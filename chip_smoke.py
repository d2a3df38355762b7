#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and hold each of
its hand-written CUDA kernels against its plain PyTorch version.

Run from the root of a checkout, on a machine with an NVIDIA GPU and
``nvcc`` (``/usr/local/cuda``)::

    python3 chip_smoke.py

It builds ``src/repro_torch/csrc/*.cu`` into ``build/repro_torch/`` and
runs seventeen phases; any failure exits non-zero:

1. kernels — B1 ``coo_spmm`` (𝔹 through its ``words_bool`` path, trop
   and nat through ``lanes_f32``; with the hub row alone and the torch
   round the planner prices it against), B3 ``coo_segment`` for bool,
   trop and nat through both its paths (``runs`` over a segment plan,
   ``scatter`` on unsorted ids) at 5% and 100% live and on the hub row
   alone, and B2 ``semiring_matmul`` at the FGH phase's
   shapes (4096³ in bool, nat and trop; 1×4096×4096 in bool and trop;
   256×4096×4096 in bool), against their plain versions on the card at
   the main path's shapes, each timed beside its plain version, a
   PyTorch library call where one computes the same function, and its
   bound;
2. latency — ``run_program`` of BM and CC Π₂ on ``powerlaw(81_306, 11)``
   (≈1.79M directed edges, the scale of SNAP ego-Twitter), checked
   against a scipy BFS and scipy connected components; every B3 launch
   must go through its ``runs`` path;
3. batched serving — ``plan_program(objective="throughput")`` +
   ``compile_batched`` for BM and CC with B = 256 sources; every row
   must equal its single-source answer and iteration count; every B1
   launch of BM must go through its ``words_bool`` path and of CC
   through ``lanes_f32``; B3 must not launch here, nor in phases 4 and
   8;
4. FGH — BM Π₁ against Π₂ on the dense ``erdos_renyi(4096, 0.4·4096)``
   (E stays dense, so Π₁'s joins and Π₂'s vector rounds run on B2);
   equal answers; every Π₁ join must go through B2's ``tc_bool`` path
   and every Π₂ round through its ``stream`` path.  BFS reaches every
   node of that graph, so Π₁ = Π₂ = BFS is also checked on the sparse
   ``erdos_renyi(4096, 1.5, seed=3)``, where it reaches 58%;
5. frontier — BM and CC Π₂ through ``run_program(...,
   mode="sparse_frontier")`` on the latency graph: the worklist over the
   CSR index on the card.  Values and rounds must equal ``sparse_jit``'s
   and scipy's; every B3 launch of the phase must go through its
   ``scatter`` path (none through ``runs``); ``budget=1`` chunks chained
   through ``FrontierRunner.run_chunk`` must equal the cold run; after
   ``apply_delta`` of 1,000 seeded edges the child's index must share
   the parent's base arrays and its worklist answer equal
   ``sparse_jit``'s, and the same after ``delete_keys`` of 100 edges.
   Per query it reports the rounds, Σ edges expanded against rounds ×
   nnz, the wall and device-busy ms of the worklist and of
   ``sparse_jit`` (median of 10 warm queries), the CSR build and B3's
   scatter per launch at the worklist's payload sizes;
6. fig11 — the paper's Fig. 11 (``benchmarks/fgh_speedups.py``): on the
   host, ``fgh.optimize`` derives Π₂ from Π₁ for BM, CC and SSSP (seed
   0; each must be ``ok`` by the rule-based method, CC's H isomorphic
   to the published one), timed; on the card Π₁ and the synthesized Π₂
   run on ``powerlaw(4096, 4)`` (BM, CC) and a weighted
   ``erdos_renyi(4096, 4.0)`` (SSSP) and must give equal answers that
   match scipy (BFS, connected components, Dijkstra); it reports each
   program's ms, the speedup, the runner each plan picked and the
   kernels it launched, by path.  B3's ``runs`` path is held against its
   plain version on the ``(m, 4096)`` 𝔹 rows one BM Π₁ round hands it,
   and timed there beside its bound and ``Tensor.scatter_reduce_``;
7. incremental — streaming updates.  (a) The twin of
   ``benchmarks/incremental_update.py`` at its defaults
   (``powerlaw(50_000, 4, seed=1)``, weights 1–7, source 0, 3 trials a
   row): SSSP/trop merges of 1 edge and of 1% of nnz, and for SSSP/trop
   and BM/bool a single delete, a delete-heavy batch (nnz // 1000) and
   a mixed stream; each answered by a full recompute (rebuild, cold
   staged fixpoint), the maintained staged loop (``mode="jit"``; the
   child's segment plan timed apart as ``plan_ms``) and the maintained
   worklist (``mode="frontier"``), which must equal the full answer bit
   for bit; the planner must pick ``delta_restart`` for merges and
   ``synth_maintenance`` (``explain()`` naming
   ``⊖-recount[seed=supported, cone=tight]``) for deletes.  (b) BM and
   CC Π₂ on the latency graph through ``Database.apply_delta`` +
   ``refresh_program`` with 1 and 1,000 inserted and 1 and 100 deleted
   edges: answers equal scipy on the mutated edge list and
   ``run_program`` from scratch; on the inserts the worklist is timed
   against the staged loop.  B3 must launch through ``runs`` (seeds,
   staged rounds) and ``scatter`` (worklist rounds, the recount), and is
   held against its plain version at this phase's shapes;
8. lm_serve — ``serve_batch("zamba2-2.7b", smoke=False)``: Zamba2-2.7B
   at its published widths (54 Mamba2 layers, d_model 2560, 32 heads of
   80, vocab 32000; 2.40 B parameters, f32, random weights from a seeded
   generator on the card), B = 8 prompts of 128–512 tokens left-padded
   to 512, 32 greedy tokens each.  Every request must emit 32 tokens in
   the vocabulary; a full forward without cache over prompt + generated
   tokens must give the decode path's last logits; B4 ``ssm_scan`` must
   launch 54 times (the prefill) and B5 ``flash_attention`` 3 times per
   forward, the prefill's through its ``prefill_tc`` path and every
   decode step's through ``decode_split``;
9. serve — the twin of ``benchmarks/serve_batch.py`` at its defaults:
   BM on ``powerlaw(50_000, 4, seed=1)``, SSSP on ``powerlaw(50_000, 4,
   seed=2)`` with weights ``default_rng(3).integers(1, 5)`` through the
   trop COO override.  Closed loop: ``DatalogServer(max_batch=64,
   warm_answers=0)`` at B = 1, 8, 64 (and 64 on the latency graph)
   against a loop of single-source ``run_program``s, answers and counts
   equal.  Open loop: 512 requests, half BM and half SSSP, Poisson
   arrivals at 2,000 qps, served by the FIFO server and by
   ``ContinuousServer`` (chunk 4) after a warm-up over every bucket;
   answers equal bit for bit, six spot checks against scipy (BFS,
   Dijkstra); qps, p50/p95/p99 from intended arrival (queue and compute
   apart), chunks, admissions, evictions, migrations and the host µs of
   a request's init, splice and harvest.  Updates on a
   ``ContinuousServer`` with warm answers on: 64 SSSP sources, a merge
   of 1,000 new edges (delta-restart), 64 BM sources, a delete of 100
   edges (the ⊖/recount rule), the same sources again (warm hits); every
   repaired answer must equal a cold ``run_program`` on the mutated graph
   and scipy, timed against a cold re-serve.  Every pool must be a
   ``TorchChunkStepper``, ``latency_routed`` 0, B1 must launch through
   ``words_bool`` for BM and ``lanes_f32`` for SSSP only, B3 through
   ``runs`` and ``scatter`` in the repairs.  One warm chunk of a B = 64
   pool of each family runs under ``torch.profiler``: device busy share,
   events, and the share of B1's pack and unpack kernels;
10. replan — the twin of ``benchmarks/replan_adaptive.py`` at its
   defaults: ``hub_chain(50_000, 18, 260)`` (n = 50,260, 900,123 𝔹
   edges, the benchmark's numpy draws), B = 64 sources, the drift (4
   chain heads, seed 1) and the control (none, seed 2).  Each workload
   runs the static ``sparse_frontier``, ``sparse_frontier_pallas`` (B1)
   and ``sparse_jit`` (B3 ``runs``) and ``adaptive_fixpoint`` from
   ``sparse_frontier_pallas`` over ``("sparse_frontier",
   "sparse_jit")`` in chunks of 32 rounds, a first run and three timed
   (median and range).  Gates: the adaptive answer and per-row counts
   equal every static runner's bit for bit and scipy's BFS on 6 rows;
   every priced boundary of the trace replays through its
   ``ReplanPolicy`` to the decision taken, and the chunk count fits the
   rounds; each chunk's launches (``by_path`` deltas read by the
   executor's observer hook) went through its runner's path alone — B1
   ``words_bool`` for the fused loop, B3 ``runs`` for ``sparse_jit``,
   B3 ``scatter`` for the worklist.  BM Π₂ from the chain head through
   the planner with ``PlanHints(adaptive=True)`` and without: equal
   answers, the worklist rejected on the card, ``explain``'s adaptive
   line.  Reported, not gated: speedups over the best static runner,
   the switch history and every boundary's priced estimates, and each
   static runner chunked from the cold carry (ms a round against
   ``ADAPTIVE_COST``'s prediction).  B1 and B3 are held against their
   plain versions at the phase's shapes outside the counted runs;
11. sharded — the twin of ``benchmarks/sharded_scaling.py`` at its
   defaults: ``powerlaw(5_000, 4)`` and ``powerlaw(2_000_000, 4)``
   (seed 1),
   weights ``integers(1, 256)`` and B = 8 sources from one
   ``default_rng(1)``; BM over the 𝔹 adjacency, SSSP (``wmax=256,
   dmax=64``) through ``edges=``.  D = 1 on a one-rank NCCL mesh
   (``make_graph_mesh(1)``): ``sharded_seminaive_fixpoint_stats``,
   single-device ``sparse_jit`` and the planner's throughput pick, a
   first run and three timed each; answers and per-row counts equal
   ``sparse_jit``'s under both exchanges, row 0 at 2 M equal to scipy's
   BFS and Dijkstra; each run's B3 launches are its rounds (``runs``
   once a dense round, ``scatter`` once a sparse one); the one-rank
   mesh rejected as single device, a forced ``sparse_sharded`` plan
   equal to the auto plan, the int-D = 8 pick recorded; the ℕ∞
   ``sharded_contract`` probe against ``contract.vspm``.  D = 2 as two
   ranks on the one card through gloo (``spawn_graph_world``; gloo's
   CUDA ``all_gather``/``all_reduce`` checked first): every rank's
   answers and counts equal ``sparse_jit``'s at both sizes, ``auto`` ≡
   ``dense``, every tier and the dense fallback taken (a shrunk ladder
   on the small graph beside the defaults), and ``DatalogServer(mesh=)``
   on the serve phase's BM graph equal to a single-device server across
   a 100-edge merge.  B3 ``runs`` on a local derive's payload and
   ``scatter`` on the largest expansion are held against their plain
   versions outside the timed runs.

12. lm_families — every other model family through ``serve_batch``,
   f32, random weights from a seeded generator on the card, greedy, one
   model at a time on an otherwise empty card (``FAMILY_RUNS``):
   DeepSeekMoE-16B at its full published size (28 layers, 64 experts
   top-6 + 2 shared, first layer dense; B = 8 prompts of 128–512 tokens
   left-padded to 512, 32 new, ``t_max`` 1024), MiniCPM-2B, LLaVA-NeXT
   (Mistral-7B), Whisper-base and xLSTM-125M whole at that traffic,
   StarCoder2-7B whole at B = 2 prompts of 4,200–4,600 tokens (its
   4,096 window binds), Llama 4 Maverick at its widths with 4 layers
   and 8 of 128 experts at B = 1 prompt of 8,320 tokens (the 8,192
   chunk is crossed; pair-block 1 is global), Llama 3 405B at 2 layers
   and Mistral Large at 4.  Per model: B5 (B4 for xLSTM) held against
   its plain version at the model's prefill and last decode shapes
   (Llama 4's global layer, Whisper's encoder and cross-attention)
   before its weights load; B4/B5 launches and B5's paths equal the
   layer count (``prefill_tc`` a layer a prefill, ``decode_split`` a
   layer a step; Whisper's cross-attention too); every token within
   ``padded_vocab`` (pad ids counted); decode's last logits equal a
   full forward's over prompt + generated tokens within ``LOGIT_TOL``
   — for the MoE models in a run of 2 sequences at ``capacity_factor =
   E/k``, where no choice can drop, the served run at the published
   1.25 reporting its dropped choices per layer in prefill and decode;
   LLaVA also through ``forward(embeds=)`` (2 × 576 stub patches + 64
   tokens, 16 steps); one warm DeepSeekMoE prefill and decode step
   under ``torch.profiler``.  Prefill ms, decode ms a step, tokens/s,
   peak memory.
13. train — one card's training step through
   ``repro_torch.launch.train``, on an emptied card.  B4's gradient
   (``ScanFn``: B4 forward, B4 backward) held against autograd through
   its plain version on the same CUDA tensors at xLSTM's training shape
   (8, 1024, 1536) and an odd T (2, 37, 1536), max |err| ≤ 1e-4 · max
   |plain| for da and db, two launches and no plain call; its backward
   timed beside its byte bound (20 B an element).  B5's gradient
   (``AttnFn``: B5 forward writing each row's log-sum-exp, B5's backward
   kernels ``rowdot`` and the 3xTF32 tensor-core ``dkdv`` and ``dq``)
   held the same way for dq, dk and dv against autograd through
   ``attention_ref`` at every attention family's training shape
   (``B5_TRAIN_ROWS``: Zamba2, MiniCPM and DeepSeekMoE at 8 × 1,024,
   StarCoder2's window at 1 × 4,600, Llama 4's chunked and global layers
   at 1 × 8,320, Whisper's encoder and its cross-attention with Tq ≠ Tk,
   an odd small shape), one forward and
   one backward launch and no plain call, the forward's output the same
   bits with and without lse, two backwards the same bits; the backward
   timed with the host hidden and L2 flushed, each kernel apart, beside
   its bound (five T²·D products over the visible pairs at three TF32
   tensor-core passes, as the forward's; the FP32 SIMT figure beside
   it), the plain backward and SDPA's f32 backward.  Three AdamW steps
   of every family's smoke config on the card and on the CPU from the
   same weights and batches (each attention family's card step from the
   CPU's weights and optimizer state): losses, grad norms and updates
   within the CPU tests' tolerances, B4 and B5 forward and backward
   launched as the layers ask.  ``train("xlstm-125m", smoke=False,
   batch=8, seq=1024, steps=30)`` (the reference's real-hardware
   setting, 109.6 M parameters) and ``train("zamba2-2.7b", smoke=False,
   batch=8, seq=1024, steps=20, remat="full")`` (2.40 B parameters): every
   loss and grad norm finite, the mean of the last 5 losses below the
   first, B4 launched 12 forward + 12 backward a step (Zamba2: 54 + 54
   recomputed + 54 backward), B5 none (Zamba2: 3 forward + 3 backward:
   the shared block runs outside the rematerialized layer scan, as in
   the reference), the plain versions never; ms a step (median of the
   warm steps), tokens/s, peak memory, and one warm step under
   ``torch.profiler`` (busy share, GEMM ms, B4's and B5's forward and
   backward ms).  Then the resume entry: the xLSTM-125M run again with
   checkpoints and heartbeats (saves at 25 and 30), its losses bit for
   bit the run's without, and a run from a directory holding only step
   25: the restored state equal to the checkpoint, the fresh weights
   not, the restore written in place (no second copy of the state on
   the card), the resumed losses, parameters, moments and step equal to the
   first run's bit for bit, B4 launched for every step that ran, host 0
   alive at step 29; the same for Zamba2-2.7B's smoke config over 28
   steps (B5's ``AttnFn`` on the path); it reports the state's bytes,
   the ms each save blocks the loop, the writer's seconds and GB/s, the
   steps that overlap a write against the others, and the restore's
   seconds and device bytes.  Then B = 32 in 4 micro-batches with ``remat="full"``
   (4 × (12 + 12 + 12) B4 launches a step), and 3 steps with
   ``remat="none"``, ``"full"`` and ``"selective"``, whose losses must
   agree within 1e-5 relative.
14. mesh — the data axis (run after the profile phase, once the warm
   cells have left the card).  Serving: the serve phase's BM and SSSP
   graphs closed loop at B = 64 on a one-rank NCCL ``"data"`` mesh
   (``make_datalog_mesh(1)``) against the one-device server, 5 timed
   reps interleaved: answers, counts, ``stats`` and the rows each
   fixpoint ran (64) equal; B1 launched.  Training: xLSTM-125M at its
   published size (B = 8 × 1,024, AdamW) for 10 steps unsharded and on a
   one-rank NCCL host mesh (``train(mesh=)``, ZeRO-3 on ``"data"``, one
   layer gathered at a time): losses and parameters bit for bit, no byte
   staged through the host; ms a step, peak, collective bytes a step,
   and the most gathered parameter bytes alive at once
   (``collectives.STATS["gathered_peak_bytes"]``) at most the leaves
   outside the stacks plus the largest layer, below the whole tree's.
   Zamba2-2.7B at its published widths likewise (B = 8 × 1,024,
   ``remat="full"``, AdamW, 3 steps): bit for bit, its peak at most the
   unsharded run's plus 3 GB, the gathered-bytes gate.  Then two gloo
   ranks on the
   card (``spawn_world``), each: the same serving on a two-rank data
   mesh (32 rows a rank, answers equal to the one-device server's, B1
   launched); ``train`` of xLSTM-125M for 5 steps and of Zamba2's smoke
   config for 3 (B4, B5 forward and backward), losses within 1e-5
   relative of one rank fed both ranks' batches concatenated, half the
   876,675,072 B of moments a rank, collective and host-staged bytes a
   step, peak, the gathered-bytes gate on every rank; a sharded
   checkpoint after 2 steps, restored at W = 2 (and
   whole at W = 1 here) equal to the saved state; GPipe over xLSTM-125M's
   12 layers as 2 stages × 4 micro-batches of 2 × 1,024, within 1e-5 ·
   max |y| of the sequential stack, B4 launched on both stages; and
   xLSTM-125M's gradient reduced in bf16 and int8
   (``compressed_grad_reduce``) within each mode's rounding bound of
   the f32 mean.  Its launches join the kernels line: B1 from serving,
   B4 and B5 from training and the pipeline.
15. model_axis — tensor parallelism over ``"model"`` (run after the
   mesh and lm_families phases, on an emptied card).  (a) the mesh
   phase's xLSTM-125M run on a one-rank NCCL host mesh
   (``make_host_mesh(1)``: a one-rank model axis, every model-axis
   operator the identity), bit for bit the unsharded run, recorded
   again here.  B4 at a rank's shapes of M = 2 ((8, 1024, 768):
   xLSTM's 1,536 channels halved; (8, 512, 2560): Zamba2's 5,120) and
   B5 with 16 of Zamba2's 32 heads of 80 and 8 of DeepSeekMoE's 16 of
   128 (the served prefill, a decode step over 528 keys, ``AttnFn``'s
   backward at 8 × 1,024) against their plain versions, outside the
   counted runs.  (b) Two gloo ranks on the card at ``(data 1, model
   2)`` (``spawn_world``, ``_ma_rank``): xLSTM-125M at full size (B =
   8 × 1,024; AdamW 5 steps, Adafactor on split leaves 3), Zamba2's
   smoke config (3 steps, B5's backward on split heads) and
   DeepSeekMoE-16B at full width with 2 layers (B = 8 × 1,024, AdamW,
   published capacity, 3 steps, each rank 32 of 64 experts) through
   ``train(model_parallel=2)``, losses within 1e-4 relative of one rank
   here on the same batches; DeepSeekMoE's smoke config at capacity
   factor 0.5 on the same ranks as ``(data 2, model 1)``, capacity
   reckoned over the global batch, against one rank fed both ranks'
   streams, and again with ``accum_steps=2`` (each rank's micro-batch
   its share of the global one) against one rank's ``accum_steps=2``
   step on the concatenated batches; Zamba2-2.7B (B = 8 prompts of
   512) and DeepSeekMoE-16B at
   its published size (the lm_families phase's prompts) served by
   ``serve_batch(mesh=)`` with 16 new tokens, each rank building only
   its blocks, their prefill logits (computed after the timed call, on
   the same weights built again) within 1e-4 · max |logit| of one
   device (DeepSeekMoE's: the lm_families phase's run) and every token
   equal where one device's top-2 gap exceeds 100× that (closer calls
   counted), DeepSeekMoE's prefill routing choices that differ from one
   device's counted; ms a step at M = 1 and 2, collective and
   host-staged bytes a rank a step, peaks, prefill and decode ms.  Its
   B4, B5 and B5-backward launches join the kernels line.

16. fig12 — the paper's Fig. 12, the CEGIS group (run after fig11):
   the twin of ``benchmarks/fgh_scaling.py`` at its own parameters (WS
   ``window=10, vmax=6``; BC on ``erdos_renyi(n, 2.0)`` with ``dmax =
   max(16, n // 4)``; R and MLM on ``random_recursive_tree`` and
   ``decay_tree``, R's ``dmax`` from ``tree_depth``).  On the host,
   ``fgh.optimize`` (seed 0) synthesizes Π₂ of WS, R and MLM, each
   ``ok`` by CEGIS; BC's Π₂ is the Brandes program.  Each series runs
   Π₁ and Π₂ on the card at its ``FIG12_SIZES`` n (a first call and
   three warm), the answers held to a numpy/scipy oracle (WS prefix
   sums, BC Brandes in float64 over ``scipy.sparse``, R scipy BFS
   depths, MLM subtree sums: R bit for bit, the ℕ and real answers
   within 1e-4 · max |oracle|) and Π₁ to Π₂; each Π₁ stratum's runner
   and B2/B3 paths recorded.  BC's Π₂ alone at n = 4,096 with TF32
   allowed globally (Brandes pins its products to f32), against the
   float64 oracle; B2 ``tile_f32`` at Brandes' 4,096³ ℕ product and at
   the (8,192 × 8,192)·(8,192 × 1) product MLM's Π₂ hands it each round,
   exact against its plain version, timed beside ``torch.matmul`` f32
   and its bound.  (b) A series' Π₁ through ``mode="host"`` equal to
   ``mode="naive"`` in answer and rounds.  (c)
   ``plan_program(cost_model="hlo")`` on the latency graph (BM and CC
   Π₂) and the fgh phase's dense graph (BM Π₁ and Π₂): every
   candidate's staged and analytic FLOPs and bytes, each model's pick,
   planning ms and peak; the two plans' answers equal.
17. dryrun — the dry-run tools (ROADMAP A8; run last: it replaces the
   process group with fake ones).  ``dryrun.calibrate`` on
   ``DRYRUN_CALIBRATE`` (xLSTM-125M's 8 × 1,024 AdamW step with no
   remat, a Zamba2-2.7B prefill of 8 × 512 and a decode step of 8 × 1
   against a 1,024-slot cache, bf16 weights): the count of the step
   staged on meta at mesh ``(1, 1)`` equals the card's count of the same
   step (FLOPs, bytes, collectives, B4/B5 as one op each), and its
   arguments plus temporaries are within 10% of the card's peak over
   the step; each step's ms beside ``hillclimb.terms``' compute and
   memory seconds.  CC's original and optimized loops
   (``datalog_dryrun.cc_loop``) on a one-rank mesh at n = 32,768 (E a
   1 GiB 𝔹 matrix), 8 iterations through B2 ``tc_bool`` and ``stream``,
   bit for bit the plain loop on the card, ms an iteration; then the
   meta count at n = 65,536 on ``(16, 16)``, the optimized variant's
   bytes and collective bytes a rank an iteration below the original's.
   Five production cells counted on meta (Llama-3-405B, DeepSeekMoE-16B
   and Zamba2-2.7B ``train_4k`` single, Zamba2-2.7B ``decode_32k``
   multi, xLSTM-125M ``long_500k`` single), each row printed and
   ``ok``.

Phase 1 also holds B4 and B5 against their plain versions at this
path's shapes, timed beside their bound and (B5) SDPA: B4 (8, 512,
5120), xLSTM's (8, 512, 1536) and one long prompt at xLSTM's width
(1, 8192, 1536), each with its share of the byte bound (phase 13
adds its backward, the ``train`` entry of its kernels line); B5 prefill
8×512 queries, decode 1 query over 544 cached keys and the full
forward's 8×544 queries, 32 heads of 80 (Zamba2), DeepSeekMoE's
prefill and decode (16 heads of 128), StarCoder2's window prefill (2 ×
4,600) and decode (36 query heads over 4 kv heads of 128, window
4,096); phase 13 adds B5's backward (the ``train`` entry of B5's
kernels line, and ``backward_launches``, its main-path calls).  B5's
``wide_simt`` route (128 < D ≤ 256; no model the main path serves has
such heads) is held and timed here too, beside its FP32 SIMT bound and
SDPA in f32 (the ``wide_simt`` entry of B5's kernels line, with its
launches): 16 q heads over 8 kv heads of 256, a 2 × 1,024 causal
prefill, the same with a window of 512, a decode step of 8 × 1 at
position 543 from a (8, 1,024, 8, 256) cache view, and 2 × 37 × 53 at D
= 200; ``AttnFn``'s backward at 2 × 1,024 and at the odd shape.  Past
256 the ``wide_chunk`` route likewise (the ``wide_chunk`` entry): 2 ×
512 causal at D = 512, a decode step at D = 576 from a cache view, 2 ×
37 × 53 at D = 320; the backward at 2 × 512 (D = 512) and the odd shape
at 576.

A line before them gives the run's seconds in all and each phase's
(the build and the data included; ``laps`` and ``seconds`` in the
record).

The last lines of standard output are the ``kernels`` JSON line, the
card's name and power limit, and the result line.  Details go to
``chiprun_out/chip_smoke.json``.  Exits non-zero, printing no result,
without a CUDA device or without the package beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke.json"

#: the card's published peaks used for the bounds (H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_SIMT_FLOPS = 67e12
INT8_TC_OPS = 1979e12
TF32_TC_FLOPS = 495e12

N_POWERLAW, M_ATTACH = 81_306, 11
N_DENSE = 4096
#: the fig11 phase's graphs: powerlaw(N_FIG11, 4) and a weighted
#: erdos_renyi(N_FIG11, 4.0), where Π₁'s n² state is 16 M entries
N_FIG11 = 4096
FIG11_WMAX = 4
#: the fgh phase's second graph: erdos_renyi(N_DENSE, SPARSE_DEG,
#: seed=SPARSE_SEED), where BFS from node 0 reaches 58% of the nodes
SPARSE_DEG, SPARSE_SEED = 1.5, 3
BATCH = 256
#: B2's shapes as (semiring, rows): Π₁'s joins (4096³), Π₂'s one-row
#: vector_dense rounds (1×4096×4096) and the batched vector_dense pack
#: (256×4096×4096); k = n = N_DENSE throughout
B2_SHAPES = (("bool", N_DENSE), ("nat", N_DENSE), ("trop", N_DENSE),
             ("bool", 1), ("trop", 1), ("bool", BATCH))

LM_ARCH = "zamba2-2.7b"
LM_BATCH, LM_PROMPT, LM_MAX_NEW, LM_T_MAX = 8, (128, 512), 32, 1024
#: the published widths: layers, d_model, heads, head dim, vocab
LM_WIDTHS = (54, 2560, 32, 80, 32000)
#: B4's long-prompt row: one prompt of this many tokens at xLSTM's width
B4_LONG_PROMPT = 8192
#: B4/B5 are float kernels summing in another order than their plain
#: versions; held to max |err| <= FLOAT_TOL · max(1, max |plain|)
FLOAT_TOL = 1e-4
#: decode path vs full forward, over 54 layers of f32 products whose
#: summation order differs (cuBLAS picks other kernels for 8 rows than
#: for 8 × 544): max |err| <= LOGIT_TOL · max(1, max |logits|)
LOGIT_TOL = 1e-4


def log(*args) -> None:
    print(*args, flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on "
              "the GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import cuda_lib

    t0 = time.perf_counter()
    lib_path = cuda_lib.build()
    cuda_lib.library()
    build_s = time.perf_counter() - t0
    laps = {"build": build_s}

    def lap(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        laps[name] = time.perf_counter() - t
        return out
    log(f"built {lib_path.relative_to(ROOT)} in {build_s:.1f} s")

    dev = torch.device("cuda")
    report = {"device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "power": nvidia_smi(), "build_s": build_s}
    data = lap("data", make_data, dev)
    report["graphs"] = data["meta"]
    kernels = lap("kernels", lambda: phase_kernels(dev, data)
                  + phase_lm_kernels(dev))
    main_path = {}
    for name, fn in (("latency", phase_latency), ("batched", phase_batched),
                     ("fgh", phase_fgh), ("frontier", phase_frontier),
                     ("fig11", phase_fig11), ("fig12", phase_fig12),
                     ("incremental", phase_incremental),
                     ("lm_serve", phase_lm_serve), ("serve", phase_serve),
                     ("replan", phase_replan), ("sharded", phase_sharded)):
        main_path[name] = lap(name, fn, dev, data)
    report["profile"] = lap("profile", phase_profile, data)
    # the warm cells hold Zamba2's weights and the 2 M graph: DeepSeekMoE
    # needs the card to itself
    del data["warm"]
    _free_cuda()
    main_path["mesh"] = lap("mesh", phase_mesh, dev)
    _free_cuda()
    log(f"lm_families starts with {torch.cuda.memory_allocated() / 1e9:.2f}"
        f" GB allocated")
    main_path["lm_families"] = lap("lm_families", phase_lm_families, dev,
                                   data)
    _free_cuda()
    # the model axis's served models are held against lm_families' runs
    main_path["model_axis"] = lap(
        "model_axis", phase_model_axis, dev, main_path["mesh"]["train_w1"],
        {arch: main_path["lm_families"]["models"][arch].pop("model_axis_ref")
         for arch in MA_FAMILY_REFS})
    _free_cuda()
    main_path["train"] = lap("train", phase_train, dev)
    _free_cuda()
    # last: the dry run replaces the process group with fake worlds
    main_path["dryrun"] = lap("dryrun", phase_dryrun, dev)
    b3 = next(k for k in kernels if k["name"] == "coo_segment")
    b3["rows"] = main_path["fig11"]["b3_rows"]
    b3["incremental"] = main_path["incremental"]["b3_checks"]
    b3["serve"] = main_path["serve"]["b3_checks"]
    b3["replan"] = main_path["replan"]["b3_checks"]
    b3["sharded"] = main_path["sharded"]["b3_checks"]
    b3["max_abs_err"] = max([b3["max_abs_err"]]
                            + [r["max_abs_err"] for r in b3["rows"]]
                            + [r["max_abs_err"]
                               for r in (*b3["incremental"].values(),
                                         *b3["serve"].values(),
                                         *b3["replan"].values(),
                                         *b3["sharded"].values())])
    fam = main_path["lm_families"]["models"]
    for k in kernels:       # B4 checked on xLSTM, B5 on the rest
        if k["name"] in ("ssm_scan", "flash_attention"):
            scan = k["name"] == "ssm_scan"
            k["families"] = {arch: r["kernel_checks"]
                             for arch, r in fam.items()
                             if (r["family"] == "ssm") == scan}
            k["max_abs_err"] = max([k["max_abs_err"]] + [
                v["max_abs_err"] for checks in k["families"].values()
                for v in checks.values()])
    for name, key in (("ssm_scan", "b4_backward"),
                      ("flash_attention", "b5_backward")):
        k = next(k for k in kernels if k["name"] == name)
        k["train"] = main_path["train"][key]
        k["model_axis"] = main_path["model_axis"]["kernel_checks"][name]
        k["max_abs_err"] = max([k["max_abs_err"]] + [
            v["max_abs_err"] for v in (*k["train"].values(),
                                       *k["model_axis"].values())])
    b2 = next(k for k in kernels if k["name"] == "semiring_matmul")
    b2["fig12"] = {"paths": main_path["fig12"]["b2_paths"],
                   **main_path["fig12"]["b2_checks"]}
    b2["max_abs_err"] = max([b2["max_abs_err"]] + [
        v["max_abs_err"] for v in main_path["fig12"]["b2_checks"].values()])
    b1 = next(k for k in kernels if k["name"] == "coo_spmm")
    b1["serve"] = main_path["serve"]["b1_checks"]
    b1["replan"] = main_path["replan"]["b1_checks"]
    b1["max_abs_err"] = max([b1["max_abs_err"]]
                            + [r["max_abs_err"]
                               for r in (*b1["serve"].values(),
                                         *b1["replan"].values())])
    for k in kernels:
        k["launches"] = sum(p["launches"][k["name"]]
                            for p in main_path.values())
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on the main "
                                 f"path")
    b5 = next(k for k in kernels if k["name"] == "flash_attention")
    b5["backward_launches"] = sum(p["launches"]["flash_attention_backward"]
                                  for p in main_path.values())
    report["kernels"] = kernels
    report["main_path"] = main_path
    report["laps"] = laps
    report["seconds"] = time.perf_counter() - t0
    log(f"chip_smoke: {report['seconds']:.1f} s in all ("
        + ", ".join(f"{k} {v:.1f}" for k, v in laps.items()) + ")")
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(report, indent=1))
    import torch.distributed as dist
    if dist.is_initialized():     # the sharded phase's one-rank world
        dist.destroy_process_group()
    top = ("name", "route", "source", "replaces", "launches", "max_abs_err",
           "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    detail = ("by_semiring", "by_shape", "rows", "incremental", "serve",
              "replan", "sharded", "families", "train", "model_axis",
              "fig12", "backward_launches", "wide_simt", "wide_chunk")
    log(json.dumps({"kernels": [
        {**{key: k[key] for key in top},
         "library_call": k["library_call"],
         "bound_gathered_ms": k.get("bound_gathered_ms"),
         **{key: k[key] for key in detail if key in k}} for k in kernels]}))
    log(report["power"])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------


def make_data(dev):
    import numpy as np
    import torch
    from repro_torch.datalog import datasets

    t0 = time.perf_counter()
    g = datasets.powerlaw(N_POWERLAW, M_ATTACH, seed=0)
    e = g.sparse_adjacency(device=dev)
    gd = datasets.erdos_renyi(N_DENSE, 0.4 * N_DENSE, seed=1)
    s = time.perf_counter() - t0
    meta = {"powerlaw": {"n": g.n, "edges": int(e.nnz)},
            "erdos_renyi": {"n": gd.n, "edges": int(len(gd.edges))},
            "generate_s": s}
    log(f"graphs: powerlaw n={g.n} nnz={e.nnz}; erdos_renyi n={gd.n} "
        f"edges={len(gd.edges)} ({s:.1f} s)")
    torch.manual_seed(0)
    return {"g": g, "E": e, "gd": gd, "meta": meta,
            "rng": np.random.default_rng(0)}


def csr_host(n, edges):
    import numpy as np
    from scipy import sparse
    return sparse.csr_matrix((np.ones(len(edges), np.int8),
                              (edges[:, 0], edges[:, 1])), shape=(n, n))


def bfs_reach(csr, src):
    import numpy as np
    from scipy.sparse import csgraph
    order = csgraph.breadth_first_order(csr, src, directed=True,
                                        return_predecessors=False)
    out = np.zeros(csr.shape[0], bool)
    out[order] = True
    return out


def cc_min_labels(csr):
    import numpy as np
    from scipy.sparse import csgraph
    k, labels = csgraph.connected_components(csr, directed=False)
    lo = np.full(k, np.inf)
    np.minimum.at(lo, labels, np.arange(csr.shape[0], dtype=np.float64))
    return lo[labels].astype(np.float32)


# --------------------------------------------------------------------------
# timing and comparison
# --------------------------------------------------------------------------


def time_ms(fn, reps: int, warmup: int = 1, hide_host: bool = False
            ) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls.

    ``hide_host``: the device first sleeps ≈0.1 ms per call, so the
    host has enqueued every call before the first one runs and the time
    is the kernels' own, not the wrapper's Python (for launches shorter
    than their enqueue)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hide_host:
        torch.cuda._sleep(int(reps * 2e5))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_cold_ms(fn, reps: int) -> float:
    """Median device time of one call of ``fn`` after a 64 MB write has
    evicted the 50 MB L2 (host enqueue hidden as in ``time_ms``)."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(int(4e5))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def max_abs_err(got, want) -> float:
    import torch
    a, b = got.float(), want.float()
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
    diff = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


def frontier(rng, shape, name, live=0.05):
    """A random Δ in the semiring: ~``live`` of it non-0̄, small ints."""
    import numpy as np
    from repro_torch.core import semiring as sr_mod
    sr = sr_mod.get(name, lib="np")
    mask = rng.random(shape) < live
    if name == "bool":
        return mask
    x = np.full(shape, sr.zero, sr.dtype)
    x[mask] = rng.integers(0, 4, int(mask.sum()))
    return x


def cast_relation(rel, name):
    """The power-law operator in semiring ``name`` (bool → 1̄ per edge)."""
    import torch
    from repro_torch.core import semiring as sr_mod
    from repro_torch.sparse.coo import SparseRelation
    if name == "bool":
        return rel
    sr = sr_mod.get(name)
    vals = sr.from_bool(rel.values) if name != "nat" else \
        rel.values.to(torch.float32)
    return SparseRelation(rel.coords, vals, rel.nnz, rel.shape, name)


# --------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# --------------------------------------------------------------------------


SEMIRINGS = ("bool", "trop", "nat")


def phase_kernels(dev, data):
    import torch
    results = [kernel_b3(dev, data), kernel_b1(dev, data),
               kernel_b2(dev, data)]
    for k in results:
        key = "by_semiring" if "by_semiring" in k else "by_shape"
        by = k[key]
        # bool (B2: bool 4096³), or the kernel's own pick
        head = by[k["head"]] if "head" in k else next(iter(by.values()))
        k.update(route="cuda", max_abs_err=max(v["max_abs_err"]
                                               for v in by.values()),
                 ms=head["ms"], plain_ms=head["plain_ms"],
                 bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                 library_ms=head["library_ms"],
                 library_call=head["library_call"])
        if "bound_gathered_ms" in head:
            k["bound_gathered_ms"] = head["bound_gathered_ms"]
        for name, v in by.items():
            extra = ""
            if "scatter" in v:             # B3: both paths
                sc, hub = v["scatter"], v["hub_row"]
                extra = (f" [runs; cold L2 {v['cold_ms']:.4f} ms, with host "
                         f"{v['host_ms']:.4f} ms; scatter {sc['ms']:.4f} ms, "
                         f"cold {sc['cold_ms']:.4f}, with host "
                         f"{sc['host_ms']:.4f}, bound "
                         f"{v['scatter_bound_ms']:.4f}; hub row runs "
                         f"{hub['runs_ms']:.4f} / scatter "
                         f"{hub['scatter_ms']:.4f} ms; live "
                         f"{v['live_share']:.3f}]")
            elif "path" in v:
                extra = (f" [{v['path']}; cold L2 {v['cold_ms']:.4f} ms, "
                         f"with host {v['host_ms']:.4f} ms")
                if "library_bf16_ms" in v:
                    extra += f"; bf16 library {v['library_bf16_ms']} ms"
                if "hub_row_ms" in v:
                    extra += (f"; hub row {v['hub_row_ms']:.4f} ms; "
                              f"gathered-bytes bound "
                              f"{v['bound_gathered_ms']:.4f} ms; by_path "
                              f"{v['by_path']}")
                extra += "]"
            log(f"{k['name']:>16} {name:>5}: {v['ms']:.4f} ms kernel, "
                f"{v['plain_ms']:.4f} ms plain, library "
                f"{v['library_ms']} ms, bound {v['bound_ms']:.4f} ms "
                f"({v['bound_by']}), max|err| {v['max_abs_err']}{extra}")
    torch.cuda.synchronize()
    return results


def _check(name, kernel, got, want):
    err = max_abs_err(got, want)
    if err != 0.0:
        raise AssertionError(f"{kernel}/{name}: kernel disagrees with its "
                             f"plain version (max |err| {err})")
    return err


def _bound(nbytes: float, ops: float = 0.0, flops: float = FP32_SIMT_FLOPS):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / flops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


#: B3's payload densities: the kernels phase's 5%-live frontier and a
#: 100%-live one, the shape of CC's first round on the latency path
B3_LIVE = (("5%", 0.05), ("100%", 1.0))
#: the dense 𝔹 payload: a 100%-live 𝔹 frontier sets every row that has
#: an in-edge, an answer that cannot fail a kernel.  So the entries of
#: the B3_DEAD_ROWS share of rows with the fewest in-edges stay 0̄, and
#: B3_DENSE_BOOL of the rest are 1̄
B3_DEAD_ROWS, B3_DENSE_BOOL = 0.4, 0.9


def b3_payloads(dev, data):
    """B3's inputs on the latency path's shape: (nnz,) payloads by dst
    over the power-law operator (vspm: ids = coords[:, 1]), each the ⊗
    of the edge values with a frontier gathered at the source.  Yields
    ``(key, semiring, vals, ids, n)``; ``ids`` is a column of its own
    (not the relation's memoized one, whose plan the latency phase
    builds)."""
    import torch
    from repro_torch.core import semiring as sr_mod
    rel, rng = data["E"], data["rng"]
    n = rel.shape[1]
    ids = rel.coords[:, 1].to(torch.int32).contiguous()
    src = rel.col(0)
    for name in SEMIRINGS:
        sr = sr_mod.get(name)
        w = cast_relation(rel, name).values
        for key, live in B3_LIVE:
            if name == "bool" and live == 1.0:
                deg = torch.bincount(ids.long(), minlength=n)
                rank = torch.argsort(deg + torch.rand(n, device=dev))
                dead = torch.zeros(n, dtype=torch.bool, device=dev)
                dead[rank[:int(B3_DEAD_ROWS * n)]] = True
                live_e = torch.from_numpy(rng.random(ids.shape[0])
                                          < B3_DENSE_BOOL).to(dev)
                vals = w & live_e & ~dead[ids.long()]
            else:
                x = torch.from_numpy(frontier(rng, (n,), name, live)).to(dev)
                if live == 1.0:            # nat's draws include its 0̄
                    x = torch.where(sr.live(x), x, sr.one)
                vals = sr.mul(w, x.index_select(0, src))
            yield f"{name} {key}", name, vals.contiguous(), ids, n


def _b3_launch(path, coo_segment, name, vals, ids, n, plan, sorted_vals):
    if path == "runs":
        return lambda: coo_segment.segment_reduce_cuda(name, sorted_vals,
                                                       ids, n, plan)
    return lambda: coo_segment.segment_reduce_cuda(name, vals, ids, n)


def kernel_b3(dev, data):
    """B3 at the latency path's shape, both paths against the plain
    version at 5% and 100% live and on the hub row alone: ``runs`` over
    a segment plan of the ids (payload in plan order), ``scatter`` on
    the unsorted ids.  Times are device times with the host's enqueue
    hidden, beside the L2-flushed time and the time with the host."""
    import torch
    from repro_torch.core import semiring as sr_mod
    from repro_torch.kernels import coo_segment, ref
    by, plan = {}, None
    paths0 = dict(coo_segment.segment_reduce_cuda.by_path)
    for key, name, vals, ids, n in b3_payloads(dev, data):
        sr = sr_mod.get(name)
        if plan is None:
            (plan, plan_ms) = wall(lambda: coo_segment.plan_segment(ids, n))
        sorted_vals = vals.index_select(0, plan.order).contiguous()
        want = ref.segment_reduce_ref(sr, vals, ids, n)
        if name == "bool":
            _assert_mixed(f"coo_segment/{key}", want)
        entry = dict(shape={"m": int(vals.shape[0]), "n": n, "lanes": 1},
                     live_share=float(sr.live(vals).float().mean()),
                     true_share=(float(want.float().mean())
                                 if name == "bool" else None))
        for path in coo_segment.PATHS:
            fn = _b3_launch(path, coo_segment, name, vals, ids, n, plan,
                            sorted_vals)
            paths = dict(coo_segment.segment_reduce_cuda.by_path)
            err = _check(f"{key} {path}", "coo_segment", fn(), want)
            paths[path] += 1
            if coo_segment.segment_reduce_cuda.by_path != paths:
                raise AssertionError(f"coo_segment/{key}: by_path "
                                     f"{coo_segment.segment_reduce_cuda.by_path}"
                                     f", expected one more {path}")
            entry[path] = dict(max_abs_err=err,
                               ms=time_ms(fn, 20, hide_host=True),
                               cold_ms=time_cold_ms(fn, 10),
                               host_ms=time_ms(fn, 20))
        reduce = sr_mod.SCATTER_REDUCE[name]
        lib_vals = vals.to(torch.uint8) if name == "bool" else vals
        ids64 = ids.long()

        def library():
            out = torch.full((n,), 0 if name == "bool" else sr.zero,
                             dtype=lib_vals.dtype, device=dev)
            return out.scatter_reduce_(0, ids64, lib_vals, reduce,
                                       include_self=True)
        if max_abs_err(library(), want) != 0.0:
            raise AssertionError(f"scatter_reduce_ yardstick disagrees "
                                 f"({key})")
        isz = vals.element_size()
        it = plan.items
        out_bytes = n * isz
        runs_bytes = plan.m_live * isz + 8 * it.n_items + out_bytes
        scatter_bytes = vals.shape[0] * (isz + 4) + out_bytes
        bound, by_what = _bound(runs_bytes)
        entry.update(
            path="runs", max_abs_err=max(entry[p]["max_abs_err"]
                                         for p in coo_segment.PATHS),
            ms=entry["runs"]["ms"], cold_ms=entry["runs"]["cold_ms"],
            host_ms=entry["runs"]["host_ms"],
            plain_ms=time_ms(lambda: ref.segment_reduce_ref(
                sr, vals, ids, n), 5),
            library_ms=time_ms(library, 20, hide_host=True),
            library_call="Tensor.scatter_reduce_",
            bound_ms=bound, bound_by=by_what, bytes=runs_bytes,
            scatter_bound_ms=_bound(scatter_bytes)[0],
            scatter_bytes=scatter_bytes)
        by[key] = entry
    hub = kernel_b3_hub(dev, data)
    for key, v in by.items():
        v["hub_row"] = hub[key.split()[0]]
    by_path = {k: v - paths0[k]
               for k, v in coo_segment.segment_reduce_cuda.by_path.items()}
    log(f"     coo_segment by_path in the kernels phase {by_path}")
    return {"name": "coo_segment", "by_path": by_path,
            "source": "src/repro_torch/csrc/coo_segment.cu",
            "replaces": "src/repro/kernels/coo_segment.py:38",
            "head": "trop 100%", "plan_ms": plan_ms,
            "plan": dict(items=plan.items.n_items,
                         split_rows=plan.items.n_split,
                         partials=plan.n_part,
                         max_item_entries=plan.items.max_edges),
            "by_semiring": by}


def kernel_b3_hub(dev, data):
    """The hub row alone: the power-law operator's largest in-degree, its
    entries only, reduced into all n rows (the other rows' 0̄ written
    too).  Checked against the plain version on a 5%-live payload, and
    with the only non-0̄ entry in the last item of the hub's split row."""
    import torch
    from repro_torch.core import semiring as sr_mod
    from repro_torch.kernels import coo_segment, ref
    rel, rng = data["E"], data["rng"]
    n = rel.shape[1]
    col = rel.coords[:, 1].long()
    deg = torch.bincount(col, minlength=n)
    hub = int(torch.argmax(deg))
    on_hub = torch.nonzero(col == hub).flatten()
    ids = torch.full((on_hub.shape[0],), hub, dtype=torch.int32, device=dev)
    plan = coo_segment.plan_segment(ids, n)
    it = plan.items
    k = int(torch.nonzero(it.fold_row == hub)[0])
    last_item = int(torch.nonzero(it.dst == ~(int(it.fold_seg[k + 1]) - 1))[0])
    planted = int(it.edge[last_item + 1]) - 1
    out = {}
    for name in SEMIRINGS:
        sr = sr_mod.get(name)
        x = torch.from_numpy(frontier(rng, (n,), name)).to(dev)
        w = cast_relation(rel, name).values
        vals = sr.mul(w, x.index_select(0, rel.col(0)))[on_hub].contiguous()
        sorted_vals = vals.index_select(0, plan.order).contiguous()
        want = ref.segment_reduce_ref(sr, vals, ids, n)
        one = sr.zeros(vals.shape, dev)
        one[planted] = sr.one
        want_one = sr.zeros((n,), dev)
        want_one[hub] = sr.one
        entry = dict(hub=hub, entries=int(ids.shape[0]), items=it.n_items,
                     hub_items=int(it.fold_seg[k + 1] - it.fold_seg[k]))
        for path in coo_segment.PATHS:
            fn = _b3_launch(path, coo_segment, name, vals, ids, n, plan,
                            sorted_vals)
            _check(f"{name} hub row {path}", "coo_segment", fn(), want)
            planted_fn = _b3_launch(path, coo_segment, name, one, ids, n,
                                    plan, one)
            _check(f"{name} hub row, one live entry in its last item "
                   f"({path})", "coo_segment", planted_fn(), want_one)
            entry[f"{path}_ms"] = time_ms(fn, 20, hide_host=True)
        out[name] = entry
    return out


def kernel_b1(dev, data):
    """The batched path's fused advance: (n, 256) frontiers over the
    power-law operator's dst-sorted plan (transpose: Δ ⊗ E), through the
    path plan_spmm picks (𝔹: words_bool; trop, nat: lanes_f32).  The 𝔹
    frontier is 5% live, so the answer is mixed (checked: 20–80% true)."""
    import numpy as np
    import torch
    from repro_torch.core import semiring as sr_mod
    from repro_torch.kernels import coo_spmm, ref
    from repro_torch.sparse.coo import SparseRelation
    rng = data["rng"]
    by = {}
    for name in SEMIRINGS:
        sr = sr_mod.get(name)
        rel = cast_relation(data["E"], name)
        plan = coo_spmm.plan_geometry(rel, transpose=True)
        path, geo = coo_spmm.plan_spmm(plan, BATCH)
        p = plan.on(dev)
        x = torch.from_numpy(frontier(rng, (plan.n_in, BATCH), name)).to(dev)
        paths = dict(coo_spmm.spmm_cuda.by_path)
        got = coo_spmm.spmm_cuda(plan, x)
        launched = {k: v - paths[k]
                    for k, v in coo_spmm.spmm_cuda.by_path.items()}
        if launched != {k: int(k == path) for k in paths}:
            raise AssertionError(f"coo_spmm/{name}: launched {launched}, "
                                 f"expected one {path}")
        want = ref.coo_spmm_ref(sr, p["src"], p["w"], p["dst"], x, plan.n_out)
        if name == "bool":
            _assert_mixed(f"coo_spmm/{name}", want)
        err = _check(name, "coo_spmm", got, want)

        def kernel():
            return coo_spmm.spmm_cuda(plan, x)
        library_ms, library_call = None, None
        if name == "nat":  # (+, ×): one torch.sparse.mm computes it
            counts = torch.bincount(p["dst"].long(), minlength=plan.n_out)
            crow = torch.zeros(plan.n_out + 1, dtype=torch.int64,
                               device=dev)
            crow[1:] = torch.cumsum(counts, 0)
            a = torch.sparse_csr_tensor(crow, p["src"].long(), p["w"],
                                        size=(plan.n_out, plan.n_in))
            if max_abs_err(torch.sparse.mm(a, x), want) != 0.0:
                raise AssertionError("torch.sparse.mm yardstick disagrees")
            library_ms = time_ms(lambda: torch.sparse.mm(a, x), 20,
                                 hide_host=True)
            library_call = "torch.sparse.mm (CSR)"
        torch_round_ms = None
        if name in ("bool", "trop"):   # SpmmKernelModel's calibration
            from repro_torch.sparse import contract
            if max_abs_err(contract.spmm(rel, x, transpose=True),
                           want) != 0.0:
                raise AssertionError("torch round disagrees")
            torch_round_ms = time_ms(
                lambda: contract.spmm(rel, x, transpose=True), 5)
        # the hub row alone (its edges only): the power-law's largest
        # in-degree, cut into items, plus every other row's 0̄
        degrees = torch.bincount(p["dst"].long(), minlength=plan.n_out)
        hub = int(torch.argmax(degrees))
        on_hub = plan.dst == hub
        hub_rel = SparseRelation.from_coo(
            np.stack([plan.src[on_hub], plan.dst[on_hub]], axis=1),
            plan.w[on_hub], rel.shape, name, device=dev)
        hub_plan = coo_spmm.plan_geometry(hub_rel, transpose=True)
        hub_want = ref.coo_spmm_ref(sr, *(hub_plan.on(dev)[k] for k in
                                          ("src", "w", "dst")), x,
                                    plan.n_out)
        _check(f"{name} hub row", "coo_spmm",
               coo_spmm.spmm_cuda(hub_plan, x), hub_want)
        hub_ms = time_ms(lambda: coo_spmm.spmm_cuda(hub_plan, x), 20,
                         hide_host=True)
        isz = x.element_size()
        it = geo.items
        idx_bytes = (4 + p["w"].element_size()) * plan.nnz \
            + 8 * it.n_items + 8 * it.n_split
        out_bytes = plan.n_out * BATCH * isz
        nbytes = idx_bytes + plan.n_in * BATCH * isz + out_bytes
        bound, by_what = _bound(nbytes)
        row_bytes = geo.row_len * 4
        if path == "words_bool":   # pack, round on words, unpack
            gathered = (plan.n_in * (BATCH + row_bytes) + idx_bytes
                        + plan.nnz * row_bytes
                        + 2 * it.n_part * row_bytes
                        + plan.n_out * (2 * row_bytes + BATCH))
        else:                      # indices once a slab
            gathered = (idx_bytes * geo.grid[1] + plan.nnz * row_bytes
                        + 2 * it.n_part * row_bytes + out_bytes)
        by[name] = dict(
            shape={"nnz": plan.nnz, "n": plan.n_out, "lanes": BATCH,
                   "rows": len(plan.udst),
                   "max_row_edges": int(degrees.max())},
            path=path,
            geometry=dict(items=it.n_items, split_rows=it.n_split,
                          partials=it.n_part, row_len=geo.row_len,
                          vec=geo.vec, slab=geo.slab, grid=list(geo.grid)),
            by_path=launched,
            true_share=(float(want.float().mean()) if name == "bool"
                        else None),
            hub_row_ms=hub_ms, hub_items=hub_plan.items().n_items,
            max_abs_err=err,
            ms=time_ms(kernel, 20, hide_host=True),
            torch_round_ms=torch_round_ms,
            cold_ms=time_cold_ms(kernel, 10),
            host_ms=time_ms(kernel, 20),
            plain_ms=time_ms(lambda: ref.coo_spmm_ref(
                sr, p["src"], p["w"], p["dst"], x, plan.n_out), 3),
            library_ms=library_ms, library_call=library_call,
            bound_ms=bound, bound_by=by_what, bytes=nbytes,
            gathered_bytes=gathered,
            bound_gathered_ms=gathered / HBM_BYTES_PER_S * 1e3)
    return {"name": "coo_spmm", "source": "src/repro_torch/csrc/coo_spmm.cu",
            "replaces": "src/repro/kernels/coo_spmm.py:214",
            "by_semiring": by}


def _one_hot(m, n, hot, dev):
    import torch
    a = torch.zeros((m, n), dtype=torch.bool, device=dev)
    a[torch.arange(m, device=dev), torch.as_tensor(hot, device=dev)] = True
    return a


def _assert_mixed(name, want):
    """A 𝔹 answer a wrong kernel could match only by luck: 20–80% true."""
    share = float(want.float().mean())
    if not 0.2 < share < 0.8:
        raise AssertionError(f"{name}: saturated check ({share:.3f} of the "
                             f"plain answer true)")


def kernel_b2(dev, data):
    """The FGH phase's products on the dense Erdős–Rényi E (4096², 40%
    dense): Π₁'s joins E ⊕.⊗ R (4096³; bool, and nat/trop on 40%-live
    relations), Π₂'s one-row rounds Δ ⊕.⊗ E (1×4096×4096; bool, trop)
    and the batched vector_dense pack (256 rows, bool), each through
    the path plan_matmul picks.

    The 𝔹 operands are the main path's own, chosen so the answer is
    mixed (checked: 20–80% true): Π₂'s Δ is one-hot (a row of E comes
    out), swept over every K split of the stream geometry for m = 1 and
    spread over all of K for the 256-row pack; Π₁'s R has density
    1/(0.4·4096), about one hit a sum."""
    import numpy as np
    import torch
    from repro_torch.core import semiring as sr_mod
    from repro_torch.kernels import ref, semiring_matmul
    rng = data["rng"]
    gd = data["gd"]
    n = gd.n
    adj = np.zeros((n, n), bool)
    adj[gd.edges[:, 0], gd.edges[:, 1]] = True
    e_bool = torch.from_numpy(adj).to(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    by = {}
    for name, m in B2_SHAPES:
        sr = sr_mod.get(name)
        key = f"{name} {m}x{n}x{n}"
        path, geo = semiring_matmul.plan_matmul(name, m, n, n)
        if name == "bool":
            if m == n:      # Π₁: E ⊕.⊗ a sparse 0/1 relation
                a = e_bool
                b = torch.from_numpy(rng.random((n, n))
                                     < 1 / (0.4 * n)).to(dev)
            else:           # Π₂: one-hot Δ rows ⊕.⊗ E
                a = _one_hot(m, n, np.linspace(0, n - 1, m).round()
                             .astype(np.int64), dev)
                b = e_bool
        else:
            live = 0.4 if m == n else 0.05
            a = torch.from_numpy(frontier(rng, (m, n), name, live=live)
                                 ).to(dev)
            b = torch.from_numpy(frontier(rng, (n, n), name, live=0.4)
                                 ).to(dev)
        if name == "bool" and m == 1:
            # one hot K row in each split of the stream geometry
            kps = geo.k_per_split
            for s in range(geo.splits):
                hot = min(n - 1, s * kps + (7 * s) % kps)
                a1 = _one_hot(1, n, [hot], dev)
                want = ref.semiring_matmul_ref(sr, a1, b)
                _assert_mixed(f"semiring_matmul/{key}", want)
                _check(f"{key} hot {hot}", "semiring_matmul",
                       semiring_matmul.semiring_matmul_cuda(name, a1, b),
                       want)
        got = semiring_matmul.semiring_matmul_cuda(name, a, b)
        want = ref.semiring_matmul_ref(sr, a, b)
        if name == "bool":
            _assert_mixed(f"semiring_matmul/{key}", want)
        err = _check(key, "semiring_matmul", got, want)

        def kernel():
            return semiring_matmul.semiring_matmul_cuda(name, a, b)
        small = m <= semiring_matmul.M_STREAM
        reps = 50 if small else (20 if m < n else 5)
        entry = dict(
            shape={"m": m, "k": n, "n": n}, path=path, max_abs_err=err,
            ms=time_ms(kernel, reps, hide_host=True),
            cold_ms=time_cold_ms(kernel, 10),
            host_ms=time_ms(kernel, reps),
            plain_ms=time_ms(lambda: ref.semiring_matmul_ref(sr, a, b),
                             2 if m == n else 5),
            library_ms=None, library_call=None, library_bf16_ms=None)
        if name in ("bool", "nat"):  # the f32 dot; bool also in bf16
            a32, b32 = a.float(), b.float()
            lib = torch.matmul(a32, b32)
            if max_abs_err(lib > 0.5 if name == "bool" else lib,
                           want) != 0.0:
                raise AssertionError("torch.matmul yardstick disagrees")
            entry.update(library_ms=time_ms(lambda: torch.matmul(a32, b32),
                                            reps, hide_host=small),
                         library_call="torch.matmul (f32, TF32 off)")
            if name == "bool":
                a16, b16 = a.bfloat16(), b.bfloat16()
                if max_abs_err(torch.matmul(a16, b16) > 0.5, want) != 0.0:
                    raise AssertionError("bf16 yardstick disagrees")
                entry["library_bf16_ms"] = time_ms(
                    lambda: torch.matmul(a16, b16), reps, hide_host=small)
                entry["library_bf16_call"] = "torch.matmul (bf16 0/1)"
            del a32, b32, lib
        if path == "tc_bool":  # B as a .t() view: no transpose inside
            b_kmajor = b.t().contiguous().t()
            entry["k_major_ms"] = time_ms(
                lambda: semiring_matmul.semiring_matmul_cuda(
                    name, a, b_kmajor), reps)
            del b_kmajor
        ops = 2.0 * m * n * n
        isz = a.element_size()
        nbytes = float(isz * (m * n + n * n + m * n))
        bound, by_what = _bound(nbytes, ops, INT8_TC_OPS
                                if path == "tc_bool" else FP32_SIMT_FLOPS)
        entry.update(bound_ms=bound, bound_by=by_what, ops=ops,
                     bytes=nbytes)
        if name in ("trop", "maxplus") and path == "tile_f32":
            # add, then min/max: two SIMT instructions per (i, j, k)
            entry["simt_issue_floor_ms"] = 2 * ops / FP32_SIMT_FLOPS * 1e3
        if name == "bool":
            entry["true_share"] = float(want.float().mean())
        by[key] = entry
    return {"name": "semiring_matmul",
            "source": "src/repro_torch/csrc/semiring_matmul.cu",
            "replaces": "src/repro/kernels/semiring_matmul.py:35",
            "by_shape": by}


# --------------------------------------------------------------------------
# phases 2-4: the main path
# --------------------------------------------------------------------------


class Counted:
    """Launch counts of one main-path phase: zeroed on entry, read on
    exit."""

    def __enter__(self):
        from repro_torch.kernels import ops
        import torch
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import (coo_segment, flash_attention, ops,
                                         semiring_matmul)
        import torch
        torch.cuda.synchronize()
        self.counts = ops.launch_counts()
        self.b3_paths = dict(coo_segment.segment_reduce_cuda.by_path)
        self.b2_paths = dict(semiring_matmul.semiring_matmul_cuda.by_path)
        self.b5_paths = dict(flash_attention.flash_attention_cuda.by_path)
        return False


def wall(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _dbs(dev, data):
    from repro_torch.core import engine
    from repro_torch.datalog import programs
    g, e = data["g"], data["E"]
    out = {}
    for kind, bench in (("bm", programs.bm(a=0)), ("cc", programs.cc())):
        out[kind] = engine.Database(
            bench.original.schema, {"id": g.n},
            {"E": e, "V": g.vertex_set(device=dev)}, dev)
    return out


def _no_b3(phase, counts):
    """B3 is the latency path's kernel; the other phases launch none."""
    if counts["coo_segment"]:
        raise AssertionError(f"{phase}: B3 coo_segment launched "
                             f"{counts['coo_segment']} times")


def phase_latency(dev, data):
    """BM and CC Π₂, one query each, through run_program."""
    import numpy as np
    from repro_torch.core.program import run_program
    from repro_torch.datalog import programs
    g = data["g"]
    dbs = data.setdefault("dbs", _dbs(dev, data))
    csr = csr_host(g.n, g.edges)
    out = {}
    with Counted() as c:
        for kind, prog in (("bm", programs.bm(a=0).optimized),
                           ("cc", programs.cc().optimized)):
            (x, st), first_ms = wall(lambda: run_program(prog, dbs[kind]))
            times = [wall(lambda: run_program(prog, dbs[kind]))[1]
                     for _ in range(5)]
            got = x.cpu().numpy()
            want = bfs_reach(csr, 0) if kind == "bm" else cc_min_labels(csr)
            if not np.array_equal(got, want):
                raise AssertionError(f"latency {kind}: answer differs from "
                                     f"the scipy oracle")
            data.setdefault("warm", {})[f"latency_{kind}"] = \
                (lambda p=prog, d=dbs[kind]: run_program(p, d))
            out[kind] = dict(runner=st.plan.strata[0].runner,
                             iterations=st.iterations, first_ms=first_ms,
                             ms=sorted(times)[len(times) // 2],
                             all_ms=times)
            log(f"latency {kind}: {out[kind]['runner']} "
                f"{st.iterations} rounds, first {first_ms:.1f} ms, median "
                f"{out[kind]['ms']:.2f} ms, matches scipy")
    out["launches"] = c.counts
    out["b3_paths"] = c.b3_paths
    log(f"latency launches {c.counts}; B3 paths {c.b3_paths}")
    n_b3 = c.counts["coo_segment"]
    if n_b3 <= 0:
        raise AssertionError("latency: B3 coo_segment never launched")
    if c.b3_paths != {"runs": n_b3, "scatter": 0}:
        raise AssertionError(f"latency: B3's {n_b3} launches went "
                             f"{c.b3_paths}, not all through runs")
    return out


def phase_batched(dev, data):
    """B = 256 sources through plan_program(throughput) + compile_batched,
    each row held against its single-source run."""
    import numpy as np
    import torch
    from repro_torch.core import planner
    from repro_torch.datalog import programs
    from repro_torch.kernels import coo_spmm
    from repro_torch.sparse import fixpoint as fx
    g, rng = data["g"], data["rng"]
    dbs = data.setdefault("dbs", _dbs(dev, data))
    sources = rng.choice(g.n, BATCH, replace=False)
    out, runs, b1 = {}, {}, {}
    b1_path = {"bm": "words_bool", "cc": "lanes_f32"}
    with Counted() as c:
        for kind in ("bm", "cc"):
            paths0 = dict(coo_spmm.spmm_cuda.by_path)
            launches0 = coo_spmm.spmm_cuda.launches
            prog = programs.bm(a=0).optimized if kind == "bm" else \
                programs.cc().optimized
            db = dbs[kind]
            plan = planner.plan_program(prog, db, objective="throughput")
            runner = plan.strata[0].runner
            if runner != "sparse_frontier_pallas":
                raise AssertionError(f"batched {kind}: planner picked "
                                     f"{runner}")
            edges = planner.materialize_edges(plan, db)
            run = planner.compile_batched(plan)
            if kind == "bm":
                init = torch.stack([planner.source_init(
                    plan, programs.bm(a=int(s)).optimized, db)
                    for s in sources])
            else:  # CC restricted to a random 1% seed set per row
                base = planner.source_init(plan, prog, db)
                seeds = torch.from_numpy(
                    rng.random((BATCH, g.n)) < 0.01).to(dev)
                init = torch.where(seeds, base, torch.full_like(
                    base, float("inf")))
            (x, it), first_ms = wall(lambda: run(edges, init))
            (x, it), ms = wall(lambda: run(edges, init))
            runs[kind] = (edges, init, x, it)
            data.setdefault("warm", {})[f"batched_{kind}"] = \
                (lambda r=run, e=edges, i=init: r(e, i))
            out[kind] = dict(runner=runner, first_ms=first_ms, ms=ms,
                             per_source_ms=ms / BATCH,
                             rounds_max=int(it.max()))
            b1[kind] = dict(
                launches=coo_spmm.spmm_cuda.launches - launches0,
                by_path={k: v - paths0[k] for k, v in
                         coo_spmm.spmm_cuda.by_path.items()})
    out["launches"] = c.counts
    out["b1_paths"] = b1
    log(f"batched launches {c.counts}; B1 paths {b1}")
    if c.counts["coo_spmm"] <= 0:
        raise AssertionError("batched: B1 coo_spmm never launched")
    _no_b3("batched", c.counts)
    # every B1 launch of BM went through words_bool, of CC lanes_f32
    if sum(v["launches"] for v in b1.values()) != c.counts["coo_spmm"]:
        raise AssertionError(f"batched: B1 paths {b1} do not account for "
                             f"{c.counts['coo_spmm']} launches")
    for kind, v in b1.items():
        want = {k: v["launches"] if k == b1_path[kind] else 0
                for k in v["by_path"]}
        if v["launches"] <= 0 or v["by_path"] != want:
            raise AssertionError(f"batched {kind}: B1 launches went "
                                 f"{v['by_path']}, not all "
                                 f"{v['launches']} through "
                                 f"{b1_path[kind]}")
    # every row against its own single-source run (outside the count)
    for kind, (edges, init, x, it) in runs.items():
        single = [fx.fixpoint(edges, init[b]) for b in range(BATCH)]
        ys = torch.stack([s[0] for s in single])
        its = np.asarray([s[1] for s in single], np.int32)
        if not torch.equal(x, ys) or not np.array_equal(
                it.cpu().numpy(), its):
            raise AssertionError(f"batched {kind}: rows differ from their "
                                 f"single-source runs")
        if kind == "bm":
            want = bfs_reach(csr_host(g.n, g.edges), int(sources[0]))
            if not np.array_equal(x[0].cpu().numpy(), want):
                raise AssertionError("batched bm: row 0 differs from BFS")
        log(f"batched {kind}: {out[kind]['runner']} B={BATCH} "
            f"{out[kind]['ms']:.2f} ms ({out[kind]['per_source_ms']:.3f} "
            f"ms/source), rows equal single-source answers and counts")
    return out


def phase_fgh(dev, data):
    """BM Π₁ (dense all-pairs) against Π₂ on the dense Erdős–Rényi graph;
    Π₁'s joins must go through B2's tc_bool path, Π₂'s rounds through
    its stream path.  BFS reaches every node of that graph, so beside it
    Π₁ = Π₂ = BFS is checked on a sparse one whose answer is mixed."""
    import numpy as np
    from repro_torch.core.program import run_program
    from repro_torch.datalog import datasets, programs
    gd = data["gd"]
    bench = programs.bm(a=0)
    db = bench.make_db(gd, device=dev)
    out = {}
    with Counted() as c1:
        (x1, st1), ms1 = wall(lambda: run_program(bench.original, db))
    with Counted() as c2:
        (x2, st2), ms2 = wall(lambda: run_program(bench.optimized, db))
        (x2, st2), ms2_warm = wall(lambda: run_program(bench.optimized, db))
    data.setdefault("warm", {}).update(
        fgh_pi1=lambda: run_program(bench.original, db),
        fgh_pi2=lambda: run_program(bench.optimized, db))
    counts = {k: c1.counts[k] + c2.counts[k] for k in c1.counts}
    out.update(pi1=dict(runner=st1.plan.strata[0].runner,
                        iterations=st1.iterations, ms=ms1,
                        b2_paths=c1.b2_paths),
               pi2=dict(runner=st2.plan.strata[0].runner,
                        iterations=st2.iterations, ms=ms2,
                        warm_ms=ms2_warm, b2_paths=c2.b2_paths),
               launches=counts)
    if st1.plan.strata[0].storage or st2.plan.strata[0].storage:
        raise AssertionError("fgh: the planner re-homed E; it must stay "
                             "dense")
    if not np.array_equal(x1.cpu().numpy(), x2.cpu().numpy()):
        raise AssertionError("fgh: Π₁ and Π₂ answers differ")
    want = bfs_reach(csr_host(gd.n, gd.edges), 0)
    if not np.array_equal(x2.cpu().numpy(), want):
        raise AssertionError("fgh: answer differs from BFS")
    log(f"fgh: Π₁ {out['pi1']['runner']} {st1.iterations} rounds "
        f"{ms1:.1f} ms; Π₂ {out['pi2']['runner']} {st2.iterations} rounds "
        f"{ms2:.1f} ms (warm {ms2_warm:.1f} ms); answers equal, match BFS")
    log(f"fgh launches {counts}; B2 paths Π₁ {c1.b2_paths}, Π₂ "
        f"{c2.b2_paths}")
    if counts["semiring_matmul"] <= 0:
        raise AssertionError("fgh: B2 semiring_matmul never launched")
    _no_b3("fgh", counts)
    for which, c, path in (("Π₁", c1, "tc_bool"), ("Π₂", c2, "stream")):
        n_mm = c.counts["semiring_matmul"]
        if n_mm <= 0 or c.b2_paths[path] != n_mm:
            raise AssertionError(f"fgh: {which}'s {n_mm} B2 products went "
                                 f"{c.b2_paths}, not all through {path}")
    # the same check where BFS reaches part of the graph: erdos_renyi at
    # average degree 1.5 (seed 3: 6,145 edges, 58% reached from node 0)
    gs = datasets.erdos_renyi(N_DENSE, SPARSE_DEG, seed=SPARSE_SEED)
    dbs = bench.make_db(gs, device=dev)
    (y1, s1), ms1s = wall(lambda: run_program(bench.original, dbs))
    (y2, s2), ms2s = wall(lambda: run_program(bench.optimized, dbs))
    want = bfs_reach(csr_host(gs.n, gs.edges), 0)
    share = float(want.mean())
    if not 0.2 < share < 0.8:
        raise AssertionError(f"fgh sparse: saturated check ({share:.3f} of "
                             f"the BFS answer true)")
    if not np.array_equal(y1.cpu().numpy(), want) or \
            not np.array_equal(y2.cpu().numpy(), want):
        raise AssertionError("fgh sparse: Π₁, Π₂ and BFS differ")
    out["sparse"] = dict(n=gs.n, edges=int(len(gs.edges)), true_share=share,
                         pi1_iterations=s1.iterations, pi1_ms=ms1s,
                         pi2_iterations=s2.iterations, pi2_ms=ms2s)
    log(f"fgh sparse: erdos_renyi({gs.n}, {SPARSE_DEG}) {len(gs.edges)} "
        f"edges, {100 * share:.1f}% reached; Π₁ {s1.iterations} rounds "
        f"{ms1s:.1f} ms, Π₂ {s2.iterations} rounds {ms2s:.1f} ms; Π₁ = Π₂ "
        f"= BFS")
    return out


# --------------------------------------------------------------------------
# phase 5: the frontier worklist and its CSR cache
# --------------------------------------------------------------------------


def _frontier_operator(prog, db):
    """The frontier plan, its materialized operator and init vector."""
    from repro_torch.core import planner
    plan = planner.plan_program(prog, db, mode="sparse_frontier")
    return (plan, planner.materialize_edges(plan, db),
            planner.source_init(plan, prog, db))


def _seeded_edges(rng, n, k, dev):
    import torch
    return torch.from_numpy(rng.integers(0, n, (k, 2))).to(dev)


def phase_frontier(dev, data):
    """BM and CC Π₂ through ``mode="sparse_frontier"`` on the latency
    graph: the worklist on the card, its ⊕ B3's scatter path once a
    round; chunked, after an overlay and after a poisoned delete."""
    import numpy as np
    import torch
    from repro_torch.core import runners
    from repro_torch.core.program import run_program
    from repro_torch.datalog import programs
    from repro_torch.kernels import coo_segment
    from repro_torch.sparse import fixpoint as fx
    from repro_torch.sparse.coo import SparseRelation
    g, rng = data["g"], np.random.default_rng(7)
    dbs = data.setdefault("dbs", _dbs(dev, data))
    csr = csr_host(g.n, g.edges)
    progs = (("bm", programs.bm(a=0).optimized),
             ("cc", programs.cc().optimized))
    out, kept = {}, {}
    with Counted() as c:
        for kind, prog in progs:
            db = dbs[kind]
            (x, st), first_ms = wall(lambda: run_program(
                prog, db, mode="sparse_frontier"))
            if st.plan.strata[0].runner != "sparse_frontier":
                raise AssertionError(f"frontier {kind}: ran "
                                     f"{st.plan.strata[0].runner}")
            want = bfs_reach(csr, 0) if kind == "bm" else cc_min_labels(csr)
            if not np.array_equal(x.cpu().numpy(), want):
                raise AssertionError(f"frontier {kind}: answer differs from "
                                     f"the scipy oracle")
            plan, edges, init = _frontier_operator(prog, db)
            fresh = SparseRelation(edges.coords.clone(), edges.values.clone(),
                                   edges.nnz, edges.shape, edges.semiring)
            _, csr_ms = wall(lambda: fx.csr_index(fresh))
            y, iters, stats = fx.sparse_seminaive_fixpoint_stats(edges, init)
            if iters != st.iterations[0] or not torch.equal(
                    y.cpu(), x.cpu()):
                raise AssertionError(f"frontier {kind}: fixpoint and "
                                     f"run_program differ")
            # budget=1 chunks chained through the runner's run_chunk
            runner = runners.get("sparse_frontier")
            ctx = runners.make_context(edges, init, edges.semiring, 10_000)
            cst, chunks = fx.FixpointState.cold(edges, init), 0
            while not cst.converged:
                cst, _ = runner.run_chunk(ctx, cst, 1)
                chunks += 1
            y_c, it_c = cst.solution()
            if not torch.equal(y_c, y) or it_c != iters or chunks != iters:
                raise AssertionError(f"frontier {kind}: budget=1 chunks "
                                     f"differ from the cold run")
            # 1,000 seeded new edges: the child keeps the parent's base
            child = edges.apply_delta(_seeded_edges(rng, g.n, 1000, dev))
            base, idx = fx._csr_lookup(edges), fx._csr_lookup(child)
            if idx is None or idx.src is not base.src or \
                    idx.xsrc.shape[0] != 1000:
                raise AssertionError(f"frontier {kind}: apply_delta did not "
                                     f"extend the parent's CSR index")
            y_add, it_add = fx.fixpoint(child, init, mode="frontier")
            # 100 of its edges deleted: the same index, 0̄-poisoned
            pick = torch.from_numpy(rng.choice(child.nnz, 100,
                                               replace=False)).to(dev)
            gone = child.coords.index_select(0, pick)
            child2 = child.delete_keys(gone)
            idx2 = fx._csr_lookup(child2)
            if idx2 is None or idx2.counts is not idx.counts:
                raise AssertionError(f"frontier {kind}: delete_keys did not "
                                     f"poison the parent's CSR index")
            y_del, it_del = fx.fixpoint(child2, init, mode="frontier")
            kept[kind] = (child, y_add, it_add, child2, y_del, it_del, init)
            times = [wall(lambda: run_program(
                prog, db, mode="sparse_frontier"))[1] for _ in range(10)]
            busy = [busy_ms(lambda: run_program(
                prog, db, mode="sparse_frontier")) for _ in range(10)]
            data.setdefault("warm", {})[f"frontier_{kind}"] = \
                (lambda p=prog, d=db: run_program(p, d,
                                                  mode="sparse_frontier"))
            out[kind] = dict(
                rounds=iters, first_ms=first_ms, ms=_median(times),
                busy_ms=_median(busy), all_ms=times, csr_build_ms=csr_ms,
                edges_expanded=stats.total_edges, nnz=int(edges.nnz),
                rounds_x_nnz=iters * int(edges.nnz),
                frontier_sizes=stats.frontier_sizes,
                per_round_edges=stats.edges_expanded, chunks=chunks,
                delta_rounds=it_add, delete_rounds=it_del)
    b3 = c.b3_paths
    log(f"frontier launches {c.counts}; B3 paths {b3}")
    if c.counts["coo_segment"] <= 0 or b3 != {
            "runs": 0, "scatter": c.counts["coo_segment"]}:
        raise AssertionError(f"frontier: B3's {c.counts['coo_segment']} "
                             f"launches went {b3}, not all through scatter")
    # the staged references, outside the count (their B3 is runs)
    for kind, prog in progs:
        db = dbs[kind]
        x_j, st_j = run_program(prog, db)
        if st_j.plan.strata[0].runner != "sparse_jit":
            raise AssertionError(f"frontier {kind}: the latency plan is "
                                 f"{st_j.plan.strata[0].runner}")
        x_f, st_f = run_program(prog, db, mode="sparse_frontier")
        if not torch.equal(x_f, x_j) or st_f.iterations != st_j.iterations:
            raise AssertionError(f"frontier {kind}: differs from sparse_jit")
        child, y_add, it_add, child2, y_del, it_del, init = kept[kind]
        for name, rel, y, it in (("apply_delta", child, y_add, it_add),
                                 ("delete_keys", child2, y_del, it_del)):
            y_j, it_j = fx.fixpoint(rel, init, mode="jit")
            if not torch.equal(y, y_j) or it != it_j:
                raise AssertionError(f"frontier {kind}: after {name} the "
                                     f"worklist differs from sparse_jit")
        jt = [wall(lambda: run_program(prog, db))[1] for _ in range(10)]
        jb = [busy_ms(lambda: run_program(prog, db)) for _ in range(10)]
        o = out[kind]
        o.update(jit_ms=_median(jt), jit_busy_ms=_median(jb),
                 jit_rounds=st_j.iterations[0],
                 scatter=_b3_scatter_at(dev, data, kind,
                                        o["per_round_edges"]))
        log(f"frontier {kind}: {o['rounds']} rounds, Σ edges expanded "
            f"{o['edges_expanded']:,} against rounds × nnz "
            f"{o['rounds_x_nnz']:,}; warm median wall {o['ms']:.3f} ms, "
            f"device busy {o['busy_ms']:.3f} ms (sparse_jit "
            f"{o['jit_ms']:.3f} / {o['jit_busy_ms']:.3f} ms); CSR build "
            f"{o['csr_build_ms']:.2f} ms; B3 scatter per launch "
            + ", ".join(f"{k} entries {v['ms']:.4f} ms"
                        for k, v in o["scatter"].items())
            + f"; {o['chunks']} budget=1 chunks equal the cold run; "
            f"overlay and poisoned delete equal sparse_jit "
            f"[{nvidia_smi()}]")
    out["launches"] = c.counts
    out["b3_paths"] = b3
    return out


def _b3_scatter_at(dev, data, kind, sizes):
    """B3's scatter path per launch at the worklist's payload sizes (the
    smallest, median and largest round): that many entries with the
    operator's destination ids, against the plain version."""
    import torch
    from repro_torch.core import semiring as sr_mod
    from repro_torch.kernels import coo_segment, ref
    name = "bool" if kind == "bm" else "trop"
    sr = sr_mod.get(name)
    rel, rng = data["E"], data["rng"]
    n = rel.shape[1]
    live = sorted(s for s in sizes if s)
    out = {}
    for m in sorted({live[0], live[len(live) // 2], live[-1]}):
        pick = torch.from_numpy(rng.choice(rel.nnz, m,
                                           replace=m > rel.nnz)).to(dev)
        ids = rel.coords[:, 1].index_select(0, pick).to(torch.int32)
        vals = torch.from_numpy(frontier(rng, (m,), name, live=1.0)).to(dev)
        if name != "bool":
            vals = torch.where(sr.live(vals), vals, sr.one)

        def fn():
            return coo_segment.segment_reduce_cuda(name, vals, ids, n)
        err = _check(f"frontier {kind} {m}", "coo_segment", fn(),
                     ref.segment_reduce_ref(sr, vals, ids, n))
        out[str(m)] = dict(ms=time_ms(fn, 20, hide_host=True),
                           max_abs_err=err,
                           bound_ms=_bound(m * (vals.element_size() + 4)
                                           + n * vals.element_size())[0])
    return out


def _median(xs):
    return sorted(xs)[len(xs) // 2]


# --------------------------------------------------------------------------
# phase 6: the paper's Fig. 11 — FGH synthesis of Π₂ from Π₁
# --------------------------------------------------------------------------


def phase_fig11(dev, data):
    """Synthesize Π₂ from Π₁ on the host for BM, CC and SSSP (seed 0,
    rule-based), then run Π₁ and the synthesized Π₂ on the card: equal
    answers that match scipy, each program's time and the speedup; and
    B3's runs path at the rows a Π₁ round hands it."""
    import numpy as np
    from repro_torch.core import fgh, ir, verify
    from repro_torch.core.program import run_program
    from repro_torch.datalog import datasets, programs
    gp = datasets.powerlaw(N_FIG11, m_attach=4, seed=0)
    gw = datasets.erdos_renyi(N_FIG11, 4.0, seed=0, weighted=True,
                              wmax=FIG11_WMAX)
    cases = (("BM", programs.bm(a=0), ["E", "V"], gp),
             ("CC", programs.cc(), ["E", "V"], gp),
             ("SSSP", programs.sssp(a=0, wmax=FIG11_WMAX, dmax=64), ["E3"],
              gw))
    out, rows = {}, []
    counts = None
    for name, bench, edbs, graph in cases:
        task = verify.task_from_program(bench.original, edbs,
                                        constraint=bench.constraint)
        t0 = time.perf_counter()
        rep = fgh.optimize(task, rng=np.random.default_rng(0))
        synth_s = time.perf_counter() - t0
        if not rep.ok or rep.method != "rule":
            raise AssertionError(f"fig11 {name}: optimize gave ok={rep.ok} "
                                 f"method={rep.method}")
        if name == "CC" and not ir.isomorphic(
                rep.h_body, bench.optimized.strata[0].rules["CC"].body):
            raise AssertionError("fig11 CC: H is not the published one")
        db = bench.make_db(graph, device=dev)
        row = dict(synth_s=synth_s, h=ir.ssp_str(rep.h_body), n=graph.n,
                   edges=int(len(graph.edges)))
        answers = []
        for which, prog in (("pi1", bench.original), ("pi2", rep.program)):
            with Counted() as c:
                (x, st), first_ms = wall(lambda: run_program(prog, db))
                warm = [wall(lambda: run_program(prog, db))[1]
                        for _ in range(3)]
            answers.append(x)
            row[which] = dict(runner=st.plan.strata[0].runner,
                              storage=dict(st.plan.strata[0].storage),
                              iterations=st.iterations, first_ms=first_ms,
                              ms=_median(warm), launches=c.counts,
                              b2_paths=c.b2_paths, b3_paths=c.b3_paths)
            counts = c.counts if counts is None else {
                k: counts[k] + c.counts[k] for k in counts}
        if not np.array_equal(answers[0].cpu().numpy(),
                              answers[1].cpu().numpy()):
            raise AssertionError(f"fig11 {name}: Π₁ and the synthesized Π₂ "
                                 f"differ")
        if not np.array_equal(answers[1].cpu().numpy(),
                              _fig11_oracle(name, graph)):
            raise AssertionError(f"fig11 {name}: answer differs from the "
                                 f"scipy oracle")
        if row["pi1"]["b3_paths"]["runs"] and not rows:
            # BM's and CC's Π₁ hand B3 the same 𝔹 closure rows
            row["b3_rows"] = _b3_rows_at(bench.original, db)
            rows.append(row["b3_rows"])
        row["speedup"] = row["pi1"]["ms"] / row["pi2"]["ms"]
        out[name] = row
        log(f"fig11 {name}: H synthesized in {synth_s:.2f} s "
            f"({rep.method}); n={graph.n}: Π₁ {row['pi1']['runner']} "
            f"{row['pi1']['ms']:.2f} ms, Π₂ {row['pi2']['runner']} "
            f"{row['pi2']['ms']:.2f} ms, speedup {row['speedup']:.1f}×, "
            f"answers equal; Π₁ launches {row['pi1']['launches']} B2 "
            f"{row['pi1']['b2_paths']} B3 {row['pi1']['b3_paths']}; Π₂ "
            f"launches {row['pi2']['launches']} B2 {row['pi2']['b2_paths']}"
            f" B3 {row['pi2']['b3_paths']}; matches scipy [{nvidia_smi()}]")
        if "b3_rows" in row:
            r = row["b3_rows"]
            log(f"fig11 {name}: B3 runs on Π₁'s ({r['shape']['m']}, "
                f"{r['shape']['lanes']}) {r['semiring']} rows (round "
                f"{r['round']} of {r['rounds']}) {r['ms']:.4f} ms kernel, "
                f"{r['plain_ms']:.4f} ms plain, library {r['library_ms']:.4f}"
                f" ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                f"max|err| {r['max_abs_err']}")
    if not rows:
        raise AssertionError("fig11: no Π₁ ran B3's runs path on rows")
    out["launches"] = counts
    out["b3_rows"] = rows
    return out


def _fig11_oracle(name, graph):
    """scipy's answer for a fig11 case: BFS reach from node 0 (BM), the
    least label of each component (CC), shortest distances from node 0
    with the weights the relation stores (SSSP; unreached: inf)."""
    import numpy as np
    from scipy import sparse
    from scipy.sparse import csgraph
    if name == "BM":
        return bfs_reach(csr_host(graph.n, graph.edges), 0)
    if name == "CC":
        return cc_min_labels(csr_host(graph.n, graph.edges))
    w = np.minimum(graph.weights, FIG11_WMAX - 1).astype(np.float64)
    csr = sparse.csr_matrix((w, (graph.edges[:, 0], graph.edges[:, 1])),
                            shape=(graph.n, graph.n))
    return csgraph.dijkstra(csr, directed=True, indices=0).astype(np.float32)


def _b3_rows_at(prog, db):
    """B3's ``runs`` path on ``(m, B)`` rows at the inputs of one Π₁
    round, as the engine's sparse join hands them over (for 𝔹 the round
    whose answer is most mixed, else the middle one): exact against the
    plain version, timed beside it, ``Tensor.scatter_reduce_`` and the
    byte bound."""
    import torch
    from repro_torch.core import semiring as sr_mod
    from repro_torch.core.program import run_program
    from repro_torch.kernels import coo_segment, ref
    seen, launch = [], coo_segment.segment_reduce_cuda
    dispatch = coo_segment.segment_reduce

    def record(sr_name, vals, ids, n, *, plan=None):
        if vals.dim() == 2 and plan is not None:
            seen.append((sr_name, vals, ids, n, plan))
        return dispatch(sr_name, vals, ids, n, plan=plan)
    coo_segment.segment_reduce = record
    try:
        run_program(prog, db)
    finally:
        coo_segment.segment_reduce = dispatch
    # the middle round; for 𝔹 the round whose answer is most mixed
    pick = len(seen) // 2
    if seen[0][0] == "bool":
        shares = [float(ref.segment_reduce_ref(
            sr_mod.get("bool"), v, i.index_select(0, p.order), n_).float()
            .mean()) for _, v, i, n_, p in seen]
        pick = min(range(len(seen)), key=lambda j: abs(shares[j] - 0.5))
    name, vals, ids, n, plan = seen[pick]
    sr = sr_mod.get(name)
    order_ids = ids.index_select(0, plan.order)
    want = ref.segment_reduce_ref(sr, vals, order_ids, n)
    if name == "bool":
        _assert_mixed("fig11 B3 rows", want)
    paths = dict(launch.by_path)

    def fn():
        return launch(name, vals, ids, n, plan)
    err = _check(f"{name} rows", "coo_segment", fn(), want)
    paths["runs"] += 1
    if launch.by_path != paths:
        raise AssertionError(f"fig11 B3 rows: by_path {launch.by_path}, "
                             f"expected one more runs")
    lanes = int(vals.shape[1])
    lib_vals = vals.view(torch.uint8) if name == "bool" else vals
    index = order_ids.long()[:, None].expand(-1, lanes)

    def library():
        out = torch.full((n, lanes), 0 if name == "bool" else sr.zero,
                         dtype=lib_vals.dtype, device=vals.device)
        return out.scatter_reduce_(0, index, lib_vals,
                                   sr_mod.SCATTER_REDUCE[name],
                                   include_self=True)
    if max_abs_err(library(), want) != 0.0:
        raise AssertionError("fig11 B3 rows: scatter_reduce_ yardstick "
                             "disagrees")
    isz = vals.element_size()
    nbytes = (plan.m_live * lanes * isz + 8 * plan.items.n_items
              + n * lanes * isz)
    bound, by_what = _bound(nbytes)
    return dict(semiring=name, round=pick + 1, rounds=len(seen),
                shape={"m": int(vals.shape[0]), "n": n, "lanes": lanes},
                path="runs", max_abs_err=err,
                ms=time_ms(fn, 10, hide_host=True),
                plain_ms=time_ms(lambda: ref.segment_reduce_ref(
                    sr, vals, order_ids, n), 3),
                library_ms=time_ms(library, 10, hide_host=True),
                library_call="Tensor.scatter_reduce_", bound_ms=bound,
                bound_by=by_what, bytes=nbytes,
                true_share=(float(want.float().mean())
                            if name == "bool" else None))


# --------------------------------------------------------------------------
# phase 16: the paper's Fig. 12 — the CEGIS group (WS, BC, R, MLM)
# --------------------------------------------------------------------------

#: Fig. 12's parameters, the benchmark's own (``benchmarks/
#: fgh_scaling.py``): WS's window and value bound, BC's average degree
#: (``erdos_renyi(n, 2.0)``, ``dmax = max(16, n // 4)``), R's distance
#: domain ``tree_depth + 2``, seed 0 throughout
FIG12_WINDOW, FIG12_VMAX, FIG12_BC_DEG, FIG12_SEED = 10, 6, 2.0, 0
#: the series, each at one n of the benchmark's doubling sequence (WS:
#: 128, 256, …; the rest 64, 128, …): the largest at which one Π₁ run
#: peaks under 8 GB of device memory and takes under 30 s on the card
#: (``tools/fig12_timing.py --sweep``), cut where the phase's 150 s
#: would not hold (R/rrt, MLM/decay) or where the sweep stopped
#: (MLM/rrt); PERF.md §4 gives the times behind each.  Each series also
#: runs at n / 2, so the speedup's growth with n is seen
FIG12_SIZES = {"WS": 512, "BC": 256, "R/rrt": 1024, "R/decay": 256,
               "MLM/rrt": 8192, "MLM/decay": 2048}
#: BC's Π₂ alone at the fig11 phase's n
FIG12_BC_BIG = N_FIG11
#: the series whose Π₁ also runs through ``mode="host"``
FIG12_HOST = "MLM/rrt"
#: ℕ and real answers within this share of max |oracle|
FIG12_TOL = 1e-4
#: Π₁ and Π₂ are timed on a first call and this many warm ones
FIG12_WARM = 3


def fig12_instance(key, n, dev):
    """One series' program at ``n``: ``(bench, database, oracle, exact,
    meta)``; ``exact``: the answer is trop-like and must equal its
    oracle bit for bit (R), else it is held within ``FIG12_TOL`` of max
    |oracle| (WS and MLM over ℕ, BC over the reals)."""
    from repro_torch.datalog import datasets, programs
    name, _, family = key.partition("/")
    if name == "WS":
        b = programs.ws(window=FIG12_WINDOW, vmax=FIG12_VMAX)
        vals = datasets.vector_data(n, seed=FIG12_SEED, vmax=FIG12_VMAX)
        return b, b.make_db(vals, device=dev), _ws_oracle(vals), False, \
            {"n": n}
    if name == "BC":
        dmax = max(16, n // 4)
        b = programs.bc(dmax=dmax)
        g = datasets.erdos_renyi(n, FIG12_BC_DEG, seed=FIG12_SEED)
        return b, b.make_db(g, device=dev), brandes_oracle(g)[0], False, \
            {"n": n, "dmax": dmax, "edges": int(len(g.edges))}
    gen = (datasets.random_recursive_tree if family == "rrt"
           else datasets.decay_tree)
    g = gen(n, seed=FIG12_SEED)
    depth = datasets.tree_depth(g)
    if name == "R":
        b = programs.radius(dmax=depth + 2)
        oracle = _tree_heights(g)
    else:
        b = programs.mlm()
        oracle = _subtree_sums(g)
    return b, b.make_db(g, device=dev), oracle, name == "R", \
        {"n": n, "depth": depth}


def _ws_oracle(vals):
    """S[t] = P[t] − P[t − window] over the prefix sums P of the values
    (clamped to the value domain, as ``make_db`` stores them)."""
    import numpy as np
    pref = np.cumsum(np.minimum(vals, FIG12_VMAX - 1).astype(np.float64))
    return pref - np.concatenate([np.zeros(FIG12_WINDOW),
                                  pref[:-FIG12_WINDOW]])


def _subtree_sums(g):
    """MLM: the sum of the vertex ids of each vertex's subtree (children
    follow their parents in id order)."""
    import numpy as np
    out = np.arange(g.n, dtype=np.float64)
    for p, c in g.edges[::-1]:
        out[p] += out[c]
    return out


def _tree_heights(g):
    """R: the height of each vertex's subtree, from scipy's BFS depths
    off the root: the deepest descendant's depth less the vertex's."""
    import numpy as np
    from scipy import sparse
    from scipy.sparse import csgraph
    csr = sparse.csr_matrix((np.ones(len(g.edges)), (g.edges[:, 0],
                                                      g.edges[:, 1])),
                            shape=(g.n, g.n))
    depth = csgraph.shortest_path(csr, unweighted=True, indices=0)
    deepest = depth.copy()
    for p, c in g.edges[::-1]:
        deepest[p] = max(deepest[p], deepest[c])
    return (deepest - depth).astype(np.float32)


def brandes_oracle(g):
    """Betweenness centrality by Brandes' algorithm in float64 on the
    host, all sources at once and one BFS level at a time over
    ``scipy.sparse``: a level's (source, vertex) pairs and path counts σ
    as a sparse matrix F, the next level the unvisited pairs of F·E; the
    backward pass δ(s, v) = σ_sv · Σ_w E[v, w] (1 + δ(s, w)) / σ_sw over
    the next level's pairs, from the deepest level up.  Unnormalized,
    directed, as the programs compute it.  Returns ``(B, levels)``:
    levels is the deepest BFS level of any source."""
    import numpy as np
    from scipy import sparse
    n = g.n
    e = sparse.csr_matrix((np.ones(len(g.edges)), (g.edges[:, 0],
                                                    g.edges[:, 1])),
                          shape=(n, n))
    e.data[:] = 1.0                     # duplicate edges count once
    et = e.T.tocsr()
    seen = np.zeros(n * n, bool)
    ids = np.arange(n)
    seen[ids * n + ids] = True
    levels = [(ids, ids, np.ones(n))]   # (sources, vertices, σ)
    while True:
        s, v, sig = levels[-1]
        nxt = (sparse.csr_matrix((sig, (s, v)), shape=(n, n)) @ e).tocoo()
        keys = nxt.row.astype(np.int64) * n + nxt.col
        new = ~seen[keys]
        if not new.any():
            break
        seen[keys[new]] = True
        levels.append((nxt.row[new], nxt.col[new], nxt.data[new]))
    delta = [np.zeros(len(lv[0])) for lv in levels]
    for lv in range(len(levels) - 1, 0, -1):
        s, w, sig = levels[lv]
        back = (sparse.csr_matrix(((1.0 + delta[lv]) / sig, (s, w)),
                                  shape=(n, n)) @ et).tocsr()
        back.sort_indices()
        bc = back.tocoo()
        bkeys = bc.row.astype(np.int64) * n + bc.col
        s0, v0, sig0 = levels[lv - 1]
        keys = s0.astype(np.int64) * n + v0
        at = np.minimum(np.searchsorted(bkeys, keys), len(bkeys) - 1)
        hit = bkeys[at] == keys if len(bkeys) else np.zeros(len(keys), bool)
        delta[lv - 1] += np.where(hit, sig0 * bc.data[at], 0.0)
    out = np.zeros(n)
    for (s, v, _), d in zip(levels[1:], delta[1:]):
        out += np.bincount(v, weights=d, minlength=n)
    return out, len(levels) - 1


def _fig12_gate(what, got, want, exact):
    """Bit for bit (``exact``) or within ``FIG12_TOL`` of max |want|;
    returns max |err|."""
    import numpy as np
    g = got.detach().cpu().double().numpy() \
        if hasattr(got, "detach") else np.asarray(got, np.float64)
    w = want.detach().cpu().double().numpy() \
        if hasattr(want, "detach") else np.asarray(want, np.float64)
    if g.shape != w.shape:
        raise AssertionError(f"fig12 {what}: shape {g.shape} vs {w.shape}")
    same = (g == w) | (np.isinf(g) & np.isinf(w) & (np.sign(g) ==
                                                     np.sign(w)))
    err = float(np.abs(np.where(same, 0.0, g - w)).max()) if g.size else 0.0
    tol = 0.0 if exact else FIG12_TOL * max(float(np.abs(
        w[np.isfinite(w)]).max(initial=0.0)), 1e-30)
    if err > tol:
        raise AssertionError(f"fig12 {what}: max |err| {err} over the "
                             f"tolerance {tol}")
    return err


def _fig12_synthesize():
    """Π₂ of WS, R and MLM from their Π₁ by ``fgh.optimize`` (seed 0) on
    the host; each must be ``ok`` by the CEGIS method (BC's Π₂ is the
    given Brandes program, as in the benchmark)."""
    import numpy as np
    from repro_torch.core import fgh, verify
    from repro_torch.datalog import programs
    out = {}
    for name, bench, edbs in (
            ("WS", programs.ws(window=FIG12_WINDOW, vmax=FIG12_VMAX),
             ["A2"]),
            ("R", programs.radius(), ["E", "V"]),
            ("MLM", programs.mlm(), ["E", "V"])):
        task = verify.task_from_program(bench.original, edbs,
                                        constraint=bench.constraint)
        t0 = time.perf_counter()
        rep = fgh.optimize(task, rng=np.random.default_rng(0))
        synth_s = time.perf_counter() - t0
        if not rep.ok or rep.method != "cegis":
            raise AssertionError(f"fig12 {name}: optimize gave ok={rep.ok} "
                                 f"method={rep.method}")
        if bench.original.post is not None:
            rep.program.post = bench.original.post
        out[name] = (rep, synth_s)
    return out


def _fig12_timed(prog, db):
    """A first call and ``FIG12_WARM`` warm ones: (answer, stats, first
    ms, warm ms, launches and B2/B3 paths of all of them)."""
    from repro_torch.core.program import run_program
    with Counted() as c:
        (x, st), first_ms = wall(lambda: run_program(prog, db))
        warm = [wall(lambda: run_program(prog, db))[1]
                for _ in range(FIG12_WARM)]
    return x, st, first_ms, warm, c


def _fig12_row(key, n, pi2, dev, data):
    """One series at ``n``: Π₁ and Π₂ (``pi2``; BC's own Brandes program
    when None) timed, gated against the oracle and against each other.
    Returns the row and the two runs' ``Counted``."""
    import torch
    from repro_torch.core.program import run_program
    bench, db, oracle, exact, meta = fig12_instance(key, n, dev)
    pi2 = bench.optimized if pi2 is None else pi2
    row = dict(meta)
    answers, counted = {}, []
    for which, prog in (("pi1", bench.original), ("pi2", pi2)):
        torch.cuda.reset_peak_memory_stats()
        x, st, first_ms, warm, c = _fig12_timed(prog, db)
        answers[which] = x
        counted.append(c)
        row[which] = dict(
            runners=[sp.runner for sp in st.plan.strata],
            storage=[dict(sp.storage) for sp in st.plan.strata],
            iterations=st.iterations, first_ms=first_ms,
            ms=_median(warm), warm_ms=warm,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches=c.counts, b2_paths=c.b2_paths, b3_paths=c.b3_paths,
            max_abs_err=_fig12_gate(f"{key} {which} n={n}", x, oracle,
                                    exact))
    row["pi1_pi2_max_abs_err"] = _fig12_gate(
        f"{key} Π₁ = Π₂ n={n}", answers["pi1"], answers["pi2"], exact)
    row["speedup"] = row["pi1"]["ms"] / row["pi2"]["ms"]
    log(f"fig12 {key} n={n}{' ' + str(meta) if len(meta) > 1 else ''}: "
        f"Π₁ {row['pi1']['runners']} {row['pi1']['iterations']} rounds "
        f"first {row['pi1']['first_ms']:.1f} ms, warm "
        f"{row['pi1']['ms']:.1f} ms, peak {row['pi1']['peak_gb']:.2f} GB; "
        f"Π₂ {row['pi2']['runners']} first {row['pi2']['first_ms']:.1f} "
        f"ms, warm {row['pi2']['ms']:.2f} ms; speedup "
        f"{row['speedup']:.1f}×; B2 Π₁ {row['pi1']['b2_paths']} Π₂ "
        f"{row['pi2']['b2_paths']}; B3 Π₁ {row['pi1']['b3_paths']} Π₂ "
        f"{row['pi2']['b3_paths']}; answers = oracle, Π₁ = Π₂")
    if key == "BC" and n == FIG12_SIZES["BC"]:
        data.setdefault("warm", {}).update(
            fig12_bc_pi1=lambda p=bench.original, d=db: run_program(p, d),
            fig12_bc_pi2=lambda p=pi2, d=db: run_program(p, d))
    return row, counted


def phase_fig12(dev, data, sizes=None):
    """The twin of ``benchmarks/fgh_scaling.py`` (paper Fig. 12): Π₂ of
    WS, R and MLM synthesized on the host by CEGIS, BC's Π₂ the given
    Brandes program; Π₁ and Π₂ of each series run on the card at half
    its ``FIG12_SIZES`` n and at n, held against a numpy/scipy oracle
    and against each other; BC's Π₂ alone at n = ``FIG12_BC_BIG``; B2
    at Brandes' product shape; (b) ``mode="host"``; (c)
    ``cost_model="hlo"`` plans (:func:`_fig12_hlo_plans`)."""
    import torch
    from repro_torch.core.program import run_program
    from repro_torch.datalog import datasets, programs
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    sizes = FIG12_SIZES if sizes is None else sizes
    out = {"power": nvidia_smi(), "series": {}}
    log(f"fig12 on {out['power']}")
    synth = _fig12_synthesize()
    out["synth_s"] = {k: s for k, (_, s) in synth.items()}
    log(f"fig12 synthesis (host, CEGIS): " + ", ".join(
        f"{k} {s:.1f} s" for k, s in out["synth_s"].items()))
    counts = dict.fromkeys(ops.launch_counts(), 0)
    b2_paths = {}
    for key, n in sizes.items():
        name = key.split("/")[0]
        pi2 = None if name == "BC" else synth[name][0].program
        rows = {}
        for m in (n // 2, n):
            rows[m], c_rows = _fig12_row(key, m, pi2, dev, data)
            for c in c_rows:
                for k, v in c.counts.items():
                    counts[k] += v
                for k, v in c.b2_paths.items():
                    b2_paths[k] = b2_paths.get(k, 0) + v
        half, full = rows[n // 2]["speedup"], rows[n]["speedup"]
        out["series"][key] = {"n": n, "rows": rows,
                              "speedup_grows": full > half}
        log(f"fig12 {key}: speedup {half:.1f}× at n={n // 2}, {full:.1f}× "
            f"at n={n}: {'grows' if full > half else 'does not grow'} "
            f"with n")
    # BC's Π₂ alone at the fig11 phase's n, with TF32 allowed globally:
    # Brandes pins its products to f32 itself
    g = datasets.erdos_renyi(FIG12_BC_BIG, FIG12_BC_DEG, seed=FIG12_SEED)
    bench = programs.bc(dmax=max(16, FIG12_BC_BIG // 4))
    db = bench.make_db(g, device=dev)
    t0 = time.perf_counter()
    oracle, levels = brandes_oracle(g)
    oracle_s = time.perf_counter() - t0
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        x, st, first_ms, warm, c = _fig12_timed(bench.optimized, db)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for k, v in c.counts.items():
        counts[k] += v
    out["bc_big"] = dict(
        n=g.n, edges=int(len(g.edges)), levels=levels, first_ms=first_ms,
        ms=_median(warm), warm_ms=warm, oracle_s=oracle_s,
        max_abs_err=_fig12_gate(f"BC Π₂ n={g.n}", x, oracle, False),
        tf32_allowed=True, launches=c.counts)
    data.setdefault("warm", {})["fig12_bc_pi2_big"] = \
        lambda p=bench.optimized, d=db: run_program(p, d)
    log(f"fig12 BC Π₂ alone n={g.n} ({len(g.edges)} edges, {levels} "
        f"levels): first {first_ms:.1f} ms, warm {_median(warm):.1f} ms "
        f"{warm}; = Brandes in float64 (max |err| "
        f"{out['bc_big']['max_abs_err']:.3g}; host oracle {oracle_s:.1f} s)")
    out["b2_checks"] = _fig12_b2_checks(db, dev)
    out["host_mode"] = _fig12_host_mode(dev, FIG12_HOST, sizes[FIG12_HOST])
    with Counted() as c:
        out["hlo_plans"] = _fig12_hlo_plans(dev, data)
    for k, v in c.counts.items():
        counts[k] += v
    out["launches"] = counts
    out["b2_paths"] = b2_paths
    out["seconds"] = time.perf_counter() - t_phase
    log(f"fig12 launches {counts}; Π₁/Π₂ B2 paths {b2_paths} "
        f"({out['seconds']:.1f} s) [{out['power']}]")
    _free_cuda()
    return out


def _fig12_b2_checks(db_big, dev):
    """B2's ``tile_f32`` at two ℕ shapes, each held exactly against its
    plain version and timed beside ``torch.matmul`` f32 (TF32 off) and
    its bound, not counted: Brandes' forward product at n =
    ``FIG12_BC_BIG`` (a level's path counts ``where(fr, σ, 0)`` ⊕.⊗ E,
    ``db_big``'s graph), and the matrix-vector product MLM's Π₂ hands it
    in its first round (``E ⊗ M``, (n × n)·(n × 1), at MLM/rrt's n; the
    engine takes it to the tile path, as every product of more than
    ``M_STREAM`` rows)."""
    import torch
    e = db_big.relations["E"].to(torch.float32)
    n = e.shape[0]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        # the level-2 frontier's counts: σ of the vertices two hops out
        two = e @ e
        fr = (two > 0) & (e == 0) & ~torch.eye(n, dtype=torch.bool,
                                               device=e.device)
        out = {"brandes": _fig12_b2_timed("Brandes' forward product",
                                          torch.where(fr, two, 0.0), e)}
        del two, fr
        _, db, _, _, meta = fig12_instance("MLM/rrt",
                                           FIG12_SIZES["MLM/rrt"], dev)
        # the first round's M, the vertex ids: later rounds' subtree sums
        # pass 2²⁴, where f32 ℕ sums stop being exact in any order
        ids = torch.arange(meta["n"], dtype=torch.float32, device=dev)
        out["mlm_pi2"] = _fig12_b2_timed(
            f"MLM Π₂'s first E ⊗ M at n={meta['n']}",
            db.relations["E"].to(torch.float32), ids[:, None])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return out


def _fig12_b2_timed(what, a, b):
    """B2 in ℕ on ``a`` ⊕.⊗ ``b`` against its plain version (exact) and
    ``torch.matmul``; ms beside the bound (operations 2·m·k·n at the
    FP32 SIMT rate, bytes A, B and C once)."""
    import torch
    from repro_torch.core import semiring as sr_mod
    from repro_torch.kernels import ref, semiring_matmul
    (m, k), n = a.shape, b.shape[1]
    path, _ = semiring_matmul.plan_matmul("nat", m, k, n)
    want = ref.semiring_matmul_ref(sr_mod.get("nat"), a, b)
    err = _check(f"nat {m}x{k}x{n} ({what})", "semiring_matmul",
                 semiring_matmul.semiring_matmul_cuda("nat", a, b), want)
    if max_abs_err(torch.matmul(a, b), want) != 0.0:
        raise AssertionError(f"torch.matmul yardstick disagrees ({what})")
    bound, by_what = _bound(4.0 * (m * k + k * n + m * n), 2.0 * m * k * n)
    res = dict(shape={"m": m, "k": k, "n": n}, path=path, max_abs_err=err,
               ms=time_ms(lambda: semiring_matmul.semiring_matmul_cuda(
                   "nat", a, b), 10, hide_host=True),
               plain_ms=time_ms(lambda: ref.semiring_matmul_ref(
                   sr_mod.get("nat"), a, b), 3),
               library_ms=time_ms(lambda: torch.matmul(a, b), 10,
                                  hide_host=True),
               library_call="torch.matmul (f32, TF32 off)", bound_ms=bound,
               bound_by=by_what)
    res["share_of_bound"] = bound / res["ms"]
    log(f"fig12 B2 {path} at {what} ({m}×{k}×{n} ℕ): {res['ms']:.4f} ms, "
        f"plain {res['plain_ms']:.4f} ms, torch.matmul f32 "
        f"{res['library_ms']:.4f} ms, bound {bound:.4f} ms ({by_what}; "
        f"the kernel at {100 * res['share_of_bound']:.0f}% of it), "
        f"max|err| {err}")
    return res


def _fig12_host_mode(dev, key, n):
    """(b) The series ``key``'s Π₁ at ``n`` through ``mode="host"`` (the
    ``dense_host`` runner) against ``mode="naive"``: equal answers and
    iteration counts."""
    import torch
    from repro_torch.core.program import run_program
    bench, db, _, _, meta = fig12_instance(key, n, dev)
    (x, st), host_ms = wall(lambda: run_program(bench.original, db,
                                                mode="host"))
    (y, st2), naive_ms = wall(lambda: run_program(bench.original, db,
                                                  mode="naive"))
    runners = [sp.runner for sp in st.plan.strata]
    if runners != ["dense_host"] or not torch.equal(x, y) or \
            st.iterations != st2.iterations:
        raise AssertionError(f"fig12 host mode: runners {runners}, "
                             f"iterations {st.iterations} vs "
                             f"{st2.iterations}, answers equal "
                             f"{torch.equal(x, y)}")
    log(f"fig12 {key} Π₁ n={meta['n']} mode=host: {st.iterations} rounds "
        f"{host_ms:.1f} ms; mode=naive {st2.iterations} rounds "
        f"{naive_ms:.1f} ms; equal")
    return dict(series=key, n=meta["n"], iterations=st.iterations,
                host_ms=host_ms,
                naive_ms=naive_ms)


def _fig12_hlo_plans(dev, data):
    """(c) ``plan_program(cost_model="hlo")`` against the analytic plan
    on the latency graph (BM and CC Π₂) and the fgh phase's dense graph
    (BM Π₁ and Π₂): each candidate's staged and analytic FLOPs and bytes
    an iteration, the runner each model picks, the planning ms and its
    peak memory; both plans run, their answers equal."""
    import torch
    from repro_torch.core import planner
    from repro_torch.core.program import run_program
    from repro_torch.datalog import programs
    from repro_torch.launch import hlo_cost
    dbs = data.setdefault("dbs", _dbs(dev, data))
    bm = programs.bm(a=0)
    dense = bm.make_db(data["gd"], device=dev)
    # a process's first counted op pays for torch's dispatch-mode set-up
    # (importing torch._dynamo): timed apart from the plans
    _, first_ms = wall(lambda: hlo_cost.staged_cost(
        lambda x: x + 1, torch.zeros(1, device=dev)))
    out = {"first_count_ms": first_ms}
    log(f"fig12 hlo: the process's first staged count {first_ms:.1f} ms")
    for name, prog, db in (("latency BM Π₂", bm.optimized, dbs["bm"]),
                           ("latency CC Π₂", programs.cc().optimized,
                            dbs["cc"]),
                           ("dense BM Π₁", bm.original, dense),
                           ("dense BM Π₂", bm.optimized, dense)):
        row, answers = {}, {}
        for model in ("analytic", "hlo"):
            _free_cuda()
            torch.cuda.reset_peak_memory_stats()
            plan, ms = wall(lambda: planner.plan_program(prog, db,
                                                         cost_model=model))
            peak = torch.cuda.max_memory_allocated() / 1e9
            answers[model], st = run_program(prog, db, plan=plan)
            row[model] = dict(
                plan_ms=ms, plan_peak_gb=peak,
                runners=[sp.runner for sp in plan.strata],
                iterations=st.iterations,
                rejected=[dict(sp.rejected) for sp in plan.strata],
                considered=[{k: dict(flops=c.flops_per_iter,
                                     bytes=c.bytes_per_iter, trips=c.trips,
                                     source=c.source)
                             for k, c in sp.considered.items()}
                            for sp in plan.strata])
        if not torch.equal(answers["analytic"], answers["hlo"]):
            raise AssertionError(f"fig12 hlo {name}: the hlo plan's answer "
                                 f"differs from the analytic plan's")
        out[name] = row
        cands = "; ".join(
            f"{k} {c['flops']:.3g}/{c['bytes']:.3g} (analytic "
            f"{row['analytic']['considered'][0][k]['flops']:.3g}/"
            f"{row['analytic']['considered'][0][k]['bytes']:.3g})"
            for k, c in row["hlo"]["considered"][0].items())
        only_hlo = {k: v for k, v in row["hlo"]["rejected"][0].items()
                    if k not in row["analytic"]["rejected"][0]}
        log(f"fig12 hlo {name}: analytic picks {row['analytic']['runners']} "
            f"in {row['analytic']['plan_ms']:.1f} ms, hlo picks "
            f"{row['hlo']['runners']} in {row['hlo']['plan_ms']:.1f} ms "
            f"(peak {row['hlo']['plan_peak_gb']:.2f} GB); staged flops/bytes "
            f"an iteration: {cands}; rejected under hlo only: {only_hlo}; "
            f"answers equal")
    del dense
    return out


# --------------------------------------------------------------------------
# phase 7: incremental maintenance under streaming updates
# --------------------------------------------------------------------------

#: the twin of ``benchmarks/incremental_update.py`` at its defaults:
#: ``powerlaw(N_INC, 4, seed=INC_SEED)``, weights ``default_rng(INC_SEED)
#: .integers(1, INC_WMAX)``, source 0, INC_TRIALS trials a row, updates
#: drawn from ``default_rng(INC_SEED + 1)``
N_INC, INC_SEED, INC_WMAX, INC_TRIALS = 50_000, 1, 8, 3
#: the latency graph's refresh rows: (op, edges) through DeltaLog
INC_LOGS = (("insert", 1), ("insert", 1000), ("delete", 1),
            ("delete", 100))
#: the rule ``explain()`` must name for every delete row
INC_RULE = "⊖-recount[seed=supported, cone=tight]"


def phase_incremental(dev, data):
    """Streaming updates on the card: (a) the twin of
    ``benchmarks/incremental_update.py`` — each update row answered by a
    full recompute, by the maintained staged loop and by the maintained
    worklist, all equal bit for bit, with the planner's pick under
    ``objective="incremental"``; (b) ``Database.apply_delta`` +
    ``refresh_program`` on the latency graph for BM and CC Π₂, against
    scipy on the mutated edge list and ``run_program`` from scratch; (c)
    B3 at the shapes this path hands it, against its plain version."""
    out = {}
    t0 = time.perf_counter()
    with Counted() as c:
        out["update"] = _inc_update_rows(dev)
        out["refresh"] = _inc_refresh_rows(dev, data)
    out["launches"] = c.counts
    out["b3_paths"] = c.b3_paths
    log(f"incremental launches {c.counts}; B3 paths {c.b3_paths}")
    if c.counts["coo_segment"] <= 0 or not c.b3_paths["runs"] \
            or not c.b3_paths["scatter"]:
        raise AssertionError(f"incremental: B3 paths {c.b3_paths}: the "
                             f"staged resume must launch runs, the "
                             f"worklist and the recount scatter")
    out["b3_checks"] = _inc_b3_checks(dev, data)
    out["breakdown"] = {kind: _inc_breakdown(dev, data, kind)
                        for kind in ("bm", "cc")}
    out["seconds"] = time.perf_counter() - t0
    log(f"incremental phase: {out['seconds']:.1f} s")
    return out


def _inc_breakdown(dev, data, kind):
    """Where a delete refresh's time goes (BM or CC Π₂, 100 deleted
    edges on the latency graph): ``refresh_program``'s steps run one by
    one, each timed with the device synchronized."""
    import numpy as np
    import torch
    from repro_torch.core import planner, vectorize
    from repro_torch.core.program import run_program
    from repro_torch.datalog import programs
    from repro_torch.incremental import DeltaLog, ensure_rule, maintenance
    from repro_torch.incremental import restart
    from repro_torch.sparse import fixpoint as fx
    g = data["g"]
    db = data["dbs"][kind]
    prog = (programs.bm(a=0) if kind == "bm" else programs.cc()).optimized
    prev, _ = run_program(prog, db)
    dlog = DeltaLog().delete("E", g.edges[np.random.default_rng(13).choice(
        len(g.edges), 100, replace=False)])
    ms, t = {}, _clock()

    def lap(name):
        nonlocal t
        now = _clock()
        ms[name] = now - t
        t = now
    vf = vectorize.vector_form(prog)
    rule = ensure_rule(vf.signature, vf.semiring, "delete")
    a = vectorize.edge_atom(vf)
    removed = restart._oriented(restart._removed_rel(
        db, a.name, dlog.removed_coords(a.name)), a, vf)
    lap("gather_old_values")
    db2 = db.apply_delta(dlog)
    lap("apply_delta")
    plan = planner.plan_program(prog, db2, objective="incremental",
                                delta_nnz=dlog.nnz(), delta_op="delete")
    lap("plan_program")
    edges = planner.materialize_edges(plan, db2)
    init = vectorize.init_vector(vf, db2)
    lap("operator_and_init")
    fx.csr_index(edges)
    fx.csr_index(edges, transpose=True)
    lap("csr_index")
    sr = edges.sr()
    k = removed.nnz
    y0 = prev.clone()
    cone = maintenance._cone(rule, prev, removed.coords[:k].long(),
                             removed.values[:k], edges, sr)
    y0.index_fill_(0, cone, sr.zero)
    lap("cone")
    d0 = sr.zeros(tuple(prev.shape), dev)
    d0.index_copy_(0, cone, maintenance._recount(cone, y0, init, edges,
                                                 sr))
    lap("recount")
    edges.runs(1, 0)
    lap("segment_plan")
    y, it = fx.fixpoint(edges, state=fx.FixpointState(
        y0[None], d0[None], torch.zeros(1, dtype=torch.int32, device=dev),
        edges.semiring, False), mode="jit")
    lap("resume")
    want, _ = run_program(prog, db2)
    if not torch.equal(y, want):
        raise AssertionError(f"incremental breakdown {kind}: differs")
    out = dict(ms=ms, total_ms=sum(ms.values()), cone=int(cone.shape[0]),
               rounds=it)
    log(f"incremental breakdown {kind} delete 100: cone {out['cone']} "
        f"vertices, {it} rounds; "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f" ms; total {out['total_ms']:.3f} ms")
    return out


def _clock():
    import torch
    torch.cuda.synchronize()
    return time.perf_counter() * 1e3


def _b3_delta(paths0):
    from repro_torch.kernels import coo_segment
    return {k: v - paths0[k]
            for k, v in coo_segment.segment_reduce_cuda.by_path.items()}


def _b3_now():
    from repro_torch.kernels import coo_segment
    return dict(coo_segment.segment_reduce_cuda.by_path)


def _inc_one_hot(n, sem, dev):
    from repro_torch.core import semiring as sr_mod
    sr = sr_mod.get(sem)
    init = sr.zeros((n,), dev)
    init[0] = sr.one
    return init


def _inc_rand_delta(rng, n, k, sem):
    """``benchmarks/incremental_update.py``'s ``_rand_delta``."""
    import numpy as np
    coords = np.stack([rng.integers(0, n, k), rng.integers(0, n, k)],
                      axis=1)
    values = (np.ones(k, bool) if sem == "bool"
              else rng.integers(1, INC_WMAX, k).astype(np.float32))
    return coords, values


def _inc_pick(n, rel, k, op, dev):
    """The planner's pick under ``objective="incremental"`` with the
    weighted COO operator as the edges override (SSSP's E3 would be a
    dense (n, n, w) tensor), as the benchmark's ``_planner_pick``; for a
    delete the rule is ensured first and ``explain()`` must name it."""
    from repro_torch.core import engine, planner
    from repro_torch.datalog import programs
    from repro_torch.incremental import ensure_rule
    if rel.semiring == "bool":
        b = programs.bm(a=0)
        db = engine.Database(b.original.schema, {"id": n}, {}, dev)
    else:
        b = programs.sssp(a=0, wmax=INC_WMAX, dmax=64)
        db = engine.Database(b.original.schema,
                             {"id": n, "w": INC_WMAX, "d": 64}, {}, dev)

    def plan():
        return planner.plan_program(b.optimized, db,
                                    objective="incremental", edges=rel,
                                    delta_nnz=k, delta_op=op)
    p = plan()
    if op != "merge":
        sp = p.strata[0]
        ensure_rule(sp.vf.signature, sp.vf.semiring, op)
        p = plan()
        if INC_RULE not in planner.explain(p):
            raise AssertionError(f"incremental: explain() does not name "
                                 f"{INC_RULE}: {p.strata[0].reason}")
    return p.strata[0].runner


def _rebuilt_without(rel, coords):
    """The pre-maintenance delete: the live entries minus every copy of
    the deleted keys, as a fresh relation (no segment plan, no CSR
    index) on the device."""
    import torch
    from repro_torch.sparse.coo import SparseRelation
    k = rel.nnz
    keep = ~torch.isin(rel._flat_keys(rel.coords[:k]),
                       rel._flat_keys(rel._keys(coords)))
    return SparseRelation(rel.coords[:k][keep].contiguous(),
                          rel.values[:k][keep], int(keep.sum()), rel.shape,
                          rel.semiring)


def _inc_ways(rel, init, y_star, update, rule, dev):
    """One update answered three ways: ``full`` (rebuild, then a cold
    staged fixpoint), ``jit`` (apply_delta/delete_keys, then the staged
    repair, whose first resumed round builds the segment plan over E′:
    ``plan_ms`` times that build alone on another child) and
    ``frontier`` (the worklist over the overlaid or poisoned CSR index).
    Returns ``(answers, rounds, ms, plan_ms, b3 paths, closures)``."""
    from repro_torch.incremental import (delta_restart_fixpoint,
                                         maintain_nonmonotone)
    from repro_torch.sparse import fixpoint as fx
    from repro_torch.sparse.coo import SparseRelation
    dels, dvals, mc, mv = update
    sem = rel.semiring

    def merge_rel():
        return None if mc is None else SparseRelation.from_coo(
            mc, mv, rel.shape, sem, device=dev)

    def full():
        r = rel if dels is None else _rebuilt_without(rel, dels)
        if mc is not None:
            r = r.union(merge_rel())
        return fx.fixpoint(r, init, mode="jit")

    def child():
        r = rel if dels is None else rel.delete_keys(dels)
        return r if mc is None else r.apply_delta(mc, mv)

    def repair(r, d, mode):
        if dels is None:
            return delta_restart_fixpoint(r, d, y_star, mode=mode)
        return maintain_nonmonotone(r, dels, dvals, y_star, init, rule,
                                    merge_delta=d, mode=mode)

    ans, rounds, ms, paths = {}, {}, {}, {}
    p0, t0 = _b3_now(), _clock()
    ans["full"], _ = full()
    ms["full"], paths["full"] = _clock() - t0, _b3_delta(p0)
    d = merge_rel()
    p0, t0 = _b3_now(), _clock()
    ans["jit"], rounds["jit"] = repair(child(), d, "jit")
    ms["jit"], paths["jit"] = _clock() - t0, _b3_delta(p0)
    # the staged loop's segment plan over E′, which its first resumed
    # round builds (a device sort of E′'s ids), timed on its own child
    r = child()
    t0 = _clock()
    r.runs(1, 0)
    plan_ms = _clock() - t0
    d = merge_rel()
    p0, t0 = _b3_now(), _clock()
    ans["frontier"], rounds["frontier"] = repair(child(), d, "frontier")
    ms["frontier"], paths["frontier"] = _clock() - t0, _b3_delta(p0)
    closures = dict(full=full,
                    jit=lambda: repair(child(), merge_rel(), "jit"),
                    frontier=lambda: repair(child(), merge_rel(),
                                            "frontier"))
    return ans, rounds, ms, plan_ms, paths, closures


def _inc_row(rows, tag, label, rel, init, y_star, updates, rule, op, k,
             dev):
    """Run one row's trials, gate exactness, record medians."""
    import torch
    n = rel.shape[0]
    acc = {w: [] for w in ("full", "jit", "frontier")}
    plans, rounds, paths = [], [], None
    for upd in updates:
        ans, rnd, ms, plan_ms, pth, closures = _inc_ways(
            rel, init, y_star, upd, rule, dev)
        for way in ("jit", "frontier"):
            if not torch.equal(ans[way], ans["full"]):
                raise AssertionError(f"incremental {tag}/{label}: the "
                                     f"maintained {way} answer differs "
                                     f"from the full recompute")
        if rnd["jit"] != rnd["frontier"]:
            raise AssertionError(f"incremental {tag}/{label}: rounds "
                                 f"{rnd}")
        for w in acc:
            acc[w].append(ms[w])
        plans.append(plan_ms)
        rounds.append(int(rnd["jit"]))
        paths = pth if paths is None else {
            w: {p: paths[w][p] + pth[w][p] for p in pth[w]} for w in pth}
    busy = {w: busy_ms(f) for w, f in closures.items()}
    pick = _inc_pick(n, rel, k, op, dev)
    want = "delta_restart" if op == "merge" else "synth_maintenance"
    if pick != want:
        raise AssertionError(f"incremental {tag}/{label}: planner picked "
                             f"{pick!r}, not {want}")
    if paths["full"]["scatter"] or (op == "merge" and
                                    paths["jit"]["scatter"]):
        raise AssertionError(f"incremental {tag}/{label}: B3 paths "
                             f"{paths}: the staged loop launched scatter")
    if sum(rounds) and not paths["frontier"]["scatter"]:
        raise AssertionError(f"incremental {tag}/{label}: the worklist "
                             f"launched no B3 scatter")
    row = dict(update=f"{tag}/{label}", nnz_delta=k, pick=pick,
               rounds=rounds, full_ms=_median(acc["full"]),
               jit_ms=_median(acc["jit"]),
               frontier_ms=_median(acc["frontier"]),
               plan_ms=_median(plans), busy_ms=busy, all_ms=acc,
               b3_paths=paths)
    row["full_over_jit"] = row["full_ms"] / row["jit_ms"]
    row["full_over_frontier"] = row["full_ms"] / row["frontier_ms"]
    rows.append(row)
    log(f"incremental {row['update']}: nnz(Δ)={k} rounds {rounds}; full "
        f"{row['full_ms']:.3f} ms, jit {row['jit_ms']:.3f} ms (plan_ms "
        f"{row['plan_ms']:.3f}), worklist {row['frontier_ms']:.3f} ms; "
        f"full/jit {row['full_over_jit']:.2f}×, full/worklist "
        f"{row['full_over_frontier']:.2f}×; busy ms full "
        f"{busy['full']:.3f} jit {busy['jit']:.3f} worklist "
        f"{busy['frontier']:.3f}; pick {pick}; B3 {paths}; all equal")


def _inc_update_rows(dev):
    """(a): the benchmark's rows on one CUDA database."""
    import numpy as np
    import torch
    from repro_torch.datalog import datasets
    from repro_torch.incremental import ensure_rule
    from repro_torch.incremental.maintenance import _gather_values
    from repro_torch.sparse import fixpoint as fx
    g = datasets.powerlaw(N_INC, 4, seed=INC_SEED)
    g.weights = np.random.default_rng(INC_SEED).integers(1, INC_WMAX,
                                                         len(g.edges))
    n = g.n
    rng = np.random.default_rng(INC_SEED + 1)
    rows = []
    fams = {}
    for tag, sem in (("sssp", "trop"), ("bm", "bool")):
        rel = g.sparse_adjacency(semiring=sem, device=dev)
        init = _inc_one_hot(n, sem, dev)
        (y_star, it0), cold_ms = wall(lambda: fx.fixpoint(rel, init,
                                                          mode="jit"))
        fx.csr_index(rel)
        fx.csr_index(rel, transpose=True)
        fams[tag] = (rel, init, y_star)
        log(f"incremental {tag}: powerlaw({n}, 4) nnz={rel.nnz}, cold "
            f"staged solve {it0} rounds {cold_ms:.2f} ms")
    rel, init, y_star = fams["sssp"]
    nnz = rel.nnz
    for label, k in (("single", 1), ("batch1pct", max(1, nnz // 100))):
        ups = [(None, None) + _inc_rand_delta(rng, n, k, "trop")
               for _ in range(INC_TRIALS)]
        _inc_row(rows, "sssp", label, rel, init, y_star, ups, None,
                 "merge", k, dev)
    for tag in ("sssp", "bm"):
        rel, init, y_star = fams[tag]
        rule = ensure_rule(f"chip-{tag}", rel.semiring, "delete")
        if not rule.verified or rule.name != INC_RULE:
            raise AssertionError(f"incremental {tag}: rule {rule.name} "
                                 f"{rule.reason}")
        live = rel.coords[:rel.nnz].cpu().numpy().astype(np.int64)
        heavy = max(1, len(live) // 1000)
        for label, kd, ki in (("delete_single", 1, 0),
                              ("delete_heavy", heavy, 0),
                              ("mixed", max(1, heavy // 2),
                               max(1, heavy // 2))):
            ups = []
            for _ in range(INC_TRIALS):
                dels = live[rng.choice(len(live), kd, replace=False)]
                mc = mv = None
                if ki:
                    mc, mv = _inc_rand_delta(rng, n, ki, rel.semiring)
                dels_t = torch.from_numpy(dels).to(dev)
                ups.append((dels_t, _gather_values(rel, dels_t), mc, mv))
            _inc_row(rows, tag, label, rel, init, y_star, ups, rule,
                     "delete", kd + ki, dev)
    return dict(n=n, nnz={t: f[0].nnz for t, f in fams.items()},
                trials=INC_TRIALS, rows=rows, power=nvidia_smi())


def _inc_mutated(edges, op, coords):
    import numpy as np
    if op == "insert":
        return np.concatenate([edges, coords])
    n = int(max(edges.max(), coords.max())) + 1
    gone = np.isin(edges[:, 0] * n + edges[:, 1],
                   coords[:, 0] * n + coords[:, 1])
    return edges[~gone]


def _inc_refresh_rows(dev, data):
    """(b): ``refresh_program`` on the latency graph for BM and CC Π₂."""
    import numpy as np
    import torch
    from repro_torch.core import planner
    from repro_torch.core.program import run_program
    from repro_torch.datalog import programs
    from repro_torch.incremental import DeltaLog, refresh_program
    from repro_torch.sparse import fixpoint as fx
    g = data["g"]
    dbs = data.setdefault("dbs", _dbs(dev, data))
    rng = np.random.default_rng(11)
    out = {}
    for kind, prog in (("bm", programs.bm(a=0).optimized),
                       ("cc", programs.cc().optimized)):
        db = dbs[kind]
        prev, _ = run_program(prog, db)
        rows = []
        for op, k in INC_LOGS:
            if op == "insert":
                coords = rng.integers(0, g.n, (k, 2))
                dlog = DeltaLog().insert("E", coords)
            else:
                coords = g.edges[rng.choice(len(g.edges), k,
                                            replace=False)]
                dlog = DeltaLog().delete("E", coords)
            p0 = _b3_now()
            (y, db2, rep), first_ms = wall(
                lambda: refresh_program(prog, db, prev, dlog))
            paths = _b3_delta(p0)
            edges2 = _inc_mutated(g.edges, op, coords)
            csr = csr_host(g.n, edges2)
            want = bfs_reach(csr, 0) if kind == "bm" else cc_min_labels(csr)
            if not np.array_equal(y.cpu().numpy(), want):
                raise AssertionError(f"incremental refresh {kind} {op} "
                                     f"{k}: answer differs from scipy")
            times = [wall(lambda: refresh_program(prog, db, prev, dlog))[1]
                     for _ in range(10)]
            (x2, _), scratch_first = wall(lambda: run_program(prog, db2))
            if not torch.equal(x2, y):
                raise AssertionError(f"incremental refresh {kind} {op} "
                                     f"{k}: differs from run_program")
            scratch = [wall(lambda: run_program(prog, db2))[1]
                       for _ in range(10)]
            want_strategy = "delta_restart" if op == "insert" else \
                "synth_maintenance"
            if rep.strategy != want_strategy:
                raise AssertionError(f"incremental refresh {kind} {op}: "
                                     f"{rep.strategy} ({rep.reason})")
            row = dict(op=op, edges=k, strategy=rep.strategy,
                       reason=rep.reason, rounds=rep.iters,
                       first_ms=first_ms, ms=_median(times), all_ms=times,
                       scratch_first_ms=scratch_first,
                       scratch_ms=_median(scratch), b3_paths=paths,
                       busy_ms=busy_ms(lambda: refresh_program(
                           prog, db, prev, dlog)),
                       scratch_busy_ms=busy_ms(lambda: run_program(
                           prog, db2)))
            # what each refresh rebuilds: the staged loop's segment plan
            # over E′ (plan_ms, on a fresh child), and the CSR index when
            # the operator is not E itself (CC: E cast into trop and
            # transposed, so the cache keyed on E's buffers misses)
            edges = planner.materialize_edges(
                rep.plan, db.apply_delta(dlog))
            row["csr"] = "kept" if fx._csr_lookup(edges) is not None \
                else "rebuilt"
            _, row["plan_ms"] = wall(lambda: edges.runs(1, 0))
            if row["csr"] == "rebuilt":
                _, row["csr_build_ms"] = wall(lambda: (
                    fx.csr_index(edges), fx.csr_index(edges,
                                                      transpose=True)))
            if op == "insert":
                # ROADMAP A1: the worklist against the staged loop on
                # the same refresh
                yf, _, repf = refresh_program(prog, db, prev, dlog,
                                              mode="frontier")
                if not torch.equal(yf, y) or repf.iters != rep.iters:
                    raise AssertionError(f"incremental refresh {kind} "
                                         f"{op} {k}: worklist differs")
                ft = [wall(lambda: refresh_program(
                    prog, db, prev, dlog, mode="frontier"))[1]
                    for _ in range(10)]
                row.update(frontier_ms=_median(ft), all_frontier_ms=ft,
                           frontier_busy_ms=busy_ms(lambda: refresh_program(
                               prog, db, prev, dlog, mode="frontier")))
            rows.append(row)
            log(f"incremental refresh {kind} {op} {k}: {rep.strategy} "
                f"({rep.reason[:60]}…), {rep.iters} rounds; median "
                f"{row['ms']:.3f} ms (first {first_ms:.1f}), busy "
                f"{row['busy_ms']:.3f} ms; run_program on the mutated db "
                f"{row['scratch_ms']:.3f} ms (first {scratch_first:.1f}), "
                f"busy {row['scratch_busy_ms']:.3f} ms; plan_ms "
                f"{row['plan_ms']:.3f}, CSR {row['csr']}"
                + (f" ({row['csr_build_ms']:.3f} ms)"
                   if "csr_build_ms" in row else "")
                + (f"; worklist {row['frontier_ms']:.3f} ms, busy "
                   f"{row['frontier_busy_ms']:.3f} ms"
                   if op == "insert" else "")
                + f"; B3 {paths}; matches scipy [{nvidia_smi()}]")
        out[kind] = rows
        data.setdefault("warm", {})[f"incremental_{kind}"] = (
            lambda p=prog, d=db, y0=prev, lg=dlog:
            refresh_program(p, d, y0, lg))
    return out


def _inc_b3_checks(dev, data):
    """(c): B3 at the shapes this path hands it, recorded during one BM
    refresh of each kind on the latency graph (outside the counted run):
    Δ's seed and the resume over E′ (``runs``), ``_gather_values``'s ⊕
    of stored copies and the recount's ⊕ into the cone (``scatter``):
    each exact against the plain version and timed beside its byte
    bound."""
    import numpy as np
    from repro_torch.core import semiring as sr_mod
    from repro_torch.core.program import run_program
    from repro_torch.datalog import programs
    from repro_torch.incremental import DeltaLog, refresh_program
    from repro_torch.kernels import coo_segment, ref
    g = data["g"]
    db = data["dbs"]["bm"]
    prog = programs.bm(a=0).optimized
    prev, _ = run_program(prog, db)
    rng = np.random.default_rng(12)
    seen = {"insert": [], "delete": []}
    dispatch = coo_segment.segment_reduce
    logs = {"insert": DeltaLog().insert("E", rng.integers(0, g.n,
                                                          (1000, 2))),
            "delete": DeltaLog().delete("E", g.edges[rng.choice(
                len(g.edges), 100, replace=False)])}
    for kind, dlog in logs.items():
        def record(sr_name, vals, ids, n, *, plan=None, into=seen[kind]):
            into.append((sr_name, vals, ids, n, plan))
            return dispatch(sr_name, vals, ids, n, plan=plan)
        coo_segment.segment_reduce = record
        try:
            refresh_program(prog, db, prev, dlog, mode="jit")
        finally:
            coo_segment.segment_reduce = dispatch
    # the insert refresh opens with Δ's seed; the delete refresh runs
    # _gather_values's ⊕ of stored copies, the recount's ⊕ into the cone
    # and then the resumed rounds over E′
    runs = [c for c in seen["insert"] if c[4] is not None]
    scatter = [c for c in seen["delete"] if c[4] is None]
    resume = [c for c in seen["delete"] if c[4] is not None]
    if not (runs and len(scatter) >= 2 and resume):
        raise AssertionError("incremental: the refreshes handed B3 no seed, "
                             "recount or resumed round")
    picks = {"seed": runs[0], "gather": scatter[0], "recount": scatter[-1],
             "resume": resume[-1]}
    out = {}
    for what, (name, vals, ids, n, plan) in picks.items():
        sr = sr_mod.get(name)
        launch = coo_segment.segment_reduce_cuda
        if plan is None:
            def fn():
                return launch(name, vals, ids, n)
            want = ref.segment_reduce_ref(sr, vals, ids, n)
        else:
            def fn():
                return launch(name, vals, ids, n, plan)
            want = ref.segment_reduce_ref(
                sr, vals, ids.index_select(0, plan.order), n)
        err = _check(f"incremental {what}", "coo_segment", fn(), want)
        m = int(vals.shape[0])
        nbytes = m * (vals.element_size() + 4) + n * vals.element_size()
        bound, by_what = _bound(nbytes)
        out[what] = dict(path="scatter" if plan is None else "runs",
                         semiring=name, m=m, n=n, max_abs_err=err,
                         ms=time_ms(fn, 20, hide_host=True),
                         plain_ms=time_ms(lambda: ref.segment_reduce_ref(
                             sr, vals, ids if plan is None else
                             ids.index_select(0, plan.order), n), 3),
                         bound_ms=bound, bound_by=by_what)
        log(f"incremental B3 {what}: {out[what]['path']} {name} m={m} "
            f"n={n}: {out[what]['ms']:.4f} ms kernel, "
            f"{out[what]['plain_ms']:.4f} ms plain, bound {bound:.4f} ms "
            f"({by_what}), max|err| {err}")
    return out


# --------------------------------------------------------------------------
# phase 9: Datalog° serving — the twin of benchmarks/serve_batch.py
# --------------------------------------------------------------------------

#: benchmarks/serve_batch.py's defaults: graph size and seed, closed-loop
#: batch sizes, open-loop requests, offered load and max_batch;
#: ContinuousServer's default chunk
SERVE_N, SERVE_SEED = 50_000, 1
SERVE_BATCHES = (1, 8, 64)
SERVE_REQUESTS, SERVE_QPS, SERVE_MAX_BATCH, SERVE_CHUNK = 512, 2000.0, 64, 4
#: the update part: warm sources a family, merged SSSP edges (weights
#: 1–4), deleted BM edges
SERVE_WARM, SERVE_MERGE, SERVE_DELETE = 64, 1000, 100
#: the kernels of B1's words_bool pack and unpack, by event name
B1_PACK_EVENTS = ("spmm_pack", "spmm_unpack")


def _mk_bm(a):
    from repro_torch.datalog import programs
    return programs.bm(a=a).optimized


def _mk_sssp(a):
    from repro_torch.datalog import programs
    return programs.sssp(a=a, wmax=4, dmax=64).optimized


def _serve_graphs():
    """``benchmarks/serve_batch.py``'s pair: BM on ``powerlaw(n, 4,
    seed)``, SSSP on ``powerlaw(n, 4, seed + 1)`` with weights
    ``default_rng(seed + 2).integers(1, 5)``."""
    import numpy as np
    from repro_torch.datalog import datasets
    g_bm = datasets.powerlaw(SERVE_N, 4, seed=SERVE_SEED)
    g0 = datasets.powerlaw(SERVE_N, 4, seed=SERVE_SEED + 1)
    rng = np.random.default_rng(SERVE_SEED + 2)
    return g_bm, datasets.Graph(g0.n, g0.edges,
                                rng.integers(1, 5, len(g0.edges)))


def _serve_bm_db(dev, g):
    from repro_torch.core import engine
    from repro_torch.datalog import programs
    return engine.Database(programs.bm(a=0).original.schema, {"id": g.n},
                           {"E": g.sparse_adjacency(device=dev),
                            "V": g.vertex_set(device=dev)}, dev)


def _serve_ss_db(dev, g):
    """SSSP's database holds no relation: its schema-level E3 is a dense
    (n, n, 4) tensor, so the family takes the weighted COO override,
    returned beside it."""
    from repro_torch.core import engine
    return (engine.Database(_mk_sssp(0).schema, {"id": g.n, "w": 4,
                                                  "d": 64}, {}, dev),
            g.sparse_adjacency(semiring="trop", device=dev))


def dijkstra_dist(n, edges, w, sources):
    """scipy Dijkstra from each source over the weighted edge list (a key
    stored twice keeps its least weight, as the trop ⊕ does): (len(
    sources), n) float32, inf where unreachable."""
    import numpy as np
    from scipy import sparse
    from scipy.sparse import csgraph
    key = edges[:, 0].astype(np.int64) * n + edges[:, 1]
    order = np.lexsort((w, key))
    key, w = key[order], np.asarray(w, np.float64)[order]
    first = np.r_[True, key[1:] != key[:-1]]
    csr = sparse.csr_matrix((w[first], (key[first] // n, key[first] % n)),
                            shape=(n, n))
    return csgraph.dijkstra(csr, directed=True,
                            indices=sources).astype(np.float32)


class _ServeTrace:
    """Host seconds of a request's init, splice (its admission, and the
    staged rows' copy when the next chunk starts) and harvest: timing
    wrappers on those functions for the phase, restored on exit."""

    def __enter__(self):
        from repro_torch.serve import family, slots
        self.host = {k: 0.0 for k in ("init", "splice", "flush",
                                      "harvest")}
        self._saved = [(owner, name, getattr(owner, name), key)
                       for owner, name, key in (
                           (family, "family_init", "init"),
                           (slots.SlotPool, "admit", "splice"),
                           (slots.TorchChunkStepper, "_flush", "flush"),
                           (slots.SlotPool, "harvest", "harvest"))]
        for owner, name, fn, key in self._saved:
            setattr(owner, name, self._timed(fn, key))
        return self

    def _timed(self, fn, key):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.host[key] += time.perf_counter() - t0
        return run

    def __exit__(self, *exc):
        for owner, name, fn, _ in self._saved:
            setattr(owner, name, fn)
        return False


def _b1_now():
    from repro_torch.kernels import coo_spmm
    return dict(coo_spmm.spmm_cuda.by_path)


def _b1_delta(paths0):
    from repro_torch.kernels import coo_spmm
    return {k: v - paths0[k] for k, v in coo_spmm.spmm_cuda.by_path.items()}


def _b1_only(window, paths, path):
    """A window that served one family launched B1 through its path
    alone (BM: words_bool, SSSP: lanes_f32)."""
    _serve_gate(paths[path] > 0 and sum(paths.values()) == paths[path],
                f"{window}: B1 launched {paths}, not {path} alone")


def _torch_pools(server, what):
    """Every slot pool of a server on the card steps through B1's chunk
    stepper, never a host stepper."""
    from repro_torch.serve import TorchChunkStepper
    pools = [fs.pool for fs in server._families.values()
             if fs.pool is not None]
    _serve_gate(pools and all(isinstance(p.stepper, TorchChunkStepper)
                              for p in pools),
                f"{what}: pools step through "
                f"{[type(p.stepper).__name__ for p in pools]}")
    return len(pools)


def _serve_gate(ok, what):
    if not ok:
        raise AssertionError(f"serve: {what}")


def phase_serve(dev, data):
    """Datalog° serving on the card, the twin of
    ``benchmarks/serve_batch.py`` at its defaults, plus warm answers
    repaired across a merge and a delete."""
    t0 = time.perf_counter()
    g_bm, g_ss = _serve_graphs()
    out = {"graphs": {"bm_edges": int(len(g_bm.edges)),
                      "sssp_edges": int(len(g_ss.edges))}}
    with Counted() as c, _ServeTrace() as tr:
        p = _b1_now()
        out["closed"] = _serve_closed(dev, data, g_bm)
        b1 = {"closed": _b1_delta(p)}
        p = _b1_now()
        out["open"] = _serve_open(dev, g_bm, g_ss, tr)
        b1["open"] = _b1_delta(p)
        p0 = _b3_now()
        out["updates"] = _serve_updates(dev, g_bm, g_ss)
        out["b3_update_paths"] = _b3_delta(p0)
        b1.update(out["updates"].pop("b1"))
    out["launches"] = c.counts
    out["b3_paths"] = c.b3_paths
    out["b1_paths"] = b1
    log(f"serve launches {c.counts}; B1 paths by window {b1}; B3 paths "
        f"{c.b3_paths} (updates {out['b3_update_paths']})")
    _b1_only("closed loop (BM)", b1["closed"], "words_bool")
    _b1_only("updates, SSSP", b1["sssp"], "lanes_f32")
    _b1_only("updates, BM", b1["bm"], "words_bool")
    _serve_gate(min(b1["open"].values()) > 0,
                f"open loop: B1 launched {b1['open']}")
    _serve_gate(sum(sum(w.values()) for w in b1.values())
                == c.counts["coo_spmm"],
                f"B1 paths {b1} do not account for {c.counts['coo_spmm']} "
                f"launches")
    fams = _serve_families(dev, g_bm, g_ss)
    out["b1_checks"] = _serve_b1_checks(dev, fams)
    out["b3_checks"] = _serve_b3_checks(dev, g_bm, g_ss)
    out["chunk_profile"] = {name: _serve_chunk_profile(fam)
                            for name, fam in fams.items()}
    out["seconds"] = time.perf_counter() - t0
    log(f"serve phase: {out['seconds']:.1f} s")
    return out


def _serve_closed(dev, data, g_bm):
    """Closed loop: ``DatalogServer(max_batch=64, warm_answers=0)`` at
    B ∈ {1, 8, 64} against a loop of single-source ``run_program``s on
    BM, and at B = 64 on the latency graph; every served answer must
    equal its single-source run, values and counts."""
    import numpy as np
    import torch
    from repro_torch.core.program import run_program
    from repro_torch.launch.datalog_serve import DatalogServer
    db_bm = _serve_bm_db(dev, g_bm)
    rows = []
    cases = [("powerlaw_50k", db_bm, g_bm.n, b) for b in SERVE_BATCHES]
    cases.append(("powerlaw_81k", data.setdefault(
        "dbs", _dbs(dev, data))["bm"], data["g"].n, SERVE_MAX_BATCH))
    servers = {}
    rng = np.random.default_rng(SERVE_SEED)
    for graph, db, n, b in cases:
        if graph not in servers:
            servers[graph] = DatalogServer(max_batch=SERVE_MAX_BATCH,
                                           warm_answers=0)
            servers[graph].register("reach", _mk_bm, db)
            run_program(_mk_bm(0), db)      # the single-source path warm
        server = servers[graph]
        sources = [int(s) for s in rng.integers(0, n, b)]
        loop, loop_ms = wall(lambda: [run_program(_mk_bm(s), db)
                                      for s in sources])
        for _ in range(2):                  # the second is timed
            reqs = [server.submit("reach", s) for s in sources]
            _, ms = wall(server.run_until_idle)
        for r, (x, st) in zip(reqs, loop):
            _serve_gate(r.error is None and torch.equal(r.result, x)
                        and r.iters == st.iterations[0],
                        f"closed {graph} B={b}: source {r.source} differs "
                        f"from its single-source run_program")
        rows.append(dict(graph=graph, B=b, ms_batched=ms, ms_loop=loop_ms,
                         qps_batched=b / ms * 1e3, qps_loop=b / loop_ms * 1e3,
                         speedup=loop_ms / ms,
                         rounds_max=max(r.iters for r in reqs)))
        log(f"serve closed {graph} B={b}: server {ms:.2f} ms "
            f"({rows[-1]['qps_batched']:.0f} qps), loop of run_program "
            f"{loop_ms:.2f} ms ({rows[-1]['qps_loop']:.0f} qps), "
            f"{rows[-1]['speedup']:.2f}x; answers and counts equal")
    for graph, server in servers.items():
        _serve_gate(server.stats["latency_routed"] == 0,
                    f"closed {graph}: latency_routed on the card")
    return {"rows": rows, "stats": {g: s.stats for g, s in servers.items()}}


def _drive_open_loop(server, schedule):
    """``benchmarks/serve_batch.py``'s replay: a request is submitted
    when its arrival time has passed, the server steps while it has
    work; latency counts from the intended arrival."""
    import numpy as np
    t0 = time.perf_counter()
    reqs = [None] * len(schedule)
    i = 0
    while i < len(schedule) or server.pending():
        now = time.perf_counter() - t0
        while i < len(schedule) and schedule[i][0] <= now:
            _, fam, src = schedule[i]
            reqs[i] = server.submit(fam, src)
            i += 1
        if server.pending():
            server.step()
        elif i < len(schedule):
            time.sleep(min(schedule[i][0] - now, 1e-3))
    server.run_until_idle()
    duration = time.perf_counter() - t0
    arrive = np.array([t0 + a for a, _, _ in schedule])

    def pct(x):
        return {f"p{q}_ms": float(np.percentile(x, q) * 1e3)
                for q in (50, 95, 99)}
    lat = {"total": pct(np.array([r.done_s for r in reqs]) - arrive),
           "queue": pct(np.array([r.admitted_s for r in reqs]) - arrive),
           "compute": pct(np.array([r.converged_s - r.admitted_s
                                    for r in reqs]))}
    return reqs, duration, lat


def _serve_open(dev, g_bm, g_ss, tr):
    """Open loop: 512 requests, half BM and half SSSP in the benchmark's
    seeded interleaving, Poisson arrivals offered at 2,000 qps, served by
    the FIFO server and by ContinuousServer (chunk 4) after a warm-up
    over every bucket; answers equal bit for bit, six spot checks
    against scipy."""
    import numpy as np
    import torch
    from repro_torch.launch.datalog_serve import DatalogServer
    from repro_torch.serve import ContinuousServer
    db_bm = _serve_bm_db(dev, g_bm)
    db_ss, ss_rel = _serve_ss_db(dev, g_ss)
    rng = np.random.default_rng(SERVE_SEED + 3)
    fams = list(rng.permutation(["reach"] * (SERVE_REQUESTS // 2)
                                + ["sssp"] * (SERVE_REQUESTS // 2)))
    arrivals = np.cumsum(rng.exponential(1.0 / SERVE_QPS, SERVE_REQUESTS))
    schedule = [(float(t), str(f), int(rng.integers(0, SERVE_N)))
                for t, f in zip(arrivals, fams)]

    def build(server):
        server.register("reach", _mk_bm, db_bm)
        server.register("sssp", _mk_sssp, db_ss, edges=ss_rel)
        warm_rng = np.random.default_rng(SERVE_SEED + 4)
        for fam in ("reach", "sssp"):
            for b in (1, 2, 4, 8, 16, 32, 64):
                for s in warm_rng.integers(0, SERVE_N, b):
                    server.submit(fam, int(s))
                server.run_until_idle()
        return server

    fifo = build(DatalogServer(max_batch=SERVE_MAX_BATCH, warm_answers=0))
    cont = build(ContinuousServer(
        max_batch=SERVE_MAX_BATCH, chunk_iters=SERVE_CHUNK, warm_answers=0,
        queue_limit=max(4 * SERVE_REQUESTS, 1024)))
    torch.cuda.synchronize()
    f_reqs, f_dur, f_lat = _drive_open_loop(fifo, schedule)
    s0 = dict(cont.stats())
    h0 = dict(tr.host)
    c_reqs, c_dur, c_lat = _drive_open_loop(cont, schedule)
    s1 = cont.stats()
    host = {k: (tr.host[k] - h0[k]) / SERVE_REQUESTS * 1e6 for k in h0}
    for rf, rc in zip(f_reqs, c_reqs):
        _serve_gate(rf.error is None and rc.error is None
                    and torch.equal(rf.result, rc.result)
                    and rf.iters == rc.iters,
                    f"open loop: {rc.family} {rc.source} differs between "
                    f"the FIFO and the continuous server")
    csr = csr_host(g_bm.n, g_bm.edges)
    spots = np.random.default_rng(SERVE_SEED + 5).integers(
        0, SERVE_REQUESTS, 6)
    for i in spots:
        r = c_reqs[int(i)]
        want = bfs_reach(csr, r.source) if r.family == "reach" else \
            dijkstra_dist(g_ss.n, g_ss.edges, g_ss.weights, [r.source])[0]
        _serve_gate(np.array_equal(r.result.cpu().numpy(), want),
                    f"open loop: {r.family} {r.source} differs from scipy")
    for name, s in (("fifo", fifo.stats), ("continuous", s1)):
        _serve_gate(s["latency_routed"] == 0,
                    f"open loop {name}: latency_routed on the card")
    _serve_gate(_torch_pools(cont, "open loop") == 2,
                "open loop: a family served without a slot pool")
    counts = {k: s1[k] - s0[k] for k in ("chunks", "admitted", "evicted",
                                         "migrated", "packed_fallback")}
    res = {"requests": SERVE_REQUESTS, "offered_qps": SERVE_QPS,
           "max_batch": SERVE_MAX_BATCH, "chunk_iters": SERVE_CHUNK,
           "fifo": {"qps": SERVE_REQUESTS / f_dur, "duration_s": f_dur,
                    **f_lat, "batches": fifo.stats["batches"]},
           "continuous": {"qps": SERVE_REQUESTS / c_dur, "duration_s": c_dur,
                          **c_lat, **counts, "host_us_per_request": host,
                          "frontier": {f: s1["families"][f]["frontier"]
                                       for f in ("reach", "sssp")}},
           "speedup": f_dur / c_dur}
    for name in ("fifo", "continuous"):
        r = res[name]
        log(f"serve open {name}: {r['qps']:.0f} qps, total p50/p95/p99 "
            f"{r['total']['p50_ms']:.1f}/{r['total']['p95_ms']:.1f}/"
            f"{r['total']['p99_ms']:.1f} ms (queue p50 "
            f"{r['queue']['p50_ms']:.1f}, compute p50 "
            f"{r['compute']['p50_ms']:.1f})")
    log(f"serve open: continuous/fifo {res['speedup']:.2f}x; {counts}; "
        f"host µs/request (splice = admit, flush = the staged rows' copy) "
        f"{ {k: round(v, 1) for k, v in host.items()} }; answers equal, "
        f"six spot checks equal scipy")
    return res


def _serve_update_data(g_bm, g_ss):
    """The update part's seeded inputs: 64 SSSP sources, 1,000 new SSSP
    edges (no self-loop, none already stored) with weights 1–4, 64 BM
    sources and 100 stored BM edges to delete."""
    import numpy as np
    rng = np.random.default_rng(SERVE_SEED + 6)
    ss_src = rng.choice(SERVE_N, SERVE_WARM, replace=False)
    have = set((g_ss.edges[:, 0].astype(np.int64) * SERVE_N
                + g_ss.edges[:, 1]).tolist())
    cand = rng.integers(0, SERVE_N, (4 * SERVE_MERGE, 2))
    key = cand[:, 0] * SERVE_N + cand[:, 1]
    keep = (cand[:, 0] != cand[:, 1]) & ~np.isin(key, list(have))
    _, first = np.unique(key[keep], return_index=True)
    new = cand[keep][np.sort(first)][:SERVE_MERGE]
    w_new = rng.integers(1, 5, len(new))
    bm_src = rng.choice(SERVE_N, SERVE_WARM, replace=False)
    gone = g_bm.edges[rng.choice(len(g_bm.edges), SERVE_DELETE,
                                 replace=False)]
    return ss_src, new, w_new, bm_src, gone


def _serve_updates(dev, g_bm, g_ss):
    """ContinuousServer with warm answers on: 64 SSSP sources, a merge of
    1,000 new SSSP edges (delta-restart), 64 BM sources, a delete of 100
    BM edges (the ⊖/recount rule), the same sources again (warm hits).
    After each update every repaired answer must equal a cold
    run_program on the mutated graph and scipy on the mutated edge
    list."""
    import numpy as np
    import torch
    from repro_torch.core import planner
    from repro_torch.core.program import run_program
    from repro_torch.incremental import ensure_rule
    from repro_torch.serve import ContinuousServer
    db_bm = _serve_bm_db(dev, g_bm)
    db_ss, ss_rel = _serve_ss_db(dev, g_ss)
    ss_src, new, w_new, bm_src, gone = _serve_update_data(g_bm, g_ss)
    cs = ContinuousServer(max_batch=SERVE_MAX_BATCH, chunk_iters=SERVE_CHUNK)
    cs.register("reach", _mk_bm, db_bm)
    cs.register("sssp", _mk_sssp, db_ss, edges=ss_rel)
    out = {"b1": {}}

    def serve(fam, sources):
        reqs = [cs.submit(fam, int(s)) for s in sources]
        _, ms = wall(cs.run_until_idle)
        _serve_gate(all(r.error is None for r in reqs), f"{fam}: failed")
        if any(r.iters for r in reqs):
            _torch_pools(cs, f"updates, {fam}")
        return reqs, ms

    def cold(fam, mk, db, edges, sources):
        """The same sources on a fresh server over the mutated graph:
        the first serve builds B1's geometry of the new operator, the
        second is the steady cold cost."""
        fresh = ContinuousServer(max_batch=SERVE_MAX_BATCH,
                                 chunk_iters=SERVE_CHUNK, warm_answers=0)
        fresh.register(fam, mk, db, edges=edges)
        times = []
        for _ in range(2):
            reqs = [fresh.submit(fam, int(s)) for s in sources]
            times.append(wall(fresh.run_until_idle)[1])
        _torch_pools(fresh, f"cold re-serve, {fam}")
        return reqs, times

    def update(fam, coords, values, op):
        st0 = cs.stats()
        p0 = _b3_now()
        u = cs.submit_update(fam, coords, values, op=op)
        _, ms = wall(cs.run_until_idle)
        out[f"{op}_b3"] = _b3_delta(p0)
        st1 = cs.stats()
        _serve_gate(u.applied and u.error is None, f"{fam} {op}: {u.error}")
        repaired = st1["answers_repaired"] - st0["answers_repaired"]
        _serve_gate(repaired == SERVE_WARM and st1["answers_dropped"] ==
                    st0["answers_dropped"],
                    f"{fam} {op}: {repaired} answers repaired, not "
                    f"{SERVE_WARM}")
        return ms, u.latency_s * 1e3

    # SSSP: serve, merge 1,000 new edges, check the repaired answers
    p = _b1_now()
    _, out["sssp_serve_ms"] = serve("sssp", ss_src)
    out["merge_ms"], out["merge_update_ms"] = update(
        "sssp", new, w_new.astype(np.float32), "merge")
    fam = cs._families["sssp"].fam
    edges2 = np.concatenate([g_ss.edges, new])
    want = dijkstra_dist(SERVE_N, edges2, np.concatenate([g_ss.weights,
                                                          w_new]), ss_src)
    creqs, out["merge_cold_reserve_ms"] = cold("sssp", _mk_sssp, db_ss,
                                               fam.edges, ss_src)
    for i, s in enumerate(ss_src):
        got = fam.answers.peek(int(s))
        x, _ = run_program(_mk_sssp(int(s)), db_ss, plan=planner.plan_program(
            _mk_sssp(int(s)), db_ss, edges=fam.edges))
        _serve_gate(torch.equal(got, x) and torch.equal(got, creqs[i].result)
                    and np.array_equal(got.cpu().numpy(), want[i]),
                    f"sssp merge: source {s}'s repaired answer differs from "
                    f"a cold run / scipy on the mutated graph")
    out["b1"]["sssp"] = _b1_delta(p)
    # BM: serve, delete 100 edges, check, serve the same sources again
    p = _b1_now()
    _, out["bm_serve_ms"] = serve("reach", bm_src)
    bm = cs._families["reach"].fam
    t_rule = time.perf_counter()
    rule = ensure_rule(bm.plan.strata[0].vf.signature, "bool", "delete")
    out["rule_s"] = time.perf_counter() - t_rule
    _serve_gate(rule.verified, f"no verified delete rule: {rule.reason}")
    out["delete_ms"], out["delete_update_ms"] = update("reach", gone, None,
                                                       "delete")
    _serve_gate(out["merge_b3"]["runs"] > 0 and out["delete_b3"]["scatter"]
                > 0, f"the repairs' B3 launches went {out['merge_b3']} "
                f"(merge) and {out['delete_b3']} (delete), not runs for the "
                f"delta-restart and scatter for the recount")
    edges2 = _inc_mutated(g_bm.edges, "delete", gone)
    csr = csr_host(SERVE_N, edges2)
    creqs, out["delete_cold_reserve_ms"] = cold("reach", _mk_bm, bm.db, None,
                                                bm_src)
    for i, s in enumerate(bm_src):
        got = bm.answers.peek(int(s))
        x, _ = run_program(_mk_bm(int(s)), bm.db)
        _serve_gate(torch.equal(got, x) and torch.equal(got, creqs[i].result)
                    and np.array_equal(got.cpu().numpy(),
                                       bfs_reach(csr, int(s))),
                    f"bm delete: source {s}'s repaired answer differs from "
                    f"a cold run / scipy on the mutated graph")
    hits0 = cs.stats()["warm_hits"]
    again, out["bm_warm_ms"] = serve("reach", bm_src)
    _serve_gate(cs.stats()["warm_hits"] - hits0 == SERVE_WARM
                and all(r.iters == 0 and torch.equal(
                    r.result, bm.answers.peek(r.source)) for r in again),
                "bm: the re-served sources were not warm hits on the repair")
    out["b1"]["bm"] = _b1_delta(p)
    _serve_gate(cs.stats()["latency_routed"] == 0,
                "updates: latency_routed on the card")
    out["stats"] = {k: v for k, v in cs.stats().items()
                    if not isinstance(v, dict)}
    log(f"serve updates: sssp merge of {len(new)} edges repairs "
        f"{SERVE_WARM} answers in {out['merge_ms']:.2f} ms (cold re-serve, "
        f"first and steady: {out['merge_cold_reserve_ms']} ms; B3 "
        f"{out['merge_b3']}); bm delete of {SERVE_DELETE} in "
        f"{out['delete_ms']:.2f} ms (cold re-serve "
        f"{out['delete_cold_reserve_ms']} ms; B3 {out['delete_b3']}; rule "
        f"{out['rule_s']:.2f} s); warm re-serve {out['bm_warm_ms']:.2f} ms; "
        f"equal to cold runs and scipy")
    return out


def _serve_families(dev, g_bm, g_ss):
    """The two families of the phase, built once more outside the counted
    runs for the kernel checks and the chunk profile."""
    from repro_torch.serve import family
    db, rel = _serve_ss_db(dev, g_ss)
    return {"bm": family.build_family("bm", _mk_bm, _serve_bm_db(dev, g_bm)),
            "sssp": family.build_family("sssp", _mk_sssp, db, edges=rel)}


def _warm_stepper(fam, b):
    """A ``TorchChunkStepper`` of ``b`` slots as the scheduler builds it,
    filled with seeded sources and stepped one chunk: its carry is the
    Δ a warm chunk hands B1."""
    import numpy as np
    from repro_torch.core import runners
    from repro_torch.serve import family, slots
    chunk = runners.get(fam.plan.strata[0].runner).serve_chunk_fn(
        SERVE_CHUNK)
    st = slots.TorchChunkStepper(fam.edges, fam.n, b, chunk)
    for j, s in enumerate(np.random.default_rng(SERVE_SEED + 7).choice(
            fam.n, b, replace=False)):
        st.admit(j, family.family_init(fam, int(s)))
    st.step(SERVE_CHUNK)
    return st, chunk


def _serve_b1_checks(dev, fams):
    """B1 at every width the serve path hands it: each family's warm
    carry (rounds 5–8) at B ∈ {1, 2, …, 64}, the FIFO's packs and the
    pools' buckets.  Each launch goes through its family's path and
    equals the plain version exactly; timed beside its byte bound."""
    import torch
    from repro_torch.core import semiring as sr_mod
    from repro_torch.kernels import coo_spmm, ref
    out = {}
    for name, fam in fams.items():
        sr = sr_mod.get(fam.semiring)
        plan = coo_spmm.plan_geometry(fam.edges, transpose=True)
        p = plan.on(dev)
        b = 1
        while b <= SERVE_MAX_BATCH:
            st, _ = _warm_stepper(fam, b)
            x = st.d.t().contiguous()          # the (n, B) Δ of round 5
            path, geo = coo_spmm.plan_spmm(plan, b)
            p0 = _b1_now()
            got = coo_spmm.spmm_cuda(plan, x)
            launched = _b1_delta(p0)
            _serve_gate(launched[path] == 1 and sum(launched.values()) == 1,
                        f"B1 check {name} B={b}: launched {launched}, not "
                        f"one {path}")
            want = ref.coo_spmm_ref(sr, p["src"], p["w"], p["dst"], x,
                                    plan.n_out)
            err = _check(f"serve {name} B={b}", "coo_spmm", got, want)
            share = float(sr.live(want).float().mean())
            _serve_gate(0.0 < share < 1.0, f"B1 check {name} B={b}: "
                        f"{share:.3f} of the plain answer non-0̄")
            isz = x.element_size()
            nbytes = ((4 + p["w"].element_size()) * plan.nnz
                      + 8 * geo.items.n_items + 8 * geo.items.n_split
                      + (plan.n_in + plan.n_out) * b * isz)
            bound, by_what = _bound(nbytes)
            key = f"{name} B={b}"
            out[key] = dict(
                path=path, lanes=b, row_len=geo.row_len, vec=geo.vec,
                tpe=geo.threads_per_edge, grid=list(geo.grid),
                live_share=share,
                max_abs_err=err,
                ms=time_ms(lambda: coo_spmm.spmm_cuda(plan, x), 20,
                           hide_host=True),
                plain_ms=time_ms(lambda: ref.coo_spmm_ref(
                    sr, p["src"], p["w"], p["dst"], x, plan.n_out), 3),
                bound_ms=bound, bound_by=by_what)
            r = out[key]
            log(f"serve B1 {key}: {path} row_len {geo.row_len} vec "
                f"{geo.vec} tpe {geo.threads_per_edge}: {r['ms']:.4f} ms "
                f"kernel, "
                f"{r['plain_ms']:.4f} ms plain, bound {bound:.4f} ms "
                f"({by_what}), {share:.3f} non-0̄, max|err| {err}")
            b *= 2
    torch.cuda.synchronize()
    return out


def _serve_b3_checks(dev, g_bm, g_ss):
    """B3 at the shapes the serve repairs hand it, recorded while a fresh
    server replays the phase's merge and delete outside the counted
    runs: the merge's Δ seed and a staged round over E′ (``runs``, trop
    rows of the 64 warm answers), the delete's recount (``scatter``) and
    its resumed round (``runs``).  Each equals the plain version exactly;
    timed beside its byte bound."""
    from repro_torch.core import semiring as sr_mod
    from repro_torch.kernels import coo_segment, ref
    from repro_torch.serve import ContinuousServer
    db_bm = _serve_bm_db(dev, g_bm)
    db_ss, ss_rel = _serve_ss_db(dev, g_ss)
    ss_src, new, w_new, bm_src, gone = _serve_update_data(g_bm, g_ss)
    cs = ContinuousServer(max_batch=SERVE_MAX_BATCH, chunk_iters=SERVE_CHUNK)
    cs.register("reach", _mk_bm, db_bm)
    cs.register("sssp", _mk_sssp, db_ss, edges=ss_rel)
    dispatch = coo_segment.segment_reduce
    seen = {"merge": [], "delete": []}
    for kind, fam, src, coords, vals in (
            ("merge", "sssp", ss_src, new, w_new.astype("float32")),
            ("delete", "reach", bm_src, gone, None)):
        for s in src:
            cs.submit(fam, int(s))
        cs.run_until_idle()

        def record(sr_name, v, ids, n, *, plan=None, into=seen[kind]):
            into.append((sr_name, v, ids, n, plan))
            return dispatch(sr_name, v, ids, n, plan=plan)
        coo_segment.segment_reduce = record
        try:
            u = cs.submit_update(fam, coords, vals, op=kind)
            cs.run_until_idle()
        finally:
            coo_segment.segment_reduce = dispatch
        _serve_gate(u.applied and u.error is None, f"B3 replay {kind}: "
                    f"{u.error}")
    m_runs = [c for c in seen["merge"] if c[4] is not None]
    d_runs = [c for c in seen["delete"] if c[4] is not None]
    d_scatter = [c for c in seen["delete"] if c[4] is None]
    _serve_gate(len(m_runs) >= 2 and d_runs and d_scatter,
                f"B3 replay: merge handed B3 {len(m_runs)} runs, delete "
                f"{len(d_runs)} runs and {len(d_scatter)} scatter")

    def size(c):
        return int(c[1].shape[0])
    picks = {"merge seed": min(m_runs, key=size),
             "merge round": max(m_runs, key=size),
             "delete recount": max(d_scatter, key=size)}
    if d_runs:
        picks["delete round"] = max(d_runs, key=size)
    out = {}
    for what, (name, vals, ids, n, plan) in picks.items():
        sr = sr_mod.get(name)
        launch = coo_segment.segment_reduce_cuda
        ids_in = ids if plan is None else ids.index_select(0, plan.order)
        args = (name, vals, ids, n) if plan is None else \
            (name, vals, ids, n, plan)
        want = ref.segment_reduce_ref(sr, vals, ids_in, n)
        err = _check(f"serve {what}", "coo_segment", launch(*args), want)
        m = int(vals.shape[0])
        row = vals.numel() // max(m, 1) * vals.element_size()
        bound, by_what = _bound(m * (row + 4) + n * row)
        out[what] = dict(path="scatter" if plan is None else "runs",
                         semiring=name, m=m, n=n,
                         lanes=int(vals.numel() // max(m, 1)),
                         max_abs_err=err,
                         ms=time_ms(lambda: launch(*args), 20,
                                    hide_host=True),
                         plain_ms=time_ms(lambda: ref.segment_reduce_ref(
                             sr, vals, ids_in, n), 3),
                         bound_ms=bound, bound_by=by_what)
        r = out[what]
        log(f"serve B3 {what}: {r['path']} {name} m={m} lanes {r['lanes']} "
            f"n={n}: {r['ms']:.4f} ms kernel, {r['plain_ms']:.4f} ms plain, "
            f"bound {bound:.4f} ms ({by_what}), max|err| {err}")
    return out


def _serve_chunk_profile(fam):
    """One warm chunk of a full B = 64 pool under ``torch.profiler``
    (rounds 5–8 of 64 fresh sources): device busy share, device events,
    and the share of B1 ``words_bool``'s pack and unpack kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    st, chunk = _warm_stepper(fam, SERVE_MAX_BATCH)

    def fn():
        return chunk(fam.edges, st.y, st.d, st.it)
    fn()
    _, wall_ms = wall(fn)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, pack_us, b1_us = [], 0.0, 0.0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        lo, hi = ev.time_range.start, ev.time_range.end
        spans.append((lo, hi))
        if any(p in ev.name for p in B1_PACK_EVENTS):
            pack_us += hi - lo
        if "spmm_" in ev.name:
            b1_us += hi - lo
    busy = _union_us(spans) / 1e3
    _serve_gate(b1_us > 0, f"chunk profile {fam.name}: no B1 event "
                f"captured ({len(spans)} device events)")
    res = dict(runner=fam.plan.strata[0].runner, wall_ms=wall_ms,
               device_busy_ms=busy, busy_share=busy / wall_ms,
               device_events=len(spans), b1_ms=b1_us / 1e3,
               pack_unpack_ms=pack_us / 1e3,
               pack_unpack_share=pack_us / 1e3 / busy if busy else 0.0,
               live_rows=int(st.live_lanes().sum()))
    log(f"serve chunk profile {fam.name}: wall {wall_ms:.3f} ms, device "
        f"busy {busy:.3f} ms ({100 * res['busy_share']:.0f}%), "
        f"{len(spans)} device events, B1 {res['b1_ms']:.3f} ms, pack+unpack "
        f"{res['pack_unpack_ms']:.4f} ms ({100 * res['pack_unpack_share']:.1f}"
        f"% of busy)")
    return res


# --------------------------------------------------------------------------
# phase 10: adaptive re-planning — the twin of benchmarks/replan_adaptive.py
# --------------------------------------------------------------------------

#: the benchmark's defaults: hub_chain(REPLAN_HUB, REPLAN_DEG,
#: REPLAN_CHAIN), B = REPLAN_BATCH sources of which REPLAN_DEEP are chain
#: heads, chunks of REPLAN_CHUNK rounds, REPLAN_TRIALS timed runs
REPLAN_HUB, REPLAN_DEG, REPLAN_CHAIN = 50_000, 18, 260
REPLAN_BATCH, REPLAN_DEEP, REPLAN_CHUNK, REPLAN_TRIALS = 64, 4, 32, 3
#: the drift (a few deep rows) and the control (none): (deep, seed)
REPLAN_WORKLOADS = (("drift", REPLAN_DEEP, 1), ("control", 0, 2))
REPLAN_START = "sparse_frontier_pallas"
REPLAN_CANDIDATES = ("sparse_frontier", "sparse_jit")
#: the static rivals, as fixpoint() arguments (B1 for the fused loop)
REPLAN_STATICS = (("sparse_frontier", dict(mode="frontier")),
                  ("sparse_frontier_pallas", dict(mode="jit",
                                                  backend="kernel")),
                  ("sparse_jit", dict(mode="jit")))
#: the kernel path each runner's chunks must launch, and no other
REPLAN_PATHS = {"sparse_frontier_pallas": ("b1", "words_bool"),
                "sparse_jit": ("b3", "runs"),
                "sparse_frontier": ("b3", "scatter")}


def hub_chain(n_hub, deg, n_chain, dev, seed=0):
    """``benchmarks/replan_adaptive.py``'s graph from the same numpy
    draws: a random hub (``n_hub`` vertices, ~``deg`` out-edges each)
    and a disjoint chain of ``n_chain`` vertices.  Returns the 𝔹
    relation on ``dev`` and its (coalesced) host edge list."""
    import numpy as np
    from repro_torch.sparse.coo import SparseRelation
    rng = np.random.default_rng(seed)
    n = n_hub + n_chain
    m = n_hub * deg
    src = np.concatenate([rng.integers(0, n_hub, m),
                          np.arange(n_hub, n - 1)])
    dst = np.concatenate([rng.integers(0, n_hub, m),
                          np.arange(n_hub + 1, n)])
    coords = np.stack([src, dst], 1)
    rel = SparseRelation.from_coo(coords, np.ones(len(coords), bool),
                                  (n, n), "bool", device=dev)
    return rel, np.unique(coords, axis=0)


def replan_sources(n_hub, n, batch, deep, seed):
    """The benchmark's ``(B, n)`` one-hot init: ``batch - deep`` hub
    sources and ``deep`` chain heads (the long-tail rows)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    init = np.zeros((batch, n), bool)
    init[np.arange(batch - deep), rng.integers(0, n_hub, batch - deep)] = True
    init[np.arange(batch - deep, batch), n_hub] = True
    return init


def _replan_gate(ok, what):
    if not ok:
        raise AssertionError(f"replan: {what}")


def _paths_now():
    return {"b1": _b1_now(), "b3": _b3_now()}


def _paths_delta(p0):
    return {"b1": _b1_delta(p0["b1"]), "b3": _b3_delta(p0["b3"])}


def _only_path(window, paths, runner):
    """A window of ``runner`` launched its kernel path and nothing else
    (pallas: B1 ``words_bool``; sparse_jit: B3 ``runs``; the worklist:
    B3 ``scatter``)."""
    kern, path = REPLAN_PATHS[runner]
    total = sum(sum(v.values()) for v in paths.values())
    _replan_gate(paths[kern][path] > 0 and total == paths[kern][path],
                 f"{window} ({runner}) launched {paths}, not {kern} "
                 f"{path} alone")


def _ms_stats(times):
    return dict(median_ms=_median(times), min_ms=min(times),
                max_ms=max(times), all_ms=times)


def _chunk_runner(trace, i):
    """The runner that ran chunk ``i`` of an adaptive trace."""
    cur = trace.start_runner
    for ev in trace.switches:
        if i > ev.chunk:
            cur = ev.to_runner
    return cur


def _replay(trace, iters_max):
    """Replay every priced boundary through the policy: the decision
    taken must be the one the policy allows, every logged switch
    carries its boundary's prices, and the chunk count fits the rounds
    run."""
    pol = trace.policy
    switched = {e.chunk: e for e in trace.switches}
    done = []
    for chunk, current, est in trace.prices:
        best = min(est, key=lambda c: (est[c], c != current, c))
        since = chunk - done[-1] if done else chunk + 1
        fire = best != current and pol.should_switch(
            est[current], est[best], chunk_index=chunk,
            chunks_since_switch=since, switches=len(done))
        _replan_gate(fire == (chunk in switched),
                     f"boundary {chunk}: the policy says switch={fire}, "
                     f"the trace {chunk in switched}")
        if fire:
            ev = switched[chunk]
            _replan_gate((ev.from_runner, ev.to_runner, ev.est_from,
                          ev.est_to) == (current, best, est[current],
                                         est[best]),
                         f"switch at chunk {chunk} is not its prices")
            done.append(chunk)
    _replan_gate(len(done) == len(trace.switches),
                 "a switch was logged at an unpriced boundary")
    want = -(-iters_max // pol.chunk_iters)
    _replan_gate(len(trace.chunks) == want,
                 f"{len(trace.chunks)} chunks for {iters_max} rounds of "
                 f"{pol.chunk_iters}")


def phase_replan(dev, data):
    """Adaptive re-planning on the card, the twin of
    ``benchmarks/replan_adaptive.py`` at its defaults, plus the
    planner's ``PlanHints(adaptive=True)`` path on the same graph."""
    t0 = time.perf_counter()
    rel, edges = hub_chain(REPLAN_HUB, REPLAN_DEG, REPLAN_CHAIN, dev)
    n = REPLAN_HUB + REPLAN_CHAIN
    _replan_gate(rel.nnz == len(edges), f"nnz {rel.nnz} vs {len(edges)}")
    csr = csr_host(n, edges)
    out = {"graph": {"n": n, "nnz": int(rel.nnz)}}
    inits = {name: replan_sources(REPLAN_HUB, n, REPLAN_BATCH, deep, seed)
             for name, deep, seed in REPLAN_WORKLOADS}
    with Counted() as c:
        for name, init in inits.items():
            out[name] = _replan_workload(dev, rel, init, csr, name, data)
        out["planner"] = _replan_planner(dev, rel, csr, n)
    out["launches"] = c.counts
    out["b3_paths"] = c.b3_paths
    log(f"replan launches {c.counts}; B3 paths {c.b3_paths}")
    _replan_gate({k for k, v in c.counts.items() if v}
                 == {"coo_spmm", "coo_segment"},
                 f"launched {c.counts}: B1 and B3 only")
    out["calibration"] = {name: _replan_calibration(dev, rel, init, name)
                          for name, init in inits.items()}
    out["b1_checks"], out["b3_checks"] = _replan_kernel_checks(
        dev, rel, inits["drift"])
    out["seconds"] = time.perf_counter() - t0
    log(f"replan phase: {out['seconds']:.1f} s")
    return out


def _round_robin(fns):
    """``REPLAN_TRIALS`` wall-clock runs of each callable, taken in turns
    (the order rotating each trial) so a drift of the shared host's
    speed spreads over all of them: ``{name: [ms, ...]}``."""
    names = list(fns)
    times = {k: [] for k in names}
    for t in range(REPLAN_TRIALS):
        for k in names[t % len(names):] + names[:t % len(names)]:
            times[k].append(wall(fns[k])[1])
    return times


def _replan_workload(dev, rel, init_np, csr, name, data):
    """One init pack: every static runner and the adaptive executor, a
    first run each and three timed in turns; answers, per-row counts and
    the trace gated, each runner's launches attributed by path."""
    import numpy as np
    import torch
    from repro_torch.core import runners
    from repro_torch.sparse import fixpoint as fx
    from repro_torch.sparse.adaptive import ReplanPolicy
    init = torch.from_numpy(init_np).to(dev)
    res, answers, fns = {"static": {}}, {}, {}
    for runner, kw in REPLAN_STATICS:
        def fn(kw=kw):
            return fx.fixpoint(rel, init, **kw)
        p0 = _paths_now()
        (y, it), first_ms = wall(fn)
        paths = _paths_delta(p0)
        _only_path(f"{name} static", paths, runner)
        answers[runner], fns[runner] = (y, it), fn
        res["static"][runner] = dict(first_ms=first_ms, paths=paths)
    policy = ReplanPolicy(chunk_iters=REPLAN_CHUNK)
    ctx = runners.make_context(rel, init, "bool", 10_000)

    def adaptive(observer=None):
        return runners.adaptive_fixpoint(
            ctx, start=REPLAN_START, candidates=REPLAN_CANDIDATES,
            policy=policy, observer=observer)
    # the first run attributes each chunk's launches by path: the
    # executor's observer hook sees every chunk as it lands
    windows, mark = [], [_paths_now()]

    def observe(stats):
        windows.append(_paths_delta(mark[0]))
        mark[0] = _paths_now()
    (y, it, trace), first_ms = wall(lambda: adaptive(observe))
    repeats = []

    def adaptive_timed():
        repeats.append(adaptive())
    times = _round_robin({**fns, "adaptive": adaptive_timed})
    for y2, it2, tr2 in repeats:
        _replan_gate(torch.equal(y2, y) and torch.equal(it2, it)
                     and [(e.chunk, e.to_runner) for e in tr2.switches]
                     == [(e.chunk, e.to_runner) for e in trace.switches],
                     f"{name}: adaptive runs differ")
    for runner in fns:
        res["static"][runner].update(_ms_stats(times[runner]))
    for runner, (ys, its) in answers.items():
        _replan_gate(torch.equal(ys, y) and torch.equal(its, it),
                     f"{name}: adaptive answer or counts differ from "
                     f"{runner}'s")
    y_host = y.cpu().numpy()
    rows = sorted({*np.random.default_rng(11).choice(
        REPLAN_BATCH - 1, 5, replace=False).tolist(), REPLAN_BATCH - 1})
    for r in rows:
        src = int(np.flatnonzero(init_np[r])[0])
        _replan_gate(np.array_equal(y_host[r], bfs_reach(csr, src)),
                     f"{name} row {r}: differs from scipy BFS")
    iters = it.cpu().numpy()
    _replan_gate(len(windows) == len(trace.chunks), "observer missed a "
                 "chunk")
    by_runner = {}
    for i, paths in enumerate(windows):
        runner = _chunk_runner(trace, i)
        _only_path(f"{name} chunk {i}", paths, runner)
        by_runner[runner] = by_runner.get(runner, 0) + 1
    _replay(trace, int(iters.max()))
    med = {k: v["median_ms"] for k, v in res["static"].items()}
    best = min(med, key=med.get)
    res["adaptive"] = dict(first_ms=first_ms, **_ms_stats(times["adaptive"]))
    res.update(
        rows_checked=rows, rounds=int(iters.max()),
        best_static=best,
        speedup=med[best] / res["adaptive"]["median_ms"],
        chunks=len(trace.chunks), chunks_by_runner=by_runner,
        final_runner=trace.final_runner,
        switches=[dict(chunk=e.chunk, iteration=e.iteration,
                       frontier_nnz=e.frontier_nnz, density=e.density,
                       frm=e.from_runner, to=e.to_runner,
                       est_from=e.est_from, est_to=e.est_to)
                  for e in trace.switches],
        prices=[dict(chunk=ch, runner=cur, est=est)
                for ch, cur, est in trace.prices],
        chunk_stats=[dict(iteration=s.iteration, nnz=s.nnz)
                     for s in trace.chunks])
    warm = data.setdefault("warm", {})
    warm[f"replan_{name}_adaptive"] = adaptive
    warm[f"replan_{name}_pallas"] = fns["sparse_frontier_pallas"]
    log(f"replan {name}: {res['rounds']} rounds, {res['chunks']} chunks "
        f"{by_runner}; static median ms "
        + ", ".join(f"{k} {v['median_ms']:.2f} [{v['min_ms']:.2f}–"
                    f"{v['max_ms']:.2f}]" for k, v in res["static"].items())
        + f"; adaptive {res['adaptive']['median_ms']:.2f} "
        f"[{res['adaptive']['min_ms']:.2f}–{res['adaptive']['max_ms']:.2f}]"
        f" ms, {res['speedup']:.3f}× the best static ({best}); switches "
        + (", ".join(f"chunk {e.chunk} @ iter {e.iteration}: "
                     f"{e.from_runner} → {e.to_runner} (est "
                     f"{e.est_from:.4g} → {e.est_to:.4g} ns)"
                     for e in trace.switches) or "none")
        + f"; priced boundaries "
        + "; ".join(f"{ch}: " + ", ".join(f"{k} {v:.4g}"
                                         for k, v in est.items())
                    for ch, _, est in trace.prices)
        + f"; exact against every static runner and scipy on rows {rows} "
        f"[{nvidia_smi()}]")
    return res


def _replan_planner(dev, rel, csr, n):
    """BM Π₂ from the chain head through the planner, with
    ``PlanHints(adaptive=True)`` and without: equal answers, the
    worklist rejected on the card, the adaptive line in explain."""
    import numpy as np
    import torch
    from repro_torch.core import engine, planner
    from repro_torch.datalog import programs
    bench = programs.bm(a=REPLAN_HUB)
    prog = bench.optimized
    db = engine.Database(bench.original.schema, {"id": n},
                         {"E": rel, "V": torch.ones(n, dtype=torch.bool,
                                                    device=dev)}, dev)
    res, fns = {}, {}
    for kind, hints in (("static", None),
                        ("adaptive", planner.PlanHints(adaptive=True))):
        plan = planner.plan_program(prog, db, hints=hints)
        sp = plan.strata[0]
        _replan_gate("sparse_frontier" in sp.rejected
                     and "sparse_frontier" not in sp.considered,
                     f"planner {kind}: the worklist is a candidate on the "
                     f"card ({sorted(sp.considered)})")
        fns[kind] = (lambda p=plan: planner.execute_plan(p, prog, db))
        (x, st), first_ms = wall(fns[kind])
        res[kind] = dict(runner=sp.runner, iterations=st.iterations,
                         considered=sorted(sp.considered),
                         explain=planner.explain(plan), first_ms=first_ms,
                         answer=x)
    for kind, times in _round_robin(fns).items():
        res[kind].update(_ms_stats(times))
    a, s = res["adaptive"], res["static"]
    _replan_gate(torch.equal(a.pop("answer"), s.pop("answer"))
                 and a["iterations"] == s["iterations"],
                 "planner: adaptive answer differs from the static one")
    _replan_gate("    adaptive    " in a["explain"]
                 and "    adaptive    " not in s["explain"],
                 "planner: explain's adaptive line")
    want = bfs_reach(csr, REPLAN_HUB)
    _replan_gate(int(want.sum()) == REPLAN_CHAIN, "chain reach")
    log(f"replan planner: BM Π₂ from the chain head, {s['runner']} "
        f"{s['iterations']} rounds; static {s['median_ms']:.2f} "
        f"[{s['min_ms']:.2f}–{s['max_ms']:.2f}] ms, adaptive "
        f"{a['median_ms']:.2f} [{a['min_ms']:.2f}–{a['max_ms']:.2f}] ms "
        f"(candidates {a['considered']}); explain:\n{a['explain']}")
    return res


def _replan_calibration(dev, rel, init_np, name):
    """Each static runner chunked (``REPLAN_CHUNK`` rounds) from the same
    cold carry: per chunk the boundary it started from (frontier nnz,
    live rows), the rounds it ran and its synchronized wall ms, beside
    ``ADAPTIVE_COST.round_ns``'s per-round prediction for that runner
    (the fused speedup from ``SPMM_COST``'s cuda entry)."""
    import torch
    from repro_torch.core import planner, runners
    from repro_torch.sparse import adaptive
    from repro_torch.sparse import fixpoint as fx
    init = torch.from_numpy(init_np).to(dev)
    ctx = runners.make_context(rel, init, "bool", 10_000)
    out = {}
    for runner, _ in REPLAN_STATICS:
        r = runners.get(runner)
        state = fx.FixpointState.cold(rel, init)
        rows = []
        while not state.converged:
            nnz, live = state.frontier_nnz(), state.live_rows()
            it0 = int(state.iters.max())
            pred = adaptive.ADAPTIVE_COST.round_ns(
                runner, n=ctx.n, e_nnz=ctx.e_nnz, batch=state.batch,
                frontier_nnz=nnz, live_rows=live, semiring="bool",
                fused_speedup=planner.SPMM_COST.speedup("bool", "cuda"))
            (state, _), ms = wall(lambda s=state: r.run_chunk(
                ctx, s, REPLAN_CHUNK))
            rounds = int(state.iters.max()) - it0
            rows.append(dict(iteration=it0, frontier_nnz=nnz,
                             live_rows=live, rounds=rounds, ms=ms,
                             ms_per_round=ms / rounds,
                             predicted_ms_per_round=pred / 1e6))
        out[runner] = rows
        log(f"replan calibration {name} {runner}: "
            + "; ".join(f"@{x['iteration']} nnz {x['frontier_nnz']} live "
                        f"{x['live_rows']}: {x['rounds']} rounds "
                        f"{x['ms_per_round']:.4f} ms/round (model "
                        f"{x['predicted_ms_per_round']:.4f})" for x in rows)
            + f" [{nvidia_smi()}]")
    return out


def _replan_kernel_checks(dev, rel, init_np):
    """B1 and B3 at this phase's shapes, outside the counted runs, each
    exact against its plain version and timed beside its byte bound: B1
    ``words_bool`` on the drift's (n × 64) carry after 3 rounds; B3
    ``runs`` on the payload of one ``sparse_jit`` round (the third),
    recorded at ``coo_segment.segment_reduce``; B3 ``scatter`` on the
    smallest and largest round of one worklist run of the drift,
    recorded the same way."""
    import torch
    from repro_torch.core import runners
    from repro_torch.core import semiring as sr_mod
    from repro_torch.kernels import coo_segment, coo_spmm, ref
    from repro_torch.sparse import fixpoint as fx
    sr = sr_mod.get("bool")
    init = torch.from_numpy(init_np).to(dev)
    ctx = runners.make_context(rel, init, "bool", 10_000)
    cold = fx.FixpointState.cold(rel, init)
    # B1 on the first chunk's carry
    st, _ = runners.get("sparse_frontier_pallas").run_chunk(ctx, cold, 3)
    x = st.delta.t().contiguous()
    plan = coo_spmm.plan_geometry(rel, transpose=True)
    p = plan.on(dev)
    path, geo = coo_spmm.plan_spmm(plan, x.shape[1])
    p0 = _b1_now()
    got = coo_spmm.spmm_cuda(plan, x)
    launched = _b1_delta(p0)
    _replan_gate(path == "words_bool" and launched[path] == 1
                 and sum(launched.values()) == 1,
                 f"B1 check launched {launched}, not one words_bool")
    want = ref.coo_spmm_ref(sr, p["src"], p["w"], p["dst"], x, plan.n_out)
    err = _check("replan drift carry", "coo_spmm", got, want)
    share = float(want.float().mean())
    _replan_gate(0.0 < share < 1.0, f"B1 check: {share} of the answer true")
    nbytes = ((4 + p["w"].element_size()) * plan.nnz
              + 8 * geo.items.n_items + 8 * geo.items.n_split
              + (plan.n_in + plan.n_out) * x.shape[1] * x.element_size())
    bound, by_what = _bound(nbytes)
    b1 = {"drift carry": dict(
        path=path, lanes=int(x.shape[1]), n=int(x.shape[0]),
        live_share=share, max_abs_err=err,
        ms=time_ms(lambda: coo_spmm.spmm_cuda(plan, x), 20,
                   hide_host=True),
        plain_ms=time_ms(lambda: ref.coo_spmm_ref(
            sr, p["src"], p["w"], p["dst"], x, plan.n_out), 3),
        bound_ms=bound, bound_by=by_what)}
    r = b1["drift carry"]
    log(f"replan B1 drift carry: {path} (n={x.shape[0]}, B={x.shape[1]}): "
        f"{r['ms']:.4f} ms kernel, {r['plain_ms']:.4f} ms plain, bound "
        f"{bound:.4f} ms ({by_what}), {share:.3f} true, max|err| {err}")
    # B3: record what the runners hand it
    dispatch = coo_segment.segment_reduce
    seen = {"runs": [], "scatter": {}}

    def record(sr_name, v, ids, n, *, plan=None):
        if plan is not None:
            seen["runs"].append((sr_name, v, ids, n, plan))
        else:
            m = int(v.shape[0])
            ext = seen["scatter"]
            if m and ("min" not in ext or m < ext["min"][1].shape[0]):
                ext["min"] = (sr_name, v, ids, n, None)
            if "max" not in ext or m > ext["max"][1].shape[0]:
                ext["max"] = (sr_name, v, ids, n, None)
        return dispatch(sr_name, v, ids, n, plan=plan)
    coo_segment.segment_reduce = record
    try:
        runners.get("sparse_jit").run_chunk(ctx, cold, 3)
        fx.fixpoint(rel, init, mode="frontier")
    finally:
        coo_segment.segment_reduce = dispatch
    _replan_gate(len(seen["runs"]) == 3 and len(seen["scatter"]) == 2,
                 f"B3 recorder: {len(seen['runs'])} runs, "
                 f"{len(seen['scatter'])} scatter extremes")
    picks = {"jit round 3": seen["runs"][-1],
             "worklist smallest non-empty round": seen["scatter"]["min"],
             "worklist largest round": seen["scatter"]["max"]}
    b3 = {}
    for what, (name, vals, ids, n, seg) in picks.items():
        launch = coo_segment.segment_reduce_cuda
        ids_in = ids if seg is None else ids.index_select(0, seg.order)
        args = (name, vals, ids, n) if seg is None else \
            (name, vals, ids, n, seg)
        p0 = _b3_now()
        got = launch(*args)
        launched = _b3_delta(p0)
        kind = "scatter" if seg is None else "runs"
        _replan_gate(launched[kind] == 1 and sum(launched.values()) == 1,
                     f"B3 check {what}: launched {launched}")
        want = ref.segment_reduce_ref(sr_mod.get(name), vals, ids_in, n)
        err = _check(f"replan {what}", "coo_segment", got, want)
        m = int(vals.shape[0])
        row = vals.numel() // max(m, 1) * vals.element_size()
        bound, by_what = _bound(m * (row + 4) + n * row)
        b3[what] = dict(path=kind, m=m, n=n,
                        lanes=int(vals.numel() // max(m, 1)),
                        true_share=float(want.float().mean()),
                        max_abs_err=err,
                        ms=time_ms(lambda: launch(*args), 20,
                                   hide_host=True),
                        plain_ms=time_ms(lambda: ref.segment_reduce_ref(
                            sr_mod.get(name), vals, ids_in, n), 3),
                        bound_ms=bound, bound_by=by_what)
        r = b3[what]
        log(f"replan B3 {what}: {kind} m={m} lanes {r['lanes']} n={n}: "
            f"{r['ms']:.4f} ms kernel, {r['plain_ms']:.4f} ms plain, bound "
            f"{bound:.4f} ms ({by_what}), max|err| {err}")
    _replan_gate(0.0 < b3["jit round 3"]["true_share"] < 1.0,
                 "B3 runs check: the round's answer is all or nothing")
    return b1, b3


# --------------------------------------------------------------------------
# phase 1, continued: B4 and B5 at the serving path's shapes
# --------------------------------------------------------------------------


def _check_float(name, kernel, got, want):
    """max |err| of a float kernel against its plain version, held to
    FLOAT_TOL · max(1, max |plain|)."""
    import torch
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{kernel}/{name}: non-finite output")
    err = max_abs_err(got, want)
    tol = FLOAT_TOL * max(1.0, float(want.abs().max()))
    if err > tol:
        raise AssertionError(f"{kernel}/{name}: kernel disagrees with its "
                             f"plain version (max |err| {err} > {tol})")
    return err, tol


def phase_lm_kernels(dev):
    """B4 and B5 at the shapes of the lm_serve phase, each timed beside
    its plain version, its library call (B5: SDPA) and its bound."""
    import torch
    results = [kernel_b4(dev), kernel_b5(dev)]
    for k in results:
        by = k["by_shape"]
        head = next(iter(by.values()))
        k.update(route="cuda",
                 max_abs_err=max(v["max_abs_err"] for v in by.values()),
                 ms=head["ms"], plain_ms=head["plain_ms"],
                 bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                 library_ms=head["library_ms"],
                 library_call=head["library_call"])
        for name, v in by.items():
            extra = (f" [cold L2 {v['cold_ms']:.4f} ms, with host "
                     f"{v['host_ms']:.4f} ms]")
            if "bound_share" in v:
                extra += (f" [{100 * v['bound_share']:.1f}% of the bound, "
                          f"cold L2 {100 * v['cold_bound_share']:.1f}%]")
            if "path" in v:
                extra = (f" [{v['path']}: cold L2 {v['cold_ms']:.4f} ms, "
                         f"with host {v['host_ms']:.4f} ms, FP32 SIMT "
                         f"bound {v['bound_simt_ms']:.4f} ms]")
            log(f"{k['name']:>16} {name:>7}: {v['ms']:.4f} ms kernel, "
                f"{v['plain_ms']:.4f} ms plain, library "
                f"{v['library_ms']} ms, bound {v['bound_ms']:.4f} ms "
                f"({v['bound_by']}), max|err| {v['max_abs_err']:.3g} "
                f"(tol {v['tol']:.3g}){extra}")
    b5 = results[1]
    b5["wide_simt"] = kernel_b5_wide(dev)
    b5["wide_chunk"] = kernel_b5_wide(dev, B5_CHUNK, B5_CHUNK_TRAIN,
                                      "wide_chunk", 100)
    b5["max_abs_err"] = max(b5["max_abs_err"],
                            b5["wide_simt"]["max_abs_err"],
                            b5["wide_chunk"]["max_abs_err"])
    torch.cuda.synchronize()
    return results


def _lm_cfg():
    from repro_torch import configs
    return configs.get(LM_ARCH)


def b4_rows():
    """B4's rows as (name, arch, (B, T, D)): Zamba2's Mamba2 prefill
    (8, 512, 5120), xLSTM-125M's mLSTM/sLSTM prefill (8, 512, 1536), and
    one long prompt at xLSTM's width, (1, 8192, 1536), where B·D is
    1,536 (held and timed here only: no cell runs it)."""
    from repro_torch import configs
    rows = []
    for name, arch, bsz, t_len in (
            ("prefill", LM_ARCH, LM_BATCH, LM_PROMPT[1]),
            ("xlstm_prefill", "xlstm-125m", LM_BATCH, LM_PROMPT[1]),
            ("xlstm_long", "xlstm-125m", 1, B4_LONG_PROMPT)):
        cfg = configs.get(arch)
        rows.append((name, arch, (bsz, t_len,
                                  cfg.d_inner_mult * cfg.d_model)))
    return rows


def b4_inputs(dev, shape):
    """a in (0, 1) as the sigmoid decay gives it, b standard normal."""
    import torch
    g = torch.Generator(device=dev).manual_seed(4)
    a = torch.sigmoid(torch.randn(shape, generator=g, device=dev) + 2.0)
    b = torch.randn(shape, generator=g, device=dev)
    return a, b


def kernel_b4(dev):
    """B4 at :func:`b4_rows`, each row checked (one launch a call, within
    tolerance of the plain version) and timed beside its byte bound."""
    from repro_torch.kernels import ref, ssm_scan
    by = {}
    for name, arch, shape in b4_rows():
        a, b = b4_inputs(dev, shape)
        before = ssm_scan.ssm_scan_cuda.launches
        got = ssm_scan.ssm_scan_cuda(a, b)
        if ssm_scan.ssm_scan_cuda.launches != before + 1:
            raise AssertionError(f"ssm_scan/{name}: not one launch a call")
        want = ref.ssm_scan_ref(a, b)
        err, tol = _check_float(name, "ssm_scan", got, want)
        n = a.numel()
        bound, by_what = _bound(3.0 * n * 4, 2.0 * n)

        def kernel(a=a, b=b):
            return ssm_scan.ssm_scan_cuda(a, b)
        ms = time_ms(kernel, 20, hide_host=True)
        cold = time_cold_ms(kernel, 10)
        by[name] = dict(
            arch=arch, shape=dict(zip("BTD", shape)), max_abs_err=err,
            tol=tol, ms=ms, cold_ms=cold, host_ms=time_ms(kernel, 20),
            plain_ms=time_ms(lambda a=a, b=b: ref.ssm_scan_ref(a, b), 5),
            library_ms=None,
            library_call="none: no single PyTorch call computes a linear "
                         "recurrence",
            bound_ms=bound, bound_by=by_what, bytes=3.0 * n * 4,
            bound_share=bound / ms, cold_bound_share=bound / cold)
        del a, b, got, want
    return {"name": "ssm_scan", "source": "src/repro_torch/csrc/ssm_scan.cu",
            "replaces": "src/repro/kernels/ssm_scan.py:29", "by_shape": by}


def _visible_ranges(tq, tk, *, causal=True, window=None, chunk=None,
                    q_offset=0):
    """Each query's ``[lo, hi)`` of keys the masks leave visible."""
    for i in range(tq):
        pos = q_offset + i
        lo, hi = 0, tk
        if causal:
            hi = min(hi, pos + 1)
        if window:
            lo = max(lo, pos - window + 1)
        if chunk:
            lo = max(lo, pos // chunk * chunk)
            hi = min(hi, (pos // chunk + 1) * chunk)
        yield lo, max(lo, hi)


def visible_pairs(tq, tk, **kw) -> int:
    """(query, key) pairs the masks leave visible: the work B5 must do
    on these inputs."""
    return sum(hi - lo for lo, hi in _visible_ranges(tq, tk, **kw))


def visible_keys(tq, tk, **kw) -> int:
    """Keys some query sees: the keys (and values) B5 must read on these
    inputs (a windowed decode step reads only the window)."""
    import numpy as np
    seen = np.zeros(tk + 1, np.int64)
    for lo, hi in _visible_ranges(tq, tk, **kw):
        seen[lo] += 1
        seen[hi] -= 1
    return int((np.cumsum(seen[:tk]) > 0).sum())


def attention_plain_blocked(q, k, v, **kw):
    """B5's plain version over blocks of kv heads, so that no block's
    (B, H, Tq, Tk) logits exceed ≈2 GB."""
    import torch
    from repro_torch.kernels import ref
    b, tq, hq, _ = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    per = max(1, int(2e9 // (4 * b * group * tq * max(tk, 1))))
    out = torch.empty_like(q)
    for lo in range(0, hkv, per):
        hi = min(hkv, lo + per)
        out[:, :, lo * group:hi * group] = ref.attention_ref(
            q[:, :, lo * group:hi * group], k[:, :, lo:hi], v[:, :, lo:hi],
            **kw)
    return out


def b5_inputs(dev, seed, b, tq, tk, hq, hkv, d, t_max=None):
    """Random q (B, Tq, Hq, D) and k, v as the written prefix of a
    ``t_max``-slot cache (strided views; contiguous with no t_max)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    slots = t_max or tk
    k = torch.randn((b, slots, hkv, d), generator=g, device=dev)[:, :tk]
    v = torch.randn((b, slots, hkv, d), generator=g, device=dev)[:, :tk]
    return torch.randn((b, tq, hq, d), generator=g, device=dev), k, v


def b5_check(name, q, k, v, **kw):
    """One B5 launch outside any counted run, held against its plain
    version; returns the path, the geometry and the error."""
    from repro_torch.kernels import flash_attention as fa
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    path, geo = fa.plan_attention(b, tq, tk, hq, hkv, d, **kw)
    paths = dict(fa.flash_attention_cuda.by_path)
    got = fa.flash_attention_cuda(q, k, v, **kw)
    paths[path] += 1
    if fa.flash_attention_cuda.by_path != paths:
        raise AssertionError(f"flash_attention/{name}: launched "
                             f"{fa.flash_attention_cuda.by_path}, "
                             f"expected one more {path}")
    want = attention_plain_blocked(q, k, v, **kw)
    err, tol = _check_float(name, "flash_attention", got, want)
    return path, geo, err, tol, want


def _sdpa(q, k, v, *, causal=True, window=None, chunk=None, q_offset=0):
    """``F.scaled_dot_product_attention`` (f32) computing B5's function:
    no mask where the call's own causal flag or none says it, else a
    boolean (Tq, Tk) mask; GQA through ``enable_gqa``."""
    import torch
    import torch.nn.functional as F
    tq, tk = q.shape[1], k.shape[1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    gqa = q.shape[2] != k.shape[2]
    masked = bool(window or chunk) or (
        causal and not (q_offset == 0 and tq == tk)
        and not (tq == 1 and q_offset >= tk - 1))
    mask = None
    if masked:
        qpos = torch.arange(tq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(tk, device=q.device)[None, :]
        mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        if chunk:
            mask &= (kpos // chunk) == (qpos // chunk)
    is_causal = causal and not masked and q_offset == 0 and tq == tk

    def call():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=is_causal,
            enable_gqa=gqa).transpose(1, 2)
    return call


#: B5's timed shapes beside SDPA and the bound: Zamba2's (the lm_serve
#: phase: 32 heads of 80, group 1), DeepSeekMoE-16B's (16 heads of 128,
#: group 1) and StarCoder2-7B's (36 query heads of 128 over 4 kv heads,
#: group 9, window 4,096 binding from position 4,096 on).  (arch, batch,
#: tq, tk, q_offset, t_max)
B5_TIMED = {
    "prefill": ("zamba2-2.7b", LM_BATCH, 512, 512, 0, LM_T_MAX),
    "decode": ("zamba2-2.7b", LM_BATCH, 1, 544, 543, LM_T_MAX),
    "full544": ("zamba2-2.7b", LM_BATCH, 544, 544, 0, LM_T_MAX),
    "deepseek_prefill": ("deepseek-moe-16b", LM_BATCH, 512, 512, 0,
                         LM_T_MAX),
    "deepseek_decode": ("deepseek-moe-16b", LM_BATCH, 1, 544, 543,
                        LM_T_MAX),
    "starcoder2_window": ("starcoder2-7b", 2, 4600, 4600, 0, 4864),
    "starcoder2_decode": ("starcoder2-7b", 2, 1, 4616, 4615, 4864),
}


def kernel_b5(dev):
    """B5 over the written slots of a KV cache, as strided views, at
    the serving paths' shapes (``B5_TIMED``).  Each shape's bound is in
    its path's unit: prefill_tc's operations at three TF32 tensor-core
    passes, decode_split's bytes; ``bound_simt_ms`` keeps the FP32 SIMT
    bound of the kernel this one replaced."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa, ref
    by = {}
    for i, (name, (arch, b, tq, tk, off, t_max)) in enumerate(
            B5_TIMED.items()):
        cfg = configs.get(arch)
        hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        kw = dict(causal=True, window=cfg.window, chunk=cfg.chunk,
                  q_offset=off)
        q, k, v = b5_inputs(dev, 5 + i, b, tq, tk, hq, hkv, d, t_max)
        path, geo, err, tol, want = b5_check(name, q, k, v, **kw)
        library = _sdpa(q, k, v, **kw)
        lib_err = max_abs_err(library(), want)
        if lib_err > tol:
            raise AssertionError(f"SDPA yardstick disagrees ({name}: "
                                 f"{lib_err})")
        del want

        def kernel(q=q, k=k, v=v, kw=kw):
            return fa.flash_attention_cuda(q, k, v, **kw)
        ops = 4.0 * b * hq * d * visible_pairs(tq, tk, **kw)
        keys = visible_keys(tq, tk, **kw)
        nbytes = 4.0 * d * (2 * b * tq * hq + 2 * b * keys * hkv)
        if path == "prefill_tc":
            bound, by_what = _bound(nbytes, 3 * ops, TF32_TC_FLOPS)
        else:
            bound, by_what = _bound(nbytes, ops)
        plain_reps = 5 if tq * tk < 1 << 22 else 2
        by[name] = dict(
            arch=arch,
            shape={"B": b, "Tq": tq, "Tk": tk, "Hq": hq, "Hkv": hkv,
                   "D": d, "q_offset": off, "window": cfg.window},
            visible_keys=keys,
            path=path, grid=list(geo.grid), splits=geo.splits,
            keys_per_split=geo.keys_per_split,
            max_abs_err=err, tol=tol,
            ms=time_ms(kernel, 20, hide_host=True),
            cold_ms=time_cold_ms(kernel, 10),
            host_ms=time_ms(kernel, 20),
            plain_ms=time_ms(lambda q=q, k=k, v=v, kw=kw:
                             ref.attention_ref(q, k, v, **kw), plain_reps),
            library_ms=time_ms(library, 20, hide_host=True),
            library_call="F.scaled_dot_product_attention (f32)",
            bound_ms=bound, bound_by=by_what,
            bound_simt_ms=_bound(nbytes, ops)[0], ops=ops, bytes=nbytes)
        del q, k, v
    return {"name": "flash_attention",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:32",
            "by_shape": by}


#: B5's wide_simt route (128 < D ≤ 256), 16 q heads over 8 kv heads of
#: 256 (Gemma 2's head dim), and one odd shape at D = 200: (batch, tq,
#: tk, hq, hkv, d, mask keywords, cache slots or None)
B5_WIDE = {
    "wide_prefill": (2, 1024, 1024, 16, 8, 256, {}, None),
    "wide_window": (2, 1024, 1024, 16, 8, 256, {"window": 512}, None),
    "wide_decode": (8, 1, 544, 16, 8, 256, {"q_offset": 543}, 1024),
    "wide_odd": (2, 37, 53, 6, 2, 200, {"window": 20, "q_offset": 16},
                 None),
}
#: the route's backward rows (``b5_train_shape``'s layout)
B5_WIDE_TRAIN = {
    "wide_causal": (None, 2, 1024, 1024, 16, 8, 256, {}),
    "wide_odd": (None, 2, 37, 53, 6, 2, 200, {"window": 20,
                                               "q_offset": 16}),
}


#: B5's wide_chunk route (D > 256, any D): 16 q heads over 8 kv heads of
#: 512, a decode step at 576 and an odd shape at 320, as ``B5_WIDE``
B5_CHUNK = {
    "chunk_prefill": (2, 512, 512, 16, 8, 512, {}, None),
    "chunk_decode": (8, 1, 544, 16, 8, 576, {"q_offset": 543}, 1024),
    "chunk_odd": (2, 37, 53, 6, 2, 320, {"window": 20, "q_offset": 16},
                  None),
}
B5_CHUNK_TRAIN = {
    "chunk_causal": (None, 2, 512, 512, 16, 8, 512, {}),
    "chunk_odd": (None, 2, 37, 53, 6, 2, 576, {"window": 20,
                                                "q_offset": 16}),
}


def kernel_b5_wide(dev, rows=None, train=None, route="wide_simt", seed=80):
    """B5's wide_simt route at ``B5_WIDE`` (forward; decode from a cache
    view) and ``B5_WIDE_TRAIN`` (``AttnFn``'s backward) — or ``route``
    at ``rows`` and ``train`` (wide_chunk: ``B5_CHUNK``) — each held
    against its plain version and timed beside its bound (f32 FMA: the
    operations at the FP32 SIMT rate, or the bytes), the plain version
    and SDPA in f32; the launches of the route counted (comparison
    launches: the main path runs no head past 128)."""
    from repro_torch.kernels import flash_attention as fa, ref
    rows = B5_WIDE if rows is None else rows
    train = B5_WIDE_TRAIN if train is None else train
    fwd0 = fa.flash_attention_cuda.by_path[route]
    bwd0 = fa.attention_backward_cuda.by_path[route]
    by = {}
    for i, (name, (b, tq, tk, hq, hkv, d, extra, slots)) in enumerate(
            rows.items()):
        kw = {"causal": True, "window": None, "chunk": None, "q_offset": 0,
              **extra}
        q, k, v = b5_inputs(dev, seed + i, b, tq, tk, hq, hkv, d, slots)
        path, geo, err, tol, want = b5_check(name, q, k, v, **kw)
        if path != route:
            raise AssertionError(f"flash_attention/{name}: D = {d} went "
                                 f"{path}")
        try:
            library = _sdpa(q, k, v, **kw)
            lib_err = max_abs_err(library(), want)
            library_ms, library_error = time_ms(library, 10,
                                                hide_host=True), None
            if lib_err > tol:
                raise AssertionError(f"SDPA yardstick disagrees ({name}: "
                                     f"{lib_err})")
        except RuntimeError as e:
            library_ms, library_error = None, str(e)[:200]
        del want

        def kernel(q=q, k=k, v=v, kw=kw):
            return fa.flash_attention_cuda(q, k, v, **kw)
        ops = 4.0 * b * hq * d * visible_pairs(tq, tk, **kw)
        keys = visible_keys(tq, tk, **kw)
        nbytes = 4.0 * d * (2 * b * tq * hq + 2 * b * keys * hkv)
        bound, by_what = _bound(nbytes, ops)
        ms = time_ms(kernel, 10, hide_host=True)
        by[name] = dict(
            shape={"B": b, "Tq": tq, "Tk": tk, "Hq": hq, "Hkv": hkv, "D": d,
                   **kw, "cache_slots": slots},
            path=path, grid=list(geo.grid), max_abs_err=err, tol=tol,
            ms=ms, host_ms=time_ms(kernel, 10),
            plain_ms=time_ms(lambda q=q, k=k, v=v, kw=kw:
                             ref.attention_ref(q, k, v, **kw), 3),
            library_ms=library_ms,
            library_call="F.scaled_dot_product_attention (f32)",
            library_error=library_error, bound_ms=bound, bound_by=by_what,
            ops=ops, bytes=nbytes, bound_share=bound / ms)
        log(f"{'flash_attention':>16} {name} {by[name]['shape']}: {ms:.4f} "
            f"ms kernel ({100 * bound / ms:.1f}% of the {by_what} bound "
            f"{bound:.4f} ms), {by[name]['plain_ms']:.4f} ms plain, SDPA "
            f"f32 {library_ms} ms, max|err| {err:.3g} (tol {tol:.3g})")
        del q, k, v
    backward = b5_backward_rows(dev, train, seed + 10, wide=route)
    return {"forward": by, "backward": backward,
            "launches": {
                "forward": fa.flash_attention_cuda.by_path[route] - fwd0,
                "backward": fa.attention_backward_cuda.by_path[route]
                - bwd0},
            "max_abs_err": max(v["max_abs_err"] for v in
                               (*by.values(), *backward.values()))}


# --------------------------------------------------------------------------
# phase 8: Zamba2-2.7B greedy serving
# --------------------------------------------------------------------------


def phase_lm_serve(dev, data):
    """serve_batch at full width; decode checked against a full forward."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    # full-f32 products, as the reference computes them (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lm_cfg()
    widths = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd, cfg.vocab)
    if widths != LM_WIDTHS:
        raise AssertionError(f"lm_serve: {LM_ARCH} widths {widths}")
    (params, init_ms) = wall(lambda: T.init_params(cfg, seed=0, device=dev))
    n_tensor = sum(x.numel() for x in _leaves(params))
    rng = data["rng"]
    lengths = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_BATCH)
    lengths[0] = LM_PROMPT[1]          # the batch pads to 512
    prompts = [rng.integers(1, cfg.vocab, n) for n in lengths]

    def run(max_new):
        reqs = [serve.Request(p, max_new) for p in prompts]
        stats = serve.serve_batch(LM_ARCH, reqs, smoke=False,
                                  t_max=LM_T_MAX, device=dev, params=params)
        return reqs, stats
    run(2)                             # warm-up: cuBLAS handles, clocks
    torch.cuda.reset_peak_memory_stats()
    with Counted() as c:
        reqs, stats = run(LM_MAX_NEW)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"lm_serve launches {c.counts}")
    _no_b3("lm_serve", c.counts)
    n_seg = cfg.n_layers // cfg.hybrid_attn_every
    want = {"ssm_scan": cfg.n_layers,
            "flash_attention": n_seg * (1 + LM_MAX_NEW)}
    for name, n in want.items():
        if c.counts[name] != n:
            raise AssertionError(f"lm_serve: {name} launched "
                                 f"{c.counts[name]} times, expected {n}")
    # the prefill's attention on tensor cores, every decode step split-KV
    want_paths = {"prefill_tc": n_seg, "decode_split": n_seg * LM_MAX_NEW,
                  "wide_simt": 0, "wide_chunk": 0}
    log(f"lm_serve B5 paths {c.b5_paths}")
    if c.b5_paths != want_paths:
        raise AssertionError(f"lm_serve: B5 launches went {c.b5_paths}, "
                             f"expected {want_paths}")
    out = np.array([r.out for r in reqs])
    if out.shape != (LM_BATCH, LM_MAX_NEW) or out.min() < 0 \
            or out.max() >= cfg.vocab:
        raise AssertionError(f"lm_serve: tokens {out.shape}, range "
                             f"[{out.min()}, {out.max()}]")
    # a full forward (no cache) over prompt + generated tokens ends where
    # the last decode step did
    padded = np.zeros((LM_BATCH, LM_PROMPT[1]), np.int64)
    for i, p in enumerate(prompts):
        padded[i, LM_PROMPT[1] - len(p):] = p
    full_tokens = torch.from_numpy(np.concatenate([padded, out], 1)).to(dev)
    (full, _), full_ms = wall(lambda: T.forward(params, cfg, full_tokens))
    dec, ref_last = stats["last_logits"], full[:, -1]
    if not bool(torch.isfinite(dec).all()):
        raise AssertionError("lm_serve: non-finite decode logits")
    err = max_abs_err(dec, ref_last)
    tol = LOGIT_TOL * max(1.0, float(ref_last.abs().max()))
    if err > tol:
        raise AssertionError(f"lm_serve: decode logits differ from the full "
                             f"forward (max |err| {err} > {tol})")
    top2 = torch.topk(ref_last, 2, -1).values
    clear = (top2[:, 0] - top2[:, 1]) > tol
    same = dec.argmax(-1) == ref_last.argmax(-1)
    if not bool(same[clear].all()):
        raise AssertionError("lm_serve: decode argmax differs from the full "
                             "forward where the top-2 margin exceeds tol")
    del full
    res = dict(arch=LM_ARCH, widths=dict(zip(
                   ("layers", "d_model", "heads", "head_dim", "vocab"),
                   widths)),
               param_count=cfg.param_count(), tensor_elements=n_tensor,
               batch=LM_BATCH, prompt_lengths=[int(x) for x in lengths],
               max_new=LM_MAX_NEW, t_max=LM_T_MAX, init_ms=init_ms,
               prefill_ms=stats["prefill_s"] * 1e3,
               decode_ms_per_step=stats["decode_s"] * 1e3 / LM_MAX_NEW,
               tok_per_s=stats["tok_per_s"], full_forward_ms=full_ms,
               logit_max_abs_err=err, logit_tol=tol,
               argmax_checked=int(clear.sum()), peak_mem_gb=peak_gb,
               launches=c.counts, b5_paths=c.b5_paths)
    log(f"lm_serve: {LM_ARCH} {cfg.param_count() / 1e9:.2f} B params "
        f"({n_tensor} tensor elements), B={LM_BATCH} prompts "
        f"{int(lengths.min())}-{int(lengths.max())} → {LM_PROMPT[1]}, "
        f"{LM_MAX_NEW} new: prefill {res['prefill_ms']:.1f} ms, decode "
        f"{res['decode_ms_per_step']:.2f} ms/step, "
        f"{res['tok_per_s']:.1f} tok/s, peak {peak_gb:.1f} GB; decode vs "
        f"full forward max|err| {err:.3g} (tol {tol:.3g}), argmax equal "
        f"on {int(clear.sum())}/{LM_BATCH} clear rows [{nvidia_smi()}]")
    cache = T.init_cache(cfg, LM_BATCH, LM_T_MAX, device=dev)
    prompt_t = full_tokens[:, :LM_PROMPT[1]]
    last, last_pos = full_tokens[:, -1:], LM_PROMPT[1] + LM_MAX_NEW - 1
    data.setdefault("warm", {}).update(
        lm_prefill=lambda: T.forward(params, cfg, prompt_t,
                                     cache={**cache, "pos": 0}),
        lm_decode=lambda: T.decode_step(params, cfg, last,
                                        {**cache, "pos": last_pos}))
    return res


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


# --------------------------------------------------------------------------
# phase 11: graph-axis sharded fixpoints — the twin of
# benchmarks/sharded_scaling.py
# --------------------------------------------------------------------------

#: the benchmark's defaults: powerlaw(size, 4, seed) at both sizes, B
#: sources a size, weights and sources from one default_rng(seed)
SHARDED_SIZES = (5_000, 2_000_000)
SHARDED_SEED, SHARDED_BATCH = 1, 8
#: the sizes the two-rank world runs (the phase's budget cuts the
#: largest first)
SHARDED_D2_SIZES = SHARDED_SIZES
#: the D = 2 world's serving check: the serve phase's BM graph, 16
#: requests, a merge of 100 new edges
SHARDED_SERVE = (50_000, 16, 100)
#: a shrunk ladder for the small graph at D = 2, so each tier and the
#: dense fallback run whatever the defaults take (the reference's
#: ``test_exchange_fallback_boundary_rounds`` shrinks them too)
SHARDED_SMALL_CAPS = ((16, 1 << 20), (128, 1 << 20))
SHARDED_TRIALS = 3
#: sharded_scaling.py's tolerance for the ℕ∞ contraction probe
SHARDED_NAT_TOL = dict(rtol=1e-6, atol=1e-4)


def _sharded_gate(ok, what):
    if not ok:
        raise AssertionError(f"sharded: {what}")


def _sharded_generate(out_dir):
    """The benchmark's draws, in its order, saved to ``out_dir``: per
    size the graph (int32 edges, checked distinct), its weights
    ``integers(1, 256)`` and ``B`` distinct sources, then the ℕ∞ probe's
    vector on the small graph; and the seconds it took."""
    import numpy as np
    from repro_torch.datalog import datasets
    t0 = time.perf_counter()
    rng = np.random.default_rng(SHARDED_SEED)
    for size in SHARDED_SIZES:
        g = datasets.powerlaw(size, 4, seed=SHARDED_SEED)
        w = rng.integers(1, 256, len(g.edges))
        src = rng.choice(size, size=SHARDED_BATCH, replace=False)
        keys = g.edges[:, 0] * size + g.edges[:, 1]
        _sharded_gate(np.unique(keys).size == len(keys),
                      f"n={size}: the graph has duplicate edges")
        np.save(f"{out_dir}/edges{size}.npy", g.edges.astype(np.int32))
        np.save(f"{out_dir}/weights{size}.npy", w)
        np.save(f"{out_dir}/sources{size}.npy", src)
    np.save(f"{out_dir}/nat_x.npy",
            rng.random(min(SHARDED_SIZES)).astype(np.float32))
    return time.perf_counter() - t0


def _sharded_load(out_dir):
    """``({size: (edges, weights, sources)}, x)`` as
    :func:`_sharded_generate` saved them."""
    import numpy as np
    graphs = {size: tuple(np.load(f"{out_dir}/{k}{size}.npy")
                          for k in ("edges", "weights", "sources"))
              for size in SHARDED_SIZES}
    return graphs, np.load(f"{out_dir}/nat_x.npy")


def sharded_relation(edges, w, n, semiring, dev):
    """``Graph.sparse_adjacency(semiring=...)`` of a graph whose directed
    edges are distinct (checked where it was made), built without its
    host ⊕-coalescing sort (45 s at 16 M edges): with no duplicate and no
    0̄ value, ``from_coo`` keeps the input order, which is what
    ``from_buffers`` adopts."""
    import numpy as np
    from repro_torch.sparse.coo import SparseRelation
    if semiring == "bool":
        vals = np.ones(len(edges), bool)
    else:
        vals = np.ones(len(edges), np.float32) if w is None else \
            np.asarray(w, np.float32)
    return SparseRelation.from_buffers(edges, vals, len(edges), (n, n),
                                       semiring, device=dev)


def sharded_init(n, sources, semiring, dev):
    import numpy as np
    import torch
    if semiring == "bool":
        init = np.zeros((len(sources), n), bool)
        init[np.arange(len(sources)), sources] = True
    else:
        init = np.full((len(sources), n), np.inf, np.float32)
        init[np.arange(len(sources)), sources] = 0.0
    return torch.from_numpy(init).to(dev)


def _sharded_run(es, init, mesh, **kw):
    """One stats run with its B3 launches attributed: ``runs`` once a
    dense round (the local derive), ``scatter`` once a sparse one (the
    expansion's ⊕), nothing else."""
    from repro_torch.distributed import datalog as dd
    p0 = _b3_now()
    y, it, rounds = dd.sharded_seminaive_fixpoint_stats(es, init, mesh=mesh,
                                                        **kw)
    paths = _b3_delta(p0)
    rounds = rounds.tolist()
    _sharded_gate(paths == {"runs": rounds[-1],
                            "scatter": sum(rounds[:-1])},
                  f"B3 launched {paths} for rounds {rounds}")
    return y, it, rounds


def _trials(fn):
    """A first run, then ``SHARDED_TRIALS`` timed: ms each."""
    wall(fn)
    return [wall(fn)[1] for _ in range(SHARDED_TRIALS)]


def _spread(ms):
    return dict(ms=_median(ms), min_ms=min(ms), max_ms=max(ms), all_ms=ms)


def _sharded_programs(semiring, rel, source, dev):
    """The benchmark's planner workload: BM over the stored 𝔹 adjacency,
    SSSP over the weighted operator through ``edges=``."""
    import torch
    from repro_torch.core import engine
    from repro_torch.datalog import programs
    n = rel.shape[0]
    if semiring == "bool":
        b = programs.bm(a=int(source))
        return b.optimized, engine.Database(
            b.original.schema, {"id": n},
            {"E": rel, "V": torch.ones(n, dtype=torch.bool, device=dev)},
            dev), {}
    b = programs.sssp(a=int(source), wmax=256, dmax=64)
    return b.optimized, engine.Database(
        b.original.schema, {"id": n, "w": 256, "d": 64}, {}, dev), \
        {"edges": rel}


def phase_sharded(dev, data):
    """Graph-axis sharded fixpoints on the card, the twin of
    ``benchmarks/sharded_scaling.py`` at its defaults: D = 1 on a
    one-rank NCCL mesh (timed against ``sparse_jit`` and the planner's
    pick), D = 2 as two ranks on the one card through gloo (exactness,
    every tier, graph-sharded serving), the ℕ∞ probe, and B3 at the
    phase's shapes.  The graphs go through files in a temporary
    directory, which the D = 2 ranks read too."""
    import tempfile
    from repro_torch.launch.mesh import make_graph_mesh, spawn_graph_world
    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    gen_s = _sharded_generate(tmp.name)
    graphs, x_nat = _sharded_load(tmp.name)
    laps = {"graphs": time.perf_counter() - t0}
    log(f"sharded graphs: "
        f"{', '.join(f'{s}: {len(g[0])} edges' for s, g in graphs.items())}"
        f" ({gen_s:.1f} s)")
    mesh = make_graph_mesh(1, device=dev)
    out = {"generate_s": gen_s, "mesh": repr(mesh), "d1": {},
           "power": nvidia_smi(), "laps": laps}
    keep = {}

    def lap(name, t):
        laps[name] = time.perf_counter() - t
        return time.perf_counter()
    t = time.perf_counter()
    with Counted() as c:
        for size in SHARDED_SIZES:
            for sem in ("bool", "trop"):
                out["d1"][f"{sem}/n{size}"] = _sharded_d1_row(
                    dev, mesh, graphs[size], size, sem, keep)
        out["nat_probe"] = _sharded_nat_probe(dev, mesh, graphs, x_nat)
    out["launches"] = c.counts
    out["b3_paths"] = c.b3_paths
    log(f"sharded launches {c.counts}; B3 paths {c.b3_paths}")
    _sharded_gate({k for k, v in c.counts.items() if v}
                  <= {"coo_spmm", "coo_segment"} and c.counts["coo_segment"],
                  f"launched {c.counts}: B3 (and B1 for the pick) only")
    t = lap("d1", t)
    out["scipy"] = _sharded_scipy(graphs, keep)
    t = lap("scipy", t)
    out["b3_checks"] = _sharded_b3_checks(dev, mesh, keep)
    t = lap("b3_checks", t)
    # the profile phase's cells: a device-bound and a host-bound call
    for (_, size, sem), (es, init) in ((k, v) for k, v in keep.items()
                                       if k[0] == "profile"):
        data.setdefault("warm", {})[f"sharded_d1_{sem}_n{size}"] = (
            lambda es=es, init=init: _sharded_run(es, init, mesh))
    with tmp:
        _sharded_serve_inputs(tmp.name)
        ranks = spawn_graph_world(_sharded_rank, 2, tmp.name, device=dev)
        t = lap("d2_world", t)
        single = _sharded_serve(dev, tmp.name, None)
    out["d2"] = _sharded_d2_check(ranks, keep, single)
    lap("d2_check", t)
    out["seconds"] = time.perf_counter() - t0
    log(f"sharded phase: {out['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in laps.items()) + ")")
    return out


def _sharded_d1_row(dev, mesh, graph, size, sem, keep):
    """One (size, semiring) cell at D = 1: the sharded fixpoint against
    single-device ``sparse_jit`` and the planner's throughput pick, each
    a first run and three timed; exactness under both exchanges; the
    planner on the one-rank mesh and its forced plan; the int-D = 8
    pick."""
    from repro_torch.core import planner
    from repro_torch.distributed import datalog as dd
    from repro_torch.sparse import fixpoint as fx
    edges, w, sources = graph
    rel = sharded_relation(edges, w, size, sem, dev)
    init = sharded_init(size, sources, sem, dev)
    (es, shard_ms) = wall(lambda: dd.shard_relation(rel, mesh))
    y0, it0 = fx.fixpoint(rel, init, mode="jit")
    y, it, rounds = _sharded_run(es, init, mesh)
    _sharded_gate(torch_equal(y, y0) and torch_equal(it, it0),
                  f"{sem}/n{size}: D=1 differs from sparse_jit")
    yd, itd, rounds_d = _sharded_run(es, init, mesh, exchange="dense")
    _sharded_gate(torch_equal(yd, y0) and torch_equal(itd, it0),
                  f"{sem}/n{size}: exchange='dense' differs")
    row = dict(n=size, nnz=int(rel.nnz), iters=int(it.max()),
               rounds=rounds, dense_rounds=rounds_d, shard_ms=shard_ms,
               exchange=dd.exchange_byte_report(es, rounds,
                                                batch=SHARDED_BATCH))
    times = {"sharded": _trials(lambda: _sharded_run(es, init, mesh)),
             "sparse_jit": _trials(lambda: fx.fixpoint(rel, init,
                                                       mode="jit"))}
    prog, db, kw = _sharded_programs(sem, rel, sources[0], dev)
    plan0 = planner.plan_program(prog, db, objective="throughput", **kw)
    pick = plan0.strata[0].runner
    if pick != "sparse_jit":
        run0 = planner.compile_batched(plan0)
        op0 = planner.materialize_edges(plan0, db)
        yp, itp = run0(op0, init)
        _sharded_gate(torch_equal(yp, y0) and torch_equal(itp, it0),
                      f"{sem}/n{size}: the pick {pick} differs")
        times[pick] = _trials(lambda: run0(op0, init))
    row["pick"] = pick
    row["times"] = {k: _spread(v) for k, v in times.items()}
    row["ratio_vs_jit"] = row["times"]["sharded"]["ms"] / \
        row["times"]["sparse_jit"]["ms"]
    row["ratio_vs_pick"] = row["times"]["sharded"]["ms"] / \
        row["times"][pick]["ms"]
    row["per_round_ms"] = {k: v["ms"] / max(1, row["iters"])
                           for k, v in row["times"].items()}
    m1 = planner.plan_program(prog, db, objective="throughput", mesh=mesh,
                              **kw)
    why = m1.strata[0].rejected.get("sparse_sharded", "")
    _sharded_gate("single device" in why,
                  f"{sem}/n{size}: a one-rank mesh was not rejected: {why}")
    forced = planner.plan_program(prog, db, objective="throughput",
                                  mode="sparse_sharded", mesh=mesh, **kw)
    yf, itf = planner.compile_batched(forced)(es, init)
    _sharded_gate(torch_equal(yf, y0) and torch_equal(itf, it0),
                  f"{sem}/n{size}: the forced plan differs")
    m8 = planner.plan_program(prog, db, objective="throughput", mesh=8,
                              **kw)
    row["pick_d8"] = m8.strata[0].runner
    row["pick_d8_partition"] = m8.strata[0].partition
    row["pick_d8_rejected"] = m8.strata[0].rejected.get("sparse_sharded")
    t = row["times"]
    log(f"sharded D=1 {sem}/n{size}: {row['iters']} rounds {rounds} "
        f"(dense {rounds_d}); sharded {t['sharded']['ms']:.2f} "
        f"[{t['sharded']['min_ms']:.2f}–{t['sharded']['max_ms']:.2f}] ms, "
        f"sparse_jit {t['sparse_jit']['ms']:.2f} "
        f"[{t['sparse_jit']['min_ms']:.2f}–{t['sparse_jit']['max_ms']:.2f}]"
        f", pick {pick} {t[pick]['ms']:.2f} ms; ×{row['ratio_vs_jit']:.2f} "
        f"jit, ×{row['ratio_vs_pick']:.2f} pick; bytes/iter "
        f"{row['exchange']['bytes_per_iter']:.0f} vs dense "
        f"{row['exchange']['dense_bytes_per_iter']:.0f}; int-D=8 pick "
        f"{row['pick_d8']}")
    keep[(size, sem)] = (y0.cpu(), it0.cpu())
    if size == max(SHARDED_SIZES):
        keep[("rel", sem)] = (rel, es, init)
    if (size, sem) in ((max(SHARDED_SIZES), "trop"),
                       (min(SHARDED_SIZES), "bool")):
        keep[("profile", size, sem)] = (es, init)
    return row


def torch_equal(a, b):
    import torch
    if not isinstance(a, torch.Tensor):
        return a == b
    return bool(torch.equal(a, b.to(a.device)))


def _sharded_nat_probe(dev, mesh, graphs, x):
    """ℕ∞ has no ⊖: the sharded contraction against ``contract.vspm`` on
    the small graph, within the benchmark's tolerance."""
    import torch
    from repro_torch.distributed import datalog as dd
    from repro_torch.sparse import contract
    size = min(SHARDED_SIZES)
    reln = sharded_relation(graphs[size][0], None, size, "nat", dev)
    xt = torch.from_numpy(x).to(dev)
    want = contract.vspm(xt, reln)
    got = dd.sharded_contract(reln, xt, mesh=mesh)
    ok = torch.allclose(got, want, **SHARDED_NAT_TOL)
    _sharded_gate(ok, "nat probe: sharded_contract differs from vspm")
    err = float((got - want).abs().max())
    log(f"sharded nat probe n{size}: max|err| {err:.3g}")
    return dict(n=size, max_abs_err=err)


def _sharded_scipy(graphs, keep):
    """At the large size, row 0 of each answer against scipy: BFS
    reachability (𝔹) and Dijkstra (trop)."""
    import numpy as np
    from scipy import sparse
    from scipy.sparse import csgraph
    size = max(SHARDED_SIZES)
    edges, w, sources = graphs[size]
    s0 = int(sources[0])
    csr = csr_host(size, edges)
    reach = bfs_reach(csr, s0)
    _sharded_gate(np.array_equal(keep[(size, "bool")][0][0].numpy(), reach),
                  "BFS row 0 differs")
    wcsr = sparse.csr_matrix((w.astype(np.float64),
                              (edges[:, 0], edges[:, 1])), shape=(size, size))
    dist = csgraph.dijkstra(wcsr, indices=s0).astype(np.float32)
    _sharded_gate(np.array_equal(keep[(size, "trop")][0][0].numpy(), dist),
                  "Dijkstra row 0 differs")
    log(f"sharded n{size}: row 0 equals scipy BFS ({int(reach.sum())} "
        f"reached) and Dijkstra")
    return dict(reached=int(reach.sum()),
                max_dist=float(dist[np.isfinite(dist)].max()))


def _sharded_b3_checks(dev, mesh, keep):
    """B3 at the phase's shapes, outside the counted and timed runs:
    ``runs`` on a local derive's payload (the large graph, trop, B = 8,
    the Δ of the round with the most live entries) and ``scatter`` on the
    largest expansion the D = 1 runs hand it (recorded through the
    loop's observer).  Exact against the plain versions, timed beside
    the byte bound and ``scatter_reduce_``."""
    import torch
    from repro_torch.core import semiring as sr_mod
    from repro_torch.distributed import datalog as dd
    from repro_torch.kernels import coo_segment, ref
    from repro_torch.sparse import fixpoint as fx
    rel, es, init = keep[("rel", "trop")]
    st = fx.FixpointState.cold(rel, init)
    best = (0, None)
    while not st.converged:
        st = fx.fixpoint(rel, state=st, budget=1, mode="jit")
        nnz = st.frontier_nnz()
        if nnz > best[0]:
            best = (nnz, st.delta.t().contiguous())
    part = dd._local_shard(es, mesh.rank, dev)
    sr = sr_mod.get("trop")
    vals = sr.mul(part.w[:, None], best[1].index_select(0, part.src))
    out = {"runs": _b3_check_one("local derive", sr, vals, part.dst,
                                 es.row_block, part.plan)}
    out["runs"]["live_entries"] = best[0]
    largest = {"live": -1}

    def observe(tier, payload):
        if payload is None:
            return
        live = int((payload[1] < es.row_block).sum())
        if live > largest["live"]:
            largest.update(live=live, tier=tier, vals=payload[0].clone(),
                           ids=payload[1].clone(), nb=es.row_block, sem=sem)
    for sem in ("bool", "trop"):
        r, e, i = keep[("rel", sem)]
        dd.sharded_seminaive_fixpoint_stats(e, i, mesh=mesh,
                                            observer=observe)
    _sharded_gate(largest["live"] > 0, "no sparse round recorded")
    out["scatter"] = _b3_check_one(
        "expansion", sr_mod.get(largest["sem"]), largest["vals"],
        largest["ids"], largest["nb"], None)
    out["scatter"].update(live_entries=largest["live"],
                          tier=largest["tier"])
    return out


def _b3_check_one(what, sr, vals, ids, n, plan):
    import torch
    from repro_torch.core import semiring as sr_mod
    from repro_torch.kernels import coo_segment, ref
    launch = coo_segment.segment_reduce_cuda
    ids_in = ids if plan is None else ids.index_select(0, plan.order)
    args = (sr.name, vals, ids, n) if plan is None else \
        (sr.name, vals, ids, n, plan)
    want = ref.segment_reduce_ref(sr, vals, ids_in, n)
    err = _check(f"sharded {what}", "coo_segment", launch(*args), want)
    m, lanes = int(vals.shape[0]), int(vals.shape[1])
    row = lanes * vals.element_size()
    nbytes = (m * row + 8 * plan.items.n_items + n * row) if plan \
        else (m * (row + 4) + n * row)
    bound, by_what = _bound(nbytes)
    lib_vals = vals.to(torch.uint8) if sr.name == "bool" else vals
    index = ids_in.long()[:, None].expand(m, lanes)
    index = torch.where(index < n, index, n)

    def library():
        base = torch.full((n + 1, lanes), 0 if sr.name == "bool" else
                          sr.zero, dtype=lib_vals.dtype, device=vals.device)
        return base.scatter_reduce_(0, index, lib_vals,
                                    sr_mod.SCATTER_REDUCE[sr.name])[:n]
    if max_abs_err(library(), want) != 0.0:
        raise AssertionError(f"sharded {what}: scatter_reduce_ yardstick "
                             f"disagrees")
    res = dict(path="scatter" if plan is None else "runs",
               semiring=sr.name, m=m, n=n, lanes=lanes, max_abs_err=err,
               ms=time_ms(lambda: launch(*args), 20, hide_host=True),
               plain_ms=time_ms(lambda: ref.segment_reduce_ref(
                   sr, vals, ids_in, n), 3),
               library_ms=time_ms(library, 20, hide_host=True),
               bound_ms=bound, bound_by=by_what, bytes=nbytes)
    log(f"sharded B3 {what}: {res['path']} {sr.name} m={m} × {lanes} into "
        f"n={n}: {res['ms']:.4f} ms kernel, {res['plain_ms']:.4f} plain, "
        f"{res['library_ms']:.4f} scatter_reduce_, bound {bound:.4f} "
        f"({by_what}), max|err| {err}")
    return res


def _sharded_serve_inputs(tmp):
    """The serving check's graph, sources and merge, as files beside the
    graphs the ranks read."""
    import numpy as np
    from repro_torch.datalog import datasets
    n, k, m = SHARDED_SERVE
    g = datasets.powerlaw(n, 4, seed=1)
    rng = np.random.default_rng(SHARDED_SEED)
    have = set((g.edges[:, 0] * n + g.edges[:, 1]).tolist())
    new = []
    while len(new) < m:
        a, b = (int(v) for v in rng.integers(0, n, 2))
        if a != b and a * n + b not in have:
            have.add(a * n + b)
            new.append((a, b))
    np.save(f"{tmp}/serve_edges.npy", g.edges.astype(np.int32))
    np.save(f"{tmp}/serve_sources.npy",
            rng.choice(n, size=k, replace=False))
    np.save(f"{tmp}/serve_merge.npy", np.asarray(new, np.int64))


def _sharded_serve(dev, tmp, mesh):
    """``DatalogServer`` over the serve graph: the sources, a merge of new
    edges, the same sources again (warm answers repaired by the merge).
    With ``mesh`` the crossover floor and the sync toll are patched away
    (the reference test's patch), so the plan takes the mesh."""
    import numpy as np
    import torch
    from repro_torch.core import engine, planner
    from repro_torch.datalog import programs
    from repro_torch.launch.datalog_serve import DatalogServer
    from repro_torch.sparse.coo import SparseRelation
    n = SHARDED_SERVE[0]
    edges = np.load(f"{tmp}/serve_edges.npy")
    srcs = np.load(f"{tmp}/serve_sources.npy")
    merge = np.load(f"{tmp}/serve_merge.npy")
    rel = SparseRelation.from_buffers(edges, np.ones(len(edges), bool),
                                      len(edges), (n, n), "bool", device=dev)
    b = programs.bm(a=0)
    db = engine.Database(b.original.schema, {"id": n},
                         {"E": rel, "V": torch.ones(n, dtype=torch.bool,
                                                    device=dev)}, dev)
    cost = planner.SHARDED_COST
    saved = (cost.min_work_per_device, cost.sync_flops_per_device)
    if mesh is not None:
        cost.min_work_per_device = cost.sync_flops_per_device = 0.0
    try:
        srv = DatalogServer(max_batch=len(srcs), mesh=mesh)
        fam = srv.register("reach", _mk_bm, db)
        first = [srv.submit("reach", int(s)) for s in srcs]
        srv.run_until_idle()
        up = srv.submit_update("reach", merge)
        again = [srv.submit("reach", int(s)) for s in srcs]
        srv.run_until_idle()
    finally:
        cost.min_work_per_device, cost.sync_flops_per_device = saved
    reqs = first + again
    return dict(runner=fam.plan.strata[0].runner,
                sharded=fam.sharded is not None,
                results=torch.stack([r.result for r in reqs]).cpu(),
                iters=[r.iters for r in reqs],
                errors=[r.error for r in reqs], applied=up.applied,
                repaired=srv.stats["answers_repaired"])


def _sharded_rank(mesh, tmp):
    """One rank of the two-rank world on the card: gloo's CUDA
    collectives checked first, then each (size, semiring) of the D = 2
    sizes (auto and dense exchange, three timed runs), the shrunk ladder
    on the small graph, and the graph-sharded server."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import datalog as dd
    dev = mesh.device
    probe = torch.full((3,), mesh.rank, dtype=torch.int32, device=dev)
    parts = [torch.empty_like(probe) for _ in range(mesh.d)]
    dist.all_gather(parts, probe)
    top = probe.clone()
    dist.all_reduce(top, op=dist.ReduceOp.MAX)
    _sharded_gate(torch.cat(parts).tolist() == [0, 0, 0, 1, 1, 1]
                  and top.tolist() == [1, 1, 1],
                  "gloo's all_gather/all_reduce on CUDA tensors")
    out = {"cells": {}}
    for size in SHARDED_D2_SIZES:
        edges = np.load(f"{tmp}/edges{size}.npy")
        w = np.load(f"{tmp}/weights{size}.npy")
        srcs = np.load(f"{tmp}/sources{size}.npy")
        for sem in ("bool", "trop"):
            rel = sharded_relation(edges, w, size, sem, dev)
            init = sharded_init(size, srcs, sem, dev)
            es = dd.shard_relation(rel, mesh)
            y, it, rounds = _sharded_run(es, init, mesh)
            yd, itd, rounds_d = _sharded_run(es, init, mesh,
                                             exchange="dense")
            _sharded_gate(torch.equal(y, yd) and torch.equal(it, itd),
                          f"D=2 {sem}/n{size}: auto differs from dense")
            ms = [wall(lambda: _sharded_run(es, init, mesh))[1]
                  for _ in range(SHARDED_TRIALS)]
            out["cells"][f"{sem}/n{size}"] = dict(
                y=y.cpu(), it=it.cpu(), rounds=rounds,
                dense_rounds=rounds_d, times=_spread(ms),
                capacity=es.capacity, nnz=list(es.nnz),
                exchange=dd.exchange_byte_report(es, rounds,
                                                 batch=SHARDED_BATCH))
            del rel, es, y, yd
    size = min(SHARDED_SIZES)
    edges = np.load(f"{tmp}/edges{size}.npy")
    rel = sharded_relation(edges, None, size, "bool", dev)
    init = sharded_init(size, np.load(f"{tmp}/sources{size}.npy"), "bool",
                        dev)
    y, it, rounds = _sharded_run(dd.shard_relation(rel, mesh), init, mesh,
                                 exchange_caps=SHARDED_SMALL_CAPS)
    out["small_caps"] = dict(y=y.cpu(), it=it.cpu(), rounds=rounds)
    out["serve"] = _sharded_serve(dev, tmp, mesh)
    return out


def _sharded_d2_check(ranks, keep, single):
    """The two-rank world against the single-device answers: every rank
    returned the same answers and counts, equal to ``sparse_jit``'s; each
    tier and the dense fallback ran; the graph-sharded server equals a
    single-device one."""
    import torch
    res = {"cells": {}}
    taken = [0, 0, 0]
    for key, cell in ranks[0]["cells"].items():
        sem, size = key.split("/n")
        y0, it0 = keep[(int(size), sem)]
        for r in ranks:
            c = r["cells"][key]
            _sharded_gate(torch.equal(c["y"], y0) and torch.equal(c["it"],
                                                                  it0),
                          f"D=2 {key}: a rank's answer differs from "
                          f"sparse_jit")
            _sharded_gate(c["rounds"] == cell["rounds"],
                          f"D=2 {key}: ranks counted different rounds")
        taken = [a + b for a, b in zip(taken, cell["rounds"])]
        res["cells"][key] = {k: cell[k] for k in (
            "rounds", "dense_rounds", "times", "capacity", "nnz",
            "exchange")}
        t = cell["times"]
        log(f"sharded D=2 (two ranks on one card through gloo) {key}: "
            f"rounds {cell['rounds']} (dense {cell['dense_rounds']}), "
            f"{t['ms']:.1f} [{t['min_ms']:.1f}–{t['max_ms']:.1f}] ms, "
            f"nnz/shard {cell['nnz']} cap {cell['capacity']}")
    small = ranks[0]["small_caps"]
    y0, it0 = keep[(min(SHARDED_SIZES), "bool")]
    _sharded_gate(torch.equal(small["y"], y0) and torch.equal(small["it"],
                                                              it0),
                  "D=2 shrunk ladder differs from sparse_jit")
    res["defaults_taken"] = taken
    res["small_caps_rounds"] = small["rounds"]
    both = [a + b for a, b in zip(taken, small["rounds"])]
    _sharded_gate(all(v > 0 for v in both),
                  f"D=2: a tier never ran (defaults {taken}, shrunk "
                  f"{small['rounds']})")
    for r in ranks:
        s = r["serve"]
        _sharded_gate(s["runner"] == "sparse_sharded" and s["sharded"],
                      f"D=2 serve: plan took {s['runner']}")
        _sharded_gate(s["applied"] and s["errors"] == [None] * len(
            s["errors"]) and s["repaired"] == SHARDED_SERVE[1],
                      f"D=2 serve: applied {s['applied']}, errors "
                      f"{set(s['errors'])}, repaired {s['repaired']}")
        _sharded_gate(torch.equal(s["results"], single["results"])
                      and s["iters"] == single["iters"],
                      "D=2 serve: answers differ from a single-device "
                      "server's")
    res["serve"] = dict(requests=len(single["iters"]),
                        repaired=ranks[0]["serve"]["repaired"],
                        single_runner=single["runner"])
    log(f"sharded D=2: tiers taken by the defaults {taken}, by the shrunk "
        f"ladder {small['rounds']}; graph-sharded server equals a "
        f"{single['runner']} server on {len(single['iters'])} answers, "
        f"{res['serve']['repaired']} repaired across the merge")
    return res


# --------------------------------------------------------------------------
# phase 14: the data axis — query-batch serving on a data mesh,
# data-parallel training (ZeRO-3 on "data"), sharded checkpoints, GPipe
# and compressed gradient reduction
# --------------------------------------------------------------------------

#: the serve phase's graphs, served closed loop at this batch, timed
#: this many times after a warm-up
MESH_SERVE_BATCH, MESH_SERVE_REPS = 64, 5
#: xLSTM-125M data parallel at the train phase's width and batch: steps
#: at W = 1 (against the unsharded run) and at W = 2 (against one rank
#: fed the two ranks' batches concatenated)
MESH_W1_STEPS, MESH_W2_STEPS = 10, 5
#: Zamba2's smoke config at W = 2: (arch, global batch, seq, steps)
MESH_ZAMBA = ("zamba2-2.7b", 8, 128, 3)
#: Zamba2-2.7B at its published widths at W = 1 on one-rank NCCL against
#: the unsharded run: (arch, batch, seq, steps, remat)
MESH_ZAMBA_W1 = ("zamba2-2.7b", 8, 1024, 3, "full")
#: the most a one-rank sharded step's peak may exceed the unsharded
#: step's: the leaves outside the stacks gathered (Zamba2-2.7B's
#: embedding, head and shared block, ≈1.1 GB) and one layer, with room
#: for the allocator's rounding
MESH_PEAK_SLACK_GB = 3.0
#: the most xLSTM-125M's one-rank sharded step's peak may exceed the
#: unsharded step's past its gathered bound (the embedding and one
#: layer, 0.18 GB): the allocator's rounding and the one-rank
#: reduce-scatters' copies; the stack held gathered (+0.26 GB) fails it
MESH_W1_PEAK_ALLOWANCE_GB = 0.1
#: sharded AdamW steps before the checkpoint is saved at W = 2
MESH_CKPT_STEPS = 2
#: GPipe over xLSTM-125M's 12 layers: stages, micro-batches, rows each
MESH_PIPE = (2, 4, 2)
#: W = 2 against one rank on the concatenated batches: losses within
#: this relative difference; the pipeline within it times max |y|
MESH_LOSS_RTOL = MESH_PIPE_TOL = 1e-5
#: AdamW's two f32 moments of xLSTM-125M's 109,584,384 parameters
MESH_MOMENTS_BYTES = 876_675_072
#: bf16's unit roundoff (8 significant bits)
BF16_U = 2.0 ** -8


def _mesh_gate(ok, what):
    if not ok:
        raise AssertionError(f"mesh: {what}")


def phase_mesh(dev):
    """The data axis on the card (``launch.mesh``, ``launch.rules``,
    ``distributed.sharding``, ``collectives``, ``pipeline``): the serve
    phase's BM and SSSP graphs served closed loop at B = 64 on a
    one-rank NCCL ``"data"`` mesh against the one-device server (timed),
    xLSTM-125M and Zamba2-2.7B trained data parallel on a one-rank NCCL
    mesh against the unsharded ``train`` (bit for bit, timed, the
    gathered bytes and Zamba2's peak gated), and a world of two gloo
    ranks on the card (``spawn_world``) that serves on a two-rank data
    mesh, trains xLSTM-125M and Zamba2's smoke config, saves and
    restores a sharded checkpoint, runs GPipe and the compressed
    reductions (:func:`_mesh_rank`); the two ranks' results are held
    against one rank here."""
    import tempfile
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_datalog_mesh, spawn_world
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = dict.fromkeys(ops.launch_counts(), 0)
    out = {"power": nvidia_smi(), "laps": {}}

    def lap(name, t):
        out["laps"][name] = time.perf_counter() - t
        return time.perf_counter()

    def count(c):
        for k, v in c.counts.items():
            launches[k] += v
    g_bm, g_ss = _serve_graphs()
    srcs = _mesh_sources(g_bm, g_ss)
    t = time.perf_counter()
    mesh1 = make_datalog_mesh(1, device=dev)
    with Counted() as c:
        single, d1 = _mesh_serve(_mesh_servers(dev, g_bm, g_ss,
                                               (None, mesh1)), srcs)
    count(c)
    _mesh_serve_gate("D=1", d1, single, MESH_SERVE_BATCH)
    _mesh_gate(c.counts["coo_spmm"] > 0, f"D=1 serve: B1 {c.counts}")
    out["serve_d1"] = {"mesh": repr(mesh1), "one_device": single["timing"],
                       "d1": d1["timing"], "b1_launches": c.counts[
                           "coo_spmm"]}
    for fam in ("reach", "sssp"):
        a, b = single["timing"][fam], d1["timing"][fam]
        log(f"mesh serve {fam} B={MESH_SERVE_BATCH}: one device "
            f"{a['ms']:.2f} [{a['min_ms']:.2f}–{a['max_ms']:.2f}] ms "
            f"({a['qps']:.0f} qps), D=1 NCCL data mesh {b['ms']:.2f} "
            f"[{b['min_ms']:.2f}–{b['max_ms']:.2f}] ms ({b['qps']:.0f} "
            f"qps), median of {MESH_SERVE_REPS} interleaved; answers, "
            f"counts and stats equal")
    t = lap("serve_d1", t)
    _free_cuda()
    with Counted() as c:
        out["train_w1"] = _mesh_train_w1(dev)
    count(c)
    t = lap("train_w1", t)
    _free_cuda()
    with Counted() as c:
        out["zamba_w1"] = _mesh_zamba_w1(dev)
    count(c)
    t = lap("zamba_w1", t)
    _free_cuda()
    ref2 = _mesh_concat_run(dev, TRAIN_ARCH, False, TRAIN_BATCH, TRAIN_SEQ,
                            MESH_W2_STEPS)
    zref = _mesh_concat_run(dev, MESH_ZAMBA[0], True, *MESH_ZAMBA[1:])
    _free_cuda()
    t = lap("one_rank_references", t)
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_world(_mesh_rank, 2, tmp, srcs, device=dev)
        t = lap("w2_world", t)
        out["ckpt_w1"] = _mesh_ckpt_w1(tmp, ranks)
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] += v
    out["w2"] = _mesh_w2_check(ranks, single, ref2, zref)
    out["ckpt_w1"]["w2_save_s"] = [r["ckpt"]["save_s"] for r in ranks]
    lap("w2_check", t)
    out["launches"] = launches
    _mesh_gate(all(launches[k] > 0 for k in (
        "coo_spmm", "ssm_scan", "flash_attention",
        "flash_attention_backward")),
               f"launches {launches}: B1, B4, B5 and B5's backward must run")
    out["seconds"] = time.perf_counter() - t0
    log(f"mesh launches {launches} ({out['seconds']:.1f} s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in out["laps"].items()) + ")")
    return out


def _mesh_sources(g_bm, g_ss):
    import numpy as np
    rng = np.random.default_rng(SERVE_SEED + 11)
    return {"reach": [int(s) for s in rng.integers(0, g_bm.n,
                                                   MESH_SERVE_BATCH)],
            "sssp": [int(s) for s in rng.integers(0, g_ss.n,
                                                  MESH_SERVE_BATCH)]}


def _mesh_servers(dev, g_bm, g_ss, meshes):
    """One ``DatalogServer(max_batch=64, warm_answers=0, mesh=m)`` for
    each of ``meshes`` (None: one device), each with the serve phase's
    BM and SSSP families registered."""
    from repro_torch.launch.datalog_serve import DatalogServer
    out = []
    for mesh in meshes:
        server = DatalogServer(max_batch=MESH_SERVE_BATCH, warm_answers=0,
                               mesh=mesh)
        server.register("reach", _mk_bm, _serve_bm_db(dev, g_bm))
        db_ss, ss_rel = _serve_ss_db(dev, g_ss)
        server.register("sssp", _mk_sssp, db_ss, edges=ss_rel)
        out.append(server)
    return out


def _mesh_serve(servers, srcs):
    """Each family's 64 sources served closed loop by every server in
    turn, once to warm up and ``MESH_SERVE_REPS`` times timed
    (interleaved, so the servers share the machine's drift): for each
    server the last answers and counts, the counters, the rows each
    batched fixpoint was compiled for, and ms and qps (median, range)."""
    import numpy as np
    import torch
    times = [{fam: [] for fam in srcs} for _ in servers]
    last = [{} for _ in servers]
    for rep in range(1 + MESH_SERVE_REPS):
        for fam, sources in srcs.items():
            for i, server in enumerate(servers):
                reqs = [server.submit(fam, s) for s in sources]
                _, ms = wall(server.run_until_idle)
                _mesh_gate(all(r.error is None for r in reqs),
                           f"serve {fam}: {[r.error for r in reqs if r.error]}")
                if rep:
                    times[i][fam].append(ms)
                last[i][fam] = reqs
    out = []
    for i, server in enumerate(servers):
        timing = {fam: {"ms": float(np.median(ts)), "min_ms": min(ts),
                        "max_ms": max(ts),
                        "qps": len(srcs[fam]) / float(np.median(ts)) * 1e3,
                        "rounds_max": max(r.iters for r in last[i][fam])}
                  for fam, ts in times[i].items()}
        out.append({"answers": {fam: (torch.stack([r.result for r in reqs])
                                      .cpu(), [r.iters for r in reqs])
                                for fam, reqs in last[i].items()},
                    "stats": dict(server.stats), "timing": timing,
                    "rows": [key[1] for key in server._compiled.keys()]})
    return out


def _mesh_serve_gate(what, got, want, rows):
    import torch
    for fam, (y, it) in want["answers"].items():
        gy, git = got["answers"][fam]
        _mesh_gate(torch.equal(gy, y) and git == it,
                   f"{what} serve {fam}: answers or counts differ from the "
                   f"one-device server's")
    _mesh_gate(got["stats"] == want["stats"],
               f"{what} serve: stats {got['stats']} != {want['stats']}")
    _mesh_gate(got["rows"] == [rows] * len(got["rows"]) and got["rows"],
               f"{what} serve: fixpoints compiled for rows {got['rows']}, "
               f"not {rows}")


def _mesh_train_w1(dev):
    """xLSTM-125M at full size, ``MESH_W1_STEPS`` steps unsharded and on
    a one-rank NCCL host mesh: losses and final parameters bit for bit;
    the gathered bytes within their bound, and the mesh run's peak at
    most the unsharded one's plus that bound and
    ``MESH_W1_PEAK_ALLOWANCE_GB`` (the stack kept gathered through a
    ``remat="none"`` step would fail it; each run's parameters wait on
    the host, so neither peak holds the other run's); ms a step (median
    of the warm steps), peak memory and the collective bytes a step of
    the mesh run."""
    import numpy as np
    import torch
    from repro_torch.distributed import collectives
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optimizer.optimizers import tree_leaves, tree_like
    runs = {}
    for name in ("unsharded", "mesh"):
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
        mesh = make_host_mesh(device=dev) if name == "mesh" else None
        hist = []
        collectives.reset_stats()
        params, losses = train_mod.train(
            TRAIN_ARCH, smoke=False, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
            steps=MESH_W1_STEPS, device=dev, history=hist, log_every=100,
            mesh=mesh)
        coll = collectives.reset_stats()
        runs[name] = dict(
            params=tree_like(params, [x.detach().cpu()
                                      for x in tree_leaves(params)]),
            losses=losses, coll=coll,
            ms=float(np.median([h["ms"] for h in hist[TRAIN_WARM_FROM:]])),
            peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del params
    a, b = runs["unsharded"], runs["mesh"]
    _mesh_gate(b["coll"]["calls"] > 0 and b["coll"]["host_staged_bytes"] == 0,
               f"W=1 on NCCL: collectives {b['coll']} (none through the "
               f"host)")
    gathered = b["coll"]["gathered_peak_bytes"]
    from repro_torch import configs
    bound, whole = _mesh_gathered_bound(configs.get(TRAIN_ARCH), a["params"],
                                        make_host_mesh(device=dev))
    _mesh_gate(0 < gathered <= bound < whole,
               f"W=1: {gathered} B of gathered parameters alive at once, "
               f"bound {bound} (the whole tree {whole})")
    slack = bound / 1e9 + MESH_W1_PEAK_ALLOWANCE_GB
    _mesh_gate(b["peak_gb"] <= a["peak_gb"] + slack,
               f"W=1: peak {b['peak_gb']:.3f} GB against unsharded "
               f"{a['peak_gb']:.3f} GB + {slack:.3f} (the gathered bound "
               f"and {MESH_W1_PEAK_ALLOWANCE_GB})")
    _mesh_gate(a["losses"] == b["losses"],
               f"W=1: losses {b['losses']} != unsharded {a['losses']}")
    _mesh_gate(all(torch.equal(x, y) for x, y in zip(
        tree_leaves(a["params"]), tree_leaves(b["params"]))),
               "W=1: final parameters differ from the unsharded run's")
    gather = _mesh_gathered_bytes(a["params"])
    per_step = (b["coll"]["bytes"] - gather) / MESH_W1_STEPS
    out = {"losses": b["losses"], "ms_unsharded": a["ms"],
           "ms_mesh": b["ms"], "peak_gb_unsharded": a["peak_gb"],
           "peak_gb_mesh": b["peak_gb"], "collectives": b["coll"],
           "collective_bytes_per_step": per_step,
           "host_staged_bytes": b["coll"]["host_staged_bytes"],
           "gathered_peak_bytes": gathered, "gathered_bound_bytes": bound,
           "whole_tree_bytes": whole}
    log(f"mesh train W=1 (one-rank NCCL mesh) {TRAIN_ARCH}: "
        f"{b['ms']:.1f} ms a step against unsharded {a['ms']:.1f} ms; "
        f"losses and parameters bit for bit; {per_step / 1e6:.1f} MB of "
        f"collectives a step, {b['coll']['host_staged_bytes']} B staged; "
        f"peak {b['peak_gb']:.2f} GB (unsharded {a['peak_gb']:.2f}); "
        f"gathered parameters {gathered / 1e9:.3f} GB alive at most "
        f"(bound {bound / 1e9:.3f}, whole tree {whole / 1e9:.3f})")
    return out


def _mesh_zamba_w1(dev):
    """Zamba2-2.7B at its published widths (``MESH_ZAMBA_W1``: B = 8 ×
    1,024, ``remat="full"``, AdamW), unsharded and on a one-rank NCCL
    host mesh, one layer gathered at a time: losses and final parameters
    bit for bit, the mesh run's peak at most the unsharded one's plus
    ``MESH_PEAK_SLACK_GB``, its gathered bytes within the bound; ms a
    step (median of steps 2 on)."""
    import numpy as np
    import torch
    from repro_torch.distributed import collectives
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch import configs
    from repro_torch.optimizer.optimizers import tree_leaves, tree_like
    arch, batch, seq, steps, remat = MESH_ZAMBA_W1
    runs = {}
    for name in ("unsharded", "mesh"):
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
        mesh = make_host_mesh(device=dev) if name == "mesh" else None
        hist = []
        collectives.reset_stats()
        params, losses = train_mod.train(
            arch, smoke=False, batch=batch, seq=seq, steps=steps,
            remat=remat, device=dev, history=hist, log_every=100, mesh=mesh)
        coll = collectives.reset_stats()
        runs[name] = dict(
            params=tree_like(params, [x.detach().cpu()
                                      for x in tree_leaves(params)]),
            losses=losses, coll=coll,
            ms=float(np.median([h["ms"] for h in hist[1:]])),
            peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del params
    a, b = runs["unsharded"], runs["mesh"]
    _mesh_gate(a["losses"] == b["losses"]
               and all(np.isfinite(a["losses"])),
               f"Zamba2-2.7B W=1: losses {b['losses']} != unsharded "
               f"{a['losses']}")
    _mesh_gate(all(torch.equal(x, y) for x, y in zip(
        tree_leaves(a["params"]), tree_leaves(b["params"]))),
               "Zamba2-2.7B W=1: final parameters differ from the "
               "unsharded run's")
    _mesh_gate(b["peak_gb"] <= a["peak_gb"] + MESH_PEAK_SLACK_GB,
               f"Zamba2-2.7B W=1: peak {b['peak_gb']:.2f} GB against "
               f"unsharded {a['peak_gb']:.2f} GB + {MESH_PEAK_SLACK_GB}")
    gathered = b["coll"]["gathered_peak_bytes"]
    bound, whole = _mesh_gathered_bound(configs.get(arch), a["params"],
                                        make_host_mesh(device=dev))
    _mesh_gate(b["coll"]["calls"] > 0 and 0 < gathered <= bound < whole,
               f"Zamba2-2.7B W=1: {gathered} B gathered at once, bound "
               f"{bound}, collectives {b['coll']}")
    out = {"losses": b["losses"], "ms_unsharded": a["ms"],
           "ms_mesh": b["ms"], "peak_gb_unsharded": a["peak_gb"],
           "peak_gb_mesh": b["peak_gb"], "collectives": b["coll"],
           "gathered_peak_bytes": gathered, "gathered_bound_bytes": bound,
           "whole_tree_bytes": whole,
           "shape": dict(zip(("arch", "batch", "seq", "steps", "remat"),
                             MESH_ZAMBA_W1))}
    log(f"mesh train W=1 (one-rank NCCL mesh) {arch} B={batch}×{seq} remat "
        f"{remat}: {b['ms']:.1f} ms a step against unsharded "
        f"{a['ms']:.1f} ms; losses and parameters bit for bit; peak "
        f"{b['peak_gb']:.2f} GB (unsharded {a['peak_gb']:.2f}); gathered "
        f"parameters {gathered / 1e9:.3f} GB alive at most (bound "
        f"{bound / 1e9:.3f}, whole tree {whole / 1e9:.3f})")
    return out


def _mesh_gathered_bound(cfg, params, mesh):
    """``(bound, whole)`` in bytes for the sharded step of ``cfg`` on
    ``mesh`` (``steps.layer_gatherer``'s ``bound``) from the full tree
    ``params`` on any device: its blocks are views of it."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.rules import make_rules
    from repro_torch.models import transformer as T
    from repro_torch.optimizer.optimizers import tree_at, tree_like, \
        tree_paths
    specs = sh.tree_specs(T.param_specs(cfg), params, mesh,
                          make_rules(mesh, "train"))
    blocks = tree_like(specs, [sh.take_block(tree_at(params, path), s, mesh)
                               for path, s in tree_paths(specs)])
    return steps_mod.layer_gatherer(cfg, mesh, specs).bound(blocks)


def _mesh_gathered_bytes(params):
    """The bytes of the closing all-gather of ``train`` on a data mesh:
    every leaf split over ``"data"``, whole."""
    import types
    from repro_torch import configs
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.rules import make_rules
    from repro_torch.models import transformer as T
    from repro_torch.optimizer.optimizers import tree_leaves
    m = types.SimpleNamespace(axis_names=("data", "model"),
                              shape={"data": 1, "model": 1},
                              coords={"data": 0, "model": 0})
    specs = sh.tree_specs(T.param_specs(configs.get(TRAIN_ARCH)), params, m,
                          make_rules(m, "train"))
    return sum(p.numel() * p.element_size() for p, s in zip(
        tree_leaves(params), tree_leaves(specs))
        if steps_mod.data_dim(s) is not None)


def _mesh_concat_run(dev, arch, smoke, batch, seq, steps, accum_steps=1):
    """One rank, the unsharded step (``accum_steps`` micro-batches), fed
    each step the two host streams' batches of a two-rank world
    concatenated: the losses and norms a data-parallel pair of ranks
    must reproduce (``arch``: a name or a ``ModelConfig``)."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.data import pipeline as pipe
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer as T
    from repro_torch.optimizer import OptConfig, cosine_schedule, wsd_schedule
    from repro_torch.optimizer.optimizers import tree_leaves
    cfg = (configs.get(arch, smoke=smoke) if isinstance(arch, str)
           else arch)
    sched = (wsd_schedule if cfg.schedule == "wsd" else cosine_schedule)(
        3e-4, warmup=max(steps // 20, 5), total=steps)
    step_fn, init = steps_mod.make_train_step(cfg, OptConfig(lr=sched),
                                              remat="none",
                                              accum_steps=accum_steps)
    params = T.init_params(cfg, 0, torch.float32, dev)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    state = init(params)
    dcfg = train_mod.data_config(cfg, batch=batch, seq=seq, seed=0)
    streams = [pipe.synthetic_stream(dcfg, host=r, n_hosts=2)
               for r in range(2)]
    losses, norms = [], []
    for _ in range(steps):
        parts = [next(s) for s in streams]
        b = {k: torch.from_numpy(np.concatenate([p[k] for p in parts])).to(
            dev) for k in parts[0]}
        params, state, m = step_fn(params, state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "norms": norms}


def _mesh_rank(mesh, tmp, srcs):
    """One rank of the two-rank world on the card: the data-mesh server,
    xLSTM-125M and Zamba2's smoke config data parallel, a sharded
    checkpoint saved and restored, GPipe and the compressed reductions;
    each part's launches counted in this process."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_datalog_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    out = {"launches": dict.fromkeys(ops.launch_counts(), 0)}

    def run(name, fn):
        _free_cuda()
        with Counted() as c:
            out[name] = fn()
        out[name]["launches"] = c.counts
        for k, v in c.counts.items():
            out["launches"][k] += v
    g_bm, g_ss = _serve_graphs()
    run("serve", lambda: _mesh_serve(_mesh_servers(
        dev, g_bm, g_ss, (make_datalog_mesh(device=dev),)), srcs)[0])
    del g_bm, g_ss
    run("train", lambda: _mesh_rank_train(dev, TRAIN_ARCH, False,
                                          TRAIN_BATCH, TRAIN_SEQ,
                                          MESH_W2_STEPS))
    run("zamba", lambda: _mesh_rank_train(dev, MESH_ZAMBA[0], True,
                                          *MESH_ZAMBA[1:]))
    run("ckpt", lambda: _mesh_rank_ckpt(mesh, tmp))
    run("pipeline", lambda: _mesh_rank_pipeline(dev))
    run("compressed", lambda: _mesh_rank_compressed(mesh))
    return out


def _mesh_rank_train(dev, arch, smoke, batch, seq, steps):
    """``train`` on the two-rank world: losses, norms, ms a step, peak
    memory, this rank's moment bytes (its blocks' shapes) and the
    collective and host-staged bytes a step."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.rules import make_rules
    from repro_torch.models import transformer as T
    from repro_torch.optimizer.optimizers import tree_leaves
    torch.cuda.reset_peak_memory_stats()
    collectives.reset_stats()
    hist = []
    params, losses = train_mod.train(arch, smoke=smoke, batch=batch,
                                     seq=seq, steps=steps, device=dev,
                                     history=hist, log_every=100)
    coll = collectives.reset_stats()
    peak = torch.cuda.max_memory_allocated()
    mesh = make_host_mesh(device=dev)
    specs = sh.tree_specs(T.param_specs(configs.get(arch, smoke=smoke)),
                          params, mesh, make_rules(mesh, "train"))
    moment = gather = staged = 0
    for p, s in zip(tree_leaves(params), tree_leaves(specs)):
        sls = sh.block_slices(tuple(p.shape), s, mesh)
        block = int(np.prod([x.stop - x.start for x in sls]))
        moment += 8 * block
        if steps_mod.data_dim(s) is not None:     # the closing gather
            gather += p.numel() * p.element_size()
            staged += (p.numel() + block) * p.element_size()
    ms = [h["ms"] for h in hist]
    bound, whole = _mesh_gathered_bound(configs.get(arch, smoke=smoke),
                                        params, mesh)
    return {"losses": losses, "norms": [h["grad_norm"] for h in hist],
            "ms": ms, "ms_median": float(np.median(ms[1:] or ms)),
            "peak_gb": peak / 1e9, "moment_bytes": moment,
            "gathered_peak_bytes": coll["gathered_peak_bytes"],
            "gathered_bound_bytes": bound, "whole_tree_bytes": whole,
            "collectives": coll,
            "collective_bytes_per_step": (coll["bytes"] - gather) / steps,
            "host_staged_bytes_per_step":
                (coll["host_staged_bytes"] - staged) / steps}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _sha(t) -> str:
    """A tensor's bytes, hashed (two hashes equal: the same bits)."""
    import hashlib
    import torch
    return hashlib.sha256(t.detach().contiguous().cpu().view(-1).view(
        torch.uint8).numpy().tobytes()).hexdigest()


def _mesh_rank_ckpt(mesh, tmp):
    """``MESH_CKPT_STEPS`` sharded AdamW steps of xLSTM-125M, the state
    saved as a sharded checkpoint, then restored at W = 2 into fresh
    blocks: equal to the saved state, leaf by leaf; the blocks' hashes
    go back for the W = 1 restore."""
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.data import make_train_iterator
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.rules import make_rules
    from repro_torch.models import transformer as T
    from repro_torch.optimizer import OptConfig
    from repro_torch.optimizer.optimizers import tree_leaves
    cfg = configs.get(TRAIN_ARCH)
    dev = mesh.device
    params = T.init_params(cfg, 0, torch.float32, dev)
    specs = sh.tree_specs(T.param_specs(cfg), params, mesh,
                          make_rules(mesh, "train"))
    step_fn, init = steps_mod.make_sharded_train_step(
        cfg, OptConfig(), mesh, specs, remat="none")
    blocks = steps_mod.param_blocks(params, specs, mesh)
    del params
    state = init(blocks)
    data = make_train_iterator(train_mod.data_config(
        cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0), device=dev,
        sharding=mesh)
    for _ in range(MESH_CKPT_STEPS):
        blocks, state, _ = step_fn(blocks, state, next(data))
    tree = {"params": blocks, "opt": state}
    shardings = {"params": specs,
                 "opt": steps_mod.state_specs(state, specs)}
    path = f"{tmp}/ckpt"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(path, MESH_CKPT_STEPS, tree, shardings=shardings,
                    mesh=mesh)
    save_s = time.perf_counter() - t0
    dist.barrier()          # rank 0 has renamed the checkpoint into place
    fresh = _tree_map(lambda x: torch.zeros_like(x) if isinstance(
        x, torch.Tensor) else 0, tree)
    t0 = time.perf_counter()
    load_checkpoint(path, MESH_CKPT_STEPS, fresh, shardings=shardings,
                    mesh=mesh, inplace=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    leaves = [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]
    got = [x for x in tree_leaves(fresh) if isinstance(x, torch.Tensor)]
    _mesh_gate(fresh["opt"]["step"] == MESH_CKPT_STEPS
               and all(torch.equal(a, b) for a, b in zip(got, leaves)),
               "W=2 restore differs from the saved state")
    return {"save_s": save_s, "load_s": load_s,
            "bytes": sum(x.numel() * x.element_size() for x in leaves),
            "coords": dict(mesh.coords),
            "sha": [_sha(x) for x in leaves]}


def _mesh_stage(cfg, params, x):
    """One GPipe stage of xLSTM-125M: its block of the stacked layers
    (``params["stack"]``, leading stage axis of 1) over ``x``."""
    from repro_torch.models import transformer as T
    stack = _tree_map(lambda v: v[0], params["stack"])
    return T.recurrent_stage(stack, x, cfg, int(params["first"][0, 0]))


def _mesh_rank_pipeline(dev):
    """xLSTM-125M's 12 layers as ``MESH_PIPE`` (S stages of 12 / S, M
    micro-batches), forward only, on a ``("stage",)`` mesh of the two
    ranks; each rank holds the output against the sequential stack."""
    import functools
    import torch
    from repro_torch import configs
    from repro_torch.data import pipeline as pipe
    from repro_torch.distributed.pipeline import bubble_fraction, run_pipeline
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    s_, m_, rows = MESH_PIPE
    cfg = configs.get(TRAIN_ARCH)
    stages = make_mesh((s_,), ("stage",), device=dev)
    params = T.init_params(cfg, 0, torch.float32, dev)
    per = cfg.n_layers // s_
    stage_params = {
        "stack": _tree_map(lambda v: v.reshape((s_, per) + v.shape[1:]),
                           params["stack"]),
        "first": (torch.arange(s_, device=dev) * per).reshape(s_, 1)}
    toks = next(pipe.synthetic_stream(train_mod.data_config(
        cfg, batch=m_ * rows, seq=TRAIN_SEQ, seed=0)))["tokens"]
    with torch.no_grad():
        x = params["embed"][torch.from_numpy(toks).to(dev).long()]
    x = x.reshape(m_, rows, TRAIN_SEQ, cfg.d_model)
    fn = functools.partial(_mesh_stage, cfg)
    y, ms = wall(lambda: run_pipeline(stages, fn, stage_params, x,
                                      n_stages=s_, n_micro=m_))
    y, ms = wall(lambda: run_pipeline(stages, fn, stage_params, x,
                                      n_stages=s_, n_micro=m_))
    with torch.no_grad():
        ref, seq_ms = wall(lambda: torch.stack([
            T.recurrent_stage(params["stack"], x[i], cfg, 0)
            for i in range(m_)]))
    err = max_abs_err(y, ref)
    scale = float(ref.abs().max())
    _mesh_gate(err <= MESH_PIPE_TOL * scale,
               f"pipeline: max |err| {err} > {MESH_PIPE_TOL} · {scale}")
    return {"ms": ms, "sequential_ms": seq_ms, "max_abs_err": err,
            "max_abs_y": scale, "bubble": bubble_fraction(s_, m_),
            "stage": stages.coords["stage"]}


def _mesh_rank_compressed(mesh):
    """xLSTM-125M's gradient of this rank's batch, reduced over the two
    ranks in bf16 and in int8 (``compressed_grad_reduce``), held against
    the f32 mean within what each mode's rounding gives, element by
    element: bf16 rounds each input and the sum, ≤ u(1 + u)·Σ|g_r| on the
    mean (u = 2⁻⁸); int8 rounds x / s_r to the nearest integer (≤ s_r / 2)
    and rescales the int32 sum by the mean scale s̄, ≤ Σ_r (127·|s̄ − s_r|
    + s_r / 2) / 2; each beside 2⁻²² Σ|g_r| for the f32 arithmetic and
    2⁻¹²⁴ for subnormals flushed to zero."""
    import torch
    from repro_torch import configs
    from repro_torch.data import make_train_iterator
    from repro_torch.distributed import collectives as co
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer as T
    from repro_torch.optimizer.optimizers import tree_leaves, tree_like
    cfg = configs.get(TRAIN_ARCH)
    dev = mesh.device
    params = T.init_params(cfg, 0, torch.float32, dev)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = next(make_train_iterator(train_mod.data_config(
        cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0), device=dev,
        sharding=mesh))
    loss, _ = T.loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    del params, leaves, loss
    g = tree_like({str(i): 0 for i in range(len(grads))}, grads)
    out = {}
    for mode in ("bf16", "int8"):
        co.reset_stats()
        red, ms = wall(lambda: co.compressed_grad_reduce(g, mesh, "data",
                                                          mode))
        stats = co.reset_stats()
        worst = 0.0
        for k, x in g.items():
            mean = co.all_reduce(x, mesh, "data") / 2
            abs_sum = co.all_reduce(x.abs(), mesh, "data")
            if mode == "bf16":
                bound = BF16_U * (1 + BF16_U) * abs_sum
            else:
                s = x.abs().max() / 127.0 + 1e-12
                scales = co.all_gather(s.reshape(1), mesh, "data")
                sbar = scales.mean()
                bound = (127 * (scales - sbar).abs().sum()
                         + scales.sum() / 2) / 2
            # f32's own rounding, and subnormals: a CUDA cast to bf16 may
            # flush an f32 below 2⁻¹²⁶ to zero
            bound = bound + 2.0 ** -22 * abs_sum + 2.0 ** -124
            err = (red[k] - mean).abs()
            bad = (err > bound).nonzero()
            if len(bad):
                i = tuple(bad[0].tolist())
                raise AssertionError(
                    f"mesh: compressed {mode}: leaf {k} {tuple(x.shape)}, "
                    f"{len(bad)} entries outside their bound, first {i}: "
                    f"got {float(red[k][i])!r}, f32 mean {float(mean[i])!r},"
                    f" this rank's {float(x[i])!r}, bound {float(bound[i])!r}")
            worst = max(worst, float((err / bound.clamp(min=1e-30)).max()))
            del mean, abs_sum, bound, err
        out[mode] = {"ms": ms, "bytes": stats["bytes"],
                     "host_staged_bytes": stats["host_staged_bytes"],
                     "worst_err_over_bound": worst}
        del red
    return out


def _mesh_ckpt_w1(tmp, ranks):
    """The two ranks' checkpoint restored whole at W = 1 (host memory):
    each rank's block of every leaf hashes as the rank's saved block."""
    import types
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.rules import make_rules
    from repro_torch.models import transformer as T
    from repro_torch.optimizer.optimizers import adamw_init, tree_leaves
    cfg = configs.get(TRAIN_ARCH)
    params = T.init_params(cfg, 0, torch.float32, "cpu")
    like = {"params": params, "opt": adamw_init(params)}
    t0 = time.perf_counter()
    whole = load_checkpoint(f"{tmp}/ckpt", MESH_CKPT_STEPS, like)
    load_s = time.perf_counter() - t0
    _mesh_gate(whole["opt"]["step"] == MESH_CKPT_STEPS,
               f"W=1 restore: step {whole['opt']['step']}")
    for r in ranks:
        m = types.SimpleNamespace(axis_names=("data", "model"),
                                  shape={"data": 2, "model": 1},
                                  coords=r["ckpt"]["coords"])
        specs = sh.tree_specs(T.param_specs(cfg), params, m,
                              make_rules(m, "train"))
        shardings = {"params": specs, "opt": steps_mod.state_specs(
            like["opt"], specs)}
        mine = [_sha(x[sh.block_slices(tuple(x.shape), s, m)])
                for x, s in zip(tree_leaves(whole), tree_leaves(shardings))
                if isinstance(x, torch.Tensor)]
        _mesh_gate(mine == r["ckpt"]["sha"],
                   f"W=1 restore: rank {r['ckpt']['coords']}'s blocks "
                   f"differ from what it saved")
    log(f"mesh checkpoint: saved at W=2 ({ranks[0]['ckpt']['bytes'] / 1e9:.2f}"
        f" GB a rank), restored at W=2 in {ranks[0]['ckpt']['load_s']:.2f} s"
        f" and whole at W=1 in {load_s:.2f} s: equal to the saved state")
    return {"w1_load_s": load_s,
            "w2_load_s": [r["ckpt"]["load_s"] for r in ranks],
            "bytes_a_rank": [r["ckpt"]["bytes"] for r in ranks]}


def _mesh_w2_check(ranks, single, ref2, zref):
    """The two-rank world's results against one rank's: served answers,
    counts and stats equal to the one-device server's on 32 rows a rank;
    losses within ``MESH_LOSS_RTOL`` of one rank fed the concatenated
    batches; half the moments a rank; B1, B4 and B5 launched on every
    rank where its part runs them."""
    import numpy as np
    out = {}
    half = MESH_SERVE_BATCH // 2
    for i, r in enumerate(ranks):
        _mesh_serve_gate(f"D=2 rank {i}", r["serve"], single, half)
        _mesh_gate(r["serve"]["launches"]["coo_spmm"] > 0,
                   f"D=2 rank {i}: B1 never launched")
        for part, want in (("train", ref2), ("zamba", zref)):
            got = r[part]
            rel = np.abs(np.subtract(got["losses"], want["losses"])) / \
                np.abs(want["losses"])
            _mesh_gate(rel.max() <= MESH_LOSS_RTOL,
                       f"W=2 {part} rank {i}: losses {got['losses']} vs one "
                       f"rank {want['losses']}")
            _mesh_gate(0 < got["gathered_peak_bytes"]
                       <= got["gathered_bound_bytes"]
                       < got["whole_tree_bytes"],
                       f"W=2 {part} rank {i}: {got['gathered_peak_bytes']} B "
                       f"of gathered parameters alive at once, bound "
                       f"{got['gathered_bound_bytes']}")
        _mesh_gate(r["train"]["launches"]["ssm_scan"] > 0,
                   f"W=2 rank {i}: B4 never launched")
        _mesh_gate(r["zamba"]["launches"]["flash_attention"] > 0
                   and r["zamba"]["launches"]["flash_attention_backward"] > 0,
                   f"W=2 rank {i}: B5 forward or backward never launched")
        _mesh_gate(r["pipeline"]["launches"]["ssm_scan"] > 0,
                   f"pipeline stage {i}: B4 never launched")
    moments = [r["train"]["moment_bytes"] for r in ranks]
    out["moment_bytes"] = moments
    out["moment_share"] = [m / MESH_MOMENTS_BYTES for m in moments]
    _mesh_gate(sum(moments) < 1.01 * MESH_MOMENTS_BYTES
               and max(moments) < 0.51 * MESH_MOMENTS_BYTES,
               f"W=2 moments {moments} of {MESH_MOMENTS_BYTES}")
    t = ranks[0]["train"]
    out["train"] = {k: [r["train"][k] for r in ranks] for k in (
        "ms_median", "peak_gb", "collective_bytes_per_step",
        "host_staged_bytes_per_step", "gathered_peak_bytes",
        "gathered_bound_bytes")}
    out["train"]["losses"] = t["losses"]
    out["train"]["one_rank_losses"] = ref2["losses"]
    out["zamba"] = {"losses": ranks[0]["zamba"]["losses"],
                    "one_rank_losses": zref["losses"],
                    "ms_median": [r["zamba"]["ms_median"] for r in ranks]}
    out["serve"] = [r["serve"]["timing"] for r in ranks]
    out["pipeline"] = [{k: r["pipeline"][k] for k in (
        "ms", "sequential_ms", "max_abs_err", "max_abs_y", "bubble",
        "stage")} for r in ranks]
    out["compressed"] = [r["compressed"] for r in ranks]
    log(f"mesh W=2 (two gloo ranks on the card) {TRAIN_ARCH}: "
        f"{out['train']['ms_median']} ms a step, losses within "
        f"{MESH_LOSS_RTOL} of one rank on the concatenated batches; "
        f"moments {moments} B a rank ({out['moment_share']}); "
        f"{out['train']['collective_bytes_per_step']} B of collectives and "
        f"{out['train']['host_staged_bytes_per_step']} B staged a step; "
        f"peak {out['train']['peak_gb']} GB; gathered parameters "
        f"{out['train']['gathered_peak_bytes']} B alive at most (bound "
        f"{out['train']['gathered_bound_bytes']})")
    p = out["pipeline"][0]
    log(f"mesh pipeline S={MESH_PIPE[0]} M={MESH_PIPE[1]}: {p['ms']:.1f} ms "
        f"(sequential {p['sequential_ms']:.1f} ms on one rank; bubble "
        f"{p['bubble']:.2f}), max |err| {p['max_abs_err']:.2e} of "
        f"{p['max_abs_y']:.2f}")
    for mode in ("bf16", "int8"):
        c = out["compressed"][0][mode]
        log(f"mesh compressed {mode}: {c['ms']:.1f} ms, {c['bytes']} B, "
            f"worst |err| / bound {c['worst_err_over_bound']:.3f}")
    return out


# --------------------------------------------------------------------------
# phase 15: the model axis — tensor parallelism over "model"
# --------------------------------------------------------------------------

#: xLSTM-125M at the train phase's width and batch on ``(data 1, model
#: 2)``: AdamW steps, against one unsharded rank on the same batches
MA_XLSTM_STEPS = 5
#: Zamba2's smoke config at M = 2, B5's backward on split heads: (arch,
#: global batch, seq, steps)
MA_ZAMBA_SMOKE = ("zamba2-2.7b", 8, 128, 3)
#: Zamba2-2.7B's full config served at M = 2: prompts, prompt length,
#: new tokens (cache slots: ``LM_T_MAX``)
MA_SERVE = (8, 512, 16)
#: DeepSeekMoE-16B at its published size served at M = 2 with each
#: rank's blocks only: the lm_families phase's DeepSeekMoE prompts (lm_
#: serve's traffic: B = 8 of 128–512 tokens, left-padded to 512, cache
#: slots ``LM_T_MAX``), this many new tokens; the one-device reference
#: is that phase's run on the same weights (seed 0)
MA_MOE_ARCH, MA_MOE_NEW = "deepseek-moe-16b", 16
#: DeepSeekMoE-16B trained at M = 2 against one rank: full width, depth
#: cut to (layers: the dense first layer and one MoE layer), global
#: batch, seq, AdamW steps; published capacity factor
MA_MOE_TRAIN = (2, 8, 1024, 3)
#: DeepSeekMoE's smoke config at ``(data 2, model 1)`` against one rank
#: fed both ranks' rows: a capacity factor at which its MoE layers drop
#: choices (the smoke config's 8.0 drops none), global batch, seq, steps
MA_MOE_SMOKE = (0.5, 8, 128, 3)
#: the same run with its batch in this many micro-batches: each rank's
#: micro-batch i its share of the global micro-batch i
MA_MOE_ACCUM = 2
#: xLSTM-125M (the train phase's config) with Adafactor at M = 2: steps
MA_ADAFACTOR_STEPS = 3
#: M = 2 against one rank: losses within this relative difference
MA_LOSS_RTOL = 1e-4
#: a served token must be one device's wherever that device's top-2
#: logit gap exceeds this many times the logits' tolerance
MA_GAP_FACTOR = 100
#: whole heads on a model axis that does not divide them (ROADMAP C), on
#: ``(data 1, model 8)``: MiniCPM-2B at its published size served, 5 or 4
#: of its 36 heads a rank, each rank building only its blocks, against
#: the lm_families phase's one-device run (its prompts and weights):
#: this many new tokens (8 of its 32: a decode step on eight gloo ranks
#: takes ≈2.6 s, its 80 all-reduces staged through the host)
MA_SPLIT_M = 8
MA_MINICPM_ARCH, MA_MINICPM_NEW = "minicpm-2b", 8
#: StarCoder2-7B at full width on the same ranks, 5 or 4 of a kv head's
#: 9 query heads a rank, trained against one rank: layers (depth cut),
#: global batch, seq, AdamW steps
MA_STARCODER_ARCH = "starcoder2-7b"
MA_STARCODER_TRAIN = (2, 4, 512, 3)
#: Whisper-base at its published size served on ``(data 1, model 16)``,
#: each of its 8 heads on two ranks, against the lm_families phase's
#: one-device run: this many new tokens (8 of its 32: ≈2.0 s a step on
#: sixteen ranks)
MA_WIDE_M = 16
MA_WHISPER_ARCH, MA_WHISPER_NEW = "whisper-base", 8
#: the one-device runs the lm_families phase keeps for this phase: arch
#: → the new tokens compared
MA_FAMILY_REFS = {MA_MOE_ARCH: MA_MOE_NEW, MA_MINICPM_ARCH: MA_MINICPM_NEW,
                  MA_WHISPER_ARCH: MA_WHISPER_NEW}


def _ma_gate(ok, what):
    if not ok:
        raise AssertionError(f"model_axis: {what}")


def phase_model_axis(dev, w1, family_refs):
    """The model axis on the card (``collectives``' model-axis
    operators, the tensor-parallel layers and experts,
    ``train(model_parallel=)``, ``serve_batch(model_parallel=)``): (a)
    ``w1``, the mesh phase's xLSTM-125M run on a one-rank NCCL host mesh
    (:func:`_mesh_train_w1`: ``make_host_mesh(1)``, whose one-rank model
    axis makes every model-axis operator the identity), bit for bit the
    unsharded run, recorded here; B4 and B5 (forward and backward)
    against their plain versions at the rank shapes of M = 2, 8 and 16
    (not counted); the one-rank references; then (b) two gloo ranks on
    the card at ``(data 1, model 2)`` (:func:`_ma_rank`): xLSTM-125M at
    full size (AdamW, and Adafactor on split leaves), Zamba2's smoke
    config and DeepSeekMoE-16B at full width, 2 layers, trained;
    Zamba2-2.7B and DeepSeekMoE-16B at full size served, each rank
    building only its blocks, each against one rank or device here
    (``family_refs``: the lm_families phase's one-device runs,
    :func:`_ma_family_reference`); DeepSeekMoE's smoke config trained on
    the same two ranks as ``(data 2, model 1)``, capacity reckoned over
    the global batch; (c) whole heads that the model axis does not
    divide: eight gloo ranks at ``(1, 8)`` (:func:`_ma_split_rank`:
    MiniCPM-2B served at full size, StarCoder2-7B at full width and 2
    layers trained) and sixteen at ``(1, 16)`` (:func:`_ma_wide_rank`:
    Whisper-base served, each head on two ranks)."""
    import functools
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh, spawn_world
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = dict.fromkeys(ops.launch_counts(), 0)
    out = {"power": nvidia_smi(), "laps": {}}
    log(f"model_axis on {out['power']}")

    def lap(name, t):
        out["laps"][name] = time.perf_counter() - t
        return time.perf_counter()

    def add(ranks):
        for r in ranks:
            for k, v in r["launches"].items():
                launches[k] += v
    out["w1"] = w1
    log(f"model_axis M=1 (the mesh phase's one-rank NCCL run): "
        f"{w1['ms_mesh']:.1f} ms a step against unsharded "
        f"{w1['ms_unsharded']:.1f}, bit for bit; peak "
        f"{w1['peak_gb_mesh']:.2f} GB")
    t = time.perf_counter()
    _free_cuda()
    out["kernel_checks"] = _ma_kernel_checks(dev)
    t = lap("kernel_checks", t)
    _free_cuda()
    refs, prompts = _ma_references(dev)
    refs["moe_serve"] = family_refs[MA_MOE_ARCH]
    _free_cuda()
    t = lap("one_rank_references", t)
    log(f"model_axis: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated here as the world starts")
    ranks = spawn_world(_ma_rank, 2, prompts,
                        family_refs[MA_MOE_ARCH]["prompts"], device=dev,
                        mesh_fn=functools.partial(make_host_mesh, 2))
    t = lap("m2_world", t)
    add(ranks)
    out["m2"] = _ma_check(ranks, refs)
    t = lap("m2_check", t)
    split = spawn_world(_ma_split_rank, MA_SPLIT_M,
                        family_refs[MA_MINICPM_ARCH]["prompts"], device=dev,
                        mesh_fn=functools.partial(make_host_mesh,
                                                  MA_SPLIT_M))
    t = lap("m8_world", t)
    wide = spawn_world(_ma_wide_rank, MA_WIDE_M,
                       family_refs[MA_WHISPER_ARCH]["prompts"], device=dev,
                       mesh_fn=functools.partial(make_host_mesh, MA_WIDE_M))
    t = lap("m16_world", t)
    add(split)
    add(wide)
    out["uneven"] = _ma_split_check(split, wide, refs, family_refs)
    lap("uneven_check", t)
    out["launches"] = launches
    _ma_gate(all(launches[k] > 0 for k in (
        "ssm_scan", "flash_attention", "flash_attention_backward")),
             f"launches {launches}: B4, B5 and B5's backward must run")
    out["seconds"] = time.perf_counter() - t0
    log(f"model_axis launches {launches} ({out['seconds']:.1f} s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in out["laps"].items()) + ")")
    return out


def _ma_kernel_checks(dev):
    """B4 and B5 at a rank's shapes on M = 2, each launch held against
    its plain version (outside every counted run): B4 at xLSTM-125M's
    training shape with 768 of its 1,536 channels and at Zamba2-2.7B's
    served prefill with 2,560 of 5,120; B5 with 16 of Zamba2's 32 heads
    of 80 and with 8 of DeepSeekMoE's 16 heads of 128, each at the
    served prefill (8 × 512) and a decode step over 528 cached keys, and
    ``AttnFn``'s backward at its training shape (8 × 1,024)."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops, ref, ssm_scan
    out = {"ssm_scan": {}, "flash_attention": {}}
    xl, zb = configs.get(TRAIN_ARCH), configs.get(LM_ARCH)
    ds = configs.get(MA_MOE_ARCH)
    n_b, plen, new = MA_SERVE
    for name, shape in (
            ("xlstm_train", (TRAIN_BATCH, TRAIN_SEQ,
                             xl.d_inner_mult * xl.d_model // 2)),
            ("zamba2_prefill", (n_b, plen, zb.d_inner_mult * zb.d_model
                                // 2))):
        a, b = b4_inputs(dev, shape)
        err, tol = _check_float(f"model_axis/{name}", "ssm_scan",
                                ssm_scan.ssm_scan_cuda(a, b),
                                ref.ssm_scan_ref(a, b))
        out["ssm_scan"][name] = dict(max_abs_err=err, tol=tol,
                                     shape=dict(zip("BTD", shape)))
        del a, b
    for j, (model, cfg) in enumerate((("zamba2", zb), ("deepseek", ds))):
        hq, hkv = cfg.n_heads // 2, cfg.n_kv_heads // 2
        for i, (name, tq, tk, off) in enumerate((
                ("prefill", plen, plen, 0),
                ("decode", 1, plen + new, plen + new - 1))):
            q, k, v = b5_inputs(dev, 70 + 4 * j + i, n_b, tq, tk, hq, hkv,
                                cfg.hd, t_max=LM_T_MAX)
            path, _, err, tol, _ = b5_check(f"model_axis/{model}_{name}", q,
                                            k, v, causal=True, q_offset=off)
            out["flash_attention"][f"{model}_{name}"] = dict(
                max_abs_err=err, tol=tol, path=path,
                shape={"B": n_b, "Tq": tq, "Tk": tk, "Hq": hq, "Hkv": hkv,
                       "D": cfg.hd})
            del q, k, v
        q, k, v = b5_inputs(dev, 72 + 4 * j, TRAIN_BATCH, TRAIN_SEQ,
                            TRAIN_SEQ, hq, hkv, cfg.hd)
        do = torch.randn(q.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(73 + 4 * j))
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        with _PlainCalls() as plain:
            grads = torch.autograd.grad(ops.flash_attention(*leaves), leaves,
                                        do)
        _ma_gate(plain.calls == 0, "AttnFn took a plain version")
        want = attention_grad_blocked(q, k, v, do)
        errs = []
        for what, got, w in zip(("dq", "dk", "dv"), grads, want):
            err, tol = _check_float(
                f"model_axis/{model}_train_backward {what}",
                "flash_attention", got, w)
            errs.append((err, tol))
        out["flash_attention"][f"{model}_train_backward"] = dict(
            max_abs_err=max(e for e, _ in errs),
            tol=min(t for _, t in errs),
            shape={"B": TRAIN_BATCH, "Tq": TRAIN_SEQ, "Tk": TRAIN_SEQ,
                   "Hq": hq, "Hkv": hkv, "D": cfg.hd})
        del q, k, v, do, leaves, grads, want
    for kname, rows in out.items():
        for name, r in rows.items():
            log(f"model_axis {kname} {name} {r['shape']}: max|err| "
                f"{r['max_abs_err']:.3g} (tol {r['tol']:.3g})")
    fwd, bwd = _ma_split_b5_rows()
    out["flash_attention"].update(b5_forward_rows(dev, fwd, 90))
    out["flash_attention"].update(
        {f"{k}_backward": v for k, v in b5_backward_rows(dev, bwd,
                                                         110).items()})
    return out


def _ma_split_b5_rows():
    """B5's rows at the rank shapes of the uneven worlds, from
    ``sharding.head_split``: forward ``{name: (b, tq, tk, hq, hkv, d,
    mask keywords, cache slots)}`` and backward (``b5_train_shape``'s
    layout).  MiniCPM-2B's 5 and 4 MHA heads of 64 at M = 8 (lm_families'
    served prefill, 8 × 512, and a decode step over ``MA_MINICPM_NEW``
    more keys); StarCoder2-7B's 5 and 4 query heads of 128 over one kv
    head at M = 8 in its window of 4,096 (lm_families' 2 × 4,600 prefill
    and a decode step; the backward at the training part's shape);
    Whisper-base's one replicated head of 64 at M = 16, self (causal,
    from the cache) and cross (over the encoder's 512 positions, no
    mask), prefill and decode; each backward at the same heads."""
    from repro_torch import configs
    from repro_torch.distributed import sharding as sh
    fwd, bwd = {}, {}
    n_new = {MA_MINICPM_ARCH: MA_MINICPM_NEW,
             MA_STARCODER_ARCH: next(r[4] for r in FAMILY_RUNS
                                     if r[0] == MA_STARCODER_ARCH)}
    causal = {"causal": True, "window": None, "chunk": None}
    for arch, m in ((MA_MINICPM_ARCH, MA_SPLIT_M),
                    (MA_STARCODER_ARCH, MA_SPLIT_M)):
        cfg = configs.get(arch)
        run = next(r for r in FAMILY_RUNS if r[0] == arch)
        b, plen, slots = run[2], run[3][1], run[5]
        split = sh.head_split(cfg.n_heads, cfg.n_kv_heads, m)
        kw = dict(causal, window=cfg.window)
        short = arch.split("-")[0]
        for (_, hq), (_, hkv) in sorted(set(zip(split.q, split.kv)),
                                        key=lambda x: -x[0][1]):
            tk = plen + n_new[arch]
            fwd[f"{short}_m{m}_h{hq}_prefill"] = (
                b, plen, plen, hq, hkv, cfg.hd, kw, slots)
            fwd[f"{short}_m{m}_h{hq}_decode"] = (
                b, 1, tk, hq, hkv, cfg.hd, dict(kw, q_offset=tk - 1), slots)
            tb, tt = ((MA_STARCODER_TRAIN[1], MA_STARCODER_TRAIN[2])
                      if arch == MA_STARCODER_ARCH else (b, plen))
            bwd[f"{short}_m{m}_h{hq}"] = (None, tb, tt, tt, hq, hkv, cfg.hd,
                                           dict(kw, q_offset=0))
    wh = configs.get(MA_WHISPER_ARCH)
    run = next(r for r in FAMILY_RUNS if r[0] == MA_WHISPER_ARCH)
    b, plen, slots = run[2], run[3][1], run[5]
    tk = plen + MA_WHISPER_NEW
    cross = {"causal": False, "window": None, "chunk": None}
    fwd.update({
        "whisper_m16_self_prefill": (b, plen, plen, 1, 1, wh.hd, causal,
                                     slots),
        "whisper_m16_self_decode": (b, 1, tk, 1, 1, wh.hd,
                                    dict(causal, q_offset=tk - 1), slots),
        "whisper_m16_cross_prefill": (b, plen, plen, 1, 1, wh.hd, cross,
                                      None),
        "whisper_m16_cross_decode": (b, 1, plen, 1, 1, wh.hd,
                                     dict(cross, q_offset=plen), None)})
    bwd.update({
        "whisper_m16_self": (None, b, plen, plen, 1, 1, wh.hd,
                             dict(causal, q_offset=0)),
        "whisper_m16_cross": (None, b, plen, plen, 1, 1, wh.hd,
                              dict(cross, q_offset=0))})
    return fwd, bwd


def b5_forward_rows(dev, rows, seed):
    """B5 at ``rows`` (``{name: (b, tq, tk, hq, hkv, d, mask keywords,
    cache slots or None)}``: k and v the written prefix of a cache of
    that many slots), outside any counted run, each held against its
    plain version and timed beside its bound in its path's unit (as
    :func:`kernel_b5` states it: prefill_tc's operations at three TF32
    tensor-core passes, else the FP32 SIMT operations or the bytes), the
    plain version and SDPA (f32)."""
    from repro_torch.kernels import flash_attention as fa, ref
    out = {}
    for i, (name, (b, tq, tk, hq, hkv, d, extra, slots)) in enumerate(
            rows.items()):
        kw = {"causal": True, "window": None, "chunk": None, "q_offset": 0,
              **extra}
        q, k, v = b5_inputs(dev, seed + i, b, tq, tk, hq, hkv, d, slots)
        path, geo, err, tol, want = b5_check(f"model_axis/{name}", q, k, v,
                                             **kw)
        library = _sdpa(q, k, v, **kw)
        lib_err = max_abs_err(library(), want)
        if lib_err > tol:
            raise AssertionError(f"SDPA yardstick disagrees ({name}: "
                                 f"{lib_err})")
        del want

        def kernel(q=q, k=k, v=v, kw=kw):
            return fa.flash_attention_cuda(q, k, v, **kw)
        ops = 4.0 * b * hq * d * visible_pairs(tq, tk, **kw)
        keys = visible_keys(tq, tk, **kw)
        nbytes = 4.0 * d * (2 * b * tq * hq + 2 * b * keys * hkv)
        bound, by_what = (_bound(nbytes, 3 * ops, TF32_TC_FLOPS)
                          if path == "prefill_tc" else _bound(nbytes, ops))
        ms = time_ms(kernel, 10, hide_host=True)
        out[name] = dict(
            shape={"B": b, "Tq": tq, "Tk": tk, "Hq": hq, "Hkv": hkv, "D": d,
                   **kw, "cache_slots": slots},
            path=path, grid=list(geo.grid), max_abs_err=err, tol=tol, ms=ms,
            plain_ms=time_ms(lambda q=q, k=k, v=v, kw=kw:
                             ref.attention_ref(q, k, v, **kw), 2),
            library_ms=time_ms(library, 10, hide_host=True),
            library_call="F.scaled_dot_product_attention (f32)",
            bound_ms=bound, bound_by=by_what, ops=ops, bytes=nbytes,
            bound_share=bound / ms)
        log(f"{'flash_attention':>16} {name} {out[name]['shape']}: {ms:.4f} "
            f"ms {path} ({100 * bound / ms:.1f}% of the {by_what} bound "
            f"{bound:.4f} ms), {out[name]['plain_ms']:.4f} ms plain, SDPA "
            f"f32 {out[name]['library_ms']:.4f} ms, max|err| {err:.3g} "
            f"(tol {tol:.3g})")
        del q, k, v, library
        _free_cuda()
    return out


def _ma_prompts():
    import numpy as np
    n_b, plen, _ = MA_SERVE
    rng = np.random.default_rng(SERVE_SEED + 31)
    return [rng.integers(1, LM_WIDTHS[4], plen) for _ in range(n_b)]


class _StepWindow(list):
    """A ``train`` history that reads ``collectives.STATS`` over steps 2
    to ``steps``: zeroed when the first step's entry arrives, read into
    ``stats`` when the last one's does (so neither set-up nor the closing
    gather is in it)."""

    def __init__(self, steps):
        super().__init__()
        self.steps, self.stats = steps, None

    def append(self, entry):
        from repro_torch.distributed import collectives
        super().append(entry)
        if len(self) == 1:
            collectives.reset_stats()
        if len(self) == self.steps:
            self.stats = collectives.reset_stats()


def _ma_train(dev, arch, smoke, batch, seq, steps, **kw):
    """``train`` of ``arch`` (a name or a ``ModelConfig``): losses, ms a
    step (median from the second step on), peak memory, and the
    collectives' calls, bytes and host-staged bytes a step over steps 2
    to ``steps``."""
    import numpy as np
    import torch
    from repro_torch.launch import train as train_mod
    torch.cuda.reset_peak_memory_stats()
    hist = _StepWindow(steps)
    params, losses = train_mod.train(arch, smoke=smoke, batch=batch,
                                     seq=seq, steps=steps, device=dev,
                                     history=hist, log_every=100, **kw)
    ms = [h["ms"] for h in hist]
    return params, {"losses": losses, "ms": ms,
                    "grad_norms": [h["grad_norm"] for h in hist],
                    "ms_median": float(np.median(ms[1:] or ms)),
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "collectives_per_step": {
                        k: v / (steps - 1) for k, v in hist.stats.items()}}


def _ma_moe_train_cfg():
    """DeepSeekMoE-16B at its published widths, depth cut to
    ``MA_MOE_TRAIN``'s layers (the dense first layer and MoE layers)."""
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get(MA_MOE_ARCH),
                               n_layers=MA_MOE_TRAIN[0])


def _ma_starcoder_cfg():
    """StarCoder2-7B at its published widths, depth cut to
    ``MA_STARCODER_TRAIN``'s layers."""
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get(MA_STARCODER_ARCH),
                               n_layers=MA_STARCODER_TRAIN[0])


def _ma_moe_smoke_cfg():
    """DeepSeekMoE's smoke config at ``MA_MOE_SMOKE``'s capacity factor."""
    import dataclasses
    from repro_torch import configs
    cfg = configs.get(MA_MOE_ARCH, smoke=True)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MA_MOE_SMOKE[0]))


def _ma_serve(dev, cfg, prompts, new, mesh=None):
    """``cfg`` served greedily by ``serve_batch`` (random weights from
    seed 0: on one device made before the call, on ``mesh`` each rank's
    blocks built inside it): tokens, prefill ms, decode ms a step, peak,
    and the call's launches and collectives.  Then, outside that call,
    :func:`_ma_logits` on the same weights (on ``mesh`` the blocks built
    again by ``serve.rank_blocks``): on one device the prefill's and
    each token-choosing decode step's logits fed the emitted tokens, on
    ``mesh`` the prefill's, with an MoE model's chosen experts."""
    import numpy as np
    import torch
    from repro_torch.distributed import collectives
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    params = None if mesh is not None else T.init_params(cfg, 0,
                                                         torch.float32, dev)
    reqs = [serve.Request(p, max_new=new) for p in prompts]
    torch.cuda.reset_peak_memory_stats()
    collectives.reset_stats()
    with Counted() as c:
        stats = serve.serve_batch(cfg, reqs, t_max=LM_T_MAX, device=dev,
                                  params=params, mesh=mesh)
    coll = collectives.reset_stats()
    out = {"tokens": [r.out for r in reqs],
           "prefill_ms": stats["prefill_s"] * 1e3,
           "decode_ms_per_step": stats["decode_s"] * 1e3 / new,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": c.counts, "collectives": coll}
    del stats
    tokens = _padded(prompts, max(len(p) for p in prompts))
    emitted = np.array(out["tokens"])[:, :-1]
    if mesh is None:
        out["logits"], _ = _ma_logits(cfg, params, tokens, emitted, dev)
        return out
    _free_cuda()
    blocks, rules = serve.rank_blocks(cfg, mesh, 0, torch.float32, dev)
    out["logits"], out["chosen"] = _ma_logits(
        cfg, blocks, tokens, emitted[:, :0], dev, mesh, rules)
    return out


def _ma_logits(cfg, params, tokens, emitted, dev, mesh=None, rules=None):
    """The last position's logits (every rank's columns, on the host)
    after a prefill of ``tokens`` (B, S) and after each decode step fed
    a column of ``emitted``, on ``params`` (a rank's blocks under
    ``rules`` on ``mesh``): ``(1 + emitted.shape[1], B, padded_vocab)``;
    and, for an MoE model, each MoE layer's ``(B, S, k)`` experts chosen
    in the prefill (uint8, on the host), else None."""
    import contextlib
    import torch
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    scope = (contextlib.nullcontext() if mesh is None else
             sh.use_rules(mesh, rules))
    moe = cfg.family == "moe"
    enc = None           # serve_batch's: zero encoder embeddings
    if cfg.family == "encdec":
        enc = torch.zeros(tokens.shape + (cfg.d_model,), device=dev)
    with scope:
        cache = T.init_cache(cfg, len(tokens), LM_T_MAX, torch.float32,
                             dev)
        logits, aux, cache = T.forward(
            params, cfg, torch.from_numpy(tokens).to(dev), cache=cache,
            enc_embeds=enc, return_aux=True)
        chosen = ([c.to(torch.uint8).cpu() for c in aux.chosen] if moe
                  else None)
        del aux
        out = [L.gather_vocab(logits[:, -1]).cpu()]
        for i in range(emitted.shape[1]):
            logits, cache = T.decode_step(
                params, cfg, torch.from_numpy(emitted[:, i:i + 1]).to(dev),
                cache)
            out.append(L.gather_vocab(logits[:, -1]).cpu())
    return torch.stack(out), chosen


def _ma_family_reference(params, cfg, prompts, tokens, timing, dev, new):
    """The one-device side of a model-axis serving check, from the
    lm_families phase's run (same weights, prompts and ``t_max``): its
    first ``new`` greedy tokens (greedy decoding is deterministic, so a
    shorter run emits these), the logits of its prefill and of each
    token-choosing decode step fed them, an MoE model's prefill choices,
    and the run's timing and peak."""
    padded = _padded(prompts, max(len(p) for p in prompts))
    logits, chosen = _ma_logits(cfg, params, padded, tokens[:, :new - 1],
                                dev)
    return {"prompts": prompts, "tokens": tokens[:, :new].tolist(),
            "logits": logits, "chosen": chosen, **timing}


def ma_family_references(dev):
    """:func:`_ma_family_reference` of each of ``MA_FAMILY_REFS`` on its
    own (prompts drawn as the lm_families phase draws them, less its VLM
    run's draws; weights from seed 0; served on one device), for a run
    of the model_axis phase alone."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    rng = np.random.default_rng(24)
    out = {}
    for arch, cuts, b, lengths, _, t_max in FAMILY_RUNS:
        _, cfg = family_cfg(arch, cuts)
        prompts = family_prompts(rng, cfg, b, lengths)   # lm_families' order
        if arch not in MA_FAMILY_REFS:
            continue
        if t_max != LM_T_MAX:
            raise AssertionError(f"lm_families' {arch} run is not at "
                                 f"t_max {LM_T_MAX}")
        new = MA_FAMILY_REFS[arch]
        params = T.init_params(cfg, seed=0, device=dev)
        reqs = [serve.Request(p, new) for p in prompts]
        torch.cuda.reset_peak_memory_stats()
        stats = serve.serve_batch(cfg, reqs, t_max=t_max, device=dev,
                                  params=params)
        timing = dict(prefill_ms=stats["prefill_s"] * 1e3,
                      decode_ms_per_step=stats["decode_s"] * 1e3 / new,
                      peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        out[arch] = _ma_family_reference(
            params, cfg, prompts, np.array([r.out for r in reqs]), timing,
            dev, new)
        del params
        _free_cuda()
    return out


def _ma_references(dev):
    """One rank on the card: xLSTM-125M (AdamW and Adafactor), Zamba2's
    smoke config, DeepSeekMoE-16B and StarCoder2-7B at 2 layers trained
    unsharded on
    the batches a ``(1, 2)`` mesh's ranks read (the whole batch: one
    ``"data"`` row); DeepSeekMoE's smoke config fed the two host streams
    a ``(2, 1)`` mesh's ranks read, concatenated
    (:func:`_mesh_concat_run`: losses only); Zamba2-2.7B served on one
    device."""
    from repro_torch import configs
    refs = {}
    _, refs["xlstm"] = _ma_train(dev, TRAIN_ARCH, False, TRAIN_BATCH,
                                 TRAIN_SEQ, MA_XLSTM_STEPS)
    _free_cuda()
    _, refs["adafactor"] = _ma_train(dev, TRAIN_ARCH, False, TRAIN_BATCH,
                                     TRAIN_SEQ, MA_ADAFACTOR_STEPS,
                                     optimizer="adafactor")
    _free_cuda()
    arch, b, seq, n = MA_ZAMBA_SMOKE
    _, refs["zamba"] = _ma_train(dev, arch, True, b, seq, n)
    _free_cuda()
    _, b, seq, n = MA_MOE_TRAIN
    _, refs["moe_train"] = _ma_train(dev, _ma_moe_train_cfg(), False, b,
                                     seq, n)
    _free_cuda()
    _, b, seq, n = MA_MOE_SMOKE
    refs["moe_data"] = _mesh_concat_run(dev, _ma_moe_smoke_cfg(), True, b,
                                        seq, n)
    _free_cuda()
    refs["moe_accum"] = _mesh_concat_run(dev, _ma_moe_smoke_cfg(), True, b,
                                         seq, n, accum_steps=MA_MOE_ACCUM)
    _free_cuda()
    _, b, seq, n = MA_STARCODER_TRAIN
    _, refs["starcoder2"] = _ma_train(dev, _ma_starcoder_cfg(), False, b,
                                      seq, n)
    _free_cuda()
    prompts = _ma_prompts()
    refs["serve"] = _ma_serve(dev, configs.get(LM_ARCH), prompts,
                              MA_SERVE[2])
    return refs, prompts


#: the parts of :func:`_ma_rank`'s training, in order: (name, what its
#: launches must include)
MA_TRAIN_PARTS = (("xlstm", ("ssm_scan",)),
                  ("adafactor", ("ssm_scan",)),
                  ("zamba", ("flash_attention", "flash_attention_backward")),
                  ("moe_train", ("flash_attention",
                                 "flash_attention_backward")),
                  ("moe_data", ("flash_attention",
                                "flash_attention_backward")),
                  ("moe_accum", ("flash_attention",
                                 "flash_attention_backward")))


def _ma_rank(mesh, prompts, moe_prompts):
    """One rank of the ``(data 1, model 2)`` world on the card: the
    training parts of ``MA_TRAIN_PARTS`` (xLSTM-125M at full size with
    AdamW and with Adafactor, Zamba2's smoke config and DeepSeekMoE-16B
    at 2 layers through ``train(model_parallel=2)``; DeepSeekMoE's smoke
    config through ``train(mesh=)`` on the same two ranks as ``(data 2,
    model 1)``), Zamba2-2.7B's and DeepSeekMoE-16B's full configs served
    on the mesh, each rank building its blocks; each part's launches
    counted in this process, its collectives read from
    ``collectives.STATS`` (:func:`_ma_train`, :func:`_ma_serve`)."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    out = {"launches": dict.fromkeys(ops.launch_counts(), 0)}
    arch, b, seq, n = MA_ZAMBA_SMOKE
    moe_layers, moe_b, moe_seq, moe_n = MA_MOE_TRAIN
    _, sb, sseq, sn = MA_MOE_SMOKE
    data_mesh = make_host_mesh(1, device=dev)           # (2, 1)
    runs = {
        "xlstm": ((TRAIN_ARCH, False, TRAIN_BATCH, TRAIN_SEQ,
                   MA_XLSTM_STEPS), {"model_parallel": 2}),
        "adafactor": ((TRAIN_ARCH, False, TRAIN_BATCH, TRAIN_SEQ,
                       MA_ADAFACTOR_STEPS),
                      {"model_parallel": 2, "optimizer": "adafactor"}),
        "zamba": ((arch, True, b, seq, n), {"model_parallel": 2}),
        "moe_train": ((_ma_moe_train_cfg(), False, moe_b, moe_seq, moe_n),
                      {"model_parallel": 2}),
        "moe_data": ((_ma_moe_smoke_cfg(), True, sb, sseq, sn),
                     {"mesh": data_mesh}),
        "moe_accum": ((_ma_moe_smoke_cfg(), True, sb, sseq, sn),
                      {"mesh": data_mesh, "accum_steps": MA_MOE_ACCUM})}
    for name, _ in MA_TRAIN_PARTS:
        args, kw = runs[name]
        _free_cuda()
        with Counted() as c:
            out[name] = _ma_train(dev, *args, **kw)[1]
        out[name]["launches"] = c.counts
    _free_cuda()
    out["serve"] = _ma_serve(dev, configs.get(LM_ARCH), prompts,
                             MA_SERVE[2], mesh)
    _free_cuda()
    out["moe_serve"] = _ma_serve(dev, configs.get(MA_MOE_ARCH), moe_prompts,
                                 MA_MOE_NEW, mesh)
    for part in (*(p for p, _ in MA_TRAIN_PARTS), "serve", "moe_serve"):
        for k, v in out[part]["launches"].items():
            out["launches"][k] += v
    return out


def _ma_serve_check(name, ranks, one, arch):
    """A served model on a model axis of ``len(ranks)`` ranks against one
    device: prefill logits within LOGIT_TOL · max |logit|, every token
    equal where one device's top-2 gap exceeds ``MA_GAP_FACTOR`` times
    that (a row's later steps are not compared once a token differs at
    a closer call; those are counted); every rank's tokens equal; an MoE
    model's prefill routing choices that differ from one device's
    counted (a near-tie in the router may flip)."""
    import numpy as np
    import torch
    world = f"M={len(ranks)}"
    _ma_gate(all(r[name]["tokens"] == ranks[0][name]["tokens"]
                 for r in ranks),
             f"{world} serving {arch}: the ranks emitted different tokens")
    lg1 = one["logits"]
    tol = LOGIT_TOL * float(lg1[0].abs().max())
    lg2 = ranks[0][name]["logits"]
    _ma_gate(bool(torch.isfinite(lg2).all()), f"{world} serving {arch}: "
             f"non-finite logits")
    prefill_err = float((lg2[0] - lg1[0]).abs().max())
    _ma_gate(prefill_err <= tol, f"{world} {arch} prefill logits: max |err| "
             f"{prefill_err} > {tol}")
    top2 = lg1.topk(2, -1).values
    gap = (top2[..., 0] - top2[..., 1]).numpy()          # (steps, B)
    t1 = np.array(one["tokens"]).T                         # (steps, B)
    t2 = np.array(ranks[0][name]["tokens"]).T
    _ma_gate(t1.shape == t2.shape, f"{world} {arch}: tokens {t2.shape} "
             f"against {t1.shape}")
    close_calls, compared = 0, 0
    for row in range(t1.shape[1]):
        for s in range(t1.shape[0]):
            compared += 1
            if t1[s, row] == t2[s, row]:
                continue
            _ma_gate(gap[s, row] <= MA_GAP_FACTOR * tol,
                     f"{world} serving {arch} row {row} step {s}: token "
                     f"{t2[s, row]} != {t1[s, row]} with a top-2 gap "
                     f"{gap[s, row]} > {MA_GAP_FACTOR} × {tol}")
            close_calls += 1
            break
    srv = [r[name] for r in ranks]
    out = {
        "prefill_max_abs_err": prefill_err, "tol": tol,
        "tokens_compared": compared, "close_calls": close_calls,
        "min_gap": float(gap.min()),
        "prefill_ms": [s["prefill_ms"] for s in srv],
        "decode_ms_per_step": [s["decode_ms_per_step"] for s in srv],
        "one_device_prefill_ms": one["prefill_ms"],
        "one_device_decode_ms_per_step": one["decode_ms_per_step"],
        "peak_gb": [s["peak_gb"] for s in srv],
        "one_device_peak_gb": one["peak_gb"],
        "collective_calls": [s["collectives"]["calls"] for s in srv],
        "collective_bytes": [s["collectives"]["bytes"] for s in srv],
        "host_staged_bytes": [s["collectives"]["host_staged_bytes"]
                              for s in srv]}
    if one.get("chosen") is not None:
        flips = []
        for r in srv:
            _ma_gate(r["chosen"] is not None and
                     len(r["chosen"]) == len(one["chosen"]),
                     f"{world} {arch}: no routing choices")
            per_layer = [int((torch.sort(a, -1).values
                              != torch.sort(b, -1).values).any(-1).sum())
                         for a, b in zip(r["chosen"], one["chosen"])]
            flips.append(per_layer)
        _ma_gate(all(f == flips[0] for f in flips), f"{world} {arch}: the "
                 f"ranks routed differently")
        out["routing_flips_by_layer"] = flips[0]
        out["routed_tokens_per_layer"] = int(one["chosen"][0][..., 0].numel())
    return out


def _ma_check(ranks, refs):
    """The ``(1, 2)`` world against one rank: losses within
    ``MA_LOSS_RTOL`` for each training part (DeepSeekMoE's smoke config
    at ``(2, 1)`` against one rank fed both ranks' rows), each part's
    kernels launched; both served models through
    :func:`_ma_serve_check`; B4 and B5 in Zamba2's serving, B5 in
    DeepSeekMoE's."""
    out = {}
    for part, kernels in MA_TRAIN_PARTS:
        want = refs[part]["losses"]
        for i, r in enumerate(ranks):
            got = r[part]["losses"]
            rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
            _ma_gate(len(got) == len(want) and max(rel) <= MA_LOSS_RTOL,
                     f"M=2 {part} rank {i}: losses {got} vs one rank {want}")
            _ma_gate(all(r[part]["launches"][k] > 0 for k in kernels),
                     f"M=2 {part} rank {i}: launches "
                     f"{r[part]['launches']}, expected {kernels}")
        per_rank = []
        for r in ranks:
            c = r[part]["collectives_per_step"]
            per_rank.append({
                "ms_median": r[part]["ms_median"],
                "peak_gb": r[part]["peak_gb"],
                "collective_bytes_per_step": c["bytes"],
                "host_staged_bytes_per_step": c["host_staged_bytes"],
                "collective_calls_per_step": c["calls"]})
        out[part] = {"losses": ranks[0][part]["losses"],
                     "one_rank_losses": want,
                     "one_rank_ms_median": refs[part].get("ms_median"),
                     "one_rank_peak_gb": refs[part].get("peak_gb"),
                     "ranks": per_rank}
    for i, r in enumerate(ranks):
        _ma_gate(r["serve"]["launches"]["ssm_scan"] > 0
                 and r["serve"]["launches"]["flash_attention"] > 0,
                 f"M=2 rank {i}: serving Zamba2 launched no B4 or B5")
        _ma_gate(r["moe_serve"]["launches"]["flash_attention"] > 0,
                 f"M=2 rank {i}: serving DeepSeekMoE launched no B5")
    out["serve"] = _ma_serve_check("serve", ranks, refs["serve"], LM_ARCH)
    out["moe_serve"] = _ma_serve_check("moe_serve", ranks, refs["moe_serve"],
                                       MA_MOE_ARCH)
    for part, _ in MA_TRAIN_PARTS:
        o = out[part]
        log(f"model_axis M=2 {part}: {[r['ms_median'] for r in o['ranks']]} "
            f"ms a step against one rank {o['one_rank_ms_median']}; "
            f"losses within {MA_LOSS_RTOL} of one rank; "
            f"{[r['collective_bytes_per_step'] for r in o['ranks']]} B of "
            f"collectives and "
            f"{[r['host_staged_bytes_per_step'] for r in o['ranks']]} B "
            f"staged a rank a step; peak {[r['peak_gb'] for r in o['ranks']]}"
            f" GB (one rank {o['one_rank_peak_gb']})")
    for name, arch in (("serve", LM_ARCH), ("moe_serve", MA_MOE_ARCH)):
        s = out[name]
        flips = ""
        if "routing_flips_by_layer" in s:
            flips = (f"; routing flips {sum(s['routing_flips_by_layer'])} "
                     f"of {s['routed_tokens_per_layer']} tokens × "
                     f"{len(s['routing_flips_by_layer'])} MoE layers")
        log(f"model_axis M=2 serving {arch}: prefill {s['prefill_ms']} ms, "
            f"decode {s['decode_ms_per_step']} ms a step (one device "
            f"{s['one_device_prefill_ms']:.1f}, "
            f"{s['one_device_decode_ms_per_step']:.2f}); prefill logits max "
            f"|err| {s['prefill_max_abs_err']:.3g} (tol {s['tol']:.3g}); "
            f"{s['close_calls']} close calls in {s['tokens_compared']} "
            f"tokens; peak {s['peak_gb']} GB (one device "
            f"{s['one_device_peak_gb']:.2f}){flips}")
    return out


def _ma_heads(cfg, mesh):
    """This rank's query and kv heads on ``mesh``'s model axis."""
    from repro_torch.distributed import sharding as sh
    r, m = sh.model_coords(mesh)
    split = sh.head_split(cfg.n_heads, cfg.n_kv_heads, m)
    return {"q": split.q[r][1], "kv": split.kv[r][1],
            "q_rep": split.q_rep, "kv_rep": split.kv_rep}


def _ma_split_rank(mesh, prompts):
    """One rank of the ``(data 1, model 8)`` world on the card, whole
    heads that the axis does not divide: StarCoder2-7B at full width and
    ``MA_STARCODER_TRAIN``'s depth trained through
    ``train(model_parallel=8)`` (5 or 4 of each kv head's 9 query heads
    a rank), then MiniCPM-2B at its published size served on the mesh
    (5 or 4 of its 36 heads a rank), each rank building its blocks; each
    part's launches counted in this process."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    out = {"launches": dict.fromkeys(ops.launch_counts(), 0)}
    _, b, seq, n = MA_STARCODER_TRAIN
    cfg = _ma_starcoder_cfg()
    with Counted() as c:
        out["starcoder2"] = _ma_train(dev, cfg, False, b, seq, n,
                                      model_parallel=MA_SPLIT_M)[1]
    out["starcoder2"].update(launches=c.counts, heads=_ma_heads(cfg, mesh))
    _free_cuda()
    cfg = configs.get(MA_MINICPM_ARCH)
    out["minicpm"] = _ma_serve(dev, cfg, prompts, MA_MINICPM_NEW, mesh)
    out["minicpm"]["heads"] = _ma_heads(cfg, mesh)
    for part in ("starcoder2", "minicpm"):
        for k, v in out[part]["launches"].items():
            out["launches"][k] += v
    return out


def _ma_wide_rank(mesh, prompts):
    """One rank of the ``(data 1, model 16)`` world on the card:
    Whisper-base at its published size served on the mesh, each of its 8
    heads on two ranks (``wq``'s columns replicated, ``wo``'s rows of the
    head split between them), each rank building its blocks."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get(MA_WHISPER_ARCH)
    out = {"whisper": _ma_serve(mesh.device, cfg, prompts, MA_WHISPER_NEW,
                                mesh)}
    out["whisper"]["heads"] = _ma_heads(cfg, mesh)
    out["launches"] = dict.fromkeys(ops.launch_counts(), 0)
    out["launches"].update(out["whisper"]["launches"])
    return out


def _ma_split_check(split, wide, refs, family_refs):
    """The uneven worlds against one rank or device: StarCoder2-7B's
    losses and grad norms on every rank of ``(1, 8)`` within
    ``MA_LOSS_RTOL`` of one rank's, B5 and its backward launched;
    MiniCPM-2B at ``(1, 8)`` and Whisper-base at ``(1, 16)`` against the
    lm_families phase's one-device runs (:func:`_ma_serve_check`), B5
    launched; rank 0 holding the most heads."""
    want = refs["starcoder2"]
    per_rank = []
    for i, r in enumerate(split):
        got = r["starcoder2"]
        for what in ("losses", "grad_norms"):
            rel = [abs(g - w) / abs(w) for g, w in zip(got[what],
                                                       want[what])]
            _ma_gate(len(got[what]) == len(want[what])
                     and max(rel) <= MA_LOSS_RTOL,
                     f"M={MA_SPLIT_M} starcoder2 rank {i}: {what} "
                     f"{got[what]} vs one rank {want[what]}")
        _ma_gate(got["launches"]["flash_attention"] > 0
                 and got["launches"]["flash_attention_backward"] > 0,
                 f"M={MA_SPLIT_M} starcoder2 rank {i}: launches "
                 f"{got['launches']}")
        c = got["collectives_per_step"]
        per_rank.append({"heads": got["heads"], "ms_median": got["ms_median"],
                         "peak_gb": got["peak_gb"],
                         "collective_bytes_per_step": c["bytes"],
                         "host_staged_bytes_per_step": c["host_staged_bytes"],
                         "collective_calls_per_step": c["calls"]})
    out = {"starcoder2": {"losses": split[0]["starcoder2"]["losses"],
                          "grad_norms": split[0]["starcoder2"]["grad_norms"],
                          "one_rank_losses": want["losses"],
                          "one_rank_grad_norms": want["grad_norms"],
                          "one_rank_ms_median": want["ms_median"],
                          "one_rank_peak_gb": want["peak_gb"],
                          "ranks": per_rank}}
    for name, ranks, arch in (("minicpm", split, MA_MINICPM_ARCH),
                              ("whisper", wide, MA_WHISPER_ARCH)):
        for i, r in enumerate(ranks):
            _ma_gate(r[name]["launches"]["flash_attention"] > 0,
                     f"M={len(ranks)} rank {i}: serving {arch} launched "
                     f"no B5")
        heads = [r[name]["heads"] for r in ranks]
        _ma_gate(heads[0]["q"] == max(h["q"] for h in heads),
                 f"M={len(ranks)} {arch}: rank 0 holds {heads[0]}, not the "
                 f"most heads")
        out[name] = _ma_serve_check(name, ranks, family_refs[arch], arch)
        out[name]["heads"] = heads
    o = out["starcoder2"]
    log(f"model_axis M={MA_SPLIT_M} starcoder2 (2 layers, heads a rank "
        f"{[r['heads']['q'] for r in o['ranks']]}): "
        f"{[r['ms_median'] for r in o['ranks']]} ms a step against one "
        f"rank {o['one_rank_ms_median']}; losses and grad norms within "
        f"{MA_LOSS_RTOL} of one rank; "
        f"{[r['collective_bytes_per_step'] for r in o['ranks']]} B of "
        f"collectives a rank a step; peak "
        f"{[r['peak_gb'] for r in o['ranks']]} GB (one rank "
        f"{o['one_rank_peak_gb']})")
    for name, arch in (("minicpm", MA_MINICPM_ARCH),
                       ("whisper", MA_WHISPER_ARCH)):
        s = out[name]
        log(f"model_axis M={len(s['peak_gb'])} serving {arch} (heads a rank "
            f"{[h['q'] for h in s['heads']]}): prefill {s['prefill_ms']} "
            f"ms, decode {s['decode_ms_per_step']} ms a step (one device "
            f"{s['one_device_prefill_ms']:.1f}, "
            f"{s['one_device_decode_ms_per_step']:.2f}); prefill logits max "
            f"|err| {s['prefill_max_abs_err']:.3g} (tol {s['tol']:.3g}); "
            f"{s['close_calls']} close calls in {s['tokens_compared']} "
            f"tokens; peak {s['peak_gb']} GB (one device "
            f"{s['one_device_peak_gb']:.2f})")
    return out


# --------------------------------------------------------------------------
# phase 12: the other model families
# --------------------------------------------------------------------------

#: the lm_families phase, in order: (arch, cuts, batch, prompt lengths
#: (shortest, longest), new tokens, t_max).  A cut names ModelConfig
#: fields (``n_experts``: the MoE config's); every width is published
FAMILY_RUNS = (
    ("deepseek-moe-16b", {}, 8, (128, 512), 32, 1024),
    ("minicpm-2b", {}, 8, (128, 512), 32, 1024),
    ("starcoder2-7b", {}, 2, (4200, 4600), 16, 4864),
    ("llava-next-mistral-7b", {}, 8, (128, 512), 32, 1024),
    ("llama4-maverick-400b-a17b", {"n_layers": 4, "n_experts": 8}, 1,
     (8320, 8320), 16, 8448),
    ("llama3-405b", {"n_layers": 2}, 8, (128, 512), 32, 1024),
    ("mistral-large-123b", {"n_layers": 4}, 8, (128, 512), 32, 1024),
    ("whisper-base", {}, 8, (128, 512), 32, 1024),
    ("xlstm-125m", {}, 8, (128, 512), 32, 1024),
)
#: why each cut: one f32 MoE layer of Llama 4 at 128 experts is 64 GB;
#: Llama 3 405B's layers are 12.8 GB each, Mistral Large's 5.5 GB
FAMILY_CUT_WHY = {
    "llama4-maverick-400b-a17b": "4 of 48 layers (2 pair-blocks: pair 1 "
                                 "is global), 8 of 128 experts a MoE layer "
                                 "(one f32 MoE layer at 128 is 64 GB)",
    "llama3-405b": "2 of 126 layers (12.8 GB f32 a layer)",
    "mistral-large-123b": "4 of 88 layers (5.5 GB f32 a layer)",
}
#: the VLM's own traffic beside serve_batch's: B sequences of stub patch
#: embeddings (anyres base grid) + text tokens, then greedy decode steps
VLM_RUN = (2, 576, 64, 16)


def family_cfg(arch, cuts):
    """The published config of ``arch`` with ``cuts`` applied; every
    field the cuts do not name is checked equal to the published one."""
    import dataclasses
    from repro_torch import configs
    full = configs.get(arch)
    cfg = full
    if "n_experts" in cuts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=cuts["n_experts"]))
    cfg = dataclasses.replace(
        cfg, **{k: v for k, v in cuts.items() if k != "n_experts"})
    for f in dataclasses.fields(full):
        if f.name not in cuts and f.name != "moe" and \
                getattr(cfg, f.name) != getattr(full, f.name):
            raise AssertionError(f"lm_families: {arch} {f.name} changed")
    return full, cfg


def _attn_layers(cfg):
    """B5 launches of a prefill and of one decode step."""
    if cfg.family == "ssm":
        return 0, 0
    if cfg.family == "encdec":   # encoder self; decoder self + cross
        return cfg.encoder_layers + 2 * cfg.n_layers, 2 * cfg.n_layers
    return cfg.n_layers, cfg.n_layers


def _family_b5_checks(dev, cfg, b, plen, max_new, t_max):
    """B5 at the model's own shapes, before its weights load: the
    prefill, the last decode step over the cache's written prefix, and
    (Llama 4) the global layer's prefill, (Whisper) the encoder and the
    cross-attention of prefill and decode."""
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    last = plen + max_new - 1
    masks = dict(window=cfg.window, chunk=cfg.chunk)
    cases = {"prefill": (plen, plen, dict(masks, q_offset=0), t_max),
             "decode": (1, last + 1, dict(masks, q_offset=last), t_max)}
    if cfg.global_every:
        cases["prefill_global"] = (plen, plen, dict(window=cfg.window,
                                                    q_offset=0), t_max)
    if cfg.family == "encdec":
        cases["encoder"] = (plen, plen, dict(masks, causal=False), None)
        cases["cross_decode"] = (1, plen, dict(masks, causal=False,
                                               q_offset=last), None)
    out = {}
    for i, (name, (tq, tk, kw, slots)) in enumerate(cases.items()):
        q, k, v = b5_inputs(dev, 50 + i, b, tq, tk, hq, hkv, d, slots)
        path, _, err, tol, _ = b5_check(f"{cfg.name}/{name}", q, k, v, **kw)
        out[name] = dict(path=path, max_abs_err=err, tol=tol,
                         shape={"B": b, "Tq": tq, "Tk": tk, "Hq": hq,
                                "Hkv": hkv, "D": d, **kw})
        del q, k, v
    return out


def _family_b4_check(dev, cfg, b, plen):
    """B4 at the recurrent stack's prefill shape (a from the sLSTM's
    exponential gate: exp(-exp(-f)))."""
    import torch
    from repro_torch.kernels import ref, ssm_scan
    shape = (b, plen, cfg.d_inner_mult * cfg.d_model)
    g = torch.Generator(device=dev).manual_seed(41)
    a = torch.exp(-torch.exp(-(torch.randn(shape, generator=g, device=dev)
                               + 2.0)))
    x = torch.randn(shape, generator=g, device=dev)
    err, tol = _check_float(f"{cfg.name}/prefill", "ssm_scan",
                            ssm_scan.ssm_scan_cuda(a, x),
                            ref.ssm_scan_ref(a, x))
    return {"prefill": dict(max_abs_err=err, tol=tol,
                            shape=dict(zip("BTD", shape)))}


def _free_cuda():
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _logits_gate(what, dec, ref_last):
    """Decode logits within LOGIT_TOL · max(1, max |logits|) of the full
    forward's, and the same argmax where the top-2 margin exceeds it."""
    import torch
    if not bool(torch.isfinite(dec).all()):
        raise AssertionError(f"lm_families {what}: non-finite logits")
    err = max_abs_err(dec, ref_last)
    tol = LOGIT_TOL * max(1.0, float(ref_last.abs().max()))
    if err > tol:
        raise AssertionError(f"lm_families {what}: decode logits differ "
                             f"from the full forward (max |err| {err} > "
                             f"{tol})")
    top2 = torch.topk(ref_last, 2, -1).values
    clear = (top2[:, 0] - top2[:, 1]) > tol
    if not bool((dec.argmax(-1) == ref_last.argmax(-1))[clear].all()):
        raise AssertionError(f"lm_families {what}: argmax differs from the "
                             f"full forward on a clear row")
    return dict(logit_max_abs_err=err, logit_tol=tol,
                argmax_checked=int(clear.sum()), rows=int(len(dec)))


def _padded(prompts, plen):
    import numpy as np
    out = np.zeros((len(prompts), plen), np.int64)
    for i, p in enumerate(prompts):
        out[i, plen - len(p):] = p
    return out


def _full_forward_gate(what, params, cfg, prompts, plen, out, last_logits,
                       dev):
    """A full forward (no cache) over prompt + generated tokens ends
    where the last decode step did."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    full_tokens = torch.from_numpy(
        np.concatenate([_padded(prompts, plen), out], 1)).to(dev)
    enc = None
    if cfg.family == "encdec":
        enc = torch.zeros((len(prompts), plen, cfg.d_model), device=dev)
    (full, _), ms = wall(lambda: T.forward(params, cfg, full_tokens,
                                           enc_embeds=enc))
    ref_last = full[:, -1].clone()
    del full
    return {**_logits_gate(what, last_logits, ref_last),
            "full_forward_ms": ms}


def _moe_drops(params, cfg, prompts, plen, out, t_max, dev):
    """Dropped choices per MoE layer of the served run: its prefill and
    its decode steps teacher-forced on the served tokens (the same
    routing: the products are deterministic).  The prefill's drops are
    split by position: the left padding's (token 0) and the prompts'."""
    import torch
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as T
    b = len(prompts)
    cache = T.init_cache(cfg, b, t_max, device=dev)
    tokens = torch.from_numpy(_padded(prompts, plen)).to(dev)
    _, aux, cache = T.forward(params, cfg, tokens, cache=cache,
                              return_aux=True)
    lens = torch.tensor([len(p) for p in prompts], device=dev)
    pad = (torch.arange(plen, device=dev)[None, :]
           < (plen - lens)[:, None])[:, :, None]          # (B, S, 1)
    prefill = torch.stack([m.sum() for m in aux.dropped])
    at_pad = torch.stack([(m & pad).sum() for m in aux.dropped])
    decode = torch.zeros_like(prefill)
    out_t = torch.from_numpy(out).to(dev)
    for i in range(out.shape[1]):
        _, aux, cache = T.forward(params, cfg, out_t[:, i:i + 1],
                                  cache=cache, return_aux=True)
        decode += torch.stack([m.sum() for m in aux.dropped])
    del cache, aux
    k = cfg.moe.top_k
    return dict(
        capacity_factor=cfg.moe.capacity_factor,
        cap_prefill=moe_mod.capacity(b * plen, cfg),
        cap_decode=moe_mod.capacity(b, cfg),
        choices_prefill=b * plen * k,
        choices_prefill_at_pad=int(pad.sum()) * k,
        choices_decode=b * k * out.shape[1],
        dropped_prefill_by_layer=prefill.tolist(),
        dropped_prefill_at_pad_by_layer=at_pad.tolist(),
        dropped_decode_by_layer=decode.tolist())


def phase_lm_families(dev, data):
    """Every other model family served through ``serve_batch`` at its
    published widths (``FAMILY_RUNS``; depth or experts cut only where
    one card cannot hold the model, ``FAMILY_CUT_WHY``), f32, random
    weights from a seeded generator on the card, greedy decoding."""
    import numpy as np
    from repro_torch.kernels import ops
    out = {"models": {}, "power": nvidia_smi()}
    launches = dict.fromkeys(ops.launch_counts(), 0)
    paths = {}
    t0 = time.perf_counter()
    rng = np.random.default_rng(24)
    for arch, cuts, b, lengths, max_new, t_max in FAMILY_RUNS:
        res = _family_run(dev, rng, arch, cuts, b, lengths, max_new, t_max)
        out["models"][arch] = res
        for counts in res["launch_sets"]:
            for k, v in counts["launches"].items():
                launches[k] += v
            for k, v in counts["b5_paths"].items():
                paths[k] = paths.get(k, 0) + v
    out["launches"], out["b5_paths"] = launches, paths
    out["seconds"] = time.perf_counter() - t0
    log(f"lm_families launches {launches}, B5 paths {paths} "
        f"({out['seconds']:.1f} s)")
    return out


def family_prompts(rng, cfg, b, lengths):
    """``b`` prompts of ``lengths`` (shortest, longest) tokens drawn from
    ``rng``, the first of the longest (the batch pads to it)."""
    lo, plen = lengths
    lens = rng.integers(lo, plen + 1, b)
    lens[0] = plen
    return [rng.integers(1, cfg.vocab, n) for n in lens]


def _family_run(dev, rng, arch, cuts, b, lengths, max_new, t_max):
    """One model of the phase: its kernels at its shapes, then serving,
    the launch counts, the token range and decode against a full
    forward; MoE drops; the VLM's embeds path; DeepSeek's profile."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    full, cfg = family_cfg(arch, cuts)
    plen = lengths[1]
    prompts = family_prompts(rng, cfg, b, lengths)
    lens = np.array([len(p) for p in prompts])
    _free_cuda()
    checks = (_family_b4_check(dev, cfg, b, plen) if cfg.family == "ssm"
              else _family_b5_checks(dev, cfg, b, plen, max_new, t_max))
    _free_cuda()
    torch.cuda.reset_peak_memory_stats()
    params, init_ms = wall(lambda: T.init_params(cfg, seed=0, device=dev))
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    weights_gb = sum(x.numel() * x.element_size()
                     for x in _leaves(params)) / 1e9

    def run(n_new, ps=prompts, run_cfg=cfg):
        reqs = [serve.Request(p, n_new) for p in ps]
        stats = serve.serve_batch(run_cfg, reqs, t_max=t_max, device=dev,
                                  params=params)
        return np.array([r.out for r in reqs]), stats
    run(2)                             # warm-up: cuBLAS handles, clocks
    torch.cuda.reset_peak_memory_stats()
    with Counted() as c:
        tokens, stats = run(max_new)
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_pre, n_dec = _attn_layers(cfg)
    want = {"flash_attention": n_pre + n_dec * max_new,
            "ssm_scan": cfg.n_layers if cfg.family == "ssm" else 0}
    want_paths = {"prefill_tc": n_pre, "decode_split": n_dec * max_new,
                  "wide_simt": 0, "wide_chunk": 0}
    for name, n in c.counts.items():
        if n != want.get(name, 0):
            raise AssertionError(f"lm_families {arch}: {name} launched {n} "
                                 f"times, expected {want.get(name, 0)}")
    if c.b5_paths != want_paths:
        raise AssertionError(f"lm_families {arch}: B5 went {c.b5_paths}, "
                             f"expected {want_paths}")
    if tokens.shape != (b, max_new) or tokens.min() < 0 \
            or tokens.max() >= cfg.padded_vocab:
        raise AssertionError(f"lm_families {arch}: tokens {tokens.shape}, "
                             f"range [{tokens.min()}, {tokens.max()}]")
    res = dict(
        arch=arch, cuts=cuts, cut_why=FAMILY_CUT_WHY.get(arch, "none"),
        family=cfg.family,
        widths=dict(layers=cfg.n_layers, d_model=cfg.d_model,
                    heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.hd, d_ff=cfg.d_ff, vocab=cfg.vocab,
                    padded_vocab=cfg.padded_vocab, window=cfg.window,
                    chunk=cfg.chunk, moe=dataclasses.asdict(cfg.moe)
                    if cfg.moe else None),
        param_count=cfg.param_count(),
        active_param_count=cfg.active_param_count(),
        published_param_count=full.param_count(),
        weights_gb=weights_gb, batch=b,
        prompt_lengths=[int(x) for x in lens], max_new=max_new,
        t_max=t_max, init_ms=init_ms, init_peak_gb=init_peak,
        prefill_ms=stats["prefill_s"] * 1e3,
        decode_ms_per_step=stats["decode_s"] * 1e3 / max_new,
        tok_per_s=stats["tok_per_s"], peak_gb=peak,
        pad_ids_emitted=int((tokens >= cfg.vocab).sum()),
        launches=c.counts, b5_paths=c.b5_paths, kernel_checks=checks)
    launch_sets = [dict(launches=c.counts, b5_paths=c.b5_paths)]
    if cfg.family == "moe":
        m = cfg.moe
        res["drops"] = _moe_drops(params, cfg, prompts, plen, tokens, t_max,
                                  dev)
        exact = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=m.n_experts / m.top_k))
        sub = prompts[:2]
        sub_tokens, sub_stats = run(max_new, sub, exact)
        res["decode_check"] = dict(
            capacity_factor=exact.moe.capacity_factor, sequences=len(sub),
            **_full_forward_gate(arch, params, exact, sub, plen, sub_tokens,
                                 sub_stats["last_logits"], dev))
    else:
        res["decode_check"] = _full_forward_gate(
            arch, params, cfg, prompts, plen, tokens, stats["last_logits"],
            dev)
    if cfg.family == "vlm":
        res["vlm"] = _vlm_run(dev, params, cfg, rng)
        launch_sets.append(res["vlm"])
    if arch == "deepseek-moe-16b":
        res["profile"] = _family_profile(params, cfg, prompts, plen, tokens,
                                         t_max, dev)
    if arch in MA_FAMILY_REFS:
        res["model_axis_ref"] = _ma_family_reference(
            params, cfg, prompts, tokens, dict(
                prefill_ms=res["prefill_ms"], peak_gb=peak,
                decode_ms_per_step=res["decode_ms_per_step"]), dev,
            MA_FAMILY_REFS[arch])
    del params
    _free_cuda()
    res["seconds"] = time.perf_counter() - t_start
    res["launch_sets"] = launch_sets
    dc = res["decode_check"]
    drops = ""
    if "drops" in res:
        d = res["drops"]
        n_moe = len(d["dropped_prefill_by_layer"])
        drops = (f"; dropped at cf {d['capacity_factor']}: prefill "
                 f"{sum(d['dropped_prefill_by_layer'])}/"
                 f"{d['choices_prefill'] * n_moe} (at pad positions "
                 f"{sum(d['dropped_prefill_at_pad_by_layer'])}/"
                 f"{d['choices_prefill_at_pad'] * n_moe})"
                 f", decode {sum(d['dropped_decode_by_layer'])}/"
                 f"{d['choices_decode'] * n_moe}")
    log(f"lm_families {arch} ({cfg.family}; cuts {cuts or 'none'}): "
        f"{cfg.param_count() / 1e9:.2f} B params ({weights_gb:.1f} GB), "
        f"B={b} prompts {int(lens.min())}-{plen}, {max_new} new: prefill "
        f"{res['prefill_ms']:.1f} ms, decode {res['decode_ms_per_step']:.2f}"
        f" ms/step, {res['tok_per_s']:.1f} tok/s, peak {peak:.1f} GB (init "
        f"{init_peak:.1f}); decode vs full forward max|err| "
        f"{dc['logit_max_abs_err']:.3g} (tol {dc['logit_tol']:.3g}), "
        f"{res['pad_ids_emitted']} pad ids{drops}; {res['seconds']:.1f} s "
        f"[{nvidia_smi()}]")
    return res


def _vlm_run(dev, params, cfg, rng):
    """LLaVA's image path: stub patch embeddings (seeded normal) + text
    tokens through ``forward(embeds=)`` into the cache, greedy decode
    steps, and the last step against a full forward over everything."""
    import torch
    from repro_torch.models import transformer as T
    b, n_patch, n_text, n_new = VLM_RUN
    g = torch.Generator(device=dev).manual_seed(24)
    patches = torch.randn((b, n_patch, cfg.d_model), generator=g,
                          device=dev)
    text = torch.from_numpy(rng.integers(1, cfg.vocab, (b, n_text))).to(dev)
    cache = T.init_cache(cfg, b, n_patch + n_text + n_new, device=dev)
    outs = []
    with Counted() as c:
        t0 = time.perf_counter()
        logits, cache = T.forward(params, cfg, text, embeds=patches,
                                  cache=cache)
        tok = logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(n_new):
            outs.append(tok)
            logits, cache = T.decode_step(params, cfg, tok[:, None], cache)
            tok = logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    want = {"prefill_tc": cfg.n_layers, "decode_split": cfg.n_layers * n_new,
            "wide_simt": 0, "wide_chunk": 0}
    if c.b5_paths != want:
        raise AssertionError(f"lm_families vlm: B5 went {c.b5_paths}, "
                             f"expected {want}")
    last = logits[:, -1].clone()
    del cache, logits
    full, _ = T.forward(params, cfg, torch.cat([text, torch.stack(outs, 1)],
                                               1), embeds=patches)
    ref_last = full[:, -1].clone()
    del full
    return dict(batch=b, patches=n_patch, text=n_text, new=n_new,
                prefill_ms=(t1 - t0) * 1e3,
                decode_ms_per_step=(t2 - t1) * 1e3 / n_new,
                launches=c.counts, b5_paths=c.b5_paths,
                **_logits_gate("vlm embeds", last, ref_last))


def _family_profile(params, cfg, prompts, plen, tokens, t_max, dev):
    """One warm prefill and one warm decode step (at the last served
    position) under ``torch.profiler``."""
    import torch
    from repro_torch.models import transformer as T
    cache = T.init_cache(cfg, len(prompts), t_max, device=dev)
    prompt_t = torch.from_numpy(_padded(prompts, plen)).to(dev)
    last = torch.from_numpy(tokens[:, -1:]).to(dev)
    last_pos = plen + tokens.shape[1] - 1
    cells = {"prefill": lambda: T.forward(params, cfg, prompt_t,
                                          cache={**cache, "pos": 0}),
             "decode": lambda: T.decode_step(params, cfg, last,
                                             {**cache, "pos": last_pos})}
    out = {name: profile_cell(f"{cfg.name} {name}", fn)
           for name, fn in cells.items()}
    del cache
    return out


# --------------------------------------------------------------------------
# train: one card's training step (xLSTM-125M)
# --------------------------------------------------------------------------

#: the train phase's model and traffic: xLSTM-125M at its published size,
#: the reference's real-hardware setting (``examples/train_lm.py``:
#: ``--full --seq 1024``; batch 8 is ``train``'s default), 30 steps
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "xlstm-125m", 8, 1024, 30
#: warm steps start here (the first ones meet cuBLAS's handles and the
#: allocator cold)
TRAIN_WARM_FROM = 2
#: accumulation with full remat: (batch, accum_steps, steps)
TRAIN_ACCUM = (32, 4, 3)
#: the CUDA-against-CPU smoke steps: (batch, seq, steps, lr schedule)
TRAIN_SMOKE = (8, 128, 3, (3e-3, 2, 10))
#: the attention path's full-size run: Zamba2-2.7B (the lm_serve model;
#: 54 Mamba2 layers and 3 applications of the shared attention block) at
#: B = 8 × 1,024 with ``remat="full"`` (without remat its Mamba2
#: activations alone would need ≈81 GB), ZAMBA_STEPS steps: over 10 the
#: loss first rises from the random init's (204 → above it, 143 at step
#: 9), so the mean of the last 5 is not yet below the first
ZAMBA_ARCH, ZAMBA_REMAT, ZAMBA_STEPS = "zamba2-2.7b", "full", 20
#: the smoke comparison's archs: every family with attention, and xLSTM
TRAIN_SMOKE_ARCHS = ("xlstm-125m", "zamba2-2.7b", "minicpm-2b",
                     "starcoder2-7b", "llava-next-mistral-7b",
                     "llama3-405b", "mistral-large-123b", "deepseek-moe-16b",
                     "llama4-maverick-400b-a17b", "whisper-base")
#: the smoke comparison's tolerances, as the CPU tests state them
#: (``tests/test_torch_train.py``): loss and grad norm 1e-4; Δp within 1%
#: of the step's lr; AdamW entries whose gradient is nonzero but below
#: 1e-4 of the leaf's largest masked (their sign is unknown), at most
#: this share of them
TRAIN_GRAD_TOL, TRAIN_MASKED_SHARE = 1e-4, 0.15


class _PlainCalls:
    """Counts calls of B4's and B5's plain versions through their
    wrappers' modules (``ssm_scan.ssm_scan_plain``; B5's forward, lse and
    backward) while active: a CUDA run must make none."""

    NAMES = (("ssm_scan", "ssm_scan_plain"),
             ("flash_attention", "flash_attention_plain"),
             ("flash_attention", "attention_lse_plain"),
             ("flash_attention", "attention_backward_plain"))

    def __enter__(self):
        import importlib
        self.calls, self._orig = 0, []
        for mod_name, attr in self.NAMES:
            mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
            orig = getattr(mod, attr, None)
            if orig is None:    # a parent tree without B5's backward
                continue
            self._orig.append((mod, attr, orig))

            def counted(*a, _orig=orig, **kw):
                self.calls += 1
                return _orig(*a, **kw)
            setattr(mod, attr, counted)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self._orig:
            setattr(mod, attr, orig)
        return False


def _train_gate(ok, what):
    if not ok:
        raise AssertionError(f"train: {what}")


def phase_train(dev):
    """One card's training step through ``repro_torch.launch.train``:
    B4's and B5's backwards held against autograd through their plain
    versions (not counted), the kernel path against the CPU on every
    family's smoke config, xLSTM-125M at full size for ``TRAIN_STEPS``
    steps, its resume from a checkpoint (and Zamba2-2.7B's smoke
    config's), Zamba2-2.7B for ``ZAMBA_STEPS`` (timed, profiled),
    accumulation with remat, and remat against none."""
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    out = {"power": nvidia_smi(),
           "b4_backward": _train_b4_backward(dev)}
    _free_cuda()
    out["b5_backward"] = _train_b5_backward(dev)
    launches = dict.fromkeys(ops.launch_counts(), 0)
    for name, fn in (("smoke_parity", _train_smoke_parity),
                     ("full", _train_full),
                     ("resume", lambda d: _train_resume(
                         d, out["full"]["losses"])),
                     ("zamba2_full", lambda d: _train_full(
                         d, arch=ZAMBA_ARCH, steps=ZAMBA_STEPS,
                         remat=ZAMBA_REMAT)),
                     ("accum_remat", _train_accum),
                     ("remat_pair", _train_remat_pair)):
        _free_cuda()
        res = fn(dev)
        out[name] = res
        for k, v in res["launches"].items():
            launches[k] += v
    _train_gate(launches["flash_attention_backward"] > 0,
                "B5's backward never launched")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    log(f"train launches {launches} ({out['seconds']:.1f} s)")
    return out


def b4_backward_rows():
    """B4's backward rows: xLSTM's training shape (8, 1024, 1536) and an
    odd T, (2, 37, 1536)."""
    from repro_torch import configs
    cfg = configs.get(TRAIN_ARCH)
    d = cfg.d_inner_mult * cfg.d_model
    return (("train", (TRAIN_BATCH, TRAIN_SEQ, d)), ("odd_t", (2, 37, d)))


def _train_b4_backward(dev):
    """``ScanFn`` (B4 forward, B4 backward) against autograd through the
    plain scan on the same CUDA tensors, max |err| <= FLOAT_TOL · max
    |plain| for da and db; the backward (``scan_backward``: three flips,
    one B4 launch, one product) timed with the host hidden and L2
    flushed beside its byte bound (a, g and h read, da and db written:
    20 B an element), the B4 launch inside it alone, and the plain
    version's backward."""
    import torch
    from repro_torch.kernels import ops, ref, ssm_scan
    out = {}
    for name, shape in b4_backward_rows():
        a, b = b4_inputs(dev, shape)
        g = torch.randn(shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(5))
        al, bl = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        before = ssm_scan.ssm_scan_cuda.launches
        with _PlainCalls() as plain:
            h = ops.ssm_scan(al, bl)
            da, db = torch.autograd.grad(h, (al, bl), g)
        n_launch = ssm_scan.ssm_scan_cuda.launches - before
        _train_gate(n_launch == 2 and plain.calls == 0,
                    f"ScanFn at {shape}: {n_launch} B4 launches, "
                    f"{plain.calls} plain calls (want 2, 0)")
        hp = ref.ssm_scan_ref(al, bl)
        want = torch.autograd.grad(hp, (al, bl), g, retain_graph=True,
                                   allow_unused=True, materialize_grads=True)
        errs = {}
        for what, got, w in (("da", da, want[0]), ("db", db, want[1])):
            err = max_abs_err(got, w)
            tol = FLOAT_TOL * float(w.abs().max())
            _train_gate(bool(torch.isfinite(got).all()) and err <= tol,
                        f"ScanFn {what} at {shape}: max |err| {err} > {tol}")
            errs[what] = dict(max_abs_err=err, tol=tol)
        hd = h.detach()
        n = a.numel()
        bound, by_what = _bound(20.0 * n, 3.0 * n)

        def backward(a=a, h=hd, g=g):
            return ssm_scan.scan_backward(a, h, g)
        a_rev = torch.cat([torch.zeros_like(a[:, :1]), a[:, 1:].flip(1)], 1)
        g_rev = g.flip(1).contiguous()
        ms = time_ms(backward, 20, hide_host=True)
        cold = time_cold_ms(backward, 10)
        scan_ms = time_ms(lambda: ssm_scan.ssm_scan_cuda(a_rev, g_rev), 20,
                          hide_host=True)
        plain_ms = time_ms(lambda: torch.autograd.grad(
            hp, (al, bl), g, retain_graph=True, allow_unused=True), 5)
        out[name] = dict(
            shape=dict(zip("BTD", shape)), launches=n_launch,
            max_abs_err=max(e["max_abs_err"] for e in errs.values()),
            tol=min(e["tol"] for e in errs.values()), by_grad=errs,
            ms=ms, cold_ms=cold, scan_ms=scan_ms, plain_ms=plain_ms,
            library_ms=None, bound_ms=bound, bound_by=by_what,
            bytes=20.0 * n, bound_share=bound / ms,
            cold_bound_share=bound / cold)
        log(f"{'ssm_scan':>16} backward {name}: {ms:.4f} ms (cold L2 "
            f"{cold:.4f}; its B4 launch {scan_ms:.4f}), {plain_ms:.4f} ms "
            f"plain, bound {bound:.4f} ms ({by_what}, "
            f"{100 * bound / ms:.1f}%), max|err| da "
            f"{errs['da']['max_abs_err']:.3g} (tol {errs['da']['tol']:.3g}), "
            f"db {errs['db']['max_abs_err']:.3g} (tol "
            f"{errs['db']['tol']:.3g})")
        del a, b, g, al, bl, h, hd, da, db, hp, want, a_rev, g_rev
    return out


#: B5's backward rows: each attention family's training shape, (arch,
#: B, Tq, Tk, mask keywords) with the arch's heads, head dim and window or
#: chunk, or (None, B, Tq, Tk, Hq, Hkv, D, mask keywords).  B = 8 × 1,024
#: (``train``'s default batch at the reference's 1,024 tokens), but
#: StarCoder2 at 1 × 4,600 (its 4,096 window binds) and Llama 4 at 1 ×
#: 8,320 (its 8,192 chunk is crossed; a global layer drops the chunk);
#: Whisper's encoder (non-causal, 1,024 frames) and its decoder's
#: cross-attention (256 tokens over the 1,024 frames: ``data_config``'s
#: ``max(seq // 4, 16)`` decoder tokens); and an odd small shape
B5_TRAIN_ROWS = {
    "zamba2": ("zamba2-2.7b", 8, 1024, 1024, {}),
    "minicpm": ("minicpm-2b", 8, 1024, 1024, {}),
    "deepseek": ("deepseek-moe-16b", 8, 1024, 1024, {}),
    "starcoder2_window": ("starcoder2-7b", 1, 4600, 4600, {}),
    "llama4_chunk": ("llama4-maverick-400b-a17b", 1, 8320, 8320, {}),
    "llama4_global": ("llama4-maverick-400b-a17b", 1, 8320, 8320,
                      {"chunk": None}),
    "whisper_encoder": ("whisper-base", 8, 1024, 1024, {"causal": False}),
    "whisper_cross": ("whisper-base", 8, 256, 1024, {"causal": False}),
    "odd": (None, 2, 37, 53, 6, 2, 33, {"window": 20, "q_offset": 16}),
}


def b5_train_shape(row):
    """``(b, tq, tk, hq, hkv, d, mask keywords)`` of a ``B5_TRAIN_ROWS``
    row."""
    from repro_torch import configs
    if row[0] is None:
        return row[1:]
    arch, b, tq, tk, extra = row
    cfg = configs.get(arch)
    kw = {"causal": True, "window": cfg.window or None,
          "chunk": cfg.chunk or None, "q_offset": 0, **extra}
    return b, tq, tk, cfg.n_heads, cfg.n_kv_heads, cfg.hd, kw


def _kv_blocks(b, tq, tk, hq, hkv, budget=16e9):
    """Blocks of kv heads whose plain autograd (≈10 (B, group, Tq, Tk)
    f32 tensors) stays within ``budget`` bytes."""
    group = hq // hkv
    per = max(1, int(budget // (40 * b * group * tq * max(tk, 1))))
    return [(lo, min(hkv, lo + per)) for lo in range(0, hkv, per)]


def _grads_by_kv_blocks(q, k, v, grads_of):
    """``(dq, dk, dv)`` assembled over blocks of kv heads
    (:func:`_kv_blocks`); ``grads_of(qs, lo, hi)`` gives a block's, for
    the q heads ``qs`` (a slice) and the kv heads ``lo … hi - 1``."""
    import torch
    b, tq, hq, _ = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    out = [torch.empty_like(x) for x in (q, k, v)]
    for lo, hi in _kv_blocks(b, tq, tk, hq, hkv):
        qs = slice(lo * g, hi * g)
        for dst, x, heads in zip(out, grads_of(qs, lo, hi),
                                 (qs, slice(lo, hi), slice(lo, hi))):
            dst[:, :, heads] = x
    return tuple(out)


def attention_grad_blocked(q, k, v, do, **kw):
    """Autograd through ``ref.attention_ref``, a block of kv heads at a
    time."""
    import torch
    from repro_torch.kernels import ref

    def grads_of(qs, lo, hi):
        leaves = [x.detach().requires_grad_(True)
                  for x in (q[:, :, qs], k[:, :, lo:hi], v[:, :, lo:hi])]
        return torch.autograd.grad(ref.attention_ref(*leaves, **kw), leaves,
                                   do[:, :, qs])
    return _grads_by_kv_blocks(q, k, v, grads_of)


def attention_backward_plain_blocked(q, k, v, o, lse, do, **kw):
    """B5's plain backward (``ref.attention_backward_ref``), a block of
    kv heads at a time, as the forward's ``attention_plain_blocked``."""
    from repro_torch.kernels import ref
    return _grads_by_kv_blocks(q, k, v, lambda qs, lo, hi: (
        ref.attention_backward_ref(
            q[:, :, qs], k[:, :, lo:hi], v[:, :, lo:hi], o[:, :, qs],
            lse[:, qs], do[:, :, qs], **kw)))


def _sdpa_backward(q, k, v, do, **kw):
    """The library yardstick: autograd of
    ``F.scaled_dot_product_attention`` in f32 (:func:`_sdpa`'s mask, k
    and v expanded to the q heads so that no GQA path is needed), as a
    zero-argument call of its backward alone."""
    import torch
    group = q.shape[2] // k.shape[2]
    leaves = [x.detach().clone().requires_grad_(True) for x in
              (q, k.repeat_interleave(group, 2), v.repeat_interleave(group, 2))]
    out = _sdpa(*leaves, **kw)()
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)


def _train_b5_backward(dev):
    """B5's backward at ``B5_TRAIN_ROWS`` (:func:`b5_backward_rows`)."""
    return b5_backward_rows(dev, B5_TRAIN_ROWS, 40)


def b5_backward_rows(dev, rows, seed0, wide=False):
    """``AttnFn`` (B5 forward writing lse, B5's backward) at ``rows``
    against autograd through ``ref.attention_ref`` on
    the same CUDA tensors, max |err| <= FLOAT_TOL · max |plain| for dq,
    dk and dv; one forward launch, one backward (its three kernels once
    each), no plain call.  The forward's output bit for bit the same
    with and without lse, two backward calls bit for bit equal.  The
    backward timed with the host hidden and with L2 flushed, each
    kernel apart, beside its bound (the five T²·D products over the
    visible pairs at three TF32 tensor-core passes, as ``kernel_b5``
    states prefill_tc's, or its bytes: q, k, v, o, dO, lse read, dq, dk,
    dv written; ``bound_simt_ms`` keeps the FP32 SIMT figure, the bound
    itself for the ``wide`` rows, whose forward and backward run the f32
    SIMT ``wide_simt`` route, one launch of it each, gated), the plain
    backward (over kv-head blocks) and SDPA's backward."""
    import torch
    from repro_torch.kernels import flash_attention as fa, ops
    out = {}
    for i, (name, row) in enumerate(rows.items()):
        b, tq, tk, hq, hkv, d, kw = b5_train_shape(row)
        q, k, v = b5_inputs(dev, seed0 + i, b, tq, tk, hq, hkv, d)
        do = torch.randn(q.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(seed0 + 20 + i))
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        fwd0 = fa.flash_attention_cuda.launches
        bwd0 = fa.attention_backward_cuda.launches
        per0 = dict(fa.attention_backward_cuda.by_kernel)
        route = wide if isinstance(wide, str) else "wide_simt"
        wide0 = (fa.flash_attention_cuda.by_path[route],
                 fa.attention_backward_cuda.by_path[route])
        with _PlainCalls() as plain:
            o = ops.flash_attention(*leaves, **kw)
            grads = torch.autograd.grad(o, leaves, do)
        launches = dict(
            forward=fa.flash_attention_cuda.launches - fwd0,
            backward=fa.attention_backward_cuda.launches - bwd0,
            **{n: c - per0[n]
               for n, c in fa.attention_backward_cuda.by_kernel.items()})
        wide_launches = (fa.flash_attention_cuda.by_path[route]
                         - wide0[0],
                         fa.attention_backward_cuda.by_path[route]
                         - wide0[1])
        _train_gate(launches == dict(forward=1, backward=1, rowdot=1, dkdv=1,
                                     dq=1) and plain.calls == 0
                    and wide_launches == ((1, 1) if wide else (0, 0)),
                    f"AttnFn {name}: launches {launches}, {route} "
                    f"{wide_launches}, {plain.calls} plain calls")
        del leaves
        want = attention_grad_blocked(q, k, v, do, **kw)
        errs = {}
        for what, got, w in zip(("dq", "dk", "dv"), grads, want):
            err = max_abs_err(got, w)
            tol = FLOAT_TOL * float(w.abs().max())
            _train_gate(bool(torch.isfinite(got).all()) and err <= tol,
                        f"AttnFn {what} at {name}: max |err| {err} > {tol}")
            errs[what] = dict(max_abs_err=err, tol=tol)
        del want
        o, lse = fa.flash_attention_lse(q, k, v, **kw)
        _train_gate(torch.equal(o, fa.flash_attention_cuda(q, k, v, **kw)),
                    f"{name}: the forward's output changes with lse")
        again = fa.attention_backward_cuda(q, k, v, o, lse, do, **kw)
        _train_gate(all(torch.equal(x, y) for x, y in zip(again, grads)),
                    f"{name}: two backward calls differ")
        del again, grads
        _, launchers = fa.backward_launchers(q, k, v, o, lse, do, **kw)

        def backward(q=q, k=k, v=v, o=o, lse=lse, do=do, kw=kw):
            return fa.attention_backward_cuda(q, k, v, o, lse, do, **kw)
        big = b * hq * tq * tk > 1 << 30
        reps = 3 if big else 10
        ms = time_ms(backward, reps, hide_host=True)
        cold = time_cold_ms(backward, 3 if big else 5)
        kernel_ms = {n: time_ms(fn, reps, hide_host=True)
                     for n, fn in launchers.items()}
        pairs = visible_pairs(tq, tk, **kw)
        ops_ = 2.0 * 5 * b * hq * d * pairs
        nbytes = 4.0 * (4 * b * tq * hq * d + 4 * b * tk * hkv * d
                        + b * hq * tq)
        bound, by_what = (_bound(nbytes, ops_) if wide else
                          _bound(nbytes, 3 * ops_, TF32_TC_FLOPS))
        plain_ms = time_ms(lambda: attention_backward_plain_blocked(
            q, k, v, o, lse, do, **kw), 1 if big else 3)
        try:
            library = _sdpa_backward(q, k, v, do, **kw)
            library_ms, library_error = time_ms(library, reps), None
            del library
        except (RuntimeError, torch.OutOfMemoryError) as e:
            library_ms, library_error = None, str(e)[:200]
        _free_cuda()
        out[name] = dict(
            shape={"B": b, "Tq": tq, "Tk": tk, "Hq": hq, "Hkv": hkv, "D": d,
                   **kw},
            visible_pairs=pairs, launches=launches,
            path=route if wide else "tc",
            max_abs_err=max(e["max_abs_err"] for e in errs.values()),
            tol=min(e["tol"] for e in errs.values()), by_grad=errs,
            ms=ms, cold_ms=cold, kernel_ms=kernel_ms,
            kernel_share={n: t / sum(kernel_ms.values())
                          for n, t in kernel_ms.items()},
            plain_ms=plain_ms, library_ms=library_ms,
            library_call="autograd of F.scaled_dot_product_attention (f32, "
                         "k and v expanded to the q heads), backward only",
            library_error=library_error, bound_ms=bound, bound_by=by_what,
            bound_simt_ms=_bound(nbytes, ops_)[0],
            ops=ops_, bytes=nbytes, bound_share=bound / ms,
            tflops_5=ops_ / ms / 1e9)
        log(f"{'flash_attention':>16} backward {name} {out[name]['shape']}: "
            f"{ms:.4f} ms (cold L2 {cold:.4f}; rowdot "
            f"{kernel_ms['rowdot']:.4f}, dkdv {kernel_ms['dkdv']:.4f}, dq "
            f"{kernel_ms['dq']:.4f}), {plain_ms:.4f} ms plain, SDPA "
            f"backward {library_ms} ms, bound {bound:.4f} ms ({by_what}, "
            f"{100 * bound / ms:.1f}%), max|err| dq "
            f"{errs['dq']['max_abs_err']:.3g} (tol {errs['dq']['tol']:.3g}), "
            f"dk {errs['dk']['max_abs_err']:.3g}, dv "
            f"{errs['dv']['max_abs_err']:.3g}")
        del q, k, v, o, lse, do, launchers
        _free_cuda()
    return out


def _attn_calls(cfg) -> int:
    """B5 calls of one full forward (a training step's forward)."""
    if cfg.family == "hybrid":     # the shared block every k layers
        return cfg.n_layers // cfg.hybrid_attn_every
    return _attn_layers(cfg)[0]


def _recurrent_layers(cfg) -> int:
    """B4 calls of one full forward."""
    return cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0


def _train_smoke_parity(dev):
    """``TRAIN_SMOKE[2]`` AdamW steps of every ``TRAIN_SMOKE_ARCHS``
    smoke config on the card and on the CPU (:func:`_smoke_parity_one`);
    the launches summed over them.  Every step of every family's
    ``masked`` run is gated, and of xLSTM's ``free`` run, as before.  An
    attention family's ``free`` run is gated up to the step at whose end
    a masked entry first moved the other way on the card: that entry's
    2 lr reaches the next step's inputs (on Llama 4's smoke config one
    such flip at step 1 put step 2 1.75% of lr off), so later steps are
    reported only."""
    from repro_torch.kernels import ops
    out = {"launches": dict.fromkeys(ops.launch_counts(), 0)}
    for arch in TRAIN_SMOKE_ARCHS:
        res = _smoke_parity_one(dev, arch)
        flips = res["free"]["flipped"]
        res["free"]["gated_steps"] = len(flips) if arch == TRAIN_ARCH else (
            next((i + 1 for i, n in enumerate(flips) if n), len(flips)))
        res["masked"]["gated_steps"] = len(flips)
        for mode in ("free", "masked"):
            r = res[mode]
            log(f"train smoke {arch} {mode}: {len(flips)} steps card vs "
                f"CPU, losses {[round(x, 4) for x in r['losses']]}, max "
                f"|Δloss| {r['max_err']['loss']:.3g}, |Δgnorm| "
                f"{r['max_err']['grad_norm']:.3g}, Δp "
                f"{100 * r['max_err']['dp_over_lr']:.3f}% of lr, flipped "
                f"{r['flipped']} of {res['masked']['masked_entries']}/"
                f"{res['masked']['entries']} masked; failures "
                f"{r['failures']}, steps 1–{r['gated_steps']} gated")
            fails = [msg for step, msg in r["failures"]
                     if step <= r["gated_steps"]]
            _train_gate(not fails, f"smoke {arch} {mode}: {fails[:1]}")
        out[arch] = res
        for k, v in res["launches"].items():
            out["launches"][k] += v
    return out


def _smoke_parity_one(dev, arch):
    """``TRAIN_SMOKE[2]`` AdamW steps of ``arch``'s smoke config on the
    CPU and twice on the card, from the same weights and batches.  Each
    card run's steps are held to the CPU's at the CPU tests' tolerances:
    loss and grad norm, and the parameter update outside the masked
    entries (a CPU gradient, at this step or before, nonzero but below
    ``TRAIN_GRAD_TOL`` of its leaf's largest: its sign is unknown, and
    AdamW moves such an entry a full lr either way).  ``free``: every
    entry evolves on the card.  ``masked``: before each step after the
    first, the masked entries take the CPU's weights and AdamW moments,
    and every other entry evolves on the card.  Gated here: B4 launched
    forward and backward for each recurrent layer, B5 forward and
    backward for each attention, their plain versions never, and the
    masked share.  Reported per run: the comparison's failures (gated by
    the caller), its worst errors, and per step the masked entries whose
    update took the other sign on the card."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.data import synthetic_stream
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.train import data_config
    from repro_torch.models import transformer as T
    from repro_torch.optimizer import OptConfig, cosine_schedule
    from repro_torch.optimizer.optimizers import tree_leaves, tree_like
    b, seq, n_steps, lr_args = TRAIN_SMOKE
    cfg = configs.get(arch, smoke=True)
    lr = cosine_schedule(*lr_args)
    base = T.init_params(cfg, seed=0, device="cpu")
    it = synthetic_stream(data_config(cfg, batch=b, seq=seq, seed=0))
    batches = [next(it) for _ in range(n_steps)]

    def run(d, cpu=None, sync=False):
        params = tree_like(base, [p.to(d, copy=True).requires_grad_(True)
                                  for p in tree_leaves(base)])
        step_fn, init = steps.make_train_step(cfg, OptConfig(lr=lr),
                                              remat="none")
        state = init(params)
        rows = []
        with Counted() as c, _PlainCalls() as plain:
            for i, bn in enumerate(batches):
                batch = {k: torch.from_numpy(v).to(d) for k, v in bn.items()}
                leaves = tree_leaves(params)
                now = leaves + tree_leaves(state["m"]) + tree_leaves(
                    state["v"])
                row = {}
                if cpu is None:     # the CPU: the mask, each step's start
                    loss, _ = T.loss_fn(params, cfg, batch)
                    gs = [x.abs() for x in torch.autograd.grad(
                        loss, leaves, allow_unused=True,
                        materialize_grads=True)]
                    row["unknown"] = [
                        (rows[-1]["unknown"][j] if rows else False)
                        | ((g > 0) & (g < TRAIN_GRAD_TOL * g.max()))
                        for j, g in enumerate(gs)]
                    row["start"] = [x.detach().clone() for x in now]
                elif sync and i:
                    unknown = cpu["rows"][i - 1]["unknown"]
                    with torch.no_grad():
                        for x, y, u in zip(now, cpu["rows"][i]["start"],
                                           unknown * 3):
                            u = u.to(d)
                            x[u] = y.to(d)[u]
                before = [p.detach().clone() for p in leaves]
                params, state, m = step_fn(params, state, batch)
                row.update(loss=float(m["loss"]),
                           grad_norm=float(m["grad_norm"]),
                           dp=[(p.detach() - q).cpu() for p, q in
                               zip(tree_leaves(params), before)])
                rows.append(row)
        return dict(rows=rows, launches=c.counts, plain=plain.calls)

    cpu = run(torch.device("cpu"))
    attn, rec = _attn_calls(cfg), _recurrent_layers(cfg)
    res = dict(batch=b, seq=seq, steps=n_steps,
               losses_cpu=[r["loss"] for r in cpu["rows"]],
               launches=dict.fromkeys(ops.launch_counts(), 0))
    for mode in ("free", "masked"):
        card = run(dev, cpu, sync=mode == "masked")
        want = {**dict.fromkeys(card["launches"], 0),
                "ssm_scan": 2 * rec * n_steps,
                "flash_attention": attn * n_steps,
                "flash_attention_backward": attn * n_steps}
        _train_gate(card["launches"] == want and card["plain"] == 0,
                    f"smoke {arch} {mode}: launches {card['launches']}, "
                    f"expected {want}; {card['plain']} plain calls")
        for k, v in card["launches"].items():
            res["launches"][k] += v
        worst = {"loss": 0.0, "grad_norm": 0.0, "dp_over_lr": 0.0}
        failures, flipped = [], []
        for i, (rc, rg) in enumerate(zip(cpu["rows"], card["rows"])):
            for key in ("loss", "grad_norm"):
                err = abs(rg[key] - rc[key])
                worst[key] = max(worst[key], err)
                if not (np.isfinite(rg[key])
                        and err <= 1e-4 + 1e-4 * abs(rc[key])):
                    failures.append((i + 1, f"step {i + 1}: {key} {rg[key]} "
                                            f"on the card, {rc[key]} on the "
                                            f"CPU"))
            flips = 0
            for j, (dg, dc, u) in enumerate(zip(rg["dp"], rc["dp"],
                                                rc["unknown"])):
                flips += int((dg.sign() != dc.sign())[u].sum())
                keep = ~u
                err = float((dg - dc).abs()[keep].max()) if keep.any() else 0.0
                worst["dp_over_lr"] = max(worst["dp_over_lr"], err / lr(i + 1))
                if err > 0.01 * lr(i + 1):
                    failures.append((i + 1, f"step {i + 1} leaf {j}: Δp "
                                            f"differs by {err} > 1% of lr "
                                            f"{lr(i + 1)}"))
            flipped.append(flips)
        res[mode] = dict(losses=[r["loss"] for r in card["rows"]],
                         max_err=worst, flipped=flipped, failures=failures)
    unknown = cpu["rows"][-1]["unknown"]
    res["masked"].update(entries=sum(u.numel() for u in unknown),
                         masked_entries=sum(int(u.sum()) for u in unknown))
    masked, total = (res["masked"]["masked_entries"],
                     res["masked"]["entries"])
    _train_gate(masked <= TRAIN_MASKED_SHARE * total,
                f"smoke {arch}: {masked} of {total} entries masked")
    return res


def _train_full(dev, arch=TRAIN_ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                steps=TRAIN_STEPS, remat="none"):
    """``train(arch, smoke=False, ...)`` on the card: finite losses and
    grad norms, the loss falling (the mean of the last 5 below the
    first), B4 launched forward, recomputed under remat and backward
    for each recurrent layer a step, B5 forward (recomputed where remat
    reaches it: not Zamba2's shared block, which runs outside the
    layer scan, as in the reference) and backward for each attention a
    step, their plain versions never; ms a step, tokens/s, peak memory,
    and one warm step profiled (busy share, GEMM ms, B4's and B5's
    forward and backward ms)."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.data import make_train_iterator
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.optimizer import OptConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get(arch)
    torch.cuda.reset_peak_memory_stats()
    hist = []
    with Counted() as c, _PlainCalls() as plain:
        t0 = time.perf_counter()
        params, losses = train_mod.train(
            arch, smoke=False, batch=batch, seq=seq, steps=steps,
            remat=remat, device=dev, history=hist, log_every=10)
        wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    norms = [h["grad_norm"] for h in hist]
    _train_gate(np.isfinite(losses).all() and np.isfinite(norms).all(),
                f"{arch}: non-finite loss or grad norm at full size")
    _train_gate(np.mean(losses[-5:]) < losses[0],
                f"{arch}: loss did not fall: first {losses[0]}, mean of last "
                f"5 {np.mean(losses[-5:])}")
    redo = remat != "none"
    rec, attn = _recurrent_layers(cfg), _attn_calls(cfg)
    attn_redo = redo and cfg.family != "hybrid"
    want = {**dict.fromkeys(c.counts, 0),
            "ssm_scan": steps * rec * (3 if redo else 2),
            "flash_attention": steps * attn * (2 if attn_redo else 1)}
    if attn:                # (a parent tree without B5's backward: none)
        want["flash_attention_backward"] = steps * attn
    _train_gate(c.counts == want and plain.calls == 0,
                f"full {arch}: launches {c.counts} (expected {want}), "
                f"{plain.calls} plain calls")
    warm = [h["ms"] for h in hist[TRAIN_WARM_FROM:]]
    ms = float(np.median(warm))
    tokens = batch * seq
    step_fn, opt_init = steps_mod.make_train_step(cfg, OptConfig(),
                                                  remat=remat)
    opt_state = opt_init(params)
    batch_t = next(make_train_iterator(
        train_mod.data_config(cfg, batch=batch, seq=seq, seed=0),
        device=dev, start_step=steps))
    prof = profile_cell(f"{arch} train step",
                        lambda: step_fn(params, opt_state, batch_t),
                        ordered=("ssm_scan", "flash_attention",
                                 "flash_attention_backward"))
    # B4's events in start order: the forward's recurrent layers, then
    # the backward's (under remat each layer's recompute, then its
    # backward); B5's forward events, then its backward's three kernels
    # a call; a capture that lost events cannot be split
    each = prof.pop("ordered")
    b4, b5f, b5b = (each[k] for k in ("ssm_scan", "flash_attention",
                                      "flash_attention_backward"))
    split = prof["complete"] and len(b4) == rec * (3 if redo else 2)
    prof["b4_forward_ms"] = sum(b4[:rec]) if split else None
    prof["b4_backward_ms"] = (sum(b4[rec + 1::2] if redo else b4[rec:])
                              if split else None)
    prof["b4_recompute_ms"] = sum(b4[rec::2]) if split and redo else None
    full_b5 = prof["complete"] and len(b5b) == 3 * attn
    prof["b5_forward_ms"] = sum(b5f) if full_b5 and attn else None
    prof["b5_backward_ms"] = sum(b5b) if full_b5 and attn else None
    del params, opt_state, batch_t
    res = dict(
        arch=arch, param_count=cfg.param_count(), batch=batch, seq=seq,
        steps=steps, remat=remat, wall_s=wall_s, losses=losses,
        grad_norms=norms, step_ms=[h["ms"] for h in hist],
        ms_per_step=ms, ms_spread=[float(min(warm)), float(max(warm))],
        tok_per_s=tokens / (ms / 1e3), peak_gb=peak, profile=prof,
        launches=c.counts)
    log(f"train full {arch} ({cfg.param_count() / 1e6:.1f} M params, "
        f"B={batch} x {seq}, remat {remat}): {steps} steps, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, {ms:.1f} ms/step (warm "
        f"median; {min(warm):.1f}-{max(warm):.1f}), "
        f"{res['tok_per_s']:.0f} tok/s, peak {peak:.2f} GB; profiled step: "
        f"busy {100 * prof['busy_share']:.0f}%, GEMMs "
        f"{prof['gemm_ms']:.2f} ms, B4 forward {prof['b4_forward_ms']} "
        f"ms, backward {prof['b4_backward_ms']} ms, B5 forward "
        f"{prof['b5_forward_ms']} ms, backward {prof['b5_backward_ms']} ms "
        f"(capture complete: {prof['complete']}) [{nvidia_smi()}]")
    return res


#: the resume entry (ROADMAP A7b): the ``full`` run's xLSTM-125M training
#: with checkpoints (every max(steps // 4, 25) steps: 25 and 30), resumed
#: from 25 alone; and Zamba2-2.7B's smoke config, whose shared attention
#: puts B5's ``AttnFn`` on the resume path: (arch, batch, seq, steps),
#: saves at 25 and 28, resumed from 25
RESUME_AT = 25
RESUME_SMOKE = ("zamba2-2.7b", 8, 128, 28)


def _host_tree(tree):
    """A host copy of a state tree (tensors copied, ints as they are)."""
    return {k: _host_tree(v) if isinstance(v, dict) else
            v.detach().to("cpu", copy=True) if hasattr(v, "detach") else v
            for k, v in tree.items()}


def _tree_diff(got, want, prefix=""):
    """The leaves of two state trees that are not the same bits."""
    import torch
    out = []
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            out += _tree_diff(g, w, f"{prefix}/{k}")
        elif not (torch.equal(g, w) if isinstance(w, torch.Tensor)
                  else g == w):
            out.append(f"{prefix}/{k}")
    return out


class _CkptSpy:
    """While active, wraps ``CheckpointManager.maybe_save`` and
    ``restore_latest`` to record, outside ``train``: each save's stats
    (bytes, snapshot ms, the write's s once it ends) with ``blocked_ms``,
    the caller's whole time in ``maybe_save``; ``writing[s]``, whether a
    write was in flight when ``maybe_save(s)`` returned, so as step ``s``
    began; and of the restore, its seconds, the bytes it allocated on the
    card beyond what was there before (``extra_bytes``), and host copies
    of the tree ``train`` hands it (its freshly built state) and of the
    tree it gets back, taken outside the timed call."""

    def __enter__(self):
        import time
        import torch
        from repro_torch.checkpoint import CheckpointManager
        self._orig = (CheckpointManager.maybe_save,
                      CheckpointManager.restore_latest)
        orig_save, orig_restore = self._orig
        self.saves, self.writing = [], {}
        self.fresh = self.restored = self.restore = None

        def maybe_save(mgr, step, tree, force=False, **kw):
            t0 = time.perf_counter()
            pending = orig_save(mgr, step, tree, force, **kw)
            if pending is not None:
                pending.stats["blocked_ms"] = \
                    (time.perf_counter() - t0) * 1e3
                self.saves.append(pending.stats)
            self.writing[step] = mgr.writing()
            return pending

        def restore(mgr, target, shardings=None, **kw):
            self.fresh = _host_tree(target)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            tree, step = orig_restore(mgr, target, shardings, **kw)
            torch.cuda.synchronize()
            self.restore = {"restore": step,
                            "s": time.perf_counter() - t0,
                            "extra_bytes": torch.cuda.max_memory_allocated()
                            - before}
            self.restored = None if tree is None else _host_tree(tree)
            return tree, step
        CheckpointManager.maybe_save = maybe_save
        CheckpointManager.restore_latest = restore
        return self

    def __exit__(self, *exc):
        from repro_torch.checkpoint import CheckpointManager
        (CheckpointManager.maybe_save,
         CheckpointManager.restore_latest) = self._orig
        return False


def _resume_case(dev, root, arch, *, smoke, batch, seq, steps,
                 plain_losses=None):
    """Run A: ``train(..., ckpt_dir=A, heartbeat_dir=H)`` for ``steps``
    steps (saves at ``RESUME_AT`` and ``steps``); run B: the same call
    on a directory holding only A's ``step_{RESUME_AT}``.  Gates, bit
    for bit: A's losses equal a run without checkpoints (``plain_losses``,
    else run here); B's restored state equals A's checkpoint leaf by leaf
    with its step, and B's freshly built parameters do not; the restore
    is in place (it allocates on the card no more than the state's
    largest leaf, where a copy of the state would double it); B's losses
    equal A's from ``RESUME_AT``, and its final parameters, moments and
    step A's; B4 (and B5) forward and backward launched for every step
    that ran, their plain versions never; the coordinator finds host 0
    alive at A's last step."""
    import shutil
    import numpy as np
    from repro_torch import configs
    from repro_torch.checkpoint import latest_steps, load_checkpoint
    from repro_torch.distributed.fault_tolerance import Coordinator, FTConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    from repro_torch.optimizer.optimizers import tree_leaves
    import torch
    cfg = configs.get(arch, smoke=smoke)
    kw = dict(smoke=smoke, batch=batch, seq=seq, steps=steps, device=dev,
              log_every=10)
    launches = dict.fromkeys(ops.launch_counts(), 0)
    rec, attn = _recurrent_layers(cfg), _attn_calls(cfg)

    def run(n_steps, **more):
        with Counted() as c, _PlainCalls() as plain:
            params, losses = train_mod.train(arch, **kw, **more)
        want = {**dict.fromkeys(c.counts, 0),
                "ssm_scan": n_steps * rec * 2,
                "flash_attention": n_steps * attn,
                "flash_attention_backward": n_steps * attn}
        _train_gate(c.counts == want and plain.calls == 0,
                    f"resume {arch}: launches {c.counts} (expected {want}), "
                    f"{plain.calls} plain calls")
        for k, v in c.counts.items():
            launches[k] += v
        return params, losses

    a_dir, b_dir, hb_dir = root / "a", root / "b", root / "hb"
    if plain_losses is None:
        _, plain_losses = run(steps)
    hist_a = []
    with _CkptSpy() as spy_a:
        params_a, losses_a = run(steps, ckpt_dir=str(a_dir),
                                 heartbeat_dir=str(hb_dir), history=hist_a)
    _train_gate(losses_a == plain_losses,
                f"resume {arch}: losses with checkpoints {losses_a} differ "
                f"from those without {plain_losses}")
    _train_gate(latest_steps(str(a_dir)) == [RESUME_AT, steps],
                f"resume {arch}: checkpoints {latest_steps(str(a_dir))}")
    (host0,) = Coordinator(FTConfig(str(hb_dir)), 1).poll()
    _train_gate(host0.alive and host0.step == steps - 1,
                f"resume {arch}: heartbeat {host0}")
    b_dir.mkdir()
    shutil.copytree(a_dir / f"step_{RESUME_AT}", b_dir / f"step_{RESUME_AT}")
    with _CkptSpy() as spy:
        params_b, losses_b = run(steps - RESUME_AT, ckpt_dir=str(b_dir))
    like = spy.fresh
    saved = load_checkpoint(str(a_dir), RESUME_AT, like)
    diff = (["nothing restored"] if spy.restored is None
            else _tree_diff(spy.restored, saved))
    _train_gate(saved["opt"]["step"] == RESUME_AT and not diff,
                f"resume {arch}: the restored state differs from step "
                f"{RESUME_AT}'s checkpoint at {diff}")
    _train_gate(_tree_diff(like["params"], saved["params"]) != [],
                f"resume {arch}: the fresh parameters equal step "
                f"{RESUME_AT}'s, so the restore proves nothing")
    _train_gate(losses_b == losses_a[RESUME_AT:],
                f"resume {arch}: resumed losses {losses_b} differ from "
                f"{losses_a[RESUME_AT:]}")
    final = _tree_diff(load_checkpoint(str(b_dir), steps, like),
                       load_checkpoint(str(a_dir), steps, like))
    final += [str(i) for i, (x, y) in enumerate(zip(
        tree_leaves(params_b), tree_leaves(params_a)))
        if not torch.equal(x, y)]
    _train_gate(not final, f"resume {arch}: the resumed final state "
                           f"differs at {final}")
    saves = spy_a.saves
    largest = max(x.numel() * x.element_size()
                  for x in tree_leaves(like) if isinstance(x, torch.Tensor))
    _train_gate(spy.restore["extra_bytes"] <= largest,
                f"resume {arch}: the restore allocated "
                f"{spy.restore['extra_bytes']} B on the card, more than "
                f"its largest leaf ({largest} B): not in place")
    warm = hist_a[TRAIN_WARM_FROM:]
    over = [h["ms"] for h in warm if spy_a.writing.get(h["step"])]
    clear = [h["ms"] for h in warm if not spy_a.writing.get(h["step"])]
    res = dict(
        arch=arch, smoke=smoke, batch=batch, seq=seq, steps=steps,
        resume_at=RESUME_AT, state_bytes=saves[0]["bytes"],
        saves=saves, restore=spy.restore, losses=losses_a,
        resumed_losses=losses_b,
        step_ms_writing=float(np.median(over)) if over else None,
        step_ms_clear=float(np.median(clear)), steps_writing=len(over),
        heartbeat_step=host0.step, launches=launches,
        power=nvidia_smi())
    log(f"train resume {arch} ({'smoke' if smoke else 'full'}, B={batch} "
        f"x {seq}, {steps} steps): state {res['state_bytes']} B; saves "
        + "; ".join(f"step {r['step']}: blocked {r['blocked_ms']:.1f} ms "
                    f"(snapshot {r['snapshot_ms']:.1f}), write "
                    f"{r['write_s']:.2f} s "
                    f"({r['bytes'] / r['write_s'] / 1e9:.2f} GB/s)"
                    for r in saves)
        + f"; steps overlapping a write {res['step_ms_writing']} ms "
          f"(median of {len(over)}), others {res['step_ms_clear']:.1f} ms;"
          f" restore {spy.restore['s']:.2f} s, "
          f"{spy.restore['extra_bytes']} B beyond the run's state on the "
          f"card; resumed from {RESUME_AT}: "
          f"losses, parameters, moments and step equal bit for bit "
          f"[{res['power']}]")
    return res


def _train_resume(dev, full_losses):
    """The resume entry: :func:`_resume_case` for the ``full`` run's
    xLSTM-125M (its losses are run A's yardstick) and for
    ``RESUME_SMOKE``, in a directory under ``build/`` removed afterwards
    whatever happens (an exception goes on up)."""
    import shutil
    import tempfile
    from repro_torch.kernels import ops
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="resume_", dir=build))
    try:
        out = {"xlstm": _resume_case(
            dev, root / "xlstm", TRAIN_ARCH, smoke=False, batch=TRAIN_BATCH,
            seq=TRAIN_SEQ, steps=TRAIN_STEPS, plain_losses=full_losses)}
        _free_cuda()
        arch, batch, seq, steps = RESUME_SMOKE
        out["smoke"] = _resume_case(dev, root / "smoke", arch, smoke=True,
                                    batch=batch, seq=seq, steps=steps)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = dict.fromkeys(ops.launch_counts(), 0)
    for case in ("xlstm", "smoke"):
        for k, v in out[case]["launches"].items():
            out["launches"][k] += v
    return out


def _train_accum(dev):
    """``TRAIN_ACCUM``: accumulation over micro-batches with full remat;
    each micro-batch launches B4 12 forward + 12 recomputed + 12
    backward."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.launch import train as train_mod
    batch, accum, n_steps = TRAIN_ACCUM
    cfg = configs.get(TRAIN_ARCH)
    hist = []
    with Counted() as c, _PlainCalls() as plain:
        _, losses = train_mod.train(
            TRAIN_ARCH, smoke=False, batch=batch, seq=TRAIN_SEQ,
            steps=n_steps, accum_steps=accum, remat="full", device=dev,
            history=hist, log_every=n_steps)
    want = n_steps * accum * 3 * cfg.n_layers
    _train_gate(c.counts["ssm_scan"] == want and plain.calls == 0,
                f"accum: {c.counts['ssm_scan']} B4 launches (expected "
                f"{want}), {plain.calls} plain calls")
    _train_gate(np.isfinite(losses).all() and
                np.isfinite([h["grad_norm"] for h in hist]).all(),
                "accum: non-finite loss or grad norm")
    res = dict(batch=batch, accum_steps=accum, remat="full", steps=n_steps,
               losses=losses, step_ms=[h["ms"] for h in hist],
               launches=c.counts)
    log(f"train accum: B={batch} in {accum} micro-batches, remat full, "
        f"{n_steps} steps: losses {[round(x, 4) for x in losses]}, "
        f"{[round(h['ms'], 1) for h in hist]} ms/step, B4 launches "
        f"{c.counts['ssm_scan']}")
    return res


def _train_remat_pair(dev):
    """3 steps at full size with ``remat="none"``, ``"full"`` and
    ``"selective"`` on the same weights and batches: losses equal to
    none's within 1e-5 relative; B4 launches 12 + 12 a step, and 12
    more recomputed under remat (the selective policy keeps only the
    2-D products)."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    cfg = configs.get(TRAIN_ARCH)
    out = {"launches": dict.fromkeys(ops.launch_counts(), 0)}
    for remat, per_step in (("none", 2), ("full", 3), ("selective", 3)):
        with Counted() as c:
            _, losses = train_mod.train(
                TRAIN_ARCH, smoke=False, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                steps=3, remat=remat, device=dev, log_every=3)
        _train_gate(c.counts["ssm_scan"] == 3 * per_step * cfg.n_layers,
                    f"remat {remat}: {c.counts['ssm_scan']} B4 launches")
        out[remat] = losses
        for k, v in c.counts.items():
            out["launches"][k] += v
    rel = max(abs(x - y) / abs(y) for remat in ("full", "selective")
              for x, y in zip(out[remat], out["none"]))
    _train_gate(rel <= 1e-5, f"remat against none: losses full "
                             f"{out['full']}, selective {out['selective']}, "
                             f"none {out['none']}")
    out["max_rel_diff"] = rel
    log(f"train remat: none {out['none']}, full {out['full']}, selective "
        f"{out['selective']} (max rel diff {rel:.3g})")
    return out


# --------------------------------------------------------------------------
# where the time goes
# --------------------------------------------------------------------------


def _union_us(spans) -> float:
    """Total time (µs) covered by at least one of the ``(lo, hi)``
    spans."""
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy


def busy_ms(fn) -> float:
    """Device-busy ms of one call of ``fn``: the union of its device
    events under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _union_us(
        (ev.time_range.start, ev.time_range.end) for ev in prof.events()
        if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def phase_profile(data):
    """One warm call of each main-path cell under ``torch.profiler``
    (:func:`profile_cell`)."""
    return {cell: profile_cell(cell, fn)
            for cell, fn in data["warm"].items()}


#: each kernel's device functions, by name fragment
OUR_KERNELS = {"coo_segment": ("segment_runs", "scatter_bool",
                               "scatter_float", "fill_float"),
               "coo_spmm": ("spmm_items", "spmm_fold", "spmm_pack",
                            "spmm_unpack"),
               "semiring_matmul": ("semiring_mm",),
               "ssm_scan": ("ssm_scan_kernel",),
               "flash_attention": ("flash_prefill_tc", "flash_decode_split",
                                   "flash_decode_combine", "flash_wide_simt"),
               "flash_attention_backward": ("flash_bwd_rowdot",
                                            "flash_bwd_dkdv", "flash_bwd_dq")}


#: device-function name fragments of cuBLAS's and CUTLASS's GEMMs and
#: GEMVs (lower case)
GEMM_NAMES = ("gemm", "gemv", "xmma", "cutlass")


def profile_cell(cell, fn, ordered=()):
    """One warm call of ``fn`` under ``torch.profiler``: device time by
    kernel, cuBLAS/CUTLASS GEMM time (``gemm_ms``), and the device's busy
    share of the call's unprofiled wall time.  A capture is complete when
    it holds at least one event per launch the wrappers counted during
    the profiled call; an incomplete capture is retried (up to 3 times)
    and flagged.  ``ordered``: kernels of ours whose event durations
    (ms) are also returned one by one in start order (``"ordered"``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    ours = OUR_KERNELS
    fn()
    _, wall_ms = wall(fn)
    for attempt in range(3):
        with Counted() as c, profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        spans, by_name, seen = [], {}, dict.fromkeys(ours, 0)
        kernel_us = dict.fromkeys(ours, 0.0)
        each = {k: [] for k in ordered}
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            lo, hi = ev.time_range.start, ev.time_range.end
            spans.append((lo, hi))
            by_name[ev.name] = by_name.get(ev.name, 0.0) + (hi - lo)
            for k, pats in ours.items():
                if any(p in ev.name for p in pats):
                    seen[k] += 1
                    kernel_us[k] += hi - lo
                    if k in each:
                        each[k].append((lo, (hi - lo) / 1e3))
        complete = all(seen[k] >= c.counts.get(k, 0) for k in ours)
        if complete:
            break
    busy = _union_us(spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    gemm_us = sum(us for name, us in by_name.items()
                  if any(p in name.lower() for p in GEMM_NAMES))
    out = dict(wall_ms=wall_ms, device_busy_ms=busy / 1e3,
               busy_share=busy / 1e3 / wall_ms,
               complete=complete, attempts=attempt + 1,
               device_events=len(spans), launches=c.counts,
               kernel_ms={k: v / 1e3 for k, v in kernel_us.items() if v},
               gemm_ms=gemm_us / 1e3,
               top=[(name[:90], us / 1e3) for name, us in top])
    if ordered:
        out["ordered"] = {k: [ms for _, ms in sorted(v)]
                          for k, v in each.items()}
    log(f"profile {cell}: device busy {busy / 1e3:.3f} ms of "
        f"{wall_ms:.3f} ms ({100 * busy / 1e3 / wall_ms:.0f}%), "
        f"{len(spans)} device events, complete={complete}; ours: "
        f"{ {k: round(v, 4) for k, v in out['kernel_ms'].items()} }"
        f"; top: " +
        "; ".join(f"{name[:40]} {us / 1e3:.3f} ms"
                  for name, us in top[:3]))
    return out


# --------------------------------------------------------------------------
# the dry run (ROADMAP A8): the count held to the card
# --------------------------------------------------------------------------

#: the calibration cells, each small enough for one card at mesh (1, 1):
#: (arch, workload, global batch, sequence, dryrun options)
DRYRUN_CALIBRATE = (
    ("xlstm-125m", "train_4k", 8, 1024, {"remat": "none"}),
    ("zamba2-2.7b", "prefill_32k", 8, 512, {}),
    ("zamba2-2.7b", "decode_32k", 8, 1024, {}),
)
#: the calibration's peak gate: the meta count's arguments plus its
#: temporaries within this share of the card's peak over the step
PEAK_SHARE = 0.10
#: the Datalog dry run on the card: vertices, iterations, edge density
#: (E is N_CC² bools, 1 GiB), and the meta count's n on (16, 16)
N_CC, CC_ITERS, CC_DEGREE = 32_768, 8, 2.0
N_CC_META = 65_536
#: production cells counted on meta (arch, shape, mesh)
DRYRUN_CELLS = (("llama3-405b", "train_4k", "single"),
                ("deepseek-moe-16b", "train_4k", "single"),
                ("zamba2-2.7b", "train_4k", "single"),
                ("zamba2-2.7b", "decode_32k", "multi"),
                ("xlstm-125m", "long_500k", "single"))


def _cc_plain(e, variant, iters):
    """CC's loop in plain PyTorch on the card (f32 products with TF32
    off: sums of 0/1 below 2²⁴ are exact)."""
    import torch
    n = e.shape[0]
    ids = torch.arange(n, device=e.device)
    idf = ids.to(torch.float32)
    inf = torch.tensor(float("inf"), device=e.device)
    if variant == "original":
        eye = ids[:, None] == ids[None, :]
        tc, ef = eye, e.float()
        for _ in range(iters):
            tc = (ef @ tc.float() > 0.5) | eye
            labels = torch.where(tc, idf[None, :], inf).amin(1)
        return labels
    cc = idf.clone()
    for _ in range(iters):
        cc = torch.minimum(idf, torch.where(e, cc[None, :], inf).amin(1))
    return cc


def phase_dryrun(dev):
    """The dry-run tools on the card.  (1) ``dryrun.calibrate`` on
    ``DRYRUN_CALIBRATE``: the meta count's FLOPs, bytes and collectives
    equal the card's count of the same step exactly, and the meta
    count's arguments plus temporaries are within ``PEAK_SHARE`` of the
    card's peak over the step; each step's ms against ``hillclimb``'s
    compute and memory seconds.  (2) CC's original and optimized loops
    (``datalog_dryrun.cc_loop``) on a one-rank mesh at ``N_CC``, through
    B2 ``tc_bool`` and ``stream``, bit for bit the plain loop on the
    card, ms an iteration; then the meta count at ``N_CC_META`` on
    ``(16, 16)``: the optimized variant's bytes and collective bytes a
    rank an iteration below the original's.  (3) ``DRYRUN_CELLS``
    counted on meta, each row ``ok``."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import semiring_matmul as mm
    from repro_torch.launch import datalog_dryrun as dd
    from repro_torch.launch import dryrun, hillclimb
    from repro_torch.launch import mesh as mesh_mod
    out = {"calibrate": {}, "datalog": {}, "cells": {}}
    with Counted() as c:
        for arch, shape, b, t, kw in DRYRUN_CALIBRATE:
            r = dryrun.calibrate(arch, shape, device=dev, batch=b, seq=t,
                                 **kw)
            meta, card = r["meta"], r["device"]
            same = all(meta[k] == card[k] for k in
                       ("flops", "bytes_accessed", "collectives", "kernels"))
            peak, pred = card["device_peak_bytes"], r["predicted_peak_bytes"]
            share = abs(pred - peak) / peak
            priced = hillclimb.terms(meta)
            key = f"{arch}/{shape}"
            out["calibrate"][key] = dict(
                batch=b, seq=t, meta=meta, card=card, predicted_peak=pred,
                card_peak=peak, peak_error=share, card_ms=card["ms"],
                compute_s=priced["compute_s"], memory_s=priced["memory_s"])
            log(f"dryrun calibrate {key} {b}×{t}: flops {meta['flops']:.6g}"
                f" (card {card['flops']:.6g}), bytes "
                f"{meta['bytes_accessed']:.6g} (card "
                f"{card['bytes_accessed']:.6g}), peak predicted "
                f"{pred / 1e9:.3f} GB against the card's {peak / 1e9:.3f} GB"
                f" ({100 * share:.1f}%), {card['ms']:.1f} ms against "
                f"{1e3 * priced['compute_s']:.2f} ms compute, "
                f"{1e3 * priced['memory_s']:.2f} ms memory")
            if not same:
                raise AssertionError(f"dryrun {key}: the meta count is not "
                                     f"the card's")
            if not meta["kernels"] or share > PEAK_SHARE:
                raise AssertionError(f"dryrun {key}: peak {pred} predicted "
                                     f"against {peak}")
            _free_cuda()
        # the Datalog dry run on a real one-rank mesh
        mesh = mesh_mod.make_host_mesh(1, device=dev)
        g = torch.Generator(device=dev).manual_seed(0)
        e = torch.rand((N_CC, N_CC), device=dev, generator=g) < (
            CC_DEGREE / N_CC)
        torch.backends.cuda.matmul.allow_tf32 = False
        for variant, path in (("original", "tc_bool"),
                              ("optimized", "stream")):
            before = dict(mm.semiring_matmul_cuda.by_path)
            got, ms = wall(lambda: dd.cc_loop(e, variant, mesh, N_CC,
                                              CC_ITERS))
            launched = {p: n - before[p] for p, n in
                        mm.semiring_matmul_cuda.by_path.items()}
            want, plain_ms = wall(lambda: _cc_plain(e, variant, CC_ITERS))
            equal = torch.equal(got, want)
            out["datalog"][variant] = dict(
                n=N_CC, iters=CC_ITERS, ms_per_iter=ms / CC_ITERS,
                plain_ms_per_iter=plain_ms / CC_ITERS, b2_paths=launched,
                equal=equal, labels=int(torch.unique(got).numel()))
            log(f"dryrun datalog {variant} n={N_CC}: {ms / CC_ITERS:.2f} ms"
                f" an iteration ({plain_ms / CC_ITERS:.2f} plain), B2 "
                f"{launched}, {out['datalog'][variant]['labels']} labels, "
                f"equal {equal}")
            if not equal or launched[path] != CC_ITERS or sum(
                    launched.values()) != CC_ITERS:
                raise AssertionError(f"dryrun datalog {variant}: equal "
                                     f"{equal}, B2 {launched}")
            del got, want
        del e
        _free_cuda()
    out["launches"] = c.counts
    rows = {v: dd.run(N_CC_META, v, False, CC_ITERS)
            for v in ("original", "optimized")}
    for v, r in rows.items():
        out["datalog"][f"meta_{v}"] = r
        log(f"dryrun datalog meta {v} n={N_CC_META} (16, 16): "
            f"{r['bytes_accessed'] / CC_ITERS:.6g} B and "
            f"{r['collective_bytes'] / CC_ITERS:.6g} collective B a rank "
            f"an iteration, {r['flops'] / CC_ITERS:.6g} operations")
    if not (rows["optimized"]["bytes_accessed"]
            < rows["original"]["bytes_accessed"] and
            rows["optimized"]["collective_bytes"]
            < rows["original"]["collective_bytes"]):
        raise AssertionError("dryrun datalog: the optimized step moves "
                             "no less than the original")
    for arch, shape, mesh_kind in DRYRUN_CELLS:
        r = dryrun.run_cell(arch, shape, mesh_kind)
        out["cells"][f"{arch}/{shape}/{mesh_kind}"] = r
        log("dryrun cell " + json.dumps({k: v for k, v in r.items()
                                         if k != "trace"}))
        if r["status"] != "ok":
            raise AssertionError(f"dryrun {arch} {shape} {mesh_kind}: "
                                 f"{r.get('error')}")
    if dist.is_initialized():
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    sys.exit(main())
