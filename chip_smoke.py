#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout, on a machine with the card and the CUDA
toolkit:

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --kernels-only  # build + kernel checks only

Phases, each of which fails the run (non-zero exit) if anything is off:

1. print the card's name and power limit (nvidia-smi); turn TF32 off;
2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` with
   nvcc (one process per source, all at once) and print each kernel's
   registers and spills (``-Xptxas -v``);
3. hold each kernel against its plain PyTorch version at its path's
   shapes (serving for K1-K4; training, batch 4 x 2048 tokens of
   llama3-8b, for K5 and its backward), in fp32 (atol 1e-4) and bf16
   (atol 1e-3, rtol 1e-2: both sides accumulate in fp32 and round once,
   so they may differ by one bf16 unit, a relative 2^-8 to 2^-7; K5's
   bf16 kernels keep P and dS to 16 bits as bf16 hi + lo halves; the
   appends bit-exact), and time kernel, plain version and one PyTorch
   library call computing the same function (CUDA events, warm, the
   median of five windows, three for the slowest calls); K6 and its
   backward (training, batch 4 x 2048 tokens of mamba2-2.7b, and a
   ragged T through the autograd op) at rtol 1e-4 with an atol of 1e-4
   times each output's largest entry (dA and dt sum thousands of terms
   that cancel), 1e-2 of both for bf16 gradients (one bf16 unit), with
   no library call to time (no single PyTorch call computes the scan);
   K7 and its backward (training, batch 4 x 2048 tokens of
   recurrentgemma-9b's 4096 channels, in fp32, with a drawn as a
   sigmoid and within 1e-3 of 1, and a ragged shape through the autograd
   op) at K6's tolerance, with no library call either; K5 and its
   backward at recurrentgemma-9b's attention shape (hd 256, 16 query
   heads on one kv head, window 2048) at batch 4 x 2048 and at batch
   2 x 4096, where the window masks keys, timed against SDPA; K2 and K4
   also at rep = H/KV of 7 (H 14, KV 2, hd 64) and 12 (H 96, KV 8, hd
   128), with K2's split count and K4's blocks printed; K1's and K3's
   device time a launch (torch.profiler) printed beside their events
   time and ``index_copy_``'s, and so is the device time a call of each
   of K6's three bf16 forward kernels (chunk_state_tc, state_pass,
   chunk_scan_tc) beside the forward's events time; K4's bf16 kernel and
   K6's bf16 tensor-core kernels (forward chunk_state_tc and
   chunk_scan_tc, backward dc_tc and dxb_tc) must show HGMMA
   instructions in the SASS of every instance; K2 at MLA width
   (``mla_decode``: fp32 q over the one compressed bf16 pool, KV 1: the
   tensor cores' ``decode_tc``, q and P as bf16 hi + lo) at DeepSeek-V2's
   decode shape (B 8, H 128, W 576, R 512, page 16, contexts 1 to 4096)
   with and without a window, and at W 80 / R 64 and W 48 / R 32, in
   fp32 (atol 1e-4), timed against SDPA over the gathered context (one
   kv head whose 128 query heads are SDPA's query rows), the fp32 pool's
   CUDA-core ``decode`` timed beside it, and the one-pool K1 and K3 forms
   at width 576, bit-exact, timed against ``index_copy_``; K2 and
   ``mla_decode`` with their LSE (the striped pools' stripe partials) at
   the same shapes, on both of mla_decode's routes with a row of no key,
   its output bit for bit the call's without the LSE, each timed as its
   own row; last (so the checks above draw the inputs they drew before),
   K2 and K4 at whisper-base's decoder (H 8, KV 8, hd 64) and K5 forward
   and backward at hd 64 at whisper-base's (8 x 448) and internvl2-1b's
   (H 14, KV 2, 4 x 2304) training shapes in bf16, timed beside SDPA;
   after those, phase 18's shapes: K2 and K4 at recurrentgemma-9b's
   local attention (H 16, KV 1, hd 256, window 2048; decode B 8 over
   contexts 1 to 4096, prefill B 8 x 512 over priors up to 3584) in bf16
   and with fp32 q and the LSE, timed beside SDPA under the same mask,
   and K6 and K7 from a nonzero h0 (B 8 x 512: mamba2-2.7b's 80 heads of
   64 with d_state 128, recurrentgemma-9b's 4096 channels) at K6's
   tolerance, then (phase 19's) both again on a masked ragged batch (8
   rows of 0 to 512 real positions, dt zero or a = 1 and g = 0 past
   them; K6 in fp32 and bf16); and a diagnostic line (no check) beside the bf16 op's dA
   at T = 100: the kernel's and the fp32 plain version's distance from
   the plain backward in fp64 on the same inputs;
4. serve a small request trace with the reduced llama3-8b in fp32 on the
   card and on the CPU (plain versions): the greedy tokens and the phase
   log must be identical; then four requests over a 12-block pool, where
   decode growth finds the pool full and the scheduler evicts and
   recovers a request: tokens, phases and the recovered count (> 0)
   must be identical;
5. serve 8 seeded requests at the full width of llama3-8b in bf16
   through ``repro_torch.launch.serve`` (its real path: DynamicScheduler
   over FlyingEngine under the layout policy), each step's duration
   logged for phase 13, with every kernel's launch count reset just
   before and
   read just after: every request must finish with its full output,
   every token must be in the vocab, K1-K4 must have launched,
   and no token may have been read back one at a time; then, on the
   same stack, its dry run (``dryrun_against_the_card``): the decode
   step at 8 rows over 256-block tables and a prefill step of 8 rows of
   512 tokens counted on the meta device (``launch/dryrun.py``, the
   plan of one card) and run once on the card through the same step
   program: the dry run's argument bytes must equal the engine's
   parameters', pools' and batch's to the byte, and its GEMM FLOPs
   those ``FlopCounterMode`` counts around the card's step exactly; the
   roofline's ms (H100 data sheet) printed beside phase 5's median step
   of each phase, and the predicted peak beside the card's;
6. serve the same trace again under torch.profiler and print the device
   time by kernel class, the device's busy share of the wall time, and
   K2's, K4's and the appends' launches and mean time a launch;
13. (run right after phase 6, on phase 5's trace) serve llama3-8b at
   full width in bf16 over HTTP: ``FrontDoor`` -> ``AsyncServeLoop``
   (wall pace, tokens harvested as ``--serve`` harvests them) ->
   ``ServeHTTP`` on 127.0.0.1, the trace replayed by
   ``loadgen.drive_http``: every stream must end done with exactly its
   output length in the vocab, K1-K4 must have launched and ``GET
   /metrics`` must serve the rolling tier report; client-side TTFT p50
   and p99, the TPOT median (the server's clock, which tracks the wall
   at wall pace) and the wall tok/s are printed beside the card's name
   and power limit, as smoke readings of 8 requests (their p99 is in
   effect their maximum; ``tools/http_bench.py`` serves a few hundred
   requests for a tail). Then the trace in
   process at virtual pace, with phase 5's step durations replayed so
   the schedule (and bf16 batching) is phase 5's: the streamed greedy
   tokens must equal phase 5's; and at temperature 0.8, top-k 50,
   per-request seeds, the streamed tokens must equal an offline run's
   on the same schedule;
7. train the reduced llama3-8b three fp32 steps on the card (K5 forward
   and backward) and on the CPU (their plain versions) from the same
   weights and batches: the losses must agree (rtol 1e-4); then three
   bf16 steps from the same bf16 weights, whose losses must agree within
   twice the CPU's own relative bf16-vs-fp32 drift over those steps;
8. train llama3-8b at full width, 4 of its 32 layers, in bf16 (fp32
   AdamW moments), batch 4 x 2048 tokens, 20 steps, through
   ``repro_torch.launch.train.train``, with the launch counts reset
   just before and read just after: every loss must be finite, the last
   below the first, and K5 must have launched 8 times forward (twice per
   layer: the forward pass and its recomputation under remat) and 4
   times backward per step; then two more steps under torch.profiler
   for the device time by kernel class;
9. train the reduced mamba2-2.7b three fp32 steps on the card (K6
   forward and backward) and on the CPU from the same weights and
   batches: the losses must agree (rtol 1e-4);
10. train mamba2-2.7b at full width and all 64 layers in bf16 (fp32
   AdamW moments), batch 4 x 2048 tokens, 20 steps, as phase 8: finite
   losses, the last below the first, and K6 launched 128 times forward
   and 64 times backward per step; then two profiled steps (the bf16
   forward's three kernels and the bf16 backward's four by name);
11. train the 4-layer RecurrentGemma test config (reduced
   recurrentgemma-9b with one whole super-layer and one more RG-LRU
   layer) three fp32 steps of 128 tokens on the card (K7, K5) and on
   the CPU from the same weights and batches: the losses must agree
   (rtol 1e-4); then three bf16 steps as in phase 7;
12. train recurrentgemma-9b at full width, 6 of its 38 layers (two
   super-layers), in bf16 (fp32 AdamW moments), batch 4 x 2048 tokens,
   20 steps, as phase 8: finite losses, the last below the first, K7
   launched 8 times forward and 4 times backward per step (four RG-LRU
   layers), K5 4 and 2 (two local-attention layers); then two profiled
   steps;
14. (run after phase 12, with this process's card memory freed) two
   rank processes share the one card, joined over gloo (NCCL refuses two
   ranks on one card; the backend is printed, and no time here measures
   TP on two cards): (a) the reduced llama3-8b in fp32 at
   ``ParallelPlan(1, 1, 2)``, 8 requests with the merge scripted DP ->
   TP2 -> DP, on the card and on the CPU in each rank: streams and
   schedules equal, on both ranks; (c) K2's ``return_lse`` partials over
   two halves of each request's pages, one half a rank, merged by
   ``TPContext.lse_merge`` across the ranks, against one whole K2 call
   (fp32 tolerance); (b) llama3-8b at full width and depth in bf16
   serving phase 5's 8 requests with the merge scripted 1 -> 2 -> 1:
   every request done with its full output in the vocab, every rebind's
   weight and pool ``data_ptr``s unchanged; then fleet decode ticks of 16
   requests at merge 1 and at merge 2, with K1-K4's launches at the
   merge-2 view (pages of 32 tokens, 4 of the 8 KV heads a rank) counted
   from zero and required, and every greedy token of both ticks held
   against a dense one-rank forward of the whole model fed the same
   tokens (K5, the full vocab, no pool and no collective): its argmax, or
   a near-tie (a margin of at most NEAR_TIE_SD of the row's deviation),
   whose margin is printed; rebind ms,
   the pool's group build ms against its lookup us, TP collectives a
   step and each rank's peak memory are printed; (d) the reduced
   llama3-8b with 2 KV heads (its one KV head is readable at no merge
   above 1) in fp32, card against CPU in each rank: 8 requests under
   LIVE with the merge scripted DP -> TP2 while decodes and a chunked
   prefill are in flight (riders carried, nothing paused or
   recomputed), a pure-SP island ``Island(0, 2, 2, sp=2)`` serving a
   context over one engine's pool (tokens equal to a big pool's), and a
   KILL of engine 1 mid-decode recovered onto engine 0 (the fault-free
   stream, no block leaked): streams and schedules equal, on both ranks;
   (e) llama3-8b at full width and depth in bf16 over the same weights:
   phase 5's 8 requests under LIVE with the merge scripted 1 -> 2 while
   decodes and a chunked prefill are in flight (every request done,
   nothing paused or recomputed, ``data_ptr``s unchanged, K2's and K4's
   LSE launches, the live lanes' sweeps, counted from zero and
   required, the riders' greedy tokens held against the dense one-rank
   forward), a decode tick of 16 tag-1 riders at merge 2 timed beside
   (b)'s plain merge-2 tick (lanes and collectives a tick printed), and
   one 3072-token request on a pure-SP island whose pool is cut to 24
   blocks of 128 tokens a rank (its greedy tokens held the same way).
15. (run after phase 14) MLA and MoE: (a) the reduced deepseek-v2-236b
   (MLA + MoE) and phi3.5-moe-42b-a6.6b (GQA + MoE) in fp32 through a
   scheduler run of six requests with prefill, mixed and decode steps,
   on the card (K1, K3 and mla_decode; K1-K4) and on the CPU: greedy
   tokens and phase logs equal; (b) deepseek-v2-236b at full width, 4 of
   its 60 layers (the dense MLA+MLP layer and three MLA+MoE layers;
   13.3 B parameters in bf16, seed 0), at ParallelPlan(1, 1, 1) over a
   4096 x 16-token pool, 8 requests of 256-1024 prompt tokens and 32
   out through the launcher's real path: every request done, every
   sampled row's logits finite, mla_decode and K1 launched 4 times in
   every step with decode rows and K3 4 times in every step with
   prefill rows; tok/s, the median decode tick and the peak memory
   printed; the MoE entries its capacity factor (1.25) drops counted;
   then the same trace in prefill chunks of 1 (no step over 8 tokens,
   so no entry drops, counted), whose greedy tokens are held against a
   dense forward (no pool, naive MLA, every token through its top-k
   experts): its argmax, or a near-tie within NEAR_TIE_SD; then a
   profiled rerun's device time by kernel class (GEMMs, MoE dispatch,
   mla_decode's decode_tc, elementwise) and busy share, where every
   mla_decode call must have run decode_tc and none the CUDA cores'
   decode.
16. (run after phase 15) the striped (context-parallel) pools: two rank
   processes on the one card over gloo at ``ParallelPlan(1, 1, 2)``,
   merge 2 (one TP2 island, stripe factor 2; no number here measures TP
   on two cards): (a) the reduced llama3-8b and deepseek-v2-236b in fp32
   on a striped pool, phase 15 (a)'s six requests with every prompt in
   one prefill chunk, on the card and on the CPU in each rank: streams
   and phase logs equal on both ranks, K1, K3, K5 forward and K2 (every
   call with its LSE), or the one-pool K1 and K3 and mla_decode (every
   call with its LSE), launched; K2's and mla_decode's LSE partials over
   each rank's stripe merged by ``lse_merge`` against one whole-context
   call (fp32 tolerance); (b) llama3-8b at full width cut to
   STRIPED_LAYERS of 32 layers in bf16 (to keep the script inside its
   time limit once phase 22 came) on a striped pool serving phase 5's 8
   requests, the prefill chunk
   raised to 2048 (striped prefill is fresh only): every request done,
   the pools' ``data_ptr``s unchanged, K1, K3, K5 forward and K2 with
   its LSE counted from zero and required, every greedy token held
   against phase 14's dense one-rank forward (its argmax or a near-tie
   within NEAR_TIE_SD); a decode tick of 16 rows printed beside the
   same tick on a head-layout pool over the same weights (at the same
   depth), with its collectives and each rank's peak; (c) deepseek-v2-236b at full width
   cut to 2 of 60 layers (the dense MLA+MLP layer and one MLA+MoE
   layer) in bf16, 8 requests
   of 256-1024 prompt tokens and 32 out in prefill chunks of 1024 on a
   striped pool: every request done, every sampled row finite,
   mla_decode with its LSE and the one-pool K1 and K3 counted from zero
   and required (2 layers x the steps that run them), the blocks a
   1024-token request takes a rank in each layout printed; then one
   prefill of 8 prompts of 1024 tokens (no padded position, so none
   takes MoE capacity) and one decode step (8 tokens: no entry drops)
   on a striped and on a head-layout pool: the prefill's logits within
   STRIPED_MLA_SD row deviations, the greedy tokens equal or near-ties;
   the same steps with the MoE FFN made a dense MLP like the first
   layer's (no router after the attention), both within STRIPED_MLA_SD;
   and over fp32 weights at 4 prompts, both within STRIPED_MLA_F32_SD.
17. (run after phase 16) whisper-base (encoder and cross caches) and
   internvl2-1b (projector and patch prefix), the modality frontends fed
   seeded stub embeddings, at step level through ``build_serve_step``
   and in training: (a) the reduced configs in fp32 from the same
   weights, one prefill step of 4 ragged prompts (whisper with frames
   masked by ``enc_len`` in two rows) and 8 decode steps on the card and
   on the CPU: greedy tokens equal, logits within rtol = atol = 1e-4,
   K1-K4 launched; (b) both at full width and depth in bf16 (whisper-base
   6 + 6 layers, 1500 frames; internvl2-1b 24 layers, 256 patches of
   1024), 8 requests (whisper prompts 32-256, every other row's
   ``enc_len`` below 1500; internvl2-1b 256-1024 text tokens), one
   prefill and 32 decode steps after an untimed warm-up, K1-K4 counted
   from zero (layers x steps), every greedy token held against a dense
   forward (its argmax or a near-tie within NEAR_TIE_SD); the prefill
   step's ms, the median decode step's ms and the peak printed; (c) both
   reduced configs trained on card and CPU as phase 7, then 20 bf16
   steps each at full width and depth (whisper-base 8 x 448,
   internvl2-1b 4 x 2048 after its patches): finite losses, the last
   below the first, K5 launched 2 x layers x steps forward and layers x
   steps backward; median step ms, tok/s and peak printed.
18. (run after phase 17) mamba2-2.7b and recurrentgemma-9b at step level
   through ``build_serve_step``, their recurrent rows carried from step
   to step: (a) the reduced mamba2-2.7b and the reduced recurrentgemma-9b
   cut to 3 layers (a local-attention layer with its window of 64) in
   fp32 from the same weights, 4 prompts of 80 tokens prefilled in two
   chunks of 40 (the second from the carried state) and 4 decode steps,
   on the card and on the CPU: greedy tokens equal, logits within rtol =
   atol = 1e-4, K6 or K7 from h0 (and K1-K4) launched once a layer a
   step; (b) both at full width and depth in bf16 (mamba2-2.7b 64 layers,
   d_model 2560, 80 heads of 64, d_state 128; recurrentgemma-9b 38
   layers, 26 RG-LRU and 12 local attention with 16 heads of 256 on one
   kv head, window 2048, vocab 256000), seeded random weights, 8
   requests of 3072 prompt tokens in 6 chunks of 512 (chunks 2-6 from the
   carried state and over the prior pages; the window masks keys from
   chunk 5 on), then 32 decode steps (K2 at hd 256 masking past 2048),
   after an untimed warm-up; launches counted from zero and held to the
   layers and steps, every token in the vocab, every step's logits
   finite, two requests' served logits no farther from a dense fp32
   forward (fp32 weights) than RECURRENT_FIDELITY times the bf16 dense
   forward's distance from it (median row deviations; random weights
   amplify bf16 rounding with depth, so greedy tokens are not held to a
   near-tie bound here); the prefill chunks' ms, the median decode
   step's ms, decode tok/s and the peak printed.
19. (run after phase 18) mamba2-2.7b and recurrentgemma-9b through
   ``DynamicScheduler`` -> ``FlyingEngine``, each request holding one
   recurrent row from its first prefill chunk to its end, every step
   staging ``valid`` (pads and idle rows leave the states alone), no
   mixed step: (a) the reduced configs of phase 18 (a) in fp32 from the
   same weights, 8 requests of 24-88 prompt tokens in chunks of 32 (a
   step holds chunks of 8, 24 and 32) and 4-12 out over 4 batch rows
   (later requests reuse finished ones' rows), every step reporting 10
   ms: card tokens equal the CPU's and each request's tokens equal its
   own batch-1 run through ``build_serve_step`` on the card (the same
   chunks, then greedy decode steps), K6 or K7 from h0 launched; (b)
   both at full width cut to 4 layers in fp32 (recurrentgemma-9b's third
   layer its local attention at hd 256), ``SLOW_DECAY``, 6 requests of
   300-1500 prompt tokens in chunks of 512 and 8-16 out over 4 rows,
   through the engine and each alone at batch 1 through the step:
   tokens equal, or equal up to a near-tie within NEAR_TIE_SD of the
   step's logits; (c) both at full width and depth in bf16
   (``SLOW_DECAY``) through the launcher's real path (``serve_config``:
   16 requests at Poisson 20/s, prompts 256-3072, outputs 32-64, 8 rows,
   chunks of 512), launches counted from zero: every request done, every
   token in the vocab, K6 or K7 from h0 once a recurrent layer a prefill
   step, K3/K4 once an attention layer a prefill step, K1/K2 once a
   decode step; the steps by phase, TTFT p50/p90, TPOT p50, output tok/s
   and the peak printed.
20. (run after phase 19) ``--serve`` on two rank processes sharing the
   card over gloo, rank 0's ``AsyncServeLoop`` leading and rank 1's
   ``lockstep.Follower`` replaying its inputs: (a) the reduced llama3-8b
   in fp32 at ``ParallelPlan(1, 1, 2)``, ``LOCKSTEP_TRACE`` (14 requests,
   a TP island carved, dissolved and carved again, one client leaving
   after its first token) at virtual pace with every step reporting 10
   ms, on the card and then on the CPU in each rank: streams, phase
   logs and switches equal, digests equal; (b) llama3-8b at full width
   and depth in bf16 at phase 5's geometry (two one-rank engines of
   2048 blocks a rank, which the layout policy merges to TP2 for
   priority traffic) over HTTP at wall pace through the launcher's rank
   entry (``launch.serve._rank_main``), 8 requests at Poisson 2/s (3
   of them priority), sent by ``loadgen.drive_http`` from a process of
   its own, which then stops the server with SIGINT: every stream done
   with its full output in the vocab, at least one rebind, K1-K4
   launched on both ranks, the digests equal, every rank exited 0;
   client TTFT p50/p90 per tier, server TPOT p50, output tok/s, the
   rebinds' ms, rank 0's broadcast ms (median, p99) and host
   collectives a tick printed.
21. (run after phase 20) sharded training (``build_train_step`` at a
   plan of two ranks: TP over 'model', the batch over 'data') on two
   rank processes sharing the card over gloo: (a) reduced llama3-8b and
   Phi-3.5-MoE in fp32 at TP2 and DP2, reduced mamba2-2.7b and the
   4-layer RecurrentGemma at TP2, 3 steps of 4 x 128 tokens on the card
   and on the CPU side by side in each rank, from the same seeded
   weights: the losses (rtol 1e-4), the gathered gradients before step
   1 and the gathered parameters (atol 1e-4; mamba2-2.7b from the
   card's state at every step, its near-zero gradients' elements left
   out, at most 1%) equal, K5, K6 and K7 launched at their rank-local
   shapes; (b) llama3-8b at full width cut to 4 of 32 layers, bf16,
   TP2, 6 steps of 4 x 2048 tokens; (c) Phi-3.5-MoE at full width cut
   to 2 of 32 layers, bf16, TP2 (8 experts a rank), 5 steps of 2 x 2048
   tokens; (d) mamba2-2.7b (2 of 64 layers) and recurrentgemma-9b (3 of
   38) at full width, bf16, TP2, 3 steps of 4 x 2048 tokens: finite
   losses ((b) and (c) falling) equal on both ranks, each kernel
   launched twice forward and once backward a layer of its kind a
   step; the median step over steps 2 on and tok/s, the peak a rank,
   TP collectives a step, the launches and (c)'s aux loss printed.
   Phase 3 holds, after the shapes above, K5 at llama3-8b's TP2-local
   heads (H 16, KV 4, hd 128) and at RecurrentGemma's (H 8, KV 1, hd
   256, window 2048), K6 at 40 heads of 64 and K7 at 2048 channels,
   each at 4 x 2048; and last K5 forward and backward on its fp32 route
   at rep 7 (H 14, KV 2, hd 64) and rep 12 (H 96, KV 8, hd 128), which
   do not divide a block's 64 rows, with and without a window, at the
   fp32 tolerance. Every bound takes its bytes and operations from
   ``kernels/cost.py``.
22. (run after phase 21) serving on two engine tiles of two 'ed' rows:
   four rank processes sharing the card over gloo at ``ParallelPlan(2,
   1, 4)`` (it raises on fewer), Phi-3.5-MoE at full width cut to 2 of
   32 layers in fp32, each rank storing 8 of the 16 experts and running
   the MoE layer's two all_to_alls over its 'ed' group
   (``CommunicatorPool.seat``); the ranks seed the weights on the card
   in turn and keep only their storage slices on the host. First, on an
   engine of its own, 4 requests of 128 prompt tokens under HARD at
   merge 1, instrumented: a decode step's mean ms in its collectives by
   kind (the card synchronised before each) and in the rest. (a) 8
   requests (prompts 256-1024, 32 tokens out, chunks of 128) through
   ``DynamicScheduler`` and ``FlyingEngine`` under LIVE at the no-drop
   capacity factor (``num_experts / top_k``): the merge goes 1 -> 2
   while decodes and a chunked prefill are in flight (the decodes ride
   in place on live lanes, nothing paused or recomputed) and back to 1
   once nothing holds KV, for the last 2 requests; every request done,
   every weight and pool ``data_ptr`` unchanged across both rebinds,
   K1-K4 and K2's and K4's LSE launches counted from zero and each
   launched on every rank, the streams equal on every rank; then on
   (a)'s engine decode ticks of 16 requests of 256 tokens at merge 1,
   at merge 2, and of 16 tag-1 riders at merge 2. (b) 8 requests of 128
   prompt tokens and 8 decode steps at the config's own capacity factor
   (1.25), the entries each 'ed' slice drops a step printed, no token
   check. (d) one request of 3072 prompt tokens and 16 out on a pure-SP
   island ``Island(0, 2, 2, sp=2)`` over pools of 2944 tokens a rank,
   K2's and K4's LSE launches required on every rank. (c) on rank 0,
   (a)'s requests on the one-rank engine (``ParallelPlan(1, 1, 1)``)
   over the same weights, (a)'s and (d)'s tokens held against its dense
   forward by phase 14 (b)'s near-tie rule. Printed: the groups and
   their build ms, lanes, all_to_all calls and bytes and TP collectives
   a step, the rebind ms, the decode step and tok/s of (a) (not
   instrumented) and of (c), the ticks, each rank's serving peak
   (counted from its engine's build) and the card's memory in use over
   all four.

Each kernel's launch count in the JSON record comes from the path that
runs it: K1-K4 from phase 5, K5 and its backward at hd 128 from phase 8
and at hd 256 from phase 12, K6 and its backward from phase 10, K7 and
its backward from phase 12, mla_decode and the one-pool K1 and K3 from
phase 15 (b)'s first run, K2 with its LSE from phase 16 (b)'s trace and
mla_decode with its LSE from phase 16 (c)'s striped run, on rank 0,
K6 and K7 from h0 and K2 and K4 at hd 256 from phase 19 (c), K5 and
its backward at llama3-8b's TP2-local heads from phase 21 (b) and K5,
K6 and K7 at the other TP2-local shapes from phase 21 (d), on rank 0
(phases 14 and 22 print their own K1-K4 counts, phase 14 also K2's and
K4's LSE launches, in their rank processes; phases 17 and 18 print the
counts of their own runs). The line before the last is the kernels' JSON
record, the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
F32_TOL = dict(atol=1e-4, rtol=0.0)
BF16_TOL = dict(atol=1e-3, rtol=1e-2)
# phase 14 (b): the largest logit margin, in standard deviations of the
# row over the vocab, at which a greedy token may differ from a dense
# one-rank forward's argmax (a near-tie)
NEAR_TIE_SD = 0.25
SERVE_KERNELS = ("paged_append_token", "paged_attention",
                 "paged_append_chunk", "paged_flash_prefill")
TRAIN_KERNELS = ("flash_prefill", "flash_prefill_bwd")
MAMBA_KERNELS = ("ssd_scan", "ssd_scan_bwd")
# K6's bf16 forward kernels, in launch order
SSD_FWD_TC = ("chunk_state_tc", "state_pass", "chunk_scan_tc")
MAMBA_STEPS = 20
# the bf16 K5 kernels' classes in the profiled breakdowns
FLASH_CLASSES = (("flash_prefill_bwd dq", "dq_tc"),
                 ("flash_prefill_bwd dkdv", "dkdv_tc"),
                 ("flash_prefill_bwd sum", "sum_parts"),
                 ("flash_prefill", "fwd_tc"))
# phase 12's kernels: the JSON rows of K5 at hd 256 take its launches
HYBRID_ROWS = {"rglru_scan": "rglru_scan",
               "rglru_scan_bwd": "rglru_scan_bwd",
               "flash_prefill_hd256": "flash_prefill",
               "flash_prefill_bwd_hd256": "flash_prefill_bwd"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters: int = 20, warm: int = 3,
            windows: int = 5) -> float:
    """Time of one ``fn()`` on the card's timeline (CUDA events): the
    median over ``windows`` windows of the mean over ``iters`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / iters)
    return sorted(means)[windows // 2]


def launch_device_ms(torch, fn, pattern: str, iters: int = 20) -> float:
    """Mean device time of one launch of the kernels whose names hold
    ``pattern``, over ``iters`` calls of ``fn`` under torch.profiler;
    NaN where the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = n = 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) \
            or getattr(e, "self_cuda_time_total", 0)
        if t and pattern in e.key:
            us += t
            n += e.count
    return us / n / 1e3 if n else float("nan")


def bound(c):
    """The card's least time (ms) for the cost ``c`` of
    ``kernels/cost.py`` (the bytes a kernel moves, the operations it
    does), at the H100's data-sheet HBM rate and dense bf16 peak, and
    which of the two sets it."""
    from repro_torch.kernels import cost
    return cost.bound_ms(c)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_checks(torch, np):
    import torch.nn.functional as F

    from repro_torch.kernels import _lib, cost
    from repro_torch.kernels.flash_prefill import kernel as fk
    from repro_torch.kernels.flash_prefill import ref as fr
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention import ref as pr
    from repro_torch.models.cache import paged_gather

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    # serving shapes of llama3-8b: H=32, KV=8, hd=128, page 16, a 4096-
    # block pool, 256-block tables, decode batch 8, prefill chunk 512
    H, KV, hd, page, nblk, MB = 32, 8, 128, 16, 4096, 256
    w = KV * hd
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    gen = torch.Generator(device=dev).manual_seed(0)

    def pools(dtype):
        return tuple(torch.randn((nblk, page, KV, hd), generator=gen,
                                 device=dev).to(dtype) for _ in range(2))

    def tables(B):
        perm = rng.permutation(nblk - 1)[:B * MB]
        return t(perm.reshape(B, MB), torch.int32)

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    def close(a, b, dtype, what):
        e = err(a, b)
        ok = torch.allclose(a.float(), b.float(),
                            **(F32_TOL if dtype == f32 else BF16_TOL))
        print(f"  {what}: max_abs_err={e:.3e}")
        check(ok, f"{what} disagrees with its plain version (max {e:.3e})")
        return e

    # -- K1 / K3: appends (bit-exact, scratch row excluded) --------------
    def append_case(kind, B, T, dtype):
        shape = (B,) if kind == "token" else (B, T)
        n = int(np.prod(shape))
        s = rng.choice((nblk - 1) * page, size=n, replace=False)
        s[rng.random(n) < 0.25] = -1                      # parked rows
        slots = t(s.reshape(shape), torch.int32)
        vals = tuple(t(rng.standard_normal(shape + (KV, hd)), dtype)
                     for _ in range(2))
        kern = pk.paged_append_token_kernel if kind == "token" \
            else pk.paged_append_chunk_kernel
        plain = pr.paged_append_token_ref if kind == "token" \
            else pr.paged_append_chunk_ref
        base = pools(dtype)
        got = kern(tuple(p.clone() for p in base), vals, slots)
        want = plain(tuple(p.clone() for p in base), vals, slots)
        torch.cuda.synchronize()
        for g, wnt in zip(got, want):
            g, wnt = g.view(-1, w), wnt.view(-1, w)
            check(torch.equal(g[:-1], wnt[:-1]),
                  f"paged_append_{kind} {dtype} is not bit-exact")
        print(f"  paged_append_{kind} {dtype} {tuple(shape)}: bit-exact")
        return base, vals, slots, kern, plain, n

    def append_row(kind, name, replaces, B, T):
        append_case(kind, B, T, f32)
        base, vals, slots, kern, plain, n = append_case(kind, B, T, bf16)
        flat = tuple(p.view(-1, w) for p in base)
        idx = torch.where(slots.reshape(-1) >= 0, slots.reshape(-1).long(),
                          nblk * page - 1)
        rows_v = tuple(v.reshape(n, w) for v in vals)

        def library():
            for f, v in zip(flat, rows_v):
                f.index_copy_(0, idx, v)
        bms, by = bound(cost.append(n, w, 2, 2, 2))
        row = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/paged_append.cu",
            replaces=replaces, max_abs_err=0.0,
            ms=time_ms(torch, lambda: kern(base, vals, slots)),
            plain_ms=time_ms(torch, lambda: plain(base, vals, slots)),
            bound_ms=bms, bound_by=by, library_ms=time_ms(torch, library))
        rows.append(row)
        dev_ms = launch_device_ms(torch, lambda: kern(base, vals, slots),
                                  "append_rows")
        lib_dev = launch_device_ms(torch, library, "index")
        print(f"  {name} ({n} rows): events {row['ms']:.4f} ms a call, "
              f"device {dev_ms:.4f} ms a launch (profiler); index_copy_ "
              f"x2 events {row['library_ms']:.4f} ms, device "
              f"{2 * lib_dev:.4f} ms")

    print("kernels against their plain versions:")
    append_row("token", "paged_append_token",
               "src/repro/kernels/paged_attention/kernel.py:165", 8, 1)

    # -- K2: paged decode attention --------------------------------------
    B = 8
    ctx_np = np.concatenate([[1, MB * page], rng.integers(
        2, MB * page, size=B - 2)]).astype(np.int32)
    ctx = t(ctx_np, torch.int32)
    bt = tables(B)
    errs, lse_errs = [], []
    for dtype in (f32, bf16):
        kp_, vp_ = pools(dtype)
        q = t(rng.standard_normal((B, H, hd)), dtype)
        for window, lse in ((None, False), (1024, False), (None, True)):
            tag = f"paged_attention {dtype} window={window} lse={lse}"
            if lse:
                c0 = ctx.clone()
                c0[2] = 0                      # a row with no live key
                g, gl = pk.paged_attention_kernel(
                    q.float(), kp_, vp_, bt, c0, return_lse=True)
                wnt, wl = pr.paged_attention_with_lse_ref(
                    q.float(), kp_, vp_, bt, c0)
                lse_errs.append(close(gl, wl, f32, tag + " (lse)"))
            else:
                g = pk.paged_attention_kernel(q, kp_, vp_, bt, ctx,
                                              window=window)
                wnt = pr.paged_attention_ref(q, kp_, vp_, bt, ctx,
                                             window=window)
            e = close(g, wnt, dtype, tag)
            if dtype == bf16:
                errs.append(e)
    live = np.minimum(ctx_np, MB * page)
    keys, pages = cost.live_keys(live, page)
    bms, by = bound(cost.paged_decode(B, H, KV, hd, keys, pages, 2, 2, 2))
    kg = paged_gather(kp_, bt).transpose(1, 2).repeat_interleave(H // KV, 1)
    vg = paged_gather(vp_, bt).transpose(1, 2).repeat_interleave(H // KV, 1)
    mask = (torch.arange(MB * page, device=dev)[None, :]
            < ctx[:, None].long())[:, None, None, :]
    q4 = q[:, :, None, :]
    n_split, split_len = pk.decode_splits(B, KV, H // KV, MB * page, dev)
    print(f"  paged_attention: {n_split} splits of {split_len} keys, "
          f"{n_split * B * KV} blocks ({int(np.ceil(live / split_len).sum()) * KV}"
          f" with live keys)")
    rows.append(dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:97",
        max_abs_err=max(errs),
        ms=time_ms(torch, lambda: pk.paged_attention_kernel(
            q, kp_, vp_, bt, ctx)),
        plain_ms=time_ms(torch, lambda: pr.paged_attention_ref(
            q, kp_, vp_, bt, ctx), iters=5, windows=3),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, kg, vg, attn_mask=mask))))
    # K2 with its LSE (the striped pools' stripe partials and the live
    # lanes' sweeps): fp32 q, fp32 out and lse, over the bf16 pools
    qf, qf4 = q.float(), q4.float()
    kgf, vgf = kg.float(), vg.float()
    bms, by = bound(cost.paged_decode(B, H, KV, hd, keys, pages, 4, 4, 2,
                                      lse=True))
    rows.append(dict(
        name="paged_attention_lse", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:97",
        max_abs_err=max(lse_errs),
        ms=time_ms(torch, lambda: pk.paged_attention_kernel(
            qf, kp_, vp_, bt, ctx, return_lse=True)),
        plain_ms=time_ms(torch, lambda: pr.paged_attention_with_lse_ref(
            qf, kp_, vp_, bt, ctx), iters=5, windows=3),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qf4, kgf, vgf, attn_mask=mask))))
    del kg, vg, kgf, vgf

    append_row("chunk", "paged_append_chunk",
               "src/repro/kernels/paged_attention/kernel.py:224", 8, 512)

    # -- K4: paged flash prefill -----------------------------------------
    B, T = 4, 512
    prior_np = np.array([0, 1024, 2560, MB * page - T], np.int32)
    prior = t(prior_np, torch.int32)
    bt = tables(B)
    errs = []
    for dtype in (f32, bf16):
        kp_, vp_ = pools(dtype)
        q = t(rng.standard_normal((B, T, H, hd)), dtype)
        for window, prior_only in ((None, False), (1024, False),
                                   (None, True)):
            tag = f"paged_flash_prefill {dtype} window={window} " \
                  f"prior_only={prior_only}"
            if prior_only:
                g, gl = fk.paged_flash_prefill_kernel(
                    q.float(), kp_, vp_, bt, prior, prior_only=True,
                    return_lse=True)
                wnt, wl = fr.paged_prefill_sweep_with_lse_ref(
                    q.float(), kp_, vp_, bt, prior, prior_only=True)
                close(gl, wl, f32, tag + " (lse)")
            else:
                g = fk.paged_flash_prefill_kernel(q, kp_, vp_, bt, prior,
                                                  window=window)
                wnt = fr.paged_flash_prefill_ref(q, kp_, vp_, bt, prior,
                                                 window=window)
            e = close(g, wnt, dtype, tag)
            if dtype == bf16:
                errs.append(e)
    print(f"  paged_flash_prefill: {fk.prefill_blocks(B, T, H, KV)} blocks "
          f"of 64 packed rows")
    # keys per request: the prior and the chunk
    keys, pages = cost.live_keys(prior_np.astype(np.int64) + T, page)
    pairs = int(sum(T * int(p) + T * (T + 1) // 2 for p in prior_np))
    bms, by = bound(cost.paged_prefill(B, T, H, KV, hd, keys, pages, pairs,
                                       2, 2, 2))
    kg = paged_gather(kp_, bt).transpose(1, 2).repeat_interleave(H // KV, 1)
    vg = paged_gather(vp_, bt).transpose(1, 2).repeat_interleave(H // KV, 1)
    qpos = prior[:, None].long() + torch.arange(T, device=dev)[None, :]
    mask = (torch.arange(MB * page, device=dev)[None, None, :]
            <= qpos[:, :, None])[:, None]
    qt = q.transpose(1, 2)
    rows.append(dict(
        name="paged_flash_prefill", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_prefill.cu",
        replaces="src/repro/kernels/flash_prefill/kernel.py:204",
        max_abs_err=max(errs),
        ms=time_ms(torch, lambda: fk.paged_flash_prefill_kernel(
            q, kp_, vp_, bt, prior)),
        plain_ms=time_ms(torch, lambda: fr.paged_flash_prefill_ref(
            q, kp_, vp_, bt, prior), iters=3, warm=1, windows=3),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask), iters=5, windows=3)))
    del kg, vg, mask, q, kp_, vp_
    paged_rep_checks(torch, np, rng, gen, close)
    rows.extend(mla_rows(torch, np, rng, close))

    # -- K5: dense causal flash attention, forward and backward ----------
    tile_checks(torch, rng)
    print_hgmma()
    # the training shape of llama3-8b: batch 4 x 2048 tokens
    rows.extend(flash_rows(torch, gen, close, "", H, KV, hd, [(4, 2048)],
                           (None, 1024)))
    torch.cuda.empty_cache()
    rows.extend(ssd_rows(torch, gen))
    torch.cuda.empty_cache()
    rows.extend(rglru_rows(torch, gen))
    torch.cuda.empty_cache()
    # recurrentgemma-9b's attention: hd 256, 16 query heads on one kv
    # head, window 2048, at 2 x 4096 (where the window masks keys) and at
    # its training shape, 4 x 2048 (where it masks nothing)
    rows.extend(flash_rows(torch, gen, close, "_hd256", 16, 1, 256,
                           [(2, 4096), (4, 2048)], (2048,)))
    # phase 17's shapes, last, so that every check above draws the inputs
    # it drew before they were added: K2 and K4 at whisper-base's decoder
    # (H 8, KV 8, hd 64), K5 at hd 64
    torch.cuda.empty_cache()
    paged_rep_checks(torch, np, rng, gen, close, ((8, 8, 64, 512, 16),))
    flash_hd64_checks(torch, gen, close)
    # phase 18's shapes, after phase 17's for the same reason: K2 and K4
    # at hd 256 with a window, K6 and K7 from a carried state
    torch.cuda.empty_cache()
    rows.extend(recurrent_rows(torch, np, rng, gen, close))
    # phase 19's masked ragged batches, after phase 18's for the same
    # reason
    torch.cuda.empty_cache()
    masked_recurrent_checks(torch, gen)
    # phase 21's shapes, after phase 19's for the same reason: K5 at the
    # TP2-local heads of llama3-8b and Phi-3.5-MoE (16 of 32, 4 of 8 KV),
    # then RecurrentGemma's local attention at TP2 (8 of 16 heads on its
    # one KV head, hd 256, window 2048), K6 at 40 of mamba2-2.7b's 80
    # heads and K7 at 2048 of recurrentgemma-9b's 4096 channels
    torch.cuda.empty_cache()
    rows.extend(flash_rows(torch, gen, close, "_tp2", H // 2, KV // 2, hd,
                           [(4, 2048)], (None,)))
    torch.cuda.empty_cache()
    rows.extend(flash_rows(torch, gen, close, "_hd256_tp2", 8, 1, 256,
                           [(2, 4096), (4, 2048)], (2048,)))
    torch.cuda.empty_cache()
    rows.extend(ssd_rows(torch, gen, "_tp2", H=40, ragged=False))
    torch.cuda.empty_cache()
    rows.extend(rglru_rows(torch, gen, "_tp2", C=2048, ragged=False))
    # K5's fp32 route at query-head ratios that do not divide a block's
    # 64 rows, last for the same reason
    torch.cuda.empty_cache()
    flash_fp32_rep_checks(torch, close)
    _lib.reset_launches()
    torch.cuda.empty_cache()
    return rows


# paged_rep_checks' shapes: (H, KV, hd, prefill T, page)
REP_SHAPES = ((14, 2, 64, 512, 16), (96, 8, 128, 256, 16),
              (16, 4, 128, 512, 32))


def paged_rep_checks(torch, np, rng, gen, close,
                     shapes=REP_SHAPES) -> None:
    """K2 and K4 at rep = H/KV of 7 (internvl2-1b's language model: H 14,
    KV 2, hd 64) and 12 (mistral-large-123b: H 96, KV 8, hd 128), and at
    the view one rank of a merge-2 llama3-8b island reads (H 16, KV 4,
    hd 128, pages of 32 tokens; K1 and K3 there too, bit-exact), against
    their plain versions (``shapes``: (H, KV, hd, prefill T, page);
    phase 3 calls it again last at whisper-base's decoder, H 8, KV 8, hd
    64), at phase 3's decode shape (B 8, contexts 1 to
    4096) and prefill shape (B 4, T 512; T 256 at rep 12, where the plain
    version's scores take 1.6 GB a copy): bf16 q over bf16 pools (K4 on
    the tensor cores) and fp32 q over bf16 pools with lse (K4 on the CUDA
    cores); the bf16 kernels' times are printed."""
    from repro_torch.kernels.flash_prefill import kernel as fk
    from repro_torch.kernels.flash_prefill import ref as fr
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention import ref as pr

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    nblk, MB = 4096, 256

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)
    for H, KV, hd, Tp, page in shapes:
        rep = H // KV
        kp_, vp_ = (torch.randn((nblk, page, KV, hd), generator=gen,
                                device=dev).to(bf16) for _ in range(2))
        if page != 16:
            for kern, plain, shape in (
                    (pk.paged_append_token_kernel, pr.paged_append_token_ref,
                     (8,)),
                    (pk.paged_append_chunk_kernel, pr.paged_append_chunk_ref,
                     (4, Tp))):
                n = int(np.prod(shape))
                s = rng.choice((nblk - 1) * page, size=n, replace=False)
                slots = t(s.reshape(shape), torch.int32)
                vals = tuple(torch.randn(shape + (KV, hd), generator=gen,
                                         device=dev).to(bf16)
                             for _ in range(2))
                got = kern((kp_.clone(), vp_.clone()), vals, slots)
                want = plain((kp_.clone(), vp_.clone()), vals, slots)
                check(all(torch.equal(g, w) for g, w in zip(got, want)),
                      f"{kern.__name__} at page {page}, KV {KV} is not "
                      f"bit-exact")
                print(f"  {kern.__name__} page {page} KV {KV} "
                      f"{tuple(shape)}: bit-exact")
        B = 8
        ctx = t(np.concatenate([[1, MB * page], rng.integers(
            2, MB * page, size=B - 2)]), torch.int32)
        bt = t(rng.permutation(nblk - 1)[:B * MB].reshape(B, MB),
               torch.int32)
        q = torch.randn((B, H, hd), generator=gen, device=dev)
        n_split, split_len = pk.decode_splits(B, KV, rep, MB * page, dev)
        tag = f"paged_attention rep {rep} hd {hd} page {page}"
        close(pk.paged_attention_kernel(q.to(bf16), kp_, vp_, bt, ctx),
              pr.paged_attention_ref(q.to(bf16), kp_, vp_, bt, ctx), bf16,
              f"{tag} bf16")
        o, lse = pk.paged_attention_kernel(q, kp_, vp_, bt, ctx,
                                           return_lse=True)
        wo, wl = pr.paged_attention_with_lse_ref(q, kp_, vp_, bt, ctx)
        close(lse, wl, f32, f"{tag} fp32 q (lse)")
        close(o, wo, f32, f"{tag} fp32 q")
        ms = time_ms(torch, lambda: pk.paged_attention_kernel(
            q.to(bf16), kp_, vp_, bt, ctx))
        print(f"  {tag}: {n_split} splits of {split_len} keys, "
              f"{ms:.4f} ms (bf16)")
        B = 4
        prior = t(np.array([0, 1024, 2560, MB * page - Tp]), torch.int32)
        bt = t(rng.permutation(nblk - 1)[:B * MB].reshape(B, MB),
               torch.int32)
        q = torch.randn((B, Tp, H, hd), generator=gen, device=dev)
        tag = f"paged_flash_prefill rep {rep} hd {hd} T {Tp} page {page}"
        for window in (None, 1024):
            close(fk.paged_flash_prefill_kernel(q.to(bf16), kp_, vp_, bt,
                                                prior, window=window),
                  fr.paged_flash_prefill_ref(q.to(bf16), kp_, vp_, bt,
                                             prior, window=window),
                  bf16, f"{tag} bf16 window={window}")
        o, lse = fk.paged_flash_prefill_kernel(q, kp_, vp_, bt, prior,
                                               prior_only=True,
                                               return_lse=True)
        wo, wl = fr.paged_prefill_sweep_with_lse_ref(q, kp_, vp_, bt, prior,
                                                     prior_only=True)
        close(lse, wl, f32, f"{tag} fp32 q prior_only (lse)")
        close(o, wo, f32, f"{tag} fp32 q prior_only")
        ms = time_ms(torch, lambda: fk.paged_flash_prefill_kernel(
            q.to(bf16), kp_, vp_, bt, prior))
        print(f"  {tag}: {fk.prefill_blocks(B, Tp, H, KV)} blocks, "
              f"{ms:.4f} ms (bf16)")
        del kp_, vp_, q, o, wo
        torch.cuda.empty_cache()


def recurrent_rows(torch, np, rng, gen, close):
    """Phase 18's kernels at its shapes against their plain versions:
    K2 and K4 at recurrentgemma-9b's local attention (H 16, KV 1, hd 256,
    window 2048, page 16) over contexts past the window (decode B 8,
    contexts 1 to 4096; prefill B 8, T 512, priors up to 3584), bf16 q
    over bf16 pools and fp32 q with the LSE (K4's CUDA-core route); K6
    from a nonzero h0 at mamba2-2.7b's prefill chunk (Bs 8, T 512, 80
    heads of 64, d_state 128, chunk 128) in fp32 and bf16, and K7 from a
    nonzero h0 at recurrentgemma-9b's (B 8, T 512, 4096 channels, fp32
    a and g, as the RG-LRU block passes them), at K6's tolerance; each
    timed with its plain version, K2 and K4 with SDPA over the gathered
    context under the same mask."""
    import torch.nn.functional as F

    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_prefill import kernel as fk
    from repro_torch.kernels.flash_prefill import ref as fr
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention import ref as pr
    from repro_torch.kernels.rglru_scan import kernel as rk
    from repro_torch.kernels.rglru_scan import ref as rr
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan import ref as sr
    from repro_torch.models.cache import paged_gather

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    H, KV, hd, page, nblk, MB, win = 16, 1, 256, 16, 4096, 256, 2048
    rows = []

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    def rnd(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale
    kp_, vp_ = (rnd((nblk, page, KV, hd)).to(bf16) for _ in range(2))

    def gathered(bt):
        return tuple(paged_gather(p, bt).transpose(1, 2).repeat_interleave(
            H // KV, 1) for p in (kp_, vp_))

    # -- K2 at hd 256 ----------------------------------------------------
    B = 8
    ctx_np = np.concatenate([[1, MB * page], rng.integers(
        2, MB * page, size=B - 2)]).astype(np.int32)
    ctx = t(ctx_np, torch.int32)
    bt = t(rng.permutation(nblk - 1)[:B * MB].reshape(B, MB), torch.int32)
    q = rnd((B, H, hd))
    qb = q.to(bf16)
    tag = "paged_attention hd 256 rep 16"
    errs = [close(pk.paged_attention_kernel(qb, kp_, vp_, bt, ctx,
                                            window=w),
                  pr.paged_attention_ref(qb, kp_, vp_, bt, ctx, window=w),
                  bf16, f"{tag} bf16 window={w}") for w in (None, win)]
    c0 = ctx.clone()
    c0[2] = 0                                  # a row with no live key
    o, lse = pk.paged_attention_kernel(q, kp_, vp_, bt, c0, window=win,
                                       return_lse=True)
    wo, wl = pr.paged_attention_with_lse_ref(q, kp_, vp_, bt, c0,
                                             window=win)
    close(lse, wl, f32, f"{tag} fp32 q window={win} (lse)")
    close(o, wo, f32, f"{tag} fp32 q window={win}")
    keys, pages = cost.live_keys(
        np.minimum(np.minimum(ctx_np, MB * page), win), page)
    bms, by = bound(cost.paged_decode(B, H, KV, hd, keys, pages, 2, 2, 2))
    kg, vg = gathered(bt)
    kpos = torch.arange(MB * page, device=dev)[None, :]
    c = ctx[:, None].long()
    mask = ((kpos < c) & (kpos >= c - win))[:, None, None, :]
    n_split, split_len = pk.decode_splits(B, KV, H // KV, MB * page, dev)
    print(f"  {tag}: {n_split} splits of {split_len} keys")
    rows.append(dict(
        name="paged_attention_hd256", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:97",
        max_abs_err=max(errs),
        ms=time_ms(torch, lambda: pk.paged_attention_kernel(
            qb, kp_, vp_, bt, ctx, window=win)),
        plain_ms=time_ms(torch, lambda: pr.paged_attention_ref(
            qb, kp_, vp_, bt, ctx, window=win), iters=5, windows=3),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qb[:, :, None, :], kg, vg, attn_mask=mask))))
    del kg, vg, mask, o, wo

    # -- K4 at hd 256 ----------------------------------------------------
    T = 512
    prior_np = np.array([0, 512, 1024, 1536, 2048, 2560, 3072,
                         MB * page - T], np.int32)
    prior = t(prior_np, torch.int32)
    bt = t(rng.permutation(nblk - 1)[:B * MB].reshape(B, MB), torch.int32)
    q = rnd((B, T, H, hd))
    qb = q.to(bf16)
    tag = "paged_flash_prefill hd 256 rep 16 T 512"
    errs = [close(fk.paged_flash_prefill_kernel(qb, kp_, vp_, bt, prior,
                                                window=w),
                  fr.paged_flash_prefill_ref(qb, kp_, vp_, bt, prior,
                                             window=w),
                  bf16, f"{tag} bf16 window={w}") for w in (None, win)]
    for w, prior_only in ((win, False), (None, True)):
        o, lse = fk.paged_flash_prefill_kernel(
            q, kp_, vp_, bt, prior, window=w, prior_only=prior_only,
            return_lse=True)
        wo, wl = fr.paged_prefill_sweep_with_lse_ref(
            q, kp_, vp_, bt, prior, window=w, prior_only=prior_only)
        sub = f"{tag} fp32 q window={w} prior_only={prior_only}"
        close(lse, wl, f32, f"{sub} (lse)")
        close(o, wo, f32, sub)
    del o, wo, lse, wl
    print(f"  {tag}: {fk.prefill_blocks(B, T, H, KV)} blocks of 64 packed "
          f"rows")
    qpos = prior_np[:, None].astype(np.int64) + np.arange(T)[None, :]
    pairs = int(np.minimum(qpos + 1, win).sum())
    first = np.maximum(prior_np.astype(np.int64) - win + 1, 0)
    # the keys each request reads
    keys, pages = cost.live_keys(prior_np.astype(np.int64) + T - first,
                                 page)
    bms, by = bound(cost.paged_prefill(B, T, H, KV, hd, keys, pages, pairs,
                                       2, 2, 2))
    kg, vg = gathered(bt)
    qp = prior[:, None].long() + torch.arange(T, device=dev)[None, :]
    kpos = torch.arange(MB * page, device=dev)[None, None, :]
    mask = ((kpos <= qp[:, :, None]) & (kpos > qp[:, :, None] - win))[:, None]
    qt = qb.transpose(1, 2)
    rows.append(dict(
        name="paged_flash_prefill_hd256", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_prefill.cu",
        replaces="src/repro/kernels/flash_prefill/kernel.py:204",
        max_abs_err=max(errs),
        ms=time_ms(torch, lambda: fk.paged_flash_prefill_kernel(
            qb, kp_, vp_, bt, prior, window=win)),
        plain_ms=time_ms(torch, lambda: fr.paged_flash_prefill_ref(
            qb, kp_, vp_, bt, prior, window=win), iters=3, warm=1,
            windows=3),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask), iters=5, windows=3)))
    del kg, vg, mask, q, qb, qt, kp_, vp_
    torch.cuda.empty_cache()

    # -- K6 from h0 ------------------------------------------------------
    Bs, T, Hs, hds, S, ch = 8, 512, 80, 64, 128, 128

    def ssd_inputs(dtype):
        return (F.silu(rnd((Bs, T, Hs, hds))).to(dtype),
                F.softplus(rnd((Bs, T, Hs))),
                -torch.linspace(1.0, 16.0, Hs, device=dev),
                F.silu(rnd((Bs, T, S))).to(dtype),
                F.silu(rnd((Bs, T, S))).to(dtype))
    errs = []
    for dtype in (f32, bf16):
        ins = ssd_inputs(dtype)
        h0 = rnd((Bs, Hs, hds, S))
        y, hT, _ = sk.ssd_scan_kernel(*ins, chunk=ch, h0=h0)
        wy, wh = sr.ssd_chunked(*ins, h0, ch)
        tag = f"ssd_scan from h0 {dtype} [{Bs},{T},{Hs},{hds}] S={S}"
        errs.append(max(ssd_close(torch, g, w, f"{tag} {n}")
                        for n, g, w in (("y", y, wy), ("hT", hT, wh))))
        del y, hT, wy, wh
    # x, dt, A, B, C and h0 in, y and hT out
    bms, by = bound(cost.ssd(Bs, T, Hs, hds, S, ch, 2, 2, h0=True))
    rows.append(dict(
        name="ssd_scan_from", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:67",
        max_abs_err=max(errs),
        ms=time_ms(torch, lambda: sk.ssd_scan_kernel(*ins, chunk=ch,
                                                     h0=h0), iters=5),
        plain_ms=time_ms(torch, lambda: sr.ssd_chunked(*ins, h0, ch),
                         iters=3, warm=1, windows=3),
        bound_ms=bms, bound_by=by, library_ms=None))
    del ins, h0

    # -- K7 from h0 ------------------------------------------------------
    B, T, C = 8, 512, 4096
    a = 1.0 - 1e-3 * torch.rand((B, T, C), generator=gen, device=dev)
    g = rnd((B, T, C), 0.5)
    h0 = rnd((B, C))
    y, hT = rk.rglru_scan_kernel(a, g, h0)
    wy, wh = rr.rglru_scan_ref(a, g, h0)
    tag = f"rglru_scan from h0 fp32 [{B},{T},{C}] a near 1"
    e = max(ssd_close(torch, got, want, f"{tag} {n}")
            for n, got, want in (("y", y, wy), ("hT", hT, wh)))
    bms, by = bound(cost.rglru(B, T, C, 4, h0=True))
    rows.append(dict(
        name="rglru_scan_from", route="cuda",
        source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan/kernel.py:53",
        max_abs_err=e,
        ms=time_ms(torch, lambda: rk.rglru_scan_kernel(a, g, h0)),
        plain_ms=time_ms(torch, lambda: rr.rglru_scan_ref(a, g, h0),
                         iters=2, warm=1, windows=3),
        bound_ms=bms, bound_by=by, library_ms=None))
    del a, g, h0, y, wy
    return rows


def masked_recurrent_checks(torch, gen) -> None:
    """K6 and K7 from a nonzero h0 on a masked ragged batch, as phase 19's
    engine stages a prefill chunk: 8 rows of 512 positions with 512, 1,
    0, 300, 511, 77, 256 and 129 real ones, dt zero (K6) or a = 1 and g =
    0 (K7) past each row's count; K6 at mamba2-2.7b's shape in fp32 and
    bf16, K7 at recurrentgemma-9b's in fp32, against their plain versions
    at K6's tolerance (every position, and hT)."""
    import torch.nn.functional as F

    from repro_torch.kernels.rglru_scan import kernel as rk
    from repro_torch.kernels.rglru_scan import ref as rr
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan import ref as sr
    dev = torch.device("cuda")
    valid = torch.tensor([512, 1, 0, 300, 511, 77, 256, 129], device=dev)
    B, T = len(valid), 512
    pad = torch.arange(T, device=dev)[None] >= valid[:, None]

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=dev)
    Hs, hds, S, ch = 80, 64, 128, 128
    for dtype in (torch.float32, torch.bfloat16):
        x = F.silu(rnd((B, T, Hs, hds))).to(dtype)
        dt = torch.where(pad[..., None], 0.0, F.softplus(rnd((B, T, Hs))))
        A = -torch.linspace(1.0, 16.0, Hs, device=dev)
        Bm, Cm = (F.silu(rnd((B, T, S))).to(dtype) for _ in range(2))
        h0 = rnd((B, Hs, hds, S))
        y, hT, _ = sk.ssd_scan_kernel(x, dt, A, Bm, Cm, chunk=ch, h0=h0)
        wy, wh = sr.ssd_chunked(x, dt, A, Bm, Cm, h0, ch)
        tag = f"ssd_scan from h0 {dtype} masked ragged [{B},{T},{Hs},{hds}]"
        for n, g, w in (("y", y, wy), ("hT", hT, wh)):
            ssd_close(torch, g, w, f"{tag} {n}")
        del x, dt, Bm, Cm, h0, y, hT, wy, wh
    C = 4096
    a = torch.where(pad[..., None], 1.0,
                    1.0 - 1e-3 * torch.rand((B, T, C), generator=gen,
                                            device=dev))
    g = torch.where(pad[..., None], 0.0, 0.5 * rnd((B, T, C)))
    h0 = rnd((B, C))
    y, hT = rk.rglru_scan_kernel(a, g, h0)
    wy, wh = rr.rglru_scan_ref(a, g, h0)
    tag = f"rglru_scan from h0 fp32 masked ragged [{B},{T},{C}]"
    for n, got, want in (("y", y, wy), ("hT", hT, wh)):
        ssd_close(torch, got, want, f"{tag} {n}")


def mla_rows(torch, np, rng, close):
    """K2 at MLA width (``mla_decode``) against its plain version at
    DeepSeek-V2's decode shape (B 8, H 128, W 576, R 512, page 16,
    contexts 1 to 4096, fp32 q over a bf16 pool: the tensor-core
    ``decode_tc``), with and without a window, and at the reduced W 80 /
    R 64 and the Pallas test's W 48 / R 32; the one-pool K1 and K3 forms
    (the compressed cache) bit-exact. Times the kernels (the fp32 pool's
    CUDA-core ``decode`` beside the row's bf16 route), the plain
    versions and one PyTorch call each:
    SDPA over the context gathered (and cast to fp32) beforehand, one
    kv head whose 128 query heads are SDPA's query rows, the key mask
    of each request's context; ``index_copy_`` for the appends."""
    import torch.nn.functional as F

    from repro_torch.kernels import _lib, cost
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention import ref as pr
    from repro_torch.models.cache import paged_gather

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    B, H, W, R, page, nblk, MB = 8, 128, 576, 512, 16, 4096, 256
    rows = []

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    def case(B_, H_, W_, nblk_, MB_, page_, full_ctx):
        ctx = np.concatenate([[1, full_ctx], rng.integers(
            2, full_ctx, size=B_ - 2)]).astype(np.int32)
        return (t(rng.standard_normal((B_, H_, W_)) * W_ ** -0.5, f32),
                t(rng.standard_normal((nblk_, page_, W_)), bf16),
                t(rng.permutation(nblk_ - 1)[:B_ * MB_].reshape(B_, MB_),
                  torch.int32), t(ctx, torch.int32), ctx)

    q, pool, bt, ctx, ctx_np = case(B, H, W, nblk, MB, page, MB * page)
    err = err_lse = 0.0
    for window in (None, 1024):
        err = max(err, close(
            pk.paged_mla_attention_kernel(q, pool, bt, ctx, R=R,
                                          window=window),
            pr.paged_mla_attention_ref(q, pool, bt, ctx, R=R, window=window),
            f32, f"mla_decode B {B} H {H} W {W} R {R} window={window}"))
    # with its LSE (the striped pools' stripe partials), on both routes,
    # a row with no live key included: out bit for bit the no-LSE call's
    c0 = ctx.clone()
    c0[0] = 0
    for pdt in (bf16, f32):
        pl = pool.to(pdt)
        g, gl = pk.paged_mla_attention_kernel(q, pl, bt, c0, R=R,
                                              return_lse=True)
        wnt, wl = pr.paged_mla_attention_ref(q, pl, bt, c0, R=R,
                                             return_lse=True)
        tag = f"mla_decode {pdt} pool, with its LSE"
        check(torch.equal(g, pk.paged_mla_attention_kernel(q, pl, bt, c0,
                                                           R=R)),
              f"{tag}: the output moved with the LSE asked")
        e = max(close(g, wnt, f32, tag), close(gl, wl, f32, tag + " (lse)"))
        if pdt == bf16:
            err_lse = e
        del pl
    for H_, W_, R_, page_ in ((4, 80, 64, 16), (8, 48, 32, 8)):
        q2, pool2, bt2, ctx2, _ = case(B, H_, W_, 512, 32, page_,
                                       32 * page_)
        close(pk.paged_mla_attention_kernel(q2, pool2, bt2, ctx2, R=R_),
              pr.paged_mla_attention_ref(q2, pool2, bt2, ctx2, R=R_), f32,
              f"mla_decode B {B} H {H_} W {W_} R {R_} page {page_}")
    n_split, split_len = pk.mla_splits(B, H, MB * page, dev)
    live = ctx_np.astype(np.int64)
    keys, pages = cost.live_keys(live, page)
    c_mla = cost.mla_decode(B, H, W, R, keys, pages, 4, 2)
    nbytes, flops = c_mla.nbytes, c_mla.flops
    bms, by = bound(c_mla)
    kg = paged_gather(pool, bt).float()[:, None]          # [B,1,Tk,W]
    vg = kg[..., :R]
    mask = (torch.arange(MB * page, device=dev)[None, :]
            < ctx[:, None].long())[:, None, None, :]
    qs = q[:, None]                                       # [B,1,H,W]
    print(f"  mla_decode: {n_split} splits of {split_len} keys, "
          f"{n_split * B * -(-H // pk.MLA_HEADS)} blocks "
          f"({int(np.ceil(live / split_len).sum()) * -(-H // pk.MLA_HEADS)}"
          f" with live keys)")
    row = dict(
        name="mla_decode", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:97",
        max_abs_err=err,
        ms=time_ms(torch, lambda: pk.paged_mla_attention_kernel(
            q, pool, bt, ctx, R=R)),
        plain_ms=time_ms(torch, lambda: pr.paged_mla_attention_ref(
            q, pool, bt, ctx, R=R), iters=5, windows=3),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask, scale=1.0)))
    rows.append(row)
    bms_l, by_l = bound(cost.mla_decode(B, H, W, R, keys, pages, 4, 2,
                                        lse=True))
    row_lse = dict(
        name="mla_decode_lse", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:97",
        max_abs_err=err_lse,
        ms=time_ms(torch, lambda: pk.paged_mla_attention_kernel(
            q, pool, bt, ctx, R=R, return_lse=True)),
        plain_ms=time_ms(torch, lambda: pr.paged_mla_attention_ref(
            q, pool, bt, ctx, R=R, return_lse=True), iters=5, windows=3),
        bound_ms=bms_l, bound_by=by_l, library_ms=row["library_ms"])
    rows.append(row_lse)
    print(f"  mla_decode: {row['ms']:.4f} ms a call with no LSE asked, "
          f"{row_lse['ms']:.4f} ms with its LSE (events)")
    dev_ms = launch_device_ms(torch, lambda: pk.paged_mla_attention_kernel(
        q, pool, bt, ctx, R=R), "decode_tc")
    pool32 = pool.float()
    err32 = close(pk.paged_mla_attention_kernel(q, pool32, bt, ctx, R=R),
                  pr.paged_mla_attention_ref(q, pool32, bt, ctx, R=R), f32,
                  f"mla_decode B {B} H {H} W {W} R {R} fp32 pool")
    ms32 = time_ms(torch, lambda: pk.paged_mla_attention_kernel(
        q, pool32, bt, ctx, R=R))
    dev32 = launch_device_ms(torch, lambda: pk.paged_mla_attention_kernel(
        q, pool32, bt, ctx, R=R), "decode")
    del pool32
    # the tensor cores' work: S = q K^T over W and O = P V over R, each
    # with its bf16 A operand (q, P) as hi + lo, for 64-head blocks
    hb = -(-H // pk.MLA_HEADS) * pk.MLA_HEADS
    tc_flops = 2.0 * 2 * (W + R) * hb * int(live.sum())
    print(f"  mla_decode: bf16 pool (decode_tc, tensor cores) events "
          f"{row['ms']:.4f} ms a call, device {dev_ms:.4f} ms a launch "
          f"(profiler); fp32 pool (decode, CUDA cores) events {ms32:.4f} ms, "
          f"device {dev32:.4f} ms, max_abs_err {err32:.3g}; bound "
          f"{bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} "
          f"GFLOP); the tensor cores run {tc_flops / 1e9:.2f} GFLOP (q and "
          f"P as hi + lo), {tc_flops / 989e12 * 1e3:.4f} ms at the bf16 "
          f"peak, {tc_flops / (dev_ms * 1e-3) / 1e12:.1f} TFLOP/s in this "
          f"run; decode_tc's dynamic shared memory "
          f"{_lib.func('mla_decode_tc_smem')()} bytes")
    del kg, vg, mask, qs

    # the one-pool appends: DeepSeek-V2's entries of 576 bf16
    flat = pool.view(-1, W)
    for kind, shape, name, replaces in (
            ("token", (B,), "paged_append_token_mla",
             "src/repro/kernels/paged_attention/kernel.py:165"),
            ("chunk", (B, 512), "paged_append_chunk_mla",
             "src/repro/kernels/paged_attention/kernel.py:224")):
        kern = pk.paged_append_token_kernel if kind == "token" \
            else pk.paged_append_chunk_kernel
        plain = pr.paged_append_token_ref if kind == "token" \
            else pr.paged_append_chunk_ref
        n = int(np.prod(shape))
        s = rng.choice((nblk - 1) * page, size=n, replace=False)
        s[rng.random(n) < 0.25] = -1                      # parked rows
        slots = t(s.reshape(shape), torch.int32)
        for dtype in (f32, bf16):
            vals = (t(rng.standard_normal(shape + (W,)), dtype),)
            (got,) = kern((pool.clone(),), vals, slots)
            (want,) = plain((pool.clone(),), vals, slots)
            torch.cuda.synchronize()
            check(torch.equal(got.view(-1, W)[:-1], want.view(-1, W)[:-1]),
                  f"{name} ({dtype} values) is not bit-exact")
        print(f"  {name} {tuple(shape)}: bit-exact")
        idx = torch.where(slots.reshape(-1) >= 0, slots.reshape(-1).long(),
                          nblk * page - 1)
        rows_v = vals[0].reshape(n, W)
        bms, by = bound(cost.append(n, W, 1, 2, 2))
        row = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/paged_append.cu",
            replaces=replaces, max_abs_err=0.0,
            ms=time_ms(torch, lambda: kern((pool,), vals, slots)),
            plain_ms=time_ms(torch, lambda: plain((pool,), vals, slots)),
            bound_ms=bms, bound_by=by,
            library_ms=time_ms(torch, lambda: flat.index_copy_(0, idx,
                                                               rows_v)))
        rows.append(row)
        dev_ms = launch_device_ms(torch, lambda: kern((pool,), vals, slots),
                                  "append_rows")
        print(f"  {name} ({n} rows of {W}): events {row['ms']:.4f} ms a "
              f"call, device {dev_ms:.4f} ms a launch (profiler)")
    del pool
    torch.cuda.empty_cache()
    return rows


def tile_checks(torch, rng):
    """The bf16 K5 kernels' tile machinery on one tile pair of each
    operand layout, against torch.matmul in fp32 (TF32 off), each entry
    held to a bound on its rounding: a b^T (both bf16 operands K-major in
    swizzled shared memory) by fp32 summation, hd units of 2^-24 of
    sum |a||b|; a b (a fp32 as bf16 hi + lo register fragments, b
    N-major) by 2^-16 of sum |a||b|."""
    from repro_torch.kernels.flash_prefill import kernel as fk

    dev = torch.device("cuda")

    def t(shape, dtype=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(shape)).to(dev, dtype)
    for hd in (64, 128, 256):
        a, b = t((64, hd)), t((64, hd))
        got = fk.flash_tile_check(a, b, 0)
        want = a.float() @ b.float().T
        lim = (a.float().abs() @ b.float().abs().T) * hd * 2.0 ** -24
        e0 = float((got - want).abs().max())
        check(bool(((got - want).abs() <= lim).all()),
              f"tile product a b^T at hd {hd} off by {e0:.3e}")
        a = t((64, 64), torch.float32)
        got = fk.flash_tile_check(a, b, 1)
        want = a @ b.float()
        lim = (a.abs() @ b.float().abs()) * 2.0 ** -16
        e1 = float((got - want).abs().max())
        check(bool(((got - want).abs() <= lim).all()),
              f"tile product a b at hd {hd} off by {e1:.3e}")
        print(f"  tile products at hd {hd} against torch.matmul: a b^T "
              f"(SS, K-major) max_abs_err={e0:.3e}, a b (RS hi + lo, "
              f"N-major) max_abs_err={e1:.3e}")


def print_hgmma() -> None:
    """HGMMA instructions in the SASS of each kernel of the flash_prefill,
    paged_prefill and ssd_scan libraries (cuobjdump), where cuobjdump
    exists; printed, and K4's bf16 kernel (prefill_tc) and K6's bf16
    tensor-core kernels (forward chunk_state_tc, chunk_scan_tc; backward
    dc_tc, dxb_tc) must have some in every instance."""
    import re
    import shutil

    from repro_torch.kernels import _lib

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(exe).exists():
        print("  HGMMA count: not measured (no cuobjdump)")
        return
    counts: dict = {}
    for name in ("flash_prefill", "paged_prefill", "ssd_scan"):
        sass = subprocess.run([exe, "-sass", str(_lib.build_all()[name])],
                              capture_output=True, text=True).stdout
        fn = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = kernel_label(m.group(1))
                counts[fn] = 0
            elif fn and "HGMMA" in line:
                counts[fn] += 1
    print("  HGMMA instructions in SASS: " + ", ".join(
        f"{k} {v}" for k, v in sorted(counts.items())))
    for hd in (64, 128):
        check(counts.get(f"prefill_tc<{hd}>", 0) > 0,
              f"K4's bf16 kernel prefill_tc<{hd}> has no HGMMA")
    for k in ("chunk_state_tc", "chunk_scan_tc", "dc_tc", "dxb_tc"):
        for hd in (32, 64):
            for S in (32, 128):
                check(counts.get(f"{k}<{hd}, {S}>", 0) > 0,
                      f"K6's bf16 kernel {k}<{hd}, {S}> has no HGMMA")


def ssd_close(torch, got, want, what):
    """K6's tolerance: an atol of 1e-4 times the largest entry of the
    plain output (dA and dt sum thousands of terms that cancel, so fp32
    error scales with the terms, not the result), and rtol 1e-4 in fp32.
    For bf16 outputs (dx, dB, dC with bf16 inputs) both sides compute in
    fp32 and round once, so they differ by that fp32 error plus at most
    one bf16 unit of the entry, which is at most 2**-7 of it: rtol
    2**-7."""
    got = got.detach()
    rtol = 1e-4 if got.dtype == torch.float32 else 2.0 ** -7
    scale = float(want.float().abs().max())
    e = float((got.float() - want.float()).abs().max())
    ok = torch.allclose(got.float(), want.float(), rtol=rtol,
                        atol=1e-4 * scale)
    print(f"  {what}: max_abs_err={e:.3e} (largest entry {scale:.3e})")
    check(ok, f"{what} disagrees with its plain version (max {e:.3e})")
    return e


def ssd_rows(torch, gen, suffix: str = "", H: int = 80,
             ragged: bool = True):
    """K6 forward and backward against their plain versions at the
    training shape of mamba2-2.7b (batch 4 x 2048 tokens, ``H`` heads of
    64: all 80, or a rank's share under TP; d_state 128, chunk 128) and,
    with ``ragged``, at a small ragged shape through the autograd op, in
    fp32 and with bf16 x, B and C (the tensor-core routes; the backward
    is fed the forward's states); then timed in bf16 at the training
    shape (with ``ragged``, with each bf16 forward kernel's device time a
    call). Rows ``ssd_scan{suffix}`` and ``ssd_scan_bwd{suffix}``."""
    import torch.nn.functional as F

    from repro_torch.kernels import cost
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan import ops as so
    from repro_torch.kernels.ssd_scan import ref as sr

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16

    def rnd(shape, dtype=f32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def inputs(Bs, T, H, hd, S, dtype):
        # the model's ranges: A = -exp(log(linspace(1, 16))), dt a
        # softplus, x and B/C after the SiLU'd convolution
        return (F.silu(rnd((Bs, T, H, hd))).to(dtype),
                F.softplus(rnd((Bs, T, H))),
                -torch.linspace(1.0, 16.0, H, device=dev),
                F.silu(rnd((Bs, T, S))).to(dtype),
                F.silu(rnd((Bs, T, S))).to(dtype))
    errs = {"fwd": [], "bwd": []}
    Bs, T, hd, S, ch = 4, 2048, 64, 128, 128
    for dtype in (f32, bf16):
        ins = inputs(Bs, T, H, hd, S, dtype)
        dy = rnd((Bs, T, H, hd))
        tag = f"ssd_scan {dtype} [{Bs},{T},{H},{hd}] S={S}"
        y, hT, st = sk.ssd_scan_kernel(*ins, chunk=ch)
        wy, wh, wst = sr.ssd_scan_fwd_ref(*ins, chunk=ch)
        e = max(ssd_close(torch, g, w, f"{tag} {n}")
                for n, g, w in (("y", y, wy), ("hT", hT, wh),
                                ("states", st, wst)))
        del wy, wh, wst
        grads = sk.ssd_scan_bwd_kernel(*ins, st, dy, chunk=ch)
        wants = sr.ssd_scan_bwd_ref(*ins, dy, chunk=ch)
        eb = max(ssd_close(torch, g, w, f"ssd_scan_bwd {dtype} d{n}")
                 for n, g, w in zip(("x", "dt", "A", "B", "C"), grads,
                                    wants))
        errs["fwd"].append(e)
        errs["bwd"].append(eb)
        del grads, wants, y, hT, st
        torch.cuda.empty_cache()
    # a ragged T through the autograd op (padded to a multiple of 32)
    for dtype in (f32, bf16) if ragged else ():
        ins = inputs(2, 100, 3, 32, 32, dtype)
        leaves = [t.clone().requires_grad_(True) for t in ins]
        dy = rnd((2, 100, 3, 32))
        y, _ = so.ssd_scan(*leaves, chunk=32)
        grads = torch.autograd.grad(y, leaves, dy)
        pad = [F.pad(t, (0, 0) * (t.dim() - 2) + (0, 28))
               if t.dim() > 1 else t for t in ins]
        wy, _, _ = sr.ssd_scan_fwd_ref(*pad, chunk=32)
        wants = sr.ssd_scan_bwd_ref(*pad, F.pad(dy, (0, 0, 0, 0, 0, 28)),
                                    chunk=32)
        ssd_close(torch, y, wy[:, :100], f"ssd_scan op {dtype} T=100 y")
        if dtype == bf16:
            dA_fp64_diagnostic(torch, sr, pad, dy, grads[2], wants[2])
        for n, g, w in zip(("x", "dt", "A", "B", "C"), grads, wants):
            ssd_close(torch, g, w[:, :100] if w.dim() > 1 else w,
                      f"ssd_scan op {dtype} T=100 d{n}")

    # timed in bf16 at the training shape
    ins = inputs(Bs, T, H, hd, S, bf16)
    dy = rnd((Bs, T, H, hd))
    y, hT, st = sk.ssd_scan_kernel(*ins, chunk=ch)
    # the bounds count the function's own inputs and outputs, not the
    # per-chunk states this design passes from its forward to its
    # backward (``kernels/cost.py::ssd``)
    fwd_b = bound(cost.ssd(Bs, T, H, hd, S, ch, 2, 2))
    bwd_b = bound(cost.ssd(Bs, T, H, hd, S, ch, 2, 2, backward=True))

    def fwd():
        sk.ssd_scan_kernel(*ins, chunk=ch)
    rows = [dict(
        name=f"ssd_scan{suffix}", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:67",
        max_abs_err=max(errs["fwd"]),
        ms=time_ms(torch, fwd, iters=5),
        plain_ms=time_ms(torch, lambda: sr.ssd_scan_fwd_ref(*ins, chunk=ch),
                         iters=3, warm=1, windows=3),
        bound_ms=fwd_b[0], bound_by=fwd_b[1], library_ms=None), dict(
        name=f"ssd_scan_bwd{suffix}", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:67",
        max_abs_err=max(errs["bwd"]),
        ms=time_ms(torch, lambda: sk.ssd_scan_bwd_kernel(
            *ins, st, dy, chunk=ch), iters=5),
        plain_ms=time_ms(torch, lambda: sr.ssd_scan_bwd_ref(
            *ins, dy, chunk=ch), iters=2, warm=1, windows=3),
        bound_ms=bwd_b[0], bound_by=bwd_b[1], library_ms=None)]
    if ragged:
        dev = {k: launch_device_ms(torch, fwd, k, iters=5)
               for k in SSD_FWD_TC}
        print(f"  ssd_scan bf16 [{Bs},{T},{H},{hd}] S={S}: events "
              f"{rows[0]['ms']:.4f} ms a call; device a call (profiler): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in dev.items())
              + f" (sum {sum(dev.values()):.4f} ms)")
    del ins, dy, y, hT, st
    return rows


def dA_fp64_diagnostic(torch, sr, pad, dy, dA_kernel, dA_plain) -> None:
    """A diagnostic line, no check: the bf16 op's dA at T = 100 (the
    kernel's, and the plain version's, which computes in fp32 from the
    same bf16 inputs) beside the plain backward in fp64 on those inputs,
    so a reading near the check's margin says which of the two sits
    nearer the exact gradient."""
    import torch.nn.functional as F
    ins64 = [t.double() for t in pad]
    dA64 = sr.ssd_scan_bwd_ref(*ins64, F.pad(dy, (0, 0, 0, 0, 0, 28))
                               .double(), chunk=32)[2]
    scale = float(dA64.abs().max())
    ek = float((dA_kernel.double() - dA64).abs().max())
    ep = float((dA_plain.double() - dA64).abs().max())
    print(f"  ssd_scan op bf16 T=100 dA against fp64 (diagnostic): kernel "
          f"{ek:.3e}, fp32 plain version {ep:.3e} (largest entry "
          f"{scale:.3e}; the check's atol {1e-4 * scale:.3e})")


def rglru_rows(torch, gen, suffix: str = "", C: int = 4096,
               ragged: bool = True):
    """K7 forward and backward against their plain versions at the
    training shape of recurrentgemma-9b (batch 4 x 2048 tokens, ``C``
    channels: all 4096, or a rank's share under TP; fp32, as the RG-LRU
    block passes them) with two draws of a, and with ``ragged`` at a
    ragged shape through the autograd op in fp32 and bf16; then timed at
    the training shape. Rows ``rglru_scan{suffix}`` and
    ``rglru_scan_bwd{suffix}``."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.rglru_scan import kernel as rk
    from repro_torch.kernels.rglru_scan import ops as ro
    from repro_torch.kernels.rglru_scan import ref as rr

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=dev)

    def inputs(B, T, C, draw, dtype=f32):
        # a as test_rglru_scan draws it, or within 1e-3 of 1 so that the
        # carry over all of T matters; g = 0.5 N(0, 1)
        a = torch.sigmoid(rnd((B, T, C))) if draw == "sigmoid" else \
            1.0 - 1e-3 * torch.rand((B, T, C), generator=gen, device=dev)
        return a.to(dtype), (0.5 * rnd((B, T, C))).to(dtype)
    errs = {"fwd": [], "bwd": []}
    B, T = 4, 2048
    for draw in ("sigmoid", "near 1"):
        a, g = inputs(B, T, C, draw)
        dy = rnd((B, T, C))
        tag = f"rglru_scan fp32 [{B},{T},{C}] a {draw}"
        y, hT = rk.rglru_scan_kernel(a, g)
        wy, wh = rr.rglru_scan_ref(a, g)
        errs["fwd"].append(max(ssd_close(torch, got, want, f"{tag} {n}")
                               for n, got, want in (("y", y, wy),
                                                    ("hT", hT, wh))))
        grads = rk.rglru_scan_bwd_kernel(a, y, dy)
        wants = rr.rglru_scan_bwd_ref(a, y, dy)
        errs["bwd"].append(max(
            ssd_close(torch, got, want, f"rglru_scan_bwd {tag} d{n}")
            for n, got, want in zip("ag", grads, wants)))
        del grads, wants, wy, wh, y, hT, dy
    for dtype in (f32, bf16) if ragged else ():
        a, g = inputs(1, 100, 96, "near 1", dtype)
        leaves = [a.clone().requires_grad_(True),
                  g.clone().requires_grad_(True)]
        dy = rnd((1, 100, 96))
        y, _ = ro.rglru_scan(*leaves)
        grads = torch.autograd.grad(y, leaves, dy)
        wy, _ = rr.rglru_scan_ref(a, g)
        ssd_close(torch, y, wy, f"rglru_scan op {dtype} (1,100,96) y")
        for n, got, want in zip("ag", grads,
                                rr.rglru_scan_bwd_ref(a, wy, dy)):
            ssd_close(torch, got, want, f"rglru_scan op {dtype} (1,100,96) "
                                        f"d{n}")

    a, g = inputs(B, T, C, "sigmoid")
    dy = rnd((B, T, C))
    y, _ = rk.rglru_scan_kernel(a, g)
    # all fp32 (``kernels/cost.py::rglru``)
    fwd_b = bound(cost.rglru(B, T, C, 4))
    bwd_b = bound(cost.rglru(B, T, C, 4, backward=True))
    rows = [dict(
        name=f"rglru_scan{suffix}", route="cuda",
        source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan/kernel.py:53",
        max_abs_err=max(errs["fwd"]),
        ms=time_ms(torch, lambda: rk.rglru_scan_kernel(a, g)),
        plain_ms=time_ms(torch, lambda: rr.rglru_scan_ref(a, g), iters=2,
                         warm=1, windows=3),
        bound_ms=fwd_b[0], bound_by=fwd_b[1], library_ms=None), dict(
        name=f"rglru_scan_bwd{suffix}", route="cuda",
        source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan/kernel.py:53",
        max_abs_err=max(errs["bwd"]),
        ms=time_ms(torch, lambda: rk.rglru_scan_bwd_kernel(a, y, dy)),
        plain_ms=time_ms(torch, lambda: rr.rglru_scan_bwd_ref(a, y, dy),
                         iters=2, warm=1, windows=3),
        bound_ms=bwd_b[0], bound_by=bwd_b[1], library_ms=None)]
    del a, g, y, dy
    return rows


# flash_fp32_rep_checks' shapes: (B, T, H, KV, hd, window)
FP32_REP_SHAPES = ((2, 300, 14, 2, 64, None), (2, 300, 14, 2, 64, 40),
                   (1, 256, 96, 8, 128, None), (1, 256, 96, 8, 128, 64))


def flash_fp32_rep_checks(torch, close) -> None:
    """K5 forward and backward on its fp32 route (the CUDA cores) at rep
    = H/KV of 7 (internvl2-1b's H 14, KV 2, hd 64) and 12
    (mistral-large-123b's H 96, KV 8, hd 128), which do not divide a
    block's 64 rows (its rows past 63 and 60 idle), with and without a
    window, against the plain version at the fp32 tolerance; the errors
    printed."""
    from repro_torch.kernels.flash_prefill import kernel as fk
    from repro_torch.kernels.flash_prefill import ref as fr
    dev, f32 = torch.device("cuda"), torch.float32
    gen = torch.Generator(device=dev).manual_seed(7)

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=dev)
    for B, T, H, KV, hd, window in FP32_REP_SHAPES:
        q, do = rnd((B, T, H, hd)), rnd((B, T, H, hd))
        k, v = rnd((B, T, KV, hd)), rnd((B, T, KV, hd))
        tag = f"fp32 rep {H // KV} hd {hd} [{B},{T}] window={window}"
        o, lse = fk.flash_prefill_kernel(q, k, v, window=window)
        wo, wl = fr.flash_prefill_fwd_ref(q, k, v, window=window)
        close(lse, wl, f32, f"flash_prefill {tag} (lse)")
        close(o, wo, f32, f"flash_prefill {tag}")
        grads = fk.flash_prefill_bwd_kernel(q, k, v, o, lse, do,
                                            window=window)
        wants = fr.flash_prefill_bwd_ref(q, k, v, o, lse, do, window=window)
        for n, g, w_ in zip("qkv", grads, wants):
            close(g, w_, f32, f"flash_prefill_bwd {tag} d{n}")
        del q, do, k, v, o, lse, wo, wl, grads, wants


def flash_hd64_checks(torch, gen, close) -> None:
    """K5 forward and backward at hd 64, the attention of phase 17's
    training runs: whisper-base's decoder (H 8, KV 8) at batch 8 x 448
    and internvl2-1b's language model (H 14, KV 2) at batch 4 x 2304
    (256 patches and 2048 text tokens), causal, in bf16 (the fp32 route
    refuses rep 7), against their plain versions; each printed with its
    time, its bound (as ``flash_rows`` counts it) and SDPA's time."""
    import torch.nn.functional as F

    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_prefill import kernel as fk
    from repro_torch.kernels.flash_prefill import ref as fr

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    hd = 64

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)
    for H, KV, B, T in ((8, 8, 8, 448), (14, 2, 4, 2304)):
        q, do = rnd((B, T, H, hd)), rnd((B, T, H, hd))
        k, v = rnd((B, T, KV, hd)), rnd((B, T, KV, hd))
        tag = f"hd 64 rep {H // KV} bf16 [{B},{T}]"
        o, lse = fk.flash_prefill_kernel(q, k, v)
        wo, wl = fr.flash_prefill_fwd_ref(q, k, v)
        close(lse, wl, f32, f"flash_prefill {tag} (lse)")
        close(o, wo, bf16, f"flash_prefill {tag}")
        grads = fk.flash_prefill_bwd_kernel(q, k, v, o, lse, do)
        wants = fr.flash_prefill_bwd_ref(q, k, v, o, lse, do)
        for n, g, w_ in zip("qkv", grads, wants):
            close(g, w_, bf16, f"flash_prefill_bwd {tag} d{n}")
        del grads, wants, wo, wl
        fwd_b = bound(cost.flash(B, T, H, KV, hd, 2))
        bwd_b = bound(cost.flash(B, T, H, KV, hd, 2, backward=True))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        lo = F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in leaves), is_causal=True,
            enable_gqa=True)
        dot = do.transpose(1, 2)
        times = (
            ("flash_prefill", fwd_b, time_ms(torch, lambda: (
                fk.flash_prefill_kernel(q, k, v))),
             time_ms(torch, lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True, enable_gqa=True))),
            ("flash_prefill_bwd", bwd_b, time_ms(torch, lambda: (
                fk.flash_prefill_bwd_kernel(q, k, v, o, lse, do)),
                iters=5, windows=3),
             time_ms(torch, lambda: torch.autograd.grad(
                 lo, leaves, dot, retain_graph=True), iters=5, windows=3)))
        for name, b, ms, lib_ms in times:
            print(f"  {name} {tag}: {ms:.4f} ms, bound {b[0]:.4f} ms "
                  f"({b[1]}; {b[0] / ms:.1%} of it), SDPA {lib_ms:.4f} ms")
        del lo, leaves, q, k, v, do, o, lse


def flash_rows(torch, gen, close, suffix: str, H: int, KV: int, hd: int,
               shapes, windows):
    """K5 forward and backward against their plain versions at each
    (batch, tokens) of ``shapes`` and each window, in fp32 and bf16; then
    timed in bf16 at the last shape and the first window against SDPA,
    causal with GQA (the same function there: the timed window is None
    or no shorter than T). Rows ``flash_prefill{suffix}`` and
    ``flash_prefill_bwd{suffix}``."""
    import torch.nn.functional as F

    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_prefill import kernel as fk
    from repro_torch.kernels.flash_prefill import ref as fr

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16

    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    errs = {"fwd": [], "bwd": []}
    for B, T in shapes:
        for dtype in (f32, bf16):
            q, do = rnd((B, T, H, hd), dtype), rnd((B, T, H, hd), dtype)
            k, v = rnd((B, T, KV, hd), dtype), rnd((B, T, KV, hd), dtype)
            for window in windows:
                tag = f"hd {hd} {dtype} [{B},{T}] window={window}"
                o, lse = fk.flash_prefill_kernel(q, k, v, window=window)
                wo, wl = fr.flash_prefill_fwd_ref(q, k, v, window=window)
                close(lse, wl, f32, f"flash_prefill {tag} (lse)")
                e = close(o, wo, dtype, f"flash_prefill {tag}")
                grads = fk.flash_prefill_bwd_kernel(q, k, v, o, lse, do,
                                                    window=window)
                wants = fr.flash_prefill_bwd_ref(q, k, v, o, lse, do,
                                                 window=window)
                eb = max(close(g, w_, dtype,
                               f"flash_prefill_bwd {tag} d{n}")
                         for n, g, w_ in zip("qkv", grads, wants))
                if dtype == bf16:
                    errs["fwd"].append(e)
                    errs["bwd"].append(eb)
                del grads, wants, wo, wl, o, lse
            torch.cuda.empty_cache()

    # timed on the last shape's bf16 inputs
    (B, T), window = shapes[-1], windows[0]
    o, lse = fk.flash_prefill_kernel(q, k, v, window=window)
    # live (query row, key) pairs under the causal mask and the window
    pairs = B * H * cost.causal_pairs(T, window)
    fwd_b = bound(cost.flash(B, T, H, KV, hd, 2, window))
    bwd_b = bound(cost.flash(B, T, H, KV, hd, 2, window, backward=True))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    lo = F.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in leaves), is_causal=True,
        enable_gqa=True)
    dot = do.transpose(1, 2)
    # SDPA's own bf16 error against the same plain version: the yardstick
    # of what bf16 rounding costs
    wo, wl = fr.flash_prefill_fwd_ref(q, k, v, window=window)
    sdpa_fwd = float((lo.detach().transpose(1, 2).float() - wo.float())
                     .abs().max())
    wants = fr.flash_prefill_bwd_ref(q, k, v, wo, wl, do, window=window)
    sdpa_bwd = max(float((g.float() - w_.float()).abs().max())
                   for g, w_ in zip(torch.autograd.grad(
                       lo, leaves, dot, retain_graph=True), wants))
    del wo, wl, wants
    ms = time_ms(torch, lambda: fk.flash_prefill_kernel(
        q, k, v, window=window))
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    bwd_ms = time_ms(torch, lambda: fk.flash_prefill_bwd_kernel(
        q, k, v, o, lse, do, window=window), iters=5, windows=3)
    bwd_lib_ms = time_ms(torch, lambda: torch.autograd.grad(
        lo, leaves, dot, retain_graph=True))
    for name, t_ms, flops, b, e, sd in (
            ("flash_prefill", ms, 4.0 * hd * pairs, fwd_b,
             max(errs["fwd"]), sdpa_fwd),
            ("flash_prefill_bwd", bwd_ms, 10.0 * hd * pairs, bwd_b,
             max(errs["bwd"]), sdpa_bwd)):
        print(f"  {name}{suffix} bf16 [{B},{T}] hd {hd}: {t_ms:.4f} ms = "
              f"{flops / t_ms / 1e9:.1f} TFLOP/s ({flops / 1e9:.1f} GFLOP "
              f"on live pairs), {b[0] / t_ms:.1%} of its bound; max_abs_err "
              f"{e:.3e} against the plain version, SDPA's {sd:.3e}")
    rows = [dict(
        name="flash_prefill" + suffix, route="cuda",
        source="src/repro_torch/kernels/csrc/flash_prefill.cu",
        replaces="src/repro/kernels/flash_prefill/kernel.py:74",
        max_abs_err=max(errs["fwd"]), ms=ms,
        plain_ms=time_ms(torch, lambda: fr.flash_prefill_fwd_ref(
            q, k, v, window=window), iters=3, warm=1, windows=3),
        bound_ms=fwd_b[0], bound_by=fwd_b[1], library_ms=lib_ms), dict(
        name="flash_prefill_bwd" + suffix, route="cuda",
        source="src/repro_torch/kernels/csrc/flash_prefill.cu",
        replaces="src/repro/kernels/flash_prefill/kernel.py:74",
        max_abs_err=max(errs["bwd"]), ms=bwd_ms,
        plain_ms=time_ms(torch, lambda: fr.flash_prefill_bwd_ref(
            q, k, v, o, lse, do, window=window), iters=3, warm=1,
            windows=3),
        bound_ms=bwd_b[0], bound_by=bwd_b[1], library_ms=bwd_lib_ms)]
    del lo, leaves, o, lse, q, k, v, do
    return rows


# ---------------------------------------------------------------------------
# phase 4: the whole path on the card against the plain path on the CPU
# ---------------------------------------------------------------------------

class FixedClock:
    """Backend proxy whose steps and rebinds report a fixed duration, so
    two runs see the same scheduler clock."""

    def __init__(self, eng):
        self.eng = eng

    def __getattr__(self, k):
        return getattr(self.eng, k)

    def prefill(self, *a):
        self.eng.prefill(*a)
        return 0.01

    def decode(self, *a):
        self.eng.decode(*a)
        return 0.01

    def mixed(self, *a):
        self.eng.mixed(*a)
        return 0.01

    def rebind(self, layout):
        self.eng.rebind(layout)
        return 0.01


def reference_check(torch):
    from repro_torch.configs import get_config
    from repro_torch.core.engine import FlyingEngine
    from repro_torch.core.kv_adaptor import PoolGeometry
    from repro_torch.core.modes import ParallelPlan
    from repro_torch.core.scheduler import DynamicScheduler, SchedulerConfig
    from repro_torch.core.task_pool import Request
    from repro_torch.models.model import build_model

    cfg = get_config("llama3-8b").reduced()
    plan = ParallelPlan(engine_rows=1, tp_base=1, data_rows=1)
    params = build_model(cfg, torch.float32, "cpu").init(
        torch.Generator().manual_seed(0))

    def serve(device, num_blocks, reqs):
        geom = PoolGeometry(cfg, plan, num_blocks=num_blocks, block_base=4)
        eng = FlyingEngine(build_model(cfg, torch.float32, device), plan,
                           geom, params, batch_per_engine=2,
                           max_blocks_per_req=16, device=device)
        sched = DynamicScheduler(plan, geom, FixedClock(eng), SchedulerConfig(
            strategy="hard", max_batch_per_group=2, prefill_chunk=8))
        for r in reqs:
            sched.submit(Request(**r))
        sched.run(max_steps=400)
        return ({r["req_id"]: eng.generated_tokens(r["req_id"])
                 for r in reqs}, [l.phase for l in sched.log],
                sched.preempt_stats["recovered"])

    two = [dict(req_id="a", arrival=0.0, prompt_len=24, output_len=6),
           dict(req_id="b", arrival=0.001, prompt_len=8, output_len=8)]
    toks_gpu, ph_gpu, _ = serve("cuda", 64, two)
    toks_cpu, ph_cpu, _ = serve("cpu", 64, two)
    print(f"reduced llama3-8b fp32, card vs CPU: tokens {toks_gpu} "
          f"phases {ph_gpu}")
    check(toks_gpu == toks_cpu, f"card tokens {toks_gpu} != CPU {toks_cpu}")
    check(ph_gpu == ph_cpu and "mixed" in ph_gpu,
          f"phase logs differ: {ph_gpu} vs {ph_cpu}")
    # a 12-block pool: decode growth finds it full, and the scheduler
    # evicts a resident and recovers it (its tokens pinned into its prompt)
    four = [dict(req_id=f"r{i}", arrival=0.001 * i, prompt_len=12 + 4 * i,
                 output_len=10) for i in range(4)]
    toks_gpu, ph_gpu, rec_gpu = serve("cuda", 12, four)
    toks_cpu, ph_cpu, rec_cpu = serve("cpu", 12, four)
    print(f"reduced llama3-8b fp32, 12-block pool, card vs CPU: recovered "
          f"{rec_gpu} and {rec_cpu}, tokens {toks_gpu}")
    check(rec_gpu == rec_cpu > 0, f"recovered {rec_gpu} on the card, "
                                  f"{rec_cpu} on the CPU")
    check(toks_gpu == toks_cpu and ph_gpu == ph_cpu,
          f"small-pool run: card tokens {toks_gpu} != CPU {toks_cpu} or "
          f"phases differ")
    check(all(len(v) == 10 for v in toks_gpu.values()),
          f"small-pool run left a request short: {toks_gpu}")


# ---------------------------------------------------------------------------
# phase 5: full-width serving
# ---------------------------------------------------------------------------

def serve_config(**kw):
    from repro_torch.launch.serve import ServeConfig
    return ServeConfig(**{**dict(
        arch="llama3-8b", real=True, requests=8, seed=0, num_blocks=4096,
        block_base=16, batch_per_engine=8, max_blocks_per_req=256,
        prefill_chunk=512, prompt_range=(256, 2048), output_range=(32, 64),
        arrival="poisson", rate=20.0), **kw})


class StepClock:
    """Backend proxy that logs each step (kind, request ids, the
    duration the engine measured) and returns that duration: the
    scheduler, and so its batching, runs as it would without it."""

    def __init__(self, eng):
        self.eng = eng
        self.log = []

    def __getattr__(self, k):
        return getattr(self.eng, k)

    def _step(self, kind, reqs, *a):
        dt = getattr(self.eng, kind)(*a)
        self.log.append((kind, reqs, dt))
        return dt

    def prefill(self, reqs, *a):
        return self._step("prefill", [r.req_id for r in reqs], reqs, *a)

    def decode(self, reqs, *a):
        return self._step("decode", [r.req_id for r in reqs], reqs, *a)

    def mixed(self, pre, dec, *a):
        return self._step("mixed", [[r.req_id for r in pre],
                                    [r.req_id for r in dec]], pre, dec, *a)


class ReplayClock(StepClock):
    """Backend proxy that reports a logged run's step durations in
    order, so that a second run over the same trace (the async loop in
    virtual pace) schedules exactly as the logged one; it fails the
    phase as soon as a step differs from the log's."""

    def __init__(self, eng, log):
        super().__init__(eng)
        self.want = list(log)

    def _step(self, kind, reqs, *a):
        i = len(self.log)
        super()._step(kind, reqs, *a)
        check(i < len(self.want) and self.want[i][:2] == (kind, reqs),
              f"replayed step {i} is {kind} {reqs}, the log has "
              f"{self.want[i][:2] if i < len(self.want) else 'no step'}")
        return self.want[i][2]


def serve_full_width(torch):
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import build_stack, replay

    cfg = serve_config()
    t0 = time.perf_counter()
    stack = build_stack(cfg)
    torch.cuda.synchronize()
    print(f"serve: built llama3-8b (bf16, 32 layers) and a "
          f"{cfg.num_blocks}x{cfg.block_base}-token pool in "
          f"{time.perf_counter() - t0:.1f} s")
    engine = stack[0].backend
    clock = StepClock(engine)
    stack[0].backend = clock
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    sched, wall = replay(cfg, stack)
    launches = dict(_lib.LAUNCHES)
    reqs = list(sched.pool.all.values())
    vocab = engine.cfg.vocab_size
    n_tok = 0
    for r in reqs:
        toks = engine.generated_tokens(r.req_id)
        check(r.state == "done" and len(toks) == r.output_len,
              f"{r.req_id}: state {r.state}, {len(toks)}/{r.output_len} "
              f"tokens")
        check(all(0 <= x < vocab for x in toks),
              f"{r.req_id}: token outside the vocab")
        n_tok += len(toks)
    phases = [l.phase for l in sched.log]
    stats = engine.sync_stats
    print(f"serve: {len(reqs)} requests, prompts "
          f"{sorted(r.prompt_len for r in reqs)}, outputs "
          f"{sorted(r.output_len for r in reqs)}")
    print(f"serve: {stats.steps} steps ({phases.count('mixed')} mixed, "
          f"{phases.count('prefill')} prefill, {phases.count('decode')} "
          f"decode), {n_tok} tokens in {wall:.3f} s = "
          f"{n_tok / wall:.1f} tok/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"serve: sync stats {stats}")
    print(f"serve: kernel launches {launches}")
    check(stats.host_argmax == 0, "tokens were read back one at a time")
    check(phases.count("mixed") > 0, "no mixed step occurred")
    for k in SERVE_KERNELS:
        check(launches[k] > 0, f"kernel {k} never launched on the serving "
                               f"path")
    offline = dict(tokens={r.req_id: engine.generated_tokens(r.req_id)
                           for r in reqs}, log=clock.log)
    dryrun_against_the_card(torch, engine, clock.log)
    return {k: launches[k] for k in SERVE_KERNELS}, offline


def _median_ms(log, kind: str) -> float:
    ts = sorted(dt for k, _, dt in log if k == kind)
    return ts[len(ts) // 2] * 1e3 if ts else float("nan")


def dryrun_against_the_card(torch, engine, log) -> None:
    """Phase 5's dry run, on phase 5's stack after its replay: the
    llama3-8b decode step at 8 rows over 256-block tables and its prefill
    step of 8 rows of a 512-token chunk, counted on the meta device
    (``launch/dryrun.py::count_serve_step``, the plan of one card) and
    run once on the card through the same step program over the engine's
    parameters and pools (every write parked on the scratch row, so the
    pools keep their contents). Gates: (a) the dry run's argument bytes
    equal the bytes of the engine's parameters and pools and the step's
    batch, to the byte; (b) ``FlopCounterMode`` around the real step
    counts exactly the dry run's GEMM FLOPs (the kernels are ctypes
    calls: neither side counts them as GEMMs). Printed: (c) the
    roofline's ms (H100 data sheet) beside phase 5's median step of that
    phase (``StepClock``), as a multiple; (d) the predicted peak
    (arguments plus the dry run's temporaries) beside
    ``torch.cuda.max_memory_allocated()`` over the step."""
    import numpy as np
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis import roofline as rl
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core.modes import FlyingMode
    from repro_torch.core.steps import build_serve_step
    from repro_torch.launch import dryrun as D

    t0 = time.perf_counter()
    cfg, plan, geom = engine.cfg, engine.plan, engine.geom
    check(plan.pods * plan.devices_per_pod == 1,
          f"phase 5's plan {plan} is not one card")
    dev = torch.device("cuda")
    B, MB, T, page = 8, 256, 512, geom.block_base
    rng = np.random.default_rng(5)
    mode = FlyingMode(plan, 1)
    for phase in ("decode", "prefill"):
        ctx_tokens = MB * page if phase == "decode" else T
        meta_batch, _ = D.abstract_batch(
            cfg, InputShape(f"phase5_{phase}", ctx_tokens, B, phase), plan,
            1, B, ctx_tokens, MB)
        res = D.count_serve_step(cfg, plan, 1, geom, phase, meta_batch,
                                 bpg=B, dtype=engine.model.dtype)
        c, mem = res["counts"], res["memory"]
        # the real batch: live keys 1-4096 (decode) or priors 0-3584
        # (prefill) over distinct blocks, every write parked
        table = rng.permutation(geom.num_blocks - 1)[:B * MB].reshape(B, MB)
        batch = {"block_table": table}
        if phase == "decode":
            lens = rng.integers(1, MB * page + 1, size=B)
            batch.update(tokens=rng.integers(0, cfg.vocab_size, (B, 1)),
                         positions=(lens - 1)[:, None], slots=np.full(B, -1),
                         context_len=lens)
        else:
            prior = rng.integers(0, MB * page - T + 1, size=B) // page * page
            batch.update(tokens=rng.integers(0, cfg.vocab_size, (B, T)),
                         positions=prior[:, None] + np.arange(T)[None],
                         slots=np.full((B, T), -1), prior_len=prior)
        batch = {k: torch.from_numpy(np.asarray(v, np.int32)).to(dev)
                 for k, v in batch.items()}
        check(sorted(batch) == sorted(meta_batch) and all(
            batch[k].shape == meta_batch[k].shape for k in batch),
              f"{phase}: the card's batch is not the dry run's")
        args = rl.tree_bytes(engine.params) + rl.tree_bytes(engine._pools) \
            + rl.tree_bytes(batch)
        print(f"dryrun: {phase} argument bytes, dry run "
              f"{mem['argument_bytes']}, card {args}")
        check(mem["argument_bytes"] == args,
              f"{phase}: the dry run's argument bytes "
              f"{mem['argument_bytes']} are not the card's {args}")
        run, _ = build_serve_step(engine.model, mode, geom, phase=phase)
        torch.cuda.synchronize()
        with FlopCounterMode(display=False) as fc:
            run(engine.params, engine._pools, batch)
        torch.cuda.synchronize()
        gemm = fc.get_total_flops()
        print(f"dryrun: {phase} GEMM FLOPs, dry run {c.gemm_flops:.0f}, "
              f"card {gemm}; kernel calls {c.kernels.calls}")
        check(c.gemm_flops == gemm,
              f"{phase}: the dry run's GEMM FLOPs {c.gemm_flops:.0f} are "
              f"not the card's {gemm}")
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run(engine.params, engine._pools, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        row = rl.RooflineTerms(flops=c.flops, hbm_bytes=c.hbm_bytes,
                               coll_bytes=0.0, chips=1).row()
        t_ms = max(row["t_compute_s"], row["t_memory_s"]) * 1e3
        med = _median_ms(log, phase)
        print(f"dryrun: {phase} roofline {t_ms:.3f} ms ({row['dominant']}: "
              f"{c.flops / 1e9:.2f} GFLOP, {c.hbm_bytes / 1e9:.3f} GB; H100 "
              f"data sheet) against phase 5's median {phase} step "
              f"{med:.3f} ms: {med / t_ms:.2f}x")
        print(f"dryrun: {phase} peak, predicted "
              f"{(mem['argument_bytes'] + mem['temp_bytes']) / 2**30:.3f} "
              f"GiB (temporaries {mem['temp_bytes'] / 2**20:.1f} MiB), card "
              f"{peak / 2**30:.3f} GiB (above the step's start "
              f"{(peak - base) / 2**20:.1f} MiB)")
    print(f"dryrun: phase 5's dry run took {time.perf_counter() - t0:.1f} s")


def serve_breakdown(torch):
    """Device time by kernel class over a second, profiled run of the
    same trace (the first run's wall time stays unprofiled)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import build_stack, replay

    cfg = serve_config()
    stack = build_stack(cfg)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = replay(cfg, stack)
    print_breakdown("breakdown", prof, wall, (
        ("paged_flash_prefill", "prefill_tc"),
        ("paged_flash_prefill fp32", "prefill_kernel"),
        ("paged_attention", "decode_kernel"),
        ("paged_append", "append_rows")))


# ---------------------------------------------------------------------------
# phase 13: the HTTP server at full width
# ---------------------------------------------------------------------------

def http_wall_run(torch, smi: str, base, weights=None):
    """The trace of config ``base`` (phase 5's, here) over HTTP at wall
    pace: the engine behind FrontDoor -> AsyncServeLoop -> ServeHTTP on
    127.0.0.1, as ``--serve`` builds them, the requests sent by
    ``loadgen.drive_http`` from a process of their own. Every stream
    must end done with exactly its output length in the vocab, K1-K4
    must launch, ``/metrics`` must serve the rolling tier report; prints
    client TTFT, TPOT and tok/s. Builds the weights from ``base.seed``
    unless ``weights`` gives them. Returns the weights and the run's
    readings (client TTFTs, the front door's requests, wall seconds,
    tokens, steps)."""
    import asyncio
    import copy
    import dataclasses
    import multiprocessing

    import numpy as np

    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import build_door, build_loop, build_stack
    from repro_torch.serving.metrics import summarize
    from repro_torch.serving.server import ServeHTTP
    from repro_torch.serving.workload import generate

    wall = dataclasses.replace(base, pace="wall", serve=True)
    t0 = time.perf_counter()
    sched, spec, _ = build_stack(wall, weights)
    eng = sched.backend
    vocab = eng.cfg.vocab_size
    torch.cuda.synchronize()
    print(f"http: built {base.arch} ({base.dtype}) and a "
          f"{base.num_blocks}x{base.block_base}-token pool in "
          f"{time.perf_counter() - t0:.1f} s")
    door = build_door(wall, sched)
    loop = build_loop(wall, door)
    reqs = [copy.deepcopy(r) for r in generate(spec)]

    async def over_http():
        srv = await ServeHTTP(loop).start("127.0.0.1", 0)   # starts loop
        _lib.reset_launches()
        # the client runs in a process of its own, as a remote client
        # would: on the server's loop (or a thread sharing its
        # interpreter lock) each engine step would hold its clock too
        ctx = multiprocessing.get_context("spawn")
        recv, send = ctx.Pipe(duplex=False)
        client = ctx.Process(target=http_client, args=(srv.port, reqs, send))
        client.start()
        send.close()
        try:
            while client.is_alive() and not recv.poll():
                await asyncio.sleep(0.005)
            check(recv.poll(), "http: the client process failed")
            box = {"out": recv.recv()}
        finally:
            client.join(timeout=60)
            if client.is_alive():
                client.terminate()
                client.join()
        torch.cuda.synchronize()
        launches = dict(_lib.LAUNCHES)
        r, w = await asyncio.open_connection("127.0.0.1", srv.port)
        w.write(b"GET /metrics HTTP/1.1\r\nHost: smoke\r\n\r\n")
        await w.drain()
        raw = await r.read()
        w.close()
        await srv.stop()
        return box["out"], launches, raw

    out, launches, raw = asyncio.run(over_http())
    recs = {rec["req_id"]: rec for rec in out["records"]}
    for q in reqs:
        rec = recs[q.req_id]
        check(rec["state"] == "done" and rec["n_tokens"] == q.output_len,
              f"http {q.req_id}: state {rec['state']}, {rec['n_tokens']}"
              f"/{q.output_len} tokens")
        check(all(0 <= t < vocab for t in rec["tokens"]),
              f"http {q.req_id}: token outside the vocab")
    for k in SERVE_KERNELS:
        check(launches.get(k, 0) > 0, f"http: kernel {k} never launched")
    check(eng.sync_stats.host_argmax == 0,
          "http: tokens were read back one at a time")
    metrics = json.loads(raw.split(b"\r\n\r\n", 1)[1])
    row = metrics.get("tiers", {}).get("standard", {})
    check(row.get("done") == len(reqs) and "p99_ttft_s" in row,
          f"http: /metrics tier report {metrics.get('tiers')}")
    ttft = np.array([recs[q.req_id]["ttft_wall_s"] for q in reqs])
    n_tok = sum(rec["n_tokens"] for rec in recs.values())
    m = summarize(list(door.requests.values()))
    print(f"http: {len(reqs)} streams over 127.0.0.1 at wall pace "
          f"(Poisson {base.rate}/s), harvests every {eng.harvest_limit} "
          f"steps, {n_tok} tokens in {eng.sync_stats.steps} steps, "
          f"launches { {k: launches[k] for k in SERVE_KERNELS} }")
    print(f"http: client TTFT p50 {np.percentile(ttft, 50) * 1e3:.1f} ms, "
          f"p99 {np.percentile(ttft, 99) * 1e3:.1f} ms over {len(ttft)} "
          f"requests (server clock: mean {m.mean_ttft * 1e3:.1f} ms); "
          f"TPOT median {m.median_tpot * 1e3:.2f} ms (server clock at "
          f"wall pace); {n_tok / out['wall_s']:.1f} tok/s over "
          f"{out['wall_s']:.3f} s wall, {loop.ticks} loop ticks; {smi}")
    print(f"http: /metrics standard tier {json.dumps(row, sort_keys=True)}")
    return (eng.model, eng.params), dict(
        ttft=ttft, requests=list(door.requests.values()),
        wall_s=out["wall_s"], tokens=n_tok, steps=eng.sync_stats.steps)


def http_client(port: int, reqs, conn) -> None:
    """``loadgen.drive_http`` of ``reqs`` against 127.0.0.1:``port``,
    its result sent over ``conn`` (run in a process of its own)."""
    import asyncio

    from repro_torch.serving.loadgen import drive_http
    conn.send(asyncio.run(drive_http("127.0.0.1", port, reqs,
                                     collect_tokens=True)))
    conn.close()


def serve_http_full_width(torch, smi: str, offline):
    """llama3-8b at full width in bf16 (seed 0, phase 5's geometry): phase
    5's trace over HTTP at wall pace (``http_wall_run``), then streamed
    in process at virtual pace with phase 5's step durations replayed
    (the offline schedule): greedy tokens equal to phase 5's, and at
    temperature 0.8, top-k 50, per-request seeds equal to an offline
    run's. ``offline`` is phase 5's tokens and step log."""
    import asyncio
    import copy
    import dataclasses

    from repro_torch.launch.serve import (build_door, build_loop,
                                          build_stack, replay)
    from repro_torch.serving.loadgen import drive_inprocess
    from repro_torch.serving.workload import generate

    base = serve_config()
    hot = dict(temperature=0.8, top_k=50, seed_mode="request")
    t_phase = time.perf_counter()
    gc_collect(torch)
    weights, _ = http_wall_run(torch, smi, base)
    print("http: the readings above are smoke readings of 8 requests "
          "(their p99 is in effect their maximum); tools/http_bench.py "
          "serves a few hundred for a tail")
    vocab = weights[0].cfg.vocab_size
    gc_collect(torch)

    def stream_virtual(c, log, **engine):
        """``c``'s trace through the async loop at virtual pace, with
        ``log``'s step durations replayed, the engine built with the
        ``engine`` keywords; the streamed tokens."""
        st, sp, _ = build_stack(c, weights, **engine)
        e = st.backend
        st.backend = ReplayClock(e, log)
        lp = build_loop(dataclasses.replace(c, pace="virtual"),
                        build_door(c, st))
        res = asyncio.run(drive_inprocess(
            lp, [copy.deepcopy(r) for r in generate(sp)],
            collect_tokens=True))
        check(len(st.backend.log) == len(log),
              f"virtual pace ran {len(st.backend.log)} steps, the log "
              f"{len(log)}")
        check(e.sync_stats.host_argmax == 0,
              "virtual pace: tokens were read back one at a time")
        return {rec["req_id"]: rec["tokens"] for rec in res["records"]}

    # virtual pace, greedy: phase 5's schedule, phase 5's tokens
    got = stream_virtual(base, offline["log"])
    check(got == offline["tokens"],
          f"virtual-pace greedy streams differ from phase 5's offline "
          f"tokens: {got} vs {offline['tokens']}")
    print(f"http: virtual-pace greedy streams equal phase 5's offline "
          f"tokens ({sum(map(len, got.values()))} tokens, "
          f"{len(offline['log'])} steps replayed)")
    gc_collect(torch)

    # temperature 0.8, top-k 50, per-request seeds: offline vs streamed
    stack = build_stack(base, weights, **hot)
    clock = StepClock(stack[0].backend)
    stack[0].backend = clock
    sched, _ = replay(base, stack)
    check(all(r.state == "done" for r in sched.pool.all.values()),
          "temperature run: a request did not finish")
    want = {r.req_id: clock.eng.generated_tokens(r.req_id)
            for r in sched.pool.all.values()}
    del sched, stack
    gc_collect(torch)
    got = stream_virtual(base, clock.log, **hot)
    check(got == want, f"temperature 0.8 streams differ from the offline "
                       f"run: {got} vs {want}")
    check(all(0 <= t < vocab for v in got.values() for t in v),
          "temperature run: token outside the vocab")
    check(got != offline["tokens"],
          "temperature 0.8 drew the greedy tokens")
    print(f"http: temperature 0.8, top-k 50, request seeds: virtual-pace "
          f"streams equal the offline run ({sum(map(len, got.values()))} "
          f"tokens, {len(clock.log)} steps replayed)")
    del weights, clock
    gc_collect(torch)
    print(f"http: phase 13 took {time.perf_counter() - t_phase:.1f} s")


def print_breakdown(tag: str, prof, wall: float, classes) -> None:
    """Device time by kernel class (``classes``: (class, name pattern)
    pairs, GEMM patterns added), the device's busy share of ``wall``
    seconds, and each of ``classes``' launches and mean time a launch."""
    named = list(dict.fromkeys(c for c, _ in classes))
    classes = tuple(classes) + (("gemm", "gemm"), ("gemm", "nvjet"),
                                ("gemm", "cutlass"), ("gemm", "xmma"))
    by: dict = {}
    calls: dict = {}
    other: dict = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) \
            or getattr(e, "self_cuda_time_total", 0)
        if us:
            name = next((c for c, pat in classes if pat in e.key.lower()),
                        "other")
            by[name] = by.get(name, 0.0) + us / 1e3
            calls[name] = calls.get(name, 0) + e.count
            if name == "other":
                k = e.key[:60]
                other[k] = other.get(k, 0.0) + us / 1e3
    busy = sum(by.values())
    if not busy:
        print(f"{tag}: not measured (the profiler saw no device time)")
        return
    parts = ", ".join(f"{k} {v:.1f} ms ({v / busy:.1%})"
                      for k, v in sorted(by.items(), key=lambda kv: -kv[1]))
    top = sorted(other.items(), key=lambda kv: -kv[1])[:6]
    print(f"{tag} (profiled rerun, {wall * 1e3:.1f} ms wall): device "
          f"busy {busy:.1f} ms = {busy / (wall * 1e3):.1%} of wall; {parts}")
    print(f"{tag}: largest 'other' kernels: " + "; ".join(
        f"{k} {v:.1f} ms" for k, v in top))
    print(f"{tag}: per kernel class: " + "; ".join(
        f"{k} {by[k]:.2f} ms over {calls[k]} launches, "
        f"{by[k] / calls[k]:.4f} ms a launch"
        for k in named if calls.get(k)))


# ---------------------------------------------------------------------------
# phases 7 and 8: training
# ---------------------------------------------------------------------------

def train_reference_check(torch, np, arch: str, layers: int = 0,
                          bf16: bool = False):
    """The reduced config (with ``layers`` layers, if given) trained in
    fp32 on the card and on the CPU from the same weights and batches;
    with ``bf16``, then in bf16 from the same bf16 weights, the card's
    losses within twice the CPU's own largest relative bf16-vs-fp32
    drift over the same steps (the card and the CPU round at different
    places, each by about as much as bf16 moves a run from fp32)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models.model import build_model
    from repro_torch.training.checkpoint import tree_map

    cfg = get_config(arch).reduced()
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    params = build_model(cfg, torch.float32, "cpu").init(
        torch.Generator().manual_seed(0))
    kw = dict(steps=3, batch=4, seq=128, dtype=torch.float32,
              log=lambda s: None)
    card = train(cfg, device="cuda",
                 params=tree_map(lambda t: t.to("cuda"), params), **kw)
    cpu = train(cfg, device="cpu", params=params, **kw)
    print(f"train reduced {arch} ({cfg.num_layers} layers) fp32: card "
          f"losses {card.losses}, CPU losses {cpu.losses}")
    check(np.allclose(card.losses, cpu.losses, rtol=1e-4, atol=0.0),
          "card and CPU training losses differ")
    if not bf16:
        return
    pb = build_model(cfg, torch.bfloat16, "cpu").init(
        torch.Generator().manual_seed(0))
    kw = dict(steps=3, batch=4, seq=128, log=lambda s: None)
    card = train(cfg, device="cuda", dtype=torch.bfloat16,
                 params=tree_map(lambda t: t.to("cuda"), pb), **kw)
    cpu = train(cfg, device="cpu", dtype=torch.bfloat16,
                params=tree_map(lambda t: t.clone(), pb), **kw)
    f32 = train(cfg, device="cpu", dtype=torch.float32,
                params=tree_map(lambda t: t.float(), pb), **kw)
    drift = max(abs(b - f) / abs(f) for b, f in zip(cpu.losses, f32.losses))
    diff = max(abs(c - b) / abs(b) for c, b in zip(card.losses, cpu.losses))
    print(f"train reduced {arch} bf16: card losses {card.losses}, CPU "
          f"{cpu.losses} (fp32 {f32.losses}); largest relative difference "
          f"{diff:.3e}, limit 2 x the CPU's bf16 drift {drift:.3e}")
    check(diff <= 2 * drift, "card and CPU bf16 training losses differ by "
                             "more than twice the CPU's bf16 drift")


def train_full_width(torch):
    import dataclasses
    import math

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.launch.train import train
    from repro_torch.training.checkpoint import tree_leaves

    # full width, depth cut to 4 of 32 layers: bf16 params and grads plus
    # fp32 moments take 12 bytes a parameter, 96 GB at full depth
    cfg = dataclasses.replace(get_config("llama3-8b"), num_layers=4)
    steps, batch, seq = 20, 4, 2048
    kw = dict(batch=batch, seq=seq, device="cuda", dtype=torch.bfloat16)
    gc_collect(torch)
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    res = train(cfg, steps=steps, log_every=5,
                log=lambda s: print(f"train: {s}"), **kw)
    launches = dict(_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in tree_leaves(res.params))
    del res.params
    steady = sorted(res.step_s[1:])
    med = steady[len(steady) // 2]
    print(f"train: llama3-8b at full width, {cfg.num_layers} of 32 layers "
          f"({n_params / 1e9:.3f} B parameters), bf16 parameters, fp32 "
          f"AdamW moments, batch {batch} x {seq} tokens, {steps} steps")
    print("train: losses " + " ".join(f"{x:.4f}" for x in res.losses))
    print(f"train: step time median {med * 1e3:.1f} ms over steps 2-{steps} "
          f"(min {steady[0] * 1e3:.1f}, max {steady[-1] * 1e3:.1f}; first "
          f"{res.step_s[0] * 1e3:.1f} ms) = "
          f"{res.tokens_per_step / med:.1f} tok/s; peak memory "
          f"{peak / 2**30:.2f} GiB")
    print(f"train: kernel launches {launches}")
    check(all(math.isfinite(x) for x in res.losses), "a loss is not finite")
    check(res.losses[-1] < res.losses[0],
          f"loss did not decrease: {res.losses[0]} -> {res.losses[-1]}")
    want = {"flash_prefill": 2 * cfg.num_layers * steps,
            "flash_prefill_bwd": cfg.num_layers * steps}
    for k, n in want.items():
        check(launches[k] == n, f"{k} launched {launches[k]} times on the "
                                f"training path, not {n}")
    gc_collect(torch)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train(cfg, steps=2, log=lambda s: None, **kw)
        wall = time.perf_counter() - t0
    print_breakdown("train breakdown", prof, wall, FLASH_CLASSES + (
        ("elementwise", "elementwise"), ("reduction", "reduce_kernel")))
    gc_collect(torch)
    return {k: launches[k] for k in TRAIN_KERNELS}


def train_mamba2(torch):
    """mamba2-2.7b at full width and all 64 layers, bf16 parameters, fp32
    AdamW moments, batch 4 x 2048 tokens, through
    ``repro_torch.launch.train.train``."""
    import math

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.launch.train import train
    from repro_torch.training.checkpoint import tree_leaves

    cfg = get_config("mamba2-2.7b")
    steps, batch, seq = MAMBA_STEPS, 4, 2048
    kw = dict(batch=batch, seq=seq, device="cuda", dtype=torch.bfloat16)
    gc_collect(torch)
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    res = train(cfg, steps=steps, log_every=5,
                log=lambda s: print(f"mamba2: {s}"), **kw)
    launches = dict(_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in tree_leaves(res.params))
    del res.params
    steady = sorted(res.step_s[1:])
    med = steady[len(steady) // 2]
    print(f"mamba2: mamba2-2.7b at full width and depth, {cfg.num_layers} "
          f"layers ({n_params / 1e9:.3f} B parameters), bf16 parameters, "
          f"fp32 AdamW moments, batch {batch} x {seq} tokens, {steps} steps")
    print("mamba2: losses " + " ".join(f"{x:.4f}" for x in res.losses))
    print(f"mamba2: step time median {med * 1e3:.1f} ms over steps "
          f"2-{steps} (min {steady[0] * 1e3:.1f}, max "
          f"{steady[-1] * 1e3:.1f}; first {res.step_s[0] * 1e3:.1f} ms) = "
          f"{res.tokens_per_step / med:.1f} tok/s; peak memory "
          f"{peak / 2**30:.2f} GiB")
    print(f"mamba2: kernel launches {launches}")
    check(all(math.isfinite(x) for x in res.losses), "a loss is not finite")
    check(res.losses[-1] < res.losses[0],
          f"loss did not decrease: {res.losses[0]} -> {res.losses[-1]}")
    # per step: the forward pass and its recomputation under remat, then
    # one backward, in each of the 64 layers
    want = {"ssd_scan": 2 * cfg.num_layers * steps,
            "ssd_scan_bwd": cfg.num_layers * steps}
    for k, n in want.items():
        check(launches[k] == n, f"{k} launched {launches[k]} times on the "
                                f"training path, not {n}")
    gc_collect(torch)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train(cfg, steps=2, log=lambda s: None, **kw)
        wall = time.perf_counter() - t0
    print_breakdown("mamba2 breakdown", prof, wall, (
        ("ssd_scan states (bf16)", "chunk_state_tc"),
        ("ssd_scan pass (bf16)", "state_pass"),
        ("ssd_scan y (bf16)", "chunk_scan_tc"),
        ("ssd_scan (fp32)", "fwd_kernel"),
        ("ssd_scan_bwd dC (bf16)", "dc_tc"),
        ("ssd_scan_bwd carry (bf16)", "carry_kernel"),
        ("ssd_scan_bwd dx dB (bf16)", "dxb_tc"),
        ("ssd_scan_bwd group sums (bf16)", "sum_groups"),
        ("ssd_scan_bwd dC (fp32)", "dc_kernel"),
        ("ssd_scan_bwd scan (fp32)", "bwd_scan_kernel"),
        ("elementwise", "elementwise"),
        ("reduction", "reduce_kernel")))
    gc_collect(torch)
    return {k: launches[k] for k in MAMBA_KERNELS}


def train_recurrentgemma(torch):
    """recurrentgemma-9b at full width, 6 of its 38 layers (two whole
    super-layers: four RG-LRU layers, two local-attention layers), bf16
    parameters (the RG-LRU's decay and gate leaves fp32), fp32 AdamW
    moments, batch 4 x 2048 tokens, through
    ``repro_torch.launch.train.train``."""
    import dataclasses
    import math

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.launch.train import train
    from repro_torch.models.transformer import stack_plan
    from repro_torch.training.checkpoint import tree_leaves

    # at 12 bytes a parameter the full 7.66 B need 92 GB; two super-layers
    # (2.97 B) leave room for the fp32 logits over the 256000-word vocab
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), num_layers=6)
    steps, batch, seq = 20, 4, 2048
    kw = dict(batch=batch, seq=seq, device="cuda", dtype=torch.bfloat16)
    kinds = [k[0] for seq_, n in stack_plan(cfg) for _ in range(n)
             for k in seq_]
    n_rec, n_attn = kinds.count("rglru"), kinds.count("gqa_win")
    gc_collect(torch)
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    res = train(cfg, steps=steps, log_every=5,
                log=lambda s: print(f"hybrid: {s}"), **kw)
    launches = dict(_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    leaves = tree_leaves(res.params)
    n_params = sum(t.numel() for t in leaves)
    n_f32 = sum(t.numel() for t in leaves if t.dtype == torch.float32)
    del res.params, leaves
    steady = sorted(res.step_s[1:])
    med = steady[len(steady) // 2]
    print(f"hybrid: recurrentgemma-9b at full width, {cfg.num_layers} of 38 "
          f"layers ({n_rec} RG-LRU, {n_attn} local attention; "
          f"{n_params / 1e9:.3f} B parameters, {n_f32} of them fp32), bf16 "
          f"parameters, fp32 AdamW moments, batch {batch} x {seq} tokens, "
          f"{steps} steps")
    print("hybrid: losses " + " ".join(f"{x:.4f}" for x in res.losses))
    print(f"hybrid: step time median {med * 1e3:.1f} ms over steps "
          f"2-{steps} (min {steady[0] * 1e3:.1f}, max "
          f"{steady[-1] * 1e3:.1f}; first {res.step_s[0] * 1e3:.1f} ms) = "
          f"{res.tokens_per_step / med:.1f} tok/s; peak memory "
          f"{peak / 2**30:.2f} GiB")
    print(f"hybrid: kernel launches {launches}")
    check(all(math.isfinite(x) for x in res.losses), "a loss is not finite")
    check(res.losses[-1] < res.losses[0],
          f"loss did not decrease: {res.losses[0]} -> {res.losses[-1]}")
    # per step: each layer's kernel forward, its recomputation under remat
    # and one backward
    want = {"rglru_scan": 2 * n_rec * steps, "rglru_scan_bwd": n_rec * steps,
            "flash_prefill": 2 * n_attn * steps,
            "flash_prefill_bwd": n_attn * steps}
    for k, n in want.items():
        check(launches[k] == n, f"{k} launched {launches[k]} times on the "
                                f"training path, not {n}")
    gc_collect(torch)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train(cfg, steps=2, log=lambda s: None, **kw)
        wall = time.perf_counter() - t0
    print_breakdown("hybrid breakdown", prof, wall, (
        ("rglru_scan", "rglru_fwd_kernel"),
        ("rglru_scan_bwd", "rglru_bwd_kernel"),
        *FLASH_CLASSES,
        ("elementwise", "elementwise"),
        ("reduction", "reduce_kernel")))
    gc_collect(torch)
    return {row: launches[k] for row, k in HYBRID_ROWS.items()}


# ---------------------------------------------------------------------------
# phase 14: two ranks on the one card over gloo
# ---------------------------------------------------------------------------

def holds_kv(sched) -> bool:
    """Whether any request of ``sched`` holds KV: running, paused, or
    part-way through its chunked prefill."""
    return bool(sched.running or sched.paused
                or any(r.prefilled > 0 for r in sched.waiting))


class ScriptedMerge:
    """Layout policy that binds both engines into one TP2 island once, at
    the first tick from ``bind`` on, and dissolves any TP island once,
    at the first tick from ``release`` on; on every other tick it keeps
    the layout the scheduler holds (the scheduler itself restores the
    DP groups of the requests a HARD bind paused once their engines are
    idle). With ``idle`` the release waits for a tick where no request
    holds KV (``holds_kv``), so that a LIVE merge-down carries nothing
    (a tag-2 request cannot ride down to merge 1: it would pause)."""

    def __init__(self, bind: int, release: int, idle: bool = False):
        self.bind, self.release, self.idle = bind, release, idle
        self.bound = self.released = False

    def decide(self, sched):
        tick = len(sched.log)
        if not self.bound and tick >= self.bind:
            self.bound = True
            return 2
        if not self.released and tick >= self.release and not (
                self.idle and holds_kv(sched)):
            self.released = True
            return 1
        return sched.layout


def islands_trace(torch, device) -> dict:
    """Phase 14 (a): the reduced llama3-8b in fp32 (weights seeded on the
    CPU) at ``ParallelPlan(1, 1, 2)`` on ``device``, 8 staggered
    requests under HARD with the merge scripted 1 -> 2 -> 1 and a fixed
    clock; every rebind zero-copy checked. Returns the streams and the
    schedule."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import FlyingEngine
    from repro_torch.core.kv_adaptor import PoolGeometry
    from repro_torch.core.modes import ParallelPlan
    from repro_torch.core.scheduler import DynamicScheduler, SchedulerConfig
    from repro_torch.core.task_pool import Request
    from repro_torch.models.model import build_model

    cfg = get_config("llama3-8b").reduced()
    plan = ParallelPlan(engine_rows=1, tp_base=1, data_rows=2)
    params = build_model(cfg, torch.float32, "cpu").init(
        torch.Generator().manual_seed(0))
    geom = PoolGeometry(cfg, plan, num_blocks=64, block_base=4)
    eng = FlyingEngine(build_model(cfg, torch.float32, device), plan, geom,
                       params, batch_per_engine=2, max_blocks_per_req=16,
                       device=device, check_zero_copy=True)
    sched = DynamicScheduler(plan, geom, FixedClock(eng), SchedulerConfig(
        strategy="hard", max_batch_per_group=2, prefill_chunk=8),
        policy=ScriptedMerge(4, 24))
    for i in range(8):
        sched.submit(Request(req_id=f"r{i}", arrival=0.004 * i,
                             prompt_len=8 + 4 * (i % 4), output_len=6))
    sched.run(max_steps=400)
    reqs = sorted(sched.pool.all.values(), key=lambda r: r.req_id)
    return {"toks": {r.req_id: list(map(int, eng.generated_tokens(
                r.req_id))) for r in reqs},
            "done": sum(r.state == "done" for r in reqs),
            "phases": [l.phase for l in sched.log],
            "merges": [l.merge for l in sched.log],
            "switches": sched.switches, "rebinds": len(eng.switch_log),
            "backend": eng.pool.describe()}


def islands_trace_rank(rank: int, world: int, out: str) -> None:
    """One rank of phase 14 (a): the trace on the card, then on the
    CPU; writes ``{out}.{rank}.json``."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    res = {dev: islands_trace(torch, dev) for dev in ("cuda", "cpu")}
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(res, f)


def check_islands_trace(runs) -> dict:
    """Phase 14 (a)'s verdict over every rank's result: the card's streams
    and schedule equal the CPU's, the same on each rank, through both
    rebinds, every request done."""
    def run(x):
        return {k: v for k, v in x.items() if k != "backend"}
    got = runs[0]["cuda"]
    for r, res in enumerate(runs):
        check(run(res["cuda"]) == run(res["cpu"]),
              f"rank {r}: card streams {res['cuda']['toks']} != CPU "
              f"{res['cpu']['toks']}")
        check(run(res["cuda"]) == run(got),
              f"rank {r} ran another schedule than rank 0")
    check(got["done"] == 8 and all(len(t) == 6 for t in got["toks"].values()),
          f"islands trace: {got['done']}/8 done")
    check(2 in got["merges"] and got["merges"][-1] == 1 and
          got["rebinds"] == 2,
          f"islands trace did not go DP -> TP2 -> DP: merges "
          f"{got['merges']}, {got['rebinds']} rebinds")
    return got


def lse_merge_check(torch, eng) -> float:
    """Phase 14 (c): K2's ``return_lse`` partials over two halves of each
    request's pages, one half on each rank (llama3-8b's per-rank shape at
    merge 2: H 16, KV 4, hd 128, page 32; fp32 q over bf16 pools), merged
    by ``TPContext.lse_merge`` over the two ranks, against one whole K2
    call. Returns the max abs error."""
    from repro_torch.core.views import make_serving_ctx
    from repro_torch.kernels.paged_attention import kernel as pk
    ctx = make_serving_ctx(2, 1, 1, group=eng.pool.seat(
        eng.layout.islands[0]).comm)
    dev = eng.device
    gen = torch.Generator(device=dev).manual_seed(14)
    Bq, H, KV, hd, page, nblk, mb = 8, 16, 4, 128, 32, 1024, 64
    kp, vp = (torch.randn((nblk, page, KV, hd), generator=gen,
                          device=dev).to(torch.bfloat16) for _ in range(2))
    q = torch.randn((Bq, H, hd), generator=gen, device=dev)
    bt = torch.randperm(nblk - 1, generator=gen, device=dev)[
        :Bq * mb].reshape(Bq, mb).to(torch.int32)
    half = mb // 2
    ctxl = torch.randint(half * page + 1, mb * page + 1, (Bq,),
                         generator=gen, device=dev).to(torch.int32)
    r = ctx.view_rank()
    part_bt = bt[:, r * half:(r + 1) * half].contiguous()
    part_len = ctxl.clamp(max=half * page) if r == 0 \
        else ctxl - half * page
    o, lse = pk.paged_attention_kernel(q, kp, vp, part_bt, part_len,
                                       return_lse=True)
    merged = ctx.lse_merge(o, torch.ones_like(lse), lse)
    whole = pk.paged_attention_kernel(q, kp, vp, bt, ctxl)
    torch.cuda.synchronize()
    err = float((merged - whole.float()).abs().max())
    check(torch.allclose(merged, whole.float(), **F32_TOL),
          f"lse_merge of split K2 partials is off one K2 call by {err:.3e}")
    return err


def decode_tick_ms(torch, eng, merge: int, steps: int = 10,
                   prompt: int = 512, kernels=SERVE_KERNELS,
                   hold: bool = True) -> dict:
    """Fleet decode ticks at one uniform merge: 2 x bpe requests of
    ``prompt`` tokens prefilled, two warm ticks, then ``steps`` ticks
    timed on the host clock to the end of a drain (which syncs every
    rank): the mean ms a tick, the slowest rank's. Returns the tick ms,
    the launches of ``kernels`` (K1-K4 by default) and those that
    returned the LSE, and the TP collectives of this rank over the
    prefill and the ticks; ``hold`` also holds the greedy tokens against
    a dense forward on this rank's parameters (``greedy_margins``: they
    must be the whole model's)."""
    from repro_torch.core.task_pool import Request
    from repro_torch.kernels import _lib
    eng.rebind(merge)
    isl = eng.layout.islands[0]
    reqs = []
    for i in range(2 * eng.bpe):
        r = Request(req_id=f"m{merge}_{i}", arrival=0.0, prompt_len=prompt,
                    output_len=1 << 30)
        r.engine_group = 0 if merge == 2 else i % 2
        reqs.append(r)
    _lib.reset_launches()
    coll0 = eng.pool.stats.collectives
    for r in reqs:
        eng.adaptors[r.engine_group].append_slots(r.req_id, prompt)
    eng.prefill(reqs, isl, prompt)
    t0 = 0.0
    for k in range(steps + 2):
        if k == 2:
            eng.drain()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        for r in reqs:
            eng.adaptors[r.engine_group].append_slots(r.req_id, 1)
        eng.decode(reqs, isl)
    eng.drain()
    torch.cuda.synchronize()
    ms = eng.pool.host_max((time.perf_counter() - t0) * 1e3 / steps)
    launches = {k: _lib.LAUNCHES[k] for k in kernels}
    lse = dict(_lib.LSE_LAUNCHES)
    for r in reqs:
        check(len(eng.generated_tokens(r.req_id)) == steps + 3,
              f"merge {merge}: {r.req_id} short of tokens")
    greedy = greedy_margins(torch, eng, reqs) if hold else None
    for r in reqs:
        eng.adaptors[r.engine_group].release(r.req_id)
    return {"ms": ms, "launches": launches, "lse": lse,
            "collectives": eng.pool.stats.collectives - coll0,
            "steps": steps + 3, "greedy": greedy}


def greedy_margins(torch, eng, reqs, dense=None) -> dict:
    """Holds every greedy token the engine streamed for ``reqs`` against
    one dense forward of the whole model on this rank (K5 and the full
    vocab, no pool, no collective), fed the prompt and the streamed
    tokens: each token must be the dense argmax, or a near-tie whose
    margin (dense top logit less the streamed token's) is at most
    NEAR_TIE_SD of the row's standard deviation over the vocab. bf16
    rounding moves a logit by a few hundredths of that; a token read
    from a wrong head or vocab slice lies some 4 deviations below the
    top. ``dense`` (tokens [T] -> fp32 logits [T, V]) replaces that
    forward. Returns the token count, the flips, their margins and the
    largest margin / bound."""
    import numpy as np

    from repro_torch.core.views import SINGLE
    from repro_torch.models.cache import TrainBackend
    acc = {"tokens": 0, "flips": 0, "worst": 0.0, "margins": []}
    for r in reqs:
        gen = eng.generated_tokens(r.req_id)
        seq = np.concatenate([np.asarray(eng.prompt_tokens(r)[:r.prompt_len],
                                         dtype=np.int64),
                              np.asarray(gen[:-1], dtype=np.int64)])
        seq_t = torch.as_tensor(seq, device=eng.device)
        if dense is not None:
            logits = dense(seq_t)[None]
        else:
            with torch.no_grad():
                logits, _, _ = eng.model.forward(
                    eng.params, SINGLE, mode="train", backend=TrainBackend(),
                    tokens=seq_t[None])
        tally_near_ties(acc, logits[0, r.prompt_len - 1:].float(),
                        torch.as_tensor(gen, device=eng.device))
    return acc


def tally_near_ties(acc: dict, rows, got) -> None:
    """Adds to ``acc`` the greedy tokens ``got`` [n] held against dense
    logits ``rows`` [n, V]: each a flip unless it is the rows' argmax,
    its margin (top logit less its own) against NEAR_TIE_SD of the row's
    standard deviation."""
    margin = rows.max(-1).values - rows.gather(1, got[:, None])[:, 0]
    acc["tokens"] += len(got)
    acc["flips"] += int((margin > 0).sum())
    acc["worst"] = max(acc["worst"], float(
        (margin / (NEAR_TIE_SD * rows.std(-1))).max()))
    acc["margins"] += [float(m) for m in margin[margin > 0]]


class MergeWhenMixed:
    """Layout policy for the LIVE traces: binds both engines into one TP2
    island once, at the first tick where a request decodes while another
    is part-way through its chunked prefill, and records the riders (the
    requests decoding then); with ``release_idle`` it dissolves the
    island once, at the first tick after that where no request holds KV
    (``holds_kv``); on every other tick it keeps the layout."""

    def __init__(self, release_idle: bool = False):
        self.riders = None
        self.release_idle = release_idle
        self.released = False

    def decide(self, sched):
        if self.riders is None and sched.running and any(
                0 < r.prefilled < r.prompt_len for r in sched.waiting):
            self.riders = sorted(r.req_id for r in sched.running)
            return 2
        if self.release_idle and self.riders is not None \
                and not self.released and not holds_kv(sched):
            self.released = True
            return 1
        return sched.layout


def live_config():
    """The reduced llama3-8b with 2 KV heads (rep 2). The reduced config
    has one KV head, which no merge above 1 can read in place
    (``PoolGeometry.live_readable``: MQA never qualifies), so its LIVE
    merge-up would pause instead of ride."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llama3-8b").reduced(),
                               num_kv_heads=2)


def _lane_keys(eng) -> list:
    """The lane tuples of the live steps the engine ran (runner keys)."""
    return sorted({str(k[8]) for k in eng.pool._runners if k[8]})


def _start(eng, reqs, island):
    """Prefill each request's whole prompt in one step and allocate its
    first decode slot (the scheduler's cadence)."""
    for r in reqs:
        eng.adaptors[r.engine_group].append_slots(r.req_id, r.prompt_len)
    eng.prefill(reqs, island, max(r.prompt_len for r in reqs))
    for r in reqs:
        eng.adaptors[r.engine_group].append_slots(r.req_id, 1)


def _decode_steps(eng, reqs, island, steps: int) -> None:
    for _ in range(steps):
        eng.decode(reqs, island)
        for r in reqs:
            eng.adaptors[r.engine_group].append_slots(r.req_id, 1)


def _request(rid: str, group: int, prompt: int):
    from repro_torch.core.task_pool import Request
    r = Request(req_id=rid, arrival=0.0, prompt_len=prompt,
                output_len=1 << 30)
    r.engine_group = group
    return r


def _sp_serve(eng, prompt: int, steps: int, rid: str = "long") -> dict:
    """One request on engine 0's island, prefilled a block a chunk (an SP
    island's chunk stays within one block), then ``steps`` decodes."""
    ad = eng.adaptors[0]
    cap = eng.geom.capacity(1)
    r = _request(rid, 0, prompt)
    isl = eng.layout.island_of(0)
    for lo in range(0, prompt, cap):
        ad.append_slots_batch([rid], [min(cap, prompt - lo)])
        r.prefilled = lo
        eng.prefill([r], isl, cap)
    r.prefilled = prompt
    ad.append_slots(rid, 1)
    _decode_steps(eng, [r], isl, steps)
    shards = sorted({min(o.engine_id for o in s.owners)
                     for s in ad.table[rid].segments})
    return {"req": r, "toks": list(map(int, eng.generated_tokens(rid))),
            "shards": shards, "one_pool": ad.max_context_tokens(1),
            "context": prompt + steps + 1}


def live_runs(torch, device) -> dict:
    """Phase 14 (d) on ``device``: live_config() in fp32 (weights seeded
    on the CPU) at ``ParallelPlan(1, 1, 2)``, every rebind and step
    zero-copy checked. (1) 8 staggered requests under LIVE on a fixed
    clock, the merge scripted 1 -> 2 while decodes and a chunked prefill
    are in flight (``MergeWhenMixed``); (2) a pure-SP island
    ``Island(0, 2, 2, sp=2)`` serving a 45-token context over pools of 28
    usable tokens, beside the same request at merge 1 from a big pool;
    (3) engine 1 killed mid-decode: its launch raises ``EngineFault``, the
    request is recovered from its harvested tokens onto engine 0, beside
    the fault-free run. Returns what the check compares."""
    from repro_torch.core.engine import FlyingEngine
    from repro_torch.core.faults import (KILL, EngineFault, FaultInjector,
                                         FaultSpec)
    from repro_torch.core.kv_adaptor import PoolGeometry
    from repro_torch.core.modes import FleetLayout, Island, ParallelPlan
    from repro_torch.core.scheduler import DynamicScheduler, SchedulerConfig
    from repro_torch.core.task_pool import Request
    from repro_torch.models.model import build_model

    cfg = live_config()
    plan = ParallelPlan(engine_rows=1, tp_base=1, data_rows=2)
    params = build_model(cfg, torch.float32, "cpu").init(
        torch.Generator().manual_seed(0))
    model = build_model(cfg, torch.float32, device)

    def engine(nb=64, **kw):
        return FlyingEngine(model, plan, PoolGeometry(
            cfg, plan, num_blocks=nb, block_base=4), params,
            batch_per_engine=2, max_blocks_per_req=16, device=device,
            check_zero_copy=True, **kw)

    out = {}
    eng = engine()
    policy = MergeWhenMixed()
    sched = DynamicScheduler(plan, eng.geom, FixedClock(eng), SchedulerConfig(
        strategy="live", max_batch_per_group=2, prefill_chunk=8),
        policy=policy)
    for i in range(8):
        sched.submit(Request(req_id=f"r{i}", arrival=0.004 * i,
                             prompt_len=8 + 4 * (i % 4), output_len=6))
    sched.run(max_steps=400)
    reqs = sorted(sched.pool.all.values(), key=lambda r: r.req_id)
    out["live"] = {
        "toks": {r.req_id: list(map(int, eng.generated_tokens(r.req_id)))
                 for r in reqs},
        "done": sum(r.state == "done" for r in reqs),
        "phases": [l.phase for l in sched.log],
        "merges": [l.merge for l in sched.log],
        "riders": policy.riders, "preempt": dict(sched.preempt_stats),
        "lanes": _lane_keys(eng), "host_argmax": eng.sync_stats.host_argmax}

    sp_eng = engine(8, layout=FleetLayout(plan, (Island(0, 2, 2, sp=2),)))
    sp = _sp_serve(sp_eng, 32, 12)
    big = _sp_serve(engine(layout=FleetLayout.uniform(plan, 1)), 32, 12)
    out["sp"] = {k: sp[k] for k in ("toks", "shards", "one_pool",
                                    "context")}
    out["sp"]["lanes"] = _lane_keys(sp_eng)
    out["sp_big"] = big["toks"]

    dp = FleetLayout.of(plan, [(1, 1), (1, 1)])

    def kill_run(inj):
        eng = engine(layout=dp, injector=inj)
        v, bg = _request("v", 1, 9), _request("b", 0, 9)
        isl_v, isl_b = dp.island_of(1), dp.island_of(0)
        free = eng.adaptors[1].free_blocks()
        _start(eng, [v], isl_v)
        _start(eng, [bg], isl_b)
        _decode_steps(eng, [v], isl_v, 3)
        _decode_steps(eng, [bg], isl_b, 3)
        if inj is None:
            _decode_steps(eng, [v], isl_v, 5)
            _decode_steps(eng, [bg], isl_b, 6)
            return {r.req_id: list(map(int, eng.generated_tokens(
                r.req_id))) for r in (v, bg)}
        # harvest v's island: 4 tokens reach the host; the next 2 stay on
        # the card and die with engine 1
        eng._drain_island(eng._rt_of[isl_v])
        _decode_steps(eng, [v], isl_v, 2)
        inj.advance(1)
        fault = None
        try:
            eng.decode([v], isl_v)
        except EngineFault as ex:
            fault = sorted(ex.engines)
        kept = eng.recover_request(v)
        v.prompt_len = v.prompt_len - v.folded + kept
        v.folded = kept
        v.prefilled = 0
        eng.adaptors[1].drop_for_recompute("v")
        leaked = free - eng.adaptors[1].free_blocks()
        eng.rebind(eng.layout.quarantine({1}))
        v.engine_group = 0
        _start(eng, [v], isl_b)
        _decode_steps(eng, [v], isl_b, 4)
        _decode_steps(eng, [bg], isl_b, 6)
        drains = eng.island_sync_stats(isl_b).drains
        return {"toks": {r.req_id: list(map(int, eng.generated_tokens(
                    r.req_id))) for r in (v, bg)},
                "fault": fault, "kept": kept, "leaked": leaked,
                "b_drains": drains,
                "layout": eng.layout.describe()}

    out["kill"] = kill_run(FaultInjector(
        [FaultSpec(kind=KILL, tick=1, engines=(1,))]))
    out["kill_free"] = kill_run(None)
    return out


def live_runs_rank(rank: int, world: int, out: str) -> None:
    """One rank of phase 14 (d): the runs on the card, then on the CPU;
    writes ``{out}.{rank}.json``."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    res = {dev: live_runs(torch, dev) for dev in ("cuda", "cpu")}
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(res, f)


def check_live_runs(runs) -> dict:
    """Phase 14 (d)'s verdict over every rank's result: the card's streams
    and schedules equal the CPU's, the same on each rank; the LIVE
    merge-up rode its riders with nothing paused or recomputed; the SP
    island served a context over one engine's pool as the big pool did;
    the killed engine's request recovered to the fault-free stream with
    no block leaked."""
    got = runs[0]["cuda"]
    for r, res in enumerate(runs):
        check(res["cuda"] == res["cpu"],
              f"rank {r}: card runs differ from the CPU's: "
              f"{ {k: (res['cuda'][k], res['cpu'][k]) for k in res['cuda'] if res['cuda'][k] != res['cpu'][k]} }")
        check(res["cuda"] == got, f"rank {r} ran another schedule than "
              f"rank 0")
    live, sp, kill = got["live"], got["sp"], got["kill"]
    p = live["preempt"]
    check(live["done"] == 8 and all(len(t) == 6
                                    for t in live["toks"].values()),
          f"live trace: {live['done']}/8 done")
    check(2 in live["merges"] and bool(live["riders"]) and
          p["live_riders"] > 0 and p["paused"] == 0 and
          p["recomputed_tokens"] == 0 and live["host_argmax"] == 0,
          f"live trace did not ride its merge-up: riders {live['riders']}, "
          f"{p}")
    check(any("1, 2" in k for k in live["lanes"]),
          f"live trace ran no lanes of tags (1, 2): {live['lanes']}")
    check(sp["context"] > sp["one_pool"] and sp["shards"] == [0, 1] and
          sp["toks"] == got["sp_big"] and sp["lanes"] == ["(1, 1)"],
          f"SP island: shards {sp['shards']}, lanes {sp['lanes']}, tokens "
          f"{sp['toks']} vs the big pool's {got['sp_big']}")
    check(kill["fault"] == [1] and kill["kept"] == 4 and
          kill["leaked"] == 0 and kill["toks"] == got["kill_free"] and
          kill["b_drains"] == 0,
          f"kill: {kill} vs fault-free {got['kill_free']}")
    return got


def live_full_width(torch, stack, cfg) -> dict:
    """Phase 14 (e)'s LIVE trace: phase 5's 8 requests replayed through
    ``stack`` (llama3-8b in bf16 at ``ParallelPlan(1, 1, 2)``, every
    rebind and step zero-copy checked) under LIVE, the merge scripted 1
    -> 2 while decodes and a chunked prefill are in flight, K1-K4's
    launches and K2's and K4's LSE launches (the live lanes' sweeps)
    counted from zero; the riders' greedy tokens held against the dense
    one-rank forward."""
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import replay
    sched, eng = stack[0], stack[0].backend
    policy = MergeWhenMixed()
    sched.policy = policy
    _lib.reset_launches()
    coll0 = eng.pool.stats.collectives
    sched, wall = replay(cfg, stack)
    launches = {k: _lib.LAUNCHES[k] for k in SERVE_KERNELS}
    lse = dict(_lib.LSE_LAUNCHES)
    reqs = list(sched.pool.all.values())
    riders = [r for r in reqs if r.req_id in (policy.riders or ())]
    return {
        "done": sum(r.state == "done" and len(eng.generated_tokens(
            r.req_id)) == r.output_len for r in reqs),
        "n": len(reqs), "riders": policy.riders,
        "preempt": dict(sched.preempt_stats), "wall_s": wall,
        "merges": [l.merge for l in sched.log],
        "phases": [l.phase for l in sched.log],
        "launches": launches, "lse": lse, "lanes": _lane_keys(eng),
        "steps": eng.sync_stats.steps,
        "collectives": eng.pool.stats.collectives - coll0,
        "host_argmax": eng.sync_stats.host_argmax,
        "greedy": greedy_margins(torch, eng, riders)}


def live_tick_ms(torch, eng, steps: int = 10, prompt: int = 512,
                 hold: bool = True) -> dict:
    """Phase 14 (e): a fleet decode tick of 16 rows at merge 2 whose KV is
    tag 1: 2 x bpe requests of ``prompt`` tokens prefilled and decoded
    twice at merge 1 (each rank's 8 rows), a LIVE rebind to merge 2
    (their pending slots retagged), two warm ticks, then ``steps`` ticks
    timed as ``decode_tick_ms`` times them. Returns the tick ms, K1-K4's
    launches and K2's LSE launches over the 12 live ticks (one a lane a
    layer a tick), their lanes, the TP collectives a tick and, with
    ``hold``, the greedy check of every token."""
    from repro_torch.kernels import _lib
    eng.rebind(1)
    reqs = [_request(f"tick{i}", i % 2, prompt) for i in range(2 * eng.bpe)]
    _start(eng, reqs, eng.layout.islands[0])
    _decode_steps(eng, reqs, eng.layout.islands[0], 2)
    eng.rebind(2)
    for r in reqs:
        eng.adaptors[r.engine_group].retag_tail(r.req_id)
    isl = eng.layout.islands[0]
    _lib.reset_launches()
    coll0 = eng.pool.stats.collectives
    t0 = 0.0
    for k in range(steps + 2):
        if k == 2:
            eng.drain()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        _decode_steps(eng, reqs, isl, 1)
    eng.drain()
    torch.cuda.synchronize()
    ms = eng.pool.host_max((time.perf_counter() - t0) * 1e3 / steps)
    launches = {k: _lib.LAUNCHES[k] for k in SERVE_KERNELS}
    lse = dict(_lib.LSE_LAUNCHES)
    for r in reqs:
        check(len(eng.generated_tokens(r.req_id)) == steps + 5,
              f"live tick: {r.req_id} short of tokens")
    greedy = greedy_margins(torch, eng, reqs) if hold else None
    for r in reqs:
        eng.adaptors[r.engine_group].release(r.req_id)
    return {"ms": ms, "launches": launches, "lse": lse,
            "lanes": _lane_keys(eng),
            "collectives": (eng.pool.stats.collectives - coll0)
            / (steps + 2), "steps": steps + 2, "greedy": greedy}


SP_BLOCKS, SP_PAGE, SP_PROMPT, SP_STEPS = 24, 128, 3072, 16


def sp_full_width(torch, weights) -> dict:
    """Phase 14 (e)'s SP run: llama3-8b in bf16 sharing ``weights`` (the
    (b) engine's model and parameters), a pool cut to SP_BLOCKS blocks
    of SP_PAGE tokens a rank (2944 usable), one SP_PROMPT-token request
    on a pure-SP island ``Island(0, 2, 2, sp=2)``, prefilled a block a
    chunk, then SP_STEPS decodes: its context exceeds one rank's pool;
    its greedy tokens held against the dense one-rank forward."""
    from repro_torch.core.engine import FlyingEngine
    from repro_torch.core.kv_adaptor import PoolGeometry
    from repro_torch.core.modes import FleetLayout, Island, ParallelPlan
    from repro_torch.kernels import _lib
    model, params = weights
    plan = ParallelPlan(engine_rows=1, tp_base=1, data_rows=2)
    geom = PoolGeometry(model.cfg, plan, num_blocks=SP_BLOCKS,
                        block_base=SP_PAGE)
    eng = FlyingEngine(model, plan, geom, params, batch_per_engine=1,
                       max_blocks_per_req=16, device=model.device,
                       check_zero_copy=True,
                       layout=FleetLayout(plan, (Island(0, 2, 2, sp=2),)))
    _lib.reset_launches()
    t0 = time.perf_counter()
    res = _sp_serve(eng, SP_PROMPT, SP_STEPS)
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lse = dict(_lib.LSE_LAUNCHES)
    return {"context": res["context"], "one_pool": res["one_pool"],
            "shards": res["shards"], "tokens": len(res["toks"]),
            "wall_s": wall, "lse": lse, "lanes": _lane_keys(eng),
            "greedy": greedy_margins(torch, eng, [res["req"]])}


def islands_rank(rank: int, world: int, out: str) -> None:
    """One rank of phase 14: (a) the reduced trace on the card and the
    CPU, (d) the LIVE, SP and KILL runs on the card and the CPU, (b)
    llama3-8b at full width and depth in bf16 serving phase 5's 8
    requests at ``ParallelPlan(1, 1, 2)`` with the merge scripted 1 -> 2
    -> 1, every rebind zero-copy checked, then fleet decode ticks at
    merge 1 and at merge 2, (c) the lse_merge of split K2 partials, (e)
    phase 5's requests under LIVE with the merge scripted 1 -> 2, a
    decode tick of tag-1 riders at merge 2 and a context over one rank's
    pool on an SP island. Writes ``{out}.{rank}.json``."""
    import gc

    import torch

    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import build_stack, replay
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    t0 = time.perf_counter()
    res = {"a": {dev: islands_trace(torch, dev) for dev in ("cuda", "cpu")}}
    t1 = time.perf_counter()
    res["d"] = {dev: live_runs(torch, dev) for dev in ("cuda", "cpu")}
    res["d_s"] = time.perf_counter() - t1

    cfg = serve_config(num_blocks=2048, ranks=2)
    t1 = time.perf_counter()
    stack = build_stack(cfg, check_zero_copy=True)
    sched, eng = stack[0], stack[0].backend
    sched.policy = ScriptedMerge(2, 400)
    torch.cuda.synchronize()
    res["build_s"] = time.perf_counter() - t1
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    sched, wall = replay(cfg, stack)
    trace_launches = {k: _lib.LAUNCHES[k] for k in SERVE_KERNELS}
    reqs = list(sched.pool.all.values())
    res["b"] = {
        "done": sum(r.state == "done" and len(eng.generated_tokens(
            r.req_id)) == r.output_len for r in reqs),
        "n": len(reqs),
        "tokens": sum(len(eng.generated_tokens(r.req_id)) for r in reqs),
        "in_vocab": all(0 <= x < eng.cfg.vocab_size for r in reqs
                        for x in eng.generated_tokens(r.req_id)),
        "wall_s": wall, "merges": [l.merge for l in sched.log],
        "phases": [l.phase for l in sched.log],
        "rebind_ms": [dt * 1e3 for dt in eng.switch_log],
        "launches": trace_launches,
        "host_argmax": eng.sync_stats.host_argmax,
        "sync": str(eng.sync_stats),
        "collectives": [eng.pool.stats.collectives,
                        eng.pool.stats.host_collectives]}
    res["tick1"] = decode_tick_ms(torch, eng, 1)
    res["tick2"] = decode_tick_ms(torch, eng, 2)
    res["c_err"] = lse_merge_check(torch, eng)
    st = eng.pool.stats
    res["pool"] = {"describe": eng.pool.describe(),
                   "build_ms": st.group_build_s * 1e3,
                   "lookup_us": st.lookup_s / max(st.lookups, 1) * 1e6,
                   "lookups": st.lookups}
    res["rebind_ms"] = [dt * 1e3 for dt in eng.switch_log]
    weights = (eng.model, eng.params)

    # (e): a fresh engine over the same weights (its own pools and token
    # buffers: phase 5's request ids again), then the SP engine
    del stack, sched, eng, reqs
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    live_cfg = serve_config(num_blocks=2048, ranks=2, strategy="live")
    stack = build_stack(live_cfg, weights, check_zero_copy=True)
    res["e"] = live_full_width(torch, stack, live_cfg)
    res["e_tick"] = live_tick_ms(torch, stack[0].backend)
    del stack
    gc.collect()
    torch.cuda.empty_cache()
    res["e_sp"] = sp_full_width(torch, weights)
    res["e_s"] = time.perf_counter() - t1
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["rank_s"] = time.perf_counter() - t0
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(res, f)


def check_live_full_width(runs, smi: str) -> None:
    """Phase 14 (e)'s verdict and readings: every request of the LIVE
    trace done, its merge-up riding its riders with nothing paused or
    recomputed, K2's and K4's LSE launches (the live lanes) counted and
    required, every greedy token of the riders, the live tick and the SP
    run a dense argmax or a near-tie; the SP context over one rank's
    pool."""
    e = runs[0]["e"]
    for r, res in enumerate(runs):
        x, tick, sp = res["e"], res["e_tick"], res["e_sp"]
        p = x["preempt"]
        check(x["done"] == x["n"] == 8 and x["host_argmax"] == 0,
              f"rank {r}: live trace {x['done']}/{x['n']} done")
        check(2 in x["merges"] and bool(x["riders"]) and
              p["live_riders"] > 0 and p["paused"] == 0 and
              p["recomputed_tokens"] == 0,
              f"rank {r}: the LIVE merge-up did not ride: riders "
              f"{x['riders']}, {p}")
        check(x["merges"] == e["merges"] and x["preempt"] == e["preempt"],
              f"rank {r} scheduled another live trace than rank 0")
        for what, lse in (("trace", x["lse"]), ("SP run", sp["lse"])):
            check(all(lse[k] > 0 for k in ("paged_attention",
                                           "paged_flash_prefill")),
                  f"rank {r}: the {what}'s live lanes never launched "
                  f"K2 and K4 with their LSE: {lse}")
        check(tick["lse"]["paged_attention"] ==
              tick["launches"]["paged_attention"] > 0,
              f"rank {r}: live tick K2 launches {tick['launches']}, LSE "
              f"{tick['lse']}")
        check(sp["context"] > sp["one_pool"] and sp["shards"] == [0, 1],
              f"rank {r}: SP run {sp['context']} tokens over pools of "
              f"{sp['one_pool']}, shards {sp['shards']}")
        for what, g in (("rider", x["greedy"]), ("live tick", tick["greedy"]),
                        ("SP", sp["greedy"])):
            check(g["tokens"] > 0 and g["worst"] <= 1.0,
                  f"rank {r}: a {what} greedy token is off the dense "
                  f"one-rank forward's argmax by {g['worst']:.2f}x the "
                  f"near-tie bound (margins {g['margins']})")
    tick, sp = runs[0]["e_tick"], runs[0]["e_sp"]
    plain = runs[0]["tick2"]
    print(f"islands (e): llama3-8b bf16, 32 layers, phase 5's 8 requests "
          f"under LIVE, merge 1 -> 2 while {len(e['riders'])} requests "
          f"decode and a chunked prefill is in flight: {e['done']}/8 done "
          f"in {e['wall_s']:.3f} s, preempt_stats {e['preempt']}, lanes "
          f"{e['lanes']}, weight and pool data_ptrs unchanged over every "
          f"rebind and step; K1-K4 launches a rank "
          f"{[res['e']['launches'] for res in runs]}, of them returning "
          f"the LSE (the live lanes) {[res['e']['lse'] for res in runs]}; "
          f"{e['collectives'] / max(e['steps'], 1):.1f} TP collectives a "
          f"step on rank 0; riders' greedy tokens against a dense one-rank "
          f"forward: {e['greedy']['flips']} of {e['greedy']['tokens']} "
          f"near-ties off its argmax (at most {e['greedy']['worst']:.2f}x "
          f"the bound)")
    print(f"islands (e): {smi}; decode tick of 16 tag-1 riders at merge 2 "
          f"(prompts of 512): {tick['ms']:.2f} ms (the slower rank's) "
          f"beside (b)'s plain merge-2 tick {plain['ms']:.2f} ms; lanes "
          f"{tick['lanes']}; {tick['collectives']:.1f} TP collectives a "
          f"tick on rank 0 (plain: {plain['collectives'] / plain['steps']:.1f}"
          f"); K1-K4 launches over its {tick['steps']} live ticks "
          f"{[res['e_tick']['launches'] for res in runs]}, K2 with its LSE "
          f"{[res['e_tick']['lse']['paged_attention'] for res in runs]}; "
          f"greedy {tick['greedy']['flips']} of {tick['greedy']['tokens']} "
          f"near-ties (at most {tick['greedy']['worst']:.2f}x the bound)")
    print(f"islands (e): {smi}; SP island Island(0, 2, 2, sp=2) served a "
          f"{sp['context']}-token context over pools of {sp['one_pool']} "
          f"tokens a rank (shards {sp['shards']}, lanes {sp['lanes']}) in "
          f"{sp['wall_s']:.3f} s; K2/K4 LSE launches "
          f"{[res['e_sp']['lse'] for res in runs]}; greedy "
          f"{sp['greedy']['flips']} of {sp['greedy']['tokens']} near-ties "
          f"(at most {sp['greedy']['worst']:.2f}x the bound); (d) "
          f"{max(res['d_s'] for res in runs):.1f} s and (e) "
          f"{max(res['e_s'] for res in runs):.1f} s of the phase")


def serve_islands(torch, smi: str) -> None:
    """Phase 14: spawn two rank processes on the one card (gloo), run
    ``islands_rank`` in each, and check and print what they found."""
    import tempfile

    from repro_torch.launch.ranks import spawn
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        out = str(Path(d) / "isl")
        spawn(islands_rank, 2, (out,), device_type="cuda",
              timeout=900)
        runs = []
        for r in range(2):
            with open(f"{out}.{r}.json") as f:
                runs.append(json.load(f))
    a = check_islands_trace([res["a"] for res in runs])
    print(f"islands: {a['backend']}; two ranks share this card over gloo, "
          f"host-staged: no number here measures TP on two cards")
    print(f"islands (a): reduced llama3-8b fp32, DP -> TP2 -> DP "
          f"({a['rebinds']} rebinds, merges by tick {a['merges']}): card "
          f"streams equal the CPU ranks', {a['done']}/8 done")
    d = check_live_runs([res["d"] for res in runs])
    live, sp, kill = d["live"], d["sp"], d["kill"]
    print(f"islands (d): reduced llama3-8b with 2 KV heads, fp32, card "
          f"runs equal the CPU ranks' on both ranks "
          f"({max(res['d_s'] for res in runs):.1f} s): LIVE DP -> TP2 "
          f"with {len(live['riders'])} riders and a chunked prefill in "
          f"flight, {live['done']}/8 done, preempt_stats {live['preempt']},"
          f" lanes {live['lanes']}; SP island Island(0, 2, 2, sp=2) "
          f"served a {sp['context']}-token context over pools of "
          f"{sp['one_pool']} tokens (shards {sp['shards']}, lanes "
          f"{sp['lanes']}), tokens equal to the big pool's; KILL of "
          f"engine 1 mid-decode: EngineFault on {kill['fault']}, "
          f"{kill['kept']} tokens kept, {kill['leaked']} blocks leaked, "
          f"the recovered stream equals the fault-free one")
    b = runs[0]["b"]
    for r, res in enumerate(runs):
        check(res["b"]["done"] == res["b"]["n"] == 8 and res["b"]["in_vocab"]
              and res["b"]["host_argmax"] == 0,
              f"rank {r}: full-width trace {res['b']['done']}/"
              f"{res['b']['n']} done")
        check(res["b"]["merges"] == b["merges"],
              f"rank {r} scheduled another merge sequence")
        for k in SERVE_KERNELS:
            check(res["tick2"]["launches"][k] > 0,
                  f"rank {r}: {k} never launched at merge 2")
        for m in (1, 2):
            g = res[f"tick{m}"]["greedy"]
            check(g["worst"] <= 1.0,
                  f"rank {r}: a merge-{m} greedy token is off the dense "
                  f"one-rank forward's argmax by {g['worst']:.2f}x the "
                  f"near-tie bound (margins {g['margins']})")
    check(2 in b["merges"] and b["merges"][-1] == 1,
          f"full-width trace did not go 1 -> 2 -> 1: {b['merges']}")
    print(f"islands (b): llama3-8b bf16, 32 layers, phase 5's 8 "
          f"requests at ParallelPlan(1, 1, 2) with merge 1 -> 2 -> 1: "
          f"{b['done']}/8 done, {b['tokens']} tokens in {b['wall_s']:.3f} s "
          f"({b['phases'].count('mixed')} mixed, {b['phases'].count('decode')}"
          f" decode ticks, {sum(m == 2 for m in b['merges'])} of "
          f"{len(b['merges'])} ticks at merge 2); weight and pool "
          f"data_ptrs unchanged over every rebind")
    print(f"islands (b): {b['sync']}; {b['collectives'][0]} TP and "
          f"{b['collectives'][1]} host collectives on rank 0 (each gloo "
          f"collective also waits for the card)")
    for r, res in enumerate(runs):
        print(f"islands (b) rank {r}: rebinds "
              f"{', '.join(f'{x:.2f}' for x in res['rebind_ms'])} ms; "
              f"pool {res['pool']['build_ms']:.1f} ms to build its groups, "
              f"{res['pool']['lookup_us']:.2f} us a lookup "
              f"({res['pool']['lookups']} lookups); trace launches "
              f"{res['b']['launches']}; peak memory {res['peak_gib']:.2f} "
              f"GiB; weights built in {res['build_s']:.1f} s")
    for m in (1, 2):
        t = runs[0][f"tick{m}"]
        g = t["greedy"]
        print(f"islands (b): decode tick at merge {m} (16 requests of 512 "
              f"tokens): {t['ms']:.2f} ms (the slower rank's), "
              f"{t['collectives'] / t['steps']:.1f} TP collectives a step "
              f"on rank 0; K1-K4 launches "
              f"{[res[f'tick{m}']['launches'] for res in runs]}; greedy "
              f"tokens against a dense one-rank forward: {g['flips']} of "
              f"{g['tokens']} are near-ties off its argmax (margins "
              f"{[f'{x:.3g}' for x in g['margins']]}, at most "
              f"{g['worst']:.2f}x the bound of {NEAR_TIE_SD} row "
              f"deviations)")
    print(f"islands (c): lse_merge of K2's split partials vs one K2 call: "
          f"max_abs_err {max(res['c_err'] for res in runs):.3e}")
    check_live_full_width(runs, smi)
    print(f"islands: {smi}; phase 14 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 15: MLA and MoE (DeepSeek-V2, Phi-3.5-MoE)
# ---------------------------------------------------------------------------

MLA_ARCH, MOE_ARCH = "deepseek-v2-236b", "phi3.5-moe-42b-a6.6b"
# phase 15 (a)'s trace: prompts in chunks of 8 (the first, of 24,
# prefills alone), request 3 at priority 1
MOE_TRACE = [dict(req_id=f"r{i}", arrival=i * 0.01,
                  prompt_len=(24, 8, 12, 16, 20, 28)[i], output_len=3 + i,
                  priority=1 if i == 3 else 0) for i in range(6)]


def moe_reference_check(torch):
    """Phase 15 (a): the reduced DeepSeek-V2 (MLA + MoE) and Phi-3.5-MoE
    (GQA + MoE) in fp32 through a scheduler run with prefill, mixed and
    decode steps, on the card (K1-K4 and mla_decode) and on the CPU
    (their plain versions): greedy tokens and phase logs equal."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import FlyingEngine
    from repro_torch.core.kv_adaptor import PoolGeometry
    from repro_torch.core.modes import ParallelPlan
    from repro_torch.core.scheduler import DynamicScheduler, SchedulerConfig
    from repro_torch.core.task_pool import Request
    from repro_torch.kernels import _lib
    from repro_torch.models.model import build_model

    plan = ParallelPlan(engine_rows=1, tp_base=1, data_rows=1)
    for arch in (MLA_ARCH, MOE_ARCH):
        cfg = get_config(arch).reduced()
        params = build_model(cfg, torch.float32, "cpu").init(
            torch.Generator().manual_seed(0))

        def serve(device):
            geom = PoolGeometry(cfg, plan, num_blocks=64, block_base=4)
            eng = FlyingEngine(build_model(cfg, torch.float32, device), plan,
                               geom, params, batch_per_engine=2,
                               max_blocks_per_req=16, device=device)
            sched = DynamicScheduler(plan, geom, FixedClock(eng),
                                     SchedulerConfig(strategy="hard",
                                                     max_batch_per_group=2,
                                                     prefill_chunk=8))
            for r in MOE_TRACE:
                sched.submit(Request(**r))
            sched.run(max_steps=400)
            return ({r["req_id"]: eng.generated_tokens(r["req_id"])
                     for r in MOE_TRACE}, [l.phase for l in sched.log])

        _lib.reset_launches()
        toks_gpu, ph_gpu = serve("cuda")
        launches = dict(_lib.LAUNCHES)
        toks_cpu, ph_cpu = serve("cpu")
        print(f"moe (a): reduced {arch} fp32, card vs CPU: tokens {toks_gpu}"
              f" phases {ph_gpu}; card launches {launches}")
        check(toks_gpu == toks_cpu, f"{arch}: card tokens {toks_gpu} != CPU "
                                    f"{toks_cpu}")
        check(ph_gpu == ph_cpu and {"prefill", "mixed", "decode"}
              <= set(ph_gpu), f"{arch}: phase logs {ph_gpu} vs {ph_cpu}")
        check(all(len(v) == r["output_len"] for v, r in
                  zip(toks_gpu.values(), MOE_TRACE)),
              f"{arch}: a request is short of tokens")
        kernels = ("paged_append_token", "paged_append_chunk", "mla_decode") \
            if arch == MLA_ARCH else SERVE_KERNELS
        for k in kernels:
            check(launches[k] > 0, f"{arch}: {k} never launched")


def dense_mla_logits(model, params):
    """The dense reference of phase 15 (b): tokens [T] -> fp32 logits
    [T, V] of one forward over the whole sequence, with no pool and no
    absorbed decode (each MLA layer expands its in-line compressed
    entries naively, causal by position: ``TrainBackend.append_ctx``)
    and no capacity (each MoE layer sends every token through its top-k
    experts: ``dense_moe_ref``)."""
    from repro_torch.core.views import SINGLE
    from repro_torch.models import moe
    from repro_torch.models.cache import TrainBackend

    def forward(seq):
        dispatch = moe.moe_ffn
        moe.moe_ffn = lambda cfg, p, x, ctx: moe.dense_moe_ref(cfg, p, x)
        try:
            # decode mode keeps every position's logits (prefill keeps
            # the last); TrainBackend makes the attention in-line
            logits, _, _ = model.forward(params, SINGLE, mode="decode",
                                         backend=TrainBackend(),
                                         tokens=seq[None])
        finally:
            moe.moe_ffn = dispatch
        return logits[0]
    return forward


class FiniteLogits:
    """Wraps ``steps.sample_tokens``: every sampled row's logits feed a
    device flag that stays True while all are finite (no host read in
    the serving loop)."""

    def __init__(self, torch, steps):
        self.steps, self.inner = steps, steps.sample_tokens
        self.ok = torch.ones((), dtype=torch.bool, device="cuda")
        self.rows = 0

        def sample(cfg, logits, ctx, **kw):
            self.ok &= torch.isfinite(logits).all()
            self.rows += logits.shape[0]
            return self.inner(cfg, logits, ctx, **kw)
        steps.sample_tokens = sample

    def restore(self) -> bool:
        self.steps.sample_tokens = self.inner
        return bool(self.ok)


class MoEDrops:
    """Wraps ``moe.moe_ffn``: counts, on the card, the (token, choice)
    entries that a call's capacity drops (padding rows included, as
    they take capacity in serving) beside the entries routed."""

    def __init__(self, torch, moe):
        self.moe, self.inner = moe, moe.moe_ffn
        self.dropped = torch.zeros((), dtype=torch.long, device="cuda")
        self.entries = 0

        def ffn(cfg, p, x, ctx):
            n = x.shape[0] * x.shape[1]
            e, _, _ = moe.route(p["router"], x.reshape(n, -1),
                                cfg.moe.top_k)
            pos = moe._positions_in_expert(e.reshape(-1),
                                           cfg.moe.num_experts)
            self.dropped += (pos >= moe.capacity(cfg, n)).sum()
            self.entries += n * cfg.moe.top_k
            return self.inner(cfg, p, x, ctx)
        moe.moe_ffn = ffn

    def restore(self) -> int:
        self.moe.moe_ffn = self.inner
        return int(self.dropped)


def serve_mla_full_width(torch, smi: str) -> dict:
    """Phase 15 (b): deepseek-v2-236b at full width, 4 of its 60 layers
    (the dense MLA+MLP layer and three MLA+MoE layers), bf16, seed-0
    weights, at ParallelPlan(1, 1, 1) over a 4096 x 16-token pool: 8
    requests (prompts 256-1024, 32 tokens out) through the launcher's
    real path (DynamicScheduler over FlyingEngine under the layout
    policy), launch counts reset just before and read just after. Every
    request done with finite logits and in-vocab tokens; K1 and
    mla_decode launched once a layer in every step that carries decode
    rows, K3 once a layer in every step that carries prefill rows. The
    config's capacity factor (1.25) drops entries, and which ones
    depends on how the batch was cut (with random weights most tokens
    pick the same experts), which no single-sequence forward
    reproduces; so the greedy tokens are held on a second run of the
    same trace in steps of at most 8 tokens (prefill chunks of 1),
    where an expert's capacity (at least 8) drops nothing (counted):
    each must be the dense forward's argmax or a near-tie
    (NEAR_TIE_SD); the first run's drops and its distance from the
    dense forward are printed. Prints
    tok/s, the median decode tick, the peak memory, and a profiled
    rerun's device time by kernel class."""
    import dataclasses
    import math

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import steps as steps_mod
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import build_stack, replay
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    from repro_torch.training.checkpoint import tree_leaves

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(MLA_ARCH), num_layers=4)
    sc = serve_config(arch=MLA_ARCH, prompt_range=(256, 1024),
                      output_range=(32, 32))
    gc_collect(torch)
    t0 = time.perf_counter()
    model = build_model(cfg, torch.bfloat16, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"mla (b): built {MLA_ARCH} at full width, {cfg.num_layers} of 60 "
          f"layers ({n_params / 1e9:.3f} B parameters, bf16) in "
          f"{time.perf_counter() - t0:.1f} s")
    stack = build_stack(sc, weights=(model, params))
    engine = stack[0].backend
    clock = StepClock(engine)
    stack[0].backend = clock
    finite = FiniteLogits(torch, steps_mod)
    drops = MoEDrops(torch, moe)
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    try:
        sched, wall = replay(sc, stack)
    finally:
        ok = finite.restore()
        dropped = drops.restore()
    launches = dict(_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    reqs = list(sched.pool.all.values())
    vocab = cfg.vocab_size
    n_tok = 0
    for r in reqs:
        toks = engine.generated_tokens(r.req_id)
        check(r.state == "done" and len(toks) == r.output_len,
              f"{r.req_id}: state {r.state}, {len(toks)}/{r.output_len} "
              f"tokens")
        check(all(0 <= x < vocab for x in toks),
              f"{r.req_id}: token outside the vocab")
        n_tok += len(toks)
    check(len(reqs) == 8, f"{len(reqs)} requests served, not 8")
    check(ok, "a sampled row's logits are not finite")
    kinds = [k for k, _, _ in clock.log]
    with_dec = sum(1 for k, ids, _ in clock.log
                   if k == "decode" or (k == "mixed" and ids[1]))
    with_pre = sum(1 for k, ids, _ in clock.log
                   if k == "prefill" or (k == "mixed" and ids[0]))
    L = cfg.num_layers
    want = {"mla_decode": L * with_dec, "paged_append_token": L * with_dec,
            "paged_append_chunk": L * with_pre}
    print(f"mla (b): {len(reqs)} requests, prompts "
          f"{sorted(r.prompt_len for r in reqs)}, outputs "
          f"{sorted(r.output_len for r in reqs)}; {len(kinds)} steps "
          f"({kinds.count('prefill')} prefill, {kinds.count('mixed')} mixed,"
          f" {kinds.count('decode')} decode; {with_dec} with decode rows); "
          f"{finite.rows} sampled rows, all logits finite")
    print(f"mla (b): kernel launches {launches}")
    for k, n in want.items():
        check(launches[k] == n, f"{k} launched {launches[k]} times, not "
                                f"{L} layers x the steps that run it = {n}")
    check(engine.sync_stats.host_argmax == 0,
          "tokens were read back one at a time")
    ticks = sorted(dt for k, _, dt in clock.log if k == "decode")
    tick = ticks[len(ticks) // 2] if ticks else float("nan")
    print(f"mla (b): {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} "
          f"tok/s; median decode tick {tick * 1e3:.2f} ms over "
          f"{len(ticks)} decode steps (min {ticks[0] * 1e3:.2f}, max "
          f"{ticks[-1] * 1e3:.2f}); peak memory {peak / 2**30:.2f} GiB; "
          f"{smi}")
    dense = dense_mla_logits(model, params)
    g = greedy_margins(torch, engine, reqs, dense=dense)
    print(f"mla (b): capacity factor {cfg.moe.capacity_factor}: "
          f"{dropped} of {drops.entries} routed entries dropped; greedy "
          f"tokens against a dense forward (no pool, naive MLA, no MoE "
          f"capacity): {g['flips']} of {g['tokens']} off its argmax, at "
          f"most {g['worst']:.2f}x the bound of {NEAR_TIE_SD} row "
          f"deviations")
    # the hold: the same trace in steps of at most 8 tokens (prefill
    # chunks of 1, 8 rows), which capacity (at least 8) never cuts
    sc1 = dataclasses.replace(sc, prefill_chunk=1)
    stack = build_stack(sc1, weights=(model, params))
    drops = MoEDrops(torch, moe)
    t0 = time.perf_counter()
    try:
        sched1, _ = replay(sc1, stack)
    finally:
        dropped1 = drops.restore()
    reqs1 = list(sched1.pool.all.values())
    check(dropped1 == 0 and all(r.state == "done" for r in reqs1),
          f"prefill chunks of 1: {dropped1} entries dropped")
    greedy = greedy_margins(torch, stack[0].backend, reqs1, dense=dense)
    print(f"mla (b): the trace in prefill chunks of 1 ({len(sched1.log)} "
          f"steps, {time.perf_counter() - t0:.1f} s; 0 of {drops.entries} "
          f"entries dropped): {greedy['flips']} of {greedy['tokens']} "
          f"greedy tokens are near-ties off the dense forward's argmax "
          f"(margins {[f'{x:.3g}' for x in greedy['margins']]}, at most "
          f"{greedy['worst']:.2f}x the bound)")
    check(greedy["worst"] <= 1.0 and math.isfinite(greedy["worst"]),
          f"a greedy token is off the dense forward's argmax by "
          f"{greedy['worst']:.2f}x the near-tie bound")
    del stack, sched1, reqs1
    # the breakdown: the same trace again, under the profiler; the bf16
    # pool's route: every mla_decode call ran decode_tc, none the CUDA
    # cores' decode
    stack = build_stack(sc, weights=(model, params))
    _lib.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall2 = replay(sc, stack)
    n_mla = _lib.LAUNCHES["mla_decode"]
    n_tc = n_core = 0
    for e in prof.key_averages():
        if "decode_tc" in e.key:
            n_tc += e.count
        elif "mla::decode<" in e.key or "mla6decodeI" in e.key:
            n_core += e.count
    print(f"mla (b): the profiled rerun's {n_mla} mla_decode calls ran "
          f"decode_tc {n_tc} times, the CUDA cores' decode {n_core} times")
    check(n_mla > 0 and n_tc == n_mla and n_core == 0,
          f"mla_decode over the bf16 pool: {n_mla} calls, {n_tc} decode_tc "
          f"launches, {n_core} CUDA-core launches")
    print_breakdown("mla (b) breakdown", prof, wall2, (
        ("mla_decode decode_tc", "decode_tc"),
        ("mla_decode decode", "mla::decode<"),
        ("mla_decode decode", "mla6decodei"),
        ("paged_append", "append_rows"),
        ("moe dispatch, pool gather", "index"),
        ("moe dispatch, pool gather", "sort"),
        ("moe dispatch, pool gather", "scatter"),
        ("moe dispatch, pool gather", "gather"),
        ("moe dispatch, pool gather", "cat"),
        ("elementwise", "elementwise"), ("reduction", "reduce"),
        ("softmax", "softmax")))
    del stack, engine, clock, sched, model, params, dense
    gc_collect(torch)
    print(f"mla (b): phase 15 (b) took {time.perf_counter() - t_phase:.1f} s")
    return {"mla_decode": launches["mla_decode"],
            "paged_append_token_mla": launches["paged_append_token"],
            "paged_append_chunk_mla": launches["paged_append_chunk"]}

# ---------------------------------------------------------------------------
# phase 16: the striped (context-parallel) pools on two ranks
# ---------------------------------------------------------------------------

# the kernels a striped llama3-8b step runs (K1, K3, K5 forward; K2 runs
# with its LSE only) and a striped DeepSeek-V2 step (the one-pool K1 and
# K3; mla_decode with its LSE only)
STRIPED_KERNELS = ("paged_append_token", "paged_append_chunk",
                   "flash_prefill", "paged_attention", "paged_flash_prefill")
STRIPED_MLA_KERNELS = ("paged_append_token", "paged_append_chunk",
                       "mla_decode")
# phase 16 (b)'s llama3-8b depth: its gloo-staged striped prefill steps
# take tens of seconds at 32 layers
STRIPED_LAYERS = 8
# phase 16 (c): the largest difference, in standard deviations of the
# row over the vocab, between a logit of a step on the striped pool and
# of the same step on the head-layout pool (merge 2): bf16 prefill (the
# same shapes in both layouts) and bf16 decode with the MoE FFN made a
# dense MLP, and fp32 prefill and decode. The bf16 decode step through the
# MoE layer is held by its greedy tokens alone: its striped path rounds
# q to bf16 for the wire and merges in bf16, and the router after it
# turns such rounding into another expert now and then
STRIPED_MLA_SD = 0.1
STRIPED_MLA_F32_SD = 1e-3


def striped_engine(model, params, layout: str, *, num_blocks: int,
                   block_base: int, bpe: int, max_blocks: int, chunk: int,
                   clock=None):
    """A ``FlyingEngine`` at ``ParallelPlan(1, 1, 2)`` over a pool of
    ``layout`` bound to merge 2 (one TP2 island: stripe factor 2 when
    striped; every step zero-copy checked; prefill and decode as two
    steps, as the striped pool runs them, whatever the layout), and a
    HARD scheduler pinned at merge 2 over it (through ``clock``, a
    backend proxy class)."""
    from repro_torch.core.engine import FlyingEngine
    from repro_torch.core.kv_adaptor import PoolGeometry
    from repro_torch.core.modes import ParallelPlan
    from repro_torch.core.scheduler import DynamicScheduler, SchedulerConfig
    plan = ParallelPlan(engine_rows=1, tp_base=1, data_rows=2)
    geom = PoolGeometry(model.cfg, plan, num_blocks=num_blocks,
                        block_base=block_base, layout=layout)
    eng = FlyingEngine(model, plan, geom, params, batch_per_engine=bpe,
                       max_blocks_per_req=max_blocks, device=model.device,
                       check_zero_copy=True, mixed_step=False)
    eng.switch(1, 2)
    backend = clock(eng) if clock is not None else eng
    sched = DynamicScheduler(plan, geom, backend, SchedulerConfig(
        strategy="hard", max_batch_per_group=bpe, prefill_chunk=chunk,
        fixed_merge=2))
    return sched, eng


def serve_spec(sc):
    """The workload of a ``serve_config``, as the launcher builds it."""
    from repro_torch.serving.workload import WorkloadSpec
    spec = WorkloadSpec(n_requests=sc.requests, seed=sc.seed,
                        prompt_range=sc.prompt_range,
                        output_range=sc.output_range,
                        priority_frac=sc.priority_frac)
    spec.arrival, spec.rate = sc.arrival, sc.rate
    spec.background_frac, spec.cancel_frac = sc.background_frac, \
        sc.cancel_frac
    return spec


def striped_reduced(torch, device) -> dict:
    """Phase 16 (a): the reduced llama3-8b and deepseek-v2-236b in fp32
    (weights seeded on the CPU) on the striped pool at merge 2, phase 15
    (a)'s six requests (every prompt within one prefill chunk of 32)
    with a fixed clock on ``device``: streams, phase logs and, on the
    card, the launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.task_pool import Request
    from repro_torch.kernels import _lib
    from repro_torch.models.model import build_model
    res = {}
    for arch in ("llama3-8b", MLA_ARCH):
        cfg = get_config(arch).reduced()
        params = build_model(cfg, torch.float32, "cpu").init(
            torch.Generator().manual_seed(0))
        sched, eng = striped_engine(
            build_model(cfg, torch.float32, device), params, "striped",
            num_blocks=64, block_base=4, bpe=2, max_blocks=16, chunk=32,
            clock=FixedClock)
        _lib.reset_launches()
        for r in MOE_TRACE:
            sched.submit(Request(**r))
        sched.run(max_steps=400)
        res[arch] = {
            "toks": {r["req_id"]: eng.generated_tokens(r["req_id"])
                     for r in MOE_TRACE},
            "phases": [l.phase for l in sched.log],
            "merges": sorted({l.merge for l in sched.log}),
            "launches": dict(_lib.LAUNCHES) if device == "cuda" else None,
            "lse": dict(_lib.LSE_LAUNCHES) if device == "cuda" else None}
    return res


def _stripe_of(torch, whole, bt_w, stripe: int, F: int, bt_s, nblk: int):
    """The stripe pool of ``whole`` [nblk_w, page, *w] (rows through
    ``bt_w`` [B, MB_w]): token t of each row, where t % F == stripe, at
    its stripe slot through ``bt_s``."""
    from repro_torch.models.striped import stripe_write_slot
    page = whole.shape[1]
    Bq, mbw = bt_w.shape
    pos = torch.arange(mbw * page, device=whole.device)[None].expand(Bq, -1)
    local = stripe_write_slot(pos, stripe, F, bt_s, page).long()
    src = bt_w.long().gather(1, pos // page) * page + pos % page
    out = torch.zeros((nblk,) + tuple(whole.shape[1:]), dtype=whole.dtype,
                      device=whole.device)
    keep = local >= 0
    out.view(nblk * page, -1)[local[keep]] = \
        whole.reshape(-1, out[0, 0].numel())[src[keep]]
    return out


def striped_kernel_checks(torch, eng) -> dict:
    """Phase 16 (a), kernel checks: K2's LSE partial over this rank's
    stripe (llama3-8b's full heads: H 32, KV 8, hd 128, page 16, bf16
    pools, q rounded to bf16) and ``mla_decode``'s with its LSE
    (DeepSeek-V2: H 128, W 576, R 512), each merged over the two ranks
    by ``TPContext.lse_merge`` in fp32, against one K2 (one
    ``mla_decode``) call over the whole context. Returns the max abs
    errors."""
    from repro_torch.core.views import make_serving_ctx
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.models.striped import stripe_partial, stripe_partial_mla
    ctx = make_serving_ctx(2, 1, 1, group=eng.pool.seat(
        eng.layout.islands[0]).comm)
    s, F = ctx.stripe_index(), ctx.tp
    dev = eng.device
    gen = torch.Generator(device=dev).manual_seed(16)
    Bq, page, mbw = 8, 16, 128
    nblk_w, nblk_s = Bq * mbw + 1, Bq * mbw // 2 + 1
    bt_w = torch.randperm(nblk_w - 1, generator=gen, device=dev)[
        :Bq * mbw].reshape(Bq, mbw).to(torch.int32)
    bt_s = torch.randperm(nblk_s - 1, generator=gen, device=dev)[
        :Bq * mbw // 2].reshape(Bq, mbw // 2).to(torch.int32)
    ctxl = torch.randint(1, mbw * page + 1, (Bq,), generator=gen,
                         device=dev).to(torch.int32)
    ctxl[0] = 1                              # one stripe holds no key
    errs = {}
    # GQA at full heads
    kw, vw = (torch.randn((nblk_w, page, 8, 128), generator=gen,
                          device=dev).to(torch.bfloat16) for _ in range(2))
    q = torch.randn((Bq, 32, 128), generator=gen, device=dev).to(
        torch.bfloat16)
    kp, vp = (_stripe_of(torch, x, bt_w, s, F, bt_s, nblk_s)
              for x in (kw, vw))
    acc, l, m = stripe_partial(q, kp, vp, bt_s, ctxl, s, F)
    merged = ctx.lse_merge(acc, l, m)
    whole = pk.paged_attention_kernel(q.float(), kw, vw, bt_w, ctxl)
    torch.cuda.synchronize()
    errs["paged_attention_lse"] = float((merged - whole).abs().max())
    check(torch.allclose(merged, whole, **F32_TOL),
          f"striped K2 partials merged are off one K2 call by "
          f"{errs['paged_attention_lse']:.3e}")
    del kw, vw, kp, vp
    # MLA at DeepSeek-V2's width
    R, W = 512, 576
    pool_w = torch.randn((nblk_w, page, W), generator=gen,
                         device=dev).to(torch.bfloat16)
    qc = (torch.randn((Bq, 128, W), generator=gen, device=dev)
          * W ** -0.5).to(torch.bfloat16)
    pool_s = _stripe_of(torch, pool_w, bt_w, s, F, bt_s, nblk_s)
    acc, l, m = stripe_partial_mla(qc[..., :R], qc[..., R:], pool_s, bt_s,
                                   ctxl, s, F, R=R)
    merged = ctx.lse_merge(acc, l, m)
    whole = pk.paged_mla_attention_kernel(qc.float(), pool_w, bt_w, ctxl,
                                          R=R)
    torch.cuda.synchronize()
    errs["mla_decode_lse"] = float((merged - whole).abs().max())
    check(torch.allclose(merged, whole, **F32_TOL),
          f"striped mla_decode partials merged are off one mla_decode "
          f"call by {errs['mla_decode_lse']:.3e}")
    return errs


def striped_full_width(torch, weights) -> dict:
    """Phase 16 (b): llama3-8b at full width (cut to STRIPED_LAYERS
    layers by the caller) in bf16 on the striped pool at merge 2 (2048
    blocks of 16 rows a rank, 32 tokens a block), phase 5's 8 requests
    with every prompt in one prefill chunk (2048) and the launches
    counted from zero; the greedy tokens held against the dense one-rank
    forward; then a decode tick of 16 rows, and the same tick on a
    head-layout pool over the same weights."""
    from repro_torch.core.weights_manager import _ptrs
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import replay
    model, params = weights
    sc = serve_config(ranks=2, num_blocks=2048, prefill_chunk=2048)
    sched, eng = striped_engine(model, params, "striped",
                                num_blocks=sc.num_blocks,
                                block_base=sc.block_base,
                                bpe=sc.batch_per_engine,
                                max_blocks=sc.max_blocks_per_req,
                                chunk=sc.prefill_chunk, clock=StepClock)
    clock = sched.backend
    pools = _ptrs(eng._pools)
    _lib.reset_launches()
    coll0 = eng.pool.stats.collectives
    sched, wall = replay(sc, (sched, serve_spec(sc), None))
    launches = {k: _lib.LAUNCHES[k] for k in STRIPED_KERNELS}
    dec = sorted(dt * 1e3 for k, _, dt in clock.log if k == "decode")
    lse = dict(_lib.LSE_LAUNCHES)
    reqs = list(sched.pool.all.values())
    res = {
        "done": sum(r.state == "done" and len(eng.generated_tokens(
            r.req_id)) == r.output_len for r in reqs),
        "n": len(reqs),
        "prompts": sorted(r.prompt_len for r in reqs),
        "tokens": sum(len(eng.generated_tokens(r.req_id)) for r in reqs),
        "in_vocab": all(0 <= x < eng.cfg.vocab_size for r in reqs
                        for x in eng.generated_tokens(r.req_id)),
        "wall_s": wall, "phases": [l.phase for l in sched.log],
        "merges": sorted({l.merge for l in sched.log}),
        "launches": launches, "lse": lse,
        "steps": eng.sync_stats.steps,
        "prefill_ms": [dt * 1e3 for k, _, dt in clock.log
                       if k == "prefill"],
        "prefill_rows": [len(ids) for k, ids, _ in clock.log
                         if k == "prefill"],
        "decode_ms": [dec[len(dec) // 2], dec[0], dec[-1]],
        "collectives": eng.pool.stats.collectives - coll0,
        "host_argmax": eng.sync_stats.host_argmax,
        "greedy": greedy_margins(torch, eng, reqs)}
    res["tick"] = decode_tick_ms(torch, eng, 2, kernels=STRIPED_KERNELS)
    res["pools_unchanged"] = _ptrs(eng._pools) == pools
    res["checks"] = striped_kernel_checks(torch, eng)
    del sched, clock, eng
    gc_collect(torch)
    # the same tick on the head-layout pool, at the same depth
    _, head = striped_engine(model, params, "head",
                             num_blocks=sc.num_blocks,
                             block_base=sc.block_base,
                             bpe=sc.batch_per_engine,
                             max_blocks=sc.max_blocks_per_req,
                             chunk=sc.prefill_chunk)
    res["head_tick"] = decode_tick_ms(torch, head, 2)
    return res


def striped_mla_steps(torch, model, params, comm, B: int = 8,
                      T: int = 1024) -> dict:
    """Phase 16 (c): one prefill of B prompts of T tokens (no padding, so
    no padded position takes MoE capacity) and one decode step, with the
    same seeded tokens, over a striped and over a head-layout pool at
    merge 2 (``build_serve_step`` with full-vocab logits, on the TP2
    group ``comm``). The prefill's block tables cover exactly its T
    tokens, so its attention runs the same shapes in both layouts and the
    caches it writes (layer 0's dense output, compressed) agree; the
    decode step's 8 tokens fit an expert's capacity of 8, so nothing
    drops there. Returns each step's logits distance in row deviations
    and the decode step's greedy agreement."""
    import numpy as np

    from repro_torch.core.kv_adaptor import KVCacheAdaptor, PoolGeometry
    from repro_torch.core.modes import FlyingMode, ParallelPlan
    from repro_torch.core.steps import build_serve_step
    plan = ParallelPlan(engine_rows=1, tp_base=1, data_rows=2)
    mode = FlyingMode(plan, 2)
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(16)
    toks = torch.randint(0, model.cfg.vocab_size, (B, T + 1), generator=gen,
                         device=dev, dtype=torch.int32)
    i32 = dict(dtype=torch.int32, device=dev)
    logits = {}
    for layout in ("striped", "head"):
        geom = PoolGeometry(model.cfg, plan, num_blocks=1024, block_base=16,
                            layout=layout)
        ad = KVCacheAdaptor(geom)
        ad.switch_mode(2)
        mb = T // geom.capacity(2)
        slots = [ad.append_slots(f"r{b}", T) for b in range(B)]
        btab = [ad.block_table(f"r{b}", mb) for b in range(B)]
        dslots = [ad.append_slots(f"r{b}", 1)[0] for b in range(B)]
        btab2 = [ad.block_table(f"r{b}", mb + 1) for b in range(B)]
        states = [tuple({"mixer": tuple(
            torch.zeros((n,) + geom.flat_shape(), dtype=model.dtype,
                        device=dev)
            for _ in range(model.pools_of(kind)))} for kind in ks)
            for ks, n in model.plan]
        prefill, _ = build_serve_step(model, mode, geom, phase="prefill")
        decode, _ = build_serve_step(model, mode, geom, phase="decode")
        lp, states = prefill(params, states, {
            "tokens": toks[:, :T],
            "positions": torch.arange(T, **i32)[None].expand(B, T),
            "slots": torch.as_tensor(np.stack(slots), **i32),
            "block_table": torch.as_tensor(np.stack(btab), **i32),
            "prior_len": torch.zeros((B,), **i32)}, comm)
        ld, states = decode(params, states, {
            "tokens": toks[:, T:],
            "positions": torch.full((B, 1), T, **i32),
            "slots": torch.as_tensor(np.asarray(dslots), **i32),
            "block_table": torch.as_tensor(np.stack(btab2), **i32),
            "context_len": torch.full((B,), T + 1, **i32)}, comm)
        logits[layout] = (lp.float(), ld.float())
        del states
    res = {}
    for i, step in enumerate(("prefill", "decode")):
        a, b = logits["striped"][i], logits["head"][i]
        sd = b.std(-1)
        res[f"{step}_sd"] = float(((a - b).abs() / sd[:, None]).max())
        res[f"{step}_max_abs"] = float((a - b).abs().max())
        res[f"{step}_flips"] = int((a.argmax(-1) != b.argmax(-1)).sum())
        margin = b.max(-1).values - b.gather(1, a.argmax(-1)[:, None])[:, 0]
        res[f"{step}_worst"] = float((margin / (NEAR_TIE_SD * sd)).max())
        res[f"{step}_finite"] = bool(torch.isfinite(a).all())
    res["logit_sd"] = float(logits["head"][1].std(-1).mean())
    res["rows"], res["T"] = B, T
    return res


def striped_mla(torch) -> dict:
    """Phase 16 (c): deepseek-v2-236b at full width, 2 of its 60 layers
    (the dense MLA+MLP layer and one MLA+MoE layer), bf16, seed-0
    weights, on the striped pool at merge 2: 8 requests of 256-1024
    prompt tokens and 32 out in prefill chunks of 1024 through the
    scheduler (every request done, every sampled row finite, the pools
    in place, the launches counted from zero), then
    ``striped_mla_steps`` against the head-layout pool: in bf16, in bf16
    with the MoE FFN made a dense MLP, and over fp32 weights (4
    prompts)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import steps as steps_mod
    from repro_torch.core.weights_manager import _ptrs
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import replay
    from repro_torch.models.model import build_model
    from repro_torch.training.checkpoint import tree_leaves
    cfg = dataclasses.replace(get_config(MLA_ARCH), num_layers=2)
    model = build_model(cfg, torch.bfloat16, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    sc = serve_config(arch=MLA_ARCH, ranks=2, prompt_range=(256, 1024),
                      output_range=(32, 32), prefill_chunk=1024)
    sched, eng = striped_engine(model, params, "striped",
                                num_blocks=sc.num_blocks,
                                block_base=sc.block_base,
                                bpe=sc.batch_per_engine,
                                max_blocks=sc.max_blocks_per_req,
                                chunk=sc.prefill_chunk, clock=StepClock)
    clock = sched.backend
    pools = _ptrs(eng._pools)
    finite = FiniteLogits(torch, steps_mod)
    _lib.reset_launches()
    try:
        sched, wall = replay(sc, (sched, serve_spec(sc), None))
    finally:
        ok = finite.restore()
    reqs = list(sched.pool.all.values())
    L = cfg.num_layers
    n_dec = sum(k == "decode" for k, _, _ in clock.log)
    n_pre = sum(k == "prefill" for k, _, _ in clock.log)
    res = {"done": sum(r.state == "done" and len(eng.generated_tokens(
               r.req_id)) == r.output_len for r in reqs),
           "n": len(reqs), "finite": ok, "wall_s": wall,
           "tokens": sum(len(eng.generated_tokens(r.req_id))
                         for r in reqs),
           "launches": {k: _lib.LAUNCHES[k] for k in STRIPED_MLA_KERNELS},
           "lse": dict(_lib.LSE_LAUNCHES),
           "want": {"mla_decode": L * n_dec, "paged_append_token": L * n_dec,
                    "paged_append_chunk": L * n_pre},
           "pools_unchanged": _ptrs(eng._pools) == pools,
           "params": sum(t.numel() for t in tree_leaves(params)),
           "blocks_1024": -(-1024 // eng.geom.capacity(2)),
           "capacity": eng.geom.capacity(2)}
    from repro_torch.core.kv_adaptor import PoolGeometry
    head = PoolGeometry(cfg, eng.plan, num_blocks=16, block_base=16)
    res["head_blocks_1024"] = -(-1024 // head.capacity(2))
    res["head_capacity"] = head.capacity(2)
    comm = eng.pool.seat(eng.layout.islands[0]).comm
    res["steps"] = striped_mla_steps(torch, model, params, comm)
    del sched, eng, clock, model, params
    gc_collect(torch)
    # the same steps in bf16 with the MoE layer's FFN a dense MLP (the
    # first layer's): no router to amplify the layouts' rounding
    model = build_model(dataclasses.replace(cfg, moe=None),
                        torch.bfloat16, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    res["steps_dense"] = striped_mla_steps(torch, model, params, comm)
    del model, params
    gc_collect(torch)
    # the same steps in fp32 (4 prompts; 21.4 GB of weights a rank)
    model = build_model(cfg, torch.float32, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    res["steps_f32"] = striped_mla_steps(torch, model, params, comm, B=4)
    del model, params
    gc_collect(torch)
    return res


def striped_rank(rank: int, world: int, out: str) -> None:
    """One rank of phase 16: (a) the reduced llama3-8b and
    deepseek-v2-236b on the striped pool on the card and on the CPU, (b)
    llama3-8b at full width cut to STRIPED_LAYERS layers on it (and the
    kernel checks of (a)), (c) deepseek-v2-236b cut to 2 layers on it and
    on the head-layout pool. Writes ``{out}.{rank}.json``."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    t0 = time.perf_counter()
    res = {"a": {dev: striped_reduced(torch, dev)
                 for dev in ("cuda", "cpu")}}
    res["a_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    model = build_model(dataclasses.replace(
        get_config("llama3-8b"), num_layers=STRIPED_LAYERS),
        torch.bfloat16, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res["b"] = striped_full_width(torch, (model, params))
    res["b_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["b_s"] = time.perf_counter() - t1
    del model, params
    gc_collect(torch)
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    res["c"] = striped_mla(torch)
    res["c_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["c_s"] = time.perf_counter() - t1
    res["rank_s"] = time.perf_counter() - t0
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(res, f)


def serve_striped(torch, smi: str) -> dict:
    """Phase 16: spawn two rank processes on the one card (gloo), run
    ``striped_rank`` in each, check and print what they found. Returns
    the LSE launches of K2 (from (b)) and of mla_decode (from (c)) for
    the kernels' JSON record."""
    import tempfile

    from repro_torch.launch.ranks import spawn
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        out = str(Path(d) / "striped")
        spawn(striped_rank, 2, (out,), device_type="cuda", timeout=900)
        runs = []
        for r in range(2):
            with open(f"{out}.{r}.json") as f:
                runs.append(json.load(f))
    print("striped: two ranks share this card over gloo at ParallelPlan(1, "
          "1, 2), merge 2 (one TP2 island, stripe factor 2), host-staged: "
          "no number here measures TP on two cards")
    # (a)
    for r, res in enumerate(runs):
        for arch, card in res["a"]["cuda"].items():
            cpu = res["a"]["cpu"][arch]
            check(card["toks"] == cpu["toks"] and
                  card["phases"] == cpu["phases"],
                  f"rank {r}: striped {arch} card streams {card['toks']} != "
                  f"CPU {cpu['toks']}")
            check(card["toks"] == runs[0]["a"]["cuda"][arch]["toks"],
                  f"rank {r}: striped {arch} streams differ from rank 0's")
            check(all(len(card["toks"][t["req_id"]]) == t["output_len"]
                      for t in MOE_TRACE) and card["merges"] == [2]
                  and "mixed" not in card["phases"],
                  f"rank {r}: striped {arch}: {card}")
            need = ("paged_append_token", "paged_append_chunk",
                    "mla_decode") if arch == MLA_ARCH else (
                "paged_append_token", "paged_append_chunk", "flash_prefill",
                "paged_attention")
            for k in need:
                check(card["launches"][k] > 0,
                      f"rank {r}: striped {arch}: {k} never launched")
            lse_k = "mla_decode" if arch == MLA_ARCH else "paged_attention"
            check(card["lse"][lse_k] == card["launches"][lse_k],
                  f"rank {r}: striped {arch}: {lse_k} ran without its LSE")
    for arch, card in runs[0]["a"]["cuda"].items():
        print(f"striped (a): reduced {arch} fp32, six requests at merge 2: "
              f"card streams and phases equal the CPU ranks' on both ranks "
              f"(phases {card['phases']}); card launches "
              f"{ {k: v for k, v in card['launches'].items() if v} }, with "
              f"the LSE {card['lse']}")
    errs = {k: max(res["b"]["checks"][k] for res in runs)
            for k in runs[0]["b"]["checks"]}
    print(f"striped (a): stripe partials merged by lse_merge over the two "
          f"ranks against one whole-context call: K2 with its LSE "
          f"max_abs_err {errs['paged_attention_lse']:.3e}, mla_decode with "
          f"its LSE {errs['mla_decode_lse']:.3e}")
    # (b)
    b = runs[0]["b"]
    for r, res in enumerate(runs):
        x = res["b"]
        check(x["done"] == x["n"] == 8 and x["in_vocab"]
              and x["host_argmax"] == 0 and x["pools_unchanged"]
              and x["merges"] == [2],
              f"rank {r}: striped llama3-8b {x['done']}/{x['n']} done, "
              f"pools unchanged {x['pools_unchanged']}")
        check(x["phases"] == b["phases"],
              f"rank {r} scheduled another striped trace than rank 0")
        for k in ("paged_append_token", "paged_append_chunk",
                  "flash_prefill", "paged_attention"):
            check(x["launches"][k] > 0,
                  f"rank {r}: striped llama3-8b: {k} never launched")
        check(x["lse"]["paged_attention"] == x["launches"][
            "paged_attention"] and x["launches"]["paged_flash_prefill"] == 0,
              f"rank {r}: striped llama3-8b launches {x['launches']}, LSE "
              f"{x['lse']}")
        for what, g in (("trace", x["greedy"]),
                        ("tick", x["tick"]["greedy"])):
            check(g["tokens"] > 0 and g["worst"] <= 1.0,
                  f"rank {r}: a striped {what} greedy token is off the dense "
                  f"one-rank forward's argmax by {g['worst']:.2f}x the "
                  f"near-tie bound (margins {g['margins']})")
    tick, head_tick = b["tick"], b["head_tick"]
    print(f"striped (b): llama3-8b bf16, {STRIPED_LAYERS} of 32 layers, "
          f"phase 5's 8 requests "
          f"(prompts {b['prompts']}) at merge 2 on the striped pool, each "
          f"prompt in one chunk of 2048: {b['done']}/8 done, {b['tokens']} "
          f"tokens in {b['wall_s']:.3f} s ({b['phases'].count('prefill')} "
          f"prefill, {b['phases'].count('decode')} decode steps); pool "
          f"data_ptrs unchanged on both ranks; launches a rank "
          f"{[res['b']['launches'] for res in runs]}, K2 with its LSE "
          f"{[res['b']['lse']['paged_attention'] for res in runs]}; "
          f"{b['collectives'] / max(b['steps'], 1):.1f} TP collectives a "
          f"step on rank 0; prefill steps "
          f"{[round(x, 1) for x in b['prefill_ms']]} ms (rows "
          f"{b['prefill_rows']}), decode steps median "
          f"{b['decode_ms'][0]:.1f} ms (min {b['decode_ms'][1]:.1f}, max "
          f"{b['decode_ms'][2]:.1f}); greedy tokens against a dense one-rank "
          f"forward: "
          f"{b['greedy']['flips']} of {b['greedy']['tokens']} near-ties off "
          f"its argmax (margins {[f'{m:.3g}' for m in b['greedy']['margins']]}"
          f", at most {b['greedy']['worst']:.2f}x the bound)")
    print(f"striped (b): {smi}; decode tick of 16 rows (prompts of 512) on "
          f"the striped pool at merge 2: {tick['ms']:.2f} ms (the slower "
          f"rank's, {STRIPED_LAYERS} layers) beside the same tick on a "
          f"head-layout pool over the same weights {head_tick['ms']:.2f} "
          f"ms; {tick['collectives'] / tick['steps']:.1f} TP collectives a "
          f"step (head layout: "
          f"{head_tick['collectives'] / head_tick['steps']:.1f})"
          f"; launches {[res['b']['tick']['launches'] for res in runs]}; "
          f"greedy {tick['greedy']['flips']} of {tick['greedy']['tokens']} "
          f"near-ties (at most {tick['greedy']['worst']:.2f}x the bound); "
          f"peak memory a rank "
          f"{[round(res['b_peak_gib'], 2) for res in runs]} GiB (both ranks "
          f"on this card)")
    # (c)
    c = runs[0]["c"]
    for r, res in enumerate(runs):
        x, st = res["c"], res["c"]["steps"]
        check(x["done"] == x["n"] == 8 and x["finite"]
              and x["pools_unchanged"],
              f"rank {r}: striped deepseek-v2 {x['done']}/{x['n']} done, "
              f"finite {x['finite']}, pools unchanged "
              f"{x['pools_unchanged']}")
        check(st == c["steps"] and x["steps_f32"] == c["steps_f32"]
              and x["steps_dense"] == c["steps_dense"],
              f"rank {r}: the layouts' steps read other logits than rank "
              f"0's")
        for k, n in x["want"].items():
            check(x["launches"][k] == n > 0,
                  f"rank {r}: striped deepseek-v2: {k} launched "
                  f"{x['launches'][k]} times, not {n}")
        check(x["lse"]["mla_decode"] == x["launches"]["mla_decode"],
              f"rank {r}: striped mla_decode ran without its LSE")
        for what, y, step, bound_sd in (
                ("bf16", st, "prefill", STRIPED_MLA_SD),
                ("bf16", st, "decode", float("inf")),
                ("bf16 dense", x["steps_dense"], "prefill", STRIPED_MLA_SD),
                ("bf16 dense", x["steps_dense"], "decode", STRIPED_MLA_SD),
                ("fp32", x["steps_f32"], "prefill", STRIPED_MLA_F32_SD),
                ("fp32", x["steps_f32"], "decode", STRIPED_MLA_F32_SD)):
            check(y[f"{step}_finite"] and y[f"{step}_sd"] <= bound_sd
                  and y[f"{step}_worst"] <= 1.0,
                  f"rank {r}: the {what} {step} step's logits on the "
                  f"striped and the head-layout pool differ by "
                  f"{y[f'{step}_sd']:.3g} row deviations (bound {bound_sd}"
                  f"), greedy {y[f'{step}_flips']} flips at "
                  f"{y[f'{step}_worst']:.2f}x the near-tie bound")
    st = c["steps"]
    print(f"striped (c): deepseek-v2-236b bf16, 2 of 60 layers "
          f"({c['params'] / 1e9:.3f} B parameters a rank), 8 requests "
          f"at merge 2 on the striped pool: {c['done']}/8 done, "
          f"{c['tokens']} tokens in {c['wall_s']:.3f} s, every sampled row "
          f"finite, pool data_ptrs unchanged; launches {c['launches']} (= 2 "
          f"layers x the steps that run them), mla_decode with its LSE "
          f"{c['lse']['mla_decode']}; a 1024-token request takes "
          f"{c['blocks_1024']} blocks a rank (capacity {c['capacity']} "
          f"tokens a block) against {c['head_blocks_1024']} on the "
          f"head-layout pool (capacity {c['head_capacity']}: MLA's cache "
          f"is replicated there)")
    for what, y, bound_sd in (
            ("bf16", st, f"{STRIPED_MLA_SD}, prefill"),
            ("bf16, both FFNs dense MLPs", c["steps_dense"],
             STRIPED_MLA_SD),
            ("fp32", c["steps_f32"], STRIPED_MLA_F32_SD)):
        print(f"striped (c): {what}, {y['rows']} prompts of {y['T']} tokens, "
              f"one prefill and one decode step on the striped and on the "
              f"head-layout pool at merge 2: prefill logits "
              f"{y['prefill_sd']:.4g} row deviations apart (max |diff| "
              f"{y['prefill_max_abs']:.4g}, {y['prefill_flips']} greedy "
              f"flips), the decode step's {y['decode_sd']:.4g} (bound "
              f"{bound_sd}; max |diff| {y['decode_max_abs']:.4g} against a "
              f"mean row deviation {y['logit_sd']:.4g}), {y['decode_flips']} "
              f"of {y['rows']} greedy tokens differ (at most "
              f"{y['decode_worst']:.2f}x the near-tie bound)")
    print(f"striped (c): peak memory a rank "
          f"{[round(res['c_peak_gib'], 2) for res in runs]} GiB")
    print(f"striped: {smi}; (a) {max(res['a_s'] for res in runs):.1f} s, (b) "
          f"{max(res['b_s'] for res in runs):.1f} s, (c) "
          f"{max(res['c_s'] for res in runs):.1f} s; phase 16 took "
          f"{time.perf_counter() - t0:.1f} s")
    return {"paged_attention_lse": b["lse"]["paged_attention"],
            "mla_decode_lse": c["lse"]["mla_decode"]}


# ---------------------------------------------------------------------------
# phase 17: whisper-base's encoder and cross caches and internvl2-1b's
# patch prefix, at step level and in training
# ---------------------------------------------------------------------------

FRONTEND_ARCHS = ("whisper-base", "internvl2-1b")


def frontend_steps(torch, np, model, params, prompts, decodes: int, *, fe,
                   enc_len=None, num_blocks: int = 1024, block_base: int = 16,
                   timed: bool = False) -> dict:
    """Serves ``prompts`` (token id lists) with their stub embeddings
    ``fe`` at ``ParallelPlan(1, 1, 1)`` through ``build_serve_step`` over
    a ``KVCacheAdaptor`` pool: one prefill step over every prompt (after
    internvl2-1b's patches; padded to the longest, the pads' slots
    parked, ``last_pos`` at each row's last real position; whisper's
    ``enc_len`` masking frames), then ``decodes`` decode steps, each row
    fed its own greedy token (whisper's cross K/V read from the states
    the prefill wrote). Returns the greedy tokens [B][decodes + 1], each
    step's full-vocab logits (on the CPU) and, ``timed``, each step's
    wall ms (the card synchronised around it)."""
    from repro_torch.core.kv_adaptor import KVCacheAdaptor, PoolGeometry
    from repro_torch.core.modes import FlyingMode, ParallelPlan
    from repro_torch.core.steps import build_serve_step, fresh_states
    cfg, dev = model.cfg, model.device
    plan = ParallelPlan(engine_rows=1, tp_base=1, data_rows=1)
    mode = FlyingMode(plan, 1)
    geom = PoolGeometry(cfg, plan, num_blocks=num_blocks,
                        block_base=block_base)
    ad = KVCacheAdaptor(geom)
    ad.switch_mode(1)
    B = len(prompts)
    prefix = cfg.frontend.num_embeds if cfg.enc_dec is None else 0
    frames = cfg.frontend.num_embeds if cfg.enc_dec is not None else 0
    lens = np.array([prefix + len(p) for p in prompts])
    T = int(lens.max())
    mb = -(-(T + decodes) // geom.capacity(1))
    slots = np.full((B, T), -1, np.int64)
    toks = np.zeros((B, T - prefix), np.int64)
    for b, p in enumerate(prompts):
        slots[b, :lens[b]] = ad.append_slots(f"r{b}", int(lens[b]))
        toks[b, :len(p)] = p
    i32 = dict(dtype=torch.int32, device=dev)

    def tables():
        return torch.as_tensor(np.stack([ad.block_table(f"r{b}", mb)
                                         for b in range(B)]), **i32)
    states = fresh_states(model, mode, geom, batch=B, enc_frames=frames)
    prefill, _ = build_serve_step(model, mode, geom, phase="prefill")
    decode, _ = build_serve_step(model, mode, geom, phase="decode")
    extra = {} if enc_len is None else {
        "enc_len": torch.as_tensor(enc_len, **i32)}
    res = {"tokens": [], "logits": [], "ms": []}

    def run(step, batch):
        if timed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        logits, _ = step(params, states, batch)
        if timed:
            torch.cuda.synchronize()
            res["ms"].append((time.perf_counter() - t0) * 1e3)
        tok = logits.argmax(-1)
        res["tokens"].append(tok)
        res["logits"].append(logits.float().cpu())
        return tok
    tok = run(prefill, {
        "tokens": torch.as_tensor(toks, **i32),
        "positions": torch.arange(T, **i32)[None].expand(B, T),
        "slots": torch.as_tensor(slots, **i32), "block_table": tables(),
        "prior_len": torch.zeros((B,), **i32),
        "last_pos": torch.as_tensor(lens - 1, **i32), "frontend_embeds": fe,
        **extra})
    for i in range(decodes):
        pos = lens + i
        dslots = [ad.append_slots(f"r{b}", 1)[0] for b in range(B)]
        tok = run(decode, {
            "tokens": tok[:, None].to(torch.int32),
            "positions": torch.as_tensor(pos[:, None], **i32),
            "slots": torch.as_tensor(np.asarray(dslots), **i32),
            "block_table": tables(),
            "context_len": torch.as_tensor(pos + 1, **i32), **extra})
    res["tokens"] = torch.stack(res["tokens"], 1).cpu().tolist()
    return res


def frontend_inputs(torch, np, cfg, B: int, lo: int, hi: int, seed: int,
                    dtype, device):
    """B prompts of lo..hi tokens, the stub embeddings (``launch.train``'s
    draw) and, for whisper, an ``enc_len`` below the frame count in every
    other row, all from ``seed``."""
    from repro_torch.launch.train import frontend_embeds
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(lo, hi + 1, B)]
    fe = frontend_embeds(cfg, B, seed, dtype, device)
    enc_len = None
    if cfg.enc_dec is not None:
        F = cfg.frontend.num_embeds
        enc_len = np.where(np.arange(B) % 2 == 1,
                           rng.integers(F // 4, F, B), F).astype(np.int32)
    return prompts, fe, enc_len


def frontends_reduced(torch, np) -> None:
    """Phase 17 (a): the reduced whisper-base and internvl2-1b in fp32,
    the same weights (seed 0, drawn on the CPU) and stub embeddings, one
    prefill step of 4 ragged prompts and 8 decode steps on the card and
    on the CPU: greedy tokens equal, every step's logits within rtol =
    atol = 1e-4, K1-K4 launched on the card."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.models.model import build_model
    from repro_torch.training.checkpoint import tree_map
    for arch in FRONTEND_ARCHS:
        cfg = get_config(arch).reduced()
        params = build_model(cfg, torch.float32, "cpu").init(
            torch.Generator().manual_seed(0))
        runs = {}
        for dev in ("cuda", "cpu"):
            model = build_model(cfg, torch.float32, dev)
            prompts, fe, enc_len = frontend_inputs(
                torch, np, cfg, 4, 8, 24, 5, torch.float32, dev)
            _lib.reset_launches()
            runs[dev] = frontend_steps(
                torch, np, model, tree_map(lambda t: t.to(dev), params),
                prompts, 8, fe=fe, enc_len=enc_len, num_blocks=64,
                block_base=4)
            runs[dev]["launches"] = {k: _lib.LAUNCHES[k]
                                     for k in SERVE_KERNELS}
        card, cpu = runs["cuda"], runs["cpu"]
        err = max(float((a - b).abs().max())
                  for a, b in zip(card["logits"], cpu["logits"]))
        print(f"frontends (a): reduced {arch} fp32, prompts "
              f"{[len(p) for p in prompts]}"
              f"{'' if enc_len is None else f', enc_len {enc_len.tolist()}'}"
              f", one prefill and 8 decode steps: card tokens "
              f"{card['tokens']}, max |logits card - CPU| {err:.3e}, card "
              f"launches {card['launches']}")
        check(card["tokens"] == cpu["tokens"],
              f"reduced {arch}: card tokens {card['tokens']} != CPU "
              f"{cpu['tokens']}")
        check(all(torch.allclose(a, b, rtol=1e-4, atol=1e-4)
                  for a, b in zip(card["logits"], cpu["logits"])),
              f"reduced {arch}: card and CPU logits differ by {err:.3e}")
        for k in SERVE_KERNELS:
            check(card["launches"][k] > 0 and cpu["launches"][k] == 0,
                  f"reduced {arch}: {k} launched {card['launches'][k]} "
                  f"times on the card, {cpu['launches'][k]} on the CPU")


def frontend_greedy(torch, model, params, prompts, fe, enc_len,
                    tokens) -> dict:
    """Holds each row's served greedy tokens against one dense train-mode
    forward of the row on the card (K5, no pool; the encoder or the
    patch prefix as served), fed the prompt and the served tokens: the
    dense argmax, or a near-tie within NEAR_TIE_SD of the row's
    deviation (``greedy_margins``' rule)."""
    from repro_torch.core.views import SINGLE
    from repro_torch.models.cache import TrainBackend
    cfg, dev = model.cfg, model.device
    prefix = cfg.frontend.num_embeds if cfg.enc_dec is None else 0
    acc = {"tokens": 0, "flips": 0, "worst": 0.0, "margins": []}
    for b, p in enumerate(prompts):
        seq = torch.as_tensor(p + tokens[b][:-1], device=dev)[None]
        kw = {} if enc_len is None else {
            "enc_len": torch.as_tensor(enc_len[b:b + 1], device=dev)}
        with torch.no_grad():
            logits, _, _ = model.forward(
                params, SINGLE, mode="train", backend=TrainBackend(),
                tokens=seq, frontend_embeds=fe[b:b + 1], **kw)
        tally_near_ties(acc, logits[0, prefix + len(p) - 1:].float(),
                        torch.as_tensor(tokens[b], device=dev))
        del logits
    return acc


def frontends_full_width(torch, np, smi: str) -> dict:
    """Phase 17 (b): whisper-base (6 + 6 layers, 1500 frames, vocab 51865)
    and internvl2-1b (24 layers, 256 patches of width 1024, vocab 151655)
    at full width and depth in bf16, seeded random weights: 8 requests
    (whisper: prompts of 32-256 tokens, every other row's ``enc_len``
    below 1500; internvl2-1b: 256-1024 text tokens after the patches),
    one prefill step and 32 decode steps (after an untimed warm-up run
    of one of each), the launch counts reset just before the timed run;
    every greedy token held against the dense forward. Returns the
    timed run's launches by arch."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.models.model import build_model
    from repro_torch.training.checkpoint import tree_leaves
    out = {}
    for arch, lo, hi in (("whisper-base", 32, 256),
                         ("internvl2-1b", 256, 1024)):
        cfg = get_config(arch)
        model = build_model(cfg, torch.bfloat16, "cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        prompts, fe, enc_len = frontend_inputs(
            torch, np, cfg, 8, lo, hi, 17, torch.bfloat16, "cuda")
        frontend_steps(torch, np, model, params, prompts, 1, fe=fe,
                       enc_len=enc_len)
        gc_collect(torch)
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        res = frontend_steps(torch, np, model, params, prompts, 32, fe=fe,
                             enc_len=enc_len, timed=True)
        launches = {k: _lib.LAUNCHES[k] for k in SERVE_KERNELS}
        peak = torch.cuda.max_memory_allocated() / 2**30
        L = cfg.num_layers
        want = {"paged_append_chunk": L, "paged_flash_prefill": L,
                "paged_append_token": 32 * L, "paged_attention": 32 * L}
        check(launches == want, f"{arch}: launches {launches}, not {want}")
        vocab = cfg.vocab_size
        check(all(0 <= x < vocab for row in res["tokens"] for x in row),
              f"{arch}: a token outside the vocab")
        g = frontend_greedy(torch, model, params, prompts, fe, enc_len,
                            res["tokens"])
        dec = sorted(res["ms"][1:])
        n_params = sum(t.numel() for t in tree_leaves(params))
        prefix = cfg.frontend.num_embeds if cfg.enc_dec is None else 0
        print(f"frontends (b): {arch} bf16 at full width and depth "
              f"({n_params / 1e9:.3f} B parameters), 8 requests, prompts "
              f"{sorted(len(p) for p in prompts)}"
              f"{f' after {prefix} patches' if prefix else ''}"
              f"{'' if enc_len is None else f', enc_len {enc_len.tolist()}'}"
              f": prefill step {res['ms'][0]:.2f} ms, decode steps median "
              f"{dec[len(dec) // 2]:.2f} ms (min {dec[0]:.2f}, max "
              f"{dec[-1]:.2f}) = {8 / dec[len(dec) // 2] * 1e3:.1f} tok/s, "
              f"peak {peak:.2f} GiB; launches {launches}; greedy tokens "
              f"against the dense forward: {g['flips']} of {g['tokens']} "
              f"near-ties off its argmax (margins "
              f"{[f'{m:.3g}' for m in g['margins']]}, at most "
              f"{g['worst']:.2f}x the bound); {smi}")
        check(g["worst"] <= 1.0,
              f"{arch}: a served greedy token is off the dense forward's "
              f"argmax by {g['worst']:.2f}x the near-tie bound")
        out[arch] = launches
        del model, params, fe, res
        gc_collect(torch)
    return out


def train_frontend(torch, arch: str, batch: int, seq: int) -> dict:
    """Phase 17 (c): ``arch`` at full width and depth in bf16 (fp32 AdamW
    moments), ``batch`` x ``seq`` text tokens with the launcher's stub
    embeddings, 20 steps through ``launch.train.train``, the launch
    counts reset just before and read just after: finite losses, the
    last below the first, K5 launched twice a decoder layer a step
    forward (remat) and once backward (the encoder's attention is plain
    torch)."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.launch.train import train
    cfg = get_config(arch)
    steps = 20
    gc_collect(torch)
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    res = train(cfg, steps=steps, batch=batch, seq=seq, device="cuda",
                dtype=torch.bfloat16, log_every=5,
                log=lambda s: print(f"frontends (c): {arch} {s}"))
    launches = {k: _lib.LAUNCHES[k] for k in TRAIN_KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2**30
    del res.params
    steady = sorted(res.step_s[1:])
    med = steady[len(steady) // 2]
    L = cfg.num_layers
    extra = (f" after {cfg.frontend.num_embeds} patches"
             if cfg.enc_dec is None else
             f", {cfg.frontend.num_embeds} encoder frames")
    print(f"frontends (c): {arch} bf16 at full width and depth, batch "
          f"{batch} x {seq} text tokens{extra}, {steps} steps: losses "
          + " ".join(f"{x:.4f}" for x in res.losses))
    print(f"frontends (c): {arch} step time median {med * 1e3:.1f} ms over "
          f"steps 2-{steps} (min {steady[0] * 1e3:.1f}, max "
          f"{steady[-1] * 1e3:.1f}; first {res.step_s[0] * 1e3:.1f} ms) = "
          f"{res.tokens_per_step / med:.1f} text tok/s; peak {peak:.2f} "
          f"GiB; launches {launches}")
    check(all(math.isfinite(x) for x in res.losses),
          f"{arch}: a loss is not finite")
    check(res.losses[-1] < res.losses[0],
          f"{arch}: loss did not decrease: {res.losses[0]} -> "
          f"{res.losses[-1]}")
    want = {"flash_prefill": 2 * L * steps, "flash_prefill_bwd": L * steps}
    check(launches == want, f"{arch}: K5 launches {launches}, not {want}")
    gc_collect(torch)
    return launches


def serve_frontends(torch, np, smi: str) -> None:
    """Phase 17: (a) the reduced configs card == CPU at step level, (b)
    both models at full width served at step level, (c) training: the
    reduced configs' card-against-CPU losses (fp32, then bf16), then 20
    full-width bf16 steps each."""
    t0 = time.perf_counter()
    frontends_reduced(torch, np)
    t1 = time.perf_counter()
    frontends_full_width(torch, np, smi)
    t2 = time.perf_counter()
    for arch in FRONTEND_ARCHS:
        train_reference_check(torch, np, arch, bf16=True)
    train_frontend(torch, "whisper-base", 8, 448)
    train_frontend(torch, "internvl2-1b", 4, 2048)
    print(f"frontends: {smi}; (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, "
          f"(c) {time.perf_counter() - t2:.1f} s; phase 17 took "
          f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 18: Mamba-2 and RecurrentGemma at step level, from carried states
# ---------------------------------------------------------------------------

RECURRENT_ARCHS = ("mamba2-2.7b", "recurrentgemma-9b")
# K6 and K7 from a carried state, and K1-K4 (recurrentgemma-9b's local
# attention at hd 256)
RECURRENT_KERNELS = ("ssd_scan_from", "rglru_scan_from") + SERVE_KERNELS


def recurrent_config(arch: str, reduced: bool):
    """The config phase 18 serves: the reduced recurrentgemma-9b cut to 3
    layers (two RG-LRU, one local attention with its window of 64), the
    reduced mamba2-2.7b as it is, or either at full width and depth."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if not reduced:
        return cfg
    cfg = cfg.reduced()
    return dataclasses.replace(cfg, num_layers=3) if cfg.hybrid else cfg


# phase 18 sets these recurrent leaves in its seeded weights: at the
# init's dt_bias 0 and Lambda 0.7 a Mamba-2 state decays by e^-0.7 or
# more a token and an RG-LRU state by e^-7.7, so a state dropped between
# two prefill chunks would not show in the chunk's logits; dt_bias -8 and
# Lambda -8 carry a state over hundreds of tokens
SLOW_DECAY = {"dt_bias": -8.0, "lam": -8.0}


def slow_decay(tree) -> None:
    """Sets every ``SLOW_DECAY`` leaf of the parameter tree in place."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k in SLOW_DECAY:
                v.fill_(SLOW_DECAY[k])
            else:
                slow_decay(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            slow_decay(v)


def recurrent_steps(torch, np, model, params, prompts, chunk: int,
                    decodes: int, *, num_blocks: int, block_base: int = 16,
                    timed: bool = False) -> dict:
    """Serves ``prompts`` [B, P] (every prompt of one length, as the step
    level requires of a recurrent model) at ``ParallelPlan(1, 1, 1)``
    through ``build_serve_step``: prefill chunks of ``chunk`` tokens, each
    after the first from the recurrent rows and the prior pages the last
    one left, then ``decodes`` decode steps, each row fed its own greedy
    token. Returns the greedy tokens [B][decodes + 1] (the last chunk's,
    then each decode step's), each step's logits on the CPU and, when
    ``timed``, each step's wall ms (the card synchronised around it)."""
    from repro_torch.core.kv_adaptor import KVCacheAdaptor, PoolGeometry
    from repro_torch.core.modes import FlyingMode, ParallelPlan
    from repro_torch.core.steps import build_serve_step, fresh_states
    cfg, dev = model.cfg, model.device
    plan = ParallelPlan(engine_rows=1, tp_base=1, data_rows=1)
    mode = FlyingMode(plan, 1)
    geom = PoolGeometry(cfg, plan, num_blocks=num_blocks,
                        block_base=block_base)
    ad = KVCacheAdaptor(geom)
    ad.switch_mode(1)
    B, P = prompts.shape
    mb = -(-(P + decodes) // geom.capacity(1))
    i32 = dict(dtype=torch.int32, device=dev)

    def tables():
        return torch.as_tensor(np.stack([ad.block_table(f"r{b}", mb)
                                         for b in range(B)]), **i32)
    states = fresh_states(model, mode, geom, batch=B)
    prefill, _ = build_serve_step(model, mode, geom, phase="prefill")
    decode, _ = build_serve_step(model, mode, geom, phase="decode")
    res = {"tokens": [], "logits": [], "ms": [], "prefills": 0}

    def run(step, batch):
        if timed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        logits, _ = step(params, states, batch)
        if timed:
            torch.cuda.synchronize()
            res["ms"].append((time.perf_counter() - t0) * 1e3)
        res["logits"].append(logits.float().cpu())
        return logits.argmax(-1)
    for pos in range(0, P, chunk):
        T = min(chunk, P - pos)
        slots = np.stack([ad.append_slots(f"r{b}", T) for b in range(B)])
        tok = run(prefill, {
            "tokens": torch.as_tensor(prompts[:, pos:pos + T], **i32),
            "positions": torch.arange(pos, pos + T, **i32)[None].expand(B, T),
            "slots": torch.as_tensor(slots, **i32), "block_table": tables(),
            "prior_len": torch.full((B,), pos, **i32)})
        res["prefills"] += 1
    res["tokens"].append(tok)
    for i in range(decodes):
        dslots = [ad.append_slots(f"r{b}", 1)[0] for b in range(B)]
        tok = run(decode, {
            "tokens": tok[:, None].to(torch.int32),
            "positions": torch.full((B, 1), P + i, **i32),
            "slots": torch.as_tensor(np.asarray(dslots), **i32),
            "block_table": tables(),
            "context_len": torch.full((B,), P + i + 1, **i32)})
        res["tokens"].append(tok)
    res["tokens"] = torch.stack(res["tokens"], 1).cpu().tolist()
    return res


def recurrent_reduced(torch, np) -> None:
    """Phase 18 (a): the reduced mamba2-2.7b and the 3-layer reduced
    recurrentgemma-9b in fp32 from the same weights (seed 0, drawn on
    the CPU, ``SLOW_DECAY`` set), 4 prompts of 80 tokens (past the window of 64) prefilled in
    two chunks of 40, the second from the carried state, then 4 decode
    steps, on the card and on the CPU: greedy tokens equal, every step's
    logits within rtol = atol = 1e-4, and on the card K6 or K7 from h0
    launched once a recurrent layer a chunk (K1-K4 at the attention
    layer)."""
    from repro_torch.kernels import _lib
    from repro_torch.models.model import build_model
    from repro_torch.training.checkpoint import tree_map
    for arch in RECURRENT_ARCHS:
        cfg = recurrent_config(arch, reduced=True)
        params = build_model(cfg, torch.float32, "cpu").init(
            torch.Generator().manual_seed(0))
        slow_decay(params)
        prompts = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                                    (4, 80))
        runs = {}
        for dev in ("cuda", "cpu"):
            model = build_model(cfg, torch.float32, dev)
            _lib.reset_launches()
            runs[dev] = recurrent_steps(
                torch, np, model, tree_map(lambda t: t.to(dev), params),
                prompts, 40, 4, num_blocks=128, block_base=4)
            runs[dev]["launches"] = {k: _lib.LAUNCHES[k]
                                     for k in RECURRENT_KERNELS}
        card, cpu = runs["cuda"], runs["cpu"]
        err = max(float((a - b).abs().max())
                  for a, b in zip(card["logits"], cpu["logits"]))
        print(f"recurrent (a): reduced {arch} fp32, {cfg.num_layers} "
              f"layers, 4 prompts of 80 tokens in 2 prefill chunks of 40, "
              f"then 4 decode steps: card tokens {card['tokens']}, max "
              f"|logits card - CPU| {err:.3e}, card launches "
              f"{ {k: v for k, v in card['launches'].items() if v} }")
        check(card["tokens"] == cpu["tokens"],
              f"reduced {arch}: card tokens {card['tokens']} != CPU "
              f"{cpu['tokens']}")
        check(all(torch.allclose(a, b, rtol=1e-4, atol=1e-4)
                  for a, b in zip(card["logits"], cpu["logits"])),
              f"reduced {arch}: card and CPU logits differ by {err:.3e}")
        check(not any(cpu["launches"].values()),
              f"reduced {arch}: CPU launches {cpu['launches']}")
        check(card["launches"] == recurrent_launches(cfg, 2, 4),
              f"reduced {arch}: card launches {card['launches']}, not "
              f"{recurrent_launches(cfg, 2, 4)}")


def recurrent_launches(cfg, chunks: int, decodes: int) -> dict:
    """The kernel launches of ``chunks`` prefill chunks and ``decodes``
    decode steps: K6 or K7 from h0 once a recurrent layer a chunk, K3
    and K4 once an attention layer a chunk, K1 and K2 once an attention
    layer a decode step."""
    from repro_torch.models.transformer import stack_plan
    kinds = [k[0] for seq, n in stack_plan(cfg) for k in seq * n]
    rec, att = sum(k in ("mamba", "rglru") for k in kinds), \
        kinds.count("gqa_win")
    return {"ssd_scan_from": chunks * rec if cfg.ssm else 0,
            "rglru_scan_from": 0 if cfg.ssm else chunks * rec,
            "paged_append_token": decodes * att,
            "paged_attention": decodes * att,
            "paged_append_chunk": chunks * att,
            "paged_flash_prefill": chunks * att}


# phase 18 (b): how much farther the served logits may lie from an fp32
# dense forward than the bf16 dense forward lies from it (the medians,
# over the compared positions, of each position's largest difference in
# standard deviations of the fp32 row). With random weights the stacks
# amplify bf16 rounding with depth: on the CPU, the reduced mamba2-2.7b
# at 64 layers in bf16 reads a median 0.55 and a largest 1.7 row
# deviations off its fp32 forward, with 29% of the argmaxes flipped, so
# a near-tie bound on greedy tokens (NEAR_TIE_SD) does not apply here;
# with SLOW_DECAY set, serving from a dropped carried state moves the
# logits by the scale of the row itself
RECURRENT_FIDELITY = 2.0


def recurrent_fidelity(torch, model, params, prompts, res, rows: int = 2):
    """The served bf16 logits of the first ``rows`` requests (the last
    prefill chunk's and each decode step's) against a dense forward of
    the row over the prompt and the served tokens (train mode: K6 or K7
    from zero and K5 over the whole sequence, no pool, no carried state)
    in fp32 on an fp32 copy of the weights, beside the same dense forward
    in bf16: each position's largest difference over the vocab in
    standard deviations of the fp32 row, and the greedy tokens that
    differ from the fp32 argmax."""
    from repro_torch.core.views import SINGLE
    from repro_torch.models.cache import TrainBackend
    from repro_torch.models.model import build_model
    from repro_torch.training.checkpoint import tree_map
    dev, P = model.device, prompts.shape[1]
    f32 = build_model(model.cfg, torch.float32, dev)
    p32 = tree_map(lambda t: t.float(), params)
    served, dense = [], []
    flips = {"served": 0, "dense": 0, "tokens": 0}
    first = res["prefills"] - 1
    for b in range(rows):
        seq = torch.as_tensor(list(prompts[b]) + res["tokens"][b][:-1],
                              device=dev)[None]
        with torch.no_grad():
            want = f32.forward(p32, SINGLE, mode="train",
                               backend=TrainBackend(),
                               tokens=seq)[0][0, P - 1:].float()
            got = model.forward(params, SINGLE, mode="train",
                                backend=TrainBackend(),
                                tokens=seq)[0][0, P - 1:].float()
        sd = want.std(-1)
        srv = torch.stack([x[b] for x in res["logits"][first:]]).to(dev)
        served += ((srv - want).abs().amax(-1) / sd).tolist()
        dense += ((got - want).abs().amax(-1) / sd).tolist()
        top = want.argmax(-1)
        flips["served"] += int((srv.argmax(-1) != top).sum())
        flips["dense"] += int((got.argmax(-1) != top).sum())
        flips["tokens"] += len(top)
        del want, got, srv
    del f32, p32
    if dev.type == "cuda":
        gc_collect(torch)
    med = {k: sorted(v)[len(v) // 2] for k, v in (("served", served),
                                                  ("dense", dense))}
    return {"median": med, "max": {"served": max(served),
                                   "dense": max(dense)}, "flips": flips}


def recurrent_full_width(torch, np, smi: str) -> None:
    """Phase 18 (b): mamba2-2.7b (64 layers, d_model 2560, 80 heads of 64,
    d_state 128) and recurrentgemma-9b (38 layers: 26 RG-LRU and 12 local
    attention, 16 heads of 256 on one kv head, window 2048, vocab 256000)
    at full width and depth in bf16, seeded random weights
    (``SLOW_DECAY`` set): 8 requests of
    3072 prompt tokens prefilled in 6 chunks of 512 (chunks 2-6 run K6 or
    K7 from the carried state and K4 over the prior pages; the window
    masks keys from chunk 5 on), then 32 decode steps (K2 at hd 256
    masking past 2048), after an untimed warm-up of one chunk and one
    decode step, the launch counts reset just before the timed run and
    held to ``recurrent_launches``; every token in the vocab, every
    step's logits finite, and two requests' served logits held against a
    dense fp32 forward within RECURRENT_FIDELITY times the bf16 dense
    forward's distance from it."""
    from repro_torch.kernels import _lib
    from repro_torch.models.model import build_model
    from repro_torch.training.checkpoint import tree_leaves
    P, chunk, decodes = 3072, 512, 32
    for arch in RECURRENT_ARCHS:
        cfg = recurrent_config(arch, reduced=False)
        model = build_model(cfg, torch.bfloat16, "cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        slow_decay(params)
        prompts = np.random.default_rng(18).integers(0, cfg.vocab_size,
                                                     (8, P))
        recurrent_steps(torch, np, model, params, prompts[:, :chunk], chunk,
                        1, num_blocks=8 * 34)
        gc_collect(torch)
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        res = recurrent_steps(torch, np, model, params, prompts, chunk,
                              decodes, num_blocks=8 * 200, timed=True)
        launches = {k: _lib.LAUNCHES[k] for k in RECURRENT_KERNELS}
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = recurrent_launches(cfg, P // chunk, decodes)
        check(launches == want, f"{arch}: launches {launches}, not {want}")
        check(all(0 <= x < cfg.vocab_size for row in res["tokens"]
                  for x in row), f"{arch}: a token outside the vocab")
        check(all(bool(torch.isfinite(x).all()) for x in res["logits"]),
              f"{arch}: a step's logits are not finite")
        fid = recurrent_fidelity(torch, model, params, prompts, res)
        pre = sorted(res["ms"][:res["prefills"]])
        dec = sorted(res["ms"][res["prefills"]:])
        n_params = sum(t.numel() for t in tree_leaves(params))
        print(f"recurrent (b): {arch} bf16 at full width and depth "
              f"({cfg.num_layers} layers, {n_params / 1e9:.3f} B "
              f"parameters), 8 requests of {P} prompt tokens in "
              f"{res['prefills']} prefill chunks of {chunk}: chunk ms "
              f"{[round(x, 2) for x in res['ms'][:res['prefills']]]} "
              f"(median {pre[len(pre) // 2]:.2f}); {decodes} decode steps "
              f"median {dec[len(dec) // 2]:.2f} ms (min {dec[0]:.2f}, max "
              f"{dec[-1]:.2f}) = {8 / dec[len(dec) // 2] * 1e3:.1f} tok/s; "
              f"peak {peak:.2f} GiB; launches "
              f"{ {k: v for k, v in launches.items() if v} }; {smi}")
        md, mx, fl = fid["median"], fid["max"], fid["flips"]
        print(f"recurrent (b): {arch}, 2 requests' {fl['tokens']} served "
              f"positions against an fp32 dense forward: served bf16 "
              f"logits a median {md['served']:.3f} (largest "
              f"{mx['served']:.3f}) row deviations off, the bf16 dense "
              f"forward {md['dense']:.3f} ({mx['dense']:.3f}); greedy "
              f"tokens off the fp32 argmax: served {fl['served']}, bf16 "
              f"dense {fl['dense']}")
        check(md["served"] <= RECURRENT_FIDELITY * md["dense"],
              f"{arch}: the served logits lie a median {md['served']:.3f} "
              f"row deviations from the fp32 dense forward, over "
              f"{RECURRENT_FIDELITY}x the bf16 dense forward's "
              f"{md['dense']:.3f}")
        del model, params, res
        gc_collect(torch)


def serve_recurrent(torch, np, smi: str) -> None:
    """Phase 18: (a) the reduced configs card == CPU at step level from
    carried states, (b) both models at full width and depth served at
    step level."""
    t0 = time.perf_counter()
    recurrent_reduced(torch, np)
    t1 = time.perf_counter()
    recurrent_full_width(torch, np, smi)
    print(f"recurrent: {smi}; (a) {t1 - t0:.1f} s, (b) "
          f"{time.perf_counter() - t1:.1f} s; phase 18 took "
          f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 19: Mamba-2 and RecurrentGemma through the engine and the scheduler
# ---------------------------------------------------------------------------

# (prompt, output) of phase 19 (a)'s requests: those of
# tests/test_torch_recurrent_engine.py, prefilled in chunks of 32 (last
# chunks of 24, 8 and 32 tokens), four batch rows
ENGINE_TRACE = ((24, 6), (56, 12), (88, 4), (40, 9), (72, 5), (24, 11),
                (88, 7), (40, 4))
# phase 19 (b)'s, at full width: prefill chunks of 512
WIDE_TRACE = ((300, 8), (1500, 16), (812, 12), (1024, 9), (517, 16),
              (1333, 10))


def engine_serve(torch, model, params, trace, *, chunk: int, bpe: int,
                 num_blocks: int, block_base: int, max_blocks: int) -> dict:
    """Serves ``trace`` [(prompt, output)] through DynamicScheduler over
    FlyingEngine at ``ParallelPlan(1, 1, 1)`` (HARD, the layout pinned),
    requests arriving 5 ms apart, every step reporting 10 ms
    (``FixedClock``), so that any two runs batch alike. Returns each
    request's tokens and prompt ids, and the scheduler's phases."""
    from repro_torch.core.engine import FlyingEngine
    from repro_torch.core.kv_adaptor import PoolGeometry
    from repro_torch.core.modes import ParallelPlan
    from repro_torch.core.scheduler import DynamicScheduler, SchedulerConfig
    from repro_torch.core.task_pool import Request
    plan = ParallelPlan(engine_rows=1, tp_base=1, data_rows=1)
    geom = PoolGeometry(model.cfg, plan, num_blocks=num_blocks,
                        block_base=block_base)
    eng = FlyingEngine(model, plan, geom, params, batch_per_engine=bpe,
                       max_blocks_per_req=max_blocks, device=model.device)
    sched = DynamicScheduler(plan, geom, FixedClock(eng), SchedulerConfig(
        strategy="hard", max_batch_per_group=bpe, prefill_chunk=chunk))
    reqs = [Request(req_id=f"r{i}", arrival=0.005 * i, prompt_len=p,
                    output_len=o) for i, (p, o) in enumerate(trace)]
    for r in reqs:
        sched.submit(r)
    sched.run(max_steps=5000)
    check(all(r.state == "done" for r in reqs),
          f"{model.cfg.name}: engine requests not done")
    return {"tokens": {r.req_id: list(map(int, eng.generated_tokens(
                r.req_id))) for r in reqs},
            "prompts": {r.req_id: eng.prompt_tokens(r) for r in reqs},
            "phases": [e.phase for e in sched.log]}


def step_reference(torch, np, model, params, run: dict, trace, chunk: int,
                   block_base: int) -> dict:
    """Each request of an ``engine_serve`` run alone at batch 1 through
    ``build_serve_step`` (``recurrent_steps``: the same prefill chunks,
    then greedy decode steps): its tokens and each step's logits."""
    out = {}
    for (rid, prompt), (P, o) in zip(run["prompts"].items(), trace):
        res = recurrent_steps(torch, np, model, params,
                              np.asarray(prompt)[None], chunk, o - 1,
                              num_blocks=-(-(P + o) // block_base) + 2,
                              block_base=block_base)
        out[rid] = {"tokens": res["tokens"][0],
                    "logits": res["logits"][res["prefills"] - 1:]}
    return out


def hold_to_reference(torch, run: dict, ref: dict, what: str,
                      near_ties: bool) -> dict:
    """Each request's engine tokens against its batch-1 step tokens:
    equal, or with ``near_ties`` equal up to a first difference where
    the step's logits put the engine's token within NEAR_TIE_SD of the
    row's deviation of the step's own (past it the two sequences
    continue from different tokens). Returns the tokens held and the
    near-ties taken."""
    held = ties = 0
    worst = 0.0
    for rid, got in run["tokens"].items():
        want = ref[rid]["tokens"]
        check(len(got) == len(want), f"{what} {rid}: {len(got)} tokens, "
              f"the step gave {len(want)}")
        j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
        held += len(got) if j is None else j
        if j is None:
            continue
        row = ref[rid]["logits"][j][0].float()
        margin = float(row.max() - row[got[j]])
        worst = max(worst, margin / (NEAR_TIE_SD * float(row.std())))
        check(near_ties and margin <= NEAR_TIE_SD * float(row.std()),
              f"{what} {rid}: token {j} is {got[j]}, the batch-1 step's "
              f"{want[j]} (margin {margin:.4g}, {worst:.2f}x the near-tie "
              f"bound)")
        ties += 1
    return {"held": held, "ties": ties, "worst": worst}


def engine_reduced(torch, np) -> None:
    """Phase 19 (a): ENGINE_TRACE with the reduced mamba2-2.7b and the
    3-layer reduced recurrentgemma-9b in fp32 (seed 0, ``SLOW_DECAY``)
    through the engine on the card and on the CPU: tokens equal, K6 or
    K7 from h0 launched on the card and none on the CPU; and each
    request's card tokens equal the batch-1 step's on the card."""
    from repro_torch.kernels import _lib
    from repro_torch.models.model import build_model
    from repro_torch.training.checkpoint import tree_map
    kw = dict(chunk=32, bpe=4, num_blocks=256, block_base=4, max_blocks=32)
    for arch in RECURRENT_ARCHS:
        cfg = recurrent_config(arch, reduced=True)
        params = build_model(cfg, torch.float32, "cpu").init(
            torch.Generator().manual_seed(0))
        slow_decay(params)
        runs = {}
        for dev in ("cuda", "cpu"):
            model = build_model(cfg, torch.float32, dev)
            p = tree_map(lambda t: t.to(dev), params)
            _lib.reset_launches()
            runs[dev] = engine_serve(torch, model, p, ENGINE_TRACE, **kw)
            runs[dev]["launches"] = {k: _lib.LAUNCHES[k]
                                     for k in RECURRENT_KERNELS}
            if dev == "cuda":
                ref = step_reference(torch, np, model, p, runs[dev],
                                     ENGINE_TRACE, 32, 4)
        card, cpu = runs["cuda"], runs["cpu"]
        scan = "ssd_scan_from" if cfg.ssm else "rglru_scan_from"
        print(f"engine (a): reduced {arch} fp32, {len(ENGINE_TRACE)} "
              f"requests in chunks of 32 over 4 rows: card tokens "
              f"{card['tokens']}; card launches "
              f"{ {k: v for k, v in card['launches'].items() if v} }")
        check(card["tokens"] == cpu["tokens"],
              f"reduced {arch} engine: card tokens {card['tokens']} != CPU "
              f"{cpu['tokens']}")
        check(card["phases"] == cpu["phases"] and "mixed" not in
              card["phases"], f"reduced {arch} engine: phases differ or "
              f"mixed")
        check(card["launches"][scan] > 0 and not any(
            cpu["launches"].values()), f"reduced {arch} engine: launches "
              f"card {card['launches']}, CPU {cpu['launches']}")
        hold_to_reference(torch, card, ref, f"reduced {arch} engine",
                          near_ties=False)


def engine_wide(torch, np, dev: str = "cuda") -> None:
    """Phase 19 (b): both models at full width cut to 4 layers in fp32
    (seed 0, ``SLOW_DECAY``): mamba2-2.7b's 80 heads of 64 with d_state
    128, recurrentgemma-9b's RG-LRU of 4096 and a local-attention layer
    at hd 256 (its 4th layer RG-LRU again); WIDE_TRACE through the engine
    (prefill chunks of 512, 4 batch rows, so chunks of several lengths
    share steps and rows are reused) and each request alone at batch 1
    through the step on the card: tokens equal, or equal up to a near-tie
    within NEAR_TIE_SD."""
    import dataclasses

    from repro_torch.models.model import build_model
    for arch in RECURRENT_ARCHS:
        cfg = dataclasses.replace(recurrent_config(arch, reduced=False),
                                  num_layers=4)
        model = build_model(cfg, torch.float32, dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        slow_decay(params)
        t0 = time.perf_counter()
        run = engine_serve(torch, model, params, WIDE_TRACE, chunk=512,
                           bpe=4, num_blocks=1024, block_base=16,
                           max_blocks=128)
        t1 = time.perf_counter()
        ref = step_reference(torch, np, model, params, run, WIDE_TRACE,
                             512, 16)
        res = hold_to_reference(torch, run, ref, f"{arch} 4 layers fp32",
                                near_ties=True)
        print(f"engine (b): {arch} fp32 at full width, 4 layers, "
              f"{len(WIDE_TRACE)} requests (prompts "
              f"{[p for p, _ in WIDE_TRACE]}) in chunks of 512 over 4 "
              f"rows: {res['held']} tokens equal to the batch-1 step's, "
              f"{res['ties']} near-ties (worst {res['worst']:.2f}x the "
              f"bound); engine {t1 - t0:.1f} s, steps "
              f"{time.perf_counter() - t1:.1f} s")
        del model, params, run, ref
        gc_collect(torch)


def engine_full(torch, np, smi: str, dev: str = "cuda") -> dict:
    """Phase 19 (c): both models at full width and depth in bf16 (seed 0,
    ``SLOW_DECAY``) through the launcher's real path (``serve_config``:
    16 requests at Poisson 20/s, prompts 256-3072, outputs 32-64, 8
    batch rows, prefill chunks of 512), the launch counts reset just
    before and read just after: every request done, every token in the
    vocab, K6 or K7 from h0 once a recurrent layer a prefill step and
    K1-K4 once an attention layer a step (``recurrent_launches``). Prints
    TTFT p50/p90, TPOT p50, output tok/s and the peak. Returns the
    launches of the kernel rows it runs."""
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import build_stack, replay
    from repro_torch.models.model import build_model
    out = {}
    for arch in RECURRENT_ARCHS:
        sc = serve_config(arch=arch, requests=16, device=dev,
                          prompt_range=(256, 3072), output_range=(32, 64))
        cfg = recurrent_config(arch, reduced=False)
        model = build_model(cfg, torch.bfloat16, dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        slow_decay(params)
        stack = build_stack(sc, weights=(model, params))
        sched = stack[0]
        clock = StepClock(sched.backend)
        sched.backend = clock
        gc_collect(torch)
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        sched, wall = replay(sc, stack)
        launches = {k: _lib.LAUNCHES[k] for k in RECURRENT_KERNELS}
        peak = torch.cuda.max_memory_allocated() / 2**30
        reqs = list(sched.pool.all.values())
        eng = clock.eng
        toks = {r.req_id: eng.generated_tokens(r.req_id) for r in reqs}
        kinds = [k for k, _, _ in clock.log]
        check(all(r.state == "done" and len(toks[r.req_id]) == r.output_len
                  for r in reqs), f"{arch}: a request not done in full")
        check(all(0 <= x < cfg.vocab_size for v in toks.values() for x in v),
              f"{arch}: a token outside the vocab")
        check("mixed" not in kinds, f"{arch}: a mixed step ran")
        want = recurrent_launches(cfg, kinds.count("prefill"),
                                  kinds.count("decode"))
        check(launches == want, f"{arch}: launches {launches}, not {want}")
        durs = {k: sorted(dt for kind, _, dt in clock.log if kind == k)
                for k in ("prefill", "decode")}
        ttft = sorted(r.first_token_t - r.arrival for r in reqs)
        tpot = sorted((r.token_times[-1] - r.first_token_t)
                      / max(len(r.token_times) - 1, 1) for r in reqs)
        n_out = sum(len(v) for v in toks.values())
        print(f"engine (c): {arch} bf16 at full width and depth "
              f"({cfg.num_layers} layers) through the launcher, 16 "
              f"requests, prompts 256-3072, outputs 32-64, 8 rows, chunks "
              f"of 512: {kinds.count('prefill')} prefill and "
              f"{kinds.count('decode')} decode steps ("
              + ", ".join(f"{k} {sum(v):.2f} s, median "
                          f"{v[len(v) // 2] * 1e3:.2f} ms"
                          for k, v in durs.items()) + "); TTFT p50 "
              f"{ttft[len(ttft) // 2] * 1e3:.1f} ms p90 "
              f"{ttft[int(0.9 * (len(ttft) - 1))] * 1e3:.1f} ms, TPOT p50 "
              f"{tpot[len(tpot) // 2] * 1e3:.2f} ms, {n_out} tokens in "
              f"{wall:.2f} s = {n_out / wall:.1f} tok/s; peak {peak:.2f} "
              f"GiB; launches {({k: v for k, v in launches.items() if v})}"
              f"; {smi}")
        if cfg.ssm:
            out["ssd_scan_from"] = launches["ssd_scan_from"]
        else:
            out["rglru_scan_from"] = launches["rglru_scan_from"]
            out["paged_attention_hd256"] = launches["paged_attention"]
            out["paged_flash_prefill_hd256"] = \
                launches["paged_flash_prefill"]
        del model, params, stack, sched, clock, eng
        gc_collect(torch)
    return out


def serve_engine_recurrent(torch, np, smi: str) -> dict:
    """Phase 19: (a) the reduced configs through the engine, card == CPU
    == the batch-1 step, (b) 4 full-width layers in fp32 against the
    batch-1 step, (c) both full models through the launcher."""
    t0 = time.perf_counter()
    engine_reduced(torch, np)
    t1 = time.perf_counter()
    engine_wide(torch, np)
    t2 = time.perf_counter()
    out = engine_full(torch, np, smi)
    print(f"engine: {smi}; (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
          f"{time.perf_counter() - t2:.1f} s; phase 19 took "
          f"{time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 20: --serve on two ranks, rank 0 leading over HTTP
# ---------------------------------------------------------------------------

# (prompt, output, tier, arrival) of phase 20 (a)'s requests (and of
# tests/test_torch_serve_ranks.py's): two priority requests among the
# first six carve a TP island; a burst of seven queues deep enough to
# dissolve it; a late priority request carves it again
LOCKSTEP_TRACE = (
    (8, 6, "standard", 0.0), (12, 24, "standard", 0.0),
    (8, 6, "priority", 0.01), (16, 5, "standard", 0.02),
    (10, 12, "standard", 0.03), (12, 7, "priority", 0.04),
    (20, 4, "standard", 0.16), (8, 8, "standard", 0.16),
    (12, 6, "standard", 0.16), (8, 5, "standard", 0.16),
    (16, 6, "standard", 0.16), (10, 4, "standard", 0.16),
    (8, 4, "standard", 0.16), (12, 6, "priority", 0.45))
LOCKSTEP_CANCEL = "s4"      # its client leaves after its first token


def lockstep_requests(Request):
    return [Request(req_id=f"s{i}", arrival=t, prompt_len=p, output_len=o,
                    tier=tier)
            for i, (p, o, tier, t) in enumerate(LOCKSTEP_TRACE)]


def adaptor_state(sched):
    """Each adaptor's free blocks and the requests it holds blocks of."""
    return [[len(a._free_set), sorted(a.table)] for a in sched.adaptors]


async def lockstep_drive(loop, reqs, snap):
    """Submit ``reqs`` to the async loop ``loop`` and consume every
    stream; the client of LOCKSTEP_CANCEL aborts after its first token
    (``snap["cancel"]`` then takes the adaptors). Returns each stream's
    tokens and terminal state."""
    import asyncio
    await loop.start()
    out = {}

    async def consume(r, st):
        toks = []
        async for ev in st:
            toks.append(int(ev[2]))
            if r.req_id == LOCKSTEP_CANCEL and len(toks) == 1:
                loop.abort(r.req_id)
                snap["cancel"] = adaptor_state(loop.door.sched)
        out[r.req_id] = [toks, st.final_state]

    streams = [(r, loop.submit(r)) for r in reqs]
    await asyncio.gather(*(consume(r, st) for r, st in streams))
    await loop.stop()
    return out


def lockstep_trace(torch, device, rank: int) -> dict:
    """Phase 20 (a) on one rank: the reduced llama3-8b in fp32 (weights
    seeded on the CPU) at ``ParallelPlan(1, 1, 2)`` on ``device``,
    LOCKSTEP_TRACE through rank 0's virtual-pace loop and rank 1's
    follower, ``FlyingPolicy`` under HARD, every step and rebind
    reporting 10 ms, tokens harvested every 4 steps."""
    import asyncio

    from repro_torch.configs import get_config
    from repro_torch.core.engine import FlyingEngine
    from repro_torch.core.kv_adaptor import PoolGeometry
    from repro_torch.core.modes import ParallelPlan
    from repro_torch.core.policy import FlyingPolicy
    from repro_torch.core.scheduler import DynamicScheduler, SchedulerConfig
    from repro_torch.core.task_pool import Request
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import ServeConfig, build_door
    from repro_torch.models.model import build_model
    from repro_torch.serving.asyncloop import AsyncServeLoop
    from repro_torch.serving.lockstep import Follower, digest

    cfg = get_config("llama3-8b").reduced()
    plan = ParallelPlan(engine_rows=1, tp_base=1, data_rows=2)
    params = build_model(cfg, torch.float32, "cpu").init(
        torch.Generator().manual_seed(0))
    geom = PoolGeometry(cfg, plan, num_blocks=64, block_base=4)
    eng = FlyingEngine(build_model(cfg, torch.float32, device), plan, geom,
                       params, batch_per_engine=2, max_blocks_per_req=16,
                       device=device, harvest_limit=4)
    sched = DynamicScheduler(plan, geom, FixedClock(eng), SchedulerConfig(
        strategy="hard", max_batch_per_group=2, prefill_chunk=8),
        policy=FlyingPolicy())
    door = build_door(ServeConfig(), sched)
    _lib.reset_launches()
    if rank == 0:
        node = AsyncServeLoop(door, pace="virtual", pool=eng.pool)
        streams = asyncio.run(lockstep_drive(
            node, lockstep_requests(Request), {}))
        node.shutdown()
    else:
        node = Follower(door, eng.pool)
        node.run()
        streams = {rid: [list(map(int, eng.generated_tokens(rid))), r.state]
                   for rid, r in door.requests.items()}
    return {"streams": streams, "phases": [l.phase for l in sched.log],
            "merges": [l.merge for l in sched.log],
            "switches": sched.switches, "digest": digest(door, node.ticks),
            "launches": {k: _lib.LAUNCHES[k] for k in SERVE_KERNELS}}


def mark_streams() -> dict:
    """Patch the serving classes to log, per request id, the monotonic
    times of its submission to the async loop, of its first token pushed
    into its stream and of that token taken by the stream's consumer,
    and under "accepts" each connection's accept time."""
    from repro_torch.serving.asyncloop import AsyncServeLoop, TokenStream
    from repro_torch.serving.server import ServeHTTP
    marks: dict = {}
    submit, push = AsyncServeLoop.submit, TokenStream.push
    handle, anext = ServeHTTP._handle, TokenStream.__anext__

    async def marked_handle(self, reader, writer):
        marks.setdefault("accepts", []).append(time.monotonic())
        await handle(self, reader, writer)

    async def marked_anext(self):
        ev = await anext(self)
        marks[self.req_id].setdefault("taken", time.monotonic())
        return ev

    def marked_submit(self, req, tier=None):
        marks[req.req_id] = {"submit": time.monotonic()}
        return submit(self, req, tier)

    def marked_push(self, ev):
        ok = push(self, ev)
        if ok:
            marks[self.req_id].setdefault("first", time.monotonic())
        return ok
    AsyncServeLoop.submit = marked_submit
    TokenStream.push = marked_push
    ServeHTTP._handle = marked_handle
    TokenStream.__anext__ = marked_anext
    return marks


def serve_ranks_rank(rank: int, world: int, cfg, d: str, trace: bool,
                     marks: bool) -> None:
    """One rank of phase 20: (a) when ``trace``, then (b): ``cfg`` served
    over HTTP through the launcher's rank entry (``launch.serve.
    _rank_main``): rank 0's server writes its port and pid to
    ``{d}/port`` for the client and runs until the client's SIGINT,
    rank 1 follows; then each rank's readings (with rank 0's
    ``mark_streams`` marks when ``marks``) into ``{d}/rank{rank}.json``."""
    import os

    import torch

    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import _rank_main
    from repro_torch.serving.lockstep import digest
    from repro_torch.serving.metrics import summarize
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    res = {}
    if trace:
        t0 = time.perf_counter()
        res["a"] = {dev: lockstep_trace(torch, dev, rank)
                    for dev in ("cuda", "cpu")}
        res["a_s"] = time.perf_counter() - t0
    stamps = mark_streams() if marks and rank == 0 else None

    def ready(port):
        Path(d, "port.part").write_text(f"{port} {os.getpid()}")
        os.replace(Path(d, "port.part"), Path(d, "port"))

    _lib.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    node = _rank_main(rank, world, cfg, ready if rank == 0 else None)
    door = node.door
    sched, eng = door.sched, door.sched.backend
    st = eng.pool.stats
    b = {"launches": {k: _lib.LAUNCHES[k] for k in SERVE_KERNELS},
         "switches": sched.switches,
         "rebind_ms": [dt * 1e3 for dt in eng.switch_log],
         "merges": [l.merge for l in sched.log],
         "log": [[l.phase, l.merge, l.t] for l in sched.log],
         "preempt": dict(sched.preempt_stats),
         "ticks": node.ticks, "host_collectives": st.host_collectives,
         "broadcasts": st.broadcasts, "digest": digest(door, node.ticks),
         "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
         "rank_s": time.perf_counter() - t0, "backend": eng.pool.describe()}
    if rank == 0:
        m = summarize(list(door.requests.values()))
        b["broadcast_ms"] = list(node.broadcast_ms)
        b["tpot_ms"] = m.median_tpot * 1e3
        b["server_ttft"] = {rid: [r.tier, r.first_token_t - r.arrival]
                            for rid, r in door.requests.items()
                            if r.first_token_t is not None}
        if stamps is not None:
            b["marks"] = stamps
    res["b"] = b
    with open(Path(d, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def serve_ranks_client(d: str, reqs, conn) -> None:
    """Phase 20 (b)'s client, in a process of its own: waits for rank 0's
    port, sends ``reqs`` with ``loadgen.drive_http``, reads ``/metrics``,
    then stops the server with SIGINT (as a launcher passes on an
    operator's); the records go over ``conn``."""
    import asyncio
    import os
    import signal

    from repro_torch.serving.loadgen import drive_http
    port_file = Path(d, "port")
    t_end = time.monotonic() + 600
    while not port_file.exists():
        if time.monotonic() > t_end:
            conn.send(None)
            return
        time.sleep(0.1)
    port, pid = map(int, port_file.read_text().split())
    out = None
    try:
        out = asyncio.run(drive_http("127.0.0.1", port, reqs,
                                     collect_tokens=True))
        out["metrics"] = asyncio.run(http_get(port, "/metrics"))
    finally:
        os.kill(pid, signal.SIGINT)
        conn.send(out)
        conn.close()


async def http_get(port: int, path: str) -> dict:
    import asyncio
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: smoke\r\n\r\n".encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    return json.loads(raw.split(b"\r\n\r\n", 1)[1])


def ranks_http_run(cfg, *, trace: bool = False, marks: bool = False):
    """``cfg`` over HTTP on ``cfg.ranks`` rank processes sharing the card
    (``serve_ranks_rank``), its trace sent by ``serve_ranks_client``
    from a process of its own. Every rank must exit 0. Returns the
    requests, the client's records and each rank's readings."""
    import copy
    import multiprocessing
    import tempfile

    from repro_torch.launch.ranks import spawn
    from repro_torch.launch.serve import real_spec
    from repro_torch.serving.workload import generate
    reqs = [copy.deepcopy(r) for r in generate(real_spec(cfg))]
    with tempfile.TemporaryDirectory() as d:
        ctx = multiprocessing.get_context("spawn")
        recv, send = ctx.Pipe(duplex=False)
        client = ctx.Process(target=serve_ranks_client, args=(d, reqs, send))
        client.start()
        send.close()
        try:
            spawn(serve_ranks_rank, cfg.ranks, (cfg, d, trace, marks),
                  device_type="cuda", timeout=900)
            check(recv.poll(60), "phase 20: the client sent no records")
            out = recv.recv()
        finally:
            client.join(timeout=60)
            if client.is_alive():
                client.terminate()
                client.join()
        check(out is not None, "phase 20: the client failed")
        runs = []
        for r in range(cfg.ranks):
            with open(Path(d, f"rank{r}.json")) as f:
                runs.append(json.load(f))
    return reqs, out, runs


def check_lockstep_trace(runs) -> dict:
    """Phase 20 (a)'s verdict: on each rank the card's streams, phase log
    and switches equal the CPU's; every rank's digest rank 0's; every
    request done but the one its client left, which was aborted; the
    policy carved a TP island and released it; K1-K4 launched on the
    card."""
    def run(x):
        return {k: v for k, v in x.items() if k != "launches"}
    got = runs[0]["cuda"]
    for r, res in enumerate(runs):
        check(run(res["cuda"]) == run(res["cpu"]),
              f"rank {r}: card run {res['cuda']['streams']} != CPU "
              f"{res['cpu']['streams']}")
        check(res["cuda"]["digest"] == got["digest"],
              f"rank {r}'s digest differs from rank 0's")
        for k in SERVE_KERNELS:
            check(res["cuda"]["launches"][k] > 0,
                  f"rank {r}: {k} never launched in (a)")
    states = {rid: s for rid, (_, s) in got["streams"].items()}
    check(states.pop(LOCKSTEP_CANCEL) == "aborted" and
          all(s == "done" for s in states.values()),
          f"phase 20 (a): terminal states {states}")
    merges = got["merges"]
    check(2 in merges and 1 in merges[merges.index(2):],
          f"phase 20 (a): the policy did not carve and release a TP "
          f"island: merges {merges}")
    return got


def serve_ranks(torch, np, smi: str) -> None:
    """Phase 20: (a) LOCKSTEP_TRACE through the leader and the follower,
    card against CPU; (b) llama3-8b at full width and depth in bf16 on
    two ranks over HTTP at wall pace (phase 5's geometry, 8 requests at
    Poisson 2/s, a quarter priority), stopped by SIGINT. Its prefill
    chunks on the TP2 island (its row-parallel all_reduces host-staged
    by gloo, a few seconds a chunk) take most of the phase, so it
    serves the first 8 requests of the trace (3 of them priority) to
    keep the script inside its time limit."""
    t0 = time.perf_counter()
    cfg = serve_config(ranks=2, serve=True, pace="wall", port=0,
                       requests=8, rate=2.0, priority_frac=0.25,
                       num_blocks=2048)
    reqs, out, runs = ranks_http_run(cfg, trace=True)
    a = check_lockstep_trace([res["a"] for res in runs])
    print(f"ranks (a): reduced llama3-8b fp32 at ParallelPlan(1, 1, 2), "
          f"{len(LOCKSTEP_TRACE)} requests through rank 0's loop and rank "
          f"1's follower, merges by tick {a['merges']} ({a['switches']} "
          f"switches): card streams, phase logs and switches equal the "
          f"CPU's on both ranks, digests equal, {LOCKSTEP_CANCEL} aborted "
          f"by its client after its first token "
          f"({max(res['a_s'] for res in runs):.1f} s)")
    from repro_torch.configs import get_config
    vocab = get_config("llama3-8b").vocab_size
    recs = {rec["req_id"]: rec for rec in out["records"]}
    for q in reqs:
        rec = recs[q.req_id]
        check(rec["state"] == "done" and rec["n_tokens"] == q.output_len,
              f"ranks (b) {q.req_id}: state {rec['state']}, "
              f"{rec['n_tokens']}/{q.output_len} tokens")
        check(all(0 <= t < vocab for t in rec["tokens"]),
              f"ranks (b) {q.req_id}: token outside the vocab")
    b = [res["b"] for res in runs]
    for r, x in enumerate(b):
        for k in SERVE_KERNELS:
            check(x["launches"][k] > 0,
                  f"ranks (b) rank {r}: {k} never launched")
        check(x["digest"] == b[0]["digest"],
              f"ranks (b): rank {r}'s digest differs from rank 0's")
    check(b[0]["switches"] >= 1 and b[0]["rebind_ms"],
          f"ranks (b): no rebind ({b[0]['switches']} switches)")
    check(out["metrics"]["layout"] in ("[2xDP]", "[DP | DP]", "[TP2]"),
          f"ranks (b): /metrics layout {out['metrics']['layout']}")
    ttft = {}
    for rec in out["records"]:
        ttft.setdefault(rec["tier"], []).append(rec["ttft_wall_s"] * 1e3)
    n_tok = sum(rec["n_tokens"] for rec in out["records"])
    bms = np.asarray(b[0]["broadcast_ms"])
    per_tick = b[0]["host_collectives"] / b[0]["ticks"]
    print(f"ranks (b): llama3-8b bf16, 32 layers, {b[0]['backend']}; "
          f"{len(reqs)} requests at Poisson {cfg.rate}/s over HTTP at wall "
          f"pace, rank 0 leading, rank 1 following: all done, every token "
          f"in the vocab, digests equal, every rank exited 0 after SIGINT; "
          f"K1-K4 launches a rank {[x['launches'] for x in b]}")
    for tier, xs in sorted(ttft.items()):
        print(f"ranks (b): client TTFT {tier} p50 {np.percentile(xs, 50):.1f} "
              f"p90 {np.percentile(xs, 90):.1f} ms over {len(xs)} requests")
    print(f"ranks (b): server TPOT p50 {b[0]['tpot_ms']:.2f} ms; "
          f"{n_tok / out['wall_s']:.1f} output tok/s over "
          f"{out['wall_s']:.3f} s wall; {b[0]['switches']} switches, "
          f"rebinds {', '.join(f'{x:.2f}' for x in b[0]['rebind_ms'])} ms; "
          f"preempt_stats {b[0]['preempt']}")
    # a step's time on the scheduler's clock (it tracks the wall at wall
    # pace): from its log entry to the next, by merge and phase
    log = b[0]["log"]
    by = {}
    for (phase, merge, t), nxt in zip(log, log[1:]):
        by.setdefault((merge, phase), []).append((nxt[2] - t) * 1e3)
    print("ranks (b): steps by merge and phase: " + "; ".join(
        f"merge {m} {p} {len(xs)}, median {np.median(xs):.1f} ms"
        for (m, p), xs in sorted(by.items())))
    print(f"ranks (b): broadcast {np.median(bms):.3f} ms median, "
          f"{np.percentile(bms, 99):.3f} ms p99 over {len(bms)} broadcasts "
          f"({b[0]['ticks']} ticks); {per_tick:.2f} host collectives a "
          f"tick on rank 0; peak memory "
          f"{[round(x['peak_gib'], 2) for x in b]} GiB; /metrics layout "
          f"{out['metrics']['layout']}; {smi}")
    print(f"ranks: {smi}; phase 20 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 21: sharded training on two ranks sharing the card over gloo
# ---------------------------------------------------------------------------

# phase 21 (a)'s plans, (engine_rows, tp_base, data_rows), and configs:
# reduced llama3-8b and Phi-3.5-MoE at both plans, reduced mamba2-2.7b
# and the 4-layer RecurrentGemma at TP2 (K6 and K7 at their local heads
# and channels)
SHARDED_PLANS = {"TP2": (1, 2, 1), "DP2": (1, 1, 2)}
SHARDED_RUNS = (("llama3-8b", "TP2"), ("llama3-8b", "DP2"),
                ("phi3.5-moe-42b-a6.6b", "TP2"),
                ("phi3.5-moe-42b-a6.6b", "DP2"),
                ("mamba2-2.7b", "TP2"), ("recurrentgemma-9b", "TP2"))
SHARDED_KERNELS = TRAIN_KERNELS + MAMBA_KERNELS + ("rglru_scan",
                                                   "rglru_scan_bwd")
# phase 21 (a): the arch whose card and CPU steps start from a common
# state, the card's, at every step, and the gradient size under which an
# element whose gradient differs on the two devices is left out of that
# step's parameters (at most 1% of them): Adam moves a weight by about
# lr * sign(g) while its moments are young, so a gradient within
# rounding of zero moves it up to 2 lr apart (tests/test_torch_train.py)
SHARDED_COMMON = "mamba2-2.7b"
SHARDED_NEAR_ZERO = 1e-6
# phase 21 (d)'s rows of the kernels' JSON record and the kernels whose
# launches they take
SHARDED_ROWS = {"ssd_scan_tp2": "ssd_scan", "ssd_scan_bwd_tp2": "ssd_scan_bwd",
                "rglru_scan_tp2": "rglru_scan",
                "rglru_scan_bwd_tp2": "rglru_scan_bwd",
                "flash_prefill_hd256_tp2": "flash_prefill",
                "flash_prefill_bwd_hd256_tp2": "flash_prefill_bwd"}


def sharded_reduced(torch) -> dict:
    """Phase 21 (a) on this rank: each run of ``SHARDED_RUNS`` in fp32,
    3 steps of batch 4 x 128 tokens through ``build_train_step`` on the
    card and on the CPU side by side, over the same gloo groups, from
    the same seeded logical weights. Before step 1, each leaf's
    gradient gathered to its logical shape on both devices; after each
    step the losses and the gathered parameters (for
    ``SHARDED_COMMON``, the CPU starting every step from the card's
    state, the elements whose gradient there is near zero on both
    devices and differs left out). Returns the largest differences and
    the card's launches."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.modes import ParallelPlan
    from repro_torch.core.weights_manager import WeightsManager
    from repro_torch.kernels import _lib
    from repro_torch.models.model import build_model
    from repro_torch.training.checkpoint import (tree_leaves, tree_map,
                                                 tree_unflatten)
    from repro_torch.training.data import DataConfig, batches
    from repro_torch.training.optimizer import AdamW, AdamWState
    from repro_torch.training.train_step import (build_train_step,
                                                 logical_specs, train_mesh)

    out = {}
    for arch, name in SHARDED_RUNS:
        cfg = get_config(arch).reduced()
        if arch == "recurrentgemma-9b":
            cfg = dataclasses.replace(cfg, num_layers=4)
        plan = ParallelPlan(*SHARDED_PLANS[name])
        mesh = train_mesh(plan)
        wm = WeightsManager(cfg, plan)
        logical = build_model(cfg, torch.float32, "cpu").init(
            torch.Generator().manual_seed(0))
        specs = logical_specs(build_model(cfg, torch.float32, "cpu"), plan)
        side = {}
        for dev in ("cuda", "cpu"):
            model = build_model(cfg, torch.float32, dev)
            opt = AdamW(lr=1e-3, warmup=1)
            shards = wm.train_shard(logical, mesh.pod, mesh.data,
                                    mesh.model, device=dev)
            side[dev] = {"step": build_train_step(model, plan, opt=opt,
                                                  mesh=mesh),
                         "carry": (shards, opt.init(shards))}

        def gathered(leaves, like):
            whole = wm.gather_train(tree_unflatten(like, list(leaves)),
                                    specs, mesh.groups)
            return [t.detach().cpu().numpy() for t in tree_leaves(whole)]
        common = arch == SHARDED_COMMON
        it = batches(DataConfig(cfg.vocab_size, 128, 4, seed=0))
        r = {"card": [], "cpu": [], "grad_abs": 0.0, "param_abs": 0.0,
             "masked_share": 0.0}
        _lib.reset_launches()
        for s in range(3):
            b = next(it)
            if common and s:
                # the CPU takes the card's parameters and Adam state
                p, o = side["cuda"]["carry"]
                cp = side["cpu"]["carry"][0]
                with torch.no_grad():
                    for dst, src in zip(tree_leaves(cp), tree_leaves(p)):
                        dst.copy_(src.cpu())
                side["cpu"]["carry"] = (cp, AdamWState(
                    o.step, tree_map(lambda t: t.to("cpu", copy=True), o.m),
                    tree_map(lambda t: t.to("cpu", copy=True), o.v)))
            grads = None
            if s == 0 or common:
                grads = {dev: gathered(x["step"].gradients(
                    x["carry"][0], b)[0], x["carry"][0])
                    for dev, x in side.items()}
                if s == 0:
                    r["grad_abs"] = max(
                        float(np.abs(a - w).max()) if a.size else 0.0
                        for a, w in zip(grads["cuda"], grads["cpu"]))
            for dev, x in side.items():
                x["carry"], mets = x["step"](x["carry"], b)
                r["card" if dev == "cuda" else "cpu"].append(
                    float(mets["loss"]))
            if common or s == 2:
                pc, ph = (gathered(tree_leaves(side[dev]["carry"][0]),
                                   side[dev]["carry"][0])
                          for dev in ("cuda", "cpu"))
                masked = size = 0
                for i, (a, w) in enumerate(zip(pc, ph)):
                    m = np.zeros(a.shape, bool)
                    if common:
                        ga, gw = grads["cuda"][i], grads["cpu"][i]
                        m = (np.abs(ga) <= SHARDED_NEAR_ZERO) \
                            & (np.abs(gw) <= SHARDED_NEAR_ZERO) & (ga != gw)
                    masked, size = masked + int(m.sum()), size + a.size
                    if a.size > m.sum():
                        r["param_abs"] = max(r["param_abs"], float(
                            np.abs(a - w)[~m].max()))
                r["masked_share"] = max(r["masked_share"], masked / size)
        r["launches"] = {k: _lib.LAUNCHES[k] for k in SHARDED_KERNELS}
        r["loss_rel"] = max(abs(a - b_) / abs(b_)
                            for a, b_ in zip(r["card"], r["cpu"]))
        out[f"{arch} {name}"] = r
        del side
    return out


def sharded_full_width(torch, arch: str, layers: int, batch: int,
                       steps: int) -> dict:
    """Phase 21 (b), (c) and (d) on this rank: ``arch`` at full width,
    cut to ``layers`` layers, bf16 parameters and fp32 AdamW moments, at
    TP2, ``steps`` steps of ``batch`` x 2048 tokens: losses and totals,
    step times, the peak memory, TP collectives a step, the kernels'
    launches and the layers of each kind."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.modes import ParallelPlan
    from repro_torch.kernels import _lib
    from repro_torch.launch.train import train
    from repro_torch.models.transformer import stack_plan
    from repro_torch.training.checkpoint import tree_leaves

    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    kinds = [k[0] for seq_, n in stack_plan(cfg) for _ in range(n)
             for k in seq_]
    gc_collect(torch)
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    res = train(cfg, steps=steps, batch=batch, seq=2048, device="cuda",
                dtype=torch.bfloat16, plan=ParallelPlan(1, 2, 1),
                log=lambda s: None)
    out = {"losses": res.losses, "totals": res.totals,
           "step_s": res.step_s, "tokens": res.tokens_per_step,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": {k: _lib.LAUNCHES[k] for k in SHARDED_KERNELS},
           "kinds": {k: kinds.count(k) for k in set(kinds)},
           "tp_collectives": res.mesh.stats["model"].collectives / steps,
           "world_collectives": res.mesh.stats["world"].collectives / steps,
           "params_rank": sum(t.numel() for t in tree_leaves(res.params))}
    del res
    gc_collect(torch)
    return out


# phase 21's full-width runs: (tag, arch, layers, batch, steps, whether
# the loss must fall over them)
SHARDED_FULL = (("b", "llama3-8b", 4, 4, 6, True),
                ("c", "phi3.5-moe-42b-a6.6b", 2, 2, 5, True),
                ("d", "mamba2-2.7b", 2, 4, 3, False),
                ("d", "recurrentgemma-9b", 3, 4, 3, False))


def train_ranks_rank(rank: int, world: int, d: str) -> None:
    """One rank of phase 21: (a) to (d); its readings into
    ``{d}/rank{rank}.json``."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    t0 = time.perf_counter()
    res = {"a": sharded_reduced(torch)}
    res["a_s"] = time.perf_counter() - t0
    for tag, arch, layers, batch, steps, _ in SHARDED_FULL:
        t0 = time.perf_counter()
        res[f"{tag} {arch}"] = sharded_full_width(torch, arch, layers, batch,
                                                  steps)
        res[f"{tag} {arch} s"] = time.perf_counter() - t0
    with open(Path(d, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def print_sharded(tag: str, what: str, x: dict, smi: str,
                  falling: bool) -> None:
    import math
    steady = sorted(x["step_s"][1:])
    med = steady[len(steady) // 2]
    print(f"{tag}: {what}; {x['params_rank'] / 1e9:.3f} B parameters a "
          f"rank; losses " + " ".join(f"{v:.4f}" for v in x["losses"]))
    print(f"{tag}: step median {med * 1e3:.1f} ms over steps 2-"
          f"{len(x['step_s'])} (min {steady[0] * 1e3:.1f}, max "
          f"{steady[-1] * 1e3:.1f}; first {x['step_s'][0] * 1e3:.1f} ms) = "
          f"{x['tokens'] / med:.1f} tok/s; peak {x['peak_gib']:.2f} GiB a "
          f"rank; {x['tp_collectives']:.1f} TP collectives and "
          f"{x['world_collectives']:.1f} world collectives a step; "
          f"launches { {k: v for k, v in x['launches'].items() if v} }; "
          f"{smi}")
    check(all(math.isfinite(v) for v in x["losses"] + x["totals"]),
          f"{tag}: a loss is not finite")
    check(not falling or x["losses"][-1] < x["losses"][0],
          f"{tag}: loss did not decrease: {x['losses'][0]} -> "
          f"{x['losses'][-1]}")


def train_ranks(torch, np, smi: str) -> dict:
    """Phase 21: sharded training (``build_train_step`` at a plan of two
    ranks) on two rank processes sharing the card over gloo. (a) reduced
    llama3-8b and Phi-3.5-MoE in fp32 at TP2 and DP2, reduced mamba2-2.7b
    and the 4-layer RecurrentGemma at TP2, on the card and on the two
    ranks' CPUs: the losses (rtol 1e-4), the gradients before step 1 and
    the parameters (atol 1e-4; mamba2-2.7b from a common state each step
    with its near-zero gradients' elements left out, at most 1% of
    them) equal, K5, K6 and K7 launched; (b) llama3-8b at full width cut
    to 4 of 32 layers, bf16, TP2, 6 steps of 4 x 2048 tokens (10 until
    the script's run neared its time limit); (c)
    Phi-3.5-MoE at full width cut to 2 of 32 layers, bf16, TP2 (8
    experts a rank), 5 steps of 2 x 2048 tokens; (d) mamba2-2.7b (2 of
    64 layers) and recurrentgemma-9b (3 of 38) at full width, bf16, TP2,
    3 steps of 4 x 2048 tokens (K6 at 40 heads of 64, K7 at 2048
    channels, K5 at 8 heads of 256 a rank): finite losses ((b) and (c)
    falling), equal on both ranks, each kernel launched twice forward
    and once backward a layer of its kind a step on each rank. Returns
    rank 0's launches in (b) and (d) under the rows of the kernels at
    the TP2-local shapes."""
    import tempfile

    from repro_torch.launch.ranks import spawn
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        spawn(train_ranks_rank, 2, (d,), device_type="cuda", timeout=900)
        runs = []
        for r in range(2):
            with open(Path(d, f"rank{r}.json")) as f:
                runs.append(json.load(f))
    for key, x in runs[0]["a"].items():
        arch, plan = key.split()
        print(f"sharded (a): reduced {arch} fp32 at {plan} on two ranks: "
              f"card losses {x['card']}, CPU {x['cpu']}; largest relative "
              f"loss difference {x['loss_rel']:.3e}, gradients before step "
              f"1 {x['grad_abs']:.3e} apart, parameters "
              f"{x['param_abs']:.3e} apart"
              + (f" ({SHARDED_COMMON}: from the card's state each step, "
                 f"at most {x['masked_share']:.3%} of the elements left "
                 f"out)" if arch == SHARDED_COMMON else "")
              + f"; card launches "
              f"{ {k: v for k, v in x['launches'].items() if v} }")
        for r, run in enumerate(runs):
            y = run["a"][key]
            check(y["card"] == x["card"] and y["cpu"] == x["cpu"],
                  f"sharded (a) {key}: rank {r}'s losses differ")
            check(y["loss_rel"] <= 1e-4,
                  f"sharded (a) {key}: card and CPU losses differ by "
                  f"{y['loss_rel']:.3e} on rank {r}")
            check(y["grad_abs"] <= 1e-4,
                  f"sharded (a) {key}: card and CPU gradients "
                  f"{y['grad_abs']:.3e} apart on rank {r}")
            check(y["param_abs"] <= 1e-4 and y["masked_share"] <= 0.01,
                  f"sharded (a) {key}: card and CPU parameters "
                  f"{y['param_abs']:.3e} apart on rank {r} (with "
                  f"{y['masked_share']:.3%} of the elements left out)")
        want = {"llama3-8b": TRAIN_KERNELS,
                "phi3.5-moe-42b-a6.6b": TRAIN_KERNELS,
                "mamba2-2.7b": MAMBA_KERNELS,
                "recurrentgemma-9b": TRAIN_KERNELS + ("rglru_scan",
                                                      "rglru_scan_bwd")}
        for k in want[arch]:
            check(all(run["a"][key]["launches"][k] > 0 for run in runs),
                  f"sharded (a) {key}: {k} never launched")
    print(f"sharded (a): {max(run['a_s'] for run in runs):.1f} s")
    # a kernel's launches a step for each layer of a kind: its forward,
    # its recomputation under remat and one backward
    per_kind = {"flash_prefill": ("gqa", "gqa_win"),
                "ssd_scan": ("mamba",), "rglru_scan": ("rglru",)}
    for tag, arch, layers, batch, steps, falling in SHARDED_FULL:
        key = f"{tag} {arch}"
        x = runs[0][key]
        print_sharded(f"sharded ({tag})",
                      f"{arch} at full width, {layers} layers "
                      f"{x['kinds']}, bf16, TP2 on two ranks over gloo, "
                      f"{steps} steps of {batch} x 2048 tokens", x, smi,
                      falling)
        if arch == "phi3.5-moe-42b-a6.6b":
            aux = [(t - l) / 0.01 for t, l in zip(x["totals"], x["losses"])]
            print(f"sharded ({tag}): aux loss " + " ".join(f"{v:.4f}"
                                                         for v in aux))
        for r, run in enumerate(runs):
            check(run[key]["losses"] == x["losses"],
                  f"sharded ({tag}) {arch}: rank {r}'s losses differ")
            for k, kinds in per_kind.items():
                n = sum(x["kinds"].get(kind, 0) for kind in kinds) * steps
                for name, want_n in ((k, 2 * n), (k + "_bwd", n)):
                    got = run[key]["launches"][name]
                    check(got == want_n,
                          f"sharded ({tag}) {arch} rank {r}: {name} "
                          f"launched {got} times, not {want_n}")
        print(f"sharded ({tag}) {arch}: "
              f"{max(run[key + ' s'] for run in runs):.1f} s")
    print(f"sharded: {smi}; phase 21 took "
          f"{time.perf_counter() - t_phase:.1f} s")
    b = runs[0]["b llama3-8b"]["launches"]
    out = {"flash_prefill_tp2": b["flash_prefill"],
           "flash_prefill_bwd_tp2": b["flash_prefill_bwd"]}
    mamba = runs[0]["d mamba2-2.7b"]["launches"]
    rg = runs[0]["d recurrentgemma-9b"]["launches"]
    out.update({row: (mamba if k.startswith("ssd") else rg)[k]
                for row, k in SHARDED_ROWS.items()})
    return out


# ---------------------------------------------------------------------------
# phase 22: two engine tiles of two 'ed' rows on four ranks sharing the card
# ---------------------------------------------------------------------------

# Phi-3.5-MoE at full width cut to EP_LAYERS of 32 layers, fp32; its
# requests (prompts, outputs), the capacity run's decode steps, and the
# virtual arrival of (a)'s last EP_LATE requests (after the first are
# done, so that the merge goes back to 1 with nothing in flight)
EP_LAYERS = 2
EP_PROMPTS = (256, 1024)
EP_OUT = 32
EP_CHUNK = 128
EP_DECODES = 8
EP_LATE = 2
EP_LATE_S = 100.0
# the instrumented run's requests (EP_CHUNK prompt tokens each)
EP_SPLIT = 4
EP_RANKS = 4
# (d): a pool of EP_SP_BLOCKS blocks of EP_CHUNK tokens a rank (2944
# usable at tag 1) and one request of EP_SP_PROMPT tokens on an SP
# island, then EP_SP_STEPS decodes
EP_SP_BLOCKS, EP_SP_PROMPT, EP_SP_STEPS = 24, 3072, 16
# the decode ticks' prompts (16 requests; at 512 the merge-2 prefill's
# no-drop MoE buffers staged by gloo took the host past its memory)
EP_TICK = 256


def ep_config(no_drop: bool):
    """Phase 22's Phi-3.5-MoE: cut to ``EP_LAYERS`` layers, with no drop
    (``capacity_factor = num_experts / top_k``: an expert's capacity is
    then every token of the slice, and a token takes an expert once) or
    the config's own capacity factor."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=EP_LAYERS)
    cf = cfg.moe.num_experts / cfg.moe.top_k if no_drop \
        else cfg.moe.capacity_factor
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def ep_requests(n: int = 8, out: int = EP_OUT, prompts=EP_PROMPTS,
                late: int = 0):
    """``n`` requests, prompts drawn in ``prompts`` from a fixed seed,
    ``out`` tokens each; the last ``late`` arrive at EP_LATE_S, the
    others at time 0."""
    import numpy as np

    from repro_torch.core.task_pool import Request
    lens = np.random.default_rng(22).integers(prompts[0], prompts[1] + 1,
                                              n)
    return [Request(req_id=f"e{i}", arrival=EP_LATE_S if i >= n - late
                    else 0.0, prompt_len=int(p), output_len=out)
            for i, p in enumerate(lens)]


class EpDrops:
    """Wraps ``moe._moe_ep``: counts, on the card, the (token, choice)
    entries that an 'ed' rank's capacity drops in its token slice (pads
    included), one count a call."""

    def __init__(self, torch, moe):
        self.moe, self.inner = moe, moe._moe_ep
        self.calls = []

        def ffn(cfg, p, x, ctx):
            n, ep = x.shape[0] * x.shape[1], ctx.ep
            nl = -(-n // ep)
            t = x.reshape(n, -1)
            if n % ep:
                t = torch.cat([t, t.new_zeros((nl * ep - n, t.shape[1]))])
            t = t[ctx.ep_rank() * nl:(ctx.ep_rank() + 1) * nl]
            e, _, _ = moe.route(p["router"], t, cfg.moe.top_k)
            pos = moe._positions_in_expert(e.reshape(-1),
                                           cfg.moe.num_experts)
            self.calls.append(((pos >= moe.capacity(cfg, nl)).sum(),
                               nl * cfg.moe.top_k))
            return self.inner(cfg, p, x, ctx)
        moe._moe_ep = ffn

    def restore(self) -> list:
        self.moe._moe_ep = self.inner
        return [(int(d), m) for d, m in self.calls]


def ep_weights(torch, cfg, plan, rank: int, world: int):
    """The weights every engine of the tiles takes its rank's storage
    shard of, seeded on the card by each rank in turn (a barrier
    between; ``ep_full`` seeds the same tree) and moved to the host:
    four full trees at once would not fit the one card beside the
    engines, nor the host beside the ranks' gloo staging. Host tensors
    of the full shapes in which only the rank's storage slices
    (``WeightsManager.storage_shard``'s) are written: the pages of the
    others are never touched, so they take no memory, and the engine
    reads only its slices."""
    import torch.distributed as dist

    from repro_torch.core.weights_manager import (WeightsManager,
                                                  _map_with_path)
    wm = WeightsManager(cfg, plan)
    ed, model = divmod(rank % (plan.engine_rows * plan.tp_base),
                       plan.tp_base)
    index = {"ed,model": ed * plan.tp_base + model, "ed": ed,
             "model": model}

    def host(path, t):
        cuts = wm.shard_dims(path, tuple(t.shape))
        if not cuts:
            return t.cpu()
        out = torch.empty(t.shape, dtype=t.dtype)
        dst, src = out, t
        for d, k, axes in cuts:
            size = t.shape[d] // k
            dst = dst.narrow(d, index[axes] * size, size)
            src = src.narrow(d, index[axes] * size, size)
        dst.copy_(src)
        return out

    params = None
    for r in range(world):
        if r == rank:
            full = ep_full(torch, cfg)
            params = _map_with_path(host, full)
            del full
            gc_collect(torch)
        dist.barrier()
    return params


def ep_full(torch, cfg):
    """Phase 22's full weights, seeded on the card."""
    from repro_torch.models.model import build_model
    return build_model(cfg, torch.float32, "cuda").init(
        torch.Generator(device="cuda").manual_seed(0))


def ep_engine(torch, cfg, plan, params, *, num_blocks: int = 1024,
              block_base: int = 16, layout=None, bpe: int = 8):
    """A FlyingEngine over ``plan`` for phase 22 (``bpe`` rows an
    engine, by default a pool for the 8 requests) on ``params`` (of which
    it keeps the rank's storage shard on the card), and its geometry;
    the card's peak is counted from there."""
    from repro_torch.core.engine import FlyingEngine
    from repro_torch.core.kv_adaptor import PoolGeometry
    from repro_torch.models.model import build_model
    model = build_model(cfg, torch.float32, "cuda")
    geom = PoolGeometry(cfg, plan, num_blocks=num_blocks,
                        block_base=block_base)
    eng = FlyingEngine(model, plan, geom, params, batch_per_engine=bpe,
                       max_blocks_per_req=128, device="cuda",
                       check_zero_copy=True, layout=layout)
    gc_collect(torch)
    torch.cuda.reset_peak_memory_stats()
    return eng, geom


class CollectiveClock:
    """Wraps ``RankGroup``'s collectives: the host seconds each kind
    takes, the card synchronised first, so that a collective's time is
    its own (gloo's staging through the host included) and not the wait
    for the work queued before it."""

    KINDS = ("all_reduce", "all_gather", "all_to_all")

    def __init__(self, torch, views):
        self.views, self.inner = views, {}
        self.s = dict.fromkeys(self.KINDS, 0.0)
        for kind in self.KINDS:
            inner = self.inner[kind] = getattr(views.RankGroup, kind)

            def timed(group, *a, _inner=inner, _kind=kind, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _inner(group, *a, **kw)
                self.s[_kind] += time.perf_counter() - t0
                return out
            setattr(views.RankGroup, kind, timed)

    def restore(self) -> None:
        for kind, fn in self.inner.items():
            setattr(self.views.RankGroup, kind, fn)


class SplitClock(StepClock):
    """``StepClock`` that also logs, a step, the seconds a
    ``CollectiveClock`` counted in it by kind."""

    def __init__(self, eng, coll: CollectiveClock):
        super().__init__(eng)
        self.coll, self.split = coll, []

    def _step(self, kind, reqs, *a):
        s0 = dict(self.coll.s)
        dt = super()._step(kind, reqs, *a)
        self.split.append({k: v - s0[k] for k, v in self.coll.s.items()})
        return dt


def ep_serve(torch, eng, geom, plan, reqs, split: bool = False,
             policy=None, strategy: str = "hard") -> dict:
    """``reqs`` through DynamicScheduler (``strategy``, chunks of
    EP_CHUNK, ``policy``) on ``eng``, launches counted from zero:
    tokens, steps, wall, tok/s, the median decode step, all_to_all calls
    and bytes and TP collectives a step (this rank's), the merges and
    preempt_stats, K1-K4's launches and those of K2 and K4 that returned
    the LSE (the live lanes); ``split``: instrumented by a
    ``CollectiveClock``, also where a decode step's time goes (the mean
    ms of its collectives by kind and of the rest)."""
    from repro_torch.core import views
    from repro_torch.core.scheduler import DynamicScheduler, SchedulerConfig
    from repro_torch.kernels import _lib
    coll = CollectiveClock(torch, views) if split else None
    clock = SplitClock(eng, coll) if split else StepClock(eng)
    sched = DynamicScheduler(plan, geom, clock, SchedulerConfig(
        strategy=strategy, max_batch_per_group=eng.bpe,
        prefill_chunk=EP_CHUNK), policy=policy)
    for r in reqs:
        sched.submit(r)
    st = eng.pool.stats
    a2a0 = (st.calls.get("all-to-all", 0), st.nbytes.get("all-to-all", 0))
    coll0 = st.collectives
    steps0 = eng.sync_stats.steps
    gc_collect(torch)
    _lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        sched.run(max_steps=2000)
    finally:
        if coll is not None:
            coll.restore()
    eng.drain()
    torch.cuda.synchronize()
    wall = eng.pool.host_max(time.perf_counter() - t0)
    launches = {k: _lib.LAUNCHES[k] for k in SERVE_KERNELS}
    toks = {r.req_id: list(map(int, eng.generated_tokens(r.req_id)))
            for r in reqs}
    steps = eng.sync_stats.steps - steps0
    mid = sorted(dt for kind, _, dt in clock.log if kind == "decode")
    res = {"toks": toks, "launches": launches, "lse": dict(
               _lib.LSE_LAUNCHES), "wall_s": wall,
           "steps": steps, "phases": [k for k, _, _ in clock.log],
           "merges": [l.merge for l in sched.log],
           "preempt": dict(sched.preempt_stats),
           "done": sum(r.state == "done" for r in reqs),
           "tok_s": sum(map(len, toks.values())) / wall,
           "decode_ms": mid[len(mid) // 2] * 1e3 if mid else float("nan"),
           "a2a": [(st.calls.get("all-to-all", 0) - a2a0[0]) / steps,
                   (st.nbytes.get("all-to-all", 0) - a2a0[1]) / steps],
           "collectives": (st.collectives - coll0) / steps,
           "lanes": _lane_keys(eng)}
    if split:
        dec = [sp for (kind, _, _), sp in zip(clock.log, clock.split)
               if kind == "decode"]
        res["decode_split"] = {
            k: 1e3 * sum(sp[k] for sp in dec) / max(len(dec), 1)
            for k in coll.KINDS}
        res["decode_split"]["rest"] = 1e3 * sum(mid) / max(len(mid), 1) \
            - sum(res["decode_split"].values())
    return res


def _card_in_use(torch) -> float:
    """GiB in use on the whole card (every rank's), now."""
    free, total = torch.cuda.mem_get_info()
    return (total - free) / 2**30


def ep_tile_rank(rank: int, world: int, out: str) -> None:
    """One rank of phase 22 on two tiles of two 'ed' rows at
    ``ParallelPlan(2, 1, 4)`` with no drop: first EP_SPLIT requests of
    EP_CHUNK prompt tokens under HARD with the collectives timed (the split,
    instrumented), then on a new engine (a) 8 requests under LIVE, the
    merge going to 2 while decodes and a chunked prefill are in flight
    and back to 1 once nothing holds KV, for the last 2 (every weight
    and pool data_ptr held across both rebinds), then on the same
    engine fleet decode ticks at merge 1 and 2 and a tick of 16 tag-1
    riders at merge 2; (b) 8 decode steps of short requests at the
    config's own capacity factor; (d) one EP_SP_PROMPT-token request on
    a pure-SP island ``Island(0, 2, 2, sp=2)`` over pools cut below its
    context; then on rank 0 alone (c) (a)'s requests on the one-rank
    engine over the same weights, and the tile's tokens ((a) and (d))
    held against its dense forward. Writes ``{out}.{rank}.json``."""
    from unittest import mock

    import numpy as np
    import torch

    from repro_torch.core.weights_manager import _ptrs
    from repro_torch.core.modes import FleetLayout, Island, ParallelPlan
    from repro_torch.core.views import SINGLE
    from repro_torch.models import moe
    from repro_torch.models.cache import TrainBackend
    if world < EP_RANKS:
        raise ValueError(f"phase 22 runs {EP_RANKS} ranks, not {world}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    t0 = time.perf_counter()
    plan = ParallelPlan(2, 1, 4)
    cfg = ep_config(True)
    params = ep_weights(torch, cfg, plan, rank, world)
    res = {"weights_s": time.perf_counter() - t0}
    card = [_card_in_use(torch)]

    def engine(c=cfg, **kw):
        eng, geom = ep_engine(torch, c, plan, params, **kw)
        card.append(_card_in_use(torch))
        return eng, geom

    def serve(eng, geom, reqs, **kw):
        return ep_serve(torch, eng, geom, plan, reqs, **kw)

    eng, geom = engine()
    split = serve(eng, geom, ep_requests(EP_SPLIT,
                                         prompts=(EP_CHUNK, EP_CHUNK)),
                  split=True)
    del eng
    eng, geom = engine()
    st = eng.pool.stats
    res.update({"describe": eng.pool.describe(),
                "build_ms": st.group_build_s * 1e3,
                "ed_groups": st.ed_groups,
                "seat_ed": list(eng.pool.seat(
                    eng.layout.islands[0]).ed.ranks),
                "split": split})
    # (a): LIVE, merge 1 -> 2 -> 1
    ptrs = (_ptrs(eng.params), _ptrs(eng._paged(eng._pools)))
    policy = MergeWhenMixed(release_idle=True)
    res["a"] = serve(eng, geom, ep_requests(late=EP_LATE), policy=policy,
                     strategy="live")
    res["a"]["riders"] = policy.riders
    res["a"]["zero_copy"] = (_ptrs(eng.params),
                             _ptrs(eng._paged(eng._pools))) == ptrs
    res["a"]["rebind_ms"] = [dt * 1e3 for dt in eng.switch_log]
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    card.append(_card_in_use(torch))
    res["a_s"] = time.perf_counter() - t0
    # the decode ticks on (a)'s engine: 16 rows at merge 1, at merge
    # 2, and 16 tag-1 riders at merge 2
    t1 = time.perf_counter()
    res["tick1"] = decode_tick_ms(torch, eng, 1, prompt=EP_TICK, hold=False)
    res["tick2"] = decode_tick_ms(torch, eng, 2, prompt=EP_TICK, hold=False)
    res["tick_live"] = live_tick_ms(torch, eng, prompt=EP_TICK, hold=False)
    res["tick_rebind_ms"] = [dt * 1e3 for dt in eng.switch_log[2:]]
    res["tick_s"] = time.perf_counter() - t1
    del eng
    gc_collect(torch)

    # (b): the config's own capacity factor, short prompts, EP_DECODES
    # decode steps (no token check: a slice's capacity is its own)
    t1 = time.perf_counter()
    cfg_b = ep_config(False)
    eng, geom = engine(cfg_b)
    drops = EpDrops(torch, moe)
    try:
        run = serve(eng, geom, ep_requests(out=EP_DECODES + 1,
                                           prompts=(EP_CHUNK, EP_CHUNK)))
    finally:
        calls = drops.restore()
    res["b"] = {"phases": run["phases"], "calls": calls,
                "layers": cfg_b.num_layers,
                "s": time.perf_counter() - t1}
    del eng

    # (d): a context over one engine's pool on a pure-SP island
    t1 = time.perf_counter()
    # one row an engine: the island's padded rows would run the MoE too
    eng, _ = engine(num_blocks=EP_SP_BLOCKS, block_base=EP_CHUNK, bpe=1,
                    layout=FleetLayout(plan, (Island(0, 2, 2, sp=2),)))
    from repro_torch.kernels import _lib
    _lib.reset_launches()
    sp = _sp_serve(eng, EP_SP_PROMPT, EP_SP_STEPS)
    eng.drain()
    torch.cuda.synchronize()
    res["d"] = {"toks": sp["toks"], "shards": sp["shards"],
                "one_pool": sp["one_pool"], "context": sp["context"],
                "lse": dict(_lib.LSE_LAUNCHES),
                "lanes": _lane_keys(eng),
                "wall_s": time.perf_counter() - t1}
    sp_req = sp["req"]
    del eng, sp, params
    gc_collect(torch)
    res["card_gib"] = max(card)
    if rank == 0:
        # (c): the one-rank engine, its world patched to this rank alone
        # (every collective of the tiles is behind it), then the tiles'
        # tokens against its model's dense forward (phase 14 (b)'s
        # near-tie rule)
        t1 = time.perf_counter()
        one = ParallelPlan(1, 1, 1)
        with mock.patch("repro_torch.core.communicator_pool.world",
                        lambda: (0, 1)):
            # the full tree seeded anew on the card (the other ranks'
            # engines are gone): at one rank the engine's shard is it
            eng, geom = ep_engine(torch, cfg, one, ep_full(torch, cfg))
            reqs = ep_requests(late=EP_LATE)
            res["c"] = ep_serve(torch, eng, geom, one, reqs)
            res["peak1_gib"] = torch.cuda.max_memory_allocated() / 2**30

            def dense(seq):
                with torch.no_grad():
                    logits, _, _ = eng.model.forward(
                        eng.params, SINGLE, mode="train",
                        backend=TrainBackend(), tokens=seq[None])
                return logits[0].float()

            for what, runs in (("greedy", [(r, res["a"]["toks"][r.req_id])
                                           for r in reqs]),
                               ("sp_greedy", [(sp_req, res["d"]["toks"])])):
                acc = {"tokens": 0, "flips": 0, "worst": 0.0,
                       "margins": []}
                for r, gen in runs:
                    gen = np.asarray(gen, dtype=np.int64)
                    seq = np.concatenate([np.asarray(
                        eng.prompt_tokens(r)[:r.prompt_len],
                        dtype=np.int64), gen[:-1]])
                    rows = dense(torch.as_tensor(seq, device="cuda"))
                    tally_near_ties(acc, rows[r.prompt_len - 1:],
                                    torch.as_tensor(gen, device="cuda"))
                res["c"][what] = acc
        res["c_s"] = time.perf_counter() - t1
    res["rank_s"] = time.perf_counter() - t0
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(res, f)


def serve_ep_tile(torch, smi: str) -> None:
    """Phase 22: spawn EP_RANKS rank processes on the one card (gloo),
    run ``ep_tile_rank`` in each, and check and print what they
    found."""
    import tempfile

    from repro_torch.launch.ranks import spawn
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        out = str(Path(d) / "ep")
        spawn(ep_tile_rank, EP_RANKS, (out,), device_type="cuda",
              timeout=600)
        runs = []
        for r in range(EP_RANKS):
            with open(f"{out}.{r}.json") as f:
                runs.append(json.load(f))
    check_ep_tile(runs)
    print_ep_tile(runs, smi)
    print(f"ep tile: {smi}; phase 22 took {time.perf_counter() - t0:.1f} s")


def merge_runs(merges) -> list:
    """The merges a scheduler log went through, each run of equal
    merges once: ``[1, 1, 2, 2, 1]`` -> ``[1, 2, 1]``."""
    return [m for i, m in enumerate(merges) if i == 0 or m != merges[i - 1]]


def check_ep_tile(runs) -> None:
    """Phase 22's verdict over every rank's result."""
    a, d, c = runs[0]["a"], runs[0]["d"], runs[0]["c"]
    for r, res in enumerate(runs):
        eng_tile = [2 * (r // 2), 2 * (r // 2) + 1]
        check(res["seat_ed"] == eng_tile,
              f"rank {r}: 'ed' group {res['seat_ed']}, not {eng_tile}")
        x = res["a"]
        for k in ("toks", "merges", "preempt", "phases"):
            check(x[k] == a[k], f"rank {r} served another {k} than rank 0")
        check(res["split"]["toks"] == runs[0]["split"]["toks"]
              and res["d"]["toks"] == d["toks"],
              f"rank {r} streamed other tokens than rank 0")
        check(x["done"] == 8 and all(len(t) == EP_OUT
                                     for t in x["toks"].values()),
              f"rank {r}: (a) {x['done']}/8 done")
        merges = merge_runs(x["merges"])
        p = x["preempt"]
        check(merges == [1, 2, 1] and bool(x["riders"]) and
              p["live_riders"] > 0 and p["paused"] == 0 and
              p["recomputed_tokens"] == 0,
              f"rank {r}: (a) did not ride 1 -> 2 -> 1: merges {merges}, "
              f"riders {x['riders']}, {p}")
        check(x["zero_copy"], f"rank {r}: (a) moved a weight or a pool")
        check(res["d"]["context"] > res["d"]["one_pool"] and
              res["d"]["shards"] == [0, 1],
              f"rank {r}: SP run of {res['d']['context']} tokens over "
              f"pools of {res['d']['one_pool']}, shards "
              f"{res['d']['shards']}")
        for k in SERVE_KERNELS:
            check(x["launches"][k] > 0,
                  f"rank {r}: {k} never launched in (a)")
        for what, lse in (("(a)", x["lse"]), ("(d)", res["d"]["lse"])):
            check(all(lse[k] > 0 for k in ("paged_attention",
                                           "paged_flash_prefill")),
                  f"rank {r}: the live lanes of {what} never launched K2 "
                  f"and K4 with their LSE: {lse}")
        check(x["a2a"][0] > 0, f"rank {r}: no all_to_all a step")
    for what in ("greedy", "sp_greedy"):
        g = c[what]
        check(g["tokens"] > 0 and g["worst"] <= 1.0,
              f"phase 22: a tile token ({what}) is off the one-rank dense "
              f"forward's argmax by {g['worst']:.2f}x the near-tie bound "
              f"(margins {g['margins']})")


def print_ep_tile(runs, smi: str) -> None:
    """Phase 22's readings, on lines before the last."""
    a, sp, c, d = (runs[0][k] for k in ("a", "split", "c", "d"))
    same = sum(a["toks"][k] == c["toks"][k] for k in a["toks"])
    g, gs = c["greedy"], c["sp_greedy"]
    cfg = ep_config(True)
    lo, hi = EP_PROMPTS
    print(f"ep tile: {runs[0]['describe']}; 'ed' groups of ranks "
          f"{[res['seat_ed'] for res in runs]}; {EP_RANKS} ranks share "
          f"this card over gloo, host-staged")
    print(f"ep tile (a): {cfg.name}, {cfg.num_layers} layers of d_model "
          f"{cfg.d_model}, fp32, capacity factor "
          f"{cfg.moe.capacity_factor:g} (no drop), ParallelPlan(2, 1, 4), "
          f"LIVE, 8 requests of {lo}-{hi} prompt tokens and {EP_OUT} out "
          f"(the last {EP_LATE} arriving once the first are done), chunks "
          f"of {EP_CHUNK}: merges {merge_runs(a['merges'])}, "
          f"riders {a['riders']}, preempt_stats {a['preempt']}, lanes "
          f"{a['lanes']}, weight and pool data_ptrs unchanged; "
          f"{a['steps']} steps ({a['phases'].count('mixed')} mixed, "
          f"{a['phases'].count('decode')} decode) in {a['wall_s']:.3f} s, "
          f"{a['tok_s']:.1f} tok/s, decode step {a['decode_ms']:.2f} ms "
          f"(median); a step on rank 0: {a['a2a'][0]:.1f} all_to_alls of "
          f"{a['a2a'][1] / 2**20:.1f} MiB, {a['collectives']:.1f} TP "
          f"collectives; rebinds "
          f"{', '.join(f'{x:.2f}' for x in a['rebind_ms'])} ms")
    print(f"ep tile (a): K1-K4 launches a rank "
          f"{[res['a']['launches'] for res in runs]}, of them returning the "
          f"LSE (the live lanes) {[res['a']['lse'] for res in runs]}")
    t1, t2, tl = (runs[0][k] for k in ("tick1", "tick2", "tick_live"))
    print(f"ep tile: {smi}; decode tick of 16 requests of {EP_TICK} tokens "
          f"(the slowest rank's): merge 1 {t1['ms']:.2f} ms, merge 2 "
          f"{t2['ms']:.2f} ms, 16 tag-1 riders at merge 2 {tl['ms']:.2f} ms "
          f"(lanes {tl['lanes']}); TP collectives a tick on rank 0: "
          f"{t1['collectives'] / t1['steps']:.1f}, "
          f"{t2['collectives'] / t2['steps']:.1f}, {tl['collectives']:.1f}; "
          f"K2 with its LSE over the live ticks "
          f"{[res['tick_live']['lse']['paged_attention'] for res in runs]}"
          f"; the ticks' rebinds "
          f"{', '.join(f'{x:.2f}' for x in runs[0]['tick_rebind_ms'])} ms")
    print(f"ep tile, instrumented (the card synchronised before each "
          f"collective), run before (a) on an engine of its own, HARD at "
          f"merge 1: {EP_SPLIT} requests of {EP_CHUNK} prompt tokens and "
          f"{EP_OUT} out, {sp['steps']} steps in {sp['wall_s']:.3f} s, "
          f"decode step "
          f"{sp['decode_ms']:.2f} ms (median); a mean decode step's ms: "
          f"{', '.join(f'{k} {v:.2f}' for k, v in sp['decode_split'].items())}")
    print(f"ep tile (c): one-rank engine, same weights and requests: "
          f"{c['steps']} steps in {c['wall_s']:.3f} s, {c['tok_s']:.1f} "
          f"tok/s, decode step {c['decode_ms']:.2f} ms; {same}/8 requests' "
          f"tokens equal (a)'s; (a)'s {g['tokens']} tokens against the "
          f"one-rank dense forward: {g['flips']} near-ties off its argmax "
          f"(margins {[f'{x:.3g}' for x in g['margins']]}, at most "
          f"{g['worst']:.2f}x the bound of {NEAR_TIE_SD} row deviations)")
    print(f"ep tile (d): SP island Island(0, 2, 2, sp=2) served a "
          f"{d['context']}-token context over pools of {d['one_pool']} "
          f"tokens a rank (shards {d['shards']}, lanes {d['lanes']}) in "
          f"{d['wall_s']:.3f} s; K2/K4 LSE launches "
          f"{[res['d']['lse'] for res in runs]}; greedy against the dense "
          f"forward: {gs['flips']} of {gs['tokens']} near-ties (at most "
          f"{gs['worst']:.2f}x the bound)")
    for r, res in enumerate(runs):
        b = res["b"]
        per = b["layers"] * 2        # a mixed step runs two MoE calls
        steps, i = [], 0
        for kind in b["phases"]:
            n = per if kind == "mixed" else b["layers"]
            dd = sum(x for x, _ in b["calls"][i:i + n])
            m = sum(y for _, y in b["calls"][i:i + n])
            steps.append(f"{kind[0]} {dd}/{m}")
            i += n
        print(f"ep tile (b) rank {r}: capacity factor "
              f"{ep_config(False).moe.capacity_factor:g}, entries "
              f"dropped/routed a step in its 'ed' slice: {', '.join(steps)}")
    for r, res in enumerate(runs):
        print(f"ep tile rank {r}: groups built in {res['build_ms']:.1f} ms "
              f"({res['ed_groups']} 'ed' groups of their own); weights "
              f"seeded in turn in {res['weights_s']:.1f} s; peak serving (a) "
              f"{res['peak_gib']:.2f} GiB (this rank's allocations, from "
              f"its engine's build)"
              + (f", {res['peak1_gib']:.2f} GiB serving (c) on the "
                 f"one-rank engine" if r == 0 else "")
              + f"; the split and (a) {res['a_s']:.1f} s, ticks "
              f"{res['tick_s']:.1f} s, (b) {res['b']['s']:.1f} s, (d) "
              f"{res['d']['wall_s']:.1f} s"
              + (f", (c) {res['c_s']:.1f} s" if r == 0 else "")
              + f", rank {res['rank_s']:.1f} s")
    print(f"ep tile: {smi}; the card in use (every rank's allocations and "
          f"contexts, sampled after each engine's build and after (a)) at "
          f"most {max(res['card_gib'] for res in runs):.2f} GiB; the ranks' "
          f"peaks sum to {sum(res['peak_gib'] for res in runs):.2f} GiB")


def gc_collect(torch) -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def kernel_label(mangled: str) -> str:
    """``fwd_kernel<bf16, 256>`` from an Itanium-mangled kernel name in an
    (anonymous) namespace; the name itself if it is not one."""
    import re
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled[:48]
    rest = mangled[m.end() + int(m.group(1)):]
    name = None
    while True:                          # nested names: keep the last
        m = re.match(r"(\d+)", rest)
        if not m:
            break
        n = int(m.group(1))
        name, rest = rest[m.end():m.end() + n], rest[m.end() + n:]
    if name is None:
        return mangled[:48]
    args = []
    i = 1 if rest.startswith("I") else len(rest)
    while i < len(rest) and rest[i] != "E":
        m = re.match(r"(\d+)|Li(-?\d+)E|Lb([01])E", rest[i:])
        if m and m.group(1):             # a named type
            k = int(m.group(1))
            j = i + m.end()
            args.append(rest[j:j + k].replace("__nv_bfloat16", "bf16"))
            i = j + k
        elif m and m.group(2):           # an int
            args.append(m.group(2))
            i += m.end()
        elif m:                          # a bool
            args.append(("false", "true")[int(m.group(3))])
            i += m.end()
        else:                            # a builtin type
            args.append({"f": "f32"}.get(rest[i], rest[i]))
            i += 1
    return f"{name}<{', '.join(args)}>" if args else name


def print_ptxas(source: str, log: str) -> None:
    """One line per compiled kernel from nvcc's ``-Xptxas -v`` report:
    its name, registers, shared memory and spills."""
    import re
    fn, spill = "?", ""
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = kernel_label(m.group(1))
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            used = line.split(":", 1)[-1].strip()
            print(f"  {source}.cu {fn}: {used}; {spill}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is visible")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail("src/repro_torch is missing: run from a checkout of the repo")
    sys.path.insert(0, str(ROOT / "src"))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import _lib
    t0 = time.perf_counter()
    _lib.build_all(force=True)
    print(f"built {len(_lib.SOURCES)} kernel sources in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in _lib.SOURCES:
        print_ptxas(name, _lib.BUILD_LOG.get(name, ""))
    smem = _lib.func("flash_tc_smem")
    print("  flash_prefill.cu, dynamic shared memory of the bf16 kernels: "
          + ", ".join(f"{k}<{hd}> {smem(hd, i)} bytes"
                      for hd in (64, 128, 256)
                      for i, k in enumerate(("fwd_tc", "dq_tc", "dkdv_tc"))))
    smem = _lib.func("paged_prefill_tc_smem")
    print("  paged_prefill.cu, dynamic shared memory of the bf16 kernel: "
          + ", ".join(f"prefill_tc<{hd}> {smem(hd)} bytes"
                      for hd in (64, 128, 256)))
    rows = kernel_checks(torch, np)
    for r in rows:
        lib_ms = "none" if r["library_ms"] is None \
            else f"{r['library_ms']:.4f} ms"
        print(f"  {r['name']:<20} {r['ms']:.4f} ms   plain {r['plain_ms']:.4f} "
              f"ms   library {lib_ms}   bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
    if args.kernels_only:
        # the paths did not run: their launch counts are unknown
        launches = {r["name"]: None for r in rows}
    else:
        reference_check(torch)
        launches, offline = serve_full_width(torch)
        serve_breakdown(torch)
        gc_collect(torch)
        serve_http_full_width(torch, smi, offline)
        del offline
        train_reference_check(torch, np, "llama3-8b", bf16=True)
        launches.update(train_full_width(torch))
        train_reference_check(torch, np, "mamba2-2.7b")
        launches.update(train_mamba2(torch))
        train_reference_check(torch, np, "recurrentgemma-9b", layers=4,
                              bf16=True)
        launches.update(train_recurrentgemma(torch))
        gc_collect(torch)
        serve_islands(torch, smi)
        moe_reference_check(torch)
        launches.update(serve_mla_full_width(torch, smi))
        gc_collect(torch)
        launches.update(serve_striped(torch, smi))
        gc_collect(torch)
        serve_frontends(torch, np, smi)
        gc_collect(torch)
        serve_recurrent(torch, np, smi)
        gc_collect(torch)
        launches.update(serve_engine_recurrent(torch, np, smi))
        gc_collect(torch)
        serve_ranks(torch, np, smi)
        gc_collect(torch)
        launches.update(train_ranks(torch, np, smi))
        gc_collect(torch)
        serve_ep_tile(torch, smi)
    for r in rows:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(f"device: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
