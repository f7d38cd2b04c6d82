#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines and wall time, each ending in
``torch.cuda.synchronize()``; any failure exits non-zero:

1. environment and build: the card (as ``nvidia-smi`` names it, with its
   power limit), torch/CUDA versions, the ``nvcc`` build of the kernels
   from this checkout's sources, each kernel's registers and spills from
   the compiler's report, and the tensor-core instructions (HMMA, HGMMA) in
   the SASS of the bf16 ``flash_attention`` kernels and of every head-dim
   instance of the bf16 decode family's split-KV routine
   (``csrc/decode_split.cuh``) and of the bf16 ``varlen_prefill`` routine
   (``csrc/varlen_prefill_tc.cuh``) and of the chunk launches of the bf16
   ``ssd`` (``csrc/ssd_tc.cu``; ``cuobjdump``): fail unless each has some
   (HGMMA in varlen's d-128 instances), the flash and varlen kernels at
   head dim 128 and the flash kernel at head dim 80 (zamba2's, over
   ``Padded<80>`` tiles) spill nothing and no split-KV or ``ssd_tc``
   instance spills; the training backwards: 16 ``flash_bwd_`` instances
   (the 8 of the tensor-core route, dK/dV and dQ at d 16/64/80/128, each
   with HMMA and no spill), 10 ``rmsnorm_bwd``, and the 11 kernels of the
   bf16 ``ssd`` backward on the tensor cores (``csrc/ssd_bwd_tc.cu``: its
   two chunk launches at chunks 16/32/64 each with HMMA, none spilling);
2. kernels: each hand-written kernel against its plain PyTorch version at
   the shapes the serve phase gives it (glm4-9b widths: h 32, kvh 2, d 128,
   page 16, D 4096, bf16; spec_verify with 8 slots and windows of 5), the
   attention kernels on a bf16 pool and on int8 and fp8 pools, with the
   error (fail unless ``|kernel - plain| <= 2e-2 * |plain| + 2e-3 *
   rms(plain)``; the plain version with one key, one context page or one
   window row too few must fail that limit); the split-KV routine's
   splits at these shapes, each spec_verify window row bit-equal to a
   one-token ``paged_attention`` at ``len + w + 1`` on all three pools, and
   the verify windows of W 13 at glm4-9b's heads and of W 5 at
   granite-20b's 48 heads on one kv head, bf16 and float32, against their
   plain versions; ``varlen_prefill``'s bf16 plan, and the longest of the
   first 8 serve prompts prefilled whole and split at key 208 (13 context
   pages), which must give the same bits on the split part's rows;
   ``rmsnorm``'s time at the decode shape (8 rows) too; kernel, plain and library
   times (see ``_time_ms``) and the bound: the larger of bytes over
   3.35 TB/s and flops over 989 TFLOP/s, each kernel's bytes and flops from
   ``repro_torch.roofline.work``.  The dense engines' kernels
   likewise: ``flash_attention`` on a static prefill pass (q (8, 1024, 32,
   128), causal) and small cases with a window, softcap, q_offset and no
   causal mask (the plain version without key 0 must fail the limit), its
   time at a continuous admission (q (1, 1024, 32, 128)), and the longest
   of the first 8 serve prompts padded with other values to 1024 and to
   2048 tokens, and batched beside another row, which must give the same
   bits on its real rows;
   ``decode_attention`` on a decode step of 8 rows over a 2048-token cache
   at the serve lengths, and with a window and a row of length 0, which
   must be exactly zero (with ``lengths - 1`` the plain version must fail),
   and equal bit for bit to ``paged_attention`` over the cache viewed as a
   pool with the identity table;
   ``ssd`` (mamba2-130m widths: h 24, p 64, n 128, chunk 64, bf16; the
   tensor-core route's three launches) on the static prefill pass of 8
   rows of the longest of the first 8 serve prompts (a partial trailing
   chunk), a partial chunk, a sequence shorter than a chunk, an initial
   state and zamba2's state width (n 64), y and the final state each (the
   plain version without the initial state, and its final state one
   timestep short, must fail the limit; no single PyTorch call computes
   SSD, so there is no library time), its plan and blocks per launch, and
   its time at a batch-1 admission.  Then ``flash_attention``, rmsnorm
   and ``ssd`` at the shapes phase 6 gives them, bf16, batches 1 to 8 of
   128 tokens: the causal attention and norms of glm4-9b (D 4096) and of
   gemma2-27b (D 4608, softcap 50, each of its two windows), of
   qwen3-moe-30b-a3b and of zamba2-2.7b's shared block (d 80),
   mamba2-130m's and zamba2-2.7b's scans (two whole chunks, y and the final
   state, x/B/C views of one projection) and norms (d_model and the gated
   d_inner).  Then the
   rest of the dense family's shapes (``zoo_kernels_phase``, d 128):
   gemma2-27b (32 query heads on 16 kv heads, softcap 50, window 4096 on
   its local layers, GLOBAL_WINDOW on its global ones):
   flash over one 8192-token pass, timed with and without the window; a
   packed 2048-token chunk at pos0 4096 over 256 context pages; the decode
   family (``decode_attention``, ``paged_attention``, ``spec_verify`` at W
   5) over 8 contexts of 4500-6000 tokens, each with the window (the plain
   version without the window must fail the limit); gemma2-27b with each
   of its two windows, granite-20b (48 on 1) and chameleon-34b (64 on 8):
   flash on a static pass (8, 1024), a packed
   buffer of two 1024-token chunks (one over 32 context pages), the decode
   family at the serve lengths; rmsnorm at d_model 4608/6144/8192 and over
   QK-norm rows of 128; each timed beside its bound (a windowed bound
   counts the live (query, key) pairs).  Then ``flash_attention`` at
   chunked prefill's shapes (``chunked_kernels_phase``): at glm4-9b's
   heads, every first and padded last chunk that phase 4's chunked run
   gives it (a 64-token first chunk at ``q_offset`` 0; 16-, 32- and
   48-token last chunks at multiples of 64) held against plain; a 64-token
   chunk at ``q_offset`` 16, 48, 1008 and 1984 over ``q_offset + 64`` keys
   at glm4-9b's heads, at 4160 past gemma2-27b's 4096 window with each of
   its two windows and softcap 50, and at 1008 with granite-20b's 48 heads
   on one kv head, each also timed beside its bound and SDPA with the same
   mask.  Then qwen3-moe-30b-a3b's shapes (32 query heads on 4 kv heads,
   d 128, D 2048: 128 rows a 16-token page in ``varlen_prefill``) through
   the same checks and timings as glm4-9b's on a bf16 and an int8 pool
   (``kernels_phase``, ``dense_kernels_phase``), its QK-norm rows, and its
   chunked-prefill chunks.  Then zamba2-2.7b's shapes
   (``hybrid_kernels_phase``), at the left-padded lengths its engines
   give: bf16 ``flash_attention`` at head dim 80 on a static pass q (8,
   881, 32, 80), a continuous admission (1, 996) and the ring run's
   prefill (2, 6000) (the plain version without key 0 must fail the
   limit), and a 64-token q at ``q_offset`` 932; ``decode_attention`` at
   (8, S, 32, 80) off the ring (S 2048, a static and a continuous step's
   lengths) and on a full 4096-slot ring (with ``lengths - 1`` the plain
   version must fail); ``ssd`` at (8, 881, 80, 64), n 64, and the (1, 996)
   admission (the final state one timestep short must fail); rmsnorm at
   2560 and the gated 5120
   over a pass's and a step's rows; each timed beside its plain version,
   its bound and SDPA or ``F.rms_norm``.  Then whisper-large-v3's shapes
   (``whisper_kernels_phase``: 20 heads of 64 on 20 kv heads, no RoPE):
   bf16 ``flash_attention`` (mma.sync d 64) on the encoder's non-causal
   pass q (8, 1500) over its 1500 frames, the cross prefill's non-causal
   q (8, 1024) over 1500 keys (the plain version without the last key
   must fail the limit) and the decoder's causal pass (8, 1024);
   ``decode_attention`` at rep 1 over the cross cache of 1504 slots with
   1500 live keys (pad slots filled with 1e4, never read; the plain
   version at 1499 keys must fail) and over the 2048-slot self cache at a
   static step's lengths; rmsnorm at 1280 over 12000 rows and 8; each
   timed beside its plain version, its bound and SDPA or ``F.rms_norm``.
   Then the training path (``train_kernels_phase``): the forward's
   log-sum-exp against ``ref.attention_lse`` (and the forward's bits the
   same with and without it); ``flash_attention_bwd`` (dq, dk, dv) at
   glm4-9b's training shape, q (4, 1024, 32, 128) on 2 kv heads, causal,
   bf16 (the tensor-core route, its GQA splits printed; dq, dk, dv the
   same bits on two runs), at zamba2-2.7b's d 80 q (4, 1024, 32, 80) on 32
   kv heads (likewise), and on small bf16 and float32 cases with a window,
   a softcap of 2, a ``q_offset``, no causal mask, rows with no live key
   (the empty log-sum-exp, dq exactly 0), whisper's d 64 at rep 1 and
   zamba2's d 80; the plain version without key 0, and without the
   softcap's factor, must fail the limit; the glm4-9b and zamba2 shapes
   and their phase-4c microbatches (2, 1024) timed beside SDPA's backward;
   ``rmsnorm_bwd`` at 4096 and 8 rows of 4096 (dx, dw the same bits
   twice), and at phase 4c's microbatches of mamba2-130m (4096 x 768) and
   zamba2-2.7b (2048 x 2560 and its gated 5120), each beside
   ``F.rms_norm``'s backward; the training shapes timed beside their plain
   version, bound and SDPA's or ``F.rms_norm``'s backward alone; ``ssd_bwd`` (every gradient:
   dx, ddt, dA, dB, dC, the initial state's) against ``ref.ssd_bwd``, the
   sequential reverse recurrence, in bf16 on the tensor-core route at
   mamba2-130m's training shape x (8, 1024, 24, 64), n 128, zamba2-2.7b's
   (4, 1024, 80, 64), n 64, and phase 4c's microbatches, each with the
   forward's kept states as the train step calls it and once without them,
   and on small bf16 cases of that route and float32 cases (a partial
   trailing chunk, s below the chunk, an initial state, a final-state
   cotangent, B and C views of one projection, of odd width too), two calls
   the same bits; the plain chunked backward without the carried-state W
   terms, and without the reverse cumsum of dcum, must fail the limit; each
   training shape and microbatch timed with the kept states beside its
   plain version and its bound (no library call computes it);
3. check (last: ``roofline_check``, the reduced glm4-9b forward in float32
   counted on the card and on the CPU, the same FLOPs, bytes and kernel
   work): reduced glm4-9b in float32 served on the card and on the CPU
   from the same weights must emit the same greedy tokens, with and
   without speculative decoding (which must also equal each other); the
   card-vs-CPU token agreement on int8 and fp8 pools is printed.  On the
   dense engines ``generate`` and ``serve_continuous`` tokens must equal
   the CPU's and ``forward`` logits agree within 1e-4 + 1e-4 |cpu|; the
   same for reduced mamba2-130m; and for reduced gemma2-27b (window 8),
   chameleon-34b, granite-20b and deepseek-67b on prompts of 20-60 tokens,
   ``serve_paged`` with ``spec_k`` 0 and 4 as well.  The rest of
   ``serve_paged`` on reduced glm4-9b (``paged_paths_check``): chunked
   prefill, the prefix cache on shared-prefix prompts (partial and full
   hits, copy-on-write) with packed and chunked prefill, and overcommit
   on a 6-page pool (preemption): the card's tokens must equal the CPU's
   and the card's packed, cache-off and undisturbed runs, and every run's
   prompt-token ledger must balance.  The MoE family (``moe_check_phase``)
   at capacity factor 0.5, where every set of runs drops slots on both
   devices (the count is printed and must be above 0): reduced
   qwen3-moe-30b-a3b through ``serve_paged`` (packed on float32, int8 and
   fp8 pools, ``spec_k`` 4; chunked, the prefix cache on, overcommit),
   ``generate`` and ``serve_continuous``, reduced llama4-maverick (dense and
   MoE layers interleaved) through ``generate`` and ``serve_continuous``:
   tokens equal across devices (capacity routing makes a verify window, a
   chunk or a packed launch a routing group of its own, so paths that
   group tokens differently are compared and printed, not held).  The
   hybrid family (``hybrid_check_phase``): reduced zamba2-2.7b through
   ``generate`` and ``serve_continuous`` on a plain cache, and with a ring
   of 8 slots at ``max_seq`` 100000 that every prompt overflows and every
   step wraps: the card's tokens equal the CPU's.  The enc-dec family
   (``encdec_check_phase``): reduced whisper-large-v3 at ``encoder_seq``
   16 and 20 (a cross cache padded to 32 slots) over random frames:
   ``generate`` tokens equal the CPU's on a ragged and a uniform batch,
   ``forward`` logits within 1e-4 + 1e-4 |cpu|.  The paper's ResNet-50
   (``resnet_check_phase``; cuDNN's convolutions, no hand-written kernel,
   TF32 off), reduced and full at batch 2 from the same float32 weights
   (the folded norms' scales and biases random): f32 logits on the card
   within 1e-4 of the CPU's largest, bf16 on the card within 5e-2 of f32
   on the card, and the model with PyTorch's symmetric ``padding=`` must
   fail the f32 limit (JAX's "SAME" pads the odd row at the end).  The
   fault-tolerant fleet (``fleet_check``): reduced glm4-9b in float32,
   three workers behind the ``FleetRouter``, the reference's recovery
   matrix (crash, stall, drain with a fourth worker joining, a corrupted
   checkpoint before a crash; ``recovery="migrate"``) at ``spec_k`` 0 and 2
   with the prefix cache on, on a float32 and an int8 pool: every request
   completes, the card's tokens equal the CPU's and its own fault-free
   run's, each request's (status, worker, attempts) and the fleet's
   counters equal the CPU's, and the corrupt runs count a checksum failure
   and restore nothing they rejected.  Training (``train_check_phase``):
   reduced glm4-9b, qwen3-moe-30b-a3b, whisper-large-v3, mamba2-130m and
   zamba2-2.7b in float32 take 3 train steps (remat, 2 microbatches) on the
   card and on the CPU from the same masters and batches, each step's loss,
   ce, aux and grad_norm within 1e-4 relative; on the card 2 steps, a
   checkpoint through ``CheckpointManager``, a restore into fresh trees and
   2 more steps give the losses of 4 straight steps within 1e-5;
4. serve: full-width, full-depth glm4-9b (40 layers, random bf16 weights
   from a seeded CUDA generator) through ``ServingEngine.serve_paged``;
   every request must complete and every kernel must have been launched
   (counts zeroed just before the run, read just after), exactly 40
   attention and 81 rmsnorm launches per decode step and per prefill
   launch, in one run of the mix.
   Then the same mix on int8 and fp8 pools, and speculative decoding
   (``spec_k`` 4) on tiled prompts with ``spec_ngram`` 1 on each pool,
   each run counted alone: 40 spec_verify
   launches per verify step, 40 paged_attention per plain decode step, and
   more than 0 spec_verify launches in each speculative run (1-gram lookup
   drafts from any earlier occurrence of the pending token, so it finds
   drafts on random weights); token agreement with the
   bf16 plain run of the same prompts is printed.  The rest of
   ``serve_paged`` (``paged_paths_serve_phase``), each run once and
   counted alone: the mix with chunked prefill (exactly 40
   ``flash_attention`` a chunk, no ``varlen_prefill``); SharedPrefixLoad's
   prompts (a 512-token prefix shared by 75%, some prompts the prefix
   alone) with the cache off and on (saved tokens, full hits and copies
   above 0); the mix at overcommit 2.0 on 200 pages (preemptions above
   0); each with prefill tok/s, TTFT p50, peak memory and its token
   agreement with its baseline; every run's prompt-token ledger must
   balance.  Whether the bf16 differences are rounding
   (``first_token_check``): the same weights in float32 give reference
   logits; the chunked path's first-token logits must be within twice
   the static prefill's error of them, and every token where a run first
   differs from its baseline must be one that float32 separates by at most
   twice the largest bf16 error measured.  Then the dense engines
   on the same requests, one run each: the static path (Poisson
   arrivals at 20 Hz through the threaded ``RequestScheduler`` into
   ``generate`` batches of up to 8) and ``serve_continuous`` (8 slots);
   every request must complete, each run must launch exactly 40
   ``flash_attention`` and 81 rmsnorm per prefill pass, 40
   ``decode_attention`` and 81 rmsnorm per decode step and no paged
   kernel (and the paged runs neither dense kernel).  Then full-width,
   full-depth mamba2-130m (24 layers, random bf16 weights) through the
   same two dense engines on the same requests, one run each: exactly
   24 ``ssd`` and 49 rmsnorm launches per prefill pass, 0 ``ssd`` and 49
   rmsnorm per decode step, and no attention kernel;
4b. the fault-tolerant fleet at full width (``fleet_serve_phase``): phase
   4's glm4-9b model and weights shared by two workers (each its own page
   pool) behind the ``FleetRouter`` on the serve mix, KV checkpoints every
   4 decode steps: fault-free; ``crash@1:8`` with migration and with
   replay; ``corrupt@1:9,crash@1:10`` at a
   checkpoint every 8 steps (no refresh heals the bitten snapshot);
   ``stall@1:8:1.0`` past a 0.5 s lease on the host's clock (the drain at
   step 8 and the migration on an int8 pool are left to phase 3's
   ``fleet_check``, which drives both on the reduced model).  Each run
   counted alone: every request
   terminal exactly once (all complete), deaths, drains and checksum
   failures as planned, migrations in every migrate run after a fault and
   none in the replay run, fewer recomputed prompt tokens with migration
   than with replay, every harvested snapshot verifies (but the bitten
   one), one snapshot imported into a fresh pool exports the same bytes,
   ``varlen_prefill``, ``paged_attention`` and rmsnorm launch in every run
   (exactly 40 and 81 a pass in the fault-free run, over the workers'
   runs), the prompt-token ledger balances on every worker run that
   returned, and snapshot bytes a token are the pool's (40960 bf16, 21120
   int8); each run prints its token agreement with the fault-free run
   (bf16 batches differ across workers), fleet tok/s, recovery_max_s,
   bytes moved and the median ``ckpt:save`` and ``migrate:restore`` ms;
4c. train (after phase 5 frees phase 4's models; ``train_phase``), three
   models at full width, each with random float32 masters from a seeded
   CUDA generator, bf16 compute, float32 AdamW moments, remat, 2
   microbatches, 5 steps on one repeated batch of 1024-token rows: the
   loss finite and lower at the last step than at the first, and every
   step exactly its launches (``_train_expected``, no serving kernel):
   glm4-9b cut to 4 layers, 4 rows (16 ``flash_attention``, 8
   ``flash_attention_bwd``, 34 rmsnorm, 18 ``rmsnorm_bwd``); mamba2-130m,
   all 24 layers, 8 rows (96 ``ssd``, 48 ``ssd_bwd``, 194 rmsnorm, 98
   ``rmsnorm_bwd``); zamba2-2.7b cut to 12 layers (two applications of its
   shared block at head dim 80), 4 rows (48 ``ssd``, 24 ``ssd_bwd``, 8
   ``flash_attention``, 4 ``flash_attention_bwd``, 114 rmsnorm, 58
   ``rmsnorm_bwd``); each with step ms, tok/s, peak memory, and one
   profiled step's device ms by class (flash forward and backward, ``ssd``
   forward and backward, rmsnorm forward and backward, matmuls, the
   optimizer, other) with the idle share, and under 1 GiB left allocated
   after it; step 1 (outside the median) runs under the roofline counter:
   its FLOPs and bytes beside 6 N D and the share of 989 TFLOP/s at the
   median step, each kernel's counted calls equal to its launches;
5. where the time goes: device time by kernel class per prefill launch and
   per decode step, per launch of each kernel, and the device's idle
   share, from torch.profiler, for the paged engine and for a dense
   prefill pass and decode step of glm4-9b (the SSM family's ``ssd``
   launches are profiled in phase 5d, on zamba2); glm4-9b's
   same split served again under the roofline counter
   (``serve_costs_phase``): the FLOPs and bytes of a packed prefill launch
   and of a decode step beside their bounds and the profiled device ms (a
   decode step bound by bytes, at least the weights but the embedding's);
5b. the rest of the dense family at published width and depth (random
   bf16 weights, one model at a time, each set run once and counted
   alone, exactly its attention and ``_norms_per_pass`` rmsnorm launches a
   pass): gemma2-27b (46 layers; 46 + 185 a pass) through ``serve_paged``
   on the mix, a long set of prompts of 6000 and 4500 tokens (``max_seq``
   8192: past the 4096 window, over several prefill boundaries) through
   ``serve_paged``; granite-20b (52 + 105) and chameleon-34b (48 + 193)
   through ``serve_paged`` (the long set's ``generate``, granite's
   ``spec_k`` 4 run and the dense engines are left to phase 3, which drives
   them reduced); each model's peak memory and
   pool bytes per token; once gemma2-27b's names are dropped, before any
   garbage collection, under 1 GiB may stay allocated.
   deepseek-67b (125.6 GiB of bf16 weights) does not fit one card: it runs
   reduced only (phase 3);
5c. the MoE family at published width and depth: qwen3-moe-30b-a3b (48
   layers, 128 experts of d_ff 768, top 8, capacity factor 1.25; random
   bf16 weights, 61.1 GB, loaded once the earlier models are freed) on the
   serve mix, each run counted alone with exactly 48 attention and 193
   rmsnorm launches a pass and a step, at 16 new tokens a request:
   ``serve_paged`` on a bf16 pool, ``spec_k`` 4 on the first 8 tiled
   prompts beside their plain run, chunked prefill (the first 4 requests)
   (the int8 pool, the shared prefix and the dense engines are left to
   phase 4, which drives them at full width on glm4-9b); each run's
   metrics, peak memory and
   token agreement with its baseline (printed, not held); the capacity of
   each routing group; torch.profiler's device ms per packed prefill launch
   and per decode step split into the attention kernels, rmsnorm, the
   expert matmuls, the other matmuls and the MoE dispatch ops (by aten
   op), with the idle share; ``moe_decode_gather`` off and on at 8 slots
   and at 1 (``moe_gather_phase``): a decode step's device ms and
   counted FLOPs and bytes, the on run's tokens beside the off run's (first
   divergences at top-two margins of at most 2E), and reduced qwen3-moe in
   float32 on the card giving the same tokens on and off.
   llama4-maverick-400b-a17b (740.8 GiB of bf16 weights) runs reduced only
   (phase 3);
5d. the hybrid family at published width and depth: zamba2-2.7b (54
   Mamba-2 layers, a shared attention + MLP block after every 6th, 32
   heads of 80; random bf16 weights, loaded once the earlier models are
   freed), each run counted alone with exactly 9 ``flash_attention``, 54
   ``ssd`` and 127 rmsnorm launches a prefill pass and 9
   ``decode_attention`` and 127 rmsnorm a decode step: the static path and
   ``serve_continuous`` on the mix (metrics, peak memory, token
   agreement), the profile of a static prefill pass and a decode step;
   ``generate`` on the long set (6000 and 4500 tokens) at ``max_seq``
   131072, whose 4096-slot ring both prompts overflow and every step wraps
   (finite logits at every step, ``pos`` 6032, decode tok/s); one
   4000-token prompt at ``max_seq`` 8192 and 131072 (a ring that never
   wraps) must give equal tokens;
5e. the enc-dec family at published width and depth: whisper-large-v3
   (32 encoder and 32 decoder layers, 20 heads of 64, 1500 frames in a
   cross cache of 1504 slots; random bf16 weights, loaded once the
   earlier models are freed), each run counted alone with exactly 96
   ``flash_attention`` and 162 rmsnorm launches a prefill pass, 64
   ``decode_attention`` and 97 rmsnorm a decode step and no other kernel:
   the static path on the serve mix (zero frames, as the driver feeds
   them), one run (metrics, peak memory); one transcription-shaped
   ``generate`` (8 four-token prompts, 224 new tokens, random frames,
   ``max_seq`` 448); torch.profiler's split of a prefill pass (the
   encoder's flash launches against the decoder's) and of a decode step
   (self against cross ``decode_attention``), with the idle share; the
   refusals of ``serve_continuous`` and ``serve_paged``
   (``NotImplementedError``, no launch);
6. platform: the evaluation platform of ``repro_torch.core`` (server,
   agent, scenario, scheduler, the torch predictor).  Every reduced
   model (ResNet-50 on images) through the predictor on the CPU and on the
   card (its handle holding the float32 model with the CPU's weights):
   logits within 1e-4 + 1e-4 |cpu|, the same (last-position) argmax,
   FRAMEWORK logits bit-equal to MODEL.  Then
   ``LocalPlatform(backends=("torch",), reduced_models=False)`` evaluates
   full-width glm4-9b (online, batched 1/2/4/8, server at 20 Hz with a
   250 ms SLO, offline, online at FRAMEWORK and at SYSTEM) and mamba2-130m
   (online, offline), gemma2-27b, qwen3-moe-30b-a3b, zamba2-2.7b and
   whisper-large-v3 (online, online at FRAMEWORK; whisper over zero
   frames), 128
   tokens, each evaluation opening its own model (random bf16 weights,
   seed 0): each kernel must launch exactly its per-pass count (glm4-9b:
   40 ``flash_attention`` and 81 rmsnorm; mamba2-130m: 24 ``ssd`` and 49
   rmsnorm; gemma2-27b: 46 and 185; qwen3-moe-30b-a3b: 48 and 193;
   zamba2-2.7b: 9, 54 ``ssd`` and 127; whisper-large-v3: 96 and 162)
   times the evaluation's
   ``inference`` spans and no other kernel; the SYSTEM evaluation's
   ``system:cuda`` launches must add up to the per-pass counts of its
   predicts (its ``system:cost`` counting forwards, one a batch shape, add
   theirs to the counters), its device busy time (torch.profiler) must be
   above 0 with no launch's device record lost, and each predict must
   carry one ``system:cost`` event (glm4-9b's counted FLOPs printed beside
   2 N D and their share of 989 TFLOP/s); the FRAMEWORK layer spans
   must carry the reference's names (``_w4096``/``_w1073741824`` on
   gemma2's layers, ``layer_{g:03d}_shared_attn`` after zamba2's groups,
   whisper's ``enc_layer_{l:03d}`` and ``dec_layer_{l:03d}``);
   the evaldb must
   hold one record per evaluation; the report is printed.  Full ResNet-50
   (bf16, 224-pixel images through the manifest's decode/resize/normalize
   pipeline): online, batched at 1/8/32, and online and batched at
   SYSTEM, with no hand-written kernel launched (``PER_PASS`` empty); at
   each batch the median device ms of a predict (``system:cuda``), the
   platform's images/s and the forward's share of 989 TFLOP/s at 2 x its
   MACs (4.09 G an image), its counted FLOPs equal to 2 x its MACs.  Then
   the serve driver on reduced glm4-9b with ``--evaldb``: its one record
   must carry backend ``torch`` and the engine knobs;
6b. the four serving examples' torch twins (``examples/*_torch.py``) in
   this process on the card, each exiting 0, with its seconds;
7. tensor-parallel paged serving (``tp_serve_phase``), last, with this
   process holding no model: two ranks (spawned processes of one gloo
   world) share the card.  glm4-9b at full width, bf16 (16 query heads on
   1 kv head, half the columns, vocabulary and pool heads a rank) on the
   first 8 requests of the serve mix against tp 1
   served here: the first prompt's logits within
   2E (E, phase 4's largest bf16 error against float32), each request's
   first divergence at a tp-1 top-two margin of at most 2E (tp 1's
   margins printed beside 2E), every rank's launches exact, each rank's
   peak memory and pool pages, the ``tp:collective`` ledger; then
   ``spec_k`` 4 on tiled prompts whose second wave hits the prefix cache
   whole (verify steps sure to run); glm4-9b at full width cut to 2
   layers in float32 (the first prompt's logits within 1e-4 of tp 1's
   largest, first divergences only at tp-1 margins of at most twice
   that); reduced glm4-9b in float32 (tokens equal tp 1's); qwen3-moe-30b-a3b
   cut to 12 of its 48 layers (64 experts a rank), the first 8 requests.
   Phase 2 holds and times ``paged_attention``, ``spec_verify`` and
   ``varlen_prefill`` at these local heads (records ``<kernel>[tp2]``,
   whose launches are rank 0's).  Then the dry-run check: glm4-9b
   at full width, bf16, a prefill of 4 x 2048 tokens into a (4, 4096)
   cache and 8 decode steps, counted at tp 1 here and on the two ranks,
   each call against ``repro_torch.launch.dryrun``'s count of the same
   cell on the same mesh (made in two CPU processes while the card works):
   FLOPs, bytes and the collective ledger equal or the phase fails; the
   bytes each call added at its peak at most the dry run's bound (the
   reference's peak formula) + 2 MiB and within 1% + 2 MiB of its live
   peak, printed hit or miss; reduced granite-20b in float32 with its
   cache's sequence split over the two ranks (``kv_seq``) and with FSDP
   over a data axis of 2, counts equal and tokens equal tp 1's;
8. one JSON line of kernel records, then the final line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without CUDA or outside a checkout.
"""
from __future__ import annotations

import gc
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
# |kernel - plain| <= TOL * |plain| + TOL_FLOOR * rms(plain): rounding the
# output to bf16 moves it by at most 2**-7 of itself; the floor, scaled to
# the output, covers values near zero
TOL, TOL_FLOOR = 2e-2, 2e-3
L2_BYTES = 50 * 2**20           # H100 L2 cache
LAUNCHES = 24                   # calls per timing, back to back

# serve phase (and the kernel shapes it implies)
SLOTS, PAGE, MAX_SEQ, BUDGET = 8, 16, 2048, 2048
REQUESTS, PROMPT_MIN, PROMPT_MAX, NEW_TOKENS = 16, 64, 1024, 32
SEED = 0
KV_MODES = (None, "int8", "fp8")  # pool storage: bf16, or codes + f32 scales
SPEC_K = 4                      # draft depth of the speculative runs
# prompt-lookup n-gram 1: drafts from any earlier occurrence of the pending
# token, and so finds drafts on random weights
DRAFT_NGRAM = 1
WINDOW_LENS = [5, 3, 1, 0, 5, 2, 4, 5]   # spec_verify check (slot 3 idle)
# dense engines: static batches of up to SLOTS prompts right-padded to the
# power-of-two bucket of the longest (1024 once a batch holds a prompt above
# 512); Poisson arrivals and the batching window of the driver's defaults
PREFILL_LEN = 1024
RATE_HZ, BATCH_TIMEOUT_MS = 20.0, 10.0


def _phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def _done(torch, name, t0):
    torch.cuda.synchronize()
    print(f"== {name} done in {time.perf_counter() - t0:.3f} s", flush=True)


def _release(torch):
    """Free what the last phase or model left: collect reference cycles
    first (an engine or a traced frame in one would hold its model's
    gigabytes until the collector happened to run), then return the cached
    blocks to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def _sleep_cycles_per_ms(torch):
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    torch.cuda._sleep(1000)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(20_000_000)
    b.record()
    b.synchronize()
    return 20_000_000 / a.elapsed_time(b)


def _rotation(nbytes, make):
    """Input sets ``make(0), make(1), ...`` to rotate over: enough that about
    twice the L2 passes between two uses of one set, so every call finds
    its ``nbytes`` of inputs cold in memory."""
    return [make(i) for i in range(math.ceil(2 * L2_BYTES / nbytes) + 1)]


def _time_ms(torch, fn, sets, cycles_per_ms):
    """Mean device time of one call of ``fn``: ``LAUNCHES`` calls back to
    back, rotating over the input ``sets``, between one pair of CUDA events.
    A sleep kernel queued first holds the card until the host has queued
    every call, so the host's time per call (argument checks, ctypes) never
    shows as a gap between launches; the sleep grows until that holds.  A
    function that waits for the card itself (the plain ``varlen_prefill``
    reads its metadata on the host) is timed with those waits.  Returns
    (ms, whether the calls ran without host gaps)."""
    for args in sets:                   # warm-up, every set once
        fn(*args)
    torch.cuda.synchronize()
    hold_ms = 5.0
    for _ in range(4):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold_ms * cycles_per_ms))
        a.record()
        for i in range(LAUNCHES):
            fn(*sets[i % len(sets)])
        queued = not a.query()          # the card still sleeps: nothing ran yet
        b.record()
        b.synchronize()
        if queued:
            break
        hold_ms *= 4
    return a.elapsed_time(b) / LAUNCHES, queued


def _time_few(torch, fn, calls=3):
    """Mean device time of ``calls`` calls of a slow ``fn`` after one
    warm-up call, between one pair of CUDA events."""
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def _timed(torch, cpm, kernel, plain, library, sets, library_sets, plain_calls=None):
    """Kernel and plain version over ``sets``, library (None where no single
    PyTorch call computes the function) over its own.  With ``plain_calls``
    the plain version, slow at the case's shape, is timed as ``_time_few``
    takes it: that many calls on the first set, host gaps in."""
    ms, ms_q = _time_ms(torch, kernel, sets, cpm)
    if plain_calls is None:
        plain_ms, plain_q = _time_ms(torch, plain, sets, cpm)
    else:
        plain_ms, plain_q = _time_few(torch, lambda: plain(*sets[0]), plain_calls), False
    lib_ms, lib_q = (_time_ms(torch, library, library_sets, cpm) if library is not None
                     else (None, True))
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                sets=(len(sets), len(library_sets)),
                gaps=[n for n, q in (("kernel", ms_q), ("plain", plain_q),
                                     ("library", lib_q)) if not q])


def _print_records(records):
    for name, r in records.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"   {name}: kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
              f"library_ms {lib} "
              f"bound_ms {r['bound'][0]:.4f} ({r['bound'][1]}) at {r['shape']}; "
              f"{LAUNCHES} calls back to back over (kernel and plain, library) "
              f"{r['sets']} input sets; host gaps in: {r['gaps'] or 'none'}")


def _bound(w):
    """(the least ms for a kernel's work ``w``, from
    ``repro_torch.roofline.work``: the larger of its bytes over 3.35 TB/s and
    its FLOPs over 989 TFLOP/s, the H100 SXM data sheet's; what bounds it)."""
    from repro_torch.roofline import work

    return work.bound_ms(w)


def _within(torch, out, want):
    """(max |out - want|, whether out is finite and within the limit)."""
    out, want = out.float(), want.float()
    err = (out - want).abs()
    limit = TOL * want.abs() + TOL_FLOOR * float(want.pow(2).mean().sqrt())
    return float(err.max()), bool((err <= limit).all()) and bool(torch.isfinite(out).all())


def _check(torch, name, out, want):
    max_abs, ok = _within(torch, out, want)
    print(f"   {name}: max_abs_err {max_abs:.3e} "
          f"(|kernel - plain| <= {TOL}*|plain| + {TOL_FLOOR}*rms(plain), finite: {ok})")
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    return max_abs


def _rejects(torch, name, wrong, want):
    """The limit must reject a plain version that drops a little of the work:
    proof that it is tight enough to catch such a fault in the kernel."""
    max_abs, ok = _within(torch, wrong, want)
    print(f"   {name}: max_abs_err {max_abs:.3e}, rejected by the limit: {not ok}")
    if ok:
        raise SystemExit(f"{name}: the limit does not tell it from the right answer")


def _name(kernel, mode):
    return kernel if mode is None else f"{kernel}[{mode}]"


def _serve_lengths(seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return rng.integers(PROMPT_MIN, PROMPT_MAX + 1, size=REQUESTS)




def _demangle(names):
    """C++ names as ``c++filt`` reads them (unchanged where it is missing)."""
    exe = shutil.which("c++filt")
    if not names or exe is None:
        return {n: n for n in names}
    out = subprocess.run([exe], input="\n".join(names), capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {n: n for n in names}


def _ptxas_report(log):
    """{kernel: (registers, spill store bytes, spill load bytes)} from the
    ``-Xptxas -v`` report of the build."""
    report, cur, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            report[cur] = (int(m.group(1)), *spill)
    return report


def _sass_counts(nvcc, lib_path):
    """{kernel: (HMMA, HGMMA)}: tensor-core instructions in each kernel's
    SASS, from ``cuobjdump --dump-sass`` on the built library."""
    exe = Path(nvcc).parent / "cuobjdump"
    out = subprocess.run([str(exe if exe.exists() else "cuobjdump"), "--dump-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode:
        raise SystemExit(f"cuobjdump failed: {out.stderr[-2000:]}")
    counts, cur = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = [0, 0]
        elif cur and re.search(r"\bHGMMA\.", line):
            counts[cur][1] += 1
        elif cur and re.search(r"\bHMMA\.", line):
            counts[cur][0] += 1
    return {k: tuple(v) for k, v in counts.items()}


def build_report(info, nvcc):
    """Print every kernel's registers and spills, and the tensor-core
    instructions of the bf16 flash_attention kernels, of the split-KV decode
    routine, of the varlen prefill routine, of the bf16 ssd's chunk
    launches, of its backward's chunk launches and of the flash backward's
    tensor-core route; fail unless each of those has some (HGMMA for varlen
    at d 128), the flash kernels at d 128 and d 80 and the varlen kernels at
    d 128 spill nothing, no split-KV, ssd_tc, ssd_bwd_tc or tensor-core flash
    backward instance spills, and the backward instances are the expected
    ones."""
    from repro_torch.kernels import decode_split as ds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd as sdm
    from repro_torch.kernels import varlen_prefill as vpf

    ptxas = _ptxas_report(info.log)
    sass = _sass_counts(nvcc, info.path)
    names = _demangle(sorted(set(ptxas) | set(sass)))
    for mangled, (regs, st, ld) in sorted(ptxas.items(), key=lambda kv: names[kv[0]]):
        print(f"   ptxas {names[mangled]}: {regs} registers, spill stores {st} B, loads {ld} B")
    flash = {m: c for m, c in sass.items() if "flash_attention_kernel_bf16" in m}
    for mangled, (hmma, hgmma) in sorted(flash.items(), key=lambda kv: names[kv[0]]):
        print(f"   sass {names[mangled]}: HMMA {hmma}, HGMMA {hgmma}")
    if not flash or any(sum(c) == 0 for c in flash.values()):
        raise SystemExit("flash_attention bf16: no tensor-core instruction in its SASS")
    # the split-KV decode routine: every head-dim instance on the tensor
    # cores, none spilling
    split = {m: c for m, c in sass.items() if "decode_split_kernel" in m}
    for mangled, (hmma, _) in sorted(split.items(), key=lambda kv: names[kv[0]]):
        regs, st, ld = ptxas.get(mangled, (None, None, None))
        print(f"   sass {names[mangled]}: HMMA {hmma}; {regs} registers, spill stores {st} B, "
              f"loads {ld} B")
    if len(split) != 2 * len(ds.BF16_HEAD_DIMS) or any(c[0] == 0 for c in split.values()):
        raise SystemExit(f"decode_split: {len(split)} kernels in the SASS, expected "
                         f"{2 * len(ds.BF16_HEAD_DIMS)}, each with HMMA")
    spilled = [names[m] for m in split if ptxas.get(m, (0, 1, 1))[1:] != (0, 0)]
    if spilled:
        raise SystemExit(f"decode_split: spills (or no ptxas report) in {spilled}")
    # the varlen prefill tensor-core routine: every head-dim instance of both
    # pool kinds on the tensor cores (HGMMA at d 128, HMMA elsewhere), none
    # at d 128 spilling
    varlen = {m: c for m, c in sass.items()
              if "varlen_prefill_kernel_wgmma" in m or "varlen_prefill_kernel_mma" in m}
    for mangled, (hmma, hgmma) in sorted(varlen.items(), key=lambda kv: names[kv[0]]):
        regs, st, ld = ptxas.get(mangled, (None, None, None))
        print(f"   sass {names[mangled]}: HMMA {hmma}, HGMMA {hgmma}; {regs} registers, spill "
              f"stores {st} B, loads {ld} B")
    wg = {m: c for m, c in varlen.items() if "wgmma" in m}
    if (len(varlen) != 2 * len(vpf.BF16_HEAD_DIMS) or len(wg) != 2
            or any(c[1] == 0 for c in wg.values())
            or any(c[0] == 0 for m, c in varlen.items() if m not in wg)):
        raise SystemExit(f"varlen_prefill: {len(varlen)} tensor-core kernels in the SASS, expected "
                         f"{2 * len(vpf.BF16_HEAD_DIMS)}, HGMMA in the two at d 128, HMMA in "
                         f"the others")
    spilled = [names[m] for m in wg if ptxas.get(m, (0, 1, 1))[1:] != (0, 0)]
    if spilled:
        raise SystemExit(f"varlen_prefill at d 128: spills (or no ptxas report) in {spilled}")
    _, bk, rows, stages, _ = fa.BF16_TILES[128]
    targs = (bk, stages, rows // 64)            # wgmma kernel <BK, ST, warpgroups>
    at128 = [r for m, r in ptxas.items()
             if f"flash_attention_kernel_bf16_wgmma<{', '.join(map(str, targs))}>" in names[m]
             or "flash_attention_kernel_bf16_wgmmaI" + "".join(f"Li{a}E" for a in targs) in m]
    if len(at128) != 1 or at128[0][1] or at128[0][2]:
        raise SystemExit(f"flash_attention bf16 at d 128: ptxas report {at128}, expected no spill")
    # zamba2's head dim: the mma.sync kernel over Padded<80> tiles, on the
    # tensor cores and spilling nothing
    at80 = [(m, ptxas.get(m)) for m in flash if "flash_attention_kernel_bf16ILi80E" in m]
    for mangled, report in at80:
        print(f"   flash_attention bf16 at d 80 ({names[mangled]}): HMMA {flash[mangled][0]}; "
              f"registers, spill stores, loads {report}")
    if (len(at80) != 1 or flash[at80[0][0]][0] == 0 or at80[0][1] is None
            or at80[0][1][1:] != (0, 0)):
        raise SystemExit(f"flash_attention bf16 at d 80: {at80}, expected one instance with "
                         f"HMMA and no spill")
    # the bf16 ssd (csrc/ssd_tc.cu): its two chunk launches on the tensor
    # cores at every chunk instance, the state pass beside them, none spilling
    tc = {m: ptxas[m] for m in ptxas if "ssd_kernel_" in m}
    for mangled in sorted(tc, key=lambda m: names[m]):
        regs, st, ld = tc[mangled]
        print(f"   ssd_tc {names[mangled]}: HMMA {sass.get(mangled, (0, 0))[0]}; {regs} registers, "
              f"spill stores {st} B, loads {ld} B")
    chunked = [m for m in tc if "ssd_kernel_chunk_" in m]
    if (len(tc) != 3 * len(sdm.TC_CHUNKS) or len(chunked) != 2 * len(sdm.TC_CHUNKS)
            or any(sass.get(m, (0, 0))[0] == 0 for m in chunked)):
        raise SystemExit(f"ssd_tc: {len(tc)} kernels ({len(chunked)} chunk launches), expected "
                         f"{3 * len(sdm.TC_CHUNKS)} ({2 * len(sdm.TC_CHUNKS)}, each with HMMA)")
    spilled = [names[m] for m, r in tc.items() if r[1:] != (0, 0)]
    if spilled:
        raise SystemExit(f"ssd_tc: spills in {spilled}")
    # the bf16 ssd backward (csrc/ssd_bwd_tc.cu): its two chunk launches on
    # the tensor cores at every chunk instance, the state pass and the two
    # sums beside them, none of the five spilling
    btc = {m: ptxas[m] for m in ptxas if "ssd_bwd_kernel_tc_" in m}
    for mangled in sorted(btc, key=lambda m: names[m]):
        regs, st, ld = btc[mangled]
        print(f"   ssd_bwd_tc {names[mangled]}: HMMA {sass.get(mangled, (0, 0))[0]}; {regs} "
              f"registers, spill stores {st} B, loads {ld} B")
    chunked = [m for m in btc if "ssd_bwd_kernel_tc_chunk_" in m]
    if (len(btc) != 3 * len(sdm.TC_CHUNKS) + 2 or len(chunked) != 2 * len(sdm.TC_CHUNKS)
            or any(sass.get(m, (0, 0))[0] == 0 for m in chunked)):
        raise SystemExit(f"ssd_bwd_tc: {len(btc)} kernels ({len(chunked)} chunk launches), "
                         f"expected {3 * len(sdm.TC_CHUNKS) + 2} ({2 * len(sdm.TC_CHUNKS)}, each "
                         f"with HMMA)")
    spilled = [names[m] for m, r in btc.items() if r[1:] != (0, 0)]
    if spilled:
        raise SystemExit(f"ssd_bwd_tc: spills in {spilled}")
    # the training backward kernels: the flash backward's CUDA-core route
    # (D, dK/dV, dQ in bf16 and float32: 6), its tensor-core route (dK/dV and
    # dQ at each head dim of TC_TILES, each with HMMA and no spill, the
    # statistics and the split sum: 10); rmsnorm_bwd's vector kernel (1, 2, 4
    # vectors a thread), scalar kernel and dw sum, each in bf16 and float32
    # (10)
    from repro_torch.kernels import flash_attention_bwd as fbm

    bwd = {m: r for m, r in ptxas.items() if "flash_bwd_" in m or "rmsnorm_bwd" in m}
    for mangled in sorted(bwd, key=lambda m: names[m]):
        regs, st, ld = bwd[mangled]
        print(f"   backward {names[mangled]}: {regs} registers, spill stores {st} B, loads {ld} B")
    tc_bwd = [m for m in bwd if "flash_bwd_dkdv_tc_kernel" in m or "flash_bwd_dq_tc_kernel" in m]
    for mangled in sorted(tc_bwd, key=lambda m: names[m]):
        print(f"   sass {names[mangled]}: HMMA {sass.get(mangled, (0, 0))[0]}, HGMMA "
              f"{sass.get(mangled, (0, 0))[1]}")
    n_flash = sum("flash_bwd_" in m for m in bwd)
    n_tc = 2 * len(fbm.TC_TILES)
    if n_flash != 6 + n_tc + 2 or len(bwd) - n_flash != 10 or len(tc_bwd) != n_tc:
        raise SystemExit(f"backward kernels: {n_flash} flash_bwd ({len(tc_bwd)} on the tensor "
                         f"cores) and {len(bwd) - n_flash} rmsnorm_bwd instances in the ptxas "
                         f"report, expected {6 + n_tc + 2} ({n_tc}) and 10")
    bad = [names[m] for m in tc_bwd if sum(sass.get(m, (0, 0))) == 0 or bwd[m][1:] != (0, 0)]
    if bad:
        raise SystemExit(f"flash_attention_bwd tensor-core route: no HMMA/HGMMA or a spill in "
                         f"{bad}")


def kernels_phase(torch, dev, arch="glm4-9b", modes=KV_MODES, tp=1):
    """Each kernel vs its plain version at the serve phase's shapes for
    ``arch``'s heads and width, the attention kernels on a bf16 pool and on
    each int8/fp8 pool of ``modes``.  glm4-9b also holds the split-KV
    routine's verify windows at W 13 and at granite-20b's 48 heads.  With
    ``tp`` above 1 the attention kernels run at one rank's heads (``h /
    tp`` on ``kvh / tp``), their records named ``<kernel>[tp<tp>]``; the
    norms, whose widths tensor parallelism leaves whole, are not run
    again."""
    from repro_torch.configs import get_config

    bf = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev, dtype=bf)
    cl = lambda t: None if t is None else t.clone()
    cpm = _sleep_cycles_per_ms(torch)
    cfg = get_config(arch)
    h, kvh, d, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_model
    h, kvh = h // tp, kvh // tp
    rep = h // kvh
    max_pages = MAX_SEQ // PAGE
    num_pages = SLOTS * max_pages + 1
    records = {}
    timed = lambda *a: _timed(torch, cpm, *a)
    name_of = _name
    if tp > 1:
        name_of = lambda kernel, mode: f"{_name(kernel, mode)}[tp{tp}]"
        arch = f"{arch} tp {tp} (one rank's {h} heads on {kvh})"
    else:
        _rmsnorm_records(torch, dev, randn, timed, records, arch, D)
    _attention_records(torch, dev, gen, randn, cl, cpm, timed, records, arch, modes, h, kvh, d,
                       rep, max_pages, num_pages, tp, name_of)
    _print_records(records)
    return records


def _rmsnorm_records(torch, dev, randn, timed, records, arch, D):
    """rmsnorm at the serve phase's shapes (``kernels_phase``)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.roofline import work

    bf = torch.bfloat16
    # -- rmsnorm: a full packed-prefill buffer of rows (decode gives 8 rows)
    x, w = randn(1, BUDGET, D), randn(D) * 0.1
    err = 0.0
    for rows in (SLOTS, BUDGET):
        xs = x[:, :rows].contiguous()
        err = max(err, _check(torch, f"rmsnorm {arch} rows={rows}", rn.rmsnorm(xs, w),
                              ref.rmsnorm(xs, w)))
    w1 = (1.0 + w.float()).to(bf)
    nbytes = 2 * (2 * BUDGET * D + D)
    sets = _rotation(nbytes, lambda i: (x if i == 0 else x.clone(), w))
    records["rmsnorm"] = dict(
        err=err,
        **timed(rn.rmsnorm, ref.rmsnorm,
                lambda x_: F.rms_norm(x_, (D,), w1, 1e-6),
                sets, [(x_,) for x_, _ in sets]),
        bound=_bound(work.rmsnorm(BUDGET, D)),
        shape=f"{arch} x (1, {BUDGET}, {D}) bf16",
    )
    del sets
    # the decode shape: SLOTS rows, _norms_per_pass launches a decode step
    nbytes8 = 2 * (2 * SLOTS * D + D)
    sets = _rotation(nbytes8, lambda i: (x[:, :SLOTS].clone(), w))
    r8 = timed(rn.rmsnorm, ref.rmsnorm, lambda x_: F.rms_norm(x_, (D,), w1, 1e-6),
               sets, [(x_,) for x_, _ in sets])
    b8 = _bound(work.rmsnorm(SLOTS, D))
    print(f"   rmsnorm {arch} at the decode shape x (1, {SLOTS}, {D}): kernel_ms {r8['ms']:.4f} "
          f"plain_ms {r8['plain_ms']:.4f} library_ms {r8['library_ms']:.4f} bound_ms "
          f"{b8[0]:.6f} ({b8[1]}); host gaps in: {r8['gaps'] or 'none'}")
    del sets


def _attention_records(torch, dev, gen, randn, cl, cpm, timed, records, arch, modes, h, kvh, d,
                       rep, max_pages, num_pages, tp, _name):
    """paged_attention, spec_verify and varlen_prefill at the serve phase's
    shapes with ``h`` query heads on ``kvh`` (``kernels_phase``)."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_split as ds
    from repro_torch.kernels import kvquant, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import spec_verify as sv
    from repro_torch.kernels import varlen_prefill as vp
    from repro_torch.roofline import work

    bf = torch.bfloat16
    # the pools every attention kernel reads: bf16, and the same values as
    # int8/fp8 codes with float32 per-row scales
    k_pages, v_pages = randn(num_pages, PAGE, kvh, d), randn(num_pages, PAGE, kvh, d)

    def pools(mode):
        """(k, v, k_scales, v_scales, bytes per pool row and kv head, and the
        bf16 pools the library's SDPA reads: the dequantized codes)."""
        if mode is None:
            return k_pages, v_pages, None, None, 2 * d, k_pages, v_pages
        store = kvquant.pool_dtype(mode)
        (kq, ks), (vq, vs) = kvquant.quantize(k_pages, store), kvquant.quantize(v_pages, store)
        return (kq, vq, ks, vs, d + 4,
                kvquant.dequantize(kq, ks).to(bf), kvquant.dequantize(vq, vs).to(bf))

    def pool_desc(mode):
        return "bf16" if mode is None else f"{mode} + f32 scales"

    # -- paged_attention: one decode step of 8 slots at ragged lengths
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev).to(torch.int32) + 1
    table = perm[: SLOTS * max_pages].view(SLOTS, max_pages).contiguous()
    lens_host = [int(n) + NEW_TOKENS for n in _serve_lengths(SEED)[:SLOTS]]
    lengths = torch.tensor(lens_host, dtype=torch.int32, device=dev)
    bound_pages = math.ceil(max(lens_host) / PAGE)
    q = randn(SLOTS, 1, h, d)
    tb = table[:, :bound_pages]
    # SDPA yardstick on K/V gathered and expanded to the query heads (and
    # dequantized) beforehand: neither is timed
    S = bound_pages * PAGE
    gather = lambda pool, t_=tb, s_=S: (pool[t_.long()].reshape(SLOTS, s_, kvh, d)
                                        .transpose(1, 2).repeat_interleave(rep, dim=1))
    mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    live = sum(lens_host)
    for mode in modes:
        kp, vpl, ks, vs, row_bytes, k_lib, v_lib = pools(mode)
        name = _name("paged_attention", mode)
        want = ref.paged_attention(q, kp, vpl, tb, lengths, k_scales=ks, v_scales=vs)
        err = _check(torch, name,
                     pa.paged_attention(q, kp, vpl, table, lengths, pages_bound=bound_pages,
                                        k_scales=ks, v_scales=vs), want)
        if mode is None:
            _rejects(torch, "paged_attention plain with lengths - 1",
                     ref.paged_attention(q, kp, vpl, tb, lengths - 1), want)
        nbytes = (2 * 2 * SLOTS * h * d + 2 * live * kvh * row_bytes
                  + 4 * (SLOTS + SLOTS * bound_pages))
        sets = _rotation(nbytes, lambda i: (q.clone(), *map(cl, (kp, vpl, ks, vs))))
        lib_sets = _rotation(2 * 2 * SLOTS * h * S * d,
                             lambda i: (q.transpose(1, 2), gather(k_lib), gather(v_lib)))
        records[name] = dict(
            err=err,
            **timed(lambda q_, k_, v_, ks_, vs_: pa.paged_attention(
                        q_, k_, v_, table, lengths, pages_bound=bound_pages,
                        k_scales=ks_, v_scales=vs_),
                    lambda q_, k_, v_, ks_, vs_: ref.paged_attention(
                        q_, k_, v_, tb, lengths, k_scales=ks_, v_scales=vs_),
                    lambda q_, k_, v_: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=mask),
                    sets, lib_sets),
            bound=_bound(work.paged_attention(SLOTS, h, kvh, d, live, SLOTS * bound_pages,
                                              quantized=mode is not None)),
            shape=f"{arch} q ({SLOTS}, 1, {h}, {d}) bf16, pool ({num_pages}, {PAGE}, {kvh}, "
                  f"{d}) {pool_desc(mode)}, lengths {lens_host}",
        )
        del sets, lib_sets

    # -- spec_verify: one verify step of 8 slots, windows of SPEC_K + 1 at the
    #    same committed lengths, ragged window lengths, one idle slot
    W = SPEC_K + 1
    wl_host = WINDOW_LENS[:SLOTS]
    wlens = torch.tensor(wl_host, dtype=torch.int32, device=dev)
    totals = [L + n if n else 0 for L, n in zip(lens_host, wl_host)]
    spec_pages = math.ceil(max(totals) / PAGE)
    ts = table[:, :spec_pages]
    qs = randn(SLOTS, W, h, d)
    S2 = spec_pages * PAGE
    k_pos = torch.arange(S2, device=dev)[None, None, :]
    w_idx = torch.arange(W, device=dev)[None, :, None]
    smask = ((k_pos <= lengths[:, None, None] + w_idx)
             & (w_idx < wlens[:, None, None]))[:, None]      # (b, 1, W, S)
    pairs = sum(L + w + 1 for L, n in zip(lens_host, wl_host) for w in range(n))
    for mode in modes:
        kp, vpl, ks, vs, row_bytes, k_lib, v_lib = pools(mode)
        name = _name("spec_verify", mode)
        want = ref.spec_verify(qs, kp, vpl, ts, lengths, wlens, k_scales=ks, v_scales=vs)
        out = sv.spec_verify(qs, kp, vpl, table, lengths, wlens, pages_bound=spec_pages,
                             k_scales=ks, v_scales=vs)
        err = _check(torch, name, out, want)
        pad_zero = all(bool((out[b, n:] == 0).all()) for b, n in enumerate(wl_host))
        print(f"   {name}: window pad rows and the idle slot exactly zero: {pad_zero}")
        if not pad_zero:
            raise SystemExit(f"{name}: pad rows are not exactly zero")
        if mode is None:
            _rejects(torch, "spec_verify plain with window_lens - 1",
                     ref.spec_verify(qs, kp, vpl, ts, lengths, (wlens - 1).clamp_min(0)), want)
        nbytes = (2 * 2 * SLOTS * W * h * d + 2 * sum(totals) * kvh * row_bytes
                  + 4 * (2 * SLOTS + SLOTS * spec_pages))
        sets = _rotation(nbytes, lambda i: (qs.clone(), *map(cl, (kp, vpl, ks, vs))))
        lib_sets = _rotation(
            2 * 2 * SLOTS * h * S2 * d,
            lambda i: (qs.transpose(1, 2), gather(k_lib, ts, S2), gather(v_lib, ts, S2)))
        records[name] = dict(
            err=err,
            **timed(lambda q_, k_, v_, ks_, vs_: sv.spec_verify(
                        q_, k_, v_, table, lengths, wlens, pages_bound=spec_pages,
                        k_scales=ks_, v_scales=vs_),
                    lambda q_, k_, v_, ks_, vs_: ref.spec_verify(
                        q_, k_, v_, ts, lengths, wlens, k_scales=ks_, v_scales=vs_),
                    lambda q_, k_, v_: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=smask),
                    sets, lib_sets),
            bound=_bound(work.spec_verify(SLOTS, W, h, kvh, d, sum(totals), pairs,
                                          SLOTS * spec_pages, quantized=mode is not None)),
            shape=f"{arch} q ({SLOTS}, {W}, {h}, {d}) bf16, pool {pool_desc(mode)}, committed "
                  f"{lens_host}, window lens {wl_host}",
        )
        del sets, lib_sets

    # -- the split-KV routine behind both: its splits at these shapes, spec
    #    row w bit-equal to a one-token decode at len + w + 1 on every pool,
    #    and the verify windows a single block of rep * W rows refused
    pp, sp = ds.plan(bf, d, rep, 1, PAGE), ds.plan(bf, d, rep, W, PAGE)
    live_blocks = kvh * sum(-(-L // pp.split_keys) for L in lens_host)
    print(f"   split-KV routine: {pp.split_keys}-key splits; paged_attention "
          f"{ds.n_splits(pp, bound_pages, PAGE, None)} splits x {SLOTS * kvh} (slot, kv head) "
          f"blocks of {pp.rows} rows, {live_blocks} with live keys; spec_verify "
          f"{ds.n_splits(sp, spec_pages, PAGE, None)} splits, {sp.row_chunks} row chunk(s) of "
          f"{sp.rows} rows")
    one_len = lambda i, w: torch.tensor([lens_host[i] + w + 1], dtype=torch.int32, device=dev)
    for mode in modes:
        kp, vpl, ks, vs = pools(mode)[:4]
        out = sv.spec_verify(qs, kp, vpl, table, lengths, wlens, pages_bound=spec_pages,
                             k_scales=ks, v_scales=vs)
        same = all(torch.equal(out[i, w], pa.paged_attention(
                       qs[i:i + 1, w:w + 1].contiguous(), kp, vpl, table[i:i + 1].contiguous(),
                       one_len(i, w), k_scales=ks, v_scales=vs)[0, 0])
                   for i, n in enumerate(wl_host) for w in range(n))
        print(f"   {_name('spec_verify', mode)}: every window row equals a one-token "
              f"paged_attention at len + w + 1 bit for bit: {same}")
        if not same:
            raise SystemExit(f"{_name('spec_verify', mode)}: a verify row differs from decoding")
    wide_pool = randn(num_pages, PAGE, 1, d)
    windows = ((("glm4-9b heads, W 13 (spec_k 12)", (h, k_pages, 13)),
                ("granite-20b heads (48 on 1 kv head), W 5", (48, wide_pool, W)))
               if arch == "glm4-9b" and tp == 1 else ())
    for label, (hh, pool, W_) in windows:
        qw = randn(SLOTS, W_, hh, d)
        wl_w = torch.tensor([W_ if n else 0 for n in wl_host], dtype=torch.int32, device=dev)
        pages_w = math.ceil((max(lens_host) + W_) / PAGE)
        for dt in (bf, torch.float32):
            args = (qw.to(dt), pool.to(dt), pool.to(dt), table, lengths, wl_w)
            p_w = ds.plan(dt, d, hh // pool.shape[2], W_, PAGE)
            _check(torch, f"spec_verify {label}, {dt} ({p_w.kernel}: {p_w.row_chunks} row chunks "
                          f"of {p_w.rows})",
                   sv.spec_verify(*args, pages_bound=pages_w),
                   ref.spec_verify(*args[:3], table[:, :pages_w], *args[4:]))
    del wide_pool

    # -- varlen_prefill: one packed buffer of BUDGET tokens holding chunks
    #    with committed context pages, ragged tails and a buffer-tail pad
    chunk_specs = [(300, 40), (517, 0), (1, 63), (640, 12), (200, 0)]   # (take, ctx pages)
    C = SLOTS
    cu, lens_c, pos0, tables = [0], [], [], torch.zeros((C, max_pages), dtype=torch.int32)
    nxt_page = 1
    for c in range(C):
        take, ctx = chunk_specs[c] if c < len(chunk_specs) else (0, 0)
        span = -(-take // PAGE) * PAGE
        cu.append(cu[-1] + span)
        lens_c.append(take)
        pos0.append(ctx * PAGE)
        npg = ctx + -(-take // PAGE)
        tables[c, :npg] = torch.arange(nxt_page, nxt_page + npg)
        nxt_page += npg
    T = BUDGET
    if not (cu[-1] < T and nxt_page <= num_pages):
        raise SystemExit("varlen_prefill: the test layout does not fit the buffer or pool")
    qp, kp_, vpk = randn(T, h, d), randn(T, kvh, d), randn(T, kvh, d)
    meta = [torch.tensor(a, dtype=torch.int32, device=dev) for a in (cu, lens_c, pos0)]
    tables = tables.to(dev)
    ctx_bound = max(1, max(p // PAGE for p in pos0))
    real = [(cu[c] + lens_c[c], cu[c + 1]) for c in range(C)] + [(cu[-1], T)]
    # SDPA yardstick: one call over every chunk's gathered context plus the
    # packed buffer, with the block mask of the packed layout (the gather,
    # dequantization and expansion to the query heads are not timed)
    ctx_owner = []
    for c in range(C):
        ctx_owner += [c] * pos0[c]
    tok_chunk = torch.zeros(T, dtype=torch.long)
    tok_off = torch.zeros(T, dtype=torch.long)
    tok_ok = torch.zeros(T, dtype=torch.bool)
    for c in range(C):
        tok_chunk[cu[c]:cu[c + 1]] = c
        tok_off[cu[c]:cu[c + 1]] = torch.arange(cu[c + 1] - cu[c])
        tok_ok[cu[c]:cu[c] + lens_c[c]] = True
    owner = torch.tensor(ctx_owner, dtype=torch.long)
    m_ctx = (tok_chunk[:, None] == owner[None, :]) & tok_ok[:, None]
    m_in = ((tok_chunk[:, None] == tok_chunk[None, :]) & tok_ok[:, None] & tok_ok[None, :]
            & (tok_off[:, None] >= tok_off[None, :]))
    lmask = torch.cat([m_ctx, m_in], dim=1).to(dev)[None, None]
    ctx_pages = torch.cat([tables[c, : pos0[c] // PAGE] for c in range(C)]).long()

    def packed(q_, k_, v_, kpool, vpool):
        expand = lambda t: t.transpose(0, 1).repeat_interleave(rep, dim=0)[None]
        return (q_.transpose(0, 1)[None],
                expand(torch.cat([kpool[ctx_pages].reshape(-1, kvh, d), k_])),
                expand(torch.cat([vpool[ctx_pages].reshape(-1, kvh, d), v_])))

    pairs = sum(lens_c[c] * pos0[c] + lens_c[c] * (lens_c[c] + 1) // 2 for c in range(C))
    ctx_rows = sum(pos0)
    for mode in modes:
        kp, vpl, ks, vs, row_bytes, k_lib, v_lib = pools(mode)
        name = _name("varlen_prefill", mode)
        vargs = (qp, kp_, vpk, kp, vpl, *meta, tables)
        out = vp.varlen_prefill(*vargs, pages_bound=ctx_bound, k_scales=ks, v_scales=vs)
        want = ref.varlen_prefill(*vargs, pages_bound=ctx_bound, k_scales=ks, v_scales=vs)
        err = _check(torch, name, out, want)
        if mode is None:
            short = list(pos0)
            short[0] -= PAGE                     # chunk 0 sees one context page too few
            _rejects(torch, "varlen_prefill plain with one context page dropped",
                     ref.varlen_prefill(*vargs[:7],
                                        torch.tensor(short, dtype=torch.int32, device=dev),
                                        tables, pages_bound=ctx_bound), want)
        pad_zero = all(bool((out[a:b] == 0).all()) for a, b in real)
        print(f"   {name}: pad rows exactly zero: {pad_zero}")
        if not pad_zero:
            raise SystemExit(f"{name}: pad rows are not exactly zero")
        nbytes = (2 * (2 * T * h * d + 2 * T * kvh * d) + 2 * ctx_rows * kvh * row_bytes
                  + 4 * (3 * C + 1 + C * max_pages))
        sets = _rotation(nbytes, lambda i: (qp.clone(), kp_.clone(), vpk.clone(),
                                            *map(cl, (kp, vpl, ks, vs))))
        lib_sets = _rotation(2 * (T * h * d + 2 * h * (ctx_rows + T) * d),
                             lambda i: packed(qp.clone(), kp_, vpk, k_lib, v_lib))
        records[name] = dict(
            err=err,
            **timed(lambda q_, k_, v_, kpool, vpool, ks_, vs_: vp.varlen_prefill(
                        q_, k_, v_, kpool, vpool, *meta, tables, pages_bound=ctx_bound,
                        k_scales=ks_, v_scales=vs_),
                    lambda q_, k_, v_, kpool, vpool, ks_, vs_: ref.varlen_prefill(
                        q_, k_, v_, kpool, vpool, *meta, tables, pages_bound=ctx_bound,
                        k_scales=ks_, v_scales=vs_),
                    lambda q_, k_, v_: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=lmask),
                    sets, lib_sets),
            bound=_bound(work.varlen_prefill(T, h, kvh, d, list(zip(lens_c, pos0)), tables.numel(),
                                             quantized=mode is not None)),
            shape=f"{arch} T {T}, chunks (take, ctx pages) {chunk_specs} + "
                  f"{C - len(chunk_specs)} empty, {PAGE * rep} rows a page, bf16, pool "
                  f"{pool_desc(mode)}",
        )
        del sets, lib_sets
    # whole vs split: the longest of the first SLOTS serve prompts prefilled
    # as one chunk and split at page 13 (208 keys: a page boundary inside a
    # 32-key tile), its first part committed to a bf16 pool, must give the
    # same bits for the rows of the second part
    p_v = vp.plan(bf, d, rep, PAGE)
    print(f"   varlen_prefill bf16 plan at {arch}'s {rep} query heads a kv head: {p_v}")
    n = int(max(_serve_lengths(SEED)[:SLOTS]))
    cut = 13 * PAGE
    rows = [randn(n, c, d) for c in (h, kvh, kvh)]
    pages = -(-n // PAGE)
    pool = [torch.zeros((pages + 1, PAGE, kvh, d), dtype=bf, device=dev) for _ in range(2)]
    for pl, t in zip(pool, rows[1:]):
        pl.view(-1, kvh, d)[PAGE:PAGE + n] = t
    tbl = torch.arange(1, pages + 1, dtype=torch.int32, device=dev).view(1, pages)

    def one_chunk(start):
        part = [t[start:] for t in rows]
        length = n - start
        packed = [torch.cat([t, randn(BUDGET - length, t.shape[1], d)]) for t in part]
        meta = [torch.tensor(a, dtype=torch.int32, device=dev)
                for a in ([0, -(-length // PAGE) * PAGE], [length], [start])]
        return vp.varlen_prefill(*packed, *pool, *meta, tbl)[:length]

    whole, split = one_chunk(0), one_chunk(cut)
    same = torch.equal(whole[cut:], split)
    _check(torch, f"varlen_prefill one {n}-token chunk vs flash_attention's plain version", whole,
           ref.attention(rows[0][None], rows[1][None], rows[2][None])[0])
    print(f"   varlen_prefill: a {n}-token prompt whole, and split at key {cut} over {cut // PAGE} "
          f"context pages, gives the same bits on its last {n - cut} rows: {same}")
    if not same:
        raise SystemExit("varlen_prefill: a split prompt differs from the whole one")
    del rows, pool


def dense_kernels_phase(torch, dev, arch="glm4-9b"):
    """flash_attention and decode_attention against their plain versions at
    the shapes of the dense engines' serve runs with ``arch``'s heads (a
    static prefill pass of SLOTS prompts padded to PREFILL_LEN; a decode
    step of SLOTS rows over a MAX_SEQ cache at the serve phase's lengths),
    plus small cases with a window, softcap, q_offset, no causal mask and a
    row of length 0."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.roofline import work
    from repro_torch.serve.engine import bucket_pow2

    bf = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev, dtype=bf)
    cpm = _sleep_cycles_per_ms(torch)
    timed = lambda *a: _timed(torch, cpm, *a)
    cfg = get_config(arch)
    h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    rep = h // kvh
    expand = lambda t: t.transpose(1, 2).repeat_interleave(rep, dim=1)   # (b, h, s, d)
    records = {}

    # -- flash_attention: one static prefill pass, causal
    b, s = SLOTS, PREFILL_LEN
    q, k, v = randn(b, s, h, d), randn(b, s, kvh, d), randn(b, s, kvh, d)
    want = ref.attention(q, k, v)
    err = _check(torch, f"flash_attention {arch} causal", fa.flash_attention(q, k, v), want)
    # key 0 dropped from every row (row 0 then has no key at all)
    _rejects(torch, "flash_attention plain without key 0",
             ref.attention(q, k[:, 1:], v[:, 1:], q_offset=-1), want)
    del want
    qs, ks, vs = randn(2, 128, h, d), randn(2, 384, kvh, d), randn(2, 384, kvh, d)
    for opts in ({"window": 64, "q_offset": 256}, {"softcap": 30.0, "q_offset": 256},
                 {"causal": False}):
        err = max(err, _check(torch, f"flash_attention q (2, 128), k (2, 384), {opts}",
                              fa.flash_attention(qs, ks, vs, **opts),
                              ref.attention(qs, ks, vs, **opts)))
    sdpa = lambda q_, k_, v_: F.scaled_dot_product_attention(q_, k_, v_, is_causal=True)

    def flash_sets(q_, k_, v_):
        """Kernel and library input sets of a causal pass (q_ (b, s, h, d))."""
        b_, s_ = q_.shape[:2]
        nbytes = 2 * (2 * b_ * s_ * h * d + 2 * b_ * s_ * kvh * d)
        return (_rotation(nbytes, lambda i: (q_.clone(), k_.clone(), v_.clone())),
                _rotation(2 * 4 * b_ * s_ * h * d,
                          lambda i: (q_.transpose(1, 2).contiguous(), expand(k_), expand(v_))))

    sets, lib_sets = flash_sets(q, k, v)
    records["flash_attention"] = dict(
        err=err,
        **timed(fa.flash_attention, ref.attention, sdpa, sets, lib_sets),
        bound=_bound(work.flash_attention(b, s, s, h, kvh, d)),
        shape=f"{arch} q ({b}, {s}, {h}, {d}), k/v ({b}, {s}, {kvh}, {d}) bf16, causal",
    )
    del q, k, v, sets, lib_sets
    # a continuous admission: one row padded to PREFILL_LEN
    q1, k1, v1 = randn(1, s, h, d), randn(1, s, kvh, d), randn(1, s, kvh, d)
    _check(torch, "flash_attention causal, batch 1", fa.flash_attention(q1, k1, v1),
           ref.attention(q1, k1, v1))
    sets, lib_sets = flash_sets(q1, k1, v1)
    one = timed(fa.flash_attention, ref.attention, sdpa, sets, lib_sets)
    bound1 = _bound(work.flash_attention(1, s, s, h, kvh, d))
    print(f"   flash_attention {arch} at a continuous admission q (1, {s}, {h}, {d}): kernel_ms "
          f"{one['ms']:.4f} plain_ms {one['plain_ms']:.4f} library_ms {one['library_ms']:.4f} "
          f"bound_ms {bound1[0]:.4f} ({bound1[1]}); host gaps in: {one['gaps'] or 'none'}")
    del q1, k1, v1, sets, lib_sets
    # padding independence: the longest of the first SLOTS serve prompts,
    # right-padded with other values to PREFILL_LEN and to MAX_SEQ, and
    # batched beside another row, must give the same bits on its real rows
    n = int(max(_serve_lengths(SEED)[:SLOTS]))
    real = [randn(1, n, c, d) for c in (h, kvh, kvh)]
    padded = lambda length: [torch.cat([t, randn(1, length - n, t.shape[2], d)], 1) for t in real]
    rows = [fa.flash_attention(*padded(PREFILL_LEN))[0, :n]]
    rows.append(fa.flash_attention(*padded(MAX_SEQ))[0, :n])
    pair = [torch.cat([t, randn(1, MAX_SEQ, t.shape[2], d)]) for t in padded(MAX_SEQ)]
    rows.append(fa.flash_attention(*pair)[0, :n])
    same = all(torch.equal(rows[0], r) for r in rows[1:])
    print(f"   flash_attention: a {n}-token prompt padded to {PREFILL_LEN} and to {MAX_SEQ}, and "
          f"batched beside another row, gives the same bits on its real rows: {same}")
    if not same:
        raise SystemExit("flash_attention: a row's output depends on the padding or the batch")
    del real, rows, pair

    # -- decode_attention: one decode step over the dense cache
    lens_host = [int(n) + NEW_TOKENS for n in _serve_lengths(SEED)[:SLOTS]]
    lengths = torch.tensor(lens_host, dtype=torch.int32, device=dev)
    bound = bucket_pow2(max(lens_host), floor=PAGE, cap=MAX_SEQ)
    q, kc, vc = randn(SLOTS, 1, h, d), randn(SLOTS, MAX_SEQ, kvh, d), randn(SLOTS, MAX_SEQ, kvh, d)
    want = ref.decode_attention(q, kc, vc, lengths, kv_bound=bound)
    err = _check(torch, f"decode_attention {arch} kv_bound {bound}",
                 da.decode_attention(q, kc, vc, lengths, kv_bound=bound), want)
    _rejects(torch, "decode_attention plain with lengths - 1",
             ref.decode_attention(q, kc, vc, lengths - 1, kv_bound=bound), want)
    with_zero = lengths.clone()
    with_zero[3] = 0
    out = da.decode_attention(q, kc, vc, with_zero, window=100, kv_bound=bound)
    err = max(err, _check(torch, "decode_attention window 100, row 3 of length 0", out,
                          ref.decode_attention(q, kc, vc, with_zero, window=100, kv_bound=bound)))
    zero = bool((out[3] == 0).all())
    print(f"   decode_attention: the row of length 0 exactly zero: {zero}")
    if not zero:
        raise SystemExit("decode_attention: a row of length 0 is not exactly zero")
    # bf16 runs paged_attention's split-KV routine over the cache viewed as
    # a pool: the same bits as paged_attention over the identity table
    kp, vp_, pages, _ = da.pool_view(kc, vc, bound)
    tbl = da.identity_table(SLOTS, MAX_SEQ // da.BLOCK_K, dev)
    same = torch.equal(da.decode_attention(q, kc, vc, lengths, kv_bound=bound),
                       pa.paged_attention(q, kp, vp_, tbl, lengths, pages_bound=pages))
    print(f"   decode_attention kv_bound {bound} == paged_attention over the identity table "
          f"({pages} of {tbl.shape[1]} pages a row): {same}")
    if not same:
        raise SystemExit("decode_attention: differs from paged_attention over the same keys")
    live = sum(lens_host)
    nbytes = 2 * 2 * SLOTS * h * d + 2 * 2 * live * kvh * d + 4 * SLOTS
    sets = _rotation(nbytes, lambda i: (q.clone(), kc.clone(), vc.clone()))
    mask = (torch.arange(bound, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    lib_sets = _rotation(2 * 2 * SLOTS * h * bound * d,
                         lambda i: (q.transpose(1, 2).contiguous(), expand(kc[:, :bound]),
                                    expand(vc[:, :bound])))
    records["decode_attention"] = dict(
        err=err,
        **timed(lambda q_, k_, v_: da.decode_attention(q_, k_, v_, lengths, kv_bound=bound),
                lambda q_, k_, v_: ref.decode_attention(q_, k_, v_, lengths, kv_bound=bound),
                lambda q_, k_, v_: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=mask),
                sets, lib_sets),
        bound=_bound(work.decode_attention(SLOTS, h, kvh, d, live)),
        shape=f"{arch} q ({SLOTS}, 1, {h}, {d}), cache ({SLOTS}, {MAX_SEQ}, {kvh}, {d}) "
              f"bf16, lengths {lens_host}, kv_bound {bound}",
    )
    del sets, lib_sets
    _print_records(records)
    return records


def ssd_kernels_phase(torch, dev):
    """ssd against its plain version at mamba2-130m widths: the static
    prefill pass (SLOTS rows of the longest of the first SLOTS serve
    prompts: 13 full chunks and a partial one), a partial trailing chunk, a
    sequence shorter than a chunk, an initial state and zamba2's state
    width (n 64); y and the final state each.  dt and A span the ranges
    mamba2's inits give."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as sd
    from repro_torch.roofline import work

    cfg = get_config("mamba2-130m")
    h, p, n, chunk = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    cpm = _sleep_cycles_per_ms(torch)

    def inputs(b, s, init, n_=n):
        randn = lambda *shape, dt_=torch.bfloat16: torch.randn(shape, generator=gen, device=dev,
                                                               dtype=dt_)
        uniform = lambda shape, lo, hi: torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo
        x, B, C = randn(b, s, h, p), randn(b, s, n_), randn(b, s, n_)
        dt, A = uniform((b, s, h), 1e-3, 1e-1), -uniform((h,), 1.0, 16.0)
        return x, dt, A, B, C, (randn(b, h, p, n_, dt_=torch.float32) if init else None)

    pl = sd.plan(torch.bfloat16, p, n, chunk)
    s_pass = int(max(_serve_lengths(SEED)[:SLOTS]))
    s1 = int(max(_serve_lengths(SEED)))
    print(f"   ssd plan (bf16, p {p}, n {n}, chunk {chunk}): {pl.kernel}, {pl.head_group} heads a "
          f"block, shared memory per launch {pl.smem_bytes} B; blocks per launch "
          f"{sd.blocks(pl, SLOTS, s_pass, h, p, n, chunk)} at the static pass, "
          f"{sd.blocks(pl, 1, s1, h, p, n, chunk)} at a batch-1 admission (1, {s1}); workspace "
          f"{sd.workspace_bytes(pl, SLOTS, s_pass, h, p, n, chunk) / 1e6:.1f} MB / "
          f"{sd.workspace_bytes(pl, 1, s1, h, p, n, chunk) / 1e6:.1f} MB")
    err = 0.0
    for label, b, s, init, n_ in (("static pass", SLOTS, s_pass, False, n),
                                  ("partial trailing chunk", 2, 100, False, n),
                                  ("s < chunk", 2, 40, False, n),
                                  ("initial state", 2, 130, True, n),
                                  ("zamba2 state width", 2, 150, True, 64)):
        x, dt, A, B, C, s0 = inputs(b, s, init, n_)
        y, sf = sd.ssd(x, dt, A, B, C, chunk=chunk, initial_state=s0, return_state=True)
        y_want, sf_want = ref.ssd(x, dt, A, B, C, initial_state=s0, return_state=True)
        shape = f"({b}, {s}, {h}, {p}), n {n_}, chunk {chunk}"
        err = max(err, _check(torch, f"ssd {label} {shape}: y", y, y_want),
                  _check(torch, f"ssd {label}: final state", sf, sf_want))
        if label == "initial state":
            _rejects(torch, "ssd plain without the initial state", ref.ssd(x, dt, A, B, C), y_want)
        if label == "static pass":
            short = ref.ssd(x[:, :-1], dt[:, :-1], A, B[:, :-1], C[:, :-1], return_state=True)[1]
            _rejects(torch, "ssd plain final state one timestep short", short, sf_want)
            pass_inputs = (x, dt, A, B, C)
    x, dt, A, B, C = pass_inputs
    b, s = SLOTS, s_pass
    w = work.ssd(b, s, h, p, n, chunk)
    sets = _rotation(w.bytes, lambda i: (x.clone(), dt.clone(), A, B.clone(), C.clone()))
    records = {"ssd": dict(
        err=err,
        **_timed(torch, cpm,
                 lambda *a: sd.ssd(*a, chunk=chunk, return_state=True),
                 lambda *a: ref.ssd(*a, return_state=True), None, sets, []),
        bound=_bound(w),
        shape=f"x ({b}, {s}, {h}, {p}) bf16, B/C n {n}, chunk {chunk}, final state out",
    )}
    del sets
    # a continuous admission: one row of the longest serve prompt
    one = inputs(1, s1, False)[:5]
    w1 = work.ssd(1, s1, h, p, n, chunk)
    nbytes1 = w1.bytes
    ms1, _ = _time_ms(torch, lambda *a: sd.ssd(*a, chunk=chunk, return_state=True),
                      _rotation(nbytes1, lambda i: tuple(t.clone() for t in one)), cpm)
    # the plain version is a sequential loop of ~0.3 s a call: a few calls
    plain1 = _time_few(torch, lambda: ref.ssd(*one, return_state=True))
    bound1 = _bound(w1)
    print(f"   ssd at a batch-1 admission x (1, {s1}, {h}, {p}): kernel_ms {ms1:.4f} "
          f"plain_ms {plain1:.4f} bound_ms {bound1[0]:.4f} ({bound1[1]}; {nbytes1} bytes) "
          f"(blocks per launch {sd.blocks(pl, 1, s1, h, p, n, chunk)} on the card's 132 SMs)")
    _print_records(records)
    return records


def _tiled_requests(n, lo, hi, new_tokens, vocab, seed):
    """Repetitive prompts, as ``benchmarks/bench_spec.py`` makes them: a
    short random phrase (3-5 tokens) tiled to a length uniform in
    ``[lo, hi]``, the document-grounded text that prompt lookup drafts
    from."""
    import numpy as np

    from repro_torch.serve.engine import ServeRequest

    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        phrase = rng.integers(0, vocab, (int(rng.integers(3, 6)),))
        length = int(rng.integers(lo, hi + 1))
        prompt = np.tile(phrase, length // len(phrase) + 1)[:length].astype(np.int32)
        reqs.append(ServeRequest(request_id=i, prompt=prompt, max_new_tokens=new_tokens))
    return reqs


def _agreement(want, got):
    """(tokens equal position by position, tokens in all, the first
    divergence as (request, index) at the smallest index, or None)."""
    import numpy as np

    same = total = 0
    first = None
    for i, (a, b) in enumerate(zip(want, got)):
        a, b = np.asarray(a), np.asarray(b)
        n = min(len(a), len(b))
        eq = a[:n] == b[:n]
        same += int(eq.sum())
        total += len(a)
        if not eq.all() or len(a) != len(b):
            at = int(np.argmin(eq)) if not eq.all() else n
            if first is None or at < first[1]:
                first = (i, at)
    return same, total, first


def _fmt_repeats(results, n=3):
    """How repetitive the greedy streams are: prompt lookup drafts only
    from a repeat of the last ``n`` tokens."""
    distinct = [len(set(r.tokens.tolist())) for r in results]
    repeating = sum(
        1 for r in results
        if len({tuple(r.tokens[i:i + n]) for i in range(len(r.tokens) - n + 1)})
        < len(r.tokens) - n + 1)
    return (f"distinct tokens per request {min(distinct)}-{max(distinct)} of "
            f"{len(results[0].tokens)}, requests repeating a {n}-gram {repeating}/{len(results)}")


def _fmt_agreement(want, got):
    same, total, first = _agreement(want, got)
    where = "none" if first is None else f"request {first[0]} token {first[1]}"
    return f"{same}/{total} tokens equal, first divergence: {where}"


class _DropCounter:
    """While active, counts the slots each device's MoE layers drop: every
    ``moe_apply`` call's routing (``moe_route``) is recomputed from its
    inputs and its ranks at or past the capacity counted, by device type."""

    def __enter__(self):
        from repro_torch.models import lm
        from repro_torch.models import modules as mod

        self.dropped, self.calls = {}, {}
        self._lm, self._real = lm, lm.moe_apply

        def spy(p, x, cfg, need_aux=True, **kw):
            b, s, _ = x.shape
            idx = mod.moe_route(p, x, cfg)[2]
            pos = mod._positions_in_expert(idx.reshape(b, -1), cfg.num_experts)
            key = x.device.type
            self.dropped[key] = self.dropped.get(key, 0) + int(
                (pos >= mod.moe_capacity(cfg, s)).sum())
            self.calls[key] = self.calls.get(key, 0) + 1
            return self._real(p, x, cfg, need_aux, **kw)

        lm.moe_apply = spy
        return self

    def __exit__(self, *exc):
        self._lm.moe_apply = self._real
        return False

    def require(self, label):
        """Print the counts; fail unless both devices dropped slots."""
        print(f"      {label}: MoE slots dropped (calls) by device: "
              + ", ".join(f"{k} {self.dropped[k]} ({self.calls[k]})" for k in sorted(self.calls)))
        if not (self.dropped.get("cpu", 0) > 0 and self.dropped.get("cuda", 0) > 0):
            raise SystemExit(f"{label}: no slot dropped; the check does not reach capacity")


def _reduced(arch, cf=None):
    """The reduced config of ``arch``, at capacity factor ``cf`` if given."""
    from repro_torch.configs import get_config

    cfg = get_config(arch, reduced=True)
    return cfg if cf is None else cfg.replace(capacity_factor=cf)


def check_phase(torch, dev, arch="glm4-9b", prompt_min=5, cf=None):
    """Reduced ``arch`` in float32 (at capacity factor ``cf`` if given): the
    card's greedy tokens equal the CPU's, plain and speculative, and
    speculative equals plain (prompts of ``prompt_min``-60 tokens); card vs
    CPU on int8 and fp8 pools is printed.  A MoE model routes a verify
    window as its own group, so where it drops slots speculative tokens
    need not equal plain ones: that agreement is printed, not held."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import DecoderLM
    from repro_torch.serve.engine import ServingEngine

    cfg = _reduced(arch, cf)
    cpu_model = DecoderLM(cfg, device="cpu", dtype=torch.float32)
    cpu_params = cpu_model.init(seed=SEED)
    gpu_model = DecoderLM(cfg, device=dev, dtype=torch.float32)
    gpu_params = _to_device(cpu_params, dev)
    plain_reqs = lambda: make_requests(6, prompt_min, 60, 8, cfg.vocab_size, SEED)
    tiled_reqs = lambda: _tiled_requests(6, max(16, prompt_min), 60, 16, cfg.vocab_size, SEED)
    runs = {}
    for kv_dtype in KV_MODES:
        for name, model, params in (("cpu", cpu_model, cpu_params),
                                    ("cuda", gpu_model, gpu_params)):
            engine = ServingEngine(model, params, max_batch=3, max_seq=96, page_size=PAGE,
                                   device=model.device, kv_dtype=kv_dtype)
            runs[name, kv_dtype, 0] = engine.serve_paged(plain_reqs(), prefill_budget=64)
            if kv_dtype is None:
                for k in (0, SPEC_K):
                    runs[name, "tiled", k] = engine.serve_paged(
                        tiled_reqs(), prefill_budget=64, spec_k=k, spec_ngram=1)
    tok = lambda key: [r.tokens for r in runs[key].results]
    same = lambda a, b: _agreement(tok(a), tok(b))[2] is None
    plain_ok = same(("cpu", None, 0), ("cuda", None, 0))
    print(f"   reduced {arch} f32{_cf_label(cfg)}, 6 requests: cuda tokens == cpu tokens: "
          f"{plain_ok}")
    spec = runs["cuda", "tiled", SPEC_K]
    exact = cfg.family != "moe"
    spec_vs_plain = same(("cuda", "tiled", 0), ("cuda", "tiled", SPEC_K))
    spec_ok = (same(("cpu", "tiled", SPEC_K), ("cuda", "tiled", SPEC_K))
               and (spec_vs_plain or not exact)
               and same(("cpu", "tiled", 0), ("cuda", "tiled", 0)))
    print(f"   reduced {arch} f32, 6 tiled prompts, spec_k {SPEC_K}: cuda spec tokens == cpu "
          f"spec tokens, cuda == cpu plain" + (" == cuda spec" if exact else "") + f": {spec_ok}; "
          f"cuda {spec.spec_stats}"
          + ("" if exact else f"; spec vs plain (printed, not held): "
             f"{_fmt_agreement(tok(('cuda', 'tiled', 0)), tok(('cuda', 'tiled', SPEC_K)))}"))
    if not plain_ok:
        raise SystemExit(f"{arch}: the card's greedy tokens differ from the CPU reference")
    if not spec_ok:
        raise SystemExit(f"{arch}: speculative tokens differ from the CPU's or from plain decoding")
    if not spec.spec_stats["spec_launches"]:
        raise SystemExit(f"{arch}: the reduced speculative check ran no verify step")
    for mode in KV_MODES[1:]:
        print(f"   reduced {arch} f32, {mode} pool, card vs CPU: "
              f"{_fmt_agreement(tok(('cpu', mode, 0)), tok(('cuda', mode, 0)))}")


def dense_check_phase(torch, dev, arch="glm4-9b", prompt_min=5, cf=None, ring=None):
    """Reduced ``arch`` in float32 (at capacity factor ``cf`` if given) on
    the dense engines: the card's greedy tokens from ``generate`` and
    ``serve_continuous`` equal the CPU's (prompts of ``prompt_min``-60
    tokens), and ``forward`` logits agree.  With ``ring`` (the hybrid
    family) the config's ``long_context_window`` is ``ring`` and the
    engines' ``max_seq`` REDUCED_RING_MAX_SEQ, so the shared attention runs
    on a ring of ``ring`` slots that every prompt overflows."""
    import numpy as np

    from repro_torch.launch.serve import make_requests
    from repro_torch.models import DecoderLM
    from repro_torch.serve.engine import ServingEngine

    cfg = _reduced(arch, cf)
    max_seq = 96
    if ring is not None:
        cfg = cfg.replace(name=f"{cfg.name} (ring of {ring})", long_context_window=ring)
        max_seq = REDUCED_RING_MAX_SEQ
    cpu_model = DecoderLM(cfg, device="cpu", dtype=torch.float32)
    cpu_params = cpu_model.init(seed=SEED)
    gpu_model = DecoderLM(cfg, device=dev, dtype=torch.float32)
    gpu_params = _to_device(cpu_params, dev)
    reqs = make_requests(6, prompt_min, 60, 8, cfg.vocab_size, SEED)
    prompts = [r.prompt for r in reqs]
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(0, cfg.vocab_size, (2, 48)))
    out = {}
    for name, model, params in (("cpu", cpu_model, cpu_params), ("cuda", gpu_model, gpu_params)):
        engine = ServingEngine(model, params, max_batch=3, max_seq=max_seq, page_size=PAGE,
                               device=model.device)
        static = np.concatenate([engine.generate(prompts[i:i + 3], 8).tokens for i in (0, 3)])
        cont = engine.serve_continuous(make_requests(6, prompt_min, 60, 8, cfg.vocab_size, SEED))
        logits, _ = model.forward(params, {"tokens": tokens.to(model.device)})
        out[name] = (static, [r.tokens for r in cont.results], logits.cpu())
    static_ok = bool((out["cpu"][0] == out["cuda"][0]).all())
    cont_ok = _agreement(out["cpu"][1], out["cuda"][1])[2] is None
    diff = float((out["cpu"][2] - out["cuda"][2]).abs().max())
    logits_ok = bool(torch.allclose(out["cuda"][2], out["cpu"][2], rtol=1e-4, atol=1e-4))
    print(f"   {cfg.name} f32{_cf_label(cfg)}, 6 requests: generate cuda tokens == cpu "
          f"tokens: {static_ok}; "
          f"serve_continuous cuda == cpu: {cont_ok}; forward logits {tuple(out['cpu'][2].shape)} "
          f"max |cuda - cpu| {diff:.3e} (within 1e-4 + 1e-4 |cpu|: {logits_ok}); "
          f"continuous == generate on the card: "
          f"{_agreement(list(out['cuda'][0]), out['cuda'][1])[2] is None}")
    if not (static_ok and cont_ok and logits_ok):
        raise SystemExit(f"{cfg.name}: the dense engines on the card differ from the CPU reference")


def _cf_label(cfg):
    return f", capacity factor {cfg.capacity_factor}" if cfg.family == "moe" else ""


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(v, fn) for v in tree]
    return fn(tree)


def _to_device(tree, dev):
    return _tree_map(tree, lambda t: t.to(dev))


# the end-to-end metrics this script prints, as the driver defines them
# (repro_torch.launch.serve.static_metrics / engine_metrics)
SERVE_KEYS = ("prefill_tok_per_s", "decode_tok_per_s", "decode_step_ms", "ttft_p50_ms",
              "ttft_p99_ms", "wall_s")


def _serve_metrics(m):
    return {k: m[k] for k in SERVE_KEYS}


def _fmt_metrics(m, stats):
    return (f"prefill {stats.prefill_launches} launches, {stats.prefill_tokens} tokens, "
            f"{m['prefill_tok_per_s']:.1f} tok/s; decode {stats.steps} steps, "
            f"{m['decode_tok_per_s']:.1f} tok/s, mean step {m['decode_step_ms']:.3f} ms; "
            f"ttft p50 {m['ttft_p50_ms']:.1f} ms, p99 {m['ttft_p99_ms']:.1f} ms; "
            f"wall {m['wall_s']:.3f} s")


def _norms_per_pass(cfg):
    """rmsnorm launches of one pass (prefill launch or pass, decode step):
    per layer ln1 and ln2 (a mamba block: ln and its gated norm), the two
    post-norms and QK-norm's q and k where the config has them, a hybrid
    model's shared block's ln1 and ln2 after each group, then the final
    norm (glm4-9b 81, mamba2-130m 49, gemma2-27b 185, granite-20b 105,
    chameleon-34b 193, zamba2-2.7b 127); an enc-dec model's decoder: ln1,
    ln2 and ln3 a layer, then the final norm (whisper-large-v3 97; its
    prefill pass adds the encoder's, ``_encoder_norms``)."""
    if cfg.family == "encdec":
        return 3 * cfg.num_layers + 1
    shared = 2 * _groups(cfg)
    return (2 + 2 * cfg.post_norms + 2 * cfg.qk_norm) * cfg.num_layers + shared + 1


def _encoder_norms(cfg):
    """rmsnorm launches of an enc-dec model's encoder (every prefill pass):
    ln1 and ln2 a layer, then enc_norm (whisper-large-v3 65); 0 for the
    decoder-only families."""
    return 2 * cfg.encoder_layers + 1 if cfg.family == "encdec" else 0


def _groups(cfg):
    """The hybrid family's groups (one shared attention block each); 0 for
    the other families."""
    return cfg.num_layers // cfg.hybrid_attn_every if cfg.family == "hybrid" else 0


def _expected_launches(stats, cfg):
    """Launches each kernel must show for one serve run: ``_norms_per_pass``
    rmsnorm per pass (prefill launch or decode step), one attention per
    layer and pass of its kind (verify steps launch spec_verify, plain steps
    paged_attention; a packed prefill launch varlen_prefill, a chunk of
    chunked prefill flash_attention)."""
    num_layers = cfg.num_layers
    verify = int(stats.spec_stats.get("spec_launches", 0))
    prefill = "flash_attention" if stats.prefill_mode == "chunked" else "varlen_prefill"
    return {
        "rmsnorm": _norms_per_pass(cfg) * (stats.steps + stats.prefill_launches),
        "paged_attention": num_layers * (stats.steps - verify),
        "spec_verify": num_layers * verify,
        prefill: num_layers * stats.prefill_launches,
    }


def _zero(counters):
    for mod in counters.values():
        mod.launches = 0


def _check_counts(label, counters, expect, done, total):
    """Fail unless every request completed and each kernel launched exactly
    as often as the run's passes imply."""
    counts = {name: mod.launches for name, mod in counters.items()}
    if done != total:
        raise SystemExit(f"{label}: only {done} of {total} requests completed")
    for name, n in counts.items():
        if n != expect.get(name, 0):
            raise SystemExit(f"{label}: {n} {name} launches, expected {expect.get(name, 0)}")
    return counts


def _completed(token_lists, vocab, new_tokens=NEW_TOKENS):
    """Requests that hold ``new_tokens`` tokens, all inside the vocabulary."""
    return sum(1 for t in token_lists if len(t) == new_tokens and all(0 <= x < vocab for x in t))


def _check_ledger(label, stats):
    """Every prompt token admitted was prefilled, served from the prefix
    cache, or dropped by a preemption, and counted once."""
    if stats.prompt_tokens_admitted != (stats.prefill_tokens + stats.saved_prefill_tokens
                                        + stats.prefill_tokens_dropped):
        raise SystemExit(f"{label}: the prompt-token ledger does not balance")


def _counted_serve(torch, engine, reqs, counters, need, **kw):
    """One serve run with the launch counts zeroed just before and read just
    after; fails unless every request completed, every count is what the
    run's steps imply, the prompt-token ledger balances, and every kernel in
    ``need`` launched."""
    _zero(counters)
    stats = engine.serve_paged(reqs, num_slots=SLOTS, page_size=PAGE, prefill_budget=BUDGET,
                               **kw)
    _check_ledger("serve_paged", stats)
    done = _completed([r.tokens for r in stats.results if r.status == "completed"],
                      engine.model.cfg.vocab_size, reqs[0].max_new_tokens)
    counts = _check_counts("serve_paged", counters,
                           _expected_launches(stats, engine.model.cfg), done, len(reqs))
    missing = [name for name in need if counts[name] == 0]
    if missing:
        raise SystemExit(f"serve_paged: no launch of {missing} in a run that needs them")
    return stats, counts


def full_model(torch, dev, arch="glm4-9b"):
    """``arch`` at published width and depth, random bf16 weights from a
    seeded CUDA generator."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, count_params

    cfg = get_config(arch)
    model = build_model(cfg, device=dev, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = model.init(seed=SEED)
    torch.cuda.synchronize()
    n_params = count_params(model.param_defs())
    layers = (f"{cfg.encoder_layers} + {cfg.num_layers}" if cfg.family == "encdec"
              else cfg.num_layers)
    print(f"   {cfg.name}: {layers} layers, {n_params / 1e9:.3f} B params, "
          f"bf16 weights {n_params * 2 / 1e9:.2f} GB, init {time.perf_counter() - t0:.1f} s")
    return model, params


def serve_phase(torch, dev, counters, model, params):
    from repro_torch.kernels import kvquant
    from repro_torch.launch.serve import engine_metrics, make_requests
    from repro_torch.serve.engine import ServingEngine

    cfg = model.cfg
    engines = {
        mode: ServingEngine(model, params, max_batch=SLOTS, max_seq=MAX_SEQ, page_size=PAGE,
                            device=dev, kv_dtype=mode)
        for mode in KV_MODES
    }
    engine = engines[None]
    # warm-up (cuBLAS handles, allocator, each pool type and the verify
    # step) on two short requests, not counted
    for mode, eng in engines.items():
        for k in (0, SPEC_K):
            eng.serve_paged(_tiled_requests(2, 16, 32, 6, cfg.vocab_size, SEED + 1),
                            prefill_budget=BUDGET, spec_k=k, spec_ngram=1)
    reqs = make_requests(REQUESTS, PROMPT_MIN, PROMPT_MAX, NEW_TOKENS, cfg.vocab_size, SEED)
    if [len(r.prompt) for r in reqs] != list(_serve_lengths(SEED)):
        raise SystemExit("serve prompts differ from the lengths the kernel phase used")
    torch.cuda.reset_peak_memory_stats(dev)
    plain_need = ("rmsnorm", "paged_attention", "varlen_prefill")
    stats, counts = _counted_serve(torch, engine, reqs, counters, plain_need)
    print(f"   requests {len(reqs)} (prompts {PROMPT_MIN}-{PROMPT_MAX}, {NEW_TOKENS} new), "
          f"completed {len(stats.results)}, slots {SLOTS}, page {PAGE}, max_seq {MAX_SEQ}, "
          f"budget {BUDGET}, pool pages {stats.num_pages}, "
          f"kv bytes/token {stats.kv_bytes_per_token:.0f}, peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    print(f"   run: {_fmt_metrics(_serve_metrics(engine_metrics(stats)), stats)}; "
          f"{_fmt_repeats(stats.results)}")
    print(f"   launches: {counts}")
    launches = {name: counts[name] for name in plain_need}

    # speculative decoding on tiled prompts, and int8/fp8 pools: each run
    # counted alone, tokens held against the bf16 plain run of its prompts
    tiled = _tiled_requests(REQUESTS, PROMPT_MIN, PROMPT_MAX, NEW_TOKENS, cfg.vocab_size, SEED)
    base_tiled = engine.serve_paged(tiled, num_slots=SLOTS, page_size=PAGE,
                                    prefill_budget=BUDGET)
    print(f"   tiled prompts, bf16 plain: "
          f"{_fmt_metrics(engine_metrics(base_tiled), base_tiled)}; "
          f"{_fmt_repeats(base_tiled.results)}")
    bf16_bytes = kvquant.kv_bytes_per_token(cfg.num_layers, cfg.num_kv_heads,
                                            cfg.resolved_head_dim, "bfloat16")
    # spec_k with spec_ngram 1 on every pool
    plan = []
    for mode in KV_MODES:
        plan += [(mode, 0)] if mode else []
        plan += [(mode, SPEC_K)]
    for mode, k in plan:
        prompts, base = (tiled, base_tiled) if k else (reqs, stats)
        need = plain_need if not k else ("rmsnorm", "varlen_prefill", "spec_verify")
        st, cnt = _counted_serve(torch, engines[mode], prompts, counters, need,
                                 spec_k=k, spec_ngram=DRAFT_NGRAM)
        label = f"{mode or 'bf16'} pool, " + (
            f"spec_k {k} spec_ngram {DRAFT_NGRAM}, tiled prompts" if k
            else "plain, the mix's prompts")
        want_bytes = bf16_bytes if mode is None else kvquant.kv_bytes_per_token(
            cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim, mode)
        print(f"   {label}: {_fmt_metrics(engine_metrics(st), st)}")
        print(f"      spec_stats {st.spec_stats or 'off'}; pool bytes/token "
              f"{st.kv_bytes_per_token:.0f} (bf16 {bf16_bytes}); launches {cnt}; vs bf16 "
              f"plain: {_fmt_agreement([r.tokens for r in base.results], [r.tokens for r in st.results])}")
        if st.kv_bytes_per_token != want_bytes:
            raise SystemExit(f"{label}: {st.kv_bytes_per_token} pool bytes per token, "
                             f"expected {want_bytes}")
        for name in need:
            if name != "rmsnorm":
                launches.setdefault(_name(name, mode), cnt[name])
    return launches, engine, reqs, stats


def _dense_expected(model, passes, steps):
    """Launches a dense-engine run of ``passes`` prefill passes and
    ``steps`` decode steps must show: ``_norms_per_pass`` rmsnorm per pass
    and per step;
    per layer one flash_attention per pass and one decode_attention per step
    (dense family), or one ssd per pass and none per step (SSM family, whose
    decode step is plain torch); the hybrid family the SSM family's, plus
    per group (its shared attention) one flash_attention per pass and one
    decode_attention per step; the enc-dec family per pass its encoder's
    layers' and each decoder layer's self and cross flash_attention and
    ``_encoder_norms`` more rmsnorm, per step two decode_attention a
    decoder layer (whisper-large-v3: 96 flash_attention and 162 rmsnorm a
    pass, 64 decode_attention and 97 rmsnorm a step).  Every other kernel:
    none."""
    cfg = model.cfg
    L = cfg.num_layers
    expect = {"rmsnorm": _norms_per_pass(cfg) * (passes + steps) + _encoder_norms(cfg) * passes}
    if cfg.family == "encdec":
        expect.update(flash_attention=(cfg.encoder_layers + 2 * L) * passes,
                      decode_attention=2 * L * steps)
    elif model.stateful:
        expect["ssd"] = L * passes
        G = _groups(model.cfg)
        if G:
            expect.update(flash_attention=G * passes, decode_attention=G * steps)
    else:
        expect.update(flash_attention=L * passes, decode_attention=L * steps)
    return expect


def dense_serve_phase(torch, dev, counters, model, params, continuous=True):
    """``model`` through the dense engines: the static path (Poisson
    arrivals, the threaded scheduler batching ``generate``) and (unless
    ``continuous`` is False: the enc-dec family, which it refuses)
    ``serve_continuous``, one run each on the serve phase's requests,
    each counted alone (``_dense_expected``): for glm4-9b 40
    flash_attention and 81 rmsnorm launches per prefill pass, 40
    decode_attention and 81 rmsnorm per decode step; for mamba2-130m 24 ssd
    and 49 rmsnorm per pass, 49 rmsnorm per step; for zamba2-2.7b 9
    flash_attention, 54 ssd and 127 rmsnorm per pass, 9 decode_attention and
    127 rmsnorm per step; no other kernel."""
    from repro_torch.core.workload import PoissonLoad
    from repro_torch.launch.serve import engine_metrics, make_requests, serve_static, static_metrics
    from repro_torch.serve.engine import ServingEngine

    cfg = model.cfg
    vocab = cfg.vocab_size
    engine = ServingEngine(model, params, max_batch=SLOTS, max_seq=MAX_SEQ, page_size=PAGE,
                           device=dev)
    reqs = make_requests(REQUESTS, PROMPT_MIN, PROMPT_MAX, NEW_TOKENS, vocab, SEED)
    prompts = [r.prompt for r in reqs]
    arrivals = [r.arrival_s for r in PoissonLoad(REQUESTS, RATE_HZ, seed=SEED).requests()]
    # warm-up (allocator, cuBLAS handles, the scheduler thread), not counted
    warm = make_requests(2, 16, 32, 4, vocab, SEED + 1)
    serve_static(engine, [r.prompt for r in warm], [0.0, 0.0], 4, BATCH_TIMEOUT_MS,
                 log=lambda _: None)
    if continuous:
        engine.serve_continuous(warm, num_slots=SLOTS)
    launches, tokens = {}, {}
    # the SSM and hybrid families left-pad to the exact longest prompt of
    # each batch or admission set; the dense family right-pads to the pow2
    # bucket
    pad = ("left-padded to the batch's longest" if model.stateful
           else "right-padded to the batch bucket")
    cont_len = max(len(p) for p in prompts) if model.stateful else PREFILL_LEN
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _zero(counters)
    run = serve_static(engine, prompts, arrivals, NEW_TOKENS, BATCH_TIMEOUT_MS,
                       log=lambda _: None)
    passes = len(run.batches)
    steps = passes * NEW_TOKENS
    counts = _check_counts(f"{cfg.name} static run", counters,
                           _dense_expected(model, passes, steps),
                           _completed(run.tokens, vocab), len(reqs))
    m = _serve_metrics(static_metrics(run))
    print(f"   static run: batches {[bt[0] for bt in run.batches]}, prefill passes "
          f"{passes} ({sum(bt[1] for bt in run.batches)} prompt tokens, {pad}), decode "
          f"steps {steps}; "
          + ", ".join(f"{k} {v:.3f}" for k, v in m.items()) + f"; launches {counts}")
    launches.update(counts)
    tokens["static"] = run.tokens
    if continuous:
        _zero(counters)
        st = engine.serve_continuous(reqs, num_slots=SLOTS)
        counts = _check_counts(f"{cfg.name} continuous run", counters,
                               _dense_expected(model, len(reqs), st.steps),
                               _completed([r.tokens for r in st.results], vocab),
                               len(reqs))
        m = _serve_metrics(engine_metrics(st))
        print(f"   continuous run: {len(reqs)} admissions (batch-1 prefills padded to "
              f"{cont_len}), decode steps {st.steps}, mean slot occupancy "
              f"{st.mean_slot_occupancy:.2f}; " + ", ".join(f"{k} {v:.3f}" for k, v in m.items())
              + f"; launches {counts}")
        tokens["continuous"] = [r.tokens for r in st.results]
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"   peak device memory {peak / 1e9:.2f} GB, {(peak - resident) / 1e9:.2f} GB above "
          f"the {resident / 1e9:.2f} GB resident before the runs"
          + (f"; continuous vs static tokens (bf16, other batch shapes): "
             f"{_fmt_agreement(tokens['static'], tokens['continuous'])}" if continuous else ""))
    return launches, engine, prompts, tokens


_CLASSES = (
    ("flash_attention", ("flash_attention_kernel",)),
    ("decode_attention", ("decode_attention_kernel",)),
    ("paged_attention", ("paged_attention_kernel",)),
    ("spec_verify", ("spec_verify_kernel",)),
    ("varlen_prefill", ("varlen_prefill_kernel",)),
    ("ssd", ("ssd_kernel",)),
    ("rmsnorm", ("rmsnorm_kernel",)),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")),
)


def _kernel_class(name, split_class):
    """The class of a device kernel by name; the bf16 decode family's
    split-KV routine (``decode_split_kernel`` and its combine) is reported
    under ``split_class``, the kernel of the engine being profiled."""
    if "decode_split" in name:
        return split_class
    for cls, keys in _CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


# a MoE model's classes: its expert products (the ``torch.bmm`` calls inside
# ``moe_apply``) and the rest of its dispatch (router softmax, top-k sort,
# ranks, index writes and gathers, the combine's ``torch.matmul``) apart from
# the other matmuls (projections, router, head) and the other ops
MOE_CLASSES = ("expert_matmul", "moe_dispatch")


def _moe_split(prof, split_class, by_class):
    """Move the kernels launched under the ``moe_apply`` range out of their
    classes by name (``by_class``, device ms, updated in place): those a
    direct ``aten::bmm`` launched (the three expert products) to
    ``expert_matmul``; the router's ``aten::mm`` stays a matmul; the rest
    (the combine's ``aten::bmm`` under ``aten::matmul`` among them) to
    ``moe_dispatch``.  The hand-written kernels, which no aten op launches,
    keep their classes.  Returns the dispatch's device ms by the aten op
    that launched it."""
    by_class.update({cls: 0.0 for cls in MOE_CLASSES})
    ops = {}
    for e in prof.events():
        if not e.kernels:
            continue
        chain, p = [], e
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        if "moe_apply" not in chain:
            continue
        op = next((n for n in chain if n.startswith("aten::")), e.name)
        moe_cls = ("expert_matmul" if "aten::bmm" in chain and "aten::matmul" not in chain
                   else "matmul" if "aten::mm" in chain else "moe_dispatch")
        for k in e.kernels:
            cls = _kernel_class(k.name, split_class)
            ms = k.duration / 1e3
            by_class[cls] -= ms
            by_class[moe_cls] += ms
            if moe_cls == "moe_dispatch":
                ops[op] = ops.get(op, 0.0) + ms
    return ops


def _profiled(torch, fn, split_class, moe=False):
    """Run ``fn()`` under torch.profiler; (its result, wall ms, device ms
    per kernel class, the split-KV routine's under ``split_class``, and
    device ms and launches of each ``ssd`` kernel by name).  With ``moe``
    each ``moe_apply`` call runs inside a profiler range, its kernels are
    classed by ``_moe_split``, and the last item is the MoE dispatch's
    device ms by aten op instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import lm

    real = lm.moe_apply
    if moe:
        def ranged(*a, **kw):
            with record_function("moe_apply"):
                return real(*a, **kw)
        lm.moe_apply = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            stats = fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        lm.moe_apply = real
    by_class = {cls: 0.0 for cls, _ in _CLASSES}
    by_class["other"] = 0.0
    ssd_kernels = {}
    for e in prof.key_averages():
        # the moe_apply range's device-side span is no kernel
        if e.device_type != DeviceType.CUDA or e.key == "moe_apply":
            continue
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        cls = _kernel_class(e.key, split_class)
        by_class[cls] += float(us) / 1e3
        if cls == "ssd":
            m = re.search(r"ssd_kernel\w*(<[^>]*>)?", e.key)
            ssd_kernels[m.group(0) if m else e.key] = (float(us) / 1e3, e.count)
    if moe:
        return stats, wall_ms, by_class, _moe_split(prof, split_class, by_class)
    return stats, wall_ms, by_class, ssd_kernels


def profile_phase(torch, engine, reqs):
    """Where the time goes: the first SLOTS serve requests run twice under
    torch.profiler, once with one new token (prefill launches only) and once
    with 16 (the same prefill plus 15 decode steps); decode = the
    difference.  Host and profiler overhead count as device idle time.  A
    MoE model's expert matmuls and dispatch ops are classed apart."""
    from repro_torch.serve.engine import ServeRequest

    runs = {}
    moe = engine.model.cfg.family == "moe"
    for new in (1, 16):
        sub = [ServeRequest(r.request_id, r.prompt, new) for r in reqs[:SLOTS]]
        runs[new] = _profiled(torch, lambda: engine.serve_paged(
            sub, num_slots=SLOTS, page_size=PAGE, prefill_budget=BUDGET), "paged_attention",
            moe=moe)
    (s1, w1, c1, ops1), (s16, w16, c16, ops16) = runs[1], runs[16]
    if sum(c16.values()) <= 0:
        print("   profiler saw no device time: breakdown not measured")
        return None
    fmt = lambda d, n: ", ".join(f"{k} {v / n:.3f}" for k, v in d.items())
    busy1 = sum(c1.values())
    print(f"   prefill only: {s1.prefill_launches} launches, {s1.prefill_tokens} tokens; per "
          f"launch wall {w1 / s1.prefill_launches:.3f} ms, device busy "
          f"{busy1 / s1.prefill_launches:.3f} ms (idle {1 - busy1 / w1:.3f}); "
          f"device ms per launch: {fmt(c1, s1.prefill_launches)}")
    steps = s16.steps
    dec = {k: c16[k] - c1[k] for k in c16}
    busy = sum(dec.values())
    wall = w16 - w1
    print(f"   decode: {steps} steps of {SLOTS} slots; per step wall {wall / steps:.3f} ms, "
          f"device busy {busy / steps:.3f} ms (idle {1 - busy / wall:.3f}); "
          f"device ms per step: {fmt(dec, steps)}")
    # the same classes per launch: a check on phase 2's event timings
    L, norms = engine.model.cfg.num_layers, _norms_per_pass(engine.model.cfg)
    n1 = s1.prefill_launches
    print(f"   device ms per kernel launch: varlen_prefill {c1['varlen_prefill'] / (L * n1):.4f}, "
          f"rmsnorm at {BUDGET} rows {c1['rmsnorm'] / (norms * n1):.4f}, "
          f"paged_attention {dec['paged_attention'] / (L * steps):.4f}, "
          f"rmsnorm at {SLOTS} rows {dec['rmsnorm'] / (norms * steps):.4f}")
    if moe:
        top = lambda ops, n: ", ".join(f"{k} {v / n:.3f}" for k, v in sorted(
            ops.items(), key=lambda kv: -kv[1])[:8])
        print(f"   MoE dispatch by aten op, device ms per prefill launch: {top(ops1, n1)}")
        dec_ops = {k: ops16.get(k, 0.0) - ops1.get(k, 0.0) for k in ops16}
        print(f"   MoE dispatch by aten op, device ms per decode step: {top(dec_ops, steps)}")
    return busy1 / s1.prefill_launches, busy / steps


def serve_costs_phase(torch, engine, reqs, busy):
    """The roofline counter over profile_phase's split: the first SLOTS
    requests served with 1 and with 16 new tokens under ``count_costs`` (the
    kernels launch as they serve; the decode family and varlen_prefill read
    their lengths to the host, so nothing here is timed); a packed prefill
    launch is the first run over its launches, a decode step the difference
    over its steps.  Each is printed with its bound on the H100 and, at
    ``busy`` (profile_phase's device ms a launch and a step), its rate and
    the bound's share of that time.  A decode step must be bound by bytes
    and move at least the model's weights but the embedding table."""
    from repro_torch.roofline import count_costs, work
    from repro_torch.serve.engine import ServeRequest

    runs = {}
    for new in (1, 16):
        sub = [ServeRequest(r.request_id, r.prompt, new) for r in reqs[:SLOTS]]
        t0 = time.perf_counter()
        with count_costs() as costs:
            stats = engine.serve_paged(sub, num_slots=SLOTS, page_size=PAGE,
                                       prefill_budget=BUDGET)
        torch.cuda.synchronize()
        runs[new] = (stats, costs, time.perf_counter() - t0)
    (s1, c1, t1), (s16, c16, t16) = runs[1], runs[16]
    steps = s16.steps - s1.steps
    if s16.prefill_launches != s1.prefill_launches or steps <= 0:
        raise SystemExit(f"counted serve: prefill launches {s1.prefill_launches} and "
                         f"{s16.prefill_launches}, decode steps {steps}")
    n = s1.prefill_launches
    launch = work.Work(c1.flops / n, c1.memory_bytes / n)
    step = work.Work((c16.flops - c1.flops) / steps, (c16.memory_bytes - c1.memory_bytes) / steps)
    kernels = lambda by, k: ", ".join(f"{name} x{calls / k:g} {f / k:.3e} FLOPs {b / k:.3e} B"
                                      for name, (calls, f, b) in sorted(by.items()))
    step_kernels = {k: tuple(x - y for x, y in zip(v, c1.by_kernel.get(k, (0, 0, 0))))
                    for k, v in c16.by_kernel.items()}
    step_kernels = {k: v for k, v in step_kernels.items() if v[0]}
    print(f"   counted serves ({SLOTS} requests, 1 and 16 new tokens): {n} packed launches, "
          f"{steps} decode steps; counting took {t1:.2f} + {t16:.2f} s wall")
    # a step gathers 8 rows of the embedding table and reads every other weight
    cfg = engine.model.cfg
    weights = 2 * (cfg.param_count() - cfg.vocab_size * cfg.d_model)
    for label, w, ms, ks in (("packed prefill launch", launch, busy[0], kernels(c1.by_kernel, n)),
                             ("decode step", step, busy[1], kernels(step_kernels, steps))):
        bound, by = work.bound_ms(w)
        print(f"   {label}: counted {w.flops:.4e} FLOPs, {w.bytes:.4e} bytes; bound {bound:.4f} ms "
              f"({by}); at phase 5's {ms:.3f} device ms {w.flops / ms / 1e9:.2f} TFLOP/s, "
              f"{w.bytes / ms / 1e6:.1f} GB/s: the bound is {bound / ms:.4f} of it; kernels: {ks}")
    if work.bound_ms(step)[1] != "bytes" or step.bytes < weights:
        raise SystemExit(f"counted decode step: {step.bytes:.4e} bytes against {weights:.4e} of "
                         f"weights, bound by {work.bound_ms(step)[1]}")


def dense_profile_phase(torch, engine, prompts):
    """Where the time goes on the dense path: ``generate`` on the first
    SLOTS prompts under torch.profiler with 0 and with 16 new tokens (one
    prefill pass, then 16 decode steps); a decode step is the difference
    over 16 steps.  Host and profiler overhead count as device idle time."""
    runs = {new: _profiled(torch, lambda n=new: engine.generate(prompts[:SLOTS], n),
                           "decode_attention")
            for new in (0, 16)}
    (_, pre_wall, prefill, ssd_kernels), (_, w16, c16, _) = runs[0], runs[16]
    if sum(c16.values()) <= 0:
        print("   profiler saw no device time: breakdown not measured")
        return
    fmt = lambda dct: ", ".join(f"{k} {v:.3f}" for k, v in dct.items())
    step = {k: (c16[k] - prefill[k]) / 16 for k in c16}
    step_wall = (w16 - pre_wall) / 16
    model = engine.model
    L, G = model.cfg.num_layers, _groups(model.cfg)
    lens = [len(p) for p in prompts[:SLOTS]]
    print(f"   {model.cfg.name}: dense prefill pass ({SLOTS} prompts of {min(lens)}-{max(lens)} tokens, padded to "
          f"{engine._pad_prompts(prompts[:SLOTS])[0].shape[1]}): wall {pre_wall:.3f} ms, device "
          f"busy {sum(prefill.values()):.3f} ms (idle {1 - sum(prefill.values()) / pre_wall:.3f}); "
          f"device ms: {fmt(prefill)}")
    print(f"   {model.cfg.name}: dense decode step ({SLOTS} rows): wall {step_wall:.3f} ms, device busy "
          f"{sum(step.values()):.3f} ms (idle {1 - sum(step.values()) / step_wall:.3f}); "
          f"device ms: {fmt(step)}")
    attn = 0 if model.ssm else G or L           # attention launches a pass and a step
    per_launch = [("ssd", prefill["ssd"] / L)] if model.stateful else []
    per_launch += [("flash_attention", prefill["flash_attention"] / attn),
                   ("decode_attention", step["decode_attention"] / attn)] if attn else []
    per_launch += [("rmsnorm per pass", prefill["rmsnorm"] / _norms_per_pass(model.cfg)),
                   ("rmsnorm per step", step["rmsnorm"] / _norms_per_pass(model.cfg))]
    print("   device ms per kernel launch: " + ", ".join(f"{k} {v:.4f}" for k, v in per_launch))
    if model.stateful:
        # the tensor-core ssd is three CUDA launches a call (one ``launches`` count)
        print(f"   {model.cfg.name}: ssd kernels in the prefill pass ({L} calls): " + ", ".join(
            f"{k} {ms:.3f} ms over {cnt} launches" for k, (ms, cnt) in sorted(ssd_kernels.items())))
        if not any("ssd_kernel_chunk_" in k for k in ssd_kernels):
            raise SystemExit(f"ssd: no ssd_kernel_chunk_* launch in the profiled pass "
                             f"({sorted(ssd_kernels)})")


# the rest of the dense family: reduced configs checked card vs CPU (phase
# 3), the three that fit one card served at full width (phase 5b)
ZOO = ("gemma2-27b", "chameleon-34b", "granite-20b", "deepseek-67b")
ZOO_FULL = ("gemma2-27b", "granite-20b", "chameleon-34b")
ZOO_PROMPT_MIN = 20             # reduced checks: prompts past reduced gemma2's window of 8
# gemma2's long set: two prompts past its 4096-key window, split over
# several prefill boundaries
LONG_LENS, LONG_MAX_SEQ = (6000, 4500), 8192


def zoo_kernels_phase(torch, dev):
    """The kernels at the shapes the rest of the dense family gives them at
    published width, bf16, d 128, each against its plain version within the
    limit and timed beside its bound: gemma2-27b (32 query heads on 16 kv
    heads, attention softcap 50, window 4096 on its local layers and
    GLOBAL_WINDOW on its global ones), its flash pass of 8192 tokens, a
    packed chunk at pos0 4096 over 256 context pages and the decode family
    over contexts of 4500-6000 tokens, each with the 4096 window (the plain
    version without it must fail the limit); gemma2-27b with each of its
    two windows, granite-20b (48 on 1) and chameleon-34b (64 on 8) at the
    serve phase's prefill and decode shapes; rmsnorm at d_model
    4608/6144/8192 and over QK-norm rows of 128.  A windowed bound counts
    the (query, key) pairs the window leaves live.  Returns each kernel's
    worst error."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import spec_verify as sv
    from repro_torch.kernels import varlen_prefill as vp
    from repro_torch.models.lm import GLOBAL_WINDOW
    from repro_torch.roofline import work
    from repro_torch.serve.engine import bucket_pow2

    bf = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev, dtype=bf)
    cpm = _sleep_cycles_per_ms(torch)
    clones = lambda *ts: (lambda i: tuple(t.clone() for t in ts))
    worst = {}

    def check(name, label, out, want):
        worst[name] = max(worst.get(name, 0.0), _check(torch, f"{name} {label}", out, want))

    def case(name, shape, kernel, plain, library, sets, lib_sets, w):
        """One timed case (the plain version over 3 calls: at these shapes it
        takes up to 0.1 s a call) bound by its work ``w``, printed as the
        other phases print theirs."""
        record = dict(**_timed(torch, cpm, kernel, plain, library, sets, lib_sets, plain_calls=3),
                      bound=_bound(w), shape=shape)
        _print_records({name: record})
        return record

    def heads(t, rep):
        """(b, s, kvh, d) -> (b, h, s, d): K/V expanded to the query heads."""
        return t.transpose(1, 2).repeat_interleave(rep, dim=1)

    def opts_label(opts):
        return "".join(f", {k} {v}" for k, v in opts.items())

    gemma = get_config("gemma2-27b")
    W, cap, d = gemma.sliding_window, gemma.attn_softcap, 128
    win = dict(window=W, softcap=cap)
    layouts = {a: (get_config(a).num_heads, get_config(a).num_kv_heads)
               for a in ("gemma2-27b", "granite-20b", "chameleon-34b")}
    # each arch with the attention options its layers pass: gemma2's local
    # and global layers, the others none
    serve_shapes = [("gemma2-27b", dict(window=w, softcap=cap)) for w in (W, GLOBAL_WINDOW)]
    serve_shapes += [(a, {}) for a in ("granite-20b", "chameleon-34b")]

    # -- flash_attention: gemma2's causal pass of LONG_MAX_SEQ tokens with its
    #    window and softcap, against the same pass without the window
    h, kvh = layouts["gemma2-27b"]
    rep, s = h // kvh, LONG_MAX_SEQ
    q, k, v = randn(1, s, h, d), randn(1, s, kvh, d), randn(1, s, kvh, d)

    def plain_rows(q_, k_, v_, **opts):
        """The plain version 2048 query rows at a time (its float32 scores of
        the whole pass would take 8.6 GB a temporary)."""
        return torch.cat([ref.attention(q_[:, i:i + 2048], k_, v_, q_offset=i, **opts)
                          for i in range(0, q_.shape[1], 2048)], 1)

    label = f"gemma2-27b q (1, {s}, {h}, {d}), kvh {kvh}"
    want = plain_rows(q, k, v, **win)
    check("flash_attention", f"{label}, window {W}, softcap {cap}",
          fa.flash_attention(q, k, v, **win), want)
    _rejects(torch, "flash_attention gemma2-27b plain without the window",
             plain_rows(q, k, v, softcap=cap), want)
    del want
    pos = torch.arange(s, device=dev)
    causal = pos[:, None] >= pos[None, :]
    wmask = (causal & (pos[:, None] - pos[None, :] < W))[None, None]
    nbytes = 2 * (2 * s * h * d + 2 * s * kvh * d)
    sets = _rotation(nbytes, clones(q, k, v))
    lib_sets = _rotation(2 * 4 * s * h * d,
                         lambda i: (q.transpose(1, 2).contiguous(), heads(k, rep), heads(v, rep)))
    live, every = work.live_pairs(s, s, window=W), work.live_pairs(s, s)
    windowed = case(f"flash_attention {label}, window {W}, softcap {cap}",
                    f"{live} live pairs; library: SDPA without the softcap, which it lacks",
                    lambda *a: fa.flash_attention(*a, **win), lambda *a: plain_rows(*a, **win),
                    lambda q_, k_, v_: F.scaled_dot_product_attention(q_, k_, v_,
                                                                      attn_mask=wmask),
                    sets, lib_sets, work.flash_attention(1, s, s, h, kvh, d, window=W))
    whole = case(f"flash_attention {label}, no window, softcap {cap}",
                 f"{every} live pairs; library: SDPA without the softcap",
                 lambda *a: fa.flash_attention(*a, softcap=cap),
                 lambda *a: plain_rows(*a, softcap=cap),
                 lambda q_, k_, v_: F.scaled_dot_product_attention(q_, k_, v_, is_causal=True),
                 sets, lib_sets, work.flash_attention(1, s, s, h, kvh, d))
    print(f"      windowed / unwindowed kernel time {windowed['ms'] / whole['ms']:.3f} "
          f"(live pairs {live / every:.3f})")
    del q, k, v, sets, lib_sets, wmask, causal

    # -- varlen_prefill: a packed chunk of BUDGET tokens at pos0 4096 over
    #    256 context pages of 16 (queries 4096..6143: the window starts
    #    inside the context)
    T, pos0 = BUDGET, W
    ctx_pages, own_pages = pos0 // PAGE, T // PAGE
    mp = ctx_pages + own_pages
    kp, vpl = randn(mp + 1, PAGE, kvh, d), randn(mp + 1, PAGE, kvh, d)
    table = torch.arange(1, mp + 1, dtype=torch.int32, device=dev)[None]
    qp, kpk, vpk = randn(T, h, d), randn(T, kvh, d), randn(T, kvh, d)
    meta = [torch.tensor(a, dtype=torch.int32, device=dev) for a in ([0, T], [T], [pos0])]
    vargs = (qp, kpk, vpk, kp, vpl, *meta, table)
    want = ref.varlen_prefill(*vargs, **win)
    label = f"gemma2-27b T {T} at pos0 {pos0} over {ctx_pages} context pages"
    check("varlen_prefill", f"{label}, window {W}, softcap {cap}",
          vp.varlen_prefill(*vargs, **win), want)
    _rejects(torch, "varlen_prefill gemma2-27b plain without the window",
             ref.varlen_prefill(*vargs, softcap=cap), want)
    qpos = pos0 + torch.arange(T, device=dev)
    kpos = torch.arange(pos0 + T, device=dev)
    lmask = ((qpos[:, None] >= kpos[None, :]) & (qpos[:, None] - kpos[None, :] < W))[None, None]
    ctx_used = pos0 - (pos0 - W + 1)                 # context keys the first query still sees
    nbytes = 2 * (2 * T * h * d + 2 * T * kvh * d) + 2 * 2 * ctx_used * kvh * d + 4 * (3 + mp)
    sets = _rotation(nbytes, clones(qp, kpk, vpk, kp, vpl))
    lib_sets = _rotation(
        2 * (2 * T * h * d + 2 * h * (pos0 + T) * d),
        lambda i: (qp.transpose(0, 1)[None].contiguous(),
                   heads(torch.cat([kp[1:ctx_pages + 1].reshape(-1, kvh, d), kpk])[None], rep),
                   heads(torch.cat([vpl[1:ctx_pages + 1].reshape(-1, kvh, d), vpk])[None], rep)))
    case(f"varlen_prefill {label}, window {W}, softcap {cap}",
         f"{T * W} live pairs; library: SDPA without the softcap",
         lambda q_, k_, v_, kp_, vp_: vp.varlen_prefill(q_, k_, v_, kp_, vp_, *meta, table, **win),
         lambda q_, k_, v_, kp_, vp_: ref.varlen_prefill(q_, k_, v_, kp_, vp_, *meta, table,
                                                         **win),
         lambda q_, k_, v_: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=lmask),
         sets, lib_sets,
         work.varlen_prefill(T, h, kvh, d, [(T, pos0)], table.numel(), window=W))
    del kp, vpl, qp, kpk, vpk, sets, lib_sets, lmask, want

    # -- the decode family: gemma2 over contexts of 4500-6000 tokens with its
    #    4096 window; each of serve_shapes at the serve phase's lengths
    lens_rng = np.random.default_rng(SEED + 5)
    long_lens = [LONG_LENS[0]] + [int(n) for n in lens_rng.integers(LONG_LENS[1], LONG_LENS[0],
                                                                    SLOTS - 1)]
    serve_lens = [int(n) + NEW_TOKENS for n in _serve_lengths(SEED)[:SLOTS]]
    decode_cases = [("gemma2-27b", long_lens, LONG_MAX_SEQ, win)]
    decode_cases += [(arch, serve_lens, MAX_SEQ, opts) for arch, opts in serve_shapes]
    for arch, lens_host, S, opts in decode_cases:
        h, kvh = layouts[arch]
        rep = h // kvh
        window = opts.get("window")
        lengths = torch.tensor(lens_host, dtype=torch.int32, device=dev)
        bound = bucket_pow2(max(lens_host), floor=PAGE, cap=S)
        q = randn(SLOTS, 1, h, d)
        kc, vc = randn(SLOTS, S, kvh, d), randn(SLOTS, S, kvh, d)
        seen = [min(n, window) if window else n for n in lens_host]
        key_lo = torch.tensor([n - m for n, m in zip(lens_host, seen)], device=dev)
        label = (f"{arch} q ({SLOTS}, 1, {h}, {d}), kvh {kvh}, lengths {min(lens_host)}-"
                 f"{max(lens_host)}{opts_label(opts)}")
        want = ref.decode_attention(q, kc, vc, lengths, kv_bound=bound, **opts)
        check("decode_attention", label,
              da.decode_attention(q, kc, vc, lengths, kv_bound=bound, **opts), want)
        if seen != lens_host:                        # the window bites
            _rejects(torch, f"decode_attention {arch} plain without the window",
                     ref.decode_attention(q, kc, vc, lengths, kv_bound=bound,
                                          softcap=opts["softcap"]), want)
        # the same keys through a page table: pages of PAGE keys in a shuffled pool
        pages = S // PAGE
        perm = torch.randperm(SLOTS * pages, generator=gen, device=dev).to(torch.int32) + 1
        table = perm.view(SLOTS, pages).contiguous()
        kp = torch.zeros((SLOTS * pages + 1, PAGE, kvh, d), dtype=bf, device=dev)
        vpl = torch.zeros_like(kp)
        kp[table.long()] = kc.view(SLOTS, pages, PAGE, kvh, d)
        vpl[table.long()] = vc.view(SLOTS, pages, PAGE, kvh, d)
        pb = math.ceil(max(lens_host) / PAGE)
        check("paged_attention", label,
              pa.paged_attention(q, kp, vpl, table, lengths, pages_bound=pb, **opts),
              ref.paged_attention(q, kp, vpl, table[:, :pb], lengths, **opts))
        qw = randn(SLOTS, SPEC_K + 1, h, d)
        wl = torch.tensor(WINDOW_LENS[:SLOTS], dtype=torch.int32, device=dev)
        committed = lengths - SPEC_K - 1
        check("spec_verify", f"{label}, W {SPEC_K + 1}",
              sv.spec_verify(qw, kp, vpl, table, committed, wl, pages_bound=pb, **opts),
              ref.spec_verify(qw, kp, vpl, table[:, :pb], committed, wl, **opts))
        live = sum(seen)
        nbytes = 2 * 2 * SLOTS * h * d + 2 * 2 * live * kvh * d + 4 * SLOTS
        kpos = torch.arange(bound, device=dev)[None, :]
        mask = ((kpos < lengths[:, None]) & (kpos >= key_lo[:, None]))[:, None, None, :]
        lib_sets = _rotation(2 * 2 * SLOTS * h * bound * d,
                             lambda i: (q.transpose(1, 2).contiguous(), heads(kc[:, :bound], rep),
                                        heads(vc[:, :bound], rep)))
        sdpa = lambda q_, k_, v_: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=mask)
        shape = (f"{live} live keys; library: SDPA"
                 + (" without the softcap" if opts else ""))
        sets = _rotation(nbytes, clones(q, kc, vc))
        case(f"decode_attention {label}", shape,
             lambda q_, k_, v_: da.decode_attention(q_, k_, v_, lengths, kv_bound=bound, **opts),
             lambda q_, k_, v_: ref.decode_attention(q_, k_, v_, lengths, kv_bound=bound, **opts),
             sdpa, sets, lib_sets, work.decode_attention(SLOTS, h, kvh, d, live))
        sets = _rotation(nbytes, clones(q, kp, vpl))
        case(f"paged_attention {label}", shape,
             lambda q_, k_, v_: pa.paged_attention(q_, k_, v_, table, lengths, pages_bound=pb,
                                                   **opts),
             lambda q_, k_, v_: ref.paged_attention(q_, k_, v_, table[:, :pb], lengths, **opts),
             sdpa, sets, lib_sets, work.paged_attention(SLOTS, h, kvh, d, live, SLOTS * pb))
        del q, kc, vc, kp, vpl, sets, lib_sets, mask

    # -- flash_attention and varlen_prefill at each of serve_shapes' prefill
    #    shapes: a static pass of SLOTS x PREFILL_LEN, and a packed buffer of
    #    two chunks, one over 32 context pages (every position below
    #    gemma2's 4096 window: each of its layers sees every causal pair)
    for arch, opts in serve_shapes:
        h, kvh = layouts[arch]
        rep = h // kvh
        b, s = SLOTS, PREFILL_LEN
        q, k, v = randn(b, s, h, d), randn(b, s, kvh, d), randn(b, s, kvh, d)
        label = f"{arch} q ({b}, {s}, {h}, {d}), kvh {kvh}, causal{opts_label(opts)}"
        check("flash_attention", label, fa.flash_attention(q, k, v, **opts),
              ref.attention(q, k, v, **opts))
        nbytes = 2 * (2 * b * s * h * d + 2 * b * s * kvh * d)
        lib = "library: SDPA" + (" without the softcap" if opts else "")
        case(f"flash_attention {label}", f"static pass; {lib}",
             lambda *a: fa.flash_attention(*a, **opts), lambda *a: ref.attention(*a, **opts),
             lambda q_, k_, v_: F.scaled_dot_product_attention(q_, k_, v_, is_causal=True),
             _rotation(nbytes, clones(q, k, v)),
             _rotation(2 * 4 * b * s * h * d, lambda i: (q.transpose(1, 2).contiguous(),
                                                         heads(k, rep), heads(v, rep))),
             work.flash_attention(b, s, s, h, kvh, d, window=opts.get("window")))
        del q, k, v
        half, ctx = BUDGET // 2, 32
        mp = ctx + 2 * (half // PAGE)
        kp, vpl = randn(mp + 1, PAGE, kvh, d), randn(mp + 1, PAGE, kvh, d)
        tables = torch.zeros((2, mp), dtype=torch.int32, device=dev)
        tables[0, :ctx + half // PAGE] = torch.arange(1, ctx + half // PAGE + 1)
        tables[1, :half // PAGE] = torch.arange(ctx + half // PAGE + 1, mp + 1)
        qp, kpk, vpk = randn(BUDGET, h, d), randn(BUDGET, kvh, d), randn(BUDGET, kvh, d)
        meta = [torch.tensor(a, dtype=torch.int32, device=dev)
                for a in ([0, half, BUDGET], [half, half], [ctx * PAGE, 0])]
        label = (f"{arch} T {BUDGET}: chunks of {half} at pos0 {ctx * PAGE} and at 0, "
                 f"{PAGE * rep} rows a page{opts_label(opts)}")
        vargs = (qp, kpk, vpk, kp, vpl, *meta, tables)
        check("varlen_prefill", label, vp.varlen_prefill(*vargs, **opts),
              ref.varlen_prefill(*vargs, **opts))
        nbytes = 2 * (2 * BUDGET * h * d + 2 * BUDGET * kvh * d) + 2 * 2 * ctx * PAGE * kvh * d
        # SDPA on the gathered K/V: chunk 0's context pages, then the packed
        # buffer, under the packed layout's mask (the first chunk's queries
        # see the context and their causal prefix, the second's their own)
        ctx_rows, ctx_ids = ctx * PAGE, tables[0, :ctx].long()
        qi = torch.arange(BUDGET, device=dev)[:, None]
        kj = torch.arange(BUDGET, device=dev)[None, :]
        vmask = torch.cat([(qi < half).expand(BUDGET, ctx_rows),
                           (qi // half == kj // half) & (kj <= qi)], 1)[None, None]
        gathered = lambda pool, own: heads(torch.cat([pool[ctx_ids].reshape(-1, kvh, d),
                                                      own])[None], rep)
        lib_sets = _rotation(2 * (2 * BUDGET * h * d + 2 * h * (ctx_rows + BUDGET) * d),
                             lambda i: (qp.transpose(0, 1)[None].contiguous(),
                                        gathered(kp, kpk), gathered(vpl, vpk)))
        case(f"varlen_prefill {label}", "packed buffer; library: SDPA on the gathered K/V"
             + (" without the softcap" if opts else ""),
             lambda q_, k_, v_, kp_, vp_: vp.varlen_prefill(q_, k_, v_, kp_, vp_, *meta, tables,
                                                            **opts),
             lambda q_, k_, v_, kp_, vp_: ref.varlen_prefill(q_, k_, v_, kp_, vp_, *meta, tables,
                                                             **opts),
             lambda q_, k_, v_: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=vmask),
             _rotation(nbytes, clones(qp, kpk, vpk, kp, vpl)), lib_sets,
             work.varlen_prefill(BUDGET, h, kvh, d, [(half, ctx * PAGE), (half, 0)],
                                 tables.numel(), window=opts.get("window")))
        del kp, vpl, qp, kpk, vpk, lib_sets, vmask

    # -- rmsnorm: a packed-prefill buffer at each new d_model, and QK-norm's
    #    rows of 128 at a buffer and a decode step (chameleon: 64 heads a
    #    token; qwen3-moe: 32 query heads and 4 kv heads)
    for D, rows in ((4608, (1, BUDGET)), (6144, (1, BUDGET)), (8192, (1, BUDGET)),
                    (128, (1, BUDGET, 64)), (128, (SLOTS, 1, 64)),
                    (128, (1, BUDGET, 32)), (128, (1, BUDGET, 4)), (128, (SLOTS, 1, 32))):
        x, w = randn(*rows, D), randn(D) * 0.1
        n = x.numel() // D
        label = f"x {tuple(x.shape)} ({n} rows of {D})"
        check("rmsnorm", label, rn.rmsnorm(x, w), ref.rmsnorm(x, w))
        w1 = (1.0 + w.float()).to(bf)
        nbytes = 2 * (2 * n * D + D)
        sets = _rotation(nbytes, clones(x, w))
        case(f"rmsnorm {label}", f"{n} rows", rn.rmsnorm, ref.rmsnorm,
             lambda x_: F.rms_norm(x_, (D,), w1, 1e-6),
             sets, [(x_,) for x_, _ in sets], work.rmsnorm(n, D))
        del x, sets
    return worst


def _long_requests(vocab):
    """gemma2's long set: LONG_LENS random prompts, NEW_TOKENS new each."""
    import numpy as np

    from repro_torch.serve.engine import ServeRequest

    rng = np.random.default_rng(SEED + 6)
    return [ServeRequest(request_id=i, prompt=rng.integers(0, vocab, (n,)).astype(np.int32),
                         max_new_tokens=NEW_TOKENS) for i, n in enumerate(LONG_LENS)]


def zoo_serve_phase(torch, dev, counters):
    """The rest of the dense family at published width and depth (random
    bf16 weights from a seeded CUDA generator), one model at a time, each
    freed before the next loads; each set run once, counted alone, every
    request completed and every kernel launched exactly as the run's passes
    imply (``_norms_per_pass`` rmsnorm and one attention per layer a pass).
    gemma2-27b: ``serve_paged`` on the serve phase's mix; the long set (two
    prompts of 6000 and 4500 tokens, ``max_seq`` 8192, 2 slots) through
    ``serve_paged``.  granite-20b and chameleon-34b: ``serve_paged`` on the
    mix.  (Cut for time: the long set as one ``generate`` batch,
    granite's ``spec_k`` 4 run and the dense engines; phase 3 drives each
    on the reduced model, phase 4 the dense engines at full width on
    glm4-9b.)  Prints each model's peak memory and pool bytes per token (which
    must be ``kvquant.kv_bytes_per_token``'s)."""
    from repro_torch.kernels import kvquant
    from repro_torch.launch.serve import engine_metrics, make_requests
    from repro_torch.serve.engine import ServingEngine

    paged_need = ("rmsnorm", "paged_attention", "varlen_prefill")
    for arch in ZOO_FULL:
        _release(torch)
        torch.cuda.reset_peak_memory_stats(dev)
        model, params = full_model(torch, dev, arch)
        cfg, vocab = model.cfg, model.cfg.vocab_size
        windows = sorted({w for w in model.windows if w is not None})
        print(f"   {arch}: {cfg.num_heads} query heads on {cfg.num_kv_heads} kv heads, "
              f"{cfg.num_layers} attention and {_norms_per_pass(cfg)} rmsnorm launches a pass; "
              f"windows {windows or 'none'}, attention softcap {cfg.attn_softcap}, logit softcap "
              f"{cfg.logit_softcap}, post-norms {cfg.post_norms}, QK-norm {cfg.qk_norm}, scaled "
              f"embeddings {cfg.scale_embed}")
        engine = ServingEngine(model, params, max_batch=SLOTS, max_seq=MAX_SEQ, page_size=PAGE,
                               device=dev)
        for k in (0, SPEC_K):                        # warm-up, not counted
            engine.serve_paged(_tiled_requests(2, 16, 32, 6, vocab, SEED + 1),
                               prefill_budget=BUDGET, spec_k=k, spec_ngram=DRAFT_NGRAM)
        reqs = make_requests(REQUESTS, PROMPT_MIN, PROMPT_MAX, NEW_TOKENS, vocab, SEED)
        stats, counts = _counted_serve(torch, engine, reqs, counters, paged_need)
        want_bytes = kvquant.kv_bytes_per_token(cfg.num_layers, cfg.num_kv_heads,
                                                cfg.resolved_head_dim, "bfloat16")
        print(f"   {arch} serve_paged, the mix: {_fmt_metrics(engine_metrics(stats), stats)}; "
              f"kv bytes/token {stats.kv_bytes_per_token:.0f}; launches {counts}")
        if stats.kv_bytes_per_token != want_bytes:
            raise SystemExit(f"{arch}: {stats.kv_bytes_per_token} pool bytes per token, "
                             f"expected {want_bytes}")
        if arch == "gemma2-27b":
            print(f"   {arch} where the time goes (torch.profiler, the paged engine):")
            profile_phase(torch, engine, reqs)
        if arch == "gemma2-27b":
            long_engine = ServingEngine(model, params, max_batch=len(LONG_LENS),
                                        max_seq=LONG_MAX_SEQ, page_size=PAGE, device=dev)
            long_reqs = _long_requests(vocab)
            _zero(counters)
            st = long_engine.serve_paged(long_reqs, num_slots=len(LONG_LENS), page_size=PAGE,
                                         prefill_budget=BUDGET)
            cnt = _check_counts(f"{arch} long serve_paged", counters, _expected_launches(st, cfg),
                                _completed([r.tokens for r in st.results], vocab), len(long_reqs))
            print(f"   {arch} serve_paged, the long set {list(LONG_LENS)} (max_seq {LONG_MAX_SEQ}, "
                  f"{len(LONG_LENS)} slots): {_fmt_metrics(engine_metrics(st), st)}; launches "
                  f"{cnt}")
            if st.prefill_launches < 3:
                raise SystemExit(f"{arch}: the long set took {st.prefill_launches} prefill "
                                 f"launches; it must span several boundaries")
            del long_engine
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"   {arch}: peak device memory over its runs {peak / 1e9:.2f} GB")
        del model, params, engine
        if arch == "gemma2-27b":
            # before any garbage collection: the static path's scheduler no
            # longer keeps its engine in a reference cycle
            left = torch.cuda.memory_allocated(dev) / 2**30
            print(f"   {arch} released: device memory still allocated before any collection "
                  f"{left:.3f} GiB")
            if left > 1.0:
                raise SystemExit(f"{arch}: its weights outlive their names (a reference cycle?)")


# ---------------------------------------------------------------------------
# the MoE family: qwen3-moe-30b-a3b at published width, llama4-maverick reduced
# ---------------------------------------------------------------------------
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_INTERLEAVED = "llama4-maverick-400b-a17b"
# reduced qwen3 (8 experts, top 2) and llama4 (8, top 1) at this capacity
# factor drop slots in every check (their configs' 2.0 rarely does)
MOE_CHECK_CF = 0.5
MOE_CHUNKED = 4                 # phase 5c's chunked-prefill run: the first 4 requests of the mix
# phase 5c's depth: new tokens a request (the mix's 32 before the time
# cuts; a qwen3-moe decode step takes ~0.2 s of host time at 8 slots)
MOE_NEW_TOKENS = 16
# phase 5c's moe_decode_gather off and on: the first SLOTS requests
# and the first one, each served with 1 and MOE_GATHER_NEW new tokens under
# torch.profiler and under the roofline counter; a decode step is the
# difference over the steps
MOE_GATHER_NEW = 4


def moe_check_phase(torch, dev):
    """Reduced qwen3-moe and llama4-maverick in float32 at MOE_CHECK_CF,
    card against CPU, each set of runs counting the slots both devices
    drop (there must be some): qwen3 through ``serve_paged`` (packed on
    bf16-width float32, int8 and fp8 pools, ``spec_k`` 4; chunked, the
    prefix cache on, overcommit), ``generate`` and ``serve_continuous``;
    llama4 (its dense and MoE layers interleaved) through ``generate`` and
    ``serve_continuous``.  Greedy tokens must be equal across devices."""
    for label, run in (
            (f"{MOE_ARCH} serve_paged", lambda: check_phase(torch, dev, MOE_ARCH, cf=MOE_CHECK_CF)),
            (f"{MOE_ARCH} the rest of serve_paged",
             lambda: paged_paths_check(torch, dev, MOE_ARCH, cf=MOE_CHECK_CF)),
            (f"{MOE_ARCH} dense engines",
             lambda: dense_check_phase(torch, dev, MOE_ARCH, cf=MOE_CHECK_CF)),
            (f"{MOE_INTERLEAVED} dense engines",
             lambda: dense_check_phase(torch, dev, MOE_INTERLEAVED, cf=MOE_CHECK_CF))):
        with _DropCounter() as drops:
            run()
        drops.require(label)


def moe_gather_phase(torch, dev, engine, reqs, bf16_err):
    """``moe_decode_gather`` off and on, at SLOTS slots and at one: a paged
    decode step's device ms (torch.profiler) and counted FLOPs and bytes
    (the roofline counter), each the difference of a serve with
    MOE_GATHER_NEW new tokens and one with 1 (a prefill alone, which the
    lever does not touch: served once for both) over the decode steps;
    the on run's greedy
    tokens beside the off run's, each first divergence at a top-two margin
    (the off run's logits there) of at most 2E (E, phase 4's largest bf16
    error against float32: a near-tie), printed.  Then reduced
    ``MOE_ARCH`` in float32 on the card: the same tokens on and off.  The
    lever runs under rules with a 1-wide model axis, which the tp-1 engine
    leaves active."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.roofline import count_costs
    from repro_torch.serve.engine import ServeRequest, ServingEngine
    from repro_torch.sharding.specs import default_rules, set_activation_rules

    on_rules = default_rules({"data": 1, "model": 1})
    on_rules.opts["moe_decode_gather"] = True
    print(f"   moe_decode_gather off and on ({MOE_GATHER_NEW - 1} decode steps a run; device ms "
          f"by torch.profiler, counted per step):")
    tokens = {}

    def measured(slots, new, rules):
        sub = [ServeRequest(r.request_id, r.prompt, new) for r in reqs[:slots]]
        serve = lambda: engine.serve_paged(sub, num_slots=slots, page_size=PAGE,
                                           prefill_budget=BUDGET)
        with set_activation_rules(rules):
            stats, _, by_class, _ = _profiled(torch, serve, "paged_attention")
            with count_costs() as costs:
                serve()
            torch.cuda.synchronize()
        return stats, sum(by_class.values()), costs

    for slots in (SLOTS, 1):
        s1, b1, c1 = measured(slots, 1, None)
        for on in (False, True):
            sn, bn, cn = measured(slots, MOE_GATHER_NEW, on_rules if on else None)
            steps = sn.steps - s1.steps
            if steps <= 0 or bn <= 0:
                raise SystemExit(f"moe_decode_gather {'on' if on else 'off'} at {slots} slots: "
                                 f"{steps} decode steps, device ms {bn}")
            tokens[(slots, on)] = [np.asarray(r.tokens) for r in sn.results]
            print(f"      {'on ' if on else 'off'} at {slots} slot{'s' if slots > 1 else ''}: "
                  f"device ms a step {(bn - b1) / steps:.3f}; counted a step "
                  f"{(cn.flops - c1.flops) / steps:.4e} FLOPs, "
                  f"{(cn.memory_bytes - c1.memory_bytes) / steps:.4e} bytes")
        off, on = tokens[(slots, False)], tokens[(slots, True)]
        firsts = [(i, int(np.argmin(a == b))) for i, (a, b) in enumerate(zip(off, on))
                  if not np.array_equal(a, b)]
        margins = []
        for i, t in firsts:
            ctx = np.concatenate([reqs[i].prompt, off[i][:t]]).astype(np.int32)
            top = engine.prompt_logits(ctx).float().topk(2).values
            margins.append((i, t, round(float(top[0] - top[1]), 4)))
        print(f"      tokens on vs off at {slots} slot{'s' if slots > 1 else ''} (bf16): "
              f"{_fmt_agreement(off, on)}; first divergences (request, token, top-two margin): "
              f"{margins}; 2E = {2 * bf16_err:.4f}")
        if any(m > 2 * bf16_err for _, _, m in margins):
            raise SystemExit("moe_decode_gather: tokens leave the default path's where its top "
                             "two are further apart than 2E: not rounding")
    cfg = get_config(MOE_ARCH, reduced=True)
    model = build_model(cfg, device=dev, dtype=torch.float32)
    small = ServingEngine(model, model.init(seed=SEED), max_batch=3, max_seq=64, page_size=4,
                          device=dev)
    rng = np.random.default_rng(SEED)
    sub = [ServeRequest(i, rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32), 6)
           for i, n in enumerate(rng.integers(5, 30, size=5))]
    got = {}
    for on in (False, True):
        with set_activation_rules(on_rules if on else None):
            got[on] = [r.tokens for r in small.serve_paged(sub, num_slots=3, page_size=4,
                                                            prefill_budget=8).results]
    same = all(np.array_equal(a, b) for a, b in zip(got[False], got[True]))
    print(f"      reduced {MOE_ARCH}, float32, on the card: tokens on == off: {same}")
    if not same:
        raise SystemExit("moe_decode_gather: float32 tokens differ from the default path's")


def moe_serve_phase(torch, dev, counters, bf16_err):
    """Full-width, full-depth qwen3-moe-30b-a3b (48 layers, 128 experts of
    d_ff 768, top 8, capacity factor 1.25; random bf16 weights from a
    seeded CUDA generator) on the serve phase's mix at MOE_NEW_TOKENS new
    tokens a request, each run counted alone
    with exactly 48 attention and 193 rmsnorm launches a pass and a step:
    ``serve_paged`` on a bf16 pool (the baseline); ``spec_k`` 4 on the
    first SLOTS tiled prompts, beside the plain run of those prompts;
    chunked prefill (the first MOE_CHUNKED requests).  (Cut, for
    time, the int8 pool's run, the shared-prefix pair and the dense engines
    (static, continuous): phase 4 drives them at full width on glm4-9b,
    phase 3 on reduced qwen3-moe.)  Each prints the driver's
    metrics, peak memory and its token agreement with its baseline (printed,
    not held: with capacity routing a verify window of 5 has C 1, so a
    drafted token can be dropped where plain decoding keeps it, and a
    packed launch routes its whole buffer as one group).  Then the profile
    of a packed prefill launch and of a decode step with the expert
    matmuls and the MoE dispatch apart."""
    from repro_torch.kernels import kvquant
    from repro_torch.launch.serve import engine_metrics, make_requests, moe_summary
    from repro_torch.models.modules import moe_capacity
    from repro_torch.serve.engine import ServingEngine

    _release(torch)
    torch.cuda.reset_peak_memory_stats(dev)
    model, params = full_model(torch, dev, MOE_ARCH)
    cfg, vocab = model.cfg, model.cfg.vocab_size
    caps = {label: moe_capacity(cfg, s) for label, s in (
        ("decode step", 1), (f"verify window {SPEC_K + 1}", SPEC_K + 1),
        (f"chunk {CHUNK}", CHUNK), (f"packed launch {BUDGET}", BUDGET),
        (f"static pass {PREFILL_LEN}", PREFILL_LEN))}
    print(f"   {MOE_ARCH}: {moe_summary(cfg)}; {cfg.num_heads} query heads on "
          f"{cfg.num_kv_heads} kv heads, QK-norm {cfg.qk_norm}, rope theta {cfg.rope_theta}; "
          f"{cfg.num_layers} attention and {_norms_per_pass(cfg)} rmsnorm launches a pass; "
          f"capacity per expert and row: {caps}")
    engine = ServingEngine(model, params, max_batch=SLOTS, max_seq=MAX_SEQ, page_size=PAGE,
                           device=dev)
    for k in (0, SPEC_K):                            # warm-up, not counted
        engine.serve_paged(_tiled_requests(2, 16, 32, 6, vocab, SEED + 1),
                           prefill_budget=BUDGET, spec_k=k, spec_ngram=DRAFT_NGRAM)
    reqs = make_requests(REQUESTS, PROMPT_MIN, PROMPT_MAX, MOE_NEW_TOKENS, vocab, SEED)
    need = ("rmsnorm", "paged_attention", "varlen_prefill")

    def run(label, eng, prompts, need, base=None, **kw):
        torch.cuda.reset_peak_memory_stats(dev)
        stats, counts = _counted_serve(torch, eng, prompts, counters, need, **kw)
        print(_fmt_run(torch, dev, engine_metrics(stats), stats, label, base))
        print(f"      launches {counts}" + (f"; spec_stats {stats.spec_stats}"
                                            if stats.spec_stats else ""))
        return stats

    base = run("paged, bf16 pool (the baseline)", engine, reqs, need)
    want_bytes = kvquant.kv_bytes_per_token(cfg.num_layers, cfg.num_kv_heads,
                                            cfg.resolved_head_dim, "bfloat16")
    if base.kv_bytes_per_token != want_bytes:
        raise SystemExit(f"{MOE_ARCH}: {base.kv_bytes_per_token} pool bytes per token, "
                         f"expected {want_bytes}")
    # the tiled pair on the first SLOTS tiled prompts, chunked prefill on the
    # first MOE_CHUNKED requests: the depth cuts that keep the script inside
    # its time limit
    tiled = _tiled_requests(REQUESTS, PROMPT_MIN, PROMPT_MAX, MOE_NEW_TOKENS, vocab,
                            SEED)[:SLOTS]
    plain_tiled = run(f"paged, the first {SLOTS} tiled prompts, plain", engine, tiled, need)
    run(f"paged, the first {SLOTS} tiled prompts, spec_k {SPEC_K} spec_ngram {DRAFT_NGRAM}",
        engine, tiled,
        ("rmsnorm", "varlen_prefill", "spec_verify"), ("plain", plain_tiled),
        spec_k=SPEC_K, spec_ngram=DRAFT_NGRAM)
    # chunked prefill: _counted_serve holds one flash_attention launch a
    # layer and chunk and no varlen_prefill (_expected_launches)
    run(f"chunked prefill ({CHUNK}-token chunks), the first {MOE_CHUNKED} requests", engine,
        reqs[:MOE_CHUNKED], ("rmsnorm", "paged_attention", "flash_attention"), ("packed", base),
        prefill_mode="chunked")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"   {MOE_ARCH} where the time goes (torch.profiler, the paged engine; device ms):")
    profile_phase(torch, engine, reqs)
    moe_gather_phase(torch, dev, engine, reqs, bf16_err)
    del engine
    peak = max(peak, torch.cuda.max_memory_allocated(dev))
    print(f"   {MOE_ARCH}: peak device memory over its runs {peak / 1e9:.2f} GB")
    del model, params
    _release(torch)


# ---------------------------------------------------------------------------
# the hybrid family: zamba2-2.7b at published width, with its ring cache
# ---------------------------------------------------------------------------
HYBRID_ARCH = "zamba2-2.7b"
# a max_seq past the ring threshold: zamba2's shared attention on a ring of
# its 4096-slot long_context_window; the long set's prompts both overflow it
RING_MAX_SEQ = 131072
# the ring as a no-op: one prompt that stays inside the ring while decoding,
# under a plain cache of NOOP_MAX_SEQ and under the ring
NOOP_LEN, NOOP_MAX_SEQ = 4000, 8192
# reduced zamba2 with a ring of 8 slots past the threshold (the JAX suite's
# wrap check, tests/test_arch_smoke.py)
REDUCED_RING, REDUCED_RING_MAX_SEQ = 8, 100_000


def hybrid_kernels_phase(torch, dev):
    """The kernels at the shapes zamba2-2.7b's serve runs give them, bf16,
    each against its plain version within the limit and timed beside its
    bound and (where one PyTorch call computes it) SDPA or ``F.rms_norm``:
    flash_attention at head dim 80 (the mma.sync kernel over Padded<80>
    tiles; 32 heads, MHA, causal) on a static pass q (8, s_pass, 32, 80)
    (s_pass the longest of the first SLOTS serve prompts, the pass's
    left-padded length), a continuous admission (1, s_adm) (s_adm the
    longest prompt of the mix, every admission's left-padded length) and
    the ring run's prefill (2, 6000) (the plain version with key 0 dropped
    must fail the limit), and a 64-token q at ``q_offset`` s_adm - 64;
    decode_attention at (8, S, 32, 80) off the ring (S = MAX_SEQ; the static
    step's uniform length s_pass + NEW_TOKENS and the continuous step's
    staggered lengths from s_adm, no bound) and on it (S 4096, every row's
    ring full; the plain version with ``lengths - 1`` must fail); ssd at
    (8, s_pass, 80, 64), n 64, chunk 64 (y and the final state, which one
    timestep short must fail) and at the admission (1, s_adm); rmsnorm at
    d_model 2560 and the gated 5120 over a static pass's rows and a decode
    step's 8.  Returns each kernel's worst error."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd as sd
    from repro_torch.roofline import work

    cfg = get_config(HYBRID_ARCH)
    h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    sh, p, n, chunk = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    bf = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev, dtype=bf)
    uniform = lambda shape, lo, hi: torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo
    cpm = _sleep_cycles_per_ms(torch)
    clones = lambda *ts: (lambda i: tuple(t.clone() for t in ts))
    heads = lambda t: t.transpose(1, 2).contiguous()              # (b, s, h, d) -> (b, h, s, d)
    worst = {}

    def check(name, label, out, want):
        worst[name] = max(worst.get(name, 0.0), _check(torch, f"{name} {label}", out, want))

    def case(name, shape, kernel, plain, library, sets, lib_sets, w, plain_calls=3):
        record = dict(**_timed(torch, cpm, kernel, plain, library, sets, lib_sets,
                               plain_calls=plain_calls),
                      bound=_bound(w), shape=shape)
        _print_records({name: record})
        return record

    # the shapes zamba2's engines give: a static pass of the first SLOTS
    # prompts left-padded to the longest, a continuous admission left-padded
    # to the longest prompt of the mix, the ring run's 2 left-padded prompts
    serve_lens = [int(x) for x in _serve_lengths(SEED)[:SLOTS]]
    s_pass, s_adm = max(serve_lens), int(max(_serve_lengths(SEED)))
    pl = fa.plan(bf, d, h // kvh)
    print(f"   flash_attention plan at d {d}: {pl.kernel}, {pl.rows} rows a block, {pl.block_k} "
          f"keys a tile, {pl.stages} stages, {pl.layout} rows of {fa.row_stride(pl.layout, d)} "
          f"elements, {pl.smem_bytes} B of shared memory")
    # -- flash_attention: causal, MHA, at a static pass, an admission and the
    #    ring run's prefill (rows and keys that end inside a tile)
    sdpa = lambda q_, k_, v_: F.scaled_dot_product_attention(q_, k_, v_, is_causal=True)
    for b, s, where in ((SLOTS, s_pass, "static pass"), (1, s_adm, "continuous admission"),
                        (len(LONG_LENS), max(LONG_LENS), "ring run prefill")):
        q, k, v = randn(b, s, h, d), randn(b, s, kvh, d), randn(b, s, kvh, d)
        label = f"{HYBRID_ARCH} q ({b}, {s}, {h}, {d}), kvh {kvh}, causal"
        want = ref.attention(q, k, v)
        check("flash_attention", label, fa.flash_attention(q, k, v), want)
        if b == SLOTS:
            _rejects(torch, f"flash_attention d {d} plain without key 0",
                     ref.attention(q, k[:, 1:], v[:, 1:], q_offset=-1), want)
        del want
        nbytes = 2 * (2 * b * s * h * d + 2 * b * s * kvh * d)
        case(f"flash_attention {label}", where,
             fa.flash_attention, ref.attention, sdpa,
             _rotation(nbytes, clones(q, k, v)),
             _rotation(nbytes, lambda i: (heads(q), heads(k), heads(v))),
             work.flash_attention(b, s, s, h, kvh, d))
        del q, k, v
    # the kernel's q_offset at d 80 (a chunk's; zamba2's engines prefill
    # whole prompts)
    q, k, v = randn(1, 64, h, d), randn(1, s_adm, kvh, d), randn(1, s_adm, kvh, d)
    check("flash_attention", f"q (1, 64, {h}, {d}) at q_offset {s_adm - 64} over "
          f"{s_adm} keys", fa.flash_attention(q, k, v, q_offset=s_adm - 64),
          ref.attention(q, k, v, q_offset=s_adm - 64))
    del q, k, v

    # -- decode_attention: a decode step of SLOTS rows off the ring (the
    #    static engine's uniform position after NEW_TOKENS steps; the
    #    continuous engine's slots, each admitted at s_adm, at staggered
    #    positions) and on a full ring
    S_ring = cfg.long_context_window             # the ring's slots at RING_MAX_SEQ
    for S, lens_host, where in (
            (MAX_SEQ, [s_pass + NEW_TOKENS] * SLOTS, "off the ring, static step"),
            (MAX_SEQ, [s_adm + 1 + i * NEW_TOKENS // SLOTS for i in range(SLOTS)],
             "off the ring, continuous step"),
            (S_ring, [S_ring] * SLOTS, "on a full ring")):
        lengths = torch.tensor(lens_host, dtype=torch.int32, device=dev)
        q, kc, vc = randn(SLOTS, 1, h, d), randn(SLOTS, S, kvh, d), randn(SLOTS, S, kvh, d)
        label = f"{HYBRID_ARCH} q ({SLOTS}, 1, {h}, {d}), cache ({SLOTS}, {S}, {kvh}, {d}) {where}"
        want = ref.decode_attention(q, kc, vc, lengths)
        check("decode_attention", label, da.decode_attention(q, kc, vc, lengths), want)
        _rejects(torch, f"decode_attention d {d} {where}: plain with lengths - 1",
                 ref.decode_attention(q, kc, vc, lengths - 1), want)
        del want
        live = sum(lens_host)
        nbytes = 2 * 2 * SLOTS * h * d + 2 * 2 * live * kvh * d + 4 * SLOTS
        mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        case(f"decode_attention {label}", f"lengths {lens_host}, no kv_bound",
             lambda q_, k_, v_: da.decode_attention(q_, k_, v_, lengths),
             lambda q_, k_, v_: ref.decode_attention(q_, k_, v_, lengths),
             lambda q_, k_, v_: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=mask),
             _rotation(nbytes, clones(q, kc, vc)),
             _rotation(2 * 2 * SLOTS * S * h * d, lambda i: (heads(q), heads(kc), heads(vc))),
             work.decode_attention(SLOTS, h, kvh, d, live))
        del q, kc, vc, mask

    # -- ssd: the static pass (left-padded to the longest of the first SLOTS
    #    prompts) and a batch-1 admission
    def ssd_inputs(b, s):
        x, B, C = randn(b, s, sh, p), randn(b, s, n), randn(b, s, n)
        return x, uniform((b, s, sh), 1e-3, 1e-1), -uniform((sh,), 1.0, 16.0), B, C

    splan = sd.plan(bf, p, n, chunk)
    print(f"   ssd plan (bf16, p {p}, n {n}, chunk {chunk}, {sh} heads): {splan.kernel}; blocks "
          f"per launch {sd.blocks(splan, SLOTS, s_pass, sh, p, n, chunk)} at the static pass")
    for b, s in ((SLOTS, s_pass), (1, s_adm)):
        args = ssd_inputs(b, s)
        label = f"{HYBRID_ARCH} x ({b}, {s}, {sh}, {p}), n {n}, chunk {chunk}"
        y, sf = sd.ssd(*args, chunk=chunk, return_state=True)
        y_want, sf_want = ref.ssd(*args, return_state=True)
        check("ssd", f"{label}: y", y, y_want)
        check("ssd", f"{label}: final state", sf, sf_want)
        if b == SLOTS:
            x, dt, A, B, C = args
            short = ref.ssd(x[:, :-1], dt[:, :-1], A, B[:, :-1], C[:, :-1], return_state=True)[1]
            _rejects(torch, "ssd zamba2 plain final state one timestep short", short, sf_want)
            w = work.ssd(b, s, sh, p, n, chunk)
            case(f"ssd {label}", "static pass, final state out; no library call computes SSD",
                 lambda *a: sd.ssd(*a, chunk=chunk, return_state=True),
                 lambda *a: ref.ssd(*a, return_state=True), None,
                 _rotation(w.bytes, lambda i: tuple(t.clone() for t in args)), [],
                 w, plain_calls=2)
        del args, y, sf, y_want, sf_want

    # -- rmsnorm at d_model and the gated d_inner, a static pass's rows and
    #    a decode step's
    for D in (cfg.d_model, cfg.ssm_inner):
        w = randn(D) * 0.1
        for rows in (SLOTS * s_pass, SLOTS):
            x = randn(rows, D)
            label = f"{HYBRID_ARCH} ({rows}, {D})"
            check("rmsnorm", label, rn.rmsnorm(x, w), ref.rmsnorm(x, w))
            nbytes = 2 * (2 * rows * D + D)
            case(f"rmsnorm {label}", f"{rows} rows",
                 rn.rmsnorm, ref.rmsnorm, lambda x_: F.rms_norm(x_, (D,), w, 1e-6),
                 _rotation(nbytes, lambda i: (x.clone(), w)), _rotation(nbytes, clones(x)),
                 work.rmsnorm(rows, D))
            del x
    return worst


def hybrid_check_phase(torch, dev):
    """Reduced zamba2-2.7b in float32, card against CPU through ``generate``
    and ``serve_continuous`` (tokens equal, ``forward`` logits within
    1e-4 + 1e-4 |cpu|): on a plain cache, and with a ring of REDUCED_RING
    slots at ``max_seq`` REDUCED_RING_MAX_SEQ, which every prompt (5-60
    tokens) overflows and every decode wraps."""
    dense_check_phase(torch, dev, HYBRID_ARCH)
    dense_check_phase(torch, dev, HYBRID_ARCH, ring=REDUCED_RING)


def hybrid_serve_phase(torch, dev, counters):
    """Full-width, full-depth zamba2-2.7b (54 Mamba-2 layers, a shared
    attention + MLP block after every 6th: 9 groups of 32 heads of 80;
    random bf16 weights, loaded once the earlier models are freed), each
    run counted alone with exact launch counts (``_dense_expected``): the
    static path and ``serve_continuous`` on the serve mix (metrics, peak
    memory, the two engines' token agreement), the profile of one static
    prefill pass and one decode step; ``generate`` on the long set (6000 and
    4500 tokens) at ``max_seq`` RING_MAX_SEQ, whose 4096-slot ring both
    prompts overflow (the prefill's roll) and every decode step wraps:
    finite logits at every step and ``pos`` the left-padded prompt length
    + NEW_TOKENS; one NOOP_LEN-token prompt under a plain cache of
    NOOP_MAX_SEQ and under the ring, which it never fills: equal tokens (a
    ring is a no-op while ``pos < S``)."""
    import numpy as np

    from repro_torch.serve.engine import ServingEngine

    _release(torch)
    torch.cuda.reset_peak_memory_stats(dev)
    model, params = full_model(torch, dev, HYBRID_ARCH)
    cfg, vocab = model.cfg, model.cfg.vocab_size
    G = _groups(cfg)
    S_ring = model.cache_len(RING_MAX_SEQ)
    kv_bytes = 2 * G * cfg.num_kv_heads * cfg.resolved_head_dim * 2
    print(f"   {HYBRID_ARCH}: {cfg.num_layers} Mamba-2 layers ({cfg.ssm_heads} heads of "
          f"{cfg.ssm_head_dim}, state {cfg.ssm_state}), a shared block after every "
          f"{cfg.hybrid_attn_every}: {G} groups of {cfg.num_heads} heads of "
          f"{cfg.resolved_head_dim}; per pass {G} flash_attention, {cfg.num_layers} ssd and "
          f"{_norms_per_pass(cfg)} rmsnorm, per step {G} decode_attention and "
          f"{_norms_per_pass(cfg)} rmsnorm; K/V {kv_bytes} B a token; at max_seq "
          f"{RING_MAX_SEQ} a ring of {S_ring} slots")
    if S_ring == RING_MAX_SEQ or S_ring >= min(LONG_LENS):
        raise SystemExit(f"{HYBRID_ARCH}: max_seq {RING_MAX_SEQ} gives no ring the long set "
                         f"overflows ({S_ring} slots)")
    _, engine, prompts, tokens = dense_serve_phase(torch, dev, counters, model, params)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"   {HYBRID_ARCH} where the time goes (torch.profiler, generate; device ms):")
    dense_profile_phase(torch, engine, prompts)
    del engine

    # the ring at full width: both prompts overflow it, every step wraps
    real_decode = model.decode
    seen = {"finite": torch.ones((), dtype=torch.bool, device=dev), "cache": None}

    def probe(params_, tokens_, cache, **kw):
        out = real_decode(params_, tokens_, cache, **kw)
        seen["finite"] &= torch.isfinite(out).all()
        seen["cache"] = cache
        return out

    long_reqs = _long_requests(vocab)
    ring_engine = ServingEngine(model, params, max_batch=len(long_reqs), max_seq=RING_MAX_SEQ,
                                page_size=PAGE, device=dev)
    model.decode = probe
    try:
        _zero(counters)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        gen = ring_engine.generate([r.prompt for r in long_reqs], NEW_TOKENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del model.decode
    cnt = _check_counts(f"{HYBRID_ARCH} ring generate", counters,
                        _dense_expected(model, 1, NEW_TOKENS),
                        _completed(list(gen.tokens), vocab), len(long_reqs))
    cache = seen.pop("cache")
    pos = cache["pos"].tolist()
    want_pos = max(LONG_LENS) + NEW_TOKENS
    finite = bool(seen["finite"])
    print(f"   {HYBRID_ARCH} generate, the long set {list(LONG_LENS)} at max_seq {RING_MAX_SEQ} "
          f"(K/V cache {tuple(cache['k'].shape)}: a ring of {S_ring}, overflowed by the prompts "
          f"and wrapped by every step): prefill {gen.prefill_s * 1e3:.1f} ms "
          f"({len(long_reqs) * max(LONG_LENS) / gen.prefill_s:.1f} tok/s of the left-padded "
          f"batch), decode {gen.decode_s * 1e3:.1f} ms ({gen.tokens_per_s:.1f} tok/s), wall "
          f"{wall:.3f} s; every step's logits finite: {finite}; pos {pos} (expected "
          f"{want_pos}); peak device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; "
          f"launches {cnt}")
    if not finite or pos != [want_pos] * len(long_reqs) or cache["k"].shape[2] != S_ring:
        raise SystemExit(f"{HYBRID_ARCH}: the ring run gave non-finite logits or pos {pos}")
    peak = max(peak, torch.cuda.max_memory_allocated(dev))
    del ring_engine, cache, seen

    # the ring as a no-op: a prompt that never fills it
    prompt = np.random.default_rng(SEED + 8).integers(0, vocab, (NOOP_LEN,)).astype(np.int32)
    noop = {}
    for max_seq in (NOOP_MAX_SEQ, RING_MAX_SEQ):
        eng = ServingEngine(model, params, max_batch=1, max_seq=max_seq, page_size=PAGE,
                            device=dev)
        _zero(counters)
        gen = eng.generate([prompt], NEW_TOKENS)
        _check_counts(f"{HYBRID_ARCH} generate at max_seq {max_seq}", counters,
                      _dense_expected(model, 1, NEW_TOKENS), _completed(list(gen.tokens), vocab), 1)
        noop[max_seq] = gen.tokens
        print(f"   {HYBRID_ARCH} generate, one {NOOP_LEN}-token prompt at max_seq {max_seq} "
              f"(cache of {model.cache_len(max_seq)} slots, ring "
              f"{model.cache_len(max_seq) != max_seq}): decode {gen.tokens_per_s:.1f} tok/s")
        del eng
    same = bool(np.array_equal(noop[NOOP_MAX_SEQ], noop[RING_MAX_SEQ]))
    print(f"   {HYBRID_ARCH}: the ring that never wraps gives the plain cache's tokens: {same}")
    if not same:
        raise SystemExit(f"{HYBRID_ARCH}: a ring that never wraps changed the tokens")
    print(f"   {HYBRID_ARCH}: peak device memory over its runs {peak / 1e9:.2f} GB")
    del model, params
    _release(torch)


# ---------------------------------------------------------------------------
# the enc-dec family: whisper-large-v3 at published width, with its cross cache
# ---------------------------------------------------------------------------
ENCDEC_ARCH = "whisper-large-v3"
# a transcription-shaped batch: SLOTS prompts of a 4-token start-of-transcript
# prefix, 224 new tokens (half of whisper's 448-token decoder context), over
# random frames; max_seq the decoder's context
TRANSCRIBE_PROMPT, TRANSCRIBE_NEW, TRANSCRIBE_MAX_SEQ = 4, 224, 448
# reduced whisper's encoder widths checked card vs CPU: 16 frames, and 20,
# whose cross cache is padded to 32 slots
REDUCED_ENCODER_SEQS = (16, 20)


def whisper_kernels_phase(torch, dev):
    """The kernels at the shapes whisper-large-v3's static serve gives them,
    bf16 (20 heads of 64 on 20 kv heads, no RoPE), each against its plain
    version within the limit and timed beside its bound and SDPA or
    ``F.rms_norm``: flash_attention (mma.sync d 64) on the encoder's
    non-causal pass q (8, 1500) over its 1500 frames and on the cross
    prefill's non-causal q (8, PREFILL_LEN) over 1500 keys (the plain
    version without the last key must fail the limit), and on the
    decoder's causal pass (8, PREFILL_LEN); decode_attention (the split
    routine at rep 1) over the cross cache of 1504 slots with 1500 live
    keys (the pad slots filled with 1e4, never read; the plain version
    at 1499 keys must fail) and over the 2048-slot self cache at a static
    step's lengths (the first SLOTS serve prompts + NEW_TOKENS, the
    engine's pow2 bound; ``lengths - 1`` must fail); rmsnorm at d_model
    1280 over an encoder pass's 12000 rows and a step's 8.  Returns each
    kernel's worst error."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import decode_split
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models import build_model
    from repro_torch.roofline import work
    from repro_torch.serve.engine import bucket_pow2

    cfg = get_config(ENCDEC_ARCH)
    h, kvh, d, Se = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.encoder_seq
    Sx = build_model(cfg.replace(num_layers=1, encoder_layers=1), device="cpu").cross_len
    bf = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev, dtype=bf)
    cpm = _sleep_cycles_per_ms(torch)
    clones = lambda *ts: (lambda i: tuple(t.clone() for t in ts))
    heads = lambda t: t.transpose(1, 2).contiguous()              # (b, s, h, d) -> (b, h, s, d)
    worst = {}

    def check(name, label, out, want):
        worst[name] = max(worst.get(name, 0.0), _check(torch, f"{name} {label}", out, want))

    def case(name, shape, kernel, plain, library, sets, lib_sets, w):
        record = dict(**_timed(torch, cpm, kernel, plain, library, sets, lib_sets,
                               plain_calls=3),
                      bound=_bound(w), shape=shape)
        _print_records({name: record})
        return record

    pl = fa.plan(bf, d, h // kvh)
    print(f"   flash_attention plan at d {d}: {pl.kernel}, {pl.rows} rows a block, {pl.block_k} "
          f"keys a tile, {pl.stages} stages, {pl.layout} rows of {fa.row_stride(pl.layout, d)} "
          f"elements, {pl.smem_bytes} B of shared memory")
    # -- flash_attention: the encoder (non-causal, 1500 frames), the cross
    #    prefill (non-causal, sq != sk) and the decoder's causal pass
    for sq, sk, causal, where in ((Se, Se, False, "encoder pass"),
                                  (PREFILL_LEN, Se, False, "cross-attention prefill"),
                                  (PREFILL_LEN, PREFILL_LEN, True, "decoder self-attention")):
        q, k, v = randn(SLOTS, sq, h, d), randn(SLOTS, sk, kvh, d), randn(SLOTS, sk, kvh, d)
        label = (f"{ENCDEC_ARCH} q ({SLOTS}, {sq}, {h}, {d}) over {sk} keys, "
                 f"{'causal' if causal else 'non-causal'}")
        want = ref.attention(q, k, v, causal=causal)
        check("flash_attention", label, fa.flash_attention(q, k, v, causal=causal), want)
        if not causal:
            _rejects(torch, f"flash_attention d {d} {where}: plain without the last key",
                     ref.attention(q, k[:, :-1], v[:, :-1], causal=False), want)
        del want
        nbytes = 2 * (2 * SLOTS * sq * h * d + 2 * SLOTS * sk * kvh * d)
        case(f"flash_attention {label}", where,
             lambda q_, k_, v_: fa.flash_attention(q_, k_, v_, causal=causal),
             lambda q_, k_, v_: ref.attention(q_, k_, v_, causal=causal),
             lambda q_, k_, v_: F.scaled_dot_product_attention(q_, k_, v_, is_causal=causal),
             _rotation(nbytes, clones(q, k, v)),
             _rotation(nbytes, lambda i: (heads(q), heads(k), heads(v))),
             work.flash_attention(SLOTS, sq, sk, h, kvh, d, causal=causal))
        del q, k, v

    # -- decode_attention at rep 1: the cross cache (1500 live keys of 1504
    #    slots, the pad slots never read) and the self cache at a static step
    dp = decode_split.plan(bf, d, h // kvh, 1, da.BLOCK_K)
    print(f"   decode_attention plan at d {d}, rep {h // kvh}: {dp.kernel}, {dp.split_keys} keys "
          f"a split, {dp.rows} rows a block ({h // kvh} live), {dp.smem_bytes} B of shared "
          f"memory; the cross cache {Sx} slots for {Se} frames")
    serve_lens = [int(x) + NEW_TOKENS for x in _serve_lengths(SEED)[:SLOTS]]
    self_bound = bucket_pow2(max(serve_lens), floor=PAGE, cap=MAX_SEQ)
    for S, lens_host, bound, where in (
            (Sx, [Se] * SLOTS, Se, "cross cache"),
            (MAX_SEQ, serve_lens, self_bound, "self cache, static step")):
        lengths = torch.tensor(lens_host, dtype=torch.int32, device=dev)
        q, kc, vc = randn(SLOTS, 1, h, d), randn(SLOTS, S, kvh, d), randn(SLOTS, S, kvh, d)
        if S > bound:
            kc[:, bound:] = 1e4
            vc[:, bound:] = 1e4
        label = (f"{ENCDEC_ARCH} q ({SLOTS}, 1, {h}, {d}), cache ({SLOTS}, {S}, {kvh}, {d}) "
                 f"{where}")
        kernel = lambda q_, k_, v_: da.decode_attention(q_, k_, v_, lengths, kv_bound=bound)
        plain = lambda q_, k_, v_: ref.decode_attention(q_, k_, v_, lengths, kv_bound=bound)
        want = plain(q, kc, vc)
        check("decode_attention", label, kernel(q, kc, vc), want)
        _rejects(torch, f"decode_attention d {d} rep 1 {where}: plain with lengths - 1",
                 ref.decode_attention(q, kc, vc, lengths - 1, kv_bound=bound), want)
        del want
        live = sum(lens_host)
        nbytes = 2 * 2 * SLOTS * h * d + 2 * 2 * live * kvh * d + 4 * SLOTS
        mask = (torch.arange(bound, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        case(f"decode_attention {label}", f"lengths {sorted(set(lens_host))}, kv_bound {bound}",
             kernel, plain,
             lambda q_, k_, v_: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=mask),
             _rotation(nbytes, clones(q, kc, vc)),
             _rotation(2 * 2 * SLOTS * bound * h * d,
                       lambda i: (heads(q), heads(kc[:, :bound]), heads(vc[:, :bound]))),
             work.decode_attention(SLOTS, h, kvh, d, live))
        del q, kc, vc, mask

    # -- rmsnorm at d_model: an encoder pass's rows and a decode step's
    D = cfg.d_model
    w = randn(D) * 0.1
    for rows in (SLOTS * Se, SLOTS):
        x = randn(rows, D)
        label = f"{ENCDEC_ARCH} ({rows}, {D})"
        check("rmsnorm", label, rn.rmsnorm(x, w), ref.rmsnorm(x, w))
        nbytes = 2 * (2 * rows * D + D)
        case(f"rmsnorm {label}", f"{rows} rows",
             rn.rmsnorm, ref.rmsnorm, lambda x_: F.rms_norm(x_, (D,), w, 1e-6),
             _rotation(nbytes, lambda i: (x.clone(), w)), _rotation(nbytes, clones(x)),
             work.rmsnorm(rows, D))
        del x
    return worst


def encdec_check_phase(torch, dev):
    """Reduced whisper-large-v3 in float32 at encoder_seq 16 and 20 (whose
    cross cache the model pads to 32 slots), card against CPU from the same
    weights and frames: ``generate`` greedy tokens equal (a ragged batch
    and a uniform one), ``forward`` logits within 1e-4 + 1e-4 |cpu|."""
    import numpy as np

    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServingEngine

    for Se in REDUCED_ENCODER_SEQS:
        cfg = _reduced(ENCDEC_ARCH).replace(encoder_seq=Se)
        cpu_model = build_model(cfg, device="cpu", dtype=torch.float32)
        cpu_params = cpu_model.init(seed=SEED)
        gpu_model = build_model(cfg, device=dev, dtype=torch.float32)
        gpu_params = _to_device(cpu_params, dev)
        prompts = [r.prompt for r in make_requests(6, 5, 60, 8, cfg.vocab_size, SEED)]
        uniform = [p[:5] for p in prompts[:3]]
        rng = np.random.default_rng(SEED + Se)
        frames = rng.normal(size=(3, Se, cfg.d_model)).astype(np.float32)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 48)))
        out = {}
        for name, model, params in (("cpu", cpu_model, cpu_params),
                                    ("cuda", gpu_model, gpu_params)):
            engine = ServingEngine(model, params, max_batch=3, max_seq=96, page_size=PAGE,
                                   device=model.device)
            ragged = np.concatenate([
                engine.generate(prompts[i:i + 3], 8, extra_inputs={"frames": frames}).tokens
                for i in (0, 3)])
            same = engine.generate(uniform, 8, extra_inputs={"frames": frames}).tokens
            logits, _ = model.forward(params, {"tokens": tokens.to(model.device),
                                               "frames": torch.from_numpy(frames[:2])})
            out[name] = (ragged, same, logits.cpu())
        tokens_ok = bool((out["cpu"][0] == out["cuda"][0]).all()
                         and (out["cpu"][1] == out["cuda"][1]).all())
        diff = float((out["cpu"][2] - out["cuda"][2]).abs().max())
        logits_ok = bool(torch.allclose(out["cuda"][2], out["cpu"][2], rtol=1e-4, atol=1e-4))
        print(f"   {cfg.name} f32, encoder_seq {Se} (cross cache {gpu_model.cross_len} slots), "
              f"6 ragged + 3 uniform prompts over random frames: generate cuda tokens == cpu "
              f"tokens: {tokens_ok}; forward logits {tuple(out['cpu'][2].shape)} max |cuda - "
              f"cpu| {diff:.3e} (within 1e-4 + 1e-4 |cpu|: {logits_ok})")
        if not (tokens_ok and logits_ok):
            raise SystemExit(f"{cfg.name} encoder_seq {Se}: the card differs from the CPU")


# decode steps of the run that splits self from cross decode_attention (few,
# so that the profiler keeps every record)
SPLIT_STEPS = 4


def _device_kernels(torch, fn, split_class):
    """Run ``fn()`` under torch.profiler (device activity only); its device
    kernels in stream order as (class, ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e.start_ns(), e.duration_ns() / 1e6, e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CUDA)
    return [(_kernel_class(name, split_class), ms) for _, ms, name in events]


def _encdec_profile(torch, engine, prompts, frames):
    """Where the time goes on the enc-dec path: ``generate`` on ``prompts``
    over ``frames`` under torch.profiler with 0 and with 16 new tokens (one
    prefill pass, then 16 decode steps; a step is the difference over 16),
    device ms by kernel class and the idle share (host and profiler
    overhead count as idle).  The encoder's share of the pass: ``encode``
    alone under the profiler.  Self against cross ``decode_attention``: a
    run of SPLIT_STEPS steps, whose decode launches come in stream order
    four a layer (the self call's split and combine kernels, then the
    cross call's); where the profiler lost a record the split is reported
    as not measured."""
    model = engine.model
    cfg = model.cfg
    L, Le = cfg.num_layers, cfg.encoder_layers
    run = lambda n: engine.generate(prompts, n, extra_inputs={"frames": frames})
    runs = {new: _profiled(torch, lambda n=new: run(n), "decode_attention") for new in (0, 16)}
    (_, pre_wall, prefill, _), (_, w16, c16, _) = runs[0], runs[16]
    if sum(c16.values()) <= 0:
        print("   profiler saw no device time: breakdown not measured")
        return
    fmt = lambda dct: ", ".join(f"{k} {v:.3f}" for k, v in dct.items())
    step = {k: (c16[k] - prefill[k]) / 16 for k in c16}
    step_wall = (w16 - pre_wall) / 16
    busy_pre, busy_step = sum(prefill.values()), sum(step.values())
    print(f"   {cfg.name}: prefill pass ({len(prompts)} prompts, padded to "
          f"{engine._pad_prompts(prompts)[0].shape[1]}, over {cfg.encoder_seq} frames): wall "
          f"{pre_wall:.3f} ms, device busy {busy_pre:.3f} ms (idle {1 - busy_pre / pre_wall:.3f});"
          f" device ms: {fmt(prefill)}")
    print(f"   {cfg.name}: decode step ({len(prompts)} rows): wall {step_wall:.3f} ms, device busy "
          f"{busy_step:.3f} ms (idle {1 - busy_step / step_wall:.3f}); device ms: {fmt(step)}")
    _, enc_wall, enc, _ = _profiled(torch, lambda: model.encode(engine.params, frames),
                                    "decode_attention")
    enc_flash, enc_busy = enc["flash_attention"], sum(enc.values())
    dec_flash = prefill["flash_attention"] - enc_flash
    print(f"   {cfg.name}: the encoder alone: wall {enc_wall:.3f} ms, device busy {enc_busy:.3f} ms "
          f"(matmul {enc['matmul']:.3f}, other {enc['other']:.3f}), of which flash_attention "
          f"{enc_flash:.3f} ms ({Le} launches, {enc_flash / Le:.4f} each); the decoder's "
          f"flash_attention in the pass {dec_flash:.3f} ms ({2 * L} launches, self and cross, "
          f"{dec_flash / (2 * L):.4f} each)")
    n = SPLIT_STEPS
    dec = [ms for cls, ms in _device_kernels(torch, lambda: run(n), "decode_attention")
           if cls == "decode_attention"]
    if len(dec) != 4 * L * n:
        print(f"   {cfg.name}: {len(dec)} decode_attention kernels in {n} steps, not "
              f"{4 * L * n}: the self/cross split is not measured")
        return
    self_ = sum(ms for i, ms in enumerate(dec) if i % 4 < 2) / n
    cross = sum(ms for i, ms in enumerate(dec) if i % 4 >= 2) / n
    print(f"   {cfg.name}: decode_attention a step ({n} steps): self {self_:.3f} ms ({L} calls, "
          f"{self_ / L:.4f} each), cross {cross:.3f} ms ({L} calls over {cfg.encoder_seq} keys, "
          f"{cross / L:.4f} each)")


def encdec_serve_phase(torch, dev, counters):
    """Full-width, full-depth whisper-large-v3 (32 encoder and 32 decoder
    layers, 20 heads of 64, 1500 frames; random bf16 weights, loaded once
    the earlier models are freed), each run counted alone with exact launch
    counts (``_dense_expected``: 96 flash_attention and 162 rmsnorm a
    prefill pass, 64 decode_attention and 97 rmsnorm a decode step, no
    other kernel): the static path on the serve mix (zero frames, as the
    driver feeds them), one run; one transcription-shaped ``generate``
    batch (SLOTS prompts of TRANSCRIBE_PROMPT tokens, TRANSCRIBE_NEW new
    tokens, random frames, ``max_seq`` TRANSCRIBE_MAX_SEQ); the profile of a
    prefill pass and a decode step; peak memory; and the refusals of
    ``serve_continuous`` and ``serve_paged`` (``NotImplementedError``, no
    launch)."""
    import numpy as np

    from repro_torch.launch.serve import make_requests
    from repro_torch.serve.engine import ServingEngine

    _release(torch)
    torch.cuda.reset_peak_memory_stats(dev)
    model, params = full_model(torch, dev, ENCDEC_ARCH)
    cfg, vocab = model.cfg, model.cfg.vocab_size
    print(f"   {ENCDEC_ARCH}: {cfg.encoder_layers} encoder + {cfg.num_layers} decoder layers, "
          f"{cfg.num_heads} heads of {cfg.resolved_head_dim} on {cfg.num_kv_heads} kv heads, "
          f"{cfg.encoder_seq} frames in a cross cache of {model.cross_len} slots; a prefill "
          f"pass {_dense_expected(model, 1, 0)}, a decode step {_dense_expected(model, 0, 1)}")
    _, engine, prompts, _ = dense_serve_phase(torch, dev, counters, model, params,
                                              continuous=False)
    peak = torch.cuda.max_memory_allocated(dev)

    # a transcription-shaped batch: short prompts, long decode, real frames
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 10)
    frames = torch.randn((SLOTS, cfg.encoder_seq, cfg.d_model), generator=gen, device=dev,
                         dtype=model.dtype)
    rng = np.random.default_rng(SEED + 10)
    short = [rng.integers(0, vocab, (TRANSCRIBE_PROMPT,)).astype(np.int32)
             for _ in range(SLOTS)]
    transcribe = ServingEngine(model, params, max_batch=SLOTS, max_seq=TRANSCRIBE_MAX_SEQ,
                               page_size=PAGE, device=dev)
    transcribe.generate(short[:2], 4, extra_inputs={"frames": frames[:2]})   # warm-up
    _zero(counters)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = transcribe.generate(short, TRANSCRIBE_NEW, extra_inputs={"frames": frames})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = sum(1 for t in res.tokens if len(t) == TRANSCRIBE_NEW and all(0 <= x < vocab for x in t))
    cnt = _check_counts(f"{ENCDEC_ARCH} transcription generate", counters,
                        _dense_expected(model, 1, TRANSCRIBE_NEW), done, SLOTS)
    peak = max(peak, torch.cuda.max_memory_allocated(dev))
    print(f"   {ENCDEC_ARCH} generate, transcription-shaped: {SLOTS} prompts of "
          f"{TRANSCRIBE_PROMPT} tokens over random frames, {TRANSCRIBE_NEW} new tokens, max_seq "
          f"{TRANSCRIBE_MAX_SEQ}: prefill (encoder + prompt) {res.prefill_s * 1e3:.1f} ms, decode "
          f"{res.decode_s * 1e3:.1f} ms ({res.tokens_per_s:.1f} tok/s, "
          f"{res.decode_s / TRANSCRIBE_NEW * 1e3:.3f} ms a step), wall {wall:.3f} s, distinct "
          f"tokens {len(np.unique(res.tokens))}; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; launches {cnt}")

    print(f"   {ENCDEC_ARCH} where the time goes (torch.profiler, generate; device ms):")
    _encdec_profile(torch, engine, prompts[:SLOTS],
                    torch.zeros((SLOTS, cfg.encoder_seq, cfg.d_model), device=dev,
                                dtype=model.dtype))

    # the engines the family does not take
    reqs = make_requests(2, 8, 16, 4, vocab, SEED)
    for name, run in (("serve_continuous", lambda: engine.serve_continuous(reqs)),
                      ("serve_paged", lambda: engine.serve_paged(reqs))):
        _zero(counters)
        try:
            run()
        except NotImplementedError as e:
            refused = "encoder-decoder" in str(e)
            print(f"   {ENCDEC_ARCH} {name}: refused ({e})")
        else:
            refused = False
        launched = {k: m.launches for k, m in counters.items() if m.launches}
        if not refused or launched:
            raise SystemExit(f"{ENCDEC_ARCH} {name}: not refused as the reference refuses it "
                             f"(launches {launched})")
    print(f"   {ENCDEC_ARCH}: peak device memory over its runs {peak / 1e9:.2f} GB")
    del model, params, engine, transcribe, frames
    _release(torch)


# ---------------------------------------------------------------------------
# the rest of serve_paged: chunked prefill, the prefix cache, preemption
# ---------------------------------------------------------------------------
CHUNK = 4 * PAGE                # chunked prefill's chunk: the engine's default of 4 pages
# chunk starts the flash kernel is timed at: 16 and 48 put the causal diagonal
# inside a 32-key tile of the bf16 d-128 kernel, the last is max_seq's last chunk
CHUNK_STARTS = (16, 48, 1008, MAX_SEQ - CHUNK)
# (pos0, chunk) held beside the serve mix's own (_serve_chunks): a 32-token
# last chunk, which the mix's lengths happen not to give
CHUNK_EXTRA = ((4 * CHUNK, 2 * PAGE),)
GEMMA_CHUNK_START = 4160        # past gemma2-27b's 4096 window
GRANITE_CHUNK_START = 1008
# the shared-prefix run: SharedPrefixLoad's mix (75% share one 512-token
# prefix, unique 128-token tails); from the slots' second wave on, every
# other shared prompt is the prefix alone, which the cache then holds whole
PREFIX_LEN, PREFIX_TAIL, PREFIX_SHARE = 512, 128, 0.75
# the overcommit run: the serve mix on a pool of 200 pages (the default is
# SLOTS * 128 + 1) admitted against twice its capacity
OVERCOMMIT, OVERCOMMIT_PAGES = 2.0, 200


def chunked_kernels_phase(torch, dev):
    """flash_attention at chunked prefill's shapes, bf16, d 128: a chunk at
    ``q_offset`` pos0 over pos0 + chunk keys.  glm4-9b (32 on 2) at every
    first and padded last chunk of the serve mix that phase 4 serves
    chunked (its first at q_offset 0, its 16- and 48-token last chunks) and
    at CHUNK_EXTRA, held against plain; glm4-9b at each of CHUNK_STARTS,
    gemma2-27b (32 on 16, softcap 50) past its 4096 window with each of its
    two windows, and granite-20b (48 on 1: 3072 rows a kv head), CHUNK-token
    chunks, each held against plain and timed beside its bound (the live
    (query, key) pairs, the keys a window leaves) and SDPA with the same
    mask (without the softcap, which it lacks).  Returns the worst error."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models.lm import GLOBAL_WINDOW
    from repro_torch.roofline import work

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev, dtype=torch.bfloat16)
    cpm = _sleep_cycles_per_ms(torch)
    d = 128
    gemma = get_config("gemma2-27b")
    # (arch, pos0, chunk, opts, timed): the serve mix's first and last chunks
    # and CHUNK_EXTRA are held against plain; the fixed starts are also timed
    served = sorted(set(_serve_chunks(_serve_lengths(SEED))) | set(CHUNK_EXTRA))
    print(f"   the serve mix's chunks (pos0, chunk) at {CHUNK}-token chunks: {served}")
    cases = [("glm4-9b", pos0, c, {}, False) for pos0, c in served]
    cases += [("glm4-9b", pos0, CHUNK, {}, True) for pos0 in CHUNK_STARTS]
    cases += [("gemma2-27b", GEMMA_CHUNK_START, CHUNK,
               dict(window=w, softcap=gemma.attn_softcap), True)
              for w in (gemma.sliding_window, GLOBAL_WINDOW)]
    cases += [("granite-20b", GRANITE_CHUNK_START, CHUNK, {}, True)]
    # qwen3-moe (32 on 4): the same chunks as its chunked run, one timed
    cases += [(MOE_ARCH, pos0, c, {}, False) for pos0, c in served]
    cases += [(MOE_ARCH, GRANITE_CHUNK_START, CHUNK, {}, True)]
    worst = 0.0
    for arch, pos0, c, opts, timed in cases:
        cfg = get_config(arch)
        h, kvh = cfg.num_heads, cfg.num_kv_heads
        rep, sk = h // kvh, pos0 + c
        q, k, v = randn(1, c, h, d), randn(1, sk, kvh, d), randn(1, sk, kvh, d)
        label = (f"flash_attention {arch} chunk q (1, {c}, {h}, {d}) at q_offset {pos0} over "
                 f"{sk} keys, kvh {kvh}" + "".join(f", {n} {x}" for n, x in opts.items()))
        kernel = lambda q_, k_, v_: fa.flash_attention(q_, k_, v_, q_offset=pos0, **opts)
        plain = lambda q_, k_, v_: ref.attention(q_, k_, v_, q_offset=pos0, **opts)
        worst = max(worst, _check(torch, label, kernel(q, k, v), plain(q, k, v)))
        if not timed:
            continue
        qpos = pos0 + torch.arange(c, device=dev)[:, None]
        kpos = torch.arange(sk, device=dev)[None, :]
        live = qpos >= kpos
        w = opts.get("window")
        if w:
            live &= qpos - kpos < w
        pairs = int(live.sum())
        first_key = max(0, pos0 - w + 1) if w else 0       # keys before it are dead
        nbytes = 2 * (2 * c * h * d + 2 * (sk - first_key) * kvh * d)
        sets = _rotation(nbytes, lambda i: (q.clone(), k.clone(), v.clone()))
        lib_sets = _rotation(2 * (2 * c * h * d + 2 * sk * h * d),
                             lambda i: (q.transpose(1, 2).contiguous(),
                                        k.transpose(1, 2).repeat_interleave(rep, dim=1),
                                        v.transpose(1, 2).repeat_interleave(rep, dim=1)))
        mask = live[None, None]
        library = lambda q_, k_, v_: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=mask)
        record = dict(**_timed(torch, cpm, kernel, plain, library, sets, lib_sets),
                      bound=_bound(work.flash_attention(1, c, sk, h, kvh, d, q_offset=pos0,
                                                        window=w)),
                      shape=f"{pairs} live pairs" + (
                          "; library: SDPA without the softcap" if "softcap" in opts else ""))
        _print_records({label: record})
        del q, k, v, sets, lib_sets
    return worst


def _serve_chunks(lengths):
    """(pos0, chunk) of each prompt's first and last chunk as chunked
    prefill cuts it at CHUNK tokens: a last chunk of c tokens is right-
    padded to a page multiple, so flash sees pos0 + padded keys."""
    shapes = []
    for n in lengths:
        last = (int(n) - 1) // CHUNK * CHUNK
        c = min(CHUNK, -(-(int(n) - last) // PAGE) * PAGE)
        shapes += [(0, min(CHUNK, -(-int(n) // PAGE) * PAGE)), (last, c)]
    return shapes


def _shared_prompts(vocab, seed, n, prefix_len, tail, first_wave):
    """``SharedPrefixLoad``'s prompts (share PREFIX_SHARE, one group), with
    every other shared prompt from index ``first_wave`` on cut to the prefix
    alone: a page-aligned prompt the cache holds whole once an earlier
    request has prefilled it."""
    from repro_torch.core.workload import SharedPrefixLoad, shared_prefix_prompts

    load = list(SharedPrefixLoad(n, rate_hz=RATE_HZ, prefix_len=prefix_len, suffix_len=tail,
                                 share_ratio=PREFIX_SHARE, num_groups=1, seed=seed).requests())
    prompts = shared_prefix_prompts(load, vocab, seed=seed)
    return [p[:prefix_len] if i >= first_wave and r.tags["prefix_group"] >= 0 and i % 2 == 0
            else p for i, (r, p) in enumerate(zip(load, prompts))]


def paged_paths_check(torch, dev, arch="glm4-9b", cf=None):
    """Reduced ``arch`` in float32 (at capacity factor ``cf`` if given), card
    against CPU on the rest of ``serve_paged``: chunked prefill (one-page
    chunks), the prefix cache on shared-prefix prompts (partial and full
    hits, with copy-on-write), with packed and with chunked prefill, and
    overcommit on a 6-page pool (preemption).  The card's tokens must equal
    the CPU's, and (a dense model) the card's packed, cache-off and
    undisturbed runs of the same prompts: a MoE model routes each launch's
    tokens as one group, so where it drops slots those paths may differ,
    and their agreement is printed, not held."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import DecoderLM
    from repro_torch.serve.engine import ServeRequest, ServingEngine

    cfg = _reduced(arch, cf)
    cpu_model = DecoderLM(cfg, device="cpu", dtype=torch.float32)
    cpu_params = cpu_model.init(seed=SEED)
    gpu_model = DecoderLM(cfg, device=dev, dtype=torch.float32)
    gpu_params = _to_device(cpu_params, dev)
    shared = _shared_prompts(cfg.vocab_size, SEED, 8, 2 * PAGE, 12, first_wave=3)
    plain_reqs = lambda: make_requests(6, 5, 60, 8, cfg.vocab_size, SEED)
    # 24 new tokens: enough page growth that a 6-page pool runs dry
    long_reqs = lambda: make_requests(6, 5, 60, 24, cfg.vocab_size, SEED)
    shared_reqs = lambda: [ServeRequest(request_id=i, prompt=p, max_new_tokens=8)
                           for i, p in enumerate(shared)]
    variants = {
        "packed": (plain_reqs, {}),
        "chunked": (plain_reqs, dict(prefill_mode="chunked", prefill_chunk=PAGE)),
        "cache off": (shared_reqs, {}),
        "cache on": (shared_reqs, dict(prefix_cache=True)),
        "cache on, chunked": (shared_reqs, dict(prefix_cache=True, prefill_mode="chunked")),
        "24 new, undisturbed": (long_reqs, {}),
        "24 new, overcommit": (long_reqs, dict(num_pages=7, overcommit=10.0)),
    }
    runs = {}
    for name, model, params in (("cpu", cpu_model, cpu_params), ("cuda", gpu_model, gpu_params)):
        engine = ServingEngine(model, params, max_batch=3, max_seq=96, page_size=PAGE,
                               device=model.device)
        for v, (reqs, kw) in variants.items():
            runs[name, v] = engine.serve_paged(reqs(), prefill_budget=64, **kw)
            _check_ledger(f"the rest of serve_paged, {name} {v}", runs[name, v])
    tok = lambda key: [r.tokens for r in runs[key].results]
    same = lambda a, b: _agreement(tok(a), tok(b))[2] is None
    card_cpu = {v: same(("cpu", v), ("cuda", v)) for v in variants}
    within = {"chunked": "packed", "cache on": "cache off", "cache on, chunked": "cache off",
              "24 new, overcommit": "24 new, undisturbed"}
    card_card = {v: same(("cuda", base), ("cuda", v)) for v, base in within.items()}
    on, pre = runs["cuda", "cache on"], runs["cuda", "24 new, overcommit"]
    exact = cfg.family != "moe"
    print(f"   reduced {arch} f32{_cf_label(cfg)}, the rest of serve_paged: cuda tokens == cpu "
          f"tokens {card_cpu}; on the card == {within}"
          + ("" if exact else " (printed, not held)") + f": {card_card}")
    print(f"      cache on: {on.prefix_stats}, saved {on.saved_prefill_tokens} tokens, "
          f"cow_copies {on.cow_copies}; overcommit: preemptions {pre.preemptions}, dropped "
          f"{pre.prefill_tokens_dropped}; chunked: "
          f"{runs['cuda', 'chunked'].prefill_launches} chunks")
    if not (all(card_cpu.values()) and (all(card_card.values()) or not exact)):
        raise SystemExit("the rest of serve_paged: the card's tokens differ from the CPU's or "
                         "between paths that must agree")
    if not (on.prefix_stats["full_hits"] > 0 and on.prefix_stats["hits"] >
            on.prefix_stats["full_hits"] and on.cow_copies > 0 and pre.preemptions > 0):
        raise SystemExit("the rest of serve_paged: the reduced check hit no full and partial "
                         "prefix, copied no page or preempted nothing")


def _fmt_run(torch, dev, m, stats, label, base=None):
    """One run's line: ``_fmt_metrics``, peak memory and, with ``base`` (its
    name, its stats), the token agreement with it."""
    agree = "" if base is None else f"; vs {base[0]}: " + _fmt_agreement(
        [r.tokens for r in base[1].results], [r.tokens for r in stats.results])
    return (f"   {label}: {_fmt_metrics(m, stats)}; peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB{agree}")


def paged_paths_serve_phase(torch, dev, counters, engine, reqs, base):
    """Full glm4-9b, bf16, the rest of ``serve_paged``, each run once and
    counted alone: the serve mix with chunked prefill (exactly 40
    flash_attention launches a chunk, no varlen_prefill); shared-prefix
    prompts with the cache off and on (exact varlen_prefill launches, saved
    prompt tokens, full hits and copies above 0); the serve mix at
    overcommit OVERCOMMIT on OVERCOMMIT_PAGES pages (preemptions above 0).
    Each prints prefill tok/s, TTFT p50, peak memory and its token
    agreement with its baseline (bf16 at full width need not be bit-equal
    across paths whose matmul row counts differ; phase 3 holds them exactly
    in float32)."""
    from repro_torch.launch.serve import engine_metrics
    from repro_torch.serve.engine import ServeRequest

    L = engine.model.cfg.num_layers

    def run(label, prompts, need, base=None, **kw):
        torch.cuda.reset_peak_memory_stats(dev)
        stats, counts = _counted_serve(torch, engine, prompts, counters, need, **kw)
        print(_fmt_run(torch, dev, engine_metrics(stats), stats, label, base))
        print(f"      launches {counts}")
        return stats, counts

    chunked, counts = run(f"chunked prefill ({CHUNK}-token chunks), the run-1 prompts", reqs,
                          ("rmsnorm", "paged_attention", "flash_attention"),
                          ("packed run 1", base), prefill_mode="chunked")
    if counts["flash_attention"] != L * chunked.prefill_launches or counts["varlen_prefill"]:
        raise SystemExit("chunked prefill: not one flash_attention launch a layer and chunk")
    shared = _shared_prompts(engine.model.cfg.vocab_size, SEED, REQUESTS, PREFIX_LEN,
                             PREFIX_TAIL, first_wave=SLOTS)
    shared_reqs = [ServeRequest(request_id=i, prompt=p, max_new_tokens=NEW_TOKENS)
                   for i, p in enumerate(shared)]
    need = ("rmsnorm", "paged_attention", "varlen_prefill")
    label = f"shared {PREFIX_LEN}-token prefix ({PREFIX_SHARE} share, {PREFIX_TAIL}-token tails)"
    off, _ = run(f"{label}, cache off", shared_reqs, need)
    on, _ = run(f"{label}, cache on", shared_reqs, need, ("cache off", off), prefix_cache=True)
    print(f"      cache on: {on.prefix_stats}; saved {on.saved_prefill_tokens} prompt tokens, "
          f"cow_copies {on.cow_copies}")
    if not (on.saved_prefill_tokens > 0 and on.cow_copies > 0
            and on.prefix_stats["full_hits"] > 0):
        raise SystemExit("prefix cache: no saved tokens, full hit or copy-on-write at full width")
    pre, _ = run(f"overcommit {OVERCOMMIT} on {OVERCOMMIT_PAGES} pages, the run-1 prompts",
                 reqs, need, ("undisturbed run 1", base), num_pages=OVERCOMMIT_PAGES,
                 overcommit=OVERCOMMIT)
    print(f"      preemptions {pre.preemptions}, prompt tokens dropped "
          f"{pre.prefill_tokens_dropped}, admitted {pre.prompt_tokens_admitted}")
    if not pre.preemptions:
        raise SystemExit("overcommit: nothing was preempted at full width")
    return first_token_check(torch, dev, engine.model, engine.params, reqs, chunked, [
        ("chunked vs packed", reqs, base, chunked),
        ("cache on vs off", shared_reqs, off, on),
        ("overcommit vs undisturbed", reqs, base, pre)])


def first_token_check(torch, dev, model, params, reqs, chunked, pairs):
    """Whether the bf16 token differences of the runs above are rounding.
    The same bf16 weights in float32 give reference logits.  For each serve
    prompt: the chunked path's last-token logits (``prefill_paged_chunk``
    chunk by chunk, as the engine cuts them) and the static bf16 prefill's,
    each one's max |logit - reference| beside the reference's top-2 margin;
    the chunked argmax must be the chunked run's first token, and the
    chunked error at most twice the static one (plus TOL_FLOOR times the
    reference's rms, where both are float32 rounding).  Then for each (label,
    requests, baseline, run) in ``pairs``, at every request's first
    differing token: the reference's margin between the two tokens, which
    two bf16 paths can flip only where it is at most twice their error.  It
    must be at most twice E, the largest bf16 error measured here."""
    import numpy as np

    from repro_torch.models import DecoderLM

    ref_model = DecoderLM(model.cfg, device=dev, dtype=torch.float32)
    ref_params = _tree_map(params, lambda t: t.float())
    max_pages = MAX_SEQ // PAGE
    row = torch.arange(1, max_pages + 1, device=dev, dtype=torch.int32)

    def dense(m, p, ctx):
        tokens = torch.as_tensor(np.asarray(ctx, np.int32), device=dev)[None]
        return m.prefill(p, {"tokens": tokens}, m.init_cache(1, len(ctx)))[0]

    def chunk_path(ctx):
        cache = model.init_paged_cache(max_pages + 1, PAGE)
        for start in range(0, len(ctx), CHUNK):
            c = min(CHUNK, len(ctx) - start)
            chunk = torch.zeros((1, min(CHUNK, -(-c // PAGE) * PAGE)), dtype=torch.int32,
                                device=dev)
            chunk[0, :c] = torch.as_tensor(np.asarray(ctx[start:start + c], np.int32))
            logits = model.prefill_paged_chunk(params, chunk, cache, row, c - 1, start)
        return logits[0]

    err = lambda a, b: float((a - b).abs().max())
    e_dense, e_chunk, same_first, rms = [], [], 0, 0.0
    print("      first-token logits, bf16 against the same weights in float32 "
          "(request: |chunked - f32|, |static - f32|, f32 top-2 margin, chunked/static "
          "argmax == f32's):")
    for r, got in zip(reqs, chunked.results):
        ctx = r.prompt.tolist()
        ref = dense(ref_model, ref_params, ctx)
        bf, ch = dense(model, params, ctx), chunk_path(ctx)
        e_dense.append(err(bf, ref))
        e_chunk.append(err(ch, ref))
        top = ref.topk(2).values
        rms = max(rms, float(ref.pow(2).mean().sqrt()))
        same_first += int(ch.argmax()) == int(got.tokens[0])
        print(f"      {r.request_id}: {e_chunk[-1]:.4f}, {e_dense[-1]:.4f}, "
              f"{float(top[0] - top[1]):.4f}, {int(ch.argmax()) == int(ref.argmax())}/"
              f"{int(bf.argmax()) == int(ref.argmax())}")
    print(f"      the chunked run's first tokens == these chunked logits' argmax: "
          f"{same_first}/{len(reqs)}; max error chunked {max(e_chunk):.4f}, "
          f"static {max(e_dense):.4f}")
    if same_first != len(reqs):
        raise SystemExit("chunked prefill: the run's first tokens are not its logits' argmax")
    if max(e_chunk) > 2 * max(e_dense) + TOL_FLOOR * rms:
        raise SystemExit("chunked prefill: its logits are further from float32 than twice "
                         "the static prefill's")
    flips = []
    for label, prompts, want, got in pairs:
        for r, a, b in zip(prompts, want.results, got.results):
            a, b = np.asarray(a.tokens), np.asarray(b.tokens)
            if np.array_equal(a, b):
                continue
            t = int(np.argmin(a == b))
            ctx = r.prompt.tolist() + a[:t].tolist()
            ref = dense(ref_model, ref_params, ctx)
            e_dense.append(err(dense(model, params, ctx), ref))
            flips.append((label, r.request_id, t, abs(float(ref[int(a[t])] - ref[int(b[t])]))))
    E = max(e_dense + e_chunk)
    for label, _, _, _ in pairs:
        mine = [(i, t, round(m, 4)) for lab, i, t, m in flips if lab == label]
        print(f"      {label}: {len(mine)} requests differ; (request, first differing token, "
              f"f32 margin of the two tokens) {mine}; 2E = {2 * E:.4f}")
    del ref_params
    _release(torch)
    if any(m > 2 * E for _, _, _, m in flips):
        raise SystemExit("a bf16 run flips a token where float32 separates the two by more "
                         "than twice the bf16 error: not rounding")
    return E


# ---------------------------------------------------------------------------
# the fault-tolerant fleet: faults and live KV migration
# ---------------------------------------------------------------------------
# the reference's recovery matrix (tests/test_recovery.py), recovery migrate;
# the corrupt cell leaves a cadence gap between the bite and the crash (a
# refresh in between would heal the snapshot)
FLEET_MATRIX = {
    "crash": ("crash@1:2", 1, None),
    "stall": ("stall@1:1:0.02", 1, None),
    "drain": ("", 0, (1, 2)),
    "corrupt": ("corrupt@1:4,crash@1:5", 3, None),
}
# the counters a fleet run must share across devices
FLEET_COUNTERS = ("deaths", "requeued", "migrated", "migrated_tokens",
                  "recomputed_prefill_tokens", "checkpoints_saved", "checksum_failures",
                  "drains", "bytes_moved")
FLEET_WORKERS = 2                # phase 4b
FLEET_CKPT = 4                   # decode steps between checkpoints (phase 4b)
# phase 4b: (label, fault plan, FleetConfig overrides, drain (worker, step),
# kv_dtype, planned (deaths, drains, checksum_failures)).  The stall outlasts
# worker 1's lease on the host's real clock, so its next heartbeat renewal
# fails.  Its workers run in parallel: in sequential rounds a worker's lease
# lapses while the workers before it serve.  No hedging, so that the stalled
# worker's crash (and its snapshots) reach the router before its requests
# are dispatched again; the lease is twice the longest boundary measured
# with checkpoints (printed per run)
FLEET_RUNS = (
    ("fault-free", "", {}, None, None, (0, 0, 0)),
    ("crash@1:8, migrate", "crash@1:8", {}, None, None, (1, 0, 0)),
    ("crash@1:8, replay", "crash@1:8", {"recovery": "replay"}, None, None, (1, 0, 0)),
    ("corrupt@1:9 then crash@1:10, checkpoint every 8", "corrupt@1:9,crash@1:10",
     {"checkpoint_every": 8}, None, None, (1, 0, 1)),
    ("stall@1:8:2.0 past a 1.0 s lease, parallel workers", "stall@1:8:2.0",
     {"lease_ttl_s": 1.0, "parallel": True, "hedge": False}, None, None, (1, 0, 0)),
)


class _Recorded:
    """A fleet worker whose ``serve_paged`` runs that return are kept (the
    router folds only their migration counters): the launch counts and the
    prompt-token ledger are checked on them."""

    def __init__(self, engine):
        self.engine = engine
        self.runs = []

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def serve_paged(self, reqs, **kw):
        stats = self.engine.serve_paged(reqs, **kw)
        self.runs.append(stats)
        return stats


class _Harvest(dict):
    """The router's migration store, keeping every snapshot harvested from a
    dead or drained worker (the store itself gives them up on restore)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __setitem__(self, rid, snap):
        self.seen.append(snap)
        super().__setitem__(rid, snap)


def _timed_hooks(router):
    """Wrap each worker's boundary hook to keep its longest gap between two
    boundaries of one ``serve_paged`` run (host clock), by worker."""
    gaps = {}
    for w in router.workers:
        inner, last = w.hook, {}

        def hook(ctx, inner=inner, i=w.index, last=last):
            now = time.perf_counter()
            if last.get("pool") is ctx.pool:
                gaps[i] = max(gaps.get(i, 0.0), now - last["t"])
            last.update(t=now, pool=ctx.pool)
            inner(ctx)

        hook.release = inner.release
        w.hook = hook
    return gaps


def _fleet_run(engines, reqs, engine_kwargs, plan="", drain=None, join=None, **cfg):
    """One fleet run, traced: (stats, spans, the harvested snapshots, the
    longest boundary by worker)."""
    from repro_torch.core.tracing import Tracer, TracingServer
    from repro_torch.serve.faults import FaultPlan
    from repro_torch.serve.fleet import FleetConfig, FleetRouter

    server = TracingServer()
    router = FleetRouter(engines, FleetConfig(**cfg), engine_kwargs=engine_kwargs,
                         fault_plan=FaultPlan.parse(plan), tracer=Tracer("fleet", server))
    router._migrations = _Harvest()
    gaps = _timed_hooks(router)
    if drain:
        router.drain(*drain)
    if join is not None:
        router.join(join, at_round=1)
    stats = router.serve(reqs)
    ids = sorted(r.request_id for r in stats.results)
    if ids != sorted(r.request_id for r in reqs) or len(set(ids)) != len(ids):
        raise SystemExit("fleet: a request is not terminal exactly once")
    return stats, server.timeline("fleet"), router._migrations.seen, gaps


def _events(spans, name):
    return [s for s in spans if s.name == name]


def _rejected_never_restored(label, stats, spans):
    """A corrupt run: some checksum failed, and no request whose snapshot
    failed was restored from it."""
    failed = {s.tags["request"] for s in _events(spans, "migrate:checksum_fail")}
    restored = {s.tags["request"] for s in _events(spans, "migrate:restore")}
    if not stats.checksum_failures or not failed or failed & restored:
        raise SystemExit(f"{label}: no checksum failure, or a rejected snapshot was restored")


def fleet_check(torch, dev):
    """Reduced glm4-9b in float32, one set of weights on both devices: the
    reference's recovery matrix {crash, stall, drain (a fourth worker
    joining), corrupt} with ``recovery="migrate"``, three workers, ``spec_k``
    0 and 2, the prefix cache on, on a float32 and an int8 pool, on the
    card and on the CPU.  Every request completes; the card's tokens equal
    the CPU's and the card's own fault-free run; each request's (status,
    worker, attempts) and the fleet's counters equal the CPU's; the corrupt
    runs count a checksum failure and restore nothing they rejected."""
    import numpy as np

    from repro_torch.models import DecoderLM
    from repro_torch.serve.engine import ServeRequest, ServingEngine

    cfg = _reduced("glm4-9b")
    cpu_model = DecoderLM(cfg, device="cpu", dtype=torch.float32)
    cpu_params = cpu_model.init(seed=SEED)
    gpu_model = DecoderLM(cfg, device=dev, dtype=torch.float32)
    gpu_params = _to_device(cpu_params, dev)
    rng = np.random.default_rng(SEED)
    shared = rng.integers(0, cfg.vocab_size, (PAGE,))
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, (8,))]).astype(np.int32)
               for _ in range(6)]
    reqs = lambda: [ServeRequest(request_id=i, prompt=p, max_new_tokens=8)
                    for i, p in enumerate(prompts)]
    runs = {}
    for kv in (None, "int8"):
        for name, model, params in (("cpu", cpu_model, cpu_params),
                                    ("cuda", gpu_model, gpu_params)):
            engines = [ServingEngine(model, params, max_batch=4, max_seq=64, page_size=PAGE,
                                     device=model.device, kv_dtype=kv) for _ in range(4)]
            for spec_k in (0, 2):
                kw = dict(num_slots=4, page_size=PAGE, spec_k=spec_k, prefix_cache=True)
                runs[name, kv, spec_k, "fault-free"] = _fleet_run(engines[:3], reqs(), kw)
                for kind, (plan, every, drain) in FLEET_MATRIX.items():
                    runs[name, kv, spec_k, kind] = _fleet_run(
                        engines[:3], reqs(), kw, plan, drain, engines[3] if drain else None,
                        recovery="migrate", checkpoint_every=every)
    bad = []
    for (name, kv, spec_k, kind), (stats, spans, _, _) in runs.items():
        if name == "cpu":
            continue
        label = f"{kv or 'f32'} pool, spec_k {spec_k}, {kind}"
        cpu = runs["cpu", kv, spec_k, kind][0]
        own = runs["cuda", kv, spec_k, "fault-free"][0]
        outcome = lambda st: [(r.status, r.worker, r.attempts) for r in st.results]
        tokens = lambda st: [r.tokens for r in st.results]
        if not (stats.completed == len(prompts) and outcome(stats) == outcome(cpu)
                and _agreement(tokens(cpu), tokens(stats))[2] is None
                and _agreement(tokens(own), tokens(stats))[2] is None
                and all(getattr(stats, f) == getattr(cpu, f) for f in FLEET_COUNTERS)):
            bad.append(label)
        if kind == "corrupt":
            _rejected_never_restored(f"reduced fleet, {label}", stats, spans)
        if kind in ("crash", "drain") and not stats.migrated:
            bad.append(f"{label}: nothing migrated")
    for kv in (None, "int8"):
        line = ", ".join(
            f"{kind} " + "/".join(str(getattr(runs["cuda", kv, 0, kind][0], f))
                                  for f in ("deaths", "drains", "migrated", "checksum_failures"))
            for kind in FLEET_MATRIX)
        print(f"   reduced glm4-9b f32, fleet of 3, {kv or 'float32'} pool, spec_k 0 and 2, "
              f"prefix cache on: (deaths/drains/migrated/checksum_failures, spec_k 0) {line}")
    print(f"   fleet card == CPU (tokens, outcomes, counters) and == the card's fault-free run "
          f"in {len(runs) // 2 - len(bad)} of {len(runs) // 2} runs")
    if bad:
        raise SystemExit(f"fleet: the card differs from the CPU or its fault-free run: {bad}")


def _median_ms(spans, name):
    d = sorted(s.duration * 1e3 for s in _events(spans, name))
    return d[len(d) // 2] if d else float("nan")


def _roundtrip_check(torch, dev, model, snap, kv):
    """One snapshot imported into a fresh pool and exported again: the same
    bytes, scales included."""
    from repro_torch.kernels import ops

    n = snap.num_pages
    cache = model.init_paged_cache(2 * n + 3, PAGE, kv)
    dst = list(range(2 * n + 2, n + 2, -1))         # fresh pages, reversed
    scales = (snap.k_scales, snap.v_scales) if snap.k_scales is not None else (None, None)
    ops.import_pages(cache["k_pages"], cache["v_pages"], dst, snap.k, snap.v,
                     cache.get("k_scales"), cache.get("v_scales"), *scales)
    again = ops.export_pages(cache["k_pages"], cache["v_pages"], dst, cache.get("k_scales"),
                             cache.get("v_scales"))
    raw = lambda t: t.cpu().contiguous().view(torch.uint8)
    src = [snap.k, snap.v] + [s for s in scales if s is not None]
    if len(again) != len(src) or not all(torch.equal(raw(a), raw(b))
                                         for a, b in zip(again, src)):
        raise SystemExit("fleet: a snapshot imported into a fresh pool exports other bytes")


def fleet_serve_phase(torch, dev, counters, model, params, reqs):
    """Full glm4-9b, bf16: FLEET_WORKERS workers sharing the model behind
    the ``FleetRouter`` on the serve mix, checkpoints every FLEET_CKPT
    decode steps, each run of FLEET_RUNS counted alone (launch counts zeroed
    before it, read after).  Every request terminal exactly once; deaths,
    drains and checksum failures as planned; migrations in the migrate runs
    and none in the replay run, which recomputes more prompt tokens; every
    harvested snapshot verifies (but the one the corrupt run bit); one
    snapshot round-trips through a fresh pool byte for byte; varlen_prefill,
    paged_attention and rmsnorm launch in every run, exactly 40 and 81 a
    pass in the fault-free run (summed over the workers' runs); the
    prompt-token ledger balances on every worker run that returned.
    Printed: each run's token agreement with the fault-free run (bf16
    batches differ across workers), fleet tok/s, recovery_max_s, snapshot
    bytes a token, bytes moved and the median ``ckpt:save`` and
    ``migrate:restore`` spans."""
    from repro_torch.kernels import kvquant
    from repro_torch.serve.engine import ServeRequest, ServingEngine

    cfg = model.cfg
    need = ("rmsnorm", "paged_attention", "varlen_prefill")
    kw = dict(num_slots=SLOTS, page_size=PAGE, prefill_budget=BUDGET)
    fresh = lambda: [ServeRequest(request_id=r.request_id, prompt=r.prompt,
                                  max_new_tokens=r.max_new_tokens) for r in reqs]
    results = {}
    for label, plan, over, drain, kv, planned in FLEET_RUNS:
        # the workers share the model and its weights; each has its own pool
        engines = [_Recorded(ServingEngine(model, params, max_batch=SLOTS, max_seq=MAX_SEQ,
                                           page_size=PAGE, device=dev, kv_dtype=kv))
                   for _ in range(FLEET_WORKERS)]
        cfg_kw = {"recovery": "migrate", "checkpoint_every": FLEET_CKPT, **over}
        torch.cuda.reset_peak_memory_stats(dev)
        _zero(counters)
        stats, spans, harvested, gaps = _fleet_run(engines, fresh(), kw, plan, drain, **cfg_kw)
        torch.cuda.synchronize()
        counts = {name: mod.launches for name, mod in counters.items()}
        results[label] = stats
        got = (stats.deaths, stats.drains, stats.checksum_failures)
        if got != planned:
            raise SystemExit(f"fleet {label}: (deaths, drains, checksum_failures) {got}, "
                             f"planned {planned}")
        if stats.completed != len(reqs):
            raise SystemExit(f"fleet {label}: {stats.completed} of {len(reqs)} completed")
        migrate = cfg_kw["recovery"] == "migrate"
        if (stats.migrated > 0) != (migrate and label != "fault-free"):
            raise SystemExit(f"fleet {label}: {stats.migrated} requests migrated")
        if [name for name in need if not counts[name]]:
            raise SystemExit(f"fleet {label}: a kernel of the path never launched: {counts}")
        worker_runs = [st for e in engines for st in e.runs]
        for st in worker_runs:
            _check_ledger(f"fleet {label}", st)
        if label == "fault-free":
            expect = {}
            for st in worker_runs:
                for name, n in _expected_launches(st, cfg).items():
                    expect[name] = expect.get(name, 0) + n
            _check_counts(f"fleet {label}", counters, expect, stats.completed, len(reqs))
        broken = [s for s in harvested if not s.verify()]
        if len(broken) != planned[2]:
            raise SystemExit(f"fleet {label}: {len(broken)} harvested snapshots fail verify, "
                             f"planned {planned[2]}")
        if planned[2]:
            _rejected_never_restored(f"fleet {label}", stats, spans)
        reasons = sorted(s.tags["reason"] for s in _events(spans, "fleet:death"))
        if "lease_ttl_s" in over and reasons != ["lease-expired"]:
            raise SystemExit(f"fleet {label}: deaths {reasons}, not one lease expiry")
        snap_line = ""
        if harvested:
            snap = next(s for s in harvested if s.verify())
            per_token = snap.nbytes / (snap.num_pages * PAGE)
            want = kvquant.kv_bytes_per_token(cfg.num_layers, cfg.num_kv_heads,
                                              cfg.resolved_head_dim, kv or "bfloat16")
            if per_token != want:
                raise SystemExit(f"fleet {label}: {per_token} snapshot bytes a token, "
                                 f"expected {want}")
            _roundtrip_check(torch, dev, model, snap, kv)
            snap_line = (f"; snapshots harvested {len(harvested)}, {per_token:.0f} B a token, "
                         f"round trip through a fresh pool bit-equal")
        base = results["fault-free"]
        recovery = max(stats.recovery_s) if stats.recovery_s else 0.0
        print(f"   {label}: fleet {stats.throughput_tps:.1f} tok/s, wall {stats.wall_s:.3f} s, "
              f"rounds {stats.rounds}, deaths {stats.deaths}, drains {stats.drains}, requeued "
              f"{stats.requeued}, migrated {stats.migrated} ({stats.migrated_tokens} tokens), "
              f"recomputed prefill tokens {stats.recomputed_prefill_tokens}, bytes moved "
              f"{stats.bytes_moved}, checkpoints {stats.checkpoints_saved} "
              f"({stats.checkpoint_bytes} B), checksum failures {stats.checksum_failures}, "
              f"recovery_max_s {recovery:.4f}; ckpt:save median "
              f"{_median_ms(spans, 'ckpt:save'):.3f} ms ({len(_events(spans, 'ckpt:save'))}), "
              f"migrate:restore median {_median_ms(spans, 'migrate:restore'):.3f} ms "
              f"({len(_events(spans, 'migrate:restore'))}); longest boundary by worker (s) "
              f"{ {i: round(g, 4) for i, g in sorted(gaps.items())} }; deaths {reasons}; peak "
              f"device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB{snap_line}")
        print(f"      launches {counts}; vs fault-free: " + _fmt_agreement(
            [r.tokens for r in base.results], [r.tokens for r in stats.results]))
    migrate, replay = results["crash@1:8, migrate"], results["crash@1:8, replay"]
    print(f"   recomputed prefill tokens after the crash: migrate "
          f"{migrate.recomputed_prefill_tokens}, replay {replay.recomputed_prefill_tokens}")
    if not migrate.recomputed_prefill_tokens < replay.recomputed_prefill_tokens:
        raise SystemExit("fleet: migration recomputed no fewer prompt tokens than replay")


# ---------------------------------------------------------------------------
# tensor-parallel paged serving: two ranks on the one card
# ---------------------------------------------------------------------------
TP = 2
TP_MOE_LAYERS = 12              # qwen3-moe-30b-a3b cut to 12 of its 48 layers (two ranks' weights)
TP_SPEC_SLOTS = 4               # the speculative TP run: 4 tiled prompts, each twice, on 4 slots
# the float32 probe at full width: glm4-9b cut to 2 of its 40 layers (every
# split at its published size), tp 2 vs tp 1; the first prompt's logits
# within TP_F32_TOL of tp 1's largest (the two differ only in the order of
# float32 sums: the partials of the row-parallel products added across ranks)
TP_F32_LAYERS = 2
TP_F32_TOL = 1e-4
# phase 7's dry-run check: glm4-9b at full width, bf16, a prefill of
# DRY_BATCH x DRY_PROMPT tokens into a (DRY_BATCH, DRY_CACHE) cache, then
# DRY_STEPS decode steps, at tp 1 here and on the world's two ranks, each
# call counted and held against ``repro_torch.launch.dryrun``'s count of the
# same cell on the same mesh: FLOPs, bytes and the collective ledger equal;
# the bytes the call added at its peak (``max_memory_allocated`` less what
# was allocated before it), printed hit or miss against two limits: at
# most the dry run's peak_per_device_bytes less its arguments (output +
# temp - alias, the reference's formula, a bound) plus DRY_MEM_SLACK, and
# within DRY_MEM_TOL of the dry run's live_peak_bytes (its timeline's own
# peak) plus DRY_MEM_SLACK: the caching allocator hands out a cached block
# whole where the rest would be under 1 MiB, so a large storage may take up
# to 1 MiB more, two of them at a peak.  Then granite-20b reduced, float32,
# with the cache's sequence split over 2 ranks (kv_seq) and with FSDP over a
# data axis of 2: tokens equal tp 1's.
DRY_BATCH, DRY_PROMPT, DRY_CACHE, DRY_STEPS = 4, 2048, 4096, 8
DRY_MEM_TOL, DRY_MEM_SLACK = 0.01, 2 << 20
DRY_REDUCED = "granite-20b"



def _tp_world_jobs(torch, cfgs, reqs, tiled, red_reqs, moe_reqs):
    """The TP world's jobs: (a) glm4-9b at full width, bf16 (the serve mix,
    probed for its first prompt's logits and traced; then the tiled prompts
    with ``spec_k``); (a') glm4-9b at full width cut to TP_F32_LAYERS
    layers, float32 (the first SLOTS requests of the mix, probed); (b)
    reduced glm4-9b in float32; (c) qwen3-moe-30b-a3b cut to TP_MOE_LAYERS
    layers, bf16."""
    from repro_torch.serve.tp import ServeJob, TPRun

    dry = _dry_checks()
    eng = dict(max_batch=SLOTS, max_seq=MAX_SEQ, page_size=PAGE)
    kw = dict(num_slots=SLOTS, page_size=PAGE, prefill_budget=BUDGET)
    red_eng = dict(max_batch=3, max_seq=64, page_size=4)
    red_kw = dict(num_slots=3, page_size=4, prefill_budget=8)
    return [
        ServeJob(cfgs["full"], SEED, [
            TPRun(reqs, engine=eng, serve=kw, probe=reqs[0].prompt, trace=True),
            TPRun(tiled, engine=eng, serve=dict(kw, spec_k=SPEC_K, spec_ngram=DRAFT_NGRAM,
                                                prefix_cache=True, num_slots=TP_SPEC_SLOTS))],
                 torch.bfloat16),
        ServeJob(cfgs["f32"], SEED,
                 [TPRun(reqs[:SLOTS], engine=eng, serve=kw, probe=reqs[0].prompt)],
                 torch.float32),
        ServeJob(cfgs["reduced"], SEED, [TPRun(red_reqs, engine=red_eng, serve=red_kw)],
                 torch.float32),
        ServeJob(cfgs["moe"], SEED, [TPRun(moe_reqs, engine=eng, serve=kw)], torch.bfloat16),
        dry["full"], dry["kv_seq"], dry["fsdp"],
    ]


def _dry_checks():
    """Phase 7's dry-run checks (``repro_torch.launch.dryrun.CellCheck``, each
    a job of the world's ranks): glm4-9b at full width,
    bf16, at tp TP; reduced DRY_REDUCED in float32 at tp TP (its one kv head:
    the cache's sequence split) and with FSDP over a data axis of TP."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import CellCheck

    rng = np.random.default_rng(SEED)
    full = get_config("glm4-9b")
    red = get_config(DRY_REDUCED, reduced=True)
    prompts = rng.integers(0, full.vocab_size, (DRY_BATCH, DRY_PROMPT)).astype(np.int32)
    small = rng.integers(0, red.vocab_size, (4, 12)).astype(np.int32)
    return {"full": CellCheck(full, prompts, DRY_CACHE, DRY_STEPS, weights=SEED, tp=TP,
                              dtype="bfloat16"),
            "kv_seq": CellCheck(red, small, 24, 4, weights=SEED, tp=TP),
            "fsdp": CellCheck(red, small, 24, 4, weights=SEED, tp=1, fsdp=True)}


def _dry_counts(check, sizes, rank):
    """The dry run's counts of ``check``'s calls on a mesh of ``sizes``
    seen from ``rank``, as plain values (run in a CPU process beside the
    card's work)."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.launch import dryrun

    return [dryrun.costs_dict(c) for c in dryrun.check_counts(check, sizes, rank)]


def _dry_compare(label, costs, added, counted):
    """One run's calls against the dry run's counts: FLOPs, bytes and the
    ledger must be equal (or the phase fails); the added peak is printed
    beside the dry run's bound and live peak with each limit's verdict."""
    calls = ["prefill"] + [f"step {i + 1}" for i in range(len(costs) - 1)]
    misses = []
    for name, real, want in zip(calls, costs, counted):
        for key in ("flops", "bytes", "ledger", "by_kernel"):
            if real[key] != want[key]:
                raise SystemExit(f"dry run {label} {name}: counted {key} on the card "
                                 f"{real[key] if key != 'ledger' else len(real[key])} != the dry "
                                 f"run's {want[key] if key != 'ledger' else len(want[key])}")
        if added:
            m = want["memory"]
            bound = m["output_bytes"] + m["temp_bytes"] - m["alias_bytes"]
            live = want["live_peak_bytes"]
            got = added[calls.index(name)]
            under = got <= bound + DRY_MEM_SLACK
            near = abs(got - live) <= DRY_MEM_TOL * live + DRY_MEM_SLACK
            if not (under and near):
                misses.append(name)
            if name in ("prefill", "step 1", calls[-1]):
                print(f"      {label} {name}: {real['flops']:.4e} FLOPs, {real['bytes']:.4e} "
                      f"bytes, {len(real['ledger'])} collectives ("
                      f"{sum(e['moved_bytes'] for e in real['ledger']):.4e} bytes moved) = the "
                      f"dry run's; peak_per_device {m['peak_per_device_bytes'] / 1e9:.4f} GB "
                      f"(arguments {m['argument_bytes'] / 1e9:.4f}); added at the peak: card "
                      f"{got / 1e6:.4f} MB, dry run's bound {bound / 1e6:.4f} MB "
                      f"({'hit' if under else 'MISS'}), live peak {live / 1e6:.4f} MB "
                      f"({'hit' if near else 'MISS'})")
    print(f"      {label}: {len(calls)} calls, FLOPs, bytes and ledger equal the dry run's"
          + (f"; added peak under the bound + {DRY_MEM_SLACK >> 20} MiB and within "
             f"{DRY_MEM_TOL:.0%} + {DRY_MEM_SLACK >> 20} MiB of the live peak: "
             f"{len(calls) - len(misses)}/{len(calls)}" + (f", misses {misses}" if misses else "")
             if added else ""))
    return misses


def _tp_spec_requests(vocab):
    """The first TP_SPEC_SLOTS tiled prompts cut to whole pages, then the
    same prompts again, on TP_SPEC_SLOTS slots: the second wave, admitted as
    the first finishes, finds each prompt cached whole (and prefills
    nothing)."""
    from repro_torch.serve.engine import ServeRequest

    first = _tiled_requests(TP_SPEC_SLOTS, PROMPT_MIN, PROMPT_MAX, NEW_TOKENS, vocab, SEED)
    prompts = [r.prompt[:len(r.prompt) // PAGE * PAGE] for r in first] * 2
    return [ServeRequest(request_id=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]


def _tp_counts(label, res, cfg, reqs):
    """Every rank's launches exactly what the run's passes imply, every
    request complete (all its tokens, inside the vocabulary), the ledger
    balanced."""
    stats = res.stats
    _check_ledger(label, stats)
    done = sum(1 for q, r in zip(reqs, stats.results)
               if r.status == "completed" and len(r.tokens) == q.max_new_tokens
               and all(0 <= t < cfg.vocab_size for t in r.tokens))
    if done != len(reqs):
        raise SystemExit(f"{label}: only {done} of {len(reqs)} requests completed")
    expect = _expected_launches(stats, cfg)
    for rank, counts in enumerate(res.launches):
        for name, got in counts.items():
            if got != expect.get(name, 0):
                raise SystemExit(f"{label}: rank {rank} launched {name} {got} times, expected "
                                 f"{expect.get(name, 0)}")
    print(f"      launches a rank (each rank's equal to the run's passes): {res.launches[0]}")


def tp_serve_phase(torch, dev, bf16_err):
    """Tensor-parallel paged serving, two ranks (``repro_torch.launch.mesh``:
    spawned processes, one gloo world) sharing the one card, against tp 1 in
    this process, which holds no model while the ranks run:

    (a) glm4-9b at full width and depth, bf16, random weights from SEED
    (each rank draws every leaf whole and keeps its cut: 16 query heads on
    1 kv head, half the MLP columns and half the vocabulary a rank) on the
    first SLOTS requests of the serve mix: the first prompt's logits within 2E of tp 1's, E the largest
    bf16 error phase 4 measured against float32 (two bf16 paths each within
    E); greedy tokens as ``_agreement`` counts them, each request's first
    divergence at a step where tp 1's top-two margin is at most 2E (tp 1's
    margins printed beside 2E: at this width in bf16 they lie far below it,
    so these two checks bind little, and (a') is the full-width check that
    binds); every rank's launches exact; each rank's peak memory and pool
    pages; the analytic ``tp:collective`` ledger.  Then ``spec_k`` SPEC_K with the
    prefix cache on ``_tp_spec_requests``, whose second wave hits the
    cache whole: each replays its last prompt token through the decode
    step, where the drafter finds it earlier in the tiled prompt, so verify
    steps (spec_verify at the local heads) are sure to run.
    (a') glm4-9b at its published widths cut to TP_F32_LAYERS layers, in
    float32 (every split, vocabulary and MLP columns included, at full
    size): the first prompt's logits within TP_F32_TOL of tp 1's largest,
    and on the same requests every first divergence at a tp-1
    margin of at most twice that limit.
    (b) reduced glm4-9b in float32: tokens equal tp 1's.  (c) qwen3-moe-
    30b-a3b cut to TP_MOE_LAYERS layers, bf16 (64 experts a rank, the
    router whole on each), once, on the first SLOTS requests of the mix:
    launches exact, tokens beside tp 1's.
    Then the dry-run check (DRY_*, :func:`_dry_checks`): glm4-9b's
    prefill and decode steps counted at tp 1 here and on the two ranks,
    each call against ``repro_torch.launch.dryrun``'s count of it (computed
    in two CPU processes while the card works); reduced DRY_REDUCED with its
    cache's sequence split and with FSDP, tokens equal tp 1's.
    Returns rank 0's launches by kernel, for the kernels line's ``[tp2]``
    records."""
    import atexit
    import dataclasses
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeRequest, ServingEngine
    from repro_torch.serve.tp import serve_tp

    cfg = get_config("glm4-9b")
    cfgs = {"full": cfg, "f32": cfg.replace(num_layers=TP_F32_LAYERS),
            "reduced": get_config("glm4-9b", reduced=True),
            "moe": get_config(MOE_ARCH).replace(num_layers=TP_MOE_LAYERS)}
    # the first SLOTS requests of the mix (gloo moves every all-reduce
    # through the host)
    reqs = make_requests(REQUESTS, PROMPT_MIN, PROMPT_MAX, NEW_TOKENS, cfg.vocab_size,
                         SEED)[:SLOTS]
    tiled = _tp_spec_requests(cfg.vocab_size)
    red = cfgs["reduced"]
    rng = np.random.default_rng(SEED)
    red_reqs = [ServeRequest(request_id=i, prompt=rng.integers(0, red.vocab_size, (int(n),))
                             .astype(np.int32), max_new_tokens=6)
                for i, n in enumerate(rng.integers(5, 40, size=6))]
    moe_reqs = make_requests(REQUESTS, PROMPT_MIN, PROMPT_MAX, NEW_TOKENS,
                             cfgs["moe"].vocab_size, SEED)[:SLOTS]
    eng = dict(max_batch=SLOTS, max_seq=MAX_SEQ, page_size=PAGE)
    kw = dict(num_slots=SLOTS, page_size=PAGE, prefill_budget=BUDGET)
    dry = _dry_checks()
    one = {"data": 1, "model": 1}
    world_mesh = {"full": {"data": 1, "model": TP}, "kv_seq": {"data": 1, "model": TP},
                  "fsdp": {"data": TP, "model": 1}}
    # the dry run's counts, on the CPU beside the card's work
    pool = ProcessPoolExecutor(max_workers=2, mp_context=mp.get_context("spawn"))
    atexit.register(pool.shutdown, wait=True, cancel_futures=True)
    counting = {("full", "tp1", 0): pool.submit(_dry_counts, dry["full"], one, 0)}
    for name, sizes in world_mesh.items():
        for rank in range(TP):
            counting[(name, "world", rank)] = pool.submit(_dry_counts, dry[name], sizes, rank)
    tp1_check = lambda name: (lambda e: dryrun.run_check(
        dataclasses.replace(dry[name], tp=1, fsdp=False), e.model, e.params, one, 0, dev))

    # tp 1 in this process, one model at a time
    def tp1(cfg_, dtype, runs):
        model = build_model(cfg_, device=dev, dtype=dtype)
        params = model.init(seed=SEED)
        out = [fn(ServingEngine(model, params, device=dev, **e)) for e, fn in runs]
        del model, params
        _release(torch)
        return out

    logits1, base, base_spec, dry1 = tp1(cfg, torch.bfloat16, [
        (eng, lambda e: e.prompt_logits(reqs[0].prompt).float().cpu()),
        (eng, lambda e: e.serve_paged(reqs, **kw)),
        (eng, lambda e: e.serve_paged(tiled, spec_k=SPEC_K, spec_ngram=DRAFT_NGRAM,
                                      prefix_cache=True, **dict(kw, num_slots=TP_SPEC_SLOTS))),
        (eng, tp1_check("full"))])
    (dry_red1,) = tp1(get_config(DRY_REDUCED, reduced=True), torch.float32,
                      [(dict(max_batch=4, max_seq=24, page_size=4), tp1_check("kv_seq"))])
    f32_logits1, f32_base = tp1(cfgs["f32"], torch.float32, [
        (eng, lambda e: e.prompt_logits(reqs[0].prompt).float().cpu()),
        (eng, lambda e: e.serve_paged(reqs[:SLOTS], **kw))])
    (red_base,) = tp1(red, torch.float32, [(dict(max_batch=3, max_seq=64, page_size=4),
                                            lambda e: e.serve_paged(
                                                red_reqs, num_slots=3, page_size=4,
                                                prefill_budget=8))])
    (moe_base,) = tp1(cfgs["moe"], torch.bfloat16, [(eng, lambda e: e.serve_paged(moe_reqs,
                                                                                   **kw))])
    t0 = time.perf_counter()
    full, f32, reduced, moe, dry_full, dry_kv, dry_fsdp = serve_tp(
        _tp_world_jobs(torch, cfgs, reqs, tiled, red_reqs, moe_reqs), TP, device=dev,
        timeout_s=600.0)
    print(f"   the world of {TP} ranks on one card (spawn, weights, every run): "
          f"{time.perf_counter() - t0:.1f} s")

    # (a) glm4-9b at full width
    res, spec = full
    print(f"   (a) {cfg.name} at full width, bf16, tp {res.engine_tp}: mesh {res.mesh}; "
          f"pool pages a rank {res.pool_pages}, kv heads a rank {cfg.num_kv_heads // TP}; "
          f"peak device memory a rank "
          f"{[round(b / 1e9, 2) for b in res.peak_bytes]} GB")
    diff = float((res.logits.float() - logits1).abs().max())
    print(f"      first prompt's logits, tp {TP} vs tp 1: max |diff| {diff:.4f}, 2E "
          f"{2 * bf16_err:.4f} (E: phase 4's largest bf16 error against float32)")
    if not diff <= 2 * bf16_err:
        raise SystemExit(f"tp {TP}: the first prefill's logits are further than 2E from tp 1's")
    _tp_counts(f"tp {TP} serve_paged", res, cfg, reqs)
    print(f"      tp:collective ledger: {res.tp_summary}")
    print(f"      vs tp 1: {_fmt_agreement([r.tokens for r in base.results], [r.tokens for r in res.stats.results])}")
    _tp_margins(torch, dev, cfg, torch.bfloat16, reqs, base, res.stats, 2 * bf16_err, "2E")
    print(f"      spec_k {SPEC_K}, prefix cache on, {len(tiled) // 2} tiled prompts, each twice: "
          f"full hits {spec.stats.prefix_stats.get('full_hits')}, spec_stats {spec.stats.spec_stats}; "
          f"vs tp 1: {_fmt_agreement([r.tokens for r in base_spec.results], [r.tokens for r in spec.stats.results])}")
    _tp_counts(f"tp {TP} speculative serve_paged", spec, cfg, tiled)
    if not spec.stats.spec_stats.get("spec_launches"):
        raise SystemExit(f"tp {TP}: the speculative run ran no verify step")

    # (a') full width in float32, depth cut: logits and tokens
    (r,) = f32
    fc = cfgs["f32"]
    diff = float((r.logits - f32_logits1).abs().max())
    limit = TP_F32_TOL * float(f32_logits1.abs().max())
    print(f"   (a') {cfg.name} cut to {TP_F32_LAYERS} of {cfg.num_layers} layers, float32, tp "
          f"{r.engine_tp}: first prompt's logits, tp {TP} vs tp 1: max |diff| {diff:.3e}, limit "
          f"{limit:.3e} ({TP_F32_TOL} of tp 1's largest)")
    if r.engine_tp != TP or not diff <= limit:
        raise SystemExit(f"tp {TP}: float32 logits at full width further than {limit:.3e} from "
                         f"tp 1's")
    _tp_counts(f"tp {TP} float32 serve_paged", r, fc, reqs[:SLOTS])
    print(f"      vs tp 1: {_fmt_agreement([x.tokens for x in f32_base.results], [x.tokens for x in r.stats.results])}")
    _tp_margins(torch, dev, fc, torch.float32, reqs[:SLOTS], f32_base, r.stats, 2 * limit,
                "twice the limit")

    # (b) reduced, float32: the same tokens
    r = reduced[0]
    same = all(np.array_equal(a.tokens, b.tokens)
               for a, b in zip(red_base.results, r.stats.results))
    print(f"   (b) {red.name}, float32, tp {r.engine_tp}: tokens equal tp 1's: {same}")
    _tp_counts(f"tp {TP} reduced", r, red, red_reqs)
    if not same or r.engine_tp != TP:
        raise SystemExit(f"tp {TP}: reduced float32 tokens differ from tp 1's")

    # (c) qwen3-moe, depth cut
    m = moe[0]
    mc = cfgs["moe"]
    print(f"   (c) {MOE_ARCH} cut to {TP_MOE_LAYERS} of 48 layers, bf16, tp {m.engine_tp} "
          f"({mc.num_experts // TP} experts a rank): peak device memory a rank "
          f"{[round(b / 1e9, 2) for b in m.peak_bytes]} GB; vs tp 1: "
          f"{_fmt_agreement([x.tokens for x in moe_base.results], [x.tokens for x in m.stats.results])}")
    _tp_counts(f"tp {TP} {MOE_ARCH}", m, mc, moe_reqs)
    if m.engine_tp != TP:
        raise SystemExit(f"tp {TP}: {MOE_ARCH} did not split")

    # the dry-run check
    t0 = time.perf_counter()
    counts = {k: f.result(timeout=600) for k, f in counting.items()}
    pool.shutdown()
    print(f"   (d) the dry run's counts against the card ({DRY_BATCH} x {DRY_PROMPT} prompts "
          f"into a ({DRY_BATCH}, {DRY_CACHE}) cache, then {DRY_STEPS} decode steps; "
          f"{cfg.name} full width, bf16; the counts waited {time.perf_counter() - t0:.1f} s "
          f"more): the added peak at most the dry run's bound + {DRY_MEM_SLACK >> 20} MiB, "
          f"and within {DRY_MEM_TOL:.0%} + {DRY_MEM_SLACK >> 20} MiB of its live peak")
    tok1, _, costs1, added1 = dry1
    misses = _dry_compare("tp 1", costs1, added1, counts[("full", "tp1", 0)])
    for rank in range(TP):
        misses += _dry_compare(f"tp {TP} rank {rank}", dry_full.costs[rank],
                               dry_full.peak_added[rank], counts[("full", "world", rank)])
    print(f"      greedy tokens, tp {TP} vs tp 1 (bf16, printed): "
          f"{_fmt_agreement(list(tok1), list(dry_full.tokens))}; added-peak misses {len(misses)}")
    red_tok1 = dry_red1[0]
    for name, got in (("kv_seq", dry_kv), ("fsdp", dry_fsdp)):
        for rank in range(TP):
            _dry_compare(f"{DRY_REDUCED} reduced {name} rank {rank}", got.costs[rank], [],
                         counts[(name, "world", rank)])
        same = np.array_equal(got.tokens, red_tok1)
        print(f"      {DRY_REDUCED} reduced, float32, {name} on {world_mesh[name]}: tokens "
              f"equal tp 1's: {same}")
        if not same:
            raise SystemExit(f"dry run {name}: float32 tokens differ from tp 1's")
    return {f"{k}[tp{TP}]": n for k, n in {**res.launches[0],
                                           "spec_verify": spec.launches[0]["spec_verify"]}.items()}


def _tp_margins(torch, dev, cfg, dtype, reqs, base, got, limit, name):
    """tp 1's top-two margins (its last-token logits over the prompt and
    the tokens before, the model drawn again from SEED in ``dtype``): at
    each request's first token, their spread beside ``limit``; and at each
    request's first token where tp 2 leaves tp 1, where a margin above
    ``limit`` (a divergence that is no near-tie) fails the check."""
    import numpy as np

    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServingEngine

    firsts = []
    for r, a, b in zip(reqs, base.results, got.results):
        a, b = np.asarray(a.tokens), np.asarray(b.tokens)
        if not np.array_equal(a, b):
            firsts.append((r, int(np.argmin(a == b)), a))
    model = build_model(cfg, device=dev, dtype=dtype)
    params = model.init(seed=SEED)
    engine = ServingEngine(model, params, max_batch=SLOTS, max_seq=MAX_SEQ, page_size=PAGE,
                           device=dev)

    def margin(ctx):
        top = engine.prompt_logits(ctx.astype(np.int32)).float().topk(2).values
        return float(top[0] - top[1])

    at_first = sorted(margin(r.prompt) for r in reqs)
    margins = [(r.request_id, t, round(margin(np.concatenate([r.prompt, a[:t]])), 4))
               for r, t, a in firsts]
    del model, params, engine
    _release(torch)
    q = [at_first[int(f * (len(at_first) - 1))] for f in (0, 0.25, 0.5, 0.75, 1)]
    print(f"      tp 1's top-two margins at the {len(reqs)} requests' first tokens: min "
          f"{q[0]:.4f}, quartiles {q[1]:.4f} {q[2]:.4f} {q[3]:.4f}, max {q[4]:.4f}; "
          f"{sum(m > limit for m in at_first)} of {len(at_first)} above {name} = {limit:.4g}")
    if not firsts:
        print("      every request's tokens equal tp 1's")
        return
    print(f"      first divergences (request, token, tp 1's top-two margin there): {margins}; "
          f"{name} = {limit:.4g}")
    if any(m > limit for _, _, m in margins):
        raise SystemExit(f"tp {TP}: tokens leave tp 1's where its top two are further apart "
                         f"than {name}: not rounding")


# the paper's ResNet-50: plain torch (cuDNN's convolutions), no hand-written
# kernel
RESNET = "resnet50"
# f32 logits, card vs CPU: |card - cpu| <= RESNET_F32_TOL * max |cpu| (the
# CPU tests hold the port to JAX's logits within the same share)
RESNET_F32_TOL = 1e-4
# bf16 vs f32 on the card: ~53 layers each rounding its activations to bf16
# (2**-9), random weights: a few 2**-9 after accumulation, within 5e-2 of the
# largest logit
RESNET_BF16_TOL = 5e-2
RESNET_CHECK_BATCH = 2
RESNET_BATCHES = [1, 8, 32]


def _resnet_weights(torch, cfg, seed):
    """Seeded float32 ResNet weights on the CPU with every folded norm's
    scale and bias drawn at random (ones and zeros would hide a norm
    applied over the wrong axis)."""
    from repro_torch.models import ResNet

    params = ResNet(cfg, device="cpu", dtype=torch.float32).init(seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)

    def perturb(node):
        if "scale" in node and "bias" in node:
            c = node["scale"].shape
            node["scale"] = 1.0 + 0.2 * torch.randn(c, generator=gen)
            node["bias"] = 0.1 * torch.randn(c, generator=gen)
        for v in node.values():
            if isinstance(v, dict):
                perturb(v)

    perturb(params)
    return params


def resnet_check_phase(torch, dev):
    """ResNet-50, reduced and full, from the same float32 weights and
    images (batch RESNET_CHECK_BATCH): (1) reduced f32 on the card against
    the CPU and (2) full f32 likewise, within RESNET_F32_TOL of the largest
    CPU logit (cuDNN's TF32 is off); (3) bf16 on the card against f32 on
    the card within RESNET_BF16_TOL; (4) the same model with PyTorch's
    symmetric ``padding=`` on the card must fail the f32 limit: JAX's
    "SAME" pads the odd row at the end, and the check sees the
    difference."""
    import torch.nn.functional as F

    from repro_torch.models import ResNet, ResNetConfig

    class SymmetricPad(ResNet):
        @staticmethod
        def _conv(x, w, stride=1):
            return F.conv2d(x, w, stride=stride, padding=w.shape[-1] // 2)

        @staticmethod
        def _max_pool(x):
            return F.max_pool2d(x, 3, 2, padding=1)

    def rel(got, want):
        got, want = got.float().cpu(), want.float().cpu()
        return float((got - want).abs().max() / want.abs().max()), \
            bool(torch.isfinite(got).all())

    for cfg in (ResNetConfig().reduced(), ResNetConfig()):
        params = _resnet_weights(torch, cfg, SEED)
        gen = torch.Generator().manual_seed(SEED + 2)
        images = torch.randn((RESNET_CHECK_BATCH, cfg.img_size, cfg.img_size, 3), generator=gen)
        card = _to_device(params, dev)
        with torch.inference_mode():
            cpu = ResNet(cfg, device="cpu", dtype=torch.float32).forward(params, images)
            f32 = ResNet(cfg, device=dev, dtype=torch.float32).forward(card, images)
            bf16 = ResNet(cfg, device=dev, dtype=torch.bfloat16).forward(
                _tree_map(card, lambda t: t.to(torch.bfloat16)), images)
            sym = SymmetricPad(cfg, device=dev, dtype=torch.float32).forward(card, images)
        (e_f32, fin_f32), (e_bf16, fin_bf16), (e_sym, _) = \
            rel(f32, cpu), rel(bf16, f32), rel(sym, cpu)
        print(f"   {cfg.name} ({'/'.join(map(str, cfg.stage_sizes))} blocks, width "
              f"{cfg.width}, {cfg.img_size} px), logits {tuple(cpu.shape)}, max |cpu| "
              f"{float(cpu.abs().max()):.4g}: f32 max |cuda - cpu| / max |cpu| {e_f32:.3e} "
              f"(<= {RESNET_F32_TOL}, finite: {fin_f32}); bf16 vs f32 on the card {e_bf16:.3e} "
              f"(<= {RESNET_BF16_TOL}, finite: {fin_bf16}); symmetric padding= {e_sym:.3e}, "
              f"rejected by the f32 limit: {e_sym > RESNET_F32_TOL}")
        if not (fin_f32 and e_f32 <= RESNET_F32_TOL):
            raise SystemExit(f"{cfg.name}: f32 logits on the card differ from the CPU's")
        if not (fin_bf16 and e_bf16 <= RESNET_BF16_TOL):
            raise SystemExit(f"{cfg.name}: bf16 logits differ from f32 past the limit")
        if e_sym <= RESNET_F32_TOL:
            raise SystemExit(f"{cfg.name}: the f32 limit does not tell symmetric padding "
                             f"from JAX's SAME")


# platform phase: the evaluation platform (client -> server -> agent ->
# scenario -> scheduler -> torch predictor) at published width
PLATFORM_SEQ = 128
# launches of each kernel per forward pass at published depth
PER_PASS = {"glm4-9b": {"flash_attention": 40, "rmsnorm": 81},
            "mamba2-130m": {"ssd": 24, "rmsnorm": 49},
            "gemma2-27b": {"flash_attention": 46, "rmsnorm": 185},
            "granite-20b": {"flash_attention": 52, "rmsnorm": 105},
            "chameleon-34b": {"flash_attention": 48, "rmsnorm": 193},
            "qwen3-moe-30b-a3b": {"flash_attention": 48, "rmsnorm": 193},
            "zamba2-2.7b": {"flash_attention": 9, "ssd": 54, "rmsnorm": 127},
            # 32 encoder + 32 decoder self + 32 cross; encoder 65 + decoder 97
            "whisper-large-v3": {"flash_attention": 96, "rmsnorm": 162},
            # cuDNN's convolutions: any hand-written kernel launched fails
            RESNET: {}}
PLATFORM_TOL = 1e-4             # reduced f32 logits, card vs CPU: 1e-4 + 1e-4 |cpu|
# every batch the evaluations can form: batched's 1/2/4/8, the server's up
# to 4 and offline's up to 8 coalesced requests
PLATFORM_BATCHES = range(1, 9)


def platform_kernels_phase(torch, dev):
    """flash_attention, rmsnorm and ssd against their plain versions at the
    shapes the platform phase gives them, bf16, every batch of
    PLATFORM_BATCHES at PLATFORM_SEQ tokens: each attention arch the
    platform phase evaluates (glm4-9b, gemma2-27b, qwen3-moe-30b-a3b, and
    zamba2-2.7b's shared block at head dim 80) with its heads, its
    attention softcap and each window its layers pass, and its norms at
    d_model and (QK-norm) over its query and kv heads' rows;
    whisper-large-v3's encoder over its 1500 frames, its decoder's causal
    self-attention and its cross-attention over the frames; the scan of
    mamba2-130m and of zamba2-2.7b (two whole chunks, final state out) with
    x, B and C views of one convolved projection as the block makes them,
    and their norms at d_model and over the gated d_inner.  One line a
    kernel; returns each kernel's worst error."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd as sd
    from repro_torch.models import DecoderLM

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    uniform = lambda shape, lo, hi: torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo
    archs = [get_config(a) for a in dict.fromkeys(arch for _, arch, *_ in _evaluations())
             if a != RESNET]
    dense = [c for c in archs if c.family in ("dense", "moe", "hybrid")]
    scans = [c for c in archs if c.family in ("ssm", "hybrid")]
    encdec = [c for c in archs if c.family == "encdec"]
    s = PLATFORM_SEQ
    norm_w = {D: randn(D) * 0.1 for D in [c.d_model for c in archs] + [c.ssm_inner for c in scans]}
    qk_w = {c.resolved_head_dim: randn(c.resolved_head_dim) * 0.1 for c in dense if c.qk_norm}
    A = {c.name: -uniform((c.ssm_heads,), 1.0, 16.0) for c in scans}
    # (arch, heads, attention options) of every distinct layer: the model's
    # own per-layer windows and its softcap, as the model passes them
    layers = [(c.name, (c.num_heads, c.num_kv_heads, c.resolved_head_dim),
               dict(window=w, softcap=c.attn_softcap))
              for c in dense for w in dict.fromkeys(DecoderLM(c, device=dev).windows)]

    def cases():
        for b in PLATFORM_BATCHES:
            for arch, (h, kvh, d), opts in layers:
                q, k, v = randn(b, s, h, d), randn(b, s, kvh, d), randn(b, s, kvh, d)
                yield ("flash_attention", f"{arch} causal q ({b}, {s}, {h}, {d}), kvh {kvh}, "
                       f"{opts}", fa.flash_attention(q, k, v, **opts),
                       ref.attention(q, k, v, **opts))
            for c in encdec:        # the encoder over its frames, the decoder, its cross
                h, kvh, d, Se = c.num_heads, c.num_kv_heads, c.resolved_head_dim, c.encoder_seq
                for sq, sk, causal in ((Se, Se, False), (s, s, True), (s, Se, False)):
                    q, k, v = randn(b, sq, h, d), randn(b, sk, kvh, d), randn(b, sk, kvh, d)
                    yield ("flash_attention", f"{c.name} q ({b}, {sq}, {h}, {d}) over {sk} "
                           f"keys, causal {causal}", fa.flash_attention(q, k, v, causal=causal),
                           ref.attention(q, k, v, causal=causal))
            for D, w in norm_w.items():
                x = randn(b, s, D)
                yield "rmsnorm", f"({b}, {s}, {D})", rn.rmsnorm(x, w), ref.rmsnorm(x, w)
            for c in (c for c in dense if c.qk_norm):          # QK-norm's rows of head_dim
                dh = c.resolved_head_dim
                for heads in (c.num_heads, c.num_kv_heads):
                    x = randn(b, s, heads, dh)
                    yield ("rmsnorm", f"{c.name} QK-norm ({b}, {s}, {heads}, {dh})",
                           rn.rmsnorm(x, qk_w[dh]), ref.rmsnorm(x, qk_w[dh]))
            for c in scans:
                sh, p, n, din = c.ssm_heads, c.ssm_head_dim, c.ssm_state, c.ssm_inner
                xBC = randn(b, s, din + 2 * n)
                x, B, C = (xBC[..., :din].reshape(b, s, sh, p), xBC[..., din:din + n],
                           xBC[..., din + n:])
                dt = uniform((b, s, sh), 1e-3, 1e-1)
                y, sf = sd.ssd(x, dt, A[c.name], B, C, chunk=c.ssm_chunk, return_state=True)
                y_want, sf_want = ref.ssd(x, dt, A[c.name], B, C, return_state=True)
                shape = f"{c.name} ({b}, {s}, {sh}, {p}), n {n}, chunk {c.ssm_chunk}"
                yield "ssd", f"{shape}: y", y, y_want
                yield "ssd", f"{shape}: final state", sf, sf_want

    worst, count = {}, {}
    for name, label, out, want in cases():
        max_abs, ok = _within(torch, out, want)
        if not ok:
            raise SystemExit(f"{name} {label}: kernel disagrees with its plain version "
                             f"(max_abs_err {max_abs:.3e})")
        worst[name] = max(worst.get(name, 0.0), max_abs)
        count[name] = count.get(name, 0) + 1
    print(f"   the platform's attention layers: "
          f"{', '.join(f'{arch} {h}/{kvh} heads {opts}' for arch, (h, kvh, _), opts in layers)}")
    for name, err in worst.items():
        print(f"   {name} at the platform's shapes (batches {PLATFORM_BATCHES[0]}-"
              f"{PLATFORM_BATCHES[-1]} of {s} tokens, {count[name]} cases): max_abs_err "
              f"{err:.3e} (|kernel - plain| <= {TOL}*|plain| + {TOL_FLOOR}*rms(plain), "
              f"finite: True)")
    return worst


def _evaluations():
    """(label, arch, trace level, scenario kwargs, scheduler kwargs) of
    each full-width evaluation."""
    online = dict(kind="online", num_requests=4, warmup=1)
    offline = (dict(kind="offline", num_requests=16, warmup=1),
               dict(max_batch=8, batch_timeout_ms=0.0))
    resnet_batched = dict(kind="batched", num_requests=4, batch_sizes=RESNET_BATCHES, warmup=1)
    return [
        ("online", "glm4-9b", "MODEL", online, None),
        ("batched", "glm4-9b", "MODEL",
         dict(kind="batched", num_requests=2, batch_sizes=[1, 2, 4, 8], warmup=1), None),
        ("server", "glm4-9b", "MODEL",
         dict(kind="server", num_requests=16, rate_hz=20.0, slo_ms=250.0, warmup=1),
         dict(max_batch=4)),
        ("offline", "glm4-9b", "MODEL") + offline,
        ("online FRAMEWORK", "glm4-9b", "FRAMEWORK", dict(online, num_requests=2), None),
        ("online SYSTEM", "glm4-9b", "SYSTEM", dict(online, num_requests=2), None),
        ("online", "mamba2-130m", "MODEL", online, None),
        ("offline", "mamba2-130m", "MODEL") + offline,
        ("online", "gemma2-27b", "MODEL", online, None),
        ("online FRAMEWORK", "gemma2-27b", "FRAMEWORK", dict(online, num_requests=2), None),
        ("online", "qwen3-moe-30b-a3b", "MODEL", online, None),
        ("online FRAMEWORK", "qwen3-moe-30b-a3b", "FRAMEWORK", dict(online, num_requests=2),
         None),
        ("online", "zamba2-2.7b", "MODEL", online, None),
        ("online FRAMEWORK", "zamba2-2.7b", "FRAMEWORK", dict(online, num_requests=2), None),
        ("online", "whisper-large-v3", "MODEL", online, None),
        ("online FRAMEWORK", "whisper-large-v3", "FRAMEWORK", dict(online, num_requests=2),
         None),
        ("online", RESNET, "MODEL", online, None),
        ("batched", RESNET, "MODEL", resnet_batched, None),
        ("online SYSTEM", RESNET, "SYSTEM", dict(online, num_requests=2), None),
        # the device ms of each batch's predicts (the profiler would slow the
        # batched run whose images/s are read)
        ("batched SYSTEM", RESNET, "SYSTEM", resnet_batched, None),
    ]


def platform_check(torch, dev):
    """Every reduced model of the built-in manifests (whisper-large-v3 over
    zero frames, as the predictor feeds it; ResNet-50 on 32-pixel images)
    through the torch predictor on the CPU and on the card, the card's
    handle holding the float32 model with the CPU's weights: logits within
    PLATFORM_TOL, the same (last-position) argmax, and the FRAMEWORK
    path's logits bit-equal to the MODEL path's on the card."""
    import numpy as np

    from repro_torch.core import NullTracer, OpenRequest, Tracer, TraceLevel, TracingServer
    from repro_torch.core import make_predictor
    from repro_torch.core.platform import builtin_manifests
    from repro_torch.models import ResNet
    from repro_torch.models.lm import build_model

    pred = make_predictor("torch")
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, 256, (4, 96)).astype(np.int32)
    for manifest in builtin_manifests(reduced=True):
        card, cpu = (pred.open(OpenRequest(manifest=manifest, device=d), NullTracer())
                     for d in ("cuda", "cpu"))
        cfg = card.state["cfg"]
        if card.state["kind"] == "resnet":
            card.state["model"] = ResNet(cfg, device=dev, dtype=torch.float32)
            batch = rng.normal(size=(4, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
            last = lambda x: x
        else:
            card.state["model"] = build_model(cfg, device=dev, dtype=torch.float32)
            batch, last = tokens, lambda x: x[:, -1]
        card.state["params"] = _to_device(cpu.state["params"], dev)
        got = pred.predict(card, batch, NullTracer())
        want = pred.predict(cpu, batch, NullTracer())
        err = float(np.abs(got - want).max())
        ok = bool(np.isfinite(got).all()) and bool(
            (np.abs(got - want) <= PLATFORM_TOL + PLATFORM_TOL * np.abs(want)).all())
        same_argmax = bool((last(got).argmax(-1) == last(want).argmax(-1)).all())
        framework = pred.predict(card, batch, Tracer("t", TracingServer(), TraceLevel.FRAMEWORK))
        bits = bool(np.array_equal(framework, got))
        print(f"   reduced {manifest.name} f32, logits {tuple(got.shape)}: max |card - cpu| "
              f"{err:.3e} (<= {PLATFORM_TOL} + {PLATFORM_TOL}|cpu|: {ok}), (last-position) "
              f"argmax equal: {same_argmax}, FRAMEWORK == MODEL bits: {bits}")
        if not (ok and same_argmax and bits):
            raise SystemExit(f"platform check: reduced {manifest.name} disagrees")
        pred.close(card)
        pred.close(cpu)


def roofline_check(torch, dev):
    """The roofline counter on the reduced glm4-9b forward in float32, the
    same tokens on the CPU and on the card: the same FLOPs, bytes and kernel
    work (each kernel-backed op counts its work, not what runs inside it,
    and nothing else depends on the device)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.roofline import count_costs

    cfg = get_config("glm4-9b", reduced=True)
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (4, 96)).astype(np.int32))
    got = []
    for d in ("cpu", dev):
        model = build_model(cfg, device=d, dtype=torch.float32)
        params = model.init(SEED)
        batch = {"tokens": tokens.to(d)}
        with count_costs() as costs, torch.inference_mode():
            model.forward(params, batch)
        got.append(costs)
    cpu, card = got
    print(f"   counted reduced glm4-9b forward (4, 96) f32: CPU {cpu.flops:.6e} FLOPs "
          f"{cpu.memory_bytes:.6e} bytes; card {card.flops:.6e} FLOPs {card.memory_bytes:.6e} "
          f"bytes; kernels {card.by_kernel}")
    same = (cpu.flops, cpu.memory_bytes, cpu.by_kernel) == (card.flops, card.memory_bytes,
                                                           card.by_kernel)
    print(f"   the same on both devices: {same}")
    if not same or cpu.flops <= 0:
        raise SystemExit(f"roofline: the CPU and the card count differently: {cpu} and {card}")


def _span_ms(spans, name):
    return [(s["end"] - s["begin"]) * 1e3 for s in spans if s["name"] == name]


def _fmt_evaluation(kind, m, spans):
    """Latency, throughput and (by kind) the optimal batch or the achieved
    QPS and SLO attainment, from the metrics and the trace."""
    from repro_torch.core.analysis import trimmed_mean

    predict = _span_ms(spans, "predict")
    if kind == "batched":
        per = m["per_batch"]
        lat = ", ".join(f"b{b} {v['trimmed_mean_ms']:.2f} ms / {v['throughput_ips']:.1f}/s"
                        for b, v in per.items())
        return (f"per batch (trimmed mean, throughput): {lat}; max throughput "
                f"{m['max_throughput_ips']:.2f} inputs/s at optimal batch "
                f"{m['optimal_batch_size']}")
    # nearest-rank p99 over at most 100 requests is their maximum
    if "p99_ms" not in m and m["num_requests"] > 100:
        raise SystemExit("platform: p99 of more than 100 requests is not their maximum")
    p99 = m.get("p99_ms", m["max_ms"])
    out = f"trimmed mean {m['trimmed_mean_ms']:.3f} ms, p99 {p99:.3f} ms"
    if kind == "online":
        (scen,) = _span_ms(spans, "scenario:online")
        out += f", throughput {m['num_requests'] / scen * 1e3:.3f} requests/s"
    elif kind == "server":
        out += (f", achieved {m['achieved_qps']:.3f} QPS of {m['offered_qps']:.1f} offered, SLO "
                f"{m['slo_ms']:.0f} ms attainment {m['slo_attainment']:.3f}, mean batch "
                f"{m['sched_mean_batch_occupancy']:.2f}")
    elif kind == "offline":
        out += (f", throughput {m['throughput_ips']:.3f} inputs/s, mean batch "
                f"{m['sched_mean_batch_occupancy']:.2f}")
    inference = _span_ms(spans, "inference")
    return out + (f"; predict trimmed mean {trimmed_mean(predict):.3f} ms over {len(predict)}, "
                  f"of which inference (the forward, synchronized) "
                  f"{trimmed_mean(inference):.3f} ms over {len(inference)}")


def _check_layer_names(arch, spans, passes):
    """The FRAMEWORK spans of every pass name the layers as the reference
    names them: ``embed``, ``layer_{l:03d}_attn`` plus ``_w{window}`` on a
    windowed config (``_w4096`` local, ``_w1073741824`` global), or
    ``layer_{l:03d}_mamba`` and, after each hybrid group ``g``,
    ``layer_{g:03d}_shared_attn``, then ``logits``; an enc-dec model's
    ``enc_embed``, ``enc_layer_{l:03d}``, ``enc_norm``, ``dec_embed``,
    ``dec_layer_{l:03d}``, ``logits``."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import GLOBAL_WINDOW

    cfg = get_config(arch)
    kind = "mamba" if cfg.family in ("ssm", "hybrid") else "attn"
    windowed = cfg.global_every > 0 and cfg.sliding_window > 0
    E = cfg.hybrid_attn_every if cfg.family == "hybrid" else 0

    def suffix(l):
        if not windowed:
            return ""
        glob = l % cfg.global_every == cfg.global_every - 1
        return f"_w{GLOBAL_WINDOW if glob else cfg.sliding_window}"

    if cfg.family == "encdec":
        want = (["enc_embed"] + [f"enc_layer_{l:03d}" for l in range(cfg.encoder_layers)]
                + ["enc_norm", "dec_embed"]
                + [f"dec_layer_{l:03d}" for l in range(cfg.num_layers)] + ["logits"])
    else:
        want = ["embed"]
        for l in range(cfg.num_layers):
            want.append(f"layer_{l:03d}_{kind}{suffix(l)}")
            if E and l % E == E - 1:
                want.append(f"layer_{l // E:03d}_shared_attn")
        want.append("logits")
    names = [s["name"] for s in spans if s["name"] in set(want)]
    if names != want * passes:
        raise SystemExit(f"platform {arch} FRAMEWORK: layer spans {names[:4]}... are not the "
                         f"reference's {want[:4]}... x{passes}")
    print(f"      FRAMEWORK layer names as the reference's: {want[1]}, {want[2]}, ... x{passes}")


def _cost_line(arch, cost, ms, batch, model_flops, label):
    """A SYSTEM predict's counted FLOPs and bytes (``system:cost``) beside a
    yardstick, and the share of the bf16 peak they reach at its
    ``system:cuda`` device ms."""
    from repro_torch.roofline import H100_SXM

    tflops = cost["flops"] / ms / 1e9
    return (f"{arch} at batch {batch}: counted {cost['flops']:.4e} FLOPs and "
            f"{cost['bytes_accessed']:.4e} bytes (bound {cost['step_time_bound_s'] * 1e3:.4f} ms, "
            f"{cost['dominant']}), {label} {model_flops:.4e} (ratio "
            f"{cost['flops'] / model_flops:.4f}); at {ms:.4f} device ms {tflops:.2f} TFLOP/s, "
            f"{tflops * 1e12 / H100_SXM.peak_flops:.4f} of "
            f"{H100_SXM.peak_flops / 1e12:.0f} TFLOP/s")


def platform_phase(torch, counters):
    """The platform at published width on the card (bf16, random weights
    from seed 0): each evaluation opens its own predictor; each kernel must
    launch exactly its per-pass count times the evaluation's ``inference``
    spans plus its SYSTEM cost events' counting forwards (one a batch
    shape), and no other kernel; the SYSTEM evaluation's ``system:cuda``
    launches must add up to the per-pass counts of its predicts, each
    predict must carry one ``system:cost`` event, and glm4-9b's counted
    FLOPs are printed beside 2 N D and their share of the card; the evaldb
    holds one record per evaluation."""
    from repro_torch.core import EvaluationRequest, ScenarioSpec, SchedulerConfig, Span
    from repro_torch.core.analysis import top_layers
    from repro_torch.configs import get_config
    from repro_torch.core.platform import LocalPlatform
    from repro_torch.roofline import model_flops_for

    platform = LocalPlatform(backends=("torch",), reduced_models=False)
    # ResNet-50's device ms and counted FLOPs of each predict by batch
    # (batched SYSTEM) and its images/s by batch (batched MODEL)
    resnet_ms, resnet_flops, resnet_ips = {}, {}, {}
    try:
        evaluations = _evaluations()
        for label, arch, level, scen, sched in evaluations:
            req = EvaluationRequest(model=arch, scenario=ScenarioSpec(seed=SEED, **scen),
                                    trace_level=level, seq_len=PLATFORM_SEQ,
                                    scheduler=SchedulerConfig(**sched) if sched else None)
            _zero(counters)
            t0 = time.perf_counter()
            res = platform.evaluate(req)[0]
            wall = time.perf_counter() - t0
            counts = {name: mod.launches for name, mod in counters.items()}
            spans = platform.evaldb.spans(res["eval_id"])
            passes = len(_span_ms(spans, "inference"))
            costs = [s["tags"] for s in spans if s["name"] == "system:cost"]
            # a SYSTEM predict's first of its batch shape counts the costs by
            # a forward of its own, outside the inference span
            counting = sum(1 for c in costs if c["counted"])
            expect = {k: n * (passes + counting) for k, n in PER_PASS[arch].items()}
            got = {k: n for k, n in counts.items() if n}
            (load,) = _span_ms(spans, "model_load")
            print(f"   {arch} {label}: model_load {load:.1f} ms, {passes} passes"
                  + (f" and {counting} counting forwards" if counting else "")
                  + f", launches {got} (expected {expect}), evaluation wall {wall:.2f} s")
            if not passes or got != expect:
                raise SystemExit(f"platform {arch} {label}: launches {got}, expected {expect}")
            print(f"      {_fmt_evaluation(scen['kind'], res['metrics'], spans)}")
            if level == "FRAMEWORK":
                _check_layer_names(arch, spans, passes)
                top = top_layers([Span.from_dict(d) for d in spans], k=5)
                print("      FRAMEWORK top 5 layers: " + ", ".join(
                    f"{t.name} {t.mean_s * 1e3:.3f} ms x{t.count}" for t in top))
            if level == "SYSTEM":
                events = [s["tags"] for s in spans if s["name"] == "system:cuda"]
                summed = {}
                for e in events:
                    for k, n in e["launches"].items():
                        summed[k] = summed.get(k, 0) + n
                in_spans = {k: n * passes for k, n in PER_PASS[arch].items() if n}
                if len(events) != passes or summed != in_spans:
                    raise SystemExit(f"platform SYSTEM: system:cuda launches {summed} over "
                                     f"{len(events)} events, expected {in_spans} (counters "
                                     f"{got})")
                if len(costs) != passes or not all(c["flops"] > 0 for c in costs):
                    raise SystemExit(f"platform SYSTEM: {len(costs)} system:cost events for "
                                     f"{passes} predicts, FLOPs {[c['flops'] for c in costs]}")
                ms = [e["device_ms"] for e in events]
                if not all(x is not None and x > 0 for x in ms):
                    raise SystemExit(f"platform SYSTEM: system:cuda device_ms {ms}, device "
                                     f"records {[e['device_records'] for e in events]}, lost "
                                     f"{[e['lost_records'] for e in events]}, work range found "
                                     f"{[e['work_range_found'] for e in events]}: the profiler "
                                     f"recorded no device time")
                lost = [e["lost_records"] for e in events]
                if any(lost):
                    raise SystemExit(f"platform SYSTEM: system:cuda lost_records {lost} (device "
                                     f"ms {ms}): the profiler dropped device records")
                print(f"      SYSTEM system:cuda: device busy ms per predict "
                      f"{', '.join(f'{x:.3f}' for x in ms)} over "
                      f"{sum(e['device_records'] for e in events)} device records, none lost (the "
                      f"prologues lost {sorted(set(e['prologue_lost'] for e in events))}); "
                      f"max_memory_allocated {max(e['max_memory_allocated'] for e in events) / 1e9:.2f} GB; "
                      f"launches agree with the counters; one system:cost a predict")
                # the events (begin 0) in predict order beside the inference
                # spans in predict order
                # (an instrumented LM pass tags no batch: glm4-9b's is online, batch 1)
                batches = [s["tags"].get("batch", 1) for s in spans if s["name"] == "inference"]
                if arch == RESNET and scen["kind"] == "batched":
                    for b, x, c in zip(batches, ms, costs):
                        resnet_ms.setdefault(b, []).append(x)
                        resnet_flops[b] = c["flops"]
                elif arch != RESNET:
                    n_active = get_config(arch).param_count(active_only=True)
                    for b, x, c in zip(batches, ms, costs):
                        print("      " + _cost_line(
                            arch, c, x, b, model_flops_for(n_active, b * PLATFORM_SEQ, "infer"),
                            "2 N D"))
            elif arch == RESNET and scen["kind"] == "batched":
                resnet_ips = {int(b): v["throughput_ips"]
                              for b, v in res["metrics"]["per_batch"].items()}
        records = platform.evaldb.query()
        if len(records) != len(evaluations):
            raise SystemExit(f"evaldb holds {len(records)} records for {len(evaluations)} "
                             f"evaluations")
        print(f"   evaldb: {len(records)} records, one per evaluation")
        _print_resnet(resnet_ms, resnet_flops, resnet_ips)
        print(platform.report(model="glm4-9b"))
    finally:
        platform.shutdown()


def _print_resnet(device_ms, flops, ips):
    """Full ResNet-50 (bf16) at each batch of RESNET_BATCHES: the median
    device ms of a predict (``system:cuda``), the platform's images/s, the
    share of the bf16 peak that the forward reaches at 2 x its MACs, and
    the counted FLOPs (``system:cost``), which must equal 2 x its MACs."""
    import statistics

    from repro_torch.models import ResNet, ResNetConfig
    from repro_torch.roofline import H100_SXM

    model = ResNet(ResNetConfig(), device="cpu")
    if sorted(device_ms) != RESNET_BATCHES or sorted(ips) != RESNET_BATCHES:
        raise SystemExit(f"platform {RESNET}: batches {sorted(device_ms)} (SYSTEM) and "
                         f"{sorted(ips)} (MODEL), expected {RESNET_BATCHES}")
    for b in RESNET_BATCHES:
        ms = statistics.median(device_ms[b])
        tflops = 2 * model.macs(b) / ms / 1e9
        print(f"   {RESNET} bf16 at batch {b}: device ms per predict {ms:.4f} (median of "
              f"{len(device_ms[b])} system:cuda events), {b / ms * 1e3:.1f} images/s of "
              f"device time; platform {ips[b]:.1f} images/s (batched, MODEL); forward "
              f"{tflops:.2f} TFLOP/s at 2 x {model.macs(1) / 1e9:.3f} GMAC an image: "
              f"{tflops * 1e12 / H100_SXM.peak_flops:.4f} of {H100_SXM.peak_flops / 1e12:.0f} "
              f"TFLOP/s; counted {flops[b]:.6e} FLOPs (2 x MACs {2 * model.macs(b):.6e})")
        if flops[b] != 2 * model.macs(b):
            raise SystemExit(f"{RESNET} batch {b}: counted {flops[b]} FLOPs, 2 x MACs "
                             f"{2 * model.macs(b)}")


EXAMPLES = ("quickstart", "compare_models", "inspect_trace", "serve_scenarios")


def examples_phase(torch):
    """The four serving examples' torch twins (``examples/*_torch.py``) run
    in this process on the card (``runpy``: no second CUDA context), as a
    user runs them, with no arguments; each must exit 0 in its seconds,
    printed with a few of its lines (inspect_trace's SYSTEM events: a
    ``system:cost`` line with FLOPs above 0 and a ``system:cuda`` line a
    predict with device ms above 0, no lost record and its work range
    found)."""
    import contextlib
    import io
    import runpy

    argv = sys.argv
    for name in EXAMPLES:
        path = ROOT / "examples" / f"{name}_torch.py"
        out, code = io.StringIO(), 0
        sys.argv = [str(path)]
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                runpy.run_path(str(path), run_name="__main__")
        except SystemExit as e:
            code = e.code or 0
        finally:
            sys.argv = argv
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        lines = out.getvalue().splitlines()
        print(f"   examples/{name}_torch.py on the card: exit {code} in {seconds:.2f} s, "
              f"{len(lines)} lines")
        keep = {"quickstart": lambda l: l.startswith(("evaluated", "  trimmed", "  p90")),
                "compare_models": lambda l: True,
                "inspect_trace": lambda l: l.startswith(("==", "  flops=", "  device_ms=")),
                "serve_scenarios": lambda l: l.startswith(("[scenario:", "---"))}[name]
        for line in [l for l in lines if keep(l)][:14]:
            print(f"      {line}")
        if code:
            raise SystemExit(f"examples/{name}_torch.py exited {code}")
        if name == "inspect_trace":
            flops = [float(x) for x in re.findall(r"^  flops=(\S+)", out.getvalue(), re.M)]
            cuda = re.findall(r"^  device_ms=(\S+) lost_records=(\d+) work_range_found=(\w+)",
                              out.getvalue(), re.M)
            # a window whose work range was not found or that lost records
            # reads None: no reading, and a failure here (ROADMAP Queue 3 item 2)
            if not (flops and len(cuda) == len(flops)
                    and all(m != "None" and float(m) > 0 and lost == "0" and found == "True"
                            for m, lost, found in cuda)
                    and all(x > 0 for x in flops)):
                raise SystemExit(f"inspect_trace: system:cost FLOPs {flops}, system:cuda "
                                 f"(device_ms, lost_records, work_range_found) {cuda}")
        _release(torch)


def serve_record_check():
    """The port's serve driver on reduced glm4-9b on the card with
    ``--evaldb``: one record, backend ``torch``, its engine knobs beside the
    summary.  The driver's report is kept out of this script's output but
    for its knobs header."""
    import contextlib
    import io
    import tempfile

    from repro_torch.core.evaldb import EvalDB
    from repro_torch.launch import serve

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = str(Path(tmp) / "serve.sqlite")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = serve.main(["--requests", "4", "--prompt-len", "32", "--max-new-tokens", "4",
                             "--evaldb", path])
        db = EvalDB(path)
        try:
            records = db.query()
        finally:
            db.close()
    if rc != 0 or len(records) != 1:
        raise SystemExit(f"serve driver --evaldb: exit {rc}, {len(records)} records")
    (rec,) = records
    knobs = rec.metrics.get("engine_knobs")
    print("   " + next(l for l in out.getvalue().splitlines() if l.startswith("[serve] engine=")))
    print(f"   serve driver --evaldb: record {rec.model} backend {rec.backend} scenario "
          f"{rec.scenario} agent {rec.agent_id}, engine_knobs {knobs}, "
          f"{len(rec.metrics) - 1} summary metrics")
    if rec.backend != "torch" or not knobs or knobs.get("engine") != "paged":
        raise SystemExit("serve driver --evaldb: the record lacks its engine knobs or backend")


# ---------------------------------------------------------------------------
# Training: the backward kernels, the train step card vs CPU, and glm4-9b at
# full width (phase 4c)
# ---------------------------------------------------------------------------
TRAIN_BATCH, TRAIN_SEQ = 4, 1024          # phase 4c's batch: 4 rows of 1024 tokens
TRAIN_LAYERS = 4                          # glm4-9b cut to 4 of its 40 layers (memory)
TRAIN_MICRO = 2                           # microbatches a step
TRAIN_STEPS = 5                           # steps on one repeated batch
# AdamW's first steps move every weight by about the learning rate: 1e-3
# memorised the batch in one step and then overshot (12.73, 1.47, 0.80,
# 8.14, 3.78 in a first run), so the full-width run takes a gentler one
TRAIN_LR = 5e-5
TRAIN_ARCHS = ("glm4-9b", "qwen3-moe-30b-a3b", "whisper-large-v3", "mamba2-130m",
               "zamba2-2.7b")
# phase 4c's models: (arch, layers kept (None: all), batch rows of TRAIN_SEQ
# tokens): glm4-9b cut for memory, mamba2-130m whole, zamba2-2.7b cut to 12
# of its 54 layers (two applications of its shared block)
TRAIN_MODELS = (("glm4-9b", TRAIN_LAYERS, TRAIN_BATCH), ("mamba2-130m", None, 8),
                ("zamba2-2.7b", 12, 4))
# the ssd backward at the training shapes: (arch, rows) of TRAIN_SEQ tokens,
# and small cases: (label, (b, s, h, p, n, chunk), initial state, final-state
# cotangent, B and C views of one projection (odd: of odd width, rows not
# 16-byte aligned)), float32 on the CUDA cores and bf16 on the tensor cores
SSD_BWD_SHAPES = (("mamba2-130m", 8), ("zamba2-2.7b", 4))
SSD_BWD_CASES = (
    ("s 37, chunk 8 (a partial trailing chunk)", (2, 37, 4, 64, 128, 8), False, False, False),
    ("s 20 < chunk 64", (2, 20, 4, 64, 128, 64), False, False, False),
    ("an initial state", (2, 130, 4, 64, 64, 64), True, False, False),
    ("a final-state cotangent", (2, 130, 4, 64, 128, 64), True, True, False),
    ("B and C views of one projection", (2, 100, 4, 64, 128, 64), False, True, True),
)
SSD_BWD_TC_CASES = (
    ("s 37, chunk 16 (a partial trailing chunk)", (2, 37, 4, 64, 128, 16), False, False, False),
    ("s 20 < chunk 64", (2, 20, 4, 64, 128, 64), False, False, False),
    ("an initial state, 5 heads", (2, 130, 5, 64, 64, 64), True, False, False),
    ("a final-state cotangent", (2, 130, 4, 64, 128, 64), True, True, False),
    ("B and C views of one projection, chunk 32", (2, 100, 4, 64, 128, 32), False, True, True),
    ("B and C views of an odd-width projection", (2, 100, 4, 64, 128, 64), True, True, "odd"),
)
TRAIN_REL = 1e-4                          # reduced f32 metrics, card vs CPU, relative
RESUME_REL = 1e-5                         # 2 + restore + 2 steps vs 4, relative
TRAIN_METRICS = ("loss", "ce", "aux", "grad_norm")
# the flash backward's small cases: (label, q (b, sq, h, d), sk, kvh, options)
BWD_CASES = (
    ("window 64, q_offset 256", (2, 128, 32, 128), 384, 2, {"window": 64, "q_offset": 256}),
    # a cap of 2 bends scores of unit spread by ~20%: the reject without its
    # factor must fail, where a cap far above the scores would change nothing
    ("softcap 2", (2, 128, 32, 128), 384, 2, {"softcap": 2.0, "q_offset": 256}),
    ("not causal", (2, 128, 32, 128), 384, 2, {"causal": False}),
    ("rows with no live key", (2, 128, 32, 128), 64, 2, {"window": 16, "q_offset": 40}),
    ("whisper d 64 rep 1, not causal", (2, 96, 20, 64), 150, 20, {"causal": False}),
    ("zamba2 d 80", (2, 96, 32, 80), 96, 32, {}),
)


def _bwd_inputs(torch, gen, dtype, shape, sk, kvh, opts):
    """q, k, v, do of a backward case, and the forward kernel's o and lse."""
    from repro_torch.kernels import flash_attention as fa

    b, sq, h, d = shape
    randn = lambda *s: torch.randn(s, generator=gen, device=gen.device, dtype=torch.float32)
    q = randn(b, sq, h, d).to(dtype)
    k, v = randn(b, sk, kvh, d).to(dtype), randn(b, sk, kvh, d).to(dtype)
    do = randn(b, sq, h, d).to(dtype)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **opts)
    return q, k, v, o, lse, do


def _sdpa_bwd_set(torch, q, k, v, do):
    """SDPA's causal forward on q, k, v (K/V expanded to q's heads), kept
    for its backward: (out, q, k, v, the cotangent)."""
    import torch.nn.functional as F

    rep = q.shape[2] // k.shape[2]
    qe = q.transpose(1, 2).contiguous().requires_grad_()
    ke = k.transpose(1, 2).repeat_interleave(rep, dim=1).requires_grad_()
    ve = v.transpose(1, 2).repeat_interleave(rep, dim=1).requires_grad_()
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(qe, ke, ve, is_causal=True)
    return out, qe, ke, ve, do.transpose(1, 2).contiguous()


def _sdpa_bwd(out, *a):
    """SDPA's backward alone, on a set of :func:`_sdpa_bwd_set`."""
    import torch

    return torch.autograd.grad(out, a[:3], a[3], retain_graph=True)


def _same_bits(torch, name, got, again):
    """Fail unless two runs of a kernel gave the same bits in every output."""
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"   {name}: the same bits on two runs: {same}")
    if not same:
        raise SystemExit(f"{name}: two runs differ")


def _without_cap_factor(torch, q, k, v, do, opts):
    """The plain backward with the softcap's factor 1 - (sc/cap)^2 left out:
    autograd of the plain forward whose cap passes the gradient straight
    through (a reject)."""
    from repro_torch.kernels import ref

    real = ref._soft_cap
    ref._soft_cap = lambda x, cap: x + (real(x, cap) - x).detach() if cap > 0 else x
    try:
        leaves = [t.float().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            out = ref.attention(*leaves, **opts)
            return torch.autograd.grad(out, leaves, do.float())
    finally:
        ref._soft_cap = real


def _ssd_bwd_inputs(torch, gen, dtype, b, s, h, p, n, init=False, fin=False, views=False):
    """(x, dt, A, B, C, dy) and the optional initial state and final-state
    cotangent of a backward case; dt and A in the ranges mamba2's inits give
    (as the forward's checks); with ``views`` B and C are slices of one
    projection, of odd width where ``views`` is ``"odd"``."""
    randn = lambda *sh: torch.randn(sh, generator=gen, device=gen.device, dtype=torch.float32)
    uniform = lambda sh, lo, hi: torch.rand(sh, generator=gen, device=gen.device) * (hi - lo) + lo
    x = randn(b, s, h, p).to(dtype)
    if views:
        odd = int(views == "odd")
        proj = randn(b, s, 2 * n + 24 + odd).to(dtype)
        B, C = proj[..., 8:8 + n], proj[..., 8 + n + odd:8 + 2 * n + odd]
    else:
        B, C = randn(b, s, n).to(dtype), randn(b, s, n).to(dtype)
    dt, A = uniform((b, s, h), 1e-3, 1e-1), -uniform((h,), 1.0, 16.0)
    dy = randn(b, s, h, p).to(dtype)
    opts = dict(initial_state=randn(b, h, p, n) if init else None,
                d_final=randn(b, h, p, n) if fin else None)
    return (x, dt, A, B, C, dy), opts


def _ssd_bwd_without(torch, part, args, opts, chunk):
    """The plain chunked backward (``ref.ssd_bwd_chunks``) with a part of
    the work left out (a reject): ``"carry"`` the carried-state W terms (every
    W_c zero), ``"cumsum"`` the reverse cumsum of dcum (da = dcum)."""
    from repro_torch.kernels import ref

    name = {"carry": "_ssd_carry_back", "cumsum": "_reverse_cumsum"}[part]
    real = getattr(ref, name)
    fake = {"carry": lambda G, decays, d_final: ([torch.zeros_like(g) for g in G], d_final),
            "cumsum": lambda t, dim: t}[part]
    setattr(ref, name, fake)
    try:
        return ref.ssd_bwd_chunks(*args, chunk=chunk, **opts)
    finally:
        setattr(ref, name, real)


def _ssd_bwd_check(torch, label, sb, args, opts, chunk, want, kept=None):
    """Every gradient of ``sb.ssd_bwd`` (with the forward's ``kept`` (cum,
    states) where given) against ``want``, ``ref.ssd_bwd``'s; two calls the
    same bits.  Returns (max error, the gradients)."""
    extra = {} if kept is None else dict(cum=kept[0], states=kept[1])
    got = sb.ssd_bwd(*args, chunk=chunk, **opts, **extra)
    err = 0.0
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "d_initial"), got, want):
        err = max(err, _check(torch, f"ssd_bwd {label}: {name}", g, w))
    if not all(torch.equal(g, a) for g, a in zip(got, sb.ssd_bwd(*args, chunk=chunk, **opts,
                                                                    **extra))):
        raise SystemExit(f"ssd_bwd {label}: two calls differ")
    return err, got


def _ssd_kept(sd, args, opts, chunk):
    """The forward's float32 cum and entry states, as ``SSDFn`` keeps them."""
    _, _, cum, states = sd._scan(*args[:5], chunk, opts["initial_state"], False)
    return cum, states


def ssd_bwd_kernels_phase(torch, dev, cpm):
    """``ssd_bwd`` against ``ref.ssd_bwd`` (the sequential reverse
    recurrence): bf16 on the tensor-core route at mamba2-130m's and
    zamba2-2.7b's training shapes and phase 4c's microbatches, each with the
    forward's kept states (as the train step calls it) and once without
    them, the small bf16 cases of SSD_BWD_TC_CASES both ways and the
    float32 cases of SSD_BWD_CASES, every gradient, two calls the same bits;
    the plain chunked backward without the carried-state W terms (dx) and
    without the reverse cumsum of dcum (ddt) must fail the limit.  Each
    training shape and microbatch timed with the kept states beside its
    plain version and its bound (no single PyTorch call computes it: no
    library time), and without them.  Returns the record of mamba2's
    shape."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as sd
    from repro_torch.kernels import ssd_bwd as sb
    from repro_torch.roofline import work

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)
    bf = torch.bfloat16
    err, record = 0.0, None
    for arch, rows in SSD_BWD_SHAPES:
        cfg = get_config(arch)
        h, p, n, chunk = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
        pl = sb.plan(bf, p, n, chunk)
        if pl.route != "mma":
            raise SystemExit(f"ssd_bwd {arch}: plan {pl}, expected the tensor-core route")
        for b in (rows, rows // TRAIN_MICRO):      # the shape, then phase 4c's microbatch
            s = TRAIN_SEQ
            args, opts = _ssd_bwd_inputs(torch, gen, bf, b, s, h, p, n)
            kept = _ssd_kept(sd, args, opts, chunk)
            shape = f"{arch} x ({b}, {s}, {h}, {p}) bf16, n {n}, chunk {chunk}"
            want = ref.ssd_bwd(*args, **opts)
            e, got = _ssd_bwd_check(torch, f"{shape}, kept states", sb, args, opts, chunk, want,
                                    kept)
            e2, alone = _ssd_bwd_check(torch, f"{shape}, states rebuilt", sb, args, opts, chunk,
                                       want)
            err = max(err, e, e2)
            print(f"   ssd_bwd {arch} ({b}, {s}): two calls give the same bits; kept and rebuilt "
                  f"states give the same bits: {all(map(torch.equal, got, alone))}; plan {pl}, "
                  f"workspace {sb.workspace_bytes(pl, b, s, h, p, n, chunk, kept=True) / 1e6:.1f} "
                  f"MB ({sb.workspace_bytes(pl, b, s, h, p, n, chunk) / 1e6:.1f} rebuilt)")
            if arch == "mamba2-130m" and b == rows:
                _rejects(torch, "ssd_bwd plain without the carried-state W terms (dx)",
                         _ssd_bwd_without(torch, "carry", args, opts, chunk)[0], want[0])
                _rejects(torch, "ssd_bwd plain without the reverse cumsum of dcum (ddt)",
                         _ssd_bwd_without(torch, "cumsum", args, opts, chunk)[1], want[1])
            del got, alone, want
            w = work.ssd_bwd(b, s, h, p, n, chunk)
            nbytes, bound = w.bytes, _bound(w)
            # cold inputs: the rotation counts the kept states, which the call reads
            kbytes = nbytes + 4 * (kept[0].numel() + kept[1].numel())
            sets = _rotation(kbytes, lambda i: tuple(t.clone() for t in args + kept))
            kernel = lambda *a: sb.ssd_bwd(*a[:6], chunk=chunk, cum=a[6], states=a[7])
            rebuilt_ms, _ = _time_ms(torch, lambda *a: sb.ssd_bwd(*a[:6], chunk=chunk), sets, cpm)
            if b == rows:
                r = dict(err=err, **_timed(torch, cpm, kernel, lambda *a: ref.ssd_bwd(*a[:6]),
                                           None, sets, [], plain_calls=2),
                         bound=bound, shape=f"{shape}; the forward's states kept; dx, ddt, dA, "
                                            f"dB, dC and d_initial out")
                _print_records({"ssd_bwd": r})
                if record is None:
                    record = r
                print(f"   ssd_bwd {arch} ({b}, {s}) with the states rebuilt: kernel_ms "
                      f"{rebuilt_ms:.4f}")
            else:
                ms, quiet = _time_ms(torch, kernel, sets, cpm)
                plain_ms = _time_few(torch, lambda: ref.ssd_bwd(*sets[0][:6]), 2)
                print(f"   ssd_bwd {arch} at phase 4c's microbatch x ({b}, {s}, {h}, {p}): "
                      f"kernel_ms {ms:.4f} (states rebuilt {rebuilt_ms:.4f}) plain_ms "
                      f"{plain_ms:.4f} (host gaps) bound_ms {bound[0]:.4f} ({bound[1]}); host "
                      f"gaps: {not quiet}")
            del sets, args, kept
    for dtype, cases in ((bf, SSD_BWD_TC_CASES), (torch.float32, SSD_BWD_CASES)):
        for label, (b, s, h, p, n, chunk), init, fin, views in cases:
            pl = sb.plan(dtype, p, n, chunk, s)
            if pl.route != ("mma" if dtype == bf else "f32"):
                raise SystemExit(f"ssd_bwd {label}: plan {pl}")
            args, opts = _ssd_bwd_inputs(torch, gen, dtype, b, s, h, p, n, init, fin, views)
            tag = f"{str(dtype)[6:]} {label} ({b}, {s}, {h}, {p}), n {n}, chunk {chunk}"
            want = ref.ssd_bwd(*args, **opts)
            e, got = _ssd_bwd_check(torch, tag, sb, args, opts, chunk, want)
            err = max(err, e)
            if pl.route == "mma":
                e, kept = _ssd_bwd_check(torch, f"{tag}, kept states", sb, args, opts, chunk,
                                         want, _ssd_kept(sd, args, opts, chunk))
                err = max(err, e)
                print(f"   ssd_bwd {tag}: kept and rebuilt states give the same bits: "
                      f"{all(map(torch.equal, got, kept))}")
    record["err"] = err
    return record


def train_kernels_phase(torch, dev):
    """The training path's kernels against their plain versions: the
    forward's log-sum-exp against ``ref.attention_lse`` (and the forward's
    bits with and without it), ``flash_attention_bwd`` at the training shape
    (glm4-9b, q (TRAIN_BATCH, TRAIN_SEQ, 32, 128) on 2 kv heads, causal,
    bf16; zamba2's d 80 on 32 kv heads; both at phase 4c's microbatch, with
    its own split count), the same bits on two runs, and on
    small bf16 and float32 cases, with two rejects (the plain version
    without the softcap factor; without key 0), and ``rmsnorm_bwd`` at 4096
    rows of 4096, at 8 rows and at phase 4c's other widths; times beside
    SDPA's and ``F.rms_norm``'s backward, and bounds."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm_bwd as rb
    from repro_torch.roofline import work

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    cpm = _sleep_cycles_per_ms(torch)
    cfg = get_config("glm4-9b")
    h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    rep = h // kvh
    bf = torch.bfloat16
    records = {}
    check3 = lambda label, got, want: max(
        _check(torch, f"flash_attention_bwd {label} {n}", g, w)
        for n, g, w in zip(("dq", "dk", "dv"), got, want))

    # -- the forward's log-sum-exp, at the training shape
    b, s = TRAIN_BATCH, TRAIN_SEQ
    q, k, v, o, lse, do = _bwd_inputs(torch, gen, bf, (b, s, h, d), s, kvh, {})
    o_plain, lse_plain = ref.attention_lse(q, k, v)
    err_lse = _check(torch, "flash_attention lse (glm4-9b, training shape)", lse, lse_plain)
    same = torch.equal(o, fa.flash_attention(q, k, v))
    print(f"   flash_attention: the output with lse has the same bits as without: {same}")
    if not same:
        raise SystemExit("flash_attention: writing the log-sum-exp moved the output")
    del o_plain, lse_plain

    # -- flash_attention_bwd at the training shape: the tensor-core route,
    # the same bits on two runs
    splits = fb.tc_splits(b, s, kvh, rep, torch.cuda.get_device_properties(dev)
                          .multi_processor_count)
    print(f"   flash_attention_bwd route at d {d} bf16: {fb.route(bf, d)}, {splits} splits of "
          f"the {rep}-head group, scratch {fb.tc_scratch_bytes(b, s, kvh, d, splits)} B")
    want = ref.flash_attention_bwd(q, k, v, o, lse, do)
    got = fb.flash_attention_bwd(q, k, v, o, lse, do)
    err = check3(f"glm4-9b q ({b}, {s}, {h}, {d}) causal", got, want)
    _same_bits(torch, f"flash_attention_bwd glm4-9b q ({b}, {s}, {h}, {d})", got,
               fb.flash_attention_bwd(q, k, v, o, lse, do))
    o1, lse1 = ref.attention_lse(q, k[:, 1:], v[:, 1:], q_offset=-1)
    _rejects(torch, "flash_attention_bwd plain without key 0 (dq)", ref.flash_attention_bwd(
        q, k[:, 1:], v[:, 1:], o1, lse1, do, q_offset=-1)[0], want[0])
    del want, got, o1, lse1
    w = work.flash_attention_bwd(b, s, s, h, kvh, d)
    nbytes = w.bytes
    sets = _rotation(nbytes, lambda i: tuple(t.clone() for t in (q, k, v, o, lse, do)))
    lib_sets = _rotation(2 * 8 * b * s * h * d, lambda i: _sdpa_bwd_set(torch, q, k, v, do))
    records["flash_attention_bwd"] = dict(
        err=err,
        **_timed(torch, cpm, fb.flash_attention_bwd, ref.flash_attention_bwd, _sdpa_bwd,
                 sets, lib_sets, plain_calls=3),
        bound=_bound(w),
        shape=f"glm4-9b q ({b}, {s}, {h}, {d}), k/v ({b}, {s}, {kvh}, {d}) bf16, causal; "
              f"library: SDPA's backward alone, K/V expanded to {h} heads",
    )
    del sets, lib_sets, q, k, v, o, lse, do
    # the microbatch shape phase 4c launches (its own split count: 8 at
    # glm4-9b's), and zamba2's d 80 (rep 1) at the training shape and its
    # microbatch: each held against the plain version, the same bits on two
    # runs, and timed beside the plain version and SDPA's backward
    mb_b = TRAIN_BATCH // TRAIN_MICRO
    zcfg = get_config(HYBRID_ARCH)
    zh, zd = zcfg.num_heads, zcfg.resolved_head_dim
    for label, (bb, hh, kk, dd) in (
            ("glm4-9b at phase 4c's microbatch", (mb_b, h, kvh, d)),
            (f"{HYBRID_ARCH} d {zd}", (TRAIN_BATCH, zh, zcfg.num_kv_heads, zd)),
            (f"{HYBRID_ARCH} d {zd} at phase 4c's microbatch", (mb_b, zh, zcfg.num_kv_heads, zd))):
        case = _bwd_inputs(torch, gen, bf, (bb, s, hh, dd), s, kk, {})
        want = ref.flash_attention_bwd(*case)
        got = fb.flash_attention_bwd(*case)
        err = max(err, check3(f"{label} q ({bb}, {s}, {hh}, {dd}) causal", got, want))
        _same_bits(torch, f"flash_attention_bwd {label}", got, fb.flash_attention_bwd(*case))
        del want, got
        ms, ms_q = _time_ms(torch, fb.flash_attention_bwd, [case], cpm)
        plain_ms, _ = _time_ms(torch, ref.flash_attention_bwd, [case], cpm)
        q_, k_, v_, _, _, do_ = case
        lib_ms, lib_q = _time_ms(torch, _sdpa_bwd, [_sdpa_bwd_set(torch, q_, k_, v_, do_)], cpm)
        bound = _bound(work.flash_attention_bwd(bb, s, s, hh, kk, dd))
        print(f"   flash_attention_bwd {label} q ({bb}, {s}, {hh}, {dd}) on {kk} kv heads "
              f"({fb.route(bf, dd)}, {fb.tc_splits(bb, s, kk, hh // kk)} splits): kernel_ms "
              f"{ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} (SDPA's backward "
              f"alone; {ms / lib_ms:.2f}x) bound_ms {bound[0]:.4f} ({bound[1]}); host gaps: "
              f"{not (ms_q and lib_q)}")
        del case, q_, k_, v_, do_
    records["flash_attention_bwd"]["err"] = err

    # -- small cases, bf16 and float32
    err = 0.0
    for dtype in (bf, torch.float32):
        for label, shape, sk, kv, opts in BWD_CASES:
            q, k, v, o, lse, do = _bwd_inputs(torch, gen, dtype, shape, sk, kv, opts)
            name = f"{label} {str(dtype).split('.')[-1]}"
            _, lse_plain = ref.attention_lse(q, k, v, **opts)
            err_lse = max(err_lse, _check(torch, f"flash_attention lse {name}", lse, lse_plain))
            want = ref.flash_attention_bwd(q, k, v, o, lse, do, **opts)
            got = fb.flash_attention_bwd(q, k, v, o, lse, do, **opts)
            if "no live key" in label:
                # held on the live rows and the keys some row sees (zeros
                # elsewhere would thin the limit's rms); the rest exactly 0
                live = ref._live(shape[1], sk, opts.get("causal", True), opts.get("window"),
                                 opts.get("q_offset", 0), dev)
                rows, keys = live.any(1), live.any(0)
                zero = bool((got[0][:, ~rows] == 0).all() and (got[1][:, ~keys] == 0).all()
                            and (got[2][:, ~keys] == 0).all())
                dead = lse == ref.LSE_EMPTY
                empty = bool(torch.equal(dead.any(1), ~rows[None].expand_as(dead.any(1))))
                print(f"   flash_attention_bwd {name}: {int((~rows).sum())} rows with no live key "
                      f"store the empty lse ({empty}); their dq and the dk, dv of the "
                      f"{int((~keys).sum())} keys no row sees exactly zero: {zero}")
                if not (zero and empty):
                    raise SystemExit("flash_attention_bwd: rows with no live key mishandled")
                if dtype == bf:
                    # rows that see a few keys of a narrow window: a bf16
                    # rounding of dS that falls the other way in the two
                    # (float32 sums in another order) moves such a row by
                    # ~2**-8 |dS k|, the limit's floor; the float32 case
                    # holds the same code with nothing rounded
                    continue
                got = (got[0][:, rows], got[1][:, keys], got[2][:, keys])
                want = (want[0][:, rows], want[1][:, keys], want[2][:, keys])
            err = max(err, check3(name, got, want))
            if "softcap" in opts:
                _rejects(torch, f"flash_attention_bwd plain without the softcap factor {name} "
                                f"(dq)", _without_cap_factor(torch, q, k, v, do, opts)[0],
                         want[0])
    records["flash_attention_bwd"]["err"] = max(records["flash_attention_bwd"]["err"], err)
    records["flash_attention_bwd"]["err_lse"] = err_lse

    # -- rmsnorm_bwd: 4096 rows of 4096 (a layer's norm at phase 4c's batch) and 8
    D = cfg.d_model
    randn = lambda *sh: torch.randn(sh, generator=gen, device=dev, dtype=torch.float32).to(bf)
    err = 0.0
    for rows in (8, TRAIN_BATCH * TRAIN_SEQ):
        x, w, dy = randn(rows, D), randn(D) * 0.1, randn(rows, D)
        want = ref.rmsnorm_bwd(x, w, 1e-5, dy)
        got = rb.rmsnorm_bwd(x, w, 1e-5, dy)
        for n, g, t in zip(("dx", "dw"), got, want):
            err = max(err, _check(torch, f"rmsnorm_bwd {rows} rows of {D} {n}", g, t))
        _same_bits(torch, f"rmsnorm_bwd {rows} rows of {D} (dx, dw)", got,
                   rb.rmsnorm_bwd(x, w, 1e-5, dy))
    nbytes = 2 * (3 * rows * D + 2 * D)
    sets = _rotation(nbytes, lambda i: (x.clone(), w.clone(), 1e-5, dy.clone()))
    have_lib = hasattr(F, "rms_norm")

    def rms_lib(x_, w_, dy_):
        xs = x_.clone().requires_grad_()
        ws = (1 + w_.float()).to(bf).requires_grad_()
        with torch.enable_grad():
            out = F.rms_norm(xs, (x_.shape[-1],), ws, eps=1e-5)
        return out, xs, ws, dy_.clone()

    rms_bwd = lambda out, xs, ws, g: torch.autograd.grad(out, (xs, ws), g, retain_graph=True)
    lib_sets = _rotation(nbytes, lambda i: rms_lib(x, w, dy)) if have_lib else []
    records["rmsnorm_bwd"] = dict(
        err=err,
        **_timed(torch, cpm, rb.rmsnorm_bwd, ref.rmsnorm_bwd, rms_bwd if have_lib else None,
                 sets, lib_sets),
        bound=_bound(work.rmsnorm_bwd(rows, D)),
        shape=f"x ({rows}, {D}) bf16; dx, dw the same bits on two runs; library: "
              f"F.rms_norm's backward alone, weight 1 + w",
    )
    del sets, lib_sets
    # phase 4c's other widths at their microbatches (mamba2-130m 8 x 1024 and
    # zamba2-2.7b 4 x 1024 tokens in 2), and 8 rows; each beside its plain
    # version and F.rms_norm's backward
    mcfg = get_config("mamba2-130m")
    zcfg = get_config(HYBRID_ARCH)
    for label, rows, D in (("mamba2-130m", 8 * TRAIN_SEQ // TRAIN_MICRO, mcfg.d_model),
                           (HYBRID_ARCH, TRAIN_BATCH * TRAIN_SEQ // TRAIN_MICRO, zcfg.d_model),
                           (f"{HYBRID_ARCH} gated", TRAIN_BATCH * TRAIN_SEQ // TRAIN_MICRO,
                            2 * zcfg.d_model),
                           ("glm4-9b", 8, cfg.d_model)):
        x, w, dy = randn(rows, D), randn(D) * 0.1, randn(rows, D)
        want = ref.rmsnorm_bwd(x, w, 1e-5, dy)
        got = rb.rmsnorm_bwd(x, w, 1e-5, dy)
        for n, g, t in zip(("dx", "dw"), got, want):
            _check(torch, f"rmsnorm_bwd {label} {rows} rows of {D} {n}", g, t)
        nb = 2 * (3 * rows * D + 2 * D)
        sets = _rotation(nb, lambda i: (x.clone(), w, 1e-5, dy.clone()))
        ms, ms_q = _time_ms(torch, rb.rmsnorm_bwd, sets, cpm)
        plain_ms, plain_q = _time_ms(torch, ref.rmsnorm_bwd, sets, cpm)
        lib = (_time_ms(torch, rms_bwd, _rotation(nb, lambda i: rms_lib(x, w, dy)), cpm)
               if have_lib else (None, True))
        p = rb.plan(D, rows, 2)
        print(f"   rmsnorm_bwd {label} x ({rows}, {D}) ({p.path}, {p.tpr} threads a row, "
              f"{p.blocks} blocks): kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
              f"{'none' if lib[0] is None else f'{lib[0]:.4f}'} bound_ms "
              f"{_bound(work.rmsnorm_bwd(rows, D))[0]:.4f}; host gaps: "
              f"{not (ms_q and plain_q and lib[1])}")
    _print_records(records)
    records["ssd_bwd"] = ssd_bwd_kernels_phase(torch, dev, cpm)
    return records


def _train_models(torch, dev, cfg, seed=SEED):
    """A float32 model on the CPU and on the card, and the CPU's masters."""
    from repro_torch.models import build_model

    cpu_model = build_model(cfg, device="cpu", dtype=torch.float32)
    gpu_model = build_model(cfg, device=dev, dtype=torch.float32)
    return cpu_model, gpu_model, cpu_model.init(seed=seed)


def _train_batch(torch, cfg, b, s, seed, device):
    import numpy as np

    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)).to(device)}
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((b, cfg.encoder_seq, cfg.d_model), device=device)
    return batch


def _run_steps(torch, model, params, opt_cfg, n, seed, microbatches=1, state=None):
    """``n`` float32 train steps; (params, state, per-step metrics as floats)."""
    from repro_torch.train import init_opt_state, make_train_step

    dev = model.device
    state = state if state is not None else init_opt_state(model.param_defs(), opt_cfg, dev)
    step = make_train_step(model, opt_cfg, microbatches=microbatches, remat=True)
    out = []
    for i in range(n):
        params, state, m = step(params, state, _train_batch(torch, model.cfg, 4, 16,
                                                            seed + i, dev))
        out.append({k: float(m[k]) for k in TRAIN_METRICS})
    return params, state, out


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _copy_to(torch, tree, dev):
    """A copy of ``tree`` on ``dev`` (the optimizer updates in place)."""
    return _tree_map(tree, lambda t: t.to(dev, copy=True))


def train_check_phase(torch, dev):
    """Reduced glm4-9b, qwen3-moe-30b-a3b, whisper-large-v3, mamba2-130m and
    zamba2-2.7b in float32: 3 train steps (remat, 2 microbatches) on the
    card and on the CPU from the same masters and batches, each step's
    loss, ce, aux and grad_norm within TRAIN_REL relative (the ssm and
    hybrid scans through ``ssd_bwd`` on the card, ``ref.ssd_bwd`` on the
    CPU); on reduced glm4-9b, 2 steps, a checkpoint, a restore into fresh
    trees and 2 more steps give the losses of 4 steps within RESUME_REL."""
    import tempfile

    from repro_torch.train import CheckpointManager, OptimizerConfig, init_opt_state

    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    for arch in TRAIN_ARCHS:
        cfg = _reduced(arch)
        cpu_model, gpu_model, masters = _train_models(torch, dev, cfg)
        runs = {}
        for name, model in (("cpu", cpu_model), ("cuda", gpu_model)):
            runs[name] = _run_steps(torch, model, _copy_to(torch, masters, model.device),
                                    opt_cfg, 3, SEED, microbatches=2)[2]
        worst = max(_rel(c[k], p[k]) for c, p in zip(runs["cuda"], runs["cpu"])
                    for k in TRAIN_METRICS if p[k] != 0 or c[k] != 0)
        ok = worst <= TRAIN_REL
        print(f"   {cfg.name} f32, 3 steps of 4 x 16 tokens, 2 microbatches, remat: cuda "
              f"{[round(m['loss'], 5) for m in runs['cuda']]} vs cpu "
              f"{[round(m['loss'], 5) for m in runs['cpu']]}; worst relative gap over loss, "
              f"ce, aux, grad_norm {worst:.2e} (within {TRAIN_REL}: {ok}); aux "
              f"{runs['cuda'][0]['aux']:.5f}")
        if not ok:
            raise SystemExit(f"{cfg.name}: the card's train step differs from the CPU's")

    # checkpoint and restore on the card
    cfg = _reduced("glm4-9b")
    _, gpu_model, masters = _train_models(torch, dev, cfg)
    straight = _run_steps(torch, gpu_model, _copy_to(torch, masters, dev), opt_cfg, 4, SEED)[2]
    params, state, first = _run_steps(torch, gpu_model, _copy_to(torch, masters, dev), opt_cfg,
                                      2, SEED)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        mgr = CheckpointManager(tmp, keep=1)
        mgr.save(2, params, state, extra={"data_cursor": 8})
        fresh_p = gpu_model.init(seed=SEED + 1)
        fresh_s = init_opt_state(gpu_model.param_defs(), opt_cfg, dev)
        params, state, meta = mgr.restore(params_template=fresh_p, opt_template=fresh_s)
    _, state, rest = _run_steps(torch, gpu_model, params, opt_cfg, 2, SEED + 2, state=state)
    resumed = first + rest
    worst = max(_rel(a["loss"], b["loss"]) for a, b in zip(resumed, straight))
    ok = worst <= RESUME_REL and meta["step"] == 2 and int(state["step"]) == 4
    print(f"   {cfg.name} f32 on the card: 2 steps, checkpoint, restore into fresh trees, 2 "
          f"steps: losses {[round(m['loss'], 6) for m in resumed]} vs 4 straight "
          f"{[round(m['loss'], 6) for m in straight]}, worst relative gap {worst:.2e} (within "
          f"{RESUME_REL}: {ok})")
    if not ok:
        raise SystemExit("checkpoint/restore: the resumed run differs from the straight one")


_TRAIN_CLASSES = (
    ("flash_fwd", ("flash_attention_kernel",)),
    ("flash_bwd", ("flash_bwd_",)),
    ("ssd_bwd", ("ssd_bwd_kernel",)),
    ("ssd_fwd", ("ssd_kernel",)),
    ("rmsnorm_bwd", ("rmsnorm_bwd",)),
    ("rmsnorm_fwd", ("rmsnorm_kernel",)),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")),
)


def _train_class(name):
    for cls, keys in _TRAIN_CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def _train_expected(cfg, mb):
    """Launches of one phase-4c step of ``mb`` microbatches: each attention
    layer (a hybrid model's shared block once a group) and each Mamba-2
    layer runs its forward kernel twice a microbatch (remat recomputes every
    layer body in the backward) and its backward once; every rmsnorm of a
    pass (``_norms_per_pass``) runs twice but the final norm, which no
    checkpointed body holds, and its backward once.  glm4-9b at 4 layers:
    16 flash, 8 flash backward, 34 rmsnorm, 18 backward; mamba2-130m: 96
    ``ssd``, 48 ``ssd_bwd``, 194 and 98; zamba2-2.7b at 12 layers: 48 and
    24, 8 and 4 flash, 114 and 58."""
    fam = cfg.family
    attn = _groups(cfg) if fam == "hybrid" else (0 if fam == "ssm" else cfg.num_layers)
    scans = cfg.num_layers if fam in ("ssm", "hybrid") else 0
    norms = _norms_per_pass(cfg)
    out = {"rmsnorm": (2 * norms - 1) * mb, "rmsnorm_bwd": norms * mb}
    if attn:
        out.update(flash_attention=2 * attn * mb, flash_attention_bwd=attn * mb)
    if scans:
        out.update(ssd=2 * scans * mb, ssd_bwd=scans * mb)
    return out


def train_phase(torch, dev, counters, arch, layers, rows):
    """``arch`` at full width, cut to ``layers`` layers (None: all): random
    float32 masters from a seeded CUDA generator, bf16 compute, AdamW
    moments in float32, remat, TRAIN_MICRO microbatches, TRAIN_STEPS steps
    on one repeated batch of ``rows`` x TRAIN_SEQ tokens.  The loss must be
    finite and fall; each step's launches must be exactly
    ``_train_expected``, no serving kernel among them.  Prints step ms,
    tok/s, peak memory and one profiled step's device ms by class (the
    optimizer: every kernel launched under ``adamw_update``).  Step 1 runs
    under the roofline counter (it lies outside the median of steps 2 on):
    its counted FLOPs and bytes beside 6 N D and the share of the bf16 peak
    at the median step; each kernel's counted calls must equal its launches.
    Returns each kernel's launches over the steps."""
    import contextlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.roofline import H100_SXM, count_costs, model_flops_for
    from repro_torch.train import OptimizerConfig, init_opt_state, make_train_step
    from repro_torch.train import step as step_mod

    full = get_config(arch)
    cfg = full if layers is None else full.replace(num_layers=layers)
    model = build_model(cfg, device=dev, dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    masters = model.init(seed=SEED, dtype=torch.float32)
    opt_cfg = OptimizerConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS)
    state = init_opt_state(model.param_defs(), opt_cfg, dev)
    step = make_train_step(model, opt_cfg, microbatches=TRAIN_MICRO, remat=True,
                           cast_params_once=True)
    batch = _train_batch(torch, cfg, rows, TRAIN_SEQ, SEED, dev)
    print(f"   {cfg.name} at full width, {cfg.num_layers} of {full.num_layers} layers: "
          f"{cfg.param_count():,} params; batch {rows} x {TRAIN_SEQ}, {TRAIN_MICRO} "
          f"microbatches, remat, bf16 compute, float32 masters and moments")
    expect = _train_expected(cfg, TRAIN_MICRO)
    totals = {name: 0 for name in counters}
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        _zero(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with count_costs() if i == 0 else contextlib.nullcontext() as counted:
            masters, state, m = step(masters, state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            costs = counted
        losses.append(float(m["loss"]))
        got = {name: c.launches for name, c in counters.items()}
        for name in totals:
            totals[name] += got[name]
        bad = {n: (got[n], expect.get(n, 0)) for n in got if got[n] != expect.get(n, 0)}
        if bad:
            raise SystemExit(f"train step {i + 1}: launches (got, expected) {bad}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    finite = all(math.isfinite(x) for x in losses)
    print(f"   losses {[round(x, 4) for x in losses]}; finite: {finite}; last below first: "
          f"{losses[-1] < losses[0]}")
    print(f"   launches per step (all {TRAIN_STEPS} exact): {expect}, no serving kernel")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    print(f"   step ms {[round(t, 1) for t in times]} (the first builds cuBLAS plans); median "
          f"of the rest {steady:.1f} ms, {rows * TRAIN_SEQ / steady * 1e3:,.0f} tok/s; "
          f"peak memory {peak:.2f} GiB")
    if not (finite and losses[-1] < losses[0]):
        raise SystemExit("train: the loss is not finite or did not fall")
    six_nd = model_flops_for(cfg.param_count(active_only=True), rows * TRAIN_SEQ, "train")
    tflops = costs.flops / steady / 1e9
    print(f"   step 1 counted: {costs.flops:.4e} FLOPs, {costs.memory_bytes:.4e} bytes; 6 N D "
          f"{six_nd:.4e} (counted / 6 N D {costs.flops / six_nd:.3f}); at the median step "
          f"{steady:.1f} ms {tflops:.2f} TFLOP/s, {tflops * 1e12 / H100_SXM.peak_flops:.4f} of "
          f"{H100_SXM.peak_flops / 1e12:.0f} TFLOP/s (6 N D: "
          f"{six_nd / steady / 1e9 * 1e12 / H100_SXM.peak_flops:.4f}); kernels: "
          + ", ".join(f"{k} x{n} {f:.3e} FLOPs {b:.3e} B"
                      for k, (n, f, b) in sorted(costs.by_kernel.items())))
    calls = {k: n for k, (n, _, _) in costs.by_kernel.items()}
    if calls != {k: n for k, n in expect.items() if n}:
        raise SystemExit(f"train: counted kernel calls {calls}, launches {expect}")

    real = step_mod.adamw_update
    span = [torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)]

    def ranged(*a, **kw):
        with record_function("adamw_update"):
            span[0].record()
            out = real(*a, **kw)
            span[1].record()
            return out

    step_mod.adamw_update = ranged
    try:
        step = make_train_step(model, opt_cfg, microbatches=TRAIN_MICRO, remat=True,
                               cast_params_once=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            masters, state, m = step(masters, state, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        step_mod.adamw_update = real
    by_class = {cls: 0.0 for cls, _ in _TRAIN_CLASSES}
    by_class.update(optimizer=0.0, other=0.0)
    bwd_kernels, other_kernels, opt_kernels = {}, {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key == "adamw_update":
            continue
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        by_class[_train_class(e.key)] += float(us) / 1e3
        if _train_class(e.key) == "other":
            other_kernels[e.key] = other_kernels.get(e.key, 0.0) + float(us) / 1e3
        m = re.search(r"(flash_bwd_\w+|rmsnorm_bwd\w*|ssd_bwd_kernel_\w+)", e.key)
        if m:
            bwd_kernels[m.group(1)] = bwd_kernels.get(m.group(1), 0.0) + float(us) / 1e3
    # the optimizer: every kernel launched under the adamw_update range
    for e in prof.events():
        chain, p = [], e
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        if e.kernels and "adamw_update" in chain:
            for kern in e.kernels:
                by_class[_train_class(kern.name)] -= kern.duration / 1e3
                by_class["optimizer"] += kern.duration / 1e3
                if kern.name in other_kernels:
                    other_kernels[kern.name] -= kern.duration / 1e3
                n, ms = opt_kernels.get(kern.name, (0, 0.0))
                opt_kernels[kern.name] = (n + 1, ms + kern.duration / 1e3)
    busy = sum(by_class.values())
    if busy <= 0:
        print("   profiler saw no device time: breakdown not measured")
    else:
        print(f"   one profiled step: wall {wall:.1f} ms, device busy {busy:.1f} ms (idle "
              f"{1 - busy / wall:.3f}); device ms by class: "
              + ", ".join(f"{k} {v:.2f}" for k, v in by_class.items()))
        print("   the backward kernels' device ms in that step, by launch: "
              + ", ".join(f"{k} {v:.3f}" for k, v in sorted(bwd_kernels.items())))
        # what the optimizer and other classes hold, kernel by kernel: the
        # optimizer is found by the profiler's link from a kernel to the
        # range that launched it, and the range's own CUDA events bound it
        short = lambda name: re.sub(r"\s+", " ", name)[:120]
        print(f"   the optimizer: {sum(n for n, _ in opt_kernels.values())} kernels linked to "
              f"the adamw_update range; the range's CUDA events span "
              f"{span[0].elapsed_time(span[1]):.2f} device ms; its largest kernels: "
              + "; ".join(f"{short(k)} x{n} {ms:.2f}" for k, (n, ms) in sorted(
                  opt_kernels.items(), key=lambda kv: -kv[1][1])[:5]))
        print("   the other class's largest kernels: "
              + "; ".join(f"{short(k)} {ms:.2f}" for k, ms in sorted(
                  other_kernels.items(), key=lambda kv: -kv[1])[:8]))
    del masters, state, model, step, m
    # what the phase leaves behind before any garbage collection: a
    # reference cycle over the trees would hold gigabytes until it ran
    left = torch.cuda.memory_allocated() / 2**30
    print(f"   device memory still allocated after the phase: {left:.3f} GiB")
    if left > 1.0:
        raise SystemExit("train: the phase's trees outlive it (a reference cycle?)")
    _release(torch)
    return totals


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {SRC}; run from a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    dev = torch.device("cuda")
    # the float32 matmuls of the check phase stay full float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = _phase("1. environment and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f"{torch.cuda.get_device_name(0)}, power limit not readable"
    print(card)
    print(f"   python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    from repro_torch.kernels import _build
    from repro_torch.kernels import kernel_counters

    info = _build.build_info()
    print(f"   kernels: {info.path} ({'built' if info.built else 'cached'} "
          f"in {info.seconds:.1f} s by nvcc, one process per source)")
    build_report(info, _build._nvcc())
    _done(torch, "1. environment and build", t0)

    t0 = _phase("2. kernels vs plain versions (glm4-9b and mamba2-130m widths, bf16; "
                "bf16/int8/fp8 pools)")
    records = kernels_phase(torch, dev)
    records.update(dense_kernels_phase(torch, dev))
    records.update(ssd_kernels_phase(torch, dev))
    for name, err in platform_kernels_phase(torch, dev).items():
        records[name]["err"] = max(records[name]["err"], err)
    print("   -- the rest of the dense family's shapes (gemma2-27b, granite-20b, chameleon-34b)")
    for name, err in zoo_kernels_phase(torch, dev).items():
        records[name]["err"] = max(records[name]["err"], err)
    print(f"   -- {MOE_ARCH}'s shapes (32 query heads on 4 kv heads, d 128, D 2048; bf16 and "
          f"int8 pools)")
    moe_records = kernels_phase(torch, dev, MOE_ARCH, modes=(None, "int8"))
    moe_records.update(dense_kernels_phase(torch, dev, MOE_ARCH))
    for name, r in moe_records.items():
        records[name]["err"] = max(records[name]["err"], r["err"])
    print("   -- flash_attention at chunked prefill's shapes (glm4-9b, gemma2-27b, granite-20b, "
          "qwen3-moe-30b-a3b)")
    records["flash_attention"]["err"] = max(records["flash_attention"]["err"],
                                            chunked_kernels_phase(torch, dev))
    print(f"   -- {HYBRID_ARCH}'s shapes (flash_attention at head dim 80, decode_attention off "
          f"and on the ring, ssd at 80 heads, rmsnorm at 2560 and 5120)")
    for name, err in hybrid_kernels_phase(torch, dev).items():
        records[name]["err"] = max(records[name]["err"], err)
    print(f"   -- {ENCDEC_ARCH}'s shapes (flash_attention at head dim 64 over the 1500 frames, "
          f"decode_attention at rep 1 over the padded cross cache, rmsnorm at 1280)")
    for name, err in whisper_kernels_phase(torch, dev).items():
        records[name]["err"] = max(records[name]["err"], err)
    print("   -- the training path: the forward's log-sum-exp, flash_attention_bwd and "
          "rmsnorm_bwd")
    records.update(train_kernels_phase(torch, dev))
    print(f"   -- glm4-9b's serving kernels at one rank's heads under tensor parallelism "
          f"(tp {TP}: 16 query heads on 1 kv head)")
    records.update(kernels_phase(torch, dev, modes=(None,), tp=TP))
    _done(torch, "2. kernels", t0)

    t0 = _phase("3. check: reduced glm4-9b, mamba2-130m, the rest of the dense family, the "
                "MoE family, the hybrid family, the enc-dec family and ResNet-50, card vs CPU "
                "reference")
    check_phase(torch, dev)
    paged_paths_check(torch, dev)
    dense_check_phase(torch, dev)
    dense_check_phase(torch, dev, "mamba2-130m")
    for arch in ZOO:
        check_phase(torch, dev, arch, prompt_min=ZOO_PROMPT_MIN)
        dense_check_phase(torch, dev, arch, prompt_min=ZOO_PROMPT_MIN)
    print(f"   -- the MoE family ({MOE_ARCH}, {MOE_INTERLEAVED}) at capacity factor "
          f"{MOE_CHECK_CF}")
    moe_check_phase(torch, dev)
    print(f"   -- the hybrid family ({HYBRID_ARCH}) on a plain cache and on a ring of "
          f"{REDUCED_RING}")
    hybrid_check_phase(torch, dev)
    print(f"   -- the enc-dec family ({ENCDEC_ARCH}) at encoder_seq "
          f"{' and '.join(map(str, REDUCED_ENCODER_SEQS))}")
    encdec_check_phase(torch, dev)
    print(f"   -- {RESNET}, reduced and full, f32 card vs CPU, bf16 vs f32, and the padding "
          f"trap")
    resnet_check_phase(torch, dev)
    print("   -- the fault-tolerant fleet (reduced glm4-9b): the recovery matrix, card vs CPU")
    fleet_check(torch, dev)
    print(f"   -- training ({', '.join(TRAIN_ARCHS)}), card vs CPU; checkpoint and restore")
    train_check_phase(torch, dev)
    print("   -- the roofline counter: reduced glm4-9b's forward counted on the card and the CPU")
    roofline_check(torch, dev)
    _done(torch, "3. check", t0)

    t0 = _phase("4. serve: glm4-9b and mamba2-130m, full width and depth, random bf16 weights")
    # every kernel wrapper's launch counter, by kernel name
    counters = kernel_counters()
    model, params = full_model(torch, dev)
    launches, engine, reqs, base = serve_phase(torch, dev, counters, model, params)
    print("   -- the rest of serve_paged: chunked prefill, the prefix cache, overcommit")
    bf16_err = paged_paths_serve_phase(torch, dev, counters, engine, reqs, base)
    print("   -- the dense engines (static generate behind the scheduler; serve_continuous)")
    dense_launches, dense_engine, prompts, _ = dense_serve_phase(torch, dev, counters, model,
                                                                 params)
    for name in ("flash_attention", "decode_attention"):
        launches[name] = dense_launches[name]
    print("   -- mamba2-130m (SSM) through the same two engines")
    ssm_model, ssm_params = full_model(torch, dev, "mamba2-130m")
    ssm_launches, ssm_engine, _, _ = dense_serve_phase(torch, dev, counters, ssm_model,
                                                       ssm_params)
    launches["ssd"] = ssm_launches["ssd"]
    _done(torch, "4. serve", t0)

    t0 = _phase(f"4b. fleet: glm4-9b, {FLEET_WORKERS} workers behind the FleetRouter, faults and "
                f"live KV migration")
    fleet_serve_phase(torch, dev, counters, model, params, reqs)
    _done(torch, "4b. fleet", t0)

    t0 = _phase("5. where the time goes (torch.profiler, device time by kernel class)")
    busy = profile_phase(torch, engine, reqs)
    if busy is None:
        raise SystemExit("profile: the profiler saw no device time in glm4-9b's serve")
    serve_costs_phase(torch, engine, reqs, busy)
    dense_profile_phase(torch, dense_engine, prompts)
    _done(torch, "5. profile", t0)
    del model, params, engine, dense_engine, ssm_model, ssm_params, ssm_engine
    _release(torch)

    t0 = _phase("4c. train: glm4-9b, mamba2-130m and zamba2-2.7b at full width, random weights, "
                "bf16 compute, float32 masters and AdamW moments")
    trained = {}
    for arch, layers, rows in TRAIN_MODELS:
        for name, n in train_phase(torch, dev, counters, arch, layers, rows).items():
            trained[name] = trained.get(name, 0) + n
    for name in ("flash_attention_bwd", "rmsnorm_bwd", "ssd_bwd"):
        launches[name] = trained[name]
    _done(torch, "4c. train", t0)

    t0 = _phase("5b. serve: gemma2-27b, granite-20b and chameleon-34b, full width and depth, "
                "random bf16 weights")
    zoo_serve_phase(torch, dev, counters)
    _release(torch)
    _done(torch, "5b. serve the rest of the dense family", t0)

    t0 = _phase(f"5c. serve: {MOE_ARCH}, full width and depth, random bf16 weights")
    moe_serve_phase(torch, dev, counters, bf16_err)
    _done(torch, "5c. serve the MoE family", t0)

    t0 = _phase(f"5d. serve: {HYBRID_ARCH}, full width and depth, random bf16 weights, with its "
                f"ring cache")
    hybrid_serve_phase(torch, dev, counters)
    _done(torch, "5d. serve the hybrid family", t0)

    t0 = _phase(f"5e. serve: {ENCDEC_ARCH}, full width and depth, random bf16 weights, with its "
                f"cross cache")
    encdec_serve_phase(torch, dev, counters)
    _done(torch, "5e. serve the enc-dec family", t0)


    t0 = _phase("6. platform: client -> server -> agent -> scenario -> torch predictor")
    platform_check(torch, dev)
    platform_phase(torch, counters)
    print("   -- the serve driver's evaluation record")
    serve_record_check()
    _done(torch, "6. platform", t0)

    t0 = _phase("6b. the four serving examples' torch twins on the card")
    examples_phase(torch)
    _done(torch, "6b. examples", t0)

    # last: once other processes (these ranks) have used the card, every
    # later profiler window of this one loses its first device records
    # (tools/profile_windows.py), and phase 6 reads such windows
    _release(torch)
    t0 = _phase(f"7. serve: tensor parallelism, {TP} ranks on the one card (glm4-9b full "
                f"width, reduced in float32, {MOE_ARCH} cut to {TP_MOE_LAYERS} layers)")
    launches.update(tp_serve_phase(torch, dev, bf16_err))
    _done(torch, "7. serve with tensor parallelism", t0)

    sources = {
        "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:26"),
        # the bf16 decode family (every record here is bf16) runs the split-KV
        # routine; float32 keeps csrc/{paged_attention,spec_verify,decode_attention}.cu
        "paged_attention": ("src/repro_torch/kernels/csrc/decode_split.cuh",
                            "src/repro/kernels/paged_attention.py:105"),
        "spec_verify": ("src/repro_torch/kernels/csrc/decode_split.cuh",
                        "src/repro/kernels/spec_verify.py:130"),
        # bf16 (every record here) runs the tensor-core routine; float32 and
        # other head dims keep csrc/varlen_prefill.cu
        "varlen_prefill": ("src/repro_torch/kernels/csrc/varlen_prefill_tc.cuh",
                           "src/repro/kernels/varlen_prefill.py:156"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:101"),
        "decode_attention": ("src/repro_torch/kernels/csrc/decode_split.cuh",
                             "src/repro/kernels/decode_attention.py:82"),
        # bf16 (the record here) runs the tensor-core route; float32 and other
        # widths or chunks keep csrc/ssd.cu
        "ssd": ("src/repro_torch/kernels/csrc/ssd_tc.cu", "src/repro/kernels/ssd_scan.py:95"),
        # the training backward: the flash path's custom VJP, and autodiff of
        # the TPU rmsnorm kernel's plain version
        "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                                "src/repro/kernels/ops.py:126"),
        "rmsnorm_bwd": ("src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
                        "src/repro/kernels/rmsnorm.py:26"),
        # the scan's backward: autodiff of the chunked scan the JAX train
        # driver runs (no Pallas backward)
        # (bf16, the record here, on the tensor cores; float32 and other
        # widths or chunks keep csrc/ssd_bwd.cu)
        "ssd_bwd": ("src/repro_torch/kernels/csrc/ssd_bwd_tc.cu", "src/repro/kernels/ops.py:838"),
    }
    kernels = []
    for name, r in records.items():
        source, replaces = sources[name.split("[")[0]]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": r["err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1],
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
