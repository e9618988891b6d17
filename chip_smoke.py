#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device   — needs ``torch.cuda.is_available()``; prints the card's name and
              power limit as ``nvidia-smi`` reports them.  f32 comparisons
              run with TF32 off (``torch.backends.cuda.matmul.allow_tf32``
              and ``torch.backends.cudnn.allow_tf32`` both False).
2. build    — builds the CUDA kernels from ``src/repro_torch/csrc``.
3. kernels  — each kernel against its plain PyTorch version at the serving
              paths' shapes plus edge cases (flash: windowed, q_offset,
              ragged, GQA 8:1 at dh=64, dh=32, each in f32 and bf16, the
              two dtypes taking different kernels; dense decode: pos = -1,
              wrapped ring, and the split pass and merge with C not a
              multiple of the split, C below one split, a split whose
              slots are all masked, a row with no valid slot, a window
              ring wrapping across a split boundary and GQA 16:1, in f32
              and bf16; paged: holes, a cur_pos sweep across
              page boundaries, a fully unmapped slot, GQA 16:1, with the
              trash page poisoned to 1e4, and the page split (a split
              whose pages are all holes, more splits than mapped pages,
              pages of 4 and 8), in f32 and bf16; verify: the same, a row 0 without
              keys, W = 2, 6 and 8, dh 32 and 64, and the page split
              (windows across split boundaries, more splits than mapped
              pages, 32 rows a kv head), in f32 and bf16; prefix: ragged
              Lp and Sq, q_offset > 0, Lp = 0, GQA 8:1 at dh=64, in f32
              and bf16, the two dtypes taking different kernels; SSD scan
              (bf16 through its five passes, f32 through its f32 kernel,
              each case's route logged and checked): the
              admission shape (also as views of one xBC tensor, as the SSM
              block passes them), S not a multiple of the chunk, S < chunk, a
              single chunk, G = 2, large dt where exp(cum) underflows,
              slow decay (dt ~ 1e-3, the carried state matters) at the
              admission shape and at chunk 32, and every (hd, N) it
              takes; rmsnorm: the qwen3-0.6b admission (2048, 1024),
              decode (8, 1024) and q/k-norm (32768, 128) rows, d = 4096,
              5120 and 12288, d = 130 and a view off the 16-byte boundary,
              f32 and bf16, mixed x and scale dtypes, each case's route
              logged and checked (rows in registers except d = 130 and
              the view, which take the two-pass kernel);
              matmul: (2048, 1024) @ (1024, 3072), (2048, 3072) @
              (3072, 1024), (8, 1024) @ (1024, 3072) and a ragged
              (100, 300) @ (300, 72), bf16 -> bf16, bf16 -> f32 and
              f32 -> f32; each case's route logged and checked: bf16
              through wgmma + TMA except the ragged case, which TMA
              cannot describe, and f32 on the CUDA cores; the host time
              of a launch on each route).  Tolerance: max abs error <= 1e-4 in
              f32 (only the summation order differs) and <= 2e-2 in bf16
              (the output is rounded to bf16 once, about 2^-8 of its
              magnitude); rmsnorm's error is relative where the output
              exceeds 1; the SSD scan's and matmul's errors are relative
              to the plain version's largest magnitude (see ``check_ssd``
              and ``check_matmul``: matmul <= 1e-5 at f32 output, <= 8e-3
              at bf16).  Times the kernel, the plain version and one
              PyTorch library call (``scaled_dot_product_attention``,
              after a torch page gather for the paged kernel;
              ``F.rms_norm``; ``torch.matmul``; a yardstick only; no
              PyTorch call computes the SSD scan).  Flash, dense decode,
              paged decode, verify and prefix also take group 1 (H = Hkv =
              16, dh 128, deepseek-moe-16b's heads) in f32 and bf16, and
              their bf16 times at group 1 are logged beside the PyTorch
              call's.  The last families' shapes: flash at 64:8 (group
              8, qwen2-vl-72b) and non-causal at whisper-base's heads (8:8,
              dh 64: 1500 x 1500 frames, and Sq = 4 and 1 over 1500 for the
              cross-attention), dense decode at 64:8, the SSD at
              jamba-1.5-large's SSM widths (B 2, S 1024, chunk 256, nh 128,
              hd 128, G 8, N 128, also with slow decay) and at hd 128, N 16,
              each in f32 and bf16; their bf16 times (and qwen2-vl's and
              whisper's decode) logged beside the bound and SDPA (none for
              the SSD).  Training: the flash kernel's log-sum-exp
              (``return_lse=True``, f32 (B, Sq, H)) against the plain
              version's and the reference's blockwise units at the training
              shape (8 x 512, 16:8, dh 128), windowed, q_offset, ragged, GQA
              8:1 at dh 64, non-causal and rows without a valid key (-1e30),
              in f32 and bf16; ``FlashAttentionFn``'s dq, dk, dv against
              autograd of naive attention in the reference test's four
              cases at dh 128 (relative to the largest gradient: 2e-4 f32,
              2e-2 bf16); then the kernel with its LSE, the torch backward
              and forward + backward (beside SDPA's, a yardstick) timed at
              the training shape (``train_times``).
4. model    — full-width qwen3-0.6b cut to 2 layers, f32: prefill + 4 decode
              steps with attn_impl="cuda" against attn_impl="torch"; the
              same decode on a shuffled paged pool (``page_table=``); one
              ``verify_step`` window on the pool, kernel against plain and
              each row against the sequential decode steps; and
              ``prefix_prefill`` through the prefix kernel against a cold
              prefill.  Full-width mamba2-370m cut to 2 layers, f32:
              with Mamba-2's dt and A init: prefill (SSD kernel) + 4
              decode steps against the plain path, and decode of token
              S + 1 against a prefill over S + 1.
              Logits within 2e-3 max abs, greedy tokens identical.
4c. moe     — deepseek-moe-16b and mixtral-8x22b at full width, each
              freed before the next: cut to 2 layers in f32 with phase 4's
              rule (logits within 2e-3, greedy tokens identical), then in
              bf16, deepseek at full depth (28 layers, 64 routed experts
              top-6 + 2 shared) and mixtral cut to 2 layers, against two
              plain routes ("torch" and "naive"): logits finite and the
              kernels' within ``MOE_SPREAD`` x the plain routes' own
              difference (see ``check_moe_model``).  A prefill of 2 x 256
              tokens and 4 decode steps each; the flash and decode kernels
              launched once a layer on the cuda route only.
4e. train   — full-width qwen3-0.6b and deepseek-moe-16b, each cut to 2
              layers, f32: the loss and gradients of ``make_loss_fn`` with
              attn_impl="flash" (the kernel under ``FlashAttentionFn``)
              against "torch" (each leaf within 1e-4 of its largest), then
              one ``make_train_step`` step each at lr 4e-5 (loss, aux and
              grad norm within 1e-5, params within rtol 1e-3 + atol 1e-4);
              the flash kernel launched once an attention layer a pass.
4d. families — after phase 6, one model at a time: qwen2-vl-72b at full
              width, 2 layers in f32, then 16 layers in bf16 (weights made
              once, kept for 5h); whisper-base whole in f32 and bf16; one
              full-width jamba-1.5-large period (8 layers, 7 Mamba and 1
              attention, MoE every second) holding 4 of its 16 experts in
              f32 (a 4-way expert split's share) and 8 in bf16 (a 2-way
              split's; the period with all 16 is 85.6 GB, more than the
              card).  Prompts through the engine's prefill step: 2 x
              (64 stub patch embeddings at an 8 x 8 M-RoPE grid, t = 0,
              then 192 text tokens), 2 x (1500 stub frames through the
              encoder, 4 tokens), 2 x 256 tokens; 4 decode steps; phase
              4c's rules, and the flash, decode and SSD kernels launched
              once a layer (whisper: the encoder's 6 and the
              cross-attention's 6 a prefill, 6 a step) on the cuda route.
5. serve    — the dense main path: full qwen3-0.6b (28 layers, bf16, seeded
              random weights) behind ``ContinuousBatcher`` in dense mode, 16
              requests after a short warm-up; every request completes and
              the launch counters show that every prefill and decode step
              went through the kernels.
5b. paged   — the paged main path: the same model behind a paged batcher
              with the prefix cache (128 pages of 16, below the 168 of dense
              capacity), 16 requests sharing a 192-token system prompt;
              every request completes, prefixes hit, every admission went
              through the flash or the prefix kernel and every decode step
              through the paged kernel, and the page ledger balances.
5c. spec    — the speculative path: phase 5b's batcher with speculative
              decode (windows of 4) and overlap, 16 requests whose tails
              repeat a phrase; every request completes, every verify window
              went through the verify kernel, the device-counted accepted
              drafts equal the host's, admission overlapped decode, the
              ledger balances.  Token identity with a non-speculative run
              of the same requests is reported (bf16 sums differ in order),
              with both runs' tokens/s and the batcher's host time per
              verify window and per decode step.
              A dense leg of 4 requests shows no verify kernel on rings.
5d. mamba2  — the Mamba-2 path: full mamba2-370m (48 layers, bf16, seeded
              random weights) behind ``ContinuousBatcher`` in dense mode,
              16 prompts of 300-1024 tokens left-padded to 1024; every
              request completes, every admission scanned through the SSD
              kernel's bf16 passes (48 calls each, five kernels a call),
              no attention kernel ran, one
              dispatch and one host sync per admission and per chunk.
5e. tenancy — two qwen3-0.6b tenants on one card through the hypervisor
              (``VirtualAcceleratorPool`` of 16 logical cores over cuda:0
              with 256 kv pages, ``make_serving_hypervisor(policy=
              "priority")``): the static stage warms the tenant program
              ``matmul(rmsnorm(x, s), w)`` (x (2048, 1024), w (1024, 3072),
              bf16) for lease sizes 12 and 16; alice (12 cores, the
              program) and bob (4 cores) each serve 16 requests on a paged
              batcher; bob drains and departs, and alice's regrow to 16
              cores lands between two of her chunks and migrates her live
              state.  Every request completes, alice's tokens equal an
              uninterrupted run's, the regrow hits the program cache, every
              kv lease change reaches ``set_page_limit`` and no batcher
              outgrows its lease, the pool's isolation and bandwidth
              invariants hold, rmsnorm and matmul launch in the static
              stage and after the regrow (the rmsnorm on its register
              route, the matmul on its wgmma route),
              and the program's output agrees
              with its plain version.  Prints the static stage's seconds
              per lease size beside the regrow's ``t_context``.
5f. guards  — phase 5b's batcher and requests with ``audit=True,
              watchdog_s=5.0``: after two clean rounds (one host sync per
              admission and per chunk), an out-of-range id in a live
              slot's page table, then a live slot mapping another live
              slot's private page, then a synthetic 6 s stall blamed on a
              third live slot, one round apart.  Every request completes
              its ``max_new`` tokens; the audit repairs at least 3
              entries, quarantines exactly the stolen page (in no table
              row, not on the free stack), the watchdog trips once, mapped,
              free, shared and quarantined pages partition the pool and the
              ledger checks; every admission went through the flash or the
              prefix kernel and every decode step through the paged decode
              kernel.  Token identity with phase 5b for the requests never
              requeued is reported, not gated.
5g. moe     — full deepseek-moe-16b, its weights made once for three legs:
              phase 5's dense batcher and 16 requests, phase 5b's paged
              batcher and requests (prefix cache), and 4 of phase 5c's
              requests with speculation and overlap (2 arriving after the
              first round, so their admission runs behind a chunk).  Every
              request completes its ``max_new``; one dispatch (plus page
              pushes) and one host sync per admission and per chunk; each
              leg's kernels launched 28 x their calls and no other
              attention kernel; the page ledger balances; ``init_params`` peaks
              below 1.1 x the weights and each leg below weights + its
              cache + 10 % of the weights (all three printed).  Reports
              tokens/s and the wall ms of a dense decode step beside the
              floor to read the routed experts once.
5h. vlm     — qwen2-vl-72b, 16 layers (33.07 GB bf16): ``generate`` of
              8 prompts of 64 stub patches + 192 tokens, ``n_new`` 64:
              one chunk step a chunk bucket, no host sync inside the call
              (``torch.cuda.set_sync_debug_mode``), flash 16 a prefill,
              decode 16 a step, peak <= weights + cache + 10 % of the
              weights; tokens/s and the wall and device ms of a decode
              step beside the floor of reading the decoder's weights and
              caches once.
5i. audio   — whisper-base, uncut: ``generate`` of 8 x 1500 stub frames
              and 4-token prompts, ``n_new`` 128, ``max_len`` 448 (its
              decoder's context): one
              encoder pass a call (6 non-causal flash launches), the
              cross K/V made once a decoder layer a call, 6 cross-attention
              flash launches and 6 decode launches a step; one chunk step
              a bucket and no host sync inside the call, as in 5h; peak
              memory within the weights, the larger of the caches (with
              the encoder's output and one layer's cross K/V beside them)
              and the encoder pass's own peak (measured alone), and 10 %
              of the weights.
5j. hybrid  — phase 4d's bf16 jamba period (8 experts held) behind the
              dense, paged (pages of 8), overlap and audited paged
              batchers, 16 requests each: completions, one dispatch and
              sync per admission and per chunk, 7 SSD calls and 1 flash
              launch an admission, 1 decode launch a step, overlap rounds,
              a clean audit, the page ledger, peak memory within the
              weights, the cache and 10 % of the weights.
5k. tp      — tensor-parallel serving over logical cores of cuda:0 (a
              pool of 16).  f32 leg: full-width qwen3-0.6b cut to 2 layers
              (TF32 off), 8 of the requests of phases 5, 5b and 5c (each
              leg of the phase takes 8, for the whole script's time)
              through their dense, paged + prefix and speculative +
              overlap batchers at
              ``tp`` 1, 2 and 4: tokens, admissions, chunks, dispatches and
              syncs identical to tp=1; a tenant leased 1 core through
              ``ServingExecutor`` and resized 1 -> 2 -> 4 -> 1 between
              chunks (``register_remesh`` -> ``remesh``) gives an
              uninterrupted run's tokens.  bf16 leg: phase 5's uncut
              weights behind the dense and paged + prefix batchers at each
              width: completions, one dispatch (plus page pushes) and one
              sync per admission and chunk as at tp=1, ``28 x tp`` kernel
              launches per admission (flash or prefix) and per decode step,
              no plain attention route, peak memory above the weights
              within tp=1's + the shards' own bytes + 10 % of the weights;
              reports token agreement with tp=1, tokens/s, wall ms a chunk
              and each resize's ``t_remesh``, and the host cost of the
              shards' turns (µs a shard a sum, no device work).
5l. train   — after phase 6's serving traces: qwen3-0.6b uncut, bf16
              params, f32 moments, attn_impl="flash", lr 1e-3, on step 0's
              ``data.make_batch(seq_len=512, batch=8, seed=0)``: (a) 10
              steps, the loss finite and falling; (b) grad_accum=2 against
              (a)'s first step; (c) remat="full": the same first loss, a
              lower peak; (d) quantize_opt=True: the peak lower by at least
              half the moments' (8 - 2.03) B a parameter; (e) 5 steps, an
              ``AsyncCheckpointer`` save, a restore into fresh tensors bit
              for bit and the next step's loss against (a)'s sixth.  Prints
              tokens/s, ms a step, peak memory beside params + grads +
              moments, and the flash launches (28 a step a microbatch, 56
              under full remat); then a window of 3 steps untraced and
              under ``torch.profiler`` (device and host activity): busy
              time, idle share, device time split into the flash forward,
              the flash backward in torch (the ``flash.backward`` range of
              ``FlashAttentionFn.backward``), cuBLAS and the rest.
5m. cells   — last, after phases 4d-5j: (a) the dry-run
              (``repro_torch.launch.dryrun.run_cell``) of one cell a
              family (``SWEEP_CELLS``: every kind among them) at full width
              on meta tensors over pod16x16 and pod2x16x16, a line a cell;
              gates: every cell traces, 0 < useful_flops_ratio < 1.25, the
              skips are the 7 full-attention archs at long_500k.  (b) three
              full-width qwen3-0.6b cells on cuda:0 (``CARD_CELLS``: the
              reference's shapes with seq_len kept and batch cut):
              prefill_32k (batch 1, "cuda"), decode_32k (batch 8, "cuda",
              a seeded 32,768-slot cache, every slot valid), train_4k
              (batch 2, "flash", remat full).  Each: the analyzer's FLOPs
              and bytes of the same program on the same route
              (``Cell.analyze``), the median ms of 3 calls after 2
              warm-ups (CUDA events), t_compute, t_memory, bound and
              t_bound at chips = 1, t_bound / ms, MFU, the cell's own peak
              memory (its argument bytes + what its calls add above all
              allocated before them) beside the analyzer's peak live, the
              attention kernel's launches a call (28, 28, 56) and its time
              alone at the cell's shape beside its bound.  Gates: flash at
              1 x 32,768 on the last 512 query rows against its plain
              version (BF16_TOL); the decode kernel on layer 0 of the
              cell's cache against its plain version in f32 (BF16_TOL of
              the largest output); the decode step in f32 (the same
              seeds), the kernel's route against "torch" (MODEL_TOL and
              every token); the bf16 step's two routes against "torch" in
              f32 on the bf16 cell's inputs, the kernel's within
              MOE_SPREAD x the plain route's distance (at least
              BF16_TOL); one f32 train step at 2 x 4,096, flash against
              torch, loss and grad norm within 1e-5.  A ``cells`` JSON
              log line holds the rows.
5n. spmd    — after 5m: runtime SPMD (``distributed.spmd``) over gloo
              ranks of one process group that share the card (NCCL refuses
              two ranks on one card), spawned by
              ``launch.spmd.run_ranks`` after phase 2 built the kernels
              (ranks only load the library), full-width qwen3-0.6b, each
              leg against the single process's ``make_prefill_step`` and
              ``make_serve_step`` on the same weights (bf16 from the seed,
              and the same values in f32): (a) (data 2, model 3), 6 ranks,
              ``param_shardings(fsdp=False)``: 8 kv heads do not divide 3,
              so the cache's 3,072 slots are split 1,024 a rank, the
              vocab (152,064) and the MLP are split over "model", batch 4
              prompts of 512 tokens, 2 a data rank, 4 decode steps; f32
              every token equal and logits within MODEL_TOL, then bf16
              (the first step's logits within BF16_TOL of the largest
              logit, the share of tokens equal printed); (b) (data 1,
              model 2), 2 ranks, the head-aligned branch, the f32 gate;
              (c) on (b)'s ranks, a ("pod" 2) mesh: one pod's gradients
              (2 x 256 tokens, bf16, the flash route) through
              ``pod_psum_compressed`` equal bit for bit to
              ``pod_psum_compressed_ref`` on both pods' gradients in one
              process, then one ``compress_pods`` train step whose loss is
              the pods' mean.  Each serving leg: the flash kernel 28 times
              in each rank's prefill and the decode kernel 28 times a step
              on every rank (counts set to 0 just before); wall ms a step
              beside the single process's, host ms in collectives a step,
              bytes each rank sends a step by collective (ring wire
              bytes), each rank's reckoned memory and peak allocated.
              Phase 3 also holds the decode kernel's stats route
              (``return_stats=True``) against its plain version and the
              merge of three length shards against the whole ring
              (``check_decode_stats``), and times it.
5o. spmd families — after 5n: the policy for the other families
              (``make_policy`` for MoE, SSM, hybrid, VLM and audio) over
              gloo ranks spawned as in 5n, each leg against the single
              process's ``make_prefill_step`` and ``make_serve_step`` on
              the same weights (bf16 from the seed, Mamba-2's dt and A
              draws on every SSM layer, cast to f32 for the f32 runs;
              ``param_shardings(fsdp=False)``), 4 prompts (2 a data rank
              where data is 2) and 3 greedy steps: (a) mamba2-370m uncut
              on (data 2, model 2), 16 of 32 SSM heads a rank, its one
              group of B and C whole on every rank, f32 then bf16; (b)
              deepseek-moe-16b at full width cut to 4 layers on (1, 2),
              32 experts a rank (``moe_ep``) and then expert-TP, 8 of 16
              kv heads a rank; (c) one full-width jamba-1.5-large period
              on (1, 2), 64 SSM heads and 4 of 8 groups a rank, 4 of 8 kv
              heads, the experts over "model", holding as many of the 16
              experts as the single process and then two ranks building
              theirs fit (the reckoning is printed); (d) whisper-base
              uncut on (2, 2) at generate's shapes (4-token prompts over
              1,500 stub frames, ``max_len`` 448), the encoder and the
              cross-attention on 4 of 8 heads, f32 then bf16; (e)
              qwen2-vl-72b at full width cut to 2 layers on (1, 3): 8 kv
              heads do not divide 3, so the cache's length is split, the
              vocab and ``d_ff`` are, M-RoPE positions (64 patches and
              448 tokens).  Prompts of 512 positions and ``max_len``
              1,536 elsewhere.  Each leg's gates: f32 tokens all equal
              and logits within MODEL_TOL, bf16 as 5n holds it; every
              rank's layout (its heads or the cache's length, its SSM
              heads and groups, its experts); on every rank, counted from
              0 just before, the flash kernel once an attention layer a
              prefill (whisper: the encoder's and the cross-attention's
              too, and the cross-attention's once a layer a step), the
              decode kernel once an attention layer a step and the SSD
              kernel once an SSM layer a prefill.  Logs wall ms a step
              beside the single process's, host ms in collectives, bytes
              each rank sends a step by site, each rank's reckoned and
              peak memory, and the phase's wall seconds.
5p. spmd batcher — after 5o: ``ContinuousBatcher`` under ``make_policy``
              (``spmd_paged_phase``), full-width qwen3-0.6b: (a) (2, 2) in
              phase 5's dense, 5b's paged + prefix and 5c's spec + overlap
              configs, f32 then bf16, (b) (1, 3) dense and the paged
              batcher refused; 8 requests, ``max_new`` 4-8; f32 tokens and
              every counter the single process's, the bookkeeping equal on
              every rank after every round, launches equal.
5q. spmd train — after 5p: ``make_train_step`` under ``make_policy``
              (``spmd_train_phase``) over gloo ranks sharing the card, each
              leg against the single process's step on the same weights
              (5n's) and batch (``make_batch(seq_len=256, batch=4)``),
              ``"flash"``, ``loss_chunk`` 128, lr 3e-4: (a) full-width
              qwen3-0.6b on (data 2, model 2), ``param_shardings(fsdp=
              True)``, 2 steps f32 then 1 bf16; (b) on (1, 3), 2 steps f32
              (8 kv heads do not divide 3: attention whole on every rank);
              (c) deepseek-moe-16b cut to 2 layers (both MoE) on (1, 2),
              one step with the experts over "model", one as expert-TP.
              f32 gates: loss, aux, lr and grad norm within 1e-5 (1e-4),
              tokens equal, the first step's gradients before clipping
              within 1e-4 of each leaf's largest, the params after the
              last step within rtol 1e-3 + atol 1e-4 (the single process's
              saved to a temp file the ranks read through a memory map),
              every block equal on the ranks that hold it, each rank's
              flash launches the single process's; bf16: finite loss and
              grad norm, the loss gap printed.  Logs ms a step, host ms in
              collectives, collectives and ring bytes a step by site
              (forward, backward, after the backward) and each rank's peak
              beside its reckoning.
6. trace    — the first rounds of the dense, the paged, the spec, the
              Mamba-2 and the MoE path,
              all untraced first, then each under ``torch.profiler``: device
              busy time, idle share and device time by kernel class; the
              dense path must run the tensor-core flash kernel and the
              decode split and merge kernels, the paged path the former,
              the tensor-core prefix kernel and the paged decode split and
              merge kernels, the spec path the verify
              split (tensor-core) and merge kernels and the prefix kernel,
              the Mamba-2 path the SSD's five bf16 passes; the MoE path
              (phase 5g's dense leg, with its host ops traced) splits out
              the expert products and the dispatch ops by the profiler
              ranges of ``models/moe.py``, and a window of its pure decode
              chunks (8 requests admitted before it opens), split the same
              way, gives the device ms of a decode step.  Each window's
              batcher is built before the window opens.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --memory

runs phase 1 and only the memory probe of phase 5 (device memory of one
dense admission prefill at the main path's shape), against the
``src/repro_torch`` beside the script: a copy of the script placed in
another checkout measures that checkout.

    python3 chip_smoke.py --kernel-times

runs phase 1 and times the flash, dense decode, prefix, paged verify,
SSD scan (on views of one xBC tensor), matmul (the tenant program's
shape and a decode-shaped one), paged decode and rmsnorm (the tenant
program's (2048, 1024)) kernels, their plain versions and their
PyTorch calls at the main paths' bf16 shapes (phase 3's timings without
its correctness cases, the training rows of ``train_times`` where the
tree's flash wrapper takes ``return_lse``), against
the ``src/repro_torch`` beside the script: a copy in another checkout
whose wrappers have ``cost`` times that checkout's kernels, so two trees
compare in turns in one chip call.  Prints one JSON line
``{"kernel_times": ...}``.

    python3 chip_smoke.py --spmd-families

runs phases 1, 2 and 5o only (no result lines); ``--spmd-paged`` and
``--spmd-train`` run phases 1, 2 and 5p, or 5q, the same way.

    python3 chip_smoke.py --ssd-faults

runs phase 1 and then checks the SSD checks themselves: it builds copies of
the SSD kernel with planted faults (``SSD_FAULTS``, in the bf16 passes and
in the f32 kernel: the inter-chunk term dropped, the carried state
dropped, carried without its decay, far key tiles skipped, and in the
passes a chunk's own state not passed on) and exits non-zero unless each
fails a slow-decay case of phase 3; it also reports whether phase 4's
Mamba-2 check (f32) fails each.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core peak
F32_TOL, BF16_TOL, MODEL_TOL = 1e-4, 2e-2, 2e-3
# phase 4c at bf16: the kernels' logits may differ from each plain route by
# up to this multiple of the two plain routes' own difference (see
# check_moe_model)
MOE_SPREAD = 2.0


_T_START = time.perf_counter()


def log(msg: str) -> None:
    """One line of the script's log; a phase's first line carries the
    seconds since the script started."""
    if msg.startswith("phase "):
        msg += f" [at {time.perf_counter() - _T_START:.1f} s]"
    print(f"[chip_smoke] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def device_ms(fn, arg_sets, iters: int = 40) -> float:
    """Mean device time of ``fn(*args)`` in ms, cycling through ``arg_sets``
    (copies whose total exceeds the 50 MB L2, so each call finds its inputs
    cold, as the serving path does).  The stream is first held by a spin
    kernel so the host enqueues every launch before the first one runs: the
    events then bracket device time, not Python launch overhead."""
    import torch

    for args in arg_sets:
        fn(*args)                              # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)             # ~0.1 s of spinning
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def copies_over_l2(tensors, l2_bytes: int = 50 * 2**20):
    one = sum(t.numel() * t.element_size() for t in tensors)
    n = max(2, -(-2 * l2_bytes // max(one, 1)))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def bound_ms(n_bytes: float, flops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_bound(wrapper, *args, **kwargs):
    """``bound_ms`` of one call of a kernel's wrapper from the kernel's own
    ``cost`` (``kernels/*/ops.py``: the useful work and the bytes read and
    written once), the one source the dry-run counts from too."""
    flops, n_bytes = wrapper.cost(*args, **kwargs)
    return bound_ms(n_bytes, flops)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _rand(gen, shape, dtype):
    import torch

    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


def check_flash(gen):
    import torch

    from repro_torch.kernels.flash_attention import ops, ref

    def run_case(name, B, Sq, Sk, H, Hkv, dh, dtype, *, window=None,
                 q_offset=0, causal=True):
        q = _rand(gen, (B, Sq, H, dh), dtype)
        k = _rand(gen, (B, Sk, Hkv, dh), dtype)
        v = _rand(gen, (B, Sk, Hkv, dh), dtype)
        got = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)
        want = ref.flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, q_offset=q_offset).transpose(1, 2)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        log(f"  flash {name:<28} max_abs_err={err:.3e} (tol {tol:g})")
        check(bool(torch.isfinite(got).all()), f"flash {name}: non-finite output")
        check(err <= tol, f"flash {name}: max abs error {err} > {tol}")
        return err, (q, k, v)

    f32, bf16 = torch.float32, torch.bfloat16
    main = dict(B=8, Sq=256, Sk=256, H=16, Hkv=8, dh=128)
    err, (q, k, v) = run_case("main bf16", dtype=bf16, **main)
    run_case("main f32", dtype=f32, **main)
    # every mask case in both dtypes: bf16 takes the tensor-core kernel,
    # f32 the CUDA-core one
    for dtype, tag in ((f32, "f32"), (bf16, "bf16")):
        run_case(f"window=64 {tag}", dtype=dtype, window=64, **main)
        run_case(f"q_offset=200 {tag}", 2, 100, 300, 16, 8, 128, dtype,
                 q_offset=200)
        run_case(f"ragged Sq=Sk=77 {tag}", 3, 77, 77, 16, 8, 128, dtype)
        run_case(f"ragged+window+offset {tag}", 2, 130, 200, 16, 8, 128,
                 dtype, q_offset=70, window=50)
        run_case(f"gqa 8:1 dh=64 {tag}", 2, 96, 96, 8, 1, 64, dtype)
        run_case(f"dh=32 {tag}", 2, 100, 100, 4, 2, 32, dtype)
        # group 1 (H = Hkv = 16, deepseek-moe-16b's prefill)
        run_case(f"group 1 16:16 {tag}", dtype=dtype, **dict(main, Hkv=16))
        # the last families: qwen2-vl's prefill (64:8, group 8), whisper's
        # encoder over its 1500 frames and its cross-attention (a 4-token
        # prompt, a decode row) over them, all non-causal at 8:8, dh 64
        run_case(f"group 8 64:8 {tag}", 2, 256, 256, 64, 8, 128, dtype)
        run_case(f"non-causal 1500 8:8 dh=64 {tag}", 2, 1500, 1500, 8, 8,
                 64, dtype, causal=False)
        run_case(f"non-causal Sq=4 Sk=1500 {tag}", 8, 4, 1500, 8, 8, 64,
                 dtype, causal=False)
        run_case(f"non-causal Sq=1 Sk=1500 {tag}", 8, 1, 1500, 8, 8, 64,
                 dtype, causal=False)
    return dict(time_flash(q, k, v), max_abs_err=err)


def time_flash(q, k, v, causal: bool = True):
    """Kernel, plain and SDPA times (and the bound) at the serving path's
    prefill shape (B=8 rows of 256, bf16), from ``q, k, v`` there; with
    ``causal=False`` every query attends to every key (Sq may differ from
    Sk)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref

    sets = copies_over_l2([q, k, v])
    kernel = device_ms(
        lambda a, b, c: ops.flash_attention(a, b, c, causal=causal), sets)
    plain = device_ms(
        lambda a, b, c: ref.flash_attention_ref(
            a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
            causal=causal), sets)
    lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in s) for s in sets]
    library = device_ms(
        lambda a, b, c: F.scaled_dot_product_attention(
            a, b, c, is_causal=causal, enable_gqa=True), lib_sets)
    bms, by = kernel_bound(ops.flash_attention, q, k, v, causal=causal)
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:99",
                ms=kernel, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=library)


def _ring_pos(rng, B, C, cur, *, holes: float = 0.0):
    """pos (B, C) int32 of a ring that has seen positions 0..cur[b]: slot c
    holds the newest position p <= cur with p % C == c, or -1."""
    c = np.arange(C)[None, :]
    cur = np.asarray(cur)[:, None]
    pos = cur - ((cur - c) % C)
    pos = np.where(pos >= 0, pos, -1)
    if holes:
        pos = np.where(rng.random((B, C)) < holes, -1, pos)
    return pos.astype(np.int32)


def check_decode(gen):
    import torch

    from repro_torch.kernels.decode_attention import kernel, ops, ref

    rng = np.random.default_rng(0)

    def run_case(name, B, C, H, Hkv, dh, dtype, cur, *, window=None,
                 holes=0.0, edit=None):
        q = _rand(gen, (B, H, dh), dtype)
        k = _rand(gen, (B, C, Hkv, dh), dtype)
        v = _rand(gen, (B, C, Hkv, dh), dtype)
        pos_np = _ring_pos(rng, B, C, cur, holes=holes)
        if edit is not None:
            edit(pos_np, kernel.plan_splits(B, C, Hkv)[1])
        pos = torch.from_numpy(pos_np).cuda()
        cur_t = torch.as_tensor(np.asarray(cur, np.int32)).cuda()
        got = ops.decode_attention(q, k, v, pos, cur_t, window=window)
        want = ref.decode_attention_ref(q, k, v, pos, cur_t, window=window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        log(f"  decode {name:<27} max_abs_err={err:.3e} (tol {tol:g})")
        check(bool(torch.isfinite(got).all()), f"decode {name}: non-finite output")
        check(err <= tol, f"decode {name}: max abs error {err} > {tol}")
        return err, (q, k, v, pos, cur_t)

    def empty_split_1(pos, split_len):         # a split whose slots are masked
        pos[:, split_len:2 * split_len] = -1

    def empty_row_0(pos, split_len):           # a row with no valid slot
        pos[0] = -1

    f32, bf16 = torch.float32, torch.bfloat16
    B, C, H, Hkv, dh = 8, 322, 16, 8, 128
    cur = rng.integers(256, 320, size=B)       # prompt 256 + decode so far
    err, (q, k, v, pos, cur_t) = run_case("main bf16", B, C, H, Hkv, dh, bf16, cur)
    run_case("main f32", B, C, H, Hkv, dh, f32, cur)
    run_case("pos=-1 holes f32", B, C, H, Hkv, dh, f32, cur, holes=0.3)
    run_case("wrapped ring window=64 f32", B, 64, H, Hkv, dh, f32,
             rng.integers(100, 300, size=B), window=64)
    run_case("wrapped ring no window f32", 4, 100, H, Hkv, dh, f32,
             rng.integers(150, 400, size=4))
    run_case("gqa 16:1 dh=64 bf16", 4, 130, 16, 1, 64, bf16,
             rng.integers(0, 129, size=4), holes=0.2)
    # the split pass and the merge (kernel.plan_splits picks split_len)
    for dtype, tag in ((f32, "f32"), (bf16, "bf16")):
        run_case(f"split: C=100 ragged {tag}", 2, 100, H, Hkv, dh, dtype,
                 [99, 150])
        run_case(f"split: C=20 < one {tag}", 2, 20, H, Hkv, dh, dtype, [7, 19])
        run_case(f"split: all masked {tag}", B, C, H, Hkv, dh, dtype, cur,
                 edit=empty_split_1)
        run_case(f"split: no valid slot {tag}", 3, 70, H, Hkv, dh, dtype,
                 [100, 69, 30], edit=empty_row_0)
        run_case(f"split: window wraps {tag}", 4, 48, H, Hkv, dh, dtype,
                 [70, 90, 100, 119], window=40)
        run_case(f"split: gqa 16:1 {tag}", 4, 130, 16, 1, 64, dtype,
                 [129, 60, 200, 5])
        # group 1: one query row a kv head in the m16 tile, twice the grid
        run_case(f"group 1 16:16 {tag}", B, C, H, H, dh, dtype, cur)
        run_case(f"group 1 holes {tag}", B, C, H, H, dh, dtype, cur,
                 holes=0.3)
        # group 8: qwen2-vl-72b's 64:8 heads, its ring of 192 + 64 + 64
        run_case(f"group 8 64:8 {tag}", B, 320, 64, 8, dh, dtype,
                 rng.integers(256, 320, size=B))
    return dict(time_decode(q, k, v, pos, cur_t), max_abs_err=err)


def time_decode(q, k, v, pos, cur_t):
    """Kernel, plain and SDPA + mask times (and the bound) at the dense
    serving path's decode shape (B=8, C=322, bf16), from its inputs."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops, ref

    sets = copies_over_l2([q, k, v, pos, cur_t])
    kernel = device_ms(lambda *a: ops.decode_attention(*a), sets)
    plain = device_ms(lambda *a: ref.decode_attention_ref(*a), sets)

    def lib_args(s):
        qq, kk, vv, pp, cc = s
        mask = ((pp >= 0) & (pp <= cc[:, None]))[:, None, None, :]
        return (qq[:, :, None, :].contiguous(), kk.transpose(1, 2).contiguous(),
                vv.transpose(1, 2).contiguous(), mask)

    library = device_ms(
        lambda a, b, c, m: F.scaled_dot_product_attention(
            a, b, c, attn_mask=m, enable_gqa=True),
        [lib_args(s) for s in sets])
    # the slots this data attends to: the valid K/V rows
    bms, by = kernel_bound(ops.decode_attention, q, k, v, pos, cur_t)
    return dict(name="decode_attention", route="cuda",
                source="src/repro_torch/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention/kernel.py:76",
                ms=kernel, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=library)


def check_decode_stats(gen, card: str) -> None:
    """The decode kernel's stats route (``return_stats=True``: each row's
    running max ``m`` and denominator ``l``) against its plain version, and
    three length shards of one ring merged as phase 5n's ranks merge them
    against the kernel over the whole ring.  The shards' ``pos`` come from
    the global ring (a wrapped one: slot c holds the newest p <= cur with p
    % C == c); one shard holds no valid slot for some rows, one row none
    anywhere (the mean of V over all C slots)."""
    import torch

    from repro_torch.kernels.decode_attention import ops, ref

    rng = np.random.default_rng(1)
    B, C, H, Hkv, dh = 8, 3 * 128, 16, 8, 128
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        q = _rand(gen, (B, H, dh), dtype)
        k = _rand(gen, (B, C, Hkv, dh), dtype)
        v = _rand(gen, (B, C, Hkv, dh), dtype)
        cur_np = rng.integers(C + 10, 3 * C, size=B)     # wrapped rings
        cur_np[1] = 100                                  # shards 2, 3 empty
        pos_np = _ring_pos(rng, B, C, cur_np, holes=0.1)
        pos_np[2] = -1                                   # no valid slot
        pos = torch.from_numpy(pos_np).cuda()
        cur = torch.as_tensor(cur_np.astype(np.int32)).cuda()
        out, m, l = ops.decode_attention(q, k, v, pos, cur, return_stats=True)
        want, wm, wl = ref.decode_attention_ref(q, k, v, pos, cur,
                                                return_stats=True)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        err_m = ((m - wm).abs() / wm.abs().clamp_min(1.0)).max().item()
        err_l = ((l - wl).abs() / wl).max().item()
        log(f"  decode stats {tag}: out {err:.3e} (tol {tol:g}), m "
            f"{err_m:.3e}, l {err_l:.3e} relative (tol {F32_TOL:g})")
        check(err <= tol and err_m <= F32_TOL and err_l <= F32_TOL,
              f"decode stats {tag}: out {err}, m {err_m}, l {err_l}")
        check(bool((m[2] == -1e30).all()) and bool((l[2] == C).all()),
              f"decode stats {tag}: a row without a valid slot has m "
              f"{m[2].tolist()}, l {l[2].tolist()}")
        parts = [ops.decode_attention(q, *(t.chunk(3, dim=1)[i].contiguous()
                                           for t in (k, v, pos)), cur,
                                      return_stats=True) for i in range(3)]
        merged = ref.decode_attention_merge_ref(*zip(*parts))
        whole = ops.decode_attention(q, k, v, pos, cur)
        torch.cuda.synchronize()
        err = (merged.float() - whole.float()).abs().max().item()
        log(f"  decode 3-shard merge {tag}: max_abs_err={err:.3e} against "
            f"the whole ring (tol {tol:g})")
        check(err <= tol, f"decode 3-shard merge {tag}: {err} > {tol}")
    # the stats route's time beside the plain call at the serving shape
    B, C = 8, 322
    cur_np = rng.integers(256, 320, size=B)
    args = (_rand(gen, (B, H, dh), torch.bfloat16),
            _rand(gen, (B, C, Hkv, dh), torch.bfloat16),
            _rand(gen, (B, C, Hkv, dh), torch.bfloat16),
            torch.from_numpy(_ring_pos(rng, B, C, cur_np)).cuda(),
            torch.as_tensor(cur_np.astype(np.int32)).cuda())
    sets = copies_over_l2(list(args))
    plain_ms = device_ms(lambda *a: ops.decode_attention(*a), sets)
    stats_ms = device_ms(lambda *a: ops.decode_attention(*a, return_stats=True),
                         sets)
    plain2_ms = device_ms(lambda *a: ops.decode_attention(*a), sets)
    log(f"  decode stats route: {stats_ms:.5f} ms beside the plain route's "
        f"{plain_ms:.5f} / {plain2_ms:.5f} ms (B 8, C 322, 16:8, bf16) "
        f"[{card}]")


def group1_times(gen, rng):
    """The five attention kernels at group 1 (H = Hkv = 16, dh 128, bf16;
    deepseek-moe-16b's heads), every other dimension the main paths':
    kernel, plain and PyTorch-call times and the bound, one row each,
    named ``<kernel> group 1``."""
    import torch

    bf16 = torch.bfloat16
    B, S, H, dh, C = 8, 256, 16, 128, 322
    W, ps, maxp, P = 4, 16, 21, 168
    kp = _rand(gen, (P + 1, ps, H, dh), bf16)
    vp = _rand(gen, (P + 1, ps, H, dh), bf16)
    kp[P] = 1e4
    vp[P] = 1e4
    cur = rng.integers(256, 320, size=B)
    vcur = rng.integers(256, 322 - W + 1, size=B)
    rows = [
        time_flash(*(_rand(gen, (B, S, H, dh), bf16) for _ in range(3))),
        time_decode(_rand(gen, (B, H, dh), bf16),
                    _rand(gen, (B, C, H, dh), bf16),
                    _rand(gen, (B, C, H, dh), bf16),
                    torch.from_numpy(_ring_pos(rng, B, C, cur)).cuda(),
                    torch.as_tensor(np.asarray(cur, np.int32)).cuda()),
        time_paged_decode(
            _rand(gen, (B, H, dh), bf16), kp, vp,
            torch.from_numpy(_page_table(rng, B, maxp, P, cur, ps)).cuda(),
            torch.as_tensor(np.asarray(cur, np.int32)).cuda()),
        time_prefix(*(_rand(gen, shape, bf16) for shape in (
            (B, 64, H, dh), (B, 192, H, dh), (B, 192, H, dh), (B, 64, H, dh),
            (B, 64, H, dh)))),
        time_verify(
            _rand(gen, (B, W, H, dh), bf16), kp, vp,
            torch.from_numpy(
                _verify_table(rng, B, maxp, P, vcur, W, ps)).cuda(),
            torch.as_tensor(np.asarray(vcur, np.int32)).cuda()),
    ]
    for row in rows:
        row["name"] += " group 1"
    return rows


def family_times(gen, rng):
    """The kernels at the shapes the last three families give them (bf16):
    qwen2-vl's prefill of 8 x 256 and its decode over rings of 320 at 64:8
    (group 8); whisper-base's encoder over 8 x 1500 frames and its
    cross-attention over them (a 4-token prompt, a decode row), all
    non-causal at 8:8, dh 64, and its decode over rings of 448; the SSD at
    jamba-1.5-large's SSM widths.  Kernel, plain and PyTorch-call times and
    the bound, one row each, named by the shape."""
    import torch

    bf16 = torch.bfloat16

    def qkv(B, Sq, Sk, H, Hkv, dh):
        return (_rand(gen, (B, Sq, H, dh), bf16), _rand(gen, (B, Sk, Hkv, dh), bf16),
                _rand(gen, (B, Sk, Hkv, dh), bf16))

    def decode(B, C, H, Hkv, dh, lo):
        cur = rng.integers(lo, C, size=B)
        return time_decode(
            _rand(gen, (B, H, dh), bf16), _rand(gen, (B, C, Hkv, dh), bf16),
            _rand(gen, (B, C, Hkv, dh), bf16),
            torch.from_numpy(_ring_pos(rng, B, C, cur)).cuda(),
            torch.as_tensor(np.asarray(cur, np.int32)).cuda())

    rows = [
        (time_flash(*qkv(8, 256, 256, 64, 8, 128)), "qwen2-vl prefill 64:8"),
        (decode(8, 320, 64, 8, 128, 256), "qwen2-vl decode 64:8"),
        (time_flash(*qkv(8, 1500, 1500, 8, 8, 64), causal=False),
         "whisper encoder non-causal 1500"),
        (time_flash(*qkv(8, 4, 1500, 8, 8, 64), causal=False),
         "whisper cross Sq=4 Sk=1500"),
        (time_flash(*qkv(8, 1, 1500, 8, 8, 64), causal=False),
         "whisper cross Sq=1 Sk=1500"),
        (decode(8, 448, 8, 8, 64, 4), "whisper decode 8:8 dh=64"),
        (time_ssd(_ssd_inputs(gen, *(SSD_JAMBA[k] for k in (
            "B", "S", "nh", "hd", "G", "N")), bf16, 1.0), SSD_JAMBA["chunk"]),
         "jamba hd=128 G=8"),
    ]
    for row, shape in rows:
        row["name"] += f" {shape}"
    return [row for row, _ in rows]


def train_times(gen):
    """The flash kernel at the training shape (8 x 512, 16:8, dh 128, bf16)
    with its log-sum-exp, beside the plain version (with LSE) and SDPA's
    forward; the torch backward (``_flash_bwd``) alone on the kernel's
    output and LSE; and forward + backward through ``FlashAttentionFn``,
    through autograd of ``naive_attention`` (plain) and of SDPA (a
    yardstick only).  Empty for a tree whose flash wrapper has no
    ``return_lse`` (an older tree under ``--kernel-times``)."""
    import inspect

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref

    if "return_lse" not in inspect.signature(ops.flash_attention).parameters:
        return []
    from repro_torch.models.attention import (
        _flash_bwd, flash_attention_train, naive_attention)

    bf16 = torch.bfloat16
    B, S, H, Hkv, dh = TRAIN_B, TRAIN_S, 16, 8, 128
    q = _rand(gen, (B, S, H, dh), bf16)
    k = _rand(gen, (B, S, Hkv, dh), bf16)
    v = _rand(gen, (B, S, Hkv, dh), bf16)
    sets = copies_over_l2([q, k, v])
    lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in s) for s in sets]
    # the bounds: the kernel's cost
    fwd_flops, qkvo = ops.flash_attention.cost(q, k, v)
    lse_bytes = 4 * B * S * H
    bms, by = kernel_bound(ops.flash_attention, q, k, v, return_lse=True)
    fwd = dict(
        name="flash_attention +lse, train 8 x 512",
        ms=device_ms(lambda a, b, c: ops.flash_attention(
            a, b, c, return_lse=True), sets),
        plain_ms=device_ms(lambda a, b, c: ref.flash_attention_ref(
            a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
            return_lse=True), sets),
        library_ms=device_ms(lambda a, b, c: F.scaled_dot_product_attention(
            a, b, c, is_causal=True, enable_gqa=True), lib_sets),
        bound_ms=bms, bound_by=by)

    out, lse = ops.flash_attention(q, k, v, return_lse=True)
    do = _rand(gen, (B, S, H, dh), bf16)
    bsets = copies_over_l2([q, k, v, out, lse, do])
    # backward: read q, k, v, out, dO and the LSE, write dq, dk, dv; the
    # products recompute QK^T and make dV, dP, dQ, dK: 10 dh a pair
    bwd_bytes = qkvo + 2 * B * S * H * dh + lse_bytes
    bms, by = bound_ms(bwd_bytes, 2.5 * fwd_flops)
    bwd = dict(
        name="flash backward (torch _flash_bwd), train 8 x 512",
        ms=device_ms(lambda a, b, c, o, l, d: _flash_bwd(
            a, b, c, o, l, d, causal=True, window=None, q_offset=0,
            block_k=512), bsets, iters=10),
        plain_ms=None, library_ms=None, bound_ms=bms, bound_by=by)

    def grad_sets(layout):
        return [tuple(t.clone().requires_grad_(True) for t in s[:3])
                + (s[5],) for s in (
                    [tuple(t.transpose(1, 2).contiguous() for t in s)
                     for s in bsets] if layout else bsets)]

    def fb(fn):
        def run(a, b, c, d):
            torch.autograd.grad(fn(a, b, c), (a, b, c), d)
        return run

    bms, by = bound_ms(qkvo + bwd_bytes + 2 * lse_bytes, 3.5 * fwd_flops)
    both = dict(
        name="flash forward + backward (FlashAttentionFn), train 8 x 512",
        ms=device_ms(fb(lambda a, b, c: flash_attention_train(a, b, c)),
                     grad_sets(False), iters=10),
        plain_ms=device_ms(fb(lambda a, b, c: naive_attention(
            a, b, c, causal=True)), grad_sets(False), iters=10),
        library_ms=device_ms(fb(lambda a, b, c: F.scaled_dot_product_attention(
            a, b, c, is_causal=True, enable_gqa=True)), grad_sets(True),
            iters=10),
        bound_ms=bms, bound_by=by)
    for row in (fwd, bwd, both):
        row.update(route="cuda" if row is fwd else "torch",
                   source="src/repro_torch/csrc/flash_attention.cu"
                   if row is fwd else "src/repro_torch/models/attention.py",
                   replaces="src/repro/kernels/flash_attention/kernel.py:99"
                   if row is fwd else "src/repro/models/attention.py:309")
    return [fwd, bwd, both]


def _log_time_row(row, card: str) -> None:
    library = ("none" if row["library_ms"] is None
               else f"{row['library_ms'] * 1e3:.2f} us")
    extra = (f", {row['copy_ms'] * 1e3:.2f} us copy of x" if "copy_ms" in row
             else "")
    if "floor_ms" in row:
        extra += f", {row['floor_ms'] * 1e3:.2f} us one-element fill"
    plain = ("none" if row["plain_ms"] is None
             else f"{row['plain_ms'] * 1e3:.2f} us")
    log(f"  {row['name']}: {row['ms'] * 1e3:.2f} us kernel, "
        f"{plain} plain, {library} library{extra}, "
        f"bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}) [{card}]")


def kernel_times(card: str) -> int:
    """``--kernel-times``: the flash, dense decode, prefix, paged verify,
    SSD scan, matmul, paged decode and rmsnorm kernels, their plain
    versions and their PyTorch calls at the main paths' bf16 shapes (the
    matmul also decode-shaped), timed against the ``src/repro_torch``
    beside this script, without the correctness cases: a copy of the
    script placed in another checkout (e.g. the parent commit unpacked
    with ``git archive``) times that checkout's kernels, so two trees
    compare in turns within one chip call.  It calls the ``ops`` and
    ``ref`` functions and the wrappers' ``cost``, so the other tree's
    wrappers must have ``cost`` too."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    bf16 = torch.bfloat16
    B, S, H, Hkv, dh, C = 8, 256, 16, 8, 128, 322
    flash = time_flash(_rand(gen, (B, S, H, dh), bf16),
                       _rand(gen, (B, S, Hkv, dh), bf16),
                       _rand(gen, (B, S, Hkv, dh), bf16))
    cur = rng.integers(256, 320, size=B)
    decode = time_decode(
        _rand(gen, (B, H, dh), bf16), _rand(gen, (B, C, Hkv, dh), bf16),
        _rand(gen, (B, C, Hkv, dh), bf16),
        torch.from_numpy(_ring_pos(rng, B, C, cur)).cuda(),
        torch.as_tensor(np.asarray(cur, np.int32)).cuda())
    Sq, Lp = 64, 192                           # a cached admission
    prefix = time_prefix(*(_rand(gen, shape, bf16) for shape in (
        (B, Sq, H, dh), (B, Lp, Hkv, dh), (B, Lp, Hkv, dh), (B, Sq, Hkv, dh),
        (B, Sq, Hkv, dh))))
    W, ps, maxp, P = 4, 16, 21, 168            # a verify window
    kp = _rand(gen, (P + 1, ps, Hkv, dh), bf16)
    vp = _rand(gen, (P + 1, ps, Hkv, dh), bf16)
    kp[P] = 1e4
    vp[P] = 1e4
    cur = rng.integers(256, 322 - W + 1, size=B)
    verify = time_verify(
        _rand(gen, (B, W, H, dh), bf16), kp, vp,
        torch.from_numpy(_verify_table(rng, B, maxp, P, cur, W, ps)).cuda(),
        torch.as_tensor(np.asarray(cur, np.int32)).cuda())
    ssd = time_ssd(_ssd_inputs(gen, *(SSD_MAIN[k] for k in (
        "B", "S", "nh", "hd", "G", "N")), bf16, 1.0, xbc=True),
        SSD_MAIN["chunk"])
    mm = time_matmul(_rand(gen, (2048, 1024), bf16),
                     _rand(gen, (1024, 3072), bf16))
    mm_decode = time_matmul(_rand(gen, (8, 1024), bf16),
                            _rand(gen, (1024, 3072), bf16))
    mm_decode["name"] = "matmul (8, 1024) @ (1024, 3072)"
    cur = rng.integers(256, 322, size=B)       # a paged decode step
    paged = time_paged_decode(
        _rand(gen, (B, H, dh), bf16), kp, vp,
        torch.from_numpy(_page_table(rng, B, maxp, P, cur, ps)).cuda(),
        torch.as_tensor(np.asarray(cur, np.int32)).cuda())
    rms = time_rmsnorm(_rand(gen, (2048, 1024), bf16),
                       _rand(gen, (1024,), bf16))
    rows = [flash, decode, prefix, verify, ssd, mm, mm_decode, paged, rms]
    rows += group1_times(gen, rng)
    rows += train_times(gen)
    for row in rows:
        _log_time_row(row, card)
    print(json.dumps({"kernel_times": {"root": str(ROOT), "card": card,
                                       "rows": rows}}), flush=True)
    return 0


def _err(got, want) -> float:
    """Max abs error, relative where |want| > 1 (the poisoned trash page
    of the paged checks averages to 1e4, where f32 keeps ~1e-3 abs)."""
    return ((got.float() - want.float()).abs()
            / want.float().abs().clamp(min=1.0)).max().item()


def _page_table(rng, B, max_pages, n_pages, cur, ps, *, holes=0.0):
    """A shuffled (B, max_pages) int32 table: slot b maps logical pages
    0..cur[b] // ps to distinct random pool pages, later pages unmapped
    (-1); ``holes`` unmaps earlier pages at random, never the page that
    holds cur[b]."""
    perm = rng.permutation(n_pages)
    table = np.full((B, max_pages), -1, np.int32)
    for b in range(B):
        last = int(cur[b]) // ps
        ids = perm[b * max_pages:b * max_pages + last + 1]
        table[b, :last + 1] = ids
        if holes:
            drop = rng.random(last) < holes
            table[b, :last][drop] = -1
    return table


def check_paged_decode(gen):
    import torch

    from repro_torch.kernels.paged_attention import kernel, ops, ref

    rng = np.random.default_rng(2)

    def pools(P, ps, Hkv, dh, dtype):
        kp = _rand(gen, (P + 1, ps, Hkv, dh), dtype)
        vp = _rand(gen, (P + 1, ps, Hkv, dh), dtype)
        kp[P] = 1e4                    # poisoned trash page: leaks are loud
        vp[P] = 1e4
        return kp, vp

    def run_case(name, B, H, Hkv, dh, ps, max_pages, P, dtype, cur, *,
                 holes=0.0, table=None):
        q = _rand(gen, (B, H, dh), dtype)
        kp, vp = pools(P, ps, Hkv, dh, dtype)
        if table is None:
            table = _page_table(rng, B, max_pages, P, cur, ps, holes=holes)
        tab = torch.from_numpy(table).cuda()
        cur_t = torch.as_tensor(np.asarray(cur, np.int32)).cuda()
        got = ops.paged_decode_attention(q, kp, vp, tab, cur_t)
        want = ref.paged_decode_attention_ref(q, kp, vp, tab, cur_t)
        torch.cuda.synchronize()
        err = _err(got, want)
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        log(f"  paged {name:<28} max_abs_err={err:.3e} (tol {tol:g})")
        check(bool(torch.isfinite(got).all()), f"paged {name}: non-finite output")
        check(err <= tol, f"paged {name}: max abs error {err} > {tol}")
        return err, (q, kp, vp, tab, cur_t)

    f32, bf16 = torch.float32, torch.bfloat16
    # the paged main path: 8 slots of up to 21 pages of 16 over 168 pages
    B, H, Hkv, dh, ps, maxp, P = 8, 16, 8, 128, 16, 21, 168
    cur = rng.integers(256, 322, size=B)       # prompt 256 + decode so far
    err, main = run_case("main bf16", B, H, Hkv, dh, ps, maxp, P, bf16, cur)
    run_case("main f32", B, H, Hkv, dh, ps, maxp, P, f32, cur)
    run_case("holes f32", B, H, Hkv, dh, ps, maxp, P, f32, cur, holes=0.3)
    for c in (14, 15, 16, 17, 31, 32):         # across page boundaries
        run_case(f"cur_pos={c} sweep f32", 2, H, Hkv, dh, ps, 4, 8, f32,
                 [c, c])
    unmapped = np.full((2, maxp), -1, np.int32)
    unmapped[1, :3] = [5, 9, 2]
    run_case("fully unmapped slot f32", 2, H, Hkv, dh, ps, maxp, 16, f32,
             [40, 40], table=unmapped)
    run_case("gqa 16:1 dh=64 f32", 4, 16, 1, 64, ps, maxp, 96, f32,
             rng.integers(0, 330, size=4), holes=0.2)
    run_case("gqa 16:1 dh=128 bf16", 4, 16, 1, 128, 8, 12, 64, bf16,
             rng.integers(0, 96, size=4))
    # the page split (kernel.plan_page_splits: 6 splits of 4 pages at the
    # main shape): a split whose pages are all holes, more splits than
    # mapped pages, and pages of 4 and 8 (a 32-row tile over 8 or 4 pages)
    n_split, pps = kernel.plan_page_splits(B, Hkv, maxp)
    check((n_split, pps) == (6, 4), f"paged decode split {(n_split, pps)}")
    for dtype, tag in ((f32, "f32"), (bf16, "bf16")):
        skipped = _page_table(rng, B, maxp, P, cur, ps)
        skipped[:, pps:2 * pps] = -1           # split 1 sees no key
        run_case(f"split all skipped {tag}", B, H, Hkv, dh, ps, maxp, P,
                 dtype, cur, table=skipped)
        run_case(f"splits > mapped pages {tag}", B, H, Hkv, dh, ps, maxp, P,
                 dtype, rng.integers(0, 40, size=B))
        for small in (4, 8):                   # 96 positions, 4 slots
            run_case(f"page size {small} {tag}", 4, H, Hkv, dh, small,
                     96 // small, 4 * 96 // small, dtype,
                     rng.integers(0, 96, size=4), holes=0.2)
        # group 1: twice the kv heads, so fewer and longer splits
        _, pps1 = kernel.plan_page_splits(B, H, maxp)
        skipped1 = _page_table(rng, B, maxp, P, cur, ps)
        skipped1[:, pps1:2 * pps1] = -1        # split 1 sees no key
        run_case(f"group 1 16:16 {tag}", B, H, H, dh, ps, maxp, P, dtype, cur)
        run_case(f"group 1 split all skipped {tag}", B, H, H, dh, ps, maxp, P,
                 dtype, cur, table=skipped1)
    return dict(time_paged_decode(*main), max_abs_err=err)


def time_paged_decode(q, kp, vp, tab, cur_t):
    """Kernel, plain and page gather + SDPA times (and the bound) at the
    paged serving path's decode shape (B=8, 21 pages of 16, bf16), from
    its inputs."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import ops, ref

    B, _, dh = q.shape
    P, ps, Hkv = kp.shape[0] - 1, kp.shape[1], kp.shape[2]
    maxp = tab.shape[1]
    sets = copies_over_l2([q, kp, vp, tab, cur_t])
    kernel = device_ms(lambda *a: ops.paged_decode_attention(*a), sets)
    plain = device_ms(lambda *a: ref.paged_decode_attention_ref(*a), sets)
    L = maxp * ps

    def library_call(qq, kk, vv, tt, cc):
        # a torch page gather, then SDPA with a boolean mask
        mapped = tt >= 0
        g = torch.where(mapped, tt, P).long()
        kg = kk[g].reshape(B, L, Hkv, dh).transpose(1, 2)
        vg = vv[g].reshape(B, L, Hkv, dh).transpose(1, 2)
        pos = torch.arange(L, device=qq.device)
        valid = mapped[:, pos // ps] & (pos[None, :] <= cc[:, None])
        return F.scaled_dot_product_attention(
            qq[:, :, None, :], kg, vg, attn_mask=valid[:, None, None, :],
            enable_gqa=True)

    library = device_ms(library_call, sets)
    # the (slot, key) pairs attended: the valid K/V rows
    bms, by = kernel_bound(ops.paged_decode_attention, q, kp, vp, tab, cur_t)
    return dict(name="paged_decode_attention", route="cuda",
                source="src/repro_torch/csrc/paged_decode_attention.cu",
                replaces="src/repro/kernels/paged_attention/kernel.py:91",
                ms=kernel, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=library)


def check_prefix(gen):
    import torch

    from repro_torch.kernels.prefix_attention import ops, ref

    def run_case(name, B, Sq, Lp, Sk, H, Hkv, dh, dtype, *, q_offset=0):
        q = _rand(gen, (B, Sq, H, dh), dtype)
        pk = _rand(gen, (B, Lp, Hkv, dh), dtype)
        pv = _rand(gen, (B, Lp, Hkv, dh), dtype)
        k = _rand(gen, (B, Sk, Hkv, dh), dtype)
        v = _rand(gen, (B, Sk, Hkv, dh), dtype)
        got = ops.prefix_flash_attention(q, pk, pv, k, v, q_offset=q_offset)
        want = ref.prefix_flash_attention_ref(q, pk, pv, k, v,
                                              q_offset=q_offset)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        log(f"  prefix {name:<27} max_abs_err={err:.3e} (tol {tol:g})")
        check(bool(torch.isfinite(got).all()), f"prefix {name}: non-finite output")
        check(err <= tol, f"prefix {name}: max abs error {err} > {tol}")
        return err, (q, pk, pv, k, v)

    f32, bf16 = torch.float32, torch.bfloat16
    # cached admission on the paged main path: 12 cached pages of 16 and a
    # 64-token suffix
    B, Sq, Lp, H, Hkv, dh = 8, 64, 192, 16, 8, 128
    err, main = run_case("main bf16", B, Sq, Lp, Sq, H, Hkv, dh, bf16)
    run_case("main f32", B, Sq, Lp, Sq, H, Hkv, dh, f32)
    run_case("ragged Lp=77 Sq=45 f32", 3, 45, 77, 45, H, Hkv, dh, f32)
    run_case("q_offset=30 f32", 2, 40, 100, 70, H, Hkv, dh, f32, q_offset=30)
    run_case("no prefix Lp=0 f32", 2, 50, 0, 50, H, Hkv, dh, f32)
    run_case("gqa 8:1 dh=64 bf16", 2, 96, 64, 96, 8, 1, 64, bf16)
    run_case("gqa 8:1 dh=64 ragged f32", 2, 33, 21, 33, 8, 1, 64, f32)
    # the bf16 route (tensor cores) on the f32 route's edge cases
    run_case("ragged Lp=77 Sq=45 bf16", 3, 45, 77, 45, H, Hkv, dh, bf16)
    run_case("q_offset=30 bf16", 2, 40, 100, 70, H, Hkv, dh, bf16, q_offset=30)
    run_case("no prefix Lp=0 bf16", 2, 50, 0, 50, H, Hkv, dh, bf16)
    run_case("gqa 8:1 dh=64 ragged bf16", 2, 33, 21, 33, 8, 1, 64, bf16)
    run_case("dh=32 Lp=130 q_offset=7 bf16", 2, 70, 130, 77, 4, 2, 32, bf16,
             q_offset=7)
    for dtype, tag in ((f32, "f32"), (bf16, "bf16")):
        run_case(f"group 1 16:16 {tag}", B, Sq, Lp, Sq, H, H, dh, dtype)
        run_case(f"group 1 ragged q_offset=30 {tag}", 2, 40, 100, 70, H, H, dh,
                 dtype, q_offset=30)
    return dict(time_prefix(*main), max_abs_err=err)


def time_prefix(q, pk, pv, k, v):
    """Kernel, plain and SDPA times (and the bound) at the paged path's
    cached-admission shape (B=8, 64 suffix rows over Lp=192, bf16), from its
    inputs; only the ``ops`` API, so a copy of this script times another
    checkout's kernel."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.prefix_attention import ops, ref

    Sq = q.shape[1]
    Lp = pk.shape[1]
    sets = copies_over_l2([q, pk, pv, k, v])
    kernel = device_ms(lambda *a: ops.prefix_flash_attention(*a), sets)
    plain = device_ms(lambda *a: ref.prefix_flash_attention_ref(*a), sets)
    rows = torch.arange(Sq, device="cuda")
    cols = torch.arange(Lp + Sq, device="cuda") - Lp
    mask = cols[None, :] <= rows[:, None]

    def lib_args(s):
        q, pk, pv, k, v = s
        return (q.transpose(1, 2).contiguous(),
                torch.cat([pk, k], 1).transpose(1, 2).contiguous(),
                torch.cat([pv, v], 1).transpose(1, 2).contiguous())

    library = device_ms(
        lambda a, b, c: F.scaled_dot_product_attention(
            a, b, c, attn_mask=mask, enable_gqa=True),
        [lib_args(s) for s in sets])
    bms, by = kernel_bound(ops.prefix_flash_attention, q, pk, pv, k, v)
    return dict(name="prefix_flash_attention", route="cuda",
                source="src/repro_torch/csrc/prefix_flash_attention.cu",
                replaces="src/repro/kernels/prefix_attention/kernel.py:94",
                ms=kernel, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=library)


def _verify_table(rng, B, max_pages, n_pages, cur, W, ps, *, holes=0.0):
    """A shuffled table that maps every page a window at ``cur`` reaches
    (positions through cur + W - 1, within the table), holes as in
    :func:`_page_table`."""
    last = np.minimum(np.asarray(cur) + W - 1, max_pages * ps - 1)
    return _page_table(rng, B, max_pages, n_pages, last, ps, holes=holes)


def check_paged_verify(gen):
    import torch

    from repro_torch.kernels.paged_attention import kernel, ops, ref

    rng = np.random.default_rng(5)

    def run_case(name, B, W, H, Hkv, dh, ps, max_pages, P, dtype, cur, *,
                 holes=0.0, table=None):
        q = _rand(gen, (B, W, H, dh), dtype)
        kp = _rand(gen, (P + 1, ps, Hkv, dh), dtype)
        vp = _rand(gen, (P + 1, ps, Hkv, dh), dtype)
        kp[P] = 1e4                    # poisoned trash page: leaks are loud
        vp[P] = 1e4
        if table is None:
            table = _verify_table(rng, B, max_pages, P, cur, W, ps, holes=holes)
        tab = torch.from_numpy(table).cuda()
        cur_t = torch.as_tensor(np.asarray(cur, np.int32)).cuda()
        got = ops.paged_verify_attention(q, kp, vp, tab, cur_t)
        want = ref.paged_verify_attention_ref(q, kp, vp, tab, cur_t)
        torch.cuda.synchronize()
        err = _err(got, want)
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        log(f"  verify {name:<27} max_abs_err={err:.3e} (tol {tol:g})")
        check(bool(torch.isfinite(got).all()), f"verify {name}: non-finite output")
        check(err <= tol, f"verify {name}: max abs error {err} > {tol}")
        return err, (q, kp, vp, tab, cur_t)

    f32, bf16 = torch.float32, torch.bfloat16
    # the speculative main path: windows of 4 on 8 slots of up to 21 pages
    # of 16 over 168 pages
    B, W, H, Hkv, dh, ps, maxp, P = 8, 4, 16, 8, 128, 16, 21, 168
    cur = rng.integers(256, 322 - W + 1, size=B)
    err, main = run_case("main bf16", B, W, H, Hkv, dh, ps, maxp, P, bf16, cur)
    run_case("main f32", B, W, H, Hkv, dh, ps, maxp, P, f32, cur)
    run_case("holes f32", B, W, H, Hkv, dh, ps, maxp, P, f32, cur, holes=0.3)
    for c in (12, 13, 14, 15, 16, 29, 31):     # windows across page boundaries
        run_case(f"cur_pos={c} sweep f32", 2, W, H, Hkv, dh, ps, 4, 8, f32,
                 [c, c])
    unmapped = np.full((2, maxp), -1, np.int32)
    unmapped[1, :3] = [5, 9, 2]
    run_case("fully unmapped slot f32", 2, W, H, Hkv, dh, ps, maxp, 16, f32,
             [40, 40], table=unmapped)
    # row 0 has no key (its pages unmapped), the window's later rows do
    late = np.full((2, 4), -1, np.int32)
    late[:, 1] = [3, 6]
    run_case("row 0 without keys f32", 2, W, H, Hkv, dh, ps, 4, 8, f32,
             [14, 15], table=late)
    run_case("gqa 16:1 W=2 dh=64 f32", 4, 2, 16, 1, 64, ps, maxp, 96, f32,
             rng.integers(0, 330, size=4), holes=0.2)
    run_case("W=2 bf16", B, 2, H, Hkv, dh, ps, maxp, P, bf16, cur)
    run_case("W=8 f32", 4, 8, H, Hkv, dh, ps, maxp, 96, f32,
             rng.integers(0, 320, size=4), holes=0.2)
    run_case("dh=32 W=6 ps=4 f32", 3, 6, 4, 2, 32, 4, 12, 40, f32,
             rng.integers(0, 42, size=3), holes=0.2)
    run_case("dh=64 gqa 8:8 bf16", 3, 4, 8, 8, 64, 8, 6, 20, bf16,
             rng.integers(0, 44, size=3))
    # the bf16 route (tensor cores) on the f32 route's edge cases, and the
    # split: kernel.plan_page_splits gives the main shape 6 splits of 4
    # pages (64 positions), so these windows straddle split boundaries
    n_split, pps = kernel.plan_page_splits(B, Hkv, maxp)
    log(f"  verify main: {n_split} splits of {pps} pages")
    edges = np.asarray([62, 63, 64, 126, 127, 128, 190, 318])
    check(bool(((edges // (pps * ps)) != ((edges + W - 1) // (pps * ps)))
               .any()), "no window straddles a split boundary")
    run_case("holes bf16", B, W, H, Hkv, dh, ps, maxp, P, bf16, cur, holes=0.3)
    for c in (12, 13, 14, 15, 16, 29, 31):
        run_case(f"cur_pos={c} sweep bf16", 2, W, H, Hkv, dh, ps, 4, 8, bf16,
                 [c, c])
    run_case("fully unmapped slot bf16", 2, W, H, Hkv, dh, ps, maxp, 16, bf16,
             [40, 40], table=unmapped)
    run_case("row 0 without keys bf16", 2, W, H, Hkv, dh, ps, 4, 8, bf16,
             [14, 15], table=late)
    for dtype, tag in ((f32, "f32"), (bf16, "bf16")):
        run_case(f"split boundaries {tag}", B, W, H, Hkv, dh, ps, maxp, P,
                 dtype, edges, holes=0.2)
        # most splits' pages are unmapped or past the window: skipped
        run_case(f"splits > mapped pages {tag}", B, W, H, Hkv, dh, ps, maxp,
                 P, dtype, rng.integers(0, 40, size=B))
        run_case(f"gqa 16:1 W=2 dh=128 {tag}", 4, 2, 16, 1, 128, ps, maxp, 96,
                 dtype, rng.integers(0, 330, size=4), holes=0.2)
        run_case(f"W=8 gqa 4:1 32 rows ps=8 {tag}", 4, 8, 16, 4, dh, 8, 40,
                 160, dtype, rng.integers(0, 310, size=4), holes=0.2)
        # group 1: W = 4 rows a kv head
        run_case(f"group 1 16:16 {tag}", B, W, H, H, dh, ps, maxp, P, dtype,
                 cur)
        run_case(f"group 1 split boundaries {tag}", B, W, H, H, dh, ps, maxp,
                 P, dtype, edges, holes=0.2)
    return dict(time_verify(*main), max_abs_err=err)


def time_verify(q, kp, vp, tab, cur_t):
    """Kernel, plain and page gather + SDPA times (and the bound) at the
    speculative path's verify shape (B=8, W=4 over 21 pages of 16, bf16),
    from its inputs; only the ``ops`` API, so a copy of this script times
    another checkout's kernel."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import ops, ref

    B, W, _, dh = q.shape
    P, ps, Hkv = kp.shape[0] - 1, kp.shape[1], kp.shape[2]
    maxp = tab.shape[1]
    sets = copies_over_l2([q, kp, vp, tab, cur_t])
    kernel = device_ms(lambda *a: ops.paged_verify_attention(*a), sets)
    plain = device_ms(lambda *a: ref.paged_verify_attention_ref(*a), sets)
    L = maxp * ps
    pos = torch.arange(L, device="cuda")
    wi = torch.arange(W, device="cuda")

    def library_call(qq, kk, vv, tt, cc):
        # a torch page gather, then SDPA with the (W, L) boolean mask
        mapped = tt >= 0
        g = torch.where(mapped, tt, P).long()
        kg = kk[g].reshape(B, L, Hkv, dh).transpose(1, 2)
        vg = vv[g].reshape(B, L, Hkv, dh).transpose(1, 2)
        valid = (mapped[:, pos // ps][:, None, :]
                 & (pos[None, None, :] <= (cc[:, None] + wi[None, :])[:, :, None]))
        return F.scaled_dot_product_attention(
            qq.transpose(1, 2), kg, vg, attn_mask=valid[:, None], enable_gqa=True)

    library = device_ms(library_call, sets)
    # bytes: q, out, the K/V rows some query of the window attends (the
    # last query's valid rows, which hold every other query's), the table
    # and cur_pos
    flops, n_bytes = ops.paged_verify_attention.cost(q, kp, vp, tab, cur_t)
    bms, by = bound_ms(n_bytes, flops)
    log(f"  verify main: {n_bytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP")
    return dict(name="paged_verify_attention", route="cuda",
                source="src/repro_torch/csrc/paged_verify_attention.cu",
                replaces="src/repro/kernels/paged_attention/kernel.py:195",
                ms=kernel, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=library)


def _rel_err(got, want) -> float:
    """Max abs error relative to the plain version's largest magnitude."""
    scale = want.float().abs().max().clamp(min=1e-30)
    return ((got.float() - want.float()).abs().max() / scale).item()


# The SSD scan's cases, as (name, shape, dtype, dt).  dt is a scale of
# softplus(randn) (about 0.8 a row: the chunk's decay exp(cum_L) is e^-20
# or less, so the carried state barely reaches the next chunk) or a
# (low, high) range dt is drawn from log-uniformly; the "slow decay" ranges
# put exp(cum_L) near 0.5, as Mamba-2's slow heads have it, so that y of
# every chunk after the first depends on the carried state and on the
# far-off key tiles of its own chunk.
SSD_MAIN = dict(B=8, S=1024, nh=32, hd=64, G=1, N=128, chunk=256)
# jamba-1.5-large's SSM at full width: d_inner 16384 in 128 heads of 128,
# 8 groups of d_state 128
SSD_JAMBA = dict(B=2, S=1024, nh=128, hd=128, G=8, N=128, chunk=256)
SSD_REDUCED = dict(B=4, S=96, nh=8, hd=32, G=1, N=16, chunk=32)
SSD_SLOW = {256: (1e-4, 1e-2), 32: (1e-3, 1e-1)}    # chunk -> dt range


def _ssd_cases():
    import torch

    f32, bf16 = torch.float32, torch.bfloat16

    def shape(B, S, nh, hd, G, N, chunk):
        return dict(B=B, S=S, nh=nh, hd=hd, G=G, N=N, chunk=chunk)

    return [
        # every admission of the Mamba-2 path: 8 prompts of 1024 in 4 chunks
        ("main bf16", SSD_MAIN, bf16, 1.0),
        # the same as the SSM block hands it over: views of its conv output
        ("main bf16, xBC views", dict(SSD_MAIN, xbc=True), bf16, 1.0),
        ("main f32", SSD_MAIN, f32, 1.0),
        ("main slow decay bf16", SSD_MAIN, bf16, SSD_SLOW[256]),
        ("main slow decay f32", SSD_MAIN, f32, SSD_SLOW[256]),
        ("S=700 ragged tail f32", shape(2, 700, 8, 64, 1, 128, 256), f32, 1.0),
        ("S=100 < chunk f32", shape(2, 100, 8, 64, 1, 128, 256), f32, 1.0),
        ("single chunk S=256 bf16", shape(2, 256, 8, 64, 1, 128, 256), bf16,
         1.0),
        ("G=2 rep 4 f32", shape(2, 512, 8, 64, 2, 128, 128), f32, 1.0),
        ("large dt, exp(cum) underflows f32",
         shape(2, 512, 8, 64, 1, 128, 256), f32, 40.0),
        ("reduced hd=32 N=16 chunk=32 f32", SSD_REDUCED, f32, 1.0),
        ("reduced hd=32 N=16 chunk=32 bf16", SSD_REDUCED, bf16, 1.0),
        ("reduced slow decay f32", SSD_REDUCED, f32, SSD_SLOW[32]),
        ("reduced slow decay bf16", SSD_REDUCED, bf16, SSD_SLOW[32]),
        ("hd=32 N=128 chunk=64 f32", shape(2, 160, 4, 32, 2, 128, 64), f32,
         1.0),
        ("hd=64 N=16 chunk=48 f32", shape(2, 144, 4, 64, 1, 16, 48), f32, 1.0),
        ("jamba hd=128 G=8 bf16", SSD_JAMBA, bf16, 1.0),
        ("jamba hd=128 G=8 f32", SSD_JAMBA, f32, 1.0),
        ("jamba slow decay bf16", SSD_JAMBA, bf16, SSD_SLOW[256]),
        ("jamba slow decay f32", SSD_JAMBA, f32, SSD_SLOW[256]),
        ("hd=128 N=16 chunk=32 bf16", shape(2, 96, 8, 128, 2, 16, 32), bf16,
         SSD_SLOW[32]),
        ("hd=128 N=16 chunk=32 f32", shape(2, 96, 8, 128, 2, 16, 32), f32,
         SSD_SLOW[32]),
    ]


def _ssd_inputs(gen, B, S, nh, hd, G, N, dtype, dt, *, xbc=False):
    """x, dt, A, Bm, Cm of one case; with ``xbc``, x, Bm and Cm are views
    of one (B, S, nh hd + 2 G N) tensor, as the SSM block slices them out
    of its conv output ``xBC`` (row stride the conv width)."""
    import torch
    import torch.nn.functional as F

    x = (_rand(gen, (B, S, nh, hd), torch.float32) * 0.5).to(dtype)
    if isinstance(dt, tuple):
        lo, hi = dt
        u = torch.rand((B, S, nh), generator=gen, device="cuda")
        dts = lo * (hi / lo) ** u
    else:
        dts = F.softplus(_rand(gen, (B, S, nh), torch.float32)) * dt
    A = -torch.exp(_rand(gen, (nh,), torch.float32) * 0.5)
    Bm = (_rand(gen, (B, S, G, N), torch.float32) * 0.3).to(dtype)
    Cm = (_rand(gen, (B, S, G, N), torch.float32) * 0.3).to(dtype)
    if xbc:
        buf = torch.cat([t.reshape(B, S, -1) for t in (x, Bm, Cm)], dim=-1)
        d_in, gn = nh * hd, G * N
        x = buf[..., :d_in].view(B, S, nh, hd)
        Bm = buf[..., d_in:d_in + gn].view(B, S, G, N)
        Cm = buf[..., d_in + gn:].view(B, S, G, N)
    return x, dts, A, Bm, Cm


def _chunk_decay(dt, A, L):
    """exp(cum_L), the decay of the carried state over each whole chunk:
    its 10th, 50th and 90th percentiles."""
    import torch

    B, S, nh = dt.shape
    n = S // L * L
    total = (dt[:, :n] * A).reshape(B, -1, L, nh).sum(2)
    q = torch.tensor([0.1, 0.5, 0.9], device=dt.device)
    return torch.quantile(torch.exp(total).flatten(), q).tolist()


def _ssd_case(gen, shape, dtype, dt):
    """One case of the SSD scan (``ops.ssd``, the model-layout wrapper the
    SSM prefill calls) against ``ssd_chunked``, its plain version, on the
    same inputs: the errors of y and of the final state relative to the
    plain version's largest magnitude, and whether each is finite."""
    import torch

    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.models.ssm import ssd_chunked

    chunk = shape["chunk"]
    args = _ssd_inputs(gen, *(shape[k] for k in ("B", "S", "nh", "hd", "G",
                                                 "N")), dtype, dt,
                       xbc=shape.get("xbc", False))
    before = ops.ssd.launches
    routes = dict(ops.ssd.route_calls)
    y, st = ops.ssd(*args, chunk=chunk, return_state=True)
    routes = [k for k, n in ops.ssd.route_calls.items() if n != routes[k]]
    want_y, want_st = ssd_chunked(*args, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    return dict(
        args=args, launched=ops.ssd.launches - before, routes=routes,
        shape_ok=y.shape == args[0].shape and y.dtype == dtype,
        finite=bool(torch.isfinite(y).all() and torch.isfinite(st).all()),
        err_y=_rel_err(y, want_y), err_st=_rel_err(st, want_st),
        abs_y=(y.float() - want_y.float()).abs().max().item(),
        max_y=want_y.float().abs().max().item(),
        tol_y=BF16_TOL if dtype == torch.bfloat16 else F32_TOL,
        decay=_chunk_decay(args[1], args[2], min(chunk, shape["S"])))


def _ssd_passes(r) -> bool:
    return (r["finite"] and r["err_y"] <= r["tol_y"]
            and r["err_st"] <= F32_TOL)


def check_ssd(gen):
    """The SSD scan against its plain version over :func:`_ssd_cases`: y
    and the final state.  Errors are relative to the plain version's
    largest magnitude: 1e-4 in f32 (only the summation order differs); in
    bf16 2e-2 for y, because the plain version rounds C.B^T, the scores and
    both halves of y to bf16 where the kernel keeps f32 and rounds y once
    (a few 2^-9 roundings of terms near |y|), and 1e-4 for the state, which
    both build in f32 from the same bf16 inputs.  The slow-decay cases must
    keep the chunk's median decay within [0.1, 0.9], or they would no
    longer test the carry.  bf16 cases take the kernel's five passes, f32
    ones its f32 kernel (``kernel.ssd_route``), as the route counters
    show; the main shape is timed on views of one ``xBC`` tensor, as the
    SSM block passes them."""
    import torch

    from repro_torch.kernels.ssd_scan import ssd_route

    for name, shape, dtype, dt in _ssd_cases():
        r = _ssd_case(gen, shape, dtype, dt)
        want = ssd_route(dtype)
        log(f"  ssd {name:<34} route {'+'.join(r['routes'])}; "
            f"y rel err={r['err_y']:.3e} (tol "
            f"{r['tol_y']:g}, abs {r['abs_y']:.3e} of max {r['max_y']:.3g}) "
            f"state rel err={r['err_st']:.3e} (tol {F32_TOL:g}); chunk decay "
            f"p10/p50/p90 {r['decay'][0]:.2g}/{r['decay'][1]:.2g}/"
            f"{r['decay'][2]:.2g}")
        check(r["launched"] == 1, f"ssd {name}: no kernel launch")
        check(r["routes"] == [want], f"ssd {name}: route {r['routes']}, "
              f"expected {want}")
        check(r["shape_ok"], f"ssd {name}: wrong shape or dtype of y")
        check(r["finite"], f"ssd {name}: non-finite output")
        check(r["err_y"] <= r["tol_y"],
              f"ssd {name}: y error {r['err_y']} > {r['tol_y']}")
        check(r["err_st"] <= F32_TOL,
              f"ssd {name}: state error {r['err_st']} > {F32_TOL}")
        if isinstance(dt, tuple):
            check(0.1 <= r["decay"][1] <= 0.9,
                  f"ssd {name}: median chunk decay {r['decay'][1]} outside "
                  f"[0.1, 0.9]")
        if name == "main bf16, xBC views":
            err, args = r["abs_y"], r["args"]
        del r
    torch.cuda.empty_cache()
    return dict(time_ssd(args, SSD_MAIN["chunk"]), max_abs_err=err)


def time_ssd(args, chunk):
    """Kernel and plain times (and the bound) of one ``ops.ssd`` call (a
    bf16 call launches five kernels) at the Mamba-2 path's admission shape
    (B=8, S=1024 in chunks of 256, nh=32, hd=64, G=1, N=128, bf16), from
    ``args`` there; no PyTorch call computes the scan."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.models.ssm import ssd_chunked

    x, _, _, Bm, _ = args
    B, S, nh, hd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = min(chunk, S)
    sets = copies_over_l2(list(args))
    kernel = device_ms(lambda *a: ops.ssd(*a, chunk=L, return_state=True),
                       sets)
    plain = device_ms(lambda *a: ssd_chunked(*a, chunk=L, return_state=True),
                      sets)
    # bytes: x, dt, A, B, C read once, y and the f32 final state written
    # once; operations: the causal (row, col) pairs of each chunk
    flops, n_bytes = ops.ssd.cost(*args, chunk=L)
    bms, by = bound_ms(n_bytes, flops)
    log(f"  ssd B={B} S={S} nh={nh} hd={hd} G={G} N={N}: "
        f"{n_bytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP")
    return dict(name="ssd_scan", route="cuda",
                source="src/repro_torch/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan/kernel.py:85",
                ms=kernel, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=None)


def check_rmsnorm(gen):
    """RMSNorm against its plain version at the qwen3-0.6b shapes (an
    admission's 2048 rows of d_model 1024, a decode step's 8, the q/k norm's
    32768 rows of d_head 128), at d = 4096, 5120 and 12288 (block-wide
    rows), and at d = 130 (scalar head and tail around the vectors) and on
    a row view one element off the 16-byte boundary, each case's route
    (``kernel.rmsnorm_route``) logged and checked: rows in registers
    wherever rows start on 16-byte boundaries and span a multiple of 16
    bytes, two passes elsewhere.  The error is ``_err``: absolute where the
    plain output is below 1, relative above, within ``F32_TOL`` /
    ``BF16_TOL``: both round the same f32 value to bf16 once, but their
    sums of squares differ in order, which can move an output across a
    rounding boundary, one bf16 step (2^-8 of its magnitude; outputs reach
    ~15 with a random scale)."""
    import torch

    from repro_torch.kernels.rmsnorm import ops, ref

    f32, bf16 = torch.float32, torch.bfloat16
    reg, two = "registers", "two_pass"
    # (name, shape, x dtype, scale dtype, route, one element off the boundary)
    cases = [("main (2048, 1024)", (2048, 1024), bf16, bf16, reg, False),
             ("main (2048, 1024)", (2048, 1024), f32, f32, reg, False),
             ("decode (8, 1024)", (8, 1024), bf16, bf16, reg, False),
             ("decode (8, 1024)", (8, 1024), f32, f32, reg, False),
             ("qk-norm (32768, 128)", (32768, 128), bf16, bf16, reg, False),
             ("qk-norm (32768, 128)", (32768, 128), f32, f32, reg, False),
             ("d=4096 (16, 4096)", (16, 4096), bf16, f32, reg, False),
             ("d=4096 (16, 4096)", (16, 4096), f32, bf16, reg, False),
             ("d=5120 (7, 5120)", (7, 5120), bf16, bf16, reg, False),
             ("d=5120 (7, 5120)", (7, 5120), f32, f32, reg, False),
             ("d=12288 (3, 12288)", (3, 12288), bf16, bf16, reg, False),
             ("d=12288 (3, 12288)", (3, 12288), f32, f32, reg, False),
             ("d=130 (33, 130)", (33, 130), bf16, bf16, two, False),
             ("d=130 (33, 130)", (33, 130), f32, f32, two, False),
             ("misaligned view (64, 256)", (64, 256), bf16, bf16, two, True),
             ("bf16 x, f32 scale (2048, 1024)", (2048, 1024), bf16, f32, reg,
              False),
             ("bf16 x, f32 scale (3, 130)", (3, 130), bf16, f32, two, False)]
    before = ops.rmsnorm.launches
    for name, shape, xdt, sdt, route, off in cases:
        if off:
            x = _rand(gen, (1 + shape[0] * shape[1],), xdt)[1:].view(shape)
        else:
            x = _rand(gen, shape, xdt)
        s = _rand(gen, (shape[-1],), sdt)
        routes = dict(ops.rmsnorm.route_launches)
        got = ops.rmsnorm(x, s)
        want = ref.rmsnorm_ref(x, s)
        torch.cuda.synchronize()
        err = _err(got, want)
        tol = BF16_TOL if xdt == bf16 else F32_TOL
        took = [k for k, n in ops.rmsnorm.route_launches.items()
                if n != routes[k]]
        log(f"  rmsnorm {name:<31} x {str(xdt)[6:]:<8} scale "
            f"{str(sdt)[6:]:<8} route {took} err={err:.3e} (tol {tol:g})")
        check(took == [route], f"rmsnorm {name}: route {took}, not {route}")
        check(got.shape == x.shape and got.dtype == x.dtype,
              f"rmsnorm {name}: wrong shape or dtype")
        check(bool(torch.isfinite(got).all()), f"rmsnorm {name}: non-finite")
        check(err <= tol, f"rmsnorm {name}: error {err} > {tol}")
        if name.startswith("main") and xdt == bf16:
            main_err, args = (got.float() - want.float()).abs().max().item(), (x, s)
    check(ops.rmsnorm.launches - before == len(cases),
          "rmsnorm: a case did not launch the kernel")
    return dict(time_rmsnorm(*args), max_abs_err=main_err)


def time_rmsnorm(x, s):
    """Kernel, plain and ``F.rms_norm`` times (and the bound) at the tenant
    program's shape ((2048, 1024), bf16), from its inputs."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import ops, ref

    d = x.shape[-1]
    sets = copies_over_l2([x, s])
    kernel = device_ms(lambda x, s: ops.rmsnorm(x, s), sets)
    plain = device_ms(lambda x, s: ref.rmsnorm_ref(x, s), sets)
    library = device_ms(lambda x, s: F.rms_norm(x, (d,), s, eps=1e-6), sets)
    # a copy of x moves the same bytes; a one-element fill moves none: the
    # least device time of any launch under this timer
    copy = device_ms(lambda x, s: x.clone(), sets)
    one = torch.zeros(1, device=x.device)
    floor = device_ms(lambda x, s: one.fill_(1.0), sets)
    bms, by = kernel_bound(ops.rmsnorm, x, s)
    return dict(name="rmsnorm", route="cuda",
                source="src/repro_torch/csrc/rmsnorm.cu",
                replaces="src/repro/kernels/rmsnorm/kernel.py:36",
                ms=kernel, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=library, copy_ms=copy, floor_ms=floor)


def check_matmul(gen):
    """The tiled matmul against its plain version (``a.float() @ b.float()``,
    TF32 off) at the qwen3-0.6b admission's MLP shapes (2048 rows, d_model
    1024, d_ff 3072, both ways), a decode step's 8 rows, and a ragged
    (100, 300) @ (300, 72); bf16 -> bf16, bf16 -> f32 and f32 -> f32.  The
    error is relative to the plain version's largest magnitude: with K =
    3072 outputs reach ~50 and bf16's rounding of them alone exceeds the
    absolute ``BF16_TOL``.  Limits: 1e-5 at f32 output (only the summation
    order differs), 8e-3 at bf16 output (one rounding, 2^-9 of an output,
    and a flip across a rounding boundary).  The route counters must show
    the bf16 2048-row and decode cases on the ``wgmma`` route, the ragged
    case (a 600-byte row of a, which TMA cannot describe) and f32 on the
    CUDA cores.  Also logs the host time of a launch on each route: the
    ``wgmma`` route encodes two TMA tensor maps a call."""
    import torch

    from repro_torch.kernels.matmul import kernel, ops, ref

    f32, bf16 = torch.float32, torch.bfloat16
    shapes = [("admission up", 2048, 1024, 3072),
              ("admission down", 2048, 3072, 1024),
              ("decode", 8, 1024, 3072),
              ("ragged", 100, 300, 72)]
    kinds = [(bf16, bf16), (bf16, f32), (f32, f32)]
    before = ops.matmul.launches
    for name, M, K, N in shapes:
        for in_dt, out_dt in kinds:
            a = _rand(gen, (M, K), in_dt)
            b = _rand(gen, (K, N), in_dt)
            routes = dict(ops.matmul.route_launches)
            got = ops.matmul(a, b, out_dtype=out_dt)
            want = ref.matmul_ref(a, b, out_dtype=out_dt)
            torch.cuda.synchronize()
            route = [k for k, n in ops.matmul.route_launches.items()
                     if n != routes[k]]
            expected = ("wgmma" if in_dt == bf16 and name != "ragged"
                        else "cuda_core")
            err = _rel_err(got, want)
            tol = 8e-3 if out_dt == bf16 else 1e-5
            log(f"  matmul {name:<14} ({M}, {K}) @ ({K}, {N}) "
                f"{str(in_dt)[6:]:>8} -> {str(out_dt)[6:]:<8} route "
                f"{'+'.join(route):<9} rel err={err:.3e} (tol {tol:g}) of "
                f"max {want.float().abs().max().item():.3g}")
            check(route == [expected],
                  f"matmul {name}: route {route}, expected {expected}")
            check(got.shape == (M, N) and got.dtype == out_dt,
                  f"matmul {name}: wrong shape or dtype")
            check(bool(torch.isfinite(got).all()), f"matmul {name}: non-finite")
            check(err <= tol, f"matmul {name}: relative error {err} > {tol}")
            if name == "admission up" and in_dt == out_dt == bf16:
                main_err = (got.float() - want.float()).abs().max().item()
                args = (a, b)
    check(ops.matmul.launches - before == len(shapes) * len(kinds),
          "matmul: a case did not launch the kernel")

    a, b = _rand(gen, (128, 64), bf16), _rand(gen, (64, 128), bf16)
    host = {}
    for route in kernel.ROUTES:
        kernel.matmul_kernel(a, b, route=route)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            kernel.matmul_kernel(a, b, route=route)
        host[route] = (time.perf_counter() - t0) / 500
        torch.cuda.synchronize()
    log(f"  matmul host time a launch, (128, 64) @ (64, 128) bf16: wgmma "
        f"{host['wgmma'] * 1e6:.1f} us (two TMA maps encoded), CUDA cores "
        f"{host['cuda_core'] * 1e6:.1f} us")
    torch.cuda.empty_cache()
    return dict(time_matmul(*args), max_abs_err=main_err)


def time_matmul(a, b):
    """Kernel, plain and ``torch.matmul`` times (and the bound) of one
    ``ops.matmul`` call on bf16 ``a``, ``b``: the tenant program's (2048,
    1024) @ (1024, 3072), or a decode-shaped 8 rows."""
    import torch

    from repro_torch.kernels.matmul import ops, ref

    sets = copies_over_l2([a, b])
    kernel = device_ms(lambda a, b: ops.matmul(a, b), sets, iters=20)
    plain = device_ms(lambda a, b: ref.matmul_ref(a, b), sets, iters=20)
    library = device_ms(lambda a, b: torch.matmul(a, b), sets, iters=20)
    flops, n_bytes = ops.matmul.cost(a, b)
    bms, by = bound_ms(n_bytes, flops)
    log(f"  matmul main: {n_bytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP; "
        f"kernel {kernel / library:.1f}x torch.matmul's time")
    return dict(name="matmul", route="cuda",
                source="src/repro_torch/csrc/matmul.cu",
                replaces="src/repro/kernels/matmul/kernel.py:50",
                ms=kernel, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=library)


# Faults planted in a copy of ssd_scan.cu, as (name, original, fault), in
# the bf16 passes and in the f32 kernel: y without the inter-chunk term, a
# state passing that drops the carried state (keeping only the last
# chunk's own), one that keeps it without its decay, query tiles that skip
# every key tile more than one below the diagonal, and (bf16) a passing
# that never adds a chunk's own state.
SSD_FAULTS = (
    ("passes: reads no carried state",
     "const float e = i < L ? exp2f(cum_s[i] * LOG2E) : 0.f;",
     "const float e = 0.f;"),
    ("passes: drops the carried state",
     "st = st * et + states[o];", "st = states[o];"),
    ("passes: carries the state undecayed",
     "st = st * et + states[o];", "st = st + states[o];"),
    ("passes: skips the far key tiles",
     "const int k_first = 0;", "const int k_first = max(0, k_last - 1);"),
    ("passes: passes no chunk state on",
     "st = st * et + states[o];", "st = st * et;"),
    ("f32: reads no carried state",
     "const float e = (i < L) ? expf(s.cum[i]) : 0.f;",
     "const float e = 0.f;"),
    ("f32: drops the carried state",
     "*e = et * *e + sacc[a][c];", "*e = sacc[a][c];"),
    ("f32: carries the state undecayed",
     "*e = et * *e + sacc[a][c];", "*e = *e + sacc[a][c];"),
    ("f32: skips the far key tiles",
     "for (int k0 = 0; k0 < k_end; k0 += TK) {",
     "for (int k0 = max(0, q0 - TK); k0 < k_end; k0 += TK) {"),
)


def _build_fault(name, original, fault, out_dir):
    """Compile csrc/ssd_scan.cu with ``original`` replaced by ``fault`` into
    its own shared library under ``out_dir``; returns the started nvcc and
    the library's path."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "ssd_scan.cu").read_text()
    check(src.count(original) == 1, f"fault {name!r}: the line to replace "
          f"is not in ssd_scan.cu once")
    tag = name.replace(":", "").replace(" ", "_")
    cu = out_dir / f"ssd_scan_{tag}.cu"
    cu.write_text(src.replace(original, fault))
    lib = out_dir / f"libssd_{tag}.so"
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, *_build.CFLAGS, "-shared",
           f"-I{_build.CSRC}", str(cu), "-o", str(lib)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def ssd_fault_check() -> int:
    """The kernel, then each fault of :data:`SSD_FAULTS` in its own build,
    run through the phase-3 SSD cases and phase 4's Mamba-2 check: the run
    fails unless the kernel passes them all and every fault fails some
    slow-decay case of phase 3.  Prints, for each fault and case, the
    errors against their tolerances, and phase 4's verdict."""
    import ctypes

    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

    out_dir = ROOT / "build" / "ssd_faults"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    builds = [(f[0], *_build_fault(*f, out_dir)) for f in SSD_FAULTS]
    libs = {"no fault": _build.load_library()}   # the kernel as it is
    for name, proc, path in builds:
        out, _ = proc.communicate()
        check(proc.returncode == 0, f"fault {name!r} did not build:\n{out}")
        lib = ctypes.CDLL(str(path))
        lib.repro_ssd_scan.argtypes = _build.SIGNATURES["repro_ssd_scan"]
        lib.repro_ssd_scan.restype = ctypes.c_int
        libs[name] = lib
    log(f"  built the kernels and {len(SSD_FAULTS)} faulty copies in "
        f"{time.perf_counter() - t0:.1f} s")
    results, all_caught = {}, True
    real = ssd_kernel.load_library
    try:
        for name, lib in libs.items():
            ssd_kernel.load_library = lambda lib=lib: lib
            gen = torch.Generator(device="cuda")
            gen.manual_seed(0)
            fails, slow_fails = [], []
            for case, shape, dtype, dt in _ssd_cases():
                r = _ssd_case(gen, shape, dtype, dt)
                ok = _ssd_passes(r)
                log(f"  fault {name!r:<29} {case:<34} y rel err="
                    f"{r['err_y']:.3e} (tol {r['tol_y']:g}) state rel err="
                    f"{r['err_st']:.3e} -> {'passes' if ok else 'FAILS'}")
                if not ok:
                    fails.append(case)
                    if isinstance(dt, tuple):
                        slow_fails.append(case)
            try:
                check_mamba_model()
                model = "passes"
            except AssertionError as e:
                model = f"FAILS ({e})"
            log(f"  fault {name!r}: phase 4 Mamba-2 check {model}")
            caught = bool(slow_fails)
            if name == "no fault":           # the kernel must pass it all
                all_caught &= not fails and model == "passes"
            else:
                all_caught &= caught
            results[name] = dict(failed_cases=fails, phase4=model,
                                 caught=caught)
    finally:
        ssd_kernel.load_library = real
    print(json.dumps({"ssd_faults": results}))
    return 0 if all_caught else 1


# ---------------------------------------------------------------------------
# phase 4: the model through the kernels against the plain path
# ---------------------------------------------------------------------------


def check_model():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.prefix_attention import ops as pfx_ops
    from repro_torch.models import (
        decode_step, init_paged_caches, init_params, prefill, prefix_prefill,
        verify_step)
    from repro_torch.models.transformer import prefill_kv

    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2,
                              dtype="float32")
    params = init_params(cfg, 0, device="cuda")
    B, S, steps = 4, 64, 4
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(
        rng.integers(1, cfg.vocab, size=(B, S)).astype(np.int32)).cuda()

    def greedy(logits):
        return torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)

    # dense: prefill + decode through the kernels against the plain path
    runs = {}
    for impl in ("cuda", "torch"):
        logits, caches = prefill(params, toks, cfg, max_len=S + steps + 1,
                                 impl=impl)
        runs[impl] = [logits, caches]
    worst = 0.0
    dense_tokens, dense_logits = [], []
    cur = torch.full((B,), S, dtype=torch.int32, device="cuda")
    for step in range(steps + 1):
        lk, lt = runs["cuda"][0], runs["torch"][0]
        err = (lk - lt).abs().max().item()
        worst = max(worst, err)
        tk, tt = greedy(lk), greedy(lt)
        check(err <= MODEL_TOL, f"model step {step}: logits differ by {err}")
        check(bool((tk == tt).all()), f"model step {step}: greedy tokens differ")
        dense_tokens.append(tt)
        dense_logits.append(lt)
        if step == steps:
            break
        for impl in ("cuda", "torch"):
            runs[impl][0], runs[impl][1] = decode_step(
                params, tt, runs[impl][1], cur, cfg, impl=impl)
        cur = cur + 1
    log(f"  dense: prefill + {steps} decode steps, 2 layers f32: max |logit "
        f"diff| {worst:.3e} (tol {MODEL_TOL:g}), greedy tokens identical")
    del runs

    # paged: the prompt's K/V packed into a shuffled pool, then the same
    # decode steps with page_table=, kernels against the plain path
    ps = 16
    max_pages = -(-(S + steps + 1) // ps)
    n_pages = B * max_pages
    table = torch.from_numpy(rng.permutation(n_pages).astype(np.int32)
                             .reshape(B, max_pages)).cuda()
    logits0, fresh, _ = prefill_kv(params, toks, cfg, impl="torch")
    prompt_pages = table[:, :S // ps].reshape(-1).long()
    runs = {}
    for impl in ("cuda", "torch"):
        caches = init_paged_caches(cfg, B, n_pages, ps, device="cuda")
        for p, view in caches.kv.items():
            k, v = fresh[p]
            view.k[:, prompt_pages] = k.reshape(k.shape[0], -1, ps, *k.shape[3:])
            view.v[:, prompt_pages] = v.reshape(v.shape[0], -1, ps, *v.shape[3:])
        runs[impl] = [logits0, caches]
    before = pa_ops.paged_decode_attention.launches
    worst = 0.0
    cur = torch.full((B,), S, dtype=torch.int32, device="cuda")
    for step in range(steps):
        for impl in ("cuda", "torch"):
            runs[impl][0], runs[impl][1] = decode_step(
                params, dense_tokens[step], runs[impl][1], cur, cfg,
                impl=impl, page_table=table)
        cur = cur + 1
        lk, lt = runs["cuda"][0], runs["torch"][0]
        err = (lk - lt).abs().max().item()
        worst = max(worst, err)
        check(err <= MODEL_TOL, f"paged step {step}: logits differ by {err}")
        check(bool((greedy(lk) == dense_tokens[step + 1]).all()),
              f"paged step {step}: greedy tokens differ from the dense run")
    check(pa_ops.paged_decode_attention.launches - before
          == cfg.n_layers * steps, "paged decode missed the kernel")
    log(f"  paged: {steps} decode steps on a shuffled pool of {n_pages} pages "
        f"of {ps}: max |logit diff| {worst:.3e} (tol {MODEL_TOL:g}), greedy "
        f"tokens identical to the dense run")
    del runs

    # verify: one window of the dense run's first `steps` tokens at S on a
    # fresh shuffled pool, through the verify kernel against the plain
    # path; row w against the dense run's logits after w + 1 decode steps
    window = torch.stack(dense_tokens[:steps], dim=1)          # (B, W)
    outs = {}
    for impl in ("cuda", "torch"):
        caches = init_paged_caches(cfg, B, n_pages, ps, device="cuda")
        for p, view in caches.kv.items():
            k, v = fresh[p]
            view.k[:, prompt_pages] = k.reshape(k.shape[0], -1, ps, *k.shape[3:])
            view.v[:, prompt_pages] = v.reshape(v.shape[0], -1, ps, *v.shape[3:])
        before = pa_ops.paged_verify_attention.launches
        outs[impl], _ = verify_step(
            params, window, caches, torch.full((B,), S, dtype=torch.int32,
                                               device="cuda"),
            cfg, impl=impl, page_table=table)
        ran = pa_ops.paged_verify_attention.launches - before
        check(ran == (cfg.n_layers if impl == "cuda" else 0),
              f"verify_step impl={impl}: {ran} verify kernel launches")
        del caches
    err = (outs["cuda"] - outs["torch"]).abs().max().item()
    check(err <= MODEL_TOL, f"verify_step: kernel and plain logits differ by {err}")
    seq = 0.0
    for w in range(steps):
        d = (outs["cuda"][:, w] - dense_logits[w + 1]).abs().max().item()
        seq = max(seq, d)
        check(d <= MODEL_TOL, f"verify row {w}: logits differ from {w + 1} "
              f"decode steps by {d}")
        check(bool((greedy(outs["cuda"][:, w]) == dense_tokens[w + 1]).all()),
              f"verify row {w}: greedy token differs from sequential decode")
    log(f"  verify: one window of {steps} on a shuffled pool, kernel against "
        f"the plain path: max |logit diff| {err:.3e}; rows against 1..{steps} "
        f"sequential decode steps: {seq:.3e} (tol {MODEL_TOL:g}), greedy "
        f"tokens identical")
    del outs

    # prefix: suffix prefill against the first 3 pages' K/V, through the
    # prefix kernel, against a cold prefill of the whole prompt
    Lp = 3 * ps
    cold, _ = prefill(params, toks, cfg, max_len=S, impl="cuda")
    _, pkv, _ = prefill_kv(params, toks[:, :Lp], cfg, impl="cuda")
    before = pfx_ops.prefix_flash_attention.launches
    warm, _ = prefix_prefill(params, toks[:, Lp:], pkv, cfg, prefix_len=Lp,
                             impl="cuda")
    check(pfx_ops.prefix_flash_attention.launches - before == cfg.n_layers,
          "prefix_prefill missed the prefix kernel")
    err = (warm - cold).abs().max().item()
    check(err <= MODEL_TOL, f"prefix_prefill: logits differ by {err}")
    check(bool((greedy(warm) == greedy(cold)).all()),
          "prefix_prefill: next token differs from the cold prefill")
    log(f"  prefix: suffix {S - Lp} rows over a cached {Lp}: max |logit diff| "
        f"{err:.3e} against a cold prefill (tol {MODEL_TOL:g}), next token "
        f"identical")
    del params


def mamba2_dt_init(params, seed: int) -> None:
    """Set each SSM layer's ``dt_bias`` and ``A_log`` in place as Mamba-2
    initialises them: dt log-uniform over [1e-3, 1e-1] (``dt_bias`` its
    inverse softplus) and A uniform over [1, 16].  The port's init, like
    the reference's, has A = -1 and dt_bias = 0, so every head forgets its
    state within a few rows and a check could not see the carried state;
    the slow heads here keep it across a chunk of 256."""
    import math

    import torch

    rng = np.random.default_rng(seed)
    for block in params["blocks"]:
        ssm = block["ssm"]
        shape = tuple(ssm["dt_bias"].shape)
        dt = np.exp(rng.uniform(math.log(1e-3), math.log(1e-1), size=shape))
        ssm["dt_bias"].copy_(torch.from_numpy(dt + np.log(-np.expm1(-dt))))
        ssm["A_log"].copy_(torch.from_numpy(np.log(rng.uniform(1, 16,
                                                               size=shape))))


def check_mamba_model():
    """Full-width mamba2-370m cut to 2 layers, f32, with Mamba-2's own dt
    and A init (:func:`mamba2_dt_init`): prefill over a ragged S = 1000
    (four chunks of 256, the last padded; a state carried wrongly shows
    from the third) and 4 decode steps with impl="cuda" (the SSD kernel)
    against impl="torch"; then decode of token S + 1 after a prefill over
    S against a prefill over S + 1."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import decode_step, init_params, prefill

    cfg = dataclasses.replace(get_config("mamba2-370m"), n_layers=2,
                              dtype="float32")
    params = init_params(cfg, 0, device="cuda")
    mamba2_dt_init(params, 1)
    B, S, steps = 4, 1000, 4
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(
        rng.integers(1, cfg.vocab, size=(B, S + 1)).astype(np.int32)).cuda()

    def greedy(logits):
        return torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)

    runs = {}
    for impl in ("cuda", "torch"):
        before = ssd_ops.ssd.launches
        runs[impl] = list(prefill(params, toks[:, :S], cfg,
                                  max_len=S + steps + 1, impl=impl))
        ran = ssd_ops.ssd.launches - before
        check(ran == (cfg.n_layers if impl == "cuda" else 0),
              f"mamba prefill impl={impl}: {ran} ssd kernel launches")
    worst = 0.0
    cur = torch.full((B,), S, dtype=torch.int32, device=toks.device)
    for step in range(steps + 1):
        lk, lt = runs["cuda"][0], runs["torch"][0]
        err = (lk - lt).abs().max().item()
        worst = max(worst, err)
        tt = greedy(lt)
        check(err <= MODEL_TOL, f"mamba step {step}: logits differ by {err}")
        check(bool((greedy(lk) == tt).all()),
              f"mamba step {step}: greedy tokens differ")
        if step == steps:
            break
        for impl in ("cuda", "torch"):
            runs[impl][0], runs[impl][1] = decode_step(
                params, tt, runs[impl][1], cur, cfg, impl=impl)
        cur = cur + 1
    log(f"  mamba2: prefill S={S} + {steps} decode steps, 2 layers f32: max "
        f"|logit diff| {worst:.3e} (tol {MODEL_TOL:g}), greedy tokens "
        f"identical")
    del runs

    full, _ = prefill(params, toks, cfg, max_len=S + 2)
    _, caches = prefill(params, toks[:, :S], cfg, max_len=S + 2)
    step_logits, _ = decode_step(params, toks[:, S], caches,
                                 torch.full((B,), S, dtype=torch.int32,
                                            device=toks.device), cfg)
    err = (step_logits - full).abs().max().item()
    check(err <= MODEL_TOL, f"mamba decode after prefill: logits differ from "
          f"a prefill over S + 1 by {err}")
    check(bool((greedy(step_logits) == greedy(full)).all()),
          "mamba decode after prefill: next token differs")
    log(f"  mamba2: decode of token {S + 1} after a prefill over {S} against "
        f"a prefill over {S + 1}: max |logit diff| {err:.3e} (tol "
        f"{MODEL_TOL:g}), next token identical")
    del params


# ---------------------------------------------------------------------------
# phase 4c: the MoE family at full width through the kernels
# ---------------------------------------------------------------------------


def _attn_counters():
    """The five attention kernels' wrappers, each with its ``launches``."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.prefix_attention import ops as pfx_ops

    return {"flash_attention": fa_ops.flash_attention,
            "prefix_flash_attention": pfx_ops.prefix_flash_attention,
            "decode_attention": da_ops.decode_attention,
            "paged_decode_attention": pa_ops.paged_decode_attention,
            "paged_verify_attention": pa_ops.paged_verify_attention}


def _free_device_memory() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def check_moe_model(card: str, arch: str, *, n_layers=None,
                    dtype: str = "bfloat16"):
    """``arch`` at full width (cut to ``n_layers`` when given) in ``dtype``,
    from the port's ``init_params``: a prefill of 2 x 256 tokens and 4
    decode steps through the kernels against the plain path
    (:func:`check_routes`).  Frees the model after."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    log(f"  {cfg.name}, {cfg.n_layers} layers, {dtype}: params "
        f"{_gib(_param_bytes(params))} made in {time.perf_counter() - t0:.1f} "
        f"s [{card}]")
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(
        rng.integers(1, cfg.vocab, size=(2, 256)).astype(np.int32)).cuda()
    check_routes(card, cfg, params, {"tokens": toks})
    del params
    _free_device_memory()


def _layer_counts(cfg):
    """(attention layers, SSM layers) of the decoder stack."""
    from repro_torch.models.transformer import n_blocks, period_structure

    specs = period_structure(cfg)
    n_attn = n_blocks(cfg) * sum(s.mixer == "attn" for s in specs)
    return n_attn, cfg.n_layers - n_attn


def check_routes(card: str, cfg, params, batch, *, steps: int = 4):
    """A prefill of ``batch`` (the engine's prefill step: tokens plus the
    family's extras, the audio encoder included) and ``steps`` decode steps
    through the kernels (impl="cuda") and the plain path (impl="torch"),
    every route fed the plain path's greedy tokens; on the cuda route only,
    the flash kernel launched once an attention layer a prefill (audio:
    also once an encoder layer and once a decoder layer for the
    cross-attention) and once a decoder layer a step for audio's
    cross-attention, the dense decode kernel once an attention layer a
    step, the SSD kernel once an SSM layer a prefill.

    f32 takes phase 4's rule: logits within ``MODEL_TOL``, greedy tokens
    identical.  bf16, the serving dtype, runs a second plain route
    (impl="naive") as well: over many layers the routes' roundings move
    some tokens' top-k experts, so even two plain routes disagree by more
    than a fixed tolerance could allow.  The kernels' logits must then lie
    as close to both plain routes as those do to each other: each
    difference, relative to the largest plain logit, within
    ``MOE_SPREAD`` x the plain routes' own (at least ``BF16_TOL``).  A
    kernel wrong at its shape moves the logits by their own size.  Greedy
    token agreement is reported."""
    import torch

    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import decode_step
    from repro_torch.serving import ServeConfig
    from repro_torch.serving.engine import make_prefill_step

    B, S = batch["tokens"].shape
    if "extra_embeds" in batch:
        S += batch["extra_embeds"].shape[1]
    n_attn, n_ssm = _layer_counts(cfg)
    L = cfg.n_layers
    audio = cfg.family == "audio"
    flash_prefill = n_attn + (cfg.n_enc_layers + L if audio else 0)
    flash_step = L if audio else 0
    counters = _attn_counters()
    fa, da = counters["flash_attention"], counters["decode_attention"]
    dtype = cfg.dtype
    impls = ("cuda", "torch") if dtype == "float32" else ("cuda", "torch",
                                                          "naive")

    def greedy(logits):
        return torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    runs = {}
    for impl in impls:
        fa.launches = ssd_ops.ssd.launches = 0
        step = make_prefill_step(cfg, ServeConfig(max_len=S + steps + 1,
                                                  attn_impl=impl))
        runs[impl] = list(step(params, batch))
        on = impl == "cuda"
        check(fa.launches == (flash_prefill if on else 0),
              f"{cfg.name} prefill impl={impl}: {fa.launches} flash launches")
        check(ssd_ops.ssd.launches == (n_ssm if on else 0),
              f"{cfg.name} prefill impl={impl}: {ssd_ops.ssd.launches} SSD "
              f"launches")
    worst, same = {}, {}
    cur = torch.full((B,), S, dtype=torch.int32,
                     device=batch["tokens"].device)
    for step in range(steps + 1):
        logits = {impl: runs[impl][0].float() for impl in impls}
        tt = greedy(logits["torch"])
        for impl in impls:
            check(bool(torch.isfinite(logits[impl]).all()),
                  f"{cfg.name} step {step} impl={impl}: non-finite logits")
            same[impl] = same.get(impl, 0) + int(
                (greedy(logits[impl]) == tt).sum())
        if dtype == "float32":
            err = (logits["cuda"] - logits["torch"]).abs().max().item()
            worst["cuda-torch"] = max(worst.get("cuda-torch", 0.0), err)
            check(err <= MODEL_TOL, f"{cfg.name} step {step}: logits differ "
                  f"by {err}")
            check(bool((greedy(logits["cuda"]) == tt).all()),
                  f"{cfg.name} step {step}: greedy tokens differ")
        else:
            d = {"cuda-torch": rel(logits["cuda"], logits["torch"]),
                 "cuda-naive": rel(logits["cuda"], logits["naive"]),
                 "naive-torch": rel(logits["naive"], logits["torch"])}
            for key, v in d.items():
                worst[key] = max(worst.get(key, 0.0), v)
            bound = MOE_SPREAD * max(d["naive-torch"], BF16_TOL)
            check(max(d["cuda-torch"], d["cuda-naive"]) <= bound,
                  f"{cfg.name} step {step}: the kernels' logits differ from "
                  f"the plain routes' by {d} (bound {bound:.3e})")
        if step == steps:
            break
        for impl in impls:
            da.launches = fa.launches = 0
            runs[impl][0], runs[impl][1] = decode_step(
                params, tt, runs[impl][1], cur, cfg, impl=impl)
            on = impl == "cuda"
            check(da.launches == (n_attn if on else 0)
                  and fa.launches == (flash_step if on else 0),
                  f"{cfg.name} decode impl={impl}: {da.launches} decode and "
                  f"{fa.launches} flash launches")
        cur = cur + 1
    n = B * (steps + 1)
    rule = (f"tol {MODEL_TOL:g} abs" if dtype == "float32" else
            f"relative to the largest plain logit, bound {MOE_SPREAD:g} x "
            f"max(naive-torch, {BF16_TOL:g})")
    log(f"  {cfg.name}: prefill {B} x {S} + {steps} decode steps, {dtype}, "
        f"{L} layers: max logit differences "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" ({rule}); greedy tokens equal to the plain path's: "
        + ", ".join(f"{k} {v}/{n}" for k, v in same.items() if k != "torch")
        + f"; launches on the cuda route: flash {flash_prefill} a prefill, "
        f"{flash_step} a step; decode {n_attn} a step; SSD {n_ssm} a prefill "
        f"[{card}]")
    del runs


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------


def _requests(cfg, n=16, seed=0, max_new=None):
    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n):
        plen = int(rng.integers(32, 257))
        budget = int(rng.integers(16, 65))
        prompt = rng.integers(1, cfg.vocab, size=plen).astype(np.int32)
        reqs.append(Request(rid=rid, prompt=prompt,
                            max_new=max_new or budget))
    return reqs


def _admitted(batcher):
    """``batcher`` after its first round (the admission of every queued
    request that fits, and one chunk), synchronised."""
    import torch

    batcher.step()
    torch.cuda.synchronize()
    return batcher


def _batcher(params, cfg, reqs):
    from repro_torch.serving import ContinuousBatcher, ServingConfig

    batcher = ContinuousBatcher(
        params, cfg, ServingConfig(slots=8, prompt_len=256, max_len=322, chunk=8))
    for r in reqs:
        batcher.submit(r)
    return batcher


def _serve(params, cfg, reqs):
    batcher = _batcher(params, cfg, reqs)
    return batcher, batcher.run()


def _gib(n_bytes: int) -> str:
    return f"{n_bytes / 2**30:.3f} GiB"


def _param_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_param_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_param_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if hasattr(tree, "numel") else 0


def admission_memory(params, cfg, card: str, B: int = 8, S: int = 256,
                     max_len: int = 322):
    """Device memory of one dense admission prefill at the main path's
    shape (``prefill`` of B prompts of S tokens into rings of ``max_len``):
    the allocator's peak above the memory allocated at its start, and what
    its result (logits and rings) holds afterwards."""
    import torch

    from repro_torch.models import prefill

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    toks = torch.randint(1, cfg.vocab, (B, S), generator=gen, device="cuda",
                         dtype=torch.int32)
    out = prefill(params, toks, cfg, max_len=max_len)   # builds, warms up
    del out
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = prefill(params, toks, cfg, max_len=max_len)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    del out
    log(f"  one dense admission prefill (B={B}, S={S}, max_len={max_len}): "
        f"peak {peak / 2**20:.1f} MiB above its start, result holds "
        f"{held / 2**20:.1f} MiB [{card}]")
    return peak, held


def serve_main_path(card: str):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import init_params

    cfg = get_config("qwen3-0.6b")
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    log(f"  allocated after init_params: {_gib(torch.cuda.memory_allocated())} "
        f"(params {_gib(_param_bytes(params))})")
    # warm-up: first-use costs (cuBLAS handles, lazily loaded GEMM kernels)
    # stay out of the measured run
    t0 = time.perf_counter()
    _serve(params, cfg, _requests(cfg, n=8, seed=1))
    torch.cuda.synchronize()
    log(f"  warm-up run (8 other requests): {time.perf_counter() - t0:.3f} s; "
        f"allocated after it: {_gib(torch.cuda.memory_allocated())}")

    admission_memory(params, cfg, card)

    reqs = _requests(cfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.flash_attention.launches = 0
    da_ops.decode_attention.launches = 0
    t0 = time.perf_counter()
    _, stats = _serve(params, cfg, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fa_n = fa_ops.flash_attention.launches
    da_n = da_ops.decode_attention.launches

    for r in reqs:
        check(r.done and not r.dropped, f"request {r.rid} did not complete")
        check(len(r.out) == r.max_new, f"request {r.rid}: {len(r.out)} tokens, "
              f"expected {r.max_new}")
        check(all(0 <= t < cfg.vocab for t in r.out),
              f"request {r.rid}: token outside the vocab")
    L = cfg.n_layers
    check(stats.prefills > 0 and stats.steps > 0, "nothing was served")
    check(fa_n == L * stats.prefills,
          f"flash_attention launches {fa_n} != {L} x {stats.prefills} prefills")
    check(da_n == L * stats.steps,
          f"decode_attention launches {da_n} != {L} x {stats.steps} steps")
    check(stats.dispatches == stats.prefills + stats.chunks,
          "dispatches != prefills + chunks")
    check(stats.host_syncs == stats.prefills + stats.chunks,
          "host syncs != one per admission + one per chunk")
    peak = torch.cuda.max_memory_allocated()
    log(f"  {stats.completed}/16 requests, {stats.tokens} tokens, "
        f"{stats.prefills} prefills, {stats.chunks} chunks, {stats.steps} "
        f"decode steps in {wall:.3f} s [{card}]")
    log(f"  tokens/s={stats.tokens / wall:.1f} dispatches_per_token="
        f"{stats.dispatches_per_token:.4f} peak_memory={_gib(peak)} "
        f"({_gib(peak - base)} above the {_gib(base)} allocated at the start, "
        f"params {_gib(_param_bytes(params))}) [{card}]")
    log(f"  launches: flash_attention={fa_n} (= {L} x {stats.prefills}), "
        f"decode_attention={da_n} (= {L} x {stats.steps})")
    return {"flash_attention": fa_n, "decode_attention": da_n}, (params, cfg)


# ---------------------------------------------------------------------------
# phase 5b: the paged main path (paged pool + shared-prefix admission)
# ---------------------------------------------------------------------------


PAGED_CONFIG = dict(slots=8, prompt_len=256, max_len=322, chunk=8, paged=True,
                    page_size=16, n_pages=128, prefix_cache=True)


def _paged_requests(cfg, n=16, seed=0, namespace="tenant0", *,
                    prompt_len=256, max_new=(16, 65)):
    """``n`` prompts of ``prompt_len`` tokens (256), one system prompt of
    three quarters of it (192 tokens) shared by all and a random tail each;
    ``max_new`` drawn from ``[16, 65)``."""
    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    system = rng.integers(1, cfg.vocab,
                          size=prompt_len * 3 // 4).astype(np.int32)
    reqs = []
    for rid in range(n):
        tail = rng.integers(1, cfg.vocab,
                            size=prompt_len - len(system)).astype(np.int32)
        reqs.append(Request(rid=rid, prompt=np.concatenate([system, tail]),
                            max_new=int(rng.integers(*max_new)),
                            namespace=namespace))
    return reqs


def _paged_batcher(params, cfg, reqs):
    from repro_torch.serving import ContinuousBatcher, ServingConfig

    batcher = ContinuousBatcher(params, cfg, ServingConfig(**PAGED_CONFIG))
    for r in reqs:
        batcher.submit(r)
    return batcher


def serve_paged_path(card: str, params, cfg):
    import torch

    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.prefix_attention import ops as pfx_ops

    t0 = time.perf_counter()
    _paged_batcher(params, cfg, _paged_requests(cfg, n=8, seed=1,
                                                namespace="warm-up")).run()
    torch.cuda.synchronize()
    log(f"  warm-up run (8 other requests): {time.perf_counter() - t0:.3f} s")

    reqs = _paged_requests(cfg)
    torch.cuda.synchronize()
    # the reset precedes the batcher, whose page pool then counts in the
    # peak above the start as phase 5's rings do
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    batcher = _paged_batcher(params, cfg, reqs)
    torch.cuda.synchronize()
    counters = (fa_ops.flash_attention, pfx_ops.prefix_flash_attention,
                pa_ops.paged_decode_attention, da_ops.decode_attention)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    stats = batcher.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fa_n, pfx_n, pa_n, da_n = (c.launches for c in counters)

    for r in reqs:
        check(r.done and not r.dropped, f"paged request {r.rid} did not complete")
        check(len(r.out) == r.max_new, f"paged request {r.rid}: {len(r.out)} "
              f"tokens, expected {r.max_new}")
        check(all(0 <= t < cfg.vocab for t in r.out),
              f"paged request {r.rid}: token outside the vocab")
    L = cfg.n_layers
    check(stats.prefills > 0 and stats.steps > 0, "nothing was served")
    check(stats.prefix_hits > 0, "no admission hit the prefix cache")
    check(pfx_n > 0, "no admission went through the prefix kernel")
    check(fa_n + pfx_n == L * stats.prefills,
          f"flash {fa_n} + prefix {pfx_n} launches != {L} x {stats.prefills} "
          f"prefills")
    check(pa_n == L * stats.steps,
          f"paged_decode_attention launches {pa_n} != {L} x {stats.steps} steps")
    check(da_n == 0, f"the dense decode kernel ran {da_n} times on the paged path")
    # a cache eviction is a dispatch (a page push) with no host sync
    check(stats.dispatches - batcher.page_pushes == stats.prefills + stats.chunks,
          "dispatches != prefills + chunks + page pushes")
    check(stats.host_syncs == stats.prefills + stats.chunks,
          "host syncs != one per admission + one per chunk")
    pool = batcher.kv_pool
    pool.check()
    free_top = int(batcher.pages.free_top)
    check(free_top + pool.shared == batcher.n_pages,
          f"free_top {free_top} + shared {pool.shared} != {batcher.n_pages} pages")
    peak = torch.cuda.max_memory_allocated()
    log(f"  {stats.completed}/16 requests, {stats.tokens} tokens, "
        f"{stats.prefills} prefills ({stats.prefix_hits} prefix hits, "
        f"{stats.prefill_tokens_skipped} prompt tokens from shared pages), "
        f"{stats.chunks} chunks, {stats.steps} decode steps, "
        f"{batcher.page_pushes} page pushes in {wall:.3f} s [{card}]")
    log(f"  tokens/s={stats.tokens / wall:.1f} dispatches_per_token="
        f"{stats.dispatches_per_token:.4f} peak_memory={_gib(peak)} "
        f"({_gib(peak - base)} above the {_gib(base)} allocated at the start) "
        f"peak_pages_in_use={stats.peak_pages_in_use}/{batcher.n_pages} "
        f"[{card}]")
    log(f"  ledger: free_top {free_top} + shared {pool.shared} = "
        f"{batcher.n_pages} pages; launches: flash_attention={fa_n} + "
        f"prefix_flash_attention={pfx_n} (= {L} x {stats.prefills}), "
        f"paged_decode_attention={pa_n} (= {L} x {stats.steps}), "
        f"decode_attention={da_n}")
    return ({"flash_attention": fa_n, "prefix_flash_attention": pfx_n,
             "paged_decode_attention": pa_n},
            {r.rid: list(r.out) for r in reqs})


# ---------------------------------------------------------------------------
# phase 5c: the speculative path (draft-and-verify windows, overlap)
# ---------------------------------------------------------------------------


SPEC_CONFIG = dict(PAGED_CONFIG, speculative=True, draft_window=4, overlap=True)


def _spec_requests(cfg, n=16, seed=0, namespace="tenant0"):
    """``n`` prompts of 256 tokens: the 192-token system prompt of
    :func:`_paged_requests`, then a 64-token tail that repeats one 16-token
    phrase of its own four times (a tenant whose answers quote their input,
    as extraction or code editing do); ``max_new`` 16-64."""
    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    system = rng.integers(1, cfg.vocab, size=192).astype(np.int32)
    reqs = []
    for rid in range(n):
        phrase = rng.integers(1, cfg.vocab, size=16).astype(np.int32)
        reqs.append(Request(rid=rid, prompt=np.concatenate([system] + [phrase] * 4),
                            max_new=int(rng.integers(16, 65)),
                            namespace=namespace))
    return reqs


def _spec_batcher(params, cfg, reqs, config=SPEC_CONFIG, telemetry=None):
    from repro_torch.serving import ContinuousBatcher, ServingConfig

    batcher = ContinuousBatcher(params, cfg, ServingConfig(**config),
                                telemetry=telemetry)
    for r in reqs:
        batcher.submit(r)
    return batcher


def _host_split(tracer, steps: int) -> str:
    """The batcher's own spans, per decode step or verify window: host time
    to enqueue the chunks (``dispatch``), host time blocked on their fetch
    (``host_sync``), and admission planning and dispatch (``admission``)."""
    tot = {"dispatch": 0.0, "host_sync": 0.0, "admission": 0.0}
    for ev in tracer.events:
        if ev["ph"] == "X" and ev["name"] in tot:
            tot[ev["name"]] += ev["dur"]
    return ", ".join(f"{k} {v / steps * 1e3:.1f} ms" for k, v in tot.items())


def serve_spec_path(card: str, params, cfg):
    import torch

    from repro_torch.obs import Telemetry, Tracer

    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.prefix_attention import ops as pfx_ops

    t0 = time.perf_counter()
    _spec_batcher(params, cfg, _spec_requests(cfg, n=8, seed=1,
                                              namespace="warm-up")).run()
    torch.cuda.synchronize()
    log(f"  warm-up run (8 other requests): {time.perf_counter() - t0:.3f} s")

    # the same requests without speculation, for the token comparison and
    # the same traffic's non-speculative tokens/s
    # both runs record the batcher's host spans (a few events a round)
    reqs, plain_reqs = _spec_requests(cfg), _spec_requests(cfg)
    plain_trace, spec_trace = Tracer(), Tracer()
    t0 = time.perf_counter()
    plain_stats = _spec_batcher(params, cfg, plain_reqs, PAGED_CONFIG,
                                Telemetry(tracer=plain_trace)).run()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    batcher = _spec_batcher(params, cfg, reqs,
                            telemetry=Telemetry(tracer=spec_trace))
    torch.cuda.synchronize()
    counters = (fa_ops.flash_attention, pfx_ops.prefix_flash_attention,
                pa_ops.paged_verify_attention, pa_ops.paged_decode_attention,
                da_ops.decode_attention)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    stats = batcher.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fa_n, pfx_n, pv_n, pa_n, da_n = (c.launches for c in counters)

    for r in reqs:
        check(r.done and not r.dropped, f"spec request {r.rid} did not complete")
        check(len(r.out) == r.max_new, f"spec request {r.rid}: {len(r.out)} "
              f"tokens, expected {r.max_new}")
        check(all(0 <= t < cfg.vocab for t in r.out),
              f"spec request {r.rid}: token outside the vocab")
    L, W = cfg.n_layers, SPEC_CONFIG["draft_window"]
    windows = stats.steps // W            # verify passes, every slot in each
    check(stats.prefills > 0 and windows > 0, "nothing was served")
    check(stats.spec_windows > 0, "no speculative window committed a token")
    check(pv_n == L * windows,
          f"paged_verify_attention launches {pv_n} != {L} x {windows} windows")
    check(fa_n + pfx_n == L * stats.prefills,
          f"flash {fa_n} + prefix {pfx_n} launches != {L} x {stats.prefills} "
          f"prefills")
    check(pa_n == 0 and da_n == 0,
          f"decode kernels ran on the spec path (paged {pa_n}, dense {da_n})")
    check(stats.device_draft_accepted == stats.accepted_tokens,
          f"device-counted accepted drafts {stats.device_draft_accepted} != "
          f"{stats.accepted_tokens} on the host")
    check(stats.dispatches - batcher.page_pushes == stats.prefills + stats.chunks,
          "dispatches != prefills + chunks + page pushes")
    check(stats.host_syncs == stats.prefills + stats.chunks,
          "host syncs != one per admission + one per chunk")
    check(stats.overlap_rounds >= 1, "no round overlapped admission and decode")
    pool = batcher.kv_pool
    pool.check()
    free_top = int(batcher.pages.free_top)
    check(free_top + pool.shared == batcher.n_pages,
          f"free_top {free_top} + shared {pool.shared} != {batcher.n_pages} pages")
    same = sum(a.out == b.out for a, b in zip(reqs, plain_reqs))
    verify_launches = pv_n
    peak = torch.cuda.max_memory_allocated()
    log(f"  {stats.completed}/16 requests, {stats.tokens} tokens, "
        f"{stats.prefills} prefills ({stats.prefix_hits} prefix hits), "
        f"{stats.chunks} chunks of {windows} verify windows, "
        f"{stats.spec_windows} slot-windows committed, {stats.overlap_rounds} "
        f"overlap rounds, {batcher.page_pushes} page pushes in {wall:.3f} s "
        f"[{card}]")
    log(f"  tokens/s={stats.tokens / wall:.1f}, {wall / windows * 1e3:.1f} ms "
        f"a window (the same requests without speculation: "
        f"{plain_stats.tokens / plain_wall:.1f} tokens/s, {plain_stats.steps} "
        f"decode steps, {plain_wall / plain_stats.steps * 1e3:.1f} ms a step) "
        f"acceptance_rate={stats.acceptance_rate:.3f} tokens_per_window="
        f"{stats.decode_tokens / max(stats.spec_windows, 1):.3f} "
        f"dispatches_per_token={stats.dispatches_per_token:.4f} "
        f"peak_memory={_gib(peak)} ({_gib(peak - base)} above the {_gib(base)} "
        f"allocated at the start) [{card}]")
    log(f"  host time per verify window: {_host_split(spec_trace, windows)}; "
        f"per decode step without speculation: "
        f"{_host_split(plain_trace, plain_stats.steps)} [{card}]")
    log(f"  bf16 token identity with the non-speculative run (reported, not "
        f"gated): {same}/16 requests ({same / 16:.3f})")
    log(f"  ledger: free_top {free_top} + shared {pool.shared} = "
        f"{batcher.n_pages} pages; launches: flash_attention={fa_n} + "
        f"prefix_flash_attention={pfx_n} (= {L} x {stats.prefills}), "
        f"paged_verify_attention={pv_n} (= {L} x {windows}), "
        f"paged_decode_attention={pa_n}, decode_attention={da_n}")

    # dense leg: 4 requests on dense rings; no multi-query kernel there
    dense = dict(slots=8, prompt_len=256, max_len=322, chunk=8,
                 speculative=True, draft_window=4, overlap=True)
    dreqs = _spec_requests(cfg, n=4, seed=2, namespace=None)
    for c in counters:
        c.launches = 0
    dstats = _spec_batcher(params, cfg, dreqs, dense).run()
    torch.cuda.synchronize()
    for r in dreqs:
        check(r.done and len(r.out) == r.max_new,
              f"dense spec request {r.rid} did not complete its budget")
    fa_n, pfx_n, pv_n, pa_n, da_n = (c.launches for c in counters)
    check(pv_n == 0 and pa_n == 0 and da_n == 0 and pfx_n == 0,
          f"dense spec leg launched verify {pv_n}, paged {pa_n}, decode "
          f"{da_n}, prefix {pfx_n}")
    check(fa_n == L * dstats.prefills,
          f"dense spec leg: flash launches {fa_n} != {L} x {dstats.prefills}")
    log(f"  dense leg: 4 requests, {dstats.tokens} tokens, {dstats.spec_windows} "
        f"slot-windows, acceptance_rate={dstats.acceptance_rate:.3f}; "
        f"launches: flash_attention={fa_n} (= {L} x {dstats.prefills}), "
        f"paged_verify_attention={pv_n}")
    return {"paged_verify_attention": verify_launches}


# ---------------------------------------------------------------------------
# phase 5d: the Mamba-2 path (mamba2-370m, dense mode)
# ---------------------------------------------------------------------------


MAMBA_CONFIG = dict(slots=8, prompt_len=1024, max_len=1088, chunk=8)


def _mamba_requests(cfg, n=16, seed=0):
    """``n`` prompts of 300-1024 tokens (left-padded to 1024, so every
    admission scans 4 chunks of 256) with ``max_new`` 16-64."""
    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n):
        plen = int(rng.integers(300, 1025))
        max_new = int(rng.integers(16, 65))
        prompt = rng.integers(1, cfg.vocab, size=plen).astype(np.int32)
        reqs.append(Request(rid=rid, prompt=prompt, max_new=max_new))
    return reqs


def _mamba_batcher(params, cfg, reqs):
    from repro_torch.serving import ContinuousBatcher, ServingConfig

    batcher = ContinuousBatcher(params, cfg, ServingConfig(**MAMBA_CONFIG))
    for r in reqs:
        batcher.submit(r)
    return batcher


def serve_mamba_path(card: str):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.prefix_attention import ops as pfx_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import init_params

    cfg = get_config("mamba2-370m")
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    log(f"  params {_gib(_param_bytes(params))}; allocated "
        f"{_gib(torch.cuda.memory_allocated())}")
    t0 = time.perf_counter()
    _mamba_batcher(params, cfg, _mamba_requests(cfg, n=8, seed=1)).run()
    torch.cuda.synchronize()
    log(f"  warm-up run (8 other requests): {time.perf_counter() - t0:.3f} s")

    reqs = _mamba_requests(cfg)
    torch.cuda.synchronize()
    # the reset precedes the batcher, whose SSM state then counts in the
    # peak above the start
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    batcher = _mamba_batcher(params, cfg, reqs)
    torch.cuda.synchronize()
    attn = (fa_ops.flash_attention, da_ops.decode_attention,
            pa_ops.paged_decode_attention, pa_ops.paged_verify_attention,
            pfx_ops.prefix_flash_attention)
    for c in (ssd_ops.ssd,) + attn:
        c.launches = 0
    ssd_ops.ssd.route_calls.update(dict.fromkeys(ssd_ops.ssd.route_calls, 0))
    t0 = time.perf_counter()
    stats = batcher.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ssd_n = ssd_ops.ssd.launches
    attn_n = {c.__name__: c.launches for c in attn}

    for r in reqs:
        check(r.done and not r.dropped, f"mamba request {r.rid} did not complete")
        check(len(r.out) == r.max_new, f"mamba request {r.rid}: {len(r.out)} "
              f"tokens, expected {r.max_new}")
        check(all(0 <= t < cfg.vocab for t in r.out),
              f"mamba request {r.rid}: token outside the vocab")
    L = cfg.n_layers
    check(stats.prefills > 0 and stats.steps > 0, "nothing was served")
    check(ssd_n == L * stats.prefills,
          f"ssd launches {ssd_n} != {L} x {stats.prefills} admissions")
    check(ssd_ops.ssd.route_calls["passes"] == ssd_n,
          f"ssd routes {ssd_ops.ssd.route_calls}: every bf16 admission "
          f"should take the five passes")
    check(not any(attn_n.values()),
          f"attention kernels ran on the Mamba-2 path: {attn_n}")
    check(stats.dispatches == stats.prefills + stats.chunks,
          "dispatches != prefills + chunks")
    check(stats.host_syncs == stats.prefills + stats.chunks,
          "host syncs != one per admission + one per chunk")
    peak = torch.cuda.max_memory_allocated()
    log(f"  {stats.completed}/16 requests, {stats.tokens} tokens, "
        f"{stats.prefills} prefills, {stats.chunks} chunks, {stats.steps} "
        f"decode steps in {wall:.3f} s [{card}]")
    log(f"  tokens/s={stats.tokens / wall:.1f} dispatches_per_token="
        f"{stats.dispatches_per_token:.4f} peak_memory={_gib(peak)} "
        f"({_gib(peak - base)} above the {_gib(base)} allocated at the start, "
        f"params {_gib(_param_bytes(params))}, decode state "
        f"{_gib(stats.cache_bytes)}) [{card}]")
    log(f"  launches: ssd_scan={ssd_n} calls (= {L} x {stats.prefills}), "
        f"routes {ssd_ops.ssd.route_calls}, 5 kernels a call; attention "
        f"kernels {attn_n}")
    return {"ssd_scan": ssd_n}, (params, cfg)


# ---------------------------------------------------------------------------
# phase 5e: tenancy (two tenants served through the hypervisor)
# ---------------------------------------------------------------------------


TENANT_CONFIG = {k: v for k, v in PAGED_CONFIG.items() if k != "prefix_cache"}
TENANT_KV_PAGES = 128        # leased between the two tenants' batchers
NORM_PROJ_SHAPES = dict(x=(2048, 1024), s=(1024,), w=(1024, 3072))


def norm_proj(x, s, w):
    """The tenant program the static stage compiles: an admission's MLP
    input projection, ``matmul(rmsnorm(x, s), w)``, through the kernels."""
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops

    return mm_ops.matmul(rms_ops.rmsnorm(x, s), w)


def _tenant_requests(cfg, n=16):
    """``2n`` requests from one ``default_rng(0)`` (phase 5's shapes:
    prompts of 32-256 tokens, ``max_new`` 16-64): alice's n, then bob's."""
    from repro_torch.serving import Request

    rng = np.random.default_rng(0)
    reqs = []
    for rid in range(2 * n):
        plen = int(rng.integers(32, 257))
        max_new = int(rng.integers(16, 65))
        reqs.append(Request(rid=rid, prompt=rng.integers(
            1, cfg.vocab, size=plen).astype(np.int32), max_new=max_new))
    return reqs[:n], reqs[n:]


def _tenant_batcher(params, cfg, reqs):
    from repro_torch.serving import ContinuousBatcher, ServingConfig

    batcher = ContinuousBatcher(params, cfg, ServingConfig(**TENANT_CONFIG))
    for r in reqs:
        batcher.submit(r)
    return batcher


def _replay(params, cfg, reqs, limits):
    """The same requests through the same batcher configuration with no
    hypervisor and no migration: each ``(rounds, pages)`` of ``limits``
    sets the page limit after that many rounds, as alice's leases did."""
    batcher = _tenant_batcher(params, cfg, reqs)
    rounds = 0
    for at, pages in limits:
        while rounds < at:
            batcher.step()
            rounds += 1
        batcher.set_page_limit(pages)
    return batcher.run()


def serve_tenancy_path(card: str, params, cfg, build_s: float):
    """Two tenants on one card through the hypervisor, as
    ``examples/serve_multitenant.py`` wires them: a pool of 16 logical
    cores over the card, the ``priority`` policy; the static stage warms
    the ``norm_proj`` program for lease sizes 12 and 16; alice (12 cores,
    priority 2, the program) and bob (4 cores) each serve 16 requests on a
    paged batcher of 128 pages, the most a lease can give it, while the
    pool leases 128 pages between them, so neither may fill its batcher
    while both are resident.  Bob drains and departs, alice's lease grows
    back, and her regrow to 16 cores lands between two of her chunks and
    migrates her live state.  Returns the rmsnorm and matmul launches of
    the run."""
    import torch

    from repro_torch.core import TenantSpec
    from repro_torch.device import resolve_device
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.kernels.matmul import ref as mm_ref
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    from repro_torch.serving import (
        TensorSpec, VirtualAcceleratorPool, make_serving_hypervisor,
    )
    from repro_torch.serving.tenancy import HBM_BYTES_PER_DEVICE

    dev = resolve_device("cuda")
    total = torch.cuda.get_device_properties(0).total_memory
    check(HBM_BYTES_PER_DEVICE <= total, f"HBM_BYTES_PER_DEVICE "
          f"{HBM_BYTES_PER_DEVICE} > the card's {total}")
    log(f"  HBM_BYTES_PER_DEVICE {HBM_BYTES_PER_DEVICE / 1e9:.1f} GB <= "
        f"the card's {total / 1e9:.2f} GB")
    pool = VirtualAcceleratorPool(devices=[dev] * 16,
                                  kv_pages=TENANT_KV_PAGES)
    hv, ex = make_serving_hypervisor(pool, policy="priority")
    alice_reqs, bob_reqs = _tenant_requests(cfg)
    alice = _tenant_batcher(params, cfg, alice_reqs)
    bob = _tenant_batcher(params, cfg, bob_reqs)
    n_pages = TENANT_CONFIG["n_pages"]
    alice_rounds = 0
    limits = {"alice": [], "bob": []}      # (alice's rounds so far, pages)

    def kv_sink(name, batcher):
        def set_limit(n):
            limits[name].append((alice_rounds, n))
            batcher.set_page_limit(n)
        return set_limit

    ex.register_kv_limit("alice", kv_sink("alice", alice))
    ex.register_kv_limit("bob", kv_sink("bob", bob))
    ex.register_state("alice", alice.live_state, on_migrate=alice.adopt_state)

    counters = (rms_ops.rmsnorm, mm_ops.matmul, fa_ops.flash_attention,
                pa_ops.paged_decode_attention)
    for c in counters:
        c.launches = 0
    for c in (mm_ops.matmul, rms_ops.rmsnorm):
        c.route_launches.update(dict.fromkeys(c.route_launches, 0))
    bf16 = torch.bfloat16
    specs = tuple(TensorSpec(NORM_PROJ_SHAPES[k], bf16) for k in "xsw")
    progs = ex.compiler.static_compile("norm_proj", norm_proj, specs,
                                       lease_sizes=[12, 16])
    static_launches = (rms_ops.rmsnorm.launches, mm_ops.matmul.launches)
    check(static_launches == (2, 2),
          f"static stage launched rmsnorm/matmul {static_launches} times, "
          f"expected (2, 2)")
    check(hv.admit(TenantSpec("alice", 12, priority=2.0, artifact="norm_proj",
                              requested_kv_pages=n_pages, min_kv_pages=32)),
          "alice was not admitted")
    check(hv.admit(TenantSpec("bob", 4, priority=1.0, artifact=None,
                              requested_kv_pages=n_pages, min_kv_pages=32)),
          "bob was not admitted")
    check(hv.allocation() == {"alice": 12, "bob": 4},
          f"allocation {hv.allocation()}")
    shared = hv.kv_allocation()
    check(shared["alice"] < n_pages and shared["bob"] < n_pages and
          sum(shared.values()) == TENANT_KV_PAGES,
          f"kv leases {shared} while both are resident: each should be "
          f"below the batcher's {n_pages} pages")
    check(ex.program_of("alice") is progs[12], "alice's program is not the "
          "static stage's lease-12 program")
    t0 = time.perf_counter()
    for _ in range(3):
        alice.step()                          # alice's chunks in flight
        alice_rounds += 1
    bob_stats = bob.run()                     # bob drains
    shared_peak = {"alice": alice.stats.peak_pages_in_use,
                   "bob": bob_stats.peak_pages_in_use}
    shared_resident = alice.stats.peak_resident
    hv.depart("bob")
    hv.resize_request("alice", 16)            # between two of alice's chunks
    alice_stats = alice.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gen = torch.Generator()
    gen.manual_seed(7)
    x, s, w = (torch.randn(NORM_PROJ_SHAPES[k], generator=gen).to(dev, bf16)
               for k in "xsw")
    y = ex.program_of("alice").executable(x, s, w)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}

    for name, reqs in (("alice", alice_reqs), ("bob", bob_reqs)):
        for r in reqs:
            check(r.done and not r.dropped and len(r.out) == r.max_new,
                  f"{name}'s request {r.rid} did not complete")
    ref_reqs = _tenant_requests(cfg)[0]
    _replay(params, cfg, ref_reqs, limits["alice"])   # uninterrupted
    same = sum(a.out == b.out for a, b in zip(alice_reqs, ref_reqs))
    check(same == len(alice_reqs), f"alice's tokens differ from an "
          f"uninterrupted run in {len(alice_reqs) - same} requests")
    regrow = [e for e in ex.reconfig_log
              if e.get("tenant") == "alice" and e.get("n_cores") == 16]
    check(len(regrow) == 1 and "t_migrate" in regrow[0],
          f"alice's regrow is not in reconfig_log: {ex.reconfig_log}")
    check(hv.allocation() == {"alice": 16}, f"allocation {hv.allocation()}")
    check(ex.program_of("alice") is progs[16],
          "the regrow did not hit the lease-16 program")
    alone = hv.kv_allocation()["alice"]
    for name in ("alice", "bob"):
        logged = [e["kv_pages"] for e in ex.reconfig_log
                  if e.get("tenant") == name and "kv_pages" in e]
        check(logged == [n for _, n in limits[name]] and logged,
              f"{name}'s kv leases {logged} != set_page_limit calls "
              f"{limits[name]}")
        # while both were resident each batcher stayed within its shrunk
        # lease, which is below the pages the batcher holds
        check(shared_peak[name] <= shared[name],
              f"{name}'s peak pages {shared_peak[name]} while both were "
              f"resident > lease {shared[name]}")
    check(alone == n_pages, f"alice's lease alone is {alone}, not {n_pages}")
    # the shrunk lease held alice back: she kept more requests resident
    # once her lease grew back
    check(shared_resident < alice_stats.peak_resident,
          f"alice kept {shared_resident} requests resident under her "
          f"shrunk lease and at most {alice_stats.peak_resident} after")
    for batcher, st in ((alice, alice_stats), (bob, bob_stats)):
        check(st.peak_pages_in_use <= n_pages, "peak pages above the pool")
        batcher.kv_pool.check()
    pool.pool.check_isolation()
    pool.pool.check_bandwidth()
    check(launches["rmsnorm"] == 3 and launches["matmul"] == 3,
          f"rmsnorm/matmul launches {launches}: expected 2 in the static "
          f"stage and 1 after the regrow")
    check(mm_ops.matmul.route_launches["wgmma"] == 3,
          f"matmul routes {mm_ops.matmul.route_launches}: the program's bf16 "
          f"product should take the wgmma route")
    check(rms_ops.rmsnorm.route_launches["registers"] == 3,
          f"rmsnorm routes {rms_ops.rmsnorm.route_launches}: the program's "
          f"aligned (2048, 1024) rows should take the register route")
    L = cfg.n_layers
    prefills = alice_stats.prefills + bob_stats.prefills
    steps = alice_stats.steps + bob_stats.steps
    check(launches["flash_attention"] == L * prefills,
          f"flash launches {launches['flash_attention']} != {L} x {prefills}")
    check(launches["paged_decode_attention"] == L * steps,
          f"paged decode launches {launches['paged_decode_attention']} != "
          f"{L} x {steps}")
    want = mm_ref.matmul_ref(rms_ref.rmsnorm_ref(x, s), w)
    err = _rel_err(y, want)
    check(y.shape == want.shape and y.dtype == bf16, "norm_proj: wrong shape")
    check(err <= 8e-3, f"norm_proj: relative error {err} > 8e-3")

    timing = regrow[0]
    log(f"  static stage: " + ", ".join(
        f"lease {n}: {p.lowered_seconds * 1e3:.3f} ms tensors + "
        f"{p.compile_seconds * 1e3:.3f} ms first call" for n, p in
        progs.items()) + f" (after phase 2's {build_s:.1f} s kernel build) "
        f"[{card}]")
    log(f"  regrow 12 -> 16 cores: t_context {timing['t_context'] * 1e3:.3f} "
        f"ms (lookup {timing['t_lookup'] * 1e3:.3f} ms, migrate "
        f"{timing['t_migrate'] * 1e3:.3f} ms) [{card}]")
    log(f"  alice: {alice_stats.completed}/16 requests, {alice_stats.tokens} "
        f"tokens, {alice_stats.prefills} prefills, {alice_stats.chunks} "
        f"chunks, peak pages {alice_stats.peak_pages_in_use}; bob: "
        f"{bob_stats.completed}/16, {bob_stats.tokens} tokens, peak pages "
        f"{bob_stats.peak_pages_in_use}; {wall:.3f} s in all [{card}]")
    log(f"  kv leases of {TENANT_KV_PAGES} pages over two batchers of "
        f"{n_pages}: alice {[n for _, n in limits['alice']]}, bob "
        f"{[n for _, n in limits['bob']]}; peak pages while both were "
        f"resident: alice {shared_peak['alice']}, bob {shared_peak['bob']}; "
        f"alice's peak residents {shared_resident} under the shrunk lease, "
        f"{alice_stats.peak_resident} in all; tokens equal to an "
        f"uninterrupted run: {same}/{len(alice_reqs)}; norm_proj rel err "
        f"{err:.3e}")
    log(f"  launches: rmsnorm={launches['rmsnorm']} matmul="
        f"{launches['matmul']} (2 static + 1 after the regrow; routes "
        f"{rms_ops.rmsnorm.route_launches}, {mm_ops.matmul.route_launches}), "
        f"flash_attention={launches['flash_attention']} (= {L} x {prefills}),"
        f" paged_decode_attention={launches['paged_decode_attention']} "
        f"(= {L} x {steps})")
    return {"rmsnorm": launches["rmsnorm"], "matmul": launches["matmul"]}


# ---------------------------------------------------------------------------
# phase 5f: the fault guards (page-table audit, quarantine, watchdog)
# ---------------------------------------------------------------------------


GUARD_CONFIG = dict(PAGED_CONFIG, audit=True, watchdog_s=5.0)


def _guarded_batcher(params, cfg, reqs):
    from repro_torch.serving import ContinuousBatcher, ServingConfig

    batcher = ContinuousBatcher(params, cfg, ServingConfig(**GUARD_CONFIG))
    for r in reqs:
        batcher.submit(r)
    return batcher


def _private_page(batcher, slot: int):
    """The first page of ``slot``'s row past its pinned prefix that is
    mapped and not owned by the prefix cache, or None."""
    row = batcher.pages.table[slot].cpu().numpy()
    pin = int(batcher.pages.pinned[slot])
    shared = batcher.kv_pool.shared_ids()
    for pid in row[pin:]:
        if pid >= 0 and int(pid) not in shared:
            return int(pid)
    return None


def serve_guarded_path(card: str, params, cfg, paged_tokens):
    """Phase 5b's batcher with ``audit=True, watchdog_s=5.0`` and its 16
    requests: after two clean rounds, an out-of-range id in a live slot's
    table, then a live slot mapping another live slot's private page, then
    a synthetic 6 s stall blamed on a third live slot, one round apart.
    ``paged_tokens`` ({rid: tokens}) is phase 5b's run of the same
    requests."""
    import torch

    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.prefix_attention import ops as pfx_ops

    t0 = time.perf_counter()
    _guarded_batcher(params, cfg, _paged_requests(cfg, n=8, seed=1,
                                                  namespace="warm-up")).run()
    torch.cuda.synchronize()
    log(f"  warm-up run (8 other requests): {time.perf_counter() - t0:.3f} s")

    reqs = _paged_requests(cfg)
    batcher = _guarded_batcher(params, cfg, reqs)
    stats = batcher.stats
    torch.cuda.synchronize()
    counters = (fa_ops.flash_attention, pfx_ops.prefix_flash_attention,
                pa_ops.paged_decode_attention, da_ops.decode_attention)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    for _ in range(2):
        batcher.step()
    check(stats.chunks > 0 and stats.host_syncs == stats.prefills
          + stats.chunks, f"guarded path, clean rounds: {stats.host_syncs} "
          f"host syncs for {stats.prefills} admissions + {stats.chunks} "
          f"chunks")
    check(stats.dispatches - batcher.page_pushes == stats.prefills
          + stats.chunks, "guarded path, clean rounds: dispatches != "
          "prefills + chunks + page pushes")
    check(stats.audit_repairs == 0 and stats.watchdog_trips == 0,
          "a guard fired in a clean round")
    clean = (stats.prefills, stats.chunks, stats.host_syncs)

    def live():
        return [i for i, r in enumerate(batcher.slot_req) if r is not None]

    requeued = set()

    def faulted_round(what: str):
        before = {r.rid for r in batcher.slot_req if r is not None}
        batcher.step()
        back = sorted(r.rid for r in batcher.queue if r.rid in before)
        requeued.update(back)
        log(f"  {what}: requests {back} requeued; audit_repairs="
            f"{stats.audit_repairs} quarantined_pages="
            f"{stats.quarantined_pages} watchdog_trips={stats.watchdog_trips}")

    slots = live()
    check(len(slots) >= 3, f"only {len(slots)} live slots after two rounds")
    batcher.inject_kv_corruption(slots[0])
    faulted_round(f"out-of-range id in slot {slots[0]}'s table")
    check(stats.audit_repairs >= 1, "the audit missed an out-of-range id")

    slots = live()
    check(len(slots) >= 2, f"only {len(slots)} live slots for the double "
          f"mapping")
    thief, owner = slots[0], slots[1]
    stolen = _private_page(batcher, owner)
    check(stolen is not None, f"slot {owner} maps no private page")
    batcher.inject_kv_corruption(thief, pid=stolen)
    faulted_round(f"slot {thief} maps page {stolen}, private to slot {owner}")
    check(stolen in batcher._quarantined,
          f"the double-mapped page {stolen} was not quarantined")

    slots = [i for i in live() if i not in (thief, owner)]
    check(bool(slots), "no third live slot to stall")
    batcher.inject_stall(slots[0], 6.0)
    faulted_round(f"synthetic 6 s stall blamed on slot {slots[0]}")
    check(stats.watchdog_trips == 1, "the watchdog missed a 6 s stall")

    batcher.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fa_n, pfx_n, pa_n, da_n = (c.launches for c in counters)

    for r in reqs:
        check(r.done and not r.dropped,
              f"guarded request {r.rid} did not complete")
        check(len(r.out) == r.max_new, f"guarded request {r.rid}: "
              f"{len(r.out)} tokens, expected {r.max_new}")
        check(all(0 <= t < cfg.vocab for t in r.out),
              f"guarded request {r.rid}: token outside the vocab")
    L = cfg.n_layers
    check(stats.audit_repairs >= 3, f"audit_repairs {stats.audit_repairs} < 3")
    check(stats.quarantined_pages == 1 and batcher._quarantined == {stolen},
          f"quarantined {sorted(batcher._quarantined)}, expected [{stolen}]")
    check(stats.watchdog_trips == 1,
          f"watchdog_trips {stats.watchdog_trips}: a real chunk took > 5 s")
    tab = batcher.pages.table.cpu().numpy()
    top = int(batcher.pages.free_top)
    mapped = set(tab[tab >= 0].tolist())
    free = set(batcher.pages.free[:top].tolist())
    shared = batcher.kv_pool.shared_ids()
    quarantined = batcher._quarantined
    check(not (quarantined & (mapped | free | shared)),
          "a quarantined page is mapped, free or shared")
    check(len(mapped) + len(free) + len(shared) + len(quarantined)
          == batcher.n_pages and sorted(mapped | free | shared | quarantined)
          == list(range(batcher.n_pages)),
          f"mapped {len(mapped)} + free {len(free)} + shared {len(shared)} + "
          f"quarantined {len(quarantined)} do not partition "
          f"{batcher.n_pages} pages")
    batcher.kv_pool.check()
    check(fa_n + pfx_n == L * stats.prefills,
          f"flash {fa_n} + prefix {pfx_n} launches != {L} x {stats.prefills} "
          f"prefills")
    check(pa_n == L * stats.steps,
          f"paged_decode_attention launches {pa_n} != {L} x {stats.steps} steps")
    check(da_n == 0, f"the dense decode kernel ran {da_n} times on the "
          f"guarded path")
    kept = [r for r in reqs if r.rid not in requeued]
    same = sum(r.out == paged_tokens[r.rid] for r in kept)
    log(f"  {stats.completed}/16 requests, {stats.tokens} tokens, "
        f"{stats.prefills} prefills, {stats.chunks} chunks, {stats.steps} "
        f"decode steps, {batcher.page_pushes} page pushes in {wall:.3f} s "
        f"[{card}]")
    log(f"  guards: audit_repairs={stats.audit_repairs} quarantined_pages="
        f"{stats.quarantined_pages} (page {stolen}) watchdog_trips="
        f"{stats.watchdog_trips} requeued requests {sorted(requeued)}; "
        f"clean rounds: {clean[2]} host syncs for {clean[0]} admissions + "
        f"{clean[1]} chunks; whole run: {stats.host_syncs} host syncs for "
        f"{stats.prefills} admissions + {stats.chunks} chunks [{card}]")
    log(f"  pool: mapped {len(mapped)} + free {len(free)} + shared "
        f"{len(shared)} + quarantined {len(quarantined)} = {batcher.n_pages} "
        f"pages; launches: flash_attention={fa_n} + prefix_flash_attention="
        f"{pfx_n} (= {L} x {stats.prefills}), paged_decode_attention={pa_n} "
        f"(= {L} x {stats.steps}), decode_attention={da_n}")
    log(f"  bf16 token identity with phase 5b for the {len(kept)} requests "
        f"never requeued (reported, not gated): {same}/{len(kept)} "
        f"({same / max(len(kept), 1):.3f})")


# ---------------------------------------------------------------------------
# phase 5k: tensor-parallel serving over a lease's logical cores
# ---------------------------------------------------------------------------


TP_WIDTHS = (1, 2, 4)
TP_REQUESTS = 8            # a leg's requests: the whole script's time budget
TP_CORES = 16              # the pool a tenant leases from: cores of cuda:0
TP_RESIZES = (2, 4, 1)     # a leased tenant's widths, one round apart
# the plain attention routes of models/attention.py: none may run on the
# "cuda" route, at any width
PLAIN_ATTENTION = ("naive_attention", "chunked_flash_attention",
                   "_decode_attn_torch", "_gather_pages", "_verify_attn_torch")
DENSE_CONFIG = dict(slots=8, prompt_len=256, max_len=322, chunk=8)


def _tp_modes():
    """(label, config, requests) of phases 5, 5b and 5c."""
    return (("dense", DENSE_CONFIG, _requests),
            ("paged + prefix", PAGED_CONFIG, _paged_requests),
            ("spec + overlap", SPEC_CONFIG, _spec_requests))


def _tp_batcher(params, cfg, config, reqs, tp: int):
    from repro_torch.serving import ContinuousBatcher, ServingConfig

    batcher = ContinuousBatcher(params, cfg, ServingConfig(**config, tp=tp))
    for r in reqs:
        batcher.submit(r)
    return batcher


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "untyped_storage"):
        yield tree


def _shard_bytes(batcher) -> int:
    """Bytes the shards' params hold beyond the batcher's full tree: the
    sharded leaves are views of it, and swiglu's ``wi`` is gathered once
    into its per-shard-contiguous order."""
    full = {t.untyped_storage().data_ptr()
            for t in _tensors(batcher._full_params)}
    seen, extra = set(), 0
    for t in _tensors(batcher.params):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in full and ptr not in seen:
            seen.add(ptr)
            extra += t.untyped_storage().nbytes()
    return extra


def _check_served(label: str, reqs, cfg) -> None:
    for r in reqs:
        check(r.done and not r.dropped and len(r.out) == r.max_new,
              f"{label}: request {r.rid} gave {len(r.out)} of {r.max_new} "
              f"tokens")
        check(all(0 <= t < cfg.vocab for t in r.out),
              f"{label}: request {r.rid}: token outside the vocab")


def _agreement(tokens, ref) -> str:
    """How far ``tokens`` follow ``ref``: requests identical, and tokens
    equal before each request's first difference."""
    same = sum(a == b for a, b in zip(tokens, ref))
    lead = 0
    for a, b in zip(tokens, ref):
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        lead += n
    total = sum(len(b) for b in ref)
    return (f"{same}/{len(ref)} requests identical, {lead}/{total} tokens "
            f"before each request's first difference")


def _tp_resize(card: str, label: str, params, cfg, config, reqs_fn):
    """A tenant leased 1 core of a pool of ``TP_CORES`` logical cores of
    cuda:0 through ``ServingExecutor``; after each of its first rounds the
    hypervisor's ``exec_resize`` moves it to the next of ``TP_RESIZES``
    (``register_remesh`` -> ``ContinuousBatcher.remesh``), between chunks.
    Returns (tokens, the ``t_remesh`` of each resize)."""
    import torch

    from repro_torch.core import TenantSpec
    from repro_torch.serving import ServingExecutor, VirtualAcceleratorPool

    pool = VirtualAcceleratorPool(devices=[torch.device("cuda", 0)] * TP_CORES)
    ex = ServingExecutor(pool)
    ex.exec_admit(TenantSpec(name="t", requested_cores=1, artifact=None), 1,
                  at=0.0)
    reqs = reqs_fn(cfg, n=TP_REQUESTS)
    batcher = _tp_batcher(params, cfg, config, reqs, 1)
    ex.register_remesh("t", lambda mesh: batcher.remesh(mesh=mesh))
    batcher.step()
    for i, n in enumerate(TP_RESIZES):
        ex.exec_resize("t", n, at=float(i + 1), mode=None)
        check(batcher.tp == n and pool.pool.lease_of("t").n_cores == n,
              f"{label}: the resize to {n} cores did not re-mesh the batcher")
        batcher.step()
    batcher.run()
    torch.cuda.synchronize()
    _check_served(f"{label} resize", reqs, cfg)
    t_remesh = [e["t_remesh"] for e in ex.reconfig_log if "t_remesh" in e]
    check(len(t_remesh) == len(TP_RESIZES)
          and batcher.stats.remeshes == len(TP_RESIZES),
          f"{label}: {len(t_remesh)} remeshes for {len(TP_RESIZES)} resizes")
    log(f"  {label}: resized 1 -> " + " -> ".join(map(str, TP_RESIZES))
        + " cores between chunks: t_remesh "
        + ", ".join(f"{t * 1e3:.2f}" for t in t_remesh) + f" ms [{card}]")
    return [list(r.out) for r in reqs], t_remesh


def serve_tp_f32(card: str):
    """Full-width qwen3-0.6b cut to 2 layers, f32 (TF32 off): phases 5, 5b
    and 5c's requests through their batchers at each width of
    ``TP_WIDTHS``; tokens and dispatch and sync counts identical to tp=1,
    and a tenant resized 1 -> 2 -> 4 -> 1 between chunks gives an
    uninterrupted run's tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2,
                              dtype="float32")
    params = init_params(cfg, 0, device="cuda")
    spec_tokens = None
    for label, config, reqs_fn in _tp_modes():
        tokens, counts = {}, {}
        for tp in TP_WIDTHS:
            reqs = reqs_fn(cfg, n=TP_REQUESTS)
            stats = _tp_batcher(params, cfg, config, reqs, tp).run()
            _check_served(f"f32 {label} tp={tp}", reqs, cfg)
            tokens[tp] = [list(r.out) for r in reqs]
            counts[tp] = (stats.prefills, stats.chunks, stats.dispatches,
                          stats.host_syncs)
        for tp in TP_WIDTHS[1:]:
            check(tokens[tp] == tokens[1],
                  f"f32 {label}: tp={tp} tokens differ from tp=1 ("
                  f"{_agreement(tokens[tp], tokens[1])})")
            check(counts[tp] == counts[1],
                  f"f32 {label}: tp={tp} (admissions, chunks, dispatches, "
                  f"syncs) {counts[tp]} != tp=1's {counts[1]}")
        log(f"  f32 {label}: tokens at tp " + ", ".join(
            map(str, TP_WIDTHS[1:])) + f" identical to tp=1 "
            f"({sum(map(len, tokens[1]))} tokens, {TP_REQUESTS} requests); "
            f"admissions, "
            f"chunks, dispatches, syncs {counts[1]} at every width")
        if label == "spec + overlap":
            spec_tokens = tokens[1]
    resized, _ = _tp_resize(card, "f32 spec + overlap", params, cfg,
                            SPEC_CONFIG, _spec_requests)
    check(resized == spec_tokens,
          f"f32 resize: tokens differ from the uninterrupted run ("
          f"{_agreement(resized, spec_tokens)})")
    log("  f32 spec + overlap: the resized tenant's tokens equal the "
        "uninterrupted run's")
    del params
    _free_device_memory()


def serve_tp_bf16(card: str, params, cfg):
    """Uncut qwen3-0.6b (phase 5's bf16 weights) behind the dense and the
    paged + prefix batchers at each width of ``TP_WIDTHS``.  Gates:
    completions; one dispatch (plus page pushes) and one host sync per
    admission and per chunk, the same counts as tp=1; ``n_layers x tp``
    kernel launches per admission (flash or prefix) and per decode step,
    and no plain attention route; peak memory above the weights within
    tp=1's + the shards' own bytes + 10 % of the weights.  Reports token
    agreement with tp=1, tokens/s and wall ms per chunk, and the
    ``t_remesh`` of a resized tenant."""
    import torch

    from repro_torch.models import attention

    pbytes = _param_bytes(params)
    L = cfg.n_layers
    plain = dict.fromkeys(PLAIN_ATTENTION, 0)
    restore = [_counting(attention, name, plain, name)
               for name in PLAIN_ATTENTION]
    counters = _attn_counters()
    dense_tokens = None
    try:
        for label, config, reqs_fn in _tp_modes()[:2]:
            paged = config.get("paged", False)
            admit = (("flash_attention", "prefix_flash_attention") if paged
                     else ("flash_attention",))
            step = "paged_decode_attention" if paged else "decode_attention"
            ref_tokens, ref_counts, ref_peak = None, None, 0
            for tp in TP_WIDTHS:
                warm = _tp_batcher(params, cfg, config,
                                   reqs_fn(cfg, n=2, seed=1), tp)
                warm.run()
                del warm
                _free_device_memory()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                reqs = reqs_fn(cfg, n=TP_REQUESTS)
                batcher = _tp_batcher(params, cfg, config, reqs, tp)
                for c in counters.values():
                    c.launches = 0
                for name in plain:
                    plain[name] = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                stats = batcher.run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                name = f"bf16 {label} tp={tp}"
                _check_served(name, reqs, cfg)
                launches = {k: c.launches for k, c in counters.items()}
                pushes = batcher.page_pushes if paged else 0
                check(stats.dispatches - pushes == stats.prefills + stats.chunks,
                      f"{name}: dispatches != admissions + chunks + pushes")
                check(stats.host_syncs == stats.prefills + stats.chunks,
                      f"{name}: host syncs != one per admission and chunk")
                counts = (stats.prefills, stats.chunks, stats.steps,
                          stats.dispatches, stats.host_syncs)
                if tp == 1:
                    ref_counts = counts
                check(counts == ref_counts,
                      f"{name}: (admissions, chunks, steps, dispatches, "
                      f"syncs) {counts} != tp=1's {ref_counts}")
                n_admit = sum(launches[k] for k in admit)
                check(n_admit == L * tp * stats.prefills,
                      f"{name}: {n_admit} admission launches != {L} x {tp} "
                      f"x {stats.prefills}")
                check(launches[step] == L * tp * stats.steps,
                      f"{name}: {launches[step]} {step} launches != {L} x "
                      f"{tp} x {stats.steps} steps")
                others = {k: n for k, n in launches.items()
                          if k not in admit and k != step and n}
                check(not others, f"{name}: other kernels ran: {others}")
                check(not any(plain.values()),
                      f"{name}: plain attention ran: {plain}")
                peak = torch.cuda.max_memory_allocated() - base
                shard = _shard_bytes(batcher)
                cache = stats.cache_bytes
                if tp == 1:
                    ref_peak = peak
                # what the shards add: their own bytes, within 10 % of the
                # weights.  (shards + cache + 10 % alone is not met at tp=1:
                # an admission holds its prompt's K/V as a list of layers,
                # stacked, and seeded into rings beside the resident cache)
                limit = ref_peak + shard + 0.1 * pbytes
                check(peak <= limit,
                      f"{name}: peak {_gib(peak)} above the weights > tp=1's "
                      f"{_gib(ref_peak)} + shards' own {_gib(shard)} + 10 % "
                      f"of the weights ({_gib(limit)})")
                toks = [list(r.out) for r in reqs]
                if tp == 1:
                    ref_tokens = toks
                    if not paged:
                        dense_tokens = toks
                agree = ("" if tp == 1 else
                         f"; against tp=1: {_agreement(toks, ref_tokens)}")
                log(f"  {name}: {stats.completed}/{len(reqs)} requests, "
                    f"{stats.tokens} tokens, {stats.prefills} admissions, "
                    f"{stats.chunks} chunks, {stats.steps} steps in "
                    f"{wall:.3f} s: tokens/s={stats.tokens / wall:.1f}, "
                    f"{wall * 1e3 / stats.chunks:.2f} wall ms a chunk "
                    f"(admissions included){agree} [{card}]")
                log(f"  {name}: launches " + ", ".join(
                    f"{k}={launches[k]}" for k in (*admit, step))
                    + f" (= {L} x {tp} x admissions, steps); peak "
                    f"{_gib(peak)} above the {_gib(base)} allocated with "
                    f"the weights ({_gib(pbytes)}): limit tp=1's "
                    f"{_gib(ref_peak)} + shards' own {_gib(shard)} + 10 % "
                    f"of the weights = {_gib(limit)}; shards' own + cache "
                    f"{_gib(cache)} + 10 % of the weights = "
                    f"{_gib(shard + cache + 0.1 * pbytes)}")
                del batcher
                _free_device_memory()
        resized, _ = _tp_resize(card, "bf16 dense", params, cfg,
                                DENSE_CONFIG, _requests)
        log(f"  bf16 dense resized tenant against tp=1: "
            f"{_agreement(resized, dense_tokens)} [{card}]")
    finally:
        for undo in restore:
            undo()


def tp_handoff_us(card: str, n_sums: int = 2000) -> None:
    """Host cost of the shards' turns: ``n_sums`` sums of a one-element CPU
    tensor through a ``ShardGroup`` at tp 2 and 4 (no device work), in µs
    a shard a sum (each sum hands the turn on once a shard)."""
    import torch

    from repro_torch.distributed import TP_POLICY, ShardGroup, make_tp_mesh

    x = torch.ones(1)

    def program():
        for _ in range(n_sums):
            TP_POLICY(x, "attn_out")

    out = []
    for tp in TP_WIDTHS[1:]:
        group = ShardGroup(make_tp_mesh(tp, [torch.device("cpu")] * tp))
        group.run(program, [()] * tp)                # threads started
        t0 = time.perf_counter()
        group.run(program, [()] * tp)
        us = (time.perf_counter() - t0) / (n_sums * tp) * 1e6
        out.append(f"tp={tp} {us:.1f}")
        group.close()
    log(f"  the shards' turns: " + ", ".join(out) + f" µs a shard a sum "
        f"({n_sums} sums of a one-element CPU tensor) [{card}]")


def serve_tp_path(card: str, params, cfg) -> None:
    serve_tp_f32(card)
    serve_tp_bf16(card, params, cfg)
    tp_handoff_us(card)


# ---------------------------------------------------------------------------
# phase 5g: the MoE family (deepseek-moe-16b, dense, paged, speculative)
# ---------------------------------------------------------------------------


def _moe_leg(card, label, params, cfg, config, reqs, base, pbytes, *,
             late: int = 0):
    """One leg of phase 5g: a 2-request warm-up of ``config``, then
    ``reqs`` through a fresh batcher with every attention kernel's count
    set to 0; the last ``late`` requests arrive after the first round.
    Gates completion, one dispatch (plus page pushes) and one host sync
    per admission and per chunk, and the peak device memory above ``base``
    (taken before the weights were made) against the weights, the leg's
    cache and 10 % of the weights.  Returns (batcher, stats, wall,
    launches)."""
    import torch

    from repro_torch.serving import ContinuousBatcher, Request, ServingConfig

    warm = [Request(rid=r.rid, prompt=r.prompt[-64:], max_new=8,
                    namespace="warm-up") for r in reqs[:2]]
    warm_b = ContinuousBatcher(params, cfg, ServingConfig(**config))
    for r in warm:
        warm_b.submit(r)
    warm_b.run()
    del warm_b
    _free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    batcher = ContinuousBatcher(params, cfg, ServingConfig(**config))
    for r in reqs[:len(reqs) - late]:
        batcher.submit(r)
    counters = _attn_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if late:
        batcher.step()
        for r in reqs[len(reqs) - late:]:
            batcher.submit(r)
    stats = batcher.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    for r in reqs:
        check(r.done and not r.dropped and len(r.out) == r.max_new,
              f"{label}: request {r.rid} gave {len(r.out)} of {r.max_new} "
              f"tokens")
        check(all(0 <= t < cfg.vocab for t in r.out),
              f"{label}: request {r.rid}: token outside the vocab")
    pushes = batcher.page_pushes if batcher.paged else 0
    check(stats.dispatches - pushes == stats.prefills + stats.chunks,
          f"{label}: dispatches != admissions + chunks + page pushes")
    check(stats.host_syncs == stats.prefills + stats.chunks,
          f"{label}: host syncs != one per admission + one per chunk")
    peak = torch.cuda.max_memory_allocated() - base
    cache = stats.cache_bytes
    limit = pbytes + cache + 0.1 * pbytes
    log(f"  {label}: {stats.completed}/{len(reqs)} requests, {stats.tokens} "
        f"tokens, {stats.prefills} admissions, {stats.chunks} chunks, "
        f"{stats.steps} decode steps in {wall:.3f} s: tokens/s="
        f"{stats.tokens / wall:.1f} [{card}]")
    log(f"  {label}: peak {_gib(peak)} above the start of the phase; params "
        f"{_gib(pbytes)} + cache {_gib(cache)} + 10 % of params "
        f"{_gib(0.1 * pbytes)} = {_gib(limit)} [{card}]")
    check(peak <= limit, f"{label}: peak device memory {_gib(peak)} > params "
          f"+ cache + 10 % of params ({_gib(limit)})")
    return batcher, stats, wall, launches


def _moe_step_ms(params, cfg, n_rounds: int = 4):
    """Wall ms per decode step of phase 5's dense batcher once 8 requests
    of ``max_new`` 64 are resident: one round admits all 8, then
    ``n_rounds`` rounds are pure chunks of 8 steps, timed between syncs."""
    import torch

    batcher = _admitted(_batcher(params, cfg, _requests(cfg, n=8, seed=9,
                                                        max_new=64)))
    prefills, steps = batcher.stats.prefills, batcher.stats.steps
    t0 = time.perf_counter()
    for _ in range(n_rounds):
        batcher.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(batcher.stats.prefills == prefills, "an admission ran in the "
          "timed decode rounds")
    return wall * 1e3 / (batcher.stats.steps - steps)


def serve_moe_path(card: str):
    """Phase 5g: full deepseek-moe-16b, its weights made once for three
    legs: phase 5's dense batcher and 16 requests, phase 5b's paged batcher
    and requests with the prefix cache, and 4 of phase 5c's requests on its
    speculative batcher with overlap.  Each kernel's launches are 28 x its
    calls on its leg and no other attention kernel runs there."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config("deepseek-moe-16b")
    L = cfg.n_layers
    _free_device_memory()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pbytes = _param_bytes(params)
    init_peak = torch.cuda.max_memory_allocated() - base
    log(f"  {cfg.name}: params {_gib(pbytes)} ({pbytes / 1e9:.2f} GB) made in "
        f"{init_s:.1f} s; init_params peak {_gib(init_peak)} above the start "
        f"[{card}]")
    check(init_peak <= 1.1 * pbytes, f"init_params peaked at {_gib(init_peak)}"
          f" > 1.1 x params: a stacked copy of the weights")

    expert_bytes = L * cfg.moe.n_experts * 3 * cfg.d_model \
        * cfg.moe.expert_d_ff * 2
    step_bytes = pbytes - params["embed"]["w"].numel() * 2
    floor_ms = expert_bytes / HBM_BYTES_PER_S * 1e3
    step_floor_ms = step_bytes / HBM_BYTES_PER_S * 1e3

    _, st, _, n = _moe_leg(card, "dense leg", params, cfg,
                           dict(slots=8, prompt_len=256, max_len=322, chunk=8),
                           _requests(cfg), base, pbytes)
    check(n["flash_attention"] == L * st.prefills
          and n["decode_attention"] == L * st.steps
          and n["prefix_flash_attention"] == n["paged_decode_attention"]
          == n["paged_verify_attention"] == 0,
          f"dense leg launches {n}: flash != {L} x {st.prefills} admissions "
          f"or decode != {L} x {st.steps} steps")
    log(f"  dense leg launches: flash_attention={n['flash_attention']} (= {L} "
        f"x {st.prefills}), decode_attention={n['decode_attention']} (= {L} x "
        f"{st.steps})")

    b, st, _, n = _moe_leg(card, "paged leg", params, cfg, PAGED_CONFIG,
                           _paged_requests(cfg), base, pbytes)
    check(st.prefix_hits > 0 and n["prefix_flash_attention"] > 0,
          "paged leg: no admission went through the prefix cache's kernel")
    check(n["flash_attention"] + n["prefix_flash_attention"] == L * st.prefills
          and n["paged_decode_attention"] == L * st.steps
          and n["decode_attention"] == n["paged_verify_attention"] == 0,
          f"paged leg launches {n}: flash + prefix != {L} x {st.prefills} "
          f"admissions or paged decode != {L} x {st.steps} steps")
    b.kv_pool.check()
    free_top = int(b.pages.free_top)
    check(free_top + b.kv_pool.shared == b.n_pages,
          f"paged leg: free_top {free_top} + shared {b.kv_pool.shared} != "
          f"{b.n_pages} pages")
    log(f"  paged leg: {st.prefix_hits} prefix hits; ledger free_top "
        f"{free_top} + shared {b.kv_pool.shared} = {b.n_pages} pages; "
        f"launches: flash_attention={n['flash_attention']} + "
        f"prefix_flash_attention={n['prefix_flash_attention']} (= {L} x "
        f"{st.prefills}), paged_decode_attention="
        f"{n['paged_decode_attention']} (= {L} x {st.steps})")
    del b

    W = SPEC_CONFIG["draft_window"]
    # two of the four arrive after the first round, so their admission
    # runs behind a verify chunk (overlap)
    b, st, _, n = _moe_leg(card, "speculative leg", params, cfg, SPEC_CONFIG,
                           _spec_requests(cfg, n=4), base, pbytes, late=2)
    windows = st.steps // W
    check(st.spec_windows > 0 and windows > 0, "speculative leg: no window")
    check(st.overlap_rounds >= 1, "speculative leg: no admission overlapped "
          "a verify chunk")
    check(n["paged_verify_attention"] == L * windows
          and n["flash_attention"] + n["prefix_flash_attention"]
          == L * st.prefills
          and n["decode_attention"] == n["paged_decode_attention"] == 0,
          f"speculative leg launches {n}: verify != {L} x {windows} windows "
          f"or flash + prefix != {L} x {st.prefills} admissions")
    check(st.device_draft_accepted == st.accepted_tokens,
          f"speculative leg: device-counted accepted drafts "
          f"{st.device_draft_accepted} != {st.accepted_tokens} on the host")
    b.kv_pool.check()
    free_top = int(b.pages.free_top)
    check(free_top + b.kv_pool.shared == b.n_pages,
          f"speculative leg: free_top {free_top} + shared {b.kv_pool.shared} "
          f"!= {b.n_pages} pages")
    log(f"  speculative leg: {windows} verify windows, acceptance_rate="
        f"{st.acceptance_rate:.3f}, {st.overlap_rounds} overlap rounds; "
        f"launches: paged_verify_attention={n['paged_verify_attention']} (= "
        f"{L} x {windows}), flash_attention={n['flash_attention']} + "
        f"prefix_flash_attention={n['prefix_flash_attention']} (= {L} x "
        f"{st.prefills})")
    del b

    step_ms = _moe_step_ms(params, cfg)
    log(f"  dense decode, 8 slots resident: {step_ms:.2f} ms a step (wall); "
        f"floor {floor_ms:.2f} ms to read the {expert_bytes / 1e9:.1f} GB of "
        f"routed experts once, {step_floor_ms:.2f} ms for all "
        f"{step_bytes / 1e9:.1f} GB a step reads [{card}]")
    return params, cfg, floor_ms


# ---------------------------------------------------------------------------
# phases 4d and 5h-5j: the VLM, audio and hybrid families
# ---------------------------------------------------------------------------


VLM_SIDE = 8           # the stub image: an 8 x 8 patch grid at t = 0
VLM_TEXT = 192         # text tokens after it
VLM_LAYERS = 16        # qwen2-vl-72b's 80 layers cut to 16: 33.07 GB of bf16
# phases 4d and 5j: one full-width jamba-1.5-large period (7 Mamba layers
# and 1 attention layer, MoE every second), every width as published; the
# card holds its share of the experts of each MoE layer: 8 of the 16 (a
# 2-way expert split) in bf16, 4 (a 4-way split) for phase 4d's f32 check
HYBRID_LAYERS = 8
HYBRID_EXPERTS = {"bfloat16": 8, "float32": 4}
# phase 5j: that period behind the batcher in each mode, 16 requests
HYBRID_CONFIG = dict(slots=8, prompt_len=256, max_len=322, chunk=8)
HYBRID_LEGS = (("dense", {}), ("paged", dict(paged=True, page_size=8)),
               ("overlap", dict(overlap=True)),
               ("paged + audit", dict(paged=True, page_size=8, audit=True)))


def vlm_positions(B: int, side: int, n_text: int, device="cuda"):
    """(3, B, side**2 + n_text) int32 M-RoPE ids: a side x side patch grid
    at t = 0 (its rows in the h stream, its columns in the w stream), then
    the text at ``side**2 + j`` on all three streams, where decode goes
    on."""
    import torch

    n_p = side * side
    i = torch.arange(n_p)
    patch = torch.stack([torch.zeros_like(i), i // side, i % side])
    text = (n_p + torch.arange(n_text)).expand(3, n_text)
    pos = torch.cat([patch, text], dim=1).to(torch.int32)
    return pos[:, None].expand(3, B, pos.shape[1]).contiguous().to(device)


def family_batch(cfg, B: int, n_text: int, seed: int, device="cuda"):
    """A prompt batch for ``cfg``'s family, made from ``seed``: B prompts of
    ``n_text`` tokens; the VLM's 64 stub patch embeddings before them at
    :func:`vlm_positions`; the audio family's stub frames (B, enc_seq, d).
    Embeddings are drawn at the token table's scale (0.02)."""
    import torch

    from repro_torch.device import torch_dtype

    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab, size=(B, n_text)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks).to(device)}

    def emb(n):
        e = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32) * 0.02
        return torch.from_numpy(e).to(device=device,
                                      dtype=torch_dtype(cfg.dtype))

    if cfg.family == "vlm":
        batch["extra_embeds"] = emb(VLM_SIDE ** 2)
        batch["positions"] = vlm_positions(B, VLM_SIDE, n_text, device)
    if cfg.family == "audio":
        batch["frames"] = emb(cfg.enc_seq)
    return batch


def _counting(obj, name: str, counts: dict, key: str, on_call=None):
    """Replace ``obj.name`` by a wrapper that adds one to ``counts[key]`` a
    call (and runs ``on_call(before, after)`` around it, given); returns
    the function that restores it."""
    real = getattr(obj, name)

    def wrapped(*a, **kw):
        counts[key] += 1
        before = on_call() if on_call else None
        out = real(*a, **kw)
        if on_call:
            counts[key + " flash"] += on_call() - before
        return out

    setattr(obj, name, wrapped)
    return lambda: setattr(obj, name, real)


def _union_ms(spans) -> float:
    """Total length in ms of the union of (start, end) intervals in us."""
    if not spans:
        return 0.0
    spans = sorted(spans)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for st, e in spans[1:]:
        if st > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = st, e
        else:
            cur_e = max(cur_e, e)
    return (busy + cur_e - cur_s) * 1e-3


def _decode_device_ms(params, cfg, scfg, batch, S: int, n_steps: int = 8):
    """Device ms a decode step: after a prefill of ``batch`` (S positions),
    one chunk of
    ``n_steps`` steps untraced, then one under ``torch.profiler`` (the
    union of its kernel intervals over ``n_steps``); None when the
    profiler saw no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import (
        SlotState, make_decode_chunk, make_prefill_step)

    logits, caches = make_prefill_step(cfg, scfg)(params, batch)
    B = logits.shape[0]
    dev = logits.device
    state = SlotState(
        tokens=torch.argmax(logits, -1).to(torch.int32),
        cur_pos=torch.full((B,), S, dtype=torch.int32, device=dev),
        active=torch.ones((B,), dtype=torch.bool, device=dev),
        remaining=torch.full((B,), 2 * n_steps, dtype=torch.int32, device=dev),
        eos=torch.full((B,), -1, dtype=torch.int32, device=dev))
    chunk = make_decode_chunk(cfg, scfg, n_steps)
    caches, state, *_ = chunk(params, caches, state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        chunk(params, caches, state)
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.time_range.end > e.time_range.start]
    return _union_ms(spans) / n_steps if spans else None


def _is_sync(warning) -> bool:
    """A warning of ``torch.cuda.set_sync_debug_mode("warn")``."""
    return "synchronizing" in str(warning.message)


def _generate_leg(card: str, label: str, params, cfg, batch, n_new: int,
                  base: int, max_len=None):
    """``generate`` over ``batch`` (a warm-up call first): gates one chunk
    step a chunk bucket, no host sync inside the call (the one fetch of
    the tokens after it is the only synchronising operation
    ``torch.cuda.set_sync_debug_mode`` reports), the kernels' launches
    (flash once an attention layer a prefill, audio: the encoder's pass
    once a call with its layers' flash launches inside it, the cross K/V
    made once a decoder layer a call and one cross-attention flash launch
    a decoder layer a step; the decode kernel once an attention layer a
    step), tokens in the vocab, and the peak device memory above ``base``
    (taken before the weights were made) against the weights + cache + 10
    % of the weights.  Audio runs its encoder before any cache exists, and
    a small model's encoder activations outgrow 10 % of its weights, so
    there the cache's term is the larger of the encoder pass's own peak
    (measured alone before the call) and the cache with what building its
    cross K/V keeps beside it: the encoder's output and one decoder
    layer's fresh K/V.  Logs tokens/s and the wall and device ms of a
    decode step beside the floor of reading the decoder's weights and
    caches once."""
    import warnings

    import torch

    from repro_torch.models import attention as attn_mod
    from repro_torch.serving import ServeConfig, engine, generate
    from repro_torch.serving.kv_cache import kv_cache_bytes

    toks = batch["tokens"]
    extras = {k: v for k, v in batch.items() if k != "tokens"}
    B, S = toks.shape
    if "extra_embeds" in extras:
        S += extras["extra_embeds"].shape[1]
    scfg = ServeConfig(max_len=max_len or S + n_new)

    def run(n):
        return generate(params, cfg, toks, n_new=n, scfg=scfg, extras=extras)

    run(9)                                    # first-use costs, one chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(1)                                    # the prefill and first token
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    _free_device_memory()

    n_attn, _ = _layer_counts(cfg)
    L, audio = cfg.n_layers, cfg.family == "audio"
    enc_peak = enc_out = layer_kv = 0
    if audio:
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        enc = engine.encoder_forward(params, extras["frames"], cfg,
                                     impl=scfg.attn_impl)
        torch.cuda.synchronize()
        enc_peak = torch.cuda.max_memory_allocated() - start
        enc_out = enc.numel() * enc.element_size()
        layer_kv = 2 * enc.shape[0] * enc.shape[1] * cfg.kv_dim \
            * enc.element_size()
        del enc
    counters = _attn_counters()
    fa, da = counters["flash_attention"], counters["decode_attention"]
    for c in counters.values():
        c.launches = 0
    counts = {"chunks": 0, "encoder": 0, "encoder flash": 0, "cross_kv": 0}
    restore = [
        _counting(engine, "make_decode_chunk", counts, "chunks"),
        _counting(engine, "encoder_forward", counts, "encoder",
                  on_call=lambda: fa.launches),
        _counting(attn_mod, "encode_cross_kv", counts, "cross_kv")]
    torch.cuda.reset_peak_memory_stats()
    try:
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            out = run(n_new)
            in_call = sum(_is_sync(w) for w in caught)
            out = out.cpu()
            wall = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
        for r in restore:
            r()
    syncs = [w for w in caught if _is_sync(w)]
    launches = {name: c.launches for name, c in counters.items()}
    steps = n_new - 1
    buckets, left = 0, steps
    while left > 0:
        left -= engine.chunk_bucket(min(left, scfg.chunk))
        buckets += 1
    check(tuple(out.shape) == (B, n_new), f"{label}: tokens {tuple(out.shape)}")
    check(bool(((out >= 0) & (out < cfg.vocab)).all()),
          f"{label}: a token outside the vocab")
    check(counts["chunks"] == buckets, f"{label}: {counts['chunks']} decode "
          f"chunk steps for {buckets} chunk buckets")
    check(in_call == 0 and len(syncs) == 1,
          f"{label}: {in_call} synchronising operations inside generate, "
          f"{len(syncs)} in all (the fetch of the tokens is one)")
    flash_want = n_attn + (cfg.n_enc_layers + L + L * steps if audio else 0)
    check(launches["flash_attention"] == flash_want,
          f"{label}: {launches['flash_attention']} flash launches, expected "
          f"{flash_want}")
    check(launches["decode_attention"] == n_attn * steps,
          f"{label}: {launches['decode_attention']} decode launches, expected "
          f"{n_attn} x {steps}")
    check(sum(launches.values()) == launches["flash_attention"]
          + launches["decode_attention"], f"{label}: other attention kernels "
          f"ran: {launches}")
    if audio:
        check(counts["encoder"] == 1
              and counts["encoder flash"] == cfg.n_enc_layers,
              f"{label}: {counts['encoder']} encoder passes with "
              f"{counts['encoder flash']} flash launches")
    check(counts["cross_kv"] == (L if audio else 0),
          f"{label}: the cross K/V made {counts['cross_kv']} times")
    pbytes = _param_bytes(params)
    cache = kv_cache_bytes(cfg, B, scfg.max_len)
    peak = torch.cuda.max_memory_allocated() - base
    limit = pbytes + max(cache + enc_out + layer_kv, enc_peak) + 0.1 * pbytes
    check(peak <= limit, f"{label}: peak device memory {_gib(peak)} > "
          f"params + cache + 10 % of params ({_gib(limit)})")
    unembed = params["embed" if cfg.tie_embeddings else "lm_head"]["w"]
    read = (_param_bytes(params["blocks"])
            + unembed.numel() * unembed.element_size() + cache)
    floor_ms = read / HBM_BYTES_PER_S * 1e3
    step_wall = (wall - prefill_s) * 1e3 / steps
    step_dev = _decode_device_ms(params, cfg, scfg, batch, S)
    dev = "not measured" if step_dev is None else f"{step_dev:.2f} ms"
    log(f"  {label}: {B} x {n_new} tokens in {wall:.3f} s (prefill and first "
        f"token {prefill_s:.3f} s): tokens/s={B * n_new / wall:.1f}; a decode "
        f"step {step_wall:.2f} ms wall, {dev} device, beside the "
        f"{floor_ms:.2f} ms floor to read {read / 1e9:.2f} GB (decoder weights "
        f"and caches) at 3.35 TB/s [{card}]")
    log(f"  {label}: {counts['chunks']} chunk steps, 0 host syncs inside "
        f"generate; launches: flash {launches['flash_attention']}, decode "
        f"{launches['decode_attention']}"
        + (f"; 1 encoder pass ({counts['encoder flash']} non-causal flash "
           f"launches), cross K/V made {counts['cross_kv']} times (once a "
           f"decoder layer)" if audio else "")
        + f"; peak {_gib(peak)} above the start; params {_gib(pbytes)} + "
        f"cache {_gib(cache)}"
        + (f" (+ encoder output {_gib(enc_out)} + one layer's cross K/V "
           f"{_gib(layer_kv)}; the encoder pass alone peaks at "
           f"{_gib(enc_peak)}: the larger counts)" if audio else "")
        + f" + 10 % = {_gib(limit)} [{card}]")
    return out


def serve_hybrid_path(card: str, params, cfg, base: int):
    """Phase 5j: the jamba period behind the batcher in each of
    :data:`HYBRID_LEGS`, 16 requests each after a 2-request warm-up.  Gates
    completion, one dispatch and one host sync per admission and per
    chunk, the SSD kernel once an SSM layer an admission, the flash kernel
    once an attention layer an admission and the leg's decode kernel once
    an attention layer a step (the other decode kernel never), overlap
    rounds on the overlap leg, a clean audit, the page ledger, and the
    peak device memory above ``base`` (taken before the weights were made)
    against the weights, the leg's cache and 10 % of the weights."""
    import torch

    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.serving import ContinuousBatcher, Request, ServingConfig

    n_attn, n_ssm = _layer_counts(cfg)
    counters = _attn_counters()
    pbytes = _param_bytes(params)
    for label, kw in HYBRID_LEGS:
        config = ServingConfig(**HYBRID_CONFIG, **kw)
        warm = ContinuousBatcher(params, cfg, config)
        for r in _requests(cfg, n=2, seed=20, max_new=8):
            warm.submit(r)
        warm.run()
        del warm
        _free_device_memory()
        torch.cuda.reset_peak_memory_stats()
        reqs = _requests(cfg, seed=21)
        batcher = ContinuousBatcher(params, cfg, config)
        for r in reqs:
            batcher.submit(r)
        for c in (*counters.values(), ssd_ops.ssd):
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = batcher.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: c.launches for name, c in counters.items()}
        tag = f"jamba {label}"
        for r in reqs:
            check(r.done and not r.dropped and len(r.out) == r.max_new,
                  f"{tag}: request {r.rid} gave {len(r.out)} of {r.max_new} "
                  f"tokens")
            check(all(0 <= t < cfg.vocab for t in r.out),
                  f"{tag}: request {r.rid}: token outside the vocab")
        pushes = batcher.page_pushes if batcher.paged else 0
        check(stats.dispatches - pushes == stats.prefills + stats.chunks,
              f"{tag}: dispatches != admissions + chunks + page pushes")
        check(stats.host_syncs == stats.prefills + stats.chunks,
              f"{tag}: host syncs != one per admission + one per chunk")
        check(ssd_ops.ssd.launches == n_ssm * stats.prefills,
              f"{tag}: {ssd_ops.ssd.launches} SSD calls for {stats.prefills} "
              f"admissions of {n_ssm} SSM layers")
        decode = ("paged_decode_attention" if batcher.paged
                  else "decode_attention")
        want = {name: 0 for name in launches}
        want["flash_attention"] = n_attn * stats.prefills
        want[decode] = n_attn * stats.steps
        check(launches == want, f"{tag}: attention launches {launches}, "
              f"expected {want}")
        if label == "overlap":
            check(stats.overlap_rounds > 0, f"{tag}: no overlap round")
        ledger = ""
        if batcher.paged:
            pool = batcher.kv_pool
            pool.check()
            free_top = int(batcher.pages.free_top)
            check(pool.used == 0 and free_top == batcher.n_pages,
                  f"{tag}: {pool.used} pages held, free_top {free_top} of "
                  f"{batcher.n_pages} after the run")
            check(stats.audit_repairs == 0 and stats.quarantined_pages == 0,
                  f"{tag}: the audit repaired a clean run")
            ledger = (f"; ledger: free_top {free_top} = {batcher.n_pages} "
                      f"pages, peak {stats.peak_pages_in_use} in use")
        peak = torch.cuda.max_memory_allocated() - base
        limit = pbytes + stats.cache_bytes + 0.1 * pbytes
        check(peak <= limit, f"{tag}: peak device memory {_gib(peak)} > "
              f"params + cache + 10 % of params ({_gib(limit)})")
        log(f"  {tag}: {stats.completed}/{len(reqs)} requests, {stats.tokens} "
            f"tokens, {stats.prefills} admissions, {stats.chunks} chunks, "
            f"{stats.steps} steps in {wall:.3f} s: tokens/s="
            f"{stats.tokens / wall:.1f}; SSD {ssd_ops.ssd.launches} "
            f"(= {n_ssm} x {stats.prefills}), flash "
            f"{launches['flash_attention']}, {decode} {launches[decode]}"
            f"{ledger}; peak {_gib(peak)} above the start: params "
            f"{_gib(pbytes)} + cache {_gib(stats.cache_bytes)} + 10 % = "
            f"{_gib(limit)} [{card}]")
        del batcher


def _make_params(card: str, cfg):
    """``init_params(cfg)`` on the card, after freeing what is unreferenced;
    returns (params, the memory allocated before them)."""
    import torch

    from repro_torch.models import init_params

    _free_device_memory()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    log(f"  {cfg.name}, {cfg.n_layers} layers, {cfg.dtype}: params "
        f"{_gib(_param_bytes(params))} made in "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    return params, base


def family_phases(card: str, families=("vlm", "audio", "hybrid")) -> None:
    """Phases 4d and 5h-5j, one family at a time, each model freed before
    the next is made: qwen2-vl-72b at full width (2 layers in f32, then 16
    layers in bf16, those weights made once for phase 4d's bf16 check and
    phase 5h), whole whisper-base (f32, then bf16 for phase 4d and phase
    5i), one full-width jamba period (f32 holding 4 experts, then bf16
    holding 8, those weights made once for phase 4d's bf16 check and phase
    5j)."""
    phases = {"vlm": _vlm_phases, "audio": _audio_phases,
              "hybrid": _hybrid_phases}
    for family in families:
        phases[family](card)
        _free_device_memory()


def _vlm_phases(card: str) -> None:
    from repro_torch.configs import get_config

    vlm = get_config("qwen2-vl-72b")
    log("phase 4d: qwen2-vl-72b at full width (M-RoPE over an 8 x 8 patch "
        "grid, then text), cuda kernels against the plain path")
    cfg = dataclasses.replace(vlm, n_layers=2, dtype="float32")
    params, _ = _make_params(card, cfg)
    check_routes(card, cfg, params, family_batch(cfg, 2, VLM_TEXT, seed=12))
    del params
    cfg = dataclasses.replace(vlm, n_layers=VLM_LAYERS)
    params, base = _make_params(card, cfg)
    check_routes(card, cfg, params, family_batch(cfg, 2, VLM_TEXT, seed=12))
    log(f"phase 5h: VLM path, qwen2-vl-72b ({VLM_LAYERS} layers) through "
        f"generate with patch embeddings")
    _generate_leg(card, "qwen2-vl", params, cfg,
                  family_batch(cfg, 8, VLM_TEXT, seed=11), 64, base)
    del params


def _audio_phases(card: str) -> None:
    from repro_torch.configs import get_config

    log("phase 4d: whisper-base, whole (encoder over 1500 stub frames, "
        "cross-attention), cuda kernels against the plain path")
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_config("whisper-base"), dtype=dtype)
        params = None
        params, base = _make_params(card, cfg)
        check_routes(card, cfg, params, family_batch(cfg, 2, 4, seed=13))
    log("phase 5i: audio path, whisper-base through generate with stub "
        "frames")
    _generate_leg(card, "whisper", params, cfg,
                  family_batch(cfg, 8, 4, seed=14), 128, base, max_len=448)
    del params


def hybrid_period(dtype: str):
    """:data:`HYBRID_LAYERS` layers of jamba-1.5-large in ``dtype``, every
    width as published, holding :data:`HYBRID_EXPERTS` of its 16 experts."""
    from repro_torch.configs import get_config

    full = get_config("jamba-1.5-large-398b")
    return dataclasses.replace(
        full, n_layers=HYBRID_LAYERS, dtype=dtype,
        moe=dataclasses.replace(full.moe, n_experts=HYBRID_EXPERTS[dtype]))


def _expert_bytes(params) -> int:
    """Bytes of the routed experts' weights (the MoE layers' wi and wo)."""
    return sum(_param_bytes({k: blk["moe"][k] for k in ("wi", "wo")})
               for blk in params["blocks"] if "moe" in blk)


def _hybrid_phases(card: str) -> None:
    log(f"phase 4d: jamba-1.5-large, one full-width period ({HYBRID_LAYERS} "
        f"layers: SSM, MoE and attention), cuda kernels against the plain "
        f"path")
    for dtype in ("float32", "bfloat16"):
        cfg = hybrid_period(dtype)
        params = None
        params, base = _make_params(card, cfg)
        held = cfg.moe.n_experts
        whole = _param_bytes(params) + _expert_bytes(params) * (16 - held) / held
        log(f"  {held} of 16 experts held (a {16 // held}-way expert split); "
            f"the period with all 16 would be {whole / 1e9:.2f} GB [{card}]")
        check_routes(card, cfg, params, family_batch(cfg, 2, 256, seed=15))
    log("phase 5j: hybrid path, the jamba period behind the dense, paged, "
        "overlap and audited paged batchers")
    serve_hybrid_path(card, params, cfg, base)


# ---------------------------------------------------------------------------
# phase 6: where the time goes (a traced window of the same requests)
# ---------------------------------------------------------------------------


# the SSD scan's bf16 passes, in launch order

# ---------------------------------------------------------------------------
# training: the flash kernel's log-sum-exp, FlashAttentionFn, the train step
# (phase 4e), full-width training (phase 5l) and its trace
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 8, 512          # phase 5l's batch: 8 rows of 512 tokens
TRAIN_LR = 1e-3                    # phase 5l: constant, on a fixed batch
# phase 4e: one AdamW step moves an element by about +-lr whatever its
# gradient's size (m_hat / sqrt(v_hat) = sign(g) at the first step), so a
# gradient at rounding level whose sign parts the two routes parts the
# params by 2 lr; at this lr that stays inside the reference test's atol
# (1e-4; tests/test_attention.py::TestFlashVJP::test_train_step_with_flash_impl)
CHECK_LR = 4e-5
GRAD_CASES = ((True, None, 0), (False, None, 0), (True, 16, 0), (True, None, 32))


def check_flash_lse(gen):
    """The flash kernel's log-sum-exp (``return_lse=True``) against the
    plain version's (``ref.flash_attention_ref``) and, for its units,
    against the reference's blockwise ``_flash_fwd_lse`` in torch, with
    the output on every row that has a valid key: the training shape
    (8 x 512, 16:8, dh 128), windowed, q_offset > 0, ragged, GQA 8:1 at dh
    64, non-causal, and rows without a valid key (-1e30 in both), each in
    f32 (<= F32_TOL) and bf16 (<= BF16_TOL).  Returns the worst LSE error."""
    import torch

    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.models.attention import _flash_fwd_lse

    f32, bf16 = torch.float32, torch.bfloat16
    B, S, H, Hkv, dh = (TRAIN_B, TRAIN_S) + (16, 8, 128)
    cases = [("train 8x512 16:8", B, S, S, H, Hkv, dh, {}),
             ("window=64", 2, S, S, H, Hkv, dh, dict(window=64)),
             ("q_offset=200", 2, 100, 300, H, Hkv, dh, dict(q_offset=200)),
             ("ragged Sq=Sk=77", 3, 77, 77, H, Hkv, dh, {}),
             ("gqa 8:1 dh=64", 2, 96, 96, 8, 1, 64, {}),
             ("non-causal", 2, 130, 200, H, Hkv, dh, dict(causal=False)),
             ("rows without keys", 2, 96, 40, H, Hkv, dh, dict(window=16))]
    worst = 0.0
    for dtype, tag, tol in ((f32, "f32", F32_TOL), (bf16, "bf16", BF16_TOL)):
        for name, b, sq, sk, h, hkv, d, kw in cases:
            causal = kw.get("causal", True)
            window, q_offset = kw.get("window"), kw.get("q_offset", 0)
            q = _rand(gen, (b, sq, h, d), dtype)
            k = _rand(gen, (b, sk, hkv, d), dtype)
            v = _rand(gen, (b, sk, hkv, d), dtype)
            out, lse = ops.flash_attention(q, k, v, causal=causal,
                                           window=window, q_offset=q_offset,
                                           return_lse=True)
            want, want_lse = ref.flash_attention_ref(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=causal, window=window, q_offset=q_offset,
                return_lse=True)
            want, want_lse = want.transpose(1, 2), want_lse.transpose(1, 2)
            _, blk_lse = _flash_fwd_lse(q.float(), k.float(), v.float(),
                                        causal=causal, window=window,
                                        q_offset=q_offset, block_k=512)
            torch.cuda.synchronize()
            live = want_lse > -1e29                       # (B, Sq, H)
            err = (lse - want_lse).abs().max().item()
            units = (blk_lse - want_lse).abs().max().item()
            out_err = ((out.float() - want.float()).abs().amax(-1)
                       * live).max().item()
            worst = max(worst, err)
            log(f"  flash lse {name:<20} {tag:<4} lse err={err:.3e} "
                f"(blockwise units {units:.3e}) out err={out_err:.3e} on "
                f"{int(live.sum())} of {live.numel()} rows (tol {tol:g})")
            check(lse.dtype == torch.float32 and lse.shape == (b, sq, h),
                  f"flash lse {name} {tag}: {lse.dtype} {tuple(lse.shape)}")
            check(bool(torch.isfinite(lse).all()), f"flash lse {name}: non-finite")
            check(err <= tol and units <= F32_TOL,
                  f"flash lse {name} {tag}: error {err}, units {units}")
            check(out_err <= tol, f"flash lse {name} {tag}: out error {out_err}")
            if not bool(live.all()):
                check(bool((lse[~live] == -1e30).all()),
                      f"flash lse {name} {tag}: a row without keys is not -1e30")
    return worst


def check_flash_grads(gen):
    """``FlashAttentionFn`` (the kernel's forward with its LSE, the torch
    backward) against autograd through ``naive_attention`` on f32 copies of
    the same inputs, in the reference test's four cases (causal;
    non-causal; window 16; q_offset 32) at dh 128, 2 x 96 rows, 4:2 heads,
    key blocks of 40 (a padded tail).  The loss is sum(out^2).  Error: max
    |dq, dk, dv - reference| over the reference's largest magnitude, <= 2e-4
    in f32 (the reference test's tolerance) and <= BF16_TOL in bf16 (the
    output and the gradients are rounded to bf16).  Returns the worst."""
    import torch

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.attention import flash_attention_train, naive_attention

    worst = {}
    n0 = ops.flash_attention.launches
    for dtype, tag, tol in ((torch.float32, "f32", 2e-4),
                            (torch.bfloat16, "bf16", BF16_TOL)):
        for causal, window, q_offset in GRAD_CASES:
            B, Sq, H, Hkv, dh = 2, 96, 4, 2, 128
            Sk = Sq + q_offset
            base = [_rand(gen, (B, s, h, dh), dtype)
                    for s, h in ((Sq, H), (Sk, Hkv), (Sk, Hkv))]
            ins = [t.clone().requires_grad_(True) for t in base]
            out = flash_attention_train(*ins, causal=causal, window=window,
                                        q_offset=q_offset, block_k=40)
            got = torch.autograd.grad((out.float() ** 2).sum(), ins)
            refs = [t.float().requires_grad_(True) for t in base]
            want_out = naive_attention(*refs, causal=causal, window=window,
                                       q_offset=q_offset)
            want = torch.autograd.grad((want_out ** 2).sum(), refs)
            torch.cuda.synchronize()
            errs = [((g.float() - w).abs().max() / w.abs().max()).item()
                    for g, w in zip(got, want)]
            label = f"causal={causal} window={window} q_offset={q_offset}"
            log(f"  FlashAttentionFn {tag:<4} {label:<38} rel err dq "
                f"{errs[0]:.2e} dk {errs[1]:.2e} dv {errs[2]:.2e} (tol {tol:g})")
            check(all(e <= tol for e in errs),
                  f"FlashAttentionFn {tag} {label}: gradient error {errs}")
            worst[tag] = max(worst.get(tag, 0.0), *errs)
    check(ops.flash_attention.launches - n0 == 2 * len(GRAD_CASES),
          "FlashAttentionFn did not launch the kernel once a forward")
    return worst


def _leaf_rel_err(a, b) -> float:
    """max |a - b| over max |b| of one leaf (0 for an all-zero ``b``)."""
    d = (a.float() - b.float()).abs().max().item()
    m = b.float().abs().max().item()
    return d / m if m > 0 else d


def check_train_routes(card: str, arch: str, *, n_layers: int = 2, B: int = 4,
                       S: int = 256):
    """Phase 4e: ``arch`` at full width cut to ``n_layers``, f32 (TF32 off):
    the loss and gradients of ``attn_impl="flash"`` (the kernel) against
    ``"torch"`` before the update (each leaf's error relative to its largest
    magnitude <= F32_TOL), then one ``make_train_step`` step of each at
    ``CHECK_LR``: loss, aux and grad norm within 1e-5 relative, updated
    params within rtol 1e-3, atol 1e-4; the flash kernel launched once an
    attention layer a pass."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.training import (
        TrainerConfig, batch_to_torch, make_loss_fn, make_train_step,
        value_and_grad)
    from repro_torch.tree import flatten_with_path

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                              dtype="float32")
    params = init_params(cfg, 0, device="cuda")
    opt = adamw_init(params)
    batch = batch_to_torch(make_batch(cfg, seq_len=S, batch=B, step=0), "cuda")
    n_attn, _ = _layer_counts(cfg)
    tcfgs = {impl: TrainerConfig(attn_impl=impl, lr=CHECK_LR, loss_chunk=128)
             for impl in ("torch", "flash")}

    (_, m_t), g_t = value_and_grad(make_loss_fn(cfg, tcfgs["torch"]), params,
                                   batch)
    fa_ops.flash_attention.launches = 0
    (_, m_f), g_f = value_and_grad(make_loss_fn(cfg, tcfgs["flash"]), params,
                                   batch)
    torch.cuda.synchronize()
    check(fa_ops.flash_attention.launches == n_attn,
          f"{arch} train: {fa_ops.flash_attention.launches} flash launches "
          f"in a pass, expected {n_attn}")
    worst_g, worst_key = 0.0, ""
    for (key, a), (_, b) in zip(flatten_with_path(g_f), flatten_with_path(g_t)):
        e = _leaf_rel_err(a, b)
        if e > worst_g:
            worst_g, worst_key = e, key
    del g_t, g_f
    log(f"  {arch} {n_layers} layers f32, {B} x {S}: loss flash "
        f"{float(m_f['loss']):.6f} torch {float(m_t['loss']):.6f}, aux "
        f"{float(m_f['aux']):.6f} / {float(m_t['aux']):.6f}; gradients: worst "
        f"leaf {worst_key} at {worst_g:.3e} of its largest (tol {F32_TOL:g})")
    check(worst_g <= F32_TOL, f"{arch} train: gradient error {worst_g} "
          f"at {worst_key}")

    out = {}
    for impl in ("torch", "flash"):
        p_new, _, m = make_train_step(cfg, tcfgs[impl])(params, opt, batch)
        if impl == "torch":
            out = (p_new, m)
            continue
        p_ref, m_ref = out
        for key in ("loss", "aux", "grad_norm"):
            a, b = float(m[key]), float(m_ref[key])
            check(abs(a - b) <= 1e-5 * max(abs(b), 1e-6),
                  f"{arch} train step: {key} {a} vs {b}")
        worst_p = 0.0
        for (key, a), (_, b) in zip(flatten_with_path(p_new),
                                    flatten_with_path(p_ref)):
            d = ((a.float() - b.float()).abs()
                 - 1e-3 * b.float().abs()).max().item()
            worst_p = max(worst_p, d)
            check(d <= 1e-4, f"{arch} train step: {key} parts by {d} beyond "
                  f"rtol 1e-3")
        log(f"  {arch} train step at lr {CHECK_LR:g}: grad_norm "
            f"{float(m['grad_norm']):.6f} / {float(m_ref['grad_norm']):.6f}, "
            f"params within rtol 1e-3 + {worst_p:.2e} (atol 1e-4) [{card}]")
    del params, opt, out
    _free_device_memory()


def _train_leg(step_fn, params, opt, batch, n_steps: int, *, on_step=None):
    """``n_steps`` of ``step_fn`` from (params, opt) on ``batch``: returns
    (params, opt, losses, grad norms, wall s of the steps after the first,
    peak device memory).  ``on_step(i, params, opt)`` runs after step i."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, t1 = [], [], None
    for i in range(n_steps):
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if i == 0:
            t1 = time.perf_counter()
        if on_step is not None:
            on_step(i + 1, params, opt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1 if n_steps > 1 else float("nan")
    return params, opt, losses, norms, wall, torch.cuda.max_memory_allocated()


def serve_train_path(card: str):
    """Phase 5l: qwen3-0.6b uncut, bf16 params, f32 moments,
    ``attn_impl="flash"``, on ``make_batch(seq_len=512, batch=8, seed=0)``
    (step 0's batch, fixed): (a) 10 steps, the loss finite and falling;
    (b) ``grad_accum=2`` against (a)'s first step; (c) ``remat="full"``:
    loss equal to (a)'s first, peak memory below (a)'s; (d)
    ``quantize_opt=True``: peak memory lower by about the moments' (8 -
    2.03) B a parameter; (e) 5 steps as (a)'s, an ``AsyncCheckpointer``
    save after the fifth, restored into fresh tensors bit for bit, and the
    next step's loss from it against (a)'s sixth.  Flash launches = 28 x
    steps x microbatches (x 2 under full remat).  Returns (the flash
    launches of (a), params, cfg, batch) for the trace."""
    import shutil

    import torch

    from repro_torch.checkpoint import AsyncCheckpointer, restore
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.training import (
        TrainerConfig, batch_to_torch, make_train_step)
    from repro_torch.tree import flatten_with_path, tree_map

    cfg = get_config("qwen3-0.6b")
    L = cfg.n_layers
    params0 = init_params(cfg, 0, device="cuda")
    batch = batch_to_torch(make_batch(cfg, seq_len=TRAIN_S, batch=TRAIN_B,
                                      step=0, seed=0), "cuda")
    n_param = sum(t.numel() for _, t in flatten_with_path(params0))
    pbytes = _param_bytes(params0)
    tokens = TRAIN_B * TRAIN_S

    def step_fn(**kw):
        return make_train_step(cfg, TrainerConfig(
            attn_impl="flash", lr=TRAIN_LR, loss_chunk=128, **kw))

    # warm-up: cuBLAS handles and lazily loaded kernels out of the legs
    make_train_step(cfg, TrainerConfig(attn_impl="flash", loss_chunk=128))(
        params0, adamw_init(params0), batch)
    _free_device_memory()

    n_a = 10
    fa_ops.flash_attention.launches = 0
    base = torch.cuda.memory_allocated()
    _, _, loss_a, norm_a, wall_a, peak_a = _train_leg(
        step_fn(), params0, adamw_init(params0), batch, n_a)
    fa_a = fa_ops.flash_attention.launches
    state_bytes = pbytes + 8 * n_param            # params + f32 m and v
    log(f"  (a) {n_a} steps of {TRAIN_B} x {TRAIN_S} on one batch: loss "
        f"{loss_a[0]:.4f} -> {loss_a[-1]:.4f}, grad norm {norm_a[0]:.3f} -> "
        f"{norm_a[-1]:.3f}; {(n_a - 1) * tokens / wall_a:,.0f} tokens/s, "
        f"{wall_a / (n_a - 1) * 1e3:.1f} ms a step; peak {_gib(peak_a)} "
        f"({_gib(peak_a - base)} above the params and batch held before "
        f"it); params {_gib(pbytes)} + grads {_gib(pbytes)} + f32 moments "
        f"{_gib(8 * n_param)} = {_gib(state_bytes + pbytes)}; flash launches "
        f"{fa_a} (= {L} x {n_a}) [{card}]")
    check(all(np.isfinite(loss_a)), f"(a) non-finite loss {loss_a}")
    check(loss_a[-1] < loss_a[0], f"(a) the loss did not fall: {loss_a}")
    check(fa_a == L * n_a, f"(a) flash launches {fa_a} != {L} x {n_a}")

    fa_ops.flash_attention.launches = 0
    _, _, loss_b, norm_b, _, peak_b = _train_leg(
        step_fn(grad_accum=2), params0, adamw_init(params0), batch, 1)
    fa_b = fa_ops.flash_attention.launches
    db = abs(loss_b[0] - loss_a[0]) / loss_a[0]
    dn = abs(norm_b[0] - norm_a[0]) / norm_a[0]
    log(f"  (b) grad_accum=2: loss {loss_b[0]:.5f} vs {loss_a[0]:.5f} "
        f"(rel {db:.2e}), grad norm {norm_b[0]:.4f} vs {norm_a[0]:.4f} (rel "
        f"{dn:.2e}), tol {BF16_TOL:g}; peak {_gib(peak_b)}")
    check(db <= BF16_TOL and dn <= BF16_TOL, "(b) grad_accum=2 parts from (a)")
    check(fa_b == L * 2, f"(b) flash launches {fa_b} != {L} x 2")

    fa_ops.flash_attention.launches = 0
    _, _, loss_c, norm_c, _, peak_c = _train_leg(
        step_fn(remat="full"), params0, adamw_init(params0), batch, 1)
    fa_c = fa_ops.flash_attention.launches
    dn = abs(norm_c[0] - norm_a[0]) / norm_a[0]
    log(f"  (c) remat=full: loss {loss_c[0]:.5f} vs {loss_a[0]:.5f}, grad "
        f"norm rel {dn:.2e}; peak {_gib(peak_c)} vs (a)'s {_gib(peak_a)}; "
        f"flash launches {fa_c} (= 2 x {L}: each layer's forward runs again "
        f"in the backward)")
    check(loss_c[0] == loss_a[0], "(c) remat=full changed the loss")
    check(dn <= BF16_TOL, "(c) remat=full parts the grad norm from (a)")
    check(peak_c < peak_a, "(c) remat=full did not lower the peak")
    check(fa_c == 2 * L, f"(c) flash launches {fa_c} != 2 x {L}")

    opt_q = adamw_init(params0, quantize=True)
    qbytes = sum(t.numel() * t.element_size()
                 for _, t in flatten_with_path((opt_q.m, opt_q.v)))
    _, _, loss_d, _, _, peak_d = _train_leg(
        step_fn(quantize_opt=True), params0, opt_q, batch, 1)
    del opt_q
    saved = peak_a - peak_d
    want = 8 * n_param - qbytes
    log(f"  (d) quantize_opt: loss {loss_d[0]:.5f}; peak {_gib(peak_d)}, "
        f"{_gib(saved)} below (a)'s; the moments' own saving {_gib(want)} "
        f"({qbytes / n_param:.3f} B a parameter against 8)")
    # at the backward's peak one set of moments is alive; at the update's,
    # the old and the new: the saving is one to two times the moments'
    check(saved >= 0.5 * want,
          f"(d) quantized moments saved {saved} bytes, expected about {want}")

    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt = AsyncCheckpointer(str(ckpt_dir))
    held = {}

    def save_at_5(i, params, opt):
        if i == 5:
            t0 = time.perf_counter()
            ckpt.save_async(5, {"params": params, "opt": opt})
            held["snapshot_s"] = time.perf_counter() - t0
            held["state"] = {"params": params, "opt": opt}

    fa_ops.flash_attention.launches = 0
    _train_leg(step_fn(), params0, adamw_init(params0), batch, 5,
               on_step=save_at_5)
    t0 = time.perf_counter()
    ckpt.wait()
    write_s = time.perf_counter() - t0
    like = tree_map(torch.empty_like, held["state"])
    t0 = time.perf_counter()
    got = restore(str(ckpt_dir), like)
    restore_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        flatten_with_path(got), flatten_with_path(held["state"])))
    check(same, "(e) the restored state is not bit-equal to step 5's")
    del held["state"], like
    _, _, loss_e, _, _, _ = _train_leg(step_fn(), got["params"], got["opt"],
                                       batch, 1)
    fa_e = fa_ops.flash_attention.launches
    de = abs(loss_e[0] - loss_a[5]) / loss_a[5]
    log(f"  (e) AsyncCheckpointer at step 5 ({_gib(state_bytes)}): snapshot "
        f"{held['snapshot_s']:.2f} s on the caller's thread, write finished "
        f"{write_s:.2f} s after the fifth step, restore {restore_s:.2f} s, "
        f"bit-equal; the next loss {loss_e[0]:.5f} vs the uninterrupted "
        f"run's {loss_a[5]:.5f} (rel {de:.2e}, tol {BF16_TOL:g}); flash "
        f"launches {fa_e} (= {L} x 6)")
    check(de <= BF16_TOL, "(e) the resumed step parts from the uninterrupted")
    check(fa_e == L * 6, f"(e) flash launches {fa_e} != {L} x 6")
    del got
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    _free_device_memory()
    return fa_a, params0, cfg, batch


def trace_train_window(card: str, params, cfg, batch, n_steps: int = 3):
    """Phase 6 (training): ``n_steps`` of phase 5l's step, untraced (after
    one window that warms the allocator), then under ``torch.profiler``
    (device and host activity): device busy time,
    the idle share against the untraced wall time, and device time split
    into the flash forward (its kernels), the flash backward in torch (the
    kernels of ops inside ``FlashAttentionFn.backward``'s
    ``flash.backward`` range), the optimizer (clip and AdamW, the
    ``train.optimizer`` range of ``training.make_train_step``), cuBLAS and
    the rest (elementwise, reductions, copies).  Fails unless the flash
    kernel and the backward range ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.optim import adamw_init
    from repro_torch.training import TrainerConfig, make_train_step

    step = make_train_step(cfg, TrainerConfig(attn_impl="flash", lr=TRAIN_LR,
                                              loss_chunk=128))

    def window():
        p, o = params, adamw_init(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            p, o, _ = step(p, o, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    window()          # regrows the allocator's cache emptied after 5l
    clean = window()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = window()
    spans, by_class = [], {}
    bwd = "flash backward (torch)"
    scopes = {"flash.backward": bwd,
              "train.optimizer": "optimizer (clip + AdamW)"}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CPU:
            scope = evt.cpu_parent
            while scope is not None and scope.name not in scopes:
                scope = scope.cpu_parent
            if scope is not None:
                cls = scopes[scope.name]
                for k in evt.kernels:
                    by_class[cls] = by_class.get(cls, 0.0) + k.duration
                    old = _kernel_class(k.name)
                    by_class[old] = by_class.get(old, 0.0) - k.duration
            continue
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or evt.name in scopes):
            continue
        start, end = evt.time_range.start, evt.time_range.end
        if end <= start:
            continue
        spans.append((start, end))
        cls = _kernel_class(evt.name)
        by_class[cls] = by_class.get(cls, 0.0) + (end - start)
    if not spans:
        log("  train window: device time not measured: the profiler saw no "
            "CUDA kernels")
        return
    busy = _union_ms(spans)
    log(f"  train window, {n_steps} steps of {TRAIN_B} x {TRAIN_S}: "
        f"{len(spans)} device kernels, device busy {busy:.1f} ms "
        f"({busy / n_steps:.1f} a step); wall {clean:.3f} s untraced "
        f"({traced:.3f} s traced) -> device idle share "
        f"{1 - busy * 1e-3 / clean:.3f} [{card}]")
    total = sum(by_class.values())
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        log(f"    {cls:<42} {us * 1e-3:9.2f} ms  {us / total:6.1%} of "
            f"kernel time")
    check(by_class.get("flash_attention", 0) > 0,
          "train window: the flash kernel did not run")
    check(by_class.get(bwd, 0) > 0,
          "train window: no device time in the flash backward range")


# ---------------------------------------------------------------------------
# phase 5m: the cell matrix on meta, and three full-width qwen3-0.6b cells
# on the card against their roofline
# ---------------------------------------------------------------------------


# the dry-run's full sweep traces 33 programs (a few minutes of host time:
# PERF.md), so the card's run traces one cell a family, every kind among
# them, and checks the 7 skips of the other
SWEEP_CELLS = (("qwen3-0.6b", "train_4k"), ("deepseek-moe-16b", "decode_32k"),
               ("mamba2-370m", "long_500k"),
               ("jamba-1.5-large-398b", "decode_32k"),
               ("qwen2-vl-72b", "decode_32k"), ("whisper-base", "prefill_32k"))
FULL_ATTENTION = ("command-r-plus-104b", "qwen3-0.6b", "starcoder2-7b",
                  "qwen3-32b", "deepseek-moe-16b", "qwen2-vl-72b",
                  "whisper-base")
# (shape, one-card batch, route): each cell's seq_len kept, its batch cut
CARD_CELLS = (("prefill_32k", 1, "cuda"), ("decode_32k", 8, "cuda"),
              ("train_4k", 2, "flash"))
# timed calls a cell, after two warm-up calls: 3 keep the whole script
# within its time budget
CELL_CALLS = 3
CELL_REF_ROWS = 512            # prefill's gate: the last query rows


def cell_sweep(card: str) -> None:
    """Phase 5m (a): the dry-run of ``SWEEP_CELLS`` at full width on meta
    tensors (``repro_torch.launch.dryrun.run_cell``, traced once, laid out
    over pod16x16 and pod2x16x16), one line a cell; gates: every cell
    traces, 0 < useful_flops_ratio < 1.25, and the skips of the 40 are the
    7 full-attention archs at long_500k, as ``cell_status`` says."""
    from repro_torch.configs import ARCHS, SHAPES, cell_status
    from repro_torch.launch import dryrun

    skips = {(a, s) for a in ARCHS for s in SHAPES
             if not cell_status(a, s)[0]}
    check(skips == {(a, "long_500k") for a in FULL_ATTENTION},
          f"cell_status skips {sorted(skips)}")
    out = ROOT / "build" / "dryrun_torch"
    t0 = time.perf_counter()
    for arch, shape in SWEEP_CELLS:
        traced = {}
        one, two = (dryrun.run_cell(arch, shape, multi_pod=mp, out_dir=str(out),
                                    skip_existing=False, traced=traced)
                    for mp in (False, True))
        check(one["ok"] and two["ok"] and not one.get("skipped"),
              f"dry-run {arch} {shape}: {one.get('error') or two.get('error')}")
        roof = one["roofline"]
        check(0 < roof["useful_flops_ratio"] < 1.25,
              f"dry-run {arch} {shape}: useful_flops_ratio "
              f"{roof['useful_flops_ratio']}")
        log(f"  sweep {arch} {shape}: {roof['hlo_flops']:.4e} FLOP, "
            f"{roof['hlo_bytes']:.4e} B, bound {roof['bound']}, t_bound "
            f"{one['t_bound'] * 1e3:.3f} ms on 256 chips, useful "
            f"{roof['useful_flops_ratio']:.3f}, args/device "
            f"{_gib(one['argument_bytes_per_device'])} (pod16x16) "
            f"{_gib(two['argument_bytes_per_device'])} (pod2x16x16), traced "
            f"in {one['trace_s']:.1f} s")
    log(f"  sweep of {len(SWEEP_CELLS)} cells in {time.perf_counter() - t0:.1f}"
        f" s; {len(skips)} cells skipped by design (long_500k on the "
        f"full-attention archs)")


def _median_ms(fn, n: int = CELL_CALLS) -> tuple:
    """(median, all) ms of ``n`` calls of ``fn`` after two warm-up calls,
    each bracketed by CUDA events on the current stream."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), times


def _card_cell(card: str, shape_name: str, batch: int, route: str):
    """One full-width qwen3-0.6b cell on cuda:0 with its batch cut to
    ``batch``: the analyzer's count of the same program on the same route
    (meta tensors, the kernels through their ``cost``), then the median
    ms a call, launches, peak memory, and the roofline at chips = 1.
    Returns (row, cell, its arguments on the card)."""
    import torch

    from repro_torch.configs import SHAPES
    from repro_torch.distributed.op_analysis import Roofline
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.cells import argument_bytes_per_device, build_cell
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.tree import leaves

    full = SHAPES[shape_name]
    shape = dataclasses.replace(full, global_batch=batch)
    cell = build_cell("qwen3-0.6b", shape, make_host_mesh(device="cuda"),
                      attn_impl=route)
    cost = cell.analyze()
    roof = Roofline(chips=1, hlo_flops=cost.flops, hlo_bytes=cost.bytes,
                    collective_bytes=None, model_flops=cell.model_flops)
    args_bytes = argument_bytes_per_device(cell, cost)
    log(f"  {shape_name} (batch {full.global_batch} -> {batch}, seq_len "
        f"{shape.seq_len} kept), route {route!r}: analyzer {cost.flops:.4e} "
        f"FLOP, {cost.bytes:.4e} B ({cost.ops} aten ops traced in "
        f"{cost.trace_s:.1f} s; kernels "
        f"{ {k: v[0] for k, v in cost.kernels.items()} })")
    _free_device_memory()
    args = cell.materialize("cuda", seed=0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    kernel = fa_ops.flash_attention if shape.kind != "decode" else da_ops.decode_attention
    L = cell.cfg.n_layers
    want = {"prefill": L, "decode": L, "train": 2 * L}[shape.kind]
    kernel.launches = 0
    out = cell.run(*args)
    torch.cuda.synchronize()
    # the floor no program can beat, whatever it fuses: every argument it
    # reads read once, every output it makes (not an argument updated in
    # place) written once, and the model's matmul FLOPs
    held = {t.untyped_storage().data_ptr() for t in leaves(args)
            if isinstance(t, torch.Tensor)}
    out_bytes = sum(t.numel() * t.element_size() for t in leaves(out)
                    if isinstance(t, torch.Tensor)
                    and t.untyped_storage().data_ptr() not in held)
    del out
    floor_ms, floor_by = bound_ms(args_bytes + out_bytes, cell.model_flops)
    check(kernel.launches == want, f"{shape_name}: {kernel.launches} "
          f"{kernel.__name__} launches a call, expected {want}")
    check(cost.kernels.get(kernel.__name__, [0])[0] == want,
          f"{shape_name}: the analyzer counted "
          f"{cost.kernels.get(kernel.__name__)} {kernel.__name__} calls")
    torch.cuda.reset_peak_memory_stats()
    ms, times = _median_ms(lambda: cell.run(*args))
    peak = torch.cuda.max_memory_allocated()
    # the cell's own peak: its arguments plus what its calls added above
    # everything allocated before them (earlier phases' tensors included)
    own = args_bytes + peak - base
    mfu = cell.model_flops / (ms * 1e-3 * BF16_FLOPS_PER_S)
    row = dict(cell=shape_name, batch=batch, seq_len=shape.seq_len,
               route=route, ms=ms, ms_min=min(times), ms_max=max(times),
               flops=cost.flops, bytes=cost.bytes, t_compute_ms=roof.t_compute * 1e3,
               t_memory_ms=roof.t_memory * 1e3, bound=roof.bound,
               t_bound_ms=roof.t_bound * 1e3, bound_share=roof.t_bound * 1e3 / ms,
               output_bytes=out_bytes, floor_ms=floor_ms, floor_by=floor_by,
               floor_share=floor_ms / ms, model_flops=cell.model_flops, mfu=mfu, peak_bytes=peak,
               base_bytes=base, own_peak_bytes=own, argument_bytes=args_bytes,
               peak_live_bytes=cost.peak_live_bytes, launches=want)
    log(f"  {shape_name}: {ms:.3f} ms a call (median of {len(times)}, "
        f"{min(times):.3f}-{max(times):.3f}); t_compute {row['t_compute_ms']:.3f}"
        f" ms, t_memory {row['t_memory_ms']:.3f} ms, bound {roof.bound}, "
        f"t_bound {row['t_bound_ms']:.3f} ms = {row['bound_share']:.3f} of the "
        f"call (the eager program's own count, not a floor); floor "
        f"{floor_ms:.3f} ms ({floor_by}: {_gib(args_bytes)} read + "
        f"{_gib(out_bytes)} written once, model FLOPs) = "
        f"{row['floor_share']:.3f} of the call; MFU {mfu:.4f} ({cell.model_flops:.4e} model FLOP); peak "
        f"{_gib(peak)} ({_gib(base)} allocated before the calls): the "
        f"cell's own {_gib(own)} ({_gib(args_bytes)} of arguments + "
        f"{_gib(peak - base)}) against the analyzer's "
        f"{_gib(cost.peak_live_bytes)} peak live; {want} {kernel.__name__} "
        f"launches a call [{card}]")
    return row, cell, args


def _gate_prefill(card: str, cell, args) -> None:
    """The flash kernel at the prefill cell's attention shape (1 x 32,768,
    16:8, dh 128, causal, bf16, seeded inputs) against its plain version on
    the last ``CELL_REF_ROWS`` query rows over all keys (the plain version
    over all 32,768 rows would hold 68.7 GB of scores a layer); and the
    cell's logits finite."""
    import torch

    from repro_torch.kernels.flash_attention import ops, ref

    cfg, S = cell.cfg, cell.shape.seq_len
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    B = cell.shape.global_batch
    q = _rand(gen, (B, S, cfg.n_heads, cfg.d_head), torch.bfloat16)
    k = _rand(gen, (B, S, cfg.n_kv_heads, cfg.d_head), torch.bfloat16)
    v = _rand(gen, (B, S, cfg.n_kv_heads, cfg.d_head), torch.bfloat16)
    got = ops.flash_attention(q, k, v)[:, -CELL_REF_ROWS:]
    want = ref.flash_attention_ref(
        q[:, -CELL_REF_ROWS:].transpose(1, 2), k.transpose(1, 2),
        v.transpose(1, 2), q_offset=S - CELL_REF_ROWS).transpose(1, 2)
    err = _err(got, want)
    log(f"  prefill gate: flash at {B} x {S}, last {CELL_REF_ROWS} rows "
        f"against the plain version: max_abs_err={err:.3e} (tol {BF16_TOL:g})")
    check(err <= BF16_TOL, f"prefill cell: flash error {err} > {BF16_TOL}")
    logits, _ = cell.run(*args)
    check(bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
          "prefill cell: non-finite logits")
    check(logits.shape == (B, cfg.vocab_padded), f"prefill cell: logits "
          f"{tuple(logits.shape)}")


def _decode_logits(cell, args, impl: str):
    """(tokens, logits) of one step of the decode cell's program on
    ``args`` with the attention route ``impl``."""
    import torch

    from repro_torch.serving import ServeConfig, make_serve_step

    step = make_serve_step(cell.cfg, ServeConfig(max_len=cell.shape.seq_len,
                                                 attn_impl=impl))
    with torch.no_grad():
        n, logits, _ = step(*args)
    return n, logits[:, :cell.cfg.vocab].float()


def _gate_decode(card: str, cell, args) -> tuple:
    """The decode cell in bf16 (the timed cell).  Gate: the decode kernel
    on layer 0 of the cell's 32,768-slot cache (every slot valid), with a
    seeded query, against its plain version on the same inputs in f32,
    within ``BF16_TOL`` of the plain output's largest magnitude.  Then one
    step of the cell's program on the kernel's route and on ``"torch"``:
    their logits and tokens are returned for :func:`_gate_decode_f32`,
    which holds both against the f32 program on the same inputs.
    Returns (dtypes of the params' leaves, of the caches' leaves, the two
    routes' (tokens, logits) on the host)."""
    import torch

    from repro_torch.kernels.decode_attention import ops, ref
    from repro_torch.tree import leaves

    cfg = cell.cfg
    B = cell.shape.global_batch
    kv = args[2].kv["0"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    q = _rand(gen, (B, cfg.n_heads, cfg.d_head), kv.k.dtype)
    got = ops.decode_attention(q, kv.k[0], kv.v[0], kv.pos[0], args[3])
    want = ref.decode_attention_ref(q.float(), kv.k[0], kv.v[0], kv.pos[0],
                                    args[3])
    rel, err = _rel_err(got, want), _err(got, want)
    log(f"  decode gate, kernel: decode_attention bf16 on layer 0 of the "
        f"cell's cache ({B} x {kv.k.shape[2]} slots, {cfg.n_heads}:"
        f"{cfg.n_kv_heads}, dh {cfg.d_head}) against its plain version in "
        f"f32: max |err| {rel:.3e} of the largest output "
        f"({want.abs().max().item():.3e}; _err {err:.3e}), tol {BF16_TOL:g}"
        f" [{card}]")
    check(rel <= BF16_TOL, f"decode cell: the kernel's error {rel} of the "
          f"largest output > {BF16_TOL}")
    del got, want
    routes = {impl: tuple(t.cpu() for t in _decode_logits(cell, args, impl))
              for impl in ("cuda", "torch")}
    diff = (routes["cuda"][1] - routes["torch"][1]).abs().max().item()
    log(f"  decode step, bf16: cuda against torch: max |logit diff| "
        f"{diff:.3e} ({diff / routes['torch'][1].abs().max().item():.3e} of "
        f"the largest), tokens equal on "
        f"{int((routes['cuda'][0] == routes['torch'][0]).sum())}/{B} rows")
    return ([t.dtype for t in leaves(args[0])],
            [t.dtype for t in leaves(args[2]) if isinstance(t, torch.Tensor)],
            routes)


def _gate_decode_f32(card: str, cell, bf16) -> None:
    """The decode cell in f32 after the bf16 cell is freed (the same seeds,
    a 60 GB cache).  Gate 1: the kernel's f32 route against ``"torch"``,
    phase 4's rule (logits within ``MODEL_TOL``, every token equal).  Then
    every param and cache leaf is rounded in place to its dtype in the bf16
    cell, which makes it the bf16 cell's inputs exactly (both draw f32 and
    cast), and ``"torch"`` in f32 on them is the reference of the two bf16
    routes of :func:`_gate_decode` (``bf16``).  Gate 2: the kernel's route
    within ``MOE_SPREAD`` x the plain route's distance to it (at least
    ``BF16_TOL``), both relative to its largest logit, as phase 4c holds
    the MoE kernels; each route's distance and tokens are logged."""
    import torch

    from repro_torch.tree import leaves

    cell32 = dataclasses.replace(cell, cfg=dataclasses.replace(
        cell.cfg, dtype="float32"))
    args = cell32.materialize("cuda", seed=0)
    n_k, l_k = _decode_logits(cell32, args, "cuda")
    n_t, l_t = _decode_logits(cell32, args, "torch")
    err = (l_k - l_t).abs().max().item()
    log(f"  decode gate, f32 (the same seeds, "
        f"{_gib(_param_bytes(args[2]))} of cache): max |logit diff| "
        f"{err:.3e} (tol {MODEL_TOL:g}), tokens equal on "
        f"{int((n_k == n_t).sum())}/{len(n_k)} rows [{card}]")
    check(err <= MODEL_TOL, f"decode cell f32: logits differ by {err}")
    check(bool((n_k == n_t).all()), "decode cell f32: tokens differ")
    del n_k, l_k, n_t, l_t
    param_dtypes, cache_dtypes, routes = bf16
    caches = [t for t in leaves(args[2]) if isinstance(t, torch.Tensor)]
    for ts, dts in ((leaves(args[0]), param_dtypes), (caches, cache_dtypes)):
        check(len(ts) == len(dts), "decode cell: the f32 and bf16 cells' "
              "trees differ")
        for t, dt in zip(ts, dts):
            if t.is_floating_point() and dt != t.dtype:
                for blk in (t if t.dim() > 2 else [t]):   # a layer at a time
                    blk.copy_(blk.to(dt))
    n_ref, l_ref = (t.cpu() for t in _decode_logits(cell32, args, "torch"))
    del args
    _free_device_memory()
    scale = l_ref.abs().max().item()
    dist = {impl: (l - l_ref).abs().max().item() / scale
            for impl, (_, l) in routes.items()}
    bound = MOE_SPREAD * max(dist["torch"], BF16_TOL)
    for impl, (n, _) in routes.items():
        log(f"  decode step, bf16 {impl!r} against f32 on the bf16 inputs: "
            f"max |logit diff| {dist[impl]:.3e} of the largest "
            f"({scale:.3e}), tokens equal on {int((n == n_ref).sum())}/"
            f"{len(n)} rows [{card}]")
    log(f"  decode gate, bf16 step: cuda {dist['cuda']:.3e} <= "
        f"{MOE_SPREAD:g} x max(torch {dist['torch']:.3e}, {BF16_TOL:g}) = "
        f"{bound:.3e}")
    check(dist["cuda"] <= bound, f"decode cell bf16: the kernel's route is "
          f"{dist['cuda']} from f32, bound {bound}")


def _kernel_alone(card: str, cell, args) -> dict:
    """The cell's attention kernel alone at the cell's shape: its device
    time (``device_ms``; inputs of two layers or two copies, over the L2)
    beside its bound from its ``cost``."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops

    cfg, shape = cell.cfg, cell.shape
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        kv = args[2].kv["0"]
        import torch

        gen = torch.Generator(device="cuda")
        gen.manual_seed(12)
        q = _rand(gen, (B, cfg.n_heads, cfg.d_head), kv.k.dtype)
        sets = [(q, kv.k[i], kv.v[i], kv.pos[i], args[3]) for i in (0, 1)]
        wrapper, kw = da_ops.decode_attention, {}
    else:
        import torch

        gen = torch.Generator(device="cuda")
        gen.manual_seed(12)
        dt = args[0]["embed"]["w"].dtype
        sets = copies_over_l2([
            _rand(gen, (B, S, cfg.n_heads, cfg.d_head), dt),
            _rand(gen, (B, S, cfg.n_kv_heads, cfg.d_head), dt),
            _rand(gen, (B, S, cfg.n_kv_heads, cfg.d_head), dt)])
        wrapper = fa_ops.flash_attention
        kw = {"return_lse": True} if shape.kind == "train" else {}
    ms = device_ms(lambda *a: wrapper(*a, **kw), sets, iters=10)
    bms, by = kernel_bound(wrapper, *sets[0], **kw)
    log(f"  {wrapper.__name__} alone at the {shape.name} cell's shape: "
        f"{ms:.3f} ms a call, bound {bms:.3f} ms ({by}) = {bms / ms:.3f} of "
        f"it [{card}]")
    return {"kernel": wrapper.__name__, "kernel_ms": ms, "kernel_bound_ms": bms,
            "kernel_bound_by": by}


def _gate_train(card: str) -> None:
    """The train cell's step in f32 (TF32 off) at its one-card shape (2 x
    4,096, full depth, remat full, its batch): one step on ``"flash"``
    against ``"torch"`` from the same params and batch, loss and grad norm
    within phase 4e's 1e-5 relative."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.launch.cells import trainer_defaults
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.training import batch_to_torch, make_train_step

    cfg = dataclasses.replace(get_config("qwen3-0.6b"), dtype="float32")
    params = init_params(cfg, 0, device="cuda")
    opt = adamw_init(params)
    batch = batch_to_torch(make_batch(cfg, seq_len=4096, batch=2, step=0),
                           "cuda")
    out = {}
    for impl in ("torch", "flash"):
        tcfg = dataclasses.replace(trainer_defaults(cfg, None, attn_impl=impl),
                                   lr=CHECK_LR)
        _, _, m = make_train_step(cfg, tcfg)(params, opt, batch)
        out[impl] = {k: float(m[k]) for k in ("loss", "grad_norm")}
        del m
        _free_device_memory()
    for key in ("loss", "grad_norm"):
        a, b = out["flash"][key], out["torch"][key]
        log(f"  train gate (f32, 2 x 4096): {key} flash {a:.7f} torch {b:.7f}"
            f" ({abs(a - b) / abs(b):.2e} relative, tol 1e-5) [{card}]")
        check(abs(a - b) <= 1e-5 * abs(b), f"train cell: {key} {a} vs {b}")
    del params, opt, batch
    _free_device_memory()


def serve_cells(card: str) -> list:
    """Phase 5m: the sweep on meta, then the three full-width qwen3-0.6b
    cells of ``CARD_CELLS`` on the card, each gated."""
    log("  (a) the dry-run sweep on meta tensors, full width")
    cell_sweep(card)
    log("  (b) full-width qwen3-0.6b cells on cuda:0, bf16")
    rows = []
    for shape_name, batch, route in CARD_CELLS:
        row, cell, args = _card_cell(card, shape_name, batch, route)
        row.update(_kernel_alone(card, cell, args))
        if shape_name == "prefill_32k":
            _gate_prefill(card, cell, args)
        elif shape_name == "decode_32k":
            bf16 = _gate_decode(card, cell, args)
        rows.append(row)
        del args
        _free_device_memory()
        if shape_name == "decode_32k":
            _gate_decode_f32(card, cell, bf16)
            _free_device_memory()
    _gate_train(card)
    log("  cells " + json.dumps({"card": card, "cells": rows}))
    return rows


# ---------------------------------------------------------------------------
# phase 5n: runtime SPMD over a gloo process group of ranks sharing the card
# ---------------------------------------------------------------------------

SPMD_TIMEOUT_S = 480.0
CUDA_CONTEXT_BYTES = 0.5 * 2**30    # a rank's CUDA context, reckoned


def spmd_job(cfg, device: str = "cuda", *, batch: int = 4, prompt: int = 512,
             max_len: int = 3072, steps: int = 4, train_seq: int = 256):
    """Phase 5n's sizes and config, passed to every rank (a spawned rank
    imports this script afresh, so nothing here may live in a global that
    a rehearsal patches)."""
    return dict(cfg=cfg, device=device, batch=batch, prompt=prompt,
                max_len=max_len, steps=steps, train_seq=train_seq, seed=0)


def _spmd_weights(job, dtype: str):
    """The weights every rank and the single-process reference make from
    the seed: bf16 from ``init_params``, cast to f32 for the f32 runs, so
    both dtypes hold the same values."""
    import torch

    from repro_torch.models import init_params
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(job["cfg"], dtype="bfloat16")
    params = init_params(cfg, job["seed"], device=job["device"])
    if dtype == "float32":
        params = tree_map(lambda t: t.float(), params)
    return params


def _spmd_prompts(job):
    import torch

    rng = np.random.default_rng(11)
    toks = rng.integers(0, job["cfg"].vocab, size=(job["batch"], job["prompt"]),
                        dtype=np.int32)
    return torch.from_numpy(toks).to(job["device"])


def _tree_nbytes(tree) -> int:
    from repro_torch.tree import leaves

    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if hasattr(t, "element_size"))


def _serve_run(job, cfg, params, batch, *, policy=None, mesh=None):
    """A prefill of ``batch`` (a prompt tensor, or the family's batch
    dict: tokens and extras) and ``job["steps"]`` greedy serve steps
    through ``make_prefill_step`` and ``make_serve_step`` on the kernels'
    route, each step timed (host clock around a synchronised step): the
    whole batch's tokens a step and, on rank 0 of a mesh or without one,
    the logits; the flash and SSD launches of the prefill and the decode
    and flash launches of each step, counted from 0 just before; each
    step's collectives."""
    import torch

    from repro_torch.distributed.spmd import gather_batch
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.serving.engine import (
        ServeConfig, make_prefill_step, make_serve_step)

    if isinstance(batch, torch.Tensor):
        batch = {"tokens": batch}
    toks = batch["tokens"]
    S = toks.shape[1] + (batch["extra_embeds"].shape[1]
                         if "extra_embeds" in batch else 0)

    cuda = job["device"] == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def whole(x):
        if mesh is None:
            return x
        return gather_batch(x, mesh, policy.batch_axes)

    keep_logits = mesh is None or mesh.coords == (0,) * len(mesh.coords)
    scfg = ServeConfig(max_len=job["max_len"], attn_impl="cuda")
    out = {"tokens": [], "logits": [], "ms": [], "coll_ms": [], "wire": [],
           "decode_launches": [], "step_flash_launches": []}
    with torch.no_grad():
        fa.flash_attention.launches = 0
        ssd_ops.ssd.launches = 0
        logits0, caches = make_prefill_step(cfg, scfg, policy=policy)(
            params, batch)
        sync()
        out["flash_launches"] = fa.flash_attention.launches
        out["ssd_launches"] = ssd_ops.ssd.launches
        tok = torch.argmax(logits0[..., :cfg.vocab], -1).to(torch.int32)
        first = whole(logits0)           # a collective: every rank joins
        out["first"] = first.float().cpu() if keep_logits else None
        out["t0"] = whole(tok).cpu()
        cur = torch.full((tok.shape[0],), S, dtype=torch.int32,
                         device=toks.device)
        step = make_serve_step(cfg, scfg, policy=policy)
        for i in range(job["steps"]):
            if policy is not None:
                policy.log.reset()
            da.decode_attention.launches = 0
            fa.flash_attention.launches = 0
            sync()
            t0 = time.perf_counter()
            tok, logits, caches = step(params, tok, caches, cur + i)
            sync()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["decode_launches"].append(da.decode_attention.launches)
            out["step_flash_launches"].append(fa.flash_attention.launches)
            if policy is not None:
                out["coll_ms"].append(policy.log.seconds * 1e3)
                out["wire"].append(dict(policy.log.wire))
            out["tokens"].append(whole(tok).cpu())
            lg = whole(logits)
            if keep_logits:
                out["logits"].append(lg.float().cpu())
    out["cache_bytes"] = _tree_nbytes(caches)
    return out


def _spmd_rank(rank: int, world: int, job):
    """One rank of phase 5n: legs (a) or (b) serve on ``job["shape"]``;
    leg (c) trains on a ("pod" 2) mesh."""
    import torch

    from repro_torch.distributed.spmd import (
        make_policy, param_shardings, shard_batch)
    from repro_torch.launch.mesh import make_host_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = job["device"] == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    out = {"rank": rank}
    if "shape" in job:
        mesh = make_host_mesh(job["shape"], device=job["device"])
        out["coords"] = mesh.coords
        for dt in job["dtypes"]:
            cfg = dataclasses.replace(job["cfg"], dtype=dt)
            pol = make_policy(cfg, mesh, batch=job["batch"], fsdp=False)
            params = param_shardings(cfg, mesh, _spmd_weights(job, dt),
                                     fsdp=False)
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            toks = shard_batch(_spmd_prompts(job), mesh, pol.batch_axes)
            res = _serve_run(job, cfg, params, toks, policy=pol, mesh=mesh)
            res.update(kv_len_sharded=pol.kv_len_sharded,
                       vocab_parallel=pol.vocab_parallel,
                       gathers_layers=pol.gathers_layers,
                       param_bytes=_tree_nbytes(params))
            if cuda:
                res["peak_bytes"] = torch.cuda.max_memory_allocated()
            out[dt] = res
            del params
    if job.get("pods"):
        out["train"] = _spmd_pod_train(job)
    return out


def _spmd_pod_train(job):
    """Leg (c): one rank a pod.  The pod's gradients through
    ``pod_psum_compressed`` against ``pod_psum_compressed_ref`` on both
    pods' gradients in this process (each leaf all-gathered), bit for bit;
    then one ``compress_pods`` train step, whose loss is the pods' mean."""
    import torch

    from repro_torch.data.synthetic import make_batch
    from repro_torch.distributed.compression import (
        pod_psum_compressed, pod_psum_compressed_ref)
    from repro_torch.distributed.spmd import CollectiveLog, mesh_all_gather
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw_init
    from repro_torch.training import (
        TrainerConfig, batch_to_torch, make_train_step)
    from repro_torch.training.steps import make_loss_fn, value_and_grad
    from repro_torch.tree import leaves, tree_map

    pods = make_host_mesh((2,), axes=("pod",), device=job["device"])
    cfg = dataclasses.replace(job["cfg"], dtype="bfloat16")
    params = _spmd_weights(job, "bfloat16")
    batch = batch_to_torch(make_batch(cfg, seq_len=job["train_seq"], batch=4,
                                      step=0, seed=0), device=job["device"])
    pod = pods.coord("pod")
    batch = {k: v[2 * pod:2 * pod + 2] for k, v in batch.items()}
    tcfg = TrainerConfig(compress_pods=True, attn_impl="flash", lr=1e-4)
    (_, metrics), grads = value_and_grad(make_loss_fn(cfg, tcfg), params,
                                         batch)
    zeros = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                           device=g.device), grads)
    log_c = CollectiveLog()
    sync = torch.cuda.synchronize if job["device"] == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    red, _ = pod_psum_compressed(grads, zeros, mesh=pods, log=log_c)
    sync()
    psum_ms = (time.perf_counter() - t0) * 1e3
    del zeros
    mismatched = 0
    for g, r in zip(leaves(grads), leaves(red)):
        both = mesh_all_gather(g[None], pods, "pod", 0)
        want, _ = pod_psum_compressed_ref(
            [both[0], both[1]], [torch.zeros(g.shape, device=g.device)] * 2)
        mismatched += int(not torch.equal(want, r))
    local_losses = mesh_all_gather(metrics["loss"].float().reshape(1), pods,
                                   "pod", 0).cpu()
    n_leaves, wire = len(leaves(red)), dict(log_c.wire)
    del grads, red
    step = make_train_step(cfg, tcfg, mesh=pods)
    sync()
    t0 = time.perf_counter()
    new, _, m = step(params, adamw_init(params), batch)
    sync()
    step_ms = (time.perf_counter() - t0) * 1e3
    return {"mismatched_leaves": mismatched, "leaves": n_leaves,
            "psum_ms": psum_ms, "psum_host_ms": log_c.seconds * 1e3,
            "psum_wire": wire, "local_losses": local_losses,
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "step_ms": step_ms,
            "finite": all(bool(torch.isfinite(t).all()) for t in leaves(new))}


def _spmd_reckon(job, shape, dtype: str, moe_ep: bool = True) -> float:
    """Bytes a serving rank should hold: its parameter blocks, its cache
    block, one gathered layer (none in this layout: the params are off the
    "data" axis and the attention weights, which do not divide "model",
    are whole on every rank) and a CUDA context.  The cache block is
    ``cache_specs``', which keeps an SSM conv window and the audio cross
    K/V whole where a rank holds only its channels or heads: an upper
    bound there."""
    from repro_torch.distributed.sharding import cache_specs, param_specs
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.models import init_caches, init_params

    cfg = dataclasses.replace(job["cfg"], dtype=dtype)
    mesh = MeshSpec(("data", "model"), shape)

    def split(spec):
        n = 1
        for ax in spec:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                n *= mesh.shape.get(a, 1) if a else 1
        return n

    def per_rank(specs, tree):
        from repro_torch.launch.cells import _spec_leaves

        return sum(t.numel() * t.element_size() / split(sp)
                   for sp, t in _spec_leaves(specs, tree))

    params = per_rank(param_specs(cfg, mesh, fsdp=False, moe_ep=moe_ep),
                      init_params(cfg, device="meta"))
    caches = per_rank(cache_specs(cfg, mesh, batch=job["batch"]),
                      init_caches(cfg, job["batch"], job["max_len"],
                                  device="meta"))
    return params + caches + CUDA_CONTEXT_BYTES


def _spmd_legs(job, shape, dtypes, *, pods: bool = False):
    from repro_torch.launch.spmd import run_ranks

    world = int(np.prod(shape))
    t0 = time.perf_counter()
    res = run_ranks(_spmd_rank, world,
                    args=(dict(job, shape=shape, dtypes=dtypes, pods=pods),),
                    timeout=SPMD_TIMEOUT_S)
    log(f"  {world} ranks on {shape}: spawned, ran and joined in "
        f"{time.perf_counter() - t0:.1f} s")
    return res


def spmd_phase(card: str, job=None) -> None:
    """Phase 5n: legs (a) length-sharded decode on (data 2, model 3), (b)
    the head-aligned (data 1, model 2) branch, (c) a compressed train
    step over ("pod" 2); each rank a process of one gloo group on the
    card.  ``job`` (``spmd_job``) defaults to full-width qwen3-0.6b."""
    from repro_torch.configs import get_config

    job = job or spmd_job(get_config("qwen3-0.6b"))
    cuda = job["device"] == "cuda"
    cfg = job["cfg"]
    steps, layers = job["steps"], cfg.n_layers
    ref = {}
    for dt in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dt)
        params = _spmd_weights(job, dt)
        ref[dt] = _serve_run(job, c, params, _spmd_prompts(job))
        del params
        if cuda:
            _free_device_memory()
    single_ms = float(np.median(ref["bfloat16"]["ms"][1:]))
    single_f32_ms = float(np.median(ref["float32"]["ms"][1:]))

    for label, shape, dtypes, pods in (
            ("(a) length-sharded", (2, 3), ("float32", "bfloat16"), False),
            ("(b) head-aligned", (1, 2), ("float32",), True)):
        for dt in dtypes:
            need = _spmd_reckon(job, shape, dt)
            log(f"  {label} {dt}: each rank reckoned <= {need / 2**30:.3f} "
                f"GiB (parameter and cache blocks + a "
                f"{CUDA_CONTEXT_BYTES / 2**30:.1f} GiB context)")
        res = _spmd_legs(job, shape, dtypes, pods=pods)
        for dt in dtypes:
            rows = [r[dt] for r in res]
            r0 = rows[0]
            if shape == (2, 3):
                check(r0["kv_len_sharded"] and r0["vocab_parallel"]
                      and not r0["gathers_layers"],
                      f"{label}: the layout is not length-sharded, "
                      f"vocab-parallel and gather-free")
            else:
                check(not r0["kv_len_sharded"], f"{label}: length-sharded")
            _spmd_check_tokens(label + " " + dt, rows, ref[dt],
                               ref["float32"], f32=dt == "float32")
            for i, r in enumerate(rows):
                if cuda:
                    check(r["flash_launches"] == layers
                          and all(n == layers for n in r["decode_launches"]),
                          f"{label} {dt}: rank {i} launched flash "
                          f"{r['flash_launches']} times in the prefill and "
                          f"decode {r['decode_launches']} a step, not "
                          f"{layers}")
            ms = float(np.median([np.median(r["ms"][1:]) for r in rows]))
            coll = float(np.median([np.median(r["coll_ms"][1:])
                                    for r in rows]))
            wire = {k: v for k, v in rows[0]["wire"][-1].items()}
            single = single_ms if dt == "bfloat16" else single_f32_ms
            log(f"  {label} {dt}: {ms:.2f} ms a serve step (median of ranks' "
                f"medians, steps 2-{steps}) beside the single process's "
                f"{single:.2f} ms; {coll:.2f} ms of host time in collectives "
                f"a step; bytes each rank sends a step "
                f"{json.dumps({k: int(v) for k, v in wire.items()})} "
                f"(ring wire bytes) [{card}]")
            if cuda:
                peak = max(r["peak_bytes"] for r in rows)
                log(f"  {label} {dt}: peak allocated a rank "
                    f"{peak / 2**30:.3f} GiB + its context, reckoned "
                    f"{_spmd_reckon(job, shape, dt) / 2**30:.3f} GiB "
                    f"(parameter blocks {r0['param_bytes'] / 2**30:.3f} GiB, "
                    f"cache block {r0['cache_bytes'] / 2**30:.3f} GiB) "
                    f"[{card}]")
        if pods:
            _spmd_check_pods(card, [r["train"] for r in res])


def _logit_dist(a, b) -> float:
    """max |a - b| over the real vocab (finite in ``b``), over max |b|."""
    import torch

    fin = torch.isfinite(b)
    return ((a[fin] - b[fin]).abs().max() / b[fin].abs().max()).item()


def _spmd_check_tokens(label, rows, ref, ref_f32, *, f32: bool) -> None:
    """f32: every token equal to the single process's and the logits
    within MODEL_TOL.  bf16: the prefill's logits and the first step's (on
    the rows whose input token agrees) within max(BF16_TOL, MOE_SPREAD x the
    single process's own bf16 distance from f32 on the same weights), as
    phase 5m holds a bf16 route; the share of equal tokens printed."""
    import torch

    toks = torch.stack(rows[0]["tokens"])
    want = torch.stack(ref["tokens"])
    for rank, r in enumerate(rows[1:], 1):
        check(torch.equal(torch.stack(r["tokens"]), toks),
              f"{label}: rank {rank} holds other tokens than rank 0")
    share = float((toks == want).float().mean())
    if f32:
        err = 0.0
        for a, b in zip(rows[0]["logits"], ref["logits"]):
            fin = torch.isfinite(b)          # -inf on the padded vocab
            check(torch.equal(torch.isfinite(a), fin),
                  f"{label}: the vocab mask differs")
            err = max(err, (a[fin] - b[fin]).abs().max().item())
        log(f"  {label}: tokens {int((toks == want).sum())}/{toks.numel()} "
            f"equal to the single process's, logits max_abs_err={err:.3e} "
            f"(tol {MODEL_TOL:g})")
        check(share == 1.0, f"{label}: tokens differ from the single-process "
                            f"run ({share:.3f} equal)")
        check(err <= MODEL_TOL, f"{label}: logits {err} > {MODEL_TOL}")
        return
    own = _logit_dist(ref["first"], ref_f32["first"])
    tol = max(BF16_TOL, MOE_SPREAD * own)
    first = _logit_dist(rows[0]["first"], ref["first"])
    same = rows[0]["t0"] == ref["t0"]
    step = (_logit_dist(rows[0]["logits"][0][same], ref["logits"][0][same])
            if bool(same.any()) else float("nan"))
    log(f"  {label}: the prefill's logits {first:.3e} and the first step's "
        f"{step:.3e} ({int(same.sum())} rows with the same input token) of "
        f"the largest logit from the single process's bf16 run; its own "
        f"bf16 distance from f32 {own:.3e} (tol {tol:.3e}); "
        f"{int((toks == want).sum())}/{toks.numel()} tokens equal "
        f"({share:.4f})")
    check(first <= tol, f"{label}: bf16 prefill logits {first} > {tol}")
    check(not bool(same.any()) or step <= tol,
          f"{label}: bf16 first-step logits {step} > {tol}")


def _spmd_check_pods(card, rows) -> None:
    for i, r in enumerate(rows):
        check(r["mismatched_leaves"] == 0,
              f"(c) pod {i}: pod_psum_compressed differs from its plain "
              f"version on {r['mismatched_leaves']} of {r['leaves']} leaves")
        want = float(r["local_losses"].mean())
        check(abs(r["loss"] - want) <= 1e-6 * abs(want),
              f"(c) pod {i}: loss {r['loss']} is not the pods' mean {want}")
        check(r["finite"], f"(c) pod {i}: non-finite params after the step")
    r = rows[0]
    log(f"  (c) compressed train step: pod_psum_compressed equals its plain "
        f"version on all {r['leaves']} leaves of both pods; loss "
        f"{r['loss']:.6f} = the mean of {r['local_losses'].tolist()}; "
        f"grad norm {r['grad_norm']:.4f}; pod_psum_compressed "
        f"{r['psum_ms']:.1f} ms ({r['psum_host_ms']:.1f} ms in collectives, "
        f"{json.dumps({k: int(v) for k, v in r['psum_wire'].items()})} bytes "
        f"sent), the step {r['step_ms']:.1f} ms [{card}]")


# ---------------------------------------------------------------------------
# phase 5o: the SPMD policy for the MoE, SSM, hybrid, VLM and audio families
# ---------------------------------------------------------------------------

FAMILY_PROMPT, FAMILY_STEPS, FAMILY_MAX_LEN = 512, 3, 1536
JAMBA_HELD = (4, 2)           # leg (c): the most of these experts that fit


def _jamba_held(card: str) -> int:
    """How many of jamba's 16 experts leg (c) holds: the most of
    :data:`JAMBA_HELD` for which the single process's f32 period and then
    two ranks building theirs fit in 92 % of the card.  A rank makes the
    whole bf16 period (half the f32 bytes), takes its bf16 blocks (a
    quarter) and casts them to f32 in place (a half, as the bf16 blocks
    go), so two ranks building at once hold about 1.5 times the f32
    period; the single process holds the f32 period and its activations
    (2 GiB reckoned)."""
    import torch

    from repro_torch.models import init_params

    budget = 0.92 * torch.cuda.mem_get_info()[1]
    for held in JAMBA_HELD:
        cfg = _jamba_period(held)
        f32 = _param_bytes(init_params(cfg, device="meta"))
        single = f32 + 2 * 2**30
        ranks = 1.5 * f32 + 2 * CUDA_CONTEXT_BYTES
        fits = max(single, ranks) <= budget
        log(f"  (c) {held} of 16 experts: the f32 period {_gib(f32)}, the "
            f"single process {_gib(single)}, two ranks building theirs "
            f"{_gib(ranks)}, against {_gib(budget)} (92 % of the card): "
            f"{'fits' if fits else 'does not fit'} [{card}]")
        if fits:
            return held
    raise RuntimeError("phase 5o: no jamba period fits on the card")


def _jamba_period(held: int):
    from repro_torch.configs import get_config

    full = get_config("jamba-1.5-large-398b")
    return dataclasses.replace(full, n_layers=HYBRID_LAYERS, dtype="float32",
                               moe=dataclasses.replace(full.moe,
                                                       n_experts=held))


def family_leg(letter: str, cfg, shape, *, dtypes=("float32",),
               eps=(True,), n_text=FAMILY_PROMPT, max_len=FAMILY_MAX_LEN,
               device="cuda"):
    """One leg of phase 5o: a job (``spmd_job``'s keys) with its letter,
    its mesh's shape, dtypes, MoE layouts (``moe_ep``) and prompt shape
    (4 prompts of ``n_text`` tokens, seeded by the letter)."""
    return dict(spmd_job(cfg, device, max_len=max_len, steps=FAMILY_STEPS),
                leg=letter, shape=shape, dtypes=dtypes, eps=eps,
                n_text=n_text, batch_seed=30 + ord(letter) - ord("a"))


def _family_legs(card: str):
    """Phase 5o's legs, grouped by the mesh their ranks run on (one spawn
    a mesh)."""
    from repro_torch.configs import get_config

    leg = family_leg
    a = leg("a", get_config("mamba2-370m"), (2, 2),
            dtypes=("float32", "bfloat16"))
    b = leg("b", dataclasses.replace(get_config("deepseek-moe-16b"),
                                     n_layers=4), (1, 2), eps=(True, False))
    c = leg("c", _jamba_period(_jamba_held(card)), (1, 2))
    # whisper at generate's shapes: 4-token prompts over 1,500 frames
    d = leg("d", get_config("whisper-base"), (2, 2),
            dtypes=("float32", "bfloat16"), n_text=4, max_len=448)
    # 64 patches and 448 text tokens: 512 positions
    e = leg("e", dataclasses.replace(get_config("qwen2-vl-72b"), n_layers=2),
            (1, 3), n_text=FAMILY_PROMPT - VLM_SIDE ** 2)
    return [((2, 2), [a, d]), ((1, 2), [b, c]), ((1, 3), [e])]


def _cast_in_place(tree, dtype) -> None:
    """Every floating leaf of a params tree cast to ``dtype``, one leaf at
    a time, each old leaf freed as its copy replaces it."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in list(items):
        if isinstance(v, (dict, list)):
            _cast_in_place(v, dtype)
        elif v.is_floating_point() and v.dtype != dtype:
            tree[k] = v.to(dtype)


def _family_weights(leg, dtype: str, mesh=None, moe_ep: bool = True):
    """The leg's weights from its seed, the same values in every process:
    bf16 from ``init_params`` (each SSM layer's ``dt_bias`` and ``A_log``
    as Mamba-2 draws them, so the heads differ), then on a mesh this
    rank's blocks (``param_shardings(fsdp=False)``, the whole tree freed),
    cast to ``dtype`` a leaf at a time."""
    import torch

    from repro_torch.device import torch_dtype
    from repro_torch.distributed.spmd import param_shardings
    from repro_torch.models import init_params

    cfg = dataclasses.replace(leg["cfg"], dtype="bfloat16")
    params = init_params(cfg, leg["seed"], device=leg["device"])
    if cfg.ssm is not None:
        mamba2_dt_init({"blocks": [b for b in params["blocks"] if "ssm" in b]},
                       leg["seed"])
    if mesh is not None:
        params = param_shardings(cfg, mesh, params, fsdp=False, moe_ep=moe_ep)
    if dtype != "bfloat16":
        _cast_in_place(params, torch_dtype(dtype))
    if leg["device"] == "cuda":
        torch.cuda.synchronize()
    return params


def _family_batch(leg, dtype: str):
    return family_batch(dataclasses.replace(leg["cfg"], dtype=dtype),
                        leg["batch"], leg["n_text"], leg["batch_seed"],
                        device=leg["device"])


def _family_rank(rank: int, world: int, job):
    """One rank of phase 5o: every leg of ``job["legs"]`` on
    ``job["shape"]``, in each of its dtypes and MoE layouts, each freed
    before the next; the policy's layout beside each run."""
    import torch

    from repro_torch.distributed.spmd import make_policy, shard_batch
    from repro_torch.launch.mesh import make_host_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = job["device"] == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    mesh = make_host_mesh(job["shape"], device=job["device"])
    out = {"rank": rank, "coords": mesh.coords}
    for leg in job["legs"]:
        for dt in leg["dtypes"]:
            for ep in leg["eps"]:
                cfg = dataclasses.replace(leg["cfg"], dtype=dt)
                pol = make_policy(cfg, mesh, batch=leg["batch"], fsdp=False,
                                  moe_ep=ep)
                params = _family_weights(leg, dt, mesh=mesh, moe_ep=ep)
                if cuda:
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                batch = {k: shard_batch(v, mesh, pol.batch_axes,
                                        dim=1 if k == "positions" else 0)
                         for k, v in _family_batch(leg, dt).items()}
                res = _serve_run(leg, cfg, params, batch, policy=pol,
                                 mesh=mesh)
                block = pol.ssm_block()
                res.update(
                    param_bytes=_tree_nbytes(params),
                    layout=dict(kv_len_sharded=pol.kv_len_sharded,
                                heads_split=pol.heads_split,
                                vocab_parallel=pol.vocab_parallel,
                                mlp_split=pol.mlp_split,
                                ssm_groups_split=pol.ssm_groups_split,
                                moe_ep=pol.moe_ep, moe_split=pol.moe_split,
                                expert_block=pol.expert_block,
                                ssm_heads=None if block is None
                                else block.heads,
                                gathers_layers=pol.gathers_layers))
                if cuda:
                    res["peak_bytes"] = torch.cuda.max_memory_allocated()
                out[(leg["leg"], dt, ep)] = res
                del params, batch
                if cuda:
                    torch.cuda.empty_cache()
    return out


def _family_layout(cfg, n_model: int, ep: bool, m: int):
    """The layout the policy must pick on "model" rank ``m`` of
    ``n_model``: the rank's heads or the cache's length, its SSM heads
    and whether its groups split, its experts (over "model" with
    ``moe_ep``, else expert-TP)."""
    want = {"heads_split": cfg.n_kv_heads % n_model == 0,
            "kv_len_sharded": (cfg.family != "ssm"
                               and cfg.n_kv_heads % n_model != 0)}
    if cfg.ssm is not None:
        k = cfg.ssm.n_ssm_heads(cfg.d_model) // n_model
        want.update(ssm_heads=(k * m, k * m + k),
                    ssm_groups_split=cfg.ssm.n_groups % n_model == 0)
    if cfg.moe is not None:
        e = cfg.moe.n_experts // n_model
        want.update(moe_split=True, moe_ep=ep,
                    expert_block=(e * m, e * m + e) if ep else None)
    return want


def spmd_family_phase(card: str, groups=None) -> None:
    """Phase 5o: the SPMD policy for the MoE, SSM, hybrid, VLM and audio
    families over gloo ranks sharing the card, each leg against the single
    process's ``make_prefill_step`` and ``make_serve_step`` on the same
    weights; every single-process leg of a mesh runs to its end, keeps its
    results on the host and is freed before that mesh's ranks start.
    ``groups`` ((mesh shape, legs) pairs) defaults to
    :func:`_family_legs`'."""
    from repro_torch.launch.spmd import run_ranks

    t_phase = time.perf_counter()
    for shape, legs in groups or _family_legs(card):
        cuda = legs[0]["device"] == "cuda"
        refs = {}
        for leg in legs:
            for dt in leg["dtypes"]:
                cfg = dataclasses.replace(leg["cfg"], dtype=dt)
                params = _family_weights(leg, dt)
                refs[(leg["leg"], dt)] = _serve_run(
                    leg, cfg, params, _family_batch(leg, dt))
                del params
                if cuda:
                    _free_device_memory()
        world = int(np.prod(shape))
        t0 = time.perf_counter()
        res = run_ranks(_family_rank, world, args=(dict(
            device=legs[0]["device"], shape=shape, legs=legs),),
            timeout=SPMD_TIMEOUT_S)
        log(f"  {world} ranks on {shape} (legs "
            f"{', '.join(leg['leg'] for leg in legs)}): spawned, ran and "
            f"joined in {time.perf_counter() - t0:.1f} s")
        for leg in legs:
            _family_checks(card, leg, shape, res, refs)
    log(f"  phase 5o: {time.perf_counter() - t_phase:.1f} s of wall time "
        f"[{card}]")


def _family_checks(card: str, leg, shape, res, refs) -> None:
    """One leg's gates and log lines, for each of its dtypes and layouts:
    the tokens and logits against the single process (f32 exact tokens and
    MODEL_TOL; bf16 as phase 5n holds it), the policy's layout on every
    rank, the kernels' launches on every rank, and the times, collectives,
    bytes and memory."""
    cfg = leg["cfg"]
    n_attn, n_ssm = _layer_counts(cfg)
    audio = cfg.family == "audio"
    flash_want = n_attn + (cfg.n_enc_layers + cfg.n_layers if audio else 0)
    step_flash = cfg.n_layers if audio else 0
    for dt in leg["dtypes"]:
        ref = refs[(leg["leg"], dt)]
        single = float(np.median(ref["ms"][1:]))
        for ep in leg["eps"]:
            rows = [r[(leg["leg"], dt, ep)] for r in res]
            layout = ("" if cfg.moe is None
                      else " experts over model" if ep else " expert-TP")
            label = f"({leg['leg']}) {cfg.name} {shape}{layout}"
            _spmd_check_tokens(f"{label} {dt}", rows, ref,
                               refs[(leg["leg"], "float32")],
                               f32=dt == "float32")
            for r, row in zip(res, rows):
                want = _family_layout(cfg, shape[1], ep, r["coords"][1])
                got = {k: row["layout"][k] for k in want}
                check(got == want, f"{label}: rank {r['rank']}'s layout "
                      f"{got}, expected {want}")
                if leg["device"] != "cuda":
                    continue              # the plain versions count nothing
                check(row["flash_launches"] == flash_want
                      and row["ssd_launches"] == n_ssm
                      and all(n == n_attn for n in row["decode_launches"])
                      and all(n == step_flash
                              for n in row["step_flash_launches"]),
                      f"{label} {dt}: rank {r['rank']} launched flash "
                      f"{row['flash_launches']} and SSD "
                      f"{row['ssd_launches']} times in the prefill, decode "
                      f"{row['decode_launches']} and flash "
                      f"{row['step_flash_launches']} a step; expected "
                      f"{flash_want}, {n_ssm}, {n_attn} and {step_flash}")
            ms = float(np.median([np.median(r["ms"][1:]) for r in rows]))
            coll = float(np.median([np.median(r["coll_ms"][1:])
                                    for r in rows]))
            wire = rows[0]["wire"][-1]
            log(f"  {label} {dt}: flash {flash_want} and SSD {n_ssm} a "
                f"prefill, decode {n_attn} and flash {step_flash} a step on "
                f"every rank; {ms:.2f} ms a serve step (median of ranks' "
                f"medians, steps 2-{leg['steps']}) beside the single "
                f"process's {single:.2f} ms; {coll:.2f} ms of host time in "
                f"collectives a step; bytes each rank sends a step "
                f"{json.dumps({k: int(v) for k, v in wire.items()})} (ring "
                f"wire bytes) [{card}]")
            peak = ("not measured" if "peak_bytes" not in rows[0] else
                    f"{max(r['peak_bytes'] for r in rows) / 2**30:.3f} GiB")
            reckon = _spmd_reckon(leg, shape, dt, moe_ep=ep)
            log(f"  {label} {dt}: peak allocated a rank {peak} + its "
                f"context, reckoned {reckon / 2**30:.3f} GiB "
                f"(parameter blocks {rows[0]['param_bytes'] / 2**30:.3f} "
                f"GiB, cache block {rows[0]['cache_bytes'] / 2**30:.3f} GiB)"
                f" [{card}]")


# ---------------------------------------------------------------------------
# phase 5p: the paged, prefix and speculative batchers under the SPMD policy
# ---------------------------------------------------------------------------

# max_new 4-8: more ran the phase past its 150 s, or the whole script
# past its time budget
SPMD_PAGED_REQUESTS, SPMD_PAGED_MAX_NEW = 8, (4, 9)


def spmd_paged_job(cfg, device: str = "cuda", *, modes=None, n_req=None):
    """Phase 5p's config, passed to every rank: the model, the seed of its
    weights (5n's), the batchers' configs by mode (phases 5, 5b and 5c's
    by default) and the requests (``n_req`` of 5b's shape)."""
    modes = modes or {"dense": DENSE_CONFIG, "paged": PAGED_CONFIG,
                      "spec": SPEC_CONFIG}
    return dict(cfg=cfg, device=device, seed=0, modes=modes,
                prompt_len=modes["paged"]["prompt_len"],
                n_req=n_req or SPMD_PAGED_REQUESTS)


PAGED_COUNTERS = ("flash", "prefix", "decode", "paged decode", "verify")


def _kernel_counters():
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.prefix_attention import ops as pfx

    return dict(zip(PAGED_COUNTERS, (
        fa.flash_attention, pfx.prefix_flash_attention, da.decode_attention,
        pa.paged_decode_attention, pa.paged_verify_attention)))


def _timed_chunks(b, pol):
    """Wrap ``b``'s chunk dispatch and sync: each chunk's wall ms from its
    dispatch to its sync, its T, whether an admission ran behind it
    (overlap), and the collectives (count, ring wire bytes, host seconds)
    issued in between, by site."""
    rec = []
    dispatch, finish = b._dispatch_chunk, b._finish_chunk

    def log():
        if pol is None:
            return {}, {}, 0.0
        return dict(pol.log.count), dict(pol.log.wire), pol.log.seconds

    def timed_dispatch(active):
        t0, prefills, before = time.perf_counter(), b.stats.prefills, log()
        pending = dispatch(active)
        pending["_timer"] = (t0, prefills, before)
        return pending

    def timed_finish(pending, **kw):
        out = finish(pending, **kw)
        t0, prefills, (c0, w0, s0) = pending["_timer"]
        c1, w1, s1 = log()
        rec.append(dict(ms=(time.perf_counter() - t0) * 1e3, T=pending["T"],
                        clean=b.stats.prefills == prefills,
                        count={k: v - c0.get(k, 0) for k, v in c1.items()},
                        wire={k: v - w0.get(k, 0.0) for k, v in w1.items()},
                        coll_ms=(s1 - s0) * 1e3))
        return out

    b._dispatch_chunk, b._finish_chunk = timed_dispatch, timed_finish
    return rec


def _state_digest(b) -> int:
    """The slot state and (paged) the page table, the free stack's valid
    entries, ``free_top`` and ``pinned`` as one integer: ranks whose
    digests agree hold the same bookkeeping.  The stack's scratch element
    is left out: masked pushes land there together, and on the card which
    of them wins is undefined (``serving.engine``'s docstring)."""
    import hashlib

    h = hashlib.sha256()
    tensors = list(b.state)
    if b.paged:
        top = int(b.pages.free_top)
        tensors += [b.pages.table, b.pages.free[:top], b.pages.free_top,
                    b.pages.pinned]
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return int.from_bytes(h.digest()[:8], "little", signed=True)


def _paged_serve(job, cfg, params, config, *, policy=None):
    """The requests through one batcher of ``config`` (under ``policy``
    on a rank), round by round: each request's tokens, every counter, the
    chunks' times and collectives, the kernels' launches counted from 0
    just before; after every round the page ledger's check (paged) and, on
    a rank, how many rounds left another rank with other bookkeeping (the
    slot and page state's digest all-gathered over the world)."""
    import torch

    from repro_torch.serving import ContinuousBatcher, ServingConfig

    cuda = job["device"] == "cuda"
    b = ContinuousBatcher(params, cfg, ServingConfig(**config),
                          device=job["device"], policy=policy)
    # 5b's shape (the system prompt and a tail), max_new 4-8
    reqs = _paged_requests(cfg, job["n_req"], prompt_len=job["prompt_len"],
                           max_new=SPMD_PAGED_MAX_NEW)
    for r in reqs:
        b.submit(r)
    chunks = _timed_chunks(b, policy)
    counters = _kernel_counters()
    for c in counters.values():
        c.launches = 0
    parted = rounds = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        while b.queue or any(r is not None for r in b.slot_req):
            b.step()
            rounds += 1
            check(rounds < 1000, f"{cfg.name}: the batcher did not drain")
            if b.paged:
                b.kv_pool.check()
            if policy is not None:
                import torch.distributed as dist

                mine = torch.tensor([_state_digest(b)], dtype=torch.int64)
                every = [torch.empty_like(mine)
                         for _ in range(dist.get_world_size())]
                dist.all_gather(every, mine)
                parted += any(int(t) != int(mine) for t in every)
    if cuda:
        torch.cuda.synchronize()
    # the timers' closures hold the batcher: drop them, so it (and the
    # params it holds) is freed with this frame
    del b._dispatch_chunk, b._finish_chunk
    return {"tokens": [list(r.out) for r in reqs],
            "done": all(r.done and len(r.out) == r.max_new for r in reqs),
            "stats": b.stats.as_dict(), "chunks": chunks,
            "launches": {k: c.launches for k, c in counters.items()},
            "rounds": rounds, "parted": parted,
            "wall_s": time.perf_counter() - t0}


def _spmd_paged_rank(rank: int, world: int, job):
    """One rank of phase 5p: every mode of ``job["modes"]`` in each of
    ``job["dtypes"]`` on ``job["shape"]``, the params placed once a dtype
    (``param_shardings(fsdp=False)``); with ``job["refuse"]`` the paged
    batcher's construction, whose refusal is recorded."""
    import torch

    from repro_torch.distributed.spmd import make_policy, param_shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving import ContinuousBatcher, ServingConfig
    from repro_torch.serving.kv_cache import (
        kv_cache_bytes, paged_kv_cache_bytes)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = job["device"] == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    mesh = make_host_mesh(job["shape"], device=job["device"])
    out = {"rank": rank, "coords": mesh.coords}
    for dt in job["dtypes"]:
        cfg = dataclasses.replace(job["cfg"], dtype=dt)
        params = param_shardings(cfg, mesh, _spmd_weights(job, dt),
                                 fsdp=False)
        for mode, config in job["modes"].items():
            pol = make_policy(cfg, mesh, batch=config["slots"], fsdp=False)
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            res = _paged_serve(job, cfg, params, config, policy=pol)
            res["param_bytes"] = _tree_nbytes(params)
            res["cache_bytes"] = (
                paged_kv_cache_bytes(cfg, config["n_pages"],
                                     config["page_size"], policy=pol)
                if config.get("paged") else
                kv_cache_bytes(cfg, config["slots"], config["max_len"],
                               policy=pol))
            res["kv_len_sharded"] = pol.kv_len_sharded
            if cuda:
                res["peak_bytes"] = torch.cuda.max_memory_allocated()
            out[(mode, dt)] = res
        if job.get("refuse"):
            pol = make_policy(cfg, mesh, batch=job["refuse"]["slots"],
                              fsdp=False)
            try:
                ContinuousBatcher(params, cfg, ServingConfig(**job["refuse"]),
                                  device=job["device"], policy=pol)
                out["refused"] = None
            except NotImplementedError as e:
                out["refused"] = str(e)
        del params
        if cuda:
            torch.cuda.empty_cache()
    return out


def spmd_paged_legs(job):
    """Phase 5p's legs: (label, mesh shape, modes, dtypes, the mode whose
    batcher must be refused).  (a) every mode on (data 2, model 2), f32
    and bf16; (b) the dense mode on (1, 3), f32, its ring made a multiple
    of 3 slots (``max_len`` rounded up), and the paged batcher refused."""
    dense = job["modes"]["dense"]
    ring = dict(dense, max_len=-(-dense["max_len"] // 3) * 3)
    return [("(a)", (2, 2), job["modes"], ("float32", "bfloat16"), None),
            ("(b)", (1, 3), {"dense": ring}, ("float32",),
             job["modes"]["paged"])]


def spmd_paged_phase(card: str, job=None) -> None:
    """Phase 5p: the port's ``ContinuousBatcher`` under ``make_policy``
    over gloo ranks sharing the card, full-width qwen3-0.6b (``job``,
    ``spmd_paged_job``, by default): each leg against the single
    process's batcher on the same weights, run and freed first."""
    from repro_torch.configs import get_config
    from repro_torch.launch.spmd import run_ranks

    job = job or spmd_paged_job(get_config("qwen3-0.6b"))
    cuda = job["device"] == "cuda"
    t_phase = time.perf_counter()
    for label, shape, modes, dtypes, refuse in spmd_paged_legs(job):
        refs = {}
        for dt in dtypes:
            cfg = dataclasses.replace(job["cfg"], dtype=dt)
            params = _spmd_weights(job, dt)
            for mode, config in modes.items():
                refs[(mode, dt)] = _paged_serve(job, cfg, params, config)
            del params
            if cuda:
                _free_device_memory()
        world = int(np.prod(shape))
        t0 = time.perf_counter()
        res = run_ranks(_spmd_paged_rank, world, args=(dict(
            job, shape=shape, modes=modes, dtypes=dtypes, refuse=refuse),),
            timeout=SPMD_TIMEOUT_S)
        log(f"  {label} {world} ranks on {shape}: spawned, ran and joined in "
            f"{time.perf_counter() - t0:.1f} s")
        if refuse is not None:
            msgs = {r["refused"] for r in res}
            check(msgs == {"paged decode does not support a length-sharded "
                           "KV cache"},
                  f"{label}: the paged batcher on {shape} was not refused as "
                  f"the reference refuses it: {msgs}")
            log(f"  {label} the paged batcher on {shape} refused on every "
                f"rank: NotImplementedError({msgs.pop()!r})")
        for mode in modes:
            for dt in dtypes:
                _spmd_paged_checks(card, f"{label} {mode} {dt} {shape}",
                                   [r[(mode, dt)] for r in res],
                                   refs[(mode, dt)], f32=dt == "float32",
                                   cuda=cuda, config=modes[mode],
                                   n_attn=_layer_counts(job["cfg"])[0])
    log(f"  phase 5p: {time.perf_counter() - t_phase:.1f} s of wall time "
        f"[{card}]")


def _launches_of(launches, stats, config, n_attn: int):
    """Each attention kernel's launches a run of ``config`` makes, from
    its own counters and the split of its admissions it launched: flash
    or prefix once a layer an admission dispatch (together ``n_attn``
    times the dispatches), the decode step's or verify window's kernel
    once a layer a step or window (a dense verify has none)."""
    W = config.get("draft_window", 4) if config.get("speculative") else 1
    steps = n_attn * stats["steps"] // W
    want = dict.fromkeys(PAGED_COUNTERS, 0)
    if stats["prefix_hits"]:        # at least one cached dispatch
        want["prefix"] = n_attn * max(1, launches["prefix"] // n_attn)
    want["flash"] = n_attn * stats["prefills"] - want["prefix"]
    if config.get("paged"):
        want["verify" if config.get("speculative") else "paged decode"] = steps
    elif not config.get("speculative"):
        want["decode"] = steps
    return want


def _spmd_paged_checks(card: str, label: str, rows, ref, *, f32: bool,
                       cuda: bool, config, n_attn: int) -> None:
    """One leg's gates and log lines: with a prefix cache, at least one
    admission hit it; on the card the mode's kernels launched once an
    attention layer a step (window) and an admission dispatch by each
    process's own counters (:func:`_launches_of`); every rank's
    launches and slot and page state (after every round) equal; f32 every
    token, counter and launch count equal to the single process's, bf16
    every request completed (the share of equal tokens printed: its
    stream, and so its steps, may differ); ms a chunk,
    host ms in collectives, collectives and ring wire bytes a step by site
    (chunks with no admission behind them), peaks beside the reckoning."""
    check(not config.get("prefix_cache") or ref["stats"]["prefix_hits"] > 0,
          f"{label}: no admission of the single process hit the prefix "
          f"cache")
    if cuda:
        want = _launches_of(ref["launches"], ref["stats"], config, n_attn)
        check(ref["launches"] == want, f"{label}: the single process "
              f"launched {ref['launches']}, its admissions and steps make "
              f"{want}")
    for i, row in enumerate(rows):
        check(row["done"], f"{label}: rank {i} left a request unfinished")
        check(row["parted"] == 0, f"{label}: rank {i}'s bookkeeping parted "
              f"from another rank's after {row['parted']} rounds")
        if cuda:
            want = _launches_of(row["launches"], row["stats"], config,
                                n_attn)
            check(row["launches"] == want,
                  f"{label}: rank {i} launched {row['launches']}, its "
                  f"admissions and steps make {want}")
        check(row["launches"] == rows[0]["launches"],
              f"{label}: rank {i} launched {row['launches']}, rank 0 "
              f"{rows[0]['launches']}")
        if f32:
            check(row["launches"] == ref["launches"],
                  f"{label}: rank {i} launched {row['launches']}, the single "
                  f"process {ref['launches']}")
            check(row["tokens"] == ref["tokens"],
                  f"{label}: rank {i}'s tokens differ from the single "
                  f"process's")
            diff = {k: (v, ref["stats"][k]) for k, v in row["stats"].items()
                    if v != ref["stats"][k]}
            check(not diff, f"{label}: rank {i}'s counters differ from the "
                  f"single process's: {diff}")
    toks = [t for r in rows[0]["tokens"] for t in r]
    want = [t for r in ref["tokens"] for t in r]
    same = sum(a == b for a, b in zip(toks, want))
    st = rows[0]["stats"]
    log(f"  {label}: {same}/{len(want)} tokens equal to the single process "
        f"{'(gated)' if f32 else '(completion gated)'}; every counter "
        f"{'equal' if f32 else 'of rank 0'} ({st['prefills']} admissions, "
        f"{st['prefix_hits']} prefix hits, {st['chunks']} chunks, "
        f"{st['steps']} steps, {st['accepted_tokens']} drafts accepted, "
        f"{st['overlap_rounds']} overlap rounds); slot and page state equal "
        f"on every rank after each of {rows[0]['rounds']} rounds; launches "
        f"on every rank {json.dumps(rows[0]['launches'])} (the single "
        f"process: {json.dumps(ref['launches'])}) [{card}]")
    clean = [[c for c in r["chunks"] if c["clean"]] for r in rows]
    ms = float(np.median([np.median([c["ms"] for c in r["chunks"]])
                          for r in rows]))
    single = float(np.median([c["ms"] for c in ref["chunks"]]))
    steps = sum(c["T"] for c in clean[0]) or 1
    coll = sum(c["coll_ms"] for r in clean for c in r) / (
        len(rows) * steps)
    count, wire = {}, {}
    for c in clean[0]:
        for k, v in c["count"].items():
            count[k] = count.get(k, 0) + v
        for k, v in c["wire"].items():
            wire[k] = wire.get(k, 0.0) + v
    per = {k: round(v / steps, 2) for k, v in count.items()}
    kv = {k: v for k, v in wire.items() if k == "pool-kv"}
    rest = {k: int(v / steps) for k, v in wire.items() if k != "pool-kv"}
    log(f"  {label}: {ms:.2f} ms a chunk (median of ranks' medians; "
        f"{len(rows[0]['chunks'])} chunks) beside the single process's "
        f"{single:.2f} ms; {coll:.2f} ms of host time in collectives a step "
        f"(a decode step or verify window; {steps} steps in chunks with no "
        f"admission behind them); collectives a step "
        f"{sum(per.values()):.2f} {json.dumps(per)}; bytes rank 0 sends a "
        f"step (ring wire) {json.dumps(rest)} [{card}]")
    log(f"  {label}: the data-axis K/V gather (pool-kv): "
        f"{per.get('pool-kv', 0):.2f} a step, "
        f"{int(kv.get('pool-kv', 0.0) / steps)} bytes a step [{card}]")
    if cuda:
        peak = max(r["peak_bytes"] for r in rows)
        reckon = (rows[0]["param_bytes"] + rows[0]["cache_bytes"]
                  + CUDA_CONTEXT_BYTES)
        log(f"  {label}: peak allocated a rank {peak / 2**30:.3f} GiB + its "
            f"context, reckoned {reckon / 2**30:.3f} GiB (parameter blocks "
            f"{rows[0]['param_bytes'] / 2**30:.3f} GiB, cache "
            f"{rows[0]['cache_bytes'] / 2**30:.3f} GiB, context "
            f"{CUDA_CONTEXT_BYTES / 2**30:.1f}) [{card}]")


# ---------------------------------------------------------------------------
# phase 5q: training under the SPMD policy over the data and model axes
# ---------------------------------------------------------------------------

SPMD_TRAIN_LR, SPMD_TRAIN_CHUNK = 3e-4, 128
# what the single process's grads and params are held to, as the CPU tests
# hold them (tests/test_torch_train_parity.py)
SPMD_TRAIN_GRAD_TOL, SPMD_TRAIN_RTOL, SPMD_TRAIN_ATOL = 1e-4, 1e-3, 1e-4
SPMD_TRAIN_METRIC_RTOL = {"loss": 1e-5, "aux": 1e-5, "lr": 1e-5,
                          "grad_norm": 1e-4}
# the collectives a train step issues after its backward, on their own line
STEP_SITES = ("grad-sum", "grad-norm", "loss", "moments-max")


def spmd_train_job(cfg, moe_cfg, device: str = "cuda", *, seq: int = 256,
                   batch: int = 4):
    """Phase 5q's config, passed to every rank: the dense model of legs (a)
    and (b) and the MoE model of leg (c) (both from 5n's seed) and the
    batch (5n (c)'s, ``make_batch(seq_len=seq, batch=batch)``)."""
    return dict(cfg=cfg, moe_cfg=moe_cfg, device=device, seed=0, seq=seq,
                batch=batch)


def spmd_train_legs(job):
    """Phase 5q's legs: (label, model key of the job, mesh shape, runs),
    each run (dtype, steps, moe_ep), the params placed by
    ``param_shardings(fsdp=True)``: (a) (data 2, model 2), 2 steps at f32,
    then 1 at bf16 (one bf16 step cut for the phase's time); (b) (1, 3), 2
    steps at f32 (8 kv heads do not divide 3); (c) the MoE model on (1, 2),
    one step with its experts over "model", then one as expert-TP."""
    return [("(a)", "cfg", (2, 2), (("float32", 2, True),
                                    ("bfloat16", 1, True))),
            ("(b)", "cfg", (1, 3), (("float32", 2, True),)),
            ("(c)", "moe_cfg", (1, 2), (("float32", 1, True),
                                        ("float32", 1, False)))]


def _train_batch(job, cfg):
    from repro_torch.data.synthetic import make_batch
    from repro_torch.training import batch_to_torch

    return batch_to_torch(make_batch(cfg, seq_len=job["seq"],
                                     batch=job["batch"], step=0, seed=0),
                          device=job["device"])


def _train_tcfg():
    from repro_torch.training import TrainerConfig

    return TrainerConfig(attn_impl="flash", lr=SPMD_TRAIN_LR,
                         loss_chunk=SPMD_TRAIN_CHUNK)


def _timed(fn, sync):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def _train_single(job, dtype: str, steps: int, path=None):
    """The single process's ``make_train_step`` on the full weights of
    ``job["cfg"]`` and the batch: ``steps`` steps, each timed with its
    flash launches counted from 0 just before, the first keeping its
    gradients before clipping (``keep_grads``); with ``path``, those
    gradients and the params after the last step saved there (CPU) for
    the ranks."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.optim import adamw_init
    from repro_torch.training import make_train_step
    from repro_torch.tree import tree_map

    cuda = job["device"] == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = dataclasses.replace(job["cfg"], dtype=dtype)
    params = _spmd_weights(job, dtype)
    batch = _train_batch(job, cfg)
    step = make_train_step(cfg, _train_tcfg())
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    out = {"ms": [], "metrics": [], "launches": []}
    opt = adamw_init(params)
    for i in range(steps):
        fa.flash_attention.launches = 0
        (params, opt, m, *grads), ms = _timed(
            lambda: step(params, opt, batch, keep_grads=i == 0), sync)
        if grads and path is not None:
            saved = {"grads": tree_map(lambda t: t.float().cpu(), grads[0])}
        del grads
        out["ms"].append(ms)
        out["launches"].append(fa.flash_attention.launches)
        out["metrics"].append({k: float(v) for k, v in m.items()})
    if cuda:
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    if path is not None:
        saved["params"] = tree_map(lambda t: t.float().cpu(), params)
        torch.save(saved, path)
        del saved
    out["path"] = path
    return out


def _ref_block(leaf, plan, mesh):
    """This rank's block of a whole reference leaf, as ``param_shardings``
    places it (a permuted ``wi``'s columns first put in their order)."""
    import torch

    from repro_torch.distributed.spmd import block_of

    if plan.perm is not None:
        leaf = leaf[..., torch.from_numpy(plan.perm).to(leaf.device)]
    return block_of(leaf, plan.spec, mesh)


def _held_to_single(path, pol, mesh, grads, params, device):
    """This rank's blocks of step 0's gradients and of the params after the
    last step against the same blocks of the single process's (``path``,
    read through a memory map): each leaf's largest gradient error over the
    leaf's largest magnitude, and its params' largest excess over rtol
    1e-3 (|a - b| - 1e-3 |b|), the largest over every rank (a MAX
    all-reduce over the world)."""
    import torch
    import torch.distributed as dist

    from repro_torch.tree import flatten_with_path, leaves

    ref = torch.load(path, mmap=True, weights_only=True)
    plans = leaves(pol.leaf_plans())
    keys = [k for k, _ in flatten_with_path(ref["grads"])]
    vals = []
    for g, rg, plan in zip(leaves(grads), leaves(ref["grads"]), plans):
        rg = rg.to(device)                   # a leaf at a time on the card
        scale = max(float(rg.abs().max()), 1e-30)
        vals.append(float((g.float() - _ref_block(rg, plan, mesh)).abs()
                          .max()) / scale)
    for p, rp, plan in zip(leaves(params), leaves(ref["params"]), plans):
        b = _ref_block(rp.to(device), plan, mesh)
        vals.append(float(((p.float() - b).abs() - SPMD_TRAIN_RTOL
                           * b.abs()).max()))
    worst = torch.tensor(vals, dtype=torch.float64)
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    n = len(keys)
    return {"keys": keys, "grad_err": worst[:n].tolist(),
            "param_excess": worst[n:].tolist()}


def _parted_blocks(pol, mesh, params) -> int:
    """Leaves whose block differs between two ranks that hold the same
    block (every rank, for a replicated leaf): a digest of each of this
    rank's blocks that some other rank holds too, all-gathered over the
    world."""
    import hashlib

    import torch
    import torch.distributed as dist

    from repro_torch.tree import leaves

    plans = leaves(pol.leaf_plans())
    shared = [any(n > 1 and a not in plan.split
                  for a, n in zip(mesh.axis_names, mesh.sizes))
              for plan in plans]
    mine = torch.tensor([int.from_bytes(hashlib.blake2b(
        p.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes(),
        digest_size=8).digest(), "little", signed=True) if s else 0
        for p, s in zip(leaves(params), shared)], dtype=torch.int64)
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    here = torch.tensor(mesh.coords, dtype=torch.int64)
    all_coords = [torch.empty_like(here) for _ in range(len(every))]
    dist.all_gather(all_coords, here)
    coords = [tuple(int(c) for c in t) for t in all_coords]
    parted = 0
    for i, plan in enumerate(plans):
        split = [mesh.axis_names.index(a) for a in plan.split]
        owners = {}
        for r, c in enumerate(coords):
            owners.setdefault(tuple(c[j] for j in split), set()).add(
                int(every[r][i]))
        parted += any(len(d) > 1 for d in owners.values())
    return parted


def _sites(log_count, log_wire):
    """A step's collectives by site, split into the forward (with the
    loss's sums and the count), the backward (``bwd:`` sites) and what the
    step issues after the backward (``STEP_SITES``)."""
    out = {"forward": {}, "backward": {}, "step": {}}
    for site, n in log_count.items():
        part = ("backward" if site.startswith("bwd:") else
                "step" if site in STEP_SITES else "forward")
        out[part][site] = (n, int(log_wire.get(site, 0.0)))
    return out


def _spmd_train_run(job, mesh, dtype: str, steps: int, moe_ep: bool,
                    path=None):
    """One run of phase 5q on this rank: the params placed
    (``param_shardings(fsdp=True)``), then ``steps`` train steps under
    ``make_policy``, each timed, with its collectives and flash launches
    counted from 0 just before, the first keeping its gradients before
    clipping where ``path`` holds the single process's; then the blocks
    held against the single process's and each other."""
    import torch

    from repro_torch.distributed.spmd import (
        make_policy, param_shardings, shard_batch)
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.optim import adamw_init
    from repro_torch.training import make_train_step

    cuda = job["device"] == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    cfg = dataclasses.replace(job["cfg"], dtype=dtype)
    pol = make_policy(cfg, mesh, batch=job["batch"], moe_ep=moe_ep)
    params = param_shardings(cfg, mesh, _spmd_weights(job, dtype),
                             moe_ep=moe_ep)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    batch = {k: shard_batch(v, mesh, pol.batch_axes)
             for k, v in _train_batch(job, cfg).items()}
    step = make_train_step(cfg, _train_tcfg(), policy=pol, mesh=mesh)
    out = {"kv_len_sharded": pol.kv_len_sharded,
           "vocab_parallel": pol.vocab_parallel,
           "expert_block": pol.expert_block, "ms": [], "coll_ms": [],
           "sites": [], "launches": [], "metrics": [],
           "setup_s": time.perf_counter() - t0}
    grads = None
    opt = adamw_init(params)
    for i in range(steps):
        pol.log.reset()
        fa.flash_attention.launches = 0
        keep = i == 0 and path is not None
        (params, opt, m, *kept), ms = _timed(
            lambda: step(params, opt, batch, keep_grads=keep), sync)
        grads = kept[0] if kept else grads
        out["ms"].append(ms)
        out["coll_ms"].append(pol.log.seconds * 1e3)
        out["sites"].append(_sites(pol.log.count, pol.log.wire))
        out["launches"].append(fa.flash_attention.launches)
        out["metrics"].append({k: float(v) for k, v in m.items()})
    if cuda:
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["param_bytes"] = _tree_nbytes(params)
    del opt
    t0 = time.perf_counter()
    out["parted"] = _parted_blocks(pol, mesh, params)
    if path is not None:
        out.update(_held_to_single(path, pol, mesh, grads, params,
                                   params["embed"]["w"].device))
    out["checks_s"] = time.perf_counter() - t0
    return out


def _spmd_train_rank(rank: int, world: int, job):
    """One rank of phase 5q: every run of ``job["runs"]`` on
    ``job["shape"]``, in order."""
    import torch

    from repro_torch.launch.mesh import make_host_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if job["device"] == "cuda":
        torch.cuda.set_device(0)
    mesh = make_host_mesh(job["shape"], device=job["device"])
    out = {"rank": rank, "coords": mesh.coords, "runs": []}
    for dtype, steps, moe_ep in job["runs"]:
        out["runs"].append(_spmd_train_run(
            job, mesh, dtype, steps, moe_ep, job["paths"].get(dtype)))
        if job["device"] == "cuda":
            _free_device_memory()
    return out


def _spmd_train_reckon(cfg, shape, moe_ep: bool, batch: int, seq: int,
                       kept: bool) -> tuple:
    """(bytes a train rank should hold at most, the single process's): the
    larger of two moments of a step, each over its parameter blocks P,
    their gradients G, two f32 moments M and, with ``kept``, the first
    step's gradients held for the checks: the update, which makes new
    params, clipped gradients and moments beside the old ones (2 (P + G +
    M)); and the backward, which also holds every layer's gathered
    parameters (no remat) and the loss's f32 logits of one chunk of its
    rows, twice.  Activations are not counted; a rank adds a CUDA
    context."""
    import math

    from repro_torch.distributed.sharding import batch_shard, param_specs
    from repro_torch.distributed.spmd import _axes
    from repro_torch.launch.cells import _spec_leaves
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.models import init_params

    mesh = MeshSpec(("data", "model"), shape)
    full = init_params(cfg, device="meta")
    size = {"data": shape[0], "model": shape[1]}

    def split(spec, axes=("data", "model")):
        return math.prod(size[a] for e in spec for a in _axes(e) if a in axes)

    def peak(blocks, gathered, rows, vp):
        state = blocks * (2 + 2 * 4 / item)            # P + G + M
        logits = 2 * rows * min(SPMD_TRAIN_CHUNK, seq) * vp * 4
        held = blocks if kept else 0.0
        return max(2 * state, state + gathered + logits) + held

    blocks = gathered = 0.0
    for spec, t in _spec_leaves(param_specs(cfg, mesh, moe_ep=moe_ep), full):
        nbytes = t.numel() * t.element_size()
        blocks += nbytes / split(spec)
        if split(spec, ("data",)) > 1:          # an FSDP block, gathered
            gathered += nbytes / split(spec, ("model",))
    item = full["embed"]["w"].element_size()
    m = size["model"]
    rows = batch // math.prod(size[a] for a in _axes(batch_shard(mesh,
                                                                  batch)))
    vp = cfg.vocab_padded // (m if cfg.vocab_padded % m == 0 else 1)
    p_all = sum(t.numel() * t.element_size() for _, t in _spec_leaves(
        param_specs(cfg, MeshSpec(("data", "model"), (1, 1))), full))
    return (peak(blocks, gathered, rows, vp) + CUDA_CONTEXT_BYTES,
            peak(p_all, 0.0, batch, cfg.vocab_padded))


def spmd_train_phase(card: str, job=None) -> None:
    """Phase 5q: ``make_train_step`` under ``make_policy`` over gloo ranks
    sharing the card, each leg (``spmd_train_legs``) against the single
    process's ``make_train_step`` on the same weights and batch, run and
    freed first (its f32 gradients and params kept on the host for the
    ranks).  ``job`` (``spmd_train_job``) defaults to full-width
    qwen3-0.6b and deepseek-moe-16b cut to 2 layers (both MoE)."""
    import os
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.spmd import run_ranks

    job = job or spmd_train_job(get_config("qwen3-0.6b"), dataclasses.replace(
        get_config("deepseek-moe-16b"), n_layers=2))
    cuda = job["device"] == "cuda"
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="spmd-train-")
    refs = {}           # (model, dtype, steps): one single process serves legs
    try:
        for label, key, shape, runs in spmd_train_legs(job):
            leg = dict(job, cfg=job[key])
            t0 = time.perf_counter()
            for dtype, steps in sorted({(r[0], r[1]) for r in runs}):
                if (key, dtype, steps) in refs:
                    continue
                path = (os.path.join(tmp, f"{key}-{dtype}-{steps}.pt")
                        if dtype == "float32" else None)
                refs[key, dtype, steps] = _train_single(leg, dtype, steps,
                                                        path)
                if cuda:
                    _free_device_memory()
            paths = {dtype: refs[key, dtype, steps]["path"]
                     for dtype, steps, _ in runs if dtype == "float32"}
            log(f"  {label} the single process: "
                f"{time.perf_counter() - t0:.1f} s")
            world = int(np.prod(shape))
            t0 = time.perf_counter()
            res = run_ranks(_spmd_train_rank, world, args=(dict(
                leg, shape=shape, runs=runs, paths=paths),),
                timeout=SPMD_TIMEOUT_S)
            log(f"  {label} {world} ranks on {shape}: spawned, ran and joined "
                f"in {time.perf_counter() - t0:.1f} s")
            for i, (dtype, steps, moe_ep) in enumerate(runs):
                _spmd_train_checks(card, label, leg, shape, dtype, moe_ep,
                                   [r["runs"][i] for r in res],
                                   refs[key, dtype, steps], cuda=cuda)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  phase 5q: {time.perf_counter() - t_phase:.1f} s of wall time "
        f"[{card}]")


def _spmd_train_checks(card, label, job, shape, dtype, moe_ep, rows, ref, *,
                       cuda: bool) -> None:
    """Phase 5q's gates on one run of the ranks against the single
    process: every rank's metrics equal, its flash launches the single
    process's a step, every block held alike on the ranks that hold it;
    f32: loss, aux, tokens, lr and grad norm at SPMD_TRAIN_METRIC_RTOL,
    step 0's gradients within SPMD_TRAIN_GRAD_TOL of each leaf's largest,
    the params after the last step within rtol / atol; bf16: finite loss
    and grad norm, the loss gap printed.  Logs ms a step, host ms in
    collectives, collectives and wire bytes a step by site (forward,
    backward, after the backward) and each rank's peak beside its
    reckoning."""
    cfg = job["cfg"]
    name = (f"{label} {cfg.name} {dtype} {shape}"
            + ("" if cfg.moe is None else
               " experts over model" if moe_ep else " expert-TP"))
    r0 = rows[0]
    for i, r in enumerate(rows):
        check(r["metrics"] == r0["metrics"],
              f"{name}: rank {i}'s metrics differ from rank 0's")
        check(r["parted"] == 0, f"{name}: rank {i}: {r['parted']} leaves "
                                f"whose block differs between its holders")
        check(r["launches"] == ref["launches"][:len(r["launches"])],
              f"{name}: rank {i} launched flash {r['launches']} times a "
              f"step, the single process {ref['launches']}")
    if shape == (1, 3):
        check(r0["kv_len_sharded"] and r0["vocab_parallel"],
              f"{name}: attention is not whole on every rank or the vocab is "
              f"not split")
    if cfg.moe is not None:
        check((r0["expert_block"] is not None) == moe_ep,
              f"{name}: the experts' layout is not the run's")
    got, want = r0["metrics"], ref["metrics"]
    if dtype == "float32":
        for i, (g, w) in enumerate(zip(got, want)):
            for k, rtol in SPMD_TRAIN_METRIC_RTOL.items():
                check(abs(g[k] - w[k]) <= rtol * max(abs(w[k]), 1e-6),
                      f"{name}: step {i} {k} {g[k]} against {w[k]}")
            check(g["tokens"] == w["tokens"], f"{name}: tokens differ")
        worst_g = max(zip(r0["grad_err"], r0["keys"]))
        worst_p = max(zip(r0["param_excess"], r0["keys"]))
        check(worst_g[0] <= SPMD_TRAIN_GRAD_TOL,
              f"{name}: gradient of {worst_g[1]} {worst_g[0]:.3e} of its "
              f"largest from the single process's")
        check(worst_p[0] <= SPMD_TRAIN_ATOL,
              f"{name}: params of {worst_p[1]} part by {worst_p[0]:.3e} "
              f"beyond rtol {SPMD_TRAIN_RTOL:g}")
        log(f"  {name}: loss {got[-1]['loss']:.6f} (single "
            f"{want[-1]['loss']:.6f}), aux {got[-1]['aux']:.6f}, grad norm "
            f"{got[-1]['grad_norm']:.6f} (single {want[-1]['grad_norm']:.6f}); "
            f"step 0's gradients within {worst_g[0]:.2e} of each leaf's "
            f"largest (worst {worst_g[1]}; tol {SPMD_TRAIN_GRAD_TOL:g}), "
            f"params after step {len(got)} within rtol {SPMD_TRAIN_RTOL:g} + "
            f"{max(worst_p[0], 0.0):.2e} (atol {SPMD_TRAIN_ATOL:g}); every "
            f"block equal on its holders; flash {r0['launches']} a step on "
            f"every rank")
    else:
        for i, g in enumerate(got):
            check(np.isfinite(g["loss"]) and np.isfinite(g["grad_norm"]),
                  f"{name}: step {i} loss {g['loss']} grad norm "
                  f"{g['grad_norm']}")
        log(f"  {name}: loss {[round(g['loss'], 6) for g in got]} against the "
            f"single process's {[round(w['loss'], 6) for w in want]} (gap "
            f"{max(abs(g['loss'] - w['loss']) for g, w in zip(got, want)):.3e}"
            f"), grad norm {[round(g['grad_norm'], 4) for g in got]}; every "
            f"block equal on its holders; flash {r0['launches']} a step on "
            f"every rank")
    ms = [float(np.median([r["ms"][i] for r in rows]))
          for i in range(len(r0["ms"]))]
    coll = [float(np.median([r["coll_ms"][i] for r in rows]))
            for i in range(len(r0["ms"]))]
    grads_ms = (f"; rank 0 took {r0['setup_s']:.1f} s to make and place "
                f"the weights, {r0['checks_s']:.1f} s for the checks")
    log(f"  {name}: ms a step (median of the ranks) "
        f"{[round(x, 1) for x in ms]} beside the single process's "
        f"{[round(x, 1) for x in ref['ms']]}; host ms in collectives "
        f"{[round(x, 1) for x in coll]}{grads_ms} [{card}]")
    for part, sites in r0["sites"][-1].items():
        n = sum(c for c, _ in sites.values())
        b = sum(w for _, w in sites.values())
        log(f"  {name}: {part}: {n} collectives, {b} bytes a rank sends a "
            f"step (ring wire) "
            f"{json.dumps({k: list(v) for k, v in sorted(sites.items())})}")
    if cuda:
        need, single = _spmd_train_reckon(dataclasses.replace(
            cfg, dtype=dtype), shape, moe_ep, job["batch"], job["seq"],
            kept=dtype == "float32")
        peaks = [r["peak_bytes"] / 2**30 for r in rows]
        log(f"  {name}: peak allocated a rank {[round(p, 3) for p in peaks]} "
            f"GiB + its context, reckoned {need / 2**30:.3f} GiB (parameter "
            f"blocks {r0['param_bytes'] / 2**30:.3f} GiB; the update's old "
            f"and new params, gradients and f32 moments, or the backward's "
            f"gathered layers and logits, with the first step's gradients "
            f"kept at f32 and a {CUDA_CONTEXT_BYTES / 2**30:.1f} GiB "
            f"context; activations not counted); the single process "
            f"{ref['peak_bytes'] / 2**30:.3f} GiB, reckoned "
            f"{single / 2**30:.3f} [{card}]")


SSD_KERNELS = ("ssd_cumsum_kernel", "ssd_cb_kernel", "ssd_chunk_state_kernel",
               "ssd_state_pass_kernel", "ssd_chunk_scan_kernel")
# the first match names the class (the SSD's f32 route is ssd_f32_kernel);
# the dense decode kernels are dec_split_kernel and dec_merge_kernel, the
# paged ones paged_decode_split_kernel and paged_decode_merge_kernel,
# the verify kernels paged_verify_{mma,f32}_kernel and
# paged_verify_merge_kernel
_KERNEL_CLASSES = (("flash_attention", ("fa_kernel", "fa_mma_kernel")),
                   ("ssd_scan", SSD_KERNELS + ("ssd_f32_kernel",)),
                   ("paged_verify_attention", ("paged_verify_mma_kernel",
                                               "paged_verify_f32_kernel",
                                               "paged_verify_merge_kernel")),
                   ("prefix_flash_attention", ("pfx_kernel", "pfx_mma_kernel")),
                   ("paged_decode_attention", ("paged_decode_split_kernel",
                                               "paged_decode_merge_kernel")),
                   ("decode_attention", ("dec_split_kernel",
                                         "dec_merge_kernel")),
                   ("matmul (port)", ("mm_wgmma_kernel", "mm_simt_kernel")),
                   # cuBLASLt's Hopper GEMMs are named nvjet_*
                   ("matmul (cuBLAS)", ("gemm", "cutlass", "xmma", "cublas",
                                        "nvjet")))


# on the MoE path, device time is also split by the op that launched each
# kernel and the profiler range of models/moe.py it ran in: the expert
# products (the batched matmuls in "moe.expert_products") and the dispatch
# ops (top-k, sorts, scatters, gathers and index copies in "moe.dispatch")
_MOE_PRODUCT_OPS = ("aten::bmm", "aten::mm", "aten::matmul", "aten::baddbmm",
                    "aten::addmm")
_MOE_DISPATCH_OPS = ("aten::topk", "aten::sort", "aten::argsort",
                     "aten::scatter", "aten::scatter_", "aten::scatter_add_",
                     "aten::gather", "aten::index", "aten::index_put_",
                     "aten::_index_put_impl_", "aten::index_add_",
                     "aten::index_select", "aten::cumsum")
MOE_PRODUCTS = "MoE expert products"
MOE_DISPATCH = "MoE dispatch (top-k, sort, scatter, gather)"


def _kernel_class(name: str) -> str:
    name = name.lower()
    for cls_name, keys in _KERNEL_CLASSES:
        if any(k in name for k in keys):
            return cls_name
    return "other (elementwise, reductions, copies)"


def _moe_op_class(evt):
    """MOE_PRODUCTS or MOE_DISPATCH for a profiled op inside the matching
    range of ``models/moe.py`` (found through the profiler's
    ``cpu_parent`` links), else None."""
    scope = evt.cpu_parent
    while scope is not None and not scope.name.startswith("moe."):
        scope = scope.cpu_parent
    if scope is None:
        return None
    if scope.name == "moe.expert_products" and evt.name in _MOE_PRODUCT_OPS:
        return MOE_PRODUCTS
    if scope.name == "moe.dispatch" and evt.name in _MOE_DISPATCH_OPS:
        return MOE_DISPATCH
    return None


def _rounds(batcher, n_rounds: int) -> float:
    """Wall time of ``n_rounds`` scheduling rounds of ``batcher``
    (admissions, then chunks), from a sync to a sync."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_rounds):
        batcher.step()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def trace_main_paths(card: str, paths, n_rounds: int = 3):
    """The first rounds of a fresh batcher of each main path in ``paths``
    ((label, make_batcher, must_run, moe) tuples), first all untraced,
    then each under ``torch.profiler`` (device activity; with ``moe``, also
    the host's ops, whose ``models/moe.py`` ranges name the MoE's classes),
    so no untraced window runs after a profiler session: device busy time
    (union of kernel intervals), the idle share against the untraced
    window's wall time, and device time by kernel class, with ``moe`` the
    expert products and the dispatch ops as classes of their own.  Fails
    unless a kernel whose name holds each of ``must_run`` ran in the
    path's traced window and, with ``moe``, unless both MoE classes took
    device time.  Returns {label: (device busy ms,
    decode steps in the traced window)}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    # each window is a fresh batcher from make_batcher(), built (and for
    # the decode window, admitted) before the window opens
    clean = {label: _rounds(make(), n_rounds) for label, make, _, _ in paths}
    busy_by_label = {}
    for label, make, must_run, moe in paths:
        batcher = make()
        steps = batcher.stats.steps
        t0 = time.perf_counter()
        activities = [ProfilerActivity.CUDA]
        if moe:
            activities.append(ProfilerActivity.CPU)
        with profile(activities=activities) as prof:
            traced = _rounds(batcher, n_rounds)
        steps = batcher.stats.steps - steps
        del batcher
        spans, by_class, by_name = [], {}, {}
        for evt in prof.events():
            if moe and evt.device_type == torch.autograd.DeviceType.CPU:
                cls = _moe_op_class(evt) if evt.kernels else None
                for k in (evt.kernels if cls else ()):
                    by_class[cls] = by_class.get(cls, 0.0) + k.duration
                    old = _kernel_class(k.name)
                    by_class[old] = by_class.get(old, 0.0) - k.duration
                continue
            if (evt.device_type != torch.autograd.DeviceType.CUDA
                    or evt.name.startswith("moe.")):
                continue              # the ranges' device spans are no kernels
            start, end = evt.time_range.start, evt.time_range.end
            if end <= start:
                continue
            spans.append((start, end))
            cls = _kernel_class(evt.name)
            by_class[cls] = by_class.get(cls, 0.0) + (end - start)
            by_name[evt.name] = by_name.get(evt.name, 0.0) + (end - start)
        log(f"  {label}: profiler post-processing "
            f"{time.perf_counter() - t0 - traced:.1f} s")
        if not spans:
            log(f"  {label}: device time not measured: the profiler saw no "
                f"CUDA kernels")
            continue
        busy_s = _union_ms(spans) * 1e-3
        log(f"  {label}, first {n_rounds} rounds: {len(spans)} device kernels, "
            f"device busy {busy_s * 1e3:.1f} ms; wall {clean[label]:.3f} s "
            f"untraced ({traced:.3f} s traced) -> device idle share "
            f"{1 - busy_s / clean[label]:.3f} [{card}]")
        total = sum(by_class.values())
        for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
            log(f"    {cls:<42} {us * 1e-3:9.2f} ms  {us / total:6.1%} of "
                f"kernel time")
        log("  top kernels by device time:")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            log(f"    {us * 1e-3:9.2f} ms  {us / total:6.1%}  {name[:90]}")
        for key in must_run:
            names = [n for n in by_name if key in n]
            check(bool(names), f"{label}: no {key} ran in the traced window")
            log(f"  {label} ran {key}: "
                f"{sum(by_name[n] for n in names) * 1e-3:.2f} ms "
                f"({names[0][:70]})")
        if moe:
            check(by_class.get(MOE_PRODUCTS, 0) > 0
                  and by_class.get(MOE_DISPATCH, 0) > 0,
                  f"{label}: no device time traced to the MoE expert "
                  f"products or dispatch ops")
        busy_by_label[label] = (busy_s * 1e3, steps)
    return busy_by_label


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: this smoke test runs on a GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    log("phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}; TF32 off for "
        f"matmul and cuDNN")

    if "--memory" in sys.argv[1:]:
        from repro_torch.configs import get_config
        from repro_torch.models import init_params

        cfg = get_config("qwen3-0.6b")
        admission_memory(init_params(cfg, 0, device="cuda"), cfg, card)
        return 0
    if "--ssd-faults" in sys.argv[1:]:
        log("SSD scan with planted faults against phases 3 and 4")
        return ssd_fault_check()
    if "--kernel-times" in sys.argv[1:]:
        log("flash, dense decode, prefix, verify, SSD, matmul, paged "
            "decode and rmsnorm kernels timed at the main paths' shapes")
        return kernel_times(card)

    log("phase 2: build")
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build(force=True)
    _build.load_library()
    build_s = time.perf_counter() - t0
    log(f"  built {_build.LIB_NAME} in {build_s:.1f} s")
    for line in "\n".join(_build.BUILD_LOG).splitlines():
        if ("Function properties for" in line or "registers" in line
                or "spill" in line or "==" in line):
            log("  " + line.strip())

    if "--spmd-families" in sys.argv[1:]:
        log("phase 5o alone: spmd families")
        spmd_family_phase(card)
        return 0
    if "--spmd-paged" in sys.argv[1:]:
        log("phase 5p alone: the paged, prefix and speculative batchers "
            "under the SPMD policy")
        spmd_paged_phase(card)
        return 0
    if "--spmd-train" in sys.argv[1:]:
        log("phase 5q alone: training under the SPMD policy")
        spmd_train_phase(card)
        return 0

    log("phase 3: kernels against their plain versions")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = [check_flash(gen), check_decode(gen), check_paged_decode(gen),
            check_paged_verify(gen), check_prefix(gen), check_ssd(gen),
            check_rmsnorm(gen), check_matmul(gen)]
    check_decode_stats(gen, card)
    log("  the five attention kernels at group 1 (H = Hkv = 16, dh 128, "
        "bf16), deepseek-moe-16b's heads:")
    for row in group1_times(gen, np.random.default_rng(7)):
        _log_time_row(row, card)
    log("  the kernels at the shapes of qwen2-vl-72b, whisper-base and "
        "jamba-1.5-large (bf16):")
    for row in family_times(gen, np.random.default_rng(8)):
        _log_time_row(row, card)
    log("  training: the flash kernel's log-sum-exp and FlashAttentionFn's "
        "gradients, then their times at the training shape (bf16):")
    check_flash_lse(gen)
    check_flash_grads(gen)
    for row in train_times(gen):
        _log_time_row(row, card)
    torch.cuda.empty_cache()

    log("phase 4: model (cuda kernels) against the plain path")
    check_model()
    check_mamba_model()
    torch.cuda.empty_cache()

    log("phase 4c: the MoE family at full width, bf16, cuda kernels against "
        "the plain path")
    for arch in ("deepseek-moe-16b", "mixtral-8x22b"):
        check_moe_model(card, arch, n_layers=2, dtype="float32")
    check_moe_model(card, "deepseek-moe-16b")
    check_moe_model(card, "mixtral-8x22b", n_layers=2)

    log("phase 4e: train step at full width, 2 layers f32, the flash "
        "kernel's route against the plain path")
    check_train_routes(card, "qwen3-0.6b")
    check_train_routes(card, "deepseek-moe-16b")

    log("phase 5: main path, qwen3-0.6b behind ContinuousBatcher")
    launches, (params, cfg) = serve_main_path(card)

    log("phase 5b: paged main path, qwen3-0.6b behind a paged batcher with "
        "the prefix cache")
    path_launches, paged_tokens = serve_paged_path(card, params, cfg)

    log("phase 5c: speculative path, qwen3-0.6b behind a paged batcher with "
        "the prefix cache, speculative decode and overlap")
    path_launches.update(serve_spec_path(card, params, cfg))

    log("phase 5d: Mamba-2 path, mamba2-370m behind ContinuousBatcher")
    mamba_launches, (mparams, mcfg) = serve_mamba_path(card)
    path_launches.update(mamba_launches)

    log("phase 5e: tenancy, qwen3-0.6b tenants served through the "
        "hypervisor (leases, static stage, regrow between chunks)")
    path_launches.update(serve_tenancy_path(card, params, cfg, build_s))

    log("phase 5f: fault guards, qwen3-0.6b behind phase 5b's batcher with "
        "the page-table audit and the watchdog, three faults injected")
    serve_guarded_path(card, params, cfg, paged_tokens)

    log("phase 5k: tensor-parallel serving, qwen3-0.6b over 1, 2 and 4 "
        "logical cores of the card, and a tenant re-meshed between chunks")
    serve_tp_path(card, params, cfg)

    log("phase 5g: MoE path, full deepseek-moe-16b behind the dense, the "
        "paged (prefix cache) and the speculative (overlap) batchers")
    dparams, dcfg, floor_ms = serve_moe_path(card)

    log("phase 6: where the time goes")
    # the bf16 paths' prefill, prefix, decode, paged decode and verify
    # take the redesigned kernels
    dense_kernels = ("fa_mma_kernel", "dec_split_kernel", "dec_merge_kernel")
    busy = trace_main_paths(card, [
        ("dense path", lambda: _batcher(params, cfg, _requests(cfg)),
         dense_kernels, False),
        ("paged path", lambda: _paged_batcher(params, cfg,
                                              _paged_requests(cfg)),
         ("fa_mma_kernel", "pfx_mma_kernel", "paged_decode_split_kernel",
          "paged_decode_merge_kernel"), False),
        ("spec path", lambda: _spec_batcher(params, cfg,
                                            _spec_requests(cfg)),
         ("paged_verify_mma_kernel", "paged_verify_merge_kernel",
          "pfx_mma_kernel"), False),
        ("mamba2 path", lambda: _mamba_batcher(mparams, mcfg,
                                               _mamba_requests(mcfg)),
         SSD_KERNELS, False),
        ("moe path", lambda: _batcher(dparams, dcfg, _requests(dcfg)),
         dense_kernels, True),
        # 8 requests admitted before the window: its rounds are pure chunks
        ("moe decode", lambda: _admitted(_batcher(
            dparams, dcfg, _requests(dcfg, n=8, seed=9, max_new=64))),
         ("dec_split_kernel", "dec_merge_kernel"), True)])
    if "moe decode" in busy:
        busy_ms, steps = busy["moe decode"]
        log(f"  moe decode: {busy_ms / steps:.2f} ms of device time a decode "
            f"step ({steps} steps), beside the {floor_ms:.2f} ms floor to "
            f"read the routed experts once [{card}]")
    del dparams
    _free_device_memory()

    log("phase 5l: training, qwen3-0.6b uncut (bf16 params, f32 moments, "
        "the flash kernel), 8 x 512 tokens a step")
    train_launches, tparams, tcfg, tbatch = serve_train_path(card)
    log("phase 6 (training): where a training step's time goes")
    trace_train_window(card, tparams, tcfg, tbatch)
    del tparams, tbatch
    _free_device_memory()
    log(f"  flash launches on the training path (a): {train_launches}")

    family_phases(card)

    log("phase 5m: the cell matrix (the dry-run on meta) and three "
        "full-width qwen3-0.6b cells timed against their roofline")
    serve_cells(card)
    _free_device_memory()

    log("phase 5n: runtime SPMD, full-width qwen3-0.6b over gloo ranks "
        "sharing the card: (a) length-sharded decode on (data 2, model 3), "
        "(b) head-aligned on (1, 2), (c) a compressed train step on (pod 2)")
    spmd_phase(card)
    _free_device_memory()

    log("phase 5o: spmd families, the policy for mamba2, deepseek (both MoE "
        "layouts), jamba, whisper and qwen2-vl over gloo ranks sharing the "
        "card")
    spmd_family_phase(card)
    _free_device_memory()

    log("phase 5p: the dense, paged + prefix and speculative + overlap "
        "batchers under the SPMD policy, full-width qwen3-0.6b over gloo "
        "ranks sharing the card: (a) (data 2, model 2), (b) (1, 3) "
        "length-sharded")
    spmd_paged_phase(card)
    _free_device_memory()

    log("phase 5q: training under the SPMD policy over gloo ranks sharing "
        "the card: (a) full-width qwen3-0.6b on (data 2, model 2) with FSDP, "
        "f32 then bf16, (b) on (1, 3), (c) deepseek-moe-16b cut to 2 layers "
        "on (1, 2), experts over model then expert-TP")
    spmd_train_phase(card)
    _free_device_memory()

    for row in rows:
        # each kernel's launches on the path that runs it: flash on the
        # dense path (it runs on both), the others on their own path
        row["launches"] = (launches[row["name"]] if row["name"] in launches
                           else path_launches[row["name"]])
        _log_time_row(row, card)
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
