#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times
    python3 chip_smoke.py --decode-times

Phases, each checked; any failed check exits non-zero before the last line:

  1. device   the card's name, capability (9, 0), name and power limit
              from nvidia-smi; TF32 switched off for fp32 matmuls and convs.
  2. build    every kernel of repro_torch/kernels/csrc/ compiled by nvcc for
              sm_90a from the checkout's sources, one nvcc each, together;
              ptxas's register and spill report of each; the HMMA
              (tensor-core) instructions in the SASS of flash_attn_fwd and
              ssd_scan counted (cuobjdump -sass), none failing the run.
  3. kernels  each kernel against its plain PyTorch version on the same CUDA
              tensors, over shapes (5, 64, 64), (5, 7, 64) (ragged) and
              (5, 4096, 96), link widths {1, 2, 4, 8, 16, 32} and fp32/bf16
              latents.  Rows with an entry whose pre-quantization value lies
              within 1e-6 of a rounding midpoint may differ at b < 32 in the
              sample mode; they are counted.
                cut_fwd        modes {sample, analytic, none}: u identical,
                               the rate within rtol 1e-5, atol 1e-5;
                cut_bwd        the three modes: dmu, dlv, deps within
                               rtol 1e-5, atol 1e-6;
                cut_prior_fwd  modes {sample, analytic}, shared (d,) and
                  cut_prior_bwd  per-node (J, d) priors: u identical, the
                               per-row gradients within rtol 1e-5 atol 1e-6
                               (both read one saved u, so on every row),
                               and two launches of cut_prior_bwd identical
                               bit for bit.  The sums — the rate, dpmu,
                               dplv — within rtol/atol 1e-5, or, where
                               their terms cancel, within 1e-5 of the sum
                               of the terms' absolute values (fp32 sums in
                               two orders; such sums are counted); dpmu and
                               dplv equal bit for bit to the plain sums in
                               the kernel's order
                               (ref.cutlayer_prior_bwd_sums_ordered).  Then
                               cut_prior_bwd on J in {1, 5} nodes of T in
                               {1, 65, 4097} rows (its 8-row chunks and
                               ~264-block grid), d in {64, 37}: the same
                               checks, three launches and two replays of
                               one CUDA-graph capture identical;
              and torch.autograd.grad through ops.cutlayer on CUDA equal to
              the kernels' outputs for the same cotangents.  The packed
              wire's kernels over the same shapes, widths
              b in {1, 2, 3, 4, 8, 16} and fp32/bf16:
                cut_fwd_pack   modes {sample, analytic, none}: (u, rate)
                               identical to cut_fwd's, u and the lanes
                               identical to the plain version's (rows at a
                               rounding midpoint excepted and counted);
                pack           the lanes of u identical to cut_fwd_pack's
                               and the plain version's (bf16 at b <= 8; at
                               b > 8 pack_values must refuse bf16);
                unpack_dequant unpack(lanes) == u bit for bit, and equal to
                               the plain version; then at every b in 1..16,
                               d in {7, 33, 64, 100}, R in {1, 7, 257}, fp32
                               and bf16, on lanes one row into their
                               allocation: equal to the plain version bit
                               for bit, unpack(pack(u)) == u (fp32; bf16 at
                               b <= 8);
                pack           then at every b in 1..16, d in {7, 33, 64,
                               100}, R in {1, 7, 257}, fp32 and bf16 (b <=
                               8), on values one row into their allocation,
                               off-grid (past the clip range, a quarter at
                               rounding midpoints) and on the grid: the
                               lanes equal the plain version's bit for bit,
                               unpack(pack(u)) == u on the grid.
  4. serving  INLScheme at PaperExperimentConfig() (the paper's full width)
              on the card from a seeded generator, a ServingEngine over
              buckets (1, 4, 16, 64) answering requests through its
              scheduler thread.  Launch counts are set to 0 just before and
              read just after; the cut kernel must have launched exactly once
              per engine launch.  Answers must be finite rows summing to 1,
              equal bit for bit to the port's predict on the card in the same
              bucket, within atol 1e-4 of the port on the CPU, and fully
              delivered on the meter.
  5. training the main path: run_scheme("inl") at PaperExperimentConfig(),
              batch 64, 1024 synthetic samples, 2 epochs (32 train steps, two
              evaluations), launch counts set to 0 just before and read just
              after.  Every loss finite; the mean loss of the last 4 rounds
              below the first 4's; final accuracy >= 0.3; gbits equal to
              32 x training_step_bits(64, 320, 32) / 1e9 exactly; cut_bwd
              launched once per step, cut_fwd once per step plus once per
              evaluation, the prior kernels never.  Then 8 steps with
              learned_prior=True: each prior kernel once per step, cut_fwd
              and cut_bwd never, and the priors moved from zero.
  5b. packed the packed wire at PaperExperimentConfig(link_bits=8), batch
              64, each path with launch counts set to 0 just before and read
              just after: run_scheme("inl", wire="packed") (cut_fwd_pack,
              unpack_dequant and cut_bwd once per step, cut_fwd once per
              evaluation, pack never); one packed step equal to one dense
              step bit for bit (loss and every gradient leaf, under
              torch.use_deterministic_algorithms); wire="packed_duplex";
              learned_prior=True on "packed" (the prior kernels, pack and
              unpack_dequant once per step); run_scheme("sl",
              wire="packed") (cut_fwd, pack, unpack_dequant and cut_bwd
              once per step, cut_fwd once more per evaluation); and
              run_scheme("fl") rounds (cut_fwd and cut_bwd once per local
              step).  Every loss finite and falling; the measured bytes
              exactly 320 x 16 x 4 forward + 320 x 64 x 4 backward per
              packed round and 2 x 320 x 16 x 4 per duplex round (the
              closed form's 2 x 64 x 320 x 8 bits).
  6. cpu      card against CPU: one set of weights, eps and dropout masks
              drawn on the CPU and moved to the card, 3 steps on each.  Step
              1's loss within rtol 1e-3, atol 1e-5, and every gradient leaf
              as a tensor: |card - cpu| <= 1e-3 |cpu| + 1e-5 sqrt(n) in the
              2-norm (entries outside the entrywise bar are counted); the
              losses of steps 2-3 within rtol 1e-3.
  6b. topology non-star graphs at full width, batch 64, each through
              run_scheme("inl", topology=...) for 16 steps with launch counts
              set to 0 just before and read just after: chain(5) at
              link_bits=8 on "packed" and "packed_duplex" (cut_fwd and
              cut_bwd once per step, pack and unpack_dequant 5 times a step,
              once per edge), tree(2, 2) dense with six views, and
              chain(5, link_bits=(2, 4, 8, 8, 32)) dense (cut_fwd and cut_bwd
              once per first-hop width group, 4 a step); cut_fwd once more
              per group for the evaluation.  Losses finite and falling, the
              meter's per-edge bits and bytes steps x the closed forms and
              wirefmt sizes (measured == closed form on duplex and fp32
              links).  One step on the packed chain(5) == the dense chain(5)
              == the star bit for bit; step 1 of the packed chain(5) and of
              tree(2, 2) against the CPU port as in phase 6; chain(5) served
              on the packed wire over buckets (1, 4, 16, 64): one cut_fwd and
              5 pack and unpack_dequant an engine launch, rows bit for bit
              equal to predict on the card in their bucket.
  6c. linkfault unreliable links (core/linkfault) at full width, batch 64:
              LinkModel() on every edge against no link model, 4 INL steps
              on the star, one FL round and 4 steps on the packed chain(5),
              deterministic algorithms on: losses and every state leaf bit
              for bit.  Then through run_scheme, launch counts set to 0 just
              before each run and read just after, at the reference's
              headline settings (benchmarks/links_bench.py: erasure 0.3 an
              edge, INL with edge_dropout 0.2): INL on the star (16 steps),
              with learned priors (8), at link_bits=8 packed (16), the
              packed chain(5) at erasure 0.1 an edge (16), FL (4 rounds) and
              SL (16 rounds, the first seed with a skipped round): every
              kernel launched as on the clean network (one cut_fwd and one
              cut_bwd a lossy INL step, five pack and five unpack_dequant a
              lossy packed chain(5) step), the meter's delivery ratio equal
              to the ratio the replayed masks imply, SL's skipped rounds
              leaving the state as it was and every other round moving it.
              One lossy step (an explicit mask, two views lost) on the card
              against the CPU port as in phase 6.  The star with
              LinkModel(latency_ms=1, jitter_ms=1) and deadline_ms=2 served
              over buckets (1, 4, 16, 64): one cut_fwd an engine launch,
              about e^-1 of the views missed (5 sigma), each request's mask
              the same in its bucket as alone, rows equal to predict_batched
              under the id-keyed masks bit for bit in their bucket, the
              meter's delivery ratio the masks' fraction.
  6d. hybrids the hybrid schemes at full width, batch 64
              (`hybrids:` lines): run_scheme("splitfed") and
              run_scheme("hybrid") (hybrid_fl_clients=(0,)) for 16 rounds
              on the dense star, with cut_depth=1, at link_bits=4 on
              "packed_duplex" and on the packed chain(5) at link_bits=8,
              launch counts set to 0 just before each and read just after:
              the loss falls, the launches as predicted (the dense star 17
              cut_fwd and 16 cut_bwd, the duplex star 16 cut_fwd_pack,
              unpack_dequant and cut_bwd, the chain 80 pack and
              unpack_dequant), the meter's per-edge bits and bytes 16 x the
              closed form from the shapes and, on the star, 16 x the
              reference's ledgers.  LinkModel() on every edge == no link
              model for 4 rounds of each, bit for bit; erasure 0.3 an edge
              for 16 rounds: the launches as clean, the delivery ratio the
              replayed masks' payload fraction, SplitFed's survivors one
              average bit for bit and a dead client not that average, the
              hybrid's weight client 0 keeping its rows bit for bit exactly
              when its route died.  One round of each, card against the CPU
              port at the phase-6 bar.  Each trained state served over
              buckets (1, 4, 16, 64), clean and at erasure 0.3: one cut_fwd
              an engine launch, rows == predict_batched bit for bit in
              their bucket.
  6e. graphs  CUDA graphs (repro_torch/graphs.py), deterministic
              algorithms on (`graphs:` lines): run_scheme under "scan"
              (the default: one captured round replayed per round) and
              under "per_round" from one seed (GRAPH_SEED), one epoch of
              16 rounds at batch 64 each, for inl, inl with learned
              priors, sl, fl, splitfed and hybrid on the dense star, INL at
              link_bits=8 on "packed" and "packed_duplex" and on the packed
              chain(5), and each of the six at erasure 0.3 an edge, launch
              counts set to 0 just before each run and read just after:
              every round's loss and every leaf of the final state bit for
              bit, the same launches per kernel, the same curve and
              offered and delivered ledgers, and exactly one capture per
              host signature (SL's keep/skip, FL's all/none/partial n).
              The trained INL state served over buckets (1, 4, 16, 64),
              clean and at erasure 0.3, three batches a bucket after
              warmup(): trace_counts == {b: 1}, rows == the eager
              predict_batched bit for bit, one cut_fwd an engine launch.
              Phases 4-6d hook rounds, so they run "per_round"; their
              engines replay graphs too.
  6h. sharded run_scheme(mesh=) (core/sharded.py) at full width, one epoch
              of 16 rounds a run (`sharded:` lines, `sharded_phase`): one
              NCCL rank in this process under "scan" (its collectives
              captured with the round) bit for bit against the graphs
              phase's single-device runs; 2 and 5 gloo ranks spawned on
              the one card ((client=1, data=2), (client=5, data=1)),
              eager: every round replayed on the mesh from the
              single-device state (loss within rtol 1e-4; moments, model
              state and parameters within 1e-2 a leaf), the free-running
              losses within a drift limit bracketed by a one-ulp control
              and a planted fault; packed == dense bit for bit and the
              fan-in's bytes of one round at client=5; INL's round time
              on each layout (`sharded times:`).
  6i. transport the fault-tolerant transport (repro_torch/transport,
              chaos, cluster; `transport:` lines), at full width, batch
              64, deterministic algorithms on: run_scheme(transport=)
              for 16 rounds over a lossy star (erasure 0.1, latency
              5 + Exp(10) ms, a 40 ms deadline, DEFAULT_RETRY, the default
              breakers, m0's edge down and m2's flapping) for INL dense
              and packed, INL with learned priors packed (link_bits=8),
              FL and SL, launch counts set to 0 just before each and read
              just after: each == the eager make_transport_round replay
              of its own masks bit for bit (losses, every state leaf),
              the masks a second transport's of the same seed, one
              capture per host signature, offered and delivered bits per
              edge == attempts x charge and surviving fraction x charge;
              INL with an adaptive controller, 2 epochs == 1 + resume bit
              for bit (curve, checkpoints, snapshots: breakers, opens,
              short-circuits, adaptive state); the trained state served
              over socket channels, speculative, a 20 ms deadline, three
              batches a bucket: each launch == predict_batched under its
              masks bit for bit, patched > 0, views_recovered == the
              reports' stragglers, the credited ledger == the consumed
              masks, one capture per bucket; run_poisson at 0.5x and 2x
              the serial capacity; a Cluster of five worker processes,
              m1 SIGKILLed and m3 SIGSTOPped on a schedule, under 16 INL
              rounds: masks == the scheduled windows, one respawn;
              chaos.cluster_drill; `transport times:` (a transport round
              against the graphed lossy round, round_outcome alone, the
              served p50 and p99 at each load).
  7. times    per-bucket predict latency, train-step latency (median of 20
              steps, with the device busy time and idle share from the
              profiler, and the device time by kernel) on the dense,
              packed and duplex wires, on the packed chain(5), tree(2, 2)
              and the mixed-width chain, and on the lossy star beside the
              clean one (`linkfault times:`), one dense round of splitfed,
              hybrid, SL and FL beside INL's (`hybrids times:`), each of
              those five rounds and the predict per bucket graphed beside
              eager (`graphs times:`: wall, device time from CUDA events
              around back-to-back replays, idle share), and each
              kernel's device time beside its bound and its plain version
              (cut_prior_bwd, unpack_dequant and pack beside their first
              designs' times, with cut_prior_bwd's first two launches
              apart), with the card's name and power limit on every line.
  8. llm      the LLM stack, Zamba2-2.7B, then the attention-block models:
                llm kernels  flash_attn_fwd against its plain version over
                             (B, S, H, KV, Dh) in {(1,128,4,4,32),
                             (2,256,8,2,64), (1,256,8,1,64), (2,192,32,32,80)
                             (ragged), (1,512,2,2,128), (2,512,32,32,80),
                             (4,512,32,32,80) (the serving prefill's),
                             (2,200,16,16,192) (MLA's head dim, ragged)},
                             causal, window {0, 100}, q_offset {0, 64} on a
                             q slice; ssd_scan (y and the final state) over
                             (B, S, H, P, N, chunk) in {(1,128,2,32,16,32),
                             (2,256,4,64,64,128), (1,192,2,16,8,64),
                             (2,512,80,64,64,256), (4,512,80,64,64,256)
                             (the serving prefill's)}; fp32 within 2e-5 and
                             bf16 within 2e-2 (absolute for attention,
                             relative to the plain max for the scan); the
                             scan's chunk 64 against chunk 128;
                llm serving  the full config in bf16 from a seeded
                             generator: prefill and two decode steps give
                             finite logits, and each kernel against its
                             plain version on the very inputs that prefill
                             gave it (9 attention and 54 scan calls, bf16,
                             the bars above); serve_batch for 4 requests x
                             prompt 512 x 32 tokens, launch counts set to 0
                             just before and read just after: exactly 9
                             flash_attn_fwd and 54 ssd_scan (one prefill;
                             decode launches neither), tokens in the
                             vocabulary, peak memory;
                llm graphs   B=4 after a prompt of 512, 32 tokens,
                             deterministic algorithms on: the decode loop
                             on the graphed step (steps.make_decode_step)
                             == the loop on the eager step from one
                             prefill, ids and every cache leaf bit for
                             bit, one capture (trace_log); serve_batch
                             gives the eager ids with one capture;
                llm fp32     one period (num_layers=6) at full width in
                             fp32, the adapter drawn N(0, 1/d_model) in
                             place of init's 1e-4 scale so the shared
                attention moves the logits: the card against the CPU on one
                set of weights, prefill 512 and 8 decode steps fed
                             the CPU's tokens within rtol/atol 1e-3, greedy
                             tokens equal where the CPU's top-2 margin
                             exceeds 1e-2 (closer calls counted); prefill of
                             256 against prefill of 255 + one decode step
                             within 1e-3;
                times        prefill latency at (4, 512) and (4, 2048) and
                             decode latency per token (eager, and graphed
                             beside it), with device busy time,
                             idle share and the prefill's time in the top
                             kernels and in the two hand-written ones (the
                             profiler); both kernels' device time at
                             (4, 512) and (4, 2048) beside the bound, the
                             plain version, the first (SIMT) kernels' times
                             from PERF.md, the scan's four launches by the
                             profiler and, for attention,
                             scaled_dot_product_attention (timed only);
                llm attn     each attention-block model in bf16 at its
                             published widths (ATTN_MODELS): Llama-3.2-1B,
                             Qwen1.5-4B, StarCoder2-3B, CodeQwen1.5-7B at
                             full depth, Arctic-480B at 1 layer and
                             DeepSeek-V2-236B at 3 (its dense layer 0 and
                             two MoE layers); one prefill at B=4, P=512,
                             launch counts set to 0 just before and read
                             just after, exactly one flash_attn_fwd a
                             layer (16, 40, 30, 32, 1, 3; DeepSeek's at
                             Dh=192), each call against its plain version
                             on its own inputs at the bf16 bar, two decode
                             steps with finite logits, peak memory;
                             Llama-3.2-1B then served, 4 requests x 512 x
                             32 tokens: 16 launches (the decode steps
                             none), wall time and the graphed decode per
                             token; flash_attn_fwd at Dh=192, H=KV=128,
                             B=4, S=512 and 2048 beside its bound, the
                             plain version and
                             scaled_dot_product_attention;
                llm zoo      the reference's last three architectures in
                             bf16 at published widths, full depth but
                             xLSTM's 1 of 3 periods
                             (ZOO_MODELS): MusicGen-medium through
                             tokens_mc (the prompt on its 4 codebooks),
                             InternVL2-2B on 256 seeded N(0, 1) patch
                             embeddings before 256 text tokens, and
                             xLSTM-125M; one prefill at B=4 over 512
                             positions, launch counts set to 0 just before
                             and read just after: exactly 48 flash_attn_fwd
                             at Dh=64, 24 at Dh=128 and none for xLSTM
                             (every counter 0), each flash call against its
                             plain version on its own inputs at the bf16
                             bar; the prefill's ms; MusicGen and xLSTM
                             served 4 x 512 x 32 (48 and 0 launches, the
                             decode none, one capture), InternVL2 two
                             graphed decode steps with finite logits; the
                             graphed decode per token, peak memory; under
                             deterministic algorithms 8 graphed decode
                             steps == 8 eager ones bit for bit (ids and
                             logits, one capture); prefill of 512 + one
                             decode step against prefill of 513: on an
                             fp32 twin of the model (its bf16 weights in
                             fp32) within rtol/atol 1e-3, in bf16 within
                             3x the bf16 prefill's deviation from the
                             twin's plus the twin's gap; one xLSTM period
                             (num_layers=4) in fp32 on the card against
                             the CPU port, prefill 512 and 8 decode steps
                             fed the CPU's tokens within rtol/atol 1e-3;
                             the phase's seconds.
  9. llm train  every architecture's train mode, deterministic algorithms
                on (TF32 off): flash_attn_fwd's logsumexp at Llama-3.2-1B's
                (4, 2048, 32, 8, 64) in bf16 and fp32 and DeepSeek-V2's
                MLA (1, 2048, 128, 128, 192) in bf16 within LSE_BAR of the
                plain version's, o with the lse written == o without it
                bit for bit; on those inputs flash_attn_bwd from the
                kernel's (o, lse) within 2e-2 of the largest |gradient| of
                the plain backward (`ref.flash_bwd_ref`, the reference's
                `_flash_bwd`) from the plain forward's, autograd through
                `blockwise_attention` == the kernel's bit for bit;
                flash_attn_bwd against `ref.flash_bwd_ref` on the same
                inputs (BWD_CASES: the StarCoder2 cells' (1, 4096, 24, 2,
                128) and (8, 512, 24, 2, 128), every other head dim, a
                window, q_offset, ragged Sq and Sk, fp32) within
                BWD_BF16_ULP / FP32_BAR, two launches bit for bit, one
                counted a call, its ms beside its bound and the plain
                version's;
                Llama-3.2-1B at full width, 2 layers, fp32: the loss and
                every gradient leaf on the card against the CPU port
                (rtol 1e-3, the INL step's bar) and one make_train_step's
                loss and grad_norm; DeepSeek-V2 cut
                to 2 layers (dense layer 0, one MoE layer; 5.4 B
                parameters) in bf16: one loss_and_metrics forward and
                backward at B=1, S=2048, ce, lb_loss, z_loss and every
                gradient finite, exactly 3 flash launches at Dh=192 and
                2 flash_attn_bwd (one a layer), ms
                and peak memory; the SSD scan's autograd Function
                (`ssm._ssd_chunked`) at Zamba2's (4, 2048, 80, 64, 64,
                256) and at a three-chunk shape, fp32 and bf16: its
                forward == ssd_scan bit for bit, its backward (the plain
                fp32 recompute) == autograd through ssd_chunked_ref in fp32
                bit for bit and within 2e-2 of the largest |gradient| in
                bf16, every gradient finite though a chunk's dt |a| passes
                the ~88 at which the reference's backward gives NaN, its ms
                and the memory it holds; Zamba2-2.7B at full width cut to
                2 of 9 periods (12 mamba layers, 2 shared-attention calls,
                0.77 B parameters) in bf16, B=4, S=2048: 4 steps of
                make_scan_train_step, exactly 96 ssd_scan and 16 flash
                launches (and 8 flash_attn_bwd), losses finite and
                falling, a step's ms, tokens/s, peak memory; its fp32 twin
                at 1 period, B=1, S=512, card against the CPU (loss within
                rtol 1e-5, every leaf within
                the INL step's bar); xLSTM-125M at its published widths
                cut to 1 of 3 periods (4 layers) in bf16, B=4, S=256 (one
                checkpointed 256-step chunk): 1 step, no kernel, the
                loss finite, ms a step, peak memory;
                its fp32 twin at 1 period, B=1, S=128, card against the
                CPU; INL over Llama-3.2-1B at full width, 3 layers (4
                encoders of 2, a 1-layer decoder), d_b=512, link_bits=4
                (the packed wire), bf16, B=2, S=2048: 2 steps of
                make_scan_train_step(scheme="inl") with AdamW without its
                fp32 master copy (with it, the update outgrows the card
                after the earlier phases), exactly one cut_fwd,
                cut_bwd, pack and unpack_dequant a step and 36 flash
                launches (18 flash_attn_bwd), losses finite, ms a step,
                peak memory (and a forward and backward's alone); INL over
                the Llama smoke config in fp32 at link_bits 16, 8, 4 and 4
                with learned
                priors, card against the CPU with their launches; the
                multi-tensor AdamW on INL over StarCoder2-3B's leaves (3
                layers, 1.8 B parameters): 2 donated scan steps, one
                adamw_norm and one adamw_update a step, its norm within
                1e-6 of global_norm, its update == ref.adamw_update_ref_
                bit for bit given that norm, two runs bit for bit, its ms
                beside its bound, the functional update's and
                torch._fused_adamw_'s; the phase's seconds.  Every train
                run through make_scan_train_step (donated on the card)
                also expects one adamw_norm and one adamw_update a step.

 10. llm launch the launcher at full width, in-process: `python -m
                repro_torch.launch.train --arch llama3.2-1b --steps 8
                --batch 4 --seq 2048 --scan-steps 4` through `train.main`
                (bf16, remat on, groups of 4 prefetched to the card):
                every loss finite and the last below the first, exactly
                2 x 16 x 8 = 256 flash launches (a forward and a recompute
                a layer a step) and 128 flash_attn_bwd, a step's ms (the
                second group's wall / 4), tokens/s, peak memory; a short
                run (the smoke config, 4 groups of 2) at --prefetch 1 and
                2, the losses and grad
                norms bit for bit; `chaos.crash_resume_check` with the
                reference's chaos defaults (smoke Llama, scheme inl, 12
                steps, SIGKILL after step 5) on the card, dense and with
                learned priors side by side: resumed lines and final
                checkpoints bit for bit, the cut-layer kernels (and
                flash_attn_fwd and flash_attn_bwd, fp32) launched in the
                golden and the resumed child; DeepSeek-V2's MoE layer at
                published widths in bf16, droppless, over 2 spawned gloo
                ranks on the card (80 experts a rank) against moe_apply in
                this process: y
                within 2e-2 of the largest |y|, aux within 1e-5, the
                layer's ms; the dry-run's record of the CLI's step on a
                1-rank mesh: argument bytes == the tensors' own and, in
                512-byte blocks, == memory_allocated to the byte, the
                model FLOPs over the measured step as a share of 989
                TFLOP/s; the phase's seconds.
 11. tracing    with --tracing only: the phase marks (repro_torch/tracing)
                of graphed INL and FL rounds at full width, one epoch
                function captured with marks and one without, timed in
                turns by CUDA events around 100 / 20 rounds, their split;
                the rounds under the profiler with spans on and off; INL
                over StarCoder2-3B (3 layers, bf16, deterministic) at
                B=1 S=4096 and B=8 S=512, eager steps with marks on and
                off, the split, the allocator's retries, and the split of
                steps the profiler recorded against the rest.

The line before the last two is {"kernels": [...]} (flash_attn_fwd's
Dh=192 instance in an entry of its own, with DeepSeek-V2's launches; the
flash entry's counts per attention-block model, and MusicGen's and
InternVL2's, `launches_on_attn_models`;
the cut-layer kernels
of the hybrids' path with their counts per run, `launches_on_hybrids`,
every cut-layer kernel's counts in the graphed runs,
`launches_on_graphs`, and in the transport phase's runs,
`launches_on_transport`; the flash entry's counts in the train runs,
`launches_on_train`, its lse error, `lse_max_abs_err`; a
flash_attn_bwd entry with its ms, bound and plain ms on BWD_CASES,
`by_case`; ssd_scan's counts in Zamba2's train run,
`launches_on_train`, and the plain SSD backward's ms,
`train_backward_ms`; the cut-layer and wire kernels' counts in INL over
an LLM, `launches_on_inl_llm`, and in the crash-resume children,
`launches_on_crash_resume`; an adamw entry with its ms, bound, the
functional update's ms as plain_ms and torch._fused_adamw_'s as
library_ms),
the one before the last
nvidia-smi's name and power limit, and the last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.

With --kernel-times it runs phase 1, builds the cut-layer kernels and
prints only their device times (phase 7's kernel lines, each kernel a call
launches by name with its time), and no result line; with --decode-times
it builds the two LLM kernels and prints only Zamba2-2.7B's decode
latency per token (phase 8's `llm decode latency` and graphed decode
lines, seeded weights), and no result line; with --llm-train (--llm-launch) it builds
the LLM kernels, AdamW's and the cut-layer kernels and runs only phase 9 (10),
and no result line; with --tracing it builds the same kernels and runs
only phase 11, the phase marks' cost and what they read (`tracing:`
lines), and no result line.  Either times
the checkout it sits in: to compare two checkouts on one card, copy it into both and run
them in turns, one after another on the same card.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DEV = "cuda"                        # the card: every phase runs there
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (NVIDIA data sheet)
MIDPOINT_TOL = 1e-6
RATE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
PRIOR_GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
CARD_CPU_TOL = dict(rtol=1e-3, atol=1e-5)
CPU_ATOL = 1e-4
BUCKETS = (1, 4, 16, 64)
N_REQUESTS = 256
SWEEP_SHAPES = ((5, 64, 64), (5, 7, 64), (5, 4096, 96))
SWEEP_BITS = (1, 2, 4, 8, 16, 32)
TRAIN_BATCH = 64
TRAIN_SAMPLES = 1024
TRAIN_EPOCHS = 2
PRIOR_STEPS = 8
PRIOR_GEOMETRY_T = (1, 65, 4097)    # rows a node: 8-row chunks, ~264 blocks
PACK_BITS = (1, 2, 3, 4, 8, 16)
WIRE_BITS = 8                       # the packed wire's width on the path
PACKED_SAMPLES = 1024               # 16 steps of 64 in one epoch
FL_ROUNDS = 4                       # each round: 5 clients x 2 local steps
GRAPH_SAMPLES = 1024                # 16 steps of 64 in one epoch
TREE_STDS = (0.4, 1.0, 2.0, 3.0, 4.0, 0.7)   # the reference's test_topology
HET_BITS = (2, 4, 8, 8, 32)         # chain(5)'s per-edge widths
PROFILE_TRIES = 3
BF16_FLOPS = 989e12                 # H100 SXM dense bf16 tensor cores
FP32_BAR, BF16_BAR = 2e-5, 2e-2     # the bars of tests/test_kernels.py
FLASH_CASES = ((1, 128, 4, 4, 32), (2, 256, 8, 2, 64), (1, 256, 8, 1, 64),
               (2, 192, 32, 32, 80), (1, 512, 2, 2, 128), (2, 512, 32, 32, 80),
               (4, 512, 32, 32, 80), (2, 200, 16, 16, 192))
SSD_CASES = ((1, 128, 2, 32, 16, 32), (2, 256, 4, 64, 64, 128),
             (1, 192, 2, 16, 8, 64), (2, 512, 80, 64, 64, 256),
             (4, 512, 80, 64, 64, 256))
LLM_B, LLM_PROMPT, LLM_GEN = 4, 512, 32    # Zamba2 serving: requests, tokens
LLM_CPU_TOL = dict(rtol=1e-3, atol=1e-3)
LLM_CPU_STEPS = 8
LLM_MARGIN = 1e-2                   # top-2 logit margin of a decided token
LLM_CONSIST_P = 255                 # P and P + 1 both prefill in one chunk
TENSOR_CORE_KERNELS = ("flash_attn_fwd", "flash_attn_bwd", "ssd_scan")
# what an LLM train step launches besides the cut layer: built before the
# first timed or phase-marked run
LLM_TRAIN_KERNELS = TENSOR_CORE_KERNELS + ("adamw",)
# the attention-block models served in the `llm attn` phase: (arch, depth on
# the card (None: the full config), flash_attn_fwd launches per prefill)
ATTN_MODELS = (("llama3.2-1b", None, 16), ("qwen1.5-4b", None, 40),
               ("starcoder2-3b", None, 30), ("codeqwen1.5-7b", None, 32),
               ("arctic-480b", 1, 1), ("deepseek-v2-236b", 3, 3))
MLA_HEADS, MLA_DH = 128, 192        # DeepSeek-V2's prefill attention
# the models of the `llm zoo` phase, each at its full config in bf16:
# (arch, flash_attn_fwd launches per prefill, their head dim)
# (arch, flash launches a prefill, their head dim, depth: None = full);
# xLSTM at 1 of its 3 periods (its eager cells make a full-depth prefill
# 3 s, and the phase runs ten)
ZOO_MODELS = (("musicgen-medium", 48, 64, None),
              ("internvl2-2b", 24, 128, None), ("xlstm-125m", 0, None, 4))
ZOO_STEPS = 8                       # graphed == eager decode steps
# prefill of P + decode against prefill of P + 1 in bf16: decode's own
# bf16 error (its roundings and two more a layer, q·scale and p) is taken
# as at most twice the prefill's, so by the triangle inequality the bf16
# gap is at most 3x the bf16 prefill's deviation from its fp32 twin plus
# the fp32 twin's own handover gap
ZOO_HANDOVER_NOISE = 3.0
XLSTM_PERIOD = 4                    # ("mlstm",) * 3 + ("slstm",)
# the `llm train` phase: flash_attn_fwd's lse and the attention backward on
# the train path's shapes (label, (B, S, H, KV, Dh), dtype): Llama-3.2-1B's
# and DeepSeek-V2's MLA
LSE_CASES = (("Llama-3.2-1B attention", (4, 2048, 32, 8, 64), "bfloat16"),
             ("Llama-3.2-1B attention", (4, 2048, 32, 8, 64), "float32"),
             ("DeepSeek-V2 MLA attention", (1, 2048, 128, 128, 192),
              "bfloat16"))
# |lse kernel - plain|: both sum the same fp32 terms in other orders (the
# tensor cores' fp32 accumulation, exp2f against expf): ~1e-5 on lse ~ 8-10;
# an lse error d scales every p of the backward by e^-d, so 1e-4 moves the
# gradients by 1e-4 of themselves, 200x under the bf16 bar
LSE_BAR = 1e-4
# flash_attn_bwd against its plain version on the same inputs (label,
# (B, Sq, Sk, H, KV, Dh, window, q_offset), dtype): the two StarCoder2 cells'
# attention, each other head dim (Llama-3.2-1B, Zamba2, DeepSeek-V2's MLA),
# a window, q_offset with ragged Sq and Sk, and the fp32 instance
BWD_CASES = (
    ("train-4k", (1, 4096, 4096, 24, 2, 128, 0, 0), "bfloat16"),
    ("train-512", (8, 512, 512, 24, 2, 128, 0, 0), "bfloat16"),
    ("Dh=32", (4, 1024, 1024, 16, 4, 32, 0, 0), "bfloat16"),
    ("Llama-3.2-1B", (4, 2048, 2048, 32, 8, 64, 0, 0), "bfloat16"),
    ("Zamba2 window", (2, 2048, 2048, 32, 32, 80, 512, 0), "bfloat16"),
    ("DeepSeek-V2 MLA", (1, 2048, 2048, 128, 128, 192, 0, 0), "bfloat16"),
    ("ragged q_offset", (2, 1000, 1537, 24, 2, 128, 0, 537), "bfloat16"),
    ("ragged window q_offset", (1, 777, 1300, 16, 4, 64, 300, 523),
     "bfloat16"),
    ("fp32 Dh=64", (1, 1024, 1024, 32, 8, 64, 0, 0), "float32"),
    ("fp32 ragged window q_offset", (1, 500, 700, 8, 2, 128, 256, 200),
     "float32"),
    ("fp32 Dh=192", (1, 512, 512, 16, 16, 192, 0, 0), "float32"),
    ("fp32 Dh=80 ragged", (2, 333, 333, 8, 8, 80, 0, 0), "float32"),
    ("fp32 Dh=32", (1, 256, 256, 8, 2, 32, 0, 0), "float32"))
# the bf16 bar of an entry: both versions round each gradient once, so
# where the two fp32 values straddle a rounding midpoint they come one ulp
# apart (up to 2^-7 of the value); the kernel's P and dS enter their
# products as bf16 hi + lo (about 2^-16 of themselves) and its fp32 sums
# run in another order, which moves the fp32 values far less (2^-12 of the
# largest).  fp32: the same terms summed in another order, expf against
# torch's exp, no final rounding: FP32_BAR of the largest
BWD_BF16_ULP, BWD_BF16_ABS = 2.0 ** -7, 2.0 ** -12
# the benchmark cell zamba2-7b.lm-2x4096: its shared attention calls (B, S,
# H, KV, Dh) at the published scale (Dh / 2)^-1/2, its grouped scan (B, S,
# H, P, N, G, chunk), and the 12-layer stage (published layers 12-23: ten
# Mamba2 layers, two hybrids) trained one step at B x S
ZAMBA7_ATTN = (2, 4096, 32, 32, 224)
ZAMBA7_SCALE = (224 / 2) ** -0.5
ZAMBA7_SSD = (2, 4096, 112, 64, 64, 2, 256)
ZAMBA7_LAYERS = 12
ZAMBA7_BATCH = (2, 4096)
LLM_TRAIN_BATCH = (4, 2048)         # Llama's full-width train step, B x S
LLM_TRAIN_STEPS = 8
LLM_TRAIN_CPU_LAYERS = 2            # Llama's fp32 card-vs-CPU step
LLM_TRAIN_CPU_BATCH = (1, 256)
# the recurrent blocks' train mode and INL over an LLM (`llm train`):
# the SSD scan's autograd Function on (label, (B, S, H, P, N, chunk)):
# Zamba2-2.7B's full shape, and one with three chunks
SSD_TRAIN_CASES = (("Zamba2-2.7B", (4, 2048, 80, 64, 64, 256)),
                   ("nc=3", (2, 768, 16, 64, 64, 256)))
ZAMBA_TRAIN_PERIODS = 2             # of 9: 12 of 54 layers, ~0.77 B params
ZAMBA_TRAIN_BATCH = (4, 2048)
ZAMBA_TRAIN_STEPS = 4
ZAMBA_CPU_BATCH = (1, 512)          # one period in fp32: two SSD chunks
XLSTM_TRAIN_BATCH = (4, 256)        # one 256-step checkpointed chunk
XLSTM_TRAIN_STEPS = 1                # one step (the launch phase's room)
XLSTM_CPU_BATCH = (1, 128)          # one period in fp32
INL_LLM_LAYERS = 3                  # Llama-3.2-1B: 2 encoder layers, 1 dec
INL_LLM_BITS = 4                    # the packed wire
INL_LLM_BATCH = (2, 2048)
INL_LLM_STEPS = 2
INL_CPU_BITS = (16, 8, 4)           # smoke width, fp32, card vs CPU
# the cut-layer and wire kernels INL over an LLM launches at link_bits < 8
INL_LLM_KERNELS = ("cut_fwd", "cut_bwd", "pack", "unpack_dequant")
INL_LLM_RUN = f"inl over llama3.2-1b {INL_LLM_STEPS} steps"
# the multi-tensor AdamW on the leaves of the cell inl-starcoder2-3b (INL
# over StarCoder2-3B at published widths, 3 of 30 layers, bf16, fp32
# master): its parameter count, the scan steps that drive it (B, S), the
# updates timed, and the plain norm's agreement
ADAMW_PARAMS = 1_797_892_608
ADAMW_SCAN = (2, 1, 512)            # K steps of make_scan_train_step, B, S
ADAMW_TIMED = 10
ADAMW_NORM_RTOL = 1e-6
# the llm launch phase: launch.train at full width, the crash-resume check
# on the card, DeepSeek-V2's MoE layer over 2 gloo ranks, the dry-run
LAUNCH_STEPS, LAUNCH_GROUP, LAUNCH_BATCH = 8, 4, (4, 2048)
LAUNCH_ARGV = ("--arch", "llama3.2-1b", "--steps", str(LAUNCH_STEPS),
               "--batch", str(LAUNCH_BATCH[0]), "--seq", str(LAUNCH_BATCH[1]),
               "--scan-steps", str(LAUNCH_GROUP), "--device", DEV)
LAUNCH_RUN = f"llama3.2-1b launch.train {LAUNCH_STEPS} steps"
# --prefetch 1 against 2 on a short run: the smoke config, 4 groups of 2
PREFETCH_ARGV = ("--arch", "llama3.2-1b", "--smoke", "--steps", "8",
                 "--batch", "2", "--seq", "32", "--scan-steps", "2",
                 "--device", DEV)
CHAOS_ARGS = dict(arch="llama3.2-1b", scheme="inl", steps=12, batch=2,
                  seq=32, scan_steps=2, ckpt_every=2, kill_after_step=5,
                  seed=0)             # the reference's chaos defaults
CHAOS_TIMEOUT = 240.0
EP_ARCH, EP_BATCH, EP_RANKS = "deepseek-v2-236b", (2, 1024), 2
EP_TIMEOUT = 240.0
LAUNCH_PHASE_BUDGET_S = 120.0
H100_BF16_FLOPS = 989e12              # NVIDIA's data sheet, dense bf16
LOSS_RTOL = 1e-5                    # an fp32 train loss, card vs CPU
# graph_ms of the first, SIMT (fp32 FMA) kernels at the bf16 shapes of
# llm_kernel_timing, (kernel, S) -> ms: the final chip_smoke.py run that
# measured them on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md section 6)
SIMT_MS = {("flash_attn_fwd", 512): 0.4703, ("flash_attn_fwd", 2048): 5.0504,
           ("ssd_scan", 512): 0.6286, ("ssd_scan", 2048): 2.5219}
# device ms (profiler) of the first designs of the three redesigned
# kernels, at the shapes of new_kernel_timing / pack_kernel_timing,
# (kernel, R) -> ms: the final chip_smoke.py run that measured them on an
# NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md section 6)
FIRST_DESIGN_MS = {("cut_prior_bwd", 320): 0.00982,
                   ("cut_prior_bwd", 20480): 0.03317,
                   ("cut_prior_bwd", 262144): 0.54090,
                   ("unpack_dequant", 320): 0.00182,
                   ("unpack_dequant", 20480): 0.00750,
                   ("unpack_dequant", 262144): 0.07647,
                   ("pack", 320): 0.00176,
                   ("pack", 20480): 0.00642,
                   ("pack", 262144): 0.06924}
# the first design of cut_prior_bwd ran two launches; (rows, reduce) device
# ms by kernel name, R -> ms: this script's --kernel-times run in a checkout
# of that design, NVIDIA H100 80GB HBM3, 700.00 W (PERF.md section 6)
FIRST_PRIOR_BWD_STAGES = {320: (0.00856, 0.00125),
                          20480: (0.02247, 0.01116),
                          262144: (0.23076, 0.31338)}
# the kernels redesigned after their first designs, and how
REDESIGNED = {"cut_prior_bwd": "one launch, parallel fixed-order reduction",
              "unpack_dequant": "one thread per lane word, vector stores",
              "pack": "one thread per lane word, vector loads"}


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def device_phase(torch):
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    card = smi()
    print(f"device: {name} capability {cap} count "
          f"{torch.cuda.device_count()}")
    print(f"nvidia-smi: {card}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    check(cap == (9, 0), f"capability {cap}, the kernels are built for "
                         "sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    return name, card


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def build_phase(names=None):
    """Build every kernel (or `names`); with every kernel, count the LLM
    kernels' tensor-core instructions."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    seconds = build.build_all(names)
    print(f"build: {sorted(seconds)} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc, sm_90a, one process "
          f"per source)")
    for name, log in sorted(build.build_logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    if names is None:
        tensor_core_phase(build)


def tensor_core_phase(build):
    """The bf16 paths of the LLM kernels run on tensor cores: count the
    HMMA instructions in the SASS of their libraries (cuobjdump -sass),
    beside ptxas's spill report of each library."""
    cuobjdump = Path(build.nvcc()).parent / "cuobjdump"
    parts = []
    for name in TENSOR_CORE_KERNELS:
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(build._library_path(name))],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        hmma = sum("HMMA" in line for line in sass.splitlines())
        ldsm = sum("LDSM" in line for line in sass.splitlines())
        spills = sorted({line.split(",", 1)[1].strip()
                         for line in build.build_logs.get(name, "")
                         .splitlines() if "spill" in line})
        check(hmma > 0, f"{name}: no HMMA instruction in its SASS; its bf16 "
                        f"path does not run on tensor cores")
        parts.append(f"{name} {hmma} HMMA, {ldsm} LDSM (ptxas: "
                     f"{'; '.join(spills) or 'no report, built earlier'})")
    print("tensor cores: " + "; ".join(parts))


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def near_midpoint(pre64: np.ndarray, bits: int) -> np.ndarray:
    r = 4.0
    scale = ((1 << bits) - 1) / (2.0 * r)
    t = (np.clip(pre64, -r, r) + r) * scale
    return np.abs(t - np.floor(t) - 0.5) / scale < MIDPOINT_TOL


def cut_inputs(torch, shape, dtype, seed):
    rng = np.random.default_rng(seed)
    mu = rng.normal(scale=2.0, size=shape).astype(np.float32)
    lv = rng.uniform(-3.0, 3.0, size=shape).astype(np.float32)
    eps = rng.normal(size=shape).astype(np.float32)
    return (torch.from_numpy(mu).cuda().to(dtype),
            torch.from_numpy(lv).cuda().to(dtype),
            torch.from_numpy(eps).cuda())


def kernel_phase(torch):
    from repro_torch.kernels import ops, ref
    worst = 0.0
    midpoints = 0
    n = 0
    for shape in SWEEP_SHAPES:
        d = shape[-1]
        for bits in SWEEP_BITS:
            for mode in ("sample", "analytic", "none"):
                for dtype in (torch.float32, torch.bfloat16):
                    mu, lv, eps = cut_inputs(torch, shape, dtype, bits)
                    u, rate = ops.cutlayer(mu, lv, eps, link_bits=bits,
                                           rate_estimator=mode)
                    pu, prate = ref.cutlayer_fwd_ref(
                        mu.reshape(-1, d), lv.reshape(-1, d),
                        eps.reshape(-1, d), bits, mode)
                    torch.cuda.synchronize()
                    check(u.dtype == dtype and rate.dtype == torch.float32,
                          f"dtypes {u.dtype}, {rate.dtype}")
                    a = u.float().cpu().numpy().reshape(-1, d)
                    b = pu.float().cpu().numpy()
                    diff = a != b
                    bad_rows = np.zeros(a.shape[0], bool)
                    if diff.any():
                        check(bits < 32, f"u differs at b=32 ({mode}, "
                                         f"{dtype}, {shape})")
                        pre = (mu.double() + torch.exp(0.5 * lv.double())
                               * eps.double()).cpu().numpy().reshape(-1, d)
                        mid = near_midpoint(pre, bits)
                        check(not (diff & ~mid).any(),
                              f"{int((diff & ~mid).sum())} u entries differ "
                              f"away from a midpoint ({mode}, b={bits}, "
                              f"{dtype}, {shape})")
                        midpoints += int(diff.sum())
                        bad_rows = diff.any(axis=-1)
                    ra = rate.cpu().numpy().reshape(-1)[~bad_rows]
                    rb = prate.cpu().numpy()[~bad_rows]
                    check(np.allclose(ra, rb, **RATE_TOL),
                          f"rate differs ({mode}, b={bits}, {dtype}, "
                          f"{shape}): max {np.abs(ra - rb).max()}")
                    if ra.size:
                        worst = max(worst, float(np.abs(ra - rb).max()))
                    worst = max(worst, float(np.abs(a - b)[~diff].max()))
                    n += 1
    torch.cuda.synchronize()
    print(f"kernels: cut_fwd == plain on {n} cases (3 shapes x 6 widths x "
          f"3 modes x 2 dtypes); {midpoints} u entries at a rounding "
          f"midpoint; max |kernel - plain| {worst:.3g}")
    return worst


def grad_inputs(torch, shape, dtype, seed):
    """cut_inputs plus the cotangents: gu (shape) in `dtype`, grate
    (shape[:-1]) fp32 at the small scale of a training step's rate
    cotangent."""
    mu, lv, eps = cut_inputs(torch, shape, dtype, seed)
    rng = np.random.default_rng(seed + 7)
    gu = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    gr = rng.normal(scale=0.1, size=shape[:-1]).astype(np.float32)
    return mu, lv, eps, gu.cuda().to(dtype), torch.from_numpy(gr).cuda()


def prior_inputs(torch, J, d, seed):
    rng = np.random.default_rng(seed + 11)
    pm = rng.normal(scale=0.5, size=(J, d)).astype(np.float32)
    pv = rng.uniform(-1.0, 1.0, size=(J, d)).astype(np.float32)
    return torch.from_numpy(pm).cuda(), torch.from_numpy(pv).cuda()


def midpoint_rows(torch, mu, lv, eps, bits):
    """Rows (flattened leading axes) with an entry near a rounding
    midpoint; none at b = 32."""
    d = mu.shape[-1]
    if bits >= 32:
        return np.zeros(mu.numel() // d, bool)
    pre = (mu.double() + torch.exp(0.5 * lv.double()) * eps.double()) \
        .cpu().numpy().reshape(-1, d)
    return near_midpoint(pre, bits).any(axis=-1)


def compare_rows(got, want, tol, what):
    """Per-row comparison of (rows, d) outputs: returns (bool rows that
    fail `tol`, max |got - want| over the entries that pass)."""
    a = got.float().cpu().numpy().reshape(got.shape[0], -1)
    b = want.float().cpu().numpy().reshape(want.shape[0], -1)
    check(a.shape == b.shape, f"{what}: shapes {a.shape} vs {b.shape}")
    close = np.isclose(a, b, **tol)
    err = float(np.abs(a - b)[close].max()) if close.any() else 0.0
    return ~close.all(axis=-1), err


def allow_midpoints(bad, mid, mode, bits, what):
    """Failing rows are allowed only at rounding midpoints in the sample
    mode at b < 32; returns how many there were."""
    if bad.any():
        check(mode == "sample" and bits < 32 and not (bad & ~mid).any(),
              f"{what}: {int((bad & ~mid).sum())} rows differ away from a "
              f"rounding midpoint")
    return int(bad.sum())


def bwd_kernel_phase(torch):
    """cut_bwd against cutlayer_bwd_ref over the sweep."""
    from repro_torch.kernels import inl_bottleneck, ref
    worst, midpoints, n = 0.0, 0, 0
    for shape in SWEEP_SHAPES:
        d = shape[-1]
        for bits in SWEEP_BITS:
            for mode in ("sample", "analytic", "none"):
                for dtype in (torch.float32, torch.bfloat16):
                    mu, lv, eps, gu, gr = grad_inputs(torch, shape, dtype,
                                                      bits)
                    rows = [t.reshape(-1, d) for t in (mu, lv, eps, gu)]
                    k = inl_bottleneck.cut_bwd(*rows, gr.reshape(-1),
                                               bits=bits, mode=mode)
                    p = ref.cutlayer_bwd_ref(*rows, gr.reshape(-1), bits,
                                             mode)
                    torch.cuda.synchronize()
                    what = f"cut_bwd {mode} b={bits} {dtype} {shape}"
                    check([t.dtype for t in k] == [dtype, dtype,
                                                   torch.float32],
                          f"{what}: dtypes {[t.dtype for t in k]}")
                    bad = np.zeros(rows[0].shape[0], bool)
                    for a, b in zip(k, p):
                        rb, err = compare_rows(a, b, GRAD_TOL, what)
                        bad |= rb
                        worst = max(worst, err)
                    midpoints += allow_midpoints(
                        bad, midpoint_rows(torch, mu, lv, eps, bits), mode,
                        bits, what)
                    n += 1
    print(f"kernels: cut_bwd == plain on {n} cases (3 shapes x 6 widths x "
          f"3 modes x 2 dtypes, rtol 1e-5 atol 1e-6); {midpoints} rows at "
          f"a rounding midpoint; max |kernel - plain| {worst:.3g}")
    return worst


def sum_scales(torch, mu, lv, u, pm, pv, gr, mode):
    """Float64 sums of the absolute values of the terms that the prior
    kernels add up: per row for the rate, per (node, column) for dpmu and
    dplv.  A sum that cancels can lose its relative digits in fp32 however
    it is ordered; these scales say how far."""
    m, l, q = mu.double(), lv.double(), u.double()
    p, v = pm.double()[:, None, :], pv.double()[:, None, :]
    g = gr.double()[..., None].abs()
    if mode == "sample":
        rate = (q - p) ** 2 * torch.exp(-v) + v.abs() \
            + (q - m) ** 2 * torch.exp(-l) + l.abs()
        wq = (q - p) * torch.exp(-v)
        dpmu = (g * wq.abs()).sum(1)
        dplv = 0.5 * (g.sum(1) + (g * (wq * (q - p)).abs()).sum(1))
    else:
        rate = v.abs() + l.abs() + (torch.exp(l) + (m - p) ** 2) \
            * torch.exp(-v) + 1.0
        dm = (m - p) * torch.exp(-v)
        dpmu = (g * dm.abs()).sum(1)
        dplv = 0.5 * (g.sum(1) + (g * torch.exp(l - v)).sum(1)
                      + (g * (dm * (m - p)).abs()).sum(1))
    return 0.5 * rate.sum(-1), dpmu, dplv


def sums_close(got, want, scale, keep, what):
    """A sum agrees within rtol/atol 1e-5 of its value or, where its terms
    cancel, within 1e-5 of the sum of their absolute values.  Returns (how
    many entries needed the second bar, max |got - want|)."""
    a = got.double().cpu().numpy().ravel()[keep]
    b = want.double().cpu().numpy().ravel()[keep]
    sc = scale.cpu().numpy().ravel()[keep]
    diff = np.abs(a - b)
    plain = diff <= 1e-5 + 1e-5 * np.abs(b)
    scaled = diff <= 1e-5 * sc
    bad = ~(plain | scaled)
    check(not bad.any(),
          f"{what}: {int(bad.sum())} sums differ: max |diff| "
          f"{diff[bad].max() if bad.any() else 0}, value "
          f"{b[bad][:3] if bad.any() else ''}, scale "
          f"{sc[bad][:3] if bad.any() else ''}")
    return int((~plain).sum()), float(diff.max()) if diff.size else 0.0


def prior_kernel_phase(torch):
    """cut_prior_fwd / cut_prior_bwd against their plain versions over the
    sweep, shared and per-node priors; the backward twice, bit for bit."""
    from repro_torch.kernels import inl_bottleneck, ref
    worst = {"cut_prior_fwd": 0.0, "cut_prior_bwd": 0.0}
    midpoints, cancelling, n = 0, 0, 0
    for shape in SWEEP_SHAPES:
        d = shape[-1]
        for bits in SWEEP_BITS:
            for mode in ("sample", "analytic"):
                for prior in ("shared", "node"):
                    for dtype in (torch.float32, torch.bfloat16):
                        mu, lv, eps, gu, gr = grad_inputs(torch, shape,
                                                          dtype, bits)
                        J = 1 if prior == "shared" else shape[0]
                        mu, lv, eps, gu = (t.reshape(J, -1, d)
                                           for t in (mu, lv, eps, gu))
                        gr = gr.reshape(J, -1)
                        pm, pv = prior_inputs(torch, J, d, bits)
                        what = (f"prior {prior} {mode} b={bits} {dtype} "
                                f"{shape}")
                        u, rate = inl_bottleneck.cut_prior_fwd(
                            mu, lv, eps, pm, pv, bits=bits, mode=mode)
                        pu, prate = ref.cutlayer_prior_fwd_ref(
                            mu, lv, eps, pm, pv, bits, mode)
                        k1 = inl_bottleneck.cut_prior_bwd(
                            mu, lv, eps, pm, pv, u, gu, gr, mode=mode)
                        k2 = inl_bottleneck.cut_prior_bwd(
                            mu, lv, eps, pm, pv, u, gu, gr, mode=mode)
                        p = ref.cutlayer_prior_bwd_ref(
                            mu, lv, eps, pm, pv, u, gu, gr, bits, mode)
                        o = ref.cutlayer_prior_bwd_sums_ordered(
                            mu, lv, pm, pv, u, gr, mode)
                        torch.cuda.synchronize()
                        check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
                              f"{what}: two launches of cut_prior_bwd "
                              f"differ")
                        check(torch.equal(k1[3], o[0])
                              and torch.equal(k1[4], o[1]),
                              f"{what}: dpmu, dplv differ from the ordered "
                              f"plain sums")
                        # forward: u identical but at midpoints; the rate
                        # on the rows whose u agrees
                        mid = midpoint_rows(torch, mu, lv, eps, bits)
                        R = mid.shape[0]
                        bad_u = (u != pu).reshape(R, d).any(-1).cpu().numpy()
                        midpoints += allow_midpoints(bad_u, mid, mode, bits,
                                                     what + " u")
                        s_rate, s_pmu, s_plv = sum_scales(
                            torch, mu, lv, u, pm, pv, gr, mode)
                        c, err = sums_close(rate, prate, s_rate, ~bad_u,
                                            what + " rate")
                        cancelling += c
                        worst["cut_prior_fwd"] = max(worst["cut_prior_fwd"],
                                                     err)
                        # backward: both read the same saved u, so every
                        # row must agree
                        for name, a, b in zip(("dmu", "dlv", "deps"), k1[:3],
                                              p[:3]):
                            rb, err = compare_rows(a.reshape(R, d),
                                                   b.reshape(R, d),
                                                   GRAD_TOL, what)
                            check(not rb.any(), f"{what}: {name} differs "
                                  f"on {int(rb.sum())} rows beyond rtol "
                                  f"1e-5 atol 1e-6")
                            worst["cut_prior_bwd"] = max(
                                worst["cut_prior_bwd"], err)
                        for name, a, b, sc in (("dpmu", k1[3], p[3], s_pmu),
                                               ("dplv", k1[4], p[4], s_plv)):
                            c, err = sums_close(a, b, sc, slice(None),
                                                f"{what} {name}")
                            cancelling += c
                            worst["cut_prior_bwd"] = max(
                                worst["cut_prior_bwd"], err)
                        n += 1
    print(f"kernels: cut_prior_fwd and cut_prior_bwd == plain on {n} cases "
          f"(3 shapes x 6 widths x 2 modes x shared/per-node x 2 dtypes); "
          f"cut_prior_bwd identical bit for bit over two launches, its "
          f"dpmu and dplv equal to the ordered plain sums bit for bit; "
          f"{midpoints} rows at a rounding midpoint; {cancelling} rate or "
          f"prior-gradient sums that cancel held to 1e-5 of the sum of "
          f"|terms|; max |kernel - plain| fwd {worst['cut_prior_fwd']:.3g} "
          f"bwd {worst['cut_prior_bwd']:.3g}")
    worst["cut_prior_bwd"] = max(worst["cut_prior_bwd"],
                                 prior_geometry_phase(torch))
    return worst


def prior_geometry_phase(torch):
    """cut_prior_bwd on rows that fill, straddle and overrun its 8-row
    chunks and its ~264-block grid (T in PRIOR_GEOMETRY_T, J in {1, 5}), at
    an even d (column pairs) and an odd one, fp32 and bf16, both modes:
    dpmu, dplv equal the ordered plain sums bit for bit, the per-row
    gradients the plain backward within rtol 1e-5, atol 1e-6; three
    launches identical; one CUDA-graph capture replayed twice identical to
    the eager call.  Returns the max |kernel - plain| of the row
    gradients."""
    from repro_torch.kernels import inl_bottleneck, ref
    worst, n = 0.0, 0
    for J in (1, 5):
        for T in PRIOR_GEOMETRY_T:
            for d in (64, 37):
                for dtype in (torch.float32, torch.bfloat16):
                    mu, lv, eps, gu, gr = grad_inputs(torch, (J, T, d),
                                                      dtype, T + d)
                    pm, pv = prior_inputs(torch, J, d, T)
                    for mode in ("sample", "analytic"):
                        what = f"cut_prior_bwd J={J} T={T} d={d} {dtype} " \
                               f"{mode}"
                        u, _ = inl_bottleneck.cut_prior_fwd(
                            mu, lv, eps, pm, pv, bits=WIRE_BITS, mode=mode)

                        def call():
                            return inl_bottleneck.cut_prior_bwd(
                                mu, lv, eps, pm, pv, u, gu, gr, mode=mode)
                        runs = [call() for _ in range(3)]
                        graph = torch.cuda.CUDAGraph()
                        with torch.cuda.graph(graph):
                            captured = call()
                        replays = []
                        for _ in range(2):
                            for t in captured:
                                t.fill_(float("nan"))
                            graph.replay()
                            replays.append([t.clone() for t in captured])
                        o = ref.cutlayer_prior_bwd_sums_ordered(
                            mu, lv, pm, pv, u, gr, mode)
                        p = ref.cutlayer_prior_bwd_ref(
                            mu, lv, eps, pm, pv, u, gu, gr, WIRE_BITS, mode)
                        torch.cuda.synchronize()
                        check(all(same_bits(a, b) for k in runs[1:] + replays
                                  for a, b in zip(runs[0], k)),
                              f"{what}: three launches and two graph "
                              f"replays are not identical")
                        check(same_bits(runs[0][3], o[0])
                              and same_bits(runs[0][4], o[1]),
                              f"{what}: dpmu, dplv differ from the ordered "
                              f"plain sums")
                        for name, a, b in zip(("dmu", "dlv", "deps"),
                                              runs[0][:3], p[:3]):
                            rb, err = compare_rows(a.reshape(J * T, d),
                                                   b.reshape(J * T, d),
                                                   GRAD_TOL, what)
                            check(not rb.any(), f"{what}: {name} differs "
                                  f"on {int(rb.sum())} rows")
                            worst = max(worst, err)
                        del graph
                        n += 1
    print(f"kernels: cut_prior_bwd geometry on {n} cases (J in {{1, 5}} x "
          f"T in {PRIOR_GEOMETRY_T} x d in {{64, 37}} x 2 dtypes x 2 "
          f"modes): dpmu, dplv == ordered plain sums bit for bit, three "
          f"launches and two CUDA-graph replays identical; max |kernel - "
          f"plain| of the row gradients {worst:.3g}")
    return worst


def autograd_phase(torch):
    """torch.autograd.grad through ops.cutlayer on CUDA == the kernels'
    outputs for the same cotangents, with and without a learned prior."""
    from repro_torch.kernels import inl_bottleneck, ops
    shape, d = (5, 64, 64), 64
    for mode, bits in (("sample", 8), ("sample", 32), ("analytic", 4),
                       ("none", 2)):
        mu, lv, eps, gu, gr = grad_inputs(torch, shape, torch.float32, bits)
        ins = [t.clone().requires_grad_() for t in (mu, lv)]
        u, rate = ops.cutlayer(*ins, eps, link_bits=bits,
                               rate_estimator=mode)
        got = torch.autograd.grad((u, rate), ins, (gu, gr))
        want = inl_bottleneck.cut_bwd(mu.reshape(-1, d), lv.reshape(-1, d),
                                      eps.reshape(-1, d), gu.reshape(-1, d),
                                      gr.reshape(-1), bits=bits, mode=mode)
        check(all(torch.equal(a.reshape(-1, d), b)
                  for a, b in zip(got, want)),
              f"autograd through ops.cutlayer != cut_bwd ({mode}, b={bits})")
        if mode == "none":
            continue
        pm, pv = prior_inputs(torch, shape[0], d, bits)
        ins = [t.clone().requires_grad_() for t in (mu, lv, pm, pv)]
        u, rate = ops.cutlayer(ins[0], ins[1], eps, link_bits=bits,
                               rate_estimator=mode, prior_mu=ins[2],
                               prior_logvar=ins[3])
        got = torch.autograd.grad((u, rate), ins, (gu, gr))
        k = inl_bottleneck.cut_prior_bwd(mu, lv, eps, pm, pv, u.detach(), gu,
                                         gr, mode=mode)
        want = (k[0], k[1], k[3], k[4])
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"autograd through ops.cutlayer(prior) != cut_prior_bwd "
              f"({mode}, b={bits})")
    print("kernels: torch.autograd.grad through ops.cutlayer on CUDA equals "
          "cut_bwd and cut_prior_bwd bit for bit (4 standard, 3 prior "
          "cases)")


def same_bits(a, b) -> bool:
    """Equal bit for bit (uint32 lanes through an int32 view)."""
    import torch
    if a.dtype == torch.uint32 and b.dtype == torch.uint32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def pack_kernel_phase(torch):
    """cut_fwd_pack, pack and unpack_dequant against their plain versions
    and against cut_fwd, over the sweep at the packable widths."""
    from repro_torch.kernels import inl_bottleneck, ref
    worst = {"cut_fwd_pack": 0.0, "pack": 0.0, "unpack_dequant": 0.0}
    midpoints, n = 0, 0
    for shape in SWEEP_SHAPES:
        d = shape[-1]
        for bits in PACK_BITS:
            for mode in ("sample", "analytic", "none"):
                for dtype in (torch.float32, torch.bfloat16):
                    mu, lv, eps = (t.reshape(-1, d) for t in
                                   cut_inputs(torch, shape, dtype, bits))
                    what = f"pack {mode} b={bits} {dtype} {shape}"
                    u, lanes, rate = inl_bottleneck.cut_fwd_pack(
                        mu, lv, eps, bits=bits, mode=mode)
                    u1, rate1 = inl_bottleneck.cut_fwd(mu, lv, eps,
                                                       bits=bits, mode=mode)
                    pu, plan, prate = ref.cutlayer_pack_fwd_ref(
                        mu, lv, eps, bits, mode)
                    back = inl_bottleneck.unpack(lanes, d=d, bits=bits,
                                                 dtype=dtype)
                    pback = ref.unpack_dequant_ref(lanes, d, bits,
                                                   dtype=dtype)
                    torch.cuda.synchronize()
                    check(u.dtype == dtype and lanes.dtype == torch.uint32
                          and lanes.shape == (mu.shape[0],
                                              ref.packed_width(d, bits)),
                          f"{what}: {u.dtype} {lanes.dtype} {lanes.shape}")
                    check(same_bits(u, u1) and same_bits(rate, rate1),
                          f"{what}: (u, rate) differ from cut_fwd's")
                    check(same_bits(back, u) and same_bits(pback, back),
                          f"{what}: unpack(lanes) != u or != its plain "
                          f"version")
                    # the plain version: lanes and u equal but on rows at a
                    # rounding midpoint
                    mid = midpoint_rows(torch, mu, lv, eps, bits)
                    bad = ((lanes.view(torch.int32) != plan.view(torch.int32))
                           .any(-1) | (u != pu).any(-1)).cpu().numpy()
                    check(not (bad & ~mid).any(),
                          f"{what}: {int((bad & ~mid).sum())} rows differ "
                          f"from the plain version away from a midpoint")
                    midpoints += int(bad.sum())
                    keep = torch.from_numpy(~bad).to(DEV)
                    rb, err = compare_rows(rate[keep][:, None],
                                           prate[keep][:, None], RATE_TOL,
                                           what + " rate")
                    check(not rb.any(), f"{what}: rate differs from the "
                          f"plain version")
                    worst["cut_fwd_pack"] = max(worst["cut_fwd_pack"], err)
                    if dtype == torch.float32 or bits <= 8:
                        k = inl_bottleneck.pack(u, bits=bits)
                        p = ref.pack_values_ref(u, bits)
                        torch.cuda.synchronize()
                        check(same_bits(k, lanes) and same_bits(p, lanes),
                              f"{what}: pack(u) differs from the lanes")
                    else:
                        try:
                            inl_bottleneck.pack_values(u, link_bits=bits)
                        except ValueError:
                            pass
                        else:
                            check(False, f"{what}: pack_values took bf16 "
                                         f"values at {bits} bits")
                    n += 1
    print(f"kernels: cut_fwd_pack, pack, unpack_dequant on {n} cases (3 "
          f"shapes x 6 widths x 3 modes x 2 dtypes): (u, rate) == cut_fwd "
          f"bit for bit, lanes == plain, unpack(pack(u)) == u bit for bit; "
          f"{midpoints} rows at a rounding midpoint; max |rate - plain| "
          f"{worst['cut_fwd_pack']:.3g}")
    unpack_width_phase(torch)
    pack_width_phase(torch)
    return worst


def unpack_width_phase(torch):
    """unpack_dequant at every b in 1..16 (vpw a power of two or not, lanes
    with unused bits), d in {7, 33, 64, 100} (a row's last word partly
    used; row starts off the vector's alignment), R in {1, 7, 257}, fp32
    and bf16, on lanes that start one row into their allocation: equal to
    the plain version bit for bit, and unpack(pack(u)) == u where pack
    takes the type (fp32, or bf16 at b <= 8)."""
    from repro_torch.kernels import inl_bottleneck, ref
    rng = np.random.default_rng(16)
    n = 0
    for bits in range(1, 17):
        for d in (7, 33, 64, 100):
            for R in (1, 7, 257):
                idx = torch.from_numpy(rng.integers(
                    0, 1 << bits, size=(R + 1, d))).to(DEV)
                lanes = ref.pack_indices(idx, bits)[1:]
                for dtype in (torch.float32, torch.bfloat16):
                    what = f"unpack_dequant b={bits} d={d} R={R} {dtype}"
                    back = inl_bottleneck.unpack(lanes, d=d, bits=bits,
                                                 dtype=dtype)
                    want = ref.unpack_dequant_ref(lanes, d, bits,
                                                  dtype=dtype)
                    torch.cuda.synchronize()
                    check(same_bits(back, want),
                          f"{what}: differs from the plain version")
                    if dtype == torch.float32 or bits <= 8:
                        again = inl_bottleneck.unpack(
                            inl_bottleneck.pack(back, bits=bits), d=d,
                            bits=bits, dtype=dtype)
                        torch.cuda.synchronize()
                        check(same_bits(again, back),
                              f"{what}: unpack(pack(u)) != u")
                    n += 1
    print(f"kernels: unpack_dequant on {n} cases (b in 1..16 x d in "
          f"{{7, 33, 64, 100}} x R in {{1, 7, 257}} x fp32/bf16, lanes one "
          f"row into their allocation) == plain bit for bit, "
          f"unpack(pack(u)) == u (fp32, bf16 at b <= 8)")


def pack_width_phase(torch):
    """pack at every b in 1..16 (vpw a power of two or not, lanes with
    unused bits), d in {7, 33, 64, 100} (a row's last word partly used; row
    starts off the vector's alignment), R in {1, 7, 257}, fp32 and bf16 (b
    <= 8), on values that start one row into their allocation: off-grid
    values (N(0, 2.5^2), past the clip range, a quarter of them at rounding
    midpoints) and values on the b-bit grid.  The lanes equal the plain
    version's bit for bit, and unpack(pack(u)) == u on the grid."""
    from repro_torch.kernels import inl_bottleneck, ref
    rng = np.random.default_rng(17)
    n = 0
    for bits in range(1, 17):
        scale = ((1 << bits) - 1) / (2.0 * ref.QUANT_RANGE)
        for d in (7, 33, 64, 100):
            for R in (1, 7, 257):
                shape = (R + 1, d)
                off = rng.normal(scale=2.5, size=shape)
                mids = (rng.integers(0, (1 << bits) - 1, size=shape) + 0.5) \
                    / scale - ref.QUANT_RANGE
                off = np.where(rng.random(shape) < 0.25, mids, off)
                grid = ref.dequantize_index(torch.from_numpy(rng.integers(
                    0, 1 << bits, size=shape)).to(DEV), bits)
                for kind, vals in (
                        ("off-grid", torch.from_numpy(
                            off.astype(np.float32)).to(DEV)),
                        ("on-grid", grid)):
                    for dtype in (torch.float32, torch.bfloat16):
                        if dtype == torch.bfloat16 and bits > 8:
                            continue
                        what = f"pack {kind} b={bits} d={d} R={R} {dtype}"
                        u = vals.to(dtype)[1:]
                        lanes = inl_bottleneck.pack(u, bits=bits)
                        want = ref.pack_values_ref(u, bits)
                        torch.cuda.synchronize()
                        check(same_bits(lanes, want),
                              f"{what}: lanes differ from the plain version")
                        if kind == "on-grid":
                            back = inl_bottleneck.unpack(lanes, d=d,
                                                         bits=bits,
                                                         dtype=dtype)
                            torch.cuda.synchronize()
                            check(same_bits(back, u),
                                  f"{what}: unpack(pack(u)) != u")
                        n += 1
    print(f"kernels: pack on {n} cases (b in 1..16 x d in {{7, 33, 64, 100}}"
          f" x R in {{1, 7, 257}} x off-grid/on-grid values x fp32/bf16 at "
          f"b <= 8, values one row into their allocation) == plain bit for "
          f"bit, unpack(pack(u)) == u on the grid")


# ---------------------------------------------------------------------------
# 4. serving at full width: the main path
# ---------------------------------------------------------------------------

def serving_phase(torch, card_line):
    from repro_torch import tree_map
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import schemes
    from repro_torch.data import multiview
    from repro_torch.kernels import inl_bottleneck
    from repro_torch.serving import ServingEngine

    cfg = PaperExperimentConfig()
    scheme = schemes.get("inl")
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    state = scheme.init(cfg, gen, device="cuda")
    imgs, _ = multiview.make_base_dataset(N_REQUESTS, seed=cfg.seed)
    views = multiview.make_views(imgs, cfg.noise_stds)    # (J, n, 32, 32, 3)
    engine = ServingEngine(scheme, state, cfg, buckets=BUCKETS,
                           device="cuda")
    engine.warmup()
    torch.cuda.synchronize()

    # closed loop: each burst waits for its answers, so every bucket
    # serves; then one flood of N_REQUESTS at once, for the throughput
    bursts = (1, 2, 4, 7, 16, 33, 64) * 2
    for k in inl_bottleneck.LAUNCHES:
        inl_bottleneck.LAUNCHES[k] = 0
    futs, view_of = [], {}

    def submit():
        m = len(futs) % N_REQUESTS
        rid, fut = engine.submit(views[:, m])
        view_of[rid] = m
        futs.append(fut)
        return fut

    with engine:
        for k in bursts:
            burst = [submit() for _ in range(k)]
            for f in burst:
                f.result(timeout=60)
        t0 = time.perf_counter()
        flood = [submit() for _ in range(N_REQUESTS)]
        for f in flood:
            f.result(timeout=60)
        wall = time.perf_counter() - t0
    launches = dict(inl_bottleneck.LAUNCHES)
    results = [f.result(timeout=60) for f in futs]
    n_served = len(results)

    stats = engine.stats
    check(stats.completed == n_served, f"{stats.completed} completed")
    check(launches["cut_fwd"] == stats.launches and stats.launches > 0,
          f"cut_fwd launched {launches['cut_fwd']} times over "
          f"{stats.launches} engine launches")
    probs = np.stack([r.probs for r in results])
    check(np.isfinite(probs).all(), "non-finite probabilities")
    check(np.abs(probs.sum(-1) - 1.0).max() <= 1e-5, "rows do not sum to 1")
    check(engine.meter.delivery_ratio == 1.0,
          f"delivery_ratio {engine.meter.delivery_ratio}")
    used = sorted({r.bucket for r in results})
    print(f"serving: {n_served} requests, {stats.launches} engine "
          f"launches over buckets {used}, pad fraction "
          f"{stats.pad_fraction:.3f}, cut_fwd launches "
          f"{launches['cut_fwd']}")

    # bit for bit against predict on the card, in the same bucket
    for b in used:
        rows = [r for r in results if r.bucket == b]
        for c in range(0, len(rows), b):
            chunk = rows[c:c + b]
            idx = [view_of[r.rid] for r in chunk]
            idx += [idx[-1]] * (b - len(idx))
            ref = scheme.predict(state, views[:, idx], device="cuda")
            ref = ref.cpu().numpy()[:len(chunk)]
            got = np.stack([r.probs for r in chunk])
            check(np.array_equal(got, ref),
                  f"served rows differ from predict in bucket {b}: max "
                  f"{np.abs(got - ref).max()}")
    # against the port on the CPU
    state_cpu = tree_map(lambda t: t.cpu(), state)
    cpu = scheme.predict(state_cpu, views, device="cpu").numpy()
    cpu = cpu[[view_of[r.rid] for r in results]]
    err = float(np.abs(probs - cpu).max())
    check(err <= CPU_ATOL, f"card vs CPU max |diff| {err} > {CPU_ATOL}")
    print(f"serving: served == predict(cuda) bit for bit in every bucket; "
          f"max |cuda - cpu| {err:.3g} (atol {CPU_ATOL})")
    flood_lat = stats.latencies_ms[-N_REQUESTS:]
    print(f"serving: flood of {N_REQUESTS} requests served at "
          f"{N_REQUESTS / wall:.1f} requests/s through the scheduler thread, "
          f"p50 latency {statistics.median(flood_lat):.3f} ms [{card_line}]")
    return scheme, state, views, launches


# ---------------------------------------------------------------------------
# 5. training at full width: the main path
# ---------------------------------------------------------------------------

def _counters():
    from repro_torch.kernels import (adamw, flash_attention, inl_bottleneck,
                                     ssm_scan)
    return (inl_bottleneck.LAUNCHES, flash_attention.LAUNCHES,
            ssm_scan.LAUNCHES, adamw.LAUNCHES)


def adamw_launches(n_steps):
    """The multi-tensor AdamW's launches over n_steps in-place optimizer
    steps (a donated `make_scan_train_step` call on the card): one norm
    and one update a step, whatever the number of leaves."""
    return {"adamw_norm": n_steps, "adamw_update": n_steps}


def reset_launches():
    for counts in _counters():
        for k in counts:
            counts[k] = 0


def read_launches():
    return {k: n for counts in _counters() for k, n in counts.items()}


def training_data(cfg, n=TRAIN_SAMPLES):
    from repro_torch.data import multiview
    imgs, labels = multiview.make_base_dataset(n, seed=1)
    return multiview.make_views(imgs, cfg.noise_stds), labels


def recorded_run(torch, name, cfg, views, labels, *, epochs, wire="dense",
                 seed=0, topology=None, states=None, dispatch="per_round",
                 captures=None, **run_kw):
    """run_scheme(name, dispatch=dispatch) on the card, with the launch
    counts set to 0 just before and read just after, and every round's
    loss recorded by a wrapper around the registered scheme's make_round
    ("per_round") or make_epoch's epoch_fn ("scan"; the graphs phase holds
    the two against each other).  Into `states`, when given, each call's
    (state in, state out): a round's, or under "scan" an epoch's; into
    `captures`, when given, the epoch_fn's captures per host signature;
    `run_kw` (ckpt_dir=, resume=) go to run_scheme.  Returns (curve,
    losses, launches, meter, seconds, the rounds' mean rates (INL; empty
    for SL and FL))."""
    from repro_torch.core import bandwidth, schemes
    from repro_torch.core.schemes import runner

    scheme = schemes.get(name)
    losses, rates, made = [], [], []
    attr = "make_epoch" if dispatch == "scan" else "make_round"
    make = getattr(scheme, attr)

    def recording_make(*a, **kw):
        fn = make(*a, **kw)
        made.append(fn)

        def rec(*ra, **rkw):
            st, m = fn(*ra, **rkw)
            if states is not None:
                states.append((ra[0], st))
            per = (lambda t: list(t.unbind(0))) if dispatch == "scan" \
                else (lambda t: [t])
            losses.extend(per(m["loss"]))
            if "rate_mean" in m:
                rates.extend(per(m["rate_mean"]))
            return st, m
        return rec
    setattr(scheme, attr, recording_make)
    meter = bandwidth.BandwidthMeter()
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        curve = runner.run_scheme(name, views, labels, cfg, epochs=epochs,
                                  batch_size=TRAIN_BATCH, eval_n=512,
                                  meter=meter, wire=wire, seed=seed,
                                  topology=topology, dispatch=dispatch,
                                  device=DEV, **run_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        delattr(scheme, attr)
    if captures is not None and dispatch == "scan" and made:
        captures.update(made[0].captures)
    loss = [float(x) for x in losses]
    check(all(np.isfinite(loss)), f"{name} {wire}: non-finite loss {loss}")
    return curve, loss, launches, meter, wall, [float(x) for x in rates]


def falls(loss, k=4) -> tuple:
    """(mean of the first k losses, of the last k); checks the second is
    below the first."""
    first, last = float(np.mean(loss[:k])), float(np.mean(loss[-k:]))
    check(last < first, f"loss did not fall: first {k} {first}, last {k} "
                        f"{last}")
    return first, last


def training_phase(torch, card_line):
    """run_scheme("inl") at full width on the card."""
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import linkmodel

    cfg = PaperExperimentConfig()
    views, labels = training_data(cfg)
    curve, loss, launches, meter, wall, _ = recorded_run(
        torch, "inl", cfg, views, labels, epochs=TRAIN_EPOCHS)
    steps = TRAIN_EPOCHS * (TRAIN_SAMPLES // TRAIN_BATCH)
    check(len(loss) == steps, f"{len(loss)} train steps, expected {steps}")
    first, last = falls(loss)
    acc = curve[-1].accuracy
    check(acc >= 0.3, f"final accuracy {acc} < 0.3")
    want_gbits = steps * linkmodel.training_step_bits(
        TRAIN_BATCH, cfg.num_clients * cfg.d_bottleneck, cfg.link_bits) / 1e9
    check(curve[-1].gbits == want_gbits,
          f"gbits {curve[-1].gbits} != {want_gbits}")
    check(launches["cut_bwd"] == steps,
          f"cut_bwd launched {launches['cut_bwd']} times in {steps} steps")
    check(launches["cut_fwd"] == steps + TRAIN_EPOCHS,
          f"cut_fwd launched {launches['cut_fwd']} times in {steps} steps "
          f"and {TRAIN_EPOCHS} evaluations")
    check(launches["cut_prior_fwd"] == launches["cut_prior_bwd"] == 0,
          f"prior kernels launched on the standard prior: {launches}")
    check(launches["cut_fwd_pack"] == launches["pack"]
          == launches["unpack_dequant"] == 0,
          f"pack kernels launched on the dense wire: {launches}")
    print(f"training: run_scheme('inl') at PaperExperimentConfig(), batch "
          f"{TRAIN_BATCH}, {TRAIN_SAMPLES} samples, {TRAIN_EPOCHS} epochs = "
          f"{steps} steps in {wall:.2f} s; loss {loss[0]:.4f} -> "
          f"{loss[-1]:.4f} (mean of first 4 {first:.4f}, last 4 "
          f"{last:.4f}); accuracy per epoch "
          f"{[round(p.accuracy, 4) for p in curve]}; gbits "
          f"{curve[-1].gbits!r} (measured {curve[-1].measured_gbits!r}); "
          f"launches {launches} [{card_line}]")
    return launches, acc


def prior_training_phase(torch, card_line):
    """PRIOR_STEPS train steps with learned_prior=True through the scheme's
    round: each prior kernel once per step, the standard kernels never."""
    import dataclasses
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import schemes

    cfg = dataclasses.replace(PaperExperimentConfig(), learned_prior=True)
    views, labels = training_data(cfg)
    scheme = schemes.get("inl")
    state = scheme.init(cfg, torch.Generator(device=DEV).manual_seed(2),
                        device=DEV)
    round_fn = scheme.make_round(cfg)
    gen = torch.Generator(device=DEV).manual_seed(3)
    v = torch.from_numpy(views).to(DEV)
    lab = torch.from_numpy(labels).to(DEV).long()
    losses = []
    torch.cuda.synchronize()
    reset_launches()
    for k in range(PRIOR_STEPS):
        sl = slice(k * TRAIN_BATCH, (k + 1) * TRAIN_BATCH)
        state, m = round_fn(state, v[None, :, sl], lab[None, sl], gen)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    launches = read_launches()
    loss = [float(x) for x in losses]
    check(all(np.isfinite(loss)), f"non-finite loss: {loss}")
    check(launches["cut_prior_fwd"] == launches["cut_prior_bwd"]
          == PRIOR_STEPS, f"prior kernels: {launches} in {PRIOR_STEPS} steps")
    check(launches["cut_fwd"] == launches["cut_bwd"] == 0,
          f"standard kernels launched with a learned prior: {launches}")
    pri = state["params"].priors
    moved = max(float(pri["mu"].abs().max()),
                float(pri["logvar"].abs().max()))
    check(moved > 0.0, "the learned priors did not move from zero")
    print(f"training: learned_prior=True, {PRIOR_STEPS} steps; loss "
          f"{loss[0]:.4f} -> {loss[-1]:.4f}; max |prior| {moved:.4g}; "
          f"launches {launches} [{card_line}]")
    return launches


# ---------------------------------------------------------------------------
# 5b. the packed wire and the SL/FL baselines at full width
# ---------------------------------------------------------------------------

def expect_launches(launches, want, what):
    """Every kernel's count equal to `want`'s (absent: 0)."""
    full = {k: want.get(k, 0) for k in launches}
    check(launches == full, f"{what}: launches {launches}, expected {full}")


def packed_training_phase(torch, card_line):
    """The packed-wire paths, each driven through run_scheme with the launch
    counts set to 0 just before and read just after.  Returns {path:
    launches}."""
    import dataclasses
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import linkmodel, paper_model

    cfg = PaperExperimentConfig(link_bits=WIRE_BITS)
    views, labels = training_data(cfg, PACKED_SAMPLES)
    steps = PACKED_SAMPLES // TRAIN_BATCH
    R, d = cfg.num_clients * TRAIN_BATCH, cfg.d_bottleneck      # 320, 64
    W = d * WIRE_BITS // 32                                       # 16 lanes
    per_round = {"packed": R * W * 4 + R * d * 4,
                 "packed_duplex": 2 * R * W * 4}
    closed = linkmodel.training_step_bits(TRAIN_BATCH, cfg.num_clients * d,
                                          WIRE_BITS)
    # SL also moves its client-side weights once an epoch, J hand-offs of
    # J fp32 encoders
    handoff = cfg.num_clients * cfg.num_clients * 4 \
        * paper_model.encoder_param_count(cfg)
    check(per_round["packed_duplex"] * 8 == closed,
          f"duplex bytes {per_round['packed_duplex']} vs closed form "
          f"{closed} bits")
    out = {}
    runs = (("inl", "packed", cfg, views, labels),
            ("inl", "packed_duplex", cfg, views, labels),
            ("inl+learned_prior", "packed",
             dataclasses.replace(cfg, learned_prior=True), views, labels),
            ("sl", "packed", cfg, views, labels))
    for path, wire, c, v, lab in runs:
        name = path.split("+")[0]
        curve, loss, launches, meter, wall, rates = recorded_run(
            torch, name, c, v, lab, epochs=1, wire=wire)
        check(len(loss) == steps, f"{path} {wire}: {len(loss)} steps")
        first, last = falls(loss)
        if path == "inl+learned_prior":
            want = {"cut_prior_fwd": steps, "cut_prior_bwd": steps,
                    "pack": steps, "unpack_dequant": steps, "cut_fwd": 1}
        elif name == "inl":
            want = {"cut_fwd_pack": steps, "unpack_dequant": steps,
                    "cut_bwd": steps, "cut_fwd": 1}
        else:                       # sl: its cut, then ship; + evaluation
            want = {"cut_fwd": steps + 1, "pack": steps,
                    "unpack_dequant": steps, "cut_bwd": steps}
        expect_launches(launches, want, f"{path} {wire}")
        extra = handoff if name == "sl" else 0
        check(meter.measured_bytes == steps * per_round[wire] + extra,
              f"{path} {wire}: measured {meter.measured_bytes} bytes, "
              f"expected {steps} x {per_round[wire]} + {extra}")
        if wire == "packed_duplex":
            check(meter.measured_bits == meter.total_bits,
                  f"duplex measured {meter.measured_bits} bits != closed "
                  f"form {meter.total_bits}")
        out[f"{path} {wire}"] = launches
        print(f"packed: run_scheme('{name}', wire='{wire}') at "
              f"PaperExperimentConfig(link_bits={WIRE_BITS}"
              f"{', learned_prior=True' if 'prior' in path else ''}), "
              f"{steps} steps of {TRAIN_BATCH} in {wall:.2f} s; loss "
              f"{loss[0]:.4f} -> {loss[-1]:.4f} (first 4 {first:.4f}, last "
              f"4 {last:.4f}); mean rate "
              f"{[round(r, 1) for r in rates[::5]] if rates else 'n/a'}; "
              f"accuracy {curve[-1].accuracy:.4f}; gbits "
              f"{curve[-1].gbits!r}, measured {curve[-1].measured_gbits!r} "
              f"({per_round[wire]} bytes a round); launches {launches} "
              f"[{card_line}]")
    # FL: J clients x 2 local steps a round, one full model each
    rounds_samples = FL_ROUNDS * cfg.num_clients * 2 * TRAIN_BATCH
    fv, fl_labels = training_data(cfg, rounds_samples)
    curve, loss, launches, meter, wall, _ = recorded_run(
        torch, "fl", cfg, fv, fl_labels, epochs=1)
    local = FL_ROUNDS * cfg.num_clients * 2
    check(len(loss) == FL_ROUNDS, f"fl: {len(loss)} rounds")
    falls(loss, k=1)
    expect_launches(launches, {"cut_fwd": local + 1, "cut_bwd": local},
                    "fl")
    out["fl"] = launches
    print(f"packed: run_scheme('fl') at PaperExperimentConfig(link_bits="
          f"{WIRE_BITS}), {FL_ROUNDS} rounds of {cfg.num_clients} clients x "
          f"2 local steps of {TRAIN_BATCH} in {wall:.2f} s; round loss "
          f"{[round(x, 4) for x in loss]}; accuracy "
          f"{curve[-1].accuracy:.4f}; gbits {curve[-1].gbits!r}, measured "
          f"{curve[-1].measured_gbits!r}; launches {launches} "
          f"[{card_line}]")
    return out


def packed_step_equals_dense(torch, card_line):
    """From one state and one set of draws, the loss and every gradient leaf
    of a packed step equal a dense step's, bit for bit (deterministic
    algorithms on for the comparison)."""
    from repro_torch import tree_leaves, value_and_grad
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import inl, paper_model, schemes

    cfg = PaperExperimentConfig(link_bits=WIRE_BITS)
    views, labels = training_data(cfg)
    st = schemes.get("inl").init(cfg, torch.Generator(device=DEV)
                                 .manual_seed(8), device=DEV)
    v = torch.from_numpy(views[:, :TRAIN_BATCH]).to(DEV)
    lab = torch.from_numpy(labels[:TRAIN_BATCH]).to(DEV).long()
    gen = torch.Generator(device=DEV).manual_seed(9)
    eps = torch.randn((cfg.num_clients, TRAIN_BATCH, cfg.d_bottleneck),
                      generator=gen, device=DEV)
    masks = paper_model.decoder_dropout_masks(gen, cfg.dense_units,
                                              TRAIN_BATCH, device=DEV)
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for wire in ("dense", "packed"):
            loss, _, grads = value_and_grad(
                inl.loss_fn, st["params"], st["state"], v, lab, cfg,
                eps=eps, drop_masks=masks, wire=wire)
            out[wire] = (loss, tree_leaves(grads))
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    (ld, gd), (lp, gp) = out["dense"], out["packed"]
    check(same_bits(ld, lp), f"packed step loss {float(lp)} != dense "
                             f"{float(ld)}")
    check(len(gd) == len(gp) > 0 and all(same_bits(a, b)
                                         for a, b in zip(gd, gp)),
          "a gradient leaf of the packed step differs from the dense one")
    print(f"packed: one packed step == one dense step bit for bit (loss "
          f"{float(ld)!r}, {len(gd)} gradient leaves) [{card_line}]")


def _loss_and_grads(torch, cfg, params, state, views, labels, eps, masks,
                    **kw):
    from repro_torch import tree_leaves, tree_unflatten
    from repro_torch.core import inl
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss, _ = inl.loss_fn(tree_unflatten(params, leaves), state, views,
                          labels, cfg, eps=eps, drop_masks=masks, **kw)
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


def grads_close(l_gpu, l_cpu, g_gpu, g_cpu, what):
    """Step-1 loss within rtol 1e-3, atol 1e-5 and every gradient leaf as a
    tensor: |card - cpu| <= 1e-3 |cpu| + 1e-5 sqrt(n) in the 2-norm.
    Returns (largest |card - cpu| / |cpu| of a leaf above the atol floor,
    largest entry difference, entries outside the bar entry by entry)."""
    check(np.isclose(l_gpu, l_cpu, **CARD_CPU_TOL),
          f"{what}: step-1 loss card {l_gpu} vs cpu {l_cpu}")
    max_abs, max_leaf, off_entries = 0.0, 0.0, 0
    for a, b in zip(g_gpu, g_cpu):
        a, b = a.cpu().double().numpy(), b.double().numpy()
        # a leaf as a tensor: |a - b| <= rtol |b| + atol sqrt(n) in the 2-norm
        # (a single entry of a conv-weight gradient sums 65536 products that
        # cancel, and cuDNN and the CPU add them in other orders)
        dist, size = np.linalg.norm(a - b), np.linalg.norm(b)
        bar = CARD_CPU_TOL["rtol"] * size \
            + CARD_CPU_TOL["atol"] * np.sqrt(a.size)
        check(dist <= bar, f"{what}: gradient leaf {a.shape}: |card - cpu| "
              f"{dist} > {bar} (|cpu| {size})")
        max_abs = max(max_abs, float(np.abs(a - b).max()))
        if size > bar:          # leaves whose gradient is not ~0 (conv
            max_leaf = max(max_leaf, float(dist / size))   # biases are)
        off_entries += int((~np.isclose(a, b, **CARD_CPU_TOL)).sum())
    return max_leaf, max_abs, off_entries


def card_vs_cpu_phase(torch, card_line):
    """One set of weights, eps and masks drawn on the CPU: step 1's loss and
    gradients, and 3 steps' losses, on the card against the CPU port."""
    from repro_torch import tree_map
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import paper_model, schemes

    cfg = PaperExperimentConfig()
    views, labels = training_data(cfg)
    scheme = schemes.get("inl")
    cpu = scheme.init(cfg, torch.Generator().manual_seed(4), device="cpu")
    gpu = tree_map(lambda t: t.to(DEV), cpu)
    v = torch.from_numpy(views[:, :TRAIN_BATCH])
    lab = torch.from_numpy(labels[:TRAIN_BATCH]).long()
    gen = torch.Generator().manual_seed(5)
    draws = []
    for _ in range(3):
        eps = torch.randn((cfg.num_clients, TRAIN_BATCH, cfg.d_bottleneck),
                          generator=gen)
        draws.append((eps, paper_model.decoder_dropout_masks(
            gen, cfg.dense_units, TRAIN_BATCH)))

    def on(dev, t):
        return tree_map(lambda x: x.to(dev), t)
    l_cpu, g_cpu = _loss_and_grads(torch, cfg, cpu["params"], cpu["state"],
                                   v, lab, *draws[0])
    l_gpu, g_gpu = _loss_and_grads(torch, cfg, gpu["params"], gpu["state"],
                                   v.to(DEV), lab.to(DEV), *on(DEV,
                                                             draws[0]))
    max_leaf, max_abs, off_entries = grads_close(l_gpu, l_cpu, g_gpu, g_cpu,
                                                 "star")
    round_fn = scheme.make_round(cfg)
    losses = {}
    for dev, st in (("cpu", cpu), (DEV, gpu)):
        out = []
        for eps, masks in draws:
            st, m = round_fn(st, v[None].to(dev), lab[None].to(dev), None,
                             eps=eps.to(dev),
                             drop_masks=[x.to(dev) for x in masks])
            out.append(float(m["loss"]))
        losses[dev] = out
    check(np.allclose(losses[DEV], losses["cpu"], rtol=1e-3, atol=0),
          f"3-step losses card {losses[DEV]} vs cpu {losses['cpu']}")
    print(f"cpu: step-1 loss card {l_gpu:.7f} cpu {l_cpu:.7f}; "
          f"{len(g_gpu)} gradient leaves within rtol 1e-3 atol 1e-5 as "
          f"tensors, largest |card - cpu| / |cpu| of a leaf {max_leaf:.3g} "
          f"(leaves above the atol floor), "
          f"largest entry difference {max_abs:.3g}, {off_entries} entries "
          f"outside the bar taken entry by entry; 3-step losses card "
          f"{losses[DEV]} cpu {losses['cpu']} [{card_line}]")


# ---------------------------------------------------------------------------
# 6b. non-star topologies at full width
# ---------------------------------------------------------------------------

def graph_runs():
    """(label, topology, config, wire) of the graph training runs."""
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import topology as T
    cfg8 = PaperExperimentConfig(link_bits=WIRE_BITS)
    return (("chain(5) packed", T.chain(5), cfg8, "packed"),
            ("chain(5) packed_duplex", T.chain(5), cfg8, "packed_duplex"),
            ("tree(2, 2) dense", T.tree(2, 2),
             PaperExperimentConfig(num_clients=6, noise_stds=TREE_STDS),
             "dense"),
            (f"chain(5, link_bits={HET_BITS}) dense",
             T.chain(5, link_bits=HET_BITS), PaperExperimentConfig(),
             "dense"))


def topology_phase(torch, card_line):
    """The graph paths at full width, batch 64, each driven through
    run_scheme("inl", topology=...) with the launch counts set to 0 just
    before and read just after: one cut_fwd and one cut_bwd a first-hop
    width group a step (one more cut_fwd a group for the evaluation, on the
    dense wire), one pack and one unpack_dequant an edge a step on a packed
    wire; the meter's per-edge bytes equal steps x the closed forms'
    wirefmt sizes.  Returns {label: launches}."""
    from repro_torch.core import topology as T

    steps = GRAPH_SAMPLES // TRAIN_BATCH
    out = {}
    for label, topo, cfg, wire in graph_runs():
        views, labels = training_data(cfg, GRAPH_SAMPLES)
        curve, loss, launches, meter, wall, rates = recorded_run(
            torch, "inl", cfg, views, labels, epochs=1, wire=wire,
            topology=topo)
        check(len(loss) == steps, f"{label}: {len(loss)} steps")
        first, last = falls(loss)
        groups = len(T.first_hop_groups(topo, cfg)[0])
        hops = 0 if wire == "dense" else len(topo.edges)
        expect_launches(launches, {
            "cut_fwd": groups * (steps + 1), "cut_bwd": groups * steps,
            "pack": hops * steps, "unpack_dequant": hops * steps}, label)
        bits = T.round_edge_bits(topo, cfg, TRAIN_BATCH)
        nbytes = T.round_edge_wire_bytes(topo, cfg, TRAIN_BATCH, wire=wire)
        check(meter.edge_bits == {k: steps * v for k, v in bits.items()}
              and meter.edge_measured_bytes
              == {k: steps * v for k, v in nbytes.items()},
              f"{label}: per-edge ledger {meter.edge_bits} "
              f"{meter.edge_measured_bytes} != {steps} x {bits} {nbytes}")
        if wire == "packed_duplex" or cfg.link_bits == 32 and all(
                e.link_bits in (None, 32) for e in topo.edges):
            check(all(nbytes[k] * 8 == bits[k] for k in bits),
                  f"{label}: measured bytes differ from the closed forms")
        out[label] = launches
        per_edge = "; ".join(
            f"{k} payload {len(topo.payload(e))}: closed {bits[k]:.0f} "
            f"bits, measured {nbytes[k]:.0f} bytes"
            for e in topo.topo_edges() for k in [e.key])
        print(f"topology: run_scheme('inl') on {label} at full width, "
              f"{cfg.num_clients} views, {steps} steps of {TRAIN_BATCH} in {wall:.2f} s; loss "
              f"{loss[0]:.4f} -> {loss[-1]:.4f} (first 4 {first:.4f}, last "
              f"4 {last:.4f}); accuracy {curve[-1].accuracy:.4f}; "
              f"{groups} first-hop group(s), {hops} packed hop(s) a step; "
              f"launches {launches} [{card_line}]")
        print(f"topology: {label} per edge and round: {per_edge}")
    return out


def graph_step_checks(torch, card_line):
    """From one state and one set of draws at PaperExperimentConfig(link_bits
    =8): the loss and every gradient leaf of a step on the packed chain(5)
    equal the dense chain's, and the dense chain's the star's, bit for bit
    (deterministic algorithms on); then step 1 of the packed chain(5) and
    of tree(2, 2) on the card against the CPU port (grads_close)."""
    from repro_torch import tree_leaves, tree_map, value_and_grad
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import inl, paper_model, schemes
    from repro_torch.core import topology as T

    cfg = PaperExperimentConfig(link_bits=WIRE_BITS)
    views, labels = training_data(cfg)
    st = schemes.get("inl").init(cfg, torch.Generator(device=DEV)
                                 .manual_seed(10), device=DEV)
    v = torch.from_numpy(views[:, :TRAIN_BATCH]).to(DEV)
    lab = torch.from_numpy(labels[:TRAIN_BATCH]).to(DEV).long()
    gen = torch.Generator(device=DEV).manual_seed(11)
    eps = torch.randn((cfg.num_clients, TRAIN_BATCH, cfg.d_bottleneck),
                      generator=gen, device=DEV)
    masks = paper_model.decoder_dropout_masks(gen, cfg.dense_units,
                                              TRAIN_BATCH, device=DEV)
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for label, topo, wire in (("star", None, "dense"),
                                  ("chain dense", T.chain(5), "dense"),
                                  ("chain packed", T.chain(5), "packed")):
            loss, _, grads = value_and_grad(
                inl.loss_fn, st["params"], st["state"], v, lab, cfg,
                eps=eps, drop_masks=masks, wire=wire, topology=topo)
            out[label] = (loss, tree_leaves(grads))
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b in (("chain dense", "star"), ("chain packed", "chain dense")):
        (la, ga), (lb, gb) = out[a], out[b]
        check(same_bits(la, lb), f"{a} step loss {float(la)} != {b} "
                                 f"{float(lb)}")
        check(len(ga) == len(gb) > 0 and all(same_bits(x, y)
                                             for x, y in zip(ga, gb)),
              f"a gradient leaf of the {a} step differs from the {b} one")
    print(f"topology: one step on the packed chain(5) == the dense chain(5) "
          f"== the star, bit for bit (loss {float(out['star'][0])!r}, "
          f"{len(out['star'][1])} gradient leaves) [{card_line}]")

    for label, topo, c, wire in graph_runs()[::2]:
        cv, cl = training_data(c)
        cpu = schemes.get("inl").init(c, torch.Generator().manual_seed(12),
                                      device="cpu")
        g = torch.Generator().manual_seed(13)
        e = torch.randn((c.num_clients, TRAIN_BATCH, c.d_bottleneck),
                        generator=g)
        m = paper_model.decoder_dropout_masks(g, c.dense_units, TRAIN_BATCH)
        vc = torch.from_numpy(cv[:, :TRAIN_BATCH])
        lc = torch.from_numpy(cl[:TRAIN_BATCH]).long()
        kw = dict(topology=topo, wire=wire)
        l_cpu, g_cpu = _loss_and_grads(torch, c, cpu["params"],
                                       cpu["state"], vc, lc, e, m, **kw)
        gpu = tree_map(lambda t: t.to(DEV), cpu)
        l_gpu, g_gpu = _loss_and_grads(
            torch, c, gpu["params"], gpu["state"], vc.to(DEV), lc.to(DEV),
            e.to(DEV), [x.to(DEV) for x in m], **kw)
        max_leaf, max_abs, off = grads_close(l_gpu, l_cpu, g_gpu, g_cpu,
                                             label)
        print(f"topology: {label} step 1, card against the CPU port: loss "
              f"{l_gpu:.7f} / {l_cpu:.7f}; {len(g_gpu)} gradient leaves "
              f"within rtol 1e-3 atol 1e-5 as tensors, largest |card - cpu|"
              f" / |cpu| of a leaf {max_leaf:.3g}, largest entry difference "
              f"{max_abs:.3g}, {off} entries outside the bar taken entry by "
              f"entry [{card_line}]")


def graph_serving_phase(torch, card_line):
    """chain(5) served at PaperExperimentConfig(link_bits=8) on the packed
    wire over buckets (1, 4, 16, 64), launch counts set to 0 just before
    and read just after: one cut_fwd and five pack and unpack_dequant an
    engine launch; answers finite rows summing to 1, equal bit for bit to
    predict on the card in the same bucket; every edge metered."""
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import schemes
    from repro_torch.core import topology as T
    from repro_torch.data import multiview
    from repro_torch.serving import ServingEngine, metering

    cfg = PaperExperimentConfig(link_bits=WIRE_BITS)
    topo = T.chain(5)
    scheme = schemes.get("inl")
    state = scheme.init(cfg, torch.Generator(device=DEV).manual_seed(14),
                        device=DEV)
    imgs, _ = multiview.make_base_dataset(N_REQUESTS, seed=cfg.seed)
    views = multiview.make_views(imgs, cfg.noise_stds)
    engine = ServingEngine(scheme, state, cfg, topology=topo, wire="packed",
                           buckets=BUCKETS, device=DEV)
    engine.warmup()
    torch.cuda.synchronize()
    reset_launches()
    futs, view_of = [], {}

    def submit():
        m = len(futs) % N_REQUESTS
        rid, fut = engine.submit(views[:, m])
        view_of[rid] = m
        futs.append(fut)
        return fut

    with engine:
        for k in (1, 2, 4, 7, 16, 33, 64) * 2:
            burst = [submit() for _ in range(k)]
            for f in burst:
                f.result(timeout=60)
        t0 = time.perf_counter()
        flood = [submit() for _ in range(N_REQUESTS)]
        for f in flood:
            f.result(timeout=60)
        wall = time.perf_counter() - t0
    launches = read_launches()
    results = [f.result(timeout=60) for f in futs]
    stats = engine.stats
    n_edges = len(topo.edges)
    expect_launches(launches, {"cut_fwd": stats.launches,
                               "pack": n_edges * stats.launches,
                               "unpack_dequant": n_edges * stats.launches},
                    "chain(5) serving")
    probs = np.stack([r.probs for r in results])
    check(np.isfinite(probs).all()
          and np.abs(probs.sum(-1) - 1.0).max() <= 1e-5,
          "chain(5) serving: rows not finite or not summing to 1")
    per_req = metering.request_edge_wire_bytes(topo, cfg, wire="packed")
    check(engine.meter.edge_measured_bytes
          == {k: len(results) * v for k, v in per_req.items()},
          f"chain(5) serving: per-edge bytes "
          f"{engine.meter.edge_measured_bytes}")
    # bit for bit against predict on the card in the same bucket: within a
    # bucket no request's answer depends on the batch it rode in
    checked = 0
    for b in sorted({r.bucket for r in results}):
        rows = [r for r in results if r.bucket == b]
        for c in range(0, len(rows), b):
            chunk = rows[c:c + b]
            idx = [view_of[r.rid] for r in chunk]
            idx += [idx[-1]] * (b - len(idx))
            ref = scheme.predict_batched(state, views[:, idx],
                                         topology=topo, cfg=cfg,
                                         wire="packed", device=DEV)
            ref = ref.cpu().numpy()[:len(chunk)]
            got = np.stack([r.probs for r in chunk])
            check(np.array_equal(got, ref),
                  f"chain(5) served rows differ from predict in bucket {b}:"
                  f" max {np.abs(got - ref).max()}")
            checked += len(chunk)
    used = sorted({r.bucket for r in results})
    print(f"topology: served chain(5) (packed, link_bits={WIRE_BITS}): "
          f"{len(results)} requests in {stats.launches} engine launches "
          f"over buckets {used}, {checked} rows == predict(cuda) bit for "
          f"bit in their bucket; flood of {N_REQUESTS} at "
          f"{N_REQUESTS / wall:.1f} requests/s, p50 latency "
          f"{statistics.median(stats.latencies_ms[-N_REQUESTS:]):.3f} ms; "
          f"launches {launches} [{card_line}]")
    return launches


# ---------------------------------------------------------------------------
# 6c. unreliable links (core/linkfault) at full width
# ---------------------------------------------------------------------------

HEADLINE_ERASURE = 0.3          # benchmarks/links_bench.py's headline rate
HEADLINE_DROPOUT = 0.2          # and its INL edge-dropout curriculum
CHAIN_ERASURE = 0.1             # per edge: chain(5)'s head crosses five
LOSSY_STEPS = 16
PERFECT_STEPS = 4
SERVE_LINK = dict(latency_ms=1.0, jitter_ms=1.0)
SERVE_DEADLINE_MS = 2.0         # a view misses iff Exp(1) > 1: p = e^-1


def _round_batches(torch, scheme, cfg, steps, seed=1):
    """`steps` rounds of (bpr, J, B, ...) views and (bpr, B) labels on the
    card, laid out as run_scheme gathers them."""
    bpr = scheme.batches_per_round(cfg)
    views, labels = training_data(cfg, steps * bpr * TRAIN_BATCH)
    v = torch.from_numpy(views).to(DEV)
    lab = torch.from_numpy(labels).to(DEV).long()
    out = []
    for k in range(steps):
        idx = torch.arange(k * bpr * TRAIN_BATCH, (k + 1) * bpr * TRAIN_BATCH,
                           device=DEV).reshape(bpr, TRAIN_BATCH)
        out.append((v[:, idx].transpose(0, 1), lab[idx]))
    return out


def perfect_links_phase(torch, card_line):
    """LinkModel() on every edge against no link model, from one state and
    one generator, deterministic algorithms on: PERFECT_STEPS INL steps on
    the star, one FL round, PERFECT_STEPS steps on the packed chain(5); the
    losses and every state leaf (parameters, BatchNorm statistics,
    optimizer state) bit for bit."""
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import topology as T

    cfg, cfg8 = PaperExperimentConfig(), PaperExperimentConfig(
        link_bits=WIRE_BITS)
    runs = (("INL star", "inl", cfg, T.star(cfg.num_clients), "dense",
             PERFECT_STEPS),
            ("FL star", "fl", cfg, T.star(cfg.num_clients), "dense", 1),
            ("INL chain(5) packed", "inl", cfg8, T.chain(5), "packed",
             PERFECT_STEPS))
    perfect_equals_bare(torch, card_line, runs, "linkfault")


def perfect_equals_bare(torch, card_line, runs, prefix):
    """Each (label, scheme, config, topology, wire, steps) of `runs`: the
    topology with LinkModel() on every edge against the bare one, from one
    state and one generator, deterministic algorithms on; the losses and
    every state leaf bit for bit."""
    from repro_torch import tree_leaves
    from repro_torch.core import linkfault, schemes

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for label, name, c, bare, wire, steps in runs:
            scheme = schemes.get(name)
            batches = _round_batches(torch, scheme, c, steps)
            out = []
            for topo in (bare, linkfault.with_links(bare,
                                                    linkfault.LinkModel())):
                st = scheme.init(c, torch.Generator(device=DEV)
                                 .manual_seed(15), device=DEV)
                round_fn = scheme.make_round(c, wire=wire, topology=topo)
                gen = torch.Generator(device=DEV).manual_seed(16)
                losses = []
                for k, (rv, rl) in enumerate(batches):
                    kw = ({} if topo is bare
                          else {"round_key": linkfault.round_key(0, k)})
                    st, m = round_fn(st, rv, rl, gen, **kw)
                    losses.append(m["loss"])
                torch.cuda.synchronize()
                out.append((losses, tree_leaves(st)))
            (la, sa), (lb, sb) = out
            check(all(same_bits(a, b) for a, b in zip(la, lb)),
                  f"{label}: perfect links moved the loss {la} -> {lb}")
            check(len(sa) == len(sb) > 0
                  and all(same_bits(a, b) for a, b in zip(sa, sb)),
                  f"{label}: perfect links moved a state leaf")
            print(f"{prefix}: perfect links on {label} == no link model, "
                  f"{steps} round(s) bit for bit (losses "
                  f"{[float(x) for x in la]}, {len(sa)} state leaves) "
                  f"[{card_line}]")
    finally:
        torch.use_deterministic_algorithms(False)


def lossy_runs():
    """(label, scheme, config, topology, wire, samples) of the lossy
    training runs: the reference's headline erasure on every edge of the
    star (INL with its edge-dropout curriculum), CHAIN_ERASURE on every
    edge of the packed chain(5)."""
    import dataclasses
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import linkfault as LF
    from repro_torch.core import topology as T

    star = LF.with_links(T.star(5), LF.LinkModel(erasure=HEADLINE_ERASURE))
    chain = LF.with_links(T.chain(5), LF.LinkModel(erasure=CHAIN_ERASURE))
    inl = PaperExperimentConfig(edge_dropout=HEADLINE_DROPOUT)
    inl8 = dataclasses.replace(inl, link_bits=WIRE_BITS)
    plain = PaperExperimentConfig()
    n = LOSSY_STEPS * TRAIN_BATCH
    return (("inl star", "inl", inl, star, "dense", n),
            ("inl+learned_prior star", "inl",
             dataclasses.replace(inl, learned_prior=True), star, "dense",
             PRIOR_STEPS * TRAIN_BATCH),
            ("inl star packed", "inl", inl8, star, "packed", n),
            ("inl chain(5) packed", "inl", inl8, chain, "packed", n),
            ("fl star", "fl", plain, star, "dense",
             FL_ROUNDS * 5 * 2 * TRAIN_BATCH),
            ("sl star", "sl", plain, star, "dense", n))


def _expected_ratio(name, scheme, cfg, topo, seed, rounds, state):
    """The delivery ratio the masks of the run's round keys imply,
    replayed on the host with the masks' own arithmetic (not the meter's):
    INL the per-edge payload fraction weighted by the edges' bits, FL the
    broadcast plus the arrived uploads, SL the rounds that ran over the
    attempts made (plus the hand-offs, delivered in full)."""
    from repro_torch.core import linkfault as LF
    from repro_torch.core import topology as T
    keys = [LF.round_key(seed, r) for r in range(rounds)]
    J = cfg.num_clients
    if name == "inl":
        bits = T.round_edge_bits(topo, cfg, TRAIN_BATCH)
        got = 0.0
        for k in keys:
            mask = LF.round_delivery_mask(k, topo, cfg, TRAIN_BATCH,
                                          train=True)
            got += sum(bits[e.key] * float(np.mean(mask[list(
                topo.payload(e))])) for e in topo.edges)
        return got / (rounds * sum(bits.values()))
    if name == "fl":
        return float(np.mean([(J + LF.client_delivery_mask(
            k, topo, cfg, train=True).sum()) / (2.0 * J) for k in keys]))
    b = scheme.bits_per_round(cfg, state, TRAIN_BATCH)
    over = scheme.epoch_overhead_bits(cfg, state)
    ran = used = 0
    for k in keys:
        oks = LF.attempt_successes(k, topo, cfg, LF.retry_attempts())
        ran += bool(oks.any())
        used += int(oks.argmax()) + 1 if oks.any() else len(oks)
    return (ran * b + over) / (used * b + over)


def lossy_training_phase(torch, card_line):
    """The lossy runs through run_scheme at full width, batch 64, launch
    counts set to 0 just before each and read just after: every kernel
    launched as on the clean network; the meter's delivery ratio equal to
    the ratio the replayed masks imply; SL's skipped rounds counted from
    the replay, each leaving the state as it was, each other round moving
    it.  Returns {label: launches}."""
    from repro_torch.core import linkfault as LF
    from repro_torch.core import schemes
    from repro_torch.core import topology as T

    out = {}
    for label, name, cfg, topo, wire, n in lossy_runs():
        scheme = schemes.get(name)
        views, labels = training_data(cfg, n)
        rounds = n // TRAIN_BATCH // scheme.batches_per_round(cfg)
        seed = 0
        if name == "sl":
            # the first seed whose rounds include a skipped one, so the
            # skip path runs (P(skip) = 0.3^3 a round)
            seed = next(s for s in range(1000) if any(
                not LF.round_success(LF.round_key(s, r), topo, cfg,
                                     LF.retry_attempts())
                for r in range(rounds)))
        states = []
        curve, loss, launches, meter, wall, rates = recorded_run(
            torch, name, cfg, views, labels, epochs=1, wire=wire, seed=seed,
            topology=topo, states=states)
        check(len(loss) == rounds, f"{label}: {len(loss)} rounds")
        groups = len(T.first_hop_groups(topo, cfg)[0])
        hops = 0 if wire == "dense" or T.nontrivial(topo, cfg) is None \
            else len(topo.edges)
        if name == "fl":
            local = rounds * cfg.num_clients * 2
            want = {"cut_fwd": local + 1, "cut_bwd": local}
        elif name == "sl":
            want = {"cut_fwd": rounds + 1, "cut_bwd": rounds}
        elif cfg.learned_prior:
            want = {"cut_prior_fwd": rounds, "cut_prior_bwd": rounds,
                    "cut_fwd": 1}
        elif wire == "packed" and hops == 0:
            want = {"cut_fwd_pack": rounds, "unpack_dequant": rounds,
                    "cut_bwd": rounds, "cut_fwd": 1}
        else:
            want = {"cut_fwd": groups * (rounds + 1),
                    "cut_bwd": groups * rounds, "pack": hops * rounds,
                    "unpack_dequant": hops * rounds}
        expect_launches(launches, want, f"lossy {label}")
        ratio = _expected_ratio(name, scheme, cfg, topo, seed, rounds,
                                states[0][0])
        check(np.isclose(meter.delivery_ratio, ratio, rtol=1e-12, atol=0)
              and meter.delivery_ratio < 1.0,
              f"lossy {label}: meter delivery ratio {meter.delivery_ratio} "
              f"!= the masks' {ratio}")
        skips = ""
        if name == "sl":
            skipped = [r for r in range(rounds) if not LF.round_success(
                LF.round_key(seed, r), topo, cfg, LF.retry_attempts())]
            from repro_torch import tree_leaves
            for r, (before, after) in enumerate(states):
                same = all(same_bits(a, b) for a, b in zip(
                    tree_leaves(before), tree_leaves(after)))
                what = "skipped" if r in skipped else "ran"
                check(same == (r in skipped),
                      f"lossy sl: round {r} {what} but its state "
                      f"{'stayed' if same else 'moved'}")
            check(len(skipped) >= 1, "lossy sl: no round was skipped")
            skips = f"; seed {seed}: rounds {skipped} skipped, state unchanged"
        out[label] = launches
        print(f"linkfault: run_scheme('{name}') on {label} (erasure "
              f"{topo.edges[0].link.erasure} an edge, edge_dropout "
              f"{cfg.edge_dropout}, link_bits={cfg.link_bits}, {wire}), "
              f"{rounds} rounds in {wall:.2f} s; loss {loss[0]:.4f} -> "
              f"{loss[-1]:.4f}; accuracy {curve[-1].accuracy:.4f}; "
              f"delivery ratio {meter.delivery_ratio!r} == the masks' "
              f"{ratio!r} (gbits {curve[-1].gbits!r}, delivered "
              f"{curve[-1].delivered_gbits!r}){skips}; launches {launches} "
              f"[{card_line}]")
    return out


LOSSY_CPU_SEEDS = 5


def worst_leaf_shape(g_gpu, g_cpu):
    """The shape of the gradient leaf with the largest |card - cpu| / |cpu|
    among those above grads_close's atol floor."""
    best, shape = -1.0, None
    for a, b in zip(g_gpu, g_cpu):
        a, b = a.cpu().double().numpy(), b.double().numpy()
        size = np.linalg.norm(b)
        floor = CARD_CPU_TOL["rtol"] * size \
            + CARD_CPU_TOL["atol"] * np.sqrt(a.size)
        if size > floor and np.linalg.norm(a - b) / size > best:
            best, shape = np.linalg.norm(a - b) / size, tuple(a.shape)
    return shape


def lossy_card_vs_cpu(torch, card_line):
    """One lossy step, card against the CPU port, on LOSSY_CPU_SEEDS sets
    of weights, eps and dropout masks and one explicit delivery mask (two
    views lost): loss and gradients at the phase-6 bar (grads_close), and
    beside each the clean step's on the same draws.  Prints each seed's
    largest |card - cpu| / |cpu| of a leaf, lossy and clean, and whether it
    stays under the bar's rtol term alone."""
    from repro_torch import tree_map
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import paper_model, schemes

    cfg = PaperExperimentConfig()
    views, labels = training_data(cfg)
    v = torch.from_numpy(views[:, :TRAIN_BATCH])
    lab = torch.from_numpy(labels[:TRAIN_BATCH]).long()
    delivery = np.array([True, False, True, True, False])
    for i in range(LOSSY_CPU_SEEDS):
        cpu = schemes.get("inl").init(
            cfg, torch.Generator().manual_seed(19 + 2 * i), device="cpu")
        gpu = tree_map(lambda t: t.to(DEV), cpu)
        g = torch.Generator().manual_seed(20 + 2 * i)
        eps = torch.randn((cfg.num_clients, TRAIN_BATCH, cfg.d_bottleneck),
                          generator=g)
        masks = paper_model.decoder_dropout_masks(g, cfg.dense_units,
                                                  TRAIN_BATCH)
        worst = {}
        for label, kw in (("lossy", {"delivery": delivery}),
                          ("clean", {})):
            l_cpu, g_cpu = _loss_and_grads(torch, cfg, cpu["params"],
                                           cpu["state"], v, lab, eps, masks,
                                           **kw)
            l_gpu, g_gpu = _loss_and_grads(
                torch, cfg, gpu["params"], gpu["state"], v.to(DEV),
                lab.to(DEV), eps.to(DEV), [x.to(DEV) for x in masks], **kw)
            worst[label] = (l_gpu, l_cpu) + grads_close(
                l_gpu, l_cpu, g_gpu, g_cpu, f"{label} star, seed {i}") \
                + (worst_leaf_shape(g_gpu, g_cpu),)
        check(worst["lossy"][1] != worst["clean"][1],
              "the delivery mask did not change the loss")
        (lg, lc, leaf, mx, off, shape), (_, cc, c_leaf, _, _, c_shape) = \
            worst["lossy"], worst["clean"]
        print(f"linkfault: one lossy step (views 1 and 4 lost), seed {i}, "
              f"card against the CPU port: loss {lg:.7f} / {lc:.7f} (clean "
              f"{cc:.7f}); {len(g_cpu)} gradient leaves within rtol 1e-3 "
              f"atol 1e-5 as tensors, largest |card - cpu| / |cpu| of a "
              f"leaf {leaf:.3g} lossy (a {shape} leaf), {c_leaf:.3g} clean "
              f"(a {c_shape} leaf; under the rtol "
              f"term alone: {leaf <= CARD_CPU_TOL['rtol']} / "
              f"{c_leaf <= CARD_CPU_TOL['rtol']}), largest entry difference "
              f"{mx:.3g}, {off} entries outside the bar taken entry by "
              f"entry [{card_line}]")


def lossy_serving_phase(torch, card_line):
    """The star with LinkModel(latency_ms=1, jitter_ms=1) on every edge and
    deadline_ms=2 served over buckets (1, 4, 16, 64), launch counts set to
    0 just before and read just after: one cut_fwd an engine launch; about
    e^-1 of the views miss (a binomial bound); each request's mask the same
    in its padded bucket as alone, and equal to views_fused; rows equal
    predict_batched under the id-keyed masks bit for bit in their bucket;
    the meter's delivery ratio the masks' fraction."""
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import linkfault as LF
    from repro_torch.core import schemes
    from repro_torch.core import topology as T
    from repro_torch.data import multiview
    from repro_torch.serving import ServingEngine

    cfg = PaperExperimentConfig()
    topo = LF.with_links(T.star(cfg.num_clients), LF.LinkModel(**SERVE_LINK))
    scheme = schemes.get("inl")
    state = scheme.init(cfg, torch.Generator(device=DEV).manual_seed(17),
                        device=DEV)
    imgs, _ = multiview.make_base_dataset(N_REQUESTS, seed=cfg.seed)
    views = multiview.make_views(imgs, cfg.noise_stds)
    engine = ServingEngine(scheme, state, cfg, topology=topo,
                           deadline_ms=SERVE_DEADLINE_MS, buckets=BUCKETS,
                           seed=18, device=DEV)
    engine.warmup()
    torch.cuda.synchronize()
    reset_launches()
    futs, view_of = [], {}

    def submit():
        m = len(futs) % N_REQUESTS
        rid, fut = engine.submit(views[:, m])
        view_of[rid] = m
        futs.append(fut)
        return fut

    with engine:
        for k in (1, 2, 4, 7, 16, 33, 64) * 2:
            burst = [submit() for _ in range(k)]
            for f in burst:
                f.result(timeout=60)
        t0 = time.perf_counter()
        flood = [submit() for _ in range(N_REQUESTS)]
        for f in flood:
            f.result(timeout=60)
        wall = time.perf_counter() - t0
    launches = read_launches()
    results = [f.result(timeout=60) for f in futs]
    stats = engine.stats
    expect_launches(launches, {"cut_fwd": stats.launches}, "lossy serving")
    key = LF.key(18)
    rids = np.array([r.rid for r in results])
    alone = LF.request_delivery_mask(key, topo, cfg, rids,
                                     deadline=SERVE_DEADLINE_MS)
    check([r.views_fused for r in results] == alone.sum(0).tolist(),
          "lossy serving: views_fused differs from the id-keyed masks")
    miss = 1.0 - float(alone.mean())
    n_views = alone.size
    bound = 5.0 * np.sqrt(np.exp(-1.0) * (1 - np.exp(-1.0)) / n_views)
    check(abs(miss - np.exp(-1.0)) <= bound,
          f"lossy serving: {miss} of the views missed, expected e^-1 within "
          f"{bound}")
    check(np.isclose(engine.meter.delivery_ratio, float(alone.mean()),
                     rtol=1e-12, atol=0),
          f"lossy serving: meter delivery ratio {engine.meter.delivery_ratio}"
          f" != the masks' {float(alone.mean())}")
    checked = 0
    for b in sorted({r.bucket for r in results}):
        rows = [r for r in results if r.bucket == b]
        for c in range(0, len(rows), b):
            chunk = rows[c:c + b]
            ids = [r.rid for r in chunk]
            ids += [ids[-1]] * (b - len(ids))
            mask = LF.request_delivery_mask(key, topo, cfg, ids,
                                            deadline=SERVE_DEADLINE_MS)
            pos = [int(np.flatnonzero(rids == r.rid)[0]) for r in chunk]
            check(np.array_equal(mask[:, :len(chunk)], alone[:, pos]),
                  f"lossy serving: a request's mask moved in bucket {b}")
            idx = [view_of[r.rid] for r in chunk]
            idx += [idx[-1]] * (b - len(idx))
            ref = scheme.predict_batched(state, views[:, idx],
                                         delivery=mask, cfg=cfg, device=DEV)
            ref = ref.cpu().numpy()[:len(chunk)]
            got = np.stack([r.probs for r in chunk])
            check(np.array_equal(got, ref),
                  f"lossy serving: rows differ from predict_batched in "
                  f"bucket {b}: max {np.abs(got - ref).max()}")
            checked += len(chunk)
    probs = np.stack([r.probs for r in results])
    check(np.isfinite(probs).all()
          and np.abs(probs.sum(-1) - 1.0).max() <= 1e-5,
          "lossy serving: rows not finite or not summing to 1")
    print(f"linkfault: served the star with LinkModel({SERVE_LINK}) and "
          f"deadline_ms={SERVE_DEADLINE_MS}: {len(results)} requests in "
          f"{stats.launches} engine launches over buckets "
          f"{sorted({r.bucket for r in results})}; {miss:.4f} of "
          f"{n_views} views missed (e^-1 = {np.exp(-1.0):.4f}); {checked} "
          f"rows == predict_batched(cuda) under the id-keyed masks bit for "
          f"bit in their bucket, every mask the same as its request's "
          f"alone; delivery ratio {engine.meter.delivery_ratio!r}; flood "
          f"of {N_REQUESTS} at {N_REQUESTS / wall:.1f} requests/s, p50 "
          f"latency {statistics.median(stats.latencies_ms[-N_REQUESTS:]):.3f}"
          f" ms; launches {launches} [{card_line}]")
    return launches


# ---------------------------------------------------------------------------
# 6d. the hybrid schemes (SplitFed, hybrid FL/SL) at full width
# ---------------------------------------------------------------------------

HYBRIDS = ("splitfed", "hybrid")
HYBRID_SAMPLES = 1024               # 16 rounds of 64 in one epoch
# the reference's ledgers (src/repro/core/schemes/{splitfed,hybrid}.py) at
# PaperExperimentConfig(), batch 64, hybrid_fl_clients=(0,): (bits,
# measured bytes) of one round, by run
HYBRID_CLOSED = {
    ("dense", "splitfed"): (115_220_480, 14_402_560),
    ("dense", "hybrid"): (23_872_128, 2_984_016),
    ("dense cut_depth=1", "splitfed"): (337_203_200, 42_150_400),
    ("dense cut_depth=1", "hybrid"): (68_268_672, 8_533_584),
    ("packed_duplex b=4", "splitfed"): (114_073_600, 14_259_200),
    ("packed_duplex b=4", "hybrid"): (22_954_624, 2_869_328),
}
HYBRID_SEED_TRIES = 1000


def hybrid_runs():
    """(label, config, topology, wire) of the hybrids' training runs: the
    dense star, the client trunk cut after its first block, the frontier
    bench's width (benchmarks/frontier_bench.py: link_bits 4 on the duplex
    wire) and the packed chain(5)."""
    import dataclasses
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import topology as T

    cfg = PaperExperimentConfig()
    return (("dense", cfg, None, "dense"),
            ("dense cut_depth=1", dataclasses.replace(cfg, cut_depth=1),
             None, "dense"),
            ("packed_duplex b=4", PaperExperimentConfig(link_bits=4), None,
             "packed_duplex"),
            ("chain(5) packed b=8", PaperExperimentConfig(link_bits=WIRE_BITS),
             T.chain(5), "packed"))


def hybrid_round_charges(name, cfg, topo, wire, state):
    """{edge: (bits, bytes)} of one round at batch 64 from the shapes alone,
    apart from the schemes' ledgers: an edge carrying n_cut cut latents and
    n_w weight exchanges moves 2 * 64 * n_cut * d * b bits of activations
    and error vectors (fp32 values, or lanes of 32 // b codewords on a
    packed direction) plus 2 * n_w * 32 * N bits of fp32 weights, N the
    client-side parameters counted in `state` (SplitFed: every payload
    client's encoder; hybrid: the weight-mode clients' encoder and branch
    head)."""
    from repro_torch import tree_leaves
    J, d, b = cfg.num_clients, cfg.d_bottleneck, cfg.link_bits
    n = sum(t.numel() for t in tree_leaves(state["params"]["encoders"])) // J
    weight = set()
    if name == "hybrid":
        weight = set(cfg.hybrid_fl_clients)
        n += d * cfg.num_classes + cfg.num_classes
    value = 4 * d
    lanes = 4 * -(-d // (32 // b)) if b <= 16 else None
    out = {}
    for e in topo.topo_edges():
        pay = topo.payload(e)
        n_cut = len(pay) if name == "splitfed" \
            else sum(j not in weight for j in pay)
        n_w = len(pay) if name == "splitfed" else len(pay) - n_cut
        rows = TRAIN_BATCH * n_cut
        fwd = rows * (value if wire == "dense" else lanes)
        bwd = rows * (lanes if wire == "packed_duplex" else value)
        out[e.key] = (2 * rows * d * b + 2 * n_w * 32 * n,
                      fwd + bwd + 2 * n_w * 4 * n)
    return out


def hybrid_launches(wire, topo, rounds):
    """The cut-layer launches of `rounds` training rounds and one
    evaluation: one cut per round (and one for the evaluation), the packed
    star's pack-emitting cut and unpack, a packed graph's pack and unpack
    on every hop."""
    if topo is not None:
        hops = len(topo.edges)
        return {"cut_fwd": rounds + 1, "cut_bwd": rounds,
                "pack": hops * rounds, "unpack_dequant": hops * rounds}
    if wire == "dense":
        return {"cut_fwd": rounds + 1, "cut_bwd": rounds}
    return {"cut_fwd_pack": rounds, "unpack_dequant": rounds,
            "cut_bwd": rounds, "cut_fwd": 1}


def hybrids_training_phase(torch, card_line):
    """run_scheme of both hybrids on each of `hybrid_runs`, 16 rounds,
    launch counts set to 0 just before and read just after: the loss falls,
    the launches as `hybrid_launches` predicts, the meter's per-edge bits
    and bytes 16 x `hybrid_round_charges` and, on the star, 16 x the
    reference's closed forms.  Returns ({"scheme run": launches}, {scheme:
    (config, the dense run's trained state)})."""
    from repro_torch.core import topology as T

    out, trained = {}, {}
    rounds = HYBRID_SAMPLES // TRAIN_BATCH
    for label, cfg, topo, wire in hybrid_runs():
        views, labels = training_data(cfg, HYBRID_SAMPLES)
        graph = topo or T.star(cfg.num_clients)
        for name in HYBRIDS:
            states = []
            curve, loss, launches, meter, wall, _ = recorded_run(
                torch, name, cfg, views, labels, epochs=1, wire=wire,
                topology=topo, states=states)
            check(len(loss) == rounds, f"{name} {label}: {len(loss)} rounds")
            first, last = falls(loss)
            expect_launches(launches, hybrid_launches(wire, topo, rounds),
                            f"{name} {label}")
            charges = hybrid_round_charges(name, cfg, graph, wire,
                                           states[-1][1])
            check(meter.edge_bits == {k: rounds * b
                                      for k, (b, _) in charges.items()}
                  and meter.edge_measured_bytes == {
                      k: rounds * n for k, (_, n) in charges.items()},
                  f"{name} {label}: per-edge bits {meter.edge_bits}, bytes "
                  f"{meter.edge_measured_bytes}, closed form {charges}")
            bits = sum(b for b, _ in charges.values())
            nbytes = sum(n for _, n in charges.values())
            if (label, name) in HYBRID_CLOSED:
                check((bits, nbytes) == HYBRID_CLOSED[label, name],
                      f"{name} {label}: ({bits}, {nbytes}) a round, the "
                      f"reference's {HYBRID_CLOSED[label, name]}")
            check(meter.total_bits == rounds * bits
                  and meter.measured_bytes == rounds * nbytes
                  and meter.delivery_ratio == 1.0,
                  f"{name} {label}: meter {meter.total_bits} bits, "
                  f"{meter.measured_bytes} bytes")
            out[f"{name} {label}"] = launches
            if label == "dense":
                trained[name] = (cfg, states[-1][1])
            print(f"hybrids: run_scheme('{name}') {label} (link_bits="
                  f"{cfg.link_bits}, cut_depth {cfg.cut_depth}, "
                  f"{'star' if topo is None else 'chain(5)'}), {rounds} "
                  f"rounds in {wall:.2f} s; loss {loss[0]:.4f} -> "
                  f"{loss[-1]:.4f} (first 4 {first:.4f}, last 4 {last:.4f}); "
                  f"accuracy {curve[-1].accuracy:.4f}; {bits} bits and "
                  f"{nbytes} bytes a round (metered == closed form per "
                  f"edge); launches {launches} [{card_line}]")
    return out, trained


def _hybrid_lossy_seed(topo, cfg, rounds):
    """The first seed whose round masks include a round with some but not
    all routes dead, one with route 0 (hybrid's weight client) dead and one
    with it alive."""
    from repro_torch.core import linkfault as LF
    J = cfg.num_clients
    for seed in range(HYBRID_SEED_TRIES):
        masks = [LF.round_delivery_mask(LF.round_key(seed, r), topo, cfg,
                                        TRAIN_BATCH, train=True)
                 for r in range(rounds)]
        if any(0 < m.sum() < J for m in masks) \
                and any(not m[0] for m in masks) and any(m[0] for m in masks):
            return seed, masks
    raise CheckFailed("no seed gives the lossy rounds the checks need")


def hybrids_faults_phase(torch, card_line):
    """Perfect links (PERFECT_STEPS rounds of each scheme: LinkModel() on
    every edge == no link model, bit for bit), then both schemes through
    run_scheme at erasure HEADLINE_ERASURE an edge of the star for 16
    rounds, launch counts set to 0 just before and read just after: the
    launches of the clean network, the meter's delivery ratio the replayed
    masks' payload fraction, and each round's state against its mask:
    SplitFed's survivors hold one average bit for bit while a dead client
    keeps its own update, not that average; the hybrid's weight client 0
    keeps its previous encoder and branch-head rows bit for bit exactly
    when its route died.  Returns {"scheme lossy star": launches}."""
    from repro_torch import tree_leaves
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import linkfault as LF
    from repro_torch.core import topology as T

    cfg = PaperExperimentConfig()
    star = T.star(cfg.num_clients)
    perfect_equals_bare(torch, card_line, [
        (f"{name} star", name, cfg, star, "dense", PERFECT_STEPS)
        for name in HYBRIDS], "hybrids")
    lossy = LF.with_links(star, LF.LinkModel(erasure=HEADLINE_ERASURE))
    rounds = LOSSY_STEPS
    seed, masks = _hybrid_lossy_seed(lossy, cfg, rounds)
    views, labels = training_data(cfg, rounds * TRAIN_BATCH)
    out = {}
    for name in HYBRIDS:
        states = []
        curve, loss, launches, meter, wall, _ = recorded_run(
            torch, name, cfg, views, labels, epochs=1, seed=seed,
            topology=lossy, states=states)
        expect_launches(launches, hybrid_launches("dense", None, rounds),
                        f"lossy {name}")
        charges = hybrid_round_charges(name, cfg, lossy, "dense",
                                       states[0][0])
        delivered = sum(charges[e.key][0] * float(np.mean(m[list(
            lossy.payload(e))])) for m in masks for e in lossy.edges)
        ratio = delivered / (rounds * sum(b for b, _ in charges.values()))
        check(np.isclose(meter.delivery_ratio, ratio, rtol=1e-12, atol=0)
              and ratio < 1.0,
              f"lossy {name}: meter delivery ratio {meter.delivery_ratio} "
              f"!= the masks' {ratio}")
        checked = []
        for r, ((before, after), m) in enumerate(zip(states, masks)):
            enc = tree_leaves(after["params"]["encoders"])
            if name == "splitfed":
                if not 0 < m.sum() < len(m):
                    continue
                alive = np.flatnonzero(m)
                for x in enc:
                    check(all(same_bits(x[alive[0]], x[j]) for j in alive),
                          f"lossy splitfed round {r}: survivors differ")
                for j in np.flatnonzero(~m):
                    check(not same_bits(enc[0][j], enc[0][alive[0]]),
                          f"lossy splitfed round {r}: dead client {j} holds "
                          f"the survivors' average")
            else:
                enc += tree_leaves(after["params"]["decoder"]["branch_heads"])
                prev = tree_leaves((before["params"]["encoders"],
                                    before["params"]["decoder"]
                                    ["branch_heads"]))
                kept = all(same_bits(a[0], b[0]) for a, b in zip(enc, prev))
                check(kept == (not m[0]),
                      f"lossy hybrid round {r}: weight client 0's route "
                      f"{'died' if not m[0] else 'held'} but its rows "
                      f"{'moved' if not kept else 'stayed'}")
                check(not same_bits(enc[0][1], prev[0][1]),
                      f"lossy hybrid round {r}: cut client 1 did not move")
            checked.append(r)
        out[f"{name} lossy star"] = launches
        print(f"hybrids: run_scheme('{name}') on the star at erasure "
              f"{HEADLINE_ERASURE} an edge (seed {seed}), {rounds} rounds in "
              f"{wall:.2f} s; loss {loss[0]:.4f} -> {loss[-1]:.4f}; accuracy "
              f"{curve[-1].accuracy:.4f}; delivery ratio "
              f"{meter.delivery_ratio!r} == the masks' {ratio!r}; rounds "
              f"{checked} checked against their masks bit for bit; "
              f"launches {launches} [{card_line}]")
    return out


def hybrids_card_vs_cpu(torch, card_line):
    """One round of each scheme from one state and one set of dropout masks
    drawn on the CPU and moved to the card: the loss and every gradient
    leaf at the phase-6 bar (grads_close), and the round's loss on both
    within rtol 1e-3."""
    from repro_torch import tree_leaves, tree_map, value_and_grad
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import paper_model, schemes

    cfg = PaperExperimentConfig()
    views, labels = training_data(cfg)
    v = torch.from_numpy(views[:, :TRAIN_BATCH])
    lab = torch.from_numpy(labels[:TRAIN_BATCH]).long()
    for k, name in enumerate(HYBRIDS):
        scheme = schemes.get(name)
        cpu = scheme.init(cfg, torch.Generator().manual_seed(21 + k),
                          device="cpu")
        gpu = tree_map(lambda t: t.to(DEV), cpu)
        masks = paper_model.decoder_dropout_masks(
            torch.Generator().manual_seed(23 + k), cfg.dense_units,
            TRAIN_BATCH)
        res = {}
        for dev, st in (("cpu", cpu), (DEV, gpu)):
            modes = (st["modes"],) if name == "hybrid" else ()
            drop = [m.to(dev) for m in masks]
            loss, _, grads = value_and_grad(
                scheme._loss, st["params"], st["state"], *modes, v.to(dev),
                lab.to(dev), cfg, wire="dense", topo=None, delivery=None,
                drop_masks=drop)
            _, m = scheme.make_round(cfg)(st, v[None].to(dev),
                                          lab[None].to(dev), None,
                                          drop_masks=drop)
            res[dev] = (float(loss), tree_leaves(grads), float(m["loss"]))
        (l_cpu, g_cpu, r_cpu), (l_gpu, g_gpu, r_gpu) = res["cpu"], res[DEV]
        max_leaf, max_abs, off = grads_close(l_gpu, l_cpu, g_gpu, g_cpu,
                                             name)
        check(np.isclose(r_gpu, r_cpu, rtol=1e-3, atol=0),
              f"{name}: the round's loss card {r_gpu} vs cpu {r_cpu}")
        print(f"hybrids: one {name} round, card against the CPU port: loss "
              f"{l_gpu:.7f} / {l_cpu:.7f}; {len(g_gpu)} gradient leaves "
              f"within rtol 1e-3 atol 1e-5 as tensors, largest |card - cpu|"
              f" / |cpu| of a leaf {max_leaf:.3g}, largest entry difference "
              f"{max_abs:.3g}, {off} entries outside the bar taken entry by "
              f"entry [{card_line}]")


def hybrids_serving_phase(torch, card_line, trained):
    """Each scheme's trained state served by a ServingEngine over buckets
    (1, 4, 16, 64), on the clean star and with LinkModel(erasure=0.3) on
    every edge, launch counts set to 0 just before and read just after:
    one cut_fwd an engine launch; rows finite, summing to 1 and equal bit
    for bit to predict_batched in their bucket (under the id-keyed masks on
    the lossy star).  Returns {"scheme served ...": launches}."""
    from repro_torch.core import linkfault as LF
    from repro_torch.core import schemes
    from repro_torch.core import topology as T
    from repro_torch.data import multiview
    from repro_torch.serving import ServingEngine

    out = {}
    for name, (cfg, state) in trained.items():
        scheme = schemes.get(name)
        imgs, _ = multiview.make_base_dataset(N_REQUESTS, seed=cfg.seed)
        views = multiview.make_views(imgs, cfg.noise_stds)
        lossy = LF.with_links(T.star(cfg.num_clients),
                              LF.LinkModel(erasure=HEADLINE_ERASURE))
        for label, topo in (("clean star", None), ("lossy star", lossy)):
            engine = ServingEngine(scheme, state, cfg, topology=topo,
                                   buckets=BUCKETS, seed=24, device=DEV)
            engine.warmup()
            torch.cuda.synchronize()
            reset_launches()
            futs, view_of = [], {}
            with engine:
                for k in (1, 2, 4, 7, 16, 33, 64) * 2:
                    burst = []
                    for _ in range(k):
                        rid, fut = engine.submit(views[:, len(futs)
                                                       % N_REQUESTS])
                        view_of[rid] = len(futs) % N_REQUESTS
                        futs.append(fut)
                        burst.append(fut)
                    for f in burst:
                        f.result(timeout=60)
            launches = read_launches()
            results = [f.result(timeout=60) for f in futs]
            stats = engine.stats
            expect_launches(launches, {"cut_fwd": stats.launches},
                            f"{name} served on the {label}")
            checked = 0
            for b in sorted({r.bucket for r in results}):
                rows = [r for r in results if r.bucket == b]
                for c in range(0, len(rows), b):
                    chunk = rows[c:c + b]
                    ids = [r.rid for r in chunk]
                    ids += [ids[-1]] * (b - len(ids))
                    mask = None if topo is None else \
                        LF.request_delivery_mask(LF.key(24), topo, cfg, ids)
                    idx = [view_of[i] for i in ids]
                    ref = scheme.predict_batched(
                        state, views[:, idx], delivery=mask, topology=topo,
                        cfg=cfg, device=DEV).cpu().numpy()[:len(chunk)]
                    got = np.stack([r.probs for r in chunk])
                    check(np.array_equal(got, ref),
                          f"{name} served on the {label}: rows differ from "
                          f"predict_batched in bucket {b}: max "
                          f"{np.abs(got - ref).max()}")
                    checked += len(chunk)
            probs = np.stack([r.probs for r in results])
            check(np.isfinite(probs).all()
                  and np.abs(probs.sum(-1) - 1.0).max() <= 1e-5,
                  f"{name} served on the {label}: rows not finite or not "
                  f"summing to 1")
            ratio = engine.meter.delivery_ratio
            check((ratio == 1.0) == (topo is None),
                  f"{name} served on the {label}: delivery ratio {ratio}")
            out[f"{name} served {label}"] = launches
            print(f"hybrids: served {name} on the {label}: {len(results)} "
                  f"requests in {stats.launches} engine launches over "
                  f"buckets {sorted({r.bucket for r in results})}, {checked}"
                  f" rows == predict_batched(cuda) bit for bit in their "
                  f"bucket; delivery ratio {ratio!r}; launches {launches} "
                  f"[{card_line}]")
    return out


def hybrids_phase(torch, card_line):
    """The hybrid schemes on the card: training, faults, card against CPU,
    serving.  Returns {run: launches} over all of them."""
    launches, trained = hybrids_training_phase(torch, card_line)
    launches.update(hybrids_faults_phase(torch, card_line))
    hybrids_card_vs_cpu(torch, card_line)
    launches.update(hybrids_serving_phase(torch, card_line, trained))
    return launches


# ---------------------------------------------------------------------------
# 6e. CUDA graphs: one dispatch per round, per bucket and per token
# ---------------------------------------------------------------------------

GRAPH_ROUNDS = 16                   # one epoch of 16 rounds a run
GRAPH_SEED = 0     # at erasure 0.3: SL skips rounds 1 and 13, FL averages
                   # over all, 4, 3 and 2 uploads (four signatures)
GRAPH_ERASURE = 0.3                 # benchmarks/links_bench.py's headline
GRAPH_SERVE_BATCHES = 3             # batches per bucket
GRAPH_TIME_ROUNDS = {"fl": 4}       # rounds an epoch in the timing (else 16)


def dispatch_runs():
    """(label, scheme, cfg, wire, topology) of the graphs phase: the six
    schemes on the dense star, INL on the packed and duplex wires and the
    packed chain(5), then each scheme at erasure 0.3 an edge."""
    import dataclasses
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import linkfault as LF
    from repro_torch.core import topology as T
    cfg = PaperExperimentConfig()
    wire_cfg = PaperExperimentConfig(link_bits=WIRE_BITS)
    prior = dataclasses.replace(cfg, learned_prior=True)
    six = (("inl", "inl", cfg), ("inl+learned_prior", "inl", prior),
           ("sl", "sl", cfg), ("fl", "fl", cfg),
           ("splitfed", "splitfed", cfg), ("hybrid", "hybrid", cfg))
    lossy = LF.with_links(T.star(cfg.num_clients),
                          LF.LinkModel(erasure=GRAPH_ERASURE))
    runs = [(label, name, c, "dense", None) for label, name, c in six]
    runs += [("inl packed", "inl", wire_cfg, "packed", None),
             ("inl packed_duplex", "inl", wire_cfg, "packed_duplex", None),
             ("inl chain(5) packed", "inl", wire_cfg, "packed",
              T.chain(wire_cfg.num_clients))]
    runs += [(f"{label} lossy", name, c, "dense", lossy)
             for label, name, c in six]
    return runs


def expected_signatures(name, cfg, wire, topology, rounds, first=0):
    """The host signatures of a run's rounds `first`..`first + rounds - 1`:
    each round's host part on its fault key, as run_scheme hands them
    out."""
    from repro_torch.core import linkfault as LF
    from repro_torch.core import schemes
    from repro_torch.core import topology as T
    plan, _ = schemes.get(name).make_round_parts(cfg, wire=wire,
                                                 topology=topology)
    faulty = LF.active(T.resolve(topology, cfg), cfg, train=True)
    return {plan(LF.round_key(GRAPH_SEED, g) if faulty else None,
                 TRAIN_BATCH)[0] for g in range(first, first + rounds)}


def ledgers(meter):
    return (meter.total_bits, meter.measured_bytes, meter.delivered_bits,
            meter.delivered_measured_bytes, dict(meter.edge_bits),
            dict(meter.edge_measured_bytes), dict(meter.edge_delivered_bits))


def graph_training_phase(torch, card_line):
    """Each run of `dispatch_runs` for one epoch of 16 rounds under "scan"
    and under "per_round" from one seed, deterministic algorithms on: the
    per-round losses and every leaf of the final state bit for bit, the
    same launches per kernel, the same offered and delivered ledgers and
    curve, and exactly one capture per host signature.  Returns ({label:
    scan launches}, the trained INL state, {label: the scan run's (curve,
    losses, final state (for SHARD_STATES' labels, else None), launches,
    ledgers)}: the single-device runs the sharded phase holds its meshes
    against)."""
    from repro_torch import tree_leaves
    from repro_torch.core import schemes

    torch.use_deterministic_algorithms(True, warn_only=True)
    out, trained, refs = {}, None, {}
    data = {}
    try:
        for label, name, cfg, wire, topo in dispatch_runs():
            bpr = schemes.get(name).batches_per_round(cfg)
            n = GRAPH_ROUNDS * bpr * TRAIN_BATCH
            if n not in data:
                data[n] = training_data(cfg, n)
            views, labels = data[n]
            caps, runs = {}, {}
            for dispatch in ("scan", "per_round"):
                states = []
                curve, loss, launches, meter, wall, _ = recorded_run(
                    torch, name, cfg, views, labels, epochs=1, wire=wire,
                    seed=GRAPH_SEED, topology=topo, states=states,
                    dispatch=dispatch, captures=caps)
                runs[dispatch] = (curve, loss, states[-1][1], launches,
                                  meter, wall)
            (c_s, l_s, s_s, n_s, m_s, w_s), (c_r, l_r, s_r, n_r, m_r, w_r) \
                = runs["scan"], runs["per_round"]
            check(len(l_s) == len(l_r) == GRAPH_ROUNDS,
                  f"graphs {label}: {len(l_s)} / {len(l_r)} rounds")
            # python floats of fp32 losses: equal iff the bits are
            check(l_s == l_r, f"graphs {label}: scan losses {l_s} != "
                              f"per_round {l_r}")
            leaves_s, leaves_r = tree_leaves(s_s), tree_leaves(s_r)
            check(len(leaves_s) == len(leaves_r) and all(
                torch.equal(a, b) for a, b in zip(leaves_s, leaves_r)),
                f"graphs {label}: the final states differ")
            check(n_s == n_r, f"graphs {label}: launches scan {n_s} "
                              f"per_round {n_r}")
            check(ledgers(m_s) == ledgers(m_r) and c_s == c_r,
                  f"graphs {label}: ledgers or curves differ")
            want = expected_signatures(name, cfg, wire, topo, GRAPH_ROUNDS)
            check(set(caps) == want and all(v == 1 for v in caps.values()),
                  f"graphs {label}: captures {caps}, signatures {want}")
            out[label] = {k: v for k, v in n_s.items() if v}
            refs[label] = (c_s, l_s, s_s if label in SHARD_STATES else None,
                           n_s, ledgers(m_s))
            if label == "inl":
                trained = s_s
            print(f"graphs: run_scheme('{name}') {label} (wire={wire}, "
                  f"link_bits={cfg.link_bits}), {GRAPH_ROUNDS} rounds: "
                  f"scan == per_round bit for bit (losses, {len(leaves_s)} "
                  f"state leaves), launches {out[label]} under both, "
                  f"delivery ratio {m_s.delivery_ratio:.5f} under both, "
                  f"captures {caps}; loss {l_s[0]:.4f} -> {l_s[-1]:.4f}; "
                  f"wall scan {w_s:.2f} s, per_round {w_r:.2f} s "
                  f"[{card_line}]")
    finally:
        torch.use_deterministic_algorithms(False)
    return out, trained, refs


def graph_serving_check(torch, card_line, state):
    """The trained INL state served over buckets (1, 4, 16, 64), clean and
    at erasure 0.3 an edge: after warmup() and GRAPH_SERVE_BATCHES batches
    of b requests per bucket, trace_counts == {b: 1}, and every batch's
    rows equal predict_batched (eager) bit for bit.  Returns the launches
    of the clean engine's batches."""
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import linkfault as LF
    from repro_torch.core import schemes
    from repro_torch.core import topology as T
    from repro_torch.data import multiview
    from repro_torch.serving import ServingEngine

    cfg = PaperExperimentConfig()
    scheme = schemes.get("inl")
    n = GRAPH_SERVE_BATCHES * sum(BUCKETS)
    imgs, _ = multiview.make_base_dataset(n, seed=cfg.seed + 3)
    views = multiview.make_views(imgs, cfg.noise_stds)
    lossy = LF.with_links(T.star(cfg.num_clients),
                          LF.LinkModel(erasure=GRAPH_ERASURE))
    launches = None
    for label, topo in (("clean", None), ("lossy", lossy)):
        engine = ServingEngine(scheme, state, cfg, topology=topo,
                               buckets=BUCKETS, seed=19, device=DEV)
        engine.warmup()
        torch.cuda.synchronize()
        reset_launches()
        batches, at = [], 0
        for b in BUCKETS:
            for _ in range(GRAPH_SERVE_BATCHES):
                block = views[:, at:at + b]
                at += b
                batches.append((b, block) + engine.serve(block))
        torch.cuda.synchronize()
        got = read_launches()
        rows = 0
        for b, block, probs, served in batches:
            check({r.bucket for r in served} == {b},
                  f"graphs serving: a block of {b} rode buckets "
                  f"{ {r.bucket for r in served} }")
            mask = None
            if topo is not None:
                mask = LF.request_delivery_mask(
                    LF.key(19), topo, cfg, [r.rid for r in served])
            want = scheme.predict_batched(state, block, delivery=mask,
                                          cfg=cfg, device=DEV).cpu().numpy()
            check(np.array_equal(probs, want),
                  f"graphs serving {label}: bucket {b} rows differ from "
                  f"the eager predict_batched: max "
                  f"{np.abs(probs - want).max()}")
            rows += b
        check(engine.trace_counts == {b: 1 for b in BUCKETS},
              f"graphs serving {label}: trace_counts {engine.trace_counts}")
        check(got["cut_fwd"] == engine.stats.launches,
              f"graphs serving {label}: cut_fwd {got['cut_fwd']} in "
              f"{engine.stats.launches} engine launches")
        if launches is None:
            launches = {k: v for k, v in got.items() if v}
        print(f"graphs: served the trained INL state {label} over buckets "
              f"{BUCKETS}, {GRAPH_SERVE_BATCHES} batches each: trace_counts "
              f"{engine.trace_counts}, {rows} rows == eager predict_batched "
              f"bit for bit, cut_fwd {got['cut_fwd']} in "
              f"{engine.stats.launches} engine launches [{card_line}]")
    return launches


def graphs_phase(torch, card_line):
    """Training and serving under CUDA graphs.  Returns ({run: launches}
    of the scan runs and the served batches, the trained INL state, the
    single-device reference runs of `graph_training_phase`)."""
    t0 = time.perf_counter()
    launches, trained, refs = graph_training_phase(torch, card_line)
    launches["served (graphs)"] = graph_serving_check(torch, card_line,
                                                      trained)
    print(f"graphs: phase took {time.perf_counter() - t0:.1f} s")
    return launches, trained, refs


# ---------------------------------------------------------------------------
# 6f. checkpoints: resume bit for bit
# ---------------------------------------------------------------------------

CKPT_EPOCHS = 2                     # the uninterrupted run; resumed at 1
CKPT_TIMING_REPS = 3


def checkpoint_runs():
    """(label, scheme, cfg, wire, topology, dispatch) of the checkpoint
    phase: the six golden runs on the dense star under "scan", INL under
    "per_round", INL on links_bench's lossy star (erasure 0.3 an edge,
    edge dropout 0.2) and INL on the packed wire."""
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    runs = [(label, name, cfg, "dense", None, "scan")
            for label, name, cfg, _, _ in dispatch_runs()[:6]]
    _, _, lossy_cfg, lossy_star, _, _ = lossy_runs()[0]
    runs += [("inl per_round", "inl", PaperExperimentConfig(), "dense",
              None, "per_round"),
             ("inl lossy star", "inl", lossy_cfg, "dense", lossy_star,
              "scan"),
             ("inl packed", "inl", PaperExperimentConfig(
                 link_bits=WIRE_BITS), "packed", None, "scan")]
    return runs


def same_checkpoints(checkpoint, d1, d2, step):
    """Checkpoint `step` of two directories: every array bit for bit and
    the sidecars (curve, ledgers, generator state) equal.  Returns the
    number of arrays."""
    import os
    p1, p2 = (os.path.join(d, f"ckpt_{step:08d}.npz") for d in (d1, d2))
    with np.load(p1) as a, np.load(p2) as b:
        check(sorted(a.files) == sorted(b.files) and len(a.files) > 0,
              f"checkpoints {p1} and {p2} hold other leaves")
        for key in a.files:
            check(a[key].dtype == b[key].dtype
                  and a[key].tobytes() == b[key].tobytes(),
                  f"checkpoint leaf {key} differs between {p1} and {p2}")
        n = len(a.files)
    check(checkpoint.load_meta(d1, step) == checkpoint.load_meta(d2, step),
          f"the sidecars of {p1} and {p2} differ")
    return n


def checkpoint_timing(torch, checkpoint, cfg, d, card_line):
    """Save and restore ms of the trained INL state at full width (the
    median of CKPT_TIMING_REPS, host clock, the restore ending in a
    synchronize) and the npz's size."""
    import os
    from repro_torch import tree_leaves
    from repro_torch.core import schemes
    template = schemes.get("inl").init(cfg, 0, device=DEV)
    torch.cuda.synchronize()
    restore_ms, save_ms = [], []
    for _ in range(CKPT_TIMING_REPS):
        t0 = time.perf_counter()
        state, step = checkpoint.restore(d, template)
        torch.cuda.synchronize()
        restore_ms.append((time.perf_counter() - t0) * 1e3)
    out = os.path.join(d, "timed")
    for i in range(CKPT_TIMING_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = checkpoint.save(out, i, state)
        save_ms.append((time.perf_counter() - t0) * 1e3)
    mb = os.path.getsize(path) / 1e6
    n = sum(t.numel() for t in tree_leaves(state))
    print(f"checkpoint times: the INL state at PaperExperimentConfig() "
          f"({n} values with the optimizer's) save "
          f"{statistics.median(save_ms):.3f} ms, restore onto the card "
          f"{statistics.median(restore_ms):.3f} ms (medians of "
          f"{CKPT_TIMING_REPS}, host clock), npz {mb:.3f} MB [{card_line}]")
    return statistics.median(save_ms), statistics.median(restore_ms), mb


def checkpoint_phase(torch, card_line):
    """Each run of `checkpoint_runs`, deterministic algorithms on: run_scheme
    for CKPT_EPOCHS epochs with ckpt_dir against CKPT_EPOCHS // 2 epochs
    with ckpt_dir and then resume=True to CKPT_EPOCHS: the curves equal,
    the resumed rounds' losses the uninterrupted run's, both final
    checkpoints' leaves and sidecars (ledgers, generator state) bit for
    bit, the meters' ledgers equal, and under "scan" one capture per host
    signature in the resumed run.  Then a directory whose newest npz lost
    its sidecar resumes from the one before, and the save and restore
    times.  Returns ({run: launches of the resumed run}, the timings)."""
    import shutil
    from repro_torch import checkpoint
    from repro_torch.core import schemes
    from repro_torch.core.schemes import runner

    t_phase = time.perf_counter()
    root = ROOT / "build" / "checkpoints"
    shutil.rmtree(root, ignore_errors=True)
    half = CKPT_EPOCHS // 2
    torch.use_deterministic_algorithms(True, warn_only=True)
    out, times = {}, None
    try:
        for label, name, cfg, wire, topo, dispatch in checkpoint_runs():
            views, labels = training_data(cfg)
            rounds = runner.rounds_per_epoch(schemes.get(name), cfg,
                                             len(labels), TRAIN_BATCH)
            full, part = (str(root / label.replace(" ", "_") / k)
                          for k in ("full", "part"))
            kw = dict(wire=wire, topology=topo, dispatch=dispatch)
            c_g, l_g, _, m_g, w_g, _ = recorded_run(
                torch, name, cfg, views, labels, epochs=CKPT_EPOCHS,
                ckpt_dir=full, **kw)
            c_h, _, _, _, _, _ = recorded_run(
                torch, name, cfg, views, labels, epochs=half,
                ckpt_dir=part, **kw)
            caps = {}
            c_r, l_r, n_r, m_r, w_r, _ = recorded_run(
                torch, name, cfg, views, labels, epochs=CKPT_EPOCHS,
                ckpt_dir=part, resume=True, captures=caps, **kw)
            check(c_h == c_g[:half] and c_r == c_g,
                  f"checkpoint {label}: resumed curve {c_r} != {c_g}")
            check(l_r == l_g[half * rounds:],
                  f"checkpoint {label}: the resumed rounds' losses differ")
            leaves = same_checkpoints(checkpoint, full, part, CKPT_EPOCHS)
            check(ledgers(m_r) == ledgers(m_g),
                  f"checkpoint {label}: the ledgers differ")
            if dispatch == "scan":
                want = expected_signatures(name, cfg, wire, topo,
                                           (CKPT_EPOCHS - half) * rounds,
                                           first=half * rounds)
                check(set(caps) == want
                      and all(v == 1 for v in caps.values()),
                      f"checkpoint {label}: captures {caps}, signatures "
                      f"{want}")
            out[label] = {k: v for k, v in n_r.items() if v}
            print(f"checkpoint: run_scheme('{name}') {label} ({wire}, "
                  f"{dispatch}), {CKPT_EPOCHS} epochs of {rounds} rounds == "
                  f"{half} + resume=True bit for bit (curve, "
                  f"{len(l_r)} resumed losses, {leaves} state leaves, "
                  f"ledgers, generator state; delivery ratio "
                  f"{m_r.delivery_ratio:.5f}), captures in the resumed run "
                  f"{caps if dispatch == 'scan' else '(per_round)'}, "
                  f"launches {out[label]}; wall {w_g:.2f} s uninterrupted, "
                  f"{w_r:.2f} s resumed [{card_line}]")
            if label == "inl":
                # a save killed between the npz and its sidecar
                import os
                os.remove(os.path.join(part, f"ckpt_{CKPT_EPOCHS:08d}"
                                             ".json"))
                check(checkpoint.latest_step(part) == half,
                      "checkpoint: a sidecarless npz counted")
                c_t = recorded_run(torch, name, cfg, views, labels,
                                   epochs=CKPT_EPOCHS, ckpt_dir=part,
                                   resume=True, **kw)[0]
                check(c_t == c_g, "checkpoint: the resume past a torn "
                                  "checkpoint differs")
                print(f"checkpoint: epoch {CKPT_EPOCHS}'s sidecar removed, "
                      f"resume=True went on from epoch {half}: the curve "
                      f"== the uninterrupted one [{card_line}]")
                times = checkpoint_timing(torch, checkpoint, cfg, full,
                                          card_line)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    print(f"checkpoint: phase took {time.perf_counter() - t_phase:.1f} s")
    return out, times


# ---------------------------------------------------------------------------
# 6g. the placement search
# ---------------------------------------------------------------------------

SEARCH_EPOCHS = 2


def search_grid():
    """The spaces of benchmarks/frontier_bench.py's build_grid(smoke=True),
    copied: INL on star(5) and chain(5) at 32 bits dense and at 4 bits on
    packed_duplex, splitfed and hybrid on star(5) at cut depth None and 1
    on both, fl and sl on star(5): 14 points."""
    from repro_torch.search.space import SearchSpace, merge_points
    topos, star, widths = ("star(5)", "chain(5)"), ("star(5)",), (4,)
    return merge_points(
        SearchSpace(schemes=("inl",), topologies=topos),
        SearchSpace(schemes=("inl",), topologies=topos, link_bits=widths,
                    wires=("packed_duplex",)),
        SearchSpace(schemes=("splitfed", "hybrid"), topologies=star,
                    cut_depths=(None, 1)),
        SearchSpace(schemes=("splitfed", "hybrid"), topologies=star,
                    link_bits=widths, wires=("packed_duplex",),
                    cut_depths=(None, 1)),
        SearchSpace(schemes=("fl", "sl"), topologies=star))


def search_phase(torch, card_line):
    """run_search over `search_grid` at PaperExperimentConfig()'s widths
    with TRAIN_SAMPLES samples, batch 64, SEARCH_EPOCHS epochs,
    train_pruned=True, deterministic algorithms on, launch counts set to 0
    just before and read just after: every trained point priced == metered
    == closed form (frontier_bench.assert_parity's bars, |d| x 1e9 < 1
    bit), every pruned point's accuracy == its stand-in's exactly (a
    star-dominated one costlier), a non-empty frontier of candidates.
    Returns the launches."""
    import dataclasses
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.search import driver
    from repro_torch.search.pricing import CANDIDATE, PRUNED_STAR

    base = dataclasses.replace(PaperExperimentConfig(),
                               dataset_size=TRAIN_SAMPLES)
    stamps = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        result = driver.run_search(
            search_grid(), base, epochs=SEARCH_EPOCHS,
            batch_size=TRAIN_BATCH, eval_n=256, train_pruned=True,
            log=lambda msg: stamps.append((time.perf_counter(), msg)),
            device=DEV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        torch.use_deterministic_algorithms(False)
    priced = {pp.key: pp for pp in result.priced}
    check(len(priced) == 14 and len(result.measured) == 14
          and all(m.trained for m in result.measured.values()),
          f"search: {len(priced)} priced, {len(result.measured)} measured")
    for m in result.measured.values():
        for a, b, what in ((m.gbits, m.priced_gbits, "priced"),
                           (m.measured_gbits, m.priced_measured_gbits,
                            "priced wire"),
                           (m.gbits, m.measured_gbits, "closed-form")):
            check(abs(a - b) * 1e9 < 1.0,
                  f"search {m.key}: {what} {b} Gbit != metered {a} Gbit")
        if m.status != CANDIDATE:
            sib = result.measured[m.stand_in]
            check(m.accuracy == sib.accuracy,
                  f"search {m.key}: accuracy {m.accuracy} != its stand-in "
                  f"{sib.key}'s {sib.accuracy}")
            check(m.status != PRUNED_STAR or m.gbits > sib.gbits,
                  f"search {m.key}: not costlier than its star sibling")
    check(result.frontier and all(m.status == CANDIDATE and m.trained
                                  for m in result.frontier),
          f"search: frontier {[m.key for m in result.frontier]}")
    walls = [b[0] - a[0] for a, b in zip(stamps, stamps[1:])]
    for (key, m), w in zip(result.measured.items(), walls):
        print(f"search: {key} ({m.status}"
              f"{'' if m.stand_in is None else ', stands in: ' + m.stand_in}"
              f") accuracy {m.accuracy:.4f}, {m.gbits:.6f} Gbit accounted "
              f"== metered == priced, measured {m.measured_gbits:.6f} "
              f"Gbit, wall {w:.2f} s [{card_line}]")
    print(f"search: {len(priced)} points priced in "
          f"{stamps[0][0] - t0:.2f} s, all trained ({SEARCH_EPOCHS} epochs "
          f"each, {TRAIN_SAMPLES} samples, batch {TRAIN_BATCH}); frontier "
          f"{[m.key for m in result.frontier]}; launches "
          f"{ {k: v for k, v in launches.items() if v} }; phase "
          f"{wall:.1f} s [{card_line}]")
    return launches


# ---------------------------------------------------------------------------
# 6h. sharded: the rounds across a mesh of ranks
# ---------------------------------------------------------------------------

# the graphs phase's runs whose final state the one-rank NCCL mesh must
# reproduce bit for bit
SHARD_STATES = ("inl", "fl", "sl", "inl packed")
SHARD_RTOL = 1e-4
# a replayed round's new state against the single-device round's, leaf by
# leaf (relative 2-norm): the optimizer's moments, the model state and the
# parameters (`state_deviation`).  On one H100 the data-split sums part a
# round's moments by up to 2.53e-3 of a leaf at full width (PERF.md
# section 6); the planted fault (`planted_fault`) parts them by 3.56
SHARD_STATE_RTOL = 1e-2
ADAM_B1 = 0.9                       # optim.adam's b1
SHARD_TIME_ROUNDS = 4               # rounds an epoch in the round timing
SHARD_TIMEOUT = 300.0               # seconds a spawned world may take
# the fan-in of one INL round at (client=5), PaperExperimentConfig(
# link_bits=8), batch 64, over the five ranks: (bytes all-gathered,
# bytes reduce-scattered), and the bytes packed_duplex is charged
FAN_IN_BYTES = {"dense": (81920, 81920), "packed": (20480, 81920),
                "packed_duplex": (20480, 81920)}
DUPLEX_CHARGED = 40960
# the runs held by their free-running losses: those whose single-device
# run trains.  The packed runs at link_bits=8 diverge on the single
# device as well (PERF.md section 7); the replayed rounds and packed ==
# dense hold them
DRIFT_RUNS = ("inl", "inl+learned_prior", "fl", "sl", "inl lossy")
# leaves whose gradient is zero: a conv bias feeds BatchNorm, which
# subtracts it again, so its gradient is rounding, Adam turns it into
# steps of about lr (its moments too), and the running means carry them
NOISE_LEAF = re.compile(r"/convs/\d+/b$|/bns/\d+/mean$")
# a parameter tree's path prefix -> its first moment's
MOMENT_OF = (("/params/", "/opt/m/"), ("/client/", "/opt_c/m/"),
             ("/server/", "/opt_s/m/"))
DENSE_TWIN = "inl dense b=8"         # the dense twin of "inl packed"
# the free-running loss drift's limit, in controls' drifts (`check_drifts`):
# on one H100 the meshes drift up to 7.5x their own control (INL on
# 'data') and 0.22x the limit, the planted fault 5.6x the limit (PERF.md
# section 6)
DRIFT_FACTOR = 10.0


def shard_layouts():
    """{layout: (ranks, backend, runs)}: each run (label, scheme, cfg,
    wire, topology) one of the graphs phase's (`dispatch_runs`), whose
    single-device scan run it is held against, except DENSE_TWIN, the
    dense twin of "inl packed" on the mesh."""
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    runs = {label: (label, name, cfg, wire, topo)
            for label, name, cfg, wire, topo in dispatch_runs()}

    def pick(*labels):
        return [runs[label] for label in labels]
    dense8 = (DENSE_TWIN, "inl", PaperExperimentConfig(
        link_bits=WIRE_BITS), "dense", None)
    return {
        "nccl 1x1": (1, "nccl", pick("inl", "fl", "sl", "inl packed")),
        "gloo data=2": (2, "gloo", pick("inl", "fl", "sl", "inl lossy")),
        "gloo client=5": (5, "gloo", pick(
            "inl", "inl+learned_prior", "fl", "inl packed",
            "inl packed_duplex", "inl chain(5) packed") + [dense8])}


def replicated_run(name, mesh_shape):
    """FL on a data axis: 'data' only replicates FL (every data rank runs
    the same clients on the whole batch), so its run is the single-device
    run bit for bit and needs no replay."""
    return name == "fl" and mesh_shape["client"] == 1


def _host_mesh(num_clients):
    import warnings
    from repro_torch.launch import mesh as mesh_lib
    with warnings.catch_warnings():
        # J=5 on one or two ranks: the replicated client axis, warned
        warnings.simplefilter("ignore", UserWarning)
        return mesh_lib.make_inl_host_mesh(num_clients, device=DEV)


def run_data(name, cfg):
    """The training set of a run of the phase: GRAPH_ROUNDS rounds'
    minibatches."""
    from repro_torch.core import schemes
    return training_data(cfg, GRAPH_ROUNDS * TRAIN_BATCH
                         * schemes.get(name).batches_per_round(cfg))


def epoch_inputs(torch, name, cfg, topo, views, labels):
    """run_scheme's first epoch at GRAPH_SEED on (views, labels) as its
    rounds take it: the rounds' views (K, R, J, B, ...) and labels (K, R,
    B) on the card and their fault keys (None on reliable links)."""
    from repro_torch.core import linkfault as LF
    from repro_torch.core import schemes
    from repro_torch.core import topology as T
    from repro_torch.data import multiview
    bpr = schemes.get(name).batches_per_round(cfg)
    v = torch.as_tensor(views, device=DEV)
    lab = torch.as_tensor(labels, device=DEV).long()
    idx = torch.as_tensor(np.array(list(multiview.batch_indices(
        len(labels), TRAIN_BATCH, seed=0))).reshape(
            GRAPH_ROUNDS, bpr, TRAIN_BATCH), device=DEV)
    faulty = LF.active(T.resolve(topo, cfg), cfg, train=True)
    keys = [LF.round_key(GRAPH_SEED, k) if faulty else None
            for k in range(GRAPH_ROUNDS)]
    return (v[:, idx].permute(1, 2, 0, *range(3, v.dim() + 2)), lab[idx],
            keys)


def leaf_paths(tree, prefix=""):
    """[(path, tensor)] of a state tree's leaves in tree_leaves order, keys
    joined by "/"."""
    if hasattr(tree, "dtype") and hasattr(tree, "shape"):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return []
    return [pl for k, v in items for pl in leaf_paths(v, f"{prefix}/{k}")]


def moment_path(path):
    for params, moment in MOMENT_OF:
        if path.startswith(params):
            return moment + path[len(params):]
    return None


def state_deviation(torch, got, want, before, *, one_step):
    """A replayed round's state `got` (this rank's slice) against the
    single-device round's `want`, both from `before`: the largest relative
    2-norm deviation |got - want| / |want| of a leaf, NOISE_LEAF apart,
    over the optimizer's moments and the model state, and over the
    parameters.  Where the parameters are one Adam step of the round's
    gradient (`one_step`: INL, SL), an entry whose gradient rounds to
    nothing is left out of them: the round's gradient g of it, as the
    single-device round computed it ((m_new - b1 m_old) / (1 - b1)), is no
    larger than the mesh's nonzero difference from it, so its sign, and
    Adam's step of about lr, is rounding.  The moments, held in full,
    bound those differences.  Returns {"state": (dev, path), "params":
    (dev, path), "left_out": entries left out, "entries": parameter entries,
    "left_g": (largest |g| left out over the RMS of its leaf's g, path),
    "left_share": the largest share of a leaf's gradient norm left out,
    "bias_g": the conv biases' RMS gradient over their weights'}."""
    G, W, B = (dict(leaf_paths(t)) for t in (got, want, before))
    out = {"state": (0.0, None), "params": (0.0, None), "left_out": 0,
           "entries": 0, "left_g": (0.0, None), "left_share": 0.0,
           "bias_g": 0.0}

    def worse(key, dev, path):
        if dev > out[key][0]:
            out[key] = (dev, path)

    def grad(path):
        mp = moment_path(path)
        return W[mp].double() - ADAM_B1 * B[mp].double(), mp
    for path, b in W.items():
        a = G[path]
        if not b.is_floating_point():
            worse("state", 0.0 if torch.equal(a, b) else float("inf"), path)
            continue
        is_param = moment_path(path) is not None
        if NOISE_LEAF.search(path):
            if is_param and one_step and path.endswith("/b"):
                gb, _ = grad(path)
                gw, _ = grad(path[:-1] + "w")
                out["bias_g"] = max(out["bias_g"], float(
                    gb.pow(2).mean().sqrt() / gw.pow(2).mean().sqrt()))
            continue
        a, b = a.double(), b.double()
        if is_param and one_step:
            g, mp = grad(path)
            diff = (G[mp].double() - W[mp].double()).abs()
            keep = (g.abs() > diff) | (diff == 0)
            out["entries"] += keep.numel()
            if not bool(keep.all()):
                out["left_out"] += int((~keep).sum())
                rms = float(g.pow(2).mean().sqrt())
                if rms > 0:
                    worse("left_g", float(g[~keep].abs().max()) / rms, path)
                    out["left_share"] = max(out["left_share"], float(
                        g[~keep].norm() / g.norm()))
                a, b = a[keep], b[keep]
        elif is_param:
            out["entries"] += b.numel()
        dev = float((a - b).norm() / b.norm().clamp_min(1e-30))
        worse("params" if is_param else "state", dev, path)
    return out


def replay_rounds(torch, mesh, name, cfg, wire, topo, views, labels):
    """The single-device run's 16 rounds (run_scheme's first epoch at
    GRAPH_SEED: its batches, draws and fault keys), each replayed on the
    mesh from the state and generator state that entered it.  Rank 0
    alone runs the single-device rounds and broadcasts each round's state
    (gloo, from the host) and generator state; every rank runs the
    sharded round on its slice and holds the result against its slice of
    the single-device round's (`state_deviation`).  Returns [(mesh loss,
    single-device loss, state_deviation)] a round."""
    import torch.distributed as dist
    from repro_torch import tree_leaves, tree_unflatten
    from repro_torch.core import schemes
    from repro_torch.launch import sharding

    scheme = schemes.get(name)
    ep_views, ep_labels, keys = epoch_inputs(torch, name, cfg, topo, views,
                                             labels)
    state = scheme.init(cfg, torch.Generator(device=DEV).manual_seed(
        GRAPH_SEED), device=DEV)
    shapes = [(t.shape, t.dtype) for t in tree_leaves(state)]
    floats = [i for i, (_, dt) in enumerate(shapes) if dt.is_floating_point]
    ints = [i for i, (_, dt) in enumerate(shapes)
            if not dt.is_floating_point]
    flat = torch.empty(sum(shapes[i][0].numel() for i in floats),
                       dtype=torch.float32)
    specs = scheme.state_shardings(cfg, state, mesh)
    sharded = scheme.make_sharded_round(cfg, mesh, wire=wire, topology=topo)
    root = dist.get_rank() == 0
    if root:
        single = scheme.make_round(cfg, wire=wire, topology=topo)
        gen = torch.Generator(device=DEV).manual_seed(GRAPH_SEED + 1)
    gen_mesh = torch.Generator(device=DEV)
    out, prev, loss = [], None, None
    for k in range(GRAPH_ROUNDS + 1):
        if k:
            # the state entering round k (the single-device round k - 1's)
            leaves = tree_leaves(state) if root else None
            if root:
                flat.copy_(torch.cat([leaves[i].reshape(-1).float()
                                      for i in floats]).cpu())
            dist.broadcast(flat, src=0)
            small = [[leaves[i].tolist() for i in ints] if root else None,
                     loss]
            dist.broadcast_object_list(small, src=0)
            if not root:
                parts = iter(flat.to(DEV).split(
                    [shapes[i][0].numel() for i in floats]))
                ivals = iter(small[0])
                state = tree_unflatten(state, [
                    next(parts).reshape(s) if dt.is_floating_point
                    else torch.tensor(next(ivals), dtype=dt,
                                      device=DEV).reshape(s)
                    for s, dt in shapes])
            want = sharding.shard_state(state, specs, mesh)
            st_mesh, loss_mesh, st_in = prev
            out.append((loss_mesh, small[1], state_deviation(
                torch, st_mesh, want, st_in, one_step=name != "fl")))
        if k == GRAPH_ROUNDS:
            break
        box = [gen.get_state() if root else None]
        dist.broadcast_object_list(box, src=0)
        gen_mesh.set_state(box[0])
        st_in = sharding.shard_state(state, specs, mesh)
        st_mesh, m_mesh = sharded(st_in, ep_views[k], ep_labels[k], gen_mesh,
                                  round_key=keys[k])
        prev = (st_mesh, float(m_mesh["loss"]), st_in)
        if root:
            state, m = single(state, ep_views[k], ep_labels[k], gen,
                              round_key=keys[k])
            loss = float(m["loss"])
    return out


def planted_fault(torch, mesh, name, cfg, wire, topo):
    """The negative control on a data axis: the INL run with the
    gradients' mean over 'data' taken out of the sharded round, so each
    rank steps with its own half batch's gradient (a missing pmean).  Its
    free-running losses and its 16 replayed rounds, read against the
    limits the true runs are held to."""
    from repro_torch.core import sharded
    views, labels = run_data(name, cfg)
    mean = sharded._pmean_tree
    sharded._pmean_tree = lambda axis, tree: tree
    try:
        _, loss, *_ = recorded_run(
            torch, name, cfg, views, labels, epochs=1, wire=wire,
            seed=GRAPH_SEED, topology=topo, dispatch="scan", mesh=mesh)
        replayed = replay_rounds(torch, mesh, name, cfg, wire, topo, views,
                                 labels)
    finally:
        sharded._pmean_tree = mean
    return {"losses": loss, "replayed": replayed}


def mesh_runs(torch, mesh, runs, *, keep_states):
    """This rank's side of a layout: each run through run_scheme(mesh=)
    under "scan" (recorded_run), deterministic algorithms on; on a gloo
    layout each run's 16 rounds replayed (`replay_rounds`; not the dense
    twin, nor a `replicated_run`) and, on the data axis, the planted
    fault; then the fan-in's bytes of one round a wire (on a client axis
    of more than one rank).  Returns {label:
    {curve, losses, launches, ledgers, captures, wall, replayed, state
    (this rank's final slice, where `keep_states`)}, "packed == dense": on
    this rank's slices (where the layout has both), "planted": ...,
    "bytes": ..., "seconds": {step: seconds}}."""
    from repro_torch import tree_leaves
    from repro_torch.core import schemes

    world = mesh.shape["client"] * mesh.shape["data"]
    torch.use_deterministic_algorithms(True, warn_only=True)
    out, data, states = {"mesh": dict(mesh.shape)}, {}, {}
    seconds = out["seconds"] = {}
    try:
        for label, name, cfg, wire, topo in runs:
            key = (schemes.get(name).batches_per_round(cfg), cfg.noise_stds)
            if key not in data:
                data[key] = run_data(name, cfg)
            views, labels = data[key]
            trace, caps = [], {}
            t0 = time.perf_counter()
            curve, loss, launches, meter, wall, _ = recorded_run(
                torch, name, cfg, views, labels, epochs=1, wire=wire,
                seed=GRAPH_SEED, topology=topo, states=trace,
                dispatch="scan", captures=caps, mesh=mesh)
            states[label] = trace[-1][1]
            out[label] = {"curve": curve, "losses": loss,
                          "launches": launches, "ledgers": ledgers(meter),
                          "captures": caps, "wall": wall, "replayed": None,
                          "state": states[label] if keep_states else None}
            t1 = time.perf_counter()
            if world > 1 and label != DENSE_TWIN \
                    and not replicated_run(name, mesh.shape):
                out[label]["replayed"] = replay_rounds(
                    torch, mesh, name, cfg, wire, topo, views, labels)
            seconds[label] = (t1 - t0, time.perf_counter() - t1)
        if "inl packed" in states and DENSE_TWIN in states:
            out["packed == dense"] = (
                out["inl packed"]["losses"] == out[DENSE_TWIN]["losses"]
                and all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(states["inl packed"]),
                    tree_leaves(states[DENSE_TWIN]))))
        del states
        t0 = time.perf_counter()
        if mesh.shape["data"] > 1:
            label, name, cfg, wire, topo = runs[0]
            out["planted"] = planted_fault(torch, mesh, name, cfg, wire, topo)
        t1 = time.perf_counter()
        if mesh.shape["client"] > 1:
            out["bytes"] = fan_in_bytes(torch, mesh)
        seconds["planted fault, bytes"] = (t1 - t0,
                                           time.perf_counter() - t1)
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def _fixed_batch(torch, cfg, R=1):
    """R minibatches of 64 from training_data as (R, J, 64, ...) and
    (R, 64) on the card."""
    views, labels = training_data(cfg, R * TRAIN_BATCH)
    v = torch.from_numpy(views).to(DEV)
    v = v.reshape((v.shape[0], R, TRAIN_BATCH) + v.shape[2:]).transpose(
        0, 1).contiguous()
    lab = torch.from_numpy(labels).to(DEV).long().reshape(R, TRAIN_BATCH)
    return v, lab


def fan_in_bytes(torch, mesh):
    """One INL round a wire at PaperExperimentConfig(link_bits=8): this
    rank's bytes on the 'client' axis' all_gather and reduce-scatter (the
    fan-in and its transpose), read from the tensors the collectives
    took."""
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import schemes
    from repro_torch.launch import sharding
    cfg = PaperExperimentConfig(link_bits=WIRE_BITS)
    cax = mesh.axis("client")
    v, lab = _fixed_batch(torch, cfg)
    scheme = schemes.get("inl")
    out = {}
    for wire in FAN_IN_BYTES:
        init = scheme.init(cfg, torch.Generator(device=DEV).manual_seed(3),
                           device=DEV)
        st = sharding.shard_state(
            init, scheme.state_shardings(cfg, init, mesh), mesh)
        round_fn = scheme.make_sharded_round(cfg, mesh, wire=wire)
        before = dict(cax.traffic)
        round_fn(st, v, lab, torch.Generator(device=DEV).manual_seed(4))
        torch.cuda.synchronize()
        out[wire] = tuple(cax.traffic[k] - before[k]
                          for k in ("all_gather", "reduce_scatter"))
    return out


def mesh_round_times(torch, mesh):
    """INL's round at PaperExperimentConfig(), batch 64, as make_epoch on
    `mesh` runs it (on NCCL one CUDA graph a round, on gloo eagerly) on
    one fixed batch: (wall ms a round, median of 3 epochs of
    SHARD_TIME_ROUNDS on the host's clock ending in a synchronize; ms a
    round between CUDA events around one more epoch on this rank's
    stream)."""
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import schemes
    from repro_torch.launch import sharding
    cfg = PaperExperimentConfig()
    scheme = schemes.get("inl")
    v, lab = _fixed_batch(torch, cfg)
    K = SHARD_TIME_ROUNDS
    ev, el = v[None].expand((K,) + v.shape), lab[None].expand((K,) + lab.shape)
    init = scheme.init(cfg, torch.Generator(device=DEV).manual_seed(6),
                       device=DEV)
    box = [sharding.shard_state(
        init, scheme.state_shardings(cfg, init, mesh), mesh)]
    gen = torch.Generator(device=DEV).manual_seed(7)
    epoch_fn = scheme.make_epoch(cfg, mesh=mesh)

    def epoch():
        box[0], _ = epoch_fn(box[0], ev, el, gen)
    wall = timed_host(torch, epoch, reps=3) / K
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    epoch()
    end.record()
    torch.cuda.synchronize()
    return wall, start.elapsed_time(end) / K, dict(epoch_fn.captures)


def sharded_rank(rank, world, store, layout, go, timed, queue):
    """A spawned rank of a gloo layout: the process group over the
    FileStore `store`, one intra-op thread; once `go` is set, `mesh_runs`
    into `queue`, then once `timed` is set, `mesh_round_times`, each as
    (rank, ok, results or traceback)."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)
    # fp32 convolutions and matmuls in fp32, as device_phase sets them in
    # the script's process (cuDNN's default is TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        # a rank left waiting in a collective fails within two minutes
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=120))
        torch.zeros(1, device=DEV)             # the card's context, now
        if not go.wait(timeout=3 * SHARD_TIMEOUT):
            raise TimeoutError(f"{layout}: never told to start")
        runs = shard_layouts()[layout][2]
        mesh = _host_mesh(runs[0][2].num_clients)
        queue.put((rank, True, mesh_runs(torch, mesh, runs,
                                         keep_states=False)))
        if not timed.wait(timeout=3 * SHARD_TIMEOUT):
            raise TimeoutError(f"{layout}: never told to time")
        queue.put((rank, True, mesh_round_times(torch, mesh)))
    except BaseException:                # reported to the parent, then raised
        queue.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class World:
    """The spawned ranks of a gloo layout on the one card.  They start at
    once, join their process group and wait for `go()`, so that their
    start-up overlaps the phase's earlier work.  `results()` returns their
    `mesh_runs` in rank order, at most SHARD_TIMEOUT seconds after `go()`;
    `timing()` then has them time the round and returns their times.
    Every rank is joined (killed past a deadline, once a rank failed, or
    by `close()`), and a failed or silent rank fails the phase."""

    def __init__(self, layout, ranks):
        import multiprocessing
        root = ROOT / "build" / "sharded"
        root.mkdir(parents=True, exist_ok=True)
        store = root / ("store_" + re.sub(r"\W", "_", layout))
        store.unlink(missing_ok=True)
        ctx = multiprocessing.get_context("spawn")
        self.layout, self.queue = layout, ctx.Queue()
        self.started, self.timed = ctx.Event(), ctx.Event()
        self.procs = [ctx.Process(target=sharded_rank, args=(
            r, ranks, str(store), layout, self.started, self.timed,
            self.queue)) for r in range(ranks)]
        for p in self.procs:
            p.start()
        self.deadline = None

    def go(self):
        self.deadline = time.monotonic() + SHARD_TIMEOUT
        self.started.set()

    def results(self):
        return self._collect()

    def timing(self):
        self.deadline = time.monotonic() + SHARD_TIMEOUT
        self.timed.set()
        times = self._collect()
        self.close(kill=False)
        check(all(p.exitcode == 0 for p in self.procs),
              f"sharded {self.layout}: rank exit codes "
              f"{[p.exitcode for p in self.procs]}")
        return times

    def _collect(self):
        import queue as queue_lib
        got, failed = {}, None
        # drain the queue before joining (a rank blocks on a full pipe)
        while len(got) < len(self.procs) and failed is None:
            try:
                rank, ok, value = self.queue.get(
                    timeout=max(self.deadline - time.monotonic(), 0.1))
            except queue_lib.Empty:
                failed = f"{len(self.procs) - len(got)} rank(s) gave no " \
                         f"result in {SHARD_TIMEOUT:.0f} s"
                break
            if ok:
                got[rank] = value
            else:
                failed = f"rank {rank} failed:\n{value}"
        if failed is not None:
            self.close()
        check(failed is None, f"sharded {self.layout}: {failed}")
        return [got[r] for r in range(len(self.procs))]

    def close(self, kill=True):
        for p in self.procs:
            if not kill:
                p.join(timeout=max(self.deadline - time.monotonic(), 5.0))
            if p.is_alive():
                p.kill()
            p.join(timeout=10)


def nccl_world(torch, runs):
    """The one-rank NCCL layout in this process: a process group of one
    rank on cuda:0 (address tcp://localhost, a free port), `mesh_runs` of
    `runs` and the round's times."""
    import socket

    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = _host_mesh(runs[0][2].num_clients)
        return [mesh_runs(torch, mesh, runs, keep_states=True)], \
            [mesh_round_times(torch, mesh)]
    finally:
        dist.destroy_process_group()


def nudged_run(torch, name, cfg, wire, topo):
    """The control of the free-running comparisons: the single-device run
    (run_scheme's first epoch at GRAPH_SEED, its rounds one by one) from
    the initial state with every fp32 entry moved one ulp up, deterministic
    algorithms on: how far a rounding-sized difference carries along this
    trajectory.  Returns its losses."""
    from repro_torch import tree_map
    from repro_torch.core import schemes
    scheme = schemes.get(name)
    ep_views, ep_labels, keys = epoch_inputs(torch, name, cfg, topo,
                                             *run_data(name, cfg))
    state = tree_map(lambda x: torch.nextafter(
        x, torch.full_like(x, float("inf"))) if x.is_floating_point()
        else x, scheme.init(cfg, torch.Generator(device=DEV).manual_seed(
            GRAPH_SEED), device=DEV))
    gen = torch.Generator(device=DEV).manual_seed(GRAPH_SEED + 1)
    round_fn = scheme.make_round(cfg, wire=wire, topology=topo)
    torch.use_deterministic_algorithms(True, warn_only=True)
    losses = []
    try:
        for k in range(GRAPH_ROUNDS):
            state, m = round_fn(state, ep_views[k], ep_labels[k], gen,
                                round_key=keys[k])
            losses.append(float(m["loss"]))
    finally:
        torch.use_deterministic_algorithms(False)
    return losses


def drift(losses, ref):
    """A free-running run's largest loss difference from the single-device
    run's over its rounds, in units of the first round's loss (a share of
    the loss at round k would read the late, near-zero losses of FL as
    large)."""
    return float(np.max(np.abs(np.array(losses) - np.array(ref)))
                 / abs(ref[0]))


def _nonzero(launches):
    return {k: n for k, n in launches.items() if n}


def replay_summary(per_rank, l_s, where):
    """Every rank's replayed rounds checked: the single-device rounds the
    graphs phase's bit for bit, the mesh's losses within SHARD_RTOL, the
    moments and model state and the parameters (the entries whose gradient
    rounds to nothing apart) within SHARD_STATE_RTOL.  Returns the worst
    readings over the ranks."""
    worst = {"loss": 0.0, "state": (0.0, None), "params": (0.0, None),
             "left_out": 0, "entries": 0, "left_g": (0.0, None),
             "left_share": 0.0, "bias_g": 0.0}
    for k, r in enumerate(per_rank):
        lm, ls, devs = zip(*r["replayed"])
        check(list(ls) == l_s, f"{where} rank {k}: the single-device "
                               f"rounds {ls} != the graphs phase's {l_s}")
        check(np.allclose(lm, ls, rtol=SHARD_RTOL, atol=0),
              f"{where} rank {k}: replayed rounds' losses {lm} vs "
              f"single-device {ls}")
        worst["loss"] = max(worst["loss"], float(np.max(
            np.abs(np.array(lm) - ls) / np.abs(ls))))
        for d in devs:
            for key in ("state", "params", "left_g"):
                worst[key] = max(worst[key], d[key], key=lambda x: x[0])
            for key in ("left_share", "bias_g"):
                worst[key] = max(worst[key], d[key])
            if k == 0:
                worst["left_out"] += d["left_out"]
                worst["entries"] += d["entries"]
    for key in ("state", "params"):
        check(worst[key][0] <= SHARD_STATE_RTOL,
              f"{where}: a replayed round's {key} deviates "
              f"{worst[key][0]:.3e} at {worst[key][1]}")
    return worst


def replay_text(w, rounds):
    left = "" if not w["entries"] else (
        f", {w['left_out']} of {w['entries']} parameter entry-rounds left "
        f"out"
        + (f" (their gradient at most {w['left_g'][0]:.2e} of its leaf's "
           f"RMS, {w['left_g'][1]}; at most {w['left_share']:.2e} of a "
           f"leaf's gradient norm)" if w["left_out"] else "")
        + f", the conv biases' gradient {w['bias_g']:.2e} of their "
        f"weights' (RMS)")
    return (f"each of {rounds} rounds replayed from the single-device "
            f"state on every rank: losses within rtol {w['loss']:.2e}, "
            f"moments and model state within {w['state'][0]:.2e} "
            f"({w['state'][1]}), parameters within {w['params'][0]:.2e} "
            f"({w['params'][1]}){left}")


def sharded_phase(torch, card_line, refs):
    """The sharded rounds (core/sharded.py) through run_scheme(mesh=) at
    PaperExperimentConfig(), batch 64, one epoch of 16 rounds a run, each
    rank's launch counts set to 0 just before a run and read just after:

      nccl 1x1      one NCCL rank in this process, INL, FL, SL and INL
                    packed (link_bits=8) under "scan" (one CUDA graph a
                    round, the collectives captured with it): losses,
                    final state, launches, both ledgers and the curve
                    equal to the graphs phase's single-device run bit for
                    bit, one capture per host signature;
      gloo data=2   two spawned ranks on the card (batch over 'data'):
                    INL, FL, SL and INL at erasure 0.3 an edge;
      gloo client=5 five spawned ranks (the J=5 nodes node-parallel):
                    INL, INL with learned priors, FL, INL packed and
                    packed_duplex (link_bits=8), the packed chain(5), and
                    the dense twin of INL packed;

    the gloo layouts eager (no capture, `captures` empty), their ranks
    started with the phase, the two worlds running together once the NCCL
    rank is done, then timing their round one after the other.  On a gloo
    layout each run's 16 rounds are
    replayed on the mesh from the state and generator state each
    single-device round started from (`replay_rounds`, `replay_summary`;
    FL on 'data' equals the single-device run bit for bit instead); the
    free-running losses of the runs that train (DRIFT_RUNS) stay within
    the drift limit (`drift`) that the control (`nudged_run`) and the
    planted fault (`planted_fault`, data=2) bracket; every rank's curve is
    the same, the ledgers the single-device run's, each rank launching the
    kernels the single-device run launched; at client=5 packed == dense
    bit for bit on every rank and the fan-in's bytes of one round, summed
    over the ranks, FAN_IN_BYTES.  Then INL's round time on each layout
    beside the single-device graphed round.  Returns {kernel: {run:
    launches on rank 0}}."""
    from repro_torch import tree_leaves
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import wirefmt

    t0 = time.perf_counter()
    layouts = shard_layouts()
    cfg8 = PaperExperimentConfig(link_bits=WIRE_BITS)
    worlds = {layout: World(layout, ranks)
              for layout, (ranks, backend, _) in layouts.items()
              if backend == "gloo"}
    results, times, took, controls = {}, {}, {}, {}
    try:
        # the NCCL rank here while the gloo ranks start up; then the gloo
        # worlds together and the controls here; then each world's round
        # timing alone on the card
        for layout, (_, backend, runs) in layouts.items():
            if backend == "nccl":
                results[layout], times[layout] = nccl_world(torch, runs)
                took[layout] = time.perf_counter() - t0
        t1 = time.perf_counter()
        for w in worlds.values():
            w.go()
        for label, name, cfg, wire, topo in (
                run for _, _, runs in layouts.values() for run in runs):
            if label in DRIFT_RUNS and label not in controls:
                controls[label] = nudged_run(torch, name, cfg, wire, topo)
        took["controls"] = time.perf_counter() - t1
        for layout, w in worlds.items():
            results[layout] = w.results()
            took[layout] = time.perf_counter() - t1
        for layout, w in worlds.items():
            times[layout] = w.timing()
        took["timing"] = time.perf_counter() - t1 - max(
            took[layout] for layout in worlds)
    finally:
        for w in worlds.values():
            w.close()
    print("sharded: seconds from the phase's start: " + ", ".join(
        f"{k} {v:.1f}" for k, v in took.items()) + " (the gloo worlds and "
        "the controls from the NCCL rank's end, together)")
    launches, drifts = {}, {}
    for layout, (world, backend, runs) in layouts.items():
        ranks = results[layout]
        for label, name, cfg, wire, topo in runs:
            per_rank = [r[label] for r in ranks]
            losses = [r["losses"] for r in per_rank]
            where = f"sharded {layout} {label}"
            if label == DENSE_TWIN:
                verdict = "the dense twin of 'inl packed'"
            elif backend == "nccl":
                c_s, l_s, s_s, n_s, g_s = refs[label]
                got = per_rank[0]
                check(got["losses"] == l_s, f"{where}: losses "
                      f"{got['losses']} != single-device {l_s}")
                check(all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(got["state"]), tree_leaves(s_s)))
                    and len(tree_leaves(got["state"]))
                    == len(tree_leaves(s_s)),
                    f"{where}: final state differs")
                check(got["launches"] == n_s and got["ledgers"] == g_s
                      and got["curve"] == c_s,
                      f"{where}: launches {got['launches']} / {n_s}, "
                      f"ledgers or curve differ")
                want_sigs = expected_signatures(name, cfg, wire, topo,
                                                GRAPH_ROUNDS)
                check(set(got["captures"]) == want_sigs
                      and all(v == 1 for v in got["captures"].values()),
                      f"{where}: captures {got['captures']}")
                verdict = "== single-device bit for bit (losses, " \
                          f"{len(tree_leaves(s_s))} state leaves, " \
                          f"launches, ledgers), captures " \
                          f"{got['captures']}"
            else:
                c_s, l_s, _, n_s, g_s = refs[label]
                for k, r in enumerate(per_rank):
                    check(r["curve"] == per_rank[0]["curve"],
                          f"{where} rank {k}: curve differs from rank "
                          f"0's")
                    check(r["ledgers"] == g_s, f"{where} rank {k}: "
                                               f"ledgers")
                    check(r["captures"] == {},
                          f"{where} rank {k}: gloo captured "
                          f"{r['captures']}")
                    check(set(_nonzero(r["launches"]))
                          == set(_nonzero(n_s)),
                          f"{where} rank {k}: launched "
                          f"{_nonzero(r['launches'])}, single-device "
                          f"{_nonzero(n_s)}")
                if replicated_run(name, ranks[0]["mesh"]):
                    check(all(x == l_s for x in losses),
                          f"{where}: losses {losses} != single-device "
                          f"{l_s}")
                    verdict = "== single-device losses bit for bit " \
                              "('data' replicates FL)"
                else:
                    verdict = replay_text(replay_summary(
                        per_rank, l_s, where), len(l_s))
                if label in DRIFT_RUNS:
                    drifts[(layout, label)] = (
                        drift(losses[0], l_s),
                        drift(controls[label], l_s))
                    verdict += (
                        f"; free-running: loss drift "
                        f"{drifts[(layout, label)][0]:.2e} of the first "
                        f"loss (control {drifts[(layout, label)][1]:.2e})"
                        f", accuracy {per_rank[0]['curve'][-1].accuracy:.4f}"
                        f" against {c_s[-1].accuracy:.4f}")
                verdict += ", ledgers equal, eager"
            for kname, n in _nonzero(per_rank[0]["launches"]).items():
                launches.setdefault(kname, {})[f"{layout} {label}"] = n
            print(f"sharded: {layout} ({world} rank(s), {backend}, mesh "
                  f"{ranks[0]['mesh']}) run_scheme('{name}', mesh=) "
                  f"{label} (wire={wire}, link_bits={cfg.link_bits}), "
                  f"{GRAPH_ROUNDS} rounds: {verdict}; loss "
                  f"{losses[0][0]:.4f} -> {losses[0][-1]:.4f}; launches "
                  f"by rank {[_nonzero(r['launches']) for r in per_rank]}"
                  f"; wall {max(r['wall'] for r in per_rank):.2f} s "
                  f"[{card_line}]")
        if "planted" in ranks[0]:
            planted = [r["planted"] for r in ranks]
            worst = max((d["state"] for p in planted
                         for _, _, d in p["replayed"]), key=lambda x: x[0])
            lm, ls, _ = zip(*planted[0]["replayed"])
            rel = np.abs(np.array(lm) - ls) / np.abs(ls)
            drifts[(layout, "planted")] = (
                drift(planted[0]["losses"], refs["inl"][1]), None)
            check(worst[0] > SHARD_STATE_RTOL,
                  f"sharded {layout}: the planted fault passes the "
                  f"replay check ({worst})")
            print(f"sharded: {layout}: planted fault (INL without the "
                  f"gradients' mean over 'data'): replayed rounds' "
                  f"losses within rtol {float(rel.max()):.2e}, moments "
                  f"and model state {worst[0]:.2e} ({worst[1]}); "
                  f"free-running loss drift "
                  f"{drifts[(layout, 'planted')][0]:.2e} of the first "
                  f"loss [{card_line}]")
        if layout == "gloo client=5":
            differ = [k for k, r in enumerate(ranks)
                      if not r["packed == dense"]]
            check(not differ,
                  f"sharded {layout}: packed != dense on ranks {differ}")
            total = {w: tuple(sum(r["bytes"][w][i] for r in ranks)
                              for i in range(2)) for w in FAN_IN_BYTES}
            closed = {w: wirefmt.round_wire_bytes(
                cfg8.num_clients * TRAIN_BATCH, cfg8.d_bottleneck,
                link_bits=WIRE_BITS, wire=w) for w in FAN_IN_BYTES}
            charged = closed["packed_duplex"]["total"]
            check(total == FAN_IN_BYTES and charged == DUPLEX_CHARGED
                  and all(total[w] == (closed[w]["fwd"], closed[w]["bwd"])
                          for w in ("dense", "packed")),
                  f"sharded {layout}: fan-in bytes {total}, duplex "
                  f"charged {charged}")
            print(f"sharded: {layout}: INL packed == dense (link_bits="
                  f"{WIRE_BITS}) bit for bit on every rank (losses and "
                  f"the rank's state slice); the fan-in's bytes of one "
                  f"round over the 5 ranks (gathered, reduce-scattered):"
                  f" " + ", ".join(f"{w} {g:,} + {s:,} = {g + s:,} B"
                                   for w, (g, s) in total.items())
                  + f"; packed_duplex charged {charged:,} B, its dense "
                  f"reduce-scatter executes [{card_line}]")
        print(f"sharded: {layout}: rank 0's seconds (run, replay): "
              + ", ".join(f"{k} " + " / ".join(f"{x:.1f}" for x in v)
                          for k, v in ranks[0]["seconds"].items()))
    check_drifts(drifts)
    single = graphed_round_timing(torch, card_line, "inl")
    print("sharded times: INL round at PaperExperimentConfig(), batch 64, "
          f"wall (host clock, median of 3 epochs of {SHARD_TIME_ROUNDS}) "
          "and stream (CUDA events around one epoch) ms a round: single "
          "device graphed "
          f"{single[0]:.3f} / {single[1]:.4f}; " + "; ".join(
              f"{layout} " + ", ".join(
                  f"rank {k} {w:.3f} / {d:.4f} (captures {c})"
                  for k, (w, d, c) in enumerate(rows))
              for layout, rows in times.items()) + f" [{card_line}]")
    print(f"sharded: phase took {time.perf_counter() - t0:.1f} s")
    return launches


def check_drifts(drifts):
    """The free-running runs' loss drifts against the limit: DRIFT_FACTOR
    times the largest drift of the controls, which must stay below the
    planted fault's."""
    controls = [c for _, c in drifts.values() if c is not None]
    limit = DRIFT_FACTOR * max(controls)
    fault = [d for (_, label), (d, c) in drifts.items() if c is None]
    worst = max(((d, key) for key, (d, c) in drifts.items()
                 if c is not None), key=lambda x: x[0])
    print(f"sharded: free-running loss drifts (of the first loss): "
          + ", ".join(f"{layout} {label} {d:.2e} (control {c:.2e})"
                      for (layout, label), (d, c) in drifts.items()
                      if c is not None)
          + f"; limit {DRIFT_FACTOR:g} x the largest control = {limit:.2e}"
          + f"; planted fault {', '.join(f'{d:.2e}' for d in fault)}")
    check(all(d > limit for d in fault),
          f"the drift limit {limit:.2e} does not catch the planted fault "
          f"{fault}")
    check(worst[0] <= limit, f"sharded {worst[1]}: free-running loss drift "
                             f"{worst[0]:.2e} > limit {limit:.2e}")


def graphed_round_timing(torch, card_line, name, *, cfg=None,
                         wire="dense", topology=None):
    """One round of scheme `name` at full width, batch 64 (`cfg`, `wire`
    and `topology` as run_scheme takes them), as the scan dispatch runs
    it: make_epoch's epoch of K rounds on one fixed batch, captured by a
    first call, then timed: wall per round on the host's clock around an
    epoch ending in a synchronize (median of 5 epochs), device time per
    round from CUDA events around 3 epochs (the replays run back to back,
    so this is the device's time with the launch gaps the graph leaves).
    Over unreliable links round k takes the fault key of round k of a run
    seeded 0.  Returns (wall ms, device ms)."""
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import linkfault as LF
    from repro_torch.core import schemes
    from repro_torch.core import topology as T

    cfg = cfg or PaperExperimentConfig()
    views, labels = training_data(cfg)
    scheme = schemes.get(name)
    state = scheme.init(cfg, torch.Generator(device=DEV).manual_seed(6),
                        device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(7)
    R = scheme.batches_per_round(cfg)
    K = GRAPH_TIME_ROUNDS.get(name, GRAPH_ROUNDS)
    v = torch.from_numpy(views[:, :R * TRAIN_BATCH]).to(DEV)
    v = v.reshape((v.shape[0], R, TRAIN_BATCH) + v.shape[2:]).transpose(
        0, 1).contiguous()
    lab = torch.from_numpy(labels[:R * TRAIN_BATCH]).to(DEV).long().reshape(
        R, TRAIN_BATCH)
    ev = v[None].expand((K,) + v.shape)
    el = lab[None].expand((K,) + lab.shape)
    epoch_fn = scheme.make_epoch(cfg, wire=wire, topology=topology)
    faulty = LF.active(T.resolve(topology, cfg), cfg, train=True)
    keys = [LF.round_key(0, g) for g in range(K)] if faulty else None
    box = [state]

    def epoch():
        box[0], _ = epoch_fn(box[0], ev, el, gen, round_keys=keys)
    wall = timed_host(torch, epoch, reps=5) / K
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        epoch()
    end.record()
    torch.cuda.synchronize()
    dev = start.elapsed_time(end) / (3 * K)
    plan, _ = scheme.make_round_parts(cfg, wire=wire, topology=topology)
    want = {plan(None if keys is None else keys[k], TRAIN_BATCH)[0]
            for k in range(K)}
    check(epoch_fn.captures == {sig: 1 for sig in want},
          f"{name}: captures {epoch_fn.captures}")
    return wall, dev


def graphed_predict_timing(torch, card_line, state):
    """Per bucket: the engine's predict (views copied from the host, then
    the bucket's graph) against the eager predict_batched on the same
    views copied the same way, both ending in a synchronize: wall (median
    of 25), and the device time of the predict without the copy (the
    profiler's busy time for eager, CUDA events around 20 back-to-back
    replays of the bucket's graph).  Returns {bucket: (eager wall, eager
    busy, graph wall, graph device)}."""
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import schemes
    from repro_torch.data import multiview
    from repro_torch.serving import ServingEngine

    cfg = PaperExperimentConfig()
    scheme = schemes.get("inl")
    imgs, _ = multiview.make_base_dataset(BUCKETS[-1], seed=cfg.seed + 4)
    views = multiview.make_views(imgs, cfg.noise_stds)
    engine = ServingEngine(scheme, state, cfg, buckets=BUCKETS, device=DEV)
    engine.warmup()
    out = {}
    for b in BUCKETS:
        pv = np.ascontiguousarray(views[:, :b])
        v_dev = torch.from_numpy(pv).to(DEV)

        def eager():
            scheme.predict_batched(state, torch.from_numpy(pv).to(DEV),
                                   cfg=cfg, device=DEV)

        def graphed():
            engine._predict(pv)            # the engine's bucketed predict
        e_wall = timed_host(torch, eager, reps=25)
        e_busy = device_ms(torch, lambda: scheme.predict_batched(
            state, v_dev, cfg=cfg, device=DEV), reps=10, warmup=2)
        g_wall = timed_host(torch, graphed, reps=25)
        # the bucket's graph itself (the engine's), replayed back to back
        g_dev = cuda_ms(torch, engine._graphs.get(b).replay, reps=20,
                        warmup=2)
        out[b] = (e_wall, e_busy, g_wall, g_dev)
        print(f"graphs times: predict bucket {b} (views from the host): "
              f"eager wall {e_wall:.3f} ms, busy {e_busy:.4f} ms, idle "
              f"{1 - e_busy / e_wall:.3f}; graph wall {g_wall:.3f} ms, "
              f"device {g_dev:.4f} ms, idle {1 - g_dev / g_wall:.3f} "
              f"[{card_line}]")
    check(engine.trace_counts == {b: 1 for b in BUCKETS},
          f"predict timing: trace_counts {engine.trace_counts}")
    return out


def graphs_timing(torch, card_line, eager_steps, state):
    """Graphed rounds of INL, SL, FL, SplitFed and hybrid beside the eager
    rounds of the same run (`eager_steps`: {name: (wall, busy)} from
    train_step_timing), then predict per bucket."""
    rows = {}
    for name in ("inl", "sl", "fl") + HYBRIDS:
        e_wall, e_busy = eager_steps[name]
        g_wall, g_dev = graphed_round_timing(torch, card_line, name)
        rows[name] = (e_wall, e_busy, g_wall, g_dev)
        print(f"graphs times: {name} round (PaperExperimentConfig, batch "
              f"{TRAIN_BATCH}{', ten local steps' if name == 'fl' else ''}):"
              f" eager wall {e_wall:.3f} ms, busy {e_busy:.4f} ms, idle "
              f"{1 - e_busy / e_wall:.3f}; scan (CUDA graph) wall "
              f"{g_wall:.3f} ms, device {g_dev:.4f} ms, idle "
              f"{1 - g_dev / g_wall:.3f}; {e_wall / g_wall:.2f}x "
              f"[{card_line}]")
    # what a graph resolves that separate eager loops could not: the
    # device time a variant adds to the same scheme's dense round
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import linkfault as LF
    from repro_torch.core import topology as T
    cfg = PaperExperimentConfig()
    wire_cfg = PaperExperimentConfig(link_bits=WIRE_BITS)
    lossy = LF.with_links(T.star(cfg.num_clients),
                          LF.LinkModel(erasure=GRAPH_ERASURE))
    base = {name: rows[name][3] for name in ("inl",) + HYBRIDS}
    base["inl packed"] = graphed_round_timing(torch, card_line, "inl",
                                              cfg=wire_cfg,
                                              wire="packed")[1]
    for label, name, c, wire, topo, ref in (
            ("inl chain(5) packed", "inl", wire_cfg, "packed",
             T.chain(cfg.num_clients), "inl packed"),
            ("inl lossy", "inl", cfg, "dense", lossy, "inl"),
            ("splitfed lossy", "splitfed", cfg, "dense", lossy, "splitfed"),
            ("hybrid lossy", "hybrid", cfg, "dense", lossy, "hybrid")):
        _, dev = graphed_round_timing(torch, card_line, name, cfg=c,
                                      wire=wire, topology=topo)
        rows[label] = (dev, base[ref])
        print(f"graphs times: {label} round device {dev:.4f} ms against "
              f"{ref}'s {base[ref]:.4f} ms in this run: "
              f"{dev - base[ref]:+.4f} ms (CUDA events, scan) "
              f"[{card_line}]")
    rows["predict"] = graphed_predict_timing(torch, card_line, state)
    return rows


# ---------------------------------------------------------------------------
# 6i. transport: the fault-tolerant transport, its serving front end, the
# worker cluster and the chaos drill
# ---------------------------------------------------------------------------

TRANSPORT_ROUNDS = 16               # one epoch of 16 rounds a run
TRANSPORT_SEED = 5
TRANSPORT_LINK = dict(erasure=0.1, latency_ms=5.0, jitter_ms=10.0)
TRANSPORT_DEADLINE_MS = 40.0        # the rounds' fusion deadline
SERVE_TRANSPORT_DEADLINE_MS = 20.0  # the engine's: about a third straggle
TRANSPORT_SERVE_BATCHES = 3         # batches per bucket
POISSON_REQUESTS = 128
POISSON_LOADS = (0.5, 2.0)          # x the serial capacity
CLUSTER_KILL = ("m1", 4, 3)         # node, tick, ticks: SIGKILL
CLUSTER_FREEZE = ("m3", 9, 3)       # SIGSTOP
CLUSTER_IO_TIMEOUT = 0.2            # seconds, the reference tests' value


def transport_cfg(**kw):
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    return PaperExperimentConfig(fusion_deadline_ms=TRANSPORT_DEADLINE_MS,
                                 **kw)


def transport_topology(cfg):
    """The lossy star every transport run rides: erasure 0.1, latency
    5 + Exp(10) ms an edge."""
    from repro_torch.core import linkfault as LF
    from repro_torch.core import topology as T
    return LF.with_links(T.star(cfg.num_clients),
                         LF.LinkModel(**TRANSPORT_LINK))


def transport_chaos():
    """m0's edge down for ticks 3-6, m2's flapping over ticks 6-13."""
    from repro_torch.chaos import ChaosSchedule
    return (ChaosSchedule().down_edge("m0->fuse", 3, 4)
            .flap_edge("m2->fuse", start=6, stop=14, period=2))


def make_transport(cfg, *, adaptive=False, channels="loopback", chaos=True,
                   seed=TRANSPORT_SEED):
    """A NetworkTransport over `transport_topology` with DEFAULT_RETRY and
    the default breakers (on the host: the fault draws are numpy)."""
    from repro_torch.transport import (DEFAULT_RETRY, AdaptivePolicy,
                                       NetworkTransport)
    return NetworkTransport(
        transport_topology(cfg), cfg, seed=seed, policy=DEFAULT_RETRY,
        chaos=transport_chaos() if chaos else None, channels=channels,
        adaptive=AdaptivePolicy() if adaptive else None)


def transport_runs():
    """(label, scheme, cfg, wire) of the transport phase's training runs:
    INL dense and packed, INL with learned priors on the packed wire,
    FL and SL, all at link_bits=8 where packed."""
    cfg = transport_cfg()
    return (("inl", "inl", cfg, "dense"),
            ("inl packed", "inl", transport_cfg(link_bits=WIRE_BITS),
             "packed"),
            ("inl+learned_prior packed", "inl",
             transport_cfg(link_bits=WIRE_BITS, learned_prior=True),
             "packed"),
            ("fl", "fl", cfg, "dense"), ("sl", "sl", cfg, "dense"))


def record_rounds(transport):
    """The charged `round_outcome` reports of `transport`, in tick order
    (a wrapper on the instance; uncharged replays are left out)."""
    reports = []
    outcome = transport.round_outcome

    def rec(*a, **kw):
        rep = outcome(*a, **kw)
        if kw.get("charge", True):
            reports.append(rep)
        return rep
    transport.round_outcome = rec
    return reports


def transport_run(torch, name, cfg, views, labels, *, wire, transport,
                  epochs=1, **run_kw):
    """run_scheme(name, transport=) under "scan" on the card, launch counts
    set to 0 just before and read just after, the epoch_fns' per-round
    losses and final state recorded by a wrapper around the scheme's
    make_transport_epoch.  Returns (curve, losses, final state, launches,
    captures, wall seconds)."""
    from repro_torch.core import schemes
    from repro_torch.core.schemes import runner

    scheme = schemes.get(name)
    made, losses, finals = [], [], []
    make = scheme.make_transport_epoch

    def recording(*a, **kw):
        fn = make(*a, **kw)
        made.append(fn)

        def rec(*ra, **rkw):
            st, m = fn(*ra, **rkw)
            losses.extend(m["loss"].unbind(0))
            finals.append(st)
            return st, m
        return rec
    scheme.make_transport_epoch = recording
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        curve = runner.run_scheme(
            name, views, labels, cfg, epochs=epochs, batch_size=TRAIN_BATCH,
            eval_n=512, wire=wire, seed=TRANSPORT_SEED, transport=transport,
            device=DEV, **run_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        del scheme.make_transport_epoch
    loss = [float(x) for x in losses]
    check(all(np.isfinite(loss)), f"transport {name}: non-finite loss")
    return (curve, loss, finals[-1] if finals else None, launches,
            dict(made[0].captures) if made else {}, wall)


def transport_replay(torch, name, cfg, views, labels, wire, masks):
    """The run's rounds replayed eagerly: make_transport_round once a round
    on `masks`, from run_scheme's seeds and minibatches.  Returns (final
    state, losses)."""
    from repro_torch.core import schemes
    from repro_torch.core.schemes import runner

    scheme = schemes.get(name)
    round_fn = scheme.make_transport_round(cfg, wire=wire)
    state = scheme.init(
        cfg, torch.Generator(device=DEV).manual_seed(TRANSPORT_SEED),
        device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(TRANSPORT_SEED + 1)
    tv = torch.as_tensor(views, dtype=torch.float32, device=DEV)
    tl = torch.as_tensor(labels, device=DEV).long()
    bpr = scheme.batches_per_round(cfg)
    ev, el = runner.epoch_batches(tv, tl, 0, len(masks), bpr, TRAIN_BATCH)
    losses = []
    for r, mask in enumerate(masks):
        state, m = round_fn(state, ev[r], el[r], gen, mask)
        losses.append(float(m["loss"]))
    return state, losses


def round_charges(name, cfg, wire, edges):
    """One round's {edge: (bits, bytes)} as run_scheme(transport=) charges
    them: INL's per-edge ledger, FL's and SL's totals split equally."""
    from repro_torch.core import schemes
    from repro_torch.core.schemes import runner
    scheme = schemes.get(name)
    state = scheme.init(cfg, 0, device=DEV)
    charges = runner._round_charges(scheme, cfg, state, TRAIN_BATCH,
                                    wire=wire, topology=None)
    if set(charges) == {None}:
        b, nb = charges[None]
        charges = {e.key: (b / len(edges), nb / len(edges)) for e in edges}
    return charges


def expected_round_ledgers(topo, charges, reports):
    """Offered bits per edge = attempts x the edge's charge, delivered =
    the surviving payload fraction x the charge, summed in the meter's
    order."""
    offered, delivered = {}, {}
    for rep in reports:
        for e in topo.edges:
            bits = charges[e.key][0]
            offered[e.key] = offered.get(e.key, 0.0) + float(
                rep.attempts[e.key] * bits)
            pay = list(topo.payload(e))
            frac = float(rep.mask[pay].sum()) / len(pay)
            if frac:
                delivered[e.key] = delivered.get(e.key, 0.0) + float(
                    bits * frac)
    return offered, delivered


def transport_training_phase(torch, card_line):
    """Each run of `transport_runs` for one epoch of 16 rounds through
    run_scheme(transport=) on the lossy star with DEFAULT_RETRY, the
    default breakers and `transport_chaos`, deterministic algorithms on:
    the per-round losses and every state leaf bit for bit against the
    eager make_transport_round replay of the run's own masks, the masks
    those of a second transport built from the same seed, one capture
    per host signature, and the offered and delivered bits per edge equal
    to attempts x charge and surviving fraction x charge.  Returns
    ({label: launches}, the trained INL state)."""
    from repro_torch import tree_leaves
    from repro_torch.core import schemes

    out, trained, data = {}, None, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for label, name, cfg, wire in transport_runs():
            scheme = schemes.get(name)
            n = TRANSPORT_ROUNDS * scheme.batches_per_round(cfg) * TRAIN_BATCH
            if n not in data:
                data[n] = training_data(cfg, n)
            views, labels = data[n]
            tr = make_transport(cfg)
            reports = record_rounds(tr)
            curve, losses, state, launches, caps, wall = transport_run(
                torch, name, cfg, views, labels, wire=wire, transport=tr)
            snap = tr.snapshot()
            meter = tr.meter
            tr.close()
            check(len(reports) == len(losses) == TRANSPORT_ROUNDS,
                  f"transport {label}: {len(reports)} reports, "
                  f"{len(losses)} rounds")
            masks = [rep.mask for rep in reports]
            twin = make_transport(cfg)
            charges = round_charges(name, cfg, wire, twin.topo.edges)
            twin_masks = [twin.round_outcome(t, TRAIN_BATCH,
                                             charges=charges,
                                             charge=False).mask
                          for t in range(TRANSPORT_ROUNDS)]
            twin.close()
            check(all(np.array_equal(a, b) for a, b in zip(masks,
                                                           twin_masks)),
                  f"transport {label}: the run's masks differ from a "
                  f"second transport's of the same seed")
            stacked = np.stack(masks)
            check(stacked.any() and not stacked.all(),
                  f"transport {label}: the masks {stacked.astype(int)} "
                  f"lost nothing or everything")
            r_state, r_losses = transport_replay(torch, name, cfg, views,
                                                 labels, wire, masks)
            check(losses == r_losses,
                  f"transport {label}: graphed losses {losses} != eager "
                  f"replay {r_losses}")
            leaves, r_leaves = tree_leaves(state), tree_leaves(r_state)
            check(len(leaves) == len(r_leaves) and all(
                torch.equal(a, b) for a, b in zip(leaves, r_leaves)),
                f"transport {label}: the final state differs from the "
                f"eager replay's")
            plan, _ = scheme.make_transport_round_parts(cfg, wire=wire)
            want = {plan(m, TRAIN_BATCH)[0] for m in masks}
            check(caps == {sig: 1 for sig in want},
                  f"transport {label}: captures {caps}, signatures {want}")
            off, dlv = expected_round_ledgers(tr.topo, charges, reports)
            check(meter.edge_bits == off,
                  f"transport {label}: offered per edge {meter.edge_bits} "
                  f"!= attempts x charge {off}")
            check(meter.edge_delivered_bits == dlv,
                  f"transport {label}: delivered per edge "
                  f"{meter.edge_delivered_bits} != surviving x charge {dlv}")
            check(curve[-1].gbits == meter.gbits
                  and curve[-1].delivered_gbits == meter.delivered_gbits,
                  f"transport {label}: the curve does not read the "
                  f"transport's meter")
            out[label] = {k: v for k, v in launches.items() if v}
            if label == "inl":
                trained = state
            attempts = sum(sum(r.attempts.values()) for r in reports)
            opens = {k: b["opens"] for k, b in snap["breaker"].items()
                     if b["opens"]}
            print(f"transport: run_scheme('{name}', transport=) {label} "
                  f"(wire={wire}, link_bits={cfg.link_bits}), "
                  f"{TRANSPORT_ROUNDS} rounds on the lossy star: == the "
                  f"eager make_transport_round replay bit for bit (losses, "
                  f"{len(leaves)} state leaves), masks == a second "
                  f"transport's ({int(stacked.sum())} of {stacked.size} "
                  f"votes fused), captures {caps}, per-edge offered == "
                  f"attempts x charge ({attempts} attempts) and delivered "
                  f"== surviving x charge (delivery ratio "
                  f"{meter.delivery_ratio:.5f}), breaker opens {opens}, "
                  f"launches {out[label]}; loss {losses[0]:.4f} -> "
                  f"{losses[-1]:.4f}, accuracy {curve[-1].accuracy:.4f}; "
                  f"wall {wall:.2f} s [{card_line}]")
    finally:
        torch.use_deterministic_algorithms(False)
    return out, trained


def transport_resume_check(torch, card_line):
    """INL over the lossy star with an adaptive controller: 2 epochs with
    ckpt_dir against 1 epoch with ckpt_dir and then resume=True: the
    curves, both final checkpoints (leaves and sidecars, the transport's
    snapshot in them) and the transports' snapshots (ledgers, breaker
    states, opens, short-circuits, the adaptive state) equal.  Returns
    the resumed run's launches."""
    import shutil
    from repro_torch import checkpoint

    cfg = transport_cfg()
    views, labels = training_data(cfg, TRANSPORT_ROUNDS * TRAIN_BATCH)
    root = ROOT / "build" / "transport_resume"
    shutil.rmtree(root, ignore_errors=True)
    full, part = str(root / "full"), str(root / "part")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = []
        for epochs, d, resume in ((2, full, False), (1, part, False),
                                  (2, part, True)):
            tr = make_transport(cfg, adaptive=True)
            curve, _, _, launches, _, wall = transport_run(
                torch, "inl", cfg, views, labels, wire="dense",
                transport=tr, epochs=epochs, ckpt_dir=d, resume=resume)
            runs.append((curve, tr.snapshot(), launches, wall))
            tr.close()
        (c_g, s_g, _, w_g), (c_h, _, _, _), (c_r, s_r, n_r, w_r) = runs
        check(c_h == c_g[:1] and c_r == c_g,
              f"transport resume: resumed curve {c_r} != {c_g}")
        leaves = same_checkpoints(checkpoint, full, part, 2)
        check(s_r == s_g, f"transport resume: snapshot {s_r} != {s_g}")
        check(checkpoint.load_meta(part, 2)["transport"] == s_g,
              "transport resume: the sidecar's snapshot differs")
        check(s_g["adaptive"]["retunes"] > 0
              and any(b["opens"] for b in s_g["breaker"].values()),
              f"transport resume: no retune or breaker trip to replay: "
              f"{s_g}")
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    states = {k: (b["state"], b["opens"], b["short_circuits"])
              for k, b in s_g["breaker"].items()}
    print(f"transport: resume, INL with an adaptive controller, 2 epochs of "
          f"{TRANSPORT_ROUNDS} rounds == 1 + resume=True bit for bit (curve, "
          f"{leaves} checkpoint leaves and sidecars), snapshots equal "
          f"(breakers (state, opens, short-circuits) {states}, "
          f"{s_g['adaptive']['retunes']} retunes); wall {w_g:.2f} s "
          f"uninterrupted, {w_r:.2f} s resumed [{card_line}]")
    return {k: v for k, v in n_r.items() if v}


def serving_views(cfg, n, seed):
    from repro_torch.data import multiview
    imgs, _ = multiview.make_base_dataset(n, seed=seed)
    return multiview.make_views(imgs, cfg.noise_stds)


def transport_engine(scheme, state, cfg, *, buckets=BUCKETS, seed):
    """A ServingEngine at full width over socket channels (DEFAULT_RETRY,
    the default breakers, no chaos), speculative, with the engine's
    deadline.  Returns (engine, transport)."""
    from repro_torch.serving import ServingEngine
    tr = make_transport(cfg, channels="socket", chaos=False, seed=seed)
    engine = ServingEngine(scheme, state, cfg, topology=tr.topo,
                           transport=tr, speculative=True,
                           deadline_ms=SERVE_TRANSPORT_DEADLINE_MS,
                           buckets=buckets, seed=seed, device=DEV)
    return engine, tr


def transport_serving_check(torch, card_line, state):
    """The trained INL state served over socket channels, speculative, a
    20 ms deadline, buckets (1, 4, 16, 64), three batches a bucket after
    warmup(): each launch's rows == predict_batched under the launch's
    masks bit for bit, patched > 0, views_recovered == the reports'
    straggler count, the credited ledger == the consumed masks x the unit
    charges, one capture per bucket, one cut_fwd per engine launch.  Then
    run_poisson at 0.5x and 2x of measure_serial_capacity.  Returns (the
    launches, {load: summary}, the serial capacity)."""
    from repro_torch.core import schemes
    from repro_torch.serving import measure_serial_capacity, run_poisson

    cfg = transport_cfg()
    scheme = schemes.get("inl")
    n = TRANSPORT_SERVE_BATCHES * sum(BUCKETS)
    views = serving_views(cfg, n, cfg.seed + 4)
    engine, tr = transport_engine(scheme, state, cfg, seed=23)
    try:
        engine.warmup()
        sent, consumed, launched = [], [], []
        send, credit, predict = (tr.send_request, tr.credit_delivered,
                                 engine._predict)

        def rec_send(*a, **kw):
            rep = send(*a, **kw)
            sent.append(rep)
            return rep

        def rec_credit(mask):
            consumed.append(np.array(mask, bool))
            return credit(mask)

        def rec_predict(v, d):
            probs = predict(v, d)
            launched.append((v, np.array(d, bool), probs.cpu().numpy()))
            return probs
        tr.send_request, tr.credit_delivered = rec_send, rec_credit
        engine._predict = rec_predict
        torch.cuda.synchronize()
        reset_launches()
        at = 0
        for b in BUCKETS:
            for _ in range(TRANSPORT_SERVE_BATCHES):
                probs, served = engine.serve(views[:, at:at + b])
                check(probs.shape == (b, cfg.num_classes)
                      and np.all(np.isfinite(probs)),
                      f"transport serving: bad rows for a block of {b}")
                at += b
        torch.cuda.synchronize()
        got = read_launches()
        for v, d, probs in launched:
            want = scheme.predict_batched(state, v, delivery=d, cfg=cfg,
                                          device=DEV).cpu().numpy()
            check(np.array_equal(probs, want),
                  f"transport serving: a bucket of {v.shape[1]} differs "
                  f"from predict_batched under its masks: max "
                  f"{np.abs(probs - want).max()}")
        st = engine.stats
        stragglers = int(sum(int(r.stragglers.sum()) for r in sent))
        check(st.patched > 0 and st.views_recovered == stragglers,
              f"transport serving: patched {st.patched}, views_recovered "
              f"{st.views_recovered}, the reports' stragglers {stragglers}")
        unit = {e.key: float(cfg.d_bottleneck * cfg.link_bits)
                for e in tr.topo.edges}
        want_dlv = {}
        for m in consumed:
            for e in tr.topo.edges:
                k = int(m[list(tr.topo.payload(e))].sum())
                if k:
                    want_dlv[e.key] = want_dlv.get(e.key, 0.0) + float(
                        k * unit[e.key])
        check(tr.meter.edge_delivered_bits == want_dlv
              and len(consumed) == n,
              f"transport serving: credited {tr.meter.edge_delivered_bits}"
              f" != the consumed masks' {want_dlv}")
        check(engine.trace_counts == {b: 1 for b in BUCKETS},
              f"transport serving: trace_counts {engine.trace_counts}")
        check(got["cut_fwd"] == st.launches,
              f"transport serving: cut_fwd {got['cut_fwd']} in "
              f"{st.launches} engine launches")
        launches = {k: v for k, v in got.items() if v}
        print(f"transport: served the trained INL state over socket "
              f"channels, speculative, deadline "
              f"{SERVE_TRANSPORT_DEADLINE_MS:g} ms, buckets {BUCKETS} x "
              f"{TRANSPORT_SERVE_BATCHES}: {n} requests in {st.launches} "
              f"launches, each launch == predict_batched under its masks "
              f"bit for bit, patched {st.patched}, views_recovered "
              f"{st.views_recovered} == the reports' stragglers, credited "
              f"ledger == the consumed masks (delivery ratio "
              f"{tr.meter.delivery_ratio:.5f}), trace_counts "
              f"{engine.trace_counts}, cut_fwd {got['cut_fwd']} "
              f"[{card_line}]")
    finally:
        tr.close()

    pool = serving_views(cfg, POISSON_REQUESTS, cfg.seed + 5)
    serial, s_tr = transport_engine(scheme, state, cfg, buckets=(1,),
                                    seed=29)
    try:
        serial.warmup()
        with serial:
            cap = measure_serial_capacity(serial, pool, num_requests=32)
    finally:
        s_tr.close()
    sweep = {}
    loaded, l_tr = transport_engine(scheme, state, cfg, seed=31)
    try:
        loaded.warmup()
        with loaded:
            for mult in POISSON_LOADS:
                s = run_poisson(loaded, pool, rate_rps=cap * mult,
                                num_requests=POISSON_REQUESTS,
                                seed=int(mult * 10))
                check(s["served"] == POISSON_REQUESTS
                      and np.isfinite(s["p99_ms"]) and s["p99_ms"] > 0,
                      f"transport serving: run_poisson at {mult}x: {s}")
                sweep[mult] = s
        check(loaded.trace_counts == {b: 1 for b in BUCKETS},
              f"transport serving: loaded trace_counts "
              f"{loaded.trace_counts}")
    finally:
        l_tr.close()
    print("transport: run_poisson over socket channels, speculative: "
          f"serial capacity {cap:.1f} req/s; " + "; ".join(
              f"{m}x offered {s['offered_rps']:.1f} req/s goodput "
              f"{s['goodput_rps']:.1f}, p50 {s['p50_ms']:.3f} ms, p99 "
              f"{s['p99_ms']:.3f} ms, patched views fused "
              f"{s['mean_views_fused']:.2f}" for m, s in sweep.items())
          + f" [{card_line}]")
    return launches, sweep, cap


def cluster_check(torch, card_line):
    """A Cluster of real worker processes over PaperExperimentConfig()'s
    five measure nodes (NO_RETRY, no breaker), m1 SIGKILLed and m3
    SIGSTOPped on a schedule, under 16 INL rounds of
    run_scheme(transport=cluster.transport) on the card: the masks are
    exactly the scheduled windows, one respawn (m1's incarnation 2, m3's
    1), and every worker stopped afterwards.  Then chaos.cluster_drill at
    its own config: its assertions hold and it replays identically.
    Returns the run's launches."""
    import argparse
    from repro_torch import chaos
    from repro_torch.cluster import Cluster
    from repro_torch.transport import NO_RETRY

    cfg = transport_cfg()
    views, labels = training_data(cfg, TRANSPORT_ROUNDS * TRAIN_BATCH)
    sched = (chaos.ChaosSchedule()
             .kill_node(CLUSTER_KILL[0], at=CLUSTER_KILL[1],
                        duration=CLUSTER_KILL[2])
             .freeze_node(CLUSTER_FREEZE[0], at=CLUSTER_FREEZE[1],
                          duration=CLUSTER_FREEZE[2]))
    cl = Cluster(cfg, seed=TRANSPORT_SEED, chaos=sched, policy=NO_RETRY,
                 breaker=None, io_timeout=CLUSTER_IO_TIMEOUT)
    with cl:
        pids = {n: h.proc.pid for n, h in cl.supervisor.handles.items()}
        reports = record_rounds(cl.transport)
        curve, losses, _, launches, caps, wall = transport_run(
            torch, "inl", cfg, views, labels, wire="dense",
            transport=cl.transport)
        names = cl.topo.view_nodes()
        respawns = cl.supervisor.respawns
        incarnations = dict(cl.supervisor.membership().incarnations)
        events = cl.supervisor.events()
        handles = list(cl.supervisor.handles.values())
    check(all(h.proc is None for h in handles),
          "cluster: a worker process outlived the Cluster")
    check(len(set(pids.values())) == len(names),
          f"cluster: worker pids {pids}")
    for t, rep in enumerate(reports):
        want = [not any(n == node and at <= t < at + dur
                        for node, at, dur in (CLUSTER_KILL, CLUSTER_FREEZE))
                for n in names]
        check(rep.mask.tolist() == want,
              f"cluster: tick {t} mask {rep.mask.tolist()}, scheduled "
              f"{want}")
    check(len(reports) == TRANSPORT_ROUNDS,
          f"cluster: {len(reports)} rounds")
    check(respawns == 1 and incarnations[CLUSTER_KILL[0]] == 2
          and incarnations[CLUSTER_FREEZE[0]] == 1,
          f"cluster: respawns {respawns}, incarnations {incarnations}")
    frozen = [e[2] for e in events if e[1] == CLUSTER_FREEZE[0]]
    check("suspect->down" in frozen and frozen[-1] == "down->up",
          f"cluster: {CLUSTER_FREEZE[0]}'s transitions {frozen}")
    launches = {k: v for k, v in launches.items() if v}
    check(launches.get("cut_bwd") == TRANSPORT_ROUNDS,
          f"cluster: launches {launches}")
    print(f"transport: Cluster of {len(names)} worker processes, "
          f"{CLUSTER_KILL[0]} SIGKILLed at tick {CLUSTER_KILL[1]} for "
          f"{CLUSTER_KILL[2]}, {CLUSTER_FREEZE[0]} SIGSTOPped at tick "
          f"{CLUSTER_FREEZE[1]} for {CLUSTER_FREEZE[2]}: "
          f"{TRANSPORT_ROUNDS} INL rounds of run_scheme(transport="
          f"cluster.transport) on the card, masks == the scheduled windows, "
          f"respawns {respawns}, incarnations {incarnations}, "
          f"{CLUSTER_FREEZE[0]} {' '.join(frozen)}, captures {caps}, "
          f"launches {launches}; loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"wall {wall:.2f} s [{card_line}]")
    t0 = time.perf_counter()
    record = chaos.cluster_drill(argparse.Namespace(seed=0))
    check(record["replay_identical"] and record["respawns"] == 1,
          f"cluster drill: {record}")
    print(f"transport: chaos.cluster_drill ({len(record['nodes'])} "
          f"processes, {record['ticks']} ticks, kill {record['kill']}, "
          f"freeze {record['freeze']}): assertions hold, replayed "
          f"identically, incarnations {record['incarnations']} "
          f"({time.perf_counter() - t0:.1f} s) [{card_line}]")
    return launches


def transport_timing(torch, card_line, serve_sweep, capacity):
    """A transport round's wall time at full width, batch 64 (each round's
    round_outcome on the host, then the graphed round on its mask; median
    of 5 epochs of 16 rounds, host clock ending in a synchronize) against
    the graphed lossy round's (the same link models as linkfault draws on
    the same cfg), round_outcome alone (median of 200 calls), and the
    served p50 and p99 at each offered load.  Returns the wall ms."""
    from repro_torch.core import schemes

    cfg = transport_cfg()
    scheme = schemes.get("inl")
    views, labels = training_data(cfg, TRAIN_BATCH)
    state = scheme.init(cfg, torch.Generator(device=DEV).manual_seed(6),
                        device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(7)
    v = torch.from_numpy(views).to(DEV)[None, None]   # (1, 1, J, B, ...)
    lab = torch.from_numpy(labels).to(DEV).long()[None, None]
    K = TRANSPORT_ROUNDS
    ev = v.expand((K,) + v.shape[1:])
    el = lab.expand((K,) + lab.shape[1:])
    epoch_fn = scheme.make_transport_epoch(cfg)
    tr = make_transport(cfg)
    box, tick = [state], [0]

    def epoch():
        masks = [tr.round_outcome(tick[0] + k, TRAIN_BATCH).mask
                 for k in range(K)]
        tick[0] += K
        box[0], _ = epoch_fn(box[0], ev, el, gen, masks)
    wall = timed_host(torch, epoch, reps=5) / K
    host = []
    for _ in range(200):
        t0 = time.perf_counter()
        tr.round_outcome(tick[0], TRAIN_BATCH)
        host.append((time.perf_counter() - t0) * 1e3)
        tick[0] += 1
    tr.close()
    outcome_ms = statistics.median(host)
    lossy_wall, lossy_dev = graphed_round_timing(
        torch, card_line, "inl", cfg=cfg, topology=transport_topology(cfg))
    print(f"transport times: INL round at PaperExperimentConfig(), batch "
          f"{TRAIN_BATCH}, over the transport (round_outcome on the host "
          f"for a star of 5 edges, then the graphed round on its mask) "
          f"{wall:.3f} ms wall against the graphed lossy round's "
          f"{lossy_wall:.3f} ms (device {lossy_dev:.4f} ms; the same links "
          f"as in-graph draws): {wall - lossy_wall:+.3f} ms; round_outcome "
          f"alone {outcome_ms:.4f} ms (median of 200); served over socket "
          f"channels, speculative, serial capacity {capacity:.1f} req/s: "
          + ", ".join(f"{m}x p50 {s['p50_ms']:.3f} ms p99 "
                      f"{s['p99_ms']:.3f} ms" for m, s in serve_sweep.items())
          + f" [{card_line}]")
    return wall, lossy_wall, outcome_ms


def transport_phase(torch, card_line):
    """The transport slice on the card (`transport:` lines).  Returns
    ({kernel: {run: launches}} over the phase's runs, the times)."""
    t0 = time.perf_counter()
    runs, trained = transport_training_phase(torch, card_line)
    runs["resume"] = transport_resume_check(torch, card_line)
    served, sweep, cap = transport_serving_check(torch, card_line, trained)
    runs["served (socket, speculative)"] = served
    runs["cluster"] = cluster_check(torch, card_line)
    times = transport_timing(torch, card_line, sweep, cap)
    on_transport = {k: {run: n[k] for run, n in runs.items() if n.get(k)}
                    for k in CUT_LAYER_SOURCES}
    print(f"transport: phase took {time.perf_counter() - t0:.1f} s")
    return on_transport, times


# ---------------------------------------------------------------------------
# 7. times
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, reps=200, warmup=20):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps):
    """Device ms per call of `fn`: `reps` calls captured in one CUDA graph,
    its replay timed with CUDA events, so the host's launch work is not
    counted however slow it is.  (The profiler's trace dropped most of the
    launches of millisecond kernels in one run on the H100, so the LLM
    kernels are timed this way.)"""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def device_profile(torch, fn, reps=100, warmup=10):
    """(device ms per call, [(kernel name, device ms per call), ...] by
    descending time): the device time of every kernel and copy `fn` runs,
    from torch.profiler's CUDA trace, over `reps` calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # the CUDA trace now and then comes back empty (seen once in 14 runs on
    # the H100); a window is traced again, at most PROFILE_TRIES times
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = sorted(((e.key, e.self_device_time_total / reps / 1e3)
                          for e in prof.key_averages()
                          if e.self_device_time_total > 0),
                         key=lambda kv: -kv[1])
        total = sum(ms for _, ms in by_name)
        if total > 0:
            return total, by_name
    raise CheckFailed(f"the profiler recorded no device time in "
                      f"{PROFILE_TRIES} traces")


def device_ms(torch, fn, reps=100, warmup=10):
    """Device time per call (see device_profile)."""
    return device_profile(torch, fn, reps, warmup)[0]


def timing_phase(torch, scheme, state, views, card_line):
    from repro_torch.kernels import inl_bottleneck, ref
    for b in BUCKETS:
        v = torch.from_numpy(views[:, :b]).to(DEV)

        def predict():
            scheme.predict(state, v, device=DEV)
        times = []
        for i in range(30):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predict()
            torch.cuda.synchronize()
            if i >= 5:
                times.append((time.perf_counter() - t0) * 1e3)
        wall = statistics.median(times)
        busy = device_ms(torch, predict, reps=10, warmup=2)
        print(f"predict latency bucket {b}: median {wall:.3f} ms over "
              f"{len(times)} runs; device busy {busy:.4f} ms of it, idle "
              f"share {1 - busy / wall:.3f} [{card_line}]")

    rows = {}
    # R=320: the serving call (bucket 64 x J=5); R=20480: 21 MB, which the
    # 50 MB L2 holds across back-to-back launches; R=262144: 268 MB, which
    # it cannot, so that row runs at device-memory rate
    for R, mode, bits in ((320, "none", 32), (20480, "none", 32),
                          (20480, "sample", 8), (262144, "none", 32),
                          (262144, "sample", 8)):
        d = 64
        mu, lv, eps = cut_inputs(torch, (R, d), torch.float32, 0)
        def kernel():
            inl_bottleneck.cut_fwd(mu, lv, eps, bits=bits, mode=mode)

        def plain():
            ref.cutlayer_fwd_ref(mu, lv, eps, bits, mode)
        k_dev, p_dev = device_ms(torch, kernel), device_ms(torch, plain)
        k_call, p_call = cuda_ms(torch, kernel), cuda_ms(torch, plain)
        nbytes = R * d * (4 + 4 + 4 + 4) + 4 * R
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows[(R, mode, bits)] = (k_dev, p_dev, bound)
        print(f"cut_fwd R={R} d={d} {mode} b={bits} fp32: device time "
              f"kernel {k_dev:.5f} ms, plain {p_dev:.5f} ms, bound "
              f"{bound:.5f} ms (bytes {nbytes}, {bound / k_dev:.3f} of the "
              f"bound); per call with the host's launch work kernel "
              f"{k_call:.5f} ms, plain {p_call:.5f} ms [{card_line}]")
    return rows


def train_step_timing(torch, card_line, *, wire="dense", link_bits=32,
                      topology=None, cfg=None, label=None, name="inl"):
    """Train-step latency of scheme `name` (one round: for FL, ten local
    steps) at full width and batch 64 on `wire` (on the star, or on
    `topology` at `cfg`): the median of 20 rounds on the host's clock, and
    the device's busy time per round from the profiler, with its breakdown
    by kernel.  Over unreliable links each step takes the next round's
    fault key, as run_scheme hands them out."""
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import linkfault, schemes
    from repro_torch.core import topology as T

    cfg = cfg or PaperExperimentConfig(link_bits=link_bits)
    label = label or wire
    views, labels = training_data(cfg)
    scheme = schemes.get(name)
    state = scheme.init(cfg, torch.Generator(device=DEV).manual_seed(6),
                        device=DEV)
    round_fn = scheme.make_round(cfg, wire=wire, topology=topology)
    gen = torch.Generator(device=DEV).manual_seed(7)
    # (R, J, B, ...) views and (R, B) labels, R the round's minibatches
    R = scheme.batches_per_round(cfg)
    v = torch.from_numpy(views[:, :R * TRAIN_BATCH]).to(DEV)
    v = v.reshape((v.shape[0], R, TRAIN_BATCH) + v.shape[2:]).transpose(
        0, 1).contiguous()
    lab = torch.from_numpy(labels[:R * TRAIN_BATCH]).to(DEV).long().reshape(
        R, TRAIN_BATCH)
    box = [state]
    faulty = linkfault.active(T.resolve(topology, cfg), cfg, train=True)
    count = [0]

    def step():
        kw = {}
        if faulty:
            kw["round_key"] = linkfault.round_key(0, count[0])
            count[0] += 1
        box[0], _ = round_fn(box[0], v, lab, gen, **kw)
    times = []
    for i in range(25):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        if i >= 5:
            times.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(times)
    busy, by_name = device_profile(torch, step, reps=10, warmup=2)
    print(f"train step latency ({label}, link_bits={cfg.link_bits}): "
          f"median {wall:.3f} ms over {len(times)} steps "
          f"(PaperExperimentConfig, batch {TRAIN_BATCH}); device busy "
          f"{busy:.4f} ms of it, idle share {1 - busy / wall:.3f} "
          f"[{card_line}]")
    kinds = {}
    for name, ms in by_name:
        low = name.lower()
        kind = ("cut-layer kernels" if "cut_" in low else
                "convolution" if "conv" in low or "cudnn" in low
                or "xmma" in low or "implicit" in low else
                "matmul" if "gemm" in low or "sgemm" in low else
                "copy/fill" if "memcpy" in low or "memset" in low
                or "fill" in low else
                "reduction" if "reduce" in low else "elementwise/other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
    print(f"train step ({label}) device time by kind: " + ", ".join(
        f"{k} {ms:.4f} ms" for k, ms in sorted(kinds.items(),
                                              key=lambda kv: -kv[1])))
    print(f"train step ({label}) device time, top kernels: " + "; ".join(
        f"{name[:60]} {ms:.4f} ms" for name, ms in by_name[:8]))
    return wall, busy


def new_kernel_timing(torch, card_line):
    """cut_bwd, cut_prior_fwd and cut_prior_bwd: device time at the
    training shape (R = 320 = 5 nodes x 64, d = 64) and at R = 20480 and
    262144 (fp32, sample mode, b = 32 as training runs), beside the bytes
    bound and the plain version."""
    from repro_torch.kernels import inl_bottleneck, ref
    rows = {}
    d, bits, mode = 64, 32, "sample"
    for R in (320, 20480, 262144):
        J = 5 if R % 5 == 0 else 4          # nodes of T rows, J * T == R
        T = R // J
        mu, lv, eps, gu, gr = grad_inputs(torch, (J, T, d), torch.float32, 0)
        pm, pv = prior_inputs(torch, J, d, 0)
        u, _ = inl_bottleneck.cut_prior_fwd(mu, lv, eps, pm, pv, bits=bits,
                                            mode=mode)
        flat = [t.reshape(R, d) for t in (mu, lv, eps, gu)]
        grf = gr.reshape(R)
        reps = 100 if R < 262144 else 30
        cases = {
            "cut_bwd": (
                lambda: inl_bottleneck.cut_bwd(*flat, grf, bits=bits,
                                               mode=mode),
                lambda: ref.cutlayer_bwd_ref(*flat, grf, bits, mode),
                28 * R * d + 4 * R),
            "cut_prior_fwd": (
                lambda: inl_bottleneck.cut_prior_fwd(mu, lv, eps, pm, pv,
                                                     bits=bits, mode=mode),
                lambda: ref.cutlayer_prior_fwd_ref(mu, lv, eps, pm, pv,
                                                   bits, mode),
                16 * R * d + 4 * R + 8 * J * d),
            "cut_prior_bwd": (
                lambda: inl_bottleneck.cut_prior_bwd(mu, lv, eps, pm, pv, u,
                                                     gu, gr, mode=mode),
                lambda: ref.cutlayer_prior_bwd_ref(mu, lv, eps, pm, pv, u,
                                                   gu, gr, bits, mode),
                32 * R * d + 4 * R + 16 * J * d),
        }
        for name, (kernel, plain, nbytes) in cases.items():
            k_dev, launched = device_profile(torch, kernel, reps=reps)
            p_dev = device_ms(torch, plain, reps=reps)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            rows[(name, R)] = (k_dev, p_dev, bound)
            earlier = ""
            if name == "cut_prior_bwd":
                stages = FIRST_PRIOR_BWD_STAGES[R]
                names = []
                for k, ms in launched:        # by kernel name
                    m = re.search(r"(\w+)(?:<[^>]*>)?\(", k)
                    names.append(f"{m.group(1) if m else k[:48]} "
                                 f"{ms:.5f} ms")
                earlier = (f" ({' + '.join(names)}; the first design's two "
                           f"launches: {FIRST_DESIGN_MS[name, R]} ms, rows "
                           f"{stages[0]} + reduce {stages[1]} ms, PERF.md)")
            print(f"{name} R={R} d={d} J={J} {mode} b={bits} fp32: device "
                  f"time kernel {k_dev:.5f} ms{earlier}, plain {p_dev:.5f} "
                  f"ms, bound {bound:.5f} ms (bytes {nbytes}, "
                  f"{bound / k_dev:.3f} of the bound) [{card_line}]")
    return rows


def pack_kernel_timing(torch, card_line):
    """cut_fwd_pack, pack and unpack_dequant: device time at the training
    shape (R = 320, d = 64) and at R = 20480 and 262144, fp32, b = 8 (the
    path's width), cut_fwd_pack in the sample mode, beside the bytes bound
    and the plain version."""
    from repro_torch.kernels import inl_bottleneck, ref
    rows = {}
    d, bits, mode = 64, WIRE_BITS, "sample"
    W = ref.packed_width(d, bits)
    for R in (320, 20480, 262144):
        mu, lv, eps = cut_inputs(torch, (R, d), torch.float32, 0)
        u, lanes, _ = inl_bottleneck.cut_fwd_pack(mu, lv, eps, bits=bits,
                                                  mode=mode)
        reps = 100 if R < 262144 else 30
        cases = {
            "cut_fwd_pack": (
                lambda: inl_bottleneck.cut_fwd_pack(mu, lv, eps, bits=bits,
                                                    mode=mode),
                lambda: ref.cutlayer_pack_fwd_ref(mu, lv, eps, bits, mode),
                R * (16 * d + 4 * W + 4)),
            "pack": (
                lambda: inl_bottleneck.pack(u, bits=bits),
                lambda: ref.pack_values_ref(u, bits),
                R * (4 * d + 4 * W)),
            "unpack_dequant": (
                lambda: inl_bottleneck.unpack(lanes, d=d, bits=bits),
                lambda: ref.unpack_dequant_ref(lanes, d, bits),
                R * (4 * d + 4 * W)),
        }
        for name, (kernel, plain, nbytes) in cases.items():
            k_dev = device_ms(torch, kernel, reps=reps)
            p_dev = device_ms(torch, plain, reps=reps)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            rows[(name, R)] = (k_dev, p_dev, bound)
            earlier = (f" (the first design's: "
                       f"{FIRST_DESIGN_MS[name, R]} ms, PERF.md)"
                       if (name, R) in FIRST_DESIGN_MS else "")
            print(f"{name} R={R} d={d} W={W} b={bits} fp32: device time "
                  f"kernel {k_dev:.5f} ms{earlier}, plain {p_dev:.5f} ms, "
                  f"bound {bound:.5f} ms (bytes {nbytes}, "
                  f"{bound / k_dev:.3f} of the bound) [{card_line}]")
    return rows


# ---------------------------------------------------------------------------
# 8. the LLM stack: Zamba2-2.7B serving
# ---------------------------------------------------------------------------

def attn_cost(torch, B, S, H, KV, Dh, dtype):
    """(flops, bytes) the causal call needs: 4 Dh flops per kept (query,
    key) pair, S (S + 1) / 2 of them, and head; q, k, v read once and o
    written once."""
    flops = 4.0 * Dh * (S * (S + 1) // 2) * B * H
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = esize * B * S * Dh * (2 * H + 2 * KV)
    return flops, nbytes


def ssd_cost(torch, B, S, H, P, N, L, dtype, groups=1):
    """(flops, bytes) of the chunked scan: C.B^T once per (b, chunk, group)
    over the causal pairs, then per head G.x, the inter-chunk term and the
    state update; x, B, C in `dtype`, dt, a, D fp32 read once, y written in
    `dtype` and the fp32 state once."""
    nc, pairs = S // L, L * (L + 1) // 2
    flops = 2.0 * B * nc * (groups * pairs * N
                            + H * (pairs * P + 2 * L * N * P))
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (esize * B * S * (2 * H * P + 2 * groups * N) + 4 * B * S * H
              + 8 * H + 4 * B * H * N * P)
    return flops, nbytes


def bound_of(flops, nbytes, peak):
    """(bound ms, "operations" or "bytes")."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def qkv_inputs(torch, B, S, H, KV, Dh, dtype, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(B, S, n, Dh))
                                  .astype(np.float32)).to(DEV).to(dtype)
                 for n in (H, KV, KV))


def ssd_inputs(torch, B, S, H, P, N, dtype, seed):
    """(x, dt, a, bm, cm, d): x, bm, cm in `dtype`; dt a softplus of a
    normal, a = -exp(0.2 N(0, 1)), D around 1, all fp32 (the draws of
    tests/test_kernels.py)."""
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(DEV)
    x = f(rng.normal(size=(B, S, H, P))).to(dtype)
    dt = f(np.log1p(np.exp(rng.normal(size=(B, S, H)))))
    a = f(-np.exp(0.2 * rng.normal(size=(H,))))
    bm = f(rng.normal(size=(B, S, N))).to(dtype)
    cm = f(rng.normal(size=(B, S, N))).to(dtype)
    d = f(1.0 + 0.2 * rng.normal(size=(H,)))
    return x, dt, a, bm, cm, d


def rel_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max()
                 / (want.double().abs().max() + 1e-6))


def llm_kernel_phase(torch):
    """flash_attn_fwd and ssd_scan against their plain versions on the
    same CUDA tensors.  Returns {name: max |kernel - plain|}."""
    from repro_torch.kernels import flash_attention, ref, ssm_scan
    worst = {"flash_attn_fwd": 0.0, "ssd_scan": 0.0}
    worst_rel = 0.0
    n_fa = n_ssd = 0
    for B, S, H, KV, Dh in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = qkv_inputs(torch, B, S, H, KV, Dh, dtype, S + Dh)
            for window in (0, 100):
                for q_offset in (0, 64):
                    qs = q[:, q_offset:].contiguous()
                    got = flash_attention.flash_attn_fwd(
                        qs, k, v, causal=True, window=window,
                        q_offset=q_offset)
                    want = ref.attention_ref(qs, k, v, causal=True,
                                             window=window, q_offset=q_offset)
                    torch.cuda.synchronize()
                    check(got.dtype == dtype and got.shape == qs.shape,
                          f"flash_attn_fwd gave {got.dtype} {got.shape}")
                    err = float((got.float() - want.float()).abs().max())
                    bar = FP32_BAR if dtype == torch.float32 else BF16_BAR
                    check(err <= bar, f"flash_attn_fwd differs from plain by "
                                      f"{err} > {bar} at {(B, S, H, KV, Dh)}"
                                      f" {dtype} window={window} "
                                      f"q_offset={q_offset}")
                    worst["flash_attn_fwd"] = max(worst["flash_attn_fwd"],
                                                  err)
                    n_fa += 1
    for B, S, H, P, N, chunk in SSD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x, dt, a, bm, cm, d = ssd_inputs(torch, B, S, H, P, N, dtype, S)
            y, st = ssm_scan.ssd_scan(x, dt, a, bm, cm, d, chunk=chunk)
            y_ref, st_ref = ref.ssd_chunked_ref(x, dt, a, bm, cm, d,
                                                chunk=chunk)
            torch.cuda.synchronize()
            check(y.dtype == dtype and st.dtype == torch.float32,
                  f"ssd_scan gave {y.dtype}, {st.dtype}")
            bar = FP32_BAR if dtype == torch.float32 else BF16_BAR
            for what, g, w in (("y", y, y_ref), ("state", st, st_ref)):
                err = rel_err(g, w)
                check(err <= bar, f"ssd_scan {what} differs from plain by "
                                  f"{err} (relative to max) > {bar} at "
                                  f"{(B, S, H, P, N, chunk)} {dtype}")
                worst_rel = max(worst_rel, err)
                worst["ssd_scan"] = max(worst["ssd_scan"], float(
                    (g.float() - w.float()).abs().max()))
            n_ssd += 1
    # chunk invariance on the card, at the shape and bar of
    # tests/test_kernels.py::test_ssd_chunk_invariance
    x, dt, a, bm, cm, d = ssd_inputs(torch, 1, 128, 2, 16, 8, torch.float32,
                                     0)
    y64, s64 = ssm_scan.ssd_scan(x, dt, a, bm, cm, d, chunk=64)
    y128, s128 = ssm_scan.ssd_scan(x, dt, a, bm, cm, d, chunk=128)
    torch.cuda.synchronize()
    inv = float((y64 - y128).abs().max())
    check(torch.allclose(y64, y128, atol=5e-4, rtol=1e-4) and
          torch.allclose(s64, s128, atol=5e-4, rtol=1e-4),
          f"ssd_scan chunk 64 vs chunk 128 differ by {inv}")
    print(f"llm kernels: flash_attn_fwd == plain on {n_fa} cases "
          f"({len(FLASH_CASES)} shapes "
          f"x fp32/bf16 x window {{0, 100}} x q_offset {{0, 64}}), max "
          f"|kernel - plain| {worst['flash_attn_fwd']:.3g} (bars {FP32_BAR} "
          f"fp32, {BF16_BAR} bf16); ssd_scan == plain on {n_ssd} cases "
          f"(y and final state), max error relative to the plain max "
          f"{worst_rel:.3g}, max |kernel - plain| {worst['ssd_scan']:.3g}; "
          f"chunk 64 vs 128 max |diff| {inv:.3g}")
    return worst


def zamba2(torch, *, num_layers=None, dtype="bfloat16"):
    import dataclasses
    from repro_torch.configs.base import get_config
    cfg = get_config("zamba2-2.7b")
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    return dataclasses.replace(cfg, dtype=dtype)


def kernel_inputs_of(fn):
    """Run fn() with the two LLM kernels' wrappers wrapped to keep the
    arguments of every call.  Returns (fn's result, {name: [(args, kw)]})."""
    from repro_torch.kernels import flash_attention, ssm_scan
    mods = {"flash_attn_fwd": flash_attention, "ssd_scan": ssm_scan}
    seen = {name: [] for name in mods}

    def keeping(name, launch):
        def call(*args, **kw):
            seen[name].append((args, kw))
            return launch(*args, **kw)
        return call
    orig = {name: getattr(mod, name) for name, mod in mods.items()}
    for name, mod in mods.items():
        setattr(mod, name, keeping(name, orig[name]))
    try:
        return fn(), seen
    finally:
        for name, mod in mods.items():
            setattr(mod, name, orig[name])


def path_inputs_check(torch, seen):
    """Each kernel against its plain version on the inputs that the
    serving prefill gave it, at the bars of `llm kernels`.  Returns
    ({name: max |kernel - plain|}, worst scan error relative to the plain
    max, max |o| of the attention outputs)."""
    from repro_torch.kernels import flash_attention, ref, ssm_scan
    worst = {"flash_attn_fwd": 0.0, "ssd_scan": 0.0}
    worst_rel = o_max = 0.0
    for (q, k, v), kw in seen["flash_attn_fwd"]:
        got = flash_attention.flash_attn_fwd(q, k, v, **kw)
        want = ref.attention_ref(q, k, v, **kw)
        bar = FP32_BAR if q.dtype == torch.float32 else BF16_BAR
        err = float((got.float() - want.float()).abs().max())
        check(got.shape == q.shape and err <= bar,
              f"flash_attn_fwd on the serving prefill's inputs "
              f"{tuple(q.shape)} {q.dtype} {kw} differs from plain by "
              f"{err} > {bar}")
        worst["flash_attn_fwd"] = max(worst["flash_attn_fwd"], err)
        o_max = max(o_max, float(want.float().abs().max()))
    for args, kw in seen["ssd_scan"]:
        y, st = ssm_scan.ssd_scan(*args, **kw)
        y_ref, st_ref = ref.ssd_chunked_ref(*args, **kw)
        bar = FP32_BAR if args[0].dtype == torch.float32 else BF16_BAR
        for what, g, w in (("y", y, y_ref), ("state", st, st_ref)):
            err = rel_err(g, w)
            check(err <= bar, f"ssd_scan {what} on the serving prefill's "
                              f"inputs {tuple(args[0].shape)} {kw} differs "
                              f"from plain by {err} (relative to max) > {bar}")
            worst_rel = max(worst_rel, err)
            worst["ssd_scan"] = max(worst["ssd_scan"], float(
                (g.float() - w.float()).abs().max()))
    torch.cuda.synchronize()
    return worst, worst_rel, o_max


def llm_serving_phase(torch, card_line):
    """Zamba2-2.7B at its full config in bf16 on the card: one prefill whose
    kernel inputs are kept and each kernel held against its plain version
    on them; serve_batch for 4 requests x prompt 512 x 32 tokens, launch
    counts set to 0 just before and read just after.  Returns (cfg, params,
    launches, {name: max |kernel - plain| on the prefill's inputs})."""
    from repro_torch.launch import serve, steps
    from repro_torch.models import zoo
    cfg = zamba2(torch)
    params = zoo.init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                             device=DEV)
    prompts = serve.prompts_for(cfg, LLM_B, LLM_PROMPT, 0).to(DEV)
    # logits of the prefill and two decode steps: finite, the right shape
    prefill = steps.make_prefill_step(cfg)
    (logits, cache), seen = kernel_inputs_of(
        lambda: prefill(params, {"tokens": prompts}))
    check(len(seen["flash_attn_fwd"]) == 9 and len(seen["ssd_scan"]) == 54,
          f"the prefill called the kernels {[len(c) for c in seen.values()]}"
          f" times, not 9 and 54")
    worst, worst_rel, o_max = path_inputs_check(torch, seen)
    del seen
    print(f"llm serving kernels: on the inputs the bf16 prefill (B={LLM_B}, "
          f"P={LLM_PROMPT}) gave them, flash_attn_fwd == plain on its 9 calls"
          f", max |kernel - plain| {worst['flash_attn_fwd']:.3g} (max |o| "
          f"{o_max:.3g}, bar {BF16_BAR}); ssd_scan == plain on its 54 calls "
          f"(y and final state), max error relative to the plain max "
          f"{worst_rel:.3g} (bar {BF16_BAR}), max |kernel - plain| "
          f"{worst['ssd_scan']:.3g}")
    cache = zoo.pad_cache(cache, 2)
    decode = steps.make_decode_step(cfg)
    all_logits = [logits]
    for t in range(2):
        tok = torch.argmax(all_logits[-1], dim=-1)[:, None]
        lg, cache = decode(params, {"tokens": tok,
                                    "cache_len": LLM_PROMPT + t}, cache)
        all_logits.append(lg)
    for lg in all_logits:
        check(lg.shape == (LLM_B, cfg.vocab_size)
              and bool(torch.isfinite(lg).all()), "non-finite logits")
    del cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    gen = serve.serve_batch(cfg, params, prompts, LLM_GEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(gen.shape == (LLM_B, LLM_GEN) and int(gen.min()) >= 0
          and int(gen.max()) < cfg.vocab_size, f"tokens out of range {gen}")
    expect_launches(launches, {"flash_attn_fwd": 9, "ssd_scan": 54},
                    "Zamba2-2.7B serve_batch (one prefill, 31 decode steps)")
    n_params = zoo.param_count(cfg)
    print(f"llm serving: Zamba2-2.7B (d_model {cfg.d_model}, {cfg.num_layers}"
          f" layers, {n_params} parameters, bf16) served {LLM_B} requests x "
          f"prompt {LLM_PROMPT} x {LLM_GEN} tokens in {wall:.3f} s; one "
          f"prefill launched flash_attn_fwd {launches['flash_attn_fwd']} and "
          f"ssd_scan {launches['ssd_scan']} times, the decode steps neither; "
          f"logits finite; peak memory {peak:.2f} GiB; sample "
          f"{gen[0, :8].tolist()} [{card_line}]")
    return cfg, params, launches, worst


def llm_fp32_phase(torch, card_line):
    """One period of Zamba2-2.7B at full width in fp32 (num_layers=6: five
    Mamba2 layers and the shared attention): (a) the card against the CPU,
    one set of weights, prefill of 512 and 8 greedy steps fed the CPU's
    tokens; (b) on the card, prefill of P+1 tokens against prefill of P and
    one decode step."""
    from repro_torch import tree_map
    from repro_torch.launch import serve, steps
    from repro_torch.models import zoo
    cfg = zamba2(torch, num_layers=6, dtype="float32")
    p_cpu = zoo.init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
    # N(0, 1/d_model) adapters in place of init's N(0, 1e-8): the shared
    # attention block then moves the compared logits as a Mamba2 layer does
    for pos in p_cpu["stack"]["pattern"]:
        if "adapter" in pos:
            pos["adapter"]["w"].mul_(1e4 / cfg.d_model ** 0.5)
    p_dev = tree_map(lambda t: t.to(DEV), p_cpu)
    prompts = serve.prompts_for(cfg, 1, LLM_PROMPT, 1)
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    lc, cc = prefill(p_cpu, {"tokens": prompts})
    lg, cg = prefill(p_dev, {"tokens": prompts.to(DEV)})
    lg = lg.cpu()
    check(torch.allclose(lg, lc, **LLM_CPU_TOL),
          f"prefill logits card vs CPU max |diff| {(lg - lc).abs().max()}")
    err = float((lg - lc).abs().max())
    cc, cg = zoo.pad_cache(cc, LLM_CPU_STEPS), zoo.pad_cache(cg, LLM_CPU_STEPS)
    same = close = 0
    step_err = 0.0
    for t in range(LLM_CPU_STEPS):
        top2 = torch.topk(lc, 2, dim=-1).values[0]
        margin = float(top2[0] - top2[1])
        if margin > LLM_MARGIN:
            check(int(lg.argmax()) == int(lc.argmax()),
                  f"greedy token {t}: card {int(lg.argmax())} cpu "
                  f"{int(lc.argmax())} at a top-2 margin of {margin}")
            same += 1
        else:
            close += 1
        tok = lc.argmax(dim=-1)[:, None]
        lc, cc = decode(p_cpu, {"tokens": tok,
                                "cache_len": LLM_PROMPT + t}, cc)
        lg, cg = decode(p_dev, {"tokens": tok.to(DEV),
                                "cache_len": LLM_PROMPT + t}, cg)
        lg = lg.cpu()
        check(torch.allclose(lg, lc, **LLM_CPU_TOL),
              f"decode step {t} logits card vs CPU max |diff| "
              f"{(lg - lc).abs().max()}")
        step_err = max(step_err, float((lg - lc).abs().max()))
    del p_cpu, cc, cg
    # (b) prefill of P + 1 == prefill of P + one decode step, on the card
    P = LLM_CONSIST_P
    toks = serve.prompts_for(cfg, 2, P + 1, 2).to(DEV)
    full, _ = prefill(p_dev, {"tokens": toks})
    _, cache = prefill(p_dev, {"tokens": toks[:, :P]})
    cache = zoo.pad_cache(cache, 1)
    step, _ = decode(p_dev, {"tokens": toks[:, P:], "cache_len": P}, cache)
    torch.cuda.synchronize()
    check(torch.allclose(step, full, **LLM_CPU_TOL),
          f"prefill {P + 1} vs prefill {P} + decode: max |diff| "
          f"{(step - full).abs().max()}")
    cons = float((step - full).abs().max())
    print(f"llm fp32 (num_layers=6, d_model {cfg.d_model}): prefill "
          f"{LLM_PROMPT} last logits card vs CPU max |diff| {err:.3g}, "
          f"{LLM_CPU_STEPS} decode steps fed the CPU's tokens max |diff| "
          f"{step_err:.3g} (rtol/atol 1e-3); greedy tokens equal on {same} "
          f"steps with a top-2 margin above {LLM_MARGIN}, {close} closer "
          f"calls; prefill {P + 1} vs prefill {P} + one decode step max "
          f"|diff| {cons:.3g} [{card_line}]")


def timed_host(torch, fn, reps):
    """Median host-clock ms of `fn` ending in a synchronize, after one
    warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def eager_decode(torch, cfg, greedy=True):
    """The decode step run eagerly, never captured: the body of
    steps.make_decode_step(greedy=greedy), for holding the graphed step
    against it (greedy: the argmax ids, else the logits)."""
    from repro_torch.models import zoo

    @torch.no_grad()
    def decode(params, batch, cache):
        logits, cache, _ = zoo.forward(params, cfg, batch, mode="decode",
                                    cache=cache)
        logits = logits[:, -1]
        return (torch.argmax(logits, dim=-1) if greedy else logits), cache
    return decode


def decode_attention_check(torch, cfg, card_line):
    """One bf16 decode_attention call at the serving decode's shapes (B=4,
    a cache of 512 + 32 slots, 300 valid, Zamba2's heads): the device
    memory it allocates beyond its inputs against the bytes an fp32 copy
    of both caches would take, its device time (CUDA events), and the
    entries that differ from the CPU port on the same inputs."""
    from repro_torch.models import attention

    g = torch.Generator(device=DEV).manual_seed(21)
    W, KV, H, Dh = LLM_PROMPT + LLM_GEN, cfg.num_kv_heads, cfg.num_heads, \
        cfg.head_dim

    def draw(*shape):
        return torch.randn(shape, generator=g, device=DEV).to(torch.bfloat16)
    q, kn, vn = draw(LLM_B, 1, H, Dh), draw(LLM_B, 1, KV, Dh), \
        draw(LLM_B, 1, KV, Dh)
    kc, vc = draw(LLM_B, W, KV, Dh), draw(LLM_B, W, KV, Dh)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = attention.decode_attention(q, kc, vc, 300, kn, vn)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    copies = 2 * kc.numel() * 4
    check(extra < copies / 4, f"decode_attention allocated {extra} bytes, "
                              f"an fp32 copy of the caches is {copies}")
    cpu = attention.decode_attention(*(t.cpu() for t in (q, kc, vc)), 300,
                                     kn.cpu(), vn.cpu())
    differ = int((out.cpu() != cpu).sum())
    err = float((out.cpu().float() - cpu.float()).abs().max())
    check(err <= 2e-2 * float(cpu.float().abs().max()),
          f"decode_attention: card against the CPU port {err}")
    ms = cuda_ms(torch, lambda: attention.decode_attention(
        q, kc, vc, 300, kn, vn), reps=100, warmup=10)
    print(f"llm decode attention: bf16 B={LLM_B} W={W} H={H} KV={KV} "
          f"Dh={Dh}, 300 valid: {extra} bytes allocated beyond the inputs "
          f"(an fp32 copy of both caches: {copies}), {ms:.4f} ms a call "
          f"(CUDA events, eager), {differ} of {out.numel()} outputs differ "
          f"from the CPU port's, by at most {err:.3g} [{card_line}]")


def llm_graph_phase(torch, cfg, params, card_line):
    """Zamba2-2.7B at full width, B=4 after a prompt of 512, 32 tokens,
    deterministic algorithms on: the greedy decode loop on the graphed step
    (steps.make_decode_step) against the same loop on the eager step from
    one prefill, the ids and every leaf of the final cache bit for bit and
    one capture (trace_log); then serve_batch(trace_log=) gives the eager
    ids with one capture.  Returns the graphed loop's launches."""
    from repro_torch import tree_leaves, tree_map
    from repro_torch.launch import serve, steps
    from repro_torch.models import zoo

    prompts = serve.prompts_for(cfg, LLM_B, LLM_PROMPT, 5).to(DEV)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        logits, cache0 = steps.make_prefill_step(cfg)(params,
                                                      {"tokens": prompts})
        log = []
        runs = {}
        for label, decode in (("eager", eager_decode(torch, cfg)),
                              ("graph", steps.make_decode_step(
                                  cfg, greedy=True, trace_log=log))):
            cache = zoo.pad_cache(tree_map(torch.clone, cache0), LLM_GEN)
            tok = torch.argmax(logits, dim=-1)
            ids = [tok]
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            for t in range(LLM_GEN - 1):
                pos = torch.full((), LLM_PROMPT + t, dtype=torch.int64,
                                 device=DEV)
                tok, cache = decode(params, {"tokens": tok[:, None],
                                             "cache_len": pos}, cache)
                ids.append(tok)
            torch.cuda.synchronize()
            runs[label] = (torch.stack(ids, dim=1), cache,
                           time.perf_counter() - t0, read_launches())
        (ids_e, cache_e, t_e, _), (ids_g, cache_g, t_g, launches) = \
            runs["eager"], runs["graph"]
        check(torch.equal(ids_e, ids_g), "decode: graphed ids differ from "
                                         "the eager ones")
        le, lg = tree_leaves(cache_e), tree_leaves(cache_g)
        check(len(le) == len(lg) and all(torch.equal(a, b)
                                         for a, b in zip(le, lg)),
              "decode: the graphed final cache differs from the eager one")
        check(len(log) == 1, f"decode: {len(log)} captures, not 1")
        log2 = []
        gen = serve.serve_batch(cfg, params, prompts, LLM_GEN,
                                trace_log=log2)
        check(torch.equal(gen, ids_e) and len(log2) == 1,
              f"serve_batch: ids == eager {torch.equal(gen, ids_e)}, "
              f"{len(log2)} captures")
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"llm graphs: Zamba2-2.7B (bf16, full width) B={LLM_B} after "
          f"{LLM_PROMPT}, {LLM_GEN} tokens: the graphed decode loop == the "
          f"eager one bit for bit (ids and {len(le)} cache leaves), "
          f"trace_log {len(log)} entry; serve_batch == eager ids with one "
          f"capture; loop wall eager {t_e:.3f} s, graphed {t_g:.3f} s "
          f"[{card_line}]")
    return launches


def llm_timing(torch, cfg, params, card_line):
    """Zamba2-2.7B prefill latency at (B=4, P=512) and (B=4, P=2048) and
    the decode latency per token, each with the device's busy time and idle
    share from the profiler; the decode step eager and graphed (its device
    time from CUDA events around back-to-back steps)."""
    from repro_torch.launch import serve, steps
    prefill = steps.make_prefill_step(cfg)
    out = {}
    for P in (LLM_PROMPT, 2048):
        prompts = serve.prompts_for(cfg, LLM_B, P, 3).to(DEV)
        fn = lambda: prefill(params, {"tokens": prompts})
        wall = timed_host(torch, fn, reps=5)
        busy, by_name = device_profile(torch, fn, reps=3, warmup=1)
        out[f"prefill_{P}"] = (wall, busy)
        top = "; ".join(f"{n[:48]} {ms:.3f} ms" for n, ms in by_name[:5])
        own = {k: sum(ms for n, ms in by_name if tag in n)
               for k, tag in (("flash_attn_fwd", "flash_fwd"),
                              ("ssd_scan", "ssd_"))}
        print(f"llm prefill latency (B={LLM_B}, P={P}): median {wall:.3f} ms "
              f"over 5; device busy {busy:.3f} ms, idle share "
              f"{1 - busy / wall:.3f}; top kernels: {top}; the hand-written "
              f"kernels: flash_attn_fwd {own['flash_attn_fwd']:.3f} ms, "
              f"ssd_scan {own['ssd_scan']:.3f} ms [{card_line}]")
    out.update(decode_timing(torch, cfg, params, card_line))
    return out


def decode_timing(torch, cfg, params, card_line):
    """Zamba2-2.7B's decode latency per token after a prompt of 512, eager
    (host clock, and the profiler's busy time) and graphed (host clock,
    and the device time from CUDA events around back-to-back steps)."""
    from repro_torch.launch import serve, steps
    from repro_torch.models import zoo
    prefill = steps.make_prefill_step(cfg)
    decode = eager_decode(torch, cfg)
    out = {}
    prompts = serve.prompts_for(cfg, LLM_B, LLM_PROMPT, 4).to(DEV)
    _, cache = prefill(params, {"tokens": prompts})
    steps_n = 24
    # room for the timed steps and every profiler window, retries included
    cache = zoo.pad_cache(cache, 1 + steps_n + PROFILE_TRIES * 12)
    tok = prompts[:, -1]
    box = [tok, cache, LLM_PROMPT]

    def one():
        pos = torch.full((), box[2], dtype=torch.int64, device=DEV)
        box[0], box[1] = decode(params, {"tokens": box[0][:, None],
                                         "cache_len": pos}, box[1])
        box[2] += 1
    wall = timed_host(torch, one, reps=steps_n)
    busy, _ = device_profile(torch, one, reps=10, warmup=2)
    out["decode"] = (wall, busy)
    print(f"llm decode latency per token (B={LLM_B}, cache {LLM_PROMPT}+): "
          f"median {wall:.3f} ms over {steps_n} steps; device busy "
          f"{busy:.3f} ms, idle share {1 - busy / wall:.3f} [{card_line}]")
    # the graphed step on a fresh cache: one capture, then replays
    g_wall, g_dev = graphed_decode_ms(torch, cfg, params,
                                      {"tokens": prompts}, steps_n)
    out["decode graphed"] = (g_wall, g_dev)
    print(f"graphs times: llm decode per token (B={LLM_B}, cache "
          f"{LLM_PROMPT}+): eager wall {wall:.3f} ms, busy {busy:.3f} ms, "
          f"idle {1 - busy / wall:.3f}; graph wall {g_wall:.3f} ms, device "
          f"{g_dev:.3f} ms (CUDA events around {steps_n} steps), idle "
          f"{1 - g_dev / g_wall:.3f}; {wall / g_wall:.2f}x [{card_line}]")
    return out


def llm_kernel_timing(torch, card_line):
    """flash_attn_fwd and ssd_scan device time (graph_ms) at the serving
    shape (B=4, S=512) and at S=2048, bf16, Zamba2's widths, beside the
    bound, the plain version and (attention) scaled_dot_product_attention,
    which the port never calls."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, ref, ssm_scan
    rows = {}
    bf16 = torch.bfloat16
    for S in (LLM_PROMPT, 2048):
        reps = 20 if S == LLM_PROMPT else 5
        timed = lambda fn: graph_ms(torch, fn, reps)
        q, k, v = qkv_inputs(torch, LLM_B, S, 32, 32, 80, bf16, 5)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        flops, nbytes = attn_cost(torch, LLM_B, S, 32, 32, 80, bf16)
        bound, by = bound_of(flops, nbytes, BF16_FLOPS)
        k_ms = timed(lambda: flash_attention.flash_attn_fwd(q, k, v,
                                                            causal=True))
        p_ms = timed(lambda: ref.attention_ref(q, k, v, causal=True))
        l_ms = timed(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        rows[("flash_attn_fwd", S)] = (k_ms, p_ms, bound, by, l_ms)
        print(f"flash_attn_fwd B={LLM_B} S={S} H=KV=32 Dh=80 bf16 causal: "
              f"device time kernel {k_ms:.4f} ms (the SIMT kernel: "
              f"{SIMT_MS['flash_attn_fwd', S]} ms, PERF.md), plain "
              f"{p_ms:.4f} ms, scaled_dot_product_attention {l_ms:.4f} ms, "
              f"bound {bound:.4f} ms by {by} ({flops:.3g} flops, {nbytes} "
              f"bytes; {bound / k_ms:.3f} of the bound, "
              f"{flops / k_ms / 1e9:.1f} TFLOP/s) [{card_line}]")
        x, dt, a, bm, cm, d = ssd_inputs(torch, LLM_B, S, 80, 64, 64, bf16, 6)
        flops, nbytes = ssd_cost(torch, LLM_B, S, 80, 64, 64, 256, bf16)
        bound, by = bound_of(flops, nbytes, BF16_FLOPS)
        k_ms = timed(lambda: ssm_scan.ssd_scan(x, dt, a, bm, cm, d,
                                               chunk=256))
        p_ms = timed(lambda: ref.ssd_chunked_ref(x, dt, a, bm, cm, d,
                                                 chunk=256))
        rows[("ssd_scan", S)] = (k_ms, p_ms, bound, by, None)
        _, stages = device_profile(
            torch, lambda: ssm_scan.ssd_scan(x, dt, a, bm, cm, d, chunk=256),
            reps=10, warmup=2)
        stages = ", ".join(f"{n.split('::')[-1].split('(')[0]} {ms:.4f}"
                           for n, ms in stages)
        print(f"ssd_scan B={LLM_B} S={S} H=80 P=64 N=64 chunk 256 bf16: "
              f"device time kernel {k_ms:.4f} ms (the SIMT kernel: "
              f"{SIMT_MS['ssd_scan', S]} ms, PERF.md; its launches by the "
              f"profiler: {stages} ms), plain {p_ms:.4f} ms, bound "
              f"{bound:.4f} ms by {by} ({flops:.3g} flops, {nbytes} bytes; "
              f"{bound / k_ms:.3f} of the bound); no single torch call "
              f"[{card_line}]")
    return rows


def attn_model(arch, num_layers=None):
    """The registered full config in bf16, its depth cut to num_layers."""
    import dataclasses
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    return dataclasses.replace(cfg, dtype="bfloat16")


def zoo_inputs(cfg, ids):
    """The batch of (B, S) token ids for cfg's modality: an audio model
    reads them on each of its K codebooks (tokens_mc), as serve_batch
    feeds it."""
    if cfg.modality == "audio_tokens":
        return {"tokens_mc": ids[..., None].expand(*ids.shape,
                                                   cfg.num_codebooks)}
    return {"tokens": ids}


def last_ids(batch):
    """The (B,) ids of a batch's last position (an audio model's first
    codebook)."""
    if "tokens_mc" in batch:
        return batch["tokens_mc"][:, -1, 0]
    return batch["tokens"][:, -1]


def positions_of(batch):
    """The positions a prefill of `batch` fills: the VLM's patches and its
    text."""
    ids = batch.get("tokens", batch.get("tokens_mc"))
    n = ids.shape[1]
    if "patch_embeds" in batch:
        n += batch["patch_embeds"].shape[1]
    return n


def graphed_decode_ms(torch, cfg, params, batch, steps_n=24):
    """The graphed greedy decode step a token after a prefill of `batch`
    (any modality's): (host-clock median ms, device ms from CUDA events
    around steps_n back-to-back steps)."""
    from repro_torch.launch import steps
    from repro_torch.models import zoo
    _, cache = steps.make_prefill_step(cfg)(params, batch)
    cache = zoo.pad_cache(cache, 2 + 2 * steps_n + 20)
    graphed = steps.make_decode_step(cfg, greedy=True)
    box = [last_ids(batch), cache, positions_of(batch)]

    def one():
        pos = torch.full((), box[2], dtype=torch.int64, device=DEV)
        box[0], box[1] = graphed(params, dict(zoo_inputs(
            cfg, box[0][:, None]), cache_len=pos), box[1])
        box[2] += 1
    wall = timed_host(torch, one, reps=steps_n)
    return wall, cuda_ms(torch, one, reps=steps_n, warmup=2)


def llm_attn_phase(torch, card_line):
    """The attention-block transformers in bf16 at their published widths
    (ATTN_MODELS): each model's prefill at B=4, P=512 with its flash calls
    held against the plain version on their own inputs, the launches
    counted (set to 0 just before, read just after) against the table, and
    two decode steps with finite logits; Llama-3.2-1B at full depth then
    served, 4 requests x 512 x 32 tokens, launches counted, and its
    graphed decode timed.  Returns ({arch: flash launches in its prefill},
    {"llama serve": launches}, max |kernel - plain| over every call,
    {"deepseek": max |kernel - plain| of its Dh = 192 calls})."""
    from repro_torch.launch import serve, steps
    from repro_torch.models import zoo
    launches_by_model, worst, worst192 = {}, 0.0, 0.0
    serve_launches = None
    for arch, depth, want in ATTN_MODELS:
        t0 = time.perf_counter()
        cfg = attn_model(arch, depth)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params = zoo.init_params(
            cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
        prompts = serve.prompts_for(cfg, LLM_B, LLM_PROMPT, 0).to(DEV)
        prefill = steps.make_prefill_step(cfg)
        torch.cuda.synchronize()
        reset_launches()
        (logits, cache), seen = kernel_inputs_of(
            lambda: prefill(params, {"tokens": prompts}))
        torch.cuda.synchronize()
        launches = read_launches()
        expect_launches(launches, {"flash_attn_fwd": want},
                        f"{arch} prefill (B={LLM_B}, P={LLM_PROMPT})")
        check(len(seen["flash_attn_fwd"]) == want,
              f"{arch}: {len(seen['flash_attn_fwd'])} flash calls, not "
              f"{want}")
        dh = {q.shape[-1] for (q, _, _), _ in seen["flash_attn_fwd"]}
        check(dh == {MLA_DH if cfg.use_mla else cfg.head_dim},
              f"{arch}: flash calls at head dims {dh}")
        err, _, o_max = path_inputs_check(torch, seen)
        err = err["flash_attn_fwd"]
        del seen
        worst = max(worst, err)
        if cfg.use_mla:
            worst192 = max(worst192, err)
        launches_by_model[arch] = launches["flash_attn_fwd"]
        cache = zoo.pad_cache(cache, 2)
        decode = steps.make_decode_step(cfg)
        all_logits = [logits]
        for t in range(2):
            tok = torch.argmax(all_logits[-1], dim=-1)[:, None]
            lg, cache = decode(params, {"tokens": tok,
                                        "cache_len": LLM_PROMPT + t}, cache)
            all_logits.append(lg)
        for lg in all_logits:
            check(lg.shape == (LLM_B, cfg.vocab_size)
                  and bool(torch.isfinite(lg).all()),
                  f"{arch}: non-finite logits")
        del cache, all_logits, logits
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        what = [f"{cfg.num_layers} layers", f"d_model {cfg.d_model}",
                f"{zoo.param_count(cfg)} parameters"]
        if depth:
            what[0] = f"{depth} of {attn_model(arch).num_layers} layers"
        if cfg.is_moe:
            what.append(f"MoE {cfg.moe.num_experts} experts top-"
                        f"{cfg.moe.experts_per_token}")
        if cfg.use_mla:
            what.append("MLA")
        print(f"llm attn: {arch} (bf16, {', '.join(what)}): prefill B={LLM_B} "
              f"P={LLM_PROMPT} launched flash_attn_fwd "
              f"{launches['flash_attn_fwd']} times at Dh {sorted(dh)}, each "
              f"== plain on its inputs, max |kernel - plain| {err:.3g} (max "
              f"|o| {o_max:.3g}, bar {BF16_BAR}); two decode steps, logits "
              f"finite; peak memory {peak:.2f} GiB; "
              f"{time.perf_counter() - t0:.1f} s [{card_line}]")
        if arch == "llama3.2-1b":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t1 = time.perf_counter()
            gen = serve.serve_batch(cfg, params, prompts, LLM_GEN)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            serve_launches = read_launches()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            check(gen.shape == (LLM_B, LLM_GEN) and int(gen.min()) >= 0
                  and int(gen.max()) < cfg.vocab_size,
                  f"{arch}: tokens out of range {gen}")
            expect_launches(serve_launches, {"flash_attn_fwd": want},
                            f"{arch} serve_batch (one prefill, "
                            f"{LLM_GEN - 1} graphed decode steps)")
            d_wall, d_dev = graphed_decode_ms(torch, cfg, params,
                                              {"tokens": prompts})
            print(f"llm attn serving: {arch} (full width and depth, bf16) "
                  f"served {LLM_B} requests x prompt {LLM_PROMPT} x "
                  f"{LLM_GEN} tokens in {wall:.3f} s; flash_attn_fwd "
                  f"launched {serve_launches['flash_attn_fwd']} times (the "
                  f"prefill; the decode steps none); peak memory "
                  f"{peak:.2f} GiB; graphed decode per token {d_wall:.3f} ms "
                  f"wall, {d_dev:.3f} ms device (CUDA events); sample "
                  f"{gen[0, :8].tolist()} [{card_line}]")
        # the decode step's graph keeps the parameters it captured
        del params, prefill, decode
        torch.cuda.empty_cache()
    return launches_by_model, serve_launches, worst, worst192


def mla_kernel_timing(torch, card_line):
    """flash_attn_fwd's Dh = 192 instance at DeepSeek-V2's prefill heads
    (H = KV = 128), B=4, S=512 and 2048, bf16: device time (graph_ms)
    beside the bound, the plain version and scaled_dot_product_attention
    (timed only; the port never calls it)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, ref
    rows = {}
    H, Dh, bf16 = MLA_HEADS, MLA_DH, torch.bfloat16
    for S in (LLM_PROMPT, 2048):
        reps = 20 if S == LLM_PROMPT else 5
        timed = lambda fn: graph_ms(torch, fn, reps)
        q, k, v = qkv_inputs(torch, LLM_B, S, H, H, Dh, bf16, 7)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        flops, nbytes = attn_cost(torch, LLM_B, S, H, H, Dh, bf16)
        bound, by = bound_of(flops, nbytes, BF16_FLOPS)
        k_ms = timed(lambda: flash_attention.flash_attn_fwd(q, k, v,
                                                            causal=True))
        p_ms = timed(lambda: ref.attention_ref(q, k, v, causal=True))
        l_ms = timed(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
        rows[S] = (k_ms, p_ms, bound, by, l_ms)
        print(f"flash_attn_fwd B={LLM_B} S={S} H=KV={H} Dh={Dh} bf16 "
              f"causal (MLA's prefill): device time kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, scaled_dot_product_attention "
              f"{l_ms:.4f} ms, bound {bound:.4f} ms by {by} ({flops:.3g} "
              f"flops, {nbytes} bytes; {bound / k_ms:.3f} of the bound, "
              f"{flops / k_ms / 1e9:.1f} TFLOP/s) [{card_line}]")
    return rows


def zoo_prompt_batch(torch, cfg, length, seed):
    """A prefill batch of LLM_B sequences over `length` positions: seeded
    Markov prompts (an audio model's on each codebook); the VLM's first
    num_prefix_tokens positions seeded N(0, 1) patch embeddings, as the
    reference's dummy batch draws them, then text tokens."""
    from repro_torch.launch import serve
    ids = serve.prompts_for(cfg, LLM_B, length, seed).to(DEV)
    if cfg.modality != "vlm":
        return zoo_inputs(cfg, ids)
    P = cfg.num_prefix_tokens
    g = torch.Generator(device=DEV).manual_seed(seed)
    patches = torch.randn((LLM_B, P, cfg.d_model), generator=g, device=DEV)
    return {"patch_embeds": patches.to(torch.bfloat16), "tokens": ids[:, P:]}


def zoo_graph_check(torch, cfg, params, batch):
    """Under deterministic algorithms, ZOO_STEPS decode steps from one
    prefill of `batch`, each fed the eager run's greedy token: the graphed
    step (steps.make_decode_step) against the eager body, the logits of
    every step, the ids and every leaf of the final cache bit for bit, one
    capture.  Returns the number of cache leaves compared."""
    from repro_torch import tree_leaves, tree_map
    from repro_torch.launch import steps
    from repro_torch.models import zoo
    P = positions_of(batch)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        logits, cache0 = steps.make_prefill_step(cfg)(params, batch)
        log, runs = [], {}
        for label, decode in (("eager", eager_decode(torch, cfg, False)),
                              ("graph", steps.make_decode_step(
                                  cfg, trace_log=log))):
            cache = zoo.pad_cache(tree_map(torch.clone, cache0), ZOO_STEPS)
            lg, ids, lgs = logits, [], []
            for t in range(ZOO_STEPS):
                tok = torch.argmax(lg, dim=-1)
                ids.append(tok[:, 0] if tok.ndim > 1 else tok)  # codebook 0
                # both runs are fed the eager run's tokens
                tok = runs["eager"][0][t] if runs else ids[-1]
                pos = torch.full((), P + t, dtype=torch.int64, device=DEV)
                lg, cache = decode(params, dict(zoo_inputs(
                    cfg, tok[:, None]), cache_len=pos), cache)
                lgs.append(lg)
            runs[label] = (ids, lgs, cache)
            del decode
        (ids_e, lg_e, cache_e), (ids_g, lg_g, cache_g) = runs["eager"], \
            runs["graph"]
        check(all(torch.equal(a, b) for a, b in zip(ids_e, ids_g)),
              f"{cfg.name}: graphed decode ids differ from the eager ones")
        check(all(torch.equal(a, b) for a, b in zip(lg_e, lg_g)),
              f"{cfg.name}: graphed decode logits differ from the eager "
              f"ones")
        le, lgl = tree_leaves(cache_e), tree_leaves(cache_g)
        check(len(le) == len(lgl) and all(torch.equal(a, b)
                                          for a, b in zip(le, lgl)),
              f"{cfg.name}: the graphed final cache differs from the eager "
              f"one")
        check(len(log) == 1, f"{cfg.name}: {len(log)} captures, not 1")
    finally:
        torch.use_deterministic_algorithms(False)
    return len(le)


def zoo_handover_check(torch, cfg, params, seed):
    """Prefill of LLM_PROMPT positions then one decode step of the next
    token against a prefill of LLM_PROMPT + 1: the states and caches a
    prefill hands to decode.  In fp32, on a twin of the model holding the
    same (bf16) weights in fp32, the two last logits within LLM_CPU_TOL;
    in bf16, within ZOO_HANDOVER_NOISE x the bf16 prefill's deviation
    from the twin's, plus the twin's gap.  Returns ({"fp32": gap, "bf16":
    gap, "noise": the bf16 prefill's deviation}, max |logit|), max |diff|
    over the last logits."""
    import dataclasses
    from repro_torch import tree_map
    from repro_torch.launch import steps
    from repro_torch.models import zoo
    full = zoo_prompt_batch(torch, cfg, LLM_PROMPT + 1, seed)
    head = {k: v if k == "patch_embeds" else v[:, :-1]
            for k, v in full.items()}
    tail = {k: v[:, -1:] for k, v in full.items() if k != "patch_embeds"}

    def run(c, p):
        prefill = steps.make_prefill_step(c)
        want, _ = prefill(p, full)
        _, cache = prefill(p, head)
        got, _ = eager_decode(torch, c, False)(
            p, dict(tail, cache_len=LLM_PROMPT), zoo.pad_cache(cache, 1))
        return want.float(), got.float()
    want16, got16 = run(cfg, params)
    twin = tree_map(lambda t: t.float(), params)
    want32, got32 = run(dataclasses.replace(cfg, dtype="float32"), twin)
    del twin
    torch.cuda.synchronize()
    gap = {"fp32": float((got32 - want32).abs().max()),
           "bf16": float((got16 - want16).abs().max()),
           "noise": float((want16 - want32).abs().max())}
    top = float(want16.abs().max())
    check(torch.allclose(got32, want32, **LLM_CPU_TOL),
          f"{cfg.name} in fp32: prefill {LLM_PROMPT} + one decode step "
          f"against prefill {LLM_PROMPT + 1}: max |diff| {gap['fp32']}")
    check(bool(torch.isfinite(got16).all()) and gap["bf16"]
          <= ZOO_HANDOVER_NOISE * gap["noise"] + gap["fp32"],
          f"{cfg.name} in bf16: prefill {LLM_PROMPT} + one decode step "
          f"against prefill {LLM_PROMPT + 1}: max |diff| {gap['bf16']} > "
          f"{ZOO_HANDOVER_NOISE} x the bf16 prefill's deviation from fp32 "
          f"{gap['noise']} + the fp32 gap {gap['fp32']}")
    return gap, top


def xlstm_fp32_check(torch, card_line):
    """One period of xLSTM-125M (num_layers=4: three mLSTM blocks and an
    sLSTM) at full width in fp32: the card against the CPU port on one set
    of weights, prefill of 512 and LLM_CPU_STEPS decode steps fed the CPU's
    tokens, within LLM_CPU_TOL."""
    import dataclasses
    from repro_torch import tree_map
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve, steps
    from repro_torch.models import zoo
    cfg = dataclasses.replace(get_config("xlstm-125m"),
                              num_layers=XLSTM_PERIOD, dtype="float32")
    p_cpu = zoo.init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
    p_dev = tree_map(lambda t: t.to(DEV), p_cpu)
    prompts = serve.prompts_for(cfg, 1, LLM_PROMPT, 1)
    prefill = steps.make_prefill_step(cfg)
    decode = eager_decode(torch, cfg, False)
    lc, cc = prefill(p_cpu, {"tokens": prompts})
    lg, cg = prefill(p_dev, {"tokens": prompts.to(DEV)})
    errs = []
    for t in range(LLM_CPU_STEPS + 1):
        lg = lg.cpu()
        check(torch.allclose(lg, lc, **LLM_CPU_TOL),
              f"xLSTM fp32 step {t} logits card vs CPU max |diff| "
              f"{(lg - lc).abs().max()}")
        errs.append(float((lg - lc).abs().max()))
        if t == LLM_CPU_STEPS:
            break
        tok = lc.argmax(dim=-1)[:, None]
        lc, cc = decode(p_cpu, {"tokens": tok, "cache_len": LLM_PROMPT + t},
                        cc)
        lg, cg = decode(p_dev, {"tokens": tok.to(DEV),
                                "cache_len": LLM_PROMPT + t}, cg)
    print(f"llm zoo fp32: xLSTM-125M one period (num_layers="
          f"{XLSTM_PERIOD}, d_model {cfg.d_model}): prefill {LLM_PROMPT} "
          f"last logits card vs CPU max |diff| {errs[0]:.3g}, "
          f"{LLM_CPU_STEPS} decode steps fed the CPU's tokens max |diff| "
          f"{max(errs[1:]):.3g} (rtol/atol 1e-3) [{card_line}]")


def llm_zoo_phase(torch, card_line):
    """The reference's last three architectures (ZOO_MODELS) in bf16 at
    their published widths (xLSTM at 1 of 3 periods): each model's prefill at B=4 over 512 positions with
    its flash calls held against the plain version on their own inputs and
    the launches counted (set to 0 just before, read just after); its
    prefill time; MusicGen and xLSTM served 4 x 512 x 32 tokens (launches
    counted, one capture), InternVL2 two graphed decode steps; the graphed
    decode per token; graphed == eager decode bit for bit; the prefill-to-
    decode handover; one xLSTM period in fp32 against the CPU.  Returns
    ({arch: flash launches in its prefill}, max |kernel - plain|)."""
    from repro_torch.launch import serve, steps
    from repro_torch.models import zoo
    t_phase = time.perf_counter()
    launches_by_model, worst = {}, 0.0
    for arch, want, dh, depth in ZOO_MODELS:
        t0 = time.perf_counter()
        cfg = attn_model(arch, depth)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params = zoo.init_params(
            cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
        batch = zoo_prompt_batch(torch, cfg, LLM_PROMPT, 0)
        prefill = steps.make_prefill_step(cfg)
        torch.cuda.synchronize()
        reset_launches()
        (logits, cache), seen = kernel_inputs_of(
            lambda: prefill(params, batch))
        torch.cuda.synchronize()
        launches = read_launches()
        expect_launches(launches, {"flash_attn_fwd": want},
                        f"{arch} prefill (B={LLM_B}, {LLM_PROMPT} "
                        f"positions)")
        calls = seen["flash_attn_fwd"]
        check(len(calls) == want, f"{arch}: {len(calls)} flash calls, not "
                                  f"{want}")
        dims = {q.shape[-1] for (q, _, _), _ in calls}
        check(dims == ({dh} if want else set()),
              f"{arch}: flash calls at head dims {dims}")
        err, _, o_max = path_inputs_check(torch, seen)
        err = err["flash_attn_fwd"]
        del seen, calls
        worst = max(worst, err)
        launches_by_model[arch] = launches["flash_attn_fwd"]
        shape = (LLM_B, cfg.num_codebooks, cfg.vocab_size) \
            if cfg.modality == "audio_tokens" else (LLM_B, cfg.vocab_size)
        check(logits.shape == shape and bool(torch.isfinite(logits).all()),
              f"{arch}: prefill logits {tuple(logits.shape)}, finite "
              f"{bool(torch.isfinite(logits).all())}")
        del logits, cache
        prefill_ms = timed_host(torch, lambda: prefill(params, batch),
                                reps=2)
        served = ""
        if cfg.modality == "vlm":
            # the reference serves no VLM: two graphed decode steps
            logits, cache = prefill(params, batch)
            cache = zoo.pad_cache(cache, 2)
            decode = steps.make_decode_step(cfg)
            for t in range(2):
                tok = torch.argmax(logits, dim=-1)[:, None]
                logits, cache = decode(params, {
                    "tokens": tok, "cache_len": LLM_PROMPT + t}, cache)
                check(logits.shape == (LLM_B, cfg.vocab_size)
                      and bool(torch.isfinite(logits).all()),
                      f"{arch}: decode step {t} logits not finite")
            del logits, cache, decode
            served = "two graphed decode steps, logits finite"
        else:
            ids = batch.get("tokens", batch.get("tokens_mc"))
            ids = ids if ids.ndim == 2 else ids[..., 0]
            log = []
            torch.cuda.synchronize()
            reset_launches()
            t1 = time.perf_counter()
            gen = serve.serve_batch(cfg, params, ids, LLM_GEN,
                                    trace_log=log)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            serve_launches = read_launches()
            check(gen.shape == (LLM_B, LLM_GEN) and int(gen.min()) >= 0
                  and int(gen.max()) < cfg.vocab_size and len(log) == 1,
                  f"{arch}: served {tuple(gen.shape)}, ids in "
                  f"[{int(gen.min())}, {int(gen.max())}], {len(log)} "
                  f"captures")
            expect_launches(serve_launches, {"flash_attn_fwd": want},
                            f"{arch} serve_batch (one prefill, "
                            f"{LLM_GEN - 1} graphed decode steps)")
            served = (f"served {LLM_B} x {LLM_PROMPT} x {LLM_GEN} tokens in "
                      f"{wall:.3f} s, flash_attn_fwd launched "
                      f"{serve_launches['flash_attn_fwd']} times (the "
                      f"decode steps none), one capture, sample "
                      f"{gen[0, :8].tolist()}")
        d_wall, d_dev = graphed_decode_ms(torch, cfg, params, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        leaves = zoo_graph_check(torch, cfg, params, batch)
        gap, h_top = zoo_handover_check(torch, cfg, params, 3)
        what = f"{cfg.num_layers} layers, d_model {cfg.d_model}, " \
               f"{zoo.param_count(cfg)} parameters"
        kern = (f"flash_attn_fwd {launches['flash_attn_fwd']} times at Dh "
                f"{sorted(dims)}, each == plain on its inputs, max |kernel - "
                f"plain| {err:.3g} (max |o| {o_max:.3g}, bar {BF16_BAR})"
                if want else "no kernel (every launch counter 0)")
        print(f"llm zoo: {arch} (bf16, {what}): prefill B={LLM_B} over "
              f"{LLM_PROMPT} positions launched {kern}; prefill "
              f"{prefill_ms:.3f} ms; {served}; graphed decode per token "
              f"{d_wall:.3f} ms wall, {d_dev:.3f} ms device (CUDA events); "
              f"peak memory {peak:.2f} GiB; {ZOO_STEPS} graphed decode "
              f"steps == eager bit for bit (ids, logits, {leaves} cache "
              f"leaves, one capture); prefill {LLM_PROMPT} + one decode "
              f"step vs prefill {LLM_PROMPT + 1}: max |diff| in fp32 (the "
              f"same weights) {gap['fp32']:.3g}, in bf16 {gap['bf16']:.3g} "
              f"(the bf16 prefill's deviation from fp32 {gap['noise']:.3g}, "
              f"largest logit {h_top:.3g}); "
              f"{time.perf_counter() - t0:.1f} s [{card_line}]")
        del params, prefill, batch
        torch.cuda.empty_cache()
    xlstm_fp32_check(torch, card_line)
    torch.cuda.empty_cache()
    print(f"llm zoo: the phase {time.perf_counter() - t_phase:.1f} s "
          f"[{card_line}]")
    return launches_by_model, worst


# ---------------------------------------------------------------------------
# 9. LLM training: the attention blocks' train mode
# ---------------------------------------------------------------------------

def lse_and_backward_check(torch, card_line):
    """flash_attn_fwd's logsumexp on the train path's shapes (LSE_CASES):
    lse against the plain version's, o with the lse written == o without it
    bit for bit; then the attention backward on the card (flash_attn_bwd
    from the kernel's (o, lse)) against the plain path (`ref.flash_bwd_ref`
    from the plain forward's (o, lse)), within BF16_BAR of the largest
    |gradient|, and autograd through `attention.blockwise_attention` on the
    card == the kernel's backward bit for bit.  Returns max |lse kernel -
    plain|."""
    from repro_torch.kernels import flash_attention, ref
    from repro_torch.models import attention
    lse_worst = 0.0
    for label, (B, S, H, KV, Dh), dname in LSE_CASES:
        dtype = getattr(torch, dname)
        q, k, v = qkv_inputs(torch, B, S, H, KV, Dh, dtype, S + Dh + 1)
        do = qkv_inputs(torch, B, S, H, H, Dh, dtype, 3)[0]
        o_plain, lse_plain = ref.attention_ref(q, k, v, causal=True,
                                               lse=True)
        o_only = flash_attention.flash_attn_fwd(q, k, v, causal=True)
        o_k, lse_k = flash_attention.flash_attn_fwd(q, k, v, causal=True,
                                                    lse=True)
        torch.cuda.synchronize()
        check(torch.equal(o_only, o_k),
              f"{label}: o with the lse written differs from o without it")
        check(lse_k.shape == (B, S, H) and lse_k.dtype == torch.float32,
              f"{label}: lse {tuple(lse_k.shape)} {lse_k.dtype}")
        err_lse = float((lse_k - lse_plain).abs().max())
        check(err_lse <= LSE_BAR, f"{label}: |lse kernel - plain| "
                                  f"{err_lse} > {LSE_BAR}")
        lse_worst = max(lse_worst, err_lse)
        kw = dict(causal=True, window=0, q_offset=0)
        g_k = flash_attention.flash_attn_bwd(q, k, v, o_k, lse_k, do, **kw)
        g_p = ref.flash_bwd_ref(q, k, v, o_plain, lse_plain, do,
                                block_q=512, block_k=512, **kw)
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = attention.blockwise_attention(qs, ks, vs, causal=True)
        g_a = torch.autograd.grad(out, (qs, ks, vs), do)
        torch.cuda.synchronize()
        errs = []
        for name, a, b, c in zip("qkv", g_k, g_p, g_a):
            top = float(b.float().abs().max())
            err = float((a.float() - b.float()).abs().max())
            check(err <= BF16_BAR * top,
                  f"{label}: d{name} on the card differs from the plain "
                  f"path's by {err} > {BF16_BAR} x {top}")
            check(torch.equal(a, c), f"{label}: autograd's d{name} through "
                                     f"blockwise_attention != "
                                     f"flash_attn_bwd's")
            errs.append(err / top)
        print(f"llm train: {label} {(B, S, H, KV, Dh)} {dtype}: lse == "
              f"plain within {err_lse:.3g} (bar {LSE_BAR}), o with lse == o "
              f"without bit for bit; (dq, dk, dv) of the kernels' forward "
              f"and backward vs the plain forward's and backward's within "
              f"{max(errs):.3g} of the largest (bar {BF16_BAR}), autograd "
              f"through blockwise_attention == flash_attn_bwd bit for bit "
              f"[{card_line}]")
        del q, k, v, do, o_only, o_k, lse_k, g_k, g_p, g_a, out, o_plain
        del lse_plain
        torch.cuda.empty_cache()
    return lse_worst


def flash_bwd_check(torch, card_line):
    """flash_attn_bwd against its plain version `ref.flash_bwd_ref` on the
    same (q, k, v, o, lse, do) (BWD_CASES: the two StarCoder2 cells'
    shapes, each other head dim, a window, q_offset, ragged Sq and Sk, the
    fp32 instance), within BWD_BF16_ULP of |plain| + BWD_BF16_ABS of max
    |plain| in bf16 and FP32_BAR of max |plain| in fp32, entry by entry;
    a second launch
    on the same inputs == the first bit for bit; one launch counted a call;
    the kernel's ms (CUDA events) beside its bound (2.5x the forward's 4 Dh
    flops a kept pair and head at 989 TFLOP/s) and the plain version's.
    Returns {case: {ms, bound_ms, plain_ms}}."""
    return {label: flash_bwd_case(torch, card_line, label, shape, dname)
            for label, shape, dname in BWD_CASES}


def flash_bwd_case(torch, card_line, label, shape, dname, scale=None):
    """`flash_bwd_check` on one case, (B, Sq, Sk, H, KV, Dh, window,
    q_offset) in `dname`, at the softmax `scale` (None: 1/sqrt(Dh)).
    Returns {ms, bound_ms, plain_ms}."""
    from repro_torch.kernels import flash_attention, ref
    B, Sq, Sk, H, KV, Dh, window, q_offset = shape
    dtype = getattr(torch, dname)
    rng = np.random.default_rng(Sq + Sk + Dh)
    q, do = (torch.from_numpy(rng.normal(size=(B, Sq, H, Dh)).astype(
        np.float32)).to(DEV).to(dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(B, Sk, KV, Dh)).astype(
        np.float32)).to(DEV).to(dtype) for _ in range(2))
    kw = dict(causal=True, window=window, q_offset=q_offset, scale=scale)
    o, lse = flash_attention.flash_attn_fwd(q, k, v, lse=True, **kw)
    before = read_launches()["flash_attn_bwd"]
    got = flash_attention.flash_attn_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attention.flash_attn_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    check(read_launches()["flash_attn_bwd"] == before + 2,
          f"{label}: two backward calls counted "
          f"{read_launches()['flash_attn_bwd'] - before} launches")
    want = ref.flash_bwd_ref(q, k, v, o, lse, do, block_q=512,
                             block_k=512, **kw)
    worst = []
    for name, a, a2, w in zip(("dq", "dk", "dv"), got, again, want):
        check(a.dtype == w.dtype and a.shape == w.shape,
              f"{label}: {name} {a.dtype} {tuple(a.shape)}")
        check(torch.equal(a, a2), f"{label}: two launches' {name} differ")
        a, w = a.float(), w.float()
        top = float(w.abs().max())
        err = (a - w).abs()
        bar = BWD_BF16_ULP * w.abs() + BWD_BF16_ABS * top \
            if dname == "bfloat16" else FP32_BAR * top
        over = int((err > bar).sum())
        check(over == 0, f"{label}: {over} entries of {name} beyond the "
                         f"bar, max |kernel - plain| {float(err.max())} "
                         f"of max |plain| {top}")
        worst.append(float(err.max()) / top)
    del got, again, want
    k_ms = cuda_ms(torch, lambda: flash_attention.flash_attn_bwd(
        q, k, v, o, lse, do, **kw), reps=10, warmup=2)
    p_ms = cuda_ms(torch, lambda: ref.flash_bwd_ref(
        q, k, v, o, lse, do, block_q=512, block_k=512, **kw),
        reps=1, warmup=0)
    rows_q = np.arange(Sq)[:, None] + q_offset
    cols = np.arange(Sk)[None, :]
    keep = (cols <= rows_q) & ((rows_q - cols < window) if window
                               else True)
    pairs = int(keep.sum()) * B * H
    bound = 2.5 * 4 * Dh * pairs / H100_BF16_FLOPS * 1e3
    row = {"ms": k_ms, "bound_ms": bound, "plain_ms": p_ms}
    print(f"llm train: flash_attn_bwd {label} (B, Sq, Sk, H, KV, Dh) = "
          f"{(B, Sq, Sk, H, KV, Dh)} window={window} q_offset="
          f"{q_offset} scale={'1/sqrt(Dh)' if scale is None else scale}"
          f" {dname}: dq, dk, dv == ref.flash_bwd_ref within "
          f"the bar (largest |kernel - plain| / max |plain| "
          f"{max(worst):.3g}), two launches bit for bit, one counted a "
          f"call; {k_ms:.4f} ms (CUDA events), bound {bound:.4f} ms "
          f"({100 * bound / k_ms:.1f}%), plain {p_ms:.3f} ms "
          f"[{card_line}]")
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    return row


def lm_batches_on(torch, cfg, B, S, steps, seed):
    """(steps, B, S) token ids of `data/tokens.markov_stream` and their
    next-token labels, on the card."""
    from repro_torch.data import tokens
    toks = tokens.markov_stream(cfg.vocab_size, steps * B * (S + 1),
                                seed=seed).reshape(steps, B, S + 1)
    t = torch.from_numpy(toks.astype(np.int64)).to(DEV)
    return {"tokens": t[..., :-1].contiguous(),
            "labels": t[..., 1:].contiguous()}


def llm_card_vs_cpu(torch, card_line):
    """Llama-3.2-1B at full width, LLM_TRAIN_CPU_LAYERS layers, fp32: one
    set of seeded weights on the card and on the CPU; the loss and every
    gradient leaf of `zoo.loss_and_metrics` (the card's through the flash
    kernel, the CPU's through the plain version) within the INL step's bar
    (`grads_close`), then one `make_train_step` (SGD) on each: the loss and
    grad_norm within rtol 1e-3."""
    import dataclasses
    from repro_torch import optim, tree_leaves, tree_map, value_and_grad
    from repro_torch.launch import steps
    from repro_torch.models import zoo
    cfg = dataclasses.replace(attn_model("llama3.2-1b",
                                         LLM_TRAIN_CPU_LAYERS),
                              dtype="float32")
    cpu = zoo.init_params(cfg, 11, device="cpu")
    gpu = tree_map(lambda t: t.to(DEV), cpu)
    B, S = LLM_TRAIN_CPU_BATCH
    batch = lm_batches_on(torch, cfg, B, S, 1, 12)
    batch = {k: v[0] for k, v in batch.items()}
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    reset_launches()
    l_gpu, _, g_gpu = value_and_grad(
        lambda p: zoo.loss_and_metrics(p, cfg, batch), gpu)
    torch.cuda.synchronize()
    launches = read_launches()["flash_attn_fwd"]
    check(launches == 2 * LLM_TRAIN_CPU_LAYERS,
          f"card-vs-cpu: {launches} flash launches, not a forward and a "
          f"recompute a layer")
    bwd = read_launches()["flash_attn_bwd"]
    check(bwd == LLM_TRAIN_CPU_LAYERS,
          f"card-vs-cpu: {bwd} flash_attn_bwd launches, not one a layer")
    l_cpu, _, g_cpu = value_and_grad(
        lambda p: zoo.loss_and_metrics(p, cfg, cpu_batch), cpu)
    max_leaf, max_abs, off = grads_close(float(l_gpu), float(l_cpu),
                                         tree_leaves(g_gpu),
                                         tree_leaves(g_cpu), "llama train")
    del g_gpu, g_cpu
    sgd = optim.sgd(1e-2)
    step = steps.make_train_step(cfg, sgd)
    got = {}
    for dev, p, b in (("cpu", cpu, cpu_batch), (DEV, gpu, batch)):
        _, _, m = step(p, sgd.init(p), b)
        got[dev] = (float(m["loss"]), float(m["grad_norm"]))
    check(np.allclose(got[DEV], got["cpu"], rtol=1e-3, atol=0),
          f"llama train step card {got[DEV]} vs cpu {got['cpu']}")
    print(f"llm train: Llama-3.2-1B at full width, {LLM_TRAIN_CPU_LAYERS} "
          f"layers, fp32, B={B} S={S}: loss card {float(l_gpu):.7f} cpu "
          f"{float(l_cpu):.7f}, {launches} flash launches (a forward and a "
          f"recompute a layer), {bwd} flash_attn_bwd (fp32); every "
          f"gradient leaf within rtol 1e-3 atol 1e-5 as a tensor, largest "
          f"|card - cpu| / |cpu| of a leaf "
          f"{max_leaf:.3g}, largest entry difference {max_abs:.3g} ({off} "
          f"entries outside the bar entry by entry); one make_train_step "
          f"(SGD): loss, grad_norm card {got[DEV]} cpu {got['cpu']} "
          f"[{card_line}]")


def deepseek_train_check(torch, card_line):
    """DeepSeek-V2-236B in bf16 at its published widths cut to 2 layers
    (the dense layer 0 and one MoE layer, ~5.4 B parameters): one
    `loss_and_metrics` forward and backward at B=1, S=2048 (no optimizer
    step: AdamW's fp32 state would add ~64 GB); ce, lb_loss, z_loss and
    every gradient finite; flash_attn_fwd launched exactly 3 times at
    Dh=192 (the pre-layer, then the period and its recompute).  Returns
    (launches, ms)."""
    from repro_torch import tree_leaves, value_and_grad
    from repro_torch.models import zoo
    t0 = time.perf_counter()
    cfg = attn_model("deepseek-v2-236b", 2)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = zoo.init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                             device=DEV)
    batch = lm_batches_on(torch, cfg, 1, LLM_TRAIN_BATCH[1], 1, 5)
    batch = {k: v[0] for k, v in batch.items()}
    torch.cuda.synchronize()
    reset_launches()
    (_, metrics, grads), seen = kernel_inputs_of(lambda: value_and_grad(
        lambda p: zoo.loss_and_metrics(p, cfg, batch), params))
    torch.cuda.synchronize()
    launches = read_launches()
    expect_launches(launches, {"flash_attn_fwd": 3, "flash_attn_bwd": 2},
                    "DeepSeek-V2 2 layers, one forward and backward")
    dims = {q.shape[-1] for (q, _, _), _ in seen["flash_attn_fwd"]}
    check(dims == {MLA_DH}, f"DeepSeek-V2 train: flash calls at {dims}")
    del seen
    vals = {k: float(metrics[k].detach())
            for k in ("ce", "lb_loss", "z_loss", "loss")}
    check(all(np.isfinite(list(vals.values()))),
          f"DeepSeek-V2 train metrics {vals}")
    leaves = tree_leaves(grads)
    finite = all(bool(torch.isfinite(g).all()) for g in leaves)
    check(finite, "DeepSeek-V2 train: a gradient is not finite")
    del grads, leaves
    ms = cuda_ms(torch, lambda: value_and_grad(
        lambda p: zoo.loss_and_metrics(p, cfg, batch), params),
        reps=1, warmup=0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"llm train: DeepSeek-V2-236B (bf16, 2 of 60 layers: dense layer "
          f"0 and one MoE layer, {zoo.param_count(cfg)} parameters) "
          f"loss_and_metrics forward and backward at B=1 S="
          f"{LLM_TRAIN_BATCH[1]}: {vals}, every gradient finite; "
          f"flash_attn_fwd launched {launches['flash_attn_fwd']} times at "
          f"Dh {sorted(dims)}, flash_attn_bwd {launches['flash_attn_bwd']} "
          f"(one a layer); {ms:.1f} ms (CUDA events); peak memory "
          f"{peak:.2f} GiB (no MoE config fits one card with AdamW's state "
          f"at full width); {time.perf_counter() - t0:.1f} s [{card_line}]")
    del params, batch
    torch.cuda.empty_cache()
    return launches["flash_attn_fwd"], ms


def ssd_train_check(torch, card_line):
    """The SSD scan's autograd Function (`ssm._ssd_chunked`) on the card,
    on SSD_TRAIN_CASES in fp32 and bf16: the forward == `ops.ssd_scan`
    (the kernel) bit for bit; the backward against autograd through the
    plain `ssd_chunked_ref` on the card, recomputed in fp32: fp32 bit for
    bit, bf16 (the kernel's bf16 forward, bf16 gradients) within BF16_BAR
    of the largest |gradient|; the plain backward's ms a call (CUDA
    events: the fp32 recompute and its autograd, which is what the
    Function's backward runs) and the memory it holds beyond its inputs.
    The draws' dt |a| summed over a chunk passes the ~88 at which exp
    overflows above the diagonal: every gradient must be finite (the
    reference's arithmetic gives NaN there; the port masks before the
    exp).  Returns {case: backward ms}."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import ssm
    bwd_ms = {}
    for label, (B, S, H, P, N, L) in SSD_TRAIN_CASES:
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            ins = ssd_inputs(torch, B, S, H, P, N, dtype, S + N + 3)
            gen = torch.Generator(device=DEV).manual_seed(S + 1)
            gy = torch.randn((B, S, H, P), generator=gen,
                             device=DEV).to(dtype)
            gs = torch.randn((B, H, N, P), generator=gen, device=DEV)
            leaves = [t.clone().requires_grad_(True) for t in ins]
            dA = (ins[1] * ins[2]).reshape(B, S // L, L, H).sum(dim=2)
            worst = float(-dA.min())
            out = ssm._ssd_chunked(*leaves, chunk=L)
            want = ops.ssd_scan(*ins, chunk=L)
            check(torch.equal(out[0], want[0])
                  and torch.equal(out[1], want[1]),
                  f"SSD Function {label} {dname}: forward != ssd_scan")
            del want
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            grads = torch.autograd.grad(out, leaves, (gy, gs))
            torch.cuda.synchronize()
            held = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            del out
            f32 = [t.detach().float().requires_grad_(True) for t in ins]

            def plain_bwd():
                outs = ref.ssd_chunked_ref(*f32, chunk=L)
                return torch.autograd.grad(outs, f32, (gy.float(), gs))
            plain = plain_bwd()
            errs = []
            for name, g, w in zip(("x", "dt", "a", "bm", "cm", "dskip"),
                                  grads, plain):
                check(g.dtype == ins[len(errs)].dtype,
                      f"SSD Function: d{name} in {g.dtype}")
                check(bool(torch.isfinite(g).all()),
                      f"SSD Function {label} {dname}: d{name} not finite")
                if dtype == torch.float32:
                    check(torch.equal(g, w), f"SSD Function {label}: fp32 "
                                             f"d{name} != autograd through "
                                             f"ssd_chunked_ref")
                    errs.append(0.0)
                else:
                    top = float(w.abs().max())
                    err = float((g.float() - w).abs().max())
                    check(err <= BF16_BAR * top,
                          f"SSD Function {label}: bf16 d{name} {err} > "
                          f"{BF16_BAR} x {top}")
                    errs.append(err / top)
            del grads, plain
            ms = cuda_ms(torch, plain_bwd, reps=3, warmup=1)
            if dtype == torch.float32:
                bwd_ms[label] = ms
            print(f"llm train: SSD Function {label} (B, S, H, P, N, chunk) "
                  f"= {(B, S, H, P, N, L)} {dname}: forward == ssd_scan bit "
                  f"for bit; backward "
                  + ("== autograd through ssd_chunked_ref bit for bit"
                     if dtype == torch.float32 else
                     f"within {max(errs):.3g} of the largest |gradient| of "
                     f"the plain fp32 one (bar {BF16_BAR})")
                  + f", every gradient finite at a chunk's dt |a| up to "
                    f"{worst:.1f}; the plain backward (fp32 recompute + "
                    f"autograd) {ms:.3f} ms a call, {held:.2f} GiB held "
                    f"beyond its inputs [{card_line}]")
            del ins, leaves, f32, gy, gs
            torch.cuda.empty_cache()
    return bwd_ms


def zamba2_7b_check(torch, card_line):
    """The kernels at the shapes of the cell zamba2-7b.lm-2x4096, on the
    card.  flash_attn_fwd at ZAMBA7_ATTN and ZAMBA7_SCALE, bf16, against
    `ref.attention_ref` at that scale, entry by entry within the backward's
    bf16 bar (both round each output once from fp32, so one ulp, 2^-7 of
    the value, where the two straddle a midpoint; P enters the kernel's
    products as bf16 hi + lo and its fp32 sums run in another order,
    2^-12 of the largest), its lse within LSE_BAR; flash_attn_bwd there
    (`flash_bwd_case`, the same bar); the grouped bf16 ssd_scan at
    ZAMBA7_SSD against `ref.ssd_chunked_ref` on the same bf16 inputs, y
    and the final state within BF16_BAR of the plain maximum (the bar of
    tests/test_kernels.py: the kernel rounds C.B^T, the decays and the
    chunk states to bf16 before its tensor-core products, about 2^-8 of
    each, where the plain version stays fp32).  Each kernel's ms (CUDA
    events) beside its bound.  Then one step of the 12-layer stage at
    ZAMBA7_BATCH through `make_scan_train_step`, its counters zeroed just
    before: flash_attn_fwd 2 a hybrid (the forward and the recompute),
    flash_attn_bwd 1 a hybrid, ssd_scan 2 a Mamba2 mixer (every layer has
    one), and 1 `ssd_scan_bwd` a mixer.  Returns {kernel: {ms,
    bound_ms}}."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention, ref, ssm_scan
    from repro_torch.models import ssm
    rows = {}
    bf16 = torch.bfloat16
    B, S, H, KV, Dh = ZAMBA7_ATTN
    q, k, v = qkv_inputs(torch, B, S, H, KV, Dh, bf16, 7)
    kw = dict(causal=True, scale=ZAMBA7_SCALE)
    got, lse = flash_attention.flash_attn_fwd(q, k, v, lse=True, **kw)
    want, want_lse = ref.attention_ref(q, k, v, lse=True, **kw)
    got, want = got.float(), want.float()
    top = float(want.abs().max())
    err = (got - want).abs()
    over = int((err > BWD_BF16_ULP * want.abs() + BWD_BF16_ABS * top).sum())
    check(over == 0, f"zamba2-7b flash_attn_fwd: {over} entries beyond the "
                     f"bar, max |kernel - plain| {float(err.max())} of max "
                     f"|plain| {top}")
    lse_err = float((lse - want_lse).abs().max())
    check(lse_err <= LSE_BAR, f"zamba2-7b flash_attn_fwd: lse off by "
                              f"{lse_err} > {LSE_BAR}")
    del got, want, lse, want_lse, err
    ms = cuda_ms(torch, lambda: flash_attention.flash_attn_fwd(q, k, v,
                                                               **kw),
                 reps=10, warmup=2)
    flops, nbytes = attn_cost(torch, B, S, H, KV, Dh, bf16)
    bound, by = bound_of(flops, nbytes, BF16_FLOPS)
    rows["flash_attn_fwd"] = {"ms": ms, "bound_ms": bound}
    print(f"zamba2-7b: flash_attn_fwd (B, S, H, KV, Dh) = {ZAMBA7_ATTN} "
          f"scale {ZAMBA7_SCALE:.6f} bf16 == ref.attention_ref within the "
          f"bar, lse within {lse_err:.3g}; {ms:.4f} ms (CUDA events), bound "
          f"{bound:.4f} ms by {by} ({100 * bound / ms:.1f}%) [{card_line}]")
    del q, k, v
    torch.cuda.empty_cache()
    rows["flash_attn_bwd"] = flash_bwd_case(
        torch, card_line, "zamba2-7b", (B, S, S, H, KV, Dh, 0, 0),
        "bfloat16", scale=ZAMBA7_SCALE)

    B, S, H, P, N, G, L = ZAMBA7_SSD
    x, dt, a, _, _, d = ssd_inputs(torch, B, S, H, P, N, bf16, 8)
    rng = np.random.default_rng(9)
    bm, cm = (torch.from_numpy(rng.normal(size=(B, S, G, N)).astype(
        np.float32)).to(DEV).to(bf16) for _ in range(2))
    y, st = ssm_scan.ssd_scan(x, dt, a, bm, cm, d, chunk=L)
    y_ref, st_ref = ref.ssd_chunked_ref(x, dt, a, bm, cm, d, chunk=L)
    errs = {what: rel_err(g, w) for what, g, w in (("y", y, y_ref),
                                                   ("state", st, st_ref))}
    for what, e in errs.items():
        check(e <= BF16_BAR, f"zamba2-7b ssd_scan {what} off the plain by "
                             f"{e} of its max > {BF16_BAR}")
    del y, st, y_ref, st_ref
    ms = cuda_ms(torch, lambda: ssm_scan.ssd_scan(x, dt, a, bm, cm, d,
                                                  chunk=L),
                 reps=10, warmup=2)
    flops, nbytes = ssd_cost(torch, B, S, H, P, N, L, bf16, groups=G)
    bound, by = bound_of(flops, nbytes, BF16_FLOPS)
    rows["ssd_scan"] = {"ms": ms, "bound_ms": bound}
    print(f"zamba2-7b: ssd_scan (B, S, H, P, N, G, chunk) = {ZAMBA7_SSD} "
          f"bf16 == ref.ssd_chunked_ref, y and state within "
          f"{max(errs.values()):.3g} of the plain max (bar {BF16_BAR}); "
          f"{ms:.4f} ms (CUDA events), bound {bound:.4f} ms by {by} "
          f"({100 * bound / ms:.1f}%) [{card_line}]")
    del x, dt, a, bm, cm, d
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config("zamba2-7b"),
                              num_layers=ZAMBA7_LAYERS, dtype="bfloat16")
    hybrids = cfg.block_pattern.count("hybrid") * (
        ZAMBA7_LAYERS // len(cfg.block_pattern))
    ssm.LAUNCHES["ssd_scan_bwd"] = 0
    launches, _ = train_run(
        torch, cfg, *ZAMBA7_BATCH, 1, "zamba2-7b 12-layer stage",
        card_line, want={"flash_attn_fwd": 2 * hybrids,
                         "flash_attn_bwd": hybrids,
                         "ssd_scan": 2 * ZAMBA7_LAYERS},
        time_steps=False, falling=False)
    n_bwd = ssm.LAUNCHES["ssd_scan_bwd"]
    check(n_bwd == ZAMBA7_LAYERS, f"zamba2-7b: {n_bwd} ssd_scan_bwd, not one "
                                  f"a Mamba2 mixer")
    print(f"zamba2-7b: one step of the {ZAMBA7_LAYERS}-layer stage launched "
          f"{_nonzero(launches)} and {n_bwd} ssd_scan_bwd ({hybrids} hybrids,"
          f" {ZAMBA7_LAYERS} Mamba2 mixers) [{card_line}]")
    return rows


def loss_close(l_gpu, l_cpu, what):
    check(abs(l_gpu - l_cpu) <= LOSS_RTOL * abs(l_cpu),
          f"{what}: loss card {l_gpu} vs cpu {l_cpu} (rtol {LOSS_RTOL})")


def zoo_card_vs_cpu(torch, cfg, B, S, what, card_line):
    """One set of seeded fp32 weights of `cfg` on the card and on the CPU:
    `zoo.loss_and_metrics`' loss within LOSS_RTOL and every gradient leaf
    within the INL step's bar (`grads_close`).  Returns the card's
    launches."""
    from repro_torch import tree_leaves, tree_map, value_and_grad
    from repro_torch.models import zoo
    cpu = zoo.init_params(cfg, 13, device="cpu")
    gpu = tree_map(lambda t: t.to(DEV), cpu)
    batch = {k: v[0] for k, v in lm_batches_on(torch, cfg, B, S, 1,
                                                14).items()}
    reset_launches()
    l_gpu, _, g_gpu = value_and_grad(
        lambda p: zoo.loss_and_metrics(p, cfg, batch), gpu)
    torch.cuda.synchronize()
    launches = read_launches()
    l_cpu, _, g_cpu = value_and_grad(
        lambda p: zoo.loss_and_metrics(
            p, cfg, {k: v.cpu() for k, v in batch.items()}), cpu)
    loss_close(float(l_gpu), float(l_cpu), what)
    max_leaf, max_abs, off = grads_close(float(l_gpu), float(l_cpu),
                                         tree_leaves(g_gpu),
                                         tree_leaves(g_cpu), what)
    print(f"llm train: {what}, fp32, B={B} S={S}: loss card "
          f"{float(l_gpu):.7f} cpu {float(l_cpu):.7f} (rtol {LOSS_RTOL}); "
          f"every gradient leaf within rtol 1e-3 atol 1e-5 as a tensor, "
          f"largest |card - cpu| / |cpu| of a leaf {max_leaf:.3g}, largest "
          f"entry difference {max_abs:.3g} ({off} entries outside the bar "
          f"entry by entry); launches {_nonzero(launches)} [{card_line}]")
    return launches


def train_run(torch, cfg, B, S, n_steps, what, card_line, *, want,
              time_steps=True, falling=True):
    """`cfg` at B x S: `make_scan_train_step` with
    `default_optimizer(cfg, total_steps=n_steps)` over n_steps Markov
    batches, launches set to 0 just before and read just after (== `want`
    and the in-place AdamW's `adamw_launches(n_steps)`);
    every loss finite and, with falling, the last below the first; the
    steps' ms (CUDA events) and peak memory; with time_steps, one step's
    ms (median of 3 `make_train_step` calls) and tokens/s, else the
    scan's ms a step.  Returns (launches, {metric: value})."""
    from repro_torch.launch import steps
    from repro_torch.models import zoo
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = zoo.init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                             device=DEV)
    opt = steps.default_optimizer(cfg, total_steps=n_steps)
    opt_state = opt.init(params)
    batches = lm_batches_on(torch, cfg, B, S, n_steps, 0)
    epoch = steps.make_scan_train_step(cfg, opt)
    torch.cuda.synchronize()
    reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    params, opt_state, ms = epoch(params, opt_state, batches)
    end.record()
    torch.cuda.synchronize()
    launches = read_launches()
    epoch_ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = ms["loss"].tolist()
    expect_launches(launches, {**want, **adamw_launches(n_steps)},
                    f"{what}, {n_steps} train steps")
    check(all(np.isfinite(losses)) and (losses[-1] < losses[0]
                                        or not falling),
          f"{what} train losses {losses}")
    check(bool(torch.isfinite(ms["grad_norm"]).all()),
          f"{what} grad_norm {ms['grad_norm'].tolist()}")
    step_ms = epoch_ms / n_steps
    if time_steps:
        step = steps.make_train_step(cfg, opt)
        batch = {k: v[0] for k, v in batches.items()}
        box = [params, opt_state]

        def one():
            box[0], box[1], _ = step(box[0], box[1], batch)
        step_ms = statistics.median(cuda_ms(torch, one, reps=1, warmup=0)
                                    for _ in range(3))
        params, opt_state = box
        del box, batch
    tok_s = B * S / (step_ms / 1e3)
    print(f"llm train: {what} ({cfg.dtype}, {zoo.param_count(cfg)} "
          f"parameters, remat {'on' if cfg.remat else 'off'}) "
          f"make_scan_train_step over {n_steps} Markov batches of B={B} "
          f"S={S}, default_optimizer: losses "
          f"{[round(x, 4) for x in losses]}; launches {_nonzero(launches)}; "
          f"the {n_steps} steps {epoch_ms:.1f} ms (CUDA events); a step "
          f"{step_ms:.1f} ms ("
          + ("median of 3 make_train_step calls" if time_steps
             else "the scan's mean") + "), "
          + f"{tok_s:.0f} tokens/s; peak "
          f"memory {peak:.2f} GiB (the scan), "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB with the "
          f"timed steps; {time.perf_counter() - t0:.1f} s [{card_line}]")
    del params, opt_state, batches
    torch.cuda.empty_cache()
    return launches, {"step_ms": step_ms, "tokens_per_s": tok_s,
                      "peak_gib": peak, "epoch_ms": epoch_ms}


def zamba_train_check(torch, card_line):
    """Zamba2-2.7B at its published widths cut to ZAMBA_TRAIN_PERIODS of
    its 9 periods, bf16, trained ZAMBA_TRAIN_STEPS steps: ssd_scan exactly
    twice a mamba layer a step (the forward and the period's recompute;
    the Function's backward recomputes in plain torch) and flash_attn_fwd
    twice a shared-attention call a step; then its fp32 twin at one period
    on the card against the CPU.  Returns (launches, metrics)."""
    import dataclasses
    per = len(zamba2(torch).block_pattern)
    cfg = zamba2(torch, num_layers=ZAMBA_TRAIN_PERIODS * per)
    n_mamba = cfg.num_layers
    n_shared = ZAMBA_TRAIN_PERIODS
    want = {"ssd_scan": 2 * n_mamba * ZAMBA_TRAIN_STEPS,
            "flash_attn_fwd": 2 * n_shared * ZAMBA_TRAIN_STEPS,
            "flash_attn_bwd": n_shared * ZAMBA_TRAIN_STEPS}
    launches, metrics = train_run(
        torch, cfg, *ZAMBA_TRAIN_BATCH, ZAMBA_TRAIN_STEPS,
        f"Zamba2-2.7B at full width, {ZAMBA_TRAIN_PERIODS} of 9 periods "
        f"({n_mamba} of 54 mamba layers, {n_shared} shared-attention "
        f"calls)", card_line, want=want)
    twin = dataclasses.replace(zamba2(torch, num_layers=per),
                               dtype="float32")
    zoo_card_vs_cpu(torch, twin, *ZAMBA_CPU_BATCH,
                    "Zamba2-2.7B at full width, 1 period", card_line)
    return launches, metrics


def xlstm_train_check(torch, card_line):
    """xLSTM-125M at its published widths in bf16 cut to one period (4 of
    its 12 layers: three mLSTM and one sLSTM block), XLSTM_TRAIN_STEPS
    step at B x S = XLSTM_TRAIN_BATCH (one checkpointed 256-step chunk),
    no kernel launched, the loss finite; then its fp32 twin at one period
    and a short S on the card against the CPU.  Returns metrics."""
    import dataclasses
    cfg = attn_model("xlstm-125m", XLSTM_PERIOD)
    _, metrics = train_run(torch, cfg, *XLSTM_TRAIN_BATCH, XLSTM_TRAIN_STEPS,
                           "xLSTM-125M (full width, 1 of 3 periods)",
                           card_line, want={}, time_steps=False,
                           falling=False)
    twin = dataclasses.replace(attn_model("xlstm-125m", XLSTM_PERIOD),
                               dtype="float32")
    zoo_card_vs_cpu(torch, twin, *XLSTM_CPU_BATCH,
                    "xLSTM-125M, 1 period", card_line)
    return metrics


def inl_cfg(cfg, **inl):
    import dataclasses
    return dataclasses.replace(cfg, inl=dataclasses.replace(cfg.inl, **inl))


def inl_llm_train_run(torch, card_line):
    """INL over Llama-3.2-1B at its published widths, num_layers cut to
    INL_LLM_LAYERS (J = 4 encoders of 2 layers, a 1-layer decoder, d_b =
    512), bf16, link_bits INL_LLM_BITS (the packed wire): INL_LLM_STEPS
    steps of `make_scan_train_step(scheme="inl")` drawing from a
    generator, launches set to 0 just before and read just after: one
    cut_fwd, cut_bwd, pack and unpack_dequant a step, flash_attn_fwd a
    forward and a recompute a layer a node and the decoder's; losses
    finite; ms a step and peak memory.  The optimizer is
    `default_optimizer`'s AdamW (its schedule, weight decay and clipping)
    without the fp32 master copy: over 2.14 B parameters the functional
    update holds the old and the new state at once, ~30 B a parameter
    with the master copy, ~26 without, and with the master copy the
    update ran the card out of memory after the script's earlier phases.
    Returns (launches, metrics)."""
    from repro_torch import optim, tree_leaves, value_and_grad
    from repro_torch.core import inl_llm
    from repro_torch.launch import steps
    t0 = time.perf_counter()
    cfg = inl_cfg(attn_model("llama3.2-1b", INL_LLM_LAYERS),
                  link_bits=INL_LLM_BITS)
    J, d_b = cfg.inl.num_nodes, cfg.inl.d_bottleneck
    B, S = INL_LLM_BATCH
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = inl_llm.init(cfg, torch.Generator(device=DEV).manual_seed(0),
                          device=DEV)
    n_params = sum(t.numel() for t in tree_leaves(params))
    opt = optim.adamw(
        optim.warmup_cosine_schedule(3e-4, INL_LLM_STEPS // 10 + 1,
                                     INL_LLM_STEPS),
        weight_decay=0.1, clip_norm=1.0, keep_master=False)
    opt_state = opt.init(params)
    batches = lm_batches_on(torch, cfg, B, S, INL_LLM_STEPS, 3)
    gen = torch.Generator(device=DEV).manual_seed(1)
    epoch = steps.make_scan_train_step(cfg, opt, scheme="inl")
    torch.cuda.synchronize()
    reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    params, opt_state, ms = epoch(params, opt_state, batches, gen)
    end.record()
    torch.cuda.synchronize()
    launches = read_launches()
    epoch_ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    enc_layers = inl_llm.encoder_cfg(cfg).num_layers
    dec_layers = inl_llm.decoder_cfg(cfg).num_layers
    want = {k: INL_LLM_STEPS for k in INL_LLM_KERNELS}
    want["flash_attn_fwd"] = 2 * (J * enc_layers + dec_layers) \
        * INL_LLM_STEPS
    want["flash_attn_bwd"] = (J * enc_layers + dec_layers) * INL_LLM_STEPS
    want.update(adamw_launches(INL_LLM_STEPS))
    expect_launches(launches, want, "INL over Llama-3.2-1B")
    losses = ms["loss"].tolist()
    check(all(np.isfinite(losses)), f"INL over Llama losses {losses}")
    step_ms = epoch_ms / INL_LLM_STEPS
    # the forward and backward alone, without the optimizer's update
    batch = {k: v[0] for k, v in batches.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, _, grads = value_and_grad(
        lambda p: inl_llm.loss_fn(p, cfg, batch, gen), params)
    torch.cuda.synchronize()
    peak_fwd_bwd = torch.cuda.max_memory_allocated() / 2 ** 30
    del grads, batch
    print(f"llm train: INL over Llama-3.2-1B at full width, {J} encoders "
          f"of {enc_layers} layers, a {dec_layers}-layer decoder, d_b={d_b}, "
          f"link_bits={cfg.inl.link_bits} (packed wire), bf16, {n_params} "
          f"parameters: {INL_LLM_STEPS} steps of make_scan_train_step("
          f"scheme='inl') at B={B} S={S}, AdamW (default_optimizer's "
          f"schedule, no fp32 master copy): losses "
          f"{[round(x, 4) for x in losses]}, ce_joint "
          f"{[round(x, 4) for x in ms['ce_joint'].tolist()]}, rate_mean "
          f"{[round(x, 3) for x in ms['rate_mean'].tolist()]}; launches "
          f"{_nonzero(launches)} (one cut layer over all {J} x {B} x {S} "
          f"rows a step); {step_ms:.1f} ms a step (CUDA events, the "
          f"scan's mean), {B * S / step_ms * 1e3:.0f} tokens/s; peak "
          f"memory {peak:.2f} GiB (AdamW's update), a forward and backward "
          f"alone {peak_fwd_bwd:.2f} GiB; "
          f"{time.perf_counter() - t0:.1f} s [{card_line}]")
    del params, opt_state, batches
    torch.cuda.empty_cache()
    return launches, {"step_ms": step_ms, "peak_gib": peak,
                      "peak_fwd_bwd_gib": peak_fwd_bwd}


def adamw_check(torch, card_line):
    """The multi-tensor AdamW (csrc/adamw.cu) on the leaves of the cell
    inl-starcoder2-3b, AdamW as the cell runs it (warm-up cosine, weight
    decay 0.1, clip at 1, an fp32 master): ADAMW_SCAN's K steps of
    `make_scan_train_step(scheme="inl")` (donated, so in place from the
    first step) with one norm and one update launch a step; then, on one
    step's gradients, the kernel's norm within ADAMW_NORM_RTOL of
    `optim.global_norm` (fp64 sums against fp32 sums by leaf), the update
    given the kernel's scale equal to `ref.adamw_update_ref_` bit for bit
    in m, v, the master and the weights, two in-place steps from one state
    equal bit for bit (norms included), and ADAMW_TIMED steps of
    `update_` timed with CUDA events beside the bytes bound (28 bytes a
    parameter and 2 for the norm over 3.35 TB/s), the two launches alone,
    the functional `update` (the plain version) and PyTorch's
    `torch._fused_adamw_` on the fp32 master with fp32 gradients (the
    library's, which the port never calls: no clip, no bf16 weight).
    Returns {metric: value}, "launches" the scan's counts."""
    import dataclasses
    from repro_torch import optim, tree_leaves, tree_map, value_and_grad
    from repro_torch.configs.base import get_config
    from repro_torch.core import inl_llm
    from repro_torch.kernels import adamw, ref
    from repro_torch.launch import steps
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("starcoder2-3b"), num_layers=3)
    params = inl_llm.init(cfg, torch.Generator(device=DEV).manual_seed(0),
                          device=DEV)
    leaves = tree_leaves(params)
    n = sum(t.numel() for t in leaves)
    check(n == ADAMW_PARAMS, f"adamw: {n} parameters, the cell's "
          f"{ADAMW_PARAMS}")
    dtypes = sorted({str(t.dtype) for t in leaves})
    sched = optim.warmup_cosine_schedule(3e-4, 100, 1000)
    opt = optim.adamw(sched, weight_decay=0.1, clip_norm=1.0)
    state = opt.init(params)
    K, B, S = ADAMW_SCAN
    batches = lm_batches_on(torch, cfg, B, S, K, 5)
    gen = torch.Generator(device=DEV).manual_seed(2)
    epoch = steps.make_scan_train_step(cfg, opt, scheme="inl")
    torch.cuda.synchronize()
    before = dict(adamw.LAUNCHES)
    out = epoch(params, state, batches, gen)
    torch.cuda.synchronize()
    launches = {k: adamw.LAUNCHES[k] - before[k] for k in before}
    check(launches == {"adamw_norm": K, "adamw_update": K},
          f"adamw: {K} scan steps launched {launches}")
    check(all(a is b for a, b in zip(tree_leaves((params, state)),
                                     tree_leaves(out[:2]))),
          "adamw: the donated scan call did not update its buffers in place")
    losses = out[2]["loss"].tolist()
    check(all(np.isfinite(losses)), f"adamw: scan losses {losses}")
    del out, batches
    batch = {k: v[0] for k, v in lm_batches_on(torch, cfg, B, S, 1,
                                                 6).items()}
    _, _, grads = value_and_grad(
        lambda p: inl_llm.loss_fn(p, cfg, batch, gen), params)
    grads = tree_leaves(grads)
    norm, scale = adamw.grad_norm(grads, 1.0)
    want = optim.global_norm(grads)
    norm_rel = abs(float(norm) - float(want)) / float(want)
    check(norm_rel <= ADAMW_NORM_RTOL,
          f"adamw: the kernel's norm {float(norm)!r} against global_norm's "
          f"{float(want)!r}: {norm_rel:.3e} of it")
    # the update given the kernel's scale, kernel against the plain version
    twin = tree_map(torch.clone, (params, state))
    for st in (state, twin[1]):
        step = st["step"].add_(1)
        scalars = (sched(step).to(torch.float32),
                   1 - 0.9 ** step.to(torch.float32),
                   1 - 0.95 ** step.to(torch.float32))
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    adamw.adamw_update(grads, tree_leaves(state["m"]),
                       tree_leaves(state["v"]), tree_leaves(state["master"]),
                       leaves, scale, *scalars, **kw)
    ref.adamw_update_ref_(grads, tree_leaves(twin[1]["m"]),
                          tree_leaves(twin[1]["v"]),
                          tree_leaves(twin[1]["master"]),
                          tree_leaves(twin[0]), scale, *scalars, **kw)
    torch.cuda.synchronize()
    differ = sum(int((a != b).sum()) for a, b in
                 zip(tree_leaves((params, state)), tree_leaves(twin)))
    check(differ == 0, f"adamw: {differ} elements of m, v, the master and "
          f"the weights differ from the plain version's")
    # two in-place steps from one state (the two copies are equal now)
    n1 = opt.update_(grads, state, params)
    n2 = opt.update_(grads, twin[1], twin[0])
    torch.cuda.synchronize()
    check(torch.equal(n1, n2) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves((params, state)),
                                          tree_leaves(twin))),
          "adamw: two steps from one state differ")
    del twin
    torch.cuda.empty_cache()
    before = dict(adamw.LAUNCHES)
    step_ms = events_ms(torch, lambda: [opt.update_(grads, state, params)
                                        for _ in range(ADAMW_TIMED)])
    step_ms /= ADAMW_TIMED
    per_step = {k: (adamw.LAUNCHES[k] - before[k]) / ADAMW_TIMED
                for k in before}
    check(per_step == {"adamw_norm": 1, "adamw_update": 1},
          f"adamw: launches a step {per_step}")
    master = tree_leaves(state["master"])

    def kernels():
        for _ in range(ADAMW_TIMED):
            _, s = adamw.grad_norm(grads, 1.0)
            adamw.adamw_update(grads, tree_leaves(state["m"]),
                               tree_leaves(state["v"]), master, leaves, s,
                               *scalars, **kw)
    kernel_ms = events_ms(torch, kernels) / ADAMW_TIMED

    def functional():
        for _ in range(ADAMW_TIMED):
            opt.update(grads, state, params)     # each new tree dropped
    opt.update(grads, state, params)             # the allocator's first
    plain_ms = events_ms(torch, functional) / ADAMW_TIMED
    library_ms = None
    fused = getattr(torch, "_fused_adamw_", None)
    if fused is not None:
        g32 = [g.float() for g in grads]
        counts = [torch.ones((), device=DEV) for _ in master]
        m, v = tree_leaves(state["m"]), tree_leaves(state["v"])

        def library():
            for _ in range(ADAMW_TIMED):
                fused(master, g32, m, v, [], counts, lr=3e-4, beta1=0.9,
                      beta2=0.95, weight_decay=0.1, eps=1e-8, amsgrad=False,
                      maximize=False)
        library_ms = events_ms(torch, library) / ADAMW_TIMED
        del g32, counts, m, v
    # the gradient read twice (norm, update), m, v and the master read and
    # written, the weight written
    nbytes = sum(t.numel() * (2 * g.element_size() + 24 + t.element_size())
                 for g, t in zip(grads, leaves))
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"llm train: adamw on the leaves of inl-starcoder2-3b ({n} "
          f"parameters in {len(leaves)} leaves, {dtypes}, an fp32 master): "
          f"{K} scan steps (B={B} S={S}) launched {launches}, losses "
          f"{[round(x, 4) for x in losses]}; norm {float(norm)!r} against "
          f"global_norm's {float(want)!r} ({norm_rel:.3e} of it, bar "
          f"{ADAMW_NORM_RTOL}), clip scale {float(scale)!r}; the update "
          f"given that scale == ref.adamw_update_ref_ bit for bit (m, v, "
          f"master, weights); two steps from one state bit for bit; "
          f"update_ {step_ms:.3f} ms a step over {ADAMW_TIMED} (CUDA "
          f"events; launches a step {per_step}), the two launches alone "
          f"{kernel_ms:.3f} ms, bound {bound_ms:.3f} ms ({nbytes / 1e9:.2f} "
          f"GB at 3.35 TB/s): {100 * bound_ms / kernel_ms:.1f}% of it; the "
          f"functional update {plain_ms:.3f} ms, torch._fused_adamw_ (fp32 "
          f"master and gradients, no clip) "
          + ("not in this torch" if library_ms is None
             else f"{library_ms:.3f} ms")
          + f"; {time.perf_counter() - t0:.1f} s [{card_line}]")
    del params, state, grads, leaves, master
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "kernel_ms": kernel_ms, "bound_ms": bound_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "norm_rel": norm_rel, "launches": launches,
            "per_step": per_step}


def inl_llm_card_vs_cpu(torch, card_line):
    """INL over the Llama-3.2-1B smoke config in fp32 (J = 2, one encoder
    and one decoder layer) at link_bits INL_CPU_BITS, and at 4 with
    learned priors: one set of weights and draws made on the CPU, the loss
    within LOSS_RTOL and every gradient leaf within `grads_close`'s bar,
    card against CPU.  Returns {run: launches}."""
    import dataclasses
    from repro_torch import tree_leaves, tree_map, value_and_grad
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core import inl_llm
    base = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                               dtype="float32")
    runs = [(f"link_bits={b}", inl_cfg(base, link_bits=b))
            for b in INL_CPU_BITS]
    runs.append(("link_bits=4, learned priors",
                 inl_cfg(base, link_bits=4, learned_prior=True)))
    B, S = 2, 64
    out = {}
    for label, cfg in runs:
        cpu = inl_llm.init(cfg, 21, device="cpu")
        if cfg.inl.learned_prior:
            gen = torch.Generator().manual_seed(22)
            cpu = cpu._replace(priors={
                k: 0.1 * torch.randn(v.shape, generator=gen)
                for k, v in cpu.priors.items()})
        gpu = tree_map(lambda t: t.to(DEV), cpu)
        noise, eps = inl_llm.draw_noise(
            cfg, torch.Generator().manual_seed(23), B, S)
        batch = {k: v[0] for k, v in lm_batches_on(torch, cfg, B, S, 1,
                                                    24).items()}
        reset_launches()
        l_gpu, _, g_gpu = value_and_grad(
            lambda p: inl_llm.loss_fn(p, cfg, batch, noise=noise.to(DEV),
                                      eps=eps.to(DEV)), gpu)
        torch.cuda.synchronize()
        out[label] = read_launches()
        l_cpu, _, g_cpu = value_and_grad(
            lambda p: inl_llm.loss_fn(
                p, cfg, {k: v.cpu() for k, v in batch.items()},
                noise=noise, eps=eps), cpu)
        loss_close(float(l_gpu), float(l_cpu), f"INL smoke {label}")
        max_leaf, max_abs, off = grads_close(
            float(l_gpu), float(l_cpu), tree_leaves(g_gpu),
            tree_leaves(g_cpu), f"INL smoke {label}")
        print(f"llm train: INL over the Llama-3.2-1B smoke config, fp32, "
              f"{label}, B={B} S={S}: loss card {float(l_gpu):.7f} cpu "
              f"{float(l_cpu):.7f}; every gradient leaf within rtol 1e-3 "
              f"atol 1e-5 as a tensor, largest |card - cpu| / |cpu| of a "
              f"leaf {max_leaf:.3g}, largest entry difference "
              f"{max_abs:.3g} ({off} entries outside the bar entry by "
              f"entry); launches {_nonzero(out[label])} [{card_line}]")
    return out


def llm_train_phase(torch, card_line):
    """The attention blocks' train mode on the card, deterministic
    algorithms on (TF32 is off since the device phase): the kernel's lse
    and the backward kernel, Llama's step against the CPU, Llama-3.2-1B
    trained 8 steps at full width, DeepSeek-V2's MLA and MoE forward and
    backward.
    Returns ({run: flash launches}, {metric: value}, max |lse kernel -
    plain|)."""
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        lse_worst = lse_and_backward_check(torch, card_line)
        bwd_ms = flash_bwd_check(torch, card_line)
        llm_card_vs_cpu(torch, card_line)
        ds_launches, ds_ms = deepseek_train_check(torch, card_line)
        ssd_bwd_ms = ssd_train_check(torch, card_line)
        zamba7 = zamba2_7b_check(torch, card_line)
        zamba_launches, zamba = zamba_train_check(torch, card_line)
        xlstm = xlstm_train_check(torch, card_line)
        inl_launches, inl = inl_llm_train_run(torch, card_line)
        inl_cpu_launches = inl_llm_card_vs_cpu(torch, card_line)
        adamw_times = adamw_check(torch, card_line)
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"llm train: the phase {time.perf_counter() - t0:.1f} s "
          f"[{card_line}]")
    times = dict(deepseek_ms=ds_ms, bwd_ms=bwd_ms, ssd_bwd_ms=ssd_bwd_ms,
                 zamba=zamba, zamba7=zamba7, xlstm=xlstm, inl=inl,
                 adamw=adamw_times)
    flash = {"deepseek-v2-236b fwd+bwd": ds_launches,
             f"zamba2-2.7b {ZAMBA_TRAIN_PERIODS} periods "
             f"{ZAMBA_TRAIN_STEPS} steps": zamba_launches["flash_attn_fwd"],
             INL_LLM_RUN: inl_launches["flash_attn_fwd"]}
    on_ssd = {f"zamba2-2.7b {ZAMBA_TRAIN_PERIODS} periods "
              f"{ZAMBA_TRAIN_STEPS} steps": zamba_launches["ssd_scan"]}
    runs = {INL_LLM_RUN: inl_launches,
            **{f"inl smoke fp32 {run}": counts
               for run, counts in inl_cpu_launches.items()}}
    on_inl = {k: {run: counts[k] for run, counts in runs.items()
                  if counts[k]} for k in CUT_LAYER_SOURCES}
    return flash, on_ssd, on_inl, times, lse_worst


# ---------------------------------------------------------------------------
# 10. llm launch: launch.train, crash-resume, expert parallelism, dry-run
# ---------------------------------------------------------------------------

def llama_cli_run(torch, card_line, prefetch):
    """`launch.train.main` in-process at full width (Llama-3.2-1B, bf16,
    B=4, S=2048, 8 steps in groups of 4), launches set to 0 just before and
    read just after.  Returns (history, launches, {metric: value})."""
    from repro_torch.launch import train
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    hist = train.main(list(LAUNCH_ARGV) + ["--prefetch", str(prefetch)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the second group's wall: its batches came in while the first ran
    step_ms = (hist[1]["wall_s"] - hist[0]["wall_s"]) / LAUNCH_GROUP * 1e3
    tok_s = LAUNCH_BATCH[0] * LAUNCH_BATCH[1] / (step_ms / 1e3)
    return hist, launches, {"step_ms": step_ms, "tokens_per_s": tok_s,
                            "peak_gib": peak, "wall_s": wall}


def launch_cli_check(torch, card_line):
    """The CLI at full width: exactly a forward and a recompute of
    flash_attn_fwd a layer and step, losses finite and falling; then a
    short run (the smoke config, 4 groups) at --prefetch 1 and 2, every
    group's losses and grad norms equal bit for bit.  Returns (flash
    launches, metrics)."""
    from repro_torch.launch import train
    from repro_torch.models import zoo
    cfg = attn_model("llama3.2-1b")
    hist, launches, m = llama_cli_run(torch, card_line, 2)
    expect_launches(launches, {"flash_attn_fwd":
                               2 * cfg.num_layers * LAUNCH_STEPS,
                               "flash_attn_bwd":
                               cfg.num_layers * LAUNCH_STEPS,
                               **adamw_launches(LAUNCH_STEPS)},
                    f"{LAUNCH_RUN}")
    losses = [h["loss"] for h in hist]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"launch.train losses {losses}")
    short = {n: train.main(list(PREFETCH_ARGV) + ["--prefetch", str(n)])
             for n in (1, 2)}
    same = all([h[k] for h in short[1]] == [h[k] for h in short[2]]
               for k in ("loss", "grad_norm"))
    check(same and len(short[1]) == 4,
          f"--prefetch 1 {short[1]} vs 2 {short[2]}")
    print(f"llm launch: launch.train {' '.join(LAUNCH_ARGV)}: "
          f"{zoo.param_count(cfg)} parameters, losses (a group's last step) "
          f"{losses}, flash_attn_fwd {launches['flash_attn_fwd']} launches "
          f"(a forward and a recompute a layer: "
          f"{launches['flash_attn_fwd'] // LAUNCH_STEPS} a step), "
          f"flash_attn_bwd {launches['flash_attn_bwd']} (one a layer and "
          f"step); a step "
          f"{m['step_ms']:.1f} ms (the second group's wall / "
          f"{LAUNCH_GROUP}), {m['tokens_per_s']:.0f} tokens/s, peak "
          f"{m['peak_gib']:.2f} GiB, the run {m['wall_s']:.1f} s; "
          f"{' '.join(PREFETCH_ARGV)} at --prefetch 1 and 2: the 4 groups' "
          f"losses and grad norms bit for bit [{card_line}]")
    return launches["flash_attn_fwd"], m


def crash_resume_card(torch, card_line):
    """`chaos.crash_resume_check` with the reference's chaos defaults on
    the card, dense and with learned priors, the two side by side (each
    its own children): resumed lines and final checkpoints bit for bit
    the uninterrupted run's, the cut-layer kernels launched in the golden
    and the resumed child.  Returns {run: child launches}."""
    import argparse
    import shutil
    import threading
    from repro_torch import chaos
    wants = {"dense": ("cut_fwd", "cut_bwd", "flash_attn_fwd",
                       "flash_attn_bwd", "adamw_norm", "adamw_update"),
             "learned prior": ("cut_prior_fwd", "cut_prior_bwd",
                               "flash_attn_fwd", "flash_attn_bwd",
                               "adamw_norm", "adamw_update")}
    results = {}

    def one(name):
        wd = ROOT / "build" / "chaos" / name.replace(" ", "_")
        shutil.rmtree(wd, ignore_errors=True)
        args = argparse.Namespace(**CHAOS_ARGS, workdir=str(wd), device=DEV,
                                  learned_prior=name == "learned prior")
        try:
            results[name] = chaos.crash_resume_check(args)
        except BaseException as exc:          # reported below
            results[name] = exc

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(n,), daemon=True)
               for n in wants]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=max(CHAOS_TIMEOUT - (time.perf_counter() - t0), 1.0))
    check(not any(t.is_alive() for t in threads),
          f"crash-resume did not finish in {CHAOS_TIMEOUT:.0f} s")
    out = {}
    for name, want in wants.items():
        rec = results.get(name)
        check(isinstance(rec, dict) and rec["bitwise_identical"],
              f"crash-resume {name}: {rec!r}")
        runs = rec["kernel_launches"]
        check(all(runs[r] and all(runs[r].get(k, 0) > 0 for k in want)
                  for r in ("golden", "resumed")),
              f"crash-resume {name}: children's launches {runs}")
        out[name] = runs
        print(f"llm launch: crash-resume ({name}) {CHAOS_ARGS}: SIGKILLed "
              f"after step {CHAOS_ARGS['kill_after_step']}, resumed from "
              f"step {rec['resume_from_step']}, {rec['metric_lines_compared']}"
              f" metric lines and {rec['tensors_compared']} checkpoint "
              f"tensors bit for bit the uninterrupted run's; the children's "
              f"launches golden {runs['golden']} resumed {runs['resumed']} "
              f"[{card_line}]")
    print(f"llm launch: crash-resume, both checks side by side, "
          f"{time.perf_counter() - t0:.1f} s [{card_line}]")
    return out


def ep_cfg():
    """DeepSeek-V2-236B at its published widths in bf16, the MoE's capacity
    raised to every token (droppless)."""
    import dataclasses
    cfg = attn_model(EP_ARCH)
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.experts_per_token))


def ep_layer(torch):
    """(cfg, the MoE layer's params, x (B, S, d) bf16) from seeds, on the
    card."""
    from repro_torch.models import moe
    cfg = ep_cfg()
    p = moe.moe_init(torch.Generator(device=DEV).manual_seed(0), cfg,
                     torch.bfloat16, device=DEV)
    x = torch.randn(EP_BATCH + (cfg.d_model,), device=DEV,
                    generator=torch.Generator(device=DEV).manual_seed(1))
    return cfg, p, x.to(torch.bfloat16)


def ep_rank(rank, world, store, queue):
    """A spawned rank of the EP world: gloo over `store`, a (1, 2) ('data',
    'model') mesh on cuda:0, this rank's 80 experts; moe_apply_ep once to
    warm up, then 3 timed calls.  Puts (rank, ok, result or traceback)."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=120))
        from repro_torch.launch import mesh as mesh_lib
        from repro_torch.models import moe
        mesh = mesh_lib.Mesh((1, world), ("data", "model"), device=DEV)
        cfg, p, x = ep_layer(torch)
        ax = mesh.axis("model")
        for k in ("wi", "wg", "wo"):
            p[k] = p[k][ax.block(p[k].shape[0])].clone()
        torch.cuda.empty_cache()
        ms = []
        with torch.no_grad():
            for i in range(4):
                mesh.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y, aux = moe.moe_apply_ep(p, cfg, x, mesh=mesh)
                torch.cuda.synchronize()
                if i:
                    ms.append((time.perf_counter() - t0) * 1e3)
        # numpy, not tensors: a tensor crosses the queue as a shared-memory
        # handle, which dies with this process
        queue.put((rank, True, {
            "y": y.float().cpu().numpy(),
            "aux": {k: v.float().cpu().numpy() for k, v in aux.items()},
            "ms": statistics.median(ms), "experts": p["wi"].shape[0],
            "traffic": dict(ax.traffic)}))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def ep_card_check(torch, card_line):
    """DeepSeek-V2's MoE layer (160 experts, 6 routed and 2 shared, d 5120,
    f 1536, bf16, droppless) over 2 gloo ranks sharing the card against
    `moe_apply` in this process on the same weights: y within 2e-2 of the
    largest |y| on both ranks, the aux values equal within 1e-5.
    Returns the EP layer's ms."""
    import multiprocessing
    import queue as queue_lib
    from repro_torch.models import moe
    root = ROOT / "build" / "ep"
    root.mkdir(parents=True, exist_ok=True)
    store = root / "store"
    store.unlink(missing_ok=True)
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=ep_rank, args=(r, EP_RANKS, str(store), q))
             for r in range(EP_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        torch.cuda.empty_cache()
        cfg, params, x = ep_layer(torch)
        with torch.no_grad():
            y_ref, aux_ref = moe.moe_apply(params, cfg, x)
            ref_ms = cuda_ms(torch, lambda: moe.moe_apply(params, cfg, x),
                             reps=3, warmup=1)
        del params
        torch.cuda.empty_cache()
        got, failed = {}, None
        while len(got) < EP_RANKS and failed is None:
            try:
                rank, ok, value = q.get(timeout=max(
                    EP_TIMEOUT - (time.perf_counter() - t0), 0.1))
            except queue_lib.Empty:
                failed = "a rank gave no result"
                break
            if ok:
                got[rank] = value
            else:
                failed = f"rank {rank} failed:\n{value}"
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    check(failed is None, f"EP: {failed}")
    y_ref = y_ref.float().cpu().numpy()
    scale = float(np.abs(y_ref).max())
    errs = [float(np.abs(got[r]["y"] - y_ref).max())
            for r in range(EP_RANKS)]
    check(max(errs) <= BF16_BAR * scale,
          f"EP y off by {errs} (bar {BF16_BAR} x {scale})")
    aux_err = max(float(np.abs(got[r]["aux"][k]
                               - aux_ref[k].float().cpu().numpy()).max())
                  for r in range(EP_RANKS) for k in aux_ref)
    check(aux_err <= 1e-5, f"EP aux off by {aux_err}")
    ms = max(got[r]["ms"] for r in range(EP_RANKS))
    print(f"llm launch: EP, {EP_ARCH}'s MoE layer at published widths "
          f"(E={cfg.moe.num_experts}, k={cfg.moe.experts_per_token}, "
          f"{cfg.moe.num_shared_experts} shared, d={cfg.d_model}, "
          f"f={cfg.moe.d_ff_expert}, bf16, droppless) at B x S = "
          f"{EP_BATCH}, {EP_RANKS} gloo ranks on one card, "
          f"{got[0]['experts']} experts a rank: y within {max(errs):.3g} of "
          f"moe_apply's (largest |y| {scale:.3g}, bar {BF16_BAR} of it), "
          f"aux within {aux_err:.3g}; a layer {ms:.3f} ms on the ranks "
          f"(median of 3, gloo's bf16 psum of (T, d) through the host "
          f"included; rank 0's traffic {got[0]['traffic']}), moe_apply in "
          f"one process {ref_ms:.3f} ms; {time.perf_counter() - t0:.1f} s "
          f"[{card_line}]")
    return ms


def dryrun_card_check(torch, card_line, step_ms):
    """The dry-run's record of the CLI's step (Llama-3.2-1B, B=4, S=2048,
    train) on a 1-rank mesh: its per-rank argument bytes, rounded leaf by
    leaf to the allocator's 512-byte blocks, equal to `memory_allocated`
    after the params, AdamW's state and a batch are made on the card (and
    the exact bytes to the tensors' own); the roofline's compute term
    against the CLI's measured step."""
    from repro_torch import tree_leaves
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import zoo
    t0 = time.perf_counter()
    cfg = attn_model("llama3.2-1b")
    shape = ShapeConfig("launch_train", LAUNCH_BATCH[1], LAUNCH_BATCH[0],
                        "train")
    rec = dryrun.run_record("llama3.2-1b", cfg, shape,
                            mesh_lib.AbstractMesh((1, 1), ("data", "model")),
                            "one rank")
    dry_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    m0 = torch.cuda.memory_allocated()
    params = zoo.init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                             device=DEV)
    opt_state = steps.default_optimizer(cfg).init(params)
    batch = zoo.dummy_batch(cfg, shape, 0, device=DEV)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - m0
    exact = sum(t.numel() * t.element_size()
                for t in tree_leaves((params, opt_state, batch)))
    mem = rec["memory"]
    check(allocated == mem["argument_bytes_allocated"]
          and exact == mem["argument_bytes"],
          f"dry-run bytes {mem['argument_bytes']} "
          f"({mem['argument_bytes_allocated']} in 512-byte blocks) vs the "
          f"card's {exact} ({allocated} memory_allocated)")
    del params, opt_state, batch
    torch.cuda.empty_cache()
    r = rec["roofline"]
    step_s = step_ms / 1e3
    print(f"llm launch: dry-run of the CLI's step (Llama-3.2-1B, B=4, "
          f"S=2048, train, 1 rank; {dry_s:.1f} s on meta): argument bytes "
          f"{mem['argument_bytes']} (params {mem['params_bytes']}, AdamW "
          f"state {mem['opt_state_bytes']}, batch {mem['batch_bytes']}) == "
          f"the tensors' own; {mem['argument_bytes_allocated']} in 512-byte "
          f"blocks == memory_allocated {allocated} to the byte; roofline "
          f"terms compute {r['compute_s']:.4f} s, memory "
          f"{r['memory_s']:.4f} s, dominant {r['dominant']}; model FLOPs "
          f"{r['model_flops']:.4g} a step (counted {r['counted_flops']:.4g},"
          f" useful {r['useful_flop_ratio']:.3f}) over the measured "
          f"{step_ms:.1f}-ms step = {r['model_flops'] / step_s / 1e12:.1f} "
          f"TFLOP/s, {r['model_flops'] / (step_s * H100_BF16_FLOPS):.4f} of "
          f"989 TFLOP/s (the compute term {r['compute_s'] * 1e3:.1f} ms is "
          f"{r['compute_s'] / step_s:.4f} of the step) [{card_line}]")
    return rec


def llm_launch_phase(torch, card_line):
    """launch.train at full width (twice: --prefetch 2 and 1), the
    crash-resume check on the card, EP over 2 gloo ranks, the dry-run
    against the card's memory.  Returns ({run: flash launches}, CLI
    metrics, crash-resume children's launches)."""
    t0 = time.perf_counter()
    flash, metrics = launch_cli_check(torch, card_line)
    children = crash_resume_card(torch, card_line)
    metrics["ep_ms"] = ep_card_check(torch, card_line)
    dryrun_card_check(torch, card_line, metrics["step_ms"])
    phase_s = time.perf_counter() - t0
    print(f"llm launch: the phase {phase_s:.1f} s (budget "
          f"{LAUNCH_PHASE_BUDGET_S:.0f} s) [{card_line}]")
    metrics["phase_s"] = phase_s
    return {LAUNCH_RUN: flash}, metrics, children


# ---------------------------------------------------------------------------
# 11. the port's own measurement: the phase marks' cost and what they read
# ---------------------------------------------------------------------------

TRACING_ROUNDS = {"inl": 100, "fl": 20}    # graphed rounds a timed call
TRACING_LLM = ((1, 4096), (8, 512))        # (B, S) of INL over StarCoder2-3B
TRACING_GROUPS = 5                         # groups of 4 steps a timed turn
TRACING_TURNS = 3                          # turns of marks on, then off


def events_ms(torch, fn):
    """Device ms of fn() between CUDA events, synchronised."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def split_line(split) -> str:
    if split is None:
        return "no samples"
    retries = "" if split["alloc_retries"] is None \
        else f" retries {split['alloc_retries']:.2f}"
    return (" ".join(f"{k} {split[k]:.4f}" for k in
                     ("forward", "backward", "optimizer", "other", "unit"))
            + f"{retries} (median of {split['n']})")


def profiled_split(samples, kind):
    got = [s for s in samples if s.kind == kind and s.profiled]
    if not got:
        return None
    out = {k: statistics.median(s.ms[k] for s in got)
           for k in ("forward", "backward", "optimizer", "other", "unit")}
    return dict(out, alloc_retries=None, n=len(got))


def tracing_paper_phase(torch, card_line):
    """The paper's INL and FL at full width, graphed: one epoch function
    captured with the marks' graph nodes and one without, timed in turns
    by CUDA events around K replayed rounds; the split the marks read;
    the same rounds under the profiler with the spans on and off."""
    from repro_torch import tracing
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import schemes
    from repro_torch.core.schemes import runner
    cfg = PaperExperimentConfig()
    B, lr = 64, 2e-3
    for name, K in TRACING_ROUNDS.items():
        scheme = schemes.get(name)
        bpr = scheme.batches_per_round(cfg)
        gen = torch.Generator(device=DEV).manual_seed(0)
        n = K * bpr * B
        views = torch.randn((cfg.num_clients, n) + tuple(cfg.image_shape),
                            generator=gen, device=DEV)
        labels = torch.randint(0, cfg.num_classes, (n,), generator=gen,
                               device=DEV)
        ev, el = runner.epoch_batches(views, labels, 0, K, bpr, B)
        state = scheme.init(cfg, gen, lr=lr, device=DEV)
        fns, gens = {}, {}
        for on in (True, False):
            tracing.MARKS = on
            fns[on] = scheme.make_epoch(cfg, lr=lr)
            gens[on] = torch.Generator(device=DEV).manual_seed(1)
            fns[on](state, ev[:3], el[:3], gens[on])
        tracing.MARKS = True
        torch.cuda.synchronize()
        mark = tracing.cursor()
        ms = {True: [], False: []}
        for _ in range(TRACING_TURNS + 1):
            for on in (True, False):
                ms[on].append(events_ms(torch, lambda: fns[on](
                    state, ev, el, gens[on])) / K)
        for on in ms:
            del ms[on][0]                  # the first turn warms up
        split = tracing.summary("graph", since=mark)
        check(split is not None and split["n"] >= 3,
              f"{name}: the graphed rounds' marks gave {split}")
        with_, without = (statistics.median(ms[o]) for o in (True, False))
        print(f"tracing: {name} graphed round {with_:.4f} ms with the "
              f"marks' nodes, {without:.4f} ms without: "
              f"{100 * (with_ / without - 1):+.3f}% (medians of "
              f"{TRACING_TURNS} turns of "              f"{K} rounds; {[round(x, 4) for x in ms[True]]} / "
              f"{[round(x, 4) for x in ms[False]]}) [{card_line}]")
        print(f"tracing: {name} graphed round split (device ms): "
              f"{split_line(split)} [{card_line}]")
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        host = {}
        for spans in (None, True, False, True, False):
            tracing.SPANS = bool(spans)
            with torch.profiler.profile(activities=acts):
                t0 = time.perf_counter()
                fns[True](state, ev, el, gens[True])
                torch.cuda.synchronize()
                host.setdefault(spans, []).append(
                    (time.perf_counter() - t0) * 1e3 / K)
        tracing.SPANS = True
        print(f"tracing: {name} profiled round, host ms (2 turns after one "
              f"to warm the profiler up): spans on "              f"{[round(x, 4) for x in host[True]]}, off "
              f"{[round(x, 4) for x in host[False]]} [{card_line}]")
        del fns, gens, state, views, labels, ev, el
        torch.cuda.empty_cache()


def tracing_llm_phase(torch, card_line):
    """INL over StarCoder2-3B at published widths, 3 of 30 layers, bf16:
    groups of 4 eager steps timed in turns with the marks on and off by
    CUDA events around TRACING_GROUPS groups (a host read a group); the
    split the marks read and the allocator's retries; then two groups
    under the profiler (CPU and CUDA) with the spans on and two off: the
    profiled split against the unprofiled one and host ms a step."""
    import dataclasses
    from repro_torch import optim, tracing
    from repro_torch.configs.base import get_config
    from repro_torch.core import inl_llm
    from repro_torch.launch import steps
    cfg = dataclasses.replace(get_config("starcoder2-3b"), num_layers=3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.use_deterministic_algorithms(True)     # as launch.train runs
    for B, S in TRACING_LLM:
        opt = optim.adamw(optim.warmup_cosine_schedule(3e-4, 100, 1000),
                          weight_decay=0.1, clip_norm=1.0)
        params = inl_llm.init(cfg, 0, device=DEV)
        state = [params, opt.init(params)]
        del params
        epoch = steps.make_scan_train_step(cfg, opt, scheme="inl")
        gen = torch.Generator(device=DEV).manual_seed(1)
        batches = {k: torch.randint(0, cfg.vocab_size, (4, B, S),
                                    generator=gen, device=DEV)
                   for k in ("tokens", "labels")}

        def groups(n):
            for _ in range(n):
                p, o, ms = epoch(state[0], state[1], batches, gen)
                state[:] = [p, o]
                float(ms["loss"][-1])
        groups(2)
        mark = tracing.cursor()
        ms = {True: [], False: []}
        for _ in range(TRACING_TURNS):
            for on in (True, False):
                tracing.MARKS = on
                ms[on].append(events_ms(torch, lambda: groups(
                    TRACING_GROUPS)) / (4 * TRACING_GROUPS))
        tracing.MARKS = True
        split = tracing.summary("eager", since=mark)
        check(split is not None and split["n"] >= 4 * TRACING_GROUPS,
              f"B={B} S={S}: the steps' marks gave {split}")
        with_, without = (statistics.median(ms[o]) for o in (True, False))
        print(f"tracing: llm B={B} S={S} step {with_:.3f} ms with the "
              f"marks, {without:.3f} ms without: "
              f"{100 * (with_ / without - 1):+.3f}% ({TRACING_TURNS} "
              f"turns of {4 * TRACING_GROUPS} steps each: "
              f"{[round(x, 3) for x in ms[True]]} / "
              f"{[round(x, 3) for x in ms[False]]}) [{card_line}]")
        print(f"tracing: llm B={B} S={S} step split (device ms): "
              f"{split_line(split)} [{card_line}]")
        mark = tracing.cursor()
        host = {}
        for spans in (None, True, False, True, False):
            tracing.SPANS = bool(spans)
            with torch.profiler.profile(activities=acts):
                t0 = time.perf_counter()
                groups(1)
                host.setdefault(spans, []).append(
                    (time.perf_counter() - t0) * 1e3 / 4)
        tracing.SPANS = True
        groups(1)
        print(f"tracing: llm B={B} S={S} profiled step split (device ms): "
              f"{split_line(profiled_split(tracing.samples(mark), 'eager'))}"
              f"; host ms a profiled step (2 turns after one to warm the "
              f"profiler up): spans on {[round(x, 3) for x in host[True]]}, "
              f"off {[round(x, 3) for x in host[False]]} [{card_line}]")
        del state, epoch, batches
        torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)


CUT_LAYER_SOURCES = ("cut_fwd", "cut_bwd", "cut_prior_fwd", "cut_prior_bwd",
                     "cut_fwd_pack", "pack", "unpack_dequant")
# the kernels the hybrid schemes' runs launch (the deterministic cut)
HYBRID_PATH_KERNELS = ("cut_fwd", "cut_bwd", "cut_fwd_pack", "pack",
                       "unpack_dequant")
# the kernels the resumed runs (learned priors among them) and the search
# grid (packed_duplex on the star and on chain(5)) must launch
RESUME_PATH_KERNELS = ("cut_fwd", "cut_bwd", "cut_prior_fwd",
                       "cut_prior_bwd")
SEARCH_PATH_KERNELS = ("cut_fwd", "cut_bwd", "cut_fwd_pack", "pack",
                       "unpack_dequant")


def main() -> int:
    parser = argparse.ArgumentParser(
        description="Drive the PyTorch port on one NVIDIA H100.")
    parser.add_argument("--kernel-times", action="store_true",
                        help="build the cut-layer kernels and print only "
                             "their device times")
    parser.add_argument("--decode-times", action="store_true",
                        help="build the LLM kernels and print only "
                             "Zamba2-2.7B's decode latency per token, "
                             "eager and graphed")
    parser.add_argument("--llm-train", action="store_true",
                        help="build the LLM and cut-layer kernels and run "
                             "only the `llm train` phase")
    parser.add_argument("--zamba2-7b", action="store_true",
                        help="build the LLM kernels and run only the "
                             "checks of the cell zamba2-7b.lm-2x4096's "
                             "shapes (part of the `llm train` phase)")
    parser.add_argument("--adamw", action="store_true",
                        help="build the LLM kernels and the AdamW kernel "
                             "and run only the AdamW check on the cell "
                             "inl-starcoder2-3b's leaves (part of the "
                             "`llm train` phase)")
    parser.add_argument("--llm-launch", action="store_true",
                        help="build the LLM and cut-layer kernels and run "
                             "only the `llm launch` phase")
    parser.add_argument("--tracing", action="store_true",
                        help="build the cut-layer and LLM kernels and run "
                             "only the `tracing` phase: the phase marks' "
                             "cost and what they read")
    args = parser.parse_args()
    # launch.train runs with deterministic algorithms on the card, under
    # which cuBLAS wants this setting from the process's first matmul on
    # (32 MiB of workspace, PyTorch's default size on sm_90 in any case)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repository ({exc})",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    name, card = device_phase(torch)
    if args.kernel_times:
        build_phase(CUT_LAYER_SOURCES)
        new_kernel_timing(torch, card)
        pack_kernel_timing(torch, card)
        return 0
    if args.decode_times:
        from repro_torch.models import zoo
        build_phase(TENSOR_CORE_KERNELS)
        cfg = zamba2(torch)
        params = zoo.init_params(
            cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
        decode_timing(torch, cfg, params, card)
        return 0
    if args.llm_train:
        build_phase(LLM_TRAIN_KERNELS + CUT_LAYER_SOURCES)
        llm_train_phase(torch, card)
        return 0
    if args.zamba2_7b:
        build_phase(LLM_TRAIN_KERNELS)
        torch.use_deterministic_algorithms(True, warn_only=True)
        zamba2_7b_check(torch, card)
        return 0
    if args.adamw:
        build_phase(LLM_TRAIN_KERNELS + CUT_LAYER_SOURCES)
        torch.use_deterministic_algorithms(True, warn_only=True)
        adamw_check(torch, card)
        return 0
    if args.llm_launch:
        build_phase(LLM_TRAIN_KERNELS + CUT_LAYER_SOURCES)
        llm_launch_phase(torch, card)
        return 0
    if args.tracing:
        build_phase(LLM_TRAIN_KERNELS + CUT_LAYER_SOURCES)
        tracing_paper_phase(torch, card)
        tracing_llm_phase(torch, card)
        return 0
    build_phase()
    worst = {"cut_fwd": kernel_phase(torch),
             "cut_bwd": bwd_kernel_phase(torch),
             **prior_kernel_phase(torch),
             **pack_kernel_phase(torch)}
    autograd_phase(torch)
    scheme, state, views, serve_launches = serving_phase(torch, card)
    train_launches, accuracy = training_phase(torch, card)
    prior_launches = prior_training_phase(torch, card)
    packed_launches = packed_training_phase(torch, card)
    packed_step_equals_dense(torch, card)
    card_vs_cpu_phase(torch, card)
    graph_launches = topology_phase(torch, card)
    graph_step_checks(torch, card)
    graph_serve_launches = graph_serving_phase(torch, card)
    perfect_links_phase(torch, card)
    lossy_launches = lossy_training_phase(torch, card)
    lossy_card_vs_cpu(torch, card)
    lossy_serve_launches = lossy_serving_phase(torch, card)
    hybrid_launches_by_run = hybrids_phase(torch, card)
    graph_launches_by_run, graph_state, graph_refs = graphs_phase(torch,
                                                                  card)
    resume_launches_by_run, _ = checkpoint_phase(torch, card)
    search_launches = search_phase(torch, card)
    sharded_launches = sharded_phase(torch, card, graph_refs)
    del graph_refs
    on_transport, transport_times = transport_phase(torch, card)
    torch.cuda.synchronize()
    rows = timing_phase(torch, scheme, state, views, card)
    steps = {wire: train_step_timing(torch, card, wire=wire,
                                     link_bits=bits)
             for wire, bits in (("dense", 32), ("packed", WIRE_BITS),
                                ("packed_duplex", WIRE_BITS))}
    for label, topo, cfg, wire in graph_runs():
        if wire != "packed_duplex":
            steps[label] = train_step_timing(torch, card, wire=wire,
                                             topology=topo, cfg=cfg,
                                             label=label)
    _, _, lossy_cfg, lossy_star, _, _ = lossy_runs()[0]
    steps["lossy star"] = train_step_timing(
        torch, card, topology=lossy_star, cfg=lossy_cfg,
        label="lossy star: erasure 0.3 an edge, edge_dropout 0.2")
    (lw, lb), (cw, cb) = steps["lossy star"], steps["dense"]
    print(f"linkfault times: lossy INL step {lw:.3f} ms (device busy "
          f"{lb:.4f} ms) against the clean star's {cw:.3f} ms (busy "
          f"{cb:.4f} ms) in this run: {lw - cw:+.3f} ms wall, "
          f"{lb - cb:+.4f} ms busy [{card}]")
    for hname in HYBRIDS + ("sl", "fl"):
        steps[f"{hname} dense"] = train_step_timing(
            torch, card, name=hname, label=f"{hname} dense")
    rounds = [("inl", steps["dense"])] + [
        (h, steps[f"{h} dense"]) for h in HYBRIDS + ("sl", "fl")]
    print("hybrids times: one dense round at PaperExperimentConfig(), batch "
          "64 (FL: ten local steps), median wall and device busy: "
          + ", ".join(f"{h} {w:.3f} ms (busy {b:.4f} ms)"
                      for h, (w, b) in rounds) + f" [{card}]")
    graph_times = graphs_timing(torch, card, dict(rounds), graph_state)
    rows.update(new_kernel_timing(torch, card))
    rows.update(pack_kernel_timing(torch, card))
    torch.cuda.synchronize()
    worst.update(llm_kernel_phase(torch))
    llm_cfg, llm_params, llm_launches, path_worst = llm_serving_phase(
        torch, card)
    for kname, err in path_worst.items():
        worst[kname] = max(worst[kname], err)
    llm_fp32_phase(torch, card)
    llm_graph_launches = llm_graph_phase(torch, llm_cfg, llm_params, card)
    decode_attention_check(torch, llm_cfg, card)
    llm_times = llm_timing(torch, llm_cfg, llm_params, card)
    del llm_params
    rows.update(llm_kernel_timing(torch, card))
    torch.cuda.synchronize()
    on_attn, attn_serve_launches, attn_worst, mla_worst = llm_attn_phase(
        torch, card)
    worst["flash_attn_fwd"] = max(worst["flash_attn_fwd"], attn_worst)
    mla_rows = mla_kernel_timing(torch, card)
    torch.cuda.synchronize()
    on_zoo, zoo_worst = llm_zoo_phase(torch, card)
    worst["flash_attn_fwd"] = max(worst["flash_attn_fwd"], zoo_worst)
    on_attn.update({arch: n for arch, n in on_zoo.items() if n})
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    on_train, ssd_on_train, on_inl_llm, train_times, lse_worst = \
        llm_train_phase(torch, card)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    on_launch, launch_times, on_children = llm_launch_phase(torch, card)
    on_train.update(on_launch)
    train_times.update(launch_times)
    launches = {"cut_fwd": train_launches["cut_fwd"],
                "cut_bwd": train_launches["cut_bwd"],
                "cut_prior_fwd": prior_launches["cut_prior_fwd"],
                "cut_prior_bwd": prior_launches["cut_prior_bwd"],
                "cut_fwd_pack": packed_launches["inl packed"]["cut_fwd_pack"],
                "pack": graph_launches["chain(5) packed"]["pack"],
                "unpack_dequant":
                    graph_launches["chain(5) packed"]["unpack_dequant"],
                "flash_attn_fwd": llm_launches["flash_attn_fwd"],
                "ssd_scan": llm_launches["ssd_scan"]}
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path never launched: {launches}")
    lossy = {k: {label: n[k] for label, n in lossy_launches.items() if n[k]}
             for k in CUT_LAYER_SOURCES}
    lossy["cut_fwd"]["served lossy star"] = lossy_serve_launches["cut_fwd"]
    check(all(lossy[k] for k in CUT_LAYER_SOURCES),
          f"a cut-layer kernel never launched on the lossy paths: {lossy}")
    on_hybrids = {k: {run: n[k] for run, n in hybrid_launches_by_run.items()
                      if n[k]} for k in HYBRID_PATH_KERNELS}
    check(all(on_hybrids.values()),
          f"a kernel of the hybrids' path never launched: {on_hybrids}")
    on_graphs = {k: {run: n[k] for run, n in graph_launches_by_run.items()
                     if n.get(k)} for k in CUT_LAYER_SOURCES}
    check(all(on_graphs.values()),
          f"a cut-layer kernel never launched under graphs: {on_graphs}")
    on_resume = {k: {run: n[k] for run, n in resume_launches_by_run.items()
                     if n.get(k)} for k in CUT_LAYER_SOURCES}
    check(all(on_resume[k] for k in RESUME_PATH_KERNELS),
          f"a kernel of the resume path never launched: {on_resume}")
    on_search = {k: search_launches.get(k, 0) for k in CUT_LAYER_SOURCES}
    check(all(on_search[k] for k in SEARCH_PATH_KERNELS),
          f"a kernel of the search grid never launched: {on_search}")
    on_sharded = {k: sharded_launches.get(k, {}) for k in CUT_LAYER_SOURCES}
    check(all(on_sharded.values()),
          f"a cut-layer kernel never launched on a mesh: {on_sharded}")
    check(all(on_transport.values()),
          f"a cut-layer kernel never launched on the transport paths: "
          f"{on_transport}")
    check(not any(llm_graph_launches.values()),
          f"the graphed decode loop launched {llm_graph_launches}")
    check(all(n > 0 for n in on_attn.values()),
          f"an attention-block model's prefill never launched "
          f"flash_attn_fwd: {on_attn}")
    check(all(n > 0 for n in on_train.values()),
          f"a train run never launched flash_attn_fwd: {on_train}")
    check(all(n > 0 for n in ssd_on_train.values()),
          f"the Zamba2 train run never launched ssd_scan: {ssd_on_train}")
    check(all(on_inl_llm[k].get(INL_LLM_RUN, 0) > 0
              for k in INL_LLM_KERNELS),
          f"a kernel of INL over an LLM never launched: {on_inl_llm}")
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t0:.1f} s; final accuracy {accuracy}, "
          f"train step " + ", ".join(
              f"{w} {ms:.3f} ms (device busy {busy:.4f} ms)"
              for w, (ms, busy) in steps.items())
          + "; Zamba2-2.7B " + ", ".join(
              f"{k} {ms:.3f} ms (device {busy:.3f} ms)"
              for k, (ms, busy) in llm_times.items())
          + "; graphed rounds " + ", ".join(
              f"{k} {row[2]:.3f} ms (device {row[3]:.4f} ms, eager "
              f"{row[0]:.3f} ms)" for k, row in graph_times.items()
              if k != "predict" and len(row) == 4)
          + f"; transport round {transport_times[0]:.3f} ms (the graphed "
            f"lossy round {transport_times[1]:.3f} ms)"
          + f"; Llama-3.2-1B train step (launch.train) "
            f"{train_times['step_ms']:.1f} ms "
            f"({train_times['tokens_per_s']:.0f} tokens/s, peak "
            f"{train_times['peak_gib']:.2f} GiB); the EP MoE layer on 2 "
            f"gloo ranks {train_times['ep_ms']:.3f} ms; the llm launch "
            f"phase {train_times['phase_s']:.1f} s"
          + f"; Zamba2-2.7B ({ZAMBA_TRAIN_PERIODS} periods) train step "
            f"{train_times['zamba']['step_ms']:.1f} ms "
            f"({train_times['zamba']['tokens_per_s']:.0f} tokens/s, peak "
            f"{train_times['zamba']['peak_gib']:.2f} GiB)"
          + f"; xLSTM-125M (1 of 3 periods) train step "
            f"{train_times['xlstm']['step_ms']:.1f} ms (peak "
            f"{train_times['xlstm']['peak_gib']:.2f} GiB)"
          + f"; INL over Llama-3.2-1B train step "
            f"{train_times['inl']['step_ms']:.1f} ms (peak "
            f"{train_times['inl']['peak_gib']:.2f} GiB)")
    src = "src/repro_torch/kernels/csrc/"
    replaces = "src/repro/kernels/inl_bottleneck.py:"
    kernels = []
    for kname, line, shape, key, per_step, path in (
            ("cut_fwd", 83, "R=320 d=64 fp32 none b=32 (serving)",
             (320, "none", 32), f"1 + 1 per evaluation; serving: "
             f"{serve_launches['cut_fwd']} in its run", "training"),
            ("cut_bwd", 169, "R=320 d=64 fp32 sample b=32 (training)",
             ("cut_bwd", 320), 1, "training"),
            ("cut_prior_fwd", 279,
             "J=5 T=64 d=64 fp32 sample b=32 (training)",
             ("cut_prior_fwd", 320), 1, "training, learned prior"),
            ("cut_prior_bwd", 298,
             "J=5 T=64 d=64 fp32 sample (training)",
             ("cut_prior_bwd", 320), 1, "training, learned prior"),
            ("cut_fwd_pack", 117, "R=320 d=64 fp32 sample b=8 (training)",
             ("cut_fwd_pack", 320), 1, "INL training, packed wire"),
            ("pack", 143, "R=320 d=64 fp32 b=8 (training)", ("pack", 320),
             f"5 on the packed chain(5) (64-320 rows a hop), 1 on SL and "
             f"the learned prior; serving chain(5): "
             f"{graph_serve_launches['pack']} in its run",
             "INL on chain(5), SL and learned prior, packed wire"),
            ("unpack_dequant", 153, "R=320 d=64 fp32 b=8 (training)",
             ("unpack_dequant", 320), "5 on the packed chain(5), 1 on "
             "every other packed path", "every packed path")):
        k_ms, p_ms, b_ms = rows[key]
        entry = {
            "name": kname, "route": "cuda", "source": f"{src}{kname}.cu",
            "replaces": f"{replaces}{line}", "launches": launches[kname],
            "max_abs_err": worst[kname], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": "bytes", "library_ms": None,
            "shape": shape, "launches_per_train_step": per_step,
            "path": path, "launches_on_lossy_links": lossy[kname],
            "launches_on_graphs": on_graphs[kname],
            "launches_on_resume": on_resume[kname],
            "launches_on_search": on_search[kname],
            "launches_on_sharded": on_sharded[kname],
            "launches_on_transport": on_transport[kname]}
        if kname in on_hybrids:
            entry["launches_on_hybrids"] = on_hybrids[kname]
        if on_inl_llm[kname]:
            entry["launches_on_inl_llm"] = on_inl_llm[kname]
        on_crash = {f"crash-resume {run} {child}": n[kname]
                    for run, children in on_children.items()
                    for child, n in children.items() if n.get(kname)}
        if on_crash:
            entry["launches_on_crash_resume"] = on_crash
        if kname in REDESIGNED:
            entry["redesigned"] = REDESIGNED[kname]
            entry["at_large_r"] = {
                f"R={R}": dict(zip(("ms", "plain_ms", "bound_ms"),
                                   rows[kname, R])) for R in (20480, 262144)}
        kernels.append(entry)
    for kname, line, source in (
            ("flash_attn_fwd", "flash_attention.py:31",
             "flash_attn_fwd.cu"),
            ("ssd_scan", "ssm_scan.py:28", "ssd_scan.cu")):
        k_ms, p_ms, b_ms, by, l_ms = rows[(kname, LLM_PROMPT)]
        k2, p2, b2, _, l2 = rows[(kname, 2048)]
        kernels.append({
            "name": kname, "route": "cuda", "source": f"{src}{source}",
            "replaces": f"src/repro/kernels/{line}",
            "launches": launches[kname], "max_abs_err": worst[kname],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": l_ms,
            "shape": f"B={LLM_B} S={LLM_PROMPT} bf16 (the serving prefill)",
            "at_s2048": {"ms": k2, "plain_ms": p2, "bound_ms": b2,
                         "library_ms": l2},
            "launches_per_prefill": {"flash_attn_fwd": 9,
                                     "ssd_scan": 54}[kname],
            "path": "Zamba2-2.7B serving (prefill)"})
        if kname == "flash_attn_fwd":
            kernels[-1]["launches_on_attn_models"] = on_attn
            kernels[-1]["launches_on_llama_serving"] = \
                attn_serve_launches["flash_attn_fwd"]
            kernels[-1]["launches_on_train"] = on_train
            kernels[-1]["lse_max_abs_err"] = lse_worst
        else:
            kernels[-1]["launches_on_train"] = ssd_on_train
            kernels[-1]["train_backward_ms"] = train_times["ssd_bwd_ms"]
    k_ms, p_ms, b_ms, by, l_ms = mla_rows[LLM_PROMPT]
    k2, p2, b2, _, l2 = mla_rows[2048]
    kernels.append({
        "name": f"flash_attn_fwd (Dh={MLA_DH} instance)", "route": "cuda",
        "source": f"{src}flash_attn_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:31",
        "launches": on_attn["deepseek-v2-236b"], "max_abs_err": mla_worst,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
        "library_ms": l_ms,
        "shape": f"B={LLM_B} S={LLM_PROMPT} H=KV={MLA_HEADS} Dh={MLA_DH} "
                 f"bf16 (DeepSeek-V2's MLA prefill)",
        "at_s2048": {"ms": k2, "plain_ms": p2, "bound_ms": b2,
                     "library_ms": l2},
        "launches_per_prefill": "1 a layer (3 at num_layers=3)",
        "path": "DeepSeek-V2-236B serving (prefill), 3 of 60 layers"})
    kernels.append({
        "name": "flash_attn_bwd", "route": "cuda",
        "source": f"{src}flash_attn_bwd.cu",
        "replaces": "no TPU kernel: src/repro/models/attention.py's "
                    "_flash_bwd is jnp",
        "bound_by": "operations", "library_ms": None,
        "by_case": train_times["bwd_ms"],
        "launches_per_train_step": "1 an attention layer",
        "path": "LLM training (blockwise_attention's backward)"})
    aw = train_times["adamw"]
    kernels.append({
        "name": "adamw", "route": "cuda", "source": f"{src}adamw.cu",
        "replaces": "no TPU kernel: src/repro/optim's adamw update is jnp",
        "launches": aw["launches"], "max_abs_err": 0.0,
        "norm_rel_err": aw["norm_rel"], "ms": aw["kernel_ms"],
        "plain_ms": aw["plain_ms"], "bound_ms": aw["bound_ms"],
        "bound_by": "bytes", "library_ms": aw["library_ms"],
        "update_ms": aw["step_ms"],
        "shape": f"inl-starcoder2-3b's {ADAMW_PARAMS} parameters, bf16 "
                 f"weights, fp32 m, v and master",
        "launches_per_train_step": aw["per_step"],
        "path": "LLM training (make_scan_train_step's in-place AdamW, "
                "standard and inl schemes)"})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
