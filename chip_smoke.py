#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

  python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It imports neither JAX nor the JAX package ``repro``. Phases:

1. header: the card (nvidia-smi name and power limit), the nvcc build of
   every kernel source (one nvcc each, started together) with its time
   and ptxas report (registers and spills of every instantiation; the
   five tensor-core attention instantiations must not spill, nor may the
   eighteen CUDA-core ones compiled for head widths up to 128, nor the
   thirty-six attention-backward ones, nor the twelve Monte-Carlo ones,
   the two quantizer ones or the four bank ones), the SM clock, and the
   TF32 state (off).
2. kernels: each kernel is held against its plain PyTorch version on the
   card. The bank kernels (qmlp_mlp_bank, qmlp_svm_bank): the fixture
   fronts' shapes, D=1, M not a multiple of the block, bits 1/4/6, H and O
   wider than a register chunk, a design above 48 KB of shared memory, a
   per-channel-range case, one design at the shared-memory edge (the
   kernels' unpadded layout) and a wide D=64, M=65536 bank; bitwise on
   dyadic inputs (every exported front's), rtol=1e-5, atol=1e-6 where the
   sums are not exact. The population quantizer (adc_quantize_population):
   the search's shapes (cardio train and test splits, P=16 and 32), P=1
   (the adc_quantize entry), M not a multiple of the tile, bits 1/4/6,
   per-channel ranges, a table above 48 KB, NaN, +-inf and x on every
   code boundary (scalar and per-channel ranges), M*C odd (the kernel's
   word walk) and a wide P=64, M=65536 call; bitwise everywhere (a gather
   copies table values). For every bank and quantizer case the built
   library's launch geometry must equal envelope.bank_geometry's or
   envelope.quantize_geometry's, and every timed bank and quantizer call
   must have a device time in torch.profiler. The Monte-Carlo
   kernel's four entries (mc_adc_eval{,_cal}{,_population}): the search's
   shapes (P=16, S=32, cardio test and train splits) under every
   non-ideality spec (ideal, offset, drift, faults, fault_rate=1, all
   three), P=1 and S=1, ragged M, bits 1/4/6/7, per-channel ranges, NaN,
   +-inf and on-bound inputs, C=200 at 6 bits (150 KB of shared memory),
   P*S above 65,535, and a wide call writing 1.41 GB; then interval
   tables that are no partition (overlapping, empty and NaN intervals,
   mixed-sign values) for all four entries at 2^N 16 and 128 and at
   C=300, above a block's threads; bitwise everywhere, the operands and
   draws compiled on the card equal the CPU's bitwise, and the built
   kernel's launch geometry equals envelope.mc_geometry's. Then each
   kernel and its plain version are timed with
   CUDA events over 200 launches after warm-up (20 for the wide MC calls)
   and with torch.profiler, beside the least time the card could take;
   the single-design calls too. The flash-attention kernels, each call
   on the route dispatch names and counted on that route's key:
   flash_attention_tc (tensor cores, wgmma + TMA; bf16 at the configs'
   head widths 64, 96, 112, 128, 256) and flash_attention (CUDA cores;
   float32, and bf16 at other widths). The JAX package's four test shapes
   in f32, musicgen-medium's prefill (B=4, S=2048, H=KV=24, dh=64) in
   bf16 and f32, gemma2's widths (H=8, KV=4, dh=256, window 1024, softcap
   50, S=4096), phi3's (dh=96, S=1030) and llama4's (H=40, KV=8, dh=128,
   S=2047) in bf16 and f32, kimi's (H=64, KV=8, dh=112, window 512,
   S=1500) in bf16, ragged S=Sk=2049 (bf16 and f32), key positions
   holding -1 (f32 and bf16), fully masked rows (exactly 0) and bf16 at
   dh=32, on q, k ~ N(0, 1.5^2) and
   v ~ N(1, 1) (a peaked softmax, outputs O(1)); rtol=atol=2e-5 in f32
   (the JAX package's own test), two output ulps in bf16 (rtol 2^-6,
   atol 2^-7) against the plain version in the working type, a limit
   that must reject the plain version with one kv tile dropped and with
   the wrong kv head; each built kernel's shared memory must equal the
   envelope's. Timed at the musicgen (bf16 and f32), gemma2 (bf16 and
   f32), ragged and llama4 (bf16 and f32) shapes beside the bound (the
   largest of the HBM, the tensor- or CUDA-core and the ex2 times, the
   last at the SM clock read from the card) and, for the causal cases
   without window or softcap, scaled_dot_product_attention (the
   yardstick; the port never calls it), with the name of the device
   kernel it ran. Each kernel's bound comes from the port's cost model
   (repro_torch.perf.cost_model; attention's from flash_bound).
   Between the Monte-Carlo and the attention kernels, phase autotune
   (the perf layer, ROADMAP A10), at the shapes of
   perf/autotune.default_workloads() (rows 1-10 at the paths' shapes,
   14 shape classes): for every entry every candidate tile's built
   geometry (the C exports) == envelope's, a tile the kernel cannot take
   refused by the build, every candidate's output bitwise == the
   heuristic tile's and == the plain version's on random floats (the
   banks also on dyadic operands: bitwise there, rtol=1e-5 atol=1e-6 on
   floats, where the plain matmuls sum in another order); then
   autotune.tune times every candidate (CUDA events over 100 launches
   queued behind a spin, so device time) and prints tuned and heuristic
   us side by side, with the bound and the waves; the table is written
   to a temporary path and loads back, and the committed
   kernels/tuned_tables.json must load on this card (not stale) with
   every default shape class. Every later phase runs under that table.
3. serve (the serving path): with every launch counter at 0, each
   committed fixture front (tests/fixtures/fronts/cardio_{mlp,svm},
   exported by the JAX package) is loaded and served by the batch driver,
   256 requests x 8 rows in microbatches of 1024, on cuda; the served
   accuracies must equal the exported ones exactly, design 0 served alone
   (the D=1 entry) must give its exported accuracy, and each bank kernel
   must have launched. The per-request predictions are then held against
   the plain version's on the card.
4. search (the main path): with every launch counter at 0, for the MLP
   and the SVM on cardio at full width (21 features, hidden 5, 3 classes,
   4-bit tree ADC; pop 16, 3 generations, 100 QAT steps, the fixture
   fronts' config): run_search -> export_front -> verify_front_parity
   (must be True) -> save_front -> load_front -> serve by the batch driver
   -> served accuracies must equal the exported ones exactly. The
   quantizer must have launched twice (train and test split) per
   population evaluation: 2 x (generations + 1) for the search, 2 for
   train_pareto_front and 2 for verify_front_parity; the bank kernels must
   have launched in serving. A lane-purity probe re-trains the front
   without padding to the fixed lane count and reports whether the lane
   count changed any accuracy.
5. robust (the robustness path): with every launch counter at 0 per
   model, the same search shape with 32 Monte-Carlo instances under
   NonIdealSpec(sigma_offset=0.5, sigma_range=0.01, fault_rate=0.02): the
   MLP with robust_objective='expected', the SVM with a FaultTolSpec and
   'yield'. run_search -> export_front -> verify_front_parity ->
   evaluate_robustness (must reproduce the searched third column
   bitwise) -> save_front/save_robustness -> load. MLP: serving instances
   0 and 31 through make_nonideal_bank_fn must give their listed instance
   accuracies, zero sigma must give the exported accuracy on every
   instance, and zero-sigma MC must equal the ideal quantizer. SVM:
   calibrate_front and make_calibrated_bank_fn serve, the tmr/calibrated
   leaves survive save -> load. The MC population entry must launch once
   and the quantizer twice per evaluation. A few genomes through the
   reference engine at one lane (the single-design MC entries) must equal
   the batched engine at one lane. Then one robust evaluation and one
   2-objective evaluation of the same genomes are timed in turns, and one
   robust evaluation is traced (MC device time, device busy share).
6. generation: one generation at SearchConfig defaults (pop 32, 300 QAT
   steps) per model, timed on the host clock around a synchronised call,
   then traced with torch.profiler: device time of the quantizer, of
   everything else, and the device's busy share.
7. baseline (the paper's Table 5 "Baseline" column): with every launch
   counter at 0 per model, full_adc_baseline for the MLP and the SVM at
   the search path's config: the full ADC at dp = -3 through one
   fixed-lane QAT chunk (2 quantizer launches), its accuracy equal to
   evaluate_population_acc of the same genome bitwise, and the flash,
   binary and proposed full areas equal to 21 x area.flash_full_tc(4),
   baseline_binary_tc(4) and ours_full_tc(4); the Table 5 row printed.
8. resume (search checkpoint/resume): with every launch counter at 0,
   the MLP search (pop 16, 3 generations, 100 QAT steps) checkpointing
   to a temporary directory, once whole and once killed after
   generation 1 (the save hook raises) and resumed: the final
   checkpoint (population, fitness, Generator state and, screened, the
   surrogate's leaves) and the front must equal the uninterrupted run's
   bitwise; then the same with screen_factor=2, whose front must
   re-train (train_pareto_front) to its fitness bitwise. The quantizer
   must have launched twice per QAT chunk of the phase.
9. gradient (the gradient engine): with every launch counter at 0,
   run_gradient_search for the MLP and the SVM, cut in depth from the
   reference's grad_* defaults (64 lanes, 800 gate-train steps in 4
   chunks, 2 polish rounds of at most 192 exact evaluations): the MLP to
   32 lanes, the SVM to 16 lanes, 400 steps and one polish round (the
   cuts printed), each -> export_front ->
   verify_front_parity (True) -> save_front -> load_front -> serve
   through the bank kernel, served accuracies equal to the exported ones
   and the front re-training to its fitness bitwise. The MLP's gate
   train killed after chunk 1 (that chunk traced: device time,
   operations, busy share) and resumed must give the uninterrupted
   run's snapshot genomes bitwise, and the backward of its per-code
   table lookup (the one-hot product) must be bitwise equal over five
   runs (a plain gather's, a scatter of float atomics, is printed
   beside it). Printed with the card: gate-train seconds
   per step, pool size and exact evaluations, re-score, polish and total
   seconds, launches of the quantizer and the banks. The quantizer must
   have launched twice per QAT chunk (counted around
   search._train_and_score), and each bank at least once.
10. cosearch (the streaming co-design path): with every launch counter
   at 0, at the reference benchmark's configuration (cosearch_stream:
   bits 3, hidden 4, pop 16, 4 generations, 60 QAT steps, seed 0),
   nothing cut: the MLP on the stress stream (FeatureSpec(4, 32): 495 /
   225 windows, 16 feature channels) and the SVM on the vitals stream
   (FeatureSpec(6, 24): 24 feature channels, a window that is no power
   of two). Each: build_search_inputs (featurize on the card, the
   per-channel AdcSpec auto-ranged over the variant stack), the ADC-only
   search on variant 0, embed_adc_only, the co-search seeded with it;
   the embedded front must re-score to its ADC-only accuracies bitwise
   and the co-search front must ε-dominate the union front (1e-9);
   export_front -> verify_front_parity (True) -> served accuracies on
   raw test windows equal to the exported ones bitwise -> design 0
   alone (the D=1 entry) -> save_front / load_front (the FeatureSpec
   and the served accuracies kept) -> raw windows through the batch
   driver in 1024-window microbatches. The same for the stress MLP at
   the benchmark's --smoke configuration (150 / 80 windows, 2 bits, pop
   8, 2 generations, 30 steps; row 2 at 2^N=4; its 0.9375 is the
   majority share of its test cut, not learning). Then the gradient
   engine with a frontend on the stress MLP and on the vitals SVM, cut
   to 32 lanes (printed): export, verify, serve; the vitals SVM learns,
   so its best accuracy must beat the test split's majority share. The
   quantizer must have launched twice per QAT chunk and rows 3-6 at
   least once. After the path: featurize on the card equal to the
   CPU's at every factor, row 2 bitwise against its plain version at
   every co-search shape the path gave it (each (stream, spec, windows,
   pop_size): the whole (V*M, C) stack of each split; timed at the
   train stack beside its bound), rows 3-6 against theirs on every
   exported front per
   subsample group, bitwise. Printed with the card: seconds
   per generation of the baseline and the co-search, the gradient
   engine's seconds to a front, windows/s of raw-window serving and
   featurize's share of it, row 2's device time, the launches.
11. async (the serving engine): with every launch counter at 0,
   serving_engine.run_workload on cuda at the reference serve_scale
   cell's shape, nothing cut (bursty traffic, 256 requests of 8 rows per
   tenant, deadline 500 ms, target 25 ms, max_batch 256, at 200, 800
   and 3,200 req/s per tenant, for D = 1 and the whole front), with
   three tenants in one engine: the cardio MLP and SVM fixture fronts
   and the vitals SVM front phase cosearch exports (raw (24, 6)
   windows, one bank per subsample group); then a device loss at bank
   launch 1 on a pool [cuda:0, cuda:0] (deadlines 30 s: one recovery,
   every request completed), the cardio SVM tenant calibrated
   (NonIdealSpec(sigma_offset=0.3, fault_rate=0.05)) through the same
   loss (two calibrations), and the loss of a one-entry pool's last
   entry (must raise). Every response must equal the direct
   make_bank_fn prediction on the plain route (the CPU) bitwise; the
   calibrated tenant's trace arrives at 0 and its device is lost at the
   first launch after 32 rows (launch 1 at the off-table quantum 32),
   so the rows served before the loss must equal instance 0's and the
   rest instance 1's, row by row, and the two instances must differ on
   both sides. The ladder's quantum is the tuned bank tile where the
   committed table has the tenant's shape class at max_batch (the
   cardio fronts), else 32. Rows 5 and 6 are held against their plain
   versions on the card at every ladder size (the quantum to 256) on
   engine-padded batches (one request then zeros, and full), per
   subsample group for the vitals tenant: bitwise, and for the
   calibrated tables rtol=1e-5 atol=1e-6. Every tenant's served
   accuracies must equal its exported ones, and rows 5 and 6 must
   have launched. Printed per cell with the card: p50 /
   p95 / p99, req/s, samples/s, shed, batches, pad fraction and the
   ladder; the device's busy share over one traced cell.
12. sharded (the sharded search and banks, ROADMAP A9b): the batched
   engine's fitness and the unsharded inputs are taken first; then, with
   every launch counter at 0, on a mesh of [cuda:0] (one trivial shard)
   and of [cuda:0, cuda:0] (two shards on the one card) at the search
   path's width (cardio, hidden 5, 4-bit tree ADC, pop 16, 100 steps):
   evaluate_population_sharded must equal the batched engine's fitness
   bitwise for the MLP, the SVM, the robust MLP (32 instances,
   ROBUST_NI), the FT SVM ('yield') and the vitals co-search SVM, on 16
   genomes with 2 duplicates, and for the MLP and SVM on 15 unique
   genomes on [cuda:0, cuda:0] (the size-1 'model' rule) and on a
   one-axis ('data',) mesh no rule divides (the batched fallback), with
   one QAT chunk per shard (2 row-2 launches each, and 1 of row 8 or 10
   for the robust configs); run_search(engine='sharded', mesh=[cuda:0,
   cuda:0]) for 2 generations -> export_front -> verify_front_parity ->
   served_accuracies(mesh=) == exported bitwise, and killed after
   generation 1 and resumed == uninterrupted bitwise;
   adc_quantize_population_sharded == the plain quantizer bitwise;
   classifier_bank_sharded on the fixture fronts (on both meshes and on
   the one-axis mesh, where the SVM's D=3 divides nothing) and on the
   wide D=64, M=65536 banks == the unsharded bank == the plain version
   bitwise, one launch per shard; the batch driver's per-request
   predictions on [cuda:0, cuda:0] == the plain route's, and one
   serve_classifier --sharded call on the default mesh; the serving
   engine on a sharded pool [cuda:0, cuda:0] (a live mesh before the
   loss at launch 1, none after it, one recovery, every response == the
   plain route's), a calibrated SVM tenant tiled to D=6 through the same
   loss (instance 0 then 1), and the loss of a one-entry pool's last
   entry (must raise). Rows 2, 5, 6, 8 and 10 must have launched. After
   the count: one pop-16 MLP generation batched and sharded on both
   meshes, in turns, and make_bank_fn per call at the serve batch
   (M=1024), unsharded and on [cuda:0, cuda:0], printed with the card.
13. lm (the LM serving path): with every launch counter at 0,
   repro_torch.launch.serve.main serves musicgen-medium at its full
   published config (48 layers, d_model 1536, 24 heads, dh 64; random
   seeded weights) on cuda: 4 requests, prompt 2048, 16 decode steps. The
   tensor-core flash kernel must launch exactly 48 times (once per layer
   of the prefill) and the CUDA-core one never, the (4, 16) generated
   matrix and every logit must be finite;
   prefill's last-position logits must equal logits_fn's (2e-2), and one
   decode step after prefill(extra_slots=1) the forward over the ragged
   2049-long sequence: 3e-2 in float32 activations (path lm_f32: that
   prefill and decode step, counted from 0, must launch the CUDA-core
   kernel 48 times and the tensor-core one never), 1.25e-1 in the served
   bf16 (twice its reading; each bf16 path is printed against the float32
   forward, and the bf16 forward with the plain attention in place of the
   kernel, as witnesses that the gap is rounding), a limit that must
   reject a decode whose layers read the next layer's cache and one with
   a 64-slot tile of the cache zeroed. Then a warm prefill and 16 warm
   decode steps are timed, and one prefill and one decode step traced
   (flash kernel device time, device operations, device busy share); so
   is the warm float32 prefill of the lm_f32 path (4 x 2048, 48 CUDA-core
   launches), beside the stated baseline of the CUDA-core kernel this one
   replaced (3.185 ms a call x 48 launches).
14. train (LM training, ROADMAP A11): (1/4) the attention backward
   against the plain autograd in float32 at the same inputs, TF32 off,
   on both routes: the tensor-core kernel (csrc/flash_attention_bwd_tc.cu)
   for bf16 at dh 64/96/112/128/256, the CUDA-core kernel
   (csrc/flash_attention_bwd.cu) for float32 and bf16 at other widths:
   musicgen-medium's per-layer shape (B 4, S 2048, H = KV = 24, dh 64,
   causal) in bf16 and float32, GQA with a window and a softcap at dh 96
   (S 1030) and 128 (S 777), a ragged S = 77 with empty key slots, and
   bf16 GQA at dh 80 (the CUDA-core kernel's bf16 instantiation); each
   gradient within |got - want| <= rtol |want| + atol max|want| (bf16
   2^-7 and 2^-12, float32 1e-5 and 1e-5), two runs bitwise equal, each
   call counted once on its route's key; a dropped 64-key tile and the
   wrong kv head must exceed the bound in every gradient, and 100-fold in
   the one where the fault shows most, in both dtypes; then
   timed at musicgen's shape, each pass's device time on both routes
   (bf16 on the CUDA-core kernel too, called directly for the
   comparison), beside the plain autograd, the bound and
   scaled_dot_product_attention's backward (the yardstick; the port never
   calls it); each pass's shared memory must equal the envelope's. (2/4)
   the smoke configs of musicgen-medium and deepseek-7b, float32: loss
   (1e-5), every gradient leaf (rtol 1e-4, atol 1e-6) and two
   microbatched train steps (loss, lr, grad_norm 1e-4; params 2e-5) on
   the card against the CPU. (3/4)
   repro_torch.launch.train.main at smoke size on the card, uninterrupted
   and with a failure injected through run_with_recovery: the final
   checkpoints bitwise equal. (4/4) musicgen-medium at its full published
   config (1,818,378,240 parameters, bf16 activations, float32 params and
   AdamW state, remat full) through launch.train.build ->
   steps.init_state -> make_train_step, the functions main uses (main's
   final checkpoint at this size would write 22 GB): batch 8 x 2048 in 2
   microbatches, 4 steps (depth cut in steps only), the launch counters
   at 0: 192 tensor-core forward launches (forward and remat) and 96
   tensor-core backward calls a step, no CUDA-core forward or backward
   (the traced step's device kernels agree); the first loss within 1.5
   of ln 2048, every loss and grad norm finite, the params changed; warm
   s/step, tokens/s, 6 N tokens / step time against the bf16 dense peak,
   peak memory, and one traced step (device busy share; row 11's forward
   and the backward kernel's device time).
15. moe (the moe family, ROADMAP A11.1; the path "moe" counts the two
   serve calls and the training steps, each from 0): kimi-k2-1t-a32b
   (bf16, cut to 2 layers: its dense first layer and one moe layer) and
   llama4-scout-17b-a16e (float32 params, cut to 2 layers, heads
   unpadded: 40 over 8 kv heads, ROADMAP C) at their published widths,
   seeded weights, through launch.serve.serve: 4 x 2048 prompts, 16
   decode steps; the tensor-core attention (dh 112, 128) once a layer of
   the prefill and never the CUDA-core route; every moe layer's routed
   output (8 prefill tokens, every decode step's 4) against a direct
   float32 recomputation of the same routing and capacity rule, per
   token within 1 % of its norm, a pair routed to another expert beyond
   100x that; the dropped pairs printed; prefill == logits_fn (2e-2);
   a warm and a traced prefill, 16 warm and one traced decode step,
   peak memory. llama4-scout trained at full layer width (1 layer, bf16
   masters and AdamW state), 4 x 2048 in 2 microbatches, 3 steps and a
   traced one: the tensor-core backward at dh 128 once a layer a
   microbatch, no CUDA-core route; the first loss within 1.5 of ln V,
   finite losses, norms and aux, the params changed; s/step, tokens/s,
   6 N_active tokens / step time against the bf16 peak, peak memory, the
   device split (row 11, row 11b by pass, the rest); one full-width moe
   layer's forward and backward twice, bitwise. The smoke configs of
   both, float32, card against CPU (path moe_smoke: the CUDA-core
   routes at dh 16): prefill and two decode steps (1e-4), three train
   steps (phase train's bounds), a replayed step bitwise.
16. ssm (the ssm and hybrid families, ROADMAP A11.2-A11.3; the path
   "ssm" counts the two serve calls and the two trainings, each from 0):
   rows 11 and 11b at hymba's layer (B 4, S 2048, 25 heads over 5 kv
   heads, dh 64, window 1024, bf16), a shape no other path runs, each
   against its plain version (the bf16 flash limit; BWD_TOL, two runs
   bitwise) with a dropped kv tile and the wrong kv head as controls,
   timed beside the bound and SDPA with the window's mask (the
   yardstick). mamba2-1.3b (48 layers, d_model 2048, state 128,
   1,343,625,216 parameters) and hymba-1.5b (32 layers, d_model 1600,
   state 16, 1,640,765,696 parameters) at their published configs,
   uncut, seeded: launch.serve.serve, 4 x 2048 prompts and 16 decode
   steps (hymba: the tensor-core attention once a layer of the prefill,
   mamba2: no kernel at all); prefill == logits_fn (2e-2); 4 decode
   steps == teacher forcing in float32 (3e-2) and in the served bf16
   (1.25e-1), a zeroed SSD state and a conv_x tail shifted by one token
   as controls; a warm and a traced prefill and decode step, each traced
   window's device time split into the float32 products (the SSD's),
   the bf16 products, rows 11/11b and the rest. Both trained uncut
   through launch.train.build -> steps.init_state -> make_train_step,
   8 x 2048 in 2 microbatches, 3 steps and a traced one (hymba: 2
   tensor-core forwards and 1 tensor-core backward a layer a
   microbatch); the first loss within 1.5 of ln V, s/step, tokens/s,
   6 N tokens / step time against the bf16 peak, peak memory, the same
   split; one microbatch's loss and every gradient leaf twice, bitwise.
   The smoke configs card against CPU (path ssm_smoke: hymba's dh 16 on
   the CUDA-core routes): prefill and 4 decode steps (1e-4), three train
   steps, a replayed step bitwise.
17. local_global_vlm (the local_global and vlm families, ROADMAP
   A11.4-A11.5; the path "local_global_vlm" counts gemma2's serve call
   and steps and qwen2-vl's prefill, decode and steps, each from 0):
   rows 11 and 11b at gemma2's layer (B 1, S 8192, 8 heads over 4, dh
   256, softcap 50, window 4096 and global): row 11b on its route in
   each type (bf16 on the tensor-core kernel's dh-256 geometry, counted
   on flash_attention_bwd_tc; float32 on the CUDA-core kernel's 32-row
   tiles, counted on flash_attention_bwd) and, in bf16, on the CUDA-core
   kernel called directly, each against the plain autograd (BWD_TOL, two
   runs bitwise; keys 1024..1087 dropped and the wrong kv head rejected
   on every gradient and by 100x on one, each control's dq / dk / dv
   shares printed), each pass's device time beside the bound, the plain
   autograd and SDPA's backward without the softcap (a yardstick; n/a
   where it refuses); row 11's tensor-core forward
   there against its plain version. gemma2-2b at its published widths,
   uncut (26 layers as 13 (local 4096, global) pairs, d_model 2304, dh
   256, softcaps 50/30, post-norms, tied 256k embedding), 8 heads over 4
   unpadded (ROADMAP C): launch.serve.serve 1 x 8192 + 8 decode steps
   (the tensor-core forward once a layer of the prefill, nothing else);
   prefill == forward (2e-2); decode == teacher forcing over 4 steps
   after prefill(extra_slots) in float32 (3e-2; a zeroed local ring and
   a zeroed global cache must fail it) and in bf16 held to the float32
   forward (within 2x the bf16 forward's distance, the controls beyond
   it; lm's 1.25e-1 gate printed); trained uncut at 1 x 8192, float32
   masters and AdamW, 3 steps and a traced one (52 tensor-core forwards
   and 26 tensor-core backwards at dh 256 a step), a replayed microbatch's
   loss and gradient leaves bitwise. qwen2-vl-72b at its published
   widths (d_model 8192, 64 heads over 8 of 128, d_ff 29568, vocab
   152064, 1280 frontend features through the 4-bit ADC, M-RoPE (16, 24,
   24), theta 1e6), cut in depth to the most float32 layers the card
   holds beside 8 GB of work (printed): 2 x 2048 vision prompts (an image
   of 1 x 32 x 48 patches at its M-RoPE grid, data.lm.mrope_grid_positions,
   then 512 text tokens) through make_prefill_step / make_decode_step (one
   tensor-core forward a layer, nothing else), 8 decode steps; prefill ==
   forward; M-RoPE's witness (the grid against its t component alone
   must move the float32 forward's final hidden states beyond 1e-3);
   decode == teacher forcing after a
   text prompt of 2048 (after a vision grid the reference's kpos and ring
   slot take position for token count, ROADMAP C; float32 gate, a zeroed
   cache and the layers' caches rolled as controls; bf16 as for gemma2);
   trained at 2 layers on the grid, 2 x 2048 in 2 microbatches,
   3 steps, a traced one, the replay bitwise. The smoke configs card
   against CPU (path local_global_vlm_smoke, dh 16 on the CUDA-core
   routes): prefill and 4 decode steps (1e-4), three train steps, a
   replayed step bitwise.
18. dp_train (data-parallel LM training with int8 error-feedback
   compression, ROADMAP A11.6 and A11.9's dp half; the path "dp_train"
   counts the 4 int8 steps from 0): optim/compression.py's ring at n =
   2, 3, 8, compressed_mean at pod 2 x data 2 and 8 syncs of sync_grads
   over 4 ranks, every rank on the card, bitwise against the same calls
   on the CPU (the reference test's inputs), the ring within (n + 1) / 4
   int8 steps of the true mean, error feedback beating the first sync
   and its zeroed-rows control not. musicgen-medium at its published
   config with grad_compression="int8" at data 2 on [cuda:0, cuda:0],
   8 x 2048 in 2 microbatches: the memory reckoning printed first; a
   gradient step (synced gradients, loss, new error rows) replayed
   bitwise through host copies, the host's issue time of the replay
   beside its wall (each rank's microbatch loop is its unit of
   tensor_parallel.map_ranks, every rank issued from one thread); the
   int8 gradients within 1.25 int8 steps of the ranks' largest
   gradient from the float32 mean of each rank's rows through the
   one-device step (their distance from the uncompressed step's
   printed); 4 steps (s/step, tokens/s, peak
   memory, err absmax, 384 tensor-core forwards and 192 backward calls
   a step), then one step with the sync timed (host clock, synchronized
   around each call). The one-device step timed, and one traced step
   of the int8 and of the one-device step (device ms, kernels, and the
   busy share: device time over the untraced warm step's wall, beside
   the traced wall). The uncompressed data-2 step is FSDP's (phase
   fsdp).
19. dryrun (the LM dry run and its roofline analysis, ROADMAP A11.7-
   A11.8; the path "dryrun" counts its musicgen steps from 0):
   musicgen-medium's training step at phase train's shape (8 x 2048 in
   2 microbatches) counted by launch/analysis.count_step twice, around
   the real step on the card (rows 11 and 11b launching) and on meta
   tensors: FLOPs, the matrix-product calls, the hand-kernel units (calls,
   FLOPs, bytes), every aten op's calls and traffic and the copies
   between devices must be equal. The H100 row's roofline of that count
   beside the measured warm s/step and peak memory; the dry run's
   per-device argument bytes (parameters, AdamW state, batch) must not
   exceed the measured peak. Then launch/dryrun.run_cell at the single
   production mesh for musicgen-medium's train_4k, prefill_32k and
   decode_32k and kimi-k2-1t-a32b's train_4k, each ok (data-sheet
   estimates, no measurement).
20. tp (tensor parallelism over 'model', ROADMAP A11.9; the path "tp"
   counts each tensor-parallel call from 0): qwen2-vl-72b (20 layers,
   bf16 weights), llama4-scout, gemma2-2b and mamba2-1.3b split over
   [cuda:0, cuda:0] (and two distinct cards where visible) against one
   card on the same weights (see phase_tp); every rank's work between
   two collectives goes through tensor_parallel.map_ranks, in rank
   order on one host thread.
21. fsdp (FSDP over the dp axes, the reference's default and extra_dp
   parameter rules; the path "fsdp" counts each case's first two-step
   run from 0): musicgen-medium at its published config, 8 x 2048 in 2
   microbatches, at (2, 1) and (2, 2) (extra_dp: four (data, model)
   batch ranks reading two owners' pieces), and gemma2-2b uncut (heads
   unpadded), 2 x 8192, at (2, 2) (FSDP with the 'model' split), each
   on cuda:0 repeated: each position's held bytes of parameters and
   AdamW state (rank 0's equal to the dry run's per-device bytes, no
   position more), step 0's loss and grad norm within 2^-7 and every
   gradient leaf within 2^-4 of one card's on the same init and batch,
   two runs of two steps bitwise, rows 11 and 11b launched by every
   rank of every slice, s/step and peak memory beside one card's.

It prints one JSON line of kernel results, one entry per kernel (row 11
has two, one per route, and so has its backward, 11b; launches summed over the
serve, search, robust, baseline, resume, gradient, cosearch, async,
sharded, lm, lm_f32, train, train_smoke, train_cli, moe, moe_smoke, ssm,
ssm_smoke, local_global_vlm, local_global_vlm_smoke, dp_train, dryrun,
tp and fsdp paths, each counted from 0),
then the card's name and power limit, and, last, the
``{"ok": true, "device": ...}`` line. Any failed check, build or launch
exits non-zero before that line; so does a missing card or a directory
that does not hold the port.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"


def port_analysis():
    """The checkout's repro_torch.launch.analysis: the H100 row and the
    attention cost formulas the bounds below share with the dry run."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.launch import analysis
    return analysis


def bf16_peak() -> float:
    """Dense bf16 on the tensor cores, the H100 data sheet's
    (analysis.H100)."""
    return port_analysis().H100.peak_flops

FRONTS = ROOT / "tests" / "fixtures" / "fronts"
DATASET = "cardio"

REPS = 200
WARMUP = 20
AUTOTUNE_REPS = 100              # launches timed per candidate tile

KERNELS = {
    "adc_quantize": {"row": 1, "replaces": "src/repro/kernels/adc_quantize.py:101",
                     "pallas": "adc_quantize_pallas (the P=1 call)",
                     "source": "src/repro_torch/kernels/csrc/adc_quantize.cu"},
    "adc_quantize_population": {
        "row": 2, "replaces": "src/repro/kernels/adc_quantize.py:139",
        "pallas": "adc_quantize_pallas_population",
        "source": "src/repro_torch/kernels/csrc/adc_quantize.cu"},
    "bespoke_mlp": {"row": 3, "replaces": "src/repro/kernels/qmlp.py:140",
                    "pallas": "bespoke_mlp_pallas (the D=1 call)",
                    "source": "src/repro_torch/kernels/csrc/qmlp_bank.cu"},
    "bespoke_svm": {"row": 4, "replaces": "src/repro/kernels/qmlp.py:178",
                    "pallas": "bespoke_svm_pallas (the D=1 call)",
                    "source": "src/repro_torch/kernels/csrc/qmlp_bank.cu"},
    "qmlp_mlp_bank": {"row": 5, "replaces": "src/repro/kernels/qmlp.py:210",
                      "pallas": "bespoke_mlp_bank_pallas",
                      "source": "src/repro_torch/kernels/csrc/qmlp_bank.cu"},
    "qmlp_svm_bank": {"row": 6, "replaces": "src/repro/kernels/qmlp.py:250",
                      "pallas": "bespoke_svm_bank_pallas",
                      "source": "src/repro_torch/kernels/csrc/qmlp_bank.cu"},
    "mc_adc_eval": {"row": 7, "replaces": "src/repro/kernels/mc_eval.py:92",
                    "pallas": "mc_adc_eval_pallas (the P=1 call)",
                    "source": "src/repro_torch/kernels/csrc/mc_eval.cu"},
    "mc_adc_eval_population": {
        "row": 8, "replaces": "src/repro/kernels/mc_eval.py:129",
        "pallas": "mc_adc_eval_pallas_population",
        "source": "src/repro_torch/kernels/csrc/mc_eval.cu"},
    "mc_adc_eval_cal": {"row": 9,
                        "replaces": "src/repro/kernels/mc_eval.py:194",
                        "pallas": "mc_adc_eval_cal_pallas (the P=1 call)",
                        "source": "src/repro_torch/kernels/csrc/mc_eval.cu"},
    "mc_adc_eval_cal_population": {
        "row": 10, "replaces": "src/repro/kernels/mc_eval.py:231",
        "pallas": "mc_adc_eval_cal_pallas_population",
        "source": "src/repro_torch/kernels/csrc/mc_eval.cu"},
    "flash_attention_tc": {
        "row": 11, "replaces": "src/repro/kernels/flash_attention.py:74",
        "pallas": "flash_attention_pallas (bf16 at the configs' head "
                  "widths: the tensor-core route)",
        "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu"},
    "flash_attention": {
        "row": 11, "replaces": "src/repro/kernels/flash_attention.py:74",
        "pallas": "flash_attention_pallas (float32, and bf16 at other head "
                  "widths: the CUDA-core route)",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu"},
    "flash_attention_bwd_tc": {
        "row": "11b", "replaces": "src/repro/models/layers.py:96",
        "pallas": "none: the gradient of row 11's function, which the "
                  "reference takes by XLA's autodiff of layers.attention "
                  "(bf16 at dh 64/96/112/128/256: the tensor-core route)",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_tc.cu"},
    "flash_attention_bwd": {
        "row": "11b", "replaces": "src/repro/models/layers.py:96",
        "pallas": "none: the gradient of row 11's function, which the "
                  "reference takes by XLA's autodiff of layers.attention "
                  "(float32, and bf16 at other widths: the CUDA-core route)",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"},
}
# the device kernel each launch counter counts, as torch.profiler names it
FLASH_DEVICE_NAMES = {"flash_attention_tc": "flash_attention_tc_kernel",
                      "flash_attention": "flash_attention_kernel"}
# each backward route's three device kernels, in launch order (row
# statistics, dk/dv, dq: one launch each per call of the wrapper); no name
# is part of another
BWD_DEVICE_NAMES = {
    "flash_attention_bwd_tc": ("stats_tc_kernel", "dkdv_tc_kernel",
                               "dq_tc_kernel"),
    "flash_attention_bwd": ("row_stats_kernel", "dkdv_kernel", "dq_kernel")}
BWD_PASSES = ("stats", "dkdv", "dq")


def bwd_route_products(route: str, dh: int) -> int:
    """Products of dh multiply-adds a visible (query, key) pair each
    backward route runs: S and dP in each of three passes and the three
    gradient products, those as hi/lo pairs on the tensor cores (12); at
    dh 256 the tensor-core dk/dv pass walks the q tiles twice, dv then dk,
    and computes S^T in both (13)."""
    if route == "flash_attention_bwd_tc":
        return 13 if dh > 128 else 12
    return 9


# the search's main path: the fixture fronts' config at cardio's width
SEARCH = dict(bits=4, pop_size=16, generations=3, train_steps=100)
# the robust path: the same shape with 32 Monte-Carlo instances
ROBUST = dict(SEARCH, mc_samples=32)
# the gradient path's cuts of depth (the reference's grad_* defaults: 64
# lanes, 800 gate-train steps in 4 chunks, 2 polish rounds of at most 192
# exact evaluations), to keep the phase near 90 s on a host-bound card
GRADIENT_CUTS = {"mlp": dict(grad_points=32),
                 "svm": dict(grad_points=16, grad_train_steps=400,
                             grad_polish_rounds=1)}
# the co-search path: the reference benchmark's configuration
# (benchmarks/run.py, cosearch_stream without --smoke), nothing cut; the
# MLP on the stress stream, the SVM on the vitals stream
COSEARCH = dict(bits=3, hidden=4, pop_size=16, generations=4,
                train_steps=60, seed=0)
COSEARCH_STREAMS = {"stress": ("mlp", dict(channels=4, window=32)),
                    "vitals": ("svm", dict(channels=6, window=24))}
# the same benchmark's --smoke configuration (the stress stream cut to 150
# train / 80 test windows, 2 bits, pop 8, 2 generations, 30 steps): row 2
# at 2^N = 4 and banks of several designs. Its test cut is 75 of 80
# windows of one class, so its 0.9375 is that majority share, not
# learning; the vitals SVM is the front that learns
COSEARCH_SMOKE = dict(bits=2, hidden=4, pop_size=8, generations=2,
                      train_steps=30, seed=0)
COSEARCH_SMOKE_WINDOWS = (150, 80)
COSEARCH_EPS = 1e-9              # the benchmark's ε-dominance slack
# the gradient engine with a frontend, cut in depth as phase gradient's
# MLP is (the reference's defaults: 4 x pop_size = 64 lanes), on both
# streams at the full configuration; the vitals SVM learns there, so its
# front must beat the test split's majority share (the stress MLP scores
# chance on every genome in both packages, ROADMAP §C)
COSEARCH_GRADIENT_CUT = dict(grad_points=32)
COSEARCH_GRADIENT_LEARNS = ("vitals",)
# raw-window serving: 8 microbatches of 1024 windows, 8-window requests
COSEARCH_SERVE = dict(batch=1024, request_size=8, batches=8)
# the async serving path: the reference serve_scale cell's shape
# (benchmarks/run.py, bench_serve_scale without --smoke), nothing cut:
# bursty traffic, 256 requests of 8 rows per tenant, deadline 500 ms,
# target 25 ms, max_batch 256, at each offered rate per tenant, for D = 1
# and the whole front; three tenants in one engine (the cardio fixture
# fronts and the vitals SVM front phase cosearch exports, raw windows)
ASYNC = dict(requests=256, request_size=8, deadline_ms=500.0,
             target_latency_ms=25.0, max_batch=256, shape="bursty")
ASYNC_RATES = (200.0, 800.0, 3200.0)
ASYNC_TRACED = ("front", 800.0)  # the cell traced with torch.profiler
# a device loss at bank launch 1 on a pool of two entries of the card,
# deadlines far beyond the recovery stall
ASYNC_FAILOVER = dict(requests=64, rate=800.0, deadline_ms=30000.0,
                      fail_at=1)
ASYNC_CAL_NI = dict(sigma_offset=0.3, fault_rate=0.05, seed=0)
# the calibrated tenant loses its device at the first launch after this
# many rows (the off-table quantum: launch 1 there, as before tuning)
ASYNC_CAL_SPLIT_ROWS = 32
ROBUST_NI = dict(sigma_offset=0.5, sigma_range=0.01, fault_rate=0.02,
                 seed=0)
# the wide Monte-Carlo call: 64 x 32 x 8192 x 21 float32 outputs, 1.41 GB
MC_WIDE = dict(P=64, S=32, M=8192)
# the LM path: musicgen-medium at its full published config
LM = dict(arch="musicgen-medium", requests=4, prompt_len=2048, gen=16)
EX2_PER_SM_PER_CLOCK = 16        # special-function unit exponentials
FLASH_F32_TOL = dict(rtol=2e-5, atol=2e-5)   # the JAX package's own test
# bf16: two ulps of the output at its magnitude (2^-6 relative), for the
# output's rounding on both sides, plus one ulp at 1.0 (2^-7 absolute),
# for p rounded to bf16 against different running maxima (the kernel's
# online max, the plain version's row max) carried to an O(1) output.
# The largest error seen, 1.56e-2 at an output below 1, is 0.97 of a
# limit without that floor
FLASH_BF16_TOL = dict(rtol=2 ** -6, atol=2 ** -7)
FLASH_QK_STD = 1.5               # scores' std 2.25: a peaked softmax
LM_TEACHER_F32_TOL = 3e-2        # tests/test_steps_lm.py's tolerance
# musicgen's float32 flash call on the CUDA-core kernel the 8 x 8 design
# replaced (NVIDIA H100 80GB HBM3, 700.00 W): the lm_f32 prefill's
# stated baseline
BASELINE_CUDA_CORE_MS = 3.185
LM_TEACHER_BF16_ATOL = 1.25e-1   # 2x the largest sound bf16 reading
# the training path: musicgen-medium at its full published config, batch
# 8 x 2048 tokens in 2 microbatches, a few steps (depth in steps only)
TRAIN = dict(arch="musicgen-medium", batch=8, seq=2048, microbatches=2,
             steps=4)
# the smoke configs trained on the card against the CPU (float32)
TRAIN_SMOKE = dict(archs=("musicgen-medium", "deepseek-7b"), batch=4,
                   seq=64, microbatches=2, steps=2)
# the launcher at smoke size on the card, one failure injected
# (the reference test_train_loss_decreases' batch, sequence and steps:
# shorter runs at batch 2 do not improve reliably, and main then fails)
TRAIN_CLI = dict(steps=30, batch=8, seq=64, ckpt_every=10, fail_at=17)
# the backward kernel against the plain autograd in float32 at the same
# inputs: |got - want| <= rtol |want| + atol max|want| per gradient. bf16:
# one bf16 ulp of the element (2^-7 relative at the bottom of a binade,
# for the two sides' roundings of float32 values 2e-6 apart) plus 2^-12 of
# the largest element; float32: 1e-5 and 1e-5 (measured 2.4e-6 of the
# largest element). Both controls (a dropped 64-key tile, the wrong kv
# head) must exceed it in every gradient and by TRAIN_CONTROL_FACTOR in
# the one where the fault shows most (bwd_control_rejected)
BWD_TOL = {"bfloat16": (2 ** -7, 2 ** -12), "float32": (1e-5, 1e-5)}
TRAIN_CONTROL_FACTOR = 100.0
# smoke train step, card against CPU, float32: loss, grad leaves (the JAX
# parity tests' bounds), the step's params
TRAIN_SMOKE_TOL = dict(loss=1e-5, grad=(1e-4, 1e-6), metrics=1e-4,
                       params=2e-5)


# the moe path (ROADMAP A11.1): both published moe configs at their full
# widths, cut in depth (kimi-k2: its first_k_dense dense layer and one moe
# layer; llama4-scout unpadded, 40 heads over 8 kv heads, ROADMAP C)
MOE_SERVE = (("kimi-k2-1t-a32b", dict(num_layers=2)),
             ("llama4-scout-17b-a16e", dict(num_layers=2, pad_heads_to=0)))
MOE = dict(requests=4, prompt_len=2048, gen=16, check_tokens=8)
# llama4-scout trained at full layer width: one layer, bf16 masters and
# AdamW state (kimi-k2's published choice for moe masters): float32 ones
# would need ~85 GB at depth 1
MOE_TRAIN = dict(arch="llama4-scout-17b-a16e",
                 cut=dict(num_layers=1, pad_heads_to=0,
                          param_dtype="bfloat16", opt_state_dtype="bfloat16"),
                 batch=4, seq=2048, microbatches=2, steps=3)
# the moe smoke configs, float32, card against CPU
MOE_SMOKE = dict(archs=("kimi-k2-1t-a32b", "llama4-scout-17b-a16e"),
                 batch=4, seq=32, microbatches=2, steps=3, prompt=16)
MOE_SMOKE_LOGITS_TOL = 1e-4      # tests/test_torch_moe.py's logits bound
# a moe layer's routed output (bf16 activations) against its float32
# recomputation from the same bf16 input and weights, per token t:
# ||got_t - want_t|| / ||want_t|| <= MOE_BF16_TOL. The port rounds h, g,
# their SwiGLU product, the expert output, the gate and each of the k
# partial sums to bf16 (2^-9 relative each), the partial sums most: about
# 0.7 % at top-8 and d 7168, the bound's scale. Routing one pair to
# another expert moves the token by about sqrt(2) g_j / ||g|| of its norm:
# the control takes the checked token where that is largest, and must
# exceed the bound TRAIN_CONTROL_FACTOR-fold
MOE_BF16_TOL = 1e-2
# decode == teacher forcing for the ssm and hybrid families: float32 is
# the gate (LM_TEACHER_F32_TOL; a zeroed SSD state and a conv tail
# shifted by one token must exceed it). In bf16 at full depth the
# reference's own rounding (dt projected in bf16, then exponentiated
# into the decays) leaves the forward and decode alike 0.15-0.27 from
# the float32 forward (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md), over
# lm's 1.25e-1 gate, and a zeroed state hides inside it. So bf16 decode
# is held to the float32 forward: no further from it than
# SSM_BF16_FACTOR times the bf16 forward is (lm's "twice the sound
# reading"), a bound the shifted conv tail must exceed; its distance
# from the bf16 forward is printed against lm's gate
SSM_BF16_FACTOR = 2.0
# the ssm and hybrid families (ROADMAP A11.2-A11.3): both published
# configs, uncut (configs/mamba2_1p3b.py, arXiv:2405.21060;
# configs/hymba_1p5b.py, arXiv:2411.13676)
SSM_ARCHS = ("mamba2-1.3b", "hymba-1.5b")
_DTYPES = dict(dtype="bfloat16", param_dtype="float32", remat="full")
# each model's published config, field by field (check_published)
PUBLISHED = {
    "mamba2-1.3b": dict(num_layers=48, d_model=2048, vocab_size=50280,
                        num_heads=0, num_kv_heads=0, head_dim=0, window=0,
                        d_ff=0, state_dim=128, ssm_head_dim=64, expand=2,
                        ngroups=1, conv_width=4, chunk=256,
                        params=1_343_625_216, **_DTYPES),
    "hymba-1.5b": dict(num_layers=32, d_model=1600, vocab_size=32001,
                       num_heads=25, num_kv_heads=5, head_dim=64,
                       window=1024, d_ff=5504, state_dim=16, ssm_head_dim=64,
                       expand=2, ngroups=1, conv_width=4, chunk=256,
                       params=1_640_765_696, **_DTYPES)}
# serving: 4 x 2048 prompts (on hymba's 1024-window grid), 16 decode
# steps; decode against teacher forcing over 4 steps
SSM = dict(requests=4, prompt_len=2048, gen=16, teacher=4)
# training: 8 x 2048 tokens in 2 microbatches, 3 steps and a traced one
SSM_TRAIN = dict(batch=8, seq=2048, microbatches=2, steps=3)
# the smoke configs, float32, card against CPU
SSM_SMOKE = dict(batch=4, seq=32, microbatches=2, steps=3, prompt=16,
                 decode=4)
# rows 11 and 11b at hymba's layer (bf16)
HYMBA_ATTN = dict(B=4, S=2048, H=25, KV=5, dh=64, window=1024)
# the local_global and vlm families (ROADMAP A11.4-A11.5). Rows 11 and
# 11b at gemma2's layer: its context, twice its window, bf16 and float32
GEMMA_ATTN = dict(B=1, S=8192, H=8, KV=4, dh=256, window=4096, softcap=50.0)
# ... and at qwen2-vl-72b's layer (bf16, tensor cores), on QWEN's grid
QWEN_ATTN = dict(B=2, S=2048, H=64, KV=8, dh=128)
# gemma2-2b (configs/gemma2_2b.py, arXiv:2408.00118) at its published
# widths, uncut, its 8 heads over 4 kv heads unpadded (the published
# model; the config pads to 16, ROADMAP C): a 1 x 8192 prompt, decode
# against teacher forcing over 4 steps; trained at 1 x 8192
GEMMA = dict(arch="gemma2-2b", cut=dict(pad_heads_to=0), requests=1,
             prompt_len=8192, gen=8, teacher=4)
PUBLISHED["gemma2-2b"] = dict(
    num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4, head_dim=256,
    d_ff=9216, vocab_size=256000, attn_type="local_global", window=4096,
    softcaps=(50.0, 30.0), post_norm=True, tie=True, mrope=None, theta=1e4,
    frontend=0, adc_bits=0, opt_state_dtype="float32", **_DTYPES)
GEMMA_TRAIN = dict(batch=1, seq=8192, microbatches=1, steps=3,
                   routes=("flash_attention_tc", "flash_attention_bwd_tc"))
# qwen2-vl-72b (configs/qwen2_vl_72b.py, arXiv:2409.12191) at its
# published widths, served cut in depth to 20 of its 80 layers (float32
# masters, 3.5 GB a layer: 20 fit beside the head and reserve_gb of
# work, 21 do not; checked against the card's free memory): 2 x 2048
# vision prompts, an image of 1 x 32 x 48 patches and 512 text tokens;
# trained at 2 layers (float32 masters and AdamW state, 24 bytes a
# parameter at the step's peak: 3 layers would need 93 GB), 2 x 2048 on
# the same grid
QWEN = dict(arch="qwen2-vl-72b", layers=20, requests=2, grid=(1, 32, 48),
            text=512, gen=8, teacher=4, reserve_gb=8)
# the tensor-parallel path (ROADMAP A11.9) on (1, 2) meshes. qwen2-vl-72b
# served at QWEN's depth and prompt length, a text prompt: bf16 weights,
# since the one-card tree of float32 masters (70 GB at 20 layers) and its
# split copy do not fit one card together
TP_QWEN = dict(arch="qwen2-vl-72b", layers=QWEN["layers"], requests=2,
               prompt_len=2048, gen=8)
# llama4-scout at phase moe's serving cut, a 4 x 2048 prefill; then one
# step at MOE_TRAIN's cut
TP_MOE = dict(arch="llama4-scout-17b-a16e",
              cut=dict(num_layers=2, pad_heads_to=0), requests=4,
              prompt_len=2048, check_tokens=8)
# gemma2-2b uncut, heads unpadded, trained at GEMMA_TRAIN's 1 x 8192
TP_GEMMA = dict(arch="gemma2-2b", cut=dict(pad_heads_to=0), batch=1,
                seq=8192, microbatches=1, steps=2)
# the repaired moe dp step: kimi-k2's smoke config at (2, 1)
TP_SMOKE = dict(arch="kimi-k2-1t-a32b", batch=8, seq=32, microbatches=2,
                steps=2)
# the ssm family's split (its SSD over 32 heads a rank): mamba2-1.3b at
# its published config, uncut (PUBLISHED), on a (1, 2) mesh against one
# card on the same weights; served at phase ssm's SSM shape (the gates'
# logits over its first ``teacher`` decode steps), trained at
# SSM_TRAIN's 8 x 2048 in 2 microbatches, 2 steps. ``cut``: none (a
# rehearsal on the CPU cuts it)
TP_SSM = dict(arch="mamba2-1.3b", cut={}, requests=SSM["requests"],
              prompt_len=SSM["prompt_len"], gen=SSM["gen"],
              teacher=SSM["teacher"], batch=SSM_TRAIN["batch"],
              seq=SSM_TRAIN["seq"], microbatches=SSM_TRAIN["microbatches"],
              steps=2)
# its float32 split against one card: prefill-last and decode logits. The
# split changes only the order of float32 sums (the gated norm's squares
# a rank, the output projection's partials); a control, rank 1's SSD
# state zeroed after prefill, must exceed it TRAIN_CONTROL_FACTOR-fold
TP_SSM_F32_TOL = 1e-4
# tensor parallel against one card on the same bf16 weights: the split
# rounds each rank's partial to bf16 before the sum. Served logits are
# held to LM_TEACHER_BF16_ATOL, the bf16 serving bound ("twice the
# largest sound bf16 reading"); a training step's loss and grad norm to
# one bf16 ulp relative (BWD_TOL's bf16 rtol): each gradient element may
# move by BWD_TOL, their norm and the float32 loss by no more
TP_SERVE_TOL = LM_TEACHER_BF16_ATOL
TP_TRAIN_RTOL = BWD_TOL["bfloat16"][0]
# llama4-scout's tp prefill against the one-card prefill: each moe call's
# dropped pairs, and the prefill's, within this share of its pairs. The
# split rounds each rank's bf16 partial before reduce_sum, so each layer's
# input is an ulp away from one card's and a near-tie top-k choice, and
# with it the capacity cutoff, can move: equal counts cannot be asked.
# Read on the H100: 513 and 386 of 8192 pairs dropped against one card's
# 516 and 385 (gaps 3 and 1, 0.04 %); the bound, 0.2 % (16 pairs a call),
# is five times the larger gap
TP_MOE_DROP_SHARE = 2e-3
# phase tp's gemma2-2b step 0, split against one card: every gradient
# leaf's distance from one card's over one card's norm (split leaves
# gathered whole), beside the loss and grad norm's TP_TRAIN_RTOL, which
# alone barely sees a rank reading the wrong kv heads at a random init
# (1.11e-2 against its 7.8e-3 on the H100). Read there: worst leaf
# layers2/k at 1.21e-2; the bound, 2^-4, is five times that; the planted
# faults (tp_train_faults) read 0.89-1.53
TP_GRAD_REL = 2.0 ** -4
# M-RoPE's witness: the grid's h and w components must move the float32
# forward's final hidden states (unit RMS) by more than this, 100x the
# float32 paths' 1e-5 agreement (decode against teacher forcing)
QWEN_WITNESS = 1e-3
PUBLISHED["qwen2-vl-72b"] = dict(
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064, attn_type="global", window=0,
    softcaps=(0.0, 0.0), post_norm=False, tie=False, mrope=(16, 24, 24),
    theta=1e6, frontend=1280, adc_bits=4, opt_state_dtype="float32",
    **_DTYPES)
QWEN_TRAIN = dict(num_layers=2, batch=2, seq=2048, microbatches=2, steps=3,
                  grid=(1, 32, 48), text=512,
                  routes=("flash_attention_tc", "flash_attention_bwd_tc"))
# their smoke configs, float32, card against CPU (gemma2's smoke window
# 32 binds under the 40-token prompt and the 64-token rows)
LG_SMOKE = dict(archs=("gemma2-2b", "qwen2-vl-72b"), batch=4, seq=64,
                microbatches=2, steps=3, prompt=40, decode=4, grid=(1, 4, 6))
# the CPU operations whose device kernels are matrix products
# the data-parallel path (ROADMAP A11.6 and A11.9's dp half). The int8
# ring on [cuda:0] x n meshes held bitwise to the CPU on the reference
# test's inputs (seed 0, 8 x 1000); its error against the true mean
# within (n + 1) / 4 of the inputs' int8 step (n - 1 reduce-scatter hops
# whose partials grow to (t + 1) max|x|, each half its step over n, and
# half a step in the all-gather; tests/test_torch_compression.py); 8
# syncs of one tree (keys out of sorted order, float32 and bf16 leaves)
# over 4 ranks, whose average must beat the first sync with error
# feedback and must not with the error rows zeroed (the control)
DP_RING = dict(ns=(2, 3, 8), seed=0, rows=8, cols=1000, ef_ranks=4,
               ef_steps=8)
# musicgen-medium at its published config with grad_compression="int8",
# data 2 on [cuda:0, cuda:0]: phase train's batch and steps
DP_TRAIN = dict(arch="musicgen-medium", batch=8, seq=2048, microbatches=2,
                steps=4, data=2)
# the int8 step's synced gradients against the float32 mean of the
# ranks' one-device gradients on the same state and batch (err zero),
# what the ring approximates: within 1.25 int8 steps
# of the ranks' largest gradient A (half a step of a leaf's scale in the
# fake quantization, a quarter in the one reduce-scatter hop over 2, half
# in the all-gather), plus 1e-6 A of float32 rounding
DP_INT8_STEPS = 1.25
PRODUCT_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm",
               "aten::addbmm", "aten::matmul", "aten::linear", "aten::mv",
               "aten::dot", "aten::einsum")


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def sm_clock(torch):
    """(SM clock in Hz, its source, SM count) of card 0: the clock from
    torch's device properties where they carry it, else nvidia-smi's
    maximum SM clock."""
    props = torch.cuda.get_device_properties(0)
    khz = getattr(props, "clock_rate", None)
    if khz:
        return (khz * 1e3, "torch.cuda.get_device_properties(0).clock_rate",
                props.multi_processor_count)
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return (float(res.stdout.strip().splitlines()[0]) * 1e6,
            "nvidia-smi clocks.max.sm", props.multi_processor_count)


def ptxas_report(log: str):
    """[(kernel, registers, spill store bytes, spill load bytes)] from an
    nvcc -Xptxas -v log, plus its performance warnings."""
    import re
    rows, name, spills, warn = [], None, (0, 0), []
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(\w+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spills))
            spills = (0, 0)
        if "Potential Performance Loss" in line:
            warn.append(line.strip())
    return rows, warn


# ---------------------------------------------------------------- inputs
def dyadic_case(np, rng, kind, d, m, f, h, o, bits, x_lo=-0.1, x_hi=1.1):
    """Random pruned masks baked to dyadic tables, power-of-two weights
    and fixed-point biases: every partial sum is exact, so any summation
    order gives the same bits. x strays outside [0, 1] to hit the
    clamps."""
    from repro_torch.core.adc import repair_mask
    from repro_torch.core.spec import AdcSpec
    import torch
    spec = AdcSpec(bits=bits)
    n = 2 ** bits
    masks = repair_mask(torch.from_numpy(
        (rng.random((d, f, n)) < 0.5).astype(np.int32)))
    tables = spec.value_table(masks).contiguous()

    def po2(*shape):
        e = rng.integers(-3, 1, size=shape)
        s = rng.choice([-1.0, 0.0, 1.0], size=shape, p=[0.45, 0.1, 0.45])
        return (s * np.exp2(e)).astype(np.float32)

    def fixed(*shape):
        return (rng.integers(-16, 17, size=shape) / 16.0).astype(np.float32)

    if kind == "mlp":
        weights = (po2(d, f, h), fixed(d, h), po2(d, h, o), fixed(d, o))
    else:
        weights = (po2(d, f, o), fixed(d, o))
    x = rng.uniform(x_lo, x_hi, size=(m, f)).astype(np.float32)
    return spec, x, tables, tuple(torch.from_numpy(w) for w in weights)


def float_case(np, rng, kind, d, m, f, h, o, bits, per_channel):
    """Float weights (and optionally per-channel ranges): sums round, so
    kernel and plain agree to rounding only."""
    from repro_torch.core.adc import repair_mask
    from repro_torch.core.spec import AdcSpec
    import torch
    if per_channel:
        lo = rng.uniform(-1.0, 0.5, size=f)
        spec = AdcSpec(bits=bits, vmin=tuple(lo),
                       vmax=tuple(lo + rng.uniform(0.5, 2.0, size=f)))
        x = rng.uniform(lo - 0.2, lo + 2.2, size=(m, f)).astype(np.float32)
    else:
        spec = AdcSpec(bits=bits)
        x = rng.uniform(-0.1, 1.1, size=(m, f)).astype(np.float32)
    n = 2 ** bits
    masks = repair_mask(torch.from_numpy(
        (rng.random((d, f, n)) < 0.5).astype(np.int32)))
    tables = spec.value_table(masks).contiguous()
    g = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32))
    weights = ((g(d, f, h), g(d, h), g(d, h, o), g(d, o)) if kind == "mlp"
               else (g(d, f, o), g(d, o)))
    return spec, x, tables, weights


# ---------------------------------------------------------------- timing
def cuda_ms(torch, fn, reps=REPS) -> float:
    """Mean time per call over ``reps`` back-to-back calls, CUDA events."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_kernel_ms(torch, fn, name_part: str, reps=REPS):
    """Device time per launch of the CUDA kernel whose name contains
    ``name_part``, from torch.profiler; None when the profiler records no
    device time for it."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if name_part in ev.key and ev.count:
            total = getattr(ev, "device_time_total",
                            getattr(ev, "cuda_time_total", 0.0))
            if total > 0:
                return total / ev.count / 1000.0
    return None


def device_ms_by_name(torch, fn, names, window_ms=250.0, tries=3):
    """{name: device ms per launch} of the CUDA kernels whose names
    contain each of ``names``, read as ``device_sums`` reads a trace (self
    device time of the device events, over the launches it recorded) from
    a torch.profiler window of about ``window_ms`` of device work after a
    timed warm-up call; None where ``tries`` windows record none. (In
    phase train the profiler has recorded only some of a window's
    launches, or none in windows of a few calls; the other phases' long
    windows and the step trace lose none.)"""
    from torch.profiler import ProfilerActivity, profile
    reps = max(5, int(window_ms / max(timed_ms(torch, fn, 1, warmup=1),
                                      1e-3)))
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = dict.fromkeys(names, 0.0)
        count = dict.fromkeys(names, 0)
        for ev in prof.key_averages():
            if "DeviceType.CUDA" not in str(getattr(ev, "device_type", "")):
                continue
            total = getattr(ev, "self_device_time_total",
                            getattr(ev, "self_cuda_time_total", 0.0))
            for n in names:
                if n in ev.key and ev.count and total > 0:
                    us[n] += total
                    count[n] += ev.count
        if all(count.values()):
            break
    return {n: us[n] / count[n] / 1e3 if count[n] else None for n in names}


def top_device_kernel(torch, fn, reps=3):
    """The name of the device kernel that takes most of ``fn``'s device
    time, from torch.profiler; None when it records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    best, best_us = None, 0.0
    for ev in prof.key_averages():
        if "DeviceType.CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        total = getattr(ev, "self_device_time_total",
                        getattr(ev, "self_cuda_time_total", 0.0))
        if total > best_us:
            best, best_us = ev.key, total
    return best


def kernel_bound(entry, m, c, n, **axes):
    """(bound_ms, bound_by, bytes, operations) of one launch of a
    non-attention entry (``repro_torch.perf.workload.ENTRIES``) at M
    rows, C channels and 2^N = n levels, from the port's cost model
    (``repro_torch.perf.cost_model.bound``): each input read once and
    each output written once against the card's memory rate, the
    operations against its float32 peak (the H100 data sheet)."""
    from repro_torch.perf import Workload, cost_model
    b = cost_model.bound(Workload(entry, m=m, c=c, bits=n.bit_length() - 1,
                                  **axes))
    return b["bound_s"] * 1e3, b["bound_by"], int(b["bytes"]), int(b["flops"])


# ---------------------------------------------------------------- phases
def bank_cases(np, rng, fronts, x_test):
    """The bank phase's cases: [(label, kernel name, spec, x, tables,
    weights, exact)]; ``exact``: every partial sum is exact (dyadic), so
    any summation order gives the same bits."""
    cases = []

    for kind, (designs, spec, tables, weights) in fronts.items():
        name = f"qmlp_{kind}_bank"
        cases.append((f"fixture {kind} front, test split", name, spec,
                      x_test, tables, weights, True))
        idx = rng.integers(0, len(x_test), size=1024)
        cases.append((f"fixture {kind} front, serve batch", name, spec,
                      x_test[idx], tables, weights, True))
        cases.append((f"fixture {kind} design 0 (D=1)", f"bespoke_{kind}",
                      spec, x_test, tables[:1],
                      tuple(w[:1] for w in weights), True))
        tile = np.arange(64) % len(designs)
        wide_x = x_test[rng.integers(0, len(x_test), size=65536)]
        cases.append((f"wide {kind} bank D=64 M=65536", name, spec, wide_x,
                      tables[tile], tuple(w[tile] for w in weights), True))
        for bits in (1, 4, 6):
            spec_b, x, t, w = dyadic_case(np, rng, kind, 4, 1000, 21, 5, 3,
                                          bits)
            cases.append((f"dyadic {kind} bits={bits} D=4 M=1000", name,
                          spec_b, x, t, w, True))
        spec_c, x, t, w = dyadic_case(np, rng, kind, 3, 333, 16, 20, 11, 4)
        cases.append((f"dyadic {kind} H=20 O=11 (register chunks)", name,
                      spec_c, x, t, w, True))
        spec_s, x, t, w = float_case(np, rng, kind, 2, 300, 200, 8, 4, 6,
                                     per_channel=False)
        cases.append((f"{kind} F=200 bits=6 (> 48 KB shared memory)", name,
                      spec_s, x, t, w, False))
        spec_p, x, t, w = float_case(np, rng, kind, 5, 777, 21, 5, 3, 4,
                                     per_channel=True)
        cases.append((f"{kind} per-channel ranges, float weights", name,
                      spec_p, x, t, w, False))
    for kind, f in (("mlp", 840), ("svm", 860)):
        # one design that leaves the kernel too little shared memory for
        # padded weight rows and four rows a thread: its unpadded path;
        # dyadic, so the 840-term sums are exact in any order
        spec_e, x, t, w = dyadic_case(np, rng, kind, 2, 300, f, 1, 1, 6)
        cases.append((f"dyadic {kind} F={f} bits=6 at the shared-memory "
                      f"edge", f"qmlp_{kind}_bank", spec_e, x, t, w, True))
    return cases


def phase_kernels(np, torch, dev, fronts, x_test):
    from repro_torch.kernels import envelope, qmlp, ref
    rng = np.random.default_rng(2024)
    cases = bank_cases(np, rng, fronts, x_test)

    def single(fn):
        """The single-design entry on a D=1 bank's operands, (1, M, O)."""
        return lambda x, t, *w, spec, rows=None: fn(
            x, t[0], *(a[0] for a in w), spec=spec, rows=rows)[None]

    wrappers = {"qmlp_mlp_bank": (qmlp.bespoke_mlp_bank,
                                  ref.bespoke_mlp_bank_ref),
                "qmlp_svm_bank": (qmlp.bespoke_svm_bank,
                                  ref.bespoke_svm_bank_ref),
                "bespoke_mlp": (single(qmlp.bespoke_mlp),
                                ref.bespoke_mlp_bank_ref),
                "bespoke_svm": (single(qmlp.bespoke_svm),
                                ref.bespoke_svm_bank_ref)}
    max_err = {k: 0.0 for k in wrappers}
    print("phase kernels: kernel vs plain version on the card")
    for label, name, spec, x, tables, weights, exact in cases:
        kern, plain = wrappers[name]
        xd = torch.as_tensor(x).to(dev).contiguous()
        td = torch.as_tensor(tables).to(dev).contiguous()
        wd = tuple(torch.as_tensor(w).to(dev).contiguous() for w in weights)
        kind = "svm" if "svm" in name else "mlp"
        shape = (kind, td.shape[0], xd.shape[0], td.shape[1], td.shape[2],
                 wd[0].shape[2] if kind == "mlp" else 0, wd[-1].shape[-1])
        mirror = envelope.bank_geometry(*shape)
        built = qmlp.geometry(*shape)
        check(built == tuple(mirror), f"{name} {label}: the built kernel's "
                                      f"geometry {built} != envelope's "
                                      f"{mirror}")
        check("edge" not in label or not mirror.padded,
              f"{name} {label}: expected the unpadded layout, got {mirror}")
        got = kern(xd, td, *wd, spec=spec)
        want = plain(xd, td, spec.bits, *wd, spec.vmin, spec.vmax)
        torch.cuda.synchronize()
        check(got.shape == want.shape,
              f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite logits")
        err = float((got - want).abs().max())
        max_err[name] = max(max_err[name], err)
        if exact:
            ok = torch.equal(got, want)
            rule = "bitwise"
        else:
            ok = torch.allclose(got, want, rtol=1e-5, atol=1e-6)
            rule = "rtol=1e-5 atol=1e-6"
        print(f"  {name:14s} {label:45s} shape={tuple(got.shape)} "
              f"max_abs_err={err:.3e} [{rule}, geometry ==] "
              f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"{name} disagrees with its plain version on {label} "
                  f"(max_abs_err {err:.3e}, {rule})")

    timings = {}
    for kind, (designs, spec, tables, weights) in fronts.items():
        # the front at the serve batch; design 0 alone (the D=1 call that
        # replaces bespoke_{mlp,svm}_pallas); a wide bank
        shapes = {"serve batch": (1024, np.arange(len(designs))),
                  "D=1": (1024, np.arange(1)),
                  "wide bank": (65536, np.arange(64) % len(designs))}
        for label, (m, tile) in shapes.items():
            name = (f"bespoke_{kind}" if label == "D=1"
                    else f"qmlp_{kind}_bank")
            kern, plain = wrappers[name]
            xd = torch.as_tensor(
                x_test[rng.integers(0, len(x_test), size=m)]).to(dev)
            td = torch.as_tensor(tables[tile]).to(dev).contiguous()
            wd = tuple(torch.as_tensor(w[tile]).to(dev).contiguous()
                       for w in weights)
            d, f, n = td.shape
            h = wd[0].shape[2] if kind == "mlp" else 0
            o = wd[-1].shape[-1]
            rows = tuple(t.to(dev) for t in _rows(spec, f))
            k_fn = lambda: kern(xd, td, *wd, spec=spec, rows=rows)  # noqa
            p_fn = lambda: plain(xd, td, spec.bits, *wd,  # noqa: E731
                                 spec.vmin, spec.vmax)
            # plain, kernel, kernel, plain: same card, turns interleaved
            p1 = cuda_ms(torch, p_fn)
            k1 = cuda_ms(torch, k_fn)
            k2 = cuda_ms(torch, k_fn)
            p2 = cuda_ms(torch, p_fn)
            dev_ms = device_kernel_ms(torch, k_fn, f"qmlp_{kind}_bank_kernel")
            check(dev_ms is not None, f"torch.profiler recorded no device "
                                      f"time for qmlp_{kind}_bank_kernel")
            b_ms, b_by, nbytes, flops = kernel_bound(
                f"classifier_bank_{kind}", m, f, n, d=d, h=h, o=o)
            row = {"shape": {"D": d, "M": m, "F": f, "levels": n, "H": h,
                             "O": o},
                   "ms": min(k1, k2), "plain_ms": min(p1, p2),
                   "device_ms": dev_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "bytes": nbytes, "flops": flops}
            timings.setdefault(name, {})[label] = row
            print(f"  time {name:14s} {label:12s} D={d} M={m}: "
                  f"kernel {k1 * 1e3:.2f}/{k2 * 1e3:.2f} us per call "
                  f"(profiler device time {dev_ms * 1e3:.2f} us), plain "
                  f"{p1 * 1e3:.2f}/{p2 * 1e3:.2f} us, bound "
                  f"{b_ms * 1e3:.3f} us ({b_by})")
    return max_err, timings


def _rows(spec, f):
    from repro_torch.core.adc import range_rows_tensors
    return range_rows_tensors(spec.bits, spec.vmin, spec.vmax, f)


def code_edge_inputs(np, rng, spec, m, c):
    """x (M, C) float32, uniform over each channel's range widened by a
    tenth; rows 0-2 NaN, +inf and -inf, and rows 3 .. 2^(N+1) + 2 put
    every channel on each code boundary k: x nudged, one float at a time
    and at most 64 floats, to the least float32 whose code position
    (x - lo) * scale reaches k in float32, and the float below it."""
    from repro_torch.core.adc import range_rows
    n = spec.levels
    lo, sc = (r[0].astype(np.float64) for r in range_rows(
        spec.bits, spec.vmin, spec.vmax, c))
    width = n / sc
    x = rng.uniform(lo - 0.1 * width, lo + 1.1 * width,
                    size=(m, c)).astype(np.float32)
    x[0], x[1], x[2] = np.nan, np.inf, -np.inf
    lo32, sc32 = lo.astype(np.float32), sc.astype(np.float32)
    for k in range(n):
        for ch in range(c):
            xv = np.float32(lo[ch] + k / sc[ch])
            for _ in range(64):
                u = np.float32(np.float32(xv - lo32[ch]) * sc32[ch])
                if u >= k and np.float32(np.float32(np.nextafter(
                        xv, np.float32(-np.inf)) - lo32[ch]) * sc32[ch]) < k:
                    break
                xv = np.nextafter(xv, np.float32(np.inf if u < k
                                                 else -np.inf))
            x[3 + 2 * k, ch] = xv
            x[4 + 2 * k, ch] = np.nextafter(xv, np.float32(-np.inf))
    return x


def random_masks(np, torch, rng, p, c, bits):
    """Repaired pruned masks (P, C, 2^N), as genome decode gives them."""
    from repro_torch.core.adc import repair_mask
    return repair_mask(torch.from_numpy(
        (rng.random((p, c, 2 ** bits)) < 0.5).astype(np.int32)))


def quantizer_cases(np, torch, rng, data):
    """The quantizer phase's cases: [(label, spec, x, masks, via the P=1
    entry)]."""
    from repro_torch.core.spec import AdcSpec
    x_tr, x_te = data["x_train"], data["x_test"]
    c = x_tr.shape[1]
    cases = []
    for split, x in (("train", x_tr), ("test", x_te)):
        for p in (16, 32):
            cases.append((f"cardio {split} split M={len(x)} P={p}",
                          AdcSpec(bits=4), x, random_masks(
                              np, torch, rng, p, c, 4), False))
    cases.append((f"P=1 (adc_quantize entry) M={len(x_te)}", AdcSpec(bits=4),
                  x_te, random_masks(np, torch, rng, 1, c, 4)[0], True))
    for m in (257, 1000):
        x = rng.uniform(-0.1, 1.1, size=(m, c)).astype(np.float32)
        cases.append((f"ragged M={m} P=5", AdcSpec(bits=4), x,
                      random_masks(np, torch, rng, 5, c, 4), False))
    for bits in (1, 4, 6):
        x = rng.uniform(-0.1, 1.1, size=(999, c)).astype(np.float32)
        cases.append((f"bits={bits} M=999 P=7", AdcSpec(bits=bits), x,
                      random_masks(np, torch, rng, 7, c, bits), False))
    lo = rng.uniform(-1.0, 0.5, size=c)
    spec_pc = AdcSpec(bits=4, vmin=tuple(lo),
                      vmax=tuple(lo + rng.uniform(0.5, 2.0, size=c)))
    x = rng.uniform(lo - 0.2, lo + 2.2, size=(777, c)).astype(np.float32)
    cases.append(("per-channel ranges M=777 P=6", spec_pc, x,
                  random_masks(np, torch, rng, 6, c, 4), False))
    x = rng.uniform(-0.1, 1.1, size=(600, 200)).astype(np.float32)
    cases.append(("C=200 bits=6 (table > 48 KB) P=3", AdcSpec(bits=6), x,
                  random_masks(np, torch, rng, 3, 200, 6), False))
    wide_x = x_te[rng.integers(0, len(x_te), size=65536)]
    cases.append(("wide P=64 M=65536", AdcSpec(bits=4), wide_x,
                  random_masks(np, torch, rng, 64, c, 4), False))
    for spec_e in (AdcSpec(bits=4), spec_pc):
        x = code_edge_inputs(np, rng, spec_e, 999, c)
        cases.append((f"NaN, +-inf, on code boundaries M=999 P=9"
                      f"{' per-channel' if spec_e is spec_pc else ''}",
                      spec_e, x, random_masks(np, torch, rng, 9, c, 4),
                      False))
    x = code_edge_inputs(np, rng, AdcSpec(bits=4), 635, c)    # M*C odd
    cases.append(("word walk (M*C odd), edges M=635 P=16", AdcSpec(bits=4),
                  x, random_masks(np, torch, rng, 16, c, 4), False))
    return cases


def phase_quantizer(np, torch, dev, data):
    """adc_quantize_population against ref.adc_quantize_ref_population on
    the card, bitwise, then timed at the search's shapes."""
    from repro_torch.core.spec import AdcSpec
    from repro_torch.kernels import adc_quantize as adcq
    from repro_torch.kernels import envelope, ops, ref
    rng = np.random.default_rng(2025)
    x_tr, x_te = data["x_train"], data["x_test"]
    c = x_tr.shape[1]
    cases = quantizer_cases(np, torch, rng, data)
    wide_x = next(x for label, _, x, _, _ in cases
                  if label.startswith("wide"))

    max_err = {"adc_quantize_population": 0.0, "adc_quantize": 0.0}
    print("phase kernels: adc_quantize{,_population} vs plain version on "
          "the card (bitwise)")
    for label, spec, x, masks, single in cases:
        name = "adc_quantize" if single else "adc_quantize_population"
        xd = torch.as_tensor(x).to(dev).contiguous()
        md = masks.to(dev)
        tables = spec.value_table(md).contiguous()
        shape = (1 if single else tables.shape[0], x.shape[0], x.shape[1],
                 tables.shape[-1])
        built, mirror = adcq.geometry(*shape), tuple(
            envelope.quantize_geometry(*shape))
        check(built == mirror, f"{label}: the built kernel's geometry "
                               f"{built} != envelope's {mirror}")
        if single:
            got = ops.adc_quantize(xd, md, spec=spec)
            want = ref.adc_quantize_ref(xd, tables, spec.bits, spec.vmin,
                                        spec.vmax)
        else:
            got = ops.adc_quantize_population(xd, md, spec=spec)
            want = ref.adc_quantize_ref_population(xd, tables, spec.bits,
                                                   spec.vmin, spec.vmax)
        torch.cuda.synchronize()
        check(got.shape == want.shape,
              f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        err = float((got - want).abs().max())
        max_err[name] = max(max_err[name], err)
        ok = torch.equal(got, want)
        print(f"  {name} {label:40s} shape={tuple(got.shape)} "
              f"max_abs_err={err:.3e} [bitwise, geometry ==] "
              f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"{name} disagrees with its plain version on {label} "
                  f"(max_abs_err {err:.3e}, bitwise)")
        del got, want

    timings = {}
    spec = AdcSpec(bits=4)
    shapes = {"search train P=16": (x_tr, 16), "search test P=16": (x_te, 16),
              "search train P=32": (x_tr, 32), "P=1": (x_te, 1),
              "wide P=64 M=65536": (wide_x, 64)}
    name = "adc_quantize_population"
    for label, (x, p) in shapes.items():
        xd = torch.as_tensor(x).to(dev).contiguous()
        tables = spec.value_table(random_masks(np, torch, rng, p, c, 4)
                                  .to(dev)).contiguous()
        m, n = len(x), spec.levels
        rows = tuple(t.to(dev) for t in _rows(spec, c))
        if p == 1:                           # the adc_quantize entry
            k_fn = lambda: adcq.adc_quantize(  # noqa: E731
                xd, tables[0], spec=spec, rows=rows)
        else:
            k_fn = lambda: adcq.adc_quantize_population(  # noqa: E731
                xd, tables, spec=spec, rows=rows)
        p_fn = lambda: ref.adc_quantize_ref_population(  # noqa: E731
            xd, tables, spec.bits, spec.vmin, spec.vmax)
        p1 = cuda_ms(torch, p_fn)
        k1 = cuda_ms(torch, k_fn)
        k2 = cuda_ms(torch, k_fn)
        p2 = cuda_ms(torch, p_fn)
        dev_ms = device_kernel_ms(torch, k_fn, f"{name}_kernel")
        check(dev_ms is not None, f"torch.profiler recorded no device time "
                                  f"for {name}_kernel")
        b_ms, b_by, nbytes, nops = kernel_bound(
            "adc_quantize_population", m, c, n, p=p)
        timings[label] = {"shape": {"P": p, "M": m, "C": c, "levels": n},
                          "ms": min(k1, k2), "plain_ms": min(p1, p2),
                          "device_ms": dev_ms, "bound_ms": b_ms,
                          "bound_by": b_by, "bytes": nbytes, "ops": nops}
        print(f"  time {name} {label:18s}: kernel {k1 * 1e3:.2f}/"
              f"{k2 * 1e3:.2f} us per call (profiler device time "
              f"{dev_ms * 1e3:.2f} us), plain {p1 * 1e3:.2f}/"
              f"{p2 * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us ({b_by}, "
              f"{nbytes} bytes)")
    return max_err, timings


def phase_serve(np, torch, dev, card, fronts, data):
    from repro_torch.core import deploy
    from repro_torch.kernels import qmlp, ref
    from repro_torch.launch.serve_classifier import (make_request_stream,
                                                     serve)
    requests = make_request_stream(data["x_test"], 256, 8)
    reports = {}
    print("phase serve: the serving path (load_front -> serve -> "
          "served_accuracies) on cuda")
    reset_all_launches()
    for kind in fronts:
        designs = deploy.load_front(FRONTS / f"cardio_{kind}")
        rep = serve(designs, requests, 1024, device=dev)
        served = deploy.served_accuracies(designs, data["x_test"],
                                          data["y_test"], device=dev)
        exported = np.array([d.accuracy for d in designs])
        # one design served alone: the single-design entry (D=1)
        alone = designs[0].accuracy_on(data["x_test"], data["y_test"],
                                       device=dev)
        check(alone == designs[0].accuracy,
              f"{kind}: design 0 served alone gives {alone}, exported "
              f"{designs[0].accuracy}")
        reports[kind] = (designs, rep, served, exported)
    launches = all_launches()
    print(f"  launch counters after the main path: {launches}")

    for kind, (designs, rep, served, exported) in reports.items():
        name = f"qmlp_{kind}_bank"
        for i, d in enumerate(designs):
            print(f"  {kind} design {i}: area={d.area_tc}T exported="
                  f"{d.accuracy!r} served={float(served[i])!r}")
        check(np.array_equal(served, exported),
              f"{kind}: served accuracies {served} != exported {exported}")
        # one launch per microbatch, plus the warm-up and the accuracy pass
        check(launches[name] == rep["batches"] + 2,
              f"{name}: {launches[name]} launches for {rep['batches']} "
              f"microbatches + warm-up + accuracy pass")
        print(f"  {kind}: {rep['requests']} requests ({rep['samples']} "
              f"samples, {rep['batches']} microbatches of {rep['batch']}) "
              f"in {rep['wall_s']:.4f} s: {rep['requests_per_s']:.1f} "
              f"req/s, {rep['samples_per_s']:.0f} samples/s on {card}; "
              f"parity OK")

        tables, weights = deploy.bank_arrays(designs)
        td = torch.from_numpy(tables).to(dev)
        wd = tuple(torch.from_numpy(w).to(dev) for w in weights)
        spec = designs[0].spec
        plain = (ref.bespoke_mlp_bank_ref if kind == "mlp"
                 else ref.bespoke_svm_bank_ref)
        plain_fn = lambda xb: plain(xb, td, spec.bits, *wd,  # noqa: E731
                                    spec.vmin, spec.vmax)
        plain_rep = serve(designs, requests, 1024, device=dev,
                          bank_fn=plain_fn)
        same = all(np.array_equal(rep["responses"][rid],
                                  plain_rep["responses"][rid])
                   for rid, _ in requests)
        check(same, f"{kind}: per-request predictions differ from the "
                    f"plain version's")
        print(f"  {kind}: per-request predictions == plain version's "
              f"({len(requests)} requests)")
        # a longer run of the same driver, for a steadier rate
        long_reqs = make_request_stream(data["x_test"], 8192, 8, seed=1)
        long_rep = serve(designs, long_reqs, 1024, device=dev)
        print(f"  {kind}: {long_rep['requests']} requests "
              f"({long_rep['batches']} microbatches) in "
              f"{long_rep['wall_s']:.4f} s: "
              f"{long_rep['requests_per_s']:.1f} req/s, "
              f"{long_rep['samples_per_s']:.0f} samples/s on {card}")
    for name in ("qmlp_mlp_bank", "qmlp_svm_bank", "bespoke_mlp",
                 "bespoke_svm"):
        check(launches[name] > 0, f"{name} never launched on the serving "
                                  f"path")
    print("  design 0 of each front served alone (the D=1 entry) at its "
          "exported accuracy")
    return launches


def reset_all_launches():
    from repro_torch.kernels import adc_quantize as adcq
    from repro_torch.kernels import flash_attention, mc_eval, qmlp
    qmlp.reset_launches()
    adcq.reset_launches()
    mc_eval.reset_launches()
    flash_attention.reset_launches()


def all_launches():
    from repro_torch.kernels import adc_quantize as adcq
    from repro_torch.kernels import flash_attention, mc_eval, qmlp
    return {**qmlp.launches, **adcq.launches, **mc_eval.launches,
            **flash_attention.launches}


def phase_search(np, torch, dev, card, data):
    """The main path: the port searches, exports, checks, saves, loads and
    serves its own front, for the MLP and the SVM."""
    from repro_torch.core import deploy, search
    from repro_torch.data import tabular
    from repro_torch.launch.serve_classifier import (make_request_stream,
                                                     serve)
    spec = tabular.SPECS[DATASET]
    sizes = (spec.features, spec.hidden, spec.classes)
    requests = make_request_stream(data["x_test"], 256, 8)
    evals = 2 * (SEARCH["generations"] + 1) + 2 + 2
    print(f"phase search: the main path (run_search -> export_front -> "
          f"verify_front_parity -> save_front -> load_front -> serve) on "
          f"cuda, cardio sizes={sizes}, {SEARCH}")
    out, fronts = {}, {}
    for kind in ("mlp", "svm"):
        cfg = search.SearchConfig(model=kind, **SEARCH)
        marks = [time.perf_counter()]

        def log(g, pop, fit):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            dt = marks[-1] - marks[-2]
            print(f"  {kind} gen {g}: {dt:.3f} s/gen, "
                  f"{cfg.pop_size / dt:.1f} individuals/s, best-acc "
                  f"{1 - fit[:, 0].min():.4f}, min-area "
                  f"{fit[:, 1].min():.4f}", flush=True)

        reset_all_launches()
        t0 = time.perf_counter()
        pg, pf, _, trained = search.run_search(
            data, sizes, cfg, log=log, return_trained=True, device=dev)
        designs = deploy.export_front(pg, data, sizes, cfg, trained=trained,
                                      device=dev)
        parity = deploy.verify_front_parity(designs, pg, data, sizes, cfg,
                                            device=dev)
        with tempfile.TemporaryDirectory() as tmp:
            deploy.save_front(tmp, designs, extra_meta={
                "dataset": DATASET, "sizes": list(sizes)})
            loaded = deploy.load_front(tmp)
        rep = serve(loaded, requests, 1024, device=dev)
        served = deploy.served_accuracies(loaded, data["x_test"],
                                          data["y_test"], device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = all_launches()
        exported = np.array([d.accuracy for d in designs])
        gen_s = [b - a for a, b in zip(marks[1:-1], marks[2:])]
        for i, d in enumerate(designs):
            print(f"  {kind} design {i}: area={d.area_tc}T dp={int(d.dp)} "
                  f"exported={d.accuracy!r} served={float(served[i])!r}")
        print(f"  {kind}: {len(designs)} designs; verify_front_parity="
              f"{parity}; launch counters {launches}; main path "
              f"{wall:.2f} s on {card}")
        if gen_s:
            print(f"  {kind}: steady generation {np.mean(gen_s):.3f} s "
                  f"({cfg.pop_size / np.mean(gen_s):.1f} individuals/s) "
                  f"over generations 1..{len(gen_s)} on {card}")
        check(parity, f"{kind}: verify_front_parity is False")
        # the front's re-train (train_pareto_front) reproduces the fitness
        # each genome got in whichever generation evaluated it
        refit = (1.0 - trained[0].astype(np.float32)).astype(np.float64)
        check(np.array_equal(refit, pf[:, 0]),
              f"{kind}: re-trained accuracies {trained[0]} do not give the "
              f"search fitness {1 - pf[:, 0]}")
        check(np.array_equal(served, exported),
              f"{kind}: served accuracies {served} != exported {exported}")
        check(launches["adc_quantize_population"] == evals,
              f"{kind}: adc_quantize_population launched "
              f"{launches['adc_quantize_population']} times, expected "
              f"{evals} (2 per population evaluation)")
        name = f"qmlp_{kind}_bank"
        check(launches[name] == rep["batches"] + 2,
              f"{name}: {launches[name]} launches for {rep['batches']} "
              f"microbatches + warm-up + accuracy pass")
        out[kind] = {"launches": launches, "designs": len(designs),
                     "generation_s": gen_s, "wall_s": wall}
        fronts[kind] = (pg, cfg)

    # lane purity: the front re-trained as exactly its K lanes, without
    # padding to the fixed lane count, against the padded result
    dd = search.device_data(data, dev)
    for kind, (pg, cfg) in fronts.items():
        padded = search._fixed_lanes(pg, dd, sizes, cfg)["acc"]
        k = len(pg)
        free = search._train_and_score(
            pg, search._stacked_init(k, sizes, cfg, dev), dd, sizes,
            cfg)["acc"].cpu().numpy()
        same = bool(np.array_equal(free, padded))
        out[kind]["lane_count_free_equals_padded"] = same
        print(f"  lane-purity probe {kind}: K={k} lanes unpadded vs padded "
              f"to {cfg.pop_size}: {'equal' if same else 'DIFFERENT'} "
              f"(max |diff| {float(np.abs(free - padded).max()):.3e})")
    return out


MC_SPECS = {"ideal": (0.0, 0.0, 0.0), "offset": (0.5, 0.0, 0.0),
            "drift": (0.0, 0.01, 0.0), "faults": (0.0, 0.0, 0.05),
            "all faulty": (0.0, 0.0, 1.0), "all three": (0.5, 0.01, 0.02)}


def mc_operands_on(np, torch, dev, spec, ni, masks, s, cal, seed=0):
    """The Monte-Carlo operands of (P, C, 2^N) masks (or one (C, 2^N)
    mask), compiled on ``dev``: the nominal ones, or, with ``cal``, the
    calibrated-table ones under random TMR and calibrate genes."""
    from repro_torch.core import nonideal
    from repro_torch.faulttol import calibrate, redundancy
    c = masks.shape[-2]
    if not cal:
        return nonideal.mc_operands(spec, ni, masks, samples=s, device=dev)
    rng = np.random.default_rng(seed)
    lead = masks.shape[:-2]
    tmr = (rng.random(lead + (c,)) < 0.5).astype(np.int32)
    genes = (rng.random(lead) < 0.5).astype(np.int32)
    rd = redundancy.draw_redundant(spec.bits, c, s, ni, dev)
    return calibrate.mc_operands_ft(spec, ni, masks, tmr, genes, rd, dev)


def on_bound_inputs(np, x, lb, lo, scale):
    """Rows 0-2 of x become NaN, +inf and -inf; row 3 puts every channel
    exactly on a finite lower bound of instance 0 of design 0 (x nudged
    until (x - lo) * scale lands on it in float32)."""
    x = np.array(x, np.float32)
    x[0], x[1], x[2] = np.nan, np.inf, -np.inf
    lb0 = lb.reshape((-1,) + lb.shape[-3:])[0, 0]          # (C, 2^N)
    lo0, sc0 = lo[0], scale[0]
    for ch in range(x.shape[1]):
        ks = np.nonzero(np.isfinite(lb0[ch]) & (lb0[ch] > 0))[0]
        if not len(ks):
            continue
        t = lb0[ch, ks[0]]
        xv = np.float32(lo0[ch] + t / sc0[ch])
        for _ in range(16):
            u = np.float32(np.float32(xv - lo0[ch]) * sc0[ch])
            if u == t:
                break
            xv = np.nextafter(xv, np.float32(np.inf if u < t else -np.inf))
        x[3, ch] = xv
    return x


def overlapping_operands(np, rng, lead, s, c, n, cal):
    """Monte-Carlo operands (lb, ub, values, lo, scale) whose intervals
    are no partition, as numpy arrays: lb/ub (*lead, S, C, 2^N) of random
    position and width (0 to 3 codes wide, a sixth empty or reversed, a
    few NaN), so that none, one or several leaves are live at a code
    position; values of mixed signs with some -0.0, (C, 2^N) or, with
    ``cal``, (*lead, S, C, 2^N); lo/scale (S, C) spreading x in [0, 1]
    over the 2^N codes."""
    shape = lead + (s, c, n)
    lb = rng.uniform(-1.0, n + 1.0, size=shape).astype(np.float32)
    ub = (lb + rng.uniform(-0.6, 3.0, size=shape)).astype(np.float32)
    lb[rng.random(shape) < 0.02] = np.nan
    ub[rng.random(shape) < 0.02] = np.nan
    lb[..., 0], ub[..., -1] = -np.inf, np.inf
    values = rng.uniform(-2.0, 2.0, size=shape if cal else (c, n)).astype(
        np.float32)
    values[rng.random(values.shape) < 0.1] = -0.0
    lo = rng.uniform(-0.1, 0.1, size=(s, c)).astype(np.float32)
    scale = (n * rng.uniform(0.9, 1.1, size=(s, c))).astype(np.float32)
    return lb, ub, values, lo, scale


def live_leaves(torch, x, lb, ub, values, lo, scale):
    """How many leaves are live at each output: (..., S, M, C)."""
    u = ((x[None] - lo[:, None]) * scale[:, None])[..., None]
    return ((u >= lb.unsqueeze(-3)) & (u < ub.unsqueeze(-3))).sum(-1)


def phase_mc_kernels(np, torch, dev, data):
    """The four Monte-Carlo entries against their plain versions on the
    card, bitwise, then timed beside their bounds."""
    from repro_torch.core import nonideal
    from repro_torch.core.spec import AdcSpec
    from repro_torch.kernels import envelope, mc_eval, ref
    rng = np.random.default_rng(2026)
    x_tr, x_te = data["x_train"], data["x_test"]
    c = x_tr.shape[1]
    all3 = nonideal.NonIdealSpec(*MC_SPECS["all three"], seed=1)
    cases = []      # (label, spec, nonideal, x, masks, S, special, compare)
    for sname, knobs in MC_SPECS.items():
        ni = nonideal.NonIdealSpec(*knobs, seed=2)
        cases.append((f"search test split P=16 S=32 M=636, {sname}",
                      AdcSpec(bits=4), ni, x_te,
                      random_masks(np, torch, rng, 16, c, 4), 32, False))
    cases.append(("search train split P=16 S=32 M=1488", AdcSpec(bits=4),
                  all3, x_tr, random_masks(np, torch, rng, 16, c, 4), 32,
                  False))
    cases.append(("P=1 (single-design entry) S=32 M=636", AdcSpec(bits=4),
                  all3, x_te, random_masks(np, torch, rng, 1, c, 4)[0], 32,
                  False))
    cases.append(("S=1 P=16 M=636", AdcSpec(bits=4), all3, x_te,
                  random_masks(np, torch, rng, 16, c, 4), 1, False))
    cases.append(("P=1 S=1 M=636", AdcSpec(bits=4), all3, x_te,
                  random_masks(np, torch, rng, 1, c, 4)[0], 1, False))
    for m in (257, 1000):
        x = rng.uniform(-0.1, 1.1, size=(m, c)).astype(np.float32)
        cases.append((f"ragged M={m} P=5 S=7", AdcSpec(bits=4), all3, x,
                      random_masks(np, torch, rng, 5, c, 4), 7, False))
    for bits in (1, 4, 6):
        x = rng.uniform(-0.1, 1.1, size=(999, c)).astype(np.float32)
        cases.append((f"bits={bits} P=3 S=8 M=999", AdcSpec(bits=bits),
                      all3, x, random_masks(np, torch, rng, 3, c, bits), 8,
                      False))
    lo = rng.uniform(-1.0, 0.5, size=c)
    spec_pc = AdcSpec(bits=4, vmin=tuple(lo),
                      vmax=tuple(lo + rng.uniform(0.5, 2.0, size=c)))
    x = rng.uniform(lo - 0.2, lo + 2.2, size=(777, c)).astype(np.float32)
    cases.append(("per-channel ranges P=6 S=8 M=777", spec_pc, all3, x,
                  random_masks(np, torch, rng, 6, c, 4), 8, False))
    cases.append(("NaN, +-inf and on-bound inputs P=4 S=8 M=636",
                  AdcSpec(bits=4), all3, x_te,
                  random_masks(np, torch, rng, 4, c, 4), 8, True))
    x = rng.uniform(-0.1, 1.1, size=(300, 200)).astype(np.float32)
    cases.append(("C=200 bits=6 (150 KB shared memory) P=2 S=3", AdcSpec(
        bits=6), all3, x, random_masks(np, torch, rng, 2, 200, 6), 3, False))
    x = rng.uniform(-0.1, 1.1, size=(16, 3)).astype(np.float32)
    cases.append(("P*S = 2100*32 > 65535 (grid loop) C=3 M=16",
                  AdcSpec(bits=4),
                  all3, x, random_masks(np, torch, rng, 2100, 3, 4), 32,
                  False))
    rng7 = np.random.default_rng(2027)      # leaves the cases above as they were
    x = rng7.uniform(-0.1, 1.1, size=(999, 8)).astype(np.float32)
    cases.append(("bits=7 C=8 (2^N=128, shared memory) P=3 S=8 M=999",
                  AdcSpec(bits=7), all3, x,
                  random_masks(np, torch, rng7, 3, 8, 7), 8, False))

    plain = {"mc_adc_eval": ref.mc_adc_eval_ref,
             "mc_adc_eval_population": ref.mc_adc_eval_ref_population,
             "mc_adc_eval_cal": ref.mc_adc_eval_cal_ref,
             "mc_adc_eval_cal_population":
                 ref.mc_adc_eval_cal_ref_population}
    max_err = {k: 0.0 for k in plain}
    print("phase kernels: mc_adc_eval{,_cal}{,_population} vs plain "
          "version on the card (bitwise); operands and draws compiled on "
          "the card vs on the CPU (bitwise)")
    d_cpu = nonideal.draw(4, c, 32, all3)
    d_gpu = nonideal.draw(4, c, 32, all3, device=dev)
    check(all(torch.equal(a, b.cpu()) for a, b in zip(d_cpu, d_gpu)),
          "the draws differ between the CPU and the card")
    def held(entry, label, xd, operands, note):
        got = getattr(mc_eval, entry)(xd, *operands)
        want = plain[entry](xd, *operands)
        torch.cuda.synchronize()
        check(got.shape == want.shape,
              f"{entry} {label}: shape {tuple(got.shape)} != "
              f"{tuple(want.shape)}")
        lb = operands[0]
        p, s = (1, lb.shape[0]) if lb.ndim == 3 else tuple(lb.shape[:2])
        (m, c), n = xd.shape, lb.shape[-1]
        mirror = tuple(envelope.mc_geometry(p, s, m, c, n))
        built = mc_eval.geometry(p, s, m, c, n)
        check(built == mirror, f"{entry} {label}: the built kernel's launch "
                               f"geometry {built} != envelope's {mirror}")
        err = float((got - want).abs().max())
        max_err[entry] = max(max_err[entry], err)
        ok = torch.equal(got, want)
        print(f"  {entry:27s} {label:45s} shape={tuple(got.shape)} "
              f"max_abs_err={err:.3e} [bitwise{note}, geometry ==] "
              f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"{entry} disagrees with its plain version on {label} "
                  f"(max_abs_err {err:.3e}, bitwise)")

    for label, spec, ni, x, masks, s, special in cases:
        for cal in (False, True):
            single = masks.ndim == 2
            entry = ("mc_adc_eval" + ("_cal" if cal else "")
                     + ("" if single else "_population"))
            operands = mc_operands_on(np, torch, dev, spec, ni,
                                      masks.to(dev), s, cal)
            host = mc_operands_on(np, torch, "cpu", spec, ni, masks, s, cal)
            same = all(torch.equal(a.cpu(), b)
                       for a, b in zip(operands, host))
            check(same, f"{entry} operands on the card differ from the CPU's "
                        f"on {label}")
            xs = (on_bound_inputs(np, x, host[0].numpy(), host[3].numpy(),
                                  host[4].numpy()) if special else x)
            xd = torch.as_tensor(xs).to(dev).contiguous()
            held(entry, label, xd, operands, ", operands ==")

    # no channels, and no leaves: an empty output, and zeros
    for c_e, n_e in ((0, 16), (21, 0)):
        ops_e = tuple(torch.zeros(shape, device=dev) for shape in (
            (3, 4, c_e, n_e), (3, 4, c_e, n_e), (c_e, n_e), (4, c_e),
            (4, c_e)))
        xe = torch.zeros((50, c_e), device=dev)
        before = dict(mc_eval.launches)
        got = mc_eval.mc_adc_eval_population(xe, *ops_e)
        torch.cuda.synchronize()
        launched = mc_eval.launches != before
        ok = (got.shape == (3, 4, 50, c_e) and not bool(got.any())
              and launched == (c_e > 0))
        print(f"  {'mc_adc_eval_population':27s} "
              f"{f'C={c_e} 2^N={n_e} P=3 S=4 M=50':45s} shape="
              f"{tuple(got.shape)} launched={launched} "
              f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"C={c_e}, 2^N={n_e}: shape {tuple(got.shape)}, "
                  f"launched {launched}")

    # interval tables that are no partition: overlapping, empty and NaN
    # intervals, mixed-sign values; the sum must add every live leaf in k
    # order, as the plain version does
    for c_o, bits_o, m_o in ((21, 4, 1000), (8, 7, 333), (300, 2, 257)):
        n_o = 2 ** bits_o
        x = rng7.uniform(-0.1, 1.1, size=(m_o, c_o)).astype(np.float32)
        x[0], x[1] = np.nan, np.inf
        xd = torch.as_tensor(x).to(dev)
        for entry in plain:
            lead = () if entry in ("mc_adc_eval", "mc_adc_eval_cal") else (5,)
            operands = tuple(torch.as_tensor(a).to(dev) for a in
                             overlapping_operands(np, rng7, lead, 8, c_o, n_o,
                                                  "_cal" in entry))
            live = live_leaves(torch, xd, *operands)
            share = float((live >= 2).float().mean())
            check(share > 0.1 and int(live.max()) >= 3,
                  f"the overlapping case at C={c_o} has too few outputs "
                  f"with two live leaves ({share:.3f})")
            held(entry, f"overlapping C={c_o} 2^N={n_o} S=8 M={m_o}", xd,
                 operands, f", {100 * share:.0f} % with >= 2 live leaves")

    # a wide call: P=64, S=32, M=8192, C=21 writes 1.41 GB
    wp, ws, wm = MC_WIDE["P"], MC_WIDE["S"], MC_WIDE["M"]
    wide_x = x_te[rng.integers(0, len(x_te), size=wm)]
    wide_masks = random_masks(np, torch, rng, wp, c, 4).to(dev)
    xd = torch.as_tensor(wide_x).to(dev).contiguous()
    for cal in (False, True):
        entry = "mc_adc_eval_cal_population" if cal else \
            "mc_adc_eval_population"
        operands = mc_operands_on(np, torch, dev, AdcSpec(bits=4), all3,
                                  wide_masks, ws, cal)
        got = getattr(mc_eval, entry)(xd, *operands)
        want = plain[entry](xd, *operands)
        torch.cuda.synchronize()
        gb = got.numel() * 4 / 1e9
        err = float((got - want).abs().max())
        max_err[entry] = max(max_err[entry], err)
        ok = torch.equal(got, want)
        label = f"wide P={wp} S={ws} M={wm} ({gb:.2f} GB out)"
        print(f"  {entry:27s} {label:45s} max_abs_err={err:.3e} [bitwise] "
              f"{'ok' if ok else 'MISMATCH'}")
        check(ok and gb >= 1.0,
              f"{entry} wide call: bitwise {ok}, {gb:.2f} GB written")
        del got, want, operands
    torch.cuda.empty_cache()

    timings = {}
    shapes = {   # label: (entry, P, S, x, masks)
        "search P=16 S=32 M=636": ("mc_adc_eval_population", 16, 32, x_te),
        "evaluate_robustness D=6 S=32 M=636": ("mc_adc_eval_population", 6,
                                               32, x_te),
        f"wide P={wp} S={ws} M={wm}": ("mc_adc_eval_population", wp, ws,
                                       wide_x),
        "single S=32 M=636": ("mc_adc_eval", 1, 32, x_te),
        "cal search P=16 S=32 M=636": ("mc_adc_eval_cal_population", 16, 32,
                                       x_te),
        f"cal wide P={wp} S={ws} M={wm}": ("mc_adc_eval_cal_population", wp,
                                           ws, wide_x),
        "cal single S=32 M=636": ("mc_adc_eval_cal", 1, 32, x_te)}
    spec = AdcSpec(bits=4)
    for label, (entry, p, s, x) in shapes.items():
        cal = "_cal" in entry
        single = not entry.endswith("_population")
        masks = random_masks(np, torch, rng, p, c, 4).to(dev)
        if single:
            masks = masks[0]
        operands = mc_operands_on(np, torch, dev, spec, all3, masks, s, cal)
        xd = torch.as_tensor(x).to(dev).contiguous()
        k_fn = lambda: getattr(mc_eval, entry)(xd, *operands)  # noqa: E731
        p_fn = lambda: plain[entry](xd, *operands)  # noqa: E731
        reps = 20 if "wide" in label else REPS
        p1 = cuda_ms(torch, p_fn, reps)
        k1 = cuda_ms(torch, k_fn, reps)
        k2 = cuda_ms(torch, k_fn, reps)
        p2 = cuda_ms(torch, p_fn, reps)
        dev_ms = device_kernel_ms(torch, k_fn, "mc_eval_kernel", reps)
        m = len(x)
        b_ms, b_by, nbytes, nops = kernel_bound(
            "mc_eval_cal_population" if cal else "mc_eval_population", m,
            c, 16, p=p, s=s)
        timings.setdefault(entry, {})[label] = {
            "shape": {"P": p, "S": s, "M": m, "C": c, "levels": 16},
            "ms": min(k1, k2), "plain_ms": min(p1, p2), "device_ms": dev_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": nops}
        dev_txt = ("not measured" if dev_ms is None
                   else f"{dev_ms * 1e3:.2f} us")
        print(f"  time {entry:27s} {label:36s}: kernel {k1 * 1e3:.2f}/"
              f"{k2 * 1e3:.2f} us per call (profiler device time "
              f"{dev_txt}), plain {p1 * 1e3:.2f}/{p2 * 1e3:.2f} us, bound "
              f"{b_ms * 1e3:.3f} us ({b_by}, {nbytes} bytes)")
        del operands
        torch.cuda.empty_cache()
    return max_err, timings


def built_geometry(w, block_m):
    """The built kernel's launch geometry for workload ``w`` at tile
    ``block_m`` (None: the heuristic), from its C export; a tile the
    kernel refuses raises ValueError."""
    from repro_torch.kernels import adc_quantize as adcq
    from repro_torch.kernels import mc_eval, qmlp
    from repro_torch.perf import cost_model
    fam, n = cost_model.family(w.entry), w.levels
    if fam == "quantize":
        return adcq.geometry(w.p, w.m, w.c, n, block_m)
    if fam == "mc":
        return mc_eval.geometry(w.p, w.s, w.m, w.c, n, block_m)
    kind = "mlp" if w.entry.endswith("mlp") else "svm"
    return qmlp.geometry(kind, w.d, w.m, w.c, n, w.h, w.o, block_m)


def refused_tile(w):
    """One tile the kernel of ``w`` cannot take: the padded bank's rows
    not a multiple of 4, a Monte-Carlo chunk one row past whole batches,
    a quantizer span one row past Q_SPAN_MAX."""
    from repro_torch.kernels import envelope
    from repro_torch.perf import cost_model
    fam = cost_model.family(w.entry)
    if fam == "quantize":
        return envelope.Q_SPAN_MAX // w.c + 1
    if fam == "mc":
        return envelope.mc_row_lanes(w.c) * envelope.MC_BATCH + 1
    return 6


def autotune_cases(np, rng, w, dev):
    """[(label, operands, spec, bitwise against the plain version)] for
    one workload: random floats (autotune.tuning_operands), and for the
    bank entries also dyadic operands, where every partial sum is exact
    and the plain version's matmul order gives the same bits."""
    import torch
    from repro_torch.perf import autotune, cost_model
    ops, spec = autotune.tuning_operands(w, seed=0, device=dev)
    bank = cost_model.family(w.entry) == "bank"
    cases = [("random floats", ops, spec, not bank)]
    if bank:
        kind = "mlp" if w.entry.endswith("mlp") else "svm"
        spec_d, x, t, ws = dyadic_case(np, rng, kind, w.d, w.m, w.c,
                                       max(w.h, 1), w.o, w.bits)
        if w.entry.startswith("bespoke"):       # the D=1 entry's shapes
            t, ws = t[0], tuple(a[0] for a in ws)
        ops_d = tuple(torch.as_tensor(a).to(dev).contiguous()
                      for a in (x, t, *ws))
        cases.append(("dyadic", ops_d, spec_d, True))
    return cases


def phase_autotune(np, torch, dev, card):
    """The perf layer on the card: at perf/autotune.default_workloads()'
    shapes, for each of the ten entries, every candidate tile's built
    geometry == envelope's (and a tile the kernel cannot take refused by
    the build too), every candidate's output bitwise == the heuristic
    tile's and == the plain version's (the banks: bitwise on dyadic
    operands, rtol 1e-5 / atol 1e-6 on random floats, as phase kernels),
    then autotune.tune times every candidate on the card; the table goes
    to a temporary path, loads back, and the committed table
    (kernels/tuned_tables.json) must load on this card, not stale, with
    every default workload's shape class."""
    from repro_torch.kernels import dispatch
    from repro_torch.perf import autotune, cost_model, shape_class
    t0 = time.perf_counter()
    workloads = autotune.default_workloads()
    check({w.entry for w in workloads} == set(dispatch.entries()),
          "autotune: default_workloads() does not cover every entry")
    rng = np.random.default_rng(2028)
    print("phase autotune: every candidate tile of the ten entries at "
          "autotune.default_workloads(): built geometry == envelope's, "
          "output bitwise == the heuristic tile's and the plain version's, "
          "timed on the card")
    out = {"workloads": {}}
    heuristic_us = {}
    dispatch.set_tuned_policy(None)      # block_m=None: the kernels' own
    try:
        for w in workloads:
            entry = dispatch.get(w.entry)
            key = f"{w.entry}[{shape_class(w)}]"
            cands = autotune.candidate_block_ms(w)
            heur = cost_model.heuristic_block_m(w)
            check(heur in cands, f"autotune {key}: the heuristic tile {heur} "
                                 f"is not among the candidates {cands}")
            for bm in (None,) + cands:
                built = built_geometry(w, bm)
                mirror = tuple(cost_model.geometry(w, bm))
                check(built == mirror, f"autotune {key} block_m={bm}: the "
                                       f"built geometry {built} != "
                                       f"envelope's {mirror}")
            bad = refused_tile(w)
            try:
                built_geometry(w, bad)
                refused = False
            except ValueError:
                refused = True
            check(refused, f"autotune {key}: the built kernel took the "
                           f"invalid tile {bad}")
            rules = []
            for label, (x, t, *ws), spec, exact in autotune_cases(
                    np, rng, w, dev):
                base = entry.kernel(x, t, *ws, spec=spec)
                plain = entry.plain(x, t, *ws, spec=spec)
                for bm in cands:
                    got = entry.kernel(x, t, *ws, spec=spec, block_m=bm)
                    torch.cuda.synchronize()
                    same = torch.equal(got, base)
                    near = (torch.equal(got, plain) if exact else
                            torch.allclose(got, plain, rtol=1e-5, atol=1e-6))
                    check(same and near,
                          f"autotune {key} {label} block_m={bm}: == heuristic "
                          f"tile {same}, == plain version {near} (max_abs_err "
                          f"{float((got - plain).abs().max()):.3e})")
                rules.append(f"{label} {'bitwise' if exact else 'rtol=1e-5'}")
                if label == "random floats":
                    heuristic_us[key] = autotune.device_us(
                        lambda: entry.kernel(x, t, *ws, spec=spec),
                        AUTOTUNE_REPS)
            print(f"  {key}: {len(cands)} tiles {list(cands)} (heuristic "
                  f"{heur}), refused {bad}; every tile == the heuristic "
                  f"tile bitwise and == plain ({', '.join(rules)}); geometry "
                  f"== envelope's")
        t1 = time.perf_counter()
        table = autotune.tune(workloads, reps=AUTOTUNE_REPS)
        t2 = time.perf_counter()
    finally:
        dispatch.reset_tuned_policy()    # later phases: the committed table
    for w in workloads:
        key = f"{w.entry}[{shape_class(w)}]"
        rec = table["entries"][w.entry][shape_class(w)]
        b_ms = cost_model.bound(w)["bound_s"] * 1e3
        waves = {bm: cost_model.roofline_estimate(w, int(bm))["waves"]
                 for bm in rec["candidates_us"]}
        xs = np.array([waves[bm] for bm in rec["candidates_us"]], float)
        ys = np.array(list(rec["candidates_us"].values()))
        slope = (float(np.polyfit(xs, ys, 1)[0]) if len(set(xs)) > 1
                 else None)
        out["workloads"][key] = {
            "heuristic_block_m": rec["heuristic_block_m"],
            "heuristic_us": rec["heuristic_us"],
            "heuristic_geometry_us": heuristic_us[key],
            "block_m": rec["block_m"], "us": rec["us"],
            "candidates_us": rec["candidates_us"], "waves": waves,
            "us_per_wave": slope, "bound_us": b_ms * 1e3}
        by_tile = ", ".join(f"{k}: {v:.2f}"
                            for k, v in rec["candidates_us"].items())
        print(f"  {key}: tuned block_m={rec['block_m']} {rec['us']:.2f} us, "
              f"heuristic {rec['heuristic_block_m']} "
              f"{rec['heuristic_us']:.2f} us (its own geometry "
              f"{heuristic_us[key]:.2f} us), bound {b_ms * 1e3:.3f} us; "
              f"us by tile {{{by_tile}}}; "
              f"waves {waves}, slope "
              f"{'n/a' if slope is None else f'{slope:.3f}'} us/wave "
              f"on {card}")
    with tempfile.TemporaryDirectory() as tmp:
        path = autotune.save_table(table, Path(tmp) / "tuned_tables.json")
        loaded = autotune.load_table(path)
        check(loaded == json.loads(json.dumps(table)),
              "autotune: the table written to a temporary path does not "
              "load back")
    committed = autotune.load_table(autotune.DEFAULT_TABLE_PATH)
    check(committed is not None, f"autotune: the committed table "
                                 f"{autotune.DEFAULT_TABLE_PATH} is missing "
                                 f"or stale on this card")
    missing = [f"{w.entry}[{shape_class(w)}]" for w in workloads
               if shape_class(w) not in committed["entries"].get(w.entry, {})]
    check(not missing, f"autotune: the committed table lacks {missing}")
    out.update(phase_s=time.perf_counter() - t0, tune_s=t2 - t1,
               table_device=table["device"],
               committed_device=committed["device"],
               committed={f"{e}[{k}]": r["block_m"]
                          for e, per in committed["entries"].items()
                          for k, r in per.items()})
    print(f"  committed table ({committed['device']}) loads on this card, "
          f"not stale: {out['committed']}")
    print(f"phase autotune: {out['phase_s']:.2f} s (tune {out['tune_s']:.2f} "
          f"s) on {card}")
    return out


def phase_robust(np, torch, dev, card, data, search_out):
    """The robust path: with every launch counter at 0 per model, a
    3-objective search on cardio at full width, export, the deployed
    robustness report, save/load and serving through sampled (and, for
    the fault-tolerant SVM, calibrated) hardware instances; then the
    reference engine's single-design entries; then one robust generation
    traced with torch.profiler."""
    import dataclasses
    from repro_torch.core import deploy, nonideal, search
    from repro_torch.data import tabular
    from repro_torch.faulttol import FaultTolSpec
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_classifier import (make_request_stream,
                                                     serve)
    spec = tabular.SPECS[DATASET]
    sizes = (spec.features, spec.hidden, spec.classes)
    ni = nonideal.NonIdealSpec(**ROBUST_NI)
    x_te, y_te = data["x_test"], data["y_test"]
    y_dev = torch.as_tensor(y_te).to(dev)
    requests = make_request_stream(x_te, 256, 8)
    configs = {
        "mlp": search.SearchConfig(model="mlp", nonideal=ni,
                                   robust_objective="expected", **ROBUST),
        "svm": search.SearchConfig(model="svm", nonideal=ni,
                                   robust_objective="yield",
                                   faulttol=FaultTolSpec(), **ROBUST)}
    gens = ROBUST["generations"]
    print(f"phase robust: the robust path (run_search -> export_front -> "
          f"evaluate_robustness -> save_front -> load_front -> non-ideal / "
          f"calibrated serving) on cuda, cardio sizes={sizes}, {ROBUST}, "
          f"{ni.describe()}")
    out = {}
    for kind, cfg in configs.items():
        pop_entry = ("mc_adc_eval_cal_population" if cfg.faulttol
                     else "mc_adc_eval_population")
        single_entry = "mc_adc_eval_cal" if cfg.faulttol else "mc_adc_eval"
        marks = [time.perf_counter()]

        def log(g, pop, fit):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            dt = marks[-1] - marks[-2]
            print(f"  {kind} gen {g}: {dt:.3f} s/gen, best-acc "
                  f"{1 - fit[:, 0].min():.4f}, min-area "
                  f"{fit[:, 1].min():.4f}, best-robust "
                  f"{fit[:, 2].min():.4f}", flush=True)

        reset_all_launches()
        t0 = time.perf_counter()
        pg, pf, decode, trained = search.run_search(
            data, sizes, cfg, log=log, return_trained=True, device=dev)
        torch.cuda.synchronize()
        after_search = all_launches()
        designs = deploy.export_front(pg, data, sizes, cfg, trained=trained,
                                      device=dev)
        parity = deploy.verify_front_parity(designs, pg, data, sizes, cfg,
                                            device=dev)
        margins = (cfg.yield_margin, 0.05)
        torch.cuda.synchronize()
        t_rep = time.perf_counter()
        rep = deploy.evaluate_robustness(designs, ni, x_te, y_te,
                                         samples=cfg.mc_samples,
                                         yield_margins=margins, device=dev)
        t_rep = time.perf_counter() - t_rep
        print(f"  {kind}: evaluate_robustness of {len(designs)} designs x "
              f"{cfg.mc_samples} instances on the test split: {t_rep:.4f} s "
              f"on {card}")
        with tempfile.TemporaryDirectory() as tmp:
            deploy.save_front(tmp, designs, extra_meta={
                "dataset": DATASET, "sizes": list(sizes)})
            deploy.save_robustness(tmp, rep)
            loaded = deploy.load_front(tmp)
            rep_loaded = deploy.load_robustness(tmp)
        check(rep_loaded == json.loads(json.dumps(rep)),
              f"{kind}: robustness.json does not round-trip")
        served = {}
        if cfg.faulttol is None:
            for k in (0, cfg.mc_samples - 1):
                fn = deploy.make_nonideal_bank_fn(
                    loaded, ni, instance=k, samples=cfg.mc_samples,
                    device=dev)
                srep = serve(loaded, requests, 1024, device=dev, bank_fn=fn)
                logits = fn(x_te)
                served[k] = deploy._mean_acc(
                    torch.argmax(logits, -1) == y_dev[None]).cpu().numpy()
                print(f"  {kind}: served instance {k} of {cfg.mc_samples} "
                      f"through make_nonideal_bank_fn: {srep['requests']} "
                      f"requests in {srep['wall_s']:.4f} s, "
                      f"{srep['requests_per_s']:.1f} req/s on {card}")
            zero = deploy.evaluate_robustness(
                designs, nonideal.NonIdealSpec(seed=3), x_te, y_te,
                samples=cfg.mc_samples, device=dev)
            xd = torch.as_tensor(x_te).to(dev)
            mask = torch.from_numpy(designs[0].mask).to(dev)
            ideal_q = ops.adc_quantize(xd, mask, spec=cfg.adc_spec)
            mc_q = nonideal.mc_quantize(xd, mask, cfg.adc_spec,
                                        nonideal.NonIdealSpec(), samples=2)
            check(torch.equal(mc_q, ideal_q[None].expand_as(mc_q)),
                  f"{kind}: zero-sigma MC != the ideal quantizer")
        else:
            cal = deploy.calibrate_front(loaded, ni, instance=0,
                                         samples=cfg.mc_samples, device=dev)
            cal_acc = deploy.served_accuracies(cal, x_te, y_te, device=dev)
            cfn = deploy.make_calibrated_bank_fn(
                loaded, ni, instance=0, samples=cfg.mc_samples, device=dev)
            crep = serve(loaded, requests, 1024, device=dev, bank_fn=cfn)
            clog = cfn(x_te)
            check(bool(torch.isfinite(clog).all())
                  and tuple(clog.shape) == (len(loaded), len(x_te), 3),
                  f"{kind}: calibrated serving gave {tuple(clog.shape)} / "
                  f"non-finite logits")
            cal_served = deploy._mean_acc(
                torch.argmax(clog, -1) == y_dev[None]).cpu().numpy()
            print(f"  {kind}: calibrate_front(instance 0) served "
                  f"accuracies {[float(a) for a in cal_acc]}; "
                  f"make_calibrated_bank_fn {[float(a) for a in cal_served]};"
                  f" {crep['requests']} requests in {crep['wall_s']:.4f} s, "
                  f"{crep['requests_per_s']:.1f} req/s on {card}")
            for a, b in zip(loaded, designs):
                check(np.array_equal(a.tmr, b.tmr)
                      and a.calibrated == b.calibrated,
                      f"{kind}: tmr/calibrated leaves lost in save -> load")
        # the reference engine: a few genomes, one lane each, against the
        # batched engine at the same lane count (pop_size=1), so both QATs
        # run the same shapes and the single-design MC entry is held
        # against the population one
        one = dataclasses.replace(cfg, pop_size=1)
        g3 = pg[:3]
        dd = search.device_data(data, dev)
        before_ref = all_launches()[single_entry]
        ref_fit = search.evaluate_population_reference(
            g3, dd, sizes, dataclasses.replace(one, engine="reference"))
        bat_fit = search.evaluate_population(g3, dd, sizes, one)
        torch.cuda.synchronize()
        launches = all_launches()
        wall = time.perf_counter() - t0
        gen_s = [b - a for a, b in zip(marks[1:-1], marks[2:])]

        col = np.array([
            (1.0 - r["yield"][f"{cfg.yield_margin:g}"]) if cfg.faulttol
            else r["expected_drop"] for r in rep["designs"]])
        for i, d in enumerate(designs):
            r = rep["designs"][i]
            print(f"  {kind} design {i}: area={d.area_tc}T "
                  f"exported={d.accuracy!r} mean={r['mean_accuracy']!r} "
                  f"worst={r['worst_accuracy']!r} yield@0.01="
                  f"{r['yield']['0.01']!r} column={pf[i, 2]!r} "
                  f"report={col[i]!r}"
                  + (f" tmr={int(d.tmr.sum())}/{d.channels} "
                     f"calibrated={d.calibrated}" if d.tmr is not None
                     else ""))
        print(f"  {kind}: {len(designs)} designs; verify_front_parity="
              f"{parity}; launches after the search {after_search}; after "
              f"the whole path {launches}; path {wall:.2f} s on {card}")
        check(parity, f"{kind}: verify_front_parity is False")
        check(np.array_equal(col, pf[:, 2]),
              f"{kind}: evaluate_robustness {col} != the searched third "
              f"column {pf[:, 2]}")
        if cfg.faulttol is None:
            for k, acc in served.items():
                want = np.array([r["instance_accuracies"][k]
                                 for r in rep["designs"]], np.float32)
                check(np.array_equal(acc, want),
                      f"{kind}: serving instance {k} gave {acc}, the report "
                      f"lists {want}")
            for d, r in zip(designs, zero["designs"]):
                check(r["instance_accuracies"] == [d.accuracy] * cfg.mc_samples,
                      f"{kind}: zero-sigma instances {r['instance_accuracies']}"
                      f" != exported {d.accuracy}")
            print(f"  {kind}: report == searched column bitwise; instances 0 "
                  f"and {cfg.mc_samples - 1} served at their listed "
                  f"accuracies; zero sigma == exported for every instance")
        else:
            print(f"  {kind}: report (1 - yield@{cfg.yield_margin:g}) == "
                  f"searched column bitwise; tmr/calibrated survive "
                  f"save -> load")
        evals = gens + 1
        check(after_search[pop_entry] == evals,
              f"{pop_entry}: {after_search[pop_entry]} launches in the "
              f"search, expected {evals} (1 per population evaluation)")
        check(after_search["adc_quantize_population"] == 2 * evals + 2,
              f"adc_quantize_population: "
              f"{after_search['adc_quantize_population']} launches in the "
              f"search, expected {2 * evals + 2} (2 per evaluation, 2 for "
              f"train_pareto_front)")
        ref_launches = launches[single_entry] - before_ref
        check(ref_launches == len(g3),
              f"{single_entry}: {ref_launches} launches for {len(g3)} "
              f"reference-engine genomes")
        check(np.allclose(ref_fit, bat_fit, rtol=0, atol=1e-6)
              and np.array_equal(ref_fit[:, 2], bat_fit[:, 2]),
              f"{kind}: reference engine {ref_fit} vs batched {bat_fit}")
        print(f"  {kind}: reference engine (single-design entry) == batched "
              f"engine at one lane: max |diff| "
              f"{float(np.abs(ref_fit - bat_fit).max()):.3e} (robust column "
              f"bitwise)")
        two_obj = search_out[kind]["generation_s"]
        if gen_s and two_obj:
            ratio = float(np.mean(gen_s) / np.mean(two_obj))
            print(f"  {kind}: steady generation {np.mean(gen_s):.3f} s "
                  f"robust vs {np.mean(two_obj):.3f} s 2-objective "
                  f"(ratio {ratio:.3f}) on {card}; launches per evaluation: "
                  f"{pop_entry} {after_search[pop_entry] / evals:g}, "
                  f"adc_quantize_population "
                  f"{(after_search['adc_quantize_population'] - 2) / evals:g}")
        else:
            ratio = None
        out[kind] = {"launches": launches, "designs": len(designs),
                     "evaluate_robustness_s": t_rep,
                     "generation_s": gen_s, "two_objective_generation_s":
                     two_obj, "ratio_to_two_objective": ratio,
                     "wall_s": wall}

    # one robust evaluation against the 2-objective one of the same shape
    # on the same genomes, in turns (2-objective, robust, robust,
    # 2-objective); then one robust evaluation traced: device busy share
    # and MC device time
    from torch.profiler import ProfilerActivity, profile
    dd = search.device_data(data, dev)
    rng = np.random.default_rng(11)
    for kind, cfg in configs.items():
        g = (rng.random((cfg.pop_size, search.genome_len(
            sizes[0], cfg.bits, cfg.faulttol))) < 0.5).astype(np.uint8)
        draws = search.search_draws(cfg, sizes[0], dev)
        two = search.SearchConfig(model=kind, **SEARCH)
        g2 = g[:, :search.genome_len(sizes[0], two.bits)]
        turns = {"two": [], "robust": []}
        for which in ("two", "robust", "robust", "two"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if which == "two":
                search.evaluate_population(g2, dd, sizes, two)
            else:
                search.evaluate_population(g, dd, sizes, cfg, draws=draws)
            torch.cuda.synchronize()
            turns[which].append(time.perf_counter() - t0)
        paired = min(turns["robust"]) / min(turns["two"])
        out[kind].update({"paired_two_objective_s": turns["two"],
                          "paired_robust_s": turns["robust"],
                          "paired_ratio": paired})
        print(f"  {kind}: one evaluation of the same {cfg.pop_size} genomes,"
              f" in turns: 2-objective {turns['two'][0]:.3f}/"
              f"{turns['two'][1]:.3f} s, robust {turns['robust'][0]:.3f}/"
              f"{turns['robust'][1]:.3f} s (ratio of the faster "
              f"{paired:.3f}) on {card}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            search.evaluate_population(g, dd, sizes, cfg, draws=draws)
            torch.cuda.synchronize()
            traced_wall = time.perf_counter() - t0
        mc_us = other_us = 0.0
        for ev in prof.key_averages():
            if "DeviceType.CUDA" not in str(getattr(ev, "device_type", "")) \
                    or not ev.count:
                continue
            total = getattr(ev, "self_device_time_total",
                            getattr(ev, "self_cuda_time_total", 0.0))
            if "mc_eval_kernel" in ev.key:
                mc_us += total
            else:
                other_us += total
        busy = (mc_us + other_us) / 1e6 / traced_wall
        out[kind].update({"traced_wall_s": traced_wall,
                          "mc_device_ms": mc_us / 1e3,
                          "other_device_ms": other_us / 1e3,
                          "device_busy_share": busy})
        print(f"  {kind} robust generation traced: wall {traced_wall:.3f} s,"
              f" device time MC kernel {mc_us / 1e3:.3f} ms, everything "
              f"else {other_us / 1e3:.3f} ms, device busy "
              f"{busy * 100:.1f} % on {card}")
    return out


def phase_generation(np, torch, dev, card, data):
    """One generation at SearchConfig defaults (pop 32, 300 QAT steps) per
    model: host clock around a synchronised evaluate_population, then a
    torch.profiler trace of the same call."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import search
    from repro_torch.data import tabular
    spec = tabular.SPECS[DATASET]
    sizes = (spec.features, spec.hidden, spec.classes)
    dd = search.device_data(data, dev)
    rng = np.random.default_rng(7)
    print("phase generation: one generation at SearchConfig defaults")
    out = {}
    for kind in ("mlp", "svm"):
        cfg = search.SearchConfig(bits=4, model=kind)
        g = (rng.random((cfg.pop_size, search.genome_len(sizes[0], 4)))
             < 0.5).astype(np.uint8)
        search.evaluate_population(g[:2], dd, sizes, cfg)     # warm-up
        torch.cuda.synchronize()
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            search.evaluate_population(g, dd, sizes, cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            search.evaluate_population(g, dd, sizes, cfg)
            torch.cuda.synchronize()
            traced_wall = time.perf_counter() - t0
        quant_us = other_us = 0.0
        launches_traced = 0
        for ev in prof.key_averages():
            if getattr(ev, "device_type", None) is None or not ev.count:
                continue
            if "DeviceType.CUDA" not in str(ev.device_type):
                continue
            total = getattr(ev, "self_device_time_total",
                            getattr(ev, "self_cuda_time_total", 0.0))
            if "adc_quantize_population_kernel" in ev.key:
                quant_us += total
            else:
                other_us += total
                launches_traced += ev.count
        wall = min(walls)
        busy = (quant_us + other_us) / 1e6 / traced_wall
        out[kind] = {"generation_s": walls, "individuals_per_s":
                     cfg.pop_size / wall, "traced_wall_s": traced_wall,
                     "quantizer_device_ms": quant_us / 1e3,
                     "other_device_ms": other_us / 1e3,
                     "other_device_ops": launches_traced,
                     "device_busy_share": busy}
        print(f"  {kind} pop={cfg.pop_size} steps={cfg.train_steps}: "
              f"{walls[0]:.3f}/{walls[1]:.3f} s per generation "
              f"({cfg.pop_size / wall:.1f} individuals/s) on {card}; "
              f"traced: wall {traced_wall:.3f} s, device time quantizer "
              f"{quant_us / 1e3:.3f} ms, everything else "
              f"{other_us / 1e3:.3f} ms over {launches_traced} device "
              f"operations, device busy {busy * 100:.1f} %")
    return out



@contextlib.contextmanager
def qat_chunks(search):
    """Counts the fixed-lane QAT chunks (``search._train_and_score``
    calls, each one train and one test quantizer launch) run inside."""
    orig = search._train_and_score
    count = [0]

    def counted(*args, **kw):
        count[0] += 1
        return orig(*args, **kw)

    search._train_and_score = counted
    try:
        yield count
    finally:
        search._train_and_score = orig


@contextlib.contextmanager
def gradient_record(torch, search, grad_gates):
    """Records, inside, what the gradient engine ran, from its own
    returns: the gate train's ``diag`` and its end, and the genome count
    and end of every exact evaluation (``search.evaluate_population``:
    the pool's re-score first, then one call a polish round). Times are
    seconds from entry, the card synchronized."""
    rec = {"t0": time.perf_counter(), "diag": None, "gate_end": None,
           "evals": []}
    train, evaluate = (grad_gates.train_gate_family,
                       search.evaluate_population)

    def trained(*args, **kw):
        snaps, diag = train(*args, **kw)
        torch.cuda.synchronize()
        rec["diag"], rec["gate_end"] = diag, time.perf_counter() - rec["t0"]
        return snaps, diag

    def evaluated(genomes, *args, **kw):
        fit = evaluate(genomes, *args, **kw)
        torch.cuda.synchronize()
        rec["evals"].append((len(genomes), time.perf_counter() - rec["t0"]))
        return fit

    grad_gates.train_gate_family = trained
    search.evaluate_population = evaluated
    try:
        yield rec
    finally:
        grad_gates.train_gate_family = train
        search.evaluate_population = evaluate


class Killed(RuntimeError):
    pass


def killing_save(ckpt, after_step: int):
    """Make ``ckpt.save`` raise once it has saved ``after_step``: a run
    killed there, with its checkpoint on disk."""
    orig = ckpt.save

    def save(step, tree):
        orig(step, tree)
        if step == after_step:
            ckpt.save = orig
            raise Killed()

    ckpt.save = save


def phase_baseline(np, torch, dev, card, data):
    """The Table 5 baseline: the full ADC at dp = -3 with QAT, and the
    three full-design areas, for the MLP and the SVM."""
    from repro_torch.core import area, search
    from repro_torch.data import tabular
    spec = tabular.SPECS[DATASET]
    sizes = (spec.features, spec.hidden, spec.classes)
    c, bits = sizes[0], SEARCH["bits"]
    print(f"phase baseline: full_adc_baseline (the paper's Table 5 "
          f"'Baseline' column) on cuda, cardio sizes={sizes}, {SEARCH}")
    out = {}
    for kind in ("mlp", "svm"):
        cfg = search.SearchConfig(model=kind, **SEARCH)
        reset_all_launches()
        with qat_chunks(search) as chunks:
            t0 = time.perf_counter()
            row = search.full_adc_baseline(data, sizes, cfg, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = all_launches()
        print(f"  Table 5 baseline {kind}: accuracy {row['accuracy']!r}, "
              f"flash {row['area_flash_tc']} T, binary "
              f"{row['area_binary_baseline_tc']} T, ours "
              f"{row['area_binary_ours_tc']} T; {wall:.3f} s on {card}")
        want = {"area_flash_tc": c * area.flash_full_tc(bits),
                "area_binary_baseline_tc": c * area.baseline_binary_tc(bits),
                "area_binary_ours_tc": c * area.ours_full_tc(bits)}
        for key, value in want.items():
            check(row[key] == value, f"{kind}: baseline {key} {row[key]} != "
                                     f"{c} x its full-design area {value}")
        genome = np.ones((1, search.genome_len(c, bits)), np.uint8)
        genome[0, c * 2 ** bits:c * 2 ** bits + search.DP_BITS] = [1, 0, 1, 0]
        acc = search.evaluate_population_acc(genome, data, sizes, cfg,
                                             device=dev)
        check(row["accuracy"] == 1.0 - float(np.float32(1.0) - acc[0]),
              f"{kind}: baseline accuracy {row['accuracy']!r} is not "
              f"evaluate_population_acc's {acc[0]!r} of the same genome")
        check(launches["adc_quantize_population"] == 2 * chunks[0] == 2,
              f"{kind}: adc_quantize_population launched "
              f"{launches['adc_quantize_population']} times for "
              f"{chunks[0]} QAT chunk(s), expected 2")
        out[kind] = dict(row, wall_s=wall, launches=launches)
    return out


def phase_resume(np, torch, dev, card, data):
    """A search killed after generation 1 and resumed equals the
    uninterrupted one bitwise, plain and surrogate-screened."""
    import dataclasses
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import search
    from repro_torch.data import tabular
    spec = tabular.SPECS[DATASET]
    sizes = (spec.features, spec.hidden, spec.classes)
    print(f"phase resume: run_search(ckpt=...) killed after generation 1 "
          f"and resumed, against the uninterrupted run, on cuda, MLP, "
          f"{SEARCH}")
    out = {}
    reset_all_launches()
    with qat_chunks(search) as chunks, \
            tempfile.TemporaryDirectory() as tmp:
        for screen in (1, 2):
            cfg = dataclasses.replace(
                search.SearchConfig(model="mlp", **SEARCH),
                screen_factor=screen)
            name = "screened" if screen > 1 else "plain"
            whole = CheckpointManager(Path(tmp) / f"{name}_whole", keep=2)
            t0 = time.perf_counter()
            pg, pf, _ = search.run_search(data, sizes, cfg, ckpt=whole,
                                          device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            parted = CheckpointManager(Path(tmp) / f"{name}_parted", keep=2)
            killing_save(parted, 1)
            try:
                search.run_search(data, sizes, cfg, ckpt=parted, device=dev)
                check(False, f"{name}: the killed run was not killed")
            except Killed:
                pass
            check(parted.latest_step() == 1,
                  f"{name}: the killed run left step "
                  f"{parted.latest_step()}, expected 1")
            rg, rf, _ = search.run_search(data, sizes, cfg, ckpt=parted,
                                          resume=True, device=dev)
            last = SEARCH["generations"]
            a, b = whole.restore_flat(last), parted.restore_flat(last)
            check(sorted(a) == sorted(b) and all(
                np.array_equal(a[k], b[k]) for k in a),
                  f"{name}: the resumed run's final state (population, "
                  f"fitness, Generator, surrogate) differs from the "
                  f"uninterrupted run's")
            check(np.array_equal(rg, pg) and np.array_equal(rf, pf),
                  f"{name}: the resumed front differs from the "
                  f"uninterrupted one")
            row = {"wall_s": wall, "front": len(pf),
                   "state_leaves": len(a)}
            if screen > 1:
                accs = search.train_pareto_front(pg, data, sizes, cfg,
                                                 device=dev)[0]
                refit = (1.0 - accs.astype(np.float32)).astype(np.float64)
                check(np.array_equal(refit, pf[:, 0]),
                      f"screened: the front re-trains to {accs}, not its "
                      f"fitness {1 - pf[:, 0]}")
            print(f"  {name}: {len(pf)} front points; killed after "
                  f"generation 1, resumed to {last}: population, fitness, "
                  f"Generator and {len(a) - 4} surrogate leaves equal "
                  f"bitwise; uninterrupted run {wall:.2f} s on {card}")
            out[name] = row
        launches = all_launches()
    check(launches["adc_quantize_population"] == 2 * chunks[0],
          f"resume: adc_quantize_population launched "
          f"{launches['adc_quantize_population']} times for {chunks[0]} "
          f"QAT chunks")
    print(f"  resume: {chunks[0]} QAT chunks, launch counters {launches}")
    out["launches"] = launches
    out["qat_chunks"] = chunks[0]
    return out


def phase_gradient(np, torch, dev, card, data):
    """The gradient engine: gate train -> exact re-score -> polish ->
    front -> export -> verify -> save -> load -> serve, for the MLP and
    (cut) the SVM; the MLP's gate train killed after chunk 1 and resumed;
    one chunk traced."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import deploy, grad_gates, search
    from repro_torch.data import tabular
    from repro_torch.launch.serve_classifier import (make_request_stream,
                                                     serve)
    spec = tabular.SPECS[DATASET]
    sizes = (spec.features, spec.hidden, spec.classes)
    requests = make_request_stream(data["x_test"], 256, 8)
    print(f"phase gradient: run_gradient_search -> export_front -> "
          f"verify_front_parity -> save_front -> load_front -> serve on "
          f"cuda, cardio sizes={sizes}, {SEARCH}")
    for kind, cut in GRADIENT_CUTS.items():
        print(f"  cut: the {kind.upper()} runs with {cut} (the reference's "
              f"defaults: 64 lanes, 800 gate-train steps in 4 chunks, 2 "
              f"polish rounds of at most 192 exact evaluations)")
    out = {}
    reset_all_launches()
    with qat_chunks(search) as chunks, tempfile.TemporaryDirectory() as tmp:
        for kind in ("mlp", "svm"):
            cfg = search.SearchConfig(model=kind, engine="gradient",
                                      **SEARCH, **GRADIENT_CUTS[kind])
            ckpt = CheckpointManager(Path(tmp) / f"{kind}_gate", keep=2)
            first = chunks[0]
            with gradient_record(torch, search, grad_gates) as rec:
                pg, pf, _, trained = search.run_gradient_search(
                    data, sizes, cfg, ckpt=ckpt, return_trained=True,
                    progress=lambda msg: print(f"  {kind}: {msg}",
                                               flush=True), device=dev)
                torch.cuda.synchronize()
                total = time.perf_counter() - rec["t0"]
            designs = deploy.export_front(pg, data, sizes, cfg,
                                          trained=trained, device=dev)
            parity = deploy.verify_front_parity(designs, pg, data, sizes,
                                                cfg, device=dev)
            with tempfile.TemporaryDirectory() as fdir:
                deploy.save_front(fdir, designs, extra_meta={
                    "dataset": DATASET, "sizes": list(sizes)})
                loaded = deploy.load_front(fdir)
            rep = serve(loaded, requests, 1024, device=dev)
            served = deploy.served_accuracies(loaded, data["x_test"],
                                              data["y_test"], device=dev)
            exported = np.array([d.accuracy for d in designs])
            check(parity, f"gradient {kind}: verify_front_parity is False")
            refit = (1.0 - trained[0].astype(np.float32)).astype(np.float64)
            check(np.array_equal(refit, pf[:, 0]),
                  f"gradient {kind}: the front re-trains to {trained[0]}, "
                  f"not its fitness {1 - pf[:, 0]}")
            check(np.array_equal(served, exported),
                  f"gradient {kind}: served accuracies {served} != "
                  f"exported {exported}")
            diag, gate_s = rec["diag"], rec["gate_end"]
            (pool, t_rescore), polish_runs = rec["evals"][0], rec["evals"][1:]
            polish = [n for n, _ in polish_runs]
            row = {"lanes": diag["lanes"], "gate_steps": diag["steps"],
                   "gate_chunks": diag["chunks"],
                   "gate_train_s": gate_s,
                   "gate_s_per_step": gate_s / diag["steps"],
                   "pool": pool, "polish_evals": polish,
                   "exact_evals": pool + sum(polish),
                   "rescore_s": t_rescore - gate_s,
                   "polish_s": (polish_runs[-1][1] - t_rescore
                                if polish else 0.0),
                   "total_s": total, "front": len(pf),
                   "qat_chunks": chunks[0] - first,
                   "served": served.tolist()}
            for i, d in enumerate(designs):
                print(f"  gradient {kind} design {i}: area={d.area_tc}T "
                      f"dp={int(d.dp)} exported={d.accuracy!r} "
                      f"served={float(served[i])!r}")
            print(f"  gradient {kind}: {row['lanes']} lanes, "
                  f"{row['gate_steps']} gate-train steps "
                  f"{row['gate_s_per_step'] * 1e3:.2f} ms/step "
                  f"({row['gate_train_s']:.2f} s); pool {pool} genomes, "
                  f"{row['exact_evals']} exact evaluations in "
                  f"{row['qat_chunks']} QAT chunks; re-score "
                  f"{row['rescore_s']:.2f} s, polish {row['polish_s']:.2f} "
                  f"s, total {total:.2f} s; verify_front_parity={parity} "
                  f"on {card}")
            if kind == "mlp":
                row.update(gate_resume_traced(np, torch, card, data, sizes,
                                              cfg, diag, ckpt,
                                              Path(tmp) / "mlp_parted", dev))
                row["gate_backward_bitwise"] = gate_backward_repeats(
                    torch, dev, data, sizes, cfg, diag["lanes"])
            out[kind] = row
        launches = all_launches()
    check(launches["adc_quantize_population"] == 2 * chunks[0],
          f"gradient: adc_quantize_population launched "
          f"{launches['adc_quantize_population']} times for {chunks[0]} "
          f"QAT chunks (2 per chunk)")
    for kind in ("mlp", "svm"):
        check(launches[f"qmlp_{kind}_bank"] > 0,
              f"gradient: qmlp_{kind}_bank never launched")
    print(f"  gradient: {chunks[0]} QAT chunks; launches of row 2 "
          f"(adc_quantize_population) {launches['adc_quantize_population']}"
          f", of the banks {launches['qmlp_mlp_bank']} / "
          f"{launches['qmlp_svm_bank']} on {card}")
    out["launches"] = launches
    out["qat_chunks"] = chunks[0]
    return out


def gate_backward_repeats(torch, dev, data, sizes, cfg, lanes, runs=5):
    """The gate train's backward (``grad_gates.lane_losses``, its table
    lookup a one-hot product: tools/lookup_backward_ab.py holds it
    against a gather) taken ``runs`` times on the same inputs from the
    seeded start: the gradients must be bitwise the same every time, or
    a resumed gate train could not repeat the uninterrupted one."""
    from repro_torch.core import grad_gates
    state = grad_gates.init_lanes(sizes, cfg, lanes, dev)
    onehot, target, values = grad_gates.train_inputs(data, sizes, cfg, dev)
    lams = torch.from_numpy(grad_gates.lambda_sweep(cfg, lanes)).to(dev)
    tau = grad_gates.tau_schedule(cfg, 2)[0].to(dev)
    trained = state.leaves()[1:]                # dp gets no gradient
    for t in trained:
        t.requires_grad_(True)

    def grads():
        loss = grad_gates.lane_losses(state, lams, tau, onehot, target,
                                      values, cfg).sum()
        return torch.autograd.grad(loss, trained)

    first = grads()
    same = all(all(torch.equal(a, b) for a, b in zip(first, grads()))
               for _ in range(runs - 1))
    check(same, "the gate train's backward differs between runs on the "
                "same inputs")
    print(f"  gradient mlp: the gate train's backward, {runs} runs on the "
          f"same inputs: bitwise equal {same}")
    return same


def gate_resume_traced(np, torch, card, data, sizes, cfg, diag, whole,
                       directory, dev):
    """The gate train killed after chunk 1 (its first chunk traced with
    torch.profiler: device time and operations, the device's busy share
    of the chunk's wall time) and resumed: its snapshot genomes must be
    the uninterrupted run's (``whole``'s last step) bitwise."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import grad_gates
    snaps = whole.restore_flat(whole.latest_step())["snap_genomes"]
    parted = CheckpointManager(directory, keep=2)
    killing_save(parted, 1)
    lanes = diag["lanes"]
    steps = int(grad_gates._chunk_bounds(diag["steps"], diag["chunks"])[1])
    # device activity only: a host trace of the chunk's ~0.5 M operator
    # events costs more to record and to reduce than the chunk itself
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        try:
            grad_gates.train_gate_family(data, sizes, cfg, lanes=lanes,
                                         ckpt=parted, device=dev)
            check(False, "the killed gate train was not killed")
        except Killed:
            pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    again, _ = grad_gates.train_gate_family(data, sizes, cfg, lanes=lanes,
                                            ckpt=parted, resume=True,
                                            device=dev)
    check(np.array_equal(again, snaps),
          "the gate train resumed after chunk 1 gives other snapshot "
          "genomes than the uninterrupted one")
    print(f"  gradient mlp: gate train killed after chunk 1 and resumed: "
          f"{len(again)} snapshot genomes equal bitwise")
    dev_us, ops = 0.0, 0
    for ev in prof.events():
        if "DeviceType.CUDA" in str(getattr(ev, "device_type", "")):
            dev_us += ev.time_range.elapsed_us()
            ops += 1
    check(dev_us > 0, "torch.profiler recorded no device time for the "
                      "gate-train chunk")
    busy = dev_us / 1e6 / wall
    print(f"  gradient mlp: the killed run's one chunk of {steps} steps, "
          f"traced: wall {wall:.3f} s ({wall / steps * 1e3:.2f} ms/step, "
          f"with the operands' set-up and the save), device "
          f"{dev_us / 1e3:.2f} ms over {ops} device operations "
          f"({ops / steps:.0f} a step), device busy {busy * 100:.1f} % on "
          f"{card}")
    return {"traced_steps": steps, "traced_wall_s": wall,
            "traced_device_ms": dev_us / 1e3, "traced_device_ops": ops,
            "device_busy_share": busy}


def _log_marks(torch, marks):
    """An nsga2 ``log`` hook that records the time of each call (the
    initial evaluation, then one per generation), the card synchronized."""
    def log(g, pop, fit):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    return log


def _per_generation(np, marks) -> float:
    """Mean seconds between consecutive generations (after the initial
    evaluation)."""
    return float(np.mean(np.diff(marks))) if len(marks) > 1 else 0.0


def serve_windows(np, torch, dev, designs, x, batches):
    """Raw windows through the batch driver in microbatches of
    COSEARCH_SERVE['batch'] windows, and the same microbatches through
    the front's featurize callables alone: (driver report, featurize
    seconds)."""
    from repro_torch.core import deploy
    from repro_torch.launch.serve_classifier import (make_request_stream,
                                                     serve)
    from repro_torch.timeseries import feature as feature_lib
    batch, size = COSEARCH_SERVE["batch"], COSEARCH_SERVE["request_size"]
    requests = make_request_stream(x, batch * batches // size, size)
    rep = serve(designs, requests, batch, device=dev)
    feats = [feature_lib.featurize_fn(designs[idx[0]].feature)
             for idx in deploy._feature_groups(designs).values()]
    xbs = [torch.from_numpy(np.concatenate(
        [r for _, r in requests[i:i + batch // size]])).to(dev)
        for i in range(0, len(requests), batch // size)]
    for feat in feats:                                    # warm-up
        feat(xbs[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for xb in xbs:
        for feat in feats:
            feat(xb)
    torch.cuda.synchronize()
    return rep, time.perf_counter() - t0


def cosearch_stream(np, torch, dev, card, name, kind, fe, conf=None,
                    windows=None):
    """One stream at the reference benchmark's configuration (``conf``,
    default COSEARCH; ``windows`` cuts the splits to (train, test)
    windows): the ADC-only search on variant 0, its front embedded, the
    co-search seeded with it; the exact embedding and ε-dominance;
    export, verify, serve raw windows, save, load."""
    from repro_torch.core import deploy, nsga2, search
    from repro_torch.timeseries import cosearch
    from repro_torch.timeseries.feature import FeatureSpec
    from repro_torch.timeseries.stream import make_stream
    conf = COSEARCH if conf is None else conf
    data = make_stream(name)
    if windows is not None:
        n_tr, n_te = windows
        data = {"x_train": data["x_train"][:n_tr],
                "y_train": data["y_train"][:n_tr],
                "x_test": data["x_test"][:n_te],
                "y_test": data["y_test"][:n_te]}
    bits, hidden = conf["bits"], conf["hidden"]
    kw = {k: v for k, v in conf.items() if k not in ("bits", "hidden")}
    t0 = time.perf_counter()
    vdata, sizes, spec = cosearch.build_search_inputs(
        data, fe, bits=bits, hidden=hidden, device=dev)
    data0 = {"x_train": vdata["x_train"][0], "y_train": vdata["y_train"],
             "x_test": vdata["x_test"][0], "y_test": vdata["y_test"]}
    cfg_b = search.SearchConfig.for_spec(spec, model=kind, **kw)
    base_marks = [time.perf_counter()]
    bpg, bpf, _ = search.run_search(data0, sizes, cfg_b,
                                    log=_log_marks(torch, base_marks),
                                    device=dev)
    emb = cosearch.embed_adc_only(bpg, fe.base())
    co_marks = [time.perf_counter()]
    pg, pf, _, trained, cfg_c, vdata, sizes, spec = cosearch.run(
        data, fe, bits=bits, hidden=hidden, init=emb, device=dev,
        log=_log_marks(torch, co_marks), model=kind, **kw)
    torch.cuda.synchronize()
    t_search = time.perf_counter()
    ef = search.evaluate_population(emb, vdata, sizes, cfg_c, device=dev)
    embed_ok = bool(np.array_equal(ef[:, 0], bpf[:, 0]))
    _, uf = nsga2.pareto_front(np.concatenate([emb, pg]),
                               np.concatenate([ef, pf]))
    dominance_ok = all(any(c[0] <= u[0] + COSEARCH_EPS
                           and c[1] <= u[1] + COSEARCH_EPS for c in pf)
                       for u in uf)
    designs = deploy.export_front(pg, vdata, sizes, cfg_c, trained=trained,
                                  device=dev)
    parity = deploy.verify_front_parity(designs, pg, vdata, sizes, cfg_c,
                                        device=dev)
    xw, y = data["x_test"], data["y_test"]
    served = deploy.served_accuracies(designs, xw, y, device=dev)
    exported = np.array([d.accuracy for d in designs])
    alone = designs[0].accuracy_on(xw, y, device=dev)     # rows 3 / 4
    with tempfile.TemporaryDirectory() as tmp:
        deploy.save_front(tmp, designs, extra_meta={"dataset": name,
                                                    "sizes": list(sizes)})
        meta = deploy.front_meta(tmp)
        loaded = deploy.load_front(tmp)
    reloaded = deploy.served_accuracies(loaded, xw, y, device=dev)
    rep, feat_s = serve_windows(np, torch, dev, loaded, xw,
                                COSEARCH_SERVE["batches"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    refit = (1.0 - trained[0].astype(np.float32)).astype(np.float64)
    for i, d in enumerate(designs):
        print(f"  {name} {kind} design {i}: sub={d.feature.subsample} "
              f"alloc-off={d.feature.alloc.count(0)} area={d.area_tc}T "
              f"dp={int(d.dp)} exported={d.accuracy!r} "
              f"served={float(served[i])!r}")
    row = {"stream": name, "kind": kind, "config": dict(conf),
           "sizes": list(sizes),
           "train_windows": int(len(data["x_train"])),
           "test_windows": int(len(xw)),
           "baseline_s_per_generation": _per_generation(np, base_marks[1:]),
           "baseline_s": base_marks[-1] - base_marks[0],
           "cosearch_s_per_generation": _per_generation(np, co_marks[1:]),
           "cosearch_s": co_marks[-1] - co_marks[0],
           "search_s": t_search - t0, "wall_s": wall,
           "baseline_front": len(bpg), "front": len(pg),
           "best_accuracy": float(1 - pf[:, 0].min()),
           "baseline_best_accuracy": float(1 - bpf[:, 0].min()),
           "min_area": float(pf[:, 1].min()),
           "embedding_exact": embed_ok, "eps_dominance": dominance_ok,
           "verify_front_parity": parity,
           "served": served.tolist(),
           "windows_per_s": rep["samples_per_s"],
           "serve_batches": rep["batches"], "serve_s": rep["wall_s"],
           "featurize_s": feat_s,
           "featurize_share": feat_s / rep["wall_s"]}
    print(f"  {name} {kind}: baseline {row['baseline_s_per_generation']:.3f}"
          f" s/generation ({row['baseline_s']:.2f} s), co-search "
          f"{row['cosearch_s_per_generation']:.3f} s/generation "
          f"({row['cosearch_s']:.2f} s); fronts {len(bpg)} -> {len(pg)}, "
          f"best accuracy {row['baseline_best_accuracy']:.4f} -> "
          f"{row['best_accuracy']:.4f}; embedding exact {embed_ok}, "
          f"ε-dominance {dominance_ok}, verify_front_parity {parity}; "
          f"raw-window serving {row['windows_per_s']:.0f} windows/s in "
          f"{rep['batches']} microbatches of {COSEARCH_SERVE['batch']}, "
          f"featurize {feat_s:.4f} of {rep['wall_s']:.4f} s "
          f"({100 * row['featurize_share']:.1f} %); on {card}")
    check(embed_ok, f"{name}: the embedded ADC-only front re-scores to "
                    f"{1 - ef[:, 0]}, not its fitness {1 - bpf[:, 0]}")
    check(dominance_ok, f"{name}: the co-search front does not "
                        f"ε-dominate the union front")
    check(parity, f"{name}: verify_front_parity is False")
    check(np.array_equal(refit, pf[:, 0]),
          f"{name}: re-trained accuracies {trained[0]} do not give the "
          f"search fitness {1 - pf[:, 0]}")
    check(np.array_equal(served, exported),
          f"{name}: served accuracies {served} != exported {exported}")
    check(alone == float(np.float32(exported[0])),
          f"{name}: design 0 alone (D=1) {alone!r} != its exported "
          f"accuracy {exported[0]!r}")
    check(FeatureSpec.from_meta(meta["feature"]) == fe.base()
          and [d.feature for d in loaded] == [d.feature for d in designs]
          and np.array_equal(reloaded, served),
          f"{name}: save_front/load_front lost the FeatureSpec or the "
          f"served accuracies")
    return row, designs, data, spec


def cosearch_gradient(np, torch, dev, card, name):
    """The gradient engine with a frontend on stream ``name`` (its
    COSEARCH_STREAMS classifier), cut in depth: export, verify, serve raw
    windows; on a stream in COSEARCH_GRADIENT_LEARNS the best accuracy
    must beat the test split's majority share."""
    from repro_torch.core import deploy, grad_gates, search
    from repro_torch.timeseries import cosearch
    from repro_torch.timeseries.feature import FeatureSpec
    from repro_torch.timeseries.stream import make_stream
    kind, fe_kw = COSEARCH_STREAMS[name]
    fe = FeatureSpec(**fe_kw)
    data = make_stream(name)
    kw = {k: v for k, v in COSEARCH.items()
          if k not in ("bits", "hidden", "generations")}
    print(f"  cut: the gradient engine on {name} runs with "
          f"{COSEARCH_GRADIENT_CUT} (the reference's defaults: "
          f"{4 * COSEARCH['pop_size']} lanes, {8 * COSEARCH['train_steps']} "
          f"gate-train steps in 4 chunks, 2 polish rounds of at most 192 "
          f"exact evaluations)")
    with gradient_record(torch, search, grad_gates) as rec:
        pg, pf, _, trained, cfg, vdata, sizes, _ = cosearch.run(
            data, fe, bits=COSEARCH["bits"], hidden=COSEARCH["hidden"],
            device=dev, model=kind, engine="gradient", **kw,
            **COSEARCH_GRADIENT_CUT)
        torch.cuda.synchronize()
        total = time.perf_counter() - rec["t0"]
    designs = deploy.export_front(pg, vdata, sizes, cfg, trained=trained,
                                  device=dev)
    parity = deploy.verify_front_parity(designs, pg, vdata, sizes, cfg,
                                        device=dev)
    served = deploy.served_accuracies(designs, data["x_test"],
                                      data["y_test"], device=dev)
    exported = np.array([d.accuracy for d in designs])
    refit = (1.0 - trained[0].astype(np.float32)).astype(np.float64)
    majority = float(np.bincount(data["y_test"]).max() / len(data["y_test"]))
    diag, gate_s = rec["diag"], rec["gate_end"]
    (pool, t_rescore), polish_runs = rec["evals"][0], rec["evals"][1:]
    row = {"stream": name, "kind": kind,
           "lanes": diag["lanes"], "gate_steps": diag["steps"],
           "gate_train_s": gate_s, "pool": pool,
           "polish_evals": [n for n, _ in polish_runs],
           "rescore_s": t_rescore - gate_s,
           "polish_s": (polish_runs[-1][1] - t_rescore
                        if polish_runs else 0.0),
           "total_s": total, "front": len(pg),
           "best_accuracy": float(1 - pf[:, 0].min()),
           "majority_share": majority,
           "subsamples": sorted({d.feature.subsample for d in designs}),
           "verify_front_parity": parity,
           "served_best": float(served.max())}
    print(f"  gradient {name} {kind}: {row['lanes']} lanes, "
          f"{row['gate_steps']} gate-train steps ({gate_s:.2f} s), pool "
          f"{pool} genomes, polish {row['polish_evals']}; {total:.2f} s to "
          f"a front of {len(pg)} (subsample factors {row['subsamples']}), "
          f"best accuracy {row['best_accuracy']:.4f} (majority share "
          f"{majority:.4f}); verify_front_parity {parity} on {card}")
    check(parity, f"gradient co-search {name}: verify_front_parity is False")
    check(np.array_equal(refit, pf[:, 0]),
          f"gradient co-search {name}: the front re-trains to {trained[0]}, "
          f"not its fitness {1 - pf[:, 0]}")
    check(np.array_equal(served, exported),
          f"gradient co-search {name}: served {served} != exported "
          f"{exported}")
    if name in COSEARCH_GRADIENT_LEARNS:
        check(row["best_accuracy"] > majority,
              f"gradient co-search {name}: best accuracy "
              f"{row['best_accuracy']} does not beat the majority share "
              f"{majority}")
    return row, designs, data


def cosearch_kernel_checks(np, torch, dev, card, fronts):
    """Rows 2-6 against their plain versions on the card at the
    co-search's shapes, the card's featurize against the CPU's, and row
    2's time at each co-search shape beside its bound. ``fronts``:
    [(label, designs, raw data, spec, the search's pop_size)]; featurize
    and row 2 run once per (stream, spec, windows, pop_size), so every
    shape the path gave row 2 is held and timed."""
    from repro_torch.core.adc import repair_mask
    from repro_torch.kernels import adc_quantize as adcq
    from repro_torch.kernels import envelope, ops, qmlp, ref
    from repro_torch.timeseries import feature as feature_lib
    rng = np.random.default_rng(2026)
    max_err = {}
    timings = {}
    seen = set()
    for label, designs, data, spec, pop in fronts:
        fe = designs[0].feature.base()
        stream_name = label.split()[0]
        shape_key = (stream_name, spec, len(data["x_train"]),
                     len(data["x_test"]), pop)
        if shape_key not in seen:
            seen.add(shape_key)
            for split in ("x_train", "x_test"):
                for s in fe.sub_grid:
                    fn = feature_lib.featurize_fn(fe, s)
                    got = fn(data[split], device=dev).cpu()
                    want = fn(data[split], device="cpu")
                    check(torch.equal(got, want),
                          f"{stream_name} {split}: featurize on the card "
                          f"differs from the CPU's at factor {s}")
            print(f"  featurize {label}: card == CPU bitwise on both "
                  f"splits at factors {fe.sub_grid}")
            # row 2 at the co-search shape: the (V*M, C) train stack
            for split in ("x_train", "x_test"):
                xv = feature_lib.stack_variants(data[split], fe, device=dev)
                v, m, c = xv.shape
                xd = torch.from_numpy(xv).to(dev)
                masks = repair_mask(torch.from_numpy(
                    (rng.random((pop, c, spec.levels))
                     < 0.5).astype(np.int32))).to(dev)
                tables = spec.value_table(masks).contiguous()
                p, n = tables.shape[0], spec.levels
                shape = (p, v * m, c, n)
                check(adcq.geometry(*shape) == tuple(
                    envelope.quantize_geometry(*shape)),
                      f"{stream_name}: row 2's geometry != the envelope's "
                      f"at {shape}")
                got = ops.adc_quantize_variants(xd, masks, spec=spec)
                flat = xd.reshape(v * m, c)
                want = ref.adc_quantize_ref_population(
                    flat, tables, spec.bits, spec.vmin, spec.vmax
                ).reshape(p, v, m, c)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                max_err["adc_quantize_population"] = max(
                    max_err.get("adc_quantize_population", 0.0), err)
                ok = torch.equal(got, want)
                print(f"  adc_quantize_population {stream_name} {split} "
                      f"P={p} M={v}x{m} C={c} 2^N={n}: max_abs_err "
                      f"{err:.3e} [bitwise, geometry ==] "
                      f"{'ok' if ok else 'MISMATCH'}")
                check(ok, f"row 2 disagrees with its plain version at "
                          f"{stream_name} {split}")
                if split != "x_train":
                    continue
                rows = tuple(t.to(dev) for t in _rows(spec, c))
                k_fn = lambda: adcq.adc_quantize_population(  # noqa: E731
                    flat, tables, spec=spec, rows=rows)
                p_fn = lambda: ref.adc_quantize_ref_population(  # noqa
                    flat, tables, spec.bits, spec.vmin, spec.vmax)
                p1, k1, k2, p2 = (cuda_ms(torch, p_fn), cuda_ms(torch, k_fn),
                                  cuda_ms(torch, k_fn), cuda_ms(torch, p_fn))
                dev_ms = device_kernel_ms(torch, k_fn,
                                          "adc_quantize_population_kernel")
                check(dev_ms is not None, "torch.profiler recorded no "
                                          "device time for row 2")
                b_ms, b_by, nbytes, nops = kernel_bound(
                    "adc_quantize_population", v * m, c, n, p=p)
                key = (f"cosearch {stream_name} P={p} M={v * m} C={c} "
                       f"2^N={n}")
                timings[key] = {
                    "shape": {"P": p, "M": v * m, "C": c, "levels": n},
                    "ms": min(k1, k2), "plain_ms": min(p1, p2),
                    "device_ms": dev_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "bytes": nbytes, "ops": nops}
                print(f"  time adc_quantize_population {key}: device "
                      f"{dev_ms * 1e3:.2f} us per launch (call "
                      f"{k1 * 1e3:.2f}/{k2 * 1e3:.2f} us), plain "
                      f"{p1 * 1e3:.2f}/{p2 * 1e3:.2f} us, bound "
                      f"{b_ms * 1e3:.3f} us ({b_by}, {nbytes} bytes) on "
                      f"{card}")
        # rows 5/6 per subsample group, rows 3/4 on each group's first
        from repro_torch.core import deploy
        kind = designs[0].kind
        bank, plain = ((qmlp.bespoke_mlp_bank, ref.bespoke_mlp_bank_ref)
                       if kind == "mlp" else
                       (qmlp.bespoke_svm_bank, ref.bespoke_svm_bank_ref))
        single = qmlp.bespoke_mlp if kind == "mlp" else qmlp.bespoke_svm
        for sub, idx in deploy._feature_groups(designs).items():
            grp = [designs[i] for i in idx]
            x = feature_lib.featurize_fn(grp[0].feature)(data["x_test"],
                                                         device=dev)
            tables, weights = deploy.bank_arrays(grp)
            td = torch.from_numpy(tables).to(dev)
            wd = tuple(torch.from_numpy(w).to(dev) for w in weights)
            for name, got in ((f"qmlp_{kind}_bank",
                               bank(x, td, *wd, spec=spec)),
                              (f"bespoke_{kind}", single(
                                  x, td[0], *(w[0] for w in wd),
                                  spec=spec)[None])):
                want = plain(x, td[:len(got)], spec.bits,
                             *(w[:len(got)] for w in wd), spec.vmin,
                             spec.vmax)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                max_err[name] = max(max_err.get(name, 0.0), err)
                ok = torch.equal(got, want)
                print(f"  {name} {label} sub={sub} D={len(got)} "
                      f"M={x.shape[0]} F={x.shape[1]}: max_abs_err "
                      f"{err:.3e} [bitwise] {'ok' if ok else 'MISMATCH'}")
                check(ok, f"{name} disagrees with its plain version on "
                          f"{label} sub={sub} (max_abs_err {err:.3e}, "
                          f"bitwise)")
    return max_err, timings


def phase_cosearch(np, torch, dev, card):
    """The streaming co-search path: stress MLP and vitals SVM at the
    reference benchmark's configuration, the gradient engine with a
    frontend (cut), then the kernel checks at the path's shapes."""
    from repro_torch.core import search
    from repro_torch.timeseries.feature import FeatureSpec
    print(f"phase cosearch: build_search_inputs -> ADC-only search on "
          f"variant 0 -> embed_adc_only -> cosearch.run -> export_front -> "
          f"verify_front_parity -> serve raw windows -> save_front -> "
          f"load_front on cuda, {COSEARCH}, streams {COSEARCH_STREAMS}")
    out = {}
    fronts = []
    reset_all_launches()
    t0 = time.perf_counter()
    with qat_chunks(search) as chunks:
        for name, (kind, fe_kw) in COSEARCH_STREAMS.items():
            row, designs, data, spec = cosearch_stream(
                np, torch, dev, card, name, kind, FeatureSpec(**fe_kw))
            out[name] = row
            if name == "vitals":
                out["async_tenant"] = (designs, data)
            fronts.append((f"{name} {kind} front", designs, data, spec,
                           COSEARCH["pop_size"]))
        kind, fe_kw = COSEARCH_STREAMS["stress"]
        print(f"  the benchmark's --smoke configuration: {COSEARCH_SMOKE}, "
              f"stress cut to {COSEARCH_SMOKE_WINDOWS} windows")
        row, designs, data, spec = cosearch_stream(
            np, torch, dev, card, "stress", kind, FeatureSpec(**fe_kw),
            COSEARCH_SMOKE, COSEARCH_SMOKE_WINDOWS)
        out["stress_smoke"] = row
        fronts.append((f"stress {kind} smoke front", designs, data, spec,
                       COSEARCH_SMOKE["pop_size"]))
        for name in COSEARCH_STREAMS:
            row, designs, data = cosearch_gradient(np, torch, dev, card,
                                                   name)
            out[f"gradient_{name}"] = row
            fronts.append((f"{name} gradient front", designs, data,
                           designs[0].spec, COSEARCH["pop_size"]))
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = all_launches()
    print(f"  cosearch: {chunks[0]} QAT chunks; launches on this path: row "
          f"2 (adc_quantize_population) "
          f"{launches['adc_quantize_population']}, row 3 (bespoke_mlp) "
          f"{launches['bespoke_mlp']}, row 4 (bespoke_svm) "
          f"{launches['bespoke_svm']}, row 5 (qmlp_mlp_bank) "
          f"{launches['qmlp_mlp_bank']}, row 6 (qmlp_svm_bank) "
          f"{launches['qmlp_svm_bank']}; path {path_s:.2f} s on {card}")
    check(launches["adc_quantize_population"] == 2 * chunks[0],
          f"cosearch: adc_quantize_population launched "
          f"{launches['adc_quantize_population']} times for {chunks[0]} "
          f"QAT chunks (2 per chunk)")
    for name in ("bespoke_mlp", "bespoke_svm", "qmlp_mlp_bank",
                 "qmlp_svm_bank"):
        check(launches[name] > 0, f"cosearch: {name} never launched")
    max_err, timings = cosearch_kernel_checks(np, torch, dev, card, fronts)
    out.update(launches=launches, qat_chunks=chunks[0], path_s=path_s,
               max_err=max_err, timings=timings)
    return out


def bank_check(np, torch, dev, where, designs, batches, exact, max_err):
    """Rows 5/6 (``qmlp.bespoke_{mlp,svm}_bank``) against their plain
    versions on the card, on the same operands: ``designs``' bank on each
    of ``batches`` (``[(label, numpy rows)]``), per subsample group after
    featurize for a raw-window front, the built geometry ==
    ``envelope.bank_geometry``. Bitwise for the dyadic fronts
    (``exact``); for calibrated tables (not dyadic) phase kernels' float
    rule. The largest error feeds ``max_err`` and is returned."""
    from repro_torch.core import deploy
    from repro_torch.kernels import envelope, qmlp, ref
    from repro_torch.timeseries import feature as feature_lib
    kind, spec = designs[0].kind, designs[0].spec
    bank, plain = ((qmlp.bespoke_mlp_bank, ref.bespoke_mlp_bank_ref)
                   if kind == "mlp" else
                   (qmlp.bespoke_svm_bank, ref.bespoke_svm_bank_ref))
    groups = (deploy._feature_groups(designs)
              if designs[0].feature is not None
              else {None: list(range(len(designs)))})
    errs = []
    for fill, xb in batches:
        x = torch.from_numpy(np.ascontiguousarray(xb, np.float32)).to(dev)
        for sub, idx in groups.items():
            grp = [designs[i] for i in idx]
            xg = (x if sub is None else
                  feature_lib.featurize_fn(grp[0].feature)(x))
            tables, weights = deploy.bank_arrays(grp)
            td = torch.from_numpy(tables).to(dev)
            wd = tuple(torch.from_numpy(w).to(dev) for w in weights)
            shape = (kind, td.shape[0], xg.shape[0], td.shape[1],
                     td.shape[2], wd[0].shape[2] if kind == "mlp" else 0,
                     wd[-1].shape[-1])
            at = (f"{where} M={len(xb)} ({fill}"
                  f"{'' if sub is None else f', sub={sub}'})")
            check(qmlp.geometry(*shape)
                  == tuple(envelope.bank_geometry(*shape)),
                  f"{at}: the built kernel's geometry differs from "
                  f"envelope's")
            got = bank(xg, td, *wd, spec=spec)
            plain_out = plain(xg, td, spec.bits, *wd, spec.vmin, spec.vmax)
            torch.cuda.synchronize()
            err = float((got - plain_out).abs().max())
            ok = (torch.equal(got, plain_out) if exact else
                  torch.allclose(got, plain_out, rtol=1e-5, atol=1e-6))
            check(ok, f"{at}: qmlp_{kind}_bank disagrees with its plain "
                      f"version (max_abs_err {err:.3e})")
            errs.append(err)
    name = f"qmlp_{kind}_bank"
    max_err[name] = max(max_err[name], max(errs))
    return max(errs)


def engine_batches(np, ladder, reqs):
    """The batches the serving engine can dispatch at each ``ladder``
    size: one request's rows then zeros (a thin queue), a full batch,
    and the warm-up's zeros."""
    rows = np.concatenate([r.x for r in reqs])
    out = []
    for size in ladder:
        one = np.pad(reqs[0].x, ((0, size - reqs[0].rows),)
                     + ((0, 0),) * (rows.ndim - 1))
        out += [("one request", one), ("full", rows[:size]),
                ("warm-up zeros", np.zeros_like(one))]
    return out


def driver_batches(np, requests, batch):
    """The microbatches ``serve_classifier.serve`` forms from
    ``requests``: their rows in order, cut into ``batch`` rows, the last
    zero-padded, after its zeros warm-up batch."""
    rows = np.concatenate([x for _, x in requests])
    rows = np.pad(rows, ((0, -len(rows) % batch),)
                  + ((0, 0),) * (rows.ndim - 1))
    return ([("warm-up zeros", np.zeros_like(rows[:batch]))]
            + [(f"microbatch {i // batch}", rows[i:i + batch])
               for i in range(0, len(rows), batch)])


def phase_async(np, torch, dev, card, fronts, data, vitals):
    """The async serving path: the serving engine on the card at the
    reference serve_scale cell's shape (ASYNC), three tenants in one
    engine per cell, then a failover on [cuda:0, cuda:0], a calibrated
    tenant's calibrate-on-recovery and the pool's exhaustion. Every
    response must equal the direct make_bank_fn prediction on the plain
    route bitwise, rows 5/6 their plain versions at every ladder size the
    engine dispatches, and every tenant's served accuracies its exported
    ones."""
    import asyncio
    import dataclasses

    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import deploy
    from repro_torch.core.nonideal import NonIdealSpec
    from repro_torch.launch import loadgen
    from repro_torch.launch import serving_engine as se
    sources = {"cardio_mlp": (fronts["mlp"][0], data),
               "cardio_svm": (fronts["svm"][0], data),
               "vitals_svm": vitals}
    sizes = {"1": 1, "front": None}
    print(f"phase async: serving_engine.run_workload on cuda, tenants "
          f"{ {n: (len(d), d[0].sample_shape) for n, (d, _) in sources.items()} }, "
          f"{ASYNC}, rates {ASYNC_RATES} req/s per tenant")

    def workload(rate, requests, deadline_ms, names=tuple(sources)):
        return loadgen.merge_workloads(*(
            loadgen.make_workload(sources[n][1]["x_test"], requests,
                                  tenant=n, rate_rps=rate,
                                  request_size=ASYNC["request_size"],
                                  deadline_ms=deadline_ms,
                                  shape=ASYNC["shape"], seed=i)
            for i, n in enumerate(names)))

    def tenants(d, names=tuple(sources), nonideal=None):
        return [se.Tenant(n, sources[n][0][:sizes[d]],
                          parity_data=(sources[n][1]["x_test"],
                                       sources[n][1]["y_test"]),
                          nonideal=nonideal) for n in names]

    fail = ASYNC_FAILOVER
    cal_ni = NonIdealSpec(**ASYNC_CAL_NI)
    fail_at = lambda engine: (  # noqa: E731
        lambda b: 0 if b == fail["fail_at"] else None)
    cal_split = {}

    def fail_after_rows(engine):
        """The loss at the first launch after ASYNC_CAL_SPLIT_ROWS rows
        were served (whatever the quantum), the rows served before it
        kept in ``cal_split``."""
        def inject(b):
            if "rows" not in cal_split and \
                    engine.dispatched_rows >= ASYNC_CAL_SPLIT_ROWS:
                cal_split["rows"] = engine.dispatched_rows
                return 0
            return None
        return inject

    def serve(tenant_list, wl, devices, inject=None):
        """One engine over ``tenant_list`` replaying ``wl``, its device-loss
        hook ``inject(engine)`` where given; the report gains the median
        of the engine's batch wall times (its step watchdog's window: the
        last 50 batches)."""
        engine = se.ServingEngine(
            tenant_list, devices=devices,
            target_latency_ms=ASYNC["target_latency_ms"],
            max_batch=ASYNC["max_batch"])
        rep = asyncio.run(engine.serve(
            wl, inject_device_failure=None if inject is None
            else inject(engine)))
        rep["batch_ms_median"] = float(
            np.median(engine.watchdog.durations)) * 1e3
        return rep

    reset_all_launches()
    marks = [time.perf_counter()]
    cells = {}
    for d in sizes:
        for rate in ASYNC_RATES:
            wl = workload(rate, ASYNC["requests"], ASYNC["deadline_ms"])
            if (d, rate) != ASYNC_TRACED:
                cells[(d, rate)] = (wl, serve(tenants(d), wl, [dev]))
                continue
            # device activity only (the engine's host threads are not
            # traced); busy share of the traced call's wall time
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                tw = time.perf_counter()
                cells[(d, rate)] = (wl, serve(tenants(d), wl, [dev]))
                torch.cuda.synchronize()
                traced_wall = time.perf_counter() - tw
    marks.append(time.perf_counter())
    fo_wl = workload(fail["rate"], fail["requests"], fail["deadline_ms"])
    fo_rep = serve(tenants("front"), fo_wl, [dev, dev], fail_at)
    marks.append(time.perf_counter())
    # every request at 0: the trace is queued before launch 0, so the
    # launches serve its rows in order; those before the loss (at least
    # ASYNC_CAL_SPLIT_ROWS) on instance 0
    cal_wl = [dataclasses.replace(r, arrival_s=0.0,
                                  deadline_s=fail["deadline_ms"] / 1e3)
              for r in workload(fail["rate"], fail["requests"],
                                fail["deadline_ms"], names=("cardio_svm",))]
    cal_rep = serve(tenants("front", ("cardio_svm",), cal_ni), cal_wl,
                    [dev, dev], fail_after_rows)
    marks.append(time.perf_counter())
    exhausted = None
    try:
        serve(tenants("1"), cal_wl[:4], [dev], lambda e: lambda b: 0)
    except RuntimeError as exc:
        exhausted = str(exc)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    path_s = marks[-1] - marks[0]
    steps_s = dict(zip(("cells", "failover", "calibrated", "exhaustion"),
                       np.diff(marks).tolist()))
    launches = all_launches()
    print(f"  async: launches on this path: row 5 (qmlp_mlp_bank) "
          f"{launches['qmlp_mlp_bank']}, row 6 (qmlp_svm_bank) "
          f"{launches['qmlp_svm_bank']}; others "
          f"{ {k: v for k, v in launches.items() if v and 'bank' not in k} }; "
          f"path {path_s:.2f} s ({', '.join(f'{k} {v:.2f} s' for k, v in steps_s.items())}) "
          f"on {card}")
    for name in ("qmlp_mlp_bank", "qmlp_svm_bank"):
        check(launches[name] > 0, f"async: {name} never launched")

    banks, preds = {}, {}

    def want(name, d, x, designs=None):
        """The direct make_bank_fn prediction for one request's rows, on
        the plain route (the CPU), so the served kernel is held against
        another path."""
        bank = (name, d, id(designs))
        key = bank + (x.tobytes(),)
        if key not in preds:
            if bank not in banks:
                banks[bank] = deploy.make_bank_fn(
                    designs if designs is not None
                    else sources[name][0][:sizes[d]], device="cpu")
            preds[key] = torch.argmax(banks[bank](x), dim=-1).numpy()
        return preds[key]

    max_err = {"qmlp_mlp_bank": 0.0, "qmlp_svm_bank": 0.0}

    def ladder_check(label, designs, ladder, reqs, exact):
        """Rows 5/6 against their plain versions at every ladder size the
        engine can dispatch, on batches padded as the engine pads them
        (``bank_check``, ``engine_batches``)."""
        err = bank_check(np, torch, dev, f"async {label}", designs,
                         engine_batches(np, ladder, reqs), exact, max_err)
        groups = (len(deploy._feature_groups(designs))
                  if designs[0].feature is not None else 1)
        print(f"  qmlp_{designs[0].kind}_bank {label}: M {ladder} x (one "
              f"request, full, warm-up zeros)"
              f"{f' x {groups} subsample groups' if groups > 1 else ''}"
              f", max_abs_err {err:.3e} "
              f"[{'bitwise' if exact else 'rtol=1e-5 atol=1e-6'}, "
              f"geometry ==] ok")

    def responses_ok(wl, rep, d, label):
        for req in wl:
            got = rep["responses"][req.rid]
            if got is not None:
                check(np.array_equal(got, want(req.tenant, d, req.x)),
                      f"async {label}: request {req.rid} ({req.tenant}) "
                      f"differs from the direct bank's prediction")

    reached = {name: sorted({s for _, rep in cells.values()
                             for s in rep["batch_sizes"][name]["ladder"]})
               for name in sources}
    traced_wl = cells[ASYNC_TRACED][0]
    for d in sizes:
        for name, (designs, _) in sources.items():
            ladder_check(f"{name} D={d}", designs[:sizes[d]],
                         reached[name],
                         [r for r in traced_wl if r.tenant == name], True)
    out = {"cells": {}}
    for (d, rate), (wl, rep) in cells.items():
        label = f"D={d},rate={rate:g}"
        responses_ok(wl, rep, d, label)
        offered = loadgen.describe(wl)
        row = {"offered_rps": offered["offered_rps"],
               "span_s": offered["span_s"], "wall_s": rep["wall_s"],
               "batches": rep["batches"],
               "batch_ms_median": rep["batch_ms_median"],
               "pad_fraction": rep["pad_fraction"],
               "stragglers": rep["stragglers"], "tenants": {}}
        for name, slo in sorted(rep["tenants"].items()):
            check(slo["completed"] + slo["shed"] == ASYNC["requests"]
                  and slo["rejected"] == 0,
                  f"async {label}: {name} accounts for {slo}")
            bs = rep["batch_sizes"][name]
            row["tenants"][name] = {
                k: slo[k] for k in ("p50_ms", "p95_ms", "p99_ms",
                                    "requests_per_s", "samples_per_s",
                                    "completed", "shed")}
            row["tenants"][name].update(
                ladder=bs["ladder"], final=bs["final"],
                trajectory_tail=bs["trajectory_tail"])
            print(f"  {label} {name}: p50 {slo['p50_ms']:.3f} ms, p95 "
                  f"{slo['p95_ms']:.3f} ms, p99 {slo['p99_ms']:.3f} ms, "
                  f"{slo['requests_per_s']:.1f} req/s, "
                  f"{slo['samples_per_s']:.0f} samples/s, shed "
                  f"{slo['shed']}; ladder {bs['ladder']} final "
                  f"{bs['final']} tail {bs['trajectory_tail']}")
        print(f"  {label}: offered {offered['offered_rps']:.1f} req/s "
              f"over {offered['span_s']:.4f} s (all tenants), "
              f"{rep['batches']} batches (median "
              f"{rep['batch_ms_median']:.3f} ms each), pad fraction "
              f"{rep['pad_fraction']:.4f}, stragglers {rep['stragglers']}, "
              f"wall {rep['wall_s']:.4f} s on {card}")
        out["cells"][label] = row
    for d in sizes:
        for name, (designs, split) in sources.items():
            served = deploy.served_accuracies(
                designs[:sizes[d]], split["x_test"], split["y_test"],
                device=dev)
            exported = np.array([x.accuracy for x in designs[:sizes[d]]])
            check(np.array_equal(served, exported),
                  f"async D={d} {name}: served {served} != exported "
                  f"{exported}")
    print("  every response == the direct make_bank_fn prediction on the "
          "plain route; served "
          "== exported for every tenant at D=1 and the whole front")

    dev_us = sum(ev.time_range.elapsed_us() for ev in prof.events()
                 if "DeviceType.CUDA" in str(getattr(ev, "device_type", "")))
    check(dev_us > 0, "torch.profiler recorded no device time for the "
                      "traced async cell")
    busy = dev_us / 1e6 / traced_wall
    traced = f"D={ASYNC_TRACED[0]},rate={ASYNC_TRACED[1]:g}"
    print(f"  {traced} traced: wall {traced_wall:.4f} s, device "
          f"{dev_us / 1e3:.3f} ms, device busy {busy * 100:.2f} % on {card}")
    out["traced"] = {"cell": traced, "wall_s": traced_wall,
                     "device_ms": dev_us / 1e3, "device_busy_share": busy}

    responses_ok(fo_wl, fo_rep, "front", "failover")
    fo_done = {n: s["completed"] for n, s in fo_rep["tenants"].items()}
    print(f"  failover on [{dev}, {dev}] at launch {fail['fail_at']}: "
          f"recoveries {fo_rep['recoveries']}, devices "
          f"{fo_rep['devices']}, completed {fo_done} of "
          f"{fail['requests']} each, responses bitwise")
    check(fo_rep["recoveries"] == 1
          and fo_rep["devices"] == {"alive": 1, "lost": 1, "sharded": False},
          f"async failover: {fo_rep['recoveries']} recoveries, "
          f"{fo_rep['devices']}")
    check(all(v == fail["requests"] for v in fo_done.values())
          and all(s["shed"] == 0 for s in fo_rep["tenants"].values()),
          f"async failover: completed {fo_done}")
    cal = [deploy.calibrate_front(sources["cardio_svm"][0], cal_ni,
                                  instance=k, samples=k + 1, device=dev)
           for k in (0, 1)]
    # the rows served before the loss came from instance 0; the failing
    # launch and every later one serve instance 1: row by row, in the
    # trace's order
    first = cal_split.get("rows", 0)
    cal_preds = [[want("cardio_svm", "front", req.x, c) for req in cal_wl]
                 for c in cal]
    row0 = np.cumsum([0] + [req.rows for req in cal_wl])
    for i, req in enumerate(cal_wl):
        got = cal_rep["responses"][req.rid]
        before = np.arange(row0[i], row0[i + 1]) < first
        expect = np.where(before, cal_preds[0][i], cal_preds[1][i])
        check(got is not None and np.array_equal(got, expect),
              f"async calibrated: request {req.rid} is not instance 0's "
              f"prediction on its rows before row {first} and instance "
              f"1's after")
    rows_differ = np.concatenate([np.any(a != b, axis=0) for a, b in
                                  zip(cal_preds[0], cal_preds[1])])
    differ = [int(rows_differ[:first].sum()),
              int(rows_differ[first:].sum())]
    check(first >= ASYNC_CAL_SPLIT_ROWS and all(differ),
          f"async calibrated: the loss came after {first} rows; instances "
          f"0 and 1 answer {differ} rows differently before/after it; the "
          f"check cannot tell them apart")
    for k, c in enumerate(cal):
        ladder_check(f"cardio_svm calibrated instance {k}", c,
                     cal_rep["batch_sizes"]["cardio_svm"]["ladder"],
                     cal_wl, False)
    print(f"  calibrated cardio_svm ({cal_ni.describe()}): calibrations "
          f"{cal_rep['calibrations']}, recoveries {cal_rep['recoveries']}; "
          f"rows 0-{first - 1} (quantum "
          f"{cal_rep['batch_sizes']['cardio_svm']['quantum']}) == instance "
          f"0, the rest == instance 1 (plain route); the instances differ "
          f"on {differ} of those rows")
    check(cal_rep["calibrations"] == {"cardio_svm": 2}
          and cal_rep["recoveries"] == 1,
          f"async calibrated: {cal_rep['calibrations']}, "
          f"{cal_rep['recoveries']} recoveries")
    check(exhausted is not None and "exhausted" in exhausted,
          f"async: losing the last pool entry gave {exhausted!r}")
    print(f"  losing the last entry of [{dev}] raises: {exhausted}")
    out.update(launches=launches, path_s=path_s, steps_s=steps_s,
               failover={"recoveries": fo_rep["recoveries"],
                         "completed": fo_done,
                         "tenants": {n: {k: s[k] for k in ("p50_ms",
                                                           "p99_ms")}
                                     for n, s in fo_rep["tenants"].items()}},
               calibrations=cal_rep["calibrations"], max_err=max_err)
    return out


# ------------------------------------------------------------ sharded path
def launch_delta(before):
    """Launch counts since ``before`` (an ``all_launches()`` snapshot),
    nonzero entries only."""
    now = all_launches()
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v - before.get(k, 0)}


def phase_sharded(np, torch, dev, card, fronts, data):
    """The sharded path (ROADMAP A9b) on a mesh of [cuda:0] (one trivial
    shard) and of [cuda:0, cuda:0] (two shards on the one card): the
    sharded engine's fitness against the batched engine's, bitwise, for
    the MLP, the SVM, the robust MLP, the FT SVM and the vitals
    co-search, with duplicates and with a unique count no rule divides;
    a sharded search to serving, killed and resumed; the sharded
    quantizer and banks against the unsharded entries and the plain
    versions; the batch driver and one --sharded CLI call; the serving
    engine on a sharded pool of [cuda:0, cuda:0] through a device loss,
    a calibrated tenant included. Launches are counted from 0 over all
    of it; the batched references are taken before the count starts and
    the timings after it ends."""
    import asyncio
    import dataclasses
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import deploy, search
    from repro_torch.core.nonideal import NonIdealSpec
    from repro_torch.data import tabular
    from repro_torch.distributed import elastic, sharding
    from repro_torch.faulttol import FaultTolSpec
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import loadgen, serve_classifier
    from repro_torch.launch import serving_engine as se
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.timeseries import cosearch
    from repro_torch.timeseries.feature import FeatureSpec
    from repro_torch.timeseries.stream import make_stream
    spec = tabular.SPECS[DATASET]
    sizes = (spec.features, spec.hidden, spec.classes)
    axes = ("data", "model")
    meshes = {"[cuda:0]": make_mesh((1, 1), axes, devices=[dev]),
              "[cuda:0, cuda:0]": make_mesh((2, 1), axes,
                                            devices=[dev, dev])}
    two = meshes["[cuda:0, cuda:0]"]
    # one 'data' axis of 2: an odd leading axis divides no rule
    odd = make_mesh((2,), ("data",), devices=[dev, dev])
    ni = NonIdealSpec(**ROBUST_NI)
    print(f"phase sharded: the sharded engine, search, quantizer, banks, "
          f"batch driver and serving pool on meshes {list(meshes)} on "
          f"cuda, cardio sizes={sizes}, {SEARCH}")
    t_phase = time.perf_counter()

    # -- the configs and their inputs; the batched references first
    fe = FeatureSpec(**COSEARCH_STREAMS["vitals"][1])
    vdata, vsizes, vspec = cosearch.build_search_inputs(
        make_stream("vitals"), fe, bits=COSEARCH["bits"],
        hidden=COSEARCH["hidden"], device=dev)
    dd = search.device_data(data, dev)
    configs = {
        "mlp": (search.SearchConfig(model="mlp", **SEARCH), dd, sizes),
        "svm": (search.SearchConfig(model="svm", **SEARCH), dd, sizes),
        "robust mlp": (search.SearchConfig(
            model="mlp", nonideal=ni, robust_objective="expected",
            **ROBUST), dd, sizes),
        "ft svm": (search.SearchConfig(
            model="svm", nonideal=ni, robust_objective="yield",
            faulttol=FaultTolSpec(), **ROBUST), dd, sizes),
        "vitals cosearch svm": (search.SearchConfig.for_spec(
            vspec, frontend=fe.base(), model="svm",
            pop_size=COSEARCH["pop_size"],
            train_steps=COSEARCH["train_steps"], seed=COSEARCH["seed"]),
            search.device_data(vdata, dev), vsizes)}
    rng = np.random.default_rng(22)
    cases = {}
    for name, (cfg, d, sz) in configs.items():
        glen = search.genome_len(sz[0], cfg.bits, cfg.faulttol,
                                 frontend=cfg.frontend)
        g = (rng.random((cfg.pop_size, glen)) < 0.5).astype(np.uint8)
        g[0] = 1
        g[-2:] = g[1:3]                     # duplicates: 14 unique
        pops = {"duplicates": g}
        if name in ("mlp", "svm"):
            odd_g = (rng.random((15, glen)) < 0.5).astype(np.uint8)
            pops["no duplicates"] = odd_g
        cases[name] = {label: (p, search.evaluate_population(p, d, sz, cfg))
                       for label, p in pops.items()}
    tables_wide = {}
    bank_rng = np.random.default_rng(2025)
    x_serve = data["x_test"][bank_rng.integers(0, len(data["x_test"]),
                                               size=1024)]
    for kind in ("mlp", "svm"):
        designs, bspec, tables, weights = fronts[kind]
        tile = np.arange(64) % len(designs)
        wide_x = data["x_test"][bank_rng.integers(0, len(data["x_test"]),
                                                  size=65536)]
        tables_wide[kind] = (bspec, wide_x, tables[tile],
                             tuple(w[tile] for w in weights))
    torch.cuda.synchronize()
    t_refs = time.perf_counter()

    reset_all_launches()
    # -- fitness: sharded == batched, bitwise; launches per shard
    per_eval = {}
    with qat_chunks(search) as chunks:
        for name, (cfg, d, sz) in configs.items():
            for label, (pop, want) in cases[name].items():
                runs = ([(m, meshes[m]) for m in meshes]
                        if label == "duplicates" else
                        [("[cuda:0, cuda:0]", two), ("odd 'data' axis", odd)])
                for mname, mesh in runs:
                    before, c0 = all_launches(), chunks[0]
                    got = search.evaluate_population_sharded(pop, d, sz, cfg,
                                                             mesh)
                    torch.cuda.synchronize()
                    delta, n_chunks = launch_delta(before), chunks[0] - c0
                    uniq = len(np.unique(pop, axis=0))
                    rule = sharding.population_axes(mesh, uniq)
                    shards = len(sharding.shard_plan(mesh, rule, uniq))
                    check(np.array_equal(got, want),
                          f"sharded {name} ({label}) on {mname}: fitness "
                          f"differs from the batched engine's "
                          f"(max |diff| {np.abs(got - want).max():.3e})")
                    check(n_chunks == shards
                          and delta.get("adc_quantize_population", 0)
                          == 2 * n_chunks,
                          f"sharded {name} ({label}) on {mname}: {n_chunks}"
                          f" QAT chunks for {shards} shards, launches "
                          f"{delta}")
                    mc = ("mc_adc_eval_cal_population" if cfg.faulttol
                          else "mc_adc_eval_population"
                          if cfg.wants_robustness else None)
                    if mc is not None:
                        check(delta.get(mc, 0) == n_chunks,
                              f"sharded {name} on {mname}: {mc} launched "
                              f"{delta.get(mc, 0)} times for {n_chunks} "
                              f"chunks")
                    per_eval[f"{name} {label} {mname}"] = {
                        "unique": uniq, "rule": rule, "shards": shards,
                        "launches": delta}
                    print(f"  {name} ({label}, {uniq} unique) on {mname}: "
                          f"rule {rule}, {shards} shard(s), launches "
                          f"{delta} == batched fitness bitwise")

    # -- a sharded search to serving, killed after generation 1 and resumed
    s_cfg = search.SearchConfig(model="mlp", engine="sharded",
                                **dict(SEARCH, generations=2))
    with tempfile.TemporaryDirectory() as tmp:
        whole = CheckpointManager(Path(tmp) / "whole", keep=2)
        t0 = time.perf_counter()
        pg, pf, _, trained = search.run_search(
            data, sizes, s_cfg, ckpt=whole, return_trained=True, mesh=two)
        torch.cuda.synchronize()
        search_s = time.perf_counter() - t0
        designs = deploy.export_front(pg, data, sizes, s_cfg,
                                      trained=trained, device=dev)
        parity = deploy.verify_front_parity(designs, pg, data, sizes, s_cfg,
                                            device=dev)
        exported = np.array([d.accuracy for d in designs])
        served = deploy.served_accuracies(designs, data["x_test"],
                                          data["y_test"], mesh=two)
        served_wide = deploy.served_accuracies(
            designs * 2, data["x_test"], data["y_test"], mesh=two)
        parted = CheckpointManager(Path(tmp) / "parted", keep=2)
        killing_save(parted, 1)
        try:
            search.run_search(data, sizes, s_cfg, ckpt=parted, mesh=two)
            check(False, "sharded: the killed search was not killed")
        except Killed:
            pass
        rg, rf, _ = search.run_search(data, sizes, s_cfg, ckpt=parted,
                                      resume=True, mesh=two)
        last = s_cfg.generations
        a, b = whole.restore_flat(last), parted.restore_flat(last)
    refit = (1.0 - trained[0].astype(np.float32)).astype(np.float64)
    check(parity, "sharded search: verify_front_parity is False")
    check(np.array_equal(refit, pf[:, 0]),
          f"sharded search: the front re-trains to {trained[0]}, not its "
          f"fitness {1 - pf[:, 0]}")
    check(np.array_equal(served, exported)
          and np.array_equal(served_wide, np.concatenate([exported] * 2)),
          f"sharded search: served (mesh) {served} != exported {exported}")
    check(sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k])
                                         for k in a)
          and np.array_equal(rg, pg) and np.array_equal(rf, pf),
          "sharded search: the resumed run differs from the "
          "uninterrupted one")
    print(f"  run_search(engine='sharded', mesh=[cuda:0, cuda:0]) "
          f"{s_cfg.generations} generations: {len(pf)} front points in "
          f"{search_s:.2f} s; export, verify_front_parity, "
          f"served_accuracies(mesh=) (D={len(designs)} and "
          f"{2 * len(designs)}) == exported bitwise; killed after "
          f"generation 1 and resumed == uninterrupted bitwise on {card}")

    # -- the sharded quantizer and banks, outputs kept for the checks
    x_tr = dd["x_train"]
    masks = search.decode_population(cases["mlp"]["duplicates"][0],
                                     sizes[0], SEARCH["bits"])[0]
    q_spec = configs["mlp"][0].adc_spec
    q_got = ops.adc_quantize_population_sharded(x_tr, masks, mesh=two,
                                                spec=q_spec)
    bank_out = []
    for kind in ("mlp", "svm"):
        designs_k, bspec, tables, weights = fronts[kind]
        x_te = torch.from_numpy(data["x_test"]).to(dev)
        for label, mesh, t, w, x in (
                ("fixture front", two, tables, weights, x_te),
                ("fixture front", meshes["[cuda:0]"], tables, weights, x_te),
                ("fixture front", odd, tables, weights, x_te),
                ("wide", two, *tables_wide[kind][2:],
                 torch.from_numpy(tables_wide[kind][1]).to(dev))):
            before = all_launches()
            got = ops.classifier_bank_sharded(x, t, w, mesh=mesh, kind=kind,
                                              spec=bspec)
            bank_out.append((kind, label, mesh, t, w, x, got,
                             launch_delta(before)))

    # -- the batch driver on [cuda:0, cuda:0] and one --sharded CLI call
    requests = serve_classifier.make_request_stream(data["x_test"], 256, 8)
    driver = {kind: serve_classifier.serve(fronts[kind][0], requests, 1024,
                                           mesh=two)
              for kind in ("mlp", "svm")}
    cli = serve_classifier.main(["--front-dir", str(FRONTS / "cardio_mlp"),
                                 "--dataset", DATASET, "--sharded",
                                 "--requests", "64"])

    # -- the serving engine on a sharded pool through a device loss
    fail_at = lambda b: 0 if b == 1 else None  # noqa: E731
    tenants = [se.Tenant(f"cardio_{k}", fronts[k][0],
                         parity_data=(data["x_test"], data["y_test"]))
               for k in ("mlp", "svm")]
    wl = loadgen.merge_workloads(*(
        loadgen.make_workload(data["x_test"], ASYNC_FAILOVER["requests"],
                              tenant=t.name, rate_rps=ASYNC_FAILOVER["rate"],
                              request_size=ASYNC["request_size"],
                              deadline_ms=ASYNC_FAILOVER["deadline_ms"],
                              shape=ASYNC["shape"], seed=i)
        for i, t in enumerate(tenants)))
    engine = se.ServingEngine(tenants, devices=[dev, dev], sharded=True,
                              target_latency_ms=ASYNC["target_latency_ms"],
                              max_batch=ASYNC["max_batch"])
    live_mesh = engine.pool.mesh()
    fo_rep = asyncio.run(engine.serve(wl, inject_device_failure=fail_at))
    cal_ni = NonIdealSpec(**ASYNC_CAL_NI)
    cal_designs = list(fronts["svm"][0]) * 2        # D=6: two shards
    cal_wl = [dataclasses.replace(r, arrival_s=0.0,
                                  deadline_s=ASYNC_FAILOVER["deadline_ms"]
                                  / 1e3)
              for r in loadgen.make_workload(
                  data["x_test"], ASYNC_FAILOVER["requests"],
                  tenant="cardio_svm", rate_rps=ASYNC_FAILOVER["rate"],
                  request_size=ASYNC["request_size"], seed=0)]
    cal_rep = se.run_workload(
        [se.Tenant("cardio_svm", cal_designs,
                   parity_data=(data["x_test"], data["y_test"]),
                   nonideal=cal_ni)], cal_wl, devices=[dev, dev],
        sharded=True, target_latency_ms=ASYNC["target_latency_ms"],
        max_batch=ASYNC["max_batch"], inject_device_failure=fail_at)
    exhausted = None
    try:
        se.run_workload(tenants[1:], cal_wl[:4], devices=[dev],
                        sharded=True, inject_device_failure=lambda b: 0)
    except RuntimeError as exc:
        exhausted = str(exc)
    torch.cuda.synchronize()
    launches = all_launches()
    path_s = time.perf_counter() - t_refs

    # -- checks against the unsharded entries and the plain versions
    q_want = ref.adc_quantize_ref_population(
        x_tr, q_spec.value_table(masks.to(dev)).contiguous(), q_spec.bits,
        q_spec.vmin, q_spec.vmax)
    check(torch.equal(q_got, q_want),
          "adc_quantize_population_sharded on [cuda:0, cuda:0] differs "
          "from the plain quantizer")
    max_err = {"adc_quantize_population": 0.0, "qmlp_mlp_bank": 0.0,
               "qmlp_svm_bank": 0.0}
    for kind, label, mesh, t, w, x, got, delta in bank_out:
        bspec = fronts[kind][1]
        td = torch.from_numpy(t).to(dev)
        wd = tuple(torch.from_numpy(a).to(dev) for a in w)
        unsharded = ops.classifier_bank(x, td, wd, kind=kind, spec=bspec)
        plain = (ref.bespoke_mlp_bank_ref if kind == "mlp"
                 else ref.bespoke_svm_bank_ref)(x, td, bspec.bits, *wd,
                                                bspec.vmin, bspec.vmax)
        rule = sharding.design_bank_axes(mesh, len(t))
        shards = len(sharding.shard_plan(mesh, rule, len(t)))
        name = f"qmlp_{kind}_bank"
        err = float((got - plain).abs().max())
        max_err[name] = max(max_err[name], err)
        check(torch.equal(got, unsharded) and torch.equal(got, plain),
              f"classifier_bank_sharded {kind} {label} (D={len(t)}) "
              f"differs from the unsharded bank or the plain version "
              f"(max_abs_err {err:.3e})")
        check(delta == {name: shards},
              f"classifier_bank_sharded {kind} {label}: launches {delta}, "
              f"expected {shards} of {name}")
        print(f"  classifier_bank_sharded {kind} {label} D={len(t)} "
              f"M={x.shape[0]} on {mesh.shape}: rule {rule}, {shards} "
              f"launch(es); == unsharded bank == plain version bitwise")
    for kind, rep in driver.items():
        plain_rep = serve_classifier.serve(fronts[kind][0], requests, 1024,
                                           device="cpu")
        check(all(np.array_equal(rep["responses"][rid],
                                 plain_rep["responses"][rid])
                  for rid, _ in requests),
              f"batch driver {kind} on [cuda:0, cuda:0]: predictions "
              f"differ from the plain route's")
    check(cli["served_accuracies"] == [d.accuracy for d in fronts["mlp"][0]],
          f"--sharded CLI: served {cli['served_accuracies']}")

    def shard_check(label, designs, mesh, batches, exact=True):
        """Rows 5/6 on each shard's slice of ``designs`` (the split
        ``make_bank_fn(mesh=)`` makes) against their plain versions on
        the card, on ``batches`` (``bank_check``)."""
        designs = list(designs)
        plan = sharding.shard_plan(
            mesh, sharding.design_bank_axes(mesh, len(designs)),
            len(designs))
        errs = [bank_check(np, torch, dev,
                           f"sharded {label} shard {k + 1}/{len(plan)}",
                           designs[sl], batches, exact, max_err)
                for k, (_, sl) in enumerate(plan)]
        rows = sorted({len(xb) for _, xb in batches})
        print(f"  qmlp_{designs[0].kind}_bank {label}: {len(plan)} shard(s) "
              f"of D={len(designs) // len(plan)}, M {rows} x "
              f"{len(batches)} batches, max_abs_err {max(errs):.3e} "
              f"[{'bitwise' if exact else 'rtol=1e-5 atol=1e-6'}, "
              f"geometry ==] ok")

    # every (D, M) the path gave rows 5/6, each shard's slice against the
    # plain version on the same operands
    x_te_np = np.asarray(data["x_test"], np.float32)
    for kind in ("mlp", "svm"):
        shard_check(f"batch driver {kind}", fronts[kind][0], two,
                    driver_batches(np, requests, 1024))
    cli_requests = serve_classifier.make_request_stream(data["x_test"], 64,
                                                        8)
    cli_mesh = search.default_search_mesh(dev)
    shard_check("--sharded CLI", fronts["mlp"][0], cli_mesh,
                driver_batches(np, cli_requests, 128)
                + [("x_test", x_te_np)])
    for label, front in (("served search front", designs),
                         ("served search front x2", designs * 2)):
        shard_check(label, front, two, [("x_test", x_te_np)])
    pool_mesh = elastic.bank_pool_mesh([dev, dev])
    for t in tenants:
        batches = engine_batches(
            np, fo_rep["batch_sizes"][t.name]["ladder"],
            [r for r in wl if r.tenant == t.name])
        shard_check(f"sharded pool {t.name} (before the loss)", t.designs,
                    pool_mesh, batches)
        shard_check(f"sharded pool {t.name} (after the loss)", t.designs,
                    make_mesh((1,), ("data",), devices=[dev]), batches)
    print(f"  batch driver on [cuda:0, cuda:0]: {len(requests)} requests "
          f"per front == the plain route's; serve_classifier --sharded "
          f"(default mesh, {torch.cuda.device_count()} card(s)): parity OK")

    plain_banks = {}

    def want(designs, x):
        """The plain route's prediction (make_bank_fn on the CPU)."""
        if id(designs) not in plain_banks:
            plain_banks[id(designs)] = deploy.make_bank_fn(designs,
                                                           device="cpu")
        return torch.argmax(plain_banks[id(designs)](x), dim=-1).numpy()

    by_name = {t.name: t.designs for t in tenants}
    for req in wl:
        check(np.array_equal(fo_rep["responses"][req.rid],
                             want(by_name[req.tenant], req.x)),
              f"sharded pool: request {req.rid} ({req.tenant}) differs "
              f"from the plain route's")
    check(live_mesh is not None and live_mesh.size == 2
          and fo_rep["recoveries"] == 1
          and fo_rep["devices"] == {"alive": 1, "lost": 1,
                                    "sharded": False},
          f"sharded pool: mesh before the loss {live_mesh}, after it "
          f"{fo_rep['devices']}, {fo_rep['recoveries']} recoveries")
    check(all(s["completed"] == ASYNC_FAILOVER["requests"]
              for s in fo_rep["tenants"].values()),
          f"sharded pool: {fo_rep['tenants']}")
    cal = [deploy.calibrate_front(cal_designs, cal_ni, instance=k,
                                  samples=k + 1, device=dev) for k in (0, 1)]
    first = (cal_rep["batch_sizes"]["cardio_svm"]["quantum"]
             // ASYNC["request_size"])
    for i, req in enumerate(cal_wl):
        check(np.array_equal(cal_rep["responses"][req.rid],
                             want(cal[int(i >= first)], req.x)),
              f"sharded pool, calibrated: request {req.rid} is not "
              f"instance {int(i >= first)}'s plain-route prediction")
    check(cal_rep["calibrations"] == {"cardio_svm": 2}
          and cal_rep["recoveries"] == 1,
          f"sharded pool, calibrated: {cal_rep['calibrations']}, "
          f"{cal_rep['recoveries']} recoveries")
    cal_batches = engine_batches(
        np, cal_rep["batch_sizes"]["cardio_svm"]["ladder"], cal_wl)
    shard_check("sharded pool calibrated instance 0 (before the loss)",
                cal[0], pool_mesh, cal_batches, exact=False)
    shard_check("sharded pool calibrated instance 1 (after the loss)",
                cal[1], make_mesh((1,), ("data",), devices=[dev]),
                cal_batches, exact=False)
    check(exhausted is not None and "exhausted" in exhausted,
          f"sharded pool: losing the last entry gave {exhausted!r}")
    print(f"  sharded pool [cuda:0, cuda:0]: mesh {live_mesh.shape} before "
          f"the loss at launch 1, {fo_rep['devices']} after it, "
          f"{fo_rep['recoveries']} recovery, every response == the plain "
          f"route's; calibrated cardio_svm (D={len(cal_designs)}): "
          f"calibrations {cal_rep['calibrations']}, requests 0-{first - 1} "
          f"== instance 0, the rest == instance 1; last entry: {exhausted}")
    for name in ("adc_quantize_population", "qmlp_mlp_bank",
                 "qmlp_svm_bank", "mc_adc_eval_population",
                 "mc_adc_eval_cal_population"):
        check(launches[name] > 0, f"sharded: {name} never launched")
    print(f"  sharded: launches on this path {launches}; path "
          f"{path_s:.2f} s on {card}")

    # -- timings, after the count: a generation and a bank call, in turns
    cfg = configs["mlp"][0]
    g16 = (rng.random((cfg.pop_size, search.genome_len(sizes[0],
                                                       cfg.bits)))
           < 0.5).astype(np.uint8)
    runs = {"batched": lambda: search.evaluate_population(g16, dd, sizes,
                                                          cfg),
            "sharded [cuda:0]": lambda: search.evaluate_population_sharded(
                g16, dd, sizes, cfg, meshes["[cuda:0]"]),
            "sharded [cuda:0, cuda:0]": lambda: (
                search.evaluate_population_sharded(g16, dd, sizes, cfg,
                                                   two))}
    gen_s = {k: [] for k in runs}
    for k in list(runs) + list(reversed(runs)):
        t0 = time.perf_counter()
        runs[k]()
        torch.cuda.synchronize()
        gen_s[k].append(time.perf_counter() - t0)
    for kind in ("mlp", "svm"):
        shard_check(f"make_bank_fn timing {kind} front x2",
                    fronts[kind][0] * 2, two, [("serve batch", x_serve)])
    xb = torch.from_numpy(x_serve).to(dev)
    bank_ms = {}
    for kind in ("mlp", "svm"):
        designs_k = fronts[kind][0]
        wide = designs_k * 2                      # D even: two shards
        for label, front in (("front", designs_k), ("front x2", wide)):
            plain_fn = deploy.make_bank_fn(front, device=dev)
            shard_fn = deploy.make_bank_fn(front, mesh=two)
            bank_ms[f"{kind} {label} D={len(front)}"] = {
                "unsharded": cuda_ms(torch, lambda: plain_fn(xb)),
                "[cuda:0, cuda:0]": cuda_ms(torch, lambda: shard_fn(xb))}
    for k, v in gen_s.items():
        print(f"  generation pop={cfg.pop_size} steps={cfg.train_steps} "
              f"MLP, {k}: {' / '.join(f'{s:.3f}' for s in v)} s on {card}")
    for k, v in bank_ms.items():
        print(f"  make_bank_fn call at the serve batch (M=1024) {k}: "
              f"unsharded {v['unsharded'] * 1e3:.2f} us, mesh "
              f"[cuda:0, cuda:0] {v['[cuda:0, cuda:0]'] * 1e3:.2f} us on "
              f"{card}")
    wall = time.perf_counter() - t_phase
    print(f"  phase sharded: {wall:.2f} s on {card}")
    return {"launches": launches, "per_eval": {
                k: dict(v, rule=None if v["rule"] is None
                        else list(v["rule"])) for k, v in per_eval.items()},
            "generation_s": gen_s, "bank_call_ms": bank_ms,
            "search_s": search_s, "path_s": path_s, "wall_s": wall,
            "max_err": max_err}


def visible_pairs(qpos, kpos, *, causal, window) -> int:
    """(query, key) pairs these positions leave unmasked, per (b, h)."""
    qp = qpos.long()[:, None]
    kp = kpos.long()[None, :]
    ok = kp >= 0
    if causal:
        ok = ok & (qp - kp >= 0)
    if window:
        ok = ok & (qp - kp < window)
    return int(ok.sum())


def flash_bound(torch, q, k, qpos, kpos, *, causal, window, clock):
    """(bound_ms, bound_by, bytes, flops, floors) of one attention call,
    the largest of three times: q, k, v and positions read once and the
    output written once, against HBM; 2 flops per multiply-add of q.k and
    of p.v over the (query, key) pairs these positions leave unmasked,
    against the peak of the inputs' type (bf16 tensor cores, or float32
    outside them); one exponential per such pair on the special-function
    units, EX2_PER_SM_PER_CLOCK a clock on each SM at ``clock`` (Hz,
    source, SM count). ``floors`` names each time. The FLOPs and bytes
    are launch/analysis.attention_fwd_cost's, the dry run's unit count."""
    pairs = visible_pairs(qpos, kpos, causal=causal, window=window)
    b, s, h, dh = q.shape
    flops, nbytes = (int(x) for x in port_analysis().attention_fwd_cost(
        b, s, k.shape[1], h, k.shape[2], dh, q.element_size(), pairs))
    from repro_torch.perf import cost_model
    card = cost_model.machine_model("cuda")     # the H100 data sheet's row
    rate = bf16_peak() if q.dtype == torch.bfloat16 else card.peak_flops
    hz, _, sms = clock
    floors = {"hbm": nbytes / card.hbm_bw * 1e3,
              "tensor_cores" if q.dtype == torch.bfloat16 else "cuda_cores":
                  flops / rate * 1e3,
              "ex2": b * h * pairs / (sms * EX2_PER_SM_PER_CLOCK * hz) * 1e3}
    unit = max(floors, key=floors.get)
    return (floors[unit], "bytes" if unit == "hbm" else "operations",
            nbytes, flops, dict(floors, binding=unit))


def flash_inputs(torch, gen, dev, b, s, sk, h, kv, dh, dt):
    """q, k ~ N(0, FLASH_QK_STD^2) and v ~ N(1, 1), in dt: the scores'
    standard deviation is FLASH_QK_STD^2 at any dh, so the softmax is
    peaked (a few keys carry each row) and the outputs are O(1), where a
    wrong key, tile or head moves them by O(1)."""
    q = torch.randn((b, s, h, dh), generator=gen, device=dev) * FLASH_QK_STD
    k = torch.randn((b, sk, kv, dh), generator=gen, device=dev) \
        * FLASH_QK_STD
    v = torch.randn((b, sk, kv, dh), generator=gen, device=dev) + 1.0
    return q.to(dt), k.to(dt), v.to(dt)


def limit_share(got, want, tol) -> float:
    """Largest |got - want| / (atol + rtol |want|): the share of the
    allclose limit used (above 1 fails)."""
    w = want.float()
    return float(((got.float() - w).abs()
                  / (tol["atol"] + tol["rtol"] * w.abs())).max())


def flash_controls(torch, ref, made) -> None:
    """The bf16 tolerance must reject the faults a kernel could make:
    the plain version with one kv tile of 64 keys dropped (keys 1024..1087
    masked), and with each query head reading the wrong kv head (the next
    head for musicgen's H = KV; h % KV in place of h // (H / KV) under
    gemma2's GQA), against the sound plain version. p left unrounded
    before P.V (the plain version on float32 copies, rounded to bf16 at
    the end) is printed: a rounding the limit is not meant to see."""
    def rejected(label, bad, want, strict=True):
        tol = FLASH_BF16_TOL
        err = float((bad.float() - want.float()).abs().max())
        fails = not torch.allclose(bad.float(), want.float(), **tol)
        print(f"  control {label}: max_abs_err {err:.3e} "
              f"({limit_share(bad, want, tol):.2f} of the limit): "
              f"{'rejected' if fails else 'not rejected'}")
        if strict:
            check(fails, f"the bf16 tolerance does not reject {label} "
                         f"({err:.3e})")

    for label in ("musicgen prefill B=4 S=2048 H=KV=24 dh=64",
                  "gemma2 widths H=8 KV=4 dh=256 win=1024 cap=50 S=4096"):
        q, k, v, qpos, kpos, kw = made[label]
        want = ref.flash_attention_ref(q, k, v, qpos, kpos, **kw)
        short = label.split()[0]
        drop = kpos.clone()
        drop[1024:1088] = -1
        rejected(f"{short}, one kv tile dropped",
                 ref.flash_attention_ref(q, k, v, qpos, drop, **kw), want)
        h, kvh = q.shape[2], k.shape[2]
        if h == kvh:
            heads = (torch.arange(h, device=q.device) + 1) % kvh
        else:
            heads = torch.arange(h, device=q.device) % kvh
        kw_, vw_ = k[:, :, heads].contiguous(), v[:, :, heads].contiguous()
        rejected(f"{short}, wrong kv head",
                 ref.flash_attention_ref(q, kw_, vw_, qpos, kpos, **kw), want)
        unrounded = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                            qpos, kpos, **kw).to(q.dtype)
        rejected(f"{short}, p unrounded", unrounded, want, strict=False)
        del want, kw_, vw_, unrounded


def timed_ms(torch, fn, reps, warmup=3) -> float:
    """Mean time per call over ``reps`` back-to-back calls, CUDA events,
    after ``warmup`` calls (the attention calls are long: few reps)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_flash_kernels(np, torch, dev, card, clock):
    """The flash-attention kernels against their plain version on the
    card: the JAX package's four test shapes (f32), musicgen-medium's
    prefill (bf16 and f32), gemma2's widths with GQA, a window and a
    softcap (bf16), phi3's, kimi's and llama4's head widths (bf16, GQA,
    ragged S, one with a window), ragged S, empty key slots, fully masked
    rows and a bf16 width off the tensor-core list; each call on the route
    dispatch names, counted on that route's key. Then times at the
    musicgen (bf16: tensor cores; f32: CUDA cores), gemma2 and ragged
    shapes beside the bound and, for the causal cases,
    scaled_dot_product_attention (the yardstick only)."""
    import torch.nn.functional as F
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    f32, bf16 = torch.float32, torch.bfloat16

    def arange(n, start=0):
        return torch.arange(start, start + n, dtype=torch.int32, device=dev)

    # label: (B, S, Sk, H, KV, dh, window, softcap, dtype, qpos, kpos)
    cases = {}
    for b, s, h, kv, dh, win, cap in ((1, 64, 4, 2, 16, 0, 0.0),
                                      (2, 128, 4, 4, 32, 0, 30.0),
                                      (1, 128, 8, 2, 16, 48, 0.0),
                                      (1, 96, 2, 1, 8, 0, 0.0)):
        cases[f"jax test B={b} S={s} H={h} KV={kv} dh={dh} win={win} "
              f"cap={cap}"] = (b, s, s, h, kv, dh, win, cap, f32,
                               arange(s), arange(s))
    cases["musicgen prefill B=4 S=2048 H=KV=24 dh=64"] = (
        4, 2048, 2048, 24, 24, 64, 0, 0.0, bf16, arange(2048), arange(2048))
    cases["gemma2 widths H=8 KV=4 dh=256 win=1024 cap=50 S=4096"] = (
        1, 4096, 4096, 8, 4, 256, 1024, 50.0, bf16, arange(4096),
        arange(4096))
    cases["ragged S=Sk=2049 (musicgen widths)"] = (
        4, 2049, 2049, 24, 24, 64, 0, 0.0, bf16, arange(2049), arange(2049))
    cases["phi3 widths H=KV=32 dh=96 S=1030"] = (
        1, 1030, 1030, 32, 32, 96, 0, 0.0, bf16, arange(1030), arange(1030))
    cases["kimi widths H=64 KV=8 dh=112 win=512 S=1500"] = (
        1, 1500, 1500, 64, 8, 112, 512, 0.0, bf16, arange(1500),
        arange(1500))
    cases["llama4 widths H=40 KV=8 dh=128 S=2047"] = (
        1, 2047, 2047, 40, 8, 128, 0, 0.0, bf16, arange(2047), arange(2047))
    kp = arange(300)
    kp[::5] = -1
    cases["k_positions with -1 (every 5th) f32"] = (
        2, 300, 300, 8, 2, 64, 0, 0.0, f32, arange(300), kp)
    cases["k_positions with -1, ragged, bf16"] = (
        2, 300, 300, 8, 2, 64, 100, 0.0, bf16, arange(300), kp)
    cases["fully masked rows 0..99 (keys at 100..) f32"] = (
        2, 256, 256, 4, 4, 64, 0, 0.0, f32, arange(256), arange(256, 100))
    cases["bf16 off the tensor-core widths dh=32"] = (
        2, 200, 200, 4, 2, 32, 0, 0.0, bf16, arange(200), arange(200))

    cases["musicgen prefill B=4 S=2048 H=KV=24 dh=64 f32"] = (
        4, 2048, 2048, 24, 24, 64, 0, 0.0, f32, arange(2048), arange(2048))
    # the configs' widths in float32, on the CUDA-core route
    cases["gemma2 widths H=8 KV=4 dh=256 win=1024 cap=50 S=4096 f32"] = (
        1, 4096, 4096, 8, 4, 256, 1024, 50.0, f32, arange(4096),
        arange(4096))
    cases["phi3 widths H=KV=32 dh=96 S=1030 f32"] = (
        1, 1030, 1030, 32, 32, 96, 0, 0.0, f32, arange(1030), arange(1030))
    cases["llama4 widths H=40 KV=8 dh=128 S=2047 f32"] = (
        1, 2047, 2047, 40, 8, 128, 0, 0.0, f32, arange(2047), arange(2047))
    cases["ragged S=Sk=2049 (musicgen widths) f32"] = (
        4, 2049, 2049, 24, 24, 64, 0, 0.0, f32, arange(2049), arange(2049))

    from repro_torch.kernels import envelope
    for dh in envelope.FLASH_TC_HEAD_DIMS:
        check(fa.tc_smem_bytes(dh) == envelope.flash_tc_smem_bytes(dh),
              f"dh={dh}: the kernel asks for {fa.tc_smem_bytes(dh)} bytes of "
              f"shared memory, the envelope says "
              f"{envelope.flash_tc_smem_bytes(dh)}")
    for dh in (8, 32, 64, 96, 128, 160, 256):
        check(fa.smem_bytes(dh) == envelope.flash_smem_bytes(dh),
              f"dh={dh}: the CUDA-core kernel asks for {fa.smem_bytes(dh)} "
              f"bytes of shared memory, the envelope says "
              f"{envelope.flash_smem_bytes(dh)}")
    print(f"phase flash kernels: flash_attention_tc (tensor cores) and "
          f"flash_attention (CUDA cores) vs the plain version on the card "
          f"({card}); q, k ~ N(0, {FLASH_QK_STD}^2), v ~ N(1, 1)")
    made, max_err, routes = {}, {key: 0.0 for key in FLASH_DEVICE_NAMES}, {}
    for label, (b, s, sk, h, kv, dh, win, cap, dt, qpos, kpos) in \
            cases.items():
        q, k, v = flash_inputs(torch, gen, dev, b, s, sk, h, kv, dh, dt)
        kw = dict(causal=True, window=win, attn_softcap=cap)
        route = dispatch.resolve_flash(fa.ENTRY, q).route
        key = fa.TC_ENTRY if route == "tensor_core" else fa.ENTRY
        want_route = ("tensor_core" if dt == bf16
                      and dh in envelope.FLASH_TC_HEAD_DIMS else "cuda_core")
        check(route == want_route, f"flash {label}: route {route}, "
                                   f"expected {want_route}")
        before = dict(fa.launches)
        got = fa.flash_attention(q, k, v, qpos, kpos, **kw)
        want = ref.flash_attention_ref(q, k, v, qpos, kpos, **kw)
        torch.cuda.synchronize()
        check(fa.launches == dict(before, **{key: before[key] + 1}),
              f"flash {label}: launches {before} -> {fa.launches}, "
              f"expected one on {key}")
        tol = FLASH_F32_TOL if dt == f32 else FLASH_BF16_TOL
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"flash {label}: {tuple(got.shape)} {got.dtype} != "
              f"{tuple(want.shape)} {want.dtype}")
        check(bool(torch.isfinite(got).all()), f"flash {label}: non-finite")
        err = float((got.float() - want.float()).abs().max())
        ok = torch.allclose(got.float(), want.float(), **tol)
        if "fully masked" in label:
            ok = ok and bool((got[:, :100] == 0).all()) and bool(
                (want[:, :100] == 0).all())
        max_err[key] = max(max_err[key], err)
        seen = want.float()[want.float() != 0].abs()
        print(f"  {key:18s} {label:52s} {str(dt)[6:]:8s} "
              f"max_abs_err={err:.3e} [rtol={tol['rtol']:g}, "
              f"atol={tol['atol']:g}; {limit_share(got, want, tol):.3f} of "
              f"the limit] |out| median "
              f"{float(seen.median()):.3f} {'ok' if ok else 'MISMATCH'}")
        check(ok, f"{key} disagrees with its plain version on "
                  f"{label} (max_abs_err {err:.3e})")
        made[label] = (q, k, v, qpos, kpos, kw)
        routes[label] = key
        del got, want
    flash_controls(torch, ref, made)

    hz, hz_src, sms = clock
    print(f"  ex2 floor: {sms} SMs x {EX2_PER_SM_PER_CLOCK} a clock x "
          f"{hz / 1e6:.0f} MHz ({hz_src})")
    timings = {}
    for label in ("musicgen prefill B=4 S=2048 H=KV=24 dh=64",
                  "gemma2 widths H=8 KV=4 dh=256 win=1024 cap=50 S=4096",
                  "ragged S=Sk=2049 (musicgen widths)",
                  "llama4 widths H=40 KV=8 dh=128 S=2047",
                  "musicgen prefill B=4 S=2048 H=KV=24 dh=64 f32",
                  "gemma2 widths H=8 KV=4 dh=256 win=1024 cap=50 S=4096 f32",
                  "llama4 widths H=40 KV=8 dh=128 S=2047 f32"):
        q, k, v, qpos, kpos, kw = made[label]
        key = routes[label]
        k_fn = lambda: fa.flash_attention(q, k, v, qpos, kpos, **kw)  # noqa
        p_fn = lambda: ref.flash_attention_ref(q, k, v, qpos,  # noqa: E731
                                               kpos, **kw)
        lib_ms = lib_err = lib_kernel = None
        if not kw["window"] and not kw["attn_softcap"]:
            rep = q.shape[2] // k.shape[2]
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            l_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, enable_gqa=rep > 1)
            lib_out = l_fn().transpose(1, 2)
            lib_err = float((lib_out.float() - p_fn().float()).abs().max())
            check(lib_err < 5e-2, f"{label}: scaled_dot_product_attention "
                                  f"is not the same function ({lib_err})")
            lib_kernel = top_device_kernel(torch, l_fn)
        # plain, kernel, kernel, plain (library between): one card, turns
        p1 = timed_ms(torch, p_fn, 3, warmup=1)
        k1 = timed_ms(torch, k_fn, 20)
        if lib_err is not None:
            lib_ms = min(timed_ms(torch, l_fn, 20), timed_ms(torch, l_fn, 20))
        k2 = timed_ms(torch, k_fn, 20)
        p2 = timed_ms(torch, p_fn, 3, warmup=1)
        dev_ms = device_kernel_ms(torch, k_fn, FLASH_DEVICE_NAMES[key],
                                  reps=10)
        b_ms, b_by, nbytes, flops, floors = flash_bound(
            torch, q, k, qpos, kpos, causal=True, window=kw["window"],
            clock=clock)
        b, s, h, dh = q.shape
        row = {"kernel": key,
               "shape": {"B": b, "S": s, "Sk": k.shape[1], "H": h,
                         "KV": k.shape[2], "dh": dh, "window": kw["window"],
                         "softcap": kw["attn_softcap"],
                         "dtype": str(q.dtype)[6:]},
               "ms": min(k1, k2), "plain_ms": min(p1, p2),
               "device_ms": dev_ms, "library_ms": lib_ms,
               "library_kernel": lib_kernel,
               "library_max_abs_err": lib_err, "bound_ms": b_ms,
               "bound_by": b_by, "floors_ms": floors, "bytes": nbytes,
               "flops": flops,
               "tflop_per_s": flops / (min(k1, k2) * 1e-3) / 1e12}
        timings[label] = row
        dev_txt = ("not measured" if dev_ms is None else f"{dev_ms:.4f} ms")
        lib_txt = ("n/a" if lib_ms is None
                   else f"{lib_ms:.4f} ms (device kernel {lib_kernel})")
        print(f"  time {key} {label}: kernel {k1:.4f}/{k2:.4f} ms per call "
              f"(profiler device time {dev_txt}; "
              f"{row['tflop_per_s']:.2f} TFLOP/s), plain {p1:.3f}/{p2:.3f} "
              f"ms, scaled_dot_product_attention {lib_txt}, bound "
              f"{b_ms:.4f} ms ({floors['binding']}; hbm "
              f"{floors['hbm']:.4f}, ex2 {floors['ex2']:.4f} ms) on {card}")
    return max_err, timings


TRACE_TRIES = 3


def timed_prefill(torch, fn):
    """Two warm runs of ``fn`` (a prefill), the host clock around a
    synchronised call, then one traced with torch.profiler: (walls,
    traced wall, flash device us, flash launches, other device us, other
    device operations).

    The profiler's device records can come back short of what ran (one
    flash kernel of two went missing from a llama4-scout trace on the
    H100 while the wrapper counted both), which would leave the busy share
    over part of the work. So each traced call's forward flash launches
    are also counted by the wrappers, and a trace that holds fewer flash
    records than that is taken again, up to ``TRACE_TRIES`` times; the
    last trace is returned, and the caller's check of its count stands."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import flash_attention as fa
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    for attempt in range(1, TRACE_TRIES + 1):
        before = fa.total_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            traced_wall = time.perf_counter() - t0
        launched = fa.total_launches() - before
        flash_us = other_us = 0.0
        flash_n = other_n = 0
        for ev in prof.key_averages():
            if getattr(ev, "device_type", None) is None or not ev.count:
                continue
            if "DeviceType.CUDA" not in str(ev.device_type):
                continue
            total = getattr(ev, "self_device_time_total",
                            getattr(ev, "self_cuda_time_total", 0.0))
            if any(n in ev.key for n in FLASH_DEVICE_NAMES.values()):
                flash_us += total
                flash_n += ev.count
            else:
                other_us += total
                other_n += ev.count
        if flash_n == launched:
            break
        print(f"  trace {attempt}/{TRACE_TRIES} holds {flash_n} flash "
              f"records of the {launched} launches the wrappers counted"
              + ("; tracing again" if attempt < TRACE_TRIES else ""))
    return walls, traced_wall, flash_us, flash_n, other_us, other_n


@contextlib.contextmanager
def plain_attention(torch):
    """models.layers.attention through the kernel's plain version in
    place of the kernel, for a witness (never on the main path): the
    FlashAttention Function's forward calls the module's
    ``flash_attention``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    kernel = fa.flash_attention
    fa.flash_attention = ref.flash_attention_ref
    try:
        yield
    finally:
        fa.flash_attention = kernel


def phase_lm(np, torch, dev, card):
    """The LM serving path: musicgen-medium at its full published config
    through repro_torch.launch.serve (4 requests, prompt 2048, 16 steps),
    the launch counters at 0; then prefill == forward, decode == teacher
    forcing over a ragged 2049-long sequence, a warm prefill and a traced
    one (device busy share)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import serving, transformer
    cfg = get_config(LM["arch"])
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size)
          == (48, 1536, 24, 24, 64, 6144, 2048)
          and cfg.dtype == "bfloat16",
          f"{cfg.name} is not at its published widths")
    b, s, n_gen = LM["requests"], LM["prompt_len"], LM["gen"]
    print(f"phase lm: {cfg.name} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads, dh "
          f"{cfg.resolved_head_dim}, "
          f"{cfg.param_counts()['total'] / 1e9:.3f} B parameters, "
          f"{cfg.dtype} activations) through repro_torch.launch.serve on "
          f"cuda ({card})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    gen, info = serve.main(["--arch", LM["arch"], "--requests", str(b),
                            "--prompt-len", str(s), "--gen", str(n_gen),
                            "--device", "cuda", "--seed", "0"])
    wall = time.perf_counter() - t0
    launches = all_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  launch counters after the main path: {launches}")
    check(launches["flash_attention_tc"] == cfg.num_layers
          and launches["flash_attention"] == 0,
          f"flash kernels launched {launches['flash_attention_tc']} times "
          f"on the tensor-core route and {launches['flash_attention']} on "
          f"the CUDA-core route in the main path, expected "
          f"{cfg.num_layers} (one per layer of the prefill) and 0")
    check(info["prefill_flash_launches"] == cfg.num_layers
          and info["decode_flash_launches"] == 0,
          f"launches by phase: prefill {info['prefill_flash_launches']}, "
          f"decode {info['decode_flash_launches']}")
    check(gen.shape == (b, n_gen), f"generated {gen.shape}")
    check(len(info["logits"]) == n_gen + 1 and all(
        lg.shape == (b, cfg.vocab_size) and np.isfinite(lg).all()
        for lg in info["logits"]), "logits not finite or misshapen")
    print(f"  serve.main: {b} x {s} prefill in {info['prefill_s']:.3f} s "
          f"({info['prefill_tokens_per_s']:.0f} tokens/s, first call), "
          f"{n_gen} decode steps in {info['decode_s']:.3f} s "
          f"({info['decode_ms_per_token']:.2f} ms/token), whole call "
          f"{wall:.2f} s (init included), peak {peak_gb:.2f} GB on {card}")

    # the same weights (the port's seeded init) for the checks
    params = transformer.init_params(cfg, seed=0, device=dev)
    batch = serve.make_batch(cfg, b, s, rng=np.random.default_rng(0),
                             device=dev)
    pre, _ = serving.prefill(params, batch, cfg)
    full = transformer.logits_fn(params, batch, cfg)[:, -1]
    err_c = float((pre - full).abs().max())
    same = float(np.abs(pre.cpu().numpy() - info["logits"][0]).max())
    print(f"  (c) prefill last-position logits vs logits_fn: max_abs_err "
          f"{err_c:.3e} [rtol=atol=2e-2]; vs serve.main's prefill "
          f"{same:.3e}")
    check(torch.allclose(pre, full, rtol=2e-2, atol=2e-2),
          f"prefill != forward at full width ({err_c:.3e})")
    check(same <= 2e-2, f"re-initialised weights differ from the "
                         f"launcher's ({same:.3e})")
    ext = serve.make_batch(cfg, b, s + 1, rng=np.random.default_rng(1),
                           device=dev)
    head = {k: (t if k == "adc_mask" else t[:, :s]) for k, t in ext.items()}
    tail = {k: (t if k == "adc_mask" else t[:, s:]) for k, t in ext.items()}
    # (d) decode == teacher forcing at full width and depth, in float32
    # activations (where a cache fault cannot hide in rounding) and in the
    # served bf16. Witnesses that the bf16 gap is rounding: each bf16
    # path's distance from the float32 forward (the truth), and the bf16
    # forward with the plain attention in place of the kernel. Controls:
    # the same decode with each layer reading the next layer's cache, and
    # with one 64-slot tile of every layer's cache zeroed, must fail.
    # The float32 serving path (prefill, then one decode step, through
    # models.serving): the CUDA-core route, counted from 0.
    c32 = cfg.replace(dtype="float32")
    reset_all_launches()
    _, cache = serving.prefill(params, head, c32, extra_slots=1)
    got32, _ = serving.decode_step(params, tail, cache, c32)
    torch.cuda.synchronize()
    launches_f32 = all_launches()
    print(f"  path lm_f32 (prefill over {s} + one decode step, float32 "
          f"activations): launch counters {launches_f32}")
    check(launches_f32["flash_attention"] == cfg.num_layers
          and launches_f32["flash_attention_tc"] == 0,
          f"float32 serving launched {launches_f32}, expected "
          f"{cfg.num_layers} CUDA-core launches and none on the tensor "
          f"cores")
    want32 = transformer.logits_fn(params, ext, c32)[:, -1]
    del cache
    _, cache = serving.prefill(params, head, cfg, extra_slots=1)
    clean = {k: t.clone() for k, t in cache.items()}
    got16, _ = serving.decode_step(params, tail, cache, cfg)
    want16 = transformer.logits_fn(params, ext, cfg)[:, -1]
    with plain_attention(torch):
        want16_plain = transformer.logits_fn(params, ext, cfg)[:, -1]
    controls = {}
    for label, edit in (
            ("each layer reads the next layer's cache",
             lambda t: torch.roll(t, 1, dims=0)),
            ("cache slots 1024..1087 zeroed",
             lambda t: t.index_fill(2, torch.arange(1024, 1088,
                                                    device=dev), 0))):
        bad = dict(clean, k=edit(clean["k"]), v=edit(clean["v"]),
                   kpos=clean["kpos"].clone())
        controls[label] = float(
            (serving.decode_step(params, tail, bad, cfg)[0] - want16)
            .abs().max())
        del bad
    del cache, clean

    def dist(a, b_):
        return float((a - b_).abs().max())

    errs = {"float32": dist(got32, want32), cfg.dtype: dist(got16, want16)}
    wit = {"bf16 decode vs float32 forward": dist(got16, want32),
           "bf16 forward vs float32 forward": dist(want16, want32),
           "bf16 forward, plain attention, vs float32 forward":
               dist(want16_plain, want32),
           "bf16 decode vs bf16 forward with plain attention":
               dist(got16, want16_plain)}
    print(f"  (d) decode after prefill(extra_slots=1) vs forward over "
          f"S+1={s + 1} (ragged), last-position logits (float32 forward: "
          f"std {float(want32.std()):.3f}, max |.| "
          f"{float(want32.abs().max()):.3f}):")
    print(f"      float32 activations: max_abs_err {errs['float32']:.3e} "
          f"[rtol=atol={LM_TEACHER_F32_TOL:g}]")
    print(f"      {cfg.dtype} activations: max_abs_err {errs[cfg.dtype]:.3e} "
          f"[atol={LM_TEACHER_BF16_ATOL:g}]")
    for label, val in wit.items():
        print(f"      witness, {label}: {val:.3e}")
    for label, val in controls.items():
        verdict = ("rejected" if val > LM_TEACHER_BF16_ATOL
                   else "not rejected")
        print(f"      control, {label}: {val:.3e} ({verdict})")
    check(torch.allclose(got32, want32, rtol=LM_TEACHER_F32_TOL,
                         atol=LM_TEACHER_F32_TOL),
          f"decode != teacher forcing at full width in float32 "
          f"({errs['float32']:.3e})")
    check(errs[cfg.dtype] <= LM_TEACHER_BF16_ATOL,
          f"decode != teacher forcing at full width in {cfg.dtype} "
          f"({errs[cfg.dtype]:.3e})")
    check(all(val > LM_TEACHER_BF16_ATOL for val in controls.values()),
          f"the {cfg.dtype} limit does not reject a cache fault: {controls}")
    err_d = errs["float32"]
    del full, got32, want32, got16, want16, want16_plain

    walls, traced_wall, flash_us, flash_n, other_us, other_n = \
        timed_prefill(torch, lambda: serving.prefill(params, batch, cfg))
    busy = (flash_us + other_us) / 1e6 / traced_wall
    warm = min(walls)
    # the float32 prefill (the lm_f32 path, 48 CUDA-core launches)
    w32, tw32, f32_us, f32_n, o32_us, o32_n = timed_prefill(
        torch, lambda: serving.prefill(params, batch, c32))
    base_ms = BASELINE_CUDA_CORE_MS * cfg.num_layers
    print(f"  warm float32 prefill {w32[0]:.4f}/{w32[1]:.4f} s "
          f"({b * s / min(w32):.0f} tokens/s); traced: wall {tw32:.4f} s, "
          f"flash_attention (CUDA cores) {f32_us / 1e3:.3f} ms over {f32_n} "
          f"launches ({f32_us / 1e3 / max(f32_n, 1):.3f} ms each; the "
          f"replaced kernel, the stated baseline: "
          f"{BASELINE_CUDA_CORE_MS} ms x {cfg.num_layers} = {base_ms:.1f} "
          f"ms), everything else "
          f"{o32_us / 1e3:.3f} ms over {o32_n} device operations, device "
          f"busy {(f32_us + o32_us) / 1e4 / tw32:.1f} % on {card}")
    check(f32_n == cfg.num_layers, f"the traced float32 prefill launched "
                                   f"the CUDA-core kernel {f32_n} times")

    # warm decode: 16 steps after a fresh prefill (the launcher's loop, no
    # sampling), then one traced step
    _, cache = serving.prefill(params, batch, cfg)
    rng = np.random.default_rng(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_gen):
        step = serve.token_to_batch(cfg, None, s + i, b, rng, device=dev)
        serving.decode_step(params, step, cache, cfg)
    torch.cuda.synchronize()
    decode_warm_ms = (time.perf_counter() - t0) / n_gen * 1e3
    step = serve.token_to_batch(cfg, None, s + n_gen, b, rng, device=dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serving.decode_step(params, step, cache, cfg)
        torch.cuda.synchronize()
        dec_wall = time.perf_counter() - t0
    dec_us, dec_n = 0.0, 0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) is None or not ev.count:
            continue
        if "DeviceType.CUDA" not in str(ev.device_type):
            continue
        dec_us += getattr(ev, "self_device_time_total",
                          getattr(ev, "self_cuda_time_total", 0.0))
        dec_n += ev.count
    del cache
    out = {"launches": launches, "launches_f32": launches_f32,
           "prefill_s_first": info["prefill_s"],
           "prefill_s_warm": walls, "prefill_tokens_per_s": b * s / warm,
           "decode_ms_per_token": info["decode_ms_per_token"],
           "decode_ms_per_token_warm": decode_warm_ms,
           "decode_traced_wall_ms": dec_wall * 1e3,
           "decode_device_ms": dec_us / 1e3, "decode_device_ops": dec_n,
           "decode_busy_share": dec_us / 1e6 / dec_wall,
           "peak_gb": peak_gb, "traced_wall_s": traced_wall,
           "flash_device_ms": flash_us / 1e3, "flash_launches_traced":
           flash_n, "other_device_ms": other_us / 1e3,
           "other_device_ops": other_n, "device_busy_share": busy,
           "f32_prefill_s_warm": w32, "f32_traced_wall_s": tw32,
           "f32_flash_device_ms": f32_us / 1e3,
           "f32_flash_launches_traced": f32_n,
           "f32_flash_baseline_ms": base_ms,
           "f32_other_device_ms": o32_us / 1e3,
           "f32_device_busy_share": (f32_us + o32_us) / 1e6 / tw32,
           "prefill_vs_forward_err": err_c, "decode_vs_teacher_err": err_d,
           "decode_vs_teacher_err_served_dtype": errs[cfg.dtype],
           "decode_vs_teacher_witnesses": wit,
           "decode_vs_teacher_controls": controls}
    print(f"  warm prefill {walls[0]:.4f}/{walls[1]:.4f} s "
          f"({b * s / warm:.0f} tokens/s); traced: wall {traced_wall:.4f} s, "
          f"flash_attention {flash_us / 1e3:.3f} ms over {flash_n} launches "
          f"({flash_us / 1e3 / max(flash_n, 1):.3f} ms each), everything "
          f"else {other_us / 1e3:.3f} ms over {other_n} device operations, "
          f"device busy {busy * 100:.1f} % on {card}")
    print(f"  warm decode {decode_warm_ms:.2f} ms/token over {n_gen} steps; "
          f"one traced step: wall {dec_wall * 1e3:.2f} ms, device "
          f"{dec_us / 1e3:.3f} ms over {dec_n} device operations, busy "
          f"{dec_us / 1e4 / dec_wall:.1f} % on {card}")
    return out


def bwd_bound(torch, q, k, qpos, kpos, *, window, route):
    """(bound_ms, bound_by, bytes, flops, kernel_flops, floors) of one
    backward call, the larger of two times: q, k, v, dout and positions
    read once and dq, dk, dv written once, against HBM; the gradient's
    five products of dh multiply-adds per visible pair (q.k recomputed,
    do.v, and the dq, dk, dv products: 10 dh flops), against the peak of
    the inputs' type (bf16 tensor cores, or float32 outside them, TF32
    off), as ``flash_bound`` prices the forward. ``kernel_flops`` is what
    the route's kernel does (``bwd_route_products``: 12 products a pair
    on the tensor cores, 13 there at dh 256, 9 on the CUDA cores), and ``floors["design"]``
    those at the rate of the units it runs them on (the bf16 tensor-core
    peak, or the float32 CUDA-core peak): the ceiling of that design, and
    no bound. The FLOPs and bytes are launch/analysis.attention_bwd_cost's,
    the dry run's unit count."""
    from repro_torch.perf import cost_model
    card = cost_model.machine_model("cuda")
    b, s, h, dh = q.shape
    pairs = visible_pairs(qpos, kpos, causal=True, window=window)
    flops, nbytes = (int(x) for x in port_analysis().attention_bwd_cost(
        b, s, k.shape[1], h, k.shape[2], dh, q.element_size(), pairs))
    bf16 = q.dtype == torch.bfloat16
    unit = "tensor_cores" if bf16 else "cuda_cores"
    floors = {"hbm": nbytes / card.hbm_bw * 1e3,
              unit: flops / (bf16_peak() if bf16 else card.peak_flops)
              * 1e3}
    binding = max(floors, key=floors.get)
    kflops = 2 * bwd_route_products(route, dh) * dh * pairs * b * h
    floors["design"] = kflops / (bf16_peak()
                                 if route == "flash_attention_bwd_tc"
                                 else card.peak_flops) * 1e3
    return (floors[binding], "bytes" if binding == "hbm" else "operations",
            nbytes, flops, kflops, dict(floors, binding=binding))


def bwd_share(torch, got, want, dtype_name) -> float:
    """Largest |got - want| / (rtol |want| + atol max|want|) over the
    elements, BWD_TOL[dtype_name]: above 1 fails."""
    rtol, atol = BWD_TOL[dtype_name]
    w = want.float()
    lim = rtol * w.abs() + atol * float(w.abs().max())
    return float(((got.float() - w).abs() / lim).max())


def bwd_control(torch, bad, want, dtype) -> dict:
    """{dq, dk, dv: share of BWD_TOL} of a backward control: the plain
    gradient of a faulty call (``bad``) held to the sound one (``want``),
    both rounded to ``dtype`` as the kernel's output is."""
    name = str(dtype).split(".")[-1]
    return {g_name: bwd_share(torch, g.to(dtype), w.to(dtype), name)
            for g_name, g, w in zip(("dq", "dk", "dv"), bad, want)}


def bwd_control_rejected(shares) -> bool:
    """A backward control is rejected when the gate rejects it on every
    gradient (each share above 1) and by TRAIN_CONTROL_FACTOR on the
    gradient where its fault shows most (the largest share). The least
    share is no measure of a fault: a dropped key's dk and dv are zeroed,
    which caps their shares at 1 / rtol (128 in bf16)."""
    return (max(shares.values()) > TRAIN_CONTROL_FACTOR
            and min(shares.values()) > 1.0)


def control_text(shares) -> str:
    return ("dq / dk / dv " + " / ".join(f"{shares[n]:.1f}"
                                          for n in ("dq", "dk", "dv"))
            + "x the bound")


def device_sums(torch, prof):
    """({group: device us}, {group: launches}, {backward kernel name:
    device us}) of a traced window, by device kernel name: 'fwd' (row
    11's two kernels), each backward route by its counter key
    (``BWD_DEVICE_NAMES``), 'other' the rest."""
    us = {"fwd": 0.0, **{key: 0.0 for key in BWD_DEVICE_NAMES},
          "other": 0.0}
    count = dict.fromkeys(us, 0)
    by_name = {n: 0.0 for names in BWD_DEVICE_NAMES.values() for n in names}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) is None or not ev.count:
            continue
        if "DeviceType.CUDA" not in str(ev.device_type):
            continue
        total = getattr(ev, "self_device_time_total",
                        getattr(ev, "self_cuda_time_total", 0.0))
        group = "other"
        if any(n in ev.key for n in FLASH_DEVICE_NAMES.values()):
            group = "fwd"
        for key, names in BWD_DEVICE_NAMES.items():
            for n in names:
                if n in ev.key:
                    group = key
                    by_name[n] += total
        us[group] += total
        count[group] += ev.count
    return us, count, by_name


def train_bwd_kernel(np, torch, dev, card):
    """The backward's two routes against the plain autograd (in float32
    at the same inputs) on the card: musicgen-medium's per-layer shape in
    bf16 (tensor cores) and float32 (CUDA cores), GQA with a window and a
    softcap at dh 96 and 128, a short ragged S with empty key slots, and
    bf16 GQA at dh 80 (the CUDA-core kernel's bf16 instantiation);
    bitwise across two runs; two controls per dtype at musicgen's shape.
    Returns (max_abs_err by counter key, timings at musicgen's shape,
    shares): timings 'bfloat16' (tensor cores), 'float32' (CUDA cores)
    and 'bfloat16 cuda_core' (the CUDA-core kernel called directly on the
    bf16 inputs, for the comparison only)."""
    from repro_torch.kernels import envelope
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    for dh in (16, 64, 96, 128):
        for p in range(3):
            check(fa.bwd_smem_bytes(p, dh)
                  == envelope.flash_bwd_smem_bytes(p, dh),
                  f"dh={dh}: backward pass {p} asks for "
                  f"{fa.bwd_smem_bytes(p, dh)} bytes of shared memory, the "
                  f"envelope says {envelope.flash_bwd_smem_bytes(p, dh)}")
    for dh in envelope.FLASH_BWD_TC_HEAD_DIMS:
        for p in range(3):
            check(fa.bwd_tc_smem_bytes(p, dh)
                  == envelope.flash_bwd_tc_smem_bytes(p, dh),
                  f"dh={dh}: tensor-core backward pass {p} asks for "
                  f"{fa.bwd_tc_smem_bytes(p, dh)} bytes of shared memory, "
                  f"the envelope says "
                  f"{envelope.flash_bwd_tc_smem_bytes(p, dh)}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2027)
    f32, bf16 = torch.float32, torch.bfloat16
    keys = {"tensor_core": "flash_attention_bwd_tc",
            "cuda_core": "flash_attention_bwd"}

    def arange(n):
        return torch.arange(n, dtype=torch.int32, device=dev)

    kp_ragged = arange(77)
    kp_ragged[::6] = -1
    # label: (B, S, H, KV, dh, window, softcap, dtype, kpos or None)
    cases = {}
    for dt in (bf16, f32):
        tag = str(dt)[6:]
        cases[f"musicgen layer B=4 S=2048 H=KV=24 dh=64 {tag}"] = (
            4, 2048, 24, 24, 64, 0, 0.0, dt, None)
        cases[f"GQA H=32 KV=8 dh=96 win=256 cap=30 S=1030 {tag}"] = (
            2, 1030, 32, 8, 96, 256, 30.0, dt, None)
        cases[f"GQA H=40 KV=8 dh=128 win=512 cap=50 S=777 {tag}"] = (
            1, 777, 40, 8, 128, 512, 50.0, dt, None)
        cases[f"ragged S=77 H=8 KV=2 dh=64, empty key slots {tag}"] = (
            3, 77, 8, 2, 64, 0, 0.0, dt, kp_ragged)
    cases["GQA H=16 KV=4 dh=80 win=300 cap=20 S=900 bfloat16"] = (
        2, 900, 16, 4, 80, 300, 20.0, bf16, None)
    print(f"phase train (1/4): the attention backward's two routes vs the "
          f"plain autograd (float32 at the same inputs, TF32 off) on the "
          f"card ({card}); q, k ~ N(0, {FLASH_QK_STD}^2), v ~ N(1, 1), "
          f"dout ~ N(0, 1); bound |got - want| <= rtol |want| + atol "
          f"max|want|, {BWD_TOL}")
    max_err, made, shares = dict.fromkeys(keys.values(), 0.0), {}, {}
    for label, (b, s, h, kv, dh, win, cap, dt, kpos) in cases.items():
        q, k, v = flash_inputs(torch, gen, dev, b, s, s, h, kv, dh, dt)
        do = torch.randn((b, s, h, dh), generator=gen, device=dev).to(dt)
        qpos = arange(s)
        kpos = qpos if kpos is None else kpos
        kw = dict(causal=True, window=win, attn_softcap=cap)
        key = keys[envelope.flash_bwd_route(dt == bf16, dh)]
        before = dict(fa.launches)
        got = fa.flash_attention_bwd(q, k, v, do, qpos, kpos, **kw)
        again = fa.flash_attention_bwd(q, k, v, do, qpos, kpos, **kw)
        want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                           do.float(), qpos, kpos, **kw)
        torch.cuda.synchronize()
        moved = {n: c - before[n] for n, c in fa.launches.items()
                 if c != before[n]}
        check(moved == {key: 2}, f"bwd {label}: launches {moved} for 2 "
                                 f"calls, expected {{{key!r}: 2}}")
        tag = str(dt)[6:]
        row = []
        for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
            check(g.dtype == dt and g.shape == w.shape,
                  f"bwd {label}: {name} {g.dtype} {tuple(g.shape)}")
            check(bool(torch.isfinite(g).all()), f"bwd {label}: {name} "
                                                 f"not finite")
            check(torch.equal(g, a), f"bwd {label}: {name} differs between "
                                     f"two runs")
            sh = bwd_share(torch, g, w.to(dt), tag)
            err = float((g.float() - w.to(dt).float()).abs().max())
            max_err[key] = max(max_err[key], err)
            row.append(f"{name} {err:.3e} ({sh:.3f} of the bound)")
            shares[f"{label} {name}"] = sh
            check(sh <= 1.0, f"{key} disagrees with the plain autograd on "
                             f"{label}: {name} at {sh:.3f} of the bound "
                             f"(max_abs_err {err:.3e})")
        print(f"  {label:50s} [{key}] {'; '.join(row)}; two runs bitwise "
              f"equal")
        if label.startswith("musicgen"):
            made[tag] = (q, k, v, do, qpos, kw, got)
        del got, again, want

    # controls: the plain gradient with keys 1024..1087 dropped, and with
    # each query head reading the next kv head, against the sound one
    for tag, (q, k, v, do, qpos, kw, got) in made.items():
        want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                           do.float(), qpos, qpos, **kw)
        drop = qpos.clone()
        drop[1024:1088] = -1
        heads = (torch.arange(q.shape[2], device=dev) + 1) % k.shape[2]
        for label, args in (
                ("one 64-key tile dropped", (k, v, drop)),
                ("the wrong kv head", (k[:, :, heads].contiguous(),
                                       v[:, :, heads].contiguous(), qpos))):
            kk, vv, kpos = args
            bad = ref.flash_attention_bwd_ref(
                q.float(), kk.float(), vv.float(), do.float(), qpos, kpos,
                **kw)
            ctrl = bwd_control(torch, bad, want, q.dtype)
            shares[f"control {label} {tag}"] = ctrl
            print(f"  control {tag}, {label}: {control_text(ctrl)}")
            check(bwd_control_rejected(ctrl),
                  f"the {tag} bound does not reject {label} on every "
                  f"gradient and by {TRAIN_CONTROL_FACTOR:g}x on one "
                  f"({control_text(ctrl)})")
            del bad
        del want

    # timed at musicgen's shape: each route's kernel (bf16 on the CUDA
    # cores too, called directly), plain, SDPA's backward (the yardstick,
    # never called by the port). The plain versions above left gigabytes
    # in the allocator's cache; hand them back first, so the profiler's
    # own buffers find room on the card
    import torch.nn.functional as F
    torch.cuda.empty_cache()
    timings = {}
    runs = [("bfloat16", "tensor_core"), ("float32", "cuda_core"),
            ("bfloat16", "cuda_core")]
    for tag, route in runs:
        q, k, v, do, qpos, kw, _ = made[tag]
        key = keys[route]
        name = tag if (tag == "bfloat16") == (route == "tensor_core") \
            else f"{tag} {route}"
        if name == tag:                  # the route dispatch takes
            k_fn = lambda: fa.flash_attention_bwd(q, k, v, do,  # noqa
                                                  qpos, qpos, **kw)
        else:
            k_fn = lambda: fa._launch_bwd(route, q, k, v, do,  # noqa
                                          qpos, qpos, **kw)
        p_fn = lambda: ref.flash_attention_bwd_ref(  # noqa: E731
            q, k, v, do, qpos, qpos, **kw)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        with torch.enable_grad():
            lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=True)
        l_fn = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, (qt, kt, vt), dot, retain_graph=True)
        lib_kernel = top_device_kernel(torch, l_fn)
        reps = 20 if route == "tensor_core" else 10
        p1 = timed_ms(torch, p_fn, 2, warmup=1)
        k1 = timed_ms(torch, k_fn, reps)
        lib_ms = timed_ms(torch, l_fn, 10)
        k2 = timed_ms(torch, k_fn, reps)
        p2 = timed_ms(torch, p_fn, 2, warmup=1)
        by_name = device_ms_by_name(torch, k_fn, BWD_DEVICE_NAMES[key])
        passes = {pname: by_name[dname] for pname, dname
                  in zip(BWD_PASSES, BWD_DEVICE_NAMES[key])}
        dev_ms = None if None in passes.values() else sum(passes.values())
        b_ms, b_by, nbytes, flops, kflops, floors = bwd_bound(
            torch, q, k, qpos, qpos, window=kw["window"], route=key)
        b, s, h, dh = q.shape
        ms = min(k1, k2)
        timings[name] = {
            "kernel": key, "route": route,
            "shape": {"B": b, "S": s, "Sk": s, "H": h, "KV": k.shape[2],
                      "dh": dh, "window": 0, "softcap": 0.0, "dtype": tag},
            "ms": ms, "plain_ms": min(p1, p2), "device_ms": dev_ms,
            "pass_device_ms": passes,
            "library_ms": lib_ms, "library_kernel": lib_kernel,
            "bound_ms": b_ms, "bound_by": b_by, "floors_ms": floors,
            "bytes": nbytes, "flops": flops, "kernel_flops": kflops,
            "tflop_per_s": kflops / (ms * 1e-3) / 1e12}
        dev_txt = "not measured" if dev_ms is None else (
            f"{dev_ms:.4f} ms: " + ", ".join(
                f"{n_} {v_:.4f}" for n_, v_ in passes.items()))
        print(f"  time {key} musicgen layer {tag}: kernel {k1:.4f}/{k2:.4f} "
              f"ms per call (3 launches; profiler device time {dev_txt}; "
              f"{timings[name]['tflop_per_s']:.2f} TFLOP/s of its own "
              f"products), plain autograd {p1:.2f}/{p2:.2f} ms, "
              f"scaled_dot_product_attention backward {lib_ms:.4f} ms "
              f"(device kernel {lib_kernel}), bound {b_ms:.4f} ms "
              f"({floors['binding']}; "
              + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in floors.items()
                          if k_ != "binding")
              + f" ms) on {card}")
        del qt, kt, vt, dot, lib_out
    made.clear()
    return max_err, timings, shares


def train_smoke_card_vs_cpu(np, torch, dev, card):
    """The smoke configs' loss, every gradient leaf and two train steps
    on the card against the CPU, float32, TF32 off, from one init and one
    batch stream. Returns the card's launch counts."""
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.lm import LMDataConfig, SyntheticLM
    from repro_torch.models import steps, transformer
    from repro_torch.optim import adamw
    cpu = torch.device("cpu")
    tol = TRAIN_SMOKE_TOL
    print(f"phase train (2/4): smoke configs {TRAIN_SMOKE['archs']}, "
          f"float32, card against CPU (batch {TRAIN_SMOKE['batch']} x "
          f"{TRAIN_SMOKE['seq']}, {TRAIN_SMOKE['microbatches']} "
          f"microbatches, {TRAIN_SMOKE['steps']} steps)")
    reset_all_launches()
    for arch in TRAIN_SMOKE["archs"]:
        cfg = smoke_config(arch)
        host = transformer.init_params(cfg, seed=5)
        data = SyntheticLM(LMDataConfig(
            vocab_size=cfg.vocab_size, seq_len=TRAIN_SMOKE["seq"],
            global_batch=TRAIN_SMOKE["batch"],
            microbatches=TRAIN_SMOKE["microbatches"]), cfg)

        def copy(tree, device):
            return adamw.tree_map(lambda t: t.detach().clone().to(device),
                                  tree)

        grads, losses = {}, {}
        for d in (cpu, dev):
            live = adamw.tree_map(lambda t: t.requires_grad_(True),
                                  copy(host, d))
            mb = {k: (t if k == "adc_mask" else t[0])
                  for k, t in data.device_batch(0, d).items()}
            loss, _ = transformer.loss_fn(live, mb, cfg)
            loss.backward()
            losses[d.type] = float(loss.detach())
            grads[d.type] = adamw.tree_map(lambda t: t.grad.cpu(), live)
        worst = 0.0
        rtol, atol = tol["grad"]
        for g, w in zip(adamw.tree_leaves(grads["cuda"]),
                        adamw.tree_leaves(grads["cpu"])):
            worst = max(worst, float(((g - w).abs()
                                      / (atol + rtol * w.abs())).max()))
        lerr = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
        check(lerr <= tol["loss"], f"{arch} smoke loss card {losses['cuda']}"
                                   f" vs CPU {losses['cpu']}")
        check(worst <= 1.0, f"{arch} smoke gradients: {worst:.3f} of the "
                            f"bound (rtol {rtol:g}, atol {atol:g})")
        shape = ShapeConfig("smoke", TRAIN_SMOKE["seq"], TRAIN_SMOKE["batch"],
                            "train")
        step = steps.make_train_step(cfg, None, shape,
                                     microbatches=TRAIN_SMOKE["microbatches"],
                                     total_steps=10)
        states, metrics = {}, {}
        for d in (cpu, dev):
            params = copy(host, d)
            state = steps.TrainState(params, adamw.init_tree(params))
            for i in range(TRAIN_SMOKE["steps"]):
                state, m = step(state, data.device_batch(i, d), i)
                metrics.setdefault(d.type, []).append(
                    {k: float(t) for k, t in m.items()})
            states[d.type] = state
        for mc, mh in zip(metrics["cuda"], metrics["cpu"]):
            for key in ("loss", "lr", "grad_norm"):
                check(abs(mc[key] - mh[key]) <= tol["metrics"] * abs(mh[key]),
                      f"{arch} smoke step {key}: card {mc[key]} vs CPU "
                      f"{mh[key]}")
        perr = max(float((a.cpu() - b_).abs().max()) for a, b_ in zip(
            adamw.tree_leaves(states["cuda"].params),
            adamw.tree_leaves(states["cpu"].params)))
        check(perr <= tol["params"], f"{arch} smoke params after "
                                     f"{TRAIN_SMOKE['steps']} steps: "
                                     f"max_abs_err {perr:.3e}")
        print(f"  {cfg.name}: loss card {losses['cuda']:.6f} CPU "
              f"{losses['cpu']:.6f} (rel {lerr:.2e}, bound "
              f"{tol['loss']:g}); {len(adamw.tree_leaves(host))} gradient "
              f"leaves at {worst:.3f} of the bound (rtol {rtol:g}, atol "
              f"{atol:g}); {TRAIN_SMOKE['steps']} train steps: loss "
              f"{[round(m['loss'], 6) for m in metrics['cuda']]} vs "
              f"{[round(m['loss'], 6) for m in metrics['cpu']]}, grad_norm "
              f"{[round(m['grad_norm'], 6) for m in metrics['cuda']]} vs "
              f"{[round(m['grad_norm'], 6) for m in metrics['cpu']]}, "
              f"params max_abs_err {perr:.2e} [{tol['params']:g}]")
    launches = all_launches()
    check(launches["flash_attention_bwd"] > 0 and launches["flash_attention"]
          > 0, f"the smoke training on the card launched {launches}")
    return launches


def train_launcher_recovery(np, torch, card):
    """repro_torch.launch.train.main on the card at smoke size, twice:
    uninterrupted, and with one failure injected through
    run_with_recovery; the final checkpoints must be bitwise equal."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed import fault
    from repro_torch.launch import train
    c = TRAIN_CLI
    argv = ["--arch", "musicgen-medium", "--smoke", "--steps",
            str(c["steps"]), "--batch", str(c["batch"]), "--seq",
            str(c["seq"]), "--ckpt-every", str(c["ckpt_every"]),
            "--log-every", str(c["steps"]), "--device", "cuda"]
    print(f"phase train (3/4): repro_torch.launch.train.main "
          f"{' '.join(argv)} on {card}, uninterrupted and with a failure "
          f"injected at step {c['fail_at']}")
    plain = fault.run_with_recovery
    infos = []

    def with_failure(*args, **kwargs):
        fired = []

        def inject(step):
            if step == c["fail_at"] and not fired:
                fired.append(step)
                return True
            return False
        state, info = plain(*args, inject_failure=inject, **kwargs)
        infos.append(info)
        return state, info

    with tempfile.TemporaryDirectory() as tmp:
        reset_all_launches()
        clean = train.main(argv + ["--ckpt-dir", f"{tmp}/clean"])
        fault.run_with_recovery = with_failure
        try:
            failed = train.main(argv + ["--ckpt-dir", f"{tmp}/failed"])
        finally:
            fault.run_with_recovery = plain
        launches = all_launches()
        check(infos and infos[0]["failures"] == 1
              and infos[0]["final_step"] == c["steps"],
              f"the injected failure was not recovered: {infos}")
        a = CheckpointManager(f"{tmp}/clean").restore_flat(c["steps"])
        b = CheckpointManager(f"{tmp}/failed").restore_flat(c["steps"])
        check(set(a) == set(b) and all(np.array_equal(a[k], b[k])
                                       for k in a),
              "the recovered run's final state differs from the "
              "uninterrupted run's")
    check(np.allclose(clean[-1], failed[-1], rtol=0, atol=0),
          f"final losses {clean[-1]} vs {failed[-1]}")
    print(f"  loss {clean[0]:.4f} -> {clean[-1]:.4f}; recovered run "
          f"{infos[0]}: its {len(a)} checkpoint leaves at step "
          f"{c['steps']} equal the uninterrupted run's bitwise; launches "
          f"{launches}")
    return launches


def phase_train(np, torch, dev, card):
    """The LM training path (ROADMAP A11, dense and audio families)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import train
    from repro_torch.models import steps
    max_err, bwd_timings, shares = train_bwd_kernel(np, torch, dev, card)
    smoke_launches = train_smoke_card_vs_cpu(np, torch, dev, card)
    cli_launches = train_launcher_recovery(np, torch, card)

    c = TRAIN
    cfg, mesh, train_step, data = train.build(
        c["arch"], smoke=False, seq=c["seq"], batch=c["batch"],
        microbatches=c["microbatches"], steps_total=100, device="cuda")
    check_musicgen(cfg)
    n_params = cfg.param_counts()["total"]
    tokens = c["batch"] * c["seq"]
    print(f"phase train (4/4): {cfg.name} at its published config "
          f"({n_params:,} parameters, {cfg.dtype} activations, float32 "
          f"params and AdamW state, remat={cfg.remat}) through "
          f"launch.train.build -> steps.init_state -> make_train_step on "
          f"cuda: batch {c['batch']} x {c['seq']} in {c['microbatches']} "
          f"microbatches, {c['steps']} steps ({card})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = steps.init_state(cfg, seed=0, mesh=mesh)
    snap = {"front_proj": state.params["front_proj"].clone(),
            "layers/wi[0]": state.params["layers"]["wi"][0].clone()}
    reset_all_launches()
    losses, norms, walls = [], [], []
    for i in range(c["steps"]):
        batch = data.device_batch(i, mesh.first_device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, batch, i)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        walls.append(time.perf_counter() - t0)
        print(f"  step {i}: loss {losses[-1]:.4f} grad_norm {norms[-1]:.4f} "
              f"lr {float(m['lr']):.3e} {walls[-1]:.3f} s", flush=True)
    launches = all_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = cfg.num_layers * c["microbatches"]
    check(launches["flash_attention_tc"] == 2 * per_step * c["steps"]
          and launches["flash_attention_bwd_tc"] == per_step * c["steps"]
          and launches["flash_attention"] == 0
          and launches["flash_attention_bwd"] == 0,
          f"the full-width steps launched {launches}; expected "
          f"{2 * per_step} tensor-core forwards (forward and remat) and "
          f"{per_step} tensor-core backwards a step, no CUDA-core forward "
          f"or backward")
    check(abs(losses[0] - np.log(cfg.vocab_size)) <= 1.5,
          f"initial loss {losses[0]:.4f} is not within 1.5 of ln "
          f"{cfg.vocab_size} = {np.log(cfg.vocab_size):.4f}")
    check(np.isfinite(losses).all() and np.isfinite(norms).all(),
          f"non-finite loss or grad norm: {losses} {norms}")
    for key, before in snap.items():
        now = (state.params["front_proj"] if key == "front_proj"
               else state.params["layers"]["wi"][0])
        check(not torch.equal(before, now), f"{key} did not change")
    del snap
    warm = min(walls[1:])
    # one traced step
    batch = data.device_batch(c["steps"], mesh.first_device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = train_step(state, batch, c["steps"])
        float(m["loss"])
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    us, count, by_name = device_sums(torch, prof)
    # each tensor-core pass's device ms a call at the microbatch's shape
    # (musicgen's layer), in the step
    step_passes = {p: by_name[n] / 1e3 / per_step for p, n in zip(
        BWD_PASSES, BWD_DEVICE_NAMES["flash_attention_bwd_tc"])}
    fwd_us, other_us, other_n = us["fwd"], us["other"], count["other"]
    bwd_us = us["flash_attention_bwd_tc"]
    # the profiler's names agree with the counters: three tensor-core
    # backward kernels a call, none of the CUDA-core route
    check(count["flash_attention_bwd_tc"] == 3 * per_step
          and count["flash_attention_bwd"] == 0,
          f"the traced step ran {count['flash_attention_bwd_tc']} "
          f"tensor-core and {count['flash_attention_bwd']} CUDA-core "
          f"backward kernels; expected {3 * per_step} and 0")
    busy = sum(us.values()) / 1e6 / traced_wall
    share = 6 * n_params * tokens / warm / bf16_peak()
    sdpa = bwd_timings["bfloat16"]["library_ms"] * per_step
    out = {"launches": launches, "launches_smoke": smoke_launches,
           "launches_cli": cli_launches, "losses": losses,
           "grad_norms": norms, "step_s": walls, "warm_step_s": warm,
           "tokens_per_s": tokens / warm, "bf16_peak_share": share,
           "peak_gb": peak_gb, "traced_wall_s": traced_wall,
           "device_busy_share": busy, "flash_fwd_device_ms": fwd_us / 1e3,
           "flash_bwd_device_ms": bwd_us / 1e3,
           "flash_bwd_pass_device_ms_per_call": step_passes,
           "other_device_ms": other_us / 1e3, "other_device_ops": other_n,
           "sdpa_bwd_yardstick_ms_per_step": sdpa, "params": n_params,
           "bwd_max_abs_err": max_err, "bwd_shares": shares}
    print(f"  warm {warm:.3f} s/step ({tokens / warm:.0f} tokens/s; "
          f"6 N tokens / step time = {share * 100:.1f} % of the bf16 dense "
          f"peak), peak memory {peak_gb:.2f} GB; traced step: wall "
          f"{traced_wall:.3f} s, device busy {busy * 100:.1f} %, row 11's "
          f"forward (tensor cores, {2 * per_step} launches) "
          f"{fwd_us / 1e3:.1f} ms, flash_attention_bwd_tc ({per_step} calls, "
          f"{count['flash_attention_bwd_tc']} kernels) "
          f"{bwd_us / 1e3:.1f} ms (a call: "
          + ", ".join(f"{p} {v:.4f}" for p, v in step_passes.items())
          + f" ms), everything else {other_us / 1e3:.1f} ms "
          f"over {other_n} device operations; scaled_dot_product_attention's"
          f" backward at the same shape would take {sdpa:.1f} ms a step "
          f"(yardstick only) on {card}")
    del state, data, train_step
    torch.cuda.empty_cache()
    return out, max_err, bwd_timings


# ------------------------------------------------------------------ moe
@contextlib.contextmanager
def recorded_moe(calls):
    """models.moe.moe_ffn / moe_ffn_decode, as the moe layers call them,
    each call's (kind, input, routed output, params, MoEConfig) appended
    to ``calls``; the outputs are the calls' own."""
    from repro_torch.models import moe
    ffn, dec = moe.moe_ffn, moe.moe_ffn_decode

    def rec_ffn(x, params, m, **kw):
        y, aux = ffn(x, params, m, **kw)
        calls.append(("prefill", x.detach().clone(), y.detach().clone(),
                      params, m))
        return y, aux

    def rec_dec(x, params, m):
        y = dec(x, params, m)
        calls.append(("decode", x.detach().clone(), y.detach().clone(),
                      params, m))
        return y

    moe.moe_ffn, moe.moe_ffn_decode = rec_ffn, rec_dec
    try:
        yield
    finally:
        moe.moe_ffn, moe.moe_ffn_decode = ffn, dec


def moe_direct(torch, x, params, m, cap):
    """The float32 routing of x (T, D) written directly: the router
    product, softmax, the k largest probabilities (the lower expert first
    on ties), the gates over their sum; pair (t, j) kept while fewer than
    cap earlier pairs (in t k + j order) chose its expert. Returns (ids,
    gate, keep), each (T, k), and ``out(rows, swap=None)``: float32 sum
    over kept pairs of gate * SwiGLU_e(x_t) for the rows, with swap = (n,
    j) routing row n's pair j to the next expert (the control)."""
    import torch.nn.functional as F
    t = x.shape[0]
    k, e = m.top_k, m.num_experts
    probs = torch.softmax(x.float() @ params["router"].float(), dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    ids = ids[:, :k]
    gate = vals[:, :k] / vals[:, :k].sum(-1, keepdim=True).clamp(min=1e-9)
    hot = F.one_hot(ids.reshape(-1), e)
    earlier = (hot.cumsum(0) - hot).gather(1, ids.reshape(-1, 1))
    keep = (earlier[:, 0] < cap).reshape(t, k)

    def out(rows, swap=None):
        y = torch.zeros((len(rows), x.shape[1]), dtype=torch.float32,
                        device=x.device)
        for n, row in enumerate(rows):
            xt = x[row].float()
            for j in range(k):
                if not bool(keep[row, j]):
                    continue
                ex = int(ids[row, j])
                if swap == (n, j):
                    ex = (ex + 1) % e
                h = xt @ params["wi"][ex].float()
                g = xt @ params["wg"][ex].float()
                y[n] += gate[row, j] * ((F.silu(g) * h)
                                        @ params["wo"][ex].float())
        return y
    return ids, gate, keep, out


def moe_share(torch, got, want) -> float:
    """The largest ||got_t - want_t|| / ||want_t|| over rows t, over
    MOE_BF16_TOL; a row whose pairs were all dropped (want_t = 0) must be
    exactly 0 (share 0, else infinite), a non-finite row is infinite."""
    got, want = got.float(), want.float()
    err, size = (got - want).norm(dim=-1), want.norm(dim=-1)
    rel = torch.where(size > 0, err / size.clamp(min=1e-30),
                      torch.where(err == 0, 0.0, float("inf")))
    rel = torch.where(torch.isfinite(rel), rel, float("inf"))
    return float(rel.max()) / MOE_BF16_TOL


def moe_output_checks(torch, calls, n_rows):
    """Each recorded moe call's routed output against moe_direct: n_rows
    prefill tokens (those with a dropped pair first, then spread evenly)
    and every decode token; one control a call kind, the largest-gate
    kept pair of the first checked row routed to the next expert. Returns
    (worst share by kind, control share by kind, dropped pairs a call,
    calls by kind)."""
    from repro_torch.models import moe
    worst, ctrl, dropped = {}, {}, []
    kinds = {"prefill": 0, "decode": 0}
    for kind, x, y, params, m in calls:
        xf, yf = x.reshape(-1, x.shape[-1]), y.reshape(-1, y.shape[-1])
        t = xf.shape[0]
        cap = (moe.prefill_capacity(t, m) if kind == "prefill"
               else moe.decode_capacity(t, m))
        _, gate, keep, out = moe_direct(torch, xf, params, m, cap)
        kinds[kind] += 1
        dropped.append(int((~keep).sum()))
        if kind == "prefill":
            # partly dropped tokens first, then one wholly dropped
            part = torch.nonzero(~keep.all(1) & keep.any(1))[:, 0].tolist()
            whole = torch.nonzero(~keep.any(1))[:, 0].tolist()
            lossy = (part[:n_rows // 2 - 1] + whole[:1])[:n_rows // 2]
            spread = [i * t // (n_rows - len(lossy))
                      for i in range(n_rows - len(lossy))]
            rows = lossy + [r for r in spread if r not in lossy]
        else:
            rows = list(range(t))
        want = out(rows)
        share = moe_share(torch, yf[rows], want)
        worst[kind] = max(worst.get(kind, 0.0), share)
        check(bool(torch.isfinite(yf).all()), f"moe {kind}: not finite")
        check(bool(keep[rows].any()), f"moe {kind}: no checked token kept "
                                      f"a pair")
        if kind not in ctrl:
            # the checked pair whose swap moves its token most
            kept = torch.where(keep[rows], gate[rows], 0.0)
            reach = kept.max(1).values / kept.norm(dim=1).clamp(min=1e-30)
            n = int(torch.argmax(reach))
            j = int(torch.argmax(kept[n]))
            bad = out([rows[n]], swap=(0, j))
            ctrl[kind] = moe_share(torch, bad, want[n:n + 1])
    return worst, ctrl, dropped, kinds


def moe_serve(np, torch, dev, card, arch, cut):
    """One moe config at full width through launch.serve.serve, with every
    launch counter at 0; its moe outputs against moe_direct, prefill ==
    logits_fn, a warm and a traced prefill, 16 warm and one traced
    decode step."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import serving, transformer
    cfg = get_config(arch).replace(**cut)
    m = cfg.moe
    b, s, n_gen = MOE["requests"], MOE["prompt_len"], MOE["gen"]
    counts = cfg.param_counts()
    print(f"phase moe: {cfg.name} at full width, cut to {cfg.num_layers} "
          f"layers ({cut}): d_model {cfg.d_model}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads, dh {cfg.resolved_head_dim}, "
          f"{m.num_experts} experts top-{m.top_k}, d_expert {m.d_expert}, "
          f"{m.num_shared_experts} shared ({m.d_shared}), cf "
          f"{m.capacity_factor}, first_k_dense {m.first_k_dense}, vocab "
          f"{cfg.vocab_size}, {counts['total']:,} parameters "
          f"({counts['active']:,} active), {cfg.param_dtype} params, "
          f"{cfg.dtype} activations; launch.serve.serve on cuda ({card})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    calls = []
    reset_all_launches()
    with recorded_moe(calls):
        gen, info = serve.serve(cfg, params, requests=b, prompt_len=s,
                                gen=n_gen, device=dev, seed=0)
    torch.cuda.synchronize()
    launches = all_launches()
    print(f"  launch counters after the main path: {launches}")
    check(launches["flash_attention_tc"] == cfg.num_layers
          and launches["flash_attention"] == 0
          and info["prefill_flash_launches"] == cfg.num_layers,
          f"{cfg.name}: flash launches {launches}, prefill "
          f"{info['prefill_flash_launches']}; expected "
          f"{cfg.num_layers} tensor-core launches (one a layer of the "
          f"prefill, dh {cfg.resolved_head_dim}), none on the CUDA cores")
    check(gen.shape == (b, n_gen) and len(info["logits"]) == n_gen + 1
          and all(lg.shape == (b, cfg.vocab_size) and np.isfinite(lg).all()
                  for lg in info["logits"]),
          f"{cfg.name}: generated {gen.shape}; logits not finite or "
          f"misshapen")
    n_moe = cfg.num_layers - m.first_k_dense
    worst, ctrl, dropped, kinds = moe_output_checks(torch, calls,
                                                    MOE["check_tokens"])
    check(kinds == {"prefill": n_moe, "decode": n_moe * n_gen},
          f"{cfg.name}: moe calls {kinds}, expected {n_moe} prefill and "
          f"{n_moe * n_gen} decode")
    del calls
    print(f"  serve: {b} x {s} prefill {info['prefill_s']:.3f} s (first "
          f"call, {info['prefill_tokens_per_s']:.0f} tokens/s), {n_gen} "
          f"decode steps {info['decode_ms_per_token']:.2f} ms/token; init "
          f"{init_s:.2f} s")
    print(f"  moe outputs vs the float32 recomputation (same bf16 input "
          f"and weights, same capacity rule; bound ||got - want|| <= "
          f"{MOE_BF16_TOL:g} ||want|| a token): prefill "
          f"{MOE['check_tokens']} tokens a moe layer, worst share "
          f"{worst['prefill']:.3f}; decode every step's {b} tokens, worst "
          f"{worst['decode']:.3f}; control (a pair routed to the next "
          f"expert): prefill {ctrl['prefill']:.1f}x, decode "
          f"{ctrl['decode']:.1f}x the bound; dropped pairs: prefill "
          f"{dropped[:n_moe]} of {b * s * m.top_k}, decode "
          f"{sum(dropped[n_moe:])} of {n_moe * n_gen * b * m.top_k} over "
          f"{n_gen} steps")
    check(max(worst.values()) <= 1.0,
          f"{cfg.name}: moe outputs at {worst} of the bound")
    check(min(ctrl.values()) > TRAIN_CONTROL_FACTOR,
          f"{cfg.name}: the moe bound does not reject a pair routed to "
          f"another expert by {TRAIN_CONTROL_FACTOR:g}x: {ctrl}")

    batch = serve.make_batch(cfg, b, s, rng=np.random.default_rng(0),
                             device=dev)
    pre, _ = serving.prefill(params, batch, cfg)
    full = transformer.logits_fn(params, batch, cfg)[:, -1]
    err_c = float((pre - full).abs().max())
    same = float(np.abs(pre.cpu().numpy() - info["logits"][0]).max())
    print(f"  prefill last-position logits vs logits_fn: max_abs_err "
          f"{err_c:.3e} [rtol=atol=2e-2]; vs serve's prefill {same:.3e}")
    ok = torch.allclose(pre, full, rtol=2e-2, atol=2e-2)
    del full
    check(ok,
          f"{cfg.name}: prefill != forward ({err_c:.3e})")
    check(same <= 2e-2, f"{cfg.name}: a second prefill differs from "
                        f"serve's ({same:.3e})")
    walls, traced_wall, flash_us, flash_n, other_us, other_n = \
        timed_prefill(torch, lambda: serving.prefill(params, batch, cfg))
    check(flash_n == cfg.num_layers, f"{cfg.name}: the traced prefill ran "
                                     f"{flash_n} flash kernels")
    busy = (flash_us + other_us) / 1e6 / traced_wall
    _, cache = serving.prefill(params, batch, cfg, extra_slots=n_gen + 1)
    rng = np.random.default_rng(2)

    def step_batch(i):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, b)).to(dev)
        return serve.token_to_batch(cfg, tok, s + i, b, rng, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_gen):
        serving.decode_step(params, step_batch(i), cache, cfg)
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t0) / n_gen * 1e3
    nxt = step_batch(n_gen)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serving.decode_step(params, nxt, cache, cfg)
        torch.cuda.synchronize()
        dec_wall = time.perf_counter() - t0
    dec_us = sum(getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
                 for ev in prof.key_averages()
                 if "DeviceType.CUDA" in str(getattr(ev, "device_type", ""))
                 and ev.count)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    warm = min(walls)
    print(f"  warm prefill {walls[0]:.4f}/{walls[1]:.4f} s ({b * s / warm:.0f}"
          f" tokens/s); traced: wall {traced_wall:.4f} s, flash_attention_tc "
          f"(dh {cfg.resolved_head_dim}) {flash_us / 1e3:.3f} ms over "
          f"{flash_n} launches, everything else {other_us / 1e3:.3f} ms over "
          f"{other_n} device operations, device busy {busy * 100:.1f} %; "
          f"warm decode {dec_ms:.2f} ms/token, a traced step {dec_wall * 1e3:.2f}"
          f" ms wall, {dec_us / 1e3:.3f} ms device (busy "
          f"{dec_us / 1e4 / dec_wall:.1f} %); peak {peak_gb:.2f} GB on {card}")
    del params, cache, batch
    torch.cuda.empty_cache()
    return {"launches": launches, "params": counts["total"],
            "active_params": counts["active"], "init_s": init_s,
            "prefill_s_first": info["prefill_s"],
            "decode_ms_per_token_first": info["decode_ms_per_token"],
            "prefill_s_warm": walls, "prefill_tokens_per_s": b * s / warm,
            "traced_wall_s": traced_wall, "flash_device_ms": flash_us / 1e3,
            "flash_launches_traced": flash_n,
            "other_device_ms": other_us / 1e3, "other_device_ops": other_n,
            "device_busy_share": busy, "decode_ms_per_token_warm": dec_ms,
            "decode_traced_wall_ms": dec_wall * 1e3,
            "decode_device_ms": dec_us / 1e3,
            "decode_busy_share": dec_us / 1e6 / dec_wall,
            "peak_gb": peak_gb, "prefill_vs_forward_err": err_c,
            "moe_share": worst, "moe_control": ctrl, "dropped": dropped}


def moe_smoke_card_vs_cpu(np, torch, dev, card):
    """Both moe smoke configs, float32, card against CPU from one init:
    prefill and two decode steps' logits, three microbatched train steps;
    one train step replayed from a cloned state on the card, bitwise.
    Returns the card's launch counts."""
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.lm import LMDataConfig, SyntheticLM
    from repro_torch.launch import serve
    from repro_torch.models import serving, steps, transformer
    from repro_torch.optim import adamw
    c, tol = MOE_SMOKE, TRAIN_SMOKE_TOL
    cpu = torch.device("cpu")
    print(f"phase moe: smoke configs {c['archs']}, float32, card against "
          f"CPU: prefill {c['prompt']} + 2 decode steps (logits "
          f"{MOE_SMOKE_LOGITS_TOL:g}), {c['steps']} train steps (batch "
          f"{c['batch']} x {c['seq']}, {c['microbatches']} microbatches; "
          f"loss, lr, grad_norm {tol['metrics']:g}, params {tol['params']:g})"
          f", a replayed step bitwise")
    reset_all_launches()

    def copy(tree, device):
        return adamw.tree_map(lambda t: t.detach().clone().to(device), tree)

    for arch in c["archs"]:
        cfg = smoke_config(arch)
        host = transformer.init_params(cfg, seed=5)
        batch = serve.make_batch(cfg, 2, c["prompt"] + 2,
                                 rng=np.random.default_rng(3))
        logits = {}
        for where, d in (("cpu", cpu), ("card", dev)):
            params = copy(host, d)
            mb = {k: t.to(d) for k, t in batch.items()}
            part = lambda lo, hi: {k: t[:, lo:hi]  # noqa: E731
                                   for k, t in mb.items()}
            out, cache = serving.prefill(params, part(0, c["prompt"]), cfg)
            outs = [out]
            for t in range(c["prompt"], c["prompt"] + 2):
                out, cache = serving.decode_step(params, part(t, t + 1),
                                                 cache, cfg)
                outs.append(out)
            logits[where] = [o.cpu() for o in outs]
        lerr = max(float((a - b_).abs().max())
                   for a, b_ in zip(logits["card"], logits["cpu"]))
        check(lerr <= MOE_SMOKE_LOGITS_TOL * (1 + max(
            float(w.abs().max()) for w in logits["cpu"])),
              f"{arch} smoke serving: card vs CPU logits {lerr:.3e}")
        data = SyntheticLM(LMDataConfig(
            vocab_size=cfg.vocab_size, seq_len=c["seq"],
            global_batch=c["batch"], microbatches=c["microbatches"]), cfg)
        step = steps.make_train_step(
            cfg, None, ShapeConfig("smoke", c["seq"], c["batch"], "train"),
            microbatches=c["microbatches"], total_steps=10)
        states, metrics = {}, {}
        for where, d in (("cpu", cpu), ("card", dev)):
            params = copy(host, d)
            state = steps.TrainState(params, adamw.init_tree(params))
            for i in range(c["steps"]):
                state, mt = step(state, data.device_batch(i, d), i)
                metrics.setdefault(where, []).append(
                    {k: float(t) for k, t in mt.items()})
            states[where] = state
        for mc, mh in zip(metrics["card"], metrics["cpu"]):
            for key in ("loss", "lr", "grad_norm"):
                check(abs(mc[key] - mh[key]) <= tol["metrics"] * abs(mh[key]),
                      f"{arch} smoke step {key}: card {mc[key]} vs CPU "
                      f"{mh[key]}")
        perr = max(float((a.cpu() - b_).abs().max()) for a, b_ in zip(
            adamw.tree_leaves(states["card"].params),
            adamw.tree_leaves(states["cpu"].params)))
        check(perr <= tol["params"], f"{arch} smoke params after "
                                     f"{c['steps']} steps: {perr:.3e}")
        # one step replayed from a clone of the card's state
        base = states["card"]
        runs = []
        for _ in range(2):
            clone = steps.TrainState(
                copy(base.params, dev),
                adamw.OptState(base.opt.step.clone(), copy(base.opt.m, dev),
                               copy(base.opt.v, dev)))
            new, mt = step(clone, data.device_batch(c["steps"], dev),
                           c["steps"])
            runs.append(adamw.tree_leaves(new.params)
                        + adamw.tree_leaves(new.opt.m)
                        + adamw.tree_leaves(new.opt.v)
                        + [mt["loss"], mt["grad_norm"]])
        differ = sum(not torch.equal(a, b_) for a, b_ in zip(*runs))
        check(differ == 0, f"{arch} smoke: a replayed step differs in "
                           f"{differ} of {len(runs[0])} tensors")
        print(f"  {cfg.name}: serving logits card vs CPU {lerr:.2e}; loss "
              f"{[round(mm['loss'], 6) for mm in metrics['card']]} vs "
              f"{[round(mm['loss'], 6) for mm in metrics['cpu']]}, "
              f"grad_norm {[round(mm['grad_norm'], 6) for mm in metrics['card']]}"
              f" vs {[round(mm['grad_norm'], 6) for mm in metrics['cpu']]}, "
              f"params max_abs_err {perr:.2e}; a replayed step's "
              f"{len(runs[0])} tensors bitwise")
        del states, runs
    launches = all_launches()
    check(launches["flash_attention"] > 0
          and launches["flash_attention_bwd"] > 0,
          f"the moe smoke runs on the card launched {launches}")
    return launches


def moe_train(np, torch, dev, card):
    """llama4-scout at full layer width (MOE_TRAIN), trained with the
    launch counters at 0; then one full-width moe layer's forward and
    backward run twice, bitwise."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.lm import LMDataConfig, SyntheticLM
    from repro_torch.models import moe, steps, transformer
    from repro_torch.optim import adamw
    c = MOE_TRAIN
    cfg = get_config(c["arch"]).replace(**c["cut"])
    counts = cfg.param_counts()
    tokens = c["batch"] * c["seq"]
    print(f"phase moe: {cfg.name} trained at full layer width, cut "
          f"{c['cut']} ({counts['total']:,} parameters, {counts['active']:,}"
          f" active; remat {cfg.remat}): steps.init_state -> "
          f"make_train_step on cuda, batch {c['batch']} x {c['seq']} in "
          f"{c['microbatches']} microbatches, {c['steps']} steps ({card})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = steps.init_state(cfg, seed=0, device=dev)
    data = SyntheticLM(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=c["seq"], global_batch=c["batch"],
        microbatches=c["microbatches"]), cfg)
    step = steps.make_train_step(cfg, None, ShapeConfig(
        "moe", c["seq"], c["batch"], "train"),
        microbatches=c["microbatches"], total_steps=100)
    mb0 = {k: t[0] for k, t in data.device_batch(0, dev).items()}
    with torch.no_grad():
        _, m0 = transformer.loss_fn(state.params, mb0, cfg)
    aux0 = float(m0["aux"])
    del mb0, m0
    snap = {"embed": state.params["embed"][:64].clone(),
            "layers/moe/wi[0][0]": state.params["layers"]["moe"]["wi"][0, 0]
            .clone(),
            "layers/moe/router": state.params["layers"]["moe"]["router"]
            .clone()}
    reset_all_launches()
    losses, norms, walls = [], [], []
    for i in range(c["steps"]):
        batch = data.device_batch(i, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, mt = step(state, batch, i)
        losses.append(float(mt["loss"]))
        norms.append(float(mt["grad_norm"]))
        walls.append(time.perf_counter() - t0)
        print(f"  step {i}: loss {losses[-1]:.4f} grad_norm {norms[-1]:.4f} "
              f"{walls[-1]:.3f} s", flush=True)
    launches = all_launches()
    per_step = cfg.num_layers * c["microbatches"]
    check(launches["flash_attention_tc"] == 2 * per_step * c["steps"]
          and launches["flash_attention_bwd_tc"] == per_step * c["steps"]
          and launches["flash_attention"] == 0
          and launches["flash_attention_bwd"] == 0,
          f"{cfg.name} steps launched {launches}; expected {2 * per_step} "
          f"tensor-core forwards and {per_step} tensor-core backwards (dh "
          f"{cfg.resolved_head_dim}) a step, no CUDA-core route")
    check(abs(losses[0] - np.log(cfg.vocab_size)) <= 1.5,
          f"initial loss {losses[0]:.4f} is not within 1.5 of ln "
          f"{cfg.vocab_size}")
    check(np.isfinite(losses).all() and np.isfinite(norms).all()
          and np.isfinite(aux0), f"non-finite loss, grad norm or aux: "
                                 f"{losses} {norms} {aux0}")
    now = {"embed": state.params["embed"][:64],
           "layers/moe/wi[0][0]": state.params["layers"]["moe"]["wi"][0, 0],
           "layers/moe/router": state.params["layers"]["moe"]["router"]}
    for key, before in snap.items():
        check(not torch.equal(before, now[key]), f"{key} did not change")
    del snap, now
    warm = min(walls[1:])
    batch = data.device_batch(c["steps"], dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, mt = step(state, batch, c["steps"])
        float(mt["loss"])
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    us, count, by_name = device_sums(torch, prof)
    passes = {p: by_name[n] / 1e3 / per_step for p, n in zip(
        BWD_PASSES, BWD_DEVICE_NAMES["flash_attention_bwd_tc"])}
    check(count["flash_attention_bwd_tc"] == 3 * per_step
          and count["flash_attention_bwd"] == 0,
          f"the traced step ran {count['flash_attention_bwd_tc']} "
          f"tensor-core and {count['flash_attention_bwd']} CUDA-core "
          f"backward kernels; expected {3 * per_step} and 0")
    busy = sum(us.values()) / 1e6 / traced_wall
    share = 6 * counts["active"] * tokens / warm / bf16_peak()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  warm {warm:.3f} s/step ({tokens / warm:.0f} tokens/s; 6 "
          f"N_active tokens / step time = {share * 100:.2f} % of the bf16 "
          f"dense peak), aux at init {aux0:.4f}, peak memory {peak_gb:.2f} "
          f"GB; traced step: wall {traced_wall:.3f} s, device busy "
          f"{busy * 100:.1f} %, row 11's forward {us['fwd'] / 1e3:.2f} ms, "
          f"flash_attention_bwd_tc {us['flash_attention_bwd_tc'] / 1e3:.2f} "
          f"ms over {per_step} calls (a call at B 2, S 2048, H 40, KV 8, dh "
          f"128: " + ", ".join(f"{p} {v:.4f}" for p, v in passes.items())
          + f" ms), everything else {us['other'] / 1e3:.1f} ms over "
          f"{count['other']} device operations on {card}")
    params = state.params
    del state, data, batch, step
    torch.cuda.empty_cache()

    # one full-width moe layer (the trained one), forward + backward twice
    p = adamw.tree_map(lambda t: t.detach().requires_grad_(True),
                       transformer.layer(params, 0)["moe"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    x = torch.randn((c["batch"] // c["microbatches"], c["seq"], cfg.d_model),
                    generator=gen, device=dev).to(torch.bfloat16)
    x.requires_grad_(True)
    w = torch.randn(x.shape, generator=gen, device=dev)
    leaves = [x] + adamw.tree_leaves(p)
    runs = []
    for _ in range(2):
        with torch.enable_grad():
            y, aux = moe.moe_ffn(x, p, cfg.moe)
            y = y + moe.shared_ffn(x, p)
            loss = (y.float() * w).sum() + aux
            grads = torch.autograd.grad(loss, leaves)
        runs.append([y.detach(), aux.detach()] + list(grads))
    differ = [i for i, (a, b_) in enumerate(zip(*runs))
              if not torch.equal(a, b_)]
    check(not differ, f"a full-width {cfg.name} moe layer's forward + "
                      f"backward differs between two runs in tensors "
                      f"{differ}")
    print(f"  a full-width moe layer's forward + backward (x {tuple(x.shape)}"
          f" bf16; {len(runs[0])} tensors: output, aux, the gradients of x "
          f"and of every moe leaf) twice: bitwise equal")
    del params, p, x, w, runs, leaves
    torch.cuda.empty_cache()
    return {"launches": launches, "losses": losses, "grad_norms": norms,
            "aux_init": aux0, "step_s": walls, "warm_step_s": warm,
            "tokens_per_s": tokens / warm, "bf16_peak_share_active": share,
            "params": counts["total"], "active_params": counts["active"],
            "peak_gb": peak_gb, "traced_wall_s": traced_wall,
            "device_busy_share": busy, "flash_fwd_device_ms": us["fwd"] / 1e3,
            "flash_bwd_device_ms": us["flash_attention_bwd_tc"] / 1e3,
            "flash_bwd_pass_device_ms_per_call": passes,
            "other_device_ms": us["other"] / 1e3,
            "other_device_ops": count["other"]}


def phase_moe(np, torch, dev, card):
    """The moe family (ROADMAP A11.1) on the card: both published configs
    served at full width (cut in depth), llama4-scout trained at full
    layer width, the smoke configs card against CPU. Returns the main
    path's launch counts (the two serve calls and the train steps, each
    counted from 0) and the numbers."""
    t_phase = time.perf_counter()
    out = {"serve": {}}
    launches = {}
    for arch, cut in MOE_SERVE:
        res = moe_serve(np, torch, dev, card, arch, cut)
        out["serve"][arch] = {k: v for k, v in res.items()
                              if k != "launches"}
        for name, n in res["launches"].items():
            launches[name] = launches.get(name, 0) + n
    train = moe_train(np, torch, dev, card)
    for name, n in train.pop("launches").items():
        launches[name] = launches.get(name, 0) + n
    out["train"] = train
    out["smoke_launches"] = moe_smoke_card_vs_cpu(np, torch, dev, card)
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase moe: {out['phase_s']:.2f} s on {card}; launches on the "
          f"moe path: {launches}")
    return out


# ------------------------------------------------------------------ ssm
def product_split(torch, prof):
    """({group: device ms}, {group: kernels}) of a traced window (a
    torch.profiler profile taken with record_shapes=True), each device
    kernel by the CPU operation that launched it (the chrome trace's
    External id, the innermost operation): 'f32_products' and
    'bf16_products' (matrix products, ``PRODUCT_OPS``, whose first input
    is float32 / bf16: in the ssm and hybrid models every float32 product
    is the SSD's), 'attention' (rows 11 and 11b, by kernel name) and
    'rest'."""
    import json
    import os
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    ops = {}
    for ev in events:
        if ev.get("cat") == "cpu_op":
            ext = ev.get("args", {}).get("External id")
            if ext is not None:
                ops[ext] = ev
    attention = list(FLASH_DEVICE_NAMES.values()) + [
        n for names in BWD_DEVICE_NAMES.values() for n in names]
    us = dict.fromkeys(("f32_products", "bf16_products", "attention",
                        "rest"), 0.0)
    count = dict.fromkeys(us, 0)
    rest = {}
    for ev in events:
        if ev.get("cat") != "kernel":
            continue
        group = "rest"
        op = ops.get(ev.get("args", {}).get("External id"))
        if any(n in ev.get("name", "") for n in attention):
            group = "attention"
        elif op is not None and op.get("name") in PRODUCT_OPS:
            types = op.get("args", {}).get("Input type") or [""]
            if types[0] == "float":
                group = "f32_products"
            elif "BFloat16" in types[0]:
                group = "bf16_products"
        dur = float(ev.get("dur", 0.0))
        us[group] += dur
        count[group] += 1
        if group == "rest":
            name = op.get("name") if op is not None else "(no CPU op)"
            rest[name] = rest.get(name, 0.0) + dur
    ms = {k: v / 1e3 for k, v in us.items()}
    ms["rest_top_ops"] = {k: v / 1e3 for k, v in sorted(
        rest.items(), key=lambda kv_: -kv_[1])[:6]}
    return ms, count


def traced_split(torch, fn):
    """One traced call of ``fn`` (record_shapes on, for
    ``product_split``): (wall s, {group: device ms}, {group: kernels},
    device busy share)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ms, count = product_split(torch, prof)
    check(count["f32_products"] + count["bf16_products"] > 0,
          f"the trace attributes no device kernel to a matrix product: "
          f"{count}")
    return wall, ms, count, sum(ms[k] for k in count) / 1e3 / wall


def split_text(ms, count) -> str:
    return (", ".join(f"{k} {ms[k]:.2f} ms ({n} kernels)"
                      for k, n in count.items())
            + " (the rest's largest launching operations: "
            + ", ".join(f"{k} {v:.1f}" for k, v in
                        ms["rest_top_ops"].items()) + " ms)")


def check_published(cfg) -> None:
    """``cfg`` against its row of PUBLISHED, field by field."""
    want = PUBLISHED[cfg.name]
    fields = dict(
        num_layers=lambda c: c.num_layers, d_model=lambda c: c.d_model,
        vocab_size=lambda c: c.vocab_size, num_heads=lambda c: c.num_heads,
        num_kv_heads=lambda c: c.num_kv_heads,
        head_dim=lambda c: c.resolved_head_dim if c.num_heads else 0,
        window=lambda c: c.window if c.attn_type != "global" else 0,
        d_ff=lambda c: c.d_ff, attn_type=lambda c: c.attn_type,
        softcaps=lambda c: (c.attn_logit_softcap, c.final_logit_softcap),
        post_norm=lambda c: c.post_norm, tie=lambda c: c.tie_embeddings,
        mrope=lambda c: c.mrope_sections if c.mrope else None,
        theta=lambda c: c.rope_theta, frontend=lambda c: c.frontend_dim,
        adc_bits=lambda c: c.adc.bits if c.adc.enable else 0,
        state_dim=lambda c: c.ssm.state_dim,
        ssm_head_dim=lambda c: c.ssm.head_dim,
        expand=lambda c: c.ssm.expand, ngroups=lambda c: c.ssm.ngroups,
        conv_width=lambda c: c.ssm.conv_width, chunk=lambda c: c.ssm.chunk,
        params=lambda c: c.param_counts()["total"],
        dtype=lambda c: c.dtype, param_dtype=lambda c: c.param_dtype,
        opt_state_dtype=lambda c: c.opt_state_dtype,
        remat=lambda c: c.remat)
    got = {k: fields[k](cfg) for k in want}
    check(got == want, f"{cfg.name} is not at its published config: {got}"
                       f" != {want}")


def attention_layer_checks(torch, label, q, k, v, do, pos, kw):
    """Rows 11 and 11b at one model's layer (bf16, positions ``pos``, (S,),
    S > 1088) on the tensor-core routes: the forward against
    ref.flash_attention_ref (FLASH_BF16_TOL), the backward twice (bitwise)
    against ref.flash_attention_bwd_ref on float32 copies (BWD_TOL), each
    call counted once on its key and nowhere else; both limits reject
    the plain version with keys 1024..1087 dropped and with every query
    head group reading the next group's kv head, the backward's on every
    gradient and by more than TRAIN_CONTROL_FACTOR on one
    (``bwd_control_rejected``). Returns ({key: max_abs_err}, the
    forward's share of its limit, {key: controls}, the backward's
    dq/dk/dv shares)."""
    from repro_torch.kernels import dispatch, envelope
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    kv, dh = k.shape[2], q.shape[3]
    check(dispatch.resolve_flash(fa.ENTRY, q).route == "tensor_core"
          and envelope.flash_bwd_route(True, dh) == "tensor_core",
          f"{label}: not on the tensor-core routes")
    drop = pos.clone()
    drop[1024:1088] = -1
    wrong = (torch.arange(kv, device=q.device) + 1) % kv
    kw_, vw_ = k[:, :, wrong].contiguous(), v[:, :, wrong].contiguous()
    controls = {"keys 1024..1087 dropped": (k, v, drop),
                "the wrong kv head": (kw_, vw_, pos)}
    max_err, ctrl = {}, {}

    # row 11
    before = dict(fa.launches)
    got = fa.flash_attention(q, k, v, pos, pos, **kw)
    want = ref.flash_attention_ref(q, k, v, pos, pos, **kw)
    torch.cuda.synchronize()
    check(fa.launches == dict(before, **{fa.TC_ENTRY:
                                         before[fa.TC_ENTRY] + 1}),
          f"{label}: launches {before} -> {fa.launches}")
    err = float((got.float() - want.float()).abs().max())
    share = limit_share(got, want, FLASH_BF16_TOL)
    check(torch.allclose(got.float(), want.float(), **FLASH_BF16_TOL),
          f"flash_attention_tc disagrees with its plain version on {label}"
          f" (max_abs_err {err:.3e})")
    again = fa.flash_attention(q, k, v, pos, pos, **kw)
    check(torch.equal(got, again), f"{label}: two forward runs differ")
    del got, again
    fctrl = {}
    for name, (kk, vv, kp) in controls.items():
        bad = ref.flash_attention_ref(q, kk, vv, pos, kp, **kw)
        fctrl[name] = limit_share(bad, want, FLASH_BF16_TOL)
        check(not torch.allclose(bad.float(), want.float(), **FLASH_BF16_TOL),
              f"the bf16 flash limit does not reject {name} at {label}")
        del bad
    del want
    max_err[fa.TC_ENTRY], ctrl[fa.TC_ENTRY] = err, fctrl
    print(f"  flash_attention_tc at {label}: max_abs_err {err:.3e} "
          f"({share:.3f} of the limit rtol {FLASH_BF16_TOL['rtol']:g}, atol "
          f"{FLASH_BF16_TOL['atol']:g}), two runs bitwise; controls "
          + ", ".join(f"{n} {v_:.1f}x the limit: rejected"
                      for n, v_ in fctrl.items()))

    # row 11b
    key = fa.BWD_TC_ENTRY
    before = dict(fa.launches)
    got = fa.flash_attention_bwd(q, k, v, do, pos, pos, **kw)
    again = fa.flash_attention_bwd(q, k, v, do, pos, pos, **kw)
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                       do.float(), pos, pos, **kw)
    torch.cuda.synchronize()
    moved = {n: c - before[n] for n, c in fa.launches.items()
             if c != before[n]}
    check(moved == {key: 2}, f"bwd {label}: launches {moved} for 2 calls")
    shares, err = {}, 0.0
    for name, g, a_, w in zip(("dq", "dk", "dv"), got, again, want):
        check(bool(torch.isfinite(g).all()), f"bwd {label}: {name} not "
                                             f"finite")
        check(torch.equal(g, a_), f"bwd {label}: {name} differs between "
                                  f"two runs")
        shares[name] = bwd_share(torch, g, w.to(g.dtype), "bfloat16")
        err = max(err, float((g.float() - w.to(g.dtype).float()).abs()
                             .max()))
        check(shares[name] <= 1.0, f"{key} disagrees with the plain "
                                   f"autograd on {label}: {name} at "
                                   f"{shares[name]:.3f} of the bound")
    del got, again
    bctrl = {}
    for name, (kk, vv, kp) in controls.items():
        bad = ref.flash_attention_bwd_ref(q.float(), kk.float(), vv.float(),
                                          do.float(), pos, kp, **kw)
        bctrl[name] = bwd_control(torch, bad, want, q.dtype)
        check(bwd_control_rejected(bctrl[name]),
              f"the bf16 backward bound does not reject {name} at {label} "
              f"on every gradient and by {TRAIN_CONTROL_FACTOR:g}x on one "
              f"({control_text(bctrl[name])})")
        del bad
    del want, kw_, vw_
    max_err[key], ctrl[key] = err, bctrl
    print(f"  {key} at {label}: dq/dk/dv at "
          + ", ".join(f"{n} {v_:.3f}" for n, v_ in shares.items())
          + f" of the bound {BWD_TOL['bfloat16']}, two runs bitwise; "
          f"controls " + "; ".join(f"{n}: {control_text(v_)}"
                                   for n, v_ in bctrl.items()))
    torch.cuda.empty_cache()
    return max_err, share, ctrl, shares


def ssm_attention_kernels(np, torch, dev, card, clock):
    """Rows 11 and 11b at hymba's layer (HYMBA_ATTN: bf16, dh 64, 25
    heads over 5 kv heads, window 1024, S 2048), a shape no other path
    runs: ``attention_layer_checks``; device ms beside the bound and the
    library call (SDPA with the windowed causal mask, the yardstick).
    Returns (max_abs_err by counter key, {key: timing row})."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    a = HYMBA_ATTN
    b, s, h, kv, dh, win = (a[k] for k in ("B", "S", "H", "KV", "dh",
                                           "window"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(2028)
    q, k, v = flash_inputs(torch, gen, dev, b, s, s, h, kv, dh,
                           torch.bfloat16)
    do = torch.randn((b, s, h, dh), generator=gen, device=dev).to(
        torch.bfloat16)
    pos = torch.arange(s, dtype=torch.int32, device=dev)
    kw = dict(causal=True, window=win, attn_softcap=0.0)
    label = f"hymba layer B={b} S={s} H={h} KV={kv} dh={dh} win={win}"
    print(f"phase ssm: rows 11 and 11b at {label} bf16 vs their plain "
          f"versions ({card})")
    max_err, share, ctrl, shares = attention_layer_checks(
        torch, label, q, k, v, do, pos, kw)
    rows = {}
    mask = (pos[:, None] - pos[None, :] >= 0) & (pos[:, None] - pos[None, :]
                                                 < win)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    k_fn = lambda: fa.flash_attention(q, k, v, pos, pos, **kw)  # noqa: E731
    p_fn = lambda: ref.flash_attention_ref(q, k, v, pos, pos,  # noqa: E731
                                           **kw)
    l_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, enable_gqa=True)
    lib_err = float((l_fn().transpose(1, 2).float() - p_fn().float()).abs()
                    .max())
    check(lib_err < 5e-2, f"{label}: scaled_dot_product_attention with the "
                          f"window's mask is not the same function "
                          f"({lib_err})")
    p1 = timed_ms(torch, p_fn, 3, warmup=1)
    k1 = timed_ms(torch, k_fn, 20)
    lib_ms = min(timed_ms(torch, l_fn, 10), timed_ms(torch, l_fn, 10))
    k2 = timed_ms(torch, k_fn, 20)
    p2 = timed_ms(torch, p_fn, 3, warmup=1)
    name = FLASH_DEVICE_NAMES["flash_attention_tc"]
    dev_ms = device_ms_by_name(torch, k_fn, (name,))[name]
    b_ms, b_by, nbytes, flops, floors = flash_bound(
        torch, q, k, pos, pos, causal=True, window=win, clock=clock)
    shape = {"B": b, "S": s, "Sk": s, "H": h, "KV": kv, "dh": dh,
             "window": win, "softcap": 0.0, "dtype": "bfloat16"}
    rows["flash_attention_tc"] = {
        "kernel": "flash_attention_tc", "shape": shape, "ms": min(k1, k2),
        "plain_ms": min(p1, p2), "device_ms": dev_ms, "library_ms": lib_ms,
        "library_kernel": top_device_kernel(torch, l_fn),
        "library_max_abs_err": lib_err, "bound_ms": b_ms, "bound_by": b_by,
        "floors_ms": floors, "bytes": nbytes, "flops": flops,
        "max_share": share, "controls": ctrl[fa.TC_ENTRY]}
    dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
    print(f"  time flash_attention_tc {label}: kernel {k1:.4f}/{k2:.4f} ms "
          f"a call (device {dev_txt}), plain {p1:.3f}/{p2:.3f} ms, SDPA "
          f"with the mask {lib_ms:.4f} ms "
          f"({rows['flash_attention_tc']['library_kernel']}), bound "
          f"{b_ms:.4f} ms ({floors['binding']}) on {card}")

    # row 11b
    key = fa.BWD_TC_ENTRY
    k_fn = lambda: fa.flash_attention_bwd(q, k, v, do, pos,  # noqa: E731
                                          pos, **kw)
    p_fn = lambda: ref.flash_attention_bwd_ref(q, k, v, do,  # noqa: E731
                                               pos, pos, **kw)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
    dot = do.transpose(1, 2).contiguous()
    with torch.enable_grad():
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                                 enable_gqa=True)
    l_fn = lambda: torch.autograd.grad(  # noqa: E731
        lib_out, (qg, kg, vg), dot, retain_graph=True)
    p1 = timed_ms(torch, p_fn, 2, warmup=1)
    k1 = timed_ms(torch, k_fn, 20)
    lib_ms = timed_ms(torch, l_fn, 10)
    k2 = timed_ms(torch, k_fn, 20)
    p2 = timed_ms(torch, p_fn, 2, warmup=1)
    by_name = device_ms_by_name(torch, k_fn, BWD_DEVICE_NAMES[key])
    passes = {pn: by_name[dn] for pn, dn in zip(BWD_PASSES,
                                                  BWD_DEVICE_NAMES[key])}
    dev_ms = None if None in passes.values() else sum(passes.values())
    b_ms, b_by, nbytes, flops, kflops, floors = bwd_bound(
        torch, q, k, pos, pos, window=win, route=key)
    rows[key] = {"kernel": key, "shape": shape, "ms": min(k1, k2),
                 "plain_ms": min(p1, p2), "device_ms": dev_ms,
                 "pass_device_ms": passes, "library_ms": lib_ms,
                 "library_kernel": top_device_kernel(torch, l_fn),
                 "bound_ms": b_ms, "bound_by": b_by, "floors_ms": floors,
                 "bytes": nbytes, "flops": flops, "kernel_flops": kflops,
                 "shares": shares, "controls": ctrl[key]}
    dev_txt = "not measured" if dev_ms is None else (
        f"{dev_ms:.4f} ms: " + ", ".join(f"{n_} {v_:.4f}"
                                         for n_, v_ in passes.items()))
    print(f"  time {key} {label}: kernel {k1:.4f}/{k2:.4f} ms a call "
          f"(device {dev_txt}), plain autograd {p1:.2f}/{p2:.2f} ms, SDPA "
          f"backward with the mask {lib_ms:.4f} ms "
          f"({rows[key]['library_kernel']}), bound {b_ms:.4f} ms "
          f"({floors['binding']}) on {card}")
    del q, k, v, do, qt, kt, vt, qg, kg, vg, lib_out, dot, mask
    torch.cuda.empty_cache()
    return max_err, rows


def dist(a_, b_) -> float:
    return float((a_.float() - b_.float()).abs().max())


def teacher_gate(torch, params, cfg, ext, s, n_tf, controls, serving,
                 transformer, served=None):
    """decode == teacher forcing over ``n_tf`` steps after a prompt of
    ``s`` (prefill with extra_slots=n_tf), in float32 (the gate, with
    each of ``controls``, {name: cache edit}, that must fail it) and in
    cfg.dtype (held to the float32 forward: within SSM_BF16_FACTOR times
    the cfg.dtype forward's distance from it, a bound that the controls
    named in ``served`` (default: all) must exceed). The forward's logits
    are taken at the decoded positions only. Returns the numbers."""
    def part(lo, hi):
        return {k: (t if k == "adc_mask" else t[:, lo:hi])
                for k, t in ext.items()}
    out = {}
    for dname in ("float32", cfg.dtype):
        c = cfg.replace(dtype=dname)
        with torch.no_grad():
            want = transformer.logits_of(
                params, transformer.forward(params, ext, c)[:, s:], c)
            _, cache = serving.prefill(params, part(0, s), c,
                                       extra_slots=n_tf)
            clean = {k: t.clone() for k, t in cache.items()}
            got = []
            for i in range(s, s + n_tf):
                lg, cache = serving.decode_step(params, part(i, i + 1),
                                                cache, c)
                got.append(lg)
            got = torch.stack(got, 1)
            ctrl = {}
            for name, edit in controls.items():
                bad = {k: t.clone() for k, t in clean.items()}
                edit(bad)
                ctrl[name] = serving.decode_step(params, part(s, s + 1), bad,
                                                 c)[0]
                del bad
        out[dname] = (got, want, ctrl)
        del cache, clean
    got32, want32, ctrl32 = out["float32"]
    got16, want16, ctrl16 = out[cfg.dtype]
    err32, err16 = dist(got32, want32), dist(got16, want16)
    c32 = {n: dist(t_, want32[:, 0]) for n, t_ in ctrl32.items()}
    fwd16 = dist(want16, want32)
    dec16 = dist(got16, want32)
    bound16 = SSM_BF16_FACTOR * fwd16
    c16 = {n: dist(t_, want32[:, 0]) for n, t_ in ctrl16.items()}
    held_lm = err16 <= LM_TEACHER_BF16_ATOL
    print(f"  decode after prefill(extra_slots={n_tf}) vs the forward over "
          f"{s + n_tf} tokens, {n_tf} steps (float32 logits: std "
          f"{float(want32.std()):.3f}, max |.| "
          f"{float(want32.abs().max()):.3f}):")
    print(f"      float32 (the gate): max_abs_err {err32:.3e} [rtol=atol="
          f"{LM_TEACHER_F32_TOL:g}]; controls " + ", ".join(
              f"{n} {v_:.3e} ({v_ / LM_TEACHER_F32_TOL:.1f}x: "
              f"{'rejected' if v_ > LM_TEACHER_F32_TOL else 'NOT'})"
              for n, v_ in c32.items()))
    print(f"      {cfg.dtype}: decode vs the {cfg.dtype} forward "
          f"{err16:.3e} (lm's gate {LM_TEACHER_BF16_ATOL:g}: "
          f"{'held' if held_lm else 'not held'}); decode vs the float32 "
          f"forward {dec16:.3e} <= {SSM_BF16_FACTOR:g} x the {cfg.dtype} "
          f"forward's {fwd16:.3e}; controls there " + ", ".join(
              f"{n} {v_:.3e} ({'rejected' if v_ > bound16 else 'within'})"
              for n, v_ in c16.items()))
    check(torch.allclose(got32, want32, rtol=LM_TEACHER_F32_TOL,
                         atol=LM_TEACHER_F32_TOL),
          f"{cfg.name}: decode != teacher forcing in float32 ({err32:.3e})")
    check(all(v_ > LM_TEACHER_F32_TOL for v_ in c32.values()),
          f"{cfg.name}: the float32 limit does not reject a cache fault: "
          f"{c32}")
    check(dec16 <= bound16,
          f"{cfg.name}: {cfg.dtype} decode is {dec16:.3e} from the float32 "
          f"forward, over {SSM_BF16_FACTOR:g} x the {cfg.dtype} forward's "
          f"distance {fwd16:.3e}")
    check(all(v_ > bound16 for n, v_ in c16.items()
              if served is None or n in served),
          f"{cfg.name}: the {cfg.dtype} bound {bound16:.3e} does not reject "
          f"a cache fault: {c16}")
    return {"decode_vs_teacher_err_f32": err32,
            "decode_vs_teacher_err_served": err16,
            "served_held_lm_gate": held_lm,
            "served_decode_vs_f32_forward": dec16,
            "served_forward_vs_f32_forward": fwd16,
            "controls_f32": c32, "controls_served_vs_f32": c16}


def ssm_serve(np, torch, dev, card, arch):
    """One published config, uncut, through launch.serve.serve with every
    launch counter at 0 (SSM: 4 x 2048 prompts, 16 decode steps); then
    prefill == forward; decode == teacher forcing over SSM['teacher']
    steps (``teacher_gate``) with two cache-fault controls (the SSD state
    zeroed, the conv_x tail shifted by one token) that must fail the
    float32 gate, the shifted tail the served bf16's bound too; a warm
    and a traced prefill, 16 warm and one traced decode step,
    each traced window split by ``product_split``; peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import serving, transformer
    cfg = get_config(arch)
    check_published(cfg)
    b, s, n_gen, n_tf = (SSM[k] for k in ("requests", "prompt_len", "gen",
                                          "teacher"))
    hybrid = cfg.family == "hybrid"
    n_tc = cfg.num_layers if hybrid else 0
    print(f"phase ssm: {cfg.name} at its published config, uncut "
          f"({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.param_counts()['total']:,} parameters, state "
          f"{cfg.ssm.state_dim}, chunk {cfg.ssm.chunk}"
          + (f", {cfg.num_heads}/{cfg.num_kv_heads} heads of "
             f"{cfg.resolved_head_dim}, window {cfg.window}" if hybrid
             else ", attention-free")
          + f"; {cfg.param_dtype} params, {cfg.dtype} activations) through "
          f"launch.serve.serve on cuda ({card})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reset_all_launches()
    gen, info = serve.serve(cfg, params, requests=b, prompt_len=s, gen=n_gen,
                            device=dev, seed=0)
    torch.cuda.synchronize()
    launches = all_launches()
    print(f"  launch counters after the main path: {launches}")
    check(launches["flash_attention_tc"] == n_tc
          and info["prefill_flash_launches"] == n_tc
          and info["decode_flash_launches"] == 0
          and sum(launches.values()) == n_tc,
          f"{cfg.name}: launches {launches}, prefill "
          f"{info['prefill_flash_launches']}; expected {n_tc} tensor-core "
          f"attention launches (one a layer of the prefill) and nothing "
          f"else")
    check(gen.shape == (b, n_gen) and len(info["logits"]) == n_gen + 1
          and all(lg.shape == (b, cfg.vocab_size) and np.isfinite(lg).all()
                  for lg in info["logits"]),
          f"{cfg.name}: generated {gen.shape}; logits not finite or "
          f"misshapen")
    print(f"  serve: {b} x {s} prefill {info['prefill_s']:.3f} s (first "
          f"call, {info['prefill_tokens_per_s']:.0f} tokens/s), {n_gen} "
          f"decode steps {info['decode_ms_per_token']:.2f} ms/token; init "
          f"{init_s:.2f} s")

    batch = serve.make_batch(cfg, b, s, rng=np.random.default_rng(0),
                             device=dev)
    pre, _ = serving.prefill(params, batch, cfg)
    full = transformer.logits_fn(params, batch, cfg)[:, -1]
    err_c = float((pre - full).abs().max())
    same = float(np.abs(pre.cpu().numpy() - info["logits"][0]).max())
    ok = torch.allclose(pre, full, rtol=2e-2, atol=2e-2)
    print(f"  prefill last-position logits vs logits_fn: max_abs_err "
          f"{err_c:.3e} [rtol=atol=2e-2]; vs serve's prefill {same:.3e}")
    check(ok, f"{cfg.name}: prefill != forward ({err_c:.3e})")
    check(same <= 2e-2, f"{cfg.name}: a second prefill differs from "
                        f"serve's ({same:.3e})")
    del pre, full

    ext = serve.make_batch(cfg, b, s + n_tf, rng=np.random.default_rng(1),
                           device=dev)
    conv = "conv_x tail shifted by one token"
    gate = teacher_gate(
        torch, params, cfg, ext, s, n_tf,
        {"SSD state zeroed": lambda cc: cc["state"].zero_(),
         conv: lambda cc: cc["conv_x"].copy_(torch.roll(cc["conv_x"], 1,
                                                        dims=2))},
        serving, transformer, served=(conv,))

    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serving.prefill(params, batch, cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    pre_wall, pre_ms, pre_n, pre_busy = traced_split(
        torch, lambda: serving.prefill(params, batch, cfg))
    _, cache = serving.prefill(params, batch, cfg, extra_slots=n_gen + 1)
    rng = np.random.default_rng(2)

    def step_batch(i):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, b)).to(dev)
        return serve.token_to_batch(cfg, tok, s + i, b, rng, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_gen):
        serving.decode_step(params, step_batch(i), cache, cfg)
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t0) / n_gen * 1e3
    nxt = step_batch(n_gen)
    dec_wall, dec_split, dec_n, dec_busy = traced_split(
        torch, lambda: serving.decode_step(params, nxt, cache, cfg))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    warm = min(walls)
    print(f"  warm prefill {walls[0]:.4f}/{walls[1]:.4f} s ({b * s / warm:.0f}"
          f" tokens/s); traced (shapes recorded): wall {pre_wall:.4f} s, "
          f"busy {pre_busy * 100:.1f} %, device {split_text(pre_ms, pre_n)}")
    print(f"  warm decode {dec_ms:.2f} ms/token; a traced step: wall "
          f"{dec_wall * 1e3:.2f} ms, busy {dec_busy * 100:.1f} %, device "
          f"{split_text(dec_split, dec_n)}; peak {peak_gb:.2f} GB on {card}")
    del params, cache, batch, ext
    torch.cuda.empty_cache()
    return {"launches": launches, "params": cfg.param_counts()["total"],
            "init_s": init_s, "prefill_s_first": info["prefill_s"],
            "decode_ms_per_token_first": info["decode_ms_per_token"],
            "prefill_s_warm": walls, "prefill_tokens_per_s": b * s / warm,
            "prefill_traced_wall_s": pre_wall,
            "prefill_device_ms": pre_ms, "prefill_kernels": pre_n,
            "prefill_busy_share": pre_busy,
            "decode_ms_per_token_warm": dec_ms,
            "decode_traced_wall_ms": dec_wall * 1e3,
            "decode_device_ms": dec_split, "decode_kernels": dec_n,
            "decode_busy_share": dec_busy, "peak_gb": peak_gb,
            "prefill_vs_forward_err": err_c, **gate}


def leaf_names(params, stacked):
    """Names of ``steps._autograd_leaves``' leaves, in its order."""
    names = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        else:
            names.extend(f"{path}[{i}]" for i in range(node.shape[0]))
    for key, value in params.items():
        if key in stacked:
            walk(value, key)
        else:
            names.append(key)
    return names


def replay_grads(torch, params, mb, cfg, steps, transformer):
    """One microbatch's loss and every gradient leaf twice: the names of
    the leaves that differ, and their count."""
    names = ["loss"] + leaf_names(params, steps._STACKED)
    first, differ = None, []
    for _ in range(2):
        live, leaves = steps._autograd_leaves(params)
        with torch.enable_grad():
            loss, _ = transformer.loss_fn(live, mb, cfg)
            grads = torch.autograd.grad(loss, leaves)
        run = [loss.detach()] + list(grads)
        del live, leaves, grads, loss
        if first is None:
            first = run
        else:
            differ = [names[i] for i, (a_, b_) in enumerate(zip(first, run))
                      if not torch.equal(a_, b_)]
        del run
    n = len(first)
    del first
    return differ, n


def ssm_train(np, torch, dev, card, arch):
    """One published config, uncut, trained through launch.train.build
    and ``train_run`` (SSM_TRAIN: 8 x 2048 in 2 microbatches, 3 steps):
    hybrid runs rows 11 and 11b on the tensor cores in each attention
    layer, mamba2 launches no kernel; the replay covers every layer, the
    token embedding's gather and, for mamba2, the tied head."""
    from repro_torch.launch import train
    c = dict(SSM_TRAIN, routes=("flash_attention_tc",
                                "flash_attention_bwd_tc"))
    built = train.build(arch, smoke=False, seq=c["seq"], batch=c["batch"],
                        microbatches=c["microbatches"], steps_total=100,
                        device="cuda")
    cfg = built[0]
    check_published(cfg)
    ssm = lambda p: p["layers"]["ssm"]  # noqa: E731
    return train_run(
        np, torch, dev, card, "ssm", built, c,
        cfg.num_layers if cfg.family == "hybrid" else 0,
        {"embed": lambda p: p["embed"][:64],
         "layers/ssm/x_proj[0]": lambda p: ssm(p)["x_proj"][0],
         "layers/ssm/A_log": lambda p: ssm(p)["A_log"]},
        " at its published config, uncut")


def smoke_card_vs_cpu(np, torch, dev, card, phase, c):
    """The smoke configs of ``c['archs']`` (SSM_SMOKE, LG_SMOKE), float32,
    card against CPU from one init: prefill and c['decode'] decode steps'
    logits, c['steps'] microbatched train steps; one train step replayed
    on the card, bitwise. An M-RoPE config takes c['grid']'s vision
    positions in both. Returns the card's launch counts (their attention,
    dh 16, runs rows 11 and 11b on the CUDA-core routes)."""
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.lm import (LMDataConfig, SyntheticLM,
                                     mrope_grid_positions)
    from repro_torch.launch import serve
    from repro_torch.models import serving, steps, transformer
    from repro_torch.optim import adamw
    tol = TRAIN_SMOKE_TOL
    cpu = torch.device("cpu")
    print(f"phase {phase}: smoke configs {c['archs']}, float32, card "
          f"against CPU: prefill {c['prompt']} + {c['decode']} decode steps "
          f"(logits {MOE_SMOKE_LOGITS_TOL:g}), {c['steps']} train steps "
          f"(batch {c['batch']} x {c['seq']}, {c['microbatches']} "
          f"microbatches; loss, lr, grad_norm {tol['metrics']:g}, params "
          f"{tol['params']:g}), a replayed step bitwise")
    reset_all_launches()

    def copy(tree, device):
        return adamw.tree_map(lambda t: t.detach().clone().to(device), tree)

    for arch in c["archs"]:
        cfg = smoke_config(arch)
        host = transformer.init_params(cfg, seed=5)
        n = c["prompt"] + c["decode"]
        rng = np.random.default_rng(3)
        batch = serve.make_batch(cfg, 2, n, rng=rng)
        grid = None
        if cfg.mrope:
            g = c["grid"]
            batch["positions"] = torch.from_numpy(mrope_grid_positions(
                2, [g], n - g[0] * g[1] * g[2]))
            grid = torch.from_numpy(mrope_grid_positions(
                c["batch"], [g], c["seq"] - g[0] * g[1] * g[2])).reshape(
                    c["microbatches"], -1, c["seq"], 3)
        logits = {}
        for where, d in (("cpu", cpu), ("card", dev)):
            params = copy(host, d)
            mb = {k: t.to(d) for k, t in batch.items()}
            part = lambda lo, hi: {  # noqa: E731
                k: (t if k == "adc_mask" else t[:, lo:hi])
                for k, t in mb.items()}
            out, cache = serving.prefill(params, part(0, c["prompt"]), cfg)
            outs = [out]
            for t in range(c["prompt"], n):
                out, cache = serving.decode_step(params, part(t, t + 1),
                                                 cache, cfg)
                outs.append(out)
            logits[where] = [o.cpu() for o in outs]
        lerr = max(float((a - b_).abs().max())
                   for a, b_ in zip(logits["card"], logits["cpu"]))
        check(lerr <= MOE_SMOKE_LOGITS_TOL * (1 + max(
            float(w.abs().max()) for w in logits["cpu"])),
              f"{arch} smoke serving: card vs CPU logits {lerr:.3e}")
        data = SyntheticLM(LMDataConfig(
            vocab_size=cfg.vocab_size, seq_len=c["seq"],
            global_batch=c["batch"], microbatches=c["microbatches"]), cfg)

        def batch_at(i, d):
            out = data.device_batch(i, d)
            if grid is not None:
                out["positions"] = grid.to(d)
            return out
        step = steps.make_train_step(
            cfg, None, ShapeConfig("smoke", c["seq"], c["batch"], "train"),
            microbatches=c["microbatches"], total_steps=10)
        states, metrics = {}, {}
        for where, d in (("cpu", cpu), ("card", dev)):
            params = copy(host, d)
            state = steps.TrainState(params, adamw.init_tree(params))
            for i in range(c["steps"]):
                state, mt = step(state, batch_at(i, d), i)
                metrics.setdefault(where, []).append(
                    {k: float(t) for k, t in mt.items()})
            states[where] = state
        for mc, mh in zip(metrics["card"], metrics["cpu"]):
            for key in ("loss", "lr", "grad_norm"):
                check(abs(mc[key] - mh[key]) <= tol["metrics"] * abs(mh[key]),
                      f"{arch} smoke step {key}: card {mc[key]} vs CPU "
                      f"{mh[key]}")
        perr = max(float((a.cpu() - b_).abs().max()) for a, b_ in zip(
            adamw.tree_leaves(states["card"].params),
            adamw.tree_leaves(states["cpu"].params)))
        check(perr <= tol["params"], f"{arch} smoke params after "
                                     f"{c['steps']} steps: {perr:.3e}")
        base = states["card"]
        runs = []
        for _ in range(2):
            clone = steps.TrainState(
                copy(base.params, dev),
                adamw.OptState(base.opt.step.clone(), copy(base.opt.m, dev),
                               copy(base.opt.v, dev)))
            new, mt = step(clone, batch_at(c["steps"], dev), c["steps"])
            runs.append(adamw.tree_leaves(new.params)
                        + adamw.tree_leaves(new.opt.m)
                        + adamw.tree_leaves(new.opt.v)
                        + [mt["loss"], mt["grad_norm"]])
        differ = sum(not torch.equal(a, b_) for a, b_ in zip(*runs))
        check(differ == 0, f"{arch} smoke: a replayed step differs in "
                           f"{differ} of {len(runs[0])} tensors")
        print(f"  {cfg.name}: serving logits card vs CPU {lerr:.2e}; loss "
              f"{[round(mm['loss'], 6) for mm in metrics['card']]} vs "
              f"{[round(mm['loss'], 6) for mm in metrics['cpu']]}, "
              f"params max_abs_err {perr:.2e}; a replayed step's "
              f"{len(runs[0])} tensors bitwise")
        del states, runs
    launches = all_launches()
    check(launches["flash_attention"] > 0
          and launches["flash_attention_bwd"] > 0
          and launches["flash_attention_tc"] == 0
          and launches["flash_attention_bwd_tc"] == 0,
          f"the {phase} smoke runs on the card launched {launches}; "
          f"expected the CUDA-core routes only (dh 16)")
    return launches


def phase_ssm(np, torch, dev, card, clock):
    """The ssm and hybrid families (ROADMAP A11.2-A11.3) on the card:
    rows 11 and 11b at hymba's layer; both published configs served and
    trained uncut; the smoke configs card against CPU. Returns the main
    path's launch counts (the serve calls and the train steps, each
    counted from 0) and the numbers."""
    t_phase = time.perf_counter()
    max_err, rows = ssm_attention_kernels(np, torch, dev, card, clock)
    out = {"serve": {}, "train": {}, "max_err": max_err,
           "hymba_rows": rows}
    launches = {}
    for arch in SSM_ARCHS:
        res = ssm_serve(np, torch, dev, card, arch)
        for name, n in res.pop("launches").items():
            launches[name] = launches.get(name, 0) + n
        out["serve"][arch] = res
    for arch in SSM_ARCHS:
        res = ssm_train(np, torch, dev, card, arch)
        for name, n in res.pop("launches").items():
            launches[name] = launches.get(name, 0) + n
        out["train"][arch] = res
    out["smoke_launches"] = smoke_card_vs_cpu(np, torch, dev, card, "ssm",
                                              dict(SSM_SMOKE, archs=SSM_ARCHS))
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase ssm: {out['phase_s']:.2f} s on {card}; launches on the "
          f"ssm path: {launches}")
    return out


def tree_numel(params) -> int:
    from repro_torch.optim import adamw
    return sum(t.numel() for t in adamw.tree_leaves(params))


def lg_attention_kernels(np, torch, dev, card, clock):
    """Rows 11 and 11b at gemma2's layer (GEMMA_ATTN: B 1, S 8192, 8
    heads over 4, dh 256, softcap 50), windowed (4096) and global: row
    11b on its route in each type (bf16 on the tensor-core kernel's dh-256
    geometry, float32 on the CUDA-core kernel's 32-row tiles) and in bf16
    on the CUDA-core kernel called directly, against the plain autograd in
    float32 (BWD_TOL), two runs bitwise, each call counted on its kernel's
    key; phase train's controls (keys 1024..1087 dropped, the wrong kv
    head) rejected by ``bwd_control_rejected`` (every gradient over the
    bound, the largest share over TRAIN_CONTROL_FACTOR: a dropped key's dk
    / dv share is at most 1 / rtol = 128, so the least of the three is no
    measure), each control's three shares printed; each pass's device time
    beside bwd_bound, the plain autograd and SDPA's backward (without the
    softcap, which SDPA lacks: a yardstick, not the same function; None
    where it refuses); row 11's tensor-core forward at the same shape
    against its plain version; then ``attention_layer_checks`` at
    qwen2-vl's layer (QWEN_ATTN, tensor cores) on the t component of
    QWEN's vision grid, its 1536 image tokens at one position. Returns
    (max_abs_err by counter key, {label: timing row})."""
    import torch.nn.functional as F
    from repro_torch.kernels import dispatch, envelope
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    a = GEMMA_ATTN
    b, s, h, kv, dh, cap = (a[k] for k in ("B", "S", "H", "KV", "dh",
                                            "softcap"))
    keys = {"tensor_core": fa.BWD_TC_ENTRY, "cuda_core": fa.BWD_ENTRY}
    check(envelope.flash_bwd_route(True, dh) == "tensor_core"
          and envelope.outside_flash_bwd_tc_envelope(b, h, dh) is None,
          f"dh {dh} bf16: not on the tensor-core backward's route and "
          f"envelope")
    check(envelope.flash_bwd_route(False, dh) == "cuda_core"
          and envelope.outside_flash_bwd_envelope(b, s, h, dh) is None,
          f"dh {dh} float32: not on the CUDA-core backward's route and "
          f"envelope")
    for p in range(3):
        check(fa.bwd_smem_bytes(p, dh) == envelope.flash_bwd_smem_bytes(p, dh)
              <= envelope.SMEM_MAX_BYTES,
              f"backward pass {p} at dh {dh}: the build asks for "
              f"{fa.bwd_smem_bytes(p, dh)} bytes, the envelope says "
              f"{envelope.flash_bwd_smem_bytes(p, dh)}")
        check(fa.bwd_tc_smem_bytes(p, dh)
              == envelope.flash_bwd_tc_smem_bytes(p, dh)
              <= envelope.SMEM_MAX_BYTES,
              f"tensor-core backward pass {p} at dh {dh}: the build asks "
              f"for {fa.bwd_tc_smem_bytes(p, dh)} bytes, the envelope says "
              f"{envelope.flash_bwd_tc_smem_bytes(p, dh)}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2029)
    q32, k32, v32 = flash_inputs(torch, gen, dev, b, s, s, h, kv, dh,
                                 torch.float32)
    do32 = torch.randn((b, s, h, dh), generator=gen, device=dev)
    pos = torch.arange(s, dtype=torch.int32, device=dev)
    # the controls every row 11b case takes: keys 1024..1087 dropped (two
    # of either kernel's 32-key tiles), and the wrong kv head
    drop = pos.clone()
    drop[1024:1088] = -1
    # every query head group reads the next group's kv head
    wrong = (torch.arange(kv, device=dev) + 1) % kv
    max_err, rows = {fa.BWD_ENTRY: 0.0, fa.TC_ENTRY: 0.0,
                     fa.BWD_TC_ENTRY: 0.0}, {}
    print(f"phase local_global_vlm: rows 11 and 11b at gemma2's layer B={b} "
          f"S={s} H={h} KV={kv} dh={dh} softcap {cap:g}, window "
          f"{a['window']} and global ({card})")
    for win in (a["window"], 0):
        kw = dict(causal=True, window=win, attn_softcap=cap)
        mask = (pos[:, None] - pos[None, :] >= 0)
        if win:
            mask = mask & (pos[:, None] - pos[None, :] < win)
        wtxt = f"window {win}" if win else "global"
        # row 11, the tensor-core forward (bf16)
        q, k, v = (x.to(torch.bfloat16) for x in (q32, k32, v32))
        check(dispatch.resolve_flash(fa.ENTRY, q).route == "tensor_core",
              f"dh {dh} bf16: not on the tensor-core forward")
        before = dict(fa.launches)
        got = fa.flash_attention(q, k, v, pos, pos, **kw)
        want = ref.flash_attention_ref(q, k, v, pos, pos, **kw)
        torch.cuda.synchronize()
        check(fa.launches == dict(before, **{fa.TC_ENTRY:
                                             before[fa.TC_ENTRY] + 1}),
              f"forward {wtxt}: launches {before} -> {fa.launches}")
        err = float((got.float() - want.float()).abs().max())
        share = limit_share(got, want, FLASH_BF16_TOL)
        check(share <= 1.0, f"flash_attention_tc disagrees with its plain "
                            f"version at gemma2's layer, {wtxt} ({err:.3e})")
        max_err[fa.TC_ENTRY] = max(max_err[fa.TC_ENTRY], err)
        k_fn = lambda: fa.flash_attention(q, k, v, pos, pos,  # noqa: E731
                                          **kw)
        f_ms = timed_ms(torch, k_fn, 5)
        f_dev = device_ms_by_name(torch, k_fn, (FLASH_DEVICE_NAMES[
            fa.TC_ENTRY],))[FLASH_DEVICE_NAMES[fa.TC_ENTRY]]
        f_plain = timed_ms(torch, lambda: ref.flash_attention_ref(
            q, k, v, pos, pos, **kw), 2, warmup=1)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        f_lib = timed_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask if win else None, is_causal=not win,
            enable_gqa=True), 5)
        fb_ms, fb_by, _, _, ffloors = flash_bound(
            torch, q, k, pos, pos, causal=True, window=win, clock=clock)
        rows[f"row 11 gemma2 layer {wtxt} bfloat16"] = {
            "kernel": fa.TC_ENTRY, "ms": f_ms, "device_ms": f_dev,
            "plain_ms": f_plain, "library_ms": f_lib,
            "library_note": "SDPA without the softcap (SDPA has none)",
            "bound_ms": fb_ms, "bound_by": fb_by, "floors_ms": ffloors,
            "max_share": share}
        print(f"  row 11 tensor-core forward, {wtxt}, bf16: max_abs_err "
              f"{err:.3e} ({share:.3f} of the bf16 flash limit); "
              f"{f_ms:.4f} ms a call (device "
              + ("not measured" if f_dev is None else f"{f_dev:.4f} ms")
              + f"), plain {f_plain:.2f} ms, SDPA without the softcap "
              f"{f_lib:.4f} ms, bound {fb_ms:.4f} ms ({ffloors['binding']})"
              f" on {card}")
        del got, want, qt, kt, vt
        # row 11b: each type on its route (bf16 on the tensor cores,
        # float32 on the CUDA cores), then bf16 on the CUDA-core kernel
        # called directly; the plain gradient, the controls, the plain
        # time and SDPA's once a type
        wants, ctrls, plains, libs, by_route = {}, {}, {}, {}, {}
        for dt, route in ((torch.bfloat16, "tensor_core"),
                          (torch.float32, "cuda_core"),
                          (torch.bfloat16, "cuda_core")):
            dname = str(dt).split(".")[-1]
            ckey = keys[route]
            direct = route != envelope.flash_bwd_route(dt == torch.bfloat16,
                                                       dh)
            label = (f"gemma2 layer B={b} S={s} H={h} KV={kv} dh={dh} "
                     f"cap={cap:g} {wtxt} {dname}"
                     + (f" {route} (called directly)" if direct else ""))
            q, k, v, do = (x.to(dt) for x in (q32, k32, v32, do32))
            if direct:
                k_fn = lambda: fa._launch_bwd(  # noqa: E731
                    route, q, k, v, do, pos, pos, **kw)
            else:
                check(dispatch.resolve_flash_bwd(fa.BWD_ENTRY, q).route
                      == route, f"{label}: not on the {route} backward")
                k_fn = lambda: fa.flash_attention_bwd(  # noqa: E731
                    q, k, v, do, pos, pos, **kw)
            before = dict(fa.launches)
            got = k_fn()
            again = k_fn()
            if dname not in wants:
                wants[dname] = ref.flash_attention_bwd_ref(
                    q.float(), k.float(), v.float(), do.float(), pos, pos,
                    **kw)
            want = wants[dname]
            torch.cuda.synchronize()
            moved = {n: c_ - before[n] for n, c_ in fa.launches.items()
                     if c_ != before[n]}
            check(moved == {ckey: 2}, f"bwd {label}: launches {moved} for 2 "
                                      f"calls, expected {{{ckey!r}: 2}}")
            shares, err = {}, 0.0
            for name, g, a_, w in zip(("dq", "dk", "dv"), got, again, want):
                check(g.dtype == dt and g.shape == w.shape,
                      f"bwd {label}: {name} {g.dtype} {tuple(g.shape)}")
                check(bool(torch.isfinite(g).all()),
                      f"bwd {label}: {name} not finite")
                check(torch.equal(g, a_), f"bwd {label}: {name} differs "
                                          f"between two runs")
                shares[name] = bwd_share(torch, g, w.to(dt), dname)
                err = max(err, float((g.float() - w.to(dt).float()).abs()
                                     .max()))
                check(shares[name] <= 1.0,
                      f"{ckey} disagrees with the plain autograd on {label}: "
                      f"{name} at {shares[name]:.3f} of the bound")
            del got, again
            if dname not in ctrls:
                ctrls[dname] = {}
                for name, kk, vv, kp in (
                        ("keys 1024..1087 dropped", k, v, drop),
                        ("the wrong kv head", k[:, :, wrong].contiguous(),
                         v[:, :, wrong].contiguous(), pos)):
                    bad = ref.flash_attention_bwd_ref(
                        q.float(), kk.float(), vv.float(), do.float(), pos,
                        kp, **kw)
                    ctrls[dname][name] = bwd_control(torch, bad, want, dt)
                    check(bwd_control_rejected(ctrls[dname][name]),
                          f"the {dname} backward bound does not reject "
                          f"{name} at {label} on every gradient and by "
                          f"{TRAIN_CONTROL_FACTOR:g}x on one "
                          f"({control_text(ctrls[dname][name])})")
                    del bad
            ctrl = ctrls[dname]
            max_err[ckey] = max(max_err[ckey], err)
            torch.cuda.empty_cache()
            if dname not in plains:
                plains[dname] = timed_ms(torch, lambda: (  # noqa: E731
                    ref.flash_attention_bwd_ref(q, k, v, do, pos, pos,
                                                **kw)), 1, warmup=1)
            p1 = plains[dname]
            reps = 20 if route == "tensor_core" else 3
            k1 = timed_ms(torch, k_fn, reps, warmup=1)
            k2 = timed_ms(torch, k_fn, reps, warmup=0)
            by_name = device_ms_by_name(torch, k_fn, BWD_DEVICE_NAMES[ckey])
            passes = {pn: by_name[dn] for pn, dn in
                      zip(BWD_PASSES, BWD_DEVICE_NAMES[ckey])}
            dev_ms = (None if None in passes.values()
                      else sum(passes.values()))
            if dname not in libs:
                libs[dname] = (None, None)
                qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                                   for x in (q, k, v, do))
                try:
                    qg, kg, vg = (x.detach().requires_grad_(True)
                                  for x in (qt, kt, vt))
                    with torch.enable_grad():
                        lib_out = F.scaled_dot_product_attention(
                            qg, kg, vg, attn_mask=None if not win else mask,
                            is_causal=not win, enable_gqa=True)
                    l_fn = lambda: torch.autograd.grad(  # noqa: E731
                        lib_out, (qg, kg, vg), dot, retain_graph=True)
                    libs[dname] = (timed_ms(torch, l_fn, 3, warmup=1),
                                   top_device_kernel(torch, l_fn))
                    del lib_out, qg, kg, vg
                except RuntimeError as exc:
                    print(f"  SDPA backward at {label}: n/a ({exc})")
                del qt, kt, vt, dot
            lib_ms, lib_kernel = libs[dname]
            b_ms, b_by, nbytes, flops, kflops, floors = bwd_bound(
                torch, q, k, pos, pos, window=win, route=ckey)
            rows[label] = {
                "kernel": ckey, "route": route, "called_directly": direct,
                "shape": {"B": b, "S": s, "Sk": s, "H": h, "KV": kv,
                          "dh": dh, "window": win, "softcap": cap,
                          "dtype": dname},
                "ms": min(k1, k2), "plain_ms": p1, "device_ms": dev_ms,
                "pass_device_ms": passes, "library_ms": lib_ms,
                "library_kernel": lib_kernel,
                "library_note": "SDPA without the softcap (SDPA has none)",
                "bound_ms": b_ms, "bound_by": b_by, "floors_ms": floors,
                "bytes": nbytes, "flops": flops, "kernel_flops": kflops,
                "shares": shares, "controls": ctrl,
                "forward_tc_ms": f_ms}
            by_route[(dname, route)] = rows[label]
            dev_txt = "not measured" if dev_ms is None else (
                f"{dev_ms:.3f} ms: " + ", ".join(
                    f"{n_} {v_:.3f}" for n_, v_ in passes.items()))
            lib_txt = ("n/a" if lib_ms is None
                       else f"{lib_ms:.3f} ms ({lib_kernel})")
            peak = "bf16 tensor-core" if route == "tensor_core" \
                else "float32"
            print(f"  row 11b {label}: dq/dk/dv at " + ", ".join(
                f"{n} {v_:.3f}" for n, v_ in shares.items())
                + " of BWD_TOL, two runs bitwise; controls "
                + "; ".join(f"{n}: {control_text(v_)}"
                            for n, v_ in ctrl.items()))
            print(f"  time {ckey} {label}: kernel {k1:.3f}/{k2:.3f} ms a "
                  f"call (device {dev_txt}), plain autograd {p1:.2f} ms, "
                  f"SDPA backward without the softcap {lib_txt}, bound "
                  f"{b_ms:.4f} ms ({floors['binding']}), the design's "
                  f"{kflops / 1e12:.3f} TFLOP at the {peak} peak "
                  f"{floors['design']:.3f} ms on {card}")
            del q, k, v, do
            torch.cuda.empty_cache()
        tc_row = by_route[("bfloat16", "tensor_core")]
        cc_row = by_route[("bfloat16", "cuda_core")]
        print(f"  row 11b bf16 at gemma2's layer, {wtxt}, a pass's device "
              f"ms (statistics / dk-dv / dq): tensor cores "
              + " / ".join("not measured" if t is None else f"{t:.3f}"
                           for t in tc_row["pass_device_ms"].values())
              + ", CUDA cores "
              + " / ".join("not measured" if t is None else f"{t:.3f}"
                           for t in cc_row["pass_device_ms"].values())
              + f"; a call {tc_row['ms']:.3f} against {cc_row['ms']:.3f} ms "
              f"({cc_row['ms'] / tc_row['ms']:.1f}x), bound "
              f"{tc_row['bound_ms']:.4f} ms ({tc_row['ms'] / tc_row['bound_ms']:.1f}x "
              f"it), plain autograd {tc_row['plain_ms']:.2f} ms, SDPA "
              f"without the softcap "
              + ("n/a" if tc_row["library_ms"] is None
                 else f"{tc_row['library_ms']:.3f} ms") + f" on {card}")
        del wants
    del q32, k32, v32, do32
    torch.cuda.empty_cache()

    # qwen2-vl's layer on its vision grid: attention reads the t
    # component, so the image's QWEN['grid'] patches share one position
    from repro_torch.data.lm import mrope_grid_positions
    a = QWEN_ATTN
    b, s, h, kv, dh = (a[k_] for k_ in ("B", "S", "H", "KV", "dh"))
    grid, text = QWEN["grid"], QWEN["text"]
    pos = torch.from_numpy(mrope_grid_positions(1, [grid], text)[0, :, 0]
                           .copy()).to(dev)
    check(pos.shape == (s,), f"qwen2-vl's grid spans {tuple(pos.shape)}")
    q, k, v = flash_inputs(torch, gen, dev, b, s, s, h, kv, dh,
                           torch.bfloat16)
    do = torch.randn((b, s, h, dh), generator=gen, device=dev).to(
        torch.bfloat16)
    kw = dict(causal=True, window=0, attn_softcap=0.0)
    label = (f"qwen2-vl layer B={b} S={s} H={h} KV={kv} dh={dh}, an image "
             f"of {grid} patches at one t then {text} text tokens")
    print(f"phase local_global_vlm: rows 11 and 11b at {label} bf16 vs "
          f"their plain versions ({card})")
    errs, share, ctrl, shares = attention_layer_checks(
        torch, label, q, k, v, do, pos, kw)
    for key_, err in errs.items():
        max_err[key_] = max(max_err[key_], err)
    f_ms = timed_ms(torch, lambda: fa.flash_attention(q, k, v, pos, pos,
                                                      **kw), 10)
    b_ms = timed_ms(torch, lambda: fa.flash_attention_bwd(q, k, v, do, pos,
                                                          pos, **kw), 10)
    # the bounds and the library at the grid's positions: SDPA with the
    # grid's explicit causal mask over positions (the image's patches
    # see each other), forward and autograd backward
    f_bound, f_by, _, _, f_floors = flash_bound(
        torch, q, k, pos, pos, causal=True, window=0, clock=clock)
    bw_bound, bw_by, _, _, _, bw_floors = bwd_bound(
        torch, q, k, pos, pos, window=0, route=fa.BWD_TC_ENTRY)
    mask = pos[:, None] >= pos[None, :]
    qt, kt, vt = (t_.transpose(1, 2).contiguous() for t_ in (q, k, v))
    l_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, enable_gqa=True)
    lib_err = float((l_fn().transpose(1, 2).float()
                     - ref.flash_attention_ref(q, k, v, pos, pos, **kw)
                     .float()).abs().max())
    check(lib_err < 5e-2, f"{label}: scaled_dot_product_attention with the "
                          f"grid's mask is not the same function "
                          f"({lib_err})")
    f_lib = min(timed_ms(torch, l_fn, 10), timed_ms(torch, l_fn, 10))
    qg, kg, vg = (t_.detach().requires_grad_(True) for t_ in (qt, kt, vt))
    dot = do.transpose(1, 2).contiguous()
    with torch.enable_grad():
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                                 enable_gqa=True)
    b_lib = timed_ms(torch, lambda: torch.autograd.grad(
        lib_out, (qg, kg, vg), dot, retain_graph=True), 10)
    del qt, kt, vt, qg, kg, vg, dot, lib_out, mask
    rows[f"row 11 {label}"] = {
        "kernel": fa.TC_ENTRY, "ms": f_ms, "max_share": share,
        "max_abs_err": errs[fa.TC_ENTRY], "controls": ctrl[fa.TC_ENTRY],
        "bound_ms": f_bound, "bound_by": f_by, "floors_ms": f_floors,
        "library_ms": f_lib, "library_max_abs_err": lib_err}
    rows[f"row 11b {label}"] = {
        "kernel": fa.BWD_TC_ENTRY, "ms": b_ms, "shares": shares,
        "max_abs_err": errs[fa.BWD_TC_ENTRY],
        "controls": ctrl[fa.BWD_TC_ENTRY], "bound_ms": bw_bound,
        "bound_by": bw_by, "floors_ms": bw_floors, "library_ms": b_lib}
    print(f"  time at {label}: forward {f_ms:.4f} ms (bound {f_bound:.4f} "
          f"ms, {f_floors['binding']}; SDPA with the grid's mask "
          f"{f_lib:.4f} ms), backward {b_ms:.4f} ms (bound {bw_bound:.4f} "
          f"ms, {bw_by}; SDPA's autograd backward with the mask "
          f"{b_lib:.4f} ms) a call on {card}")
    del q, k, v, do
    torch.cuda.empty_cache()
    return max_err, rows


def gemma2_serve(np, torch, dev, card):
    """gemma2-2b at its published widths, uncut, heads unpadded
    (GEMMA['cut']): launch.serve.serve with every launch counter at 0
    (1 x 8192 prompt, twice the window, GEMMA['gen'] decode steps: the
    tensor-core forward once a layer of the prefill, 13 windowed and 13
    global, nothing else); prefill == forward; decode == teacher forcing
    after prefill(extra_slots) in float32 with a zeroed local ring and a
    zeroed global cache as controls, and in bf16 held to the float32
    forward; a warm prefill and decode step, peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import serving, transformer
    g = GEMMA
    cfg = get_config(g["arch"]).replace(**g["cut"])
    check_published(cfg)
    b, s, n_gen, n_tf = g["requests"], g["prompt_len"], g["gen"], g["teacher"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = transformer.init_params(cfg, seed=0, device=dev)
    n_params = tree_numel(params)
    print(f"phase local_global_vlm: {cfg.name} at its published widths, uncut "
          f"({cfg.num_layers} layers as {transformer.scan_len(cfg)} (local "
          f"{cfg.window}, global) pairs, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads over {cfg.num_kv_heads} of "
          f"{cfg.resolved_head_dim}, softcaps {cfg.attn_logit_softcap:g}/"
          f"{cfg.final_logit_softcap:g}, {n_params:,} parameters; heads "
          f"unpadded, {g['cut']}, ROADMAP C) through launch.serve.serve: "
          f"{b} x {s} prompt, {n_gen} decode steps ({card})")
    reset_all_launches()
    gen, info = serve.serve(cfg, params, requests=b, prompt_len=s, gen=n_gen,
                            device=dev, seed=0)
    torch.cuda.synchronize()
    launches = all_launches()
    print(f"  launch counters after the main path: {launches}")
    check(launches["flash_attention_tc"] == cfg.num_layers
          and info["prefill_flash_launches"] == cfg.num_layers
          and sum(launches.values()) == cfg.num_layers,
          f"{cfg.name}: launches {launches}; expected {cfg.num_layers} "
          f"tensor-core forwards (one a layer of the prefill), nothing else")
    check(gen.shape == (b, n_gen) and all(
        lg.shape == (b, cfg.vocab_size) and np.isfinite(lg).all()
        for lg in info["logits"]), f"{cfg.name}: generated {gen.shape}; "
                                   f"logits not finite or misshapen")
    print(f"  serve: prefill {info['prefill_s']:.3f} s (first call, "
          f"{info['prefill_tokens_per_s']:.0f} tokens/s), {n_gen} decode "
          f"steps {info['decode_ms_per_token']:.2f} ms/token")
    batch = serve.make_batch(cfg, b, s, rng=np.random.default_rng(0),
                             device=dev)
    with torch.no_grad():
        full = transformer.logits_of(
            params, transformer.forward(params, batch, cfg)[:, -1], cfg)
    err_c = dist(torch.from_numpy(info["logits"][0]).to(dev), full)
    print(f"  serve's prefill last-position logits vs the forward's: "
          f"max_abs_err {err_c:.3e} [rtol=atol=2e-2]")
    check(err_c <= 2e-2, f"{cfg.name}: prefill != forward ({err_c:.3e})")
    del full
    ext = serve.make_batch(cfg, b, s + n_tf, rng=np.random.default_rng(1),
                           device=dev)

    def zero(*keys):
        return lambda cc: [cc[k_].zero_() for k_ in keys]
    gate = teacher_gate(
        torch, params, cfg, ext, s, n_tf,
        {"local ring zeroed": zero("k", "v"),
         "global cache zeroed": zero("k2", "v2")}, serving, transformer)
    del ext
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            serving.prefill(params, batch, cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with torch.no_grad():
        _, cache = serving.prefill(params, batch, cfg, extra_slots=n_gen)
        rng = np.random.default_rng(2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_gen):
            tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, b)).to(dev)
            serving.decode_step(params, serve.token_to_batch(
                cfg, tok, s + i, b, rng, device=dev), cache, cfg)
        torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t0) / n_gen * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  warm prefill {walls[0]:.4f}/{walls[1]:.4f} s "
          f"({b * s / min(walls):.0f} tokens/s), warm decode {dec_ms:.2f} "
          f"ms/token, peak {peak_gb:.2f} GB on {card}")
    del params, cache, batch
    torch.cuda.empty_cache()
    return {"launches": launches, "params": n_params,
            "prefill_s_first": info["prefill_s"],
            "decode_ms_per_token_first": info["decode_ms_per_token"],
            "prefill_s_warm": walls, "prefill_tokens_per_s":
                b * s / min(walls), "decode_ms_per_token_warm": dec_ms,
            "peak_gb": peak_gb, "prefill_vs_forward_err": err_c, **gate}


def lg_train(np, torch, dev, card, cfg, c, positions=None):
    """``cfg`` (a published config cut as the phase cuts it, so not one
    launch.train.build builds) through make_train_step and ``train_run``:
    rows 11 and 11b on ``c['routes']`` in each of its layers."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.lm import LMDataConfig, SyntheticLM
    from repro_torch.models import steps
    step = steps.make_train_step(cfg, None, ShapeConfig(
        "lg", c["seq"], c["batch"], "train"),
        microbatches=c["microbatches"], total_steps=100)
    data = SyntheticLM(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=c["seq"], global_batch=c["batch"],
        microbatches=c["microbatches"]), cfg)
    first = "front_proj" if cfg.frontend_dim else "embed"
    return train_run(
        np, torch, dev, card, "local_global_vlm", (cfg, None, step, data), c,
        cfg.num_layers,
        {first: lambda p: p[first][:64],
         "layers/wi[0]": lambda p: p["layers"]["wi"][0, :64]},
        "", positions)


def train_run(np, torch, dev, card, phase, built, c, n_attn, snap, how,
              positions=None):
    """``built`` ((cfg, mesh, train_step, data), as launch.train.build
    gives them; mesh None: on ``dev``) trained from steps.init_state with
    every launch counter at 0 (c: batch x seq in microbatches, steps),
    ``positions`` (np, (batch, seq, 3)) in place of the corpus's. Each
    step launches rows 11 and 11b on ``c['routes']`` (forward key,
    backward key) in each of ``n_attn`` attention layers (the forward
    twice under remat) and nothing else; the first loss is within 1.5 of
    ln V; each leaf of ``snap`` ({name: params -> tensor}) moves. Then one
    traced step (the device split) and one microbatch's loss and every
    gradient leaf twice, bitwise."""
    from repro_torch.models import steps, transformer
    cfg, mesh, step, data = built
    fwd_key, bwd_key = c["routes"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = steps.init_state(cfg, seed=0, mesh=mesh, device=dev)
    n_params = tree_numel(state.params)
    tokens = c["batch"] * c["seq"]
    print(f"phase {phase}: {cfg.name} trained{how} ({cfg.num_layers} "
          f"layers, {n_params:,} parameters, {cfg.param_dtype} masters and "
          f"{cfg.opt_state_dtype} AdamW state, {cfg.dtype} activations, "
          f"remat {cfg.remat}) through "
          + ("launch.train.build -> " if mesh is not None else "")
          + f"steps.init_state -> make_train_step on cuda: batch "
          f"{c['batch']} x {c['seq']} in {c['microbatches']} microbatches, "
          f"{c['steps']} steps"
          + (", vision-grid positions" if positions is not None else "")
          + f" ({card})")
    grid = None
    if positions is not None:
        grid = torch.from_numpy(positions).to(dev).reshape(
            c["microbatches"], c["batch"] // c["microbatches"], c["seq"], 3)

    def batch_of(i):
        out = data.device_batch(i, dev)
        if grid is not None:
            check(out["positions"].shape == grid.shape,
                  f"corpus positions {tuple(out['positions'].shape)} != the "
                  f"grid's {tuple(grid.shape)}")
            out["positions"] = grid
        return out
    before = {k_: f(state.params).clone() for k_, f in snap.items()}
    reset_all_launches()
    losses, norms, walls = [], [], []
    for i in range(c["steps"]):
        batch = batch_of(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, i)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        walls.append(time.perf_counter() - t0)
        print(f"  step {i}: loss {losses[-1]:.4f} grad_norm {norms[-1]:.4f} "
              f"{walls[-1]:.3f} s", flush=True)
    launches = all_launches()
    per_step = n_attn * c["microbatches"]
    check(launches[fwd_key] == 2 * per_step * c["steps"]
          and launches[bwd_key] == per_step * c["steps"]
          and sum(launches.values()) == 3 * per_step * c["steps"],
          f"{cfg.name} steps launched {launches}; expected {2 * per_step} "
          f"{fwd_key} (forward and remat) and {per_step} {bwd_key} a step, "
          f"nothing else")
    check(abs(losses[0] - np.log(cfg.vocab_size)) <= 1.5,
          f"initial loss {losses[0]:.4f} is not within 1.5 of ln "
          f"{cfg.vocab_size}")
    check(np.isfinite(losses).all() and np.isfinite(norms).all(),
          f"non-finite loss or grad norm: {losses} {norms}")
    for k_, f in snap.items():
        check(not torch.equal(before[k_], f(state.params)),
              f"{k_} did not change")
    del before
    warm = min(walls[1:])
    batch = batch_of(c["steps"])
    wall, split, count, busy = traced_split(
        torch, lambda: step(state, batch, c["steps"]))
    share = 6 * n_params * tokens / warm / bf16_peak()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  warm {warm:.3f} s/step ({tokens / warm:.0f} tokens/s; 6 N "
          f"tokens / step time = {share * 100:.1f} % of the bf16 dense "
          f"peak), peak memory {peak_gb:.2f} GB; traced step (shapes "
          f"recorded): wall {wall:.3f} s, busy {busy * 100:.1f} %, device "
          f"{split_text(split, count)} on {card}")
    del batch
    mb = {k: (t if k == "adc_mask" else t[0])
          for k, t in batch_of(c["steps"] + 1).items()}
    differ, n_leaves = replay_grads(torch, state.params, mb, cfg, steps,
                                    transformer)
    print(f"  replay: one microbatch ({c['batch'] // c['microbatches']} x "
          f"{c['seq']}) loss and its {n_leaves - 1} gradient leaves twice: "
          + ("bitwise equal" if not differ else
             f"{len(differ)} differ: {differ[:12]}"))
    check(not differ, f"{cfg.name}: a replayed microbatch's gradients "
                      f"differ in {differ[:12]}")
    del state, data, step, mb, grid
    torch.cuda.empty_cache()
    return {"launches": launches, "losses": losses, "grad_norms": norms,
            "step_s": walls, "warm_step_s": warm,
            "tokens_per_s": tokens / warm, "bf16_peak_share": share,
            "params": n_params, "peak_gb": peak_gb, "traced_wall_s": wall,
            "device_ms": split, "device_kernels": count,
            "device_busy_share": busy, "replay_bitwise": not differ,
            "replay_leaves": n_leaves - 1}


def qwen_fits(torch, cfg, bytes_per_param, reserve_gb) -> None:
    """Fails unless the card's free memory holds ``cfg``'s parameters
    (its layers, the head and the frontend) at ``bytes_per_param`` each
    beside ``reserve_gb`` for the work."""
    free, _ = torch.cuda.mem_get_info()
    layer = (cfg.replace(num_layers=2).param_counts()["total"]
             - cfg.replace(num_layers=1).param_counts()["total"])
    rest = (cfg.vocab_size + cfg.frontend_dim + 1) * cfg.d_model
    need = ((cfg.num_layers * layer + rest) * bytes_per_param
            + reserve_gb * 1e9)
    check(need <= free, f"{cfg.name} at {cfg.num_layers} layers needs "
                        f"{need / 1e9:.1f} GB, the card has {free / 1e9:.1f}"
                        f" GB free")


def qwen_inputs(np, torch, cfg, b, grid, text, rng, dev):
    """Frontend inputs of a vision prompt: random patch embeddings in [0,
    1) through all ADC levels, and its M-RoPE grid positions."""
    from repro_torch.data.lm import mrope_grid_positions
    from repro_torch.launch import serve
    pos = mrope_grid_positions(b, [grid], text)
    out = serve._frontend_inputs(cfg, b, pos.shape[1], rng, dev)
    out["positions"] = torch.from_numpy(pos).to(dev)
    return out


def qwen2_vl(np, torch, dev, card):
    """qwen2-vl-72b at its published widths, cut in depth to
    QWEN['layers'] (checked against the card's free memory): a vision
    prompt (an image of QWEN['grid'] patches at its M-RoPE grid
    positions, then text) through steps.make_prefill_step /
    make_decode_step with every launch counter at 0 (the tensor-core
    forward once a layer of the prefill, nothing else); M-RoPE's witness
    (the grid against its t component alone, the float32 forward's final
    hidden states); decode == teacher forcing after a text prompt of the
    same length (after a vision grid the reference's cache bookkeeping
    drops keys, ROADMAP C) in float32 (a zeroed cache and the layers'
    caches rolled by one as controls) and in bf16 held to the float32
    forward; then trained at QWEN_TRAIN's depth on the grid, replayed
    bitwise."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import serving, steps, transformer
    q = QWEN
    full = get_config(q["arch"])
    check_published(full)
    b, n_gen, n_tf = q["requests"], q["gen"], q["teacher"]
    grid, text = q["grid"], q["text"]
    s = grid[0] * grid[1] * grid[2] + text
    torch.cuda.empty_cache()
    depth = q["layers"]
    cfg = full.replace(num_layers=depth)
    qwen_fits(torch, cfg, 4, q["reserve_gb"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = transformer.init_params(cfg, seed=0, device=dev)
    n_params = tree_numel(params)
    print(f"phase local_global_vlm: {cfg.name} at its published widths "
          f"(d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads over {cfg.num_kv_heads} of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, frontend {cfg.frontend_dim} through the "
          f"{cfg.adc.bits}-bit ADC, M-RoPE sections {cfg.mrope_sections}, "
          f"theta {cfg.rope_theta:g}), cut in depth {full.num_layers} -> "
          f"{depth} layers (float32 masters beside {q['reserve_gb']} GB of "
          f"work), {n_params:,} parameters: "
          f"{b} x {s} vision prompts (an image of {grid} patches, then "
          f"{text} text tokens), {n_gen} decode steps ({card})")
    rng = np.random.default_rng(0)
    batch = qwen_inputs(np, torch, cfg, b, grid, text, rng, dev)
    prefill = steps.make_prefill_step(cfg)
    decode = steps.make_decode_step(cfg)
    reset_all_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    nxt = int(batch["positions"][0, -1, 0]) + 1
    outs = [logits]
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(n_gen):
            sb = serve._frontend_inputs(cfg, b, 1, rng, dev)
            sb["positions"] = torch.full((b, 1, 3), nxt + i, dtype=torch.int32,
                                         device=dev)
            logits, cache = decode(params, sb, cache)
            outs.append(logits)
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t0) / n_gen * 1e3
    launches = all_launches()
    print(f"  launch counters after the main path: {launches}")
    check(launches["flash_attention_tc"] == depth
          and sum(launches.values()) == depth,
          f"{cfg.name}: launches {launches}; expected {depth} tensor-core "
          f"forwards (one a layer of the prefill), nothing else")
    check(all(o.shape == (b, cfg.vocab_size) and bool(torch.isfinite(o).all())
              for o in outs), f"{cfg.name}: logits not finite or misshapen")
    check(int(cache["pos"]) == nxt + n_gen, f"{cfg.name}: the cache's pos "
                                            f"{int(cache['pos'])}")
    del cache
    # M-RoPE's witness: the float32 forward's final hidden states (unit
    # RMS) on the grid against those with its t component in all three
    c32 = cfg.replace(dtype="float32")
    flat = dict(batch, positions=batch["positions"][..., :1].expand(
        -1, -1, 3).contiguous())
    with torch.no_grad():
        full_lg = transformer.logits_of(
            params, transformer.forward(params, batch, cfg)[:, -1], cfg)
        wit = dist(transformer.forward(params, batch, c32),
                   transformer.forward(params, flat, c32))
    err_c = dist(outs[0], full_lg)
    print(f"  prefill {t_pre:.3f} s ({b * s / t_pre:.0f} tokens/s, first "
          f"call), decode {dec_ms:.2f} ms/token; prefill's last-position "
          f"logits vs the forward's {err_c:.3e} [2e-2]; M-RoPE witness: the "
          f"same prompt with its t component in all three moves the float32 "
          f"forward's final hidden states by {wit:.3e} [> {QWEN_WITNESS:g}]")
    check(err_c <= 2e-2, f"{cfg.name}: prefill != forward ({err_c:.3e})")
    check(wit > QWEN_WITNESS, f"{cfg.name}: the vision grid's h and w "
                              f"components move the float32 forward by only "
                              f"{wit:.3e}")
    del full_lg, flat, outs
    # the cache gate on a text prompt: after a vision grid the reference's
    # kpos and ring slot read position as token count (ROADMAP C), so
    # decode there is not teacher forcing in either package
    ext = serve.make_batch(cfg, b, s + n_tf, rng=np.random.default_rng(1),
                           device=dev)
    controls = {"k/v cache zeroed": lambda cc: (cc["k"].zero_(),
                                                cc["v"].zero_()),
                "each layer reading the next layer's cache":
                lambda cc: (cc["k"].copy_(torch.roll(cc["k"], 1, 0)),
                            cc["v"].copy_(torch.roll(cc["v"], 1, 0)))}
    gate = teacher_gate(torch, params, cfg, ext, s, n_tf, controls,
                           serving, transformer)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            prefill(params, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  warm prefill {walls[0]:.4f}/{walls[1]:.4f} s "
          f"({b * s / min(walls):.0f} tokens/s), peak {peak_gb:.2f} GB on "
          f"{card}")
    del params, batch, ext
    torch.cuda.empty_cache()
    serve_out = {"launches": launches, "layers": depth, "params": n_params,
                 "prefill_s_first": t_pre, "decode_ms_per_token": dec_ms,
                 "prefill_s_warm": walls,
                 "prefill_tokens_per_s": b * s / min(walls),
                 "peak_gb": peak_gb, "prefill_vs_forward_err": err_c,
                 "mrope_witness": wit, **gate}
    t = QWEN_TRAIN
    tcfg = full.replace(num_layers=t["num_layers"])
    from repro_torch.data.lm import mrope_grid_positions
    pos = mrope_grid_positions(t["batch"], [t["grid"]], t["text"])
    check(pos.shape[1] == t["seq"], f"the training grid spans "
                                    f"{pos.shape[1]} tokens, not {t['seq']}")
    train_out = lg_train(np, torch, dev, card, tcfg, t, positions=pos)
    return serve_out, train_out


def phase_local_global_vlm(np, torch, dev, card, clock):
    """The local_global and vlm families (ROADMAP A11.4-A11.5) on the
    card: rows 11 and 11b at gemma2's layer (dh 256); gemma2-2b served
    and trained uncut at 1 x 8192; qwen2-vl-72b at full width, cut in
    depth, served on a vision grid and trained; the smoke configs card
    against CPU. Returns the main path's launch counts (the serve calls
    and the train steps, each counted from 0) and the numbers."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    max_err, rows = lg_attention_kernels(np, torch, dev, card, clock)
    out = {"max_err": max_err, "layer_rows": rows}
    launches = {}

    def add(res):
        for name, n in res.pop("launches").items():
            launches[name] = launches.get(name, 0) + n
        return res
    out["gemma2_serve"] = add(gemma2_serve(np, torch, dev, card))
    gcfg = get_config(GEMMA["arch"]).replace(**GEMMA["cut"])
    out["gemma2_train"] = add(lg_train(np, torch, dev, card, gcfg,
                                       GEMMA_TRAIN))
    vserve, vtrain = qwen2_vl(np, torch, dev, card)
    out["qwen2_vl_serve"], out["qwen2_vl_train"] = add(vserve), add(vtrain)
    out["smoke_launches"] = smoke_card_vs_cpu(np, torch, dev, card,
                                              "local_global_vlm", LG_SMOKE)
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase local_global_vlm: {out['phase_s']:.2f} s on {card}; "
          f"launches on the local_global_vlm path: {launches}")
    return out


# ---------------------------------------------------------------- dp
def dp_ring_checks(np, torch, dev, card):
    """Part 1 of phase dp_train: ring_allreduce_int8 (n = 2, 3, 8),
    compressed_mean (pod 2 x data 2) and 8 syncs of sync_grads, every
    rank on the card, bitwise against the same calls on the CPU."""
    from repro_torch.optim import compression
    c = DP_RING
    xs = np.random.default_rng(c["seed"]).normal(
        size=(c["rows"], c["cols"])).astype(np.float32)

    def on(d, rows):
        return [torch.from_numpy(x.copy()).to(d) for x in rows]

    def host(ts):
        return [t.cpu() for t in ts]

    out = {}
    for n in c["ns"]:
        cpu = compression.ring_allreduce_int8(on("cpu", xs[:n]), n)
        got = host(compression.ring_allreduce_int8(on(dev, xs[:n]), n))
        check(all(torch.equal(a, b) for a, b in zip(got, cpu)),
              f"the int8 ring at n={n}: the card's output is not the CPU's")
        check(all(torch.equal(g, got[0]) for g in got),
              f"the int8 ring at n={n}: the ranks' outputs differ")
        scale = float(np.abs(xs[:n]).max()) / 127.0
        err = float(np.abs(got[0].numpy() - xs[:n].mean(0)).max())
        check(err <= (n + 1) / 4 * scale,
              f"the int8 ring at n={n}: max |ring - mean| {err:.4g} > "
              f"{(n + 1) / 4} x the step {scale:.4g}")
        out[f"ring_n{n}_err_steps"] = err / scale
    cpu = compression.compressed_mean(on("cpu", xs[:4]), ("pod", "data"),
                                      (2, 2))
    got = host(compression.compressed_mean(on(dev, xs[:4]), ("pod", "data"),
                                           (2, 2)))
    check(all(torch.equal(a, b) for a, b in zip(got, cpu))
          and torch.equal(got[0], got[1]) and torch.equal(got[2], got[3]),
          "compressed_mean at pod 2 x data 2: the card is not the CPU, or "
          "ranks of one pod differ")
    out["pods_max_diff"] = float((got[0] - got[2]).abs().max())

    rng = np.random.default_rng(1)
    r = c["ef_ranks"]
    w = rng.normal(size=(r, 30, 10)).astype(np.float32)
    b = (rng.normal(size=(r, 7, 11)) * 3).astype(np.float32)
    z = (rng.normal(size=(r, 50)) * 1e-3).astype(np.float32)
    cc = rng.normal(size=(r, 64)).astype(np.float32)

    def grads(d):
        return [{"w": torch.from_numpy(w[k]).to(d),
                 "b": torch.from_numpy(b[k]).to(d).to(torch.bfloat16),
                 "a": {"z": torch.from_numpy(z[k]).to(d),
                       "c": torch.from_numpy(cc[k]).to(d).to(torch.bfloat16)}}
                for k in range(r)]

    def syncs(d, zero):
        g = grads(d)
        err = compression.init_error_buffer(g[0], r, [d] * r)
        outs = []
        for _ in range(c["ef_steps"]):
            if zero:
                err = [torch.zeros_like(e) for e in err]
            o, err = compression.sync_grads(g, err, ("data",), (r,))
            outs.append(([x["w"].cpu() for x in o], host(err)))
        return outs

    cpu, got = syncs("cpu", False), syncs(dev, False)
    check(all(torch.equal(a, b_) for (ow, oe), (cw, ce) in zip(got, cpu)
              for a, b_ in zip(ow + oe, cw + ce)),
          "sync_grads: the card's synced leaves or error rows are not the "
          "CPU's")
    want = w.mean(0)

    def ef(outs):
        first = np.abs(outs[0][0][0].numpy() - want).max()
        avg = np.abs(np.mean([o[0][0].numpy() for o in outs], 0)
                     - want).max()
        return float(first), float(avg)
    first, avg = ef(got)
    zfirst, zavg = ef(syncs(dev, True))
    check(avg < first, f"error feedback: the 8 syncs' average is "
                       f"{avg:.4g} from the mean, the first {first:.4g}")
    check(not zavg < zfirst, f"the control (error rows zeroed) passes the "
                             f"error-feedback check: {zavg:.4g} < {zfirst:.4g}")
    out.update(ef_first=first, ef_avg=avg, ef_control=(zfirst, zavg))
    print(f"phase dp_train (1/3): the int8 ring on [cuda:0] x n == the CPU "
          f"bitwise at n = {c['ns']} (max |ring - mean| in int8 steps: "
          + ", ".join(f"{out[f'ring_n{n}_err_steps']:.3f}" for n in c["ns"])
          + f"; bounds (n + 1) / 4), pod 2 x data 2 == the CPU (pods "
          f"{out['pods_max_diff']:.3g} apart, as in the reference), "
          f"sync_grads x {c['ef_steps']} over {r} ranks == the CPU with its "
          f"error rows; error feedback: the average {avg:.4g} < the first "
          f"{first:.4g}; control (rows zeroed): {zavg:.4g}, not below "
          f"{zfirst:.4g} ({card})")
    return out


def check_musicgen(cfg) -> None:
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size, cfg.dtype,
           cfg.param_dtype, cfg.opt_state_dtype, cfg.remat)
          == (48, 1536, 24, 24, 64, 6144, 2048, "bfloat16", "float32",
              "float32", "full"), f"{cfg.name} is not at its published "
                                  f"config")


def dp_rank_mean(torch, state, batch, base, half, mb, dp):
    """Each rank's rows of ``batch`` through the one-device gradient step
    of ``base``: (their float32 mean in rank order, each rank's largest
    gradient), what the int8 ring approximates."""
    from repro_torch.models import steps
    from repro_torch.optim import adamw
    gsr = steps.make_grad_step(base, None, half, mb)
    per = half.global_batch // mb
    acc, amax = None, []
    for r in range(dp):
        part = {k: (v if k == "adc_mask" else v[:, r * per:(r + 1) * per])
                for k, v in batch.items()}
        g = adamw.tree_leaves(gsr(state, part)[0])
        amax.append(max(float(t.abs().max()) for t in g))
        if acc is None:
            acc = [t.float() for t in g]
        else:
            for a, t in zip(acc, g):
                a.add_(t.float())
        del g
    for a in acc:
        a.div_(dp)
    return acc, amax


@contextlib.contextmanager
def timed_sync(torch, times):
    """compression.local_quantize and compressed_mean, as the train step
    calls them, each call's host-clock seconds (synchronized before and
    after) appended to ``times``."""
    from repro_torch.optim import compression
    fns = {k: getattr(compression, k)
           for k in ("local_quantize", "compressed_mean")}

    def timed(fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return res
        return run
    for k, fn in fns.items():
        setattr(compression, k, timed(fn))
    try:
        yield
    finally:
        for k, fn in fns.items():
            setattr(compression, k, fn)


def dp_musicgen(np, torch, dev, card):
    """Parts 2 and 3 of phase dp_train: musicgen-medium at its published
    config trained with int8 compression at data 2 on [cuda:0, cuda:0]
    (memory reckoning, a replayed gradient step bitwise, the synced
    gradients within DP_INT8_STEPS of the ranks' float32 mean and their
    distance from the one-device step's, 4 steps timed, one with the
    sync timed), every launch counter at 0 around the 4 steps."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.lm import LMDataConfig, SyntheticLM
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import steps
    from repro_torch.optim import adamw
    c = DP_TRAIN
    base = get_config(c["arch"])
    check_musicgen(base)
    cfg8 = base.replace(grad_compression="int8")
    mb, dp = c["microbatches"], c["data"]
    mesh = mesh_lib.make_mesh((dp, 1), ("data", "model"), devices=[dev] * dp)
    shape = ShapeConfig("dp", c["seq"], c["batch"], "train")
    n = base.param_counts()["total"]
    tokens = c["batch"] * c["seq"]
    gb = lambda b: b * n / 1e9                                  # noqa: E731
    # two moments of the step: a rank's backward (phase train's activations:
    # its 37.41 GB peak on an H100 at 700 W, PERF.md, less params, m, v and
    # a gradient sum), and the ring's all-gather (the step's largest)
    states = [("params", gb(4)), ("AdamW m and v", gb(8)),
              (f"err, {dp} bf16 rows", gb(2 * dp))]
    backward = states + [
        ("rank 0's quantized vector and new err row", gb(4 + 2)),
        ("rank 1's float32 gradient sum", gb(4)),
        ("activations", 37.41 - gb(16))]
    gather = states + [
        (f"new err, {dp} bf16 rows", gb(2 * dp)),
        (f"{dp} padded float32 ring vectors (inputs, then outputs)",
         gb(4 * dp)),
        ("owned chunks, int8 messages, a dequantized chunk",
         gb(4 + 1 + 4 / dp))]
    total = max(sum(v for _, v in r) for r in (backward, gather))
    torch.cuda.empty_cache()
    free, whole = torch.cuda.mem_get_info()
    print(f"phase dp_train (2/3): {cfg8.name} at its published config "
          f"({n:,} parameters, bf16 activations, float32 params and AdamW, "
          f"remat full), grad_compression=int8, data {dp} on "
          f"{[str(d) for d in mesh.devices.reshape(-1)]}: batch "
          f"{c['batch']} x {c['seq']} in {mb} microbatches, {c['steps']} "
          f"steps, uncut; memory reckoning (GB) at a rank's backward: "
          + "; ".join(f"{k} {v:.1f}" for k, v in backward)
          + f" (total {sum(v for _, v in backward):.1f}); at the ring's "
          f"all-gather: "
          + "; ".join(f"{k} {v:.1f}" for k, v in gather)
          + f" (total {sum(v for _, v in gather):.1f}); of "
          f"{whole / 1e9:.1f} ({free / 1e9:.1f} free) ({card})", flush=True)
    check(total < free / 1e9, f"the reckoning {total:.1f} GB exceeds the "
                              f"free {free / 1e9:.1f} GB")
    data = SyntheticLM(LMDataConfig(vocab_size=base.vocab_size,
                                    seq_len=c["seq"], global_batch=c["batch"],
                                    microbatches=mb), base)
    state = steps.init_state(cfg8, seed=0, mesh=mesh)
    gs8 = steps.make_grad_step(cfg8, mesh, shape, mb)
    batch = data.device_batch(0, dev)
    leaves = adamw.tree_leaves

    def timed(fn, *a, host=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*a)
        if host is not None:            # the host's issue time alone
            host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0
    (g8, l8, e8), t_g8 = timed(gs8, state, batch)
    host_g, host_e = [t.cpu() for t in leaves(g8)], [e.cpu() for e in e8]
    del g8, e8
    g8_host = []
    (g8b, l8b, e8b), g8_wall = timed(gs8, state, batch, host=g8_host)
    same = torch.equal(l8, l8b) and all(
        torch.equal(a.cpu(), b) for a, b in zip(leaves(g8b) + e8b,
                                                host_g + host_e))
    print(f"  int8 gradient step replayed bitwise {same}: the host issued "
          f"it in {g8_host[0]:.3f} s of its {g8_wall:.3f} s wall (every "
          f"rank's work from one thread, tensor_parallel.map_ranks) "
          f"({card})", flush=True)
    check(same, "a replayed int8 gradient step is not bitwise the first")
    del g8b, e8b

    # each rank's rows on one device: the float32 mean the ring
    # approximates, and each rank's largest gradient for the bound
    mean, amax = dp_rank_mean(torch, state, batch, base,
                              half=ShapeConfig("dp-rank", c["seq"],
                                               c["batch"] // dp, "train"),
                              mb=mb, dp=dp)
    big = max(amax)
    step = big / 127.0
    worst = max(float((a.to(dev) - u).abs().max())
                for a, u in zip(host_g, mean))
    check(worst <= DP_INT8_STEPS * step + 1e-6 * big,
          f"int8 against the ranks' float32 mean at data {dp}: max |diff| "
          f"{worst:.4g} > {DP_INT8_STEPS} int8 steps of the largest "
          f"gradient ({step:.4g})")
    del mean

    # the one-device gradient step on the same state and batch: the
    # int8 step's distance from it (the uncompressed data-2 step is FSDP's
    # since PR 35: phase fsdp holds it against one card)
    gs1 = steps.make_grad_step(base, None, shape, mb)
    (g1, l1, _), t_g1 = timed(gs1, state, batch)
    vs_uncompressed = max(float((a.to(dev) - u).abs().max())
                          for a, u in zip(host_g, leaves(g1))) / step
    del host_g, host_e, g1

    # 4 int8 steps from the same state, every launch counter at 0
    step8 = steps.make_train_step(cfg8, mesh, shape, mb, total_steps=100)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    losses, norms, walls, err_max = [], [], [], []
    for i in range(c["steps"]):
        b = data.device_batch(i, dev)
        (state, m), wall = timed(step8, state, b, i)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        walls.append(wall)
        err_max.append(max(float(e.float().abs().max()) for e in state.err))
        print(f"  int8 step {i}: loss {losses[-1]:.4f} grad_norm "
              f"{norms[-1]:.4f} err absmax {err_max[-1]:.4g} "
              f"{wall:.3f} s", flush=True)
    launches = all_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = base.num_layers * mb * dp
    check(launches["flash_attention_tc"] == 2 * per_step * c["steps"]
          and launches["flash_attention_bwd_tc"] == per_step * c["steps"]
          and launches["flash_attention"] == 0
          and launches["flash_attention_bwd"] == 0,
          f"the int8 data-{dp} steps launched {launches}; expected "
          f"{2 * per_step} tensor-core forwards and {per_step} tensor-core "
          f"backwards a step, nothing on the CUDA cores")
    check(abs(losses[0] - np.log(base.vocab_size)) <= 1.5
          and np.isfinite(losses).all() and np.isfinite(norms).all()
          and np.isfinite(err_max).all() and 0 < err_max[0],
          f"losses {losses}, grad norms {norms}, err absmax {err_max}")
    warm = min(walls[1:])
    # one more step with the sync timed (synchronized around each call)
    times = []
    with timed_sync(torch, times):
        (state, _), t_sync_step = timed(step8, state,
                                        data.device_batch(c["steps"], dev),
                                        c["steps"])
    sync_ms = sum(times) * 1e3
    # s/step of the one-device step (timed on its second call)
    step1 = steps.make_train_step(base, None, shape, mb, total_steps=100)
    st = state._replace(err=None)
    t_1 = []
    for i in range(2):
        (st, _), t = timed(step1, st, data.device_batch(20 + i, dev), 20 + i)
        t_1.append(t)
    # one traced int8 data-2 step and one traced one-device step (the
    # uncompressed config's, same state): device ms, kernels, busy share
    # over the untraced warm step (the profiler stretches the traced one)
    traces = {name: traced_step(torch, fn, st, data.device_batch(30 + k,
                                                                 dev),
                                30 + k, untraced)
              for k, (name, fn, st, untraced) in enumerate((
                  ("int8_dp", step8, state, warm),
                  ("one_device", step1, state._replace(err=None),
                   t_1[-1])))}
    out = {"launches": launches, "losses": losses, "grad_norms": norms,
           "step_s": walls, "warm_step_s": warm, "tokens_per_s": tokens / warm,
           "peak_gb": peak_gb, "reckoning_gb": total, "err_absmax": err_max,
           "sync_ms": sync_ms, "sync_calls": len(times),
           "sync_step_s": t_sync_step, "sync_share": sync_ms / 1e3 / t_sync_step,
           "grad_step_s": {"int8": t_g8, "one_device": t_g1},
           "int8_replay_host_s": g8_host[0], "int8_replay_wall_s": g8_wall,
           "int8_vs_rank_mean_steps": worst / step,
           "int8_vs_uncompressed_steps": vs_uncompressed,
           "rank_grad_amax": amax,
           "one_device_step_s": t_1[-1],
           "traced": traces}
    print(f"  int8 data {dp}: warm {warm:.3f} s/step ({tokens / warm:.0f} "
          f"tokens/s), peak memory {peak_gb:.2f} GB (reckoned {total:.1f}); "
          f"the sync (local_quantize x {dp}, compressed_mean) {sync_ms:.1f} "
          f"ms of a {t_sync_step:.3f} s step "
          f"({out['sync_share'] * 100:.1f} %); launches {launches}; "
          f"replayed gradient step bitwise; int8 against the ranks' "
          f"float32 mean {worst / step:.3f} int8 steps of the largest "
          f"gradient {big:.4g} (bound {DP_INT8_STEPS}), against the "
          f"uncompressed step {vs_uncompressed:.3f} ({card})")
    print(f"phase dp_train (3/3): s/step one device {t_1[-1]:.3f}, "
          f"int8 data {dp} {warm:.3f}; gradient steps int8 {t_g8:.3f} s, "
          f"one device {t_g1:.3f} s; traced "
          + "; ".join(f"{k}: device {v['device_ms']:.1f} ms in "
                      f"{v['kernels']} kernels, busy {v['busy'] * 100:.1f} "
                      f"% of the untraced {v['untraced_wall_s']:.3f} s "
                      f"({v['busy_traced'] * 100:.1f} % of the traced wall "
                      f"{v['wall_s']:.3f} s)"
                      for k, v in traces.items())
          + f" ({card})")
    del state, st, data
    torch.cuda.empty_cache()
    return out


def traced_step(torch, step, state, batch, i, untraced_wall) -> dict:
    """One train step under torch.profiler: its wall s, device ms, device
    kernels and the busy share: device time over ``untraced_wall`` (the
    same step's warm wall without the profiler, which stretches the host
    side of every launch), and over the traced wall."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    us, count, _ = device_sums(torch, prof)
    ms = sum(us.values()) / 1e3
    return {"wall_s": wall, "device_ms": ms, "kernels": sum(count.values()),
            "untraced_wall_s": untraced_wall,
            "busy": ms / 1e3 / untraced_wall, "busy_traced": ms / 1e3 / wall,
            "flash_ms": (us["fwd"] + us["flash_attention_bwd_tc"]) / 1e3}


def phase_dp_train(np, torch, dev, card):
    """The data-parallel path (ROADMAP A11.6 and A11.9's dp half): the
    int8 ring on the card against the CPU; musicgen-medium trained with
    int8 at data 2 on [cuda:0, cuda:0]. Returns the numbers and the 4
    int8 steps' launch counts."""
    t_phase = time.perf_counter()
    out = {"ring": dp_ring_checks(np, torch, dev, card)}
    out.update(dp_musicgen(np, torch, dev, card))
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase dp_train: {out['phase_s']:.2f} s on {card}; launches on "
          f"the dp_train path: {out['launches']}")
    return out


# phase dryrun (ROADMAP A11.7-A11.8): production cells of the dry run at
# the single mesh; kimi-k2's train cell routes its moe layers on meta
DRYRUN_CELLS = (("musicgen-medium", "train_4k"),
                ("musicgen-medium", "prefill_32k"),
                ("musicgen-medium", "decode_32k"),
                ("kimi-k2-1t-a32b", "train_4k"))


def op_diff(a, b) -> dict:
    """{op: (a's [calls, bytes], b's)} where two counts' ops differ."""
    return {k: (a.get(k), b.get(k)) for k in sorted(set(a) | set(b))
            if a.get(k) != b.get(k)}


def dryrun_card_vs_meta(np, torch, dev, card):
    """Part 1 of phase dryrun: musicgen-medium's TRAIN step counted on the
    card (the real step, rows 11 and 11b launching) and on meta, equal;
    the H100 roofline of the count against the measured step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, train
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import steps
    analysis = port_analysis()
    c = TRAIN
    cfg, mesh, train_step, data = train.build(
        c["arch"], smoke=False, seq=c["seq"], batch=c["batch"],
        microbatches=c["microbatches"], steps_total=100, device="cuda")
    check_musicgen(cfg)
    shape = ShapeConfig("train", c["seq"], c["batch"], "train")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = steps.init_state(cfg, seed=0, mesh=mesh)
    reset_all_launches()
    walls = []
    for i in range(2):                    # warm-up, then the timed step
        batch = data.device_batch(i, mesh.first_device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, batch, i)
        float(m["loss"])
        walls.append(time.perf_counter() - t0)
    warm = walls[-1]
    batch = data.device_batch(2, mesh.first_device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card, (state, m) = analysis.count_step(train_step, state, batch, 2)
    loss = float(m["loss"])
    counted_s = time.perf_counter() - t0
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    per_step = cfg.num_layers * c["microbatches"]
    fwd = (2 if cfg.remat == "full" else 1) * per_step    # remat: twice
    check(launches["flash_attention_tc"] == 3 * fwd
          and launches["flash_attention_bwd_tc"] == 3 * per_step
          and sum(launches.values()) == 3 * (fwd + per_step),
          f"the three steps launched {launches}; expected {fwd} "
          f"tensor-core forwards and {per_step} backwards a step")
    check(np.isfinite(loss), f"non-finite loss {loss}")
    t0 = time.perf_counter()
    on_meta, _ = analysis.count_step(
        train_step, dryrun.meta_state(cfg),
        {k: torch.empty_like(v, device="meta") for k, v in batch.items()},
        2)
    meta_s = time.perf_counter() - t0
    units = analysis.unit_calls(on_card)
    print(f"phase dryrun (1/2): {cfg.name}'s train step ({c['batch']} x "
          f"{c['seq']} in {c['microbatches']} microbatches) counted by "
          f"analysis.count_step on the card (the real step, {counted_s:.2f} "
          f"s with the counter; warm {warm:.3f} s/step without) and on meta "
          f"({meta_s:.2f} s): FLOPs {on_card.flops:.6e} / {on_meta.flops:.6e}"
          f", matrix products {on_card.dot_ops} / {on_meta.dot_ops}, units "
          f"{units} / {analysis.unit_calls(on_meta)}, traffic "
          f"{on_card.traffic_bytes:.6e} / {on_meta.traffic_bytes:.6e} B, "
          f"copies between devices {on_card.transfers} / "
          f"{on_meta.transfers} ({card})")
    check(on_card.flops == on_meta.flops
          and on_card.dot_ops == on_meta.dot_ops
          and on_card.kernel_units == on_meta.kernel_units,
          f"card != meta: FLOPs {on_card.flops} / {on_meta.flops}, "
          f"products {on_card.dot_ops} / {on_meta.dot_ops}, units "
          f"{on_card.kernel_units} / {on_meta.kernel_units}")
    check(units == {"flash_attention": fwd, "flash_attention_bwd": per_step},
          f"the count saw units {units}; the step launched {fwd} forwards "
          f"and {per_step} backwards")
    differ = op_diff(on_card.ops, on_meta.ops)
    check(on_card.traffic_bytes == on_meta.traffic_bytes and not differ
          and on_card.transfers == on_meta.transfers,
          f"card != meta in traffic: {on_card.traffic_bytes} / "
          f"{on_meta.traffic_bytes} B; ops (card, meta) {differ}; copies "
          f"between devices {on_card.transfers} / {on_meta.transfers}")
    mf = analysis.model_flops(cfg, shape)
    roof = analysis.roofline(
        on_card, chips=1, model_flops_global=mf,
        ideal_bytes_per_dev=analysis.ideal_bytes(cfg, shape, 1,
                                                 c["microbatches"]),
        machine=analysis.H100)
    bound_s = max(roof["compute_s"], roof["memory_s"], roof["collective_s"])
    structs, _ = dryrun.state_structs(cfg, AbstractMesh((1, 1),
                                                        ("data", "model")))
    batch_b = float(sum(t.numel() * t.element_size()
                        for t in batch.values()))
    args = {"params": dryrun.bytes_per_device(structs.params),
            "opt": dryrun.bytes_per_device(structs.opt), "inputs": batch_b}
    args["total"] = sum(args.values())
    unit_flops = sum(u["flops"] for u in on_card.kernel_units.values())
    print(f"  counted FLOPs / 6 N D = {on_card.flops / mf:.4f} (remat "
          f"counted; attention {unit_flops:.4e} FLOPs in units); H100 "
          f"(data sheet): compute "
          f"{roof['compute_s']:.4f} s, memory {roof['memory_s']:.4f} s, "
          f"dominant {roof['dominant']}; measured warm {warm:.4f} s/step = "
          f"{warm / bound_s:.2f} x the bound; the largest traffic "
          f"{on_card.top_traffic[:5]}; argument bytes "
          f"{args['total'] / 1e9:.3f} GB (params "
          f"{args['params'] / 1e9:.3f}, AdamW "
          f"{args['opt'] / 1e9:.3f}, batch {batch_b / 1e9:.4f}) against the "
          f"measured peak {peak / 1e9:.3f} GB ({card})")
    check(args["total"] <= peak,
          f"the dry run's argument bytes {args['total']} exceed the "
          f"measured peak {peak}")
    del state, batch, data, train_step
    torch.cuda.empty_cache()
    return {"launches": launches, "warm_step_s": warm,
            "counted_step_s": counted_s, "meta_count_s": meta_s,
            "flops": on_card.flops, "flops_over_6nd": on_card.flops / mf,
            "traffic_bytes": on_card.traffic_bytes,
            "dot_ops": on_card.dot_ops, "units": on_card.kernel_units,
            "transfers": on_card.transfers, "roofline": roof,
            "bound_s": bound_s, "warm_over_bound": warm / bound_s,
            "peak_bytes": peak, "argument_bytes": args,
            "top_traffic": on_card.top_traffic}


def dryrun_cells(card):
    """Part 2 of phase dryrun: launch/dryrun.run_cell at the single
    production mesh for DRYRUN_CELLS, each ok; the records' numbers are
    the H100 row's data-sheet estimates."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun
    out, memo = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for arch, shape in DRYRUN_CELLS:
            rec = dryrun.run_cell(arch, SHAPES[shape], "single", Path(tmp),
                                  force=True, memo=memo)
            check(rec["ok"], f"dry run {arch} {shape}: {rec.get('error')}\n"
                             f"{rec.get('traceback')}")
            r = rec["roofline"]
            out[f"{arch} {shape}"] = {
                k: rec[k] for k in ("count_s", "rows_per_device",
                                    "model_division", "bytes_per_device")
            } | {"n_microbatches": rec.get("n_microbatches"),
                 "flops": rec["step_stats"]["flops"],
                 "traffic_bytes": rec["step_stats"]["traffic_bytes"],
                 "units": rec["step_stats"]["kernel_units"],
                 "roofline": r}
            print(f"phase dryrun (2/2): {arch} {shape} single mesh: ok in "
                  f"{rec['count_s']:.2f} s; {rec['rows_per_device']} rows a "
                  f"device, work / {rec['model_division']}; counted / model "
                  f"FLOPs {1 / r['useful_flops_ratio']:.4f}; dominant "
                  f"{r['dominant']} (compute {r['compute_s']:.4e} s, memory "
                  f"{r['memory_s']:.4e} s, collective "
                  f"{r['collective_s']:.4e} s: data-sheet estimates); "
                  f"{rec['bytes_per_device']['total'] / 1e9:.3f} GB a device "
                  f"({card})", flush=True)
    return out


def phase_dryrun(np, torch, dev, card):
    """The LM dry run and its roofline analysis (ROADMAP A11.7-A11.8)."""
    t_phase = time.perf_counter()
    out = dryrun_card_vs_meta(np, torch, dev, card)
    out["cells"] = dryrun_cells(card)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase dryrun: {out['phase_s']:.2f} s on {card}; launches on "
          f"the dryrun path: {out['launches']}")
    return out


# ---------------------------------------------------------------- tp
def tp_meshes(torch):
    """The phase's (1, 2) meshes: one card repeated, and two distinct
    cards where the machine has them."""
    from repro_torch.launch import mesh as mesh_lib
    out = {"repeated": mesh_lib.make_mesh(
        (1, 2), ("data", "model"), devices=["cuda:0", "cuda:0"])}
    if torch.cuda.device_count() >= 2:
        out["distinct"] = mesh_lib.make_mesh(
            (1, 2), ("data", "model"), devices=["cuda:0", "cuda:1"])
    return out


def tp_counts(launches, total):
    """The flash counters of one call, added into ``total``."""
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n


def tp_qwen_serve(np, torch, dev, card, meshes, total):
    """qwen2-vl-72b at full width, TP_QWEN's depth: a text prompt served
    on one card, then over the (1, 2) meshes on the same weights (the
    one-card tree freed, then drawn again from its seed already split,
    ``init_params(plan=)``: the same values); every logits array within
    TP_SERVE_TOL of the one-card run's, a control (rank 1's kv cache
    zeroed before a decode step) beyond it."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.launch import serve
    from repro_torch.models import serving, steps, transformer
    q = TP_QWEN
    full = get_config(q["arch"])
    check_published(full)
    cfg = full.replace(num_layers=q["layers"], param_dtype="bfloat16")
    b, s, n_gen = q["requests"], q["prompt_len"], q["gen"]
    mesh = meshes["repeated"]
    plan = serving.serving_plan(cfg, mesh)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = transformer.init_params(cfg, seed=0, device=dev)
    n_params = tree_numel(params)
    print(f"phase tp (1/6): {cfg.name} at its published widths ({cfg.d_model}"
          f", {cfg.num_heads} heads over {cfg.num_kv_heads}, dh "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size})"
          f", cut in depth {full.num_layers} -> {cfg.num_layers} layers, "
          f"bf16 weights ({n_params:,} parameters; a float32 tree and its "
          f"split copy do not fit one card together), a {b} x {s} text "
          f"prompt, {n_gen} decode steps: one card, then tensor parallel "
          f"over {list(meshes)} (1, 2) meshes, {cfg.num_heads // 2} heads "
          f"and {len(plan.kv_heads(0))} kv heads a rank ({card})")

    def run(p, m):
        reset_all_launches()
        outs = [serve.serve(cfg, p, requests=b, prompt_len=s, gen=n_gen,
                            device=dev, seed=0, mesh=m) for _ in range(2)]
        launches = all_launches()
        return outs[1][1], outs[0][1], launches

    one, one_first, one_launches = run(params, None)
    check(one_launches["flash_attention_tc"] == 2 * cfg.num_layers,
          f"one card: flash launches {one_launches}")
    del params
    torch.cuda.empty_cache()
    params = transformer.init_params(cfg, seed=0, device=dev, plan=plan)
    per_rank = TP.weight_bytes(params)
    reset_all_launches()
    got, got_first, launches = run(params, mesh)
    tp_counts(launches, total)
    print(f"  launch counters over the two tensor-parallel serve calls: "
          f"{launches}")
    check(launches["flash_attention_tc"] == 2 * 2 * cfg.num_layers
          and sum(launches.values()) == launches["flash_attention_tc"]
          and got["prefill_flash_launches"] == 2 * cfg.num_layers,
          f"{cfg.name} tp: launches {launches}, prefill "
          f"{got['prefill_flash_launches']}; expected {cfg.num_layers} "
          f"tensor-core forwards a rank a prefill (H/tp = "
          f"{cfg.num_heads // 2}, dh {cfg.resolved_head_dim}), nothing else")
    errs = [dist(torch.from_numpy(a), torch.from_numpy(w))
            for a, w in zip(got["logits"], one["logits"], strict=True)]
    check(all(np.isfinite(lg).all() for lg in got["logits"]),
          f"{cfg.name} tp: non-finite logits")
    # the control: rank 1's cache zeroed before the first decode step
    rng = np.random.default_rng(0)
    batch = serve.make_batch(cfg, b, s, rng=rng, device=dev)
    with torch.no_grad():
        _, cache = serving.prefill(params, batch, cfg, mesh=mesh)
        for key in ("k", "v"):
            cache[key][1].zero_()
        step_in = serve.token_to_batch(cfg, torch.zeros(b, dtype=torch.long,
                                                        device=dev), s, b,
                                       rng, device=dev)
        bad, _ = serving.decode_step(params, step_in, cache, cfg, mesh=mesh)
    ctrl = dist(bad.cpu(), torch.from_numpy(one["logits"][1]))
    del cache, bad
    print(f"  tensor parallel vs one card, the same bf16 weights: prefill "
          f"logits {errs[0]:.3e}, decode steps max {max(errs[1:]):.3e} "
          f"[{TP_SERVE_TOL:g}]; control (rank 1's kv cache zeroed) "
          f"{ctrl:.3e} [> {TP_SERVE_TOL:g}]; weights a rank "
          f"{[round(x / 1e9, 3) for x in per_rank]} GB; prefill "
          f"{got['prefill_s']:.4f} s (one card {one['prefill_s']:.4f}; first "
          f"calls {got_first['prefill_s']:.4f} / {one_first['prefill_s']:.4f})"
          f", decode {got['decode_ms_per_token']:.2f} ms/token (one card "
          f"{one['decode_ms_per_token']:.2f}) on {card}")
    check(max(errs) <= TP_SERVE_TOL, f"{cfg.name} tp logits {errs} beyond "
                                     f"{TP_SERVE_TOL:g}")
    check(ctrl > TP_SERVE_TOL, f"{cfg.name}: zeroing rank 1's cache moves "
                               f"the logits by only {ctrl:.3e}")
    out = {"layers": cfg.num_layers, "params": n_params,
           "weight_bytes_per_rank": per_rank, "logits_err": errs,
           "control": ctrl, "prefill_s": got["prefill_s"],
           "prefill_s_one_card": one["prefill_s"],
           "decode_ms_per_token": got["decode_ms_per_token"],
           "decode_ms_per_token_one_card": one["decode_ms_per_token"],
           "flash_launches": launches["flash_attention_tc"]}
    if "distinct" in meshes:
        moved = steps._on_group(params, list(meshes["distinct"].devices[0]))
        del params
        reset_all_launches()
        dist_run, _, _ = run(moved, meshes["distinct"])
        same = all(np.array_equal(a, w) for a, w in zip(
            dist_run["logits"], got["logits"]))
        print(f"  on [cuda:0, cuda:1]: prefill {dist_run['prefill_s']:.4f} "
              f"s, decode {dist_run['decode_ms_per_token']:.2f} ms/token; "
              f"logits bitwise the repeated card's: {same}")
        check(same, f"{cfg.name}: distinct cards differ from one card "
                    f"repeated")
        out["distinct_cards"] = {
            "prefill_s": dist_run["prefill_s"],
            "decode_ms_per_token": dist_run["decode_ms_per_token"]}
        del moved
    else:
        del params
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    return out


def tp_moe(np, torch, dev, card, meshes, total):
    """llama4-scout at full width, TP_MOE's cut: a prefill on one card,
    then over the repeated (1, 2) mesh on the same weights (8 experts, 20
    heads and 4 kv heads a rank): phase moe's gates on every recorded moe
    call (against the float32 recomputation, the swapped-expert control);
    each call's routing (top-k, capacity, keep) bitwise one card's
    ``moe_ffn`` on the same input; each call's dropped pairs, and the
    prefill's, within TP_MOE_DROP_SHARE of the one-card prefill's (whose
    layers see inputs an ulp away: see the constant); the last-position
    logits within TP_SERVE_TOL of one card's. Then one training step at
    depth 1 (MOE_TRAIN's cut), both ways, loss and grad norm within
    TP_TRAIN_RTOL."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.lm import LMDataConfig, SyntheticLM
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.launch import serve
    from repro_torch.models import moe, serving, steps, transformer
    c = TP_MOE
    cfg = get_config(c["arch"]).replace(**c["cut"])
    mesh = meshes["repeated"]
    b, s = c["requests"], c["prompt_len"]
    print(f"phase tp (2/6): {cfg.name} at full width cut {c['cut']}: a "
          f"{b} x {s} prefill on one card and over [cuda:0, cuda:0], "
          f"{cfg.moe.num_experts // 2} experts, {cfg.num_heads // 2} heads "
          f"and {cfg.num_kv_heads // 2} kv heads a rank ({card})")
    routes = []
    real = moe.route

    def spy(ids, e, cap):
        r = real(ids, e, cap)
        routes.append((ids.clone(), cap, r.keep.clone()))
        return r
    calls = []
    moe.route = spy
    try:
        params = transformer.init_params(cfg, seed=0, device=dev)
        batch = serve.make_batch(cfg, b, s, rng=np.random.default_rng(0),
                                 device=dev)
        with torch.no_grad():
            one, _ = serving.prefill(params, batch, cfg)
        n_one = len(routes)
        del params
        torch.cuda.empty_cache()
        params = transformer.init_params(
            cfg, seed=0, device=dev, plan=serving.serving_plan(cfg, mesh))
        reset_all_launches()
        with torch.no_grad(), recorded_moe(calls):
            got, _ = serving.prefill(params, batch, cfg, mesh=mesh)
        launches = all_launches()
        tp_counts(launches, total)
        calls = [(k, x, y, TP.gather_params(p), m) for k, x, y, p, m in calls]
        n_tp = len(routes) - n_one
        with torch.no_grad():
            for _, x, _, p, m in calls:
                moe.moe_ffn(x, p, m)
    finally:
        moe.route = real
    check(launches["flash_attention_tc"] == 2 * cfg.num_layers
          and sum(launches.values()) == 2 * cfg.num_layers,
          f"{cfg.name} tp prefill launches {launches}")
    r_one, r_tp = routes[:n_one], routes[n_one:n_one + n_tp]
    r_same = routes[n_one + n_tp:]
    check(n_one == n_tp == len(calls) == len(r_same),
          f"{cfg.name}: {n_one} / {n_tp} / {len(r_same)} routings for "
          f"{len(calls)} moe calls")
    same_routes = all(torch.equal(a[0], b_[0]) and a[1] == b_[1]
                      and torch.equal(a[2], b_[2])
                      for a, b_ in zip(r_tp, r_same))
    drops_one = [int((~r[2]).sum()) for r in r_one]
    drops_tp = [int((~r[2]).sum()) for r in r_tp]
    pairs = [r[0].numel() for r in r_one]
    moved = [int((a[0] != b_[0]).any(1).sum()) for a, b_ in zip(r_tp, r_one)]
    gaps = [abs(a - b_) for a, b_ in zip(drops_tp, drops_one)]
    drop_bounds = [TP_MOE_DROP_SHARE * n for n in pairs]
    gap_total = abs(sum(drops_tp) - sum(drops_one))
    worst, ctrl, dropped, kinds = moe_output_checks(torch, calls,
                                                    c["check_tokens"])
    err = dist(got, one)
    print(f"  tp prefill: launches {launches}; moe outputs worst share "
          f"{worst['prefill']:.3f} of {MOE_BF16_TOL:g}, control "
          f"{ctrl['prefill']:.1f}x; dropped pairs a call {dropped}; top-k, "
          f"capacity and keep bitwise one card's moe_ffn on the same "
          f"inputs: {same_routes}; against the one-card prefill: dropped "
          f"{drops_tp} vs {drops_one} of {pairs} pairs (gaps {gaps}, total "
          f"{gap_total}; bound {TP_MOE_DROP_SHARE:g} of the pairs, "
          f"{[round(x, 1) for x in drop_bounds]}), tokens routed to other "
          f"experts {moved}; last-position logits vs one card {err:.3e} "
          f"[{TP_SERVE_TOL:g}]")
    check(worst["prefill"] <= 1.0, f"{cfg.name} tp moe outputs at {worst}")
    check(ctrl["prefill"] > TRAIN_CONTROL_FACTOR,
          f"{cfg.name} tp: the moe control {ctrl}")
    check(same_routes, f"{cfg.name} tp: routing differs from one card's on "
                       f"the same inputs")
    check(all(g <= bd for g, bd in zip(gaps, drop_bounds))
          and gap_total <= TP_MOE_DROP_SHARE * sum(pairs),
          f"{cfg.name} tp: dropped pairs {drops_tp} against one card's "
          f"{drops_one} beyond {TP_MOE_DROP_SHARE:g} of {pairs}")
    check(err <= TP_SERVE_TOL, f"{cfg.name} tp prefill logits {err:.3e}")
    del params, batch, one, got, calls, routes
    torch.cuda.empty_cache()
    t = MOE_TRAIN
    tcfg = get_config(t["arch"]).replace(**t["cut"])
    shape = ShapeConfig("tp", t["seq"], t["batch"], "train")
    data = SyntheticLM(LMDataConfig(
        vocab_size=tcfg.vocab_size, seq_len=t["seq"], global_batch=t["batch"],
        microbatches=t["microbatches"]), tcfg)
    metrics = {}
    for tag, m in (("one", None), ("tp", mesh)):
        state = steps.init_state(tcfg, seed=0, device=dev, mesh=m)
        step = steps.make_train_step(tcfg, m, shape, t["microbatches"],
                                     total_steps=100)
        reset_all_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, mt = step(state, data.device_batch(0, dev), 0)
        torch.cuda.synchronize()
        metrics[tag] = (float(mt["loss"]), float(mt["grad_norm"]),
                        time.perf_counter() - t0)
        if tag == "tp":
            tl = all_launches()
            tp_counts(tl, total)
        del state, step
        torch.cuda.empty_cache()
    per_step = tcfg.num_layers * t["microbatches"]
    check(tl["flash_attention_tc"] == 2 * 2 * per_step
          and tl["flash_attention_bwd_tc"] == 2 * per_step
          and sum(tl.values()) == 6 * per_step,
          f"{tcfg.name} tp step launched {tl}")
    (l1, g1, w1), (l2, g2, w2) = metrics["one"], metrics["tp"]
    print(f"  one training step at depth 1 (bf16 masters, {t['batch']} x "
          f"{t['seq']}): loss {l2:.6f} vs one card {l1:.6f}, grad norm "
          f"{g2:.6f} vs {g1:.6f} [rtol {TP_TRAIN_RTOL:g}]; {w2:.3f} s vs "
          f"{w1:.3f} s (first steps); launches {tl}")
    check(abs(l2 - l1) <= TP_TRAIN_RTOL * abs(l1)
          and abs(g2 - g1) <= TP_TRAIN_RTOL * abs(g1)
          and abs(l1 - np.log(tcfg.vocab_size)) <= 1.5,
          f"{tcfg.name} tp step: loss {l2} / {l1}, grad norm {g2} / {g1}")
    return {"prefill_moe_share": worst, "prefill_moe_control": ctrl,
            "dropped": dropped, "dropped_one_card": drops_one,
            "routed_elsewhere": moved, "routes_equal": same_routes,
            "prefill_logits_err": err, "train": metrics}


def tp_gemma_train(np, torch, dev, card, meshes, total):
    """gemma2-2b uncut (pad_heads_to=0), trained TP_GEMMA's steps at 1 x
    8192 on one card and twice over [cuda:0, cuda:0] (4 heads and 2 kv
    heads a rank, row 11b's Cfg<256>): each step's loss and grad norm
    within TP_TRAIN_RTOL of one card's, every rank's slices bitwise across
    the two runs; s/step, and the share of a step inside reduce_sum's
    forward calls (host clock, synchronised around each call). Then step
    0's gradients (``tp_grad_gate``): every leaf within TP_GRAD_REL of one
    card's, and each planted fault (``tp_train_faults``) rejected by the
    same comparisons."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.lm import LMDataConfig, SyntheticLM
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import steps
    from repro_torch.optim import adamw
    c = TP_GEMMA
    cfg = get_config(c["arch"]).replace(**c["cut"])
    check_published(get_config(c["arch"]))
    mesh = meshes["repeated"]
    shape = ShapeConfig("tp", c["seq"], c["batch"], "train")
    data = SyntheticLM(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=c["seq"], global_batch=c["batch"],
        microbatches=c["microbatches"]), cfg)
    print(f"phase tp (3/6): {cfg.name} uncut ({cfg.num_layers} layers, "
          f"heads unpadded), trained {c['steps']} steps at {c['batch']} x "
          f"{c['seq']} on one card and twice over [cuda:0, cuda:0]: "
          f"{cfg.num_heads // 2} heads and {cfg.num_kv_heads // 2} kv heads "
          f"a rank, dh {cfg.resolved_head_dim} ({card})")
    runs, snaps, times = {}, [], {}
    timer = {"s": 0.0, "n": 0}
    real = TP.reduce_sum

    def timed(parts, dev_, tp):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(parts, dev_, tp)
        torch.cuda.synchronize()
        timer["s"] += time.perf_counter() - t0
        timer["n"] += 1
        return out
    for tag, m in (("one", None), ("tp", mesh), ("tp again", mesh)):
        state = steps.init_state(cfg, seed=0, device=dev, mesh=m)
        step = steps.make_train_step(cfg, m, shape, c["microbatches"],
                                     total_steps=100)
        if tag == "tp":
            reset_all_launches()
        out, walls = [], []
        for i in range(c["steps"]):
            instrument = tag == "tp again" and i == c["steps"] - 1
            if instrument:
                TP.reduce_sum = timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                state, mt = step(state, data.device_batch(i, dev), i)
                out.append((float(mt["loss"]), float(mt["grad_norm"])))
            finally:
                TP.reduce_sum = real
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        if tag == "tp":
            tl = all_launches()
            tp_counts(tl, total)
        runs[tag], times[tag] = out, walls
        if tag != "one":
            snaps.append([t.cpu() for t in adamw.tree_leaves(state.params)])
            check(isinstance(state.params["layers"]["q"], TP.Shards)
                  and state.params["layers"]["q"][0].shape[2]
                  == cfg.num_heads // 2, f"{cfg.name}: q is not split")
        del state, step
        torch.cuda.empty_cache()
    per_step = cfg.num_layers * c["microbatches"]
    check(tl["flash_attention_tc"] == 2 * 2 * per_step * c["steps"]
          and tl["flash_attention_bwd_tc"] == 2 * per_step * c["steps"]
          and sum(tl.values()) == 6 * per_step * c["steps"],
          f"{cfg.name} tp steps launched {tl}")
    bitwise = all(torch.equal(a, b_) for a, b_ in zip(*snaps, strict=True))
    worst = max(max(abs(a[0] - w[0]) / abs(w[0]), abs(a[1] - w[1]) / abs(w[1]))
                for a, w in zip(runs["tp"], runs["one"]))
    share = timer["s"] / times["tp again"][-1]
    print(f"  loss / grad norm a step: tp {runs['tp']}, one card "
          f"{runs['one']}: worst relative {worst:.2e} [{TP_TRAIN_RTOL:g}]; "
          f"the two tp runs' {len(snaps[0])} slices and leaves bitwise: "
          f"{bitwise}; s/step tp {times['tp']} (one card {times['one']}); "
          f"reduce_sum's {timer['n']} forward calls {timer['s']:.3f} s of an "
          f"instrumented {times['tp again'][-1]:.3f} s step ({share * 100:.1f}"
          f" %); launches {tl} on {card}")
    check(worst <= TP_TRAIN_RTOL, f"{cfg.name} tp vs one card {worst:.2e}")
    check(bitwise, f"{cfg.name}: two tp runs differ")
    del snaps
    grads = tp_grad_gate(torch, cfg, mesh, shape, c["microbatches"],
                         data.device_batch(0, dev), dev, runs["one"][0],
                         tp_train_faults(torch))
    return {"losses": runs, "step_s": times, "worst_rel": worst,
            "bitwise": bitwise, "reduce_sum_s": timer["s"],
            "reduce_sum_calls": timer["n"], "reduce_sum_share": share,
            "step0_grads": grads}


def tp_train_faults(torch):
    """Planted faults of a split step over (1, 2), each a context manager
    over the split state that leaves it as it found it: rank 1's
    attention output partial dropped (its rows of ``o`` zeroed), the
    ranks reading each other's kv heads (their ``k`` slices swapped), and
    the attention input's backward all-reduce missing rank 1's share
    (its copy of x detached in ``project_qkv``)."""
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import transformer

    def stacks(state):
        return [state.params[k] for k in ("layers", "layers2")
                if k in state.params]

    @contextlib.contextmanager
    def drop_partial(state):
        saved = [st["o"][1].clone() for st in stacks(state)]
        with torch.no_grad():
            for st in stacks(state):
                st["o"][1].zero_()
        try:
            yield
        finally:
            with torch.no_grad():
                for st, o in zip(stacks(state), saved):
                    st["o"][1].copy_(o)

    def swap(state):
        with torch.no_grad():
            for st in stacks(state):
                k0 = st["k"][0].clone()
                st["k"][0].copy_(st["k"][1])
                st["k"][1].copy_(k0)

    @contextlib.contextmanager
    def swap_kv(state):
        swap(state)
        try:
            yield
        finally:
            swap(state)

    @contextlib.contextmanager
    def detach_rank1(state):
        real_b, real_p = TP.broadcast, transformer.project_qkv

        def detached(x, like):
            out = real_b(x, like)
            return out[:1] + [o.detach() for o in out[1:]]

        def project(*args, **kw):
            TP.broadcast = detached
            try:
                return real_p(*args, **kw)
            finally:
                TP.broadcast = real_b
        transformer.project_qkv = project
        try:
            yield
        finally:
            transformer.project_qkv = real_p
    return {"rank 1's attention partial dropped": drop_partial,
            "kv heads swapped across ranks": swap_kv,
            "rank 1's attention input gradient dropped": detach_rank1}


def step0_grads(torch, cfg, mesh, shape, n_mb, batch, state, fault=None):
    """(loss, global grad norm, leaf names, gradient leaves gathered
    whole) of ``steps.make_grad_step`` on ``state`` over ``mesh``, under
    the context manager ``fault(state)`` where one is given."""
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import steps
    from repro_torch.optim import adamw
    grad_step = steps.make_grad_step(cfg, mesh, shape, n_mb)
    with fault(state) if fault else contextlib.nullcontext():
        grads, loss, _ = grad_step(state, batch)
    gnorm = float(adamw.global_norm(grads))
    whole = TP.gather_params(grads)
    del grads
    return float(loss), gnorm, leaf_paths(whole), adamw.tree_leaves(whole)


def leaf_dists(torch, leaves, ref):
    """Each leaf's distance from ``ref``'s (host copies), over ``ref``'s
    norm."""
    out = []
    for g, r in zip(leaves, ref, strict=True):
        r = r.to(g.device).float()
        d = float(torch.linalg.vector_norm(g.float() - r))
        n = float(torch.linalg.vector_norm(r))
        out.append(d / n if n > 0 else (0.0 if d == 0 else float("inf")))
    return out


def tp_grad_gate(torch, cfg, mesh, shape, n_mb, batch, dev, one_step0,
                 faults, keep=None):
    """Step 0's gradients (``step0_grads``) on one card and over ``mesh``
    on the same init and batch: the loss and global grad norm (the train
    step's metrics) within TP_TRAIN_RTOL of one card's, and every
    gradient leaf's distance from one card's, over one card's norm,
    within TP_GRAD_REL. Each of ``faults`` ({name: context manager over
    the split state}, ``tp_train_faults``) must be rejected by them
    (beyond either bound). ``one_step0``: the one-card train step's
    step-0 (loss, grad norm), which the one-card grad step repeats, or
    None. ``keep``: a list that receives one card's leaves (host
    copies)."""
    import numpy as np
    from repro_torch.models import steps

    def read(m, state, fault=None):
        return step0_grads(torch, cfg, m, shape, n_mb, batch, state, fault)

    state = steps.init_state(cfg, seed=0, device=dev)
    l1, g1, names, leaves = read(None, state)
    ref = [t.cpu() for t in leaves]
    del state, leaves
    torch.cuda.empty_cache()

    def compare(loss, gnorm, leaves):
        rel = max(abs(loss - l1) / abs(l1), abs(gnorm - g1) / abs(g1))
        dists = leaf_dists(torch, leaves, ref)
        i = int(np.argmax(dists))
        return rel, dists[i], names[i]

    state = steps.init_state(cfg, seed=0, device=dev, mesh=mesh)
    loss, gnorm, _, leaves = read(mesh, state)
    rel, leaf_worst, leaf_name = compare(loss, gnorm, leaves)
    del leaves
    out = {"one_card": [l1, g1], "tp": [loss, gnorm], "scalar_rel": rel,
           "leaf_rel": leaf_worst, "leaf": leaf_name, "controls": {}}
    print(f"  step 0's gradients ({len(ref)} leaves, {cfg.dtype} "
          f"activations): one card loss {l1:.6f}, grad norm {g1:.6f}"
          + ("" if one_step0 is None
             else f" (its train step's {one_step0})")
          + f"; tp {loss:.6f}, {gnorm:.6f}: relative {rel:.2e} "
          f"[{TP_TRAIN_RTOL:g}]; worst leaf {leaf_name} {leaf_worst:.3e} "
          f"[{TP_GRAD_REL:g}]", flush=True)
    for name, fault in faults.items():
        c_loss, c_gnorm, _, leaves = read(mesh, state, fault)
        c_rel, c_leaf, c_name = compare(c_loss, c_gnorm, leaves)
        del leaves
        torch.cuda.empty_cache()
        seen = c_rel > TP_TRAIN_RTOL or c_leaf > TP_GRAD_REL
        out["controls"][name] = {"scalar_rel": c_rel, "leaf_rel": c_leaf,
                                 "leaf": c_name, "rejected": seen}
        print(f"  control, {name}: loss / grad norm relative {c_rel:.2e} "
              f"({c_rel / TP_TRAIN_RTOL:.2f} x TP_TRAIN_RTOL), worst leaf "
              f"{c_name} {c_leaf:.3e} ({c_leaf / TP_GRAD_REL:.1f} x "
              f"TP_GRAD_REL): rejected {seen}", flush=True)
    if keep is not None:
        keep.extend(ref)
    del state, ref
    torch.cuda.empty_cache()
    check(rel <= TP_TRAIN_RTOL and leaf_worst <= TP_GRAD_REL,
          f"{cfg.name} tp step-0 gradients: {rel:.2e}, {leaf_name} "
          f"{leaf_worst:.3e}")
    check(all(v["rejected"] for v in out["controls"].values()),
          f"{cfg.name}: a planted fault passes the tp gates: "
          f"{out['controls']}")
    return out


def tp_ssm_grad_gate(torch, cfg, mesh, shape, n_mb, batch, dev, one_step0):
    """mamba2's step-0 gradients split against one card. A float32 copy
    (``cfg`` with float32 activations) takes ``tp_grad_gate``: every leaf
    within TP_GRAD_REL of one card's, ``tp_ssm_faults`` rejected. In
    ``cfg``'s bf16 the split's own roundings (each rank's bf16 output
    partial, a rank's narrower products) move a leaf as one card's bf16
    rounding moves it, and the SSD's bf16 dt makes some leaves (dt_bias)
    far from float32 on one card already (PERF.md): so, the ssm rule of
    PERF.md section 2, every bf16 leaf of the split no further from the
    float32 one-card leaf than SSM_BF16_FACTOR times one card's bf16 leaf
    is; the loss and grad norm within TP_TRAIN_RTOL of one card's bf16
    ones; the split's distance from one card's bf16 leaves printed."""
    import numpy as np
    from repro_torch.models import steps
    ref32 = []
    out = {"float32": tp_grad_gate(torch, cfg.replace(dtype="float32"), mesh,
                                   shape, n_mb, batch, dev, None,
                                   tp_ssm_faults(torch), keep=ref32)}
    runs = {}
    for tag, m in (("one", None), ("tp", mesh)):
        state = steps.init_state(cfg, seed=0, device=dev, mesh=m)
        loss, gnorm, names, leaves = step0_grads(torch, cfg, m, shape, n_mb,
                                                 batch, state)
        runs[tag] = (loss, gnorm, [t.cpu() for t in leaves])
        del state, leaves
        torch.cuda.empty_cache()
    (l1, g1, one), (l2, g2, tp) = runs["one"], runs["tp"]
    rel = max(abs(l2 - l1) / abs(l1), abs(g2 - g1) / abs(g1))
    d_one = leaf_dists(torch, one, ref32)
    d_tp = leaf_dists(torch, tp, ref32)
    d_pair = leaf_dists(torch, tp, one)
    ratio = [a / b if b > 0 else (1.0 if a == 0 else float("inf"))
             for a, b in zip(d_tp, d_one)]
    i, j = int(np.argmax(ratio)), int(np.argmax(d_pair))
    out[cfg.dtype] = {"one_card": [l1, g1], "tp": [l2, g2],
                      "scalar_rel": rel, "worst_ratio": ratio[i],
                      "worst_ratio_leaf": names[i],
                      "leaf_vs_f32_tp": d_tp[i], "leaf_vs_f32_one": d_one[i],
                      "pair_worst": d_pair[j], "pair_worst_leaf": names[j]}
    print(f"  step 0 in {cfg.dtype} (the train step's {one_step0}): loss / "
          f"grad norm tp vs one card relative {rel:.2e} [{TP_TRAIN_RTOL:g}]; "
          f"every leaf's distance from the float32 one-card leaf, split "
          f"over one card: worst {names[i]} {d_tp[i]:.3e} / {d_one[i]:.3e} "
          f"= {ratio[i]:.3f} [{SSM_BF16_FACTOR:g}]; split vs one card "
          f"{cfg.dtype}: worst leaf {names[j]} {d_pair[j]:.3e}", flush=True)
    del ref32, one, tp
    check(rel <= TP_TRAIN_RTOL and ratio[i] <= SSM_BF16_FACTOR,
          f"{cfg.name} tp step-0 {cfg.dtype} gradients: {rel:.2e}, "
          f"{names[i]} at {ratio[i]:.3f} x one card's distance from float32")
    return out


def tp_ssm_logits(np, torch, params, cfg, mesh, c, dev):
    """Prefill-last and ``c['teacher']`` decode steps' float32 logits (on
    the CPU) of ``cfg`` over ``mesh`` (None: one card), the prompt and
    tokens from seeded numpy streams; and the prefill's cache."""
    from repro_torch.launch import serve
    from repro_torch.models import serving
    b, s, n = c["requests"], c["prompt_len"], c["teacher"]
    rng = np.random.default_rng(0)
    batch = serve.make_batch(cfg, b, s, rng=rng, device=dev)
    toks = rng.integers(0, cfg.vocab_size, (n, b))
    with torch.no_grad():
        lg, cache = serving.prefill(params, batch, cfg, extra_slots=n,
                                    mesh=mesh)
        first = {k: (t.like([p.clone() for p in t])
                     if isinstance(t, list) else t.clone())
                 for k, t in cache.items()}
        out = [lg.float().cpu()]
        for i in range(n):
            step = serve.token_to_batch(cfg, torch.from_numpy(toks[i]).to(
                dev), s + i, b, rng, device=dev)
            lg, cache = serving.decode_step(params, step, cache, cfg,
                                            mesh=mesh)
            out.append(lg.float().cpu())
    return out, first, toks


def tp_ssm_serve(np, torch, dev, card, meshes, total):
    """mamba2-1.3b at its published config (TP_SSM): launch.serve.serve
    on one card, then over the repeated (1, 2) mesh on the same weights
    (the one-card tree freed, drawn again already split), each twice, the
    second call timed; the gates on the prefill-last and TP_SSM['teacher']
    decode steps' logits (``tp_ssm_logits``): a float32 copy split within
    TP_SSM_F32_TOL of one card's, the control (rank 1's SSD state zeroed
    after prefill) beyond TRAIN_CONTROL_FACTOR times it; the served bf16
    split no further from the float32 one-card logits than SSM_BF16_FACTOR
    times the bf16 one card is."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.launch import serve
    from repro_torch.models import serving, transformer
    c = TP_SSM
    full = get_config(c["arch"])
    check_published(full)
    cfg = full.replace(**c["cut"])
    c32 = cfg.replace(dtype="float32")
    mesh = meshes["repeated"]
    plan = serving.serving_plan(cfg, mesh)
    b, s, n_gen = c["requests"], c["prompt_len"], c["gen"]
    hr = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim // 2
    print(f"phase tp (4/6): {cfg.name} at its published config "
          f"({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.param_counts()['total']:,} parameters, {cfg.param_dtype} "
          f"weights, {cfg.dtype} activations), a {b} x {s} prompt and "
          f"{n_gen} decode steps: one card, then over [cuda:0, cuda:0], "
          f"{hr} SSD heads a rank ({card})")
    torch.cuda.empty_cache()
    params = transformer.init_params(cfg, seed=0, device=dev)

    def run(p, m):
        reset_all_launches()
        outs = [serve.serve(cfg, p, requests=b, prompt_len=s, gen=n_gen,
                            device=dev, seed=0, mesh=m)[1]
                for _ in range(2)]
        return outs[1], all_launches()

    one, one_launches = run(params, None)
    one32, _, _ = tp_ssm_logits(np, torch, params, c32, None, c, dev)
    one16, _, _ = tp_ssm_logits(np, torch, params, cfg, None, c, dev)
    del params
    torch.cuda.empty_cache()
    params = transformer.init_params(cfg, seed=0, device=dev, plan=plan)
    per_rank = TP.weight_bytes(params)
    got, launches = run(params, mesh)
    tp_counts(launches, total)
    check(sum(launches.values()) == 0 == sum(one_launches.values()),
          f"{cfg.name}: kernel launches {launches} / {one_launches}; the "
          f"attention-free model launches none")
    check(isinstance(params["layers"]["ssm"]["z_proj"], TP.Shards)
          and all(np.isfinite(lg).all() for lg in got["logits"]),
          f"{cfg.name} tp: the SSD is not split, or non-finite logits")
    tp32, cache, toks = tp_ssm_logits(np, torch, params, c32, mesh, c, dev)
    tp16, _, _ = tp_ssm_logits(np, torch, params, cfg, mesh, c, dev)
    # the control: rank 1's state zeroed after prefill, one decode step
    rng = np.random.default_rng(0)
    serve.make_batch(c32, b, s, rng=rng, device=dev)
    rng.integers(0, cfg.vocab_size, toks.shape)
    with torch.no_grad():
        cache["state"][1].zero_()
        step = serve.token_to_batch(c32, torch.from_numpy(toks[0]).to(dev),
                                    s, b, rng, device=dev)
        bad, _ = serving.decode_step(params, step, cache, c32, mesh=mesh)
    ctrl = dist(bad.float().cpu(), one32[1])
    del cache, bad
    err32 = max(dist(a_, w) for a_, w in zip(tp32, one32, strict=True))
    fwd16 = max(dist(a_, w) for a_, w in zip(one16, one32, strict=True))
    err16 = max(dist(a_, w) for a_, w in zip(tp16, one32, strict=True))
    print(f"  logits (prefill-last and {c['teacher']} decode steps): float32"
          f" split vs one card {err32:.3e} [{TP_SSM_F32_TOL:g}]; control "
          f"(rank 1's state zeroed) {ctrl:.3e} ({ctrl / TP_SSM_F32_TOL:.0f}x"
          f" the gate) [> {TRAIN_CONTROL_FACTOR:g}x]; {cfg.dtype} split vs "
          f"float32 one card {err16:.3e} <= {SSM_BF16_FACTOR:g} x one card's "
          f"{cfg.dtype} {fwd16:.3e}; weights a rank "
          f"{[round(x / 1e9, 3) for x in per_rank]} GB")
    print(f"  served ({cfg.dtype}): prefill {got['prefill_s']:.4f} s (one "
          f"card {one['prefill_s']:.4f}), decode "
          f"{got['decode_ms_per_token']:.2f} ms/token (one card "
          f"{one['decode_ms_per_token']:.2f}) on {card}")
    check(err32 <= TP_SSM_F32_TOL, f"{cfg.name} tp float32 logits "
                                   f"{err32:.3e}")
    check(ctrl > TRAIN_CONTROL_FACTOR * TP_SSM_F32_TOL,
          f"{cfg.name}: zeroing rank 1's state moves the logits by only "
          f"{ctrl:.3e}")
    check(err16 <= SSM_BF16_FACTOR * fwd16,
          f"{cfg.name} tp {cfg.dtype} logits {err16:.3e} from float32, "
          f"over {SSM_BF16_FACTOR:g} x {fwd16:.3e}")
    del params
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "weight_bytes_per_rank": per_rank,
            "f32_logits_err": err32, "control": ctrl,
            "served_vs_f32": err16, "one_card_served_vs_f32": fwd16,
            "prefill_s": got["prefill_s"],
            "prefill_s_one_card": one["prefill_s"],
            "decode_ms_per_token": got["decode_ms_per_token"],
            "decode_ms_per_token_one_card": one["decode_ms_per_token"]}


def tp_ssm_faults(torch):
    """Planted faults of mamba2's split step over (1, 2), each a context
    manager over the split state that leaves it as it found it: rank 1
    reading rank 0's slices of ``A_log`` and ``dt_bias`` (their second
    halves overwritten with their first), and the gated norm's variance
    taken from rank 0's partial sum of squares alone (the (..., 1)
    float32 ``reduce_sum``)."""
    from repro_torch.distributed import tensor_parallel as TP

    @contextlib.contextmanager
    def rank0_vectors(state):
        p = state.params["layers"]["ssm"]
        saved = {k: p[k].clone() for k in ("A_log", "dt_bias")}
        with torch.no_grad():
            for k in saved:
                h = p[k].shape[-1] // 2
                p[k][:, h:].copy_(p[k][:, :h])
        try:
            yield
        finally:
            with torch.no_grad():
                for k, v in saved.items():
                    p[k].copy_(v)

    @contextlib.contextmanager
    def rank0_variance(state):
        real = TP.reduce_sum

        def partial(parts, dev_, tp):
            if parts[0].shape[-1] == 1 and parts[0].dtype == torch.float32:
                return parts[0].to(dev_) * tp
            return real(parts, dev_, tp)
        TP.reduce_sum = partial
        try:
            yield
        finally:
            TP.reduce_sum = real
    return {"rank 1 reading rank 0's A_log and dt_bias": rank0_vectors,
            "the norm's variance from rank 0's partial": rank0_variance}


def tp_ssm_train(np, torch, dev, card, meshes, total):
    """mamba2-1.3b at its published config (TP_SSM) trained 2 steps at 8 x
    2048 in 2 microbatches on one card and twice over [cuda:0, cuda:0]:
    s/step; step 0's loss and grad norm within TP_TRAIN_RTOL of one
    card's, the two split runs' slices bitwise; then step 0's gradients
    leaf by leaf (``tp_ssm_grad_gate``)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.lm import LMDataConfig, SyntheticLM
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import steps
    from repro_torch.optim import adamw
    c = TP_SSM
    cfg = get_config(c["arch"]).replace(**c["cut"])
    mesh = meshes["repeated"]
    shape = ShapeConfig("tp", c["seq"], c["batch"], "train")
    data = SyntheticLM(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=c["seq"], global_batch=c["batch"],
        microbatches=c["microbatches"]), cfg)
    print(f"phase tp (5/6): {cfg.name} at its published config trained "
          f"{c['steps']} steps at {c['batch']} x {c['seq']} in "
          f"{c['microbatches']} microbatches on one card and twice over "
          f"[cuda:0, cuda:0] ({card})")
    runs, snaps, times = {}, [], {}
    for tag, m in (("one", None), ("tp", mesh), ("tp again", mesh)):
        state = steps.init_state(cfg, seed=0, device=dev, mesh=m)
        step = steps.make_train_step(cfg, m, shape, c["microbatches"],
                                     total_steps=100)
        reset_all_launches()
        out, walls = [], []
        for i in range(c["steps"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, mt = step(state, data.device_batch(i, dev), i)
            out.append((float(mt["loss"]), float(mt["grad_norm"])))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches = all_launches()
        check(sum(launches.values()) == 0, f"{cfg.name}: launches "
                                           f"{launches}")
        tp_counts(launches, total)
        runs[tag], times[tag] = out, walls
        if tag != "one":
            check(isinstance(state.params["layers"]["ssm"]["x_proj"],
                             TP.Shards), f"{cfg.name}: x_proj is not split")
            snaps.append([t.cpu() for t in adamw.tree_leaves(state.params)])
        del state, step
        torch.cuda.empty_cache()
    bitwise = all(torch.equal(a, b_) for a, b_ in zip(*snaps, strict=True))
    (l1, g1), (l2, g2) = runs["one"][0], runs["tp"][0]
    rel = max(abs(l2 - l1) / abs(l1), abs(g2 - g1) / abs(g1))
    print(f"  loss / grad norm a step: tp {runs['tp']}, one card "
          f"{runs['one']}: step 0 relative {rel:.2e} [{TP_TRAIN_RTOL:g}]; "
          f"the two tp runs' {len(snaps[0])} slices and leaves bitwise: "
          f"{bitwise}; s/step tp {times['tp']} (again {times['tp again']}; "
          f"one card {times['one']}) on {card}")
    check(rel <= TP_TRAIN_RTOL, f"{cfg.name} tp step 0 vs one card "
                                f"{rel:.2e}")
    check(bitwise, f"{cfg.name}: two tp runs differ")
    del snaps
    grads = tp_ssm_grad_gate(torch, cfg, mesh, shape, c["microbatches"],
                             data.device_batch(0, dev), dev, runs["one"][0])
    return {"losses": runs, "step_s": times, "step0_rel": rel,
            "bitwise": bitwise, "step0_grads": grads}


def leaf_paths(tree, path=""):
    """The names of ``adamw.tree_leaves(tree)``'s leaves, in its order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_paths(tree[k], f"{path}/{k}" if path else k)]
    return [path]


def tp_moe_dp_smoke(np, torch, dev, card):
    """The repaired uncompressed moe dp step (each dp shard routed apart;
    since PR 35 each slice on its own rows, the state FSDP's pieces):
    kimi-k2's smoke config on (2, 1) [cuda:0, cuda:0] against [cpu, cpu],
    float32, from one init, TRAIN_SMOKE_TOL's bounds."""
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.lm import LMDataConfig, SyntheticLM
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import steps, transformer
    from repro_torch.optim import adamw
    c = TP_SMOKE
    cfg = smoke_config(c["arch"])
    host = transformer.init_params(cfg, seed=5)
    data = SyntheticLM(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=c["seq"], global_batch=c["batch"],
        microbatches=c["microbatches"]), cfg)
    shape = ShapeConfig("smoke", c["seq"], c["batch"], "train")
    out = {}
    for d in ("cpu", "cuda:0"):
        mesh = mesh_lib.make_mesh((2, 1), ("data", "model"), devices=[d, d])
        # placed by the mesh's plan: FSDP's pieces over the two slices
        params = fsdp.shard_params(adamw.tree_map(lambda t: t.to(d), host),
                                   fsdp.param_plan(cfg, mesh))
        state = steps.TrainState(params, adamw.init_tree(params))
        step = steps.make_train_step(cfg, mesh, shape, c["microbatches"],
                                     total_steps=10)
        ms = []
        for i in range(c["steps"]):
            state, m = step(state, data.device_batch(i, torch.device(d)), i)
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        out[d] = (ms, [t.cpu() for t in adamw.tree_leaves(
            TP.gather_params(state.params))])
    tol = TRAIN_SMOKE_TOL
    worst = max(abs(a - w) / abs(w) for mc, mh in zip(out["cuda:0"][0],
                                                      out["cpu"][0])
                for a, w in zip(mc, mh))
    perr = max(float((a - w).abs().max()) for a, w in zip(out["cuda:0"][1],
                                                          out["cpu"][1]))
    print(f"phase tp (6/6): {cfg.name} uncompressed at (2, 1), each dp "
          f"shard routed apart: card {out['cuda:0'][0]} vs CPU "
          f"{out['cpu'][0]} (worst relative {worst:.2e} [{tol['metrics']:g}])"
          f", params max_abs_err {perr:.2e} [{tol['params']:g}]")
    check(worst <= tol["metrics"] and perr <= tol["params"],
          f"{cfg.name} moe dp step card vs CPU: {worst:.2e}, {perr:.2e}")
    return {"metrics": out["cuda:0"][0], "metrics_cpu": out["cpu"][0],
            "worst_rel": worst, "params_err": perr}


def phase_tp(np, torch, dev, card):
    """Tensor parallelism over 'model' (ROADMAP A11.9) on the card: rows
    11 and 11b per rank at full width (qwen2-vl-72b served, llama4-scout
    prefill and a step, gemma2-2b trained, its step-0 gradients leaf by
    leaf with planted faults as controls) and the ssm family's split SSD
    (mamba2-1.3b at its published config served and trained, no kernel)
    over [cuda:0, cuda:0] (and two cards where the machine has them),
    each against one card on the same weights; the repaired moe dp step
    card == CPU. Returns the main path's launch counts (the
    tensor-parallel calls, each counted from 0) and the numbers."""
    t_phase = time.perf_counter()
    meshes = tp_meshes(torch)
    launches = {}
    out = {"qwen2_vl_serve": tp_qwen_serve(np, torch, dev, card, meshes,
                                           launches)}
    out["llama4_moe"] = tp_moe(np, torch, dev, card, meshes, launches)
    out["gemma2_train"] = tp_gemma_train(np, torch, dev, card, meshes,
                                         launches)
    out["mamba2_serve"] = tp_ssm_serve(np, torch, dev, card, meshes,
                                       launches)
    out["mamba2_train"] = tp_ssm_train(np, torch, dev, card, meshes,
                                       launches)
    out["moe_dp_smoke"] = tp_moe_dp_smoke(np, torch, dev, card)
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase tp: {out['phase_s']:.2f} s on {card}; launches on the tp "
          f"path: {launches}")
    return out


# ---------------------------------------------------------------- fsdp
# FSDP over the dp axes (PR 35): the uncompressed step over a mesh with
# dp > 1, each data slice holding its pieces of every parameter and
# AdamW moment; (mesh shapes, batch, seq, microbatches, steps) a config
FSDP_CASES = (
    dict(arch="musicgen-medium", cut={}, meshes=((2, 1), (2, 2)), batch=8,
         seq=2048, microbatches=2, steps=2),
    dict(arch="gemma2-2b", cut=dict(pad_heads_to=0), meshes=((2, 2),),
         batch=2, seq=8192, microbatches=1, steps=2),
)


def fsdp_one_card(torch, cfg, shape, c, data, dev):
    """One card's step 0 on seed 0 (loss, grad norm, leaf names, host
    copies of the gradient leaves) and the s/step and peak GB of its
    ``c["steps"]`` train steps."""
    from repro_torch.models import steps
    state = steps.init_state(cfg, seed=0, device=dev)
    l1, g1, names, leaves = step0_grads(torch, cfg, None, shape,
                                        c["microbatches"],
                                        data.device_batch(0, dev), state)
    ref = [t.cpu() for t in leaves]
    del leaves
    torch.cuda.empty_cache()
    step = steps.make_train_step(cfg, None, shape, c["microbatches"],
                                 total_steps=100)
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for i in range(c["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, data.device_batch(i, dev), i)
        float(m["loss"])
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del state, step
    torch.cuda.empty_cache()
    return (l1, g1, names, ref), walls, peak


def fsdp_case(np, torch, dev, card, cfg, c, axes, one, launches):
    """``cfg`` at ``c``'s shape over an ``axes`` mesh of ``dev`` repeated
    (see the module docstring's phase 21), against ``one``
    (``fsdp_one_card``'s)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.lm import LMDataConfig, SyntheticLM
    from repro_torch.distributed import fsdp
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import steps
    from repro_torch.optim import adamw
    mesh = mesh_lib.make_mesh(axes, ("data", "model"),
                              devices=[dev] * (axes[0] * axes[1]))
    shape = ShapeConfig("fsdp", c["seq"], c["batch"], "train")
    n_mb = c["microbatches"]
    data = SyntheticLM(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=c["seq"], global_batch=c["batch"],
        microbatches=n_mb), cfg)
    plan = fsdp.plan(cfg, mesh)
    check(plan is not None, f"{cfg.name} at {axes}: no leaf over dp")
    ranks = len(steps._rank_plan(cfg, mesh, c["batch"] // n_mb))
    tp = 1 if plan.tp is None else plan.tp.tp
    (l1, g1, names, ref), walls1, peak1 = one
    torch.cuda.empty_cache()
    state = steps.init_state(cfg, seed=0, mesh=mesh)
    held = fsdp.held_bytes((state.params, state.opt), mesh).reshape(-1)
    want = dryrun.bytes_per_device(dryrun.state_structs(cfg, mesh)[0], mesh)
    whole = sum(t.numel() * t.element_size() for tree in (
        state.params, state.opt.m, state.opt.v)
        for t in adamw.tree_leaves(tree))
    print(f"phase fsdp: {cfg.name} at {axes} on "
          f"{[str(d) for d in mesh.devices.reshape(-1)]}: "
          f"{ranks} batch ranks of {c['batch'] // n_mb // ranks} rows a "
          f"microbatch, {len(next(iter(plan.slices.values())))} owners, "
          f"'model' {tp}; held state a position (parameters, AdamW "
          f"step and moments) {[round(float(h) / 1e9, 3) for h in held]} GB, "
          f"the dry run's a device "
          f"{want / 1e9:.3f} GB, the whole state {whole / 1e9:.3f} GB "
          f"({card})", flush=True)
    check(held[0] == want and held.max() == held[0],
          f"{cfg.name} at {axes}: held {held} against the dry run's {want}")
    loss, gnorm, _, leaves = step0_grads(torch, cfg, mesh, shape, n_mb,
                                         data.device_batch(0, dev), state)
    rel = max(abs(loss - l1) / abs(l1), abs(gnorm - g1) / abs(g1))
    dists = leaf_dists(torch, leaves, ref)
    worst = int(np.argmax(dists))
    del leaves, state
    torch.cuda.empty_cache()
    print(f"  step 0: one card loss {l1:.6f} grad norm {g1:.6f}; fsdp "
          f"{loss:.6f} {gnorm:.6f}: relative {rel:.2e} [{TP_TRAIN_RTOL:g}];"
          f" worst leaf {names[worst]} {dists[worst]:.3e} "
          f"[{TP_GRAD_REL:g}]", flush=True)
    check(rel <= TP_TRAIN_RTOL and dists[worst] <= TP_GRAD_REL,
          f"{cfg.name} at {axes} against one card: {rel:.2e}, "
          f"{names[worst]} {dists[worst]:.3e}")
    runs, snaps = [], []
    for run in range(2):
        state = steps.init_state(cfg, seed=0, mesh=mesh)
        step = steps.make_train_step(cfg, mesh, shape, n_mb,
                                     total_steps=100)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if run == 0:
            reset_all_launches()
        out, walls = [], []
        for i in range(c["steps"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, data.device_batch(i, dev), i)
            out.append((float(m["loss"]), float(m["grad_norm"])))
            walls.append(time.perf_counter() - t0)
        if run == 0:
            got = all_launches()
            peak = torch.cuda.max_memory_allocated() / 1e9
        runs.append((out, walls))
        snaps.append([t.cpu() for t in adamw.tree_leaves(state.params)
                      + adamw.tree_leaves(state.opt.m)])
        check(isinstance(state.params["layers"]["wo"], fsdp.Pieces),
              f"{cfg.name} at {axes}: the state is not FSDP's")
        del state, step
        torch.cuda.empty_cache()
    bitwise = runs[0][0] == runs[1][0] and all(
        torch.equal(a, b) for a, b in zip(*snaps, strict=True))
    del snaps
    # a layer's forward, its remat and its backward on every rank of
    # every batch rank, each microbatch
    per_step = cfg.num_layers * n_mb * ranks * tp
    fwd = (2 if cfg.remat == "full" else 1) * per_step * c["steps"]
    ok = (got["flash_attention_tc"] == fwd
          and got["flash_attention_bwd_tc"] == per_step * c["steps"]
          and sum(got.values()) == fwd + per_step * c["steps"])
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    print(f"  two runs of {c['steps']} steps: losses / grad norms "
          f"{runs[0][0]}, bitwise {bitwise}; s/step {runs[0][1]} / "
          f"{runs[1][1]} (one card {walls1}); peak {peak:.2f} GB (one card "
          f"{peak1:.2f}); launches {got} (expected {fwd} forwards and "
          f"{per_step * c['steps']} backwards) ({card})", flush=True)
    check(bitwise, f"{cfg.name} at {axes}: two fsdp runs differ")
    check(ok, f"{cfg.name} at {axes}: launched {got}")
    return {"ranks": ranks, "tp": tp, "held_bytes": [int(h) for h in held],
            "dryrun_bytes": want, "state_bytes": whole,
            "step0": {"one_card": [l1, g1], "fsdp": [loss, gnorm],
                      "scalar_rel": rel, "leaf_rel": dists[worst],
                      "leaf": names[worst]},
            "metrics": runs[0][0], "step_s": [r[1] for r in runs],
            "one_card_step_s": walls1, "peak_gb": peak,
            "one_card_peak_gb": peak1, "bitwise": bitwise,
            "launches": got}


def phase_fsdp(np, torch, dev, card):
    """FSDP over the dp axes (PR 35) on cuda:0 repeated: FSDP_CASES, each
    against one card on the same init and batch. Returns the numbers
    and the launch counts of each case's first run."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.lm import LMDataConfig, SyntheticLM
    t_phase = time.perf_counter()
    launches, out = {}, {}
    for c in FSDP_CASES:
        cfg = get_config(c["arch"]).replace(**c["cut"])
        if c["arch"] == "musicgen-medium":
            check_musicgen(cfg)
        else:
            check_published(get_config(c["arch"]))
        shape = ShapeConfig("fsdp", c["seq"], c["batch"], "train")
        data = SyntheticLM(LMDataConfig(
            vocab_size=cfg.vocab_size, seq_len=c["seq"],
            global_batch=c["batch"], microbatches=c["microbatches"]), cfg)
        one = fsdp_one_card(torch, cfg, shape, c, data, dev)
        for axes in c["meshes"]:
            out[f"{cfg.name} {axes}"] = fsdp_case(np, torch, dev, card, cfg,
                                                  c, axes, one, launches)
        del one
        torch.cuda.empty_cache()
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase fsdp: {out['phase_s']:.2f} s on {card}; launches on the "
          f"fsdp path: {launches}")
    return out


def main() -> int:
    if not (SRC / "repro_torch").is_dir() or not FRONTS.is_dir():
        print("chip_smoke: FAIL: run from the root of a checkout holding "
              "src/repro_torch and tests/fixtures/fronts", file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(SRC))
    from repro_torch.core import deploy
    from repro_torch.data import tabular
    from repro_torch.device import resolve_device, tf32_state
    from repro_torch.kernels import _build

    try:
        t_start = time.perf_counter()
        card = card_line()
        print(f"nvidia-smi: {card}")
        dev = resolve_device("cuda")
        kind_name = torch.cuda.get_device_name(0)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"numpy {np.__version__} device 0: {kind_name}")
        t0 = time.perf_counter()
        built = _build.build_all()
        print(f"build: {time.perf_counter() - t0:.2f} s "
              f"({', '.join(f'{k} {v:.2f} s' for k, v in built.items())})")
        for src in _build.SOURCES:
            kernels, warnings = ptxas_report(_build.build_log(src))
            for name, regs, st, ld in kernels:
                print(f"  ptxas {src}: {name}: {regs} registers, spill "
                      f"stores {st} B, spill loads {ld} B")
            for line in warnings:
                print(f"  ptxas {src}: {line}")
            if src in ("adc_quantize", "qmlp_bank"):
                # quantizer: 16-byte and word walks; banks: {MLP, SVM} x
                # {padded, unpadded} weight rows
                want = 2 if src == "adc_quantize" else 4
                check(len(kernels) == want and all(
                    st == 0 and ld == 0 for _, _, st, ld in kernels),
                      f"the {src} instantiations spill or are missing: "
                      f"{kernels}")
            if src == "mc_eval":
                # {nominal, calibrated} x {2^N = 2, 4, 8, 16, 32 in
                # registers, the shared-memory route}
                check(len(kernels) == 12 and all(
                    st == 0 and ld == 0 for _, _, st, ld in kernels),
                      f"the Monte-Carlo instantiations spill or are "
                      f"missing: {kernels}")
            if src == "flash_attention_tc":
                check(len(kernels) == 5 and all(
                    st == 0 and ld == 0 for _, _, st, ld in kernels),
                      f"the tensor-core instantiations spill or are "
                      f"missing: {kernels}")
            if src == "flash_attention":
                # 3 layouts x softcap x (f32 cp.async, f32 and bf16
                # through registers), 18; Narrow is dh <= 64, Wide<128>
                # dh <= 128
                narrow = [k for k in kernels
                          if "Narrow" in k[0] or "WideILi128E" in k[0]]
                check(len(kernels) == 18 and len(narrow) == 12 and all(
                    st == 0 and ld == 0 for _, _, st, ld in narrow),
                      f"the CUDA-core instantiations for head widths up "
                      f"to 128 spill or are missing: {kernels}")
            if src == "flash_attention_bwd_tc":
                # {row statistics, dk/dv, dq} x dh {64, 96, 112, 128, 256};
                # the dk/dv kernel above dh 64 and the dq kernel at dh 256
                # (128 accumulator registers a thread beside S, dP and
                # their fragments) spill, a known cost (PERF.md, ROADMAP §B)
                tight = [k for k in kernels
                         if not ("dkdv_tc_kernel" in k[0]
                                 and "ILi64E" not in k[0])
                         and not ("dq_tc_kernel" in k[0]
                                  and "ILi256E" in k[0])]
                check(len(kernels) == 15 and len(tight) == 10 and all(
                    st == 0 and ld == 0 for _, _, st, ld in tight),
                      f"the tensor-core backward instantiations spill or "
                      f"are missing: {kernels}")
            if src == "flash_attention_bwd":
                # {row statistics, dk/dv, dq} x {f32, bf16} x DHP {64,
                # 128, 256} x softcap
                check(len(kernels) == 36 and all(
                    st == 0 and ld == 0 for _, _, st, ld in kernels),
                      f"the backward instantiations spill or are "
                      f"missing: {kernels}")
        clock = sm_clock(torch)
        tf32 = tf32_state()
        print(f"tf32: {tf32}")
        check(not any(tf32.values()), "TF32 is on")

        data = tabular.make_dataset(DATASET)
        x_test = data["x_test"]
        fronts = {}
        for kind in ("mlp", "svm"):
            designs = deploy.load_front(FRONTS / f"cardio_{kind}")
            tables, weights = deploy.bank_arrays(designs)
            fronts[kind] = (designs, designs[0].spec, tables, weights)

        max_err, timings = phase_kernels(np, torch, dev, fronts, x_test)
        q_err, q_timings = phase_quantizer(np, torch, dev, data)
        max_err.update(q_err)
        mc_err, mc_timings = phase_mc_kernels(np, torch, dev, data)
        max_err.update(mc_err)
        autotune_out = phase_autotune(np, torch, dev, card)
        fa_err, fa_timings = phase_flash_kernels(np, torch, dev, card, clock)
        max_err.update(fa_err)
        serve_launches = phase_serve(np, torch, dev, card, fronts, data)
        search_out = phase_search(np, torch, dev, card, data)
        robust_out = phase_robust(np, torch, dev, card, data, search_out)
        gen_out = phase_generation(np, torch, dev, card, data)
        marks = [time.perf_counter()]
        baseline_out = phase_baseline(np, torch, dev, card, data)
        marks.append(time.perf_counter())
        resume_out = phase_resume(np, torch, dev, card, data)
        marks.append(time.perf_counter())
        gradient_out = phase_gradient(np, torch, dev, card, data)
        marks.append(time.perf_counter())
        cosearch_out = phase_cosearch(np, torch, dev, card)
        marks.append(time.perf_counter())
        for name, err in cosearch_out["max_err"].items():
            max_err[name] = max(max_err[name], err)
        q_timings.update(cosearch_out["timings"])
        async_out = phase_async(np, torch, dev, card, fronts, data,
                                cosearch_out.pop("async_tenant"))
        for name, err in async_out.pop("max_err").items():
            max_err[name] = max(max_err[name], err)
        marks.append(time.perf_counter())
        sharded_out = phase_sharded(np, torch, dev, card, fronts, data)
        for name, err in sharded_out.pop("max_err").items():
            max_err[name] = max(max_err[name], err)
        marks.append(time.perf_counter())
        phase_s = dict(zip(("baseline", "resume", "gradient", "cosearch",
                            "async", "sharded"), np.diff(marks).tolist()))
        print(f"phases baseline / resume / gradient / cosearch / async / "
              f"sharded: "
              f"{' / '.join(f'{v:.2f}' for v in phase_s.values())} s, "
              f"{marks[-1] - marks[0]:.2f} s in all on {card}")
        lm_out = phase_lm(np, torch, dev, card)
        t_train = time.perf_counter()
        train_out, bwd_err, bwd_timings = phase_train(np, torch, dev, card)
        max_err.update(bwd_err)
        train_out["phase_s"] = time.perf_counter() - t_train
        print(f"phase train: {train_out['phase_s']:.2f} s on {card}")
        moe_out = phase_moe(np, torch, dev, card)
        ssm_out = phase_ssm(np, torch, dev, card, clock)
        for name, err in ssm_out.pop("max_err").items():
            max_err[name] = max(max_err[name], err)
        fa_timings["hymba layer (phase ssm)"] = \
            ssm_out["hymba_rows"]["flash_attention_tc"]
        bwd_timings["hymba layer (phase ssm)"] = \
            ssm_out["hymba_rows"]["flash_attention_bwd_tc"]
        lg_out = phase_local_global_vlm(np, torch, dev, card, clock)
        for name, err in lg_out.pop("max_err").items():
            max_err[name] = max(max_err[name], err)
        for k, v in lg_out["layer_rows"].items():
            (fa_timings if v["kernel"] == "flash_attention_tc"
             else bwd_timings)[f"{k} (phase local_global_vlm)"] = v
        dp_out = phase_dp_train(np, torch, dev, card)
        dryrun_out = phase_dryrun(np, torch, dev, card)
        tp_out = phase_tp(np, torch, dev, card)
        fsdp_out = phase_fsdp(np, torch, dev, card)

        mods = sorted(m for m in sys.modules
                      if m == "jax" or m.startswith(("jax.", "jaxlib"))
                      or m == "repro" or m.startswith("repro."))
        check(not mods, f"JAX or the JAX package was imported: {mods}")

        # launches on each path, both models: serve, search, robust,
        # baseline, resume, gradient; cosearch, async, sharded, lm
        both = lambda res: {n: sum(res[k]["launches"][n]  # noqa: E731
                                   for k in ("mlp", "svm"))
                            for n in KERNELS}
        by_path = {"serve": serve_launches,
                   "search": both(search_out),
                   "robust": both(robust_out),
                   "baseline": both(baseline_out),
                   "resume": resume_out["launches"],
                   "gradient": gradient_out["launches"],
                   "cosearch": cosearch_out["launches"],
                   "async": async_out["launches"],
                   "sharded": sharded_out["launches"],
                   "lm": lm_out["launches"],
                   "lm_f32": lm_out["launches_f32"],
                   "train": train_out["launches"],
                   "train_smoke": train_out["launches_smoke"],
                   "train_cli": train_out["launches_cli"],
                   "moe": moe_out["launches"],
                   "moe_smoke": moe_out["smoke_launches"],
                   "ssm": ssm_out["launches"],
                   "ssm_smoke": ssm_out["smoke_launches"],
                   "local_global_vlm": lg_out["launches"],
                   "local_global_vlm_smoke": lg_out["smoke_launches"],
                   "dp_train": dp_out["launches"],
                   "dryrun": dryrun_out["launches"],
                   "tp": tp_out["launches"],
                   "fsdp": fsdp_out["launches"]}
        main_timing = {
            "adc_quantize": q_timings["P=1"],
            "adc_quantize_population": q_timings["search train P=16"],
            "bespoke_mlp": timings["bespoke_mlp"]["D=1"],
            "bespoke_svm": timings["bespoke_svm"]["D=1"],
            "qmlp_mlp_bank": timings["qmlp_mlp_bank"]["serve batch"],
            "qmlp_svm_bank": timings["qmlp_svm_bank"]["serve batch"],
            "mc_adc_eval": mc_timings["mc_adc_eval"]["single S=32 M=636"],
            "mc_adc_eval_population":
                mc_timings["mc_adc_eval_population"]["search P=16 S=32 M=636"],
            "mc_adc_eval_cal":
                mc_timings["mc_adc_eval_cal"]["cal single S=32 M=636"],
            "mc_adc_eval_cal_population":
                mc_timings["mc_adc_eval_cal_population"][
                    "cal search P=16 S=32 M=636"],
            "flash_attention_tc":
                fa_timings["musicgen prefill B=4 S=2048 H=KV=24 dh=64"],
            "flash_attention":
                fa_timings["musicgen prefill B=4 S=2048 H=KV=24 dh=64 f32"],
            "flash_attention_bwd_tc": bwd_timings["bfloat16"],
            "flash_attention_bwd": bwd_timings["float32"]}
        extra_timings = {"adc_quantize_population": q_timings,
                         "qmlp_mlp_bank": timings["qmlp_mlp_bank"],
                         "qmlp_svm_bank": timings["qmlp_svm_bank"],
                         **mc_timings, "flash_attention": fa_timings,
                         "flash_attention_tc": fa_timings,
                         "flash_attention_bwd": bwd_timings,
                         "flash_attention_bwd_tc": bwd_timings}
        rows = []
        for name, meta in KERNELS.items():
            paths = {path: counts.get(name, 0)
                     for path, counts in by_path.items()}
            total = sum(paths.values())
            check(total > 0, f"{name} (row {meta['row']}) never launched on "
                             f"a path")
            t = main_timing[name]
            rows.append({
                "name": name, "route": "cuda", "source": meta["source"],
                "replaces": meta["replaces"], "pallas": meta["pallas"],
                "row": meta["row"], "launches": total,
                "launches_by_path": paths, "max_abs_err": max_err[name],
                "ms": t["ms"], "kernel_ms": t["ms"],
                "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t.get("library_ms"), "shape": t["shape"],
                "timings": extra_timings.get(name)})
        summary = {"autotune": autotune_out,
                   "search": {k: {kk: vv for kk, vv in v.items()
                                  if kk != "launches"}
                              for k, v in search_out.items()},
                   "robust": {k: {kk: vv for kk, vv in v.items()
                                  if kk != "launches"}
                              for k, v in robust_out.items()},
                   "generation_defaults": gen_out,
                   "baseline": {k: {kk: vv for kk, vv in v.items()
                                    if kk != "launches"}
                                for k, v in baseline_out.items()},
                   "resume": {k: v for k, v in resume_out.items()
                              if k != "launches"},
                   "gradient": {k: v for k, v in gradient_out.items()
                                if k != "launches"},
                   "cosearch": {k: v for k, v in cosearch_out.items()
                                if k not in ("launches", "timings")},
                   "async": {k: v for k, v in async_out.items()
                             if k != "launches"},
                   "sharded": {k: v for k, v in sharded_out.items()
                               if k != "launches"},
                   "phase_s": phase_s,
                   "lm": {k: v for k, v in lm_out.items()
                          if k != "launches"},
                   "train": {k: v for k, v in train_out.items()
                             if not k.startswith("launches")},
                   "moe": {k: v for k, v in moe_out.items()
                           if not k.endswith("launches")},
                   "ssm": {k: v for k, v in ssm_out.items()
                           if not k.endswith("launches")},
                   "local_global_vlm": {k: v for k, v in lg_out.items()
                                        if not k.endswith("launches")},
                   "dp_train": {k: v for k, v in dp_out.items()
                                if k != "launches"},
                   "dryrun": {k: v for k, v in dryrun_out.items()
                              if k != "launches"},
                   "tp": {k: v for k, v in tp_out.items()
                          if k != "launches"},
                   "fsdp": {k: v for k, v in fsdp_out.items()
                            if k != "launches"},
                   "wall_s": time.perf_counter() - t_start}
        print(f"summary: {json.dumps(summary)}")
        print(json.dumps({"kernels": rows}))
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1
    print(card)                      # nvidia-smi's name and power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
