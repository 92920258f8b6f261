"""Drive the PyTorch/CUDA port (ptyrad_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON object per line each:
  1. device  - the card, torch and CUDA versions; TF32 off.
  2. build   - nvcc builds the kernels of ptyrad_tpu_torch/csrc into
               ptyrad_tpu_torch/_build and, beside them, the mixed-radix
               libraries of the fused kernels at N = 96, 120 and 127 and of
               the segmented chain at N = 192, 254, 384 and 509 (seconds,
               each), then the chain kernels' one-time set-up for N = 256,
               512, 192, 254, 384 and 509 (ops.chain.prepare) and the fused
               kernels' for N = 128, 96, 120 and 127, with the plans they
               compiled (the chain's mixed plans equal to
               ops/chain_plan.py's; at 254 and 509 Bluestein lines).
  3. kernels - each kernel against its plain PyTorch version at its main
               path's shapes (B1-B4 at tBL_WSe2's, B5/B6 at PSO's, B1/B2 at
               PSO's too), with its error, tolerance and CUDA-event times
               (median of 20 runs after warm-up; a row under 0.1 ms, and B1,
               B2 and their library calls always, as a run of 100
               back-to-back launches queued behind a device-side sleep,
               over 100) beside the plain version's, one PyTorch call's where
               one computes the same function, and the bound from bytes and
               operations. B1 and B2 at tolerance 0 (B2 against
               scatter_add_plain on the CPU, which sums in batch order as
               the kernel does, and run twice to repeat bit for bit), their
               pair launches (obja and objp at once) against two single
               launches, and the wrappers' host us per call; B3b and B4b
               (fixed-order sums over modes and samples) run twice to repeat
               bit for bit, with a per-position and a shared probe, and B3a/B3b
               again at one slice (nz = 1, the hypertune path); then the
               need_dh variants: B3a/B4a on a
               per-position H and B3b/B4b with dH at tBL shapes, B5b/B6b with
               dH at PSO shapes, each for a shared and a per-position H, dH
               held at 1e-4 of its largest entry; then B5a/B5b with the
               far-field exit (without and with dH) at PSO shapes and at
               N = 512, against chain_segment_plain(far_field=True), with the
               time of what the exit replaces (B5 without it plus one
               torch.fft.fft2 or its backward) as library_ms; then one
               propagation of the PSO batch (a row pass plus a column pass
               of B6a, torch.profiler) beside torch.fft's (fft2, the H
               product, ifft2), its bound from what the function reads and
               writes (psi in and out, a, phi and H once) and, apart, the
               two passes' own traffic at the memory rate. Then the
               bfloat16-operand kernels (csrc/multislice_bf16.cu,
               csrc/chain_bf16.cu: every line transform rounds its operand):
               B3a, B3b, B3b with dH, B4a, B4b at tBL shapes, B6a, B6b, B6b
               with dH, B5a, B5a with the far-field exit and B5b at PSO
               shapes, each against its plain twin with bf16_operands. Bfloat16
               rounding turns float32 differences into whole bfloat16 steps
               that later passes spread (BF16_RATIO_TOL), so a row holds the
               kernel's own bfloat16 error against its twin's within 10% and
               the kernel within twice that error of its twin, B3b/B4b run
               twice bit for bit; at two passes (B4a at one slice, B5a/B5b at
               one slice with the exit) the kernel is within a tenth of its
               own bfloat16 error of its twin. Each timed beside the float32
               kernel, with the float32 row's bound and library time.
               Then B3a, B3b, B3b with dH, B4a and B4b of the mixed-radix
               pair at N = 120 (PSO's widths) and 96 (tBL's), and of the
               Bluestein line at the primes 127 (a small batch, and PSO's
               widths) and 29 (PSO's widths), each at its power-of-two
               twin's tolerance, B3b/B4b run twice bit for bit, and the
               _bf16 rows at 120 and at 127 (PSO's widths) by the bf16
               gates. Then B5 and B6 of the segmented
               chain's mixed build (check_chain_npo2): at N = 192 and 254
               (PSO's widths; 254 = 2 x 127 a Bluestein line) B5a, B5a with
               the far-field exit, B5b, B5b with dH (per-position H), B5b
               with the exit, B6a, B6b, B6b with dH and the _bf16
               B5a/B5b/B6a/B6b; at 384 (B = 8) B5a and B5b with and without
               the exit; at the prime 509 (B 2, 2 modes, 3 slices, a
               Bluestein line) B5a/B5b with and without the exit, B6a and
               B6b; each at its power-of-two twin's tolerance (dH against
               the plain dH gathered with the plan's permutation, as the
               kernels give it), each backward run twice bit for bit.
     fused route - forward() (B4a, B4b) and fused_loss_terms (B3a, B3b) at
               N = 96 and 120 (the mixed-radix pair) on the card against
               the CPU, then the same cases with fwd_fused: false through the
               plain torch.fft chain (B1/B2 for the patches, no chain
               kernel), values and gradients at 1e-4 of the largest entry.
  4. main    - the tBL_WSe2 reconstruction through PtyRADSolver.run(): 16,384
               128^2 patterns simulated through forward() (B4a; every 8th
               batch held against the plain multislice_dp), 6 probe modes, 6
               slices, batch 32, Adam, loss_single + loss_sparse, the six tBL
               constraints, 3 iterations from a flat object. Asserts a
               finite, falling loss and that every kernel of the path ran
               during the run. quality: its phase correlation with the
               seeded object over the scanned square.
     mixed_precision - the same run from the same start under
               compute_dtype 'bfloat16' (B1, B2, the bf16 B3a/B3b): finite,
               falling losses; its phase correlation and its final state's
               loss through the float32 forward beside the main phase's
               (noiseless patterns: that loss measures bfloat16's rounding
               floor); patterns/s, peak memory. tBL_policy_gate: the JAX
               policy's own gate, on the same patterns with Poisson noise at
               1e5 counts, a float32 and a bfloat16 run from the same start:
               the phase correlation at most 0.005 below the float32 run's, both
               final states' loss through the same float32 forward within
               2%. A profile (tBL-bf16).
  5. profile - torch.profiler over 32 more tBL training steps: device time by
               kernel, the device's busy share, host time per step.
     params_file - the same run from its params file through the normal
               entry: the main phase's patterns written as an EMPAD .raw
               (1,024 gap bytes a frame, flipped along ky) and a .json params
               file (the yml's init_params: fitRBF, max_at_one, flipT,
               jitter 0.15, simulated probe, positions, object and tilt; every
               key written out), then load_params (validated where pydantic
               imports) -> PtyRADSolver(params, init_rng=RandomState(SEED))
               -> run(), 2 iterations. Prints which optional host packages
               import, the Initializer's seconds by stage, load_raw's GB/s,
               patterns/s and peak memory. Asserts the native .raw reader
               ran, the mean pattern's max is 1, the probe and object shapes,
               dx within 5% of the simulation's, a finite, falling loss, B1,
               B2, B3a and B3b launched and B4-B6 not; then a .npy of the
               patterns with a dx calibration, whose measurements must equal
               the patterns bit for bit.
     resume  - the tBL run at full width on the main phase's data, 3
               iterations, whose callback takes make_save_dict's checkpoint
               of iteration 2 with the optimizer state from the live run
               (seconds printed); a second solver built from that dict alone
               (resume_from: the tensors into init_variables, the optimizer
               state through optim.load_opt_state_values) runs iteration 3
               through recon_loop(start_niter=3) beside the uninterrupted
               run's: the first batch's loss, the first 8 batches' and the
               iteration's equal bit for bit (rtol 0; see resume_path), and
               a solver without the restored optimizer state must miss the
               last two.
               Where h5py imports, again through model_iter0002.hdf5 and
               load_ptyrad (write seconds printed); which routes ran is
               printed. B1, B2, B3a, B3b.
     cli     - ``python -m ptyrad_tpu_torch run --params_path`` in a
               subprocess on params_file's .raw and a .json set to 2
               iterations saved every iteration into a temporary output_dir
               (objp, obja, probe; model and optim_state where h5py
               imports): exit 0, one output folder named as
               make_output_folder names it, the params copy and the log in
               it, the objp and probe_amp TIFs of iterations 1 and 2 at
               their shapes (read back through PIL), each iteration saved
               once, finite and falling losses, the kernel library neither
               rebuilt nor replaced. Prints the seconds to training and to
               the first iteration's end, patterns/s and each save's
               seconds. cli_commands: validate-params (exit 0 on the .json,
               1 on a copy with a bad key), check-gpu and print-system-info
               (exit 0, naming the card). cli_commands, cli_mixed_precision,
               dist_cli and hypertune_cli run at once, after hypertune (each
               subprocess spends most of its seconds starting; cli's own
               start is timed alone). cli_mixed_precision: one
               iteration of ``run --mixed_precision`` in a subprocess: exit
               0, a finite loss, the log naming the policy. dist_cli:
               ``run --multihost --coordinator_address 127.0.0.1:<port>
               --num_processes 1 --process_id 0`` on the same .raw, 2
               iterations: NCCL as a world of one through the CLI, exit 0,
               the log naming process 0 / 1 and NCCL, a falling loss.
     figures - the params_file phase's .raw through run_reconstruction, 2
               iterations saved every iteration with selected_figs [loss,
               forward, probe_r_amp, pos, group]: each plot_summary's
               seconds (the forward figure's forward() is B4a on 2
               patterns, one launch per save); forward_panels finite and
               equal to the plain multislice_dp within 1e-4 of its largest
               value; every expected PNG where matplotlib imports, else
               "figures: drawing skipped, matplotlib missing".
     hypertune - run_hypertune in process on the same .raw at full width
               with demo/params/tBL_WSe2_hypertune.yml's sections (one
               slice: B3 at nz = 1): 4 trials of 2 iterations tuning scale
               and rotation, TPE (seed 0, 2 startup trials) and Hyperband
               (min_resource 1, reduction_factor 2, 2 startup trials), a
               sqlite study, objp and the loss and forward figures collated.
               Each trial's seconds and peak memory, the best trial. No
               trial FAILED (a failed trial's exception printed), the
               staged re-init moved the positions, finite values, the
               sqlite file's reports, the _error_..._tNNNN names, the last
               trial's peak memory within 10% of the first's.
     hypertune_cli - a second worker, ``python -m ptyrad_tpu_torch run
               --jobid 1``, 1 trial of 2 iterations on the same study: exit
               0, 5 trials in the study, the worker's log file.
     determinism - the main phase and the resume phase's uninterrupted run
               (the same 3 iterations on the same data) equal bit for bit:
               every batch's loss terms in every iteration, the losses and
               the final obja, objp and probe; where they part, the ops
               torch.use_deterministic_algorithms(warn_only=True) names. The
               low-dose phase runs its 2 iterations twice for the same check
               through B4b.
     lbfgs   - tBL's sections with LBFGS (history_size 10), 2 iterations: the
               objective is the mean loss of all 512 batches, evaluated
               again at every line-search step. Per-iteration losses,
               line-search steps, objective evaluations and seconds; a
               finite, falling loss, probe_pos_shifts (start_iter 10)
               unchanged bit for bit, the first value equal to the batch
               mean recomputed at the start (rtol 1e-6), and a second run
               equal bit for bit (values, line-search steps, final
               tensors). B1, B2, B3a, B3b.
     grad_accum - Adam with grad_accumulation 4, 2 iterations: a finite,
               falling loss, each tensor's Adam step count the batches over
               4, patterns/s.
     optimizers - every other registry name (AdamW with weight_decay and
               obja from iteration 2, SGD with momentum, RMSprop, Adagrad,
               Adamax, NAdam, RAdam, Adadelta, Rprop, ASGD, Adafactor, Muon,
               SparseAdam), then the optax configs beyond the torch names
               (Adam with nesterov and eps_root, mu_dtype bfloat16 for Adam,
               NAdam and Muon, SGD's accumulator_dtype, Adafactor's
               dtype_momentum, AdamW's mask and Muon's weight_decay_mask
               False), 16 tBL batches each: finite losses, each moment of a
               dtype config stored in that dtype on the card, a False mask
               equal bit for bit to its decay off; one more step on CUDA
               against the same step on CPU copies of the same parameters,
               state and gradients at rtol 1e-5, the 2-byte moments within
               one step of their type; AdamW's obja unchanged bit for bit
               before it starts.
     grouping - compact and sparse grouping of the 16,384 positions, one
               iteration each: make_batches' host seconds, every index in
               one batch, none empty, compact tighter than random and sparse
               wider than compact; "grouping: skipped, scikit-learn missing"
               where scikit-learn does not import.
     forward - one forward() of a batch with 2 object modes, shifted probes
               and detector blur (B4a, and B4b under autograd) against the
               plain multislice_dp, values and gradients. forward_bf16: under
               compute_dtype 'bfloat16', dp float32: a tBL batch through the
               bf16 B4 against the plain multislice_dp with bf16_operands, and
               N = 96 through the plain chain (fwd_fused: false; a bfloat16
               wavefield), card
               against CPU, values and gradients by the bf16 rows' gates; a
               tBL batch of loss_fn with optimizable dz and tilts (the bf16
               B3b with dH).
     low-dose - the same reconstruction with the low-dose loss mix
               (loss_poissn + loss_pacbed of demo/scripts/run_parity_midscale.py
               plus loss_sparse) on the patterns normalised as the yml asks
               (max at one): fused_loss_terms declines, so every step runs
               forward() (B4a), combined_loss and B4b, 2 iterations. Asserts a finite loss,
               B1, B2, B4a and B4b launched and B3 not; then each data term
               alone for 2 iterations, where loss_poissn must fall; then its
               torch.profiler breakdown over 32 more steps.
     dev_tools - utils/dev_tools on the card: test_loss_fn on a low-dose
               batch (B4a) against the plain route at rtol 1e-4,
               check_nan_inf and print_tree_sizes over the model, time_sync
               around one training step beside CUDA events around another,
               and trace() around a third: its Chrome trace must hold kernel
               events.
     dist_tbl, dist_low_dose - data parallelism over ranks (A6): the tBL
               data with random_object's seeded start written once as .npz,
               then two ranks spawned on cuda:0 (gloo; one card, so no
               speed-up is measured or claimed; the canvas phases' ranks,
               one spawn for both: rank_main), each taking 16 of every
               batch's 32 positions, run tBL and the low-dose mix for one
               iteration (512 steps). Gates, each kind, against the one-rank run of
               the same start on the card: the first batch's loss (rtol
               1e-5) and gradients (obja/objp atol 1e-5, probe 5e-5, shifts
               1e-7: tests/test_engine.py's mesh tolerances), each rank's
               losses at rtol 1e-4; the ranks' parameters bit for bit after
               every iteration (sha256); the path's kernels launched in each
               rank. Per rank: s/iteration, peak memory, the all-reduces a
               step, the gradient all-reduce's host ms and bytes a step.
               Reported, not gated: the ranks' tBL run from the flat start
               against the main phase, and how far float32 rounding alone
               moves either start (a one-rank run from the object times
               1 + 2^-23: about 1e-3 at iteration 2 from the flat start,
               1e-6 from the seeded one; see DIST_WORLD). The store is split
               over the ranks (shard_measurements): dist_store_split runs
               tBL again on the same ranks with it replicated and gates the
               split run against it bit for bit (losses, parameters), each
               store ceil(N/2) rows; per rank the store's bytes beside the
               replicated store's, the row exchange's calls, host ms and
               bytes a step, and peak memory.
     hypertune_dist - hypertune over ranks (A6b), in the dist ranks' spawn:
               a 2-trial study (RandomSampler, MedianPruner; the objp and
               probe rates) at tBL's widths on a 32 x 32 sub-raster of its
               data from a seeded object, 2 iterations a trial, rank 0
               holding the study, against the same study in one process on
               the card: the trial params and states equal, the values at
               rtol 1e-5, every rank running every trial, B1-B3 launched on
               each. Then one canvas trial at the largeFOV yml's widths on
               the smallest sub-raster whose slabs hold a probe (30 x 30),
               whose value must be the last loss of the plain canvas run of
               its configuration on the same ranks, bit for bit. Per rank:
               seconds and peak memory of each trial.
     canvas_largefov, canvas_fullscan - canvas sharding over ranks (A7)
               at demo/params/largeFOV_shard_canvas.yml's widths (128^2, 6
               probe modes, 1 object mode, 6 slices, batch 256, loss_single
               + loss_sparse, its four constraints) on tbl_positions'
               raster, the dist phases' two gloo ranks on cuda:0, each rank
               simulating only its slab's patterns. canvas_largefov: a
               256 x 256 scan (the yml's 512 x 512 cut), one iteration from
               random_object's seeded start, against the one-rank
               replicated run of the same per-slab batches: the first
               batch's loss (rtol 1e-6) and gradients (CANVAS_GRAD_RTOL), each
               rank's losses at rtol 1e-5, the ranks bit for bit, B1-B3
               launched in each rank; per rank peak memory beside the one
               rank's, the all_gather and all_reduce calls and bytes a step,
               the halo exchange's and the gradient all-reduce's host ms
               and bytes. canvas_fullscan: the whole 512 x 512 scan's slabs
               and store for the first 128 batches of a rank's iteration 1
               (only the patterns they read simulated), each rank's peak
               memory and seconds beside one rank's replicated peak over 16
               steps of the same scan; gates: a finite loss, the batch loss
               falling over the window, each rank's peak below the
               replicated one.
               Then B1/B2 at both phases' halo-extended slab shapes and
               B1-B3 at the batch a rank launches them on (about 150 and
               140 of each batch of 256).
  6. pso     - the PSO reconstruction (demo/params/PSO_reconstruct.yml)
               through PtyRADSolver.run(): 4,096 patterns simulated at 256^2,
               cropped to the central 120^2 and padded back to 256^2 on the
               fly, 4 probe modes, 21 slices, batch 32, the yml's Adam rates,
               loss_single, its five constraints, 2 iterations from a flat
               object. Asserts a finite, falling loss, that B1, B2, B5a/b and
               B6a/b ran and B3 did not; then one no-grad forward() of a batch
               (the yml's "forward" figure) against the plain multislice_dp.
               quality: its phase correlation with the seeded columns.
  7. profile - torch.profiler over 8 more PSO training steps.
     pso_n120 - PSO at its 120^2 crop without the on-the-fly pad (the same
               patterns, the crop's pixel), from a seeded object, 2
               iterations: B1, B2, B3a/B3b at N = 120 (the mixed-radix pair)
               and B4a for the forward figure, no plain route; a finite,
               falling loss within rtol 1e-4 of the same run with fwd_fused:
               false; a profile (PSO-n120); then the dz and tilt float64
               gate at N = 120 on its first batch (B3b with dH).
     pso_n127 - the same padded on the fly to 127^2 (the 120^2 crops
               through meas_pad_on_the_fly(.., "power", 127, threshold=70),
               the pixel 0.15 x 256 / 127 Ang): B1, B2, B3a/B3b at N = 127 (a
               prime: the Bluestein line over 256 points), B4a for the
               figure, the same gates, profile (PSO-n127) and tilt gate.
     pso_n192, pso_n254 - PSO as its yml gives it but padded on the fly
               to 192^2 and to 254^2 instead of 256^2 (the 120^2 crops
               through meas_pad_on_the_fly(.., "power", N, threshold=70), the
               pixel 0.15 x 256 / N Ang), from a seeded object, 2 iterations:
               B1, B2, B6a/B6b over 16 slices and B5a/B5b over the 5-slice
               tail at N (chain.cu's mixed build: the mixed-radix pair at
               192, a Bluestein line at 254), no B3/B4 and no plain route; a
               finite, falling loss within rtol 1e-4 of the same run with
               fwd_fused: false; a profile (PSO-n192, PSO-n254); then on its first
               batch the far-field exit (loss_fn and its backward with
               set_far_field(True) within rtol 1e-5 of the exit off, every
               B5 launch through the exit) and the dz and tilt float64 gate
               on the chain route (per-position tilts and dz optimizable:
               B5b and B6b with dH on a per-position H, against the plain
               route and float64 on the CPU).
     pso_n1024 - PSO as its yml gives it but padded on the fly to 1024^2,
               the first N above the kernels' 512: the plain route (the
               eager torch.fft chain), B1/B2 at 1024^2 windows. The first 8
               batches of iteration 1 through solver.train_epoch, four
               times from one seeded state: fwd_remat off, then on, with
               the yml's update set, and the same with dz and the tilts
               optimized. Each pair equal bit for bit (every batch's terms,
               the parameters' digest), the window's first batch's loss
               falling, the remat run's peak device memory below its
               pair's; every run through B1/B2 and the plain route 8
               times, never B3-B6. A profile over 4 steps of each yml run
               (PSO-n1024, PSO-n1024-remat); then B1/B2 at these shapes
               (32 windows of 21 x 1024^2 on a 21 x 1,721^2 canvas, the
               pair launch: 64 windows) against their plain versions, rows
               of the kernels line.
     pso_bf16 - the PSO run from the same start under compute_dtype
               'bfloat16' (the bf16 B5/B6), beside the pso phase as
               mixed_precision is beside main; from pso_ff_random_start's
               seeded object (the flat start amplifies any rounding to the
               size of the loss gate) PSO_policy_report with the yml's
               constraints (kz_filter quantizes the amplitude under the
               policy, as in the JAX package: ROADMAP C10) and
               PSO_policy_gate without the transform constraints; a profile
               (PSO-bf16).
  8. tilt    - the tBL reconstruction with optimizable slice thickness and
               per-position tilts: the 16,384 patterns simulated through
               forward() with a smooth tilt field within 1 mrad (B4a on a
               per-position H), reconstructed from zero tilts with obj_tilts
               and slice_thickness at lr 1e-4 and tilt_smooth (std 2), 2
               iterations. Asserts a finite, falling loss, moved dz and
               tilts, B1, B2, B3a (per-position H) and B3b (dH) launched and
               B4b not; then one batch's dH, dz and tilt gradients through B3
               against the plain route; then a profile over 32 steps. The
               forward phase also runs forward() with optimizable dz and
               per-position tilts (B4b with dH) against the plain chain.
     tbl_store - the tBL data binned 2 x 2 on the host to 64^2, stored as
               bfloat16 and resampled on the fly by (2, 2), 2 iterations
               through B3: a finite, falling loss, the store's type and bytes.
     constraints - all twelve constraints once on a tBL-sized model, on the
               card against the CPU.
     pso_ff  - the PSO run again on the same data after set_far_field(True):
               B5's kernel ends in the detector transform. The first batch's
               loss must equal the pso phase's at rtol 1e-5; from the flat
               start the run amplifies float32 rounding, so each iteration's
               loss is only held within 2e-2 there; every B5 launch must take
               the exit, B3 and B4 stay at 0; its profile beside pso's.
     pso_ff_random_start - the tight gates on the same path: the
               full-width PSO run from a seeded random object through the
               kernels with the exit off, with it on, and with fwd_fused:
               false (no chain kernel: cuFFT), each iteration's loss at rtol
               1e-4 against the first. Then one forward() at
               nz = 16 (the carve: B6 over one segment, a full B5 tail with
               the exit, dH) against the plain chain. Then a PSO batch of
               forward() under compute_dtype 'bfloat16' with the exit and
               optimizable dz and its backward (the bf16 B6, B5 with the exit
               and dH): dp float32 and finite.
  9. pso_tilt - the PSO reconstruction from data simulated at a global tilt
               of (1.0, -0.5) mrad, from (0, 0) with obj_tilts and
               slice_thickness at lr 1e-4, 2 iterations: a finite, falling
               loss, moved dz and tilt, B5b and B6b with dH, B3 not; then a
               profile over 8 steps.
Then a phase_seconds line (the host seconds of each phase of main, and
the whole script's), a {"kernels": [...]} line (launches summed over the driven runs: the
fused route, tBL, params_file, resume, figures, hypertune, lbfgs,
grad_accum, optimizers, grouping, low-dose (both runs), the dist ranks, tbl_store, PSO,
pso_n120 (and its tilt gate), pso_n192 and pso_n254 (with their exit
checks and tilt gates), pso_ff (with its random-start
runs and the carve), tilt (its simulation included) and PSO tilt paths,
mixed_precision, pso_bf16 and the forward phases' kernel routes, the bf16
kernels in rows of their own; B1/B2's rows at the tBL shapes count the
N <= 128 runs but the canvas ranks, their rows at the PSO shapes the N =
256, 192 and 254 runs, their rows at N = 1024 pso_n1024's windows, their
canvas slab rows the canvas ranks'), the
nvidia-smi name/power-limit line, and as the last line {"ok": true,
"device": {...}}. Any failed check raises, so the exit code is not 0 and the
last line is never printed. Exits non-zero at once without CUDA.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import gc
import hashlib
import importlib
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# the card's published peaks (H100 SXM data sheet): HBM bytes/s and FP32
# (non-tensor-core) operations/s; used for each kernel's bound
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# rows under SHORT_MS, and B1/B2 always, are timed as a run of RUN_LAUNCHES
# back-to-back launches (run_ms); SLEEP_CYCLES_PER_S sizes the device-side
# sleep that queues a run ahead of its first event (the boost clock)
SHORT_MS = 0.1
RUN_LAUNCHES = 100
SLEEP_CYCLES_PER_S = 1.98e9

N_SIDE, STEP_PX, NPIX, PMODE, NZ, BATCH = 128, 3, 128, 6, 6, 32
N_SCANS = N_SIDE * N_SIDE
NITER = 3
SIDE_NITER = 2  # the params_file, low-dose, tbl_store, tilt and hypertune trial runs
SEED = 0

# PSO (demo/params/PSO_reconstruct.yml): 64 x 64 scan at 0.41 Ang steps,
# 256^2 patterns cropped to [68, 188)^2 and padded on the fly to 256^2,
# 300 kV, 21.4 mrad, defocus -200 Ang, 4 probe modes, 21 slices of 10 Ang.
# dx = 0.15 Ang puts the bright-field disk (radius 1.087 1/Ang, 42 px)
# inside the 120^2 crop.
PSO_SIDE, PSO_NPIX, PSO_PMODE, PSO_NZ, PSO_DZ, PSO_DX = 64, 256, 4, 21, 10.0, 0.15
PSO_KV, PSO_STEP_ANG, PSO_CROP = 300.0, 0.41, (68, 188)
PSO_SCANS = PSO_SIDE * PSO_SIDE
PSO_NITER = 2
PSO_SG = 8  # ops.chain.best_sg(21): 21 = 2 x 8 + 5
PSO_FF_FLAT_RTOL = 2e-2  # pso_ff against pso from the flat start (see pso_ff_path)
# The fused kernels at N that is not a power of two (one library per N,
# built beside the main one): PSO's 120^2 crop without the on-the-fly pad
# (pso_n120) and 96 (the fused route check, tBL widths) on the mixed-radix
# pair; the prime 127 on a Bluestein line over 256 points (a small-batch row
# set, the rows at PSO widths, and pso_n127: the crops padded on the fly);
# the prime 29 on a Bluestein line over 64 points (rows at PSO widths)
PSO_N120 = PSO_CROP[1] - PSO_CROP[0]
NPO2_NS = (96, PSO_N120)
PRIME_N = 127
SMALL_PRIME_N = 29
MIXED_NS = NPO2_NS + (PRIME_N, SMALL_PRIME_N)
PSO_FUSED = (PSO_N120, PRIME_N)  # pso_n120, and pso_n127: the crops padded on the fly to 127^2
# The segmented chain at N in (128, 512] that is not a power of two
# (chain.cu's mixed-radix build, one library per N, built beside the main
# one): PSO padded on the fly to 192^2 (pso_n192) and to 254^2 = 2 x 127
# (pso_n254, a Bluestein line over 512 points), 384 (a three-pass plan, the
# 512^2 far-field rows' batch) and the prime 509 (a Bluestein line over
# 1,024 points, a small-batch row set)
PSO_N192 = 192
PSO_N254 = 254
PSO_PADS = (PSO_N192, PSO_N254)  # the N that PSO is padded to on the fly
CHAIN_PRIME_N = 509
CHAIN_NS = (PSO_N192, PSO_N254, 384, CHAIN_PRIME_N)
# the mixed N whose _bf16 twins a row runs (FUSED_BF16_ROWS, chain_npo2_bf16_rows):
# only their twins' libraries are built
BF16_MIXED_NS = (PSO_N120, PRIME_N) + PSO_PADS
SIM_BATCH = 512  # patterns per forward() call when simulating the tBL data

# tBL_WSe2 sections of demo/params/tBL_WSe2_reconstruct.yml (the card's
# machine has no yaml reader)
TBL_PARAMS = {
    "model_params": {
        "optimizer_params": {"name": "Adam"},
        "update_params": {
            "obja": {"start_iter": 1, "lr": 5.0e-4},
            "objp": {"start_iter": 1, "lr": 5.0e-4},
            "probe": {"start_iter": 1, "lr": 1.0e-4},
            "probe_pos_shifts": {"start_iter": 10, "lr": 1.0e-4},
            "obj_tilts": {"start_iter": None, "lr": 0},
            "slice_thickness": {"start_iter": None, "lr": 0},
        },
    },
    "loss_params": {
        "loss_single": {"state": True, "weight": 1.0, "dp_pow": 0.5},
        "loss_sparse": {"state": True, "weight": 0.1, "ln_order": 1},
    },
    "constraint_params": {
        "ortho_pmode": {"freq": 1},
        "fix_probe_int": {"freq": 1},
        "obj_rblur": {"freq": 1, "obj_type": "both", "kernel_size": 5, "std": 0.5},
        "obj_zblur": {"freq": 1, "obj_type": "both", "kernel_size": 5, "std": 1.0},
        "obja_thresh": {"freq": 1, "relax": 0, "thresh": [0.98, 1.02]},
        "objp_postiv": {"freq": 1, "relax": 0, "mode": "clip_neg"},
    },
    "recon_params": {
        "NITER": NITER,
        "BATCH_SIZE": {"size": BATCH},
        "GROUP_MODE": "random",
        "GROUP_MODE_SEED": SEED,
    },
}


# The low-dose loss surface: POISSN_LOSS of demo/scripts/run_parity_midscale.py
# (:252-259) plus the tBL yml's loss_sparse, on the tBL sections otherwise
LOW_DOSE_PARAMS = {
    **TBL_PARAMS,
    "recon_params": {**TBL_PARAMS["recon_params"], "NITER": SIDE_NITER},
    "loss_params": {
        "loss_single": {"state": False, "weight": 0.0, "dp_pow": 0.5},
        "loss_poissn": {"state": True, "weight": 1.0, "dp_pow": 1.0, "eps": 1e-6},
        "loss_pacbed": {"state": True, "weight": 0.5, "dp_pow": 0.2},
        "loss_sparse": {"state": True, "weight": 0.1, "ln_order": 1},
    },
}


PSO_PARAMS = {
    "model_params": {
        "optimizer_params": {"name": "Adam"},
        "update_params": {
            "obja": {"start_iter": 1, "lr": 5.0e-4},
            "objp": {"start_iter": 1, "lr": 5.0e-4},
            "probe": {"start_iter": 1, "lr": 1.0e-4},
            "probe_pos_shifts": {"start_iter": 10, "lr": 1.0e-4},
            "obj_tilts": {"start_iter": None, "lr": 0},
            "slice_thickness": {"start_iter": None, "lr": 0},
        },
    },
    "loss_params": {"loss_single": {"state": True, "weight": 1.0, "dp_pow": 0.5}},
    "constraint_params": {
        "ortho_pmode": {"freq": 1},
        "fix_probe_int": {"freq": 1},
        "kz_filter": {"freq": 1, "obj_type": "both", "beta": 1.0, "alpha": 1.0},
        "obja_thresh": {"freq": 1, "relax": 0, "thresh": [0.98, 1.02]},
        "objp_postiv": {"freq": 1, "relax": 0, "mode": "clip_neg"},
    },
    "recon_params": {
        "NITER": PSO_NITER,
        "BATCH_SIZE": {"size": BATCH},
        "GROUP_MODE": "random",
        "GROUP_MODE_SEED": SEED,
    },
}


_EMIT_LOCK = threading.Lock()  # the CLI phases that run at once emit from threads


def emit(obj: dict) -> None:
    with _EMIT_LOCK:
        print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _event_ms(fn, reps: int, warmup: int) -> float:
    """Median CUDA-event time of single calls of fn() in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run_ms(fn, launches: int = RUN_LAUNCHES, runs: int = 5) -> float:
    """Device ms per call of fn() over a run of `launches` back-to-back calls
    between one pair of CUDA events, the median of `runs` runs. Before each
    run a device-side sleep (twice the host's time to queue the run, from
    host_us) holds the stream, so the host has queued every call before the
    first event fires: the events time the device's work, not the host's
    launch path."""
    queue_s = launches * host_us(fn, reps=20) * 1e-6
    sleep_cycles = int(2.0 * queue_s * SLEEP_CYCLES_PER_S)
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """CUDA-event time of fn() in ms: the median of `reps` single calls, or,
    where that is under SHORT_MS, run_ms's time per call of a run."""
    one = _event_ms(fn, reps, warmup)
    return one if one >= SHORT_MS else run_ms(fn)


def host_us(fn, reps: int = 200) -> float:
    """Host us per call of fn(): a host clock around each call, after a
    synchronise so that the queue is empty and the call never waits on the
    device; the median of `reps` calls."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tbl_probe() -> np.ndarray:
    from ptyrad_tpu_torch.physics import make_mixed_probe, make_stem_probe

    probe = make_stem_probe({"kv": 80.0, "conv_angle": 24.9, "Npix": NPIX, "dx": 0.1494})
    return make_mixed_probe(probe, PMODE, [0.02])


def tbl_positions() -> tuple[np.ndarray, int]:
    canvas = N_SIDE * STEP_PX + NPIX + 8
    ys, xs = np.meshgrid(np.arange(N_SIDE) * STEP_PX, np.arange(N_SIDE) * STEP_PX,
                         indexing="ij")
    return np.stack([ys.ravel() + 4, xs.ravel() + 4], -1).astype(np.int32), canvas


# -- phase 3: kernels against their plain versions ---------------------------

PSO_SHAPES = " (PSO shapes)"  # name suffix of the B1/B2 rows at the PSO shapes


def patch_corners(dev, gen, corners: np.ndarray, h: int, w: int, n: int,
                  batch: int = BATCH) -> torch.Tensor:
    """``batch`` corners drawn from `corners` with the edge cases of the
    kernel checks: one past the last corner, one negative (both clamped) and
    a window three times over."""
    pick = torch.randperm(len(corners), generator=gen, device=dev)[:batch].cpu().numpy()
    pos = torch.as_tensor(corners[pick], device=dev)
    pos[0] = torch.tensor([h - n + 9, w - n + 3])  # past the last corner: clamped
    pos[1] = torch.tensor([-4, 7])                  # negative: clamped
    pos[3] = pos[2]                                 # duplicate windows
    pos[4] = pos[2]
    return pos.contiguous()


def check_patches_at(dev, gen, lmodes: int, h: int, w: int, n: int, pos: torch.Tensor,
                     suffix: str, atomic_b2: bool = False,
                     launches: int = RUN_LAUNCHES) -> list:
    """B1 and B2 at one shape: a (1, lmodes, h, w) canvas, len(pos) n^2
    windows at `pos`. B1 against advanced indexing and B2 against scatter_add_plain on
    the CPU, both at tolerance 0; B2 run twice must repeat bit for bit; the
    pair launch against two single launches. The kernels and their library
    calls are timed as runs of back-to-back launches (run_ms), with the
    wrapper's host us per call apart. `atomic_b2` is for a tree from before
    the pair launch, whose B2 summed with atomics (chain_bench.py
    --atomic-b2 times one): B2 held at rtol 1e-5 of the largest sum, with
    no repeat check and no pair rows. `launches`: of each timed run."""
    from ptyrad_tpu_torch.ops import patches as P

    shape, batch = (n, n), len(pos)

    def run(fn):
        return run_ms(fn, launches)

    canvas = torch.rand((1, lmodes, h, w), generator=gen, device=dev)
    canvas_p = torch.rand((1, lmodes, h, w), generator=gen, device=dev)
    out_k = P.gather_cuda(canvas, pos, shape)
    err_g = float((out_k - P.gather_plain(canvas, pos, shape)).abs().max())
    iy, ix = P._clamped_index(pos, (h, w), shape)
    covered = np.zeros((h, w), bool)
    for y, x in np.minimum(pos.clamp(min=0).cpu().numpy(), [h - n, w - n]):
        covered[y:y + n, x:x + n] = True
    g_bound, g_by = bound(4 * (lmodes * covered.sum() + out_k.numel()) + pos.numel() * 4, 0)
    gather = {
        "name": "B1 gather_patches" + suffix, "route": "cuda",
        "source": "ptyrad_tpu_torch/csrc/patches.cu",
        "replaces": "ptyrad_tpu/ops/patches.py:136",
        "shape": {"canvas": [1, lmodes, h, w], "batch": batch, "window": n},
        "max_abs_err": err_g, "tolerance": 0.0,
        "ms": run(lambda: P.gather_cuda(canvas, pos, shape)),
        "host_us": host_us(lambda: P.gather_cuda(canvas, pos, shape)),
        "plain_ms": time_ms(lambda: P.gather_plain(canvas, pos, shape)),
        "library_ms": run(lambda: canvas[..., iy, ix]),
        "bound_ms": g_bound, "bound_by": g_by,
    }
    if not atomic_b2:
        pair = P.gather_pair_cuda(canvas, canvas_p, pos, shape)
        require(torch.equal(pair[0], out_k)
                and torch.equal(pair[1], P.gather_cuda(canvas_p, pos, shape)),
                f"B1{suffix}: the pair launch differs from two single launches")
        gather["pair_ms"] = run(lambda: P.gather_pair_cuda(canvas, canvas_p, pos, shape))
    del out_k
    emit({"phase": "kernel", **gather, "note": "bit-exact against advanced indexing"})
    require(err_g == 0.0, f"B1{suffix} gather differs from its plain version: {err_g}")

    cshape = (1, lmodes, h, w)
    grads = torch.randn((batch, 1, lmodes, n, n), generator=gen, device=dev)
    grads_p = torch.randn((batch, 1, lmodes, n, n), generator=gen, device=dev)
    sc_k = P.scatter_add_cuda(cshape, grads, pos)
    ref = P.scatter_add_plain(cshape, grads.cpu(), pos.cpu())
    err_s = float((sc_k.cpu() - ref).abs().max())
    tol_s = 1e-5 * float(ref.abs().max()) if atomic_b2 else 0.0
    repeats = torch.equal(sc_k, P.scatter_add_cuda(cshape, grads, pos))
    flat = ((torch.arange(lmodes, device=dev)[:, None, None, None] * h + iy) * w + ix)
    flat = flat.expand(lmodes, batch, n, n).reshape(-1)
    vals = grads[:, 0].transpose(0, 1).reshape(-1)
    s_bound, s_by = bound(4 * (grads.numel() + lmodes * h * w) + pos.numel() * 4, grads.numel())
    scatter = {
        "name": "B2 scatter_add_patches" + suffix, "route": "cuda",
        "source": "ptyrad_tpu_torch/csrc/patches.cu",
        "replaces": "ptyrad_tpu/ops/patches.py:98",
        "shape": {"canvas": list(cshape), "batch": batch, "window": n},
        "max_abs_err": err_s, "tolerance": tol_s, "repeats_bit_for_bit": repeats,
        "ms": run(lambda: P.scatter_add_cuda(cshape, grads, pos)),
        "host_us": host_us(lambda: P.scatter_add_cuda(cshape, grads, pos)),
        "plain_ms": time_ms(lambda: P.scatter_add_plain(cshape, grads, pos)),
        "library_ms": run(lambda: torch.zeros(lmodes * h * w, device=dev).index_put_(
            (flat,), vals, accumulate=True)),
        "bound_ms": s_bound, "bound_by": s_by,
    }
    if not atomic_b2:
        pair = P.scatter_add_pair_cuda(cshape, grads, grads_p, pos)
        require(torch.equal(pair[0], sc_k)
                and torch.equal(pair[1], P.scatter_add_cuda(cshape, grads_p, pos)),
                f"B2{suffix}: the pair launch differs from two single launches")
        scatter["pair_ms"] = run(
            lambda: P.scatter_add_pair_cuda(cshape, grads, grads_p, pos))
        require(repeats, f"B2{suffix}: two runs differ")
    emit({"phase": "kernel", **scatter,
          "note": ("atomics: order varies run to run; rtol 1e-5 of the largest sum"
                   if atomic_b2 else "batch-order sums: bit-exact against the CPU's index_add_")})
    require(err_s <= tol_s, f"B2{suffix} scatter differs from its plain version: "
                            f"{err_s} > {tol_s}")
    return [gather, scatter]


def check_patches(dev, gen, atomic_b2: bool = False) -> list:
    """B1 and B2 at the tBL shapes (canvas 6 x 520 x 520, 128^2 windows on
    tbl_positions' raster) and at the PSO shapes (21 x 436 x 436, 256^2
    windows on pso_positions')."""
    corners, side = tbl_positions()
    rows = check_patches_at(dev, gen, NZ, side, side, NPIX,
                            patch_corners(dev, gen, corners, side, side, NPIX), "", atomic_b2)
    torch.cuda.empty_cache()
    corners, side = pso_positions()
    rows += check_patches_at(dev, gen, PSO_NZ, side, side, PSO_NPIX,
                             patch_corners(dev, gen, corners, side, side, PSO_NPIX), PSO_SHAPES,
                             atomic_b2)
    return rows


def _chain_flops(n: int, n_fft: int, nz: int) -> float:
    """FP32 operations of one wavefield's chain: n_fft 2D FFTs at
    10 N^2 log2 N each, plus the T and H complex products (6 each)."""
    nn = n * n
    return n_fft * 10 * nn * np.log2(n) + (2 * nz - 1) * 6 * nn


def repeats_bitwise(fn, first) -> bool:
    """Does a second call of fn() give the tensors of ``first`` bit for
    bit? (B3b/B4b reduce over modes and samples in a fixed order.)"""
    return all(torch.equal(a, b) for a, b in zip(first, fn()))


def check_loss_chain(dev, gen, atomic_b3: bool = False, batch: int = BATCH,
                     suffix: str = "") -> list:
    """B3a/B3b against loss_sums_plain and its autograd VJP at tBL shapes,
    ``batch`` patterns, for per-position probe spectra (the main path's
    case, which is timed) and a shared real-space probe; B3b run twice must
    repeat bit for bit (``atomic_b3``: a tree from before the fixed-order
    reduce, whose B3b added with atomics; chain_bench.py --atomic-b3 times
    one). The rows' names end in ``suffix``; the one-slice rows
    (check_loss_chain_one_slice) come with the tBL batch's rows alone."""
    from ptyrad_tpu_torch.ops import fused_multislice as M
    from ptyrad_tpu_torch.ops.shift import fourier_shift_kspace
    from ptyrad_tpu_torch.physics import electron_wavelength, near_field_evolution

    n = NPIX
    lam = electron_wavelength(80.0)
    probe = torch.as_tensor(tbl_probe(), device=dev)
    h = torch.as_tensor(near_field_evolution((n, n), 0.1494, 2.0, lam), device=dev)[None]
    obja = 1.0 + 0.05 * torch.randn((batch, 1, NZ, n, n), generator=gen, device=dev)
    objp = 0.1 * torch.randn((batch, 1, NZ, n, n), generator=gen, device=dev)
    shifts = 0.3 * torch.randn((batch, 2), generator=gen, device=dev)
    meas = torch.rand((batch, n, n), generator=gen, device=dev) * 2e-4
    mask = torch.ones(batch, device=dev)
    mask[batch - 1] = 0.0  # a padded tail sample
    p, eps, c = 0.5, 1e-10, 0.7
    results = {}
    for kspace in (True, False):
        pr = fourier_shift_kspace(probe, shifts) if kspace else probe[None]
        args = (meas, mask, p, eps)
        s1k, s2k, dp = M.loss_sums_fwd_cuda(obja, objp, pr, h, *args, kspace)
        with torch.no_grad():
            s1p, s2p = M.loss_sums_plain(obja, objp, pr, h, *args, kspace)
        err_fwd = max(abs(float(s1k - s1p)), abs(float(s2k - s2p)))
        # float32 chains of 12 transforms by two FFT algorithms: rtol 1e-4
        tol_fwd = 1e-4 * max(abs(float(s1p)), abs(float(s2p)))

        leaves = [t.clone().requires_grad_(True) for t in (obja, objp, pr)]
        s1_plain, _ = M.loss_sums_plain(*leaves, h, *args, kspace)
        cvec = torch.tensor(c, device=dev)
        g_plain = torch.autograd.grad(s1_plain, leaves, grad_outputs=cvec, retain_graph=True)
        def bwd(pr=pr, dp=dp, kspace=kspace):
            return M.loss_sums_bwd_cuda(obja, objp, pr, h, meas, mask, dp, cvec, p, eps,
                                        kspace)[:3]

        g_kern = bwd()
        repeat = repeats_bitwise(bwd, g_kern)
        errs = [float((a - b).abs().max()) for a, b in zip(g_kern, g_plain)]
        scales = [float(b.abs().max()) for b in g_plain]
        # 24 transforms by two FFT algorithms: 1e-4 of each cotangent's largest entry
        tols = [1e-4 * s for s in scales]
        err_bwd = max(errs)
        emit({"phase": "kernel_check", "name": "B3 loss chain" + suffix, "kspace": kspace,
              "batch": batch,
              "shared_probe": not kspace,
              "s1": [float(s1k), float(s1p)], "s2": [float(s2k), float(s2p)],
              "fwd_max_abs_err": err_fwd, "fwd_tolerance": tol_fwd,
              "bwd_max_abs_err": errs, "bwd_tolerance": tols,
              "bwd_names": ["d obja", "d objp", "d probe"], "bwd_repeats_bitwise": repeat})
        require(err_fwd <= tol_fwd,
                f"B3a{suffix} (kspace={kspace}) differs: {err_fwd} > {tol_fwd}")
        require(repeat or atomic_b3, f"B3b{suffix} (kspace={kspace}) run twice differs")
        for name, e, t in zip(("obja", "objp", "probe"), errs, tols):
            require(e <= t, f"B3b{suffix} d{name} (kspace={kspace}) differs: {e} > {t}")
        results[kspace] = (pr, dp, err_fwd, err_bwd, s1_plain, leaves, cvec)

    # times at the main path's case (per-position probe spectra)
    pr, dp, err_fwd, err_bwd, s1_plain, leaves, cvec = results[True]
    n_wave = batch * PMODE
    in_bytes = 4 * (obja.numel() + objp.numel() + meas.numel() + mask.numel()) \
        + 8 * (pr.numel() + h.numel())
    f_bound, f_by = bound(in_bytes + 8, n_wave * _chain_flops(n, 2 * NZ, NZ))
    b_bytes = in_bytes + 4 * dp.numel() + 4 * (obja.numel() + objp.numel()) + 8 * pr.numel()
    b_bound, b_by = bound(b_bytes, n_wave * 2 * _chain_flops(n, 2 * NZ, NZ))
    fwd = {
        "name": "B3a loss_sums_fwd" + suffix, "route": "cuda",
        "source": "ptyrad_tpu_torch/csrc/multislice.cu",
        "replaces": "ptyrad_tpu/ops/pallas_multislice.py:548",
        "max_abs_err": err_fwd,
        "ms": time_ms(lambda: M.loss_sums_fwd_cuda(obja, objp, pr, h, meas, mask, p, eps, True)),
        "plain_ms": time_ms(lambda: M.loss_sums_plain(obja, objp, pr, h, meas, mask, p, eps,
                                                      True)),
        "library_ms": None, "bound_ms": f_bound, "bound_by": f_by,
    }
    bwd = {
        "name": "B3b loss_sums_bwd" + suffix, "route": "cuda",
        "source": "ptyrad_tpu_torch/csrc/multislice.cu",
        "replaces": "ptyrad_tpu/ops/pallas_multislice.py:588",
        "max_abs_err": err_bwd,
        "ms": time_ms(lambda: M.loss_sums_bwd_cuda(obja, objp, pr, h, meas, mask, dp, cvec, p,
                                                   eps, True)),
        "plain_ms": time_ms(lambda: torch.autograd.grad(s1_plain, leaves, grad_outputs=cvec,
                                                        retain_graph=True)),
        "library_ms": None, "bound_ms": b_bound, "bound_by": b_by,
    }
    for k in (fwd, bwd):
        emit({"phase": "kernel", **k, "shape": {"batch": batch},
              "note": "kspace probe, the main path's case"})
    if suffix:
        return [fwd, bwd]
    return [fwd, bwd] + check_loss_chain_one_slice(obja, objp, pr, h, meas, mask, p, eps, cvec,
                                                   atomic_b3)


def check_loss_chain_one_slice(obja, objp, pr, h, meas, mask, p, eps, cvec,
                               atomic_b3: bool = False) -> list:
    """B3a/B3b at nz = 1 (the hypertune demo's obj_Nlayer: 1, no
    propagation in the chain) against loss_sums_plain and its VJP, with the
    per-position probe spectra of the main path, at check_loss_chain's
    tolerances; B3b run twice must repeat bit for bit."""
    from ptyrad_tpu_torch.ops import fused_multislice as M

    n = NPIX
    a1, p1 = obja[:, :, :1].contiguous(), objp[:, :, :1].contiguous()
    args = (meas, mask, p, eps, True)
    s1k, s2k, dp = M.loss_sums_fwd_cuda(a1, p1, pr, h, *args)
    with torch.no_grad():
        s1p, s2p = M.loss_sums_plain(a1, p1, pr, h, *args)
    err_fwd = max(abs(float(s1k - s1p)), abs(float(s2k - s2p)))
    tol_fwd = 1e-4 * max(abs(float(s1p)), abs(float(s2p)))
    leaves = [t.clone().requires_grad_(True) for t in (a1, p1, pr)]
    s1_plain, _ = M.loss_sums_plain(*leaves, h, *args)
    g_plain = torch.autograd.grad(s1_plain, leaves, grad_outputs=cvec, retain_graph=True)

    def bwd():
        return M.loss_sums_bwd_cuda(a1, p1, pr, h, meas, mask, dp, cvec, p, eps, True)[:3]

    g_kern = bwd()
    repeat = repeats_bitwise(bwd, g_kern)
    errs = [float((a - b).abs().max()) for a, b in zip(g_kern, g_plain)]
    tols = [1e-4 * float(b.abs().max()) for b in g_plain]
    emit({"phase": "kernel_check", "name": "B3 loss chain, nz = 1", "kspace": True,
          "s1": [float(s1k), float(s1p)], "s2": [float(s2k), float(s2p)],
          "fwd_max_abs_err": err_fwd, "fwd_tolerance": tol_fwd, "bwd_max_abs_err": errs,
          "bwd_tolerance": tols, "bwd_names": ["d obja", "d objp", "d probe"],
          "bwd_repeats_bitwise": repeat})
    require(err_fwd <= tol_fwd, f"B3a (nz = 1) differs: {err_fwd} > {tol_fwd}")
    require(repeat or atomic_b3, "B3b (nz = 1) run twice differs")
    for name, e, t in zip(("obja", "objp", "probe"), errs, tols):
        require(e <= t, f"B3b d{name} (nz = 1) differs: {e} > {t}")
    n_wave = BATCH * PMODE
    in_bytes = 4 * (a1.numel() + p1.numel() + meas.numel() + mask.numel()) \
        + 8 * (pr.numel() + h.numel())
    f_bound, f_by = bound(in_bytes + 8, n_wave * _chain_flops(n, 2, 1))
    b_bytes = in_bytes + 4 * dp.numel() + 4 * (a1.numel() + p1.numel()) + 8 * pr.numel()
    b_bound, b_by = bound(b_bytes, n_wave * 2 * _chain_flops(n, 2, 1))
    fwd = {
        "name": "B3a loss_sums_fwd (nz=1)", "route": "cuda",
        "source": "ptyrad_tpu_torch/csrc/multislice.cu",
        "replaces": "ptyrad_tpu/ops/pallas_multislice.py:548",
        "max_abs_err": err_fwd,
        "ms": time_ms(lambda: M.loss_sums_fwd_cuda(a1, p1, pr, h, *args)),
        "plain_ms": time_ms(lambda: M.loss_sums_plain(a1, p1, pr, h, *args)),
        "library_ms": None, "bound_ms": f_bound, "bound_by": f_by,
    }
    bwd_row = {
        "name": "B3b loss_sums_bwd (nz=1)", "route": "cuda",
        "source": "ptyrad_tpu_torch/csrc/multislice.cu",
        "replaces": "ptyrad_tpu/ops/pallas_multislice.py:588",
        "max_abs_err": max(errs),
        "ms": time_ms(bwd),
        "plain_ms": time_ms(lambda: torch.autograd.grad(s1_plain, leaves, grad_outputs=cvec,
                                                        retain_graph=True)),
        "library_ms": None, "bound_ms": b_bound, "bound_by": b_by,
    }
    for k in (fwd, bwd_row):
        emit({"phase": "kernel", **k, "note": "kspace probe, one slice: the hypertune path"})
    return [fwd, bwd_row]


def check_dp_chain(dev, gen, atomic_b3: bool = False) -> list:
    """B4a/B4b against multislice_dp_plain and its autograd VJP at tBL
    shapes, for per-position probe spectra (the low-dose path's case, which
    is timed) and a shared real-space probe; B4b run twice must repeat bit
    for bit (``atomic_b3`` as in check_loss_chain)."""
    from ptyrad_tpu_torch.ops import fused_multislice as M
    from ptyrad_tpu_torch.ops.shift import fourier_shift_kspace
    from ptyrad_tpu_torch.physics import electron_wavelength, near_field_evolution

    n = NPIX
    lam = electron_wavelength(80.0)
    probe = torch.as_tensor(tbl_probe(), device=dev)
    h = torch.as_tensor(near_field_evolution((n, n), 0.1494, 2.0, lam), device=dev)[None]
    obja = 1.0 + 0.05 * torch.randn((BATCH, 1, NZ, n, n), generator=gen, device=dev)
    objp = 0.1 * torch.randn((BATCH, 1, NZ, n, n), generator=gen, device=dev)
    shifts = 0.3 * torch.randn((BATCH, 2), generator=gen, device=dev)
    g = torch.randn((BATCH, n, n), generator=gen, device=dev)
    results = {}
    for kspace in (True, False):
        pr = fourier_shift_kspace(probe, shifts) if kspace else probe[None]
        dp_k = M.dp_fwd_cuda(obja, objp, pr, h, kspace)
        leaves = [t.clone().requires_grad_(True) for t in (obja, objp, pr)]
        dp_p = M.multislice_dp_plain(*leaves, h, kspace)
        err_fwd = float((dp_k - dp_p.detach()).abs().max())
        # float32 chains of 12 transforms by two FFT algorithms: 1e-4 of the
        # largest intensity, as for B3
        tol_fwd = 1e-4 * float(dp_p.detach().abs().max())
        g_plain = torch.autograd.grad(dp_p, leaves, grad_outputs=g, retain_graph=True)
        def bwd(pr=pr, kspace=kspace):
            return M.dp_bwd_cuda(obja, objp, pr, h, g, kspace)[:3]

        g_kern = bwd()
        repeat = repeats_bitwise(bwd, g_kern)
        errs = [float((a - b).abs().max()) for a, b in zip(g_kern, g_plain)]
        # 24 transforms by two FFT algorithms, sums over modes (and over
        # samples for a shared probe) in another order: 1e-4 of each
        # cotangent's largest entry
        tols = [1e-4 * float(b.abs().max()) for b in g_plain]
        emit({"phase": "kernel_check", "name": "B4 dp chain", "kspace": kspace,
              "shared_probe": not kspace, "fwd_max_abs_err": err_fwd, "fwd_tolerance": tol_fwd,
              "bwd_max_abs_err": errs, "bwd_tolerance": tols,
              "bwd_names": ["d obja", "d objp", "d probe"], "bwd_repeats_bitwise": repeat})
        require(err_fwd <= tol_fwd, f"B4a (kspace={kspace}) differs: {err_fwd} > {tol_fwd}")
        require(repeat or atomic_b3, f"B4b (kspace={kspace}) run twice differs")
        for name, e, t in zip(("obja", "objp", "probe"), errs, tols):
            require(e <= t, f"B4b d{name} (kspace={kspace}) differs: {e} > {t}")
        results[kspace] = (pr, err_fwd, max(errs), dp_p, leaves)

    pr, err_fwd, err_bwd, dp_p, leaves = results[True]
    n_wave = BATCH * PMODE
    in_bytes = 4 * (obja.numel() + objp.numel()) + 8 * (pr.numel() + h.numel())
    dp_bytes = 4 * g.numel()  # B4a's output, B4b's cotangent input
    f_bound, f_by = bound(in_bytes + dp_bytes, n_wave * _chain_flops(n, 2 * NZ, NZ))
    b_bytes = in_bytes + dp_bytes + 4 * (obja.numel() + objp.numel()) + 8 * pr.numel()
    b_bound, b_by = bound(b_bytes, n_wave * 2 * _chain_flops(n, 2 * NZ, NZ))
    fwd = {
        "name": "B4a dp_fwd", "route": "cuda",
        "source": "ptyrad_tpu_torch/csrc/multislice.cu",
        "replaces": "ptyrad_tpu/ops/pallas_multislice.py:128",
        "max_abs_err": err_fwd,
        "ms": time_ms(lambda: M.dp_fwd_cuda(obja, objp, pr, h, True)),
        "plain_ms": time_ms(lambda: M.multislice_dp_plain(obja, objp, pr, h, True)),
        "library_ms": None, "bound_ms": f_bound, "bound_by": f_by,
    }
    bwd = {
        "name": "B4b dp_bwd", "route": "cuda",
        "source": "ptyrad_tpu_torch/csrc/multislice.cu",
        "replaces": "ptyrad_tpu/ops/pallas_multislice.py:145",
        "max_abs_err": err_bwd,
        "ms": time_ms(lambda: M.dp_bwd_cuda(obja, objp, pr, h, g, True)),
        "plain_ms": time_ms(lambda: torch.autograd.grad(dp_p, leaves, grad_outputs=g,
                                                        retain_graph=True)),
        "library_ms": None, "bound_ms": b_bound, "bound_by": b_by,
    }
    for k in (fwd, bwd):
        emit({"phase": "kernel", **k, "note": "kspace probe, the low-dose path's case"})
    return [fwd, bwd]


def pso_probe(npix: int = PSO_NPIX) -> np.ndarray:
    from ptyrad_tpu_torch.physics import make_mixed_probe, make_stem_probe

    probe = make_stem_probe({"kv": PSO_KV, "conv_angle": 21.4, "Npix": npix,
                             "dx": PSO_DX, "df": -200.0})
    return make_mixed_probe(probe, PSO_PMODE, [0.02])


def _chain_ops(n: int, n_wave: int, n_prop: int, n_t: int, n_adj_t: int = 0) -> float:
    """FP32 operations of a chain call: each propagation a 2D FFT and a 2D
    IFFT (10 N^2 log2 N each) and the H product (6 N^2); each T product
    6 N^2; each adjoint slice 12 N^2 (d chi conj(T) and d chi conj(psi))."""
    nn = n * n
    return n_wave * (n_prop * (20 * nn * np.log2(n) + 6 * nn) + n_t * 6 * nn
                     + n_adj_t * 12 * nn)


def check_chain(dev, gen) -> list:
    """B5a/B5b and B6a/B6b at the PSO shapes the main path gives them: B6
    over S = 2 segments of sg = 8 slices with a ragged tail after it
    (last_mega False), B5 over the 5-slice tail (last True; last False is
    checked too). The a/phi operands are views into (B, 1, 21, N, N)
    patches, as multislice_dp_chain passes them."""
    from ptyrad_tpu_torch.ops import chain as C
    from ptyrad_tpu_torch.ops.shift import fourier_shift
    from ptyrad_tpu_torch.physics import electron_wavelength, near_field_evolution

    n, b, pm = PSO_NPIX, BATCH, PSO_PMODE
    lam = electron_wavelength(PSO_KV)
    h = torch.as_tensor(near_field_evolution((n, n), PSO_DX, PSO_DZ, lam), device=dev)[None]
    probe = torch.as_tensor(pso_probe(), device=dev)
    psi = fourier_shift(probe, 0.3 * torch.randn((b, 2), generator=gen, device=dev))
    obja = 1.0 + 0.05 * torch.randn((b, 1, PSO_NZ, n, n), generator=gen, device=dev)
    objp = 0.1 * torch.randn((b, 1, PSO_NZ, n, n), generator=gen, device=dev)
    nz_main = 2 * PSO_SG
    a_main, p_main = obja[:, 0, :nz_main], objp[:, 0, :nz_main]
    a_tail, p_tail = obja[:, 0, nz_main:], objp[:, 0, nz_main:]
    g = torch.complex(torch.randn(psi.shape, generator=gen, device=dev),
                      torch.randn(psi.shape, generator=gen, device=dev)) * float(psi.abs().max())

    def plain_vjp(fn, inputs):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        grads = torch.autograd.grad(out, leaves, grad_outputs=g, retain_graph=True)
        return out, leaves, grads

    def errs(actual, ref):
        # 1e-4 of the largest entry of each output or cotangent, as for B3
        e = [float((x - y).abs().max()) for x, y in zip(actual, ref)]
        t = [1e-4 * float(y.abs().max()) for y in ref]
        return e, t

    rows = []
    field = 8 * psi.numel()
    h_bytes = 8 * h.numel()

    def slice_bytes(k):
        return 2 * 4 * b * k * n * n  # a and phi

    # B6 over the uniform segments
    stack_fn = lambda x, y, z: C.chain_stack_plain(x, y, z, h, PSO_SG, False)  # noqa: E731
    out_k, stack = C.stack_fwd_cuda(psi, a_main, p_main, h, PSO_SG, False)
    out_p, leaves, g_plain = plain_vjp(stack_fn, (psi, a_main, p_main))
    (e_f,), (t_f,) = errs([out_k], [out_p.detach()])
    g_kern = C.stack_bwd_cuda(g, stack, a_main, p_main, h, PSO_SG, False)[:3]
    e_b, t_b = errs(g_kern, g_plain)
    emit({"phase": "kernel_check", "name": "B6 chain_stack", "S": 2, "sg": PSO_SG,
          "last_mega": False, "fwd_max_abs_err": e_f, "fwd_tolerance": t_f,
          "bwd_max_abs_err": e_b, "bwd_tolerance": t_b,
          "bwd_names": ["d psi0", "d a", "d phi"]})
    require(e_f <= t_f, f"B6a differs from its plain version: {e_f} > {t_f}")
    for name, e, t in zip(("psi0", "a", "phi"), e_b, t_b):
        require(e <= t, f"B6b d {name} differs from its plain version: {e} > {t}")
    b6a_bytes = field + slice_bytes(nz_main) + h_bytes + field + 2 * field
    b6b_bytes = field + 2 * field + slice_bytes(nz_main) + h_bytes + field + slice_bytes(nz_main)
    n_wave = b * pm
    rows.append({
        "name": "B6a chain_stack_fwd", "route": "cuda", "source": "ptyrad_tpu_torch/csrc/chain.cu",
        "replaces": "ptyrad_tpu/ops/pallas_chain.py:466", "max_abs_err": e_f,
        "ms": time_ms(lambda: C.stack_fwd_cuda(psi, a_main, p_main, h, PSO_SG, False)),
        "plain_ms": time_ms(lambda: stack_fn(psi, a_main, p_main)),
        "library_ms": None,
        **dict(zip(("bound_ms", "bound_by"),
                   bound(b6a_bytes, _chain_ops(n, n_wave, nz_main, nz_main)))),
    })
    rows.append({
        "name": "B6b chain_stack_bwd", "route": "cuda", "source": "ptyrad_tpu_torch/csrc/chain.cu",
        "replaces": "ptyrad_tpu/ops/pallas_chain.py:529", "max_abs_err": max(e_b),
        "ms": time_ms(lambda: C.stack_bwd_cuda(g, stack, a_main, p_main, h, PSO_SG, False)),
        "plain_ms": time_ms(lambda: torch.autograd.grad(out_p, leaves, grad_outputs=g,
                                                        retain_graph=True)),
        "library_ms": None,
        # rebuild: S (sg - 1) propagations; walk: nz_main adjoint slices and
        # nz_main adjoint propagations (the last one undoes the exit's)
        **dict(zip(("bound_ms", "bound_by"),
                   bound(b6b_bytes, _chain_ops(n, n_wave, 2 * (PSO_SG - 1) + nz_main,
                                               2 * (PSO_SG - 1), nz_main)))),
    })
    del out_p, leaves, g_plain, stack

    # B5 over the ragged tail
    sg = PSO_NZ - nz_main
    for last in (False, True):
        seg_fn = lambda x, y, z, last=last: C.chain_segment_plain(x, y, z, h, last)  # noqa: E731
        out_k = C.segment_fwd_cuda(psi, a_tail, p_tail, h, last)
        out_p, leaves, g_plain = plain_vjp(seg_fn, (psi, a_tail, p_tail))
        (e_f,), (t_f,) = errs([out_k], [out_p.detach()])
        g_kern = C.segment_bwd_cuda(g, psi, a_tail, p_tail, h, last)[:3]
        e_b, t_b = errs(g_kern, g_plain)
        emit({"phase": "kernel_check", "name": "B5 chain_segment", "sg": sg, "last": last,
              "fwd_max_abs_err": e_f, "fwd_tolerance": t_f, "bwd_max_abs_err": e_b,
              "bwd_tolerance": t_b, "bwd_names": ["d psi", "d a", "d phi"]})
        require(e_f <= t_f, f"B5a (last={last}) differs from its plain version: {e_f} > {t_f}")
        for name, e, t in zip(("psi", "a", "phi"), e_b, t_b):
            require(e <= t, f"B5b d {name} (last={last}) differs: {e} > {t}")
    # times at the main path's case: the chain's tail, last = True
    n_prop = sg - 1
    b5a_bytes = field + slice_bytes(sg) + h_bytes + field
    b5b_bytes = 2 * field + slice_bytes(sg) + h_bytes + field + slice_bytes(sg)
    rows.append({
        "name": "B5a chain_segment_fwd", "route": "cuda",
        "source": "ptyrad_tpu_torch/csrc/chain.cu",
        "replaces": "ptyrad_tpu/ops/pallas_chain.py:238", "max_abs_err": e_f,
        "ms": time_ms(lambda: C.segment_fwd_cuda(psi, a_tail, p_tail, h, True)),
        "plain_ms": time_ms(lambda: seg_fn(psi, a_tail, p_tail)),
        "library_ms": None,
        **dict(zip(("bound_ms", "bound_by"), bound(b5a_bytes, _chain_ops(n, n_wave, n_prop, sg)))),
    })
    rows.append({
        "name": "B5b chain_segment_bwd", "route": "cuda",
        "source": "ptyrad_tpu_torch/csrc/chain.cu",
        "replaces": "ptyrad_tpu/ops/pallas_chain.py:279", "max_abs_err": max(e_b),
        "ms": time_ms(lambda: C.segment_bwd_cuda(g, psi, a_tail, p_tail, h, True)),
        "plain_ms": time_ms(lambda: torch.autograd.grad(out_p, leaves, grad_outputs=g,
                                                        retain_graph=True)),
        "library_ms": None,
        # rebuild sg - 1 propagations; walk sg adjoint slices, sg - 1 propagations
        **dict(zip(("bound_ms", "bound_by"),
                   bound(b5b_bytes, _chain_ops(n, n_wave, 2 * n_prop, n_prop, sg)))),
    })
    for k in rows:
        emit({"phase": "kernel", **k, "note": "PSO shapes; library_ms null: no single PyTorch "
              "call computes a segment, and the plain version is the cuFFT chain"})
    return rows


def propagation_yardstick(dev, gen) -> dict:
    """One propagation ifft2(H fft2(psi)) of the PSO batch (32 x 4 fields of
    256^2): the kernels' share of it, one row pass plus one column pass
    (their mean device times over one B6a call, torch.profiler; the row
    pass also applies T), against one PyTorch call each of torch.fft.fft2,
    the H product and torch.fft.ifft2 (cuFFT) on the same field. The bound
    is that of the function the passes compute, T product included: psi
    read and written once, a, phi and H read once."""
    from torch.profiler import ProfilerActivity, profile

    from ptyrad_tpu_torch.ops import chain as C
    from ptyrad_tpu_torch.physics import electron_wavelength, near_field_evolution

    n, b = PSO_NPIX, BATCH
    lam = electron_wavelength(PSO_KV)
    h = torch.as_tensor(near_field_evolution((n, n), PSO_DX, PSO_DZ, lam), device=dev)[None]
    psi = torch.complex(torch.randn((b, PSO_PMODE, n, n), generator=gen, device=dev),
                        torch.randn((b, PSO_PMODE, n, n), generator=gen, device=dev))
    a = 1.0 + 0.05 * torch.randn((b, 2 * PSO_SG, n, n), generator=gen, device=dev)
    p = 0.1 * torch.randn((b, 2 * PSO_SG, n, n), generator=gen, device=dev)
    C.stack_fwd_cuda(psi, a, p, h, PSO_SG, False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        C.stack_fwd_cuda(psi, a, p, h, PSO_SG, False)
        torch.cuda.synchronize()
    us = {}
    for e in prof.key_averages():
        for kind in ("row_fwd_kernel", "col_kernel"):
            if kind in e.key and e.self_device_time_total > 0:
                us[kind] = e.self_device_time_total / e.count
    require(set(us) == {"row_fwd_kernel", "col_kernel"}, f"the profiler saw {sorted(us)}")
    field = 8 * psi.numel()
    nn = n * n
    # the function: psi read and written once, one slice of a and phi, H
    fn_bytes = 2 * field + 2 * 4 * b * nn + 8 * h.numel()
    out = {
        "phase": "propagation_yardstick", "shape": list(psi.shape),
        "row_pass_ms": us["row_fwd_kernel"] / 1e3, "column_pass_ms": us["col_kernel"] / 1e3,
        "ms": (us["row_fwd_kernel"] + us["col_kernel"]) / 1e3,
        "library_ms": time_ms(lambda: torch.fft.ifft2(h * torch.fft.fft2(psi))),
        "note": "ms: one row pass (with the T product) plus one column pass of B6a; "
                "library_ms: torch.fft.fft2, the H product, torch.fft.ifft2; "
                "design_traffic_ms: the two passes' own bytes (the field in and out of "
                "each) at the card's memory rate, not a bound of the function",
        **dict(zip(("bound_ms", "bound_by"),
                   bound(fn_bytes, b * PSO_PMODE * (20 * nn * np.log2(n) + 12 * nn)))),
        "design_traffic_ms": (fn_bytes + 2 * field) / PEAK_BYTES_PER_S * 1e3,
    }
    emit(out)
    return out


def tilted_h(h: torch.Tensor, tilts: torch.Tensor, dx: float, dz: float) -> torch.Tensor:
    """Per-position propagators (B, N, N): the shared h times the port's
    tilt_ramp (models/forward.py), tilts (B, 2) in mrad."""
    from ptyrad_tpu_torch.models import tilt_ramp
    from ptyrad_tpu_torch.physics import propagator_kgrid

    ky, kx = (torch.as_tensor(k, dtype=torch.float32, device=h.device)
              for k in propagator_kgrid(tuple(h.shape[-2:]), dx))
    return (h * tilt_ramp(ky, kx, tilts, dz)).contiguous()


def _grad_errs(kern, plain) -> tuple[list, list]:
    """Max abs error of each cotangent and its tolerance, 1e-4 of the plain
    cotangent's largest entry (float32 chains by two FFT algorithms; the
    kernels' sums over modes and samples run in another fixed order)."""
    return ([float((a - b).abs().max()) for a, b in zip(kern, plain)],
            [1e-4 * float(b.abs().max()) for b in plain])


def check_fused_dh(dev, gen) -> list:
    """B3 and B4 with a per-position H (B3a, B4a) and with dH (B3b, B4b) at
    tBL shapes and per-position probe spectra, for a per-position H (tilts
    within 1 mrad; the tilt path's case, which is timed) and a shared one:
    values and every cotangent, dH included, against the plain versions."""
    from ptyrad_tpu_torch.ops import fused_multislice as M
    from ptyrad_tpu_torch.ops.shift import fourier_shift_kspace
    from ptyrad_tpu_torch.physics import electron_wavelength, near_field_evolution

    n, dz = NPIX, 2.0
    lam = electron_wavelength(80.0)
    probe = torch.as_tensor(tbl_probe(), device=dev)
    h1 = torch.as_tensor(near_field_evolution((n, n), 0.1494, dz, lam), device=dev)[None]
    tilts = 2.0 * torch.rand((BATCH, 2), generator=gen, device=dev) - 1.0
    h_each = tilted_h(h1, tilts, 0.1494, dz)
    obja = 1.0 + 0.05 * torch.randn((BATCH, 1, NZ, n, n), generator=gen, device=dev)
    objp = 0.1 * torch.randn((BATCH, 1, NZ, n, n), generator=gen, device=dev)
    pr = fourier_shift_kspace(probe, 0.3 * torch.randn((BATCH, 2), generator=gen, device=dev))
    meas = torch.rand((BATCH, n, n), generator=gen, device=dev) * 2e-4
    mask = torch.ones(BATCH, device=dev)
    mask[BATCH - 1] = 0.0
    g = torch.randn((BATCH, n, n), generator=gen, device=dev)
    p, eps, cvec = 0.5, 1e-10, torch.tensor(0.7, device=dev)
    names = ["d obja", "d objp", "d probe", "d h"]
    timed = {}
    for layout, h in (("each", h_each), ("shared", h1)):
        leaves = [t.clone().requires_grad_(True) for t in (obja, objp, pr, h)]
        # B3: the loss-folded pair
        s1k, s2k, dp = M.loss_sums_fwd_cuda(obja, objp, pr, h, meas, mask, p, eps, True)
        s1p, s2p = M.loss_sums_plain(*leaves, meas, mask, p, eps, True)
        e3f = max(abs(float(s1k - s1p.detach())), abs(float(s2k - s2p)))
        t3f = 1e-4 * max(abs(float(s1p.detach())), abs(float(s2p)))
        g3p = torch.autograd.grad(s1p, leaves, grad_outputs=cvec, retain_graph=True)
        g3k = M.loss_sums_bwd_cuda(obja, objp, pr, h, meas, mask, dp, cvec, p, eps, True,
                                   need_dh=True)
        e3b, t3b = _grad_errs(g3k, g3p)
        # B4: the plain pair
        dp_k = M.dp_fwd_cuda(obja, objp, pr, h, True)
        dp_p = M.multislice_dp_plain(*leaves, True)
        e4f = float((dp_k - dp_p.detach()).abs().max())
        t4f = 1e-4 * float(dp_p.detach().abs().max())
        g4p = torch.autograd.grad(dp_p, leaves, grad_outputs=g, retain_graph=True)
        g4k = M.dp_bwd_cuda(obja, objp, pr, h, g, True, need_dh=True)
        e4b, t4b = _grad_errs(g4k, g4p)
        for name, ef, tf, eb, tb in (("B3", e3f, t3f, e3b, t3b), ("B4", e4f, t4f, e4b, t4b)):
            emit({"phase": "kernel_check", "name": f"{name} with dH", "h": layout,
                  "fwd_max_abs_err": ef, "fwd_tolerance": tf, "bwd_max_abs_err": eb,
                  "bwd_tolerance": tb, "bwd_names": names})
            require(ef <= tf, f"{name}a ({layout} H) differs: {ef} > {tf}")
            for nm, e, t in zip(names, eb, tb):
                require(e <= t, f"{name}b {nm} ({layout} H) differs: {e} > {t}")
        timed[layout] = (leaves, s1p, dp, dp_p, e3f, max(e3b), e4f, max(e4b))

    leaves, s1p, dp, dp_p, e3f, e3b, e4f, e4b = timed["each"]
    h = h_each
    n_wave = BATCH * PMODE
    obj_bytes = 4 * (obja.numel() + objp.numel())
    in_bytes = obj_bytes + 8 * (pr.numel() + h.numel())
    loss_in = 4 * (meas.numel() + mask.numel())
    # the K scratch, written by the recompute and read by the walk: the
    # design's own traffic, reported apart; the bound counts only what the
    # function must move (the JAX kernel recomputes K instead)
    k_bytes = 2 * 8 * n_wave * (NZ - 1) * n * n
    # dH: U conj(K) and its sum, 8 operations per element and propagation
    dh_ops = n_wave * (NZ - 1) * 8 * n * n
    fwd_ops = n_wave * _chain_flops(n, 2 * NZ, NZ)
    bwd_out = obj_bytes + 8 * (pr.numel() + h.numel())
    note = ("tBL shapes, per-position probe spectra and H (tilts within 1 mrad); "
            "scratch_bytes: the K scratch written and read back, not in the bound")
    rows = [
        {"name": "B3a loss_sums_fwd (per-position H)", "route": "cuda",
         "source": "ptyrad_tpu_torch/csrc/multislice.cu",
         "replaces": "ptyrad_tpu/ops/pallas_multislice.py:548", "max_abs_err": e3f,
         "ms": time_ms(lambda: M.loss_sums_fwd_cuda(obja, objp, pr, h, meas, mask, p, eps, True)),
         "plain_ms": time_ms(lambda: M.loss_sums_plain(obja, objp, pr, h, meas, mask, p, eps,
                                                       True)),
         "library_ms": None,
         **dict(zip(("bound_ms", "bound_by"), bound(in_bytes + loss_in + 8, fwd_ops)))},
        {"name": "B3b loss_sums_bwd (dH)", "route": "cuda",
         "source": "ptyrad_tpu_torch/csrc/multislice.cu",
         "replaces": "ptyrad_tpu/ops/pallas_multislice.py:588", "max_abs_err": e3b,
         "ms": time_ms(lambda: M.loss_sums_bwd_cuda(obja, objp, pr, h, meas, mask, dp, cvec, p,
                                                    eps, True, need_dh=True)),
         "plain_ms": time_ms(lambda: torch.autograd.grad(s1p, leaves, grad_outputs=cvec,
                                                         retain_graph=True)),
         "library_ms": None, "scratch_bytes": k_bytes,
         **dict(zip(("bound_ms", "bound_by"),
                    bound(in_bytes + loss_in + 4 * dp.numel() + bwd_out, 2 * fwd_ops + dh_ops)))},
        {"name": "B4a dp_fwd (per-position H)", "route": "cuda",
         "source": "ptyrad_tpu_torch/csrc/multislice.cu",
         "replaces": "ptyrad_tpu/ops/pallas_multislice.py:128", "max_abs_err": e4f,
         "ms": time_ms(lambda: M.dp_fwd_cuda(obja, objp, pr, h, True)),
         "plain_ms": time_ms(lambda: M.multislice_dp_plain(obja, objp, pr, h, True)),
         "library_ms": None,
         **dict(zip(("bound_ms", "bound_by"), bound(in_bytes + 4 * g.numel(), fwd_ops)))},
        {"name": "B4b dp_bwd (dH)", "route": "cuda",
         "source": "ptyrad_tpu_torch/csrc/multislice.cu",
         "replaces": "ptyrad_tpu/ops/pallas_multislice.py:145", "max_abs_err": e4b,
         "ms": time_ms(lambda: M.dp_bwd_cuda(obja, objp, pr, h, g, True, need_dh=True)),
         "plain_ms": time_ms(lambda: torch.autograd.grad(dp_p, leaves, grad_outputs=g,
                                                         retain_graph=True)),
         "library_ms": None, "scratch_bytes": k_bytes,
         **dict(zip(("bound_ms", "bound_by"),
                    bound(in_bytes + 4 * g.numel() + bwd_out, 2 * fwd_ops + dh_ops)))},
    ]
    for k in rows:
        emit({"phase": "kernel", **k, "note": note})
    return rows


# check_fused_npo2's row sets: (N, widths, the rows' tag) and the N whose
# _bf16 rows it adds (npo2_bf16_rows)
FUSED_ROWS = ((PSO_N120, "PSO", f"N={PSO_N120}"), (96, "tBL", "N=96"),
              (PRIME_N, "small", f"N={PRIME_N}"), (PRIME_N, "PSO", f"N={PRIME_N}, PSO widths"),
              (SMALL_PRIME_N, "PSO", f"N={SMALL_PRIME_N}"))
FUSED_BF16_ROWS = (f"N={PSO_N120}", f"N={PRIME_N}, PSO widths")


def npo2_widths(n: int, widths: str) -> dict:
    """The widths of the fused rows at N that is not a power of two: PSO's
    (300 kV, 21 slices of 10 Ang, 4 modes, the pixel 0.15 x 256 / N Ang: at
    120 its crop's), tBL's (80 kV, 6 slices of 2 Ang, 6 modes) or a small
    batch (4 samples, 2 modes, 3 slices)."""
    if widths == "PSO":
        return {"batch": BATCH, "pmode": PSO_PMODE, "nz": PSO_NZ, "kv": PSO_KV, "conv": 21.4,
                "dx": PSO_DX * PSO_NPIX / n, "dz": PSO_DZ, "df": -200.0,
                "note": f"PSO widths at {n}^2, per-position probe spectra"}
    small = widths == "small"
    return {"batch": 4 if small else BATCH, "pmode": 2 if small else PMODE,
            "nz": 3 if small else NZ, "kv": 80.0, "conv": 24.9, "dx": 0.1494, "dz": 2.0, "df": 0.0,
            "note": ("a small batch" if small else "tBL widths") + ", per-position probe spectra"}


def check_fused_npo2(dev, gen) -> list:
    """B3a, B3b, B3b with dH, B4a and B4b at N that is not a power of two
    (FUSED_ROWS): the mixed-radix pair at N = 120 (PSO's widths) and 96
    (tBL's), the Bluestein line at the prime N (a small batch, and PSO's
    widths) and at 29 (PSO's widths), each against its plain version on the
    same CUDA tensors at the tolerance of its power-of-two twin
    (check_loss_chain, check_dp_chain, check_fused_dh: s1/s2 at rtol 1e-4,
    dp and every cotangent at 1e-4 of its largest entry); B3b and B4b run
    twice bit for bit. Then for FUSED_BF16_ROWS the _bf16 rows, each
    against its plain twin with bf16_operands by the bf16 rows' error-ratio
    gates (check_bf16_kernels). Per-position probe spectra; dH on a
    per-position H (tilts within 1 mrad). Bounds from each N's own
    operations (_chain_flops at log2 N) and bytes."""
    from ptyrad_tpu_torch.ops import fused_multislice as M
    from ptyrad_tpu_torch.ops.shift import fourier_shift_kspace
    from ptyrad_tpu_torch.physics import (electron_wavelength, make_mixed_probe,
                                          make_stem_probe, near_field_evolution)

    rows, failures = [], []
    src = "ptyrad_tpu_torch/csrc/multislice.cu"
    for n, widths, tag in FUSED_ROWS:
        w = npo2_widths(n, widths)
        b, pmode, nz = w["batch"], w["pmode"], w["nz"]
        lam = electron_wavelength(w["kv"])
        probe = make_mixed_probe(make_stem_probe({"kv": w["kv"], "conv_angle": w["conv"],
                                                  "Npix": n, "dx": w["dx"], "df": w["df"]}),
                                 pmode, [0.02])
        probe = torch.as_tensor(probe, device=dev)
        h = torch.as_tensor(near_field_evolution((n, n), w["dx"], w["dz"], lam), device=dev)[None]
        h_each = tilted_h(h, 2.0 * torch.rand((b, 2), generator=gen, device=dev) - 1.0,
                          w["dx"], w["dz"])
        obja = 1.0 + 0.05 * torch.randn((b, 1, nz, n, n), generator=gen, device=dev)
        objp = 0.1 * torch.randn((b, 1, nz, n, n), generator=gen, device=dev)
        pr = fourier_shift_kspace(probe, 0.3 * torch.randn((b, 2), generator=gen, device=dev))
        meas = torch.rand((b, n, n), generator=gen, device=dev) * 2.0 / (n * n)
        mask = torch.ones(b, device=dev)
        mask[b - 1] = 0.0
        g = torch.randn((b, n, n), generator=gen, device=dev)
        p, eps, cvec = 0.5, 1e-10, torch.tensor(0.7, device=dev)
        largs = (meas, mask, p, eps)
        n_wave = b * pmode
        obj_bytes = 4 * (obja.numel() + objp.numel())
        in_bytes = obj_bytes + 8 * (pr.numel() + h.numel())
        fwd_ops = n_wave * _chain_flops(n, 2 * nz, nz)
        dh_ops = n_wave * (nz - 1) * 8 * n * n
        loss_in = 4 * (meas.numel() + mask.numel())
        bwd_out = obj_bytes + 8 * pr.numel()

        def add(name, replaces, errs, tols, kern, plain, nbytes, ops, repeat=None):
            row = {"name": f"{name} ({tag})" if "(" not in name else f"{name[:-1]}, {tag})",
                   "route": "cuda", "source": src, "replaces": replaces,
                   "max_abs_err": max(errs), "ms": time_ms(kern), "plain_ms": time_ms(plain),
                   "library_ms": None, **dict(zip(("bound_ms", "bound_by"), bound(nbytes, ops)))}
            emit({"phase": "kernel", **row, "errors": errs, "tolerances": tols,
                  "repeats_bitwise": repeat, "note": w["note"],
                  "shape": {"N": n, "batch": b, "pmode": pmode, "nz": nz}})
            failures.extend(f"{row['name']} differs from its plain version: {e} > {t}"
                            for e, t in zip(errs, tols) if not e <= t)
            if repeat is False:
                failures.append(f"{row['name']} run twice differs")
            rows.append(row)

        # B3: the loss-folded pair
        s1k, s2k, dp = M.loss_sums_fwd_cuda(obja, objp, pr, h, *largs, True)
        leaves = [t.clone().requires_grad_(True) for t in (obja, objp, pr)]
        s1p, s2p = M.loss_sums_plain(*leaves, h, *largs, True)
        add("B3a loss_sums_fwd", "ptyrad_tpu/ops/pallas_multislice.py:548",
            [max(abs(float(s1k - s1p.detach())), abs(float(s2k - s2p)))],
            [1e-4 * max(abs(float(s1p.detach())), abs(float(s2p)))],
            lambda: M.loss_sums_fwd_cuda(obja, objp, pr, h, *largs, True),
            lambda: M.loss_sums_plain(obja, objp, pr, h, *largs, True),
            in_bytes + loss_in + 8, fwd_ops)
        g_plain = torch.autograd.grad(s1p, leaves, grad_outputs=cvec, retain_graph=True)

        def b3b():
            return M.loss_sums_bwd_cuda(obja, objp, pr, h, meas, mask, dp, cvec, p, eps,
                                        True)[:3]

        add("B3b loss_sums_bwd", "ptyrad_tpu/ops/pallas_multislice.py:588",
            *_grad_errs(b3b(), g_plain), b3b,
            lambda: torch.autograd.grad(s1p, leaves, grad_outputs=cvec, retain_graph=True),
            in_bytes + loss_in + 4 * dp.numel() + bwd_out, 2 * fwd_ops,
            repeat=repeats_bitwise(b3b, b3b()))
        # B3b with dH on a per-position H
        dpe = M.loss_sums_fwd_cuda(obja, objp, pr, h_each, *largs, True)[2]
        leaves_e = [t.clone().requires_grad_(True) for t in (obja, objp, pr, h_each)]
        s1pe = M.loss_sums_plain(*leaves_e, *largs, True)[0]
        g_plain_e = torch.autograd.grad(s1pe, leaves_e, grad_outputs=cvec, retain_graph=True)

        def b3b_dh():
            return M.loss_sums_bwd_cuda(obja, objp, pr, h_each, meas, mask, dpe, cvec, p, eps,
                                        True, need_dh=True)

        in_each = obj_bytes + 8 * (pr.numel() + h_each.numel())
        add("B3b loss_sums_bwd (dH)", "ptyrad_tpu/ops/pallas_multislice.py:588",
            *_grad_errs(b3b_dh(), g_plain_e), b3b_dh,
            lambda: torch.autograd.grad(s1pe, leaves_e, grad_outputs=cvec, retain_graph=True),
            in_each + loss_in + 4 * dpe.numel() + bwd_out + 8 * h_each.numel(),
            2 * fwd_ops + dh_ops, repeat=repeats_bitwise(b3b_dh, b3b_dh()))
        # B4: the plain pair
        dp_k = M.dp_fwd_cuda(obja, objp, pr, h, True)
        leaves = [t.clone().requires_grad_(True) for t in (obja, objp, pr)]
        dp_p = M.multislice_dp_plain(*leaves, h, True)
        add("B4a dp_fwd", "ptyrad_tpu/ops/pallas_multislice.py:128",
            [float((dp_k - dp_p.detach()).abs().max())],
            [1e-4 * float(dp_p.detach().abs().max())],
            lambda: M.dp_fwd_cuda(obja, objp, pr, h, True),
            lambda: M.multislice_dp_plain(obja, objp, pr, h, True),
            in_bytes + 4 * g.numel(), fwd_ops)
        g4 = torch.autograd.grad(dp_p, leaves, grad_outputs=g, retain_graph=True)

        def b4b():
            return M.dp_bwd_cuda(obja, objp, pr, h, g, True)[:3]

        add("B4b dp_bwd", "ptyrad_tpu/ops/pallas_multislice.py:145", *_grad_errs(b4b(), g4), b4b,
            lambda: torch.autograd.grad(dp_p, leaves, grad_outputs=g, retain_graph=True),
            in_bytes + 4 * g.numel() + bwd_out, 2 * fwd_ops, repeat=repeats_bitwise(b4b, b4b()))
        if tag in FUSED_BF16_ROWS:
            rows += npo2_bf16_rows(rows, failures, obja, objp, pr, h, g, largs, cvec, tag)
        torch.cuda.empty_cache()
    require(not failures, "; ".join(failures))
    return rows


def npo2_bf16_rows(f32_rows, failures, obja, objp, pr, h, g, largs, cvec, tag) -> list:
    """The _bf16 rows of B3a, B3b, B4a and B4b at one N, each against its
    plain twin with bf16_operands (bf16_errors, bf16_failures: the kernel's
    bfloat16 error against its twin's within BF16_RATIO_TOL), B3b and B4b
    run twice bit for bit, with their float32 rows' bounds."""
    from ptyrad_tpu_torch.ops import fused_multislice as M

    f32 = {r["name"]: r for r in f32_rows}
    meas, mask, p, eps = largs
    out = []

    def row(name, names, kern, twin, repeat=False):
        k16, time_k16 = kern(True)
        k32 = kern(False)[0]
        t16, time_t16 = twin(True)
        t32 = twin(False)[0]
        errs = bf16_errors(k16, k32, t16, t32)
        bad = bf16_failures(name, names, errs)
        rep = repeats_bitwise(lambda: kern(True)[0], k16) if repeat else None
        if rep is False:
            bad.append(f"{name}: run twice differs")
        ref = f32[f"{name.replace(' (bf16)', '')} ({tag})"]
        r = {"name": f"{name[:-1]}, {tag})" if "(" in name else name, "route": "cuda",
             "source": "ptyrad_tpu_torch/csrc/multislice_bf16.cu", "replaces": ref["replaces"],
             "max_abs_err": max(e["max_abs"] for e in errs), "ms": time_ms(time_k16),
             "plain_ms": time_ms(time_t16), "bound_ms": ref["bound_ms"],
             "bound_by": ref["bound_by"], "library_ms": None}
        emit({"phase": "kernel", **r, "f32_row": ref["name"], "outputs": names, "errors": errs,
              "tolerance": BF16_TOLERANCE, "repeats_bitwise": rep})
        out.append(r)
        failures.extend(bad)

    def b3a(bf16):
        def call():
            return M.loss_sums_fwd_cuda(obja, objp, pr, h, *largs, True, bf16_operands=bf16)
        return (call()[2],), call

    def b3a_twin(bf16):
        with torch.no_grad():
            dp = M.multislice_dp_plain(obja, objp, pr, h, True, bf16)
        return (dp,), lambda: M.loss_sums_plain(obja, objp, pr, h, *largs, True, bf16)

    def b3b(bf16):
        dp = M.loss_sums_fwd_cuda(obja, objp, pr, h, *largs, True, bf16_operands=bf16)[2]

        def call():
            return M.loss_sums_bwd_cuda(obja, objp, pr, h, meas, mask, dp, cvec, p, eps, True,
                                        bf16_operands=bf16)[:3]
        return call(), call

    def b3b_twin(bf16):
        return _twin_vjp(lambda a, ph, q: M.loss_sums_plain(a, ph, q, h, *largs, True, bf16)[0],
                         (obja, objp, pr), cvec)

    def b4a(bf16):
        def call():
            return M.dp_fwd_cuda(obja, objp, pr, h, True, bf16)
        return (call(),), call

    def b4a_twin(bf16):
        def call():
            return M.multislice_dp_plain(obja, objp, pr, h, True, bf16)
        with torch.no_grad():
            return (call(),), call

    def b4b(bf16):
        def call():
            return M.dp_bwd_cuda(obja, objp, pr, h, g, True, bf16_operands=bf16)[:3]
        return call(), call

    def b4b_twin(bf16):
        return _twin_vjp(lambda a, ph, q: M.multislice_dp_plain(a, ph, q, h, True, bf16),
                         (obja, objp, pr), g)

    grads = ["d obja", "d objp", "d probe"]
    row("B3a loss_sums_fwd (bf16)", ["dp"], b3a, b3a_twin)
    row("B3b loss_sums_bwd (bf16)", grads, b3b, b3b_twin, repeat=True)
    row("B4a dp_fwd (bf16)", ["dp"], b4a, b4a_twin)
    row("B4b dp_bwd (bf16)", grads, b4b, b4b_twin, repeat=True)
    return out


def chain_npo2_case(n: int) -> dict:
    """The widths of the chain rows at N in (128, 512] that is not a power of
    two: PSO's at 192^2 and 254^2 (B 32, 4 modes, 21 slices: B6 over 2 x 8,
    B5 over the 5-slice tail), B = 8 at 384 as the 512^2 far-field rows (B5
    over the tail, with and without the exit), and a small batch at the
    prime 509 (B 2, 2 modes, 3 slices: B5 over them, B6 over 3 segments of
    one). The pixel keeps PSO's reciprocal pixel, 0.15 x 256 / N Ang."""
    tail = PSO_NZ - 2 * PSO_SG
    if n in PSO_PADS:
        return {"batch": BATCH, "pmode": PSO_PMODE, "nz": PSO_NZ, "tail": tail,
                "stack": (2, PSO_SG), "note": f"PSO widths padded to {n}^2"}
    if n == CHAIN_PRIME_N:
        return {"batch": 2, "pmode": 2, "nz": 3, "tail": 3, "stack": (3, 1),
                "note": "a small batch at a prime N (a Bluestein line)"}
    return {"batch": 8, "pmode": PSO_PMODE, "nz": PSO_NZ, "tail": tail, "stack": None,
            "note": "B = 8, as the 512^2 far-field rows"}


def check_chain_npo2(dev, gen) -> list:
    """B5 and B6 of chain.cu's mixed-radix build at N = 192 and 254 (PSO's
    widths; 254 a Bluestein line), 384 and the prime 509 (a Bluestein line;
    chain_npo2_case), each against its plain version
    on the same CUDA tensors at its power-of-two twin's tolerance (1e-4 of
    each output's or cotangent's largest entry; check_chain, check_chain_dh,
    check_chain_ff), the backwards run twice bit for bit. The kernels take H
    gathered with the plan's permutation (ops.chain.kernel_h) and give dH in
    that order, held against the plain dH gathered the same way. B5 over
    the tail with `last` both ways (the row times last), with the far-field
    exit (library_ms: B5 without it plus torch.fft.fft2, or that
    transform's backward before B5b), B5b with dH on a per-position H; B6
    (last_mega False at 192, 254 and 384's, True at 509) and B6b with dH; at
    192 and 254 the _bf16 rows of B5a, B5b, B6a and B6b by the bf16 gates
    (bf16_errors, bf16_failures). Bounds from each N's own operations
    (_chain_ops at log2 N) and bytes."""
    from ptyrad_tpu_torch.ops import chain as C
    from ptyrad_tpu_torch.ops.shift import fourier_shift
    from ptyrad_tpu_torch.physics import (electron_wavelength, make_mixed_probe,
                                          make_stem_probe, near_field_evolution)

    rows, failures = [], []
    src = "ptyrad_tpu_torch/csrc/chain.cu"
    lam = electron_wavelength(PSO_KV)
    for n in CHAIN_NS:
        w = chain_npo2_case(n)
        b, pm, nz, sg = w["batch"], w["pmode"], w["nz"], w["tail"]
        dx = PSO_DX * PSO_NPIX / n
        h = torch.as_tensor(near_field_evolution((n, n), dx, PSO_DZ, lam), device=dev)[None]
        h_each = tilted_h(h, 2.0 * torch.rand((b, 2), generator=gen, device=dev) - 1.0, dx,
                          PSO_DZ)
        probe = make_mixed_probe(make_stem_probe({"kv": PSO_KV, "conv_angle": 21.4, "Npix": n,
                                                  "dx": dx, "df": -200.0}), pm, [0.02])
        psi = fourier_shift(torch.as_tensor(probe, device=dev),
                            0.3 * torch.randn((b, 2), generator=gen, device=dev))
        obja = 1.0 + 0.05 * torch.randn((b, 1, nz, n, n), generator=gen, device=dev)
        objp = 0.1 * torch.randn((b, 1, nz, n, n), generator=gen, device=dev)
        a_t, p_t = obja[:, 0, nz - sg:], objp[:, 0, nz - sg:]
        g = torch.complex(torch.randn(psi.shape, generator=gen, device=dev),
                          torch.randn(psi.shape, generator=gen, device=dev))
        g = g * float(psi.abs().max())
        hk, hk_each = C.kernel_h(h), C.kernel_h(h_each)
        field, nn, n_wave = 8 * psi.numel(), n * n, b * pm
        tag = f"N={n}"

        def slab(k, b=b, nn=nn):
            return 2 * 4 * b * k * nn  # a and phi

        def add(name, replaces, errs, tols, kern, plain, nbytes, ops, repeat=None, library=None,
                n=n, w=w, b=b, pm=pm, nz=nz):
            row = {"name": per_n(name, n), "route": "cuda", "source": src,
                   "replaces": f"ptyrad_tpu/ops/pallas_chain.py:{replaces}",
                   "max_abs_err": max(errs), "ms": time_ms(kern), "plain_ms": time_ms(plain),
                   "library_ms": None if library is None else time_ms(library),
                   **dict(zip(("bound_ms", "bound_by"), bound(nbytes, ops)))}
            emit({"phase": "kernel", **row, "errors": errs, "tolerances": tols,
                  "repeats_bitwise": repeat, "note": w["note"],
                  "shape": {"N": n, "batch": b, "pmode": pm, "slices": nz}})
            failures.extend(f"{row['name']} differs from its plain version: {e} > {t}"
                            for e, t in zip(errs, tols) if not e <= t)
            if repeat is False:
                failures.append(f"{row['name']} run twice differs")
            rows.append(row)

        def vjp_plain(fn, inputs, g=g):
            leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
            out = fn(*leaves)
            return out, leaves, torch.autograd.grad(out, leaves, grad_outputs=g,
                                                    retain_graph=True)

        # B5 over the tail: last False held, last True (the path's case) held and timed
        n_prop = sg - 1
        for last in (False, True):
            out_k = C.segment_fwd_cuda(psi, a_t, p_t, hk, last)
            out_p, leaves, g_p = vjp_plain(
                lambda x, y, z, last=last: C.chain_segment_plain(x, y, z, h, last), (psi, a_t, p_t))
            (e_f,), (t_f,) = _grad_errs([out_k], [out_p.detach()])
            e_b, t_b = _grad_errs(C.segment_bwd_cuda(g, psi, a_t, p_t, hk, last)[:3], g_p)
            if not last:
                emit({"phase": "kernel_check", "name": "B5 chain_segment", "N": n, "last": last,
                      "fwd_max_abs_err": e_f, "fwd_tolerance": t_f, "bwd_max_abs_err": e_b,
                      "bwd_tolerance": t_b})
                failures.extend(f"B5 (last False, {tag}) differs: {e} > {t}"
                                for e, t in zip([e_f] + e_b, [t_f] + t_b) if not e <= t)

        def b5b():
            return C.segment_bwd_cuda(g, psi, a_t, p_t, hk, True)[:3]

        add("B5a chain_segment_fwd", 238, [e_f], [t_f],
            lambda: C.segment_fwd_cuda(psi, a_t, p_t, hk, True),
            lambda: C.chain_segment_plain(psi, a_t, p_t, h, True),
            2 * field + slab(sg) + 8 * h.numel(), _chain_ops(n, n_wave, n_prop, sg))
        add("B5b chain_segment_bwd", 279, e_b, t_b, b5b,
            lambda: torch.autograd.grad(out_p, leaves, grad_outputs=g, retain_graph=True),
            3 * field + 2 * slab(sg) + 8 * h.numel(),
            _chain_ops(n, n_wave, 2 * n_prop, n_prop, sg), repeat=repeats_bitwise(b5b, b5b()))
        del out_p, leaves, g_p

        # B5 with the far-field exit
        fft_ops = n_wave * 10 * nn * np.log2(n)
        ff_p, ff_leaves, ff_g = vjp_plain(
            lambda x, y, z: C.chain_segment_plain(x, y, z, h, True, far_field=True),
            (psi, a_t, p_t))
        (e_f,), (t_f,) = _grad_errs([C.segment_fwd_cuda(psi, a_t, p_t, hk, True, True)],
                                    [ff_p.detach()])

        def b5b_ff():
            return C.segment_bwd_cuda(g, psi, a_t, p_t, hk, True, far_field=True)[:3]

        x = torch.empty_like(psi).requires_grad_(True)
        y = torch.fft.fft2(x, norm="ortho")
        add("B5a chain_segment_fwd (far-field)", 238, [e_f], [t_f],
            lambda: C.segment_fwd_cuda(psi, a_t, p_t, hk, True, True),
            lambda: C.chain_segment_plain(psi, a_t, p_t, h, True, far_field=True),
            2 * field + slab(sg) + 8 * h.numel(), _chain_ops(n, n_wave, n_prop, sg) + fft_ops,
            library=lambda: torch.fft.fft2(C.segment_fwd_cuda(psi, a_t, p_t, hk, True),
                                           norm="ortho"))
        add("B5b chain_segment_bwd (far-field)", 279, *_grad_errs(b5b_ff(), ff_g), b5b_ff,
            lambda: torch.autograd.grad(ff_p, ff_leaves, grad_outputs=g, retain_graph=True),
            3 * field + 2 * slab(sg) + 8 * h.numel(),
            _chain_ops(n, n_wave, 2 * n_prop, n_prop, sg) + fft_ops,
            repeat=repeats_bitwise(b5b_ff, b5b_ff()),
            library=lambda: C.segment_bwd_cuda(
                torch.autograd.grad(y, x, grad_outputs=g, retain_graph=True)[0], psi, a_t, p_t,
                hk, True))
        del ff_p, ff_leaves, ff_g, x, y
        torch.cuda.empty_cache()
        if n == 384:
            continue

        # B5b with dH on a per-position H: dH in the kernels' order against
        # the plain dH gathered the same way
        dh_p, dh_leaves, dh_g = vjp_plain(
            lambda x, y, z, v: C.chain_segment_plain(x, y, z, v, True), (psi, a_t, p_t, h_each))

        def b5b_dh():
            return C.segment_bwd_cuda(g, psi, a_t, p_t, hk_each, True, need_dh=True)

        dh_ops = n_wave * n_prop * 8 * nn
        if n in PSO_PADS:
            add("B5b chain_segment_bwd (dH)", 279,
                *_grad_errs(b5b_dh(), [*dh_g[:3], C.kernel_h(dh_g[3])]), b5b_dh,
                lambda: torch.autograd.grad(dh_p, dh_leaves, grad_outputs=g, retain_graph=True),
                3 * field + 2 * slab(sg) + 16 * h_each.numel(),
                _chain_ops(n, n_wave, 2 * n_prop, n_prop, sg) + dh_ops,
                repeat=repeats_bitwise(b5b_dh, b5b_dh()))
        else:
            e, t = _grad_errs(b5b_dh(), [*dh_g[:3], C.kernel_h(dh_g[3])])
            emit({"phase": "kernel_check", "name": "B5b with dH", "N": n, "h": "each",
                  "bwd_max_abs_err": e, "bwd_tolerance": t})
            failures.extend(f"B5b with dH ({tag}) differs: {ei} > {ti}"
                            for ei, ti in zip(e, t) if not ei <= ti)
        del dh_p, dh_leaves, dh_g

        # B6 over the uniform segments
        n_seg, ssg = w["stack"]
        nz_main = n_seg * ssg
        last_mega = nz_main == nz
        a_m, p_m = obja[:, 0, :nz_main], objp[:, 0, :nz_main]
        out_k, stack = C.stack_fwd_cuda(psi, a_m, p_m, hk, ssg, last_mega)
        st_p, st_leaves, st_g = vjp_plain(
            lambda x, y, z, v: C.chain_stack_plain(x, y, z, v, ssg, last_mega),
            (psi, a_m, p_m, h_each))
        st_out = C.chain_stack_plain(psi, a_m, p_m, h, ssg, last_mega)
        (e_f,), (t_f,) = _grad_errs([out_k], [st_out])

        def b6b(dh=False):
            out = C.stack_bwd_cuda(g, stack, a_m, p_m, hk_each if dh else hk, ssg, last_mega,
                                   need_dh=dh)
            return out if dh else out[:3]

        st_plain, st_pl_leaves, st_pl_g = vjp_plain(
            lambda x, y, z: C.chain_stack_plain(x, y, z, h, ssg, last_mega), (psi, a_m, p_m))
        # rebuild: S (sg - 1) propagations; walk: nz_main adjoint slices and
        # nz_main - last_mega adjoint propagations
        n_main_prop = nz_main - last_mega
        b6a_ops = _chain_ops(n, n_wave, n_main_prop, nz_main)
        b6b_ops = _chain_ops(n, n_wave, n_seg * (ssg - 1) + n_main_prop, n_seg * (ssg - 1),
                             nz_main)
        add("B6a chain_stack_fwd", 466, [e_f], [t_f],
            lambda: C.stack_fwd_cuda(psi, a_m, p_m, hk, ssg, last_mega),
            lambda: C.chain_stack_plain(psi, a_m, p_m, h, ssg, last_mega),
            2 * field + slab(nz_main) + 8 * h.numel() + n_seg * field, b6a_ops)
        add("B6b chain_stack_bwd", 529, *_grad_errs(b6b(), st_pl_g), b6b,
            lambda: torch.autograd.grad(st_plain, st_pl_leaves, grad_outputs=g,
                                        retain_graph=True),
            2 * field + n_seg * field + 2 * slab(nz_main) + 8 * h.numel(), b6b_ops,
            repeat=repeats_bitwise(b6b, b6b()))
        out_k, stack = C.stack_fwd_cuda(psi, a_m, p_m, hk_each, ssg, last_mega)

        def b6b_dh():
            return b6b(True)

        if n in PSO_PADS:
            add("B6b chain_stack_bwd (dH)", 529,
                *_grad_errs(b6b_dh(), [*st_g[:3], C.kernel_h(st_g[3])]), b6b_dh,
                lambda: torch.autograd.grad(st_p, st_leaves, grad_outputs=g, retain_graph=True),
                2 * field + n_seg * field + 2 * slab(nz_main) + 16 * h_each.numel(),
                b6b_ops + n_wave * n_main_prop * 8 * nn, repeat=repeats_bitwise(b6b_dh, b6b_dh()))
        else:
            e, t = _grad_errs(b6b_dh(), [*st_g[:3], C.kernel_h(st_g[3])])
            emit({"phase": "kernel_check", "name": "B6b with dH", "N": n, "h": "each",
                  "bwd_max_abs_err": e, "bwd_tolerance": t})
            failures.extend(f"B6b with dH ({tag}) differs: {ei} > {ti}"
                            for ei, ti in zip(e, t) if not ei <= ti)
        if n in PSO_PADS:
            rows += chain_npo2_bf16_rows(rows, failures, psi, a_t, p_t, a_m, p_m, h, hk, g, ssg,
                                         n)
        del st_p, st_leaves, st_g, st_plain, st_pl_leaves, st_pl_g, stack
        torch.cuda.empty_cache()
    require(not failures, "; ".join(failures))
    return rows


def chain_npo2_bf16_rows(f32_rows, failures, psi, a_t, p_t, a_m, p_m, h, hk, g, sg,
                         n) -> list:
    """The _bf16 rows of B5a, B5b, B6a and B6b at N (192, 254), each against its
    plain twin with bf16_operands by the bf16 gates (bf16_errors,
    bf16_failures), B5b and B6b run twice bit for bit, with their float32
    rows' bounds."""
    from ptyrad_tpu_torch.ops import chain as C

    f32 = {r["name"]: r for r in f32_rows}
    out = []
    names = ["d psi", "d a", "d phi"]

    def row(name, outputs, kern, twin, repeat=False):
        k16, time_k16 = kern(True)
        k32 = kern(False)[0]
        t16, time_t16 = twin(True)
        t32 = twin(False)[0]
        errs = bf16_errors(k16, k32, t16, t32)
        bad = bf16_failures(name, outputs, errs)
        rep = repeats_bitwise(lambda: kern(True)[0], k16) if repeat else None
        if rep is False:
            bad.append(f"{name}: run twice differs")
        ref = f32[per_n(name.replace(" (bf16)", ""), n)]
        r = {"name": per_n(name, n), "route": "cuda",
             "source": "ptyrad_tpu_torch/csrc/chain_bf16.cu", "replaces": ref["replaces"],
             "max_abs_err": max(e["max_abs"] for e in errs), "ms": time_ms(time_k16),
             "plain_ms": time_ms(time_t16), "bound_ms": ref["bound_ms"],
             "bound_by": ref["bound_by"], "library_ms": None}
        emit({"phase": "kernel", **r, "f32_row": ref["name"], "outputs": outputs, "errors": errs,
              "tolerance": BF16_TOLERANCE, "repeats_bitwise": rep})
        out.append(r)
        failures.extend(bad)

    def b5a(bf16):
        def call():
            return C.segment_fwd_cuda(psi, a_t, p_t, hk, True, bf16_operands=bf16)
        return (call(),), call

    def b5a_twin(bf16):
        def call():
            return C.chain_segment_plain(psi, a_t, p_t, h, True, bf16_operands=bf16)
        with torch.no_grad():
            return (call(),), call

    def b5b(bf16):
        def call():
            return C.segment_bwd_cuda(g, psi, a_t, p_t, hk, True, bf16_operands=bf16)[:3]
        return call(), call

    def b5b_twin(bf16):
        return _twin_vjp(lambda x, y, z: C.chain_segment_plain(x, y, z, h, True,
                                                               bf16_operands=bf16),
                         (psi, a_t, p_t), g)

    def b6a(bf16):
        def call():
            return C.stack_fwd_cuda(psi, a_m, p_m, hk, sg, False, bf16)
        return (call()[0],), call

    def b6a_twin(bf16):
        def call():
            return C.chain_stack_plain(psi, a_m, p_m, h, sg, False, bf16)
        with torch.no_grad():
            return (call(),), call

    def b6b(bf16):
        stack = C.stack_fwd_cuda(psi, a_m, p_m, hk, sg, False, bf16)[1]

        def call():
            return C.stack_bwd_cuda(g, stack, a_m, p_m, hk, sg, False, bf16_operands=bf16)[:3]
        return call(), call

    def b6b_twin(bf16):
        return _twin_vjp(lambda x, y, z: C.chain_stack_plain(x, y, z, h, sg, False, bf16),
                         (psi, a_m, p_m), g)

    row("B5a chain_segment_fwd (bf16)", ["exit"], b5a, b5a_twin)
    row("B5b chain_segment_bwd (bf16)", names, b5b, b5b_twin, repeat=True)
    row("B6a chain_stack_fwd (bf16)", ["exit"], b6a, b6a_twin)
    row("B6b chain_stack_bwd (bf16)", names, b6b, b6b_twin, repeat=True)
    return out


def check_chain_dh(dev, gen) -> list:
    """B5b and B6b with dH at the PSO shapes the main path gives them (B6
    over 2 x 8 slices with last_mega False, B5 over the 5-slice tail with
    `last` both ways), for a shared H (the PSO tilt path's case, which is
    timed) and a per-position one: every cotangent, dH included, against the
    plain chain's VJP."""
    from ptyrad_tpu_torch.ops import chain as C
    from ptyrad_tpu_torch.ops.shift import fourier_shift
    from ptyrad_tpu_torch.physics import electron_wavelength, near_field_evolution

    n, b, pm = PSO_NPIX, BATCH, PSO_PMODE
    lam = electron_wavelength(PSO_KV)
    h1 = torch.as_tensor(near_field_evolution((n, n), PSO_DX, PSO_DZ, lam), device=dev)[None]
    h_each = tilted_h(h1, 2.0 * torch.rand((b, 2), generator=gen, device=dev) - 1.0, PSO_DX,
                      PSO_DZ)
    probe = torch.as_tensor(pso_probe(), device=dev)
    psi = fourier_shift(probe, 0.3 * torch.randn((b, 2), generator=gen, device=dev))
    obja = 1.0 + 0.05 * torch.randn((b, 1, PSO_NZ, n, n), generator=gen, device=dev)
    objp = 0.1 * torch.randn((b, 1, PSO_NZ, n, n), generator=gen, device=dev)
    nz_main, sg_tail = 2 * PSO_SG, PSO_NZ - 2 * PSO_SG
    a_main, p_main = obja[:, 0, :nz_main], objp[:, 0, :nz_main]
    a_tail, p_tail = obja[:, 0, nz_main:], objp[:, 0, nz_main:]
    g = torch.complex(torch.randn(psi.shape, generator=gen, device=dev),
                      torch.randn(psi.shape, generator=gen, device=dev)) * float(psi.abs().max())
    names = ["d psi", "d a", "d phi", "d h"]

    def plain_vjp(fn, inputs):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        return out, leaves, torch.autograd.grad(out, leaves, grad_outputs=g, retain_graph=True)

    timed = {}
    for layout, h in (("shared", h1), ("each", h_each)):
        _, stack = C.stack_fwd_cuda(psi, a_main, p_main, h, PSO_SG, False)
        stack_fn = lambda x, y, z, w: C.chain_stack_plain(x, y, z, w, PSO_SG, False)  # noqa: E731
        out6, leaves6, g6p = plain_vjp(stack_fn, (psi, a_main, p_main, h))
        e6, t6 = _grad_errs(C.stack_bwd_cuda(g, stack, a_main, p_main, h, PSO_SG, False,
                                             need_dh=True), g6p)
        checks = [("B6", {"S": 2, "sg": PSO_SG, "last_mega": False}, e6, t6)]
        for last in (True, False):
            seg_fn = lambda x, y, z, w, last=last: C.chain_segment_plain(  # noqa: E731
                x, y, z, w, last)
            out5, leaves5, g5p = plain_vjp(seg_fn, (psi, a_tail, p_tail, h))
            e5, t5 = _grad_errs(C.segment_bwd_cuda(g, psi, a_tail, p_tail, h, last,
                                                   need_dh=True), g5p)
            checks.append(("B5", {"sg": sg_tail, "last": last}, e5, t5))
            if last and layout == "shared":
                timed[layout] = (stack, out6, leaves6, max(e6), out5, leaves5, max(e5))
        for name, extra, e, t in checks:
            emit({"phase": "kernel_check", "name": f"{name} with dH", "h": layout, **extra,
                  "bwd_max_abs_err": e, "bwd_tolerance": t, "bwd_names": names})
            for nm, ei, ti in zip(names, e, t):
                require(ei <= ti, f"{name}b {nm} ({layout} H, {extra}) differs: {ei} > {ti}")
        del stack, out6, leaves6, g6p

    stack, out6, leaves6, e6, out5, leaves5, e5 = timed["shared"]
    h = h1
    field = 8 * psi.numel()
    n_wave = b * pm

    def slab(k):
        return 2 * 4 * b * k * n * n  # a and phi

    # dH: U conj(K) and its sum, 8 operations per element and propagation
    def dh_ops(n_prop):
        return n_wave * n_prop * 8 * n * n

    # B6b: rebuild 2 x 8 propagations (the final slice's K included), walk 16
    # adjoint slices and 16 adjoint propagations (the exit's included). The
    # bound counts inputs read once and outputs written once; the K scratch
    # (one field written and read per propagation) is reported apart.
    n6 = nz_main
    b6_bytes = 3 * field + slab(nz_main) + 8 * h.numel() + field + slab(nz_main) \
        + 8 * h.numel()
    b6_ops = _chain_ops(n, n_wave, 2 * n6, n6, nz_main) + dh_ops(n6)
    n5 = sg_tail - 1  # B5b with last: 4 propagations each way
    b5_bytes = 2 * field + slab(sg_tail) + 8 * h.numel() + field + slab(sg_tail) \
        + 8 * h.numel()
    b5_ops = _chain_ops(n, n_wave, 2 * n5, n5, sg_tail) + dh_ops(n5)
    rows = [
        {"name": "B6b chain_stack_bwd (dH)", "route": "cuda",
         "source": "ptyrad_tpu_torch/csrc/chain.cu",
         "replaces": "ptyrad_tpu/ops/pallas_chain.py:529", "max_abs_err": e6,
         "ms": time_ms(lambda: C.stack_bwd_cuda(g, stack, a_main, p_main, h, PSO_SG, False,
                                                need_dh=True)),
         "plain_ms": time_ms(lambda: torch.autograd.grad(out6, leaves6, grad_outputs=g,
                                                         retain_graph=True)),
         "library_ms": None, "scratch_bytes": 2 * field * n6,
         **dict(zip(("bound_ms", "bound_by"), bound(b6_bytes, b6_ops)))},
        {"name": "B5b chain_segment_bwd (dH)", "route": "cuda",
         "source": "ptyrad_tpu_torch/csrc/chain.cu",
         "replaces": "ptyrad_tpu/ops/pallas_chain.py:279", "max_abs_err": e5,
         "ms": time_ms(lambda: C.segment_bwd_cuda(g, psi, a_tail, p_tail, h, True,
                                                  need_dh=True)),
         "plain_ms": time_ms(lambda: torch.autograd.grad(out5, leaves5, grad_outputs=g,
                                                         retain_graph=True)),
         "library_ms": None, "scratch_bytes": 2 * field * n5,
         **dict(zip(("bound_ms", "bound_by"), bound(b5_bytes, b5_ops)))},
    ]
    for k in rows:
        emit({"phase": "kernel", **k, "note": "PSO shapes, shared H; scratch_bytes: the K "
              "scratch written and read back, not in the bound"})
    return rows


def check_chain_ff(dev, gen) -> list:
    """B5a and B5b with the far-field exit against
    chain_segment_plain(far_field=True) and its VJP, without and with dH
    (shared H), over the 5-slice tail: at the PSO shapes the pso_ff path
    gives them (B = 32, N = 256) and at N = 512 (B = 8: the same bytes).
    library_ms is what the exit replaces, timed on the same inputs: B5
    without the exit plus torch.fft.fft2(norm="ortho"), or that transform's
    autograd backward before B5b."""
    from ptyrad_tpu_torch.ops import chain as C
    from ptyrad_tpu_torch.ops.shift import fourier_shift
    from ptyrad_tpu_torch.physics import electron_wavelength, near_field_evolution

    pm, sg = PSO_PMODE, PSO_NZ - 2 * PSO_SG
    lam = electron_wavelength(PSO_KV)
    names = ["d psi", "d a", "d phi", "d h"]
    rows = []
    for n, b in ((PSO_NPIX, BATCH), (512, 8)):
        h = torch.as_tensor(near_field_evolution((n, n), PSO_DX, PSO_DZ, lam), device=dev)[None]
        psi = fourier_shift(torch.as_tensor(pso_probe(n), device=dev),
                            0.3 * torch.randn((b, 2), generator=gen, device=dev))
        # the tail's a/phi as views into whole patches, as multislice_dp_chain passes them
        obja = 1.0 + 0.05 * torch.randn((b, 1, PSO_NZ, n, n), generator=gen, device=dev)
        objp = 0.1 * torch.randn((b, 1, PSO_NZ, n, n), generator=gen, device=dev)
        a_t, p_t = obja[:, 0, 2 * PSO_SG:], objp[:, 0, 2 * PSO_SG:]
        g = torch.complex(torch.randn(psi.shape, generator=gen, device=dev),
                          torch.randn(psi.shape, generator=gen, device=dev))

        leaves = [t.detach().clone().requires_grad_(True) for t in (psi, a_t, p_t, h)]
        out_p = C.chain_segment_plain(*leaves, True, far_field=True)
        g_plain = torch.autograd.grad(out_p, leaves, grad_outputs=g, retain_graph=True)
        out_k = C.segment_fwd_cuda(psi, a_t, p_t, h, True, far_field=True)
        (e_f,), (t_f,) = _grad_errs([out_k], [out_p.detach()])
        e_b, t_b = _grad_errs(C.segment_bwd_cuda(g, psi, a_t, p_t, h, True, far_field=True)[:3],
                              g_plain[:3])
        e_d, t_d = _grad_errs(C.segment_bwd_cuda(g, psi, a_t, p_t, h, True, need_dh=True,
                                                 far_field=True), g_plain)
        emit({"phase": "kernel_check", "name": "B5 chain_segment with the far-field exit",
              "N": n, "B": b, "sg": sg, "fwd_max_abs_err": e_f, "fwd_tolerance": t_f,
              "bwd_max_abs_err": e_b, "bwd_tolerance": t_b, "bwd_dh_max_abs_err": e_d,
              "bwd_dh_tolerance": t_d, "bwd_names": names})
        require(e_f <= t_f, f"B5a far-field (N={n}) differs from its plain version: {e_f} > {t_f}")
        for nm, e, t in zip(names, e_b, t_b):
            require(e <= t, f"B5b far-field {nm} (N={n}) differs: {e} > {t}")
        for nm, e, t in zip(names, e_d, t_d):
            require(e <= t, f"B5b far-field with dH {nm} (N={n}) differs: {e} > {t}")

        # what the exit replaces: the detector transform through cuFFT and autograd
        x = torch.empty_like(psi).requires_grad_(True)
        y = torch.fft.fft2(x, norm="ortho")

        def fft_bwd():
            return torch.autograd.grad(y, x, grad_outputs=g, retain_graph=True)[0]

        field, nn, n_wave, n_prop = 8 * psi.numel(), n * n, b * pm, sg - 1
        slab = 2 * 4 * b * sg * nn  # a and phi
        fft_ops = n_wave * 10 * nn * np.log2(n)
        tag = "far-field" if n == PSO_NPIX else f"far-field, N={n}"
        common = {"route": "cuda", "source": "ptyrad_tpu_torch/csrc/chain.cu"}
        new = [
            {"name": f"B5a chain_segment_fwd ({tag})", **common,
             "replaces": "ptyrad_tpu/ops/pallas_chain.py:238", "max_abs_err": e_f,
             "ms": time_ms(lambda: C.segment_fwd_cuda(psi, a_t, p_t, h, True, far_field=True)),
             "plain_ms": time_ms(lambda: C.chain_segment_plain(psi, a_t, p_t, h, True,
                                                               far_field=True)),
             "library_ms": time_ms(lambda: torch.fft.fft2(
                 C.segment_fwd_cuda(psi, a_t, p_t, h, True), norm="ortho")),
             **dict(zip(("bound_ms", "bound_by"),
                        bound(2 * field + slab + 8 * h.numel(),
                              _chain_ops(n, n_wave, n_prop, sg) + fft_ops)))},
            {"name": f"B5b chain_segment_bwd ({tag})", **common,
             "replaces": "ptyrad_tpu/ops/pallas_chain.py:279", "max_abs_err": max(e_b),
             "ms": time_ms(lambda: C.segment_bwd_cuda(g, psi, a_t, p_t, h, True, far_field=True)),
             "plain_ms": time_ms(lambda: torch.autograd.grad(out_p, leaves[:3], grad_outputs=g,
                                                             retain_graph=True)),
             "library_ms": time_ms(lambda: C.segment_bwd_cuda(fft_bwd(), psi, a_t, p_t, h, True)),
             **dict(zip(("bound_ms", "bound_by"),
                        bound(3 * field + 2 * slab + 8 * h.numel(),
                              _chain_ops(n, n_wave, 2 * n_prop, n_prop, sg) + fft_ops)))},
        ]
        if n == PSO_NPIX:
            new.append(
                {"name": f"B5b chain_segment_bwd ({tag}, dH)", **common,
                 "replaces": "ptyrad_tpu/ops/pallas_chain.py:279", "max_abs_err": max(e_d),
                 "ms": time_ms(lambda: C.segment_bwd_cuda(g, psi, a_t, p_t, h, True, need_dh=True,
                                                          far_field=True)),
                 "plain_ms": time_ms(lambda: torch.autograd.grad(out_p, leaves, grad_outputs=g,
                                                                 retain_graph=True)),
                 "library_ms": time_ms(lambda: C.segment_bwd_cuda(fft_bwd(), psi, a_t, p_t, h,
                                                                  True, need_dh=True)),
                 "scratch_bytes": 2 * field * n_prop,
                 **dict(zip(("bound_ms", "bound_by"),
                            bound(3 * field + 2 * slab + 16 * h.numel(),
                                  _chain_ops(n, n_wave, 2 * n_prop, n_prop, sg) + fft_ops
                                  + n_wave * n_prop * 8 * nn)))})
        for k in new:
            emit({"phase": "kernel", **k, "B": b, "note": "the 5-slice tail, shared H; library_ms: "
                  "B5 without the exit plus torch.fft.fft2(norm='ortho') or its autograd "
                  "backward, which the exit replaces"
                  + ("" if n == PSO_NPIX else "; no driven path runs N = 512: 0 launches")})
        rows += new
        del out_p, leaves, g_plain, y, x
        torch.cuda.empty_cache()
    return rows


# -- phase 4: the main path -----------------------------------------------------

def ground_truth_phase(canvas: int) -> np.ndarray:
    """Sum of 300 Gaussian blobs (0.15 rad, variance 2 px^2) per slice at
    seeded random centres, as bench.build_workload draws them; each blob is
    evaluated in a 25^2 window, beyond which it is below 1e-15."""
    rng = np.random.default_rng(SEED)
    phase = np.zeros((NZ, canvas, canvas), np.float32)
    d = np.arange(-12, 13, dtype=np.float32)
    blob = 0.15 * np.exp(-(d[:, None] ** 2 + d[None, :] ** 2) / 4.0)
    for z in range(NZ):
        for _ in range(300):
            cy, cx = rng.integers(12, canvas - 12, 2)
            phase[z, cy - 12:cy + 13, cx - 12:cx + 13] += blob
    return phase


def simulate(dev, init: dict) -> torch.Tensor:
    """Measurements from the known object through the port's forward() under
    no_grad, as bench.py and demo/scripts/run_synthetic_demo.py simulate
    (set-up, not the path being driven): B4a in batches of SIM_BATCH. Every
    8th batch is held against the plain multislice_dp on the same patches
    within 1e-4 of its largest value."""
    from ptyrad_tpu_torch.models import (compute_propagators, forward, get_probes, make_model,
                                         multislice_dp)
    from ptyrad_tpu_torch.ops import fused_multislice as M

    params, buffers, geom = make_model(init, None, dev)
    meas = torch.empty((N_SCANS, NPIX, NPIX), dtype=torch.float32, device=dev)
    launches, checks = M.dp_fwd_cuda.launches, []
    h_each = M.dp_fwd_cuda.launches_h_each
    t0 = time.perf_counter()
    with torch.no_grad():
        for k, start in enumerate(range(0, N_SCANS, SIM_BATCH)):
            idx = torch.arange(start, min(start + SIM_BATCH, N_SCANS), device=dev)
            dp, (obja_p, objp_p) = forward(params, buffers, geom, idx)
            meas[idx] = dp
            if k % 8 == 0:
                ref = multislice_dp(obja_p, objp_p, get_probes(params, geom, idx),
                                    compute_propagators(params, buffers, geom, idx),
                                    buffers.omode_occu, eps=geom.eps)
                checks.append((float((dp - ref).abs().max()), 1e-4 * float(ref.abs().max())))
    torch.cuda.synchronize()
    launches = M.dp_fwd_cuda.launches - launches
    h_each = M.dp_fwd_cuda.launches_h_each - h_each
    emit({"phase": "simulate", "n_patterns": N_SCANS, "batch": SIM_BATCH,
          "tilts": "per position" if not geom.global_tilt else "none",
          "seconds": time.perf_counter() - t0, "b4a_launches": launches,
          "b4a_per_position_h_launches": h_each,
          "checked_batches": len(checks), "max_abs_err": [e for e, _ in checks],
          "tolerance": [t for _, t in checks]})
    require(launches == -(-N_SCANS // SIM_BATCH), f"simulate ran B4a {launches} times")
    require(h_each == (0 if geom.global_tilt else launches),
            f"simulate ran B4a on a per-position H {h_each} times")
    require(bool(torch.isfinite(meas).all()), "simulated measurements are not finite")
    for e, t in checks:
        require(e <= t, f"forward() differs from the plain multislice_dp: {e} > {t}")
    return meas


def kernel_counters():
    """Row name -> (wrapper, count attribute): `launches` counts every
    launch; `launches_h_each` those on a per-position H; `launches_dh` the
    backwards that computed dH; `launches_ff` those of B5 that took the
    far-field exit, `launches_ff_dh` its backwards that also computed dH;
    `launches_nz1` those of B3 at one slice; `launches_bf16` those of the
    bfloat16-operand kernels, `launches_bf16_dh` and `launches_ff_bf16`
    those of them with dH or the exit; PLAIN_ROUTE the forward() calls that
    took the plain torch.fft chain."""
    from ptyrad_tpu_torch.ops import chain as C
    from ptyrad_tpu_torch.ops import fused_multislice as M
    from ptyrad_tpu_torch.ops import patches as P

    every = {"B1 gather_patches": P.gather_cuda, "B2 scatter_add_patches": P.scatter_add_cuda,
             "B3a loss_sums_fwd": M.loss_sums_fwd_cuda, "B3b loss_sums_bwd": M.loss_sums_bwd_cuda,
             "B4a dp_fwd": M.dp_fwd_cuda, "B4b dp_bwd": M.dp_bwd_cuda,
             "B5a chain_segment_fwd": C.segment_fwd_cuda,
             "B5b chain_segment_bwd": C.segment_bwd_cuda,
             "B6a chain_stack_fwd": C.stack_fwd_cuda, "B6b chain_stack_bwd": C.stack_bwd_cuda}
    out = {name: (fn, "launches") for name, fn in every.items()}
    out.update({
        PLAIN_ROUTE: (importlib.import_module("ptyrad_tpu_torch.models.forward").forward,
                      "launches_plain"),
        "B3a loss_sums_fwd (per-position H)": (M.loss_sums_fwd_cuda, "launches_h_each"),
        "B3b loss_sums_bwd (dH)": (M.loss_sums_bwd_cuda, "launches_dh"),
        "B3a loss_sums_fwd (nz=1)": (M.loss_sums_fwd_cuda, "launches_nz1"),
        "B3b loss_sums_bwd (nz=1)": (M.loss_sums_bwd_cuda, "launches_nz1"),
        "B4a dp_fwd (per-position H)": (M.dp_fwd_cuda, "launches_h_each"),
        "B4b dp_bwd (dH)": (M.dp_bwd_cuda, "launches_dh"),
        "B5b chain_segment_bwd (dH)": (C.segment_bwd_cuda, "launches_dh"),
        "B6b chain_stack_bwd (dH)": (C.stack_bwd_cuda, "launches_dh"),
        "B5a chain_segment_fwd (far-field)": (C.segment_fwd_cuda, "launches_ff"),
        "B5b chain_segment_bwd (far-field)": (C.segment_bwd_cuda, "launches_ff"),
        "B5b chain_segment_bwd (far-field, dH)": (C.segment_bwd_cuda, "launches_ff_dh"),
        # the bfloat16-operand kernels (the _bf16 entry points)
        "B3a loss_sums_fwd (bf16)": (M.loss_sums_fwd_cuda, "launches_bf16"),
        "B3b loss_sums_bwd (bf16)": (M.loss_sums_bwd_cuda, "launches_bf16"),
        "B3b loss_sums_bwd (bf16, dH)": (M.loss_sums_bwd_cuda, "launches_bf16_dh"),
        "B4a dp_fwd (bf16)": (M.dp_fwd_cuda, "launches_bf16"),
        "B4b dp_bwd (bf16)": (M.dp_bwd_cuda, "launches_bf16"),
        "B5a chain_segment_fwd (bf16)": (C.segment_fwd_cuda, "launches_bf16"),
        "B5a chain_segment_fwd (far-field, bf16)": (C.segment_fwd_cuda, "launches_ff_bf16"),
        "B5b chain_segment_bwd (bf16)": (C.segment_bwd_cuda, "launches_bf16"),
        "B6a chain_stack_fwd (bf16)": (C.stack_fwd_cuda, "launches_bf16"),
        "B6b chain_stack_bwd (bf16)": (C.stack_bwd_cuda, "launches_bf16"),
        "B6b chain_stack_bwd (bf16, dH)": (C.stack_bwd_cuda, "launches_bf16_dh"),
    })
    # the kernels at each N that is not a power of two (check_fused_npo2's
    # rows; two row sets at one N share its counts)
    for n, _, tag in FUSED_ROWS:
        out.update({
            f"B3a loss_sums_fwd ({tag})": (M.loss_sums_fwd_cuda, f"launches_n{n}"),
            f"B3b loss_sums_bwd ({tag})": (M.loss_sums_bwd_cuda, f"launches_n{n}"),
            f"B3b loss_sums_bwd (dH, {tag})": (M.loss_sums_bwd_cuda, f"launches_n{n}_dh"),
            f"B4a dp_fwd ({tag})": (M.dp_fwd_cuda, f"launches_n{n}"),
            f"B4b dp_bwd ({tag})": (M.dp_bwd_cuda, f"launches_n{n}"),
        })
        for name, fn in (("B3a loss_sums_fwd", M.loss_sums_fwd_cuda),
                         ("B3b loss_sums_bwd", M.loss_sums_bwd_cuda),
                         ("B4a dp_fwd", M.dp_fwd_cuda), ("B4b dp_bwd", M.dp_bwd_cuda)):
            if tag in FUSED_BF16_ROWS:
                out[f"{name} (bf16, {tag})"] = (fn, f"launches_n{n}_bf16")
    # the segmented chain's mixed-radix kernels at each N in (128, 512]
    for n in CHAIN_NS:
        for name, wrapper, flags in CHAIN_SPLITS:
            out[per_n(name, n)] = (getattr(C, wrapper), "_".join([f"launches_n{n}", *flags]))
    return out


def per_n(name: str, n: int) -> str:
    """A row's name at N: "B5a chain_segment_fwd (N=192)", "B5b
    chain_segment_bwd (dH, N=192)"."""
    return f"{name[:-1]}, N={n})" if name.endswith(")") else f"{name} (N={n})"


# The chain rows split by N (the wrapper, and the flags of its per-N count,
# ops/chain.py _count_n): the generic row counts the power-of-two build's
# launches only (main subtracts these)
CHAIN_WRAPPERS = {"B5a chain_segment_fwd": "segment_fwd_cuda",
                  "B5b chain_segment_bwd": "segment_bwd_cuda",
                  "B6a chain_stack_fwd": "stack_fwd_cuda", "B6b chain_stack_bwd": "stack_bwd_cuda"}
CHAIN_SPLITS = tuple(
    (name, CHAIN_WRAPPERS[name.split(" (")[0]], flags) for name, flags in (
        ("B5a chain_segment_fwd", ()), ("B5a chain_segment_fwd (far-field)", ("ff",)),
        ("B5b chain_segment_bwd", ()), ("B5b chain_segment_bwd (dH)", ("dh",)),
        ("B5b chain_segment_bwd (far-field)", ("ff",)), ("B6a chain_stack_fwd", ()),
        ("B6b chain_stack_bwd", ()), ("B6b chain_stack_bwd (dH)", ("dh",)),
        ("B5a chain_segment_fwd (bf16)", ("bf16",)), ("B5b chain_segment_bwd (bf16)", ("bf16",)),
        ("B6a chain_stack_fwd (bf16)", ("bf16",)), ("B6b chain_stack_bwd (bf16)", ("bf16",))))


PLAIN_ROUTE = "forward() plain route"
PATCH_KERNELS = ("B1 gather_patches", "B2 scatter_add_patches")
CHAIN_KERNELS = ("B5a chain_segment_fwd", "B5b chain_segment_bwd", "B6a chain_stack_fwd",
                 "B6b chain_stack_bwd")
TBL_KERNELS = ("B1 gather_patches", "B2 scatter_add_patches", "B3a loss_sums_fwd",
               "B3b loss_sums_bwd")
LOW_DOSE_KERNELS = ("B1 gather_patches", "B2 scatter_add_patches", "B4a dp_fwd", "B4b dp_bwd")
PSO_KERNELS = ("B1 gather_patches", "B2 scatter_add_patches", "B5a chain_segment_fwd",
               "B5b chain_segment_bwd", "B6a chain_stack_fwd", "B6b chain_stack_bwd")
TILT_KERNELS = ("B1 gather_patches", "B2 scatter_add_patches",
                "B3a loss_sums_fwd (per-position H)", "B3b loss_sums_bwd (dH)")
PSO_FF_KERNELS = PSO_KERNELS + ("B5a chain_segment_fwd (far-field)",
                                "B5b chain_segment_bwd (far-field)")
PSO_TILT_KERNELS = PSO_KERNELS + ("B5b chain_segment_bwd (dH)", "B6b chain_stack_bwd (dH)")
# Rows of the kernels line that only size the far-field kernels at N = 512: every
# driven path runs them at N = 256 (PSO_NPIX), so these rows report 0 launches.
NOT_DRIVEN = ("B5a chain_segment_fwd (far-field, N=512)",
              "B5b chain_segment_bwd (far-field, N=512)")


def counted(fn):
    """fn() with every launch count set to 0 just before it: (its result,
    the counts just after)."""
    counters = kernel_counters()
    for f, attr in counters.values():
        setattr(f, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    return out, {name: getattr(f, attr) for name, (f, attr) in counters.items()}


def drive(solver) -> dict:
    """solver.run() under counted(): the counts of the run."""
    return counted(solver.run)[1]


def add_counts(*runs) -> dict:
    return {k: sum(run[k] for run in runs) for k in runs[0]}


def tbl_init() -> dict:
    """init_variables of the tBL simulation: the known object, the probe,
    the raster and the yml's 2 Ang slices; no tilt; measurements to fill."""
    from ptyrad_tpu_torch.physics import electron_wavelength, near_field_evolution

    crop_pos, canvas = tbl_positions()
    lam = electron_wavelength(80.0)
    return {
        "obj": np.exp(1j * ground_truth_phase(canvas))[None].astype(np.complex64),
        "probe": tbl_probe(),
        "probe_pos_shifts": np.zeros((N_SCANS, 2), np.float32),
        "obj_tilts": np.zeros((1, 2), np.float32),
        "slice_thickness": 2.0,
        "H": near_field_evolution((NPIX, NPIX), 0.1494, 2.0, lam),
        "measurements": np.zeros((1, NPIX, NPIX), np.float32),
        "crop_pos": crop_pos,
        "omode_occu": np.ones(1, np.float32),
        "dx": 0.1494,
        "lambd": lam,
        "N_scan_slow": N_SIDE,
        "N_scan_fast": N_SIDE,
    }


def main_path(dev, card: str):
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    t0 = time.perf_counter()
    init = tbl_init()
    init["measurements"] = simulate(dev, init)
    init["obj"] = np.ones_like(init["obj"])
    setup_s = time.perf_counter() - t0

    solver = PtyRADSolver(TBL_PARAMS, init_variables=init, device=dev, verbose=True)
    torch.cuda.reset_peak_memory_stats()
    record = RunRecord()
    t1 = time.perf_counter()
    launches = counted(lambda: solver.run(callback=record))[1]
    run_s = time.perf_counter() - t1
    record.finish(solver)

    losses = [v for _, v in solver.history.loss_iters]
    times = solver.history.iter_times
    out = {
        "phase": "main", "card": card, "n_patterns": N_SCANS, "batch": BATCH,
        "iterations": len(losses), "losses": losses, "iter_s": times,
        "patterns_per_s": [N_SCANS / t for t in times], "setup_s": setup_s, "run_s": run_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches,
    }
    emit(out)
    require(len(losses) == NITER and all(np.isfinite(losses)), f"loss not finite: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for name in TBL_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the tBL path")
    return solver, launches, init, record


# -- determinism (fault C9): two runs of a path equal bit for bit ---------------

class RunRecord:
    """A solver callback that keeps every iteration's per-batch loss terms;
    ``finish`` keeps the final obja, objp and probe on the host."""

    def __init__(self):
        self.batch_terms = {}
        self.losses = []
        self.tensors = {}

    def __call__(self, niter, params, history):
        self.batch_terms[niter] = {k: list(v) for k, v in history.batch_terms.items()}

    def finish(self, solver):
        self.losses = [v for _, v in solver.history.loss_iters]
        self.tensors = {k: getattr(solver.params, k).detach().cpu().clone()
                        for k in ("obja", "objp", "probe")}


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))) if a.size else 0.0


def nondeterministic_ops(solver, niter: int) -> list:
    """What torch.use_deterministic_algorithms(True, warn_only=True) names
    while the solver runs 2 batches: the ops with no deterministic CUDA
    implementation on the path (the diagnostic when two runs part)."""
    import warnings

    idx = torch.as_tensor(solver.batch_idx[:2], device=solver.device)
    mask = torch.as_tensor(solver.batch_mask[:2], device=solver.device)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            solver.train_epoch(idx, mask, niter)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split("\n")[0][:200] for w in caught})


def determinism_check(path: str, card: str, first: RunRecord, second: RunRecord,
                      solver=None) -> None:
    """Two runs of a path (same data, same sections, one process) must give
    the same per-batch loss terms in every iteration, the same losses and
    the same final obja, objp and probe, bit for bit: B3b/B4b reduce over
    modes and samples in a fixed order and B2 sums in batch order. Where
    they part, the ops torch's deterministic mode warns about are named
    (``solver``: a solver of the path to run them on)."""
    iters = sorted(first.batch_terms)
    batches_equal = {n: first.batch_terms[n] == second.batch_terms.get(n) for n in iters}
    tensors_equal = {k: torch.equal(first.tensors[k], second.tensors[k]) for k in first.tensors}
    out = {"phase": "determinism", "path": path, "card": card, "iterations": iters,
           "losses": [first.losses, second.losses],
           "losses_equal": first.losses == second.losses,
           "batch_terms_equal": batches_equal, "tensors_equal": tensors_equal,
           "batch_terms_max_rel_diff": {
               n: max(_max_rel(first.batch_terms[n][k], second.batch_terms[n][k])
                      for k in first.batch_terms[n]) for n in iters},
           "tensors_max_rel_diff": {k: _max_rel(first.tensors[k].abs().numpy(),
                                                second.tensors[k].abs().numpy())
                                    for k in first.tensors}}
    same = out["losses_equal"] and all(batches_equal.values()) and all(tensors_equal.values())
    if not same and solver is not None:
        out["nondeterministic_ops"] = nondeterministic_ops(solver, iters[-1])
    emit(out)
    require(same, f"determinism ({path}): two runs differ: {out}")


# -- the resume phase: a checkpoint of iteration 2 continues at iteration 3 ------

def resume_from(ckpt: dict, params: dict, init: dict, dev, verbose: bool = False):
    """A solver set to go on from a checkpoint: ``ckpt`` is make_save_dict's
    dict or load_ptyrad's of a model.hdf5 (which needs h5py). The
    optimizable tensors go into ``init`` (the object as float64 amplitude
    and phase, which make_model splits back into the float32 ones exactly),
    the optimizer state through optim.load_opt_state_values. Run it with
    recon_loop(start_niter=<the checkpoint's niter> + 1)."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver
    from ptyrad_tpu_torch.optim import load_opt_state_values

    t = ckpt["optimizable_tensors"]
    obj = np.asarray(t["obja"], np.float64) * np.exp(1j * np.asarray(t["objp"], np.float64))
    iv = {**init, "obj": obj, "probe": t["probe"], "probe_pos_shifts": t["probe_pos_shifts"],
          "obj_tilts": t["obj_tilts"], "slice_thickness": t["slice_thickness"]}
    solver = PtyRADSolver(params, init_variables=iv, device=dev, verbose=verbose)
    solver.prepare()
    solver._build()
    load_opt_state_values(solver.optimizer, ckpt["optim_state_dict"])
    return solver


def resume_step(solver, start_niter: int, verbose: bool = False):
    """Iteration ``start_niter`` of a resumed solver; its ReconHistory."""
    from ptyrad_tpu_torch.engine.solver import recon_loop

    return recon_loop(solver.train_epoch, solver.params, solver.batch_idx, solver.batch_mask, 1,
                      solver.constraint_fn, solver.buffers, verbose=verbose,
                      optimizer=solver.optimizer, start_niter=start_niter)[1]


def batch_totals(history) -> np.ndarray:
    """The total loss of each batch of the history's last iteration, in the
    order the batches ran."""
    return np.sum([np.asarray(v) for v in history.batch_terms.values()], axis=0)


# -- the optimizer phases (A5): LBFGS, accumulation, every family, grouping ----

LBFGS_NITER = 2          # iterations of each of the lbfgs phase's two runs
GRAD_ACCUM, GRAD_ACCUM_NITER = 4, 2
FAMILY_BATCHES = 16      # batches each optimizer family runs
# every registry name but Adam (the main phase's) and LBFGS (its own phase),
# with the configs of a torch-named params file; then the optax configs a
# params file can spell beyond the torch names: eps_root and Adam's nesterov
# (optim.AdamRule in place of torch's Adam), the moments' storage dtypes and
# the decay masks. AdamW stays first: its row carries the start_iter check.
FAMILIES = (("AdamW", {"weight_decay": 0.1}), ("SGD", {"momentum": 0.9}), ("RMSprop", {}),
            ("Adagrad", {}), ("Adamax", {}), ("NAdam", {}), ("RAdam", {}), ("Adadelta", {}),
            ("Rprop", {}), ("ASGD", {}), ("Adafactor", {}), ("Muon", {}), ("SparseAdam", {}),
            ("Adam", {"nesterov": True, "eps_root": 1e-8}), ("Adam", {"mu_dtype": "bfloat16"}),
            ("NAdam", {"mu_dtype": "bfloat16"}), ("AdamW", {"weight_decay": 0.1, "mask": False}),
            ("SGD", {"momentum": 0.9, "accumulator_dtype": "bfloat16"}),
            ("Adafactor", {"momentum": 0.9, "dtype_momentum": "bfloat16"}),
            ("Muon", {"mu_dtype": "bfloat16", "weight_decay": 0.01, "weight_decay_mask": False}))
FAMILY_RTOL = 1e-5       # one step on CUDA against the same step on the CPU
# a dtype config -> the state slots it stores (optim's OptaxRule slot names)
DTYPE_SLOTS = {"mu_dtype": ("mu", "muon_mu", "adam_mu"), "accumulator_dtype": ("trace",),
               "dtype_momentum": ("ema",)}
# seconds each of these phases is expected to take on the card (PERF.md §6)
PREDICTED_S = {"lbfgs": (10, 60), "grad_accum": (8, 20), "optimizers": (8, 30),
               "grouping": (5, 30), "pso_n1024": (40, 90)}


def with_optimizer(params: dict, optimizer_params: dict, **recon) -> dict:
    out = copy.deepcopy(params)
    out["model_params"]["optimizer_params"] = optimizer_params
    out["recon_params"].update(recon)
    return out


def lbfgs_run(dev, init: dict, niter: int):
    """tBL's own sections with LBFGS (history_size 10) for niter iterations:
    (solver, launches, the parameters after the last iteration on the
    host)."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    params = with_optimizer(TBL_PARAMS, {"name": "LBFGS", "configs": {"history_size": 10}},
                            NITER=niter)
    solver = PtyRADSolver(params, init_variables=init, device=dev, verbose=True)
    _, launches = counted(solver.run)
    return solver, launches, {k: t.detach().cpu().clone() for k, t in solver.params.named()}


def batch_mean_loss(solver) -> float:
    """The mean of the per-batch losses at the solver's parameters (no
    gradient), summed in batch order as the LBFGS objective sums them."""
    from ptyrad_tpu_torch.engine.solver import loss_fn

    acc = torch.zeros((), dtype=torch.float32, device=solver.device)
    with torch.no_grad():
        for i, m in zip(solver.batch_idx, solver.batch_mask):
            acc = acc + loss_fn(solver.params, solver.buffers, solver.geom,
                                torch.as_tensor(i, device=solver.device),
                                torch.as_tensor(m, device=solver.device), solver.loss_params)[0]
    return float(acc / len(solver.batch_idx))


def lbfgs_path(dev, card: str, init: dict) -> dict:
    """LBFGS at tBL full width through B1, B2, B3a and B3b: the objective is
    the mean loss over all 512 batches (one backward per batch), and each
    iteration runs the zoom line search, every step of which evaluates it
    again. Gates: a finite, falling loss; probe_pos_shifts (start_iter 10)
    unchanged bit for bit; the first objective value equal to the batch
    mean recomputed at the start parameters (rtol 1e-6); a second run
    (its values, line-search steps, evaluations and final parameters) equal
    to the first bit for bit, which needs B3b's fixed-order reduce."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver
    from ptyrad_tpu_torch.optim_lbfgs import LBFGS

    t0 = time.perf_counter()
    probe = PtyRADSolver(TBL_PARAMS, init_variables=init, device=dev, verbose=False)
    probe.prepare()
    start_mean = batch_mean_loss(probe)
    shifts0 = probe.params.probe_pos_shifts.detach().cpu().clone()
    del probe
    solver, launches, final = lbfgs_run(dev, init, LBFGS_NITER)
    first_s = time.perf_counter() - t0
    h = solver.history
    losses = [v for _, v in h.loss_iters]
    steps = [(s, e) for _, s, e in h.linesearch]
    shifts = solver.params.probe_pos_shifts.detach().cpu()
    require(isinstance(solver.optimizer, LBFGS), "lbfgs: the solver did not build LBFGS")
    del solver
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    again, counts, again_final = lbfgs_run(dev, init, LBFGS_NITER)
    rerun_s = time.perf_counter() - t1
    launches = add_counts(launches, counts)
    rerun = {"losses": [v for _, v in again.history.loss_iters],
             "linesearch": [(s, e) for _, s, e in again.history.linesearch]}
    same = (rerun["losses"] == losses and rerun["linesearch"] == steps
            and all(torch.equal(final[k], again_final[k]) for k in final))
    del again
    out = {"phase": "lbfgs", "card": card, "n_patterns": N_SCANS, "batch": BATCH,
           "history_size": 10, "iterations": len(losses), "losses": losses,
           "linesearch_steps": [s for s, _ in steps], "evaluations": [e for _, e in steps],
           "iter_s": h.iter_times, "patterns_per_s_per_evaluation": [
               N_SCANS * e / t for (_, e), t in zip(steps, h.iter_times)],
           "first_value": losses[0], "batch_mean_at_start": start_mean,
           "first_value_rel_diff": abs(losses[0] - start_mean) / abs(start_mean),
           "rerun": rerun, "rerun_bitwise": same,
           "shifts_unchanged": bool(torch.equal(shifts, shifts0)),
           "seconds": first_s + rerun_s, "rerun_s": rerun_s,
           "predicted_s": PREDICTED_S["lbfgs"], "launches": launches}
    emit(out)
    require(len(losses) == LBFGS_NITER and all(np.isfinite(losses)),
            f"lbfgs: loss not finite: {losses}")
    require(losses[-1] < losses[0], f"lbfgs: loss did not fall: {losses}")
    require(out["shifts_unchanged"], "lbfgs: probe_pos_shifts moved before its start_iter")
    require(out["first_value_rel_diff"] <= 1e-6,
            f"lbfgs: first objective {losses[0]} is not the batch mean {start_mean}")
    require(same, f"lbfgs: a second run differs: {rerun} against {losses}, {steps}")
    for name in TBL_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the lbfgs path")
    return launches


def grad_accum_path(dev, card: str, init: dict) -> dict:
    """Adam with grad_accumulation 4 at tBL full width: one step every 4
    batches, the running mean carried across iterations. A finite, falling
    loss; each tensor's Adam step count is the batches run over 4."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver
    from ptyrad_tpu_torch.optim import MultiSteps

    params = with_optimizer(TBL_PARAMS, {"name": "Adam"}, NITER=GRAD_ACCUM_NITER)
    params["recon_params"]["BATCH_SIZE"] = {"size": BATCH, "grad_accumulation": GRAD_ACCUM}
    solver = PtyRADSolver(params, init_variables=init, device=dev, verbose=True)
    t0 = time.perf_counter()
    _, launches = counted(solver.run)
    seconds = time.perf_counter() - t0
    losses = [v for _, v in solver.history.loss_iters]
    opt = solver.optimizer
    n_batches = len(solver.batch_idx) * GRAD_ACCUM_NITER
    steps = {g["name"]: float(opt.state[g["params"][0]]["step"]) for g in opt.param_groups}
    out = {"phase": "grad_accum", "card": card, "grad_accumulation": GRAD_ACCUM,
           "iterations": len(losses), "losses": losses, "iter_s": solver.history.iter_times,
           "patterns_per_s": [N_SCANS / t for t in solver.history.iter_times],
           "adam_steps": steps, "mini_step": opt.mini_step, "seconds": seconds,
           "predicted_s": PREDICTED_S["grad_accum"], "launches": launches}
    emit(out)
    require(isinstance(opt, MultiSteps), "grad_accum: the optimizer is not accumulating")
    require(len(losses) == GRAD_ACCUM_NITER and all(np.isfinite(losses)),
            f"grad_accum: loss not finite: {losses}")
    require(losses[-1] < losses[0], f"grad_accum: loss did not fall: {losses}")
    require(all(v == n_batches // GRAD_ACCUM for v in steps.values()),
            f"grad_accum: step counts {steps}, not {n_batches // GRAD_ACCUM}")
    require(opt.mini_step == n_batches % GRAD_ACCUM, f"grad_accum: mini_step {opt.mini_step}")
    return launches


def _on_cpu(v):
    """A state value (a tensor, a list of tensors or None, a count) copied to
    the CPU in its own dtype."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().clone()
    if isinstance(v, list):
        return [_on_cpu(x) for x in v]
    return v


def _cpu_twin(solver, name: str, configs: dict, update: dict):
    """The solver's parameters and optimizer state copied to the CPU, each
    state tensor in its own dtype (a bfloat16 state does not pass through a
    checkpoint's values: C11), with an optimizer of the same family over
    them."""
    from ptyrad_tpu_torch.models.state import PtychoParams
    from ptyrad_tpu_torch.optim import create_optimizer

    params = PtychoParams(**{k: t.detach().cpu().clone() for k, t in solver.params.named()})
    opt, _, _ = create_optimizer({"name": name, "configs": configs}, update, params)
    for ours, theirs in zip(opt.param_groups, solver.optimizer.param_groups):
        opt.state[ours["params"][0]] = {k: _on_cpu(v) for k, v in
                                        solver.optimizer.state[theirs["params"][0]].items()}
    return params, opt


def state_slots(opt, slots) -> list:
    """The tensors of an optimizer's state under these slot names, every
    param group's, the leaves that hold one."""
    return [t for st in opt.state.values() for k in slots if k in st
            for t in (st[k] if isinstance(st[k], list) else [st[k]]) if t is not None]


def masked_twin(name: str, configs: dict):
    """A row's configs with its False decay mask dropped and the decay the
    mask turns off removed (Adafactor's weight_decay_rate None, another
    family's weight_decay 0): the run a False mask must equal bit for bit.
    None when no mask is False."""
    masks = [k for k in ("mask", "weight_decay_mask") if configs.get(k) is False]
    if not masks:
        return None
    twin = {k: v for k, v in configs.items() if k not in masks}
    twin.update({"weight_decay_rate": None} if name == "Adafactor" else {"weight_decay": 0.0})
    return twin


def optimizers_path(dev, card: str, init: dict) -> dict:
    """Every registry name but Adam and LBFGS on the card, and the optax
    configs beyond the torch names (FAMILIES): FAMILY_BATCHES tBL batches
    each from the same start through B1-B3 (finite losses; each moment of
    a dtype config stored in that dtype on the card; a row with a decay
    mask False equal bit for bit to its family with that decay 0); then one
    more step on CUDA and the same step on the CPU, from copies of the same
    parameters, optimizer state and gradients: the parameters agree at rtol
    1e-5 (atol 1e-5 of each tensor's largest entry: torch's foreach and
    fused CUDA paths against the CPU's), and a moment stored in a 2-byte
    type within one step of that type (its machine epsilon times the
    moment's largest entry). AdamW (weight_decay 0.1) starts obja at
    iteration 2: run at iteration 1, obja must not move at all."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver, RankBatches, build_train_epoch, \
        loss_fn
    from ptyrad_tpu_torch.optim import create_optimizer, mask_unstarted_grads, \
        storage_dtype, unstarted_tensors

    t0 = time.perf_counter()
    solver = PtyRADSolver(TBL_PARAMS, init_variables=init, device=dev, verbose=False)
    solver.prepare()
    start = {k: t.detach().clone() for k, t in solver.params.named()}
    idx = torch.as_tensor(solver.batch_idx[:FAMILY_BATCHES + 1], device=dev)
    mask = torch.as_tensor(solver.batch_mask[:FAMILY_BATCHES + 1], device=dev)
    rows, launches = [], None

    def run(name, configs, update):
        """FAMILY_BATCHES batches of a fresh optimizer from the start:
        (start_dict, per-batch totals, seconds, launches)."""
        with torch.no_grad():
            for k, t in solver.params.named():
                t.copy_(start[k])
        solver.optimizer, _, start_dict = create_optimizer(
            {"name": name, "configs": configs}, update, solver.params)
        epoch = build_train_epoch(solver.params,
                                  RankBatches(solver.params, solver.buffers, solver.geom),
                                  solver.loss_params, solver.optimizer, start_dict)
        t1 = time.perf_counter()
        (_, terms), counts = counted(lambda: epoch(idx[:-1], mask[:-1], 1))
        seconds = time.perf_counter() - t1
        return (start_dict, np.sum([np.asarray(v) for v in terms.values()], axis=0), seconds,
                counts)

    for name, configs in FAMILIES:
        update = copy.deepcopy(TBL_PARAMS["model_params"]["update_params"])
        if name == "AdamW" and not rows:
            update["obja"]["start_iter"] = 2
        twin, twin_equal = masked_twin(name, configs), None
        if twin is not None:
            _, twin_totals, _, counts = run(name, twin, update)
            launches = counts if launches is None else add_counts(launches, counts)
            twin_params = {k: t.detach().clone() for k, t in solver.params.named()}
        start_dict, totals, seconds, counts = run(name, configs, update)
        launches = counts if launches is None else add_counts(launches, counts)
        if twin is not None:
            twin_equal = bool(np.array_equal(totals, twin_totals) and all(
                torch.equal(t, twin_params[k]) for k, t in solver.params.named()))
            del twin_params
        stored = {key: sorted({str(t.dtype) for t in state_slots(solver.optimizer, slots)}
                              | {t.device.type for t in state_slots(solver.optimizer, slots)})
                  for key, slots in DTYPE_SLOTS.items() if configs.get(key) is not None}
        stored_ok = all(v == sorted({str(storage_dtype(configs[k])), "cuda"})
                        for k, v in stored.items())
        obja_still = bool(torch.equal(solver.params.obja, start["obja"]))
        # one more batch's gradients, then the same step on both devices
        solver.optimizer.zero_grad(set_to_none=True)
        loss_fn(solver.params, solver.buffers, solver.geom, idx[-1], mask[-1],
                solver.loss_params)[0].backward()
        mask_unstarted_grads(solver.params, 1, start_dict)
        cpu_params, cpu_opt = _cpu_twin(solver, name, configs, update)
        for (_, a), (_, b) in zip(solver.params.named(), cpu_params.named()):
            b.grad = None if a.grad is None else a.grad.detach().cpu().clone()
        for p, o in ((solver.params, solver.optimizer), (cpu_params, cpu_opt)):
            frozen = unstarted_tensors(p, 1, start_dict)
            kept = [t.detach().clone() for t in frozen]
            o.step()
            with torch.no_grad():
                for t, k in zip(frozen, kept):
                    t.copy_(k)
        errs = {}
        for (k, a), (_, b) in zip(solver.params.named(), cpu_params.named()):
            a, b = a.detach().cpu(), b.detach()
            scale = float(b.abs().max())
            errs[k] = float(((a - b).abs() - FAMILY_RTOL * b.abs()).max()) / max(scale, 1e-30)
        slots = [s for key in stored for s in DTYPE_SLOTS[key]]
        pairs = zip(state_slots(solver.optimizer, slots), state_slots(cpu_opt, slots))
        steps = [float((a.cpu().float() - b.float()).abs().max())
                 / (torch.finfo(b.dtype).eps * max(float(b.float().abs().max()), 1e-30))
                 for a, b in pairs]
        rows.append({"name": name, "configs": configs, "losses_first_last":
                     [float(totals[0]), float(totals[-1])], "finite": bool(np.isfinite(totals).all()),
                     "seconds": seconds, "cuda_vs_cpu_excess": errs,
                     "stored_dtypes": stored or None, "stored_as_asked": stored_ok,
                     "moments_cuda_vs_cpu_steps": max(steps) if steps else None,
                     "equal_to_decay_off": twin_equal,
                     "obja_unchanged_before_start":
                         obja_still if update["obja"]["start_iter"] == 2 else None})
    seconds = time.perf_counter() - t0
    emit({"phase": "optimizers", "card": card, "batches": FAMILY_BATCHES, "families": rows,
          "rtol": FAMILY_RTOL, "seconds": seconds, "predicted_s": PREDICTED_S["optimizers"],
          "launches": launches})
    for r in rows:
        what = f"optimizers: {r['name']} {r['configs']}"
        require(r["finite"], f"{what} gave a non-finite loss")
        bad = {k: v for k, v in r["cuda_vs_cpu_excess"].items() if v > FAMILY_RTOL}
        require(not bad, f"{what}'s step on CUDA differs from the CPU's: {bad}")
        require(r["stored_as_asked"], f"{what}: moments stored as {r['stored_dtypes']}")
        require(r["moments_cuda_vs_cpu_steps"] is None or r["moments_cuda_vs_cpu_steps"] <= 1.0,
                f"{what}: a stored moment on CUDA is {r['moments_cuda_vs_cpu_steps']} steps of "
                "its type from the CPU's")
        require(r["equal_to_decay_off"] is not False,
                f"{what}: a False mask does not equal its decay off")
    require(rows[0]["obja_unchanged_before_start"],
            "optimizers: AdamW moved obja before its start_iter")
    for name in TBL_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the optimizers path")
    return launches


def grouping_path(dev, card: str, init: dict):
    """compact and sparse grouping of the 16,384 tBL positions (scikit-learn's
    MiniBatchKMeans, then the max-min assignment), one iteration each: the
    host seconds of make_batches, every index in exactly one batch, no
    batch empty, compact batches tighter than random ones and sparse ones
    wider (tests/test_engine.py:98-138's contract); None where scikit-learn
    does not import."""
    from ptyrad_tpu_torch.engine.batching import make_batches
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    if not optional_packages()["sklearn"]:
        print("grouping: skipped, scikit-learn missing", flush=True)
        emit({"phase": "grouping", "card": card, "skipped": "scikit-learn missing"})
        return None
    pos = init["crop_pos"].astype(np.float64)
    indices = np.arange(N_SCANS)

    def spread(batches):
        return float(np.mean([np.linalg.norm(pos[b] - pos[b].mean(0), axis=1).mean()
                              for b in batches]))

    def nearest(batches):
        """The mean over batches of each batch's smallest in-batch distance
        (on 64 seeded batches: the pairwise table of 32 positions each)."""
        vals = []
        pick = np.random.default_rng(SEED).choice(len(batches), min(64, len(batches)),
                                                  replace=False)
        for i in sorted(pick):
            b = pos[batches[i]]
            d = np.linalg.norm(b[:, None] - b[None], axis=-1)
            np.fill_diagonal(d, np.inf)
            vals.append(d.min())
        return float(np.mean(vals))

    random_b = make_batches(indices, pos, BATCH, mode="random", seed=SEED)
    out = {"phase": "grouping", "card": card, "n_positions": N_SCANS, "batch": BATCH,
           "random": {"spread": spread(random_b), "nearest": nearest(random_b)}}
    launches = None
    t_all = time.perf_counter()
    for mode in ("compact", "sparse"):
        params = copy.deepcopy(TBL_PARAMS)
        params["recon_params"].update(NITER=1, GROUP_MODE=mode)
        solver = PtyRADSolver(params, init_variables=init, device=dev, verbose=True)
        t0 = time.perf_counter()
        solver.prepare()  # make_batches, then the padding
        make_s = time.perf_counter() - t0
        batches = [i[m > 0] for i, m in zip(solver.batch_idx, solver.batch_mask)]
        flat = np.sort(np.concatenate(batches))
        _, counts = counted(solver.run)
        launches = counts if launches is None else add_counts(launches, counts)
        loss = solver.history.loss_iters[-1][1]
        out[mode] = {"make_batches_s": make_s, "batches": len(batches),
                     "sizes": [int(min(map(len, batches))), int(max(map(len, batches)))],
                     "partition": bool(np.array_equal(flat, indices)),
                     "empty": int(sum(len(b) == 0 for b in batches)),
                     "spread": spread(batches), "nearest": nearest(batches),
                     "loss": loss, "iter_s": solver.history.iter_times[-1]}
        del solver
    out.update(seconds=time.perf_counter() - t_all, predicted_s=PREDICTED_S["grouping"],
               launches=launches)
    emit(out)
    for mode in ("compact", "sparse"):
        r = out[mode]
        require(r["partition"] and r["empty"] == 0, f"grouping ({mode}): not a partition: {r}")
        require(np.isfinite(r["loss"]), f"grouping ({mode}): loss not finite")
    require(out["compact"]["spread"] < out["random"]["spread"],
            "grouping: compact batches are not tighter than random ones")
    require(out["sparse"]["nearest"] > out["compact"]["nearest"],
            "grouping: sparse batches are not wider than compact ones")
    for name in TBL_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the grouping path")
    return launches


# -- the params_file phase: the tBL run from its params file --------------------

OPTIONAL_PACKAGES = ("pydantic", "h5py", "yaml", "PIL", "scipy", "sklearn", "matplotlib",
                     "optuna")
SIM_DX = 0.1494  # Ang, the simulation's pixel size (tbl_probe, tbl_init)
RAW_GAP = 1024   # bytes after each EMPAD frame
INIT_STAGES = ("init_cache", "_load_meas", "_process_meas", "init_calibration",
               "set_variables_dict", "init_probe", "init_pos", "init_obj", "init_omode_occu",
               "init_H", "init_obj_tilts", "init_check")


def _tune(state: bool, suggest: str, **kwargs) -> dict:
    return {"state": state, "suggest": suggest, "kwargs": kwargs}


def tbl_params_file(meas_path: str) -> dict:
    """The params file of the params_file phase: the init_params of
    demo/params/tBL_WSe2_reconstruct.yml for the .raw at ``meas_path`` and
    TBL_PARAMS' other four sections, with every key that validation would
    fill written out (a fixed point of params/schema.py, held so by
    tests/test_torch_params.py), so the card's machine runs what validation
    would have given with or without pydantic. pos_scan_step_size is the
    simulated scan's (3 px of SIM_DX), not the yml's 0.4290 Ang. The
    sections are copies: a caller that edits one (hypertune_params_file
    turns obj_rblur off) must not edit TBL_PARAMS, which later phases run."""
    base = copy.deepcopy(TBL_PARAMS)
    return {
        "init_params": {
            "probe_illum_type": "electron", "probe_kv": 80.0, "probe_conv_angle": 24.9,
            "probe_defocus": 0.0, "probe_c3": 0.0, "probe_c5": 0.0,
            "beam_kev": None, "probe_dRn": None, "probe_Rn": None, "probe_D_H": None,
            "probe_D_FZP": None, "probe_Ls": None,
            "meas_Npix": NPIX, "pos_N_scans": N_SCANS, "pos_N_scan_slow": N_SIDE,
            "pos_N_scan_fast": N_SIDE, "pos_scan_step_size": STEP_PX * SIM_DX,
            "meas_calibration": {"mode": "fitRBF", "value": None, "thresh": 0.5},
            "probe_pmode_max": PMODE, "probe_pmode_init_pows": [0.02],
            "obj_omode_max": 1, "obj_omode_init_occu": {"occu_type": "uniform", "init_occu": None},
            "obj_Nlayer": NZ, "obj_slice_thickness": 2.0,
            "meas_permute": None, "meas_reshape": None, "meas_flipT": [1, 0, 0],
            "meas_crop": None, "meas_pad": None, "meas_resample": None,
            "meas_add_source_size": None, "meas_add_detector_blur": None,
            "meas_remove_neg_values": {"mode": "clip_neg", "value": None, "force": False},
            "meas_normalization": {"mode": "max_at_one", "value": None},
            "meas_add_poisson_noise": None, "meas_export": None,
            "probe_permute": None, "pos_scan_flipT": None, "pos_scan_affine": None,
            "pos_scan_rand_std": 0.15,
            "meas_source": "file",
            "meas_params": {"path": meas_path, "key": None, "shape": None, "offset": None,
                            "gap": None},
            "probe_source": "simu", "probe_params": None, "pos_source": "simu",
            "pos_params": None, "obj_source": "simu", "obj_params": None,
            "tilt_source": "simu", "tilt_params": {"tilt_type": "all", "init_tilts": [[0.0, 0.0]]},
        },
        "model_params": {
            "obj_preblur_std": None, "detector_blur_std": None,
            "optimizer_params": {"name": "Adam", "configs": {}, "load_state": None},
            "update_params": base["model_params"]["update_params"],
            "fwd_fused": None, "fwd_remat": False, "compute_dtype": "float32",
            "matmul_dtype": None, "meas_dtype": "float32",
        },
        "loss_params": {
            **base["loss_params"],
            "loss_poissn": {"state": False, "weight": 1.0, "dp_pow": 1.0, "eps": 1e-06},
            "loss_pacbed": {"state": False, "weight": 0.5, "dp_pow": 0.2},
            "loss_simlar": {"state": False, "weight": 0.1, "obj_type": "both",
                            "scale_factor": [1.0, 1.0], "blur_std": 1.0},
        },
        "constraint_params": {
            **base["constraint_params"],
            "probe_mask_k": {"freq": None, "radius": 0.22, "width": 0.05, "power_thresh": 0.95},
            "kr_filter": {"freq": None, "obj_type": "both", "radius": 0.15, "width": 0.05},
            "kz_filter": {"freq": None, "obj_type": "both", "beta": 1.0, "alpha": 1.0},
            "complex_ratio": {"freq": None, "obj_type": "both", "alpha1": 1.0, "alpha2": 0.0},
            "mirrored_amp": {"freq": None, "relax": 0.1, "scale": 0.03, "power": 4.0},
            "tilt_smooth": {"freq": None, "std": 2.0},
        },
        "recon_params": {
            "NITER": NITER,
            "INDICES_MODE": {"mode": "full", "subscan_slow": None, "subscan_fast": None},
            "BATCH_SIZE": {"size": BATCH, "grad_accumulation": 1},
            "GROUP_MODE": "random", "GROUP_MODE_SEED": SEED, "SAVE_ITERS": 10,
            "shard_measurements": True, "shard_canvas": False, "output_dir": "output/tBL_WSe2/",
            "recon_dir_affixes": ["default"], "prefix_time": "%Y%m%d", "prefix": "",
            "postfix": "", "save_result": ["model", "objp", "probe"],
            "result_modes": {"obj_dim": [2, 3], "FOV": ["crop"], "bit": ["8"]},
            "selected_figs": ["loss", "forward", "probe_r_amp", "pos"],
            "copy_params": True, "if_quiet": False,
        },
        "hypertune_params": {
            "if_hypertune": False, "collate_results": True, "append_params": True,
            "sampler_params": {"name": "TPESampler", "configs": {}},
            "pruner_params": {"name": "HyperbandPruner", "configs": {}},
            "n_trials": 50, "timeout": None, "error_metric": "loss",
            "storage_path": "hypertune.db", "study_name": "ptyrad_hypertune",
            "tune_params": {
                "optimizer": _tune(False, "cat", choices=["Adam", "AdamW", "RMSprop", "SGD"],
                                   optim_configs={}),
                "batch_size": _tune(False, "int", low=16, high=512, log=True),
                "plr": _tune(False, "cat", choices=[1e-2, 1e-3, 1e-4]),
                **{k: _tune(False, "float", low=1e-4, high=1e-2, log=True)
                   for k in ("oalr", "oplr", "slr", "tlr", "dzlr")},
                "dx": _tune(False, "float", low=0.14, high=0.16, step=0.001),
                "pmode_max": _tune(False, "int", low=1, high=8, step=1),
                "conv_angle": _tune(False, "float", low=24, high=26, step=1),
                "defocus": _tune(False, "float", low=-50, high=50, step=0.1),
                "c3": _tune(False, "float", low=4000, high=10000, step=100),
                "c5": _tune(False, "float", low=50000, high=100000, step=5000),
                "Nlayer": _tune(False, "int", low=1, high=8, step=1),
                "dz": _tune(False, "float", low=4, high=8, step=0.5),
                "scale": _tune(True, "float", low=0.8, high=1.2, step=0.02),
                "asymmetry": _tune(False, "float", low=-0.2, high=0.2, step=0.05),
                "rotation": _tune(True, "float", low=-4, high=4, step=0.5),
                "shear": _tune(False, "float", low=-4, high=4, step=0.5),
                "tilt_y": _tune(False, "float", low=-5, high=5, step=0.5),
                "tilt_x": _tune(False, "float", low=-5, high=5, step=0.5),
            },
        },
        "params_path": None,
    }


def optional_packages() -> dict:
    """Which of the optional host packages import on this machine."""
    found = {}
    for name in OPTIONAL_PACKAGES:
        try:
            importlib.import_module(name)
            found[name] = True
        except ImportError:
            found[name] = False
    return found


def write_raw(path: str, meas: np.ndarray) -> float:
    """Write (N, H, W) float32 patterns as an EMPAD .raw (RAW_GAP zero bytes
    after each frame), flipped along ky so that meas_flipT [1, 0, 0]
    restores them; returns the seconds."""
    t0 = time.perf_counter()
    n = meas.shape[0]
    frame = meas[0].nbytes
    buf = np.zeros((n, frame + RAW_GAP), np.uint8)
    buf[:, :frame] = np.ascontiguousarray(np.flip(meas, axis=1)).view(np.uint8).reshape(n, frame)
    buf.tofile(path)
    return time.perf_counter() - t0


class StageTimer:
    """Wall seconds of each Initializer stage (INIT_STAGES) and of the CBED
    fit, by wrapping them on the class for the duration of a ``with``."""

    def __init__(self):
        self.seconds: dict = {}

    def _wrap(self, owner, name: str):
        fn = getattr(owner, name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
        return fn, timed

    def __enter__(self):
        import ptyrad_tpu_torch.initialization as I

        self._saved = []
        for owner, names in ((I.Initializer, INIT_STAGES), (I, ("fit_cbed_pattern",))):
            for name in names:
                fn, timed = self._wrap(owner, name)
                self._saved.append((owner, name, fn))
                setattr(owner, name, timed)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        return False


def params_file_path(dev, card: str, meas: np.ndarray, tmp: str) -> tuple[dict, str]:
    """The tBL run from its params file through the normal entry point:
    the main phase's patterns written as an EMPAD .raw in ``tmp`` and the
    params as a .json (no package needed), then load_params ->
    PtyRADSolver(params, init_rng=RandomState(SEED)) -> run(), validated
    where pydantic imports. Then a .npy of the same patterns with a dx
    calibration, no jitter and no normalization, whose measurements must
    equal the patterns bit for bit. Returns the run's launch counts and the
    .raw's path (the cli phase reads it again)."""
    from ptyrad_tpu_torch import load as L
    from ptyrad_tpu_torch import native
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver
    from ptyrad_tpu_torch.initialization import Initializer

    packages = optional_packages()
    emit({"phase": "params_file_packages", "imports": packages})
    raw_path, json_path = f"{tmp}/tbl.raw", f"{tmp}/tbl.json"
    write_s = write_raw(raw_path, meas)
    d = tbl_params_file(raw_path)
    d["recon_params"]["NITER"] = SIDE_NITER
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(d, f)
    params = L.load_params(json_path, validate=packages["pydantic"])
    L.LAST_RAW_READ.clear()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()  # the main phase's patterns, still held
    t0 = time.perf_counter()
    with StageTimer() as timer:
        solver = PtyRADSolver(params, init_rng=np.random.RandomState(SEED), device=dev,
                              verbose=True)
    init_s = time.perf_counter() - t0
    raw_read = dict(L.LAST_RAW_READ)
    t1 = time.perf_counter()
    launches = drive(solver)
    run_s = time.perf_counter() - t1

    iv = solver.init_variables
    losses = [v for _, v in solver.history.loss_iters]
    times = solver.history.iter_times
    mean_max = float(iv["measurements"].mean(0).max())
    out = {
        "phase": "params_file", "card": card, "validated": packages["pydantic"],
        "raw_bytes": os.path.getsize(raw_path), "write_raw_s": write_s,
        "raw_reader": raw_read.get("reader"), "native_build_error": native.BUILD_ERROR,
        "load_raw_s": raw_read.get("seconds"),
        "load_raw_gb_per_s": raw_read["bytes"] / raw_read["seconds"] / 1e9,
        "init_s": init_s, "init_stage_s": timer.seconds,
        "measurements": [list(iv["measurements"].shape), str(iv["measurements"].dtype)],
        "mean_pattern_max": mean_max, "fitRBF": iv["fitRBF"], "dx": iv["dx"],
        "dx_rel_err": iv["dx"] / SIM_DX - 1.0,
        "probe": list(solver.params.probe.shape), "obja": list(solver.params.obja.shape),
        "iterations": len(losses), "losses": losses, "iter_s": times,
        "patterns_per_s": [N_SCANS / t for t in times], "run_s": run_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "resident_before_gb": resident / 1e9, "launches": launches,
    }
    emit(out)
    require(raw_read.get("reader") == "native",
            f"the .raw was not read by the native reader: {raw_read}, "
            f"build error {native.BUILD_ERROR}")
    require(iv["measurements"].shape == (N_SCANS, NPIX, NPIX)
            and iv["measurements"].dtype == np.float32,
            f"measurements {iv['measurements'].shape} {iv['measurements'].dtype}")
    require(abs(mean_max - 1.0) <= 1e-6, f"max_at_one left the mean pattern's max at {mean_max}")
    require(tuple(solver.params.probe.shape) == (PMODE, NPIX, NPIX),
            f"probe {tuple(solver.params.probe.shape)}")
    require(tuple(solver.params.obja.shape[:2]) == (1, NZ), f"object {solver.params.obja.shape}")
    require(abs(iv["dx"] / SIM_DX - 1.0) <= 0.05, f"fitted dx {iv['dx']} vs {SIM_DX}")
    require(len(losses) == SIDE_NITER and all(np.isfinite(losses)), f"loss not finite: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for name in TBL_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the params_file path")
    for name in ("B4a dp_fwd", "B4b dp_bwd") + CHAIN_KERNELS:
        require(launches[name] == 0, f"kernel {name} was launched on the params_file path")
    del solver, iv
    torch.cuda.empty_cache()

    npy_path = f"{tmp}/tbl.npy"
    np.save(npy_path, meas)
    ip = tbl_params_file(npy_path)["init_params"]
    ip.update(meas_flipT=None, pos_scan_rand_std=None,
              meas_calibration={"mode": "dx", "value": SIM_DX, "thresh": 0.5},
              meas_normalization={"mode": "divide_const", "value": 1.0})
    t2 = time.perf_counter()
    npy_init = Initializer(ip, verbose=False, rng=np.random.RandomState(SEED)).init_all()
    got = npy_init.init_variables["measurements"]
    same = got.dtype == meas.dtype and got.shape == meas.shape and np.array_equal(got, meas)
    emit({"phase": "params_file_npy", "init_s": time.perf_counter() - t2,
          "bit_exact": bool(same), "dx": npy_init.init_variables["dx"]})
    require(same, "the .npy round trip changed the measurements")
    os.remove(npy_path)
    return launches, raw_path


# resume gates (see resume_path): the first batch of the resumed iteration,
# its first RESUME_BATCHES batches, and the whole iteration; 0: bit for bit
# (they were 1e-6, 1e-5 and 5e-3 while B3b added with atomics)
RESUME_FIRST_RTOL = 0.0
RESUME_BATCHES, RESUME_BATCHES_RTOL = 8, 0.0
RESUME_ITER_RTOL = 0.0


def resume_path(dev, card: str, init: dict, main_losses: list, tmp: str, record: RunRecord):
    """The tBL run at full width on the main phase's data, stopped and
    resumed in process: 3 iterations whose callback takes make_save_dict's
    checkpoint of iteration 2 (with the optimizer state) from the live run;
    then a second solver from that dict alone (resume_from) runs iteration
    3 through recon_loop(start_niter=3), batch by batch beside the
    uninterrupted run's iteration 3. Every kernel of the path sums in a
    fixed order (B2 in batch order, B3b over modes and samples), so the
    first batch's loss (before any step of iteration 3: the restored
    parameters), the first 8 batches' (the restored optimizer state's
    first steps) and the iteration's are held equal bit for bit (rtol 0;
    Adam turns a difference in the last bits of a gradient of rounding
    size into a step of lr, so any difference would show). A third solver
    from the checkpoint without its optimizer state must miss the last two
    gates: a resume that drops the state fails them. Where h5py
    imports, the resume again through model_iter0002.hdf5 and load_ptyrad.
    ``record`` takes the uninterrupted run's per-batch terms and final
    tensors (the determinism phase's second run of the main path). Returns
    the launch counts and the uninterrupted solver."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver
    from ptyrad_tpu_torch.load import load_ptyrad
    from ptyrad_tpu_torch.save import make_save_dict, save_dict_to_hdf5

    params = copy.deepcopy(TBL_PARAMS)
    params["recon_params"]["save_result"] = ["model", "optim_state"]
    solver = PtyRADSolver(params, init_variables=init, device=dev, verbose=True)
    taken = {}

    def callback(niter, cur_params, history, optimizer=None):
        record(niter, cur_params, history)
        if niter == 2:
            t0 = time.perf_counter()
            taken["ckpt"] = make_save_dict("", cur_params, solver.buffers, solver.geom, params,
                                           optimizer, history, niter, solver.indices,
                                           solver.lr_dict, solver.start_dict)
            taken["make_save_dict_s"] = time.perf_counter() - t0

    _, launches = counted(lambda: solver.run(callback=callback))
    record.finish(solver)
    losses = [v for _, v in solver.history.loss_iters]
    ref = batch_totals(solver.history)
    ckpt = taken["ckpt"]
    routes = {"dict": ckpt}
    write_s = None
    if optional_packages()["h5py"]:
        path = f"{tmp}/model_iter0002.hdf5"
        t0 = time.perf_counter()
        save_dict_to_hdf5(ckpt, path)
        write_s = time.perf_counter() - t0
        routes["file"] = load_ptyrad(path)
    routes["dict, fresh optimizer"] = ckpt
    resumed = {}
    for route, c in routes.items():
        other = resume_from(c, params, init, dev, verbose=True)
        if route.endswith("fresh optimizer"):
            other.optimizer.state.clear()
        history, counts = counted(lambda: resume_step(other, 3, verbose=True))
        launches = add_counts(launches, counts)
        got = batch_totals(history)
        resumed[route] = {
            "iter3": history.loss_iters[-1][1],
            "rel_diff": abs(history.loss_iters[-1][1] - losses[2]) / abs(losses[2]),
            "first_batch_rel_diff": float(abs(got[0] - ref[0]) / abs(ref[0])),
            "batches_rel_diff_max": {n: float(np.max(np.abs(got[:n] - ref[:n]) / np.abs(ref[:n])))
                                     for n in (RESUME_BATCHES, 64, 512)},
        }
        del other
    out = {
        "phase": "resume", "card": card, "n_patterns": N_SCANS, "batch": BATCH,
        "routes": sorted(routes), "losses": losses, "resumed": resumed,
        "main_losses": main_losses,
        "rel_diff_to_main": [abs(a - b) / abs(b) for a, b in zip(losses, main_losses)],
        "make_save_dict_s": taken["make_save_dict_s"],
        "write_s": write_s if write_s is not None else "not measured: h5py does not import",
        "optim_state_groups": [g["name"] for g in solver.optimizer.param_groups],
        "launches": launches,
    }
    emit(out)
    require(len(losses) == NITER and all(np.isfinite(losses)), f"resume: loss not finite: {losses}")
    require(ckpt["optim_state_dict"] is not None and ckpt["niter"] == 2,
            "resume: the checkpoint of iteration 2 holds no optimizer state")
    for route, r in resumed.items():
        require(r["first_batch_rel_diff"] <= RESUME_FIRST_RTOL,
                f"resume ({route}): the first batch of iteration 3 differs by "
                f"{r['first_batch_rel_diff']} > {RESUME_FIRST_RTOL}")
        gates = ((r["batches_rel_diff_max"][RESUME_BATCHES], RESUME_BATCHES_RTOL,
                  f"the first {RESUME_BATCHES} batches"), (r["rel_diff"], RESUME_ITER_RTOL,
                                                            "iteration 3"))
        for diff, tol, what in gates:
            if route.endswith("fresh optimizer"):
                require(diff > tol, f"resume without the optimizer state: {what} within "
                                    f"{tol} ({diff}); the gate cannot tell")
            else:
                require(diff <= tol, f"resume ({route}): {what} differ from the "
                                     f"uninterrupted run's by {diff} > {tol}")
    for name in TBL_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the resume path")
    return launches, solver


CLI_NITER, CLI_SAVE_ITERS = 2, 1
CLI_SAVES = list(range(CLI_SAVE_ITERS, CLI_NITER + 1, CLI_SAVE_ITERS))
_ITER_LINE = re.compile(r"Iter: (\d+), Total Loss: (\S+?),.* in ([0-9.]+) sec")
_SAVE_LINE = re.compile(r"Saved the results of iteration (\d+) to .* in ([0-9.]+) sec")


def _run_cli(args: list, timeout_s: float) -> tuple[int, list, float]:
    """``python -m ptyrad_tpu_torch <args>`` from the repository root, its
    output read line by line as it comes: (exit code, [(seconds since the
    start, line)], seconds)."""
    proc = subprocess.Popen([sys.executable, "-m", "ptyrad_tpu_torch", *args],
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env={**os.environ, "PYTHONUNBUFFERED": "1"})
    timer = threading.Timer(timeout_s, proc.kill)
    t0 = time.perf_counter()
    timer.start()
    try:
        lines = [(time.perf_counter() - t0, line.rstrip("\n")) for line in proc.stdout]
        rc = proc.wait()
    finally:
        timer.cancel()
        proc.stdout.close()
    return rc, lines, time.perf_counter() - t0


def _tail(lines: list, n: int = 30) -> str:
    return "\n".join(line for _, line in lines[-n:])


def cli_path(card: str, tmp: str, raw_path: str, named_like) -> None:
    """The tBL run as a user starts it: ``python -m ptyrad_tpu_torch run
    --params_path`` in a subprocess, on the params_file phase's .raw, with
    its .json (``tmp``/tbl_cli.json, which cli_commands reads) set to
    CLI_NITER iterations saved every CLI_SAVE_ITERS into a temporary
    output_dir (objp, obja and probe; model and optim_state where h5py
    imports). The kernels built for this process serve the subprocess
    unbuilt. ``named_like``: a solver of the same shapes, to name the output
    folder as make_output_folder does."""
    from PIL import Image

    from ptyrad_tpu_torch.ops import _build
    from ptyrad_tpu_torch.save import make_output_folder

    h5py = optional_packages()["h5py"]
    d = tbl_params_file(raw_path)
    out_dir = f"{tmp}/cli_out"
    d["recon_params"].update(
        NITER=CLI_NITER, SAVE_ITERS=CLI_SAVE_ITERS, output_dir=out_dir,
        save_result=["objp", "obja", "probe"] + (["model", "optim_state"] if h5py else []))
    json_path = f"{tmp}/tbl_cli.json"
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(d, f)

    def folder_name():
        return os.path.basename(make_output_folder(
            out_dir, np.arange(N_SCANS), d, named_like.params, named_like.geom, make_dir=False))

    build_files = {p.name: p.stat().st_mtime_ns for p in _build.BUILD_DIR.iterdir()}
    names = {folder_name()}
    rc, lines, seconds = _run_cli(["run", "--params_path", json_path], 600)
    names.add(folder_name())
    text = [line for _, line in lines]
    require(rc == 0, f"cli run exited {rc}:\n{_tail(lines)}")
    iters = [(t, _ITER_LINE.search(line)) for t, line in lines if _ITER_LINE.search(line)]
    saves = [_SAVE_LINE.search(line) for line in text if _SAVE_LINE.search(line)]
    start_s = next(t for t, line in lines if "Starting reconstruction" in line)
    losses = [float(m.group(2)) for _, m in iters]
    iter_s = [float(m.group(3)) for _, m in iters]
    folders = os.listdir(out_dir)
    folder = os.path.join(out_dir, folders[0]) if len(folders) == 1 else None
    files = sorted(os.listdir(folder)) if folder else []
    shapes = {}
    for name in files:
        if name.endswith(".tif"):
            with Image.open(os.path.join(folder, name)) as im:
                shapes[name] = [getattr(im, "n_frames", 1), im.size[1], im.size[0]]
    out = {
        "phase": "cli", "card": card, "rc": rc, "seconds": seconds,
        "seconds_to_training": start_s, "seconds_to_first_iteration_end": iters[0][0],
        "iterations": len(losses), "losses": losses, "iter_s": iter_s,
        "patterns_per_s": [N_SCANS / t for t in iter_s],
        "saves": [[int(m.group(1)), float(m.group(2))] for m in saves],
        "folder": folders, "files": files, "tif_shapes": shapes,
        "rebuilt": build_files != {p.name: p.stat().st_mtime_ns
                                   for p in _build.BUILD_DIR.iterdir()},
    }
    emit(out)
    require(len(folders) == 1 and folders[0] in names,
            f"cli output folders {folders}, expected one of {sorted(names)}")
    date = folders[0].split("_")[0]
    require({"tbl_cli.json", f"{date}_ptyrad_tpu_torch_log.txt"} <= set(files),
            f"cli: no params copy or log in {files}")
    require(not out["rebuilt"], "cli: the subprocess rebuilt or replaced the kernel library")
    require(len(losses) == CLI_NITER and all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"cli: losses {losses}")
    require([int(m.group(1)) for m in saves] == CLI_SAVES,
            f"cli: saves at iterations {[m.group(1) for m in saves]}, expected {CLI_SAVES} "
            "once each")
    for it in CLI_SAVES:
        zsum, zstack = f"objp_zsum_crop_08bit_iter{it:04d}.tif", f"objp_zstack_crop_08bit_iter{it:04d}.tif"
        probe = f"probe_amp_08bit_iter{it:04d}.tif"
        require(shapes.get(probe) == [1, NPIX, PMODE * NPIX], f"cli: {probe} {shapes.get(probe)}")
        require(zsum in shapes and zstack in shapes and shapes[zstack][0] == NZ
                and shapes[zstack][1:] == shapes[zsum][1:]
                and all(0.9 * (N_SIDE - 1) * STEP_PX <= v <= 1.1 * (N_SIDE - 1) * STEP_PX + 2
                        for v in shapes[zsum][1:]),
                f"cli: object images {shapes.get(zsum)} {shapes.get(zstack)}")
        if h5py:
            require(f"model_iter{it:04d}.hdf5" in files, f"cli: no checkpoint of iteration {it}")
    log = open(os.path.join(folder, f"{date}_ptyrad_tpu_torch_log.txt")).read()
    require(f"Iter: {CLI_NITER}, Total Loss" in log and "### System information ###" in log,
            "cli: the log file misses the run")


def cli_commands(card: str, tmp: str, raw_path: str) -> None:
    """validate-params (on cli_path's .json and on a copy with a bad key),
    check-gpu and print-system-info, all at once: the exit codes, and the
    card named by the last two."""
    json_path = f"{tmp}/tbl_cli.json"
    with open(json_path, encoding="utf-8") as f:
        d = json.load(f)
    bad_path = f"{tmp}/tbl_bad.json"
    with open(bad_path, "w", encoding="utf-8") as f:
        json.dump({**d, "init_params": {**d["init_params"], "bogus_key": 1}}, f)
    commands = {"validate-params": ["validate-params", "--params_path", json_path],
                "validate-params (bad key)": ["validate-params", "--params_path", bad_path],
                "check-gpu": ["check-gpu"], "print-system-info": ["print-system-info"]}
    with concurrent.futures.ThreadPoolExecutor(len(commands)) as pool:
        futures = {k: pool.submit(_run_cli, args, 180) for k, args in commands.items()}
        results = {k: f.result() for k, f in futures.items()}
    emit({"phase": "cli_commands",
          **{k: {"rc": rc, "seconds": sec, "tail": [line for _, line in lines[-3:]]}
             for k, (rc, lines, sec) in results.items()}})
    expected = {"validate-params": 0, "validate-params (bad key)": 1, "check-gpu": 0,
                "print-system-info": 0}
    for k, want in expected.items():
        require(results[k][0] == want, f"cli {k} exited {results[k][0]}, expected {want}:\n"
                                       f"{_tail(results[k][1])}")
    gpu_name = torch.cuda.get_device_name(0)
    for k in ("check-gpu", "print-system-info"):
        require(any(gpu_name in line for _, line in results[k][1]),
                f"cli {k} does not name the card {gpu_name}")


# -- the figures and hypertune phases (A9) ---------------------------------------

FIG_NITER = 2
FIGS = ["loss", "forward", "probe_r_amp", "pos", "group"]
HT_TRIALS, HT_NITER = 4, SIDE_NITER
HT_CLI_NITER = 2
HT_MEM_RTOL = 0.10  # the last trial's peak device memory against the first's


def figures_path(dev, card: str, tmp: str, raw_path: str) -> dict:
    """The tBL run from its params file through run_reconstruction, 2
    iterations saved every iteration with selected_figs [loss, forward,
    probe_r_amp, pos, group]: each plot_summary's seconds (the "forward"
    figure's forward() is B4a on a batch of 2). Gate 1: forward_panels on
    the first 2 indices is finite and equal to the plain multislice_dp on
    the same patches within 1e-4 of its largest value. Gate 2, where
    matplotlib imports: every expected PNG exists. Returns the run's launch
    counts."""
    import ptyrad_tpu_torch.engine.workflow as W
    from ptyrad_tpu_torch import load as L
    from ptyrad_tpu_torch.models import (compute_propagators, forward_route, get_obj_patches,
                                         get_probes, multislice_dp)
    from ptyrad_tpu_torch.visualization import forward_panels

    t0 = time.perf_counter()
    drawing = optional_packages()["matplotlib"]
    d = tbl_params_file(raw_path)
    d["recon_params"].update(NITER=FIG_NITER, SAVE_ITERS=1, selected_figs=FIGS,
                             output_dir=f"{tmp}/fig_out", save_result=["objp"])
    json_path = f"{tmp}/tbl_figs.json"
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(d, f)
    params = L.load_params(json_path, validate=optional_packages()["pydantic"])
    seconds = []
    plot = W.plot_summary

    def timed(*args, **kwargs):
        t1 = time.perf_counter()
        try:
            return plot(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t1)

    W.plot_summary = timed
    try:
        solver, launches = counted(lambda: W.run_reconstruction(
            params, device=dev, init_rng=np.random.RandomState(SEED)))
    finally:
        W.plot_summary = plot
    files = sorted(os.listdir(solver.output_path))
    idx = torch.as_tensor(np.asarray(solver.indices)[:2], device=dev)
    route = forward_route(solver.params, solver.geom, idx)
    panels = forward_panels(solver.params, solver.buffers, solver.geom, idx.cpu().numpy())
    with torch.no_grad():
        obja_p, objp_p = get_obj_patches(solver.params, solver.buffers, solver.geom, idx)
        ref = multislice_dp(obja_p, objp_p, get_probes(solver.params, solver.geom, idx),
                            compute_propagators(solver.params, solver.buffers, solver.geom, idx),
                            solver.buffers.omode_occu, solver.geom.eps).cpu().numpy()
    dp = panels["model_dp"]
    err = float(np.abs(dp - ref).max())
    tol = 1e-4 * float(np.abs(ref).max())
    want = {"summary_grouping.png"} | {f"summary_{f}_iter{i:04d}.png"
                                       for f in FIGS[:-1] for i in range(1, FIG_NITER + 1)}
    losses = [v for _, v in solver.history.loss_iters]
    emit({"phase": "figures", "card": card, "seconds": time.perf_counter() - t0,
          "matplotlib": drawing, "route": route, "plot_summary_s": seconds, "losses": losses, "pngs": [f for f in files
                                                                  if f.endswith(".png")],
          "panel_shapes": {k: list(v.shape) for k, v in panels.items()},
          "max_abs_err": err, "tolerance": tol, "launches": launches})
    require(route == "fused", f"figures: forward() of 2 patterns took the {route} route")
    require(all(np.isfinite(v).all() for v in panels.values()), "figures: non-finite panels")
    require(dp.shape == (2, NPIX, NPIX), f"figures: model_dp {dp.shape}")
    require(err <= tol, f"figures: forward_panels differs from the plain chain: {err} > {tol}")
    require(len(seconds) == FIG_NITER, f"figures: plot_summary ran {len(seconds)} times")
    require(launches["B4a dp_fwd"] == FIG_NITER,
            f"figures: {launches['B4a dp_fwd']} B4a launches, expected one per save")
    for name in TBL_KERNELS:
        require(launches[name] > 0, f"figures: kernel {name} was not launched")
    if drawing:
        require(want <= set(files), f"figures: missing {sorted(want - set(files))}")
    else:
        print("figures: drawing skipped, matplotlib missing", flush=True)
    del solver
    torch.cuda.empty_cache()
    return launches


def hypertune_params_file(raw_path: str, tmp: str, n_trials: int, niter: int) -> dict:
    """demo/params/tBL_WSe2_hypertune.yml on the params_file phase's .raw:
    tbl_params_file with one slice of 12 Ang, the demo's constraints (no
    obj_rblur), quiet trials collating objp and the loss and forward
    figures into one folder, and its study: scale and rotation,
    TPESampler(seed 0, 2 startup trials, the demo's multivariate, group and
    constant_liar), HyperbandPruner(min_resource 1, reduction_factor 2, 2
    startup trials), a sqlite file in ``tmp``."""
    d = tbl_params_file(raw_path)
    d["init_params"].update(obj_Nlayer=1, obj_slice_thickness=12.0)
    d["constraint_params"]["obj_rblur"]["freq"] = None
    d["recon_params"].update(
        NITER=niter, SAVE_ITERS=None, output_dir=f"{tmp}/ht_out", recon_dir_affixes=[],
        save_result=["objp"], selected_figs=["loss", "forward"], if_quiet=True,
        result_modes={"obj_dim": [2, 3], "FOV": ["crop"], "bit": ["8"]})
    d["hypertune_params"].update(
        if_hypertune=True, collate_results=True, n_trials=n_trials,
        sampler_params={"name": "TPESampler",
                        "configs": {"seed": 0, "n_startup_trials": 2, "multivariate": True,
                                    "group": True, "constant_liar": True}},
        pruner_params={"name": "HyperbandPruner",
                       "configs": {"min_resource": 1, "reduction_factor": 2,
                                   "n_startup_trials": 2}},
        storage_path=f"sqlite:///{tmp}/hypertune.sqlite3", study_name="tBL_WSe2")
    return d


class TrialRecorder:
    """Wraps hypertune_objective for the duration of a ``with``: each
    trial's seconds, peak device memory (the peak reset at its start), the
    memory allocated before it, its params, crop_pos after its re-init, and
    the exception of a trial that raised anything but TrialPruned."""

    def __init__(self):
        self.rows = []

    def __enter__(self):
        import ptyrad_tpu_torch.engine.hypertune as H

        self._module, self._fn = H, H.hypertune_objective

        def recorded(trial, params, init, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            row = {"number": trial.number, "before_gb": torch.cuda.memory_allocated() / 1e9}
            t0 = time.perf_counter()
            try:
                return self._fn(trial, params, init, **kwargs)
            except Exception as e:
                if "Pruned" not in type(e).__name__:
                    row["exception"] = f"{type(e).__name__}: {e}"
                raise
            finally:
                torch.cuda.synchronize()
                row.update(seconds=time.perf_counter() - t0,
                           peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                           params=dict(trial.params),
                           crop_pos=np.array(init.init_variables["crop_pos"]))
                self.rows.append(row)

        H.hypertune_objective = recorded
        return self

    def __exit__(self, *exc):
        self._module.hypertune_objective = self._fn
        return False


def hypertune_path(dev, card: str, tmp: str, raw_path: str) -> dict:
    """run_hypertune in process on the .raw at full width (16,384 patterns
    of 128², 6 probe modes, batch 32, one slice): 4 trials of 2 iterations
    (hypertune_params_file), trials 3 and 4 past the TPE startup and
    consulted by the pruner. Gates: no trial FAILED (each failed trial's
    exception printed), every trial COMPLETE or PRUNED; each trial's
    crop_pos differs from the previous one's (the staged re-init); every
    completed value finite; the sqlite file holds the 4 trials with a report
    per iteration run; the collated objp files carry the
    _error_<value>_tNNNN names; B3a/B3b launched at one slice; the last
    trial's peak memory within 10% of the first's. Returns the launch counts."""
    from ptyrad_tpu_torch import load as L
    from ptyrad_tpu_torch.engine import tuner
    from ptyrad_tpu_torch.engine.hypertune import run_hypertune

    d = hypertune_params_file(raw_path, tmp, HT_TRIALS, HT_NITER)
    json_path = f"{tmp}/tbl_hypertune.json"
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(d, f)
    params = L.load_params(json_path, validate=optional_packages()["pydantic"])
    t0 = time.perf_counter()
    with TrialRecorder() as rec:
        study, launches = counted(lambda: run_hypertune(
            params, device=dev, init_rng=np.random.RandomState(SEED), use_optuna=False))
    seconds = time.perf_counter() - t0
    trials = tuner.create_study("tBL_WSe2", d["hypertune_params"]["storage_path"]).trials
    out_dir = d["recon_params"]["output_dir"]
    files = sorted(os.listdir(out_dir))
    best = study.best_trial
    emit({"phase": "hypertune", "card": card, "seconds": seconds,
          "trials": [{"number": t["number"], "state": t["state"], "value": t["value"],
                      "params": t["params"], "reports": t["reports"]} for t in trials],
          "trial_s": [r["seconds"] for r in rec.rows],
          "trial_peak_gb": [r["peak_gb"] for r in rec.rows],
          "allocated_before_trial_gb": [r["before_gb"] for r in rec.rows],
          "best": None if best is None else {k: best[k] for k in ("number", "value", "params")},
          "files": files, "launches": launches})
    for r in rec.rows:
        if "exception" in r:
            print(f"hypertune: trial {r['number']} raised {r['exception']}", flush=True)
    states = [t["state"] for t in trials]
    require(len(trials) == HT_TRIALS and len(rec.rows) == HT_TRIALS,
            f"hypertune: {len(trials)} trials in the study, {len(rec.rows)} run")
    require(set(states) <= {"COMPLETE", "PRUNED"} and "COMPLETE" in states,
            f"hypertune: trial states {states}")
    # init_pos runs again in every trial (scale and rotation are tuned) and
    # draws a new jitter (pos_scan_rand_std), so even a repeated affine moves
    for prev, cur in zip(rec.rows, rec.rows[1:]):
        require(not np.array_equal(prev["crop_pos"], cur["crop_pos"]),
                f"hypertune: trial {cur['number']} kept the positions of trial "
                f"{prev['number']}: the staged re-init did not run")
    for t in trials:
        niter = HT_NITER if t["state"] == "COMPLETE" else len(t["reports"])
        require(t["value"] is not None and np.isfinite(t["value"]),
                f"hypertune: trial {t['number']} value {t['value']}")
        require(sorted(t["reports"], key=int) == [str(i) for i in range(1, niter + 1)],
                f"hypertune: trial {t['number']} reports {t['reports']}")
        stamp = f"_error_{t['value']:.5f}_t{t['number']:04d}_scale_"
        require(any(f.startswith("objp_") and stamp in f for f in files),
                f"hypertune: no objp file named with {stamp} in {files}")
    for name in ("B3a loss_sums_fwd (nz=1)", "B3b loss_sums_bwd (nz=1)", "B4a dp_fwd"):
        require(launches[name] > 0, f"hypertune: kernel {name} was not launched")
    peaks = [r["peak_gb"] for r in rec.rows]
    require(abs(peaks[-1] - peaks[0]) <= HT_MEM_RTOL * peaks[0],
            f"hypertune: peak memory of the trials {peaks}")
    torch.cuda.empty_cache()
    return launches


def hypertune_cli_path(card: str, tmp: str, raw_path: str) -> None:
    """A second worker on the same study: ``python -m ptyrad_tpu_torch run
    --params_path <json> --jobid 1`` with 1 trial of 2 iterations on the
    hypertune phase's sqlite file, as demo/scripts/LoopSubmit.sh starts
    workers. Gates: exit 0, the study holds 5 trials, the worker's log file
    carries its job id, the kernel library neither rebuilt nor replaced."""
    from ptyrad_tpu_torch.engine import tuner
    from ptyrad_tpu_torch.ops import _build

    d = hypertune_params_file(raw_path, tmp, 1, HT_CLI_NITER)
    json_path = f"{tmp}/tbl_hypertune_cli.json"
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(d, f)
    build_files = {p.name: p.stat().st_mtime_ns for p in _build.BUILD_DIR.iterdir()}
    rc, lines, seconds = _run_cli(["run", "--params_path", json_path, "--jobid", "1"], 600)
    trials = tuner.create_study("tBL_WSe2", d["hypertune_params"]["storage_path"]).trials
    out_dir = d["recon_params"]["output_dir"]
    logs = [f for f in os.listdir(out_dir) if f.endswith("_1_ptyrad_tpu_torch_log.txt")]
    out = {"phase": "hypertune_cli", "card": card, "rc": rc, "seconds": seconds,
           "trials": [[t["number"], t["state"], t["value"]] for t in trials], "logs": logs,
           "rebuilt": build_files != {p.name: p.stat().st_mtime_ns
                                      for p in _build.BUILD_DIR.iterdir()},
           "tail": [line for _, line in lines[-4:]]}
    emit(out)
    require(rc == 0, f"hypertune_cli exited {rc}:\n{_tail(lines)}")
    require([t["number"] for t in trials] == list(range(HT_TRIALS + 1)),
            f"hypertune_cli: the study holds trials {[t['number'] for t in trials]}")
    require(trials[-1]["state"] in ("COMPLETE", "PRUNED"),
            f"hypertune_cli: the worker's trial is {trials[-1]['state']}")
    require(len(logs) == 1, f"hypertune_cli: worker logs {logs}")
    require(not out["rebuilt"], "hypertune_cli: the kernel library was rebuilt or replaced")


# -- the forward() figure and the low-dose path ---------------------------------

def float64_cpu(params, buffers, device="cpu"):
    """Copies of a model in float64 / complex128 on the CPU (or ``device``),
    the parameters as fresh leaves that want gradients: the reference for
    the gradients that float32 rounding dominates."""
    from ptyrad_tpu_torch.models.state import PtychoParams

    def up(t):
        if t is None:
            return None
        t = t.detach().to(device)
        if t.is_complex():
            return t.to(torch.complex128)
        return t.double() if t.is_floating_point() else t

    p64 = PtychoParams(**{n: up(t).requires_grad_(True) for n, t in params.named()})
    b64 = dataclasses.replace(buffers, **{f.name: up(getattr(buffers, f.name))
                                          for f in dataclasses.fields(buffers)})
    return p64, b64


def scalar_grads_check(label: str, names, kern, plain, ref64) -> None:
    """The dz and tilt gradients, which autograd contracts out of dH. The
    global phase exp(i dz k) of every propagator (k = 2 pi / lambda, about
    150 / Ang at 80 kV) contributes a term that is zero in exact arithmetic
    but of order float32 epsilon x k x sum |dH| in any float32 route, so the
    kernels' gradients are held against the float64 plain route: each entry
    within 5e-2 of its own size (the rtol of the JAX package's own test,
    tests/test_forward.py:1192-1198) plus 1e-3 of the largest entry, for
    entries near zero. The float32 plain route's error is reported beside."""
    errs_k, errs_p, worst = [], [], []
    for name, k, p, r in zip(names, kern, plain, ref64):
        r = r.detach().cpu().double()
        dk = (k.detach().cpu().double() - r).abs()
        scale = float(r.abs().max())
        tol = 5e-2 * r.abs() + 1e-3 * scale
        errs_k.append(float(dk.max()))
        errs_p.append(float((p.detach().cpu().double() - r).abs().max()))
        worst.append(float((dk / tol).max()) if scale > 0 else float("inf"))
        require(scale > 0, f"{label}: the float64 {name} gradient is zero")
        require(worst[-1] <= 1.0, f"{label}: the kernels' {name} gradient is off the float64 "
                f"one by {worst[-1]} of the limit (max abs err {errs_k[-1]}, largest entry "
                f"{scale}; the float32 plain route's error: {errs_p[-1]})")
    emit({"phase": "scalar_gradients", "path": label, "names": list(names),
          "kernel_err_vs_float64": errs_k, "plain_float32_err_vs_float64": errs_p,
          "kernel_err_over_limit": worst, "limit": "5e-2 |ref| + 1e-3 max |ref| per entry",
          "float64": [r.detach().cpu().reshape(-1)[:4].tolist() for r in ref64]})


def forward_vs_plain(dev, data: dict, mp: dict, label: dict, scalar_names=()) -> dict:
    """One forward() of a batch spread over the scan (B4a, and B4b under
    autograd) against the plain multislice_dp plus the same detector blur on
    the same CUDA tensors: dp within 1e-4 of its largest value, each
    gradient within 1e-4 of its largest entry, dH (the cotangent of the
    batch's H, kept in both routes) included; the scalars autograd
    contracts out of dH (dz, tilts) go to scalar_grads_check against a
    float64 plain route on the CPU. Returns the kernel route's launch
    counts (forward and backward, under counted())."""
    from ptyrad_tpu_torch.models import (compute_propagators, forward, forward_route,
                                         get_obj_patches, get_probes, make_model, multislice_dp)
    F = importlib.import_module("ptyrad_tpu_torch.models.forward")
    from ptyrad_tpu_torch.ops.blur import gaussian_blur_2d

    idx = torch.arange(0, N_SCANS, N_SCANS // BATCH, device=dev)
    w = torch.rand((BATCH, NPIX, NPIX), generator=torch.Generator(device=dev).manual_seed(SEED),
                   device=dev)

    held = []

    def keep_h(*args):
        """compute_propagators, its H kept for dH when it wants a gradient"""
        h = compute_propagators(*args)
        if h.requires_grad:
            h.retain_grad()
            held.append(h)
        return h

    def run(route):
        params, buffers, geom = make_model(data, mp, dev)
        for _, t in params.named():
            t.requires_grad_(True)
        at, wr = idx, w
        held.clear()
        if route == "float64":
            params, buffers = float64_cpu(params, buffers)
            at, wr = idx.cpu(), w.cpu().double()
        if route == "kernels":
            require(forward_route(params, geom, idx) == "fused", "forward() left the B4 route")
            F.compute_propagators = keep_h  # forward() looks it up at call time
            try:
                dp, _ = forward(params, buffers, geom, idx)
            finally:
                F.compute_propagators = compute_propagators
        else:
            obja_p, objp_p = get_obj_patches(params, buffers, geom, at)
            dp = multislice_dp(obja_p, objp_p, get_probes(params, geom, at),
                               keep_h(params, buffers, geom, at), buffers.omode_occu, eps=geom.eps)
            if geom.detector_blur_std:
                dp = gaussian_blur_2d(dp, kernel_size=5, sigma=geom.detector_blur_std)
        (wr * dp).sum().backward()
        grads = {n: t.grad for n, t in params.named() if t.grad is not None}
        if held:
            grads["H"] = held[0].grad
        return dp.detach(), grads

    (dp_k, g_k), launches = counted(lambda: run("kernels"))
    dp_p, g_p = run("plain")
    if scalar_names:
        g_64 = run("float64")[1]
        scalar_grads_check(f"forward() {label}", scalar_names,
                           [g_k[n] for n in scalar_names], [g_p[n] for n in scalar_names],
                           [g_64[n] for n in scalar_names])
    err = float((dp_k - dp_p).abs().max())
    tol = 1e-4 * float(dp_p.abs().max())
    # every gradient at 1e-4 of its largest entry, dH (B4b's own output) too
    names = sorted(set(g_p) - set(scalar_names))
    errs = [float((g_k[n] - g_p[n]).abs().max()) for n in names]
    tols = [1e-4 * float(g_p[n].abs().max()) for n in names]
    emit({"phase": "forward_modes", **label, "batch": BATCH,
          "finite": bool(torch.isfinite(dp_k).all()), "max_abs_err": err, "tolerance": tol,
          "grad_names": names, "grad_max_abs_err": errs, "grad_tolerance": tols,
          "launches": launches})
    expected = {"obja", "objp", "probe", "probe_pos_shifts", *scalar_names,
                *(("H",) if scalar_names else ())}
    require(set(g_k) == set(g_p) == expected, f"gradients reached {sorted(g_k)} and {sorted(g_p)}")
    require(bool(torch.isfinite(dp_k).all()) and err <= tol,
            f"forward() ({label}) differs from the plain version: {err} > {tol}")
    for name, e, t in zip(names, errs, tols):
        require(e <= t, f"forward() ({label}) gradient of {name} differs: {e} > {t}")
    n_dh = launches["B4b dp_bwd (dH)"]
    require(n_dh == (1 if scalar_names else 0), f"B4b computed dH {n_dh} times")
    return launches


def forward_modes_check(dev, init: dict) -> dict:
    """forward() against the plain chain in two cases: 2 object modes (a
    random weak object), per-position shifted probes and detector blur (B4a
    per object mode, B4b per mode under autograd); then optimizable slice
    thickness and per-position tilts within 1 mrad (B4a on a per-position H,
    B4b with dH), every gradient checked, dz's and the tilts' included.
    Returns the kernel routes' launch counts."""
    rng = np.random.default_rng(SEED + 2)
    shape = (2, *init["obj"].shape[1:])
    obj = (1.0 + 0.02 * rng.standard_normal(shape)) * np.exp(0.1j * rng.standard_normal(shape))
    shifts = (0.3 * rng.standard_normal((N_SCANS, 2))).astype(np.float32)
    two = dict(init, obj=obj.astype(np.complex64), omode_occu=np.array([0.7, 0.3], np.float32),
               probe_pos_shifts=shifts)
    modes = forward_vs_plain(dev, two, {"update_params": {"probe_pos_shifts": {"lr": 1e-4}},
                                        "detector_blur_std": 0.5},
                             {"omode": 2, "detector_blur_std": 0.5})
    one = (1.0 + 0.02 * rng.standard_normal(init["obj"].shape)) * np.exp(
        0.1j * rng.standard_normal(init["obj"].shape))
    tilted = dict(init, obj=one.astype(np.complex64), probe_pos_shifts=shifts,
                  obj_tilts=rng.uniform(-1.0, 1.0, (N_SCANS, 2)).astype(np.float32))
    tilts = forward_vs_plain(dev, tilted, {"update_params": {
        "probe_pos_shifts": {"lr": 1e-4}, "obj_tilts": {"lr": 1e-4},
        "slice_thickness": {"lr": 1e-4}}},
        {"omode": 1, "tilts": "per position", "slice_thickness": "optimizable"},
        scalar_names=("obj_tilts", "slice_thickness"))
    return add_counts(modes, tilts)


def low_dose_dataset(init: dict) -> dict:
    """The tBL patterns as the Initializer hands them over under the yml's
    meas_normalization (max_at_one), with the probe scaled so its intensity
    equals the mean pattern sum (its _probe_normalize). loss_poissn's eps
    (1e-6) is an absolute floor: on the raw patterns (sum 1, about 6e-5 a
    pixel) it swamps the dark field and the term barely descends, in the JAX
    package and upstream PtyRAD alike (PARITY_MIDSCALE.json, leg A)."""
    meas = init["measurements"] / init["measurements"].max()
    probe = init["probe"]
    scale = np.sqrt(float(meas.mean(0).sum()) / float(np.sum(np.abs(probe) ** 2)))
    return dict(init, measurements=meas, probe=(probe * scale).astype(np.complex64))


def low_dose_path(dev, card: str, init: dict):
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    data = low_dose_dataset(init)
    solver = PtyRADSolver(LOW_DOSE_PARAMS, init_variables=data, device=dev, verbose=True)
    torch.cuda.reset_peak_memory_stats()
    record = RunRecord()
    t1 = time.perf_counter()
    launches = counted(lambda: solver.run(callback=record))[1]
    run_s = time.perf_counter() - t1
    record.finish(solver)
    losses = [v for _, v in solver.history.loss_iters]
    times = solver.history.iter_times
    emit({
        "phase": "low_dose", "card": card, "n_patterns": N_SCANS, "batch": BATCH,
        "iterations": len(losses), "losses": losses, "terms": solver.history.term_iters,
        "iter_s": times, "patterns_per_s": [N_SCANS / t for t in times], "run_s": run_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches,
    })
    # The mix's total does not fall in 3 iterations from the flat start
    # (loss_pacbed rises, see low_dose_terms_alone), upstream PtyRAD's and
    # the JAX package's neither (PARITY_MIDSCALE.json, leg A); so the run is
    # held to finite values here, and descent to the Poisson term alone.
    require(len(losses) == SIDE_NITER and all(np.isfinite(losses)), f"loss not finite: {losses}")
    for name in LOW_DOSE_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the low-dose path")
    for name in ("B3a loss_sums_fwd", "B3b loss_sums_bwd"):
        require(launches[name] == 0, f"kernel {name} ran on the low-dose path")
    # determinism through B4b: the same iterations again
    again = PtyRADSolver(LOW_DOSE_PARAMS, init_variables=data, device=dev, verbose=False)
    second = RunRecord()
    launches = add_counts(launches, counted(lambda: again.run(callback=second))[1])
    second.finish(again)
    determinism_check("low-dose (B4b)", card, record, second, again)
    del again
    low_dose_terms_alone(dev, data)
    return solver, launches


def low_dose_terms_alone(dev, data: dict) -> None:
    """Each data term of the low-dose mix alone (with loss_sparse), 2
    iterations from the flat start on the same data: the Poisson term must
    fall through B4; the PACBED term's trajectory is reported."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    out = {}
    for term, other in (("loss_poissn", "loss_pacbed"), ("loss_pacbed", "loss_poissn")):
        params = copy.deepcopy(LOW_DOSE_PARAMS)
        params["loss_params"][other]["state"] = False
        params["recon_params"]["NITER"] = 2
        solver = PtyRADSolver(params, init_variables=data, device=dev, verbose=False)
        solver.run()
        out[term] = [t[term] for t in solver.history.term_iters]
        del solver
    emit({"phase": "low_dose_terms_alone", "iterations": 2, **out})
    poissn = out["loss_poissn"]
    require(len(poissn) == 2 and all(np.isfinite(poissn)) and poissn[1] < poissn[0],
            f"loss_poissn alone did not fall through B4: {poissn}")


DEV_TOOLS_RTOL = 1e-4  # the smoke run's terms on B4a against the plain route (forward_vs_plain's)


def dev_tools_path(dev, card: str, init: dict, tmp: str) -> dict:
    """utils/dev_tools on the card, on the low-dose data: test_loss_fn on a
    batch of BATCH (forward() through B4a, the low-dose mix) against the
    same smoke run on the plain route (fwd_fused off), within
    DEV_TOOLS_RTOL; check_nan_inf and print_tree_sizes over the model;
    time_sync around one training step, against CUDA events around
    another; trace() around a third, whose Chrome trace must hold kernel
    events. Returns the launches of the smoke run and the steps."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver
    from ptyrad_tpu_torch.utils import dev_tools as DT

    data = low_dose_dataset(init)
    solver = PtyRADSolver(LOW_DOSE_PARAMS, init_variables=data, device=dev, verbose=False)
    solver.prepare()
    solver._build()
    p, b, g = solver.params, solver.buffers, solver.geom
    idx = np.arange(BATCH)
    loss_params = LOW_DOSE_PARAMS["loss_params"]
    (total, terms), smoke = counted(lambda: DT.test_loss_fn(p, b, g, idx, loss_params))
    plain_total, plain_terms = DT.test_loss_fn(p, b, dataclasses.replace(g, fwd_fused=False),
                                               idx, loss_params)
    rel = {k: abs(v - plain_terms[k]) / max(abs(plain_terms[k]), 1e-30)
           for k, v in terms.items() if plain_terms[k] != 0}
    rel["total"] = abs(total - plain_total) / abs(plain_total)
    clean = DT.check_nan_inf(p, "params") and DT.check_nan_inf(b, "buffers")
    nbytes = DT.print_tree_sizes(p, "params")
    bidx = torch.as_tensor(solver.batch_idx[:1], device=dev)
    bmask = torch.as_tensor(solver.batch_mask[:1], device=dev)

    def steps():
        t0 = DT.time_sync(p)
        solver.train_epoch(bidx, bmask, 1)
        t1 = DT.time_sync(p)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        solver.train_epoch(bidx, bmask, 2)
        end.record()
        end.synchronize()
        with DT.trace(f"{tmp}/dev_tools_trace") as path:
            solver.train_epoch(bidx, bmask, 3)
            DT.time_sync(p)
        return (t1 - t0) * 1e3, start.elapsed_time(end), path

    (sync_ms, event_ms, path), stepped = counted(steps)
    with open(path, encoding="utf-8") as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = add_counts(smoke, stepped)
    emit({"phase": "dev_tools", "card": card, "batch": BATCH, "terms": terms, "total": total,
          "plain_terms": plain_terms, "plain_total": plain_total, "rel_err": rel,
          "rtol": DEV_TOOLS_RTOL, "clean": clean, "params_bytes": nbytes,
          "time_sync_step_ms": sync_ms, "event_step_ms": event_ms,
          "trace_bytes": os.path.getsize(path), "trace_events": len(events),
          "trace_kernel_events": len(kernels), "smoke_launches": smoke["B4a dp_fwd"],
          "launches": {k: launches[k] for k in LOW_DOSE_KERNELS}})
    require(smoke["B4a dp_fwd"] > 0 and smoke["B4b dp_bwd"] == 0,
            f"dev_tools: the smoke run launched B4a {smoke['B4a dp_fwd']} times, B4b "
            f"{smoke['B4b dp_bwd']}")
    require(np.isfinite(total) and max(rel.values()) <= DEV_TOOLS_RTOL,
            f"dev_tools: test_loss_fn on B4a against the plain route: {rel}")
    require(clean and nbytes == sum(t.numel() * t.element_size() for _, t in p.named()),
            f"dev_tools: check_nan_inf {clean}, print_tree_sizes {nbytes}")
    require(sync_ms > 0 and event_ms > 0, f"dev_tools: step ms {sync_ms}, {event_ms}")
    require(len(events) > 0 and len(kernels) > 0,
            f"dev_tools: the trace holds {len(events)} events, {len(kernels)} kernels")
    del solver
    torch.cuda.empty_cache()
    return launches


# -- phase 6: the PSO path ----------------------------------------------------

def pso_positions() -> tuple[np.ndarray, int]:
    """Integer patch corners of the 64 x 64 raster at 0.41 Ang steps (2.73 px
    at dx = 0.15 Ang; the yml's 0.15 Ang random jitter is left out)."""
    steps = np.round(np.arange(PSO_SIDE) * PSO_STEP_ANG / PSO_DX).astype(np.int32)
    ys, xs = np.meshgrid(steps, steps, indexing="ij")
    canvas = int(steps[-1]) + PSO_NPIX + 8
    return np.stack([ys.ravel() + 4, xs.ravel() + 4], -1).astype(np.int32), canvas


def columnar_phase(canvas: int) -> np.ndarray:
    """A columnar phase object: 1,500 atom columns at seeded random centres,
    each a Gaussian of 0.04 rad per slice (variance 2 px^2), the same in all
    21 slices; each blob is evaluated in a 25^2 window."""
    rng = np.random.default_rng(SEED + 1)
    phase = np.zeros((canvas, canvas), np.float32)
    d = np.arange(-12, 13, dtype=np.float32)
    blob = 0.04 * np.exp(-(d[:, None] ** 2 + d[None, :] ** 2) / 4.0)
    for cy, cx in rng.integers(12, canvas - 12, (1500, 2)):
        phase[cy - 12:cy + 13, cx - 12:cx + 13] += blob
    return np.broadcast_to(phase, (PSO_NZ, canvas, canvas))


def pso_dataset(dev, tilt=(0.0, 0.0)) -> dict:
    """init_variables for PSO: 256^2 patterns simulated through the port's
    plain multislice_dp (set-up, not the path being driven) with a global
    crystal tilt (mrad), cropped to [68, 188)^2, normalised to max at one,
    and padded on the fly; the probe scaled to the mean measured intensity
    with its pad, as the Initializer's _probe_normalize does; a flat initial
    object and zero tilt."""
    from ptyrad_tpu_torch.initialization import meas_pad_on_the_fly
    from ptyrad_tpu_torch.models import (compute_propagators, get_obj_patches, get_probes,
                                         make_model, multislice_dp)
    from ptyrad_tpu_torch.physics import electron_wavelength, near_field_evolution

    crop_pos, canvas = pso_positions()
    lam = electron_wavelength(PSO_KV)
    true_obj = np.exp(1j * columnar_phase(canvas))[None].astype(np.complex64)
    init = {
        "obj": true_obj,
        "probe": pso_probe(),
        "probe_pos_shifts": np.zeros((PSO_SCANS, 2), np.float32),
        "obj_tilts": np.array([tilt], np.float32),
        "slice_thickness": PSO_DZ,
        "H": near_field_evolution((PSO_NPIX, PSO_NPIX), PSO_DX, PSO_DZ, lam),
        "measurements": np.zeros((1, PSO_NPIX, PSO_NPIX), np.float32),
        "crop_pos": crop_pos,
        "omode_occu": np.ones(1, np.float32),
        "dx": PSO_DX,
        "lambd": lam,
        "N_scan_slow": PSO_SIDE,
        "N_scan_fast": PSO_SIDE,
    }
    params, buffers, geom = make_model(init, None, dev)
    lo, hi = PSO_CROP
    crops = torch.empty((PSO_SCANS, hi - lo, hi - lo), dtype=torch.float32, device=dev)
    with torch.no_grad():
        for start in range(0, PSO_SCANS, 256):
            idx = torch.arange(start, min(start + 256, PSO_SCANS), device=dev)
            obja_p, objp_p = get_obj_patches(params, buffers, geom, idx)
            dp = multislice_dp(obja_p, objp_p, get_probes(params, geom, idx),
                               compute_propagators(params, buffers, geom, idx),
                               buffers.omode_occu, eps=geom.eps)
            crops[idx] = dp[:, lo:hi, lo:hi]
    del params, buffers, geom
    crops /= crops.max()
    crops_np = crops.cpu().numpy()
    padded, pad_idx = meas_pad_on_the_fly(crops_np, "power", PSO_NPIX, threshold=70)
    meas_avg_sum = float(crops_np.mean(0).sum() + padded.sum())
    probe = init["probe"]
    probe = (probe * np.sqrt(meas_avg_sum / np.sum(np.abs(probe) ** 2))).astype(np.complex64)
    init.update(obj=np.ones_like(true_obj), probe=probe, measurements=crops,
                obj_tilts=np.zeros((1, 2), np.float32), on_the_fly_meas_padded=padded,
                on_the_fly_meas_padded_idx=pad_idx)
    return init


def pso_path(dev, card: str):
    t0 = time.perf_counter()
    init = pso_dataset(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    solver, launches, first = run_pso_solver(dev, card, "pso", init, setup_s)
    for name in PSO_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the PSO path")
    for name in ("B5a chain_segment_fwd (far-field)", "B5b chain_segment_bwd (far-field)"):
        require(launches[name] == 0, f"{name} ran with the exit switched off")
    ref = {"losses": [v for _, v in solver.history.loss_iters], "first_batch_loss": first,
           "state": final_state(solver),
           "phase_corr": quality_check("PSO", card, solver.params.objp,
                                       columnar_phase(pso_positions()[1]), *pso_scanned())}
    pso_forward_figure(solver)
    return solver, launches, init, ref


def batch_loss(solver, idx: torch.Tensor, mask: torch.Tensor) -> float:
    """The total loss of one batch, no gradient (the chain runs B5 segment
    by segment)."""
    from ptyrad_tpu_torch.engine.solver import loss_fn

    with torch.no_grad():
        total, _ = loss_fn(solver.params, solver.buffers, solver.geom, idx, mask,
                           solver.loss_params)
    return float(total)


def first_batch_loss(solver) -> float:
    """The loss of the solver's first batch before any step."""
    solver.prepare()
    return batch_loss(solver, *(torch.as_tensor(x[0], device=solver.device)
                                 for x in (solver.batch_idx, solver.batch_mask)))


def run_pso_solver(dev, card: str, phase: str, init: dict, setup_s: float,
                   params: dict = PSO_PARAMS):
    """PtyRADSolver(params).run() on the PSO data with the counts set to 0
    just before it; asserts a finite, falling loss and that neither B3 nor
    B4 ran. Returns (solver, launches, the first batch's loss before
    training)."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    solver = PtyRADSolver(params, init_variables=init, device=dev, verbose=True)
    first = first_batch_loss(solver)
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    launches = drive(solver)
    run_s = time.perf_counter() - t1
    losses = [v for _, v in solver.history.loss_iters]
    times = solver.history.iter_times
    emit({
        "phase": phase, "card": card, "n_patterns": PSO_SCANS, "batch": BATCH,
        "first_batch_loss": first, "iterations": len(losses), "losses": losses, "iter_s": times,
        "patterns_per_s": [PSO_SCANS / t for t in times], "setup_s": setup_s, "run_s": run_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches,
    })
    require(len(losses) == PSO_NITER and all(np.isfinite(losses)),
            f"{phase}: loss not finite: {losses}")
    require(losses[-1] < losses[0], f"{phase}: loss did not fall: {losses}")
    for name in ("B3a loss_sums_fwd", "B3b loss_sums_bwd", "B4a dp_fwd", "B4b dp_bwd"):
        require(launches[name] == 0, f"kernel {name} ran on the {phase} path (N = 256)")
    return solver, launches, first


def pso_forward_figure(solver) -> None:
    """One no-grad forward() of a batch, the yml's "forward" figure: finite,
    of the expected shape, and equal to the plain multislice_dp on the same
    patches within 1e-4 of its largest value."""
    from ptyrad_tpu_torch.models import (compute_propagators, forward, get_obj_patches,
                                         get_probes, multislice_dp)

    p, bufs, geom = solver.params, solver.buffers, solver.geom
    idx = torch.as_tensor(solver.batch_idx[0], device=solver.device)
    with torch.no_grad():
        dp, (obja_p, objp_p) = forward(p, bufs, geom, idx)
        ref = multislice_dp(obja_p, objp_p, get_probes(p, geom, idx),
                            compute_propagators(p, bufs, geom, idx), bufs.omode_occu, geom.eps)
    err = float((dp - ref).abs().max())
    tol = 1e-4 * float(ref.abs().max())
    emit({"phase": "pso_forward", "shape": list(dp.shape), "finite": bool(torch.isfinite(dp).all()),
          "max_abs_err": err, "tolerance": tol})
    require(tuple(dp.shape) == (len(idx), *geom.probe_shape) and bool(torch.isfinite(dp).all()),
            "forward() gave a non-finite or misshapen dp")
    require(err <= tol, f"forward() differs from the plain multislice_dp: {err} > {tol}")


# -- PSO at its 120^2 crop: the fused kernels' mixed-radix pair ------------------

def pso_n120_init(pso_init: dict) -> dict:
    """init_variables of PSO at its 120^2 crop without the on-the-fly pad:
    pso_dataset's patterns (cropped to [68, 188)^2, normalised to max one),
    the crop's pixel 0.15 x 256 / 120 Ang (the same reciprocal pixel), the
    yml's probe at 120^2 scaled to the mean measured intensity, the raster
    at that pixel, 21 slices of 10 Ang, a seeded random object (the flat
    start amplifies float32 rounding, see pso_ff_path) and zero tilt."""
    from ptyrad_tpu_torch.physics import (electron_wavelength, make_mixed_probe,
                                          make_stem_probe, near_field_evolution)

    n = PSO_N120
    dx = PSO_DX * PSO_NPIX / n
    steps = np.round(np.arange(PSO_SIDE) * PSO_STEP_ANG / dx).astype(np.int32)
    ys, xs = np.meshgrid(steps, steps, indexing="ij")
    canvas = int(steps[-1]) + n + 8
    lam = electron_wavelength(PSO_KV)
    meas = pso_init["measurements"]
    probe = make_mixed_probe(make_stem_probe({"kv": PSO_KV, "conv_angle": 21.4, "Npix": n,
                                              "dx": dx, "df": -200.0}), PSO_PMODE, [0.02])
    scale = np.sqrt(float(meas.mean(0).sum()) / np.sum(np.abs(probe) ** 2))
    return {
        "obj": random_object((1, PSO_NZ, canvas, canvas), SEED + 9),
        "probe": (probe * scale).astype(np.complex64),
        "probe_pos_shifts": np.zeros((PSO_SCANS, 2), np.float32),
        "obj_tilts": np.zeros((1, 2), np.float32), "slice_thickness": PSO_DZ,
        "H": near_field_evolution((n, n), dx, PSO_DZ, lam), "measurements": meas,
        "crop_pos": np.stack([ys.ravel() + 4, xs.ravel() + 4], -1).astype(np.int32),
        "omode_occu": np.ones(1, np.float32), "dx": dx, "lambd": lam,
        "N_scan_slow": PSO_SIDE, "N_scan_fast": PSO_SIDE,
    }


def pso_fused_path(dev, card: str, pso_init: dict, n: int):
    """pso_n120 and pso_n127: PSO as its params file gives it minus the
    on-the-fly pad (4,096 patterns of 120^2), or padded on the fly to 127^2
    (pso_pad_init), 4 probe modes, 21 slices, batch 32, Adam, loss_single,
    the yml's constraints, 2 iterations from a seeded object through
    PtyRADSolver.run(): each step B1, B2, B3a and B3b at N (at 120 the
    mixed-radix pair, at 127 the Bluestein line), the forward figure B4a,
    no plain route; finite and falling, and every iteration's loss within
    rtol 1e-4 of the same run through the plain route (fwd_fused: false,
    torch.fft on the card). Returns (solver, launches of the kernel run and
    the figure, init)."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    t0 = time.perf_counter()
    init = pso_n120_init(pso_init) if n == PSO_N120 else pso_pad_init(pso_init, n)
    setup_s = time.perf_counter() - t0
    solver = PtyRADSolver(PSO_PARAMS, init_variables=init, device=dev, verbose=True)
    first = first_batch_loss(solver)
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    launches = drive(solver)
    run_s = time.perf_counter() - t1
    losses = [v for _, v in solver.history.loss_iters]
    times = solver.history.iter_times
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = add_counts(launches, counted(lambda: pso_forward_figure(solver))[1])

    plain_params = copy.deepcopy(PSO_PARAMS)
    plain_params["model_params"]["fwd_fused"] = False
    ref = PtyRADSolver(plain_params, init_variables=init, device=dev, verbose=False)
    t2 = time.perf_counter()
    ref_launches = drive(ref)
    ref_s = time.perf_counter() - t2
    ref_losses = [v for _, v in ref.history.loss_iters]
    del ref
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    emit({
        "phase": f"pso_n{n}", "card": card, "N": n, "n_patterns": PSO_SCANS, "batch": BATCH,
        "first_batch_loss": first, "iterations": len(losses), "losses": losses, "iter_s": times,
        "patterns_per_s": [PSO_SCANS / t for t in times], "setup_s": setup_s, "run_s": run_s,
        "peak_mem_gb": peak, "launches": launches, "plain_route_losses": ref_losses,
        "plain_route_run_s": ref_s, "rel_diff": rel, "rtol": 1e-4,
        "plain_route_launches": ref_launches[PLAIN_ROUTE],
    })
    tag = f"pso_n{n}"
    require(len(losses) == PSO_NITER and all(np.isfinite(losses)), f"{tag}: losses {losses}")
    require(losses[-1] < losses[0], f"{tag}: loss did not fall: {losses}")
    require(len(ref_losses) == PSO_NITER and max(rel) <= 1e-4,
            f"{tag}: losses {losses} differ from the plain route's {ref_losses}: {rel}")
    for name in (f"B3a loss_sums_fwd (N={n})", f"B3b loss_sums_bwd (N={n})",
                 f"B4a dp_fwd (N={n})", "B1 gather_patches", "B2 scatter_add_patches"):
        require(launches[name] > 0, f"kernel {name} was not launched on the {tag} path")
    require(launches[PLAIN_ROUTE] == 0, f"{tag}: {launches[PLAIN_ROUTE]} plain routes")
    for name in CHAIN_KERNELS:
        require(launches[name] == 0, f"{tag}: {name} ran at N = {n}")
    for name in ("B3a loss_sums_fwd", "B3b loss_sums_bwd"):  # every B3 launch at N
        require(launches[name] == launches[f"{name} (N={n})"],
                f"{tag}: {name} ran {launches[name]} times, {launches[f'{name} (N={n})']} at N")
    require(ref_launches[PLAIN_ROUTE] > 0, f"{tag}'s reference did not take the plain route")
    return solver, launches, init


def fused_tilt_gate(dev, init: dict, n: int) -> dict:
    """The dz and tilt float64 gate (tilt_gradients_check, its tolerance
    unchanged) at N (120, 127): pso_n<N>'s data with per-position tilts and
    dz optimizable (with_dz_tilts), the first batch through B3 with dH (a
    per-position H) against the plain route and against float64 on the
    CPU. Returns the launch counts."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    data = dict(init, obj_tilts=np.zeros((PSO_SCANS, 2), np.float32))
    solver = PtyRADSolver(with_dz_tilts(PSO_PARAMS), init_variables=data, device=dev,
                          verbose=False)
    solver.prepare()
    for name in ("slice_thickness", "obj_tilts"):
        getattr(solver.params, name).requires_grad_(True)
    require(not solver.geom.global_tilt, f"the N = {n} tilt gate runs one global tilt")
    launches = counted(lambda: tilt_gradients_check(solver))[1]
    require(launches[f"B3b loss_sums_bwd (dH, N={n})"] > 0,
            f"the N = {n} tilt gate did not run B3b with dH")
    return launches


# -- PSO padded to 192^2: the segmented chain's mixed-radix build --------------

def pso_pad_init(pso_init: dict, n: int) -> dict:
    """init_variables of PSO as its params file gives it, but padded on the
    fly to N^2 (192, 254) instead of 256^2: pso_dataset's 120^2 crops padded
    with meas_pad_on_the_fly(crops, "power", N, threshold=70), the pixel
    0.15 x 256 / N Ang (at 192: 0.2 Ang, the crop's 0.32 Ang x 120 / 192),
    the yml's probe at N^2 scaled to the mean measured intensity with its
    pad (as pso_dataset scales it), the raster at that pixel, 21 slices of
    10 Ang, a seeded random object (the flat start amplifies float32
    rounding, see pso_ff_path) and zero tilt."""
    from ptyrad_tpu_torch.initialization import meas_pad_on_the_fly
    from ptyrad_tpu_torch.physics import (electron_wavelength, make_mixed_probe,
                                          make_stem_probe, near_field_evolution)

    dx = PSO_DX * PSO_NPIX / n
    steps = np.round(np.arange(PSO_SIDE) * PSO_STEP_ANG / dx).astype(np.int32)
    ys, xs = np.meshgrid(steps, steps, indexing="ij")
    canvas = int(steps[-1]) + n + 8
    lam = electron_wavelength(PSO_KV)
    crops = pso_init["measurements"]
    crops_np = crops.cpu().numpy()
    padded, pad_idx = meas_pad_on_the_fly(crops_np, "power", n, threshold=70)
    meas_avg_sum = float(crops_np.mean(0).sum() + padded.sum())
    probe = make_mixed_probe(make_stem_probe({"kv": PSO_KV, "conv_angle": 21.4, "Npix": n,
                                              "dx": dx, "df": -200.0}), PSO_PMODE, [0.02])
    scale = np.sqrt(meas_avg_sum / np.sum(np.abs(probe) ** 2))
    return {
        "obj": random_object((1, PSO_NZ, canvas, canvas), SEED + 11),
        "probe": (probe * scale).astype(np.complex64),
        "probe_pos_shifts": np.zeros((PSO_SCANS, 2), np.float32),
        "obj_tilts": np.zeros((1, 2), np.float32), "slice_thickness": PSO_DZ,
        "H": near_field_evolution((n, n), dx, PSO_DZ, lam), "measurements": crops,
        "crop_pos": np.stack([ys.ravel() + 4, xs.ravel() + 4], -1).astype(np.int32),
        "omode_occu": np.ones(1, np.float32), "dx": dx, "lambd": lam,
        "N_scan_slow": PSO_SIDE, "N_scan_fast": PSO_SIDE,
        "on_the_fly_meas_padded": padded, "on_the_fly_meas_padded_idx": pad_idx,
    }


def pso_pad_path(dev, card: str, pso_init: dict, n: int):
    """pso_n192 and pso_n254: PSO as its params file gives it, padded on the
    fly to N^2 (4,096 patterns, 4 probe modes, 21 slices, batch 32, Adam,
    loss_single, the yml's constraints), 2 iterations from a seeded object
    through PtyRADSolver.run(): each step B1, B2, B6a/B6b over 16 slices and
    B5a/B5b over the 5-slice tail at N (chain.cu's mixed build: at 192 the
    mixed-radix pair, at 254 = 2 x 127 a Bluestein line), no B3/B4 and no
    plain route; finite and falling, and every iteration's loss within rtol
    1e-4 of the same run through the plain route (fwd_fused: false,
    torch.fft on the card). Returns (solver, launches, init)."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    t0 = time.perf_counter()
    init = pso_pad_init(pso_init, n)
    setup_s = time.perf_counter() - t0
    solver = PtyRADSolver(PSO_PARAMS, init_variables=init, device=dev, verbose=True)
    first = first_batch_loss(solver)
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    launches = drive(solver)
    run_s = time.perf_counter() - t1
    losses = [v for _, v in solver.history.loss_iters]
    times = solver.history.iter_times
    peak = torch.cuda.max_memory_allocated() / 1e9

    plain_params = copy.deepcopy(PSO_PARAMS)
    plain_params["model_params"]["fwd_fused"] = False
    ref = PtyRADSolver(plain_params, init_variables=init, device=dev, verbose=False)
    t2 = time.perf_counter()
    ref_launches = drive(ref)
    ref_s = time.perf_counter() - t2
    ref_losses = [v for _, v in ref.history.loss_iters]
    del ref
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    emit({
        "phase": f"pso_n{n}", "card": card, "N": n, "n_patterns": PSO_SCANS,
        "batch": BATCH, "first_batch_loss": first, "iterations": len(losses), "losses": losses,
        "iter_s": times, "patterns_per_s": [PSO_SCANS / t for t in times], "setup_s": setup_s,
        "run_s": run_s, "peak_mem_gb": peak, "launches": launches,
        "plain_route_losses": ref_losses, "plain_route_run_s": ref_s, "rel_diff": rel,
        "rtol": 1e-4, "plain_route_launches": ref_launches[PLAIN_ROUTE],
    })
    tag = f"pso_n{n}"
    require(len(losses) == PSO_NITER and all(np.isfinite(losses)), f"{tag}: losses {losses}")
    require(losses[-1] < losses[0], f"{tag}: loss did not fall: {losses}")
    require(len(ref_losses) == PSO_NITER and max(rel) <= 1e-4,
            f"{tag}: losses {losses} differ from the plain route's {ref_losses}: {rel}")
    for name in tuple(per_n(name, n) for name in CHAIN_KERNELS) + PATCH_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the {tag} path")
    require(launches[PLAIN_ROUTE] == 0, f"{tag}: {launches[PLAIN_ROUTE]} plain routes")
    for name in ("B3a loss_sums_fwd", "B3b loss_sums_bwd", "B4a dp_fwd", "B4b dp_bwd"):
        require(launches[name] == 0, f"{tag}: {name} ran at N = {n}")
    for name in CHAIN_KERNELS:  # every chain launch at N (the mixed build)
        require(launches[name] == launches[per_n(name, n)],
                f"{tag}: {name} ran {launches[name]} times, "
                f"{launches[per_n(name, n)]} at N = {n}")
    require(ref_launches[PLAIN_ROUTE] > 0, f"{tag}'s reference did not take the plain route")
    return solver, launches, init


def pad_exit_check(solver, n: int) -> dict:
    """The far-field exit at N (192, 254) on pso_n<N>'s first batch: loss_fn
    and its backward (B6 over 16 slices, B5 over the tail) with
    set_far_field(True) against the same with the exit off: the loss
    within rtol 1e-5, and every B5 launch of the exit's run took it.
    Returns both runs' launch counts, summed."""
    from ptyrad_tpu_torch.engine.solver import loss_fn

    p, bufs, geom = solver.params, solver.buffers, solver.geom
    idx, mask = (torch.as_tensor(x[0], device=solver.device)
                 for x in (solver.batch_idx, solver.batch_mask))

    def run():
        total, _ = loss_fn(p, bufs, geom, idx, mask, solver.loss_params)
        total.backward()
        for _, t in p.named():
            t.grad = None
        return float(total.detach())

    off, l_off = counted(run)
    on, l_on = counted(lambda: far_field_on(run))
    rel = abs(on - off) / abs(off)
    b5 = [per_n(name, n) for name in ("B5a chain_segment_fwd", "B5b chain_segment_bwd")]
    emit({"phase": f"n{n}_exit", "loss_exit_off": off, "loss_exit_on": on, "rel_diff": rel,
          "rtol": 1e-5, "launches_exit_on": {k: l_on[k] for k in b5 + [per_n(
              f"{k.split(' (')[0]} (far-field)", n) for k in b5]}})
    require(rel <= 1e-5, f"n{n}_exit: the exit's loss {on} differs from {off}: {rel}")
    for name in b5:
        ff = per_n(f"{name.split(' (')[0]} (far-field)", n)
        require(l_off[ff] == 0 < l_on[name] == l_on[ff],
                f"n{n}_exit: {name} ran {l_on[name]} times with the exit on, {l_on[ff]} "
                f"through it; {l_off[ff]} with it off")
    return add_counts(l_off, l_on)


def chain_tilt_gradients_check(solver) -> dict:
    """The dz and tilt float64 gate on the chain route (N > 128, where
    tilt_gradients_check's B3 does not run), built as that check is: the
    first batch's patches, probes and patterns computed once in float32,
    and the loss (combined_loss, the solver's terms) of multislice_dp_chain
    on the kernels (B6b and B5b with dH on a per-position H), of the plain
    multislice_dp on the same CUDA tensors and of the plain chain in
    float64 on the CPU. H comes from float64 parameters in every route,
    rounded once to complex64 for the two float32 routes: at 192^2 (k up to
    2.5 / Ang) evaluating H and contracting dH into the tilt gradients in
    float32, which both float32 routes share, puts an entry of the tilt
    gradient 1.06 of the limit off the float64 one, for torch.fft's route
    as for the kernels (on an H100: 2.8143e-7 and 2.8144e-7, largest entry
    1.72e-4), so
    the gate holds the chains' own float32 arithmetic, where the dz
    cancellation lives. dH within 1e-4 of the plain route's largest entry;
    the dz and tilt gradients through scalar_grads_check (its tolerance
    unchanged). Returns the kernel route's launch counts."""
    from ptyrad_tpu_torch.losses import combined_loss
    from ptyrad_tpu_torch.models import (compute_propagators, forward_route, get_measurements,
                                         get_obj_patches, get_probes, multislice_dp)
    from ptyrad_tpu_torch.ops import chain as C

    p, bufs, geom = solver.params, solver.buffers, solver.geom
    idx, mask = (torch.as_tensor(x[0], device=solver.device)
                 for x in (solver.batch_idx, solver.batch_mask))
    require(forward_route(p, geom, idx) == "chain", "the chain tilt gate left the chain route")
    with torch.no_grad():
        ops = (*get_obj_patches(p, bufs, geom, idx), get_probes(p, geom, idx),
               get_measurements(bufs, geom, idx), mask)

    def run(route):
        on_cpu = route == "float64"
        model, bb = float64_cpu(p, bufs, "cpu" if on_cpu else solver.device)
        at, args = idx, ops
        h = compute_propagators(model, bb, geom, idx.cpu() if on_cpu else idx)
        if on_cpu:
            at = idx.cpu()
            args = tuple(t.cpu().to(torch.complex128 if t.is_complex() else torch.float64)
                         for t in ops)
        else:
            h = h.to(torch.complex64)
        h.retain_grad()
        obja_p, objp_p, probes, meas, m = args
        occu = bb.omode_occu if on_cpu else bufs.omode_occu
        chain = multislice_dp if route == "plain" else C.multislice_dp_chain
        dp = chain(obja_p, objp_p, probes, h, occu, geom.eps)
        total, _ = combined_loss(dp, meas, obja_p, objp_p, occu, solver.loss_params, m)
        total.backward()
        return h.grad, model.slice_thickness.grad, model.obj_tilts.grad[at]

    k, launches = counted(lambda: run("kernels"))
    pl, r64 = run("plain"), run("float64")
    (e_dh,), (t_dh,) = _grad_errs(k[:1], pl[:1])
    emit({"phase": "tilt_gradients", "route": "chain", "N": geom.probe_shape[-1],
          "batch": len(idx), "h": "float64 parameters, rounded once to complex64",
          "dh_max_abs_err": e_dh, "dh_tolerance": t_dh})
    require(e_dh <= t_dh, f"chain tilt gate: dH differs from the plain route: {e_dh} > {t_dh}")
    scalar_grads_check(f"chain tilt gate (N = {geom.probe_shape[-1]})",
                       ("slice_thickness", "obj_tilts"), k[1:], pl[1:], r64[1:])
    return launches


def pad_tilt_gate(dev, init: dict, n: int) -> dict:
    """The dz and tilt float64 gate at N (192, 254): pso_n<N>'s data with
    per-position tilts and dz optimizable (with_dz_tilts), the first batch
    through B6b and B5b with dH on a per-position H (chain_tilt_gradients_check).
    Returns the launch counts."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    data = dict(init, obj_tilts=np.zeros((PSO_SCANS, 2), np.float32))
    solver = PtyRADSolver(with_dz_tilts(PSO_PARAMS), init_variables=data, device=dev,
                          verbose=False)
    solver.prepare()
    for name in ("slice_thickness", "obj_tilts"):
        getattr(solver.params, name).requires_grad_(True)
    require(not solver.geom.global_tilt, f"the N = {n} tilt gate runs one global tilt")
    launches = chain_tilt_gradients_check(solver)
    for name in ("B5b chain_segment_bwd (dH)", "B6b chain_stack_bwd (dH)"):
        require(launches[per_n(name, n)] > 0,
                f"the N = {n} tilt gate did not run {per_n(name, n)}")
    return launches


# -- PSO padded on the fly to 1024^2: the plain route, with and without remat ---

# The first N above the kernels' 512: forward_route gives "plain" (the eager
# torch.fft chain) and B1/B2 are the path's only kernels, at 1024^2 windows.
# The window: the first N1024_STEPS batches of iteration 1 through
# solver.train_epoch, as canvas_fullscan's window runs, from one seeded
# state for each of the four runs (fwd_remat off and on, with the yml's
# update set and with dz and the tilts optimized too)
PSO_N1024 = 1024
N1024_STEPS = 8
N1024_PROFILE_STEPS = 4
N1024_SHAPES = " (PSO N=1024)"  # name suffix of the B1/B2 rows at pso_n1024's shapes
# launches a timed run of B1/B2 and their library calls at these shapes (a
# library scatter of 704 M values takes some 200 ms)
N1024_ROW_LAUNCHES = 4


def free_device_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def n1024_window(dev, init: dict, params: dict, remat: bool):
    """One run of pso_n1024's window: a fresh PtyRADSolver with fwd_remat as
    given, the window's first batch's loss, the window under counted() with
    the peak device memory from just before it, that batch's loss again.
    Returns (the record, the solver)."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver, iter_batch_perm

    t0 = time.perf_counter()
    params = copy.deepcopy(params)
    params["model_params"]["fwd_remat"] = remat
    solver = PtyRADSolver(params, init_variables=init, device=dev, verbose=False)
    solver.prepare()
    solver._build()
    require(solver.geom.fwd_remat == remat, f"pso_n1024: fwd_remat {remat} not in Geometry")
    window = iter_batch_perm(1, len(solver.batch_idx))[:N1024_STEPS]
    idx = torch.as_tensor(solver.batch_idx[window], device=dev)
    mask = torch.as_tensor(solver.batch_mask[window], device=dev)
    before = batch_loss(solver, idx[0], mask[0])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    (mean, terms), launches = counted(lambda: solver.train_epoch(idx, mask, 1))
    run_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() / 1e9
    after = batch_loss(solver, idx[0], mask[0])
    return {"remat": remat, "mean_loss": mean, "batch_terms": terms,
            "first_batch_loss": [before, after], "peak_mem_gb": peak,
            "s_per_step": run_s / N1024_STEPS, "setup_s": setup_s,
            "digest": params_digest(solver.params), "launches": launches}, solver


def pso_n1024_path(dev, card: str, pso_init: dict) -> tuple[dict, list]:
    """pso_n1024: PSO as its params file gives it (4,096 patterns, 4 probe
    modes, 21 slices of 10 Ang, batch 32, Adam, loss_single, the yml's
    constraints) with the 120^2 crops padded on the fly to 1024^2
    (pso_pad_init: dx 0.0375 Ang, canvas 1,721^2): the plain route, B1/B2 at
    1024^2 windows. n1024_window four times from one seeded state: the yml's
    update set with fwd_remat off, then on, and the same with dz and the
    tilts optimized (with_dz_tilts: H needs a gradient). Each pair equal bit
    for bit (every batch's terms, the mean, the parameters' digest), the
    window's first batch's loss falling and finite, the remat peak below
    its pair's; every run B1 and B2, PLAIN_ROUTE N1024_STEPS times, no
    B3-B6. A profile over N1024_PROFILE_STEPS steps of each yml run
    (PSO-n1024, PSO-n1024-remat); then B1/B2 at these shapes against their
    plain versions (rows of the kernels line). Returns (the launches of the
    four windows, the B1/B2 rows)."""
    t0 = time.perf_counter()
    init = pso_pad_init(pso_init, PSO_N1024)
    corners, side = init["crop_pos"], init["obj"].shape[-1]
    init_s = time.perf_counter() - t0
    runs, pairs = [], {}
    for label, params in (("yml", PSO_PARAMS), ("dz_tilts", with_dz_tilts(PSO_PARAMS))):
        pair = []
        for remat in (False, True):
            rec, solver = n1024_window(dev, init, params, remat)
            tag = f"pso_n1024 {label}, fwd_remat {remat}"
            require(solver.geom.probe_shape == (PSO_N1024, PSO_N1024)
                    and solver.geom.tilt_obj == (label == "dz_tilts"),
                    f"{tag}: geometry {solver.geom.probe_shape}, tilt {solver.geom.tilt_obj}")
            before, after = rec["first_batch_loss"]
            require(np.isfinite(after) and after < before,
                    f"{tag}: the first batch's loss went {before} -> {after}")
            launches = rec["launches"]
            for name in PATCH_KERNELS:
                require(launches[name] > 0, f"{tag}: {name} was not launched")
            require(launches[PLAIN_ROUTE] == N1024_STEPS,
                    f"{tag}: {launches[PLAIN_ROUTE]} plain routes in {N1024_STEPS} steps")
            chain = {k: v for k, v in launches.items() if k[:2] in ("B3", "B4", "B5", "B6") and v}
            require(not chain, f"{tag}: chain kernels ran: {chain}")
            if label == "yml":
                rec["profile"] = profile_steps(solver, card, "PSO-n1024" + "-remat" * remat,
                                               1, n_batches=N1024_PROFILE_STEPS)
            del solver
            free_device_memory()
            pair.append(rec)
            runs.append(launches)
        off, on = pair
        same = (off["batch_terms"] == on["batch_terms"] and off["mean_loss"] == on["mean_loss"]
                and off["digest"] == on["digest"])
        pairs[label] = {"peak_mem_gb": [off["peak_mem_gb"], on["peak_mem_gb"]],
                        "peak_ratio": on["peak_mem_gb"] / off["peak_mem_gb"],
                        "s_per_step": [off["s_per_step"], on["s_per_step"]],
                        "setup_s": [off["setup_s"], on["setup_s"]],
                        "first_batch_loss": [off["first_batch_loss"], on["first_batch_loss"]],
                        "mean_loss": [off["mean_loss"], on["mean_loss"]],
                        "bit_for_bit": same,
                        "launches": {k: v for k, v in off["launches"].items() if v}}
        require(same, f"pso_n1024 {label}: fwd_remat changed the run: {off['mean_loss']} / "
                      f"{on['mean_loss']}, digests {off['digest'][:12]} / {on['digest'][:12]}")
        require(on["peak_mem_gb"] < off["peak_mem_gb"],
                f"pso_n1024 {label}: remat peak {on['peak_mem_gb']} GB not below "
                f"{off['peak_mem_gb']} GB")
    windows_s = time.perf_counter() - t0
    del init
    free_device_memory()
    t1 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    rows = check_patches_at(dev, gen, PSO_NZ, side, side, PSO_N1024,
                            patch_corners(dev, gen, corners, side, side, PSO_N1024),
                            N1024_SHAPES, launches=N1024_ROW_LAUNCHES)
    free_device_memory()
    emit({"phase": "pso_n1024", "card": card, "N": PSO_N1024, "n_patterns": PSO_SCANS,
          "batch": BATCH, "steps": N1024_STEPS, "canvas": side, "pairs": pairs,
          "init_s": init_s, "windows_s": windows_s, "rows_s": time.perf_counter() - t1,
          "seconds": time.perf_counter() - t0, "predicted_s": PREDICTED_S["pso_n1024"]})
    return add_counts(*runs), rows


# -- the far-field exit: the PSO path again, and the carve ----------------------

def far_field_on(fn):
    """fn() with the chain's far-field exit switched on, and off again after."""
    from ptyrad_tpu_torch.ops import chain as C

    C.set_far_field(True)
    try:
        return fn()
    finally:
        C.set_far_field(False)


def pso_ff_path(dev, card: str, init: dict, pso: dict):
    """The pso phase's run on the same data after set_far_field(True): the
    5-slice B5 tail ends in the detector transform, forward and backward.
    The exit changes where the transform runs, not the result: the first
    batch's loss before training must equal the pso phase's at rtol 1e-5.
    From the flat start the dark field of every pattern is rounding residue,
    where loss_single's dp^0.5 is steepest, and Adam amplifies any float32
    rounding difference: one unit in the last place of the initial object
    moves the two losses by 1.7e-4 and 4.1e-3 (H100 80GB HBM3, 700 W). So
    the trajectory is held here only within PSO_FF_FLAT_RTOL, and
    pso_ff_random_start holds the path at rtol 1e-4. Every B5 launch of the
    run must have taken the exit."""
    def run():
        solver, launches, first = run_pso_solver(dev, card, "pso_ff", init, 0.0)
        pso_forward_figure(solver)
        return solver, launches, first

    solver, launches, first = far_field_on(run)
    losses = [v for _, v in solver.history.loss_iters]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, pso["losses"])]
    first_rel = abs(first - pso["first_batch_loss"]) / abs(pso["first_batch_loss"])
    emit({"phase": "pso_ff_vs_pso", "losses": losses, "pso_losses": pso["losses"],
          "rel_diff": rel, "limit": PSO_FF_FLAT_RTOL,
          "first_batch_loss": [first, pso["first_batch_loss"]], "first_batch_rel_diff": first_rel,
          "first_batch_rtol": 1e-5})
    require(first_rel <= 1e-5, f"pso_ff's first loss {first} differs from pso's "
            f"{pso['first_batch_loss']}")
    require(max(rel) <= PSO_FF_FLAT_RTOL, f"pso_ff losses {losses} differ from pso's "
            f"{pso['losses']}: {rel} > {PSO_FF_FLAT_RTOL}")
    for name in PSO_FF_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the pso_ff path")
    for way in ("B5a chain_segment_fwd", "B5b chain_segment_bwd"):
        require(launches[f"{way} (far-field)"] == launches[way],
                f"{way}: {launches[way]} launches on the tail, "
                f"{launches[way + ' (far-field)']} with the exit")
    return solver, launches


def random_object(shape, seed: int) -> np.ndarray:
    """A seeded object that is not flat: amplitude 1 + 0.02 n, phase 0.1 n."""
    rng = np.random.default_rng(seed)
    obj = (1.0 + 0.02 * rng.standard_normal(shape)) * np.exp(0.1j * rng.standard_normal(shape))
    return obj.astype(np.complex64)


def pso_ff_random_start(dev, init: dict) -> dict:
    """The tight gates of the chain kernels at full width: PtyRADSolver.run()
    on the PSO data from a seeded random object, through the kernels with
    the exit off, with it on, and with fwd_fused: false (the plain torch.fft
    chain through cuFFT, no chain kernel). Away from the flat start the run
    does not amplify rounding, so each iteration's loss must agree at rtol
    1e-4 between the kernels and cuFFT (a wrong pass would not pass) and
    between the exit on and off (nor a wrong adjoint of the exit); with the
    exit on every B5 launch must have taken it. Returns the three runs'
    launch counts, summed."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    data = dict(init, obj=random_object(init["obj"].shape, SEED + 5))
    plain_params = copy.deepcopy(PSO_PARAMS)
    plain_params["model_params"]["fwd_fused"] = False

    def run(params=PSO_PARAMS):
        solver = PtyRADSolver(params, init_variables=data, device=dev, verbose=False)
        launches = drive(solver)
        return [v for _, v in solver.history.loss_iters], launches

    off, launches_off = run()
    on, launches_on = far_field_on(run)
    plain, launches_plain = run(plain_params)
    rel = [abs(a - b) / abs(b) for a, b in zip(on, off)]
    rel_plain = [abs(a - b) / abs(b) for a, b in zip(off, plain)]
    emit({"phase": "pso_ff_random_start", "losses_exit_off": off, "losses_exit_on": on,
          "losses_cufft_route": plain, "rel_diff": rel, "rel_diff_kernels_vs_cufft": rel_plain,
          "rtol": 1e-4, "launches_exit_on": launches_on, "launches_cufft_route": launches_plain})
    require(len(on) == len(off) == len(plain) == PSO_NITER and all(np.isfinite(on + off + plain)),
            f"pso_ff_random_start: losses {off}, {on}, {plain}")
    require(max(rel_plain) <= 1e-4, f"from a random start the kernels' losses {off} differ from "
            f"the cuFFT route's {plain}: {rel_plain} > 1e-4")
    require(max(rel) <= 1e-4, f"from a random start the exit's losses {on} differ from "
            f"{off}: {rel} > 1e-4")
    for way in ("B5a chain_segment_fwd", "B5b chain_segment_bwd"):
        require(launches_off[f"{way} (far-field)"] == 0, f"{way} took the exit while it was off")
        require(0 < launches_on[way] == launches_on[f"{way} (far-field)"],
                f"{way}: {launches_on[way]} launches on the tail, "
                f"{launches_on[way + ' (far-field)']} with the exit")
    for name in CHAIN_KERNELS:
        require(launches_off[name] > 0 and launches_plain[name] == 0,
                f"{name}: {launches_off[name]} launches through the kernels, "
                f"{launches_plain[name]} with fwd_fused off")
    require(launches_plain[PLAIN_ROUTE] > 0 == launches_off[PLAIN_ROUTE],
            "fwd_fused: false did not take the plain route, or the kernel run did")
    return add_counts(launches_off, launches_on, launches_plain)


def carve_check(dev, init: dict) -> dict:
    """One forward() with gradients at nz = 16, a multiple of sg = 8, with
    the exit on and an optimizable slice thickness: the dispatcher carves a
    full tail segment off B6, which runs S = 1 segment, and B5 takes the
    exit with dH. dp and the gradients of obja, objp, the probe and H (the
    kernels' own dH, kept with retain_grad) against the plain multislice_dp
    on the same CUDA tensors, each within 1e-4 of its largest entry. Returns
    the kernel route's launch counts."""
    from ptyrad_tpu_torch.models import (compute_propagators, forward, forward_route,
                                         get_obj_patches, get_probes, make_model, multislice_dp)
    F = importlib.import_module("ptyrad_tpu_torch.models.forward")
    from ptyrad_tpu_torch.ops import chain as C

    nz = 2 * PSO_SG
    data = dict(init, obj=random_object((1, nz, *init["obj"].shape[2:]), SEED + 3))
    mp = {"update_params": {"slice_thickness": {"lr": 1e-4}}}
    idx = torch.arange(0, PSO_SCANS, PSO_SCANS // BATCH, device=dev)
    w = torch.rand((BATCH, PSO_NPIX, PSO_NPIX), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(SEED))
    held = []

    def keep_h(*args):
        h = compute_propagators(*args)
        h.retain_grad()
        held.append(h)
        return h

    def run(kernels: bool):
        params, buffers, geom = make_model(data, mp, dev)
        for name in ("obja", "objp", "probe", "slice_thickness"):
            getattr(params, name).requires_grad_(True)
        held.clear()
        if kernels:
            require(forward_route(params, geom, idx) == "chain", "forward() left the chain route")
            F.compute_propagators = keep_h  # forward() looks it up at call time
            try:
                dp, _ = far_field_on(lambda: forward(params, buffers, geom, idx))
            finally:
                F.compute_propagators = compute_propagators
        else:
            obja_p, objp_p = get_obj_patches(params, buffers, geom, idx)
            dp = multislice_dp(obja_p, objp_p, get_probes(params, geom, idx),
                               keep_h(params, buffers, geom, idx), buffers.omode_occu,
                               eps=geom.eps)
        (w * dp).sum().backward()
        return dp.detach(), {"obja": params.obja.grad, "objp": params.objp.grad,
                             "probe": params.probe.grad, "H": held[0].grad}

    (dp_k, g_k), launches = counted(lambda: run(True))
    dp_p, g_p = run(False)
    names = sorted(g_p)
    (e_dp,), (t_dp,) = _grad_errs([dp_k], [dp_p])
    errs, tols = _grad_errs([g_k[n] for n in names], [g_p[n] for n in names])
    emit({"phase": "far_field_carve", "nz": nz, "sg": C.best_sg(nz), "S": nz // PSO_SG - 1,
          "batch": BATCH, "max_abs_err": e_dp, "tolerance": t_dp, "grad_names": names,
          "grad_max_abs_err": errs, "grad_tolerance": tols, "launches": launches})
    require(bool(torch.isfinite(dp_k).all()) and e_dp <= t_dp,
            f"the carved route differs from the plain version: {e_dp} > {t_dp}")
    for name, e, t in zip(names, errs, tols):
        require(e <= t, f"the carved route's gradient of {name} differs: {e} > {t}")
    for name in ("B6a chain_stack_fwd", "B6b chain_stack_bwd", "B6b chain_stack_bwd (dH)",
                 "B5a chain_segment_fwd", "B5a chain_segment_fwd (far-field)",
                 "B5b chain_segment_bwd", "B5b chain_segment_bwd (far-field, dH)"):
        require(launches[name] == 1, f"the carved route launched {name} {launches[name]} times")
    return launches


def route_case(n: int, rng) -> dict:
    """The fused route check's case at N: init_variables (a seeded random
    object, 6 probe modes, 6 slices, a batch of 32 shifted probes, 32
    patterns), model_params and the weights of the summed dp, drawn from
    ``rng``."""
    from ptyrad_tpu_torch.physics import (electron_wavelength, make_mixed_probe,
                                          make_stem_probe, near_field_evolution)

    lam = electron_wavelength(80.0)
    canvas = n + 64
    probe = make_stem_probe({"kv": 80.0, "conv_angle": 24.9, "Npix": n, "dx": 0.1494})
    init = {
        "obj": random_object((1, NZ, canvas, canvas), SEED + n),
        "probe": make_mixed_probe(probe, PMODE, [0.02]),
        "probe_pos_shifts": (0.3 * rng.standard_normal((BATCH, 2))).astype(np.float32),
        "obj_tilts": np.zeros((1, 2), np.float32), "slice_thickness": 2.0,
        "H": near_field_evolution((n, n), 0.1494, 2.0, lam),
        "measurements": np.zeros((1, n, n), np.float32),
        "crop_pos": rng.integers(0, canvas - n, (BATCH, 2)).astype(np.int32),
        "omode_occu": np.ones(1, np.float32), "dx": 0.1494, "lambd": lam,
        "N_scan_slow": BATCH, "N_scan_fast": 1,
    }
    mp = {"update_params": {"probe_pos_shifts": {"lr": 1e-4}}}
    w = torch.from_numpy(rng.random((BATCH, n, n)).astype(np.float32))
    init["measurements"] = (rng.random((BATCH, n, n)) * 2.0 / (n * n)).astype(np.float32)
    return {"init": init, "mp": mp, "w": w}


def fused_route_check(dev) -> dict:
    """The fused route at N = 96 and 120 (not powers of two: the mixed-radix
    pair) and, with fwd_fused: false, the plain torch.fft chain at the same
    cases, each on the card against the CPU (whose fused route runs the
    kernels' plain versions): forward() (B4a, B4b under autograd) and the
    loss_single data term through fused_loss_terms (B3a, B3b), a batch of 32
    with 6 probe modes, 6 slices and shifted probes from a seeded random
    object; dp, the loss and every gradient within 1e-4 of each largest
    entry (the tolerance of the B4 tests). The patches go through B1/B2 on
    both routes. Returns the card runs' launch counts."""
    from ptyrad_tpu_torch.models import forward, forward_route, fused_loss_terms, make_model

    loss_params = {"loss_single": {"state": True, "weight": 1.0, "dp_pow": 0.5}}
    rng = np.random.default_rng(SEED + 6)
    runs = []
    for n in NPO2_NS:
        case = route_case(n, rng)
        init, w = case["init"], case["w"]
        for fused in (True, False):
            mp = {**case["mp"], "fwd_fused": fused}
            route = "fused" if fused else "plain"

            def run(where):
                params, buffers, geom = make_model(init, mp, where)
                for _, t in params.named():
                    t.requires_grad_(True)
                idx = torch.arange(BATCH, device=where)
                require(forward_route(params, geom, idx) == route,
                        f"N = {n} left the {route} route")
                dp, _ = forward(params, buffers, geom, idx)
                (w.to(where) * dp).sum().backward()
                out = [dp.detach().cpu()], {k: t.grad.cpu() for k, t in params.named()
                                            if t.grad is not None}
                if fused:
                    for _, t in params.named():
                        t.grad = None
                    total = fused_loss_terms(params, buffers, geom, idx, None, loss_params)[0]
                    total.backward()
                    out[0].append(total.detach().cpu().reshape(1))
                    out[1].update({"loss " + k: t.grad.cpu() for k, t in params.named()
                                   if t.grad is not None})
                return out

            (vals_k, g_k), launches = counted(lambda: run(dev))
            vals_c, g_c = run(torch.device("cpu"))
            names = sorted(g_c)
            errs_v, tols_v = _grad_errs(vals_k, vals_c)
            errs, tols = _grad_errs([g_k[k] for k in names], [g_c[k] for k in names])
            emit({"phase": "forward_fused_route" if fused else "forward_plain_route", "N": n,
                  "batch": BATCH, "pmode": PMODE, "nz": NZ,
                  "finite": bool(torch.isfinite(vals_k[0]).all()),
                  "values": ["dp", "loss"][:len(vals_k)], "max_abs_err_vs_cpu": errs_v,
                  "tolerance": tols_v, "grad_names": names, "grad_max_abs_err": errs,
                  "grad_tolerance": tols, "launches": launches})
            want = {"obja", "objp", "probe", "probe_pos_shifts"}
            want |= {"loss " + k for k in want} if fused else set()
            require(set(names) == want and set(g_k) == set(g_c),
                    f"N = {n}: gradients reached {sorted(g_k)} and {names}")
            require(bool(torch.isfinite(vals_k[0]).all()), f"N = {n}: dp is not finite")
            for v, e, t in zip(["dp", "loss"], errs_v, tols_v):
                require(e <= t, f"N = {n} ({route}): {v} on the card differs from the CPU: "
                        f"{e} > {t}")
            for k, e, t in zip(names, errs, tols):
                require(e <= t, f"N = {n} ({route}): the gradient of {k} differs from the "
                        f"CPU's: {e} > {t}")
            for k in ("B1 gather_patches", "B2 scatter_add_patches"):
                require(launches[k] > 0, f"N = {n}: {k} did not gather the patches")
            ours = [f"B4a dp_fwd (N={n})", f"B4b dp_bwd (N={n})", f"B3a loss_sums_fwd (N={n})",
                    f"B3b loss_sums_bwd (N={n})"]
            if fused:
                require(launches[PLAIN_ROUTE] == 0 and all(launches[k] == 1 for k in ours),
                        f"N = {n}: the fused route's launches {launches}")
            else:
                require(launches[PLAIN_ROUTE] == 1,
                        f"N = {n}: {launches[PLAIN_ROUTE]} plain routes")
                for k in ("B3a loss_sums_fwd", "B4a dp_fwd", "B4b dp_bwd") + CHAIN_KERNELS:
                    require(launches[k] == 0, f"N = {n}: {k} ran on the plain route")
            runs.append(launches)
    return add_counts(*runs)


# -- the measurement store and the constraints -----------------------------------

TBL_STORE_DTYPE = "bfloat16"


def tbl_store_dataset(init: dict) -> dict:
    """The tBL patterns binned 2 x 2 on the host to 64^2, as a detector
    read out at half the sampling hands them over, with the scale factors
    that resample them back to the probe's 128^2 on the fly."""
    from ptyrad_tpu_torch.initialization import meas_resample_on_the_fly

    meas = init["measurements"].cpu().numpy()
    half = NPIX // 2
    binned = meas.reshape(N_SCANS, half, 2, half, 2).sum(axis=(2, 4))
    factors, npix = meas_resample_on_the_fly(binned, (2, 2))
    require(npix == NPIX, f"the resampled patterns would be {npix} wide")
    return dict(init, measurements=binned, on_the_fly_meas_scale_factors=factors)


def tbl_store_path(dev, card: str, data: dict):
    """The tBL reconstruction from a reduced measurement store: 64^2
    patterns stored as bfloat16, each batch upcast and resampled bilinearly
    by (2, 2) with its intensity conserved, trained through B3."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    params = copy.deepcopy(TBL_PARAMS)
    params["model_params"]["meas_dtype"] = TBL_STORE_DTYPE
    params["recon_params"]["NITER"] = SIDE_NITER
    torch.cuda.reset_peak_memory_stats()
    solver = PtyRADSolver(params, init_variables=data, device=dev, verbose=True)
    store = solver.buffers.measurements
    t1 = time.perf_counter()
    launches = drive(solver)
    run_s = time.perf_counter() - t1
    losses = [v for _, v in solver.history.loss_iters]
    times = solver.history.iter_times
    emit({
        "phase": "tbl_store", "card": card, "n_patterns": N_SCANS, "batch": BATCH,
        "store_dtype": str(store.dtype), "store_shape": list(store.shape),
        "store_bytes": store.numel() * store.element_size(),
        "float32_128_bytes": N_SCANS * NPIX * NPIX * 4,
        "scale_factors": list(solver.geom.meas_scale_factors),
        "iterations": len(losses), "losses": losses, "iter_s": times,
        "patterns_per_s": [N_SCANS / t for t in times], "run_s": run_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches,
    })
    require(store.dtype == torch.bfloat16 and tuple(store.shape[-2:]) == (NPIX // 2, NPIX // 2),
            f"the store is {store.dtype} {tuple(store.shape)}")
    require(len(losses) == SIDE_NITER and all(np.isfinite(losses)),
            f"tbl_store: loss not finite: {losses}")
    require(losses[-1] < losses[0], f"tbl_store: loss did not fall: {losses}")
    steps = SIDE_NITER * -(-N_SCANS // BATCH)
    for name in ("B3a loss_sums_fwd", "B3b loss_sums_bwd"):
        require(launches[name] == steps, f"tbl_store: {name} ran {launches[name]} times in "
                f"{steps} steps")
    return solver, launches


def constraints_check(dev) -> None:
    """All twelve constraints, at their default options, applied once to a
    tBL-sized model (the simulation's object with a varying amplitude, probe
    modes of distinct powers, the per-position tilt field) on the card and
    on the CPU: finite, and each parameter within 1e-4 of its largest entry
    (float32 transforms and blurs on two devices). ortho_pmode leaves each
    mode's phase free, so the probe is compared by its mode powers and its
    incoherent intensity sum_m |p_m|^2."""
    from ptyrad_tpu_torch.constraints import DEFAULT_CONSTRAINT_PARAMS, ConstraintScheduler
    from ptyrad_tpu_torch.models import make_model
    from ptyrad_tpu_torch.physics import make_mixed_probe, make_stem_probe

    every = {name: {"freq": 1} for name in DEFAULT_CONSTRAINT_PARAMS}
    init = tbl_init()
    rng = np.random.default_rng(SEED + 4)
    amp = 1.0 + 0.03 * rng.standard_normal(init["obj"].shape).astype(np.float32)
    probe = make_stem_probe({"kv": 80.0, "conv_angle": 24.9, "Npix": NPIX, "dx": 0.1494})
    init.update(obj=(amp * init["obj"]).astype(np.complex64), obj_tilts=tilt_field(),
                probe=make_mixed_probe(probe, PMODE, [0.05, 0.04, 0.03, 0.02, 0.01]))
    out = {}
    for where in (dev, torch.device("cpu")):
        params, buffers, geom = make_model(init, None, where)
        sched = ConstraintScheduler(every, geom)
        require(len(sched.active_names) == 12, f"{sched.active_names} are active")
        sched(params, buffers, 1)
        got = {n: t.detach().cpu() for n, t in params.named() if n != "probe"}
        power = (params.probe.detach().abs() ** 2).cpu()
        got.update(probe_mode_power=power.sum(dim=(-2, -1)), probe_intensity=power.sum(0))
        out[where.type] = got
    names = sorted(out["cpu"])
    errs, tols = _grad_errs([out["cuda"][n] for n in names], [out["cpu"][n] for n in names])
    emit({"phase": "constraints", "applied": sched.active_names, "names": names,
          "finite": all(bool(torch.isfinite(t).all()) for t in out["cuda"].values()),
          "max_abs_err_vs_cpu": errs, "tolerance": tols})
    for name, e, t in zip(names, errs, tols):
        require(bool(torch.isfinite(out["cuda"][name]).all()), f"constraints: {name} not finite")
        require(e <= t, f"constraints: {name} differs from the CPU's: {e} > {t}")


# -- the tilt paths: optimizable slice thickness and crystal tilts -----------------

DZ_TILT_UPDATE = {"obj_tilts": {"start_iter": 1, "lr": 1.0e-4},
                  "slice_thickness": {"start_iter": 1, "lr": 1.0e-4}}


def with_dz_tilts(params: dict, constraints: dict | None = None) -> dict:
    """A copy of a configuration with obj_tilts and slice_thickness
    optimized from iteration 1 at lr 1e-4 (the rates of
    tests/test_forward.py:1164-1167), plus extra constraints."""
    out = copy.deepcopy(params)
    out["model_params"]["update_params"].update(copy.deepcopy(DZ_TILT_UPDATE))
    out["constraint_params"].update(constraints or {})
    return out


def tilt_field() -> np.ndarray:
    """A smooth per-position tilt field over the tBL raster, within +-1 mrad
    (tilt_y, tilt_x)."""
    ys, xs = np.meshgrid(np.arange(N_SIDE), np.arange(N_SIDE), indexing="ij")
    ty = 0.8 * np.sin(2 * np.pi * ys / N_SIDE) * np.cos(np.pi * xs / N_SIDE)
    tx = 0.6 * np.cos(2 * np.pi * xs / N_SIDE) + 0.2 * np.sin(np.pi * ys / N_SIDE)
    return np.stack([ty.ravel(), tx.ravel()], -1).astype(np.float32)


def run_tilt_solver(dev, card: str, phase: str, params: dict, init: dict, setup_s: float,
                    niter: int):
    """PtyRADSolver.run() with the counts set to 0 just before it; asserts a
    finite, falling loss and that dz and the tilts moved."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    solver = PtyRADSolver(params, init_variables=init, device=dev, verbose=True)
    tilts0 = solver.params.obj_tilts.detach().clone()
    dz0 = float(solver.params.slice_thickness.detach())
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    launches = drive(solver)
    run_s = time.perf_counter() - t1
    losses = [v for _, v in solver.history.loss_iters]
    times = solver.history.iter_times
    n = solver.buffers.measurements.shape[0]
    tilt_moved = float((solver.params.obj_tilts.detach() - tilts0).abs().max())
    emit({
        "phase": phase, "card": card, "n_patterns": n, "batch": BATCH,
        "iterations": len(losses), "losses": losses, "iter_s": times,
        "patterns_per_s": [n / t for t in times], "setup_s": setup_s, "run_s": run_s,
        "dz": [dz0] + [v for _, v in solver.history.dz_iters],
        "avg_tilt": [np.asarray(v).tolist() for _, v in solver.history.avg_tilt_iters],
        "tilt_max_change": tilt_moved,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches,
    })
    require(len(losses) == niter and all(np.isfinite(losses)), f"{phase}: loss not finite")
    require(losses[-1] < losses[0], f"{phase}: loss did not fall: {losses}")
    require(solver.history.dz_iters[-1][1] != dz0, f"{phase}: dz did not move")
    require(tilt_moved > 0.0, f"{phase}: the tilts did not move")
    return solver, launches


def tilt_path(dev, card: str):
    """The tBL reconstruction with per-position tilts: 16,384 patterns
    simulated through forward() with tilt_field() (B4a on a per-position H),
    reconstructed from zero tilts with obj_tilts (16,384 x 2) and
    slice_thickness optimized and tilt_smooth, the yml otherwise, 2
    iterations. The simulation and the run are driven under counted():
    B4a on a per-position H, B1, B2, B3a on a per-position H and B3b with
    dH must run, B4b must not; then one batch's dz and tilt gradients and dH
    through B3 against the plain route."""
    t0 = time.perf_counter()
    init = tbl_init()
    init["obj_tilts"] = tilt_field()
    init["measurements"], sim_launches = counted(lambda: simulate(dev, init))
    init.update(obj=np.ones_like(init["obj"]), obj_tilts=np.zeros((N_SCANS, 2), np.float32))
    setup_s = time.perf_counter() - t0
    params = with_dz_tilts(TBL_PARAMS, {"tilt_smooth": {"freq": 1, "std": 2.0}})
    params["recon_params"]["NITER"] = SIDE_NITER
    solver, launches = run_tilt_solver(dev, card, "tilt", params, init, setup_s, SIDE_NITER)
    launches = add_counts(sim_launches, launches)
    require(not solver.geom.global_tilt, "the tilt path runs one global tilt")
    for name in TILT_KERNELS + ("B4a dp_fwd (per-position H)",):
        require(launches[name] > 0, f"kernel {name} was not launched on the tilt path")
    for name in ("B4b dp_bwd", "B5a chain_segment_fwd", "B6b chain_stack_bwd"):
        require(launches[name] == 0, f"kernel {name} ran on the tilt path")
    tilt_gradients_check(solver)
    return solver, launches


def tilt_gradients_check(solver) -> None:
    """On the first batch of the trained state: s1 of the loss-folded chain
    through B3 (per-position H, dH) and through its plain version on the
    same CUDA tensors, dH within 1e-4 of its largest entry; the dz and tilt
    gradients through scalar_grads_check against the plain version in
    float64 on the CPU."""
    from ptyrad_tpu_torch.models import compute_propagators, get_measurements, get_obj_patches
    from ptyrad_tpu_torch.ops import fused_multislice as M
    from ptyrad_tpu_torch.ops.fourier import ifftshift2
    from ptyrad_tpu_torch.ops.shift import fourier_shift_kspace

    p, bufs, geom = solver.params, solver.buffers, solver.geom
    idx = torch.as_tensor(solver.batch_idx[0], device=solver.device)
    mask = torch.as_tensor(solver.batch_mask[0], device=solver.device)
    with torch.no_grad():
        obja_p, objp_p = get_obj_patches(p, bufs, geom, idx)
        probe = (fourier_shift_kspace(p.probe, p.probe_pos_shifts[idx]) if geom.shift_probes
                 else p.probe[None])
        meas_cc = ifftshift2(get_measurements(bufs, geom, idx))
    out = {}
    p64, b64 = float64_cpu(p, bufs)
    for route in ("kernels", "plain", "float64"):
        model, bb, at, ops = p, bufs, idx, (obja_p, objp_p, probe)
        if route == "float64":
            model, bb, at = p64, b64, idx.cpu()
            ops = (obja_p.cpu().double(), objp_p.cpu().double(), probe.cpu().to(torch.complex128))
        model.slice_thickness.grad = model.obj_tilts.grad = None
        h = compute_propagators(model, bb, geom, at)
        h.retain_grad()
        rest = (meas_cc, mask) if route != "float64" else (meas_cc.cpu().double(),
                                                           mask.cpu().double())
        args = (*ops, h, *rest, 0.5, geom.eps)
        s1 = (M.multislice_loss_sums_fused(*args, probe_kspace=geom.shift_probes)
              if route == "kernels" else M.loss_sums_plain(*args, geom.shift_probes))[0]
        s1.backward()
        out[route] = (h.grad, model.slice_thickness.grad.clone(), model.obj_tilts.grad[at].clone())
    (e_dh,), (t_dh,) = _grad_errs(out["kernels"][:1], out["plain"][:1])
    emit({"phase": "tilt_gradients", "batch": len(idx), "dh_max_abs_err": e_dh,
          "dh_tolerance": t_dh})
    require(e_dh <= t_dh, f"tilt path dH differs from the plain route: {e_dh} > {t_dh}")
    scalar_grads_check("tilt path", ("slice_thickness", "obj_tilts"), *(
        out[r][1:] for r in ("kernels", "plain", "float64")))
    p.slice_thickness.grad = p.obj_tilts.grad = None


def pso_tilt_path(dev, card: str):
    """The PSO reconstruction with a global tilt: the data simulated at
    (1.0, -0.5) mrad, reconstructed from (0, 0) with obj_tilts (1 x 2) and
    slice_thickness (10 Ang) optimized, 2 iterations. B5b and B6b must run
    with dH, B3 must not."""
    t0 = time.perf_counter()
    init = pso_dataset(dev, tilt=(1.0, -0.5))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    solver, launches = run_tilt_solver(dev, card, "pso_tilt", with_dz_tilts(PSO_PARAMS), init,
                                       setup_s, PSO_NITER)
    require(solver.geom.global_tilt, "the PSO tilt path runs per-position tilts")
    for name in PSO_TILT_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the PSO tilt path")
    for name in ("B3a loss_sums_fwd", "B3b loss_sums_bwd", "B4a dp_fwd", "B4b dp_bwd"):
        require(launches[name] == 0, f"kernel {name} ran on the PSO tilt path (N = 256)")
    return solver, launches


def profile_steps(solver, card: str, path: str, niter: int, n_batches: int):
    """Where a training step's time goes: torch.profiler over n_batches steps
    of the solver's own epoch function (after the path's run, so its launches
    are not counted there). Device time by kernel, the device's busy share of
    the window's wall time, and the host time per step. Returns the record
    it prints."""
    from torch.profiler import ProfilerActivity, profile

    dev = solver.device
    idx = torch.as_tensor(solver.batch_idx[:n_batches], device=dev)
    mask = torch.as_tensor(solver.batch_mask[:n_batches], device=dev)
    solver.train_epoch(idx[:2], mask[:2], niter)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.train_epoch(idx, mask, niter)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side kernels only: the host ops that launched them carry the same
    # device time again, and a user annotation (e.g. Optimizer.step) spans
    # its kernels and the gaps between them
    rows = [(e.self_device_time_total / 1e3, e.count, e.key[:70])
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    # B1 and B2 by their kernels' names in csrc/patches.cu, and every memset
    # (a B2 of the parent design zeroed its canvas with one)
    patch_ms = {item: sum(ms for ms, _, k in rows if k.startswith(match)) / n_batches if rows
                else "not measured"
                for item, match in (("B1", "(anonymous namespace)::gather_kernel("),
                                    ("B2", "(anonymous namespace)::scatter_add_kernel("),
                                    ("memset", "Memset"))}
    out = {"phase": "profile", "path": path, "card": card, "steps": n_batches,
           "wall_ms": wall_ms, "ms_per_step": wall_ms / n_batches,
           "device_busy_ms": busy_ms if rows else "not measured",
           "device_ms_per_step": busy_ms / n_batches if rows else "not measured",
           "device_busy_share": busy_ms / wall_ms if rows else "not measured",
           "patches_device_ms_per_step": patch_ms,
           "top_device_ms": [{"kernel": k, "calls": c, "ms": ms} for ms, c, k in rows[:12]]}
    emit(out)
    return out


# -- the bfloat16 compute policy (A8) ---------------------------------------------

# Bfloat16 rounding amplifies float32 differences: where two float32
# transforms of one operand differ in the last bits across a rounding
# boundary, the next rounding makes it a whole bfloat16 step, which the next
# pass spreads over its line (tests/test_torch_bf16.py
# test_rounding_amplifies_float32_differences). A kernel and its torch.fft
# twin that round at the same points therefore agree to a few percent of the
# policy's own error after one 2-D transform and part by about that error
# after a few propagations. So each bf16 row compares errors, for every
# output (L2 norms over the whole tensor): the kernel's own bfloat16 error
# e_K = |K16 - K32| / |K32| against its twin's e_T = |T16 - T32| / |T32|
# within BF16_RATIO_TOL (a kernel that rounds elsewhere, less or not at all
# moves it), and the kernel within BF16_TWIN_FACTOR e_T of its twin (the CPU
# tests' rule against the JAX package). At two passes, before the drift,
# the kernel must be within BF16_SHALLOW of its own error of its twin.
BF16_RATIO_TOL = 0.1
BF16_TWIN_FACTOR = 2.0
BF16_SHALLOW = 0.1
BF16_TOLERANCE = (f"|e_K / e_T - 1| <= {BF16_RATIO_TOL} and |K16 - T16| <= {BF16_TWIN_FACTOR} "
                  "e_T |T32| for every output (L2)")
MP_CORR_TOL = 0.005   # how far the bf16 runs' phase correlation may fall below float32's
MP_LOSS_RTOL = 0.02   # their final states' loss through the float32 forward
# The JAX policy's own gate (tests/test_forward.py TestComputeDtypePolicy)
# runs on data with Poisson noise at 1e5 counts a pattern: on noiseless data
# float32 converges below bfloat16's rounding floor, and a loss gate then
# measures the floor (test_bf16_policy_converges_like_f32's docstring).
MP_COUNTS = 1e5


def _l2(t: torch.Tensor) -> float:
    t = t.detach()
    return float(torch.linalg.vector_norm(t.to(torch.complex128 if t.is_complex()
                                                else torch.float64)))


def bf16_errors(k16, k32, t16, t32) -> list:
    """Per output: e_kernel, e_twin, kernel_to_twin (|K16 - T16| / |T32|) and
    max_abs (max |K16 - T16|)."""
    out = []
    for a, b, c, d in zip(k16, k32, t16, t32):
        nd = _l2(d)
        out.append({"e_kernel": _l2(a - b) / _l2(b), "e_twin": _l2(c - d) / nd,
                    "kernel_to_twin": _l2(a - c) / nd, "max_abs": float((a - c).abs().max())})
    return out


def bf16_failures(label: str, names, errs, shallow: bool = False) -> list:
    """The gates of one bf16 comparison (see BF16_RATIO_TOL); shallow: the
    two-pass gate, kernel_to_twin <= BF16_SHALLOW e_kernel."""
    bad = []
    for nm, e in zip(names, errs):
        e["ratio"] = e["e_kernel"] / e["e_twin"] if e["e_twin"] else float("inf")
        if not e["e_twin"] > 1e-4:
            bad.append(f"{label} {nm}: the twin did not round (e_T {e['e_twin']})")
        if shallow:
            if e["kernel_to_twin"] > BF16_SHALLOW * e["e_kernel"]:
                bad.append(f"{label} {nm}: {e['kernel_to_twin']} from its twin at two passes, "
                           f"over {BF16_SHALLOW} of its bf16 error {e['e_kernel']}")
        else:
            if abs(e["ratio"] - 1.0) > BF16_RATIO_TOL:
                bad.append(f"{label} {nm}: e_K / e_T = {e['ratio']} (e_K {e['e_kernel']}, "
                           f"e_T {e['e_twin']})")
            if e["kernel_to_twin"] > BF16_TWIN_FACTOR * e["e_twin"]:
                bad.append(f"{label} {nm}: {e['kernel_to_twin']} from its twin, over "
                           f"{BF16_TWIN_FACTOR} e_T = {BF16_TWIN_FACTOR * e['e_twin']}")
    return bad


def _twin_vjp(fn, inputs, cot):
    """(the cotangents of ``inputs`` of fn(*inputs) for ``cot``, a timer of
    that backward), through autograd on fresh leaves."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)

    def again():
        return torch.autograd.grad(out, leaves, grad_outputs=cot, retain_graph=True)

    return again(), again


def check_bf16_kernels(dev, gen, f32_rows: list) -> list:
    """The bf16-operand kernels (csrc/multislice_bf16.cu, csrc/chain_bf16.cu)
    at the main paths' shapes, each against its plain twin with
    bf16_operands on the same inputs (the gates of BF16_RATIO_TOL), B3b and
    B4b run twice bit for bit; each row's kernel and twin timed with CUDA
    events beside the float32 kernel (f32_ms), with the float32 row's bound
    and library time (the same bytes and operations; no library call rounds
    its operands). Then the two-pass checks: B4a at one slice with a shared
    real-space probe and B5a/B5b at one slice with the far-field exit."""
    from ptyrad_tpu_torch.ops import chain as C
    from ptyrad_tpu_torch.ops import fused_multislice as M
    from ptyrad_tpu_torch.ops.shift import fourier_shift, fourier_shift_kspace
    from ptyrad_tpu_torch.physics import electron_wavelength, near_field_evolution

    f32 = {r["name"]: r for r in f32_rows}
    rows, failures = [], []
    ms_src = "ptyrad_tpu_torch/csrc/multislice_bf16.cu"
    ch_src = "ptyrad_tpu_torch/csrc/chain_bf16.cu"

    def row(name, base, source, names, kern, twin, repeat=False, note=""):
        """kern(bf16) and twin(bf16) -> (outputs, a timer of the call)"""
        k16, time_k16 = kern(True)
        k32, time_k32 = kern(False)
        t16, time_t16 = twin(True)
        t32 = twin(False)[0]
        errs = bf16_errors(k16, k32, t16, t32)
        bad = bf16_failures(name, names, errs)
        rep = None
        if repeat:
            rep = repeats_bitwise(lambda: kern(True)[0], k16)
            if not rep:
                bad.append(f"{name}: run twice differs")
        ref = f32[base]
        r = {"name": name, "route": "cuda", "source": source, "replaces": ref["replaces"],
             "max_abs_err": max(e["max_abs"] for e in errs), "ms": time_ms(time_k16),
             "plain_ms": time_ms(time_t16), "bound_ms": ref["bound_ms"],
             "bound_by": ref["bound_by"], "library_ms": ref["library_ms"]}
        emit({"phase": "kernel", **r, "f32_ms": time_ms(time_k32), "f32_row": base,
              "outputs": names, "errors": errs, "tolerance": BF16_TOLERANCE,
              "repeats_bitwise": rep, "note": note})
        rows.append(r)
        failures.extend(bad)

    # -- tBL shapes: B3 and B4 (check_loss_chain's inputs) --
    n = NPIX
    lam = electron_wavelength(80.0)
    probe = torch.as_tensor(tbl_probe(), device=dev)
    h = torch.as_tensor(near_field_evolution((n, n), 0.1494, 2.0, lam), device=dev)[None]
    h_each = tilted_h(h, 2.0 * torch.rand((BATCH, 2), generator=gen, device=dev) - 1.0,
                      0.1494, 2.0)
    obja = 1.0 + 0.05 * torch.randn((BATCH, 1, NZ, n, n), generator=gen, device=dev)
    objp = 0.1 * torch.randn((BATCH, 1, NZ, n, n), generator=gen, device=dev)
    pr = fourier_shift_kspace(probe, 0.3 * torch.randn((BATCH, 2), generator=gen, device=dev))
    meas = torch.rand((BATCH, n, n), generator=gen, device=dev) * 2e-4
    mask = torch.ones(BATCH, device=dev)
    mask[BATCH - 1] = 0.0
    g = torch.randn((BATCH, n, n), generator=gen, device=dev)
    p, eps, cvec = 0.5, 1e-10, torch.tensor(0.7, device=dev)
    loss_args = (meas, mask, p, eps, True)

    def b3a(bf16):
        def call():
            return M.loss_sums_fwd_cuda(obja, objp, pr, h, *loss_args, bf16_operands=bf16)
        return (call()[2],), call

    def b3a_twin(bf16):
        with torch.no_grad():
            dp = M.multislice_dp_plain(obja, objp, pr, h, True, bf16)
        return (dp,), lambda: M.loss_sums_plain(obja, objp, pr, h, *loss_args, bf16)

    def b3b(hh, dh):
        def kern(bf16):
            dp = M.loss_sums_fwd_cuda(obja, objp, pr, hh, *loss_args, bf16_operands=bf16)[2]

            def call():
                out = M.loss_sums_bwd_cuda(obja, objp, pr, hh, meas, mask, dp, cvec, p, eps,
                                           True, need_dh=dh, bf16_operands=bf16)
                return out if dh else out[:3]
            return call(), call

        def twin(bf16):
            ins = (obja, objp, pr, hh) if dh else (obja, objp, pr)
            return _twin_vjp(lambda a, ph, q, *hx: M.loss_sums_plain(
                a, ph, q, hx[0] if hx else hh, *loss_args, bf16)[0], ins, cvec)
        return kern, twin

    row("B3a loss_sums_fwd (bf16)", "B3a loss_sums_fwd", ms_src, ["dp"], b3a, b3a_twin,
        note="tBL shapes, per-position probe spectra: the main path's case")
    row("B3b loss_sums_bwd (bf16)", "B3b loss_sums_bwd", ms_src, ["d obja", "d objp", "d probe"],
        *b3b(h, False), repeat=True, note="tBL shapes, per-position probe spectra")
    row("B3b loss_sums_bwd (bf16, dH)", "B3b loss_sums_bwd (dH)", ms_src,
        ["d obja", "d objp", "d probe", "d h"], *b3b(h_each, True), repeat=True,
        note="tBL shapes, per-position spectra and H (tilts within 1 mrad)")

    def b4a(bf16):
        def call():
            return M.dp_fwd_cuda(obja, objp, pr, h, True, bf16)
        return (call(),), call

    def b4a_twin(bf16):
        def call():
            return M.multislice_dp_plain(obja, objp, pr, h, True, bf16)
        with torch.no_grad():
            return (call(),), call

    def b4b(bf16):
        def call():
            return M.dp_bwd_cuda(obja, objp, pr, h, g, True, bf16_operands=bf16)[:3]
        return call(), call

    def b4b_twin(bf16):
        return _twin_vjp(lambda a, ph, q: M.multislice_dp_plain(a, ph, q, h, True, bf16),
                         (obja, objp, pr), g)

    row("B4a dp_fwd (bf16)", "B4a dp_fwd", ms_src, ["dp"], b4a, b4a_twin,
        note="tBL shapes, per-position probe spectra: the low-dose path's case")
    row("B4b dp_bwd (bf16)", "B4b dp_bwd", ms_src, ["d obja", "d objp", "d probe"], b4b,
        b4b_twin, repeat=True, note="tBL shapes, per-position probe spectra")

    # two passes: B4a at one slice on the shared real-space probe
    a1, p1 = obja[:, :, :1].contiguous(), objp[:, :, :1].contiguous()
    k16, k32 = (M.dp_fwd_cuda(a1, p1, probe[None], h, False, b) for b in (True, False))
    with torch.no_grad():
        t16, t32 = (M.multislice_dp_plain(a1, p1, probe[None], h, False, b)
                    for b in (True, False))
    shallow = [("B4a dp_fwd (bf16), one slice", ["dp"], bf16_errors([k16], [k32], [t16], [t32]))]
    del obja, objp, pr, meas, h_each, k16, k32, t16, t32
    torch.cuda.empty_cache()

    # -- PSO shapes: B5 and B6 (check_chain's inputs) --
    n, b = PSO_NPIX, BATCH
    lam = electron_wavelength(PSO_KV)
    h = torch.as_tensor(near_field_evolution((n, n), PSO_DX, PSO_DZ, lam), device=dev)[None]
    psi = fourier_shift(torch.as_tensor(pso_probe(), device=dev),
                        0.3 * torch.randn((b, 2), generator=gen, device=dev))
    obja = 1.0 + 0.05 * torch.randn((b, 1, PSO_NZ, n, n), generator=gen, device=dev)
    objp = 0.1 * torch.randn((b, 1, PSO_NZ, n, n), generator=gen, device=dev)
    nz_main = 2 * PSO_SG
    a_main, p_main = obja[:, 0, :nz_main], objp[:, 0, :nz_main]
    a_tail, p_tail = obja[:, 0, nz_main:], objp[:, 0, nz_main:]
    gc = torch.complex(torch.randn(psi.shape, generator=gen, device=dev),
                       torch.randn(psi.shape, generator=gen, device=dev)) * float(psi.abs().max())
    chain_names = ["d psi", "d a", "d phi"]

    def b6a(bf16):
        def call():
            return C.stack_fwd_cuda(psi, a_main, p_main, h, PSO_SG, False, bf16)
        return (call()[0],), call

    def b6a_twin(bf16):
        def call():
            return C.chain_stack_plain(psi, a_main, p_main, h, PSO_SG, False, bf16)
        with torch.no_grad():
            return (call(),), call

    def b6b(dh):
        def kern(bf16):
            stack = C.stack_fwd_cuda(psi, a_main, p_main, h, PSO_SG, False, bf16)[1]

            def call():
                out = C.stack_bwd_cuda(gc, stack, a_main, p_main, h, PSO_SG, False, need_dh=dh,
                                       bf16_operands=bf16)
                return out if dh else out[:3]
            return call(), call

        def twin(bf16):
            ins = (psi, a_main, p_main, h) if dh else (psi, a_main, p_main)
            return _twin_vjp(lambda x, y, z, *hx: C.chain_stack_plain(
                x, y, z, hx[0] if hx else h, PSO_SG, False, bf16), ins, gc)
        return kern, twin

    def b5a(ff):
        def kern(bf16):
            def call():
                return C.segment_fwd_cuda(psi, a_tail, p_tail, h, True, ff, bf16)
            return (call(),), call

        def twin(bf16):
            def call():
                return C.chain_segment_plain(psi, a_tail, p_tail, h, True, ff, bf16)
            with torch.no_grad():
                return (call(),), call
        return kern, twin

    def b5b(bf16):
        def call():
            return C.segment_bwd_cuda(gc, psi, a_tail, p_tail, h, True, bf16_operands=bf16)[:3]
        return call(), call

    def b5b_twin(bf16):
        return _twin_vjp(lambda x, y, z: C.chain_segment_plain(x, y, z, h, True,
                                                               bf16_operands=bf16),
                         (psi, a_tail, p_tail), gc)

    pso_note = "PSO shapes, shared H"
    row("B6a chain_stack_fwd (bf16)", "B6a chain_stack_fwd", ch_src, ["exit"], b6a, b6a_twin,
        note=pso_note + ", S = 2 segments of 8")
    row("B6b chain_stack_bwd (bf16)", "B6b chain_stack_bwd", ch_src, chain_names, *b6b(False),
        note=pso_note)
    row("B6b chain_stack_bwd (bf16, dH)", "B6b chain_stack_bwd (dH)", ch_src,
        chain_names + ["d h"], *b6b(True), note=pso_note)
    row("B5a chain_segment_fwd (bf16)", "B5a chain_segment_fwd", ch_src, ["exit"], *b5a(False),
        note=pso_note + ", the 5-slice tail")
    row("B5a chain_segment_fwd (far-field, bf16)", "B5a chain_segment_fwd (far-field)", ch_src,
        ["spectrum"], *b5a(True), note=pso_note + ", the tail with the far-field exit")
    row("B5b chain_segment_bwd (bf16)", "B5b chain_segment_bwd", ch_src, chain_names, b5b,
        b5b_twin, note=pso_note + ", the 5-slice tail")

    # two passes: B5a and B5b at one slice with the far-field exit
    a1, p1 = a_tail[:, :1], p_tail[:, :1]
    k16, k32 = (C.segment_fwd_cuda(psi, a1, p1, h, True, True, bf) for bf in (True, False))
    with torch.no_grad():
        t16, t32 = (C.chain_segment_plain(psi, a1, p1, h, True, True, bf)
                    for bf in (True, False))
    shallow.append(("B5a chain_segment_fwd (far-field, bf16), one slice", ["spectrum"],
                    bf16_errors([k16], [k32], [t16], [t32])))
    kb = {bf: C.segment_bwd_cuda(gc, psi, a1, p1, h, True, far_field=True,
                                 bf16_operands=bf)[:3] for bf in (True, False)}
    tb = {bf: _twin_vjp(lambda x, y, z, bf=bf: C.chain_segment_plain(
        x, y, z, h, True, True, bf16_operands=bf), (psi, a1, p1), gc)[0] for bf in (True, False)}
    shallow.append(("B5b chain_segment_bwd (far-field, bf16), one slice", chain_names,
                    bf16_errors(kb[True], kb[False], tb[True], tb[False])))
    for label, names, errs in shallow:
        failures += bf16_failures(label, names, errs, shallow=True)
        emit({"phase": "kernel_check", "name": label, "passes": 2, "outputs": names,
              "errors": errs, "tolerance": f"|K16 - T16| <= {BF16_SHALLOW} |K16 - K32| (L2)"})
    require(not failures, "bf16 kernels against their twins:\n" + "\n".join(failures))
    return rows


def phase_corr(objp: torch.Tensor, truth: np.ndarray, lo: int, hi: int) -> float:
    """Pearson correlation of the reconstructed phase summed over object
    modes and slices with the simulated truth summed over slices, on the
    scanned square [lo, hi)^2 (the probe centres' span)."""
    o = objp.detach().float().sum(dim=(0, 1))[lo:hi, lo:hi].cpu().numpy().ravel()
    t = np.asarray(truth).sum(0)[lo:hi, lo:hi].ravel()
    return float(np.corrcoef(o, t)[0, 1])


def tbl_scanned() -> tuple[int, int]:
    lo = 4 + NPIX // 2
    return lo, lo + (N_SIDE - 1) * STEP_PX + 1


def pso_scanned() -> tuple[int, int]:
    lo = 4 + PSO_NPIX // 2
    return lo, lo + int(pso_positions()[0][:, 0].max()) - 4 + 1


def final_state(solver) -> dict:
    """The tensors a few iterations of these paths move, on the device."""
    return {k: getattr(solver.params, k).detach().clone() for k in ("obja", "objp", "probe")}


def quality_check(path: str, card: str, objp: torch.Tensor, truth: np.ndarray, lo: int,
                  hi: int) -> float:
    """The float32 run's phase correlation with its seeded object: the
    baseline of the bf16 phase's gate."""
    corr = phase_corr(objp, truth, lo, hi)
    emit({"phase": "quality", "path": path, "card": card, "dtype": "float32",
          "phase_corr": corr, "window": [lo, hi]})
    require(np.isfinite(corr), f"{path}: phase correlation {corr}")
    return corr


def f32_losses(params: dict, init: dict, dev, states: list) -> list:
    """The mean batch loss of each state (obja, objp, probe) through the
    float32 forward and loss of ``params`` on ``init``'s data."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    solver = PtyRADSolver(params, init_variables=init, device=dev, verbose=False)
    require(not solver.geom.bf16_operands, "the float32 evaluation runs the bf16 policy")
    solver.prepare()
    out = []
    with torch.no_grad():
        for state in states:
            for k, v in state.items():
                getattr(solver.params, k).copy_(v)
            out.append(batch_mean_loss(solver))
    del solver
    torch.cuda.empty_cache()
    return out


def with_bf16(params: dict) -> dict:
    out = copy.deepcopy(params)
    out["model_params"]["compute_dtype"] = "bfloat16"
    return out


BF16_TBL_KERNELS = ("B1 gather_patches", "B2 scatter_add_patches", "B3a loss_sums_fwd (bf16)",
                    "B3b loss_sums_bwd (bf16)")
BF16_PSO_KERNELS = ("B1 gather_patches", "B2 scatter_add_patches", "B5a chain_segment_fwd (bf16)",
                    "B5b chain_segment_bwd (bf16)", "B6a chain_stack_fwd (bf16)",
                    "B6b chain_stack_bwd (bf16)")


def finite_falling(path: str, losses) -> None:
    require(len(losses) > 1 and all(np.isfinite(losses)), f"{path}: loss not finite: {losses}")
    require(losses[-1] < losses[0], f"{path}: loss did not fall: {losses}")


def bf16_launches(path: str, launches: dict, kernels) -> None:
    """Every kernel of the path ran, and every chain launch had bfloat16
    operands."""
    for name in kernels:
        require(launches[name] > 0, f"{path}: kernel {name} was not launched")
        base = name.replace(" (bf16)", "")
        require(launches[base] == launches[name], f"{path}: {base} ran {launches[base]} times, "
                f"{launches[name]} of them with bf16 operands")


def poisson_noised(meas, gen) -> torch.Tensor:
    """The patterns with Poisson noise at MP_COUNTS electrons each (each
    pattern's sum kept as its scale), drawn on the device."""
    m = torch.as_tensor(meas, dtype=torch.float32, device=gen.device)
    total = m.sum(dim=(-2, -1), keepdim=True)
    return torch.poisson(m / total * MP_COUNTS, generator=gen) / MP_COUNTS * total


def policy_gate(dev, card: str, path: str, params: dict, init: dict, truth: np.ndarray,
                window: tuple, start_obj=None, gated: bool = True) -> dict:
    """The JAX policy's quality gate on this path: its data with Poisson
    noise at MP_COUNTS, a float32 and a bfloat16 run from the same start
    (init's object, or ``start_obj``; the path's iterations), both finite
    and falling; with ``gated`` the bfloat16 run's
    phase correlation with the seeded object at most MP_CORR_TOL below the
    float32 run's (the JAX gate's c16 >= c32 - 0.005: a better bfloat16 run
    passes), and both final states' loss through the same float32 forward
    within MP_LOSS_RTOL; without it the same numbers, reported."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    noisy = dict(init, measurements=poisson_noised(init["measurements"], gen))
    if start_obj is not None:
        noisy["obj"] = start_obj
    states, corrs, losses = {}, {}, {}
    for dtype, p in (("float32", params), ("bfloat16", with_bf16(params))):
        solver = PtyRADSolver(p, init_variables=noisy, device=dev, verbose=False)
        solver.run()
        losses[dtype] = [v for _, v in solver.history.loss_iters]
        finite_falling(f"{path} ({dtype}, {MP_COUNTS:g} counts)", losses[dtype])
        states[dtype] = final_state(solver)
        corrs[dtype] = phase_corr(solver.params.objp, truth, *window)
        del solver
        torch.cuda.empty_cache()
    e32, e16 = f32_losses(params, noisy, dev, [states["float32"], states["bfloat16"]])
    out = {"phase": f"{path}_policy_{'gate' if gated else 'report'}", "card": card,
           "counts_per_pattern": MP_COUNTS,
           "constraints": sorted(params.get("constraint_params") or {}),
           "start": "flat" if start_obj is None else "seeded random object",
           "losses": losses, "phase_corr": corrs,
           "f32_evaluated_loss": {"bfloat16": e16, "float32": e32},
           "loss_rel_diff": abs(e16 - e32) / abs(e32)}
    emit(out)
    if not gated:
        return out
    require(corrs["bfloat16"] >= corrs["float32"] - MP_CORR_TOL,
            f"{path}: phase correlation {corrs['bfloat16']} against float32's {corrs['float32']}")
    require(abs(e16 - e32) <= MP_LOSS_RTOL * abs(e32),
            f"{path}: float32-evaluated loss {e16} against float32's {e32}")
    return out


def mixed_precision_path(dev, card: str, init: dict, f32_state: dict, corr32: float):
    """The tBL run of the main phase under compute_dtype 'bfloat16' (3
    iterations through B1, B2 and the bf16 B3 from the same start): finite,
    falling losses, every chain launch with bf16 operands; its phase
    correlation and its final state's float32-evaluated loss beside the
    main phase's, patterns/s and peak memory. Then policy_gate on the same
    patterns with Poisson noise."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    solver = PtyRADSolver(with_bf16(TBL_PARAMS), init_variables=init, device=dev, verbose=True)
    require(solver.geom.bf16_operands and solver.geom.compute_dtype == "bfloat16",
            "mixed_precision: the policy did not reach the geometry")
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    launches = drive(solver)
    run_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [v for _, v in solver.history.loss_iters]
    times = solver.history.iter_times
    truth = ground_truth_phase(tbl_positions()[1])
    corr16 = phase_corr(solver.params.objp, truth, *tbl_scanned())
    e32, e16 = f32_losses(TBL_PARAMS, init, dev, [f32_state, final_state(solver)])
    emit({"phase": "mixed_precision", "card": card, "n_patterns": N_SCANS, "batch": BATCH,
          "iterations": len(losses), "losses": losses, "iter_s": times,
          "patterns_per_s": [N_SCANS / t for t in times], "run_s": run_s, "peak_mem_gb": peak,
          "phase_corr": {"bfloat16": corr16, "float32": corr32},
          "f32_evaluated_loss": {"bfloat16": e16, "float32": e32},
          "note": "noiseless patterns: the loss measures bfloat16's rounding floor, the gate is "
                  "tBL_policy_gate's", "launches": launches})
    finite_falling("mixed_precision", losses)
    bf16_launches("mixed_precision", launches, BF16_TBL_KERNELS)
    for name in ("B4a dp_fwd", "B4b dp_bwd") + CHAIN_KERNELS:
        require(launches[name] == 0, f"mixed_precision: {name} ran")
    policy_gate(dev, card, "tBL", TBL_PARAMS, init, truth, tbl_scanned())
    return solver, launches


def without_transform_constraints(params: dict) -> dict:
    """A copy of a configuration without the constraints whose transforms
    follow the bfloat16 policy (constraints.DFT_CONSTRAINTS)."""
    from ptyrad_tpu_torch.constraints import DFT_CONSTRAINTS

    out = copy.deepcopy(params)
    out["constraint_params"] = {k: v for k, v in out["constraint_params"].items()
                                if k not in DFT_CONSTRAINTS}
    return out


def pso_bf16_path(dev, card: str, init: dict, pso_ref: dict):
    """The PSO run under compute_dtype 'bfloat16' from the same start as
    the pso phase (2 iterations through B1, B2 and the bf16 B5/B6), as
    mixed_precision_path does it. The policy pairs then start from
    pso_ff_random_start's seeded object: the flat PSO start amplifies any
    rounding (two float32 routes part by up to PSO_FF_FLAT_RTOL there, the
    size of the loss gate), and away from it float32 routes agree at rtol
    1e-4. The yml's kz_filter runs its transforms with bfloat16 operands
    under the policy, in the JAX package as here, which quantizes the
    object amplitude near 1 to bfloat16 steps of 2^-7 (ROADMAP fault C10;
    tests/test_torch_bf16.py test_transform_constraints_follow_the_jax_switch):
    the pair with the yml's constraints is reported, and the gate runs
    without the constraints whose transforms follow the policy, where it
    measures the kernels' and the trainer's rounding."""
    solver, launches, _ = run_pso_solver(dev, card, "pso_bf16", init, 0.0,
                                         params=with_bf16(PSO_PARAMS))
    truth = columnar_phase(pso_positions()[1])
    corr16 = phase_corr(solver.params.objp, truth, *pso_scanned())
    e32, e16 = f32_losses(PSO_PARAMS, init, dev, [pso_ref["state"], final_state(solver)])
    emit({"phase": "pso_bf16_quality", "card": card,
          "phase_corr": {"bfloat16": corr16, "float32": pso_ref["phase_corr"]},
          "f32_evaluated_loss": {"bfloat16": e16, "float32": e32},
          "note": "noiseless patterns: the gate is PSO_policy_gate's"})
    bf16_launches("pso_bf16", launches, BF16_PSO_KERNELS)
    start = random_object(init["obj"].shape, SEED + 5)
    policy_gate(dev, card, "PSO", PSO_PARAMS, init, truth, pso_scanned(), start, gated=False)
    policy_gate(dev, card, "PSO", without_transform_constraints(PSO_PARAMS), init, truth,
                pso_scanned(), start)
    return solver, launches


def bf16_compare(label: str, names, k16, k32, t16, t32) -> dict:
    """bf16_errors and bf16_failures of a driven comparison, emitted; raises
    on a failed gate."""
    errs = bf16_errors(k16, k32, t16, t32)
    bad = bf16_failures(label, names, errs)
    emit({"phase": "forward_bf16", "check": label, "outputs": names, "errors": errs,
          "tolerance": BF16_TOLERANCE})
    require(not bad, "\n".join(bad))
    return errs


def forward_bf16_check(dev, init: dict) -> dict:
    """forward() under compute_dtype 'bfloat16', dp float32: (1) a tBL
    batch with shifted probes through B4 (the low-dose route), dp and every
    gradient against the plain multislice_dp with bf16_operands on the same
    patches (BF16_RATIO_TOL's gates); (2) N = 96 through the plain chain (a
    bfloat16 wavefield; fwd_fused: false, since the fused kernels take
    N = 96), the card against the CPU, by the same gates; (3) a
    tBL batch of loss_fn with optimizable dz and per-position tilts (B3 with
    dH, bf16): a finite, float32 loss and gradients. Returns the kernel
    routes' launch counts."""
    from ptyrad_tpu_torch.engine.solver import loss_fn
    from ptyrad_tpu_torch.models import (compute_propagators, forward, forward_route,
                                         get_obj_patches, get_probes, make_model, multislice_dp)

    rng = np.random.default_rng(SEED + 7)
    # the fields; the 64 position-shift gradients are too few numbers for
    # an L2 statistic and are held finite instead
    names = ["obja", "objp", "probe"]
    runs = []

    # (1) B4 at the low-dose shapes
    shifts = (0.3 * rng.standard_normal((N_SCANS, 2))).astype(np.float32)
    one = (1.0 + 0.02 * rng.standard_normal(init["obj"].shape)) * np.exp(
        0.1j * rng.standard_normal(init["obj"].shape))
    data = dict(init, obj=one.astype(np.complex64), probe_pos_shifts=shifts)
    idx = torch.arange(0, N_SCANS, N_SCANS // BATCH, device=dev)
    w = torch.rand((BATCH, NPIX, NPIX), generator=torch.Generator(device=dev).manual_seed(SEED),
                   device=dev)
    upd = {"update_params": {"probe_pos_shifts": {"lr": 1e-4}}}

    def run(dtype, route):
        params, buffers, geom = make_model(data, {**upd, "compute_dtype": dtype}, dev)
        for _, t in params.named():
            t.requires_grad_(True)
        if route == "kernels":
            require(forward_route(params, geom, idx) == "fused", "forward() left the B4 route")
            dp, _ = forward(params, buffers, geom, idx)
        else:
            obja_p, objp_p = get_obj_patches(params, buffers, geom, idx)
            dp = multislice_dp(obja_p, objp_p, get_probes(params, geom, idx),
                               compute_propagators(params, buffers, geom, idx),
                               buffers.omode_occu, eps=geom.eps,
                               bf16_operands=geom.bf16_operands)
        (w * dp).sum().backward()
        require(bool(torch.isfinite(params.probe_pos_shifts.grad).all()),
                "forward(): the position-shift gradient is not finite")
        return [dp.detach()] + [getattr(params, k).grad for k in names]

    (k16, launches) = counted(lambda: run("bfloat16", "kernels"))
    require(k16[0].dtype == torch.float32, f"forward() gave dp as {k16[0].dtype}")
    require(launches["B4a dp_fwd (bf16)"] == launches["B4a dp_fwd"] > 0
            and launches["B4b dp_bwd (bf16)"] == launches["B4b dp_bwd"] > 0,
            f"forward() under the policy: {launches}")
    runs.append(launches)
    bf16_compare("forward() B4, tBL batch", ["dp"] + ["d " + k for k in names], k16,
                 run("float32", "kernels"), run("bfloat16", "plain"), run("float32", "plain"))

    # (2) the plain route at N = 96 (fwd_fused: false): the card against the CPU
    n96 = route_case(96, np.random.default_rng(SEED + 6))

    def run96(where, dtype):
        params, buffers, geom = make_model(n96["init"], {**n96["mp"], "compute_dtype": dtype,
                                                         "fwd_fused": False}, where)
        for _, t in params.named():
            t.requires_grad_(True)
        at = torch.arange(BATCH, device=where)
        require(forward_route(params, geom, at) == "plain", "N = 96 left the plain route")
        dp, _ = forward(params, buffers, geom, at)
        (n96["w"].to(where) * dp).sum().backward()
        return [dp.detach().cpu()] + [getattr(params, k).grad.cpu() for k in names]

    (c16, launches) = counted(lambda: run96(dev, "bfloat16"))
    require(c16[0].dtype == torch.float32 and launches[PLAIN_ROUTE] == 1,
            f"N = 96 under the policy: dp {c16[0].dtype}, {launches[PLAIN_ROUTE]} plain routes")
    runs.append(launches)
    cpu = torch.device("cpu")
    bf16_compare("forward() plain route, N = 96, card against CPU",
                 ["dp"] + ["d " + k for k in names], c16, run96(dev, "float32"),
                 run96(cpu, "bfloat16"), run96(cpu, "float32"))

    # (3) B3 with dH: loss_fn with optimizable dz and per-position tilts
    tilted = dict(data, obj_tilts=rng.uniform(-1.0, 1.0, (N_SCANS, 2)).astype(np.float32))
    params, buffers, geom = make_model(tilted, with_bf16(with_dz_tilts(TBL_PARAMS))["model_params"],
                                       dev)
    for _, t in params.named():
        t.requires_grad_(True)
    mask = torch.ones(BATCH, device=dev)

    def b3_dh():
        total, _ = loss_fn(params, buffers, geom, idx, mask, TBL_PARAMS["loss_params"])
        total.backward()
        return total

    total, launches = counted(b3_dh)
    grads = {k: t.grad for k, t in params.named() if t.grad is not None}
    emit({"phase": "forward_bf16", "check": "loss_fn B3 with dH (tilts, dz)",
          "loss": float(total), "grads": sorted(grads), "launches": launches})
    require(total.dtype == torch.float32 and bool(torch.isfinite(total)), f"loss {total}")
    require({"slice_thickness", "obj_tilts"} <= set(grads)
            and all(g.dtype == torch.float32 or g.dtype == torch.complex64 for g in grads.values())
            and all(bool(torch.isfinite(g).all()) for g in grads.values()),
            f"B3 with dH under the policy: gradients {sorted(grads)}")
    require(launches["B3b loss_sums_bwd (bf16, dH)"] == 1, f"B3b (bf16, dH): {launches}")
    runs.append(launches)
    return add_counts(*runs)


def forward_bf16_pso(dev, pso_init: dict) -> dict:
    """A PSO batch of forward() under compute_dtype 'bfloat16' with the
    far-field exit and optimizable dz (B6, B5 with the exit, dH, bf16) and
    its backward: dp float32 and finite, a finite dz gradient. Returns the
    launch counts."""
    from ptyrad_tpu_torch.models import forward, make_model

    C = importlib.import_module("ptyrad_tpu_torch.ops.chain")
    pso_mp = with_bf16(PSO_PARAMS)["model_params"]
    pso_mp["update_params"] = {**pso_mp["update_params"],
                               "slice_thickness": {"start_iter": 1, "lr": 1e-4}}
    params, buffers, geom = make_model(pso_init, pso_mp, dev)
    for _, t in params.named():
        t.requires_grad_(True)
    pidx = torch.arange(BATCH, device=dev)

    def pso_batch():
        C.set_far_field(True)
        try:
            dp, _ = forward(params, buffers, geom, pidx)
            dp.sum().backward()
        finally:
            C.set_far_field(False)
        return dp

    dp, launches = counted(pso_batch)
    emit({"phase": "forward_bf16", "check": "forward() PSO batch, far-field exit, dz",
          "dp_dtype": str(dp.dtype), "finite": bool(torch.isfinite(dp).all()),
          "launches": launches})
    require(dp.dtype == torch.float32 and bool(torch.isfinite(dp).all())
            and bool(torch.isfinite(params.slice_thickness.grad)), "PSO batch under the policy")
    for name in ("B5a chain_segment_fwd (far-field, bf16)", "B6a chain_stack_fwd (bf16)",
                 "B6b chain_stack_bwd (bf16, dH)"):
        require(launches[name] > 0, f"PSO batch under the policy: {name} was not launched")
    return launches


def cli_mixed_precision(card: str, tmp: str, raw_path: str) -> None:
    """``python -m ptyrad_tpu_torch run --mixed_precision`` in a subprocess on
    the params_file phase's .raw, 1 iteration: exit 0, a finite loss, and
    the log names the policy."""
    d = tbl_params_file(raw_path)
    d["recon_params"].update(NITER=1, SAVE_ITERS=1, output_dir=f"{tmp}/cli_bf16_out",
                             save_result=["objp"], selected_figs=[])
    path = f"{tmp}/tbl_cli_bf16.json"
    with open(path, "w", encoding="utf-8") as f:
        json.dump(d, f)
    rc, lines, seconds = _run_cli(["run", "--params_path", path, "--mixed_precision"], 600)
    iters = [_ITER_LINE.search(line) for _, line in lines if _ITER_LINE.search(line)]
    policy = [line for _, line in lines if "Compute policy:" in line]
    emit({"phase": "cli_mixed_precision", "card": card, "rc": rc, "seconds": seconds,
          "losses": [float(m.group(2)) for m in iters], "policy_line": policy})
    require(rc == 0, f"cli --mixed_precision exited {rc}:\n{_tail(lines)}")
    require(len(iters) == 1 and np.isfinite(float(iters[0].group(2))),
            f"cli --mixed_precision: {_tail(lines)}")
    require(any("compute_dtype=bfloat16, transform operands bfloat16" in line for line in policy),
            f"cli --mixed_precision: the log does not name the policy: {policy}")


def fused_plan(n: int) -> dict:
    """The plan csrc/multislice.cu compiled for N (ptyrad_fused_plan; at N
    that is not a power of two from that N's library, which must be
    ops/fused_plan.py's)."""
    import ctypes

    from ptyrad_tpu_torch.ops import _build
    from ptyrad_tpu_torch.ops.fused_plan import reported

    out = (ctypes.c_int * 19)()
    lib = _build.lib() if n & (n - 1) == 0 else _build.mixed_lib(n)
    _build.check(lib.ptyrad_fused_plan(n, out), "ptyrad_fused_plan")
    if n & (n - 1):
        require(tuple(out) == reported(n), f"N = {n}: the compiled fused plan {list(out)} is not "
                f"ops/fused_plan.py's {reported(n)}")
    keys = ("n", "elems", "line_threads", "line", "pad_shift", "fwd_threads", "fwd_row_sweeps",
            "fwd_col_sweeps", "bwd_threads", "bwd_row_sweeps", "bwd_col_sweeps", "group_threads",
            "smem_bytes", "chunks", "line_kind", "slots", "scratch_bytes", "scratch_row",
            "scratch_pad_shift")
    return dict(zip(keys, out))


def chain_plan(n: int) -> dict:
    """The plan chain.cu's mixed build compiled for N at PSO's 4 modes
    (ptyrad_chain_plan from N's library), which must be ops/chain_plan.py's."""
    import ctypes

    from ptyrad_tpu_torch.ops import _build
    from ptyrad_tpu_torch.ops.chain_plan import chain_plan as python_plan

    out = (ctypes.c_int * 14)()
    _build.check(_build.mixed_lib(n).ptyrad_chain_plan(n, PSO_PMODE, out), "ptyrad_chain_plan")
    require(tuple(out) == python_plan(n).reported(PSO_PMODE),
            f"N = {n}: the compiled chain plan {list(out)} is not ops/chain_plan.py's "
            f"{python_plan(n).reported(PSO_PMODE)}")
    keys = ("n", "elems", "line_threads", "passes", "stages", "rows", "cols", "row_threads",
            "col_threads", "row_smem_bytes", "col_smem_bytes", "line", "pad_shift", "slots")
    return {**dict(zip(keys, out)), "bluestein": python_plan(n).bluestein}


KERNEL_CHECKS = ("check_patches", "check_loss_chain", "check_dp_chain", "check_chain",
                 "check_fused_dh", "check_chain_dh", "check_chain_ff", "check_fused_npo2",
                 "check_chain_npo2")


# -- data parallelism over ranks (A6) ---------------------------------------------

# Two gloo ranks on the one card (cuda:0), each taking half of every tBL batch;
# held against the one-rank run of the same data on the card at the JAX
# package's mesh tolerances (tests/test_engine.py:818-921) and
# tests/test_torch_dist.py's trajectory tolerance. The runs start from
# random_object's seeded object: from the flat start a tBL run whose start
# differs by one unit in the last place parts from the main phase by about
# 1e-3 at iteration 2 (float32 rounding that the focused probe's Adam steps
# amplify; the ranks part by 1.7e-4 there), so no reordering of float32
# sums could be held at rtol 1e-4 from it; from the seeded object the same
# change moves iteration 2 by about 1e-6. dist_tbl reports both yardsticks
# and the ranks' run from the flat start beside the main phase's. The rank
# runs take one iteration (512 steps of the ranks' half batches), dist_cli
# two (its loss must fall).
DIST_WORLD, DIST_NITER, DIST_CLI_NITER = 2, 1, 2
DIST_GRAD_ATOL = {"obja": 1e-5, "objp": 1e-5, "probe": 5e-5, "probe_pos_shifts": 1e-7}
DIST_LOSS_RTOL, DIST_TRAJ_RTOL = 1e-5, 1e-4
DIST_TIMEOUT_S = 600
DIST_KINDS = {"tbl": TBL_KERNELS, "low_dose": LOW_DOSE_KERNELS}
DIST_ALLREDUCE_REPS = 20


def dist_problem(kind: str, init: dict, low_dose_probe,
                 split: bool = True) -> tuple[dict, dict]:
    """(params, init_variables) of a dist phase: tBL's sections or the
    low-dose mix for DIST_NITER iterations, on the tBL init (the low-dose
    phase's normalisation, with its probe as low_dose_dataset scaled it);
    the store split over the ranks (the tBL yml's shard_measurements: true)
    or, with ``split`` False, replicated."""
    base = TBL_PARAMS if kind == "tbl" else LOW_DOSE_PARAMS
    params = copy.deepcopy(base)
    params["recon_params"].update(NITER=DIST_NITER, shard_measurements=split)
    if kind == "tbl":
        return params, init
    meas = init["measurements"]
    return params, dict(init, measurements=meas / meas.max(), probe=low_dose_probe)


def first_batch_grads(solver, group) -> tuple[float, dict]:
    """The loss and gradients of iteration 1's first batch at the start
    (each rank its block, its rows fetched from the split store, the
    gradients all-reduced), on the host; the gradients are then cleared."""
    from ptyrad_tpu_torch.engine.solver import iter_batch_perm, params_tensors
    from ptyrad_tpu_torch.parallel import all_reduce_grads

    b = int(iter_batch_perm(1, solver.batch_idx.shape[0])[0])
    idx = torch.as_tensor(solver.batch_idx[b:b + 1], device=solver.device)
    mask = torch.as_tensor(solver.batch_mask[b:b + 1], device=solver.device)
    idx, mask, plans = solver.share.slice(idx, mask)
    total, _ = solver.share.loss(idx[0], mask[0], solver.loss_params, plans[0])
    total.backward()
    all_reduce_grads(params_tensors(solver.params), group)
    grads = {}
    for name, t in solver.params.named():
        if t.grad is not None:
            g = t.grad.detach()
            grads[name] = (torch.view_as_real(g) if g.is_complex() else g).cpu().numpy()
        t.grad = None
    return float(total.detach()), grads


def params_digest(params) -> str:
    h = hashlib.sha256()
    for _, t in params.named():
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def allreduce_timing(solver, group) -> dict:
    """Host ms of one step's gradient all-reduce (the flat buffer of every
    gradient the step holds, zeroed first), synchronised before and after,
    the median of DIST_ALLREDUCE_REPS, and its bytes; and the host ms of a
    3-float all-reduce, the loss's kind."""
    from ptyrad_tpu_torch.engine.solver import params_tensors
    from ptyrad_tpu_torch.parallel import all_reduce_grads, all_reduce_sum

    tensors = params_tensors(solver.params)
    for t in tensors:
        if t.grad is not None:
            t.grad.zero_()

    def median_ms(fn):
        times = []
        for _ in range(DIST_ALLREDUCE_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    nbytes = all_reduce_grads(tensors, group)
    small = torch.zeros(3, device=solver.device)
    return {"grad_allreduce_ms": median_ms(lambda: all_reduce_grads(tensors, group)),
            "grad_allreduce_bytes": nbytes,
            "loss_allreduce_ms": median_ms(lambda: all_reduce_sum(small, group))}


class ExchangeTimer:
    """Wraps torch.distributed.all_to_all_single (the split store's row
    exchange) for the duration of a ``with``: each call's host ms,
    synchronised before and after, and the bytes this rank hands it (its
    rows for every rank, its own included)."""

    def __enter__(self):
        self._fn = torch.distributed.all_to_all_single
        self.ms, self.sent = [], 0

        def timed(output, input, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return self._fn(output, input, *args, **kwargs)
            finally:
                torch.cuda.synchronize()
                self.ms.append((time.perf_counter() - t0) * 1e3)
                self.sent += input.numel() * input.element_size()

        torch.distributed.all_to_all_single = timed
        return self

    def __exit__(self, *exc):
        torch.distributed.all_to_all_single = self._fn
        return False


def dist_run(kind: str, init: dict, low_dose_probe, dev, group,
             split: bool = True) -> tuple[dict, dict]:
    """One dist run, in a rank (group) or in the one-rank parent (group
    None): the first batch's loss and gradients, then DIST_NITER iterations
    under counted(); in a rank also the parameters' digest after each
    iteration, the collectives of one step, the all-reduce's times, the
    store's bytes and the row exchange's host ms and bytes a step."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    params, data = dist_problem(kind, init, low_dose_probe, split)
    solver = PtyRADSolver(params, init_variables=data, device=dev, verbose=False, group=group)
    solver.prepare()
    solver._build()
    first, grads = first_batch_grads(solver, group)
    out = {"first_loss": first}
    if group is None:
        out["launches"] = drive(solver)
        out["losses"] = [v for _, v in solver.history.loss_iters]
        return out, grads
    calls = [0]
    all_reduce = torch.distributed.all_reduce

    def counting(*args, **kwargs):
        calls[0] += 1
        return all_reduce(*args, **kwargs)

    digests = []
    torch.cuda.reset_peak_memory_stats()
    torch.distributed.all_reduce = counting
    try:
        t0 = time.perf_counter()
        with ExchangeTimer() as exchange:
            launches = counted(lambda: solver.run(
                callback=lambda niter, p, history: digests.append(params_digest(p))))[1]
        run_s = time.perf_counter() - t0
    finally:
        torch.distributed.all_reduce = all_reduce
    steps = DIST_NITER * solver.batch_idx.shape[0]
    store = solver.buffers.measurements
    row_bytes = store[0].numel() * store.element_size()
    out.update({
        "store_split": solver.buffers.store_split is not None,
        "store_rows": store.shape[0], "store_bytes": store.shape[0] * row_bytes,
        "replicated_store_bytes": solver.geom.n_scans * row_bytes,
        "exchanges_per_step": len(exchange.ms) / steps,
        "exchange_ms_per_step": sum(exchange.ms) / steps,
        "exchange_ms_median": statistics.median(exchange.ms) if exchange.ms else 0.0,
        "exchange_bytes_per_step": exchange.sent / steps,
        "losses": [v for _, v in solver.history.loss_iters], "iter_s": solver.history.iter_times,
        "run_s": run_s, "digests": digests, "launches": launches,
        "allreduces_per_step": calls[0] / steps, "local_batch": solver.batch_idx.shape[1] // group.size,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        **allreduce_timing(solver, group)})
    return out, grads


def dist_rank(tmp: str, group) -> None:
    """The dist phases' work of a rank (rank_main): runs both kinds from the
    parent's init (the store split), the tBL run from the flat start and
    again with the store replicated, then the hypertune_dist studies, and
    writes <tmp>/dist_<rank>.json and dist_<rank>_<kind>.npz."""
    rank = group.rank
    with np.load(f"{tmp}/dist_init.npz") as f:
        init = {k: f[k] for k in f.files}
    low_dose_probe, flat_obj = init.pop("low_dose_probe"), init.pop("flat_obj")
    out = {}
    for kind in DIST_KINDS:
        out[kind], grads = dist_run(kind, init, low_dose_probe, group.device, group)
        np.savez(f"{tmp}/dist_{rank}_{kind}.npz", **grads)
        torch.cuda.empty_cache()
    out["tbl_flat"], _ = dist_run("tbl", dict(init, obj=flat_obj), None, group.device, group)
    out["tbl_replicated"], _ = dist_run("tbl", init, None, group.device, group, split=False)
    del init
    torch.cuda.empty_cache()
    with np.load(f"{tmp}/ht_dist.npz") as f:
        arrays = {k: f[k] for k in f.files}
    out["hypertune"] = hypertune_rank(arrays, tmp, group)
    with open(f"{tmp}/dist_{rank}.json", "w", encoding="utf-8") as f:
        json.dump(out, f)


def rank_main(rank: int, tmp: str, port: int) -> None:
    """A spawned rank of the dist and canvas phases: joins the gloo group on
    cuda:0 once, runs the dist phases' work (dist_rank), then the canvas
    phases' (canvas_rank), and writes the seconds of each to
    <tmp>/rank_<rank>_s.json."""
    from ptyrad_tpu_torch.parallel import init_multihost

    group = init_multihost(f"127.0.0.1:{port}", DIST_WORLD, rank, backend="gloo")
    try:
        t0 = time.perf_counter()
        dist_rank(tmp, group)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        canvas_rank(tmp, group)
        seconds = {"dist_s": t1 - t0, "canvas_s": time.perf_counter() - t1}
        with open(f"{tmp}/rank_{rank}_s.json", "w", encoding="utf-8") as f:
            json.dump(seconds, f)
    finally:
        torch.distributed.destroy_process_group()


def spawn_ranks(fn, args: tuple, world: int, timeout_s: float) -> None:
    """fn(rank, *args) in `world` spawned processes; raises if one fails or
    the run outlasts timeout_s, and leaves no process behind."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=world, join=False, start_method="spawn")
    deadline = time.perf_counter() + timeout_s
    try:
        while not ctx.join(timeout=5):
            require(time.perf_counter() < deadline, f"the ranks outlasted {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def rel_each(losses, ref) -> list:
    return [abs(a - b) / abs(b) for a, b in zip(losses, ref)]


def ulp_yardstick(dev, init: dict, ref_losses: list) -> list:
    """How far float32 rounding alone moves the tBL run from this start:
    one rank from the start's object times (1 + 2^-23), its losses'
    relative distance from ref_losses (the same run from the start itself),
    iteration by iteration."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver

    params, _ = dist_problem("tbl", init, None)
    obj = (init["obj"] * np.float32(1 + 2 ** -23)).astype(np.complex64)
    solver = PtyRADSolver(params, init_variables=dict(init, obj=obj), device=dev, verbose=False)
    solver.run()
    return rel_each([v for _, v in solver.history.loss_iters], ref_losses)


def dist_reference(dev, init: dict, flat_losses: list, tmp: str) -> dict:
    """The dist phases' side in this process, before the ranks start:
    random_object's seeded start on the tBL data and the low-dose probe
    written to <tmp> as .npz (so no rank simulates), the one-rank runs of
    both kinds from it, the 1-ulp yardsticks of either start (flat_losses:
    the main phase's) and the hypertune_dist reference studies. Returns what
    dist_check holds the ranks against."""
    flat_obj = init["obj"]
    t0 = time.perf_counter()
    flat_ulp = ulp_yardstick(dev, init, flat_losses)
    init = dict(init, obj=random_object(init["obj"].shape, SEED + 5))
    low_dose_probe = low_dose_dataset(init)["probe"]
    t1 = time.perf_counter()
    np.savez(f"{tmp}/dist_init.npz", low_dose_probe=low_dose_probe, flat_obj=flat_obj,
             **{k: v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
                for k, v in init.items()})
    write_s = time.perf_counter() - t1
    one = {kind: dist_run(kind, init, low_dose_probe, dev, None) for kind in DIST_KINDS}
    seeded_ulp = ulp_yardstick(dev, init, one["tbl"][0]["losses"])
    torch.cuda.empty_cache()
    ht_ref = hypertune_reference(dev, init, tmp)
    torch.cuda.empty_cache()
    return {"flat_ulp": flat_ulp, "seeded_ulp": seeded_ulp, "write_s": write_s, "one": one,
            "ht_ref": ht_ref, "flat_losses": flat_losses,
            "reference_s": time.perf_counter() - t0}


def dist_check(card: str, ref: dict, tmp: str, ranks_s: float) -> dict:
    """dist_tbl and dist_low_dose: DIST_WORLD gloo ranks on cuda:0 ran tBL
    and the low-dose mix from random_object's seeded start on the tBL data,
    each rank half of every batch (rank_main; their output in <tmp>).
    Gates: the first batch's loss (rtol 1e-5) and gradients, and the loss
    trajectory (rtol 1e-4), against the one-rank run of the same start on
    the card (dist_reference); the ranks' parameters bit for bit after every
    iteration; the path's kernels launched in every rank. Returns the
    launches summed over the ranks and the one-rank runs. Reported beside
    dist_tbl: the ranks from the flat start against the main phase, and the
    1-ulp yardstick of either start."""
    flat_losses, one = ref["flat_losses"], ref["one"]
    outs, rank_s = [], []
    for r in range(DIST_WORLD):
        with open(f"{tmp}/dist_{r}.json", encoding="utf-8") as f:
            outs.append(json.load(f))
        with open(f"{tmp}/rank_{r}_s.json", encoding="utf-8") as f:
            rank_s.append(json.load(f)["dist_s"])
    grads = {(r, kind): dict(np.load(f"{tmp}/dist_{r}_{kind}.npz"))
             for r in range(DIST_WORLD) for kind in DIST_KINDS}
    launches = []
    for kind, kernels in DIST_KINDS.items():
        (one_out, one_grads), ranks = one[kind], [o[kind] for o in outs]
        grad_err = {name: max(float(np.abs(grads[r, kind][name] - g).max())
                              for r in range(DIST_WORLD))
                    for name, g in one_grads.items()}
        loss_err = [abs(o["first_loss"] - one_out["first_loss"]) / abs(one_out["first_loss"])
                    for o in ranks]
        traj_err = [_max_rel(o["losses"], one_out["losses"]) for o in ranks]
        emit({"phase": f"dist_{kind}", "card": card, "world": DIST_WORLD, "backend": "gloo",
              "device": "cuda:0", "n_patterns": N_SCANS, "batch": BATCH, "start": "seeded",
              "iterations": DIST_NITER, "init_write_s": ref["write_s"],
              "reference_s": ref["reference_s"], "ranks_s": ranks_s, "rank_dist_s": rank_s,
              **({"seeded_start_ulp_rel": ref["seeded_ulp"],
                  "flat_start": {"ranks_rel": rel_each(outs[0]["tbl_flat"]["losses"],
                                                       flat_losses),
                                 "ulp_rel": ref["flat_ulp"]}} if kind == "tbl" else {}),
              "one_rank_losses": one_out["losses"],
              "first_loss_rel_err": loss_err, "first_loss_rtol": DIST_LOSS_RTOL,
              "grad_max_abs_err": grad_err, "grad_atol": DIST_GRAD_ATOL,
              "trajectory_max_rel_err": traj_err, "trajectory_rtol": DIST_TRAJ_RTOL,
              "ranks": [{**{k: v for k, v in o.items() if k not in ("digests", "launches")},
                         "launches": {name: o["launches"][name] for name in kernels}}
                        for o in ranks],
              "digests_equal": all(o["digests"] == ranks[0]["digests"] for o in ranks)})
        for r, o in enumerate(ranks):
            require(len(o["losses"]) == DIST_NITER and all(np.isfinite(o["losses"])),
                    f"dist_{kind} rank {r}: losses {o['losses']}")
            for name in kernels:
                require(o["launches"][name] > 0, f"dist_{kind} rank {r}: {name} not launched")
            require(o["digests"] == ranks[0]["digests"] and len(o["digests"]) == DIST_NITER,
                    f"dist_{kind}: the ranks' parameters part")
            require(o["losses"] == ranks[0]["losses"], f"dist_{kind}: the ranks' losses part")
        require(max(loss_err) <= DIST_LOSS_RTOL, f"dist_{kind}: first loss {loss_err}")
        for name, err in grad_err.items():
            require(err <= DIST_GRAD_ATOL[name], f"dist_{kind}: gradient of {name} off by {err}")
        require(set(grad_err) == set(DIST_GRAD_ATOL), f"dist_{kind}: gradients of {set(grad_err)}")
        require(max(traj_err) <= DIST_TRAJ_RTOL, f"dist_{kind}: trajectory off by {traj_err}")
        launches += [o["launches"] for o in ranks] + [one_out["launches"]]
    for r, o in enumerate(outs):
        require(o["tbl_flat"]["digests"] == outs[0]["tbl_flat"]["digests"],
                f"dist_tbl from the flat start: rank {r}'s parameters part from rank 0's")
        launches.append(o["tbl_flat"]["launches"])
    launches += store_split_check(card, outs)
    launches += hypertune_dist_check(card, ref["ht_ref"], [o["hypertune"] for o in outs])
    return add_counts(*launches)


def ranks_path(dev, card: str, dist_ref: dict, tmp: str) -> tuple[dict, dict, dict]:
    """The dist and canvas phases after dist_reference (which wrote the
    ranks' inputs to <tmp>): the canvas phases' one-rank references
    (canvas_reference), then one spawn of DIST_WORLD gloo ranks on cuda:0
    that runs both phases' work in one process group (rank_main), then each
    phase's gates (dist_check, canvas_check). Returns (the dist launches,
    the largeFOV canvas ranks', the full scan canvas ranks')."""
    require(DIST_WORLD == CANVAS_WORLD, "the dist and canvas phases share one spawn")
    canvas_ref = canvas_reference(dev)
    torch.cuda.empty_cache()
    loopback_env()
    t0 = time.perf_counter()
    spawn_ranks(rank_main, (tmp, _free_port()), DIST_WORLD, DIST_TIMEOUT_S + CANVAS_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    dist_launches = dist_check(card, dist_ref, tmp, ranks_s)
    canvas_launches, canvas_full_launches = canvas_check(card, canvas_ref, tmp, ranks_s)
    return dist_launches, canvas_launches, canvas_full_launches


def store_split_check(card: str, outs: list) -> list:
    """dist_tbl's split store against its rerun with the store replicated
    (shard_measurements: false) on the same ranks: losses and parameters
    bit for bit; each rank's store, exchange and peak memory reported.
    Returns the replicated reruns' launches."""
    rows = []
    for r, o in enumerate(outs):
        split, rep = o["tbl"], o["tbl_replicated"]
        rows.append({
            "rank": r, "store_rows": split["store_rows"], "store_bytes": split["store_bytes"],
            "replicated_store_bytes": rep["store_bytes"],
            "exchanges_per_step": split["exchanges_per_step"],
            "exchange_ms_per_step": split["exchange_ms_per_step"],
            "exchange_ms_median": split["exchange_ms_median"],
            "exchange_bytes_per_step": split["exchange_bytes_per_step"],
            "peak_mem_gb": {"split": split["peak_mem_gb"], "replicated": rep["peak_mem_gb"]},
            "iter_s": {"split": split["iter_s"], "replicated": rep["iter_s"]},
            "losses_equal": split["losses"] == rep["losses"],
            "digests_equal": split["digests"] == rep["digests"]})
    emit({"phase": "dist_store_split", "card": card, "world": DIST_WORLD, "backend": "gloo",
          "n_patterns": N_SCANS, "batch": BATCH, "ranks": rows})
    for r, (o, row) in enumerate(zip(outs, rows)):
        require(o["tbl"]["store_split"] and not o["tbl_replicated"]["store_split"],
                f"dist_store_split rank {r}: the store was not split, or split when asked not to")
        require(row["store_rows"] == -(-N_SCANS // DIST_WORLD),
                f"dist_store_split rank {r}: {row['store_rows']} store rows")
        require(row["replicated_store_bytes"] == DIST_WORLD * row["store_bytes"],
                f"dist_store_split rank {r}: store bytes {row['store_bytes']} against "
                f"{row['replicated_store_bytes']} replicated")
        require(row["exchanges_per_step"] == 1.0,
                f"dist_store_split rank {r}: {row['exchanges_per_step']} exchanges a step")
        require(row["losses_equal"] and row["digests_equal"],
                f"dist_store_split rank {r}: the split store's run parts from the replicated "
                f"store's: {o['tbl']['losses']} against {o['tbl_replicated']['losses']}")
    return [o["tbl_replicated"]["launches"] for o in outs]


HT_DIST_SIDE = 32                  # the study's sub-raster of the tBL scan: 1,024 patterns
HT_DIST_TRIALS, HT_DIST_NITER = 2, 2
HT_DIST_RTOL = 1e-5                # the ranks' trial values against the one-process study's
HT_DIST_START_SEED = SEED + 11     # the seeded object every study starts from


def canvas_trial_side() -> int:
    """The smallest square sub-raster of the tBL scan whose canvas (the
    Initializer's: 1.2 times the scan's extent plus a probe,
    initialization.init_pos) splits over DIST_WORLD slabs at least a probe
    tall each (parallel.plan_canvas_sharding)."""
    for side in range(2, N_SIDE + 1):
        rows = int(1.2 * np.ceil((side - 1) * STEP_PX + NPIX))
        if -(-rows // DIST_WORLD) >= NPIX:
            return side
    raise ValueError("no sub-raster of the tBL scan splits into slabs a probe tall")


def sub_raster(side: int) -> np.ndarray:
    """Scan indices of the side x side block at the tBL raster's corner."""
    r = np.arange(side)
    return (r[:, None] * N_SIDE + r[None, :]).ravel()


def ht_dist_params(meas: np.ndarray, obj, tmp: str, tag: str, canvas: bool) -> dict:
    """A study on ``meas`` (a square sub-raster of the tBL patterns, in
    memory) from the seeded object ``obj`` (None: the Initializer's flat
    one), through tbl_params_file's sections: the calibrated dx, no
    position jitter, the store split. The data-parallel study: HT_DIST_TRIALS
    trials of HT_DIST_NITER iterations tuning the objp and probe rates,
    RandomSampler(seed 0), MedianPruner after one finished trial. ``canvas``:
    one trial at the largeFOV yml's widths (batch 256, its constraints,
    shard_canvas), its objp rate the yml's."""
    side = int(round(np.sqrt(len(meas))))
    d = tbl_params_file("")
    d["init_params"].update(
        pos_N_scans=side * side, pos_N_scan_slow=side, pos_N_scan_fast=side,
        meas_source="custom", meas_params=meas, meas_flipT=None,
        meas_calibration={"mode": "dx", "value": SIM_DX, "thresh": 0.5}, pos_scan_rand_std=None,
        obj_source="simu" if obj is None else "custom", obj_params=obj)
    d["recon_params"].update(
        NITER=HT_DIST_NITER, SAVE_ITERS=None, output_dir=f"{tmp}/{tag}_out", save_result=[],
        selected_figs=[], if_quiet=True, shard_measurements=True)
    tune = d["hypertune_params"]["tune_params"]
    tune["scale"]["state"] = tune["rotation"]["state"] = False
    tune["oplr"] = _tune(True, "cat", choices=[2.5e-4, 5e-4, 1e-3])
    tune["plr"] = _tune(True, "cat", choices=[1e-4, 5e-4])
    d["hypertune_params"].update(
        if_hypertune=True, collate_results=False, n_trials=HT_DIST_TRIALS,
        sampler_params={"name": "RandomSampler", "configs": {"seed": 0}},
        pruner_params={"name": "MedianPruner", "configs": {"n_startup_trials": 1}},
        storage_path=f"{tmp}/{tag}.sqlite3", study_name=tag)
    if canvas:
        d["constraint_params"].update(
            {k: {**v, "freq": None} for k, v in d["constraint_params"].items()})
        d["constraint_params"].update(copy.deepcopy(LARGEFOV_PARAMS["constraint_params"]))
        d["recon_params"].update(BATCH_SIZE={"size": CANVAS_BATCH, "grad_accumulation": 1},
                                 shard_canvas=True)
        tune["plr"]["state"] = False
        tune["oplr"] = _tune(True, "cat", choices=[5e-4])
        d["hypertune_params"].update(n_trials=1, pruner_params=None)
    return d


def ht_start(meas: np.ndarray, tmp: str, tag: str, canvas: bool) -> np.ndarray:
    """The seeded object of a study: random_object at the shape of the
    Initializer's object for these patterns."""
    from ptyrad_tpu_torch.initialization import Initializer

    d = ht_dist_params(meas, None, tmp, tag, canvas)
    init = Initializer(d["init_params"], verbose=False, rng=np.random.RandomState(SEED))
    shape = init.init_all().init_variables["obj"].shape
    return random_object(shape, HT_DIST_START_SEED)


def hypertune_reference(dev, init: dict, tmp: str) -> dict:
    """The hypertune_dist phase's inputs and its one-process reference: the
    sub-rasters' patterns and seeded objects, written to <tmp>/ht_dist.npz
    for the ranks, and the data-parallel study run here on one rank of the
    card (trials, seconds)."""
    from ptyrad_tpu_torch.engine.hypertune import run_hypertune
    from ptyrad_tpu_torch.parallel import plan_canvas_sharding

    meas_all = init["measurements"]
    meas_all = meas_all.cpu().numpy() if torch.is_tensor(meas_all) else np.asarray(meas_all)
    side = canvas_trial_side()
    arrays = {"meas": np.ascontiguousarray(meas_all[sub_raster(HT_DIST_SIDE)]),
              "canvas_meas": np.ascontiguousarray(meas_all[sub_raster(side)])}
    arrays["obj"] = ht_start(arrays["meas"], tmp, "ht_shape", False)
    arrays["canvas_obj"] = ht_start(arrays["canvas_meas"], tmp, "ht_shape", True)
    # the canvas trial's scan is the smallest whose slabs hold a probe
    d = ht_dist_params(arrays["canvas_meas"], arrays["canvas_obj"], tmp, "ht_plan", True)
    from ptyrad_tpu_torch.initialization import Initializer

    iv = Initializer(d["init_params"], verbose=False,
                     rng=np.random.RandomState(SEED)).init_all().init_variables
    plan_canvas_sharding(iv["crop_pos"], iv["obj"].shape[-2], NPIX, DIST_WORLD)
    np.savez(f"{tmp}/ht_dist.npz", **arrays)
    d = ht_dist_params(arrays["meas"], arrays["obj"], tmp, "ht_one", False)
    t0 = time.perf_counter()
    study = run_hypertune(d, device=dev, init_rng=np.random.RandomState(SEED), use_optuna=False)
    return {"trials": study.trials, "seconds": time.perf_counter() - t0,
            "canvas_side": side, "canvas_rows": int(iv["obj"].shape[-2])}


def hypertune_rank(arrays: dict, tmp: str, group) -> dict:
    """A rank's share of hypertune_dist: the data-parallel study and the
    canvas trial through run_hypertune(group=) (rank 0 holding each study),
    each trial's seconds and peak memory on this rank and the launches;
    then the canvas trial's configuration as a plain canvas-sharded run of
    the same ranks, whose last loss the trial's value must be."""
    from ptyrad_tpu_torch.engine.hypertune import run_hypertune
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver
    from ptyrad_tpu_torch.initialization import Initializer

    out = {}
    for tag, canvas in (("ht_dist", False), ("ht_canvas", True)):
        prefix = "canvas_" if canvas else ""
        d = ht_dist_params(arrays[prefix + "meas"], arrays[prefix + "obj"], tmp, tag, canvas)
        t0 = time.perf_counter()
        with TrialRecorder() as rec:
            study, launches = counted(lambda: run_hypertune(
                d, device=group.device, init_rng=np.random.RandomState(SEED), use_optuna=False,
                group=group))
        out[tag] = {"seconds": time.perf_counter() - t0, "launches": launches,
                    "trial_s": [r["seconds"] for r in rec.rows],
                    "trial_peak_gb": [r["peak_gb"] for r in rec.rows],
                    "trial_numbers": [r["number"] for r in rec.rows],
                    "exceptions": [r.get("exception") for r in rec.rows],
                    "trials": None if study is None else study.trials}
        torch.cuda.empty_cache()
    init = Initializer(d["init_params"], verbose=False, rng=np.random.RandomState(SEED))
    solver = PtyRADSolver(d, init_variables=init.init_all().init_variables, device=group.device,
                          verbose=False, group=group)
    solver.run()
    out["ht_canvas"].update(direct_losses=[v for _, v in solver.history.loss_iters],
                            direct_canvas=solver._canvas is not None)
    del solver
    torch.cuda.empty_cache()
    return out


def hypertune_dist_check(card: str, ref: dict, ranks: list) -> list:
    """hypertune_dist's gates: the ranks' data-parallel study (rank 0's)
    has the one-process study's trial params and states, its values within
    HT_DIST_RTOL; every rank ran every trial, none raised; the canvas
    trial is COMPLETE, canvas-sharded, and its value is the last loss of
    the plain canvas run of its configuration, bit for bit; B1-B3 launched
    in both studies on every rank. Returns the ranks' launches."""
    dp, cv = ranks[0]["ht_dist"], ranks[0]["ht_canvas"]
    rel = [abs(a["value"] - b["value"]) / abs(b["value"]) for a, b in zip(dp["trials"],
                                                                         ref["trials"])]
    emit({"phase": "hypertune_dist", "card": card, "world": DIST_WORLD, "backend": "gloo",
          "n_patterns": HT_DIST_SIDE ** 2, "batch": BATCH, "iterations": HT_DIST_NITER,
          "one_process": {"seconds": ref["seconds"],
                          "trials": [[t["number"], t["state"], t["value"], t["params"]]
                                     for t in ref["trials"]]},
          "ranks_trials": [[t["number"], t["state"], t["value"], t["params"]]
                           for t in dp["trials"]],
          "value_rel_err": rel, "value_rtol": HT_DIST_RTOL,
          "ranks": [{"study_s": o["ht_dist"]["seconds"], "trial_s": o["ht_dist"]["trial_s"],
                     "trial_peak_gb": o["ht_dist"]["trial_peak_gb"],
                     "canvas_trial_s": o["ht_canvas"]["trial_s"],
                     "canvas_trial_peak_gb": o["ht_canvas"]["trial_peak_gb"]} for o in ranks],
          "canvas": {"side": ref["canvas_side"], "canvas_rows": ref["canvas_rows"],
                     "n_patterns": ref["canvas_side"] ** 2, "batch": CANVAS_BATCH,
                     "trials": [[t["number"], t["state"], t["value"]] for t in cv["trials"]],
                     "direct_losses": cv["direct_losses"]}})
    require([t["params"] for t in dp["trials"]] == [t["params"] for t in ref["trials"]],
            "hypertune_dist: the ranks' trial params differ from the one-process study's")
    require([t["state"] for t in dp["trials"]] == [t["state"] for t in ref["trials"]],
            "hypertune_dist: the ranks' trial states differ from the one-process study's")
    require(len(rel) == HT_DIST_TRIALS and max(rel) <= HT_DIST_RTOL,
            f"hypertune_dist: trial values off by {rel}")
    for r, o in enumerate(ranks):
        for tag in ("ht_dist", "ht_canvas"):
            require(o[tag]["trial_numbers"] == ranks[0][tag]["trial_numbers"],
                    f"hypertune_dist rank {r}: ran trials {o[tag]['trial_numbers']}")
            require(not any(o[tag]["exceptions"]),
                    f"hypertune_dist rank {r}: {o[tag]['exceptions']}")
            for name in TBL_KERNELS:
                require(o[tag]["launches"][name] > 0,
                        f"hypertune_dist rank {r}: {name} not launched in {tag}")
        require((o["ht_dist"]["trials"] is None) == (r > 0) and o["ht_canvas"]["direct_canvas"],
                f"hypertune_dist rank {r}: a study held off rank 0, or a run not canvas-sharded")
    (trial,) = cv["trials"]
    require(trial["state"] == "COMPLETE" and trial["value"] == cv["direct_losses"][-1],
            f"hypertune_dist: the canvas trial {trial} against the plain canvas run "
            f"{cv['direct_losses']}")
    return [o[tag]["launches"] for o in ranks for tag in ("ht_dist", "ht_canvas")]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def loopback_env() -> None:
    """gloo and NCCL meet on the loopback interface: the card's machine has
    no network, and the ranks share one host."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")


def dist_cli_path(card: str, tmp: str, raw_path: str) -> None:
    """``python -m ptyrad_tpu_torch run --multihost --coordinator_address
    127.0.0.1:<port> --num_processes 1 --process_id 0`` on params_file's
    .raw, 2 iterations: NCCL as a world of one through the CLI. Exit 0,
    the log naming the process and the backend, a finite, falling loss."""
    d = tbl_params_file(raw_path)
    d["recon_params"].update(NITER=DIST_CLI_NITER, output_dir=f"{tmp}/dist_cli_out",
                             save_result=["objp"])
    json_path = f"{tmp}/tbl_dist_cli.json"
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(d, f)
    loopback_env()
    rc, lines, seconds = _run_cli(
        ["run", "--params_path", json_path, "--multihost", "--coordinator_address",
         f"127.0.0.1:{_free_port()}", "--num_processes", "1", "--process_id", "0"], 600)
    text = [line for _, line in lines]
    losses = [float(m.group(2)) for m in map(_ITER_LINE.search, text) if m]
    out = {"phase": "dist_cli", "card": card, "rc": rc, "seconds": seconds, "losses": losses,
           "process_line": [t for t in text if "process index" in t],
           "data_parallel_line": [t for t in text if "Data parallel" in t]}
    emit(out)
    require(rc == 0, f"dist_cli exited {rc}:\n{_tail(lines)}")
    require(any("process index   : 0 / 1" in t for t in text), "dist_cli: no process line")
    require(any("Data parallel: 1 rank(s) over nccl" in t for t in text),
            f"dist_cli: not an NCCL world of one:\n{_tail(lines)}")
    require(len(losses) == DIST_CLI_NITER and all(np.isfinite(losses))
            and losses[-1] < losses[0], f"dist_cli: losses {losses}")


# -- canvas sharding over ranks (A7) ---------------------------------------------

# demo/params/largeFOV_shard_canvas.yml at its widths: 128^2 patterns, 6 probe
# modes, 1 object mode, 6 slices, batch 256, loss_single + loss_sparse, its four
# constraints, shifts from iteration 10; the raster of tbl_positions (3 px a
# step, the tBL geometry). canvas_largefov cuts the 512 x 512 scan to 256 x 256
# and holds two gloo ranks on cuda:0 against the one-rank replicated run of the
# same per-slab batches (parallel.global_batches) from random_object's seeded
# start: the first batch's loss at rtol 1e-6 and each gradient within
# CANVAS_GRAD_RTOL of the reference's largest entry (a dropped halo cotangent
# or summed canvases are errors of the gradient's own size),
# one iteration (256 steps) at rtol 1e-5, the ranks bit for bit.
# canvas_fullscan runs the whole 512 x 512 scan's slabs and store for the
# first CANVAS_FULL_STEPS batches of iteration 1 (an eighth of a rank's
# 1,024; the same count on both ranks, through solver.train_epoch: no
# constraint is due inside the window); each rank simulates only the
# patterns its window reads into a host store whose other rows are never
# touched (np.zeros), so no 17 GB array is written; the peak memory (set by
# the slab and the store, not by the step count) and the falling batch loss
# are gated on that window; the replicated figure is one rank's peak memory
# over CANVAS_REPLICATED_STEPS steps of the same scan.
CANVAS_WORLD = 2
CANVAS_SIDE, CANVAS_NITER = 256, 1
CANVAS_FULL_SIDE, CANVAS_FULL_STEPS = 512, 128
CANVAS_BATCH = 256
CANVAS_LOSS_RTOL, CANVAS_TRAJ_RTOL = 1e-6, 1e-5
CANVAS_GRAD_RTOL = {"obja": 1e-5, "objp": 1e-5, "probe": 1e-5, "probe_pos_shifts": 1e-5}
CANVAS_REPLICATED_STEPS = 16
CANVAS_TIMEOUT_S = 900
CANVAS_START_SEED = SEED + 7
CANVAS_TIMING_REPS = 10
CANVAS_SLAB = " (canvas rank, 256x256 scan)"       # the rows at a canvas rank's shapes
CANVAS_FULL_SLAB = " (canvas rank, 512x512 scan)"
CANVAS_KERNELS = ("B1 gather_patches", "B2 scatter_add_patches", "B3a loss_sums_fwd",
                  "B3b loss_sums_bwd")
LARGEFOV_PARAMS = {
    "model_params": copy.deepcopy(TBL_PARAMS["model_params"]),
    "loss_params": copy.deepcopy(TBL_PARAMS["loss_params"]),
    "constraint_params": {
        "ortho_pmode": {"freq": 1},
        "fix_probe_int": {"freq": 1},
        "obja_thresh": {"freq": 1, "relax": 0, "thresh": [0.98, 1.02]},
        "objp_postiv": {"freq": 1, "relax": 0, "mode": "clip_neg"},
    },
    "recon_params": {"BATCH_SIZE": {"size": CANVAS_BATCH}, "GROUP_MODE": "random",
                     "GROUP_MODE_SEED": SEED},
}


def largefov_params(niter: int, shard: bool) -> dict:
    params = copy.deepcopy(LARGEFOV_PARAMS)
    params["recon_params"].update(NITER=niter, shard_canvas=shard)
    return params


def canvas_raster(side: int) -> tuple[np.ndarray, int]:
    """tbl_positions' raster at side x side positions, and its canvas."""
    canvas = side * STEP_PX + NPIX + 8
    ys, xs = np.meshgrid(np.arange(side) * STEP_PX, np.arange(side) * STEP_PX, indexing="ij")
    return np.stack([ys.ravel() + 4, xs.ravel() + 4], -1).astype(np.int32), canvas


def canvas_init(side: int) -> dict:
    """init_variables of the largeFOV problem at side x side: tbl_init's
    probe and slices on the raster, the known object ground_truth_phase's
    blobs at tBL's density (seeded); measurements to fill."""
    from ptyrad_tpu_torch.physics import electron_wavelength, near_field_evolution

    crop_pos, canvas = canvas_raster(side)
    rng = np.random.default_rng(SEED)
    phase = np.zeros((NZ, canvas, canvas), np.float32)
    d = np.arange(-12, 13, dtype=np.float32)
    blob = 0.15 * np.exp(-(d[:, None] ** 2 + d[None, :] ** 2) / 4.0)
    for z in range(NZ):
        for _ in range(int(300 * (canvas / 520) ** 2)):
            cy, cx = rng.integers(12, canvas - 12, 2)
            phase[z, cy - 12:cy + 13, cx - 12:cx + 13] += blob
    lam = electron_wavelength(80.0)
    return {"obj": np.exp(1j * phase)[None].astype(np.complex64), "probe": tbl_probe(),
            "probe_pos_shifts": np.zeros((side * side, 2), np.float32),
            "obj_tilts": np.zeros((1, 2), np.float32), "slice_thickness": 2.0,
            "H": near_field_evolution((NPIX, NPIX), SIM_DX, 2.0, lam),
            "measurements": None, "crop_pos": crop_pos, "omode_occu": np.ones(1, np.float32),
            "dx": SIM_DX, "lambd": lam, "N_scan_slow": side, "N_scan_fast": side}


def simulate_positions(dev, init: dict, ids: np.ndarray) -> torch.Tensor:
    """The patterns of positions ``ids`` through forward() (B4a) from the
    known object, SIM_BATCH at a time (set-up, as simulate)."""
    from ptyrad_tpu_torch.models import forward, make_model

    params, buffers, geom = make_model(dict(init, measurements=np.zeros((1, NPIX, NPIX),
                                                                       np.float32)), None, dev)
    out = torch.empty((len(ids), NPIX, NPIX), dtype=torch.float32, device=dev)
    ids_dev = torch.as_tensor(ids, device=dev)
    with torch.no_grad():
        for start in range(0, len(ids), SIM_BATCH):
            out[start:start + SIM_BATCH] = forward(params, buffers, geom,
                                                   ids_dev[start:start + SIM_BATCH])[0]
    torch.cuda.synchronize()
    require(bool(torch.isfinite(out).all()), "simulated canvas patterns are not finite")
    return out


def canvas_plan(side: int):
    from ptyrad_tpu_torch.parallel import plan_canvas

    crop_pos, canvas = canvas_raster(side)
    return plan_canvas(crop_pos, np.arange(side * side), canvas, NPIX, CANVAS_WORLD)


def host_grads(params, gather=None) -> dict:
    """Every gradient on the host (complex as real pairs; obja/objp through
    ``gather``, the canvas path's whole-canvas gather), then cleared."""
    grads = {}
    for name, t in params.named():
        if t.grad is None:
            continue
        g = t.grad.detach()
        if gather is not None and name in ("obja", "objp"):
            g = gather(g)
        grads[name] = (torch.view_as_real(g) if g.is_complex() else g).cpu().numpy()
        t.grad = None
    return grads


def canvas_replicated(dev, side: int, niter: int) -> tuple[dict, dict]:
    """The one-rank replicated run of canvas_largefov: every pattern
    simulated on the card, the seeded start, the first batch's loss and
    gradients, then niter iterations on the batches the ranks draw together."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver, loss_fn, recon_loop
    from ptyrad_tpu_torch.parallel import global_batches
    from ptyrad_tpu_torch.parallel.canvas import canvas_batch_count

    t0 = time.perf_counter()
    init = canvas_init(side)
    init["measurements"] = simulate_positions(dev, init, np.arange(side * side))
    init["obj"] = random_object(init["obj"].shape, CANVAS_START_SEED)
    solver = PtyRADSolver(largefov_params(niter, False), init_variables=init, device=dev,
                          verbose=False)
    solver.prepare()
    solver._build()
    plan = canvas_plan(side)
    n_batches = canvas_batch_count(plan, side * side, CANVAS_BATCH, verbose=False)
    gids, mask = global_batches(plan, n_batches, 1)
    total, _ = loss_fn(solver.params, solver.buffers, solver.geom,
                       torch.as_tensor(gids[0], device=dev), torch.as_tensor(mask[0], device=dev),
                       solver.loss_params)
    total.backward()
    grads = host_grads(solver.params)
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    recon_loop(solver.train_epoch, solver.params, lambda n: global_batches(plan, n_batches, n),
               None, niter, solver.constraint_fn, solver.buffers, history=solver.history,
               verbose=False)
    torch.cuda.synchronize()
    return {"first_loss": float(total.detach()), "setup_s": setup_s,
            "run_s": time.perf_counter() - t1, "iter_s": solver.history.iter_times,
            "losses": [v for _, v in solver.history.loss_iters], "n_batches": n_batches,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}, grads


def canvas_replicated_peak(dev, side: int) -> dict:
    """One rank's replicated run of the whole scan for CANVAS_REPLICATED_STEPS
    steps of its first iteration's canvas batches: its peak memory (the
    whole store, canvases and optimizer state, one step's work) and ms a
    step."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver
    from ptyrad_tpu_torch.parallel import global_batches
    from ptyrad_tpu_torch.parallel.canvas import canvas_batch_count

    init = canvas_init(side)
    init["measurements"] = simulate_positions(dev, init, np.arange(side * side))
    init["obj"] = random_object(init["obj"].shape, CANVAS_START_SEED)
    solver = PtyRADSolver(largefov_params(1, False), init_variables=init, device=dev,
                          verbose=False)
    solver.prepare()
    solver._build()
    plan = canvas_plan(side)
    gids, mask = global_batches(plan, canvas_batch_count(plan, side * side, CANVAS_BATCH,
                                                         verbose=False), 1)
    k = CANVAS_REPLICATED_STEPS
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, terms = solver.train_epoch(torch.as_tensor(gids[:k], device=dev),
                                  torch.as_tensor(mask[:k], device=dev), 1)
    torch.cuda.synchronize()
    out = {"steps": k, "ms_per_step": (time.perf_counter() - t0) * 1e3 / k,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "store_gb": solver.buffers.measurements.numel() * 4 / 1e9,
           "finite": bool(np.all(np.isfinite(terms["loss_single"])))}
    return out


def median_host_ms(fn, reps: int = CANVAS_TIMING_REPS) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def canvas_timing(shard, group) -> dict:
    """Host ms and bytes of one step's halo exchange (forward and backward
    on copies of the rank's slabs) and of its gradient all-reduce (the
    replicated tensors' gradients, zeroed)."""
    from ptyrad_tpu_torch.parallel import all_reduce_grads, halo_extend

    halo = shard.plan.halo
    a = shard.params.obja.detach().clone().requires_grad_(True)
    p = shard.params.objp.detach().clone().requires_grad_(True)

    def exchange():
        ea, ep = halo_extend(a, p, halo, group)
        (ea.sum() + ep.sum()).backward()

    tensors = [t for t in shard.replicated_tensors() if t.requires_grad]
    for t in tensors:
        t.grad = torch.zeros_like(t)
    nbytes = all_reduce_grads(tensors, group)
    out = {"halo_ms": median_host_ms(exchange),
           "halo_bytes_sent": 2 * 2 * a[..., :halo, :].numel() * 4,
           "grad_allreduce_ms": median_host_ms(lambda: all_reduce_grads(tensors, group)),
           "grad_allreduce_bytes": nbytes}
    for t in tensors:
        t.grad = None
    return out


class CollectiveCounter:
    """Counts the calls and bytes (the tensor each rank puts in) of
    torch.distributed's all_gather and all_reduce while active."""

    def __init__(self):
        self.calls = {"all_gather": 0, "all_reduce": 0}
        self.bytes = {"all_gather": 0, "all_reduce": 0}

    def __enter__(self):
        self.saved = {k: getattr(torch.distributed, k) for k in self.calls}

        def wrap(name, fn, arg):
            def counting(*args, **kwargs):
                t = args[arg]
                self.calls[name] += 1
                self.bytes[name] += t.numel() * t.element_size()
                return fn(*args, **kwargs)
            return counting

        torch.distributed.all_gather = wrap("all_gather", self.saved["all_gather"], 1)
        torch.distributed.all_reduce = wrap("all_reduce", self.saved["all_reduce"], 0)
        return self

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(torch.distributed, k, fn)


def canvas_rank_run(side: int, niter: int, group, first: bool,
                    steps: int | None = None) -> tuple[dict, dict]:
    """A rank of a canvas phase: its slab's patterns simulated on the card
    into a host store of which it writes only those rows, the seeded start,
    PtyRADSolver with shard_canvas; with ``first`` the first batch's loss and
    gradients (the canvases gathered whole); niter iterations under
    counted() with the collectives counted and the replicated tensors'
    digest after each, or with ``steps`` only the first ``steps`` batches
    of iteration 1 (solver.train_epoch on them; one loss, their mean, and
    one digest; only the patterns those batches read are simulated, the
    rest of the slab's store rows stay zero); then the exchange's and the
    all-reduce's times."""
    from ptyrad_tpu_torch.engine.solver import PtyRADSolver
    from ptyrad_tpu_torch.parallel import all_reduce_grads
    from ptyrad_tpu_torch.parallel.canvas import canvas_batch_count, canvas_iteration_batches

    dev = group.device
    t0 = time.perf_counter()
    init = canvas_init(side)
    plan = canvas_plan(side)
    cap = plan.b_local
    ids = np.unique(plan.pos_index[group.rank * cap:(group.rank + 1) * cap])
    if steps is not None:
        window_batches = canvas_batch_count(plan, side * side, CANVAS_BATCH, verbose=False)
        slots, mask, _ = canvas_iteration_batches(plan, window_batches, 1)
        per = slots.shape[1] // plan.n_dev
        mine = slice(group.rank * per, (group.rank + 1) * per)
        read = slots[:steps, mine][mask[:steps, mine] > 0]
        ids = np.intersect1d(ids, plan.pos_index[read])
    meas = np.zeros((side * side, NPIX, NPIX), np.float32)  # untouched rows stay unbacked
    sim = simulate_positions(dev, init, ids)
    for start in range(0, len(ids), 4096):
        meas[ids[start:start + 4096]] = sim[start:start + 4096].cpu().numpy()
    del sim
    sim_s = time.perf_counter() - t0
    init.update(obj=random_object(init["obj"].shape, CANVAS_START_SEED), measurements=meas)
    solver = PtyRADSolver(largefov_params(niter, True), init_variables=init, device=dev,
                          verbose=False, group=group)
    solver.prepare()
    solver._build()
    shard, n_batches = solver._canvas
    if steps is not None:
        require(n_batches == window_batches, f"canvas rank {group.rank}: {n_batches} batches, "
                f"the window took {window_batches}")
    out = {"sim_s": sim_s, "setup_s": time.perf_counter() - t0, "n_batches": n_batches,
           "simulated": len(ids), "rows_local": plan.rows_local, "halo": plan.halo, "cap": cap,
           "slab_positions": int(plan.mask[group.rank * cap:(group.rank + 1) * cap].sum()),
           "store_gb": shard.store.measurements.numel() * 4 / 1e9,
           "slab_shape": list(shard.params.obja.shape)}
    grads = {}
    if first:
        slots, mask = shard.local_batches(n_batches, 1)
        total, _ = shard.loss(torch.as_tensor(slots[0], device=dev),
                              torch.as_tensor(mask[0], device=dev), solver.loss_params)
        total.backward()
        all_reduce_grads(shard.replicated_tensors(), group)
        out["first_loss"] = float(total.detach())
        grads = host_grads(shard.params, shard.gather)
    digests = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    with CollectiveCounter() as coll:
        if steps is None:
            launches = counted(lambda: solver.run(
                callback=lambda niter, p, history: digests.append(params_digest(p))))[1]
            steps = niter * n_batches
            batch = solver.history.batch_terms.get("loss_single", [])
            losses, iter_s = [v for _, v in solver.history.loss_iters], solver.history.iter_times
        else:
            slots, mask = shard.local_batches(n_batches, 1)
            (mean, terms), launches = counted(lambda: solver.train_epoch(
                torch.as_tensor(slots[:steps], device=dev),
                torch.as_tensor(mask[:steps], device=dev), 1))
            batch, losses, iter_s = terms.get("loss_single", []), [mean], []
            digests.append(params_digest(shard.whole_params()))
    tenth = max(1, len(batch) // 10)
    out.update({
        "run_s": time.perf_counter() - t1, "iter_s": iter_s, "steps": steps,
        "losses": losses, "digests": digests,
        "launches": launches, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "batch_loss_first_tenth": float(np.mean(batch[:tenth])) if batch else None,
        "batch_loss_last_tenth": float(np.mean(batch[-tenth:])) if batch else None,
        "collectives_per_step": {k: v / steps for k, v in coll.calls.items()},
        "collective_bytes_per_step": {k: v / steps for k, v in coll.bytes.items()},
        **canvas_timing(shard, group)})
    return out, grads


def canvas_rank(tmp: str, group) -> None:
    """The canvas phases' work of a rank (rank_main): canvas_largefov then
    canvas_fullscan; writes <tmp>/canvas_<rank>.json and
    canvas_<rank>_grads.npz."""
    rank = group.rank
    out = {}
    out["largefov"], grads = canvas_rank_run(CANVAS_SIDE, CANVAS_NITER, group, True)
    np.savez(f"{tmp}/canvas_{rank}_grads.npz", **grads)
    torch.cuda.empty_cache()
    out["fullscan"], _ = canvas_rank_run(CANVAS_FULL_SIDE, 1, group, False,
                                         steps=CANVAS_FULL_STEPS)
    with open(f"{tmp}/canvas_{rank}.json", "w", encoding="utf-8") as f:
        json.dump(out, f)


def canvas_reference(dev) -> tuple[dict, dict, dict]:
    """The canvas phases' one-rank replicated runs in this process, before
    the ranks start: (canvas_largefov's run and gradients, canvas_fullscan's
    peak)."""
    t0 = time.perf_counter()
    ref, ref_grads = canvas_replicated(dev, CANVAS_SIDE, CANVAS_NITER)
    torch.cuda.empty_cache()
    full_ref = canvas_replicated_peak(dev, CANVAS_FULL_SIDE)
    torch.cuda.empty_cache()
    ref["reference_s"] = time.perf_counter() - t0
    return ref, ref_grads, full_ref


def canvas_check(card: str, refs: tuple, tmp: str, ranks_s: float) -> tuple[dict, dict]:
    """canvas_largefov and canvas_fullscan: CANVAS_WORLD gloo ranks on cuda:0
    ran both phases (rank_main; their output in <tmp>) against the one-rank
    replicated runs (canvas_reference). Gates as in CANVAS_WORLD's comment;
    each rank launched B1, B2, B3a and B3b. Returns (the largeFOV ranks'
    summed launches, the full scan ranks')."""
    ref, ref_grads, full_ref = refs
    outs, rank_s = [], []
    for r in range(CANVAS_WORLD):
        with open(f"{tmp}/canvas_{r}.json", encoding="utf-8") as f:
            outs.append(json.load(f))
        with open(f"{tmp}/rank_{r}_s.json", encoding="utf-8") as f:
            rank_s.append(json.load(f)["canvas_s"])
    grads = [dict(np.load(f"{tmp}/canvas_{r}_grads.npz")) for r in range(CANVAS_WORLD)]

    def per_rank(o):
        return {k: v for k, v in o.items() if k not in ("digests", "launches")} | {
            "launches": {name: o["launches"][name] for name in CANVAS_KERNELS}}

    ranks = [o["largefov"] for o in outs]
    grad_err = {name: max(float(np.abs(g[name] - ref_grads[name]).max()) for g in grads)
                for name in ref_grads}
    grad_max = {name: float(np.abs(g).max()) for name, g in ref_grads.items()}
    loss_err = [abs(o["first_loss"] - ref["first_loss"]) / abs(ref["first_loss"]) for o in ranks]
    traj_err = [_max_rel(o["losses"], ref["losses"]) for o in ranks]
    emit({"phase": "canvas_largefov", "card": card, "world": CANVAS_WORLD, "backend": "gloo",
          "n_patterns": CANVAS_SIDE ** 2, "batch": CANVAS_BATCH, "iterations": CANVAS_NITER,
          "reduced": "512 x 512 scan cut to 256 x 256", "start": "seeded", "ranks_s": ranks_s,
          "rank_canvas_s": rank_s,
          "one_rank": ref, "first_loss_rel_err": loss_err, "first_loss_rtol": CANVAS_LOSS_RTOL,
          "grad_max_abs": grad_max, "grad_max_abs_err": grad_err,
          "grad_rel_err": {k: v / grad_max[k] if grad_max[k] else None
                           for k, v in grad_err.items()},
          "grad_rtol": CANVAS_GRAD_RTOL,
          "trajectory_max_rel_err": traj_err, "trajectory_rtol": CANVAS_TRAJ_RTOL,
          "peak_mem_ratio": [o["peak_mem_gb"] / ref["peak_mem_gb"] for o in ranks],
          "ranks": [per_rank(o) for o in ranks],
          "digests_equal": all(o["digests"] == ranks[0]["digests"] for o in ranks)})
    full = [o["fullscan"] for o in outs]
    emit({"phase": "canvas_fullscan", "card": card, "world": CANVAS_WORLD, "backend": "gloo",
          "n_patterns": CANVAS_FULL_SIDE ** 2, "batch": CANVAS_BATCH,
          "steps": CANVAS_FULL_STEPS, "reduced": f"the first {CANVAS_FULL_STEPS} batches of "
          f"a rank's {full[0]['n_batches']} in iteration 1, only the patterns they read "
          "simulated", "replicated": full_ref,
          "peak_mem_ratio": [o["peak_mem_gb"] / full_ref["peak_mem_gb"] for o in full],
          "ranks": [per_rank(o) for o in full],
          "digests_equal": all(o["digests"] == full[0]["digests"] for o in full)})
    for phase, runs, niter in (("canvas_largefov", ranks, CANVAS_NITER),
                               ("canvas_fullscan", full, 1)):
        for r, o in enumerate(runs):
            require(len(o["losses"]) == niter and all(np.isfinite(o["losses"])),
                    f"{phase} rank {r}: losses {o['losses']}")
            for name in CANVAS_KERNELS:
                require(o["launches"][name] > 0, f"{phase} rank {r}: {name} not launched")
            require(o["digests"] == runs[0]["digests"] and len(o["digests"]) == niter,
                    f"{phase}: the ranks' parameters part")
            require(o["losses"] == runs[0]["losses"], f"{phase}: the ranks' losses part")
    require(max(loss_err) <= CANVAS_LOSS_RTOL, f"canvas_largefov: first loss {loss_err}")
    require(set(grad_err) == set(CANVAS_GRAD_RTOL),
            f"canvas_largefov: gradients of {set(grad_err)}")
    for name, err in grad_err.items():
        require(grad_max[name] > 0, f"canvas_largefov: the reference's gradient of {name} is 0")
        require(err <= CANVAS_GRAD_RTOL[name] * grad_max[name],
                f"canvas_largefov: gradient of {name} off by {err} (largest entry "
                f"{grad_max[name]})")
    require(max(traj_err) <= CANVAS_TRAJ_RTOL, f"canvas_largefov: trajectory off by {traj_err}")
    require(full_ref["finite"], "canvas_fullscan: the replicated steps' loss is not finite")
    for r, o in enumerate(full):
        require(o["batch_loss_last_tenth"] < o["batch_loss_first_tenth"],
                f"canvas_fullscan rank {r}: the batch loss did not fall "
                f"({o['batch_loss_first_tenth']} -> {o['batch_loss_last_tenth']})")
        require(o["peak_mem_gb"] < full_ref["peak_mem_gb"],
                f"canvas_fullscan rank {r}: peak memory {o['peak_mem_gb']} GB is not below the "
                f"replicated run's {full_ref['peak_mem_gb']} GB")
    return (add_counts(*[o["launches"] for o in ranks]),
            add_counts(*[o["launches"] for o in full]))


def canvas_rank_batch(side: int) -> tuple[int, np.ndarray]:
    """The batch a canvas rank launches its kernels on at side x side (the
    width of its block of canvas_iteration_batches, its real slots and the
    padding ones), and the last rank's corners in iteration 1's first batch,
    rebased to its slab."""
    from ptyrad_tpu_torch.parallel import slab_local_positions
    from ptyrad_tpu_torch.parallel.canvas import canvas_batch_count, canvas_iteration_batches

    plan = canvas_plan(side)
    crop_pos, _ = canvas_raster(side)
    n_batches = canvas_batch_count(plan, side * side, CANVAS_BATCH, verbose=False)
    slots, _, _ = canvas_iteration_batches(plan, n_batches, 1)
    per, last = slots.shape[1] // CANVAS_WORLD, CANVAS_WORLD - 1
    corners = slab_local_positions(crop_pos, plan.pos_index, plan.rows_local, plan.n_dev,
                                   plan.b_local)
    return per, corners[slots[0, last * per:(last + 1) * per]]


def canvas_kernel_rows(dev, gen) -> list:
    """B1 and B2 at the canvas phases' halo-extended slab shapes,
    (1, NZ, rows_local + halo, canvas), and B3a/B3b, each at the batch a
    canvas rank launches (canvas_rank_batch); B1/B2 at the last rank's
    corners with patch_corners' edge cases (a negative corner among
    them)."""
    rows = []
    for side, suffix in ((CANVAS_SIDE, CANVAS_SLAB), (CANVAS_FULL_SIDE, CANVAS_FULL_SLAB)):
        plan = canvas_plan(side)
        canvas = canvas_raster(side)[1]
        per, corners = canvas_rank_batch(side)
        h = plan.rows_local + plan.halo
        rows += check_patches_at(dev, gen, NZ, h, canvas, NPIX,
                                 patch_corners(dev, gen, corners, h, canvas, NPIX, per), suffix)
        torch.cuda.empty_cache()
        rows += check_loss_chain(dev, gen, batch=per, suffix=suffix)
        torch.cuda.empty_cache()
    return rows


def kernel_rows(dev, gen, atomic_b2: bool = False, atomic_b3: bool = False,
                checks=KERNEL_CHECKS) -> list:
    """Every kernel against its plain version at the main paths' shapes, and
    its times: the rows of the kernels line (chain_bench.py times the same
    rows, or those of the named ``checks``; `atomic_b2` as in
    check_patches_at, `atomic_b3` as in check_loss_chain)."""
    rows = []
    for name in checks:
        if name == "check_patches":
            rows += check_patches(dev, gen, atomic_b2)
        elif name in ("check_loss_chain", "check_dp_chain"):
            rows += globals()[name](dev, gen, atomic_b3)
        else:
            rows += globals()[name](dev, gen)
        torch.cuda.empty_cache()
    return rows


PHASE_SECONDS = {}  # each phase of main -> host seconds (the phase_seconds line)


@contextlib.contextmanager
def phase(name: str):
    """Add the host seconds of the block to PHASE_SECONDS[name]."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; this script runs on a GPU",
              file=sys.stderr)
        return 2
    from ptyrad_tpu_torch.device import pin_fp32
    from ptyrad_tpu_torch.ops import _build
    from ptyrad_tpu_torch.ops import chain as C
    from ptyrad_tpu_torch.ops import fused_multislice as M

    start = time.perf_counter()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    pin_fp32()
    card = gpu_line()
    emit({"phase": "device", "card": card, "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "tf32_cudnn": torch.backends.cudnn.allow_tf32})

    with phase("build"):
        t0 = time.perf_counter()
        # the mixed-radix libraries (B3/B4's, B5/B6's) beside the main one
        path = _build.build(extra_n=MIXED_NS + CHAIN_NS, bf16_n=BF16_MIXED_NS)
        _build.lib()
        for n in (PSO_NPIX, 512) + CHAIN_NS:
            C.prepare(dev, n)
        for n in (NPIX,) + MIXED_NS:
            M.prepare(dev, n)
        emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": path.name,
              "compiled": _build.BUILD_SECONDS is not None, "main_seconds": _build.BUILD_SECONDS,
              "mixed_seconds": {str(n): s for n, s in _build.MIXED_BUILD_SECONDS.items()},
              "fused_plan": {str(n): fused_plan(n) for n in (NPIX,) + MIXED_NS},
              "chain_plan": {str(n): chain_plan(n) for n in CHAIN_NS}})

    gen = torch.Generator(device=dev).manual_seed(SEED)
    with phase("kernel_rows"):
        kernels = kernel_rows(dev, gen)
    with phase("bf16_rows"):
        kernels += check_bf16_kernels(dev, gen, kernels)
        torch.cuda.empty_cache()
    with phase("propagation_yardstick"):
        propagation_yardstick(dev, gen)
        torch.cuda.empty_cache()
    with phase("fused_route"):
        route_launches = fused_route_check(dev)

    with phase("tBL"):
        solver, tbl_launches, init, main_record = main_path(dev, card)
        main_losses = [v for _, v in solver.history.loss_iters]
        main_state = final_state(solver)  # before the profile's steps move it
        corr32 = quality_check("tBL", card, solver.params.objp,
                               ground_truth_phase(tbl_positions()[1]), *tbl_scanned())
        profile_steps(solver, card, "tBL", NITER + 1, n_batches=32)
        del solver
        torch.cuda.empty_cache()
    with phase("mixed_precision"):
        solver, mp_launches = mixed_precision_path(dev, card, init, main_state, corr32)
        profile_steps(solver, card, "tBL-bf16", NITER + 1, n_batches=32)
        del solver, main_state
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        with phase("params_file"):
            params_file_launches, raw_path = params_file_path(
                dev, card, init["measurements"].cpu().numpy(), tmp)
            torch.cuda.empty_cache()
        with phase("resume"):
            resume_record = RunRecord()
            resume_launches, solver = resume_path(dev, card, init, main_losses, tmp,
                                                  resume_record)
            determinism_check("tBL", card, main_record, resume_record, solver)
            torch.cuda.empty_cache()
        with phase("cli"):
            cli_path(card, tmp, raw_path, solver)
            del solver
            torch.cuda.empty_cache()
        with phase("figures"):
            figures_launches = figures_path(dev, card, tmp, raw_path)
        with phase("hypertune"):
            hypertune_launches = hypertune_path(dev, card, tmp, raw_path)
        with phase("cli_subprocesses"):
            # the other CLI subprocesses at once (the hypertune worker after
            # the study it joins): each spends most of its time starting, and
            # no gate reads their seconds; cli_path ran alone, it times the
            # start
            loopback_env()
            with concurrent.futures.ThreadPoolExecutor(4) as pool:
                jobs = [pool.submit(fn, card, tmp, raw_path)
                        for fn in (cli_mixed_precision, dist_cli_path, hypertune_cli_path,
                                   cli_commands)]
                for job in jobs:
                    job.result()
    torch.cuda.empty_cache()
    with phase("lbfgs"):
        lbfgs_launches = lbfgs_path(dev, card, init)
        torch.cuda.empty_cache()
    with phase("grad_accum"):
        accum_launches = grad_accum_path(dev, card, init)
        torch.cuda.empty_cache()
    with phase("optimizers"):
        family_launches = optimizers_path(dev, card, init)
        torch.cuda.empty_cache()
    with phase("grouping"):
        grouping_launches = grouping_path(dev, card, init)
        torch.cuda.empty_cache()
    with phase("forward_modes"):
        forward_launches = forward_modes_check(dev, init)
        torch.cuda.empty_cache()
        forward_bf16_launches = forward_bf16_check(dev, init)
        torch.cuda.empty_cache()
    with phase("low_dose"):
        solver, low_dose_launches = low_dose_path(dev, card, init)
        profile_steps(solver, card, "low-dose", NITER + 1, n_batches=32)
        store_data = tbl_store_dataset(init)
        del solver
        torch.cuda.empty_cache()
    with phase("dev_tools"), tempfile.TemporaryDirectory(prefix="chip_smoke_dev_tools_") as tmp:
        dev_tools_launches = dev_tools_path(dev, card, init, tmp)
    torch.cuda.empty_cache()
    with phase("dist_canvas"), tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
        dist_ref = dist_reference(dev, init, main_losses, tmp)
        del init  # before the canvas references, whose peak memory the ranks are held under
        torch.cuda.empty_cache()
        dist_launches, canvas_launches, canvas_full_launches = ranks_path(dev, card, dist_ref,
                                                                          tmp)
        kernels += canvas_kernel_rows(dev, gen)
    with phase("tbl_store"):
        solver, store_launches = tbl_store_path(dev, card, store_data)
        profile_steps(solver, card, "tBL-store", NITER + 1, n_batches=32)
        del solver, store_data
        torch.cuda.empty_cache()
    with phase("constraints"):
        constraints_check(dev)
        torch.cuda.empty_cache()
    with phase("pso"):
        solver, pso_launches, pso_init, pso_ref = pso_path(dev, card)
        pso_ms = profile_steps(solver, card, "PSO", PSO_NITER + 1,
                               n_batches=8)["device_ms_per_step"]
        del solver
        torch.cuda.empty_cache()
    fused_launches = []
    for n in PSO_FUSED:  # pso_n120, pso_n127
        with phase(f"pso_n{n}"):
            solver, path_launches, fused_init = pso_fused_path(dev, card, pso_init, n)
            profile_steps(solver, card, f"PSO-n{n}", PSO_NITER + 1, n_batches=8)
            del solver
            torch.cuda.empty_cache()
            fused_launches += [path_launches, fused_tilt_gate(dev, fused_init, n)]
            del fused_init
            torch.cuda.empty_cache()
    pad_launches = []
    for n in PSO_PADS:  # pso_n192, pso_n254
        with phase(f"pso_n{n}"):
            solver, path_launches, pad_init = pso_pad_path(dev, card, pso_init, n)
            profile_steps(solver, card, f"PSO-n{n}", PSO_NITER + 1, n_batches=8)
            pad_launches += [path_launches, pad_exit_check(solver, n)]
            del solver
            torch.cuda.empty_cache()
            pad_launches.append(pad_tilt_gate(dev, pad_init, n))
            del pad_init
            torch.cuda.empty_cache()
    with phase("pso_n1024"):
        n1024_launches, n1024_rows = pso_n1024_path(dev, card, pso_init)
        kernels += n1024_rows
    with phase("pso_bf16"):
        solver, pso_bf16_launches = pso_bf16_path(dev, card, pso_init, pso_ref)
        profile_steps(solver, card, "PSO-bf16", PSO_NITER + 1, n_batches=8)
        del solver
        torch.cuda.empty_cache()
    with phase("pso_ff"):
        solver, pso_ff_launches = pso_ff_path(dev, card, pso_init, pso_ref)
        pso_ff_ms = far_field_on(
            lambda: profile_steps(solver, card, "PSO-ff", PSO_NITER + 1, n_batches=8)
        )["device_ms_per_step"]
        emit({"phase": "pso_ff_profile", "card": card,
              "device_ms_per_step": {"pso": pso_ms, "pso_ff": pso_ff_ms}})
        del solver
        torch.cuda.empty_cache()
        random_start_launches = pso_ff_random_start(dev, pso_init)
        torch.cuda.empty_cache()
    with phase("carve"):
        carve_launches = carve_check(dev, pso_init)
        torch.cuda.empty_cache()
        pso_bf16_forward_launches = forward_bf16_pso(dev, pso_init)
        del pso_init
        torch.cuda.empty_cache()
    with phase("tilt"):
        solver, tilt_launches = tilt_path(dev, card)
        profile_steps(solver, card, "tBL-tilt", NITER + 1, n_batches=32)
        del solver
        torch.cuda.empty_cache()
    with phase("pso_tilt"):
        solver, pso_tilt_launches = pso_tilt_path(dev, card)
        profile_steps(solver, card, "PSO-tilt", PSO_NITER + 1, n_batches=8)
    # the canvas ranks' B1-B3 launches count in the canvas rows alone; the
    # one-rank reference of canvas_largefov (the two slabs' batch on the
    # whole canvas) is a comparison and counts in no row
    canvas_ranks = add_counts(canvas_launches, canvas_full_launches)
    narrow = add_counts(route_launches, tbl_launches, params_file_launches, resume_launches,
                        forward_launches, low_dose_launches, store_launches, tilt_launches,
                        lbfgs_launches, accum_launches, family_launches, figures_launches,
                        hypertune_launches, mp_launches, forward_bf16_launches, dist_launches,
                        dev_tools_launches, *fused_launches,
                        {k: 0 if k in CANVAS_KERNELS else v for k, v in canvas_ranks.items()},
                        *([grouping_launches] if grouping_launches else []))
    wide = add_counts(pso_launches, pso_ff_launches, random_start_launches, carve_launches,
                      pso_tilt_launches, pso_bf16_launches, pso_bf16_forward_launches,
                      *pad_launches)
    launches = add_counts(narrow, wide)
    # a chain row at N = 2^k counts the power-of-two build's launches: less
    # those of the mixed builds, which have rows of their own
    for name, _, _ in CHAIN_SPLITS:
        if name in launches:
            launches[name] -= sum(launches[per_n(name, n)] for n in CHAIN_NS)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    launches.update({name: 0 for name in NOT_DRIVEN})
    # B1/B2's rows at the tBL shapes count the launches of the N <= 128 runs,
    # their rows at the PSO shapes those of the N = 256, 192 and 254 runs,
    # their rows at N = 1024 those of pso_n1024's four windows
    for name in PATCH_KERNELS:
        launches[name], launches[name + PSO_SHAPES] = narrow[name], wide[name]
        launches[name + N1024_SHAPES] = n1024_launches[name]
    for name in CANVAS_KERNELS:
        launches[name + CANVAS_SLAB] = canvas_launches[name]
        launches[name + CANVAS_FULL_SLAB] = canvas_full_launches[name]
    emit({"phase": "phase_seconds", "card": card, "seconds": PHASE_SECONDS,
          "total_s": time.perf_counter() - start})
    emit({"kernels": [{key: {**k, "launches": launches[k["name"]]}[key] for key in keys}
                      for k in kernels]})
    print(card)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
