#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA card.

Run from the root of the repository, with no arguments::

    python3 chip_smoke.py

``python3 chip_smoke.py --kaisa-only`` builds the kernels and runs the
KAISA phase (5 below) alone, for a machine with a card per rank.

It needs one CUDA card and ``nvcc`` (``sm_90a``), and imports nothing of
JAX or of the JAX package.  Phases, each of which exits non-zero when it
fails:

1. the card's name and power limit (``nvidia-smi``), then the build of
   every CUDA kernel from ``kfac_pytorch_tpu_torch/csrc`` and its time;
2. every kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it (ResNet-32's six bucket stacks, and
   GPT-125M's five, ResNet-50's 21, ViT-B/16's six and BERT-large's six
   below), in f32 (``rtol 1e-5, atol 1e-4``) and in
   bf16 (against f32: mean relative error < 0.05), with two runs giving
   bitwise-equal outputs; times of the kernel, its plain version and
   the cuBLAS ``torch.matmul`` chain, with CUDA events, and the device
   time of one step's kernel calls replayed as one CUDA graph; per case
   a ``profile`` line with the device time of each CUDA kernel the call
   issued (``torch.profiler``; the kernel names carry the tiling),
   failing if the profiler sees none or a main-path call issues more
   than two; the kernels line's ``kernels_per_call`` is that count.
   The bound is the least time of
   an f32-exact result, the larger of the bytes and the lesser of the
   f32 CUDA-core FMA and 3xTF32 tensor-core times; the bound with every
   operation on the CUDA cores is printed beside it
   (``bound_cuda_core_ms``);
3. the main path: CIFAR ResNet-32 at batch 128 trained for 20 K-FAC
   steps on one fixed synthetic batch through ``KFACPreconditioner``,
   counting kernel launches, checking one step's preconditioned
   gradients against a rerun of the same state through the plain
   version, and timing the step and its stages;
4. the sharded kernel (``fused_eigen_precondition_sharded``) on one
   rank's MEM-OPT shard shapes of ResNet-32 at world 4: times of the
   kernel, its plain version and the cuBLAS chain on one step's six
   shards, each with its ``profile`` line (at most two kernels);
5. the KAISA path: four ranks (``torch.multiprocessing`` spawn; NCCL
   when there is a card per rank, gloo otherwise, so on one card all
   four share it) train ResNet-32 wrapped in ``DistributedDataParallel``
   at a global batch of 128 for 12 steps under each of COMM-OPT,
   HYBRID-OPT and MEM-OPT, twice: a timing pass with each collective
   synchronized and timed, then the checked pass, which runs the path
   as a user does and gives the step times.  Each rank checks a finite,
   falling loss, parameters bitwise equal across ranks after every
   step, kernel launches equal to steps x buckets, the refresh step's
   preconditioned gradients against a single-process rerun from the
   same averaged factors and raw gradients, and the sharded kernel
   against its plain version through the rank's grid row in f32 and
   bf16.  Then ``compute_method='inverse'`` and ``'iterative'`` under
   HYBRID-OPT (a column and a row gather), one checked pass of 12 steps
   each, with the same gates (no fused-kernel launch; the iterative
   rerun replays both refreshes, so its warm seeds match).  Step and
   collective times there are correctness-path times, not a scaling
   result;
6. the other methods: ResNet-32 as in phase 3 with
   ``compute_method='inverse'``, ``'iterative'`` and
   ``compute_eigenvalue_outer_product=False``: a finite, falling loss,
   no fused-kernel launch (cuSOLVER and cuBLAS calls, as the JAX
   package runs these paths outside its Pallas kernel), the refresh
   step's buckets and preconditioned gradients against a CPU rerun
   from the same factor EMAs, warm seeds and raw gradients (relative
   Frobenius error ``< 1e-4`` per slot and per layer), stage times; for
   the iterative method the depths run (30, then 3) and the residuals:
   every slot within ``tol`` after the bootstrap, and after the warm
   refresh every slot whose warm seed the gate took (a slot it sends
   back to a cold seed gets the warm depth only, as in the JAX package,
   and is printed);
7. checkpoint and resume: eigen, inverse, low-rank eigen
   (``lowrank_rank=64``: five of ResNet-32's six buckets truncate their
   A side) and EKFAC (its scales in the checkpoint) saved after step 10
   (model, SGD, ``precond.state_dict()`` dense and packed as upper
   triangles) and resumed for steps 11-19 must end bitwise equal to the
   uninterrupted run (cuDNN held to its deterministic algorithms); the
   iterative restore must refresh at bootstrap depth and train on;
8. the transformer path: GPT-125M at its published widths (vocab 50304,
   12 layers, 12 heads, ``d_model`` 768, ``d_ff`` 3072, bf16 compute,
   f32 parameters) on one synthetic batch of 4 x 2048 tokens, 12 steps
   with full coverage (``layer_types`` with ``'embedding'`` and
   ``'layernorm'``, ``tied_weights=('wte',)``): a finite, falling loss,
   kernel launches equal to steps x 5 buckets, one factor set for the
   tied embedding, and at the refresh step 10 every layer's
   preconditioned gradient (embedding and LayerNorms included) and the
   kl-clip scale against a rerun on the card from the same
   decompositions through the plain version (relative Frobenius error
   ``< 1e-4``); the step and stage medians, the kernel's share,
   ``torch.cuda.max_memory_allocated()`` and ``memory_usage()``.  Then 3
   steps with the default coverage (48 Dense layers, 4 buckets).  Phase
   2 holds the kernel against its plain version at GPT-125M's five
   bucket shapes too, at most four CUDA kernels per call there (every
   GPT bucket has ``gp > 64``);
9. the ImageNet CNN path: ResNet-50 at its published widths (1000
   classes, 54 layers in 21 buckets) at batch 32 on 224x224 synthetic
   images, f32, ``factor_update_steps=10, inv_update_steps=100``: 21
   steps (factor steps 0, 10 and 20, the refresh at 0), then 11 steps
   with ``accumulation_steps=4`` at micro-batches of 8.  Each run: a
   finite, falling loss, kernel launches equal to steps x 21 buckets,
   and at step 0 every layer's preconditioned gradient and the kl-clip
   scale against a rerun on the card through the plain version
   (relative Frobenius error ``< 1e-4``); stage medians, peak memory and
   ``memory_usage()``.  Then the factors of one factor step taken in 4
   micro-batches of 8 against one batch of 32 (BatchNorm in eval mode
   for this check, so the splits normalize alike; relative ``< 1e-5``;
   A equal, G equal to 4^2 times the whole batch's, as the JAX
   package's accumulation takes each micro-batch's G from the gradients
   of its own mean loss),
   and one ``kfac_pytorch_tpu_torch.bench`` line for ResNet-50 and
   ResNet-32 at a shortened cycle (inv 20, one cycle).  Phase 2 holds
   the kernel at ResNet-50's 21 bucket shapes.
10. the vision transformer: ViT-B/16 at its published widths and depth
    (224x224 images, 16x16 patches, 1000 classes, 12 layers, bf16
    compute, f32 parameters) at batch 32 on one synthetic batch, 12
    steps with full coverage (``layer_types=('linear', 'conv2d',
    'layernorm')``: the patchify conv, 48 Dense layers, the head and 25
    LayerNorms in six buckets), refreshes at 0 and 10: the gates of
    phase 8 (a finite, falling loss, launches equal to steps x buckets,
    the refresh step 10 against a plain rerun on the card for every
    layer), the buckets equal to phase 2's shapes, the stage medians,
    peak memory, ``memory_usage()`` and ``coverage_report()`` (only
    ``pos_embed`` uncovered);
11. the BERT-large encoder (vocab 30522, 24 layers, 16 heads, ``d_model``
    1024, bf16 compute) on 4 x 384 tokens, the last 64 positions of two
    rows masked, no type ids, the span loss, ``examples/squad_bert.py``'s
    damping and kl-clip, 7 steps with full coverage (``layer_types=(
    'linear', 'embedding', 'layernorm')``: 96 Dense layers, ``qa_head``
    and 49 LayerNorms in six buckets, ``wte`` on the diagonal side
    path), refreshes at 0 and 5, with phase 10's gates and lines (only
    ``wpe`` uncovered);
12. randomized low-rank eigen on ResNet-50: phase 9's batch,
    ``lowrank_rank=512`` (oversample 32, two power iterations), a factor
    update every step, refreshes at 0, 5 and 10, 11 steps.  The
    truncated sides must be the eleven buckets of ``RN50_LOWRANK_SIDES``
    and the fused kernel must launch 10 times a step, at the ten exact
    buckets (phase 2 holds it there too), matching its plain version at
    step 10; at the step-10 refresh every truncated side's Ritz values
    must lie below the float64 eigenvalues of the same factor, a rerun
    from the same factors and sketch step must give the same bits, and
    the truncated buckets' preconditioned gradients must agree with a
    float64 CPU evaluation of the same code on the card's sketches
    (``RN50_LOWRANK_F64_GATE``); phase 9's lines, the captured trace
    fraction, and the refresh and ``memory_usage()`` beside phase 9's;
13. EKFAC on ResNet-50 with ``AdaptiveRefresh(threshold=0.2,
    min_interval=4)``: phase 9's batch, a factor update every step,
    inv 100, 12 steps.  No fused-kernel launch (EKFAC keeps no
    ``dgda``); ``skron == dg ⊗ da`` bitwise after every refresh; step
    2's scale update against a float64 CPU recompute from the captured
    rows and basis (``<= 1e-5``); at least one refresh the drift asked
    for, off the cadence; the drift at every factor step, the stage
    medians and the ``ekfac scales`` stage;
14. the staggered refresh on ResNet-50: phase 9's batch, a factor update
    every step, inv 10, ``stagger_refresh=5``, 21 steps, then the same
    21 steps monolithic.  Gates: the cadence (the monolithic bootstrap
    at step 0, then shard ``s % 10`` at every phase below 5: shards 1-4
    at steps 1-4, 0-4 at 10-14 and 20; never a monolithic refresh
    again), 21 kernel launches a step, finite falling losses, the
    shard-0 step against a plain rerun; on the last factors, a sweep of
    the five shards against one monolithic refresh (every slot's ``dgda``
    and ``q diag(d) q^T`` within ``max(1e-4, 4 n eps)``, eigenvectors
    orthonormal within ``1e-3``); a checkpoint after step 12 resumed to
    step 16 by fresh objects bitwise equal to the same run restored in
    place, on the shard cadence.  Prints each mode's step p50/p95/max,
    every shard refresh's time and the plan's costs;
15. the drift-adaptive staggered refresh: phase 14's configuration with
    ``AdaptiveRefreshConfig(threshold=0.2, staleness_factor=3,
    record_events=True)``, 40 steps, twice.  Gates from the controller's
    events: at most one refresh per shard per interval, every age at a
    decision at most ``3 * 10 - 1``, the rerun's decisions identical; 21
    launches a step.  Prints the counters and the host reads of the
    drift per factor step.

16. the deferred refresh (``overlap_comm=True``) on ResNet-50 with
    phase 9's batch: on frozen weights (no optimizer step; factor 1, inv
    5, 12 steps, cuDNN deterministic) a synchronous and an overlap run
    side by side, the overlap stacks after every step ``t >= 1`` bitwise
    the synchronous stacks after ``t - 1``, the preconditioned gradients
    bitwise equal off the due steps and different on them, the factor
    EMAs equal; then phase 14's configuration (factor 1, inv 10, SGD with
    momentum), 22 steps: monolithic (the bootstrap in band at 0, the
    refreshes due at 10 and 20 installed at 11 and 21), the same
    run under ``torch.profiler`` around each deferred refresh (how much of
    the side stream's device time ran while another stream ran), and
    staggered at ``stagger_refresh=5`` (each shard one step after its
    due step), whose state after step 12 (shard 2 pending) restored by
    fresh objects drops the pending refresh: with the recompute the
    shard cadence resumes deferred, without it the next due refresh (20)
    runs in band.  Gates: the cadences, 21 launches a step, finite
    falling losses.  Prints the step p50/p95/max beside phase 14's
    synchronous runs and each deferred refresh's device time (CUDA events
    on the side stream) beside phase 14's in-band ones;
17. the pipelined gradient gather on ResNet-50 at world 4 on one card
    over gloo (phase 5's spawn), 8 images per rank: under HYBRID-OPT and
    MEM-OPT, factor 10, inv 100, 4 steps with the synchronous tail and
    4 with ``pipeline_grads=True`` (cuDNN deterministic): the pipelined
    run's preconditioned gradients and parameters bitwise the
    synchronous run's at every step, parameters bitwise equal across
    ranks, 21 launches a step on every rank, finite falling losses; the
    tail's time (the precondition stage between two synchronizes) and
    the step medians of both; then 7 steps with ``overlap_comm`` and
    ``pipeline_grads`` together under HYBRID-OPT (factor 5, inv 5): the
    cadence and the pending decisions identical on every rank.  The
    kernels line's entry is timed at rank 0's HYBRID-OPT shard shapes.
18. EKFAC across the grid on ResNet-50 at world 4 on one card over
    gloo, 8 images per rank, factor 1, inv 2, 2 steps under COMM-OPT,
    HYBRID-OPT and MEM-OPT (the last two stepped with COMM-OPT's
    preconditioned gradients, so all three see the same weights; cuDNN
    deterministic): the grids' losses and preconditioned gradients
    within 1e-4 of COMM-OPT's, ``ekfac_divergence`` bitwise on every
    rank, no fused-kernel launch, finite falling losses, and a
    state-dict round trip at ``cols > 1`` (saved before step 1)
    resuming bitwise.  Prints the counted bytes of the three designs of
    EKFAC with several columns at both grids and the second-order bytes
    a rank holds;
19. the fused training path on ResNet-50 with phase 9's batch and
    cadence and ``damping=AdaptiveDamping(0.003, interval=5)``, 15
    steps through ``make_train_step``, through ``train_loop`` and
    through ``step()`` fed by hand from ``last_step_info['vg_sum']``
    and a loss-only forward: the fused runs bitwise the hand-fed one
    (losses, damping, ``rho``, ``vg_sum``, parameters and BatchNorm
    buffers), 21 launches a step, finite falling losses, the damping
    moved.  Prints the damping and ``rho`` sequences and the loss-only
    forward's device time as a share of the step;
20. the numerical-health guardrails on ResNet-50 with phase 9's batch,
    factor 1, inv 3, ``train_loop`` with SGD momentum: ``HealthConfig()``
    bitwise the guardrails off over 6 steps, then a NaN pixel at step 7
    skipped (parameters, momentum, BatchNorm buffers and factor EMAs
    bitwise unchanged, ``vg_sum`` 0); an injection run (inv 2) that
    fails two slots (one of ``a576g64``'s three, the one of
    ``a2176g1024``): the first attempt only (retries, no fallback), with
    one layer's factors poisoned (``factor_resets`` 2), then every
    attempt (a fallback, then quarantine after 2 refreshes); the
    quarantined slots' gradients their raw gradients bitwise behind the
    fused kernel; 21 launches a step.  Prints the median step health on
    and off and the host reads a step and a refresh;
21. the cross-replica consistency guard on ResNet-50 at world 4 on one
    card over gloo, HYBRID-OPT, 8 images per rank, frozen weights,
    ``ConsistencyConfig(cadence=2, quarantine_after=2)``, 13 steps: one
    flipped bit of rank 1's factor EMA and of rank 2's ``qa`` slot
    counted exactly and repaired (a follow-up check clean) with the
    bootstrap flags down; the slot flipped again quarantined on the
    ranks of its grid column; one rank's drifted damping counted, not
    repaired; ``repair='detect'`` counting and leaving the divergence;
    the same counters on every rank; the sharded kernel 21 times a
    step.  Prints the check step's extra time over a plain step and the
    bytes each check gathers;
22. streaming checkpoints on ResNet-50 (phase 9's widths and batch,
    factor 1, inv 4, SGD momentum): ``elastic.save_streaming`` after
    step 2 with the model and SGD state as extras, training on to step
    5 and a second save cut short before its manifest (its first
    shard, truncated by ``testing.corrupt_checkpoint``); a
    fresh model and preconditioner ``restore_streaming`` (the walk skips
    and names the cut generation) and replay steps 3-5: parameters and
    the first replayed step's preconditioned gradients bitwise the
    uninterrupted run's, no ``eigh`` call and no decomposition kernel
    (``torch.profiler``) between the restore and that step, 21 fused
    launches on it, the kernel against its plain version on the
    restored stacks.  Then a resize: world 4 at MEM-OPT (four columns)
    on one card over gloo, 8 images a rank, saves after step 1; world 2
    at HYBRID-OPT (two columns) restores: the factor EMAs and every
    transplanted slot bitwise the saved values, the bootstrap flags
    down, the sharded kernel on the transplanted stacks (against its
    plain version through the grid row), the next due refresh forced to
    the monolithic bootstrap.  Prints the generation's bytes, the save
    and restore times, the slot counts and one monolithic refresh time;
23. the trajectory watchdog on ResNet-50 through ``train_loop``: a
    finite poison of every factor EMA (x1e-4, once) detected at a check
    through ``vg_sum``, softened (rung 1), then
    rolled back (rung 2) onto the newest ``healthy`` generation with
    the factor EMAs, stacks, model and SGD state bitwise as saved, the
    damping and kl-clip escalated on re-entry, a clean replay with 21
    fused launches a step, one host read per check; then two ranks
    (ResNet-32, gloo) with different local losses take the same rungs
    through one all-reduce per check;
24. observe and flight on ResNet-50 (phase 9's widths and batch, factor
    1, inv 3, kl-clip 0.001, 7 steps through ``train_loop``), off and
    with ``ObserveConfig(monitor=True, annotate=True, timeline=True)``
    and ``FlightConfig(window=8, flush_every=4)``: parameters and the last
    step's gradients bitwise equal; ``observe/kl_nu`` and
    ``observe/precond_grad_norm`` within 1e-5 of the plain version's on
    the same stacks and raw gradients; the Kronecker extremes within the
    eigen gate of a float64 ``eigvalsh`` of the factor EMAs; under
    ``torch.profiler`` every fused-kernel launch inside
    ``kfac/precondition`` and every ``eigh`` kernel inside
    ``kfac/eigh_refresh``; observe adds one synchronize a step (the
    timeline) and flight one device-to-host copy per flush; the
    ``profile_phases`` times and the on-against-off step delta;
25. the runtime and a rank death: four ranks on the card over gloo up
    through ``runtime.initialize_distributed`` (CIFAR ResNet-32, 32
    images a rank, HYBRID-OPT, factor 1, inv 3, monitor, health, a
    streaming generation every 2 steps, flight), the ledger's rows equal
    to the bytes the collectives moved on a step without and one with a
    factor update; after an uninterrupted reference run rank 3 is
    SIGKILLed once ``gen-4`` is committed: ranks 0-2 exit 87 within
    grace + 2 heartbeat intervals + 1 s, ``rank_death.json`` names rank
    3, every postmortem validates and rank 3's last snapshot equals the
    reference series bitwise; two fresh ranks restart at world 2 (1x2,
    the saved two-column layout), ``restore_streaming`` the generation
    and run a step with the sharded kernel held against its plain
    version;
26. the MoE flavour (``gpt.MoEKFACPreconditioner``): the JAX MoE test
    harness at Switch-Base-8 widths (``d_model`` 768, ``d_ff`` 3072, 8
    experts, capacity factor 1.25, 8 classes; one MoE layer) on seeded
    features ``[4, 2048, 768]``, f32, factor 1, inv 3, 6 steps on one
    card (a finite falling loss, every fused call on the expert stacks
    ``[8, 3072, 769]`` and ``[8, 768, 3073]`` and the dense layers
    against its plain version, 30 launches, the eigen gate on every
    stack at the refresh step 3), then 3 steps over four gloo ranks of
    one expert group (2 experts a rank, in phase 28's spawn): the losses
    and each rank's expert gradients within 1e-5 of the one-card run;
27. the GPipe flavour (``gpt.PipelineKFACPreconditioner``): a 4-stage
    ``PipelineLM`` of 3 GPT blocks a stage at GPT-125M widths, f32,
    batch 4 x 2048, ``M = 4``, factor 1, inv 3, 5 steps in one process
    holding every stage, then over four gloo ranks, one stage each (in
    phase 28's spawn):
    losses within 1e-5, stage factors within 1e-5 and first-step
    gradients within 1e-4 (relative) of the one process, every fused
    call against plain, 12 launches a step in the one process and a
    rank, every hand-off ``mb * T * D * 4`` bytes.  Phases 26 and 27
    print each worst ``pg`` and ``clip`` error beside the largest plain
    ``|pg|`` and ``|clip|``.  Their unaligned stacks (``ap`` 769 and
    3073) reach the kernel zero-padded to multiples of 8
    (``gpt/stacked.py``); each line gives one step's calls' time
    unpadded and as the path makes them (the gradient padded, ``pg``
    sliced), beside the 28.20 and 20.70 ms the unpadded path took before
    the padding (H100 80GB HBM3, 700 W);
28. GPT's sequence- and tensor-parallel paths, on four gloo ranks of
    the shared spawn (the same ranks run phases 26 and 27's four-rank
    work first), at GPT-125M's widths (vocab 50304, 12
    layers, 12 heads, 768/3072), f32, batch 4 x 2048, factor 1, inv 3:
    (a) the ring GPT over a sequence group of 4 (512 tokens a rank)
    under ``KFACPreconditioner`` (MEM-OPT: COMM-OPT's gathered
    decompositions on every rank do not fit four ranks on one card) and
    DDP, 2 steps; (b)
    ``gpt.GPTKFACPreconditioner`` on a ``('data', 'model')`` grid of
    ``2 x 2`` (the dense layers tensor-parallel, DDP over the data
    group, MEM-OPT), 1 step at the default (no ``dgda``: 0 launches)
    and 1 with ``compute_eigenvalue_outer_product=True``.  Each is held
    against one process of the port on the same batch and weights (run
    here while the ranks do phases 26 and 27's work): the losses and the
    step-0 factors within 1e-4, the first step's preconditioned
    gradients within the card's eigen gate ``max(1e-4, 4 n eps)`` of
    each layer's widest factor (two runs' f32 ``eigh`` of a factor that
    wide agree only that far), all relative Frobenius; every rank's
    factors and gradients bitwise its peers'; every fused call against
    its plain version; one layer's ring attention output within 1e-5 of
    the single-block path; the rotation and gather bytes and times,
    step times and launches.  (c) Phase 30b in the same spawn: the
    tensor-parallel ``BertForQA`` at BERT-large's widths (vocab 30522,
    16 heads, 1024/4096; depth cut to 4 blocks for the run's time), f32,
    on the same ``2 x 2`` grid under ``GPTKFACPreconditioner`` with
    prediv, 2 steps on 4 real-text QA examples of 384 positions, held to
    one process of the same depth and seed by (b)'s gates (the bias of
    the last LayerNorm, zero in exact arithmetic, against its scale's
    gradient); launches = steps x buckets a rank; the gathered bytes.
29. the port's ``tiny_gpt_lm`` example (``run()``, SGD then K-FAC with
    the curvature monitor) at GPT-125M's widths (12 layers, 768, ``d_ff``
    1536, vocab 256, 1024 positions), batch 32, full coverage, lr 0.01,
    factor 1, inv 10, 12 steps on ``examples/data/real_text.npz``: finite falling
    losses, launches = steps x buckets, every fused call against plain;
30. the port's ``squad_bert`` example (``train()``) at BERT-large's
    widths and depth on the real-text QA task, batch 4 x 384, in one
    process under ``GPTKFACPreconditioner``, factor 1, inv 3: 2 steps at
    the default (no ``dgda``: 0 launches, as in JAX), 3 with prediv
    (launches = steps x buckets, every fused call against plain), the
    checkpoints written; the step and refresh times.
31. the host C++ (``kfac_pytorch_tpu_torch/_native``, built with ``g++``
    after the kernels, its build times printed; a failed build fails the
    script): (a) the native KAISA greedy (both factor placements) and
    bucket column packer against their Python twins on the registered
    layers of ResNet-50, GPT-125M and BERT-large at worlds 4 and 64 under
    COMM-OPT, HYBRID-OPT and MEM-OPT, and ``gather_crop_flip`` of a
    32 x 224 x 224 x 3 f32 batch bit for bit against the numpy twin, with
    both host times; (b) ``grad_worker_fraction='auto'`` on
    ``PodTopology(ici_size=2, n_groups=2)``: four ranks train ResNet-50 at
    phase 17's batch (factor 1, inv 1, the cadence at which the plan
    leaves HYBRID-OPT) for 3 steps; the plan's payload is the same on
    every rank (a digest all-gathered), equal to the host re-solve from
    ``problem_for`` and valid; ``verify_assignment`` passes; the native
    planner ran during the solve; the sharded kernel launched steps x
    buckets on every rank, rank 0's shard shapes held against the plain
    version; losses and parameters bitwise those of the run at the fixed
    fraction the plan chose; the ledger's rows tagged ``'ici'``/``'dcn'``
    by the topology, and at every step the bytes the ranks' collectives
    moved by link class and by phase equal to the ledger's rows that
    fired.  The placement report is printed.
32. the port's scripts: (a) ``profile_step``'s variant mode on ResNet-50
    at full width (batch 32, 224x224, factor 10, inv 100; 5 timed calls
    a window, CUDA events): the ``sgd``, ``plain``, ``factor`` and
    ``inv`` times, the amortized time and its ratio to SGD; every time
    finite, 21 fused-kernel launches each K-FAC call, one kernel call at
    ResNet-50's ``a2176g1024`` slot against its plain version (``rtol
    1e-5, atol 1e-4``); then ``profile_step``'s iterative smoke, whose
    validator's speed pin (warm Newton-Schulz strictly faster than
    ``eigh`` on every shape) is a claim about the card; (b)
    ``fault_drill --elastic`` at worlds 8 -> 4
    -> 2 (gloo ranks on the card; the mid-save kill, the bitwise
    same-world resume, two resizes, the layers-only recompute; every leg
    started at once, each waiting for the leg it restores from), its
    artifact passed by the port's validator; a process of its own that
    runs beside phase 33.
33. the retrace guard, the compiled tail and the sync guard, right
    after phase 4: ResNet-50 b32 at 224x224, factor 2, inv 4, damping
    swept over 1e-3, 3e-3, 1e-2 and the lr decayed by step, 9 steps
    unguarded and with ``compile_budget=3`` (3 programs, 0 retraces,
    bitwise), then ``plain`` steps under
    ``torch.cuda.set_sync_debug_mode('error')`` and the other variants'
    syncs counted by call site; the precondition tail under
    ``torch.compile(fullgraph=True)`` (the eager backend on ResNet-50,
    Inductor on ResNet-32: no graph break, one Dynamo graph, a kernel
    launch a bucket, within the kernel gate of eager); then the eager
    op's host cost against the direct launch.

The rank work of phases 5, 17, 18, 21, 22 (the resize), 23 (its two
ranks), 31 (b) and 28 (with 26-27 at world 4 and 30b) runs in one spawn
of four processes started after phase 33 (``SharedSpawn``: each phase
with its own process groups and reports; a failure names its phase;
phase 28's one-process references run here as the ranks start).  While
the ranks run, this process runs phases 30, 11, 8, 29, 10, 12-15, 19,
20, 6, 7 and the single-card parts of 22 and 23 beside them: their gates
are bitwise, counts and cadences, so their step times are taken on a
shared card and host.  Each phase's gates then read its ranks' reports
where the phase stands.
Phases 26 and 27 end with an adaptive
pass: ``AdaptiveDamping`` through ``make_train_step`` (an adaptation
every step, the ``rho`` band cut to 0.5 so each moves the damping), 2
steps in one process and at world 4 (in phase 28's ranks): finite
losses, the damping moved, bitwise the same on every rank, launches =
steps x layers, every fused call against plain on the padded stacks,
the loss-only forward's time beside the step's.

Phase 8 ends with a remat pass: GPT-125M with ``remat=True`` against
``remat=False`` (3 steps, SDPA held to its math backend, whose backward
is deterministic where the memory-efficient kernel's is not): losses,
factor EMAs and final gradients bitwise, the launches equal, the peak
memory of both.  The kernel is then held against its plain version at
the (padded) shapes of phases 26 and 27 and at phase 28's, their
kernels-line entries.

Then the bench's ``micro_mlp``, ``inverse_root`` and
``secondary_rn50_inverse`` stages run once (the K-FAC ones at inv 20,
one cycle), each K-FAC step through ``train_loop``.

Phase 5 also trains ResNet-32 at world 4 under each strategy with
``factor_comm='bf16_triu'`` (a timing pass of the factor all-reduce,
then a checked pass: the first factor step's EMAs against the dense
run's within ``rtol 0.02, atol 0.02 max|F|``; the wire bytes of the
packed factors against the dense ones), under HYBRID-OPT with
``stagger_refresh=2`` at inv 4 (the shard cadence; the sharded kernel;
a shard sweep against a monolithic refresh by their preconditioned
gradients, within the eigen gate) and with the adaptive cadence (every
rank decides the same), and under each strategy with
``pipeline_grads=True`` (every step's pipelined tail bitwise the
synchronous tail on the same state; the asynchronous row gathers, none
under COMM-OPT).  Phase 6 also runs the replicated engine
(``bucketed=False``: eigen, eigen without prediv, inverse; no kernel
launch; the refresh step against the bucketed engine from the same
factors) and ``compute_factor_eig_general`` on a non-symmetric card
tensor against ``numpy.linalg.eig``.

A ``phases:`` line gives each phase's time.

The line before the last is one JSON object ``{"kernels": [...]}`` (with
phases 26-27's adaptive passes, 29, 30, 30b, 31 and 32 among its entries); the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import datetime
import gc
import json
import math
import os
import queue
import shutil
import statistics
import sys
import tempfile
import time
from typing import Any, Callable, NamedTuple

#: H100 SXM figures (NVIDIA data sheet, 700 W): HBM bytes/s, f32
#: CUDA-core FLOP/s, dense TF32 and bf16 tensor-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12

#: ResNet-32's bucket stacks ``(L, gp, ap)`` in plan order.
MAIN_PATH_CASES = [
    (9, 64, 576), (1, 64, 320), (9, 32, 320), (11, 32, 192),
    (1, 32, 128), (1, 32, 32),
]
#: ResNet-50's 21 bucket stacks (54 layers) in plan order: the 3x3 convs
#: of layer4 (a4608g512) first, the fc head (2049 -> 2176, 1000 -> 1024)
#: third, the stem (147 -> 192) second to last.
RN50_CASES = [
    (3, 512, 4608), (6, 256, 2304), (1, 1024, 2176), (1, 2048, 1024),
    (2, 512, 2048), (3, 2048, 512), (4, 128, 1152), (1, 512, 1024),
    (1, 1024, 512), (5, 256, 1024), (6, 1024, 256), (3, 64, 576),
    (1, 256, 512), (1, 512, 256), (3, 128, 512), (4, 512, 128),
    (1, 128, 256), (2, 64, 256), (4, 256, 64), (1, 64, 192), (1, 64, 64),
]
#: GPT-125M's bucket stacks under full coverage, in plan order: fc_out,
#: fc_in, qkv, proj (12 slots each; ``pad_dim`` takes 769 to 896 and 3073
#: to 3200) and the LayerNorms (25 slots).  Every one has ``gp > 64``.
GPT_CASES = [(12, 768, 3200), (12, 3072, 896), (12, 2304, 896),
             (12, 768, 896), (25, 768, 32)]
#: ViT-B/16's bucket stacks under full coverage, in plan order: fc_out
#: (3073 -> 3200), fc_in, qkv, the head (769 -> 896, 1000 -> 1024), the
#: patchify conv with the 12 proj layers (768 + 1 -> 896) and the 25
#: LayerNorms.
VIT_CASES = [(12, 768, 3200), (12, 3072, 896), (12, 2304, 896),
             (1, 1024, 896), (13, 768, 896), (25, 768, 32)]
#: BERT-large's under full coverage: fc_out (4097 -> 4224), fc_in, qkv,
#: proj, qa_head (2 -> 32: the narrow path at ap 1152) and the 49
#: LayerNorms; ``wte`` takes the diagonal side path.
BERT_CASES = [(24, 1024, 4224), (24, 4096, 1152), (24, 3072, 1152),
              (24, 1024, 1152), (1, 32, 1152), (49, 1024, 32)]
TRAIN_STEPS = 20
BATCH = 128
DEVICE = 'cuda'
CHECK_STEP = 10  # an inverse-update step: refresh + precondition
KAISA_WORLD = 4
KAISA_STEPS = 12  # crosses the refresh at step 10
KAISA_STRATEGIES = ('COMM_OPT', 'HYBRID_OPT', 'MEM_OPT')
#: ``(strategy, compute_method)`` runs of the other methods (checked pass).
KAISA_METHOD_RUNS = (('HYBRID_OPT', 'inverse'), ('HYBRID_OPT', 'iterative'))
KAISA_TIMEOUT_S = 600
#: ResNet-32's MEM-OPT segments at world 4 (slots per column, plan order).
MEM_OPT_SEGS = [3, 1, 4, 5, 1, 1]


def fail(msg: str) -> None:
    print(f'FAIL: {msg}', file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line() -> str:
    from kfac_pytorch_tpu_torch.utils.backend import card_power_line

    line = card_power_line()
    if line is None:
        fail('nvidia-smi --query-gpu=name,power.limit failed')
    return line


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
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


def graph_ms(torch, calls, reps: int = 20) -> float:
    """Mean milliseconds per replay of one CUDA graph that holds every
    call in ``calls``: their device time without the host's cost of
    issuing each call."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    return time_ms(torch, graph.replay, reps)


def precond_work(L, gp, ap, itemsize):
    """``(bytes, matmul FLOPs, elementwise FLOPs)`` of one fused call:
    every input read once, ``pg`` and ``clip`` written once; the four
    contractions; the scale and the clip product."""
    nbytes = itemsize * L * (2 * gp * ap + ap * ap + gp * gp)
    nbytes += 4 * L * gp * ap + 4 * L
    mm = 2 * L * (gp * gp * ap * 2 + gp * ap * ap * 2)
    return nbytes, mm, 3 * L * gp * ap


def precond_bound(L, gp, ap, itemsize):
    """``(bound_ms, bytes_ms, ops_ms)`` of one fused call.  The
    operations take the least time of a result as exact as the plain
    version's: for f32 operands the f32 CUDA-core FMA rate or 3xTF32 on
    the tensor cores (three TF32 products per f32 product), whichever is
    less; for bf16 operands the bf16 tensor-core rate."""
    nbytes, mm, ew = precond_work(L, gp, ap, itemsize)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if itemsize == 4:
        t_ops = min((mm + ew) / F32_FLOPS,
                    3 * mm / TF32_FLOPS + ew / F32_FLOPS) * 1e3
    else:
        t_ops = (mm + ew) / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops


def precond_bound_cuda_core(L, gp, ap):
    """The bound of an f32 call with every operation at the f32 CUDA-core
    FMA rate, or the bytes, whichever takes longer (ms)."""
    nbytes, mm, ew = precond_work(L, gp, ap, 4)
    return max(nbytes / HBM_BYTES_PER_S, (mm + ew) / F32_FLOPS) * 1e3


def kernel_device_times(torch, fn, sessions: int = 5, calls: int = 3):
    """``([(kernel, device ms)], sessions used)`` of every CUDA kernel
    one call of ``fn`` issues, from ``torch.profiler`` (CUPTI sees
    kernels launched through ctypes).  A profiler session now and then
    delivers no device activity at all, so up to ``sessions`` are
    opened until one does; the list is empty if none did.  A session
    may also miss a kernel here and there, so each runs ``calls`` calls
    and a kernel seen ``n`` times counts ``ceil(n / calls)`` times per
    call (the kernels of one call have distinct names: their template
    arguments differ), at its median device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for used in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by_name: dict[str, list[float]] = {}
        for evt in sorted(prof.events(), key=lambda e: e.time_range.start):
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(evt, 'device_time', None)
            if us is None:
                us = evt.cuda_time
            name = evt.name.replace('(anonymous namespace)::', '')
            by_name.setdefault(name.split('(')[0], []).append(us / 1e3)
        if by_name:
            return [(name, statistics.median(ms))
                    for name, ms in by_name.items()
                    for _ in range(math.ceil(len(ms) / calls))], used
    return [], sessions


def make_case(torch, L, gp, ap, seed, device=None):
    """Realistic operands: orthonormal eigenbases, Gaussian gradient,
    positive eigenvalue grid (on ``device``, default ``DEVICE``)."""
    device = DEVICE if device is None else device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def orth(n):
        a = torch.randn(L, n, n, generator=gen, device=device)
        return torch.linalg.qr(a)[0].contiguous()

    g = torch.randn(L, gp, ap, generator=gen, device=device)
    dgda = torch.rand(L, gp, ap, generator=gen, device=device) * 0.9 + 0.1
    return [g, orth(ap), orth(gp), dgda]


def library_chain(g, qa, qg, dgda):
    """The cuBLAS ``torch.matmul`` chain of the same function."""
    return qg @ ((qg.mT @ g @ qa) * dgda) @ qa.mT


def time_case(torch, kernel, plain, args):
    """``(ms, plain_ms, library_ms)`` of one call on ``args``."""
    return (time_ms(torch, lambda: kernel(*args)),
            time_ms(torch, lambda: plain(*args)),
            time_ms(torch, lambda: library_chain(*args)))


def step_entry(name, replaces, timed, max_err, kernels_per_call):
    """A kernels-line entry summed over one step's f32 calls; ``timed``
    holds ``((L, gp, ap), ms, plain_ms, library_ms)`` per call and
    ``kernels_per_call`` the CUDA kernels the profiler saw in each."""
    bounds = [precond_bound(L, gp, ap, 4) for (L, gp, ap), *_ in timed]
    t_bytes = sum(b[1] for b in bounds)
    t_ops = sum(b[2] for b in bounds)
    return {
        'name': name,
        'route': 'cuda',
        'source': 'kfac_pytorch_tpu_torch/csrc/fused_eigen_precond.cu',
        'replaces': replaces,
        'launches': None,  # filled from the path's run
        'max_abs_err': max_err,
        'ms': sum(t[1] for t in timed),
        'plain_ms': sum(t[2] for t in timed),
        'bound_ms': sum(b[0] for b in bounds),
        'bound_by': 'operations' if t_ops >= t_bytes else 'bytes',
        'library_ms': sum(t[3] for t in timed),
        'kernels_per_call': kernels_per_call,
    }


def step_bound_cuda_core(timed):
    """:func:`precond_bound_cuda_core` summed over one step's calls."""
    return sum(precond_bound_cuda_core(*shape) for shape, *_ in timed)


#: ``[(process, requests, replies)]``: the fresh process that profiles
#: a call once this one's profiler has stopped delivering (at most one).
PROFILE_WORKER: list = []
PROFILE_WORKER_TIMEOUT_S = 180


def profile_worker(requests, replies):
    """A fresh process's profiler: for each ``(kernel, (L, gp, ap),
    seed)`` request, :func:`kernel_device_times` of one call of the
    named ``kfac_pytorch_tpu_torch.ops`` kernel on :func:`make_case`'s
    operands (the same seed gives the caller's operands), until
    ``None``."""
    import torch

    import kfac_pytorch_tpu_torch as kt

    while (req := requests.get()) is not None:
        name, (L, gp, ap), seed = req
        kernel = getattr(kt.ops, name)
        args = make_case(torch, L, gp, ap, seed=seed)
        replies.put(kernel_device_times(torch, lambda: kernel(*args)))
        del args
        torch.cuda.empty_cache()


def fresh_kernel_device_times(torch, name, shape, seed):
    """:func:`kernel_device_times` in :func:`profile_worker`, started at
    the first call.  After phases 16-17 this process's profiler sessions
    came up empty at every first try of a call, and once at five tries
    in a row (the cause is not known), while a new process's sessions
    never did."""
    import torch.multiprocessing as mp

    if not PROFILE_WORKER:
        ctx = mp.get_context('spawn')
        requests, replies = ctx.Queue(), ctx.Queue()
        proc = ctx.Process(target=profile_worker, args=(requests, replies),
                           daemon=True)
        proc.start()
        PROFILE_WORKER.append((proc, requests, replies))
    proc, requests, replies = PROFILE_WORKER[0]
    requests.put((name, tuple(shape), seed))
    deadline = time.time() + PROFILE_WORKER_TIMEOUT_S
    while proc.is_alive() and time.time() < deadline:
        try:
            return replies.get(timeout=1.0)
        except queue.Empty:
            pass
    fail(f'profile {shape}: the fresh profiling process gave no answer '
         f'(exit code {proc.exitcode}, {PROFILE_WORKER_TIMEOUT_S} s allowed)')


def stop_profile_worker():
    """Stop :func:`profile_worker` if it was started."""
    while PROFILE_WORKER:
        proc, requests, _ = PROFILE_WORKER.pop()
        requests.put(None)
        proc.join(30)
        if proc.is_alive():
            proc.kill()
            proc.join()


def profile_case(torch, kernel, args, shape, seed, at_most=None):
    """One line with the device time of each CUDA kernel one call issued
    (the names carry the tiling: ``Tile<rows, cols, ...>`` for the fused
    pair, ``wide_pass`` for the large-gp chain); returns how many there
    were.  ``args`` are :func:`make_case`'s operands for ``seed``.  When
    no session here sees a kernel, the same call on the same operands is
    profiled in a fresh process.  Fails if neither profiler saw a kernel,
    or if a call issued more than ``at_most``."""
    L, gp, ap = shape
    seen, sessions = kernel_device_times(torch, lambda: kernel(*args))
    where = f'profiler session {sessions}'
    if not seen:
        seen, fresh = fresh_kernel_device_times(torch, kernel.__name__,
                                                shape, seed)
        where = (f'no kernel in {sessions} sessions here; a fresh '
                 f'process\'s session {fresh}')
    if not seen:
        fail(f'profile {shape}: the profiler saw no CUDA kernel in the '
             f'call ({sessions} sessions here, {fresh} in a fresh process)')
    per = ', '.join(f'{name} {ms:.5f} ms' for name, ms in seen)
    print(f'profile L={L} gp={gp} ap={ap}: {len(seen)} kernels per call: '
          f'{per}; sum {sum(ms for _, ms in seen):.5f} ms (torch.profiler, '
          f'medians over three f32 calls, {where})',
          flush=True)
    if at_most is not None and len(seen) > at_most:
        fail(f'profile {shape}: {len(seen)} kernels per call on the path '
             f'(at most {at_most})')
    return len(seen)


def check_case(torch, kernel, plain, shape, seed, at_most):
    """One bucket shape: the kernel against plain in f32 and bf16, two
    runs bitwise equal, times, a ``case`` line and a ``profile`` line
    held to ``at_most`` kernels.  Returns ``(max abs err, (shape, ms,
    plain_ms, library_ms), kernels per call, args)``."""
    L, gp, ap = shape
    args = make_case(torch, L, gp, ap, seed=seed)
    pg, clip = kernel(*args)
    pg2, clip2 = kernel(*args)
    want_pg, want_clip = plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(clip, clip2) and torch.equal(pg, pg2)):
        fail(f'case {shape}: two kernel runs differ bitwise')
    err = float((pg - want_pg).abs().max())
    bad = (pg - want_pg).abs() > 1e-4 + 1e-5 * want_pg.abs()
    if not torch.isfinite(pg).all() or bool(bad.any()):
        fail(f'case {shape} f32: kernel disagrees with plain '
             f'(max abs err {err:.3e}, {int(bad.sum())} elements)')
    clip_err = float(((clip - want_clip).abs()
                      / want_clip.abs().clamp_min(1e-6)).max())
    if clip_err > 1e-3:
        fail(f'case {shape}: clip rel err {clip_err:.3e}')
    bf = [a.to(torch.bfloat16) for a in args]
    pg16, clip16 = kernel(*bf)
    pg16b, clip16b = kernel(*bf)
    want16, _ = plain(*bf)
    torch.cuda.synchronize()
    if not (torch.equal(clip16, clip16b) and torch.equal(pg16, pg16b)):
        fail(f'case {shape} bf16: two runs differ bitwise')
    rel32 = float((pg16 - want_pg).abs().mean() / want_pg.abs().mean())
    rel16 = float((pg16 - want16).abs().mean() / want16.abs().mean())
    if not rel32 < 0.05 or not rel16 < 1e-3:
        fail(f'case {shape} bf16: mean rel err {rel32:.3e} vs f32, '
             f'{rel16:.3e} vs plain bf16')
    del pg, pg2, want_pg, pg16, pg16b, want16
    ms, plain_ms, library_ms = time_case(torch, kernel, plain, args)
    ms16 = time_ms(torch, lambda: kernel(*bf))
    bound = precond_bound(L, gp, ap, 4)[0]
    bound16 = precond_bound(L, gp, ap, 2)[0]
    print(f'case L={L} gp={gp} ap={ap}: f32 max_abs_err={err:.3e} '
          f'clip_rel_err={clip_err:.3e} kernel_ms={ms:.5f} '
          f'plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} '
          f'bound_ms={bound:.6f} share_of_bound={bound / ms:.3f} '
          f'bound_cuda_core_ms='
          f'{precond_bound_cuda_core(L, gp, ap):.6f} | bf16 '
          f'mean_rel_err_vs_f32={rel32:.3e} kernel_ms={ms16:.5f} '
          f'bound_ms={bound16:.6f}', flush=True)
    n = profile_case(torch, kernel, args, shape, seed, at_most=at_most)
    return err, (shape, ms, plain_ms, library_ms), n, args


def phase_kernels(torch, ops):
    """Kernel against plain on the card; returns the kernels-line entries
    of ResNet-32's path (times summed over its six bucket calls of one
    step), then GPT-125M's (its five bucket calls), ResNet-50's (its 21),
    ViT-B/16's (six), BERT-large's (six) and the low-rank ResNet-50's
    (the ten exact buckets of phase 12).  A call with ``gp <= 64``
    may issue two CUDA kernels, a ``gp > 64`` call four."""
    kernel = ops.fused_eigen_precondition
    plain = ops.fused_eigen_precondition_reference
    max_err = 0.0
    step_calls, timed, per_call = [], [], []
    for i, shape in enumerate(MAIN_PATH_CASES):
        err, t, n, args = check_case(torch, kernel, plain, shape, 100 + i, 2)
        step_calls.append(lambda a=args: kernel(*a))
        timed.append(t)
        per_call.append(n)
        max_err = max(max_err, err)
    entry = step_entry('fused_eigen_precondition',
                       'kfac_pytorch_tpu/ops/pallas_precond.py:43', timed,
                       max_err, per_call)
    entry['kernel_ms'] = entry['ms']
    entry['graph_ms'] = graph_ms(torch, step_calls)
    print(f'kernel: one step\'s {len(step_calls)} calls: {entry["ms"]:.5f} '
          f'ms issued one by one, {entry["graph_ms"]:.5f} ms replayed as '
          'one CUDA graph (device time); cuBLAS chain '
          f'{entry["library_ms"]:.5f} ms issued one by one; bound '
          f'{entry["bound_ms"]:.6f} ms ({entry["bound_by"]}), CUDA-core '
          f'bound {step_bound_cuda_core(timed):.6f} ms', flush=True)
    del step_calls
    paths = [bucket_entry(torch, kernel, plain, label, cases, seed)
             for label, cases, seed in (
                 ('GPT-125M', GPT_CASES, 400),
                 ('ResNet-50', RN50_CASES, 500),
                 ('ViT-B/16', VIT_CASES, 600),
                 ('BERT-large', BERT_CASES, 700),
                 ('ResNet-50 low-rank exact', RN50_LOWRANK_CASES, 800))]
    return [entry] + paths


#: ``(L, gp, ap) -> (max abs err, (shape, ms, plain_ms, library_ms),
#: kernels per call)`` of every :func:`check_case` of :func:`bucket_entry`.
CASES_SEEN: dict = {}


def bucket_entry(torch, kernel, plain, label, cases, seed, counts=None,
                 what='buckets'):
    """The kernels-line entry of one model's path: :func:`check_case` at
    each of its bucket shapes (at most two CUDA kernels per call for
    ``gp <= 64``, four above; a shape an earlier entry checked keeps
    that check and its times), times summed over one step's calls (a
    shape's ``counts`` entry calls, default one each), and a ``kernel
    <label>:`` line that names the buckets where the cuBLAS chain is
    faster."""
    counts = counts or [1] * len(cases)
    cases = [tuple(shape) for shape in cases]
    err, timed, per_call = 0.0, [], []
    for i, (shape, count) in enumerate(zip(cases, counts)):
        if shape in CASES_SEEN:
            e, t, n = CASES_SEEN[shape]
        else:
            e, t, n, _ = check_case(torch, kernel, plain, shape, seed + i,
                                    2 if shape[1] <= 64 else 4)
            CASES_SEEN[shape] = (e, t, n)
        err = max(err, e)
        timed += [t] * count
        per_call += [n] * count
        torch.cuda.empty_cache()
    out = step_entry(f'fused_eigen_precondition, {label} {what}',
                     'kfac_pytorch_tpu/ops/pallas_precond.py:43', timed, err,
                     per_call)
    out['shapes'] = cases
    out['per_bucket'] = [
        dict(shape=shape, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
             bound_ms=precond_bound(*shape, 4)[0])
        for shape, ms, plain_ms, lib_ms in timed
    ]
    print(f'kernel {label}: one step\'s {len(timed)} calls: '
          f'{out["ms"]:.5f} ms issued one by one; plain '
          f'{out["plain_ms"]:.5f} ms; cuBLAS chain {out["library_ms"]:.5f} '
          f'ms; bound {out["bound_ms"]:.6f} ms ({out["bound_by"]}), '
          f'CUDA-core bound {step_bound_cuda_core(timed):.6f} ms; kernels '
          f'per call {per_call}; buckets where cuBLAS is faster: '
          + str([shape for shape, ms, _, lib in timed if lib < ms]),
          flush=True)
    return out


TRAIN_HP = dict(factor_update_steps=1, inv_update_steps=10, damping=0.003,
                kl_clip=0.001, lr=0.1)


def fixed_batch(torch, device=None):
    """The one synthetic CIFAR batch every single-card run trains on."""
    device = DEVICE if device is None else device
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    x = torch.randn(BATCH, 3, 32, 32, generator=gen, device=device)
    y = torch.randint(0, 10, (BATCH,), generator=gen, device=device)
    return x, y


def train_resnet32(torch, kt, **kfac_kw):
    """ResNet-32, batch 128, ``TRAIN_STEPS`` K-FAC steps on one fixed
    batch, with the stages timed by CUDA events and the fused kernel's
    launches counted from 0 over exactly these steps.  At ``CHECK_STEP``
    (a refresh step) it keeps the raw and the preconditioned gradients,
    the factor EMAs and the buckets before and after the refresh."""
    import torch.nn.functional as F

    model = kt.models.resnet32(device=DEVICE, seed=0)
    x, y = fixed_batch(torch)
    precond = kt.KFACPreconditioner(model, **TRAIN_HP, **kfac_kw)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)

    events: dict[str, list] = {
        'capture (fwd+bwd)': [], 'factors (cov+EMA)': [],
        'eigh refresh': [], 'precondition': [],
    }

    def timed(name, fn):
        def run(*a, **k):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **k)
            e.record()
            events[name].append((s, e))
            return out
        return run

    precond._update_factors = timed(
        'factors (cov+EMA)', precond._update_factors,
    )
    precond._refresh = timed('eigh refresh', precond._refresh)
    precond._precondition = timed('precondition', precond._precondition)

    def fwd_bwd():
        opt.zero_grad()
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        return loss

    fwd_bwd_timed = timed('capture (fwd+bwd)', fwd_bwd)
    run = dict(precond=precond, losses=[], step_s=[])
    kernel = kt.ops.fused_eigen_precondition
    torch.cuda.synchronize()
    kernel.launches = 0
    for step in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = fwd_bwd_timed()
        if step == CHECK_STEP:
            run['raw'] = {n: h.get_grad().clone()
                          for n, h in precond.helpers.items()}
            run['prev'] = precond.buckets
        precond.step()
        if step == CHECK_STEP:
            run['got'] = {n: h.get_grad().clone()
                          for n, h in precond.helpers.items()}
            run['factors'] = {n: (st.a_factor.clone(), st.g_factor.clone())
                              for n, st in precond.layers.items()}
            run['buckets'] = precond.buckets
        opt.step()
        torch.cuda.synchronize()
        run['step_s'].append(time.perf_counter() - t0)
        run['losses'].append(float(loss.detach()))
    run['launches'] = kernel.launches
    losses = run['losses']
    if not all(math.isfinite(v) for v in losses):
        fail(f'{kfac_kw or "eigen"}: non-finite loss: {losses}')
    if not losses[-1] < losses[0]:
        fail(f'{kfac_kw or "eigen"}: loss did not fall: first {losses[0]}, '
             f'last {losses[-1]}')
    run['stage_ms'] = {
        name: (statistics.median([s.elapsed_time(e) for s, e in evs]),
               len(evs))
        for name, evs in events.items()
    }
    run['refresh_ms'] = [s.elapsed_time(e) for s, e in events['eigh refresh']]
    return run


def cpu_second_order(kt, precond):
    """A CPU ``BucketedSecondOrder`` of the same plan and method (CPU
    tensors take every plain version)."""
    from kfac_pytorch_tpu_torch.parallel.second_order import (
        BucketedSecondOrder,
    )

    so = precond._second_order
    return BucketedSecondOrder(
        precond.plan, compute_method=so.compute_method,
        prediv_eigenvalues=so.prediv, iterative_config=so.iterative,
        device='cpu',
    )


def to_cpu(buckets):
    from kfac_pytorch_tpu_torch.parallel.second_order import BucketSecond

    return {k: BucketSecond(**{f: t.cpu() for f, t in b.tensors().items()})
            for k, b in buckets.items()}


def rel_frob(got, want) -> float:
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def phase_train(torch, kt):
    """Phase 3: ResNet-32, batch 128, 20 K-FAC steps on one fixed
    batch, the default eigen method through the fused kernel."""
    run = train_resnet32(torch, kt)
    precond, losses, launches = run['precond'], run['losses'], \
        run['launches']
    n_buckets = len(precond.plan.buckets)
    if launches != TRAIN_STEPS * n_buckets:
        fail(f'kernel launched {launches} times in {TRAIN_STEPS} steps, '
             f'expected {TRAIN_STEPS * n_buckets} ({n_buckets} buckets)')

    # Rerun the check step's precondition from the same state through the
    # plain version (CPU tensors take it): same kl-clip, same buckets.
    want, _ = cpu_second_order(kt, precond).precondition(
        to_cpu(run['buckets']), {n: g.cpu() for n, g in run['raw'].items()},
        0.003, 0.001, 0.1,
    )
    worst = max(rel_frob(run['got'][n].cpu(), w) for n, w in want.items())
    # Same eigenbases on both sides; only the f32 summation order of the
    # 576-long contractions differs (relative norm error ~1e-6).
    if not worst < 1e-4:
        fail(f'step {CHECK_STEP}: kernel path vs plain rerun relative '
             f'norm error {worst:.3e}')

    steady = run['step_s'][1:]
    print(f'train: losses first={losses[0]:.6f} last={losses[-1]:.6f} '
          f'all={[round(v, 5) for v in losses]}', flush=True)
    print(f'train: launches={launches} ({n_buckets} buckets x '
          f'{TRAIN_STEPS} steps); check step {CHECK_STEP} rel err vs '
          f'plain rerun {worst:.3e}', flush=True)
    print(f'train: median step {statistics.median(steady) * 1e3:.4f} ms '
          f'(steps 1-{TRAIN_STEPS - 1}, host clock, synchronized); first '
          f'step {run["step_s"][0] * 1e3:.2f} ms', flush=True)
    for name, (ms, n) in run['stage_ms'].items():
        print(f'train: stage {name}: median {ms:.4f} ms over {n} calls '
              '(CUDA events)', flush=True)
    return launches


#: Phase 6's methods: label -> ``KFACPreconditioner`` keywords.
METHODS = {
    'inverse': dict(compute_method='inverse'),
    'iterative': dict(compute_method='iterative'),
    'eigen_noprediv': dict(compute_eigenvalue_outer_product=False),
}


def newton_schulz_spy(kt, calls):
    """Wrap ``kt.ops.batched_newton_schulz_inverse`` to keep, per call,
    the depth, the final residuals and the inputs (no host sync: the
    refresh stays timed as a user runs it); returns the original, to put
    back."""
    orig = kt.ops.batched_newton_schulz_inverse

    def spy(stack, damping, **kw):
        out = orig(stack, damping, **kw)
        calls.append(dict(kw, stack=stack, damping=damping,
                          res=out.residual))
        return out

    kt.ops.batched_newton_schulz_inverse = spy
    return orig


def seed_taken(torch, kt, call) -> list[bool]:
    """Which slots of a recorded call had their warm seed taken by the
    gate, recomputed from the call's own inputs."""
    warm = call.get('warm_start')
    if warm is None:
        return [False] * call['stack'].shape[0]
    s = kt.ops.damped_stack(call['stack'], call['damping'])
    eye = torch.eye(s.shape[-1], device=s.device)
    res0 = torch.linalg.matrix_norm(s @ warm.float() - eye)
    return (res0 < call['warm_restart_gate']).tolist()


def check_refresh(torch, kt, run, label):
    """Phase 6's check of the refresh step against a CPU rerun from the
    same factor EMAs (and, iterative, the same warm seeds) and raw
    gradients: every layer's preconditioned gradient, and every slot of
    the refreshed buckets — inverses directly (``< 1e-4``); for eigen
    the clamped eigenvalues, never the eigenvectors themselves (they
    rotate within near-degenerate eigenspaces).  An f32 eigensolver is
    backward stable to a small multiple of ``n eps``: cuSOLVER's ``eigh``
    on the card reaches it (eigenvalues 8.6e-5 off LAPACK's at n = 576,
    ``|Q^T Q - I|`` 1.1e-4, where LAPACK keeps 2e-6), so eigenvalues are
    held to ``max(1e-4, 4 n eps)`` and the eigenvectors to
    orthonormality within ``1e-3``; how far each side's
    ``q diag(d) q^T`` lies from the factor is printed.
    Returns ``(buckets err, grads err, eigen details or None)``."""
    from kfac_pytorch_tpu_torch.state import LayerKFACState

    precond = run['precond']
    cpu_so = cpu_second_order(kt, precond)
    layers = {n: LayerKFACState(a_factor=a.cpu(), g_factor=g.cpu())
              for n, (a, g) in run['factors'].items()}
    want_b = cpu_so.compute(layers, 0.003, prev=to_cpu(run['prev']))
    got_b = to_cpu(run['buckets'])
    worst_b, over, eig = 0.0, 0.0, None
    for key, w in want_b.items():
        g = got_b[key]
        if w.a_inv is not None:
            pairs = [(g.a_inv, w.a_inv), (g.g_inv, w.g_inv)]
        else:
            pairs = [(g.da, w.da), (g.dg, w.dg)]
            eig = eig or dict(orth=0.0, card=0.0, cpu=0.0)
            for side, (q, d, wq, wd) in enumerate((
                    (g.qa, g.da, w.qa, w.da), (g.qg, g.dg, w.qg, w.dg))):
                n = q.shape[-1]
                orth = float((q.mT @ q - torch.eye(n)).abs().max())
                if not orth < 1e-3:
                    fail(f'{label}: {key} eigenvectors off orthonormal by '
                         f'{orth:.3e} (n = {n})')
                eig['orth'] = max(eig['orth'], orth)
                for i, name in enumerate(precond.plan.buckets[
                        [b.key for b in precond.plan.buckets].index(key)
                ].slots):
                    if name is None:
                        continue
                    f = run['factors'][name][side].cpu()
                    k = f.shape[-1]
                    for which, qq, dd in (('card', q, d), ('cpu', wq, wd)):
                        rebuilt = (qq[i] @ torch.diag(dd[i]) @ qq[i].mT)
                        eig[which] = max(eig[which],
                                         rel_frob(rebuilt[:k, :k], f))
        for got, want in pairs:
            bar = 1e-4 if eig is None else max(
                1e-4, 4 * want.shape[-1] * 1.1920929e-07)
            for i in range(want.shape[0]):
                err = rel_frob(got[i], want[i])
                worst_b = max(worst_b, err)
                over = max(over, err / bar)
    want, _ = cpu_so.precondition(
        want_b, {n: t.cpu() for n, t in run['raw'].items()},
        0.003, 0.001, 0.1,
    )
    worst_g = max(rel_frob(run['got'][n].cpu(), w) for n, w in want.items())
    if not (over < 1 and worst_g < 1e-4):
        fail(f'{label}: step {CHECK_STEP} vs CPU rerun: buckets rel err '
             f'{worst_b:.3e}, preconditioned grads rel err {worst_g:.3e}')
    return worst_b, worst_g, eig


def phase_methods(torch, kt):
    """Phase 6: the inverse, iterative and non-prediv eigen methods on
    ResNet-32 as phase 3 trains it.  None launches the fused kernel."""
    tol = kt.IterativeConfig().tol
    for label, kw in METHODS.items():
        calls = []
        orig = (newton_schulz_spy(kt, calls) if label == 'iterative'
                else None)
        try:
            run = train_resnet32(torch, kt, **kw)
        finally:
            if orig is not None:
                kt.ops.batched_newton_schulz_inverse = orig
        if run['launches'] != 0:
            fail(f'methods {label}: the fused kernel launched '
                 f'{run["launches"]} times (expected 0)')
        worst_b, worst_g, eig = check_refresh(torch, kt, run,
                                              f'methods {label}')
        losses = run['losses']
        what = ('eigenvalues' if eig is not None else 'inverses')
        extra = ('' if eig is None else
                 f'; eigenvectors |Q^T Q - I| max {eig["orth"]:.3e}; '
                 'q diag(d) q^T against the factor: card '
                 f'{eig["card"]:.3e}, CPU {eig["cpu"]:.3e}')
        print(f'methods {label}: losses first={losses[0]:.6f} '
              f'last={losses[-1]:.6f}; fused-kernel launches 0; step '
              f'{CHECK_STEP} vs CPU rerun, worst slot or layer: {what} '
              f'rel err {worst_b:.3e}{extra}, preconditioned grads rel err '
              f'{worst_g:.3e}', flush=True)
        if label == 'iterative':
            report_iterative(torch, kt, calls, tol,
                             len(run['precond'].plan.buckets))
        ms = {k: v[0] for k, v in run['stage_ms'].items()}
        refresh = ', '.join(f'{t:.4f}' for t in run['refresh_ms'])
        print(f'methods {label}: median step '
              f'{statistics.median(run["step_s"][1:]) * 1e3:.4f} ms; stage '
              f'medians (CUDA events): factors {ms["factors (cov+EMA)"]:.4f}'
              f' ms, precondition {ms["precondition"]:.4f} ms; refresh at '
              f'steps 0 and {CHECK_STEP}: {refresh} ms', flush=True)
        del run
    for label, kw in REPLICATED.items():
        run = train_resnet32(torch, kt, bucketed=False, **kw)
        if run['launches'] != 0:
            fail(f'methods replicated {label}: the fused kernel launched '
                 f'{run["launches"]} times (expected 0)')
        worst_d, worst_g = check_replicated(
            torch, kt, run, f'methods replicated {label}')
        losses = run['losses']
        print(f'methods replicated {label} (bucketed=False): losses '
              f'first={losses[0]:.6f} last={losses[-1]:.6f}; fused-kernel '
              f'launches 0; step {CHECK_STEP} vs the bucketed engine from '
              f'the same factors: decompositions {worst_d:.3f} and '
              f'preconditioned grads {worst_g:.3f} of their gates; median '
              f'step {statistics.median(run["step_s"][1:]) * 1e3:.4f} ms; '
              'refresh at steps 0 and 10: '
              + ', '.join(f'{t:.4f}' for t in run['refresh_ms']) + ' ms',
              flush=True)
        del run
    err = check_eig_general(torch, kt)
    print(f'methods: compute_factor_eig_general on a seeded non-symmetric '
          f'96 x 96 card tensor vs numpy.linalg.eig: clamped real spectrum '
          f'rel err {err:.3e}, result on the card', flush=True)


#: Phase 6's replicated engine (``bucketed=False``): label -> keywords.
REPLICATED = {
    'eigen': {}, 'eigen_noprediv': METHODS['eigen_noprediv'],
    'inverse': METHODS['inverse'],
}


def check_replicated(torch, kt, run, label):
    """The replicated run's refresh step against the bucketed engine's
    on the card from the same factor EMAs and raw gradients: every
    preconditioned gradient (the bucketed stage decomposes padded stacks
    in one batched call, the replicated engine each layer alone, so the
    eigenbases differ inside near-degenerate clusters: eigen within
    :func:`eigen_gate` of the bucket's pad, inverse ``< 1e-4``); without
    prediv each layer's eigenvalues, with the identity pad's 1s added,
    against the bucket slot's (eigen gate), and the inverses against the
    slot's top-left blocks (``< 1e-4``); every eigenvector stack
    orthonormal within ``1e-3``.  Returns ``(worst decomposition, worst
    gradient)`` as ratios to their gates (no decomposition compared
    under prediv: ``dgda`` orders the padded spectra)."""
    from kfac_pytorch_tpu_torch.parallel.bucketing import make_bucket_plan
    from kfac_pytorch_tpu_torch.parallel.second_order import (
        BucketedSecondOrder,
    )
    from kfac_pytorch_tpu_torch.state import LayerKFACState

    precond = run['precond']
    plan = make_bucket_plan(precond.helpers)
    bucketed = BucketedSecondOrder(
        plan, compute_method=precond.compute_method,
        prediv_eigenvalues=precond.prediv_eigenvalues, device=DEVICE,
    )
    layers = {n: LayerKFACState(a_factor=a, g_factor=g)
              for n, (a, g) in run['factors'].items()}
    buckets = bucketed.compute(layers, 0.003)
    want, _ = bucketed.precondition(buckets, run['raw'], 0.003, 0.001, 0.1)
    worst_d = worst_g = 0.0
    for name, st in precond.layers.items():
        key, i = plan.slot_of[name]
        b, bs = plan.bucket(key), buckets[key]
        a, g = st.a_factor.shape[-1], st.g_factor.shape[-1]
        if st.a_inv is not None:
            gate = 1e-4
            pairs = [(st.a_inv, bs.a_inv[i, :a, :a]),
                     (st.g_inv, bs.g_inv[i, :g, :g])]
        else:
            gate = eigen_gate(max(b.a_pad, b.g_pad))
            pairs = []
            if st.da is not None:
                for d, ref, pad in ((st.da, bs.da[i], b.a_pad - a),
                                    (st.dg, bs.dg[i], b.g_pad - g)):
                    ones = torch.ones(pad, device=d.device)
                    pairs.append((torch.cat([d, ones]).sort().values, ref))
            for q in (st.qa, st.qg):
                eye = torch.eye(q.shape[-1], device=q.device)
                if not float((q.mT @ q - eye).abs().max()) < 1e-3:
                    fail(f'{label}: {name} eigenvectors off orthonormal')
        for got, ref in pairs:
            worst_d = max(worst_d, rel_frob(got, ref) / gate)
        worst_g = max(worst_g, rel_frob(run['got'][name], want[name]) / gate)
    if not (worst_d <= 1 and worst_g <= 1):
        fail(f'{label}: step {CHECK_STEP} vs the bucketed engine: '
             f'decompositions {worst_d:.3f} and preconditioned grads '
             f'{worst_g:.3f} of their gates')
    return worst_d, worst_g


def check_eig_general(torch, kt):
    """``compute_factor_eig_general`` on a seeded non-symmetric 96 x 96
    card tensor (the host eig, as the JAX package runs it) against
    ``numpy.linalg.eig``: the clamped real spectra, sorted, ``rtol
    1e-5``; the result comes back on the card.  Returns the error."""
    import numpy as np

    rng = np.random.default_rng(7)
    f = rng.standard_normal((96, 96)).astype(np.float32)
    q, d = kt.ops.compute_factor_eig_general(
        torch.from_numpy(f).to(DEVICE))
    want = np.sort(np.clip(np.linalg.eig(f)[0].real.astype(np.float32),
                           0.0, None))
    got = np.sort(d.cpu().numpy())
    err = float(np.abs(got - want).max() / np.abs(want).max())
    if not (q.device.type == d.device.type == torch.device(DEVICE).type
            and err <= 1e-5 and (d >= 0).all()):
        fail(f'compute_factor_eig_general: spectrum rel err {err:.3e}, '
             f'on {q.device}')
    return err


def report_iterative(torch, kt, calls, tol, n_buckets):
    """The iterative run's two refreshes: depths 30 then 3; after the
    bootstrap every slot within ``tol``, after the warm refresh every
    slot whose warm seed the gate took.  A slot the gate sent back to a
    cold seed gets only the warm depth, as in the JAX package, and is
    reported."""
    per = 2 * n_buckets
    if len(calls) != 2 * per:
        fail(f'iterative: {len(calls)} Newton-Schulz calls, expected '
             f'{2 * per}')
    depths = sorted({c['iters'] for c in calls[:per]}), \
        sorted({c['iters'] for c in calls[per:]})
    if depths != ([30], [3]):
        fail(f'iterative: depths {depths}, expected [30] then [3]')
    boot = max(float(c['res'].max()) for c in calls[:per])
    warm = [(r, t, c['stack'].shape[-1]) for c in calls[per:]
            for r, t in zip(c['res'].tolist(), seed_taken(torch, kt, c))]
    taken = [r for r, t, _ in warm if t]
    cold = [r for r, t, _ in warm if not t]
    above = [(round(r, 4), n) for r, t, n in warm if not t and r > tol]
    if not boot <= tol or (taken and not max(taken) <= tol):
        fail(f'iterative: residual above tol {tol}: bootstrap max {boot}, '
             f'warm max {max(taken) if taken else None}')
    print(f'iterative: depths run {depths[0][0]} (bootstrap, step 0) and '
          f'{depths[1][0]} (warm, step {CHECK_STEP}); bootstrap: all {per} '
          f'calls\' slots within tol {tol}, largest residual {boot:.3e}; '
          f'warm refresh: {len(taken)} slot side(s) warm-seeded (largest '
          f'residual {max(taken, default=float("nan")):.3e}), {len(cold)} '
          'restarted cold because the gate rejected the seed (largest '
          f'residual within tol '
          f'{max((r for r in cold if r <= tol), default=float("nan")):.3e}),'
          f' of which {len(above)} above tol at the warm depth: '
          f'(residual, n) {above}', flush=True)


def resume_run(torch, kt, method_kw, start=0, stop=TRAIN_STEPS,
               ckpt=None, save_at=None):
    """ResNet-32 steps ``[start, stop)`` on the fixed batch from fresh
    objects, or from ``ckpt``; with ``save_at``, checkpoints (the model,
    SGD and the preconditioner, dense and packed as upper triangles, with
    the EKFAC scales under ``ekfac``, through ``torch.save``/
    ``torch.load``) taken after that step.  Returns ``(parameters,
    losses, checkpoints, launches, buckets that launch the kernel)``."""
    import io

    import torch.nn.functional as F

    model = kt.models.resnet32(device=DEVICE, seed=0)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    precond = kt.KFACPreconditioner(model, **TRAIN_HP, **method_kw)
    x, y = fixed_batch(torch)
    kernel = kt.ops.fused_eigen_precondition
    torch.cuda.synchronize()
    kernel.launches = 0
    if ckpt is not None:
        model.load_state_dict(ckpt['model'])
        opt.load_state_dict(ckpt['opt'])
        precond.load_state_dict(ckpt['kfac'])
        start = precond.steps
    losses, saved = [], {}
    for step in range(start, stop):
        opt.zero_grad()
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        precond.step()
        opt.step()
        losses.append(float(loss.detach()))
        if step == save_at:
            for triu in (False, True):
                buf = io.BytesIO()
                torch.save({
                    'model': model.state_dict(), 'opt': opt.state_dict(),
                    'kfac': precond.state_dict(
                        compress_symmetric=triu,
                        include_ekfac_scales=bool(method_kw.get('ekfac')),
                    ),
                }, buf)
                buf.seek(0)
                saved['triu' if triu else 'dense'] = torch.load(
                    buf, map_location=DEVICE,
                )
    torch.cuda.synchronize()
    params = [p.detach().clone() for p in model.parameters()]
    return params, losses, saved, kernel.launches, kernel_buckets(precond)


#: Phase 7's bitwise resumes: label -> ``KFACPreconditioner`` keywords.
RESUME_RUNS = {
    'eigen': {}, 'inverse': METHODS['inverse'],
    'lowrank64': dict(lowrank_rank=64), 'ekfac': dict(ekfac=True),
}


def phase_resume(torch, kt):
    """Phase 7: checkpoint after step 10 (a refresh step, so the saved
    factor EMAs are the ones that refresh decomposed) and resume steps
    11-19 from it.  Eigen and inverse must end bitwise equal to the
    uninterrupted 20 steps (cuDNN held to its deterministic algorithms
    for the phase), and so must low-rank eigen at ``lowrank_rank=64``
    (five of the six buckets truncate their A side; the restore draws
    the saved refresh step's sketches again) and EKFAC with its scales
    in the checkpoint; the iterative restore must refresh at bootstrap
    depth and train on with a finite, falling loss."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for label, kw in RESUME_RUNS.items():
            full, _, saved, launches, n_buckets = resume_run(
                torch, kt, kw, save_at=CHECK_STEP,
            )
            for form, ckpt in saved.items():
                got, losses, _, resumed_launches, _ = resume_run(
                    torch, kt, kw, ckpt=ckpt,
                )
                diff = max(float((a - b).abs().max())
                           for a, b in zip(full, got))
                equal = all(torch.equal(a, b) for a, b in zip(full, got))
                if not equal:
                    fail(f'resume {label} {form}: parameters after step '
                         f'{TRAIN_STEPS - 1} differ from the uninterrupted '
                         f'run (max abs diff {diff:.3e})')
                want = (TRAIN_STEPS - CHECK_STEP - 1) * n_buckets
                if resumed_launches != want:
                    fail(f'resume {label} {form}: {resumed_launches} kernel '
                         f'launches, expected {want}')
                print(f'resume {label} {form}: steps {CHECK_STEP + 1}-'
                      f'{TRAIN_STEPS - 1} from the step-{CHECK_STEP} '
                      f'checkpoint end bitwise equal to the uninterrupted '
                      f'run; losses {losses[0]:.6f} -> {losses[-1]:.6f}; '
                      f'kernel launches {resumed_launches} (uninterrupted '
                      f'run: {launches})', flush=True)
        calls = []
        _, _, saved, _, _ = resume_run(
            torch, kt, METHODS['iterative'], stop=CHECK_STEP + 1,
            save_at=CHECK_STEP,
        )
        orig = newton_schulz_spy(kt, calls)
        try:
            _, losses, _, _, _ = resume_run(
                torch, kt, METHODS['iterative'], ckpt=saved['dense'],
            )
        finally:
            kt.ops.batched_newton_schulz_inverse = orig
        depths = sorted({c['iters'] for c in calls})
        if depths != [30] or len(calls) != 12:
            fail(f'resume iterative: the restore refresh ran {len(calls)} '
                 f'Newton-Schulz calls at depths {depths}, expected 12 at '
                 '[30]')
        if not (all(math.isfinite(v) for v in losses)
                and losses[-1] < losses[0]):
            fail(f'resume iterative: losses {losses}')
        print(f'resume iterative: the restore refresh ran at depth '
              f'{depths[0]} ({len(calls)} calls; largest residual '
              f'{max(float(c["res"].max()) for c in calls):.3e}); steps '
              f'{CHECK_STEP + 1}-{TRAIN_STEPS - 1} losses {losses[0]:.6f} '
              f'-> {losses[-1]:.6f}', flush=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic


#: Phase 8: ``examples/tiny_gpt_lm.py``'s defaults (lr 0.3, damping
#: 0.003, plain SGD; kl-clip the preconditioner's default 0.001) with a
#: factor update every step and a refresh every 10.  The rehearsal on the
#: CPU sets ``GPT_MODEL = 'gpt_tiny'`` and a small ``GPT_BATCH``.
GPT_HP = dict(factor_update_steps=1, inv_update_steps=10, damping=0.003,
              kl_clip=0.001, lr=0.3)
GPT_MODEL = 'gpt_125m'
GPT_BATCH = (4, 2048)  # sequences x tokens: the 125M config's max_seq_len
GPT_STEPS = 12
GPT_DEFAULT_STEPS = 3
GPT_FULL = dict(layer_types=('linear', 'conv2d', 'embedding', 'layernorm'),
                tied_weights=('wte',))


def gpt_tokens(torch, vocab):
    """The one synthetic token batch phase 8 trains on."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2)
    return torch.randint(0, vocab, GPT_BATCH, generator=gen, device=DEVICE)


def train_path(torch, kt, label, model, fwd_bwd, hp, steps, check_step=None,
               momentum=0.0, on_precond=None, keep_check=False, **kfac_kw):
    """``steps`` K-FAC steps of ``model`` on a fixed batch, as a user runs
    them: ``fwd_bwd()`` (the forward and backward passes, returning the
    detached loss), ``precond.step()``, ``opt.step()`` (SGD at
    ``hp['lr']``).  Stages are timed by CUDA events, the fused kernel's
    launches counted from 0 over exactly these steps and its calls timed
    by events around each.  Fails on a non-finite or unfallen loss, or
    launches other than steps x the buckets that keep ``dgda`` (every
    bucket on the default path; the exact ones under ``lowrank_rank``;
    none under EKFAC).  At ``check_step`` (a refresh
    step) every layer's preconditioned gradient and the kl-clip scale are
    held against a rerun on the card from the same decompositions and raw
    gradients through the plain version (relative Frobenius error
    ``< 1e-4``; ``run['check']``; ``keep_check`` keeps the raw gradients
    as ``run['raw']``).  ``on_precond(precond)`` runs before the stages
    are wrapped."""
    precond = kt.KFACPreconditioner(model, **hp, **kfac_kw)
    if on_precond is not None:
        on_precond(precond)
    opt = torch.optim.SGD(model.parameters(), lr=hp['lr'], momentum=momentum)
    events: dict[str, list] = {
        'capture (fwd+bwd)': [], 'factors (cov+EMA)': [],
        'refresh': [], 'precondition': [], 'kernel': [],
    }

    def timed(name, fn):
        def run(*a, **k):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **k)
            e.record()
            events[name].append((s, e))
            return out
        return run

    precond._update_factors = timed('factors (cov+EMA)',
                                    precond._update_factors)
    precond._refresh = timed('refresh', precond._refresh)
    precond._precondition = timed('precondition', precond._precondition)

    def step_fwd_bwd():
        opt.zero_grad()
        return fwd_bwd()

    fwd_bwd_timed = timed('capture (fwd+bwd)', step_fwd_bwd)
    sharded = kt.ops.fused_eigen_precondition_sharded
    kt.ops.fused_eigen_precondition_sharded = timed('kernel', sharded)
    run = dict(precond=precond, losses=[], step_s=[])
    try:
        # An earlier run's preconditioner sits in a reference cycle (its
        # timed stage wrappers hold its bound methods): collect it so
        # the peak is this run's alone.
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kt.ops.fused_eigen_precondition.launches = 0
        for step in range(steps):
            t0 = time.perf_counter()
            loss = fwd_bwd_timed()
            if step == check_step:
                run['raw'] = {n: h.get_grad().clone()
                              for n, h in precond.helpers.items()}
            precond.step()
            if step == check_step:
                run['got'] = {n: h.get_grad().clone()
                              for n, h in precond.helpers.items()}
                run['scale'] = precond.last_kl_scale
            opt.step()
            torch.cuda.synchronize()
            run['step_s'].append(time.perf_counter() - t0)
            run['losses'].append(float(loss))
        run['launches'] = kt.ops.fused_eigen_precondition.launches
        run['peak_bytes'] = torch.cuda.max_memory_allocated()
    finally:
        kt.ops.fused_eigen_precondition_sharded = sharded
    losses = run['losses']
    if not all(math.isfinite(v) for v in losses):
        fail(f'{label}: non-finite loss: {losses}')
    if not losses[-1] < losses[0]:
        fail(f'{label}: loss did not fall: first {losses[0]}, last '
             f'{losses[-1]}')
    n_buckets = kernel_buckets(precond)
    if run['launches'] != steps * n_buckets:
        fail(f'{label}: kernel launched {run["launches"]} times in {steps} '
             f'steps, expected {steps * n_buckets} ({n_buckets} buckets '
             'that keep dgda)')
    per_step = len(events['kernel']) // steps
    run['kernel_step_ms'] = [
        sum(s.elapsed_time(e) for s, e in events['kernel'][i:i + per_step])
        for i in range(0, len(events['kernel']), per_step)
    ] if per_step else [0.0]
    run['stage_ms'] = {
        name: (statistics.median([s.elapsed_time(e) for s, e in evs]),
               len(evs))
        for name, evs in events.items() if name != 'kernel'
    }
    run['refresh_ms'] = [s.elapsed_time(e) for s, e in events['refresh']]
    if check_step is None:
        return run

    # The check step rerun on the card from the same decompositions and
    # raw gradients, the plain version in place of the kernel.
    kt.ops.fused_eigen_precondition_sharded = (
        kt.ops.fused_eigen_precondition_sharded_reference)
    launches = kt.ops.fused_eigen_precondition.launches
    try:
        want, scale = precond.precondition_combined(
            run['raw'], hp['damping'], hp['kl_clip'], hp['lr'],
        )
    finally:
        kt.ops.fused_eigen_precondition_sharded = sharded
    if kt.ops.fused_eigen_precondition.launches != launches:
        fail(f'{label}: the plain rerun launched the kernel')
    errs = {n: rel_frob(run['got'][n], w) for n, w in want.items()}
    worst = max(errs, key=errs.get)
    scale_err = abs(float(scale) - float(run['scale'])) / float(scale)
    if not (set(errs) == set(precond.helpers) and errs[worst] < 1e-4
            and scale_err < 1e-4):
        fail(f'{label}: step {check_step} kernel path vs plain rerun: worst '
             f'layer {worst} rel err {errs[worst]:.3e}, kl-clip scale rel '
             f'err {scale_err:.3e}')
    by_kind = {}
    for n, e in errs.items():
        kind = type(precond.helpers[n]).__name__
        by_kind[kind] = max(by_kind.get(kind, 0.0), e)
    run['check'] = dict(step=check_step, worst=worst, err=errs[worst],
                        scale=float(scale), scale_err=scale_err,
                        by_kind=by_kind)
    del run['got'], want
    if not keep_check:
        del run['raw']
    return run


def kernel_buckets(precond) -> int:
    """The buckets whose every step launches the fused kernel: those that
    keep ``dgda``."""
    so = precond._second_order
    return sum(so.bucket_prediv(b.key) for b in precond.plan.buckets)


def report_path(label, run, steps, note=''):
    """The lines every training phase prints: losses; launches and the
    check step; step and stage medians with the kernel's share; peak
    memory and ``memory_usage()``."""
    precond, losses = run['precond'], run['losses']
    keys = [f'{b.key}:{b.n_slots}' for b in precond.plan.buckets]
    print(f'{label}: losses first={losses[0]:.6f} last={losses[-1]:.6f} '
          f'all={[round(v, 5) for v in losses]}', flush=True)
    line = (f'{label}: launches={run["launches"]} '
            f'({kernel_buckets(precond)} of {len(keys)} buckets x {steps} '
            'steps)')
    chk = run.get('check')
    if chk is not None:
        line += (f'; step {chk["step"]} vs plain rerun on the card, worst '
                 f'layer {chk["worst"]} {chk["err"]:.3e}, worst by kind '
                 + ', '.join(f'{k} {v:.3e}'
                             for k, v in sorted(chk['by_kind'].items()))
                 + f'; kl-clip scale {chk["scale"]:.6e} (rel err '
                 f'{chk["scale_err"]:.3e})')
    print(line, flush=True)
    ms = {k: v[0] for k, v in run['stage_ms'].items()}
    kernel_ms = statistics.median(run['kernel_step_ms'])
    print(f'{label}: median step '
          f'{statistics.median(run["step_s"][1:]) * 1e3:.4f} ms (steps '
          f'1-{steps - 1}, host clock, synchronized{note}); first step '
          f'{run["step_s"][0] * 1e3:.2f} ms; stage medians (CUDA events): '
          f'capture (fwd+bwd) {ms["capture (fwd+bwd)"]:.4f} ms, factors '
          f'{ms["factors (cov+EMA)"]:.4f} ms over '
          f'{run["stage_ms"]["factors (cov+EMA)"][1]} factor steps, '
          f'precondition {ms["precondition"]:.4f} ms of which the kernel\'s '
          f'{kernel_buckets(precond)} calls {kernel_ms:.4f} ms '
          f'({kernel_ms / ms["precondition"]:.3f}); refresh: '
          + ', '.join(f'{t:.2f}' for t in run['refresh_ms']) + ' ms',
          flush=True)
    print(f'{label}: torch.cuda.max_memory_allocated {run["peak_bytes"]} '
          f'bytes ({run["peak_bytes"] / 2**30:.3f} GiB); memory_usage '
          f'{precond.memory_usage()}', flush=True)


def train_gpt(torch, kt, steps, check_step=None, **kfac_kw):
    """``steps`` K-FAC steps of the GPT on the fixed batch (next-token
    cross entropy) through :func:`train_path`."""
    import torch.nn.functional as F

    model = getattr(kt.models, GPT_MODEL)(device=DEVICE, seed=0)
    tokens = gpt_tokens(torch, model.config.vocab_size)

    def fwd_bwd():
        logits = model(tokens)
        loss = F.cross_entropy(
            logits[:, :-1].reshape(-1, logits.shape[-1]),
            tokens[:, 1:].reshape(-1),
        )
        loss.backward()
        return loss.detach()

    return train_path(torch, kt, 'gpt', model, fwd_bwd, GPT_HP, steps,
                      check_step, **kfac_kw)


def phase_gpt(torch, kt):
    """Phase 8: GPT-125M at its published widths, full coverage (48
    Dense layers and 25 LayerNorms in five buckets, the tied embedding
    on the diagonal side path), ``GPT_STEPS`` steps with refreshes at 0
    and ``CHECK_STEP``; then the default coverage (48 Dense layers, four
    buckets) for ``GPT_DEFAULT_STEPS`` steps.  Returns the full-coverage
    run's kernel launches."""
    run = train_gpt(torch, kt, GPT_STEPS, check_step=CHECK_STEP, **GPT_FULL)
    precond = run['precond']
    cfg = precond._capture.model.config
    n_blocks = cfg.n_layers
    keys = [f'{b.key}:{b.n_slots}' for b in precond.plan.buckets]
    # The tied group holds one factor set: one 'wte' layer whose A is the
    # [V] diagonal, no layer for the head, and the head's call captured.
    wte = precond.layers.get('wte')
    if (wte is None or tuple(wte.a_factor.shape) != (cfg.vocab_size,)
            or len(precond.layers) != 4 * n_blocks + 2 * n_blocks + 2
            or 'head' in precond.layers
            or list(precond._capture.attend) != ['wte']
            or precond.diag_layers != ('wte',)):
        fail(f'gpt: the tied group is not one factor set: layers '
             f'{len(precond.layers)}, diagonal {precond.diag_layers}, '
             f'attend {list(precond._capture.attend)}')
    print(f'gpt: {GPT_MODEL} (vocab {cfg.vocab_size}, {n_blocks} layers, '
          f'{cfg.n_heads} heads, d_model {cfg.d_model}, d_ff {cfg.d_ff}, '
          f'{cfg.dtype} compute), batch {GPT_BATCH[0]} x {GPT_BATCH[1]} '
          f'tokens, full coverage: {len(precond.layers)} layers, buckets '
          f'{keys}, diagonal side path {list(precond.diag_layers)}',
          flush=True)
    report_path('gpt', run, GPT_STEPS,
                f'; the refresh step {CHECK_STEP} included')
    launches = run['launches']
    del run, precond
    torch.cuda.empty_cache()

    run = train_gpt(torch, kt, GPT_DEFAULT_STEPS)
    precond = run['precond']
    keys = [f'{b.key}:{b.n_slots}' for b in precond.plan.buckets]
    if len(precond.layers) != 4 * n_blocks or len(keys) != 4:
        fail(f'gpt default coverage: {len(precond.layers)} layers, '
             f'buckets {keys}')
    ms = {k: v[0] for k, v in run['stage_ms'].items()}
    print(f'gpt default coverage: {len(precond.layers)} Dense layers, '
          f'buckets {keys}; losses {[round(v, 5) for v in run["losses"]]}; '
          f'launches {run["launches"]} ({len(keys)} buckets x '
          f'{GPT_DEFAULT_STEPS} steps); median step '
          f'{statistics.median(run["step_s"][1:]) * 1e3:.4f} ms; factors '
          f'{ms["factors (cov+EMA)"]:.4f} ms, precondition '
          f'{ms["precondition"]:.4f} ms (kernel '
          f'{statistics.median(run["kernel_step_ms"]):.4f} ms), refresh '
          f'at step 0 {run["refresh_ms"][0]:.2f} ms', flush=True)
    del run, precond
    torch.cuda.empty_cache()
    return launches


def mem_opt_shards(kt):
    """``(seg, gp, ap)`` of one rank's MEM-OPT shard of each ResNet-32
    bucket at world 4, in plan order."""
    from kfac_pytorch_tpu_torch.capture import ModelCapture
    from kfac_pytorch_tpu_torch.parallel.bucketing import make_bucket_plan

    helpers = ModelCapture(kt.models.resnet32(device=DEVICE)).helpers
    plan = make_bucket_plan(helpers, n_cols=KAISA_WORLD)
    segs = [b.seg for b in plan.buckets]
    if segs != MEM_OPT_SEGS:
        fail(f'MEM-OPT segments {segs}, expected {MEM_OPT_SEGS}')
    return [(b.seg, b.g_pad, b.a_pad) for b in plan.buckets]


def phase_sharded_kernel(torch, kt):
    """The sharded form on one rank's MEM-OPT shards, timed alone on the
    card (no gather: one process holds no row group); returns the
    kernels-line entry, summed over one step's six shard calls."""
    sharded = kt.ops.fused_eigen_precondition_sharded
    plain = kt.ops.fused_eigen_precondition_sharded_reference
    max_err = 0.0
    timed, per_call = [], []
    shards = mem_opt_shards(kt)
    for i, (L, gp, ap) in enumerate(shards):
        args = make_case(torch, L, gp, ap, seed=200 + i)
        pg, clip = sharded(*args)
        want, want_clip = plain(*args)
        torch.cuda.synchronize()
        err = float((pg - want).abs().max())
        bad = (pg - want).abs() > 1e-4 + 1e-5 * want.abs()
        if not torch.isfinite(pg).all() or bool(bad.any()):
            fail(f'sharded shard {(L, gp, ap)}: kernel disagrees with plain '
                 f'(max abs err {err:.3e})')
        max_err = max(max_err, err)
        ms, plain_ms, library_ms = time_case(torch, sharded, plain, args)
        timed.append(((L, gp, ap), ms, plain_ms, library_ms))
        print(f'sharded shard L={L} gp={gp} ap={ap}: max_abs_err={err:.3e} '
              f'kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} '
              f'library_ms={library_ms:.5f} '
              f'bound_ms={precond_bound(L, gp, ap, 4)[0]:.6f} '
              f'bound_cuda_core_ms={precond_bound_cuda_core(L, gp, ap):.6f}',
              flush=True)
        # Without a row group the sharded form is the local kernel call.
        per_call.append(profile_case(torch, sharded, args, (L, gp, ap),
                                     200 + i, at_most=2))
    entry = step_entry('fused_eigen_precondition_sharded',
                       'kfac_pytorch_tpu/ops/pallas_precond.py:151', timed,
                       max_err, per_call)
    entry['shard_shapes'] = shards
    print(f'sharded: one step\'s {len(shards)} shard calls: '
          f'{entry["ms"]:.5f} ms issued one by one; cuBLAS chain '
          f'{entry["library_ms"]:.5f} ms; bound {entry["bound_ms"]:.6f} ms, '
          f'CUDA-core bound {step_bound_cuda_core(timed):.6f} ms',
          flush=True)
    return entry


def kaisa_rank(rank, world, backend, device_type, workdir):
    """One rank of the KAISA phase; writes ``rank{rank}.pt`` to
    ``workdir`` and raises on a failed check.  ``device_type`` is
    ``'cuda'`` on the card (``'cpu'`` rehearses the phase)."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    import kfac_pytorch_tpu_torch as kt
    from kfac_pytorch_tpu_torch.parallel import collectives
    from kfac_pytorch_tpu_torch.parallel.bucketing import make_bucket_plan
    from kfac_pytorch_tpu_torch.parallel.second_order import (
        BucketedSecondOrder,
    )
    from kfac_pytorch_tpu_torch.state import LayerKFACState

    if device_type == 'cuda':
        dev = torch.device(
            'cuda',
            rank % torch.cuda.device_count() if backend == 'nccl' else 0,
        )
        torch.cuda.set_device(dev)
        sync = torch.cuda.synchronize
    else:
        dev = torch.device('cpu')

        def sync(device=None):
            pass
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        backend, init_method=f'file://{workdir}/pg_init', rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=300),
    )
    ops = kt.ops
    # Host-clock timers around the three KAISA collectives, with the
    # card synchronized on both sides of each call; on only in the timing
    # pass, so the checked pass runs the path without those syncs.
    timings = {'factor all-reduce': [], 'decomposition gather': [],
               'gradient gather': []}
    timing = {'on': False}

    def timed(name, fn):
        def run(*a, **k):
            if not timing['on']:
                return fn(*a, **k)
            sync(dev)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync(dev)
            timings[name].append(time.perf_counter() - t0)
            return out
        return run

    collectives.all_reduce_mean = timed(
        'factor all-reduce', collectives.all_reduce_mean)
    collectives.all_gather_decompositions = timed(
        'decomposition gather', collectives.all_gather_decompositions)
    collectives.all_gather_preconditioned = timed(
        'gradient gather', collectives.all_gather_preconditioned)
    # Under factor_comm the factor all-reduce is two calls a step: the
    # bf16 triangles, then the dense rest (the row counts at least).
    collectives.all_reduce_sum_triu = timed(
        'factor all-reduce', collectives.all_reduce_sum_triu)

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    x = torch.randn(BATCH, 3, 32, 32, generator=gen, device=dev)
    y = torch.randint(0, 10, (BATCH,), generator=gen, device=dev)
    q = BATCH // world
    xl, yl = x[rank * q:(rank + 1) * q], y[rank * q:(rank + 1) * q]

    # The asynchronous gathers the pipelined tail issues (a gather of a
    # group of one or of None issues none).
    async_gathers = [0]
    real_gather_flat = collectives._gather_flat

    def counted_gather_flat(stacks, group, async_op):
        if async_op:
            async_gathers[0] += 1
        return real_gather_flat(stacks, group, async_op)
    collectives._gather_flat = counted_gather_flat

    def tail_check(precond, raw, got):
        """The synchronous tail on the same state and raw gradients as
        the pipelined step just run: bitwise equal, or False.  Its
        launches are not the path's and are taken off the count."""
        so = precond._second_order
        order, so.pipeline_order = so.pipeline_order, None
        launches = ops.fused_eigen_precondition.launches
        try:
            want, _ = precond.precondition_combined(
                raw, *precond._tail_hyperparams())
        finally:
            so.pipeline_order = order
            ops.fused_eigen_precondition.launches = launches
        return all(torch.equal(got[n], w) for n, w in want.items())

    def train(strategy, method='eigen', inv=10, **kfac_kw):
        """``KAISA_STEPS`` steps from the seeded weights; the launches
        are counted from 0 over exactly these steps.  A pipelined run
        holds every step against :func:`tail_check`."""
        model = kt.models.resnet32(device=dev, seed=0)
        ddp = torch.nn.parallel.DistributedDataParallel(
            model, device_ids=None if dev.index is None else [dev.index],
        )
        precond = kt.KFACPreconditioner(
            ddp, factor_update_steps=1, inv_update_steps=inv, damping=0.003,
            kl_clip=0.001, lr=0.1, compute_method=method,
            grad_worker_fraction=kt.DistributedStrategy[strategy],
            **kfac_kw,
        )
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        run = dict(precond=precond, losses=[], step_s=[], equal=[],
                   actions=[], tails_equal=[])
        pipelined = kfac_kw.get('pipeline_grads', False)
        sync(dev)
        ops.fused_eigen_precondition.launches = 0
        async_gathers[0] = 0
        for step in range(KAISA_STEPS):
            t0 = time.perf_counter()
            opt.zero_grad()
            loss = F.cross_entropy(ddp(xl), yl)
            loss.backward()
            if step == CHECK_STEP or pipelined:
                run['raw'] = {n: h.get_grad().clone()
                              for n, h in precond.helpers.items()}
            precond.step()
            if pipelined:
                run['tails_equal'].append(tail_check(precond, run['raw'], {
                    n: h.get_grad() for n, h in precond.helpers.items()}))
            run['actions'].append(precond.last_refresh)
            if step in (0, CHECK_STEP):  # the two refresh steps
                run[f'factors{step}'] = {
                    n: LayerKFACState(a_factor=st.a_factor.clone(),
                                      g_factor=st.g_factor.clone())
                    for n, st in precond.layers.items()
                }
            if step == CHECK_STEP:
                run['got'] = {n: h.get_grad().clone()
                              for n, h in precond.helpers.items()}
            opt.step()
            sync(dev)
            run['step_s'].append(time.perf_counter() - t0)
            run['losses'].append(float(loss.detach()))
            flat = torch.cat([p.detach().reshape(-1)
                              for p in model.parameters()])
            every = [torch.empty_like(flat) for _ in range(world)]
            dist.all_gather(every, flat)
            run['equal'].append(all(torch.equal(flat, o) for o in every))
        run['launches'] = ops.fused_eigen_precondition.launches
        run['async_gathers'] = async_gathers[0]
        return run

    def single_rerun(precond, run, label):
        """The refresh step rerun in this one process: no grid, the whole
        plan, the same averaged factors and raw gradients (the iterative
        method replays both refreshes, so its warm seeds match).  Both
        sides run their own batched decompositions, so the eigenbases
        come from different cuSOLVER calls; the preconditioned action
        is what is compared."""
        so = precond._second_order
        single = BucketedSecondOrder(
            make_bucket_plan(precond.helpers, n_cols=1), device=dev,
            compute_method=so.compute_method, iterative_config=so.iterative,
        )
        buckets = single.compute(run['factors0'], 0.003, bootstrap=True)
        buckets = single.compute(run[f'factors{CHECK_STEP}'], 0.003,
                                 prev=buckets)
        want, _ = single.precondition(buckets, run['raw'], 0.003, 0.001, 0.1)
        worst = max(
            float((run['got'][n] - w).norm() / w.norm().clamp_min(1e-30))
            for n, w in want.items()
        )
        if not worst < 1e-4:
            raise RuntimeError(f'{label}: step {CHECK_STEP} rel err vs '
                               f'single-process rerun {worst:.3e}')
        return worst

    def checked(run, label, launches_per_step):
        """The gates every extra run shares: finite losses, parameters
        bitwise equal across ranks, the kernel's launches."""
        if not all(math.isfinite(v) for v in run['losses']):
            raise RuntimeError(f'{label}: non-finite loss {run["losses"]}')
        if not all(run['equal']):
            raise RuntimeError(
                f'{label}: parameters differ across ranks after steps '
                f'{[i for i, e in enumerate(run["equal"]) if not e]}')
        want_n = (KAISA_STEPS * launches_per_step if dev.type == 'cuda'
                  else 0)
        if run['launches'] != want_n:
            raise RuntimeError(f'{label}: {run["launches"]} kernel '
                               f'launches, expected {want_n}')

    report, dense_f0 = {}, {}
    for strategy in KAISA_STRATEGIES:
        # The timing pass first, so the checked pass that follows is the
        # one whose launches are read.
        for v in timings.values():
            v.clear()
        timing['on'] = True
        train(strategy)
        timing['on'] = False
        times = {k: list(v) for k, v in timings.items()}
        run = train(strategy)
        precond, losses, launches = run['precond'], run['losses'], \
            run['launches']
        n_buckets = len(precond.plan.buckets)
        if not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f'{strategy} rank {rank}: non-finite loss '
                               f'{losses}')
        if not all(run['equal']):
            raise RuntimeError(
                f'{strategy} rank {rank}: parameters differ across ranks '
                f'after steps '
                f'{[i for i, e in enumerate(run["equal"]) if not e]}')
        # CPU tensors run the plain version, which counts nothing.
        want_n = KAISA_STEPS * n_buckets if dev.type == 'cuda' else 0
        if launches != want_n:
            raise RuntimeError(
                f'{strategy} rank {rank}: {launches} kernel launches, '
                f'expected {want_n} ({n_buckets} buckets x {KAISA_STEPS} '
                'steps)')
        worst = single_rerun(precond, run, f'{strategy} rank {rank}')

        # The sharded form against its plain version through this rank's
        # row, at this rank's shard shapes.
        f32_err, bf16_err = 0.0, 0.0
        for i, b in enumerate(precond.plan.buckets):
            args = make_case(torch, b.seg, b.g_pad, b.a_pad,
                             seed=300 + 10 * rank + i, device=dev)
            row = precond.grid.row_group
            pg, clip = ops.fused_eigen_precondition_sharded(*args, group=row)
            ref, ref_clip = ops.fused_eigen_precondition_sharded_reference(
                *args, group=row)
            bad = (pg - ref).abs() > 1e-4 + 1e-5 * ref.abs()
            if bool(bad.any()) or not torch.isfinite(pg).all():
                raise RuntimeError(
                    f'{strategy} rank {rank} bucket {b.key}: sharded kernel '
                    f'disagrees with its plain version '
                    f'({int(bad.sum())} elements)')
            f32_err = max(f32_err, float((pg - ref).abs().max()))
            pg16, _ = ops.fused_eigen_precondition_sharded(
                *[a.to(torch.bfloat16) for a in args], group=row)
            rel = float((pg16 - ref).abs().mean() / ref.abs().mean())
            if not rel < 0.05:
                raise RuntimeError(
                    f'{strategy} rank {rank} bucket {b.key}: bf16 mean rel '
                    f'err {rel:.3e}')
            bf16_err = max(bf16_err, rel)
        report[strategy] = dict(
            grid=(precond.grid.rows, precond.grid.cols, precond.grid.row,
                  precond.grid.col),
            shards=[(b.key, tuple(precond.buckets[b.key].qa.shape[:1])
                     + (b.g_pad, b.a_pad)) for b in precond.plan.buckets],
            losses=losses, step_s=run['step_s'], times=times,
            launches=launches, n_buckets=n_buckets,
            check_rel_err=worst, f32_err=f32_err, bf16_err=bf16_err,
            memory=precond.memory_usage(),
        )
        dense_f0[strategy] = run['factors0']
        del run, precond
        if dev.type == 'cuda':
            torch.cuda.empty_cache()
    for strategy, method in KAISA_METHOD_RUNS:
        label = f'{strategy} {method} rank {rank}'
        run = train(strategy, method)
        if not all(math.isfinite(v) for v in run['losses']):
            raise RuntimeError(f'{label}: non-finite loss {run["losses"]}')
        if not all(run['equal']):
            raise RuntimeError(
                f'{label}: parameters differ across ranks after steps '
                f'{[i for i, e in enumerate(run["equal"]) if not e]}')
        if run['launches'] != 0:
            raise RuntimeError(f'{label}: {run["launches"]} fused-kernel '
                               'launches, expected 0')
        precond = run['precond']
        report[strategy, method] = dict(
            grid=(precond.grid.rows, precond.grid.cols, precond.grid.row,
                  precond.grid.col),
            losses=run['losses'], step_s=run['step_s'],
            check_rel_err=single_rerun(precond, run, label),
            memory=precond.memory_usage(),
        )
        del run, precond
    # factor_comm='bf16_triu': the first factor step's EMAs (the same
    # weights and batch as the dense run's) within the compressed path's
    # bar of the CPU test, rtol 0.02 and atol 0.02 * max|F| (JAX's own
    # bar for its compressed path against the dense one).
    for strategy in KAISA_STRATEGIES:
        label = f'{strategy} bf16_triu rank {rank}'
        for v in timings.values():
            v.clear()
        timing['on'] = True
        train(strategy, factor_comm='bf16_triu')
        timing['on'] = False
        reduce_s = list(timings['factor all-reduce'])
        run = train(strategy, factor_comm='bf16_triu')
        precond = run['precond']
        checked(run, label, len(precond.plan.buckets))
        worst = 0.0
        for n, st in run['factors0'].items():
            d = dense_f0[strategy][n]
            for got, want in ((st.a_factor, d.a_factor),
                              (st.g_factor, d.g_factor)):
                bar = 0.02 * want.abs() + 0.02 * want.abs().max()
                worst = max(worst, float(((got - want).abs() / bar).max()))
        if not worst <= 1:
            raise RuntimeError(f'{label}: step-0 factors off the dense '
                               f'run by {worst:.3f} of the bf16 bar')
        dims = [d for n in precond._compressed
                for d in (precond.layers[n].a_factor.shape[-1],
                          precond.layers[n].g_factor.shape[-1])]
        every = [t.numel() for st in precond.layers.values()
                 for t in (st.a_factor, st.g_factor)]
        report[strategy, 'bf16_triu'] = dict(
            grid=(precond.grid.rows, precond.grid.cols),
            losses=run['losses'], launches=run['launches'], bar=worst,
            wire=(sum(d * (d + 1) // 2 * 2 for d in dims),
                  sum(d * d * 4 for d in dims), sum(every) * 4),
            step_s=run['step_s'], reduce_s=reduce_s,
        )
        del run, precond
    # stagger_refresh=2 at inv 4 under HYBRID-OPT: the shard cadence, the
    # sharded kernel, and on the last factors a sweep of both shards
    # against one monolithic refresh, compared by their action on the
    # check step's raw gradients (eigen gate at the widest pad, 576).
    label = f'HYBRID_OPT stagger rank {rank}'
    run = train('HYBRID_OPT', inv=4, stagger_refresh=2)
    precond = run['precond']
    checked(run, label, len(precond.plan.buckets))
    want_actions = stagger_cadence(KAISA_STEPS, 4, 2)
    if run['actions'] != want_actions:
        raise RuntimeError(f'{label}: refreshes {run["actions"]}, expected '
                           f'{want_actions}')
    so = precond._second_order
    mono = so.compute(precond.layers, 0.003)
    swept = precond.buckets
    for k in range(precond.stagger.n_shards):
        swept = so.compute_shard(precond.layers, 0.003, k, swept)
    want, _ = so.precondition(mono, run['raw'], 0.003, 0.001, 0.1)
    got, _ = so.precondition(swept, run['raw'], 0.003, 0.001, 0.1)
    sweep_err = max(rel_frob(got[n], w) for n, w in want.items())
    if not sweep_err <= eigen_gate(576):
        raise RuntimeError(f'{label}: shard sweep vs monolithic refresh, '
                           f'preconditioned grads rel err {sweep_err:.3e}')
    report['stagger'] = dict(actions=run['actions'], losses=run['losses'],
                             launches=run['launches'], sweep_err=sweep_err,
                             grid=(precond.grid.rows, precond.grid.cols))
    del run, precond, mono, swept, want, got
    # The drift-adaptive cadence on the same grid: the parent checks that
    # every rank decided the same.
    label = f'HYBRID_OPT adaptive rank {rank}'
    run = train('HYBRID_OPT', inv=4, stagger_refresh=2,
                adaptive=kt.AdaptiveRefreshConfig(
                    threshold=0.2, staleness_factor=3, record_events=True))
    precond = run['precond']
    checked(run, label, len(precond.plan.buckets))
    ctl = precond.adaptive_controller
    sketch, digest = precond._adaptive_last_drift
    report['adaptive'] = dict(
        events=list(ctl.events), counters=ctl.counters(),
        syncs=precond.adaptive_host_syncs, losses=run['losses'],
        launches=run['launches'], sketch=sketch.cpu(), digest=digest.cpu(),
    )
    del run, precond, ctl
    # pipeline_grads under every strategy: each step's pipelined tail
    # against the synchronous tail on the same state, bitwise; the
    # asynchronous row gathers, none under COMM-OPT (a grid of one
    # column).
    for strategy in KAISA_STRATEGIES:
        label = f'{strategy} pipelined rank {rank}'
        run = train(strategy, pipeline_grads=True)
        precond = run['precond']
        n_buckets = len(precond.plan.buckets)
        checked(run, label, n_buckets)
        if not all(run['tails_equal']):
            raise RuntimeError(
                f'{label}: the pipelined tail differs from the synchronous '
                'one at steps '
                f'{[i for i, e in enumerate(run["tails_equal"]) if not e]}')
        want_gathers = (KAISA_STEPS * n_buckets if precond.grid.cols > 1
                        else 0)
        if run['async_gathers'] != want_gathers:
            raise RuntimeError(f'{label}: {run["async_gathers"]} async '
                               f'gathers, expected {want_gathers}')
        report[strategy, 'pipelined'] = dict(
            grid=(precond.grid.rows, precond.grid.cols),
            losses=run['losses'], launches=run['launches'],
            gathers=run['async_gathers'], step_s=run['step_s'],
            order=precond._second_order.pipeline_order,
        )
        del run, precond
    torch.save(report, os.path.join(workdir, f'rank{rank}.pt'))
    dist.barrier()
    dist.destroy_process_group()


class RankPhase(NamedTuple):
    """One multi-rank phase of :func:`spawn_shared`: ``target(rank, world,
    backend, device, directory, *args)`` on ``world`` ranks, each writing
    ``{stem}{rank}.pt`` to the phase's ``directory``.  ``args`` is a
    tuple, or a function of the phase's directory that returns it;
    ``env`` holds ``(name, value)`` pairs the ranks set before their
    first CUDA allocation; ``meanwhile(torch, *args)``, when given, runs
    in the parent right after the ranks start, and what it returns comes
    back beside the reports."""

    label: str
    target: Callable
    world: int
    args: Any
    timeout_s: float
    stem: str
    env: tuple = ()
    meanwhile: Callable | None = None


def multi_rank_plan() -> dict[str, RankPhase]:
    """The rank work of the multi-rank phases that share one spawn
    (:func:`spawn_shared`), in the order its ranks run it.  Phase 25
    keeps a spawn of its own (a rank is killed and the world restarts).
    Phase 28's ranks (with 26-27's four-rank parts and 30b) come last:
    the parent runs their one-process references as the ranks start
    (:func:`seq_references`)."""
    return {
        '5': RankPhase('kaisa', kaisa_rank, KAISA_WORLD, (), KAISA_TIMEOUT_S,
                       'rank'),
        '17': RankPhase('resnet50 pipelined', pipeline_rank, KAISA_WORLD,
                        (RN50_IMAGE, RN50_BATCH, PIPE_MODEL),
                        RN50_PIPE_TIMEOUT_S, 'pipe'),
        '18': RankPhase('resnet50 ekfac grid', ekfac_grid_rank, KAISA_WORLD,
                        (RN50_IMAGE, RN50_BATCH, GRID_MODEL),
                        RN50_GRID_TIMEOUT_S, 'grid'),
        '21': RankPhase('resnet50 consistency', consistency_rank,
                        KAISA_WORLD, (RN50_IMAGE, RN50_BATCH, CONS_MODEL),
                        RN50_CONS_TIMEOUT_S, 'cons'),
        '22': RankPhase('resnet50 resize', elastic_rank,
                        RN50_RESIZE_WORLDS[0],
                        (RN50_IMAGE, RN50_BATCH, ELASTIC_MODEL),
                        RN50_RESIZE_TIMEOUT_S, 'resize'),
        '23': RankPhase('watchdog ranks', watchdog_rank, 2, (),
                        WATCH_RANK_TIMEOUT_S, 'watch'),
        '31': RankPhase('resnet50 placement', placement_rank, KAISA_WORLD,
                        (RN50_IMAGE, RN50_BATCH, PLACE_MODEL),
                        PLACE_TIMEOUT_S, 'place'),
        # Four ranks share the card: segments that grow in place keep the
        # freed attention blocks reusable.
        '28': RankPhase('seq/tp', world_rank, SEQ_WORLD, seq_ref_paths,
                        SEQ_TIMEOUT_S, 'seq',
                        env=(('PYTORCH_CUDA_ALLOC_CONF',
                              'expandable_segments:True'),),
                        meanwhile=seq_references),
    }


def plan_backend(world: int) -> str:
    from kfac_pytorch_tpu_torch.parallel.mesh import default_backend

    return default_backend(world) if DEVICE == 'cuda' else 'gloo'


def spawn_alone(torch, key):
    """One phase's ranks in a spawn of their own: the phase functions'
    path when no shared spawn gave them reports."""
    return spawn_shared(torch, [key])[0][key]


def shared_rank(rank, device_type, workdir, entries, env):
    """One process of :func:`spawn_shared`: each entry's target in turn
    (on the ranks below its world), in a directory of its own, so each
    phase makes its own process groups and writes its own reports.  A
    failure is written to ``<stem><rank>.error`` before it is raised, so
    the parent names the phase.  Between phases the backend flags a
    phase sets are put back and the card's cache is emptied.  ``env``
    is set before the process's first CUDA allocation."""
    import traceback

    os.environ.update(env)
    import torch

    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    for label, target, n, phase_backend, args, stem in entries:
        sub = os.path.join(workdir, stem)
        if rank < n:
            with open(os.path.join(sub, f'started{rank}'), 'w'):
                pass
            try:
                target(rank, n, phase_backend, device_type, sub, *args)
            except BaseException:
                with open(os.path.join(sub, f'{stem}{rank}.error'),
                          'w') as f:
                    f.write(traceback.format_exc())
                raise
        (torch.backends.cudnn.deterministic,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
        gc.collect()
        if device_type == 'cuda':
            torch.cuda.empty_cache()


class SharedSpawn:
    """The ranks of the phases ``keys`` of :func:`multi_rank_plan`
    (default all) in one spawn of as many processes as the widest needs
    (:func:`shared_rank`), which pay the start, the imports and the
    card's context once.  Made, it has started the ranks and run every
    phase's ``meanwhile`` here; the parent then goes on with phases of
    its own while the ranks run (their gloo collectives hold the host
    far more than the card), and :meth:`wait` joins them.  :meth:`stop`
    kills whatever still runs and removes the ranks' directory."""

    def __init__(self, torch, keys=None):
        import torch.multiprocessing as mp

        plan = multi_rank_plan()
        self.torch = torch
        self.keys = list(plan) if keys is None else list(keys)
        world = max(plan[k].world for k in self.keys)
        self.timeout_s = sum(plan[k].timeout_s for k in self.keys)
        env = {name: value for k in self.keys for name, value in plan[k].env}
        self.workdir = tempfile.mkdtemp(prefix='ranks_')
        self.entries, args = [], {}
        for k in self.keys:
            ph = plan[k]
            sub = os.path.join(self.workdir, ph.stem)
            os.makedirs(sub)
            args[k] = ph.args(sub) if callable(ph.args) else ph.args
            self.entries.append((ph.label, ph.target, ph.world,
                                 plan_backend(ph.world), args[k], ph.stem))
        ctx = mp.get_context('spawn')
        self.procs = [ctx.Process(target=shared_rank,
                                  args=(rank, DEVICE, self.workdir,
                                        self.entries, env))
                      for rank in range(world)]
        self.t0 = time.perf_counter()
        self.deadline = time.time() + self.timeout_s
        self.result = None
        for p in self.procs:
            p.start()
        self.meanwhile = {}
        try:
            for k in self.keys:
                if plan[k].meanwhile is not None:
                    self.meanwhile[k] = plan[k].meanwhile(torch, *args[k])
        except BaseException:
            self.stop()
            raise

    def wait(self):
        """Joins the ranks; returns ``({key: the ranks' reports}, {key:
        what its meanwhile returned})``; fails naming the phase whose
        rank failed or hung (a failed rank ends the spawn at once).
        Prints how long each phase took on rank 0."""
        if self.result is not None:
            return self.result
        procs = self.procs
        try:
            while time.time() < self.deadline and any(p.is_alive()
                                                      for p in procs):
                if any(p.exitcode for p in procs if not p.is_alive()):
                    break
                time.sleep(0.2)
        finally:
            alive = [i for i, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        ended = time.perf_counter() - self.t0
        codes = [p.exitcode for p in procs]
        for label, _, n, _, _, stem in self.entries:
            for r in range(n):
                err = os.path.join(self.workdir, stem, f'{stem}{r}.error')
                if os.path.exists(err):
                    with open(err) as f:
                        text = f.read().strip().splitlines()
                    fail(f'{label} rank {r} failed: {text[-1]} (exit codes '
                         f'{codes})')
        if alive or any(codes):
            pending = next((e[0] for e in self.entries if not all(
                os.path.exists(self.report(e[5], r)) for r in range(e[2]))),
                'shared spawn')
            fail(f'{pending} ranks {alive} did not finish in '
                 f'{self.timeout_s} s' if alive
                 else f'{pending}: ranks exited with {codes}')
        spans = []
        for label, _, _, _, _, stem in self.entries:
            began = os.path.join(self.workdir, stem, 'started0')
            took = (os.path.getmtime(self.report(stem, 0))
                    - os.path.getmtime(began))
            spans.append(f'{label} {took:.2f} s')
        print(f'shared ranks: {len(procs)} processes, ended {ended:.2f} s '
              f'after their start; rank 0 by phase: {", ".join(spans)}',
              flush=True)
        self.result = ({k: [self.torch.load(self.report(e[5], r))
                            for r in range(e[2])]
                        for k, e in zip(self.keys, self.entries)},
                       self.meanwhile)
        self.stop()
        return self.result

    def report(self, stem, rank):
        return os.path.join(self.workdir, stem, f'{stem}{rank}.pt')

    def stop(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(self.workdir, ignore_errors=True)


def spawn_shared(torch, keys=None):
    """:class:`SharedSpawn` of ``keys``, joined at once: returns what
    :meth:`SharedSpawn.wait` returns."""
    ranks = SharedSpawn(torch, keys)
    try:
        return ranks.wait()
    finally:
        ranks.stop()


def phase_kaisa(torch, kt, ranks=None):
    """Four ranks on the KAISA grid (``ranks``: their reports from the
    shared spawn, :func:`spawn_shared`; ``None`` spawns them here);
    returns the kernel's launches over the checked passes (every rank,
    every strategy) and the MEM-OPT gradient gather's time per step over
    its timing pass (all calls)."""
    from kfac_pytorch_tpu_torch.parallel.mesh import default_backend

    world = KAISA_WORLD
    if DEVICE == 'cuda':
        backend = default_backend(world)
        share = (f'all four ranks share cuda:0, '
                 f'{torch.cuda.get_device_name(0)}' if backend == 'gloo'
                 else 'one card per rank')
        where = f'{torch.cuda.device_count()} card(s): {share}'
    else:
        backend, where = 'gloo', 'CPU rehearsal'
    print(f'kaisa: world {world}, backend {backend} ({where}); the times '
          'below are correctness-path times, not a scaling result',
          flush=True)
    if ranks is None:
        ranks = spawn_alone(torch, '5')
    total_launches = 0
    mem_gather_ms = None
    for strategy in KAISA_STRATEGIES:
        runs = [r[strategy] for r in ranks]
        losses = [statistics.fmean(v) for v in zip(*(r['losses']
                                                      for r in runs))]
        if not losses[-1] < losses[0]:
            fail(f'kaisa {strategy}: mean loss did not fall: {losses}')
        total_launches += sum(r['launches'] for r in runs)
        rows, cols = runs[0]['grid'][:2]
        print(f'kaisa {strategy}: grid {rows}x{cols}; mean loss '
              f'{losses[0]:.6f} -> {losses[-1]:.6f} over {KAISA_STEPS} '
              f'steps; parameters bitwise equal across ranks after every '
              'step', flush=True)
        step_ms = statistics.median(
            ms for r in runs for ms in r['step_s'][1:]) * 1e3
        print(f'kaisa {strategy}: median step {step_ms:.4f} ms (steps '
              f'1-{KAISA_STEPS - 1}, all ranks, host clock, synchronized at '
              'the step end; collectives untimed)', flush=True)
        idle = {'decomposition gather': rows == 1,
                'gradient gather': cols == 1}
        for name in ('factor all-reduce', 'decomposition gather',
                     'gradient gather'):
            if idle.get(name):
                print(f'kaisa {strategy}: {name}: nothing moves (grid axis '
                      'of 1)', flush=True)
                continue
            calls = [t * 1e3 for r in runs for t in r['times'][name]]
            steps = KAISA_STEPS * len(runs)
            # The sum holds every stall (the first call on a group also
            # sets it up); the median-based figure leaves them out.
            total = sum(calls) / steps
            at_median = statistics.median(calls) * len(calls) / steps
            print(f'kaisa {strategy}: {name}: median '
                  f'{statistics.median(calls):.4f} ms per call over '
                  f'{len(calls)} calls (all ranks; max {max(calls):.4f} '
                  f'ms); per step {total:.4f} ms in all, {at_median:.4f} ms '
                  'at the median (timing pass)', flush=True)
            if strategy == 'MEM_OPT' and name == 'gradient gather':
                mem_gather_ms = total
        for rank, r in enumerate(runs):
            print(f'kaisa {strategy} rank {rank}: grid (row, col) = '
                  f'{r["grid"][2:]}, shards launched (seg, gp, ap) '
                  f'{[s for _, s in r["shards"]]}, launches {r["launches"]} '
                  f'({r["n_buckets"]} buckets x {KAISA_STEPS} steps), '
                  f'step {CHECK_STEP} rel err vs single-process rerun '
                  f'{r["check_rel_err"]:.3e}, sharded vs plain f32 max abs '
                  f'err {r["f32_err"]:.3e}, bf16 mean rel err '
                  f'{r["bf16_err"]:.3e}, second-order bytes '
                  f'{r["memory"]["second_order"]}', flush=True)
    for strategy, method in KAISA_METHOD_RUNS:
        runs = [r[strategy, method] for r in ranks]
        losses = [statistics.fmean(v) for v in zip(*(r['losses']
                                                      for r in runs))]
        if not losses[-1] < losses[0]:
            fail(f'kaisa {strategy} {method}: mean loss did not fall: '
                 f'{losses}')
        rows, cols = runs[0]['grid'][:2]
        step_ms = statistics.median(
            ms for r in runs for ms in r['step_s'][1:]) * 1e3
        errs = ', '.join(f'{r["check_rel_err"]:.3e}' for r in runs)
        print(f'kaisa {strategy} {method}: grid {rows}x{cols}; mean loss '
              f'{losses[0]:.6f} -> {losses[-1]:.6f} over {KAISA_STEPS} '
              'steps; parameters bitwise equal across ranks after every '
              f'step; fused-kernel launches 0; median step {step_ms:.4f} '
              f'ms; step {CHECK_STEP} rel err vs single-process rerun per '
              f'rank {errs}; second-order bytes per rank '
              f'{runs[0]["memory"]["second_order"]}', flush=True)
    for strategy in KAISA_STRATEGIES:
        runs = [r[strategy, 'bf16_triu'] for r in ranks]
        losses = [statistics.fmean(v) for v in zip(*(r['losses']
                                                      for r in runs))]
        if not losses[-1] < losses[0]:
            fail(f'kaisa {strategy} bf16_triu: mean loss did not fall: '
                 f'{losses}')
        total_launches += sum(r['launches'] for r in runs)
        packed, dense, every = runs[0]['wire']
        step_ms = statistics.median(
            ms for r in runs for ms in r['step_s'][1:]) * 1e3
        reduce_ms = (sum(t for r in runs for t in r['reduce_s']) * 1e3
                     / (KAISA_STEPS * len(runs)))
        print(f'kaisa {strategy} bf16_triu: grid {runs[0]["grid"]}; mean '
              f'loss {losses[0]:.6f} -> {losses[-1]:.6f}; parameters '
              'bitwise equal across ranks after every step; launches '
              f'{[r["launches"] for r in runs]}; step-0 factors vs the '
              'dense run, worst per rank '
              + ', '.join(f'{r["bar"]:.3f}' for r in runs)
              + ' of the bf16 bar (rtol 0.02, atol 0.02 max|F|); wire '
              f'bytes of the packed factors {packed} against {dense} dense '
              f'f32 (ratio {packed / dense:.4f}; d(d+1)/2 x 2 against d^2 '
              f'x 4), of all factors {packed + every - dense} against '
              f'{every}; factor all-reduce {reduce_ms:.4f} ms per step in '
              'all (timing pass: the bf16 triangles and the dense rest); '
              f'median step {step_ms:.4f} ms (checked pass)', flush=True)
    runs = [r['stagger'] for r in ranks]
    total_launches += sum(r['launches'] for r in runs)
    losses = [statistics.fmean(v) for v in zip(*(r['losses'] for r in runs))]
    if not losses[-1] < losses[0]:
        fail(f'kaisa HYBRID_OPT stagger: mean loss did not fall: {losses}')
    print(f'kaisa HYBRID_OPT stagger_refresh=2 (inv 4): grid '
          f'{runs[0]["grid"]}; refreshes per step {runs[0]["actions"]} on '
          'every rank; the sharded kernel launched '
          f'{[r["launches"] for r in runs]} times; mean loss '
          f'{losses[0]:.6f} -> {losses[-1]:.6f}; shard sweep vs one '
          'monolithic refresh on the last factors, preconditioned grads '
          'rel err per rank '
          + ', '.join(f'{r["sweep_err"]:.3e}' for r in runs)
          + f' (gate {eigen_gate(576):.3e})', flush=True)
    runs = [r['adaptive'] for r in ranks]
    total_launches += sum(r['launches'] for r in runs)
    for rank, r in enumerate(runs[1:], 1):
        if not (r['events'] == runs[0]['events']
                and torch.equal(r['digest'], runs[0]['digest'])
                and torch.equal(r['sketch'], runs[0]['sketch'])):
            fail(f'kaisa HYBRID_OPT adaptive: rank {rank} decided '
                 f'{r["events"]}, rank 0 {runs[0]["events"]}')
    bad = adaptive_invariants(runs[0]['events'], 4, 12)
    if bad:
        fail(f'kaisa HYBRID_OPT adaptive: contract violations {bad}')
    print(f'kaisa HYBRID_OPT adaptive (stagger 2, inv 4, threshold 0.2, '
          f'floor 3x): every rank made the same decisions from the same '
          f'digest and sketch: {runs[0]["events"]}; counters '
          f'{runs[0]["counters"]}; host reads of the drift '
          f'{runs[0]["syncs"]} per rank over {KAISA_STEPS} factor steps; '
          f'launches {[r["launches"] for r in runs]}', flush=True)
    for strategy in KAISA_STRATEGIES:
        runs = [r[strategy, 'pipelined'] for r in ranks]
        total_launches += sum(r['launches'] for r in runs)
        losses = [statistics.fmean(v)
                  for v in zip(*(r['losses'] for r in runs))]
        if not losses[-1] < losses[0]:
            fail(f'kaisa {strategy} pipelined: mean loss did not fall: '
                 f'{losses}')
        step_ms = statistics.median(
            ms for r in runs for ms in r['step_s'][1:]) * 1e3
        print(f'kaisa {strategy} pipeline_grads: grid {runs[0]["grid"]}; '
              f'issue order {list(runs[0]["order"])}; every step\'s '
              'pipelined tail bitwise equal to the synchronous tail on the '
              'same state, every rank; parameters bitwise equal across '
              f'ranks; async row gathers per rank '
              f'{[r["gathers"] for r in runs]}; launches '
              f'{[r["launches"] for r in runs]}; mean loss {losses[0]:.6f} '
              f'-> {losses[-1]:.6f}; median step {step_ms:.4f} ms (with the '
              'per-step tail check)', flush=True)
    if [s[1][0] for s in ranks[0]['MEM_OPT']['shards']] != MEM_OPT_SEGS:
        fail(f'MEM-OPT shards {ranks[0]["MEM_OPT"]["shards"]}')
    return total_launches, mem_gather_ms


#: Phase 9: ImageNet ResNet-50 at its published widths, the ImageNet
#: trainer's cadence (``bench.py:1803-1830``).  The rehearsal on the CPU
#: sets a small ``RN50_IMAGE`` and fewer steps.
RN50_HP = dict(factor_update_steps=10, inv_update_steps=100, damping=0.003,
               kl_clip=0.001, lr=0.1)
RN50_BATCH = 32
RN50_IMAGE = 224
RN50_STEPS = 21  # factor steps 0, 10 and 20; the refresh at step 0
RN50_ACCUM = 4  # micro-batches of RN50_BATCH // RN50_ACCUM rows
RN50_ACCUM_STEPS = 11  # factor steps 0 and 10
#: The bench line's shortened cycle.
RN50_BENCH = dict(inv_steps=20, cycles=1)
#: Phase 9's exact refresh times and ``memory_usage()`` in this run,
#: printed beside phases 12 and 13.
RN50_EXACT: dict = {}

#: Phase 12: ResNet-50 at ``lowrank_rank=512`` with the JAX defaults
#: (oversample 32, two power iterations), a factor update every step and
#: refreshes at 0, 5 and ``RN50_LOWRANK_CHECK``.
RN50_LOWRANK_HP = dict(RN50_HP, factor_update_steps=1, inv_update_steps=5)
RN50_LOWRANK_RANK = 512
RN50_LOWRANK_STEPS = 11
RN50_LOWRANK_CHECK = 10
#: Which sides of ResNet-50's buckets truncate at rank 512 (``(A, G)``);
#: the other ten buckets stay exact and keep the fused kernel.
RN50_LOWRANK_SIDES = {
    'a4608g512': (True, False), 'a2304g256': (True, False),
    'a2048g512': (True, False), 'a1152g128': (True, False),
    'a1024g512': (True, False), 'a1024g256': (True, False),
    'a512g2048': (False, True), 'a512g1024': (False, True),
    'a256g1024': (False, True), 'a2176g1024': (True, True),
    'a1024g2048': (True, True),
}
#: The exact buckets' stacks ``(L, gp, ap)``, phase 2's kernel cases of
#: the low-rank path.
RN50_LOWRANK_CASES = [c for c in RN50_CASES
                      if f'a{c[2]}g{c[1]}' not in RN50_LOWRANK_SIDES]
#: The gate of the truncated buckets' preconditioned gradients against a
#: float64 CPU evaluation of the same code on the same sketch (relative
#: Frobenius error per layer).
RN50_LOWRANK_F64_GATE = 1e-4

#: Phase 13: ResNet-50 under EKFAC, a factor update every step, the
#: cadence's refresh at 0 only (inv 100), and the drift controller with
#: the stated threshold and least interval.
RN50_EKFAC_HP = dict(RN50_HP, factor_update_steps=1, inv_update_steps=100)
RN50_EKFAC_STEPS = 12
RN50_DRIFT = dict(threshold=0.2, min_interval=4)
#: The factor step (no refresh) whose scale update is recomputed in
#: float64 on the CPU, and the buckets whose first layer it checks.
RN50_EKFAC_CHECK = 2
RN50_EKFAC_CHECK_BUCKETS = ('a576g64', 'a4608g512', 'a2176g1024')


def rn50_batch(torch):
    """The one synthetic ImageNet batch phase 9 trains on."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(3)
    x = torch.randn(RN50_BATCH, 3, RN50_IMAGE, RN50_IMAGE, generator=gen,
                    device=DEVICE)
    y = torch.randint(0, 1000, (RN50_BATCH,), generator=gen, device=DEVICE)
    return x, y


def train_resnet50(torch, kt, steps, accumulation=1):
    """``steps`` K-FAC steps of ResNet-50 on the fixed batch through
    :func:`train_path`, split into ``accumulation`` micro-batches (each
    loss divided by their number), SGD with momentum 0.9, step 0 (a
    refresh step) checked against the plain version; also fails unless
    the plan is ``RN50_CASES``."""
    import torch.nn.functional as F

    model = kt.models.resnet50(device=DEVICE, seed=0)
    x, y = rn50_batch(torch)
    xs, ys = x.chunk(accumulation), y.chunk(accumulation)

    def fwd_bwd():
        losses = []
        for xm, ym in zip(xs, ys):
            loss = F.cross_entropy(model(xm), ym)
            (loss / accumulation).backward()
            losses.append(loss.detach())
        return sum(losses) / accumulation

    label = f'resnet50 accumulation {accumulation}'
    run = train_path(torch, kt, label, model, fwd_bwd, RN50_HP, steps,
                     check_step=0, momentum=0.9,
                     accumulation_steps=accumulation)
    precond = run['precond']
    shapes = [(b.n_slots, b.g_pad, b.a_pad) for b in precond.plan.buckets]
    if shapes != RN50_CASES or len(precond.layers) != 54:
        fail(f'{label}: {len(precond.layers)} layers in buckets {shapes}, '
             f'expected 54 in {RN50_CASES}')
    return run


def rn50_factors_split(torch, kt, accumulation):
    """The factor contributions of one factor step on the fixed batch, in
    ``accumulation`` micro-batches (``factor_decay=0``, so the EMA is the
    contribution itself, and no refresh: ``inv_update_steps=0``),
    BatchNorm in eval mode (so every split normalizes alike)."""
    import torch.nn.functional as F

    model = kt.models.resnet50(device=DEVICE, seed=0)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.eval()
    x, y = rn50_batch(torch)
    precond = kt.KFACPreconditioner(
        model, accumulation_steps=accumulation,
        **dict(RN50_HP, factor_decay=0.0, inv_update_steps=0, kl_clip=None),
    )
    for xm, ym in zip(x.chunk(accumulation), y.chunk(accumulation)):
        (F.cross_entropy(model(xm), ym) / accumulation).backward()
    precond.step()
    out = {n: (st.a_factor, st.g_factor) for n, st in precond.layers.items()}
    del precond, model
    return out


def phase_resnet50(torch, kt):
    """Phase 9: ImageNet ResNet-50 at its published widths (1000
    classes, batch ``RN50_BATCH`` at ``RN50_IMAGE``), 54 layers in 21
    buckets, f32 with TF32 off: ``RN50_STEPS`` steps, then
    ``RN50_ACCUM_STEPS`` steps of ``RN50_ACCUM`` micro-batches; the
    accumulated factors against one whole batch's; one bench line at a
    shortened cycle.  Returns the first run's kernel launches."""
    from kfac_pytorch_tpu_torch import bench

    launches = None
    for steps, accumulation in ((RN50_STEPS, 1),
                                (RN50_ACCUM_STEPS, RN50_ACCUM)):
        run = train_resnet50(torch, kt, steps, accumulation)
        precond = run['precond']
        label = (f'resnet50: batch {RN50_BATCH} at {RN50_IMAGE}x{RN50_IMAGE}'
                 f', accumulation {accumulation} x '
                 f'{RN50_BATCH // accumulation} rows')
        print(f'{label}: {len(precond.layers)} layers, '
              f'{len(RN50_CASES)} buckets', flush=True)
        report_path(label, run, steps, '; factor steps included')
        if launches is None:
            launches = run['launches']
            RN50_EXACT.update(refresh_ms=run['refresh_ms'],
                              memory=precond.memory_usage())
        del run, precond
        torch.cuda.empty_cache()

    # The JAX package's accumulation takes each micro-batch's factors from
    # the gradients of that micro-batch's own mean loss, which are N times
    # the whole batch's per row: A (a mean over rows) is the whole batch's,
    # and G (a mean of squares of those gradients) is N^2 times it.
    whole = rn50_factors_split(torch, kt, 1)
    split = rn50_factors_split(torch, kt, RN50_ACCUM)
    errs = {(n, side): rel_frob(split[n][side],
                                whole[n][side] * RN50_ACCUM ** (2 * side))
            for n in whole for side in (0, 1)}
    worst = max(errs, key=errs.get)
    if not errs[worst] < 1e-5:
        fail(f'resnet50: accumulated factors vs one batch: {worst} rel err '
             f'{errs[worst]:.3e}')
    print(f'resnet50: factors of {RN50_ACCUM} x {RN50_BATCH // RN50_ACCUM} '
          f'micro-batches vs one batch of {RN50_BATCH} (BatchNorm in eval '
          f'mode, first factor step, A against A and G against '
          f'{RN50_ACCUM}^2 G): worst {worst[0]} {"AG"[worst[1]]} rel err '
          f'{errs[worst]:.3e} over {len(errs)} factors', flush=True)
    del whole, split
    torch.cuda.empty_cache()

    line = bench.run(['resnet50', 'resnet32_cifar'], DEVICE, **RN50_BENCH)
    print(f'bench (inv {RN50_BENCH["inv_steps"]}, {RN50_BENCH["cycles"]} '
          f'cycle): {json.dumps(line)}', flush=True)
    for name in ('resnet50', 'resnet32_cifar'):
        d = line['detail']
        if not (d[f'{name}_sgd_ms'] > 0 and d[f'{name}_kfac_ms_amortized']
                > 0 and math.isfinite(d[f'{name}_ratio'])):
            fail(f'bench {name}: {d}')
    return launches


def rn50_fwd_bwd(torch, model):
    """Phase 9's fixed batch, cross entropy, backward; the detached loss."""
    import torch.nn.functional as F

    x, y = rn50_batch(torch)

    def fwd_bwd():
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        return loss.detach()
    return fwd_bwd


def padded_factor(torch, factor, pad):
    """A factor zero-padded to ``pad``, as a low-rank bucket stacks it."""
    d = factor.shape[-1]
    return torch.nn.functional.pad(factor, (0, pad - d, 0, pad - d))


def lowrank_f64_reference(torch, kt, precond, layers, raw, step, damping):
    """Per layer of a truncated bucket, its preconditioned gradient from a
    float64 CPU evaluation of the port's own low-rank code on the same
    factors, raw gradients and sketches: each sketch is drawn once, by
    the card's generator, and moved (a CPU generator draws another
    stream)."""
    from kfac_pytorch_tpu_torch.ops import lowrank

    so = precond._second_order
    real = lowrank.draw_sketch
    lowrank.draw_sketch = (
        lambda seed, side, st, slot, n, m, device:
        real(seed, side, st, slot, n, m, DEVICE).to(device))
    out = {}
    try:
        for b in precond.plan.buckets:
            sides = so.lowrank_sides(b.key)
            if not any(sides):
                continue
            dims = so._slot_dims[b.key]
            decomp = []
            for side, (pad, lowrank_side) in enumerate(
                    zip((b.a_pad, b.g_pad), sides)):
                stack = torch.stack([
                    padded_factor(torch, (layers[n].a_factor,
                                          layers[n].g_factor)[side]
                                  .cpu().double(), pad)
                    if n else torch.zeros(pad, pad, dtype=torch.float64)
                    for n in b.slots
                ])
                decomp.append(lowrank.decompose_stack(
                    stack, lowrank_side, RN50_LOWRANK_RANK,
                    oversample=so.lowrank_oversample,
                    power_iters=so.lowrank_power_iters,
                    seed=so._bucket_seed[b.key], side=side, step=step,
                    slots=range(b.n_slots), effective_dims=dims[side],
                ))
            grads = torch.stack([
                torch.nn.functional.pad(
                    raw[n].cpu().double(),
                    (0, b.a_pad - raw[n].shape[1],
                     0, b.g_pad - raw[n].shape[0]))
                if n else torch.zeros(b.g_pad, b.a_pad, dtype=torch.float64)
                for n in b.slots
            ])
            pg = lowrank.precondition_grad_lowrank(
                grads, decomp[0], decomp[1], damping,
                lowrank_a=sides[0], lowrank_g=sides[1],
            )
            for i, n in enumerate(b.slots):
                if n:
                    go, ga = raw[n].shape
                    out[n] = pg[i, :go, :ga]
    finally:
        lowrank.draw_sketch = real
    return out


def phase_resnet50_lowrank(torch, kt):
    """Phase 12: ResNet-50 at ``lowrank_rank=512`` on phase 9's batch:
    ``RN50_LOWRANK_STEPS`` steps, refreshes at 0, 5 and 10.  Gates: the
    truncated sides are ``RN50_LOWRANK_SIDES``; the fused kernel runs
    10 times a step (its exact buckets) and matches its plain version at
    the step-10 refresh; every truncated side's Ritz values at step 10
    lie below the exact eigenvalues of the same factor (``d_i <= lambda_i
    (1 + 1e-3) + 1e-6 lambda_max``, a float64 ``eigvalsh`` on the card);
    rerunning that refresh from the same factors and sketch step gives
    the same bits; the truncated buckets' preconditioned gradients
    against a float64 CPU evaluation on the same sketches (relative
    ``< RN50_LOWRANK_F64_GATE``); a finite, falling loss.  Returns the
    kernel launches."""
    from kfac_pytorch_tpu_torch.state import LayerKFACState

    snap = {}

    def on_precond(precond):
        refresh = precond._refresh

        def keep(damping):
            if precond.steps == RN50_LOWRANK_CHECK:
                snap['layers'] = {
                    n: LayerKFACState(a_factor=st.a_factor,
                                      g_factor=st.g_factor)
                    for n, st in precond.layers.items()}
                snap['prev'] = precond.buckets
                snap['damping'] = damping
            out = refresh(damping)
            if precond.steps == RN50_LOWRANK_CHECK:
                snap['buckets'] = precond.buckets
                snap['sketch_step'] = precond._last_inv_step
            return out
        precond._refresh = keep

    model = kt.models.resnet50(device=DEVICE, seed=0)
    label = (f'resnet50 lowrank {RN50_LOWRANK_RANK}: batch {RN50_BATCH} at '
             f'{RN50_IMAGE}x{RN50_IMAGE}')
    run = train_path(torch, kt, label, model, rn50_fwd_bwd(torch, model),
                     RN50_LOWRANK_HP, RN50_LOWRANK_STEPS,
                     check_step=RN50_LOWRANK_CHECK, momentum=0.9,
                     on_precond=on_precond, keep_check=True,
                     lowrank_rank=RN50_LOWRANK_RANK)
    precond = run['precond']
    so = precond._second_order
    sides = {b.key: so.lowrank_sides(b.key) for b in precond.plan.buckets}
    truncated = {k: v for k, v in sides.items() if any(v)}
    exact = [(b.n_slots, b.g_pad, b.a_pad) for b in precond.plan.buckets
             if not any(sides[b.key])]
    if truncated != RN50_LOWRANK_SIDES or exact != RN50_LOWRANK_CASES:
        fail(f'{label}: truncated sides {truncated}, exact buckets {exact}')
    if snap.get('sketch_step') != RN50_LOWRANK_CHECK:
        fail(f'{label}: the step-{RN50_LOWRANK_CHECK} refresh was not seen '
             f'({snap.get("sketch_step")})')

    # Rayleigh-Ritz: the Ritz values of a subspace lie below the matching
    # exact eigenvalues; the captured share of each factor's trace.
    worst, fracs = -math.inf, []
    for b in precond.plan.buckets:
        for side, lowrank_side in enumerate(sides[b.key]):
            if not lowrank_side:
                continue
            pad = (b.a_pad, b.g_pad)[side]
            bs = snap['buckets'][b.key]
            d_all = (bs.da, bs.dg)[side]
            for i, name in enumerate(b.slots):
                if name is None:
                    continue
                st = snap['layers'][name]
                f = padded_factor(torch, (st.a_factor, st.g_factor)[side]
                                  .double(), pad)
                lam = torch.linalg.eigvalsh(f).flip(0)[:d_all.shape[-1]]
                d = d_all[i].double().sort(descending=True).values
                over = d - lam * (1 + 1e-3) - 1e-6 * lam[0]
                worst = max(worst, float((over / lam[0]).max()))
                if bool((over > 0).any()):
                    fail(f'{label}: {b.key} slot {i} side {"AG"[side]}: a '
                         f'Ritz value above its eigenvalue by '
                         f'{float(over.max()):.3e} (lambda_max '
                         f'{float(lam[0]):.3e})')
                fracs.append(float(d.sum() / torch.diagonal(f).sum()))
    again = so.compute(snap['layers'], snap['damping'], prev=snap['prev'],
                       sketch_step=snap['sketch_step'])
    for key in truncated:
        for field, t in again[key].tensors().items():
            if not torch.equal(t, snap['buckets'][key].tensors()[field]):
                fail(f'{label}: rerunning the step-{RN50_LOWRANK_CHECK} '
                     f'refresh changed {key}.{field}')

    # The card's preconditioned gradients of the truncated buckets (no
    # kl-clip) against the float64 CPU evaluation.
    got, _ = precond.precondition_combined(
        run['raw'], snap['damping'], None, RN50_LOWRANK_HP['lr'])
    want = lowrank_f64_reference(torch, kt, precond, snap['layers'],
                                 run['raw'], snap['sketch_step'],
                                 snap['damping'])
    errs = {n: rel_frob(got[n].double().cpu(), w) for n, w in want.items()}
    f64_worst = max(errs, key=errs.get)
    if not errs[f64_worst] < RN50_LOWRANK_F64_GATE:
        fail(f'{label}: truncated buckets vs float64 CPU: {f64_worst} rel '
             f'err {errs[f64_worst]:.3e} (gate {RN50_LOWRANK_F64_GATE})')
    n_truncated = sum(len(b.slots) for b in precond.plan.buckets
                      if any(sides[b.key]))
    print(f'{label}: {len(precond.layers)} layers in '
          f'{len(precond.plan.buckets)} buckets, truncated '
          f'{sorted(truncated)} ({n_truncated} slots), exact {len(exact)} '
          f'buckets {exact}', flush=True)
    report_path(label, run, RN50_LOWRANK_STEPS,
                '; factor steps and refreshes 0, 5, 10 included')
    print(f'{label}: step {RN50_LOWRANK_CHECK} refresh: Ritz values below '
          f'the exact float64 eigenvalues on every truncated side (largest '
          f'(d - lambda (1 + 1e-3) - 1e-6 lambda_max) / lambda_max '
          f'{worst:.3e}); captured trace fraction sum(d) / tr over '
          f'{len(fracs)} slot sides min {min(fracs):.6f} median '
          f'{statistics.median(fracs):.6f} max {max(fracs):.6f}; rerun from '
          f'the same factors and sketch step bitwise equal; truncated '
          f'buckets vs float64 CPU on the card\'s sketches: worst layer '
          f'{f64_worst} rel err {errs[f64_worst]:.3e} over {len(errs)} '
          'layers', flush=True)
    exact_ms = RN50_EXACT.get('refresh_ms')
    print(f'{label}: refreshes {[round(t, 2) for t in run["refresh_ms"]]} '
          f'ms against phase 9\'s exact refresh '
          f'{[round(t, 2) for t in exact_ms] if exact_ms else "not run"} ms; '
          f'memory_usage {precond.memory_usage()} against phase 9\'s '
          f'{RN50_EXACT.get("memory", "not run")}', flush=True)
    launches = run['launches']
    del run, precond, model, snap, again, got, want
    torch.cuda.empty_cache()
    return launches


def phase_resnet50_ekfac(torch, kt):
    """Phase 13: ResNet-50 under EKFAC with an ``AdaptiveRefresh`` of
    ``RN50_DRIFT`` on phase 9's batch, ``RN50_EKFAC_STEPS`` steps.  Gates:
    no fused-kernel launch; right after every refresh ``skron == dg ⊗
    da`` bitwise; the scale update of step ``RN50_EKFAC_CHECK`` against a
    float64 CPU recompute from the same captured rows and basis
    (relative ``<= 1e-5``, the first layer of each of
    ``RN50_EKFAC_CHECK_BUCKETS``); at least one refresh triggered by the
    drift, off the cadence; a finite, falling loss.  Prints the drift
    at every factor step and the stage medians with the scales' own."""
    ar = kt.AdaptiveRefresh(**RN50_DRIFT)
    seen = dict(refreshes=[], reseed=[], drift=[], check={}, scale_ev=[])
    names = {}

    def timed_scales(fn):
        def run(*a, **k):
            s_ev = torch.cuda.Event(enable_timing=True)
            e_ev = torch.cuda.Event(enable_timing=True)
            s_ev.record()
            out = fn(*a, **k)
            e_ev.record()
            seen['scale_ev'].append((seen['step'], s_ev, e_ev))
            return out
        return run

    def on_precond(precond):
        so = precond._second_order
        for key in RN50_EKFAC_CHECK_BUCKETS:
            b = next(b for b in precond.plan.buckets if b.key == key)
            names[b.slots[0]] = key
        seen['step'] = 0
        refresh, fold = precond._refresh, precond._ekfac_fold
        update = so.ekfac_update

        def on_refresh(damping):
            out = refresh(damping)
            seen['refreshes'].append(precond.steps)
            seen['reseed'].append(all(
                torch.equal(bs.skron, bs.dg.float()[:, :, None]
                            * bs.da.float()[:, None, :])
                for bs in precond.buckets.values()))
            return out

        def on_fold(name, roles, scale):
            seen['step'] = precond.steps
            if precond.steps == RN50_EKFAC_CHECK and name in names:
                key, slot = so.local_slot(name)
                bs = precond.buckets[key]
                seen['check'][name] = dict(
                    roles=[(h, [a.double().cpu() for a in acts],
                            [g.double().cpu() for g in grads])
                           for h, acts, grads in roles],
                    scale=scale, qa=bs.qa[slot].double().cpu(),
                    qg=bs.qg[slot].double().cpu(),
                    old=bs.skron[slot].double().cpu(), slot=slot, key=key)
            return fold(name, roles, scale)

        def on_update(buckets, contribs, decay):
            out = update(buckets, contribs, decay)
            if precond.steps == RN50_EKFAC_CHECK:
                for name, rec in seen['check'].items():
                    rec['new'] = buckets[rec['key']].skron[rec['slot']] \
                        .double().cpu()
                    rec['decay'] = decay
            return out

        def on_drift(divergence, step):
            seen['drift'].append((step, divergence))
            return real_update(divergence, step)

        real_update = ar.update
        ar.update = on_drift
        precond._refresh = on_refresh
        precond._ekfac_fold = on_fold
        so.ekfac_contrib = timed_scales(so.ekfac_contrib)
        so.ekfac_update = timed_scales(on_update)
        so.ekfac_divergence = timed_scales(so.ekfac_divergence)

    model = kt.models.resnet50(device=DEVICE, seed=0)
    label = (f'resnet50 ekfac: batch {RN50_BATCH} at {RN50_IMAGE}x'
             f'{RN50_IMAGE}')
    run = train_path(torch, kt, label, model, rn50_fwd_bwd(torch, model),
                     RN50_EKFAC_HP, RN50_EKFAC_STEPS, momentum=0.9,
                     on_precond=on_precond, ekfac=True, adaptive_refresh=ar)
    precond = run['precond']
    if not (seen['reseed'] and all(seen['reseed'])):
        fail(f'{label}: skron after the refreshes at {seen["refreshes"]} '
             f'equal to dg x da bitwise: {seen["reseed"]}')
    inv = RN50_EKFAC_HP['inv_update_steps']
    off = [s for s in seen['refreshes'] if s % inv]
    if not (off and ar.triggers >= 1 and seen['refreshes'][0] == 0):
        fail(f'{label}: refreshes at {seen["refreshes"]}, {ar.triggers} '
             'drift trigger(s): none off the cadence')
    errs = {}
    for name, rec in seen['check'].items():
        calls = []
        for helper, acts, grads in rec['roles']:
            for a, g in zip(acts, grads):
                a_rows, an = helper.get_a_rows(a)
                g_rows, gn = helper.get_g_rows(g)
                calls.append(kt.ops.ekfac_scale_contrib(
                    a_rows, g_rows, rec['qa'][:a_rows.shape[1]],
                    rec['qg'][:g_rows.shape[1]], an, gn) * rec['scale'])
        contrib = torch.stack(calls).mean(0)
        want = rec['decay'] * rec['old'] + (1 - rec['decay']) * contrib
        errs[name] = rel_frob(rec['new'], want)
    if set(errs) != set(names) or not max(errs.values()) <= 1e-5:
        fail(f'{label}: step {RN50_EKFAC_CHECK} scale update vs float64 CPU '
             f'recompute: {errs} (layers {sorted(names)})')
    by_step: dict[int, float] = {}
    for step, s_ev, e_ev in seen['scale_ev']:
        by_step[step] = by_step.get(step, 0.0) + s_ev.elapsed_time(e_ev)
    report_path(label, run, RN50_EKFAC_STEPS,
                '; factor steps and refreshes included')
    print(f'{label}: drift controller threshold {RN50_DRIFT["threshold"]} '
          f'min_interval {RN50_DRIFT["min_interval"]}: divergence at every '
          f'factor step '
          + ', '.join(f'{s}: {d:.6f}' for s, d in seen['drift'])
          + f'; refreshes at steps {seen["refreshes"]} ({len(off)} off the '
          f'cadence of inv {inv}, from {ar.triggers} drift request(s), a '
          'request at the last step running at the next); skron == dg x da '
          f'bitwise after each; fused-kernel launches {run["launches"]}',
          flush=True)
    print(f'{label}: step {RN50_EKFAC_CHECK} scale EMA vs float64 CPU '
          'recompute from the captured rows and basis: '
          + ', '.join(f'{n} ({names[n]}) {e:.3e}' for n, e in errs.items())
          + '; stage ekfac scales (projections, EMA, drift) median '
          f'{statistics.median(by_step.values()):.4f} ms a factor step over '
          f'{len(by_step)} steps (CUDA events; inside the factors stage); '
          f'refreshes {[round(t, 2) for t in run["refresh_ms"]]} ms; '
          f'memory_usage {precond.memory_usage()} against phase 9\'s '
          f'{RN50_EXACT.get("memory", "not run")}', flush=True)
    launches = run['launches']
    del run, precond, model, seen
    torch.cuda.empty_cache()
    return launches


#: Phase 14: ResNet-50 with the staggered refresh, a factor update every
#: step, a refresh interval of 10 split into ``RN50_STAGGER`` shards;
#: 21 steps staggered, then the same 21 monolithic (cut from 31 for
#: phases 29-30, for time).
RN50_STAGGER_HP = dict(RN50_HP, factor_update_steps=1, inv_update_steps=10)
RN50_STAGGER = 5
RN50_STAGGER_STEPS = 21
RN50_STAGGER_CHECK = 20  # the last refresh (shard 0): the kernel vs a rerun
#: The checkpoint of phase 14's resume, and the last resumed step.
RN50_STAGGER_SAVE = 12
RN50_STAGGER_RESUME_TO = 16
#: Phase 15: the drift-adaptive cadence on phase 14's configuration.
RN50_ADAPTIVE = dict(threshold=0.2, staleness_factor=3, record_events=True)
RN50_ADAPTIVE_STEPS = 40


def stagger_cadence(steps, inv, shards):
    """The fixed staggered cadence: the monolithic bootstrap at step 0,
    then shard ``s % inv`` at every step whose phase is below
    ``shards``."""
    return ['full' if s == 0 else (s % inv if s % inv < shards else None)
            for s in range(steps)]


def eigen_gate(n: int) -> float:
    """The card's eigen gate at padded dim ``n``: ``max(1e-4, 4 n eps)``
    (cuSOLVER's f32 ``eigh`` is backward stable to a small multiple of
    ``n eps``; phase 6)."""
    return max(1e-4, 4 * n * 1.1920929e-07)


def recorded_steps(precond, actions):
    """Record what each ``precond.step()`` refreshed (``last_refresh``)
    into ``actions``."""
    step = precond.step

    def run():
        step()
        actions.append(precond.last_refresh)
    precond.step = run


def step_spread(step_s):
    """``(p50, p95, max)`` in ms of host-clock step times (linear
    interpolation, as the bench's percentile)."""
    from kfac_pytorch_tpu_torch.tracing import percentile

    ordered = sorted(t * 1e3 for t in step_s)
    return (percentile(ordered, 0.5), percentile(ordered, 0.95),
            ordered[-1])


def stagger_sweep_check(torch, kt, precond, label):
    """On frozen factors (the run's last EMAs), a sweep of every shard
    against one monolithic refresh: the engine's own prediv stacks
    (``dgda`` per slot) and, from a stage without prediv on the same plan
    and shards, every occupied slot's ``q diag(d) q^T`` on both sides,
    held to :func:`eigen_gate`; every eigenvector stack orthonormal
    within ``1e-3``.  cuSOLVER may pick another algorithm for a
    sub-stack than for the whole stack, so nothing here is bitwise.
    Returns the worst ratios to the gates."""
    from kfac_pytorch_tpu_torch.parallel.second_order import (
        BucketedSecondOrder,
    )

    layers, damping = precond.layers, RN50_STAGGER_HP['damping']
    n_shards = precond.stagger.n_shards
    so = precond._second_order
    plain = BucketedSecondOrder(
        precond.plan, prediv_eigenvalues=False, device=so.device,
        grid=so.grid, stagger=precond.stagger,
    )
    out = dict(dgda=0.0, recon=0.0, orth=0.0)
    for stage in (so, plain):
        mono = stage.compute(layers, damping)
        swept = stage.init_buckets()
        for k in range(n_shards):
            swept = stage.compute_shard(layers, damping, k, swept)
        for b in precond.plan.buckets:
            m, w = mono[b.key], swept[b.key]
            for q in (m.qa, m.qg, w.qa, w.qg):
                eye = torch.eye(q.shape[-1], device=q.device)
                out['orth'] = max(out['orth'], float(
                    (q.mT @ q - eye).abs().max()))
            gate = eigen_gate(max(b.a_pad, b.g_pad))
            for i, name in enumerate(b.slots):
                if name is None:
                    continue
                a, g = (layers[name].a_factor.shape[-1],
                        layers[name].g_factor.shape[-1])
                if stage is so:
                    err = rel_frob(w.dgda[i, :g, :a], m.dgda[i, :g, :a])
                    out['dgda'] = max(out['dgda'], err / gate)
                    continue
                for q, d, k in ((w.qa, w.da, a), (w.qg, w.dg, g)):
                    mq, md = (m.qa, m.da) if q is w.qa else (m.qg, m.dg)
                    rebuilt = q[i] @ torch.diag(d[i]) @ q[i].mT
                    ref = mq[i] @ torch.diag(md[i]) @ mq[i].mT
                    err = rel_frob(rebuilt[:k, :k], ref[:k, :k])
                    out['recon'] = max(out['recon'], err / gate)
        del mono, swept
    if not (out['dgda'] <= 1 and out['recon'] <= 1 and out['orth'] < 1e-3):
        fail(f'{label}: a sweep of {n_shards} shards vs one monolithic '
             f'refresh on frozen factors: worst dgda {out["dgda"]:.3f} and '
             f'q diag(d) q^T {out["recon"]:.3f} of the eigen gate, '
             f'|Q^T Q - I| {out["orth"]:.3e}')
    return out


def rn50_stagger_resume(torch, kt):
    """Phase 14's checkpoint: a staggered run saved after step
    ``RN50_STAGGER_SAVE`` (model, SGD with momentum, the preconditioner's
    state, through ``torch.save``) and continued to
    ``RN50_STAGGER_RESUME_TO`` twice: by the same objects after
    ``load_state_dict`` in place, and by fresh objects from the
    checkpoint.  A restore recomputes every slot from the saved factors
    (the JAX restore invariant), so both resume on the shard cadence
    from the same state and must end bitwise equal; cuDNN is held to
    its deterministic algorithms.  Returns ``(max abs diff, the two
    cadences after the restore)``."""
    import io

    import torch.nn.functional as F

    x, y = rn50_batch(torch)

    def build():
        model = kt.models.resnet50(device=DEVICE, seed=0)
        opt = torch.optim.SGD(model.parameters(), lr=RN50_STAGGER_HP['lr'],
                              momentum=0.9)
        precond = kt.KFACPreconditioner(model, stagger_refresh=RN50_STAGGER,
                                        **RN50_STAGGER_HP)
        return model, opt, precond

    def steps(model, opt, precond, start, stop):
        acts = []
        for _ in range(start, stop):
            opt.zero_grad()
            F.cross_entropy(model(x), y).backward()
            precond.step()
            opt.step()
            acts.append(precond.last_refresh)
        return acts

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        model, opt, precond = build()
        steps(model, opt, precond, 0, RN50_STAGGER_SAVE + 1)
        buf = io.BytesIO()
        torch.save({'model': model.state_dict(), 'opt': opt.state_dict(),
                    'kfac': precond.state_dict()}, buf)
        buf.seek(0)
        ckpt = torch.load(buf, map_location=DEVICE)
        precond.load_state_dict(ckpt['kfac'])
        cadences = [steps(model, opt, precond, RN50_STAGGER_SAVE + 1,
                          RN50_STAGGER_RESUME_TO + 1)]
        ref = [p.detach().clone() for p in model.parameters()]
        del model, opt, precond
        model, opt, precond = build()
        model.load_state_dict(ckpt['model'])
        opt.load_state_dict(ckpt['opt'])
        precond.load_state_dict(ckpt['kfac'])
        cadences.append(steps(model, opt, precond, precond.steps,
                              RN50_STAGGER_RESUME_TO + 1))
        got = [p.detach() for p in model.parameters()]
        diff = max(float((a - b).abs().max()) for a, b in zip(ref, got))
        equal = all(torch.equal(a, b) for a, b in zip(ref, got))
        del model, opt, precond, ckpt, ref, got
    finally:
        torch.backends.cudnn.deterministic = deterministic
    want = stagger_cadence(RN50_STAGGER_RESUME_TO + 1, 10, RN50_STAGGER)[
        RN50_STAGGER_SAVE + 1:]
    if not (equal and cadences == [want, want]):
        fail(f'resnet50 stagger resume: steps {RN50_STAGGER_SAVE + 1}-'
             f'{RN50_STAGGER_RESUME_TO} from the step-{RN50_STAGGER_SAVE} '
             f'checkpoint: bitwise {equal} (max abs diff {diff:.3e}), '
             f'cadences {cadences}, expected {want}')
    return diff, cadences


def phase_resnet50_stagger(torch, kt):
    """Phase 14: ResNet-50 on phase 9's batch with ``stagger_refresh=
    RN50_STAGGER`` (factor 1, inv 10), ``RN50_STAGGER_STEPS`` steps, then
    the same steps monolithic.  Gates: the cadence (the bootstrap at 0,
    then shard ``s % 10`` at every phase below 5, never a monolithic
    refresh again), 21 kernel launches a step, finite falling losses,
    the shard-0 step against a plain rerun, a shard sweep on frozen
    factors against one monolithic refresh (:func:`stagger_sweep_check`),
    and the resume (:func:`rn50_stagger_resume`).  Prints per-step
    p50/p95/max of both modes, every shard refresh's time and the plan's
    costs.  Returns the staggered run's launches."""
    label = (f'resnet50 stagger: batch {RN50_BATCH} at {RN50_IMAGE}x'
             f'{RN50_IMAGE}, stagger_refresh={RN50_STAGGER}')
    actions, shard_ev = [], []

    def on_precond(precond):
        recorded_steps(precond, actions)
        real = precond._refresh_shard

        def timed(damping, shard):
            s_ev = torch.cuda.Event(enable_timing=True)
            e_ev = torch.cuda.Event(enable_timing=True)
            s_ev.record()
            out = real(damping, shard)
            e_ev.record()
            shard_ev.append((precond.steps, shard, s_ev, e_ev))
            return out
        precond._refresh_shard = timed

    model = kt.models.resnet50(device=DEVICE, seed=0)
    run = train_path(torch, kt, label, model, rn50_fwd_bwd(torch, model),
                     RN50_STAGGER_HP, RN50_STAGGER_STEPS,
                     check_step=RN50_STAGGER_CHECK, momentum=0.9,
                     on_precond=on_precond, stagger_refresh=RN50_STAGGER)
    precond = run['precond']
    want = stagger_cadence(RN50_STAGGER_STEPS, 10, RN50_STAGGER)
    if actions != want:
        fail(f'{label}: refreshes per step {actions}, expected {want}')
    report_path(label, run, RN50_STAGGER_STEPS,
                '; factor steps and shard refreshes included')
    stagger = precond.stagger
    print(f'{label}: plan: {stagger.n_shards} shards, costs (sum of '
          f'a_pad^3 + g_pad^3) {[int(c) for c in stagger.costs]}, largest '
          f'/ total {max(stagger.costs) / sum(stagger.costs):.4f}; slots '
          + '; '.join(f'shard {k}: ' + ', '.join(
              f'{key}{list(v)}' for key, v in sh.items())
              for k, sh in enumerate(stagger.shards)), flush=True)
    by_shard: dict[int, list] = {}
    for step, shard, s_ev, e_ev in shard_ev:
        by_shard.setdefault(shard, []).append(
            (step, s_ev.elapsed_time(e_ev)))
    print(f'{label}: monolithic bootstrap {run["refresh_ms"][0]:.2f} ms; '
          'shard refreshes (step: ms) '
          + '; '.join(f'shard {k}: ' + ', '.join(
              f'{st}: {ms:.2f}' for st, ms in v)
              for k, v in sorted(by_shard.items())), flush=True)
    stag_spread = step_spread(run['step_s'][1:])
    sweep = stagger_sweep_check(torch, kt, precond, label)
    launches = run['launches']
    del run, precond, model
    gc.collect()
    torch.cuda.empty_cache()

    mono_label = f'resnet50 monolithic (phase 14): inv 10'
    model = kt.models.resnet50(device=DEVICE, seed=0)
    mono = train_path(torch, kt, mono_label, model,
                      rn50_fwd_bwd(torch, model), RN50_STAGGER_HP,
                      RN50_STAGGER_STEPS, momentum=0.9)
    mono_spread = step_spread(mono['step_s'][1:])
    print(f'{mono_label}: refreshes '
          f'{[round(t, 2) for t in mono["refresh_ms"]]} ms; launches '
          f'{mono["launches"]}', flush=True)
    RN50_STAGGER_TIMES.update(
        mono=mono_spread, stagger=stag_spread, shards=by_shard,
        mono_refresh=[round(t, 2) for t in mono['refresh_ms']])
    del mono, model
    gc.collect()
    torch.cuda.empty_cache()
    for name, (p50, p95, mx) in (('staggered', stag_spread),
                                 ('monolithic', mono_spread)):
        print(f'resnet50 stagger: {name} steps 1-{RN50_STAGGER_STEPS - 1} '
              f'(host clock, synchronized): p50 {p50:.4f} ms, p95 '
              f'{p95:.4f} ms, max {mx:.4f} ms, max/p50 {mx / p50:.3f}',
              flush=True)
    print(f'resnet50 stagger: sweep of {RN50_STAGGER} shards vs one '
          'monolithic refresh on frozen factors: worst dgda '
          f'{sweep["dgda"]:.3f} and q diag(d) q^T {sweep["recon"]:.3f} of '
          f'the eigen gate max(1e-4, 4 n eps); |Q^T Q - I| max '
          f'{sweep["orth"]:.3e}', flush=True)
    diff, cadences = rn50_stagger_resume(torch, kt)
    print(f'resnet50 stagger resume: steps {RN50_STAGGER_SAVE + 1}-'
          f'{RN50_STAGGER_RESUME_TO} from the step-{RN50_STAGGER_SAVE} '
          'checkpoint by fresh objects end bitwise equal to the same run '
          f'restored in place (max abs diff {diff:.1e}); refreshes after '
          f'the restore {cadences[1]} (the restore recomputed every slot, '
          'so the shard cadence resumes with no monolithic refresh)',
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def adaptive_invariants(events, inv, floor):
    """The controller's contracts on its own event log: at most one
    refresh per shard per interval, and every age at decision time at
    most ``floor - 1``.  Returns the violations."""
    bad, seen = [], set()
    for step, kind, shard, age in events:
        if kind == 'full':
            continue
        if age > floor - 1:
            bad.append((step, kind, shard, age, 'age'))
        if shard is not None:
            if (step // inv, shard) in seen:
                bad.append((step, kind, shard, age, 'budget'))
            seen.add((step // inv, shard))
    return bad


def phase_resnet50_adaptive(torch, kt):
    """Phase 15: phase 14's configuration with ``adaptive=
    AdaptiveRefreshConfig(**RN50_ADAPTIVE)``, ``RN50_ADAPTIVE_STEPS``
    steps, twice (cuDNN held to its deterministic algorithms).  Gates
    from the controller's events: at most one refresh per shard per
    interval, every age at decision time at most ``3 * 10 - 1``, the
    rerun's decisions identical; 21 kernel launches a step; finite
    falling losses.  Prints the counters and the host reads of the drift
    per factor step.  Returns the first run's launches."""
    inv = RN50_STAGGER_HP['inv_update_steps']
    floor = RN50_ADAPTIVE['staleness_factor'] * inv
    runs = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for attempt in range(2):
            label = (f'resnet50 adaptive (run {attempt + 1}): '
                     f'stagger_refresh={RN50_STAGGER}, {RN50_ADAPTIVE}')
            model = kt.models.resnet50(device=DEVICE, seed=0)
            run = train_path(
                torch, kt, label, model, rn50_fwd_bwd(torch, model),
                RN50_STAGGER_HP, RN50_ADAPTIVE_STEPS, momentum=0.9,
                stagger_refresh=RN50_STAGGER,
                adaptive=kt.AdaptiveRefreshConfig(**RN50_ADAPTIVE),
            )
            precond = run['precond']
            ctl = precond.adaptive_controller
            if attempt == 0:
                report_path(label, run, RN50_ADAPTIVE_STEPS,
                            '; factor steps and refreshes included')
            runs.append(dict(events=list(ctl.events),
                             counters=ctl.counters(),
                             syncs=precond.adaptive_host_syncs,
                             launches=run['launches'],
                             refresh_ms=run['refresh_ms']))
            del run, precond, model, ctl
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    first = runs[0]
    bad = adaptive_invariants(first['events'], inv, floor)
    if bad:
        fail(f'resnet50 adaptive: contract violations {bad}')
    if runs[1]['events'] != first['events']:
        fail(f'resnet50 adaptive: the rerun decided {runs[1]["events"]}, '
             f'the first run {first["events"]}')
    ages = [age for _, kind, _, age in first['events'] if kind != 'full']
    print(f'resnet50 adaptive: counters {first["counters"]}; decisions '
          f'(step, kind, shard, max age) {first["events"]}; the largest '
          f'age at a decision {max(ages)} (floor {floor}, gate '
          f'<= {floor - 1}); at most one refresh per shard per interval; '
          'the rerun decided identically; host reads of the drift '
          f'{first["syncs"]} over {RN50_ADAPTIVE_STEPS} factor steps '
          f'({first["syncs"] / RN50_ADAPTIVE_STEPS:.3f} per factor step)',
          flush=True)
    return first['launches']


#: Phase 16: ResNet-50 with ``overlap_comm=True`` on phase 9's batch.  The
#: shift check freezes the weights (no optimizer step: the same weights
#: and batch every step, as JAX's ``run_pair``), factor 1, inv 5; the
#: training runs take phase 14's configuration (factor 1, inv 10, SGD
#: with momentum 0.9), 22 steps (cut from 32 for phases 24-25), monolithic and at
#: ``stagger_refresh=5``.
RN50_SHIFT_HP = dict(RN50_HP, factor_update_steps=1, inv_update_steps=5)
RN50_SHIFT_STEPS = 12
RN50_OVERLAP_STEPS = 22
#: The staggered run is saved after this step (shard 2, due at step 12,
#: pending) and restored by fresh objects.
RN50_OVERLAP_SAVE = 12
#: Without a recompute the restored run's next due refresh is the
#: monolithic one at step 20, in band.
RN50_OVERLAP_INBAND = 20
#: Phase 14's numbers of this run (step spreads, shard refresh ms, the
#: monolithic refreshes), printed beside phase 16's.
RN50_STAGGER_TIMES: dict = {}


def main_stream_sync(torch):
    """Wait for the current stream only: a device-wide synchronize would
    also wait for the deferred refresh's side stream and take the
    overlap away."""
    if DEVICE == 'cuda':
        torch.cuda.current_stream().synchronize()


def overlap_cadence(sync):
    """The refreshes of an ``overlap_comm`` run whose synchronous run
    refreshes ``sync``: the bootstrap (step 0) in band, every later
    refresh reported one step late as ``overlap_inv`` /
    ``overlap_shard<k>``."""
    out = []
    for s in range(len(sync)):
        prev = sync[s - 1] if s > 1 else None
        if s == 0:
            out.append(sync[0])
        elif prev == 'full':
            out.append('overlap_inv')
        elif isinstance(prev, int):
            out.append(f'overlap_shard{prev}')
        else:
            out.append(None)
    return out


def rn50_overlap_shift(torch, kt):
    """The one-step shift on frozen weights: a synchronous and an
    ``overlap_comm`` preconditioner, each on its own ResNet-50 from the
    same seed, step side by side on the same batch with no optimizer
    step (cuDNN held to its deterministic algorithms).  Gates: after
    every step ``t >= 1`` the overlap run's stacks equal the synchronous
    run's after ``t - 1`` bitwise; the preconditioned gradients bitwise
    equal off the refresh-due steps and different on them; the factor
    EMAs equal; the cadences.  Returns the line's facts."""
    import torch.nn.functional as F

    x, y = rn50_batch(torch)
    runs = []
    for overlap in (False, True):
        model = kt.models.resnet50(device=DEVICE, seed=0)
        runs.append((model, kt.KFACPreconditioner(
            model, overlap_comm=overlap, **RN50_SHIFT_HP)))
    inv = RN50_SHIFT_HP['inv_update_steps']
    prev, worst, problems, actions = None, 0.0, [], ([], [])
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for t in range(RN50_SHIFT_STEPS):
            grads = []
            for (model, precond), acts in zip(runs, actions):
                model.zero_grad()
                F.cross_entropy(model(x), y).backward()
                precond.step()
                acts.append(precond.last_refresh)
                grads.append([p.grad for p in model.parameters()])
            (_, sync), (_, over) = runs
            same = all(torch.equal(a, b) for a, b in zip(*grads))
            due = t > 0 and t % inv == 0
            if same == due:
                problems.append(f'step {t}: grads equal {same}, due {due}')
            for n, st in sync.layers.items():
                o = over.layers[n]
                if not (torch.equal(st.a_factor, o.a_factor)
                        and torch.equal(st.g_factor, o.g_factor)):
                    problems.append(f'step {t}: factors of {n} differ')
            if prev is not None:
                for key, fields in prev.items():
                    got = over.buckets[key].tensors()
                    for f, want in fields.items():
                        if not torch.equal(got[f], want):
                            worst = max(worst, rel_frob(got[f], want))
                            problems.append(f'step {t}: {key}.{f} is not '
                                            f'the synchronous step {t - 1}\'s')
            prev = {k: {f: v.clone() for f, v in bs.tensors().items()}
                    for k, bs in sync.buckets.items()}
        runs[1][1].join_deferred_refresh()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    want = ['full' if s % inv == 0 else None for s in range(RN50_SHIFT_STEPS)]
    if actions[0] != want or actions[1] != overlap_cadence(want):
        problems.append(f'cadences {actions}')
    if problems:
        fail(f'resnet50 overlap shift: {problems[:6]} ({len(problems)} in '
             f'all; worst bucket rel err {worst:.3e}, eigen gate at 4608 '
             f'{eigen_gate(4608):.3e})')
    del runs, prev
    gc.collect()
    return actions


def interval_union(spans):
    """Sorted, merged ``[start, end)`` spans."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def intersect_len(a, b) -> float:
    """Total length of the intersection of two merged span lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def side_stream_concurrency(torch, prof):
    """From one profiler window: ``(side-stream device ms, ms of it that
    ran while a kernel or copy of another stream ran)``, the side stream
    found by the ``spin_kernel`` marker the deferred refresh launched
    first; ``None`` when the window holds no marker (the profiler
    delivered no activity for it)."""
    acts = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    marker = [e for e in acts if 'spin_kernel' in e.name]
    if not marker:
        return None
    side = marker[0].device_resource_id
    mine = interval_union([(e.time_range.start, e.time_range.end)
                           for e in acts if e.device_resource_id == side])
    other = interval_union([(e.time_range.start, e.time_range.end)
                            for e in acts if e.device_resource_id != side])
    busy = sum(e - s for s, e in mine)
    return busy / 1e3, intersect_len(mine, other) / 1e3


def overlap_train(torch, kt, label, steps, profile_at=(), save=None,
                  **kfac_kw):
    """``steps`` steps of ResNet-50 with ``overlap_comm=True`` in phase
    14's configuration, as a user runs them; each step's host time ends
    with the current stream synchronized.  The deferred refreshes' device
    times come from CUDA events on the side stream (around the worker's
    ``_refresh_state``); with ``profile_at`` (due steps ``R``) steps ``R``
    and ``R + 1`` run under ``torch.profiler`` and each window's
    side-stream concurrency is measured; ``save = (step, fn)`` calls
    ``fn(precond, model, opt)`` after that step.  Gates: finite falling
    losses, 21 launches a step."""
    import threading

    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    x, y = rn50_batch(torch)
    model = kt.models.resnet50(device=DEVICE, seed=0)
    precond = kt.KFACPreconditioner(model, overlap_comm=True,
                                    **RN50_STAGGER_HP, **kfac_kw)
    opt = torch.optim.SGD(model.parameters(), lr=RN50_STAGGER_HP['lr'],
                          momentum=0.9)
    deferred_ev = []
    real = precond._refresh_state

    def timed_state(*args):
        if threading.current_thread() is threading.main_thread():
            return real(*args)  # the in-band bootstrap
        if DEVICE == 'cuda' and profile_at:
            torch.cuda._sleep(1000)  # the side stream's marker
        s_ev = torch.cuda.Event(enable_timing=True)
        e_ev = torch.cuda.Event(enable_timing=True)
        s_ev.record()
        out = real(*args)
        e_ev.record()
        deferred_ev.append((precond.steps - 1, args[3], s_ev, e_ev))
        return out
    precond._refresh_state = timed_state
    run = dict(losses=[], step_s=[], actions=[], windows={})
    gc.collect()
    torch.cuda.synchronize()
    kt.ops.fused_eigen_precondition.launches = 0
    prof = None
    for step in range(steps):
        if step in profile_at:
            # Device activity only (host events would slow the window's
            # parse by seconds); the CPU rehearsal has none to record.
            prof = profile(activities=[ProfilerActivity.CUDA]
                           if DEVICE == 'cuda' else [ProfilerActivity.CPU])
            prof.__enter__()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        precond.step()
        opt.step()
        main_stream_sync(torch)
        run['step_s'].append(time.perf_counter() - t0)
        run['losses'].append(float(loss.detach()))
        run['actions'].append(precond.last_refresh)
        if save is not None and step == save[0]:
            save[1](precond, model, opt)
        if prof is not None and step - 1 in profile_at:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            run['windows'][step - 1] = side_stream_concurrency(torch, prof)
            prof = None
    run['launches'] = kt.ops.fused_eigen_precondition.launches
    precond.join_deferred_refresh()
    torch.cuda.synchronize()
    run['deferred_ms'] = [(step, shard, s.elapsed_time(e))
                          for step, shard, s, e in deferred_ev]
    losses = run['losses']
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f'{label}: losses {losses}')
    n_buckets = kernel_buckets(precond)
    if run['launches'] != steps * n_buckets:
        fail(f'{label}: kernel launched {run["launches"]} times in {steps} '
             f'steps, expected {steps * n_buckets}')
    run['precond'], run['model'], run['opt'] = precond, model, opt
    return run


def rn50_overlap_restore(torch, kt, run):
    """The staggered overlap run's state after step ``RN50_OVERLAP_SAVE``
    (shard 2 pending) restored by fresh objects: the pending refresh is
    dropped.  With the recompute the shard cadence resumes deferred
    (shard 3, due at 13, installed at 14); without it the next due
    refresh is the monolithic bootstrap at ``RN50_OVERLAP_INBAND``, in
    band.  Returns both cadences."""
    import torch.nn.functional as F

    x, y = rn50_batch(torch)
    ckpt = run['ckpt']
    out = {}
    for recompute in (True, False):
        model = kt.models.resnet50(device=DEVICE, seed=0)
        model.load_state_dict(ckpt['model'])
        opt = torch.optim.SGD(model.parameters(), lr=RN50_STAGGER_HP['lr'],
                              momentum=0.9)
        opt.load_state_dict(ckpt['opt'])
        precond = kt.KFACPreconditioner(
            model, overlap_comm=True, stagger_refresh=RN50_STAGGER,
            **RN50_STAGGER_HP)
        precond.load_state_dict(ckpt['kfac'], compute_inverses=recompute)
        if precond.overlap_pending is not None:
            fail('resnet50 overlap restore: a pending refresh survived')
        stop = 15 if recompute else RN50_OVERLAP_INBAND + 1
        acts = []
        for _ in range(RN50_OVERLAP_SAVE + 1, stop):
            opt.zero_grad()
            F.cross_entropy(model(x), y).backward()
            precond.step()
            opt.step()
            acts.append(precond.last_refresh)
        precond.join_deferred_refresh()
        out[recompute] = acts
        del model, opt, precond
    want = {True: [None, 'overlap_shard3'],
            False: [None] * (RN50_OVERLAP_INBAND - RN50_OVERLAP_SAVE - 1)
            + ['full']}
    if out != want:
        fail(f'resnet50 overlap restore: refreshes after the restore {out}, '
             f'expected {want}')
    return out


def phase_resnet50_overlap(torch, kt):
    """Phase 16: ResNet-50 with ``overlap_comm=True``.  The shift check on
    frozen weights (:func:`rn50_overlap_shift`); a monolithic training run
    (factor 1, inv 10, 22 steps: the bootstrap in band at 0, the refreshes
    due at 10 and 20 installed at 11 and 21), timed, then the
    same run again under ``torch.profiler`` around each deferred refresh
    for its side-stream concurrency; a staggered one (``stagger_refresh=
    5``: each shard one step after its due step), whose state after step
    12 is restored by fresh objects (:func:`rn50_overlap_restore`).
    Gates: the cadences, 21 launches a step, finite falling losses.
    Prints the step p50/p95/max beside phase 14's synchronous runs and
    each deferred refresh's device time beside phase 14's.  Returns the
    timed monolithic run's launches."""
    import io

    shift = rn50_overlap_shift(torch, kt)
    print(f'resnet50 overlap shift (frozen weights, factor 1, inv 5, '
          f'{RN50_SHIFT_STEPS} steps, cuDNN deterministic): after every step '
          't >= 1 the overlap stacks equal the synchronous stacks of step '
          't - 1 bitwise; preconditioned gradients bitwise equal off the '
          'due steps and different on them; factor EMAs bitwise equal; '
          f'refreshes sync {shift[0]}, overlap {shift[1]}', flush=True)
    sync = ['full' if s % 10 == 0 else None for s in range(RN50_OVERLAP_STEPS)]
    label = 'resnet50 overlap monolithic (factor 1, inv 10)'
    mono = overlap_train(torch, kt, label, RN50_OVERLAP_STEPS)
    want = overlap_cadence(sync)
    if mono['actions'] != want:
        fail(f'{label}: refreshes {mono["actions"]}, expected {want}')
    launches = mono['launches']
    p50, p95, mx = step_spread(mono['step_s'][1:])
    ref = RN50_STAGGER_TIMES.get('mono')
    print(f'{label}: losses {mono["losses"][0]:.6f} -> '
          f'{mono["losses"][-1]:.6f}; refreshes {mono["actions"]}; '
          f'launches {launches} (21 x {RN50_OVERLAP_STEPS}); steps 1-'
          f'{RN50_OVERLAP_STEPS - 1} (host clock, current stream '
          f'synchronized): p50 {p50:.4f} ms, p95 {p95:.4f} ms, max '
          f'{mx:.4f} ms'
          + (' against phase 14\'s synchronous monolithic run (steps 1-30) '
             '{:.4f} / {:.4f} / {:.4f} ms'.format(*ref) if ref else '')
          + '; the steps that install a refresh: '
          + ', '.join(f'{s}: {mono["step_s"][s] * 1e3:.2f} ms'
                      for s in (11, 21, 31) if s < RN50_OVERLAP_STEPS)
          + '; the deferred refreshes on the side stream (issued at the end '
          'of step: device ms) '
          + ', '.join(f'{s}: {ms:.2f}' for s, _, ms in mono['deferred_ms'])
          + (f' (phase 14\'s in-band refreshes '
             f'{RN50_STAGGER_TIMES["mono_refresh"]} ms)'
             if 'mono_refresh' in RN50_STAGGER_TIMES else ''), flush=True)
    del mono
    gc.collect()
    torch.cuda.empty_cache()
    prof = overlap_train(torch, kt, f'{label}, profiled', RN50_OVERLAP_STEPS,
                         profile_at=(10, 20))
    parts = []
    for due, found in sorted(prof['windows'].items()):
        if found is None:
            parts.append(f'due {due}: not measured (the profiler delivered '
                         'no side-stream activity)')
            continue
        busy, conc = found
        parts.append(f'due {due}: side-stream device time {busy:.2f} ms, of '
                     f'which {conc:.2f} ms ({conc / busy:.3f}) ran while '
                     'another stream ran')
    print(f'{label}: torch.profiler around steps R and R+1 of each deferred '
          'refresh: ' + '; '.join(parts), flush=True)
    del prof
    gc.collect()
    torch.cuda.empty_cache()

    label = f'resnet50 overlap stagger_refresh={RN50_STAGGER}'
    ckpt = {}

    def save_at(precond, model, opt):
        buf = io.BytesIO()
        torch.save({'model': model.state_dict(), 'opt': opt.state_dict(),
                    'kfac': precond.state_dict()}, buf)
        buf.seek(0)
        ckpt.update(torch.load(buf, map_location=DEVICE))

    stag = overlap_train(torch, kt, label, RN50_OVERLAP_STEPS,
                         stagger_refresh=RN50_STAGGER,
                         save=(RN50_OVERLAP_SAVE, save_at))
    want = overlap_cadence(stagger_cadence(RN50_OVERLAP_STEPS, 10,
                                           RN50_STAGGER))
    if stag['actions'] != want:
        fail(f'{label}: refreshes {stag["actions"]}, expected {want}')
    launches_stag = stag['launches']
    p50, p95, mx = step_spread(stag['step_s'][1:])
    ref = RN50_STAGGER_TIMES.get('stagger')
    by_shard: dict[int, list] = {}
    for step, shard, ms in stag['deferred_ms']:
        by_shard.setdefault(shard, []).append((step, ms))
    ref_shards = RN50_STAGGER_TIMES.get('shards', {})
    print(f'{label}: losses {stag["losses"][0]:.6f} -> '
          f'{stag["losses"][-1]:.6f}; refreshes {stag["actions"]}; launches '
          f'{launches_stag}; steps 1-{RN50_OVERLAP_STEPS - 1} p50 '
          f'{p50:.4f} ms, p95 {p95:.4f} ms, '
          f'max {mx:.4f} ms'
          + (' against phase 14\'s synchronous staggered run '
             '{:.4f} / {:.4f} / {:.4f} ms'.format(*ref) if ref else '')
          + '; deferred shard refreshes on the side stream (due step: device '
          'ms) ' + '; '.join(
              f'shard {k}: ' + ', '.join(f'{s}: {ms:.2f}' for s, ms in v)
              + (' (phase 14 in band: ' + ', '.join(
                  f'{s}: {ms:.2f}' for s, ms in ref_shards[k]) + ')'
                 if k in ref_shards else '')
              for k, v in sorted(by_shard.items())), flush=True)
    stag['ckpt'] = ckpt
    del stag['precond'], stag['model'], stag['opt']
    gc.collect()
    torch.cuda.empty_cache()
    restored = rn50_overlap_restore(torch, kt, stag)
    print(f'resnet50 overlap restore: the state after step '
          f'{RN50_OVERLAP_SAVE} (shard 2 pending) restored by fresh objects '
          'drops the pending refresh; with the recompute the refreshes of '
          f'steps {RN50_OVERLAP_SAVE + 1}-14 are {restored[True]} (the shard '
          'cadence resumes deferred), without it steps '
          f'{RN50_OVERLAP_SAVE + 1}-{RN50_OVERLAP_INBAND} are '
          f'{restored[False]} (the next due refresh in band)', flush=True)
    del stag
    gc.collect()
    torch.cuda.empty_cache()
    return launches


#: Phase 17: ResNet-50 at world 4 on one card over gloo (phase 5's
#: spawn), 8 images per rank (global batch 32 at 224x224), factor 10,
#: inv 100, ``RN50_PIPE_STEPS`` steps with the synchronous tail and then
#: with ``pipeline_grads=True`` under each strategy; then one pass of
#: ``RN50_PIPE_OVERLAP_STEPS`` steps with ``overlap_comm`` and
#: ``pipeline_grads`` together under HYBRID-OPT at factor 5, inv 5 (the
#: refresh due at 5 installed at 6).  The steps are cut (7, from 11 when
#: phases 20 and 21 came, then 4 when phases 24 and 25 came: the factor
#: step 0 and three steps on its factors; the overlap pass to 7, factor
#: steps every fifth) to keep the phase near a minute; the widths are
#: ResNet-50's.
RN50_PIPE_STEPS = 4
RN50_PIPE_OVERLAP_STEPS = 7
RN50_PIPE_STRATEGIES = ('HYBRID_OPT', 'MEM_OPT')
RN50_PIPE_OVERLAP_HP = dict(RN50_HP, factor_update_steps=5,
                            inv_update_steps=5)
RN50_PIPE_TIMEOUT_S = 600
#: The model of phase 17 and its classes (the CPU rehearsal may take a
#: smaller one).
PIPE_MODEL = ('resnet50', 1000)


def pipeline_rank(rank, world, backend, device_type, workdir, image, batch,
                  model_name):
    """One rank of phase 17; writes ``pipe{rank}.pt`` to ``workdir`` and
    raises on a failed check.  ``device_type`` is ``'cuda'`` on the card
    (``'cpu'`` rehearses the phase at the given ``image``, ``batch`` and
    ``model_name = (name, classes)``)."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    import kfac_pytorch_tpu_torch as kt

    if device_type == 'cuda':
        dev = torch.device(
            'cuda',
            rank % torch.cuda.device_count() if backend == 'nccl' else 0,
        )
        torch.cuda.set_device(dev)
        sync = torch.cuda.synchronize
    else:
        dev = torch.device('cpu')

        def sync(device=None):
            pass
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # Both tails must see the same forward and backward bits.
    torch.backends.cudnn.deterministic = True
    dist.init_process_group(
        backend, init_method=f'file://{workdir}/pg_init', rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=300),
    )
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    x = torch.randn(batch, 3, image, image, generator=gen, device=dev)
    y = torch.randint(0, model_name[1], (batch,), generator=gen,
                      device=dev)
    q = batch // world
    xl, yl = x[rank * q:(rank + 1) * q], y[rank * q:(rank + 1) * q]
    fused = kt.ops.fused_eigen_precondition

    def checksum(flat):
        """Exact and order-free: the int64 sum of the f32 bit patterns."""
        return flat.view(torch.int32).to(torch.int64).sum()

    def run(strategy, hp, ref=None, steps=RN50_PIPE_STEPS, **kfac_kw):
        model = getattr(kt.models, model_name[0])(device=dev, seed=0)
        ddp = torch.nn.parallel.DistributedDataParallel(
            model, device_ids=None if dev.index is None else [dev.index],
        )
        precond = kt.KFACPreconditioner(
            ddp, grad_worker_fraction=kt.DistributedStrategy[strategy],
            **hp, **kfac_kw)
        opt = torch.optim.SGD(model.parameters(), lr=hp['lr'], momentum=0.9)
        tail_s = []
        real = precond._precondition

        def timed(*a):
            sync(dev)
            t0 = time.perf_counter()
            out = real(*a)
            sync(dev)
            tail_s.append(time.perf_counter() - t0)
            return out
        precond._precondition = timed
        out = dict(grads=[], params=[], step_s=[], losses=[], pending=[],
                   actions=[], mismatch=[], ranks_equal=[])
        sync(dev)
        fused.launches = 0
        for step in range(steps):
            t0 = time.perf_counter()
            opt.zero_grad()
            loss = F.cross_entropy(ddp(xl), yl)
            loss.backward()
            precond.step()
            grads = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
            opt.step()
            sync(dev)
            out['step_s'].append(time.perf_counter() - t0)
            out['losses'].append(float(loss.detach()))
            out['pending'].append(precond.overlap_pending)
            out['actions'].append(precond.last_refresh)
            params = torch.cat([p.detach().reshape(-1)
                                for p in model.parameters()])
            if ref is None:
                out['grads'].append(grads)
                out['params'].append(params)
            elif not (torch.equal(grads, ref['grads'][step])
                      and torch.equal(params, ref['params'][step])):
                out['mismatch'].append(step)
            sums = [torch.zeros((), dtype=torch.int64, device=dev)
                    for _ in range(world)]
            dist.all_gather(sums, checksum(params))
            out['ranks_equal'].append(all(bool(s == sums[0]) for s in sums))
        out['launches'] = fused.launches
        precond.join_deferred_refresh()
        every = [torch.empty_like(params) for _ in range(world)]
        dist.all_gather(every, params)
        out['final_equal'] = all(torch.equal(params, o) for o in every)
        out['tail_s'] = tail_s
        out['n_buckets'] = sum(precond._second_order.bucket_prediv(b.key)
                               for b in precond.plan.buckets)
        out['grid'] = (precond.grid.rows, precond.grid.cols)
        out['shards'] = [tuple(precond.buckets[b.key].qa.shape[:1])
                         + (b.g_pad, b.a_pad) for b in precond.plan.buckets]
        out['order'] = precond._second_order.pipeline_order
        del precond, ddp, model, opt, every
        return out

    report = {}
    keep = ('step_s', 'losses', 'pending', 'actions', 'mismatch',
            'ranks_equal', 'launches', 'final_equal', 'tail_s',
            'n_buckets', 'grid', 'shards', 'order')
    for strategy in RN50_PIPE_STRATEGIES:
        ref = run(strategy, RN50_HP)
        pipe = run(strategy, RN50_HP, ref=ref, pipeline_grads=True)
        report[strategy] = {
            'sync': {k: ref[k] for k in keep},
            'pipe': {k: pipe[k] for k in keep},
        }
        del ref, pipe
        if dev.type == 'cuda':
            torch.cuda.empty_cache()
    both = run('HYBRID_OPT', RN50_PIPE_OVERLAP_HP,
               steps=RN50_PIPE_OVERLAP_STEPS, overlap_comm=True,
               pipeline_grads=True)
    report['overlap'] = {k: both[k] for k in keep}
    del both
    torch.save(report, os.path.join(workdir, f'pipe{rank}.pt'))
    dist.barrier()
    dist.destroy_process_group()


def phase_resnet50_pipelined(torch, kt, ranks=None):
    """Phase 17: four ranks of :func:`pipeline_rank` on the card
    (``ranks``: their reports from :func:`spawn_shared`).  Gates,
    per strategy: the pipelined run's preconditioned gradients and
    parameters bitwise equal to the synchronous run's at every step,
    parameters bitwise equal across ranks (a checksum every step, the
    whole vector at the end), the fused kernel launched steps x 21 on
    every rank in both runs, finite falling mean losses; the overlap pass:
    the cadence, identical pending decisions on every rank, a finite
    falling loss.  Prints the tail's time (the precondition stage between
    two synchronizes) and the step medians of both tails, and returns
    ``(launches of the pipelined runs, the kernels-line entry)``, the
    entry timed at rank 0's HYBRID-OPT shard shapes."""
    from kfac_pytorch_tpu_torch.parallel.mesh import default_backend

    world = KAISA_WORLD
    backend = default_backend(world) if DEVICE == 'cuda' else 'gloo'
    print(f'resnet50 pipelined: world {world}, backend {backend}, batch '
          f'{RN50_BATCH // world} per rank at {RN50_IMAGE}x{RN50_IMAGE}; '
          'times are correctness-path times on one shared card, not a '
          'scaling result', flush=True)
    if ranks is None:
        ranks = spawn_alone(torch, '17')
    launches = 0
    n_buckets = ranks[0]['HYBRID_OPT']['sync']['n_buckets']
    if PIPE_MODEL[0] == 'resnet50' and n_buckets != 21:
        fail(f'resnet50 pipelined: {n_buckets} buckets keep dgda, not 21')
    per_step = n_buckets if DEVICE == 'cuda' else 0
    want_n = RN50_PIPE_STEPS * per_step
    for strategy in RN50_PIPE_STRATEGIES:
        stats = {}
        for mode in ('sync', 'pipe'):
            runs = [r[strategy][mode] for r in ranks]
            label = f'resnet50 pipelined {strategy} {mode}'
            for i, r in enumerate(runs):
                if r['mismatch']:
                    fail(f'{label} rank {i}: gradients or parameters differ '
                         f'from the synchronous tail at steps {r["mismatch"]}')
                if not (all(r['ranks_equal']) and r['final_equal']):
                    fail(f'{label} rank {i}: parameters differ across ranks')
                if r['launches'] != want_n:
                    fail(f'{label} rank {i}: {r["launches"]} launches, '
                         f'expected {want_n}')
            losses = [statistics.fmean(v)
                      for v in zip(*(r['losses'] for r in runs))]
            if not (all(map(math.isfinite, losses))
                    and losses[-1] < losses[0]):
                fail(f'{label}: mean losses {losses}')
            if mode == 'pipe':
                launches += sum(r['launches'] for r in runs)
            stats[mode] = dict(
                step=statistics.median(t for r in runs
                                       for t in r['step_s'][1:]) * 1e3,
                tail=statistics.median(t for r in runs
                                       for t in r['tail_s'][1:]) * 1e3,
                losses=losses, grid=runs[0]['grid'],
                order=runs[0]['order'])
        s, p = stats['sync'], stats['pipe']
        print(f'resnet50 pipelined {strategy}: grid {s["grid"]}; issue order '
              f'{list(p["order"])}; gradients and parameters of the '
              f'pipelined tail bitwise equal to the synchronous tail\'s at '
              f'all {RN50_PIPE_STEPS} steps on every rank; parameters bitwise '
              f'equal across ranks; launches {want_n} per rank per run; mean '
              f'loss {p["losses"][0]:.6f} -> {p["losses"][-1]:.6f}; the tail '
              f'(precondition stage between two synchronizes, median of '
              f'steps 1-{RN50_PIPE_STEPS - 1}, all ranks) sync '
              f'{s["tail"]:.4f} ms, pipelined {p["tail"]:.4f} ms '
              f'(pipelined/sync {p["tail"] / s["tail"]:.4f}); median step '
              f'sync {s["step"]:.4f} ms, pipelined {p["step"]:.4f} ms',
              flush=True)
    runs = [r['overlap'] for r in ranks]
    label = 'resnet50 pipelined HYBRID_OPT overlap_comm'
    sync_cadence = ['full' if s % 5 == 0 else None
                    for s in range(RN50_PIPE_OVERLAP_STEPS)]
    for i, r in enumerate(runs):
        if r['pending'] != runs[0]['pending']:
            fail(f'{label}: rank {i} deferred {r["pending"]}, rank 0 '
                 f'{runs[0]["pending"]}')
        if r['actions'] != overlap_cadence(sync_cadence):
            fail(f'{label} rank {i}: refreshes {r["actions"]}')
        if not (all(r['ranks_equal']) and r['final_equal']):
            fail(f'{label} rank {i}: parameters differ across ranks')
        if r['launches'] != RN50_PIPE_OVERLAP_STEPS * per_step:
            fail(f'{label} rank {i}: {r["launches"]} launches')
    losses = [statistics.fmean(v) for v in zip(*(r['losses'] for r in runs))]
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        fail(f'{label}: mean losses {losses}')
    launches += sum(r['launches'] for r in runs)
    step_ms = statistics.median(
        t for r in runs for t in r['step_s'][1:]) * 1e3
    print(f'{label} (factor 5, inv 5): refreshes {runs[0]["actions"]} and '
          f'pending decisions {runs[0]["pending"]} identical on every rank; '
          f'mean loss {losses[0]:.6f} -> {losses[-1]:.6f}; median step '
          f'{step_ms:.4f} ms', flush=True)
    cases = [tuple(c) for c in ranks[0]['HYBRID_OPT']['pipe']['shards']]
    entry = bucket_entry(torch, kt.ops.fused_eigen_precondition,
                         kt.ops.fused_eigen_precondition_reference,
                         'ResNet-50 HYBRID-OPT shards (rank 0)', cases, 900)
    entry.update(
        name='fused_eigen_precondition_sharded_async, ResNet-50 at world 4, '
             'pipelined gradient gather (phase 17)',
        replaces='kfac_pytorch_tpu/ops/pallas_precond.py:151',
        launches=launches)
    return entry


#: Phase 18: EKFAC across the grid (ROADMAP item 10b), ResNet-50 at
#: world 4 on one card over gloo, 8 images a rank, factor 1, inv 2 (cut
#: from inv 5 and 8 steps, then from inv 4 and 6 steps, then from inv 3
#: and 4 steps, then from 3 steps when phases 26 and 27 came, for time);
#: the round trip saves before step ``RN50_GRID_SAVE`` and resumes the
#: last step (``tests/test_torch_ekfac_grid.py`` holds a resume across
#: a later refresh on the grids against JAX).  The save follows the
#: refresh of step 0: a state dict carries the factors, not the bases,
#: and the restore recomputes the bases from them, which gives the saved
#: run's bits only while the factors are those the last refresh
#: decomposed.
RN50_GRID_HP = dict(RN50_HP, factor_update_steps=1, inv_update_steps=2)
RN50_GRID_STEPS = 2
RN50_GRID_SAVE = 1
RN50_GRID_STRATEGIES = ('COMM_OPT', 'HYBRID_OPT', 'MEM_OPT')
#: The EKFAC trajectory tolerance (``tests/test_torch_ekfac.py``).
RN50_GRID_TOL = 1e-4
RN50_GRID_TIMEOUT_S = 600
#: ``(model, classes)`` of phase 18 (a CPU rehearsal takes a smaller one).
GRID_MODEL = ('resnet50', 1000)


def ekfac_design_bytes(torch, kt, batch, image, world, fraction):
    """Counted bytes of the three designs of EKFAC on a grid with
    several columns (``PERF.md`` §6), from the shapes each sends,
    f32 everywhere; ResNet-50's rows per example come from a forward on
    the meta device (no compute).

    ``L``, ``seg``, ``A``, ``G``: a bucket's slots, slots a column,
    padded A and G dims; ``R_l``: a layer's rows on one rank (batch x
    output positions), ``a_l``/``g_l`` its row widths.

    * ``gather_bases`` (chosen): each refresh all-gathers every column's
      ``qa``/``qg`` over the grid row (a rank receives ``(cols - 1) *
      seg * (A^2 + G^2)`` per bucket, a column's padding slots
      included); each factor step all-reduces the ``[G, A]`` scale
      contribution of every layer over the world, as COMM-OPT does (the
      payload; a ring moves ``2 (world - 1) / world`` of it through each
      rank), plus the ``(num, den)`` drift pairs; a rank holds the bases
      of every occupied slot, padding dropped after the gather.
    * ``rows_to_column``: each factor step every rank sends its rows
      ``R_l (a_l + g_l)`` of each layer to every rank of the layer's
      column (an all-to-all), whose ranks then project all ``world``
      ranks' rows themselves; nothing moves at a refresh; a rank holds
      its column's bases and, in flight, the rows of its column's
      layers from every rank.
    * ``project_at_owner``: each factor step every rank sends its rows
      of each layer to the one rank of the layer's column in its own
      grid row, which projects them; the column's ranks then all-reduce
      the ``[G, A]`` contributions of their layers over the column.
      Under MEM-OPT (one rank a column) it is ``rows_to_column``.

    Returns per design ``{'factor_step': bytes a rank receives (the
    largest over ranks), 'refresh': ..., 'held': second-order bytes a
    rank holds (the largest), 'in_flight': transient receive buffers}``.
    """
    from kfac_pytorch_tpu_torch.capture import ModelCapture
    from kfac_pytorch_tpu_torch.parallel.bucketing import make_bucket_plan
    from kfac_pytorch_tpu_torch.parallel.mesh import grid_shape

    model = kt.models.resnet50(device='cpu', seed=0).to('meta').eval()
    cap = ModelCapture(model)
    positions = {}
    hooks = [h.module.register_forward_hook(
        lambda m, i, o, n=n: positions.__setitem__(
            n, math.prod(o.shape[2:]) if o.ndim == 4 else 1))
        for n, h in cap.helpers.items()]
    model(torch.empty(1, 3, image, image, device='meta'))
    for h in hooks:
        h.remove()
    rows, cols = grid_shape(world, fraction)
    plan = make_bucket_plan(cap.helpers, n_cols=cols)
    f32 = 4
    dims = {n: (h.a_factor_shape[0], h.g_factor_shape[0])
            for n, h in cap.helpers.items()}
    row_bytes = {n: batch * positions[n] * (a + g) * f32
                 for n, (a, g) in dims.items()}
    contrib = {}
    for b in plan.buckets:
        for n in b.slots:
            if n is not None:
                contrib[n] = b.g_pad * b.a_pad * f32
    column = [[] for _ in range(cols)]  # layers of each column
    col_state = [0] * cols  # qa, qg, da, dg, skron of a column's slots
    sent = kept = 0  # bases on the wire (padding too) and held
    for b in plan.buckets:
        per = (b.a_pad ** 2 + b.g_pad ** 2 + b.a_pad + b.g_pad
               + b.g_pad * b.a_pad) * f32
        square = (b.a_pad ** 2 + b.g_pad ** 2) * f32
        sent += b.n_slots * square
        kept += sum(n is not None for n in b.slots) * square
        for c in range(cols):
            col_state[c] += b.seg * per
            column[c] += [n for n in b.column_slots(c) if n is not None]
    gather = {}
    payload = sum(contrib.values())
    ring = 2 * (world - 1) / world
    n_buckets = len(plan.buckets)
    gather['factor_step'] = ring * payload + (
        (cols - 1) * n_buckets * 2 * f32 if cols > 1 else 0)
    gather['refresh'] = (cols - 1) / cols * sent
    gather['held'] = max(col_state) + (kept if cols > 1 else 0)
    gather['in_flight'] = 0
    gather['payload'] = payload
    to_col = {}
    recv = [sum((world - 1) * row_bytes[n] for n in column[c])
            for c in range(cols)]
    to_col['factor_step'] = max(recv)
    to_col['refresh'] = 0
    to_col['held'] = max(col_state)
    to_col['in_flight'] = max(recv[c] + sum(row_bytes[n] for n in column[c])
                              for c in range(cols))
    owner = {}
    recv = [sum((cols - 1) * row_bytes[n] for n in column[c])
            for c in range(cols)]
    reduce = [(2 * (rows - 1) / rows) * sum(contrib[n] for n in column[c])
              for c in range(cols)]
    owner['factor_step'] = max(r + s for r, s in zip(recv, reduce))
    owner['refresh'] = 0
    owner['held'] = max(col_state)
    owner['in_flight'] = max(recv[c] + sum(row_bytes[n] for n in column[c])
                             for c in range(cols))
    return {'grid': (rows, cols), 'gather_bases': gather,
            'rows_to_column': to_col, 'project_at_owner': owner}


def ekfac_grid_rank(rank, world, backend, device_type, workdir, image,
                    batch, model_name):
    """One rank of phase 18; writes ``grid{rank}.pt`` to ``workdir``.
    ``device_type`` ``'cpu'`` rehearses the phase at the given ``image``,
    ``batch`` and ``model_name = (name, classes)``."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    import kfac_pytorch_tpu_torch as kt

    if device_type == 'cuda':
        dev = torch.device(
            'cuda',
            rank % torch.cuda.device_count() if backend == 'nccl' else 0,
        )
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    else:
        dev = torch.device('cpu')
    dist.init_process_group(
        backend, init_method=f'file://{workdir}/pg_init', rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=300),
    )
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    x = torch.randn(batch, 3, image, image, generator=gen, device=dev)
    y = torch.randint(0, model_name[1], (batch,), generator=gen, device=dev)
    q = batch // world
    xl, yl = x[rank * q:(rank + 1) * q], y[rank * q:(rank + 1) * q]
    fused = kt.ops.fused_eigen_precondition

    def make(ddp, strategy):
        return kt.KFACPreconditioner(
            ddp, grad_worker_fraction=kt.DistributedStrategy[strategy],
            ekfac=True, **RN50_GRID_HP)

    def train(model, ddp, precond, opt, steps, save=None, feed=None,
              start=0):
        """``feed``: COMM-OPT's preconditioned gradients by step, which
        the optimizer applies in place of the run's own (after they are
        recorded), so every strategy sees the same weights."""
        out = dict(grads=[], losses=[], divs=[], step_s=[])
        for step in range(steps):
            if save is not None and step == RN50_GRID_SAVE:
                save['sd'] = precond.state_dict(include_ekfac_scales=True)
                save['model'] = {k: v.clone()
                                 for k, v in model.state_dict().items()}
                save['opt'] = opt.state_dict()
                save['opt']['state'] = {
                    k: {n: t.clone() for n, t in v.items()}
                    for k, v in save['opt']['state'].items()}
            t0 = time.perf_counter()
            opt.zero_grad()
            loss = F.cross_entropy(ddp(xl), yl)
            loss.backward()
            precond.step()
            out['grads'].append(torch.cat(
                [p.grad.reshape(-1) for p in model.parameters()]))
            if feed is not None:
                offset = 0
                for p in model.parameters():
                    p.grad.copy_(feed[start + step][
                        offset:offset + p.numel()].view_as(p))
                    offset += p.numel()
            opt.step()
            mean = loss.detach().clone()
            dist.all_reduce(mean)
            out['losses'].append(float(mean) / world)
            out['divs'].append(float(precond.last_ekfac_divergence))
            if dev.type == 'cuda':
                torch.cuda.synchronize(dev)
            out['step_s'].append(time.perf_counter() - t0)
        return out

    report, ref = {}, None
    for strategy in RN50_GRID_STRATEGIES:
        model = getattr(kt.models, model_name[0])(device=dev, seed=0)
        ddp = torch.nn.parallel.DistributedDataParallel(
            model, device_ids=None if dev.index is None else [dev.index])
        precond = make(ddp, strategy)
        opt = torch.optim.SGD(model.parameters(), lr=RN50_GRID_HP['lr'],
                              momentum=0.9)
        fused.launches = 0
        save = {} if strategy != 'COMM_OPT' else None
        feed = None if ref is None else ref['grads']
        run = train(model, ddp, precond, opt, RN50_GRID_STEPS, save, feed)
        rec = dict(
            losses=run['losses'], divs=run['divs'], step_s=run['step_s'],
            launches=fused.launches,
            grid=(precond.grid.rows, precond.grid.cols),
            second_order=precond.memory_usage()['second_order'],
            bases=sum(bs.basis_qa.numel() * bs.basis_qa.element_size()
                      + bs.basis_qg.numel() * bs.basis_qg.element_size()
                      for bs in precond.buckets.values()
                      if bs.basis_qa is not None),
        )
        if ref is None:
            ref = run
        else:
            rec['grad_err'] = [
                float(torch.linalg.vector_norm(g - r)
                      / torch.linalg.vector_norm(r))
                for g, r in zip(run['grads'], ref['grads'])]
            rec['loss_err'] = [abs(a - b) / abs(b) for a, b in
                               zip(run['losses'], ref['losses'])]
            # The round trip on the same DDP wrapper (a new wrapper's
            # first all-reduce sums in another bucket layout).
            precond._capture.armed = False
            model.load_state_dict(save['model'])
            opt.load_state_dict(save['opt'])
            again = make(ddp, strategy)
            again.load_state_dict(save['sd'])
            tail = train(model, ddp, again, opt,
                         RN50_GRID_STEPS - RN50_GRID_SAVE, feed=feed,
                         start=RN50_GRID_SAVE)
            rec['resume_bitwise'] = all(
                torch.equal(a, b) for a, b in zip(
                    tail['grads'], run['grads'][RN50_GRID_SAVE:])) and (
                tail['divs'] == run['divs'][RN50_GRID_SAVE:])
            del again, tail
        report[strategy] = rec
        if run is not ref:
            del run
        del precond, ddp, model, opt
        if dev.type == 'cuda':
            torch.cuda.empty_cache()
    torch.save(report, os.path.join(workdir, f'grid{rank}.pt'))
    dist.barrier()
    dist.destroy_process_group()


def phase_resnet50_ekfac_grid(torch, kt, ranks=None):
    """Phase 18: four ranks of :func:`ekfac_grid_rank` on the card
    (``ranks``: their reports from :func:`spawn_shared`), EKFAC
    on ResNet-50 under COMM-OPT, HYBRID-OPT and MEM-OPT.  The grids with
    several columns step their weights with COMM-OPT's preconditioned
    gradients, so all three see the same weights at every step (a free
    trajectory on one memorized batch amplifies a last-bit difference
    about tenfold a step: 1e-7 at step 1, 0.2 by step 6 on a CPU
    rehearsal with ResNet-32); the EKFAC state of each grid evolves by
    itself.  Gates: under the two grids with several columns every
    step's preconditioned gradients (relative Frobenius over the whole
    model) within ``RN50_GRID_TOL`` of COMM-OPT's, ``ekfac_divergence``
    bitwise equal on all four ranks at every step, no fused-kernel
    launch, finite falling losses, and the state-dict round trip (saved
    before step ``RN50_GRID_SAVE``, the last step resumed)
    resuming bitwise.  The losses are held to the same bar, but under
    this feeding the weights, and so the losses, equal COMM-OPT's by
    construction: that gate only shows the feeding took (it reads 0).  Prints the three designs'
    counted bytes (:func:`ekfac_design_bytes`) and the second-order
    bytes a rank holds."""
    from kfac_pytorch_tpu_torch.parallel.mesh import default_backend

    world = KAISA_WORLD
    backend = default_backend(world) if DEVICE == 'cuda' else 'gloo'
    local = RN50_BATCH // world
    print(f'resnet50 ekfac grid: world {world}, backend {backend}, batch '
          f'{local} per rank at {RN50_IMAGE}x{RN50_IMAGE}, factor 1, inv '
          f'{RN50_GRID_HP["inv_update_steps"]}, {RN50_GRID_STEPS} steps; '
          'times are correctness-path times on one shared card',
          flush=True)
    for fraction in (0.5, 0.25):
        counted = ekfac_design_bytes(torch, kt, local, RN50_IMAGE, world,
                                     fraction)
        grid = counted.pop('grid')
        print(f'resnet50 ekfac grid bytes {grid[0]}x{grid[1]} (f32, per '
              'rank; factor_step and refresh are bytes received, held the '
              'second-order state, in_flight the receive buffers): '
              + json.dumps(counted), flush=True)
    if ranks is None:
        ranks = spawn_alone(torch, '18')
    for strategy in RN50_GRID_STRATEGIES:
        runs = [r[strategy] for r in ranks]
        label = f'resnet50 ekfac grid {strategy}'
        first = runs[0]
        for i, r in enumerate(runs):
            if r['launches']:
                fail(f'{label} rank {i}: the fused kernel launched '
                     f'{r["launches"]} times (EKFAC keeps no dgda)')
            if r['divs'] != first['divs']:
                fail(f'{label}: rank {i} read the drift {r["divs"]}, rank 0 '
                     f'{first["divs"]}')
            if r['losses'] != first['losses']:
                fail(f'{label}: rank {i} mean losses differ from rank 0\'s')
        losses = first['losses']
        if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
            fail(f'{label}: mean losses {losses}')
        step_ms = statistics.median(
            t for r in runs for t in r['step_s'][1:]) * 1e3
        line = (f'{label}: grid {first["grid"]}; mean loss {losses[0]:.6f} '
                f'-> {losses[-1]:.6f}; ekfac_divergence bitwise equal on '
                f'all {world} ranks at every step {first["divs"]}; 0 fused '
                f'launches; second-order bytes a rank holds '
                f'{first["second_order"]} (of them the bases of every '
                f'occupied slot {first["bases"]}); median step '
                f'{step_ms:.4f} ms')
        if strategy != 'COMM_OPT':
            grad_err = max(max(r['grad_err']) for r in runs)
            loss_err = max(max(r['loss_err']) for r in runs)
            if grad_err > RN50_GRID_TOL or loss_err > RN50_GRID_TOL:
                fail(f'{label}: against COMM-OPT the preconditioned '
                     f'gradients differ by {grad_err:.3e} and the losses by '
                     f'{loss_err:.3e} (relative; the bar '
                     f'{RN50_GRID_TOL:g})')
            if not all(r['resume_bitwise'] for r in runs):
                fail(f'{label}: the state-dict round trip saved before step '
                     f'{RN50_GRID_SAVE} did not resume bitwise')
            line += (f'; against COMM-OPT: gradients max relative Frobenius '
                     f'{grad_err:.3e}, losses max relative {loss_err:.3e} '
                     '(equal by construction: the same fed weights) '
                     f'(bar {RN50_GRID_TOL:g}); the state-dict round trip '
                     f'saved before step {RN50_GRID_SAVE} resumes bitwise '
                     'on every rank')
        print(line, flush=True)


#: Phase 19: the fused training path with Levenberg–Marquardt damping on
#: ResNet-50 (phase 9's batch and hyperparameters), an adaptation every
#: ``RN50_FUSED_INTERVAL`` steps.
RN50_FUSED_STEPS = 15
RN50_FUSED_INTERVAL = 5


def rn50_fused_run(torch, kt, mode):
    """``RN50_FUSED_STEPS`` steps of ResNet-50 with
    ``damping=AdaptiveDamping(0.003, interval=5)``: through
    ``make_train_step`` (``mode='train_step'``), ``train_loop``
    (``'train_loop'``) or ``step()`` fed by hand (``'hand'``: the
    documented recipe, ``vg_sum`` from ``last_step_info`` and a loss-only
    forward under ``no_grad`` with BatchNorm's buffers restored).  The
    loss-only forwards are timed with CUDA events (``loss_only_ms``)."""
    import torch.nn.functional as F

    model = kt.models.resnet50(device=DEVICE, seed=0)
    x, y = rn50_batch(torch)
    ad = kt.AdaptiveDamping(RN50_HP['damping'], interval=RN50_FUSED_INTERVAL)
    precond = kt.KFACPreconditioner(model, **dict(RN50_HP, damping=ad))
    opt = torch.optim.SGD(model.parameters(), lr=RN50_HP['lr'],
                          momentum=0.9)
    bn = [b for m in model.modules()
          if isinstance(m, torch.nn.BatchNorm2d) for b in m.buffers()]
    out = dict(losses=[], damping=[], rho=[], step_ms=[], loss_only_ms=[],
               vg=[])
    real = precond._loss_only

    def timed_loss_only(*a):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        s.record()
        loss = real(*a)
        e.record()
        out['events'].append((s, e))
        return loss
    out['events'] = []
    precond._loss_only = timed_loss_only
    if mode == 'train_step':
        step = precond.make_train_step(opt, F.cross_entropy)
    elif mode == 'train_loop':
        step = precond.train_loop(opt, F.cross_entropy).step
    else:
        def step(xb, loss_args):
            opt.zero_grad()
            before = F.cross_entropy(model(xb), *loss_args)
            before.backward()
            index = precond.steps
            precond.step()
            opt.step()
            if ad.should_adapt(index):
                s, e = torch.cuda.Event(enable_timing=True), \
                    torch.cuda.Event(enable_timing=True)
                s.record()
                with torch.no_grad():
                    saved = [b.clone() for b in bn]
                    after = F.cross_entropy(model(xb), *loss_args)
                    for b, v in zip(bn, saved):
                        b.copy_(v)
                e.record()
                out['events'].append((s, e))
                lr = RN50_HP['lr']
                predicted = (-lr + 0.5 * lr * lr) * float(
                    precond.last_step_info['vg_sum'])
                ad.update(float(after) - float(before.detach()), predicted)
            return before.detach(), None
    kt.ops.fused_eigen_precondition.launches = 0
    for _ in range(RN50_FUSED_STEPS):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        s.record()
        loss, _ = step(x, loss_args=(y,))
        e.record()
        e.synchronize()
        out['step_ms'].append(s.elapsed_time(e))
        out['losses'].append(float(loss))
        out['damping'].append(ad.damping)
        out['rho'].append(ad.rho)
        out['vg'].append(float(precond.last_step_info['vg_sum']))
    torch.cuda.synchronize()
    out['launches'] = kt.ops.fused_eigen_precondition.launches
    out['loss_only_ms'] = [s.elapsed_time(e) for s, e in out.pop('events')]
    out['params'] = torch.cat([p.detach().reshape(-1)
                               for p in model.parameters()])
    out['buffers'] = torch.cat([b.detach().float().reshape(-1)
                                for b in model.buffers()])
    out['buckets'] = kernel_buckets(precond)
    del precond, model, opt
    return out


def phase_resnet50_fused(torch, kt):
    """Phase 19: the fused path (``make_train_step``, then
    ``train_loop``) against ``step()`` fed by hand from
    ``last_step_info['vg_sum']`` and the same loss-only forward, each
    from the same weights.  Gates: every run bitwise equal to the
    hand-fed one (losses, damping and ``rho`` at every step, the final
    parameters and BatchNorm buffers), 21 kernel launches a step, finite
    falling losses, at least one adaptation that moved the damping.
    Prints the damping sequence, ``rho``, and the loss-only forward's
    device time beside the step's."""
    torch.backends.cudnn.deterministic = True
    try:
        runs = {mode: rn50_fused_run(torch, kt, mode)
                for mode in ('hand', 'train_step', 'train_loop')}
    finally:
        torch.backends.cudnn.deterministic = False
    hand = runs['hand']
    per_step = hand['buckets'] if DEVICE == 'cuda' else 0
    if DEVICE == 'cuda' and per_step != 21:
        fail(f'resnet50 fused: {per_step} buckets keep dgda, not 21')
    launches = 0
    for mode, run in runs.items():
        label = f'resnet50 fused {mode}'
        if run['launches'] != RN50_FUSED_STEPS * per_step:
            fail(f'{label}: {run["launches"]} launches, expected '
                 f'{RN50_FUSED_STEPS * per_step}')
        losses = run['losses']
        if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
            fail(f'{label}: losses {losses}')
        for key in ('losses', 'damping', 'rho', 'vg'):
            if run[key] != hand[key]:
                fail(f'{label}: {key} {run[key]} differ from the hand-fed '
                     f'step() run\'s {hand[key]}')
        for key in ('params', 'buffers'):
            if not torch.equal(run[key], hand[key]):
                fail(f'{label}: the final {key} differ from the hand-fed '
                     'step() run\'s')
        if mode != 'hand':
            launches += run['launches']
    if len(set(hand['damping'])) < 2:
        fail(f'resnet50 fused: the damping never moved: {hand["damping"]}')
    step_ms = statistics.median(hand['step_ms'][1:])
    lo_ms = statistics.median(runs['train_step']['loss_only_ms'])
    print(f'resnet50 fused: make_train_step and train_loop bitwise equal to '
          f'step() fed by hand ({RN50_FUSED_STEPS} steps each: losses, '
          f'damping, rho, vg_sum, final parameters and BatchNorm buffers); '
          f'{per_step} launches a step; losses {hand["losses"][0]:.6f} -> '
          f'{hand["losses"][-1]:.6f}; damping {hand["damping"]}; rho '
          f'{hand["rho"]}',
          flush=True)
    print(f'resnet50 fused: the loss-only forward (CUDA events, median of '
          f'{len(runs["train_step"]["loss_only_ms"])} adapting steps) '
          f'{lo_ms:.4f} ms against the median step {step_ms:.4f} ms '
          f'(steps 1-{RN50_FUSED_STEPS - 1}, CUDA events): share '
          f'{lo_ms / step_ms:.4f} of a step, '
          f'{lo_ms / step_ms / RN50_FUSED_INTERVAL:.4f} amortized over '
          f'the interval of {RN50_FUSED_INTERVAL}; make_train_step median '
          f'step '
          f'{statistics.median(runs["train_step"]["step_ms"][1:]):.4f} ms, '
          f'train_loop '
          f'{statistics.median(runs["train_loop"]["step_ms"][1:]):.4f} ms',
          flush=True)
    return launches


#: Phase 20: the numerical-health guardrails on ResNet-50 (phase 9's
#: batch), a factor update every step so that the bad batch meets a
#: factor update, refreshes every 3 steps (every 2 in the injection run):
#: cut from phase 9's cadence to fit its budget.  The injection run fails
#: two slots: one of a bucket with three slots (``a576g64``) and the one
#: slot of a wide bucket (``a2176g1024``).
RN50_HEALTH_HP = dict(RN50_HP, factor_update_steps=1, inv_update_steps=3)
RN50_HEALTH_STEPS = 6   # the health-off and health-on runs compared
RN50_HEALTH_NAN = 7     # the bad batch of the health-on run
RN50_HEALTH_INJECT = (('a576g64', 1), ('a2176g1024', 0))
RN50_HEALTH_Q_AFTER = 2
#: ``(model, classes)`` of phase 20 (a CPU rehearsal takes a smaller one,
#: with its own ``RN50_HEALTH_INJECT``).
HEALTH_MODEL = ('resnet50', 1000)


def health_model(torch, kt):
    """Phase 20's model and its batch (phase 9's, labels within the
    model's classes)."""
    name, classes = HEALTH_MODEL
    model = getattr(kt.models, name)(num_classes=classes, device=DEVICE,
                                     seed=0)
    x, y = rn50_batch(torch)
    return model, x, y % classes


def rn50_health_run(torch, kt, health, steps, nan_at=None):
    """``steps`` steps of ResNet-50 through ``train_loop`` (SGD momentum
    0.9) from phase 9's weights and batch; ``nan_at`` plants one NaN
    pixel in that step's batch and checks what the step must leave
    alone.  Returns losses, parameters, step times, launches and the
    health counters."""
    import torch.nn.functional as F

    model, x, y = health_model(torch, kt)
    precond = kt.KFACPreconditioner(model, health=health, **RN50_HEALTH_HP)
    opt = torch.optim.SGD(model.parameters(), lr=RN50_HEALTH_HP['lr'],
                          momentum=0.9)
    loop = precond.train_loop(opt, F.cross_entropy)
    out = dict(losses=[], step_ms=[], syncs=[], nan={})
    kt.ops.fused_eigen_precondition.launches = 0
    for t in range(steps):
        xb = x
        if t == nan_at:
            xb = x.clone()
            xb[0, 0, 0, 0] = float('nan')
            before = dict(
                params=[p.detach().clone() for p in model.parameters()],
                momentum=[s['momentum_buffer'].clone()
                          for s in opt.state.values()],
                buffers=[b.clone() for b in model.buffers()],
                factors=[t.clone() for st in precond.layers.values()
                         for t in (st.a_factor, st.g_factor)])
        syncs = precond.health_host_syncs
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        s.record()
        loss, _ = loop.step(xb, loss_args=(y,))
        e.record()
        e.synchronize()
        out['step_ms'].append(s.elapsed_time(e))
        out['syncs'].append(precond.health_host_syncs - syncs)
        out['losses'].append(float(loss))
        if t == nan_at:
            after = dict(
                params=list(model.parameters()),
                momentum=[s['momentum_buffer'] for s in opt.state.values()],
                buffers=list(model.buffers()),
                factors=[t for st in precond.layers.values()
                         for t in (st.a_factor, st.g_factor)])
            out['nan'] = {k: all(torch.equal(a, b) for a, b in
                                 zip(before[k], after[k])) for k in before}
            out['nan']['vg_sum'] = float(precond.last_step_info['vg_sum'])
            out['nan']['info'] = {
                k: int(v) for k, v in precond.last_step_info.items()
                if k.startswith('health/')}
    torch.cuda.synchronize()
    out['launches'] = kt.ops.fused_eigen_precondition.launches
    out['buckets'] = kernel_buckets(precond)
    out['params'] = torch.cat([p.detach().reshape(-1)
                               for p in model.parameters()])
    out['info'] = {k: int(v) for k, v in precond.last_step_info.items()
                   if k.startswith('health/')} if health else {}
    del loop, opt, precond, model
    gc.collect()
    return out


def rn50_health_injection(torch, kt):
    """The injection run: refreshes at 0, 2, 4 and 6 (inv 2) through
    ``step()``.  The first refresh is clean; before step 2 both slots'
    first attempt is made to fail and one layer's factors are poisoned;
    before steps 4 and 6 every attempt fails.  Returns the counters after
    each refresh step, the launches, and the step-6 checks of the
    quarantined slots."""
    import dataclasses

    import torch.nn.functional as F

    model, x, y = health_model(torch, kt)
    cfg = kt.HealthConfig(quarantine_after=RN50_HEALTH_Q_AFTER)
    precond = kt.KFACPreconditioner(
        model, health=cfg, **dict(RN50_HEALTH_HP, inv_update_steps=2))
    opt = torch.optim.SGD(model.parameters(), lr=RN50_HEALTH_HP['lr'],
                          momentum=0.9)
    slot_of = {v: k for k, v in precond.plan.slot_of.items()}
    names = [slot_of[s] for s in RN50_HEALTH_INJECT]
    poisoned = next(n for n in sorted(precond.helpers) if n not in names)

    def inject(attempts):
        # The test harness's knob: the injection of the next refreshes
        # (the configuration is frozen; both holders take the new one).
        new = dataclasses.replace(
            cfg, inject_eigh_failures=attempts,
            inject_eigh_layers=RN50_HEALTH_INJECT)
        precond.health = new
        precond._second_order.health = new

    out = dict(info={}, syncs={}, check={})
    launches = 0
    for t in range(7):
        if t == 2:
            inject(1)
            kt.testing.poison_factors(precond, poisoned)
        elif t == 4:
            inject(cfg.max_eigh_retries + 1)
        opt.zero_grad()
        F.cross_entropy(model(x), y).backward()
        raw = {n: precond.helpers[n].get_grad().clone() for n in names}
        syncs = precond.health_host_syncs
        kt.ops.fused_eigen_precondition.launches = 0
        precond.step()
        launches += kt.ops.fused_eigen_precondition.launches
        out['syncs'][t] = precond.health_host_syncs - syncs
        out['info'][t] = {k: int(v) for k, v in
                          precond.last_step_info.items()
                          if k.startswith('health/')}
        if t == 6:
            scale = precond.last_kl_scale
            out['check']['raw_bitwise'] = all(
                torch.equal(precond.helpers[n].get_grad(),
                            (raw[n].float() * scale).to(raw[n].dtype))
                for n in names)
            out['check']['masks'] = {
                k: precond.buckets[k].quarantined.tolist()
                for k, _ in RN50_HEALTH_INJECT}
            # The other slots of the quarantined buckets against the
            # same state preconditioned without the masks (kl-clip off,
            # so no global scale couples the slots).
            combined = {n: h.get_grad() for n, h in precond.helpers.items()}
            so = precond._second_order
            quarantined, _ = so.precondition(
                precond.buckets, combined, precond.damping, None,
                precond.lr)
            clear = {k: dataclasses.replace(
                bs, quarantined=torch.zeros_like(bs.quarantined))
                for k, bs in precond.buckets.items()}
            plain, _ = so.precondition(clear, combined, precond.damping,
                                       None, precond.lr)
            err = 0.0
            for key, slot in RN50_HEALTH_INJECT:
                for i, n in enumerate(precond.plan.bucket(key).slots):
                    if n is None or i == slot:
                        continue
                    err = max(err, rel_frob(quarantined[n], plain[n]))
            out['check']['others_err'] = err
        opt.step()
    torch.cuda.synchronize()
    out['launches'] = launches
    out['names'] = names
    del opt, precond, model
    gc.collect()
    return out


def phase_resnet50_health(torch, kt):
    """Phase 20: ``health=HealthConfig()`` on ResNet-50 (budget 30 s).
    Gates: the health-on run bitwise the health-off run over
    ``RN50_HEALTH_STEPS`` steps (losses and final parameters); the NaN
    batch of step ``RN50_HEALTH_NAN`` skipped (``steps_skipped`` 1,
    ``step_ok`` 0, ``vg_sum`` 0; parameters, momentum, BatchNorm buffers
    and factor EMAs bitwise unchanged) and the next step finite; in the
    injection run the first failed attempt recovered by a retry with no
    fallback, the poisoned layer's two factors reset (``factor_resets``
    2), then every attempt failing: a fallback at the first such refresh
    and both slots quarantined at the second; the quarantined slots'
    gradients their raw gradients bitwise (times the kl-clip scale), the
    other slots of their buckets within 1e-5 of the same state
    preconditioned without the masks; 21 kernel launches a step in every
    run.  Prints the median step health on and off and the host reads a
    step and a refresh."""
    torch.backends.cudnn.deterministic = True
    try:
        off = rn50_health_run(torch, kt, None, RN50_HEALTH_STEPS)
        on = rn50_health_run(torch, kt, kt.HealthConfig(),
                             RN50_HEALTH_NAN + 2, nan_at=RN50_HEALTH_NAN)
        inj = rn50_health_injection(torch, kt)
    finally:
        torch.backends.cudnn.deterministic = False
    per_step = off['buckets'] if DEVICE == 'cuda' else 0
    if DEVICE == 'cuda' and HEALTH_MODEL[0] == 'resnet50' and per_step != 21:
        fail(f'resnet50 health: {per_step} buckets keep dgda, not 21')
    for label, run, steps in (('off', off, RN50_HEALTH_STEPS),
                              ('on', on, RN50_HEALTH_NAN + 2),
                              ('injection', inj, 7)):
        if run['launches'] != steps * per_step:
            fail(f'resnet50 health {label}: {run["launches"]} launches, '
                 f'expected {steps * per_step}')
    n = RN50_HEALTH_STEPS
    if on['losses'][:n] != off['losses']:
        fail(f'resnet50 health: the health-on losses {on["losses"][:n]} '
             f'differ from the health-off run\'s {off["losses"]}')
    if not all(map(math.isfinite, off['losses'])) or not (
            off['losses'][-1] < off['losses'][0]):
        fail(f'resnet50 health: losses {off["losses"]}')
    nan = on['nan']
    info = nan['info']
    if not (all(nan[k] for k in ('params', 'momentum', 'buffers', 'factors'))
            and nan['vg_sum'] == 0.0 and info['health/steps_skipped'] == 1
            and info['health/step_ok'] == 0):
        fail(f'resnet50 health: the NaN batch was not skipped cleanly: '
             f'{nan}')
    if not (math.isfinite(on['losses'][-1])
            and on['info']['health/step_ok'] == 1):
        fail(f'resnet50 health: the step after the NaN batch: '
             f'{on["losses"][-1]}, {on["info"]}')
    i2, i4, i6 = inj['info'][2], inj['info'][4], inj['info'][6]
    if not (inj['info'][0]['health/eigh_retries'] == 0
            and i2['health/eigh_retries'] == 2
            and i2['health/eigh_fallbacks'] == 0
            and i2['health/factor_resets'] == 2
            and i4['health/eigh_fallbacks'] == 2
            and i4['health/quarantined_layers'] == 0
            and i6['health/eigh_fallbacks'] == 4
            and i6['health/quarantined_layers'] == 2):
        fail(f'resnet50 health injection: counters {inj["info"]}')
    check = inj['check']
    masks = [check['masks'][k][s] for k, s in RN50_HEALTH_INJECT]
    if not (all(masks) and check['raw_bitwise']
            and check['others_err'] <= 1e-5):
        fail(f'resnet50 health injection: the quarantined slots: {check}')
    off_ms = statistics.median(
        t for i, t in enumerate(off['step_ms']) if i % 3)
    on_ms = statistics.median(
        t for i, t in enumerate(on['step_ms'][:n]) if i % 3)
    refresh_syncs = sorted({on['syncs'][i] for i in range(0, n, 3)})
    print(f'resnet50 health: health on bitwise health off over {n} steps '
          f'(losses and final parameters, factor 1, inv 3, train_loop with '
          f'SGD momentum); {per_step} launches a step in every run; the NaN '
          f'pixel at step {RN50_HEALTH_NAN} skipped: parameters, momentum, '
          f'BatchNorm buffers and factor EMAs bitwise unchanged, vg_sum 0, '
          f'counters {info}; median non-refresh step (CUDA events) health '
          f'off {off_ms:.4f} ms, on {on_ms:.4f} ms (on/off '
          f'{on_ms / off_ms:.4f}); host reads a non-refresh step '
          f'{sorted(set(on["syncs"][i] for i in range(n) if i % 3))}, a '
          f'refresh step {refresh_syncs}', flush=True)
    print(f'resnet50 health injection (inv 2, slots {RN50_HEALTH_INJECT} = '
          f'{inj["names"]}, quarantine_after {RN50_HEALTH_Q_AFTER}): '
          f'counters after the refreshes at 0, 2, 4, 6: '
          + json.dumps({t: inj['info'][t] for t in (0, 2, 4, 6)})
          + f'; host reads at those steps '
          f'{[inj["syncs"][t] for t in (0, 2, 4, 6)]}; quarantined slots '
          f'bitwise their raw gradients times the kl-clip scale; the other '
          f'slots of their buckets against the unmasked state max relative '
          f'Frobenius {check["others_err"]:.3e}', flush=True)
    return on['launches'] + off['launches'] + inj['launches']


#: Phase 21: the cross-replica consistency guard at world 4 on one card
#: over gloo, HYBRID-OPT (2x2), ResNet-50 with 8 images a rank on frozen
#: weights (no optimizer step, so a corrupted rank's gradients cannot
#: move the model), cadence 2, one factor update and one refresh at
#: step 0 (factor and inv 100: the checks, not the refresh, are timed).
RN50_CONS_HP = dict(RN50_HP, factor_update_steps=100, inv_update_steps=100)
RN50_CONS_STEPS = 13
RN50_CONS_Q_AFTER = 2
RN50_CONS_TIMEOUT_S = 300
#: ``(model, classes)`` of phase 21 (a CPU rehearsal takes a smaller one).
CONS_MODEL = ('resnet50', 1000)
#: The bucket whose first slot of grid column 0 rank 2 corrupts.
CONS_FLIP_KEY = 'a576g64'


def consistency_rank(rank, world, backend, device_type, workdir, image,
                     batch, model_name):
    """One rank of phase 21; writes ``cons{rank}.pt`` to ``workdir``.
    Checks at even steps; the faults (rank 1 flips a bit of the first
    layer's A factor, rank 2 of the first slot of its column of
    ``CONS_FLIP_KEY``'s ``qa``): both before step 4, the slot again
    before step 6 (two consecutive strikes: quarantine), nothing before
    8, rank 3's damping drifted for step 10, then ``repair='detect'``
    with rank 1's flip before step 12.  After every check one more check
    of the final state counts what is left."""
    import dataclasses

    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    import kfac_pytorch_tpu_torch as kt

    if device_type == 'cuda':
        dev = torch.device(
            'cuda',
            rank % torch.cuda.device_count() if backend == 'nccl' else 0,
        )
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        dev = torch.device('cpu')
    dist.init_process_group(
        backend, init_method=f'file://{workdir}/pg_init', rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=240),
    )
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    x = torch.randn(batch, 3, image, image, generator=gen, device=dev)
    y = torch.randint(0, model_name[1], (batch,), generator=gen, device=dev)
    q = batch // world
    xl, yl = x[rank * q:(rank + 1) * q], y[rank * q:(rank + 1) * q]
    model = getattr(kt.models, model_name[0])(device=dev, seed=0)
    ddp = torch.nn.parallel.DistributedDataParallel(
        model, device_ids=None if dev.index is None else [dev.index])
    cfg = kt.ConsistencyConfig(cadence=2, quarantine_after=RN50_CONS_Q_AFTER)
    precond = kt.KFACPreconditioner(
        ddp, grad_worker_fraction=kt.DistributedStrategy.HYBRID_OPT,
        consistency=cfg, **RN50_CONS_HP)
    first = sorted(precond.layers)[0]
    seg = precond.plan.bucket(CONS_FLIP_KEY).seg

    def flip_layer():
        st = precond.layers[first]
        st.a_factor = kt.testing.desync_replica(st.a_factor, 1)

    def flip_slot():
        kt.testing.desync_slot(precond, CONS_FLIP_KEY, 0, 'qa', replica=2)

    def sync():
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)

    fused = kt.ops.fused_eigen_precondition
    fused.launches = 0
    rec = dict(info={}, after={}, flags={}, step_ms=[], masks={},
               check_ms={})
    for t in range(RN50_CONS_STEPS):
        if t == 4:
            flip_layer()
            flip_slot()
        elif t == 6:
            flip_slot()
        elif t in (10, 11) and rank == 3:
            precond._damping = RN50_CONS_HP['damping'] * (
                1.01 if t == 10 else 1.0)
        elif t == 12:
            precond._consistency = dataclasses.replace(cfg, repair='detect')
            flip_layer()
        sync()
        t0 = time.perf_counter()
        ddp.zero_grad()
        F.cross_entropy(ddp(xl), yl).backward()
        precond.step()
        sync()
        rec['step_ms'].append((time.perf_counter() - t0) * 1e3)
        info = precond.last_step_info
        if t % 2 == 0:
            rec['info'][t] = {k: int(v) for k, v in info.items()
                              if k.startswith('consistency/')
                              and not k.startswith('consistency/bucket/')}
            rec['flags'][t] = (precond._stagger_bootstrapped,
                               precond._iter_bootstrapped,
                               precond._overlap_bootstrapped)
            rec['masks'][t] = precond.buckets[CONS_FLIP_KEY].quarantined[
                :seg].tolist()
            rec['bytes'] = precond.last_consistency_check.gathered_bytes
            # One more check of the final state: clean after a repair,
            # still divergent after a detect-only check.
            fused_before = fused.launches
            sync()
            t0 = time.perf_counter()
            again = precond._consistency_check({
                'damping': precond.damping,
                'factor_decay': precond.factor_decay,
                'kl_clip': precond.kl_clip, 'lr': precond.lr})
            rec['check_ms'][t] = (time.perf_counter() - t0) * 1e3
            rec['after'][t] = int(again.info()['consistency/mismatches'])
            fused.launches = fused_before
    sync()
    rec['launches'] = fused.launches
    rec['buckets'] = kernel_buckets(precond)
    rec['grid'] = (precond.grid.rows, precond.grid.cols)
    rec['col'] = precond.grid.col
    torch.save(rec, os.path.join(workdir, f'cons{rank}.pt'))
    dist.barrier()
    dist.destroy_process_group()


def phase_resnet50_consistency(torch, kt, ranks=None):
    """Phase 21: four ranks of :func:`consistency_rank` (budget 45 s;
    ``ranks``: their reports from :func:`spawn_shared`).
    Gates on every rank, all reading the same counters: the checks at 0
    and 2 clean; at 4 exactly one layer and one slot mismatching,
    repaired (the follow-up check clean) and the next refresh forced to
    a bootstrap (the three flags down); at 6 the slot again (strike 2 =
    ``quarantine_after``): quarantined on the two ranks of grid column 0,
    still at 8 (clean); at 10 an ``hp`` mismatch counted and nothing
    repaired; at 12 under ``repair='detect'`` the layer counted and left
    divergent (the follow-up check still counts it); the sharded kernel
    launched 21 times a step on every rank.  Prints the check step's
    extra time over a plain step and the bytes each check gathered."""
    from kfac_pytorch_tpu_torch.parallel.mesh import default_backend

    world = KAISA_WORLD
    backend = default_backend(world) if DEVICE == 'cuda' else 'gloo'
    if ranks is None:
        ranks = spawn_alone(torch, '21')
    label = 'resnet50 consistency'
    per_step = ranks[0]['buckets'] if DEVICE == 'cuda' else 0
    if DEVICE == 'cuda' and CONS_MODEL[0] == 'resnet50' and per_step != 21:
        fail(f'{label}: {per_step} buckets keep dgda, not 21')
    ref = ranks[0]['info']
    for i, r in enumerate(ranks):
        if r['info'] != ref:
            fail(f'{label}: rank {i} counters {r["info"]} differ from rank '
                 f'0\'s {ref}')
        if r['launches'] != RN50_CONS_STEPS * per_step:
            fail(f'{label} rank {i}: {r["launches"]} launches, expected '
                 f'{RN50_CONS_STEPS * per_step}')
        if r['grid'] != (2, 2):
            fail(f'{label} rank {i}: grid {r["grid"]}')
        after = r['after']
        if after != {0: 0, 2: 0, 4: 0, 6: 0, 8: 0, 10: 1, 12: 1}:
            fail(f'{label} rank {i}: follow-up check mismatches {after}')
        if r['flags'][4] != (False, False, False) or r['flags'][2] != (
                True, True, True):
            fail(f'{label} rank {i}: the bootstrap flags {r["flags"]}')
        n = len(r['masks'][6])
        want_mask = ([True] + [False] * (n - 1) if r['col'] == 0
                     else [False] * n)
        if r['masks'][4] != [False] * n or r['masks'][6] != want_mask or (
                r['masks'][8] != want_mask):
            fail(f'{label} rank {i}: quarantine masks {r["masks"]}')
    c = {t: ref[t] for t in ref}
    ok = (
        c[0]['consistency/mismatches'] == 0
        and c[2]['consistency/mismatches'] == 0
        and c[4]['consistency/layer_mismatches'] == 1
        and c[4]['consistency/bucket_mismatches'] == 1
        and c[4]['consistency/mismatches'] == 2
        and c[4]['consistency/repairs_total'] == 1
        and c[4]['consistency/strikes_max'] == 1
        and c[6]['consistency/layer_mismatches'] == 0
        and c[6]['consistency/bucket_mismatches'] == 1
        and c[6]['consistency/strikes_max'] == 2
        and c[6]['consistency/quarantines_total'] == 1
        and c[8]['consistency/mismatches'] == 0
        and c[8]['consistency/strikes_max'] == 0
        and c[10]['consistency/hp_mismatches'] == 1
        and c[10]['consistency/mismatches'] == 1
        and c[10]['consistency/repairs_total'] == 2
        and c[12]['consistency/layer_mismatches'] == 1
        and c[12]['consistency/mismatches'] == 1
        and c[12]['consistency/repairs_total'] == 2
        and c[12]['consistency/detections_total'] == 4
        and c[12]['consistency/checks_total'] == 7
    )
    if not ok:
        fail(f'{label}: counters {c}')
    plain = statistics.median(t for r in ranks
                              for s, t in enumerate(r['step_ms'])
                              if s % 2 and s > 1)
    check = statistics.median(r['step_ms'][2] for r in ranks)
    alone = statistics.median(r['check_ms'][t] for r in ranks
                              for t in (2, 4, 6, 8))
    print(f'{label}: world {world}, backend {backend}, grid 2x2, batch '
          f'{RN50_BATCH // world} per rank at {RN50_IMAGE}x{RN50_IMAGE}, '
          f'frozen weights, cadence 2, quarantine_after {RN50_CONS_Q_AFTER}; '
          f'the same counters on every rank: '
          + json.dumps({t: c[t] for t in (4, 6, 10, 12)})
          + f'; {per_step} sharded launches a step on every rank; the clean '
          f'check step 2 {check:.4f} ms against the median plain step '
          f'{plain:.4f} ms (extra {check - plain:.4f} ms; host clock around '
          f'a synchronized step, one shared card); a check by itself (the '
          f'follow-up checks of steps 2-8, synchronized before and after, '
          f'median over ranks) {alone:.4f} ms; each check gathered '
          f'{ranks[0]["bytes"]} bytes into every rank', flush=True)
    return sum(r['launches'] for r in ranks)


#: The three JAX bench stages of ``bench.py`` item 6, cut in steps (the
#: K-FAC cycles at inv 20, one cycle; widths as the stages define them).
BENCH_STAGE_CUT = dict(inv_steps=20, cycles=1)


def phase_bench_stages(torch, kt):
    """The bench's ``micro_mlp``, ``inverse_root`` and
    ``secondary_rn50_inverse`` stages once (the K-FAC stages at
    ``BENCH_STAGE_CUT``), each timed through ``train_loop``; fails on a
    non-finite time."""
    from kfac_pytorch_tpu_torch import bench

    out = {
        'micro_mlp': bench.measure_micro_mlp(DEVICE, **BENCH_STAGE_CUT),
        'inverse_root': bench.measure_inverse_root(DEVICE),
        'secondary_rn50_inverse': bench.measure_secondary_rn50_inverse(
            DEVICE, **BENCH_STAGE_CUT),
    }
    times = [out['micro_mlp']['sgd_ms'], out['micro_mlp']['kfac_ms'],
             out['secondary_rn50_inverse']['kfac_ms']] + [
        s[k] for s in out['inverse_root']['shapes']
        for k in ('eigh_ms', 'cholesky_ms', 'ns_cold_ms', 'ns_warm_ms')]
    if not all(math.isfinite(t) and t > 0 for t in times):
        fail(f'bench stages: times {times}')
    print(f'bench stages ({BENCH_STAGE_CUT}): ' + json.dumps(out),
          flush=True)


#: Phases 10 and 11: the transformer encoders at their published widths
#: and depths, f32 parameters, the models' bf16 compute, SGD, a factor
#: update every step.  The rehearsal on the CPU sets ``VIT_MODEL =
#: 'vit_tiny'``, ``BERT_MODEL = 'bert_tiny'`` and small batches.
VIT_HP = dict(factor_update_steps=1, inv_update_steps=10, damping=0.003,
              kl_clip=0.001, lr=0.1)
VIT_MODEL = 'vit_b16'
VIT_BATCH = 32
VIT_STEPS = 12  # refreshes at 0 and CHECK_STEP
VIT_FULL = dict(layer_types=('linear', 'conv2d', 'layernorm'))
#: ``examples/squad_bert.py``'s damping and kl-clip, 4 x 384 tokens.
BERT_HP = dict(factor_update_steps=1, inv_update_steps=5, damping=0.001,
               kl_clip=0.001, lr=0.1)
BERT_MODEL = 'bert_large'
BERT_BATCH = (4, 384)  # sequences x tokens
BERT_MASKED = 64  # the last positions of rows 0 and 1
BERT_STEPS = 7
BERT_CHECK_STEP = 5  # the second refresh
BERT_FULL = dict(layer_types=('linear', 'embedding', 'layernorm'))


def report_coverage(label, precond, want_uncovered):
    """Prints ``coverage_report()``; fails on an unsupported layer, a
    count other than the registered layers, or other uncovered
    parameters than ``want_uncovered``."""
    rep = precond.coverage_report()
    if (rep['unsupported'] or rep['registered'] != len(precond.layers)
            or rep['uncovered'] != want_uncovered
            or not precond._uses_coverage_helpers()):
        fail(f'{label}: coverage report {rep}')
    print(f'{label}: coverage_report registered={rep["registered"]} '
          f'skipped={rep["skipped"]} unsupported={rep["unsupported"]} '
          f'tied={rep["tied"]} params {rep["params_covered"]}/'
          f'{rep["params_total"]} param_fraction={rep["param_fraction"]:.6f}'
          f' uncovered={rep["uncovered"]}', flush=True)


def check_plan(label, precond, cases, full_size):
    """The plan's ``(L, gp, ap)`` stacks; at the published widths they
    must be the shapes phase 2 held the kernel at."""
    shapes = [(b.n_slots, b.g_pad, b.a_pad) for b in precond.plan.buckets]
    if full_size and shapes != cases:
        fail(f'{label}: buckets {shapes}, phase 2 checked {cases}')
    return shapes


def phase_vit(torch, kt):
    """Phase 10: ViT-B/16 at its published widths and depth (224x224
    images, 1000 classes, 12 layers) at batch ``VIT_BATCH``, full
    coverage (the patchify conv, 48 Dense layers, the head and 25
    LayerNorms in six buckets), ``VIT_STEPS`` steps with refreshes at 0
    and ``CHECK_STEP``.  Returns the kernel launches."""
    import torch.nn.functional as F

    model = getattr(kt.models, VIT_MODEL)(device=DEVICE, seed=0)
    cfg = model.config
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(4)
    x = torch.randn(VIT_BATCH, 3, cfg.image_size, cfg.image_size,
                    generator=gen, device=DEVICE)
    y = torch.randint(0, cfg.num_classes, (VIT_BATCH,), generator=gen,
                      device=DEVICE)

    def fwd_bwd():
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        return loss.detach()

    run = train_path(torch, kt, 'vit', model, fwd_bwd, VIT_HP, VIT_STEPS,
                     CHECK_STEP, **VIT_FULL)
    precond = run['precond']
    n = cfg.n_layers
    if len(precond.layers) != 1 + 4 * n + 1 + 2 * n + 1:
        fail(f'vit: {len(precond.layers)} layers registered')
    shapes = check_plan('vit', precond, VIT_CASES, VIT_MODEL == 'vit_b16')
    print(f'vit: {VIT_MODEL} ({cfg.image_size}x{cfg.image_size} images, '
          f'patch {cfg.patch_size}, {cfg.num_classes} classes, {n} layers, '
          f'{cfg.n_heads} heads, d_model {cfg.d_model}, d_ff {cfg.d_ff}, '
          f'{cfg.dtype} compute, {cfg.pool} pool), batch {VIT_BATCH}, full '
          f'coverage: {len(precond.layers)} layers, buckets (L, gp, ap) '
          f'{shapes}', flush=True)
    report_path('vit', run, VIT_STEPS,
                f'; the refresh step {CHECK_STEP} included')
    report_coverage('vit', precond, ['pos_embed'])
    launches = run['launches']
    del run, precond, model
    torch.cuda.empty_cache()
    return launches


def phase_bert(torch, kt):
    """Phase 11: BERT-large at its published widths and depth (vocab
    30522, 24 layers, 16 heads, ``d_model`` 1024) on ``BERT_BATCH``
    tokens, the last ``BERT_MASKED`` positions of two rows masked, no
    type ids (as ``examples/squad_bert.py`` passes none), span loss on
    random starts and ends, full coverage (96 Dense layers, ``qa_head``
    and 49 LayerNorms in six buckets, ``wte`` on the diagonal side path),
    ``BERT_STEPS`` steps with refreshes at 0 and ``BERT_CHECK_STEP``.
    Returns the kernel launches."""
    import torch.nn.functional as F

    model = getattr(kt.models, BERT_MODEL)(device=DEVICE, seed=0)
    cfg = model.config
    B, T = BERT_BATCH
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                           device=DEVICE)
    mask = torch.ones(B, T, dtype=torch.bool, device=DEVICE)
    mask[:2, T - BERT_MASKED:] = False
    starts, ends = torch.randint(0, T - BERT_MASKED, (2, B), generator=gen,
                                 device=DEVICE)

    def fwd_bwd():
        start, end = model(tokens, None, mask)
        loss = (F.cross_entropy(start, starts)
                + F.cross_entropy(end, ends)) / 2
        loss.backward()
        return loss.detach()

    run = train_path(torch, kt, 'bert', model, fwd_bwd, BERT_HP, BERT_STEPS,
                     BERT_CHECK_STEP, **BERT_FULL)
    precond = run['precond']
    n = cfg.n_layers
    if (len(precond.layers) != 2 + 6 * n + 1
            or precond.diag_layers != ('wte',)
            or tuple(precond.layers['wte'].a_factor.shape)
            != (cfg.vocab_size,)):
        fail(f'bert: {len(precond.layers)} layers, diagonal '
             f'{precond.diag_layers}')
    shapes = check_plan('bert', precond, BERT_CASES,
                        BERT_MODEL == 'bert_large')
    print(f'bert: {BERT_MODEL} (vocab {cfg.vocab_size}, {n} layers, '
          f'{cfg.n_heads} heads, d_model {cfg.d_model}, d_ff {cfg.d_ff}, '
          f'{cfg.dtype} compute), batch {B} x {T} tokens, last '
          f'{BERT_MASKED} masked in rows 0-1, full coverage: '
          f'{len(precond.layers)} layers, buckets (L, gp, ap) {shapes}, '
          f'diagonal side path {list(precond.diag_layers)}', flush=True)
    report_path('bert', run, BERT_STEPS,
                f'; the refresh step {BERT_CHECK_STEP} included')
    report_coverage('bert', precond, ['wpe'])
    launches = run['launches']
    del run, precond, model
    torch.cuda.empty_cache()
    return launches


#: Phase 22: streaming checkpoints on ResNet-50 (phase 9's widths and
#: batch, f32, TF32 off), a factor update every step and a refresh every
#: 4 (at 0 and 4).  The single-card run saves the generation after step
#: 2, trains to step 5 and saves again; a fresh model and preconditioner
#: restore (the second generation cut short, so the walk skips it) and
#: replay steps 3-5.
RN50_ELASTIC_HP = dict(RN50_HP, factor_update_steps=1, inv_update_steps=4)
RN50_ELASTIC_STEPS = 6
RN50_ELASTIC_SAVE = 3  # steps done at the save: the replay starts at 3
#: The resize: four spawned ranks on one card over gloo at MEM-OPT (1x4,
#: four columns; HYBRID-OPT at world 4 keeps the two columns of world 2,
#: so its restore would install the stacks as they are), frozen weights,
#: 8 images a rank, steps 0-1 (the bootstrap at 0, stagger shard 1 at 1),
#: then the save; ranks 0-1 restore at HYBRID-OPT (1x2) and run steps
#: 2-4: 2 and 3 through the transplanted stacks, 4 the next due refresh,
#: which the resize forces to the monolithic bootstrap (shard 0 of
#: ``stagger_refresh=2`` otherwise).
RN50_RESIZE_HP = dict(RN50_HP, factor_update_steps=1, inv_update_steps=4,
                      stagger_refresh=2)
RN50_RESIZE_SAVE = 2
RN50_RESIZE_STOP = 5
RN50_RESIZE_WORLDS = (4, 2)
RN50_RESIZE_TIMEOUT_S = 300
#: ``(model, classes)`` of phases 22-23 (a CPU rehearsal takes a smaller
#: one).
ELASTIC_MODEL = ('resnet50', 1000)


def elastic_model(torch, kt, hp, seed, optimizer=True):
    """ResNet-50 (``ELASTIC_MODEL``), SGD with momentum 0.9 and a
    preconditioner with ``hp``."""
    name, classes = ELASTIC_MODEL
    model = getattr(kt.models, name)(num_classes=classes, device=DEVICE,
                                     seed=seed)
    opt = (torch.optim.SGD(model.parameters(), lr=hp['lr'], momentum=0.9)
           if optimizer else None)
    return model, opt, kt.KFACPreconditioner(model, **hp)


def cuda_kernel_names(torch, prof) -> set:
    """Names of the CUDA kernels a profiler session saw, without their
    argument lists."""
    return {evt.name.replace('(anonymous namespace)::', '').split('(')[0]
            for evt in prof.events()
            if evt.device_type == torch.autograd.DeviceType.CUDA}


def profile_session(torch, fn):
    """``(fn's result, CUDA kernel names)`` from one ``torch.profiler``
    session of the card's activity only (an empty set off the card)."""
    from torch.profiler import ProfilerActivity, profile

    if DEVICE != 'cuda':
        return fn(), set()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, cuda_kernel_names(torch, prof)


def eigh_kernel_names(torch) -> set:
    """cuSOLVER's kernels of ``torch.linalg.eigh`` on the bucket sides'
    kind of input (a batch of 64-wide and one 1024-wide f32 SPD
    matrices), from the profiler: every kernel it launches but copies,
    memsets, PyTorch's own (``at::native``) and the BLAS (cuBLAS and
    CUTLASS GEMMs, which a plain step runs too)."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(9)
    mats = [torch.randn(2, 64, 96, generator=gen, device=DEVICE),
            torch.randn(1, 1024, 1536, generator=gen, device=DEVICE)]
    spd = [m @ m.mT for m in mats]
    _, names = profile_session(torch, lambda: [torch.linalg.eigh(a)
                                               for a in spd])
    generic = ('Memcpy', 'Memset', 'at::native', 'cublas', 'cutlass', 'gemm')
    return {n for n in names if not any(g in n for g in generic)}


def restored_kernel_check(torch, kt, precond, raw, group=None):
    """The fused kernel (the sharded form with a ``group``) against its
    plain version on the live stacks of every bucket that keeps ``dgda``,
    twice: with the raw gradient stacks ``raw``, and with unit-Gaussian
    gradients, phase 2's inputs, where ``rtol 1e-5, atol 1e-4`` binds on
    ``pg`` (``atol 1e-3`` on the clip terms, whose sums are larger);
    the launches are not counted.  Returns the largest absolute errors
    of ``pg`` and the largest ``|pg|`` of the plain version, for both:
    ``{'raw': (err, max_want), 'gauss': (err, max_want)}``."""
    from kfac_pytorch_tpu_torch.ops import fused_precond as fp

    kernel = kt.ops.fused_eigen_precondition
    count = kernel.launches
    so = precond._second_order
    gen = torch.Generator(device=precond.device)
    gen.manual_seed(23)
    out = {'raw': (0.0, 0.0), 'gauss': (0.0, 0.0)}
    for b in precond.plan.buckets:
        bs = precond.buckets[b.key]
        if bs.dgda is None:
            continue
        g_raw = so._grad_stack(b, raw).contiguous()
        g_unit = torch.randn(g_raw.shape, generator=gen,
                             device=precond.device)
        for kind, g, atol_clip in (('raw', g_raw, 1e-4),
                                   ('gauss', g_unit, 1e-3)):
            args = [t.contiguous() for t in (g, bs.qa, bs.qg, bs.dgda)]
            if group is None:
                got = kernel(*args)
                want = fp.fused_eigen_precondition_reference(*args)
            else:
                got = fp.fused_eigen_precondition_sharded(*args, group=group)
                want = fp.fused_eigen_precondition_sharded_reference(
                    *args, group=group)
            for g_, w, atol in zip(got, want, (1e-4, atol_clip)):
                if not torch.allclose(g_, w, rtol=1e-5, atol=atol):
                    fail(f'elastic: the kernel on the restored {b.key} '
                         f'stacks with {kind} gradients differs from its '
                         f'plain version by {float((g_ - w).abs().max()):.3e}'
                         f' (max |plain| {float(w.abs().max()):.3e})')
            err, top = out[kind]
            out[kind] = (max(err, float((got[0] - want[0]).abs().max())),
                         max(top, float(want[0].abs().max())))
    kernel.launches = count
    return out


def kernel_check_text(check) -> str:
    """:func:`restored_kernel_check`'s result as a phase line reads it."""
    return '; '.join(
        f'{kind} gradients max abs err {err:.3e} at max |pg| {top:.3e}'
        for kind, (err, top) in check.items())


def elastic_replay(torch, kt, workdir, x, y):
    """Restore the newest valid generation of ``workdir`` into a fresh
    model, SGD and preconditioner and replay steps ``RN50_ELASTIC_SAVE``
    to the end.  The restore and the first replayed step run in one
    profiler session with ``torch.linalg.eigh`` spied on; step 5 (no
    refresh) in another, the plain-step baseline.  Returns the final
    parameters, the first step's gradients and the checks."""
    import torch.nn.functional as F

    from kfac_pytorch_tpu_torch import elastic
    from kfac_pytorch_tpu_torch.engine import load_training_extras

    model, opt, precond = elastic_model(torch, kt, RN50_ELASTIC_HP, seed=1)
    kernel = kt.ops.fused_eigen_precondition
    out = {}
    eigh_calls = []
    real_eigh = torch.linalg.eigh

    def spy(*a, **k):
        eigh_calls.append(1)
        return real_eigh(*a, **k)

    def restore_and_first_step():
        t0 = time.perf_counter()
        info = elastic.restore_streaming(workdir, precond)
        load_training_extras(model, opt, info['extras'])
        if DEVICE == 'cuda':
            torch.cuda.synchronize()
        out['restore_s'] = time.perf_counter() - t0
        opt.zero_grad()
        F.cross_entropy(model(x), y).backward()
        raw = {n: h.get_grad().clone() for n, h in precond.helpers.items()}
        kernel.launches = 0
        precond.step()
        out['first_launches'] = kernel.launches
        out['grads'] = [p.grad.detach().clone() for p in model.parameters()]
        opt.step()
        return info, raw

    torch.cuda.synchronize()
    torch.linalg.eigh = spy
    try:
        (info, raw), out['restore_kernels'] = profile_session(
            torch, restore_and_first_step)
    finally:
        torch.linalg.eigh = real_eigh
    out['eigh_calls'] = len(eigh_calls)
    out['info'] = {k: v for k, v in info.items() if k != 'extras'}
    out['kernel_check'] = restored_kernel_check(torch, kt, precond, raw)
    launches = out['first_launches']
    for t in range(RN50_ELASTIC_SAVE + 1, RN50_ELASTIC_STEPS):
        opt.zero_grad()
        F.cross_entropy(model(x), y).backward()
        kernel.launches = 0
        precond.step()
        launches += kernel.launches
        opt.step()
    out['launches'] = launches
    out['params'] = [p.detach().clone() for p in model.parameters()]
    out['buckets'] = kernel_buckets(precond)
    # One monolithic refresh for scale (CUDA events).
    s, e = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    s.record()
    precond._refresh(precond.damping)
    e.record()
    e.synchronize()
    out['refresh_ms'] = s.elapsed_time(e)
    del model, opt, precond
    gc.collect()
    return out


def rn50_elastic_single(torch, kt, workdir):
    """Phase 22's single-card part: the uninterrupted run with its two
    saves, the second cut short, then :func:`elastic_replay`."""
    import torch.nn.functional as F

    from kfac_pytorch_tpu_torch import elastic
    from kfac_pytorch_tpu_torch.engine import training_extras

    x, y = rn50_batch(torch)
    y = y % ELASTIC_MODEL[1]
    model, opt, precond = elastic_model(torch, kt, RN50_ELASTIC_HP, seed=0)
    out = {}
    for t in range(RN50_ELASTIC_STEPS):
        opt.zero_grad()
        F.cross_entropy(model(x), y).backward()
        precond.step()
        if t == RN50_ELASTIC_SAVE:
            out['grads'] = [p.grad.detach().clone()
                            for p in model.parameters()]
        opt.step()
        if precond.steps == RN50_ELASTIC_SAVE:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen = elastic.save_streaming(
                workdir, precond, extras=training_extras(model, opt))
            out['save_s'] = time.perf_counter() - t0
            out['gen'] = gen
            out['bytes'] = elastic.generation_bytes(gen)
            out['shards'] = len(os.listdir(gen)) - 1
            print(f'resnet50 elastic: saved {out["bytes"]} bytes in '
                  f'{out["save_s"]:.3f} s', flush=True)
    out['params'] = [p.detach().clone() for p in model.parameters()]
    # The second save, cut short before its manifest: the generation
    # directory holds its first shard, truncated, as a save killed while
    # writing it leaves it (a whole second 1.5 GB save cost ~6 s).
    torn = os.path.join(workdir, f'gen-{precond.steps:08d}')
    os.makedirs(torn)
    shutil.copyfile(os.path.join(out['gen'], 'layers.npz'),
                    os.path.join(torn, 'layers.npz'))
    out['torn_files'] = kt.testing.corrupt_checkpoint(torn)
    out['torn'] = os.path.basename(torn)
    del model, opt, precond
    gc.collect()
    torch.cuda.empty_cache()
    out['eigh_kernels'] = eigh_kernel_names(torch)
    for attempt in range(3):
        replay = elastic_replay(torch, kt, workdir, x, y)
        print(f'resnet50 elastic: restored in {replay["restore_s"]:.3f} s',
              flush=True)
        if DEVICE != 'cuda' or any('precond_forward' in n for n in
                                   replay['restore_kernels']):
            break
        print(f'resnet50 elastic: profiler session {attempt} saw no fused '
              f'kernel ({len(replay["restore_kernels"])} kernels); '
              'replaying again', flush=True)
    else:
        fail('resnet50 elastic: three profiler sessions of the restore saw '
             'no fused kernel')
    return out, replay


def elastic_rank(rank, world, backend, device_type, workdir, image, batch,
                 model_name):
    """One rank of phase 22's resize; writes ``resize{rank}.pt``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    import kfac_pytorch_tpu_torch as kt
    from kfac_pytorch_tpu_torch import elastic
    from kfac_pytorch_tpu_torch.parallel.bucketing import signature_slot_map

    def device():
        if device_type != 'cuda':
            return torch.device('cpu')
        dev = torch.device(
            'cuda',
            rank % torch.cuda.device_count() if backend == 'nccl' else 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return dev

    def sync():
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)

    def engine(w, strategy):
        model = getattr(kt.models, model_name[0])(
            num_classes=model_name[1], device=dev, seed=0)
        ddp = torch.nn.parallel.DistributedDataParallel(
            model, device_ids=None if dev.index is None else [dev.index])
        return ddp, kt.KFACPreconditioner(
            ddp, grad_worker_fraction=strategy, **RN50_RESIZE_HP)

    def local(w):
        gen = torch.Generator(device=dev)
        gen.manual_seed(3)
        x = torch.randn(batch, 3, image, image, generator=gen, device=dev)
        y = torch.randint(0, model_name[1], (batch,), generator=gen,
                          device=dev)
        q = batch // w
        return x[rank * q:(rank + 1) * q], y[rank * q:(rank + 1) * q]

    dev = device()
    save_world, restore_world = RN50_RESIZE_WORLDS
    gen_dir = os.path.join(workdir, 'gens')
    dist.init_process_group(
        backend, init_method=f'file://{workdir}/pg_a', rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=240))
    ddp, precond = engine(save_world, kt.DistributedStrategy.MEM_OPT)
    xl, yl = local(save_world)
    for _ in range(RN50_RESIZE_SAVE):
        ddp.zero_grad()
        F.cross_entropy(ddp(xl), yl).backward()
        precond.step()
    sync()
    t0 = time.perf_counter()
    gen = elastic.save_streaming(gen_dir, precond)
    rec = dict(save_s=time.perf_counter() - t0,
               saved_grid=(precond.grid.rows, precond.grid.cols))
    del ddp, precond
    dist.barrier()
    dist.destroy_process_group()
    if rank >= restore_world:
        torch.save(rec, os.path.join(workdir, f'resize{rank}.pt'))
        return
    dist.init_process_group(
        backend, init_method=f'file://{workdir}/pg_b', rank=rank,
        world_size=restore_world, timeout=datetime.timedelta(seconds=240))
    ddp, precond = engine(restore_world, kt.DistributedStrategy.HYBRID_OPT)
    sync()
    t0 = time.perf_counter()
    info = elastic.restore_streaming(gen_dir, precond)
    sync()
    rec['restore_s'] = time.perf_counter() - t0
    rec['info'] = {k: v for k, v in info.items() if k != 'extras'}
    rec['grid'] = (precond.grid.rows, precond.grid.cols)
    rec['flags'] = (precond._stagger_bootstrapped,
                    precond._iter_bootstrapped,
                    precond._overlap_bootstrapped)
    # The restacked EMAs and the transplanted slots of this rank's
    # column against the saved per-layer values, bit for bit.
    meta, shards = elastic._load_generation(gen)
    saved_sig = meta['topology']['signature']
    slot_of = signature_slot_map(saved_sig)
    saved_pads = {b['key']: sum(n is None for n in b['slots'])
                  for b in saved_sig['buckets']}
    layers = shards['layers.npz']
    rec['factors_bitwise'] = all(
        np.array_equal(st.a_factor.cpu().numpy(),
                       layers[f'{n}::a_factor'])
        and np.array_equal(st.g_factor.cpu().numpy(),
                           layers[f'{n}::g_factor'])
        for n, st in precond.layers.items())
    slots = dict(occupied=0, bitwise=0, pads=0, donated=0, synthesized=0)
    for b in precond.plan.buckets:
        saved = shards[f'bucket-{b.key}.npz']
        live = precond.buckets[b.key].stack_fields()
        for i, name in enumerate(b.column_slots(precond.grid.col)):
            if name is None:
                slots['pads'] += 1
                slots['donated' if saved_pads[b.key] else 'synthesized'] += 1
                continue
            _, oslot = slot_of[name]
            slots['occupied'] += 1
            slots['bitwise'] += all(
                np.array_equal(t[i].cpu().numpy(), saved[f][oslot])
                for f, t in live.items())
    rec['slots'] = slots
    rec['saved_slots'] = sum(len(b['slots']) for b in saved_sig['buckets'])
    rec['live_slots'] = sum(b.n_slots for b in precond.plan.buckets)
    del shards, layers
    kernel = kt.ops.fused_eigen_precondition
    xl, yl = local(restore_world)
    rec['refresh'] = []
    launches = 0
    for t in range(RN50_RESIZE_SAVE, RN50_RESIZE_STOP):
        ddp.zero_grad()
        F.cross_entropy(ddp(xl), yl).backward()
        raw = {n: h.get_grad().clone() for n, h in precond.helpers.items()}
        kernel.launches = 0
        precond.step()
        launches += kernel.launches
        rec['refresh'].append(precond.last_refresh)
        if t == RN50_RESIZE_SAVE:
            rec['kernel_check'] = restored_kernel_check(
                torch, kt, precond, raw, group=precond.grid.row_group)
    sync()
    rec['launches'] = launches
    rec['buckets'] = kernel_buckets(precond)
    torch.save(rec, os.path.join(workdir, f'resize{rank}.pt'))
    dist.barrier()
    dist.destroy_process_group()


def phase_resnet50_elastic(torch, kt, ranks=None):
    """Phase 22: streaming checkpoints (budget 45 s; ``ranks``: the
    resize ranks' reports from :func:`spawn_shared`, or a function that
    waits for them, called after the single-card part).  Single card: the
    replay from the generation saved after step 2 ends bitwise equal to
    the uninterrupted run (parameters after step 5 and the first replayed
    step's preconditioned gradients, cuDNN deterministic); the walk skips
    the cut-short newer generation and names it; between the restore and
    the first replayed step no ``torch.linalg.eigh`` call and none of
    the kernels ``eigh`` launches (:func:`eigh_kernel_names`) runs, while
    the fused kernel does, 21 launches, and matches its plain version on the restored
    stacks (:func:`restored_kernel_check`).  Resize: world 4 at MEM-OPT saves, world 2 at HYBRID-OPT
    restores: every occupied slot of each rank's column and every factor
    EMA bitwise the saved values, the bootstrap flags down, steps 2-3
    through the transplanted stacks with the sharded kernel (21 launches
    a step a rank, held against its plain version through the row), step
    4 the forced monolithic refresh.  Returns the launches of both."""
    from kfac_pytorch_tpu_torch.parallel.mesh import default_backend

    label = 'resnet50 elastic'
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory(prefix='elastic_') as workdir:
            full, replay = rn50_elastic_single(torch, kt, workdir)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    per_step = replay['buckets'] if DEVICE == 'cuda' else 0
    if DEVICE == 'cuda' and ELASTIC_MODEL[0] == 'resnet50' and per_step != 21:
        fail(f'{label}: {per_step} buckets keep dgda, not 21')
    info = replay['info']
    if not (info['generation'] == f'gen-{RN50_ELASTIC_SAVE:08d}'
            and [s['generation'] for s in info['skipped']] == [full['torn']]
            and info['decompositions_installed'] and not info['recomputed']
            and not info['resized']):
        fail(f'{label}: restore info {info}')
    if not all(torch.equal(a, b) for a, b in zip(full['params'],
                                                 replay['params'])):
        fail(f'{label}: the replayed parameters differ from the '
             'uninterrupted run\'s')
    if not all(torch.equal(a, b) for a, b in zip(full['grads'],
                                                 replay['grads'])):
        fail(f'{label}: the first replayed step\'s preconditioned '
             'gradients differ from the uninterrupted run\'s')
    if replay['first_launches'] != per_step or replay['launches'] != (
            RN50_ELASTIC_STEPS - RN50_ELASTIC_SAVE) * per_step:
        fail(f'{label}: launches {replay["first_launches"]} on the first '
             f'replayed step, {replay["launches"]} in all')
    solver = full['eigh_kernels']
    seen = solver & replay['restore_kernels']
    if replay['eigh_calls'] or seen or (DEVICE == 'cuda' and not solver):
        fail(f'{label}: between the restore and the first replayed step '
             f'{replay["eigh_calls"]} eigh calls and decomposition kernels '
             f'{sorted(seen)} (eigh\'s kernels: {sorted(solver)})')
    print(f'{label}: ResNet-50 batch {RN50_BATCH} at {RN50_IMAGE}x'
          f'{RN50_IMAGE}, factor 1, inv 4; generation after step '
          f'{RN50_ELASTIC_SAVE - 1}: {full["bytes"]} bytes in '
          f'{full["shards"]} files (counted by its manifest), save '
          f'{full["save_s"]:.3f} s; restore {replay["restore_s"]:.3f} s '
          f'(walk, CRC checks, install, model and SGD state loaded; '
          f'skipped {info["skipped"][0]["generation"]}: '
          f'{info["skipped"][0]["error"][:80]}); replayed steps '
          f'{RN50_ELASTIC_SAVE}-{RN50_ELASTIC_STEPS - 1} bitwise the '
          f'uninterrupted run (parameters, first-step gradients); '
          f'{replay["eigh_calls"]} eigh calls and no decomposition kernel '
          f'between the restore and the first replayed step (of the '
          f'{len(solver)} eigh launches: {sorted(solver)[:4]}...); '
          f'fused kernel launches {replay["first_launches"]} on that step, '
          f'{replay["launches"]} in the replay, against its plain version '
          f'on the restored stacks: '
          f'{kernel_check_text(replay["kernel_check"])}; one monolithic '
          f'refresh {replay["refresh_ms"]:.3f} ms (CUDA events)', flush=True)
    single_launches = replay['launches']
    checks = [replay['kernel_check']]
    del full, replay
    gc.collect()
    torch.cuda.empty_cache()

    world = RN50_RESIZE_WORLDS[0]
    backend = default_backend(world) if DEVICE == 'cuda' else 'gloo'
    if ranks is None:
        ranks = spawn_alone(torch, '22')
    elif callable(ranks):
        ranks = ranks()
    label = 'resnet50 resize'
    restored = ranks[:RN50_RESIZE_WORLDS[1]]
    steps = RN50_RESIZE_STOP - RN50_RESIZE_SAVE
    for i, r in enumerate(restored):
        s = r['slots']
        if not (r['info']['resized'] and not r['info']['recomputed']
                and r['saved_grid'] == (1, 4) and r['grid'] == (1, 2)
                and r['flags'] == (False, False, False)
                and r['factors_bitwise'] and s['bitwise'] == s['occupied']
                and r['refresh'] == [None, None, 'full']):
            fail(f'{label} rank {i}: {r}')
        if DEVICE == 'cuda' and r['launches'] != steps * r['buckets']:
            fail(f'{label} rank {i}: {r["launches"]} launches, expected '
                 f'{steps} x {r["buckets"]}')
    occupied = sum(r['slots']['occupied'] for r in restored)
    print(f'{label}: world {world} MEM-OPT (1x4) saved after step '
          f'{RN50_RESIZE_SAVE - 1} in {ranks[0]["save_s"]:.3f} s (rank 0 '
          f'writes after the row gathers); world {RN50_RESIZE_WORLDS[1]} '
          f'HYBRID-OPT (1x2) restored in '
          f'{[round(r["restore_s"], 3) for r in restored]} s; '
          f'{ranks[0]["saved_slots"]} saved slots -> '
          f'{restored[0]["live_slots"]} live: {occupied} occupied slots '
          f'transplanted bitwise, pads per rank '
          f'{[r["slots"]["pads"] for r in restored]} (donated '
          f'{[r["slots"]["donated"] for r in restored]}, synthesized '
          f'{[r["slots"]["synthesized"] for r in restored]}); factor EMAs '
          f'bitwise; bootstrap flags down; refreshes at steps '
          f'{RN50_RESIZE_SAVE}-{RN50_RESIZE_STOP - 1}: '
          f'{restored[0]["refresh"]}; sharded kernel launches '
          f'{[r["launches"] for r in restored]} ({steps} steps x '
          f'{restored[0]["buckets"]} buckets a rank), against its plain '
          f'version through the row on the transplanted stacks: '
          + ' / '.join(kernel_check_text(r['kernel_check'])
                       for r in restored), flush=True)
    checks += [r['kernel_check'] for r in restored]
    return (single_launches + sum(r['launches'] for r in restored),
            max(err for c in checks for err, _ in c.values()))


#: Phase 23: the trajectory watchdog on ResNet-50 (phase 22's widths,
#: factor 1, inv 4), fed by ``train_loop``: a check every 2 steps over a
#: window of 4, a generation every 4 steps, stamped ``healthy`` after 4
#: clean steps beyond it.  The fault: every factor EMA times 1e-4
#: (``testing.poison_factors``, finite) just before the refresh of step 8,
#: once (a replay after the rollback does not meet it again): ``vg_sum``
#: jumps ~30x, the check at step 10 softens (rung 1), the one at 12 rolls
#: back (rung 2) onto gen-4, the newest stamped generation.  A bad-data
#: span (``testing.bad_batch_span``) moves neither the loss nor
#: ``vg_sum`` here: inputs x 50 are normalized away by the first
#: BatchNorm, and shuffled labels move the loss by under 20%.
RN50_WATCH_HP = dict(RN50_HP, factor_update_steps=1, inv_update_steps=4)
RN50_WATCH = dict(window=4, check_every=2, save_every=4, clearance=4,
                  retain=3)
RN50_WATCH_POISON = (8, 1e-4)  # (step, scale)
RN50_WATCH_FIRST = 12  # the first pass ends at the rollback's check
RN50_WATCH_STEPS = 10  # the replay from gen-4 ends here
#: The two-rank part: CIFAR ResNet-32 at 64 images a rank over gloo on
#: the one card; rank 0 feeds its loss times 1e5 at the check of step 6.
WATCH_RANK_STEPS = 8
WATCH_RANK_SPIKE = 6
WATCH_RANK_TIMEOUT_S = 180


def watchdog_snapshot(precond, extras):
    """Clones of what a generation holds: factor EMAs, stack fields and
    the caller's extras."""
    return dict(
        factors={n: (st.a_factor.clone(), st.g_factor.clone())
                 for n, st in precond.layers.items()},
        stacks={k: {f: t.clone() for f, t in bs.stack_fields().items()}
                for k, bs in precond.buckets.items()},
        extras={k: v.detach().clone() for k, v in extras.items()})


def watchdog_landing(torch, precond, model, opt, snap) -> dict:
    """Which parts of the live state equal ``snap`` bit for bit."""
    from kfac_pytorch_tpu_torch.engine import training_extras

    live = training_extras(model, opt)
    return dict(
        factors=all(torch.equal(precond.layers[n].a_factor, a)
                    and torch.equal(precond.layers[n].g_factor, g)
                    for n, (a, g) in snap['factors'].items()),
        stacks=all(torch.equal(precond.buckets[k].stack_fields()[f], t)
                   for k, fields in snap['stacks'].items()
                   for f, t in fields.items()),
        model_and_sgd=set(live) == set(snap['extras']) and all(
            torch.equal(live[k], v) for k, v in snap['extras'].items()))


def watchdog_rank(rank, world, backend, device_type, workdir):
    """One rank of phase 23's two-rank part; writes ``watch{rank}.pt``."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    import kfac_pytorch_tpu_torch as kt

    if device_type == 'cuda':
        dev = torch.device(
            'cuda',
            rank % torch.cuda.device_count() if backend == 'nccl' else 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device('cpu')
    dist.init_process_group(
        backend, init_method=f'file://{workdir}/pg_init', rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    gen = torch.Generator(device=dev)
    gen.manual_seed(10 + rank)  # each rank its own local batch
    x = torch.randn(BATCH // 2, 3, 32, 32, generator=gen, device=dev)
    y = torch.randint(0, 10, (BATCH // 2,), generator=gen, device=dev)
    model = kt.models.resnet32(device=dev, seed=0)
    ddp = torch.nn.parallel.DistributedDataParallel(
        model, device_ids=None if dev.index is None else [dev.index])
    precond = kt.KFACPreconditioner(
        ddp, watchdog=kt.WatchdogConfig(window=4, check_every=2,
                                        rollback_after=1, park_after=3),
        **TRAIN_HP)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    step = precond.make_train_step(opt, F.cross_entropy)
    rec = dict(rungs=[], losses=[])
    for t in range(WATCH_RANK_STEPS):
        loss, _ = step(x, loss_args=(y,))
        fed = loss * (1e5 if rank == 0 and t + 1 == WATCH_RANK_SPIKE
                      else 1.0)
        precond.watchdog_step(fed)
        rec['rungs'].append(int(precond.last_step_info['watchdog/rung']))
        rec['losses'].append(float(loss))
    w = precond.watchdog
    rec.update(checks=w.totals['checks'], all_reduces=w.all_reduces,
               host_syncs=w.host_syncs, totals=dict(w.totals))
    torch.save(rec, os.path.join(workdir, f'watch{rank}.pt'))
    dist.barrier()
    dist.destroy_process_group()


def phase_resnet50_watchdog(torch, kt, ranks=None):
    """Phase 23 (``ranks``: the two ranks' reports from
    :func:`spawn_shared`, or a function that waits for them, called after
    the ResNet-50 run): the trajectory watchdog (budget 45 s), the fault of
    ``RN50_WATCH_POISON``.  Gates: the first
    dirty check at step 10 (rung 1, damping and kl-clip softened), the
    next at 12 (rung 2) rolling back onto the newest ``healthy``
    generation (gen-4) with the factor EMAs, the stacks, the model and
    SGD state bitwise as saved; re-entry at 10x the damping and 0.1x the
    kl-clip of the saved run; the replay clean, 21 kernel launches each
    of its steps; one host read per check, no all-reduce at world 1.
    Two ranks (ResNet-32, gloo) with different local losses, rank 0's
    spiking: the same rungs on both, rung 1 at the spike's check, one
    all-reduce per check.  Returns the launches of the ResNet-50 run."""
    import torch.nn.functional as F

    from kfac_pytorch_tpu_torch import elastic
    from kfac_pytorch_tpu_torch.parallel.mesh import default_backend

    label = 'resnet50 watchdog'
    kernel = kt.ops.fused_eigen_precondition
    x, y = rn50_batch(torch)
    y = y % ELASTIC_MODEL[1]
    poison_at, scale = RN50_WATCH_POISON
    saved = {}
    real_save = elastic.save_streaming

    def spy(directory, p, **kw):
        path = real_save(directory, p, **kw)
        saved[p.steps] = watchdog_snapshot(p, kw['extras'])
        return path

    with tempfile.TemporaryDirectory(prefix='watchdog_') as save_dir:
        cfg = kt.WatchdogConfig(save_dir=save_dir, **RN50_WATCH)
        model, opt, precond = elastic_model(
            torch, kt, dict(RN50_WATCH_HP, watchdog=cfg), seed=0)
        loop = precond.train_loop(opt, F.cross_entropy)
        elastic.save_streaming = spy
        log, rolled, landing, reentry = [], None, None, None
        replay_steps = replay_launches = 0
        torch.cuda.synchronize()
        kernel.launches = 0
        try:
            while len(log) < 40 and precond.steps < (
                    RN50_WATCH_FIRST if rolled is None else RN50_WATCH_STEPS):
                t = precond.steps
                if t == poison_at and rolled is None:
                    kt.testing.poison_factors(
                        precond, tuple(precond.layers), scale=scale)
                before = kernel.launches
                loss, _ = loop.step(x, loss_args=(y,))
                info = precond.last_step_info
                log.append(dict(step=t + 1, loss=float(loss),
                                vg_sum=float(info['vg_sum']),
                                checked=int(info['watchdog/checked']),
                                dirty=int(info['watchdog/dirty']),
                                rung=int(info['watchdog/rung'])))
                if rolled is not None:
                    replay_steps += 1
                    replay_launches += kernel.launches - before
                if loop.last_rollback is not None and rolled is None:
                    rolled = loop.last_rollback
                    landing = watchdog_landing(
                        torch, precond, model, opt,
                        saved[rolled['target_step']])
                    reentry = (precond._damping, precond._kl_clip)
            torch.cuda.synchronize()
            launches = kernel.launches
            stamps = [(os.path.basename(g), s) for g, s in
                      elastic.list_generations(save_dir, stamps=True)]
        finally:
            elastic.save_streaming = real_save
        w = precond.watchdog
        per_step = kernel_buckets(precond) if DEVICE == 'cuda' else 0
        host_syncs, all_reduces, totals = (w.host_syncs, w.all_reduces,
                                           dict(w.totals))
        del loop, model, opt, precond, saved
        gc.collect()
        torch.cuda.empty_cache()
    checks = [e for e in log if e['checked']]
    dirty = [e for e in checks if e['dirty']]
    hp = RN50_WATCH_HP
    if not (rolled is not None and dirty and dirty[0]['step'] == 10
            and dirty[0]['rung'] == 1 and len(dirty) >= 2
            and dirty[1]['step'] == 12 and dirty[1]['rung'] == 2
            and rolled['target_step'] == 4
            and rolled['health_stamp'] == 'healthy'):
        fail(f'{label}: checks {checks}, rollback {rolled}')
    if not all(landing.values()):
        fail(f'{label}: the landing on {rolled["generation"]} is not bitwise: '
             f'{landing}')
    want = (hp['damping'] * cfg.soften_damping,
            hp['kl_clip'] * cfg.soften_kl_clip)
    if reentry != want:
        fail(f'{label}: re-entry damping and kl-clip {reentry}, expected '
             f'{want}')
    if any(e['dirty'] for e in checks[len(checks) - replay_steps // 2:]):
        fail(f'{label}: a dirty check in the replay: {checks}')
    if DEVICE == 'cuda' and (per_step != 21 or replay_launches != (
            replay_steps * per_step) or launches != len(log) * per_step):
        fail(f'{label}: launches {launches} over {len(log)} steps, '
             f'{replay_launches} over the {replay_steps} replayed steps, '
             f'{per_step} a step')
    if host_syncs != totals['checks'] or all_reduces != 0:
        fail(f'{label}: {host_syncs} host reads and {all_reduces} '
             f'all-reduces over {totals["checks"]} checks')
    vgs = [float(f'{e["vg_sum"]:.4g}') for e in log[:12]]
    print(f'{label}: ResNet-50 batch {RN50_BATCH}, train_loop with SGD '
          f'momentum, watchdog {RN50_WATCH}; factor EMAs x{scale} before '
          f'step {poison_at}: vg_sum {vgs}; '
          f'detected at the '
          f'check of step {dirty[0]["step"]} (rung {dirty[0]["rung"]}, '
          f'soften), rung {dirty[1]["rung"]} at step {dirty[1]["step"]}: '
          f'rolled back onto '
          f'{rolled["generation"]} (stamp {rolled["health_stamp"]}), bitwise '
          f'{landing}; re-entry damping {reentry[0]:.6g} kl-clip '
          f'{reentry[1]:.6g}; {replay_steps} replayed steps, clean, '
          f'{replay_launches} fused launches in them ({launches} in the '
          f'run); generations {stamps}; totals {totals}; host reads '
          f'{host_syncs} = checks, all-reduces {all_reduces} (world 1)',
          flush=True)

    backend = default_backend(2) if DEVICE == 'cuda' else 'gloo'
    if ranks is None:
        ranks = spawn_alone(torch, '23')
    elif callable(ranks):
        ranks = ranks()
    label = 'watchdog ranks'
    r0, r1 = ranks
    if not (r0['rungs'] == r1['rungs'] and r0['totals'] == r1['totals']
            and r0['rungs'][WATCH_RANK_SPIKE - 1] == 1
            and r0['losses'] != r1['losses']):
        fail(f'{label}: rungs {r0["rungs"]} vs {r1["rungs"]}, totals '
             f'{r0["totals"]} vs {r1["totals"]}')
    for r in ranks:
        if not r['all_reduces'] == r['host_syncs'] == r['checks']:
            fail(f'{label}: {r["all_reduces"]} all-reduces, '
                 f'{r["host_syncs"]} host reads, {r["checks"]} checks')
    print(f'{label}: ResNet-32, 2 ranks over {backend}, {BATCH // 2} images '
          f'a rank (local losses differ: rank 0 '
          f'{[round(v, 4) for v in r0["losses"][:3]]}, rank 1 '
          f'{[round(v, 4) for v in r1["losses"][:3]]}); rank 0 fed its loss '
          f'x 1e5 at step {WATCH_RANK_SPIKE}: rungs on both ranks '
          f'{r0["rungs"]}; {r0["checks"]} checks, {r0["all_reduces"]} '
          f'all-reduces and {r0["host_syncs"]} host reads on each rank',
          flush=True)
    return launches


#: Phase 24: observe and flight on ImageNet ResNet-50 (phase 9's widths
#: and batch, f32, TF32 off): factor 1, inv 3, kl-clip 0.001, 7 steps a
#: run, refreshes at steps 0, 3 and 6; the flight recorder flushes after
#: step 3 (``flush_every=4``).  Steps 3-4 run under ``torch.profiler`` in
#: both runs (the refresh of step 3 and the flush after it inside the
#: window; a refresh's ``eigh`` alone is ~48,000 CUDA kernels).
RN50_OBS_HP = dict(RN50_HP, factor_update_steps=1, inv_update_steps=3)
RN50_OBS_STEPS = 7
RN50_OBS_WINDOW = (3, 5)
RN50_OBS_FLIGHT = dict(window=8, flush_every=4)
OBSERVE_MODEL = ('resnet50', 1000)
#: The fused kernel's CUDA kernels, by a part of their names.
FUSED_KERNEL_NAMES = ('precond_forward', 'precond_back', 'wide_pass')


def kernel_ranges(trace_path, prefix='kfac/'):
    """``[(kernel name, [enclosing range names])]`` of every CUDA kernel
    of a ``torch.profiler`` chrome trace: a kernel is inside a
    ``record_function`` range when the host call that launched it (the
    CUDA API event of its correlation id) lies inside the range on the
    same thread."""
    with open(trace_path) as fh:
        events = json.load(fh)['traceEvents']
    ranges = [e for e in events if e.get('cat') == 'user_annotation'
              and e.get('name', '').startswith(prefix)]
    launches = {e['args']['correlation']: e for e in events
                if e.get('cat') in ('cuda_runtime', 'cuda_driver')
                and 'correlation' in e.get('args', {})}
    out = []
    for k in events:
        if k.get('cat') != 'kernel':
            continue
        host = launches.get(k.get('args', {}).get('correlation'))
        inside = [] if host is None else [
            r['name'] for r in ranges
            if r['tid'] == host['tid'] and r['pid'] == host['pid']
            and r['ts'] <= host['ts'] <= r['ts'] + r['dur']]
        name = k['name'].replace('(anonymous namespace)::', '')
        out.append((name.split('(')[0], inside))
    return out


def trace_host_reads(trace_path) -> dict:
    """Device-to-host copies and ``cudaDeviceSynchronize`` calls of a
    chrome trace: the host reads a window made."""
    with open(trace_path) as fh:
        events = json.load(fh)['traceEvents']
    return dict(
        dtoh=sum(1 for e in events if e.get('cat') == 'gpu_memcpy'
                 and 'DtoH' in e.get('name', '')),
        device_syncs=sum(1 for e in events if e.get('cat') == 'cuda_runtime'
                         and e.get('name') == 'cudaDeviceSynchronize'),
    )


def observe_run(torch, kt, observe, workdir):
    """One 7-step ResNet-50 run through ``train_loop`` (SGD momentum 0.9,
    cuDNN deterministic); with ``observe`` also the flight recorder, and a
    spy on the last step's precondition that keeps its raw combined
    gradients, factor EMAs and stacks.  Steps in ``RN50_OBS_WINDOW`` run
    under the profiler (trace in ``workdir``).  Returns the parameters,
    the last step's gradients, the step times, the kernel launches, the
    trace's path and, observed, the engine."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from kfac_pytorch_tpu_torch.observe import FlightConfig

    name, classes = OBSERVE_MODEL
    model = getattr(kt.models, name)(num_classes=classes, device=DEVICE,
                                     seed=0)
    x, y = rn50_batch(torch)
    y = y % classes
    flight = None if observe is None else FlightConfig(
        path=os.path.join(workdir, 'postmortem.json'), **RN50_OBS_FLIGHT)
    precond = kt.KFACPreconditioner(model, observe=observe, flight=flight,
                                    **RN50_OBS_HP)
    opt = torch.optim.SGD(model.parameters(), lr=RN50_OBS_HP['lr'],
                          momentum=0.9)
    loop = precond.train_loop(opt, F.cross_entropy)
    out = {'step_s': []}
    if observe is not None:
        real = precond._precondition

        def spy(*a, **k):
            if precond.steps == RN50_OBS_STEPS - 1:
                out['raw'] = {n: h.get_grad().clone()
                              for n, h in precond.helpers.items()}
                out['factors'] = {n: (st.a_factor.clone(),
                                      st.g_factor.clone())
                                  for n, st in precond.layers.items()}
                out['stacks'] = dict(precond.buckets)
            return real(*a, **k)

        precond._precondition = spy
    kernel = kt.ops.fused_eigen_precondition
    trace = os.path.join(workdir, f'trace_{"on" if observe else "off"}.json')
    prof = None
    torch.cuda.synchronize()
    kernel.launches = 0
    for t in range(RN50_OBS_STEPS):
        if t == RN50_OBS_WINDOW[0] and DEVICE == 'cuda':
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        loop.step(x, loss_args=(y,))
        torch.cuda.synchronize()
        out['step_s'].append(time.perf_counter() - t0)
        if t == RN50_OBS_WINDOW[1] - 1 and prof is not None:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(trace)
            out['trace'] = trace
    out['launches'] = kernel.launches
    out['params'] = [p.detach().clone() for p in model.parameters()]
    out['grads'] = [p.grad.detach().clone() for p in model.parameters()]
    out['buckets'] = kernel_buckets(precond)
    if observe is None:
        del loop, model, opt, precond
    else:
        out.update(precond=precond, model=model, x=x, y=y)
        precond.flight.disarm()
    gc.collect()
    return out


def observe_plain_check(torch, kt, on):
    """The last step's ``observe/kl_nu`` and ``observe/precond_grad_norm``
    against the plain version on the same stacks and raw gradients:
    ``(kl_nu error, norm error, max |pg|, the plain scale)``, relative."""
    from kfac_pytorch_tpu_torch import ops
    from kfac_pytorch_tpu_torch.ops import fused_precond as fp

    precond, raw, stacks = on['precond'], on['raw'], on['stacks']
    so = precond._second_order
    hp = RN50_OBS_HP
    terms, pgs = [], []
    for b in precond.plan.buckets:
        bs = stacks[b.key]
        g = so._grad_stack(b, raw).contiguous()
        pg, clip = fp.fused_eigen_precondition_reference(g, bs.qa, bs.qg,
                                                         bs.dgda)
        terms.append(torch.sum(clip) * hp['lr'] ** 2)
        for i, name in enumerate(b.slots):
            if name is not None:
                go, ga = raw[name].shape
                pgs.append(pg[i, :go, :ga])
    scale = ops.kl_clip_scale(terms, hp['kl_clip'])
    sq = sum(torch.sum((p * scale) ** 2) for p in pgs)
    sq = sq + sum(torch.sum(p.grad.float() ** 2)
                  for p in precond._uncovered_params)
    info = precond.last_step_info
    nu, norm = float(info['observe/kl_nu']), float(
        info['observe/precond_grad_norm'])
    want_nu, want_norm = float(scale), float(torch.sqrt(sq))
    top = max(float(p.abs().max()) for p in pgs)
    return (abs(nu - want_nu) / abs(want_nu),
            abs(norm - want_norm) / abs(want_norm), top, want_nu)


def observe_spectrum_check(torch, on):
    """``observe/kron_min``/``kron_max`` against the float64 ``eigvalsh``
    of the factor EMAs the last refresh decomposed (a prediv bucket's
    Kronecker spectrum is ``da_i dg_j``): ``(errors relative to the
    largest eigenvalue, the gate, the f64 extremes)``."""
    lo = hi = None
    n = 0
    for a, g in on['factors'].values():
        da = torch.linalg.eigvalsh(a.double()).clamp(min=0.0)
        dg = torch.linalg.eigvalsh(g.double()).clamp(min=0.0)
        n = max(n, a.shape[-1], g.shape[-1])
        lo_l, hi_l = float(da[0] * dg[0]), float(da[-1] * dg[-1])
        lo = lo_l if lo is None else min(lo, lo_l)
        hi = hi_l if hi is None else max(hi, hi_l)
    info = on['precond'].last_step_info
    got_lo, got_hi = (float(info['observe/kron_min']),
                      float(info['observe/kron_max']))
    gate = eigen_gate(n)
    return ((abs(got_lo - lo) / hi, abs(got_hi - hi) / hi), gate,
            (lo, hi), (got_lo, got_hi))


def observe_bucket_diagnosis(torch, on) -> dict:
    """Per bucket: the monitor's Kronecker maximum, the f64 one of its
    layers, and per side the eigenpairs the support mask keeps against
    the logical dims (a failure's evidence)."""
    from kfac_pytorch_tpu_torch.observe import monitor

    precond = on['precond']
    so = precond._second_order
    out = {}
    for b in precond.plan.buckets:
        bs = on['stacks'][b.key]
        _, st = so._bucket_stats(b, bs)
        a_dims, g_dims, occ = so._monitor_masks(b)
        f64 = 0.0
        for name in b.slots:
            if name is not None:
                a, g = on['factors'][name]
                f64 = max(f64, float(torch.linalg.eigvalsh(a.double())[-1]
                                     * torch.linalg.eigvalsh(g.double())[-1]))
        out[b.key] = dict(
            kron_max=float(st['kron_max']), f64=f64,
            a_kept=monitor.support_mask(bs.qa, a_dims).sum(-1).tolist(),
            a_dims=a_dims.tolist(),
            g_kept=monitor.support_mask(bs.qg, g_dims).sum(-1).tolist(),
            g_dims=g_dims.tolist())
    return out


def phase_resnet50_observe(torch, kt):
    """Phase 24: observe and flight on ResNet-50 (budget 45 s).  Off and
    on (``ObserveConfig(monitor=True, annotate=True, timeline=True)``,
    ``FlightConfig(window=8, flush_every=4)``), 7 steps each: (a)
    parameters and the last step's preconditioned gradients bitwise
    equal; (b) ``observe/kl_nu`` and ``observe/precond_grad_norm`` within
    1e-5 of the plain version's on the same stacks and raw gradients; (c)
    the Kronecker extremes within the eigen gate of a float64
    ``eigvalsh`` of the factor EMAs the last refresh decomposed; (d)
    under the profiler (steps 3-4), every fused-kernel launch inside
    ``kfac/precondition`` and every kernel of ``eigh``
    (:func:`eigh_kernel_names`) inside ``kfac/eigh_refresh``; (e) on the
    same window, observe-on adds one ``cudaDeviceSynchronize`` a step (the
    timeline) and the flight recorder one device-to-host copy per flush,
    nothing else; (f) ``profile_phases`` and the on-against-off step
    delta.  Returns the on run's launches."""
    from kfac_pytorch_tpu_torch.observe import ObserveConfig
    from kfac_pytorch_tpu_torch.observe import timeline

    import torch.nn.functional as F

    label = 'resnet50 observe'
    marks = [('start', time.perf_counter())]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory(prefix='observe_') as workdir:
            off = observe_run(torch, kt, None, workdir)
            marks.append(('off run', time.perf_counter()))
            on = observe_run(torch, kt, ObserveConfig(
                monitor=True, annotate=True, timeline=True), workdir)
            marks.append(('on run', time.perf_counter()))
            eigh_names = eigh_kernel_names(torch) if DEVICE == 'cuda' else set()
            attributed = (kernel_ranges(on['trace'])
                          if 'trace' in on else [])
            reads = ((trace_host_reads(off['trace']),
                      trace_host_reads(on['trace']))
                     if 'trace' in on else None)
            marks.append(('traces', time.perf_counter()))
            precond, model = on['precond'], on['model']
            x, y = on['x'], on['y']
            flight = precond.flight
            pm = kt.observe.flight.read_postmortem(flight.last_dump['path'])
            problems = kt.observe.flight.validate_postmortem(
                pm, min_subsystems=1)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if not (all(torch.equal(a, b) for a, b in zip(off['params'],
                                                  on['params']))
            and all(torch.equal(a, b) for a, b in zip(off['grads'],
                                                      on['grads']))):
        fail(f'{label}: observe and flight on are not bitwise off '
             '(parameters or the last step\'s gradients)')
    per_step = on['buckets'] if DEVICE == 'cuda' else 0
    if DEVICE == 'cuda' and (per_step != 21 or on['launches'] != (
            RN50_OBS_STEPS * per_step) or off['launches'] != on['launches']):
        fail(f'{label}: launches {on["launches"]} on, {off["launches"]} off '
             f'({per_step} a step)')
    nu_err, norm_err, top, nu = observe_plain_check(torch, kt, on)
    marks.append(('plain check', time.perf_counter()))
    if nu_err > 1e-5 or norm_err > 1e-5:
        fail(f'{label}: observe/kl_nu err {nu_err:.3e}, precond_grad_norm '
             f'err {norm_err:.3e} against the plain version (max |pg| '
             f'{top:.3e})')
    (lo_err, hi_err), gate, want, got = observe_spectrum_check(torch, on)
    marks.append(('f64 eigvalsh', time.perf_counter()))
    if lo_err > gate or hi_err > gate:
        fail(f'{label}: kron extremes {got} against f64 {want}: errors '
             f'{lo_err:.3e}, {hi_err:.3e} of the largest (gate {gate:.3e}); '
             f'per bucket {observe_bucket_diagnosis(torch, on)}')
    fused = [inside for name, inside in attributed
             if any(k in name for k in FUSED_KERNEL_NAMES)]
    solver = [(name, inside) for name, inside in attributed
              if name in eigh_names]
    if DEVICE == 'cuda':
        outside = [n for n, inside in solver
                   if 'kfac/eigh_refresh' not in inside]
        if not fused or not all('kfac/precondition' in r for r in fused):
            fail(f'{label}: fused kernels outside kfac/precondition: '
                 f'{sum("kfac/precondition" not in r for r in fused)} of '
                 f'{len(fused)}')
        if not solver or outside:
            fail(f'{label}: {len(solver)} eigh kernels, outside '
                 f'kfac/eigh_refresh: {sorted(set(outside))[:4]}')
        window = RN50_OBS_WINDOW[1] - RN50_OBS_WINDOW[0]
        flushes = sum((t + 1) % RN50_OBS_FLIGHT['flush_every'] == 0
                      for t in range(*RN50_OBS_WINDOW))
        extra = {k: reads[1][k] - reads[0][k] for k in reads[0]}
        if extra != {'dtoh': flushes, 'device_syncs': window}:
            fail(f'{label}: host reads on minus off over steps '
                 f'{RN50_OBS_WINDOW}: {extra} (off {reads[0]}, on '
                 f'{reads[1]}); expected {flushes} copies, {window} syncs')
    if (flight.host_syncs != flight.dumps_total or problems
            or precond.timeline.syncs != RN50_OBS_STEPS):
        fail(f'{label}: flight reads {flight.host_syncs}, dumps '
             f'{flight.dumps_total}, postmortem {problems}, timeline syncs '
             f'{precond.timeline.syncs}')

    def fwd_bwd():
        model.zero_grad()
        F.cross_entropy(model(x), y).backward()

    phases, total = timeline.profile_phases(precond, fwd_bwd, iters=1)
    marks.append(('profile_phases', time.perf_counter()))
    plain = [1, 2]
    d_plain = (statistics.median(on['step_s'][t] for t in plain)
               - statistics.median(off['step_s'][t] for t in plain)) * 1e3
    tl = precond.timeline.summary()
    print(f'{label}: ResNet-50 batch {RN50_BATCH} at {RN50_IMAGE}x'
          f'{RN50_IMAGE}, factor 1, inv 3, kl-clip '
          f'{RN50_OBS_HP["kl_clip"]}, {RN50_OBS_STEPS} steps; observe '
          '(monitor, annotate, timeline) and flight '
          f'{RN50_OBS_FLIGHT} bitwise off (parameters, last gradients); '
          f'{on["launches"]} fused launches; kl_nu {nu:.6g} err '
          f'{nu_err:.3e}, precond_grad_norm err {norm_err:.3e} (max |pg| '
          f'{top:.3e}) against the plain version; kron_min/max '
          f'{got[0]:.6g}/{got[1]:.6g} against f64 {want[0]:.6g}/'
          f'{want[1]:.6g}: errors {lo_err:.3e}/{hi_err:.3e} of the largest '
          f'(gate {gate:.3e})', flush=True)
    if reads is not None:
        print(f'{label}: profiled steps {RN50_OBS_WINDOW[0]}-'
              f'{RN50_OBS_WINDOW[1] - 1}: {len(fused)} fused-kernel kernels, '
              f'all inside kfac/precondition; {len(solver)} eigh kernels '
              f'({len(eigh_names)} names from a probe eigh), all inside '
              f'kfac/eigh_refresh; host reads off {reads[0]}, on {reads[1]}: '
              f'+1 synchronize a step (the timeline), +1 copy per flush '
              f'(flight host_syncs {flight.host_syncs} over '
              f'{flight.dumps_total} flushes)', flush=True)
    print(f'{label}: profile_phases (1 iteration after a warm one) '
          + ', '.join(f'{k} {v * 1e3:.3f} ms' for k, v in phases.items())
          + f'; total {total * 1e3:.3f} ms; sum/total '
          f'{sum(phases.values()) / total:.4f}; step on minus off '
          f'{d_plain:.3f} ms (median of plain steps 1-2; on '
          f'{[round(v * 1e3, 3) for v in on["step_s"]]} ms, off '
          f'{[round(v * 1e3, 3) for v in off["step_s"]]} ms); timeline '
          + json.dumps({k: round(v['p50'] * 1e3, 3) for k, v in tl.items()})
          + ' ms p50; the phase\'s parts '
          + ', '.join(f'{name} {t - prev:.2f} s' for (_, prev), (name, t)
                      in zip(marks, marks[1:])), flush=True)
    launches = on['launches']
    del on, off, precond, model, flight
    gc.collect()
    torch.cuda.empty_cache()
    return launches


#: Phase 25: the runtime and a rank death.  Four ranks on the one card
#: over gloo, CIFAR ResNet-32 at 32 images a rank, HYBRID-OPT, factor 1,
#: inv 3, the Observe monitor, health guardrails, the watchdog saving a
#: streaming generation every 2 steps, the flight recorder (window 8,
#: flushes every 2 steps), heartbeats every 0.25 s with a 2 s grace.
RT_WORLD = 4
RT_BATCH = 32
RT_HP = dict(factor_update_steps=1, inv_update_steps=3, damping=0.003,
             kl_clip=0.001, lr=0.1)
RT_INTERVAL_S = 0.25
RT_GRACE_S = 2.0
RT_REF_STEPS = 4  # rank 3's last snapshot holds steps 1-4
RT_KILL_AFTER = 4  # rank 3 dies once gen-4 is committed
RT_TIMEOUT_S = 240
RT_LEDGER_HP = dict(RT_HP, factor_update_steps=2, inv_update_steps=100)
#: The ledger row each collective of the port counts under: the
#: innermost caller of these names.
LEDGER_LABELS = {
    'all_reduce_mean': 'factor_allreduce',
    'all_reduce_sum_triu': 'factor_allreduce',
    'all_gather_decompositions': 'inverse_row_allgather',
    'all_gather_preconditioned': 'grad_col_allgather',
    'all_gather_preconditioned_async': 'grad_col_allgather',
    'curvature_stats': 'observe_extremes',
}


class CollectiveBytes:
    """Wraps ``torch.distributed``'s collectives: each call's result bytes
    (an all-reduce's buffer, an all-gather's output) under the ledger
    phase of the ``parallel/collectives.py`` function (or monitor) that
    issued it (:data:`LEDGER_LABELS`), and with ``scope_of`` under the
    link class of its group too (phase 31)."""

    def __init__(self, dist, scope_of=None) -> None:
        self.dist, self.counts, self.saved = dist, {}, {}
        # With ``scope_of`` (a topology's): the labelled bytes by the
        # link class of the group each collective ran on.
        self.scope_of, self.scoped = scope_of, {}
        for name in ('all_reduce', 'all_gather_into_tensor', 'all_gather',
                     'broadcast'):
            self.saved[name] = getattr(dist, name)
            setattr(dist, name, self._wrap(self.saved[name]))

    def _wrap(self, fn):
        def wrapped(*args, **kw):
            out = args[0]
            nbytes = (sum(t.numel() * t.element_size() for t in out)
                      if isinstance(out, list)
                      else out.numel() * out.element_size())
            frame, label = sys._getframe(1), 'other'
            while frame is not None:
                if frame.f_code.co_name in LEDGER_LABELS:
                    label = LEDGER_LABELS[frame.f_code.co_name]
                    break
                frame = frame.f_back
            self.counts[label] = self.counts.get(label, 0) + nbytes
            if self.scope_of is not None and label != 'other':
                group = kw.get('group')
                ranks = (range(self.dist.get_world_size()) if group is None
                         else self.dist.get_process_group_ranks(group))
                scope = self.scope_of(ranks)
                self.scoped[scope] = self.scoped.get(scope, 0) + nbytes
            return fn(*args, **kw)
        return wrapped

    def take(self) -> dict:
        out, self.counts = self.counts, {}
        return out

    def take_scoped(self) -> dict:
        out, self.scoped = self.scoped, {}
        return out

    def close(self) -> None:
        for name, fn in self.saved.items():
            setattr(self.dist, name, fn)


def rt_device(torch, device_type, rank=0, backend='gloo'):
    """The rank's device with TF32 off and cuDNN deterministic: the
    rank's own card on NCCL, ``cuda:0`` for every rank over gloo."""
    if device_type != 'cuda':
        return torch.device('cpu')
    dev = torch.device(
        'cuda', rank % torch.cuda.device_count() if backend == 'nccl' else 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    return dev


def rt_engine(torch, kt, dev, rank, hp, **kw):
    """ResNet-32 in DDP, its HYBRID-OPT preconditioner, SGD, the local
    batch of ``rank``."""
    model = kt.models.resnet32(device=dev, seed=0)
    ddp = torch.nn.parallel.DistributedDataParallel(
        model, device_ids=None if dev.index is None else [dev.index])
    precond = kt.KFACPreconditioner(
        ddp, grad_worker_fraction=kt.DistributedStrategy.HYBRID_OPT,
        **hp, **kw)
    opt = torch.optim.SGD(model.parameters(), lr=hp['lr'], momentum=0.9)
    gen = torch.Generator(device=dev)
    gen.manual_seed(30 + rank)
    x = torch.randn(RT_BATCH, 3, 32, 32, generator=gen, device=dev)
    y = torch.randint(0, 10, (RT_BATCH,), generator=gen, device=dev)
    return model, ddp, precond, opt, x, y


def rt_ledger_check(torch, kt, dev, rank):
    """Phase 25 (b): a step without a factor update (1) and a factor step
    (2) of a HYBRID-OPT engine with the monitor (factor 2, inv 100): per
    step, the bytes the port's collectives moved by ledger phase, and the
    ledger's payloads of the rows that fire."""
    import dataclasses

    import torch.distributed as dist
    import torch.nn.functional as F

    from kfac_pytorch_tpu_torch.observe import ObserveConfig
    from kfac_pytorch_tpu_torch.observe import costs

    model, ddp, precond, opt, x, y = rt_engine(
        torch, kt, dev, rank, RT_LEDGER_HP,
        observe=ObserveConfig(monitor=True, annotate=False))
    rows = [dataclasses.asdict(r) for r in costs.ledger_for(precond)]
    counter = CollectiveBytes(dist)
    out = []
    try:
        for t in range(3):
            ddp.zero_grad()
            F.cross_entropy(ddp(x), y).backward()
            factor = precond._step_gating()[0]
            counter.take()
            precond.step()
            moved = counter.take()
            if t == 0:
                continue
            fired = {'step'} | ({'factor_step'} if factor else set())
            want = {r['phase']: r['payload_bytes'] for r in rows
                    if r['cadence'] in fired and r['collective'] != 'host'}
            out.append(dict(step=t, factor=factor, moved=moved, want=want))
    finally:
        counter.close()
    del model, ddp, precond, opt
    return out, rows


def rt_train(torch, kt, dev, rank, workdir, tag, steps, marker=None):
    """The phase's main path on one rank: ``steps`` steps (``None``: until
    the process ends) through ``train_loop`` (the watchdog saves
    generations into ``<tag>/gens``, the flight recorder dumps into
    ``<tag>``); per step ``loss`` and every scalar of ``last_step_info``
    as floats, the series a flight recorder keeps; ``marker`` gets the
    step count and the launches after each step."""
    import torch.nn.functional as F

    from kfac_pytorch_tpu_torch.observe import FlightConfig
    from kfac_pytorch_tpu_torch.observe import ObserveConfig

    root = os.path.join(workdir, tag)
    flight = None if marker is None else FlightConfig(
        path=os.path.join(root, 'postmortem.json'), window=8, flush_every=2)
    model, ddp, precond, opt, x, y = rt_engine(
        torch, kt, dev, rank, RT_HP,
        observe=ObserveConfig(monitor=True, annotate=False),
        health=kt.HealthConfig(),
        watchdog=kt.WatchdogConfig(save_dir=os.path.join(root, 'gens'),
                                   save_every=2, check_every=2),
        flight=flight)
    loop = precond.train_loop(opt, F.cross_entropy)
    kernel = kt.ops.fused_eigen_precondition
    kernel.launches = 0
    series = {}
    t = 0
    while steps is None or t < steps:
        loss, _ = loop.step(x, loss_args=(y,))
        t += 1
        if marker is None:
            series[precond.steps] = dict(
                {k: float(v) for k, v in precond.last_step_info.items()},
                loss=float(loss))
        else:
            tmp = f'{marker}.tmp'
            with open(tmp, 'w') as fh:
                json.dump(dict(steps=precond.steps,
                               launches=kernel.launches), fh)
            os.replace(tmp, marker)
    return series, kernel.launches


def runtime_death_rank(rank, world, device_type, workdir, port):
    """One rank of phase 25's world 4: up through
    ``runtime.initialize_distributed``, the ledger check, an uninterrupted
    reference run, then the main run until the process ends (rank 3 is
    SIGKILLed by the parent; the others are ended by the runtime's
    monitor, exit 87).  Writes ``rt{rank}.pt`` before the main run."""
    import torch
    import torch.distributed as dist

    import kfac_pytorch_tpu_torch as kt
    from kfac_pytorch_tpu_torch import runtime

    dev = rt_device(torch, device_type)
    cfg = runtime.RuntimeConfig(
        coordinator=f'127.0.0.1:{port}', num_processes=world,
        process_id=rank, init_deadline_s=90.0,
        heartbeat_dir=os.path.join(workdir, 'hb'),
        heartbeat_interval_s=RT_INTERVAL_S, heartbeat_grace_s=RT_GRACE_S)
    rt = runtime.DistributedRuntime(cfg)
    rec = dict(attempts=rt.initialize())
    runtime.install(rt)
    rec['backend'] = dist.get_backend()
    rec['ledger'], rec['rows'] = rt_ledger_check(torch, kt, dev, rank)
    rec['reference'], rec['ref_launches'] = rt_train(
        torch, kt, dev, rank, workdir, 'ref', RT_REF_STEPS)
    torch.save(rec, os.path.join(workdir, f'rt{rank}.pt'))
    rt.barrier('main-run')
    try:
        rt_train(torch, kt, dev, rank, workdir, 'death', None,
                 marker=os.path.join(workdir, f'death-step{rank}'))
    except RuntimeError:
        # Gloo may raise "connection closed by peer" at once; the
        # runtime's monitor ends the process (EXIT_RANK_DEATH).
        time.sleep(60)


def runtime_restart_rank(rank, world, device_type, workdir, port):
    """One rank of phase 25's restart at world 2: started beside the world
    of 4 (it imports and opens the card meanwhile) and waiting for the
    parent's ``go`` file, then up through the runtime, ``restore_streaming``
    of the newest committed generation of the world-4 run, one step, and
    the sharded kernel against its plain version on the restored stacks.
    Writes ``restart{rank}.pt``."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    import kfac_pytorch_tpu_torch as kt
    from kfac_pytorch_tpu_torch import elastic
    from kfac_pytorch_tpu_torch import runtime
    from kfac_pytorch_tpu_torch.engine import load_training_extras
    from kfac_pytorch_tpu_torch.observe import ObserveConfig

    dev = rt_device(torch, device_type)
    go = os.path.join(workdir, 'go')
    deadline = time.monotonic() + RT_TIMEOUT_S
    while not os.path.exists(go):
        if time.monotonic() > deadline:
            raise SystemExit(f'restart rank {rank}: no go file')
        time.sleep(0.05)
    cfg = runtime.RuntimeConfig(
        coordinator=f'127.0.0.1:{port}', num_processes=world,
        process_id=rank, init_deadline_s=90.0)
    rt = runtime.DistributedRuntime(cfg)
    rec = dict(attempts=rt.initialize())
    runtime.install(rt)
    model, ddp, precond, opt, x, y = rt_engine(
        torch, kt, dev, rank, RT_HP,
        observe=ObserveConfig(monitor=True, annotate=False),
        health=kt.HealthConfig())
    info = elastic.restore_streaming(
        os.path.join(workdir, 'death', 'gens'), precond)
    load_training_extras(model, opt, info['extras'])
    rec['info'] = {k: v for k, v in info.items() if k != 'extras'}
    rec['grid'] = (precond.grid.rows, precond.grid.cols)
    ddp.zero_grad()
    F.cross_entropy(ddp(x), y).backward()
    raw = {n: h.get_grad().clone() for n, h in precond.helpers.items()}
    kernel = kt.ops.fused_eigen_precondition
    kernel.launches = 0
    precond.step()
    rec['launches'] = kernel.launches
    rec['buckets'] = kernel_buckets(precond)
    rec['finite'] = all(bool(torch.isfinite(p.grad).all())
                        for p in model.parameters())
    rec['kernel_check'] = restored_kernel_check(
        torch, kt, precond, raw, group=precond.grid.row_group)
    torch.save(rec, os.path.join(workdir, f'restart{rank}.pt'))
    rt.barrier('done')
    rt.shutdown()
    dist.destroy_process_group()


def rt_wait(procs, deadline, poll_s=0.02):
    """Exit codes and exit times (``time.monotonic``) of ``procs``, polled
    until all have exited or ``deadline``; stragglers are killed."""
    codes, times = [None] * len(procs), [None] * len(procs)
    while time.monotonic() < deadline and None in codes:
        for i, p in enumerate(procs):
            if codes[i] is None and not p.is_alive():
                times[i] = time.monotonic()
                p.join()
                codes[i] = p.exitcode
        time.sleep(poll_s)
    for i, p in enumerate(procs):
        if codes[i] is None:
            p.kill()
            p.join()
            codes[i] = 'hung'
    return codes, times


def shard_entry(torch, kt, n_cols, name, seed):
    """The sharded form timed alone on one rank's shard of each ResNet-32
    bucket on a grid of ``n_cols`` columns (column 0's slots; no gather),
    against its plain version: a kernels-line entry summed over one
    step's calls."""
    from kfac_pytorch_tpu_torch.capture import ModelCapture
    from kfac_pytorch_tpu_torch.parallel.bucketing import make_bucket_plan

    sharded = kt.ops.fused_eigen_precondition_sharded
    plain = kt.ops.fused_eigen_precondition_sharded_reference
    helpers = ModelCapture(kt.models.resnet32(device=DEVICE)).helpers
    shapes = [(b.seg, b.g_pad, b.a_pad)
              for b in make_bucket_plan(helpers, n_cols=n_cols).buckets]
    timed, max_err = [], 0.0
    for i, (L, gp, ap) in enumerate(shapes):
        args = make_case(torch, L, gp, ap, seed=seed + i)
        pg, _ = sharded(*args)
        want, _ = plain(*args)
        torch.cuda.synchronize()
        bad = (pg - want).abs() > 1e-4 + 1e-5 * want.abs()
        if not torch.isfinite(pg).all() or bool(bad.any()):
            fail(f'{name} {(L, gp, ap)}: kernel disagrees with plain')
        max_err = max(max_err, float((pg - want).abs().max()))
        timed.append(((L, gp, ap), *time_case(torch, sharded, plain, args)))
    entry = step_entry(name, 'kfac_pytorch_tpu/ops/pallas_precond.py:151',
                       timed, max_err, [])
    entry['shard_shapes'] = shapes
    return entry


def phase_runtime(torch, kt):
    """Phase 25: the runtime and a rank death (budget 45 s).  Four ranks
    come up through ``runtime.initialize_distributed`` (a), and hold the
    cost ledger's rows to the bytes the port's collectives moved on a
    step without a factor update and on a factor step (b); after an
    uninterrupted reference run, the parent SIGKILLs rank 3 once it has
    committed ``gen-4`` (c): ranks 0-2 exit 87 within grace + 2 intervals
    + 1 s of the kill, ``rank_death.json`` names rank 3, every survivor's
    ``postmortem.json`` (trigger ``peer_death``) and rank 3's last
    periodic snapshot validate, and rank 3's window equals the reference
    run's series bit for bit; two fresh ranks restart at world 2 (d),
    ``restore_streaming`` the newest committed generation, run a step
    through the sharded kernel and hold it against its plain version
    (unit-Gaussian and raw gradients).  HYBRID-OPT keeps two columns at
    world 2 (1x2) as at world 4 (2x2), so the bucket layout is the saved
    one and the stacks install as saved; phase 22 covers the transplant
    across layouts.  Returns ``(launches, max abs err)``."""
    import torch.multiprocessing as mp

    from kfac_pytorch_tpu_torch import runtime
    from kfac_pytorch_tpu_torch.observe import flight as flight_lib

    label = 'runtime'
    ctx = mp.get_context('spawn')
    with tempfile.TemporaryDirectory(prefix='runtime_') as workdir:
        port, port2 = kt.testing.free_port(), kt.testing.free_port()
        # Daemonic: a failed phase ends the script, which ends them.
        procs = [ctx.Process(target=runtime_death_rank, daemon=True,
                             args=(r, RT_WORLD, DEVICE, workdir, port))
                 for r in range(RT_WORLD)]
        restart = [ctx.Process(target=runtime_restart_rank, daemon=True,
                               args=(r, 2, DEVICE, workdir, port2))
                   for r in range(2)]
        for p in procs + restart:
            p.start()
        marker = os.path.join(workdir, f'death-step{RT_WORLD - 1}')
        deadline = time.monotonic() + RT_TIMEOUT_S
        victim = None
        while time.monotonic() < deadline:
            if os.path.exists(marker):
                with open(marker) as fh:
                    victim = json.load(fh)
                if victim['steps'] >= RT_KILL_AFTER:
                    break
            if any(not p.is_alive() for p in procs):
                break
            time.sleep(0.02)
        if victim is None or victim['steps'] < RT_KILL_AFTER:
            for p in procs + restart:
                p.kill()
                p.join()
            fail(f'{label}: rank {RT_WORLD - 1} never reached step '
                 f'{RT_KILL_AFTER} (exit codes '
                 f'{[p.exitcode for p in procs]})')
        procs[-1].kill()
        t_kill = time.monotonic()
        codes, times = rt_wait(procs, t_kill + 30.0)
        bound = RT_GRACE_S + 2 * RT_INTERVAL_S + 1.0
        latency = [None if t is None else t - t_kill for t in times[:-1]]
        if codes[:-1] != [runtime.EXIT_RANK_DEATH] * (RT_WORLD - 1) or any(
                lat is None or lat > bound for lat in latency):
            fail(f'{label}: survivors exited {codes[:-1]} after '
                 f'{latency} s (bound {bound} s); the victim {codes[-1]}')
        recs = [torch.load(os.path.join(workdir, f'rt{r}.pt'))
                for r in range(RT_WORLD)]
        with open(os.path.join(workdir, 'hb', 'rank_death.json')) as fh:
            death = json.load(fh)
        death_dir = os.path.join(workdir, 'death')
        pms = [flight_lib.read_postmortem(
            os.path.join(death_dir, f'postmortem.p{r}.json'))
            for r in range(RT_WORLD)]
        last = []
        for r in range(RT_WORLD):
            with open(os.path.join(workdir, f'death-step{r}')) as fh:
                last.append(json.load(fh))
        with open(os.path.join(workdir, 'go'), 'w') as fh:
            fh.write('restart')
        rcodes, _ = rt_wait(restart, time.monotonic() + RT_TIMEOUT_S)
        if rcodes != [0, 0]:
            fail(f'{label}: the world-2 restart exited {rcodes}')
        rrecs = [torch.load(os.path.join(workdir, f'restart{r}.pt'))
                 for r in range(2)]
    if death['dead_ranks'] != [RT_WORLD - 1]:
        fail(f'{label}: rank_death.json {death}')
    for r, pm in enumerate(pms):
        want = 'peer_death' if r < RT_WORLD - 1 else 'periodic'
        problems = flight_lib.validate_postmortem(pm, expect_trigger=want)
        if problems:
            fail(f'{label}: rank {r} postmortem: {problems}')
    ref = recs[-1]['reference']
    window = pms[-1]['steps']
    mismatched = [s['step'] for s in window
                  if {k: v for k, v in s.items() if k != 'time'}
                  != dict(ref.get(s['step'], {}), step=s['step'])]
    if mismatched or not window:
        fail(f'{label}: rank {RT_WORLD - 1}\'s last snapshot differs from '
             f'the uninterrupted run at steps {mismatched}')
    for r, rec in enumerate(recs):
        for step in rec['ledger']:
            if step['moved'] != step['want']:
                fail(f'{label} rank {r} ledger step {step["step"]}: moved '
                     f'{step["moved"]}, ledger {step["want"]}')
    for r, rec in enumerate(rrecs):
        if not (rec['info']['decompositions_installed']
                and not rec['info']['recomputed'] and rec['grid'] == (1, 2)
                and rec['info']['generation'] == f'gen-{RT_KILL_AFTER:08d}'
                and rec['finite'] and (DEVICE != 'cuda'
                                       or rec['launches'] == rec['buckets'])):
            fail(f'{label}: restart rank {r}: {rec}')
    launches = (sum(rec['ref_launches'] for rec in recs)
                + sum(m['launches'] for m in last)
                + sum(rec['launches'] for rec in rrecs))
    err = max(e for rec in rrecs for e, _ in rec['kernel_check'].values())
    print(f'{label}: world {RT_WORLD} over {recs[0]["backend"]} on one '
          f'card, ResNet-32 {RT_BATCH} images a rank, HYBRID-OPT, factor '
          f'1, inv 3; init attempts {[r["attempts"] for r in recs]}; '
          'ledger rows equal the bytes moved: '
          + '; '.join(f'step {s["step"]} ({"factor" if s["factor"] else "no factor"}) '
                      + json.dumps(s['moved'])
                      for s in recs[0]['ledger'])
          + f'; rank {RT_WORLD - 1} SIGKILLed after step '
          f'{victim["steps"]} (gen-{RT_KILL_AFTER} committed): survivors '
          f'exit {codes[:-1]} after {[round(v, 3) for v in latency]} s '
          f'(bound {bound} s); rank_death.json {death["dead_ranks"]}; '
          f'postmortems valid (triggers '
          f'{[pm["trigger"]["name"] for pm in pms]}); rank '
          f'{RT_WORLD - 1}\'s window steps {[s["step"] for s in window]} '
          'bitwise the uninterrupted run; restart at world 2: '
          f'{rrecs[0]["info"]["generation"]} restored onto grid '
          f'{rrecs[0]["grid"]} (the 2x2 grid\'s two-column layout: the '
          'stacks install as saved; resized '
          f'{rrecs[0]["info"]["resized"]}), init attempts '
          f'{[r["attempts"] for r in rrecs]}, {rrecs[0]["launches"]} '
          'sharded launches a rank on its step, against its plain version '
          'through the row: '
          + ' / '.join(kernel_check_text(r['kernel_check']) for r in rrecs),
          flush=True)
    return launches, err


# -- phase 8's remat pass; phases 26-27: the MoE and GPipe flavours ------

REMAT_STEPS = 3
#: Switch-Base-8 widths (Fedus et al. 2021, ``google/switch-base-8``) on
#: the JAX MoE test harness ``TinyMoEModel``; depth cut to one MoE layer.
MOE_CFG = dict(n_experts=8, d_model=768, d_ff=3072, capacity_factor=1.25)
MOE_FEATURES = (4, 2048, 768)  # 8192 tokens: capacity 1280 an expert
MOE_CLASSES = 8
MOE_HP = dict(factor_update_steps=1, inv_update_steps=3, damping=0.003,
              kl_clip=0.001, lr=0.1)
MOE_STEPS = 6
MOE_RANK_STEPS = 3
#: GPT-125M widths as a 4-stage GPipe LM of 3 blocks a stage.
PIPE_LM = dict(vocab_size=50304, n_stages=4, blocks_per_stage=3,
               n_heads=12, d_model=768, d_ff=3072, max_seq_len=2048)
PIPE_LM_BATCH = (4, 2048)
PIPE_LM_M = 4
PIPE_LM_HP = dict(factor_update_steps=1, inv_update_steps=3, damping=0.003,
                  kl_clip=0.001, lr=0.1)
PIPE_LM_STEPS = 5
FLAVOUR_SGD_LR = 0.1
#: The flavours' adaptive passes (phases 26-27): ``AdaptiveDamping``
#: through ``make_train_step``, an adaptation every step, so the
#: controller adapts at both of the pass's steps; its ``rho`` band is cut
#: to the one point 0.5, so every adaptation moves the damping (in the
#: paper's band [1/4, 3/4] a step may leave it; the pass checks the feed
#: and the ranks' agreement, not the band).
ADAPT_STEPS = 2
ADAPT_DAMPING = dict(initial=0.003, interval=1, lower=0.5, upper=0.5)


def sync_device(torch, dev) -> None:
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


class KernelCheck:
    """Installed as ``ops.fused_eigen_precondition`` while a flavour
    runs: each call launches the kernel (the real function counts it)
    and holds its ``pg`` and ``clip`` against the plain version on the
    same inputs (``rtol 1e-5, atol 1e-4``; the plain calls launch no
    kernel).  ``worst`` is the largest absolute ``pg`` error and
    ``clip_worst`` the largest ``clip`` one; ``pg_max`` and ``clip_max``
    the largest plain ``|pg|`` and ``|clip|``, which say how far below a
    typical value ``atol`` sits; ``shapes`` the ``(L, gp, ap)`` seen."""

    def __init__(self, ops):
        self.ops, self.real = ops, ops.fused_eigen_precondition
        self.plain = ops.fused_eigen_precondition_reference
        self.worst, self.bad, self.shapes = 0.0, [], []
        self.clip_worst = self.pg_max = self.clip_max = 0.0

    def __call__(self, g, qa, qg, dgda):
        pg, clip = self.real(g, qa, qg, dgda)
        want_pg, want_clip = self.plain(g, qa, qg, dgda)
        err = float((pg - want_pg).abs().max())
        off = (pg - want_pg).abs() > 1e-4 + 1e-5 * want_pg.abs()
        clip_off = (clip - want_clip).abs() > 1e-4 + 1e-5 * want_clip.abs()
        shape = tuple(g.shape)
        if bool(off.any()) or bool(clip_off.any()) or not bool(
                pg.isfinite().all()):
            self.bad.append((shape, err))
        self.worst = max(self.worst, err)
        self.clip_worst = max(self.clip_worst,
                              float((clip - want_clip).abs().max()))
        self.pg_max = max(self.pg_max, float(want_pg.abs().max()))
        self.clip_max = max(self.clip_max, float(want_clip.abs().max()))
        if shape not in self.shapes:
            self.shapes.append(shape)
        return pg, clip

    @property
    def launches(self) -> int:
        """The real function's count (``ops.fused_precond``'s kernel
        counts through its module global, which this check replaces while
        it is installed there)."""
        return self.real.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.real.launches = n

    def __enter__(self):
        self.ops.fused_eigen_precondition = self
        return self

    def __exit__(self, *exc):
        self.ops.fused_eigen_precondition = self.real

    def summary(self) -> dict:
        return dict(worst=self.worst, clip_worst=self.clip_worst,
                    pg_max=self.pg_max, clip_max=self.clip_max,
                    bad=self.bad, shapes=self.shapes)


def check_line(checks) -> str:
    """The worst ``pg`` and ``clip`` errors of :class:`KernelCheck`
    summaries beside the largest plain ``|pg|`` and ``|clip|``."""
    def top(k):
        return max(c[k] for c in checks)
    return (f'worst |pg - plain| {top("worst"):.3e} (max |pg| '
            f'{top("pg_max"):.3e}), worst |clip - plain| '
            f'{top("clip_worst"):.3e} (max |clip| {top("clip_max"):.3e}); '
            'atol 1e-4, rtol 1e-5')


def stack_eigen_check(torch, precond, label):
    """Every layer stack's decomposition on the refresh step: the
    eigen-residual ``|F Q - Q diag(Q^T F Q)| / |F|`` within the card's
    gate ``max(1e-4, 4 n eps)`` and ``|Q^T Q - I| < 1e-3``.  Returns the
    worst residual as a share of its gate."""
    worst = 0.0
    for name, st in precond.layers.items():
        for f, q in ((st.a_factor, st.qa), (st.g_factor, st.qg)):
            f, q = f.float(), q.float()
            d = torch.diagonal(q.mT @ f @ q, dim1=-2, dim2=-1)
            resid = rel_frob(f @ q, q * d[..., None, :])
            eye = torch.eye(q.shape[-1], device=q.device)
            orth = float((q.mT @ q - eye).abs().max())
            gate = eigen_gate(q.shape[-1])
            if not (resid <= gate and orth < 1e-3):
                fail(f'{label}: {name} {tuple(q.shape)} eigen residual '
                     f'{resid:.3e} (gate {gate:.3e}), |Q^T Q - I| {orth:.3e}')
            worst = max(worst, resid / gate)
    return worst


def gpt_remat_run(torch, kt, remat):
    """``REMAT_STEPS`` K-FAC steps of GPT-125M with SGD at phase 8's
    batch (default coverage, refresh at step 0); returns the losses, the
    factor EMAs, the final ``.grad``, the fused launches, the peak memory
    and the seconds."""
    import torch.nn.functional as F

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = getattr(kt.models, GPT_MODEL)(device=DEVICE, seed=0, remat=remat)
    tokens = gpt_tokens(torch, model.config.vocab_size)
    precond = kt.KFACPreconditioner(model, **GPT_HP)
    opt = torch.optim.SGD(model.parameters(), lr=GPT_HP['lr'])
    kt.ops.fused_eigen_precondition.launches = 0
    losses = []
    for _ in range(REMAT_STEPS):
        opt.zero_grad()
        logits = model(tokens)
        loss = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                               tokens[:, 1:].reshape(-1))
        del logits
        loss.backward()
        precond.step()
        opt.step()
        losses.append(loss.detach())
    torch.cuda.synchronize()
    return dict(
        losses=torch.stack(losses),
        factors={n: (st.a_factor, st.g_factor)
                 for n, st in precond.layers.items()},
        grads={n: p.grad for n, p in model.named_parameters()},
        launches=kt.ops.fused_eigen_precondition.launches,
        peak=torch.cuda.max_memory_allocated(),
        seconds=time.perf_counter() - t0)


def remat_differences(torch, a, b):
    """``(tensors compared, [(name, relative error)] of those not
    bitwise equal)`` between two :func:`gpt_remat_run` results."""
    pairs = [('loss', a['losses'], b['losses'])]
    for n, (fa, fg) in a['factors'].items():
        pairs += [(f'{n} A', fa, b['factors'][n][0]),
                  (f'{n} G', fg, b['factors'][n][1])]
    pairs += [(f'{n}.grad', g, b['grads'][n]) for n, g in a['grads'].items()]
    return len(pairs), [(n, rel_frob(y, x)) for n, x, y in pairs
                        if not torch.equal(x, y)]


def gpt_remat_pass(torch, kt):
    """Phase 8's remat pass (budget 20 s): :func:`gpt_remat_run` with
    ``remat=True`` against ``remat=False`` from seed 0: the losses, every
    factor EMA and the final ``.grad`` bitwise, the fused kernel's
    launches equal; ``torch.cuda.max_memory_allocated`` of both.  Both
    runs hold ``scaled_dot_product_attention`` to its math backend: the
    memory-efficient kernel's backward is not deterministic, so two
    ``remat=False`` runs differ with it."""
    from torch.nn.attention import SDPBackend
    from torch.nn.attention import sdpa_kernel

    with sdpa_kernel(SDPBackend.MATH):
        plain = gpt_remat_run(torch, kt, False)
        remat = gpt_remat_run(torch, kt, True)
    n, differ = remat_differences(torch, plain, remat)
    worst = max([e for _, e in differ], default=0.0)
    if worst > 1e-6 or plain['launches'] != remat['launches']:
        fail(f'gpt remat: {len(differ)} of {n} tensors differ from '
             f'remat=False (worst {differ[:3]}), launches '
             f'{remat["launches"]} vs {plain["launches"]}')
    print(f'gpt remat: {GPT_MODEL} batch {GPT_BATCH[0]} x {GPT_BATCH[1]}, '
          f'{REMAT_STEPS} steps, SDPA math backend, remat=True vs '
          f'remat=False: {n - len(differ)} of {n} tensors (losses, factor '
          'EMAs, final .grad) bitwise'
          + (f', worst of the rest {worst:.3e} relative ({differ[:3]})'
             if differ else '')
          + f'; fused launches {remat["launches"]} both; '
          f'torch.cuda.max_memory_allocated {plain["peak"]} bytes plain, '
          f'{remat["peak"]} bytes remat '
          f'({remat["peak"] / plain["peak"]:.3f}x); '
          f'{plain["seconds"]:.2f} s plain, {remat["seconds"]:.2f} s remat',
          flush=True)
    del plain, remat, differ
    gc.collect()
    torch.cuda.empty_cache()


def moe_model(torch, kt, dev, expert_group=None):
    from kfac_pytorch_tpu_torch.models.moe import MoEConfig
    from kfac_pytorch_tpu_torch.models.moe import tiny_moe_model

    return tiny_moe_model(MoEConfig(**MOE_CFG), MOE_FEATURES[2],
                          MOE_CLASSES, device=dev, seed=0,
                          expert_group=expert_group)


def moe_batch(torch, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(26)
    x = torch.randn(*MOE_FEATURES, generator=gen, device=dev)
    y = torch.randint(0, MOE_CLASSES, (MOE_FEATURES[0],), generator=gen,
                      device=dev)
    return x, y


def moe_xent(out, labels):
    import torch.nn.functional as F

    logits, aux = out
    return F.cross_entropy(logits, labels) + 0.01 * aux


def expert_grads(model):
    moe = model.moe
    return {n: getattr(moe, n).grad.detach().cpu().clone()
            for n in ('w_in', 'b_in', 'w_out', 'b_out')}


def adaptive_pass(torch, kt, dev, model, make_precond, args, loss_args):
    """``ADAPT_STEPS`` fused steps of a flavour (``make_train_step``,
    SGD) under ``AdaptiveDamping(**ADAPT_DAMPING)``, every
    fused call held against its plain version: per step the loss, the
    damping in force after it and the synchronized step time; the
    loss-only forwards' times (synchronized); the launches (counted from
    0 just before the steps) and the kernel check."""
    ad = kt.AdaptiveDamping(**ADAPT_DAMPING)
    precond = make_precond(ad)
    step = precond.make_train_step(
        torch.optim.SGD(model.parameters(), lr=FLAVOUR_SGD_LR))
    real = precond._loss_only
    loss_only_s = []

    def timed(*a):
        sync_device(torch, dev)
        t0 = time.perf_counter()
        out = real(*a)
        sync_device(torch, dev)
        loss_only_s.append(time.perf_counter() - t0)
        return out

    precond._loss_only = timed
    out = dict(losses=[], damping=[], step_s=[], start=ad.damping,
               n_layers=len(precond.layers))
    sync_device(torch, dev)
    kt.ops.fused_eigen_precondition.launches = 0
    with KernelCheck(kt.ops) as check:
        for _ in range(ADAPT_STEPS):
            t0 = time.perf_counter()
            loss, _ = step(*args, loss_args=loss_args)
            sync_device(torch, dev)
            out['step_s'].append(time.perf_counter() - t0)
            out['losses'].append(float(loss))
            out['damping'].append(ad.damping)
    out.update(launches=kt.ops.fused_eigen_precondition.launches,
               loss_only_s=loss_only_s, **check.summary())
    return out


def adaptive_gate(label, runs, stacks):
    """The gates of the adaptive passes ``runs`` (one a rank): finite
    losses, the damping moved from its start, every rank's damping after
    every step bitwise rank 0's, launches = steps x layers, every fused
    call within the kernel's bar, every stack it saw padded to multiples
    of 8 and ``stacks`` among them; and the line they print.  Returns
    the launches over the runs and the worst ``pg`` error."""
    first = runs[0]
    for r, run in enumerate(runs):
        want = ADAPT_STEPS * run['n_layers'] * (DEVICE == 'cuda')
        if not (all(map(math.isfinite, run['losses']))
                and any(d != run['start'] for d in run['damping'])
                and run['damping'] == first['damping']
                and run['launches'] == want and not run['bad']
                and stacks <= set(run['shapes'])
                and all(aligned(x) == x for x in run['shapes'])):
            fail(f'{label} rank {r}: losses {run["losses"]}, damping '
                 f'{run["damping"]} (rank 0 {first["damping"]}, start '
                 f'{run["start"]}), launches {run["launches"]} (want '
                 f'{want}), kernel vs plain off at {run["bad"][:4]}, '
                 f'shapes {run["shapes"]}')
    step = statistics.median(t for r in runs for t in r['step_s']) * 1e3
    fwd = statistics.median(t for r in runs for t in r['loss_only_s']) * 1e3
    print(f'{label}: AdaptiveDamping({ADAPT_DAMPING}) '
          f'through make_train_step, {ADAPT_STEPS} steps on '
          f'{len(runs)} rank(s): damping {first["damping"]} (from '
          f'{first["start"]}), bitwise equal on every rank; losses '
          f'{[round(v, 6) for v in first["losses"]]}; fused launches '
          f'{[r["launches"] for r in runs]} ({ADAPT_STEPS} steps x '
          f'{first["n_layers"]}) on {first["shapes"]}, '
          f'{check_line(runs)}; median step {step:.2f} ms, the loss-only '
          f'forward {fwd:.2f} ms (host clock, synchronized)', flush=True)
    return sum(r['launches'] for r in runs), max(r['worst'] for r in runs)


def moe_rank(torch, kt, dev, world):
    """One rank of phase 26's expert group (``X = world``), run in phase
    28's spawn: losses, expert gradients and launches of
    ``MOE_RANK_STEPS`` steps, the kernel check."""
    from kfac_pytorch_tpu_torch.gpt import MoEKFACPreconditioner
    from kfac_pytorch_tpu_torch.parallel.mesh import axis_groups

    grid = axis_groups(1, world)
    model = moe_model(torch, kt, dev, expert_group=grid.inner_group)
    precond = MoEKFACPreconditioner(model, moe_xent, **MOE_HP)
    opt = torch.optim.SGD(model.parameters(), lr=FLAVOUR_SGD_LR)
    x, y = moe_batch(torch, dev)
    out = dict(losses=[], grads=[], offset=model.moe.expert_offset,
               local=model.moe.local_experts)
    kt.ops.fused_eigen_precondition.launches = 0
    with KernelCheck(kt.ops) as check:
        for _ in range(MOE_RANK_STEPS):
            out['losses'].append(float(precond.step(x, loss_args=(y,))))
            out['grads'].append(expert_grads(model))
            opt.step()
    sync_device(torch, dev)
    out.update(launches=kt.ops.fused_eigen_precondition.launches,
               **check.summary())
    del model, precond, opt
    model = moe_model(torch, kt, dev, expert_group=grid.inner_group)
    out['adaptive'] = adaptive_pass(
        torch, kt, dev, model,
        lambda ad: MoEKFACPreconditioner(model, moe_xent,
                                         **dict(MOE_HP, damping=ad)),
        (x,), (y,))
    return out


def phase_moe(torch, kt):
    """Phase 26 (budget 60 s): the expert-parallel MoE flavour.  The JAX
    MoE test harness (``inproj`` -> ``MoEMLP`` -> residual -> ``head``)
    at Switch-Base-8 widths (``d_model`` 768, ``d_ff`` 3072, 8 experts,
    capacity factor 1.25, 8 classes; depth cut to one MoE layer) on
    seeded features ``[4, 2048, 768]`` (8192 tokens, capacity 1280),
    f32, TF32 off.  One card: ``MOE_STEPS`` steps, factor 1, inv 3:
    a finite falling loss; every fused call (the expert stacks
    ``[8, 3072, 769]`` and ``[8, 768, 3073]``, the dense layers as
    stacks of one) against its plain version; launches = steps x 5; the
    eigen gate on every stack at the refresh step 3.  Its four ranks
    (one expert group, 2 experts a rank, ``MOE_RANK_STEPS`` steps from
    the same weights) run in phase 28's spawn (:func:`moe_rank`,
    :func:`moe_world_check`).  Returns the one-card run's launches,
    worst kernel error, losses, expert gradients and layer count."""
    from kfac_pytorch_tpu_torch.gpt import MoEKFACPreconditioner

    dev = torch.device(DEVICE)
    model = moe_model(torch, kt, dev)
    precond = MoEKFACPreconditioner(model, moe_xent, **MOE_HP)
    opt = torch.optim.SGD(model.parameters(), lr=FLAVOUR_SGD_LR)
    x, y = moe_batch(torch, dev)
    losses, ref, step_s, gate_share = [], [], [], None
    kt.ops.fused_eigen_precondition.launches = 0
    with KernelCheck(kt.ops) as check:
        for step in range(MOE_STEPS):
            sync_device(torch, dev)
            t0 = time.perf_counter()
            loss = precond.step(x, loss_args=(y,))
            sync_device(torch, dev)
            step_s.append(time.perf_counter() - t0)
            losses.append(float(loss))
            if step < MOE_RANK_STEPS:
                ref.append(expert_grads(model))
            if step == MOE_HP['inv_update_steps']:
                gate_share = stack_eigen_check(torch, precond, 'moe')
            opt.step()
    launches = kt.ops.fused_eigen_precondition.launches
    n_layers = len(precond.layers)
    want = MOE_STEPS * n_layers if DEVICE == 'cuda' else 0
    E, D, Fd = (MOE_CFG[k] for k in ('n_experts', 'd_model', 'd_ff'))
    stacks = {aligned((E, Fd, D + 1)), aligned((E, D, Fd + 1))}
    before, after = padding_times(torch, kt, MOE_CASES, None, 980)
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        fail(f'moe: losses {losses}')
    if check.bad or launches != want or not stacks <= set(check.shapes):
        fail(f'moe: kernel vs plain off at {check.bad[:4]}, launches '
             f'{launches} (want {want}), shapes {check.shapes}')
    print(f'moe: TinyMoEModel at Switch-Base-8 widths, {n_layers} K-FAC '
          f'layers ({sorted(precond.layers)}), features {MOE_FEATURES}; '
          f'losses {[round(v, 6) for v in losses]}; fused launches '
          f'{launches} ({MOE_STEPS} steps x {n_layers}), shapes '
          f'{check.shapes} (the unaligned ones zero-padded to multiples '
          f'of 8), {check_line([check.summary()])}; one step\'s five '
          f'calls {before:.5f} ms unpadded, {after:.5f} ms padded as the '
          f'path calls them (before the padding, unpadded: 28.20 ms); eigen '
          f'residual at step {MOE_HP["inv_update_steps"]} at most '
          f'{gate_share:.3f} of the gate; step times '
          f'{[round(s * 1e3, 2) for s in step_s]} ms (host clock, '
          f'synchronized, refreshes at 0 and 3); memory_usage '
          f'{precond.memory_usage()}', flush=True)
    del model, precond, opt
    gc.collect()
    torch.cuda.empty_cache()
    model = moe_model(torch, kt, dev)
    adaptive = adaptive_pass(
        torch, kt, dev, model,
        lambda ad: MoEKFACPreconditioner(model, moe_xent,
                                         **dict(MOE_HP, damping=ad)),
        (x,), (y,))
    adaptive_launches, adaptive_worst = adaptive_gate(
        'moe adaptive', [adaptive], stacks)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, worst=check.worst, losses=losses,
                ref=ref, n_layers=n_layers, adaptive=adaptive,
                adaptive_launches=adaptive_launches,
                adaptive_worst=adaptive_worst, stacks=stacks)


def moe_world_check(one, ranks, backend):
    """Phase 26's four ranks (run in phase 28's spawn) against the
    one-card run ``one``: each step's loss and each rank's expert
    gradients within 1e-5; launches = steps x layers.  Returns the worst
    kernel error."""
    losses, ref, n_layers = one['losses'], one['ref'], one['n_layers']
    worst_loss = worst_grad = 0.0
    for r, res in enumerate(ranks):
        if res['bad'] or res['launches'] != MOE_RANK_STEPS * n_layers * (
                DEVICE == 'cuda'):
            fail(f'moe rank {r}: kernel vs plain off at {res["bad"][:4]}, '
                 f'launches {res["launches"]}')
        rows = slice(res['offset'], res['offset'] + res['local'])
        for step in range(MOE_RANK_STEPS):
            worst_loss = max(worst_loss, abs(res['losses'][step]
                                             - losses[step])
                             / abs(losses[step]))
            for n, g in res['grads'][step].items():
                worst_grad = max(worst_grad, rel_frob(g, ref[step][n][rows]))
    if not (worst_loss <= 1e-5 and worst_grad <= 1e-5):
        fail(f'moe world {len(ranks)}: loss {worst_loss:.3e} and expert '
             f'gradients {worst_grad:.3e} relative from the one-card run')
    print(f'moe world {len(ranks)} ({backend}, one expert group, '
          f'{ranks[0]["local"]} experts a rank, {MOE_RANK_STEPS} steps): '
          f'losses within {worst_loss:.3e} and expert gradients within '
          f'{worst_grad:.3e} (relative) of the one-card run; launches '
          f'{[r["launches"] for r in ranks]}, {check_line(ranks)}, shapes '
          f'{ranks[0]["shapes"]}', flush=True)
    launches, worst = adaptive_gate(
        f'moe adaptive world {len(ranks)} ({backend})',
        [r['adaptive'] for r in ranks],
        {(ranks[0]['local'], *x[1:]) for x in one['stacks']})
    one['adaptive_launches'] += launches
    one['adaptive_worst'] = max(one['adaptive_worst'], worst)
    return max(r['worst'] for r in ranks)


def pipe_lm_batch(torch, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(27)
    vocab = PIPE_LM['vocab_size']
    tokens = torch.randint(0, vocab, PIPE_LM_BATCH, generator=gen,
                           device=dev)
    labels = torch.randint(0, vocab, PIPE_LM_BATCH, generator=gen,
                           device=dev)
    return tokens, labels


def pipe_lm_loss(logits, labels):
    import torch.nn.functional as F

    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def stage_snapshot(model, precond, stages):
    """CPU copies of the factors of ``stages`` (stack rows) and of every
    gradient, keyed by name."""
    factors = {n: (st.a_factor.cpu(), st.g_factor.cpu())
               for n, st in precond.layers.items()}
    grads = {n: p.grad.detach().cpu().clone()
             for n, p in model.named_parameters()
             if not n.startswith('stages.')
             or int(n.split('.')[1]) in stages}
    return factors, grads


def pipe_rank(torch, kt, dev, world):
    """One rank of phase 27 (the stage of its rank), run in phase 28's
    spawn: losses, step times, the stage's first-step factors and
    gradients, launches, hand-offs and the kernel check."""
    from kfac_pytorch_tpu_torch.gpt import PipelineKFACPreconditioner
    from kfac_pytorch_tpu_torch.models.pipeline import PipeLMConfig
    from kfac_pytorch_tpu_torch.models.pipeline import pipeline_lm
    from kfac_pytorch_tpu_torch.parallel.mesh import axis_groups

    grid = axis_groups(world, 1)
    model = pipeline_lm(PipeLMConfig(**PIPE_LM), grid=grid, device=dev,
                        seed=0)
    precond = PipelineKFACPreconditioner(
        model, pipe_lm_loss, n_microbatches=PIPE_LM_M, grid=grid,
        **PIPE_LM_HP)
    opt = torch.optim.SGD(model.parameters(), lr=FLAVOUR_SGD_LR)
    tokens, labels = pipe_lm_batch(torch, dev)
    out = dict(losses=[], step_s=[], stage=grid.outer)
    kt.ops.fused_eigen_precondition.launches = 0
    with KernelCheck(kt.ops) as check:
        for step in range(PIPE_LM_STEPS):
            sync_device(torch, dev)
            t0 = time.perf_counter()
            out['losses'].append(float(precond.step(tokens, labels)))
            sync_device(torch, dev)
            out['step_s'].append(time.perf_counter() - t0)
            if step == 0:
                out['factors'], out['grads'] = stage_snapshot(
                    model, precond, [grid.outer])
            opt.step()
    out.update(launches=kt.ops.fused_eigen_precondition.launches,
               handoffs=precond.links.handoff_bytes, **check.summary())
    del model, precond, opt
    model = pipeline_lm(PipeLMConfig(**PIPE_LM), grid=grid, device=dev,
                        seed=0)
    out['adaptive'] = adaptive_pass(
        torch, kt, dev, model,
        lambda ad: PipelineKFACPreconditioner(
            model, pipe_lm_loss, n_microbatches=PIPE_LM_M, grid=grid,
            **dict(PIPE_LM_HP, damping=ad)),
        (tokens,), (labels,))
    return out


def phase_pipeline(torch, kt):
    """Phase 27 (budget 75 s): the GPipe flavour.  ``PipeLMConfig`` at
    GPT-125M widths (vocab 50304, 4 stages of 3 blocks, 12 heads,
    ``d_model`` 768, ``d_ff`` 3072, 2048 positions), f32, TF32 off,
    batch 4 x 2048, ``M = 4``, factor 1, inv 3, ``PIPE_LM_STEPS`` steps
    with SGD.  First one process holding every stage
    (``apply_sequential``, the stacks ``[4, ...]``); then four ranks over
    gloo on the card, one stage each, from the same weights (in phase
    28's spawn: :func:`pipe_rank`, :func:`pipeline_world_check`).  Gates:
    each step's loss within 1e-5 (relative) of the one-process run's;
    each rank's stage factors after step 0 within 1e-5 and its
    first-step preconditioned gradients within 1e-4 (relative
    Frobenius); every fused call against its plain version (the stage
    layers ``[4 | 1, 2304|768|3072, 769]`` and ``[4 | 1, 768, 3073]``,
    zero-padded to ``ap`` 776 and 3080, each of these shapes seen and no
    other); launches = steps x 12 in the one process (counted from 0
    just before its loop) and a rank; every activation handed off ``mb *
    T * D * 4`` bytes, ``M`` a step from each stage but the last.
    Returns what :func:`pipeline_world_check` holds the ranks to."""
    from kfac_pytorch_tpu_torch.gpt import PipelineKFACPreconditioner
    from kfac_pytorch_tpu_torch.models.pipeline import PipeLMConfig
    from kfac_pytorch_tpu_torch.models.pipeline import pipeline_lm

    dev = torch.device(DEVICE)
    cfg = PipeLMConfig(**PIPE_LM)
    model = pipeline_lm(cfg, device=dev, seed=0)
    precond = PipelineKFACPreconditioner(
        model, pipe_lm_loss, n_microbatches=PIPE_LM_M, **PIPE_LM_HP)
    opt = torch.optim.SGD(model.parameters(), lr=FLAVOUR_SGD_LR)
    tokens, labels = pipe_lm_batch(torch, dev)
    losses, step_s = [], []
    per_step = 4 * cfg.blocks_per_stage * (DEVICE == 'cuda')
    S, D, Fd = cfg.n_stages, cfg.d_model, cfg.d_ff
    stacks = {aligned(x) for x in ((S, 3 * D, D + 1), (S, D, D + 1),
                                   (S, Fd, D + 1), (S, D, Fd + 1))}
    before, after = padding_times(torch, kt, PIPE_LM_CASES, [3] * 4, 990)
    kt.ops.fused_eigen_precondition.launches = 0
    with KernelCheck(kt.ops) as check:
        for step in range(PIPE_LM_STEPS):
            sync_device(torch, dev)
            t0 = time.perf_counter()
            losses.append(float(precond.step(tokens, labels)))
            sync_device(torch, dev)
            step_s.append(time.perf_counter() - t0)
            if step == 0:
                factors, grads = stage_snapshot(model, precond,
                                                range(cfg.n_stages))
            opt.step()
    one_launches = kt.ops.fused_eigen_precondition.launches
    if (check.bad or one_launches != PIPE_LM_STEPS * per_step
            or set(check.shapes) != stacks
            or not (all(map(math.isfinite, losses))
                    and losses[-1] < losses[0])):
        fail(f'pipeline one process: losses {losses}, kernel vs plain off '
             f'at {check.bad[:4]}, launches {one_launches} (want '
             f'{PIPE_LM_STEPS * per_step}), shapes {check.shapes} (want '
             f'{sorted(stacks)})')
    print(f'pipeline: PipeLMConfig at GPT-125M widths ({cfg.n_stages} '
          f'stages x {cfg.blocks_per_stage} blocks), batch '
          f'{PIPE_LM_BATCH[0]} x {PIPE_LM_BATCH[1]}, M={PIPE_LM_M}; one '
          f'process holding every stage: losses '
          f'{[round(v, 6) for v in losses]}, step times '
          f'{[round(s * 1e3, 2) for s in step_s]} ms (host clock, '
          f'synchronized), fused launches {one_launches} ({per_step} a '
          f'step) on the stacks {check.shapes} (zero-padded to multiples '
          f'of 8), {check_line([check.summary()])}; one rank\'s twelve '
          f'calls a step {before:.5f} ms unpadded, {after:.5f} ms padded '
          f'as the path calls them (before the padding, unpadded: 20.70 '
          'ms)',
          flush=True)
    del model, precond, opt
    gc.collect()
    torch.cuda.empty_cache()
    model = pipeline_lm(cfg, device=dev, seed=0)
    adaptive = adaptive_pass(
        torch, kt, dev, model,
        lambda ad: PipelineKFACPreconditioner(
            model, pipe_lm_loss, n_microbatches=PIPE_LM_M,
            **dict(PIPE_LM_HP, damping=ad)),
        (tokens,), (labels,))
    adaptive_launches, adaptive_worst = adaptive_gate(
        'pipeline adaptive', [adaptive], stacks)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, factors=factors, grads=grads, stacks=stacks,
                per_step=per_step, worst=check.worst, cfg=cfg,
                adaptive_launches=adaptive_launches,
                adaptive_worst=adaptive_worst)


def pipeline_world_check(one, ranks, backend):
    """Phase 27's four ranks (one stage each, run in phase 28's spawn)
    against the one-process run ``one`` (:func:`phase_pipeline`'s
    gates).  Returns ``(launches over the ranks, worst kernel error)``."""
    losses, factors, grads = one['losses'], one['factors'], one['grads']
    stacks, per_step, cfg = one['stacks'], one['per_step'], one['cfg']
    world = cfg.n_stages
    mb = PIPE_LM_BATCH[0] // PIPE_LM_M
    handoff = mb * PIPE_LM_BATCH[1] * cfg.d_model * 4
    worst = dict(loss=0.0, factor=0.0, grad=0.0)
    for r, res in enumerate(ranks):
        s = res['stage']
        sends = PIPE_LM_STEPS * PIPE_LM_M if s < world - 1 else 0
        if (res['bad'] or res['launches'] != PIPE_LM_STEPS * per_step
                or set(res['shapes']) != {(1, *x[1:]) for x in stacks}
                or res['handoffs'] != [handoff] * sends):
            fail(f'pipeline rank {r}: kernel vs plain off at '
                 f'{res["bad"][:4]}, launches {res["launches"]}, shapes '
                 f'{res["shapes"]}, hand-offs '
                 f'{sorted(set(res["handoffs"]))} x {len(res["handoffs"])}')
        for step, loss in enumerate(res['losses']):
            worst['loss'] = max(worst['loss'],
                                abs(loss - losses[step]) / abs(losses[step]))
        for n, (a, g) in res['factors'].items():
            worst['factor'] = max(worst['factor'],
                                  rel_frob(a, factors[n][0][s:s + 1]),
                                  rel_frob(g, factors[n][1][s:s + 1]))
        for n, g in res['grads'].items():
            worst['grad'] = max(worst['grad'], rel_frob(g, grads[n]))
    if not (worst['loss'] <= 1e-5 and worst['factor'] <= 1e-5
            and worst['grad'] <= 1e-4):
        fail(f'pipeline world {world}: against one process {worst}')
    times = [statistics.median(r['step_s'][1:]) for r in ranks]
    print(f'pipeline world {world} ({backend}, one stage a rank): losses '
          f'within {worst["loss"]:.3e}, stage factors within '
          f'{worst["factor"]:.3e}, first-step gradients within '
          f'{worst["grad"]:.3e} (relative) of one process; launches '
          f'{[r["launches"] for r in ranks]} ({per_step} a step a rank); '
          f'hand-offs {handoff} bytes each (mb*T*D*4), '
          f'{[len(r["handoffs"]) for r in ranks]} a rank; '
          f'{check_line(ranks)}; median '
          f'step {[round(t * 1e3, 2) for t in times]} ms by rank (host '
          'clock; a correctness path on one shared card, not a scaling '
          'result)', flush=True)
    launches, worst = adaptive_gate(
        f'pipeline adaptive world {world} ({backend})',
        [r['adaptive'] for r in ranks], {(1, *x[1:]) for x in stacks})
    one['adaptive_launches'] += launches
    one['adaptive_worst'] = max(one['adaptive_worst'], worst)
    return (sum(r['launches'] for r in ranks),
            max(r['worst'] for r in ranks))


def aligned(shape):
    """``(L, gp, ap)`` with ``gp`` and ``ap`` rounded up to multiples of
    8: the stack the flavours hand the kernel (``gpt/stacked.py``)."""
    L, gp, ap = shape
    return (L, gp + -gp % 8, ap + -ap % 8)


def padding_times(torch, kt, cases, counts, seed):
    """One step's flavour calls at ``cases`` (``counts`` calls each,
    default one): ``(ms unpadded, ms as the path makes them)``, the
    latter through ``StackedKFAC._fused`` itself (the gradient padded
    and ``pg`` sliced each call; ``qa``, ``qg`` and ``dgda`` padded once,
    as once a refresh).  Fails if the path's ``pg`` or ``clip`` is off
    the unpadded plain version's by more than ``atol 1e-4, rtol
    1e-5``.  Zeros on the CPU."""
    import types

    from kfac_pytorch_tpu_torch.gpt.stacked import StackedKFAC
    from kfac_pytorch_tpu_torch.gpt.stacked import StackState

    if DEVICE != 'cuda':
        return 0.0, 0.0
    kernel = kt.ops.fused_eigen_precondition
    plain = kt.ops.fused_eigen_precondition_reference
    counts = counts or [1] * len(cases)
    before = after = 0.0
    for i, (shape, n) in enumerate(zip(cases, counts)):
        g, qa, qg, dgda = make_case(torch, *shape, seed=seed + i)
        holder = types.SimpleNamespace(_padded={})
        st = StackState(a_factor=None, g_factor=None, qa=qa, qg=qg,
                        dgda=dgda)

        def path():
            return StackedKFAC._fused(holder, 'case', st, g)
        pg, clip = path()
        want_pg, want_clip = plain(g, qa, qg, dgda)
        if (bool((pg - want_pg).abs().gt(1e-4 + 1e-5 * want_pg.abs()).any())
                or bool((clip - want_clip).abs().gt(
                    1e-4 + 1e-5 * want_clip.abs()).any())):
            fail(f'padded path {shape}: |pg - plain| '
                 f'{float((pg - want_pg).abs().max()):.3e}')
        before += n * time_ms(torch, lambda: kernel(g, qa, qg, dgda))
        after += n * time_ms(torch, path)
        del g, qa, qg, dgda, pg, clip, want_pg, want_clip, holder, st
        torch.cuda.empty_cache()
    return before, after


#: Phase 28: GPT-125M's widths, f32; the batch is phase 8's.
SEQ_HP = dict(factor_update_steps=1, inv_update_steps=3, damping=0.003,
              kl_clip=0.001, lr=0.1)
SEQ_WORLD = 4
#: Steps of (a) and of each pass of (b), cut for the card run's time
#: (spawned ranks on one card run gloo through host memory, 5-16 s a
#: step): the step-0 refresh and, for the ring, one step on its
#: decompositions (two until phases 29-30 came); each TP pass one step.
SEQ_STEPS = 2
TP_STEPS = 1
SEQ_TIMEOUT_S = 600
SEQ_TOL = 1e-4
SEQ_ATTN_TOL = 1e-5


#: Phase 30b: BERT-large's widths (vocab 30522, 16 heads, 1024/4096),
#: f32 compute, with the depth cut to ``BERT_TP_LAYERS`` blocks for the
#: card run's time; ``BERT_TP_BATCH`` real-text QA examples of
#: ``BERT_TP_SEQ`` positions (half a data rank), ``SEQ_HP``, prediv,
#: ``BERT_TP_STEPS`` steps.
BERT_TP_MODEL = 'bert_large'
BERT_TP_LAYERS = 4
BERT_TP_BATCH = 4
BERT_TP_SEQ = 384
BERT_TP_STEPS = 2


def bert_tp_model(torch, kt, dev, tp_group=None):
    """Phase 30b's BERT from seed 0 (sharded over ``tp_group``)."""
    return getattr(kt.models, BERT_TP_MODEL)(
        device=dev, seed=0, dtype=torch.float32, n_layers=BERT_TP_LAYERS,
        max_seq_len=BERT_TP_SEQ, tp_group=tp_group)


def bert_tp_batch(torch, dev):
    """``(tokens, mask, starts, ends)`` of the squad example's real-text
    QA task, on the card."""
    from kfac_pytorch_tpu_torch.examples.squad_bert import build_realtext_qa

    tokens, starts, ends, mask = build_realtext_qa(
        BERT_TP_SEQ, n_examples=BERT_TP_BATCH, seed=30)
    return (torch.from_numpy(tokens).long().to(dev),
            torch.from_numpy(mask).to(dev),
            torch.from_numpy(starts).long().to(dev),
            torch.from_numpy(ends).long().to(dev))


def bert_tp_loss(out, targets):
    from kfac_pytorch_tpu_torch.examples.squad_bert import span_loss

    return span_loss(out, *targets)[0]


def seq_model(torch, kt, dev, **kw):
    """GPT-125M (phase 8's ``GPT_MODEL``) in f32 compute from seed 0."""
    return getattr(kt.models, GPT_MODEL)(device=dev, seed=0,
                                         dtype=torch.float32, **kw)


def seq_batch(torch, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(28)
    vocab = 256 if GPT_MODEL == 'gpt_tiny' else 50304
    return torch.randint(0, vocab, GPT_BATCH, generator=gen, device=dev)


def layer_digest(torch, tensors):
    """``[n, 2]`` f64 sums and sums of squares: equal digests across
    ranks say their tensors agree (bitwise, in practice)."""
    return torch.stack([torch.stack([t.double().sum(),
                                     t.double().square().sum()])
                        for t in tensors]).cpu()


def seq_grad_gate(precond, name: str) -> float:
    """The card's cuSOLVER gate for a parameter's preconditioned
    gradient: ``eigen_gate`` of its layer's widest factor (two separate
    runs' f32 ``eigh`` of a factor that wide agree only to about ``4 n
    eps``), ``SEQ_TOL`` for a parameter outside every registered layer
    (its raw gradient)."""
    st = precond.layers.get(name.rsplit('.', 1)[0])
    if st is None:
        return SEQ_TOL
    return max(SEQ_TOL, eigen_gate(max(st.a_factor.shape[0],
                                       st.g_factor.shape[0])))


def seq_errors(torch, precond, params, ref, shard=None, zero=()):
    """The worst relative Frobenius errors of this rank's factors and
    gradients against the one-process reference (its gradients sharded
    as ``shard(full) -> this rank's state dict`` when given); the
    gradients' as ``(share of the gate, error, name)``.  A parameter in
    ``zero`` has a gradient that is zero in exact arithmetic (the bias of
    BERT's last LayerNorm, whose output gradient is ``qa_head``'s kernel
    times softmax gradients that each sum to zero over a row), so its
    relative error is rounding over rounding: its error is taken against
    the norm of its LayerNorm's scale gradient instead."""
    worst_f, worst_g = (0.0, None), (0.0, 0.0, None)
    for name, st in precond.layers.items():
        a, g = ref['factors'][name]
        worst_f = max(worst_f,
                      (rel_frob(st.a_factor, a.to(st.a_factor)), name + ' A'),
                      (rel_frob(st.g_factor, g.to(st.g_factor)), name + ' G'))
    want = ref['grads'] if shard is None else shard(ref['grads'])
    for name, p in params:
        if name in zero:
            scale = want[name.rsplit('.', 1)[0] + '.weight'].to(p.grad)
            err = float((p.grad - want[name].to(p.grad)).norm()
                        / scale.norm())
        else:
            err = rel_frob(p.grad, want[name].to(p.grad))
        worst_g = max(worst_g,
                      (err / seq_grad_gate(precond, name), err, name))
    return worst_f, worst_g


def seq_train(torch, kt, dev, ddp, model, precond, batch, loss_fn, steps,
              ref, shard=None, zero=()):
    """``steps`` K-FAC steps with SGD, the fused calls checked against
    plain; per step the loss and the synchronized step time, the first
    step's errors against ``ref`` (``None`` on ranks that only digest)
    and the digests of its factors and gradients; the launches."""
    opt = torch.optim.SGD(model.parameters(), lr=SEQ_HP['lr'])
    out = dict(losses=[], step_s=[])
    fused = kt.ops.fused_eigen_precondition
    sync_device(torch, dev)
    fused.launches = 0
    with KernelCheck(kt.ops.fused_precond) as check:
        for step in range(steps):
            t0 = time.perf_counter()
            opt.zero_grad()
            loss = loss_fn(ddp(batch[0]), batch[1])
            loss.backward()
            if step == 0 and ref is not None:
                want = (ref['raw'] if shard is None
                        else shard(ref['raw']))
                out['raw_err'] = max(
                    (rel_frob(p.grad, want[n].to(p.grad)), n)
                    for n, p in model.named_parameters())
            precond.step()
            sync_device(torch, dev)
            out['step_s'].append(time.perf_counter() - t0)
            out['losses'].append(float(loss.detach()))
            if step == 0:
                params = list(model.named_parameters())
                out['digest'] = layer_digest(
                    torch, [t for st in precond.layers.values()
                            for t in (st.a_factor, st.g_factor)]
                    + [p.grad for _, p in params])
                if ref is not None:
                    out['factor_err'], out['grad_err'] = seq_errors(
                        torch, precond, params, ref, shard, zero)
            opt.step()
    sync_device(torch, dev)
    out.update(launches=fused.launches, **check.summary())
    return out


def seq_ring_check(torch, dev, links):
    """One layer's ring attention (``[4, 2048, 12, 64]``, causal, f32)
    on this rank's quarter against the single-block path on the whole
    sequence (on rank 0, after an all-gather of the quarters); the time
    of one rotation of the ``[2, 4, 512, 12, 64]`` K/V block."""
    import torch.distributed as dist

    from kfac_pytorch_tpu_torch.parallel import ring_attention as ra

    B, T = GPT_BATCH
    H, D = (2, 16) if GPT_MODEL == 'gpt_tiny' else (12, 64)
    gen = torch.Generator(device=dev)
    gen.manual_seed(280)
    q, k, v = (torch.randn(B, T, H, D, generator=gen, device=dev)
               for _ in range(3))
    t = T // links.n
    cols = slice(links.index * t, (links.index + 1) * t)
    with torch.no_grad():
        out = ra.ring_self_attention(q[:, cols], k[:, cols], v[:, cols],
                                     causal=True, links=links)
        parts = [torch.empty_like(out) for _ in range(links.n)]
        dist.all_gather(parts, out.contiguous(), group=links.group)
        err = None
        if links.index == 0:
            full = ra.ring_self_attention(q, k, v, causal=True)
            err = float((torch.cat(parts, 1) - full).abs().max())
            del full
        kv = torch.stack([k[:, cols], v[:, cols]])
        sync_device(torch, dev)
        t0 = time.perf_counter()
        for _ in range(5):
            links.shift(kv, toward_lower=True)
        sync_device(torch, dev)
    return (err, (time.perf_counter() - t0) / 5 * 1e3,
            kv.numel() * kv.element_size(), (B, T, H, D))


def world_rank(rank, world, backend, device_type, workdir, ref_path,
               bert_ref_path):
    """One rank of phase 28's spawn: phase 26's expert group
    (:func:`moe_rank`) and phase 27's stage (:func:`pipe_rank`), then (a)
    the ring GPT over a sequence group of ``world`` and (b)
    ``GPTKFACPreconditioner`` on a ``2 x 2`` (data, model) grid, default
    then prediv, then (c) phase 30b's tensor-parallel BERT on the same
    grid; ranks 0 and 1 hold their first step against the one-process
    references at ``ref_path`` and ``bert_ref_path``; writes
    ``seq{rank}.pt``."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    import kfac_pytorch_tpu_torch as kt
    from kfac_pytorch_tpu_torch.gpt import GPTKFACPreconditioner
    from kfac_pytorch_tpu_torch.models import bert as bert_lib
    from kfac_pytorch_tpu_torch.models.gpt import shard_state_dict
    from kfac_pytorch_tpu_torch.parallel import tensor as tp_lib
    from kfac_pytorch_tpu_torch.parallel.mesh import axis_groups
    from kfac_pytorch_tpu_torch.parallel.ring_attention import \
        sequence_links

    # Four ranks' activations and K-FAC state share one card: segments
    # that grow in place keep the freed attention blocks reusable.
    os.environ['PYTORCH_CUDA_ALLOC_CONF'] = 'expandable_segments:True'
    dev = rt_device(torch, device_type, rank, backend)
    dist.init_process_group(
        backend, init_method=f'file://{workdir}/pg_init', rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=400))
    DDP = torch.nn.parallel.DistributedDataParallel
    res = {}
    for name, body in (('moe', moe_rank), ('pipe', pipe_rank)):
        res[name] = body(torch, kt, dev, world)
        gc.collect()
        torch.cuda.empty_cache()
    tokens = seq_batch(torch, dev)
    B, T = tokens.shape
    # The parent writes the one-process references as the spawn starts,
    # and renames each into place once its memory is free.
    def reference(path):
        deadline = time.time() + SEQ_TIMEOUT_S
        while not os.path.exists(path):
            if time.time() > deadline:
                raise TimeoutError(f'no reference at {path}')
            time.sleep(0.2)
        return torch.load(path, map_location='cpu') if rank < 2 else None

    ref = reference(ref_path)

    # (a) The ring over a sequence group of ``world``.
    grid = axis_groups(1, world, names=('data', 'seq'))
    links = sequence_links(grid, 'seq')
    model = seq_model(torch, kt, dev, attention_impl='ring', seq_axis='seq',
                      seq_links=links)
    ddp = DDP(model)
    precond = kt.KFACPreconditioner(
        ddp, grad_worker_fraction=kt.DistributedStrategy.MEM_OPT, **SEQ_HP)
    t = T // world
    cols = slice(rank * t, (rank + 1) * t)
    targets = torch.cat([tokens[:, 1:],
                         torch.full((B, 1), -100, device=dev)], 1)
    count = B * (T - 1)

    def ring_loss(logits, y):
        return world * F.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), y.reshape(-1),
            ignore_index=-100, reduction='sum') / count

    res['ring'] = seq_train(
        torch, kt, dev, ddp, model, precond,
        (tokens[:, cols], targets[:, cols]), ring_loss, SEQ_STEPS,
        ref if rank == 0 else None)
    res['ring'].update(rotations=links.rotations,
                       rotated_bytes=links.sent_bytes,
                       buckets=kernel_buckets(precond))
    res['n_layers'] = model.config.n_layers
    del model, ddp, precond
    gc.collect()
    torch.cuda.empty_cache()
    (res['attn_err'], res['rotation_ms'], res['rotation_bytes'],
     res['attn_shape']) = seq_ring_check(torch, dev, links)
    gc.collect()
    torch.cuda.empty_cache()

    # (b) GPTKFACPreconditioner on a (data, model) grid of 2 x 2.
    mesh = axis_groups(2, 2, names=('data', 'model'))
    rows = slice(mesh.outer * B // 2, (mesh.outer + 1) * B // 2)

    def lm_loss(logits, y):
        return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                               y[:, 1:].reshape(-1))

    for label, prediv in (('tp default', False), ('tp prediv', True)):
        model = seq_model(torch, kt, dev, tp_group=mesh.group('model'))
        ddp = DDP(model, process_group=mesh.group('data'))
        precond = GPTKFACPreconditioner(
            ddp, mesh=mesh, compute_eigenvalue_outer_product=prediv,
            **SEQ_HP)
        tp_lib.reset_gather_stats()
        res[label] = seq_train(
            torch, kt, dev, ddp, model, precond,
            (tokens[rows], tokens[rows]), lm_loss, TP_STEPS,
            ref if rank < 2 else None,
            lambda full: shard_state_dict(full, mesh.inner, 2))
        res[label].update(
            gathers={k: list(v) for k, v in tp_lib.GATHER_STATS.items()},
            grid=(precond.grid.rows, precond.grid.cols))
        del model, ddp, precond
        gc.collect()
        torch.cuda.empty_cache()
    x = torch.randn(B // 2, T, 3 * 768 // 2, device=dev)
    sync_device(torch, dev)
    t0 = time.perf_counter()
    for _ in range(5):
        tp_lib.gather_features(x, mesh.group('model'), parts=3)
    sync_device(torch, dev)
    res['gather_ms'] = (time.perf_counter() - t0) / 5 * 1e3
    res['gather_bytes'] = 2 * x.numel() * x.element_size()
    del x, ref
    gc.collect()
    torch.cuda.empty_cache()

    # (c) Phase 30b: the tensor-parallel BERT on the same grid, prediv.
    ref = reference(bert_ref_path)
    model = bert_tp_model(torch, kt, dev, tp_group=mesh.group('model'))
    ddp = DDP(model, process_group=mesh.group('data'))
    precond = GPTKFACPreconditioner(
        ddp, mesh=mesh, compute_eigenvalue_outer_product=True, **SEQ_HP)
    tokens, mask, starts, ends = bert_tp_batch(torch, dev)
    half = BERT_TP_BATCH // 2
    rows = slice(mesh.outer * half, (mesh.outer + 1) * half)
    tp_lib.reset_gather_stats()
    res['bert tp'] = seq_train(
        torch, kt, dev, lambda x: ddp(x[0], None, x[1]), model, precond,
        ((tokens[rows], mask[rows]), (starts[rows], ends[rows])),
        bert_tp_loss, BERT_TP_STEPS, ref,
        lambda full: bert_lib.shard_state_dict(full, mesh.inner, 2),
        zero=(f'h_{BERT_TP_LAYERS - 1}.ln_mlp.bias',))
    res['bert tp'].update(
        gathers={k: list(v) for k, v in tp_lib.GATHER_STATS.items()},
        grid=(precond.grid.rows, precond.grid.cols),
        buckets=kernel_buckets(precond), n_layers=BERT_TP_LAYERS)
    del model, ddp, precond
    torch.save(res, os.path.join(workdir, f'seq{rank}.pt'))
    dist.destroy_process_group()


def seq_reference(torch, kt, path, out):
    """The one-process run phase 28's paths are held to: the dense
    GPT-125M (f32, SDPA) under ``KFACPreconditioner`` on the whole batch,
    SGD (:func:`reference_run`)."""
    import torch.nn.functional as F

    dev = torch.device(DEVICE)
    model = seq_model(torch, kt, dev)
    tokens = seq_batch(torch, dev)

    def loss_of():
        logits = model(tokens)
        return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                               tokens[:, 1:].reshape(-1))

    reference_run(torch, path, out, model,
                  kt.KFACPreconditioner(model, **SEQ_HP), loss_of, SEQ_STEPS)


def bert_tp_reference(torch, kt, path, out):
    """The one-process run phase 30b is held to: the same BERT whole under
    ``GPTKFACPreconditioner`` with prediv on the whole batch, SGD."""
    from kfac_pytorch_tpu_torch.gpt import GPTKFACPreconditioner

    dev = torch.device(DEVICE)
    model = bert_tp_model(torch, kt, dev)
    tokens, mask, starts, ends = bert_tp_batch(torch, dev)
    precond = GPTKFACPreconditioner(
        model, compute_eigenvalue_outer_product=True, **SEQ_HP)
    reference_run(torch, path, out, model, precond,
                  lambda: bert_tp_loss(model(tokens, None, mask),
                                       (starts, ends)), BERT_TP_STEPS)


def reference_run(torch, path, out, model, precond, loss_of, steps):
    """``steps`` K-FAC steps with SGD of a one-process reference; saves
    the factors and the raw and preconditioned gradients after step 0
    to ``path`` (written aside and renamed into place, once the card
    memory is freed), and puts the losses and step times in ``out``."""
    dev = torch.device(DEVICE)
    opt = torch.optim.SGD(model.parameters(), lr=SEQ_HP['lr'])
    ref, losses, step_s = {}, [], []
    for step in range(steps):
        sync_device(torch, dev)
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = loss_of()
        loss.backward()
        if step == 0:
            ref['raw'] = {n: p.grad.cpu()
                          for n, p in model.named_parameters()}
        precond.step()
        sync_device(torch, dev)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss.detach()))
        if step == 0:
            ref['factors'] = {n: (st.a_factor.cpu(), st.g_factor.cpu())
                              for n, st in precond.layers.items()}
            ref['grads'] = {n: p.grad.cpu()
                            for n, p in model.named_parameters()}
        opt.step()
    del model, precond, opt
    gc.collect()
    torch.cuda.empty_cache()
    torch.save(ref, path + '.part')
    os.replace(path + '.part', path)
    out.update(losses=losses, step_s=step_s)


def seq_ref_paths(directory: str) -> tuple[str, str]:
    """Where phase 28's ranks find the one-process references: in the
    phase's directory of the shared spawn."""
    return (os.path.join(directory, 'ref.pt'),
            os.path.join(directory, 'bert_ref.pt'))


def seq_references(torch, path, bert_path) -> dict:
    """Phase 28's one-process references, run as its ranks start: the
    dense GPT-125M and the whole BERT, their step-0 state saved at
    ``path`` and ``bert_path``; returns their ``one`` and ``bert_one``
    records."""
    import kfac_pytorch_tpu_torch as kt

    one, bert_one = {}, {}
    seq_reference(torch, kt, path, one)
    bert_tp_reference(torch, kt, bert_path, bert_one)
    return dict(one=one, bert_one=bert_one)


def phase_seq_tp(torch, kt, moe, pipe, ranks, refs):
    """Phase 28 (module docstring) and the four-rank parts of phases 26
    and 27 in the same ranks, held to the one-card runs ``moe`` and
    ``pipe`` (:func:`moe_world_check`, :func:`pipeline_world_check`).
    ``ranks``: the shared spawn's reports; ``refs``: what its
    :func:`seq_references` returned (``None`` when they did not run).
    Returns the kernels-line entries' inputs: the MoE ranks' worst
    kernel error, the GPipe ranks' launches and worst error, and the
    ring's and the TP prediv pass's launches, shapes and worst error."""
    from kfac_pytorch_tpu_torch.parallel.mesh import default_backend

    backend = default_backend(SEQ_WORLD) if DEVICE == 'cuda' else 'gloo'
    if refs is None:
        fail('seq/tp: the one-process references did not run')
    one, bert_one = refs['one'], refs['bert_one']
    losses, ref_s = one['losses'], one['step_s']
    moe_worst = moe_world_check(moe, [r['moe'] for r in ranks], backend)
    pipe_launches, pipe_worst = pipeline_world_check(
        pipe, [r['pipe'] for r in ranks], backend)
    cuda = DEVICE == 'cuda'
    print(f'seq/tp reference: {GPT_MODEL} f32, batch {GPT_BATCH[0]} x '
          f'{GPT_BATCH[1]}, one process, KFACPreconditioner: losses '
          f'{[round(v, 6) for v in losses]}, step times '
          f'{[round(s * 1e3, 2) for s in ref_s]} ms', flush=True)
    print(f'bert tp reference: BERT-large widths, {BERT_TP_LAYERS} blocks, '
          f'f32, batch {BERT_TP_BATCH} x {BERT_TP_SEQ}, one process, '
          f'GPTKFACPreconditioner with prediv: losses '
          f'{[round(v, 6) for v in bert_one["losses"]]}, step times '
          f'{[round(s * 1e3, 2) for s in bert_one["step_s"]]} ms',
          flush=True)
    worst = 0.0
    for label, steps in (('ring', SEQ_STEPS), ('tp default', TP_STEPS),
                         ('tp prediv', TP_STEPS),
                         ('bert tp', BERT_TP_STEPS)):
        runs = [r[label] for r in ranks]
        want_losses = bert_one['losses'] if label == 'bert tp' else losses
        for r, run in enumerate(runs):
            if not torch.equal(run['digest'], runs[0]['digest'] if label ==
                               'ring' else runs[r % 2]['digest']):
                fail(f'{label} rank {r}: factors or gradients differ from '
                     'its peers\'')
            if run['bad']:
                fail(f'{label} rank {r}: kernel vs plain off at '
                     f'{run["bad"][:4]}')
        if label == 'ring':
            got = [sum(r['losses'][i] for r in runs) / SEQ_WORLD
                   for i in range(steps)]
            want_launches = steps * runs[0]['buckets'] * cuda
            launches_ok = all(r['launches'] == want_launches for r in runs)
        elif label == 'bert tp':
            got = [(runs[0]['losses'][i] + runs[2]['losses'][i]) / 2
                   for i in range(steps)]
            launches_ok = all(r['launches'] == steps * r['buckets'] * cuda
                              for r in runs)
        else:
            got = [(runs[0]['losses'][i] + runs[2]['losses'][i]) / 2
                   for i in range(steps)]
            launches_ok = all((r['launches'] > 0) == (cuda and label ==
                                                       'tp prediv')
                              for r in runs)
        loss_err = max(abs(g - w) / abs(w) for g, w in zip(got, want_losses))
        checked = [r for r in runs if 'factor_err' in r]
        f_err, f_at = max(r['factor_err'] for r in checked)
        g_share, g_err, g_at = max(r['grad_err'] for r in checked)
        worst = max([worst] + [r['worst'] for r in runs])
        if not (loss_err <= SEQ_TOL and f_err <= SEQ_TOL
                and g_share <= 1 and launches_ok):
            fail(f'{label}: losses {loss_err:.3e}, factors {f_err:.3e} '
                 f'({f_at}) from one process (gate {SEQ_TOL}), first-step '
                 f'gradients {g_err:.3e} ({g_at}, {g_share:.3f} of its '
                 'eigen gate); launches '
                 f'{[r["launches"] for r in runs]}')
        med = [round(statistics.median(r['step_s'][1:] or r['step_s']) * 1e3,
                     2) for r in runs]
        extra = ''
        if label == 'ring':
            extra = (f'; rotations {runs[0]["rotations"]} a rank '
                     f'({runs[0]["rotated_bytes"]} bytes handed on, '
                     f'forward and backward), one rotation of '
                     f'{ranks[0]["rotation_bytes"]} bytes '
                     f'{ranks[0]["rotation_ms"]:.3f} ms')
        else:
            fac, grd = runs[0]['gathers']['factor'], runs[0]['gathers']['grad']
            blocks = runs[0].get('n_layers', ranks[0]['n_layers'])
            extra = (f'; grid {runs[0]["grid"]} a model index; gathered '
                     f'{fac[1] / steps / blocks:.0f} bytes a '
                     'block a factor '
                     f'step ({fac[0] // steps} gathers a step), '
                     f'{grd[1] / steps:.0f} bytes of weight gradients a step '
                     f'({grd[0] // steps} gathers)')
            if label != 'bert tp':
                extra += (f'; one qkv output gather of '
                          f'{ranks[0]["gather_bytes"]} bytes '
                          f'{ranks[0]["gather_ms"]:.3f} ms')
        print(f'{label} (world {SEQ_WORLD}, {backend}): losses '
              f'{[round(v, 6) for v in got]} within {loss_err:.3e}, step-0 '
              f'factors within {f_err:.3e} ({f_at}; gate {SEQ_TOL}), '
              f'first-step gradients within {g_err:.3e} ({g_at}, '
              f'{g_share:.3f} of its eigen gate max(1e-4, 4 n eps)) of one '
              'process, the raw gradients before the preconditioner within '
              f'{max(r["raw_err"] for r in checked)[0]:.3e} '
              f'({max(r["raw_err"] for r in checked)[1]}); relative '
              'Frobenius; '
              'every rank\'s '
              f'digests equal its peers\'; fused launches '
              f'{[r["launches"] for r in runs]}'
              + (' (no dgda at the default, as in JAX)'
                 if label == 'tp default' else '')
              + f' on {runs[0]["shapes"]}, {check_line(runs)}; median '
              f'step {med} ms by rank (host clock, synchronized; a '
              f'correctness path on one shared card){extra}', flush=True)
    err = ranks[0]['attn_err']
    if not err <= SEQ_ATTN_TOL:
        fail(f'ring attention: {err:.3e} from the single-block path')
    print(f'ring attention: one layer {list(ranks[0]["attn_shape"])} '
          f'causal over {SEQ_WORLD} ranks within {err:.3e} (max abs) of the '
          f'single-block path (gate {SEQ_ATTN_TOL})', flush=True)
    return dict(moe_worst=moe_worst, pipe_launches=pipe_launches,
                pipe_worst=pipe_worst,
                ring_launches=sum(r['ring']['launches'] for r in ranks),
                ring_shapes=ranks[0]['ring']['shapes'],
                tp_launches=sum(r['tp prediv']['launches'] for r in ranks),
                tp_shapes=ranks[0]['tp prediv']['shapes'], worst=worst,
                bert_launches=sum(r['bert tp']['launches'] for r in ranks),
                bert_shapes=ranks[0]['bert tp']['shapes'])


#: Phase 29: the port's ``tiny_gpt_lm`` example at GPT-125M's widths
#: (the example's flags; its default batch 32), factor 1, inv 10, 12
#: steps, full coverage, on ``examples/data/real_text.npz``; lr 0.01,
#: since at these widths the example's default 0.3 sends SGD's loss from
#: 5.57 to 83.5 in six steps on the card (and 0.03 still oscillates on a
#: CPU run at batch 8 x 256).
LM_EXAMPLE_ARGS = ['--layers', '12', '--d-model', '768', '--seq-len', '1024',
                   '--full-coverage', '--factor-update-steps', '1',
                   '--inv-update-steps', '10', '--steps', '12',
                   '--lr', '0.01']


def phase_tiny_gpt_lm(torch, kt):
    """Phase 29: ``tiny_gpt_lm.run()`` twice, SGD then K-FAC
    (``KFACPreconditioner`` with the curvature monitor on), with the
    example's writer and emitter.  Gates: finite falling losses in both
    runs; fused launches (counted from 0 just before the K-FAC run) =
    steps x the buckets that keep ``dgda``; every fused call against its
    plain version.  Returns the launches, the bucket shapes and the
    worst error."""
    from kfac_pytorch_tpu_torch.examples import tiny_gpt_lm
    from kfac_pytorch_tpu_torch.observe import Emitter
    from kfac_pytorch_tpu_torch.utils.metrics import MetricsWriter

    dev = torch.device(DEVICE)
    with tempfile.TemporaryDirectory(prefix='tiny_gpt_') as log_dir:
        args = tiny_gpt_lm.parse_args(LM_EXAMPLE_ARGS + [
            '--device', DEVICE, '--log-dir', log_dir])
        kept, tails, secs = {}, {}, {}
        with MetricsWriter(log_dir, use_tensorboard=False) as writer, \
                Emitter.to_dir(log_dir) as emitter:
            for tag in ('sgd', 'kfac'):
                kept[tag] = {}
                sync_device(torch, dev)
                kt.ops.fused_eigen_precondition.launches = 0
                t0 = time.perf_counter()
                with KernelCheck(kt.ops.fused_precond) as check:
                    tails[tag] = tiny_gpt_lm.run(
                        tag == 'kfac', args, writer, emitter,
                        keep=kept[tag])
                sync_device(torch, dev)
                secs[tag] = time.perf_counter() - t0
                launches = kt.ops.fused_eigen_precondition.launches
        precond = kept['kfac']['precond']
        buckets = kernel_buckets(precond)
        report = precond.coverage_report()
        layers = len(precond.layers)
    want = args.steps * buckets * (DEVICE == 'cuda')
    losses = {tag: kept[tag]['losses'] for tag in kept}
    for tag, run in losses.items():
        if not (all(map(math.isfinite, run)) and run[-1] < run[0]):
            fail(f'tiny_gpt_lm {tag}: losses {run}')
    if launches != want or check.bad:
        fail(f'tiny_gpt_lm: {launches} launches (want {want} = '
             f'{args.steps} x {buckets}), kernel vs plain off at '
             f'{check.bad[:4]}')
    print(f'tiny_gpt_lm: the example\'s run() at {args.layers} layers x '
          f'{args.d_model} (d_ff {2 * args.d_model}, vocab 256), batch '
          f'{args.batch} x {args.seq_len} of real_text.npz, lr {args.lr}, '
          f'factor 1, inv {args.inv_update_steps}, {args.steps} steps, full '
          'coverage '
          f'({layers} layers, uncovered {report["uncovered"]}); losses SGD '
          f'{[round(v, 4) for v in losses["sgd"]]}, K-FAC '
          f'{[round(v, 4) for v in losses["kfac"]]}; tail means '
          f'{tails["sgd"]:.4f} and {tails["kfac"]:.4f}; fused launches '
          f'{launches} ({args.steps} steps x {buckets} buckets) on '
          f'{check.shapes}, {check_line([check.summary()])}; '
          f'{secs["sgd"]:.2f} s and {secs["kfac"]:.2f} s for the runs '
          '(host clock)', flush=True)
    shapes = check.shapes
    del kept, precond
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, shapes=shapes, worst=check.worst)


#: Phase 30: the port's ``squad_bert`` example at BERT-large's widths and
#: depth (the example's defaults: vocab 30522, 24 blocks, 16 heads,
#: 1024/4096, 384 positions, batch 4, AdamW), factor 1, inv 3, one epoch
#: of ``SQUAD_STEPS`` steps on a data file of the real-text QA task, in
#: one process (a 1 x 1 grid).
SQUAD_ARGS = ['--model', 'bert_large', '--seq-len', '384', '--batch-size',
              '4', '--epochs', '1', '--kfac-factor-update-steps', '1',
              '--kfac-inv-update-steps', '3']
SQUAD_STEPS = 3


def phase_squad_bert(torch, kt):
    """Phase 30: ``squad_bert.train()`` twice: at the default (no
    ``dgda``: no launch, as in JAX) for two steps (the schedule's least:
    a one-step epoch leaves the cosine no step), then with
    ``compute_eigenvalue_outer_product=True`` for ``SQUAD_STEPS``.
    Gates: finite losses; the checkpoint written; launches = steps x the
    buckets that keep ``dgda`` with prediv, 0 at the default; every
    fused call against its plain version.  Prints the step and refresh
    times (host clock, synchronized).  Returns the launches, the bucket
    shapes and the worst error."""
    import numpy as np

    from kfac_pytorch_tpu_torch.examples import squad_bert
    from kfac_pytorch_tpu_torch.gpt import GPTKFACPreconditioner

    dev = torch.device(DEVICE)
    seq = int(SQUAD_ARGS[SQUAD_ARGS.index('--seq-len') + 1])
    data = squad_bert.build_realtext_qa(seq, n_examples=4 * SQUAD_STEPS)
    refresh_s = []
    real = GPTKFACPreconditioner._refresh

    def timed(self, damping):
        sync_device(torch, dev)
        t0 = time.perf_counter()
        real(self, damping)
        sync_device(torch, dev)
        refresh_s.append(time.perf_counter() - t0)

    runs = {}
    GPTKFACPreconditioner._refresh = timed
    try:
        with tempfile.TemporaryDirectory(prefix='squad_') as work:
            for label, steps, prediv in (('default', 2, False),
                                         ('prediv', SQUAD_STEPS, True)):
                path = os.path.join(work, f'{label}.npz')
                n = 4 * steps
                np.savez(path, tokens=data[0][:n], starts=data[1][:n],
                            ends=data[2][:n], mask=data[3][:n])
                args = squad_bert.parse_args(SQUAD_ARGS + [
                    '--data-file', path, '--device', DEVICE,
                    '--log-dir', os.path.join(work, label)])
                sync_device(torch, dev)
                del refresh_s[:]
                kt.ops.fused_eigen_precondition.launches = 0
                with KernelCheck(kt.ops.fused_precond) as check:
                    out = squad_bert.train(
                        args, compute_eigenvalue_outer_product=prediv)
                sync_device(torch, dev)
                out.update(launches=kt.ops.fused_eigen_precondition.launches,
                           buckets=kernel_buckets(out['precond']),
                           layers=len(out['precond'].layers),
                           refresh_s=list(refresh_s),
                           saved=os.path.isfile(out['checkpoint']),
                           **check.summary())
                del out['precond']
                runs[label] = out
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        GPTKFACPreconditioner._refresh = real
    cuda = DEVICE == 'cuda'
    for label, out in runs.items():
        steps = len(out['losses'])
        want = steps * out['buckets'] * cuda if label == 'prediv' else 0
        if not (all(map(math.isfinite, out['losses'])) and out['saved']
                and out['launches'] == want and not out['bad']):
            fail(f'squad_bert {label}: losses {out["losses"]}, checkpoint '
                 f'{out["saved"]}, launches {out["launches"]} (want {want}), '
                 f'kernel vs plain off at {out["bad"][:4]}')
    p = runs['prediv']
    step_ms = statistics.median(p['step_s'][1:]) * 1e3
    print(f'squad_bert: BERT-large (24 x 1024/4096, 16 heads, vocab 30522) '
          f'on the real-text QA task, batch 4 x {seq}, one process, '
          f'GPTKFACPreconditioner ({p["layers"]} layers), factor 1, inv 3, '
          f'AdamW: at the default 2 steps, losses '
          f'{runs["default"]["losses"]}, 0 fused launches (no dgda, as in '
          f'JAX); with prediv {SQUAD_STEPS} steps, losses '
          f'{[round(v, 5) for v in p["losses"]]}, fused launches '
          f'{p["launches"]} ({SQUAD_STEPS} steps x {p["buckets"]} buckets) '
          f'on {p["shapes"]}, {check_line([p])}; step times '
          f'{[round(t * 1e3, 2) for t in p["step_s"]]} ms (median of steps '
          f'1-{SQUAD_STEPS - 1} {step_ms:.2f} ms), the refresh of step 0 '
          f'{[round(t * 1e3, 2) for t in p["refresh_s"]]} ms (host clock, '
          'synchronized); checkpoints written', flush=True)
    return dict(launches=p['launches'], shapes=p['shapes'], worst=p['worst'])


#: Phase 31: the host C++ planners and data kernels (a), and
#: ``grad_worker_fraction='auto'`` on a 2 x 2 topology (b).  (a) holds the
#: native greedy and column packer to their Python twins on the registered
#: layers of these models and worlds, under each named strategy.
NATIVE_MODELS = (('ResNet-50', 'resnet50', {}),
                 ('GPT-125M', 'gpt_125m', GPT_FULL),
                 ('BERT-large', 'bert_large', BERT_FULL))
NATIVE_WORLDS = (4, 64)
#: The data kernel's batch: 32 images of 224x224x3 f32 drawn from 64.
NATIVE_DATA = (64, 32, 224)
#: (b): ResNet-50 at world 4, phase 17's images and batch, on two link
#: groups of two ranks (``PodTopology(ici_size=2, n_groups=2)``, the H100
#: data-sheet bandwidths).  Factor 1, inv 1 is the cadence at which the
#: plan leaves HYBRID-OPT for ResNet-50 at world 4 (MEM-OPT; every
#: cadence with ``inv_update_steps >= 2`` keeps HYBRID-OPT:
#: ``tests/test_torch_placement.py`` and the solver on ResNet-50's
#: layers), so each of the 3 steps refreshes.  The auto run and the run
#: at the fraction it chose share the spawn.
PLACE_MODEL = ('resnet50', 1000)
PLACE_TOPOLOGY = dict(ici_size=2, n_groups=2)
PLACE_HP = dict(RN50_HP, factor_update_steps=1, inv_update_steps=1)
PLACE_STEPS = 3
PLACE_TIMEOUT_S = 300


def phase_native(torch, kt):
    """Phase 31 (a): the native planners against their Python twins on
    the work and bucket layouts of :data:`NATIVE_MODELS` at
    :data:`NATIVE_WORLDS` under COMM-OPT, HYBRID-OPT and MEM-OPT (both
    factor placements), and the data kernel's gather, crop and flip of a
    :data:`NATIVE_DATA` batch bit for bit against the numpy twin, with
    both host times.  The libraries were built at the start of the
    script."""
    import numpy as np

    from kfac_pytorch_tpu_torch import _native
    from kfac_pytorch_tpu_torch._native import data as native_data
    from kfac_pytorch_tpu_torch.assignment import KAISAAssignment
    from kfac_pytorch_tpu_torch.capture import DEFAULT_LAYER_TYPES
    from kfac_pytorch_tpu_torch.capture import ModelCapture
    from kfac_pytorch_tpu_torch.examples.cnn_utils.datasets import (
        ArrayLoader,
    )
    from kfac_pytorch_tpu_torch.parallel import bucketing

    if not (_native.available() and native_data.available()):
        fail(f'native: the host libraries did not build: '
             f'{_native.build_error()} {native_data.library.error}')
    checked = []
    for label, name, kw in NATIVE_MODELS:
        model = getattr(kt.models, name)(device=DEVICE)
        helpers = ModelCapture(
            model, skip_layers=(),
            layer_types=kw.get('layer_types', DEFAULT_LAYER_TYPES),
            kfac_approx='expand',
            tied_weights=kw.get('tied_weights', ())).helpers
        del model
        if DEVICE == 'cuda':
            torch.cuda.empty_cache()
        work = {n: {'A': float(h.a_factor_shape[0]) ** 3,
                    'G': float(h.g_factor_shape[0]) ** 3}
                for n, h in helpers.items()}
        square = {n: h for n, h in helpers.items() if not h.diagonal_a}
        for world in NATIVE_WORLDS:
            for strategy in ('COMM_OPT', 'HYBRID_OPT', 'MEM_OPT'):
                rows = {'COMM_OPT': world, 'HYBRID_OPT': world // 2,
                        'MEM_OPT': 1}[strategy]
                groups = [sorted(g) for g in sorted(
                    KAISAAssignment.partition_grad_workers(world, rows),
                    key=min)]
                for colocate in (True, False):
                    got = _native.greedy_assignment(work, groups, world,
                                                    colocate)
                    want = KAISAAssignment.greedy_assignment(
                        work, groups, world, colocate)
                    if got != want:
                        fail(f'native: {label} world {world} {strategy} '
                             f'colocate={colocate}: the native greedy '
                             'differs from the Python twin')
                cols = world // rows
                native_plan = bucketing.make_bucket_plan(square, cols)
                saved = _native.bucket_columns
                _native.bucket_columns = lambda *a, **k: None
                try:
                    python_plan = bucketing.make_bucket_plan(square, cols)
                finally:
                    _native.bucket_columns = saved
                if native_plan != python_plan:
                    fail(f'native: {label} world {world} {strategy}: the '
                         'native column packer differs from the Python '
                         'twin')
        checked.append(f'{label} ({len(work)} layers, '
                       f'{len(native_plan.buckets)} buckets)')
    n_src, n_batch, size = NATIVE_DATA
    rng = np.random.default_rng(31)
    images = rng.standard_normal((n_src, size, size, 3), dtype=np.float32)
    idx = rng.integers(0, n_src, size=n_batch)
    loader = ArrayLoader(images, np.zeros(n_src, np.int32), n_batch,
                         augment=True)
    ys, xs, flips = loader._draw_augment(n_batch, rng)
    times = {'native': [], 'numpy': []}
    for _ in range(5):
        t = time.perf_counter()
        native = native_data.gather_crop_flip(images, idx, loader.PAD, ys,
                                              xs, flips)
        times['native'].append(time.perf_counter() - t)
        t = time.perf_counter()
        plain = loader._augment_numpy(images[idx], ys, xs, flips)
        times['numpy'].append(time.perf_counter() - t)
    if native is None or not np.array_equal(native.view(np.uint32),
                                            plain.view(np.uint32)):
        fail('native: gather_crop_flip differs from the numpy twin')
    med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    print(f'native: planner built in {_native.build_seconds():.2f} s, data '
          f'kernels in {native_data.library.seconds:.2f} s (g++, this '
          'machine); native greedy (both factor placements) and column '
          f'packer equal to the Python twins on {", ".join(checked)} at '
          f'worlds {list(NATIVE_WORLDS)} under COMM-OPT, HYBRID-OPT and '
          f'MEM-OPT; gather_crop_flip of {n_batch}x{size}x{size}x3 f32 '
          f'bitwise the numpy twin: native {med["native"]:.3f} ms, numpy '
          f'{med["numpy"]:.3f} ms (host, median of 5, '
          f'{native_data._threads()} threads)', flush=True)


def placement_rank(rank, world, backend, device_type, workdir, image, batch,
                   model_name):
    """One rank of phase 31 (b); writes ``place{rank}.pt`` to ``workdir``
    and raises on a failed check.  The auto run: the plan's digest
    all-gathered, the plan solved again on the host from ``problem_for``,
    ``validate_plan_payload`` and ``verify_assignment``, the native calls
    of the construction, then :data:`PLACE_STEPS` steps with the bytes
    the port's collectives moved by link class; then the same steps at
    the fixed fraction the plan chose."""
    import dataclasses
    import hashlib

    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    import kfac_pytorch_tpu_torch as kt
    from kfac_pytorch_tpu_torch import _native
    from kfac_pytorch_tpu_torch.observe import costs
    from kfac_pytorch_tpu_torch.placement import apply
    from kfac_pytorch_tpu_torch.placement import solver

    dev = rt_device(torch, device_type, rank, backend)
    dist.init_process_group(
        backend, init_method=f'file://{workdir}/pg_init', rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=300),
    )
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    x = torch.randn(batch, 3, image, image, generator=gen, device=dev)
    y = torch.randint(0, model_name[1], (batch,), generator=gen, device=dev)
    q = batch // world
    xl, yl = x[rank * q:(rank + 1) * q], y[rank * q:(rank + 1) * q]
    fused = kt.ops.fused_eigen_precondition
    topo = kt.PodTopology(**PLACE_TOPOLOGY)

    def checksum(flat):
        return int(flat.view(torch.int32).to(torch.int64).sum())

    def run(fraction, counter=None):
        model = getattr(kt.models, model_name[0])(
            num_classes=model_name[1], device=dev, seed=0)
        ddp = torch.nn.parallel.DistributedDataParallel(
            model, device_ids=None if dev.index is None else [dev.index])
        calls = _native.calls
        precond = kt.KFACPreconditioner(
            ddp, grad_worker_fraction=fraction,
            topology=topo if fraction == 'auto' else None, **PLACE_HP)
        out = dict(native_calls=_native.calls - calls, losses=[], sums=[],
                   moved=[], grid=(precond.grid.rows, precond.grid.cols))
        opt = torch.optim.SGD(model.parameters(), lr=PLACE_HP['lr'],
                              momentum=0.9)
        fused.launches = 0
        for _ in range(PLACE_STEPS):
            opt.zero_grad()
            loss = F.cross_entropy(ddp(xl), yl)
            loss.backward()
            gating = precond._step_gating()
            if counter is not None:
                counter.take(), counter.take_scoped()
            precond.step()
            if counter is not None:
                out['moved'].append(dict(
                    gating=gating, by_phase=counter.take(),
                    by_scope=counter.take_scoped()))
            opt.step()
            out['losses'].append(float(loss.detach()))
            out['sums'].append(checksum(torch.cat(
                [p.detach().reshape(-1) for p in model.parameters()])))
        out['launches'] = fused.launches
        out['params'] = torch.cat([p.detach().reshape(-1).cpu()
                                   for p in model.parameters()])
        out['n_buckets'] = sum(precond._second_order.bucket_prediv(b.key)
                               for b in precond.plan.buckets)
        out['shards'] = [tuple(precond.buckets[b.key].qa.shape[:1])
                         + (b.g_pad, b.a_pad) for b in precond.plan.buckets]
        return out, precond, model, ddp, opt

    counter = CollectiveBytes(dist, scope_of=topo.scope_of)
    try:
        auto, precond, *rest = run('auto', counter)
    finally:
        counter.close()
    plan = precond.placement_plan
    payload = json.dumps(apply.plan_payload(plan), sort_keys=True)
    digest = hashlib.sha256(payload.encode()).digest()
    mine = torch.tensor([int.from_bytes(digest[i:i + 8], 'little',
                                        signed=True) for i in (0, 8)],
                        dtype=torch.int64, device=dev)
    every = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(every, mine)
    calls = _native.calls
    host = json.dumps(apply.plan_payload(solver.auto_placement(
        solver.problem_for(precond), topo)), sort_keys=True)
    apply.verify_assignment(plan, precond.assignment)
    auto.update(
        payload=payload, host_equal=host == payload,
        host_native_calls=_native.calls - calls,
        digests_equal=all(torch.equal(e, mine) for e in every),
        problems=apply.validate_plan_payload(json.loads(payload)),
        fraction=plan.fraction, strategy=plan.strategy,
        n_candidates=len(plan.candidates),
        rows=[dataclasses.asdict(r) for r in costs.ledger_for(precond)],
        report=precond.placement_report() if rank == 0 else None,
        descriptor=precond._topology_descriptor())
    del precond, rest
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    fixed, *rest = run(plan.fraction)
    auto['fixed_equal'] = (fixed['losses'] == auto['losses']
                           and fixed['sums'] == auto['sums']
                           and torch.equal(fixed['params'], auto['params'])
                           and fixed['grid'] == auto['grid'])
    auto['fixed_launches'] = fixed['launches']
    del rest, auto['params']
    torch.save(auto, os.path.join(workdir, f'place{rank}.pt'))
    dist.barrier()
    dist.destroy_process_group()


def phase_resnet50_placement(torch, kt, ranks=None):
    """Phase 31 (b): four ranks of :func:`placement_rank` (``ranks``:
    their reports from :func:`spawn_shared`).  Gates: every rank's plan
    payload identical (its digest all-gathered) and equal to the plan it
    solves again on the host from ``problem_for``; no problem from
    ``validate_plan_payload``; ``verify_assignment`` passed; the native
    planner ran during the solve; the sharded kernel launched steps x
    buckets on every rank; losses and parameters bitwise equal to the run
    at the fixed fraction the plan chose; the ledger's rows tagged by the
    topology's rule, and at every step, per link class and per phase, the
    bytes the ranks' collectives moved equal to the payloads of the rows
    that fired; finite falling losses.  Prints the placement report and
    returns the kernels-line entry, timed at rank 0's shard shapes."""
    from kfac_pytorch_tpu_torch.observe import costs
    from kfac_pytorch_tpu_torch.placement import apply

    label = 'resnet50 placement'
    if ranks is None:
        ranks = spawn_alone(torch, '31')
    r0 = ranks[0]
    topo = kt.PodTopology(**PLACE_TOPOLOGY)
    rows, cols = r0['grid']
    world_s, col_s, row_s = costs.grid_scopes(topo, rows, cols)
    want_scope = {'data': world_s, 'mesh': world_s, 'kfac_row': col_s,
                  'kfac_col': row_s, '-': 'host'}
    per_step = r0['n_buckets'] if DEVICE == 'cuda' else 0
    for i, r in enumerate(ranks):
        bad = [k for k in ('digests_equal', 'host_equal', 'fixed_equal')
               if not r[k]]
        if bad or r['payload'] != r0['payload'] or r['problems']:
            fail(f'{label} rank {i}: {bad} payload problems '
                 f'{r["problems"]}')
        # The solve prices each candidate grid through the native greedy,
        # and the flat model once more.
        if (r['host_native_calls'] < r['n_candidates'] + 1
                or r['native_calls'] < r['n_candidates'] + 1):
            fail(f'{label} rank {i}: native calls {r["native_calls"]} in '
                 f'the construction, {r["host_native_calls"]} in the host '
                 'solve')
        if r['launches'] != PLACE_STEPS * per_step or (
                r['fixed_launches'] != r['launches']):
            fail(f'{label} rank {i}: {r["launches"]} launches (fixed '
                 f'{r["fixed_launches"]}), expected '
                 f'{PLACE_STEPS * per_step}')
        tags = {row['phase']: row['scope'] for row in r['rows']}
        wrong = {row['phase']: row['scope'] for row in r['rows']
                 if row['scope'] != want_scope[row['axis']]}
        if wrong or not {'ici', 'dcn'} & set(tags.values()):
            fail(f'{label} rank {i}: ledger scopes {tags}')
        for t, step in enumerate(r['moved']):
            factor, inv = step['gating']
            fired = {'step'} | ({'factor_step'} if factor else set()) | (
                {'inv_step'} if inv else set())
            want_phase, want_by_scope = {}, {}
            for row in r['rows']:
                if row['cadence'] in fired and row['payload_bytes']:
                    want_phase[row['phase']] = row['payload_bytes']
                    want_by_scope[row['scope']] = (
                        want_by_scope.get(row['scope'], 0)
                        + row['payload_bytes'])
            moved = {k: v for k, v in step['by_phase'].items()
                     if k != 'other'}
            if moved != want_phase or step['by_scope'] != want_by_scope:
                fail(f'{label} rank {i} step {t}: moved {moved} by phase, '
                     f'{step["by_scope"]} by scope; ledger {want_phase}, '
                     f'{want_by_scope}')
    losses = [statistics.fmean(v) for v in zip(*(r['losses'] for r in ranks))]
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        fail(f'{label}: mean losses {losses}')
    payload = json.loads(r0['payload'])
    if apply.validate_plan_payload(payload):
        fail(f'{label}: {apply.validate_plan_payload(payload)}')
    print(r0['report'], flush=True)
    print(f'{label}: ResNet-50 at world {len(ranks)} on one card, '
          f'{RN50_BATCH // len(ranks)} images a rank at '
          f'{RN50_IMAGE}x{RN50_IMAGE}, factor 1, inv 1, '
          f'grad_worker_fraction=\'auto\' on {topo}: plan {rows}x{cols} '
          f'({r0["strategy"]}, fraction {r0["fraction"]:g}; best named '
          f'{payload["best_fixed"]["strategy"]}), the same payload on every '
          'rank and equal to the host re-solve from problem_for, valid; '
          f'native calls {r0["native_calls"]} in the construction; losses '
          'and parameters bitwise the fixed-fraction run\'s at all '
          f'{PLACE_STEPS} steps; launches {r0["launches"]} a rank; mean '
          f'loss {losses[0]:.6f} -> {losses[-1]:.6f}; ledger scopes '
          f'{ {row["phase"]: row["scope"] for row in r0["rows"]} }; bytes '
          'moved by link class equal the ledger\'s at every step (rank 0: '
          + '; '.join(f'step {t} {json.dumps(s["by_scope"])}'
                      for t, s in enumerate(r0['moved']))
          + f'); {r0["descriptor"]}', flush=True)
    entry = bucket_entry(
        torch, kt.ops.fused_eigen_precondition,
        kt.ops.fused_eigen_precondition_reference,
        f'ResNet-50 auto-placed {r0["strategy"]} shards (rank 0, phase 31)',
        [tuple(c) for c in r0['shards']], 1100)
    entry.update(
        name='fused_eigen_precondition_sharded, ResNet-50 at world 4 on the '
             'auto-placed grid (grad_worker_fraction=\'auto\', phase 31)',
        replaces='kfac_pytorch_tpu/ops/pallas_precond.py:151',
        launches=sum(r['launches'] for r in ranks))
    return entry


#: ``(L, gp, ap)`` of the flavours' stacks: phase 26's five layers (the
#: expert stacks unaligned: ``ap`` 769 and 3073, padded on the path) and
#: phase 27's per rank (each shape three times a step, once a block).
MOE_CASES = [(8, 3072, 769), (8, 768, 3073), (1, 768, 769), (1, 8, 768),
             (1, 8, 769)]
PIPE_LM_CASES = [(1, 2304, 769), (1, 768, 769), (1, 3072, 769),
                 (1, 768, 3073)]


PROFILE_MODEL = 'resnet50'  # b32, 224x224, factor 10, inv 100
PROFILE_ITERS = 5
PROFILE_BATCH = None  # the variant mode's own (32 for ResNet-50)
PROFILE_IMAGE = None
ELASTIC_DRILL_WORLDS = (8, 4, 2)
PROFILE_CHECK = (1, 1024, 2176)  # ResNet-50's a2176g1024 slot


def phase_profile_drill(torch, kt):
    """Phase 32: the port's scripts on the card.  (a) ``profile_step``'s
    variant mode on ResNet-50 at full width (batch 32, 224x224, factor
    10, inv 100, ``PROFILE_ITERS`` timed calls a window): the four
    variant times, the amortized time and its ratio to SGD; gates: every
    time finite, 21 fused-kernel launches a K-FAC call of each variant,
    and one call of the kernel at a ResNet-50 bucket shape against its
    plain version at ``rtol 1e-5, atol 1e-4``; then the iterative, stagger
    and phase-profile smokes, each validator passing (their timing pins,
    the warm Newton-Schulz speed, the staggered flatness and the phases'
    sum within 10% of the total, are the card's to hold).  (b), the
    elastic drill, runs beside phase 33 (:func:`start_elastic_drill`).
    Returns ``(launches, max_abs_err)`` of the variant mode's run."""
    from kfac_pytorch_tpu_torch.scripts import profile_step

    gc.collect()
    kernel = kt.ops.fused_eigen_precondition
    kernel.launches = 0
    t = time.perf_counter()
    payload = profile_step.run_variants(
        PROFILE_MODEL, DEVICE, PROFILE_ITERS, batch=PROFILE_BATCH,
        image=PROFILE_IMAGE)
    launches = kernel.launches
    took = time.perf_counter() - t
    times = dict(payload['phases_ms'], sgd=payload['sgd_ms'])
    if not all(math.isfinite(v) and v > 0 for v in times.values()):
        fail(f'profile variants: times {times}')
    per_call = payload['kernel_launches_per_call']
    if DEVICE == 'cuda' and any(v != 21 for v in per_call.values()):
        fail(f'profile variants: fused-kernel launches a call {per_call}, '
             'expected 21 (one a ResNet-50 bucket)')
    if DEVICE == 'cuda' and launches <= 0:
        fail('profile variants: the fused kernel never launched')
    args = make_case(torch, *PROFILE_CHECK, 3200)
    got = kernel(*args)
    want = kt.ops.fused_eigen_precondition_reference(*args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
    # The preconditioned gradient's error (the clip sums run to ~1e5 and
    # are held relatively by the rtol above).
    err = float((got[0] - want[0]).abs().max())
    print(f'profile variants {PROFILE_MODEL} (b{payload["batch"]}, '
          f'{payload["image"]}x{payload["image"]}, factor '
          f'{payload["cadence"]["factor"]}, inv {payload["cadence"]["inv"]},'
          f' iters {PROFILE_ITERS}): sgd {payload["sgd_ms"]} ms, plain '
          f'{times["plain"]} ms, factor {times["factor"]} ms, inv '
          f'{times["inv"]} ms; amortized {payload["amortized_ms"]} ms, '
          f'ratio {payload["amortized_ratio"]}; fused-kernel launches '
          f'{launches} ({per_call} a call); kernel at {PROFILE_CHECK} vs '
          f'plain: preconditioned gradient max abs err {err:.3e}; '
          f'{took:.2f} s', flush=True)

    # The iterative smoke's pin (warm Newton–Schulz strictly faster than
    # eigh on every shape) is a claim about the card: its validator runs
    # here.
    path = os.path.join(tempfile.mkdtemp(prefix='phase32_'),
                        'iterative.json')
    t = time.perf_counter()
    if profile_step.run_iterative_smoke(path, DEVICE) != 0:
        fail(f'iterative smoke: its validator refused {path}')
    with open(path) as fh:
        detail = json.load(fh)['detail']
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    print('iterative smoke: warm Newton-Schulz against eigh '
          + ', '.join(f'{e["shape"]} {e["eigh_ms"]:.4f} / '
                      f'{e["ns_warm_ms"]:.4f} ms' for e in detail['shapes'])
          + f'; speedup min {detail["warm_vs_eigh_speedup_min"]:.3f}, max '
          f'{detail["warm_vs_eigh_speedup_max"]:.3f}; valid; '
          f'{time.perf_counter() - t:.2f} s', flush=True)

    # The stagger smoke's flatness and the phase profile's sum against
    # its total: timings, held here.
    for name, run in (('stagger', profile_step.run_stagger_smoke),
                      ('profile', profile_step.run_smoke)):
        path = os.path.join(tempfile.mkdtemp(prefix='phase32_'),
                            f'{name}.json')
        t = time.perf_counter()
        if run(path, DEVICE) != 0:
            fail(f'{name} smoke: its validator refused {path}')
        with open(path) as fh:
            detail = json.load(fh)['detail']
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
        if name == 'stagger':
            what = (f'max/p50 monolithic {detail["mono_max_over_p50"]}, '
                    f'staggered {detail["stag_max_over_p50"]}; ledger '
                    f'interval ratio {detail["ledger_interval_ratio"]}')
        else:
            what = (f'phases {detail["phases_ms"]} ms, sum/total '
                    f'{detail["phase_sum_vs_total"]}')
        print(f'{name} smoke: {what}; valid; '
              f'{time.perf_counter() - t:.2f} s', flush=True)

    return launches, err


#: Phase 32b's drill must end within this long of its start.
ELASTIC_DRILL_TIMEOUT_S = 600


def start_elastic_drill():
    """Phase 32b: ``fault_drill --elastic`` at ``ELASTIC_DRILL_WORLDS``
    (gloo ranks on ``cuda:0``; the mid-save kill, the bitwise same-world
    resume, two resizes, the layers-only recompute), started as a process
    of its own, in a session of its own, so that it runs beside phase 33:
    its ranks spend most of their time starting and opening the card.
    Returns ``(process, artifact path, log path, start time)`` for
    :func:`finish_elastic_drill` (or :func:`stop_elastic_drill`)."""
    import subprocess

    work = tempfile.mkdtemp(prefix='phase32_')
    out = os.path.join(work, 'elastic.json')
    log = os.path.join(work, 'elastic.log')
    with open(log, 'w') as fh:
        proc = subprocess.Popen(
            [sys.executable, '-m', 'kfac_pytorch_tpu_torch.scripts.fault_drill',
             '--elastic', '--device', DEVICE, '--worlds',
             ','.join(str(w) for w in ELASTIC_DRILL_WORLDS),
             '--json-out', out],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=fh,
            stderr=subprocess.STDOUT, start_new_session=True)
    return proc, out, log, time.perf_counter()


def stop_elastic_drill(drill) -> None:
    """Kill the drill's whole session (its ranks too) if it still runs."""
    import signal

    proc = drill[0]
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    shutil.rmtree(os.path.dirname(drill[1]), ignore_errors=True)


def finish_elastic_drill(drill) -> float:
    """Wait for :func:`start_elastic_drill`'s drill, print its log, pass
    its artifact to the port's validator and print the summary; returns
    the drill's seconds from its start."""
    import subprocess

    from kfac_pytorch_tpu_torch.scripts import fault_drill

    proc, out, log, t0 = drill
    try:
        rc = proc.wait(timeout=max(
            1.0, ELASTIC_DRILL_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        stop_elastic_drill(drill)
        fail(f'elastic drill at worlds {ELASTIC_DRILL_WORLDS}: not done '
             f'within {ELASTIC_DRILL_TIMEOUT_S} s')
    took = time.perf_counter() - t0
    with open(log) as fh:
        print(fh.read(), end='', flush=True)
    try:
        if rc != 0 or fault_drill.validate_elastic_artifact(out) != 0:
            fail(f'elastic drill at worlds {ELASTIC_DRILL_WORLDS}: rc {rc}')
        with open(out) as fh:
            phases = json.load(fh)['phases']
    finally:
        stop_elastic_drill(drill)
    print(f'elastic drill {ELASTIC_DRILL_WORLDS}: valid; same-world resume '
          f'bitwise {phases["same_world_bitwise"]["bitwise_equal"]} from '
          f'{phases["same_world_bitwise"]["restored_generation"]}; resize '
          f'rel err {phases["resize_divergence"]["param_rel_err"]:.3e}; '
          f'layers-only recomputed '
          f'{phases["layers_only_recompute"]["recomputed"]} (rel err '
          f'{phases["layers_only_recompute"]["param_rel_err"]:.3e}); '
          f'{took:.2f} s from its start (beside phase 33)', flush=True)
    return took


#: Phase 33: the retrace guard (33a), the compiled precondition tail
#: (33b) and the sync guard (33c).  JAX's damping-sweep test at full
#: width: factor 2, inv 4, damping swept by step over three values, the
#: K-FAC lr a new value every step (``guard_lr``).
GUARD_HP = dict(RN50_HP, factor_update_steps=2, inv_update_steps=4)
GUARD_DAMPINGS = (1e-3, 3e-3, 1e-2)
GUARD_STEPS = 9  # every (damping, variant) pairing occurs
GUARD_BUDGET = 3  # plain, factor and inv
#: 33c's steps after the sweep: step -> sync debug mode.
SYNC_STEPS = {9: 'error', 10: 'warn', 11: 'error', 12: 'warn', 13: 'error'}
#: 33b's contrast: the compiled tail called with Python-float lrs.
FLOAT_LRS = (0.1, 0.05, 0.02)
#: The eager op's host cost: calls timed on the host, no sync between.
HOST_CALLS = 2000


def guard_damping(step: int) -> float:
    return GUARD_DAMPINGS[step % len(GUARD_DAMPINGS)]


def guard_lr(step: int) -> float:
    """The K-FAC lr, a new value every step (a per-step schedule, as a
    trainer's decay is): every step makes a new canonical scalar."""
    return GUARD_HP['lr'] / (1 + step)


def guard_engine(torch, kt, model_name, budget):
    """A fresh model (seed 0) and its K-FAC engine under ``GUARD_HP``
    with the damping sweep; ``budget`` attaches the retrace guard."""
    if model_name == 'resnet50':
        model = kt.models.resnet50(device=DEVICE, seed=0)
    else:
        model = kt.models.resnet32(device=DEVICE, seed=0)
    hp = dict(GUARD_HP, damping=guard_damping, lr=guard_lr)
    precond = kt.KFACPreconditioner(model, compile_budget=budget, **hp)
    opt = torch.optim.SGD(model.parameters(), lr=GUARD_HP['lr'],
                          momentum=0.9)
    return model, precond, opt


def guard_step(torch, model, precond, opt, batch, keep=False):
    """One step as a user runs it; returns ``(loss, gradients after
    the K-FAC step or None, host seconds of precond.step())``."""
    import torch.nn.functional as F

    opt.zero_grad(set_to_none=True)
    loss = F.cross_entropy(model(batch[0]), batch[1])
    loss.backward()
    t0 = time.perf_counter()
    precond.step()
    host_s = time.perf_counter() - t0
    grads = [p.grad.clone() for p in model.parameters()] if keep else None
    opt.step()
    return loss.detach(), grads, host_s


def compile_tail(torch, precond, backend, keep):
    """Replace the engine's bucket tail by ``torch.compile(fullgraph=
    True)`` of it in the step variants ``keep`` (the engine's
    ``_last_variant``), the eager tail in the others; returns
    ``(compiled, launches of each compiled call by variant, the eager
    tail, a retrace guard over the compiled calls' inputs)``.  The guard
    signs what Dynamo compiles against: one key, the tail's inputs."""
    from kfac_pytorch_tpu_torch.analysis.retrace import RetraceGuard

    so = precond._second_order
    eager = so.precondition
    compiled = torch.compile(eager, fullgraph=True, backend=backend)
    tail_guard = RetraceGuard()
    launches: dict = {}
    kernel = precond_kernel()

    def tail(buckets, grads, damping, kl_clip, lr, extra_clip_terms=()):
        variant = precond._last_variant
        if variant not in keep:
            return eager(buckets, grads, damping, kl_clip, lr,
                         extra_clip_terms)
        tail_guard.observe_call(
            'precondition_tail',
            (buckets, grads, damping, kl_clip, lr, extra_clip_terms), {})
        before = kernel.launches
        out = compiled(buckets, grads, damping, kl_clip, lr,
                       extra_clip_terms)
        launches.setdefault(variant, []).append(kernel.launches - before)
        return out

    so.precondition = tail
    return compiled, launches, eager, tail_guard


def precond_kernel():
    from kfac_pytorch_tpu_torch.ops import fused_precond

    return fused_precond.fused_eigen_precondition


def tail_gate(torch, precond, model, batch, compiled, eager, label):
    """The compiled tail against the eager tail on one fresh gradient of
    ``batch`` at the engine's state, every layer within the kernel gate
    (``rtol 1e-5, atol 1e-4``); returns ``(max abs err, compiled ms,
    eager ms, the gate's args)`` (CUDA events, the tail alone)."""
    import torch.nn.functional as F

    model.zero_grad(set_to_none=True)
    F.cross_entropy(model(batch[0]), batch[1]).backward()
    grads = {n: h.get_grad() for n, h in precond.helpers.items()}
    damping, kl_clip, lr = precond._tail_hyperparams()
    args = (precond.buckets, grads, damping, kl_clip, lr)
    with torch.no_grad():  # as the step calls it: no recompile
        want, want_scale = eager(*args)
        got, scale = compiled(*args)
    worst = 0.0
    for name, w in want.items():
        diff = (got[name] - w).abs()
        worst = max(worst, float(diff.max()))
        if bool((diff > 1e-4 + 1e-5 * w.abs()).any()):
            fail(f'{label}: the compiled tail disagrees with the eager tail '
                 f'at {name} (max abs err {float(diff.max()):.3e})')
    if not torch.allclose(scale, want_scale, rtol=1e-5, atol=0):
        fail(f'{label}: kl-clip scale {float(scale)} != '
             f'{float(want_scale)}')
    with torch.no_grad():
        ms = time_ms(torch, lambda: compiled(*args), reps=10)
        eager_ms = time_ms(torch, lambda: eager(*args), reps=10)
    model.zero_grad(set_to_none=True)
    return worst, ms, eager_ms, args


def sync_sites(records) -> dict:
    """``{'file:line': count}`` of the synchronizing calls ``'warn'``
    reported (each warning names the Python line that made the call)."""
    sites: dict = {}
    for w in records:
        if 'synchroniz' not in str(w.message):
            continue
        site = f'{os.path.relpath(w.filename)}:{w.lineno}'
        sites[site] = sites.get(site, 0) + 1
    return dict(sorted(sites.items(), key=lambda kv: -kv[1]))


def phase_guard(torch, kt):
    """33a and 33c: ResNet-50 b32 at 224x224, factor 2, inv 4, the damping
    swept over ``GUARD_DAMPINGS`` and the lr decayed by step for
    ``GUARD_STEPS`` steps, once unguarded and once with ``compile_budget=3``: 3 programs, 0
    retraces, and every step's loss and gradients bitwise the unguarded
    run's.  Then the guarded engine steps on with each ``plain`` step (a
    new lr each) under ``torch.cuda.set_sync_debug_mode('error')`` and the ``factor``
    and ``inv`` steps under ``'warn'``, their syncs counted by call
    site.  Returns the guarded run's kernel launches."""
    deterministic = torch.backends.cudnn.deterministic
    # Two runs bitwise: cuDNN's default convolution backward sums in no
    # fixed order.
    torch.backends.cudnn.deterministic = True
    try:
        return guard_runs(torch, kt)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def guard_runs(torch, kt):
    """:func:`phase_guard`'s runs (cuDNN deterministic)."""
    import warnings

    batch = rn50_batch(torch)
    runs = []
    for budget in (None, GUARD_BUDGET):
        gc.collect()
        torch.cuda.empty_cache()
        model, precond, opt = guard_engine(torch, kt, 'resnet50', budget)
        kernel = precond_kernel()
        torch.cuda.synchronize()
        kernel.launches = 0
        out = []
        for _ in range(GUARD_STEPS):
            out.append(guard_step(torch, model, precond, opt, batch,
                                  keep=True))
        torch.cuda.synchronize()
        launches = kernel.launches
        if budget is None:
            runs.append(out)
            del model, precond, opt
            continue
        for i, ((la, ga, _), (lb, gb, _)) in enumerate(zip(runs[0], out)):
            if not (torch.equal(la, lb)
                    and all(torch.equal(a, b) for a, b in zip(ga, gb))):
                fail(f'guard: step {i} of the guarded run is not bitwise '
                     'the unguarded run\'s')
        guard = precond.retrace_guard
        if (guard.compiles, guard.retraces) != (GUARD_BUDGET, 0):
            fail(f'guard: {guard.compiles} programs and {guard.retraces} '
                 f'retraces, expected {GUARD_BUDGET} and 0:\n'
                 + guard.report())
        if launches != GUARD_STEPS * len(RN50_CASES):
            fail(f'guard: {launches} kernel launches, expected '
                 f'{GUARD_STEPS} x {len(RN50_CASES)}')
        host = {b: statistics.median([s for _, _, s in r[1::2]])
                for b, r in zip(('unguarded', 'guarded'), (runs[0], out))}
        print(f'guard resnet50: {GUARD_STEPS} steps, damping swept over '
              f'{list(GUARD_DAMPINGS)}, K-FAC lr {GUARD_HP["lr"]}/(1+step): '
              f'{guard.compiles} programs '
              f'{guard.keys()}, {guard.retraces} retraces, losses '
              f'{[round(float(l), 5) for l, _, _ in out]} bitwise the '
              f'unguarded run\'s with every gradient; {launches} kernel '
              'launches; median host time of precond.step() on plain '
              f'steps: unguarded {host["unguarded"] * 1e3:.3f} ms, guarded '
              f'{host["guarded"] * 1e3:.3f} ms', flush=True)
        del runs, out
        # 33c on the guarded engine.
        opt_sites: dict = {}
        for step_index, mode in SYNC_STEPS.items():
            if precond.steps != step_index:
                fail(f'sync: engine at step {precond.steps}, expected '
                     f'{step_index}')
            variant = precond._step_variant(*precond._step_gating())
            with warnings.catch_warnings(record=True) as records:
                warnings.simplefilter('always')
                torch.cuda.set_sync_debug_mode(mode)
                try:
                    try:
                        import torch.nn.functional as F

                        opt.zero_grad(set_to_none=True)
                        loss = F.cross_entropy(model(batch[0]), batch[1])
                        loss.backward()
                        precond.step()
                    except RuntimeError as exc:
                        fail(f'sync: {variant} step {step_index} made a '
                             f'host sync under \'error\': {exc}')
                finally:
                    torch.cuda.set_sync_debug_mode('default')
                sites = sync_sites(records)
            with warnings.catch_warnings(record=True) as records:
                warnings.simplefilter('always')
                torch.cuda.set_sync_debug_mode('warn')
                try:
                    opt.step()
                finally:
                    torch.cuda.set_sync_debug_mode('default')
                for site, n in sync_sites(records).items():
                    opt_sites[site] = opt_sites.get(site, 0) + n
            torch.cuda.synchronize()
            if mode == 'error':
                print(f'sync resnet50 {variant} step {step_index}: forward, '
                      'backward and precond.step() under '
                      'set_sync_debug_mode(\'error\'), K-FAC lr '
                      f'{guard_lr(step_index):.6g} new this step: no host '
                      'sync', flush=True)
            else:
                print(f'sync resnet50 {variant} step {step_index} under '
                      f'\'warn\': {sum(sites.values())} host syncs by call '
                      f'site: {json.dumps(sites)}', flush=True)
        print(f'sync resnet50: optimizer.step() (SGD, momentum 0.9) under '
              f'\'warn\' over {len(SYNC_STEPS)} steps: '
              f'{sum(opt_sites.values())} host syncs {json.dumps(opt_sites)}',
              flush=True)
        if (guard.compiles, guard.retraces) != (GUARD_BUDGET, 0):
            fail(f'guard: {guard.compiles} programs after the sync steps')
        del model, precond, opt
        gc.collect()
        torch.cuda.empty_cache()
        return launches
    return None


def phase_compiled_tail(torch, kt, model_name, backend, keep,
                        float_sweep=False):
    """33b: the bucket tail under ``torch.compile(fullgraph=True,
    backend=backend)`` in the step variants ``keep``, over the damping
    sweep (``GUARD_STEPS`` steps of ``GUARD_HP``, guarded): no graph
    break, Dynamo's graphs equal the programs a retrace guard counts over
    the compiled calls' inputs (the sweep adds none: damping reaches the
    tail as a canonical 0-d tensor), each compiled call launches the
    kernel once per bucket, and the compiled tail is within the kernel
    gate of the eager tail.  With ``float_sweep`` the same tail is then
    called with ``FLOAT_LRS`` as Python floats, and the graphs that adds
    are printed.  Returns ``(launches, max abs err, compiled ms,
    eager ms)``."""
    from torch._dynamo.utils import counters

    gc.collect()
    torch.cuda.empty_cache()
    torch._dynamo.reset()
    if backend == 'inductor':
        import torch._inductor.config

        # Compile in this process: no pool of compile workers outlives
        # the phase.
        torch._inductor.config.compile_threads = 1
    model, precond, opt = guard_engine(torch, kt, model_name, GUARD_BUDGET)
    if model_name == 'resnet50':
        batch = rn50_batch(torch)
    else:
        batch = fixed_batch(torch)
    n_buckets = len(precond.plan.buckets)
    compiled, per_call, eager, tail_guard = compile_tail(
        torch, precond, backend, keep)
    graphs0 = counters['stats']['unique_graphs']
    breaks0 = sum(counters['graph_break'].values())
    kernel = precond_kernel()
    torch.cuda.synchronize()
    kernel.launches = 0
    t0 = time.perf_counter()
    for _ in range(GUARD_STEPS):
        guard_step(torch, model, precond, opt, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel.launches
    graphs = counters['stats']['unique_graphs'] - graphs0
    breaks = sum(counters['graph_break'].values()) - breaks0
    guard = precond.retrace_guard
    label = f'compiled tail {model_name} ({backend})'
    if breaks:
        fail(f'{label}: {breaks} graph breaks')
    if set(per_call) != set(keep):
        fail(f'{label}: compiled calls in {sorted(per_call)}, expected '
             f'{sorted(keep)}')
    if graphs != tail_guard.compiles or tail_guard.retraces:
        fail(f'{label}: Dynamo made {graphs} graphs over the sweep; the '
             f'guard counts {tail_guard.compiles} programs and '
             f'{tail_guard.retraces} retraces of the tail\'s inputs:\n'
             + tail_guard.report())
    bad = {v: c for v, c in per_call.items() if set(c) != {n_buckets}}
    if bad:
        fail(f'{label}: kernel launches per compiled call {bad}, expected '
             f'{n_buckets}')
    if launches != GUARD_STEPS * n_buckets:
        fail(f'{label}: {launches} launches over {GUARD_STEPS} steps')
    if (guard.compiles, guard.retraces) != (GUARD_BUDGET, 0):
        fail(f'{label}: the engine guard has {guard.compiles} programs and '
             f'{guard.retraces} retraces')
    worst, ms, eager_ms, args = tail_gate(torch, precond, model, batch,
                                          compiled, eager, label)
    calls = {v: len(c) for v, c in per_call.items()}
    print(f'{label}: {n_buckets} buckets, compiled with fullgraph=True in '
          f'the variants {calls} (calls each): {breaks} graph breaks, '
          f'{graphs} Dynamo graph(s) = the {tail_guard.compiles} program(s) '
          f'a retrace guard counts over the compiled calls\' inputs over '
          f'the damping sweep {list(GUARD_DAMPINGS)} (the engine\'s guard: '
          f'{guard.compiles} step-variant programs, {guard.retraces} '
          f'retraces); {n_buckets} launches a compiled call, {launches} '
          f'over {GUARD_STEPS} steps ({seconds:.2f} s, the compile '
          f'included); compiled tail {ms:.5f} ms against eager '
          f'{eager_ms:.5f} ms a call; max abs err against eager '
          f'{worst:.3e}', flush=True)
    if float_sweep:
        # The prediv tail reads no damping; lr enters every clip term.
        before = counters['stats']['unique_graphs']
        buckets, grads, damping, kl_clip, _ = args
        with torch.no_grad():
            for lr in FLOAT_LRS:
                compiled(buckets, grads, damping, kl_clip, lr)
        torch.cuda.synchronize()
        print(f'{label}: the same tail with lr as a Python float over '
              f'{list(FLOAT_LRS)} adds '
              f'{counters["stats"]["unique_graphs"] - before} Dynamo '
              'graph(s) (a canonical 0-d tensor adds none)', flush=True)
    del model, precond, opt, compiled, args
    torch._dynamo.reset()
    gc.collect()
    torch.cuda.empty_cache()
    return launches, worst, ms, eager_ms


def op_host_cost(torch, kt):
    """Host microseconds a call of the kernel through the custom op
    against the direct ``ctypes`` launch (the path before the op), on
    ``(1, 32, 32)`` operands, ``HOST_CALLS`` calls each, no sync between
    calls, interleaved op / direct / op / direct."""
    from kfac_pytorch_tpu_torch.ops import fused_precond

    args = make_case(torch, 1, 32, 32, seed=1100)
    fns = {'op': lambda: fused_precond.fused_eigen_precondition(*args),
           'direct': lambda: fused_precond._launch_kernel(*args)}
    got: dict = {k: [] for k in fns}
    for name in ('op', 'direct', 'op', 'direct'):
        fn = fns[name]
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        got[name].append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
    print(f'kernel host: {statistics.mean(got["op"]):.2f} us a call through '
          'kfac_torch::fused_eigen_precond against '
          f'{statistics.mean(got["direct"]):.2f} us for the direct ctypes '
          f'launch (L=1 gp=32 ap=32, {HOST_CALLS} calls, two rounds each: '
          f'{got})', flush=True)
    return got


def phase_analysis(torch, kt, rn32, rn50, drill=None):
    """Phase 33: the retrace guard and the sync guard on ResNet-50 (33a,
    33c), the compiled precondition tail on ResNet-32 with Inductor and
    on ResNet-50 with the eager backend (33b), then, once ``drill`` (phase
    32b's elastic drill, :func:`start_elastic_drill`, running beside
    33a-b) has ended, the op's host cost on a quiet host.  Returns the
    kernels-line entries."""
    import torch._dynamo

    if torch._dynamo.config.suppress_errors:
        fail('phase 33: torch._dynamo.config.suppress_errors is on')
    took = {}
    t0 = time.perf_counter()
    guard_launches = phase_guard(torch, kt)
    took['33a+c guard, syncs'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tail50 = phase_compiled_tail(torch, kt, 'resnet50', 'eager',
                                 ('plain', 'factor', 'inv'), float_sweep=True)
    took['33b resnet50 eager'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tail32 = phase_compiled_tail(torch, kt, 'resnet32', 'inductor',
                                 ('plain', 'factor'))
    took['33b resnet32 inductor'] = time.perf_counter() - t0
    if drill is not None:
        t0 = time.perf_counter()
        finish_elastic_drill(drill)
        took['32b elastic drill, its rest'] = time.perf_counter() - t0
    host = op_host_cost(torch, kt)
    print('phase 33: ' + ', '.join(f'{k} {v:.2f} s' for k, v in took.items()),
          flush=True)
    guarded = dict(
        rn50, name='fused_eigen_precondition through kfac_torch::'
        'fused_eigen_precond, ResNet-50 buckets, retrace-guarded steps over '
        'a damping sweep (phase 33a; ms, plain_ms, library_ms: phase 2\'s '
        'timing of the same shapes)', launches=guard_launches,
        op_host_us=statistics.mean(host['op']),
        direct_host_us=statistics.mean(host['direct']))
    compiled50 = dict(
        rn50, name='fused_eigen_precondition through kfac_torch::'
        'fused_eigen_precond, ResNet-50 buckets, precondition tail under '
        'torch.compile(fullgraph=True, backend=\'eager\') (phase 33b)',
        launches=tail50[0], max_abs_err=max(rn50['max_abs_err'], tail50[1]),
        tail_ms=tail50[2], eager_tail_ms=tail50[3])
    compiled32 = dict(
        rn32, name='fused_eigen_precondition through kfac_torch::'
        'fused_eigen_precond, ResNet-32 buckets, precondition tail under '
        'torch.compile(fullgraph=True) with Inductor (phase 33b)',
        launches=tail32[0], max_abs_err=max(rn32['max_abs_err'], tail32[1]),
        tail_ms=tail32[2], eager_tail_ms=tail32[3])
    return [guarded, compiled50, compiled32]


def device_record(torch) -> dict:
    """The last line: ``{"ok": true, "device": {...}}``."""
    return {'ok': True, 'device': {
        'platform': 'gpu',
        'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count(),
    }}


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail('torch is not installed')
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this smoke test needs '
             'a CUDA card')
    try:
        import kfac_pytorch_tpu_torch as kt
        from kfac_pytorch_tpu_torch.ops import _build
    except ImportError as exc:
        fail(f'the port is not importable (run from the repository root): '
             f'{exc}')
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]}', flush=True)

    kaisa_only = sys.argv[1:] == ['--kaisa-only']
    if sys.argv[1:] and not kaisa_only:
        fail(f'unknown arguments {sys.argv[1:]}; the only one is '
             '--kaisa-only')
    t0 = time.perf_counter()
    _build.build_all()
    print(f'build: {time.perf_counter() - t0:.2f} s for '
          f'{len(_build.build_log)} kernel source(s)', flush=True)
    # The host C++ (phase 31 a), before any rank needs it.
    from kfac_pytorch_tpu_torch import _native
    from kfac_pytorch_tpu_torch._native import data as native_data

    for lib in (_native.planner, native_data.library):
        if lib.load() is None:
            fail(f'build: {lib.source.name} did not build: {lib.error}')
        print(f'build: {lib.source.name}: {lib.seconds:.2f} s (g++) -> '
              f'{lib.path}', flush=True)
    for stem, rec in _build.build_log.items():
        usage = [ln.strip() for ln in rec['log'].splitlines()
                 if 'registers' in ln or 'spill' in ln]
        print(f'build: {stem}: {rec["seconds"]:.2f} s -> {rec["path"]}',
              flush=True)
        for ln in usage:
            print(f'  ptxas: {ln}', flush=True)

    took = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        took[name] = time.perf_counter() - t
        return out

    if kaisa_only:
        phase('5 kaisa', phase_kaisa, torch, kt)
        print(card, flush=True)
        print(json.dumps(device_record(torch)), flush=True)
        return 0
    entry, gpt, rn50, vit, bert, rn50_lr = phase(
        '1-2 kernels', phase_kernels, torch, kt.ops)
    entry['launches'] = phase('3 train', phase_train, torch, kt)
    sharded = phase('4 sharded', phase_sharded_kernel, torch, kt)
    # Early: the guard, the compiled tail and the sync guard read the
    # kernel entries of phases 1-2.  Phase 32b's elastic drill runs beside
    # it (its ranks mostly start and open the card; phase 33's gates are
    # bitwise, counts and syncs, not times).
    drill = start_elastic_drill()
    try:
        analysis = phase('33 guard, compiled tail, syncs; 32b elastic drill',
                         phase_analysis, torch, kt, entry, rn50, drill)
    finally:
        stop_elastic_drill(drill)
    # The rank work of phases 5, 17, 18, 21, 22, 23, 31 and 28 (with 26-27
    # at world 4 and 30b) in one spawn, started here (phase 28's
    # one-process references run first).  While its ranks run, the
    # one-card phases whose gates are bitwise, counts and cadences run
    # beside them, heaviest first, the card's cache emptied after each;
    # phases 22 and 23 come last and wait for their ranks after their own
    # run.  The timed phases (kernels 1-2 and the padding times of 26-27,
    # 9's stages and bench, 16's side stream, 24's on-off, 25's death
    # detection, 31a's host times, 32) run with the card to themselves.
    gc.collect()
    torch.cuda.empty_cache()
    ranks = phase('shared ranks start, 28 references', SharedSpawn, torch)

    def beside(name, fn, *args):
        out = phase(name, fn, *args)
        gc.collect()
        torch.cuda.empty_cache()
        return out

    try:
        squad = beside('30 squad_bert', phase_squad_bert, torch, kt)
        bert['launches'] = beside('11 bert', phase_bert, torch, kt)
        gpt['launches'] = beside('8 gpt', phase_gpt, torch, kt)
        beside('8 gpt remat', gpt_remat_pass, torch, kt)
        lm = beside('29 tiny_gpt_lm', phase_tiny_gpt_lm, torch, kt)
        vit['launches'] = beside('10 vit', phase_vit, torch, kt)
        rn50_lr['launches'] = beside('12 resnet50 lowrank',
                                     phase_resnet50_lowrank, torch, kt)
        ekfac_launches = beside('13 resnet50 ekfac', phase_resnet50_ekfac,
                                torch, kt)
        print(f'resnet50 ekfac: the fused kernel launched {ekfac_launches} '
              'times (EKFAC keeps no dgda)', flush=True)
        rn50_stagger = dict(
            rn50, name='fused_eigen_precondition, ResNet-50 buckets, '
            'staggered refresh (phase 14)',
            launches=beside('14 resnet50 stagger', phase_resnet50_stagger,
                            torch, kt),
        )
        rn50_adaptive = dict(
            rn50, name='fused_eigen_precondition, ResNet-50 buckets, '
            'drift-adaptive staggered refresh (phase 15)',
            launches=beside('15 resnet50 adaptive', phase_resnet50_adaptive,
                            torch, kt),
        )
        rn50_fused = dict(
            rn50, name='fused_eigen_precondition, ResNet-50 buckets, fused '
            'training path with AdaptiveDamping (phase 19)',
            launches=beside('19 resnet50 fused', phase_resnet50_fused, torch,
                            kt),
        )
        rn50_health = dict(
            rn50, name='fused_eigen_precondition, ResNet-50 buckets, health '
            'guardrails: a NaN batch, injected eigh failures, quarantined '
            'slots (phase 20)',
            launches=beside('20 resnet50 health', phase_resnet50_health,
                            torch, kt),
        )
        beside('6 methods', phase_methods, torch, kt)
        beside('7 resume', phase_resume, torch, kt)
        launches, err = beside('22 resnet50 elastic (then its ranks)',
                               phase_resnet50_elastic, torch, kt,
                               lambda: ranks.wait()[0]['22'])
        rn50_elastic = dict(
            rn50, name='fused_eigen_precondition and its sharded form, '
            'ResNet-50 buckets, streaming restore and world 4 -> 2 resize '
            '(phase 22)', launches=launches, max_abs_err=err,
        )
        rn50_watchdog = dict(
            rn50, name='fused_eigen_precondition, ResNet-50 buckets, '
            'trajectory watchdog: detection, rollback and replay (phase 23)',
            launches=beside('23 resnet50 watchdog', phase_resnet50_watchdog,
                            torch, kt, lambda: ranks.wait()[0]['23']),
        )
        shared, meanwhile = phase('shared ranks, the rest of the wait',
                                  ranks.wait)
    finally:
        ranks.stop()
    sharded['launches'], sharded['gather_ms'] = phase(
        '5 kaisa', phase_kaisa, torch, kt, shared['5'],
    )
    rn50['launches'] = phase('9 resnet50', phase_resnet50, torch, kt)
    rn50_overlap = dict(
        rn50, name='fused_eigen_precondition, ResNet-50 buckets, deferred '
        'refresh on a side stream (phase 16)',
        launches=phase('16 resnet50 overlap', phase_resnet50_overlap,
                       torch, kt),
    )
    rn50_pipelined = phase('17 resnet50 pipelined', phase_resnet50_pipelined,
                           torch, kt, shared['17'])
    phase('18 resnet50 ekfac grid', phase_resnet50_ekfac_grid, torch, kt,
          shared['18'])
    rn50_consistency = dict(
        rn50_pipelined, name='fused_eigen_precondition_sharded, ResNet-50 '
        'at world 4, the cross-replica consistency guard (phase 21)',
        launches=phase('21 resnet50 consistency', phase_resnet50_consistency,
                       torch, kt, shared['21']),
    )
    rn50_observe = dict(
        rn50, name='fused_eigen_precondition, ResNet-50 buckets, observed '
        '(monitor, profiler ranges, timeline) and flight-recorded (phase 24)',
        launches=phase('24 resnet50 observe', phase_resnet50_observe, torch,
                       kt),
    )
    launches, err = phase('25 runtime', phase_runtime, torch, kt)
    rt_kernel = shard_entry(
        torch, kt, 2, 'fused_eigen_precondition_sharded, ResNet-32 at world '
        '4 (HYBRID-OPT) under the runtime, a rank death and the world-2 '
        'restart (phase 25)', 900)
    rt_kernel.update(launches=launches, max_abs_err=err)
    kernel = kt.ops.fused_eigen_precondition
    plain = kt.ops.fused_eigen_precondition_reference
    moe = phase('26 moe', phase_moe, torch, kt)
    pipe = phase('27 pipeline', phase_pipeline, torch, kt)
    world = phase('28 seq/tp, 26-27 world 4', phase_seq_tp, torch, kt, moe,
                  pipe, shared['28'], meanwhile.get('28'))
    moe_kernel = bucket_entry(
        torch, kernel, plain, 'MoE expert and dense layers (phase 26)',
        [aligned(x) for x in MOE_CASES], 960,
        what='stacks, zero-padded to multiples of 8')
    moe_kernel.update(launches=moe['launches'], max_abs_err=max(
        moe['worst'], world['moe_worst'], moe_kernel['max_abs_err']))
    pipe_kernel = bucket_entry(
        torch, kernel, plain, 'GPipe stage layers of one rank of four '
        '(phase 27)', [aligned(x) for x in PIPE_LM_CASES], 970,
        counts=[3] * 4, what='stacks, zero-padded to multiples of 8')
    pipe_kernel.update(launches=world['pipe_launches'], max_abs_err=max(
        pipe['worst'], world['pipe_worst'], pipe_kernel['max_abs_err']))
    ring_kernel = bucket_entry(
        torch, kernel, plain, 'GPT-125M ring over a sequence group of 4, '
        'one rank\'s MEM-OPT column (phase 28)', world['ring_shapes'], 1000,
        what='bucket slices')
    ring_kernel.update(launches=world['ring_launches'], max_abs_err=max(
        world['worst'], ring_kernel['max_abs_err']))
    tp_kernel = bucket_entry(
        torch, kernel, plain, 'GPT-125M GPTKFACPreconditioner prediv on a '
        '2 x 2 (data, model) grid, one rank\'s MEM-OPT column (phase 28)',
        world['tp_shapes'], 1010, what='bucket slices')
    tp_kernel.update(launches=world['tp_launches'], max_abs_err=max(
        world['worst'], tp_kernel['max_abs_err']))
    moe_adaptive = dict(
        moe_kernel, name='fused_eigen_precondition, MoE expert and dense '
        'layers under AdaptiveDamping through make_train_step (phase 26, '
        'one card and world 4)', launches=moe['adaptive_launches'],
        max_abs_err=max(moe['adaptive_worst'], moe_kernel['max_abs_err']))
    pipe_adaptive = dict(
        pipe_kernel, name='fused_eigen_precondition, GPipe stage layers under '
        'AdaptiveDamping through make_train_step (phase 27, one process and '
        'world 4; timed at one rank\'s stacks)',
        launches=pipe['adaptive_launches'],
        max_abs_err=max(pipe['adaptive_worst'], pipe_kernel['max_abs_err']))
    bert_tp_kernel = bucket_entry(
        torch, kernel, plain, 'BERT-large widths (4 blocks) '
        'GPTKFACPreconditioner prediv on a 2 x 2 (data, model) grid, one '
        'rank\'s MEM-OPT column (phase 30b)', world['bert_shapes'], 1040,
        what='bucket slices')
    bert_tp_kernel.update(launches=world['bert_launches'], max_abs_err=max(
        world['worst'], bert_tp_kernel['max_abs_err']))
    lm_kernel = bucket_entry(
        torch, kernel, plain, 'tiny_gpt_lm example at GPT-125M widths, full '
        'coverage (phase 29)', lm['shapes'], 1020)
    lm_kernel.update(launches=lm['launches'], max_abs_err=max(
        lm['worst'], lm_kernel['max_abs_err']))
    squad_kernel = bucket_entry(
        torch, kernel, plain, 'squad_bert example, BERT-large '
        'GPTKFACPreconditioner prediv, one process (phase 30)',
        squad['shapes'], 1030)
    squad_kernel.update(launches=squad['launches'], max_abs_err=max(
        squad['worst'], squad_kernel['max_abs_err']))
    phase('31a native', phase_native, torch, kt)
    place_kernel = phase('31b resnet50 placement', phase_resnet50_placement,
                         torch, kt, shared['31'])
    launches, err = phase('32 profile', phase_profile_drill, torch, kt)
    # The variant mode calls the kernel on phase 9's 21 bucket shapes:
    # its times are phase 9's timing of them, in this run.
    rn50_profile = dict(
        rn50, name='fused_eigen_precondition, ResNet-50 buckets, '
        'profile_step variant mode: plain, factor and inv calls (phase 32; '
        'ms, plain_ms, library_ms: phase 9\'s timing of the same shapes)',
        launches=launches, max_abs_err=max(rn50['max_abs_err'], err),
    )
    phase('bench stages', phase_bench_stages, torch, kt)
    stop_profile_worker()
    print('phases: ' + ', '.join(f'{k} {v:.2f} s' for k, v in took.items())
          + f'; total since start {time.perf_counter() - t_start:.2f} s',
          flush=True)
    print(card, flush=True)
    print(json.dumps({'kernels': [entry, sharded, gpt, rn50, vit, bert,
                                  rn50_lr, rn50_stagger, rn50_adaptive,
                                  rn50_overlap, rn50_pipelined,
                                  rn50_fused, rn50_health,
                                  rn50_consistency, rn50_elastic,
                                  rn50_watchdog, rn50_observe, rt_kernel,
                                  moe_kernel, pipe_kernel, ring_kernel,
                                  tp_kernel, moe_adaptive, pipe_adaptive,
                                  bert_tp_kernel, lm_kernel,
                                  squad_kernel, place_kernel,
                                  rn50_profile, *analysis]}),
          flush=True)
    print(json.dumps(device_record(torch)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
