#!/usr/bin/env python3
"""Chip smoke for the PyTorch / CUDA port (perceiver_io_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits nonzero):

1. print the card (``nvidia-smi`` name and power limit); build the CUDA
   kernels from ``perceiver_io_torch/csrc`` with ``nvcc`` and print the
   build seconds;
2. the attention forward kernel against its plain version at the flagship
   serving shapes (encoder cross-attention with ~30% of keys padded and one
   fully masked row, latent self-attention, the gathered decoder), the
   training decoder at capacity 160 and a ragged (250, 509) cross, both
   padded, and at the D=16 ``flagship_mlm`` cross shape, in f32 (the scalar
   design) and bf16 (the wgmma design; each row logs its ``design``, and a
   bf16 call must advance the wgmma counter), with the host time of one
   call; then at every call phases 33 and 34 give the kernels
   (``CLASSIFIER_SHAPES``), without the library's device time and the host
   time; first, the host time of the C entry points alone, f32 against
   bf16 (whose design encodes TMA tensor maps at each launch: three for
   the forward, one for the dequant matmul);
3. the attention backward at the training shapes (the encoder cross with
   padding and a fully masked row, self-attention, the decoder gathered at
   capacity 160, the D=16 cross, a ragged (250, 509) cross whose rows are
   padded from a random length on), f32 (the scalar design) and bf16 (the
   wgmma design; each row logs its ``design``, a bf16 call must advance both
   backward wgmma counters, and the share of key tiles the design skips):
   the forward's statistics (m, l) and the dq and dk/dv kernels against
   their plain versions, dq and dk of the fully masked example exactly
   zero; CUDA-event and profiler device times of each kernel and of SDPA's
   backward; then at ``CLASSIFIER_SHAPES``, without SDPA's device time;
4. the dequant-matmul kernel against its plain version (int8 per-channel,
   int4 group 128; bf16 and f32) at the self-attention projection
   (M=16384, K=N=512) and the vocab head (M=512, K=512, N=10003), and at
   the vocab head with M=1 (one request) and M=413 (the serving pass's
   masks);
5. the three fused CE kernels (forward, dx, dW/db) against their plain
   versions at bench.py's head (R, C, V) = (10240, 64, 10003), the flagship
   head (10240, 512, 10003) and a ragged (10239, 64, 10003), f32 (the
   scalar designs) and bf16 (the wgmma designs; a call must advance the
   three CE wgmma counters), ~15% of rows ignored at random (cotangent 0, their
   dx exactly 0); later, once the data module exists, ``gathered``: bench's
   head in the training path's layout (each example's live rows first among
   its 160, as many as the first training batch's masking gives, g 0 on the
   rest), where the bf16 backward skips the 64-row tiles whose g are all 0
   (the share is logged); CUDA-event and profiler device times of each
   kernel, of the plain forward and backward and of the unfused head
   (cuBLAS product + ``softmax_ce_integer``, two library calls; its
   backward by ``autograd.grad`` over a retained graph), and the device
   and host time of making round(W)^T and the host time of one forward call
   (``fwd_host_us``: bf16 encodes two TMA maps); each kernel's bound is the largest
   of bytes / 3.35 TB/s, its products (2.R.C.V in the forward, twice that
   in each backward kernel, at the rows whose g is not 0) / the dtype's
   peak, and its exponentials (R.V, the backward's at those rows) / (16 a
   clock per SM x 132 SMs x the SM clock nvidia-smi reports as its
   maximum, printed);
6. the serving path: ``MLMServer`` at ``flagship_tpu_mlm`` width (seeded random
   weights, a tokenizer trained on the synthetic corpus, width buckets
   128/256/512, max_batch 64) fills ~200 ``[MASK]`` texts, then encodes them
   and fills from the cached latents, under bf16, int8w and int4w; the
   kernels' launch counters must advance by 22 attention and 131 dequant
   launches per quantized fused forward, every one of them through the bf16
   wgmma designs, and the plain versions must never run; then the bf16 pass
   again with the plain versions in the kernels' place on the same weights:
   its top-1 fills must agree with the kernels' on at least 95% of the
   masks (bf16 logits tie, so agreement, not identity);
7. the same serving pass at f32 with the plain versions put in the kernels'
   place must give the same top-1 fill on every mask;
8. the training path: ``Trainer.fit`` takes 30 Adam steps (lr 1e-3) of
   ``flagship_tpu_mlm`` in bf16 over f32 weights, batch 64 of the synthetic
   ``IMDBDataModule`` at 512 tokens, masked positions gathered at capacity
   160; every step must launch exactly 22 forward, 22 dq and 22 dk/dv
   attention kernels (all through the wgmma designs) and no plain version, give
   a finite loss, and the mean
   loss of the last 5 steps must be below the first step's. Then
   ``Trainer.fit`` runs on as the CLI drives it, with no per-step check: 10
   steps give the train tokens/s (all tokens over the window's host time,
   the loader's collation included), and a profile of 3 more gives the
   device idle share;
9. three f32 train steps at flagship width with the kernels, then with the
   plain versions in their place, for each of three masking seeds: the
   losses agree within 1e-4 relative at every step and the first step's
   gradients within 1e-3 of each leaf's peak; then three bf16 steps, kernels
   against plain versions, at masking seed 2: losses within 2e-2 relative;
10. the C=64 path (bench.py's and the CLI's default configuration):
    ``flagship_mlm`` (256 latents, C=64, 4 heads of depth 16, 3 x (cross +
    6 self), vocab 10003, 512 tokens) trained as in phase 8 with
    ``make_mlm_steps(fused_head='pallas')``: every step launches exactly 22
    attention forward, 22 dq, 22 dk/dv and one CE forward, dx and dW kernel,
    all three through the wgmma design (each eval batch 22 attention
    forward and one CE forward), and the loss falls; the share of the CE
    backward's 64-row tiles whose g are all 0 (skipped), per checked step;
    the 10-step window and the 3-step profile; then the unfused head
    on the same model and state (windows in turns: unfused, unfused,
    fused), and both heads timed on bench.py's own batch (ids from
    ``default_rng(0)``, no padding), fused / unfused / unfused / fused;
11. ``perceiver_io_torch.cli.train_mlm --preset reference --synthetic``, 5
    steps in-process with ``--eval_every_n_steps 2``: ``--fused_head auto``
    must resolve to the CE kernels on the card (their counters advance, the
    forward, dx and dW ones all through the wgmma design, no plain version runs),
    the vocab head must have the tokenizer's size, and
    validation must run at steps 2, 4 and 5 (the JAX trainer's cadence);
12. phase 9 on the C=64 path, the plain attention and CE versions in the
    kernels' place, plus the unfused head with the kernels: its losses within
    1e-4 relative of the fused head's;
13. the packed-heads kernels (forward, dq, dk/dv) against their plain
    versions at B=64: the C=64 encoder cross (T, S, E, H) = (256, 512, 64, 4)
    with ~30% of keys padded and one fully masked example (its dq and dk
    exactly 0), the same with each example's keys valid up to a random
    length (``enc_cross_tail``, as the encoder's token rows), self (256,
    256, 64, 4), the gathered decoder (160, 256, 64, 4), the flagship
    encoder cross (256, 512, 512, 4) and a ragged (250, 509, 64, 4), f32
    (the scalar design) and bf16 (the wgmma design; a bf16 call must
    advance the three packed wgmma counters, and the row logs the share of
    key tiles the design skips); CUDA-event and profiler device times of
    each kernel, times of the plain forward and
    backward, of SDPA's forward and backward on the head-split views (one
    library call for the same function; it rounds at other points; events
    and device times) and of
    kernel #1's forward and backward at the same shape; each kernel's bound
    is the largest of bytes / 3.35 TB/s, its products (4.B.H.T.S.d forward,
    10.B.H.T.S.d the backward, 6 and 8 of them the dq and dk/dv kernels) /
    the dtype's peak, and the B.H.T.S exponentials / (16 a clock per SM x
    132 SMs x the maximum SM clock);
14. the C=64 path with ``attn_impl='packed'``: phase 10 with every step
    launching exactly 22 packed forward, 22 packed dq, 22 packed dk/dv (all
    through the wgmma designs) and
    one CE forward, dx and dW kernel and none of the fused attention kernels
    (each eval batch 22 packed forwards and one CE forward), the loss
    falling; the window and the profile; then ``attn_impl='pallas'`` on the
    same model and state, windows and bench.py's batch in turns (packed /
    pallas / pallas / packed);
15. phase 9 on the packed path, the plain packed attention and CE versions
    in the kernels' place, plus the pallas kernels: their losses within 1e-4
    relative of the packed kernels';
16. the entry points on the packed path: ``train_mlm --preset reference
    --synthetic --attn_impl packed``, 5 steps in-process (the packed counters
    advance, every launch through the wgmma designs, kernels #1-#3 never
    launch); ``MLMServer`` over
    ``flagship_mlm(attn_impl='packed')`` fills the texts of phase 6 in bf16
    with 22 packed forwards per fused forward, all through the wgmma design,
    and in f32 its top-1 fill of
    every mask equals that of the same weights under ``'pallas'``;
17. kernel #1 with the causal offset (the Perceiver-AR path's forward)
    against its plain version at the AR shapes, B=4, H=4, D=128: the
    latent self-attention (256, 256, offset 0; also the W=256 prefill cross
    and the output decode), the prefill cross at W=511 (offset 255, S not a
    multiple of the 128-key tile) and W=512 (offset 256), and the decode
    step (T=1 against 512 and 256 keys, pad mask only); keys padded from 300
    on, plus rows whose visible keys are all padding; f32 and bf16, each
    call one causal and (bf16) one wgmma launch; CUDA-event and profiler
    times of the kernel, of the plain version and of SDPA with the same
    boolean mask, and the bound;
18. Perceiver-AR generation: ``ARGenerator`` over ``flagship_ar`` (vocab
    10003, 512 tokens, 256 latents, C=512, 4 heads of depth 128, 3 x
    (causal cross + 6 causal self), bf16, weights from seed 0) continues
    four prompts of 250, 120, 37 and 9 tokens (cut from synthetic reviews)
    by 32 greedy tokens each in chunks of 8; the 250-token stream crosses
    the episode boundary and re-prefills at width 511. The counters, set to
    0 just before, must read 22 causal #1 launches a prefill and 22 #1
    launches a decode step, all wgmma. Then: the prefill's ms at each width,
    the decode's host ms a token, a profiled 32-step window (device busy ms
    a token, idle share); teacher forcing on the same streams through the
    plain versions: every step's logits within 2e-2 of the plain ones' peak,
    top-1 agreement at least 0.95; ``flagship_ar`` in f32 with the kernels:
    4 incremental steps against the dense forward of the same prefix within
    1e-4 absolute; and the entry point ``cli.serve --task generate --preset
    flagship_ar`` on two texts;
19. phase 18's generation with int8 weights (``int8w``): 131 #9 launches a
    prefill and a step, every one wgmma, besides #1's; top-1 agreement with
    the int8 plain versions under teacher forcing at least 0.95; the same
    times;
20. the two backward kernels (#2 dq, #3 dk/dv) with the causal offset (the
    Perceiver-AR training path's backward) through ``FusedAttention`` under
    autograd, against the plain backward with the same offset on the
    kernel forward's residuals, at B=64, H=4, D=128: the AR training cross
    (T=256, S=512, offset 256), the latent self-attention and output decode
    (256, 256, 0) and a ragged cross (256, 511, 255); each example's keys
    padded from a random length on, the first four examples' first keys
    padded so that their first rows see only padding, the last example all
    padding; f32 (the scalar designs) and bf16 (the wgmma designs): the
    statistics, dq, dk and dv within the tolerances below, dq of every row
    whose visible keys are all padding and dk of every padded key exactly
    0, each call one causal launch a kernel and in bf16 one wgmma launch a
    kernel; CUDA-event and profiler device times of each kernel, of the
    plain backward and of SDPA's backward with the same additive mask (pad
    and causal biases); the bound counts the (row, key) pairs the data needs;
21. Perceiver-AR training: ``Trainer.fit`` takes 30 Adam steps (lr 1e-3) of
    ``flagship_ar`` (vocab 10003, 512 tokens, 256 latents, C=512, 4 heads of
    depth 128, 3 x (causal cross + 6 causal self), bf16 over f32 weights,
    seed 0) through ``make_ar_steps``, batch 64 x 512 tokens: the synthetic
    ``IMDBDataModule``'s (seed 0) training reviews, tokenized by its
    tokenizer and packed end to end into rows (its collated rows are
    shorter than the 256-token offset of the latent window, so every target
    would be padding), every fourth row padded from a random length past
    the window's start and each batch's last row from 200 on (its window
    all padding); validation once, at the end, on its validation reviews
    packed the same way. The counters, set to 0 just before the checked
    fit, must read per step 22 causal #1 launches with statistics, 22 causal
    dq and 22 causal dk/dv, all wgmma (3 cross, 18 self, 1 output decode),
    and no other kernel; the loss finite and the mean of the last 5 below the
    first step's. Then the 10-step window (tokens/s) and the profiled 3-step
    window (device busy ms, idle share), as phase 8;
22. three f32 ``flagship_ar`` train steps with the kernels, then with the
    plain versions in their place, from the same weights and batches:
    losses within 1e-4 relative at every step, the first step's gradients
    within 1e-3 of each leaf's peak; then three bf16 steps: losses within
    2e-2 relative;
23. ``perceiver_io_torch.cli.train_ar --preset flagship_tpu --synthetic
    --max_steps 5 --attn_impl pallas`` in-process: ``metrics.jsonl`` rows
    with finite losses, every #1-#3 launch causal and wgmma, the vocab head
    at the tokenizer's size;
24. the einsum attention (``attn_impl='xla'``, ``ops.attention.
    dot_product_attention``) against kernels #1-#3 in f32 (TF32 off, which
    the phase asserts): output, dq, dk, dv within 1e-4 of each peak at the
    flagship encoder cross (~30% of keys padded) and the AR training cross
    (offset 256), every row with a live key; then the H100 sweep that sets
    ``auto_attention_impl``'s constants: bf16 device ms (torch.profiler,
    every kernel of the call) of the einsum path and of #1-#3, forward and
    forward + backward (forward only for a decode step), at
    ``tools/attn_shapes_bench.py``'s shapes and decode family, the port's
    training shapes, the rule's floors and the deep heads (the flow crosses
    at batch 1, 2 and 8, a D=256 cross and self: SWEEP_SHAPES); a head depth
    the kernel refuses is marked refused and must not route to it; the
    table and the thresholds in force are printed;
25. ``train_mlm --preset flagship_tpu --synthetic`` with the JAX CLI's
    defaults (``xla`` by the preset) and ``--dropout 0.1 --optimizer AdamW
    --accumulate_steps 2 --one_cycle_lr --one_cycle_pct_start 0.3``, 12
    steps at batch 64 x 512: the JAX trainer's rows, the loss falling, no
    #1-#3 launch (22 einsum calls a step and an eval batch), the peak
    memory; then three fresh CLI runs, one an arm (A B C): A these
    flags, B ``--attn_impl pallas --dropout 0``, C ``--dropout 0``, each
    with its tokens/s over a 10-step window, device ms a step and idle
    share over a profiled 4-step one;
26. ``train_mlm --preset reference --synthetic`` with its defaults
    (``auto``, ``--fused_head auto``), 5 steps with validation every 2,
    with ``--remat --optimizer RAdam`` and then ``--attn_impl pallas
    --dropout 0.1``: every train step and eval batch checked for its
    launches (#6-#8 one each a step; #1-#3 as the rule routes the preset's
    shapes, 22 at batch 64, #1 21 more under remat for the encoder's
    recompute; under dropout no #1-#3 in training and 22 #1 an eval batch);
    then each of the eight ``--optimizer`` names for 2 steps (SGD with
    ``--momentum 0.9``, Adamax with ``--no_reuse_kv``, Adagrad with
    ``--accumulate_steps 2``), checked alike;
27. ``train_ar --preset flagship_tpu --synthetic --dropout 0.1`` with the
    JAX CLI's default ``auto`` (every causal call on the einsum path), its
    trainer fitted on phase 21's packed reviews for 12 steps: the loss
    falling, no #1-#3 launch, 22 einsum calls a step and an eval batch;
    the windows' tokens/s, device ms a step and idle share;
28. three f32 ``flagship_tpu_mlm`` steps through ``'xla'`` and through
    ``'pallas'``, no dropout: losses within 1e-4 relative; then dropout 0.1
    with ``remat`` and without, the same keys: losses and the first step's
    gradients within 1e-5 of each leaf's peak (remat recomputes the
    encoder's 21 calls: 43 einsum calls a step); last, the stacked q/k/v
    product against three projections on one bf16 ``flagship_tpu_mlm``
    model, device ms a step in turns (stacked, three, three, stacked);
29. preemption and resume: ``train_mlm --preset flagship_tpu --attn_impl
    pallas --synthetic`` (bf16), 24 steps, validation every 8, rows every 4,
    two checkpoints kept, in-process (run A); the same command in a
    subprocess (run B) gets SIGTERM once its step-8 row exists and must exit
    0 with a ``last/`` checkpoint; ``--resume`` takes B to step 24. Every
    train row of B equals A's at its step, bit for bit (or within 1e-5
    relative, the ops PyTorch calls nondeterministic named); every step of A
    and of the resumed B launches 22/22/22 #1-#3, all wgmma; A's best
    checkpoint holds its lowest ``val_loss`` and its params hash to the
    recorded digest and equal A's weights at that validation; a
    ``prefer_latest`` restore takes the newest step, and with that step
    truncated falls back to the other with a warning; the checkpoint's bytes
    and the seconds of a save (synchronous; async: the call's return and the
    write) and of a restore;
30. serving from that checkpoint: ``cli.serve --checkpoint --tokenizer
    --dtype bfloat16`` (buckets 128/256/512) on phase 6's texts, then with
    ``--quantize int8``: 22 #1 launches a fused forward, 131 #9 under int8,
    all wgmma; every top-1 fill equals that of an ``MLMServer`` built in
    memory from A's weights at the best step, in the same mode;
31. ``train_ar --preset flagship_tpu --synthetic --attn_impl pallas
    --bucket_widths 128 256 512 --sample_prefix_len 16 --sample_new_tokens
    12 --max_steps 16 --eval_every_n_steps 8``: 22 causal #1, dq and dk/dv
    launches a step at every width (the batches and launches of each width
    printed), every ``train_loss`` above 0, ``continuation`` rows at steps 8
    and 16 whose hook launched the causal #1, and ``cli.serve --task
    generate --checkpoint`` (the best step) continuing the hook's prefix
    with the hook's tokens; the corpus's reviews all fit 128 tokens, so the
    same run again with ``--bucket_widths 64 128 512`` must batch at two
    widths or more, with the same checks of each step and row;
32. recovery at ``train_mlm --preset reference`` (#1-#3 under ``auto``,
    #6-#8): with ``--skip_nonfinite_steps --rollback_after_bad_steps 2`` a
    gradient hook writes NaN on two train-step calls in a row: the first
    leaves the params and the optimizer's moments as they were, the second
    rolls back to the step-2 checkpoint, ``events`` rows say so and every
    later loss is finite; with ``--dispatch_error_retries 1`` one injected
    ``ConnectionResetError`` gives a clean run's losses;
33. MNIST image classification: ``train_img_clf --synthetic`` at the
    reference width (bf16, batch 128, 32 latents × 128 channels, 4 heads of
    depth 32, 3 × (cross over 784 pixels of 131 channels + 3 self), ``auto``),
    30 steps with validation every 15, in-process: every train step and eval
    batch launches what the ``auto`` rule routes (12 #1, dq and dk/dv a step,
    all wgmma: every encoder call; the one-query decoder on the einsum path),
    the loss falls, the last ``val_acc`` is above chance (0.1); then the
    images/s window and the profiled window (device ms a step, idle share);
    three f32 steps with the kernels and with the plain versions in their
    place (phase 9's bars);
34. sequence classification and transfer over phase 29's root (its
    tokenizer) and checkpoint (``flagship_tpu_mlm``, the classifier built at
    its width from its hparams), batch 128, each step and eval batch checked
    against the rule's routes: (a) ``--mlm_checkpoint --freeze_encoder``
    (dropout 0.1): 21 #1 a step and no #2/#3, the encoder bit-equal to the
    checkpoint's best step after the fit; (b) ``--mlm_checkpoint --dropout
    0``: #1-#3 at every call, the one-query decoder included (B·H·S =
    131072); (c) ``--clf_checkpoint`` of (b)'s run, 4 more steps from its
    best step; (d) the CLI's defaults from scratch: training on the einsum
    path, validation on #1.
35. #1-#3 at head depths 256 and 512 (the deep designs,
    ``csrc/attention_deep.cu``) against their plain versions, f32 and bf16,
    at ``DEEP_SHAPES`` (the flow crosses (B, 2048, 182528, 1, 512) and
    (B, 182528, 2048, 1, 512), a D=256 cross and a D=256 self): at B=2
    with ~30% of keys padded and the second example fully masked (dq and dk
    exactly 0 there), and at B=1 with the causal offset 8 and the first 12
    keys padded (rows 0-3 see only padding: their dq exactly 0); out, m, l,
    dq, dk, dv; each call one launch on the deep counters; every bf16
    forward and backward run twice, out, m, l and dq, dk, dv bit for bit
    the same. Times at the
    comparison batch (the kernels' by CUDA events, the plain versions', SDPA's or,
    where SDPA does not take the shape, the einsum path's, labelled, and
    the einsum path's beside it) and, in bf16 without padding, at B=8, each
    beside its bound; then the bf16
    backward with one key at every head dim (``one_key_sweep``: where ds is
    0 in exact arithmetic, how far the kernels' and the plain versions' dq
    and dk lie from 0, and how much of it is the sum g.v);
36. optical flow at the Perceiver IO paper's width: ``train_flow
    --synthetic --synthetic_size 48 --learning_rate 1e-4`` with the CLI's
    defaults (368 × 496 × 3 frame pairs, 2048 × 512 latents, one cross head
    of depth 512 and 24 self layers of 8 heads, batch 8, bf16, ``auto``),
    P36_STEPS steps in-process: every step launches 26 #1 (with statistics), 26 #2 and 26
    #3, all wgmma, 2 + 2 + 2 of them the D=512 design, and no plain
    version; the eval batch 26 #1; losses finite, the end-point error
    falling; then the frame-pairs/s window, the profiled window (device ms
    a step, idle share) and ``torch.cuda.max_memory_allocated``; three f32
    steps at batch 1 (``'pallas'``: every call on the kernels) against the
    plain versions in float64 in their place, phase 9's bars; one bf16
    batch-1 step on each route, ``'auto'``, ``'pallas'`` and ``'xla'``: device ms and peak
    memory; one bf16 step at batches 2, 4 and 8 on the einsum path: its
    peak memory, or that it does not fit; six bf16 steps at batch 2 at the
    CLI's Adam 1e-3 from one set of weights, on the kernels and on the
    einsum path (``lr_witness``);
37. multimodal audio-video autoencoding at the Perceiver IO paper's
    Kinetics width: first #1-#3 at each call of its step (``MM_CALLS``: the
    encoder cross (B, 784, 52096, 1, 512), whose last 128-row block has 16
    live rows, the decoder cross (B, 52097, 784, 1, 512), one live row in
    its last block and 13 key tiles, the last of 16 keys, on the D=512
    designs; the self layer (B, 784, 784, 8, 64)) against their plain
    versions at batch 2, f32 and bf16, no pad mask, one launch a kernel a
    call, every bf16 forward and backward twice and bit for bit the same;
    bf16 at batch 8 timed beside the bounds and the library; then
    ``train_multimodal --synthetic_size 48 --attn_impl pallas --learning_rate
    1e-4`` with the CLI's other defaults (16 × 224 × 224 × 3 video, 30,720
    audio samples, 784 × 512 latents, one cross head of depth 512, 8 self
    layers of 8 heads, 52,097 decoder queries, batch 8, bf16), P37_STEPS
    steps in-process: every step launches 10 #1 (with statistics), 10 #2
    and 10 #3, all wgmma, 2 + 2 + 2 of them the D=512 design, and no plain
    version; the eval batch 10 #1, 2 deep; every metric in the rows, the
    loss falling; then the batch-8 step on each route in turn (``xla``,
    ``auto``, ``pallas``), each step's launches checked against the route
    (``auto`` 8 + 8 + 8, none deep, by ``auto_attention_impl``): clips/s
    over a 10-step window, device ms a step and idle share of a profiled
    window, peak memory; three f32 steps at batch 1 on the kernels against
    the plain versions in float64 in their place (phase 36's bars); the f32
    loss with ``--video_patch_loss`` against the pixel-space loss on the same weights
    and clip (1e-6 relative, gradients 1e-5 of each leaf's peak); five bf16
    steps at the CLI's Adam 1e-3 from one set of weights on the kernels and
    on the einsum path (the witness: the checked fit takes 1e-4, as phase
    36's does);
38. #1-#3 at head depth 1024 (ImageNet's one-head crosses, ``IN_SHAPES``:
    the encoder cross (B, 512, 50176, 1, 1024) and the decoder cross (B, 1,
    512, 1, 1024)) through phase 35's ``deep_attention_phase``: f32 (the
    scalar design, its sums in float64 and compensated) and bf16 (the wgmma
    design over a four-block cluster) at B=2 with ~30% of keys padded and
    the second example fully masked, and at B=1 with the causal offset 8,
    against the plain versions at phase 35's bars; bf16 at B=8 timed beside
    the bounds, SDPA and the einsum path (CUDA events); then
    ``quarters_check``: bf16 at the encoder cross with k, v and g one
    quarter repeated four times, out's, dq's and dv's four column quarters
    bit for bit equal (the cluster's fixed summation order);
39. ImageNet classification at the Perceiver paper's width:
    ``train_imagenet --synthetic --attn_impl pallas --learning_rate 1e-4``
    with the CLI's other defaults (224 × 224 × 3 images, 64 bands, 512 ×
    1024 latents, 6 encoder layers (2..6 one weight set reusing one K/V
    projection) × (a cross of one head of depth 1024 + 6 self layers of 8
    heads of depth 128), a one-query decoder of depth 1024, batch 64, bf16,
    remat), P39_STEPS steps in-process: every step launches 85 #1 (with
    statistics; 42 of them remat's recompute), 43 #2 and 43 #3, all wgmma,
    13 + 7 + 7 of them the D=1024 design, and no plain version; the eval
    batch 43 #1, 7 deep; the loss falls; then the batch-64 step on each
    route in turn (``pallas``, ``auto``, ``xla``), each step's launches
    checked against the route (``auto`` 72/36/36, none deep; a route that
    does not fit the card fails the phase): images/s
    over a 10-step window, device ms a step and idle share of a profiled
    window, peak memory; three f32 steps at batch 1 on the kernels against
    the plain versions in float64 (phase 36's bars: the one-query decoder
    over near-equal latents amplifies f32 rounding, so an f32 plain version
    is no reference there); five bf16 steps at the CLI's AdamW 4e-3 at batch 16 from one
    set of weights on the kernels and on the einsum path (the witness).

Phases 23 and 27 run ``train_ar`` with ``--sample_prefix_len 0`` (their
checks count the training path's launches; phase 31 drives the hook);
phase 25 counts the MLM predict hook's forward at each validation. The
timed windows of phases 8, 10, 14, 21 and 25-27 run on a trainer with no
TensorBoard writer and no end-of-fit checkpoint, closed after its window
(``window_trainer``), and phases 8, 10 and 25-27 train without TensorBoard.

Each path's launch counters are set to 0 just before its checked
``Trainer.fit`` (or its serving pass, or its generation) and read just
after; the ``kernels`` line sums them with the serving path's, and the
script fails if any kernel was never launched. Its ``attention_fwd_causal``
entry is #1's causal reading (phase 17's bf16 W=512 cross), with the causal
launches of phases 18, 19 and 21; ``attention_bwd_dq_causal`` and
``attention_bwd_dkv_causal`` are phase 20's bf16 AR training cross, with
phase 21's launches. Phase 26's launches count with the paths'. A failure
prints one line on stdout naming the phase (``chip_smoke: failed in phase
...``) before the nonzero exit; a machine without a CUDA card, or a
directory without the package, fails so too. The ``done`` row gives each
phase's wall seconds (``phase_s``) and each kernel row of phases 2 and 3
its own (``row_s``).

The script re-executes itself with ``PYTHONHASHSEED=0``: the WordPiece
trainer's merge order follows string hashing, so the pin makes every run
train the same vocabulary and see the same data.

f32 comparisons run with TF32 off. Tolerances against the plain versions:
f32 within 1e-4 of the reference's peak magnitude, bf16 within 2e-2 (the CE
loss within 1e-4 in both: its bf16 design keeps the plain version's
rounding points); the statistics m, l and the CE lse within 1e-5 of
max(|ref|, 1) (f32 on both sides). Times
are CUDA-event means over repeated launches after a warm-up (phases 2, 3,
4, 5 and 13 also give each kernel's and the library call's device time from
torch.profiler, ``device_ms``, which the kernels line reports for every
kernel: a short kernel's event time is the host's enqueue); ``bound_ms`` is
the larger of bytes / 3.35 TB/s and operations / the H100 peak for the
inputs' type (989 TF/s bf16, 67 TF/s f32 without tensor cores), for the CE
kernels with the exponential term of phase 5 beside them. The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
ATTN_PER_FORWARD = 22       # 3 encoder cross + 18 self + 1 decoder cross
DEQUANT_PER_FORWARD = 131   # 124 encoder (layer_n reuses its k/v) + 6 decoder + head
ATTN_PER_ENCODE, DEQUANT_PER_ENCODE = 21, 124
ATTN_PER_DECODE, DEQUANT_PER_DECODE = 1, 7
TRAIN_STEPS, TRAIN_BATCH, SEQ_LEN, CAPACITY = 30, 64, 512, 160
WINDOW_STEPS, PROFILE_STEPS = 10, 3
PARITY_SEEDS = (2, 3, 4)
STAT_TOL = 1e-5
KERNEL_NAMES = ("attention_fwd", "attention_bwd_dq", "attention_bwd_dkv",
                "linear_ce_fwd", "linear_ce_bwd_dx", "linear_ce_bwd_dw",
                "packed_attention_fwd", "packed_attention_bwd_dq", "packed_attention_bwd_dkv",
                "attention_fwd_wgmma", "attention_bwd_dq_wgmma", "attention_bwd_dkv_wgmma",
                "packed_attention_fwd_wgmma", "packed_attention_bwd_dq_wgmma",
                "packed_attention_bwd_dkv_wgmma", "linear_ce_bwd_dx_wgmma",
                "linear_ce_bwd_dw_wgmma", "linear_ce_fwd_wgmma",
                "attention_bwd_dq_causal", "attention_bwd_dkv_causal")
BF16_TOP1_AGREEMENT, BF16_LOSS_REL = 0.95, 2e-2
# (rows, channels, vocab): bench.py's head (batch 64 x capacity 160, C=64),
# the flagship head (C=512), a ragged row count
CE_SHAPES = (("bench_head", (10240, 64, 10003)), ("flagship_head", (10240, 512, 10003)),
             ("ragged", (10239, 64, 10003)))
EXP_PER_CLOCK_PER_SM, SMS = 16, 132
BENCH_STEPS, CLI_STEPS = 10, 5
# name, (B, T, S, H, D), padding (None, "random" ~30% of keys or "tail"
# from a random length on): the packed path's attention shapes
PACKED_SHAPES = (("enc_cross", (64, 256, 512, 4, 16), "random"),
                 ("enc_cross_tail", (64, 256, 512, 4, 16), "tail"),
                 ("self", (64, 256, 256, 4, 16), None),
                 ("dec_cross", (64, CAPACITY, 256, 4, 16), None),
                 ("flagship_enc_cross", (64, 256, 512, 4, 128), "random"),
                 ("ragged", (64, 250, 509, 4, 16), "random"))
# the Perceiver-AR serving path (flagship_ar): 22 attention calls a prefill
# (3 causal cross + 18 causal self + 1 causal decode) and 22 a decode step
# (over the rings' pad masks); 131 dequant matmuls each on the int8 path
AR_ATTN_PER_CALL, AR_DEQUANT_PER_CALL = 22, 131
AR_PROMPT_LENS, AR_NEW_TOKENS, AR_CHUNK = (250, 120, 37, 9), 32, 8
AR_F32_STEPS, AR_F32_TOL = 4, 1e-4
# name, (B, T, S, H, D), causal offset (None: a decode step, pad mask only):
# kernel #1's calls on the AR path (ar_self is also the W=256 prefill cross
# and the output decode)
AR_ATTN_SHAPES = (("ar_self", (4, 256, 256, 4, 128), 0),
                  ("ar_cross_511", (4, 256, 511, 4, 128), 255),
                  ("ar_cross_512", (4, 256, 512, 4, 128), 256),
                  ("ar_step_512", (4, 1, 512, 4, 128), None),
                  ("ar_step_256", (4, 1, 256, 4, 128), None))
# name, (B, T, S, H, D), causal offset: #2/#3's calls on the AR training path
# (ar_self is also the output decode)
AR_BWD_SHAPES = (("ar_cross", (64, 256, 512, 4, 128), 256),
                 ("ar_self", (64, 256, 256, 4, 128), 0),
                 ("ar_cross_511", (64, 256, 511, 4, 128), 255))
AR_LEFT_PADDED = 4  # examples whose first rows see only padding (phase 20)
phase_name = "start"  # the phase running now, named in a failure's stdout line
phase_seconds = {}  # each phase's wall seconds, from its enter() to the next
phase_start = time.perf_counter()


def enter(name: str) -> None:
    global phase_name, phase_start
    now = time.perf_counter()
    phase_seconds[phase_name] = phase_seconds.get(phase_name, 0.0) + now - phase_start
    phase_name, phase_start = name, now


def log(**fields) -> None:
    print(json.dumps(fields), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float, dtype: str):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check(name: str, got, ref, dtype: str) -> float:
    import torch

    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((got.float() - ref.float()).abs().max())
    peak = float(ref.float().abs().max())
    if err > TOL[dtype] * peak:
        raise AssertionError(f"{name}: max|err| {err} > {TOL[dtype]} * {peak}")
    return err


def host_us(torch, fn, calls: int = 30) -> float:
    """Host microseconds of one call of ``fn`` (its enqueue: argument checks,
    tensor maps, the launch), the median of ``calls`` calls each timed
    alone; the device is drained before and after."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return sorted(times)[calls // 2]


def device_ms(torch, fn, match: str = "", iters: int = 20, tries: int = 3):
    """Device time of one call of ``fn``: the kernels whose name contains
    ``match`` (every kernel of the call when empty), summed by torch.profiler
    over ``iters`` calls after a warm-up. Unlike CUDA events around the
    calls, it does not count the device waiting on the host's enqueue. The
    profiler on the card's machine now and then returns no kernel events, or
    only some of them (a kernel counted fewer times than the calls launched
    it, whose sum then reads below the kernel's bound): such a window is
    profiled again, up to ``tries`` times, then the reading is None (not
    measured)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and match in e.key
                   and not getattr(e, "is_user_annotation", False)]
        us = sum(e.self_device_time_total for e in kernels)
        if us and all(e.count % iters == 0 for e in kernels):
            return us / 1e3 / iters
    return None


def entry_host_us(torch, build, calls: int = 200) -> None:
    """Host microseconds of one call of the C entry points alone (no Python
    wrapper), median of ``calls``, f32 against bf16 on the same shapes: the
    difference is what the bf16 design's TMA tensor maps cost to encode
    (three for #1, one for #9; the f32 design encodes none)."""
    lib = build.library()
    stream = torch.cuda.current_stream().cuda_stream
    b, t, s, h, d = 64, 8, 256, 4, 128  # the serving decoder: a short kernel
    m, k, n = 1, 512, 10003             # one request's vocab head
    readings = {}
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        q = torch.randn(b, t, h, d, device="cuda").to(dtype)
        kv = torch.randn(b, s, h, d, device="cuda").to(dtype)
        bias = torch.zeros(b, s, device="cuda")
        out = torch.empty_like(q)
        x = torch.randn(m, k, device="cuda").to(dtype)
        w = torch.zeros(k, n, dtype=torch.int8, device="cuda")
        scale = torch.ones(n, device="cuda")
        y = torch.empty(m, n, device="cuda", dtype=dtype)
        strides = [q.stride(i) for i in range(3)] + [kv.stride(i) for i in range(3)] * 2
        attn = (code, d, q.data_ptr(), kv.data_ptr(), kv.data_ptr(), bias.data_ptr(),
                out.data_ptr(), None, None, b, t, s, h, 0, 0, *strides, stream)
        deq = (code, 8, 0, x.data_ptr(), w.data_ptr(), scale.data_ptr(), y.data_ptr(), m, k, n,
               stream)
        for name, fn, args in (("attention_fwd", lib.attention_fwd, attn),
                               ("dequant_matmul", lib.dequant_matmul, deq)):
            times = []
            for i in range(calls):
                if i % 50 == 0:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                err = fn(*args)
                times.append((time.perf_counter() - t0) * 1e6)
                build.check_launch(name, err)
            torch.cuda.synchronize()
            readings[f"{name}_{str(dtype).split('.')[1]}"] = sorted(times)[calls // 2]
    for name in ("attention_fwd", "dequant_matmul"):
        readings[f"{name}_tensor_map_us"] = (readings[f"{name}_bfloat16"]
                                             - readings[f"{name}_float32"])
    log(phase="entry_host_us", calls=calls, **readings)


def key_padding(torch, gen, padding, b: int, s: int):
    """The (B, S) key mask of a kernel row on the card: None, ``"random"``
    (~30% of keys) or ``"tail"`` (each example's tail from a random length,
    as the encoder's token rows are); a padded one masks every key of its
    last example."""
    if padding is None:
        return None
    if padding == "random":
        pad = torch.rand(b, s, generator=gen) < 0.3
    else:
        pad = torch.arange(s)[None, :] >= torch.randint(1, s + 1, (b, 1), generator=gen)
    pad[-1] = True
    return pad.cuda()


def live_work(pad, b: int, s: int) -> tuple:
    """(examples with a live key, live keys in all): the work this call's
    data needs, which the bounds count. A fully masked example needs no
    logits: its output is the mean of V, its dq and dk are 0 and its dv
    each key's share of G's column sums, so it reads only V (forward) or G
    (backward) and writes its outputs."""
    if pad is None:
        return b, b * s
    return int((~pad).any(1).sum()), int((~pad).sum())


# #1-#3 at the classifiers' calls (phases 33-34), name, (B, T, S, H, D),
# padding: the MNIST encoder's cross over 784 unpadded pixels and its
# self-attention at D=32, the reference-width text classifier's cross over
# tail-padded tokens and self-attention at D=16 (phase 34 d), the flagship
# transfer encoder at its batch of 128 and its one-query decoder (a, b, c).
# They are checked rows: the kernel's CUDA-event and device times beside
# the plain version's and the library's CUDA-event times; the rows of the
# earlier slices also read the library's device time and the host's cost.
CLASSIFIER_SHAPES = (("img_cross", (128, 32, 784, 4, 32), None),
                     ("img_self", (128, 32, 32, 4, 32), None),
                     ("text_clf_cross", (128, 64, 512, 4, 16), "tail"),
                     ("text_clf_self", (128, 64, 64, 4, 16), None),
                     ("clf_enc_cross", (128, 256, 512, 4, 128), "tail"),
                     ("clf_self", (128, 256, 256, 4, 128), None),
                     ("clf_dec_t1", (128, 1, 256, 4, 128), None))


def attention_phase(torch, ak):
    import torch.nn.functional as F

    shapes = [  # name, (B, T, S, H, D), padding
        ("enc_cross", (64, 256, 512, 4, 128), "random"),
        ("self", (64, 256, 256, 4, 128), None),
        ("dec_cross", (64, 8, 256, 4, 128), None),
        ("dec_cross_train", (64, CAPACITY, 256, 4, 128), "random"),
        ("ragged", (64, 250, 509, 4, 128), "random"),
        ("enc_cross_d16", (64, 256, 512, 4, 16), "random"),
    ]
    checked = {name for name, _, _ in CLASSIFIER_SHAPES}
    rows = []
    for name, (b, t, s, h, d), padding in shapes + list(CLASSIFIER_SHAPES):
        g = torch.Generator().manual_seed(b + t + s + d)
        pad = key_padding(torch, g, padding, b, s)
        for dtype in (torch.float32, torch.bfloat16):
            t_row = time.perf_counter()
            dt = str(dtype).split(".")[1]
            q = torch.randn(b, t, h, d, generator=g).to("cuda", dtype)
            k = torch.randn(b, s, h, d, generator=g).to("cuda", dtype)
            v = torch.randn(b, s, h, d, generator=g).to("cuda", dtype)
            design = ak.forward_design(q, k, v)
            before = ak.wgmma_counter.launches
            err = check(f"attention {name} {dt}", ak.fused_attention(q, k, v, pad),
                        ak.attention_reference(q, k, v, pad), dt)
            if ak.wgmma_counter.launches - before != (design == "wgmma"):
                raise AssertionError(f"attention {name} {dt}: {design} call, wgmma counter "
                                     f"{ak.wgmma_counter.launches - before}")
            bias = ak.pad_bias(pad, b, s, "cuda")
            mask = bias[:, None, None, :].to(dtype)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            io_t, io_s = (q.element_size() * n * h * d for n in (t, s))  # one example's
            live, keys = live_work(pad, b, s)
            nbytes = live * (2 * io_t + 2 * io_s) + (b - live) * (io_t + io_s) + 4 * b * s
            bound, by = bound_ms(nbytes, 4 * h * t * d * keys, dt)
            library = lambda: F.scaled_dot_product_attention(qt, kt, vt,  # noqa: E731
                                                             attn_mask=mask)
            row = dict(kernel="attention_fwd", shape=name, dims=[b, t, s, h, d], dtype=dt,
                       design=design, padding=padding, max_abs_err=err,
                       launches_per_forward=ATTN_PER_FORWARD,
                       kernel_ms=time_ms(lambda: ak.fused_attention(q, k, v, pad)),
                       plain_ms=time_ms(lambda: ak.attention_reference(q, k, v, pad)),
                       library_ms=time_ms(library), bound_ms=bound, bound_by=by,
                       device_ms=device_ms(torch, lambda: ak.fused_attention(q, k, v, pad),
                                           "attention_fwd"))
            if name not in checked:
                row.update(library_device_ms=device_ms(torch, library),
                           host_us_per_call=host_us(torch, lambda: ak.fused_attention(
                               q, k, v, pad)))
            row["row_s"] = time.perf_counter() - t_row
            log(**row)
            rows.append(row)
    return rows


def check_stats(name: str, got, ref) -> float:
    """m and l: f32 on both sides, compared within STAT_TOL of max(|ref|, 1)
    (m is -1e30 on a fully masked row)."""
    import torch

    torch.cuda.synchronize()
    rel = float(((got - ref).abs() / ref.abs().clamp_min(1.0)).max())
    if not rel <= STAT_TOL:
        raise AssertionError(f"{name}: statistics differ by {rel} relative")
    return rel


def library_bwd_ms(torch, q, k, v, g, mask, device: bool = True):
    """SDPA's backward alone with the same additive mask: ``autograd.grad``
    over one retained forward graph; its CUDA-event time and, with
    ``device``, its device time (every kernel of the call; else None)."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    gt = g.transpose(1, 2)
    fn = lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)  # noqa: E731
    return time_ms(fn, 30), device_ms(torch, fn) if device else None


def skipped_tiles(pad, s: int):
    """What the bf16 backward (#2/#3) and the bf16 packed kernels (#4/#5)
    skip for this padding: the share of (example, 64-key tile) pairs that
    are all padding, which the dq kernels (and the packed forward) never
    load, and the share of the dk/dv kernels' (example, 64-key warpgroup)
    rows that compute nothing (all padding in an example with a valid key)."""
    import torch

    if pad is None:
        return 0.0, 0.0
    tiles = -(-s // 64)
    padded = torch.ones(pad.shape[0], tiles * 64, dtype=torch.bool, device=pad.device)
    padded[:, :s] = pad
    dead = padded.view(-1, tiles, 64).all(-1)
    return float(dead.float().mean()), float((dead & ~pad.all(1, keepdim=True)).float().mean())


def attention_bwd_phase(torch, ak):
    """The forward's (m, l) and the two backward kernels against their plain
    versions at the training shapes; times of the dq kernel, the dk/dv
    kernel, the whole backward (delta included), the plain backward and
    SDPA's backward, CUDA events and profiler device times (SDPA's device
    time not at ``CLASSIFIER_SHAPES``); the share of key tiles the bf16
    design skips. ``ragged`` and the classifiers' token crosses pad each
    example's tail from a random length (as the encoder's token rows are),
    the others pad ~30% of keys at random; each padded shape masks every key
    of its last example."""
    shapes = [  # name, (B, T, S, H, D), padding: None, "random" or "tail"
        ("enc_cross", (64, 256, 512, 4, 128), "random"),
        ("self", (64, 256, 256, 4, 128), None),
        ("dec_cross", (64, CAPACITY, 256, 4, 128), None),
        ("enc_cross_d16", (64, 256, 512, 4, 16), "random"),
        ("ragged", (64, 250, 509, 4, 128), "tail"),
    ]
    checked = {name for name, _, _ in CLASSIFIER_SHAPES}
    rows = []
    for name, (b, t, s, h, d), padding in shapes + list(CLASSIFIER_SHAPES):
        gen = torch.Generator().manual_seed(b + t + s + d + 1)
        pad = key_padding(torch, gen, padding, b, s)
        dq_skip, dkv_skip = skipped_tiles(pad, s)
        for dtype in (torch.float32, torch.bfloat16):
            t_row = time.perf_counter()
            dt = str(dtype).split(".")[1]
            q, g = (torch.randn(b, t, h, d, generator=gen).to("cuda", dtype) for _ in range(2))
            k, v = (torch.randn(b, s, h, d, generator=gen).to("cuda", dtype) for _ in range(2))
            out, m, l = ak.attention_fwd_with_stats(q, k, v, pad)
            ref_out, ref_m, ref_l = ak.attention_reference_with_stats(q, k, v, pad)
            check(f"attention fwd+stats {name} {dt}", out, ref_out, dt)
            stat_err = max(check_stats(f"m {name} {dt}", m, ref_m),
                           check_stats(f"l {name} {dt}", l, ref_l))
            # both backward versions from the same residuals
            design = ak.backward_design(q, k, v, g)
            before = (ak.dq_wgmma_counter.launches, ak.dkv_wgmma_counter.launches)
            grads = ak.attention_bwd(q, k, v, pad, ref_out, ref_m, ref_l, g)
            wgmma = (ak.dq_wgmma_counter.launches - before[0],
                     ak.dkv_wgmma_counter.launches - before[1])
            if wgmma != ((1, 1) if design == "wgmma" else (0, 0)):
                raise AssertionError(f"attention bwd {name} {dt}: {design} call, wgmma "
                                     f"counters {wgmma}")
            refs = ak.attention_bwd_reference(q, k, v, pad, ref_out, ref_m, ref_l, g)
            errs = [check(f"attention bwd {x} {name} {dt}", got, ref, dt)
                    for x, got, ref in zip(("dq", "dk", "dv"), grads, refs)]
            if pad is not None and (grads[0][-1].any() or grads[1][-1].any()):
                raise AssertionError(f"{name} {dt}: dq/dk of the fully masked example not 0")
            bias = ak.pad_bias(pad, b, s, "cuda")
            delta = ak.bwd_delta(g, ref_out)
            io_t, io_s = (q.element_size() * n * h * d for n in (t, s))  # one example's
            live, keys = live_work(pad, b, s)
            dead = b - live
            stats_bytes = 4 * 3 * b * h * t + 4 * b * s  # m, l, delta, bias
            dq_bound = bound_ms(live * (3 * io_t + 2 * io_s) + dead * io_t + stats_bytes,
                                3 * 2 * h * t * d * keys, dt)
            dkv_bound = bound_ms(live * (2 * io_t + 4 * io_s) + dead * (io_t + 2 * io_s)
                                 + stats_bytes, 4 * 2 * h * t * d * keys, dt)
            bwd_bound = bound_ms(live * (4 * io_t + 4 * io_s) + dead * (2 * io_t + 2 * io_s)
                                 + 8 * b * h * t + 4 * b * s, 5 * 2 * h * t * d * keys, dt)
            plain = time_ms(lambda: ak.attention_bwd_reference(q, k, v, pad, ref_out, ref_m,
                                                               ref_l, g))
            library, library_device = library_bwd_ms(torch, q, k, v, g,
                                                     bias[:, None, None, :].to(dtype),
                                                     device=name not in checked)
            run_dq = lambda: ak.launch_bwd_dq(q, k, v, bias, ref_m, ref_l, delta, g)  # noqa: E731
            run_dkv = lambda: ak.launch_bwd_dkv(q, k, v, bias, ref_m, ref_l, delta,  # noqa: E731
                                                g)
            row = dict(kernel="attention_bwd", shape=name, dims=[b, t, s, h, d], dtype=dt,
                       design=design, padding=padding, max_abs_err=max(errs),
                       stats_max_rel_err=stat_err,
                       dq_tiles_skipped=dq_skip if design == "wgmma" else 0.0,
                       dkv_rows_skipped=dkv_skip if design == "wgmma" else 0.0,
                       dq_ms=time_ms(run_dq), dkv_ms=time_ms(run_dkv),
                       dq_device_ms=device_ms(torch, run_dq, "attention_bwd_dq"),
                       dkv_device_ms=device_ms(torch, run_dkv, "attention_bwd_dkv"),
                       kernel_ms=time_ms(lambda: ak.attention_bwd(q, k, v, pad, ref_out, ref_m,
                                                                  ref_l, g)),
                       plain_ms=plain, library_ms=library, library_device_ms=library_device,
                       bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
                       dq_bound_ms=dq_bound[0], dq_bound_by=dq_bound[1],
                       dkv_bound_ms=dkv_bound[0], dkv_bound_by=dkv_bound[1],
                       fwd_stats_ms=time_ms(lambda: ak.attention_fwd_with_stats(q, k, v, pad)),
                       row_s=time.perf_counter() - t_row)
            log(**row)
            rows.append(row)
            del q, k, v, g, out, m, l, ref_out, ref_m, ref_l, grads, refs
    return rows


def dequant_phase(torch, qm, QKernel, pack_int4, quantize_array):
    import numpy as np

    rows = []
    shapes = (("self_proj", (16384, 512, 512)), ("vocab_head", (512, 512, 10003)),
              ("vocab_head_m1", (1, 512, 10003)), ("vocab_head_m413", (413, 512, 10003)))
    for name, (m, k, n) in shapes:
        rng = np.random.default_rng(m + n)
        w = rng.normal(size=(k, n)).astype(np.float32) * 0.05
        for bits, gs in ((8, None), (4, 128)):
            qv, scale_np = quantize_array(w, bits=bits, group_size=gs)
            q = torch.from_numpy(pack_int4(qv) if bits == 4 else qv).cuda()
            scale = torch.from_numpy(scale_np).cuda()
            for dtype in (torch.float32, torch.bfloat16):
                dt = str(dtype).split(".")[1]
                x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to("cuda", dtype)
                design = qm.matmul_design(x, gs)
                before = qm.wgmma_counter.launches
                err = check(f"dequant {name} int{bits} {dt}",
                            qm.dequant_matmul(x, q, scale, bits, gs),
                            qm.dequant_matmul_reference(x, q, scale, bits, gs), dt)
                if qm.wgmma_counter.launches - before != (design == "wgmma"):
                    raise AssertionError(f"dequant {name} int{bits} {dt}: {design} call, "
                                         f"wgmma counter {qm.wgmma_counter.launches - before}")
                w_deq = QKernel(q, scale, bits, dtype).dequantize()
                nbytes = (x.element_size() * (m * k + m * n) + q.numel()
                          + 4 * scale.numel())
                bound, by = bound_ms(nbytes, 2 * m * k * n, dt)
                row = dict(kernel="dequant_matmul", shape=name, dims=[m, k, n],
                           quant=f"int{bits}" + (f"-g{gs}" if gs else ""), dtype=dt,
                           design=design, max_abs_err=err,
                           launches_per_forward=DEQUANT_PER_FORWARD,
                           kernel_ms=time_ms(lambda: qm.dequant_matmul(x, q, scale, bits, gs)),
                           plain_ms=time_ms(lambda: qm.dequant_matmul_reference(
                               x, q, scale, bits, gs), 3),
                           library_ms=time_ms(lambda: torch.matmul(x, w_deq)),
                           bound_ms=bound, bound_by=by,
                           device_ms=device_ms(torch, lambda: qm.dequant_matmul(
                               x, q, scale, bits, gs), "dequant_matmul"),
                           library_device_ms=device_ms(torch, lambda: torch.matmul(x, w_deq)),
                           host_us_per_call=host_us(torch, lambda: qm.dequant_matmul(
                               x, q, scale, bits, gs)))
                log(**row)
                rows.append(row)
    return rows


def masked_texts(synthetic_reviews, n: int = 200):
    """~n texts of 20..~400 words with 1-3 ``[MASK]`` words each, so every
    width bucket (128 / 256 / 512) sees traffic."""
    import numpy as np

    reviews, _ = synthetic_reviews(n, seed=11)
    rng = np.random.default_rng(12)
    texts = []
    for i, review in enumerate(reviews):
        words = (review + " " + reviews[(i + 1) % n] + " " + reviews[(i + 2) % n]
                 if i % 4 == 0 else review).split()
        for j in rng.choice(len(words), size=int(rng.integers(1, 4)), replace=False):
            words[j] = "[MASK]"
        texts.append(" ".join(words))
    return texts


def use_plain_kernels(model, port) -> None:
    """Put the plain versions in the kernels' place on every layer."""
    for module in model.modules():
        if isinstance(module, port["MultiHeadAttention"]):
            module.attention = port["ak"].attention_reference
            module.packed_attention = port["pk"].packed_attention_reference
        if isinstance(module, port["Linear"]):
            module.qmatmul = port["qm"].dequant_matmul_reference


def use_attn_impl(model, port, impl: str) -> None:
    """Route every attention layer of ``model`` through ``impl``'s kernels
    (the weights do not depend on it)."""
    for module in model.modules():
        if isinstance(module, port["MultiHeadAttention"]):
            module.attn_impl = impl


def check_wgmma_share(ak, qm, what: str) -> None:
    """Every launch of #1 and #9 since the counters' reset went through the
    bf16 wgmma designs."""
    got = (ak.wgmma_counter.launches, qm.wgmma_counter.launches)
    if got != (ak.counter.launches, qm.counter.launches):
        raise AssertionError(f"{what}: wgmma launches {got} of (#1, #9) launches "
                             f"{(ak.counter.launches, qm.counter.launches)}")


def serving_phase(torch, ak, qm, port, tokenizer, texts):
    counters = (ak.counter, qm.counter, ak.wgmma_counter, qm.wgmma_counter)
    model = port["presets"].flagship_tpu_mlm(device="cuda", seed=0)
    names = ("attention_fwd", "dequant_matmul", "attention_fwd_wgmma", "dequant_matmul_wgmma")
    launches = dict.fromkeys(names, 0)
    for mode in ("bfloat16", "int8w", "int4w"):
        server = port["MLMServer"](model, None, tokenizer, 512, bucket_widths=[128, 256, 512],
                                   max_batch=64, compute_dtype=mode, device="cuda")
        quantized = mode != "bfloat16"
        for c in counters:
            c.reset()
        gc.collect()  # the earlier phases' garbage, collected outside the timed pass
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fills = server.fill_masks(texts, k=5)
        torch.cuda.synchronize()
        fused_s = time.perf_counter() - t0
        n_fwd = server.engine.dispatches
        expect = (ATTN_PER_FORWARD * n_fwd, DEQUANT_PER_FORWARD * n_fwd if quantized else 0)
        got = (ak.counter.launches, qm.counter.launches)
        if got != expect or ak.counter.plain_calls or qm.counter.plain_calls:
            raise AssertionError(f"{mode} fused: launches {got} != {expect} over {n_fwd} "
                                 f"forwards, or a plain version ran")
        check_wgmma_share(ak, qm, f"{mode} fused")
        for name, c in zip(names, counters):
            launches[name] += c.launches

        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        cached = server.encode(texts)
        cached_fills = server.fill_masks_cached(cached, k=5)
        torch.cuda.synchronize()
        cached_s = time.perf_counter() - t0
        n_enc, n_dec = server.encoder.dispatches, server.decoder.dispatches
        expect = (ATTN_PER_ENCODE * n_enc + ATTN_PER_DECODE * n_dec,
                  (DEQUANT_PER_ENCODE * n_enc + DEQUANT_PER_DECODE * n_dec) if quantized else 0)
        got = (ak.counter.launches, qm.counter.launches)
        if got != expect or ak.counter.plain_calls or qm.counter.plain_calls:
            raise AssertionError(f"{mode} cached: launches {got} != {expect}")
        check_wgmma_share(ak, qm, f"{mode} cached")
        for name, c in zip(names, counters):
            launches[name] += c.launches

        masks = [t.split().count("[MASK]") for t in texts]
        for out in (fills, cached_fills):
            if [len(r) for r in out] != masks or any(len(f) != 5 for r in out for f in r):
                raise AssertionError(f"{mode}: fills of the wrong shape")
        logits = server.decode(cached, [[0, 1]] * len(cached))
        import numpy as np

        if logits.shape != (len(texts), 2, 10003) or not np.isfinite(logits).all():
            raise AssertionError(f"{mode}: decode logits {logits.shape} not finite")
        top1 = [f[0] for r in fills for f in r]
        agree = float(np.mean([a == b for a, b in zip(top1, [f[0] for r in cached_fills
                                                             for f in r])]))
        if mode in ("bfloat16", "int8w"):
            profile_pass(torch, lambda: server.fill_masks(texts, k=5), mode)
        plain_agreement = None
        if mode == "bfloat16":
            plain_agreement = bf16_plain_agreement(ak, qm, port, server, tokenizer, texts, top1)
        log(phase="serve", mode=mode, texts=len(texts), masks=sum(masks),
            fused_forwards=n_fwd, encodes=n_enc, decodes=n_dec,
            attention_per_forward=ATTN_PER_FORWARD,
            dequant_per_forward=DEQUANT_PER_FORWARD if quantized else 0,
            fill_masks_s=fused_s, encode_and_cached_fill_s=cached_s,
            cached_top1_agreement=agree, plain_top1_agreement=plain_agreement,
            example=[texts[1][:60], fills[1]])
        del server
    return launches


def bf16_plain_agreement(ak, qm, port, server, tokenizer, texts, top1) -> float:
    """The bf16 pass again on the same weights with the plain versions in the
    kernels' place: the share of masks whose top-1 fill agrees with the
    kernels' (``top1``); fails below BF16_TOP1_AGREEMENT."""
    import numpy as np

    plain = port["MLMServer"](server.model, None, tokenizer, 512, bucket_widths=[128, 256, 512],
                              max_batch=64, compute_dtype="bfloat16", device="cuda")
    use_plain_kernels(plain.model, port)
    before = (ak.counter.launches, qm.counter.launches)
    top_plain = [f[0] for r in plain.fill_masks(texts, k=1) for f in r]
    if (ak.counter.launches, qm.counter.launches) != before:
        raise AssertionError("the bf16 plain pass launched a kernel")
    del plain
    agreement = float(np.mean([a == b for a, b in zip(top1, top_plain)]))
    if len(top_plain) != len(top1) or not agreement >= BF16_TOP1_AGREEMENT:
        raise AssertionError(f"bf16 serving: top-1 kernels vs plain agree on {agreement} of "
                             f"{len(top1)} masks < {BF16_TOP1_AGREEMENT}")
    return agreement


def window_trainer(port, train_step, eval_step, state, steps: int, logdir: str):
    """A Trainer for a timed window of ``steps`` more steps from ``state``,
    its rows logged every ``steps``: no TensorBoard writer and no end-of-fit
    checkpoint, so the window measures the steps (phases 29-32 measure the
    saves). Use it in ``with``, which closes its checkpoint thread."""
    trainer = port["Trainer"](
        train_step, eval_step, state,
        port["TrainerConfig"](max_steps=state.step + steps, log_every_n_steps=steps,
                              logdir=logdir, use_tensorboard=False),
        tokens_per_example=SEQ_LEN)
    trainer.checkpoints.save = lambda *args, **kwargs: False
    return trainer


def profile_pass(torch, run, mode: str) -> None:
    """Where one pass spends the card's time: device time by kernel
    (torch.profiler) against the host wall clock of the pass."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = []  # kernels only: an operator's device time repeats its kernels',
    # and a user annotation's (Optimizer.step#...) spans kernels it does not run
    for event in prof.key_averages():
        ms = event.self_device_time_total / 1e3
        if event.device_type == torch.autograd.DeviceType.CUDA and ms > 0 \
                and not getattr(event, "is_user_annotation", False):
            device.append((ms, event.count, event.key[:70]))
    device.sort(reverse=True)
    busy_ms = sum(ms for ms, _, _ in device)
    reading = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                   device_idle_share=(1 - busy_ms / wall_ms) if device else None)
    log(phase="profile", mode=mode, **reading,
        top=[dict(kernel=k, ms=ms, calls=c) for ms, c, k in device[:20]])
    return reading


def plain_parity_phase(torch, ak, qm, port, tokenizer, texts):
    """f32 serving with the kernels, then with the plain versions in their
    place: the top-1 fill of every mask must agree."""
    model = port["presets"].flagship_tpu_mlm(dtype=torch.float32, device="cuda", seed=0)
    for quantize in (None, "int8"):
        kernel = port["MLMServer"](model, None, tokenizer, 512, bucket_widths=[128, 256, 512],
                                   max_batch=64, quantize=quantize, device="cuda")
        top_kernel = [f[0] for r in kernel.fill_masks(texts, k=1) for f in r]
        del kernel
        plain = port["MLMServer"](model, None, tokenizer, 512, bucket_widths=[128, 256, 512],
                                  max_batch=64, quantize=quantize, device="cuda")
        use_plain_kernels(plain.model, port)
        before = (ak.counter.launches, qm.counter.launches)
        top_plain = [f[0] for r in plain.fill_masks(texts, k=1) for f in r]
        if (ak.counter.launches, qm.counter.launches) != before:
            raise AssertionError("the plain pass launched a kernel")
        del plain
        mismatched = sum(a != b for a, b in zip(top_kernel, top_plain))
        log(phase="plain_parity", quantize=quantize or "none", masks=len(top_kernel),
            top1_mismatches=mismatched)
        if mismatched or len(top_kernel) != len(top_plain):
            raise AssertionError(f"f32 {quantize}: {mismatched} top-1 fills differ from plain")


def train_setup(torch, port, dtype, plain: bool = False, seed: int = 2,
                preset: str = "flagship_tpu_mlm", fused_head=False, attn_impl: str = "pallas",
                **model_options):
    """The preset's MLM (weights from seed 0, ``model_options`` such as
    ``dropout`` and ``remat`` passed to it) with Adam at 1e-3 and its train
    state (masking and dropout from ``seed``), its steps at capacity 160 with
    ``fused_head`` and ``attn_impl``; with ``plain`` the plain attention and
    CE versions stand in the kernels' place."""
    model = port["presets"].PRESETS[preset](dtype=dtype, device="cuda", seed=0,
                                            attn_impl=attn_impl, **model_options)
    if plain:
        for module in model.modules():
            if isinstance(module, port["MultiHeadAttention"]):
                module.attention = port["ak"].plain_attention
                module.packed_attention = port["pk"].plain_packed_attention
        model.decoder.output_adapter.linear_ce = port["ck"].plain_linear_ce_integer
    optimizer, schedule = port["make_optimizer"](port["OptimizerConfig"](learning_rate=1e-3),
                                                 model.parameters())
    state = port["TrainState"].create(model, optimizer, schedule, seed=seed)
    steps = port["make_mlm_steps"](model, schedule, loss_gather_capacity=CAPACITY,
                                   fused_head=fused_head)
    return model, state, steps


def path_counters(port):
    """The counters of KERNEL_NAMES, in that order."""
    ak, ck, pk = port["ak"], port["ck"], port["pk"]
    return (ak.counter, ak.dq_counter, ak.dkv_counter,
            ck.ce_fwd_counter, ck.ce_dx_counter, ck.ce_dw_counter,
            pk.fwd_counter, pk.dq_counter, pk.dkv_counter, ak.wgmma_counter,
            ak.dq_wgmma_counter, ak.dkv_wgmma_counter, pk.fwd_wgmma_counter,
            pk.dq_wgmma_counter, pk.dkv_wgmma_counter, ck.ce_dx_wgmma_counter,
            ck.ce_dw_wgmma_counter, ck.ce_fwd_wgmma_counter, ak.dq_causal_counter,
            ak.dkv_causal_counter)


def per_step_launches(fused_head, attn_impl: str = "pallas", bf16: bool = True) -> list:
    """Launches of one MLM train step, in ``path_counters`` order; in bf16
    every launch of #1-#8 takes the wgmma design; none is causal."""
    ce = 1 if fused_head else 0
    fused, packed = (0, ATTN_PER_FORWARD) if attn_impl == "packed" else (ATTN_PER_FORWARD, 0)
    return ([fused] * 3 + [ce] * 3 + [packed] * 3 + [fused if bf16 else 0] * 3
            + [packed if bf16 else 0] * 3 + [ce if bf16 else 0] * 3 + [0, 0])


def per_eval_launches(per_step: list) -> list:
    """Launches of one eval batch: the forward kernels of a train step."""
    return [n if "_fwd" in name else 0 for name, n in zip(KERNEL_NAMES, per_step)]


def bench_batch(torch):
    """bench.py's batch: ids from default_rng(0) in [3, 10003), no padding."""
    import numpy as np

    ids = np.random.default_rng(0).integers(3, 10003, (TRAIN_BATCH, SEQ_LEN)).astype(np.int32)
    return {"token_ids": torch.from_numpy(ids).cuda(),
            "pad_mask": torch.zeros((TRAIN_BATCH, SEQ_LEN), dtype=torch.bool, device="cuda")}


def training_phase(torch, port, data, logdir, preset: str = "flagship_tpu_mlm",
                   fused_head=False, attn_impl: str = "pallas"):
    """The training path: Trainer.fit over TRAIN_STEPS bf16 steps, each one
    checked for its kernel launches, its plain calls and a finite loss; then
    the unchecked windows. With the fused head and the pallas attention, the
    same window with the unfused head; with the packed attention, the same
    window with the pallas attention; each pair also timed on bench.py's
    batch, in turns."""
    counters = path_counters(port)
    names = KERNEL_NAMES
    per_step = per_step_launches(fused_head, attn_impl)
    per_eval = per_eval_launches(per_step)
    model, state, (train_step, eval_step, _) = train_setup(torch, port, torch.bfloat16,
                                                           preset=preset,
                                                           fused_head=fused_head,
                                                           attn_impl=attn_impl)
    label = f"{preset} {attn_impl}"
    losses, step_ms = [], []
    ck, ce_cotangents = port["ck"], []  # each step's CE cotangent g: the row tiles skipped

    def checked_step(state, batch):
        before = [c.launches for c in counters]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = train_step(state, batch)
        end.record()
        torch.cuda.synchronize()
        got = [c.launches - b for c, b in zip(counters, before)]
        if got != per_step or any(c.plain_calls for c in counters):
            raise AssertionError(f"{label} train step {state.step}: launches {got} != "
                                 f"{per_step}, or a plain version ran")
        loss = float(metrics["loss"])
        if loss != loss or abs(loss) == float("inf"):
            raise AssertionError(f"{label} train step {state.step}: loss {loss}")
        losses.append(loss)
        step_ms.append(start.elapsed_time(end))
        return state, metrics

    trainer = port["Trainer"](checked_step, eval_step, state,
                              port["TrainerConfig"](max_steps=TRAIN_STEPS, log_every_n_steps=10,
                                                    logdir=logdir, use_tensorboard=False),
                              tokens_per_example=SEQ_LEN)
    val_loader = data.val_dataloader()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset()
    launch_bwd_dw = ck.launch_bwd_dw

    def spy(x, w, b, labels, lse, g, wt=None):  # a copy of g, read after the fit (no sync)
        ce_cotangents.append(g.detach().clone())
        return launch_bwd_dw(x, w, b, labels, lse, g, wt)

    ck.launch_bwd_dw = spy
    t0 = time.perf_counter()
    try:
        trainer.fit(data.train_dataloader(), val_loader)
        torch.cuda.synchronize()
    finally:
        ck.launch_bwd_dw = launch_bwd_dw
    fit_s = time.perf_counter() - t0
    ce_tiles = [zero_row_tiles(g) for g in ce_cotangents]
    del ce_cotangents
    launches = {name: c.launches for name, c in zip(names, counters)}
    expect = {name: s * TRAIN_STEPS + e * len(val_loader)
              for name, s, e in zip(names, per_step, per_eval)}
    if launches != expect:
        raise AssertionError(f"{label} fit launches {launches} != {expect} over "
                             f"{TRAIN_STEPS} steps and {len(val_loader)} eval batches")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    with open(f"{trainer.run_dir}/metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    val = [r["val_loss"] for r in rows if "val_loss" in r]
    tail = sum(losses[-5:]) / 5
    if not tail < losses[0] or len(val) != 1 or not val[0] == val[0]:
        raise AssertionError(f"{label}: loss did not fall: first {losses[0]}, last five "
                             f"{tail}, val {val}")
    steady = sorted(step_ms[1:])
    median_ms = steady[len(steady) // 2]
    tokens = TRAIN_BATCH * SEQ_LEN
    state = trainer.state

    def window_fit(n_steps: int, name: str, step=train_step, per=per_step) -> float:
        """Trainer.fit over n more steps as the CLI drives it (no per-step
        check or sync; the loader collates between steps); its logged
        tokens/s: all the window's tokens over its host time."""
        nonlocal state
        before = [c.launches for c in counters]
        with window_trainer(port, step, eval_step, state, n_steps, f"{logdir}/{name}") as fit:
            state = fit.fit(data.train_dataloader())
        got = [c.launches - b for c, b in zip(counters, before)]
        if got != [n * n_steps for n in per] or any(c.plain_calls for c in counters):
            raise AssertionError(f"{label} {name}: launches {got} over {n_steps} steps")
        with open(f"{fit.run_dir}/metrics.jsonl") as f:
            row = [json.loads(line) for line in f][-1]
        if not math.isfinite(row["train_loss"]):
            raise AssertionError(f"{label} {name}: loss {row['train_loss']}")
        return row["tokens_per_sec"]

    window_rate = window_fit(WINDOW_STEPS, "window")
    profile_pass(torch, lambda: window_fit(PROFILE_STEPS, "profiled"),
                 f"train_{preset}_bfloat16" + ("_fused" if fused_head else "")
                 + ("_packed" if attn_impl == "packed" else ""))
    loader = iter(data.train_dataloader())
    collate_ms = []
    for _ in range(WINDOW_STEPS):
        t0 = time.perf_counter()
        next(loader)
        collate_ms.append((time.perf_counter() - t0) * 1e3)
    window_step_ms = tokens / window_rate * 1e3
    # the arm this path runs and the arm it is compared with, on the same
    # model and state: (step, launches per step, attention impl)
    arms = {}
    if attn_impl == "packed":
        arms = {"packed": (train_step, per_step, "packed"),
                "pallas": (train_step, per_step_launches(fused_head, "pallas"), "pallas")}
    elif fused_head:
        unfused_step = port["make_mlm_steps"](model, state.schedule,
                                              loss_gather_capacity=CAPACITY)[0]
        arms = {"fused": (train_step, per_step, attn_impl),
                "unfused": (unfused_step, per_step_launches(False, attn_impl), attn_impl)}
    turns = {}
    if arms:
        # windows this, other, other, this (the first is the window above),
        # then bench.py's batch this, other, other, this
        this, other = arms
        turns["window_tokens_per_s"] = {this: [window_rate], other: []}
        for i, arm in enumerate((other, other, this)):
            step, per, impl = arms[arm]
            use_attn_impl(model, port, impl)
            turns["window_tokens_per_s"][arm].append(
                window_fit(WINDOW_STEPS, f"window_{i}", step, per))
        batch = bench_batch(torch)
        turns["bench_batch_tokens_per_s"] = {this: [], other: []}
        for arm in (this, other, other, this):
            step, _, impl = arms[arm]
            use_attn_impl(model, port, impl)
            state, _ = step(state, batch)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(BENCH_STEPS):
                state, metrics = step(state, batch)
            torch.cuda.synchronize()
            if not math.isfinite(float(metrics["loss"])):
                raise AssertionError(f"{label} bench batch: loss {metrics['loss']}")
            turns["bench_batch_tokens_per_s"][arm].append(
                BENCH_STEPS * tokens / (time.perf_counter() - t0))
    log(phase="train", preset=preset, fused_head=fused_head, attn_impl=attn_impl,
        steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq_len=SEQ_LEN,
        capacity=CAPACITY, first_loss=losses[0], last5_mean_loss=tail, val_loss=val[0],
        ce_tiles_skipped=(sum(ce_tiles) / len(ce_tiles)) if ce_tiles else None,
        ce_tiles_skipped_per_step=ce_tiles,
        losses=losses, tokens_per_s=window_rate, window_steps=WINDOW_STEPS,
        window_step_ms=window_step_ms, step_ms_first=step_ms[0], step_ms_median=median_ms,
        step_ms_mean=sum(steady) / len(steady), step_tokens_per_s=tokens / (median_ms / 1e3),
        between_steps_ms=window_step_ms - median_ms,
        collate_ms_median=sorted(collate_ms)[len(collate_ms) // 2],
        checked_fit_tokens_per_s=[r["tokens_per_sec"] for r in rows if "tokens_per_sec" in r],
        fit_s=fit_s, peak_memory_gib=peak_gib, launches=launches,
        launches_per_step=dict(zip(names, per_step)), **turns)
    del model, state, trainer
    return launches


def cli_phase(torch, port, root: str, vocab: int, attn_impl: str = "pallas") -> None:
    """The training CLI's default preset (``reference``: 64 latents x 64
    channels) on the card for CLI_STEPS steps, in-process, with
    ``--attn_impl`` and validation every 2 steps: ``--fused_head auto`` must
    resolve to the CE kernels there, only ``attn_impl``'s attention kernels
    may launch, the vocab head has the tokenizer's ``vocab`` rows (as the
    JAX CLI builds it), and validation runs at each multiple of 2 and at the
    last step (the JAX trainer's cadence)."""
    counters = path_counters(port)
    for c in counters:
        c.reset()
    common = port["train_mlm"].common
    build_mlm, built = common.build_mlm, []

    def spy(args, vocab_size, *rest, **kwargs):
        built.append(vocab_size)
        return build_mlm(args, vocab_size, *rest, **kwargs)

    common.build_mlm = spy
    t0 = time.perf_counter()
    try:
        run_dir = port["train_mlm"].main([
            "--preset", "reference", "--synthetic", "--max_steps", str(CLI_STEPS),
            "--eval_every_n_steps", "2", "--attn_impl", attn_impl,
            "--log_every_n_steps", str(CLI_STEPS), "--root", root,
            "--logdir", f"{root}/cli_{attn_impl}"])
    finally:
        common.build_mlm = build_mlm
    torch.cuda.synchronize()
    with open(f"{run_dir}/metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    launches = dict(zip(KERNEL_NAMES, (c.launches for c in counters)))
    train = [r for r in rows if "train_loss" in r]
    val_steps = [r["step"] for r in rows if "val_loss" in r]
    used, unused = ("packed_attention", "attention") if attn_impl == "packed" \
        else ("attention", "packed_attention")
    # the CLI trains in bf16: every attention launch through the wgmma designs
    attention_ok = (launches[f"{used}_bwd_dq"] == launches[f"{used}_bwd_dkv"]
                    == ATTN_PER_FORWARD * CLI_STEPS
                    and all(launches[f"{used}_{k}_wgmma"] == launches[f"{used}_{k}"]
                            for k in ("fwd", "bwd_dq", "bwd_dkv"))
                    and not any(launches[f"{unused}_{k}"] for k in ("fwd", "bwd_dq", "bwd_dkv")))
    ce_bwd = (launches["linear_ce_bwd_dx"], launches["linear_ce_bwd_dw"],
              launches["linear_ce_bwd_dx_wgmma"], launches["linear_ce_bwd_dw_wgmma"])
    if ce_bwd != (CLI_STEPS,) * 4 or launches["linear_ce_fwd"] <= CLI_STEPS \
            or launches["linear_ce_fwd_wgmma"] != launches["linear_ce_fwd"] \
            or any(c.plain_calls for c in counters) \
            or not attention_ok or not all(math.isfinite(r["train_loss"]) for r in train) \
            or built != [vocab] or val_steps != [2, 4, CLI_STEPS]:
        raise AssertionError(f"train_mlm --preset reference --attn_impl {attn_impl}: "
                             f"launches {launches}, vocab {built} (tokenizer {vocab}), "
                             f"rows {rows}")
    log(phase="cli", preset="reference", attn_impl=attn_impl, steps=CLI_STEPS, vocab=built[0],
        launches=launches, train_loss=train[-1]["train_loss"],
        tokens_per_s=train[-1]["tokens_per_sec"], val_steps=val_steps,
        val_loss=[r["val_loss"] for r in rows if "val_loss" in r], wall_s=time.perf_counter() - t0)


def train_parity_phase(torch, port, data, preset: str = "flagship_tpu_mlm", fused_head=False,
                       attn_impl: str = "pallas"):
    """Three f32 steps with the kernels, then with the plain versions in
    their place, from the same weights, batches and masking, for each of
    PARITY_SEEDS: the losses within 1e-4 relative, the first step's
    gradients within 1e-3 of each leaf's peak (k_proj.bias is zero in exact
    arithmetic, softmax being shift-invariant per row: there both sides must
    be noise far below the other gradients). Then the same function through
    other kernels, its losses within 1e-4 relative: with the packed
    attention the pallas attention kernels, else with the fused head the
    unfused head."""
    counters = path_counters(port)
    batches = [b for _, b in zip(range(3), data.train_dataloader())]
    readings = []
    # (head, plain, attention) of each run: the kernels, the plain versions,
    # and the comparison run, if any
    versus = ((fused_head, False, "pallas") if attn_impl == "packed"
              else (False, False, attn_impl) if fused_head else None)
    runs_of = [(fused_head, False, attn_impl), (fused_head, True, attn_impl)] \
        + ([versus] if versus else [])
    for seed in PARITY_SEEDS:
        runs = []
        for head, plain, impl in runs_of:
            model, state, (train_step, _, _) = train_setup(torch, port, torch.float32, plain,
                                                           seed, preset, head, impl)
            before = [c.launches for c in counters]
            losses, grads = [], None
            for batch in batches:
                state, metrics = train_step(state, batch)
                losses.append(float(metrics["loss"]))
                if grads is None:
                    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
            got = [c.launches - b for c, b in zip(counters, before)]
            expect = [0] * len(counters) if plain else [
                3 * n for n in per_step_launches(head, impl, bf16=False)]
            if got != expect:
                raise AssertionError(f"{preset} head={head} plain={plain} {impl}: launches "
                                     f"{got} != {expect}")
            runs.append((losses, grads))
            del model, state
        (k_losses, k_grads), (p_losses, p_grads) = runs[:2]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(k_losses, p_losses))
        versus_rel = (max(abs(a - b) / abs(b) for a, b in zip(k_losses, runs[2][0]))
                      if versus else 0.0)
        peak_all = max(float(g.abs().max()) for g in p_grads.values())
        worst, worst_name, symmetric = 0.0, None, 0.0
        for name, ref in p_grads.items():
            got = k_grads[name]
            if name.endswith("k_proj.bias"):
                symmetric = max(symmetric, float(got.abs().max()) / peak_all,
                                float(ref.abs().max()) / peak_all)
                continue
            peak = float(ref.abs().max())
            err = float((got - ref).abs().max())
            err = err / peak if peak else err
            if err > worst:
                worst, worst_name = err, name
        extra = dict(versus=dict(zip(("fused_head", "plain", "attn_impl"), versus)),
                     versus_losses=runs[2][0], versus_loss_max_rel_diff=versus_rel) \
            if versus else {}
        log(phase="train_parity", preset=preset, fused_head=fused_head, attn_impl=attn_impl,
            dtype="float32", seed=seed, kernel_losses=k_losses, plain_losses=p_losses,
            loss_max_rel_diff=loss_rel, grad_max_err_over_leaf_peak=worst,
            worst_leaf=worst_name, k_proj_bias_over_global_peak=symmetric, **extra)
        readings.append((loss_rel, worst, worst_name, symmetric, versus_rel))
    for seed, (loss_rel, worst, worst_name, symmetric, versus_rel) in zip(PARITY_SEEDS,
                                                                           readings):
        if not (loss_rel <= 1e-4 and worst <= 1e-3 and symmetric < 1e-5 and versus_rel <= 1e-4):
            raise AssertionError(f"{preset} {attn_impl} f32 train parity, seed {seed}: losses "
                                 f"{loss_rel}, grads {worst} ({worst_name}), k_proj.bias "
                                 f"{symmetric}, versus {versus} {versus_rel}")


def bf16_train_parity(torch, port, data) -> None:
    """Three bf16 flagship train steps with the kernels (the forward through
    its wgmma design), then with the plain versions in their place, from
    the same weights, batches and masking (seed 2): losses within
    BF16_LOSS_REL relative at every step."""
    counters = path_counters(port)
    batches = [b for _, b in zip(range(3), data.train_dataloader())]
    runs = []
    for plain in (False, True):
        model, state, (train_step, _, _) = train_setup(torch, port, torch.bfloat16, plain, 2)
        before = [c.launches for c in counters]
        losses = []
        for batch in batches:
            state, metrics = train_step(state, batch)
            losses.append(float(metrics["loss"]))
        got = [c.launches - b for c, b in zip(counters, before)]
        expect = [0] * len(counters) if plain else [3 * n for n in per_step_launches(False)]
        if got != expect:
            raise AssertionError(f"bf16 parity plain={plain}: launches {got} != {expect}")
        runs.append(losses)
        del model, state
    rel = max(abs(a - b) / abs(b) for a, b in zip(*runs))
    log(phase="train_parity", preset="flagship_tpu_mlm", dtype="bfloat16", seed=2,
        kernel_losses=runs[0], plain_losses=runs[1], loss_max_rel_diff=rel)
    if not rel <= BF16_LOSS_REL:
        raise AssertionError(f"bf16 train parity: losses differ by {rel} relative")


def sm_clock_hz() -> float:
    """The SM clock the exponential bound assumes: the card's maximum, as
    nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def roofline_bound(nbytes: float, products: float, exps: float, dtype: str, clock_hz: float):
    """(ms, bound_by, term): the largest of the bytes over the memory rate,
    the products over the dtype's peak and the exponentials over 16 a clock
    per SM on 132 SMs."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S, "products": products / PEAK_OPS[dtype],
             "exponentials": exps / (EXP_PER_CLOCK_PER_SM * SMS * clock_hz)}
    term = max(terms, key=terms.get)
    return terms[term] * 1e3, ("bytes" if term == "bytes" else "operations"), term


def zero_row_tiles(g) -> float:
    """The share of 64-row tiles whose cotangents are all 0: the tiles the
    bf16 CE backward skips (dW/db never loads them, dx writes their zeros)."""
    import torch

    tiles = -(-g.numel() // 64)
    padded = torch.zeros(tiles * 64, dtype=g.dtype, device=g.device)
    padded[:g.numel()] = g.reshape(-1)
    return float((padded.view(tiles, 64) == 0).all(1).float().mean())


def ce_case(torch, ck, softmax_ce_integer, clock_hz: float, name: str, x32, w, b, labels, g):
    """One CE shape, f32 and bf16: the three kernels against their plain
    versions (loss and lse, then dx, dW and db from the plain lse; dx of every
    row whose g is 0 exactly 0; a bf16 call of each must advance its wgmma
    counter), CUDA-event and profiler device times of each kernel, of the
    plain versions and of the unfused head, the share of row tiles the bf16
    backward skips, what making round(W)^T costs and the forward's host time
    a call."""
    r, c = x32.shape
    v = w.shape[1]
    ignored = g == 0
    live = int((~ignored).sum())
    wgmma_counters = (ck.ce_fwd_wgmma_counter, ck.ce_dx_wgmma_counter, ck.ce_dw_wgmma_counter)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[1]
        x = x32.to("cuda", dtype)
        design = ck.ce_backward_design(x, w)
        before = [n.launches for n in wgmma_counters]
        loss, lse = ck.linear_ce_fwd(x, w, b, labels)
        ref_loss, ref_lse = ck.linear_ce_fwd_reference(x, w, b, labels)
        # both designs keep the plain version's rounding points: f32's bar
        fwd_err = check(f"ce loss {name} {dt}", loss, ref_loss, "float32")
        lse_rel = check_stats(f"ce lse {name} {dt}", lse, ref_lse)
        dx = ck.linear_ce_bwd_dx(x, w, b, labels, ref_lse, g)
        dw, db = ck.linear_ce_bwd_dw(x, w, b, labels, ref_lse, g)
        wgmma = [n.launches - m for n, m in zip(wgmma_counters, before)]
        if wgmma != [int(design == "wgmma")] * 3 or (design == "wgmma") != (dt == "bfloat16") \
                or ck.ce_forward_design(x, w) != design:
            raise AssertionError(f"ce {name} {dt}: {design} call, wgmma counters {wgmma}")
        ref_dx, ref_dw, ref_db = ck.linear_ce_bwd_reference(x, w, b, labels, ref_lse, g)
        dx_err = check(f"ce dx {name} {dt}", dx, ref_dx, dt)
        dw_err = max(check(f"ce dW {name} {dt}", dw, ref_dw, dt),
                     check(f"ce db {name} {dt}", db, ref_db, dt))
        if dx[ignored].any():
            raise AssertionError(f"ce {name} {dt}: dx of an ignored row is not 0")
        item = x.element_size()
        # bytes: each input read once, each output written once (x of the
        # rows whose g is 0 need not be read by the backward); operations:
        # the backward's products and exponentials at the rows whose g is
        # not 0, as this run's data needs them
        params = 4 * c * v + 4 * v
        inputs = item * r * c + params + 4 * r  # x, W, b, labels (int32)
        bwd_in = item * live * c + params + 4 * r + 8 * r  # + lse, g
        bounds = {
            "fwd": roofline_bound(inputs + 8 * r, 2 * r * c * v, r * v, dt, clock_hz),
            "dx": roofline_bound(bwd_in + item * r * c, 4 * live * c * v, live * v, dt,
                                 clock_hz),
            "dw": roofline_bound(bwd_in + params, 4 * live * c * v, live * v, dt, clock_hz),
        }
        leaves = [t.detach().requires_grad_(True) for t in (x, w, b)]
        unfused = softmax_ce_integer(leaves[0] @ leaves[1].to(dtype) + leaves[2].to(dtype), labels)
        wt = ck.round_weight_t(w) if design == "wgmma" else None
        run_fwd = lambda: ck.launch_fwd(x, w, b, labels, wt)  # noqa: E731
        run_dx = lambda: ck.launch_bwd_dx(x, w, b, labels, ref_lse, g, wt)  # noqa: E731
        run_dw = lambda: ck.launch_bwd_dw(x, w, b, labels, ref_lse, g, wt)  # noqa: E731
        library_fwd = lambda: softmax_ce_integer(x @ w.to(dtype) + b.to(dtype), labels)  # noqa: E731
        library_bwd = lambda: torch.autograd.grad(unfused, leaves, g,  # noqa: E731
                                                  retain_graph=True)
        extra = {}
        if design == "wgmma":  # round(W)^T, made once per train step
            extra = dict(wt_device_ms=device_ms(torch, lambda: ck.round_weight_t(w)),
                         wt_host_us=host_us(torch, lambda: ck.round_weight_t(w)))
        row = dict(
            kernel="linear_ce", shape=name, dims=[r, c, v], dtype=dt, design=design,
            ignored_rows=int(ignored.sum()),
            tiles_skipped=zero_row_tiles(g) if design == "wgmma" else 0.0,
            fwd_max_abs_err=fwd_err, lse_max_rel_err=lse_rel, dx_max_abs_err=dx_err,
            dw_max_abs_err=dw_err,
            fwd_ms=time_ms(run_fwd), dx_ms=time_ms(run_dx), dw_ms=time_ms(run_dw),
            fwd_host_us=host_us(torch, run_fwd),
            fwd_device_ms=device_ms(torch, run_fwd, "linear_ce_fwd"),
            dx_device_ms=device_ms(torch, run_dx, "linear_ce_bwd_dx"),
            dw_device_ms=device_ms(torch, run_dw, "linear_ce_bwd_dw"),
            plain_fwd_ms=time_ms(lambda: ck.linear_ce_fwd_reference(x, w, b, labels), 3),
            plain_bwd_ms=time_ms(lambda: ck.linear_ce_bwd_reference(x, w, b, labels,
                                                                    ref_lse, g), 3),
            library_fwd_ms=time_ms(library_fwd), library_bwd_ms=time_ms(library_bwd),
            library_fwd_device_ms=device_ms(torch, library_fwd),
            library_bwd_device_ms=device_ms(torch, library_bwd),
            sm_clock_mhz=clock_hz / 1e6, **extra,
            **{f"{k}_bound_{f}": val for k, bnd in bounds.items()
               for f, val in zip(("ms", "by", "term"), bnd)})
        log(**row)
        rows.append(row)
        del x, loss, lse, ref_loss, ref_lse, dx, dw, db, ref_dx, ref_dw, ref_db, leaves, unfused
    return rows


def ce_phase(torch, ck, softmax_ce_integer, clock_hz: float):
    """The three CE kernels against their plain versions at bench.py's head,
    the flagship head and a ragged row count, f32 and bf16, with ~15% of
    rows ignored at random (label 0, cotangent 0), so no 64-row tile is all
    ignored: ``ce_case`` for each of CE_SHAPES."""
    rows = []
    for name, (r, c, v) in CE_SHAPES:
        gen = torch.Generator().manual_seed(r + c + v)
        w = ((torch.rand(c, v, generator=gen) * 2 - 1) * c**-0.5).cuda()
        b = ((torch.rand(v, generator=gen) * 2 - 1) * c**-0.5).cuda()
        valid = torch.rand(r, generator=gen) >= 0.15
        labels = torch.where(valid, torch.randint(0, v, (r,), generator=gen), 0).cuda()
        g = (valid.float() / valid.sum()).cuda()
        x32 = torch.randn(r, c, generator=gen)
        rows += ce_case(torch, ck, softmax_ce_integer, clock_hz, name, x32, w, b, labels, g)
    return rows


def gathered_live_rows(torch, port, data):
    """Live rows per example of the C=64 train step's gathered head on the
    first synthetic IMDB batch that phases 10 and 14 train on: the masked
    positions of ``flagship_mlm``'s masking under the train state's step-0
    generator (seed 2), at most CAPACITY; the gather puts them first."""
    from perceiver_io_torch.ops.masking import IGNORE_LABEL

    masking = port["presets"].flagship_mlm(device="cuda", seed=0).masking
    batch = next(iter(data.train_dataloader()))
    generator = port["TrainState"](model=None, optimizer=None, schedule=None,
                                   seed=2).step_generator("cuda")
    ids = torch.as_tensor(batch["token_ids"]).cuda()
    pad = torch.as_tensor(batch["pad_mask"]).to("cuda", torch.bool)
    _, labels = masking(generator, ids, pad)
    return (labels != IGNORE_LABEL).sum(1).clamp(max=CAPACITY).cpu()


def ce_gathered_phase(torch, ck, port, data, softmax_ce_integer, clock_hz: float):
    """``ce_case`` at (64 x CAPACITY, 64, 10003) in the training path's
    layout: each example's live rows first among its CAPACITY, as many as
    ``gathered_live_rows`` counts, g = 1/live there and 0 elsewhere."""
    counts = gathered_live_rows(torch, port, data)
    b_n, (r, c, v) = len(counts), (len(counts) * CAPACITY, 64, 10003)
    gen = torch.Generator().manual_seed(r + c + v + 1)
    w = ((torch.rand(c, v, generator=gen) * 2 - 1) * c**-0.5).cuda()
    b = ((torch.rand(v, generator=gen) * 2 - 1) * c**-0.5).cuda()
    valid = (torch.arange(CAPACITY)[None, :] < counts[:, None]).reshape(-1)
    labels = torch.where(valid, torch.randint(0, v, (r,), generator=gen), 0).cuda()
    g = (valid.float() / valid.sum().clamp(min=1)).cuda()
    x32 = torch.randn(r, c, generator=gen)
    rows = ce_case(torch, ck, softmax_ce_integer, clock_hz, "gathered", x32, w, b, labels, g)
    for row in rows:
        row.update(examples=b_n, live_rows_per_example=counts.tolist())
    log(phase="ce_gathered", examples=b_n, capacity=CAPACITY, live_rows=int(valid.sum()),
        live_rows_per_example=counts.tolist(), tiles_skipped=zero_row_tiles(g))
    return rows


def packed_phase(torch, ak, pk, clock_hz: float):
    """The packed kernels against their plain versions at PACKED_SHAPES, f32
    and bf16: out, then dq, dk and dv from one cotangent (dq and dk of the
    fully masked example exactly 0); a bf16 call must advance the three
    wgmma counters. CUDA-event and profiler device times of each kernel;
    times of the whole backward, of the plain forward and backward, of
    SDPA's forward and backward on the head-split views with the float bias
    as its mask (events and device), and of kernel #1's forward and whole
    backward at the same shape; the share of key tiles the bf16 design
    skips (``skipped_tiles``); each kernel's bound (``roofline_bound``),
    counting the work the data needs (``live_work``)."""
    import torch.nn.functional as F

    wgmma_counters = (pk.fwd_wgmma_counter, pk.dq_wgmma_counter, pk.dkv_wgmma_counter)
    rows = []
    for name, (b, t, s, h, d), padding in PACKED_SHAPES:
        e = h * d
        gen = torch.Generator().manual_seed(b + t + s + e + 2)
        pad = None
        if padding == "random":
            pad = torch.rand(b, s, generator=gen) < 0.3
        elif padding == "tail":
            pad = torch.arange(s)[None, :] >= torch.randint(1, s + 1, (b, 1), generator=gen)
        if pad is not None:
            pad[-1] = True  # one example with every key masked out
            pad = pad.cuda()
        tiles_skip, rows_skip = skipped_tiles(pad, s)
        bias = ak.pad_bias(pad, b, s, "cuda")
        live, keys = live_work(pad, b, s)
        dead = b - live
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype).split(".")[1]
            q, g = (torch.randn(b, t, e, generator=gen).to("cuda", dtype) for _ in range(2))
            k, v = (torch.randn(b, s, e, generator=gen).to("cuda", dtype) for _ in range(2))
            design = pk.packed_backward_design(q, k, v, g, h)
            before = [c.launches for c in wgmma_counters]
            fwd_err = check(f"packed fwd {name} {dt}", pk.packed_attention_fwd(q, k, v, h, pad),
                            pk.packed_attention_reference(q, k, v, h, pad), dt)
            grads = pk.packed_attention_bwd(q, k, v, h, pad, g)
            wgmma = [c.launches - n for c, n in zip(wgmma_counters, before)]
            if wgmma != [int(design == "wgmma")] * 3:
                raise AssertionError(f"packed {name} {dt}: {design} call, wgmma counters "
                                     f"{wgmma}")
            refs = pk.packed_attention_bwd_reference(q, k, v, bias, g, h)
            errs = {x: check(f"packed bwd {x} {name} {dt}", got, ref, dt)
                    for x, got, ref in zip(("dq", "dk", "dv"), grads, refs)}
            if pad is not None and (grads[0][-1].any() or grads[1][-1].any()):
                raise AssertionError(f"packed {name} {dt}: dq/dk of the fully masked example "
                                     f"not 0")
            del grads, refs
            stats = pk.launch_bwd_dq(q, k, v, bias, g, h)[1]
            io_t, io_s = (q.element_size() * n * e for n in (t, s))  # one example's
            stat_bytes = 12 * b * t * h
            exps = h * t * keys  # one exponential per (head, query, key)
            bounds = {
                "fwd": roofline_bound(live * (2 * io_t + 2 * io_s) + dead * (io_t + io_s)
                                      + 4 * b * s, 4 * t * e * keys, exps, dt, clock_hz),
                "dq": roofline_bound(live * (3 * io_t + 2 * io_s) + dead * io_t + 4 * b * s
                                     + stat_bytes, 6 * t * e * keys, exps, dt, clock_hz),
                "dkv": roofline_bound(live * (2 * io_t + 4 * io_s) + dead * (io_t + 2 * io_s)
                                      + 4 * b * s + stat_bytes, 8 * t * e * keys, exps, dt,
                                      clock_hz),
                "bwd": roofline_bound(live * (3 * io_t + 4 * io_s) + dead * (2 * io_t + 2 * io_s)
                                      + 4 * b * s, 10 * t * e * keys, exps, dt, clock_hz),
            }
            qh, kh, vh, gh = (x.view(x.shape[0], x.shape[1], h, d) for x in (q, k, v, g))
            mask = bias[:, None, None, :].to(dtype)
            qt, kt, vt = (x.transpose(1, 2) for x in (qh, kh, vh))
            out1, m1, l1 = ak.attention_fwd_with_stats(qh, kh, vh, pad)
            library_bwd, library_bwd_device = library_bwd_ms(torch, qh, kh, vh, gh, mask)
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)  # noqa: E731
            run_fwd = lambda: pk.launch_fwd(q, k, v, bias, h)  # noqa: E731
            run_dq = lambda: pk.launch_bwd_dq(q, k, v, bias, g, h)  # noqa: E731
            run_dkv = lambda: pk.launch_bwd_dkv(q, k, v, bias, g, stats, h)  # noqa: E731
            row = dict(
                kernel="packed_attention", shape=name, dims=[b, t, s, h, d], dtype=dt,
                design=design, padding=padding,
                fwd_max_abs_err=fwd_err, **{f"{x}_max_abs_err": err for x, err in errs.items()},
                tiles_skipped=tiles_skip if design == "wgmma" else 0.0,
                dkv_rows_skipped=rows_skip if design == "wgmma" else 0.0,
                fwd_ms=time_ms(run_fwd), dq_ms=time_ms(run_dq), dkv_ms=time_ms(run_dkv),
                fwd_device_ms=device_ms(torch, run_fwd, "packed_fwd"),
                dq_device_ms=device_ms(torch, run_dq, "packed_bwd_dq"),
                dkv_device_ms=device_ms(torch, run_dkv, "packed_bwd_dkv"),
                bwd_ms=time_ms(lambda: pk.packed_attention_bwd(q, k, v, h, pad, g)),
                plain_fwd_ms=time_ms(lambda: pk.packed_attention_reference(q, k, v, h, pad), 3),
                plain_bwd_ms=time_ms(lambda: pk.packed_attention_bwd_reference(q, k, v, bias, g,
                                                                               h), 3),
                library_fwd_ms=time_ms(sdpa), library_fwd_device_ms=device_ms(torch, sdpa),
                library_bwd_ms=library_bwd, library_bwd_device_ms=library_bwd_device,
                attention_fwd_ms=time_ms(lambda: ak.fused_attention(qh, kh, vh, pad)),
                attention_bwd_ms=time_ms(lambda: ak.attention_bwd(qh, kh, vh, pad, out1, m1, l1,
                                                                  gh)),
                sm_clock_mhz=clock_hz / 1e6,
                **{f"{x}_bound_{f}": val for x, bnd in bounds.items()
                   for f, val in zip(("ms", "by", "term"), bnd)})
            log(**row)
            rows.append(row)
            del q, k, v, g, stats, qh, kh, vh, gh, qt, kt, vt, out1, m1, l1
    return rows


def packed_serving_phase(torch, port, tokenizer, texts):
    """``MLMServer`` over ``flagship_mlm(attn_impl='packed')``: the texts in
    bf16, 22 packed forward launches per fused forward and no other
    attention kernel; then in f32 the top-1 fill of every mask against the
    same weights under ``'pallas'``."""
    ak, pk = port["ak"], port["pk"]
    presets, server_cls = port["presets"], port["MLMServer"]
    kwargs = dict(bucket_widths=[128, 256, 512], max_batch=64, device="cuda")
    model = presets.flagship_mlm(dtype=torch.bfloat16, device="cuda", seed=0, attn_impl="packed")
    server = server_cls(model, None, tokenizer, 512, compute_dtype="bfloat16", **kwargs)
    counters = (ak.counter, pk.fwd_counter, pk.fwd_wgmma_counter)
    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fills = server.fill_masks(texts, k=5)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    n_fwd = server.engine.dispatches
    got = tuple(c.launches for c in counters)
    if got != (0, ATTN_PER_FORWARD * n_fwd, ATTN_PER_FORWARD * n_fwd) \
            or any(c.plain_calls for c in counters):
        raise AssertionError(f"packed serving: launches (#1, packed, packed wgmma) {got} over "
                             f"{n_fwd} forwards, or a plain version ran")
    masks = [t.split().count("[MASK]") for t in texts]
    if [len(r) for r in fills] != masks or any(len(f) != 5 for r in fills for f in r):
        raise AssertionError("packed serving: fills of the wrong shape")
    del server, model
    top1 = {}
    for impl in ("packed", "pallas"):
        server = server_cls(presets.flagship_mlm(device="cuda", seed=0, attn_impl=impl), None,
                            tokenizer, 512, **kwargs)
        top1[impl] = [f[0] for r in server.fill_masks(texts, k=1) for f in r]
        del server
    mismatched = sum(a != b for a, b in zip(top1["packed"], top1["pallas"]))
    log(phase="serve_packed", preset="flagship_mlm", mode="bfloat16", texts=len(texts),
        masks=sum(masks), fused_forwards=n_fwd, packed_per_forward=ATTN_PER_FORWARD,
        fill_masks_s=fused_s, f32_top1_masks=len(top1["packed"]),
        f32_top1_mismatches_vs_pallas=mismatched, example=[texts[1][:60], fills[1]])
    if mismatched or len(top1["packed"]) != len(top1["pallas"]):
        raise AssertionError(f"f32 packed serving: {mismatched} top-1 fills differ from pallas")
    return {"packed_attention_fwd": got[1], "packed_attention_fwd_wgmma": got[2]}


def ar_attention_phase(torch, ak):
    """Phase 17: #1 with the causal offset against its plain version at the
    AR path's shapes (AR_ATTN_SHAPES), B=4, f32 (the scalar design) and bf16
    (the wgmma design): every example's keys padded from 300 on, and the
    last example's first offset + 8 keys padded too, so its rows 0..7 see
    only padding (a step shape: that example wholly padded). Each call must
    count one launch, one causal launch (offset given) and one wgmma launch
    (bf16). Times: CUDA events and profiler device time of the kernel, of
    the plain version and of SDPA with the same boolean mask (it gives NaN
    on rows with no live key: timed only); the bound counts the (row, key)
    pairs the data needs (a row's live keys; on a row with none, the keys
    masked exactly once, which it averages)."""
    import torch.nn.functional as F
    from perceiver_io_torch.ops.masking import causal_mask

    log(phase="ar_attention", card=card_line())
    rows = []
    for name, (b, t, s, h, d), off in AR_ATTN_SHAPES:
        pad = (torch.arange(s) >= 300)[None, :].repeat(b, 1)
        if off is None:
            pad[-1] = True
            future = torch.zeros(t, s, dtype=torch.bool)
        else:
            pad[-1, : off + 8] = True
            future = causal_mask(t, s, off)
        live = ~(pad[:, None, :] | future[None])
        once = pad[:, None, :] ^ future[None]
        dead = ~live.any(-1, keepdim=True)
        pairs = int(live.sum()) + int((once & dead).sum())
        pad, live = pad.cuda(), live.cuda()
        g = torch.Generator().manual_seed(b + t + s + d + 17)
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype).split(".")[1]
            q = torch.randn(b, t, h, d, generator=g).to("cuda", dtype)
            k = torch.randn(b, s, h, d, generator=g).to("cuda", dtype)
            v = torch.randn(b, s, h, d, generator=g).to("cuda", dtype)
            design = ak.forward_design(q, k, v)
            counters = (ak.counter, ak.causal_counter, ak.wgmma_counter)
            before = [c.launches for c in counters]
            run = lambda: ak.fused_attention(q, k, v, pad, causal_offset=off)  # noqa: E731
            err = check(f"causal attention {name} {dt}", run(),
                        ak.attention_reference(q, k, v, pad, off), dt)
            got = [c.launches - n for c, n in zip(counters, before)]
            if got != [1, int(off is not None), int(design == "wgmma")]:
                raise AssertionError(f"causal attention {name} {dt}: launches (all, causal, "
                                     f"wgmma) {got}")
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=live[:, None])
            item = q.element_size()
            nbytes = item * (2 * b * t * h * d + 2 * b * s * h * d) + 4 * b * s
            bound, by = bound_ms(nbytes, 4 * h * d * pairs, dt)
            row = dict(kernel="attention_fwd", shape=name, dims=[b, t, s, h, d],
                       causal_offset=off, dtype=dt, design=design, max_abs_err=err,
                       kernel_ms=time_ms(run),
                       plain_ms=time_ms(lambda: ak.attention_reference(q, k, v, pad, off)),
                       library_ms=time_ms(sdpa), bound_ms=bound, bound_by=by,
                       device_ms=device_ms(torch, run, "attention_fwd"),
                       library_device_ms=device_ms(torch, sdpa),
                       host_us_per_call=host_us(torch, run), pairs=pairs)
            log(**row)
            rows.append(row)
    return rows


def ar_prompts(tokenizer, synthetic_reviews):
    """Token-id prompts of AR_PROMPT_LENS tokens, cut from synthetic reviews
    (the longest one's stream crosses the episode boundary at 256)."""
    reviews, _ = synthetic_reviews(200, seed=21)
    ids = [t for review in reviews for t in tokenizer.encode_ids(review)]
    prompts, start = [], 0
    for n in AR_PROMPT_LENS:
        prompts.append(ids[start: start + n])
        start += n
    if [len(p) for p in prompts] != list(AR_PROMPT_LENS):
        raise AssertionError("the synthetic reviews gave too few tokens for the prompts")
    return prompts


def forced_logits(torch, gen, prefix, tokens):
    """Teacher forcing along ``gen.generate``'s episodes: the logits that
    predict each of ``tokens`` after ``prefix``, each step fed the given
    token; (len(tokens), vocab) f32."""
    out, session = [], None
    with torch.inference_mode():
        for i, tok in enumerate(tokens):
            if session is None or session.remaining() < 1:
                session = gen.start(prefix + tokens[:i])
            out.append(session.next_logits[0])
            if i + 1 < len(tokens):
                logits, session.cache = gen.model.step(
                    session.cache, torch.tensor([[tok]], device="cuda"))
                session.next_logits = logits.float()
                session.seq = session.seq + [tok]
    return torch.stack(out)


def ar_generation_phase(torch, ak, qm, port, prompts, mode: str):
    """Phases 18 (``mode='bfloat16'``) and 19 (``'int8w'``): ``ARGenerator``
    over ``flagship_ar`` (weights from seed 0), the prompts greedy,
    AR_NEW_TOKENS each in chunks of AR_CHUNK; the counters, set to 0 just
    before, must read 22 causal #1 launches a prefill and 22 a step, every
    one wgmma, and on the int8 path 131 #9 launches each, every one wgmma;
    the 250-token prompt re-prefills once (width 511). Then the times: the
    decode's host ms a token (its chunks' wall, one sync a chunk), the
    prefill's ms at each width (median of 3, synchronised), and a profiled
    window of 32 steps (device busy ms a token, idle share). Then teacher
    forcing on the same streams through the plain versions (same weights):
    bf16 every step's logits within TOL of the plain ones' peak; top-1
    agreement at least BF16_TOP1_AGREEMENT in both modes."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    quantized = mode == "int8w"
    model = port["presets"].flagship_ar(device="cuda", seed=0)
    gen = port["ARGenerator"](model, None, 512, chunk=AR_CHUNK, compute_dtype=mode,
                              device="cuda")
    gen.warmup()
    counters = (ak.counter, ak.causal_counter, ak.wgmma_counter, qm.counter, qm.wgmma_counter)
    for c in counters:
        c.reset()
    prefills, steps, chunk_ms = gen.prefills, gen.steps, []
    gc.collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = [gen.generate(p, AR_NEW_TOKENS,
                            on_chunk=lambda toks, info: chunk_ms.append(info["chunk_ms"]))[0]
               for p in prompts]
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    prefills, steps = gen.prefills - prefills, gen.steps - steps
    got = [c.launches for c in counters]
    calls = prefills + steps
    deq = AR_DEQUANT_PER_CALL * calls if quantized else 0
    expect = [AR_ATTN_PER_CALL * calls, AR_ATTN_PER_CALL * prefills, AR_ATTN_PER_CALL * calls,
              deq, deq]
    if got != expect or any(c.plain_calls for c in counters):
        raise AssertionError(f"{mode} generation: launches (#1, causal, wgmma, #9, #9 wgmma) "
                             f"{got} != {expect} over {prefills} prefills and {steps} steps, "
                             f"or a plain version ran")
    if [len(x) for x in streams] != [AR_NEW_TOKENS] * len(prompts) \
            or prefills != len(prompts) + 1 or steps != AR_NEW_TOKENS * len(prompts):
        raise AssertionError(f"{mode} generation: streams {[len(x) for x in streams]}, "
                             f"{prefills} prefills, {steps} steps")
    launches = {"attention_fwd": got[0], "attention_fwd_causal": got[1],
                "attention_fwd_wgmma": got[2], "dequant_matmul": got[3],
                "dequant_matmul_wgmma": got[4]}

    prefill_ms = {}
    flat = [t for p in prompts for t in p] * 2
    for width in gen.widths:  # each width's longest prefix: width - 1 tokens
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            gen.start(flat[: width - 1])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        prefill_ms[str(width)] = sorted(times)[1]
    session = gen.start(prompts[1])
    greedy = port["SamplingConfig"]()
    gen.decode_chunk(session, greedy)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t1 = time.perf_counter()
        for _ in range(4):
            gen.decode_chunk(session, greedy)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t1) * 1e3
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)) / 1e3
    attn_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "attention_fwd" in e.key) / 1e3

    plain = port["ARGenerator"](model, None, 512, chunk=AR_CHUNK, compute_dtype=mode,
                                device="cuda")
    use_plain_kernels(plain.model, port)
    agree, worst = [], 0.0
    for prefix, stream in zip(prompts, streams):
        kernel = forced_logits(torch, gen, prefix, stream)
        before = (ak.counter.launches, qm.counter.launches)
        ref = forced_logits(torch, plain, prefix, stream)
        if (ak.counter.launches, qm.counter.launches) != before:
            raise AssertionError(f"{mode}: the plain pass launched a kernel")
        for i in range(len(stream)):
            err = float((kernel[i] - ref[i]).abs().max())
            worst = max(worst, err / float(ref[i].abs().max()))
        agree += (kernel.argmax(-1) == ref.argmax(-1)).tolist()
    top1 = float(np.mean(agree))
    tokens = AR_NEW_TOKENS * len(prompts)
    log(phase="ar_generate", mode=mode, card=card_line(), prompts=[len(p) for p in prompts],
        new_tokens=tokens, prefills=prefills, steps=steps,
        attention_per_call=AR_ATTN_PER_CALL,
        dequant_per_call=AR_DEQUANT_PER_CALL if quantized else 0, generate_s=generate_s,
        decode_host_ms_per_token=sum(chunk_ms) / tokens, prefill_ms=prefill_ms,
        window_steps=4 * AR_CHUNK, window_ms=window_ms,
        device_busy_ms_per_token=busy_ms / (4 * AR_CHUNK),
        attention_device_ms_per_token=attn_ms / (4 * AR_CHUNK),
        device_idle_share=1 - busy_ms / window_ms,
        forced_max_err_over_peak=worst, forced_top1_agreement=top1,
        example=[prompts[3], streams[3]])
    if top1 < BF16_TOP1_AGREEMENT:
        raise AssertionError(f"{mode} generation: top-1 kernels vs plain agree on {top1} "
                             f"< {BF16_TOP1_AGREEMENT}")
    if not quantized and worst > TOL["bfloat16"]:
        raise AssertionError(f"bf16 generation: a forced step's logits differ from the "
                             f"plain versions' by {worst} of their peak > {TOL['bfloat16']}")
    del gen, plain
    return launches


def ar_f32_parity(torch, port, prompts):
    """Phase 18, f32: ``flagship_ar`` in f32 with the kernels (the scalar
    design, TF32 off): AR_F32_STEPS incremental steps after a 120-token
    prefix at width 256, each step's logits against the dense forward of
    the same prefix at the same width, within AR_F32_TOL absolute (the JAX
    package's CPU bar is 2e-5: M=1 and M=256 products may round otherwise
    on the card)."""
    model = port["presets"].flagship_ar(dtype=torch.float32, device="cuda", seed=0)
    prefix = prompts[1]
    w, p = 256, len(prefix)
    ids = torch.zeros((1, w), dtype=torch.long, device="cuda")
    ids[0, :p] = torch.tensor(prefix, device="cuda")
    errs = []
    with torch.inference_mode():
        logits, cache = model.prefill(ids.clone(), torch.arange(w, device="cuda")[None] >= p,
                                      length=p)
        nxt = logits[:, p - 1]
        for t in range(AR_F32_STEPS):
            tok = nxt.argmax(-1, keepdim=True)
            nxt, cache = model.step(cache, tok)
            ids[0, p + t] = tok[0, 0]
            dense = model(ids, torch.arange(w, device="cuda")[None] >= p + t + 1)
            errs.append(float((nxt - dense[:, p + t]).abs().max()))
    log(phase="ar_f32_parity", steps=AR_F32_STEPS, max_abs_err_per_step=errs,
        tolerance=AR_F32_TOL)
    if max(errs) > AR_F32_TOL:
        raise AssertionError(f"f32 AR: incremental vs dense logits differ by {max(errs)}")


def ar_cli_phase(torch, port, tokenizer, root: str) -> None:
    """Phase 18, the entry point: ``cli.serve --task generate --preset
    flagship_ar --init_seed 0 --dtype bfloat16`` in-process on two texts,
    8 tokens each: one JSON line per text."""
    path = os.path.join(root, "tokenizer.json")
    tokenizer.save(path)
    texts = ["a great movie about the war", "the plot was thin but the acting"]
    lines = port["serve"].main(["--task", "generate", "--preset", "flagship_ar",
                                "--init_seed", "0", "--dtype", "bfloat16", "--tokenizer",
                                path, "--max_new_tokens", "8", "--texts", *texts])
    if [line["text"] for line in lines] != texts \
            or any(len(line["continuation_ids"]) != 8 for line in lines):
        raise AssertionError(f"serve --task generate: {lines}")


def ar_attention_bwd_phase(torch, ak):
    """Phase 20: the dq and dk/dv kernels with the causal offset through
    ``FusedAttention`` under autograd, against the plain backward with the
    same offset on the kernel forward's residuals (AR_BWD_SHAPES, f32 and
    bf16). Keys padded from a random length on; the first AR_LEFT_PADDED
    examples' first keys padded too, so their first rows see only padding;
    the last example all padding. dq of those rows and dk of every padded
    key must be exactly 0. Times as phase 3's; the bound counts the (row,
    key) pairs the data needs (a row's live keys; on a row with none, the
    keys masked exactly once, which it averages)."""
    from perceiver_io_torch.ops.masking import causal_mask

    log(phase="ar_attention_bwd", card=card_line())
    rows = []
    for name, (b, t, s, h, d), off in AR_BWD_SHAPES:
        gen = torch.Generator().manual_seed(b + t + s + d + off + 20)
        pad = torch.arange(s)[None, :] >= torch.randint(1, s + 1, (b, 1), generator=gen)
        for i in range(AR_LEFT_PADDED):
            pad[i, : off + 16 * (i + 1)] = True
        pad[-1] = True
        future = causal_mask(t, s, off)
        live = ~(pad[:, None, :] | future[None])
        dead = ~live.any(-1)  # (B, T): rows whose visible keys are all padding
        once = pad[:, None, :] ^ future[None]
        pairs = int(live.sum()) + int((once & dead[..., None]).sum())
        dead_rows = int(dead[:-1].sum())  # beside the wholly padded example's
        pad, dead = pad.cuda(), dead.cuda()
        mask_bias = ak.pad_bias(pad, b, s, "cuda")[:, None, None, :] + ak.causal_bias(
            t, s, off, "cuda")[None, None]
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype).split(".")[1]
            q, g = (torch.randn(b, t, h, d, generator=gen).to("cuda", dtype) for _ in range(2))
            k, v = (torch.randn(b, s, h, d, generator=gen).to("cuda", dtype) for _ in range(2))
            out, m, l = ak.attention_fwd_with_stats(q, k, v, pad, off)
            ref_out, ref_m, ref_l = ak.attention_reference_with_stats(q, k, v, pad, off)
            check(f"causal attention fwd+stats {name} {dt}", out, ref_out, dt)
            stat_err = max(check_stats(f"m {name} {dt}", m, ref_m),
                           check_stats(f"l {name} {dt}", l, ref_l))
            design = ak.backward_design(q, k, v, g)
            counters = (ak.dq_causal_counter, ak.dkv_causal_counter, ak.dq_wgmma_counter,
                        ak.dkv_wgmma_counter)
            before = [c.launches for c in counters]
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
            ak.FusedAttention.apply(*leaves, pad, off).backward(g)
            got = [c.launches - n for c, n in zip(counters, before)]
            wgmma = int(design == "wgmma")
            if got != [1, 1, wgmma, wgmma]:
                raise AssertionError(f"causal attention bwd {name} {dt}: launches (dq causal, "
                                     f"dkv causal, dq wgmma, dkv wgmma) {got}")
            grads = [x.grad for x in leaves]
            refs = ak.attention_bwd_reference(q, k, v, pad, out, m, l, g, off)
            errs = [check(f"causal attention bwd {x} {name} {dt}", got_, ref, dt)
                    for x, got_, ref in zip(("dq", "dk", "dv"), grads, refs)]
            if grads[0][dead].any() or grads[1][pad].any():
                raise AssertionError(f"causal {name} {dt}: dq of a row that sees only padding, "
                                     f"or dk of a padded key, is not 0")
            bias = ak.pad_bias(pad, b, s, "cuda")
            delta = ak.bwd_delta(g, out)
            item = q.element_size()
            stats_bytes = 4 * 3 * b * h * t + 4 * b * s  # m, l, delta, bias
            dq_bound = bound_ms(item * (3 * b * t * h * d + 2 * b * s * h * d) + stats_bytes,
                                3 * 2 * h * d * pairs, dt)
            dkv_bound = bound_ms(item * (2 * b * t * h * d + 4 * b * s * h * d) + stats_bytes,
                                 4 * 2 * h * d * pairs, dt)
            bwd_bound = bound_ms(item * (4 * b * t * h * d + 4 * b * s * h * d)
                                 + 8 * b * h * t + 4 * b * s, 5 * 2 * h * d * pairs, dt)
            library, library_device = library_bwd_ms(torch, q, k, v, g, mask_bias.to(dtype))
            run_dq = lambda: ak.launch_bwd_dq(q, k, v, bias, m, l, delta, g, off)  # noqa: E731
            run_dkv = lambda: ak.launch_bwd_dkv(q, k, v, bias, m, l, delta, g,  # noqa: E731
                                                off)
            row = dict(kernel="attention_bwd_causal", shape=name, dims=[b, t, s, h, d],
                       causal_offset=off, dtype=dt, design=design, max_abs_err=max(errs),
                       stats_max_rel_err=stat_err, pairs=pairs, dead_rows=dead_rows,
                       dq_ms=time_ms(run_dq), dkv_ms=time_ms(run_dkv),
                       dq_device_ms=device_ms(torch, run_dq, "attention_bwd_dq"),
                       dkv_device_ms=device_ms(torch, run_dkv, "attention_bwd_dkv"),
                       kernel_ms=time_ms(lambda: ak.attention_bwd(q, k, v, pad, out, m, l, g,
                                                                  off)),
                       plain_ms=time_ms(lambda: ak.attention_bwd_reference(q, k, v, pad, out, m,
                                                                           l, g, off)),
                       library_ms=library, library_device_ms=library_device,
                       bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
                       dq_bound_ms=dq_bound[0], dq_bound_by=dq_bound[1],
                       dkv_bound_ms=dkv_bound[0], dkv_bound_by=dkv_bound[1],
                       dq_host_us_per_call=host_us(torch, run_dq))
            log(**row)
            rows.append(row)
            del q, k, v, g, out, m, l, ref_out, ref_m, ref_l, leaves, grads, refs
    return rows


def ar_batches(data, texts, drop_last: bool = True):
    """Batches of TRAIN_BATCH rows of SEQ_LEN token ids for the AR path:
    ``texts`` tokenized by the data module's tokenizer and packed end to end
    (the collated synthetic reviews are shorter than the latent window's
    offset of 256, so their windows would hold only padding); every fourth
    row padded from a random length past the window's start, and each
    batch's last row from 200 on (its window all padding, every target
    ignored)."""
    import numpy as np

    stream = [i for ids in data.tokenizer.encode_batch(texts) for i in ids]
    n = len(stream) // SEQ_LEN
    ids = np.asarray(stream[: n * SEQ_LEN], dtype=np.int32).reshape(n, SEQ_LEN)
    lengths = np.full(n, SEQ_LEN)
    lengths[3::4] = np.random.default_rng(0).integers(SEQ_LEN // 2 + 1, SEQ_LEN,
                                                      len(lengths[3::4]))
    lengths[TRAIN_BATCH - 1::TRAIN_BATCH] = 200
    pad = np.arange(SEQ_LEN)[None, :] >= lengths[:, None]
    ids[pad] = data.collator.pad_id
    stop = n - n % TRAIN_BATCH if drop_last else n
    return [{"token_ids": ids[i: i + TRAIN_BATCH], "pad_mask": pad[i: i + TRAIN_BATCH]}
            for i in range(0, stop, TRAIN_BATCH)]


# the counters of the AR training path: KERNEL_NAMES and #1's causal one
AR_NAMES = KERNEL_NAMES + ("attention_fwd_causal",)
AR_PER_STEP = {name: ATTN_PER_FORWARD for name in (
    "attention_fwd", "attention_fwd_wgmma", "attention_fwd_causal", "attention_bwd_dq",
    "attention_bwd_dq_wgmma", "attention_bwd_dq_causal", "attention_bwd_dkv",
    "attention_bwd_dkv_wgmma", "attention_bwd_dkv_causal")}


def ar_counters(port):
    return path_counters(port) + (port["ak"].causal_counter,)


def ar_train_setup(torch, port, dtype, plain: bool = False):
    """``flagship_ar`` (weights from seed 0) with Adam at 1e-3, its train
    state and ``make_ar_steps``; with ``plain`` the plain attention versions
    stand in the kernels' place."""
    model = port["presets"].flagship_ar(dtype=dtype, device="cuda", seed=0)
    if plain:
        for module in model.modules():
            if isinstance(module, port["MultiHeadAttention"]):
                module.attention = port["ak"].plain_attention
    optimizer, schedule = port["make_optimizer"](port["OptimizerConfig"](learning_rate=1e-3),
                                                 model.parameters())
    state = port["TrainState"].create(model, optimizer, schedule, seed=2)
    return model, state, port["make_ar_steps"](model, schedule)


def ar_training_phase(torch, port, train, val, logdir):
    """Phase 21: Trainer.fit over TRAIN_STEPS bf16 ``flagship_ar`` steps on
    the packed batches ``train`` (validation once, at the end, on ``val``),
    each step checked for its launches (AR_PER_STEP, no other kernel, no
    plain version) and a finite loss; then the 10-step window and the
    profiled 3-step one."""
    counters, names = ar_counters(port), AR_NAMES
    per_step = [AR_PER_STEP.get(name, 0) for name in names]
    per_eval = [n if "_fwd" in name else 0 for name, n in zip(names, per_step)]
    model, state, (train_step, eval_step, _) = ar_train_setup(torch, port, torch.bfloat16)
    losses, step_ms = [], []

    def checked_step(state, batch):
        before = [c.launches for c in counters]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = train_step(state, batch)
        end.record()
        torch.cuda.synchronize()
        got = [c.launches - b for c, b in zip(counters, before)]
        if got != per_step or any(c.plain_calls for c in counters):
            raise AssertionError(f"AR train step {state.step}: launches "
                                 f"{dict(zip(names, got))}, or a plain version ran")
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"AR train step {state.step}: loss {loss}")
        losses.append(loss)
        step_ms.append(start.elapsed_time(end))
        return state, metrics

    config = port["TrainerConfig"](max_steps=TRAIN_STEPS, log_every_n_steps=10,
                                   eval_every_n_steps=TRAIN_STEPS, logdir=logdir,
                                   use_tensorboard=False)
    trainer = port["Trainer"](checked_step, eval_step, state, config, tokens_per_example=SEQ_LEN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    trainer.fit(train, val)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {name: c.launches for name, c in zip(names, counters)}
    expect = {name: s * TRAIN_STEPS + e * len(val)
              for name, s, e in zip(names, per_step, per_eval)}
    if launches != expect:
        raise AssertionError(f"AR fit launches {launches} != {expect}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    with open(f"{trainer.run_dir}/metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    val_loss = [r["val_loss"] for r in rows if "val_loss" in r]
    tail = sum(losses[-5:]) / 5
    if not tail < losses[0] or len(val_loss) != 1 or not math.isfinite(val_loss[0]):
        raise AssertionError(f"AR: loss did not fall: first {losses[0]}, last five {tail}, "
                             f"val {val_loss}")
    state = trainer.state

    def window_fit(n_steps: int, name: str) -> float:
        """Trainer.fit over n more steps, no per-step check or sync; its
        logged tokens/s."""
        nonlocal state
        before = [c.launches for c in counters]
        with window_trainer(port, train_step, eval_step, state, n_steps,
                            f"{logdir}/{name}") as fit:
            state = fit.fit(train)
        got = [c.launches - b for c, b in zip(counters, before)]
        if got != [n * n_steps for n in per_step] or any(c.plain_calls for c in counters):
            raise AssertionError(f"AR {name}: launches {got} over {n_steps} steps")
        with open(f"{fit.run_dir}/metrics.jsonl") as f:
            row = [json.loads(line) for line in f][-1]
        if not math.isfinite(row["train_loss"]):
            raise AssertionError(f"AR {name}: loss {row['train_loss']}")
        return row["tokens_per_sec"]

    window_rate = window_fit(WINDOW_STEPS, "window")
    profile_pass(torch, lambda: window_fit(PROFILE_STEPS, "profiled"), "train_flagship_ar_bfloat16")
    steady = sorted(step_ms[1:])
    median_ms = steady[len(steady) // 2]
    tokens = TRAIN_BATCH * SEQ_LEN
    pads = [float(b["pad_mask"].mean()) for b in train]
    log(phase="train_ar", preset="flagship_ar", card=card_line(), steps=TRAIN_STEPS,
        batch=TRAIN_BATCH, seq_len=SEQ_LEN, batches=len(train), pad_share=sum(pads) / len(pads),
        first_loss=losses[0], last5_mean_loss=tail, val_loss=val_loss[0], losses=losses,
        tokens_per_s=window_rate, window_steps=WINDOW_STEPS,
        window_step_ms=tokens / window_rate * 1e3, step_ms_first=step_ms[0],
        step_ms_median=median_ms, step_ms_mean=sum(steady) / len(steady),
        step_tokens_per_s=tokens / (median_ms / 1e3), fit_s=fit_s, peak_memory_gib=peak_gib,
        launches=launches, launches_per_step=AR_PER_STEP)
    del model, state, trainer
    return launches


def ar_train_parity_phase(torch, port, train) -> None:
    """Phase 22: three f32 ``flagship_ar`` steps with the kernels, then with
    the plain versions in their place, from the same weights and batches:
    losses within 1e-4 relative, the first step's gradients within 1e-3 of
    each leaf's peak (k_proj.bias, zero in exact arithmetic, below 1e-5 of
    the largest gradient on both sides); then three bf16 steps, losses
    within BF16_LOSS_REL relative."""
    counters = ar_counters(port)
    per_step = [AR_PER_STEP.get(name, 0) for name in AR_NAMES]
    batches = train[:3]
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[1]
        runs = []
        for plain in (False, True):
            model, state, (train_step, _, _) = ar_train_setup(torch, port, dtype, plain)
            before = [c.launches for c in counters]
            losses, grads = [], None
            for batch in batches:
                state, metrics = train_step(state, batch)
                losses.append(float(metrics["loss"]))
                if grads is None and dtype == torch.float32:
                    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
            got = [c.launches - b for c, b in zip(counters, before)]
            expect = [0 if plain or (dtype == torch.float32 and "wgmma" in name) else 3 * n
                      for name, n in zip(AR_NAMES, per_step)]
            if got != expect:
                raise AssertionError(f"AR {dt} parity plain={plain}: launches {got} != {expect}")
            runs.append((losses, grads))
            del model, state
        (k_losses, k_grads), (p_losses, p_grads) = runs
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(k_losses, p_losses))
        worst, worst_name, symmetric = 0.0, None, 0.0
        if dtype == torch.float32:
            peak_all = max(float(g.abs().max()) for g in p_grads.values())
            for name, ref in p_grads.items():
                got = k_grads[name]
                if name.endswith("k_proj.bias"):
                    symmetric = max(symmetric, float(got.abs().max()) / peak_all,
                                    float(ref.abs().max()) / peak_all)
                    continue
                peak = float(ref.abs().max())
                err = float((got - ref).abs().max())
                err = err / peak if peak else err
                if err > worst:
                    worst, worst_name = err, name
        log(phase="train_parity", preset="flagship_ar", dtype=dt, kernel_losses=k_losses,
            plain_losses=p_losses, loss_max_rel_diff=loss_rel, grad_max_err_over_leaf_peak=worst,
            worst_leaf=worst_name, k_proj_bias_over_global_peak=symmetric)
        bar = 1e-4 if dtype == torch.float32 else BF16_LOSS_REL
        if not (loss_rel <= bar and worst <= 1e-3 and symmetric < 1e-5):
            raise AssertionError(f"AR {dt} train parity: losses {loss_rel}, grads {worst} "
                                 f"({worst_name}), k_proj.bias {symmetric}")


def ar_train_cli_phase(torch, port, root: str, vocab: int) -> None:
    """Phase 23: ``train_ar --preset flagship_tpu --synthetic --max_steps 5
    --attn_impl pallas`` in-process: finite losses in ``metrics.jsonl``,
    every #1-#3 launch causal and wgmma, no plain version, the vocab head at
    the tokenizer's size."""
    ak, common = port["ak"], port["train_ar"].common
    counters = ar_counters(port)
    for c in counters:
        c.reset()
    build_ar, built = common.build_ar, []

    def spy(args, vocab_size, *rest, **kwargs):
        built.append(vocab_size)
        return build_ar(args, vocab_size, *rest, **kwargs)

    common.build_ar = spy
    t0 = time.perf_counter()
    try:
        run_dir = port["train_ar"].main([
            "--preset", "flagship_tpu", "--synthetic", "--max_steps", str(CLI_STEPS),
            "--attn_impl", "pallas", "--log_every_n_steps", "1", "--root", root,
            "--sample_prefix_len", "0", "--logdir", f"{root}/cli_ar"])
    finally:
        common.build_ar = build_ar
    torch.cuda.synchronize()
    with open(f"{run_dir}/metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    launches = dict(zip(AR_NAMES, (c.launches for c in counters)))
    train = [r for r in rows if "train_loss" in r]
    causal = (ak.counter.launches == ak.causal_counter.launches == ak.wgmma_counter.launches
              and ak.dq_counter.launches == ak.dq_causal_counter.launches
              == ak.dq_wgmma_counter.launches == ATTN_PER_FORWARD * CLI_STEPS
              and ak.dkv_counter.launches == ak.dkv_causal_counter.launches
              == ak.dkv_wgmma_counter.launches == ATTN_PER_FORWARD * CLI_STEPS)
    if not causal or any(c.plain_calls for c in counters) or built != [vocab] \
            or [r["step"] for r in train] != list(range(1, CLI_STEPS + 1)) \
            or not all(math.isfinite(r["train_loss"]) for r in train):
        raise AssertionError(f"train_ar --preset flagship_tpu: launches {launches}, vocab "
                             f"{built} (tokenizer {vocab}), rows {rows}")
    log(phase="cli_ar", preset="flagship_tpu", steps=CLI_STEPS, vocab=built[0],
        launches=launches, train_losses=[r["train_loss"] for r in train],
        tokens_per_s=train[-1]["tokens_per_sec"],
        val_loss=[r["val_loss"] for r in rows if "val_loss" in r], wall_s=time.perf_counter() - t0)


# phase 24: tools/attn_shapes_bench.py's shapes, (name, (B, T, S, H, D),
# causal offset or None); the decode family's step rows are forward only
SWEEP_ITERS = 5  # profiled calls a reading
SWEEP_SHAPES = (("mlm-cross", (8, 256, 512, 4, 16), None),
                ("mlm-self", (8, 256, 256, 4, 16), None),
                ("in-cross", (2, 512, 50176, 1, 1024), None),
                ("in-8h", (2, 512, 50176, 8, 128), None),
                ("flow-cross", (1, 2048, 182528, 1, 512), None),
                ("flow-self", (2, 2048, 2048, 8, 64), None),
                ("flow-dec-cross", (2, 182528, 2048, 1, 512), None),
                # train_flow's crosses at its batch of 8, and the decoder's
                # at batch 1 (16 key tiles: the rule's key floor); D=256
                ("flow-cross-b8", (8, 2048, 182528, 1, 512), None),
                ("flow-dec-cross-b8", (8, 182528, 2048, 1, 512), None),
                ("flow-dec-cross-b1", (1, 182528, 2048, 1, 512), None),
                ("d256-cross", (2, 1024, 16384, 2, 256), None),
                ("d256-self-b8", (8, 1024, 1024, 4, 256), None),
                ("in-self-b16", (16, 512, 512, 8, 128), None),
                ("mlm-32k", (2, 256, 32768, 4, 16), None),
                ("mlm-131k", (1, 256, 131072, 4, 16), None),
                # the port's own training shapes: the C=64 (reference) and
                # C=512 (flagship) encoder cross and self at batch 64
                ("c64-cross-b64", (64, 256, 512, 4, 16), None),
                ("c64-self-b64", (64, 256, 256, 4, 16), None),
                ("c512-cross-b64", (64, 256, 512, 4, 128), None),
                ("c512-self-b64", (64, 256, 256, 4, 128), None),
                # the reference preset (64 latents, C=64) at batch 64: encoder
                # cross, self, the decoder gathered at capacity 160
                ("ref-cross-b64", (64, 64, 512, 4, 16), None),
                ("ref-self-b64", (64, 64, 64, 4, 16), None),
                ("ref-dec-b64", (64, 160, 64, 4, 16), None),
                # where the rule's floors sit: a serving decoder, few blocks,
                # small areas, D=8
                ("serve-dec-c512", (64, 8, 256, 4, 128), None),
                ("mlm-cross-b2", (2, 256, 512, 4, 16), None),
                ("mlm-cross-b1", (1, 256, 512, 4, 16), None),
                ("tiny-self-b8", (8, 64, 64, 4, 16), None),
                ("d8-self", (8, 256, 256, 4, 8), None),
                ("ar-prefill-cross", (8, 256, 512, 4, 128), 256),
                ("ar-prefill-self", (8, 256, 256, 4, 128), 0),
                ("ar-prefill-32k", (1, 256, 32768, 4, 128), 32512),
                ("ar-step-cross", (8, 1, 512, 4, 128), 511),
                ("ar-step-cross-32k", (1, 1, 32768, 4, 128), 32767),
                ("ar-step-latent", (8, 1, 256, 4, 128), 255))


def einsum_vs_kernels_f32(torch, ak, pat) -> list:
    """Phase 24, first part: the einsum path (``'xla'``) against kernels #1-#3
    in f32 (TF32 off), forward and the three gradients under one cotangent,
    at the flagship encoder cross (~30% of keys padded at random, no example
    all padding) and the AR training cross (offset 256, keys padded from a
    random length past 256): every row has a live key, where the two paths
    compute one function (a row with none differs by design, ROADMAP Queue 3
    trap 1). Within 1e-4 of each reference's peak."""
    from perceiver_io_torch.ops.masking import causal_mask

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("allow_tf32 is on: the f32 einsum needs full f32 products")
    rows = []
    for name, (b, t, s, h, d), off in (("enc_cross", (64, 256, 512, 4, 128), None),
                                       ("ar_cross", (64, 256, 512, 4, 128), 256)):
        gen = torch.Generator().manual_seed(b + t + s + d + 24)
        if off is None:
            pad = torch.rand(b, s, generator=gen) < 0.3
            pad[:, 0] = False
        else:
            pad = torch.arange(s)[None, :] >= torch.randint(off + 1, s + 1, (b, 1),
                                                            generator=gen)
        pad = pad.cuda()
        q, g = (torch.randn(b, t, h, d, generator=gen).cuda() for _ in range(2))
        k, v = (torch.randn(b, s, h, d, generator=gen).cuda() for _ in range(2))
        outs = []
        for fn in (ak.fused_attention, None):
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            if fn is None:
                cmask = None if off is None else causal_mask(t, s, off, "cuda")
                out = pat.dot_product_attention(*leaves, pad, cmask)
            else:
                out = fn(*leaves, pad, causal_offset=off)
            out.backward(g)
            outs.append([out.detach()] + [x.grad for x in leaves])
        errs = [check(f"xla vs kernels {name} {part}", e, kern, "float32")
                for part, kern, e in zip(("out", "dq", "dk", "dv"), *outs)]
        row = dict(phase="xla_vs_kernels_f32", shape=name, dims=[b, t, s, h, d],
                   causal_offset=off, max_abs_err=dict(zip(("out", "dq", "dk", "dv"), errs)))
        log(**row)
        rows.append(row)
    return rows


def auto_sweep_phase(torch, ak, pat) -> list:
    """Phase 24, the sweep: bf16 device ms (torch.profiler, every kernel of
    the call) of the einsum path and of kernels #1-#3 (the forward with its
    statistics, the delta reduction, dq and dk/dv), forward alone and
    forward + backward, at SWEEP_SHAPES; causal rows take the causal offset
    (the einsum its causal mask). A head depth the kernel refuses is marked
    refused; a shape that does not fit in the card's memory is skipped,
    saying so. Prints the table and the thresholds in force, and asserts
    that the rule routes no refused shape to the kernel."""
    from perceiver_io_torch.ops.masking import causal_mask

    rows = []
    for name, (b, t, s, h, d), off in SWEEP_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(b + t + s + h + d)
        row = dict(phase="auto_sweep", shape=name, dims=[b, t, s, h, d], causal_offset=off,
                   route=("xla (causal)" if off is not None
                          else pat.auto_attention_impl(b, t, s, h, d)))
        refused = d not in ak.SUPPORTED_HEAD_DIMS
        if refused and row["route"] == "pallas":
            raise AssertionError(f"auto routes {name} (D={d}) to a kernel that refuses it")
        backward = t > 1  # a decode step (T = 1) serves: forward only
        try:
            q = torch.randn(b, t, h, d, generator=gen, device="cuda").bfloat16()
            k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
                    for _ in range(2))
            g = torch.randn(b, t, h, d, generator=gen, device="cuda").bfloat16()
            leaves = [x.requires_grad_(True) for x in (q, k, v)]
            cmask = None if off is None else causal_mask(t, s, off, "cuda")

            def xla():
                return pat.dot_product_attention(*leaves, None, cmask)

            def kern():
                return ak.fused_attention(*leaves, None, causal_offset=off)

            for impl, fn in (("xla", xla), ("pallas", None if refused else kern)):
                if fn is None:
                    row[f"{impl}_fwd_ms"] = row[f"{impl}_ms"] = "refused"
                    continue
                with torch.no_grad():
                    row[f"{impl}_fwd_ms"] = device_ms(torch, fn, iters=SWEEP_ITERS)
                row[f"{impl}_ms"] = (device_ms(torch, lambda: torch.autograd.grad(
                    fn(), leaves, g), iters=SWEEP_ITERS) if backward else None)
                torch.cuda.empty_cache()
        except torch.cuda.OutOfMemoryError:
            row["skipped"] = "does not fit in the card's memory"
            gc.collect()
            torch.cuda.empty_cache()
        key = "pallas_ms" if backward else "pallas_fwd_ms"
        if isinstance(row.get(key), float) and isinstance(row.get(key.replace("pallas", "xla")),
                                                           float):
            row["faster"] = ("pallas" if row[key] < row[key.replace("pallas", "xla")]
                             else "xla")
        log(**row)
        rows.append(row)
    log(phase="auto_thresholds", card=card_line(), min_kv=pat.AUTO_PALLAS_MIN_KV,
        min_logits=pat.AUTO_PALLAS_MIN_LOGITS, deep_min_logits=pat.AUTO_DEEP_MIN_LOGITS,
        area_min_head_dim=pat.AUTO_PALLAS_AREA_MIN_HEAD_DIM,
        head_dims=list(ak.SUPPORTED_HEAD_DIMS))
    return rows


# phases 25-27: the CLIs with the JAX CLI's defaults
XLA_CLI_STEPS, CLI_PROFILE_STEPS, CLI_WARM_STEPS = 12, 4, 2
ATTN_COUNTERS = ("attention_fwd", "attention_bwd_dq", "attention_bwd_dkv")


def cli_windows(torch, port, trainer, loader, logdir: str, label: str,
                per: str = "tokens") -> dict:
    """``trainer``'s steps driven as its CLI drives them, on ``loader``:
    CLI_WARM_STEPS steps, a WINDOW_STEPS window (its rate ``per`` second,
    tokens or examples: all of them over the window's host time) and a
    profiled CLI_PROFILE_STEPS window (device busy ms a step, the idle
    share)."""
    state = trainer.state

    def fit(n: int, name: str) -> float:
        nonlocal state
        with window_trainer(port, trainer.train_step, trainer.eval_step, state, n,
                            f"{logdir}/{name}") as run:
            state = run.fit(loader)
        with open(f"{run.run_dir}/metrics.jsonl") as f:
            row = [json.loads(line) for line in f][-1]
        if not math.isfinite(row["train_loss"]):
            raise AssertionError(f"{label} {name}: loss {row['train_loss']}")
        return row[f"{per}_per_sec"]

    fit(CLI_WARM_STEPS, "warm")
    rate = fit(WINDOW_STEPS, "window")
    prof = profile_pass(torch, lambda: fit(CLI_PROFILE_STEPS, "profiled"), label)
    trainer.state = state
    return {f"{per}_per_s": rate,
            "device_ms_per_step": prof["device_busy_ms"] / CLI_PROFILE_STEPS,
            "idle_share": prof["device_idle_share"]}


def check_launches(trainer, counters, want, label: str) -> None:
    """Wrap the trainer's train and eval steps: each must launch ``want(batch,
    training)`` (a KERNEL_NAMES dict) and no plain version."""
    def wrap(step, training: bool):
        def run(state, batch, *rest, **kwargs):
            before = [c.launches for c in counters]
            out = step(state, batch, *rest, **kwargs)
            got = dict(zip(KERNEL_NAMES, (c.launches - n for c, n in zip(counters, before))))
            if got != want(batch, training) or any(c.plain_calls for c in counters):
                raise AssertionError(f"{label} {'train step' if training else 'eval batch'}: "
                                     f"launches {got} != {want(batch, training)}, or a plain "
                                     f"version ran")
            return out
        return run

    trainer.train_step = wrap(trainer.train_step, True)
    trainer.eval_step = wrap(trainer.eval_step, False)


def read_rows(run_dir: str) -> list:
    with open(f"{run_dir}/metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def check_train_rows(rows: list, steps: int, label: str) -> list:
    """The rows of the JAX trainer: each step's ``train_loss``, ``lr``,
    ``step_s`` and ``tokens_per_sec``, finite, and ``val_loss`` rows; the
    train losses, which must fall (the mean of the last three below the
    first)."""
    train = [r for r in rows if "train_loss" in r]
    val = [r for r in rows if "val_loss" in r]
    keys_ok = all({"train_loss", "lr", "step_s", "tokens_per_sec"} <= set(r) for r in train)
    losses = [r["train_loss"] for r in train]
    if [r["step"] for r in train] != list(range(1, steps + 1)) or not keys_ok or not val \
            or not all(math.isfinite(x) for x in losses + [r["val_loss"] for r in val]) \
            or not sum(losses[-3:]) / 3 < losses[0]:
        raise AssertionError(f"{label}: rows {rows}")
    return losses


def mlm_flagship_cli_phase(torch, port, root: str) -> dict:
    """Phase 25: ``train_mlm --preset flagship_tpu --synthetic`` with the JAX
    CLI's defaults (``--attn_impl xla`` by the preset) and ``--dropout 0.1
    --optimizer AdamW --accumulate_steps 2 --one_cycle_lr
    --one_cycle_pct_start 0.3``, batch 64 x 512, XLA_CLI_STEPS steps,
    in-process: the rows of the JAX trainer, the loss falling, no launch of
    #1-#3 (every call on the einsum path: 22 a train step and 22 an eval
    batch), the peak memory. Then tokens/s, device ms a step and the idle
    share of three arms, each a fresh run of the CLI, one after another
    (A B C): A these flags, B ``--attn_impl pallas --dropout 0``, C ``--dropout
    0`` alone (the einsum path without dropout)."""
    pat, counters = port["pat"], path_counters(port)
    base = ["--preset", "flagship_tpu", "--synthetic", "--optimizer", "AdamW",
            "--accumulate_steps", "2", "--one_cycle_lr", "--one_cycle_pct_start", "0.3",
            "--log_every_n_steps", "1", "--no_tensorboard", "--root", root]
    arms = {"xla_dropout": ["--dropout", "0.1"], "pallas": ["--attn_impl", "pallas"],
            "xla": []}
    for c in counters:
        c.reset()
    pat.xla_counter.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, data = port["train_mlm"].prepare(
        base + arms["xla_dropout"] + ["--max_steps", str(XLA_CLI_STEPS),
                                      "--logdir", f"{root}/cli_xla"])
    if {m.attn_impl for m in trainer.state.model.modules()
            if isinstance(m, port["MultiHeadAttention"])} != {"xla"}:
        raise AssertionError("--preset flagship_tpu did not resolve to attn_impl 'xla'")
    trainer.fit(data.train_dataloader(), data.val_dataloader())
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    rows = read_rows(trainer.run_dir)
    losses = check_train_rows(rows, XLA_CLI_STEPS, "train_mlm --preset flagship_tpu")
    n_val = sum("val_loss" in r for r in rows)
    n_eval = n_val * len(data.val_dataloader())
    launches = {name: c.launches for name, c in zip(KERNEL_NAMES, counters)}
    # each validation also runs the predict hook: one forward
    if any(launches[n] for n in ATTN_COUNTERS) or any(c.plain_calls for c in counters) \
            or pat.xla_counter.calls != ATTN_PER_FORWARD * (XLA_CLI_STEPS + n_eval + n_val):
        raise AssertionError(f"train_mlm --preset flagship_tpu: launches {launches}, einsum "
                             f"calls {pat.xla_counter.calls} over {XLA_CLI_STEPS} steps and "
                             f"{n_eval} eval batches")
    log(phase="cli_flagship_xla", steps=XLA_CLI_STEPS, losses=losses,
        val_loss=[r["val_loss"] for r in rows if "val_loss" in r],
        lr=[r["lr"] for r in rows if "lr" in r], einsum_calls=pat.xla_counter.calls,
        launches=launches, peak_memory_gib=peak_gib, wall_s=wall_s,
        checked_fit_tokens_per_s=[r["tokens_per_sec"] for r in rows if "tokens_per_sec" in r])
    del trainer
    turns = {arm: [] for arm in arms}
    for arm in arms:
        trainer, data = port["train_mlm"].prepare(
            base + arms[arm] + ["--max_steps", "1000", "--logdir", f"{root}/turns_{arm}"])
        turns[arm].append(cli_windows(torch, port, trainer, data.train_dataloader(),
                                      f"{root}/turns_{arm}", f"cli_flagship_{arm}"))
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    log(phase="cli_flagship_turns", card=card_line(), arms=arms, turns=turns)
    return launches


def mlm_routes(b: int, latents: int, seq: int, capacity: int, c: int, heads: int,
               layers: int, per_block: int, pat) -> dict:
    """How many of one MLM forward's attention calls the H100 ``auto`` rule
    sends to kernel #1: in the encoder (cross and self) and the decoder."""
    d = c // heads
    kernel = lambda t, s: pat.auto_attention_impl(b, t, s, heads, d) == "pallas"  # noqa: E731
    encoder = layers * (kernel(latents, seq) + per_block * kernel(latents, latents))
    return dict(encoder=encoder, decoder=int(kernel(capacity, latents)))


def reference_cli_phase(torch, port, root: str) -> dict:
    """Phase 26: ``train_mlm --preset reference --synthetic`` with its
    defaults (``--attn_impl auto``, ``--fused_head auto``: the CE kernels on
    the card), CLI_STEPS steps and validation every 2, in-process, twice:
    with ``--remat --optimizer RAdam``, then with ``--attn_impl pallas
    --dropout 0.1``. Every train step and eval batch is checked for its
    launches: #6-#8 one each a step (#6 one an eval batch); #1-#3 as the
    rule routes the preset's shapes at the batch's size, #1 once more for
    each kernel call in the encoder under remat (its recompute); under
    dropout no #1-#3 in a train step and #1 22 times an eval batch. Then
    each of the eight ``--optimizer`` names for 2 steps (SGD with
    ``--momentum 0.9``, Adamax with ``--no_reuse_kv``, Adagrad with
    ``--accumulate_steps 2``), checked the same way."""
    pat, counters = port["pat"], path_counters(port)
    names = KERNEL_NAMES
    launches = dict.fromkeys(names, 0)
    readings = {}
    runs = [("remat_radam", ["--remat", "--optimizer", "RAdam"], CLI_STEPS),
            ("pallas_dropout", ["--attn_impl", "pallas", "--dropout", "0.1"], CLI_STEPS)]
    options = {"SGD": ["--momentum", "0.9"], "Adamax": ["--no_reuse_kv"],
               "Adagrad": ["--accumulate_steps", "2"]}
    runs += [(opt, ["--optimizer", opt] + options.get(opt, []), 2)
             for opt in port["SUPPORTED_OPTIMIZERS"]]
    for name, extra, steps in runs:
        for c in counters:
            c.reset()
        trainer, data = port["train_mlm"].prepare(
            ["--preset", "reference", "--synthetic", "--max_steps", str(steps),
             "--eval_every_n_steps", "2", "--log_every_n_steps", "1", "--no_tensorboard",
             "--root", root, "--logdir", f"{root}/cli_ref_{name}"] + extra)
        remat = "--remat" in extra
        dropout = "--dropout" in extra

        def expect(batch, training: bool) -> dict:
            b = len(batch["token_ids"])
            if "--attn_impl" in extra:
                routes = dict(encoder=ATTN_PER_FORWARD - 1, decoder=1)
            else:
                routes = mlm_routes(b, 64, SEQ_LEN, CAPACITY, 64, 4, 3, 6, pat)
            fwd = routes["encoder"] + routes["decoder"]
            bwd = fwd if training else 0
            if training and dropout:
                fwd = bwd = 0
            if training and remat:
                fwd += routes["encoder"]
            ce = (1, 1, 1) if training else (1, 0, 0)
            return dict(zip(names, [fwd, bwd, bwd, *ce, 0, 0, 0, fwd, bwd, bwd, 0, 0, 0,
                                    ce[1], ce[2], ce[0], 0, 0]))

        check_launches(trainer, counters, expect, f"train_mlm --preset reference {extra}")
        t0 = time.perf_counter()
        trainer.fit(data.train_dataloader(), data.val_dataloader())
        torch.cuda.synchronize()
        rows = read_rows(trainer.run_dir)
        train = [r for r in rows if "train_loss" in r]
        val_steps = sorted(set(range(2, steps + 1, 2)) | {steps})
        if [r["step"] for r in rows if "val_loss" in r] != val_steps \
                or [r["step"] for r in train] != list(range(1, steps + 1)) \
                or not all(math.isfinite(r["train_loss"]) for r in train):
            raise AssertionError(f"train_mlm --preset reference {extra}: rows {rows}")
        got = {n: c.launches for n, c in zip(names, counters)}
        readings[name] = dict(launches=got, per_step=expect(next(iter(
            data.train_dataloader())), True), train_losses=[r["train_loss"] for r in train],
            tokens_per_s=train[-1]["tokens_per_sec"], wall_s=time.perf_counter() - t0)
        for n in names:
            launches[n] += got[n]
        del trainer
    log(phase="cli_reference_defaults", **readings)
    return launches


def ar_cli_defaults_phase(torch, port, root: str, ar_train, ar_val) -> None:
    """Phase 27: ``train_ar --preset flagship_tpu --synthetic --dropout 0.1``
    at ``flagship_ar`` width with the JAX CLI's defaults (``auto``: every
    causal call on the einsum path), the CLI's trainer fitted on phase 21's
    packed reviews for XLA_CLI_STEPS steps: the loss finite and falling, no
    launch of #1-#3, 22 einsum calls a train step and an eval batch; its
    tokens/s, and the windows' device ms a step and idle share."""
    pat, counters = port["pat"], ar_counters(port)
    for c in counters:
        c.reset()
    pat.xla_counter.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer, _ = port["train_ar"].prepare(
        ["--preset", "flagship_tpu", "--synthetic", "--dropout", "0.1",
         "--max_steps", str(XLA_CLI_STEPS), "--log_every_n_steps", "1", "--no_tensorboard",
         "--root", root, "--sample_prefix_len", "0", "--logdir", f"{root}/cli_ar_defaults"])
    t0 = time.perf_counter()
    trainer.fit(ar_train, ar_val)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    rows = read_rows(trainer.run_dir)
    losses = check_train_rows(rows, XLA_CLI_STEPS, "train_ar --preset flagship_tpu")
    n_eval = sum("val_loss" in r for r in rows) * len(ar_val)
    launches = dict(zip(AR_NAMES, (c.launches for c in counters)))
    einsum_calls = pat.xla_counter.calls
    if any(launches.values()) or any(c.plain_calls for c in counters) \
            or einsum_calls != ATTN_PER_FORWARD * (XLA_CLI_STEPS + n_eval):
        raise AssertionError(f"train_ar --preset flagship_tpu: launches {launches}, einsum "
                             f"calls {einsum_calls}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    windows = cli_windows(torch, port, trainer, ar_train, f"{root}/cli_ar_windows",
                          "cli_ar_defaults")
    log(phase="cli_ar_defaults", steps=XLA_CLI_STEPS, losses=losses,
        val_loss=[r["val_loss"] for r in rows if "val_loss" in r], einsum_calls=einsum_calls,
        peak_memory_gib=peak_gib, wall_s=wall_s, **windows)
    del trainer


def xla_parity_phase(torch, port, data) -> None:
    """Phase 28: three f32 ``flagship_tpu_mlm`` train steps through
    ``'xla'`` and through ``'pallas'`` (kernels #1-#3), same weights, batches
    and masking, no dropout: losses within 1e-4 relative at every step (the
    training batches give every row a live key, where the two compute one
    function). Then ``remat`` against none, dropout 0.1 on, same keys: the
    losses and the first step's gradients within 1e-5 of each leaf's peak
    (``k_proj.bias``, zero in exact arithmetic, under 1e-5 of the largest
    gradient on both sides)."""
    pat, counters = port["pat"], path_counters(port)
    batches = [b for _, b in zip(range(3), data.train_dataloader())]
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("allow_tf32 is on: the f32 einsum needs full f32 products")

    def run(impl: str, **options):
        model, state, (train_step, _, _) = train_setup(torch, port, torch.float32, False, 2,
                                                       "flagship_tpu_mlm", False, impl,
                                                       **options)
        before = [c.launches for c in counters] + [pat.xla_counter.calls]
        losses, grads = [], None
        for batch in batches:
            state, metrics = train_step(state, batch)
            losses.append(float(metrics["loss"]))
            if grads is None:
                grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        after = [c.launches for c in counters] + [pat.xla_counter.calls]
        del model, state
        return losses, grads, [a - b for a, b in zip(after, before)]

    xla, pallas = run("xla"), run("pallas")
    if xla[2][:3] != [0, 0, 0] or xla[2][-1] != 3 * ATTN_PER_FORWARD \
            or pallas[2][:3] != [3 * ATTN_PER_FORWARD] * 3 or pallas[2][-1] != 0:
        raise AssertionError(f"xla / pallas parity: launches {xla[2]} / {pallas[2]}")
    impl_rel = max(abs(a - b) / abs(b) for a, b in zip(xla[0], pallas[0]))
    plain, remat = run("pallas", dropout=0.1), run("pallas", dropout=0.1, remat=True)
    remat_rel = max(abs(a - b) / abs(b) for a, b in zip(remat[0], plain[0]))
    peak_all = max(float(g.abs().max()) for g in plain[1].values())
    worst, worst_name, symmetric = 0.0, None, 0.0
    for name, ref in plain[1].items():
        got = remat[1][name]
        if name.endswith("k_proj.bias"):
            symmetric = max(symmetric, float(got.abs().max()) / peak_all,
                            float(ref.abs().max()) / peak_all)
            continue
        peak = float(ref.abs().max())
        err = float((got - ref).abs().max()) / (peak or 1.0)
        if err > worst:
            worst, worst_name = err, name
    # remat recomputes the encoder's 21 calls, each on the einsum path (dropout)
    log(phase="xla_parity", dtype="float32", xla_losses=xla[0], pallas_losses=pallas[0],
        loss_max_rel_diff=impl_rel, remat_losses=remat[0], no_remat_losses=plain[0],
        remat_loss_max_rel_diff=remat_rel, remat_grad_max_err_over_leaf_peak=worst,
        worst_leaf=worst_name, k_proj_bias_over_global_peak=symmetric,
        einsum_calls_no_remat=plain[2][-1], einsum_calls_remat=remat[2][-1])
    if not (impl_rel <= 1e-4 and remat_rel <= 1e-5 and worst <= 1e-5 and symmetric < 1e-5
            and plain[2][-1] == 3 * ATTN_PER_FORWARD
            and remat[2][-1] == 3 * (2 * ATTN_PER_FORWARD - 1)):
        raise AssertionError(f"f32 parity: xla/pallas losses {impl_rel}, remat losses "
                             f"{remat_rel}, grads {worst} ({worst_name}), k_proj.bias "
                             f"{symmetric}, einsum calls {plain[2][-1]} / {remat[2][-1]}")


def qkv_turns_phase(torch, port) -> None:
    """Phase 28, last: the self-attention's stacked q/k/v product against
    three projections on one bf16 ``flagship_tpu_mlm`` model and state
    (``'pallas'``), device ms a step (torch.profiler over PROFILE_STEPS
    steps of bench.py's batch) in turns: stacked, three, three, stacked;
    the launches of #1-#3 alike in both."""
    model, state, (train_step, _, _) = train_setup(torch, port, torch.bfloat16)
    batch = bench_batch(torch)
    attention = [m for m in model.modules() if isinstance(m, port["MultiHeadAttention"])]
    readings = {"stacked": [], "three": []}
    for arm in ("stacked", "three", "three", "stacked"):
        for m in attention:
            if arm == "three":
                m._project_qkv = lambda x, m=m: (m.q_proj(x),) + m.project_kv(x)
            else:
                m.__dict__.pop("_project_qkv", None)
        state, _ = train_step(state, batch)  # warm-up

        def steps():
            nonlocal state
            for _ in range(PROFILE_STEPS):
                state, metrics = train_step(state, batch)
            if not math.isfinite(float(metrics["loss"])):
                raise AssertionError(f"qkv {arm}: loss {metrics['loss']}")

        prof = profile_pass(torch, steps, f"train_flagship_tpu_mlm_qkv_{arm}")
        readings[arm].append(prof["device_busy_ms"] / PROFILE_STEPS)
    log(phase="qkv_turns", card=card_line(), device_ms_per_step=readings)
    del model, state


# phases 29-32: the training system (checkpoints, resume, preemption,
# serving from a checkpoint, width buckets with the sample hook, recovery)
P29_STEPS, P29_EVAL, P29_LOG = 24, 8, 4
P29_ARGS = ["--preset", "flagship_tpu", "--attn_impl", "pallas", "--synthetic",
            "--max_steps", str(P29_STEPS), "--eval_every_n_steps", str(P29_EVAL),
            "--log_every_n_steps", str(P29_LOG), "--max_to_keep", "2", "--no_tensorboard"]
P29_SIGTERM_ROW = 8          # B gets SIGTERM once its row of this step exists
P29_WAIT_S = 400             # the longest B may take to reach it, and to stop
RESUME_REL_TOL = 1e-5        # the bar where bit equality is out of reach
P31_ARGS = ["--preset", "flagship_tpu", "--synthetic", "--attn_impl", "pallas",
            "--bucket_widths", "128", "256", "512", "--sample_prefix_len", "16",
            "--sample_new_tokens", "12", "--max_steps", "16", "--eval_every_n_steps", "8",
            "--log_every_n_steps", "1", "--no_tensorboard"]
# bucket widths that split this corpus's lengths (all within 128 tokens): its
# first 16 batches, seed 0, come out 10 at 128 and 6 at 64 on the CPU
P31_SPLIT_WIDTHS = ["64", "128", "512"]
P32_STEPS, P32_POISONED, P32_FLAKY = 8, (4, 5), 3  # train_step calls, 1-based
FLAGSHIP_TOKENIZER = "imdb-synthetic-tokenizer-10003.json"


def checked_steps(trainer, counters, want, label: str, record=None) -> None:
    """Wrap ``trainer.train_step``: each step must launch ``want(batch)``
    kernels (``counters`` order) and no plain version; ``record`` collects
    (width, launches) a step."""
    inner = trainer.train_step

    def run(state, batch, **kwargs):
        before = [c.launches for c in counters]
        out = inner(state, batch, **kwargs)
        got = [c.launches - b for c, b in zip(counters, before)]
        if got != want(batch) or any(c.plain_calls for c in counters):
            raise AssertionError(f"{label} train step {state.step}: launches {got} != "
                                 f"{want(batch)}, or a plain version ran")
        if record is not None:
            record.append((int(batch["token_ids"].shape[1]), got))
        return out

    trainer.train_step = run


def train_rows(rows: list) -> dict:
    """{step: (train_loss, lr)} of the train rows."""
    return {r["step"]: (r["train_loss"], r["lr"]) for r in rows if "train_loss" in r}


def rows_agree(got: dict, want: dict, label: str) -> dict:
    """Every row of ``got`` against ``want``'s at its step: bit equality, or
    within RESUME_REL_TOL relative (the reading says which)."""
    missing = sorted(set(got) - set(want))
    if missing or not got:
        raise AssertionError(f"{label}: rows {sorted(got)} not all in {sorted(want)}")
    rel = max(abs(got[s][0] - want[s][0]) / max(abs(want[s][0]), 1e-30) for s in got)
    bitwise = all(got[s] == want[s] for s in got)
    if not bitwise and (rel > RESUME_REL_TOL or any(got[s][1] != want[s][1] for s in got)):
        raise AssertionError(f"{label}: train rows differ by {rel} relative: {got} vs {want}")
    return dict(compared_steps=sorted(got), bitwise=bitwise, max_rel_diff=rel)


def nondeterministic_ops(torch, step, state, batch) -> list:
    """The ops of one train step that PyTorch reports as nondeterministic
    (``use_deterministic_algorithms(warn_only=True)``): what keeps two runs
    from agreeing bit for bit. The step runs (``state`` advances)."""
    import warnings

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step(state, batch)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message)[:160] for w in caught
                   if "determinis" in str(w.message).lower()})


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path)
               for f in files)


def preemption_phase(torch, port, root: str):
    """Phase 29: ``train_mlm --preset flagship_tpu --attn_impl pallas
    --synthetic`` (bf16), P29_STEPS steps, validation every P29_EVAL, rows
    every P29_LOG, two checkpoints kept. Run A uninterrupted in-process; run
    B the same command in a subprocess, sent SIGTERM once its step-8 row
    exists: it must exit 0 with a ``last/`` checkpoint; then ``--resume`` of
    B's run directory, in-process, to the end. Every train row of B (before
    and after the resume) equals A's at its step, bit for bit (or within
    RESUME_REL_TOL, the ops PyTorch calls nondeterministic named); every
    step of A and of the resumed B launches 22/22/22 #1-#3 (all wgmma); A's
    best checkpoint holds its lowest ``val_loss``; its params hash to the
    digest recorded at the save; a restore (``prefer_latest``) takes the
    newest step, and with that step truncated falls back to the one before
    it with a warning. The checkpoint's size and the seconds of a save
    (synchronous, and the async call's return) and of a restore. Returns
    (launches, run A's trainer, A's weights at each validation)."""
    t_phase = time.perf_counter()
    train_mlm, ckpt = port["train_mlm"], port["checkpoint"]
    counters, names = path_counters(port), KERNEL_NAMES
    per_step = per_step_launches(False, "pallas")
    launches = dict.fromkeys(names, 0)
    snapshots = {}

    def run(argv, snapshot: bool = False):
        trainer, data = train_mlm.prepare(P29_ARGS + ["--root", root] + argv)
        for c in counters:
            c.reset()
        checked_steps(trainer, counters, lambda batch: per_step, "phase 29")
        if snapshot:
            hook = trainer.predict_hook

            def snap(state, logger, step):  # the weights at each validation, on the host
                snapshots[step] = {k: v.to("cpu", copy=True)
                                   for k, v in port["param_tree"](state.model).items()}
                hook(state, logger, step)

            trainer.predict_hook = snap
        t0 = time.perf_counter()
        with trainer:
            train_mlm.common.run_fit(trainer, data.train_dataloader(), data.val_dataloader())
        torch.cuda.synchronize()
        for n, c in zip(names, counters):
            launches[n] += c.launches
        return trainer, data, time.perf_counter() - t0

    a, data, a_s = run(["--logdir", f"{root}/p29_A"], snapshot=True)
    a_rows = read_rows(a.run_dir)
    want = train_rows(a_rows)
    if sorted(want) != list(range(P29_LOG, P29_STEPS + 1, P29_LOG)):
        raise AssertionError(f"phase 29 A: rows {a_rows}")

    b_logdir = f"{root}/p29_B"
    b_dir = f"{b_logdir}/mlm/version_0"
    gc.collect()
    torch.cuda.empty_cache()  # the card's memory for B's process
    t0 = time.perf_counter()
    with open(f"{root}/p29_B.log", "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "perceiver_io_torch.cli.train_mlm", *P29_ARGS, "--root",
             root, "--logdir", b_logdir], cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=out, stderr=subprocess.STDOUT)
        try:
            while not any(r.get("step") == P29_SIGTERM_ROW for r in
                          (read_rows(b_dir) if os.path.exists(f"{b_dir}/metrics.jsonl")
                           else [])):
                if proc.poll() is not None or time.perf_counter() - t0 > P29_WAIT_S:
                    raise AssertionError(f"phase 29 B: no step-{P29_SIGTERM_ROW} row "
                                         f"(exit {proc.poll()})")
                time.sleep(0.05)
            proc.send_signal(15)  # SIGTERM
            rc = proc.wait(timeout=P29_WAIT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    b_first_s = time.perf_counter() - t0
    last = f"{b_dir}/checkpoints/last"
    saved_last = sorted(int(s) for s in os.listdir(last) if s.isdigit()) \
        if os.path.isdir(last) else []
    if rc != 0 or len(saved_last) != 1:
        with open(f"{root}/p29_B.log") as f:
            tail = f.read()[-2000:]
        raise AssertionError(f"phase 29 B: exit {rc}, last/ {saved_last}: {tail}")
    b_before = train_rows(read_rows(b_dir))
    b, _, b_resume_s = run(["--logdir", b_logdir, "--resume", b_dir])
    if os.path.abspath(b.run_dir) != os.path.abspath(b_dir):
        raise AssertionError(f"phase 29: the resume logged into {b.run_dir}, not {b_dir}")
    b_all = train_rows(read_rows(b_dir))
    resumed = {s: v for s, v in b_all.items() if s > saved_last[0]}
    if max(b_all) != P29_STEPS or not resumed:
        raise AssertionError(f"phase 29: the resumed B's rows {sorted(b_all)}")
    agree = rows_agree(b_all, want, "phase 29: B against A")
    ops = None
    if not agree["bitwise"]:
        batch = next(iter(data.train_dataloader()))
        ops = nondeterministic_ops(torch, b.train_step, b.state, batch)

    a_ckpt = f"{a.run_dir}/checkpoints"
    val = {r["step"]: r["val_loss"] for r in a_rows if "val_loss" in r}
    best = ckpt.resolve_checkpoint_step(a_ckpt)
    kept = sorted(int(s) for s in os.listdir(a_ckpt) if s.isdigit())
    by_loss = sorted(val, key=lambda s: (val[s], -s))
    if best != by_loss[0] or kept != sorted(by_loss[:2]):
        raise AssertionError(f"phase 29: best {best}, kept {kept}, val rows {val}")
    with open(f"{a_ckpt}/digests.json") as f:
        digests = json.load(f)
    params, _ = ckpt.restore_raw_params(a_ckpt, best)
    if port["tree_digest"](params) != digests[str(best)]:
        raise AssertionError(f"phase 29: step {best}'s params do not hash to its digest")
    if any(not torch.equal(params[k], v) for k, v in snapshots[best].items()):
        raise AssertionError(f"phase 29: step {best}'s saved params are not its weights")
    import warnings

    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ckpt.restore_train_state(a_ckpt, b.state, prefer_latest=True)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if b.state.step != kept[-1] or caught:
        raise AssertionError(f"phase 29: restored step {b.state.step} of {kept}, warnings "
                             f"{[str(w.message) for w in caught]}")
    trunc = f"{root}/p29_truncated"
    import shutil

    shutil.copytree(a_ckpt, trunc)
    for name in os.listdir(f"{trunc}/{kept[-1]}"):
        open(f"{trunc}/{kept[-1]}/{name}", "wb").close()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ckpt.restore_train_state(trunc, b.state, prefer_latest=True)
    fell_back = [str(w.message)[:120] for w in caught if "failed to restore" in str(w.message)]
    if b.state.step != kept[0] or not fell_back:
        raise AssertionError(f"phase 29: a truncated step {kept[-1]} gave step "
                             f"{b.state.step}, warnings {fell_back}")
    shutil.rmtree(trunc)

    sizes = {s: dir_bytes(f"{a_ckpt}/{s}") for s in kept}
    timings = {}
    for mode in ("sync", "async"):
        mngr = ckpt.CheckpointManager(f"{root}/p29_save_{mode}", async_save=mode == "async")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mngr.save(a.state.step, a.state, {"val_loss": 0.0})
        returned = time.perf_counter() - t0
        mngr.wait()
        timings[mode] = dict(call_s=returned, saved_s=time.perf_counter() - t0)
        mngr.close()
        shutil.rmtree(f"{root}/p29_save_{mode}")
    log(phase="preemption_resume", card=card_line(), steps=P29_STEPS, a_fit_s=a_s,
        b_until_sigterm_exit_s=b_first_s, b_resume_fit_s=b_resume_s,
        sigterm_last_step=saved_last[0], b_rows_before_sigterm=sorted(b_before),
        resumed_rows=sorted(resumed), **agree, nondeterministic_ops=ops,
        val_loss=val, best_step=best, kept_steps=kept, checkpoint_bytes=sizes,
        save=timings, restore_s=restore_s, truncated_fallback=fell_back[0],
        launches=launches, launches_per_step=dict(zip(names, per_step)),
        phase_s=time.perf_counter() - t_phase)
    return launches, a, snapshots, best


def checkpoint_serving_phase(torch, port, root: str, a, snapshots, best, texts) -> dict:
    """Phase 30: ``cli.serve --checkpoint <A>/checkpoints --tokenizer T
    --dtype bfloat16`` (width buckets 128/256/512, max_batch 64) on phase 6's
    texts, then with ``--quantize int8``: #1 launches 22 a fused forward, #9
    131 under int8 (all wgmma, no plain version), and each mask's top-1 fill
    equals that of an ``MLMServer`` built in memory from A's weights at the
    best step (the host copy taken at that validation), in the same mode."""
    import contextlib
    import io

    t_phase = time.perf_counter()
    ak, qm, serve = port["ak"], port["qm"], port["serve"]
    tokenizer_file = f"{root}/{FLAGSHIP_TOKENIZER}"
    tokenizer = port["load_tokenizer"](tokenizer_file)
    counters = (ak.counter, qm.counter, ak.wgmma_counter, qm.wgmma_counter)
    out = dict(attention_fwd=0, attention_fwd_wgmma=0, attention_fwd_causal=0,
               dequant_matmul=0, dequant_matmul_wgmma=0)
    servers, base = [], port["MLMServer"]

    class Recording(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            servers.append(self)

    readings = {}
    for quantize in ("none", "int8"):
        for c in counters:
            c.reset()
        serve.MLMServer = Recording
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                results = serve.main(["--checkpoint", f"{a.run_dir}/checkpoints", "--tokenizer",
                                      tokenizer_file, "--dtype", "bfloat16", "--bucket_widths",
                                      "128", "256", "512", "--max_batch", "64", "--quantize",
                                      quantize, "--texts", *texts])
        finally:
            serve.MLMServer = base
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        n_fwd = servers[-1].engine.dispatches
        quantized = quantize == "int8"
        expect = (ATTN_PER_FORWARD * n_fwd, DEQUANT_PER_FORWARD * n_fwd if quantized else 0)
        got = (ak.counter.launches, qm.counter.launches)
        if got != expect or ak.counter.plain_calls or qm.counter.plain_calls:
            raise AssertionError(f"phase 30 {quantize}: launches {got} != {expect} over "
                                 f"{n_fwd} forwards, or a plain version ran")
        check_wgmma_share(ak, qm, f"phase 30 {quantize}")
        out["attention_fwd"] += ak.counter.launches
        out["attention_fwd_wgmma"] += ak.wgmma_counter.launches
        out["dequant_matmul"] += qm.counter.launches
        out["dequant_matmul_wgmma"] += qm.wgmma_counter.launches
        memory = base(a.state.model, snapshots[best], tokenizer, SEQ_LEN,
                      bucket_widths=[128, 256, 512], max_batch=64, compute_dtype="bfloat16",
                      quantize=None if quantize == "none" else quantize, device="cuda")
        want = [f[0] for r in memory.fill_masks(texts, k=5) for f in r]
        top1 = [f[0] for r in results for f in r["fills"]]
        if top1 != want or len(top1) != sum(t.split().count("[MASK]") for t in texts):
            raise AssertionError(f"phase 30 {quantize}: {sum(x != y for x, y in zip(top1, want))}"
                                 f" of {len(want)} top-1 fills differ from the in-memory server")
        readings[quantize] = dict(masks=len(top1), forwards=n_fwd, serve_s=serve_s,
                                  attention_launches=got[0], dequant_launches=got[1])
        del memory
    log(phase="checkpoint_serving", card=card_line(), best_step=best, **readings,
        phase_s=time.perf_counter() - t_phase)
    return out


def bucketed_fit(torch, port, argv: list, label: str) -> dict:
    """``train_ar.prepare(argv)`` fitted in-process: every step must launch 22
    causal #1, 22 causal dq and 22 causal dk/dv (all wgmma) at whatever width
    its batch has; every ``train_loss`` row above 0; ``continuation`` rows at
    steps 8 and 16, the hook launching the causal #1. Returns the trainer,
    the data, the rows, the batches and launches of each width, the hook's
    launches and the fit's seconds."""
    ak, train_ar = port["ak"], port["train_ar"]
    counters, names = ar_counters(port), AR_NAMES
    per_step = [AR_PER_STEP.get(name, 0) for name in names]
    trainer, data = train_ar.prepare(argv)
    steps = []
    checked_steps(trainer, counters, lambda batch: per_step, label, steps)
    hook, hook_launches = trainer.predict_hook, {}

    def counted(state, logger, step):
        before = (ak.counter.launches, ak.causal_counter.launches, ak.wgmma_counter.launches)
        hook(state, logger, step)
        hook_launches[step] = dict(zip(("attention_fwd", "causal", "wgmma"), (
            c.launches - b for c, b in zip((ak.counter, ak.causal_counter, ak.wgmma_counter),
                                           before))))

    trainer.predict_hook = counted
    t0 = time.perf_counter()
    with trainer:
        train_ar.common.run_fit(trainer, data.train_dataloader(), data.val_dataloader())
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    rows = read_rows(trainer.run_dir)
    losses = [r["train_loss"] for r in rows if "train_loss" in r]
    texts = {r["step"]: r["text"] for r in rows if r.get("tag") == "continuation"}
    if len(losses) != 16 or not all(x > 0 and math.isfinite(x) for x in losses) \
            or sorted(texts) != [8, 16] or not all(h["causal"] > 0 and h["wgmma"] ==
                                                   h["attention_fwd"]
                                                   for h in hook_launches.values()):
        raise AssertionError(f"{label}: losses {losses}, hook rows {texts}, hook launches "
                             f"{hook_launches}")
    by_width = {}
    for width, got in steps:
        w = by_width.setdefault(width, dict(batches=0, **dict.fromkeys(ATTN_COUNTERS, 0)))
        w["batches"] += 1
        for n in ATTN_COUNTERS:
            w[n] += got[names.index(n)]
    return dict(trainer=trainer, data=data, rows=rows, losses=losses, texts=texts,
                by_width=by_width, hook_launches=hook_launches, fit_s=fit_s)


def bucketed_ar_phase(torch, port, root: str) -> dict:
    """Phase 31: ``train_ar --preset flagship_tpu --synthetic --attn_impl
    pallas --bucket_widths 128 256 512 --sample_prefix_len 16
    --sample_new_tokens 12 --max_steps 16 --eval_every_n_steps 8``
    in-process (:func:`bucketed_fit`; phase 23, unbucketed, logs a loss of
    exactly 0), then ``cli.serve --task generate --checkpoint`` (the best
    step) continues the hook's prefix with the hook's greedy tokens at that
    step. This corpus's reviews all fit 128 tokens, so a second fit with
    ``--bucket_widths`` P31_SPLIT_WIDTHS must batch at two widths or more,
    each step still launching 22/22/22 causal kernels."""
    import contextlib
    import io

    t_phase = time.perf_counter()
    serve = port["serve"]
    counters, names = ar_counters(port), AR_NAMES
    for c in counters:
        c.reset()
    run = bucketed_fit(torch, port, P31_ARGS + ["--root", root, "--logdir", f"{root}/p31"],
                       "phase 31")
    split_args = ["--bucket_widths", *P31_SPLIT_WIDTHS, "--root", root, "--logdir",
                  f"{root}/p31_split"]
    split = bucketed_fit(torch, port, P31_ARGS + split_args, "phase 31 split")
    launches = {n: c.launches for n, c in zip(names, counters)}
    if len(split["by_width"]) < 2:
        raise AssertionError(f"phase 31 split: every batch had one width: {split['by_width']}")
    trainer, data, texts = run["trainer"], run["data"], run["texts"]
    ckpt = f"{trainer.run_dir}/checkpoints"
    best = port["checkpoint"].resolve_checkpoint_step(ckpt)
    ids = next(iter(data.val_dataloader()))["token_ids"][0]
    prefix = [int(t) for t in ids[:16] if int(t) != 0]
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        served = serve.main(["--task", "generate", "--checkpoint", ckpt, "--max_new_tokens",
                             "12", "--generate_chunk", "8", "--texts",
                             " ".join(map(str, prefix))])
    words = " ".join(data.tokenizer.id_to_token(t) for t in served[0]["continuation_ids"])
    if texts[best] != f"prefix({len(prefix)} toks) → {words}":
        raise AssertionError(f"phase 31: serving step {best} gave {words!r}, the hook "
                             f"{texts[best]!r}")
    log(phase="bucketed_ar", card=card_line(), steps=len(run["losses"]), losses=run["losses"],
        val_loss=[r["val_loss"] for r in run["rows"] if "val_loss" in r],
        by_width=run["by_width"], hook_launches=run["hook_launches"], continuation=texts,
        best_step=best, served_tokens=served[0]["continuation_ids"], fit_s=run["fit_s"],
        split_widths=[int(w) for w in P31_SPLIT_WIDTHS], split_losses=split["losses"],
        split_val_loss=[r["val_loss"] for r in split["rows"] if "val_loss" in r],
        split_by_width=split["by_width"], split_hook_launches=split["hook_launches"],
        split_fit_s=split["fit_s"], launches=launches, phase_s=time.perf_counter() - t_phase)
    return launches


def snapshot_state(state) -> tuple:
    """Copies of the params and the optimizer's state tensors (on the card)."""
    opt = state.optimizer.state_dict()["state"]
    return ({n: p.detach().clone() for n, p in state.model.named_parameters()},
            {i: {k: v.clone() for k, v in s.items() if hasattr(v, "clone")}
             for i, s in opt.items()})


def same_state(torch, a, b) -> bool:
    return all(torch.equal(a[0][n], b[0][n]) for n in a[0]) and a[1].keys() == b[1].keys() \
        and all(torch.equal(a[1][i][k], b[1][i][k]) for i in a[1] for k in a[1][i])


def recovery_phase(torch, port, root: str) -> dict:
    """Phase 32: ``train_mlm --preset reference --synthetic`` (#1-#3 under
    ``auto``, #6-#8 by ``--fused_head auto``), P32_STEPS steps with
    validation every 2, in-process. With ``--skip_nonfinite_steps
    --rollback_after_bad_steps 2``, a gradient hook writing NaN on train-step
    calls P32_POISONED: the first leaves the params and the optimizer's
    moments as they were, the second rolls back to the step-2 checkpoint,
    ``events`` rows say so, and every later loss is finite. With
    ``--dispatch_error_retries 1``, one ``ConnectionResetError`` before call
    P32_FLAKY: the train losses of a clean run (bit for bit, or within
    RESUME_REL_TOL with the nondeterministic ops named)."""
    t_phase = time.perf_counter()
    train_mlm = port["train_mlm"]
    counters, names = path_counters(port), KERNEL_NAMES
    for c in counters:
        c.reset()
    base = ["--preset", "reference", "--synthetic", "--max_steps", str(P32_STEPS),
            "--eval_every_n_steps", "2", "--log_every_n_steps", "1", "--no_tensorboard",
            "--predict_samples", "--root", root]
    trainer, data = train_mlm.prepare(base + ["--skip_nonfinite_steps",
                                              "--rollback_after_bad_steps", "2",
                                              "--logdir", f"{root}/p32_skip"])
    inner, snaps = trainer.train_step, []
    param = next(trainer.state.model.parameters())

    def poisoned(state, batch, **kwargs):
        snaps.append(snapshot_state(state))
        handle = None
        if len(snaps) in P32_POISONED:
            handle = param.register_hook(lambda g: torch.full_like(g, float("nan")))
        try:
            return inner(state, batch, **kwargs)
        finally:
            if handle is not None:
                handle.remove()

    trainer.train_step = poisoned
    with trainer:
        train_mlm.common.run_fit(trainer, data.train_dataloader(), data.val_dataloader())
    torch.cuda.synchronize()
    first, second = P32_POISONED
    rows = read_rows(trainer.run_dir)
    events = [r["text"] for r in rows if r.get("tag") == "events"]
    losses = [r["train_loss"] for r in rows if "train_loss" in r]
    kept = same_state(torch, snaps[first - 1], snaps[first])
    rolled = same_state(torch, snaps[second], snaps[2]) \
        and not same_state(torch, snaps[second], snaps[second - 1])
    if not (kept and rolled) or trainer.bad_steps != 2 or trainer.rollbacks != 1 \
            or trainer.state.step != P32_STEPS or len(events) != 3 \
            or "rolled back to checkpoint step 2" not in events[-1] \
            or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"phase 32: pre-step state kept {kept}, rolled back {rolled}, "
                             f"events {events}, losses {losses}")
    skip_launches = {n: c.launches for n, c in zip(names, counters)}
    if any(c.plain_calls for c in counters) or not all(
            skip_launches[n] for n in ("attention_fwd", "attention_bwd_dq", "attention_bwd_dkv",
                                       "linear_ce_fwd", "linear_ce_bwd_dx", "linear_ce_bwd_dw")):
        raise AssertionError(f"phase 32: launches {skip_launches}")
    del snaps

    def losses_of(extra: list, flaky: bool) -> tuple:
        trainer, data = train_mlm.prepare(base + extra)
        if flaky:
            inner, calls = trainer.train_step, [0]

            def step(state, batch, **kwargs):
                calls[0] += 1
                if calls[0] == P32_FLAKY:
                    raise ConnectionResetError("connection reset by peer (injected)")
                return inner(state, batch, **kwargs)

            trainer.train_step = step
        with trainer:
            train_mlm.common.run_fit(trainer, data.train_dataloader(), data.val_dataloader())
        torch.cuda.synchronize()
        return trainer, data, read_rows(trainer.run_dir)

    clean, data, clean_rows = losses_of(["--logdir", f"{root}/p32_clean"], False)
    retried, _, retry_rows = losses_of(["--dispatch_error_retries", "1",
                                        "--logdir", f"{root}/p32_retry"], True)
    agree = rows_agree(train_rows(retry_rows), train_rows(clean_rows), "phase 32 retry")
    retry_events = [r["text"] for r in retry_rows if r.get("tag") == "events"]
    if retried.step_retries != 1 or len(retry_events) != 1:
        raise AssertionError(f"phase 32: retries {retried.step_retries}, events {retry_events}")
    ops = None
    if not agree["bitwise"]:
        ops = nondeterministic_ops(torch, clean.train_step, clean.state,
                                   next(iter(data.train_dataloader())))
    launches = {n: c.launches for n, c in zip(names, counters)}
    log(phase="recovery", card=card_line(), steps=P32_STEPS, poisoned_calls=P32_POISONED,
        events=events + retry_events, losses=losses, retry=agree, nondeterministic_ops=ops,
        launches=launches, phase_s=time.perf_counter() - t_phase)
    return launches


# phases 33-34: the classifiers (MNIST image classification; sequence
# classification with transfer from phase 29's MLM checkpoint)
P33_STEPS, P33_EVAL = 30, 15
P33_ARGS = ["--synthetic", "--max_steps", str(P33_STEPS), "--eval_every_n_steps",
            str(P33_EVAL), "--log_every_n_steps", "1", "--no_tensorboard"]
P33_IMAGE, P33_CLASSES, CHANCE = (28, 28, 1), 10, 0.1
P34_STEPS, P34_MORE = 8, 4
P34_ARGS = ["--synthetic", "--eval_every_n_steps", "4", "--log_every_n_steps", "1",
            "--no_tensorboard"]


def classifier_routes(pat, b: int, latents: int, inputs: int, c: int, heads: int,
                      layers: int, per_block: int) -> dict:
    """How many of a classifier forward's attention calls the H100 ``auto``
    rule sends to kernel #1 at batch ``b``: the encoder's (``layers`` ×
    (cross over ``inputs`` keys + ``per_block`` self)) and the one-query
    decoder's."""
    d = c // heads
    kernel = lambda t, s: pat.auto_attention_impl(b, t, s, heads, d) == "pallas"  # noqa: E731
    return dict(encoder=layers * (kernel(latents, inputs) + per_block * kernel(latents, latents)),
                decoder=int(kernel(1, latents)))


def classifier_launches(routes: dict, training: bool, dropout: bool, frozen: bool) -> dict:
    """#1-#3 launches (and their wgmma ones, bf16) of one train step or eval
    batch, in KERNEL_NAMES order: active dropout sends a trained call to the
    einsum path; a frozen encoder runs forward only and without dropout."""
    enc, dec = routes["encoder"], routes["decoder"]
    if not training:
        fwd, bwd = enc + dec, 0
    else:
        fwd = (enc if frozen or not dropout else 0) + (0 if dropout else dec)
        bwd = (0 if frozen or dropout else enc) + (0 if dropout else dec)
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    counts.update(attention_fwd=fwd, attention_bwd_dq=bwd, attention_bwd_dkv=bwd,
                  attention_fwd_wgmma=fwd, attention_bwd_dq_wgmma=bwd,
                  attention_bwd_dkv_wgmma=bwd)
    return counts


def image_parity(torch, port, batches) -> dict:
    """Three f32 steps of the reference-width image classifier (weights from
    seed 0, Adam 1e-3) with the kernels, then with the plain versions in
    their place, on the same batches: losses within 1e-4 relative, the first
    step's gradients within 1e-3 of each leaf's peak (phase 9's bars)."""
    import argparse

    common, MHA, ak = port["train_img_clf"].common, port["MultiHeadAttention"], port["ak"]
    args = port["train_img_clf"].build_parser().parse_args(["--dtype", "float32"])
    counters = path_counters(port)
    runs = []
    for plain in (False, True):
        model = common.build_image_classifier(args, P33_IMAGE, P33_CLASSES, "cuda")
        if plain:
            for module in model.modules():
                if isinstance(module, MHA):
                    module.attention = ak.plain_attention
        optimizer, schedule = port["make_optimizer"](port["OptimizerConfig"](),
                                                     model.parameters())
        state = port["TrainState"].create(model, optimizer, schedule, seed=2)
        step, _ = port["make_classifier_steps"](model, schedule, "image")
        before = [c.launches for c in counters]
        losses, grads = [], None
        for batch in batches:
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            if grads is None:
                grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        got = sum(c.launches - b for c, b in zip(counters, before))
        if (got == 0) != plain:
            raise AssertionError(f"phase 33 f32 parity: plain={plain} launched {got} kernels")
        runs.append((losses, grads))
        del model, state
    (k_losses, k_grads), (p_losses, p_grads) = runs
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(k_losses, p_losses))
    peak_all = max(float(g.abs().max()) for g in p_grads.values())
    worst, worst_name, symmetric = 0.0, None, 0.0
    for name, ref in p_grads.items():
        if name.endswith("k_proj.bias"):  # zero in exact arithmetic: noise on both sides
            symmetric = max(symmetric, float(k_grads[name].abs().max()) / peak_all,
                            float(ref.abs().max()) / peak_all)
            continue
        err = float((k_grads[name] - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
        if err > worst:
            worst, worst_name = err, name
    reading = dict(kernel_losses=k_losses, plain_losses=p_losses, loss_max_rel_diff=loss_rel,
                   grad_max_err_over_leaf_peak=worst, worst_leaf=worst_name,
                   k_proj_bias_over_global_peak=symmetric)
    if not (loss_rel <= 1e-4 and worst <= 1e-3 and symmetric < 1e-5):
        raise AssertionError(f"phase 33 f32 parity: {reading}")
    return reading


def image_classification_phase(torch, port, root: str) -> dict:
    """Phase 33: ``train_img_clf --synthetic`` at the reference MNIST width
    (bf16, batch 128, 32 latents × 128 channels, 4 heads of depth 32, 3 ×
    (cross over 784 pixels of 131 channels + 3 self), ``auto``), P33_STEPS
    steps with validation every P33_EVAL, in-process: every train step and
    eval batch launches what the ``auto`` rule routes (12/12/12 #1-#3 a step,
    all wgmma; the one-query decoder on the einsum path), the loss falls and
    the last ``val_acc`` is above chance; then the images/s window and the
    profiled window; three f32 steps, kernels against plain versions."""
    t_phase = time.perf_counter()
    pat, train_img_clf = port["pat"], port["train_img_clf"]
    counters = path_counters(port)
    for c in counters:
        c.reset()
    trainer, data = train_img_clf.prepare(P33_ARGS + ["--root", root,
                                                      "--logdir", f"{root}/p33"])
    args = train_img_clf.build_parser().parse_args([])
    heads = args.num_cross_attention_heads

    def routes(b: int) -> dict:
        return classifier_routes(pat, b, args.num_latents, P33_IMAGE[0] * P33_IMAGE[1],
                                 args.num_latent_channels, heads, args.num_encoder_layers,
                                 args.num_self_attention_layers_per_block)

    check_launches(trainer, counters, lambda batch, training: classifier_launches(
        routes(len(batch["label"])), training, False, False), "phase 33")
    t0 = time.perf_counter()
    with trainer:
        trainer.fit(data.train_dataloader(), data.val_dataloader())
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {n: c.launches for n, c in zip(KERNEL_NAMES, counters)}
    rows = read_rows(trainer.run_dir)
    train = [r for r in rows if "train_loss" in r]
    val = [r for r in rows if "val_loss" in r]
    losses = [r["train_loss"] for r in train]
    per_step = classifier_launches(routes(args.batch_size), True, False, False)
    # at the reference width the rule sends every encoder call to the kernels
    # (12 a step) and the one-query decoder (B·H·S = 16384) to the einsum path
    encoder_calls = args.num_encoder_layers * (1 + args.num_self_attention_layers_per_block)
    if [r["step"] for r in train] != list(range(1, P33_STEPS + 1)) \
            or [r["step"] for r in val] != list(range(P33_EVAL, P33_STEPS + 1, P33_EVAL)) \
            or not all(math.isfinite(x) for x in losses) \
            or not sum(losses[-5:]) / 5 < losses[0] or not val[-1]["val_acc"] > CHANCE \
            or not per_step["attention_fwd"] == per_step["attention_bwd_dq"] == encoder_calls:
        raise AssertionError(f"phase 33: rows {rows}, per step {per_step}")
    windows = cli_windows(torch, port, trainer, data.train_dataloader(), f"{root}/p33_windows",
                          "img_clf", per="examples")
    batches = [b for _, b in zip(range(3), data.train_dataloader())]
    parity = image_parity(torch, port, batches)
    log(phase="image_classification", card=card_line(), steps=P33_STEPS, losses=losses,
        train_acc=[r["train_acc"] for r in train], val=[(r["step"], r["val_loss"], r["val_acc"])
                                                        for r in val],
        routes=routes(args.batch_size), launches_per_step={k: v for k, v in per_step.items()
                                                           if v},
        launches=launches, fit_s=fit_s, checked_fit_images_per_s=[r["examples_per_sec"]
                                                                  for r in train],
        **windows, f32_parity=parity, phase_s=time.perf_counter() - t_phase)
    return launches


def sequence_classification_phase(torch, port, root: str, mlm_ckpt: str) -> dict:
    """Phase 34: ``train_seq_clf --synthetic`` in-process over phase 29's
    root (its tokenizer file) and checkpoint, at its width (the classifier
    built from the checkpoint's hparams: 256 latents × 512 channels, 4 heads
    of depth 128, 3 × (cross + 6 self), 512 tokens), batch 128, bf16, every
    train step and eval batch checked against the ``auto`` rule's routes:

    (a) ``--mlm_checkpoint --freeze_encoder`` (dropout 0.1 by the CLI's
        default): the encoder runs #1 forward only (21 a step, no #2/#3),
        the dropped-out decoder on the einsum path; after the fit the encoder
        equals the checkpoint's best step bit for bit;
    (b) ``--mlm_checkpoint --dropout 0``: #1-#3 at every call, the one-query
        decoder included (B·H·T·S = 131072: the rule's floor);
    (c) ``--clf_checkpoint`` of (b)'s run, ``--dropout 0``: it starts at
        (b)'s best step with its weights, and takes P34_MORE more steps;
    (d) the CLI's defaults from scratch (64 latents × 64 channels): training
        on the einsum path (dropout 0.1), validation on #1."""
    t_phase = time.perf_counter()
    pat, ak, seq, ckpt = port["pat"], port["ak"], port["train_seq_clf"], port["checkpoint"]
    counters = path_counters(port)
    for c in counters:
        c.reset()
    hp = ckpt.load_hparams(mlm_ckpt)
    readings = {}

    def fit(name: str, extra: list, dropout: bool, frozen: bool, widths: dict) -> tuple:
        trainer, data = seq.prepare(P34_ARGS + ["--root", root, "--logdir",
                                                f"{root}/p34_{name}"] + extra)
        if os.path.abspath(data.tokenizer_path) != os.path.abspath(
                f"{root}/{FLAGSHIP_TOKENIZER}"):
            raise AssertionError(f"phase 34 {name}: tokenizer {data.tokenizer_path}")

        def want(batch, training):
            b = len(batch["label"])
            routes = classifier_routes(pat, b, widths["num_latents"], widths["max_seq_len"],
                                       widths["num_latent_channels"], widths["heads"],
                                       widths["num_encoder_layers"],
                                       widths["num_self_attention_layers_per_block"])
            return classifier_launches(routes, training, dropout, frozen)

        check_launches(trainer, counters, want, f"phase 34 {name}")
        start_step = trainer.state.step
        t0 = time.perf_counter()
        with trainer:
            trainer.fit(data.train_dataloader(), data.val_dataloader())
        torch.cuda.synchronize()
        rows = read_rows(trainer.run_dir)
        train = [r for r in rows if "train_loss" in r]
        val = [r for r in rows if "val_loss" in r]
        if not train or not val or not all(math.isfinite(r["train_loss"]) for r in train) \
                or not all(0.0 <= r["val_acc"] <= 1.0 for r in val):
            raise AssertionError(f"phase 34 {name}: rows {rows}")
        b = trainer.state.model.encoder.latent.shape
        readings[name] = dict(
            start_step=start_step, steps=[r["step"] for r in train],
            losses=[r["train_loss"] for r in train],
            val=[(r["step"], r["val_loss"], r["val_acc"]) for r in val],
            launches_per_step={k: v for k, v in want(
                {"label": [0] * 128}, True).items() if v},
            launches_per_eval_batch={k: v for k, v in want(
                {"label": [0] * 128}, False).items() if v},
            tokens_per_s=train[-1]["tokens_per_sec"], latent_shape=list(b),
            fit_s=time.perf_counter() - t0)
        return trainer, rows

    keys = ("num_latents", "num_latent_channels", "num_encoder_layers",
            "num_self_attention_layers_per_block", "max_seq_len")
    flagship = dict({k: hp[k] for k in keys}, heads=hp.get("num_cross_attention_heads", 4))
    steps = ["--max_steps", str(P34_STEPS)]
    a, _ = fit("a_frozen", steps + ["--mlm_checkpoint", mlm_ckpt, "--freeze_encoder"], True,
               True, flagship)
    best = ckpt.resolve_checkpoint_step(mlm_ckpt)
    saved, _ = ckpt.restore_raw_params(mlm_ckpt, best)
    enc = {k: v for k, v in port["param_tree"](a.state.model).items() if k.startswith("encoder/")}
    if sorted(enc) != sorted(k for k in saved if k.startswith("encoder/")) \
            or not all(torch.equal(v.cpu(), saved[k]) for k, v in enc.items()):
        raise AssertionError(f"phase 34 a: the frozen encoder is not step {best}'s")
    readings["a_frozen"]["encoder_bit_equal_to_step"] = best
    del a, enc
    gc.collect()
    torch.cuda.empty_cache()
    b, _ = fit("b_unfrozen", steps + ["--mlm_checkpoint", mlm_ckpt, "--dropout", "0"], False,
               False, flagship)
    b_ckpt = f"{b.run_dir}/checkpoints"
    b_best = ckpt.resolve_checkpoint_step(b_ckpt)
    del b
    gc.collect()
    torch.cuda.empty_cache()
    c, _ = fit("c_resumed", ["--clf_checkpoint", b_ckpt, "--dropout", "0", "--max_steps",
                             str(b_best + P34_MORE)], False, False, flagship)
    if readings["c_resumed"]["start_step"] != b_best \
            or readings["c_resumed"]["steps"] != list(range(b_best + 1, b_best + P34_MORE + 1)):
        raise AssertionError(f"phase 34 c: {readings['c_resumed']} from (b)'s step {b_best}")
    del c
    gc.collect()
    torch.cuda.empty_cache()
    defaults = seq.build_parser().parse_args([])
    scratch = dict({k: getattr(defaults, k) for k in keys},
                   heads=defaults.num_cross_attention_heads)
    fit("d_defaults", steps, True, False, scratch)
    launches = {n: c.launches for n, c in zip(KERNEL_NAMES, counters)}
    if not launches["attention_bwd_dq"] or not launches["attention_fwd"]:
        raise AssertionError(f"phase 34: launches {launches}")
    log(phase="sequence_classification", card=card_line(), mlm_checkpoint_step=best,
        runs=readings, launches=launches, phase_s=time.perf_counter() - t_phase)
    return launches


# phase 35: #1-#3 at the deep head dims, name, (T, S, H, D); compared at
# B=2 (no causal offset) and B=1 (offset DEEP_CAUSAL_OFFSET), timed in bf16
# at DEEP_TIME_BATCH too
DEEP_SHAPES = (("flow-cross", (2048, 182528, 1, 512)),
               ("flow-dec-cross", (182528, 2048, 1, 512)),
               ("d256-cross", (1024, 16384, 2, 256)),
               ("d256-self", (1024, 1024, 4, 256)))
DEEP_CAUSAL_OFFSET, DEEP_HEAD_PADDED, DEEP_TIME_BATCH = 8, 12, 8
# the bf16 designs of attention_deep.cu, as the kernels line names them
_DEEP_BWD = ("wgmma, 256 threads: a loading warp refills a 2-stage TMA ring of 64-row "
             "tiles through mbarriers; S and dP computed once, one a warpgroup; D=512 "
             "split over a 2-block cluster that adds its halves by st.async")
DEEP_DESIGNS = dict(fwd=("wgmma, 256 threads: 128 query rows a block, 64 a warpgroup; a "
                         "loading warp refills 2-stage K and V rings of 64-key tiles through "
                         "mbarriers; each logit tile computed once, the next tile's S issued "
                         "before this tile's softmax; D=512 split over a 2-block cluster that "
                         "adds its halves by st.async"),
                    dq=_DEEP_BWD, dkv=_DEEP_BWD)
# D=1024: the same kernels over a 4-block cluster, 256 head columns a block,
# whose blocks sum each logit tile's shares by a 2-round butterfly
_IN_SPLIT = ("; D=1024 split over a 4-block cluster that sums its shares by a 2-round "
             "butterfly of st.async pushes ((s0 + s1) + (s2 + s3) in every block)")
_IN_BWD = ("wgmma, 256 threads: a loading warp refills a 2-stage TMA ring of 64-row "
           "tiles through mbarriers; S and dP computed once, one a warpgroup" + _IN_SPLIT)
IN_DESIGNS = dict(fwd=("wgmma, 256 threads: 128 query rows a block, 64 a warpgroup; a "
                       "loading warp refills 2-stage K and V rings of 64-key tiles through "
                       "mbarriers; each logit tile computed once, the next tile's S issued "
                       "before this tile's softmax" + _IN_SPLIT),
                  dq=_IN_BWD, dkv=_IN_BWD)


def deep_library_ms(torch, pat, q, k, v, g, pad) -> dict:
    """The times of one library call computing the same function: SDPA
    with the additive pad mask where it takes the shape, else the einsum
    path (``library``: ``'sdpa'`` or ``'einsum'``; ``library_fwd_ms``,
    ``library_bwd_ms``), and the einsum path's own (``einsum_fwd_ms``,
    ``einsum_bwd_ms``: the yardstick ``AUTO_DEEP_MIN_LOGITS`` is drawn
    from); CUDA events. None where a call does not fit in the card's
    memory."""
    import torch.nn.functional as F

    bias = None if pad is None else torch.zeros(pad.shape, device=q.device).masked_fill(
        pad, -1e30)[:, None, None, :].to(q.dtype)
    heads_first = [x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v)]
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    calls = (("sdpa", lambda: F.scaled_dot_product_attention(*heads_first, attn_mask=bias),
              heads_first, g.transpose(1, 2)),
             ("einsum", lambda: pat.dot_product_attention(*leaves, pad, None), leaves, g))
    times = {}
    for kind, fn, ins, cot in calls:
        try:
            fwd = time_ms(fn, 2)
            out = fn()
            bwd = time_ms(lambda: torch.autograd.grad(out, ins, cot, retain_graph=True), 2)
            times[kind] = (fwd, bwd)
        except (torch.cuda.OutOfMemoryError, RuntimeError):
            pass
        out = None
        gc.collect()
        torch.cuda.empty_cache()
    kind = next((x for x in ("sdpa", "einsum") if x in times), None)
    lib = times.get(kind, (None, None))
    ein = times.get("einsum", (None, None))
    return dict(library=kind, library_fwd_ms=lib[0], library_bwd_ms=lib[1],
                einsum_fwd_ms=ein[0], einsum_bwd_ms=ein[1])


def deep_counts(ak) -> list:
    return [c.launches for c in (ak.deep_counter, ak.dq_deep_counter, ak.dkv_deep_counter)]


def check_fwd_repeats(torch, ak, label: str, first, *args) -> bool:
    """A second ``ak.attention_fwd_with_stats(*args)`` gives out, m and l
    bit for bit equal to ``first``: the deep forward sums in a fixed order
    (at D=512 own + peer on both blocks of a cluster), with no atomics."""
    for name, a, again in zip(("out", "m", "l"), first, ak.attention_fwd_with_stats(*args)):
        if not torch.equal(a, again):
            raise AssertionError(f"{label}: a second forward's {name} differs from the first")
    return True


def check_bwd_repeats(torch, ak, label: str, grads, *args) -> bool:
    """A second ``ak.attention_bwd(*args)`` gives dq, dk and dv bit for bit
    equal to ``grads``: the deep backward reduces in a fixed order, with no
    atomics (phase 29's bit-for-bit resume rests on that)."""
    for name, first, again in zip(("dq", "dk", "dv"), grads, ak.attention_bwd(*args)):
        if not torch.equal(first, again):
            raise AssertionError(f"{label}: a second backward's {name} differs from the first")
    return True


def deep_attention_phase(torch, ak, pat, shapes=None) -> list:
    """Phases 35 and 38: #1-#3's deep designs against their plain versions
    at ``shapes`` (phase 35's DEEP_SHAPES by default; see the module
    docstring); the rows of the ``kernels`` line."""
    rows = []
    for name, (t, s, h, d) in shapes or DEEP_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for off in (None, DEEP_CAUSAL_OFFSET):
                t_row = time.perf_counter()
                dt = str(dtype).split(".")[1]
                b = 2 if off is None else 1
                gen = torch.Generator().manual_seed(t + s + d + (off or 0))
                pad = torch.rand(b, s, generator=gen) < 0.3
                if off is None:
                    pad[-1] = True  # a fully masked example
                else:
                    pad[:, :DEEP_HEAD_PADDED] = True  # rows 0-3 see only padding
                pad = pad.cuda()
                q, g = (torch.randn(b, t, h, d, generator=gen).to("cuda", dtype)
                        for _ in range(2))
                k, v = (torch.randn(b, s, h, d, generator=gen).to("cuda", dtype)
                        for _ in range(2))
                before = deep_counts(ak)
                out, m, l = ak.attention_fwd_with_stats(q, k, v, pad, off)
                label = f"deep {name} {dt} offset {off}"
                fwd_repeats = (check_fwd_repeats(torch, ak, label, (out, m, l), q, k, v, pad,
                                                 off) if dt == "bfloat16" else None)
                ref_out, ref_m, ref_l = ak.attention_reference_with_stats(q, k, v, pad, off)
                fwd_err = check(f"{label} out", out, ref_out, dt)
                stat_err = max(check_stats(f"{label} m", m, ref_m),
                               check_stats(f"{label} l", l, ref_l))
                del out, m, l
                grads = ak.attention_bwd(q, k, v, pad, ref_out, ref_m, ref_l, g, off)
                if deep_counts(ak) != [n + 1 + (dt == "bfloat16") * (i == 0)
                                       for i, n in enumerate(before)]:
                    raise AssertionError(f"{label}: deep launches {deep_counts(ak)} from {before}")
                repeats = (check_bwd_repeats(torch, ak, label, grads, q, k, v, pad, ref_out,
                                             ref_m, ref_l, g, off)
                           if dt == "bfloat16" else None)
                refs = ak.attention_bwd_reference(q, k, v, pad, ref_out, ref_m, ref_l, g, off)
                errs = [check(f"{label} {x}", got, ref, dt)
                        for x, got, ref in zip(("dq", "dk", "dv"), grads, refs)]
                del refs
                if off is None and (grads[0][-1].any() or grads[1][-1].any()):
                    raise AssertionError(f"{label}: dq/dk of the fully masked example not 0")
                if off is not None and grads[0][:, :DEEP_HEAD_PADDED - off].any():
                    raise AssertionError(f"{label}: dq of rows that see only padding not 0")
                row = dict(phase="deep_attention", shape=name, dims=[b, t, s, h, d], dtype=dt,
                           causal_offset=off, design=ak.forward_design(q, k, v),
                           max_abs_err=max([fwd_err] + errs), fwd_max_abs_err=fwd_err,
                           dq_max_abs_err=errs[0], dkv_max_abs_err=max(errs[1:]),
                           stats_max_rel_err=stat_err, fwd_bit_identical=fwd_repeats,
                           bwd_bit_identical=repeats)
                if off is None:
                    row.update(deep_timing(torch, ak, pat, q, k, v, g, pad, ref_m, ref_l,
                                           ref_out, dt, plain=True))
                row["row_s"] = time.perf_counter() - t_row
                log(**row)
                rows.append(row)
                del q, k, v, g, grads, ref_out, ref_m, ref_l
                gc.collect()
                torch.cuda.empty_cache()
        # bf16 at DEEP_TIME_BATCH, no padding: the kernels' times at the CLI's batch
        t_row = time.perf_counter()
        b = DEEP_TIME_BATCH
        gen = torch.Generator(device="cuda").manual_seed(t + s + d)
        q, g = (torch.randn(b, t, h, d, generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        out, m, l = ak.attention_fwd_with_stats(q, k, v, None)
        fwd_repeats = check_fwd_repeats(torch, ak, f"deep {name} bfloat16 B={b}", (out, m, l),
                                        q, k, v, None)
        grads = ak.attention_bwd(q, k, v, None, out, m, l, g)
        repeats = check_bwd_repeats(torch, ak, f"deep {name} bfloat16 B={b}", grads, q, k, v,
                                    None, out, m, l, g)
        del grads
        row = dict(phase="deep_attention", shape=name, dims=[b, t, s, h, d], dtype="bfloat16",
                   causal_offset=None, design=ak.forward_design(q, k, v), timed_only=True,
                   fwd_bit_identical=fwd_repeats, bwd_bit_identical=repeats,
                   **deep_timing(torch, ak, pat, q, k, v, g, None, m, l, out, "bfloat16",
                                 plain=False))
        row["row_s"] = time.perf_counter() - t_row
        log(**row)
        rows.append(row)
        del q, k, v, g, out, m, l
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def deep_timing(torch, ak, pat, q, k, v, g, pad, m, l, out, dt: str, plain: bool) -> dict:
    """Times of the deep kernels on these inputs (CUDA events: the profiler
    misses part of a cluster's launch), their bounds
    (counting the work the data needs, ``live_work``), the library's
    (``deep_library_ms``) and, with ``plain``, the plain versions' (forward
    with statistics; the whole backward)."""
    b, t, h, d = q.shape
    s = k.shape[1]
    bias = ak.pad_bias(pad, b, s, "cuda")
    delta = ak.bwd_delta(g, out)
    run = dict(fwd=lambda: ak.attention_fwd_with_stats(q, k, v, pad),
               dq=lambda: ak.launch_bwd_dq(q, k, v, bias, m, l, delta, g),
               dkv=lambda: ak.launch_bwd_dkv(q, k, v, bias, m, l, delta, g))
    io_t, io_s = (q.element_size() * n * h * d for n in (t, s))  # one example's
    live, keys = live_work(pad, b, s)
    dead = b - live
    stats_bytes = 4 * 3 * b * h * t + 4 * b * s
    bounds = dict(fwd=bound_ms(live * (2 * io_t + 2 * io_s) + dead * (io_t + io_s) + 4 * b * s
                               + 8 * b * h * t, 4 * h * t * d * keys, dt),
                  dq=bound_ms(live * (3 * io_t + 2 * io_s) + dead * io_t + stats_bytes,
                              6 * h * t * d * keys, dt),
                  dkv=bound_ms(live * (2 * io_t + 4 * io_s) + dead * (io_t + 2 * io_s)
                               + stats_bytes, 8 * h * t * d * keys, dt))
    row = {}
    for part, fn in run.items():
        row[f"{part}_ms"] = time_ms(fn, 2)
        row[f"{part}_bound_ms"], row[f"{part}_bound_by"] = bounds[part]
    if plain:
        row["plain_fwd_ms"] = time_ms(lambda: ak.attention_reference_with_stats(q, k, v, pad),
                                      2)
        row["plain_bwd_ms"] = time_ms(lambda: ak.attention_bwd_reference(q, k, v, pad, out, m,
                                                                         l, g), 2)
    row.update(deep_library_ms(torch, pat, q, k, v, g, pad))
    return row


ONE_KEY_SEEDS = 3


def one_key_sweep(torch, ak) -> list:
    """The bf16 backward where ds = p (g.v - delta) is 0 in exact arithmetic
    (one key, so p = 1 and out = v), at every head dim from the same draw
    (the first D columns of one at the widest D), ONE_KEY_SEEDS draws of (3, 250,
    2, D) queries: how far the wgmma kernels' dq, dk and the plain
    versions' lie from 0 (the card tests' ``BWD_ATOL`` cases) and where it
    comes from. ds of a row is read back from dq by least squares over k's
    D columns; since delta is the same f32 sum on both sides (``bwd_delta``,
    against float64), the rest of the kernel's ds is its tensor-core sum
    g.v against float64, beside the plain version's f32 einsum."""
    rows = []
    width = max(ak.SUPPORTED_HEAD_DIMS)
    for d in ak.SUPPORTED_HEAD_DIMS:
        worst = dict.fromkeys(("kernel_dq", "kernel_dk", "plain_dq", "plain_dk", "kernel_ds",
                               "plain_ds", "delta_err", "kernel_dp_err", "plain_dp_err",
                               "kernel_minus_plain"), 0.0)
        for seed in range(ONE_KEY_SEEDS):
            gen = torch.Generator().manual_seed(seed)
            q, g = (torch.randn(3, 250, 2, width, generator=gen)[..., :d] for _ in range(2))
            k, v = (torch.randn(3, 1, 2, width, generator=gen)[..., :d] for _ in range(2))
            q, k, v, g = (x.to("cuda", torch.bfloat16).contiguous() for x in (q, k, v, g))
            pad = torch.zeros(3, 1, dtype=torch.bool, device="cuda")
            out, m, l = ak.attention_reference_with_stats(q, k, v, pad)
            got = ak.attention_bwd(q, k, v, pad, out, m, l, g)
            ref = ak.attention_bwd_reference(q, k, v, pad, out, m, l, g)
            k64 = k.double()[:, 0]  # (B, H, D)
            dp64 = (g.double() * v.double()).sum(-1)  # (B, T, H): one key
            delta64 = (g.double() * out.double()).sum(-1)
            delta32 = ak.bwd_delta(g, out).transpose(1, 2).double()
            plain_dp = torch.einsum("bthd,bshd->bhts", g.float(), v.float())[..., 0]
            plain_dp = plain_dp.transpose(1, 2).double()  # the plain version's f32 g.v
            scale = d**-0.5
            for side, (dq, dk, _) in (("kernel", got), ("plain", ref)):
                ds = ((dq.double() * k64[:, None]).sum(-1)
                      / (scale * (k64 * k64).sum(-1))[:, None])  # (B, T, H)
                worst[f"{side}_dq"] = max(worst[f"{side}_dq"], float(dq.float().abs().max()))
                worst[f"{side}_dk"] = max(worst[f"{side}_dk"], float(dk.float().abs().max()))
                worst[f"{side}_ds"] = max(worst[f"{side}_ds"], float(ds.abs().max()))
                if side == "kernel":  # ds = fl(dp) - delta32 and dp64 = delta64
                    err = float((ds + delta32 - dp64).abs().max())
                    worst["kernel_dp_err"] = max(worst["kernel_dp_err"], err)
            worst["delta_err"] = max(worst["delta_err"], float((delta32 - delta64).abs().max()))
            worst["plain_dp_err"] = max(worst["plain_dp_err"],
                                        float((plain_dp - dp64).abs().max()))
            worst["kernel_minus_plain"] = max(worst["kernel_minus_plain"], *(
                float((x.float() - r.float()).abs().max()) for x, r in zip(got[:2], ref[:2])))
        rows.append(dict(d=d, **worst))
    log(phase="deep_attention_one_key", seeds=ONE_KEY_SEEDS, rows=rows)
    return rows


# phase 36: train_flow at the paper's width. Adam at the CLI's 1e-3 swings
# the end-point error over the first steps (2.31, 5.28, 6.88, 5.86, 2.29,
# 3.38: PERF.md §6), on the einsum path as on the kernels (lr_witness),
# so the checked fit takes 1e-4
P36_STEPS, P36_PAIRS = 8, 48
P36_ARGS = ["--synthetic", "--synthetic_size", str(P36_PAIRS), "--max_steps", str(P36_STEPS),
            "--eval_every_n_steps", str(P36_STEPS), "--log_every_n_steps", "1",
            "--learning_rate", "1e-4", "--no_tensorboard"]
FLOW_ATTENTION = 26  # 1 encoder cross + 24 self + 1 decoder cross
FLOW_DEEP = 2        # the two crosses, one head of depth 512


def attention_launches(calls: int, training: bool) -> dict:
    """#1-#3 launches (and their wgmma ones) of one train step or eval batch
    whose forward makes ``calls`` attention calls on the kernels, in
    KERNEL_NAMES order (flow at the CLI's batch: FLOW_ATTENTION, every call
    on the kernels by the ``auto`` rule)."""
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    bwd = calls if training else 0
    counts.update(attention_fwd=calls, attention_fwd_wgmma=calls, attention_bwd_dq=bwd,
                  attention_bwd_dkv=bwd, attention_bwd_dq_wgmma=bwd, attention_bwd_dkv_wgmma=bwd)
    return counts


def deep_per_step(deep: int):
    """``want`` of :func:`check_deep_launches` for a model with ``deep``
    deep calls at any batch: as many of each deep kernel a train step, as
    many forwards an eval batch."""
    return lambda batch, training: [deep] + [deep if training else 0] * 2


def check_deep_launches(trainer, ak, label: str, want) -> None:
    """Wrap the trainer's steps: each launches ``want(batch, training)`` of
    #1, #2 and #3 on the deep designs."""
    def wrap(step, training: bool):
        def run(state, batch, *rest, **kwargs):
            before = deep_counts(ak)
            out = step(state, batch, *rest, **kwargs)
            got = [a - b for a, b in zip(deep_counts(ak), before)]
            expected = want(batch, training)
            if got != expected:
                raise AssertionError(f"{label}: deep launches {got} != {expected}")
            return out
        return run

    trainer.train_step = wrap(trainer.train_step, True)
    trainer.eval_step = wrap(trainer.eval_step, False)


def flow_model(port, dtype: str, attn_impl: str):
    """The flow model at the CLI's defaults, weights from seed 0."""
    train_flow = port["train_flow"]
    args = train_flow.build_parser().parse_args(["--dtype", dtype, "--attn_impl", attn_impl])
    shape = (args.image_height, args.image_width, args.image_channels)
    return train_flow.common.build_flow_model(args, shape, "cuda")


def f32_step_parity(torch, port, build, make_steps, batches, deep: int, label: str) -> dict:
    """Three f32 steps (weights from seed 0, Adam 1e-3) of the model
    ``build()`` gives with the kernels at every call (``'pallas'``), then
    with the plain versions in their place, on the same batches: losses
    within 1e-4 relative, the first step's gradients within 1e-3 of each
    leaf's peak (phase 9's bars); ``deep`` calls a step on the deep
    designs. The plain versions run in float64 (f32 inputs upcast, the
    output rounded to f32): an f32 plain version's own rounding, which the
    one-query crosses amplify in their q/k gradients, is not the kernels'."""
    ak, MHA = port["ak"], port["MultiHeadAttention"]
    counters = path_counters(port)

    def plain_in_f64(q, k, v, pad_mask=None, causal_offset=None):
        return ak.plain_attention(q.double(), k.double(), v.double(), pad_mask,
                                  causal_offset).to(q.dtype)

    runs = []
    for plain in (False, True):
        model = build()
        if plain:
            for module in model.modules():
                if isinstance(module, MHA):
                    module.attention = plain_in_f64
        optimizer, schedule = port["make_optimizer"](port["OptimizerConfig"](),
                                                     model.parameters())
        state = port["TrainState"].create(model, optimizer, schedule, seed=2)
        step, _ = make_steps(model, schedule)
        before = [c.launches for c in counters] + deep_counts(ak)
        losses, grads = [], None
        for batch in batches:
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            if grads is None:
                grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        got = [a - b for a, b in zip([c.launches for c in counters] + deep_counts(ak), before)]
        if (sum(got) == 0) != plain or (not plain and got[-3:] != [3 * deep] * 3):
            raise AssertionError(f"{label} f32 parity: plain={plain} launched {got}")
        runs.append((losses, grads))
        del model, state, optimizer
        gc.collect()
        torch.cuda.empty_cache()
    (k_losses, k_grads), (p_losses, p_grads) = runs
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(k_losses, p_losses))
    worst, worst_name, symmetric = grads_apart(k_grads, p_grads)
    reading = dict(kernel_losses=k_losses, plain_losses=p_losses, loss_max_rel_diff=loss_rel,
                   grad_max_err_over_leaf_peak=worst, worst_leaf=worst_name,
                   k_proj_bias_over_global_peak=symmetric)
    if not (loss_rel <= 1e-4 and worst <= 1e-3 and symmetric < 1e-5):
        raise AssertionError(f"{label} f32 parity: {reading}")
    return reading


def grads_apart(got: dict, ref: dict) -> tuple:
    """(the largest gradient difference over its leaf's peak, that leaf,
    the larger ``k_proj.bias`` gradient over the global peak): a
    ``k_proj.bias`` gradient is zero in exact arithmetic, noise on both
    sides, so it is held to the other gradients' scale."""
    peak_all = max(float(x.abs().max()) for x in ref.values())
    worst, worst_name, symmetric = 0.0, None, 0.0
    for name, r in ref.items():
        if name.endswith("k_proj.bias"):
            symmetric = max(symmetric, float(got[name].abs().max()) / peak_all,
                            float(r.abs().max()) / peak_all)
            continue
        err = float((got[name] - r).abs().max()) / max(float(r.abs().max()), 1e-30)
        if err > worst:
            worst, worst_name = err, name
    return worst, worst_name, symmetric



def flow_routes(torch, port, batch) -> dict:
    """One bf16 step at batch 1 on each route, ``'auto'`` (at batch 1 the
    crosses on the einsum path, the self-attention on the kernels),
    ``'pallas'`` (every call on the kernels) and ``'xla'`` (a warm step,
    then a profiled one): device busy ms, peak memory, and the #1 launches
    of the measured step."""
    ak = port["ak"]
    model = flow_model(port, "bfloat16", "auto")
    optimizer, schedule = port["make_optimizer"](port["OptimizerConfig"](), model.parameters())
    state = port["TrainState"].create(model, optimizer, schedule, seed=2)
    step, _ = port["make_flow_steps"](model, schedule)
    reading = {}
    for impl in ("auto", "pallas", "xla"):
        use_attn_impl(model, port, impl)
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        before = (ak.counter.launches, ak.deep_counter.launches)
        prof = profile_pass(torch, lambda: step(state, batch), f"flow_b1_{impl}")
        reading[impl] = dict(device_ms=prof["device_busy_ms"],
                             idle_share=prof["device_idle_share"],
                             peak_memory_bytes=torch.cuda.max_memory_allocated(),
                             attention_fwd=ak.counter.launches - before[0],
                             attention_fwd_deep=ak.deep_counter.launches - before[1])
    del model, state, optimizer
    gc.collect()
    torch.cuda.empty_cache()
    return reading


EINSUM_BATCHES = (2, 4, 8)
WITNESS_STEPS, WITNESS_BATCH = 6, 2


def flow_einsum_steps(torch, port, batch) -> dict:
    """One bf16 step at each of EINSUM_BATCHES (the first rows of the CLI's
    batch) with every attention call on the einsum path (``'xla'``): its
    peak memory and device ms, or that it does not fit in the card's memory
    (where ``'auto'`` must send the deep crosses to the kernels,
    ``ops.attention.AUTO_DEEP_MIN_LOGITS``); one model and optimizer for
    all, so each peak holds the same weights and Adam state."""
    model = flow_model(port, "bfloat16", "xla")
    optimizer, schedule = port["make_optimizer"](port["OptimizerConfig"](), model.parameters())
    state = port["TrainState"].create(model, optimizer, schedule, seed=2)
    step, _ = port["make_flow_steps"](model, schedule)
    readings = {}
    for b in EINSUM_BATCHES:
        rows = {k: v[:b] for k, v in batch.items()}
        state.optimizer.zero_grad(set_to_none=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            prof = profile_pass(torch, lambda: step(state, rows), f"flow_b{b}_xla")
            reading = dict(fits=True, device_ms=prof["device_busy_ms"],
                           peak_memory_bytes=torch.cuda.max_memory_allocated())
        except torch.cuda.OutOfMemoryError as exc:
            reading = dict(fits=False, peak_memory_bytes=torch.cuda.max_memory_allocated(),
                           error=str(exc).splitlines()[0][:200])
        reading["cross_logits"] = b * 2048 * 182528  # B·H·T·S of each cross
        readings[f"b{b}"] = reading
    state.optimizer.zero_grad(set_to_none=True)
    del model, state, optimizer, step
    gc.collect()
    torch.cuda.empty_cache()
    return readings


def lr_witness(torch, port, build, make_steps, batches, deep: int, label: str,
               config) -> dict:
    """bf16 steps at the CLI's optimizer ``config`` on ``batches`` from the
    same weights (seed 0), once with every call on the kernels
    (``'pallas'``: ``deep`` forward calls a step on the deep wgmma design)
    and once on the einsum path (``'xla'``), the model ``build(impl)``
    gives: whether a swing of the loss at the CLI's rate
    comes with the kernels or with the optimizer."""
    ak = port["ak"]
    runs = {}
    for impl in ("pallas", "xla"):
        model = build(impl)
        optimizer, schedule = port["make_optimizer"](config, model.parameters())
        state = port["TrainState"].create(model, optimizer, schedule, seed=2)
        step, _ = make_steps(model, schedule)
        before = ak.deep_counter.launches
        losses = []
        for batch in batches:
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        launched = ak.deep_counter.launches - before
        if not all(math.isfinite(x) for x in losses) \
                or launched != (deep * len(batches) if impl == "pallas" else 0):
            raise AssertionError(f"{label} witness {impl}: losses {losses}, deep {launched}")
        runs[impl] = losses
        del model, state, optimizer, step
        gc.collect()
        torch.cuda.empty_cache()
    return dict(batch=len(next(iter(batches[0].values()))), optimizer=config.optimizer,
                learning_rate=config.learning_rate, weight_decay=config.weight_decay, **runs,
                max_rel_diff=max(abs(a - b) / abs(b) for a, b in zip(runs["pallas"], runs["xla"])))



def flow_phase(torch, port, root: str) -> dict:
    """Phase 36 (see the module docstring): ``train_flow`` at the CLI's
    defaults; returns the checked fit's launches."""
    t_phase = time.perf_counter()
    ak, train_flow = port["ak"], port["train_flow"]
    counters = path_counters(port)
    for c in counters + (ak.deep_counter, ak.dq_deep_counter, ak.dkv_deep_counter):
        c.reset()
    t0 = time.perf_counter()
    trainer, data = train_flow.prepare(P36_ARGS + ["--root", root, "--logdir", f"{root}/p36"])
    setup_s = time.perf_counter() - t0
    check_launches(trainer, counters,
                   lambda batch, training: attention_launches(FLOW_ATTENTION, training),
                   "phase 36")
    check_deep_launches(trainer, ak, "phase 36", deep_per_step(FLOW_DEEP))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with trainer:
        trainer.fit(data.train_dataloader(), data.val_dataloader())
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_peak = torch.cuda.max_memory_allocated()
    launches = {n: c.launches for n, c in zip(KERNEL_NAMES, counters)}
    deep = dict(zip(("attention_fwd_deep", "attention_bwd_dq_deep", "attention_bwd_dkv_deep"),
                    deep_counts(ak)))
    rows = read_rows(trainer.run_dir)
    train = [r for r in rows if "train_loss" in r]
    val = [r for r in rows if "val_loss" in r]
    losses = [r["train_loss"] for r in train]
    if [r["step"] for r in train] != list(range(1, P36_STEPS + 1)) \
            or [r["step"] for r in val] != [P36_STEPS] \
            or not all(math.isfinite(x) for x in losses + [val[0]["val_loss"]]) \
            or not sum(losses[-3:]) / 3 < losses[0]:
        raise AssertionError(f"phase 36: rows {rows}")
    # the checked steps' state and loader; the deep wrap stays on (windows
    # take the trainer's steps)
    torch.cuda.reset_peak_memory_stats()
    windows = cli_windows(torch, port, trainer, data.train_dataloader(), f"{root}/p36_windows",
                          "flow", per="examples")
    window_peak = torch.cuda.max_memory_allocated()
    batches = [b for _, b in zip(range(3), data.train_dataloader())]
    batch1 = [{k: v[:1] for k, v in b.items()} for b in batches]
    # WITNESS_STEPS batches of WITNESS_BATCH pairs, cut from those rows in order
    witness_batches = [{k: v[i:i + WITNESS_BATCH] for k, v in b.items()}
                       for b in batches for i in range(0, len(b["flow"]), WITNESS_BATCH)]
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    parity = f32_step_parity(torch, port, lambda: flow_model(port, "float32", "pallas"),
                             port["make_flow_steps"], batch1, FLOW_DEEP, "phase 36")
    routes = flow_routes(torch, port, batch1[0])
    einsum = flow_einsum_steps(torch, port, batches[0])
    witness = lr_witness(torch, port, lambda impl: flow_model(port, "bfloat16", impl),
                         port["make_flow_steps"], witness_batches[:WITNESS_STEPS], FLOW_DEEP,
                         "phase 36", port["OptimizerConfig"]())
    log(phase="flow", card=card_line(), steps=P36_STEPS, losses=losses,
        val=[(r["step"], r["val_loss"]) for r in val], launches=launches, deep_launches=deep,
        launches_per_step={k: v for k, v in attention_launches(FLOW_ATTENTION, True).items()
                           if v},
        deep_per_step=FLOW_DEEP, setup_s=setup_s, fit_s=fit_s,
        checked_fit_pairs_per_s=[r["examples_per_sec"] for r in train],
        fit_peak_memory_bytes=fit_peak, window_peak_memory_bytes=window_peak,
        **windows, f32_parity=parity, b1_routes=routes, einsum_steps=einsum,
        lr_witness=witness,
        phase_s=time.perf_counter() - t_phase)
    launches.update(deep)
    return launches


# phase 37: train_multimodal at the paper's Kinetics width, on the kernels
# (--attn_impl pallas: the CLI's preset, xla, runs every call on the einsum
# path). Adam at the CLI's 1e-3 swings the loss over the first steps (2.59,
# 5.29, 3.97, 7.78, 8.86: the label CE; PERF.md §6) on the einsum path as on
# the kernels (the witness), so the checked fit takes 1e-4. Each call of one
# forward, (T, S, H, D) and its count:
P37_STEPS, P37_CLIPS, P37_WITNESS_STEPS = 8, 48, 5
P37_ARGS = ["--synthetic_size", str(P37_CLIPS), "--max_steps", str(P37_STEPS),
            "--eval_every_n_steps", str(P37_STEPS), "--log_every_n_steps", "1",
            "--attn_impl", "pallas", "--learning_rate", "1e-4", "--no_tensorboard"]
MM_CALLS = (("mm-enc-cross", (784, 52096, 1, 512), 1),   # latents over the fused stream
            ("mm-dec-cross", (52097, 784, 1, 512), 1),   # every output query over the latents
            ("mm-self", (784, 784, 8, 64), 8))           # the 8 self-attention layers
MM_CHECK_BATCH, MM_TIME_BATCH, MM_PARITY_BATCH = 2, 8, 1
MM_ROUTES = ("xla", "auto", "pallas")


def mm_kernel_calls(pat, b: int, impl: str) -> tuple:
    """(#1 calls, of them on the deep designs) of one multimodal forward at
    batch ``b`` with every layer on ``impl``: ``'pallas'`` every call,
    ``'auto'`` the calls ``auto_attention_impl`` sends to the kernels,
    ``'xla'`` none."""
    calls = deep = 0
    for _, (t, s, h, d), n in MM_CALLS:
        if impl == "pallas" or (impl == "auto"
                                and pat.auto_attention_impl(b, t, s, h, d) == "pallas"):
            calls += n
            deep += n * (d >= 256)
    return calls, deep


def mm_launches(pat, impl: str):
    """``want(batch, training)`` for :func:`check_launches`: #1-#3 launches
    (and their wgmma ones) of one multimodal train step or eval batch on
    ``impl``, in KERNEL_NAMES order."""
    def want(batch, training: bool) -> dict:
        return attention_launches(mm_kernel_calls(pat, len(batch["label"]), impl)[0], training)
    return want


def mm_model(port, dtype: str, attn_impl: str, video_patch_loss: bool = False):
    """The multimodal autoencoder at the CLI's defaults, weights from seed 0."""
    tm = port["train_multimodal"]
    args = tm.build_parser().parse_args(
        ["--dtype", dtype, "--attn_impl", attn_impl]
        + (["--video_patch_loss"] if video_patch_loss else []))
    shape = (args.video_frames, args.video_size, args.video_size, args.video_channels)
    return tm.common.build_multimodal_model(args, shape, args.num_classes, "cuda")


def multimodal_attention_phase(torch, ak, pat) -> list:
    """Phase 37's kernel rows: #1-#3 at each call of the multimodal step
    (MM_CALLS; the crosses on the D=512 designs, the self layer on the
    D=64 ones) against their plain versions at MM_CHECK_BATCH, f32 and bf16,
    no pad mask: out, m, l, dq, dk, dv, one launch of each kernel a call
    (on the deep counters at D=512), every bf16 forward and backward run
    twice, bit for bit the same; then bf16 at MM_TIME_BATCH, the step's
    batch: the kernels' times beside their bounds and the library's."""
    rows = []
    for name, (t, s, h, d), _ in MM_CALLS:
        deep = d in ak.DEEP_HEAD_DIMS
        for dtype in (torch.float32, torch.bfloat16):
            t_row = time.perf_counter()
            dt = str(dtype).split(".")[1]
            b = MM_CHECK_BATCH
            gen = torch.Generator().manual_seed(t + s + d)
            q, g = (torch.randn(b, t, h, d, generator=gen).to("cuda", dtype) for _ in range(2))
            k, v = (torch.randn(b, s, h, d, generator=gen).to("cuda", dtype) for _ in range(2))
            counters = (ak.counter, ak.dq_counter, ak.dkv_counter)
            before = [c.launches for c in counters] + deep_counts(ak)
            label = f"multimodal {name} {dt}"
            out, m, l = ak.attention_fwd_with_stats(q, k, v, None)
            bf16 = dt == "bfloat16"
            fwd_repeats = (check_fwd_repeats(torch, ak, label, (out, m, l), q, k, v, None)
                           if bf16 else None)
            ref_out, ref_m, ref_l = ak.attention_reference_with_stats(q, k, v, None)
            fwd_err = check(f"{label} out", out, ref_out, dt)
            stat_err = max(check_stats(f"{label} m", m, ref_m),
                           check_stats(f"{label} l", l, ref_l))
            del out, m, l
            grads = ak.attention_bwd(q, k, v, None, ref_out, ref_m, ref_l, g)
            per_kernel = [1 + bf16, 1, 1]
            want = [n + x for n, x in zip(before, per_kernel + [x * deep for x in per_kernel])]
            if [c.launches for c in counters] + deep_counts(ak) != want:
                raise AssertionError(f"{label}: launches {[c.launches for c in counters]} + "
                                     f"deep {deep_counts(ak)} != {want}")
            repeats = (check_bwd_repeats(torch, ak, label, grads, q, k, v, None, ref_out, ref_m,
                                         ref_l, g) if bf16 else None)
            refs = ak.attention_bwd_reference(q, k, v, None, ref_out, ref_m, ref_l, g)
            errs = [check(f"{label} {x}", got, ref, dt)
                    for x, got, ref in zip(("dq", "dk", "dv"), grads, refs)]
            row = dict(phase="multimodal_attention", shape=name, dims=[b, t, s, h, d], dtype=dt,
                       design=ak.forward_design(q, k, v), max_abs_err=max([fwd_err] + errs),
                       fwd_max_abs_err=fwd_err, dq_max_abs_err=errs[0],
                       dkv_max_abs_err=max(errs[1:]), stats_max_rel_err=stat_err,
                       fwd_bit_identical=fwd_repeats, bwd_bit_identical=repeats,
                       row_s=time.perf_counter() - t_row)
            log(**row)
            rows.append(row)
            del q, k, v, g, grads, refs, ref_out, ref_m, ref_l
            gc.collect()
            torch.cuda.empty_cache()
        t_row = time.perf_counter()
        b = MM_TIME_BATCH
        gen = torch.Generator(device="cuda").manual_seed(t + s + d)
        q, g = (torch.randn(b, t, h, d, generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        out, m, l = ak.attention_fwd_with_stats(q, k, v, None)
        label = f"multimodal {name} bfloat16 B={b}"
        fwd_repeats = check_fwd_repeats(torch, ak, label, (out, m, l), q, k, v, None)
        grads = ak.attention_bwd(q, k, v, None, out, m, l, g)
        repeats = check_bwd_repeats(torch, ak, label, grads, q, k, v, None, out, m, l, g)
        del grads
        row = dict(phase="multimodal_attention", shape=name, dims=[b, t, s, h, d],
                   dtype="bfloat16", design=ak.forward_design(q, k, v), timed_only=True,
                   fwd_bit_identical=fwd_repeats, bwd_bit_identical=repeats,
                   **deep_timing(torch, ak, pat, q, k, v, g, None, m, l, out, "bfloat16",
                                 plain=False))
        row["row_s"] = time.perf_counter() - t_row
        log(**row)
        rows.append(row)
        del q, k, v, g, out, m, l
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def mm_patch_loss(torch, port, batch) -> dict:
    """``--video_patch_loss`` in f32 on the same weights (seed 0) and
    ``batch``: the patch-space loss against the pixel-space one within 1e-6
    relative, every gradient within 1e-5 of its leaf's peak."""
    mm = port["multimodal"]
    runs = []
    for patch in (False, True):
        model = mm_model(port, "float32", "pallas", patch)
        target = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
        out = model({"video": target["video"], "audio": target["audio"]})
        loss, _ = mm.multimodal_autoencoding_loss(out, target,
                                                  video_patch_info=mm.video_patch_info(model))
        loss.backward()
        runs.append((float(loss.detach()), {n: p.grad.detach().clone()
                                   for n, p in model.named_parameters()},
                     tuple(out["video"].shape)))
        del model, out, loss, target
        gc.collect()
        torch.cuda.empty_cache()
    (pixel, p_grads, p_shape), (patch, q_grads, q_shape) = runs
    worst, worst_name, symmetric = grads_apart(q_grads, p_grads)
    reading = dict(pixel_loss=pixel, patch_loss=patch, loss_rel_diff=abs(patch - pixel) / pixel,
                   grad_max_err_over_leaf_peak=worst, worst_leaf=worst_name,
                   k_proj_bias_over_global_peak=symmetric, pixel_video_shape=p_shape,
                   patch_video_shape=q_shape)
    if not (reading["loss_rel_diff"] <= 1e-6 and worst <= 1e-5 and symmetric < 1e-5
            and len(p_shape) == 5 and len(q_shape) == 3):
        raise AssertionError(f"phase 37 video_patch_loss: {reading}")
    return reading


def mm_route_windows(torch, port, steps, state, loader, root: str) -> dict:
    """The batch-8 bf16 step on each route of MM_ROUTES in turn, from the
    checked fit's state: every step's launches checked against the route
    (``'auto'``: ``auto_attention_impl`` call by call), then
    :func:`cli_windows` (clips/s over a WINDOW_STEPS window, device ms a
    step and the idle share of a profiled window) and the peak memory
    (``max_memory_allocated``) over them."""
    from types import SimpleNamespace

    ak, pat = port["ak"], port["pat"]
    counters = path_counters(port)
    readings = {}
    for impl in MM_ROUTES:
        use_attn_impl(state.model, port, impl)
        run = SimpleNamespace(train_step=steps[0], eval_step=steps[1], state=state)
        check_launches(run, counters, mm_launches(pat, impl), f"phase 37 {impl}")
        check_deep_launches(run, ak, f"phase 37 {impl}",
                            deep_per_step(mm_kernel_calls(pat, MM_TIME_BATCH, impl)[1]))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        windows = cli_windows(torch, port, run, loader, f"{root}/p37_{impl}",
                              f"multimodal_{impl}", per="examples")
        state = run.state
        readings[impl] = dict(**windows, peak_memory_bytes=torch.cuda.max_memory_allocated(),
                              kernel_calls_per_step=mm_kernel_calls(pat, MM_TIME_BATCH, impl))
    use_attn_impl(state.model, port, "pallas")
    return readings


def multimodal_phase(torch, port, root: str) -> dict:
    """Phase 37 (see the module docstring): ``train_multimodal`` at the
    CLI's defaults on the kernels; returns the checked fit's launches."""
    t_phase = time.perf_counter()
    ak, pat, tm = port["ak"], port["pat"], port["train_multimodal"]
    counters = path_counters(port)
    for c in counters + (ak.deep_counter, ak.dq_deep_counter, ak.dkv_deep_counter):
        c.reset()
    t0 = time.perf_counter()
    trainer, data = tm.prepare(P37_ARGS + ["--root", root, "--logdir", f"{root}/p37"])
    setup_s = time.perf_counter() - t0
    steps = (trainer.train_step, trainer.eval_step)
    check_launches(trainer, counters, mm_launches(pat, "pallas"), "phase 37")
    check_deep_launches(trainer, ak, "phase 37",
                        deep_per_step(mm_kernel_calls(pat, MM_TIME_BATCH, "pallas")[1]))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with trainer:
        trainer.fit(data.train_dataloader(), data.val_dataloader())
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_peak = torch.cuda.max_memory_allocated()
    launches = {n: c.launches for n, c in zip(KERNEL_NAMES, counters)}
    deep = dict(zip(("attention_fwd_deep", "attention_bwd_dq_deep", "attention_bwd_dkv_deep"),
                    deep_counts(ak)))
    rows = read_rows(trainer.run_dir)
    train = [r for r in rows if "train_loss" in r]
    val = [r for r in rows if "val_loss" in r]
    losses = [r["train_loss"] for r in train]
    metric_keys = {"video_loss", "audio_loss", "label_loss", "video_psnr", "train_acc", "lr"}
    if [r["step"] for r in train] != list(range(1, P37_STEPS + 1)) \
            or not all(metric_keys <= set(r) for r in train) \
            or [r["step"] for r in val] != [P37_STEPS] \
            or not all(math.isfinite(x) for x in losses + [val[0]["val_loss"]]):
        raise AssertionError(f"phase 37: rows {rows}")
    batches = [b for _, b in zip(range(3), data.train_dataloader())]
    routes = mm_route_windows(torch, port, steps, trainer.state, data.train_dataloader(), root)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    one = [{k: v[:MM_PARITY_BATCH] for k, v in b.items()} for b in batches]
    parity = f32_step_parity(torch, port, lambda: mm_model(port, "float32", "pallas"),
                             port["make_multimodal_steps"], one,
                             mm_kernel_calls(pat, MM_PARITY_BATCH, "pallas")[1], "phase 37")
    patch_loss = mm_patch_loss(torch, port, one[0])
    witness = lr_witness(torch, port, lambda impl: mm_model(port, "bfloat16", impl),
                         port["make_multimodal_steps"],
                         [b for _, b in zip(range(P37_WITNESS_STEPS), data.train_dataloader())],
                         mm_kernel_calls(pat, MM_TIME_BATCH, "pallas")[1], "phase 37",
                         port["OptimizerConfig"]())
    log(phase="multimodal", card=card_line(), steps=P37_STEPS, losses=losses,
        metrics_last={k: train[-1][k] for k in sorted(metric_keys)},
        val={k: v for k, v in val[0].items() if k.startswith("val_")}, launches=launches,
        deep_launches=deep,
        launches_per_step={k: v for k, v in mm_launches(pat, "pallas")(
            batches[0], True).items() if v},
        setup_s=setup_s, fit_s=fit_s,
        checked_fit_clips_per_s=[r["examples_per_sec"] for r in train],
        fit_peak_memory_bytes=fit_peak, routes=routes, f32_parity=parity,
        video_patch_loss=patch_loss, lr_witness=witness,
        phase_s=time.perf_counter() - t_phase)
    if not sum(losses[-3:]) / 3 < losses[0]:
        raise AssertionError(f"phase 37: the loss did not fall: {losses}")
    launches.update(deep)
    return launches


# phase 38: #1-#3 at head depth 1024 (ImageNet's one-head crosses) through
# deep_attention_phase, (T, S, H, D): the encoder cross (the latents over
# 224 x 224 pixels) and the decoder cross (the class query over the latents)
IN_SHAPES = (("in-enc-cross", (512, 50176, 1, 1024)),
             ("in-dec-cross", (1, 512, 1, 1024)))


def quarters_check(torch, ak) -> dict:
    """Phase 38: the four blocks of a D=1024 cluster add their shares of each
    logit tile in one fixed order, so all four form the same m, l, P and ds.
    bf16 at ImageNet's encoder cross (B=1, ~30% of keys padded), q random
    (its column quarters differ, so do the blocks' shares of S), k, v and g
    each one random quarter repeated four times: out's, dq's and dv's four
    column quarters must be bit for bit equal."""
    t, s, h, d = IN_SHAPES[0][1]
    gen = torch.Generator().manual_seed(d)
    pad = (torch.rand(1, s, generator=gen) < 0.3).cuda()
    q = torch.randn(1, t, h, d, generator=gen).to("cuda", torch.bfloat16)
    k, v = (torch.randn(1, s, h, d // 4, generator=gen).repeat(1, 1, 1, 4)
            .to("cuda", torch.bfloat16) for _ in range(2))
    g = torch.randn(1, t, h, d // 4, generator=gen).repeat(1, 1, 1, 4).to("cuda", torch.bfloat16)
    out, m, l = ak.attention_fwd_with_stats(q, k, v, pad)
    grads = ak.attention_bwd(q, k, v, pad, out, m, l, g)
    torch.cuda.synchronize()
    reading = {}
    for name, x in (("out", out), ("dq", grads[0]), ("dv", grads[2])):
        quarters = x.reshape(*x.shape[:-1], 4, d // 4)
        reading[f"{name}_quarters_equal"] = all(
            torch.equal(quarters[..., 0, :], quarters[..., i, :]) for i in range(1, 4))
    log(phase="imagenet_quarters", dims=[1, t, s, h, d], **reading)
    if not all(reading.values()):
        raise AssertionError(f"phase 38: the D=1024 cluster's quarters disagree: {reading}")
    return reading


# phase 39: train_imagenet at the Perceiver paper's width (the CLI's defaults:
# bf16, batch 64, remat), on the kernels. The CLI's AdamW 4e-3 blows the loss
# up within 5 steps (2.28 to 119 over the 8 checked steps), on the einsum
# path as on the kernels (the witness: 2.28, 6.76, 15.47, 20.71, 98.49 on
# 'xla', 2.28, 6.90, 15.55, 38.70, 39.12 on 'pallas'; PERF.md §6), so the
# checked fit takes 1e-4. Each call of one forward, (T, S, H, D) and its
# count; remat recomputes the encoder's in the backward
P39_STEPS, P39_IMAGES, P39_WITNESS_STEPS, P39_PARITY_BATCH = 8, 1024, 5, 1
P39_WITNESS_BATCH = 16
P39_ARGS = ["--synthetic", "--synthetic_size", str(P39_IMAGES), "--max_steps", str(P39_STEPS),
            "--eval_every_n_steps", str(P39_STEPS), "--log_every_n_steps", "1",
            "--attn_impl", "pallas", "--learning_rate", "1e-4", "--no_tensorboard"]
IN_CALLS = (("in-enc-cross", IN_SHAPES[0][1], 6),   # layer 1 and the shared layers 2..6
            ("in-self", (512, 512, 8, 128), 36),     # 6 self layers in each
            ("in-dec-cross", IN_SHAPES[1][1], 1))    # the class query
IN_ROUTES = ("pallas", "auto", "xla")


def in_launches(pat, b: int, impl: str, training: bool, remat: bool = True) -> tuple:
    """(#1, #2 = #3, deep #1, deep #2 = #3) launches of one ImageNet train
    step (``training``) or eval batch at batch ``b`` with every layer on
    ``impl``: ``'pallas'`` every call, ``'auto'`` the calls
    ``auto_attention_impl`` sends to the kernels, ``'xla'`` none; remat
    adds the encoder's calls again to #1 in a train step."""
    fwd = bwd = deep_fwd = deep_bwd = 0
    for name, (t, s, h, d), n in IN_CALLS:
        if not (impl == "pallas"
                or (impl == "auto" and pat.auto_attention_impl(b, t, s, h, d) == "pallas")):
            continue
        calls = n * (1 + (training and remat and name != "in-dec-cross"))
        fwd, bwd = fwd + calls, bwd + n * training
        if d >= 256:
            deep_fwd, deep_bwd = deep_fwd + calls, deep_bwd + n * training
    return fwd, bwd, deep_fwd, deep_bwd


def check_in_launches(run, port, impl: str, label: str, remat: bool = True) -> None:
    """Wrap ``run``'s steps: each train step and eval batch launches what
    :func:`in_launches` gives on ``impl``, all wgmma, no plain version, and
    as many on the deep designs."""
    ak, pat = port["ak"], port["pat"]

    def want(batch, training: bool) -> dict:
        fwd, bwd, _, _ = in_launches(pat, len(batch["label"]), impl, training, remat)
        counts = dict.fromkeys(KERNEL_NAMES, 0)
        counts.update(attention_fwd=fwd, attention_fwd_wgmma=fwd, attention_bwd_dq=bwd,
                      attention_bwd_dkv=bwd, attention_bwd_dq_wgmma=bwd,
                      attention_bwd_dkv_wgmma=bwd)
        return counts

    check_launches(run, path_counters(port), want, label)
    check_deep_launches(run, ak, label, want=lambda batch, training: [
        in_launches(pat, len(batch["label"]), impl, training, remat)[i] for i in (2, 3, 3)])


def in_model(port, dtype: str, attn_impl: str, extra=()):
    """The ImageNet classifier at the CLI's defaults (remat by its rule),
    weights from seed 0, the synthetic set's classes."""
    ti = port["train_imagenet"]
    args = ti.build_parser().parse_args(["--dtype", dtype, "--attn_impl", attn_impl, *extra])
    return ti.build_model(args, args.synthetic_classes, "cuda")


def in_optimizer(port):
    """The CLI's optimizer: AdamW 4e-3, weight decay 0.1."""
    args = port["train_imagenet"].build_parser().parse_args([])
    return port["OptimizerConfig"](optimizer=args.optimizer, learning_rate=args.learning_rate,
                                   weight_decay=args.weight_decay)


def in_steps(port):
    return lambda model, schedule: port["make_classifier_steps"](model, schedule,
                                                                 input_kind="image")


def in_route_windows(torch, port, steps, state, loader, root: str, b: int) -> dict:
    """The CLI's step on each route of IN_ROUTES in turn, from the checked
    fit's state: every step's launches checked against the route, then
    :func:`cli_windows` (images/s over a WINDOW_STEPS window, device ms a
    step and the idle share of a profiled window) and the peak memory
    (``max_memory_allocated``) over them. Every route fits the card at the
    CLI's batch (PERF.md); one that does not fails the phase."""
    from types import SimpleNamespace

    readings = {}
    for impl in IN_ROUTES:
        use_attn_impl(state.model, port, impl)
        run = SimpleNamespace(train_step=steps[0], eval_step=steps[1], state=state)
        check_in_launches(run, port, impl, f"phase 39 {impl}")
        state.optimizer.zero_grad(set_to_none=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        windows = cli_windows(torch, port, run, loader, f"{root}/p39_{impl}",
                              f"imagenet_{impl}", per="examples")
        readings[impl] = dict(**windows, peak_memory_bytes=torch.cuda.max_memory_allocated(),
                              kernel_calls_per_step=in_launches(port["pat"], b, impl, True))
        state = run.state
    use_attn_impl(state.model, port, "pallas")
    state.optimizer.zero_grad(set_to_none=True)
    return readings


def imagenet_phase(torch, port, root: str) -> dict:
    """Phase 39 (see the module docstring): ``train_imagenet`` at the CLI's
    defaults on the kernels; returns the checked fit's launches."""
    t_phase = time.perf_counter()
    ak, ti = port["ak"], port["train_imagenet"]
    counters = path_counters(port)
    for c in counters + (ak.deep_counter, ak.dq_deep_counter, ak.dkv_deep_counter):
        c.reset()
    t0 = time.perf_counter()
    trainer, data = ti.prepare(P39_ARGS + ["--root", root, "--logdir", f"{root}/p39"])
    setup_s = time.perf_counter() - t0
    steps = (trainer.train_step, trainer.eval_step)
    check_in_launches(trainer, port, "pallas", "phase 39")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with trainer:
        trainer.fit(data.train_dataloader(), data.val_dataloader())
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_peak = torch.cuda.max_memory_allocated()
    launches = {n: c.launches for n, c in zip(KERNEL_NAMES, counters)}
    deep = dict(zip(("attention_fwd_deep", "attention_bwd_dq_deep", "attention_bwd_dkv_deep"),
                    deep_counts(ak)))
    rows = read_rows(trainer.run_dir)
    train = [r for r in rows if "train_loss" in r]
    val = [r for r in rows if "val_loss" in r]
    losses = [r["train_loss"] for r in train]
    if [r["step"] for r in train] != list(range(1, P39_STEPS + 1)) \
            or not all({"train_acc", "lr"} <= set(r) for r in train) \
            or [r["step"] for r in val] != [P39_STEPS] or "val_acc" not in val[0] \
            or not all(math.isfinite(x) for x in losses + [val[0]["val_loss"]]):
        raise AssertionError(f"phase 39: rows {rows}")
    batches = [b for _, b in zip(range(3), data.train_dataloader())]
    batch_size = len(batches[0]["label"])
    routes = in_route_windows(torch, port, steps, trainer.state, data.train_dataloader(), root,
                              batch_size)
    del trainer, steps
    gc.collect()
    torch.cuda.empty_cache()
    one = [{k: v[:P39_PARITY_BATCH] for k, v in x.items()} for x in batches]
    parity = f32_step_parity(torch, port,
                             lambda: in_model(port, "float32", "pallas", ["--no_remat"]),
                             in_steps(port), one,
                             in_launches(port["pat"], P39_PARITY_BATCH, "pallas", True,
                                         False)[2], "phase 39")
    witness_batches = [{k: v[:P39_WITNESS_BATCH] for k, v in x.items()}
                       for _, x in zip(range(P39_WITNESS_STEPS), data.train_dataloader())]
    witness = lr_witness(torch, port, lambda impl: in_model(port, "bfloat16", impl),
                         in_steps(port), witness_batches,
                         in_launches(port["pat"], P39_WITNESS_BATCH, "pallas", True)[2],
                         "phase 39", in_optimizer(port))
    log(phase="imagenet", card=card_line(), steps=P39_STEPS, losses=losses,
        train_acc=[r["train_acc"] for r in train],
        val={k: v for k, v in val[0].items() if k.startswith("val_")}, launches=launches,
        deep_launches=deep,
        batch=batch_size, launches_per_step=dict(zip(
            ("fwd", "dq_dkv", "deep_fwd", "deep_dq_dkv"),
            in_launches(port["pat"], batch_size, "pallas", True))),
        setup_s=setup_s, fit_s=fit_s,
        checked_fit_images_per_s=[r["examples_per_sec"] for r in train],
        fit_peak_memory_bytes=fit_peak, routes=routes, f32_parity=parity,
        lr_witness=witness, phase_s=time.perf_counter() - t_phase)
    if not sum(losses[-3:]) / 3 < losses[0]:
        raise AssertionError(f"phase 39: the loss did not fall: {losses}")
    launches.update(deep)
    return launches


def check_kernel_entry(k: dict) -> None:
    """One entry of the ``kernels`` line carries every key of its contract,
    each of its type: times, errors and bounds are numbers, ``library_ms``
    a number or None, ``launches`` a count."""
    number = (int, float)
    ok = (isinstance(k.get("name"), str) and k.get("route") in ("cuda", "triton")
          and isinstance(k.get("source"), str) and isinstance(k.get("replaces"), str)
          and isinstance(k.get("launches"), int)
          and all(isinstance(k.get(f), number) and math.isfinite(k[f])
                  for f in ("max_abs_err", "ms", "plain_ms", "bound_ms"))
          and k.get("bound_by") in ("bytes", "operations")
          and "library_ms" in k and (k["library_ms"] is None
                                     or isinstance(k["library_ms"], number)))
    if not ok:
        raise AssertionError(f"kernels line entry breaks its contract: {k}")


def main() -> int:
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.execve(sys.executable, [sys.executable, os.path.abspath(__file__), *sys.argv[1:]],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    enter("import")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: failed in phase device: no CUDA device", flush=True)
        return 1
    from perceiver_io_torch.cli import (
        serve,
        train_ar,
        train_flow,
        train_imagenet,
        train_img_clf,
        train_mlm,
        train_multimodal,
        train_seq_clf,
    )
    from perceiver_io_torch.data.imdb import IMDBDataModule, synthetic_reviews
    from perceiver_io_torch.data.tokenizer import WordPieceTokenizer
    from perceiver_io_torch.inference.engine import MLMServer
    from perceiver_io_torch.inference.generate import ARGenerator, SamplingConfig
    from perceiver_io_torch.models import multimodal, presets
    from perceiver_io_torch.ops import attention as pat
    from perceiver_io_torch.ops import attention_kernel as ak
    from perceiver_io_torch.ops import build
    from perceiver_io_torch.ops import ce_kernel as ck
    from perceiver_io_torch.ops import packed_attention_kernel as pk
    from perceiver_io_torch.ops import qmatmul as qm
    from perceiver_io_torch.ops.attention import Linear, MultiHeadAttention
    from perceiver_io_torch.quant.int8 import QKernel, pack_int4, quantize_array
    from perceiver_io_torch.training.losses import softmax_ce_integer
    from perceiver_io_torch.training.optim import (
        SUPPORTED_OPTIMIZERS,
        OptimizerConfig,
        make_optimizer,
    )
    from perceiver_io_torch.data.tokenizer import load_tokenizer
    from perceiver_io_torch.interop import param_tree
    from perceiver_io_torch.training import checkpoint
    from perceiver_io_torch.training.steps import (
        make_ar_steps,
        make_classifier_steps,
        make_flow_steps,
        make_mlm_steps,
        make_multimodal_steps,
    )
    from perceiver_io_torch.training.train_state import TrainState
    from perceiver_io_torch.training.trainer import Trainer, TrainerConfig
    from perceiver_io_torch.utils.treepath import tree_digest

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    enter("build")
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    build.library()
    log(phase="build", build_s=time.perf_counter() - t0, library=build.library_path().name)

    enter("2: attention forward")
    entry_host_us(torch, build)
    attn_rows = attention_phase(torch, ak)
    enter("3: attention backward")
    bwd_rows = attention_bwd_phase(torch, ak)
    enter("4: dequant matmul")
    deq_rows = dequant_phase(torch, qm, QKernel, pack_int4, quantize_array)
    enter("5: CE kernels")
    clock_hz = sm_clock_hz()
    ce_rows = ce_phase(torch, ck, softmax_ce_integer, clock_hz)
    enter("13: packed attention kernels")
    packed_rows = packed_phase(torch, ak, pk, clock_hz)
    enter("17: causal attention kernel")
    ar_rows = ar_attention_phase(torch, ak)
    enter("20: causal attention backward kernels")
    ar_bwd_rows = ar_attention_bwd_phase(torch, ak)
    enter("24: einsum attention and the auto sweep")
    einsum_vs_kernels_f32(torch, ak, pat)
    auto_sweep_phase(torch, ak, pat)
    enter("35: deep-head attention kernels")
    deep_rows = deep_attention_phase(torch, ak, pat)
    one_key_sweep(torch, ak)

    enter("6: serving")
    trained = WordPieceTokenizer()
    trained.train_from_iterator(synthetic_reviews(2000, seed=0)[0], 10003)
    # the synthetic corpus yields a few hundred pieces; reserved entries fill
    # the vocab to the model's 10003 so every predicted id names a token
    vocab = dict(trained.vocab)
    vocab.update({f"[unused{i}]": i for i in range(len(vocab), 10003)})
    tokenizer = WordPieceTokenizer(vocab=vocab)
    texts = masked_texts(synthetic_reviews)
    port = dict(presets=presets, MLMServer=MLMServer, MultiHeadAttention=MultiHeadAttention,
                Linear=Linear, ak=ak, ck=ck, pk=pk, qm=qm, make_optimizer=make_optimizer,
                OptimizerConfig=OptimizerConfig, TrainState=TrainState,
                make_mlm_steps=make_mlm_steps, Trainer=Trainer, TrainerConfig=TrainerConfig,
                train_mlm=train_mlm, ARGenerator=ARGenerator, SamplingConfig=SamplingConfig,
                serve=serve, make_ar_steps=make_ar_steps, train_ar=train_ar, pat=pat,
                SUPPORTED_OPTIMIZERS=SUPPORTED_OPTIMIZERS, checkpoint=checkpoint,
                param_tree=param_tree, tree_digest=tree_digest, load_tokenizer=load_tokenizer,
                train_img_clf=train_img_clf, train_seq_clf=train_seq_clf,
                make_classifier_steps=make_classifier_steps, train_flow=train_flow,
                make_flow_steps=make_flow_steps, train_multimodal=train_multimodal,
                make_multimodal_steps=make_multimodal_steps, multimodal=multimodal,
                train_imagenet=train_imagenet)
    launches = serving_phase(torch, ak, qm, port, tokenizer, texts)
    enter("7: serving parity")
    plain_parity_phase(torch, ak, qm, port, tokenizer, texts)
    enter("18: AR generation, bf16")
    prompts = ar_prompts(tokenizer, synthetic_reviews)
    ar_launches = [ar_generation_phase(torch, ak, qm, port, prompts, "bfloat16")]
    ar_f32_parity(torch, port, prompts)
    with tempfile.TemporaryDirectory() as root:
        ar_cli_phase(torch, port, tokenizer, root)
    enter("19: AR generation, int8 weights")
    ar_launches.append(ar_generation_phase(torch, ak, qm, port, prompts, "int8w"))

    with tempfile.TemporaryDirectory() as root:
        data = IMDBDataModule(root=root, max_seq_len=SEQ_LEN, vocab_size=10003,
                              batch_size=TRAIN_BATCH, synthetic=True, seed=0)
        data.prepare_data()
        data.setup()
        enter("8: flagship training")
        path_launches = [training_phase(torch, port, data, f"{root}/logs")]
        enter("9: flagship training parity")
        train_parity_phase(torch, port, data)
        bf16_train_parity(torch, port, data)
        enter("5: CE kernels, gathered layout")
        ce_rows += ce_gathered_phase(torch, ck, port, data, softmax_ce_integer, clock_hz)
        enter("10: C=64 training, fused head")
        path_launches.append(training_phase(torch, port, data, f"{root}/logs_c64",
                                            "flagship_mlm", "pallas"))
        enter("11: training CLI")
        cli_phase(torch, port, root, data.tokenizer.get_vocab_size())
        enter("12: C=64 training parity")
        train_parity_phase(torch, port, data, "flagship_mlm", "pallas")
        enter("14: C=64 training, packed attention")
        path_launches.append(training_phase(torch, port, data, f"{root}/logs_packed",
                                            "flagship_mlm", "pallas", "packed"))
        enter("15: packed training parity")
        train_parity_phase(torch, port, data, "flagship_mlm", "pallas", "packed")
        enter("16: packed entry points")
        cli_phase(torch, port, root, data.tokenizer.get_vocab_size(), "packed")
        enter("21: AR training")
        ar_train = ar_batches(data, data.ds_train.texts)
        ar_val = ar_batches(data, data.ds_valid.texts, drop_last=False)
        path_launches.append(ar_training_phase(torch, port, ar_train, ar_val, f"{root}/logs_ar"))
        enter("22: AR training parity")
        ar_train_parity_phase(torch, port, ar_train)
        enter("23: AR training CLI")
        ar_train_cli_phase(torch, port, root, data.tokenizer.get_vocab_size())
        enter("25: MLM CLI, flagship_tpu with the JAX defaults")
        mlm_flagship_cli_phase(torch, port, root)
        enter("26: MLM CLI, reference with the JAX defaults")
        path_launches.append(reference_cli_phase(torch, port, root))
        enter("27: AR CLI with the JAX defaults")
        ar_cli_defaults_phase(torch, port, root, ar_train, ar_val)
        enter("28: einsum, remat and dropout parity")
        xla_parity_phase(torch, port, data)
        qkv_turns_phase(torch, port)
        enter("29: preemption and resume")
        p29_launches, run_a, snapshots, best = preemption_phase(torch, port, root)
        path_launches.append(p29_launches)
        enter("30: serving from a checkpoint")
        ar_launches.append(checkpoint_serving_phase(torch, port, root, run_a, snapshots, best,
                                                    texts))
        p29_checkpoints = f"{run_a.run_dir}/checkpoints"
        del run_a, snapshots
        gc.collect()
        torch.cuda.empty_cache()
        enter("31: bucketed AR training with the sample hook")
        path_launches.append(bucketed_ar_phase(torch, port, root))
        enter("32: recovery")
        path_launches.append(recovery_phase(torch, port, root))
        gc.collect()
        torch.cuda.empty_cache()
        enter("33: MNIST image classification")
        path_launches.append(image_classification_phase(torch, port, root))
        gc.collect()
        torch.cuda.empty_cache()
        enter("34: sequence classification and transfer")
        path_launches.append(sequence_classification_phase(torch, port, root, p29_checkpoints))
        gc.collect()
        torch.cuda.empty_cache()
        enter("36: optical flow at the paper's width")
        flow_launches_run = flow_phase(torch, port, root)
        path_launches.append(flow_launches_run)
        gc.collect()
        torch.cuda.empty_cache()
        enter("37: multimodal autoencoding at the paper's width")
        multimodal_attention_phase(torch, ak, pat)
        mm_launches_run = multimodal_phase(torch, port, root)
        path_launches.append(mm_launches_run)
        gc.collect()
        torch.cuda.empty_cache()
        enter("38: attention kernels at head depth 1024")
        in_rows = deep_attention_phase(torch, ak, pat, IN_SHAPES)
        quarters_check(torch, ak)
        gc.collect()
        torch.cuda.empty_cache()
        enter("39: ImageNet classification at the paper's width")
        in_launches_run = imagenet_phase(torch, port, root)
        path_launches.append(in_launches_run)
    enter("16: packed serving")
    path_launches.append(packed_serving_phase(torch, port, tokenizer, texts))
    enter("kernels line")
    for name in AR_NAMES:
        launches[name] = launches.get(name, 0) + sum(p.get(name, 0) for p in path_launches)
    for name in ("attention_fwd", "attention_fwd_wgmma", "attention_fwd_causal",
                 "dequant_matmul", "dequant_matmul_wgmma"):
        launches[name] = launches.get(name, 0) + sum(p[name] for p in ar_launches)

    def entry(rows, name, source, replaces, pick, ms="device_ms", bound="bound",
              library="library_device_ms", event="kernel_ms"):
        """A kernel's row: ms and library_ms are device times (torch.profiler),
        which the host's enqueue of a short kernel does not inflate, or the
        CUDA-event times where the profiler gave none (ms_source says which);
        event_ms is the CUDA-event time of a call through the wrapper."""
        row = next(r for r in rows if pick(r))
        if row[ms] is None or row[library] is None:
            ms, library = event, "library_ms"
        extra = {"design": row["design"], "event_ms": row[event],
                 "ms_source": "event" if ms == event else "device"}
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches[name], max_abs_err=row["max_abs_err"], ms=row[ms],
                    plain_ms=row["plain_ms"], bound_ms=row[f"{bound}_ms"],
                    bound_by=row[f"{bound}_by"], library_ms=row[library],
                    shape=row["shape"], dims=row["dims"], dtype=row["dtype"], **extra)

    enc_bf16 = lambda r: r["shape"] == "enc_cross" and r["dtype"] == "bfloat16"  # noqa: E731
    ar_cross = lambda r: r["shape"] == "ar_cross" and r["dtype"] == "bfloat16"  # noqa: E731
    proj_bf16 = lambda r: (r["shape"] == "self_proj" and r["quant"] == "int8"  # noqa: E731
                           and r["dtype"] == "bfloat16")
    bwd_src = "perceiver_io_torch/csrc/attention_bwd.cu"
    fwd_src, deq_src = ("perceiver_io_torch/csrc/attention_fwd.cu",
                        "perceiver_io_torch/csrc/dequant_matmul.cu")
    # the main paths run bf16: every launch of #1-#9 there is a wgmma one
    for name in ("attention_fwd", "attention_bwd_dq", "attention_bwd_dkv", "dequant_matmul",
                 "packed_attention_fwd", "packed_attention_bwd_dq", "packed_attention_bwd_dkv",
                 "linear_ce_fwd", "linear_ce_bwd_dx", "linear_ce_bwd_dw"):
        if launches[f"{name}_wgmma"] != launches[name]:
            raise AssertionError(f"{name}: {launches[f'{name}_wgmma']} of {launches[name]} "
                                 f"main-path launches took the wgmma design")
    # plain_ms and library_ms of the two backward kernels are those of the
    # whole backward (the plain version and SDPA compute dq, dk, dv in one
    # call); ms and the bound are each kernel's own
    dq = dict(ms="dq_device_ms", bound="dq_bound", event="dq_ms")
    dkv = dict(ms="dkv_device_ms", bound="dkv_bound", event="dkv_ms")
    tpu_attn = "perceiver_io_tpu/ops/pallas_attention.py:{}"
    kernels = [
        entry(attn_rows, "attention_fwd", fwd_src, tpu_attn.format(245), enc_bf16),
        entry(attn_rows, "attention_fwd_wgmma", fwd_src, tpu_attn.format(194), enc_bf16),
        # the causal offset (_causal_bias, added in _attention_kernel): bf16 at
        # the W=512 prefill cross; its launches are the AR path's causal ones
        entry(ar_rows, "attention_fwd_causal", fwd_src, tpu_attn.format(181),
              lambda r: r["shape"] == "ar_cross_512" and r["dtype"] == "bfloat16"),
        entry(bwd_rows, "attention_bwd_dq", bwd_src, tpu_attn.format(402), enc_bf16, **dq),
        entry(bwd_rows, "attention_bwd_dq_wgmma", bwd_src, tpu_attn.format(331), enc_bf16,
              **dq),
        entry(bwd_rows, "attention_bwd_dkv", bwd_src, tpu_attn.format(424), enc_bf16, **dkv),
        entry(bwd_rows, "attention_bwd_dkv_wgmma", bwd_src, tpu_attn.format(352), enc_bf16,
              **dkv),
        # the causal offset of the backward (_recompute_probs_and_ds with
        # causal_offset, called from each backward kernel): bf16 at the AR
        # training cross; its launches are the AR training path's causal ones
        entry(ar_bwd_rows, "attention_bwd_dq_causal", bwd_src, tpu_attn.format(342), ar_cross,
              **dq),
        entry(ar_bwd_rows, "attention_bwd_dkv_causal", bwd_src, tpu_attn.format(364), ar_cross,
              **dkv),
        entry(deq_rows, "dequant_matmul", deq_src, "perceiver_io_tpu/ops/pallas_matmul.py:163",
              proj_bf16),
        entry(deq_rows, "dequant_matmul_wgmma", deq_src,
              "perceiver_io_tpu/ops/pallas_matmul.py:125", proj_bf16),
    ]
    # the CE kernels at bench.py's head (the scalar designs in f32, the
    # wgmma ones in bf16), the packed kernels at the C=64 encoder cross in bf16;
    # plain_ms and library_ms of the backward kernels are those of the whole
    # backward (the plain version and the library's autograd compute every
    # gradient in one call); ms and library_ms are device times
    # (torch.profiler) where the profiler gave both, else CUDA-event times
    # (ms_source)
    head = next(r for r in ce_rows if r["shape"] == "bench_head" and r["dtype"] == "bfloat16")
    head32 = next(r for r in ce_rows if r["shape"] == "bench_head" and r["dtype"] == "float32")
    cross = next(r for r in packed_rows if enc_bf16(r))
    cross["dkv_max_abs_err"] = max(cross["dk_max_abs_err"], cross["dv_max_abs_err"])
    packed_src = "perceiver_io_torch/csrc/packed_attention.cu"
    ce_src = "perceiver_io_torch/csrc/linear_ce_{}.cu"
    for name, row, part, source, replaces in (
            ("linear_ce_fwd", head32, "fwd", ce_src.format("fwd"), "pallas_ce.py:206"),
            ("linear_ce_fwd_wgmma", head, "fwd", ce_src.format("fwd"), "pallas_ce.py:95"),
            ("linear_ce_bwd_dx", head32, "dx", ce_src.format("bwd"), "pallas_ce.py:248"),
            ("linear_ce_bwd_dw", head32, "dw", ce_src.format("bwd"), "pallas_ce.py:270"),
            ("linear_ce_bwd_dx_wgmma", head, "dx", ce_src.format("bwd"), "pallas_ce.py:143"),
            ("linear_ce_bwd_dw_wgmma", head, "dw", ce_src.format("bwd"), "pallas_ce.py:161"),
            ("packed_attention_fwd", cross, "fwd", packed_src, "pallas_attention.py:783"),
            ("packed_attention_bwd_dq", cross, "dq", packed_src, "pallas_attention.py:804"),
            ("packed_attention_bwd_dkv", cross, "dkv", packed_src, "pallas_attention.py:804"),
            ("packed_attention_fwd_wgmma", cross, "fwd", packed_src, "pallas_attention.py:843"),
            ("packed_attention_bwd_dq_wgmma", cross, "dq", packed_src,
             "pallas_attention.py:866"),
            ("packed_attention_bwd_dkv_wgmma", cross, "dkv", packed_src,
             "pallas_attention.py:866")):
        way = "fwd" if part == "fwd" else "bwd"
        device = row[f"{part}_device_ms"] is not None \
            and row[f"library_{way}_device_ms"] is not None
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=f"perceiver_io_tpu/ops/{replaces}",
            launches=launches[name], max_abs_err=row[f"{part}_max_abs_err"],
            ms=row[f"{part}_device_ms" if device else f"{part}_ms"],
            plain_ms=row[f"plain_{way}_ms"],
            bound_ms=row[f"{part}_bound_ms"], bound_by=row[f"{part}_bound_by"],
            library_ms=row[f"library_{way}_device_ms" if device else f"library_{way}_ms"],
            shape=row["shape"], dims=row["dims"], dtype=row["dtype"],
            design=row["design"],
            event_ms=row[f"{part}_ms"], ms_source="device" if device else "event"))
    # the deep designs (D = 256, 512) at the flow encoder's cross, bf16, B=2
    # with padding (phase 35; CUDA-event times: the profiler misses part of
    # a cluster's launch); launches: phases 36's and 37's checked fits
    deep_row = next(r for r in deep_rows if r["shape"] == "flow-cross"
                    and r["dtype"] == "bfloat16" and r["causal_offset"] is None
                    and not r.get("timed_only"))
    deep_src = "perceiver_io_torch/csrc/attention_deep.cu"
    for name, part, way, site in (("attention_fwd_deep", "fwd", "fwd", 272),
                                  ("attention_bwd_dq_deep", "dq", "bwd", 402),
                                  ("attention_bwd_dkv_deep", "dkv", "bwd", 424)):
        kernels.append(dict(
            name=name, route="cuda", source=deep_src, replaces=tpu_attn.format(site),
            launches=flow_launches_run[name] + mm_launches_run[name],
            max_abs_err=deep_row[f"{part}_max_abs_err"], ms=deep_row[f"{part}_ms"],
            plain_ms=deep_row[f"plain_{way}_ms"], bound_ms=deep_row[f"{part}_bound_ms"],
            bound_by=deep_row[f"{part}_bound_by"], library_ms=deep_row[f"library_{way}_ms"],
            library=deep_row["library"], shape=deep_row["shape"], dims=deep_row["dims"],
            dtype=deep_row["dtype"], design=DEEP_DESIGNS[part],
            event_ms=deep_row[f"{part}_ms"], ms_source="event"))
    # the D=1024 design at ImageNet's encoder cross, bf16, B=2 with padding
    # (phase 38; CUDA-event times: the profiler misses part of a cluster's
    # launch); launches: phase 39's checked fit
    in_row = next(r for r in in_rows if r["shape"] == "in-enc-cross"
                  and r["dtype"] == "bfloat16" and r["causal_offset"] is None
                  and not r.get("timed_only"))
    for name, part, way, site in (("attention_fwd_deep_d1024", "fwd", "fwd", 272),
                                  ("attention_bwd_dq_deep_d1024", "dq", "bwd", 402),
                                  ("attention_bwd_dkv_deep_d1024", "dkv", "bwd", 424)):
        counted = name.replace("_d1024", "")
        kernels.append(dict(
            name=name, route="cuda", source=deep_src, replaces=tpu_attn.format(site),
            launches=in_launches_run[counted], max_abs_err=in_row[f"{part}_max_abs_err"],
            ms=in_row[f"{part}_ms"], plain_ms=in_row[f"plain_{way}_ms"],
            bound_ms=in_row[f"{part}_bound_ms"], bound_by=in_row[f"{part}_bound_by"],
            library_ms=in_row[f"library_{way}_ms"], library=in_row["library"],
            shape=in_row["shape"], dims=in_row["dims"], dtype=in_row["dtype"],
            design=IN_DESIGNS[part], event_ms=in_row[f"{part}_ms"], ms_source="event"))
    missing = [k["name"] for k in kernels if not k["launches"]]
    if missing:
        raise AssertionError(f"kernels the main paths never launched: {missing}")
    for k in kernels:
        check_kernel_entry(k)
    enter("done")
    log(phase="done", total_s=time.perf_counter() - t_start, phase_s=phase_seconds)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:
        first = (str(exc).splitlines() or [""])[0][:300]
        print(f"chip_smoke: failed in phase {phase_name}: {type(exc).__name__}: {first}",
              flush=True)
        raise
