#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mxnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--out results.json]
    python3 chip_smoke.py --only f32_lm --package DIR  # phase 19 and 8 on another tree
    python3 chip_smoke.py --only rtc --package DIR     # K5's push path on another tree
    python3 chip_smoke.py --only slab --package DIR    # phases 16-18 and K1's times there
    python3 chip_smoke.py --only zoo                   # K2/K3's build and all of phase 20
    python3 chip_smoke.py --only multistep [--package DIR]  # K1-K3's build and phase 21
    python3 chip_smoke.py --only serving [--package DIR]  # K4f's build and phase 22
    python3 chip_smoke.py --only resilience            # K1-K3's build and phase 23
    python3 chip_smoke.py --only input                 # K1-K3's build and phase 24
    python3 chip_smoke.py --only rnn                   # the flash kernels' build and phase 25
    python3 chip_smoke.py --only mirror                # K1-K3's build, phase 26 and its sweep
    python3 chip_smoke.py --only parallel              # the flash kernels' build and phase 27
    python3 chip_smoke.py --only telemetry             # K1-K3's build and all of phase 28
    python3 chip_smoke.py --only detection             # K1-K3's and NMS's build and phase 29
    python3 chip_smoke.py --only dist                  # K1-K3's build and phase 30 with (d)
    python3 chip_smoke.py --only axes                  # the flash kernels' build and phase 31
    python3 chip_smoke.py --only pp                    # the flash kernels' build, 31's pp leg
    python3 chip_smoke.py --only cpp                   # K2/K3's build and phase 32
    python3 chip_smoke.py --only examples              # K2/K3's build and phase 33


Phases, each fatal on failure:

1. device: the card's name and power limit; build every CUDA kernel from
   the sources in this checkout (nvcc, sm_90a, one process per source, all
   started together) and time the build; ptxas's registers and spills of
   each kernel. Then ``cuobjdump -sass`` (beside nvcc) of the flash and
   conv libraries, read by function: every flash kernel, bf16 and split
   f32, and every bf16 and f32 K2 and K3 kernel (flash_fwd_sm90,
   flash_fwd_split_sm90 at D 16-128, flash_dq_sm90 and flash_dkv_sm90 at
   D 16-128 on one bf16 plane or the hi and lo planes of split f32;
   conv_wgrad_sm90 and conv_dgrad_sm90 at 64
   and 128 channels a tile, on one bf16 plane or the hi and lo planes of
   split f32, K2 in CTAs of one and two warpgroups, reading channels-last
   copies or, bf16 only, NCHW in place) holds HGMMA (wgmma) and UTMALDG
   (TMA load) instructions; no SIMT flash kernel and no SIMT filter- or
   data-gradient kernel of any type is left.
2. forward kernel vs plain: the flash-attention forward kernels against
   their plain PyTorch version on the card, f32 to 1e-4 and bf16 to 2e-2
   (the plain version rounds its scores to bf16; the bf16 kernel keeps them
   in f32 and rounds P to bf16 before P·V), D 16 to 128, T 7 to 2048,
   contiguous operands and transposed views of [B, H, T, D] tensors (which
   TMA reads in place), and in f32 at FLASH_DEEP (T 4096 and 8192, D 64
   and 128, causal and not, n·H 1-2); a second launch gives the same bits.
   The split pass of the f32 kernels (``split_planes``) is bit for bit
   ``split_bf16`` on the training path's four operands and on a
   [B, H, T, D] view, and repeatable.
3. backward kernels vs plain: dq and dk/dv kernels against
   ``reference_attention_bwd`` on the same q, k, v, dO, lse and delta, for
   T in 7..2048, D 16 to 128, causal or not, f32 and bf16, contiguous
   and as [B, H, T, D] views, and in f32 at FLASH_DEEP; error relative
   to max|plain| at most 1e-4 in f32 (the split f32 dq and dk/dv kernels
   take three bf16 products of hi and lo planes for each f32 one, split
   dS, Pᵀ and dSᵀ into hi and lo planes in registers, and add each K/V
   tile's (dq) or q tile's (dk, dv) products into the sum after a zeroed
   partial, so the error does not grow with T) and 2e-2 in
   bf16 (the outputs differ by about one bf16 rounding, 2^-8 relative, and
   the bf16 kernels round dS to bf16 before dS·K, and P^T and dS^T before
   P^T·dO and dS^T·Q); and a second launch on the same inputs gives the
   same bits.
4. serving, f32: the full-width transformer LM at depth 2; prefill
   last-token logits through the kernel agree with the same forward
   through the plain attention at rtol = atol = 1e-3.
5. training, f32: the full-width LM at depth 2, batch 2, T 1000: loss and
   backward through the three kernels against the same with the plain
   attention; every parameter gradient agrees at rtol = atol = 1e-3 of its
   max|.| (the embedding's gradient is accumulated with atomics, so it is
   not bitwise stable); each kernel ran twice.
6. serving, bf16 (main path 1): the full model (vocab 32000, d_model 1024,
   16 heads, 12 layers, d_ff 4096, KV window 2048, 4 slots) behind a
   GenerationEngine on the card (its decode step one captured CUDA
   graph); 8 requests of 32 new tokens each. The
   kernel launch counts are zeroed just before and read just after: the
   flash kernel must have run n_layers times per prefill dispatch.
7. training, bf16 (main path 2): 10 SGD steps of the example trainer
   ``train(...)`` on the full model (batch 8, T 2047, f32 masters) on one
   batch of its corpus: every loss finite, the last below the first, and
   the forward, dq and dk/dv kernels each launched exactly n_layers times
   per step (counts zeroed just before); step ms, tokens/s, peak memory.
   Phase 19 (main path 6) is the same in f32, the trainer's default.
8. attention kernel times: per flash kernel its launches on the main
   paths, error against the plain version, time (``ms``: CUDA events
   around one call, median, L2 flushed before each, so the host's enqueue
   of the call shows where the card would wait for it), the plain
   version's time, the least time
   the card could take (bytes at 3.35 TB/s or operations at 989 TFLOP/s,
   H100 SXM data sheet) and one PyTorch call computing the same function
   as a yardstick the port never calls (scaled_dot_product_attention, and
   its backward for dq, dk and dv together). Beside them, for the kernel
   and for that call: ``device_ms``, the same span with a ~0.5 ms sleep
   kernel queued first, so the events time the card alone, and
   ``host_ms``, the host's time to enqueue one call. The same for the f32
   kernels (three bf16 products of split planes, the split pass inside
   each standalone call and its own ``split_device_ms`` beside) at T 2048
   and at the training path's shape, against f32
   scaled_dot_product_attention (TF32 off), under each entry's ``f32``
   (and ``f32_shapes``) key, their bound counted as for f32 K2 and K3
   (phase 12); beside the backward's, ``pair``: dq and dk/dv as the
   autograd backward runs them, on the planes of one split pass, against
   f32 SDPA's backward.
9. conv-backward kernels vs plain: K2 (conv_bwd_filter) and K3
   (conv_bwd_input) against their plain versions on every distinct
   in-envelope convolution shape of ResNet-50 at batch 32 (from
   ``infer_shape``) and on ragged small shapes (N 1 to 3, H x W 7 x 7 to
   17 x 17, k 1/3/5, 1 x 7 and 3 x 1, pad 0-3, C and O 8-512, 24 in and
   out), f32 and bf16, and in f32 on the shapes whose sums are the longest
   (``CONV_DEEP``: ResNet-50's at batch 256, AlexNet's conv2 at 512): the f32
   outputs before any cast within 1e-4 of max|plain| (bf16 products are
   exact in f32 and summed in another order; an f32 product is taken as
   three bf16 products of its hi and lo planes, about 5e-6 of max), and a
   second launch gives the same bits. grad's channels-last copy (f32: its
   two planes) made once and handed to both kernels (``g_cl``), and the
   autograd Function's backward that does so, give the standalone
   wrappers' bits.
10. ResNet-50 gradients, f32: full width and depth, batch 2, 224 x 224,
    weights from ``init_params``: every parameter gradient and new aux
    state through K2/K3 against the same through their plain versions, at
    rtol = atol = 1e-3 of each tensor's max|.|; each kernel ran 46 times.
    A tensor that two runs of the plain path do not reproduce to 1e-3 of
    its max (bn0_gamma: a cancelling sum, moved by ops outside K2/K3 that
    are not bitwise repeatable) is held to three times that spread.
11. ResNet-50 training (main path 3): ``tools/resnet_bench.py``'s step
    (bench.py's SGD-momentum step) at batch 32, one warm-up and 5 steps on
    one fixed random batch, in f32 (TF32 off) and in bf16: every loss
    (the cross-entropy of the softmax output) finite, the last below the
    first, K2 and K3 each launched exactly 46 times a step (counts zeroed
    just before); step ms, img/s, model TFLOP/s, peak memory.
12. conv kernel times: K2, K3, their plain versions and the library calls
    (``torch.nn.grad.conv2d_weight`` / ``conv2d_input``, which the port
    never calls) at every distinct in-envelope ResNet-50 shape at batch
    32, bf16 and f32, each kernel and library call also as ``device_ms``
    (after a sleep kernel: the card alone) and the kernel's ``host_ms``
    (the host's enqueue of one call); the launch-weighted total a step;
    the kernels-line entry at the shape where the kernel spends the most
    of a bf16 step, with bound = max(bytes / 3.35 TB/s, 2·N·OH·OW·O·C·kh·kw
    / 989 TFLOP/s); in f32, the bytes of f32 inputs and three times the
    operations at the bf16 rate (each f32 product is three bf16 ones,
    ``bound_counts``).

13. Rtc (kernel K5, CUDA C through NVRTC): the kernel bodies of
    ``rtc_kernels`` — (a) y = 2x + 1, (b) a·b + a, (c) exp(5x) through
    shared memory with ``block_dims=(n, 1, 1)`` — at tests/test_rtc.py's
    sizes (8 x 128, 4 x 128) and at 32 x 64 x 112 x 112, f32 and bf16,
    against their plain versions: f32 within rtol 1e-6 (FMA contraction),
    bf16 within one bf16 ulp; a second push gives the same bits. The cache
    holds 1, then 1, then 2 entries; a bad source and a wrong array count
    each raise MXNetError.
14. Executor at full width: ResNet-50 (1000 classes) bound with
    ``simple_bind(mx.gpu(0), data=(32, 3, 224, 224))`` in f32, TF32 off,
    with phase 11's weights and batch; ``forward(is_train=True)`` and
    ``backward()`` against ``resnet_bench.make_train_step``'s step on the
    same program: every gradient (as the step's first momentum, −lr·(g/32 +
    wd·p)) and new aux state within 1e-6 of its max; 46 launches of K2 and
    of K3 in the backward. Phases 14 and 15 run cuDNN deterministic: its
    default backward of the 7 strided convolutions sums in a run-dependent
    order, which moves cancelling sums such as bn_data_beta's gradient by
    ~2e-5 of their max between two runs.
15. Training through Executor and Rtc (main path 4): six steps of
    forward / backward, then kernel (d) (``rtc_kernels.sgd_mom_source``,
    bench.py's lr 0.1, momentum 0.9, wd 1e-4, rescale 1/32) pushed on
    every parameter NDArray; the same six steps on a second executor with
    ``mx.nd.sgd_mom_update``. Parameters agree within 1e-5 of each tensor's
    max, the loss falls, K5 ran once per parameter array a step, K2 and K3
    46 times a step (counts zeroed just before), and NVRTC compiled once
    per distinct parameter shape, none after step 1. Then the times of a
    step's kernel (d) launches and of the plain updates (CUDA events, L2
    flushed before each step), the bound (20 bytes an element at 3.35
    TB/s) and NVRTC ms per compile; ``host_ms``, the host's enqueue of one
    push and (``host_ms_step``) of the step's pushes, and ``device_ms``,
    the card's time for the step's launches (a sleep kernel queued first,
    long enough to cover the enqueue); one launch on the largest parameter
    array against its bound; phase 14's forward + backward ms.

16. Optimizer-slab kernel K1 against its plain version: one slab
    (``fused_slab_update``, a table of one) for sgd, sgd_mom and adam, bf16
    and f32 gradients, clipping on and off, a finite and a skipped step, at
    S = 131, 1024, 5000, 2,359,296 and every bucket size of ResNet-50's AMP
    plan at dp 4; then tables in one call (``fused_slab_update_multi``):
    ResNet-50's 16 buckets and seven slabs of 1-7 elements at offsets 1-3
    off the 16-byte boundary, each with its own lr (one a device tensor)
    and wd, for each kind and gradient type, finite and skipped, with and
    without clipping, and replicated mode's 64 dp chunks of the buckets with
    the small slabs (71 slabs, three launches): master, states and the bf16
    copy bit for bit (the kernel rounds each operation once, as each
    PyTorch op of the plain version does), a skipped step returns its
    inputs bit for bit, a repeat gives the same bits, a call takes one
    launch a table of up to 32 slabs; one launch
    of each wrapper under ``torch.cuda.set_sync_debug_mode("error")`` (the
    table's in place, with host lrs, as the trainer makes it) shows neither
    waits for the device. Then K1's kernels-line entry: one step's update
    over ResNet-50's 16 buckets as the trainer hands it over (sgd_mom, bf16
    gradient, in place): ``ms`` (CUDA events, L2 flushed), ``device_ms``
    (after a sleep kernel), ``host_ms`` (the enqueue), the plain version's
    device ms, the bound (20 bytes an element at 3.35 TB/s) in total and a
    bucket beside each bucket's one-slab call, the card time of K1 in phase
    17's profile, and the trainer's whole AMP update
    (``_apply_optimizer_flat_amp`` on phase 17's plan: gradient slabs,
    finite flag, K1, loss scaler) timed the same way. ``--only slab`` runs
    the build of K1, phases 16-18 and this entry on any tree's package
    (``--package``; a tree without the table wrapper takes one call a
    bucket), so that a parent and a change are timed in one call.
17. ResNet-50 through ``Module.fit`` with bf16 AMP (main path 5): the
    imagenet ResNet-50 at batch 32, ``Module(context=mx.gpu(0),
    mesh=make_mesh(dp=4, devices=[mx.gpu(0)] * 4))``, ``kvstore="device"``,
    SGD (lr 0.1, momentum 0.9, wd 1e-4), Xavier, ``MXTPU_AMP=bf16``, over an
    NDArrayIter of 8 seeded batches: AMP on and the flat update in shard
    mode; K1 launched once a step over the 16 buckets, K2 and K3 46 times a
    step (counts zeroed just before ``fit``); every working param bf16 and
    equal to bf16(master), ``get_params`` f32 and equal to the masters;
    every loss finite, the loss scale unchanged and the good count 8. Then a
    batch poisoned with inf (one K1 launch) leaves params, masters and
    states bit for bit, halves the scale and zeroes the count, and a clean
    step after it updates. Step ms (median of steps 3-8), img/s, peak
    memory; then two more steps under torch.profiler: wall and device-busy
    ms a step, the idle share, kernels a step and device ms per kernel
    family.
18. Convergence on the card (the verify skill's drive 1): 10 seeded
    gaussian blobs in 784 dimensions, ``models/mlp.py``, 3 epochs; (a) on
    ``gpu(0)`` with ``kvstore="local"`` (the executor-group path), (b) on
    the dp 4 mesh with AMP and Adam (K1's adam variant, one launch a step):
    validation accuracy at least 0.97 in both.

19. training, f32 (main path 6; run after phase 7): phase 7 with the
    trainer's default dtype, f32 (the same full model, batch 8, T 2047,
    10 SGD steps on one batch): every loss finite, the last below the
    first, the forward, dq and dk/dv kernels each launched exactly
    n_layers times a step and the split pass twice as often (one for each
    forward and one for each backward, whose dq and dk/dv kernels share
    it); step ms (median of the steps before the last two), tokens/s, peak
    memory; the last two steps run under torch.profiler: wall and
    device-busy ms a step, the idle share, and device ms a step per kernel
    family (the split pass, the three flash kernels, f32 GEMMs, reductions,
    elementwise).

20. the image-classification zoo (main path 7): (a) K2 and K3 against their
    plain versions, as in phase 9, on every distinct in-envelope convolution
    shape of alexnet (batch 512), vgg-16, googlenet, inception-bn,
    inception-v3, inception-resnet-v2 and resnext-50 (batch 32) at their
    published image sides, f32, and bf16 under ``--only zoo`` (phase 9
    holds bf16 K2/K3 on ResNet-50's shapes in the full script;
    ``conv_checks.s_by_dtype`` times each dtype) (non-square 1 x 7 / 7 x 1 / 1 x 3 /
    3 x 1 kernels, sides 147 to 8 that are not multiples of K2/K3's 8 x 8
    patch, 1 x 1 convolutions whose OH·OW is not a multiple of 8, 24
    channels); (b) f32 gradients of inception-v3 and alexnet at full width,
    batch 8, through K2/K3 against their plain versions, as phase 10 holds
    ResNet-50's; (c) the model sweep's step (``tools/model_sweep.py``, one
    warm-up and 3 timed steps) on inception-bn, inception-v3 and alexnet in
    f32 and (``--only zoo``) bf16, and on vgg-16, googlenet,
    resnext-50 and
    inception-resnet-v2 in f32, each at its published batch and side
    (vgg-16 and googlenet, which have no BatchNorm, at lr 0.001: at the
    sweep's 0.1 their losses reach NaN within four steps from the sweep's
    init, in the JAX package as in the port): the
    losses finite and K2 and K3 each launched once a step for each of the
    model's in-envelope convolutions (counts zeroed before each row); img/s,
    step ms, model TFLOP/s, peak memory; (d) K2 and K3 at every distinct f32
    shape of an inception-v3 step at batch 32 against the library calls, as
    phase 12 times them, summed over the step's 89 launches.

21. K fused steps as one captured CUDA graph (main path 8,
    ``MXNET_FIT_MULTISTEP``), cuDNN deterministic and its autotuner off:
    (a) phase 17's ResNet-50 ``Module.fit`` (bf16 AMP, dp 4 on gpu(0),
    batch 32, SGD-momentum, Xavier) over 32 seeded batches, two epochs,
    batch 29 of each poisoned with inf, eagerly and with
    ``MXNET_FIT_MULTISTEP=4`` and ``=8``, each K fitted twice (timed, and
    under torch.profiler to count launches): every working param, aux
    state, master, momentum slab, the loss scale and the good count, every
    loss and the final metric equal to the eager fit's bit for bit (the
    poisoned step, inside a replayed group, halves the scale and keeps
    every bit), and so is the whole state after batch 23 of the first
    epoch, before the poisoned batch puts NaN into the BatchNorm moving
    statistics: there every aux tensor is finite, so the replays' aux
    write-back is held as finite bits. In the profiled fits, the device
    kernels counted by name over the whole fit (the warm-up group's and
    every replay's) are K2 and K3 46 times and K1 once a step; the
    wrappers, which count where they launch (a replay calls none), count
    the warm-up group's launches and the capture's. Step ms (median
    interval between the ends of replayed groups ÷ K, eager: between
    steps, leaving out the interval in which the state is copied), img/s,
    the capture's ms, the graph pool's bytes, peak memory; wall and busy ms
    a step, the idle share and kernels a step (K2, K3 and K1 by name) of
    two replayed groups beside two eager steps; a short count there (a
    record the profiler dropped) profiles the two groups again, up to three
    times, and a count above 46 / 46 / 1 fails. (b) the same in f32 without
    AMP (the f32 flat path), 24 batches, one epoch, K = 4, no snapshot.
    (c) phase 18 (b)'s MLP (AMP, Adam) with a FactorScheduler
    at K = 4: bit for bit against its eager fit, validation accuracy at
    least 0.97. (d) a Dropout MLP's trainer at K = 2 run three times from
    one state: the two replays draw different masks; without Dropout every
    replay gives the warm-up's bits. The warm-up group's micro-steps after
    the first run under ``torch.cuda.set_sync_debug_mode("error")``: a
    host read there raises. ``--only multistep --package DIR`` on a tree
    without ``Module.update_multi`` runs the eager fits of (a) and (b)
    alone and prints their state digests (the parent's eager bits). The
    full script runs (a) at K = 8 over one epoch and (b) over 12 batches
    (phase 30's seconds); ``--only multistep`` runs (a) at K = 4 too and
    both at the depth above.

22. the serving surface (main path 9), cuDNN deterministic for (a)-(c):
    (a) ``predict.Predictor`` on bench.py's ResNet-50 symbol (f32, 1000
    classes, 3 x 224 x 224, ``init_params``'s weights, moving means 0 and
    variances 1) on gpu(0): batch buckets 1, 2, 4, 8, 16 and 32 compiled,
    each one captured CUDA graph; each bucket's replayed ``predict_batch``
    equal to the eager ``predict()`` of the same rows bit for bit; capture
    ms and pool bytes a bucket, replayed and eager ms a call and img/s, the
    idle share of replayed and eager calls at batch 1 and 32 under
    torch.profiler, peak memory. (b) ``serving.ServingEngine`` over (a):
    five requests coalesced into one batch (bucket 8) give each row of solo
    dispatch in that bucket bit for bit; closed loop of 512 per-example
    requests at max_batch 1 and 32 (img/s, the speedup, at least 3); an open
    loop of Poisson arrivals at 0.4x the batched rate (client p50 and p99
    ms); no plan miss (capture) and no recompile after warm-up. (c)
    ``tools/serving_bench.py`` on the card (its 128-d MLP's int8 top-1
    agreement at least 0.99, no recompile and no plan miss), and ResNet-50
    int8 against f32 at batch 32 (agreement and img/s). (d) phase 6's mix
    (8 prompts of 5 to 2000 tokens x 32 new, 4 slots, KV 2048) on the full
    bf16 LM behind a ``GenerationEngine`` whose decode step is captured in
    ``compile()``: K4f launched n_layers times a prefill dispatch, no capture
    and no recompile after ``compile()``, decode-step p50 / p99, tokens/s,
    the continuations' sha256 digest, and the idle share of 16 decode steps
    under torch.profiler (four slots busy, stepped from the main thread).
    ``--only serving --package DIR`` on a tree without ``predict`` runs (d)
    alone with that tree's eager engine: equal digests show the captured
    decode gives the eager engine's continuations token for token. Phase 6
    runs captured too: its non-finite check is a flag on the card that the
    captured step ORs into.

23. resilience (main path 10), ResNet-50 bf16 AMP at batch 32 through
    ``Module.fit`` over ``make_mesh(dp=4, devices=[gpu(0)] * 4)``, SGD
    momentum, two epochs of 8 seeded batches (16 steps),
    ``MXTPU_CKPT_INTERVAL=4``. Each run is a process of its own (this
    script with ``--resilience-worker``), cuDNN deterministic with
    autotuning off in all of them; the chains run side by side (each
    reference apart from its kill and resume): (a) at
    ``MXNET_FIT_MULTISTEP`` 1 and 4, a reference fit, a fit with
    ``kill_at_step=11`` (it must die of SIGKILL) and a ``resume="auto"``
    fit from its checkpoints, whose final state (every master, momentum
    slab, working param, BatchNorm statistic, the loss scale and the good
    count, compared by per-tensor sha256) and metric equal the
    reference's bit for bit, and whose K2, K3 and K1 device kernels,
    counted by name under torch.profiler over the fit, are 46, 46 and 1 a
    step it ran (one capture at K = 4); (b) ``preempt_at_step=6`` exits 75
    after a final checkpoint at step 6, and the resume from it equals the
    reference bit for bit; (c) ``guardrails="auto"`` with
    ``nan_grad_at_step=6,loss_spike_at_step=12``: eagerly, the state after
    step 6 equals that after step 5 bit for bit but for the loss scale
    (halved) and the good count (zeroed); at K = 4 the final state equals
    the eager run's bit for bit, with one capture; both finite (the full
    script runs (a) at K = 1 and (c) eagerly: the K = 4 chain and the
    guarded K = 4 fit run under ``--only resilience``). Whether
    ResNet-50's spike trips is recorded (its ``bn_data`` BatchNorm
    normalizes a scaled batch); a 2-layer MLP's spike at K = 4 inside the
    first replayed group must be skipped by the gate (one capture, one
    skip in the health stamp). The guard's gated K1 launch (its flag a
    device scalar ``finite and gn2 <= threshold``) over ResNet-50's 16
    buckets equals ``slab_update_multi_reference`` bit for bit, eagerly and
    in a captured graph replayed with the threshold written between
    replays. (a)'s numbers in this process: the reference's final
    checkpoint's bytes, the ms of its restore (load and placement; the
    restored state equals the reference run's bit for bit), of a
    synchronous save, and the host ms ``save_async`` takes from the train
    thread beside its total. (d) ``predict.params_from_checkpoint`` on
    that checkpoint (the f32 masters), a ``Predictor`` on gpu(0) whose
    batch-32 replay equals ``Module.predict`` bit for bit, and
    ``tools/serve.py --checkpoint`` in a process of its own answering one
    request with the bucket-1 row (within 1e-5 of its max), then draining
    on SIGTERM with exit 0.

24. the input path (``--only input``): (a) the native host library
    (``native.build``: g++ into build/native/) builds and loads; 1024 PNG
    records from seed 0 (smooth synthetic images, sides 256-400, labels
    0-999, every row filter; written by this script's zlib PNG writer, so
    the phase needs no PIL) go through the port's MXIndexedRecordIO,
    ``NativeRecordReader`` reads every record back byte for byte and the
    native PNG decoder gives the source pixels bit for bit; the loader's
    libjpeg / libz, PIL and cv2 are printed; ``fail_recordio_read`` = 2 on
    the sequential reader is retried and the batch is the clean run's. (b)
    (``--only input`` only, as is the delayed-staging fit of (c)) ms an
    image of the native PNG decoder and of PIL on one thread over every
    record (equal pixels); img/s of ``ImageRecordIter`` on the host
    (batch 32, 3x224x224, rand_crop, rand_mirror, the mean) over 192
    batches (6 epochs of the file, each epoch's rate too) at
    preprocess_threads 1, 4, 8, at 8 with PNG through PIL, and at
    input_workers 4, 8, beside the rate a replayed ResNet-50 AMP fit step
    consumes, and the CPU count. (c) phase 17's ResNet-50 AMP fit (dp 4 on
    gpu(0)) over the 32 batches of that .rec through ``ImageRecordIter``
    with a 4-process decode pool, eagerly and at ``MXNET_FIT_MULTISTEP=4``,
    each with ``MXTPU_DEVICE_FEED`` 0 and 1 (the full script runs the fed
    fit at K = 4 alone, held to the host stream; the pairs run under
    ``--only input``), and eagerly with the feed at
    depth 1 behind a sleep of 5e7 cycles on the staging stream before
    every staged copy: with the feed the final state and
    ``bn_data``'s moving statistics after every step bitwise equal to the
    run without it; the tensors each step received (checksummed on its
    stream before the step) and each batch after its step equal (exact
    integer checksums) to the same stream decoded inline under ``cpu()``;
    46 K2 / K3 and one K1 launch a step (the profiler's count by name over
    the whole fit; eagerly the wrappers' too, at K = 4 the wrappers count
    the warm-up group and the capture); step ms over steps 9-32 (and each
    four steps') on the host's clock, and on the card's timeline of those
    steps the idle share and how much of the host-to-device copy time ran
    under kernels, under the profiler (the card's activity only). (d)
    (``--only input`` only: with it the full script took 1012–1094 s of
    its 1200 s limit on an H100 80GB HBM3 at 700 W, its workers 78–85 s)
    phase 23's worker harness on fits fed through the device feed by a
    2-process pool from a 256-record .rec: a run SIGKILLed in epoch 2
    once its step-12 checkpoint landed resumes there (the stream's epoch
    and ``sample_position`` through ``seek_epoch`` / ``seek_sample``) and
    ends bitwise equal to an uninterrupted run; ``bad_record`` = 2 on a
    1-process pool gives two quarantine lines and the fit finishes.

25. the Module family and RNN (``--only rnn``): (a) the ``RNN`` operator
    (cuDNN through ``torch._VF``) against its plain per-step loop
    (``ops.rnn_op.rnn_reference``) at T 60, N 32, I = H = 200, 2 layers,
    f32 with TF32 off, for lstm, gru, rnn_tanh, rnn_relu and a
    bidirectional lstm: the output, the final states and the gradients of
    the data, the blob and the states (one random cotangent) to 1e-4 of
    max|plain|, the ms of each forward and backward, and any warning of
    cuDNN's about the weights' layout. (b) ``BucketingModule.fit`` of the
    PTB LSTM LM at the reference's width (2 x 200 LSTM, embed 200, vocab
    10000, batch 32, buckets 10-60, Adam at 0.01, Xavier(in, 2.34),
    Perplexity(ignore_label=0)) over ``BucketSentenceIter`` of a synthetic
    corpus of 2048 sentences from seed 0, 2 epochs, on the fused route and
    on the ``LSTMCell`` stack from the same initial parameters (the blob
    unpacked and packed per layer): the two routes' first-batch losses
    agree to 1e-4 relative, perplexity falls, buckets share the default
    bucket's ``_arg_params``, a ``save_rnn_checkpoint`` /
    ``load_rnn_checkpoint`` round trip gives every parameter bit for bit;
    ms a batch per bucket (host clock, synchronised, each bucket's first
    batch left out), the perplexity after each epoch and the peak memory;
    then the fused route with ``kvstore="device"`` on 4 logical ranks of
    gpu(0) (the owner demoted to the per-parameter update by the borrowing
    buckets): its parameters after each epoch against the local run's
    (recorded: its Adam rounds the bias correction in f32, the executor
    path's in f64, and Adam carries the difference on), within 1e-5
    relative after the first batch, and under SGD, whose update is the same
    arithmetic on both paths, within 1e-5 after an epoch; the (a) cases
    raise no cuDNN warning about the weights' layout. (c)
    ``models.lstm.lstm_attention_lm`` at its published width (vocab 10000,
    hidden and embed 256, 4 heads, D 64, f32) on 16 x 1024 tokens from seed
    0: logits and a cross-entropy loss's gradients against the same model
    with the plain attention (1e-4 of max), then 4 SGD steps (ms a step),
    with one launch of K4f, K4dq and K4dkv a step. (d) ``FeedForward.create``
    of an MLP over 8 batches, ``predict`` and ``score``; a
    ``SequentialModule`` of a Module and a ``PythonLossModule`` (softmax
    minus one-hot), 8 steps; a ``MutableModule`` over batches of 32, 16 and
    8; each on gpu(0) against the same run with ``Module`` (with
    ``reshape`` for the mutable one) to 1e-5 of each tensor's max.

26. placement and memory mirroring in the Executor (``--only mirror``):
    (a) ``examples/model_parallel_lstm.build`` at lstm_ptb.py's width (8
    LSTM layers, hidden and embedding 400, seq 35, batch 128, vocab 10000)
    on a cyclic corpus from seed 0, bound with ``group2ctx`` (layer 3 on
    cpu(0), the rest on gpu(0): three segments, a copy each way at each
    boundary) and on gpu(0) alone with the same Xavier parameters: one
    step's loss and every gradient within 1e-4 of max|unplaced| (TF32
    off), the host layer's arguments and gradients on the host, then 3
    Adam steps on each (losses within 1e-4, ms a step). (b) inception-v3,
    f32, batch 128, 299 x 299 (the reference's mirror row) through the
    Executor with cuDNN deterministic, the mirror off and on
    (``tools/mirror_inception``'s bind and step, no update): gradients bit
    for bit when two plain steps are (else within 1e-5 of max|off|), peak
    memory, what a step adds to it, step ms and img/s, and the same
    forward convolutions (``aten::cudnn_convolution``) and K2/K3 kernels in
    a profiled step (and its card-busy and wall ms), and the same wrapper
    launches, with the mirror as without; ``__force_mirroring__`` on block mixed_4: its gradients the
    same. (c) phase 21's ResNet-50 bf16 AMP fit on the dp 4 mesh (16
    batches, one epoch) unmirrored and mirrored, eagerly and (``--only
    mirror``) at ``MXNET_FIT_MULTISTEP=4`` (profiled): every
    state tensor of each replayed
    fit bit for bit its eager fit's, and the mirrored fits the unmirrored
    ones'; peak memory and step ms of each (a replay's ms is the card's
    cost of the mirror, without the host's); then a Dropout MLP's trainer, three groups
    of two steps (warm-up, capture, replay), mirrored and not: bit for bit.
    ``--only mirror`` adds ``tools/mirror_inception``'s rows: plain and
    mirror at batch 32, 64 and 128, and at 128 the larger saved sets
    (pooling; pooling and Concat).

27. ring attention, Switch-MoE and the GPipe pipeline on logical ranks of
    one card (``--only parallel``): (a) ``parallel.ring_attention`` at B 4,
    T 2048, H 16, D 64, causal and not, sp 2 and 4, in bf16 (and in f32
    under ``--only parallel``): the output and dq, dk, dv (autograd, one
    random cotangent) against the unsharded ``flash_attention``, each of
    the sp blocks along T to 2e-2 (bf16) / 1e-4 (f32) of that block's own
    max (a causal output's row 0 is v's, so the whole tensor's max would
    hide a merge fault in the later, smaller blocks, which are the only
    ones merged), and against the plain attention to the same limits of
    max|plain|, as every K4 check here (per block the unsharded kernel
    itself reads up to 2.2e-2 from the plain bf16 version, which rounds
    the scores to bf16 as the JAX package's does; printed); K4f, K4dq and
    K4dkv launched once a live block pair, sp (sp + 1) / 2 causal and sp²
    not (a wrapper that fell back to its plain version fails here); the
    TMA repair copies; ms (events) and device ms (a ~20 ms sleep queued
    first) of forward + backward at sp 1 (the unsharded kernel), 2 and 4.
    (b) the example trainer's Switch-MoE LM at full width (vocab 32000,
    d 1024, 16 heads, 12 layers, d_ff 4096, 8 experts every second layer,
    batch 4, T 2048, bf16, 10 SGD steps from ``init_fn(0)``) at sp 4 / ep 4
    (the main path: 120 launches of each K4 kernel a step): finite losses,
    step 9's below step 0's, ms a step (median of steps 1-9, host clock,
    synchronised), tokens/s, peak memory; and one step at sp 1 / ep 1 (12
    launches), whose loss, step 0's, is within 1e-4 relative of the sp 4
    run's (the two share the weights and compute the loss in f32, so only
    the ring's merge order differs; they read 1.5e-6 apart on the card).
    ``--only parallel`` runs the sp 1 / ep 1 model for all 10 steps (its
    losses fall too; ms a step, tokens/s, peak memory) and adds the dense
    model's ms a step at the same batch (5 steps). (c) the full bf16 model's
    prefill with ``mesh=make_mesh(sp=4, devices=[gpu(0)] * 4)`` against
    ``mesh=None`` on phase 6's eight prompt lengths, each in its bucket:
    the last logits within 2e-2 of max, 12 x 10 K4f launches a prefill;
    then ``GenerationEngine`` (4 slots, ``max_len`` 2048) with each mesh,
    its loop driven in order by ``step()``: the greedy continuations that
    agree (printed, not held: bf16 logits a few ulps apart may break a
    near tie) and K4f launches a prefill dispatch. (d) the ``SwitchMoE``
    contrib operator's ``Module.fit`` (tests/test_moe_pipeline.py's net) on
    gpu(0): accuracy > 0.9; ``pipelined_loss`` over 4 pp ranks, d 1024, 8
    microbatches of 64, f32 (TF32 off), against the stages run one after
    another: loss within 1e-5 relative, gradients within 1e-4 of max.
28. telemetry and the tools (``--only telemetry`` runs all of it, the full
    script (a), (b), (e) and (g)): phase 21's ResNet-50 bf16 AMP ``Module.fit``
    on the dp 4 mesh of gpu(0), batch 32, 64 batches cycled from 8, with
    ``telemetry.enable(jsonl=...)``. (a) ``MXNET_FIT_MULTISTEP=auto``,
    ``MXTPU_ANATOMY_INTERVAL=8``, ``MXNET_FIT_MULTISTEP_MAX=8``: each
    ``multistep_auto`` decision (K, dispatch share) and each anatomy
    interval (step ms, phases, unattributed, MFU against the H100 peak
    table, roofline) printed; phases + unattributed = wall to 1e-9, MFU in
    (0, 1], the tuner settled, one group left (the deeper ones released)
    with one warm-up, one capture and only replays after it, no recompile in
    an interval after settling, and the captured launches a step K2 46, K3
    46, K1 1. (b) two replays of the settled group under
    ``profiler.profiler_set_state("run")``; ``profiler.attribute_trace`` on
    the exported Kineto trace names K1, K2 and K3 with device ms, and their
    launches by the profiler are printed beside the wrappers' count a
    replay times the replays (equal unless the profiler drops records).
    (c) ``fit(monitor=Monitor(interval=1))`` over two batches on
    ``context=[gpu(0)] * 4`` with kvstore 'device': the fused path is
    declined (the module without a monitor takes it) and every stat is
    finite. (d) ``tools/serve.py --metrics-port 0`` on a ResNet-50 bundle
    on the card (a subprocess): 8 requests, then ``/metrics`` reads
    ``mxtpu_serve_requests 8`` and ``/healthz`` answers 200; SIGTERM drains
    it to exit 0. (e) the port's ``perf_doctor`` and ``trace_summary``
    (and ``--anatomy``), three processes side by side, on (a)'s JSONL exit
    0, and perf_doctor names the largest phase. (f) ms a step with
    telemetry on and off at the settled K (32 batches a fit, in turns on,
    off, off, on). (g) a kvstore 'local' initialised on the host takes four
    card gradients (SGD with momentum): the stored value and its momentum
    end on the card, the pull within 1e-5 of w - lr * sum of the gradients.
29. detection, the rest of the one-card surface (``--only detection`` runs
    the same): (a) each operator this slice adds (the contrib and spatial
    operators) on the card against itself on the host from one seed,
    outputs and gradients within 1e-4 of max, MultiBoxTarget's matches,
    MultiBoxDetection's classes and quantize's bytes equal. (b) the NMS
    kernel against its plain version, the kept sets equal: at SSD-300's
    8732 anchors x 32 images, every anchor a step (2.4 GB of mask), and at
    Proposal's 6000 -> 300 on R-CNN's 600 x 800 map; kernel ms (events,
    L2 flushed), the plain version's ms, the bytes of the rows read. (c)
    K2/K3 against their plain versions on SSD-300's in-envelope shapes at
    batch 32 (1e-4), then SSD-300 (20 classes, batch 32, seeded images and
    1-4 boxes each) through ``Module.fit``, 6 steps in f32 on gpu(0) and 6
    in bf16 AMP on a dp 4 mesh of gpu(0) with kvstore 'device': losses
    finite, K2 and K3 once a step on each in-envelope convolution, K1 on
    the AMP leg; step ms, img/s, peak memory. (d) SSD-300's deploy symbol
    behind a Predictor at batch 1 and 32: each bucket one captured graph
    (MultiBoxDetection's NMS kernel inside), its output equal to an eager
    forward bit for bit; ms a batch replayed and eager. (e) Faster R-CNN
    VGG-16 (21 classes, 6000 -> 300 proposals, 128 rois, 7 x 7, 1024
    hidden) through MutableModule bound at 800 x 800, 10 SGD steps
    alternating 600 x 800 and 800 x 600: ms a step, the host's
    ``proposal_target`` ms in it, the card's busy ms of two profiled
    steps, one NMS launch a step, K2/K3's launches (none expected). (f) a
    Custom operator mid-graph on gpu(0) against the host, then a
    Predictor bucket and ``MXNET_FIT_MULTISTEP=2`` refusing the graph,
    naming the node, and a Predictor bucket refusing a ROIPooling graph
    (its window size is read on the host). (g)
    ``test_utils.check_consistency`` across [gpu(0), cpu(0)]. K1, K2, K3
    and NMS are counted from zero over (c)-(e), and each must have
    launched.

31. the model axes across processes (``--only axes`` runs the sp and ep
    legs and tp-step too): phase 30's launch of two workers on gpu(0) also
    trains the LM at full width (FULL, bf16, T 2048, batch 4) with ``--tp
    2`` across the two processes for 3 steps (``dist_check --lm tp``): each
    process holds half of every tp-sharded weight and runs K4f / K4dq /
    K4dkv on its 8 heads. The first loss is held within 5e-3 relative, and
    the first step's gathered gradients within 2e-2 of each leaf's max, of
    one process's tp 1 run at the same seed on the card; both ranks' losses
    equal, the replicated leaves and the gathered ones bit for bit equal
    across the ranks; each worker's K4 launches (12 a step), step ms, idle
    share, collectives' ms and MB a step, peak GiB printed. ``--only axes``
    launches its own job: the axes check, the tp, sp 2 (the process ring)
    and ep 2 (8 experts) legs to the same limits (the ep leg against one
    process's MoE run), and tp-step (``ShardedTrainStep(param_specs=)`` over
    dp 1 x tp 2 across the processes, an MLP, against one process's over a
    logical tp 2 mesh: 1e-6 of max, and ``Module(mesh=, param_specs=).fit``
    with rank 0's checkpoint). The same launch also trains the LM as a
    pipeline (``dist_check --pp-test``): pp 2 across the two processes, the
    12 blocks as 2 stages of 6 (the embedding before the pipeline, the
    final norm and the tied head in the loss), bf16, T 2048, 4 microbatches
    of one row, 3 SGD steps; each stage sends its microbatches' activations
    to the next and their gradients back (``mesh.ppermute`` over gloo).
    Held to one process's logical pp 2 (``pipeline_stages``) at the same
    seed on the card: the first loss within 5e-3 relative (and whether bit
    for bit), each stage leaf's first-step gradient within 2e-2 of its max
    and so rank 0's embedding and final norm gradients (summed over pp),
    both ranks' losses equal, each worker's K4f / K4dq / K4dkv launches 6
    blocks x 4 microbatches a step; step ms, idle share, the permutes' and
    the replicated leaves' all-reduce ms and MB a step, peak GiB printed
    (the pp shape, 1 x 2048 x 16 x 64 bf16 causal, is among phases 2 and
    3's kernel checks). ``--only pp`` launches its own job with the pp axis
    check (rank order, neighbours, ``ppermute`` f32 / bf16 and its
    gradient) and adds pp 4 over 4 processes at d_model 512, 8 layers.
    ``phase_seconds`` records each phase's seconds of the full script.

32. the C++ frontend: ``make -C mxnet_tpu_torch/cpp`` (g++ against the
    CPython headers and ``python3-config --embed --ldflags``) into
    ``build/cpp/``, then ``train_mlp`` and ``lenet`` on gpu(0): accuracy
    above 0.90, ``checkpoint-roundtrip: exact``, the Predictor's accuracy
    equal to the executor's, and lenet's second convolution (8 -> 16, 3 x
    3 on 4 x 4 maps) through K2 and K3 once a step (375 launches each, the
    binary's own counters); build and run seconds printed. Without
    ``Python.h`` the phase raises naming it.

33. the 16 root examples in-process on gpu(0) at their smokes' settings
    (``tests/test_examples_smoke.py``), each passing its own check;
    stochastic_depth's blocks (16 -> 16 channel 3 x 3 convolutions, the
    examples' only ones in K2 / K3's envelope) launch each 1980 times. K2 and K3 are held against their plain versions (f32, 1e-4 of
    max, repeats bitwise) and timed on every in-envelope shape of the
    examples and on lenet.cpp's, and the Caffe converter converts a
    hand-encoded model whose forward on gpu(0) is held to the host's
    (1e-5 of max).

Then the kernels line: the seven kernels, K4f, K4dq, K4dkv, K2, K3, K5 and
K1, and the NMS kernel; K2's and K3's launches count phase 20's training rows, and their
entries carry phase 20's launches and inception-v3 step under ``zoo``;
K1's, K2's and K3's count phase 21's launches run in its eager fits (the
wrappers' counts) and its profiled grouped fits (the profiler's by name),
under ``launches_by_path`` for K1; the timed grouped fits' replays are
not counted; and phase 23's resumed fits (the profiler's by name; for K1
under ``launches_by_path["resilience"]``); and phase 24's fits (the
wrappers' counts eagerly, the profiler's by name over the whole grouped
fits; under ``--only input`` the resumed run's wrapper counts too; for K1
under ``launches_by_path["input"]``). K4f's ``launches_by_path["serving"]`` counts phase 6's and
phase 22 (d)'s prefills; K4f's, K4dq's and K4dkv's ``launches_by_path["rnn"]`` the f32
launches of phase 25 (c)'s SGD steps, which their ``launches`` include;
K1's, K2's and K3's ``launches_by_path["mirror"]`` phase 26's (b) (the
wrappers' counts) and (c) (the wrappers' eagerly, the profiler's by name
over the grouped fit), which their ``launches`` include. K4f's, K4dq's and
K4dkv's ``launches_by_path["parallel"]`` count phase 27 (b)'s sp 4
training run and, for K4f, (c)'s sp 4 engine run, which their
``launches`` include. K1's, K2's and K3's ``launches_by_path["telemetry"]``
count phase 28 (a)'s wrappers (the warm-up groups and the captures) and
(b)'s profiled replays by kernel name, which their ``launches`` include.
K1's, K2's and K3's ``launches_by_path["detection"]`` count phase 29
(c)-(e)'s wrappers, and ``launches_by_path["dist"]`` phase 30 (b)-(c)'s
wrappers in both worker processes, which their ``launches`` include.
K4f's, K4dq's and K4dkv's ``launches_by_path["axes"]`` count phase 31's tp
leg in both workers, and ``launches_by_path["pp"]`` its pp leg in both
workers, which their ``launches`` include. K2's and K3's
``launches_by_path["cpp"]`` count phase 32's lenet and ``["examples"]``
phase 33's runs, which their ``launches`` include, and
``examples_shapes`` carries phase 33's rows (f32 ms, plain, library,
bound, error) at the examples' and lenet.cpp's shapes. The NMS kernel's
entry (a kernel of the port with no TPU counterpart) counts phase 29's
detection path and carries (b)'s times at SSD-300's 8732 x 32 (``ms``,
``plain_ms``, ``bound_ms``) and at Proposal's 6000 -> 300.

The last line of output is {"ok": true, "device": {...}}. Without a CUDA
device, or without the package beside this script, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
FULL = dict(vocab=32000, d_model=1024, n_heads=16, n_layers=12, d_ff=4096)
MAX_LEN = 2048
SLOTS = 4
PROMPT_LENGTHS = (5, 60, 128, 300, 700, 1000, 1500, 2000)
MAX_NEW = 32
TRAIN = dict(batch_size=8, seq_len=2047, steps=10, lr=3e-2)  # T = 2047
BWD_CHECK_T = (7, 100, 128, 512, 1000, 2048)
BWD_CHECK_EXTRA = [(2047, 64), (2047, 128), (7, 16), (100, 16), (2047, 16), (7, 32), (100, 32),
                   (2047, 32), (300, 64, "bhtd"), (2047, 128, "bhtd")]
# (T, D[, "bhtd": transposed [B, H, T, D] views]) beside BWD_CHECK_T x (64, 128)
BWD_TIME_SHAPE = (8, 2047, 16, 64)  # n, T, H, D of the training path's attention
# f32 (n, T, H, D) where the sums of the split f32 kernels are longest, small
# n·H so the plain version's [T, T] scores fit; causal and not
FLASH_DEEP = [(1, 4096, 2, 64), (1, 4096, 2, 128), (1, 8192, 2, 64), (1, 8192, 1, 128)]
RESNET_BATCH = 32
RESNET_STEPS = 5
RESNET_CONVS = 46  # in-envelope convolutions of ResNet-50: K2 and K3 launches a step
RTC_STEPS = 6
RTC_BIG = (32, 64, 112, 112)
SGD = dict(lr=0.1, momentum=0.9, wd=1e-4)  # bench.py's step; rescale_grad = 1 / batch
# ragged (data, weight, pad) shapes: N 1 and 3, H x W 7 x 7 and 9 x 11, k 1/3/5, pad 0-2;
# non-square kernels (1 x 7 pad (0, 3) on 17 x 17, 3 x 1 pad (1, 0) on 8 x 8) and 24
# channels in and out (googlenet's 5 x 5 and its 512 -> 24 reduce)
CONV_RAGGED = [
    ((1, 8, 7, 7), (16, 8, 3, 3), (1, 1)),
    ((3, 16, 9, 11), (8, 16, 1, 1), (0, 0)),
    ((3, 24, 9, 11), (40, 24, 5, 5), (2, 2)),
    ((1, 64, 7, 7), (72, 64, 3, 3), (0, 0)),
    ((3, 8, 9, 11), (8, 8, 5, 5), (1, 1)),
    ((1, 72, 9, 11), (64, 72, 1, 1), (0, 0)),
    ((3, 16, 17, 17), (24, 16, 1, 7), (0, 3)),
    ((2, 24, 8, 8), (16, 24, 3, 1), (1, 0)),
    ((2, 24, 14, 14), (64, 24, 5, 5), (2, 2)),
    ((2, 512, 14, 14), (24, 512, 1, 1), (0, 0)),
]
# f32 shapes of ResNet-50 at batch 256 whose sums are the longest: K2's
# 56 x 56 ones (the most k steps a split) and K3's 512-channel 3 x 3
CONV_DEEP = [
    ((256, 64, 56, 56), (64, 64, 3, 3), (1, 1)),
    ((256, 64, 56, 56), (64, 64, 1, 1), (0, 0)),
    ((256, 64, 56, 56), (256, 64, 1, 1), (0, 0)),
    ((256, 256, 56, 56), (64, 256, 1, 1), (0, 0)),
    ((256, 512, 7, 7), (512, 512, 3, 3), (1, 1)),
    # AlexNet's conv2 at batch 512 and 224 x 224 images (26 x 26, 5 x 5 pad 2):
    # the longest K2 sum of any path
    ((512, 96, 26, 26), (256, 96, 5, 5), (2, 2)),
]
# phase 20: the image-classification zoo at its published batch and image
# side. The model sweep's rows other than ResNet, trained in f32 and bf16,
# and the rest of the zoo, trained in f32 at batch 32: name -> ((model
# module, get_symbol kwargs), side, batch, K80 img/s or None)
ZOO_SWEEP = ("inception-bn", "inception-v3", "alexnet")
ZOO_EXTRA = {
    "vgg-16": (("vgg", {"num_layers": 16}), 224, 32, None),
    "googlenet": (("googlenet", {}), 224, 32, None),
    "resnext-50": (("resnext", {"num_layers": 50}), 224, 32, None),
    "inception-resnet-v2": (("inception_resnet_v2", {}), 299, 32, None),
}
# the sweep's step at lr 0.1 takes the two models without BatchNorm to NaN
# losses within four steps from the sweep's init, in the JAX package as in
# the port: they train at this lr
ZOO_LR = {"vgg-16": 1e-3, "googlenet": 1e-3}
ZOO_STEPS = 3  # timed steps of a phase 20 training row, after one warm-up
ZOO_GRAD_BATCH = 8  # phase 20 (b): the plain path's runs fit beside the kernel's
ZOO_GRAD_MODELS = ("inception-v3", "alexnet")


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_label(mangled):
    """``flash_fwd_sm90<64>`` from a mangled kernel name."""
    m = re.search(r"\d+((?:flash|conv|slab)_[a-z0-9_]+?)I", mangled)
    if not m:
        return mangled[:80]
    args = re.findall(r"13__nv_bfloat16|L[a-z]\d+E|f",
                      mangled[m.end():mangled.find("EEv", m.end()) + 1])
    names = ["bf16" if a[0] == "1" else "float" if a == "f" else a[2:-1] for a in args]
    return "%s<%s>" % (m.group(1), ",".join(names))


def ptxas_lines(log_text):
    """{kernel label: "Used N registers, ...; N bytes stack frame, ..."} from
    nvcc's -Xptxas -v output."""
    out, func = {}, None
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([^' ]+)'?", line)
        if m:
            func = kernel_label(m.group(1))
        elif func and ("registers" in line or "spill" in line):
            out.setdefault(func, []).append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def sass_counts(_build, name):
    """{kernel label: {"HGMMA": n, "UTMALDG": n}} over the SASS of kernel
    ``name``'s library, from cuobjdump beside nvcc."""
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts, func = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = kernel_label(m.group(1))
            counts[func] = {"HGMMA": 0, "UTMALDG": 0}
        elif func:
            for op in counts[func]:
                counts[func][op] += op in line
    return counts


# (kernel whose library to read, Hopper kernel prefix, its instantiations,
# the SIMT kernels that must be gone)
SASS_CHECKS = (
    ("flash_attn_fwd", "flash_fwd_sm90", 4, ("flash_fwd_kernel<",)),  # bf16, D 16-128
    ("flash_attn_fwd", "flash_fwd_split_sm90", 4, ("flash_fwd_kernel<",)),  # split f32
    # <D, planes>: bf16 and split f32
    ("flash_attn_bwd_dq", "flash_dq_sm90", 8, ("flash_dq_kernel<",)),
    ("flash_attn_bwd_dkv", "flash_dkv_sm90", 8, ("flash_dkv_kernel<",)),
    # <c tile, warpgroups, NCHW in place, planes>: 8 bf16, 4 f32
    ("conv_bwd_filter", "conv_wgrad_sm90", 12, ("conv_wgrad_kernel<",)),
    # <c tile, planes>
    ("conv_bwd_input", "conv_dgrad_sm90", 4, ("conv_dgrad_kernel<",)),
)


def phase_build(_build):
    t0 = time.perf_counter()
    logs = _build.build()
    secs = time.perf_counter() - t0
    for name, text in sorted(logs.items()):
        for func, line in sorted(ptxas_lines(text).items()):
            log("  %s %s: %s" % (name, func, line))
    log("phase 1: built %s in %.2f s" % (sorted(logs) or "nothing new", secs))
    sass, by_lib = {}, {}
    for name, prefix, count, simt in SASS_CHECKS:
        lib = _build.library_path(name)
        if lib not in by_lib:  # dq and dk/dv share one library, K2 and K3 another
            by_lib[lib] = sass_counts(_build, name)
        counts = by_lib[lib]
        tma = {f: c for f, c in counts.items() if f.startswith(prefix + "<")}
        left = [f for f in counts if f.startswith(simt)]
        log("  sass %s: %s" % (name, json.dumps(tma)))
        if len(tma) != count or not all(c["HGMMA"] > 0 and c["UTMALDG"] > 0
                                        for c in tma.values()):
            raise AssertionError("%s: the Hopper kernels want wgmma and TMA in their SASS, got %s"
                                 % (name, tma))
        if left:
            raise AssertionError("%s: SIMT kernels left: %s" % (name, left))
        sass.update(tma)
    flash = [f for lib, counts in by_lib.items() for f in counts if f.startswith("flash_")]
    simt = [f for f in flash if "_sm90" not in f and not f.startswith("flash_split_kernel")]
    if simt:
        raise AssertionError("the flash libraries want no SIMT kernel, got %s" % simt)
    log("phase 1: HGMMA and UTMALDG in every flash kernel (bf16 and split f32) and every bf16 "
        "and f32 K2 and K3 kernel; no SIMT flash, K2 or K3 kernel")
    return secs, sass


def _randn(shape, dtype, device, rng):
    import torch

    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)


def _operand(kernels, n, t, h, d, dtype, dev, rng, layout=()):
    """A [B, T, H, D] operand: contiguous, or with ``layout`` == ["bhtd"]
    the transposed view of a contiguous [B, H, T, D] tensor, which
    ``tma_compatible`` accepts, so the bf16 kernels read it in place."""
    if not layout:
        return _randn((n, t, h, d), dtype, dev, rng)
    x = _randn((n, h, t, d), dtype, dev, rng).transpose(1, 2)
    assert x.stride(1) < x.stride(2) and kernels.tma_compatible(x), x.stride()
    return x


def max_err(kernels, q, k, v, causal, repeat=False):
    """max |kernel - plain| of the forward; with ``repeat``, also whether a
    second launch gave the same bits (output and lse)."""
    import torch

    out, lse = kernels.flash_attention(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    ref = kernels.reference_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == q.dtype
    err = (out.float() - ref.float()).abs().max().item()
    if not repeat:
        return err
    out2, lse2 = kernels.flash_attention(q, k, v, causal=causal, return_lse=True)
    return err, torch.equal(out, out2) and torch.equal(lse, lse2)


def phase_kernel_checks(kernels, dev):
    import torch

    rng = np.random.default_rng(0)
    cases = [(n, t, 16, 64, True) for n in (1, 4) for t in (7, 100, 128, 512, 1000, 2048)]
    cases += [(2, 300, 16, 64, False), (2, 500, 8, 128, True), (1, 2047, 16, 64, True),
              (1, 2047, 8, 128, False)]
    cases += [(2, t, 8, d, causal) for d in (16, 32) for t, causal in
              ((7, True), (100, False), (300, True), (2047, True), (2047, False))]
    # [B, H, T, D] tensors read as [B, T, H, D] views: TMA-aligned strides in another order
    cases += [(2, 300, 8, 64, True, "bhtd"), (1, 2047, 16, 64, False, "bhtd"),
              (2, 100, 8, 128, True, "bhtd")]
    split = split_checks(kernels, dev, rng)
    worst = {}
    f32_only = ((torch.float32, 1e-4),)
    cases = [c + (None,) for c in cases] + [(n, t, h, d, causal, f32_only)
                                            for n, t, h, d in FLASH_DEEP for causal in (True, False)]
    for (n, t, h, d, causal, *layout, dtypes) in cases:
        for dtype, tol in dtypes or ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            q, k, v = (_operand(kernels, n, t, h, d, dtype, dev, rng, layout) for _ in range(3))
            err, same = max_err(kernels, q, k, v, causal, repeat=True)
            log("  flash_attn_fwd n=%d T=%d H=%d D=%d causal=%s %s%s: max_abs_err %.3g (tol %g), "
                "bitwise repeat %s" % (n, t, h, d, causal, str(dtype).split(".")[-1],
                                       " bhtd view" if layout else "", err, tol, same))
            if not err <= tol:
                raise AssertionError("flash_attn_fwd disagrees with the plain version")
            if not same:
                raise AssertionError("flash_attn_fwd is not bitwise repeatable")
            key = str(dtype).split(".")[-1]
            worst[key] = max(worst.get(key, 0.0), err)
    log("phase 2: forward kernels vs plain ok over %d cases (%d FLASH_DEEP, f32), worst %s; "
        "split pass bitwise equal to split_bf16: %s"
        % (len(cases), 2 * len(FLASH_DEEP), json.dumps(worst), json.dumps(split)))
    worst["split"] = split
    return worst


def split_checks(kernels, dev, rng):
    """The split pass (``split_planes``) bit for bit against its plain
    version ``split_bf16``: the four operands of the training path's dk/dv
    (n=8, T=2047, H=16, D=64) contiguous, and a [B, H, T, D] view next to a
    contiguous tensor; a second launch gives the same bits."""
    import torch

    n, t, h, d = BWD_TIME_SHAPE
    out = {}
    for name, xs in (
            ("contiguous x4", [_randn((n, t, h, d), torch.float32, dev, rng) for _ in range(4)]),
            ("bhtd view + contiguous", [_operand(kernels, 2, 300, 8, 64, torch.float32, dev, rng,
                                                 ["bhtd"]),
                                        _randn((2, 300, 8, 64), torch.float32, dev, rng)])):
        got = kernels.split_planes(*xs)
        again = kernels.split_planes(*xs)
        want = torch.stack([kernels.split_bf16(x) for x in xs])
        bits = lambda a: a.view(torch.int16)  # noqa: E731
        same = torch.equal(bits(got), bits(want)) and torch.equal(bits(got), bits(again))
        log("  split_planes %s %s: bitwise equal to split_bf16 and repeatable %s"
            % (name, tuple(xs[0].shape), same))
        if not same:
            raise AssertionError("split_planes differs from split_bf16 (%s)" % name)
        out[name] = same
    return out


def bwd_inputs(kernels, n, t, h, d, dtype, causal, dev, rng, layout=()):
    """q, k, v, dO (laid out as :func:`_operand`), and the lse and delta a
    training backward would hand the kernels: lse from the forward kernel,
    delta = sum_D dO * O in f32."""
    import torch

    q, k, v, do = (_operand(kernels, n, t, h, d, dtype, dev, rng, layout) for _ in range(4))
    with torch.no_grad():
        out, lse = kernels.flash_attention(q, k, v, causal=causal, return_lse=True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


def bwd_errors(kernels, args, causal):
    """Per backward kernel: max |kernel - plain| / max |plain| over its
    outputs, the max abs error, and whether a second launch gave the same
    bits."""
    import torch

    dq = kernels.flash_attention_dq(*args, causal=causal)
    dk, dv = kernels.flash_attention_dkv(*args, causal=causal)
    torch.cuda.synchronize()
    dq2 = kernels.flash_attention_dq(*args, causal=causal)
    dk2, dv2 = kernels.flash_attention_dkv(*args, causal=causal)
    torch.cuda.synchronize()
    ref = kernels.reference_attention_bwd(*args, causal=causal)
    out = {}
    for name, got, again, want in (("flash_attn_bwd_dq", (dq,), (dq2,), ref[:1]),
                                   ("flash_attn_bwd_dkv", (dk, dv), (dk2, dv2), ref[1:])):
        rel, err = 0.0, 0.0
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, g.dtype)
            # max() below would drop a NaN, so non-finite values fail here
            if not (bool(torch.isfinite(g).all()) and bool(torch.isfinite(w).all())):
                raise AssertionError("%s or its plain version is not finite" % name)
            diff = (g.float() - w.float()).abs().max().item()
            rel = max(rel, diff / max(w.float().abs().max().item(), 1e-30))
            err = max(err, diff)
        out[name] = {"rel_err": rel, "max_abs_err": err,
                     "bitwise_repeat": all(torch.equal(a, b) for a, b in zip(got, again))}
    return out


def phase_bwd_checks(kernels, dev):
    import torch

    rng = np.random.default_rng(4)
    worst = {}
    n, h = 2, 8
    both = ((torch.float32, 1e-4), (torch.bfloat16, 2e-2))
    shapes = [(n, h, t, d, both) for t in BWD_CHECK_T for d in (64, 128)]
    shapes += [(n, h, *extra, both) for extra in BWD_CHECK_EXTRA]
    shapes += [(dn, dh, t, d, ((torch.float32, 1e-4),)) for dn, t, dh, d in FLASH_DEEP]
    for n, h, t, d, *layout, dtypes in shapes:
        for causal in (True, False):
            for dtype, tol in dtypes:
                args = bwd_inputs(kernels, n, t, h, d, dtype, causal, dev, rng, layout)
                key = str(dtype).split(".")[-1]
                for name, e in bwd_errors(kernels, args, causal).items():
                    log("  %s n=%d T=%d H=%d D=%d causal=%s %s%s: rel_err %.3g (tol %g) "
                        "max_abs_err %.3g, bitwise repeat %s"
                        % (name, n, t, h, d, causal, key, " bhtd view" if layout else "",
                           e["rel_err"], tol, e["max_abs_err"], e["bitwise_repeat"]))
                    if not e["rel_err"] <= tol:
                        raise AssertionError("%s disagrees with the plain version" % name)
                    if not e["bitwise_repeat"]:
                        raise AssertionError("%s is not bitwise repeatable" % name)
                    worst[name + " " + key] = max(worst.get(name + " " + key, 0.0),
                                                  e["rel_err"])
    log("phase 3: backward kernels vs plain ok, worst rel_err %s" % json.dumps(worst))
    return worst


def phase_serving_f32(tfm, kernels, dev):
    import torch

    dims = dict(FULL, n_layers=2)
    init_fn, _ = tfm.transformer_lm(dtype=torch.float32, **dims)
    params = tfm.params_from_jax(init_fn(0), device=dev, dtype=torch.float32)
    init_cache, prefill, _ = tfm.transformer_lm_serving(
        max_len=MAX_LEN, dtype=torch.float32, **dims)
    rng = np.random.default_rng(1)
    lengths = np.array([5, 300, 1000], np.int64)
    toks = np.zeros((3, 1024), np.int64)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(0, dims["vocab"], n)
    slots = np.arange(3)

    def run():
        cache = init_cache(4, device=dev)
        _, last = prefill(params, cache, torch.from_numpy(toks), torch.from_numpy(slots),
                          torch.from_numpy(lengths))
        torch.cuda.synchronize()
        return last

    zero_counts(kernels)
    got = run()
    launched = kernels.flash_attention.launches
    # the same forward with the plain attention in the kernel's place
    dispatch = kernels.attention
    kernels.attention = lambda q, k, v, causal=False, scale=None, mesh=None: (
        kernels.reference_attention(q, k, v, causal=causal, scale=scale))
    try:
        ref = run()
    finally:
        kernels.attention = dispatch
    assert launched == dims["n_layers"], launched
    assert got.shape == (3, dims["vocab"]) and bool(torch.isfinite(got).all())
    err = (got - ref).abs().max().item()
    torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-3)
    log("phase 4: f32 depth-2 prefill logits, kernel vs plain attention: "
        "max_abs_err %.3g (rtol = atol = 1e-3)" % err)
    return {"err": err, "launches": launched}


def zero_counts(kernels):
    for fn in (kernels.flash_attention, kernels.flash_attention_dq, kernels.flash_attention_dkv,
               kernels.conv_bwd_filter, kernels.conv_bwd_input, kernels.fused_slab_update,
               getattr(kernels, "split_planes", None)):  # absent from older trees
        if fn is not None:
            fn.launches = 0


def conv_counts(kernels):
    return {"conv_bwd_filter": kernels.conv_bwd_filter.launches,
            "conv_bwd_input": kernels.conv_bwd_input.launches}


def read_counts(kernels):
    return {"flash_attn_fwd": kernels.flash_attention.launches,
            "flash_attn_bwd_dq": kernels.flash_attention_dq.launches,
            "flash_attn_bwd_dkv": kernels.flash_attention_dkv.launches}


def phase_train_f32(tfm, trainer, kernels, dev):
    import torch

    dims = dict(FULL, n_layers=2)
    init_fn, apply_fn = tfm.transformer_lm(dtype=torch.float32, **dims)
    params = tfm.params_from_jax(init_fn(0), device=dev, dtype=torch.float32)
    params.requires_grad_()
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, dims["vocab"], (2, 1001))).to(dev)

    def grads():
        loss = trainer.lm_loss(apply_fn(params, toks[:, :-1]), toks[:, 1:])
        loss.backward()
        torch.cuda.synchronize()
        out = [p.grad for p in params.parameters()]
        for p in params.parameters():
            p.grad = None
        return loss.detach(), out

    zero_counts(kernels)
    loss, got = grads()
    counts = read_counts(kernels)
    dispatch = kernels.attention
    kernels.attention = lambda q, k, v, causal=False, scale=None, mesh=None: (
        kernels.reference_attention(q, k, v, causal=causal, scale=scale))
    try:
        ref_loss, want = grads()
    finally:
        kernels.attention = dispatch
    assert counts == dict.fromkeys(counts, dims["n_layers"]), counts
    assert bool(torch.isfinite(loss)) and abs(loss.item() - ref_loss.item()) <= 1e-3, (
        loss.item(), ref_loss.item())
    worst = 0.0
    for (name, _), g, w in zip(params.named_parameters(), got, want):
        m = w.abs().max().clamp_min(1e-30)
        torch.testing.assert_close(g / m, w / m, rtol=1e-3, atol=1e-3, msg=name)
        worst = max(worst, ((g - w).abs().max() / m).item())
    log("phase 5: f32 depth-2 training grads, kernels vs plain attention: loss %.6f vs %.6f, "
        "worst grad err %.3g of max (rtol = atol = 1e-3), launches %s"
        % (loss.item(), ref_loss.item(), worst, json.dumps(counts)))
    return {"loss": loss.item(), "ref_loss": ref_loss.item(), "worst_rel_err": worst,
            "launches": counts}


# kernel families of the LM step's profile (phase 19), first match wins:
# the f32 split pass, the flash kernels (bf16 and split f32), cuBLAS's f32
# GEMMs (TF32 off) and other GEMMs, reductions and softmax, elementwise
LM_FAMILIES = (
    ("flash_split", ("flash_split",)),
    ("flash_attn_fwd", ("flash_fwd_",)),
    ("flash_attn_bwd_dq", ("flash_dq_",)),
    ("flash_attn_bwd_dkv", ("flash_dkv_",)),
    ("gemm_f32", ("sgemm", "f32f32")),
    ("gemm", ("nvjet", "gemm", "xmma", "cutlass")),
    ("reduce", ("reduce", "SoftMax", "softmax")),
    ("elementwise", ("elementwise",)),
)


def lm_family(name):
    return next((fam for fam, keys in LM_FAMILIES if any(k in name for k in keys)), "other")


def phase_train_lm(trainer, kernels, dev, dtype, family=None):
    """Phase 7 (bf16) or 19 (f32): TRAIN's SGD steps of the example
    trainer on the full model; see the module docstring. With ``family``
    (a kernel name's family), the last two steps run under torch.profiler
    and the step time is the median of the steps before them."""
    import torch

    steps, layers = TRAIN["steps"], FULL["n_layers"]
    profiled = 2 if family is not None else 0
    per_step, stamps, prof = [], [], {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def on_step(i, loss, params):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        per_step.append(read_counts(kernels))
        if profiled and i == steps - 1 - profiled:
            prof["p"] = torch.profiler.profile(activities=acts)
            prof["p"].__enter__()
            prof["t0"] = time.perf_counter()
        elif profiled and i == steps - 1:
            prof["wall"] = time.perf_counter() - prof["t0"]
            prof["p"].__exit__(None, None, None)

    f32 = dtype == "float32"
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(kernels)  # counts from here are the training path's
    t0 = time.perf_counter()
    losses = trainer.train(dtype=dtype, device=dev, on_step=on_step,
                           log=lambda *a: log("  train:", *a), **FULL, **TRAIN)
    wall = time.perf_counter() - t0
    counts = read_counts(kernels)
    split = getattr(kernels, "split_planes", None)
    split_launches = split.launches if split is not None else None
    prev = dict.fromkeys(counts, 0)
    for i, c in enumerate(per_step):
        for name, n in c.items():
            assert n - prev[name] == layers, (i, name, n - prev[name])
        prev = c
    assert counts == dict.fromkeys(counts, steps * layers), counts
    # f32: one split pass a forward and one a backward (dq and dk/dv share
    # it); bf16: none
    if split_launches is not None:
        assert split_launches == (2 * steps * layers if f32 else 0), split_launches
    assert len(losses) == steps and all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    step_s = [b - a for a, b in zip(stamps, stamps[1:])][:len(stamps) - 1 - profiled]
    t = TRAIN["seq_len"]
    res = {
        "dtype": dtype, "losses": losses, "wall_s": wall,
        "step_ms_median": 1e3 * statistics.median(step_s), "steps_in_median": len(step_s),
        "first_step_ms_with_setup": 1e3 * (stamps[0] - t0),
        "tokens_per_s": TRAIN["batch_size"] * t / statistics.median(step_s),
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "launches": counts, "split_launches": split_launches, "batch": TRAIN["batch_size"],
        "T": t,
    }
    if profiled:
        res["profile"] = profile_summary(prof["p"], profiled, prof["wall"], family)
    log("phase %d: %s full model, %d SGD steps of train(): %s"
        % (19 if f32 else 7, "f32" if f32 else "bf16", steps, json.dumps(res)))
    return res


def phase_serving_bf16(tfm, kernels, telemetry, GenerationEngine, dev):
    import torch

    t0 = time.perf_counter()
    init_fn, _ = tfm.transformer_lm(dtype=torch.bfloat16, **FULL)
    params = tfm.params_from_jax(init_fn(0), device=dev, dtype=torch.bfloat16)
    init_cache, prefill, decode_step = tfm.transformer_lm_serving(
        max_len=MAX_LEN, dtype=torch.bfloat16, **FULL)
    # a flag on the card that every prefill and decode ORs into in place, so
    # the check is captured with the decode step and runs in every replay
    nonfinite = torch.zeros((), dtype=torch.bool, device=dev)

    def checked(fn):
        def call(*args, **kwargs):
            cache, logits = fn(*args, **kwargs)
            nonfinite.logical_or_(~torch.isfinite(logits).all())
            return cache, logits
        return call

    gen = GenerationEngine(params, (init_cache, checked(prefill), checked(decode_step)),
                           slots=SLOTS, max_len=MAX_LEN, device=dev)
    gen.compile()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, FULL["vocab"], n) for n in PROMPT_LENGTHS]

    telemetry.enable()
    telemetry.reset()
    nonfinite.zero_()
    kernels.flash_attention.launches = 0  # counts from here are the main path's
    t0 = time.perf_counter()
    gen.start(precompile=False)
    try:
        reqs = [gen.submit(p, max_new=MAX_NEW) for p in prompts]
        outs = [r.result(timeout=300) for r in reqs]
    finally:
        gen.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.flash_attention.launches

    h_prefill = telemetry.REGISTRY.get("serve.prefill_seconds")
    h_decode = telemetry.REGISTRY.get("serve.decode_step_seconds")
    dispatches = h_prefill.count()
    for out in outs:
        assert len(out) == MAX_NEW and all(0 <= t < FULL["vocab"] for t in out), out
    assert not bool(nonfinite), "non-finite logits"
    assert launches == dispatches * FULL["n_layers"], (launches, dispatches)
    res = {
        "setup_s": setup_s, "wall_s": wall, "requests": len(outs),
        "new_tokens": sum(len(o) for o in outs),
        "tokens_per_s": sum(len(o) for o in outs) / wall,
        "prefill_dispatches": dispatches, "decode_steps": h_decode.count(),
        "flash_launches": launches,
        "prefill_p50_s": h_prefill.percentile(50), "prefill_p99_s": h_prefill.percentile(99),
        "decode_step_p50_s": h_decode.percentile(50), "decode_step_p99_s": h_decode.percentile(99),
        "prefill_mean_s": h_prefill.sum() / dispatches,
        "decode_step_mean_s": h_decode.sum() / h_decode.count(),
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
    }
    log("phase 6: bf16 full model, %d requests x %d tokens via GenerationEngine: %s"
        % (len(outs), MAX_NEW, json.dumps(res)))
    return res


def time_ms(fn, reps, warmup, flush):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()  # evict the 50 MB L2 so each launch starts cold
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def flash_fwd_row(kernels, n, t, h, d, dtype, dev, rng, flush, reps):
    """Phase 8's numbers of the forward kernel at one causal shape."""
    import torch
    import torch.nn.functional as F

    q, k, v = (_randn((n, t, h, d), dtype, dev, rng) for _ in range(3))
    err = max_err(kernels, q, k, v, True)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def kern():
        return kernels.flash_attention(q, k, v, causal=True)

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    kernel_ms = time_ms(kern, reps, 5, flush)
    # causal: t(t+1)/2 live (q, k) pairs, 2*d flops each for q.k and for p.v
    flops = 2.0 * n * h * d * t * (t + 1)
    nbytes = 4 * n * t * h * d * q.element_size() + 4 * n * h * t  # q k v o + f32 lse
    t_ops = split_products(dtype) * flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    key = str(dtype).split(".")[-1]
    return {
        "n": n, "T": t, "H": h, "D": d, "dtype": key, "causal": True,
        "max_abs_err": err, "ms": kernel_ms, "kernel_ms": kernel_ms,
        "plain_ms": time_ms(lambda: kernels.reference_attention(q, k, v, causal=True), 10, 2,
                            flush),
        "library_ms": time_ms(lib, reps, 5, flush),
        "device_ms": device_ms(kern, reps, 5, flush), "host_ms": host_ms(kern, reps, 5),
        "library_device_ms": device_ms(lib, reps, 5, flush),
        "library_host_ms": host_ms(lib, reps, 5),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bound_counts": BOUND_COUNTS[key], "flops": flops, "bytes": nbytes,
        **split_row(kernels, (q, k, v), flush, reps),
    }


def split_row(kernels, xs, flush, reps):
    """For f32 operands: the device ms of the split pass the wrapper runs
    first (``split_planes`` of ``xs``; inside the kernel's ``ms``), and its
    bound, 4 bytes read and 4 written a value."""
    import torch

    if xs[0].dtype != torch.float32 or not hasattr(kernels, "split_planes"):
        return {}
    nbytes = 8 * len(xs) * xs[0].numel()
    return {"split_device_ms": device_ms(lambda: kernels.split_planes(*xs), reps, 3, flush),
            "split_bound_ms": nbytes / PEAK_BYTES * 1e3, "split_bytes": nbytes}


F32_DESIGN = "tma+wgmma, 3 bf16 products of split hi/lo planes (f32)"


def phase_kernel_times(kernels, dev, launches, f32_launches):
    import torch

    rng = np.random.default_rng(3)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    n, h, d = 4, 16, 64
    shapes = []
    for t in (1024, 2048):
        shapes.append(flash_fwd_row(kernels, n, t, h, d, torch.bfloat16, dev, rng, flush, 30))
        log("  flash_attn_fwd %s" % json.dumps(shapes[-1]))
    f32_rows = [flash_fwd_row(kernels, fn, ft, h, d, torch.float32, dev, rng, flush, 10)
                for fn, ft in ((n, 2048), BWD_TIME_SHAPE[:2])]
    for row in f32_rows:
        row["launches"] = f32_launches
        log("  flash_attn_fwd %s" % json.dumps(row))
    f32 = f32_rows[0]
    head = shapes[-1]
    entry = {
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attn_fwd.cu",
        "design": "tma+wgmma (bf16); " + F32_DESIGN,
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:263",
        "launches": launches,
        **{key: head[key] for key in ("max_abs_err", "ms", "kernel_ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms", "device_ms",
                                      "host_ms", "library_device_ms", "library_host_ms")},
        "shapes": shapes, "f32": f32, "f32_shapes": f32_rows,
    }
    return [entry]


def flash_bwd_rows(kernels, dtype, dev, rng, flush, reps, shape=BWD_TIME_SHAPE):
    """Phase 8's numbers of the two backward kernels at ``shape`` (n, T, H,
    D; by default the training path's attention shape), causal: {name:
    row}."""
    import torch
    import torch.nn.functional as F

    n, t, h, d = shape
    args = bwd_inputs(kernels, n, t, h, d, dtype, True, dev, rng)
    errs = bwd_errors(kernels, args, True)
    kern = {"flash_attn_bwd_dq": lambda: kernels.flash_attention_dq(*args, causal=True),
            "flash_attn_bwd_dkv": lambda: kernels.flash_attention_dkv(*args, causal=True)}
    # the plain version computes dq, dk and dv together
    plain_ms = time_ms(lambda: kernels.reference_attention_bwd(*args, causal=True), 5, 1, flush)
    q, k, v, do = args[:4]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)

    def lib():
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    library = {"library_ms": time_ms(lib, reps, 3, flush),
               "library_device_ms": device_ms(lib, reps, 3, flush),
               "library_host_ms": host_ms(lib, reps, 3)}
    pairs = t * (t + 1)  # twice the live (q, k) pairs under the causal mask
    esize = q.element_size()
    work = {  # flops, bytes: each input read once, each output written once
        "flash_attn_bwd_dq": (3.0 * n * h * d * pairs, 5 * n * t * h * d * esize + 8 * n * h * t),
        "flash_attn_bwd_dkv": (4.0 * n * h * d * pairs, 6 * n * t * h * d * esize + 8 * n * h * t),
    }
    key = str(dtype).split(".")[-1]
    rows = {}
    for name, (flops, nbytes) in work.items():
        t_ops = split_products(dtype) * flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        ms = time_ms(kern[name], reps, 3, flush)
        rows[name] = {
            "max_abs_err": errs[name]["max_abs_err"], "rel_err": errs[name]["rel_err"],
            "ms": ms, "kernel_ms": ms, "device_ms": device_ms(kern[name], reps, 3, flush),
            "host_ms": host_ms(kern[name], reps, 3),
            "plain_ms": plain_ms, "plain_computes": "dq, dk, dv",
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_counts": BOUND_COUNTS[key], **library,
            "library_computes": "scaled_dot_product_attention backward: dq, dk, dv",
            "n": n, "T": t, "H": h, "D": d, "dtype": key, "causal": True,
            "flops": flops, "bytes": nbytes,
        }
    split = split_row(kernels, args[:4], flush, reps)
    rows["flash_attn_bwd_dkv"].update(split)
    if takes_planes(kernels):  # f32 dq splits its operands too (older trees: not)
        rows["flash_attn_bwd_dq"].update(split)
    if dtype == torch.float32:
        pair = backward_pair(kernels, args)
        summary = {"ms": time_ms(pair, reps, 3, flush),
                   "device_ms": device_ms(pair, reps, 3, flush),
                   "host_ms": host_ms(pair, reps, 3), "computes": "dq, dk, dv",
                   "shared_split": pair.shared}
        for row in rows.values():
            row["pair"] = summary
    return rows


def takes_planes(kernels):
    """Whether the backward wrappers take a split made once for both."""
    return "planes" in inspect.signature(kernels.flash_attention_dq).parameters


def backward_pair(kernels, args):
    """dq and dk/dv of ``args`` (q, k, v, dO, lse, delta; causal) as the
    autograd backward runs them: on the planes of one split pass where the
    wrappers take ``planes`` (``pair.shared``), else each wrapper with its
    own split (older trees)."""
    shared = takes_planes(kernels)

    def pair():
        kw = {"planes": kernels.split_planes(*args[:4])} if shared else {}
        kernels.flash_attention_dq(*args, causal=True, **kw)
        kernels.flash_attention_dkv(*args, causal=True, **kw)

    pair.shared = shared
    return pair


def phase_bwd_times(kernels, dev, launches, f32_launches):
    """Kernels-line entries of the two backward kernels at the training
    path's attention shape: n=8, T=2047, H=16, D=64, causal; bf16, and
    f32 under ``f32``."""
    import torch

    rng = np.random.default_rng(6)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    rows = flash_bwd_rows(kernels, torch.bfloat16, dev, rng, flush, 20)
    f32 = flash_bwd_rows(kernels, torch.float32, dev, rng, flush, 5)
    f32_t2048 = flash_bwd_rows(kernels, torch.float32, dev, rng, flush, 5, (4, 2048, 16, 64))
    entries = []
    for name, row in rows.items():
        for r in (f32, f32_t2048):
            r[name]["launches"] = f32_launches[name]
        entries.append({
            "name": name, "route": "cuda", "source": "mxnet_tpu_torch/csrc/flash_attn_bwd.cu",
            "design": "tma+wgmma (bf16); " + F32_DESIGN,
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:%d" % (
                295 if name.endswith("dq") else 316),
            "launches": launches[name], **row, "f32": f32[name],
            "f32_shapes": [f32[name], f32_t2048[name]],
        })
        log("  %s %s" % (name, json.dumps(entries[-1])))
    return entries


def resnet_conv_shapes(resnet, kernels, batch):
    """{(data, weight, pad): convolutions of that shape} over ResNet-50's
    in-envelope convolutions at ``batch``, 3 x 224 x 224, from infer_shape."""
    shapes = {}
    for layer in resnet.conv_layers(resnet.get_symbol(), (batch, 3, 224, 224)):
        if kernels.conv_bwd_plan(layer["data"], layer["weight"], layer["stride"], layer["pad"],
                                 layer["dilate"], "float32"):
            key = (layer["data"], layer["weight"], layer["pad"])
            shapes[key] = shapes.get(key, 0) + 1
    assert sum(shapes.values()) == RESNET_CONVS, shapes
    return shapes


def conv_inputs(dshape, wshape, pad, dtype, dev, rng):
    """x, w and an output gradient g of one convolution shape."""
    import torch

    n, _, h, w = dshape
    o, _, kh, kw = wshape
    oshape = (n, o, h + 2 * pad[0] - kh + 1, w + 2 * pad[1] - kw + 1)
    x = _randn(dshape, dtype, dev, rng)
    wt = (0.1 * _randn(wshape, torch.float32, dev, rng)).to(dtype)
    g = _randn(oshape, dtype, dev, rng)
    return x, wt, g


def conv_errors(kernels, x, w, g, dshape, wshape, pad):
    """Per conv kernel: max |kernel - plain| / max |plain| of the f32
    output, the max abs error, and whether a second launch gave the same
    bits."""
    import torch

    got = {"conv_bwd_filter": kernels.conv_bwd_filter(x, g, wshape, pad),
           "conv_bwd_input": kernels.conv_bwd_input(g, w, dshape, pad)}
    torch.cuda.synchronize()
    again = {"conv_bwd_filter": kernels.conv_bwd_filter(x, g, wshape, pad),
             "conv_bwd_input": kernels.conv_bwd_input(g, w, dshape, pad)}
    torch.cuda.synchronize()
    want = {"conv_bwd_filter": kernels.conv_bwd_filter_reference(x, g, wshape, pad),
            "conv_bwd_input": kernels.conv_bwd_input_reference(g, w, dshape, pad)}
    out = {}
    for name in got:
        a, b = got[name], want[name]
        assert a.dtype == torch.float32 and a.shape == b.shape, (name, a.dtype, a.shape)
        if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
            raise AssertionError("%s or its plain version is not finite" % name)
        diff = (a - b).abs().max().item()
        out[name] = {"rel_err": diff / max(b.abs().max().item(), 1e-30), "max_abs_err": diff,
                     "bitwise_repeat": torch.equal(a, again[name])}
    for name, same in shared_grad_bits(kernels, x, w, g, dshape, wshape, pad, got).items():
        out[name]["shared_g_cl_bitwise"] = same
    return out


def shared_grad_bits(kernels, x, w, g, dshape, wshape, pad, got):
    """Per conv kernel: whether grad's channels-last copy (f32: its hi and
    lo planes) made once and handed to it (``g_cl``), and the autograd
    Function's backward that does so for both, give the bits of its
    standalone call ``got``."""
    import torch

    g_cl = kernels.conv_grad_channels_last(g)
    shared = {"conv_bwd_filter": kernels.conv_bwd_filter(x, g, wshape, pad, g_cl=g_cl),
              "conv_bwd_input": kernels.conv_bwd_input(g, w, dshape, pad, g_cl=g_cl)}
    leaves = [x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()]
    kernels.conv2d_kernel_bwd(*leaves, pad).backward(g)
    torch.cuda.synchronize()
    autograd = {"conv_bwd_filter": (leaves[1].grad, w.dtype),
                "conv_bwd_input": (leaves[0].grad, x.dtype)}
    return {name: torch.equal(shared[name], got[name])
            and torch.equal(autograd[name][0], got[name].to(autograd[name][1]))
            for name in got}


def conv_checks(kernels, cases, dev, rng, seconds=None):
    """K2 and K3 against their plain versions on ``cases`` [((data, weight,
    pad), dtypes)]: each within 1e-4 of max|plain|, a repeat bitwise, the
    shared channels-last grad bitwise. Returns (worst error by kernel and
    dtype, every case's errors); ``seconds``, a dict, gets each dtype's."""
    worst, errs = {}, {}
    for (dshape, wshape, pad), dtypes in cases:
        for dtype in dtypes:
            key = str(dtype).split(".")[-1]
            t_case = time.perf_counter()
            args = conv_inputs(dshape, wshape, pad, dtype, dev, rng)
            for name, e in conv_errors(kernels, *args, dshape, wshape, pad).items():
                log("  %s data=%s weight=%s pad=%s %s: rel_err %.3g (tol 1e-4) max_abs_err "
                    "%.3g, bitwise repeat %s, shared g_cl bitwise %s"
                    % (name, dshape, wshape, pad, key, e["rel_err"], e["max_abs_err"],
                       e["bitwise_repeat"], e["shared_g_cl_bitwise"]))
                if not e["rel_err"] <= 1e-4:
                    raise AssertionError("%s disagrees with the plain version" % name)
                if not e["bitwise_repeat"]:
                    raise AssertionError("%s is not bitwise repeatable" % name)
                if not e["shared_g_cl_bitwise"]:
                    raise AssertionError("%s with the shared channels-last grad differs from "
                                         "its standalone call" % name)
                worst[name + " " + key] = max(worst.get(name + " " + key, 0.0), e["rel_err"])
                errs[(name, dshape, wshape, pad, key)] = e
            if seconds is not None:
                seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t_case
    return worst, errs


def phase_conv_checks(kernels, resnet, dev):
    import torch

    cases = [(key, (torch.float32, torch.bfloat16)) for key in
             list(resnet_conv_shapes(resnet, kernels, RESNET_BATCH)) + CONV_RAGGED]
    cases += [(key, (torch.float32,)) for key in CONV_DEEP]
    worst, errs = conv_checks(kernels, cases, dev, np.random.default_rng(7))
    log("phase 9: conv-backward kernels vs plain ok over %d shapes, worst rel_err %s"
        % (len(cases), json.dumps(worst)))
    return worst, errs


def grads_kernel_vs_plain(kernels, symbol, params, aux, data, label, seed=0):
    """Every parameter gradient and new aux state of ``symbol`` in training
    mode through K2/K3 against the same through their plain versions, at
    rtol = atol = 1e-3 of each tensor's max|.|. Dropout draws the same
    masks in each run (a generator seeded with ``seed``). A tensor that two
    runs of the plain path do not reproduce to 1e-3 of its max (a
    cancelling sum, moved by ops outside K2/K3 that are not bitwise
    repeatable) is held to three times that spread. Returns (worst error,
    tensors held to 1e-3, the noisy ones, K2/K3 launches of the kernel
    run)."""
    import torch

    from mxnet_tpu_torch.executor import _GraphProgram

    program = _GraphProgram(symbol)

    def grads():
        gen = torch.Generator(device=data.device).manual_seed(seed)
        outs, new_aux = program({**params, "data": data, "softmax_label": label}, aux, gen, True)
        got = torch.autograd.grad(outs[0].sum(), list(params.values()), allow_unused=True)
        torch.cuda.synchronize()
        out = {n: torch.zeros_like(p) if g is None else g
               for (n, p), g in zip(params.items(), got)}
        out.update({"aux " + n: v.detach() for n, v in new_aux.items()})
        return out

    zero_counts(kernels)
    got = grads()
    counts = conv_counts(kernels)
    swapped = (kernels.conv_bwd_filter, kernels.conv_bwd_input)
    # the plain versions in the wrappers' place; they need no g_cl
    kernels.conv_bwd_filter = lambda *args, g_cl=None: kernels.conv_bwd_filter_reference(*args)
    kernels.conv_bwd_input = lambda *args, g_cl=None: kernels.conv_bwd_input_reference(*args)
    try:
        want, again = grads(), grads()
    finally:
        kernels.conv_bwd_filter, kernels.conv_bwd_input = swapped
    worst, noisy = 0.0, {}
    for name, w in want.items():
        g = got[name]
        if not bool(torch.isfinite(g).all()):
            raise AssertionError("%s is not finite" % name)
        m = w.abs().max().clamp_min(1e-30)
        err = ((g - w).abs().max() / m).item()
        # the plain path run twice: ops outside K2/K3 are not bitwise
        # repeatable, which shows in gradients that are tiny cancelling
        # sums (bn0_gamma); there the bound is that spread
        spread = ((again[name] - w).abs().max() / m).item()
        if spread > 1e-3:
            noisy[name] = {"err": err, "plain_run_to_run": spread}
            if not err <= 3 * spread:
                raise AssertionError("%s: kernel vs plain %.3g of max, plain vs plain %.3g"
                                     % (name, err, spread))
            continue
        torch.testing.assert_close(g / m, w / m, rtol=1e-3, atol=1e-3, msg=name)
        worst = max(worst, err)
    return worst, len(want) - len(noisy), noisy, counts


def phase_resnet_grads_f32(resnet_bench, kernels, dev):
    _, (params, _, aux), data, label, symbol = resnet_bench.build_step(2, False, dev)
    worst, held, noisy, counts = grads_kernel_vs_plain(kernels, symbol, params, aux, data, label)
    assert counts == dict.fromkeys(counts, RESNET_CONVS), counts
    log("phase 10: f32 ResNet-50 (batch 2, 224x224) gradients and aux, K2/K3 vs plain: worst "
        "err %.3g of max (rtol = atol = 1e-3) over %d tensors; not repeatable between two plain "
        "runs (held to 3x that spread): %s; launches %s"
        % (worst, held, json.dumps(noisy), json.dumps(counts)))
    return {"worst_rel_err": worst, "tensors": held + len(noisy), "noisy": noisy,
            "launches": counts}


def phase_resnet_train(resnet_bench, kernels, dev, dtype):
    import torch

    bf16 = dtype == "bfloat16"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    step, (params, moms, aux), data, label, symbol = resnet_bench.build_step(
        RESNET_BATCH, bf16, dev)
    flops = 3.0 * resnet_bench.model_flops(symbol, tuple(data.shape))
    setup_s = time.perf_counter() - t0
    zero_counts(kernels)  # counts from here are this path's
    losses, stamps, per_step = [], [time.perf_counter()], []
    for _ in range(1 + RESNET_STEPS):
        aux, prob = step(params, moms, aux, data, label)
        losses.append(float(resnet_bench.cross_entropy(prob, label)))  # synchronises
        stamps.append(time.perf_counter())
        per_step.append(conv_counts(kernels))
    flash = read_counts(kernels)
    prev = dict.fromkeys(per_step[0], 0)
    for i, c in enumerate(per_step):
        for name, n in c.items():
            assert n - prev[name] == RESNET_CONVS, (dtype, i, name, n - prev[name])
        prev = c
    assert flash == dict.fromkeys(flash, 0), flash
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    step_s = [b - a for a, b in zip(stamps[1:], stamps[2:])]  # after the warm-up step
    med = statistics.median(step_s)
    res = {
        "dtype": dtype, "batch": RESNET_BATCH, "steps": RESNET_STEPS, "warmup": 1,
        "losses": losses, "setup_s": setup_s,
        "first_step_ms_with_build": 1e3 * (stamps[1] - stamps[0]),
        "step_ms_median": 1e3 * med, "step_ms_mean": 1e3 * statistics.mean(step_s),
        "img_per_s": RESNET_BATCH / med, "tflops_per_step": flops / 1e12,
        "tflops_per_s": flops / med / 1e12,
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "launches": per_step[-1], "tf32": False,
    }
    log("phase 11: ResNet-50 %s batch %d, 1 + %d steps of resnet_bench's step: %s"
        % (dtype, RESNET_BATCH, RESNET_STEPS, json.dumps(res)))
    return res


# how a bound counts operations: an f32 product keeps the f32 limit as three
# bf16 products of its hi and lo planes (the f32 conv kernels' design)
BOUND_COUNTS = {
    "bfloat16": "operations at 989 TFLOP/s (bf16 tensor cores), f32 output bytes",
    "float32": "3 bf16 products per f32 product at 989 TFLOP/s, f32 input and output bytes",
}


def split_products(dtype):
    import torch

    return 3 if dtype == torch.float32 else 1


def conv_work(name, dshape, wshape, pad, esize):
    """(flops, bytes) of one kernel call: 2·N·OH·OW·O·C·kh·kw; each input
    read once, the f32 output written once."""
    n, c, h, w = dshape
    o, _, kh, kw = wshape
    oh, ow = h + 2 * pad[0] - kh + 1, w + 2 * pad[1] - kw + 1
    flops = 2.0 * n * oh * ow * o * c * kh * kw
    x, g, wt = n * c * h * w, n * o * oh * ow, o * c * kh * kw
    if name == "conv_bwd_filter":
        return flops, (x + g) * esize + 4 * wt
    return flops, (g + wt) * esize + 4 * x


def conv_time_rows(kernels, shapes, dtypes, dev, errs, rng):
    """Phase 12's numbers of K2 and K3 at each of ``shapes`` ({(data, weight,
    pad): convolutions of that shape a step}) in each of ``dtypes``: the
    kernel's ``ms``, ``device_ms`` and ``host_ms``, the plain version's ms,
    the library call's ms and device ms, the bound and ``errs``' error.
    Returns {kernel name: [row, ...]}."""
    import torch
    from torch.nn.grad import conv2d_input, conv2d_weight

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    rows = {"conv_bwd_filter": [], "conv_bwd_input": []}
    for dtype in dtypes:
        key = str(dtype).split(".")[-1]
        for (dshape, wshape, pad), count in shapes.items():
            x, w, g = conv_inputs(dshape, wshape, pad, dtype, dev, rng)
            calls = {
                "conv_bwd_filter": (
                    lambda: kernels.conv_bwd_filter(x, g, wshape, pad),
                    lambda: kernels.conv_bwd_filter_reference(x, g, wshape, pad),
                    lambda: conv2d_weight(x, wshape, g, padding=pad)),
                "conv_bwd_input": (
                    lambda: kernels.conv_bwd_input(g, w, dshape, pad),
                    lambda: kernels.conv_bwd_input_reference(g, w, dshape, pad),
                    lambda: conv2d_input(dshape, w, g, padding=pad)),
            }
            for name, (kern, plain, lib) in calls.items():
                flops, nbytes = conv_work(name, dshape, wshape, pad, x.element_size())
                t_ops, t_bytes = split_products(dtype) * flops / PEAK_BF16_FLOPS * 1e3, \
                    nbytes / PEAK_BYTES * 1e3
                row = {
                    "dtype": key, "data": dshape, "weight": wshape, "pad": pad,
                    "convs_per_step": count, "ms": time_ms(kern, 10, 2, flush),
                    "device_ms": device_ms(kern, 10, 2, flush), "host_ms": host_ms(kern, 10, 2),
                    "plain_ms": time_ms(plain, 3, 1, flush), "library_ms": time_ms(lib, 10, 2, flush),
                    "library_device_ms": device_ms(lib, 10, 2, flush),
                    "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "bound_counts": BOUND_COUNTS[key],
                    "flops": flops, "bytes": nbytes,
                    "max_abs_err": errs[(name, dshape, wshape, pad, key)]["max_abs_err"],
                    "rel_err": errs[(name, dshape, wshape, pad, key)]["rel_err"],
                }
                rows[name].append(row)
                log("  %s %s" % (name, json.dumps(row)))
    return rows


STEP_FIELDS = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms")


def per_step(rows, key):
    """The launch-weighted sums of a step over ``rows`` of dtype ``key``."""
    mine = [r for r in rows if r["dtype"] == key]
    return {f: sum(r[f] * r["convs_per_step"] for r in mine) for f in STEP_FIELDS}


def phase_conv_times(kernels, resnet, dev, launches, errs):
    """Kernels-line entries of K2 and K3; see the module docstring."""
    import torch

    rows = conv_time_rows(kernels, resnet_conv_shapes(resnet, kernels, RESNET_BATCH),
                          (torch.bfloat16, torch.float32), dev, errs, np.random.default_rng(8))
    entries = []
    for name, shape_rows in rows.items():
        step = {key: per_step(shape_rows, key) for key in ("bfloat16", "float32")}
        head, f32_head = (max((r for r in shape_rows if r["dtype"] == key),
                              key=lambda r: r["ms"] * r["convs_per_step"])
                          for key in ("bfloat16", "float32"))
        f32_design = ("f32: the same kernel on the split-bf16 hi and lo planes of channels-last "
                      "copies, three wgmma products (hi·lo, lo·hi, hi·hi) a k16 step into an f32 "
                      "accumulator added into a second on the CUDA cores every 8 k steps")
        entries.append({
            "name": name, "route": "cuda", "source": "mxnet_tpu_torch/csrc/conv_bwd.cu",
            "design": ("tma+wgmma implicit GEMM on channels-last copies (both operands "
                       "MN-major) or on NCHW in place (1x1), CTAs of two warpgroups (128 o) "
                       "where O > 64, one-wave split of M + ordered reduce (bf16); " + f32_design
                       if name == "conv_bwd_filter" else
                       "tma+wgmma implicit GEMM on channels-last copies (bf16); " + f32_design),
            "timed_with": "the wrapper's own layout transposes inside each timed call",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:%d" % (
                745 if name == "conv_bwd_filter" else 804),
            "launches": launches[name],
            **{f: head[f] for f in ("max_abs_err", "rel_err", "ms", "device_ms", "host_ms",
                                    "plain_ms", "bound_ms", "bound_by", "library_ms",
                                    "library_device_ms", "dtype", "data", "weight", "pad",
                                    "convs_per_step", "flops", "bytes")},
            "kernel_ms": head["ms"],
            "library_computes": "torch.nn.grad.%s" % (
                "conv2d_weight" if name == "conv_bwd_filter" else "conv2d_input"),
            "launch_weighted_ms_per_step": step,
            "f32": {f: f32_head[f] for f in ("data", "weight", "pad", "convs_per_step", "ms",
                                               "device_ms", "host_ms", "plain_ms", "library_ms",
                                               "library_device_ms", "bound_ms", "bound_by",
                                               "bound_counts", "max_abs_err", "rel_err")},
            "shapes": shape_rows,
        })
        log("  %s per step %s, headline shape %s %s" % (
            name, json.dumps(step), head["data"], head["weight"]))
    return entries


def zoo_models(model_sweep):
    """Phase 20's models: {name: (((module, kwargs), side, batch, k80), dtypes
    trained)}."""
    zoo = {name: (model_sweep.MODELS[name], ("float32", "bfloat16")) for name in ZOO_SWEEP}
    zoo.update({name: (spec, ("float32",)) for name, spec in ZOO_EXTRA.items()})
    return zoo


def zoo_conv_shapes(model_sweep, kernels, spec, dtype):
    """{(data, weight, pad): convolutions of that shape} over the in-envelope
    convolutions of one zoo model (``spec`` as in ``zoo_models``) in
    ``dtype``, at its published batch and side."""
    (module, kwargs), side, batch, _ = spec
    shape = (batch, 3, side, side)
    symbol = model_sweep.build_symbol(module, kwargs, side)
    shapes = {}
    for layer in model_sweep.conv_layers(symbol, shape):
        if kernels.conv_bwd_plan(layer["data"], layer["weight"], layer["stride"], layer["pad"],
                                 layer["dilate"], dtype):
            key = (layer["data"], layer["weight"], layer["pad"])
            shapes[key] = shapes.get(key, 0) + 1
    return shapes


def phase_zoo(model_sweep, kernels, dev, full=True):
    """Phase 20 (see the module docstring; without ``full`` (a) checks and
    (c) trains f32 alone). Returns (results, K2/K3 launches of its training
    rows)."""
    import torch

    zoo = zoo_models(model_sweep)
    res = {"counts": {}}
    # (a) every distinct in-envelope convolution shape, f32 and bf16
    dtypes_of = {}
    for name, (spec, _) in zoo.items():
        res["counts"][name] = {}
        for dtype in ("float32", "bfloat16") if full else ("float32",):
            shapes = zoo_conv_shapes(model_sweep, kernels, spec, dtype)
            res["counts"][name][dtype] = {"convs": sum(shapes.values()),
                                          "distinct": len(shapes)}
            for key in shapes:
                dtypes_of.setdefault(key, []).append(getattr(torch, dtype))
    cases = [(key, tuple(dict.fromkeys(dts))) for key, dts in dtypes_of.items()]
    t0 = time.perf_counter()
    by_dtype = {}
    worst, errs = conv_checks(kernels, cases, dev, np.random.default_rng(20), by_dtype)
    res["conv_checks"] = {"shapes": len(cases), "cases": sum(len(d) for _, d in cases),
                          "worst_rel_err": worst, "s": time.perf_counter() - t0,
                          "s_by_dtype": by_dtype}
    log("phase 20 (a): K2/K3 vs plain ok over the zoo's %d distinct in-envelope shapes (%d "
        "shape-dtype cases; in-envelope convolutions by model and dtype %s), worst rel_err %s"
        % (len(cases), res["conv_checks"]["cases"], json.dumps(res["counts"]),
           json.dumps(worst)))
    # (b) full-width f32 gradients, kernel against plain
    res["grads_f32"] = {}
    t0 = time.perf_counter()
    for name in ZOO_GRAD_MODELS:
        (module, kwargs), side, _, _ = zoo[name][0]
        _, (params, _, aux), data, label, symbol = model_sweep.build_step(
            module, kwargs, side, ZOO_GRAD_BATCH, False, dev)
        convs = model_sweep.in_envelope_convs(symbol, tuple(data.shape), "float32")
        worst_g, held, noisy, counts = grads_kernel_vs_plain(kernels, symbol, params, aux,
                                                             data, label)
        assert counts == dict.fromkeys(counts, convs), (name, counts, convs)
        res["grads_f32"][name] = {"batch": ZOO_GRAD_BATCH, "side": side,
                                  "worst_rel_err": worst_g, "tensors": held + len(noisy),
                                  "noisy": noisy, "launches": counts}
        log("phase 20 (b): f32 %s (batch %d, %dx%d) gradients and aux, K2/K3 vs plain: worst "
            "err %.3g of max (rtol = atol = 1e-3) over %d tensors; held to 3x the plain "
            "run-to-run spread: %s; launches %s" % (name, ZOO_GRAD_BATCH, side, side, worst_g,
                                                   held, json.dumps(noisy), json.dumps(counts)))
        del params, aux, data, label
        torch.cuda.empty_cache()
    res["grads_f32_s"] = time.perf_counter() - t0
    # (c) training at the published batch and side (main path 7)
    res["train"], launches = [], dict.fromkeys(("conv_bwd_filter", "conv_bwd_input"), 0)
    for name, (spec, dtypes) in zoo.items():
        for dtype in dtypes if full else [d for d in dtypes if d == "float32"]:
            zero_counts(kernels)  # counts from here are this row's
            row = model_sweep.run_row(name, dtype, ZOO_STEPS, dev, model=spec,
                                      lr=ZOO_LR.get(name, model_sweep.resnet_bench.LR))
            counts = conv_counts(kernels)
            want = (1 + ZOO_STEPS) * row["in_envelope_convs"]
            assert counts == dict.fromkeys(counts, want), (name, dtype, counts, want)
            row["launches"] = counts
            for k in launches:
                launches[k] += counts[k]
            res["train"].append(row)
            log("phase 20 (c): %s %s batch %d: %s" % (name, dtype, row["batch"],
                                                      json.dumps(row)))
    # (d) inception-v3's conv gradients in one f32 step against cuDNN
    shapes = zoo_conv_shapes(model_sweep, kernels, zoo["inception-v3"][0], "float32")
    rows = conv_time_rows(kernels, shapes, (torch.float32,), dev, errs,
                          np.random.default_rng(21))
    res["inception_v3_f32_step"] = {
        name: {"launches_per_step": sum(shapes.values()), "distinct_shapes": len(shapes),
               "launch_weighted_ms_per_step": per_step(shape_rows, "float32"),
               "library_computes": "torch.nn.grad.%s" % (
                   "conv2d_weight" if name == "conv_bwd_filter" else "conv2d_input"),
               "shapes": shape_rows}
        for name, shape_rows in rows.items()}
    log("phase 20 (d): inception-v3 f32 batch 32, K2/K3 against cuDNN (TF32 off), a step: %s"
        % json.dumps({n: {k: v for k, v in r.items() if k != "shapes"}
                      for n, r in res["inception_v3_f32_step"].items()}))
    return res, launches


def _rtc_errors(out, want, dtype):
    """Worst error of an Rtc kernel against its plain version, and whether
    it is inside the tolerance: rtol 1e-6 in f32, one bf16 ulp of the
    larger magnitude in bf16."""
    import torch

    got, want = out.float(), want.float()
    err = (got - want).abs()
    if dtype == torch.float32:
        ok = bool((err <= 1e-6 * want.abs()).all())
    else:
        mag = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
        ok = bool((err <= 2.0 ** (torch.floor(torch.log2(mag)) - 7)).all())
    return err.max().item(), ok


def phase_rtc(mx, rk, dev):
    import torch

    rng = np.random.default_rng(9)
    worst, cases = {}, 0
    small = {"axpb": (8, 128), "madd": (4, 128), "exp5": (8, 128)}
    for spec, plain in ((rk.AXPB, rk.axpb_plain), (rk.MADD, rk.madd_plain),
                        (rk.EXP5, rk.exp5_plain)):
        for shape in (small[spec[0]], RTC_BIG):
            for dtype in (torch.float32, torch.bfloat16):
                # madd on [0, 1) as test_rtc.py draws it: a·b + a then has no
                # cancellation, so a relative tolerance applies
                ins = [mx.nd.NDArray((torch.from_numpy(rng.random(shape, np.float32)).to(dev)
                                      if spec[0] == "madd" else
                                      0.5 * _randn(shape, torch.float32, dev, rng)).to(dtype))
                       for _ in spec[1]]
                out = mx.nd.zeros(shape, ctx=mx.gpu(0), dtype=dtype)
                size = int(np.prod(shape))
                if spec[0] == "exp5":
                    n = min(size, 1024)
                    dims = ((size // n, 1, 1), (n, 1, 1))
                elif shape == RTC_BIG:
                    dims = rk.grid_stride_dims(size)
                else:  # test_rtc.py's launches: one block of one thread
                    dims = ((1, 1, 1), (1, 1, 1))
                k = rk.make(spec, ins, [out])
                k.push(ins, [out], *dims)
                torch.cuda.synchronize()
                first = out._data.clone()
                k.push(ins, [out], *dims)
                torch.cuda.synchronize()
                err, ok = _rtc_errors(out._data, plain(*[a._data for a in ins]), dtype)
                key = "%s %s" % (spec[0], str(dtype).split(".")[-1])
                log("  rtc %s %s grid %s block %s: max_abs_err %.3g, within tolerance %s, "
                    "bitwise repeat %s" % (key, shape, dims[0], dims[1], err, ok,
                                           torch.equal(first, out._data)))
                if not ok:
                    raise AssertionError("rtc %s disagrees with its plain version" % key)
                if not torch.equal(first, out._data):
                    raise AssertionError("rtc %s is not bitwise repeatable" % key)
                worst[key] = max(worst.get(key, 0.0), err)
                cases += 1
    a, b = (mx.nd.NDArray(torch.rand(4, 128, device=dev)) for _ in range(2))
    out = mx.nd.zeros((4, 128), ctx=mx.gpu(0))
    k = rk.make(rk.MADD, [a, b], [out])
    counts = [len(k._cache)]
    k.push([a, b], [out])
    counts.append(len(k._cache))
    a2, o2 = mx.nd.ones((2, 128), ctx=mx.gpu(0)), mx.nd.zeros((2, 128), ctx=mx.gpu(0))
    k.push([a2, a2], [o2])
    counts.append(len(k._cache))
    torch.cuda.synchronize()
    assert counts == [1, 1, 2] and bool((o2._data == 2.0).all()), counts
    raised = {}
    for what, call in (
            ("bad source", lambda: mx.rtc.Rtc("bad", [("x", a)], [("y", out)], "y[0] = = x[0];")),
            ("wrong array count", lambda: k.push([a], [out]))):
        try:
            call()
        except mx.MXNetError as e:
            raised[what] = str(e).splitlines()[0][:120]
        else:
            raise AssertionError("rtc: %s did not raise" % what)
    log("phase 13: Rtc kernels (a)-(c) vs plain ok over %d cases, worst %s; cache counts %s; "
        "raised %s" % (cases, json.dumps(worst), counts, json.dumps(raised)))
    return {"worst": worst, "cache_counts": counts, "raised": raised}


def _resnet_executor(mx, resnet, symbol, state, data, label):
    """ResNet-50 bound by simple_bind on gpu(0) at ``data``'s shape, grad_req
    null for data and label, arrays holding ``state``'s params and aux."""
    params, aux = state
    req = {n: ("null" if n in ("data", "softmax_label") else "write")
           for n in symbol.list_arguments()}
    exe = symbol.simple_bind(mx.gpu(0), grad_req=req, data=tuple(data.shape),
                             softmax_label=tuple(label.shape))
    with_data = dict(params, data=data, softmax_label=label)
    for n, arr in exe.arg_dict.items():
        arr._data.copy_(with_data[n].detach())
    for n, arr in exe.aux_dict.items():
        arr._data.copy_(aux[n])
    return exe


def phase_executor(mx, resnet, resnet_bench, kernels, dev):
    import torch

    step, (params, moms, aux), data, label, symbol = resnet_bench.build_step(
        RESNET_BATCH, False, dev)
    exe = _resnet_executor(mx, resnet, symbol, (params, aux), data, label)
    zero_counts(kernels)
    exe.forward(is_train=True)
    exe.backward()
    torch.cuda.synchronize()
    counts = conv_counts(kernels)
    new_aux, prob = step(params, moms, aux, data, label)
    torch.cuda.synchronize()
    assert counts == dict.fromkeys(counts, RESNET_CONVS), counts
    lr, wd, rescale = SGD["lr"], SGD["wd"], 1.0 / RESNET_BATCH
    worst, bitwise = 0.0, 0
    with torch.no_grad():
        pairs = [("output", exe.outputs[0]._data, prob)]
        for n, g in exe.grad_dict.items():
            if g is not None:
                p0 = exe.arg_dict[n]._data
                mom = torch.zeros_like(p0).mul_(SGD["momentum"]).sub_(lr * (g._data * rescale
                                                                            + wd * p0))
                pairs.append(("grad " + n, mom, moms[n]))
        pairs += [("aux " + n, a._data, new_aux[n]) for n, a in exe.aux_dict.items()]
        for name, got, want in pairs:
            if not bool(torch.isfinite(got).all()):
                raise AssertionError("executor %s is not finite" % name)
            err = ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()
            if not err <= 1e-6:
                raise AssertionError("executor %s: %.3g of max from make_train_step" % (name, err))
            worst = max(worst, err)
            bitwise += bool(torch.equal(got, want))
    stamps = []
    for _ in range(1 + 5):  # one warm-up, then five timed forward + backward
        exe.forward(is_train=True)
        exe.backward()
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    res = {"tensors": len(pairs), "bitwise_equal": bitwise, "worst_rel_err": worst,
           "launches": counts,
           "fwd_bwd_ms_median": 1e3 * statistics.median(
               b - a for a, b in zip(stamps, stamps[1:]))}
    log("phase 14: ResNet-50 Executor (simple_bind, batch 32, f32) vs make_train_step: %s"
        % json.dumps(res))
    return res


def _update_all(exe, update):
    args = exe.arg_dict  # a property that builds its dict: once a step
    for n, g in exe.grad_dict.items():
        if g is not None:
            update(n, args[n], g)


def phase_rtc_training(mx, rk, resnet, resnet_bench, kernels, dev):
    import torch

    _, (params, _, aux), data, label, symbol = resnet_bench.build_step(RESNET_BATCH, False, dev)
    rescale = 1.0 / RESNET_BATCH
    runs = {}
    for how in ("rtc", "nd"):
        exe = _resnet_executor(mx, resnet, symbol, (params, aux), data, label)
        moms = {n: mx.nd.zeros(g.shape, ctx=mx.gpu(0)) for n, g in exe.grad_dict.items()
                if g is not None}
        compiles0 = mx.rtc.Rtc.compiles
        if how == "rtc":
            spec = rk.sgd_mom_source(rescale_grad=rescale, **SGD)
            first = next(iter(moms))
            kernel = rk.make(spec, [exe.grad_dict[first]], [exe.arg_dict[first], moms[first]])

            def update(n, w, g):
                kernel.push([g], [w, moms[n]], *rk.grid_stride_dims(w.size))
        else:
            def update(n, w, g):
                mx.nd.sgd_mom_update(w, g, moms[n], out=w, rescale_grad=rescale, **SGD)
        zero_counts(kernels)
        mx.rtc.Rtc.launches = 0  # counts from here are this path's
        losses, per_step, compiles = [], [], []
        t0 = time.perf_counter()
        for _ in range(RTC_STEPS):
            exe.forward(is_train=True)
            exe.backward()
            _update_all(exe, update)
            losses.append(float(resnet_bench.cross_entropy(exe.outputs[0]._data, label)))
            per_step.append(dict(conv_counts(kernels), rtc=mx.rtc.Rtc.launches))
            compiles.append(mx.rtc.Rtc.compiles - compiles0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[how] = {"exe": exe, "moms": moms, "losses": losses, "per_step": per_step,
                     "compiles": compiles, "wall_s": wall}
        if how == "rtc":
            runs[how]["kernel"] = kernel
    n_params = len(runs["rtc"]["moms"])
    shapes = {tuple(m.shape) for m in runs["rtc"]["moms"].values()}
    for how, r in runs.items():
        prev = {"conv_bwd_filter": 0, "conv_bwd_input": 0, "rtc": 0}
        for i, c in enumerate(r["per_step"]):
            want = {"conv_bwd_filter": RESNET_CONVS, "conv_bwd_input": RESNET_CONVS,
                    "rtc": n_params if how == "rtc" else 0}
            assert {k: c[k] - prev[k] for k in c} == want, (how, i, c, prev)
            prev = c
        assert all(np.isfinite(r["losses"])) and r["losses"][-1] < r["losses"][0], r["losses"]
    compiles = runs["rtc"]["compiles"]
    assert compiles == [len(shapes)] * RTC_STEPS, (compiles, len(shapes))
    worst, err = 0.0, 0.0
    with torch.no_grad():
        a, b = runs["rtc"]["exe"], runs["nd"]["exe"]
        for n in runs["rtc"]["moms"]:
            for got, want in ((a.arg_dict[n]._data, b.arg_dict[n]._data),
                              (runs["rtc"]["moms"][n]._data, runs["nd"]["moms"][n]._data)):
                diff = (got - want).abs().max().item()
                rel = diff / max(want.abs().max().item(), 1e-30)
                if not rel <= 1e-5:
                    raise AssertionError("%s: Rtc vs sgd_mom_update %.3g of max" % (n, rel))
                worst, err = max(worst, rel), max(err, diff)
    res = {"steps": RTC_STEPS, "params": n_params, "distinct_shapes": len(shapes),
           "losses_rtc": runs["rtc"]["losses"], "losses_nd": runs["nd"]["losses"],
           "worst_rel_err": worst, "max_abs_err": err,
           "launches": runs["rtc"]["per_step"][-1], "nvrtc_compiles_by_step": compiles,
           "wall_s": {h: r["wall_s"] for h, r in runs.items()}}
    log("phase 15: ResNet-50 training through Executor + Rtc sgd_mom (kernel d) vs "
        "nd.sgd_mom_update, %d steps: %s" % (RTC_STEPS, json.dumps(res)))
    return res, runs


def phase_rtc_times(mx, rk, runs, res, dev):
    """Kernels-line entry of K5: kernel (d)'s launches of one step against
    the plain updates of one step."""
    import torch

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    r, p = runs["rtc"], runs["nd"]
    kernel, rescale = r["kernel"], 1.0 / RESNET_BATCH
    steps = {
        "rtc": lambda: _update_all(r["exe"], lambda n, w, g: kernel.push(
            [g], [w, r["moms"][n]], *rk.grid_stride_dims(w.size))),
        "nd": lambda: _update_all(p["exe"], lambda n, w, g: mx.nd.sgd_mom_update(
            w, g, p["moms"][n], out=w, rescale_grad=rescale, **SGD)),
    }
    ms = {how: time_ms(fn, 10, 2, flush) for how, fn in steps.items()}
    # the card alone: a sleep of ~50 ms (100 M clocks) covers the host's
    # enqueue of a step
    dev_ms = {how: device_ms(fn, 10, 2, flush, sleep_cycles=100_000_000)
              for how, fn in steps.items()}
    step_host_ms = {how: host_ms(fn, 10, 2) for how, fn in steps.items()}
    # one launch on the largest parameter array: the kernel's own device time
    big = max(r["moms"], key=lambda n: r["moms"][n].size)
    w, g, m = r["exe"].arg_dict[big], r["exe"].grad_dict[big], r["moms"][big]

    def push_big():
        kernel.push([g], [w, m], *rk.grid_stride_dims(w.size))

    one_ms = time_ms(push_big, 20, 3, flush)
    elems = sum(m.size for m in r["moms"].values())
    nbytes = 20.0 * elems  # w, g, mom read; w, mom written; f32
    entry = {
        "name": "rtc_sgd_mom", "route": "cuda", "source": "mxnet_tpu_torch/rtc_kernels.py",
        "replaces": "mxnet_tpu/rtc.py:71", "launches": res["launches"]["rtc"],
        "max_abs_err": res["max_abs_err"], "rel_err": res["worst_rel_err"],
        "ms": ms["rtc"], "kernel_ms": ms["rtc"], "plain_ms": ms["nd"],
        "host_ms": host_ms(push_big, 50, 5), "host_ms_step": step_host_ms["rtc"],
        "device_ms": dev_ms["rtc"], "plain_host_ms_step": step_host_ms["nd"],
        "plain_device_ms": dev_ms["nd"],
        "host_note": "host_ms: one push (the largest array); host_ms_step: the step's pushes",
        "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes", "library_ms": None,
        "library_note": "none: no single PyTorch call computes MXNet's sgd_mom_update",
        "per": "one step: %d launches over %d parameter arrays, %d elements, f32"
               % (res["params"], res["params"], elems),
        "bytes": nbytes, "largest_array": {
            "name": big, "elements": w.size, "ms": one_ms,
            "bound_ms": 20.0 * w.size / PEAK_BYTES * 1e3},
        "nvrtc_compiles": mx.rtc.Rtc.compiles,
        "nvrtc_ms_per_compile": 1e3 * mx.rtc.Rtc.compile_seconds / mx.rtc.Rtc.compiles,
    }
    log("  rtc_sgd_mom %s" % json.dumps(entry))
    return [entry]


def phase_rtc_push(mx, rk, resnet, dev):
    """K5's push path alone (``--only rtc``, on any tree's package): kernel
    (d) pushed once on each of ResNet-50's 157 f32 parameter arrays (random
    values, no executor), as one step: ``ms`` (events around the step),
    ``host_ms_step`` and ``host_ms`` (the host's enqueue of the step and of
    one push on the largest array), ``device_ms`` (the card alone, after a
    ~50 ms sleep kernel) and, where the package keeps launch records, the
    host µs a call of the push's parts: the launch (``_nvrtc.launch``), the
    CUDA driver call alone (``cuLaunchKernel``) and the stream lookup."""
    import ctypes

    import torch

    symbol = resnet.get_symbol()
    shapes = dict(zip(symbol.list_arguments(), symbol.infer_shape(
        data=(RESNET_BATCH, 3, 224, 224), softmax_label=(RESNET_BATCH,))[0]))
    names = [n for n in symbol.list_arguments() if n not in ("data", "softmax_label")]
    rng = np.random.default_rng(14)
    arrays = {n: [mx.nd.array(rng.standard_normal(shapes[n]).astype(np.float32), ctx=mx.gpu(0))
                  for _ in range(3)] for n in names}
    kernel = rk.make(rk.sgd_mom_source(rescale_grad=1.0 / RESNET_BATCH, **SGD),
                     [arrays[names[0]][1]], [arrays[names[0]][0], arrays[names[0]][2]])

    def step():
        for n in names:
            w, g, m = arrays[n]
            kernel.push([g], [w, m], *rk.grid_stride_dims(w.size))

    big = max(names, key=lambda n: arrays[n][0].size)
    w, g, m = arrays[big]
    dims = rk.grid_stride_dims(w.size)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    res = {"params": len(names), "ms": time_ms(step, 10, 2, flush),
           "host_ms_step": host_ms(step, 10, 2),
           "device_ms": device_ms(step, 10, 2, flush, sleep_cycles=100_000_000),
           "host_ms": host_ms(lambda: kernel.push([g], [w, m], *dims), 200, 10)}
    records = getattr(kernel, "_records", None)
    if records:
        from mxnet_tpu_torch import _nvrtc

        record = next(r for key, r in records.items()
                      if key[0][0] == g._data.shape and r.grid == dims[0])
        ptrs = [x._data.data_ptr() for x in (g, w, m)]
        lib = _nvrtc._lib("cuda")
        stream = torch.cuda.current_stream(dev).cuda_stream
        parts = {"launch": lambda: _nvrtc.launch(record, ptrs),
                 "cuLaunchKernel": lambda: lib.cuLaunchKernel(
                     *record.head, ctypes.c_void_p(stream), record.params, None),
                 "stream": lambda: _nvrtc._raw_stream(dev.index)}
        res["host_us_a_call"] = {k: 1e3 * host_ms(lambda: [fn() for _ in range(200)], 10, 1)
                                 / 200 for k, fn in parts.items()}
    log("rtc push: %s" % json.dumps(res))
    return res


SLAB_SIZES = (131, 1024, 5000, 2359296)
SLAB_KW = dict(wd=1e-4, rescale_grad=1.0 / RESNET_BATCH, momentum=0.9, beta1=0.9,
               beta2=0.999, epsilon=1e-8)
SLAB_STATICS = {k: v for k, v in SLAB_KW.items() if k != "wd"}  # a table's wd is per slab
FIT_BATCHES = 8
BLOBS = dict(classes=10, dim=784, train=2000, val=500, batch=100, epochs=3)


def resnet50_amp_plan(mx, resnet):
    """The flat plan the AMP fused path builds for ResNet-50 at dp 4 (SGD,
    the Module's optimizer and multipliers): ``_FlatUpdatePlan`` itself."""
    from mxnet_tpu_torch.parallel.train_step import _FlatUpdatePlan

    symbol = resnet.get_symbol()
    shapes = dict(zip(symbol.list_arguments(), symbol.infer_shape(
        data=(RESNET_BATCH, 3, 224, 224), softmax_label=(RESNET_BATCH,))[0]))
    names = [n for n in symbol.list_arguments() if n not in ("data", "softmax_label")]
    opt = mx.optimizer.create("sgd", momentum=SGD["momentum"], sym=symbol,
                              param_idx2name=dict(enumerate(names)))
    return _FlatUpdatePlan(names, {n: tuple(shapes[n]) for n in names},
                           dict.fromkeys(names, "float32"), opt, 4, 4 * 1024 * 1024,
                           comm_itemsize=2)


def slab_case(kernels, kind, size, g_dtype, dev, rng):
    """Master, gradient and states of one K1 case (Adam's second moment,
    the last state, non-negative as it always is)."""
    import torch

    w = _randn((size,), torch.float32, dev, rng)
    g = (4.0 * _randn((size,), torch.float32, dev, rng)).to(g_dtype)
    states = [0.1 * _randn((size,), torch.float32, dev, rng)
              for _ in range(kernels.SLAB_STATE_SLOTS[kind])]
    if kind == "adam":
        states[1] = states[1].abs()
    return w, g, tuple(states)


def host_ms(fn, reps, warmup):
    """Median host ms to enqueue one call of ``fn`` (checks, allocations,
    the launch itself): a ~0.5 ms sleep kernel is queued first, so the call
    never waits for the card."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000)
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def device_ms(fn, reps, warmup, flush, sleep_cycles=1_000_000):
    """Median device ms of ``fn``'s launches, L2 flushed before each rep:
    a sleep kernel (``sleep_cycles`` clocks, ~0.5 ms by default) is queued
    before the start event, so the host enqueues the launches while the
    card sleeps and the events time the launches back to back, not the
    host's enqueue gaps, as long as the enqueue is shorter than the
    sleep."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(sleep_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def slab_launches_a_step(kernels, slabs):
    """K1's launches for one update over ``slabs`` slabs: one for every
    table of ``SLAB_TABLE_CAP`` where the package has the table wrapper,
    else one a slab (older trees, run through ``--package``)."""
    cap = getattr(kernels, "SLAB_TABLE_CAP", None)
    return -(-slabs // cap) if cap else slabs


def slab_table(kernels, kind, g_dtype, plan, dev, gen, chunks=1):
    """One step's table for phase 16: ResNet-50's AMP buckets (each whole,
    or as its ``chunks`` dp chunks, which begin at multiples of padded /
    chunks: replicated mode's entries) and seven entries of 1-7 elements
    at offsets 1-3 off the 16-byte boundary, each with its own lr (one a
    device tensor) and wd; random masters, states and gradients from the
    device generator ``gen`` (Adam's second moment non-negative)."""
    import torch

    def rand(n, scale=1.0, dtype=torch.float32, offset=0):
        buf = torch.randn(n + offset, generator=gen, device=dev) * scale
        return buf.to(dtype)[offset:]

    slots = kernels.SLAB_STATE_SLOTS[kind]
    slabs = []
    for b in plan.buckets:
        w, g = rand(b.padded), rand(b.padded, 4.0, g_dtype)
        states = [rand(b.padded, 0.1) for _ in range(slots)]
        s = b.padded // chunks
        slabs += [(w[c * s:(c + 1) * s], g[c * s:(c + 1) * s],
                   [x[c * s:(c + 1) * s] for x in states]) for c in range(chunks)]
    for n in range(1, 8):
        off = 1 + n % 3
        slabs.append((rand(n, offset=off), rand(n, 4.0, g_dtype, off),
                      [rand(n, 0.1, offset=off) for _ in range(slots)]))
    entries = []
    for i, (w, g, states) in enumerate(slabs):
        if kind == "adam":
            states[1] = states[1].abs()
        lr = torch.full((), 0.07, device=dev) if i == 1 else 0.1 * (1 + i % 3) / 2
        entries.append(kernels.SlabEntry(w, g, tuple(states), lr, (0.0, 1e-4, 5e-4)[i % 3]))
    return entries


def slab_outputs(result):
    new_w, new_states, w16 = result
    return (new_w, *new_states, w16)


def phase_slab_table_checks(kernels, dev, plan):
    """Phase 16's table cases: K1 over ``slab_table`` in one call, against
    the plain version of the table, bit for bit; a repeat; a skipped step;
    the launches a call; replicated mode's 64 chunks with the small slabs
    (71 slabs, three launches); one call in place under sync debug mode
    'error'."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(16)
    cases, worst, shapes = 0, 0.0, {}
    tables = [(kind, g_dtype, 1) for kind in ("sgd", "sgd_mom", "adam")
              for g_dtype in (torch.bfloat16, torch.float32)] + [("sgd_mom", torch.bfloat16, 4)]
    for kind, g_dtype, chunks in tables:
        entries = slab_table(kernels, kind, g_dtype, plan, dev, gen, chunks)
        shapes[len(entries)] = slab_launches_a_step(kernels, len(entries))
        for finite in (1.0, 0.0):
            for clip in (None, 0.05):
                args = (kind, entries, torch.full((), 1.0 / 128, device=dev),
                        torch.full((), finite, device=dev))
                before = kernels.fused_slab_update.launches
                got = kernels.fused_slab_update_multi(*args, clip_gradient=clip, **SLAB_STATICS)
                again = kernels.fused_slab_update_multi(*args, clip_gradient=clip,
                                                        **SLAB_STATICS)
                launched = kernels.fused_slab_update.launches - before
                want = kernels.slab_update_multi_reference(*args, clip_gradient=clip,
                                                           **SLAB_STATICS)
                torch.cuda.synchronize()
                if launched != 2 * slab_launches_a_step(kernels, len(entries)):
                    raise AssertionError("slab_update_multi: %d launches for two calls over %d "
                                         "slabs" % (launched, len(entries)))
                for e, r, w_, a in zip(entries, got, want, again):
                    for x, y, z in zip(slab_outputs(r), slab_outputs(w_), slab_outputs(a)):
                        err = (x.float() - y.float()).abs().max().item()
                        worst = max(worst, err)
                        if not torch.equal(x, y):
                            raise AssertionError(
                                "slab_update_multi %s g %s S=%d finite %s clip %s: %.3g from "
                                "the plain version" % (kind, g_dtype, e.w.shape[0], finite, clip,
                                                       err))
                        if not torch.equal(x, z):
                            raise AssertionError("slab_update_multi is not bitwise repeatable")
                    if finite == 0.0 and not (
                            torch.equal(r[0], e.w)
                            and all(torch.equal(x, y) for x, y in zip(r[1], e.states))
                            and torch.equal(r[2], e.w.to(torch.bfloat16))):
                        raise AssertionError("slab_update_multi changed a skipped step's bits")
                cases += 1
        del entries, got, again, want
    # one step's call as the trainer makes it (in place, host lrs, device
    # inv_scale and finite), which must never wait for the device
    entries = [kernels.SlabEntry(e.w, e.g, e.states, float(0.05 * (1 + i % 2)), e.wd,
                                 (e.w, e.states, torch.empty_like(e.w, dtype=torch.bfloat16)))
               for i, e in enumerate(slab_table(kernels, "sgd_mom", torch.bfloat16, plan, dev,
                                                gen))]
    copy = [kernels.SlabEntry(e.w.clone(), e.g, tuple(x.clone() for x in e.states), e.lr, e.wd)
            for e in entries]
    inv, fin = torch.full((), 1.0 / 128, device=dev), torch.ones((), device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kernels.fused_slab_update_multi("sgd_mom", entries, inv, fin, clip_gradient=None,
                                        **SLAB_STATICS)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = kernels.slab_update_multi_reference("sgd_mom", copy, inv, fin, clip_gradient=None,
                                               **SLAB_STATICS)
    torch.cuda.synchronize()
    for e, w_ in zip(entries, want):
        if not all(torch.equal(x, y) for x, y in zip((e.w, *e.states, e.out[2]),
                                                      slab_outputs(w_))):
            raise AssertionError("slab_update_multi in place differs from the plain version")
    log("phase 16: slab_update_multi (K1 over a table) vs plain bit for bit over %d cases "
        "(slabs: launches a call %s), max_abs_err %.3g; a call in place under sync debug mode "
        "'error' ran" % (cases, json.dumps(shapes), worst))
    return {"table_cases": cases, "launches_a_call": shapes, "table_max_abs_err": worst}


def phase_slab_checks(kernels, dev, plan):
    import torch

    rng = np.random.default_rng(10)
    sizes = sorted(set(SLAB_SIZES) | {b.padded for b in plan.buckets})
    cases, worst = 0, 0.0
    for size in sizes:
        for kind in ("sgd", "sgd_mom", "adam"):
            for g_dtype in (torch.bfloat16, torch.float32):
                w, g, states = slab_case(kernels, kind, size, g_dtype, dev, rng)
                for finite in (1.0, 0.0):
                    for clip in (None, 0.05):
                        args = (kind, w, g, states, 0.05, 1.0 / 128, finite)
                        got = kernels.fused_slab_update(*args, clip_gradient=clip, **SLAB_KW)
                        again = kernels.fused_slab_update(*args, clip_gradient=clip, **SLAB_KW)
                        want = kernels.slab_update_reference(*args, clip_gradient=clip,
                                                             **SLAB_KW)
                        torch.cuda.synchronize()
                        outs = list(zip((got[0], *got[1], got[2]), (want[0], *want[1], want[2]),
                                        (again[0], *again[1], again[2])))
                        for a, b, c in outs:
                            err = (a.float() - b.float()).abs().max().item()
                            worst = max(worst, err)
                            if not torch.equal(a, b):
                                raise AssertionError(
                                    "slab_update %s S=%d g %s finite %s clip %s: %.3g from the "
                                    "plain version" % (kind, size, g_dtype, finite, clip, err))
                            if not torch.equal(a, c):
                                raise AssertionError("slab_update is not bitwise repeatable")
                        if finite == 0.0 and not (
                                torch.equal(got[0], w)
                                and all(torch.equal(a, s) for a, s in zip(got[1], states))
                                and torch.equal(got[2], w.to(torch.bfloat16))):
                            raise AssertionError("slab_update changed a skipped step's bits")
                        cases += 1
    # one launch that must never wait for the device
    w, g, states = slab_case(kernels, "sgd_mom", 5000, torch.bfloat16, dev, rng)
    inv, fin = torch.full((), 1.0 / 128, device=dev), torch.ones((), device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kernels.fused_slab_update("sgd_mom", w, g, states, 0.05, inv, fin, clip_gradient=None,
                                  out=(w, states, torch.empty(5000, dtype=torch.bfloat16,
                                                              device=dev)), **SLAB_KW)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("phase 16: slab_update (K1) vs plain bit for bit over %d cases, %d sizes (%d buckets of "
        "ResNet-50's AMP plan), max_abs_err %.3g; a launch under sync debug mode 'error' ran"
        % (cases, len(sizes), len(plan.buckets), worst))
    res = {"cases": cases, "sizes": sizes, "max_abs_err": worst}
    if hasattr(kernels, "fused_slab_update_multi"):
        res.update(phase_slab_table_checks(kernels, dev, plan))
        res["max_abs_err"] = max(worst, res["table_max_abs_err"])
    return res


def k1_step(kernels, plan, dev, rng):
    """One step's K1 work on ResNet-50's AMP plan as the trainer hands it
    over (sgd_mom, bf16 gradient, in place, each bucket's lr and wd host
    numbers, inv_scale and finite device scalars): one table call where the
    package has the table wrapper, else one call a bucket. Returns the
    callable, its plain version (one ``slab_update_reference`` a bucket)
    and each bucket's one-slab call."""
    import torch

    inv, fin = torch.full((), 1.0 / 32768, device=dev), torch.ones((), device=dev)
    slabs = []
    for b in plan.buckets:
        w, g, states = slab_case(kernels, "sgd_mom", b.padded, torch.bfloat16, dev, rng)
        slabs.append((w, g, states, torch.empty(b.padded, dtype=torch.bfloat16, device=dev)))
    singles = [lambda s=s: kernels.fused_slab_update(
        "sgd_mom", s[0], s[1], s[2], 0.1, inv, fin, clip_gradient=None, out=(s[0], s[2], s[3]),
        **SLAB_KW) for s in slabs]
    plain = [lambda s=s: kernels.slab_update_reference(
        "sgd_mom", s[0], s[1], s[2], 0.1, inv, fin, clip_gradient=None, **SLAB_KW)
        for s in slabs]
    if hasattr(kernels, "fused_slab_update_multi"):
        entries = [kernels.SlabEntry(w, g, states, 0.1, SLAB_KW["wd"], (w, states, w16))
                   for w, g, states, w16 in slabs]

        def step():
            kernels.fused_slab_update_multi("sgd_mom", entries, inv, fin, clip_gradient=None,
                                            **SLAB_STATICS)
    else:
        def step():
            for fn in singles:
                fn()
    return step, (lambda: [fn() for fn in plain]), singles


def phase_slab_times(kernels, dev, plan, launches, checks, fit):
    """Kernels-line entry of K1: one step's update over ResNet-50's 16 AMP
    buckets (``k1_step``): ``ms`` (events around the call, L2 flushed),
    ``device_ms`` (after a ~5 ms sleep kernel: the card alone),
    ``host_ms`` (the enqueue), the plain version's device ms, the bound in
    total and a bucket (with each bucket's one-slab call), the in-step card
    time from phase 17's profile and the trainer's whole update beside it."""
    import torch

    rng = np.random.default_rng(11)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    step, plain, singles = k1_step(kernels, plan, dev, rng)
    before = kernels.fused_slab_update.launches
    step()
    step_launches = kernels.fused_slab_update.launches - before
    ms = time_ms(step, 20, 3, flush)
    dev_ms = device_ms(step, 20, 3, flush, sleep_cycles=10_000_000)
    host = host_ms(step, 20, 3)
    plain_ms = device_ms(plain, 10, 2, flush, sleep_cycles=10_000_000)
    rows = [{"padded": b.padded, "one_slab_device_ms": device_ms(fn, 10, 2, flush),
             "bound_ms": 20.0 * b.padded / PEAK_BYTES * 1e3}
            for b, fn in zip(plan.buckets, singles)]
    elems = sum(b.padded for b in plan.buckets)
    nbytes = 20.0 * elems  # read w 4, g 2, mom 4; write w 4, mom 4, w16 2
    bound = nbytes / PEAK_BYTES * 1e3
    in_step = fit["profile"]["families_per_step"].get("slab_update", {})
    entry = {
        "name": "slab_update", "route": "cuda", "source": "mxnet_tpu_torch/csrc/slab_update.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:582", "launches": launches,
        "max_abs_err": checks["max_abs_err"], "ms": ms, "device_ms": dev_ms, "host_ms": host,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
        "library_note": "none: no single PyTorch call computes this update (torch's fused "
                        "optimizers use other formulas and write no bf16 copy)",
        "per": "one step: %d launch(es) (sgd_mom, bf16 gradient, in place) over ResNet-50's %d "
               "AMP buckets at dp 4, %d elements" % (step_launches, len(plan.buckets), elems),
        "launches_a_step": step_launches, "bytes": nbytes,
        "share_of_bound": bound / dev_ms, "in_step_device_ms": in_step.get("device_ms"),
        "in_step_launches": in_step.get("count"), "trainer_update": fit["update_times"],
        "buckets": rows,
    }
    log("  slab_update %s" % json.dumps(entry))
    return [entry]


def phase_trainer_update_times(mod, kernels, dev):
    """The trainer's whole AMP update (``_apply_optimizer_flat_amp``: the
    gradient slabs, the finite flag, K1, the loss scaler) on phase 17's
    plan, on copies of its state, with random bf16 gradients (finite at its
    loss scale): ``ms`` (events, L2 flushed), ``device_ms`` (after a ~10 ms
    sleep kernel), ``host_ms`` (the enqueue) and K1's launches a call."""
    import torch

    tr, owner = mod._fused_trainer, mod._fused_owner
    params = dict(owner._fused_params)
    opt = {k: (tuple(x.clone() for x in v) if isinstance(v, tuple) else
               v.clone() if torch.is_tensor(v) else v) for k, v in owner._fused_opt.items()}
    gen = torch.Generator(device=dev).manual_seed(17)
    grads = {n: torch.randn(p.shape, generator=gen, device=dev).to(torch.bfloat16)
             for n, p in params.items()}
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def update():
        with torch.no_grad():
            tr._apply_optimizer_flat_amp(params, grads, opt, SGD["lr"], 10)

    before = kernels.fused_slab_update.launches
    update()
    launched = kernels.fused_slab_update.launches - before
    return {"ms": time_ms(update, 10, 2, flush),
            "device_ms": device_ms(update, 10, 2, flush, sleep_cycles=20_000_000),
            "host_ms": host_ms(update, 10, 2), "k1_launches_a_call": launched}


def phase_slab_path(mx, resnet, kernels, dev, results):
    """Phases 16-18 and K1's kernels-line entry (``results["k1_entry"]``),
    as the full run and ``--only slab`` run them."""
    plan = resnet50_amp_plan(mx, resnet)
    results["slab_checks"] = phase_slab_checks(kernels, dev, plan)
    results["fit_resnet_amp"] = fit = phase_fit_resnet_amp(mx, kernels, dev, plan)
    results["convergence"] = conv = phase_convergence(mx, kernels, dev)
    by_path = {"fit_resnet_amp": fit["launches"]["slab_update"],
               "convergence_adam": conv["b"]["slab_update_launches"]}
    k1 = phase_slab_times(kernels, dev, plan, sum(by_path.values()), results["slab_checks"], fit)[0]
    k1["launches_by_path"] = by_path
    k1["share_of_phase17_step"] = k1["ms"] / fit["step_ms_median_steps_3_8"]
    results["k1_entry"] = k1


def _amp_env(on):
    if on:
        os.environ["MXTPU_AMP"] = "bf16"
    else:
        os.environ.pop("MXTPU_AMP", None)


def phase_fit_resnet_amp(mx, kernels, dev, plan):
    import torch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    rng = np.random.RandomState(12)
    n = FIT_BATCHES * RESNET_BATCH
    X = rng.rand(n, 3, 224, 224).astype(np.float32)
    y = rng.randint(0, 1000, n).astype(np.float32)
    it = mx.io.NDArrayIter(X, y, batch_size=RESNET_BATCH)
    from mxnet_tpu_torch.models import resnet

    np.random.seed(0)
    mod = mx.mod.Module(resnet.get_symbol(), context=mx.gpu(0),
                        mesh=mx.parallel.make_mesh(dp=4, devices=[mx.gpu(0)] * 4))
    losses, stamps = [], []
    from mxnet_tpu_torch.tools import model_sweep, resnet_bench

    def on_batch(param):
        prob = mod.get_outputs()[0]._data
        label = param.locals["data_batch"].label[0]._data
        losses.append(float(resnet_bench.cross_entropy(prob, label)))  # synchronises
        stamps.append(time.perf_counter())

    _amp_env(True)
    try:
        zero_counts(kernels)
        kernels.fused_slab_update.launches = 0  # counts from here are this path's
        t_fit = time.perf_counter()
        mod.fit(it, kvstore="device", optimizer="sgd",
                optimizer_params={"learning_rate": SGD["lr"], "momentum": SGD["momentum"],
                                  "wd": SGD["wd"]},
                initializer=mx.init.Xavier(), num_epoch=1, batch_end_callback=on_batch)
        counts = dict(conv_counts(kernels), slab_update=kernels.fused_slab_update.launches)
    finally:
        _amp_env(False)
    tr = mod._fused_trainer
    owner = mod._fused_owner
    buckets = len(tr._flat_plan.buckets)
    assert tr.amp and tr.flat_mode == "shard", (tr.amp, tr.flat_mode)
    assert [b.padded for b in tr._flat_plan.buckets] == [b.padded for b in plan.buckets]
    # K1: one launch a step over every bucket (older trees: one a bucket)
    want = {"conv_bwd_filter": RESNET_CONVS * FIT_BATCHES,
            "conv_bwd_input": RESNET_CONVS * FIT_BATCHES,
            "slab_update": slab_launches_a_step(kernels, buckets) * FIT_BATCHES}
    assert counts == want, (counts, want)
    assert len(losses) == FIT_BATCHES and all(np.isfinite(losses)), losses
    masters = tr.master_params_named(owner._fused_opt)
    for name, p in owner._fused_params.items():
        assert p.dtype == torch.bfloat16, name
        assert torch.equal(p, masters[name].to(torch.bfloat16)), "%s != bf16(master)" % name
    arg, _ = mod.get_params()
    for name, v in arg.items():
        assert v._data.dtype == torch.float32 and torch.equal(v._data, masters[name].cpu()), name
    scale, good = (float(owner._fused_opt[k]) for k in (tr.AMP_SCALE_KEY, tr.AMP_GOOD_KEY))
    assert scale == tr.amp_scale_init and good == FIT_BATCHES, (scale, good)
    step_s = [b - a for a, b in zip(stamps[1:], stamps[2:])]  # steps 3-8
    med = statistics.median(step_s)
    res = {"batch": RESNET_BATCH, "steps": FIT_BATCHES, "dp": 4, "buckets": buckets,
           "padded": [b.padded for b in tr._flat_plan.buckets], "losses": losses,
           "launches": counts, "loss_scale": scale, "good_steps": good,
           "setup_and_fit_s": time.perf_counter() - t0, "fit_s": time.perf_counter() - t_fit,
           "step_ms_median_steps_3_8": 1e3 * med, "img_per_s": RESNET_BATCH / med,
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}

    # a poisoned batch: skipped bit for bit, scale halved; then a clean step
    snap = {"params": {k: v.clone() for k, v in owner._fused_params.items()},
            "opt": {k: v.clone() for k, v in owner._fused_opt.items() if torch.is_tensor(v)}}
    it.reset()
    batch = next(iter(it))
    bad = mx.io.DataBatch([batch.data[0].copy()], batch.label)
    bad.data[0]._data[0, 0, 0, 0] = float("inf")
    before = kernels.fused_slab_update.launches
    mod.forward_backward(bad)
    mod.update()
    torch.cuda.synchronize()
    assert kernels.fused_slab_update.launches - before == slab_launches_a_step(kernels, buckets)
    for k, v in owner._fused_params.items():
        assert torch.equal(v, snap["params"][k]), "param %s changed on a skipped step" % k
    for k, v in owner._fused_opt.items():
        if k not in (tr.AMP_SCALE_KEY, tr.AMP_GOOD_KEY):
            assert torch.equal(v, snap["opt"][k]), "state %s changed on a skipped step" % k
    assert float(owner._fused_opt[tr.AMP_SCALE_KEY]) == scale / 2
    assert float(owner._fused_opt[tr.AMP_GOOD_KEY]) == 0.0
    mod.forward_backward(batch)
    mod.update()
    changed = sum(not torch.equal(v, snap["params"][k]) for k, v in owner._fused_params.items())
    assert changed > 0, "the clean step after the skipped one did not update"
    assert float(owner._fused_opt[tr.AMP_GOOD_KEY]) == 1.0
    res["poisoned_step"] = {"skipped_bitwise": True, "scale_after": scale / 2,
                            "params_changed_by_next_clean_step": changed}
    res["profile"] = profile_fit_steps(mod, batch)
    res["update_times"] = phase_trainer_update_times(mod, kernels, dev)
    log("phase 17: ResNet-50 Module.fit, bf16 AMP, dp 4 mesh on gpu(0): %s" % json.dumps(res))
    return res


def profile_fit_steps(mod, batch, steps=2):
    """Where a fused step's time goes: ``steps`` more steps under
    torch.profiler (each ending in a synchronise); see
    :func:`profile_summary` (resnet_bench's families, K1 apart)."""
    import torch

    from mxnet_tpu_torch.tools import model_sweep, resnet_bench

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            mod.forward_backward(batch)
            mod.update()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return profile_summary(prof, steps, wall, lambda name: (
        "slab_update" if "slab_update" in name else resnet_bench.family(name)))


def profile_summary(prof, steps, wall_s, family):
    """Of ``steps`` steps profiled in ``wall_s`` seconds: wall ms and
    device-busy ms a step, the idle share, kernels a step, and device ms a
    step per kernel family (``family(name)``)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda]
    fams = {}
    for e in events:
        f = fams.setdefault(family(e.name), {"device_ms": 0.0, "count": 0})
        f["device_ms"] += (e.time_range.end - e.time_range.start) / 1e3 / steps
        f["count"] += 1 / steps
    busy = sum(f["device_ms"] for f in fams.values())
    wall = 1e3 * wall_s / steps
    return {"steps": steps, "wall_ms": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "kernels_per_step": len(events) / steps, "families_per_step": fams}


def phase_convergence(mx, kernels, dev):
    from mxnet_tpu_torch.models import mlp

    rng = np.random.RandomState(13)
    c, d = BLOBS["classes"], BLOBS["dim"]
    centers = rng.randn(c, d).astype(np.float32)
    n = BLOBS["train"] + BLOBS["val"]
    labels = rng.randint(0, c, n)
    X = (centers[labels] + rng.randn(n, d).astype(np.float32)).astype(np.float32)
    y = labels.astype(np.float32)
    tr_, va = slice(0, BLOBS["train"]), slice(BLOBS["train"], n)
    res = {}
    for leg in ("a", "b"):
        np.random.seed(0)
        train = mx.io.NDArrayIter(X[tr_], y[tr_], batch_size=BLOBS["batch"], shuffle=True)
        val = mx.io.NDArrayIter(X[va], y[va], batch_size=BLOBS["batch"])
        if leg == "a":
            mod = mx.mod.Module(mlp.get_symbol(), context=mx.gpu(0))
            kw = dict(kvstore="local", optimizer="sgd",
                      optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
        else:
            mod = mx.mod.Module(mlp.get_symbol(), context=mx.gpu(0),
                                mesh=mx.parallel.make_mesh(dp=4, devices=[mx.gpu(0)] * 4))
            kw = dict(kvstore="device", optimizer="adam",
                      optimizer_params={"learning_rate": 0.001})
        _amp_env(leg == "b")
        try:
            kernels.fused_slab_update.launches = 0  # counts from here are this leg's
            t0 = time.perf_counter()
            mod.fit(train, eval_data=val, initializer=mx.init.Xavier(),
                    num_epoch=BLOBS["epochs"], **kw)
            wall = time.perf_counter() - t0
        finally:
            _amp_env(False)
        acc = dict(mod.score(val, "acc"))["accuracy"]
        tr = mod._fused_trainer
        res[leg] = {"val_acc": acc, "fit_s": wall, "fused": tr is not None,
                    "amp": bool(tr is not None and tr.amp),
                    "slab_update_launches": kernels.fused_slab_update.launches}
        if leg == "b":
            steps = BLOBS["epochs"] * BLOBS["train"] // BLOBS["batch"]
            assert tr.amp and tr.flat_mode == "shard" and tr._slab_kind() == "adam"
            assert res[leg]["slab_update_launches"] == steps * slab_launches_a_step(
                kernels, len(tr._flat_plan.buckets)), res
        else:
            assert tr is None
        assert acc >= 0.97, (leg, acc)
    log("phase 18: 10-blob MLP convergence on the card: %s" % json.dumps(res))
    return res


# phase 21 (a), bf16 AMP: the state after batch `snap` of epoch 0 (the end
# of a group at every K) compared before batch `poison` makes aux NaN
MULTI = dict(batches=32, epochs=2, poison=29, snap=23, ks=(4, 8))
MULTI_F32 = dict(batches=24, epochs=1, poison=None, snap=None, ks=(4,))  # phase 21 (b)
MULTI_MLP_K = 4  # phase 21 (c)
MULTI_DROPOUT_K = 2  # phase 21 (d)
# device kernel names of K2, K3 and K1 (counted per micro-step in a profile)
MULTI_KERNEL_NAMES = {"conv_bwd_filter": "conv_wgrad_sm90", "conv_bwd_input": "conv_dgrad_sm90",
                      "slab_update": "slab_update_kernel"}


def _multistep_env(k):
    if k > 1:
        os.environ["MXNET_FIT_MULTISTEP"] = str(k)
    else:
        os.environ.pop("MXNET_FIT_MULTISTEP", None)


def fused_state(mod):
    """Clones of every state tensor of a fused module: working params, aux
    and optimizer state (masters, momentum slabs, loss scale, good count),
    ``kind:name.slot`` -> tensor."""
    owner = mod._fused_owner
    out = {}
    for kind, tree in (("param", owner._fused_params), ("aux", owner._fused_aux),
                       ("opt", owner._fused_opt)):
        for name, v in tree.items():
            for j, t in enumerate(v if isinstance(v, tuple) else (v,)):
                if t is not None:
                    out["%s:%s.%d" % (kind, name, j)] = t.detach().clone()
    return out


def state_digest(state):
    """sha256 of a :func:`fused_state`'s bytes in key order (bf16 as its
    bits), to compare the state of two trees' runs."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for name in sorted(state):
        t = state[name]
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        h.update(name.encode())
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def state_diff(got, want):
    """The names of the tensors of two :func:`fused_state` dicts that are
    not equal bit for bit (compared as integers: a poisoned step leaves
    NaN in the BatchNorm moving statistics, and NaN equals no float)."""
    import torch

    ints = {4: torch.int32, 2: torch.int16, 8: torch.int64}

    def bits(t):
        return t.view(ints[t.element_size()]) if t.is_floating_point() else t

    assert sorted(got) == sorted(want), (sorted(set(got) ^ set(want)))
    return [n for n in sorted(want) if not torch.equal(bits(got[n]), bits(want[n]))]


def multistep_leg(mx, kernels, dev, X, y, k, amp, epochs, snap=None, profile=False):
    """One ``Module.fit`` of phase 21 (a)/(b): ResNet-50 on the dp 4 mesh of
    gpu(0), phase 17's recipe, ``MXNET_FIT_MULTISTEP=k`` (unset for 1).
    Returns ``(module, numbers, fused_state, snapshot)``, the snapshot the
    :func:`fused_state` after batch ``snap`` of epoch 0 (None without
    ``snap``). Step ms is the median interval between batch-end callbacks
    (eager: steps 3 on, within an epoch) or between the ends of replayed
    groups ÷ k (groups 3 on, within an epoch), leaving out the interval in
    which the snapshot is taken. With ``profile`` the fit runs under
    torch.profiler and ``launches_run`` holds K2's, K3's and K1's device
    kernels over the whole fit, counted by name."""
    import gc

    import torch

    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.tools import resnet_bench

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    it = mx.io.NDArrayIter(X, y, batch_size=RESNET_BATCH)
    np.random.seed(0)
    mod = mx.mod.Module(resnet.get_symbol(), context=mx.gpu(0),
                        mesh=mx.parallel.make_mesh(dp=4, devices=[mx.gpu(0)] * 4))
    losses, stamps, snapshot = [], [], {}

    def on_batch(param):
        prob = mod.get_outputs()[0]._data
        label = param.locals["data_batch"].label[0]._data
        losses.append(float(resnet_bench.cross_entropy(prob, label)))  # synchronises
        snapped = param.epoch == 0 and param.nbatch == snap
        stamps.append((param.epoch, param.nbatch, time.perf_counter(), snapped))
        if snapped:
            snapshot.update(fused_state(mod))

    metric = mx.metric.create("acc")
    # the card's activity only: kernel_counts reads device kernels, and the
    # host's ops made parsing a whole profiled fit take tens of seconds
    acts = [torch.profiler.ProfilerActivity.CUDA]
    _amp_env(amp)
    _multistep_env(k)
    try:
        zero_counts(kernels)
        with (torch.profiler.profile(activities=acts) if profile
              else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            mod.fit(it, eval_metric=metric, kvstore="device", optimizer="sgd",
                    optimizer_params={"learning_rate": SGD["lr"], "momentum": SGD["momentum"],
                                      "wd": SGD["wd"]},
                    initializer=mx.init.Xavier(), num_epoch=epochs, batch_end_callback=on_batch)
            torch.cuda.synchronize(dev)
            fit_s = time.perf_counter() - t0
        counts = dict(conv_counts(kernels), slab_update=kernels.fused_slab_update.launches)
    finally:
        _amp_env(False)
        _multistep_env(1)
    tr = mod._fused_trainer
    assert tr.amp == amp and tr.flat_mode == "shard", (tr.amp, tr.flat_mode)
    assert (snap is None) == (not snapshot), (snap, len(snapshot))
    # the end of each step (eager) or group: the interval before end i + 1
    # times step or group i + 1, counted from 2 (eager: past the first
    # steps; grouped: past the warm-up and the capture) within an epoch
    ends = [(e, t, snapped) for (e, n, t, snapped) in stamps if (n + 1) % k == 0]
    gaps = [(b[1] - a[1]) / k for i, (a, b) in enumerate(zip(ends, ends[1:]))
            if a[0] == b[0] and i + 1 >= 2 and not a[2]]
    med = statistics.median(gaps)
    steps = len(stamps)
    res = {"k": k, "amp": amp, "steps": steps, "losses": losses, "metric": metric.get()[1],
           "launches": counts, "fit_s": fit_s, "under_profiler": profile,
           "step_ms_median": 1e3 * med, "step_ms_samples": len(gaps),
           "step_ms_range": [1e3 * min(gaps), 1e3 * max(gaps)], "img_per_s": RESNET_BATCH / med,
           "loss_scale": float(mod._fused_owner._fused_opt[tr.AMP_SCALE_KEY]) if amp else None,
           "good_steps": float(mod._fused_owner._fused_opt[tr.AMP_GOOD_KEY]) if amp else None,
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "peak_reserved_gib": torch.cuda.max_memory_reserved(dev) / 2**30}
    buckets = len(tr._flat_plan.buckets)
    a_step = {"conv_bwd_filter": RESNET_CONVS, "conv_bwd_input": RESNET_CONVS,
              "slab_update": slab_launches_a_step(kernels, buckets) if amp else 0}
    if k == 1:
        assert counts == {n: c * steps for n, c in a_step.items()}, (counts, a_step)
    else:
        # the wrappers count where they launch: in the warm-up group and
        # once while the graph is captured; a replay calls no wrapper
        (g,) = tr.group_stats()
        assert g["k"] == k and g["warmup_groups"] == 1 and g["captures"] == 1, g
        assert g["groups"] == steps // k and g["replays"] == g["groups"] - 1, g
        by_wrapper = {("fused_" + n if n == "slab_update" else n): c * k
                      for n, c in a_step.items() if c}
        assert g["captured_launches"] == by_wrapper, (g["captured_launches"], by_wrapper)
        assert counts == {n: 2 * c * k for n, c in a_step.items()}, (counts, a_step)
        res["group"] = g
    if profile:
        # what ran on the device: the warm-up group's launches and every
        # replay's, by kernel name
        run = kernel_counts(prof)
        assert run == {n: c * steps for n, c in a_step.items()}, (run, a_step, steps)
        res.update(launches_run=run,
                   launches_counted_as="torch.profiler: device kernels by name, whole fit")
    log("phase 21 leg (k %d, %s%s): %s" % (
        k, "bf16 AMP" if amp else "f32", ", profiled" if profile else "",
        json.dumps({n: v for n, v in res.items() if n != "losses"})))
    return mod, res, fused_state(mod), snapshot or None


def kernel_counts(prof):
    """K2's, K3's and K1's device kernels in a torch.profiler profile, by
    name (``MULTI_KERNEL_NAMES``)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    names = [e.name for e in prof.events() if e.device_type == cuda]
    return {n: sum(key in name for name in names) for n, key in MULTI_KERNEL_NAMES.items()}


def profile_groups(mod, batches, k, groups=2):
    """``groups`` replayed groups of ``k`` steps (``Module.update_multi``,
    each ending in a synchronise) under torch.profiler; see
    :func:`profile_summary`, plus the device launches a micro-step of K2,
    K3 and K1 by kernel name."""
    import torch

    from mxnet_tpu_torch.tools import resnet_bench

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(groups):
            mod.update_multi(batches)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = profile_summary(prof, groups * k, wall, lambda name: (
        "slab_update" if "slab_update" in name else resnet_bench.family(name)))
    out["launches_per_step"] = {n: c / (groups * k) for n, c in kernel_counts(prof).items()}
    return out


PROFILE_TRIES = 3  # profiles of two replayed groups until one holds every record


def profile_groups_counted(mod, it, k):
    """:func:`profile_groups` of the first ``k`` batches, held to K2 and K3
    46 times and K1 once a micro-step by kernel name. A replay launches
    every node of its graph, so a count above that fails at once; a count
    below it is a record the profiler dropped (seen twice for one kernel in
    one window), and the window is profiled again, up to
    ``PROFILE_TRIES`` times. Every short reading is printed and kept."""
    want = {"conv_bwd_filter": RESNET_CONVS, "conv_bwd_input": RESNET_CONVS, "slab_update": 1}
    short = []
    for _ in range(PROFILE_TRIES):
        it.reset()
        prof = profile_groups(mod, [b for _, b in zip(range(k), it)], k)
        got = prof["launches_per_step"]
        if got == want:
            prof["short_readings"] = short
            return prof
        assert set(got) == set(want) and all(got[n] <= want[n] for n in want), got
        short.append(got)
        log("phase 21: a profile of two K = %d replays counted %s a step against %s; "
            "profiling again" % (k, got, want))
    raise AssertionError("every profile short of %s: %s" % (want, short))


def multistep_resnet(mx, kernels, dev, amp, batches, epochs, poison, snap, ks, grouped):
    """Phase 21 (a) (bf16 AMP) or (b) (f32): an eager fit and, for each K in
    ``ks``, a timed and a profiled one; every state tensor (at the end and
    after batch ``snap`` of epoch 0), the losses and the metric equal bit
    for bit; K2 and K3 46 times and K1 once a step on the device."""
    import torch

    rng = np.random.RandomState(21)
    n = batches * RESNET_BATCH
    X = rng.rand(n, 3, 224, 224).astype(np.float32)
    y = rng.randint(0, 1000, n).astype(np.float32)
    if poison is not None:
        X[poison * RESNET_BATCH, 0, 0, 0] = np.inf
    mod, eager, want, want_snap = multistep_leg(mx, kernels, dev, X, y, 1, amp, epochs, snap)
    it = mx.io.NDArrayIter(X, y, batch_size=RESNET_BATCH)
    if amp:
        eager["profile"] = profile_fit_steps(mod, next(iter(it)))
    out = {"batches": batches, "epochs": epochs, "poisoned_batch": poison, "snapshot_batch": snap,
           "eager": eager, "digest": state_digest(want)}
    del mod
    if snap is not None:
        # before the poisoned batch: every aux tensor (BatchNorm moving
        # statistics) finite, so the grouped fits' aux is held as finite bits
        bad = [name for name, t in want_snap.items()
               if t.is_floating_point() and not bool(torch.isfinite(t).all())]
        assert not bad, bad[:5]
        out["snapshot_tensors"] = len(want_snap)
    if not grouped:
        return out
    if poison is not None:
        # each epoch's poisoned step skipped (scale halved, count zeroed)
        assert eager["loss_scale"] == 2.0 ** 15 / 2 ** epochs, eager["loss_scale"]
        assert eager["good_steps"] == batches - poison - 1, eager["good_steps"]
    for k in ks:
        for profile in (False, True):
            mod, leg, got, got_snap = multistep_leg(mx, kernels, dev, X, y, k, amp, epochs, snap,
                                                    profile)
            diff = state_diff(got, want)
            assert not diff, "k %d: %d tensors differ from the eager fit's, first %s" % (
                k, len(diff), diff[:5])
            if snap is not None:
                diff = state_diff(got_snap, want_snap)
                assert not diff, "k %d: %d tensors differ after batch %d, first %s" % (
                    k, len(diff), snap, diff[:5])
            assert leg["metric"] == eager["metric"], (leg["metric"], eager["metric"])
            assert np.array_equal(leg["losses"], eager["losses"], equal_nan=True)
            leg["bitwise_equal_to_eager"] = {"tensors": len(want), "metric": True,
                                             "losses": True,
                                             "snapshot_tensors": len(want_snap or ())}
            if amp and k == max(ks) and not profile:
                leg["profile"] = profile_groups_counted(mod, it, k)
            out["k%d%s" % (k, "_profiled" if profile else "")] = leg
            del mod
            torch.cuda.empty_cache()
    return out


def _blob_data():
    rng = np.random.RandomState(13)
    c, d = BLOBS["classes"], BLOBS["dim"]
    centers = rng.randn(c, d).astype(np.float32)
    n = BLOBS["train"] + BLOBS["val"]
    labels = rng.randint(0, c, n)
    X = (centers[labels] + rng.randn(n, d).astype(np.float32)).astype(np.float32)
    return X, labels.astype(np.float32), slice(0, BLOBS["train"]), slice(BLOBS["train"], n)


def multistep_mlp(mx, kernels, dev):
    """Phase 21 (c): phase 18 (b)'s MLP (AMP, Adam) with a FactorScheduler,
    eagerly and at K = MULTI_MLP_K: bit for bit, validation accuracy at
    least 0.97, K1 once a micro-step."""
    from mxnet_tpu_torch.models import mlp

    X, y, tr_, va = _blob_data()
    legs, states = {}, {}
    for k in (1, MULTI_MLP_K):
        np.random.seed(0)
        train = mx.io.NDArrayIter(X[tr_], y[tr_], batch_size=BLOBS["batch"], shuffle=True)
        val = mx.io.NDArrayIter(X[va], y[va], batch_size=BLOBS["batch"])
        mod = mx.mod.Module(mlp.get_symbol(), context=mx.gpu(0),
                            mesh=mx.parallel.make_mesh(dp=4, devices=[mx.gpu(0)] * 4))
        metric = mx.metric.create("acc")
        _amp_env(True)
        _multistep_env(k)
        try:
            kernels.fused_slab_update.launches = 0
            t0 = time.perf_counter()
            mod.fit(train, eval_data=val, eval_metric=metric, initializer=mx.init.Xavier(),
                    num_epoch=BLOBS["epochs"], kvstore="device", optimizer="adam",
                    optimizer_params={"learning_rate": 0.001, "lr_scheduler":
                                      mx.lr_scheduler.FactorScheduler(step=20, factor=0.9)})
            wall = time.perf_counter() - t0
        finally:
            _amp_env(False)
            _multistep_env(1)
        tr = mod._fused_trainer
        assert tr.amp and tr._slab_kind() == "adam"
        legs[k] = {"val_acc": dict(mod.score(val, "acc"))["accuracy"], "fit_s": wall,
                   "train_metric": metric.get()[1],
                   "slab_update_launches": kernels.fused_slab_update.launches,
                   "lr_at_end": mod._optimizer.lr_scheduler(mod._optimizer.num_update)}
        if k > 1:
            (g,) = tr.group_stats()
            assert g["captured_launches"] == {"fused_slab_update": k}, g
            legs[k]["group"] = g
        states[k] = fused_state(mod)
        assert legs[k]["val_acc"] >= 0.97, legs[k]
    diff = state_diff(states[MULTI_MLP_K], states[1])
    assert not diff, diff[:5]
    assert legs[MULTI_MLP_K]["train_metric"] == legs[1]["train_metric"]
    assert legs[MULTI_MLP_K]["val_acc"] == legs[1]["val_acc"]
    return {"eager": legs[1], "k%d" % MULTI_MLP_K: legs[MULTI_MLP_K],
            "bitwise_equal_to_eager": len(states[1])}


def multistep_dropout(mx, dev):
    """Phase 21 (d): a Dropout MLP's trainer at K = MULTI_DROPOUT_K run three
    times from one state on one pair of batches (warm-up, capture + replay,
    replay): the two replays' outputs differ (fresh masks: the generator is
    registered with the graph); the same net without Dropout gives the
    warm-up's bits on every replay."""
    import torch

    k = MULTI_DROPOUT_K
    rng = np.random.RandomState(5)
    batches = {"data": [torch.from_numpy(rng.randn(32, 100).astype(np.float32)).to(dev)
                        for _ in range(k)],
               "softmax_label": [torch.from_numpy(rng.randint(0, 10, 32).astype(np.float32))
                                 .to(dev) for _ in range(k)]}
    out = {}
    for p in (0.3, None):
        net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=64, name="fc1")
        net = mx.sym.Activation(net, act_type="relu")
        if p:
            net = mx.sym.Dropout(net, p=p)
        net = mx.sym.FullyConnected(net, num_hidden=10, name="fc2")
        net = mx.sym.SoftmaxOutput(net, name="softmax")
        opt = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9, rescale_grad=1 / 32)
        tr = mx.parallel.ShardedTrainStep(
            net, mx.parallel.make_mesh(dp=4, devices=[mx.gpu(0)] * 4), optimizer=opt).compile()
        arg_shapes, _, _ = net.infer_shape(data=(32, 100), softmax_label=(32,))
        np.random.seed(0)
        state = tr.init(dict(zip(net.list_arguments(), arg_shapes)), mx.init.Xavier())
        runs = []
        for _ in range(3):
            copy = [{n: tuple(x.clone() for x in v) if isinstance(v, tuple) else
                     (None if v is None else v.clone()) for n, v in d.items()} for d in state]
            outs = tr.call_multi(*copy, batches, [0.1] * k, list(range(1, k + 1)))[3]
            runs.append([o.clone() for o in outs])
        torch.cuda.synchronize(dev)
        (g,) = tr.group_stats()
        assert (g["warmup_groups"], g["captures"], g["replays"]) == (1, 1, 2), g
        same = [all(torch.equal(a, b) for a, b in zip(runs[i], runs[j]))
                for i, j in ((0, 1), (1, 2))]
        if p:
            assert not same[1], "two replays drew the same Dropout masks"
        else:
            assert same == [True, True], same
        out["dropout" if p else "control"] = {"warmup_eq_replay1": same[0],
                                              "replay1_eq_replay2": same[1], "group": g}
    return out


def multistep_launches(res):
    """K1's, K2's and K3's launches run in phase 21's ResNet-50 fits: the
    eager fits' wrapper counts and the profiled grouped fits' device
    kernels by name (the timed grouped fits' replays are not counted)."""
    total = dict.fromkeys(MULTI_KERNEL_NAMES, 0)
    for part in (res["a"], res["b"]):
        for name, leg in part.items():
            if name == "eager" or name.endswith("_profiled"):
                for n, c in leg.get("launches_run", leg["launches"]).items():
                    total[n] += c
    return total


def phase_multistep(mx, kernels, dev, full=True):
    """Phase 21: K fused steps as one captured CUDA graph; see the module
    docstring. On a tree without ``Module.update_multi`` (``--package``)
    only the eager fits of (a) and (b) run, for their state digests.
    Without ``full`` (the full script's run) (a) groups at K = 8 only over
    one epoch (the poisoned batch 29 still in a replayed group) and (b) runs
    12 batches (a warm-up group, the capture and a replay)."""
    import torch

    grouped = hasattr(mx.mod.Module, "update_multi")
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    t0 = time.perf_counter()
    try:
        res = {"grouped": grouped,
               "a": multistep_resnet(mx, kernels, dev, True, grouped=grouped, **(
                   MULTI if full else dict(MULTI, ks=MULTI["ks"][-1:], epochs=1))),
               "b": multistep_resnet(mx, kernels, dev, False, grouped=grouped, **(
                   MULTI_F32 if full else dict(MULTI_F32, batches=12)))}
        if grouped:
            res["c"] = multistep_mlp(mx, kernels, dev)
            res["d"] = multistep_dropout(mx, dev)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    res["phase_s"] = time.perf_counter() - t0
    log("phase 21: K fused steps as one CUDA graph: %s" % json.dumps(
        res, default=lambda o: None))
    return res


SERVE_BUCKETS = (1, 2, 4, 8, 16, 32)  # phase 22 (a): the Predictor's batch buckets
SERVE_SHAPE = (3, 224, 224)
SERVE_REQUESTS = 512  # phase 22 (b): requests of each closed and the open loop
SERVE_MAX_BATCH = 32
SERVE_REPS = 10  # timed calls a bucket
DECODE_PROFILE_STEPS = 16  # phase 22 (d): decode steps under torch.profiler


def _bits_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _median_ms(fn, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _profiled(fn, reps, family=lambda name: "kernel"):
    """``fn`` ``reps`` times under torch.profiler (each call ends on the
    host, synchronised): :func:`profile_summary` of them."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        wall = time.perf_counter() - t0
    out = profile_summary(prof, reps, wall, family)
    out.pop("families_per_step")
    return out


def serving_predictor(mx, resnet, params, quant=""):
    """bench.py's ResNet-50 (f32, 1000 classes, 3x224x224) behind a Predictor
    on gpu(0), from ``params`` ({"arg:...", "aux:..."} host NDArrays)."""
    from mxnet_tpu_torch import predict

    symbol = resnet.get_symbol(num_classes=1000, num_layers=50,
                               image_shape=",".join(str(d) for d in SERVE_SHAPE))
    return predict.Predictor(symbol.tojson(), params, {"data": (1,) + SERVE_SHAPE},
                             ctx=mx.gpu(0), quant=quant)


def serving_params(mx, resnet):
    """``init_params``'s ResNet-50 weights, moving means 0 and variances 1,
    as the host NDArrays a Predictor takes."""
    from mxnet_tpu_torch.models.common import init_params

    symbol = resnet.get_symbol(num_classes=1000, num_layers=50,
                               image_shape=",".join(str(d) for d in SERVE_SHAPE))
    arg_np, aux_np = init_params(symbol, (1,) + SERVE_SHAPE, 0)
    with mx.cpu():
        params = {"arg:" + n: mx.nd.array(v) for n, v in arg_np.items()}
        params.update({"aux:" + n: mx.nd.array(v) for n, v in aux_np.items()})
    return params


def _plan_misses(telemetry):
    return telemetry.REGISTRY.get("executor.dispatch_plan_misses").value()


def serve_buckets(pred, dev, rng):
    """Phase 22 (a): every bucket compiled and captured; each replay equal
    to the eager ``predict()`` of the same rows bit for bit; capture ms, pool
    bytes, replayed and eager ms a call, img/s."""
    import torch

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    pred.compile([{"data": (b,) + SERVE_SHAPE} for b in SERVE_BUCKETS])
    compile_s = time.perf_counter() - t0
    rows = []
    for b in SERVE_BUCKETS:
        fn = pred._serve_cache[(("data", (b,) + SERVE_SHAPE),)]
        assert fn._graph is not None, "bucket %d has no graph" % b
        x = rng.standard_normal((b,) + SERVE_SHAPE, dtype=np.float32)
        got = pred.predict_batch(data=x)[0]
        pred.reshape({"data": x.shape})
        want = pred.predict(data=x)[0]
        assert got.shape == (b, 1000) and np.isfinite(got).all(), (b, got.shape)
        if not _bits_equal(got, want):
            raise AssertionError("bucket %d: replay differs from eager predict() by %.3g"
                                 % (b, float(np.abs(got - want).max())))
        replay_ms = _median_ms(lambda: pred.predict_batch(data=x), SERVE_REPS)
        eager_ms = _median_ms(lambda: pred.predict(data=x), SERVE_REPS)
        rows.append({"bucket": b, "bitwise_equal_to_eager": True,
                     "capture_ms": fn.stats["capture_ms"], "pool_bytes": fn.stats["pool_bytes"],
                     "replay_ms": replay_ms, "eager_ms": eager_ms,
                     "replay_img_per_s": b / replay_ms * 1e3,
                     "eager_img_per_s": b / eager_ms * 1e3})
    x1 = rng.standard_normal((1,) + SERVE_SHAPE, dtype=np.float32)
    x32 = rng.standard_normal((32,) + SERVE_SHAPE, dtype=np.float32)
    pred.reshape({"data": x1.shape})
    profiles = {"replay_1": _profiled(lambda: pred.predict_batch(data=x1), 5),
                "eager_1": _profiled(lambda: pred.predict(data=x1), 5)}
    pred.reshape({"data": x32.shape})
    profiles.update(replay_32=_profiled(lambda: pred.predict_batch(data=x32), 5),
                    eager_32=_profiled(lambda: pred.predict(data=x32), 5))
    return {"compile_s": compile_s, "buckets": rows, "profiles": profiles,
            "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "pool_bytes_total": sum(r["pool_bytes"] for r in rows)}


def serve_engine(pred, telemetry, rng):
    """Phase 22 (b): coalesced rows equal to solo dispatch in the same bucket
    bit for bit; closed loop at max_batch 1 and 32, the open loop; no capture
    and no recompile after warm-up."""
    from mxnet_tpu_torch.serving import engine as se
    from mxnet_tpu_torch.tools import serving_bench

    xs = rng.standard_normal((64,) + SERVE_SHAPE, dtype=np.float32)
    r0, m0 = telemetry.anatomy._C_RECOMPILES.value(), _plan_misses(telemetry)
    eng = se.ServingEngine(pred, max_batch=SERVE_MAX_BATCH, batch_timeout_ms=200.0).start()
    b0 = se._C_BATCHES.value()
    outs = [f.result(60) for f in [eng.submit(data=xs[i]) for i in range(5)]]
    eng.drain()
    assert se._C_BATCHES.value() - b0 == 1, "five requests were not one batch"
    for i, out in enumerate(outs):
        solo = np.zeros((8,) + SERVE_SHAPE, np.float32)
        solo[i] = xs[i]
        if not _bits_equal(out[0], pred.predict_batch(data=solo)[0][i]):
            raise AssertionError("request %d's row differs from solo dispatch" % i)
    rps = {}
    for mb in (1, SERVE_MAX_BATCH):
        eng = se.ServingEngine(pred, max_batch=mb, batch_timeout_ms=2.0).start()
        serving_bench._saturate(eng, xs, 64)  # warm the dispatch loop
        rps[mb] = serving_bench._saturate(eng, xs, SERVE_REQUESTS)
        eng.drain()
    speedup = rps[SERVE_MAX_BATCH] / rps[1]
    eng = se.ServingEngine(pred, max_batch=SERVE_MAX_BATCH, batch_timeout_ms=2.0).start()
    open_loop = serving_bench._open_loop(eng, xs, SERVE_REQUESTS, 0.4 * rps[SERVE_MAX_BATCH],
                                         np.random.RandomState(2))
    eng.drain()
    res = {"rows_bitwise_equal_to_solo": len(outs),
           "closed_img_per_s": {"max_batch_1": rps[1], "max_batch_32": rps[SERVE_MAX_BATCH]},
           "speedup": speedup, "open_loop": open_loop,
           "recompiles": telemetry.anatomy._C_RECOMPILES.value() - r0,
           "plan_misses": _plan_misses(telemetry) - m0}
    assert res["recompiles"] == 0 and res["plan_misses"] == 0, res
    assert speedup >= 3.0, "closed-loop speedup %.3g < 3" % speedup
    return res


def serve_int8(mx, resnet, params, pred, telemetry, rng):
    """Phase 22 (c): the serving bench on the card (the 128-d MLP's int8
    top-1 agreement at least 0.99, its gate) and ResNet-50 int8 against f32
    at batch 32."""
    from mxnet_tpu_torch.serving import quant
    from mxnet_tpu_torch.tools import serving_bench

    bench = serving_bench.run_serving_bench()
    bench["gates"] = serving_bench.gates(bench, True)
    for gate in ("steady_state_recompiles", "steady_state_plan_misses", "top1_agreement"):
        assert bench["gates"][gate], (gate, bench)
    q = serving_predictor(mx, resnet, params, quant="int8")
    q.compile([{"data": (32,) + SERVE_SHAPE}])
    x = rng.standard_normal((32,) + SERVE_SHAPE, dtype=np.float32)
    a, b = pred.predict_batch(data=x)[0], q.predict_batch(data=x)[0]
    assert np.isfinite(b).all()
    f32_ms = _median_ms(lambda: pred.predict_batch(data=x), SERVE_REPS)
    i8_ms = _median_ms(lambda: q.predict_batch(data=x), SERVE_REPS)
    return {"bench": bench,
            "resnet50": {"top1_agreement": quant.top1_agreement(a, b),
                         "f32_img_per_s": 32 / f32_ms * 1e3, "int8_img_per_s": 32 / i8_ms * 1e3,
                         "int8_vs_f32_img_per_s": f32_ms / i8_ms}}


def serve_decode(tfm, kernels, telemetry, GenerationEngine, dev):
    """Phase 22 (d): phase 6's mix on the full bf16 LM behind a
    GenerationEngine (captured decode step where the package has one):
    K4f n_layers times a prefill dispatch, no capture after compile(),
    decode-step p50/p99, tokens/s, the continuations' digest, and the idle
    share of decode steps under torch.profiler."""
    import hashlib

    import torch

    t0 = time.perf_counter()
    init_fn, _ = tfm.transformer_lm(dtype=torch.bfloat16, **FULL)
    params = tfm.params_from_jax(init_fn(0), device=dev, dtype=torch.bfloat16)
    model = tfm.transformer_lm_serving(max_len=MAX_LEN, dtype=torch.bfloat16, **FULL)
    gen = GenerationEngine(params, model, slots=SLOTS, max_len=MAX_LEN, device=dev)
    gen.compile()
    setup_s = time.perf_counter() - t0
    captured = getattr(gen, "_decode_graph", None) is not None
    capture = dict(getattr(gen, "decode_stats", {}))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, FULL["vocab"], n) for n in PROMPT_LENGTHS]

    # decode steps under the profiler: four prompts admitted, then the
    # engine stepped from this thread (each step ends in the argmax's copy)
    reqs = [gen.submit(p, max_new=DECODE_PROFILE_STEPS + 4) for p in prompts[:SLOTS]]
    gen.step()
    profile = _profiled(gen.step, DECODE_PROFILE_STEPS)
    while not all(r.done.is_set() for r in reqs):
        gen.step()

    anatomy = getattr(telemetry, "anatomy", None)
    telemetry.enable()
    telemetry.reset()
    seen0 = len(getattr(gen, "_seen_sigs", ()))
    r0 = anatomy._C_RECOMPILES.value() if anatomy else 0
    kernels.flash_attention.launches = 0  # counts from here are the main path's
    t0 = time.perf_counter()
    gen.start(precompile=False)
    try:
        outs = [r.result(timeout=300) for r in [gen.submit(p, max_new=MAX_NEW) for p in prompts]]
    finally:
        gen.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.flash_attention.launches
    h_prefill = telemetry.REGISTRY.get("serve.prefill_seconds")
    h_decode = telemetry.REGISTRY.get("serve.decode_step_seconds")
    dispatches = h_prefill.count()
    for out in outs:
        assert len(out) == MAX_NEW and all(0 <= t < FULL["vocab"] for t in out), out
    assert launches == dispatches * FULL["n_layers"], (launches, dispatches)
    misses = len(getattr(gen, "_seen_sigs", ())) - seen0
    recompiles = (anatomy._C_RECOMPILES.value() - r0) if anatomy else 0
    if captured:
        assert gen.decode_stats["captures"] == capture["captures"] == 1, gen.decode_stats
        assert misses == 0 and recompiles == 0, (misses, recompiles)
    res = {"captured": captured, "capture": capture, "setup_s": setup_s, "wall_s": wall,
           "requests": len(outs), "new_tokens": sum(len(o) for o in outs),
           "tokens_per_s": sum(len(o) for o in outs) / wall,
           "prefill_dispatches": dispatches, "decode_steps": h_decode.count(),
           "flash_launches": launches, "misses_after_compile": misses,
           "recompiles": recompiles,
           "decode_step_p50_s": h_decode.percentile(50),
           "decode_step_p99_s": h_decode.percentile(99),
           "decode_step_mean_s": h_decode.sum() / h_decode.count(),
           "decode_profile": profile,
           "digest": hashlib.sha256(json.dumps(outs).encode()).hexdigest(),
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    return res


def phase_serving(mx, resnet, tfm, kernels, telemetry, GenerationEngine, dev):
    """Phase 22: the serving surface on the card; (a)-(c) only where the
    package has ``predict``, (d) always."""
    import importlib.util

    import torch

    t0 = time.perf_counter()
    res = {}
    if importlib.util.find_spec("mxnet_tpu_torch.predict") is not None:
        telemetry.enable()
        rng = np.random.default_rng(22)
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True  # replay vs eager, bit for bit
        try:
            params = serving_params(mx, resnet)
            pred = serving_predictor(mx, resnet, params)
            res["a"] = serve_buckets(pred, dev, rng)
            log("phase 22 (a): Predictor buckets: %s" % json.dumps(res["a"]))
            res["b"] = serve_engine(pred, telemetry, rng)
            log("phase 22 (b): ServingEngine: %s" % json.dumps(res["b"]))
            res["c"] = serve_int8(mx, resnet, params, pred, telemetry, rng)
            log("phase 22 (c): int8: %s" % json.dumps(res["c"]))
            del pred, params
        finally:
            torch.backends.cudnn.deterministic = deterministic
        torch.cuda.empty_cache()
    res["d"] = serve_decode(tfm, kernels, telemetry, GenerationEngine, dev)
    log("phase 22 (d): GenerationEngine: %s" % json.dumps(res["d"]))
    res["phase_s"] = time.perf_counter() - t0
    log("phase 22: %.1f s" % res["phase_s"])
    return res


# phase 23: resilience through Module.fit (ResNet-50, bf16 AMP, batch 32, dp 4 on gpu(0))
RESIL = dict(batches=8, epochs=2, interval=4, kill=11, preempt=6, nan=6, spike=12, seed=23,
             window=3, timeout=600)
RESIL_MLP = dict(n=64, dim=8, classes=4, batch=8, epochs=2, k=4, spike=6)


def _resil_data():
    """Phase 23's batches from a seed: ``batches`` x 32 images, 1000 classes."""
    rng = np.random.RandomState(RESIL["seed"])
    n = RESIL["batches"] * RESNET_BATCH
    return (rng.rand(n, 3, 224, 224).astype(np.float32),
            rng.randint(0, 1000, n).astype(np.float32))


def tensor_digests(state):
    """sha256 of each :func:`fused_state` tensor's bytes (bf16 as its
    bits): two runs' states compared bit for bit without moving them."""
    import hashlib

    import torch

    out = {}
    for name, t in state.items():
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        out[name] = hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
    return out


def _digest_diff(got, want, skip=()):
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))
    return [n for n in sorted(want) if n not in skip and got[n] != want[n]]


def _resnet_fit_module(mx):
    from mxnet_tpu_torch.models import resnet

    return mx.mod.Module(resnet.get_symbol(), context=mx.gpu(0),
                         mesh=mx.parallel.make_mesh(dp=4, devices=[mx.gpu(0)] * 4))


def _resil_fit_kwargs(mx):
    return dict(kvstore="device", optimizer="sgd",
                optimizer_params={"learning_rate": SGD["lr"], "momentum": SGD["momentum"],
                                  "wd": SGD["wd"]},
                initializer=mx.init.Xavier(), num_epoch=RESIL["epochs"])


def resilience_worker(spec):
    """One ``Module.fit`` of phase 23 in a process of its own (``spec``, a
    JSON dict: package, ckpt, out, k, resume, guard, fault, snap, profile):
    ResNet-50, bf16 AMP, phase 17's recipe, ``MXTPU_CKPT_INTERVAL`` 4, two
    epochs of 8 batches, cuDNN deterministic with autotuning off (the same
    in every run, so each process picks the same algorithms). Writes the
    final state's tensor digests, the metric, the steps it ran, the
    wrappers' launch counts (zeroed before the fit), the groups, digests
    and loss scaler at the ``snap`` steps, and with ``profile`` K1's, K2's
    and K3's device kernels by name over the fit, as JSON to ``out``."""
    import torch

    os.environ.update(MXTPU_AMP="bf16", MXTPU_CKPT_INTERVAL=str(RESIL["interval"]),
                      MXTPU_GUARD_WINDOW=str(RESIL["window"]))
    if spec.get("k", 1) > 1:
        os.environ["MXNET_FIT_MULTISTEP"] = str(spec["k"])
    if spec.get("fault"):
        os.environ["MXTPU_FAULT_INJECT"] = spec["fault"]
    if spec.get("feed"):
        os.environ["MXTPU_DEVICE_FEED"] = spec["feed"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    sys.path.insert(0, spec["package"])
    import logging

    logging.basicConfig(level=logging.INFO)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import kernels

    seeks = []
    if spec.get("rec"):  # phase 24 (d): fed from a .rec by the streaming pipeline
        from mxnet_tpu_torch import io_pipeline

        if spec.get("quarantine"):
            os.environ["MXTPU_QUARANTINE_FILE"] = spec["quarantine"]
        seek = io_pipeline.StreamingImageRecordIter.seek_sample

        def spy(self, pos):
            seeks.append(int(pos))
            return seek(self, pos)

        io_pipeline.StreamingImageRecordIter.seek_sample = spy
        it = _resil_rec_iter(mx, spec)
    else:
        X, y = _resil_data()
        it = mx.io.NDArrayIter(X, y, batch_size=RESNET_BATCH)
    np.random.seed(0)
    mx.random.seed(0)
    mod = _resnet_fit_module(mx)
    steps, snaps = [], {}

    def on_batch(param):
        step = param.epoch * RESIL["batches"] + param.nbatch + 1
        steps.append(step)
        if spec.get("linger_after") and step > spec["linger_after"]:
            time.sleep(INPUT["linger_s"])  # the parent kills this run mid-epoch
        if step in spec.get("snap", ()):
            owner, tr = mod._fused_owner, mod._fused_trainer
            snaps[str(step)] = {
                "digests": tensor_digests(fused_state(mod)),
                "scale": float(owner._fused_opt[tr.AMP_SCALE_KEY]),
                "good": float(owner._fused_opt[tr.AMP_GOOD_KEY])}

    metric = mx.metric.create("acc")
    acts = [torch.profiler.ProfilerActivity.CUDA]  # kernel_counts reads the card's kernels
    zero_counts(kernels)
    with (torch.profiler.profile(activities=acts) if spec.get("profile")
          else contextlib.nullcontext()) as prof:
        t0 = time.perf_counter()
        mod.fit(it, eval_metric=metric, batch_end_callback=on_batch,
                checkpoint_dir=spec["ckpt"], resume=spec.get("resume"),
                guardrails=spec.get("guard"), **_resil_fit_kwargs(mx))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    tr, owner = mod._fused_trainer, mod._fused_owner
    assert tr.amp and tr.flat_mode == "shard" and tr.guard == bool(spec.get("guard"))
    state = fused_state(mod)
    out = {"digests": tensor_digests(state), "metric": metric.get()[1], "steps_run": len(steps),
           "first_step": steps[0] if steps else None, "fit_s": fit_s,
           "launches": dict(conv_counts(kernels), slab_update=kernels.fused_slab_update.launches),
           "groups": tr.group_stats(), "snaps": snaps,
           "finite": all(bool(torch.isfinite(t).all()) for t in state.values()
                         if t.is_floating_point()),
           "loss_scale": float(owner._fused_opt[tr.AMP_SCALE_KEY]),
           "good": float(owner._fused_opt[tr.AMP_GOOD_KEY])}
    if spec.get("profile"):
        out["launches_run"] = kernel_counts(prof)
    if spec.get("rec"):
        out["seek_sample"] = seeks
        it.close()
    with open(spec["out"], "w") as fh:
        json.dump(out, fh)
    log("WORKER-DONE")
    return 0


def _resil_run(root, package, name, **spec):
    """Run one worker; returns its exit code, wall seconds, the tail of its
    log and the JSON it wrote (if it got that far)."""
    spec.update(package=package, out=os.path.join(root, name + ".json"),
                ckpt=os.path.join(root, spec.pop("dir")))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--resilience-worker",
                           json.dumps(spec)], capture_output=True, text=True,
                          timeout=RESIL["timeout"])
    res = {"name": name, "rc": proc.returncode, "wall_s": time.perf_counter() - t0,
           "log": proc.stdout[-2000:] + proc.stderr[-6000:]}
    if os.path.exists(spec["out"]):
        with open(spec["out"]) as fh:
            res.update(json.load(fh))
    return res


def _expect(run, rc):
    if run["rc"] != rc:
        raise AssertionError("phase 23 %s: exit %s, expected %s\n%s"
                             % (run["name"], run["rc"], rc, run["log"]))


def resil_measure(mx, kernels, dev, ck, path, ref):
    """Phase 23 (a)'s numbers on a fused module in this process: the
    reference's final checkpoint restored (load, then placement; the state
    equal to the reference run's bit for bit), a synchronous save of the
    same state, and the host ms ``save_async`` takes from the train thread
    (the device clones and the thread's start) beside its total."""
    import shutil

    import torch

    mod = _resnet_fit_module(mx)
    _amp_env(True)
    try:
        mod.bind(data_shapes=[("data", (RESNET_BATCH, 3, 224, 224))],
                 label_shapes=[("softmax_label", (RESNET_BATCH,))])
        mod.init_params(initializer=mx.init.Xavier())
        kw = _resil_fit_kwargs(mx)
        mod.init_optimizer(kvstore=kw["kvstore"], optimizer=kw["optimizer"],
                           optimizer_params=kw["optimizer_params"])
    finally:
        _amp_env(False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = ck.load_state(path)
    t1 = time.perf_counter()
    mod._restore_train_state(state["module"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    diff = _digest_diff(tensor_digests(fused_state(mod)), ref["digests"])
    assert not diff, "restored state differs from the reference run's: %s" % diff[:5]
    out_dir = os.path.join(os.path.dirname(os.path.dirname(path)), "measure")
    mgr = ck.CheckpointManager(out_dir, keep=100)

    def blob():
        return {"module": mod._capture_train_state(), "epoch": RESIL["epochs"], "nbatch": 0,
                "global_step": 16, "metric": None, "rng": {"numpy": np.random.get_state()}}

    sync_ms, host_ms, async_ms = [], [], []
    for rep in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        mgr.save(blob(), 100 + rep)
        sync_ms.append(1e3 * (time.perf_counter() - t))
        torch.cuda.synchronize()
        t = time.perf_counter()
        mgr.save_async(blob(), 200 + rep)
        host_ms.append(1e3 * (time.perf_counter() - t))
        mgr.wait()
        async_ms.append(1e3 * (time.perf_counter() - t))
    assert mgr._last_error is None, mgr._last_error
    ck.verify_checkpoint(ck.step_dir(out_dir, 202), deep=True)
    files = os.listdir(path)
    res = {"checkpoint_bytes": sum(os.path.getsize(os.path.join(path, f)) for f in files),
           "members": {f: os.path.getsize(os.path.join(path, f)) for f in files},
           "restore_ms": 1e3 * (t2 - t0), "restore_load_ms": 1e3 * (t1 - t0),
           "restore_place_ms": 1e3 * (t2 - t1), "restored_state_bitwise_equal": True,
           "save_sync_ms": sync_ms, "save_async_host_ms": host_ms,
           "save_async_total_ms": async_ms}
    shutil.rmtree(out_dir, ignore_errors=True)
    return mod, res


def resil_serving(mx, dev, ck, path, mod_train):
    """Phase 23 (d): ``predict.params_from_checkpoint`` on (a)'s final
    checkpoint, a ``Predictor`` on gpu(0) (buckets 1 and 32, captured),
    its batch-32 replay against ``Module.predict`` of an inference Module
    with the same params bit for bit (cuDNN deterministic, as phase 22);
    then ``tools/serve.py --checkpoint`` in a process of its own answers one
    request with the bucket-1 row (within 1e-5 of its max)."""
    import socket

    import torch

    from mxnet_tpu_torch import predict
    from mxnet_tpu_torch.models import resnet

    params = predict.params_from_checkpoint(path)
    arg_m, aux_m = mod_train.get_params()  # the restored f32 masters and aux
    for k, v in arg_m.items():
        assert torch.equal(params["arg:" + k]._data, v._data), k
    pred = serving_predictor(mx, resnet, params)
    pred.compile([{"data": (b,) + SERVE_SHAPE} for b in (1, RESNET_BATCH)])
    rng = np.random.default_rng(RESIL["seed"])
    x = rng.standard_normal((RESNET_BATCH,) + SERVE_SHAPE, dtype=np.float32)
    got = pred.predict_batch(data=x)[0]
    symbol = resnet.get_symbol(num_classes=1000, num_layers=50,
                               image_shape=",".join(str(d) for d in SERVE_SHAPE))
    infer = mx.mod.Module(symbol, context=mx.gpu(0))
    infer.bind(data_shapes=[("data", x.shape)], for_training=False)
    infer.set_params({k: params["arg:" + k] for k in arg_m},
                     {k: params["aux:" + k] for k in aux_m})
    want = infer.predict(mx.io.NDArrayIter(x, None, batch_size=RESNET_BATCH)).asnumpy()
    assert got.shape == (RESNET_BATCH, 1000) and np.isfinite(got).all()
    if not _bits_equal(got, want):
        raise AssertionError("phase 23 (d): the checkpoint's Predictor differs from "
                             "Module.predict by %.3g" % float(np.abs(got - want).max()))
    row = pred.predict_batch(data=x[:1])[0][0]
    sym_file = os.path.join(os.path.dirname(os.path.dirname(path)), "resnet50.json")
    symbol.save(sym_file)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(mx.__file__))))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.serve", "--checkpoint", path,
         "--symbol", sym_file, "--input", "data=%s" % "x".join(map(str, SERVE_SHAPE)),
         "--port", "0", "--max-batch", "1"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        if not line.startswith("serving on "):
            proc.kill()
            raise AssertionError("serve.py --checkpoint did not start: %r %s"
                                 % (line, proc.stderr.read()[-3000:]))
        ready_s = time.perf_counter() - t0
        port = int(line.split()[2].split(":")[1])
        with socket.create_connection(("127.0.0.1", port), 120) as s:
            fh = s.makefile("rwb")
            t = time.perf_counter()
            fh.write((json.dumps({"inputs": {"data": x[0].tolist()}}) + "\n").encode())
            fh.flush()
            reply = json.loads(fh.readline().decode())
            request_ms = 1e3 * (time.perf_counter() - t)
        served = np.asarray(reply["outputs"][0], np.float32)
        err = float(np.abs(served - row).max() / np.abs(row).max())
        assert served.shape == row.shape and err <= 1e-5, (served.shape, err)
        proc.send_signal(15)
        rc = proc.wait(120)
        assert rc == 0, (rc, proc.stderr.read()[-3000:])
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"predictor_vs_module_predict": "bitwise", "rows": RESNET_BATCH,
            "serve": {"ready_s": ready_s, "request_ms": request_ms, "reply_err_rel": err,
                      "server_latency_ms": reply.get("latency_ms"), "exit": rc}}


def resil_gated_k1(kernels, dev, plan):
    """Phase 23's K1 check: the guard's gated launch (its flag a device
    scalar ``finite and gn2 <= threshold``) over ResNet-50's 16 buckets
    against ``slab_update_multi_reference`` bit for bit: eagerly with the
    flag 0 (outputs equal inputs), and one launch captured in a CUDA graph
    replayed with the threshold written 0 then inf between replays (the
    gated and the applied step), each replay from the same state."""
    import torch

    gen = torch.Generator().manual_seed(23)
    sizes = [b.padded for b in plan.buckets]
    w0 = [torch.randn(s, generator=gen).to(dev) for s in sizes]
    m0 = [(torch.randn(s, generator=gen) * 0.1).to(dev) for s in sizes]
    g = [(torch.randn(s, generator=gen) * 4).to(dev, torch.bfloat16) for s in sizes]
    w = [t.clone() for t in w0]
    m = [t.clone() for t in m0]
    w16 = [torch.empty(s, dtype=torch.bfloat16, device=dev) for s in sizes]
    lr = torch.full((), SGD["lr"], device=dev)
    thr = torch.zeros((), device=dev)
    inv = torch.full((), 1.0 / 1024, device=dev)
    kw = dict(rescale_grad=1.0 / RESNET_BATCH, clip_gradient=None, momentum=SGD["momentum"])

    def flag():
        gn2 = torch.stack([torch.linalg.vector_norm(t, dtype=torch.float32).square()
                           for t in g]).sum() * inv * inv
        return (torch.isfinite(gn2) & (gn2 <= thr)).float()

    def table(out):
        return [kernels.SlabEntry(w[i], g[i], (m[i],), lr, SGD["wd"],
                                  (w[i], (m[i],), w16[i]) if out else None)
                for i in range(len(sizes))]

    def reference(f):
        ins = [kernels.SlabEntry(w0[i], g[i], (m0[i],), lr, SGD["wd"], None)
               for i in range(len(sizes))]
        return kernels.slab_update_multi_reference("sgd_mom", ins, inv, f, **kw)

    def same(got, want):
        return all(torch.equal(a[0], b[0]) and torch.equal(a[1][0], b[1][0])
                   and torch.equal(a[2], b[2]) for a, b in zip(got, want))

    got = kernels.fused_slab_update_multi("sgd_mom", table(False), inv, flag(), **kw)
    torch.cuda.synchronize()
    assert float(flag()) == 0.0
    assert same(got, reference(torch.zeros((), device=dev))), "eager gated K1 != plain"
    assert all(torch.equal(a[0], b) for a, b in zip(got, w0)), "gated K1 moved a master"
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kernels.fused_slab_update_multi("sgd_mom", table(True), inv, flag(), **kw)
    replays = {}
    for value in (0.0, float("inf")):
        for a, b in zip(w + m, w0 + m0):
            a.copy_(b)
        thr.fill_(value)
        graph.replay()
        torch.cuda.synchronize()
        f = torch.full((), 0.0 if value == 0.0 else 1.0, device=dev)
        got = [(w[i], (m[i],), w16[i]) for i in range(len(sizes))]
        assert same(got, reference(f)), "replayed K1 (threshold %g) != plain" % value
        replays["threshold_%g" % value] = ("gated: inputs kept" if value == 0.0
                                           else "applied")
    return {"buckets": len(sizes), "eager_gated_bitwise": True, "replays_bitwise": replays}


def resil_mlp_spike(mx, dev, ck, root):
    """Phase 23 (c)'s loss spike where it reaches the gradient: a 2-layer
    MLP (no BatchNorm) under bf16 AMP at K = 4, ``loss_spike_at_step=6``
    inside the first replayed group: the gate, its threshold from the
    warmed detector written between groups, skips step 6 (the health stamp
    counts one skip and one trip), one capture, the run finite."""
    import logging

    rng = np.random.RandomState(42)
    c = RESIL_MLP
    X = rng.randn(c["n"], c["dim"]).astype(np.float32)
    y = rng.randint(0, c["classes"], c["n"]).astype(np.float32)
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=c["classes"], name="fc2")
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    env = {"MXTPU_AMP": "bf16", "MXNET_FIT_MULTISTEP": str(c["k"]),
           "MXTPU_GUARD_WINDOW": str(RESIL["window"]), "MXTPU_CKPT_INTERVAL": "4",
           "MXTPU_FAULT_INJECT": "loss_spike_at_step=%d,mlp=1" % c["spike"]}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    records = []

    class _Grab(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    grab = _Grab(level=logging.WARNING)
    logging.getLogger().addHandler(grab)
    try:
        np.random.seed(0)
        mod = mx.mod.Module(net, context=mx.gpu(0),
                            mesh=mx.parallel.make_mesh(dp=4, devices=[mx.gpu(0)] * 4))
        ckpt = os.path.join(root, "mlp")
        mod.fit(mx.io.NDArrayIter(X, y, batch_size=c["batch"]), kvstore="device",
                optimizer="sgd", optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=mx.init.Uniform(0.1), num_epoch=c["epochs"], checkpoint_dir=ckpt,
                guardrails="auto")
    finally:
        logging.getLogger().removeHandler(grab)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    (g,) = mod._fused_trainer.group_stats()
    health = ck.read_manifest(ck.step_dir(ckpt, ck.list_checkpoints(ckpt)[-1]))["health"]
    skipped = [r for r in records if "skipped step %d" % c["spike"] in r]
    assert skipped, records
    assert g["captures"] == 1 and g["warmup_groups"] == 1, g
    assert (health["skips"], health["trips"]) == (1, 1), health
    arg, _ = mod.get_params()
    assert all(np.isfinite(v.asnumpy()).all() for v in arg.values())
    return {"k": c["k"], "spike_step": c["spike"], "log": skipped[0], "group": g,
            "health": {k: health[k] for k in ("skips", "trips", "last_clean_step")}}


def phase_resilience(mx, kernels, dev, package, plan, full=True):
    """Phase 23; see the module docstring. Without ``full`` (the full
    script) the K = 4 chain of (a) and (c)'s guarded K = 4 fit are left to
    ``--only resilience``."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from mxnet_tpu_torch.resilience import checkpoint as ck

    torch.backends.cudnn.deterministic = True
    root = tempfile.mkdtemp(prefix="chip_smoke_resilience_")
    fault_c = "nan_grad_at_step=%d,loss_spike_at_step=%d" % (RESIL["nan"], RESIL["spike"])
    # a reference needs nothing of its kill / resume chain: each runs apart
    chains = {
        "r1": [("ref1", dict(dir="ref1", k=1))],
        "a1": [("kill1", dict(dir="kill1", k=1, fault="kill_at_step=%d" % RESIL["kill"])),
               ("res1", dict(dir="kill1", k=1, resume="auto", profile=True))],
        "r4": [("ref4", dict(dir="ref4", k=4))],
        "a4": [("kill4", dict(dir="kill4", k=4, fault="kill_at_step=%d" % RESIL["kill"])),
               ("res4", dict(dir="kill4", k=4, resume="auto", profile=True))],
        "b": [("pre", dict(dir="pre", k=1, fault="preempt_at_step=%d" % RESIL["preempt"])),
              ("preres", dict(dir="pre", k=1, resume="auto"))],
        "c": [("nan1", dict(dir="nan1", k=1, guard="auto", fault=fault_c,
                            snap=[RESIL["nan"] - 1, RESIL["nan"]])),
              ("nan4", dict(dir="nan4", k=4, guard="auto", fault=fault_c))],
    }
    ks = (1, 4) if full else (1,)
    if not full:
        del chains["r4"], chains["a4"]
        chains["c"] = chains["c"][:1]
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(chains)) as pool:
            futures = {c: pool.submit(lambda runs: [_resil_run(root, package, n, **dict(s))
                                                    for n, s in runs], runs)
                       for c, runs in chains.items()}
            runs = {r["name"]: r for f in futures.values() for r in f.result()}
        workers_s = time.perf_counter() - t0
        res = {"workers_s": workers_s, "concurrent_chains": len(chains),
               "runs": {n: {k: r.get(k) for k in ("rc", "wall_s", "fit_s", "steps_run",
                                                  "first_step", "launches", "launches_run",
                                                  "metric", "loss_scale", "good", "finite")}
                        for n, r in runs.items()}}
        # (a) kill and resume, K = 1 and 4
        launches = dict.fromkeys(MULTI_KERNEL_NAMES, 0)
        for k in ks:
            ref, kill, again = runs["ref%d" % k], runs["kill%d" % k], runs["res%d" % k]
            _expect(ref, 0)
            _expect(kill, -9)
            _expect(again, 0)
            assert ref["finite"] and ref["steps_run"] == 16, ref["steps_run"]
            assert "resume: restored step" in again["log"], again["log"]
            diff = _digest_diff(again["digests"], ref["digests"])
            assert not diff, "k %d: %d tensors differ after the resume, first %s" % (
                k, len(diff), diff[:5])
            assert again["metric"] == ref["metric"], (again["metric"], ref["metric"])
            n = again["steps_run"]
            a_step = {"conv_bwd_filter": RESNET_CONVS, "conv_bwd_input": RESNET_CONVS,
                      "slab_update": 1}
            assert again["launches_run"] == {m: c * n for m, c in a_step.items()}, (
                again["launches_run"], n)
            for m in launches:
                launches[m] += again["launches_run"][m]
            if k > 1:
                (g,) = again["groups"]
                assert g["captures"] == 1, g
            res["a_k%d" % k] = {"bitwise_equal_to_reference": len(ref["digests"]),
                                "resumed_at_step": again["first_step"] - 1, "steps_run": n,
                                "launches_run": again["launches_run"],
                                "metric_equal": True}
        res["launches_resumed_runs"] = launches
        # (b) SIGTERM: exit 75 after a final checkpoint at step 6, then the resume
        pre, preres = runs["pre"], runs["preres"]
        _expect(pre, 75)
        _expect(preres, 0)
        assert "preempted: checkpoint at step %d written" % RESIL["preempt"] in pre["log"]
        assert "resume: restored step %d" % RESIL["preempt"] in preres["log"], preres["log"]
        diff = _digest_diff(preres["digests"], runs["ref1"]["digests"])
        assert not diff, "SIGTERM resume differs: %s" % diff[:5]
        res["b"] = {"exit": pre["rc"], "checkpoint_step": RESIL["preempt"],
                    "bitwise_equal_to_reference": len(preres["digests"])}
        # (c) the guard: the NaN step keeps every bit of the step before
        nan1 = runs["nan1"]
        _expect(nan1, 0)
        before, after = (nan1["snaps"][str(s)] for s in (RESIL["nan"] - 1, RESIL["nan"]))
        scaler = ("opt:__amp_scale__.0", "opt:__amp_good__.0")
        diff = _digest_diff(after["digests"], before["digests"], skip=scaler)
        assert not diff, "the gated step changed %s" % diff[:5]
        assert after["scale"] == before["scale"] / 2 and after["good"] == 0.0, (before, after)
        assert nan1["finite"]
        g = None
        if full:
            nan4 = runs["nan4"]
            _expect(nan4, 0)
            assert nan4["finite"]
            diff = _digest_diff(nan4["digests"], nan1["digests"])
            assert not diff, "guarded K = 4 differs from guarded eager: %s" % diff[:5]
            (g,) = nan4["groups"]
            assert g["captures"] == 1 and g["warmup_groups"] == 1, g
        health = ck.read_manifest(ck.step_dir(os.path.join(root, "nan1"), 16))["health"]
        spike_trip = "skipped step %d" % RESIL["spike"] in nan1["log"]
        res["c"] = {"nan_step": RESIL["nan"], "state_after_equals_before_bitwise": True,
                    "scale_before": before["scale"], "scale_after": after["scale"],
                    "k4_bitwise_equal_to_eager": len(runs["nan4"]["digests"]) if full else None,
                    "k4_group": g,
                    "health_at_16": {k: health[k] for k in ("skips", "trips",
                                                            "last_clean_step")},
                    "resnet_spike_step": RESIL["spike"], "resnet_spike_skipped": spike_trip,
                    "rewound": "guardrail: rewound" in nan1["log"]}
        res["c"]["mlp_spike"] = resil_mlp_spike(mx, dev, ck, root)
        res["gated_k1"] = resil_gated_k1(kernels, dev, plan)
        # (a)'s numbers and (d) on the reference's final checkpoint
        path = ck.step_dir(os.path.join(root, "ref1"), 16)
        ck.verify_checkpoint(path, deep=True)
        mod, res["a_numbers"] = resil_measure(mx, kernels, dev, ck, path, runs["ref1"])
        res["d"] = resil_serving(mx, dev, ck, path, mod)
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(root, ignore_errors=True)
    log("phase 23: resilience: %s" % json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# Phase 24: the input path (RecordIO, native decode, ImageRecordIter, the
# streaming decode pool, DeviceFeedIter) feeding Module.fit
# ---------------------------------------------------------------------------

INPUT = dict(records=1024, resil_records=256, side=(256, 400), seed=0,
             shape=(3, 224, 224), mean=(123.68, 116.28, 103.53), threads=(1, 4, 8),
             workers=(4, 8), bench_blocks=6, fit_workers=4, fit_k=4, window=(8, 32),
             delay_cycles=50_000_000, bad=2, read_fail=2, kill_after_step=12, linger_s=1.0)
#: phase 24 (c)'s fits: (K, MXTPU_DEVICE_FEED, MXTPU_FEED_DEPTH, a sleep of
#: ``delay_cycles`` on the staging stream before each staged copy)
INPUT_FITS = ((1, "0", None, False), (1, "1", None, False), (1, "1", "1", True),
              (4, "0", None, False), (4, "1", None, False))
#: the rate one replayed ResNet-50 AMP fit step consumes: 32 images in
#: 37.41 ms (PERF.md section 5, phase 21 at K = 8)
REPLAYED_FIT_IMG_S = RESNET_BATCH / 37.41e-3
PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _png_chunk(kind, data):
    import struct
    import zlib

    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(img, level=1):
    """An 8-bit RGB PNG of ``img`` (HxWx3 uint8), written with the standard
    library's zlib (the card's machine has no PIL): row y uses filter type
    y % 5, so every image holds all five filters."""
    import struct
    import zlib

    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int16)
    a = np.zeros_like(x)
    a[:, c:] = x[:, :-c]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    ul = np.zeros_like(x)
    ul[1:, c:] = x[:-1, :-c]
    p = a + b - ul
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
    preds = (np.zeros_like(x), a, b, (a + b) // 2, paeth)
    filt = np.arange(h) % 5
    rows = np.empty((h, 1 + w * c), np.uint8)
    rows[:, 0] = filt
    for k, pred in enumerate(preds):
        sel = filt == k
        rows[sel, 1:] = ((x[sel] - pred[sel]) % 256).astype(np.uint8)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (PNG_SIG + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _png_chunk(b"IEND", b""))


def smooth_image(params):
    """A smooth synthetic RGB image from (h, w, per-channel frequencies and
    phases): sums of two sinusoids a channel."""
    h, w, freqs, phases = params
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    chans = [127.5 + 60 * np.sin(2 * np.pi * (f[0] * xx + f[1] * yy) + ph[0])
             + 50 * np.cos(2 * np.pi * (f[2] * xx - f[3] * yy) + ph[1])
             for f, ph in zip(freqs, phases)]
    return np.clip(np.stack(chans, axis=-1), 0, 255).astype(np.uint8)


def input_records(root, recordio):
    """Phase 24 (a)'s data: ``records`` PNG records from seed 0 (sides 256-400,
    labels 0-999) through the port's MXIndexedRecordIO (read by (b) and
    (c)), and the file of its first 256 records for (d). Returns the
    paths, the payloads, the first images and the seconds taken."""
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.RandomState(INPUT["seed"])
    lo, hi = INPUT["side"]
    params, labels = [], []
    for _ in range(INPUT["records"]):
        h, w = rng.randint(lo, hi + 1, size=2)
        params.append((int(h), int(w), rng.uniform(0.3, 3.0, (3, 4)),
                       rng.uniform(0, 2 * np.pi, (3, 2))))
        labels.append(float(rng.randint(0, 1000)))
    t0 = time.perf_counter()

    def make(p):
        img = smooth_image(p)
        return img, png_bytes(img)

    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        made = list(pool.map(make, params))
    encode_s = time.perf_counter() - t0
    payloads = [recordio.pack(recordio.IRHeader(0, labels[i], i, 0), png)
                for i, (_, png) in enumerate(made)]
    paths = {}
    t0 = time.perf_counter()
    for name, n in (("input", INPUT["records"]), ("resil", INPUT["resil_records"])):
        rec, idx = os.path.join(root, name + ".rec"), os.path.join(root, name + ".idx")
        w = recordio.MXIndexedRecordIO(idx, rec, "w")
        for i in range(n):
            w.write_idx(i, payloads[i])
        w.close()
        paths[name] = rec
    return (paths, payloads, [img for img, _ in made[:8]], labels, encode_s,
            time.perf_counter() - t0)


def decode_libraries():
    """What the machine offers for image decode: the loader's libjpeg and
    libz lines, and whether PIL and cv2 import."""
    try:
        out = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True,
                             timeout=30).stdout
        lines = [l.strip() for l in out.splitlines() if re.search(r"libjpeg|libz\.", l)]
    except (OSError, subprocess.SubprocessError) as exc:
        lines = ["ldconfig failed: %s" % exc]
    found = {"ldconfig": lines}
    for mod in ("PIL", "cv2"):
        try:
            __import__(mod)
            found[mod] = True
        except ImportError:
            found[mod] = False
    return found


def input_iter(mx, rec, threads=1, workers=0, **kw):
    args = dict(path_imgrec=rec, data_shape=INPUT["shape"], batch_size=RESNET_BATCH,
                rand_crop=True, rand_mirror=True, mean_r=INPUT["mean"][0],
                mean_g=INPUT["mean"][1], mean_b=INPUT["mean"][2], preprocess_threads=threads,
                input_workers=workers, shuffle=True, seed=0)
    args.update(kw)
    return mx.io.ImageRecordIter(**args)


def input_rate(mx, rec, threads=1, workers=0, decoder="native"):
    """Phase 24 (b): img/s of ImageRecordIter on the host (batches under
    ``cpu()``) over ``bench_blocks`` blocks of 32 batches (an epoch of the
    file each; the iterator resets at its end) after a first batch (which
    starts a decode pool); the rate over all blocks and each block's.
    ``decoder="pil"`` sends the PNG payloads to PIL (threads only: the
    decode processes import the module afresh)."""
    from mxnet_tpu_torch import native

    block = INPUT["records"] // RESNET_BATCH
    saved = native.imdecode_png
    if decoder == "pil":
        native.imdecode_png = lambda buf, gray=False: None  # falls through to PIL
    try:
        with mx.cpu():
            it = input_iter(mx, rec, threads=threads, workers=workers)
            t0 = time.perf_counter()
            it.next()
            first_s = time.perf_counter() - t0
            stamps = [time.perf_counter()]
            n = 0
            while n < INPUT["bench_blocks"] * block:
                try:
                    b = it.next()
                except StopIteration:
                    it.reset()
                    continue
                n += 1
                if n % block == 0:
                    stamps.append(time.perf_counter())
            assert tuple(b.data[0].shape) == (RESNET_BATCH,) + INPUT["shape"]
            assert b.data[0]._data.device.type == "cpu"
            if hasattr(it, "close"):
                it.close()
    finally:
        native.imdecode_png = saved
    blocks = [block * RESNET_BATCH / (b - a) for a, b in zip(stamps, stamps[1:])]
    return {"threads": threads, "workers": workers, "decoder": decoder,
            "first_batch_s": first_s, "batches": n,
            "img_per_s": n * RESNET_BATCH / (stamps[-1] - stamps[0]),
            "block_img_per_s": blocks}


def decode_compare(payloads, recordio):
    """Phase 24 (b): ms an image of the native PNG decoder and of PIL on one
    thread over every payload (PIL as the port calls it: open, RGB, numpy),
    each pass twice in turn; the pixels must agree."""
    import io as _io

    from PIL import Image

    from mxnet_tpu_torch import native

    pngs = [recordio.unpack(p)[1] for p in payloads]
    decoders = {"native": native.imdecode_png,
                "pil": lambda b: np.asarray(Image.open(_io.BytesIO(b)).convert("RGB"))}
    ms = {n: [] for n in decoders}
    for _ in range(2):
        for name, fn in decoders.items():
            t0 = time.perf_counter()
            for b in pngs:
                fn(b)
            ms[name].append(1e3 * (time.perf_counter() - t0) / len(pngs))
    for b in pngs[::97]:
        assert np.array_equal(decoders["native"](b), decoders["pil"](b)), "native vs PIL"
    return {"images": len(pngs), "ms_per_image": ms,
            "native_over_pil": min(ms["native"]) / min(ms["pil"])}


def batch_tensors(batch):
    return [t._data for t in batch.data + batch.label]


def batch_checksum(tensors):
    """Two exact int64 sums of each float32 tensor's bits (plain, and weighted
    by position mod 1021), stacked: queued on the tensors' device, read
    later, so a fit is not synchronised for it."""
    import torch

    out = []
    for t in tensors:
        v = t.detach().reshape(-1).view(torch.int32).to(torch.int64)
        w = torch.arange(v.numel(), device=v.device, dtype=torch.int64) % 1021
        out += [v.sum(), (v * w).sum()]
    return torch.stack(out)


def _interval_overlap(spans, others):
    """The part of ``spans`` (a list of (start, end)) covered by the union
    of ``others``."""
    merged = []
    for s, e in sorted(others):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    total = 0.0
    for s, e in spans:
        for ms, me in merged:
            total += max(0.0, min(e, me) - max(s, ms))
    return total


def window_profile(prof, lo, hi):
    """Over steps ``lo`` + 1 to ``hi`` on the card's timeline (from the end of
    K1's ``lo``-th launch to the end of its ``hi``-th: one a step): wall ms,
    busy ms of the card's kernels (the staging stream's sleeps left out),
    the idle share, the host-to-device copies' ms and how much of it ran
    while a kernel ran, and K1's, K2's and K3's kernels by name."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev = sorted((e for e in prof.events() if e.device_type == cuda),
                 key=lambda e: e.time_range.start)
    k1 = [e for e in dev if MULTI_KERNEL_NAMES["slab_update"] in e.name]
    t0, t1 = k1[lo - 1].time_range.end, k1[hi - 1].time_range.end
    dev = [e for e in dev if t0 <= e.time_range.start and e.time_range.end <= t1]
    kern = [(e.time_range.start, e.time_range.end) for e in dev
            if not any(w in e.name.lower() for w in ("memcpy", "memset", "spin_kernel"))]
    htod = [(e.time_range.start, e.time_range.end) for e in dev
            if "memcpy htod" in e.name.lower()]
    busy = sum(e - s for s, e in kern)
    copy = sum(e - s for s, e in htod)
    names = [e.name for e in dev]
    return {"wall_ms": (t1 - t0) / 1e3, "busy_ms": busy / 1e3,
            "idle_share": max(0.0, 1.0 - busy / max(1e-9, t1 - t0)), "kernels": len(kern),
            "htod_copies": len(htod), "htod_ms": copy / 1e3,
            "htod_overlapped_ms": _interval_overlap(htod, kern) / 1e3,
            "launches": {n: sum(key in name for name in names)
                         for n, key in MULTI_KERNEL_NAMES.items()}}


def input_fit(mx, kernels, rec, k, feed, depth=None, delay=False):
    """Phase 24 (c): ResNet-50 bf16 AMP ``Module.fit`` (phase 17's recipe,
    dp 4 on gpu(0)) over the 32 batches of ``rec`` through
    ``ImageRecordIter`` with a 4-process decode pool, at K
    (``MXNET_FIT_MULTISTEP``) with ``MXTPU_DEVICE_FEED`` = ``feed`` and
    ``MXTPU_FEED_DEPTH`` = ``depth``, under torch.profiler (the card's
    activity) with steps 9-32 as the window; with ``delay`` every staged
    copy waits behind a
    sleep on the staging stream. Returns the state digests, the checksums
    of the tensors each step received (queued on the step's stream before
    the step) and of each batch after its step, ``bn_data``'s moving
    statistics after each step, the launch counts, step ms and the
    window's profile."""
    import torch

    from mxnet_tpu_torch import io as mx_io
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.module.module import Module

    lo, hi = INPUT["window"]
    os.environ["MXTPU_DEVICE_FEED"] = feed
    if depth is not None:
        os.environ["MXTPU_FEED_DEPTH"] = depth
    if k > 1:
        os.environ["MXNET_FIT_MULTISTEP"] = str(k)
    it = input_iter(mx, rec, workers=INPUT["fit_workers"])
    np.random.seed(0)
    mx.random.seed(0)
    mod = mx.mod.Module(resnet.get_symbol(), context=mx.gpu(0),
                        mesh=mx.parallel.make_mesh(dp=4, devices=[mx.gpu(0)] * 4))
    received, seen, bn_data, stamps, marks = [], [], [], [], {}

    def on_batch(param):
        step = param.nbatch + 1
        batch = param.locals["data_batch"]
        # exact integer checksums, queued on the card, of every batch after its step
        seen.append(batch_checksum(batch_tensors(batch)))
        aux = mod._fused_owner._fused_aux
        bn_data.append(torch.cat([t.detach().reshape(-1).float() for name in sorted(aux)
                                  if name.startswith("bn_data_")
                                  for t in (aux[name] if isinstance(aux[name], tuple)
                                            else (aux[name],))]))
        marks.setdefault("staged_device", str(getattr(batch, "staged_device", None)))
        stamps.append(time.perf_counter())
        if step in (lo, hi):
            torch.cuda.synchronize()
            marks[step] = time.perf_counter()

    make, multi, place = Module._make_fused_batch, Module.update_multi, mx_io.DeviceFeedIter._place

    def make_spy(self, data_batch):
        batch = make(self, data_batch)
        received.append(batch_checksum(list(batch.values())))  # before the step, on its stream
        return batch

    def multi_spy(self, data_batches):
        received.extend(batch_checksum(batch_tensors(b)) for b in data_batches)
        return multi(self, data_batches)

    def delayed_place(self, arr, pinned):
        if self._cuda:
            with torch.cuda.stream(self._stream):
                torch.cuda._sleep(INPUT["delay_cycles"])
        return place(self, arr, pinned)

    Module._make_fused_batch, Module.update_multi = make_spy, multi_spy
    if delay:
        mx_io.DeviceFeedIter._place = delayed_place
    _amp_env(True)
    zero_counts(kernels)
    try:
        # the card's activity only: the host's ops would cost tens of seconds to parse
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mod.fit(it, kvstore="device", optimizer="sgd",
                    optimizer_params={"learning_rate": SGD["lr"], "momentum": SGD["momentum"],
                                      "wd": SGD["wd"]},
                    initializer=mx.init.Xavier(), num_epoch=1, batch_end_callback=on_batch)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
    finally:
        Module._make_fused_batch, Module.update_multi = make, multi
        mx_io.DeviceFeedIter._place = place
        _amp_env(False)
        for name in ("MXTPU_DEVICE_FEED", "MXTPU_FEED_DEPTH", "MXNET_FIT_MULTISTEP"):
            os.environ.pop(name, None)
        it.close()
    assert it.bad_records == 0, "%d records quarantined" % it.bad_records
    tr = mod._fused_trainer
    assert tr.amp and tr.flat_mode == "shard", (tr.amp, tr.flat_mode)
    steps = INPUT["records"] // RESNET_BATCH
    assert len(stamps) == steps and len(received) == steps, (len(stamps), len(received))
    win = window_profile(prof, lo, hi)
    a_step = {"conv_bwd_filter": RESNET_CONVS, "conv_bwd_input": RESNET_CONVS,
              "slab_update": 1}
    assert win["launches"] == {n: (hi - lo) * c for n, c in a_step.items()}, win["launches"]
    # what ran on the device over the whole fit, by kernel name
    run = kernel_counts(prof)
    assert run == {n: steps * c for n, c in a_step.items()}, (run, steps)
    wrappers = dict(conv_counts(kernels), slab_update=kernels.fused_slab_update.launches)
    if k == 1:
        assert wrappers == run, (wrappers, run)
    else:
        # the wrappers count in the warm-up group and once while the graph
        # is captured; a replay calls no wrapper
        (g,) = tr.group_stats()
        assert g["captures"] == 1 and g["replays"] == steps // k - 1, g
        assert wrappers == {n: 2 * k * c for n, c in a_step.items()}, wrappers
    state = fused_state(mod)
    # per-step host times over the window, four steps at a time (a K = 4
    # group's callbacks come together)
    quads = [1e3 * (stamps[i + 3] - stamps[i - 1]) / 4 for i in range(lo, hi, 4)]
    res = {"k": k, "device_feed": feed, "feed_depth": depth or "2", "delayed_staging": delay,
           "fit_s": fit_s, "steps": steps, "staged_device": marks["staged_device"],
           "received": [[int(v) for v in c.cpu().tolist()] for c in received],
           "batches": [[int(v) for v in c.cpu().tolist()] for c in seen],
           "bn_data": [c.cpu().numpy().tobytes().hex() for c in bn_data],
           "digests": tensor_digests(state),
           "finite": all(bool(torch.isfinite(t).all()) for t in state.values()
                         if t.is_floating_point()),
           "launches": wrappers if k == 1 else run,
           "launches_counted_by": ("wrappers (equal to the profiler's over the fit)" if k == 1
                                   else "torch.profiler: device kernels by name, whole fit"),
           "step_ms": 1e3 * (marks[hi] - marks[lo]) / (hi - lo),
           "step_ms_by_4": quads, "window_steps": [lo + 1, hi], "window": win}
    if k > 1:
        res["groups"] = tr.group_stats()
    return res


def _resil_rec_iter(mx, spec):
    """Phase 24 (d)'s iterator in a resilience worker."""
    return input_iter(mx, spec["rec"], workers=spec.get("workers", 2))


def input_resilience(package, paths, root):
    """Phase 24 (d): phase 23's worker harness on fits fed from a .rec by
    ``ImageRecordIter`` with a 2-process decode pool through the device
    feed (``MXTPU_DEVICE_FEED=1``): an uninterrupted
    reference, a run SIGKILLed mid-epoch 2 once its step-12 checkpoint
    landed (the run lingers after step 12 so the kill falls mid-epoch),
    the resume (at the checkpoint's ``sample_position``), and a run with
    ``bad_record`` = 2 on a 1-process pool (two quarantine lines, the fit
    finishes)."""
    from concurrent.futures import ThreadPoolExecutor

    from mxnet_tpu_torch.resilience import checkpoint as ck

    rec = paths["resil"]
    qfile = os.path.join(root, "quarantine.jsonl")
    common = dict(k=1, rec=rec, workers=2, feed="1")

    def killed():
        spec = dict(common, dir="kill", linger_after=INPUT["kill_after_step"])
        spec.update(package=package, out=os.path.join(root, "kill.json"),
                    ckpt=os.path.join(root, "kill"))
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--resilience-worker", json.dumps(spec)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        target = INPUT["kill_after_step"]
        deadline = time.monotonic() + RESIL["timeout"]
        try:
            while target not in ck.list_checkpoints(spec["ckpt"]):
                assert proc.poll() is None, "the run ended before its step-%d checkpoint" % target
                assert time.monotonic() < deadline, "no step-%d checkpoint" % target
                time.sleep(0.05)
            proc.kill()
            log_text = proc.communicate(timeout=60)[0]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        return {"name": "kill", "rc": proc.returncode, "wall_s": time.perf_counter() - t0,
                "log": log_text[-6000:]}

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        f_ref = pool.submit(_resil_run, root, package, "ref", dir="ref", **common)
        f_kill = pool.submit(killed)
        f_bad = pool.submit(_resil_run, root, package, "bad", dir="bad", k=1, rec=rec,
                            workers=1, fault="bad_record=%d" % INPUT["bad"], quarantine=qfile)
        ref, kill, bad = f_ref.result(), f_kill.result(), f_bad.result()
    again = _resil_run(root, package, "res", dir="kill", resume="auto", **common)
    workers_s = time.perf_counter() - t0
    _expect(ref, 0)
    _expect(kill, -9)
    _expect(again, 0)
    _expect(bad, 0)
    assert ref["finite"] and ref["steps_run"] == 16, ref["steps_run"]
    assert "resume: restored step" in again["log"], again["log"]
    resumed = again["first_step"] - 1
    state = ck.CheckpointManager(os.path.join(root, "kill")).load(step=resumed)
    pos = (int(state["epoch"]), int(state["nbatch"]), state["sample_position"])
    assert pos[1] > 0 and again["seek_sample"] == [pos[2]], (pos, again["seek_sample"])
    diff = _digest_diff(again["digests"], ref["digests"])
    assert not diff, "%d tensors differ after the resume, first %s" % (len(diff), diff[:5])
    assert again["metric"] == ref["metric"], (again["metric"], ref["metric"])
    with open(qfile) as fh:
        lines = [json.loads(l) for l in fh]
    assert len(lines) == INPUT["bad"] and all(l["type"] == "quarantine" for l in lines), lines
    assert bad["steps_run"] == 16 and bad["finite"], bad["steps_run"]
    return {"workers_s": workers_s, "resumed_from": {"epoch": pos[0], "nbatch": pos[1],
                                                     "sample_position": pos[2]},
            "resumed_at_step": resumed, "steps_run": again["steps_run"],
            "bitwise_equal_to_reference": len(ref["digests"]), "metric_equal": True,
            "seek_sample": again.get("seek_sample"),
            "launches_resumed_run": again["launches"],
            "bad_record": {"quarantine_lines": lines, "fit_finished": True,
                           "steps_run": bad["steps_run"]},
            "runs": {r["name"]: {k: r.get(k) for k in ("rc", "wall_s", "fit_s", "steps_run")}
                     for r in (ref, kill, again, bad)}}


def phase_input(mx, kernels, dev, package, measure=True):
    """Phase 24; see the module docstring. Without ``measure`` (the full
    script, to stay well inside its time limit) it leaves out (b), (d) and
    every fit of (c) but the fed one at K = 4 (held to the host stream's
    checksums), which ``--only input`` runs: the feed on / off pairs."""
    import shutil
    import tempfile

    import torch

    from mxnet_tpu_torch import native, recordio
    from mxnet_tpu_torch.resilience import fault

    res = {}
    t0 = time.perf_counter()
    lib = native.build()
    res["native_build_s"] = time.perf_counter() - t0
    assert native.available() and Path(native.get_lib()._name) == lib, "native library"
    res["native_library"] = str(lib)
    res["decode_libraries"] = decode_libraries()
    res["cpu_count"] = os.cpu_count()
    res["cpu_affinity"] = len(os.sched_getaffinity(0))
    log("phase 24 (a): native library %s built in %.2f s; decode: %s; %d CPUs (%d usable)"
        % (lib, res["native_build_s"], json.dumps(res["decode_libraries"]), res["cpu_count"],
           res["cpu_affinity"]))
    root = tempfile.mkdtemp(prefix="chip_smoke_input_")
    torch.backends.cudnn.deterministic = True
    try:
        paths, payloads, imgs, labels, enc_s, write_s = input_records(root, recordio)
        reader = native.NativeRecordReader(paths["input"])
        assert len(reader) == len(payloads)
        assert all(reader.read(i) == p for i, p in enumerate(payloads)), "native reader"
        reader.close()
        for i, img in enumerate(imgs):
            _hdr, png = recordio.unpack(payloads[i])
            got = native.imdecode_png(png)
            assert got is not None and np.array_equal(got, img), "PNG %d decode" % i
        res["a"] = {"records": len(payloads), "rec_bytes": os.path.getsize(paths["input"]),
                    "encode_s": enc_s, "write_s": write_s, "read_back_bitwise": True,
                    "png_decode_bitwise": len(imgs)}
        # fail_recordio_read: the sequential reader retries its first read
        plain = dict(shuffle=False, rand_crop=False, rand_mirror=False)
        os.environ[fault.ENV] = "fail_recordio_read=%d,unit=phase24" % INPUT["read_fail"]
        try:
            with mx.cpu():
                got = batch_checksum(batch_tensors(input_iter(mx, paths["input"], **plain).next()))
            raw = os.environ[fault.ENV]
            fired = fault._fired.get((raw, "fail_recordio_read"), 0)
        finally:
            os.environ.pop(fault.ENV)
        with mx.cpu():
            want = batch_checksum(batch_tensors(input_iter(mx, paths["input"], **plain).next()))
        assert fired == INPUT["read_fail"] and torch.equal(got, want), (fired, got, want)
        res["a"]["fail_recordio_read"] = {"injected": fired, "batch_equal": True}
        log("phase 24 (a): %s" % json.dumps(res["a"]))

        if measure:
            res["b"] = {"decode": decode_compare(payloads, recordio)}
            log("phase 24 (b): PNG decode on one thread: %s" % json.dumps(res["b"]["decode"]))
            rates = [input_rate(mx, paths["input"], threads=t) for t in INPUT["threads"]]
            rates.append(input_rate(mx, paths["input"], threads=max(INPUT["threads"]),
                                    decoder="pil"))
            rates += [input_rate(mx, paths["input"], workers=w) for w in INPUT["workers"]]
            res["b"].update(rates=rates, replayed_fit_img_per_s=REPLAYED_FIT_IMG_S)
            for r in rates:
                log("phase 24 (b): ImageRecordIter threads %d workers %d (%s PNG): %.1f img/s "
                    "over %d batches, blocks of 32 %s (first batch %.2f s); a replayed fit "
                    "step consumes %.1f img/s"
                    % (r["threads"], r["workers"], r["decoder"], r["img_per_s"], r["batches"],
                       ["%.1f" % x for x in r["block_img_per_s"]], r["first_batch_s"],
                       REPLAYED_FIT_IMG_S))

        from mxnet_tpu_torch import io_pipeline

        with mx.cpu():  # the fits' stream, decoded inline
            it = io_pipeline.StreamingImageRecordIter(
                RESNET_BATCH, INPUT["shape"], paths["input"], shuffle=True, seed=0, workers=0,
                aug_recipe={"rand_crop": True, "rand_mirror": True, "scale": 1.0,
                            "mean": np.array(INPUT["mean"])})
            host = [[int(v) for v in batch_checksum(batch_tensors(b)).tolist()] for b in it]
        fits, faults = {}, []  # every disagreement, reported together
        for k, feed, depth, delay in INPUT_FITS if measure else [(4, "1", None, False)]:
            name = "k%d_feed%s%s%s" % (k, feed, "_depth" + depth if depth else "",
                                       "_delayed" if delay else "")
            fits[name] = run = input_fit(mx, kernels, paths["input"], k, feed, depth, delay)
            log("phase 24 (c) %s: fit %.2f s, step %.2f ms (steps %d-%d; by 4 steps %s), idle "
                "%.3f, HtoD %.3f ms of which %.3f under kernels, launches %s"
                % (name, run["fit_s"], run["step_ms"], run["window_steps"][0],
                   run["window_steps"][1], ["%.1f" % x for x in run["step_ms_by_4"]],
                   run["window"]["idle_share"], run["window"]["htod_ms"],
                   run["window"]["htod_overlapped_ms"], json.dumps(run["launches"])))
            for what in ("received", "batches"):
                bad = [i + 1 for i, (a, b) in enumerate(zip(run[what], host)) if a != b]
                if bad or len(run[what]) != len(host):
                    faults.append("%s: the %s of steps %s differ from the host's"
                                  % (name, what, bad))
            if (run["staged_device"] == "cuda:0") != (feed == "1"):
                faults.append("%s staged on %s" % (name, run["staged_device"]))
            if feed == "1" and "k%d_feed0" % k in fits:
                off = fits["k%d_feed0" % k]
                diff = _digest_diff(run["digests"], off["digests"])
                if diff:
                    faults.append("%s: the feed changes %d tensors, first %s"
                                  % (name, len(diff), diff[:5]))
                bn = [i + 1 for i, (a, b) in enumerate(zip(run["bn_data"], off["bn_data"]))
                      if a != b]
                if bn:
                    faults.append("%s: bn_data's statistics differ after steps %s" % (name, bn))
        assert not faults, "; ".join(faults)
        res["c"] = {"fits": {n: {k: v for k, v in f.items()
                                 if k not in ("digests", "received", "batches", "bn_data")}
                             for n, f in fits.items()},
                    "steps_equal_host_run_before_and_after_the_step": len(host)}
        if "k1_feed0" in fits:
            res["c"].update(state_tensors_bitwise_equal_feed_on_off=len(
                fits["k1_feed0"]["digests"]), bn_data_equal_feed_on_off_every_step=True)
        launches = dict.fromkeys(MULTI_KERNEL_NAMES, 0)
        for f in fits.values():
            for n in launches:
                launches[n] += f["launches"][n]
        if measure:
            res["d"] = input_resilience(package, paths, root)
            for n in launches:
                launches[n] += res["d"]["launches_resumed_run"][n]
        res["launches"] = launches
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(root, ignore_errors=True)
    log("phase 24: input path: %s" % json.dumps(res))
    return res


# phase 25: the Module family and RNN on the card
RNN_OP = dict(T=60, N=32, I=200, H=200, layers=2, seed=25)
RNN_OP_CASES = (("lstm", False), ("gru", False), ("rnn_tanh", False), ("rnn_relu", False),
                ("lstm", True))
PTB = dict(layers=2, hidden=200, embed=200, vocab=10000, batch=32,
           buckets=(10, 20, 30, 40, 50, 60), lr=0.01, sentences=2048, seed=0, epochs=2, dp=4)
ATTN_LM = dict(vocab=10000, hidden=256, embed=256, heads=4, batch=16, T=1024, steps=4, lr=0.1)
FAMILY = dict(dim=64, classes=10, hidden=128, batch=32, batches=8, lr=0.1, sizes=(32, 16, 8),
              seed=7)


def _rel_err(got, want):
    """max|got - want| over max|want| (1 where want is all zeros)."""
    scale = max(float(want.abs().max()), 1e-30) if want.numel() else 1.0
    return float((got - want).abs().max()) / scale if want.numel() else 0.0


def rnn_op_case(mode, bidir, dev, cfg=RNN_OP):
    """Phase 25 (a), one case: the RNN operator (cuDNN) against its plain
    per-step loop: the output, the final states and the gradients of the
    data, the blob and the initial states, each to 1e-4 of max|plain|."""
    import warnings

    import torch

    from mxnet_tpu_torch.ops import registry, rnn_op

    op = registry.get("RNN")
    L, T, N, I, H = cfg["layers"], cfg["T"], cfg["N"], cfg["I"], cfg["H"]
    attrs = op.canon_attrs({"mode": mode, "num_layers": L, "state_size": H,
                            "bidirectional": bidir, "state_outputs": True})
    dirs = 2 if bidir else 1
    rng = np.random.default_rng(cfg["seed"])
    psize = rnn_op._rnn_param_size(L, I, H, bidir, mode)
    bound = 1.0 / np.sqrt(H)
    host = [rng.standard_normal((T, N, I)), rng.uniform(-bound, bound, psize),
            0.5 * rng.standard_normal((L * dirs, N, H))]
    if mode == "lstm":
        host.append(0.5 * rng.standard_normal((L * dirs, N, H)))
    ins = [torch.tensor(a, dtype=torch.float32, device=dev, requires_grad=True) for a in host]

    cot = []  # one random cotangent an output, the same for both runs

    def run(fn):
        outs = fn(attrs, ins, True)
        if not cot:
            cot.extend(torch.tensor(rng.standard_normal(o.shape), dtype=torch.float32,
                                    device=dev) for o in outs)
        return list(outs), list(torch.autograd.grad(outs, ins, cot))

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = run(op.fcompute)
    want = run(rnn_op.rnn_reference)
    names = (["output", "state", "state_cell"][:len(want[0])]
             + ["d_data", "d_parameters", "d_state", "d_state_cell"][:len(ins)])
    errs = {n: _rel_err(g, w) for n, g, w in zip(names, got[0] + got[1], want[0] + want[1])}
    bad = {n: e for n, e in errs.items() if not e <= 1e-4}
    assert not bad, ("RNN %s bidirectional=%s: kernel vs plain over 1e-4 of max" % (mode, bidir),
                     bad)
    # the weights are handed over in cuDNN's own layout: no compaction a call
    assert not caught, [str(w.message) for w in caught]
    return {"mode": mode, "bidirectional": bidir, "param_size": psize, "rel_err": errs,
            "cudnn_weight_warnings": len(caught),
            "ms": _median_ms(lambda: (run(op.fcompute), torch.cuda.synchronize()), 5),
            "plain_ms": _median_ms(lambda: (run(rnn_op.rnn_reference), torch.cuda.synchronize()),
                                   2)}


def ptb_iter(mx, sentences, cfg):
    """The LM's BucketSentenceIter, its batch order and row shuffles from
    ``cfg["seed"]``. The port's generators are seeded too: a generator
    made unseeded takes its seed from numpy's stream, which would move
    the next epoch's shuffle."""
    import random

    random.seed(cfg["seed"])
    np.random.seed(cfg["seed"])
    mx.random.seed(cfg["seed"])
    return mx.rnn.BucketSentenceIter(sentences, cfg["batch"], buckets=list(cfg["buckets"]))


def ptb_module(mx, cfg, stack, ctx):
    from mxnet_tpu_torch.examples import lstm_bucketing as lb

    cell = lb.make_cell(mx, cfg["hidden"], cfg["layers"], stack)
    sym_gen = lb.make_sym_gen(mx, cell, cfg["vocab"], cfg["embed"], cfg["hidden"])
    return mx.mod.BucketingModule(sym_gen, default_bucket_key=max(cfg["buckets"]),
                                  context=ctx), cell


def ptb_fit(mx, dev, cfg, sentences, stack, arg_params, kvstore, ctx, optimizer="adam",
            epochs=None):
    """Phase 25 (b), one fit: BucketingModule over the corpus from
    ``arg_params``; the first batch's loss before any update, ms a batch per
    bucket (each bucket's first batch left out), the perplexity after each
    epoch and the peak memory."""
    import torch

    it = ptb_iter(mx, sentences, cfg)
    mod, cell = ptb_module(mx, cfg, stack, ctx)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(initializer=None, arg_params=arg_params, aux_params={})
    batch0 = it.next()
    it.curr_idx = 0  # the fit starts from that batch
    mod.forward(batch0, is_train=False)
    prob = mod.get_outputs()[0]._data
    lab = batch0.label[0]._data.reshape(-1).long()
    keep = lab != 0
    loss0 = float(-prob[keep.nonzero()[:, 0], lab[keep]].log().mean())
    mod.switch_bucket(mod._default_bucket_key, None)  # the default bucket owns the optimizer
    rec = {"t": None, "seen": set(), "ms": {}, "ppl": [], "last": None, "snapshots": []}

    def on_batch(p):
        torch.cuda.synchronize(dev)
        now = time.perf_counter()
        key = p.locals["data_batch"].bucket_key
        if rec["t"] is not None and key in rec["seen"]:
            rec["ms"].setdefault(key, []).append((now - rec["t"]) * 1e3)
        rec["seen"].add(key)
        rec["t"] = now
        rec["last"] = p.eval_metric.get()[1]

    def on_epoch(epoch, symbol, arg, aux):
        rec["ppl"].append(rec["last"])
        rec["snapshots"].append({k: v.asnumpy() for k, v in arg.items()})
        rec["t"] = None  # the epoch's end is not a batch

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    epochs = epochs or cfg["epochs"]
    mod.fit(it, eval_metric=mx.metric.Perplexity(ignore_label=0), kvstore=kvstore,
            optimizer=optimizer, optimizer_params={"learning_rate": cfg["lr"]},
            num_epoch=epochs, batch_end_callback=on_batch, epoch_end_callback=on_epoch)
    torch.cuda.synchronize(dev)
    fit_s = time.perf_counter() - t0
    return mod, cell, {
        "route": "stack" if stack else "fused", "kvstore": kvstore, "optimizer": optimizer,
        "loss0": loss0, "perplexity": rec["ppl"], "fit_s": fit_s,
        "batches": len(it.idx) * epochs,
        "ms_by_bucket": {k: statistics.median(v) for k, v in sorted(rec["ms"].items())},
        "timed_by_bucket": {k: len(v) for k, v in sorted(rec["ms"].items())},
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "snapshots": rec["snapshots"]}


def ptb_steps(mx, cfg, sentences, arg_params, kvstore, ctx, steps):
    """The fused route's first ``steps`` Adam steps by hand (the fit's
    batches and order); the parameters after them."""
    it = ptb_iter(mx, sentences, cfg)
    mod, _ = ptb_module(mx, cfg, False, ctx)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(initializer=None, arg_params=arg_params, aux_params={})
    mod.init_optimizer(kvstore=kvstore, optimizer="adam",
                       optimizer_params={"learning_rate": cfg["lr"]})
    for _, batch in zip(range(steps), it):
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def rnn_checkpoint_round_trip(mx, mod, cell, root, name):
    """save_rnn_checkpoint then load_rnn_checkpoint: every parameter back
    bit for bit."""
    arg, aux = mod.get_params()
    prefix = os.path.join(root, name)
    mx.rnn.save_rnn_checkpoint(cell, prefix, 1, mod.symbol, arg, aux)
    _, arg2, _ = mx.rnn.load_rnn_checkpoint(cell, prefix, 1)
    assert sorted(arg2) == sorted(arg), (sorted(arg2), sorted(arg))
    for k, v in arg.items():
        assert np.array_equal(arg2[k].asnumpy(), v.asnumpy()), "checkpoint round trip: %s" % k
    return len(arg)


def phase_rnn_lm(mx, dev, cfg=PTB):
    """Phase 25 (b); see the module docstring."""
    import tempfile

    from mxnet_tpu_torch.examples import lstm_bucketing as lb

    sentences, _ = lb.synthetic_corpus(cfg["vocab"], cfg["sentences"], cfg["seed"])
    it = ptb_iter(mx, sentences, cfg)
    fused, fused_cell = ptb_module(mx, cfg, False, mx.gpu(0))
    fused.bind(it.provide_data, it.provide_label)
    np.random.seed(cfg["seed"])
    fused.init_params(mx.init.Xavier(factor_type="in", magnitude=2.34))
    init = {k: v.copy() for k, v in fused.get_params()[0].items()}
    stack_cell = lb.make_cell(mx, cfg["hidden"], cfg["layers"], True)
    # the same weights for the LSTMCell stack: the blob unpacked per gate,
    # packed per layer
    init_stack = stack_cell.pack_weights(fused_cell.unpack_weights(init))
    res, mods = {}, {}
    root = tempfile.mkdtemp(prefix="chip_smoke_rnn_")
    for route, stack, args in (("fused", False, init), ("stack", True, init_stack)):
        mod, cell, run = ptb_fit(mx, dev, cfg, sentences, stack, args, "local", mx.gpu(0))
        mods[route] = run.pop("snapshots")
        keys = sorted(mod._buckets)
        default = mod._buckets[mod._default_bucket_key]
        other = next(m for k, m in mod._buckets.items() if k != mod._default_bucket_key)
        assert other._arg_params is default._arg_params, "buckets do not share their params"
        run["bound_buckets"] = keys
        run["checkpoint_params_bitwise"] = rnn_checkpoint_round_trip(mx, mod, cell, root, route)
        assert run["perplexity"][-1] < run["perplexity"][0], (route, run["perplexity"])
        res[route] = run
        log("phase 25 (b) %s: loss0 %.6f, perplexity by epoch %s, fit %.2f s over %d batches, "
            "ms a batch by bucket %s, peak %.2f GiB" % (
                route, run["loss0"], ["%.3f" % p for p in run["perplexity"]], run["fit_s"],
                run["batches"], json.dumps({k: round(v, 3)
                                            for k, v in run["ms_by_bucket"].items()}),
                run["peak_gib"]))
    rel = abs(res["fused"]["loss0"] - res["stack"]["loss0"]) / abs(res["stack"]["loss0"])
    assert rel <= 1e-4, ("first-batch loss, fused vs stack", res["fused"]["loss0"],
                         res["stack"]["loss0"])
    res["loss0_rel_diff"] = rel
    # kvstore="device": each bucket on the fused path, the owner demoted to
    # the per-parameter update once the other buckets borrow its state. Its
    # Adam rounds the bias correction in f32, as the JAX package's traced
    # step does, where the executor path's Updater rounds it in f64 (1 -
    # 0.999 is 1.3e-5 off in f32), and Adam's normalised steps carry that
    # on: the divergence from the local run is recorded after each epoch,
    # and held to 1e-5 after the first batch. SGD's update is the same
    # arithmetic on both paths: the same batches under SGD hold the demoted
    # path to the local run at 1e-5 over an epoch.
    def device_fit(optimizer, epochs):
        mod, _, run = ptb_fit(mx, dev, cfg, sentences, False, init, "device",
                              [mx.gpu(0)] * cfg["dp"], optimizer, epochs)
        owner = mod._buckets[mod._default_bucket_key]
        assert owner._fused_trainer is not None and owner._fused_trainer.flat_mode is None, \
            "the device run's owner is not on the demoted fused path"
        assert all(m._fused_owner is owner for k, m in mod._buckets.items()
                   if k != mod._default_bucket_key)
        return run

    def rel_by_epoch(got, want):
        return [_params_err(g, w) for g, w in zip(got, want)]

    run = device_fit("adam", None)
    run["rel_err_vs_local_by_epoch"] = rel_by_epoch(run.pop("snapshots"), mods["fused"])
    run["rel_err_vs_local_first_batch"] = rel_by_epoch(
        [ptb_steps(mx, cfg, sentences, init, "device", [mx.gpu(0)] * cfg["dp"], 1)],
        [ptb_steps(mx, cfg, sentences, init, "local", mx.gpu(0), 1)])[0]
    assert run["perplexity"][-1] < run["perplexity"][0], run["perplexity"]
    res["device"] = run
    _, _, sgd_local = ptb_fit(mx, dev, cfg, sentences, False, init, "local", mx.gpu(0), "sgd",
                              1)
    sgd = device_fit("sgd", 1)
    sgd["rel_err_vs_local"] = rel_by_epoch(sgd.pop("snapshots"), sgd_local["snapshots"])[0]
    res["device_sgd"] = sgd
    log("phase 25 (b) fused, kvstore device (dp %d, owner demoted): Adam perplexity %s, params "
        "after each epoch %s of the local run's, after the first batch %.3g; SGD, one epoch: "
        "%.3g (limits 1e-5 relative)" % (
            cfg["dp"], ["%.3f" % p for p in run["perplexity"]],
            ["%.3g" % e for e in run["rel_err_vs_local_by_epoch"]],
            run["rel_err_vs_local_first_batch"], sgd["rel_err_vs_local"]))
    assert run["rel_err_vs_local_first_batch"] <= 1e-5, (
        "device vs local params after one Adam step", run["rel_err_vs_local_first_batch"])
    assert sgd["rel_err_vs_local"] <= 1e-5, ("device vs local params under SGD",
                                             sgd["rel_err_vs_local"])
    return res


def phase_attention_lm(kernels, dev, cfg=ATTN_LM):
    """Phase 25 (c): lstm_attention_lm at its published width, logits and
    gradients against the same model with the plain attention, then SGD
    steps with one launch of K4f, K4dq and K4dkv a step."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.models import common, lstm

    init_fn, apply_fn = lstm.lstm_attention_lm(cfg["vocab"], cfg["hidden"], cfg["embed"],
                                               cfg["heads"])
    params, _ = common.params_from_numpy(init_fn(0), {}, device=dev)
    for p in params.values():
        p.requires_grad_()
    names = sorted(params)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg["vocab"], (cfg["batch"], cfg["T"] + 1))).to(dev)
    inp, tgt = tokens[:, :-1], tokens[:, 1:]

    def loss_grads():
        logits = apply_fn(params, inp)
        loss = F.cross_entropy(logits.reshape(-1, cfg["vocab"]), tgt.reshape(-1))
        return logits.detach(), loss.detach(), torch.autograd.grad(loss, [params[n] for n in names])

    logits, loss, grads = loss_grads()
    dispatch = kernels.attention
    kernels.attention = lambda q, k, v, causal=False, scale=None, mesh=None: (
        kernels.reference_attention(q, k, v, causal=causal, scale=scale))
    try:
        ref_logits, ref_loss, ref_grads = loss_grads()
    finally:
        kernels.attention = dispatch
    assert logits.shape == (cfg["batch"], cfg["T"], cfg["vocab"])
    assert bool(torch.isfinite(logits).all())
    errs = {"logits": _rel_err(logits, ref_logits)}
    errs.update({"d_" + n: _rel_err(g, w) for n, g, w in zip(names, grads, ref_grads)})
    bad = {n: e for n, e in errs.items() if not e <= 1e-4}
    assert not bad, ("lstm_attention_lm kernel vs plain attention over 1e-4 of max", bad)
    del logits, ref_logits, grads, ref_grads
    zero_counts(kernels)
    step_ms, losses = [], []
    for _ in range(cfg["steps"]):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        _, step_loss, grads = loss_grads()
        with torch.no_grad():
            for n, g in zip(names, grads):
                params[n] -= cfg["lr"] * g
        torch.cuda.synchronize(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(step_loss))
    launches = read_counts(kernels)
    assert launches == dict.fromkeys(launches, cfg["steps"]), launches
    assert all(np.isfinite(losses)), losses
    res = {"rel_err": errs, "loss": float(loss), "plain_loss": float(ref_loss),
           "step_ms": step_ms, "step_losses": losses, "launches": launches,
           "split_launches": kernels.split_planes.launches,
           "launches_a_step": {k: v // cfg["steps"] for k, v in launches.items()},
           "shape": {"B": cfg["batch"], "T": cfg["T"], "H": cfg["heads"],
                     "D": cfg["hidden"] // cfg["heads"], "vocab": cfg["vocab"]}}
    log("phase 25 (c) lstm_attention_lm f32 B %d T %d: logits and gradients kernel vs plain "
        "within %.3g of max (limit 1e-4); SGD steps %s ms, losses %s, launches %s"
        % (cfg["batch"], cfg["T"], max(errs.values()), ["%.2f" % t for t in step_ms],
           ["%.4f" % x for x in losses], json.dumps(launches)))
    return res


def _family_data(cfg):
    rng = np.random.RandomState(cfg["seed"])
    n = cfg["batch"] * cfg["batches"]
    centers = rng.randn(cfg["classes"], cfg["dim"]).astype(np.float32)
    labels = rng.randint(0, cfg["classes"], n)
    X = (centers[labels] + 0.5 * rng.randn(n, cfg["dim"])).astype(np.float32)
    return X, labels.astype(np.float32)


def _scores(mx, cfg):
    net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=cfg["hidden"], name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    return mx.sym.FullyConnected(net, num_hidden=cfg["classes"], name="fc2")


def _params_err(got, want):
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    return max(float(np.abs(got[k] - v).max() / max(np.abs(v).max(), 1e-30))
               for k, v in want.items())


def _host_params(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def phase_module_family(mx, dev, cfg=FAMILY):
    """Phase 25 (d): FeedForward, SequentialModule (with a PythonLossModule)
    and MutableModule on gpu(0), each against the same run with Module, to
    1e-5 of each tensor's max."""
    X, y = _family_data(cfg)
    res = {}
    bs, lr = cfg["batch"], cfg["lr"]
    net = mx.sym.SoftmaxOutput(_scores(mx, cfg), name="softmax")
    # FeedForward.create, predict, score
    np.random.seed(0)
    ff = mx.model.FeedForward.create(net, X, y, ctx=mx.gpu(0), num_epoch=1, optimizer="sgd",
                                     initializer=mx.init.Xavier(), numpy_batch_size=bs,
                                     learning_rate=lr)
    ff_pred = ff.predict(X)
    ff_score = ff.score(mx.io.NDArrayIter(X, y, batch_size=bs))
    np.random.seed(0)
    train = mx.io.NDArrayIter(X, y, batch_size=bs, shuffle=True, last_batch_handle="roll_over")
    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.fit(train, optimizer="sgd", optimizer_params={"learning_rate": lr},
            initializer=mx.init.Xavier(), num_epoch=1, kvstore="local")
    pred = mod.predict(mx.io.NDArrayIter(X, y, batch_size=bs)).asnumpy()
    score = dict(mod.score(mx.io.NDArrayIter(X, y, batch_size=bs), "acc"))["accuracy"]
    want = _host_params(mod)
    res["feedforward"] = {
        "params_rel_err": _params_err({k: v.asnumpy() for k, v in ff.arg_params.items()}, want),
        "predict_rel_err": float(np.abs(ff_pred - pred).max() / np.abs(pred).max()),
        "score": ff_score[0], "module_score": score, "batches": cfg["batches"]}
    assert ff_pred.shape == pred.shape == (len(X), cfg["classes"])
    assert res["feedforward"]["params_rel_err"] <= 1e-5, res["feedforward"]
    assert res["feedforward"]["predict_rel_err"] <= 1e-5 and ff_score[0] == score, \
        res["feedforward"]
    init = {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in want.items()}
    shapes = ([("data", (bs, cfg["dim"]))], [("softmax_label", (bs,))])

    def batch(i, n=bs):
        lo = (i * bs) % len(X)
        return mx.io.DataBatch(data=[mx.nd.array(X[lo:lo + n])],
                               label=[mx.nd.array(y[lo:lo + n])])

    def train_steps(m, steps, sizes=(bs,), before=None):
        for i in range(steps):
            b = batch(i, sizes[i % len(sizes)])
            if before is not None:
                before(m, b)
            m.forward(b, is_train=True)
            m.backward()
            m.update()
        return m

    def start(m, *bind_shapes):
        m.bind(*(bind_shapes or shapes))
        m.init_params(initializer=None, arg_params=init, aux_params={})
        m.init_optimizer(optimizer="sgd", optimizer_params={"learning_rate": lr})
        return m

    # SequentialModule: the scores' Module, then a PythonLossModule whose
    # gradient is SoftmaxOutput's (softmax - onehot)
    def softmax_grad(scores, labels):
        return mx.nd.softmax(scores) - mx.nd.one_hot(labels, depth=cfg["classes"])

    seq = mx.mod.SequentialModule()
    seq.add(mx.mod.Module(_scores(mx, cfg), label_names=[], context=mx.gpu(0)))
    seq.add(mx.mod.PythonLossModule(grad_func=softmax_grad), take_labels=True,
            auto_wiring=True)
    train_steps(start(seq), cfg["batches"])
    ref = train_steps(start(mx.mod.Module(net, context=mx.gpu(0))), cfg["batches"])
    res["sequential"] = {"params_rel_err": _params_err(_host_params(seq), _host_params(ref)),
                         "steps": cfg["batches"]}
    assert res["sequential"]["params_rel_err"] <= 1e-5, res["sequential"]
    # MutableModule over batches of changing size, against Module.reshape
    sizes = cfg["sizes"]
    mm = mx.mod.MutableModule(net, ["data"], ["softmax_label"], context=mx.gpu(0),
                              max_data_shapes=shapes[0], max_label_shapes=shapes[1])
    train_steps(start(mm), cfg["batches"], sizes)

    def reshape(m, b):
        m.reshape([("data", b.data[0].shape)], [("softmax_label", b.label[0].shape)])

    ref = train_steps(start(mx.mod.Module(net, context=mx.gpu(0))), cfg["batches"], sizes,
                      before=reshape)
    res["mutable"] = {"params_rel_err": _params_err(_host_params(mm), _host_params(ref)),
                      "shape_modules": len(mm._shape_modules), "batch_sizes": list(sizes),
                      "steps": cfg["batches"]}
    assert res["mutable"]["shape_modules"] == len(sizes), res["mutable"]
    assert res["mutable"]["params_rel_err"] <= 1e-5, res["mutable"]
    log("phase 25 (d) FeedForward / SequentialModule / MutableModule vs Module on gpu(0): %s"
        % json.dumps(res))
    return res


def phase_rnn(mx, kernels, dev):
    """Phase 25; see the module docstring. Every part runs; the phase fails
    after them if any failed."""
    import traceback

    res = {"a": []}
    faults = []

    def part(name, fn, *args):
        try:
            return fn(*args)
        except Exception as e:  # reported with the others at the end of the phase
            faults.append("%s: %s: %s" % (name, type(e).__name__, e))
            log("phase 25 (%s) FAILED:\n%s" % (name, traceback.format_exc()))
            return None

    t0 = time.perf_counter()
    for mode, bidir in RNN_OP_CASES:
        row = part("a", rnn_op_case, mode, bidir, dev)
        if row is None:
            continue
        res["a"].append(row)
        log("phase 25 (a) RNN %s%s T %d N %d I %d H %d x%d layers f32: op (cuDNN) vs plain "
            "loop, worst %.3g of max (limit 1e-4); fwd+bwd %.3f ms (plain %.3f); cuDNN "
            "weight warnings %d" % (
                mode, " bidirectional" if bidir else "", RNN_OP["T"], RNN_OP["N"],
                RNN_OP["I"], RNN_OP["H"], RNN_OP["layers"],
                max(res["a"][-1]["rel_err"].values()), res["a"][-1]["ms"],
                res["a"][-1]["plain_ms"], res["a"][-1]["cudnn_weight_warnings"]))
    res["b"] = part("b", phase_rnn_lm, mx, dev)
    res["c"] = part("c", phase_attention_lm, kernels, dev)
    res["d"] = part("d", phase_module_family, mx, dev)
    res["phase_s"] = time.perf_counter() - t0
    log("phase 25: %.1f s" % res["phase_s"])
    assert not faults, "phase 25: " + "; ".join(faults)
    res["launches"] = res["c"]["launches"]
    return res


# phase 26: placement and memory mirroring in the Executor
MIRROR_LSTM = dict(layers=8, hidden=400, seq=35, batch=128, vocab=10000, cpu_layers=(3,),
                   adam_steps=3, lr=0.001, seed=0)  # (a): lstm_ptb.py's width
MIRROR_INCEPTION = dict(batch=128, side=299, steps=3, force_block="mixed_4")  # (b)
MIRROR_FIT = dict(batches=16, k=4)  # (c): ResNet-50 bf16 AMP, dp 4, one epoch
MIRROR_CURVE = (32, 64, 128)  # --only mirror: batches of the memory / ms curve
MIRROR_SAVES = ("mirror_pool", "mirror_pool_concat")  # --only mirror, at batch 128


def _grads_of(exe):
    return {n: g._data.detach().clone() for n, g in exe.grad_dict.items() if g is not None}


def _rel_max(got, want):
    """max|got - want| / max|want| of two tensors (on want's device)."""
    got = got.to(want.device).float()
    want = want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _ptb_batches(cfg, n):
    """``n`` batches of a cyclic corpus from ``cfg["seed"]`` (the example's
    recipe: each row counts up by 1 or 2 modulo the vocabulary)."""
    rng = np.random.RandomState(cfg["seed"])
    out = []
    for _ in range(n):
        seq = np.cumsum(rng.randint(1, 3, (cfg["batch"], cfg["seq"] + 1)), axis=1) % cfg["vocab"]
        out.append((seq[:, :-1].astype(np.float32), seq[:, 1:].astype(np.float32)))
    return out


def _ptb_loss(exe, label):
    import torch

    prob = exe.outputs[0]._data.float()
    lab = torch.as_tensor(label.reshape(-1), device=prob.device).long()
    return float(-torch.log(prob[torch.arange(lab.numel(), device=prob.device), lab]
                            + 1e-12).mean())


def mirror_placement(mx, cfg=MIRROR_LSTM, ctx=None, host=None):
    """Phase 26 (a): the model-parallel LSTM at lstm_ptb.py's width, layers
    ``cpu_layers`` on the host and the rest on the card, against the same
    model bound on the card alone: one step's loss and gradients, then
    ``adam_steps`` Adam steps on each (ms a step)."""
    import torch

    from mxnet_tpu_torch.examples import model_parallel_lstm as mpl

    ctx = ctx or mx.gpu(0)
    host = host or mx.cpu(0)
    net = mpl.build(cfg["seq"], cfg["vocab"], cfg["hidden"], cfg["layers"])
    plan = {"embed": ctx, "decode": ctx}
    for i in range(cfg["layers"]):
        plan["layer%d" % i] = host if i in cfg["cpu_layers"] else ctx
    shapes = dict(data=(cfg["batch"], cfg["seq"]), softmax_label=(cfg["batch"], cfg["seq"]))
    placed = net.simple_bind(ctx, group2ctx=plan, **shapes)
    plain = net.simple_bind(ctx, **shapes)
    segs = [(str(c), len(nodes)) for c, nodes in placed._placed.segments]
    assert [c for c, _ in segs] == [str(ctx), str(host), str(ctx)], segs
    np.random.seed(cfg["seed"])
    init = mx.init.Xavier()
    for name, arr in plain.arg_dict.items():
        if name not in ("data", "softmax_label"):
            init(name, arr)
            placed.arg_dict[name]._data.copy_(arr._data)
    on_host = [n for n, c in placed._arg_contexts.items() if c == host]
    assert on_host and all(placed.arg_dict[n]._data.device == host.torch_device
                           for n in on_host), on_host
    batches = _ptb_batches(cfg, 1 + cfg["adam_steps"])
    res = {"config": dict(cfg, cpu_layers=list(cfg["cpu_layers"])), "segments": segs,
           "args_on_host": len(on_host)}
    for exe in (placed, plain):
        exe.arg_dict["data"][:] = batches[0][0]
        exe.arg_dict["softmax_label"][:] = batches[0][1]
        exe.forward(is_train=True)
        exe.backward()
    res["boundary_copies"] = placed._placed.boundary_copies
    assert res["boundary_copies"] >= 2, res["boundary_copies"]
    assert all(placed.grad_dict[n]._data.device == host.torch_device for n in on_host)
    loss = {"placed": _ptb_loss(placed, batches[0][1]), "unplaced": _ptb_loss(plain, batches[0][1])}
    got, want = _grads_of(placed), _grads_of(plain)
    errs = {n: _rel_max(got[n], want[n]) for n in want}
    res.update(loss=loss, worst_grad=max(errs.items(), key=lambda kv: kv[1]),
               loss_rel=abs(loss["placed"] - loss["unplaced"]) / abs(loss["unplaced"]))
    assert res["loss_rel"] <= 1e-4 and res["worst_grad"][1] <= 1e-4, (loss, res["worst_grad"])
    steps = {}
    for tag, exe in (("placed", placed), ("unplaced", plain)):
        opt = mx.optimizer.create("adam", learning_rate=cfg["lr"],
                                  rescale_grad=1.0 / cfg["batch"])
        updater = mx.optimizer.get_updater(opt)
        names = [n for n in exe.arg_dict if n not in ("data", "softmax_label")]
        ms, losses = [], []
        for data, label in batches[1:]:
            if ctx.device_type == "gpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            exe.arg_dict["data"][:] = data
            exe.arg_dict["softmax_label"][:] = label
            exe.forward(is_train=True)
            exe.backward()
            for i, name in enumerate(names):
                updater(i, exe.grad_dict[name], exe.arg_dict[name])
            losses.append(_ptb_loss(exe, label))  # synchronises
            ms.append(1e3 * (time.perf_counter() - t0))
        steps[tag] = {"ms": ms, "ms_median": statistics.median(ms), "losses": losses}
    res["adam"] = steps
    rel = [abs(a - b) / abs(b) for a, b in zip(steps["placed"]["losses"],
                                               steps["unplaced"]["losses"])]
    res["adam_loss_rel_max"] = max(rel)
    assert max(rel) <= 1e-4, rel
    return res


def _profile_conv_counts(step):
    """One ``step()`` under torch.profiler: forward convolutions
    (``aten::cudnn_convolution`` host ops) and K2's and K3's device kernels
    by name."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    out = {"forward_convolutions": sum(e.name == "aten::cudnn_convolution" for e in events
                                       if e.device_type != cuda)}
    kernels = [e for e in events if e.device_type == cuda]
    # the card's busy ms (kernel durations summed) against the step's wall
    # ms under the profiler: what the host's launches leave idle
    out["device_busy_ms"] = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    out["wall_ms_profiled"] = 1e3 * wall
    names = [e.name for e in kernels]
    for n in ("conv_bwd_filter", "conv_bwd_input"):
        out[n] = sum(MULTI_KERNEL_NAMES[n] in name for name in names)
    return out


def _inception_run(mx, kernels, cfg, variant, symbol=None, steps=None, profile=True):
    """inception-v3 bound under ``variant`` (mirror_inception's), the same
    parameters and batch each time: gradients of the first step, whether a
    second is bit for bit the first, peak memory and ms of ``steps`` more
    (no update), and a profiled step's convolution counts."""
    import gc

    import torch

    from mxnet_tpu_torch.tools import mirror_inception as mi

    steps = cfg["steps"] if steps is None else steps
    mi.set_variant(variant)
    try:
        exe = mi.bind(mx, cfg["batch"], cfg["side"], symbol=symbol)
        zero_counts(kernels)
        mi.train_step(exe, update=False)
        torch.cuda.synchronize()
        first = _grads_of(exe)
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            mi.train_step(exe, update=False)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        res = {"variant": variant, "mirror": exe._mirror, "launches": conv_counts(kernels)}
        if steps:
            peak = torch.cuda.max_memory_allocated()
            res.update(peak_gib=peak / 2**30, step_added_gib=(peak - held) / 2**30,
                       held_gib=held / 2**30)
            again = _grads_of(exe)
            res["repeat_bitwise"] = all(torch.equal(again[n], first[n]) for n in first)
            ms = 1e3 * statistics.median(times)
            res.update(step_ms=ms, step_ms_all=[1e3 * t for t in times],
                       img_per_s=cfg["batch"] / ms * 1e3)
        if profile:
            res["profiled"] = _profile_conv_counts(lambda: mi.train_step(exe, update=False))
        return res, first
    finally:
        mi.set_variant("plain")
        exe = None
        gc.collect()
        torch.cuda.empty_cache()


def _force_mirrored_block(mx, block):
    """inception-v3 with ``__force_mirroring__`` on every node of ``block``."""
    from mxnet_tpu_torch.models import inception_v3

    graph = json.loads(inception_v3.get_symbol(num_classes=1000).tojson())
    marked = 0
    for node in graph["nodes"]:
        if node["op"] != "null" and re.search(r"(^|_)%s_" % block, node["name"]):
            node.setdefault("attr", {})["__force_mirroring__"] = "True"
            marked += 1
    return mx.sym.load_json(json.dumps(graph)), marked


def _compare_grads(got, want, bitwise):
    import torch

    if bitwise:
        return [n for n in want if not torch.equal(got[n], want[n])], None
    errs = {n: _rel_max(got[n], want[n]) for n in want}
    worst = max(errs.items(), key=lambda kv: kv[1])
    return [n for n, e in errs.items() if e > 1e-5], worst


def mirror_inception_check(mx, kernels, cfg=MIRROR_INCEPTION):
    """Phase 26 (b): inception-v3 f32 at batch 128 through the Executor,
    the mirror off and on and ``__force_mirroring__`` on one block, cuDNN
    deterministic: gradients bit for bit where two plain steps are (else
    within 1e-5 of max|off|), peak memory, step ms, img/s, and the same
    forward convolutions and K2/K3 launches with the mirror as without."""
    import torch

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        off, want = _inception_run(mx, kernels, cfg, "plain")
        on, got = _inception_run(mx, kernels, cfg, "mirror")
        bitwise = off["repeat_bitwise"]
        bad, worst = _compare_grads(got, want, bitwise)
        on["grads_bitwise_equal_off"] = bitwise and not bad
        on["worst_grad_vs_off"] = worst
        assert not bad, ("mirror", bad[:5], worst)
        del got
        counts = ("forward_convolutions", "conv_bwd_filter", "conv_bwd_input")
        assert all(on["profiled"][n] == off["profiled"][n] for n in counts), (
            on["profiled"], off["profiled"])
        assert on["launches"] == off["launches"], (on["launches"], off["launches"])
        symbol, marked = _force_mirrored_block(mx, cfg["force_block"])
        forced, fgot = _inception_run(mx, kernels, cfg, "plain", symbol=symbol, steps=0,
                                      profile=False)
        bad, worst = _compare_grads(fgot, want, bitwise)
        forced.update(block=cfg["force_block"], nodes_marked=marked,
                      grads_bitwise_equal_off=bitwise and not bad, worst_grad_vs_off=worst)
        assert marked and not bad, ("force_mirroring", marked, bad[:5], worst)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    res = {"config": cfg, "off": off, "on": on, "forced": forced,
           "peak_ratio": on["peak_gib"] / off["peak_gib"],
           "step_added_ratio": on["step_added_gib"] / off["step_added_gib"],
           "step_ms_ratio": on["step_ms"] / off["step_ms"]}
    res["launches"] = {n: off["launches"][n] + on["launches"][n] + forced["launches"][n]
                       for n in off["launches"]}
    return res


def mirror_dropout_groups(mx, dev):
    """Phase 26 (c): a Dropout MLP's trainer, three groups of two steps from
    one state (warm-up, capture + replay, replay), with the mirror and
    without: the parameters after each group bit for bit."""
    import torch

    rng = np.random.RandomState(5)
    batches = {"data": [torch.from_numpy(rng.randn(32, 100).astype(np.float32)).to(dev)
                        for _ in range(2)],
               "softmax_label": [torch.from_numpy(rng.randint(0, 10, 32).astype(np.float32))
                                 .to(dev) for _ in range(2)]}
    runs = {}
    for mirror in (False, True):
        _mirror_env(mirror)
        try:
            net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=64, name="fc1")
            net = mx.sym.Dropout(mx.sym.Activation(net, act_type="relu"), p=0.3)
            net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(net, num_hidden=10, name="fc2"),
                                       name="softmax")
            opt = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                                      rescale_grad=1 / 32)
            tr = mx.parallel.ShardedTrainStep(
                net, mx.parallel.make_mesh(dp=4, devices=[mx.gpu(0)] * 4),
                optimizer=opt).compile()
        finally:
            _mirror_env(False)
        assert tr.mirror == mirror
        arg_shapes, _, _ = net.infer_shape(data=(32, 100), softmax_label=(32,))
        np.random.seed(0)
        state = tr.init(dict(zip(net.list_arguments(), arg_shapes)), mx.init.Xavier())
        mx.random.seed(11)
        outs = []
        for _ in range(3):
            state = tr.call_multi(*state, batches, [0.1, 0.1], [1, 2])[:3]
            outs.append({n: v.clone() for n, v in state[0].items()})
        torch.cuda.synchronize(dev)
        (g,) = tr.group_stats()
        assert (g["warmup_groups"], g["captures"], g["replays"]) == (1, 1, 2), g
        runs[mirror] = outs
    diff = [(i, n) for i, (a, b) in enumerate(zip(runs[False], runs[True]))
            for n in a if not torch.equal(a[n], b[n])]
    assert not diff, diff[:5]
    return {"groups": 3, "tensors": len(runs[True][0]), "bitwise_equal_unmirrored": True}


def _mirror_env(on):
    if on:
        os.environ["MXNET_BACKWARD_DO_MIRROR"] = "1"
    else:
        os.environ.pop("MXNET_BACKWARD_DO_MIRROR", None)


def mirror_fit(mx, kernels, dev, cfg=MIRROR_FIT, grouped=True):
    """Phase 26 (c): ResNet-50 bf16 AMP ``Module.fit`` on the dp 4 mesh
    (phase 21's leg, one epoch of ``batches``) unmirrored and mirrored,
    eagerly and (``grouped``) at ``MXNET_FIT_MULTISTEP=k`` (profiled): every
    state tensor of a replayed fit bit for bit its eager fit's, the
    mirrored fits the unmirrored ones'; then the Dropout groups."""
    import torch

    rng = np.random.RandomState(26)
    n = cfg["batches"] * RESNET_BATCH
    X = rng.rand(n, 3, 224, 224).astype(np.float32)
    y = rng.randint(0, 1000, n).astype(np.float32)
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    legs, states = {}, {}
    try:
        for tag, mirror, k in (("off", False, 1), ("on", True, 1),
                               ("off_k%d" % cfg["k"], False, cfg["k"]),
                               ("on_k%d" % cfg["k"], True, cfg["k"]))[:4 if grouped else 2]:
            _mirror_env(mirror)
            try:
                mod, leg, state, _ = multistep_leg(mx, kernels, dev, X, y, k, True, 1,
                                                   profile=k > 1)
            finally:
                _mirror_env(False)
            assert mod._fused_trainer.mirror == mirror
            leg.pop("losses")
            legs[tag], states[tag] = leg, state
            del mod
            torch.cuda.empty_cache()
        diff = state_diff(states["on"], states["off"])
        assert not diff, ("mirrored vs unmirrored", len(diff), diff[:5])
        if grouped:
            diff = state_diff(states["on_k%d" % cfg["k"]], states["on"])
            assert not diff, ("replayed vs eager mirrored", len(diff), diff[:5])
            diff = state_diff(states["off_k%d" % cfg["k"]], states["off"])
            assert not diff, ("replayed vs eager unmirrored", len(diff), diff[:5])
        legs["dropout"] = mirror_dropout_groups(mx, dev)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    fits = [t for t in legs if t != "dropout"]
    launches = dict.fromkeys(MULTI_KERNEL_NAMES, 0)
    for tag in fits:
        for name, c in legs[tag].get("launches_run", legs[tag]["launches"]).items():
            launches[name] += c
    return {"config": cfg, "legs": legs, "tensors_bitwise": len(states["on"]),
            "peak_gib": {t: legs[t]["peak_mem_gib"] for t in fits},
            "step_ms": {t: legs[t]["step_ms_median"] for t in fits}, "launches": launches}


def mirror_sweep(mx):
    """``--only mirror``: mirror_inception's rows, plain and mirror at each
    batch of MIRROR_CURVE, and the larger saved sets at batch 128."""
    from mxnet_tpu_torch.tools import mirror_inception as mi

    rows = [mi.measure(mx, b, v) for b in MIRROR_CURVE for v in ("plain", "mirror")]
    rows += [mi.measure(mx, MIRROR_INCEPTION["batch"], v) for v in MIRROR_SAVES]
    for row in rows:
        log("phase 26 sweep: %s" % json.dumps(row))
    return rows


def phase_mirror(mx, kernels, dev, full=False):
    """Phase 26; see the module docstring. Every part runs; the phase fails
    after them if any failed. ``full`` (``--only mirror``) adds (c)'s
    grouped legs and the sweep."""
    import traceback

    faults = []

    def part(name, fn, *args):
        try:
            return fn(*args)
        except Exception as e:  # reported with the others at the end of the phase
            faults.append("%s: %s: %s" % (name, type(e).__name__, e))
            log("phase 26 (%s) FAILED:\n%s" % (name, traceback.format_exc()))
            return None

    t0 = time.perf_counter()
    res = {}
    res["a"] = part("a", mirror_placement, mx)
    res["a_s"] = time.perf_counter() - t0
    res["b"] = part("b", mirror_inception_check, mx, kernels)
    res["b_s"] = time.perf_counter() - t0 - res["a_s"]
    res["c"] = part("c", mirror_fit, mx, kernels, dev, MIRROR_FIT, full)
    res["phase_s"] = time.perf_counter() - t0
    if full:
        res["sweep"] = part("sweep", mirror_sweep, mx)
    for key in ("a", "b", "c"):
        log("phase 26 (%s): %s" % (key, json.dumps(res[key], default=str)))
    log("phase 26: %.1f s (a %.1f, b %.1f)" % (res["phase_s"], res["a_s"], res["b_s"]))
    assert not faults, "phase 26: " + "; ".join(faults)
    res["launches"] = {n: res["b"]["launches"].get(n, 0) + res["c"]["launches"][n]
                       for n in MULTI_KERNEL_NAMES}
    return res


# phase 27: ring attention, Switch-MoE and the GPipe pipeline on logical ranks of one card
RING = dict(B=4, T=2048, H=16, D=64, sps=(2, 4), seed=27)
RING_TOL = {"bfloat16": 2e-2, "float32": 1e-4}  # of max|reference|, the card's K4 limits
RING_TIME_SLEEP = 40_000_000  # a ~20 ms sleep queued first: longer than a ring call's enqueue
PAR_LM = dict(FULL, seq_len=2048, batch_size=4, steps=10, lr=3e-2, moe_experts=8)
PAR_LM_DENSE_STEPS = 5  # the dense model's steps at the same batch, for its ms a step
PAR_LOSS_RTOL = 1e-4  # step 0's loss, sp 4 against sp 1 (see the module docstring)
PAR_SP, PAR_EP = 4, 4
PIPE = dict(stages=4, d=1024, micro=8, mb=64, seed=27)


_LM_TREES = {}  # phase 27: (configuration, seed) -> the numpy tree init_fn drew


def memo_lm(transformer_lm):
    """``transformer_lm`` whose ``init_fn`` keeps each tree it draws by
    configuration and seed, so phase 27's runs of one configuration share
    one draw: the JAX package's numpy draws of the full MoE model take ~20 s
    of the card machine's host. ``params_from_jax`` copies the tree."""
    def lm(**cfg):
        init_fn, apply_fn = transformer_lm(**cfg)
        key = tuple(cfg.get(k, d) for k, d in (("vocab", 32000), ("d_model", 512),
                                                ("n_heads", 8), ("n_layers", 4),
                                                ("d_ff", 2048), ("moe_experts", 0),
                                                ("moe_every", 2)))

        def init(seed=0):
            if (key, seed) not in _LM_TREES:
                _LM_TREES[key, seed] = init_fn(seed)
            return _LM_TREES[key, seed]
        return init, apply_fn
    return lm


def _block_rel_errs(got, want, blocks):
    """For each of ``blocks`` equal blocks along T (dim 1), the block's
    max|got - want| over its own max|want|."""
    return [_rel_err(g, w) for g, w in zip(got.chunk(blocks, 1), want.chunk(blocks, 1))]


def ring_pairs(sp, causal):
    return sp * (sp + 1) // 2 if causal else sp * sp


def _ring_inputs(dev, dtype, rng):
    import torch

    shape = (RING["B"], RING["T"], RING["H"], RING["D"])
    q, k, v, cot = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                    .to(dev, getattr(torch, dtype)) for _ in range(4))
    return q.requires_grad_(), k.requires_grad_(), v.requires_grad_(), cot


def ring_case(kernels, ring, dev, dtype, sp, causal, rng, flush):
    """Phase 27 (a): one ring call at RING's shape against the unsharded
    kernel and the plain attention, forward and gradients."""
    import torch

    q, k, v, cot = _ring_inputs(dev, dtype, rng)

    def fwd_bwd(fn):
        out = fn(q, k, v)
        return [out.detach()] + list(torch.autograd.grad(out, (q, k, v), cot))

    ring_fn = lambda q, k, v: ring.ring_attention(q, k, v, sp, causal=causal)  # noqa: E731
    zero_counts(kernels)
    kernels.check_kernel_args.clones = 0
    got = fwd_bwd(ring_fn)
    torch.cuda.synchronize()
    counts, clones = read_counts(kernels), kernels.check_kernel_args.clones
    split = kernels.split_planes.launches
    pairs = ring_pairs(sp, causal)
    assert counts == dict.fromkeys(counts, pairs), (
        "a wrapper did not launch its kernel on every live pair", counts, pairs)
    unsharded = fwd_bwd(lambda q, k, v: kernels.flash_attention(q, k, v, causal=causal))
    plain = fwd_bwd(lambda q, k, v: kernels.reference_attention(q, k, v, causal=causal))
    names = ("out", "dq", "dk", "dv")
    by_block = {against: {n: _block_rel_errs(a.float(), b.float(), sp)
                          for n, a, b in zip(names, x, y)}
                for against, x, y in (("ring_vs_kernel", got, unsharded),
                                      ("kernel_vs_plain", unsharded, plain))}
    err_plain = {n: _rel_err(a.float(), b.float()) for n, a, b in zip(names, got, plain)}
    abs_kernel = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, unsharded))
    del got, unsharded, plain
    row = {"dtype": dtype, "sp": sp, "causal": causal, "launches_a_call": counts,
           "pairs": pairs, "tma_clones": clones, "split_launches": split,
           "rel_err_by_block": by_block, "rel_err_vs_plain": err_plain,
           "max_abs_err_vs_kernel": abs_kernel}
    log("phase 27 (a) ring %s %s sp %d: errors by block %s, ring vs plain %s" % (
        dtype, "causal" if causal else "full", sp, json.dumps(by_block), json.dumps(err_plain)))
    tol = RING_TOL[dtype]
    bad = {n: max(e) for n, e in by_block["ring_vs_kernel"].items() if not max(e) <= tol}
    bad.update({"%s vs plain" % n: e for n, e in err_plain.items() if not e <= tol})
    assert not bad, ("ring vs unsharded kernel over %g of a block's max, or vs plain of max"
                     % tol, bad)
    row["ms"] = time_ms(lambda: fwd_bwd(ring_fn), 5, 2, flush)
    row["device_ms"] = device_ms(lambda: fwd_bwd(ring_fn), 5, 1, flush,
                                 sleep_cycles=RING_TIME_SLEEP)
    return row


def ring_sp1_ms(kernels, dev, dtype, causal, rng, flush):
    """fwd + bwd ms of the unsharded kernel (sp 1) at RING's shape."""
    import torch

    q, k, v, cot = _ring_inputs(dev, dtype, rng)

    def fwd_bwd():
        out = kernels.flash_attention(q, k, v, causal=causal)
        return torch.autograd.grad(out, (q, k, v), cot)

    return {"ms": time_ms(fwd_bwd, 5, 2, flush),
            "device_ms": device_ms(fwd_bwd, 5, 1, flush, sleep_cycles=RING_TIME_SLEEP)}


def parallel_ring(kernels, dev, dtypes):
    import torch

    import mxnet_tpu_torch.parallel  # noqa: F401

    ring = sys.modules["mxnet_tpu_torch.parallel.ring_attention"]
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(RING["seed"])
    rows = []
    for dtype in dtypes:
        for causal in (True, False):
            rows.append({"dtype": dtype, "sp": 1, "causal": causal,
                         **ring_sp1_ms(kernels, dev, dtype, causal, rng, flush)})
            for sp in RING["sps"]:
                rows.append(ring_case(kernels, ring, dev, dtype, sp, causal, rng, flush))
            for r in rows[-3:]:
                log("phase 27 (a) ring %s %s sp %d B %d T %d H %d D %d: %s" % (
                    dtype, "causal" if causal else "full", r["sp"], RING["B"], RING["T"],
                    RING["H"], RING["D"], json.dumps(r)))
    return rows


def parallel_lm_run(trainer, kernels, dev, sp, ep, moe_experts, steps):
    """One trainer run of PAR_LM's shape: per-step launches, step ms (the
    median of the steps after the first), tokens/s, peak memory."""
    import torch

    stamps, per_step = [], []

    def on_step(i, loss, params):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        per_step.append(read_counts(kernels))

    cfg = dict(PAR_LM, steps=steps, moe_experts=moe_experts)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(kernels)  # counts from here are this run's
    t0 = time.perf_counter()
    losses = trainer.train(dtype="bfloat16", device=dev, sp=sp, ep=ep, on_step=on_step,
                           log=lambda *a: log("  train:", *a), **cfg)
    wall = time.perf_counter() - t0
    counts = read_counts(kernels)
    a_step = FULL["n_layers"] * ring_pairs(sp, True)
    prev = dict.fromkeys(counts, 0)
    for i, c in enumerate(per_step):
        for name, n in c.items():
            assert n - prev[name] == a_step, (sp, i, name, n - prev[name], a_step)
        prev = c
    assert len(losses) == steps and all(np.isfinite(losses)), losses
    res = {"sp": sp, "ep": ep, "moe_experts": moe_experts, "losses": losses, "wall_s": wall,
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "launches": counts, "launches_a_step": a_step}
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    if step_s:
        med = statistics.median(step_s)
        res.update(step_ms_median=1e3 * med, step_ms=[1e3 * s for s in step_s],
                   tokens_per_s=cfg["batch_size"] * cfg["seq_len"] / med)
    return res


def parallel_lm(trainer, kernels, dev, full=False):
    """Phase 27 (b): the MoE LM at full width, sp 4 / ep 4 (the main path)
    against sp 1 / ep 1 (one step; all of them, and the dense model's steps
    at the same batch, with ``full``)."""
    lm = trainer.transformer_lm
    trainer.transformer_lm = memo_lm(lm)
    try:
        runs = {"sp4": parallel_lm_run(trainer, kernels, dev, PAR_SP, PAR_EP,
                                       PAR_LM["moe_experts"], PAR_LM["steps"])}
        runs["sp1"] = parallel_lm_run(trainer, kernels, dev, 1, 1, PAR_LM["moe_experts"],
                                      PAR_LM["steps"] if full else 1)
        if full:
            runs["dense_sp1"] = parallel_lm_run(trainer, kernels, dev, 1, 1, 0,
                                                PAR_LM_DENSE_STEPS)
    finally:
        trainer.transformer_lm = lm
    for key, r in runs.items():
        log("phase 27 (b) %s LM bf16 B %d T %d%s: %s" % (
            "MoE" if r["moe_experts"] else "dense", PAR_LM["batch_size"], PAR_LM["seq_len"],
            " E %d sp %d ep %d" % (r["moe_experts"], r["sp"], r["ep"]) if r["moe_experts"]
            else "", json.dumps({k: v for k, v in r.items() if k != "step_ms"})))
    l4, l1 = runs["sp4"]["losses"][0], runs["sp1"]["losses"][0]
    rel = abs(l4 - l1) / abs(l1)
    log("phase 27 (b) step 0 loss sp 4 %.6f vs sp 1 %.6f: rel %.3g (limit %g)"
        % (l4, l1, rel, PAR_LOSS_RTOL))
    for key in ("sp4", "sp1"):
        losses = runs[key]["losses"]
        assert len(losses) == 1 or losses[-1] < losses[0], (key, losses)
    assert rel <= PAR_LOSS_RTOL, ("step 0's loss, sp 4 vs sp 1", l4, l1, rel)
    return {"runs": runs, "step0_rel_diff": rel, "launches": runs["sp4"]["launches"]}


def parallel_prefill(mx, tfm, kernels, GenerationEngine, dev):
    """Phase 27 (c): sp 4 prefill at full width against sp 1, directly and
    through GenerationEngine."""
    import torch

    from mxnet_tpu_torch.serving import buckets

    bf16 = torch.bfloat16
    init_fn, _ = memo_lm(tfm.transformer_lm)(dtype=bf16, **FULL)
    params = tfm.params_from_jax(init_fn(0), device=dev, dtype=bf16)
    init_cache, prefill, decode_step = tfm.transformer_lm_serving(
        max_len=MAX_LEN, dtype=bf16, **FULL)
    mesh = mx.parallel.make_mesh(sp=PAR_SP, devices=[mx.gpu(0)] * PAR_SP)
    ladder = buckets.bucket_ladder(MAX_LEN, base=8)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, FULL["vocab"], n) for n in PROMPT_LENGTHS]
    a_dispatch = FULL["n_layers"] * ring_pairs(PAR_SP, True)
    cache = init_cache(2, device=dev)
    errs = {}
    for p in prompts:
        t = buckets.covering_value(ladder, len(p))
        toks = np.zeros((1, t), np.int64)
        toks[0, :len(p)] = p
        args = (torch.from_numpy(toks), torch.tensor([0]), torch.tensor([len(p)]))
        zero_counts(kernels)
        _, ring_last = prefill(params, cache, *args, mesh=mesh)
        n_ring = kernels.flash_attention.launches
        _, last = prefill(params, cache, *args)
        assert n_ring == a_dispatch, (len(p), n_ring, a_dispatch)
        assert bool(torch.isfinite(ring_last).all())
        errs[len(p)] = _rel_err(ring_last.float(), last.float())
    worst = max(errs.values())
    assert worst <= 2e-2, ("sp 4 prefill's last logits vs sp 1 over 2e-2 of max", errs)

    dispatches = [0]

    def counted(*args, **kwargs):
        dispatches[0] += 1
        return prefill(*args, **kwargs)

    outs, engine = {}, {}
    for key, m in (("sp4", mesh), ("sp1", None)):
        gen = GenerationEngine(params, (init_cache, counted, decode_step), slots=SLOTS,
                               max_len=MAX_LEN, mesh=m, device=dev)
        gen.compile(prompt_lengths=PROMPT_LENGTHS)
        zero_counts(kernels)  # counts from here are the engine's run
        dispatches[0] = 0
        t0 = time.perf_counter()
        reqs = [gen.submit(p, max_new=MAX_NEW) for p in prompts]
        for _ in range(len(prompts) * MAX_NEW + 8):  # the engine's loop, driven in order
            if all(r.done.is_set() for r in reqs):
                break
            gen.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        outs[key] = [r.result(0) for r in reqs]
        engine[key] = {"wall_s": wall, "prefill_dispatches": dispatches[0],
                       "flash_launches": kernels.flash_attention.launches}
        assert all(len(o) == MAX_NEW for o in outs[key])
    n_disp = engine["sp4"]["prefill_dispatches"]
    assert engine["sp4"]["flash_launches"] == n_disp * a_dispatch, engine
    same = sum(a == b for o4, o1 in zip(outs["sp4"], outs["sp1"]) for a, b in zip(o4, o1))
    whole = sum(o4 == o1 for o4, o1 in zip(outs["sp4"], outs["sp1"]))
    res = {"rel_err_by_length": errs, "worst_rel_err": worst, "launches_a_dispatch": a_dispatch,
           "engine": engine, "tokens_equal": same, "tokens": len(prompts) * MAX_NEW,
           "requests_equal": whole, "requests": len(prompts),
           "launches": engine["sp4"]["flash_launches"]}
    log("phase 27 (c) sp %d prefill bf16 full width, %d prompts (lengths %s): last logits vs "
        "sp 1 worst %.3g of max (limit 2e-2); engine: %s" % (
            PAR_SP, len(prompts), list(PROMPT_LENGTHS), worst, json.dumps(
                {k: v for k, v in res.items() if k != "rel_err_by_length"})))
    return res


def parallel_small(mx, dev):
    """Phase 27 (d): SwitchMoE through Module.fit on the card, and the GPipe
    pipeline against the sequential loop."""
    import torch

    from mxnet_tpu_torch.parallel.pipeline import pipelined_loss

    E, D, H = 4, 16, 32
    t0 = time.perf_counter()
    with mx.gpu(0):
        data = mx.sym.Variable("data")
        moe = mx.contrib.symbol.SwitchMoE(
            data, mx.sym.Variable("gate_weight"), mx.sym.Variable("up_weight"),
            mx.sym.Variable("down_weight"), num_experts=E, num_hidden=H, capacity_factor=2.0,
            name="moe")
        fc = mx.sym.FullyConnected(moe[0], num_hidden=2, name="fc")
        net = mx.sym.SoftmaxOutput(fc, name="softmax")
        r = np.random.RandomState(0)
        X = r.randn(128, D).astype(np.float32)
        yl = (X[:, 0] > 0).astype(np.float32)
        it = mx.io.NDArrayIter(X, yl, batch_size=32)
        np.random.seed(0)
        mod = mx.mod.Module(net, context=mx.gpu(0))
        mod.fit(it, num_epoch=20, optimizer="sgd", initializer=mx.init.Uniform(0.3),
                optimizer_params={"learning_rate": 0.5})
        acc = dict(mod.score(it, mx.metric.Accuracy()))["accuracy"]
        where = str(mod.get_outputs()[0].context)
    fit_s = time.perf_counter() - t0
    assert acc > 0.9, acc
    assert where.startswith("gpu"), where

    s, d = PIPE["stages"], PIPE["d"]
    rng = np.random.RandomState(PIPE["seed"])
    host = {"w": (rng.randn(s, d, d) / np.sqrt(d)).astype(np.float32),
            "b": (rng.randn(s, d) * 0.1).astype(np.float32)}
    x = torch.from_numpy(rng.randn(PIPE["micro"], PIPE["mb"], d).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randn(PIPE["micro"], PIPE["mb"], d).astype(np.float32)).to(dev)

    def stage_fn(p, act):
        return torch.relu(act @ p["w"] + p["b"])

    def loss_fn(outs, tgt):
        return torch.mean((outs - tgt) ** 2)

    def params():
        return {k: torch.from_numpy(v).to(dev).requires_grad_() for k, v in host.items()}

    pp = params()
    t1 = time.perf_counter()
    mesh = mx.parallel.make_mesh(dp=1, pp=s, devices=[mx.gpu(0)] * s)
    loss = pipelined_loss(stage_fn, loss_fn, mesh)(pp, x, y)
    loss.backward()
    torch.cuda.synchronize()
    pipe_ms = (time.perf_counter() - t1) * 1e3
    sq = params()
    act = x
    for i in range(s):
        act = stage_fn({"w": sq["w"][i], "b": sq["b"][i]}, act)
    ref = loss_fn(act, y)
    ref.backward()
    loss_rel = abs(loss.item() - ref.item()) / abs(ref.item())
    grad_err = {k: _rel_err(pp[k].grad, sq[k].grad) for k in host}
    res = {"switch_moe_fit_accuracy": acc, "switch_moe_fit_s": fit_s, "switch_moe_ctx": where,
           "pipeline_loss": loss.item(), "sequential_loss": ref.item(),
           "pipeline_loss_rel_diff": loss_rel, "pipeline_grad_rel_err": grad_err,
           "pipeline_fwd_bwd_ms_first_call": pipe_ms}
    log("phase 27 (d): %s" % json.dumps(res))
    assert loss_rel <= 1e-5, (loss.item(), ref.item())
    assert all(e <= 1e-4 for e in grad_err.values()), grad_err
    return res


def phase_parallel(mx, tfm, trainer, kernels, GenerationEngine, dev, full=False):
    """Phase 27; see the module docstring. Every part runs; the phase fails
    after them if any failed. ``full`` (``--only parallel``) adds (a)'s f32
    sweep and (b)'s whole sp 1 and dense runs."""
    import traceback

    faults = []

    def part(name, fn, *args):
        try:
            return fn(*args)
        except Exception as e:  # reported with the others at the end of the phase
            faults.append("%s: %s: %s" % (name, type(e).__name__, e))
            log("phase 27 (%s) FAILED:\n%s" % (name, traceback.format_exc()))
            return None

    t0 = time.perf_counter()
    res, times = {}, {}
    dtypes = ("bfloat16", "float32") if full else ("bfloat16",)
    for key, fn, args in (("a", parallel_ring, (kernels, dev, dtypes)),
                          ("b", parallel_lm, (trainer, kernels, dev, full)),
                          ("c", parallel_prefill, (mx, tfm, kernels, GenerationEngine, dev)),
                          ("d", parallel_small, (mx, dev))):
        t = time.perf_counter()
        res[key] = part(key, fn, *args)
        times[key] = time.perf_counter() - t
    _LM_TREES.clear()
    res["phase_s"] = time.perf_counter() - t0
    res["part_s"] = times
    log("phase 27: %.1f s (%s)" % (res["phase_s"], ", ".join(
        "%s %.1f" % kv for kv in times.items())))
    assert not faults, "phase 27: " + "; ".join(faults)
    launches = dict(res["b"]["launches"])
    launches["flash_attn_fwd"] += res["c"]["launches"]
    res["launches"] = launches
    return res


# phase 28: telemetry, the step anatomy, the profiler, Monitor and the
# perf tools over phase 21's ResNet-50 bf16 AMP fit on the dp 4 mesh
TELE = dict(distinct=8, batches=64, interval=8, k_max=8, cost_batches=32, monitor_batches=2,
            requests=8)
TELE_KERNELS = {"conv_bwd_filter": "K2", "conv_bwd_input": "K3", "slab_update": "K1"}


def _tele_env(**env):
    """Set (value) or clear (None) environment variables; returns the old
    values for :func:`_tele_env` to put back."""
    old = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    return old


def _tele_data(cfg=TELE):
    """``cfg["batches"]`` ResNet-50 batches cycled from ``distinct`` random
    ones (host numpy, as phase 21's)."""
    rng = np.random.RandomState(28)
    n = cfg["distinct"] * RESNET_BATCH
    X = rng.rand(n, 3, 224, 224).astype(np.float32)
    y = rng.randint(0, 1000, n).astype(np.float32)
    reps = cfg["batches"] // cfg["distinct"]
    return np.concatenate([X] * reps), np.concatenate([y] * reps)


def _tele_module(mx):
    from mxnet_tpu_torch.models import resnet

    np.random.seed(0)
    return mx.mod.Module(resnet.get_symbol(), context=mx.gpu(0),
                         mesh=mx.parallel.make_mesh(dp=4, devices=[mx.gpu(0)] * 4))


def _tele_fit(mx, mod, X, y, batch_end_callback=None, monitor=None, kvstore="device"):
    it = mx.io.NDArrayIter(X, y, batch_size=RESNET_BATCH)
    mod.fit(it, eval_metric="acc", kvstore=kvstore, optimizer="sgd",
            optimizer_params={"learning_rate": SGD["lr"], "momentum": SGD["momentum"],
                              "wd": SGD["wd"]},
            initializer=mx.init.Xavier(), num_epoch=1, batch_end_callback=batch_end_callback,
            monitor=monitor)
    return it


def _jsonl(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def telemetry_auto(mx, kernels, dev, telemetry, root, X, y):
    """(a): the fit under MXNET_FIT_MULTISTEP=auto with telemetry on; every
    anatomy interval and tuner decision, the invariants, the kernels'
    launches a step. Returns (numbers, module, JSONL path)."""
    import torch

    path = os.path.join(root, "telemetry.jsonl")
    telemetry.reset()
    telemetry.enable(jsonl=path)
    old = _tele_env(MXTPU_AMP="bf16", MXNET_FIT_MULTISTEP="auto",
                    MXTPU_ANATOMY_INTERVAL=TELE["interval"],
                    MXNET_FIT_MULTISTEP_MAX=TELE["k_max"])
    mod = _tele_module(mx)
    zero_counts(kernels)
    try:
        t0 = time.perf_counter()
        _tele_fit(mx, mod, X, y)
        torch.cuda.synchronize(dev)
        fit_s = time.perf_counter() - t0
    finally:
        _tele_env(**old)
    telemetry.flush()
    counts = dict(conv_counts(kernels), slab_update=kernels.fused_slab_update.launches)
    recs = _jsonl(path)
    decisions = [r for r in recs if r.get("type") == "multistep_auto"]
    intervals = [r for r in recs if r.get("type") == "anatomy"]
    for d in decisions:
        log("phase 28 (a) multistep_auto: K %d, dispatch share %s, settled %s%s" % (
            d["k"], d.get("dispatch_frac"), d["settled"],
            " (%s)" % d["why"] if d.get("why") else ""))
    for r in intervals:
        log("phase 28 (a) anatomy interval %d: %d steps, step %.3f ms, phases %s, "
            "unattributed %.6f s, MFU %s, roofline %s, K %s, recompiles %d" % (
                r["interval"], r["steps"], r["step_ms"],
                json.dumps({k: round(v, 6) for k, v in r["phases"].items()}),
                r["unattributed_seconds"], r.get("mfu"), json.dumps(r.get("roofline")),
                (r.get("multistep") or {}).get("k"), r["recompiles"]))
    assert decisions and decisions[-1]["settled"], decisions
    k = decisions[-1]["k"]
    assert intervals, "no anatomy record"
    for r in intervals:
        total = sum(r["phases"].values()) + r["unattributed_seconds"]
        assert abs(total - r["wall_seconds"]) <= 1e-9 * max(1.0, r["wall_seconds"]), r
        assert "mfu" in r and 0.0 < r["mfu"] <= 1.0, r
        assert r["device_kind"] == torch.cuda.get_device_name(0), r["device_kind"]
    tr = mod._fused_trainer
    (g,) = tr.group_stats()  # the settled depth's group: the others were released
    assert g["k"] == k and g["warmup_groups"] == 1 and g["captures"] == 1, g
    assert g["replays"] == g["groups"] - 1, g
    per_step = {n: g["captured_launches"].get(("fused_" + n) if n == "slab_update" else n, 0) / k
                for n in TELE_KERNELS}
    assert per_step == {"conv_bwd_filter": RESNET_CONVS, "conv_bwd_input": RESNET_CONVS,
                        "slab_update": 1}, per_step
    settled_at = decisions[-1]["t"]
    after = [r for r in intervals if r["t"] > settled_at]
    assert all(r["recompiles"] == 0 for r in after), after
    res = {"fit_s": fit_s, "k_settled": k, "why": decisions[-1].get("why"),
           "decisions": decisions, "intervals": intervals, "group": g,
           "launches": counts, "launches_a_step": per_step,
           "captures_after_settling": 0,
           "mfu_last": intervals[-1]["mfu"], "step_ms_last": intervals[-1]["step_ms"],
           "steps": sum(r["steps"] for r in intervals)}
    log("phase 28 (a): settled at K %d (%s), %d steps, %d intervals, launches a step %s, "
        "wrapper launches %s, fit %.1f s" % (k, res["why"], res["steps"], len(intervals),
                                              per_step, counts, fit_s))
    return res, mod, path


def telemetry_profiler(mx, kernels, mod, X, y, k, root):
    """(b): two replayed groups under the port's profiler; attribute_trace
    on the exported Kineto trace names K1, K2 and K3 with device ms."""
    import torch

    from mxnet_tpu_torch import profiler

    it = mx.io.NDArrayIter(X, y, batch_size=RESNET_BATCH)
    group = [b for _, b in zip(range(k), it)]
    mod.update_multi(group)  # outside the window: a replay of the settled graph
    torch.cuda.synchronize()
    stats0 = mod._fused_trainer.group_stats()[0]
    profiler.profiler_set_config(filename=os.path.join(root, "profile.json"))
    profiler.profiler_set_state("run")
    for _ in range(2):
        mod.update_multi(group)
        torch.cuda.synchronize()
    profiler.profiler_set_state("stop")
    stats1 = mod._fused_trainer.group_stats()[0]
    replays = stats1["replays"] - stats0["replays"]
    assert replays == 2 and stats1["captures"] == stats0["captures"], (stats0, stats1)
    att = profiler.attribute_trace(profiler.kineto_path(), top=None)
    by_label = {}
    for row in att["kernels"]:
        if row["label"]:
            slot = by_label.setdefault(row["label"], {"ms": 0.0, "launches": 0, "kernels": []})
            slot["ms"] += row["ms"]
            slot["launches"] += row["launches"]
            slot["kernels"].append(row["kernel"])
    expected = {TELE_KERNELS[n]: c * k * replays for n, c in (
        ("conv_bwd_filter", RESNET_CONVS), ("conv_bwd_input", RESNET_CONVS), ("slab_update", 1))}
    for label in ("K1", "K2", "K3"):
        assert label in by_label and by_label[label]["ms"] > 0, (label, sorted(by_label))
    # K2's entry counts its reduce kernel too; the main kernel alone
    main = {"K1": "slab_update_kernel", "K2": "conv_wgrad_sm90", "K3": "conv_dgrad_sm90"}
    seen = {label: sum(r["launches"] for r in att["kernels"] if main[label] in r["kernel"])
            for label in main}
    res = {"replays": replays, "device_ms": att["device_ms"],
           "unattributed_ms": att["unattributed_ms"],
           "by_label": by_label, "profiler_launches": seen, "wrapper_equivalent": expected,
           "counts_agree": seen == expected, "ops": att["ops"][:8],
           "kernels_top": att["kernels"][:10]}
    log("phase 28 (b): profiler over %d replays: %s; launches by the profiler %s against the "
        "wrappers' count a replay x replays %s; ops %s" % (
            replays, json.dumps({l: round(v["ms"], 4) for l, v in by_label.items()}), seen,
            expected, json.dumps([(o["op"], round(o["ms"], 3)) for o in att["ops"][:5]])))
    return res


def telemetry_tools(package, path):
    """(e): the port's perf_doctor and trace_summary on (a)'s JSONL, as a
    user runs them (three processes side by side); each exits 0 and
    perf_doctor names the largest phase."""
    out = {}
    env = dict(os.environ, PYTHONPATH=package)
    procs = {}
    try:
        for name, args in (("perf_doctor", [path]), ("trace_summary", [path]),
                           ("trace_summary_anatomy", [path, "--anatomy"])):
            mod = "mxnet_tpu_torch.tools." + name.replace("_anatomy", "")
            procs[name] = subprocess.Popen([sys.executable, "-m", mod] + args, cwd=package,
                                           env=env, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True)
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            assert proc.returncode == 0, (name, stdout[-2000:], stderr[-2000:])
            out[name] = stdout
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    diag = [l for l in out["perf_doctor"].splitlines() if l.startswith("diagnosis:")]
    assert diag, out["perf_doctor"][-2000:]
    m = re.match(r"diagnosis: largest cost is (\w+)", diag[0])
    assert m and m.group(1) in ("input_wait", "stage_host", "dispatch_host", "device_sync",
                                "collective", "unattributed"), diag
    log("phase 28 (e): perf_doctor: %s" % diag[0])
    log("phase 28 (e): perf_doctor report:\n%s" % out["perf_doctor"])
    log("phase 28 (e): trace_summary --anatomy:\n%s" % out["trace_summary_anatomy"])
    return {"largest_phase": m.group(1), "diagnosis": diag[0],
            "trace_summary_lines": len(out["trace_summary"].splitlines())}


def kvstore_on_card(mx, dev):
    """(g): a 'local' store initialised on the host takes four card
    gradients (SGD with momentum): the stored value and its momentum end on
    the card, and the pull equals w - lr * (sum of the gradients)."""
    import torch

    rng = np.random.RandomState(7)
    w = rng.randn(256, 128).astype(np.float32)
    gs = [rng.randn(256, 128).astype(np.float32) for _ in range(4)]
    kv = mx.kv.create("local")
    with mx.cpu():
        kv.init(0, mx.nd.array(w))
    kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                                         rescale_grad=1.0))
    kv.push(0, [mx.nd.array(g, ctx=mx.gpu(0)) for g in gs])
    out = mx.nd.zeros(w.shape, ctx=mx.gpu(0))
    kv.pull(0, out=out)
    (state,) = kv._updater.states.values()
    where = {"store": str(kv._store[0].context), "momentum": str(state.context)}
    assert where == {"store": str(mx.gpu(0)), "momentum": str(mx.gpu(0))}, where
    want = torch.from_numpy(w).to(dev) - 0.1 * sum(torch.from_numpy(g).to(dev) for g in gs)
    err = float((out._data - want).abs().max())
    assert err <= 1e-5, err
    log("phase 28 (g): 'local' store on the host, card gradients pushed: %s, pull max abs "
        "err %.3g (limit 1e-5)" % (json.dumps(where), err))
    return dict(where, max_abs_err=err)


def telemetry_monitor(mx, X, y):
    """(c): fit(monitor=Monitor(interval=1)) over two batches on four
    contexts of gpu(0) with kvstore 'device': the fused path is declined
    (the same module without a monitor takes it), every stat finite."""
    from mxnet_tpu_torch.models import resnet

    n = TELE["monitor_batches"] * RESNET_BATCH
    seen = []
    mon = mx.monitor.Monitor(interval=1, pattern=".*")
    toc = mon.toc

    def capture():
        rec = toc()
        seen.extend(rec)
        return rec

    mon.toc = capture
    np.random.seed(0)
    mod = mx.mod.Module(resnet.get_symbol(), context=[mx.gpu(0)] * 4)
    _tele_fit(mx, mod, X[:n], y[:n], monitor=mon)
    assert mod._fused_trainer is None
    vals = [float(v) for _, _, s in seen for v in s.split("\t") if v.strip()]
    assert vals and all(np.isfinite(vals)), [r for r in seen if "nan" in r[2] or "inf" in r[2]][:5]
    steps = sorted({s for s, _, _ in seen})
    plain = mx.mod.Module(resnet.get_symbol(), context=[mx.gpu(0)] * 4)
    plain.bind(data_shapes=[("data", (RESNET_BATCH, 3, 224, 224))],
               label_shapes=[("softmax_label", (RESNET_BATCH,))])
    plain.init_params(mx.init.Xavier())
    plain.init_optimizer(kvstore="device", optimizer="sgd")
    assert plain._fused_trainer is not None
    res = {"records": len(seen), "steps": steps, "finite": True, "fused_declined": True,
           "fused_without_monitor": True}
    log("phase 28 (c): Monitor: %d records over steps %s, all finite; fused path declined" % (
        len(seen), steps))
    return res


def telemetry_serve(mx, package, root):
    """(d): tools/serve.py --metrics-port on a ResNet-50 Predictor bundle on
    the card: requests, then /metrics (serve.requests = the number sent)
    and /healthz (200)."""
    import signal
    import socket
    import urllib.request

    from mxnet_tpu_torch import predict
    from mxnet_tpu_torch.models import resnet

    bundle = os.path.join(root, "resnet50.pred")
    with mx.cpu():
        params = serving_params(mx, resnet)
        symbol = resnet.get_symbol(num_classes=1000, num_layers=50,
                                   image_shape=",".join(str(d) for d in SERVE_SHAPE))
        predict.export_bundle(bundle, symbol, {k[4:]: v for k, v in params.items()
                                               if k.startswith("arg:")},
                              {k[4:]: v for k, v in params.items() if k.startswith("aux:")})
    env = dict(os.environ, PYTHONPATH=package)
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.serve", "--bundle", bundle, "--input",
         "data=" + "x".join(str(d) for d in SERVE_SHAPE), "--port", "0", "--metrics-port", "0",
         "--max-batch", "4"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=package, env=env)
    try:
        ports = {}
        lines = []
        t0 = time.perf_counter()
        while len(ports) < 2:
            line = proc.stdout.readline()
            assert line, "serve exited: %s" % "".join(lines[-20:])
            lines.append(line)
            m = re.match(r"(serving|metrics) on [\d.]+:(\d+)", line)
            if m:
                ports[m.group(1)] = int(m.group(2))
            assert time.perf_counter() - t0 < 300, lines[-20:]
        rng = np.random.RandomState(5)
        lat = []
        with socket.create_connection(("127.0.0.1", ports["serving"]), 120) as s:
            f = s.makefile("rwb")
            for _ in range(TELE["requests"]):
                x = rng.rand(*SERVE_SHAPE).astype(np.float32)
                f.write((json.dumps({"inputs": {"data": x.tolist()}}) + "\n").encode())
                f.flush()
                reply = json.loads(f.readline().decode())
                assert "outputs" in reply and len(reply["outputs"][0]) == 1000, str(reply)[:300]
                lat.append(reply["latency_ms"])
        base = "http://127.0.0.1:%d" % ports["metrics"]
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            text = r.read().decode()
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health_status = r.status
            health = json.loads(r.read().decode())
        m = re.search(r"^mxtpu_serve_requests (\S+)$", text, re.M)
        assert m and float(m.group(1)) == TELE["requests"], text[:2000]
        assert health_status == 200 and health["status"] == "ok", health
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        assert rc == 0, rc
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    res = {"requests": TELE["requests"], "serve_requests_metric": float(m.group(1)),
           "healthz": health_status, "latency_ms": lat, "metrics_lines": len(text.splitlines())}
    log("phase 28 (d): serve --metrics-port: %d requests, /metrics serve.requests %s, /healthz "
        "%d, latency ms %s" % (TELE["requests"], m.group(1), health_status,
                               [round(v, 2) for v in lat]))
    return res


def telemetry_cost(mx, telemetry, k, X, y):
    """(f): ms a step of the same fit at K = ``k`` with telemetry on and off
    (turns: on, off, off, on), the median interval between the ends of
    replayed groups, groups 3 on."""
    import torch

    n = TELE["cost_batches"] * RESNET_BATCH
    out = {"on": [], "off": []}
    for on in (True, False, False, True):
        telemetry.reset()
        (telemetry.enable if on else telemetry.disable)()
        stamps = []
        old = _tele_env(MXTPU_AMP="bf16", MXNET_FIT_MULTISTEP=k)
        try:
            mod = _tele_module(mx)
            _tele_fit(mx, mod, X[:n], y[:n], batch_end_callback=lambda p: stamps.append(
                (p.nbatch, time.perf_counter())))
            torch.cuda.synchronize()
        finally:
            _tele_env(**old)
        ends = [t for nb, t in stamps if (nb + 1) % k == 0]
        gaps = [(b - a) / k for a, b in zip(ends[2:], ends[3:])]
        out["on" if on else "off"].append(1e3 * statistics.median(gaps))
        del mod
    telemetry.disable()
    res = {"k": k, "step_ms_on": out["on"], "step_ms_off": out["off"],
           "cost_ms": statistics.median(out["on"]) - statistics.median(out["off"])}
    log("phase 28 (f): telemetry cost at K %d: step ms on %s, off %s" % (
        k, out["on"], out["off"]))
    return res


def phase_telemetry(mx, kernels, dev, telemetry, package, full=False):
    """Phase 28 (see the module docstring): (a), (b), (e) and (g); with ``full``
    (``--only telemetry``) also (c), (d) and (f)."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    X, y = _tele_data()
    root = tempfile.mkdtemp(prefix="chip_smoke_telemetry_")
    res = {}
    res["a"], mod, path = telemetry_auto(mx, kernels, dev, telemetry, root, X, y)
    k = res["a"]["k_settled"]
    res["b"] = telemetry_profiler(mx, kernels, mod, X, y, k, root)
    del mod
    telemetry.disable()
    torch.cuda.empty_cache()
    res["e"] = telemetry_tools(package, path)
    res["g"] = kvstore_on_card(mx, dev)
    if full:
        res["c"] = telemetry_monitor(mx, X, y)
        res["d"] = telemetry_serve(mx, package, root)
        res["f"] = telemetry_cost(mx, telemetry, k, X, y)
    res["launches"] = {n: res["a"]["launches"][n]
                       + res["b"]["profiler_launches"][TELE_KERNELS[n]]
                       for n in TELE_KERNELS}
    res["phase_s"] = time.perf_counter() - t0
    log("phase 28: telemetry and tools, %.1f s: %s" % (res["phase_s"], json.dumps(
        {k: v for k, v in res.items() if k in ("launches", "phase_s")})))
    return res


# ---------------------------------------------------------------------------
# phase 29: detection (the rest of the one-card surface)
# ---------------------------------------------------------------------------
DET_BATCH = 32  # SSD-300's batch in (b), (c) and (d)
DET_CLASSES = 20  # VOC
DET_FIT_STEPS = 6  # SSD-300 Module.fit steps a leg; ms and img/s from the last 3
RCNN_STEPS = 10
RCNN_SHAPES = ((600, 800), (800, 600))
DET_OP_TOL = 1e-4  # card against host, of max, outputs and gradients


def det_op_cases(rng):
    """(a)'s cases: (name, op, attrs, numpy inputs, differentiable inputs,
    outputs held bit for bit): every operator this slice adds."""
    def boxes(n, scale=1.0):
        xy = rng.uniform(0, 0.8, (n, 2))
        wh = rng.uniform(0.05, 0.4, (n, 2))
        return (np.concatenate([xy, np.minimum(xy + wh, 1.0)], 1) * scale).astype(np.float32)

    def softmax(x, axis):
        e = np.exp(x - x.max(axis=axis, keepdims=True))
        return (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)

    lab = -np.ones((4, 6, 5), np.float32)
    for b in range(4):
        lab[b, :b + 1, 0] = rng.randint(0, 20, b + 1)
        lab[b, :b + 1, 1:] = boxes(b + 1)
    score = rng.rand(1, 9, 38, 50).astype(np.float32)
    rois = np.concatenate([np.zeros((64, 1), np.float32), boxes(64, 600.0)], 1)
    theta = np.tile(np.array([0.9, 0.1, 0.05, -0.1, 0.8, 0.02], np.float32), (2, 1))
    return [
        ("MultiBoxPrior", "_contrib_MultiBoxPrior", {"sizes": (0.2, 0.272),
                                                      "ratios": (1, 2, 0.5, 3, 1.0 / 3)},
         [np.zeros((1, 8, 19, 19), np.float32)], 0, ()),
        ("MultiBoxTarget", "_contrib_MultiBoxTarget", {},
         [boxes(2000)[None], lab, np.zeros((4, 21, 2000), np.float32)], 0, (1, 2)),
        ("MultiBoxDetection", "_contrib_MultiBoxDetection", {"nms_topk": 400},
         [softmax(rng.randn(4, 21, 2000).astype(np.float32) * 3, 1),
          (rng.randn(4, 8000) * 0.2).astype(np.float32), boxes(2000)[None]], 0, ((0, 0),)),
        ("Proposal", "_contrib_Proposal", {"scales": (8, 16, 32), "ratios": (0.5, 1, 2)},
         [np.concatenate([1 - score, score], 1), (rng.randn(1, 36, 38, 50) * 0.2)
          .astype(np.float32), np.array([[600, 800, 1]], np.float32)], 0, ()),
        ("ROIPooling", "ROIPooling", {"pooled_size": (7, 7), "spatial_scale": 1.0 / 16},
         [rng.randn(1, 64, 38, 50).astype(np.float32), rois], 1, ()),
        ("CTCLoss", "CTCLoss", {}, [rng.randn(20, 4, 12).astype(np.float32),
                                    rng.randint(0, 12, (4, 6)).astype(np.float32)], 1, ()),
        ("fft", "fft", {}, [rng.randn(8, 64).astype(np.float32)], 1, ()),
        ("ifft", "ifft", {}, [rng.randn(8, 128).astype(np.float32)], 1, ()),
        ("quantize", "quantize", {}, [rng.uniform(-1, 1, (16, 32)).astype(np.float32),
                                      np.array([-1.0], np.float32),
                                      np.array([1.0], np.float32)], 0, (0,)),
        ("dequantize", "dequantize", {}, [rng.randint(0, 256, (16, 32)).astype(np.uint8),
                                          np.array([-1.0], np.float32),
                                          np.array([2.0], np.float32)], 0, ()),
        ("count_sketch", "count_sketch", {"out_dim": 50},
         [rng.randn(8, 200).astype(np.float32), rng.randint(0, 50, (1, 200))
          .astype(np.float32), (rng.randint(0, 2, (1, 200)) * 2 - 1).astype(np.float32)], 1, ()),
        ("GridGenerator", "GridGenerator", {"target_shape": (16, 16)}, [theta], 1, ()),
        ("BilinearSampler", "BilinearSampler", {},
         [rng.randn(2, 3, 16, 16).astype(np.float32),
          rng.uniform(-1.2, 1.2, (2, 2, 12, 12)).astype(np.float32)], 2, ()),
        ("SpatialTransformer", "SpatialTransformer", {"target_shape": (12, 12)},
         [rng.randn(2, 3, 16, 16).astype(np.float32), theta], 2, ()),
        ("Correlation", "Correlation", {"kernel_size": 3, "max_displacement": 4,
                                        "stride2": 2, "pad_size": 4},
         [rng.randn(2, 8, 16, 16).astype(np.float32),
          rng.randn(2, 8, 16, 16).astype(np.float32)], 2, ()),
        ("IdentityAttachKLSparseReg", "IdentityAttachKLSparseReg", {},
         [rng.rand(8, 16).astype(np.float32), np.full(16, 0.1, np.float32)], 1, ()),
    ]


def _op_run(op, attrs, inputs, n_diff, cot, dev):
    """Outputs and the first ``n_diff`` inputs' gradients against ``cot`` of
    one operator's fcompute on ``dev``."""
    import torch

    xs = [torch.from_numpy(np.array(x)).to(dev) for x in inputs]
    for x in xs[:n_diff]:
        x.requires_grad_()
    outs = op.fcompute(op.canon_attrs(attrs), xs, True)
    grads = []
    if n_diff:
        grads = torch.autograd.grad(outs[0], xs[:n_diff], torch.from_numpy(cot).to(dev))
    return ([o.detach().cpu().numpy() for o in outs], [g.cpu().numpy() for g in grads])


def det_ops_on_card(dev):
    """Phase 29 (a): each new operator on the card against itself on the
    host, from the same seeded inputs."""
    import torch

    from mxnet_tpu_torch.ops import registry

    rng = np.random.RandomState(29)
    rows = {}
    for name, opname, attrs, inputs, n_diff, exact in det_op_cases(rng):
        op = registry.get(opname)
        host_outs, _ = _op_run(op, attrs, inputs, 0, None, torch.device("cpu"))
        cot = rng.randn(*host_outs[0].shape).astype(np.float32)
        host = _op_run(op, attrs, inputs, n_diff, cot, torch.device("cpu"))
        card = _op_run(op, attrs, inputs, n_diff, cot, dev)
        worst = 0.0
        for kind, a_list, b_list in (("output", card[0], host[0]), ("grad", card[1], host[1])):
            for i, (a, b) in enumerate(zip(a_list, b_list)):
                a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
                fin = np.isfinite(b)
                if not np.array_equal(np.isfinite(a), fin):
                    raise AssertionError("%s %s %d: non-finite entries differ" % (name, kind, i))
                err = float(np.abs(a[fin] - b[fin]).max()) if fin.any() else 0.0
                rel = err / max(float(np.abs(b[fin]).max()) if fin.any() else 0.0, 1.0)
                if rel > DET_OP_TOL:
                    raise AssertionError("%s %s %d: card against host %.3g of max (tol %g)"
                                         % (name, kind, i, rel, DET_OP_TOL))
                worst = max(worst, rel)
        for e in exact:
            a = card[0][e] if isinstance(e, int) else card[0][e[0]][..., e[1]]
            b = host[0][e] if isinstance(e, int) else host[0][e[0]][..., e[1]]
            if not np.array_equal(a, b):
                raise AssertionError("%s output %s differs between card and host" % (name, e))
        rows[name] = {"worst_rel_err": worst, "bitwise_outputs": [str(e) for e in exact]}
    log("phase 29 (a): %d operators on the card against the host (tol %g of max): %s"
        % (len(rows), DET_OP_TOL, json.dumps(rows)))
    return rows


def ssd300_anchors(mx, dev):
    """SSD-300's 8732 anchors [1, 8732, 4] on ``dev``: MultiBoxPrior over its
    six sources (38, 19, 10, 5, 3, 1) with ``DEFAULT_SIZES`` /
    ``DEFAULT_RATIOS``."""
    import torch

    from mxnet_tpu_torch.models import ssd
    from mxnet_tpu_torch.ops import registry

    op = registry.get("_contrib_MultiBoxPrior")
    parts = [op.fcompute(op.canon_attrs({"sizes": s, "ratios": r}),
                         [torch.zeros((1, 1, side, side), device=dev)], False)[0]
             for side, s, r in zip((38, 19, 10, 5, 3, 1), ssd.DEFAULT_SIZES, ssd.DEFAULT_RATIOS)]
    return torch.cat(parts, dim=1)


def _nms_held(kernels, mask, order, active, flush, what):
    """The NMS kernel against its plain version on one input: the largest
    difference of their flags (0 or 1; fails unless 0), kernel ms (events,
    L2 flushed), the plain version's ms (its checking call), and the bound:
    the bytes of the rows this data makes it read (a visited box that is
    active and survives), order, active and the output. Returns (row, the
    kernel's flags, the plain version's flags)."""
    import torch

    torch.cuda.synchronize()
    got = kernels.nms_suppress(mask, order, active)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = kernels.nms_suppress_reference(mask, order, active)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = float((got.cpu().float() - want.cpu().float()).abs().max())
    if err != 0.0:
        raise AssertionError("NMS kernel: %s's kept set differs from the plain version's "
                             "(%d flags)" % (what, int((got.cpu() ^ want.cpu()).sum())))
    b_n, steps, n = mask.shape
    visited = torch.gather(active & ~got, 1, order)  # [B, S]
    rows = int(visited.sum())
    moved = rows * n + order.numel() * 8 + 2 * b_n * n
    ms = time_ms(lambda: kernels.nms_suppress(mask, order, active), 5, 1, flush)
    return ({"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "rows_read": rows,
             "bytes": moved, "bound_ms": 1e3 * moved / PEAK_BYTES, "shape": list(mask.shape),
             "kept": int((active & ~got).sum())}, got, want)


def det_nms(mx, kernels, dev):
    """Phase 29 (b): the NMS kernel against its plain version at SSD-300's
    8732 anchors x 32 images (every anchor a step, nms_topk -1) and at
    Proposal's 6000 -> 300 (R-CNN's 600 x 800 map): the kept sets equal."""
    import torch

    from mxnet_tpu_torch.contrib import ops as cops

    flush = torch.empty(50 * 2**20 // 4, dtype=torch.float32, device=dev)
    rng = np.random.RandomState(290)
    res = {}
    anchors = ssd300_anchors(mx, dev)
    a_n = anchors.shape[1]
    logits = torch.from_numpy(rng.randn(DET_BATCH, DET_CLASSES + 1, a_n).astype(np.float32))
    logits[:, 0] += 2.0  # mostly background, as a trained head
    prob = torch.softmax(logits, dim=1).to(dev)
    loc = torch.from_numpy((rng.randn(DET_BATCH, a_n * 4) * 0.3).astype(np.float32)).to(dev)
    attrs = {"threshold": 0.01, "clip": True}
    boxes, cls_id, _, order = cops.detection_candidates(attrs, prob, loc, anchors)
    mask, order, active = cops.detection_nms_inputs(boxes, cls_id, order, 0.5)
    res["ssd300"] = _nms_held(kernels, mask, order, active, flush, "SSD-300")[0]
    res["ssd300"]["mask_gib"] = mask.numel() / 2**30
    del mask
    torch.cuda.empty_cache()
    # Proposal at R-CNN's 600 x 800 (a 38 x 50 map, 9 anchors): 6000 -> 300
    score = torch.from_numpy(rng.rand(1, 9, 38, 50).astype(np.float32))
    cls_prob = torch.cat([1 - score, score], dim=1).to(dev)
    bbox = torch.from_numpy((rng.randn(1, 36, 38, 50) * 0.2).astype(np.float32)).to(dev)
    im_info = torch.tensor([[600.0, 800.0, 1.0]], device=dev)
    from mxnet_tpu_torch.ops import registry

    pattrs = registry.get("_contrib_Proposal").canon_attrs(
        {"scales": (8, 16, 32), "ratios": (0.5, 1, 2)})
    top_boxes, top_scores = cops.proposal_candidates(pattrs, cls_prob, bbox, im_info)
    pmask, porder, pactive = cops.proposal_nms_inputs(top_boxes, top_scores, 0.7)
    res["proposal"], pgot, pwant = _nms_held(kernels, pmask, porder, pactive, flush,
                                             "Proposal")
    keep = torch.where(pgot[0], torch.full_like(top_scores, -1.0), top_scores)
    picks = torch.sort(keep, descending=True, stable=True)[1][:300]
    keep_plain = torch.where(pwant[0].to(dev), torch.full_like(top_scores, -1.0), top_scores)
    assert torch.equal(picks, torch.sort(keep_plain, descending=True, stable=True)[1][:300])
    log("phase 29 (b): NMS kernel kept sets equal to the plain version's: %s" % json.dumps(res))
    return res


def _ssd_data(mx, n, seed=29):
    """``n`` seeded images [n, 3, 300, 300] and labels [n, 8, 5] (1-4 boxes
    each, class in [0, 20), -1 pads)."""
    rng = np.random.RandomState(seed)
    data = rng.rand(n, 3, 300, 300).astype(np.float32)
    label = -np.ones((n, 8, 5), np.float32)
    for i in range(n):
        k = rng.randint(1, 5)
        xy = rng.uniform(0, 0.7, (k, 2))
        wh = rng.uniform(0.1, 0.3, (k, 2))
        label[i, :k, 0] = rng.randint(0, DET_CLASSES, k)
        label[i, :k, 1:] = np.concatenate([xy, np.minimum(xy + wh, 1.0)], 1)
    return data, label


def ssd_conv_cases(mx, kernels):
    """SSD-300's in-envelope convolutions at batch 32 by dtype:
    {dtype: {(data, weight, pad): count}} and their names."""
    from mxnet_tpu_torch.models import common, ssd

    symbol = ssd.get_symbol(num_classes=DET_CLASSES)  # the training symbol's convolutions
    out, names = {}, {}
    for dtype in ("float32", "bfloat16"):
        shapes, names[dtype] = {}, []
        for c in common.conv_layers(symbol, (DET_BATCH, 3, 300, 300)):
            if kernels.conv_bwd_plan(c["data"], c["weight"], c["stride"], c["pad"], c["dilate"],
                                     dtype):
                key = (c["data"], c["weight"], c["pad"])
                shapes[key] = shapes.get(key, 0) + 1
                names[dtype].append(c["name"])
        out[dtype] = shapes
    return out, names


def ssd_fit_leg(mx, kernels, dev, amp):
    """Phase 29 (c), one leg: SSD-300 (20 classes) through ``Module.fit`` at
    batch 32, f32 on gpu(0) (the executor path), or bf16 AMP on a dp 4 mesh
    of gpu(0) with kvstore 'device' (the fused path)."""
    import torch

    from mxnet_tpu_torch.models import ssd

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    data, label = _ssd_data(mx, DET_FIT_STEPS * DET_BATCH)
    it = mx.io.NDArrayIter(data, label, batch_size=DET_BATCH, label_name="label")
    np.random.seed(0)
    kw = dict(data_names=("data",), label_names=("label",))
    if amp:
        mod = mx.mod.Module(ssd.get_symbol_train(num_classes=DET_CLASSES), context=mx.gpu(0),
                            mesh=mx.parallel.make_mesh(dp=4, devices=[mx.gpu(0)] * 4), **kw)
    else:
        mod = mx.mod.Module(ssd.get_symbol_train(num_classes=DET_CLASSES), context=mx.gpu(0),
                            **kw)
    metric = ssd.MultiBoxMetric()
    losses, stamps = [], []

    def on_batch(param):
        names, values = metric.get()  # the metric's update read the outputs: synchronised
        losses.append(dict(zip(names, values)))
        stamps.append(time.perf_counter())
        metric.reset()

    _amp_env(amp)
    try:
        before = dict(conv_counts(kernels), slab_update=kernels.fused_slab_update.launches)
        mod.fit(it, kvstore="device" if amp else "local", optimizer="sgd",
                optimizer_params={"learning_rate": 1e-3, "momentum": 0.9, "wd": 5e-4},
                initializer=mx.init.Xavier(), eval_metric=metric, num_epoch=1,
                batch_end_callback=on_batch)
        after = dict(conv_counts(kernels), slab_update=kernels.fused_slab_update.launches)
    finally:
        _amp_env(False)
    if amp:
        assert mod._fused_trainer is not None and mod._fused_trainer.amp
    counts = {k: after[k] - before[k] for k in after}
    it.reset()
    profile = profile_fit_steps(mod, next(iter(it)))  # two more steps, after the counts
    assert len(losses) == DET_FIT_STEPS, len(losses)
    for row in losses:
        assert all(np.isfinite(v) for v in row.values()), losses
    step_s = [b - a for a, b in zip(stamps[-4:], stamps[-3:])]
    med = statistics.median(step_s)
    return {"dtype": "bf16 AMP, dp 4" if amp else "float32", "batch": DET_BATCH,
            "steps": DET_FIT_STEPS, "losses": losses, "launches": counts,
            "step_ms_median_last_3": 1e3 * med, "img_per_s": DET_BATCH / med,
            "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30, "profile": profile}


def det_ssd_conv_checks(mx, kernels, dev):
    """Phase 29 (c), first part: K2/K3 against their plain versions on
    SSD-300's in-envelope shapes at batch 32 (1e-4), f32 and bf16."""
    import torch

    cases, names = ssd_conv_cases(mx, kernels)
    dtypes_of = {}
    for dtype, shapes in cases.items():
        for key in shapes:
            dtypes_of.setdefault(key, []).append(getattr(torch, dtype))
    worst, _ = conv_checks(kernels, list(dtypes_of.items()), dev, np.random.default_rng(29))
    res = {"conv_checks": {"shapes": len(dtypes_of), "worst_rel_err": worst},
           "in_envelope": {d: {"convs": sum(s.values()), "names": names[d]}
                           for d, s in cases.items()}}
    log("phase 29 (c): K2/K3 vs plain ok on SSD-300's %d in-envelope shapes, worst %s; "
        "in-envelope convolutions %s" % (len(dtypes_of), json.dumps(worst),
                                         json.dumps(res["in_envelope"])))
    return res


def det_ssd_fit(mx, kernels, dev, res):
    """Phase 29 (c), second part: the f32 and AMP fits, K2 and K3 once a step
    on each in-envelope convolution (``res`` from
    :func:`det_ssd_conv_checks`) and K1 once a step on the AMP leg."""
    for amp in (False, True):
        leg = ssd_fit_leg(mx, kernels, dev, amp)
        want = DET_FIT_STEPS * res["in_envelope"]["bfloat16" if amp else "float32"]["convs"]
        assert leg["launches"]["conv_bwd_filter"] == want, (leg["launches"], want)
        assert leg["launches"]["conv_bwd_input"] == want, (leg["launches"], want)
        if amp:
            assert leg["launches"]["slab_update"] >= DET_FIT_STEPS, leg["launches"]
        res["amp" if amp else "f32"] = leg
        log("phase 29 (c): SSD-300 Module.fit %s: %s" % (leg["dtype"], json.dumps(leg)))
    return res


def det_predictor(mx, dev):
    """Phase 29 (d): SSD-300's deploy symbol (MultiBoxDetection, nms_topk
    400) behind a Predictor at batch 1 and 32: each bucket one captured
    graph whose output equals an eager forward bit for bit."""
    import torch

    from mxnet_tpu_torch import predict
    from mxnet_tpu_torch.models import ssd
    from mxnet_tpu_torch.models.common import init_params

    symbol = ssd.get_symbol(num_classes=DET_CLASSES)
    arg_np, aux_np = init_params(symbol, (1, 3, 300, 300), 0)
    with mx.cpu():
        params = {"arg:" + n: mx.nd.array(v) for n, v in arg_np.items()}
        params.update({"aux:" + n: mx.nd.array(v) for n, v in aux_np.items()})
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # replay against eager, bit for bit
    try:
        pred = predict.Predictor(symbol.tojson(), params, {"data": (1, 3, 300, 300)},
                                 ctx=mx.gpu(0))
        pred.compile([{"data": (b, 3, 300, 300)} for b in (1, DET_BATCH)])
        rng = np.random.default_rng(291)
        rows = []
        for b in (1, DET_BATCH):
            fn = pred._serve_cache[(("data", (b, 3, 300, 300)),)]
            assert fn._graph is not None, "bucket %d has no graph" % b
            x = rng.random((b, 3, 300, 300), dtype=np.float32)
            got = pred.predict_batch(data=x)[0]
            pred.reshape({"data": x.shape})
            want = pred.predict(data=x)[0]
            assert got.shape == (b, 8732, 6) and np.isfinite(got).all(), got.shape
            if not _bits_equal(got, want):
                raise AssertionError("SSD-300 detection bucket %d: replay differs from eager" % b)
            kept = int((got[..., 0] >= 0).sum())
            rows.append({"batch": b, "bitwise_equal_to_eager": True, "kept_boxes": kept,
                         "capture_ms": fn.stats["capture_ms"],
                         "replay_ms": _median_ms(lambda: pred.predict_batch(data=x), 5),
                         "eager_ms": _median_ms(lambda: pred.predict(data=x), 5)})
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log("phase 29 (d): SSD-300 detection through Predictor: %s" % json.dumps(rows))
    return rows


def det_rcnn(mx, kernels, dev):
    """Phase 29 (e): Faster R-CNN VGG-16 (21 classes, 6000 -> 300 proposals,
    128 rois, 7 x 7 pooling, 1024 hidden) through MutableModule bound at 800
    x 800, ``RCNN_STEPS`` SGD steps alternating 600 x 800 and 800 x 600:
    ms a step, the host's proposal_target ms in it, the card's busy ms of
    two profiled steps, NMS and K2/K3 launches."""
    import torch

    from mxnet_tpu_torch.examples import train_rcnn
    from mxnet_tpu_torch.models import rcnn

    kw, _ = train_rcnn.config("vgg")
    kw["num_classes"] = 21
    target_ms = []
    orig = rcnn.ProposalTargetProp.create_operator

    def timed_operator(self, ctx, in_shapes, in_dtypes):
        op = orig(self, ctx, in_shapes, in_dtypes)
        forward = op.forward

        def timed(*args):
            torch.cuda.synchronize()  # the host's own time, not the card's queue
            t0 = time.perf_counter()
            forward(*args)
            target_ms.append(1e3 * (time.perf_counter() - t0))

        op.forward = timed
        return op

    rcnn.ProposalTargetProp.create_operator = timed_operator
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        net = rcnn.get_symbol_train(**kw)
        mod = train_rcnn.build_module(net, kw, list(RCNN_SHAPES), mx.gpu(0))
        fs, scales, ratios = kw["feature_stride"], kw["scales"], kw["ratios"]
        batches = [train_rcnn.make_batch(*RCNN_SHAPES[i % 2], fs, scales, ratios, i,
                                         ctx=mx.gpu(0)) for i in range(RCNN_STEPS + 2)]
        mod.bind(data_shapes=batches[0].provide_data, label_shapes=batches[0].provide_label)
        mod.init_params(initializer=mx.init.Xavier())
        mod.init_optimizer(optimizer="sgd", optimizer_params={"learning_rate": 1e-3})
        nms0, conv0 = kernels.nms_suppress.launches, conv_counts(kernels)

        def step(batch):
            mod.forward(batch, is_train=True)
            outs = [o.asnumpy() for o in mod.get_outputs()]
            mod.backward()
            mod.update()
            torch.cuda.synchronize()
            return outs

        step_ms, losses = [], []
        for i in range(RCNN_STEPS):
            t0 = time.perf_counter()
            outs = step(batches[i])
            step_ms.append(1e3 * (time.perf_counter() - t0))
            assert all(np.isfinite(o).all() for o in outs), i
            losses.append({"rpn_bbox_loss": float(outs[1].sum()),
                           "bbox_loss": float(outs[3].sum()),
                           "fg_rois": int((outs[4] > 0).sum())})
        nms = kernels.nms_suppress.launches - nms0
        convs = {k: v - conv0[k] for k, v in conv_counts(kernels).items()}
        assert nms == RCNN_STEPS, nms  # one Proposal a step
        n_target = len(target_ms)
        from mxnet_tpu_torch.tools import resnet_bench

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as p:
            t0 = time.perf_counter()
            for i in (RCNN_STEPS, RCNN_STEPS + 1):  # one image of each shape
                step(batches[i])
            wall = time.perf_counter() - t0
        prof = profile_summary(p, 2, wall, lambda name: (
            "nms" if "nms_kernel" in name else resnet_bench.family(name)))
        prof_target = target_ms[n_target:]
    finally:
        rcnn.ProposalTargetProp.create_operator = orig
    res = {"steps": RCNN_STEPS, "shapes": [list(s) for s in RCNN_SHAPES],
           "bound_shapes": len(mod._shape_modules), "losses": losses,
           "step_ms": step_ms, "step_ms_median_after_2": statistics.median(step_ms[2:]),
           "proposal_target_host_ms_median": statistics.median(target_ms[2:n_target]),
           "profiled": prof, "profiled_proposal_target_host_ms": prof_target,
           "nms_launches": nms, "conv_launches": convs,
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    log("phase 29 (e): Faster R-CNN VGG-16 through MutableModule: %s" % json.dumps(res))
    return res


def det_custom(mx, dev):
    """Phase 29 (f): a Custom operator mid-graph on gpu(0) against the host
    (outputs and gradients within 1e-6), then the capture refusals: a
    Predictor bucket and MXNET_FIT_MULTISTEP=2 raise naming the node, and a
    Predictor bucket of a ROIPooling graph raises naming its node."""
    import torch

    from mxnet_tpu_torch import predict

    @mx.operator.register("chip_scale2")
    class Scale2Prop(mx.operator.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            class Scale2(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0] * 2.0)  # on the card

                def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
                    self.assign(in_grad[0], req[0], out_grad[0].asnumpy() * 2.0)  # via host

            return Scale2()

    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = mx.sym.Custom(net, op_type="chip_scale2", name="scaled")
    net = mx.sym.FullyConnected(mx.sym.tanh(net), num_hidden=4, name="fc2")
    rng = np.random.RandomState(296)
    vals = {"data": rng.randn(8, 10), "fc1_weight": rng.randn(16, 10) * 0.3,
            "fc1_bias": rng.randn(16) * 0.1, "fc2_weight": rng.randn(4, 16) * 0.3,
            "fc2_bias": rng.randn(4) * 0.1}
    head = rng.randn(8, 4).astype(np.float32)
    runs = []
    for ctx in (mx.gpu(0), mx.cpu()):
        exe = net.simple_bind(ctx, data=(8, 10))
        for k, v in vals.items():
            exe.arg_dict[k][:] = v.astype(np.float32)
        exe.forward(is_train=True)
        exe.backward(mx.nd.array(head, ctx=ctx))
        assert exe.outputs[0]._data.device.type == ctx.torch_device.type
        runs.append([exe.outputs[0].asnumpy()] + [exe.grad_dict[k].asnumpy() for k in vals])
    worst = max(float(np.abs(a - b).max()) for a, b in zip(*runs))
    assert worst <= 1e-5, worst
    res = {"card_vs_host_max_abs_err": worst}
    with mx.cpu():
        params = {"arg:" + k: mx.nd.array(v.astype(np.float32)) for k, v in vals.items()
                  if k != "data"}
    try:
        predict.Predictor(net.tojson(), params, {"data": (8, 10)}, ctx=mx.gpu(0)).compile(
            [{"data": (8, 10)}])
        raise AssertionError("a Predictor captured a graph that holds a Custom node")
    except mx.MXNetError as exc:
        assert "scaled" in str(exc), exc
        res["predictor_refusal"] = str(exc)
    roi_net = mx.sym.ROIPooling(mx.sym.Variable("data"), mx.sym.Variable("rois"),
                                pooled_size=(2, 2), name="roi_pool")
    roi_shapes = {"data": (1, 4, 8, 8), "rois": (3, 5)}
    try:
        predict.Predictor(roi_net.tojson(), {}, roi_shapes, ctx=mx.gpu(0)).compile([roi_shapes])
        raise AssertionError("a Predictor captured a graph that holds a ROIPooling node")
    except mx.MXNetError as exc:
        assert "roi_pool" in str(exc), exc
        res["roi_pooling_predictor_refusal"] = str(exc)
    X = rng.rand(32, 10).astype(np.float32)
    y = rng.randint(0, 4, 32).astype(np.float32)
    mod = mx.mod.Module(mx.sym.SoftmaxOutput(net, name="softmax"), context=mx.gpu(0),
                        mesh=mx.parallel.make_mesh(dp=4, devices=[mx.gpu(0)] * 4))
    os.environ["MXNET_FIT_MULTISTEP"] = "2"
    try:
        mod.fit(mx.io.NDArrayIter(X, y, batch_size=8), kvstore="device", optimizer="sgd",
                num_epoch=1)
        raise AssertionError("MXNET_FIT_MULTISTEP=2 grouped a graph that holds a Custom node")
    except mx.MXNetError as exc:
        assert "scaled" in str(exc), exc
        res["multistep_refusal"] = str(exc)
    finally:
        os.environ.pop("MXNET_FIT_MULTISTEP", None)
    torch.cuda.synchronize()
    log("phase 29 (f): Custom on gpu(0): %s" % json.dumps(res))
    return res


def det_consistency(mx):
    """Phase 29 (g): ``test_utils.check_consistency`` over [gpu(0), cpu(0)]:
    a conv / BatchNorm / pooling net and a spatial-transformer net, outputs
    and gradients."""
    from mxnet_tpu_torch import test_utils

    data = mx.sym.Variable("data")
    net = mx.sym.Convolution(data, num_filter=8, kernel=(3, 3), pad=(1, 1), name="conv")
    net = mx.sym.BatchNorm(net, fix_gamma=False, name="bn")
    net = mx.sym.Pooling(mx.sym.Activation(net, act_type="relu"), kernel=(2, 2),
                         stride=(2, 2), pool_type="max")
    net = mx.sym.FullyConnected(mx.sym.Flatten(net), num_hidden=4, name="fc")
    loc = mx.sym.FullyConnected(mx.sym.Flatten(data), num_hidden=6, name="loc")
    stn = mx.sym.SpatialTransformer(data, loc, target_shape=(6, 6))
    np.random.seed(297)
    for sym in (net, stn):
        test_utils.check_consistency(sym, [{"ctx": mx.gpu(0), "data": (4, 3, 8, 8)},
                                           {"ctx": mx.cpu(0), "data": (4, 3, 8, 8)}])
    log("phase 29 (g): check_consistency across [gpu(0), cpu(0)] ok (conv/BN net, "
        "SpatialTransformer)")
    return {"symbols": 2, "ok": True}


def phase_detection(mx, kernels, dev):
    """Phase 29 (see the module docstring). The detection path's launches
    (K2, K3, K1, NMS) are counted from zero over (c)-(e)."""
    import torch

    t0 = time.perf_counter()
    res = {"a": det_ops_on_card(dev), "b": det_nms(mx, kernels, dev)}
    torch.cuda.empty_cache()
    checks = det_ssd_conv_checks(mx, kernels, dev)
    zero_counts(kernels)
    kernels.nms_suppress.launches = 0  # counts from here are the detection path's
    res["c"] = det_ssd_fit(mx, kernels, dev, checks)
    res["d"] = det_predictor(mx, dev)
    res["e"] = det_rcnn(mx, kernels, dev)
    launches = dict(conv_counts(kernels), slab_update=kernels.fused_slab_update.launches,
                    nms=kernels.nms_suppress.launches)
    for name, n in launches.items():
        if n == 0:
            raise AssertionError("the detection path never launched %s" % name)
    res["launches"] = launches
    torch.cuda.empty_cache()
    res["f"] = det_custom(mx, dev)
    res["g"] = det_consistency(mx)
    res["phase_s"] = time.perf_counter() - t0
    log("phase 29: detection, %.1f s: launches %s" % (res["phase_s"], json.dumps(launches)))
    return res


def nms_entry(res):
    """The NMS kernel's entry of the kernels line (no TPU counterpart):
    times at SSD-300's 8732 x 32 and Proposal's 6000 -> 300 ('ms',
    'plain_ms', 'bound_ms' the SSD-300 call's), launches on the detection
    path."""
    b = res["b"]
    return {"name": "nms", "route": "cuda", "source": "mxnet_tpu_torch/csrc/nms.cu",
            "replaces": "none: a port kernel for the fori_loops at "
                        "mxnet_tpu/contrib/ops.py:246 and :379 (no pallas_call)",
            "launches": res["launches"]["nms"],
            "max_abs_err": max(b["ssd300"]["max_abs_err"], b["proposal"]["max_abs_err"]),
            "ms": b["ssd300"]["ms"], "plain_ms": b["ssd300"]["plain_ms"],
            "bound_ms": b["ssd300"]["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "proposal_6000": {k: b["proposal"][k] for k in ("ms", "plain_ms", "bound_ms",
                                                            "rows_read", "shape")},
            "ssd300_8732x32": {k: b["ssd300"][k] for k in ("rows_read", "shape", "kept")}}



# -- phase 30: several processes on the card --------------------------------
# phase 30's limits against one process. (b): the first step's loss (the
# same weights; BatchNorm's sums in another order flip bf16 roundings
# through 53 layers under AMP) and every loss; in f32 the first loss, the
# BatchNorm statistics of the first step (the global batch's) and the first
# update: per leaf, max |two processes - one| of the weights after step 1
# over the one-process update's max |w1 - w0| (``update_rel``), for the
# leaves whose update is at least ``held_ulps`` ulps of their largest
# initial weight (the others, bn0_gamma's fixed 1 among them, move by a few
# roundings and are listed). ResNet-50's first update at this init is
# ill-conditioned: in one process, conv forwards without cuDNN move it by a
# few hundredths (the witness, --only dist), so the limit sits above that
# and below the control, the same fit with the gradient rescaled by the
# local batch (twice the gradient), which must fail it. The weights after
# all steps are reported, not held; (b) holds the sharded update bit for
# bit to the replicated one across the processes. The replicated twin and
# the control run under --only dist only, and the full script's AMP fit
# takes amp_steps // 2 steps.
# (c) the executor path's workers compute what the two contexts compute.
DIST = dict(batch=64, amp_steps=10, f32_steps=3, profile_steps=2, timeout=900,
            elastic_steps=6, elastic_batch=64, first_loss=1e-3, losses=1e-2, f32=1e-5,
            update_rel=0.25, held_ulps=64)


def _dist_launch(package, root, name, args, env=None, timeout=None, watchdog=None, n=2):
    """``tools/launch.py -n n`` (under ``tools/watchdog.py`` with
    ``watchdog`` flags) of ``tools/dist_check.py args``, its output in
    ``root/name.log``; returns (exit code, wall s, log tail, each rank's
    JSON)."""
    out = os.path.join(root, name)
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n", str(n),
           sys.executable, "-m", "mxnet_tpu_torch.tools.dist_check", "--out", out,
           "--device", "cuda"] + list(args)
    if watchdog is not None:
        cmd = ([sys.executable, "-m", "mxnet_tpu_torch.tools.watchdog"] + watchdog + ["--"]
               + cmd[:3] + cmd[5:])  # the launcher takes its world from the watchdog
    full_env = dict(os.environ, PYTHONPATH=package, **(env or {}))
    full_env.pop("MXTPU_AMP", None)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=package, env=full_env, capture_output=True, text=True,
                          timeout=timeout or DIST["timeout"])
    wall = time.perf_counter() - t0
    with open(os.path.join(root, name + ".log"), "w") as fh:
        fh.write(proc.stdout + "\n---- stderr ----\n" + proc.stderr)
    ranks = []
    for r in range(n):
        path = os.path.join(out, "rank%d.json" % r)
        if os.path.exists(path):
            with open(path) as fh:
                ranks.append(json.load(fh))
    tail = proc.stdout[-3000:] + proc.stderr[-8000:]
    if proc.returncode != 0:
        raise AssertionError("launch %s: exit %d\n%s" % (name, proc.returncode, tail))
    return proc, wall, ranks


def _dist_reference_fit(mx, dev, kv, amp, steps, mesh_dp=None, cudnn=True):
    """The one-process run a dist fit is held to: the same global batches
    (``dist_check.fit_data``), seed and optimizer, on ``mesh_dp`` logical
    ranks of gpu(0) (kvstore ``device``) or two contexts of gpu(0)
    (``local``); ``cudnn=False`` runs the convolutions' forward without
    cuDNN. Returns (losses, arg, aux, ms a step, the weights and (``aux:*``)
    aux states after the first step, the initial weights)."""
    import torch

    from mxnet_tpu_torch.tools import dist_check

    X, y = dist_check.fit_data("resnet50", steps, DIST["batch"])
    it = mx.io.NDArrayIter(X, y, batch_size=DIST["batch"])
    _amp_env(amp)
    np.random.seed(0)
    sym = dist_check.fit_symbol(mx, "resnet50")
    if mesh_dp:
        mod = mx.mod.Module(sym, context=mx.gpu(0),
                            mesh=mx.parallel.make_mesh(dp=mesh_dp, devices=[mx.gpu(0)] * mesh_dp))
    else:
        mod = mx.mod.Module(sym, context=[mx.gpu(0), mx.gpu(0)])
    # fit's own bind and init, first: the initial weights (fit then keeps them)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label, for_training=True)
    mod.init_params(initializer=mx.init.Xavier())
    init = {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}
    losses, stamps, snap = [], [], {}

    def on_batch(param):
        if param.nbatch == 0:
            mod._sync_params_from_devices()
            snap.update({k: v.asnumpy().copy() for k, v in mod._arg_params.items()})
            snap.update({"aux:" + k: v.asnumpy().copy() for k, v in mod._aux_params.items()})
        prob = mod.get_outputs()[0]._data
        label = param.locals["data_batch"].label[0]._data.long()
        picked = prob.float().gather(1, label.unsqueeze(1)).squeeze(1)
        losses.append(float(-torch.log(picked.clamp_min(1e-30)).mean()))  # synchronises
        stamps.append(time.perf_counter())

    torch.backends.cudnn.enabled = cudnn
    try:
        mod.fit(it, kvstore=kv, optimizer="sgd",
                optimizer_params=dict(dist_check.SGD),
                initializer=mx.init.Xavier(), num_epoch=1, batch_end_callback=on_batch)
    finally:
        torch.backends.cudnn.enabled = True
        _amp_env(False)
    arg, aux = mod.get_params()
    step_s = [b - a for a, b in zip(stamps[1:], stamps[2:])]
    return (losses, {k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in aux.items()},
            1e3 * statistics.median(step_s) if step_s else None, snap, init)


def _first_update_err(got_w1, ref):
    """Per leaf: max |got - want| of the weights after step 1 over the
    one-process update's max |want - init|, for the leaves whose update is
    at least ``DIST["held_ulps"]`` ulps of their largest initial weight.
    Returns the worst (err, leaf), the three worst and the leaves left
    out."""
    snap, init = ref[4], ref[5]
    errs, out = [], []
    for k, w0 in init.items():
        w0 = np.asarray(w0, np.float32)
        want = np.asarray(snap[k], np.float64)
        upd = float(np.abs(want - w0).max())
        if upd < DIST["held_ulps"] * float(np.spacing(np.abs(w0).max())):
            out.append(k)
            continue
        errs.append((float(np.abs(np.asarray(got_w1[k], np.float64) - want).max()) / upd, k))
    errs.sort(reverse=True)
    return {"worst": errs[0], "top3": errs[:3], "held": len(errs), "left_out": out}


def _of_max(got, want, keys):
    """Per tensor: max |got - want| over max(1, max |want|), the worst."""
    worst = (-1.0, "")
    for k in keys:
        w = np.asarray(want[k], np.float64)
        err = float(np.abs(np.asarray(got[k], np.float64) - w).max()) / max(1.0, float(
            np.abs(w).max()))
        worst = max(worst, (err, k))
    return worst


def phase_dist(mx, kernels, dev, package, full=False, extra=()):
    """Phase 30: two worker processes on gpu(0), one gloo group, through the
    port's launcher (see the module docstring). Returns the numbers and
    each rank's K1/K2/K3 launches (``launches``, summed over the ranks);
    ``extra`` flags of dist_check join the same launch (phase 31's tp leg),
    and ``ranks`` holds the workers' JSON for them."""
    import torch

    from mxnet_tpu_torch.tools import dist_check

    t_phase = time.perf_counter()
    root = os.path.join(package, "build", "chip_smoke_dist")
    os.makedirs(root, exist_ok=True)
    res = {"card": card_line()}
    amp_fits = ["dist_device_sync+amp", "dist_device_sync+amp+rep"]
    # the full script's AMP fit is half as long (its host-bound steps vary most)
    steps = DIST["amp_steps"] if full else DIST["amp_steps"] // 2
    fit_list = "%s:%d,dist_device_sync:%d,dist_sync:%d" % (
        amp_fits[0], steps, DIST["f32_steps"], DIST["f32_steps"])
    if full:  # the replicated twin and the local-rescale control
        fit_list += ",%s:%d,dist_device_sync+localrescale:1" % (amp_fits[1], steps)
    proc, wall, ranks = _dist_launch(package, root, "abc", [
        "--checks", "kvstore,barrier,fused", "--fit", fit_list,
        "--model", "resnet50", "--batch", str(DIST["batch"]), "--snap-step", "1",
        "--profile-steps", str(DIST["profile_steps"])] + list(extra))
    res["ranks"] = ranks
    assert len(ranks) == 2 and all(r["ok"] and r["size"] == 2 for r in ranks), ranks
    res["launch_wall_s"] = wall
    log("phase 30 (a)-(c): the workers' launch %.1f s; rank 0's seconds: to its first check "
        "%.1f, each fit's setup, fit and total %s, all %.1f" % (
            wall, ranks[0]["started_s"], json.dumps({n: [round(f[k], 1) for k in (
                "setup_s", "fit_s", "wall_s")] for n, f in ranks[0]["fits"].items()}),
            ranks[0]["wall_s"]))
    # (a) the three checks
    for r in ranks:
        assert r["backend"] == "gloo"
        assert r["kvstore_value"] == r["kvstore_expected"], r
        assert r["params_identical"] and r["fused_losses"][1] < 0.5 * r["fused_losses"][0]
    assert ranks[0]["barrier_wait_s"] >= 1.0, ranks[0]["barrier_wait_s"]
    res["a"] = {"kvstore_value": ranks[0]["kvstore_value"],
                "barrier_wait_s_rank0": ranks[0]["barrier_wait_s"],
                "fused_losses": [r["fused_losses"] for r in ranks]}
    log("phase 30 (a): %s" % json.dumps(res["a"]))

    # (b) the AMP dist_device_sync fit: both ranks, and the replicated
    # update, bit for bit; the f32 fused fit against one process over dp 2
    fits = [r["fits"][amp_fits[0]] for r in ranks]
    reps = [r["fits"][amp_fits[1]] for r in ranks] if full else []
    assert fits[0]["digests"] == fits[1]["digests"], "the ranks' masters / bf16 weights differ"
    assert fits[0]["losses"] == fits[1]["losses"]
    assert fits[0]["fused"] and fits[0]["flat_mode"] == "shard" and fits[0]["amp"]
    assert not reps or reps[0]["flat_mode"] == "replicated"
    want = {"conv_bwd_filter": RESNET_CONVS * steps, "conv_bwd_input": RESNET_CONVS * steps,
            "slab_update": slab_launches_a_step(kernels, fits[0]["buckets"]) * steps}
    for f in fits:
        assert f["launches"] == want, (f["launches"], want)
    torch.backends.cudnn.deterministic = True
    t_ref = time.perf_counter()
    try:
        amp_ref = _dist_reference_fit(mx, dev, "device", True, steps, 2)
        f32_ref = _dist_reference_fit(mx, dev, "device", False, DIST["f32_steps"], 2)
        # the witness (--only dist): one process again, its conv forwards
        # without cuDNN, its first update against the reference's
        witness = _dist_reference_fit(mx, dev, "device", False, 1, 2, cudnn=False) \
            if full else None
    finally:
        torch.backends.cudnn.deterministic = False
    losses, ref_ms = amp_ref[0], amp_ref[3]
    res["reference_fits_s"] = time.perf_counter() - t_ref
    npz = lambda name: dict(np.load(os.path.join(root, "abc", "fit_%s_rank0.npz" % name)))  # noqa
    got, got32 = npz(amp_fits[0]), npz("dist_device_sync")
    snap_of = lambda g: {k[5:]: v for k, v in g.items() if k.startswith("snap:")}  # noqa
    first_update = {"two_processes": _first_update_err(snap_of(got32), f32_ref),
                    "amp_two_processes_not_held": _first_update_err(snap_of(got), amp_ref)}
    if full:
        first_update["control_local_rescale"] = _first_update_err(
            snap_of(npz("dist_device_sync+localrescale")), f32_ref)
    if witness is not None:
        assert all(np.array_equal(witness[5][k], f32_ref[5][k]) for k in f32_ref[5])
        first_update["witness_one_process_no_cudnn"] = _first_update_err(witness[4], f32_ref)

    def errs(got, ref):
        """Of max: the weights and aux after the last step and after the first."""
        losses, arg, aux, _, snap, _ = ref
        pick = lambda pre: {k[len(pre):]: v for k, v in got.items() if k.startswith(pre)}  # noqa
        snap_w = {k: v for k, v in snap.items() if not k.startswith("aux:")}
        snap_a = {k[4:]: v for k, v in snap.items() if k.startswith("aux:")}
        return {"weights": _of_max(pick("arg:"), arg, arg), "aux": _of_max(pick("aux:"), aux, aux),
                "step1_weights": _of_max(pick("snap:"), snap_w, snap_w),
                "step1_aux": _of_max(pick("snapaux:"), snap_a, snap_a)}

    amp_err, f32_err = errs(got, amp_ref), errs(got32, f32_ref)
    l_errs = [abs(a - b) / abs(b) for a, b in zip(fits[0]["losses"], losses)]
    f32s = [r["fits"]["dist_device_sync"] for r in ranks]
    f32_l = [abs(a - b) / abs(b) for a, b in zip(f32s[0]["losses"], f32_ref[0])]
    res["b"] = {"steps": steps, "rows_a_rank": fits[0]["rows"],
                "buckets": fits[0]["buckets"], "losses": fits[0]["losses"],
                "one_process_losses": losses, "first_loss_rel_err": l_errs[0],
                "max_loss_rel_err": max(l_errs), "err_of_max": amp_err,
                "limits": {k: DIST[k] for k in ("first_loss", "losses", "f32", "update_rel",
                                                "held_ulps")},
                "first_update_rel_err": first_update,
                "ranks_bitwise_equal": True,
                "shard_bitwise_equal_to_replicated": (fits[0]["digests"] == reps[0]["digests"]
                                                      if reps else None),
                "launches_each_rank": fits[0]["launches"],
                "replicated_launches_each_rank": reps[0]["launches"] if reps else None,
                "step_ms_per_rank": [f["step_ms_median"] for f in fits],
                "replicated_step_ms_per_rank": [f["step_ms_median"] for f in reps],
                "one_process_step_ms": ref_ms,
                "collective_ms_per_step": [f["collective_ms_per_step"] for f in fits],
                "collective_bytes_per_step": fits[0]["collective_bytes_per_step"],
                "collectives_after_step_1": fits[0]["collectives_after_step_1"],
                "replicated_collective_ms_per_step": [f["collective_ms_per_step"] for f in reps],
                "replicated_collective_bytes_per_step": (reps[0]["collective_bytes_per_step"]
                                                         if reps else None),
                "peak_mem_gib_per_rank": [f.get("peak_mem_gib") for f in fits],
                "replicated_peak_mem_gib_per_rank": [f.get("peak_mem_gib") for f in reps],
                "profile_rank0": fits[0].get("profile"), "profile_rank1": fits[1].get("profile"),
                "f32": {"steps": DIST["f32_steps"], "err_of_max": f32_err,
                        "loss_rel_errs": f32_l, "losses": f32s[0]["losses"],
                        "one_process_losses": f32_ref[0],
                        "ranks_bitwise_equal": f32s[0]["digests"] == f32s[1]["digests"],
                        "step_ms_per_rank": [f["step_ms_median"] for f in f32s],
                        "one_process_step_ms": f32_ref[3],
                        "collective_ms_per_step": [f["collective_ms_per_step"] for f in f32s],
                        "collective_bytes_per_step": f32s[0]["collective_bytes_per_step"],
                        "peak_mem_gib_per_rank": [f.get("peak_mem_gib") for f in f32s],
                        "launches_each_rank": f32s[0]["launches"]}}
    log("phase 30 (b): %s" % json.dumps(res["b"]))
    if reps:
        assert res["b"]["shard_bitwise_equal_to_replicated"], "shard and replicated differ"
        assert reps[0]["launches"] == want, (reps[0]["launches"], want)
    assert l_errs[0] <= DIST["first_loss"], ("first loss", l_errs[0])
    assert max(l_errs) <= DIST["losses"], ("losses", l_errs)
    assert res["b"]["f32"]["ranks_bitwise_equal"]
    assert f32_l[0] <= DIST["f32"], ("f32 first loss", f32_l)
    assert f32_err["step1_aux"][0] <= DIST["f32"], ("f32 BatchNorm statistics, step 1",
                                                    f32_err["step1_aux"])
    for name, e in first_update.items():
        if name == "control_local_rescale":
            assert e["worst"][0] > DIST["update_rel"], ("the control passed the check", e)
        elif name != "amp_two_processes_not_held":
            assert e["worst"][0] <= DIST["update_rel"], ("f32 first update, " + name, e)
    want_f32 = {"conv_bwd_filter": RESNET_CONVS * DIST["f32_steps"],
                "conv_bwd_input": RESNET_CONVS * DIST["f32_steps"], "slab_update": 0}
    for f in f32s:
        assert f["launches"] == want_f32, (f["launches"], want_f32)

    # (c) the f32 dist_sync fit against one process over two contexts
    fits_c = [r["fits"]["dist_sync"] for r in ranks]
    steps_c = DIST["f32_steps"]
    want_c = {"conv_bwd_filter": RESNET_CONVS * steps_c, "conv_bwd_input": RESNET_CONVS * steps_c,
              "slab_update": 0}
    for f in fits_c:
        assert not f["fused"] and f["launches"] == want_c, (f["launches"], want_c)
    torch.backends.cudnn.deterministic = True
    try:
        losses_c, arg_c, aux_c, ref_ms_c, _, _ = _dist_reference_fit(mx, dev, "local", False,
                                                                     steps_c)
    finally:
        torch.backends.cudnn.deterministic = False
    got_c = [dict(np.load(os.path.join(root, "abc", "fit_dist_sync_rank%d.npz" % r)))
             for r in range(2)]
    wc = max(_of_max({k[4:]: v for k, v in g.items() if k.startswith("arg:")}, arg_c, arg_c)
             for g in got_c)
    mean_aux = {k[4:]: (got_c[0][k] + got_c[1][k]) / 2 for k in got_c[0] if k.startswith("aux:")}
    ac = _of_max(mean_aux, aux_c, aux_c)
    res["c"] = {"steps": steps_c, "max_weight_err_of_max": wc, "max_aux_err_of_max": ac,
                "limit": 1e-5, "losses": fits_c[0]["losses"], "one_process_losses": losses_c,
                "bucket_flushes_per_step": fits_c[0]["bucket_flushes_per_step"],
                "bucket_bytes_per_step": fits_c[0]["bucket_bytes_per_step"],
                "step_ms_per_rank": [f["step_ms_median"] for f in fits_c],
                "one_process_step_ms": ref_ms_c,
                "collective_ms_per_step": [f["collective_ms_per_step"] for f in fits_c],
                "peak_mem_gib_per_rank": [f.get("peak_mem_gib") for f in fits_c],
                "launches_each_rank": fits_c[0]["launches"]}
    log("phase 30 (c): %s" % json.dumps(res["c"]))
    assert wc[0] <= DIST["f32"] and ac[0] <= DIST["f32"], ("dist_sync against two contexts",
                                                          wc, ac)

    # (d) the elastic shrink (--only dist)
    if full:
        ckpt = os.path.join(root, "elastic_ckpt")
        if os.path.isdir(ckpt):
            import shutil

            shutil.rmtree(ckpt)
        proc_d, wall_d, ranks_d = _dist_launch(
            package, root, "d", ["--checks", "none", "--fit",
                                 "dist_sync:%d" % DIST["elastic_steps"], "--model", "mlp-bn",
                                 "--batch", str(DIST["elastic_batch"]), "--ckpt", ckpt],
            env={"MXTPU_FAULT_INJECT": "replica_lost=1@3", "MXTPU_ELASTIC_POLL": "0",
                 "MXTPU_CKPT_INTERVAL": "2"},
            watchdog=["--elastic", "--world", "2", "--max-restarts", "0"], timeout=600)
        text = proc_d.stdout + proc_d.stderr
        for needle in ("elastic shrink", "world 1 (was 2)", "exiting 76",
                       "resume: restored step 3"):
            assert needle in text, (needle, text[-6000:])
        assert ranks_d[0]["size"] == 1
        assert ranks_d[0]["fits"]["dist_sync"]["steps"] == DIST["elastic_steps"] - 3
        res["d"] = {"wall_s": wall_d, "losses_after_resume": ranks_d[0]["fits"]["dist_sync"][
            "losses"], "resumed_at_step": 3, "world_after": 1}
        log("phase 30 (d): %s" % json.dumps(res["d"]))
    res["launches"] = {n: sum(f["launches"][n] for f in fits + reps + f32s + fits_c)
                       for n in want}
    res["seconds"] = time.perf_counter() - t_phase
    log("phase 30: %.1f s" % res["seconds"])
    return res


AXES = dict(seq_len=2048, batch=4, steps=3, experts=8, first_loss=5e-3, grads=2e-2,
            step_tol=1e-6)
#: phase 31's MLP for tp-step: Megatron's specs over dp 1 x tp 2
AXES_SPECS = {"fc1_weight": ("tp", None), "fc1_bias": ("tp",), "fc2_weight": (None, "tp")}


def axes_lm_args(legs, profile=True):
    """dist_check's flags for the LM legs at the full width (FULL, bf16, T
    2048, batch 4): rank 0 writes the first step's gathered gradients."""
    dims = (FULL["vocab"], FULL["d_model"], FULL["n_heads"], FULL["n_layers"], FULL["d_ff"],
            AXES["seq_len"], AXES["batch"])
    return (["--lm", legs, "--lm-dims", ",".join(map(str, dims)), "--lm-steps",
             str(AXES["steps"]), "--lm-dtype", "bfloat16", "--lm-experts", str(AXES["experts"]),
             "--lm-save", "grads"] + (["--lm-profile"] if profile else []))


def _axes_mlp(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=1024, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=16, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def axes_step_blob(mx, path):
    """tp-step's blob: the MLP (512 -> 1024 -> 16), batch 64, 3 steps."""
    rng = np.random.RandomState(31)
    sym = _axes_mlp(mx)
    shapes = dict(zip(sym.list_arguments(), sym.infer_shape(data=(64, 512))[0]))
    blob = {"arg:" + n: rng.uniform(-0.05, 0.05, s).astype(np.float32)
            for n, s in shapes.items() if n not in ("data", "softmax_label")}
    blob.update(symbol=np.array(sym.tojson()), steps=3, local_ranks=1, lr=0.1, momentum=0.9,
                specs=np.array(json.dumps(AXES_SPECS)),
                data=rng.randn(3, 64, 512).astype(np.float32),
                label=rng.randint(0, 16, (3, 64)).astype(np.float32))
    np.savez(path, **blob)
    return blob


def axes_reference(trainer, tfm, dev, moe_experts):
    """One process's tp 1 run on the card at the legs' configuration and
    seed, one step: (loss, the gradients as a flat {path: array})."""
    got = {}

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + k + "/") if isinstance(v, dict) else {prefix + k: v})
        return out

    def on_grads(i, params):
        got["grads"] = flat(tfm.grads_to_jax(params))

    lm = trainer.transformer_lm
    trainer.transformer_lm = memo_lm(lm)
    try:
        losses = trainer.train(dtype="bfloat16", device=dev, steps=1, lr=3e-2,
                               seq_len=AXES["seq_len"], batch_size=AXES["batch"],
                               moe_experts=moe_experts, on_grads=on_grads,
                               log=lambda *a: None, **FULL)
    finally:
        trainer.transformer_lm = lm
    return losses[0], got["grads"]


def axes_leg(leg, ranks, root, ref):
    """Phase 31's checks of one LM leg across the two workers against the
    one-process run ``ref`` (loss, gradients)."""
    legs = [r["lm"][leg] for r in ranks]
    losses = legs[0]["losses"]
    assert legs[1]["losses"] == losses and len(losses) == AXES["steps"], legs
    assert all(np.isfinite(losses)), losses
    first = abs(losses[0] - ref[0]) / abs(ref[0])
    # the replicated leaves bit for bit across the ranks, the gathered ones too
    assert legs[0]["replicated_digests"] == legs[1]["replicated_digests"], leg
    assert legs[0]["digests"] == legs[1]["digests"], leg
    errs = {}
    with np.load(os.path.join(root, "lm_%s.npz" % leg)) as z:
        for key in z.files:
            w = ref[1][key[5:]]
            errs[key[5:]] = float(np.abs(z[key].astype(np.float64) - w).max()) / max(
                float(np.abs(w).max()), 1e-30)
    assert sorted(errs) == sorted(ref[1]), leg
    worst = max(errs.items(), key=lambda kv: kv[1])
    n_layers = FULL["n_layers"]
    pairs = 3 if leg == "sp" else 2  # the causal ring's live pairs over sp 2; one call else
    launches = [lg["launches"] for lg in legs]
    for name in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        total = sum(lc[name] for lc in launches)
        assert total == n_layers * pairs * AXES["steps"], (leg, name, launches)
        assert all(lc[name] > 0 for lc in launches), (leg, name, launches)
    held = legs[0]["shapes_held"]
    if leg == "tp":  # half of every tp-sharded weight in each process
        d, ff = FULL["d_model"], FULL["d_ff"]
        assert held["layers.0.wq"] == [d // 2, d] and held["layers.0.w2"] == [d, ff // 2], held
    if leg == "ep":
        assert held["layers.1.moe.w_up"][0] == AXES["experts"] // 2, held
    out = {"losses": losses, "one_process_loss": ref[0], "first_loss_rel_err": first,
           "grad_err_of_max_worst": list(worst), "grad_leaves": len(errs),
           "replicated_bitwise": True, "mesh": legs[0]["mesh"],
           "launches_per_worker": launches,
           "step_ms_per_rank": [lg["step_ms_median"] for lg in legs],
           "idle_share_per_rank": [lg.get("profile", {}).get("idle_share") for lg in legs],
           "busy_ms_per_rank": [lg.get("profile", {}).get("device_busy_ms") for lg in legs],
           "collective_ms_per_step": [lg["collective_ms_per_step"] for lg in legs],
           "collective_mb_per_step": legs[0]["collective_bytes_per_step"] / 1e6,
           "collectives_after_step_1": legs[0]["collectives_after_step_1"],
           "peak_gib_per_rank": [lg.get("peak_mem_gib") for lg in legs],
           "wall_s_per_rank": [lg["wall_s"] for lg in legs],
           "limits": {"first_loss": AXES["first_loss"], "grads": AXES["grads"]}}
    log("phase 31 %s: %s" % (leg, json.dumps({k: v for k, v in out.items()
                                               if k != "collectives_after_step_1"})))
    assert first <= AXES["first_loss"], (leg, "first loss", first)
    assert worst[1] <= AXES["grads"], (leg, "gradients", worst)
    return out


def axes_tp_step(mx, dev, ranks, root, blob):
    """tp-step: the two workers' ShardedTrainStep(param_specs) over dp 1 x
    tp 2 against one process's over a logical tp 2 mesh on the card."""
    import torch

    sym = _axes_mlp(mx)
    mesh = mx.parallel.make_mesh(dp=1, tp=2, devices=[dev] * 2)
    opt = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9, rescale_grad=1.0 / 64)
    step = mx.parallel.ShardedTrainStep(sym, mesh, optimizer=opt, param_specs=AXES_SPECS)
    params, aux = step.place_params({k[4:]: v for k, v in blob.items() if k.startswith("arg:")},
                                    {})
    state = step.make_state(params)
    for t in range(3):
        batch = {"data": torch.from_numpy(blob["data"][t]).to(dev),
                 "softmax_label": torch.from_numpy(blob["label"][t]).to(dev)}
        params, aux, state, _ = step(params, aux, state, batch, t=t + 1)
    got = dict(np.load(os.path.join(root, "step_tp-step_rank0.npz")))
    errs = {}
    for k, v in params.items():
        w = v.cpu().numpy()
        errs[k] = float(np.abs(got["arg:" + k] - w).max()) / max(float(np.abs(w).max()), 1e-30)
        errs["mom:" + k] = float(np.abs(got["mom:" + k] - state[k].cpu().numpy()).max())
    info = [r["steps"]["tp-step"] for r in ranks]
    out = {"err_of_max": errs, "limit": AXES["step_tol"],
           "shapes_held": info[0]["shapes_held"],
           "ranks_bitwise_equal": info[0]["digests"] == info[1]["digests"],
           "module_ckpt_files": ranks[0]["tp_module"]["ckpt_files"]}
    log("phase 31 tp-step: %s" % json.dumps(out))
    assert out["ranks_bitwise_equal"] and info[0]["shapes_held"]["fc1_weight"] == [512, 512]
    assert max(errs.values()) <= AXES["step_tol"], errs
    return out


def phase_axes(mx, trainer, tfm, dev, package, ranks=None):
    """Phase 31: the model axes across two worker processes on gpu(0) (see
    the module docstring). ``ranks``: phase 30's workers' JSON, whose job
    ran the tp leg; without it (``--only axes``) one launch runs the tp, sp
    and ep legs, the axes check and tp-step."""
    import torch

    t_phase = time.perf_counter()
    res = {"card": card_line()}
    root = os.path.join(package, "build", "chip_smoke_dist")
    legs = ["tp"]
    blob = None
    if ranks is None:
        os.makedirs(root, exist_ok=True)
        blob = axes_step_blob(mx, os.path.join(root, "axes_step.npz"))
        legs = ["tp", "sp", "ep"]
        _, wall, ranks = _dist_launch(package, root, "axes", [
            "--checks", "axes", "--step-test", "tp-step=%s" % os.path.join(root, "axes_step.npz")]
            + axes_lm_args(",".join(legs)))
        res["launch_wall_s"] = wall
        out = os.path.join(root, "axes")
    else:
        out = os.path.join(root, "abc")
    torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    dense = axes_reference(trainer, tfm, dev, 0)
    res["reference_s"] = time.perf_counter() - t_ref
    for leg in legs:
        ref = dense if leg != "ep" else axes_reference(trainer, tfm, dev, AXES["experts"])
        res[leg] = axes_leg(leg, ranks, out, ref)
    if blob is not None:
        res["axes_check"] = ranks[0]["axes"]
        res["tp_step"] = axes_tp_step(mx, dev, ranks, out, blob)
    res["launches"] = {name: sum(lc[name] for leg in legs
                                 for lc in res[leg]["launches_per_worker"])
                       for name in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")}
    res["seconds"] = time.perf_counter() - t_phase
    log("phase 31: %.1f s" % res["seconds"])
    return res


#: phase 31's pp leg: the LM's blocks in ``stages`` stages over that many
#: processes, dist_check's PP_MICRO microbatches of one row (AXES' width, T
#: and steps); --only pp adds pp 4 over 4 processes at ``small`` (vocab,
#: d_model, heads, layers, d_ff, T, batch)
PP = dict(stages=2, first_loss=5e-3, grads=2e-2,
          small=(32000, 512, 8, 8, 2048, 1024, 4), small_stages=4)


def pp_args(dims=None):
    """dist_check's flags for the pp leg (``--lm-*`` are the tp leg's when
    they ride one launch)."""
    args = ["--pp-test"]
    if dims is not None:
        args += ["--lm-dims", ",".join(map(str, dims)), "--lm-steps", str(AXES["steps"]),
                 "--lm-dtype", "bfloat16", "--lm-profile"]
    return args


def pp_full_dims():
    return (FULL["vocab"], FULL["d_model"], FULL["n_heads"], FULL["n_layers"], FULL["d_ff"],
            AXES["seq_len"], AXES["batch"])


def pp_reference(dist_check, dev, dims, stages):
    """One process's pipeline over ``stages`` logical pp ranks on the card
    (``pipeline_stages``' tick schedule), one step: (loss, each stage
    leaf's gradient as numpy [S, blocks, ...], and the embedding's and the
    final norm's, which the workers sum over pp)."""
    import torch

    torch.cuda.empty_cache()
    lm = dist_check.pp_lm(dims, "bfloat16", dev, stages)
    loss = lm.loss_for({"pp": stages})()
    loss.backward()
    grads = {k: v.grad.float().cpu().numpy() for k, v in lm.stages.items()}
    grads.update(embed=lm.embed.grad.float().cpu().numpy(),
                 ln_f=lm.ln_f.grad.float().cpu().numpy())
    out = (loss.item(), grads)
    del lm, loss
    torch.cuda.empty_cache()
    return out


def pp_leg(ranks, out_dir, ref, stages, micro, dims):
    """The pp leg's checks across the workers against the one-process run
    ``ref``: the first loss, each stage leaf's first-step gradient and the
    replicated leaves' (rank 0's, summed over pp), every rank's losses
    equal, the K4 launches each worker's stages make."""
    legs = [r["pp_lm"] for r in ranks]
    losses = legs[0]["losses"]
    assert all(lg["losses"] == losses for lg in legs) and len(losses) == AXES["steps"], legs
    assert all(np.isfinite(losses)), losses
    first = abs(losses[0] - ref[0]) / abs(ref[0])
    errs = {}
    for r in range(stages):
        with np.load(os.path.join(out_dir, "pp_lm_rank%d.npz" % r)) as z:
            for k, want in ref[1].items():
                whole = k in ("embed", "ln_f")
                if whole and r:
                    continue
                got = z["grad:" + k].astype(np.float64)
                w = want if whole else want[r:r + 1]
                name = k if whole else "%s stage %d" % (k, r)
                errs[name] = float(np.abs(got - w).max()) / max(float(np.abs(w).max()), 1e-30)
    worst = max(errs.items(), key=lambda kv: kv[1])
    per = dims[3] // stages
    launches = [lg["launches"] for lg in legs]
    for name in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        for lc in launches:  # each worker's blocks, each microbatch, each step
            assert lc[name] == per * micro * AXES["steps"], (name, launches)
    out = {"stages": stages, "micro": micro, "dims": list(dims), "losses": losses,
           "one_process_loss": ref[0], "first_loss_rel_err": first,
           "first_loss_bitwise": losses[0] == ref[0],
           "grad_err_of_max_worst": list(worst), "grad_leaves": len(errs),
           "launches_per_worker": launches,
           "launches_a_step_per_worker": [{k: v // AXES["steps"] for k, v in lc.items()}
                                          for lc in launches],
           "step_ms_per_rank": [lg["step_ms_median"] for lg in legs],
           "idle_share_per_rank": [lg.get("profile", {}).get("idle_share") for lg in legs],
           "busy_ms_per_rank": [lg.get("profile", {}).get("device_busy_ms") for lg in legs],
           "permute_ms_per_step": [lg["permute_ms_per_step"] for lg in legs],
           "permute_mb_per_step": [lg["permute_bytes_per_step"] / 1e6 for lg in legs],
           "allreduce_ms_per_step": [lg["allreduce_ms_per_step"] for lg in legs],
           "allreduce_mb_per_step": legs[0]["allreduce_bytes_per_step"] / 1e6,
           "peak_gib_per_rank": [lg.get("peak_mem_gib") for lg in legs],
           "wall_s_per_rank": [lg["wall_s"] for lg in legs],
           "limits": {"first_loss": PP["first_loss"], "grads": PP["grads"]}}
    log("phase 31 pp %d: %s" % (stages, json.dumps(out)))
    assert first <= PP["first_loss"], ("pp first loss", first)
    assert worst[1] <= PP["grads"], ("pp gradients", worst)
    return out


def phase_pp(dev, package, ranks=None):
    """Phase 31's pp leg: the LM as a pipeline over two worker processes on
    gpu(0) (see the module docstring). ``ranks``: phase 30's workers' JSON,
    whose job ran it; without it (``--only pp``) a launch of its own, the
    axis check, and pp 4 over 4 processes at a smaller width."""
    from mxnet_tpu_torch.tools import dist_check

    t_phase = time.perf_counter()
    res = {"card": card_line()}
    root = os.path.join(package, "build", "chip_smoke_dist")
    dims = pp_full_dims()
    if ranks is None:
        os.makedirs(root, exist_ok=True)
        _, wall, ranks = _dist_launch(package, root, "pp", ["--checks", "pp"] + pp_args(dims))
        res["launch_wall_s"] = wall
        res["pp_check"] = ranks[0]["pp"]
        out = os.path.join(root, "pp")
    else:
        out = os.path.join(root, "abc")
    t_ref = time.perf_counter()
    ref = pp_reference(dist_check, dev, dims, PP["stages"])
    res["reference_s"] = time.perf_counter() - t_ref
    res["pp2"] = pp_leg(ranks, out, ref, PP["stages"], dist_check.PP_MICRO, dims)
    launches = {name: sum(lc[name] for lc in res["pp2"]["launches_per_worker"])
                for name in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")}
    if "launch_wall_s" in res:  # --only pp: pp 4 over 4 processes
        n = PP["small_stages"]
        _, wall4, ranks4 = _dist_launch(package, root, "pp4", pp_args(PP["small"]), n=n)
        ref4 = pp_reference(dist_check, dev, PP["small"], n)
        res["pp4"] = pp_leg(ranks4, os.path.join(root, "pp4"), ref4, n, dist_check.PP_MICRO,
                            PP["small"])
        res["pp4"]["launch_wall_s"] = wall4
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    log("phase 31 pp: %.1f s" % res["seconds"])
    return res


#: phase 32: lenet.cpp's training steps (25 epochs of 15 batches) and its
#: second convolution, the one in K2 / K3's envelope (8 -> 16 channels,
#: 3 x 3, pad 1, on the 4 x 4 maps of batch 100)
CPP = dict(lenet_steps=25 * 15, lenet_conv=((100, 8, 4, 4), (16, 8, 3, 3), (1, 1)),
           timeout=600)


def _cpp_run(binary, args, package):
    t0 = time.perf_counter()
    proc = subprocess.run([binary] + args, capture_output=True, text=True, cwd=package,
                          env=dict(os.environ, PYTHONPATH=package), timeout=CPP["timeout"])
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError("phase 32: %s exit %d\n%s\n%s" % (
            os.path.basename(binary), proc.returncode, proc.stdout[-3000:], proc.stderr[-5000:]))
    return proc.stdout, seconds


def phase_cpp(package):
    """Phase 32: the C++ frontend built with make and its two examples run
    on gpu(0) (see the module docstring)."""
    import sysconfig

    t_phase = time.perf_counter()
    inc = sysconfig.get_config_var("INCLUDEPY")
    if not os.path.exists(os.path.join(inc or "", "Python.h")):
        raise AssertionError("phase 32: no Python.h under %r: the C++ frontend needs the "
                             "CPython headers" % inc)
    build = os.path.join(package, "build", "cpp")
    t0 = time.perf_counter()
    proc = subprocess.run(["make", "-C", os.path.join(package, "mxnet_tpu_torch", "cpp"),
                           "BUILD=" + build], capture_output=True, text=True, timeout=300)
    build_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError("phase 32: make exit %d\n%s\n%s" % (proc.returncode,
                                                                proc.stdout[-3000:],
                                                                proc.stderr[-5000:]))
    out, mlp_s = _cpp_run(os.path.join(build, "train_mlp"), ["--out", build], package)
    nums = dict(re.findall(r"^([\w-]+): ([0-9.]+)$", out, re.M))
    mlp = {"final_accuracy": float(nums["final-accuracy"]),
           "reload_accuracy": float(nums["reload-accuracy"]),
           "predictor_accuracy": float(nums["predictor-accuracy"]),
           "checkpoint_roundtrip": re.search(r"checkpoint-roundtrip: (\w+)", out).group(1),
           "context": re.search(r"context: (\S+)", out).group(1), "seconds": mlp_s}
    out, lenet_s = _cpp_run(os.path.join(build, "lenet"), [], package)
    counts = {k: int(v) for k, v in re.findall(r"(\w+)=(\d+)", out.split("kernel-launches:")[1])}
    lenet = {"accuracy": float(re.search(r"lenet val-accuracy: ([0-9.]+)", out).group(1)),
             "context": re.search(r"context: (\S+)", out).group(1), "launches": counts,
             "seconds": lenet_s}
    res = {"card": card_line(), "build_s": build_s, "train_mlp": mlp, "lenet": lenet}
    log("phase 32: %s" % json.dumps(res))
    assert mlp["context"] == lenet["context"] == "gpu(0)", res
    assert mlp["final_accuracy"] > 0.90 and mlp["checkpoint_roundtrip"] == "exact", mlp
    assert mlp["predictor_accuracy"] == mlp["final_accuracy"], mlp
    assert lenet["accuracy"] > 0.90, lenet
    for name in ("conv_bwd_filter", "conv_bwd_input"):
        assert counts[name] == CPP["lenet_steps"], (name, counts)
    res["launches"] = {name: counts[name] for name in ("conv_bwd_filter", "conv_bwd_input")}
    res["seconds"] = time.perf_counter() - t_phase
    return res


#: phase 33: the root examples at the settings of their smokes in
#: tests/test_examples_smoke.py (or of their docstrings), in-process on
#: gpu(0); stochastic_depth's blocks are the examples' only convolutions in
#: K2 / K3's envelope
EXAMPLES = {
    "train_mnist": ["--num-epochs", "1"],
    "svm_digits": [],
    "autoencoder": ["--num-epochs", "3"],
    "multi_task": ["--num-epochs", "8"],
    "adversary_fgsm": ["--num-epochs", "4"],
    "stochastic_depth": ["--min-acc", "0.8"],
    "cnn_text_classification": ["--num-epochs", "4", "--min-acc", "0.75"],
    "numpy_ops": [],
    "matrix_factorization": ["--num-epochs", "8"],
    "nce_loss": ["--num-epochs", "6"],
    "char_lstm": ["--num-epochs", "2", "--sample-chars", "25", "--num-hidden", "64"],
    "bi_lstm_sort": ["--num-epochs", "3", "--num-samples", "1500", "--min-acc", "0.3"],
    "bayesian_sgld": [],
    "dec_clustering": ["--num-epochs", "15", "--refine-rounds", "3", "--lr", "0.001"],
    "reinforce_gridworld": ["--iters", "35"],
    "train_gan": ["--steps", "400"],
}
#: K2 / K3 launches of stochastic_depth's run: 22 epochs of 15 batches, six
#: in-envelope convolutions a step
SD_LAUNCHES = 22 * 15 * 6
CAFFE_TOL = 1e-5  # the converted model's forward on gpu(0) against the host's, of max


def example_conv_cases(mx):
    """{(data, weight, pad): convolutions of that shape a step} of the
    examples' in-envelope convolutions (from infer_shape at their batch)
    and lenet.cpp's second convolution."""
    import argparse as _argparse
    from importlib import import_module

    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.ops import kernels

    ex = lambda name: import_module("mxnet_tpu_torch.examples." + name)  # noqa: E731
    syms = [(ex("stochastic_depth").build(3, 0.75, True), (100, 1, 8, 8)),
            (ex("adversary_fgsm").build_net(), (100, 1, 8, 8)),
            (ex("cnn_text_classification").build_sym(16, 32, 0.25), (100, 20)),
            (ex("train_mnist").get_symbol(_argparse.Namespace(network="lenet")),
             (64, 1, 28, 28))]
    cases = {CPP["lenet_conv"]: 1}
    for sym, shape in syms:
        for layer in resnet.conv_layers(sym, shape):
            if kernels.conv_bwd_plan(layer["data"], layer["weight"], layer["stride"],
                                     layer["pad"], layer["dilate"], "float32"):
                key = (layer["data"], layer["weight"], layer["pad"])
                cases[key] = cases.get(key, 0) + 1
    return cases


def _pb_varint(x):
    out = b""
    while True:
        b, x = x & 0x7F, x >> 7
        if not x:
            return out + bytes([b])
        out += bytes([b | 0x80])


def _pb_ld(field, payload):
    return _pb_varint((field << 3) | 2) + _pb_varint(len(payload)) + payload


def _pb_blob(arr):
    import struct

    arr = np.asarray(arr, np.float32)
    shape = _pb_ld(7, _pb_ld(1, b"".join(_pb_varint(int(v)) for v in arr.shape)))
    return shape + _pb_ld(5, struct.pack("<%df" % arr.size, *arr.reshape(-1).tolist()))


def _pb_layer(name, ltype, blobs):
    payload = _pb_ld(1, name.encode()) + _pb_ld(2, ltype.encode())
    return _pb_ld(100, payload + b"".join(_pb_ld(7, _pb_blob(b)) for b in blobs))


CAFFE_PROTOTXT = """
name: "tiny"
input: "data"
input_dim: 2 input_dim: 3 input_dim: 8 input_dim: 8
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 8 kernel_size: 3 pad: 1 stride: 1 } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "bn1" type: "BatchNorm" bottom: "pool1" top: "bn1"
  batch_norm_param { use_global_stats: true eps: 1e-5 } }
layer { name: "scale1" type: "Scale" bottom: "bn1" top: "bn1"
  scale_param { bias_term: true } }
layer { name: "fc1" type: "InnerProduct" bottom: "bn1" top: "fc1"
  inner_product_param { num_output: 5 } }
layer { name: "prob" type: "Softmax" bottom: "fc1" top: "prob" }
"""


def caffe_check(mx, root):
    """The Caffe converter on a hand-encoded model (the protobuf wire format
    written here, independent of the converter's reader): its forward on
    gpu(0) against the host's."""
    from mxnet_tpu_torch.tools import caffe_converter as cc

    rng = np.random.RandomState(0)
    net = (_pb_ld(1, b"tiny")
           + _pb_layer("conv1", "Convolution", [rng.randn(8, 3, 3, 3) * 0.3, rng.randn(8) * 0.1])
           + _pb_layer("bn1", "BatchNorm", [rng.randn(8) * 0.4, rng.rand(8) + 1.0, [2.0]])
           + _pb_layer("scale1", "Scale", [rng.rand(8) + 0.5, rng.randn(8) * 0.1])
           + _pb_layer("fc1", "InnerProduct", [rng.randn(5, 8 * 4 * 4) * 0.1, rng.randn(5) * 0.1]))
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "tiny.prototxt"), "w") as fh:
        fh.write(CAFFE_PROTOTXT)
    with open(os.path.join(root, "tiny.caffemodel"), "wb") as fh:
        fh.write(net)
    sym, args, auxs = cc.convert_model(os.path.join(root, "tiny.prototxt"),
                                       os.path.join(root, "tiny.caffemodel"),
                                       os.path.join(root, "tiny"))
    x = rng.randn(2, 3, 8, 8).astype(np.float32)
    host, card = [], []
    for ctx, out in ((mx.cpu(), host), (mx.gpu(0), card)):
        with ctx:
            exe = sym.simple_bind(ctx=ctx, data=(2, 3, 8, 8))
            for k, v in list(args.items()) + list(auxs.items()):
                (exe.arg_dict if k in exe.arg_dict else exe.aux_dict)[k][:] = v.asnumpy()
            exe.arg_dict["data"][:] = x
            out.append(exe.forward(is_train=False)[0].asnumpy())
    host, card = host[0], card[0]
    err = float(np.abs(card - host).max()) / float(np.abs(host).max())
    res = {"args": len(args), "auxs": len(auxs), "out_shape": list(card.shape),
           "gpu_vs_cpu_err_of_max": err, "limit": CAFFE_TOL}
    assert err <= CAFFE_TOL and np.all(np.isfinite(card)), res
    return res


def _summary(res):
    """An example's result without its arrays."""
    return {k: v for k, v in res.items() if isinstance(v, (int, float, str, bool))}


def phase_examples(mx, kernels, dev, package):
    """Phase 33: the root examples in-process on gpu(0), K2 / K3 against
    their plain versions on the examples' in-envelope shapes, and the Caffe
    converter (see the module docstring)."""
    import torch
    from importlib import import_module

    t_phase = time.perf_counter()
    res = {"card": card_line()}
    cases = example_conv_cases(mx)
    worst, errs = conv_checks(kernels, [(key, (torch.float32,)) for key in cases], dev,
                              np.random.default_rng(33))
    res["conv_checks"] = {"worst": worst, "rows": conv_time_rows(
        kernels, cases, (torch.float32,), dev, errs, np.random.default_rng(34))}
    log("phase 33: K2 / K3 vs plain on the examples' shapes %s, worst %s"
        % (sorted(cases), json.dumps(worst)))
    launches = {"conv_bwd_filter": 0, "conv_bwd_input": 0}
    runs = {}
    for name in EXAMPLES:
        ex = import_module("mxnet_tpu_torch.examples." + name)
        zero_counts(kernels)
        t0 = time.perf_counter()
        if name == "train_gan":
            np.random.seed(0)
            samples = ex.train(steps=int(EXAMPLES[name][1]), log=None, ctx=mx.gpu(0))
            assert samples.shape == (512, 2) and np.all(np.isfinite(samples)), samples
            out = {"mean": samples.mean(axis=0).tolist()}
        else:
            with mx.gpu(0):
                out = _summary(ex.run(ex.parse_args(EXAMPLES[name])))
        torch.cuda.synchronize()
        got = conv_counts(kernels)
        out.update(seconds=time.perf_counter() - t0, launches=got)
        for k in launches:
            launches[k] += got[k]
        runs[name] = out
        log("phase 33 %s: %s" % (name, json.dumps(out)))
    assert runs["stochastic_depth"]["launches"] == {
        "conv_bwd_filter": SD_LAUNCHES, "conv_bwd_input": SD_LAUNCHES}, runs
    res["examples"] = runs
    res["caffe"] = caffe_check(mx, os.path.join(package, "build", "chip_smoke_caffe"))
    log("phase 33 caffe: %s" % json.dumps(res["caffe"]))
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    log("phase 33: %.1f s" % res["seconds"])
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every phase's numbers to this JSON file")
    ap.add_argument("--package", help="import mxnet_tpu_torch from this checkout instead of the "
                    "one beside this script (to run this script's phases on another tree)")
    ap.add_argument("--only", choices=("f32_lm", "rtc", "slab", "zoo", "multistep", "serving",
                                       "resilience", "input", "rnn", "mirror", "parallel",
                                       "telemetry", "detection", "dist", "axes", "pp", "cpp",
                                       "examples"),
                    help="f32_lm: build, phase 19 and phase 8's attention kernel times only; "
                    "rtc: K5's push path on ResNet-50's parameter arrays only; slab: K1's "
                    "build, phases 16-18 and K1's times only; zoo: K2/K3's build and "
                    "all of phase 20; multistep: K1-K3's build and phase 21 only; serving: "
                    "the flash forward's build and phase 22 only (on a package without "
                    "predict, only (d) and its continuations' digest); resilience: K1-K3's "
                    "build and phase 23 only; input: K1-K3's build and phase 24 only; rnn: the "
                    "flash kernels' build and phase 25 only; mirror: K1-K3's build and phase "
                    "26 with its memory / ms sweep; parallel: the flash kernels' build and "
                    "phase 27 with (a)'s f32 sweep and (b)'s sp 1 and dense runs; telemetry: "
                    "K1-K3's build and phase 28 with (c), (d) and (f); detection: K1-K3's and "
                    "the NMS kernel's build and phase 29; dist: K1-K3's build and phase 30 "
                    "with (d), the elastic shrink; axes: the flash kernels' build and phase "
                    "31 with the sp and ep legs, the axes check and tp-step; pp: the flash "
                    "kernels' build and phase 31's pp leg in a launch of its own, with the pp "
                    "axis check and pp 4 over 4 processes; cpp: K2/K3's build and phase 32; "
                    "examples: K2/K3's build and phase 33")
    ap.add_argument("--resilience-worker", metavar="SPEC", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    package = os.path.abspath(args.package or os.path.dirname(os.path.abspath(__file__)))
    if args.resilience_worker:
        return resilience_worker(json.loads(args.resilience_worker))
    sys.path.insert(0, package)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc_kernels as rk
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.examples import train_transformer_lm as trainer
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.models import transformer as tfm
    from mxnet_tpu_torch.ops import _build, kernels
    from mxnet_tpu_torch.serving import GenerationEngine
    from mxnet_tpu_torch.tools import model_sweep, resnet_bench

    # f32 products stay f32 (no TF32) in the plain versions and the f32 model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log("card: %s | torch %s, CUDA %s" % (card, torch.__version__, torch.version.cuda))

    results = {"card": card, "package": os.path.dirname(os.path.abspath(mx.__file__))}
    if args.only == "rtc":
        results["rtc_push"] = phase_rtc_push(mx, rk, resnet, dev)
    if args.only == "f32_lm":
        t0 = time.perf_counter()
        _build.build()
        results["build_s"] = time.perf_counter() - t0
        results["training_f32_full"] = phase_train_lm(trainer, kernels, dev, "float32",
                                                      lm_family)
        f32_launches = dict(results["training_f32_full"]["launches"])
        bf16_launches = dict.fromkeys(f32_launches, 0)
        results["kernels"] = (
            phase_kernel_times(kernels, dev, 0, f32_launches["flash_attn_fwd"])
            + phase_bwd_times(kernels, dev, bf16_launches, f32_launches))
    if args.only == "slab":
        t0 = time.perf_counter()
        _build.build(["slab_update"])
        results["build_s"] = time.perf_counter() - t0
        phase_slab_path(mx, resnet, kernels, dev, results)
        results["kernels"] = [results.pop("k1_entry")]
    if args.only == "zoo":
        t0 = time.perf_counter()
        _build.build(["conv_bwd_filter"])
        results["build_s"] = time.perf_counter() - t0
        results["zoo"], results["zoo_launches"] = phase_zoo(model_sweep, kernels, dev)
    if args.only == "multistep":
        t0 = time.perf_counter()
        _build.build(["conv_bwd_filter", "slab_update"])
        results["build_s"] = time.perf_counter() - t0
        results["multistep"] = phase_multistep(mx, kernels, dev)
    if args.only == "serving":
        t0 = time.perf_counter()
        _build.build(["flash_attn_fwd"])
        results["build_s"] = time.perf_counter() - t0
        results["serving"] = phase_serving(mx, resnet, tfm, kernels, telemetry,
                                           GenerationEngine, dev)
        log("phase 22 (d) digest: %s" % results["serving"]["d"]["digest"])
    if args.only == "resilience":
        t0 = time.perf_counter()
        _build.build(["conv_bwd_filter", "slab_update"])
        results["build_s"] = time.perf_counter() - t0
        results["resilience"] = phase_resilience(mx, kernels, dev, package,
                                                 resnet50_amp_plan(mx, resnet))
    if args.only == "input":
        t0 = time.perf_counter()
        _build.build(["conv_bwd_filter", "slab_update"])
        results["build_s"] = time.perf_counter() - t0
        results["input"] = phase_input(mx, kernels, dev, package)
    if args.only == "rnn":
        t0 = time.perf_counter()
        _build.build(["flash_attn_fwd", "flash_split", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"])
        results["build_s"] = time.perf_counter() - t0
        results["rnn"] = phase_rnn(mx, kernels, dev)
    if args.only == "mirror":
        t0 = time.perf_counter()
        _build.build(["conv_bwd_filter", "slab_update"])
        results["build_s"] = time.perf_counter() - t0
        results["mirror"] = phase_mirror(mx, kernels, dev, full=True)
    if args.only == "parallel":
        t0 = time.perf_counter()
        _build.build(["flash_attn_fwd", "flash_split", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"])
        results["build_s"] = time.perf_counter() - t0
        results["parallel"] = phase_parallel(mx, tfm, trainer, kernels, GenerationEngine, dev,
                                             full=True)
    if args.only == "telemetry":
        t0 = time.perf_counter()
        _build.build(["conv_bwd_filter", "slab_update"])
        results["build_s"] = time.perf_counter() - t0
        results["telemetry"] = phase_telemetry(mx, kernels, dev, telemetry, package, full=True)
    if args.only == "detection":
        t0 = time.perf_counter()
        _build.build(["conv_bwd_filter", "slab_update", "nms"])
        results["build_s"] = time.perf_counter() - t0
        results["detection"] = det = phase_detection(mx, kernels, dev)
        print(json.dumps({"kernels": [nms_entry(det)]}))
    if args.only == "dist":
        t0 = time.perf_counter()
        _build.build(["conv_bwd_filter", "slab_update"])
        results["build_s"] = time.perf_counter() - t0
        results["dist"] = phase_dist(mx, kernels, dev, package, full=True)
        results["dist"].pop("ranks")
    if args.only == "axes":
        t0 = time.perf_counter()
        _build.build(["flash_attn_fwd", "flash_split", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"])
        results["build_s"] = time.perf_counter() - t0
        results["axes"] = phase_axes(mx, trainer, tfm, dev, package)
    if args.only == "pp":
        t0 = time.perf_counter()
        _build.build(["flash_attn_fwd", "flash_split", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"])
        results["build_s"] = time.perf_counter() - t0
        results["pp"] = phase_pp(dev, package)
    if args.only == "cpp":
        t0 = time.perf_counter()
        _build.build(["conv_bwd_filter"])
        results["build_s"] = time.perf_counter() - t0
        results["cpp"] = phase_cpp(package)
    if args.only == "examples":
        t0 = time.perf_counter()
        _build.build(["conv_bwd_filter"])
        results["build_s"] = time.perf_counter() - t0
        results["examples"] = phase_examples(mx, kernels, dev, package)
    if args.only:
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(results, fh, indent=1)
        print(card)
        return 0
    phase_s = results["phase_seconds"] = {}
    t_last = [time.perf_counter()]

    def mark(name):
        """The seconds since the last mark, as phase ``name``'s."""
        now = time.perf_counter()
        phase_s[name] = now - t_last[0]
        t_last[0] = now

    results["build_s"], results["sass"] = phase_build(_build)
    mark("build")
    results["kernel_checks"] = phase_kernel_checks(kernels, dev)
    mark("kernel_checks")
    results["bwd_kernel_checks"] = phase_bwd_checks(kernels, dev)
    mark("bwd_kernel_checks")
    results["serving_f32"] = phase_serving_f32(tfm, kernels, dev)
    mark("serving_f32")
    results["training_f32"] = phase_train_f32(tfm, trainer, kernels, dev)
    mark("training_f32")
    results["serving_bf16"] = phase_serving_bf16(tfm, kernels, telemetry, GenerationEngine, dev)
    mark("serving_bf16")
    results["training_bf16"] = phase_train_lm(trainer, kernels, dev, "bfloat16")
    train_launches = results["training_bf16"]["launches"]
    mark("training_bf16")
    results["training_f32_full"] = phase_train_lm(trainer, kernels, dev, "float32",
                                                  lm_family)
    mark("training_f32_full")
    results["conv_checks"], conv_errs = phase_conv_checks(kernels, resnet, dev)
    mark("conv_checks")
    results["resnet_grads_f32"] = phase_resnet_grads_f32(resnet_bench, kernels, dev)
    mark("resnet_grads_f32")
    results["resnet_train"] = [phase_resnet_train(resnet_bench, kernels, dev, dtype)
                               for dtype in ("float32", "bfloat16")]
    conv_launches = {name: sum(r["launches"][name] for r in results["resnet_train"])
                     for name in ("conv_bwd_filter", "conv_bwd_input")}
    mark("resnet_train")
    results["rtc"] = phase_rtc(mx, rk, dev)
    # cuDNN's default backward algorithms for the strided convolutions sum
    # in an order that changes from run to run; phases 14 and 15 compare two
    # runs of one computation, so they take its deterministic algorithms
    torch.backends.cudnn.deterministic = True
    mark("rtc")
    results["executor"] = phase_executor(mx, resnet, resnet_bench, kernels, dev)
    mark("executor")
    results["rtc_training"], rtc_runs = phase_rtc_training(mx, rk, resnet, resnet_bench, kernels,
                                                          dev)
    torch.backends.cudnn.deterministic = False
    conv_launches = {name: conv_launches[name] + results["rtc_training"]["launches"][name]
                     for name in conv_launches}
    phase_slab_path(mx, resnet, kernels, dev, results)
    conv_launches = {name: conv_launches[name] + results["fit_resnet_amp"]["launches"][name]
                     for name in conv_launches}
    mark("rtc_training_and_slab")
    results["zoo"], zoo_launches = phase_zoo(model_sweep, kernels, dev, full=False)
    conv_launches = {name: conv_launches[name] + zoo_launches[name] for name in conv_launches}
    mark("zoo")
    results["multistep"] = multi = phase_multistep(mx, kernels, dev, full=False)
    mark("multistep")
    results["serving"] = phase_serving(mx, resnet, tfm, kernels, telemetry, GenerationEngine, dev)
    mark("serving")
    results["resilience"] = resil = phase_resilience(mx, kernels, dev, package,
                                                     resnet50_amp_plan(mx, resnet), full=False)
    mark("resilience")
    results["input"] = inp = phase_input(mx, kernels, dev, package, measure=False)
    mark("input")
    results["rnn"] = rnn = phase_rnn(mx, kernels, dev)
    mark("rnn")
    results["mirror"] = mirror = phase_mirror(mx, kernels, dev)
    mark("mirror")
    results["parallel"] = par = phase_parallel(mx, tfm, trainer, kernels, GenerationEngine, dev)
    mark("parallel")
    results["telemetry"] = tele = phase_telemetry(mx, kernels, dev, telemetry, package)
    mark("telemetry")
    results["detection"] = det = phase_detection(mx, kernels, dev)
    mark("detection")
    results["dist"] = dist = phase_dist(mx, kernels, dev, package,
                                        extra=axes_lm_args("tp") + pp_args())
    mark("dist")
    ranks = dist.pop("ranks")
    results["axes"] = axes = phase_axes(mx, trainer, tfm, dev, package, ranks)
    mark("axes")
    results["pp"] = pp = phase_pp(dev, package, ranks)
    mark("pp")
    results["cpp"] = cpp = phase_cpp(package)
    mark("cpp")
    results["examples"] = examples = phase_examples(mx, kernels, dev, package)
    mark("examples")
    log("phase seconds: %s" % json.dumps({k: round(v, 1) for k, v in phase_s.items()}))
    dist_launches = dist["launches"]  # phase 30 (b)-(c): both ranks' wrappers
    det_launches = det["launches"]  # phase 29 (c)-(e): the detection path's wrappers
    tele_launches = tele["launches"]  # phase 28 (a)'s wrapper counts and (b)'s profiled replays
    par_launches = par["launches"]  # phase 27 (b)'s sp 4 training and (c)'s sp 4 engine
    mirror_launches = mirror["launches"]
    multi_launches = multistep_launches(multi)
    resil_launches = resil["launches_resumed_runs"]
    input_launches = inp["launches"]
    cpp_launches = cpp["launches"]  # phase 32: the C++ lenet's process
    ex_launches = examples["launches"]  # phase 33: the examples' runs
    conv_launches = {name: conv_launches[name] + multi_launches[name] + resil_launches[name]
                     + input_launches[name] + mirror_launches[name] + tele_launches[name]
                     + det_launches[name] + dist_launches[name] + cpp_launches[name]
                     + ex_launches[name] for name in conv_launches}
    k1 = results["k1_entry"]
    k1["launches_by_path"]["multistep"] = multi_launches["slab_update"]
    k1["launches_by_path"]["resilience"] = resil_launches["slab_update"]
    k1["launches_by_path"]["input"] = input_launches["slab_update"]
    k1["launches_by_path"]["mirror"] = mirror_launches["slab_update"]
    k1["launches_by_path"]["telemetry"] = tele_launches["slab_update"]
    k1["launches_by_path"]["detection"] = det_launches["slab_update"]
    k1["launches_by_path"]["dist"] = dist_launches["slab_update"]
    k1["launches"] += (multi_launches["slab_update"] + resil_launches["slab_update"]
                       + input_launches["slab_update"] + mirror_launches["slab_update"]
                       + tele_launches["slab_update"] + det_launches["slab_update"]
                       + dist_launches["slab_update"])
    # the f32 kernels' launches in phases 4, 5 and 19
    f32_launches = {name: n + results["training_f32_full"]["launches"][name]
                    for name, n in results["training_f32"]["launches"].items()}
    f32_launches["flash_attn_fwd"] += results["serving_f32"]["launches"]
    fwd = phase_kernel_times(kernels, dev, results["serving_bf16"]["flash_launches"],
                             f32_launches["flash_attn_fwd"])
    # the forward kernel runs on the serving, training and rnn paths; serving
    # counts phase 6's and phase 22's prefills
    serve_launches = fwd[0]["launches"] + results["serving"]["d"]["flash_launches"]
    rnn_launches = rnn["launches"]  # phase 25 (c): f32 kernels, on the rnn path
    axes_launches = axes["launches"]  # phase 31: both workers' tp leg
    pp_launches = pp["launches"]  # phase 31: both workers' pp leg
    fwd[0]["launches_by_path"] = {"serving": serve_launches,
                                  "training": train_launches["flash_attn_fwd"],
                                  "rnn": rnn_launches["flash_attn_fwd"],
                                  "parallel": par_launches["flash_attn_fwd"],
                                  "axes": axes_launches["flash_attn_fwd"],
                                  "pp": pp_launches["flash_attn_fwd"]}
    fwd[0]["launches"] = sum(fwd[0]["launches_by_path"].values())
    bwd = phase_bwd_times(kernels, dev, train_launches, f32_launches)
    for entry in bwd:
        entry["launches_by_path"] = {"training": entry["launches"],
                                     "rnn": rnn_launches[entry["name"]],
                                     "parallel": par_launches[entry["name"]],
                                     "axes": axes_launches[entry["name"]],
                                     "pp": pp_launches[entry["name"]]}
        entry["launches"] = sum(entry["launches_by_path"].values())
    conv_entries = phase_conv_times(kernels, resnet, dev, conv_launches, conv_errs)
    for entry in conv_entries:
        # phase 20: the zoo's training launches and inception-v3's f32 step
        step = results["zoo"]["inception_v3_f32_step"][entry["name"]]
        entry["zoo"] = {"launches": zoo_launches[entry["name"]],
                        "inception_v3_f32_step": {k: v for k, v in step.items()
                                                  if k != "shapes"}}
        # phases 26 and 28: the mirror and telemetry paths' launches, in
        # ``launches`` too
        entry["launches_by_path"] = {"mirror": mirror_launches[entry["name"]],
                                     "telemetry": tele_launches[entry["name"]],
                                     "detection": det_launches[entry["name"]],
                                     "dist": dist_launches[entry["name"]],
                                     "cpp": cpp_launches[entry["name"]],
                                     "examples": ex_launches[entry["name"]]}
        # phase 33: the examples' and lenet.cpp's shapes, f32
        entry["examples_shapes"] = examples["conv_checks"]["rows"][entry["name"]]
    kernel_line = {"kernels": fwd + bwd + conv_entries
                   + phase_rtc_times(mx, rk, rtc_runs, results["rtc_training"], dev)
                   + [results.pop("k1_entry"), nms_entry(det)],
                   "card": card}
    results.update(kernel_line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
    print(json.dumps(kernel_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
