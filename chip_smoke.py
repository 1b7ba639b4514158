#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Needs one CUDA card, nvcc and the repository checkout; it imports neither
JAX nor the JAX package. Phases (any failure exits non-zero):

1. Environment: the card's name and power limit (nvidia-smi), the CUDA and
   PyTorch versions, nvcc's version and the host's CPU count; builds the
   flash-attention forward (K1) and backward (K2, K3) libraries and the
   fused 1x1-conv library (K4) from ``mxnet_tpu_torch/csrc``, started
   together: K1's as one ``nvcc -c`` a head dim (``fa.fwd_sources``),
   all at once, and a link; K2+K3's and K4's one nvcc each. Prints the build
   times, each K1 object's seconds and the ptxas reports.
2. K1 against its plain version: ``flash_attention_fwd`` (O and LSE)
   against ``flash_attention_fwd_reference`` on the card at every listed
   shape (the serving and training shapes among them), f32 within 1e-4
   (sum order only) and bf16 within 2e-2 (P is rounded to bf16; one bf16
   ulp near 1 is 7.8e-3), each on q, k, v taken as the split (B, H, S, D)
   views of one seeded (B, S, 3 H D) QKV buffer and on contiguous copies
   of them: both within tolerance, and bitwise equal to each other. At the
   serving and the training shape it times the kernel on both layouts,
   the plain version and ``torch.nn.functional.
   scaled_dot_product_attention``'s forward (a yardstick only; the port
   never calls it) with CUDA events around 10 back-to-back calls, median
   of 30 such windows after warm-up, and the device time of the kernel and
   of SDPA replayed from a CUDA graph of 10 calls (no host work in the
   window); it prints the bound (bytes over 3.35 TB/s against operations
   over the peak for the type). Then the host microseconds of one K1 call,
   of its C entry alone (four tensor maps encoded, the launch) and of one
   SDPA call, timed in turns.
2b. K2 and K3, each against its own plain version, at every listed shape
   (the training and serving shapes, ragged tails, causal, D = 32/64/128)
   in bf16 and f32: ``flash_attention_bwd_dq`` (dq and delta, given K1's
   out and lse) against ``flash_attention_bwd_dq_reference``, and
   ``flash_attention_bwd_dkv`` (dk and dv, given K2's delta) against
   ``flash_attention_bwd_dkv_reference``, each output within tol *
   max(1, max|plain|): f32 1e-4 (sum order only), bf16 2e-2 (outputs
   rounded to bf16, and P and dS are rounded to bf16 on both sides, where
   an f32 sum order can flip an ulp). Inputs as the training path hands
   them over: q, k, v the split views of one QKV buffer, out K1's (B, S,
   H, D) memory, dout the transposed view of a (B, S, H, D) gradient; the
   same on contiguous copies must be bitwise equal. Then one head dim the
   kernels do not take (D = 16): ``multi_head_attention`` forward and QKV
   gradients on the card in f32 against the same on the CPU within 1e-4,
   launching no kernel, and in bf16 without raising. At the training and
   the serving shape it times K2, K3 and the whole backward
   (``flash_attention_bwd``) through the wrappers (10-call windows) and
   replayed from CUDA graphs, each kernel's plain version, and
   ``scaled_dot_product_attention``'s backward (a yardstick only: through
   autograd, and from a graph as the forward plus backward less the
   forward), with the bounds.
2c. K4 against its plain version: ``conv1x1_bn_act`` against
   ``conv1x1_bn_act_reference`` at ResNet-50's nine batch-128 1x1 shapes
   (bf16 x) and at a ragged M, K = 8, no ReLU and an f32 x: y within
   2e-2 x max(1, max|plain|) (bf16 output, sum order), each moment within
   1e-3 x max(1, max|plain|) of itself (f32 sums over up to 401,408 rows in
   another order); each of the nine twice, bitwise equal (the moments are
   reduced in a fixed order). At each of the nine it prints the schedule
   (tile width, blocks) and times the kernel, the plain
   version, ``torch.matmul`` of the pre-activated bf16 x with w (the
   product alone) and the library composition of the same function
   (``tools/k4_compare.py``: the prologue, ``torch.mm`` with an f32
   result, the rounding and the column sums; held to the plain version
   too), yardsticks the port never calls, each through its calls (10-call
   windows) and replayed from a CUDA graph of 10 calls, and the bound
   (bytes over 3.35 TB/s against 2 M K N operations over 989 TFLOP/s) with
   the graph time's share of it.
3. The serving slice: ``bert_base()`` at full width with seeded random
   weights, cast to bf16, served by ``ModelEndpoint`` + ``InferenceServer``
   to 8 client threads sending 96 requests of 1-8 rows of 512 tokens.
   Checks: every response is on the card and equals the direct forward of
   the same rows (``|a - b| <= 2e-2 + 2e-2 |b|``, bf16 with other batch
   sizes in the matrix products); K1's launch count is exactly 12 per
   executed batch (the construction probe and warm-up included); and one
   row run in f32 on the card matches the plain f32 forward on the CPU
   within 1e-3. Prints requests/s, tokens/s and p50/p99 latency beside the
   card.
4. The training slice: ``BERTForPretraining(bert_base(max_length=128))`` at
   full width, seeded weights through the weight carrier, ``Adam(1e-4)``,
   bf16 compute over f32 masters, dropout 0.1, batch 64 x 128 with P = 19
   masked positions, through ``ParallelTrainStep``: 2 warm-up steps, 3
   ``step_n`` calls of K = 10, then 10 steps on one fixed batch. Checks:
   every loss is finite; the fixed batch's loss falls; K1, K2 and K3 each
   launched exactly 12 times per step. Then one f32 step at batch 2 x 128
   on the card against the same step on the CPU (plain versions): loss
   within 1e-4 relative; parameters after the update within 2 lr (the most
   one Adam step can move a weight either way) and no more than 1e-3 of
   them beyond 0.1 lr (a near-zero gradient whose sign the sum order flips
   moves its weight by up to lr). Prints tokens/s (batch * seq * K * calls
   / wall, as bench.py), the step's median ms and the peak device memory
   beside the card.
5. The ResNet-50 slice: ``resnet50_v1(classes=1000)`` at full width and
   depth, seeded weights through the weight carrier (``collect_params()``
   names), ``SGD(0.05, momentum 0.9)`` and ``SoftmaxCrossEntropyLoss``,
   bf16 compute over f32 masters, batch 32 x 3 x 224 x 224 with labels in
   [0, 1000), as ``bench.py``: 2 warm-up steps, 3 ``step_n`` calls of
   K = 10, then 10 steps on one fixed batch. Checks: every loss is finite;
   the fixed batch's loss falls; the running stats moved from (0, 1) and are
   finite float32. Prints img/s (32 * K * calls / wall, closed by fetching
   the last loss), the step's median ms and the peak device memory beside
   the card. Then K4 on the model's own data: one bf16 training-mode
   forward with hooks at the 16 bottlenecks takes the 3x3 conv's output as
   an (N*H*W, C) matrix, the scale and shift its BatchNorm computes, and
   the last 1x1 conv's weight as (K, N); K4 is launched once per
   bottleneck (the count must be 16) and y + the conv's bias must equal the
   conv's output within 2e-2 x max(1, max|out|), and sum/M (+ bias) and
   sumsq/M - (sum/M)^2 the next BatchNorm's batch mean and variance within
   2^-7 of each column's rms and 2^-6 of its mean square (the conv's output
   is rounded to bf16, and the bias added in bf16, before that BatchNorm
   reads it: two roundings of at most 2^-9 each, doubled). Then one f32
   step at batch 2 on the card against the same step on the CPU: loss within
   1e-4 relative; running stats within 1e-4 x max(1, |stat|) (f32 batch
   moments, sum order only); and each parameter's update (w before - w
   after = lr * gradient on a first SGD step) held against the same step
   computed in f64 on the CPU (``tools/f32_drift.py`` runs all three):
   the card's f32 update of each leaf may be at most 3 times as far from
   it in norm as the CPU's f32 update of that leaf is, and its largest
   element error at most 3 times the CPU's largest in the same stage,
   each plus one f32 ulp of the leaf's weights. At random initialization
   f32 rounding alone puts this net's gradient percents away from f64,
   on the CPU as on the card: the forward's relative error grows block by
   block through the 16 bottlenecks, and the backward amplifies it, so
   each leaf's own f32 error, measured on the CPU, is the scale the card
   is held to. Element maxima come from the handful of ReLU mask flips
   each device makes at its own positions, so they are compared per
   stage.
6. The rtc slice and the imperative path (K5), on ``gpu(0)``: the three
   sources of ``csrc/rtc/`` compiled at run time by ``rtc.CudaModule``
   (NVRTC, sm_90a; compile seconds printed). Each of these must raise
   MXNetError at its call with the reference's message: a broken source
   ("failed to compile", with the log), a missing name ("not found"), a
   name outside ``exports`` ("not exported"), an argument of the wrong
   dtype, a CPU array, and a launch the card refuses (1025 threads a
   block, at ``launch``); an exported template (``twice<float>``) resolves
   through its lowered name. The main path, with ``rtc.launches`` set to 0
   just before and read just after: the reference's ``axpy``, ``scale`` and
   ``k`` at 8 elements, ``axpy`` over as many f32 values as ``resnet50_v1``
   has trainable parameters, three steps of ``GeluTanh`` (an
   ``autograd.Function`` over the GELU kernel pair) under
   ``autograd.record()`` at BERT-base's FFN width, (64 * 128, 3072) bf16
   from ``nd.random.normal``, with ``loss = (y * w).sum()`` and
   ``loss.backward()`` (2 launches a step), and ``log_softmax`` at the MLM
   logits' (64 * 19, 30522) bf16, one 128-thread block a row.
   Checks: axpy, scale and k bitwise equal to their plain versions (2x is
   exact, so an FMA cannot change the sum), y and x.grad within one bf16
   ulp of each value of the plain versions and of
   ``F.gelu(approximate="tanh")`` under torch autograd, log_softmax within
   one bf16 ulp of its plain version, the launch counts. Then each kernel
   is timed beside its bound, its plain version and one PyTorch call
   computing the same function (``torch.add(y, x, alpha=2)``, ``F.gelu``
   and its backward, ``torch.log_softmax``), the kernel and that call also
   replayed from CUDA graphs of 10 (device time), the host cost of one
   ``CudaKernel.launch`` at 8 elements beside one ``torch.add``, and
   NDArray/autograd cases run on the card against the same calls on
   ``cpu()``. ``rtc.launches`` at the end equals every launch the phase
   made.
7. The generate slice: ``TransformerLM`` at BERT-base width (12 layers, 768
   units, 12 heads, FFN 3072, vocab 30522, 512 positions; the causal
   encoder with a tied LM head), seeded weights through the weight carrier
   (the JAX test's Normal(0.5) recipe), bf16, in a ``DecodeEndpoint``
   (max_seq_len 512, max batch 8, pages of 16, 257 pages) registered with
   warm-up on an ``InferenceServer``: 4 client threads submit 24 sequences
   through ``server.generate`` (prompt lengths from the seed in [8, 448],
   four from each prefill bucket; 32 new tokens each; tenants "default"
   and one at 50 ms/token). Checks: every stream yields exactly 32 tokens;
   K1 launched 12 times per prefill (the 6 warm-up prefills included) and
   0 times per decode step; the same prompts decoded serially through the
   same engine give bitwise the same token lists, and 8 rows' first-step
   logits stepped together (bucket 8) equal each row's stepped alone
   (bucket 1) bitwise; greedy tokens depend on the context; K1 against its
   plain version at (1, 12, S, 64) causal for every prefill bucket S in
   bf16 and f32 at phase 2's tolerances; one sequence in f32 on the card
   against the CPU (prefill logits within 1e-3 x max(1, |logit|), first 8
   greedy tokens equal), with the repo's BERT weight recipe (under the wide
   init f32 rounding alone moves the logits by more than that: the CPU's
   f32 prefill against its f64 one is printed).
   Prints tokens/s, time to first token and inter-token gaps per tenant
   (p50, p99; client-side clocks), peak device memory, each prefill and
   decode bucket's ms (host clock and CUDA events), the decode step's
   device busy share (torch.profiler), and K1's causal times at
   (1, 12, 512, 64) and (1, 12, 128, 64) on split views, from CUDA graphs,
   beside the bound and SDPA's causal forward.
8. The Gluon training surface, on ``gpu(0)``: (a) the LeNet drive of
   ``.claude/skills/verify/SKILL.md`` (``Conv2D(6, 5, padding=2,
   activation="relu")``, ``MaxPool2D(2)``, ``Flatten``, ``Dense(10)``,
   deferred shapes) at batch 64 from Xavier weights, ``Trainer("sgd",
   0.1)``, three eager then three hybridized ``record`` / ``backward`` /
   ``step`` iterations on the card and the same on the CPU: losses and
   parameters within 1e-4 x max(1, max|value|) (f32 both, TF32 off; sums
   in another order over six steps). (b) The main path, as a Gluon user
   writes it: ``BERTForPretraining(bert_base(max_length=128))``,
   ``initialize(Normal(0.02))``, ``cast("bfloat16")``, ``hybridize()``,
   ``Trainer("adam", lr 1e-4, multi_precision)``, dropout 0.1, batch
   64 x 128 with P = 19 and a per-sample loss (the two cross-entropies,
   ``PretrainLoss``): 2 warm-up steps, 10 steps closed by one fetch
   (tokens/s), 10 steps each closed by a fetch (median ms). Checks: every
   loss finite; K1, K2 and K3 each launched 12 times per step. Prints
   tokens/s, the step's median ms, the device ms per step and busy share
   over one profiled step (as ``tools/step_profile.py`` reads them;
   phase 4 prints the same for ``ParallelTrainStep``), peak memory. (c) At
   dropout 0, three such steps against three ``ParallelTrainStep``
   (bf16 compute) steps from the same bf16-exact weights, both handing
   Adam the update count as an f32 scalar, as the reference does: the f32
   masters bitwise equal (the two differ only in mean-then-backward against
   backward-then-rescale, a power of 2, exact in bf16).
9. The op surface and the LSTM word LM, on ``gpu(0)``: (a) every case of
   ``mxnet_tpu_torch/tools/op_cases.py`` (one per registered op but the
   samplers; small f32 shapes, bf16/f16 and integer variants, seeded
   inputs; the table tests/test_torch_ops.py holds to the JAX package) on
   the card against the same case on ``cpu()``: data movement, indexing
   and ordering exact, sums and products within 1e-5 relative, f32
   transcendental functions within 1e-6, bf16/f16 results within 2^-7
   (each also absolute near zero), every result on the card; sorts,
   argsort and topk run on tie-free inputs (a permutation of distinct
   values). Each of the 20 samplers then draws 200,000 values on the card
   from the context's generator, held to its first two moments (five
   standard errors, and 2% of the variance) or its property (rows sum to
   1, frequencies, a permutation, the Zipfian mass at 0). Prints the names
   of any op that differs, and fails; prints K1's launches in the
   ``nd.flash_attention`` and ``nd.multi_head_attention`` cases (2 each:
   the unmasked and the causal call at D = 32). The contrib ops' cases
   (boxes, NMS and the MultiBox family, ROI ops, the graph ops, ...) run
   on inputs for which NMS and matching are well posed (no IoU within
   1e-3 of a threshold, distinct scores). (b) The main path: ``LSTMLanguageModel`` at the PTB
   "medium" width of Zaremba et al. 2014 (2 layers of 650, vocabulary
   10,000, dropout 0.5 on the embedding's and the LSTM's outputs),
   ``initialize(Uniform(0.05))``, ``Trainer("sgd", lr 1)``, batch 20 x
   BPTT 35 of seeded synthetic tokens, the states carried and detached,
   ``clip_global_norm`` at 5 per sample, f32: 2 warm-up steps, 10 steps
   closed by one fetch (tokens/s), 10 steps each closed by a fetch
   (median ms). Checks: losses finite; no hand-written kernel launched
   (none lies on this path). Prints tokens/s, the step's median ms, device
   ms and busy share and device operations a step (torch.profiler, one
   step), peak memory; then the port's RNN op and ``torch.nn.LSTM``
   (cuDNN, a yardstick the port never calls), forward + backward at the
   same shape, through CUDA events and from CUDA graphs. (c) Three steps
   at batch 2 and dropout 0 from the same seeded weights on the card and
   on the CPU: losses and parameters within 1e-4 x max(1, max|value|)
   (f32 both, TF32 off; sums in another order).
10. SSD, on ``gpu(0)``: (a) ``ssd_96_tiny(classes=3)`` at f32 from seeded
   Xavier-uniform weights, three ``gluon.Trainer`` steps (SGD lr 1e-3,
   momentum 0.9) on 4 ``get_shapes_detection`` images, then ``detect()``
   (threshold 0.2, NMS 0.3, top 16), on the card and on the CPU: losses,
   parameters and rows within phase 9's 1e-4 of max(1, |value|), the rows'
   classes equal, on inputs the CPU's predictions show to be well posed
   (no score within 1e-6 of the threshold or of another candidate's, no
   same-class IoU within 1e-4 of the NMS threshold). (b) The main path:
   ``ssd_300_vgg16(classes=3)`` (VGG16-reduced, four extra scales, 8732
   anchors) from ``initialize(Xavier())``, ``SSDMultiBoxLoss``,
   ``Adam(1e-3)``, bf16 compute over f32 masters, through
   ``ParallelTrainStep`` at batch 32 of 300 x 300 images gathered on the
   card from 128 ``get_shapes_detection`` images placed there once
   (``examples/ssd/train_shapes.py``'s recipe): 2 warm-up steps, 10 steps
   closed by one fetch (img/s), 10 steps each closed by a fetch (median
   ms). Checks: losses finite and falling; K1–K5 launched 0 times (none
   lies on this path). Prints img/s, the step's median ms, device ms,
   busy share and device operations a step (torch.profiler, one step),
   peak memory. (c) ``detect()`` on 32 of those images with the trained
   weights (f32; threshold 0.01, NMS 0.45, top 400): its ms (host clock
   to the synchronized rows) and ``MultiBoxDetection``'s alone, the K
   rows NMS's loop ran over (``contrib.nms_rows``) and the rows kept;
   launches 0. (d) tests/test_ssd.py's accuracy drive: ``ssd_96_tiny``
   from ``initialize(Xavier())``, 251 Adam steps (lr 2e-3, batch 16)
   through ``gluon.Trainer`` on 96 images at 96 x 96 (seed 0), VOC07
   mAP@0.5 on 32 held-out images (seed 99) at least 0.6, the last loss
   under a quarter of the first.
11. AMP, on ``gpu(0)``: (a) F4's fp16 instances of K1, K2 and K3, each
   against its plain version (outputs within 2.5e-3 x max(1, max|plain|):
   bf16's 2e-2 times 2^-11 / 2^-8) at the serving and training shapes and
   at causal, D = 32 and D = 128 cases, on split QKV views; at the two
   timed shapes each from CUDA graphs beside its plain version, its bound
   and SDPA's fp16 forward and backward. (b) The main path under
   ``amp.init("bfloat16")``: ``BERTForPretraining(bert_base(max_length=
   128))``, ``initialize(Normal(0.02))`` (f32 parameters),
   ``Trainer("adam", lr 1e-4)``, dropout 0.1, one fixed batch 64 x 128,
   P = 19, ``PretrainLoss``: 2 warm-up steps, 10 in a window closed by
   one fetch (tokens/s), 10 each closed by a fetch (median ms). Checks:
   losses finite and falling; K1, K2 and K3 each launched 12 times a
   step, K4 and K5 never. Prints tokens/s, the step's median ms, device ms
   and busy share, peak memory. (c) The same under
   ``amp.init("float16")`` with ``amp.init_trainer``: each step
   ``scale_loss``, ``backward``, ``unscale``, ``launch_check_overflow``
   and ``wait_and_update``, then ``step`` unless skipped; prints the
   final scale and the skipped steps; then one step with a gradient set
   to inf must be skipped, the weights untouched and the scale halved.
   AMP is turned off after each. (d) Three AMP-fp16 Adam steps (lr 1e-3,
   the loss scaler from 2^10) of a small BERT (2 layers, units 64, D = 32: K1-K3 on the
   card) on the card and on the CPU from the same seeded weights and
   batches: the same skipped steps (not all), losses within 5e-3
   relative, f32 masters within 0.1 lr on average and 0.5 lr at the 99th
   percentile (the bf16 band of tests/test_torch_train.py: rounding flips
   the sign of near-zero gradients, and one Adam step moves a weight by
   about lr). (e) The 35 optimizer ops are op cases of phase 9(a).
12. Row-sparse gradients, on ``gpu(0)``: (a) the main path: the LM of the
   reference's sparse-embedding test at PTB-medium width (``SparseLM``:
   ``Embedding(10000, 650, sparse_grad=True)``, a 2 x 650 LSTM, a Dense
   decoder), seeded uniform(0.05) weights, batch 20 x BPTT 35 of seeded
   tokens, lazy Adam (lr 1e-3) through ``gluon.Trainer``: 22 steps as in
   (b) of phase 11. Checks: the embedding's gradient a
   ``RowSparseNDArray``; losses finite and within rtol 0.08 (the
   reference test's bar) of the dense-embedding twin's from the same
   weights; no hand-written kernel launched. Prints tokens/s, the step's
   median ms, device ms and busy share, the touched rows per step, peak
   memory. (b) Five SGD steps (lr 1, no momentum, wd or clipping: lazy ==
   dense) of both twins: weights within 1e-6 of max(1, |value|) (the card
   sums the gradient's rows in another order). (c) The sparse functions
   (storage casts, the three dots, retain, add_n, the row-sparse sum of
   squares) on the card against the CPU within 1e-5.
13. The data path, on ``gpu(0)``: the native library (engine and RecordIO,
   built by g++; the OpenCV pipeline where the host has its headers) must
   have built and loaded and the host engine be a ``NativeEngine``; the
   decoders on the host are printed. (a) The main path: 512 seeded
   256 x 256 x 3 uint8 images with labels in [0, 1000) written with
   ``MXIndexedRecordIO`` as raw-pixel records (``recordio.pack`` of the
   bytes) under ``build/phase_data/``; ``resnet50_v1(classes=1000)`` with
   phase 5's recipe (seeded weights, SGD(0.05, momentum 0.9), bf16 over
   f32 masters) trained one epoch of 16 steps at batch 32 from a
   ``DataLoader`` (4 workers, shuffle, ``pin_memory``) over
   ``RecordFileDataset`` with ``RandomResizedCrop(224)``,
   ``RandomFlipLeftRight``, ``ToTensor`` and ``Normalize`` (ImageNet's
   mean and std) on the first field, each batch moved with
   ``as_in_context(gpu(0))``. Checks: 16 finite losses; no hand-written
   kernel launched (none lies on the path). Prints img/s, the step's
   median ms (batch on the card to fetched loss), the consumer's wait a
   batch p50/p99, device ms and busy share (one profiled step), peak
   memory, beside phase 5's img/s and step in the same run. Where the host
   has PIL or cv2, the same images as JPEG records (``pack_img``, quality
   95) and the same epoch through ``ImageRecordDataset``. (b)
   ``ImageRecordIter`` over the JPEG records (3 x 224 x 224, batch 32, 4
   threads): which path ran (the native OpenCV pipeline, or ``ImageIter``
   under ``PrefetchingIter``), its batches/s, all 16 batches; or a line
   saying it did not run. ``NDArrayIter`` under ``PrefetchingIter`` on the
   engine over raw-pixel batches keeps their order. (c) Under one seed the
   first 4 batches with 0 and with 4 workers are bitwise equal, and a
   loader restored from the ``state_dict`` taken after batch 10 yields the
   other 6 bitwise. The files are removed. The 15 image ops are op cases
   of phase 9(a).
14. The training utilities, custom ops and the rest of the zoo, on
   ``gpu(0)``: (a) the main path: ``resnet50_v1(classes=1000)`` with phase
   5's seeded weights, cast to bf16 (f32 masters: ``Trainer("sgd", lr
   0.05, momentum 0.9, multi_precision)``), ``net.summary()`` once (its
   total must be the JAX package's count, ``tools.RESNET50_V1_PARAM_COUNT``),
   trained through ``Estimator(net, SoftmaxCrossEntropyLoss(),
   train_metrics=[Accuracy(), TopKAccuracy(5)], context=gpu(0)).fit``
   for 2 epochs from phase 13's DataLoader (the 512 records, the
   training transforms then a cast to bf16) with validation on 256 more
   records (resize 256, center crop 224), ``CheckpointHandler`` (monitor:
   validation accuracy, ``save_best``), ``EarlyStoppingHandler``
   (validation accuracy, patience 1) and ``LoggingHandler(log_interval=8)``.
   Checks: parameters, predictions and every profiled convolution on the
   card (no host convolution); each epoch's training Accuracy and
   TopKAccuracy(5) equal to the same metrics recomputed from the epoch's
   predictions fetched in one piece; ``model-epoch1.params`` and
   ``model-best.params`` load into a fresh bf16 ``resnet50_v1``
   bitwise equal to the parameters at that epoch's end; a second fit at
   lr 0 over the validation records with ``EarlyStoppingHandler(loss,
   patience 0, min_delta 1e-3)`` stops by patience before its 3 epochs;
   finite losses; no hand-written kernel launched. Prints each epoch's
   training and validation accuracy and top-5, which handler stopped
   training, img/s, the step median, device ms and busy share over one
   profiled step, the device-to-host copies a step with the two metrics
   and with the loss metric alone, peak memory, and phase 5's and phase
   13's img/s and step from this run. (b) ``resnet50_v2``, ``alexnet``,
   ``vgg16_bn``, ``squeezenet1_1``, ``densenet121``, ``inception_v3``
   (299 x 299), ``mobilenet1_0`` and ``mobilenet_v2_1_0`` at full width
   (1000 classes, Xavier weights): a batch-2 f32 forward on the card
   against the CPU's from the same weights within 1e-3 relative to the
   CPU's largest logit (TF32 off; cuDNN's and the CPU's sums differ in
   order through up to 121 layers), then three SGD steps at batch 32 in
   bf16 over f32 masters: finite losses, the step ms and img/s. (c) A
   Python ``CustomOp`` (y = x * x) at (4096, 4096) f32 on the card: value
   and gradient bitwise equal to ``x * x`` in ``nd`` (2 dy x is exact
   either way), the host microseconds of one ``nd.Custom`` call beside one
   ``x * x``; a Gluon block with the op between two Dense layers trained
   three ``Trainer`` steps, bitwise equal to the block with ``x * x``; the
   external library of ``tests/torch_ext_ops.cc`` built by g++ into
   ``build/phase_custom/``, loaded with ``library.load``, its ops forward
   and backward on card inputs bitwise equal to the same arithmetic in
   torch. (d) ``DeformableConvolution`` (non-zero offsets),
   ``PixelShuffle2D``, ``BatchNormReLU`` (training mode), ``LSTMPCell``
   and ``VariationalDropoutCell`` (predict mode; and its locked mask on
   the card) against their CPU forward within 1e-4 x max(1, |value|).
   ``Custom`` is an op case of phase 9(a).
15. int8 quantization and the kvstore, on ``gpu(0)``: (a) the main path:
   ``resnet50_v1(classes=1000)`` f32 from phase 5's seeded weights,
   ``contrib.quantization.quantize_net(calib_mode="naive")`` on 2 seeded
   batches of 16 x 3 x 224 x 224 (53 Conv2D and the Dense converted), then
   served through ``ModelEndpoint`` + ``InferenceServer`` (buckets 1-32) to
   8 closed-loop clients sending 96 requests of 1-8 images, and the f32 net
   served the same way. Checks: every int8 response equals the quantized
   net's direct forward of the same rows within 1e-5 + 1e-5 |direct| (the
   reference's bar); the int8 forward makes 54 ``aten::_int_mm`` calls with
   kernels under them and no convolution op (the f32 forward's are
   printed); the int32 accumulators of conv1, a stage-3 3x3 convolution and
   the Dense, on the card, bitwise the CPU's from the same codes; on 2
   images, the int8 net on the card against the CPU port's (the same
   ranges, ``quantized_like``) layer by layer (``card_vs_cpu_int8``):
   every quantized layer on the card's input to it within 2 ulps of the
   card's output, the float path with the quantized outputs pinned to
   the card's within 1e-5, and the free-running logits (where a rounding
   difference flips a code and later layers carry the flip) within half
   the int8 net's own error against f32. Prints requests/s, img/s,
   p50/p99 of
   both nets, each net's device ms for a bucket-32 forward by kernel class
   with its top kernels, the calibration's seconds, and the top-1
   agreement of the int8 and f32 nets on 256 seeded images (random
   weights: a report). (b) The main path: ``bert_base()`` f32 from the
   seeded weights, quantized (naive) on 2 batches of 8 x 128 (49 Dense),
   served at S = 128, buckets 1-8, 32 requests. Checks: responses equal
   the direct forward (1e-5); K1 launched 12 times per executed batch, in
   f32 (a spy on its wrapper for one forward: 12 calls, all f32); the
   int32 accumulators of layer 0's QKV, layer 11's second FFN product and
   the pooler bitwise card vs CPU; one row of 32 tokens on the card
   against the CPU port's, layer by layer as in (a). Prints the bucket-8 forward's device
   ms by kernel class. (c)
   ``resnet50_v1`` in bf16 (f32 masters) at batch 32 through
   ``gluon.Trainer(kvstore="device", update_on_kvstore=True)``, SGD(0.05,
   momentum 0.9): from one backward's gradients, the kvstore route's
   weights, masters and momenta bitwise the local route's; the 2-bit and
   1-bit packed bytes, scales and residuals of every gradient, two pushes,
   bitwise card vs CPU; then 10 steps without and 10 with
   ``{"type": "2bit", "threshold": 0.5}``: finite losses, no hand-written
   kernel launched; prints the step median, img/s, device ms and busy
   share beside phase 5's and phase 14's steps. (d) The int8 product from
   CUDA graphs: ``int8_matmul`` (``torch._int_mm``) at (1024, 768, 3072)
   beside bf16 ``torch.matmul``, and ``int8_conv`` at a stage-3 3x3 shape
   (32, 256, 14, 14) -> 256 (and its im2col alone) beside cuDNN's bf16
   convolution, each beside its bound (1,979 int8 TOP/s, 989 bf16
   TFLOP/s, 3.35 TB/s); each first held to the CPU's int32 result.
16. Multi-process training, two (or four) ranks sharing card 0 over gloo,
   each job started by ``mxnet_tpu_torch/tools/launch.py`` (fresh
   interpreters; K1-K3 were built by this process first). (a) The stores
   on card tensors: ``tests/torch_dist_kvstore_worker.py`` on 2 ranks (the
   reference worker's checks: dense push/pull and pushpull, row-sparse
   pushes of unequal nnz and ``row_sparse_pull``, 2-bit compression with
   the packed wire at 1/16 of the f32 bytes and error feedback 0 -> 1.0,
   1-bit, ``dist_async`` converging to -9, the ``collective`` store, ``p3``
   slices, the heartbeat) and on 4 (dense sums), a one-rank job that must
   take NCCL, and probes of gloo's own all_gather, reduce_scatter,
   all_to_all and point-to-point on card tensors (the phase fails where
   one that the port leaves to gloo does not run or is wrong); prints each
   job's backend, the collectives staged through host memory and each
   operation's ms (the 2-rank job runs alone first, so its ms are its
   own). (b)-(e) one two-rank job (``chip_smoke.py
   --dist-worker``), held against one-process runs on the card made
   first, each with a limit of 4x a control's distance set before the
   ranks run: (b) ``BERTForPretraining(bert_base(max_length=128))`` bf16
   over f32 masters, Adam(1e-4), dropout 0.1, on {"dp": 2}: 5 steps of a
   64 x 128 global batch (P = 19), 32 rows a rank, against the
   one-process 64 x 128 run; the control is that run with each step's
   gradient summed from its two 32-row halves (the global batch's dropout
   masks); the ranks' parameters bitwise equal after every step; K1-K3 12
   launches a layer-step a rank; an f32 2-layer run (SGD 0.01, momentum
   0.9, 3 steps) within 2e-5 of its one-process run. (c) The same on
   {"tp": 2} with ``shard_for_tensor_parallel`` (6 heads a rank: K1 at
   (64, 6, 128, 64)), the gathered parameters against the same run; the
   control splits every row-parallel product in two bf16 halves. (d)
   ``resnet50_v1`` bf16, SGD(0.05, 0.9), on {"dp": 2}, 16 images a rank,
   BatchNorm's moments over all 32, 3 steps: parameters and moving
   statistics after the first step against the one-process batch-32 run,
   relative to that run's own update; the control is that run with each
   step computed as the two ranks compute it, in one process (the halves'
   forwards in two threads, BatchNorm's moment sums added across them at
   every layer, the gradient the halves' mean), printed after every step
   (the runs diverge, so only the first step's limit can bind); and one
   f32 step (cuDNN's TF32 off) on {"dp": 2} against its one-process run,
   the control that run with the batch's halves swapped. (e) BERT-base through
   ``gluon.Trainer(kvstore="dist_sync")`` (phase 8's recipe, 32 x 128 a
   rank), 3 steps without and 3 with 2-bit compression: the ranks'
   weights bitwise equal after each step, the 2-bit wire exactly the
   packed codes (1/16 of the f32 bytes). Prints tokens/s or img/s, the
   step median, the gradient all-reduce in the step and a step's
   communication alone.
17. Ring attention, DLRM on the vocab-sharded table, the thin modules.
   (a) K1, K2 and K3 at one rank's block (1, 12, 4096, 64) bf16, causal
   and not, through the wrappers and from CUDA graphs, beside the plain
   versions, SDPA and the bounds; with one rank ``ring_self_attention`` at
   (1, 12, 8192, 64) bf16 is one K1, K2 and K3 call, bitwise. (b) A
   two-rank job (``chip_smoke.py --slice17-worker``, both ranks on the one
   card over gloo) on {"sp": 2}: ``ring_self_attention`` at (1, 12, 8192,
   64) bf16 (S_local = 4096), causal and not, forward and the q, k, v
   gradients for a seeded output gradient, against one process's K1-K3
   over the whole sequence within TOL[bf16] (2e-2) x max(1, max |ref|)
   (each block's output is rounded to bf16 before the f32 merge), and at
   (1, 12, 1024, 64) f32 within 1e-4; K1/K2/K3 launches a call 2 each
   without ``causal`` and r + 1 on rank r with it (the counts set to 0
   just before each call and read just after); rank 0's ms a call
   (forward, forward + backward) and of one staged ``ppermute`` of a K/V
   block. (c) DLRM at MLPerf Training's widths (dense 13, 26 fields,
   dim 128, bottom 512, top 1024; batch 2048; one table of 8,388,608
   rows, 4.29 GB f32, filled on the card from a seeded generator; SGD
   0.05) on one process: four steps kept for (d), then steps/s,
   lookups/s, the step's median ms (host clock to a fetched loss),
   device ms and busy share (torch.profiler), peak memory, and eight
   steps through ``DeviceFeed`` (wait p50/p99, lead); four steps at
   vocab 65,536 on the card against the port on the CPU, losses, table
   and MLP within 1e-4 x max(1, max |CPU|). (d) In the same job, DLRM on
   {"tp": 2} with the table vocab-sharded (block): ``replicated`` mode's
   four steps bitwise (c)'s (losses, MLP, 4,096 touched rows and each
   rank's shard's fingerprint), ``sharded`` mode within 1e-4; the step
   ms and the exchange counters against ``exchange_cost_bytes``. (e)
   ``runtime.Features()`` lists CUDA and the card; ``TensorInspector`` on
   a card tensor.
18. Training resilience (``mxnet_tpu_torch.resilience``) on BERT at
   full width through K1-K3. (a)-(d) and (f) run in one process started
   with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` under
   ``torch.use_deterministic_algorithms(True)`` (``chip_smoke.py
   --slice18-worker det``), phase 4's step (bf16 over f32 masters, Adam,
   dropout 0.1, 64 x 128, P = 19) on 4 of BERT-base's 12 layers
   (``RES_LAYERS``) under a ``RetryPolicy`` without backoff
   sleeps, batches from a seeded shuffling DataLoader: (a) 8 steps, the
   losses and a sha256 of every parameter and optimizer state; (b)
   ``device_oom`` every 3rd attempt, a ``CheckpointManager`` (async, keep
   2) saving the step, the random state and the DataLoader's position
   every 2 steps, a simulated crash after step 5, a new step from other
   weights, ``restore_latest`` (step 4) and on to step 8: losses and
   digest bitwise (a)'s; (c) a ``NumericsGuard(check_every_n=4)`` with
   ``nan_grad`` at step 3 (token batches: the loss is poisoned): bitwise
   the run without that batch, one host read a verified window, the step
   ms with and without the guard, the snapshots' bytes; (d) an injected
   preemption notice after step 4: the flush within the deadline, the
   marker, ``resume_info`` and a restore into a step of other weights,
   on to step 8 bitwise (a)'s; (f) the checkpoint's bytes, a synchronous
   save's ms and MB/s, the loop's blocked ms under async saves,
   ``restore_latest``'s ms and the retry overhead a fault. K1-K3 launched
   once a layer and computed step. Then (a)'s first 3 steps twice in this
   process without deterministic algorithms (bitwise or not, reported).
   (e) a two-rank job (``--slice18-worker tp``, both ranks on the card
   over gloo): BERT at full width with 2 layers on {"tp": 2}, a sharded
   checkpoint after 3 steps (one shard file a rank), restored on one
   process bitwise the job's gathered state, its next 2 steps held to the
   job's within 4x a control (the row-parallel products split in two);
   DLRM at MLPerf widths with its table cut to 1,048,576 rows (17(c)
   runs all 2^23), vocab-sharded (``sharded`` mode, 4 steps) under
   ``retry=`` with ``emb_exchange`` every 2nd dispatch bitwise the run
   without faults, its sharded checkpoint restored on one process bitwise
   (each half's fingerprint, the MLP).
19. The pipelined multi-tenant server (``serving``) on ``bert_base()`` in
   bf16 with seeded weights, every attention call on K1. (a) Two tenants
   on one server: ``bert512`` (S = 512, buckets 1-32, SLO 1000 ms) and
   ``bert128`` (S = 128, buckets 1-8, SLO 50 ms), closed-loop clients
   (4 a tenant; 24 requests of 1-8 rows and 48 of 1-2 rows a client); per
   tenant requests/s, p50/p99, the share within the SLO, queue wait, prep
   us and the prep overlap ratio, then the same traffic with
   ``pipeline=False``; K1 launches per tenant (forward hooks) equal 12 x
   its executed forwards (batches, construction probe, warm-up); then
   phase 3's traffic on ``bert512`` alone, pipelined and serial. (b)
   Every response of (a) within 2e-2 + 2e-2 |direct| of the direct
   forward and on the card; a scripted stream, one request at a time,
   pipelined byte for byte the serial path. (c) Three hot swaps of
   ``bert512`` (w1, w2, w1: other seeds' weights in ``CheckpointManager``
   directories with recorded probes) under load on both tenants: zero
   errors, each response within tolerance of the base, w1 or w2 weights'
   direct forward, ``weights_epoch`` 3; then a corrupt checkpoint and a
   probe mismatch are refused and the old weights keep serving bitwise.
   (d) ``worker_kill`` and a ``hang`` (watchdog 0.25 s) at
   ``serving_dispatch`` under a ``PoolSupervisor``: every request
   completes once, within tolerance; the requeued count and the time from
   the fault to the last response. (e) A ``ServingPool`` of ``bert128``
   replicas (each its own server, streams and weights) under an
   ``Autoscaler`` over the SLO monitor: a burst scales 1 -> 2 replicas,
   hedged requests (zero delay) bitwise a replica's unhedged response,
   quiet scales back to 1 with requests in flight and none dropped; the
   peak device memory.
20. The executable cache and the serving fabric. (a) Three processes
   (``--slice20-worker A|B|C``) over one fresh ``MXNET_EXEC_CACHE_DIR``
   store: A loads K1-K4's libraries (from ``build/`` or nvcc, printed)
   and compiles four rtc modules' cubins with NVRTC, storing all seven;
   B, with a build directory of its own, hits every entry with zero nvcc
   and NVRTC compiles; C has the first cubin's entry poisoned
   (``cache_poison``), catches the digest mismatch before loading, runs
   NVRTC once and stores it again; K1 at (32, 12, 512, 64) bf16, K2, K3,
   K4 and every rtc kernel's outputs are bitwise A's in B and C; NVRTC
   compile ms against the cubins' load ms. (b) A ``ShardedEndpoint`` on
   ``plan_slices([1], devices=[gpu(0)])`` serving ``bert_base()`` bf16 at
   S = 512 (buckets 1-32) through the server: a scripted stream bitwise a
   ``ModelEndpoint``'s, closed-loop requests/s beside it, 12 K1 launches
   a forward, capacity 1; then on ``plan_slices([2], devices=[gpu(0),
   gpu(0)])`` (two batch groups on the one card) with ``shard_params``:
   every chunk it ran bitwise the direct forward of that chunk, two
   chunks a batch, 12 K1 launches a chunk, capacity 2. (c) A
   ``ShardedDecodeEndpoint`` on the one-card slice and on the two-group
   slice: phase 7's ``TransformerLM`` in bf16, batch 8, tokens equal to
   ``DecodeEndpoint``'s serial and batched and after a compaction
   (``defrag``) of the pool, the KV replicas' sequence pages (all but
   scratch page 0) bitwise equal.
   (d) A ``FrontDoor`` over
   three host planes on the card, each an ``InferenceServer`` with phase
   19's two tenants (requests of a whole top bucket, so a response is one
   forward of its own rows), agents on gpu(0), 4 closed-loop clients a
   tenant: ``kill_host`` of ``fd_bert512``'s owner under load, then a
   second host's agent SIGKILLed and declared down by ``check_hosts``;
   zero client errors, only the dead hosts' tenants moved, every response
   bitwise the direct forward; ms from each failure to its last
   resubmitted response, requests/s before and after, heartbeat ages.
21. Telemetry and the profiler (``mxnet_tpu_torch.telemetry``,
   ``profiler``), with the memstats holders of earlier phases dropped
   first. (a) ``bert_base()`` bf16 at S = 512 (buckets 1-32) through the
   serial ``InferenceServer``, 4 closed-loop clients each inside a
   ``smoke.client`` span: every ``serving.batch`` and
   ``serving.device_step`` span in the flight ring carries a client's
   trace id, the ``completed`` delta of ``mxtpu_serving_requests_total``
   equals the responses, the ``mxtpu_serving_batches_total`` delta x 12
   equals K1's launches, every line of ``prometheus_text()`` parses.
   (b) One request under ``profiler.start()``/``stop()``/``dump()`` with
   ``profile_all``: the chrome dump holds the ``serving.batch`` span with
   the client's trace id, and the torch session's trace a device event of
   ``flash_fwd_kernel`` (printed with its duration). (c) A few
   ``ParallelTrainStep`` steps of ``BERTForPretraining(bert_base(
   max_length=128))`` at 64 x 128: ``train.step`` spans and the
   ``mxtpu_train_steps_total`` delta equal the steps, K1-K3 launch 12
   times a step, ``memstats.reconcile()`` attributes at most the bytes in
   use on ``gpu:0`` (both printed, and the remainder), and
   ``mxtpu_device_memory_bytes{device="gpu:0"}`` is set. (d) In a process
   under deterministic algorithms (``--slice21-worker``) with
   ``MXNET_FLIGHT_DIR`` set: one ``device_oom`` injected into a training
   step under its ``RetryPolicy``; the state after it and one more step is
   bitwise the uninterrupted run's, and exactly one ``oom`` bundle lands,
   holding the metrics snapshot, the holder breakdown, thread stacks and
   the last spans, which ``load_bundle`` reads. (e) On the card's host:
   the host us of a span, a labelled counter ``inc`` and a histogram
   ``observe`` (over 10^5 calls), and the registry calls of one served
   batch with their share of its host time (printed, not gated).
22. Goodput, the fleet pane and the debug server
   (``telemetry.goodput``, ``.fleet``, ``.debug_server``), in a process of
   their own (``--slice22-worker``, started with ``MXNET_TRACE_ID``,
   ``MXNET_SPAN_SPOOL_DIR`` and ``MXNET_FLIGHT_DIR`` under ``build/``). (b)
   First, while every source series is at zero: ``goodput.reset()``, 3
   ``ParallelTrainStep`` steps of ``BERTForPretraining(bert_base(
   max_length=128))`` at 64 x 128 from a ``gluon.data.DataLoader``, one
   checkpoint save, ``goodput.account()``: the buckets sum to the wall
   gauge within 1e-6 relative, ``step``, ``data_wait`` and
   ``checkpoint_flush`` equal their source series (rescaled if the active
   sum passes the wall), ``mxtpu_goodput_seconds_total`` equals the
   attribution, K1-K3 launch 12 times a step; the table and the step share
   beside the ``train.step`` spans' host times. (a) A ``DebugServer`` on
   127.0.0.1 (port 0; every fetch through an opener without a proxy, with
   a timeout) in front of ``bert_base()`` bf16 at S = 512 (buckets 1-32)
   through the serial ``InferenceServer``: phase 21(a)'s 4 closed-loop
   clients once alone, once with six scraper threads on ``/metricsz``,
   ``/metricsz?json=1``, ``/statusz``, ``/tracez``, ``/memz`` and
   ``/fleetz``, each pausing 200 ms between fetches; then one-row
   requests under six scrapers that do not pause, at the interpreter's
   default switch interval and at 0.5 ms: no scrape error and every
   status 200, the
   ``mxtpu_debug_requests_total`` deltas equal the fetches page by page,
   responses within phase 3's tolerance of the direct forward, one row
   bitwise the same with and without scrapers, the batches delta x 12
   equals K1's launches, ``/tracez`` holds each client's trace id,
   ``/memz``'s ``gpu:0`` reading within what the caching allocator
   allocated and freed around the scrape, ``/flightz?dump=1`` writes one
   bundle ``load_bundle`` reads, ``/healthz`` 200 running, 503 ``stopped``
   after ``stop()``, 200 after ``detach``; the ms of one ``/metricsz`` and
   one ``/fleetz`` scrape, the batch p50 with and without scrapers and
   the one-row requests' median at each switch interval (printed). (c) A ``FrontDoor`` over two host planes on the card (a
   ``bert128`` tenant each, agents on gpu(0) writing their dumps), 2
   closed-loop clients for at least three agent ticks: ``fleet_collect``
   has 3 sources, ``mxtpu_serving_requests_total`` merged equals the sum
   over them, the ``serving.batch`` span histogram's ALL row the
   element-wise sum of its 3 sources, ``goodput_reconcile`` ok for both
   hosts, health ``ok`` with ``mxtpu_fleet_health`` 0, the agents' dumps
   reconcile as ``tools/fleet_report.py --verify`` reads them, the
   spool's journey of the trace holds both agents' ``fabric.host_agent``
   spans (the reference's readers import the JAX package, so the port
   computes what they read; the CPU tests run the readers themselves),
   and K1's launches are 12 x (the tenant's ``mxtpu_serving_batches_total``
   delta + both planes' probe and warm-up batches).
23. The symbolic API on a BERT-base-width encoder written in ``mx.sym``
   (``tools/symbol_bert.py``: 12 layers, 768 units, 12 heads, FFN 3072,
   vocab 30522, a first-token head over 2 classes), f32, on ``gpu(0)``,
   seeded weights carried from the Gluon ``bert_base(max_length=128)``:
   (a) ``Module.bind`` at 32 x 128: shape inference (meta tensors)
   allocates nothing, the bind allocates exactly the bound arguments,
   gradients and auxiliary states, and no kernel is launched; (b) the
   encoder's output (``get_internals()``), dropout 0, against the Gluon
   ``BERTModel``'s sequence output on two batches within 1e-4 x max(1,
   max|Gluon|); (c) ``Module.fit`` (Adam 1e-4, dropout 0.1, one epoch of 8
   batches, ``do_checkpoint`` at its end), 5 ``forward_backward`` +
   ``update`` on one fixed batch, then ``score``: every loss finite, the
   fixed batch's loss falls, K1 launched 12 x forwards and K2, K3 12 x
   backwards exactly; prints the step's median ms, tokens/s and peak
   memory; (d) one f32 SGD step at 2 x 128 on the card against the CPU
   (plain versions): loss within 1e-4 relative; each leaf's update held
   against the step's f64 update (the graph bound in f64 on the CPU): the
   card's distance at most SYM_DRIFT_FACTOR x the CPU's own f32 distance
   plus one f32 ulp of the leaf's largest weight, in largest element and
   in norm; (e) the epoch's checkpoint
   files carry the reference's names, and ``Module.load`` + ``predict``
   is bitwise the saved module's ``predict``; (f) ``BucketingModule``
   over buckets 64 and 128: the parameter objects are shared (identity),
   an update under bucket 128 is seen by bucket 64, exact launch counts;
   (g) ``optimize_for(net, "xla")``: outputs and gradients bitwise the
   unpartitioned graph's (a leaf the unpartitioned graph does not repeat
   bitwise from run to run, as PyTorch's embedding backward at a 2-row
   table may not, within 1e-4 x max(1, max|grad|)); (h) ``Monitor(1,
   ".*attention.*")`` over one batch: 12 finite stats. Then K1, K2 and K3
   f32 at (32, 12, 64, 64) (bucket 64's shape: half of each 128-row query
   block masked) and (32, 12, 128, 64) against their plain versions, and
   timed at the latter through the wrappers and from CUDA graphs beside SDPA's f32 forward and
   backward and the bounds.
24. A JSON line with the kernels' numbers (``launches_by_path`` gains
   ``int8_resnet``, ``int8_bert`` and ``kvstore_resnet`` (phase 15),
   ``dp_bert``, ``tp_bert`` and ``dist_trainer_bert``, counted on rank 0
   (phase 16), ``ring_attention`` (phase 17(b), rank 0),
   ``resilience_bert``, ``resilience_nondeterministic_check`` and
   ``resilience_tp_bert`` (phase 18, the last on rank 0) and
   ``serving_pipelined``, ``serving_serial``, ``serving_bitwise``,
   ``serving_hot_swap``, ``serving_failover`` and ``serving_pool`` (phase
   19) and ``sharded_serving``, ``sharded_serving_dp2``,
   ``sharded_decode``, ``sharded_decode_dp2`` and ``frontdoor`` (phase
   20), ``telemetry_serving``, ``telemetry_profiled_request``,
   ``telemetry_cost_batch``, ``telemetry_training`` and
   ``telemetry_oom_retry`` (phase 21), ``fleet_serving``,
   ``fleet_training`` and ``fleet_frontdoor`` (phase 22) and
   ``symbol_fit``, ``symbol_predict``, ``symbol_bucketing`` and
   ``symbol_subgraph`` (phase 23), and K1-K3 gain their times at the
   ring's block and their f32 times at phase 23's shape), then the last
   line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import ctypes
import gc
import importlib.util
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from mxnet_tpu_torch import (MXNetError, amp, autograd, cpu, engine, gluon,
                             gpu, init, io, kvstore, library, metric, native,
                             nd, operator, random, recordio, rtc, runtime,
                             serving, sparse)
from mxnet_tpu_torch.contrib import quantization as qz
from mxnet_tpu_torch.embedding import (DeviceFeed, DLRMTrainStep,
                                       ShardedEmbedding,
                                       synthetic_dlrm_batches)
from mxnet_tpu_torch.gluon import data as gdata
from mxnet_tpu_torch.gluon.data.vision import transforms as T
from mxnet_tpu_torch.gluon import nn, rnn
from mxnet_tpu_torch.gluon.contrib import cnn as ccnn
from mxnet_tpu_torch.gluon.contrib import estimator as est_handlers
from mxnet_tpu_torch.gluon.contrib import nn as cnn
from mxnet_tpu_torch.gluon.contrib import rnn as crnn
from mxnet_tpu_torch.gluon.contrib.estimator import Estimator
from mxnet_tpu_torch.gluon.model_zoo.bert import (
    BERTForPretraining, BERTModel, BERTPretrainingLoss, TransformerLM,
    bert_base, load_jax_params)
from mxnet_tpu_torch.gluon.model_zoo.lstm_lm import PTB_MEDIUM, ptb_medium
from mxnet_tpu_torch.gluon.model_zoo.vision import (BottleneckV1, get_model,
                                                    resnet50_v1)
from mxnet_tpu_torch.gluon.model_zoo.vision import ssd as ssd_zoo
from mxnet_tpu_torch.ops import _build, _nvrtc, contrib
from mxnet_tpu_torch.ops import nn as ops
from mxnet_tpu_torch.ops import quantization as qops
from mxnet_tpu_torch.ops.cuda import flash_attention as fa
from mxnet_tpu_torch.ops.cuda import fused_conv1x1 as fc
from mxnet_tpu_torch.ops.nn import rnn_param_size
from mxnet_tpu_torch import config as mt_config
from mxnet_tpu_torch.optimizer import Adam
from mxnet_tpu_torch.parallel import ParallelTrainStep, make_mesh
from mxnet_tpu_torch.resilience import (CheckpointManager, faults,
                                        verify_checkpoint_dir)
from mxnet_tpu_torch.serving import tailguard
from mxnet_tpu_torch.serving.generate import DecodeEndpoint
from mxnet_tpu_torch import profiler, telemetry
from mxnet_tpu_torch.telemetry import flight, memstats, slo
from mxnet_tpu_torch.tensor_inspector import TensorInspector
from mxnet_tpu_torch.test_utils import get_shapes_detection
from mxnet_tpu_torch.tools import (RESNET50_V1_PARAM_COUNT, PretrainStep,
                                   card, f32_drift, graph_ms,
                                   median_ms, pretrain_batch, resnet_batch,
                                   resnet_train_step, seeded_bert_weights,
                                   seeded_resnet_weights)
from mxnet_tpu_torch.tools import int8_drift, op_cases
from mxnet_tpu_torch.tools import rtc_examples as rx
from mxnet_tpu_torch.tools.k4_compare import composition as k4_composition
from mxnet_tpu_torch import callback as mcallback
from mxnet_tpu_torch import module as mmod
from mxnet_tpu_torch import monitor as mmonitor
from mxnet_tpu_torch import subgraph
from mxnet_tpu_torch import symbol as msym
from mxnet_tpu_torch.tools.symbol_bert import (encoder_output,
                                               gluon_arg_params, symbol_bert)

HBM_BYTES_PER_S = 3.35e12                   # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,       # dense tensor cores
              torch.float16: 989e12,
              torch.int8: 1979e12,          # dense int8 tensor-core ops
              torch.float32: 67e12}         # fp32 without the tensor cores
# fp16: bf16's tolerance times 2^-11 / 2^-8 (the two unit roundoffs)
TOL = {torch.bfloat16: 2e-2, torch.float16: 2.5e-3, torch.float32: 1e-4}
TIMED_CALLS = 10          # calls between two CUDA events (see median_ms)
BERT_SHAPE = (32, 12, 512, 64)
TRAIN_SHAPE = (64, 12, 128, 64)             # BERT-base pretraining, B x H
CHECK_SHAPES = [  # (B, H, S, D), causal
    (BERT_SHAPE, False), ((2, 2, 256, 64), False), ((2, 2, 256, 64), True),
    ((1, 1, 192, 64), False), ((1, 2, 640, 64), True),
    ((2, 4, 128, 32), False), ((1, 2, 256, 128), False),
    ((1, 2, 256, 128), True), (TRAIN_SHAPE, False)]
TIMED_SHAPES = {BERT_SHAPE: "serving", TRAIN_SHAPE: "training"}
K1_HOST_ROUNDS, K1_HOST_CALLS = 25, 20
SEQ_LEN = 512
N_CLIENTS = 8
REQS_PER_CLIENT = 12
BWD_SHAPES = [  # (B, H, S, D), causal
    (TRAIN_SHAPE, False), (BERT_SHAPE, False), ((2, 2, 300, 64), False),
    ((1, 2, 640, 64), True), ((2, 4, 128, 32), False),
    ((1, 2, 256, 128), False), ((1, 2, 256, 128), True)]
TRAIN_BATCH, TRAIN_SEQ, TRAIN_P = 64, 128, 19   # bench.py's BERT cell
TRAIN_K, TRAIN_CALLS, TRAIN_WARMUP, TRAIN_FIXED = 10, 3, 2, 10
TRAIN_LR = 1e-4
PROFILED_STEPS = 1         # steps under torch.profiler for the busy share
# (one: a profile's cost grows with its events)
LENET_BATCH, LENET_STEPS, LENET_TOL = 64, 6, 1e-4
GLUON_TIMED = 10           # timed Gluon steps: a window, then one by one
GLUON_CHECK_STEPS = 3
OPS_SAMPLES = 200_000      # draws per sampler on the card
K1_CASES = {"flash_attention": 2, "multi_head_attention": 2}
# the PTB word LM (Zaremba et al. 2014, "medium"): BPTT 35, batch 20,
# SGD at lr 1, gradient norm clipped at 5
LSTM_BPTT, LSTM_BATCH, LSTM_LR, LSTM_CLIP = 35, 20, 1.0, 5.0
LSTM_WARMUP, LSTM_TIMED = 2, 10
LSTM_CHECK_BATCH, LSTM_CHECK_STEPS, LSTM_TOL = 2, 3, 1e-4
SSD_BATCH, SSD_IMAGES, SSD_LR = 32, 128, 1e-3  # examples/ssd/train_shapes.py
SSD_WARMUP, SSD_TIMED = 2, 10
SSD_ANCHORS = 8732
SSD_DETECT = dict(threshold=0.01, nms_threshold=0.45, nms_topk=400)
SSD_CHECK_BATCH, SSD_CHECK_STEPS = 4, 3
SSD_CHECK_DETECT = dict(threshold=0.2, nms_threshold=0.3, nms_topk=16)
MAP_STEPS, MAP_BATCH, MAP_LR, MAP_FLOOR = 251, 16, 2e-3, 0.6
AMP_WARMUP, AMP_TIMED = 2, 10          # 22 steps: warm-up, window, one by one
# the small BERT of the AMP card-vs-CPU check (D = 32: K1-K3 on the card)
AMP_SMALL = dict(num_layers=2, units=64, hidden_size=128, num_heads=2,
                 vocab_size=30522, max_length=TRAIN_SEQ, dropout=0.0)
AMP_CHECK_BATCH, AMP_CHECK_STEPS, AMP_CHECK_LR = 4, 3, 1e-3
AMP_LOSS_RTOL = 5e-3       # fp16 compute: sum order in fp16-rounded layers
# the check's first loss scale: at 2^16 (init_trainer's) this net's fp16
# backward overflows until the scaler has halved the scale six times
AMP_CHECK_SCALE = 2.0 ** 10
SPARSE_WARMUP, SPARSE_TIMED, SPARSE_LR = 2, 10, 1e-3   # lazy Adam
SPARSE_LOSS_RTOL = 0.08    # tests/test_sparse.py's sparse-vs-dense bar
SPARSE_SGD_STEPS, SPARSE_SGD_LR, SPARSE_SGD_TOL = 5, 1.0, 1e-6
# the data path: a RecordIO file of seeded 256 x 256 x 3 uint8 images with
# labels in [0, 1000), read by a DataLoader of 4 workers into ResNet-50;
# 512 records (16 steps an epoch, here and in phase 14's Estimator) keep
# the whole script inside its time limit
DATA_RECORDS, DATA_HW, DATA_WORKERS = 512, 256, 4
DATA_WARMUP = 2                  # synthetic steps before the timed epoch
DATA_SAME_BATCHES, DATA_RESUME_AT = 4, 10
DATA_MEAN, DATA_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
DATA_DIR = Path(__file__).resolve().parent / "build" / "phase_data"
# phase 14: the Estimator path (phase 13's records, 256 more for validation)
EST_VAL_RECORDS, EST_EPOCHS, EST_PATIENCE = 256, 2, 1
EST_LR0_EPOCHS, EST_LR0_MIN_DELTA = 3, 1e-3
# convolutions that ran on the host (a batch the Estimator left there)
HOST_CONV_OPS = ("aten::mkldnn_convolution", "aten::_slow_conv2d_forward",
                 "aten::thnn_conv2d", "aten::_nnpack_spatial_convolution",
                 "aten::slow_conv_dilated2d")
# the zoo at full width (name, image size), SGD steps at batch ZOO_BATCH
ZOO_FULL = [("resnet50_v2", 224), ("alexnet", 224), ("vgg16_bn", 224),
            ("squeezenet1_1", 224), ("densenet121", 224),
            ("inception_v3", 299), ("mobilenet1_0", 224),
            ("mobilenet_v2_1_0", 224)]
ZOO_BATCH, ZOO_STEPS = 32, 3
ZOO_RTOL = 1e-3     # f32 card vs CPU forward, relative to max |CPU|
CUSTOM_SHAPE, CUSTOM_LIB_SHAPE, CUSTOM_HOST_CALLS = (4096, 4096), \
    (1024, 1024), 50
CUSTOM_DIR = Path(__file__).resolve().parent / "build" / "phase_custom"
EXT_SOURCE = Path(__file__).resolve().parent / "tests" / "torch_ext_ops.cc"
CONTRIB_TOL = 1e-4
# ResNet-50 v1's distinct 1x1 convolutions at batch 128, as the reference's
# K4 benchmark lists them: (label, M = 128 * H * W, K = Cin, N = Cout)
K4_SHAPES = [("s2_reduce", 128 * 56 * 56, 64, 64),
             ("s2_expand", 128 * 56 * 56, 64, 256),
             ("s2_in", 128 * 56 * 56, 256, 64),
             ("s3_in", 128 * 28 * 28, 512, 128),
             ("s3_expand", 128 * 28 * 28, 128, 512),
             ("s4_in", 128 * 14 * 14, 1024, 256),
             ("s4_expand", 128 * 14 * 14, 256, 1024),
             ("s5_in", 128 * 7 * 7, 2048, 512),
             ("s5_expand", 128 * 7 * 7, 512, 2048)]
K4_EDGES = [  # (M, K, N, relu, x dtype): ragged M, K = 8, no ReLU, f32 x
    (1000, 64, 64, True, torch.bfloat16),
    (32 * 7 * 7, 512, 2048, True, torch.bfloat16),
    (1000, 8, 64, True, torch.bfloat16),
    (4000, 64, 256, False, torch.bfloat16),
    (32 * 7 * 7, 2048, 512, True, torch.float32)]
K4_Y_TOL, K4_MOMENT_TOL = 2e-2, 1e-3
RESNET_BATCH = 32                  # bench.py's cell
RESNET_BLOCKS = 3 + 4 + 6 + 3
F32_RATIO = 3.0       # card vs CPU: f32 distance to the f64 step
RTC_FFN = (TRAIN_BATCH * TRAIN_SEQ, 3072)     # BERT-base FFN activations
RTC_MLM = (TRAIN_BATCH * TRAIN_P, 30522)      # masked-LM logits
RTC_STEPS = 3
RTC_REPS, RTC_WARMUP = 30, 5                  # median_ms defaults
RTC_LAUNCH_CALLS = 100      # host cost of one launch, averaged over these
# the generate slice: BERT-base's encoder with the causal mask and a tied LM
# head (GPT-2-small's width), built with explicit arguments
LM_CONFIG = dict(num_layers=12, units=768, hidden_size=3072, num_heads=12,
                 vocab_size=30522, max_length=512)
GEN_ENGINE = dict(max_seq_len=512, max_batch_size=8, page_size=16,
                  num_pages=257)
GEN_CLIENTS, GEN_SEQS, GEN_NEW_TOKENS = 4, 24, 32
GEN_PROMPT_RANGE = (8, 448)
GEN_TENANT, GEN_TENANT_SLO_MS = "slo50", 50.0
GEN_F32_PROMPT, GEN_F32_TOKENS, GEN_F32_PAGES = 40, 8, 33
GEN_TIMED_REPS, GEN_TIMED_POS, GEN_PROFILE_STEPS = 10, 300, 10
PREFILL_TIMED_SHAPES = [(1, 12, 512, 64), (1, 12, 128, 64)]
RESNET_CONVS = 53                 # resnet50_v1's Conv2D layers
QUANT_CALIB_BATCH = 16            # phase 15: calibration images a batch
QUANT_CALIB_BATCHES = 2
QUANT_BUCKET = 32                 # the ResNet endpoint's largest bucket
QUANT_MAX_ROWS = 8                # images (rows) a request, 1..8
QUANT_REQS = 96
QUANT_SERVE_TOL = 1e-5            # served vs direct (the reference's bar)
QUANT_CPU_ROWS = 2                # images of the card-vs-CPU logits check
QUANT_OWN_ULPS = 2                # a quantized layer card vs CPU, same input
QUANT_PINNED_TOL = 1e-5           # the float path card vs CPU, quantized
                                  # outputs pinned (of max |CPU value|)
QUANT_AGREE_IMAGES = 256
QUANT_SEQ = 128                   # int8 BERT-base's served sequence
QUANT_BERT_BUCKET = 8
QUANT_BERT_REQS = 32
QUANT_CPU_SEQ = 32                # the card-vs-CPU BERT row's length
KV_STEPS = 10
QUANT_MM_SHAPE = (1024, 768, 3072)          # BERT-base's FFN product
QUANT_CONV_SHAPE = (32, 256, 14, 256)       # a stage-3 3x3 conv (B, C, H, O)
TEMPLATED_SOURCE = r"""
template <typename T> __global__ void twice(const T *x, int n, T *o) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    o[i] = x[i] + x[i];
}"""


def _bound(nbytes, flops, dtype):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, nbytes, flops


def bound_ms(shape, dtype, causal: bool, kernel: str = "fwd"):
    """Least time on an H100 for one call of ``kernel``: each input read
    once, each output written once, against the products this input needs
    (causal: the lower triangle only). fwd (K1): q, k, v -> o, lse; dq (K2):
    q, k, v, o, dO, lse -> dq, delta; dkv (K3): q, k, v, dO, lse, delta ->
    dk, dv; bwd (K2 + K3): q, k, v, o, dO, lse -> dq, dk, dv, with delta's
    products."""
    B, H, S, D = shape
    elt = torch.finfo(dtype).bits // 8
    mat, row = B * H * S * D * elt, B * H * S * 4
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    mats, rows, mults = {"fwd": (4, 1, 4), "dq": (6, 2, 6),
                         "dkv": (6, 2, 8), "bwd": (8, 1, 14)}[kernel]
    flops = mults * pairs * D + (2 * B * H * S * D if kernel == "bwd" else 0)
    return _bound(mats * mat + rows * row, flops, dtype)


# ---------------------------------------------------------------------------
def phase_environment(smi: str):
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], check=True,
                          capture_output=True, text=True, timeout=60).stdout
    print(f"nvcc: {nvcc.strip().splitlines()[-1]}")
    # the three libraries started together: K1's as one nvcc -c a head dim
    # (fa.fwd_sources) and a link, K2+K3's and K4's one nvcc each
    print(f"host cpus: {os.cpu_count()}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        for f in [pool.submit(fa._kernel), pool.submit(fa._bwd_kernels),
                  pool.submit(fc._kernel)]:
            f.result()
    print(f"built the three libraries in {time.perf_counter() - t0:.1f} s")
    for name in (fa._LIB_NAME, fa._BWD_LIB_NAME, fc._LIB_NAME):
        log = _build.build_log(name)
        print(f"built {log['path']} (nvcc {log['seconds']:.1f} s, "
              f"cached={log['cached']})")
        for obj in log.get("objects", []):
            print(f"  object {obj['unit']}: {obj['seconds']:.1f} s")
        for line in log["ptxas"].splitlines():
            if "Compiling entry" in line or "registers" in line or \
                    "spill" in line or line.startswith("unit "):
                print("  ptxas:", line.strip())


def _randn(shape, gen, dtype):
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


def split_qkv(shape, gen, dtype):
    """q, k, v as the QKV projection hands them to K1: the (B, H, S, D)
    views of one seeded (B, S, 3 * H * D) buffer."""
    B, H, S, D = shape
    qkv = _randn((B, S, 3 * H * D), gen, dtype)
    return [x.view(B, S, H, D).transpose(1, 2)
            for x in qkv.split(H * D, dim=-1)]


def k1_host_us(gen, rounds: int = K1_HOST_ROUNDS,
               calls: int = K1_HOST_CALLS):
    """Host microseconds of one K1 call through its wrapper (checks, two
    allocations, the launch), of its C entry alone (four tensor maps
    encoded, the launch) and of one SDPA call, on split views at
    (1, 1, 128, 64) bf16: ``rounds`` rounds, each timing ``calls``
    back-to-back calls of the three in turn on the host clock (the device
    drained before each), the median round of each. Taking turns within a
    round keeps the three comparable on a host whose speed drifts."""
    q, k, v = split_qkv((1, 1, 128, 64), gen, torch.bfloat16)
    out, lse = fa.flash_attention_fwd(q, k, v, 0.125, False)
    entry = fa._kernel()
    views = (ctypes.c_longlong * 16)(*(
        n for x in (q, k, v, out) for n in (x.data_ptr(), *fa.tma_strides(x))))
    stream = torch.cuda.current_stream().cuda_stream
    fns = {
        "k1": lambda: fa.flash_attention_fwd(q, k, v, 0.125, False),
        "entry": lambda: entry(views, lse.data_ptr(), 1, 1, 128, 64, 1,
                               0.125, 0, stream),
        "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, scale=0.125)}
    times = {name: [] for name in fns}
    for fn in fns.values():
        for _ in range(10):
            fn()
    for _ in range(rounds):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times[name].append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return {name: float(np.median(t)) for name, t in times.items()}


def phase_kernel(seed: int, smi: str):
    """K1 against its plain version at every listed shape, on the split
    views of one QKV buffer and on contiguous copies of them (the two
    results bitwise equal); times at the serving and training shapes."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    record = {}
    for shape, causal in CHECK_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = split_qkv(shape, gen, dtype)
            qc, kc, vc = (x.contiguous() for x in (q, k, v))
            scale = shape[-1] ** -0.5
            out, lse = fa.flash_attention_fwd(qc, kc, vc, scale, causal)
            out_s, lse_s = fa.flash_attention_fwd(q, k, v, scale, causal)
            torch.cuda.synchronize()
            ref, ref_lse = fa.flash_attention_fwd_reference(qc, kc, vc, scale,
                                                            causal)
            err_o = (out.float() - ref.float()).abs().max().item()
            err_l = (lse - ref_lse).abs().max().item()
            err_os = (out_s.float() - ref.float()).abs().max().item()
            err_ls = (lse_s - ref_lse).abs().max().item()
            same = torch.equal(out_s, out) and torch.equal(lse_s, lse)
            ok = max(err_o, err_l, err_os, err_ls) <= TOL[dtype] and same
            line = (f"kernel {shape} {str(dtype)[6:]} causal={causal}: "
                    f"max|dO|={err_o:.3g} max|dLSE|={err_l:.3g}, split "
                    f"views max|dO|={err_os:.3g} max|dLSE|={err_ls:.3g}, "
                    f"bitwise equal to contiguous: {same}; "
                    f"tol={TOL[dtype]:g}")
            where = TIMED_SHAPES.get(shape)
            if where and not causal:
                ms = median_ms(lambda: fa.flash_attention_fwd(
                    qc, kc, vc, scale, causal), calls=TIMED_CALLS)
                ms_s = median_ms(lambda: fa.flash_attention_fwd(
                    q, k, v, scale, causal), calls=TIMED_CALLS)
                plain = median_ms(lambda: fa.flash_attention_fwd_reference(
                    qc, kc, vc, scale, causal), reps=20, warmup=2,
                    calls=TIMED_CALLS)
                def sdpa():
                    return torch.nn.functional.scaled_dot_product_attention(
                        qc, kc, vc, is_causal=causal, scale=scale)

                lib = median_ms(sdpa, calls=TIMED_CALLS)
                dev = graph_ms(lambda: fa.flash_attention_fwd(
                    q, k, v, scale, causal))
                lib_dev = graph_ms(sdpa)
                bms, by, nbytes, flops = bound_ms(shape, dtype, causal)
                line += (f" | {where}: kernel {ms:.4f} ms, on split views "
                         f"{ms_s:.4f} ms ({dev:.4f} ms from a CUDA graph), "
                         f"plain {plain:.4f} ms, sdpa {lib:.4f} ms "
                         f"({lib_dev:.4f} ms from a CUDA graph), bound "
                         f"{bms * 1e3:.1f} us ({by}: {nbytes / 1e6:.1f} MB, "
                         f"{flops / 1e9:.2f} GFLOP), {bms / ms:.1%} of bound "
                         f"on {smi}")
                record[where, dtype] = {
                    "max_abs_err": max(err_o, err_l, err_os, err_ls),
                    "ms": ms, "ms_strided": ms_s, "device_ms": dev,
                    "plain_ms": plain, "library_ms": lib,
                    "library_device_ms": lib_dev, "bound_ms": bms,
                    "bound_by": by}
            print(line)
            if not ok:
                raise SystemExit(f"FAIL: kernel disagrees with its plain "
                                 f"version, or the split views with the "
                                 f"contiguous copies, at {shape} {dtype} "
                                 f"causal={causal}")
            del q, k, v, qc, kc, vc, out, lse, out_s, lse_s, ref, ref_lse
    record["host_us"] = k1_host_us(gen)
    print(f"host cost of one K1 call (split views, 4 tensor maps encoded): "
          f"{record['host_us']['k1']:.2f} us, of which its C entry "
          f"{record['host_us']['entry']:.2f} us; one SDPA call "
          f"{record['host_us']['sdpa']:.2f} us (median of {K1_HOST_ROUNDS} "
          f"rounds of {K1_HOST_CALLS} calls each, in turns)")
    return record


def _bwd_errors(got, want, dtype):
    """max |kernel - plain| of each output, and whether every one is finite
    and within TOL[dtype] x max(1, max|plain|)."""
    errs, ok = [], True
    for a, b in zip(got, want):
        err = (a.float() - b.float()).abs().max().item()
        ok &= err <= TOL[dtype] * max(1.0, b.float().abs().max().item()) \
            and bool(torch.isfinite(a).all())
        errs.append(err)
    return errs, ok


def _sdpa_bwd_graph_ms(q, k, v, do, scale, causal):
    """Device ms of SDPA's backward alone: a CUDA graph of its forward plus
    backward (autograd captured with the forward, on one stream) less a
    graph of its forward."""
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))

    def fwd():
        return torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal, scale=scale)

    both = graph_ms(lambda: torch.autograd.grad(fwd(), (qs, ks, vs), do))
    return both - graph_ms(fwd)


def time_backward(q, k, v, out, lse, do, scale, causal, smi, shape,
                  dtype=torch.bfloat16):
    """K2, K3 and the whole backward through the wrappers and from CUDA
    graphs, each kernel's plain version and SDPA's backward, beside the
    bounds, at one shape and dtype; prints them and returns the record."""
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, do, lse, scale, causal)
    calls = {
        "dq": lambda: fa.flash_attention_bwd_dq(q, k, v, out, do, lse, scale,
                                                causal),
        "dkv": lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                  scale, causal),
        "bwd": lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, scale,
                                              causal)}
    plains = {
        "dq": lambda: fa.flash_attention_bwd_dq_reference(
            q, k, v, out, do, lse, scale, causal),
        "dkv": lambda: fa.flash_attention_bwd_dkv_reference(
            q, k, v, do, lse, delta, scale, causal),
        "bwd": lambda: fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, scale, causal)}
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    o_lib = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=causal, scale=scale)
    lib = median_ms(lambda: torch.autograd.grad(
        o_lib, (qs, ks, vs), do, retain_graph=True), calls=TIMED_CALLS)
    lib_dev = _sdpa_bwd_graph_ms(q, k, v, do, scale, causal)
    record = {"library_ms": lib, "library_device_ms": lib_dev}
    line = (f"backward times at {shape} {str(dtype)[6:]} on {smi}: sdpa "
            f"backward {lib:.4f}"
            f" ms through autograd, {lib_dev:.4f} ms from a CUDA graph "
            f"(dq, dk, dv together)")
    for name, fn in calls.items():
        ms = median_ms(fn, calls=TIMED_CALLS)
        dev = graph_ms(fn)
        plain = median_ms(plains[name], reps=20, warmup=2, calls=TIMED_CALLS)
        bms, by, nbytes, flops = bound_ms(shape, dtype, causal, name)
        record[name] = {"ms": ms, "device_ms": dev, "plain_ms": plain,
                        "bound_ms": bms, "bound_by": by}
        line += (f"\n  {name}: {ms:.4f} ms ({dev:.4f} ms from a CUDA graph), "
                 f"plain {plain:.4f} ms, bound {bms * 1e3:.1f} us ({by}: "
                 f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
                 f"{bms / dev:.1%} of bound from the graph")
    print(line)
    return record


def check_other_head_dim(gen):
    """A head dim the kernels do not take (D = 16, the generative test
    model's) through ``multi_head_attention`` on the card: forward and the
    QKV gradient in f32 against the same calls on the CPU within 1e-4 (the
    dense path on both, sum order only), no kernel launched; bf16 runs
    without raising."""
    N, L, H, D = 2, 64, 2, 16
    x = _randn((N, L, 3 * H * D), gen, torch.float32)
    g = _randn((N, L, H * D), gen, torch.float32)
    before = (fa.launches, fa.launches_dq, fa.launches_dkv)
    results = []
    for dev_x, dev_g in ((x, g), (x.cpu(), g.cpu())):
        xr = dev_x.detach().requires_grad_()
        out = ops.multi_head_attention(*xr.split(H * D, dim=-1), None,
                                       heads=H, causal=True)
        (gx,) = torch.autograd.grad(out, (xr,), dev_g)
        results.append((out.detach().cpu(), gx.cpu()))
    xb = x.to(torch.bfloat16).requires_grad_()
    out = ops.multi_head_attention(*xb.split(H * D, dim=-1), None, heads=H)
    (gb,) = torch.autograd.grad(out, (xb,), g.to(torch.bfloat16))
    torch.cuda.synchronize()
    launched = (fa.launches, fa.launches_dq, fa.launches_dkv) != before
    (o_gpu, g_gpu), (o_cpu, g_cpu) = results
    err = max((o_gpu - o_cpu).abs().max().item(),
              (g_gpu - g_cpu).abs().max().item())
    finite = bool(torch.isfinite(gb.float()).all())
    print(f"head dim {D} (dense route) on the card: f32 forward and QKV "
          f"gradient vs the CPU max|d|={err:.3g} (tol 1e-4), kernels "
          f"launched: {launched}; bf16 gradient finite: {finite}")
    if err > 1e-4 or launched or not finite:
        raise SystemExit(f"FAIL: head dim {D} on the card")


def phase_backward(seed: int, smi: str):
    """K2 and K3 each against its own plain version at every listed shape,
    on the training path's layouts and on contiguous copies (bitwise
    equal); a head dim the kernels do not take; times and bounds at the
    training and serving shapes."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    record = {}
    for shape, causal in BWD_SHAPES:
        B, H, S, D = shape
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = split_qkv(shape, gen, dtype)
            do = _randn((B, S, H, D), gen, dtype).transpose(1, 2)
            scale = D ** -0.5
            out, lse = fa.flash_attention_fwd(q, k, v, scale, causal)
            dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, do, lse,
                                                  scale, causal)
            dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                scale, causal)
            c = [x.contiguous() for x in (q, k, v, out, do)]
            cdq, cdelta = fa.flash_attention_bwd_dq(*c, lse, scale, causal)
            cdk, cdv = fa.flash_attention_bwd_dkv(*c[:3], c[4], lse, cdelta,
                                                  scale, causal)
            torch.cuda.synchronize()
            want_dq = fa.flash_attention_bwd_dq_reference(
                q, k, v, out, do, lse, scale, causal)
            want_dkv = fa.flash_attention_bwd_dkv_reference(
                q, k, v, do, lse, delta, scale, causal)
            errs_dq, ok_dq = _bwd_errors((dq, delta), want_dq, dtype)
            errs_dkv, ok_dkv = _bwd_errors((dk, dv), want_dkv, dtype)
            same = all(torch.equal(a, b) for a, b in (
                (dq, cdq), (delta, cdelta), (dk, cdk), (dv, cdv)))
            print(f"backward {shape} {str(dtype)[6:]} causal={causal}: K2 "
                  f"max|d dq|={errs_dq[0]:.3g} max|d delta|={errs_dq[1]:.3g}"
                  f"; K3 max|d dk|={errs_dkv[0]:.3g} max|d dv|="
                  f"{errs_dkv[1]:.3g}; tol={TOL[dtype]:g} x max(1, "
                  f"max|plain|); split views bitwise equal to contiguous: "
                  f"{same}")
            if not (ok_dq and ok_dkv and same):
                raise SystemExit(f"FAIL: K2/K3 disagree with their plain "
                                 f"versions, or the views with contiguous "
                                 f"copies, at {shape} {dtype} causal={causal}")
            for name, errs in (("dq", errs_dq), ("dkv", errs_dkv)):
                record.setdefault(f"{name}_err", 0.0)
                record[f"{name}_err"] = max(record[f"{name}_err"], *errs)
            where = TIMED_SHAPES.get(shape)
            if where and not causal and dtype == torch.bfloat16:
                record[where] = time_backward(q, k, v, out, lse, do, scale,
                                              causal, smi, shape)
            del q, k, v, do, out, lse, delta, dq, dk, dv, c, cdq, cdelta, \
                cdk, cdv, want_dq, want_dkv
    check_other_head_dim(gen)
    return record


FP16_SHAPES = [(BERT_SHAPE, False), (TRAIN_SHAPE, False),
               ((1, 2, 640, 64), True), ((2, 4, 128, 32), False),
               ((1, 2, 256, 128), True)]


def phase_fp16(seed: int, smi: str):
    """F4: K1, K2 and K3's fp16 instances, each against its plain version
    (outputs within TOL[fp16] x max(1, max|plain|)) at the serving and
    training shapes and at causal, D = 32 and D = 128 cases, on the split
    views of one QKV buffer; at the two timed shapes each kernel from CUDA
    graphs beside its plain version, its bound and SDPA's fp16 forward and
    backward."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    dtype = torch.float16
    record = {"fwd_err": 0.0, "dq_err": 0.0, "dkv_err": 0.0}
    for shape, causal in FP16_SHAPES:
        B, H, S, D = shape
        q, k, v = split_qkv(shape, gen, dtype)
        do = _randn((B, S, H, D), gen, dtype).transpose(1, 2)
        scale = D ** -0.5
        out, lse = fa.flash_attention_fwd(q, k, v, scale, causal)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, do, lse, scale,
                                              causal)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale,
                                            causal)
        torch.cuda.synchronize()
        errs = {
            "fwd": _bwd_errors((out, lse), fa.flash_attention_fwd_reference(
                q, k, v, scale, causal), dtype),
            "dq": _bwd_errors((dq, delta), fa.flash_attention_bwd_dq_reference(
                q, k, v, out, do, lse, scale, causal), dtype),
            "dkv": _bwd_errors((dk, dv), fa.flash_attention_bwd_dkv_reference(
                q, k, v, do, lse, delta, scale, causal), dtype)}
        print(f"fp16 {shape} causal={causal}: " + "; ".join(
            f"{n} max|d|={max(e):.3g}" for n, (e, _) in errs.items())
            + f" (tol {TOL[dtype]:g} x max(1, max|plain|))")
        if not all(ok for _, ok in errs.values()):
            raise SystemExit(f"FAIL: an fp16 kernel disagrees with its plain "
                             f"version at {shape} causal={causal}")
        for n, (e, _) in errs.items():
            record[f"{n}_err"] = max(record[f"{n}_err"], *e)
        where = TIMED_SHAPES.get(shape)
        if where:
            record[where] = time_fp16(q, k, v, out, lse, delta, do, scale,
                                      shape, smi)
        del q, k, v, do, out, lse, dq, delta, dk, dv
    return record


def time_fp16(q, k, v, out, lse, delta, do, scale, shape, smi):
    """Device ms from CUDA graphs of each fp16 kernel and of SDPA's fp16
    forward and backward (yardsticks only), the plain versions through
    CUDA events, and the bounds, at one shape."""
    calls = {
        "fwd": (lambda: fa.flash_attention_fwd(q, k, v, scale, False),
                lambda: fa.flash_attention_fwd_reference(q, k, v, scale,
                                                         False)),
        "dq": (lambda: fa.flash_attention_bwd_dq(q, k, v, out, do, lse, scale,
                                                 False),
               lambda: fa.flash_attention_bwd_dq_reference(
                   q, k, v, out, do, lse, scale, False)),
        "dkv": (lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                   scale, False),
                lambda: fa.flash_attention_bwd_dkv_reference(
                    q, k, v, do, lse, delta, scale, False))}
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    lib_fwd = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qc, kc, vc, scale=scale))
    lib_bwd = _sdpa_bwd_graph_ms(qc, kc, vc, do, scale, False)
    record = {"library_ms_fwd": lib_fwd, "library_ms_bwd": lib_bwd}
    line = (f"fp16 times at {shape} on {smi}, ms from CUDA graphs: sdpa "
            f"forward {lib_fwd:.4f}, backward {lib_bwd:.4f}")
    for name, (fn, plain_fn) in calls.items():
        dev = graph_ms(fn)
        plain = median_ms(plain_fn, reps=10, warmup=2, calls=TIMED_CALLS)
        bms, by, _, _ = bound_ms(shape, torch.float16, False, name)
        record[name] = {"device_ms": dev, "plain_ms": plain,
                        "bound_ms": bms, "bound_by": by}
        line += (f"\n  {name}: {dev:.4f} ms, plain {plain:.4f} ms, bound "
                 f"{bms * 1e3:.1f} us ({by}), {bms / dev:.1%} of bound")
    print(line)
    return record


def k4_bound_ms(M, K, N, x_dtype=torch.bfloat16):
    """Least time on an H100 for one K4 call: x, w, scale, shift read once,
    y, col_sum, col_sumsq written once, against the product's 2 M K N
    operations at the bf16 tensor-core peak."""
    nbytes = M * K * (torch.finfo(x_dtype).bits // 8) + K * N * 2 + \
        2 * K * 4 + M * N * 2 + 2 * N * 4
    return _bound(nbytes, 2 * M * K * N, torch.bfloat16)


def _k4_inputs(gen, M, K, N, x_dtype):
    x = _randn((M, K), gen, x_dtype)
    w = (_randn((K, N), gen, torch.float32) * K ** -0.5).to(torch.bfloat16)
    scale = torch.rand(K, generator=gen, device="cuda") + 0.5
    shift = 0.1 * torch.randn(K, generator=gen, device="cuda")
    return x, w, scale, shift


def _k4_errors(got, want):
    """max |y - plain y| and the moments' max errors, each over its
    tolerance x max(1, max |plain|) (pass if every ratio <= 1)."""
    errs, ratios = [], []
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.float(), b.float()
        err = (a - b).abs().max().item()
        tol = (K4_Y_TOL if i == 0 else K4_MOMENT_TOL) * \
            max(1.0, b.abs().max().item())
        errs.append(err)
        ratios.append(err / tol if torch.isfinite(a).all() else float("inf"))
    return errs, ratios


def phase_fused_conv(seed: int, smi: str):
    """K4 against its plain version at ResNet-50's nine batch-128 1x1
    shapes (timed: the kernel, the plain version, torch.matmul of the
    pre-activated bf16 x with w as the product alone, and the bound) and at
    the edge cases; twice at each shape, to show the result does not change
    from run to run."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    record = {"shapes": {}, "max_abs_err": 0.0}
    for label, M, K, N in K4_SHAPES:
        x, w, scale, shift = _k4_inputs(gen, M, K, N, torch.bfloat16)
        got = fc.conv1x1_bn_act(x, w, scale, shift)
        again = fc.conv1x1_bn_act(x, w, scale, shift)
        torch.cuda.synchronize()
        want = fc.conv1x1_bn_act_reference(x, w, scale, shift)
        errs, ratios = _k4_errors(got, want)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        del got, again
        xh = torch.relu(x.float() * scale + shift).to(torch.bfloat16)
        comp_ratio = max(_k4_errors(k4_composition(x, w, scale, shift)[0],
                                    want)[1])
        del want
        kernel = lambda: fc.conv1x1_bn_act(x, w, scale, shift)  # noqa: E731
        matmul = lambda: torch.matmul(xh, w)  # noqa: E731
        comp = lambda: k4_composition(x, w, scale, shift)  # noqa: E731
        ms = median_ms(kernel, reps=10, warmup=3, calls=TIMED_CALLS)
        plain = median_ms(lambda: fc.conv1x1_bn_act_reference(
            x, w, scale, shift), reps=5, warmup=1, calls=TIMED_CALLS)
        lib = median_ms(matmul, reps=10, warmup=3, calls=TIMED_CALLS)
        comp_ms = median_ms(comp, reps=10, warmup=3, calls=TIMED_CALLS)
        # device times: CUDA graphs of TIMED_CALLS calls, no host work
        dev, lib_dev, comp_dev = graph_ms(kernel), graph_ms(matmul), \
            graph_ms(comp)
        bms, by, nbytes, flops = k4_bound_ms(M, K, N)
        print(f"K4 {label} (M={M}, K={K}, N={N}) bf16, schedule "
              f"{fc._schedule(M, N, fc._sm_count(x.device))}: "
              f"max|dy|={errs[0]:.3g} max|dsum|={errs[1]:.3g} "
              f"max|dsumsq|={errs[2]:.3g} (worst {max(ratios):.3g} of "
              f"tolerance), repeatable={same} | kernel {ms:.4f} ms (graph "
              f"{dev:.4f}), plain {plain:.4f} ms, matmul of the product "
              f"alone {lib:.4f} ms (graph {lib_dev:.4f}), library "
              f"composition {comp_ms:.4f} ms (graph {comp_dev:.4f}, within "
              f"{comp_ratio:.3g} of tolerance), bound {bms * 1e3:.1f} us "
              f"({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
              f"{bms / dev:.1%} of bound from the graph on {smi}")
        if max(ratios) > 1 or not same:
            raise SystemExit(f"FAIL: K4 disagrees with its plain version "
                             f"(or with itself) at {label}")
        record["shapes"][label] = {
            "M": M, "K": K, "N": N, "ms": ms, "device_ms": dev,
            "plain_ms": plain, "library_ms": lib, "library_device_ms": lib_dev,
            "composition_ms": comp_ms, "composition_device_ms": comp_dev,
            "bound_ms": bms, "bound_by": by, "bound_share": bms / dev}
        record["max_abs_err"] = max(record["max_abs_err"], *errs)
        del x, w, scale, shift, xh
    for M, K, N, relu, x_dtype in K4_EDGES:
        x, w, scale, shift = _k4_inputs(gen, M, K, N, x_dtype)
        got = fc.conv1x1_bn_act(x, w, scale, shift, relu=relu)
        torch.cuda.synchronize()
        errs, ratios = _k4_errors(got, fc.conv1x1_bn_act_reference(
            x, w, scale, shift, relu=relu))
        print(f"K4 (M={M}, K={K}, N={N}) relu={relu} x {str(x_dtype)[6:]}: "
              f"max|dy|={errs[0]:.3g} max|dsum|={errs[1]:.3g} "
              f"max|dsumsq|={errs[2]:.3g} (worst {max(ratios):.3g} of "
              f"tolerance)")
        if max(ratios) > 1:
            raise SystemExit(f"FAIL: K4 disagrees with its plain version at "
                             f"M={M} K={K} N={N} relu={relu} {x_dtype}")
        record["max_abs_err"] = max(record["max_abs_err"], *errs)
    return record


def phase_slice(seed: int, smi: str):
    net = bert_base()
    named = seeded_bert_weights(net, seed)
    load_jax_params(net, named)
    net = net.to(torch.bfloat16)

    layers, units = len(net.encoder._layers), net._units

    # ---- the main path: counts from 0 just before, read just after ----
    fa.launches = 0
    ep = serving.ModelEndpoint("bert", net, [(SEQ_LEN,), (SEQ_LEN,)],
                               dtype="int32", max_batch_size=32)
    server = serving.InferenceServer(batch_timeout_ms=2.0, max_queue=512)
    server.register(ep)
    server.start()
    results = [[] for _ in range(N_CLIENTS)]
    errors = []

    def client(i):
        rng = np.random.default_rng(seed * 1000 + i)
        try:
            for _ in range(REQS_PER_CLIENT):
                rows = int(rng.integers(1, 9))
                tok = rng.integers(0, 30522, (rows, SEQ_LEN), dtype=np.int32)
                typ = rng.integers(0, 2, (rows, SEQ_LEN), dtype=np.int32)
                seq, pooled = server.predict("bert", (tok, typ), timeout=300)
                results[i].append((tok, typ, seq, pooled))
        except Exception as e:        # surfaced below; the phase fails
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(N_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    server.stop(drain=True)
    launches = fa.launches
    # ---- end of the main path ----

    if errors or any(t.is_alive() for t in threads):
        raise SystemExit(f"FAIL: client errors {errors[:3]}")
    snap = ep.stats.snapshot()
    c = snap["counters"]
    executed = c["batches"] + c["warmup_batches"]
    reqs = [r for rs in results for r in rs]
    rows_total = sum(r[0].shape[0] for r in reqs)
    print(f"served {len(reqs)} requests ({rows_total} rows) in "
          f"{c['batches']} batches + {c['warmup_batches']} probe/warm-up "
          f"runs, occupancy {snap['batch_occupancy']:.3f}; kernel launches "
          f"{launches} (expected {layers} x {executed} = "
          f"{layers * executed})")
    if len(reqs) != N_CLIENTS * REQS_PER_CLIENT or c["completed"] != len(reqs):
        raise SystemExit("FAIL: not every request was served")
    if launches != layers * executed:
        raise SystemExit("FAIL: kernel launches do not match one per layer "
                         "per batch")

    worst_abs, worst_excess = 0.0, -1.0
    with torch.inference_mode():
        for tok, typ, seq, pooled in reqs:
            if seq.device.type != "cuda" or pooled.device.type != "cuda":
                raise SystemExit("FAIL: a response came from the CPU")
            rows = tok.shape[0]
            if tuple(seq.shape) != (rows, SEQ_LEN, units) or \
                    tuple(pooled.shape) != (rows, units):
                raise SystemExit(f"FAIL: response shapes {seq.shape}, "
                                 f"{pooled.shape}")
            d_seq, d_pooled = net(torch.from_numpy(tok).cuda(),
                                  torch.from_numpy(typ).cuda())
            for a, b in ((seq, d_seq), (pooled, d_pooled)):
                a, b = a.float(), b.float()
                if not torch.isfinite(a).all():
                    raise SystemExit("FAIL: non-finite response")
                diff = (a - b).abs()
                worst_abs = max(worst_abs, diff.max().item())
                worst_excess = max(worst_excess, (
                    diff - (2e-2 + 2e-2 * b.abs())).max().item())
    print(f"responses vs direct forward: max|d|={worst_abs:.4g}, "
          f"max(|d| - tol)={worst_excess:.4g} (pass if <= 0)")
    if worst_excess > 0:
        raise SystemExit("FAIL: a response differs from the direct forward")

    # one row in f32: the card (kernel f32 path) against the plain CPU path
    tok, typ = reqs[0][0][:1], reqs[0][1][:1]
    ref = bert_base()
    load_jax_params(ref, named, ctx=cpu())
    ref.eval()
    with torch.inference_mode():
        cpu_seq, cpu_pooled = ref(torch.from_numpy(tok), torch.from_numpy(typ))
        ref = ref.cuda()
        gpu_seq, gpu_pooled = ref(torch.from_numpy(tok).cuda(),
                                  torch.from_numpy(typ).cuda())
    err32 = max((gpu_seq.cpu() - cpu_seq).abs().max().item(),
                (gpu_pooled.cpu() - cpu_pooled).abs().max().item())
    bf = reqs[0][2][:1].float().cpu()
    rel16 = ((bf - cpu_seq).norm() / cpu_seq.norm()).item()
    print(f"f32 card vs f32 CPU plain forward (1 row): max|d|={err32:.3g} "
          f"(tol 1e-3); served bf16 vs f32 CPU: relative error {rel16:.3g}")
    if err32 > 1e-3:
        raise SystemExit("FAIL: the f32 forward on the card disagrees with "
                         "the plain CPU forward")

    lat = snap["latency"]
    print(f"serving bert_base S={SEQ_LEN} bf16, {N_CLIENTS} closed-loop "
          f"clients: {len(reqs) / wall:.2f} requests/s, "
          f"{rows_total * SEQ_LEN / wall:.0f} tokens/s, "
          f"p50 {lat['p50_us'] / 1e3:.2f} ms, p99 {lat['p99_us'] / 1e3:.2f} "
          f"ms, step p50 {snap['step']['p50_us'] / 1e3:.2f} ms "
          f"(wall {wall:.2f} s) on {smi}")
    return launches


def _train_step(named, dropout, compute_dtype, ctx=None, seed=0,
                loss=None):
    model = BERTForPretraining(bert_base(max_length=TRAIN_SEQ,
                                         dropout=dropout))
    load_jax_params(model, named, ctx=ctx)
    mesh = make_mesh({"dp": 1}) if ctx is None else make_mesh({"dp": 1},
                                                               ctx=ctx)
    return ParallelTrainStep(PretrainStep(model),
                             loss or BERTPretrainingLoss(),
                             Adam(learning_rate=TRAIN_LR), mesh,
                             compute_dtype=compute_dtype,
                             extra_specs=("dp", "dp"), seed=seed)


def phase_train(seed: int, smi: str):
    rng = np.random.default_rng(seed + 2)
    named = seeded_bert_weights(BERTForPretraining(
        bert_base(max_length=TRAIN_SEQ)), seed)
    step = _train_step(named, 0.1, "bfloat16", seed=seed)
    warm = pretrain_batch(rng, TRAIN_WARMUP, TRAIN_BATCH, TRAIN_SEQ,
                          TRAIN_P)
    bench = step.place_batch_n(*pretrain_batch(rng, TRAIN_K, TRAIN_BATCH,
                                               TRAIN_SEQ, TRAIN_P))
    fixed = step.place_batch_n(*pretrain_batch(rng, 1, TRAIN_BATCH,
                                               TRAIN_SEQ, TRAIN_P))
    fixed = (fixed[0][0], (fixed[1][0][0], fixed[1][1][0]), fixed[2][0],
             fixed[3][0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: counts from 0 just before, read just after ----
    fa.launches = fa.launches_dq = fa.launches_dkv = 0
    losses = [step(warm[0][i], (warm[1][0][i], warm[1][1][i]), warm[2][i],
                   warm[3][i]) for i in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_CALLS):
        losses.append(step.step_n(*bench))
    losses[-1][-1].item()                  # the window closes on a fetch
    wall = time.perf_counter() - t0
    fixed_losses, step_ms = [], []
    for _ in range(TRAIN_FIXED):
        t1 = time.perf_counter()
        fixed_losses.append(step(*fixed).item())
        step_ms.append((time.perf_counter() - t1) * 1e3)
    counts = {"flash_attention_fwd": fa.launches,
              "flash_attention_bwd_dq": fa.launches_dq,
              "flash_attention_bwd_dkv": fa.launches_dkv}
    # ---- end of the main path ----

    peak = torch.cuda.max_memory_allocated()
    all_losses = torch.cat([x.reshape(-1) for x in losses]).cpu()
    steps = TRAIN_WARMUP + TRAIN_CALLS * TRAIN_K + TRAIN_FIXED
    layers = len(step._block.inner.backbone.encoder._layers)
    print(f"trained BERTForPretraining(bert_base) bf16, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, P={TRAIN_P}: {steps} steps; losses "
          f"first {all_losses[0].item():.4f}, last "
          f"{all_losses[-1].item():.4f}; fixed batch "
          f"{fixed_losses[0]:.4f} -> {fixed_losses[-1]:.4f}; launches "
          f"{counts} (expected {layers} x {steps} = {layers * steps} each)")
    if not torch.isfinite(all_losses).all() or \
            not np.isfinite(fixed_losses).all():
        raise SystemExit("FAIL: a training loss is not finite")
    if not fixed_losses[-1] < fixed_losses[0]:
        raise SystemExit("FAIL: the fixed batch's loss did not fall")
    if any(n != layers * steps for n in counts.values()):
        raise SystemExit("FAIL: kernel launches do not match one per layer "
                         "per step")
    tokens = TRAIN_BATCH * TRAIN_SEQ * TRAIN_K * TRAIN_CALLS
    median = float(np.median(step_ms))
    device_ms, busy = busy_share(lambda: step(*fixed), median)
    print(f"training bert_base S={TRAIN_SEQ} bf16: {tokens / wall:.0f} "
          f"tokens/s over {TRAIN_CALLS} step_n calls of K={TRAIN_K} (wall "
          f"{wall:.3f} s), step median {median:.2f} ms (host clock to a "
          f"fetched loss), device {device_ms:.2f} ms/step, busy share "
          f"{busy:.3f}, peak device memory {peak / 2**30:.2f} GiB on "
          f"{smi}")
    del step, bench, fixed, losses

    # one f32 step at batch 2 on the card against the plain versions on
    # the CPU, same weights and batch, dropout 0
    batch = pretrain_batch(rng, 1, 2, TRAIN_SEQ, TRAIN_P)
    batch = (batch[0][0], (batch[1][0][0], batch[1][1][0]), batch[2][0],
             batch[3][0])
    results = []
    for ctx in (None, cpu()):
        st = _train_step(named, 0.0, None, ctx=ctx)
        loss = st(*batch).item()
        results.append((loss, {k: v.detach().cpu()
                               for k, v in st.params.items()}))
        del st
    (l_gpu, p_gpu), (l_cpu, p_cpu) = results
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    diff = torch.cat([(p_gpu[k] - p_cpu[k]).abs().reshape(-1)
                      for k in p_cpu])
    worst, frac = diff.max().item(), (diff > 0.1 * TRAIN_LR).float().mean()
    print(f"f32 step, card vs CPU plain versions (batch 2 x {TRAIN_SEQ}): "
          f"loss {l_gpu:.6f} vs {l_cpu:.6f} (relative {rel:.3g}, tol 1e-4); "
          f"parameters max|d| {worst / TRAIN_LR:.3g} lr (tol 2 lr), share "
          f"beyond 0.1 lr {frac.item():.3g} (tol 1e-3), mean|d| "
          f"{diff.mean().item() / TRAIN_LR:.3g} lr")
    if not (rel <= 1e-4 and worst <= 2 * TRAIN_LR and frac <= 1e-3):
        raise SystemExit("FAIL: the f32 training step on the card disagrees "
                         "with the CPU")
    return counts


def _k4_sites(net, cast, x):
    """One bf16 training-mode forward of ``net`` (parameters ``cast``)
    with hooks at every BottleneckV1: the 3x3 convolution's output, the
    scale and shift its BatchNorm computes from it, the last 1x1
    convolution's weight, bias and output, and the batch mean and variance
    of its BatchNorm. Returns one dict per block."""
    sites, handles = [], []

    def bn_stats(bn, inp):
        return ops.bn_scale_shift(inp, bn._t("gamma"), bn._t("beta"),
                                  bn._t("running_mean"),
                                  bn._t("running_var"), training=True,
                                  **{k: v for k, v in bn._kwargs.items()
                                     if k != "use_global_stats"})

    for blk in (m for m in net.modules() if isinstance(m, BottleneckV1)):
        site = {}
        sites.append(site)
        body = blk.body

        def pre_bn2(mod, args, site=site):
            site["x"] = args[0]
            site["a"], site["b"] = bn_stats(mod, args[0])[:2]

        def post_conv(mod, args, out, site=site):
            site["w"], site["bias"] = mod._t("weight"), mod._t("bias")
            site["out"] = out

        def pre_bn3(mod, args, site=site):
            site["mean"], site["var"] = bn_stats(mod, args[0])[2:4]

        # torch's hooks (removable), not the Gluon ones of Block
        module = torch.nn.Module
        handles += [module.register_forward_pre_hook(body[4], pre_bn2),
                    module.register_forward_hook(body[6], post_conv),
                    module.register_forward_pre_hook(body[7], pre_bn3)]
    try:
        with torch.no_grad():
            torch.func.functional_call(net, cast, (x,))
    finally:
        for h in handles:
            h.remove()
    return sites


def resnet_f32_step(named, seed: int):
    """One f32 step at batch 2 on the card against the same step on the CPU,
    both held against the step computed in f64 on the CPU, leaf by leaf:
    each parameter's update on the card may be at most F32_RATIO times as
    far from the f64 update as the CPU's f32 update of that parameter is,
    in norm, and at most F32_RATIO times the CPU's largest element error in
    the same stage, in its largest element; each plus one f32 ulp of the
    leaf's weights. Returns the per-leaf distances."""
    runs = f32_drift.step_runs(named, seed)
    probe = resnet50_v1(classes=1000)
    leaves = f32_drift.leaf_distances(runs, probe.jax_names())
    stage_max = {}
    for v in leaves.values():
        stage_max[v["stage"]] = max(stage_max.get(v["stage"], 0.0),
                                    v["cpu_max"])
    margin = {k: max(v["card_norm"] / (F32_RATIO * v["cpu_norm"]
                                       + v["ulp_norm"]),
                     v["card_max"] / (F32_RATIO * stage_max[v["stage"]]
                                      + v["ulp_max"]))
              for k, v in leaves.items()}
    bad = [k for k, m in margin.items() if m > 1]
    total = sum(v["update_norm"] ** 2 for v in leaves.values()) ** 0.5
    cpu_sq = sum(v["cpu_norm"] ** 2 for v in leaves.values())
    e_card = sum(v["card_norm"] ** 2 for v in leaves.values()) ** 0.5 / total
    (l_gpu, s_gpu), (l_cpu, s_cpu) = ((runs[t]["loss"], runs[t]["buffers"])
                                      for t in ("card", "cpu"))
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    stat_err = max(((s_gpu[k] - s_cpu[k]).abs().max()
                    / max(1.0, s_cpu[k].abs().max().item())).item()
                   for k in s_cpu)
    worst = max(margin, key=margin.get)
    print(f"f32 step, card vs CPU (batch 2): loss {l_gpu:.6f} vs {l_cpu:.6f}"
          f" (relative {rel:.3g}, tol 1e-4); running stats card vs CPU "
          f"max|d| {stat_err:.3g} x max(1, |stat|) (tol 1e-4); update "
          f"against the CPU's f64 step, all parameters: card f32 "
          f"{e_card:.4g}, CPU f32 {cpu_sq ** 0.5 / total:.4g} of its norm; "
          f"per leaf (tol: card <= {F32_RATIO:g} x the CPU's distance of the"
          f" leaf in norm and of the leaf's stage in max, + 1 ulp of the "
          f"weights): {len(leaves) - len(bad)} of {len(leaves)} hold; the "
          f"closest, {worst}, at {margin[worst]:.3g} of its tolerance")
    print("  the CPU's f32-vs-f64 distance is carried by: " + "; ".join(
        f"{k} {leaves[k]['cpu_norm'] ** 2 / cpu_sq:.1%} (card "
        f"{leaves[k]['card_norm'] / leaves[k]['update_norm']:.3g}, CPU "
        f"{leaves[k]['cpu_norm'] / leaves[k]['update_norm']:.3g} of the "
        f"leaf's update)"
        for k in sorted(leaves, key=lambda k: -leaves[k]["cpu_norm"])[:5]))
    for k in bad:
        print(f"  leaf beyond tolerance: {k} {leaves[k]}")
    if not (rel <= 1e-4 and stat_err <= 1e-4 and not bad):
        raise SystemExit("FAIL: the f32 ResNet-50 step on the card "
                         "disagrees with the CPU")
    return leaves


def phase_resnet(seed: int, smi: str):
    """ResNet-50 v1 training as bench.py runs it, K4 on the model's own
    activations, and one f32 step on the card against the CPU."""
    probe = resnet50_v1(classes=1000)
    named = seeded_resnet_weights(probe, seed)
    step = resnet_train_step(named, "bfloat16")
    rng = np.random.default_rng(seed + 4)
    warm = step.place_batch_n(*resnet_batch(rng, TRAIN_WARMUP, RESNET_BATCH))
    bench = step.place_batch_n(*resnet_batch(rng, TRAIN_K, RESNET_BATCH))
    fixed = step.place_batch_n(*resnet_batch(rng, 1, RESNET_BATCH))
    # bench.py hands the step bf16 images
    warm, bench, fixed = ((xs.to(torch.bfloat16), ys)
                          for xs, ys in (warm, bench, fixed))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: ResNet-50 training steps ----
    fc.launches = 0
    losses = [step(warm[0][i], warm[1][i]) for i in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_CALLS):
        losses.append(step.step_n(*bench))
    losses[-1][-1].item()                  # the window closes on a fetch
    wall = time.perf_counter() - t0
    fixed_losses, step_ms = [], []
    for _ in range(TRAIN_FIXED):
        t1 = time.perf_counter()
        fixed_losses.append(step(fixed[0][0], fixed[1][0]).item())
        step_ms.append((time.perf_counter() - t1) * 1e3)
    train_launches = fc.launches       # the reference's net is unfused: 0
    # ---- end of the main path ----

    peak = torch.cuda.max_memory_allocated()
    all_losses = torch.cat([x.reshape(-1) for x in losses]).cpu()
    steps = TRAIN_WARMUP + TRAIN_CALLS * TRAIN_K + TRAIN_FIXED
    net = step._block
    stats = step.buffers
    means = torch.cat([v for k, v in stats.items() if k.endswith("mean")])
    varis = torch.cat([v for k, v in stats.items() if k.endswith("var")])
    print(f"trained resnet50_v1 bf16, batch {RESNET_BATCH} x 3 x 224 x 224, "
          f"SGD(lr 0.05, momentum 0.9): {steps} steps; losses first "
          f"{all_losses[0].item():.4f}, last {all_losses[-1].item():.4f}; "
          f"fixed batch {fixed_losses[0]:.4f} -> {fixed_losses[-1]:.4f}; "
          f"running means |max| {means.abs().max().item():.4g}, running "
          f"variances in [{varis.min().item():.4g}, "
          f"{varis.max().item():.4g}] over {len(stats) // 2} BatchNorms; "
          f"K4 launches {train_launches} (the net is unfused)")
    if not torch.isfinite(all_losses).all() or \
            not np.isfinite(fixed_losses).all():
        raise SystemExit("FAIL: a ResNet-50 training loss is not finite")
    if not fixed_losses[-1] < fixed_losses[0]:
        raise SystemExit("FAIL: the fixed batch's loss did not fall")
    if not (torch.isfinite(means).all() and torch.isfinite(varis).all()
            and all(v.dtype == torch.float32 for v in stats.values())
            and (means != 0).any() and (varis != 1).any()):
        raise SystemExit("FAIL: the running stats did not move from (0, 1) "
                         "or are not finite float32")
    images = RESNET_BATCH * TRAIN_K * TRAIN_CALLS
    print(f"training resnet50_v1 bf16: {images / wall:.1f} img/s over "
          f"{TRAIN_CALLS} step_n calls of K={TRAIN_K} (wall {wall:.3f} s), "
          f"step median {float(np.median(step_ms)):.2f} ms (host clock to a "
          f"fetched loss), peak device memory {peak / 2**30:.2f} GiB on "
          f"{smi}")

    # ---- K4 on the model's own activations: counts from 0 just before ----
    cast = {n: p.to(torch.bfloat16) for n, p in step.params.items()}
    sites = _k4_sites(net, cast, fixed[0][0])
    fc.launches = 0
    results = []
    for site in sites:
        x = site["x"]
        n, c = x.shape[:2]
        xm = x.permute(0, 2, 3, 1).reshape(-1, c).contiguous()
        w = site["w"].reshape(site["w"].shape[0], c).t().contiguous()
        results.append(fc.conv1x1_bn_act(xm, w, site["a"], site["b"]))
    torch.cuda.synchronize()
    k4_launches = fc.launches
    # ---- end of the K4 path ----
    worst_y = worst_m = worst_v = 0.0
    for site, (y, col_sum, col_sumsq) in zip(sites, results):
        out = site["out"]
        rows = out.numel() // out.shape[1]
        ref = out.permute(0, 2, 3, 1).reshape(rows, -1).float()
        bias = site["bias"].float()
        worst_y = max(worst_y, ((y.float() + bias - ref).abs().max()
                                / (K4_Y_TOL * max(1.0, ref.abs().max()
                                                  .item()))).item())
        mean = col_sum / rows
        var = col_sumsq / rows - mean.square()
        # y is rounded to bf16 (and the bias added in bf16) before the
        # BatchNorm sees it: two roundings of 2^-9 each bound the shift of
        # a column's mean by 2^-8 of its rms and of its variance by 2^-7
        # of its mean square; the tolerance is twice that
        sq = site["var"] + site["mean"].square()
        worst_m = max(worst_m, ((mean + bias - site["mean"]).abs()
                                / (2 ** -7 * sq.sqrt() + 1e-6)).max().item())
        worst_v = max(worst_v, ((var - site["var"]).abs()
                                / (2 ** -6 * sq + 1e-6)).max().item())
    print(f"K4 at the {len(sites)} bottlenecks of one bf16 training forward:"
          f" launches {k4_launches} (expected {RESNET_BLOCKS}); y + bias vs "
          f"the 1x1 conv's output {worst_y:.3g} of tolerance (2e-2 x "
          f"max(1, max|out|)); moments vs the next BatchNorm's mean "
          f"{worst_m:.3g} and variance {worst_v:.3g} of tolerance (2^-7 rms,"
          f" 2^-6 mean square)")
    if len(sites) != RESNET_BLOCKS or k4_launches != RESNET_BLOCKS:
        raise SystemExit("FAIL: K4 was not launched once per bottleneck")
    if max(worst_y, worst_m, worst_v) > 1:
        raise SystemExit("FAIL: K4 disagrees with the model's conv and "
                         "BatchNorm at a bottleneck")
    del step, warm, bench, fixed, losses, sites, results, cast

    resnet_f32_step(named, seed)
    return {"img_s": images / wall, "k4_launches": k4_launches,
            "train_launches": train_launches,
            "step_ms": float(np.median(step_ms))}


# ---------------------------------------------------------------------------
def _bf16_ulps(got, want):
    """max over the values of |got - want| in units of one bf16 ulp of
    want (the spacing of bf16 numbers at |want|; 2^-133 at 0)."""
    g, w = got.float(), want.float()
    _, e = torch.frexp(w.abs())
    ulp = torch.ldexp(torch.ones_like(w), torch.where(w == 0, -133, e - 8))
    d = (g - w).abs() / ulp
    return d.max().item() if torch.isfinite(g).all() else float("inf")


def _expect_error(what, match, fn):
    """``fn()`` must raise MXNetError whose message holds ``match``."""
    try:
        fn()
    except MXNetError as e:
        msg = str(e)
        if match not in msg:
            raise SystemExit(f"FAIL: {what} raised without {match!r}: {msg}")
        print(f"  {what}: MXNetError ({msg.splitlines()[0][:110]})")
        return msg
    raise SystemExit(f"FAIL: {what} did not raise MXNetError")


def _imperative_cases(ctx):
    """A few of the CPU tests' NDArray and autograd cases on ``ctx``:
    numpy values and dtypes by name."""
    a = nd.array(np.arange(12, dtype=np.float32).reshape(3, 4), ctx=ctx)
    i = nd.array(np.array([1, 2, 3], np.int32), ctx=ctx)
    b = nd.full((3, 4), 2.0, ctx=ctx)
    out = {"array": a, "arange": nd.arange(0, 10, 2, ctx=ctx),
           "ones_int": nd.ones((2, 3), ctx=ctx, dtype="int32"),
           "arith": (a + b) * a - 1 / (a + 1) + a ** 2, "int_div": i / i,
           "int_scalar": i + 1, "compare": a > 5, "sum": a.sum(axis=0),
           "mean": a.mean(), "argmax": a.argmax(axis=1), "dot": nd.dot(a, a.T),
           "index": a[1:, ::2], "roundtrip": nd.array(a.asnumpy(), ctx=ctx)}
    x = nd.array([1.0, 2.0, 3.0], ctx=ctx)
    x.attach_grad(grad_req="add")
    for _ in range(2):
        with autograd.record():
            y = (nd.exp(x) * x).sum()
        y.backward()
    out["grad_add"] = x.grad
    return {k: (v.asnumpy(), str(v.dtype), v.context) for k, v in out.items()}


def rtc_bound_ms(nbytes, ops_per_elt, n):
    """Least time on an H100: the bytes over 3.35 TB/s against the
    elementwise operations over the f32 rate without tensor cores."""
    return _bound(nbytes, ops_per_elt * n, torch.float32)


def phase_rtc(seed: int, smi: str):
    """The rtc slice and the imperative path on gpu(0) (phase 6)."""
    ctx = gpu(0)
    major, minor = _nvrtc.nvrtc_version()
    print(f"NVRTC {major}.{minor} ({_nvrtc.cuda_home()}), target "
          f"{' '.join(_nvrtc.ARCH_OPTIONS)}")
    rtc.launches = 0
    t0 = time.perf_counter()
    names = sorted(set(rx.SOURCES.values()))
    with ThreadPoolExecutor(len(names)) as pool:
        mods = dict(zip(names, pool.map(rx.module, names)))
    compile_s = {n: m.compile_seconds for n, m in mods.items()}
    print(f"compiled {len(mods)} rtc modules in "
          f"{time.perf_counter() - t0:.2f} s: " + ", ".join(
              f"{n} {s:.3f} s" for n, s in compile_s.items()))

    # ---- errors, each at its call ----
    x8 = nd.array(np.arange(8, dtype=np.float32), ctx=ctx)
    y8 = nd.ones((8,), ctx=ctx)
    elementwise = (rx.CSRC_RTC / "elementwise.cu").read_text()
    msg = _expect_error("broken source", "failed to compile",
                        lambda: rtc.CudaModule(
                            'extern "C" __global__ void broken(float *x) '
                            '{ x[0] = ; }'))
    if "error" not in msg:
        raise SystemExit("FAIL: the compile error carries no NVRTC log")
    _expect_error("missing name", "not found",
                  lambda: rtc.CudaModule(elementwise).get_kernel(
                      "missing", rx.SIGNATURES["k"]))
    _expect_error("name outside exports", "not exported",
                  lambda: rtc.CudaModule(elementwise, exports=("k",)).get_kernel(
                      "axpy", rx.SIGNATURES["axpy"]))
    _expect_error("wrong dtype", "must be float32",
                  lambda: rx.axpy(x8.astype("float16"), y8))
    _expect_error("CPU array", "GPU context",
                  lambda: rx.axpy(x8.as_in_context(cpu()),
                                  y8.as_in_context(cpu())))
    _expect_error("1025 threads a block", "cuLaunchKernel",
                  lambda: rx.kernel("k").launch(
                      [x8, 8], block_dims=(1025, 1, 1), out_shapes=[(8,)]))
    torch.cuda.synchronize()       # the refused launch left nothing behind
    if rtc.launches != 0:
        raise SystemExit("FAIL: a refused call counted as a launch")
    # a templated kernel resolves through its lowered (mangled) name
    tmpl = rtc.CudaModule(TEMPLATED_SOURCE, exports=("twice<float>",))
    twice = tmpl.get_kernel("twice<float>", rx.SIGNATURES["k"]).launch(
        [x8, 8], block_dims=(32, 1, 1), out_shapes=[(8,)])
    ok = torch.equal(twice.data, 2 * x8.data)
    print(f"  exported template twice<float> -> {tmpl._lowered}: "
          f"{twice.asnumpy().tolist()} (equal to 2x: {ok})")
    if not ok:
        raise SystemExit("FAIL: the exported template kernel")

    n_params = sum(math.prod(p.shape) for p in resnet50_v1(
        classes=1000).collect_params().values() if p.grad_req != "null")
    nd.random.seed(seed, ctx=ctx)
    xp = nd.random.normal(shape=(n_params,), ctx=ctx)
    yp = nd.random.normal(shape=(n_params,), ctx=ctx)
    xg = nd.random.normal(shape=RTC_FFN, dtype="bfloat16", ctx=ctx)
    wg = nd.random.normal(shape=RTC_FFN, dtype="bfloat16", ctx=ctx)
    logits = nd.random.normal(scale=4.0, shape=RTC_MLM, dtype="bfloat16",
                              ctx=ctx)
    xg.attach_grad()
    torch.cuda.synchronize()

    # ---- the main path: counts from 0 just before, read just after ----
    before_main = rtc.launches
    rtc.launches = 0
    for k in rx.SIGNATURES:
        rx.kernel(k).launches = 0
    ref_outs = {"axpy": rx.axpy(x8, y8), "scale": rx.scale(x8),
                "k": rx.identity(x8)}
    big = rx.axpy(xp, yp)
    per_step = []
    for _ in range(RTC_STEPS):
        before = rtc.launches
        with autograd.record():
            yg = rx.GeluTanh()(xg)
            loss = (yg * wg).sum()
        loss.backward()
        per_step.append(rtc.launches - before)
    lsm = rx.log_softmax(logits)
    lsm.wait_to_read()
    main_launches = rtc.launches
    by_launches = {k: rx.kernel(k).launches for k in rx.SIGNATURES}
    # ---- end of the main path ----
    torch.cuda.synchronize()
    expect_main = 3 + 1 + 2 * RTC_STEPS + 1
    print(f"rtc main path: {main_launches} launches (expected "
          f"{expect_main}), per GeluTanh step {per_step}, by kernel "
          f"{by_launches}")
    if main_launches != expect_main or per_step != [2] * RTC_STEPS or \
            sum(by_launches.values()) != main_launches:
        raise SystemExit("FAIL: rtc launch counts on the main path")

    plain = {"axpy": rx.axpy_plain(x8.data, y8.data),
             "scale": rx.scale_plain(x8.data), "k": rx.identity_plain(x8.data)}
    for k, out in ref_outs.items():
        same = torch.equal(out.data, plain[k])
        print(f"  {k} at 8 elements: {out.asnumpy().tolist()} bitwise equal "
              f"to the plain version: {same}")
        if not same:
            raise SystemExit(f"FAIL: rtc kernel {k} differs from its plain "
                             "version")
    lib_axpy = torch.add(yp.data, xp.data, alpha=2)
    same_big = torch.equal(big.data, rx.axpy_plain(xp.data, yp.data))
    same_lib = torch.equal(big.data, lib_axpy)
    print(f"  axpy over {n_params} f32 (resnet50_v1's trainable parameters):"
          f" bitwise equal to 2 * x + y: {same_big}, to torch.add(y, x, "
          f"alpha=2): {same_lib}")
    if not (same_big and same_lib):
        raise SystemExit("FAIL: axpy differs from its plain version")

    # GeluTanh: y and x.grad against the plain versions and torch autograd
    xd = xg.data.detach()
    xs = xd.clone().requires_grad_()
    ys = torch.nn.functional.gelu(xs, approximate="tanh")
    (ys * wg.data).sum().backward()
    errs = {"gelu_tanh_fwd": max(_bf16_ulps(yg.data, rx.gelu_tanh_plain(
                xd)), _bf16_ulps(yg.data, ys.detach())),
            "gelu_tanh_bwd": max(_bf16_ulps(xg.grad.data, rx.gelu_tanh_grad_plain(
                xd, wg.data)), _bf16_ulps(xg.grad.data, xs.grad)),
            "log_softmax": _bf16_ulps(lsm.data, rx.log_softmax_plain(
                logits.data))}
    def max_abs(got, *wants):
        return max((got.float() - w.float()).abs().max().item()
                   for w in wants)
    abs_err = {"gelu_tanh_fwd": max_abs(yg.data, rx.gelu_tanh_plain(xd),
                                        ys.detach()),
               "gelu_tanh_bwd": max_abs(xg.grad.data, rx.gelu_tanh_grad_plain(
                   xd, wg.data), xs.grad),
               "log_softmax": max_abs(lsm.data,
                                      rx.log_softmax_plain(logits.data)),
               "axpy": max_abs(big.data, rx.axpy_plain(xp.data, yp.data))}
    print(f"  GeluTanh at {RTC_FFN} bf16, {RTC_STEPS} recorded steps: y within"
          f" {errs['gelu_tanh_fwd']:.3g} and x.grad within "
          f"{errs['gelu_tanh_bwd']:.3g} bf16 ulp of the plain versions and "
          f"of F.gelu(approximate='tanh') under torch autograd (tol 1); "
          f"log_softmax at {RTC_MLM} bf16 within {errs['log_softmax']:.3g} "
          f"ulp (tol 1)")
    if max(errs.values()) > 1:
        raise SystemExit("FAIL: an rtc kernel is beyond one bf16 ulp of its "
                         "plain version")
    del xs, ys, yg, loss

    # ---- timing: kernel, plain, one PyTorch call, bound ----
    n_ffn, n_mlm = xg.size, logits.size
    dy = wg.data
    F = torch.nn.functional
    timed = {
        "axpy": (lambda: rx.axpy(xp, yp),
                 lambda: rx.axpy_plain(xp.data, yp.data),
                 lambda: torch.add(yp.data, xp.data, alpha=2),
                 rtc_bound_ms(12 * n_params, 2, n_params),
                 "torch.add(y, x, alpha=2)", [n_params], "float32"),
        "gelu_tanh_fwd": (lambda: rx.gelu_tanh_fwd(xg),
                          lambda: rx.gelu_tanh_plain(xd),
                          lambda: F.gelu(xd, approximate="tanh"),
                          rtc_bound_ms(4 * n_ffn, 9, n_ffn),
                          "F.gelu(x, approximate='tanh')", list(RTC_FFN),
                          "bfloat16"),
        "gelu_tanh_bwd": (lambda: rx.gelu_tanh_bwd(xg, wg),
                          lambda: rx.gelu_tanh_grad_plain(xd, dy),
                          lambda: torch.ops.aten.gelu_backward(
                              dy, xd, approximate="tanh"),
                          rtc_bound_ms(6 * n_ffn, 18, n_ffn),
                          "aten.gelu_backward(dy, x, approximate='tanh')",
                          list(RTC_FFN), "bfloat16"),
        "log_softmax": (lambda: rx.log_softmax(logits),
                        lambda: rx.log_softmax_plain(logits.data),
                        lambda: torch.log_softmax(logits.data, -1),
                        rtc_bound_ms(4 * n_mlm, 6, n_mlm),
                        "torch.log_softmax(x, -1)", list(RTC_MLM),
                        "bfloat16"),
    }
    by_kernel = {}
    for name, (kern, pl, lib, bound, lib_name, shape, dt) in timed.items():
        ms = median_ms(kern, reps=RTC_REPS, warmup=RTC_WARMUP,
                       calls=TIMED_CALLS)
        plain_ms = median_ms(pl, reps=RTC_REPS, warmup=RTC_WARMUP,
                             calls=TIMED_CALLS)
        lib_ms = median_ms(lib, reps=RTC_REPS, warmup=RTC_WARMUP,
                           calls=TIMED_CALLS)
        # device times: the launches replayed from a CUDA graph of
        # TIMED_CALLS (no host work in the window)
        dev_ms, lib_dev_ms = graph_ms(kern), graph_ms(lib)
        bms, by, nbytes, _ = bound
        print(f"  {name} {shape} {dt}: kernel {ms:.4f} ms (graph "
              f"{dev_ms:.4f}), plain {plain_ms:.4f} ms, {lib_name} "
              f"{lib_ms:.4f} ms (graph {lib_dev_ms:.4f}), bound "
              f"{bms * 1e3:.1f} us ({by}: {nbytes / 1e6:.1f} MB), "
              f"{bms / dev_ms:.1%} of bound from the graph on {smi}")
        by_kernel[name] = {"launches": by_launches[name], "ms": ms,
                           "device_ms": dev_ms, "plain_ms": plain_ms,
                           "library_ms": lib_ms,
                           "library_device_ms": lib_dev_ms,
                           "library": lib_name, "bound_ms": bms,
                           "bound_by": by, "max_abs_err": abs_err[name],
                           "shape": shape, "dtype": dt}

    # host cost of one launch (allocating form, 8 elements) beside torch.add
    host = {}
    for label, fn in (("rtc_launch_us", lambda: rx.axpy(x8, y8)),
                      ("torch_add_us",
                       lambda: torch.add(y8.data, x8.data, alpha=2))):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(RTC_LAUNCH_CALLS):
            fn()
        host[label] = (time.perf_counter() - t1) / RTC_LAUNCH_CALLS * 1e6
        torch.cuda.synchronize()
    print(f"  host cost of one CudaKernel.launch (axpy, 8 elements, output "
          f"allocated): {host['rtc_launch_us']:.2f} us; one torch.add: "
          f"{host['torch_add_us']:.2f} us (mean of {RTC_LAUNCH_CALLS} calls)")

    # NDArray and autograd on the card against the same calls on the CPU
    on_card, on_cpu = _imperative_cases(ctx), _imperative_cases(cpu())
    worst = 0.0
    for k, (a, dt, c) in on_card.items():
        b, dt_cpu, _ = on_cpu[k]
        if dt != dt_cpu or c != ctx or a.shape != b.shape:
            raise SystemExit(f"FAIL: NDArray case {k}: {dt} on {c} vs "
                             f"{dt_cpu} on the CPU")
        worst = max(worst, float(np.max(np.abs(a.astype(np.float64) - b)
                                        / np.maximum(1.0, np.abs(b)))))
    print(f"  NDArray/autograd on {ctx} vs cpu(): {len(on_card)} cases, "
          f"dtypes equal, max |d| / max(1, |cpu|) = {worst:.3g} (tol 1e-6: "
          f"f32 exp and sums in another order)")
    if worst > 1e-6:
        raise SystemExit("FAIL: NDArray on the card differs from the CPU")

    # median_ms's calls, then graph_ms's: one warm-up and the captured
    # calls (replays launch nothing from Python)
    per_timing = RTC_WARMUP + RTC_REPS * TIMED_CALLS + 1 + TIMED_CALLS
    expect_all = before_main + main_launches + len(timed) * per_timing + \
        10 + RTC_LAUNCH_CALLS
    made = before_main + rtc.launches       # the counter restarted at 0
    print(f"rtc launches over the phase: {made} (expected {expect_all})")
    if made != expect_all:
        raise SystemExit("FAIL: rtc.launches does not count every launch")
    return {"launches": main_launches, "compile_seconds": compile_s,
            "by_kernel": by_kernel, **host}


# ---------------------------------------------------------------------------
def lm_weights(seed: int):
    """Seeded weights for the generate slice's TransformerLM, named as the
    JAX package names them, drawn as the JAX package's generate test draws
    its (``mx.init.Normal(0.5)``): weights and embeddings N(0, 0.5^2),
    biases and LayerNorm beta 0, gamma 1. At 768 units every layer's
    attention is then nearly one-hot, so greedy tokens depend on the
    context, and any difference in rounding grows from layer to layer, so
    batched and serial decode agree only if they compute alike."""
    rng = np.random.default_rng(seed)
    named = {}
    for k, p in TransformerLM(**LM_CONFIG)._collect_params_with_prefix() \
            .items():
        if k.endswith("gamma"):
            named[k] = np.ones(p.shape, np.float32)
        elif k.endswith(("beta", "bias")):
            named[k] = np.zeros(p.shape, np.float32)
        else:
            named[k] = rng.standard_normal(p.shape, dtype=np.float32) \
                * np.float32(0.5)
    return named


def _lm(named, dtype=torch.float32):
    lm = TransformerLM(**LM_CONFIG)
    load_jax_params(lm, named, ctx=cpu())
    return lm.to(dtype)


def gen_prompts(seed: int, buckets):
    """GEN_SEQS prompts with lengths drawn from the seed in
    GEN_PROMPT_RANGE, in turn from each prefill bucket's share of it (so
    every bucket is exercised), tokens uniform over the vocabulary."""
    rng = np.random.default_rng(seed + 8)
    lo, hi = GEN_PROMPT_RANGE
    edges = [0] + list(buckets)
    ranges = [(max(lo, a + 1), min(hi, b)) for a, b in zip(edges, edges[1:])
              if max(lo, a + 1) <= min(hi, b)]
    lengths = [int(rng.integers(r[0], r[1] + 1)) for r in
               (ranges[i % len(ranges)] for i in range(GEN_SEQS))]
    return [rng.integers(0, LM_CONFIG["vocab_size"], n).tolist()
            for n in lengths]


def serial_decode(eng, prompt, max_new: int, sid: int):
    """One sequence at a time through ``eng`` (the JAX package's test
    oracle), returning its tokens and K1's launches during its prefill and
    during its decode steps."""
    eng.pool.reserve(sid, len(prompt) + max_new)
    n0 = fa.launches
    toks = [eng.prefill(prompt, eng.pool.table(sid))]
    n1 = fa.launches
    pos = len(prompt)
    for _ in range(max_new - 1):
        (t,) = eng.decode_step([(toks[-1], pos, eng.pool.table(sid))])
        toks.append(t)
        pos += 1
    eng.pool.free(sid)
    return toks, n1 - n0, fa.launches - n1


def first_step_logits(eng, rows):
    """The logits of one decode step of ``rows`` ((id, position, table)
    each) stepped together, as the engine's decode step computes them,
    without its scatter and argmax."""
    B = serving.bucketing.bucket_for(len(rows), eng.decode_buckets)
    with torch.inference_mode():
        dev = torch.from_numpy(eng._decode_host(rows)).to(eng.device)
        return eng._step_outputs(dev, B)[0][:len(rows)].float().cpu()


def k1_prefill_shapes(gen, buckets, smi: str):
    """K1 against its plain version at each prefill bucket's causal shape
    (1, 12, S, 64), bf16 and f32, on the split views of one QKV buffer;
    times at PREFILL_TIMED_SHAPES beside the plain version, SDPA's causal
    forward (a yardstick) and the causal bound."""
    H, D = LM_CONFIG["num_heads"], LM_CONFIG["units"] // LM_CONFIG["num_heads"]
    worst = 0.0
    for S in buckets:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = split_qkv((1, H, S, D), gen, dtype)
            out, lse = fa.flash_attention_fwd(q, k, v, D ** -0.5, True)
            ref, ref_lse = fa.flash_attention_fwd_reference(
                q, k, v, D ** -0.5, True)
            err = max((out.float() - ref.float()).abs().max().item(),
                      (lse - ref_lse).abs().max().item())
            print(f"kernel (1, {H}, {S}, {D}) {str(dtype)[6:]} causal "
                  f"(prefill bucket): max|d| {err:.3g} (tol {TOL[dtype]:g})")
            if err > TOL[dtype]:
                raise SystemExit(f"FAIL: K1 disagrees with its plain version "
                                 f"at the prefill shape S={S} {dtype}")
            worst = max(worst, err)
    timed = {}
    for shape in PREFILL_TIMED_SHAPES:
        q, k, v = split_qkv(shape, gen, torch.bfloat16)
        scale = shape[-1] ** -0.5

        def k1():
            return fa.flash_attention_fwd(q, k, v, scale, True)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale)

        ms = median_ms(k1, calls=TIMED_CALLS)
        dev = graph_ms(k1)
        plain = median_ms(lambda: fa.flash_attention_fwd_reference(
            q, k, v, scale, True), reps=20, warmup=2, calls=TIMED_CALLS)
        lib, lib_dev = median_ms(sdpa, calls=TIMED_CALLS), graph_ms(sdpa)
        bms, by, nbytes, flops = bound_ms(shape, torch.bfloat16, True)
        print(f"K1 causal {shape} bf16 on split views: {ms:.4f} ms through "
              f"the wrapper, {dev:.4f} ms from a CUDA graph of 10 calls; "
              f"plain {plain:.4f} ms; sdpa causal {lib:.4f} ms ({lib_dev:.4f}"
              f" ms from a graph); bound {bms * 1e3:.2f} us ({by}: "
              f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP), graph time "
              f"{bms / dev:.1%} of bound on {smi}")
        timed["x".join(map(str, shape))] = {
            "ms": ms, "device_ms": dev, "plain_ms": plain, "library_ms": lib,
            "library_device_ms": lib_dev, "bound_ms": bms, "bound_by": by}
    return worst, timed


def time_buckets(eng, smi: str):
    """Each prefill bucket (a prompt of exactly its length) and each decode
    bucket (rows at position GEN_TIMED_POS) run GEN_TIMED_REPS times: the
    median host-clock ms of one call (each ends in a sync for its tokens)
    and the median CUDA-event ms around it."""
    def timed(fn):
        host, ev = [], []
        for _ in range(GEN_TIMED_REPS + 2):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            fn()
            b.record()
            b.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            ev.append(a.elapsed_time(b))
        return {"host_ms": float(np.median(host[2:])),
                "event_ms": float(np.median(ev[2:]))}

    sids = range(60_000, 60_000 + eng.max_batch_size)
    for sid in sids:
        eng.pool.reserve(sid, eng.max_seq_len)
    tables = [eng.pool.table(sid) for sid in sids]
    prefill = {S: timed(lambda: eng.prefill(list(range(1, S + 1)), tables[0]))
               for S in eng.prefill_buckets}
    rows = [(7, GEN_TIMED_POS, t) for t in tables]
    decode = {B: timed(lambda: eng.decode_step(rows[:B]))
              for B in eng.decode_buckets}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    B = eng.decode_buckets[-1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(GEN_PROFILE_STEPS):
            eng.decode_step(rows[:B])
        torch.cuda.synchronize()
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA) / 1e3 \
        / GEN_PROFILE_STEPS
    for sid in sids:
        eng.pool.free(sid)
    for S, t in prefill.items():
        print(f"prefill bucket S={S}: {t['host_ms']:.3f} ms host clock, "
              f"{t['event_ms']:.3f} ms CUDA events (median of "
              f"{GEN_TIMED_REPS}) on {smi}")
    for b, t in decode.items():
        print(f"decode step bucket B={b} (products at {B} rows, context "
              f"{eng.max_seq_len} lanes): {t['host_ms']:.3f} ms host clock, "
              f"{t['event_ms']:.3f} ms CUDA events (median of "
              f"{GEN_TIMED_REPS}) on {smi}")
    busy = device_ms / decode[B]["host_ms"]
    print(f"decode step B={B}: {device_ms:.3f} ms of kernels per step "
          f"(torch.profiler, {GEN_PROFILE_STEPS} steps) in a "
          f"{decode[B]['host_ms']:.3f} ms step: device busy share "
          f"{busy:.3f} on {smi}")
    return {"prefill": prefill, "decode": decode,
            "decode_device_ms": device_ms, "decode_busy_share": busy}


def _rel_err(got, want) -> float:
    """max |got - want| / max(1, |want|) over the values."""
    got, want = got.double().cpu(), want.double().cpu()
    return ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()


def f32_card_vs_cpu(seed: int, wide, prompt, smi: str):
    """One sequence in f32: prefill logits on the card (K1's f32 path)
    against the CPU (plain versions) within 1e-3 x max(1, |logit|), and the
    first GEN_F32_TOKENS greedy tokens of both engines equal. The weights
    are the repo's BERT recipe (``seeded_bert_weights``: matrices
    N(0, 1/fan_in), embeddings N(0, 1)): under the generate phase's wide
    init (``wide``) the 12 layers' sharp attention amplifies f32 rounding
    without bound, so that no two f32 orders of summation agree to 1e-3;
    the CPU's own f32 prefill against its f64 one shows it (printed)."""
    named = seeded_bert_weights(TransformerLM(**LM_CONFIG), seed)
    cpu_lm, gpu_lm = _lm(named), _lm(named).cuda()
    wide32, wide64 = _lm(wide), _lm(wide, torch.float64)
    tok = torch.tensor([prompt])
    with torch.inference_mode():
        err = _rel_err(gpu_lm.prefill_collect(tok.cuda())[0],
                       cpu_lm.prefill_collect(tok)[0])
        chaos = _rel_err(wide32.prefill_collect(tok)[0],
                         wide64.prefill_collect(tok)[0])
    del wide32, wide64
    kw = dict(max_seq_len=GEN_ENGINE["max_seq_len"],
              max_batch_size=GEN_ENGINE["max_batch_size"],
              page_size=GEN_ENGINE["page_size"], num_pages=GEN_F32_PAGES)
    cpu_toks = serial_decode(DecodeEndpoint("lm_cpu", cpu_lm, ctx=cpu(), **kw),
                             prompt, GEN_F32_TOKENS, 1)[0]
    gpu_toks = serial_decode(DecodeEndpoint("lm_f32", gpu_lm, **kw),
                             prompt, GEN_F32_TOKENS, 1)[0]
    print(f"f32 card vs CPU plain, prompt of {len(prompt)}: prefill logits "
          f"max |d| / max(1, |logit|) = {err:.3g} (tol 1e-3); first "
          f"{GEN_F32_TOKENS} greedy tokens card {gpu_toks}, CPU {cpu_toks} "
          f"on {smi}. Under the wide init the CPU's f32 prefill logits lie "
          f"{chaos:.3g} x max(1, |logit|) from its f64 ones")
    if err > 1e-3 or gpu_toks != cpu_toks:
        raise SystemExit("FAIL: the f32 generate path on the card disagrees "
                         "with the CPU")
    return err


def phase_generate(seed: int, smi: str):
    """The generate slice (phase 7): TransformerLM at BERT-base width in
    bf16 behind an InferenceServer's generator, 4 clients, 24 sequences."""
    named = lm_weights(seed)
    lm = _lm(named, torch.bfloat16)
    layers = LM_CONFIG["num_layers"]

    # ---- the main path: counts from 0 just before, read just after ----
    fa.launches = 0
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()      # by earlier phases
    eng = DecodeEndpoint("lm", lm, **GEN_ENGINE)
    server = serving.InferenceServer()
    t0 = time.perf_counter()
    server.register_generator(eng, warmup=True,
                              tenants={GEN_TENANT: GEN_TENANT_SLO_MS})
    warm_s = time.perf_counter() - t0
    warm_launches = fa.launches
    server.start()
    prompts = gen_prompts(seed, eng.prefill_buckets)
    results, errors = {}, []

    def client(c):
        rng = np.random.default_rng(seed * 100 + c)
        mine = []
        try:
            for i in range(c, GEN_SEQS, GEN_CLIENTS):
                tenant = GEN_TENANT if i % 2 else "default"
                stamps = []
                t_sub = time.perf_counter()
                s = server.generate(
                    "lm", prompts[i], max_new_tokens=GEN_NEW_TOKENS,
                    tenant=tenant,
                    on_token=lambda _, st=stamps: st.append(
                        time.perf_counter()))
                mine.append((i, tenant, t_sub, stamps, s))
                time.sleep(float(rng.uniform(0.0, 0.02)))
            for i, tenant, t_sub, stamps, s in mine:
                results[i] = (tenant, t_sub, stamps, s.result(timeout=600))
        except Exception as e:        # surfaced below; the phase fails
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(GEN_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t0
    server.stop(drain=True)
    gen_launches = fa.launches
    peak = torch.cuda.max_memory_allocated()
    # ---- end of the main path ----

    if errors or any(t.is_alive() for t in threads) or \
            len(results) != GEN_SEQS:
        raise SystemExit(f"FAIL: generate clients: {errors[:3]}")
    snap = eng.snapshot()
    c = snap["stats"]["counters"]
    n_warm = len(eng.prefill_buckets)
    print(f"generate: {len(eng.prefill_buckets)} prefill + "
          f"{len(eng.decode_buckets)} decode buckets warmed in {warm_s:.1f} s "
          f"(K1 launches {warm_launches} = {layers} x {n_warm}); "
          f"{GEN_SEQS} sequences, {c['tokens']} tokens, {c['steps']} decode "
          f"steps; K1 launches {gen_launches} (expected {layers} x "
          f"({n_warm} + {GEN_SEQS}) = {layers * (n_warm + GEN_SEQS)})")
    short = [i for i, r in results.items() if len(r[3]) != GEN_NEW_TOKENS]
    if short:
        raise SystemExit(f"FAIL: streams {short} did not yield exactly "
                         f"{GEN_NEW_TOKENS} tokens")
    if warm_launches != layers * n_warm or \
            gen_launches != layers * (n_warm + GEN_SEQS):
        raise SystemExit("FAIL: K1 launches do not match one per layer per "
                         "prefill")

    # the same prompts, serially through the same engine
    serial, d_prefill, d_decode = [], set(), set()
    for i, p in enumerate(prompts):
        toks, dp, dd = serial_decode(eng, p, GEN_NEW_TOKENS, 20_000 + i)
        serial.append(toks)
        d_prefill.add(dp)
        d_decode.add(dd)
    print(f"serial decode: K1 launches per prefill {sorted(d_prefill)}, per "
          f"sequence's {GEN_NEW_TOKENS - 1} decode steps {sorted(d_decode)}")
    if d_prefill != {layers} or d_decode != {0}:
        raise SystemExit("FAIL: K1 launched other than 12 times per prefill "
                         "and 0 times per decode step")
    batched = [results[i][3] for i in range(GEN_SEQS)]
    diverge = [(i, next(j for j, (a, b) in enumerate(zip(x, y)) if a != b))
               for i, (x, y) in enumerate(zip(batched, serial)) if x != y]
    bitwise = not diverge
    print(f"batched continuous decode == serial decode, token lists bitwise "
          f"equal: {bitwise} ({len(diverge)} of {GEN_SEQS} differ; first "
          f"diverging token (sequence, index): {diverge[:6]}); distinct "
          f"tokens per sequence {sorted(len(set(t)) for t in serial)}")
    if max(len(set(t)) for t in serial) <= 2:
        raise SystemExit("FAIL: greedy tokens do not depend on the context")

    # each row's first-step logits: alone (bucket 1) and stepped with the
    # others (the top bucket)
    sids = range(30_000, 30_000 + eng.max_batch_size)
    rows = []
    for sid, p in zip(sids, prompts):
        eng.pool.reserve(sid, len(p) + GEN_NEW_TOKENS)
        rows.append((eng.prefill(p, eng.pool.table(sid)), len(p),
                     eng.pool.table(sid)))
    together = first_step_logits(eng, rows)
    alone = torch.cat([first_step_logits(eng, [r]) for r in rows])
    for sid in sids:
        eng.pool.free(sid)
    d_logit = (together - alone).abs().max().item()
    same = torch.equal(together, alone)
    print(f"first-step logits of {len(rows)} rows, bucket {len(rows)} vs "
          f"bucket 1: bitwise equal {same}, max |dlogit| {d_logit:.4g}")
    if not (bitwise and same):
        raise SystemExit("FAIL: batched decode is not bitwise equal to "
                         "serial decode")

    ttft = [(r[2][0] - r[1]) * 1e3 for r in results.values()]
    gaps = {}
    for tenant, _, stamps, _ in results.values():
        gaps.setdefault(tenant, []).extend(np.diff(stamps) * 1e3)
    tokens = sum(len(r[3]) for r in results.values())
    print(f"generate {LM_CONFIG['num_layers']} x {LM_CONFIG['units']} bf16, "
          f"{GEN_CLIENTS} clients x {GEN_SEQS // GEN_CLIENTS} sequences, "
          f"prompts {min(map(len, prompts))}-{max(map(len, prompts))} "
          f"tokens, {GEN_NEW_TOKENS} new each: {tokens / wall:.1f} tokens/s "
          f"(wall {wall:.2f} s); time to first token p50 "
          f"{np.percentile(ttft, 50):.1f} ms, p99 "
          f"{np.percentile(ttft, 99):.1f} ms; peak device memory "
          f"{peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB of it held "
          f"before the phase) on {smi}")
    for tenant, g in sorted(gaps.items()):
        print(f"  inter-token, tenant {tenant!r}: p50 "
              f"{np.percentile(g, 50):.2f} ms, p99 {np.percentile(g, 99):.2f}"
              f" ms over {len(g)} gaps")

    gen = torch.Generator(device="cuda").manual_seed(seed)
    k1_err, k1_timed = k1_prefill_shapes(gen, eng.prefill_buckets, smi)
    buckets = time_buckets(eng, smi)
    f32_err = f32_card_vs_cpu(seed, named, prompts[2][:GEN_F32_PROMPT], smi)
    return {"launches": gen_launches, "k1_max_abs_err": k1_err,
            "k1_timed": k1_timed, "bitwise": bitwise, "diverge": diverge,
            "max_dlogit": d_logit, "tokens_per_s": tokens / wall,
            "ttft_ms": {"p50": float(np.percentile(ttft, 50)),
                        "p99": float(np.percentile(ttft, 99))},
            "intertoken_ms": {t: {"p50": float(np.percentile(g, 50)),
                                  "p99": float(np.percentile(g, 99))}
                              for t, g in gaps.items()},
            "peak_bytes": peak, "held_bytes": held, "f32_err": f32_err,
            **buckets}


# ---------------------------------------------------------------------------
def profiled(step):
    """Device ms and device operations (kernels and copies) per step over
    PROFILED_STEPS calls of ``step`` under torch.profiler (as
    ``tools/step_profile.py`` reads them; the optimizer's and the loss's
    range annotations are not kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_STEPS):
            step()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0
              and e.key not in ("mxt.optimizer", "mxt.loss")]
    device_us = sum(e.self_device_time_total for e in events)
    return (device_us / 1e3 / PROFILED_STEPS,
            sum(e.count for e in events) / PROFILED_STEPS)


def busy_share(step, step_ms: float):
    """Device kernel ms per step (``profiled``) and that over the
    host-clock ``step_ms``."""
    device_ms, _ = profiled(step)
    return device_ms, device_ms / step_ms


class PretrainLoss(gluon.HybridBlock):
    """BERT's pretraining loss per sample, as a Gluon user writes it: the
    masked-LM cross-entropy (mean over the P positions) plus the NSP
    cross-entropy, (B,). Its batch mean is ``BERTPretrainingLoss`` when
    every masked position is labelled."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.ce = gluon.loss.SoftmaxCrossEntropyLoss()

    def hybrid_forward(self, F, mlm, nsp, mlm_labels, nsp_labels):
        return self.ce(mlm, mlm_labels) + self.ce(nsp, nsp_labels)


def lenet():
    """The LeNet of ``.claude/skills/verify/SKILL.md`` (BASELINE config
    1): deferred input shapes."""
    net = nn.HybridSequential()
    net.add(nn.Conv2D(6, 5, padding=2, activation="relu"), nn.MaxPool2D(2),
            nn.Flatten(), nn.Dense(10))
    return net


def lenet_drive(ctx, weights, x, y):
    """Xavier-shaped ``weights``, SGD(0.1), LENET_STEPS steps of
    ``record`` / ``backward`` / ``Trainer.step``, hybridized half way, on
    ``ctx``; returns the per-sample losses and the parameters."""
    with ctx:
        net = lenet()
        net.initialize(init.Xavier())
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(nd.array(weights[k]))
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
        ce = gluon.loss.SoftmaxCrossEntropyLoss()
        xs, ys = nd.array(x), nd.array(y)
        losses = []
        for i in range(LENET_STEPS):
            if i == LENET_STEPS // 2:
                net.hybridize()
            with autograd.record():
                loss = ce(net(xs), ys)
            loss.backward()
            trainer.step(x.shape[0])
            losses.append(loss.asnumpy())
        return np.stack(losses), {k: p.data().asnumpy() for k, p in
                                  net._collect_params_with_prefix().items()}


def _gluon_batches(rng, n):
    """``n`` pretraining batches as int32 NDArrays on the card."""
    toks, (mlm, nsp), tt, pos = pretrain_batch(rng, n, TRAIN_BATCH,
                                               TRAIN_SEQ, TRAIN_P)
    to = lambda a: nd.array(a, ctx=gpu(0), dtype="int32")  # noqa: E731
    return [tuple(to(a[i]) for a in (toks, tt, pos, mlm, nsp))
            for i in range(n)]


def gluon_bert(dropout):
    """``BERTForPretraining(bert_base(max_length=128))`` as a Gluon user
    sets it up, without weights yet."""
    return BERTForPretraining(bert_base(max_length=TRAIN_SEQ,
                                        dropout=dropout))


def gluon_step(net, trainer, loss_fn, batch):
    """One Gluon training step: ``record``, the loss, ``backward``,
    ``trainer.step(batch size)``; returns the (B,) losses."""
    tok, tt, pos, mlm, nsp = batch
    with autograd.record():
        loss = loss_fn(*net(tok, tt, None, pos), mlm, nsp)
    loss.backward()
    trainer.step(TRAIN_BATCH)
    return loss


def gluon_masters(named, batches, optimizer):
    """GLUON_CHECK_STEPS Gluon steps (bf16 weights, ``optimizer`` with
    multi_precision, dropout 0) from ``named``: the mean losses and the
    f32 masters by structural name."""
    net = gluon_bert(0.0)
    load_jax_params(net, named, ctx=gpu(0))
    net.cast("bfloat16")
    trainer = gluon.Trainer(net.collect_params(), optimizer)
    loss_fn = PretrainLoss()
    losses = [float(gluon_step(net, trainer, loss_fn, b).asnumpy().mean())
              for b in batches]
    keys = {id(p): k for k, p in net._collect_params_with_prefix().items()}
    return losses, {keys[id(p)]: trainer._updaters.states[i][0].cpu()
                    for i, p in enumerate(trainer._params)
                    if i in trainer._updaters.states}


def gluon_vs_train_step(named, rng):
    """GLUON_CHECK_STEPS steps of the Gluon path against as many
    ParallelTrainStep(bf16 compute) steps from the same bf16-representable
    weights, dropout 0, both handing Adam the reference's f32 update count:
    the f32 masters' absolute differences and each run's mean losses."""
    batches = _gluon_batches(rng, GLUON_CHECK_STEPS)
    g_losses, masters = gluon_masters(named, batches, Adam(
        learning_rate=TRAIN_LR, multi_precision=True))
    step = _train_step(named, 0.0, "bfloat16", loss=PretrainLoss())
    p_losses = [step(b[0].data, (b[3].data, b[4].data), b[1].data,
                     b[2].data).item() for b in batches]
    p_masters = {k[len("inner."):]: v.detach().cpu()
                 for k, v in step.params.items()}
    del step
    if set(masters) != set(p_masters):
        raise SystemExit("FAIL: the Gluon path and ParallelTrainStep "
                         "train different parameters")
    diff = torch.cat([(masters[k] - p_masters[k]).abs().reshape(-1)
                      for k in p_masters])
    return diff, g_losses, p_losses


def phase_gluon(seed: int, smi: str):
    """The Gluon training surface (phase 8): the LeNet drive on the card
    against the CPU, BERT-base trained through gluon.Trainer (the main
    path), and that path against ParallelTrainStep."""
    # (a) the LeNet drive, batch 64, on the card and on the CPU
    rng = np.random.default_rng(seed + 9)
    x = rng.standard_normal((LENET_BATCH, 1, 28, 28), dtype=np.float32)
    y = rng.integers(0, 10, LENET_BATCH).astype(np.float32)
    with cpu():
        probe = lenet()
        probe.initialize(init.Xavier())
        probe(nd.array(x[:1]))                  # the deferred shapes
        weights = {k: p.data().asnumpy() for k, p in
                   probe._collect_params_with_prefix().items()}
    got = lenet_drive(gpu(0), weights, x, y)
    want = lenet_drive(cpu(), weights, x, y)
    loss_err = float(np.abs(got[0] - want[0]).max() /
                     max(1.0, np.abs(want[0]).max()))
    w_err = max(float(np.abs(got[1][k] - want[1][k]).max() /
                      max(1.0, np.abs(want[1][k]).max())) for k in want[1])
    print(f"LeNet drive (SKILL.md), batch {LENET_BATCH}, {LENET_STEPS} SGD "
          f"steps ({LENET_STEPS // 2} eager, {LENET_STEPS // 2} hybridized),"
          f" card vs CPU: losses {want[0].mean(1)[0]:.5f} -> "
          f"{want[0].mean(1)[-1]:.5f}, max relative difference {loss_err:.3g}"
          f"; parameters {w_err:.3g} (tol {LENET_TOL})")
    if not (loss_err <= LENET_TOL and w_err <= LENET_TOL):
        raise SystemExit("FAIL: the LeNet drive on the card disagrees with "
                         "the CPU")

    # (b) BERT-base through gluon.Trainer
    rng = np.random.default_rng(seed + 10)
    batches = _gluon_batches(rng, 1 + TRAIN_WARMUP + 2 * GLUON_TIMED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts from 0 just before, read just after ----
    fa.launches = fa.launches_dq = fa.launches_dkv = 0
    net = gluon_bert(0.1)
    net.initialize(init.Normal(0.02))
    net.cast("bfloat16")
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": TRAIN_LR,
                             "multi_precision": True})
    loss_fn = PretrainLoss()
    losses = [gluon_step(net, trainer, loss_fn, b)
              for b in batches[:TRAIN_WARMUP]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[TRAIN_WARMUP:TRAIN_WARMUP + GLUON_TIMED]:
        losses.append(gluon_step(net, trainer, loss_fn, b))
    losses[-1].asnumpy()                   # the window closes on a fetch
    wall = time.perf_counter() - t0
    step_ms = []
    for b in batches[TRAIN_WARMUP + GLUON_TIMED:-1]:
        t1 = time.perf_counter()
        losses.append(gluon_step(net, trainer, loss_fn, b))
        losses[-1].asnumpy()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    counts = {"flash_attention_fwd": fa.launches,
              "flash_attention_bwd_dq": fa.launches_dq,
              "flash_attention_bwd_dkv": fa.launches_dkv}
    # ---- end of the main path ----
    peak = torch.cuda.max_memory_allocated()
    steps = TRAIN_WARMUP + 2 * GLUON_TIMED
    layers = len(net.backbone.encoder._layers)
    all_losses = np.array([l.asnumpy().mean() for l in losses])
    median = float(np.median(step_ms))
    device_ms, busy = busy_share(
        lambda: gluon_step(net, trainer, loss_fn, batches[-1]), median)
    tokens = TRAIN_BATCH * TRAIN_SEQ * GLUON_TIMED
    print(f"Gluon: BERTForPretraining(bert_base) initialize(Normal(0.02)), "
          f"cast bf16, hybridize, Trainer adam multi_precision, dropout 0.1,"
          f" batch {TRAIN_BATCH} x {TRAIN_SEQ}, P={TRAIN_P}: {steps} steps, "
          f"losses {all_losses[0]:.4f} -> {all_losses[-1]:.4f}; launches "
          f"{counts} (expected {layers} x {steps} = {layers * steps} each)")
    print(f"training bert_base through gluon.Trainer S={TRAIN_SEQ} bf16: "
          f"{tokens / wall:.0f} tokens/s over {GLUON_TIMED} steps (wall "
          f"{wall:.3f} s), step median {median:.2f} ms (host clock to a "
          f"fetched loss), device {device_ms:.2f} ms/step, busy share "
          f"{busy:.3f}, peak device memory {peak / 2**30:.2f} GiB on {smi}")
    if not np.isfinite(all_losses).all():
        raise SystemExit("FAIL: a Gluon training loss is not finite")
    if any(n != layers * steps for n in counts.values()):
        raise SystemExit("FAIL: kernel launches do not match one per layer "
                         "per step on the Gluon path")
    del net, trainer, losses, batches

    # (c) against ParallelTrainStep from the same bf16-exact weights
    named = {k: torch.from_numpy(v).to(torch.bfloat16).float().numpy()
             for k, v in seeded_bert_weights(gluon_bert(0.0), seed).items()}
    diff, g_losses, p_losses = gluon_vs_train_step(
        named, np.random.default_rng(seed + 11))
    bitwise = (diff == 0).float().mean().item()
    print(f"Gluon Trainer vs ParallelTrainStep, {GLUON_CHECK_STEPS} bf16 "
          f"steps, dropout 0, Adam's count an f32 scalar on both: losses "
          f"{[f'{v:.5f}' for v in g_losses]} vs "
          f"{[f'{v:.5f}' for v in p_losses]}; f32 masters max|d| "
          f"{diff.max().item() / TRAIN_LR:.3g} lr, bitwise equal {bitwise:.6f}"
          f" (held: 1)")
    if bitwise != 1.0:
        raise SystemExit("FAIL: the Gluon Trainer's masters are not bitwise "
                         "ParallelTrainStep's")
    return {"launches": counts, "tokens_per_s": tokens / wall,
            "step_ms": median, "busy_share": busy}


# ---------------------------------------------------------------------------
# phase 11: AMP on BERT-base through gluon.Trainer
# ---------------------------------------------------------------------------
def _grad_params(trainer):
    return [p for p in trainer._params if p.grad_req != "null"]


def amp_step(net, trainer, loss_fn, batch, poison=False):
    """One AMP step as the reference's API has it: the loss, scaled by
    the trainer's loss scale (1 without a scaler), ``backward``,
    ``unscale``, the overflow check launched and read, then
    ``trainer.step`` unless the step is skipped. ``poison`` sets one
    gradient to inf first. Returns (per-sample losses, skipped)."""
    tok, tt, pos, mlm, nsp = batch
    with autograd.record():
        loss = loss_fn(*net(tok, tt, None, pos), mlm, nsp)
        with amp.scale_loss(loss, trainer) as scaled:
            pass
    scaled.backward()
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        trainer.step(tok.shape[0])
        return loss, False
    amp.unscale(trainer)
    if poison:
        g = _grad_params(trainer)[0].grad()
        g._data = torch.full_like(g._data, float("inf"))
    scaler.launch_check_overflow(_grad_params(trainer))
    skipped = scaler.wait_and_update()
    if not skipped:
        trainer.step(tok.shape[0])
    return loss, skipped


def amp_main_path(target, batch, smi):
    """BERT-base (f32 parameters, Normal(0.02), dropout 0.1) trained
    through gluon.Trainer (Adam) under ``amp.init(target)``, fp16 with the
    dynamic loss scaler, for AMP_WARMUP + 2 * AMP_TIMED steps on one fixed
    batch; the kernels' counts from 0 just before, read just after."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts from 0 just before, read just after ----
    fa.launches = fa.launches_dq = fa.launches_dkv = fc.launches = 0
    rtc.launches = 0
    amp.init(target)
    net = gluon_bert(0.1)
    net.initialize(init.Normal(0.02))
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": TRAIN_LR})
    if target == "float16":
        amp.init_trainer(trainer)
    loss_fn = PretrainLoss()
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    scales = []        # the loss scale after each step

    def step():
        out.append(amp_step(net, trainer, loss_fn, batch))
        if scaler is not None:
            scales.append(scaler.loss_scale)

    out = []
    for _ in range(AMP_WARMUP):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(AMP_TIMED):
        step()
    out[-1][0].asnumpy()                   # the window closes on a fetch
    wall = time.perf_counter() - t0
    step_ms = []
    for _ in range(AMP_TIMED):
        t1 = time.perf_counter()
        step()
        out[-1][0].asnumpy()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    counts = {"flash_attention_fwd": fa.launches,
              "flash_attention_bwd_dq": fa.launches_dq,
              "flash_attention_bwd_dkv": fa.launches_dkv}
    others = {"K4": fc.launches, "K5": rtc.launches}
    # ---- end of the main path ----
    peak = torch.cuda.max_memory_allocated()
    steps = AMP_WARMUP + 2 * AMP_TIMED
    layers = len(net.backbone.encoder._layers)
    losses = np.array([l.asnumpy().mean() for l, _ in out])
    skipped = [i for i, (_, s) in enumerate(out) if s]
    median = float(np.median(step_ms))
    device_ms, busy = busy_share(
        lambda: amp_step(net, trainer, loss_fn, batch), median)
    tokens = TRAIN_BATCH * TRAIN_SEQ * AMP_TIMED
    print(f"AMP {target}: BERTForPretraining(bert_base) f32 parameters, "
          f"Trainer adam, dropout 0.1, batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"P={TRAIN_P}, one fixed batch: {steps} steps, losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches {counts} "
          f"(expected {layers} x {steps} = {layers * steps} each)"
          + (f"; loss scale after each step {[f'{v:g}' for v in scales]}, "
             f"skipped steps {skipped}" if scaler else ""))
    print(f"training bert_base under amp.init({target!r}) S={TRAIN_SEQ}: "
          f"{tokens / wall:.0f} tokens/s over {AMP_TIMED} steps (wall "
          f"{wall:.3f} s), step median {median:.2f} ms (host clock to a "
          f"fetched loss), device {device_ms:.2f} ms/step, busy share "
          f"{busy:.3f}, peak device memory {peak / 2**30:.2f} GiB on {smi}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise SystemExit(f"FAIL: AMP {target} losses not finite or not "
                         f"falling: {losses}")
    if any(n != layers * steps for n in counts.values()) or \
            any(others.values()):
        raise SystemExit(f"FAIL: AMP {target}: kernel launches do not match "
                         f"one per layer per step ({counts}, {others})")
    record = {"launches": counts, "others": others,
              "tokens_per_s": tokens / wall,
              "step_ms": median, "device_ms": device_ms, "busy_share": busy,
              "peak_gib": peak / 2**30, "losses": losses.tolist(),
              "skipped": skipped}
    if scaler is not None:
        # one forced overflow: the step is skipped, the scale halved
        before = scaler.loss_scale
        w = _grad_params(trainer)[0].data().asnumpy()
        _, forced = amp_step(net, trainer, loss_fn, batch, poison=True)
        unchanged = np.array_equal(w, _grad_params(trainer)[0].data()
                                   .asnumpy())
        print(f"forced overflow (one gradient set to inf): skipped {forced}, "
              f"loss scale {before:g} -> {scaler.loss_scale:g}, weights "
              f"unchanged {unchanged}")
        if not (forced and unchanged and scaler.loss_scale == before / 2):
            raise SystemExit("FAIL: the forced overflow was not skipped with "
                             "the scale halved")
        record.update(scales=scales, forced_skip=forced)
    amp._AMP_STATE["on"] = False
    del net, trainer
    return record


def amp_small_steps(named, batches, ctx):
    """AMP_CHECK_STEPS AMP-fp16 steps (loss scaler from AMP_CHECK_SCALE,
    Adam) of the small BERT on ``ctx`` from ``named``: the mean losses,
    the f32 weights and which steps the scaler skipped."""
    with ctx:
        amp.init("float16")
        net = BERTForPretraining(BERTModel(**AMP_SMALL),
                                 vocab_size=AMP_SMALL["vocab_size"])
        load_jax_params(net, named, ctx=ctx)
        trainer = amp.init_trainer(gluon.Trainer(
            net.collect_params(), "adam", {"learning_rate": AMP_CHECK_LR}))
        trainer._amp_loss_scaler.loss_scale = AMP_CHECK_SCALE
        loss_fn = PretrainLoss()
        losses, skips = [], []
        for b in batches:
            loss, skipped = amp_step(
                net, trainer, loss_fn,
                [nd.array(a, dtype="int32") for a in b])
            losses.append(float(loss.asnumpy().mean()))
            skips.append(skipped)
        amp._AMP_STATE["on"] = False
        return np.array(losses), {k: p.data().asnumpy() for k, p in
                                  net._collect_params_with_prefix().items()
                                  }, skips


def phase_amp(seed: int, smi: str, fp16_record=None):
    """Phase 11: (a) F4's fp16 kernels (``phase_fp16``, or its record when
    given); (b) BERT-base under
    amp.init("bfloat16"); (c) under amp.init("float16") with the loss
    scaler and one forced overflow; (d) a small BERT's AMP-fp16 steps on
    the card against the CPU."""
    if fp16_record is None:
        fp16_record = phase_fp16(seed, smi)
    rng = np.random.default_rng(seed + 12)
    batch = _gluon_batches(rng, 1)[0]
    bf16 = amp_main_path("bfloat16", batch, smi)
    fp16 = amp_main_path("float16", batch, smi)
    # (d) card vs CPU from the same weights and batches
    probe = BERTForPretraining(BERTModel(**AMP_SMALL),
                               vocab_size=AMP_SMALL["vocab_size"])
    # the repo's seeded recipe with BERT's N(0, 0.02^2) embeddings (N(0, 1)
    # rows make the tied decoder's fp16 gradient overflow at every scale
    # the scaler starts from)
    named = {k: v * np.float32(0.02) if "embed" in k else v
             for k, v in seeded_bert_weights(probe, seed).items()}
    toks, (mlm, nsp), tt, pos = pretrain_batch(
        np.random.default_rng(seed + 13), AMP_CHECK_STEPS, AMP_CHECK_BATCH,
        TRAIN_SEQ, TRAIN_P)
    batches = [(toks[i], tt[i], pos[i], mlm[i], nsp[i])
               for i in range(AMP_CHECK_STEPS)]
    got = amp_small_steps(named, batches, gpu(0))
    want = amp_small_steps(named, batches, cpu())
    loss_err = float(np.abs(got[0] - want[0]).max() / np.abs(want[0]).max())
    keys = sorted(want[1])
    diff = np.abs(np.concatenate([got[1][k].ravel() for k in keys])
                  - np.concatenate([want[1][k].ravel() for k in keys]))
    mean_lr, p99_lr = diff.mean() / AMP_CHECK_LR, \
        np.percentile(diff, 99) / AMP_CHECK_LR
    print(f"AMP fp16, small BERT ({AMP_SMALL['num_layers']} layers, units "
          f"{AMP_SMALL['units']}), {AMP_CHECK_STEPS} Adam steps (lr "
          f"{AMP_CHECK_LR}, loss scaler) card vs CPU: losses {got[0]} vs "
          f"{want[0]}, max relative {loss_err:.3g} (tol {AMP_LOSS_RTOL}); "
          f"skipped steps {got[2]} vs {want[2]}; f32 masters mean |d| "
          f"{mean_lr:.3g} lr, p99 {p99_lr:.3g} lr (tol 0.1, 0.5)")
    if not (loss_err <= AMP_LOSS_RTOL and mean_lr <= 0.1 and p99_lr <= 0.5
            and got[2] == want[2] and not all(got[2])):
        raise SystemExit("FAIL: AMP fp16 steps on the card disagree with the "
                         "CPU")
    return {"fp16": fp16_record, "amp_bf16": bf16, "amp_fp16": fp16}


# ---------------------------------------------------------------------------
# phase 12: row-sparse embedding gradients on the PTB-medium LSTM LM
# ---------------------------------------------------------------------------
class SparseLM(gluon.Block):
    """The LM of the reference's sparse-embedding test at PTB-medium width:
    Embedding (``sparse_grad``) -> 2-layer LSTM (NTC) -> Dense decoder."""

    def __init__(self, sparse_grad):
        super().__init__()
        c = PTB_MEDIUM
        with self.name_scope():
            self.embed = nn.Embedding(c["vocab"], c["embed"],
                                      sparse_grad=sparse_grad)
            self.lstm = gluon.rnn.LSTM(c["hidden"], num_layers=c["layers"],
                                       layout="NTC", input_size=c["embed"])
            self.decoder = nn.Dense(c["vocab"], flatten=False,
                                    in_units=c["hidden"])

    def forward(self, x):
        return self.decoder(self.lstm(self.embed(x)))


def sparse_lm_weights(seed: int):
    """Seeded uniform [-0.05, 0.05] weights of SparseLM, by structural
    name (both twins load the same)."""
    probe = SparseLM(False)
    with cpu():
        probe.initialize(init.Uniform(0.05))
        return {k: p.data().asnumpy() for k, p in
                probe._collect_params_with_prefix().items()}


def sparse_lm_train(sparse_grad, named, batches, opt, timed=False):
    """Steps of SparseLM (sparse or dense embedding gradient) on the card
    through gluon.Trainer with ``opt`` (name, params), one per batch; with
    ``timed``, the first SPARSE_WARMUP untimed, the next SPARSE_TIMED in a
    window closed by a fetch and the rest one by one. Returns the mean
    losses, the weights, the touched rows per step and the timings."""
    net = SparseLM(sparse_grad)
    with gpu(0):
        net.initialize()
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(nd.array(named[k]))
    trainer = gluon.Trainer(net.collect_params(), *opt)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    losses, rows, step_ms, wall = [], [], [], None

    def step(x, y):
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        g = net.embed.weight.grad()
        rows.append(g.nnz if sparse_grad else None)
        trainer.step(LSTM_BATCH)
        return loss

    for i, (x, y) in enumerate(batches):
        x, y = (nd.array(a, ctx=gpu(0), dtype="int32") for a in (x, y))
        if timed and i == SPARSE_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        t1 = time.perf_counter()
        losses.append(step(x, y))
        if timed and i == SPARSE_WARMUP + SPARSE_TIMED - 1:
            losses[-1].asnumpy()
            wall = time.perf_counter() - t0
        elif timed and i >= SPARSE_WARMUP + SPARSE_TIMED:
            losses[-1].asnumpy()
            step_ms.append((time.perf_counter() - t1) * 1e3)
    grad_type = type(net.embed.weight.grad()).__name__
    weights = {k: p.data().asnumpy() for k, p in
               net._collect_params_with_prefix().items()}
    out = {"losses": np.array([l.asnumpy().mean() for l in losses]),
           "weights": weights, "rows": rows, "grad_type": grad_type,
           "wall": wall, "step_ms": step_ms}
    if timed:
        x, y = (nd.array(a, ctx=gpu(0), dtype="int32") for a in batches[-1])
        out["device_ms"], out["busy"] = busy_share(
            lambda: step(x, y), float(np.median(step_ms)))
    return out


def sparse_cases(ctx):
    """The sparse module's functions at small shapes on ``ctx``, as dense
    numpy results: storage casts, csr . dense (and transposed), row-sparse
    . dense, retain, add_n and the row-sparse sum of squares."""
    rng = np.random.default_rng(5)
    d = (rng.standard_normal((8, 6)) *
         (rng.random((8, 6)) < 0.3)).astype(np.float32)
    rhs = rng.standard_normal((6, 4)).astype(np.float32)
    rhs_t = rng.standard_normal((8, 4)).astype(np.float32)
    with ctx:
        a = nd.array(d)
        rsp, csr = a.tostype("row_sparse"), a.tostype("csr")
        two = sparse.row_sparse_array((np.ones((3, 6), np.float32),
                                       [6, 1, 6]), shape=(8, 6))
        out = {"rsp": rsp, "csr": csr, "csr_dot": sparse.dot(csr, nd.array(rhs)),
               "csr_dot_t": sparse.dot(csr, nd.array(rhs_t),
                                       transpose_a=True),
               "rsp_dot": sparse.dot(rsp, nd.array(rhs)),
               "retain": rsp.retain(nd.array([1, 3, 5])),
               "add_n": sparse.add_n([rsp, two]),
               "square_sum": nd._square_sum(rsp, axis=1)}
        return {k: v.asnumpy() for k, v in out.items()}


def phase_sparse(seed: int, smi: str):
    """Phase 12: (a) the PTB-medium LM with a row-sparse embedding gradient
    under lazy Adam against its dense twin; (b) under SGD, where lazy
    equals dense; (c) the sparse functions card vs CPU."""
    rng = np.random.default_rng(seed + 14)
    named = sparse_lm_weights(seed)
    steps = SPARSE_WARMUP + 2 * SPARSE_TIMED
    batches = lstm_batches(rng, steps, LSTM_BATCH)
    adam = ("adam", {"learning_rate": SPARSE_LR})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts from 0 just before, read just after ----
    fa.launches = fa.launches_dq = fa.launches_dkv = fc.launches = 0
    rtc.launches = 0
    sp = sparse_lm_train(True, named, batches, adam, timed=True)
    hand = {"K1": fa.launches, "K2": fa.launches_dq, "K3": fa.launches_dkv,
            "K4": fc.launches, "K5": rtc.launches}
    # ---- end of the main path ----
    peak = torch.cuda.max_memory_allocated()
    dense = sparse_lm_train(False, named, batches, adam)
    rel = np.abs(sp["losses"] - dense["losses"]) / np.abs(dense["losses"])
    median = float(np.median(sp["step_ms"]))
    tokens = LSTM_BATCH * LSTM_BPTT * SPARSE_TIMED
    print(f"sparse-embedding LM (PTB medium: vocab {PTB_MEDIUM['vocab']}, "
          f"2 x {PTB_MEDIUM['hidden']}), batch {LSTM_BATCH} x {LSTM_BPTT}, "
          f"lazy Adam lr {SPARSE_LR}, {steps} steps: losses "
          f"{sp['losses'][0]:.4f} -> {sp['losses'][-1]:.4f}, dense twin "
          f"{dense['losses'][0]:.4f} -> {dense['losses'][-1]:.4f}, max "
          f"relative difference {rel.max():.3g} (tol {SPARSE_LOSS_RTOL}); "
          f"embedding gradient {sp['grad_type']}, touched rows per step "
          f"{sp['rows'][:steps]}; hand-written kernel launches {hand} (none "
          f"lies on the path)")
    print(f"training the sparse-embedding LM: {tokens / sp['wall']:.0f} "
          f"tokens/s over {SPARSE_TIMED} steps (wall {sp['wall']:.3f} s), "
          f"step median {median:.2f} ms (host clock to a fetched loss), "
          f"device {sp['device_ms']:.2f} ms/step, busy share "
          f"{sp['busy']:.3f}, peak device memory {peak / 2**30:.2f} GiB on "
          f"{smi}")
    if sp["grad_type"] != "RowSparseNDArray" or \
            not np.isfinite(sp["losses"]).all() or \
            rel.max() > SPARSE_LOSS_RTOL or any(hand.values()):
        raise SystemExit("FAIL: the sparse-embedding LM")
    # (b) SGD without momentum, wd or clipping: lazy == dense
    sgd = ("sgd", {"learning_rate": SPARSE_SGD_LR})
    a = sparse_lm_train(True, named, batches[:SPARSE_SGD_STEPS], sgd)
    b = sparse_lm_train(False, named, batches[:SPARSE_SGD_STEPS], sgd)
    w_err = max(float(np.abs(a["weights"][k] - b["weights"][k]).max() /
                      max(1.0, np.abs(b["weights"][k]).max()))
                for k in b["weights"])
    print(f"lazy SGD (lr {SPARSE_SGD_LR}, no momentum, wd or clipping) vs "
          f"the dense twin after {SPARSE_SGD_STEPS} steps: weights max |d| "
          f"{w_err:.3g} of max(1, |value|) (tol {SPARSE_SGD_TOL}; the card "
          f"sums the gradient's rows in another order)")
    if w_err > SPARSE_SGD_TOL:
        raise SystemExit("FAIL: lazy SGD differs from the dense update")
    # (c) the sparse functions, card vs CPU
    got, want = sparse_cases(gpu(0)), sparse_cases(cpu())
    errs = {k: float(np.abs(got[k] - want[k]).max()) for k in want}
    print(f"sparse functions card vs CPU: max |d| {errs} (tol 1e-5: the "
          f"scatter-adds sum in another order)")
    if max(errs.values()) > 1e-5:
        raise SystemExit("FAIL: a sparse function differs on the card")
    return {"hand": hand, "tokens_per_s": tokens / sp["wall"],
            "step_ms": median, "busy_share": sp["busy"]}


# ---------------------------------------------------------------------------
# phase 9: the op surface on the card; the LSTM LM through gluon.Trainer
# ---------------------------------------------------------------------------
def _on_card(results, ctx):
    """Names of the NDArray results that do not lie on ``ctx``."""
    flat = []
    for k, v in results.items():
        flat += [(f"{k}[{i}]", x) for i, x in enumerate(v)] \
            if isinstance(v, (list, tuple)) else [(k, v)]
    return [f"{k}: on {x.context}" for k, x in flat
            if hasattr(x, "context") and x.context != ctx]


def op_surface(seed: int, smi: str):
    """Phase 9(a): every case of ``tools/op_cases.py`` (one per registered
    op but the samplers, small f32 shapes, seeded inputs) on gpu(0)
    against cpu(), at the case's tolerance (data movement and indexing
    exact, sums and products 1e-5 relative, f32 transcendental functions
    1e-6, bf16/f16 results 2^-7; sorts, argsort and topk on tie-free
    inputs: a permutation of distinct values), every result on the card;
    then each sampler's draws on the card against its first two moments
    (``op_cases.moment_errors``). Returns K1's launches in the
    ``flash_attention`` and ``multi_head_attention`` cases."""
    bad, k1 = {}, {}
    for name, (case, tol) in sorted(op_cases.CASES.items()):
        with cpu():
            want = case(nd, cpu())
        before = fa.launches
        with gpu(0):
            got = case(nd, gpu(0))
        if name in K1_CASES:
            k1[name] = fa.launches - before
        diff = op_cases.differences(want, got, tol) + _on_card(got, gpu(0))
        if diff:
            bad[name] = diff
    sampler_bad = {}
    for name, draw in sorted(op_cases.SAMPLER_CALLS(nd, gpu(0)).items()):
        random.seed(seed)
        with gpu(0):
            out = draw(OPS_SAMPLES)
        out = out[0] if isinstance(out, (list, tuple)) else out
        errs = op_cases.moment_errors(name, out.asnumpy())
        if out.context != gpu(0):
            errs.append(f"drawn on {out.context}")
        if errs:
            sampler_bad[name] = errs
    n_ops = len(op_cases.CASES)
    print(f"op surface: {n_ops} ops of the registry on gpu(0) vs cpu(), "
          f"{n_ops - len(bad)} agree (exact / 1e-5 sums / 1e-6 "
          f"transcendental / 2^-7 bf16); {len(op_cases.SAMPLER_CALLS(nd, cpu()))}"
          f" samplers on the card, {OPS_SAMPLES} draws each: "
          f"{len(sampler_bad)} outside their moments; K1 launches by case "
          f"{k1} on {smi}")
    for name, diff in sorted({**bad, **sampler_bad}.items()):
        print(f"  DIFFERS {name}: {'; '.join(diff[:4])}")
    if bad or sampler_bad:
        raise SystemExit(f"FAIL: ops differ on the card: "
                         f"{sorted(bad) + sorted(sampler_bad)}")
    if k1 != K1_CASES:
        raise SystemExit(f"FAIL: K1 launches by case {k1}, expected "
                         f"{K1_CASES} (the unmasked and the causal call at "
                         "D = 32 in each)")
    return sum(k1.values())


def lstm_batches(rng, n, batch):
    """``n`` truncated-BPTT batches (tokens, next tokens) of a seeded
    synthetic token stream at PTB's vocabulary, as int32 numpy arrays."""
    stream = rng.integers(0, PTB_MEDIUM["vocab"],
                          (batch, n * LSTM_BPTT + 1)).astype(np.int32)
    return [(stream[:, i * LSTM_BPTT:(i + 1) * LSTM_BPTT],
             stream[:, i * LSTM_BPTT + 1:(i + 1) * LSTM_BPTT + 1])
            for i in range(n)]


class LSTMTrainer:
    """The truncated-BPTT loop of the PTB word LM as a Gluon user writes
    it: ``record``, the model with the carried states, the per-sample
    cross-entropy, ``backward``, ``clip_global_norm`` of the gradients at
    LSTM_CLIP (per sample: the gradients sum over the batch), SGD through
    ``Trainer.step(batch)``, the states detached."""

    def __init__(self, net, batch, ctx):
        self.net, self.batch, self.ctx = net, batch, ctx
        self.trainer = gluon.Trainer(net.collect_params(), "sgd",
                                     {"learning_rate": LSTM_LR})
        self.loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        self.states = net.begin_state(batch, ctx=ctx)

    def step(self, x, y):
        with autograd.record():
            out, self.states = self.net(x, self.states)
            loss = self.loss_fn(out, y)
        loss.backward()
        grads = [p.grad() for p in self.net.collect_params().values()
                 if p.grad_req != "null"]
        gluon.utils.clip_global_norm(grads, LSTM_CLIP * self.batch)
        self.trainer.step(self.batch)
        self.states = [s.detach() for s in self.states]
        return loss


def lstm_weights(seed: int):
    """Seeded PTB-medium weights, uniform in [-0.05, 0.05] (Zaremba et
    al.'s init), by structural name."""
    rng = np.random.default_rng(seed)
    c = PTB_MEDIUM
    shapes = {"embedding.weight": (c["vocab"], c["embed"]),
              "lstm.parameters": (rnn_param_size(
                  "lstm", c["layers"], c["embed"], c["hidden"], False),),
              "decoder.weight": (c["vocab"], c["hidden"]),
              "decoder.bias": (c["vocab"],)}
    return {k: rng.uniform(-0.05, 0.05, s).astype(np.float32)
            for k, s in shapes.items()}


def lstm_check(named, batches, ctx):
    """LSTM_CHECK_STEPS steps at dropout 0 on ``ctx`` from ``named``: the
    per-sample losses and the parameters."""
    with ctx:
        net = ptb_medium(dropout=0.0)
        load_jax_params(net, named, ctx=ctx)
        loop = LSTMTrainer(net, LSTM_CHECK_BATCH, ctx)
        losses = [loop.step(nd.array(x, dtype="int32"),
                            nd.array(y, dtype="int32")).asnumpy()
                  for x, y in batches]
        return np.stack(losses), {k: p.data().asnumpy() for k, p in
                                  net._collect_params_with_prefix().items()}


def lstm_yardsticks(smi: str):
    """The port's RNN op against ``torch.nn.LSTM`` (cuDNN; a yardstick the
    port never calls) at the main path's shape, forward + backward of the
    two layers over one BPTT window, f32: CUDA events around the calls and
    the device time replayed from a CUDA graph of 10 calls."""
    c = PTB_MEDIUM
    dev = gpu(0).torch_device()
    g = torch.Generator(device=dev).manual_seed(0)
    T, N, H = LSTM_BPTT, LSTM_BATCH, c["hidden"]
    x = torch.randn(T, N, c["embed"], device=dev, generator=g)
    h0 = torch.zeros(c["layers"], N, H, device=dev)
    size = rnn_param_size("lstm", c["layers"], c["embed"], H, False)
    params = ((torch.rand(size, device=dev, generator=g) - 0.5) * 0.1) \
        .requires_grad_(True)

    def port():
        out, hT, cT = ops.rnn(x, params, h0, h0, state_size=H,
                              num_layers=c["layers"])
        out.sum().backward()
    lstm = torch.nn.LSTM(c["embed"], H, c["layers"]).to(dev)

    def cudnn():
        out, _ = lstm(x, (h0, h0))
        out.sum().backward()
    times = {"port_ms": median_ms(port), "port_graph_ms": graph_ms(port),
             "cudnn_ms": median_ms(cudnn), "cudnn_graph_ms": graph_ms(cudnn)}
    print(f"LSTM 2 x 650 forward + backward over ({T}, {N}, {H}) f32: the "
          f"port's RNN op {times['port_ms']:.3f} ms (graph "
          f"{times['port_graph_ms']:.3f}); torch.nn.LSTM (cuDNN, a "
          f"yardstick) {times['cudnn_ms']:.3f} ms (graph "
          f"{times['cudnn_graph_ms']:.3f}) on {smi}")
    return times


def phase_ops_rnn(seed: int, smi: str):
    """Phase 9: (a) the op surface on the card; (b) the LSTM word LM at
    PTB-medium width trained through gluon.Trainer (the main path); (c)
    three steps of it on the card against the CPU."""
    k1 = op_surface(seed, smi)

    # (b) the main path: counts from 0 just before, read just after
    rng = np.random.default_rng(seed + 12)
    n = LSTM_WARMUP + 2 * LSTM_TIMED
    batches = [(nd.array(x, ctx=gpu(0), dtype="int32"),
                nd.array(y, ctx=gpu(0), dtype="int32"))
               for x, y in lstm_batches(rng, n + 1, LSTM_BATCH)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fa.launches = fa.launches_dq = fa.launches_dkv = fc.launches = 0
    rtc.launches = 0
    with gpu(0):
        net = ptb_medium()
        net.initialize(init.Uniform(0.05))
        loop = LSTMTrainer(net, LSTM_BATCH, gpu(0))
    losses = [loop.step(*b) for b in batches[:LSTM_WARMUP]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[LSTM_WARMUP:LSTM_WARMUP + LSTM_TIMED]:
        losses.append(loop.step(*b))
    losses[-1].asnumpy()                   # the window closes on a fetch
    wall = time.perf_counter() - t0
    step_ms = []
    for b in batches[LSTM_WARMUP + LSTM_TIMED:n]:
        t1 = time.perf_counter()
        losses.append(loop.step(*b))
        losses[-1].asnumpy()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    hand = {"K1": fa.launches, "K2": fa.launches_dq, "K3": fa.launches_dkv,
            "K4": fc.launches, "K5": rtc.launches}
    # ---- end of the main path ----
    peak = torch.cuda.max_memory_allocated()
    median = float(np.median(step_ms))
    device_ms, device_ops = profiled(lambda: loop.step(*batches[n]))
    all_losses = np.array([l.asnumpy().mean() for l in losses])
    tokens = LSTM_BATCH * LSTM_BPTT * LSTM_TIMED
    print(f"LSTM LM (PTB medium: 2 x 650, vocab 10000, dropout 0.5) through "
          f"gluon.Trainer, SGD lr {LSTM_LR}, clip {LSTM_CLIP}, batch "
          f"{LSTM_BATCH} x BPTT {LSTM_BPTT}, f32: {n} steps, losses "
          f"{all_losses[0]:.4f} -> {all_losses[-1]:.4f} (ln 10000 = "
          f"{math.log(PTB_MEDIUM['vocab']):.4f}); hand-written kernel "
          f"launches on the path {hand} (none lies on it)")
    print(f"training the LSTM LM through gluon.Trainer: {tokens / wall:.0f} "
          f"tokens/s over {LSTM_TIMED} steps (wall {wall:.3f} s), step "
          f"median {median:.2f} ms (host clock to a fetched loss), device "
          f"{device_ms:.2f} ms/step, busy share {device_ms / median:.3f}, "
          f"{device_ops:.0f} device operations a step, peak device memory "
          f"{peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB of it held before "
          f"the phase) on {smi}")
    if not np.isfinite(all_losses).all():
        raise SystemExit("FAIL: an LSTM LM loss is not finite")
    if any(hand.values()):
        raise SystemExit(f"FAIL: a hand-written kernel ran on the LSTM path: "
                         f"{hand}")
    del net, loop, losses, batches
    yard = lstm_yardsticks(smi)

    # (c) card against CPU from the same weights, dropout 0
    named = lstm_weights(seed + 13)
    check = lstm_batches(np.random.default_rng(seed + 14), LSTM_CHECK_STEPS,
                         LSTM_CHECK_BATCH)
    got = lstm_check(named, check, gpu(0))
    want = lstm_check(named, check, cpu())
    loss_err = float(np.abs(got[0] - want[0]).max() /
                     max(1.0, np.abs(want[0]).max()))
    w_err = max(float(np.abs(got[1][k] - want[1][k]).max() /
                      max(1.0, np.abs(want[1][k]).max())) for k in want[1])
    print(f"LSTM LM card vs CPU, {LSTM_CHECK_STEPS} steps at batch "
          f"{LSTM_CHECK_BATCH}, dropout 0, f32: losses {want[0].mean(1)} "
          f"max relative difference {loss_err:.3g}; parameters {w_err:.3g} "
          f"(tol {LSTM_TOL} of max(1, |value|))")
    if not (loss_err <= LSTM_TOL and w_err <= LSTM_TOL):
        raise SystemExit("FAIL: the LSTM LM on the card disagrees with the "
                         "CPU")
    return {"k1_op_surface": k1, "hand": hand, "tokens_per_s": tokens / wall,
            "step_ms": median, "device_ms": device_ms,
            "busy_share": device_ms / median, "device_ops": device_ops,
            "peak_bytes": peak, "held_bytes": held, **yard}


# ---------------------------------------------------------------------------
# phase 10: SSD
# ---------------------------------------------------------------------------
def ssd_tiny_weights(seed: int):
    """Seeded Xavier-uniform weights of ``ssd_96_tiny(classes=3)`` by
    structural name (biases uniform in +-0.05)."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, p in ssd_zoo.ssd_96_tiny(classes=3) \
            ._collect_params_with_prefix().items():
        if len(p.shape) < 2:
            out[k] = rng.uniform(-0.05, 0.05, p.shape).astype(np.float32)
            continue
        fan_in = int(np.prod(p.shape[1:]))
        fan_out = p.shape[0] * int(np.prod(p.shape[2:]))
        a = math.sqrt(6.0 / (fan_in + fan_out))
        out[k] = rng.uniform(-a, a, p.shape).astype(np.float32)
    return out


def ssd_tiny_check(named, x, y, ctx):
    """SSD_CHECK_STEPS SGD-momentum steps (lr 1e-3, tests/test_ssd.py's)
    of ssd_96_tiny at f32 through gluon.Trainer on ``ctx``: the losses, the
    parameters, the forward's outputs and ``detect()``'s rows after them,
    as numpy."""
    with ctx:
        net = ssd_zoo.ssd_96_tiny(classes=3)
        load_jax_params(net, named, ctx=ctx)
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 1e-3, "momentum": 0.9})
        loss_fn = ssd_zoo.SSDMultiBoxLoss()
        xs, ys = nd.array(x, ctx=ctx), nd.array(y, ctx=ctx)
        losses = []
        for _ in range(SSD_CHECK_STEPS):
            with autograd.record():
                loss = loss_fn(*net(xs), ys)
            loss.backward()
            trainer.step(len(x))
            losses.append(loss.asnumpy())
        outs = [a.asnumpy() for a in net(xs)]
        det = net.detect(xs, **SSD_CHECK_DETECT)
        if det.context != ctx:
            raise SystemExit(f"FAIL: detect() returned rows on {det.context}")
        return (np.stack(losses), {k: p.data().asnumpy() for k, p in
                                   net._collect_params_with_prefix().items()},
                outs, det.asnumpy())


def host_ms(fn, reps: int = 5) -> float:
    """Median host ms of ``fn()`` closed by a synchronize, after one
    untimed call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def ssd_accuracy(seed: int, smi: str):
    """Phase 10(d): tests/test_ssd.py's accuracy drive on the card:
    ssd_96_tiny, MAP_STEPS Adam steps (lr 2e-3, batch 16) through
    gluon.Trainer on 96 shapes images, VOC07 mAP@0.5 on 32 held-out
    images (seed 99) at least MAP_FLOOR."""
    imgs, labels = get_shapes_detection(96, size=96, seed=0)
    val_imgs, val_labels = get_shapes_detection(32, size=96, seed=99)
    random.seed(seed)
    t0 = time.perf_counter()
    with gpu(0):
        net = ssd_zoo.ssd_96_tiny(classes=3)
        net.initialize(init.Xavier())
        net.hybridize()
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": MAP_LR})
        loss_fn = ssd_zoo.SSDMultiBoxLoss()
        imgs_d, labels_d = nd.array(imgs), nd.array(labels)
        rng = np.random.RandomState(7)
        losses = []
        for _ in range(MAP_STEPS):
            idx = nd.array(rng.randint(0, len(imgs), MAP_BATCH),
                           dtype="int32")
            with autograd.record():
                loss = loss_fn(*net(nd.take(imgs_d, idx)),
                               nd.take(labels_d, idx))
            loss.backward()
            trainer.step(MAP_BATCH)
            losses.append(loss)
        first = float(losses[0].asnumpy().mean())
        last = float(losses[-1].asnumpy().mean())
        metric = ssd_zoo.MApMetric(ovp_thresh=0.5)
        metric.update(net.detect(nd.array(val_imgs), threshold=0.01),
                      val_labels)
    mean_ap = metric.get()[1]
    print(f"SSD accuracy (tests/test_ssd.py's drive): ssd_96_tiny, "
          f"{MAP_STEPS} Adam steps lr {MAP_LR} batch {MAP_BATCH} through "
          f"gluon.Trainer, losses {first:.4f} -> {last:.4f}; VOC07 mAP@0.5 "
          f"on 32 held-out images {mean_ap:.4f} (floor {MAP_FLOOR}), "
          f"{time.perf_counter() - t0:.1f} s on {smi}")
    if not (mean_ap >= MAP_FLOOR and last < first / 4):
        raise SystemExit(f"FAIL: SSD mAP {mean_ap:.4f} < {MAP_FLOOR} or the "
                         f"loss did not fall to a quarter ({first} -> {last})")
    return mean_ap


def phase_ssd(seed: int, smi: str):
    """Phase 10: SSD. (a) ssd_96_tiny at f32, card against CPU; (b) the
    main path: ssd_300_vgg16 trained at batch 32, bf16, through
    ParallelTrainStep; (c) detect() at full width; (d) the accuracy
    drive."""
    # (a) card against CPU, same weights and batch
    named = ssd_tiny_weights(seed + 15)
    x, y = get_shapes_detection(SSD_CHECK_BATCH, size=96, seed=seed + 16)
    got = ssd_tiny_check(named, x, y, gpu(0))
    want = ssd_tiny_check(named, x, y, cpu())
    problems = op_cases.detection_problems(
        want[2][1], want[2][2], want[2][0], SSD_CHECK_DETECT["threshold"],
        SSD_CHECK_DETECT["nms_threshold"], SSD_CHECK_DETECT["nms_topk"])
    if problems:
        raise SystemExit(f"FAIL: the SSD check's NMS is ill posed: {problems}")
    rel = lambda a, b: float(np.abs(a - b).max() /  # noqa: E731
                             max(1.0, np.abs(b).max()))
    loss_err = rel(got[0], want[0])
    w_err = max(rel(got[1][k], want[1][k]) for k in want[1])
    det_err = rel(got[3], want[3])
    same_rows = bool((got[3][..., 0] == want[3][..., 0]).all())
    kept = int((want[3][..., 0] >= 0).sum())
    print(f"SSD ssd_96_tiny card vs CPU, {SSD_CHECK_STEPS} SGD-momentum "
          f"steps at batch {SSD_CHECK_BATCH}, f32: losses "
          f"{want[0].mean(1)} max relative difference {loss_err:.3g}; "
          f"parameters {w_err:.3g}; detect() {kept} rows kept, classes "
          f"equal {same_rows}, rows {det_err:.3g} (tol {LSTM_TOL} of "
          f"max(1, |value|))")
    if not (loss_err <= LSTM_TOL and w_err <= LSTM_TOL and same_rows
            and det_err <= LSTM_TOL and kept):
        raise SystemExit("FAIL: SSD on the card disagrees with the CPU")

    # (b) the main path: counts from 0 just before, read just after
    imgs, labels = get_shapes_detection(SSD_IMAGES, size=300, seed=seed)
    imgs_d = torch.from_numpy(imgs).to(gpu(0).torch_device())
    labels_d = torch.from_numpy(labels).to(gpu(0).torch_device())
    rng = np.random.RandomState(7)
    n = SSD_WARMUP + 2 * SSD_TIMED
    idx = torch.from_numpy(rng.randint(0, SSD_IMAGES, (n + 1, SSD_BATCH))) \
        .to(imgs_d.device)
    batches = [(imgs_d[i], labels_d[i]) for i in idx]
    del imgs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fa.launches = fa.launches_dq = fa.launches_dkv = fc.launches = 0
    rtc.launches = 0
    random.seed(seed)
    with gpu(0):
        net = ssd_zoo.ssd_300_vgg16(classes=3)
        net.initialize(init.Xavier())
    step = ParallelTrainStep(net, ssd_zoo.SSDMultiBoxLoss(),
                             Adam(learning_rate=SSD_LR),
                             make_mesh({"dp": 1}), compute_dtype="bfloat16")
    losses = [step(*b) for b in batches[:SSD_WARMUP]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[SSD_WARMUP:SSD_WARMUP + SSD_TIMED]:
        losses.append(step(*b))
    losses[-1].item()                      # the window closes on a fetch
    wall = time.perf_counter() - t0
    step_ms = []
    for b in batches[SSD_WARMUP + SSD_TIMED:n]:
        t1 = time.perf_counter()
        losses.append(step(*b))
        losses[-1].item()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    train_hand = {"K1": fa.launches, "K2": fa.launches_dq,
                  "K3": fa.launches_dkv, "K4": fc.launches,
                  "K5": rtc.launches}
    # ---- end of the main path ----
    peak = torch.cuda.max_memory_allocated()
    median = float(np.median(step_ms))
    device_ms, device_ops = profiled(lambda: step(*batches[n]))
    all_losses = np.array([v.item() for v in losses])
    imgs_per_s = SSD_BATCH * SSD_TIMED / wall
    n_params = sum(p.numel() for p in step.params.values())
    print(f"SSD-300 VGG16 (ssd_300_vgg16(classes=3), {SSD_ANCHORS} anchors, "
          f"{n_params} parameters) through ParallelTrainStep, Adam lr "
          f"{SSD_LR}, bf16 over f32 masters, batch {SSD_BATCH} x 3 x 300 x "
          f"300 of get_shapes_detection on the card: {n} steps, losses "
          f"{all_losses[0]:.4f} -> {all_losses[-1]:.4f}; hand-written "
          f"kernel launches on the path {train_hand} (none lies on it)")
    print(f"training SSD-300 through ParallelTrainStep: {imgs_per_s:.1f} "
          f"img/s over {SSD_TIMED} steps (wall {wall:.3f} s), step median "
          f"{median:.2f} ms (host clock to a fetched loss), device "
          f"{device_ms:.2f} ms/step, busy share {device_ms / median:.3f}, "
          f"{device_ops:.0f} device operations a step, peak device memory "
          f"{peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB of it held before "
          f"the phase) on {smi}")
    if not np.isfinite(all_losses).all() or \
            all_losses[-5:].mean() >= all_losses[:2].mean():
        raise SystemExit(f"FAIL: SSD-300 losses not finite or not falling: "
                         f"{all_losses}")
    if any(train_hand.values()):
        raise SystemExit(f"FAIL: a hand-written kernel ran on the SSD path: "
                         f"{train_hand}")

    # (c) detect() at full width, 32 images, from the trained weights
    fa.launches = fa.launches_dq = fa.launches_dkv = fc.launches = 0
    rtc.launches = 0
    net = step._block.eval()
    x32 = batches[0][0]
    rows = net.detect(x32, **SSD_DETECT)
    k_rows, kept = contrib.nms_rows, int((rows[..., 0] >= 0).sum().item())
    n_anchors = rows.shape[1]
    detect_ms = host_ms(lambda: net.detect(x32, **SSD_DETECT))
    with torch.no_grad():
        anchors, cls_preds, loc_preds = net(x32)
        prob = ops.softmax(cls_preds, axis=1)
    nms_ms = host_ms(lambda: contrib.multibox_detection(
        prob, loc_preds, anchors, **SSD_DETECT))
    detect_hand = {"K1": fa.launches, "K2": fa.launches_dq,
                   "K3": fa.launches_dkv, "K4": fc.launches,
                   "K5": rtc.launches}
    print(f"SSD-300 detect() on {SSD_BATCH} images at 300 x 300 (f32, "
          f"threshold 0.01, NMS 0.45, top 400): {detect_ms:.2f} ms (host "
          f"clock to the synchronized rows), MultiBoxDetection alone "
          f"{nms_ms:.2f} ms = {nms_ms / detect_ms:.3f} of it; the NMS loop "
          f"ran over K = {k_rows} of {n_anchors} sorted rows (one host sync), "
          f"{kept} rows kept; hand-written kernel launches {detect_hand} on "
          f"{smi}")
    if not (rows.shape == (SSD_BATCH, SSD_ANCHORS, 6) and kept
            and torch.isfinite(rows).all()) or any(detect_hand.values()):
        raise SystemExit("FAIL: SSD-300 detect() rows")
    del step, net, batches, imgs_d, labels_d, rows

    # (d) accuracy
    mean_ap = ssd_accuracy(seed, smi)
    hand = {k: train_hand[k] + detect_hand[k] for k in train_hand}
    return {"hand": hand, "img_per_s": imgs_per_s, "step_ms": median,
            "device_ms": device_ms, "busy_share": device_ms / median,
            "device_ops": device_ops, "peak_bytes": peak, "held_bytes": held,
            "detect_ms": detect_ms, "nms_ms": nms_ms, "nms_rows": k_rows,
            "kept": kept, "map": mean_ap}


# ---------------------------------------------------------------------------
# phase 13: the data path
# ---------------------------------------------------------------------------
def decoders():
    """The image decoders this host has, in the order imdecode tries."""
    return [m for m in ("PIL", "cv2") if importlib.util.find_spec(m)]


def write_data_records(seed: int, jpeg: bool, count: int = DATA_RECORDS,
                       stem: str = ""):
    """``count`` seeded DATA_HW x DATA_HW x 3 uint8 images with labels in
    [0, 1000) as raw-pixel records (``recordio.pack`` of the bytes) and,
    when ``jpeg``, as JPEG records (``recordio.pack_img``, quality 95),
    each file (``{stem}raw.rec``, ``{stem}jpeg.rec``) with its ``.idx``.
    Returns the paths, the images' bytes and the seconds each file took."""
    rng = np.random.default_rng(seed + 21)
    imgs = rng.integers(0, 256, (count, DATA_HW, DATA_HW, 3),
                        dtype=np.uint8)
    labels = rng.integers(0, 1000, count)
    DATA_DIR.mkdir(parents=True, exist_ok=True)
    paths, seconds = {}, {}
    for kind in ("raw", "jpeg") if jpeg else ("raw",):
        path = DATA_DIR / f"{stem}{kind}.rec"
        t0 = time.perf_counter()
        w = recordio.MXIndexedRecordIO(str(path.with_suffix(".idx")),
                                       str(path), "w")
        for i in range(count):
            header = recordio.IRHeader(0, float(labels[i]), i, 0)
            if kind == "raw":
                w.write_idx(i, recordio.pack(header, imgs[i].tobytes()))
            else:      # cv2 encodes BGR; the decoder gives the RGB back
                w.write_idx(i, recordio.pack_img(header, imgs[i][:, :, ::-1],
                                                 quality=95))
        w.close()
        paths[kind], seconds[kind] = str(path), time.perf_counter() - t0
    return paths, imgs, seconds


def _decode_raw(record):
    header, body = recordio.unpack(record)
    img = np.frombuffer(body, np.uint8).reshape(DATA_HW, DATA_HW, 3)
    return nd.array(img, ctx=cpu(), dtype="uint8"), header.label


def data_pipeline():
    return T.Compose([T.RandomResizedCrop(224), T.RandomFlipLeftRight(),
                      T.ToTensor(), T.Normalize(DATA_MEAN, DATA_STD)])


def data_loader(path, kind, num_workers=DATA_WORKERS):
    """The DataLoader of the main path over ``path``: raw-pixel records
    decoded by ``_decode_raw``, or JPEG records through
    ``ImageRecordDataset``; the transforms on the first field."""
    if kind == "raw":
        ds = gdata.RecordFileDataset(path).transform(_decode_raw)
    else:
        ds = gdata.vision.ImageRecordDataset(path)
    return gdata.DataLoader(ds.transform_first(data_pipeline()),
                            batch_size=RESNET_BATCH, shuffle=True,
                            num_workers=num_workers, pin_memory=True,
                            last_batch="discard")


def data_epoch(step, loader):
    """One epoch of ResNet-50 steps from ``loader``: each batch moved with
    ``as_in_context(gpu(0))``, the images cast to bf16, each loss fetched.
    Returns the losses, the consumer's wait per batch (ms), each step's ms
    (host clock, batch on the card to fetched loss) and the wall."""
    losses, waits, steps = [], [], []
    t0 = time.perf_counter()
    it = iter(loader)
    while True:
        t1 = time.perf_counter()
        batch = next(it, None)
        t2 = time.perf_counter()
        if batch is None:
            break
        waits.append((t2 - t1) * 1e3)
        x, y = (b.as_in_context(gpu(0)).data for b in batch)
        losses.append(step(x.to(torch.bfloat16), y).item())
        steps.append((time.perf_counter() - t2) * 1e3)
    return {"losses": np.asarray(losses), "waits": np.asarray(waits),
            "step_ms": np.asarray(steps),
            "wall": time.perf_counter() - t0}


def _batch_arrays(batch):
    return [b.data.clone() for b in batch]


def _same_batches(a, b):
    return len(a) == len(b) and all(
        len(x) == len(y) and all(torch.equal(u, v) for u, v in zip(x, y))
        for x, y in zip(a, b))


def data_determinism(seed: int, path: str):
    """(c): the first DATA_SAME_BATCHES batches with 0 workers and with
    DATA_WORKERS under one seed, and a loader restored from the state after
    DATA_RESUME_AT batches against the rest of the epoch; bitwise."""
    heads = []
    for workers in (0, DATA_WORKERS):
        random.seed(seed)
        it = iter(data_loader(path, "raw", workers))
        heads.append([_batch_arrays(next(it))
                      for _ in range(DATA_SAME_BATCHES)])
        del it
    random.seed(seed)
    first = data_loader(path, "raw")
    it = iter(first)
    for _ in range(DATA_RESUME_AT):
        next(it)
    state = first.state_dict()
    rest = [_batch_arrays(b) for b in it]
    random.seed(seed + 1)        # the restored loader must not depend on it
    second = data_loader(path, "raw")
    second.load_state_dict(state)
    resumed = [_batch_arrays(b) for b in second]
    return {"workers_equal": _same_batches(heads[0], heads[1]),
            "resume_equal": _same_batches(rest, resumed),
            "resumed": len(resumed)}


def data_iterators(paths, imgs):
    """(b): ImageRecordIter over the JPEG records (where a decoder
    exists), and NDArrayIter under PrefetchingIter on the engine over
    raw-pixel batches, in order."""
    out = {"image_record_iter": None}
    if "jpeg" in paths:
        it = io.ImageRecordIter(path_imgrec=paths["jpeg"],
                                data_shape=(3, 224, 224),
                                batch_size=RESNET_BATCH,
                                preprocess_threads=DATA_WORKERS)
        native_path = isinstance(it, io.NativeImageRecordIter)
        t0 = time.perf_counter()
        shapes = [batch.data[0].shape for batch in it]
        out["image_record_iter"] = {
            "path": "native OpenCV pipeline" if native_path
            else "Python ImageIter + PrefetchingIter",
            "batches": shapes.count((RESNET_BATCH, 3, 224, 224)),
            "batches_per_s": len(shapes) / (time.perf_counter() - t0)}
    x = imgs[:8 * RESNET_BATCH]
    y = np.arange(len(x), dtype=np.float32)
    want = [b.data[0].asnumpy() for b in io.NDArrayIter(
        x, y, batch_size=RESNET_BATCH)]
    got = [b.data[0].asnumpy() for b in io.PrefetchingIter(
        io.NDArrayIter(x, y, batch_size=RESNET_BATCH), prefetch=4)]
    out["prefetch_in_order"] = len(got) == len(want) == 8 and all(
        np.array_equal(a, b) for a, b in zip(got, want))
    return out


def phase_data(seed: int, smi: str, resnet: dict):
    """Phase 13: (a) ResNet-50 trained from a DataLoader over a RecordIO
    file (raw pixels, and JPEG where the host has a decoder); (b) the
    iterators; (c) determinism across workers and a resume; the image ops
    are op cases of phase 9(a)."""
    have = decoders()
    lib = native.available()
    print(f"data path: decoders on this host {have or 'none'}; native "
          f"library (g++) {'built' if lib else 'FAILED'} at "
          f"{native.lib_path()}; OpenCV image pipeline "
          f"{'built' if native.has_image_pipeline() else 'not built (no OpenCV headers)'}"
          f"; host engine {type(engine.get_engine()).__name__}")
    if not lib or not isinstance(engine.get_engine(), native.NativeEngine):
        raise SystemExit(f"FAIL: the native engine and recordio did not "
                         f"build or load: {native.build_error()}")
    paths, imgs, write_s = write_data_records(seed, jpeg=bool(have))
    print(f"wrote {DATA_RECORDS} records of {DATA_HW} x {DATA_HW} x 3 uint8 "
          f"({imgs.nbytes / 2**20:.0f} MiB raw) with MXIndexedRecordIO: "
          + ", ".join(f"{k} {os.path.getsize(p) / 2**20:.1f} MiB in "
                      f"{write_s[k]:.2f} s" for k, p in paths.items()))
    probe = resnet50_v1(classes=1000)
    step = resnet_train_step(seeded_resnet_weights(probe, seed), "bfloat16")
    warm = step.place_batch_n(*resnet_batch(np.random.default_rng(seed + 22),
                                            DATA_WARMUP, RESNET_BATCH))
    for i in range(DATA_WARMUP):
        step(warm[0][i].to(torch.bfloat16), warm[1][i]).item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    random.seed(seed)

    # ---- the main path: counts from 0 just before, read just after ----
    fa.launches = fa.launches_dq = fa.launches_dkv = fc.launches = 0
    rtc.launches = 0
    raw = data_epoch(step, data_loader(paths["raw"], "raw"))
    hand = {"K1": fa.launches, "K2": fa.launches_dq, "K3": fa.launches_dkv,
            "K4": fc.launches, "K5": rtc.launches}
    # ---- end of the main path ----
    peak = torch.cuda.max_memory_allocated()
    prof_it = iter(data_loader(paths["raw"], "raw"))

    def one_step():
        x, y = (b.as_in_context(gpu(0)).data for b in next(prof_it))
        return step(x.to(torch.bfloat16), y)
    median = float(np.median(raw["step_ms"]))
    device_ms, busy = busy_share(one_step, median)
    del prof_it
    runs = {"raw pixels": raw}
    if "jpeg" in paths:
        runs[f"JPEG ({have[0]})"] = data_epoch(
            step, data_loader(paths["jpeg"], "jpeg"))
    for name, r in runs.items():
        n = len(r["losses"])
        print(f"resnet50_v1 bf16 from a DataLoader ({name}; {DATA_WORKERS} "
              f"workers, shuffle, pin_memory, RandomResizedCrop(224) -> "
              f"RandomFlipLeftRight -> ToTensor -> Normalize): {n} steps, "
              f"{RESNET_BATCH * n / r['wall']:.1f} img/s (wall "
              f"{r['wall']:.3f} s), step median "
              f"{float(np.median(r['step_ms'])):.2f} ms (host clock to a "
              f"fetched loss), loader wait per batch p50 "
              f"{np.percentile(r['waits'], 50):.3f} ms p99 "
              f"{np.percentile(r['waits'], 99):.3f} ms; losses "
              f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f} on {smi}")
    if "jpeg" not in paths:
        print("JPEG epoch did not run: no decoder (PIL or cv2) on this host")
    print(f"  raw-pixel path: device {device_ms:.2f} ms/step, busy share "
          f"{busy:.3f} ({PROFILED_STEPS} profiled steps), peak device memory "
          f"{peak / 2**30:.2f} GiB; phase 5's synthetic input in this run: "
          f"{resnet['img_s']:.1f} img/s, step median {resnet['step_ms']:.2f}"
          f" ms; hand-written kernel launches {hand} (none lies on this "
          f"path) on {smi}")
    if not all(np.isfinite(r["losses"]).all() and len(r["losses"])
               == DATA_RECORDS // RESNET_BATCH for r in runs.values()) \
            or any(hand.values()):
        raise SystemExit("FAIL: the DataLoader-fed ResNet-50 epoch")
    iters = data_iterators(paths, imgs)
    ir = iters["image_record_iter"]
    if ir is None:
        print("ImageRecordIter did not run: no decoder (PIL or cv2) on this "
              "host")
    else:
        print(f"ImageRecordIter over the JPEG records (3 x 224 x 224, batch "
              f"{RESNET_BATCH}, {DATA_WORKERS} threads): {ir['path']}, "
              f"{ir['batches']} batches, {ir['batches_per_s']:.2f} batches/s "
              f"on {smi}")
    print(f"NDArrayIter under PrefetchingIter on the {type(engine.get_engine()).__name__}"
          f" over raw-pixel batches: order kept {iters['prefetch_in_order']}")
    det = data_determinism(seed, paths["raw"])
    print(f"determinism: first {DATA_SAME_BATCHES} batches with 0 and "
          f"{DATA_WORKERS} workers bitwise equal {det['workers_equal']}; "
          f"restored after batch {DATA_RESUME_AT}, the {det['resumed']} "
          f"batches left bitwise equal {det['resume_equal']}")
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    if not (iters["prefetch_in_order"] and det["workers_equal"]
            and det["resume_equal"]) or (ir is not None
                                         and ir["batches"] != DATA_RECORDS
                                         // RESNET_BATCH):
        raise SystemExit("FAIL: the data path's iterators or determinism")
    return {"hand": hand, "img_s": RESNET_BATCH * len(raw["losses"])
            / raw["wall"], "step_ms": median, "busy_share": busy,
            "device_ms": device_ms}


# ---------------------------------------------------------------------------
# phase 14: the training utilities, custom ops and the rest of the zoo
# ---------------------------------------------------------------------------
def _est_loaders(paths):
    """Phase 13's training DataLoader (the ImageNet training transforms,
    then a cast to bf16) and the validation one (resize, center crop 224,
    no shuffle) over the raw-pixel records."""
    def loader(path, transforms, shuffle):
        ds = gdata.RecordFileDataset(path).transform(_decode_raw)
        return gdata.DataLoader(
            ds.transform_first(T.Compose(transforms + [T.Cast("bfloat16")])),
            batch_size=RESNET_BATCH, shuffle=shuffle,
            num_workers=DATA_WORKERS, pin_memory=True, last_batch="discard")
    train = [T.RandomResizedCrop(224), T.RandomFlipLeftRight(),
             T.ToTensor(), T.Normalize(DATA_MEAN, DATA_STD)]
    val = [T.Resize(256), T.CenterCrop(224), T.ToTensor(),
           T.Normalize(DATA_MEAN, DATA_STD)]
    return loader(paths["train"], train, True), \
        loader(paths["val"], val, False)


class _EpochRecorder(est_handlers.EpochBegin, est_handlers.BatchBegin,
                     est_handlers.BatchEnd, est_handlers.EpochEnd):
    """Keeps, per epoch, every batch's prediction and label on the card,
    the training metrics' values and a copy of the parameters at the
    epoch's end (before any other handler runs), and the seconds from the
    epoch's start to its last batch's end."""

    priority = -5000

    def __init__(self, net):
        self.net = net
        self.preds, self.labels, self.metrics, self.params = [], [], [], []
        self.train_s = []

    def epoch_begin(self, estimator, *args, **kwargs):
        self.preds.append([])
        self.labels.append([])
        self._epoch_t0 = time.perf_counter()

    def batch_begin(self, estimator, *args, **kwargs):
        self._t0 = time.perf_counter()

    def batch_end(self, estimator, *args, **kwargs):
        self.preds[-1].append(kwargs["pred"].data.detach())
        self.labels[-1].append(kwargs["label"].data.detach())
        self._t1 = time.perf_counter()

    def epoch_end(self, estimator, *args, **kwargs):
        self.train_s.append(self._t1 - self._epoch_t0)
        self.metrics.append([m.get() for m in estimator.train_metrics])
        self.params.append({k: p.data().data.detach().cpu().clone()
                            for k, p in
                            self.net._collect_params_with_prefix().items()})


class _StepTimer(est_handlers.BatchBegin, est_handlers.BatchEnd):
    """Each step's host ms, batch in to every metric updated (it runs
    last at a batch's end)."""

    priority = 10 ** 6

    def __init__(self):
        self.ms = []

    def batch_begin(self, estimator, *args, **kwargs):
        self._t0 = time.perf_counter()

    def batch_end(self, estimator, *args, **kwargs):
        self.ms.append((time.perf_counter() - self._t0) * 1e3)


def _profile_fit(est, loader, handlers=()):
    """``est.fit`` over PROFILED_STEPS batches under torch.profiler: device
    ms per step, device-to-host copies per step, the convolutions that ran
    on the card and those that ran on the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        est.fit(loader, batches=PROFILED_STEPS, event_handlers=list(handlers))
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0
              and e.key not in ("mxt.optimizer", "mxt.loss")]
    d2h = sum(e.count for e in events if e.key.startswith("Memcpy DtoH"))
    card_convs = sum(e.count for e in events
                     if e.key == "aten::cudnn_convolution")
    host_convs = sum(e.count for e in events if e.key in HOST_CONV_OPS)
    return {"device_ms": sum(e.self_device_time_total for e in device)
            / 1e3 / PROFILED_STEPS, "d2h": d2h / PROFILED_STEPS,
            "card_convs": card_convs / PROFILED_STEPS,
            "host_convs": host_convs}


def _metric_values(preds, labels):
    """Accuracy and TopKAccuracy(5) recomputed from one epoch's
    predictions and labels (CPU tensors) in one update."""
    acc, top5 = metric.Accuracy(), metric.TopKAccuracy(5)
    p, y = nd.NDArray(preds, ctx=cpu()), nd.NDArray(labels, ctx=cpu())
    acc.update(y, p)
    top5.update(y, p)
    return [acc.get(), top5.get()]


def _loads_bitwise(path, want):
    """A fresh bf16 ``resnet50_v1`` loads ``path``; every parameter equals
    ``want``'s bitwise (dtype included)."""
    fresh = resnet50_v1(classes=1000)
    fresh.cast("bfloat16")
    fresh.load_parameters(str(path), ctx=gpu(0))
    got = {k: p.data().data for k, p in
           fresh._collect_params_with_prefix().items()}
    return set(got) == set(want) and all(
        torch.equal(got[k].cpu(), want[k]) for k in want)


def estimator_path(seed: int, smi: str, resnet: dict, data: dict):
    """Phase 14(a): ResNet-50 v1 trained through ``Estimator.fit`` from
    phase 13's DataLoader, with validation, checkpoints and early
    stopping; then the early stop of an lr-0 fit and the profiled step."""
    import contextlib
    import io as _io
    import logging
    paths = {"train": write_data_records(seed, jpeg=False)[0]["raw"],
             "val": write_data_records(seed + 6, jpeg=False,
                                       count=EST_VAL_RECORDS,
                                       stem="val_")[0]["raw"]}
    ckpt_dir = DATA_DIR / "checkpoints"
    train_loader, val_loader = _est_loaders(paths)
    net = resnet50_v1(classes=1000)
    load_jax_params(net, seeded_resnet_weights(net, seed), ctx=gpu(0))
    net.cast("bfloat16")
    out = _io.StringIO()
    with contextlib.redirect_stdout(out):
        net.summary()
    summary = out.getvalue().strip().splitlines()
    total = int(summary[-1].rpartition(" ")[2])
    print(f"net.summary(): {len(summary) - 5} parameter rows, "
          f"{summary[-1]} (the JAX package counts "
          f"{RESNET50_V1_PARAM_COUNT})")
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.05, "momentum": 0.9,
                             "multi_precision": True})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    est = Estimator(net, loss_fn, train_metrics=[metric.Accuracy(),
                                                 metric.TopKAccuracy(5)],
                    trainer=trainer, context=gpu(0))
    val_metrics = [metric.Accuracy(), metric.TopKAccuracy(5)]
    val_log = []

    def validate(loader):
        val_log.append(est.evaluate(loader, val_metrics))
    recorder, timer = _EpochRecorder(net), _StepTimer()
    ckpt = est_handlers.CheckpointHandler(str(ckpt_dir),
                                          monitor=val_metrics[0],
                                          save_best=True)
    stopper = est_handlers.EarlyStoppingHandler(val_metrics[0],
                                                patience=EST_PATIENCE)
    log = logging.getLogger("mxnet_tpu_torch.estimator")
    stream = logging.StreamHandler(sys.stdout)
    stream.setFormatter(logging.Formatter("  estimator: %(message)s"))
    log.addHandler(stream)
    log.setLevel(logging.INFO)
    handlers = [recorder, timer,
                # validation before the checkpoint (-3000) reads its metric
                est_handlers.ValidationHandler(val_loader, validate,
                                               priority=-4000),
                ckpt, stopper,
                est_handlers.LoggingHandler(
                    log_interval=8,
                    metrics=[est.loss_metric] + est.train_metrics)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    random.seed(seed)

    # ---- the main path: counts from 0 just before, read just after ----
    fa.launches = fa.launches_dq = fa.launches_dkv = fc.launches = 0
    rtc.launches = 0
    t0 = time.perf_counter()
    est.fit(train_loader, val_data=val_loader, epochs=EST_EPOCHS,
            event_handlers=handlers)
    wall = time.perf_counter() - t0
    hand = {"K1": fa.launches, "K2": fa.launches_dq, "K3": fa.launches_dkv,
            "K4": fc.launches, "K5": rtc.launches}
    # ---- end of the main path ----
    peak = torch.cuda.max_memory_allocated()
    log.removeHandler(stream)
    epochs = len(recorder.metrics)
    steps = sum(len(p) for p in recorder.preds)
    images = steps * RESNET_BATCH
    train_s = sum(recorder.train_s)
    step_ms = float(np.median(timer.ms))
    stopped_by = "EarlyStoppingHandler" if stopper.stopped_epoch is not None \
        else "StoppingHandler (epoch budget)"
    for e in range(epochs):
        (_, acc), (_, top5) = recorder.metrics[e]
        (_, vacc), (_, vtop5) = val_log[e]
        print(f"epoch {e + 1}: train accuracy {acc:.6f}, top-5 {top5:.6f}; "
              f"validation ({EST_VAL_RECORDS} records) accuracy {vacc:.6f},"
              f" top-5 {vtop5:.6f}")
    print(f"resnet50_v1 bf16 through Estimator.fit ({DATA_WORKERS}-worker "
          f"DataLoader, batch {RESNET_BATCH}, SGD(0.05, momentum 0.9), "
          f"metrics Accuracy and TopKAccuracy(5), validation, checkpoints,"
          f" early stopping): {epochs} epochs, {steps} steps, "
          f"{images / train_s:.1f} img/s over the training batches "
          f"({train_s:.3f} s; the whole fit {wall:.3f} s with validation "
          f"and checkpoints), step median {step_ms:.2f} ms (batch in to "
          f"metrics updated), peak device memory {peak / 2**30:.2f} GiB; "
          f"stopped by {stopped_by}; phase 5 in this run "
          f"{resnet['img_s']:.1f} img/s, step {resnet['step_ms']:.2f} ms; "
          f"phase 13 {data['img_s']:.1f} img/s, step "
          f"{data['step_ms']:.2f} ms; hand-written kernel launches {hand} "
          f"(none lies on this path) on {smi}")

    # ---- checks ----
    on_card = all(p.data().data.is_cuda for p in
                  net.collect_params().values()) and all(
        t.is_cuda for ep in recorder.preds for t in ep)
    flat = torch.cat([t for ep in recorder.preds for t in ep]).cpu()
    flat_y = torch.cat([t for ep in recorder.labels for t in ep]).cpu()
    metrics_equal, at = True, 0
    for e in range(epochs):
        n = sum(t.shape[0] for t in recorder.preds[e])
        again = _metric_values(flat[at:at + n], flat_y[at:at + n])
        metrics_equal &= again == recorder.metrics[e]
        at += n
    best_epoch, best = None, -float("inf")
    for e, ((_, vacc), _) in enumerate(val_log):
        if vacc > best:
            best_epoch, best = e, vacc
    files = {"model-epoch1.params": 0, "model-best.params": best_epoch}
    ckpt_ok = {name: (ckpt_dir / name).exists() and e is not None
               and _loads_bitwise(ckpt_dir / name, recorder.params[e])
               for name, e in files.items()}
    losses_finite = all(math.isfinite(v) for v in
                        (est.loss_metric.get()[1],
                         *(m[0][1] for m in recorder.metrics)))
    print(f"checks: parameters and predictions on the card {on_card}; "
          f"each epoch's training metrics equal those recomputed from its "
          f"{steps // max(epochs, 1)} batches of predictions fetched in one "
          f"piece {metrics_equal}; checkpoints load bitwise into a fresh "
          f"resnet50_v1 {ckpt_ok} (best = epoch {None if best_epoch is None else best_epoch + 1}); loss finite "
          f"{losses_finite}; summary total {total} == "
          f"{RESNET50_V1_PARAM_COUNT}")

    # the early stop: lr 0 over the validation records (fixed order), the
    # epoch's training loss cannot improve by more than float noise
    trainer0 = gluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.0, "momentum": 0.9,
                              "multi_precision": True})
    est0 = Estimator(net, loss_fn, train_metrics=[metric.Accuracy()],
                     trainer=trainer0, context=gpu(0))
    stop0 = est_handlers.EarlyStoppingHandler(est0.loss_metric, patience=0,
                                              min_delta=EST_LR0_MIN_DELTA)
    est0.fit(val_loader, epochs=EST_LR0_EPOCHS, event_handlers=[stop0])
    early = stop0.stopped_epoch is not None and \
        stop0.stopped_epoch + 1 < EST_LR0_EPOCHS and stop0.wait > 0
    print(f"lr-0 fit with EarlyStoppingHandler(loss, patience 0, min_delta "
          f"{EST_LR0_MIN_DELTA}): stopped after epoch "
          f"{None if stop0.stopped_epoch is None else stop0.stopped_epoch + 1}"
          f" of {EST_LR0_EPOCHS} (wait {stop0.wait}) by patience {early}")

    # the profiled step, with the metrics and with the loss metric alone
    prof = _profile_fit(est, train_loader)
    bare = Estimator(net, loss_fn, train_metrics=[], trainer=trainer,
                     context=gpu(0))
    prof_bare = _profile_fit(bare, train_loader)
    print(f"profiled Estimator step ({PROFILED_STEPS} steps): device "
          f"{prof['device_ms']:.2f} ms/step, busy share "
          f"{prof['device_ms'] / step_ms:.3f}; device-to-host copies a step "
          f"{prof['d2h']:.1f} with Accuracy and TopKAccuracy(5), "
          f"{prof_bare['d2h']:.1f} with the loss metric alone (the metrics "
          f"read predictions and labels on the host); cuDNN convolutions a "
          f"step {prof['card_convs']:.0f}, host convolutions "
          f"{prof['host_convs']}")
    placed = prof["card_convs"] > 0 and prof["host_convs"] == 0 and \
        prof_bare["host_convs"] == 0
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    if not (on_card and placed and metrics_equal and all(ckpt_ok.values())
            and losses_finite and early and total == RESNET50_V1_PARAM_COUNT
            and epochs >= 1 and not any(hand.values())):
        raise SystemExit("FAIL: the Estimator path (placement, metrics, "
                         "checkpoints, early stopping, loss or summary)")
    return {"hand": hand, "img_s": images / train_s, "step_ms": step_ms,
            "device_ms": prof["device_ms"],
            "busy_share": prof["device_ms"] / step_ms,
            "d2h_metrics": prof["d2h"], "d2h_bare": prof_bare["d2h"],
            "peak_bytes": peak, "val": val_log, "stopped_by": stopped_by}


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / max(want.float().abs().max().item(), 1e-30))


def zoo_full_width(seed: int, smi: str):
    """Phase 14(b): each ZOO_FULL net at full width: a batch-2 f32 forward
    on the card against the CPU's from the same weights, then three SGD
    steps at batch ZOO_BATCH in bf16 over f32 masters."""
    rows = []
    for name, hw in ZOO_FULL:
        random.seed(seed)
        rng = np.random.default_rng(seed + 31)
        x = rng.standard_normal((2, 3, hw, hw), dtype=np.float32)
        with cpu():
            ref = get_model(name, classes=1000)
            ref.initialize(init.Xavier())
            want = ref(nd.array(x)).data
            weights = {k: p.data().data for k, p in
                       ref._collect_params_with_prefix().items()}
        net = get_model(name, classes=1000)
        load_jax_params(net, weights, ctx=gpu(0))
        got = net(nd.array(x, ctx=gpu(0))).data
        rel = _rel(got.cpu(), want)
        del ref, weights
        net.cast("bfloat16")
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.01, "momentum": 0.9,
                                 "multi_precision": True})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        xb = nd.array(rng.standard_normal((ZOO_BATCH, 3, hw, hw),
                                          dtype=np.float32), ctx=gpu(0),
                      dtype="bfloat16")
        yb = nd.array(rng.integers(0, 1000, ZOO_BATCH).astype(np.float32),
                      ctx=gpu(0))
        losses, ms = [], []
        for _ in range(ZOO_STEPS):
            t0 = time.perf_counter()
            with autograd.record():
                loss = loss_fn(net(xb), yb)
            loss.backward()
            trainer.step(ZOO_BATCH)
            losses.append(float(loss.mean().asscalar()))
            ms.append((time.perf_counter() - t0) * 1e3)
        step = float(np.median(ms[1:]))
        rows.append({"name": name, "hw": hw, "rel": rel, "losses": losses,
                     "step_ms": step, "img_s": ZOO_BATCH / step * 1e3})
        print(f"{name} ({hw} x {hw}): f32 forward at batch 2 card vs CPU "
              f"{rel:.3g} relative (tol {ZOO_RTOL}); bf16 SGD at batch "
              f"{ZOO_BATCH}: losses {', '.join(f'{v:.4f}' for v in losses)}"
              f", step {step:.2f} ms (median of steps 2-{ZOO_STEPS}), "
              f"{ZOO_BATCH / step * 1e3:.1f} img/s on {smi}")
        del net, trainer, xb, got
        torch.cuda.empty_cache()
    bad = [r["name"] for r in rows if not (r["rel"] <= ZOO_RTOL and all(
        math.isfinite(v) for v in r["losses"]))]
    if bad:
        raise SystemExit(f"FAIL: the zoo at full width: {bad}")
    return rows


class _SquareProp(operator.CustomOpProp):
    """``phase_square``: y = x * x, dx = 2 x dy, through nd on the body's
    context."""

    def create_operator(self, ctx, shapes, dtypes):
        class _Square(operator.CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                self.assign(out_data[0], req[0], in_data[0] * in_data[0])

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                self.assign(in_grad[0], req[0],
                            2 * in_data[0] * out_grad[0])
        return _Square()


class _SquareNet(gluon.HybridBlock):
    """Dense, then the square (``phase_square`` or ``x * x`` in nd), then
    Dense."""

    def __init__(self, custom, **kwargs):
        super().__init__(**kwargs)
        self.custom = custom
        with self.name_scope():
            self.fc1 = nn.Dense(64, in_units=256)
            self.fc2 = nn.Dense(10, in_units=64)

    def hybrid_forward(self, F, x):
        h = self.fc1(x)
        h = F.Custom(h, op_type="phase_square") if self.custom else h * h
        return self.fc2(h)


def _train_square_net(custom, named, x, y):
    net = _SquareNet(custom)
    load_jax_params(net, named, ctx=gpu(0))
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.01})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(3):
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(loss.data.detach().clone())
    return torch.stack(losses), {k: p.data().data.clone() for k, p in
                                 net._collect_params_with_prefix().items()}


def build_ext_library():
    """The test's external op library (tests/torch_ext_ops.cc) built by
    g++ into build/phase_custom/."""
    CUSTOM_DIR.mkdir(parents=True, exist_ok=True)
    so = CUSTOM_DIR / "libportextops.so"
    r = subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-o", str(so),
                        str(EXT_SOURCE)], capture_output=True, text=True,
                       timeout=300)
    if r.returncode:
        raise SystemExit(f"FAIL: g++ did not build {EXT_SOURCE}: "
                         f"{r.stderr[-2000:]}")
    return so


def custom_ops(seed: int, smi: str):
    """Phase 14(c): a Python CustomOp on card tensors against the same
    arithmetic in nd, the op inside a Gluon block trained by Trainer, and
    an external library's ops on card inputs."""
    operator.register("phase_square")(_SquareProp)
    rng = np.random.default_rng(seed + 41)
    x0 = rng.standard_normal(CUSTOM_SHAPE, dtype=np.float32)
    dy0 = rng.standard_normal(CUSTOM_SHAPE, dtype=np.float32)
    grads, outs = [], []
    for custom in (True, False):
        x = nd.array(x0, ctx=gpu(0))
        x.attach_grad()
        with autograd.record():
            y = nd.Custom(x, op_type="phase_square") if custom else x * x
        y.backward(nd.array(dy0, ctx=gpu(0)))
        outs.append(y.data)
        grads.append(x.grad.data)
    op_equal = torch.equal(outs[0], outs[1]) and \
        torch.equal(grads[0], grads[1]) and outs[0].is_cuda
    x = nd.array(x0, ctx=gpu(0))
    host = {}
    for name, fn in (("Custom", lambda: nd.Custom(x, op_type="phase_square")),
                     ("nd", lambda: x * x)):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(CUSTOM_HOST_CALLS):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        host[name] = float(np.median(times))
    # the op in a Gluon block, three Trainer steps, against x * x in nd
    with cpu():
        probe = _SquareNet(True)
        probe.initialize(init.Xavier())
        named = {k: p.data().data for k, p in
                 probe._collect_params_with_prefix().items()}
    xb = nd.array(rng.standard_normal((64, 256), dtype=np.float32),
                  ctx=gpu(0))
    yb = nd.array(rng.integers(0, 10, 64).astype(np.float32), ctx=gpu(0))
    l_custom, p_custom = _train_square_net(True, named, xb, yb)
    l_plain, p_plain = _train_square_net(False, named, xb, yb)
    block_equal = torch.equal(l_custom, l_plain) and all(
        torch.equal(p_custom[k], p_plain[k]) for k in p_plain) and \
        bool(torch.isfinite(l_custom).all())
    # the external library
    so = build_ext_library()
    library.load(str(so), verbose=False)
    a0 = rng.standard_normal(CUSTOM_LIB_SHAPE, dtype=np.float32)
    b0 = rng.standard_normal(CUSTOM_LIB_SHAPE, dtype=np.float32)
    a = nd.array(a0, ctx=gpu(0))
    a.attach_grad()
    with autograd.record():
        sq = nd.Custom(a, op_type="port_ext_square")
    sq.backward(nd.array(dy0[:CUSTOM_LIB_SHAPE[0], :CUSTOM_LIB_SHAPE[1]],
                         ctx=gpu(0)))
    am = nd.Custom(a, nd.array(b0, ctx=gpu(0)), op_type="port_ext_addmul")
    dev = a.data.device
    at = torch.from_numpy(a0).to(dev)
    dyt = torch.from_numpy(dy0[:CUSTOM_LIB_SHAPE[0], :CUSTOM_LIB_SHAPE[1]]
                           ).to(dev)
    lib_equal = sq.data.is_cuda and a.grad.data.is_cuda and \
        torch.equal(sq.data, at * at) and \
        torch.equal(a.grad.data, 2 * at * dyt) and \
        torch.equal(am.data, at + 2 * torch.from_numpy(b0).to(dev))
    shutil.rmtree(CUSTOM_DIR, ignore_errors=True)
    print(f"Custom op phase_square at {CUSTOM_SHAPE} f32 on the card: value"
          f" and gradient bitwise equal to x * x in nd {op_equal}; host time"
          f" a call {host['Custom']:.1f} us (its body runs in Python) vs "
          f"{host['nd']:.1f} us for x * x; in a Gluon block, three Trainer "
          f"steps equal to the nd block's bitwise {block_equal}; external "
          f"library (g++ from {EXT_SOURCE.relative_to(EXT_SOURCE.parents[1])}"
          f") ops port_ext_square (forward, backward) and port_ext_addmul at "
          f"{CUSTOM_LIB_SHAPE} on card inputs bitwise equal to torch "
          f"{lib_equal} on {smi}")
    if not (op_equal and block_equal and lib_equal):
        raise SystemExit("FAIL: the custom ops or the external library")
    return {"custom_host_us": host["Custom"], "nd_host_us": host["nd"]}


def contrib_layers(seed: int, smi: str):
    """Phase 14(d): the contrib layers on the card against their CPU
    forward from the same weights (f32, 1e-4 x max(1, |value|))."""
    rng = np.random.default_rng(seed + 51)

    def lstmp():
        return crnn.LSTMPCell(256, 64, input_size=32)

    def vdrop():
        return crnn.VariationalDropoutCell(rnn.LSTMCell(128, input_size=32),
                                           drop_inputs=0.3, drop_states=0.3,
                                           drop_outputs=0.3)
    cases = [
        ("DeformableConvolution", lambda: ccnn.DeformableConvolution(
            32, kernel_size=3, padding=1, in_channels=16), (8, 16, 28, 28),
         False),
        ("PixelShuffle2D", lambda: cnn.PixelShuffle2D(2), (8, 64, 32, 32),
         False),
        ("BatchNormReLU", lambda: cnn.BatchNormReLU(in_channels=64),
         (8, 64, 32, 32), True),
        ("LSTMPCell", lstmp, (16, 10, 32), False),
        ("VariationalDropoutCell", vdrop, (16, 10, 32), False)]
    worst, report = 0.0, []
    for name, make, shape, train in cases:
        x = rng.standard_normal(shape, dtype=np.float32)
        outs = []
        for ctx in (cpu(), gpu(0)):
            random.seed(seed)
            with ctx:
                layer = make()
                layer.initialize(init.Xavier())
                if name == "DeformableConvolution":   # off the zero offset
                    layer.offset_weight.set_data(nd.array(
                        0.05 * np.random.default_rng(seed).standard_normal(
                            layer.offset_weight.shape, dtype=np.float32)))
                if ctx == cpu():
                    named = {k: p.data().data for k, p in
                             layer._collect_params_with_prefix().items()
                             if p._var is not None}
                else:
                    load_jax_params(layer, named, ctx=gpu(0))
                xs = nd.array(x)
                if name in ("LSTMPCell", "VariationalDropoutCell"):
                    out = layer.unroll(shape[1], xs, merge_outputs=True)[0]
                elif train:
                    with autograd.record():
                        out = layer(xs)
                else:
                    out = layer(xs)
                outs.append(out.data.detach().cpu())
        err = float((outs[1] - outs[0]).abs().max()
                    / max(1.0, outs[0].abs().max().item()))
        worst = max(worst, err)
        report.append(f"{name} {tuple(shape)} {err:.3g}")
    # the locked mask on the card: one mask for all steps
    with gpu(0):
        cell = vdrop()
        cell.initialize(init.Xavier())
        with autograd.record():
            cell.unroll(6, nd.ones((4, 6, 32)), merge_outputs=True)
        mask = cell._input_mask
    values = mask.unique()
    locked = mask.is_cuda and len(values) == 2 and values[0] == 0 and \
        abs(values[1].item() - 1 / 0.7) < 1e-6
    print(f"contrib layers, card vs CPU (max |d| / max(1, |CPU|), tol "
          f"{CONTRIB_TOL}): {'; '.join(report)}; VariationalDropoutCell's "
          f"locked mask on the card {locked} on {smi}")
    if not (worst <= CONTRIB_TOL and locked):
        raise SystemExit("FAIL: a contrib layer on the card disagrees with "
                         "the CPU")


def phase_utilities(seed: int, smi: str, resnet: dict, data: dict):
    """Phase 14: (a) the Estimator path, (b) the zoo at full width, (c)
    custom ops and an external library, (d) the contrib layers; the
    ``Custom`` op case runs in phase 9(a)."""
    est = estimator_path(seed, smi, resnet, data)
    zoo = zoo_full_width(seed, smi)
    custom = custom_ops(seed, smi)
    contrib_layers(seed, smi)
    return dict(est, zoo=zoo, **custom)


# ---------------------------------------------------------------------------
# phase 15: int8 serving (ResNet-50, BERT-base), the kvstore Trainer, the
# int8 product alone
# ---------------------------------------------------------------------------
def _quantized_blocks(net):
    return [b for b in net.modules()
            if isinstance(b, (qz.QuantizedDense, qz.QuantizedConv2D))]


def _zero_counters():
    fa.launches = fa.launches_dq = fa.launches_dkv = fc.launches = 0
    rtc.launches = 0


def _read_counters():
    return {"K1": fa.launches, "K2": fa.launches_dq, "K3": fa.launches_dkv,
            "K4": fc.launches, "K5": rtc.launches}


def serve_closed_loop(ep, make_request, clients, per_client, seed):
    """``clients`` threads, each sending ``per_client`` requests from
    ``make_request(rng)`` through an InferenceServer over ``ep``: returns
    (responses as (inputs, outputs), wall s, the endpoint's snapshot)."""
    server = serving.InferenceServer(batch_timeout_ms=2.0, max_queue=512)
    server.register(ep)
    server.start()
    results = [[] for _ in range(clients)]
    errors = []

    def client(i):
        rng = np.random.default_rng(seed * 1000 + i)
        try:
            for _ in range(per_client):
                inputs = make_request(rng)
                results[i].append((inputs, server.predict(
                    ep.name, inputs, timeout=300)))
        except Exception as e:        # surfaced below; the phase fails
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    server.stop(drain=True)
    if errors or any(t.is_alive() for t in threads):
        raise SystemExit(f"FAIL: client errors {errors[:3]}")
    return [r for rs in results for r in rs], wall, ep.stats.snapshot()


def _served_vs_direct(net, responses):
    """max over the responses of |served - direct| - (1e-5 + 1e-5 |direct|)
    (<= 0 passes), the direct forward on the same rows."""
    worst = -1.0
    with torch.inference_mode():
        for inputs, outs in responses:
            inputs = inputs if isinstance(inputs, tuple) else (inputs,)
            direct = net(*(torch.from_numpy(a).cuda() for a in inputs))
            direct = direct if isinstance(direct, (tuple, list)) \
                else (direct,)
            outs = outs if isinstance(outs, (tuple, list)) else (outs,)
            for a, b in zip(outs, direct):
                if a.device.type != "cuda" or not torch.isfinite(a).all():
                    raise SystemExit("FAIL: a response is off the card or "
                                     "not finite")
                worst = max(worst, ((a - b).abs() - (QUANT_SERVE_TOL + (
                    QUANT_SERVE_TOL * b.abs()))).max().item())
    return worst


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "i8" in n or "s8" in n or "imma" in n or "int8" in n:
        return "int8 GEMM"
    if "conv" in n or "fprop" in n or "cudnn" in n or "winograd" in n:
        return "cuDNN convolution"
    if "gemm" in n or "cutlass" in n or "xmma" in n:
        return "float GEMM"
    if "copy" in n or "cat" in n or "fill" in n:
        return "copy / fill"
    if "reduce" in n:
        return "reduction"
    return "elementwise and other"


def forward_profile(fn):
    """One ``fn()`` under torch.profiler: (host op counts by name, device
    ms, device ms by kernel class, the top kernels as (name, ms))."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops, classes, kernels = {}, {}, []
    int_mm_ms = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            if e.self_device_time_total > 0:
                ms = e.self_device_time_total / 1e3
                kernels.append((e.key, ms))
                c = _kernel_class(e.key)
                classes[c] = classes.get(c, 0.0) + ms
        else:
            ops[e.key] = ops.get(e.key, 0) + e.count
            if e.key == "aten::_int_mm":
                int_mm_ms += e.device_time_total / 1e3
    kernels.sort(key=lambda k: -k[1])
    return ops, sum(classes.values()), classes, kernels[:5], int_mm_ms


def _print_profile(what, prof):
    ops, device_ms, classes, top, _ = prof
    print(f"  {what}: device {device_ms:.3f} ms a forward; by "
          "class " + ", ".join(f"{c} {ms:.3f}" for c, ms in sorted(
              classes.items(), key=lambda kv: -kv[1])) + "; top kernels "
          + "; ".join(f"{n[:70]} {ms:.3f}" for n, ms in top))


def _accumulators(layer, x):
    """The int32 accumulators of the quantized ``layer`` on input ``x``
    (its calibrated range, its weight's own), with the input codes."""
    xq, xmn, xmx = qops.quantize_v2(x, min_calib_range=-layer._amax,
                                    max_calib_range=layer._amax)
    wq, wmn, wmx = qops.quantize_v2(layer._t("weight").detach())
    return xq, wq, (xmn, xmx, wmn, wmx)


def _layer_accumulators_card_vs_cpu(qnet, inputs, picks):
    """For each (label, layer): capture the layer's input on the card,
    quantize it there, and compute the int32 accumulators on the card and
    on the CPU from the same codes: bitwise equal?"""
    seen = {}
    hooks = []
    for label, layer in picks:
        def grab(block, args, label=label):
            seen[label] = args[0].detach()
        hooks.append((layer, layer.register_forward_pre_hook(grab)))
    with torch.inference_mode():
        qnet(*inputs)
    for layer, h in hooks:
        layer._gluon_pre_hooks.remove(h)
    out = {}
    for label, layer in picks:
        xq, wq, ranges = _accumulators(layer, seen[label])
        if isinstance(layer, qz.QuantizedConv2D):
            kw = layer._conv_kwargs
            args = dict(kernel=kw["kernel"], stride=kw["stride"],
                        dilate=kw["dilate"], pad=kw["pad"],
                        num_group=kw["num_group"])
            prod = qops.quantized_conv
        else:
            args = dict(flatten=layer._flatten)
            prod = qops.quantized_fully_connected
        card = prod(xq, wq, *ranges, **args)[0]
        host = prod(xq.cpu(), wq.cpu(), *(r.cpu() for r in ranges),
                    **args)[0]
        out[label] = (tuple(card.shape), bool(torch.equal(card.cpu(), host)))
    return out


def card_vs_cpu_int8(qnet, host, host_f32, inputs, what):
    """Hold an int8 net on the card to the CPU port's (``host``: the same
    ranges, ``quantized_like``) on the same ``inputs``, layer by layer
    (``tools/int8_drift.compare``):

    1. each quantized layer, run on the CPU on the card's input to it,
       gives the card layer's output within QUANT_OWN_ULPS ulps of its
       largest output (bitwise but for a transcendental activation);
    2. with every quantized layer's output pinned to the card's, the
       CPU's float path (K1's plain version, LayerNorm, BatchNorm, GELU,
       the residuals) gives every layer input and the outputs within
       QUANT_PINNED_TOL of the card's, of the largest value;
    3. run freely, the outputs differ where an f32 rounding difference
       flipped an input code and later layers carried the flip on; that
       distance stays below half the int8 net's own error (vs
       ``host_f32`` on the CPU)."""
    c = int8_drift.compare(qnet, host, host_f32, inputs,
                           tuple(x.cpu() for x in inputs))
    first = "none" if c["first_flip"] is None else (
        f"{c['first_flip']} (its input {c['first_flip_input_rel']:.3g})")
    print(f"  {what} card vs CPU port, layer by layer: {c['own_bitwise']} "
          f"of {len(c['layers'])} quantized layers bitwise on the card's "
          f"input, the largest own error {c['own_ulps']:.3g} ulps of the "
          f"layer's largest output (tol {QUANT_OWN_ULPS}); quantized outputs"
          f" pinned to the card's: layer inputs {c['pinned_inputs_rel']:.3g}"
          f", outputs {c['pinned_outputs_rel']:.3g} of the largest value "
          f"(tol {QUANT_PINNED_TOL:g}); free-running: first code flip "
          f"{first}, {c['codes_differing']} of {c['codes']} codes differ, "
          f"outputs {c['free_running_rel']:.3g} of the largest (tol half "
          f"the int8 net's own error vs f32 on the CPU, "
          f"{c['int8_vs_f32_rel']:.3g})")
    if not (c["own_ulps"] <= QUANT_OWN_ULPS
            and c["pinned_inputs_rel"] <= QUANT_PINNED_TOL
            and c["pinned_outputs_rel"] <= QUANT_PINNED_TOL
            and c["free_running_rel"] < c["int8_vs_f32_rel"] / 2):
        raise SystemExit(f"FAIL: int8 {what} differs card vs CPU")
    return {k: c[k] for k in ("own_ulps", "own_bitwise", "pinned_inputs_rel",
                              "pinned_outputs_rel", "first_flip",
                              "codes_differing", "codes", "free_running_rel",
                              "int8_vs_f32_rel")}


def int8_resnet(seed: int, smi: str):
    """Phase 15(a): ResNet-50 v1 calibrated (naive) and served in int8
    beside the f32 net."""
    named = seeded_resnet_weights(resnet50_v1(classes=1000), seed)
    nets = {}
    for kind in ("f32", "int8"):
        nets[kind] = resnet50_v1(classes=1000)
        load_jax_params(nets[kind], named, ctx=gpu(0))
    rng = np.random.default_rng(seed + 15)
    calib = [nd.array(resnet_batch(rng, 1, QUANT_CALIB_BATCH)[0][0],
                      ctx=gpu(0)) for _ in range(QUANT_CALIB_BATCHES)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qnet = qz.quantize_net(nets["int8"], calib_data=calib,
                           calib_mode="naive")
    calib_s = time.perf_counter() - t0
    blocks = _quantized_blocks(qnet)
    convs = sum(isinstance(b, qz.QuantizedConv2D) for b in blocks)
    denses = len(blocks) - convs
    print(f"15(a) resnet50_v1 f32 calibrated on {QUANT_CALIB_BATCHES} "
          f"batches of {QUANT_CALIB_BATCH} x 3 x 224 x 224 (naive) in "
          f"{calib_s:.2f} s: {convs} Conv2D and {denses} Dense converted")
    if (convs, denses) != (RESNET_CONVS, 1):
        raise SystemExit("FAIL: quantize_net did not convert ResNet-50's 53 "
                         "convolutions and its Dense")

    def request(rng):
        rows = int(rng.integers(1, QUANT_MAX_ROWS + 1))
        return rng.random((rows, 3, 224, 224), dtype=np.float32)

    served = {}
    for kind in ("f32", "int8"):
        ep = serving.ModelEndpoint(f"resnet_{kind}", nets[kind],
                                   [(3, 224, 224)], dtype="float32",
                                   max_batch_size=QUANT_BUCKET)
        # ---- the main path: counts from 0 just before, read just after
        _zero_counters()
        responses, wall, snap = serve_closed_loop(
            ep, request, N_CLIENTS, QUANT_REQS // N_CLIENTS, seed + 16)
        hand = _read_counters()
        # ---- end of the main path ----
        rows = sum(r[0].shape[0] for r in responses)
        lat = snap["latency"]
        served[kind] = {"ep": ep, "responses": responses, "hand": hand,
                        "req_s": len(responses) / wall,
                        "img_s": rows / wall, "p50_ms": lat["p50_us"] / 1e3,
                        "p99_ms": lat["p99_us"] / 1e3,
                        "batches": snap["counters"]["batches"]}
        print(f"  served resnet50_v1 {kind}, {N_CLIENTS} closed-loop "
              f"clients, {len(responses)} requests of 1-{QUANT_MAX_ROWS} "
              f"images ({rows}) in {snap['counters']['batches']} batches: "
              f"{len(responses) / wall:.2f} requests/s, {rows / wall:.1f} "
              f"img/s, p50 {lat['p50_us'] / 1e3:.2f} ms, p99 "
              f"{lat['p99_us'] / 1e3:.2f} ms on {smi}; hand-written kernel "
              f"launches {hand}")
        if len(responses) != QUANT_REQS or any(hand.values()):
            raise SystemExit("FAIL: not every request was served, or a "
                             "hand-written kernel ran on a ResNet path")
    # check 1: served = direct forward
    worst = _served_vs_direct(qnet, served["int8"]["responses"])
    worst32 = _served_vs_direct(nets["f32"], served["f32"]["responses"])
    print(f"  int8 served vs its direct forward: max(|d| - tol) {worst:.3g}"
          f" (tol 1e-5 + 1e-5 |direct|; pass if <= 0); f32 served vs direct"
          f" (reported): {worst32:.3g}")
    if worst > 0:
        raise SystemExit("FAIL: an int8 response differs from the direct "
                         "forward")
    # device ms of a bucket-32 forward, by kernel class; check 4
    batch = torch.from_numpy(resnet_batch(rng, 1, QUANT_BUCKET)[0][0]).cuda()
    profs = {}
    for kind in ("f32", "int8"):
        net = served[kind]["ep"].block
        with torch.inference_mode():
            net(batch)
            profs[kind] = forward_profile(lambda: net(batch))
        _print_profile(f"resnet50_v1 {kind} (bucket {QUANT_BUCKET})",
                       profs[kind])
    ops8 = profs["int8"][0]
    conv_ops = {k: v for k, v in ops8.items() if "conv" in k.lower()}
    int_mm = ops8.get("aten::_int_mm", 0)
    int_mm_ms = profs["int8"][4]
    print(f"  int8 forward's host ops: aten::_int_mm {int_mm} (expected "
          f"{RESNET_CONVS + 1}) with {int_mm_ms:.3f} ms of kernels under "
          f"them, convolution ops {conv_ops or 0}; f32 forward's "
          f"convolution ops {profs['f32'][0].get('aten::convolution', 0)}")
    if int_mm != RESNET_CONVS + 1 or conv_ops or not int_mm_ms > 0:
        raise SystemExit("FAIL: the int8 forward ran a library convolution "
                         "or missed an int8 GEMM")
    # check 2: three layers' accumulators, card vs CPU, same codes
    # features.6 is the third stage (stem conv, BatchNorm, ReLU, pool, ...)
    stage3 = next(b for path, b in qnet.named_modules()
                  if path.startswith("features.6.")
                  and isinstance(b, qz.QuantizedConv2D)
                  and b._conv_kwargs["kernel"] == (3, 3))
    picks = [("conv1", blocks[0]), ("stage3 3x3", stage3),
             ("dense", blocks[-1])]
    acc = _layer_accumulators_card_vs_cpu(qnet, (batch[:2],), picks)
    print("  int32 accumulators card vs CPU on the same codes (batch 2): "
          + ", ".join(f"{k} {s} {'bitwise' if eq else 'DIFFER'}"
                      for k, (s, eq) in acc.items()))
    if not all(eq for _, eq in acc.values()):
        raise SystemExit("FAIL: int8 accumulators differ card vs CPU")
    # check 3: logits card vs the CPU port's, same images and ranges
    host, host32 = resnet50_v1(classes=1000), resnet50_v1(classes=1000)
    for h in (host, host32):
        load_jax_params(h, named, ctx=cpu())
    int8_drift.quantized_like(host, qnet).eval()
    cmp = card_vs_cpu_int8(qnet, host, host32.eval(),
                           (batch[:QUANT_CPU_ROWS],),
                           f"logits of {QUANT_CPU_ROWS} images")
    del host, host32
    # top-1 agreement with f32 (a report: random weights)
    agree = 0
    with torch.inference_mode():
        for _ in range(QUANT_AGREE_IMAGES // QUANT_BUCKET):
            xb = torch.from_numpy(resnet_batch(rng, 1, QUANT_BUCKET)[0][0]
                                  ).cuda()
            agree += (nets["f32"](xb).argmax(1) == qnet(xb).argmax(1)
                      ).sum().item()
    print(f"  top-1 agreement int8 vs f32 on {QUANT_AGREE_IMAGES} seeded "
          f"images: {agree / QUANT_AGREE_IMAGES:.3f} (random weights: a "
          "report, not a gate)")
    out = {k: {m: v[m] for m in ("req_s", "img_s", "p50_ms", "p99_ms",
                                 "hand")} for k, v in served.items()}
    for kind in out:
        out[kind]["device_ms"] = profs[kind][1]
    del nets, qnet, served, calib
    torch.cuda.empty_cache()
    return dict(out, calib_s=calib_s, agree=agree / QUANT_AGREE_IMAGES,
                card_vs_cpu=cmp)


def int8_bert(seed: int, smi: str):
    """Phase 15(b): BERT-base calibrated (naive) and served in int8; K1 in
    f32 in each of its 12 layers."""
    net = bert_base()
    named = seeded_bert_weights(net, seed)
    load_jax_params(net, named)
    layers = len(net.encoder._layers)
    rng = np.random.default_rng(seed + 17)

    def tokens(rows, seq=QUANT_SEQ):
        return (rng.integers(0, 30522, (rows, seq), dtype=np.int32),
                rng.integers(0, 2, (rows, seq), dtype=np.int32))
    calib = [tuple(nd.array(a, ctx=gpu(0), dtype="int32")
                   for a in tokens(QUANT_BERT_BUCKET))
             for _ in range(QUANT_CALIB_BATCHES)]
    qnet = qz.quantize_net(net, calib_data=calib, calib_mode="naive")
    blocks = _quantized_blocks(qnet)
    print(f"15(b) bert_base f32 calibrated on {QUANT_CALIB_BATCHES} batches "
          f"of {QUANT_BERT_BUCKET} x {QUANT_SEQ} (naive): {len(blocks)} "
          "Dense converted")
    if len(blocks) != 4 * layers + 1 or not all(
            isinstance(b, qz.QuantizedDense) for b in blocks):
        raise SystemExit("FAIL: quantize_net did not convert BERT-base's 49 "
                         "Dense layers")

    def request(r):
        rows = int(r.integers(1, QUANT_BERT_BUCKET + 1))
        return (r.integers(0, 30522, (rows, QUANT_SEQ), dtype=np.int32),
                r.integers(0, 2, (rows, QUANT_SEQ), dtype=np.int32))

    # ---- the main path: counts from 0 just before, read just after ----
    _zero_counters()
    ep = serving.ModelEndpoint("bert_int8", qnet,
                               [(QUANT_SEQ,), (QUANT_SEQ,)], dtype="int32",
                               max_batch_size=QUANT_BERT_BUCKET)
    responses, wall, snap = serve_closed_loop(
        ep, request, N_CLIENTS, QUANT_BERT_REQS // N_CLIENTS, seed + 18)
    hand = _read_counters()
    # ---- end of the main path ----
    c = snap["counters"]
    executed = c["batches"] + c["warmup_batches"]
    rows = sum(r[0][0].shape[0] for r in responses)
    lat = snap["latency"]
    print(f"  served {len(responses)} requests ({rows} rows of {QUANT_SEQ} "
          f"tokens) in {c['batches']} batches + {c['warmup_batches']} "
          f"probe/warm-up runs: {len(responses) / wall:.2f} requests/s, "
          f"{rows * QUANT_SEQ / wall:.0f} tokens/s, p50 "
          f"{lat['p50_us'] / 1e3:.2f} ms, p99 {lat['p99_us'] / 1e3:.2f} ms "
          f"on {smi}; launches {hand} (K1 expected {layers} x {executed} = "
          f"{layers * executed})")
    if len(responses) != QUANT_BERT_REQS or hand["K1"] != layers * executed \
            or any(v for k, v in hand.items() if k != "K1"):
        raise SystemExit("FAIL: a request was lost, or K1 did not run in "
                         "every layer of every forward")
    worst = _served_vs_direct(qnet, responses)
    print(f"  served vs direct forward: max(|d| - tol) {worst:.3g} (tol "
          "1e-5 + 1e-5 |direct|; pass if <= 0)")
    if worst > 0:
        raise SystemExit("FAIL: an int8 BERT response differs from the "
                         "direct forward")
    # which dtype K1 gets: a spy around its wrapper for one forward
    dtypes = []
    kernel = fa.flash_attention_fwd

    def spy(q, *args, **kw):
        dtypes.append(q.dtype)
        return kernel(q, *args, **kw)
    tok = tokens(1, QUANT_CPU_SEQ)
    fa.flash_attention_fwd = spy
    try:
        with torch.inference_mode():
            qnet(*(torch.from_numpy(a).cuda() for a in tok))
    finally:
        fa.flash_attention_fwd = kernel
    print(f"  K1 in one int8 forward: {len(dtypes)} calls, dtypes "
          f"{sorted(set(str(d) for d in dtypes))}")
    if len(dtypes) != layers or any(d != torch.float32 for d in dtypes):
        raise SystemExit("FAIL: the int8 BERT's attention did not run K1 in "
                         "f32 in every layer")
    enc = qnet.encoder._layers
    picks = [("layer0 qkv", enc[0].attention.qkv),
             (f"layer{layers - 1} ffn2", enc[-1].ffn.ffn2),
             ("pooler", qnet.pooler)]
    acc = _layer_accumulators_card_vs_cpu(
        qnet, tuple(torch.from_numpy(a).cuda() for a in tok), picks)
    print(f"  int32 accumulators card vs CPU on the same codes (1 x "
          f"{QUANT_CPU_SEQ}): " + ", ".join(
              f"{k} {s} {'bitwise' if eq else 'DIFFER'}"
              for k, (s, eq) in acc.items()))
    if not all(eq for _, eq in acc.values()):
        raise SystemExit("FAIL: int8 BERT accumulators differ card vs CPU")
    host, host32 = bert_base(), bert_base()
    for h in (host, host32):
        load_jax_params(h, named, ctx=cpu())
    int8_drift.quantized_like(host, qnet).eval()
    cmp = card_vs_cpu_int8(
        qnet, host, host32.eval(),
        tuple(torch.from_numpy(a).cuda() for a in tok),
        f"BERT-base (1 row of {QUANT_CPU_SEQ} tokens; K1 f32 on the card, "
        "the plain attention on the CPU)")
    with torch.inference_mode():
        xb = tuple(torch.from_numpy(a).cuda() for a in tokens(
            QUANT_BERT_BUCKET))
        qnet(*xb)
        prof = forward_profile(lambda: qnet(*xb))
    _print_profile(f"bert_base int8 (bucket {QUANT_BERT_BUCKET} x "
                   f"{QUANT_SEQ})", prof)
    del net, qnet, host, host32, ep, responses
    torch.cuda.empty_cache()
    return {"launches": hand["K1"], "hand": hand, "card_vs_cpu": cmp,
            "device_ms": prof[1],
            "req_s": c["completed"] / wall,
            "tokens_s": rows * QUANT_SEQ / wall,
            "p50_ms": lat["p50_us"] / 1e3, "p99_ms": lat["p99_us"] / 1e3}


def kvstore_resnet(seed: int, smi: str, resnet: dict, util: dict):
    """Phase 15(c): ResNet-50 through ``gluon.Trainer(kvstore="device",
    update_on_kvstore=True)``, without and with 2-bit compression; the
    kvstore route bitwise the local one on the same gradients; 2-bit and
    1-bit packing card vs CPU."""
    named = seeded_resnet_weights(resnet50_v1(classes=1000), seed)
    net = resnet50_v1(classes=1000)
    load_jax_params(net, named, ctx=gpu(0))
    net.cast("bfloat16")
    rng = np.random.default_rng(seed + 19)
    xs, ys = resnet_batch(rng, 1, RESNET_BATCH)
    x = nd.array(xs[0], ctx=gpu(0)).astype("bfloat16")
    y = nd.array(ys[0], ctx=gpu(0))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    opt = {"learning_rate": 0.05, "momentum": 0.9, "multi_precision": True}
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]

    def backward():
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        return loss

    # check 1: both update routes from the same gradients
    backward()
    start = [p.data()._data.clone() for p in params]
    leaves = torch.utils._pytree.tree_leaves
    routes = {}
    for route, kw in (("local", {}), ("kvstore", {"update_on_kvstore":
                                                  True})):
        with torch.no_grad():
            for p, w in zip(params, start):
                p.data()._data.copy_(w)
        tr = gluon.Trainer(net.collect_params(), "sgd", dict(opt),
                           kvstore="device", **kw)
        tr.step(RESNET_BATCH)
        states = tr._kvstore._updater.states if kw else tr._updaters.states
        routes[route] = ([p.data()._data.clone() for p in params],
                         [t.clone() for i in sorted(states)
                          for t in leaves(states[i])])
    same_w = all(torch.equal(a, b) for a, b in zip(routes["local"][0],
                                                   routes["kvstore"][0]))
    same_s = len(routes["local"][1]) == len(routes["kvstore"][1]) and all(
        torch.equal(a, b) for a, b in zip(routes["local"][1],
                                          routes["kvstore"][1]))
    print(f"15(c) one SGD step from the same gradients, local vs "
          f"update_on_kvstore: {len(params)} weights "
          f"{'bitwise' if same_w else 'DIFFER'}, "
          f"{len(routes['local'][1])} f32 masters and momenta "
          f"{'bitwise' if same_s else 'DIFFER'}")
    # check 2: the packing, card vs CPU, two pushes each (residuals fed back)
    packing = {}
    for kind in ("2bit", "1bit"):
        card_c = kvstore.GradientCompression(kind, 0.5)
        host_c = kvstore.GradientCompression(kind, 0.5)
        ok = True
        for _ in range(2):
            for i, p in enumerate(params):
                g = p.grad()._data
                pk, sc = card_c.quantize(i, g)
                hpk, hsc = host_c.quantize(i, g.cpu())
                ok &= bool(torch.equal(pk.cpu(), hpk)) and bool(
                    torch.equal(sc.cpu(), hsc)) and bool(torch.equal(
                        card_c._residuals[i].cpu(), host_c._residuals[i]))
        packing[kind] = ok
    print("  packed bytes, scales and residuals card vs CPU over "
          f"{len(params)} gradients, two pushes: " + ", ".join(
              f"{k} {'bitwise' if v else 'DIFFER'}"
              for k, v in packing.items()))
    del routes, start
    if not (same_w and same_s and all(packing.values())):
        raise SystemExit("FAIL: the kvstore route or the gradient packing "
                         "differs")
    out = {}
    for label, comp in (("device", None),
                        ("device_2bit", {"type": "2bit",
                                         "threshold": 0.5})):
        load_jax_params(net, named)        # each run from the seeded weights
        tr = gluon.Trainer(net.collect_params(), "sgd", dict(opt),
                           kvstore="device", update_on_kvstore=True,
                           compression_params=comp)

        def step():
            loss = backward()
            tr.step(RESNET_BATCH)
            return loss
        torch.cuda.synchronize()
        # ---- the main path: counts from 0 just before, read just after
        _zero_counters()
        losses, step_ms = [], []
        for _ in range(KV_STEPS):
            t1 = time.perf_counter()
            losses.append(step().mean().asscalar())
            step_ms.append((time.perf_counter() - t1) * 1e3)
        hand = _read_counters()
        # ---- end of the main path ----
        median = float(np.median(step_ms))
        device_ms, busy = busy_share(step, median)
        out[label] = {"step_ms": median, "device_ms": device_ms,
                      "busy_share": busy, "hand": hand,
                      "img_s": RESNET_BATCH / median * 1e3}
        print(f"  {KV_STEPS} steps, kvstore 'device', update_on_kvstore, "
              f"compression {comp}: losses {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, step median {median:.2f} ms "
              f"({RESNET_BATCH / median * 1e3:.1f} img/s), device "
              f"{device_ms:.2f} ms, busy {busy:.3f}; hand-written kernel "
              f"launches {hand} on {smi}")
        if not np.isfinite(losses).all() or any(hand.values()):
            raise SystemExit("FAIL: a kvstore training loss is not finite, "
                             "or a hand-written kernel ran")
    print(f"  same run: phase 5's step {resnet['step_ms']:.2f} ms, phase "
          f"14's (Estimator) {util['step_ms']:.2f} ms")
    del net, params
    torch.cuda.empty_cache()
    return out


def int8_product_times(seed: int, smi: str):
    """Phase 15(d): the int8 product alone from CUDA graphs, beside bf16
    and the bounds."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    i8 = lambda *s: torch.randint(-127, 128, s, generator=g,  # noqa: E731
                                  device="cuda", dtype=torch.int8)
    bf = lambda *s: torch.randn(*s, generator=g, device="cuda",  # noqa: E731
                                dtype=torch.bfloat16)
    out = {}
    M, K, N = QUANT_MM_SHAPE
    a, w = i8(M, K), i8(N, K)
    ab, wb = bf(M, K), bf(K, N)
    want = qops.int8_matmul(a.cpu(), w.cpu())
    if not torch.equal(qops.int8_matmul(a, w).cpu(), want):
        raise SystemExit("FAIL: _int_mm differs from the CPU's int32 product")
    ops = 2 * M * K * N
    out["mm"] = {
        "shape": [M, K, N],
        "int8_ms": graph_ms(lambda: qops.int8_matmul(a, w)),
        "bf16_ms": graph_ms(lambda: torch.matmul(ab, wb)),
        "int8_bound": _bound(M * K + N * K + 4 * M * N, ops, torch.int8)[:2],
        "bf16_bound": _bound(2 * (M * K + K * N + M * N), ops,
                             torch.bfloat16)[:2]}
    B, C, H, O = QUANT_CONV_SHAPE
    x, wc = i8(B, C, H, H), i8(O, C, 3, 3)
    xb, wcb = bf(B, C, H, H), bf(O, C, 3, 3)
    conv = lambda: qops.int8_conv(x, wc, (1, 1), (1, 1), (1, 1))  # noqa: E731
    if not torch.equal(conv()[:2].cpu(), qops.int8_conv(
            x[:2].cpu(), wc.cpu(), (1, 1), (1, 1), (1, 1))):
        raise SystemExit("FAIL: the int8 convolution differs card vs CPU")
    xcl = torch.nn.functional.pad(x, (1, 1, 1, 1)).permute(0, 2, 3, 1) \
        .contiguous()
    rows, k = B * H * H, C * 9
    ops = 2 * rows * k * O
    out["conv"] = {
        "shape": [B, C, H, H, O, 3, 3],
        "int8_ms": graph_ms(conv),
        "im2col_ms": graph_ms(lambda: qops._im2col(xcl, (3, 3), (1, 1),
                                                   (1, 1))),
        "bf16_ms": graph_ms(lambda: torch.nn.functional.conv2d(
            xb, wcb, padding=1)),
        "int8_bound": _bound(x.numel() + wc.numel() + 4 * rows * O, ops,
                             torch.int8)[:2],
        "bf16_bound": _bound(2 * (xb.numel() + wcb.numel() + rows * O), ops,
                             torch.bfloat16)[:2]}
    for name, r in out.items():
        print(f"15(d) int8 {name} {r['shape']}: int8 route "
              f"{r['int8_ms']:.4f} ms (bound {r['int8_bound'][0]:.4f} ms by "
              f"{r['int8_bound'][1]} at 1,979 TOP/s and 3.35 TB/s; "
              f"{r['int8_bound'][0] / r['int8_ms']:.1%} of it), bf16 "
              f"{'cuDNN convolution' if name == 'conv' else 'torch.matmul'} "
              f"{r['bf16_ms']:.4f} ms (bound {r['bf16_bound'][0]:.4f} ms)"
              + (f"; im2col alone {r['im2col_ms']:.4f} ms"
                 if name == "conv" else "") + f", from CUDA graphs, on {smi}")
    return out


def phase_quantization(seed: int, smi: str, resnet: dict, util: dict):
    """Phase 15: (a) int8 ResNet-50 served, (b) int8 BERT-base served, (c)
    ResNet-50 through the kvstore Trainer, (d) the int8 product alone."""
    t0 = time.perf_counter()
    res = int8_resnet(seed, smi)
    bert = int8_bert(seed, smi)
    kv = kvstore_resnet(seed, smi, resnet, util)
    times = int8_product_times(seed, smi)
    print(f"phase 15: {time.perf_counter() - t0:.1f} s")
    return {"resnet": res, "bert": bert, "kvstore": kv, "times": times}


# ---------------------------------------------------------------------------
# phase 16: multi-process training (two ranks on the card, gloo)
# ---------------------------------------------------------------------------
DIST_DIR = Path(__file__).resolve().parent / "build" / "phase_dist"
KV_WORKER = Path(__file__).resolve().parent / "tests" / \
    "torch_dist_kvstore_worker.py"
DIST_STEPS = 5             # bf16 BERT-base steps of 16(b), (c)
DIST_F32 = dict(num_layers=2, steps=3, lr=0.01, tol=2e-5)
DIST_RESNET_STEPS = 3
DIST_TRAINER_STEPS = 3
DIST_LIMIT_FACTOR = 4.0    # a reading's limit: this times its control
DIST_JOB_TIMEOUT = 900     # the two-rank training job's launcher timeout
#: the training job's rank command, and where the stores' jobs keep values
DIST_WORKER = [sys.executable, str(Path(__file__).resolve()), "--dist-worker"]
DIST_STORE_DEVICE = "cuda"
#: collectives whose unstaged gloo form on card tensors 16(a) probes
PROBED = ("all_gather", "reduce_scatter", "all_to_all", "ppermute")


def _fingerprint(tensors):
    """An exact fingerprint of float32 tensors: each one's bits summed as
    int64 (two tensors that differ in any bit almost surely differ)."""
    return torch.stack([t.detach().float().contiguous().view(torch.int32)
                        .sum(dtype=torch.int64) for t in tensors])


def _same_on_ranks(tensors, what):
    """Fail unless every rank holds bitwise the same ``tensors``."""
    from mxnet_tpu_torch.parallel import collectives
    fp = collectives.world_all_gather(_fingerprint(tensors))
    bad = (fp != fp[0]).any(0).nonzero().flatten().tolist()
    if bad:
        raise SystemExit(f"FAIL: the ranks' {what} differ: {len(bad)} of "
                         f"{len(tensors)} tensors, first {bad[:5]}")


def _first_layers(named, layers):
    """The weights of a ``layers``-layer BERTForPretraining at full width:
    ``named`` without the encoder's later layers."""
    return {k: v for k, v in named.items()
            if not k.startswith("backbone.encoder.layer")
            or int(k.split(".")[2][len("layer"):]) < layers}


def _bert_model(dropout, layers=None):
    """BERTForPretraining over bert_base(max_length=128), or over the same
    width with ``layers`` layers."""
    if layers is None:
        return BERTForPretraining(bert_base(max_length=TRAIN_SEQ,
                                            dropout=dropout))
    return BERTForPretraining(BERTModel(
        num_layers=layers, units=768, hidden_size=3072, num_heads=12,
        max_length=TRAIN_SEQ, dropout=dropout))


def _bert_step(named, mesh, dropout, dtype, tp=False, layers=None,
               sgd=False, seed=0):
    model = _bert_model(dropout, layers)
    load_jax_params(model, named, ctx=mesh.ctx)
    if tp:
        from mxnet_tpu_torch.gluon.model_zoo.bert import \
            shard_for_tensor_parallel
        shard_for_tensor_parallel(model)
    from mxnet_tpu_torch.optimizer import SGD
    opt = SGD(learning_rate=DIST_F32["lr"], momentum=0.9) if sgd else \
        Adam(learning_rate=TRAIN_LR)
    return ParallelTrainStep(PretrainStep(model), BERTPretrainingLoss(), opt,
                             mesh, compute_dtype=dtype,
                             extra_specs=("dp", "dp"), seed=seed)


def _bert_batches(seed, n=DIST_STEPS):
    return pretrain_batch(np.random.default_rng(seed + 16), n, TRAIN_BATCH,
                          TRAIN_SEQ, TRAIN_P)


def _at(batches, i):
    toks, (mlm, nsp), tt, pos = batches
    return toks[i], (mlm[i], nsp[i]), tt[i], pos[i]


class _rows:
    """One rank's rows of a data-parallel split, emulated in one process
    (the control): Dropout draws the global batch's mask and keeps rows
    ``index`` of ``size``."""

    def __init__(self, index, size):
        from mxnet_tpu_torch.parallel import collectives
        self.inner = collectives.sharded_batch.__new__(
            collectives.sharded_batch)
        self.inner.state = (None, (), index, size)

    def __enter__(self):
        return self.inner.__enter__()

    def __exit__(self, *exc):
        return self.inner.__exit__(*exc)


def _halves_step(step, batch):
    """The control of 16(b): one step of the one-process ``step`` whose
    gradient is the mean of its two half batches' (each half's dropout
    mask the global batch's rows), as two ranks sum them; the loss the
    halves' mean."""
    x, mlm, nsp, tt, pos = (step._place(a) for a in (
        batch[0], batch[1][0], batch[1][1], batch[2], batch[3]))
    n = x.shape[0] // 2
    gen = step.generator
    state = gen.get_state()
    grads, losses = None, []
    opt = step._optimizer
    step._t += 1
    step._block.train()
    for i in range(2):
        gen.set_state(state)
        rows = slice(i * n, (i + 1) * n)
        with _rows(i, 2):
            loss = step._forward_loss(x[rows], (mlm[rows], nsp[rows]),
                                      (tt[rows], pos[rows]))
        g = torch.autograd.grad(loss, step._plist, allow_unused=True)
        g = [torch.zeros_like(w) if a is None else a.to(w.dtype)
             for w, a in zip(step._plist, g)]
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        losses.append(loss.detach())
    with torch.no_grad():
        for i, (w, g, s) in enumerate(zip(step._plist, grads, step._states)):
            opt._rule(w, g / 2 * opt.rescale_grad, s, opt._get_lr(i),
                      opt._get_wd(i), np.float32(step._t))
    return (losses[0] + losses[1]) / 2


class _no_tf32:
    """cuDNN's convolutions in f32 within (PyTorch lets them round their
    inputs to TF32 by default; the port's own switch covers matmuls)."""

    def __enter__(self):
        self.own = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32 = self.own


def _lockstep_step(step, twin, x, y):
    """The control of 16(d): one step of the one-process ResNet-50
    ``step`` computed as two ranks compute it. Each half of the batch runs
    its forward in a thread of its own (the second on ``twin``, a copy of
    the block with running statistics of its own), and BatchNorm's moment
    sums are added across the halves at every layer, as the ranks'
    all-reduce adds them, on the tape; the gradient is that of the halves'
    mean loss, the update the step's optimizer's."""
    from mxnet_tpu_torch.parallel import collectives
    x, y = step._place(x), step._place(y)
    n, cd = x.shape[0] // 2, step._compute_dtype
    barrier = threading.Barrier(2, timeout=300)
    slot, losses, errors = [None, None], [None, None], []

    def batch_sum(t):
        i = collectives.batch_shard()[2]
        slot[i] = t
        barrier.wait()
        out = slot[0] + slot[1]
        barrier.wait()
        return out

    def half(i):
        block = step._block if i == 0 else twin
        block.train()
        use = {k: p.to(cd) for k, p in zip(step._names, step._plist)}
        try:
            with _rows(i, 2):
                out = torch.func.functional_call(
                    block, use, (x[i * n:(i + 1) * n].to(cd),))
                losses[i] = step._loss(out, y[i * n:(i + 1) * n]) \
                    .float().mean()
        except BaseException as e:     # the other half must not wait
            errors.append(e)
            barrier.abort()

    own = collectives.batch_sum
    collectives.batch_sum = batch_sum
    threads = [threading.Thread(target=half, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    collectives.batch_sum = own
    if errors:
        raise errors[0]
    step._t += 1
    grads = torch.autograd.grad((losses[0] + losses[1]) / 2, step._plist)
    opt = step._optimizer
    with torch.no_grad():
        for i, (w, g, s) in enumerate(zip(step._plist, grads, step._states)):
            opt._rule(w, g * opt.rescale_grad, s, opt._get_lr(i),
                      opt._get_wd(i), np.float32(step._t))


def _row_split_hooks(model):
    """The control of 16(c): the output projection and the second FFN
    product of every layer computed as two bf16 half products over their
    input columns, summed, then the bias (what tp=2 computes), by forward
    hooks on the one-process model; returns the hooks' handles."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import (PositionwiseFFN,
                                                      SelfAttention)

    def hook(dense, inputs, out):
        x, w, b = inputs[0], dense._t("weight"), dense._t("bias")
        h = x.shape[-1] // 2
        y = torch.nn.functional.linear(x[..., :h], w[:, :h]) + \
            torch.nn.functional.linear(x[..., h:], w[:, h:])
        return y + b.to(y.dtype)

    handles = []
    for m in model.modules():
        if isinstance(m, SelfAttention):
            handles.append(torch.nn.Module.register_forward_hook(m.proj,
                                                                 hook))
        elif isinstance(m, PositionwiseFFN):
            handles.append(torch.nn.Module.register_forward_hook(m.ffn2,
                                                                 hook))
    return handles


def _bert_distance(got_losses, got, want_losses, want, lr):
    """How far one run is from another: the largest relative loss
    difference over the steps, and the parameters' mean absolute
    difference in units of lr (Adam moves each element about lr a
    step)."""
    diff = torch.cat([(got[k].float() - want[k].float()).abs().reshape(-1)
                      for k in want])
    rel = max(abs(a - b) / abs(b) for a, b in zip(got_losses, want_losses))
    return {"loss_rel": float(rel), "mean_lr": diff.mean().item() / lr}


def _resnet_distance(got, want, start):
    """How far one ResNet-50 state is from another, relative to how far
    ``want`` moved from ``start``: the L2 distance of the parameters over
    that of their update, and the same of the running statistics."""
    sums = {"param_update_rel": [0.0, 0.0], "stat_update_rel": [0.0, 0.0]}
    for k in want:
        acc = sums["stat_update_rel" if "running" in k else
                   "param_update_rel"]
        acc[0] += (got[k] - want[k]).square().sum().item()
        acc[1] += (want[k] - start[k]).square().sum().item()
    return {k: math.sqrt(a / b) for k, (a, b) in sums.items()}


def _resnet_state(step):
    """A copy of a ResNet-50 step's parameters and running statistics on
    the host, in float32."""
    return {k: v.detach().float().cpu().clone()
            for k, v in {**step.params, **step.buffers}.items()}


def _limits(control, floor=1e-7):
    return {k: max(DIST_LIMIT_FACTOR * v, floor) for k, v in control.items()}


def _within(reading, limit):
    return all(reading[k] <= limit[k] for k in limit)


def _host_params(step, gathered=False):
    src = step.global_params() if gathered else step.params
    return {k: v.detach().float().cpu() for k, v in src.items()}


def _run_steps(step, batches, n, hook=None):
    """``n`` steps on the stacked ``batches`` (``hook(step, batch)`` in
    place of a step where given); the losses."""
    losses = []
    for i in range(n):
        b = _at(batches, i)
        losses.append((hook(step, b) if hook else step(*b)).item())
    return losses


def dist_references(seed: int):
    """The one-process runs on the card that 16(b)-(d) are held against,
    and their controls, computed before any rank's reading: BERT-base bf16
    (dp=1 at 64 x 128; the control sums the gradient from the batch's two
    halves; the tp control splits the row-parallel products in two), the
    f32 2-layer BERT (SGD), and ResNet-50 at batch 32, held after its
    first step (the control computes each step as two ranks do,
    :func:`_lockstep_step`; its distance after each step is kept) and in
    f32 after one step (the control takes the batch's halves in the other
    order)."""
    named = seeded_bert_weights(BERTForPretraining(
        bert_base(max_length=TRAIN_SEQ)), seed)
    batches = _bert_batches(seed)
    one = make_mesh({"dp": 1})
    ref = {}
    st = _bert_step(named, one, 0.1, "bfloat16", seed=seed)
    ref["bert_losses"] = _run_steps(st, batches, DIST_STEPS)
    ref["bert"] = _host_params(st)
    del st
    st = _bert_step(named, one, 0.1, "bfloat16", seed=seed)
    c_losses = _run_steps(st, batches, DIST_STEPS, hook=_halves_step)
    ref["dp_control"] = _bert_distance(c_losses, _host_params(st),
                                       ref["bert_losses"], ref["bert"],
                                       TRAIN_LR)
    del st
    st = _bert_step(named, one, 0.1, "bfloat16", seed=seed)
    handles = _row_split_hooks(st._block)
    c_losses = _run_steps(st, batches, DIST_STEPS)
    for h in handles:
        h.remove()
    ref["tp_control"] = _bert_distance(c_losses, _host_params(st),
                                       ref["bert_losses"], ref["bert"],
                                       TRAIN_LR)
    del st
    f32 = _first_layers(named, DIST_F32["num_layers"])
    st = _bert_step(f32, one, 0.0, None, layers=DIST_F32["num_layers"],
                    sgd=True, seed=seed)
    ref["f32_losses"] = _run_steps(st, batches, DIST_F32["steps"])
    ref["f32"] = _host_params(st)
    del st
    torch.cuda.empty_cache()

    rnamed = seeded_resnet_weights(resnet50_v1(classes=1000), seed)
    xs, ys = resnet_batch(np.random.default_rng(seed + 17),
                          DIST_RESNET_STEPS, RESNET_BATCH)
    runs = []
    for control in (False, True):
        st = resnet_train_step(rnamed, "bfloat16")
        twin = copy.deepcopy(st._block) if control else None
        states = [_resnet_state(st)]
        for i in range(DIST_RESNET_STEPS):
            if control:
                _lockstep_step(st, twin, xs[i], ys[i])
            else:
                st(xs[i], ys[i]).item()
            states.append(_resnet_state(st))
        runs.append(states)
        del st, twin
    ref["resnet_start"], ref["resnet"] = runs[0][0], runs[0][1]
    ref["resnet_control_steps"] = [
        _resnet_distance(b, a, runs[0][0])
        for a, b in zip(runs[0][1:], runs[1][1:])]
    ref["resnet_control"] = ref["resnet_control_steps"][0]
    swap = np.r_[RESNET_BATCH // 2:RESNET_BATCH, 0:RESNET_BATCH // 2]
    f32 = []
    with _no_tf32():
        for order in (slice(None), swap):
            st = resnet_train_step(rnamed, None)
            st(xs[0][order], ys[0][order]).item()
            f32.append(_resnet_state(st))
            del st
    ref["resnet_f32"] = f32[0]
    ref["resnet_f32_control"] = _resnet_distance(f32[1], f32[0],
                                                 ref["resnet_start"])
    torch.cuda.empty_cache()
    return ref


def _timed_steps(step, args_of, n, what, after=None):
    """``n`` steps on ``args_of(i)``, the host-clock ms of each to its
    fetched loss; after each the ranks' parameters (but a rank's own
    shards) and buffers checked bitwise equal, then ``after(i)`` where
    given."""
    whole = [p for i, p in enumerate(step._plist) if i not in step._shards]
    losses, ms = [], []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(*args_of(i)).item())
        ms.append((time.perf_counter() - t0) * 1e3)
        _same_on_ranks(whole + list(step.buffers.values()),
                       f"{what} parameters (step {i})")
        if after is not None:
            after(i)
    return losses, ms


def _record_k1_shapes():
    """Record the (B, H, S, D) of every K1 launch; returns the set."""
    shapes = set()
    orig = fa.flash_attention_fwd

    def recording(q, *args, **kwargs):
        shapes.add(tuple(q.shape))
        return orig(q, *args, **kwargs)
    fa.flash_attention_fwd = recording
    return shapes, orig


def _collective_ms(fn, reps=3):
    """Median host ms of ``fn()`` (a collective) between two
    synchronizes: the communication alone."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _comm_alone(step, tp):
    """What one step's communication costs alone: dp, one all-reduce of
    a buffer the size of the gradients (f32); tp, per layer two forward
    and two backward all-reduces of a (B, S, 768) bf16 activation, and the
    word embedding's all-gather."""
    from mxnet_tpu_torch.parallel import collectives
    dev = step._device
    if not tp:
        n = sum(p.numel() for p in step._plist)
        buf = torch.ones(n, device=dev)
        return _collective_ms(lambda: collectives.world_all_reduce(buf))
    layers = len(step._block.inner.backbone.encoder._layers)
    act = torch.ones(TRAIN_BATCH, TRAIN_SEQ, 768, device=dev,
                     dtype=torch.bfloat16)
    emb = step.params["inner.backbone.word_embed.weight"].to(torch.bfloat16)
    mesh = step._mesh
    return 4 * layers * _collective_ms(
        lambda: collectives.all_reduce(act, "tp", mesh=mesh)) + \
        _collective_ms(lambda: collectives.all_gather(emb, "tp", axis=1,
                                                      mesh=mesh))


def _dist_bert(seed, named, batches, tp, save):
    """16(b) or (c) on this rank: 2 ranks, bf16 BERT-base, DIST_STEPS
    steps."""
    from mxnet_tpu_torch.parallel import collectives
    mesh = make_mesh({"tp": 2} if tp else {"dp": 2})
    step = _bert_step(named, mesh, 0.1, "bfloat16", tp=tp, seed=seed)
    placed = step.place_batch_n(*batches)
    shapes, orig = _record_k1_shapes()
    torch.cuda.synchronize()
    comm0 = step.comm_seconds
    # ---- the main path: counts from 0 just before, read just after ----
    fa.launches = fa.launches_dq = fa.launches_dkv = 0
    t0 = time.perf_counter()
    losses, ms = _timed_steps(step, lambda i: _at(placed, i), DIST_STEPS,
                              "tp" if tp else "dp")
    wall = time.perf_counter() - t0
    counts = {"K1": fa.launches, "K2": fa.launches_dq, "K3": fa.launches_dkv}
    # ---- end of the main path ----
    fa.flash_attention_fwd = orig
    alone = _comm_alone(step, tp)
    full = _host_params(step, gathered=True)
    _same_on_ranks(list(full.values()),
                   f"{'tp' if tp else 'dp'} gathered parameters")
    if collectives.rank() == 0:
        torch.save(full, save)
    enc = step._block.inner.backbone.encoder._layers
    heads, units = enc[0].attention._heads, enc[0].attention._units
    shape = [TRAIN_BATCH // (1 if tp else 2), heads // (2 if tp else 1),
             TRAIN_SEQ, units // heads]
    layers = len(enc)
    out = {"losses": losses, "expected_k1_shape": shape, "step_ms": float(np.median(ms)),
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * DIST_STEPS / wall,
           "comm_ms": (step.comm_seconds - comm0) * 1e3 / DIST_STEPS,
           "comm_alone_ms": alone, "launches": counts, "k1_shapes": sorted(shapes),
           "expected_launches": layers * DIST_STEPS}
    del step, placed
    torch.cuda.empty_cache()
    return out


def _dist_f32(seed, named, batches, tp):
    """The f32 2-layer run of 16(b)/(c) on this rank."""
    mesh = make_mesh({"tp": 2} if tp else {"dp": 2})
    f32 = _first_layers(named, DIST_F32["num_layers"])
    step = _bert_step(f32, mesh, 0.0, None, tp=tp,
                      layers=DIST_F32["num_layers"], sgd=True, seed=seed)
    losses = _run_steps(step, step.place_batch_n(*batches), DIST_F32["steps"])
    params = _host_params(step, gathered=True)
    del step
    return losses, params


def _dist_trainer(seed, named, batches, compression):
    """16(e) on this rank: BERT-base bf16 through gluon.Trainer over a
    dist_sync store (phase 8's recipe: cast bf16, Adam multi_precision,
    dropout 0.1), this rank's 32 rows of each global batch of 64."""
    from mxnet_tpu_torch.parallel import collectives
    random.seed(seed)
    net = gluon_bert(0.1)
    load_jax_params(net, named, ctx=gpu(0))
    net.cast("bfloat16")
    net.hybridize()
    params = {"learning_rate": TRAIN_LR, "multi_precision": True}
    trainer = gluon.Trainer(
        net.collect_params(), "adam", params, kvstore="dist_sync",
        compression_params=({"type": "2bit", "threshold": 0.5}
                            if compression else None))
    loss_fn = PretrainLoss()
    r, n = collectives.rank(), TRAIN_BATCH // 2
    toks, (mlm, nsp), tt, pos = batches
    to = lambda a: nd.array(a[r * n:(r + 1) * n], ctx=gpu(0),  # noqa: E731
                            dtype="int32")
    fa.launches = fa.launches_dq = fa.launches_dkv = 0
    ms, losses = [], []
    for i in range(DIST_TRAINER_STEPS):
        tok, ttype, p, ml, ns = (to(a[i]) for a in (toks, tt, pos, mlm, nsp))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with autograd.record():
            loss = loss_fn(*net(tok, ttype, None, p), ml, ns)
        loss.backward()
        trainer.step(TRAIN_BATCH)
        losses.append(float(loss.asnumpy().mean()))
        ms.append((time.perf_counter() - t0) * 1e3)
        _same_on_ranks([q._data for p_ in trainer._params
                        for q in p_.list_data()], f"Trainer weights (step {i})")
    counts = {"K1": fa.launches, "K2": fa.launches_dq, "K3": fa.launches_dkv}
    kv = trainer._kvstore
    out = {"losses": losses, "step_ms": float(np.median(ms[1:])),
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (np.median(ms[1:]) / 1e3),
           "launches": counts, "wire_bytes": kv.wire_bytes,
           "payload_bytes": kv.payload_bytes,
           "packed_bytes": sum(math.ceil(p_.data()._data.numel() / 4)
                               for p_ in trainer._params
                               if p_.grad_req != "null")
           * DIST_TRAINER_STEPS}
    del net, trainer
    torch.cuda.empty_cache()
    return out


def _dist_resnet(seed, save):
    """16(d) on this rank: ResNet-50 v1 bf16, SGD(0.05, 0.9), a global
    batch of 32 split 16 a rank, BatchNorm's moments over all 32; rank 0
    saves the state after the first step, and after one f32 step (as
    ``resnet_f32.pt`` beside ``save``)."""
    from mxnet_tpu_torch.optimizer import SGD
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.parallel import collectives
    named = seeded_resnet_weights(resnet50_v1(classes=1000), seed)

    def dp_step(dtype):
        net = resnet50_v1(classes=1000)
        load_jax_params(net, named)
        return ParallelTrainStep(net, SoftmaxCrossEntropyLoss(),
                                 SGD(learning_rate=0.05, momentum=0.9),
                                 make_mesh({"dp": 2}), compute_dtype=dtype)
    step = dp_step("bfloat16")
    xs, ys = resnet_batch(np.random.default_rng(seed + 17),
                          DIST_RESNET_STEPS, RESNET_BATCH)
    placed = step.place_batch_n(xs, ys)

    def first(i):
        if i == 0 and collectives.rank() == 0:
            torch.save(_resnet_state(step), save)
    losses, ms = _timed_steps(step, lambda i: (placed[0][i], placed[1][i]),
                              DIST_RESNET_STEPS, "ResNet-50", after=first)
    out = {"losses": losses, "step_ms": float(np.median(ms)),
           "img_per_s": RESNET_BATCH * DIST_RESNET_STEPS / (sum(ms) / 1e3),
           "comm_ms": step.comm_seconds * 1e3 / DIST_RESNET_STEPS}
    del step
    step = dp_step(None)
    with _no_tf32():
        _timed_steps(step, lambda i: (placed[0][i], placed[1][i]), 1,
                     "f32 ResNet-50")
    if collectives.rank() == 0:
        torch.save(_resnet_state(step), save.with_name("resnet_f32.pt"))
    del step, placed
    return out


def dist_worker(seed: int) -> int:
    """One rank of 16(b)-(e), started by ``mxnet_tpu_torch/tools/launch.py``
    (``chip_smoke.py --dist-worker``): prints one JSON line of its
    readings; rank 0 writes its final parameters under build/phase_dist/."""
    from mxnet_tpu_torch.parallel import collectives
    make_mesh({"dp": 2})                      # joins the job
    named = seeded_bert_weights(BERTForPretraining(
        bert_base(max_length=TRAIN_SEQ)), seed)
    batches = _bert_batches(seed)
    res = {"rank": collectives.rank(), "backend": collectives.backend()}
    for part, tp in (("dp", False), ("tp", True)):
        res[part] = _dist_bert(seed, named, batches, tp,
                               DIST_DIR / f"{part}.pt")
        losses, params = _dist_f32(seed, named, batches, tp)
        res[f"{part}_f32_losses"] = losses
        if collectives.rank() == 0:
            torch.save(params, DIST_DIR / f"{part}_f32.pt")
    res["trainer"] = _dist_trainer(seed, named, batches, False)
    res["trainer_2bit"] = _dist_trainer(seed, named, batches, True)
    res["resnet"] = _dist_resnet(seed, DIST_DIR / "resnet.pt")
    res["host_staged"] = collectives.host_staged()
    os.write(1, (json.dumps(res) + "\n").encode())  # one write: shared pipe
    collectives.barrier()
    return 0


def _job_lines(proc, n, what):
    if proc.returncode != 0:
        print(proc.stdout[-3000:])
        print(proc.stderr[-6000:])
        raise SystemExit(f"FAIL: {what} exited {proc.returncode}")
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    if sorted(ln["rank"] for ln in lines) != list(range(n)):
        raise SystemExit(f"FAIL: {what}: not every rank reported")
    return sorted(lines, key=lambda ln: ln["rank"])


def _store_job(mode, n, env):
    from mxnet_tpu_torch.tools import launch
    return launch.run(n, [sys.executable, str(KV_WORKER), mode,
                          DIST_STORE_DEVICE], 300, env)


def _stores(env):
    """16(a): the 2-rank stores' job alone on the card (its ms are its
    own), then the 4-rank and one-rank jobs and the probes of the
    backend's own collectives started together in the background."""
    two = _store_job("two", 2, env)
    jobs = {"four": (4, "four"), "nccl": (1, "one"),
            **{op: (2, f"probe_{op}") for op in PROBED}}
    pool = ThreadPoolExecutor(len(jobs))
    futures = {k: pool.submit(_store_job, mode, n, env)
               for k, (n, mode) in jobs.items()}
    pool.shutdown(wait=False)
    return two, futures


def _report_stores(two, futures):
    out = {}
    for key in ("two", "four", "nccl"):
        n = {"two": 2, "four": 4, "nccl": 1}[key]
        proc = two if key == "two" else futures[key].result()
        lines = _job_lines(proc, n, f"16(a) {key}")
        first = lines[0]
        print(f"16(a) {key}: {n} rank(s), backend {first['backend']}, "
              f"staged through host memory {first['host_staged']}, rank 0 "
              f"ms {json.dumps({k: round(v, 3) for k, v in first['ms'].items()})}"
              + (f", 2-bit wire {first['wire_bytes']} B for "
                 f"{first['payload_bytes']} B of f32 (alone on the card)"
                 if key == "two" else " (beside the other jobs and the "
                 "one-process references)"))
        out[key] = lines
    if out["nccl"][0]["backend"] != "nccl":
        raise SystemExit("FAIL: a one-rank job on the card did not take NCCL")
    if out["two"][0]["backend"] != "gloo":
        raise SystemExit("FAIL: two ranks on one card did not take gloo")
    from mxnet_tpu_torch.parallel import collectives
    native = {op: futures[op].result().returncode == 0 for op in PROBED}
    staged = list(collectives.GLOO_CUDA_STAGED)
    print(f"16(a) gloo on card tensors, unstaged, 20 checked calls each "
          f"(True: ran and right): {native}; the port stages {staged} "
          f"through pinned host memory (parallel/collectives.py _staged) "
          f"and leaves the others to gloo")
    wrong = [op for op in PROBED if op not in staged and not native[op]]
    if wrong:
        raise SystemExit(f"FAIL: gloo does not run {wrong} right on card "
                         "tensors, and the port leaves them to it")
    return native


def phase_distributed(seed: int, smi: str):
    """Phase 16: the stores on 1, 2 and 4 ranks; BERT-base on dp=2 and
    tp=2, ResNet-50 on dp=2 and BERT-base through a dist_sync Trainer on 2
    ranks of the one card, each held against the one-process run on the
    card with a limit set from a control."""
    DIST_DIR.mkdir(parents=True, exist_ok=True)
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, MXNET_DIST_TIMEOUT="300",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    t_phase = time.perf_counter()
    two, futures = _stores(env)
    ref = dist_references(seed)
    native = _report_stores(two, futures)
    limits = {"dp": _limits(ref["dp_control"]),
              "tp": _limits(ref["tp_control"]),
              "resnet": _limits(ref["resnet_control"]),
              "resnet_f32": _limits(ref["resnet_f32_control"])}
    for k in limits:
        print(f"16 control {k}: {json.dumps(ref[k + '_control'])} -> limit "
              f"{json.dumps(limits[k])} ({DIST_LIMIT_FACTOR}x the control)")
    print(f"16 control resnet after each of the {DIST_RESNET_STEPS} steps "
          f"(the first is held): {json.dumps(ref['resnet_control_steps'])}")

    from mxnet_tpu_torch.tools import launch
    proc = launch.run(2, DIST_WORKER + ["--seed", str(seed)],
                      DIST_JOB_TIMEOUT, env)
    ranks = _job_lines(proc, 2, "the two-rank training job")
    r0 = ranks[0]
    print(f"16 training job: backend {r0['backend']}, staged through host "
          f"memory (rank 0) {r0['host_staged']}")
    ok = True
    tol = DIST_F32["tol"]
    for part, what in (("dp", "16(b) BERT-base {\"dp\": 2}"),
                       ("tp", "16(c) BERT-base {\"tp\": 2}")):
        got = torch.load(DIST_DIR / f"{part}.pt")
        reading = _bert_distance(r0[part]["losses"], got, ref["bert_losses"],
                                 ref["bert"], TRAIN_LR)
        f32 = torch.load(DIST_DIR / f"{part}_f32.pt")
        f32_loss = max(abs(a - b) / abs(b) for a, b in
                       zip(r0[f"{part}_f32_losses"], ref["f32_losses"]))
        f32_par = max(((f32[k] - ref["f32"][k]).abs() /
                       (1 + ref["f32"][k].abs())).max().item()
                      for k in ref["f32"])
        launches = [rk[part]["launches"] for rk in ranks]
        exp = r0[part]["expected_launches"]
        print(f"{what}: losses {[round(v, 5) for v in r0[part]['losses']]} "
              f"vs one process {[round(v, 5) for v in ref['bert_losses']]}; "
              f"reading {json.dumps(reading)} vs control "
              f"{json.dumps(ref[part + '_control'])}, limit "
              f"{json.dumps(limits[part])}; f32 {DIST_F32['num_layers']}-layer"
              f" SGD: loss rel {f32_loss:.3g}, params {f32_par:.3g} (tol "
              f"{tol}); launches a rank {launches} (expected {exp} each); "
              f"K1 shapes a rank {[rk[part]['k1_shapes'] for rk in ranks]}; "
              f"{r0[part]['tokens_per_s']:.0f}"
              f" tokens/s, step median {r0[part]['step_ms']:.1f} ms, "
              f"gradient all-reduce in the step {r0[part]['comm_ms']:.1f} ms "
              f"(host clock, waiting for the backward included), a step's "
              f"communication alone {r0[part]['comm_alone_ms']:.1f} ms (gloo "
              f"through host memory) on {smi}")
        if not _within(reading, limits[part]):
            ok = False
            print(f"FAIL: {what} is beyond its control's limit")
        if not (f32_loss <= tol and f32_par <= tol):
            ok = False
            print(f"FAIL: {what}'s f32 run is not within {tol}")
        if any(n != exp for c in launches for n in c.values()):
            ok = False
            print(f"FAIL: {what}: K1-K3 launches do not match 12 a step")
    for part in ("dp", "tp"):
        want = r0[part]["expected_k1_shape"]
        if any([want] != [list(s) for s in rk[part]["k1_shapes"]]
               for rk in ranks):
            ok = False
            print(f"FAIL: {part}=2's K1 shapes are not {want}")

    got = torch.load(DIST_DIR / "resnet.pt")
    reading = _resnet_distance(got, ref["resnet"], ref["resnet_start"])
    rr = r0["resnet"]
    print(f"16(d) ResNet-50 {{\"dp\": 2}}, 16 images a rank, BatchNorm over "
          f"32, after the first step: reading {json.dumps(reading)} vs "
          f"control "
          f"{json.dumps(ref['resnet_control'])}, limit "
          f"{json.dumps(limits['resnet'])}; losses "
          f"{[round(v, 4) for v in rr['losses']]}; {rr['img_per_s']:.1f} "
          f"img/s over the steps' ms, step median {rr['step_ms']:.1f} ms, gradient all-reduce "
          f"{rr['comm_ms']:.1f} ms a step on {smi}")
    if not _within(reading, limits["resnet"]):
        ok = False
        print("FAIL: 16(d) is beyond its control's limit")
    reading = _resnet_distance(torch.load(DIST_DIR / "resnet_f32.pt"),
                               ref["resnet_f32"], ref["resnet_start"])
    print(f"16(d) ResNet-50 f32 (no TF32), one step on {{\"dp\": 2}}: "
          f"reading {json.dumps(reading)} vs control (the batch's halves "
          f"swapped) {json.dumps(ref['resnet_f32_control'])}, limit "
          f"{json.dumps(limits['resnet_f32'])}")
    if not _within(reading, limits["resnet_f32"]):
        ok = False
        print("FAIL: 16(d)'s f32 step is beyond its control's limit")

    for key in ("trainer", "trainer_2bit"):
        t = r0[key]
        ratio = t["wire_bytes"] / t["payload_bytes"]
        print(f"16(e) BERT-base gluon.Trainer(kvstore=\"dist_sync\""
              f"{', 2-bit' if key == 'trainer_2bit' else ''}), "
              f"{TRAIN_BATCH // 2} x {TRAIN_SEQ} a rank: losses "
              f"{[round(v, 5) for v in t['losses']]}; wire {t['wire_bytes']}"
              f" B for {t['payload_bytes']} B of f32 (ratio {ratio:.5f}); "
              f"launches a rank {[rk[key]['launches'] for rk in ranks]}; "
              f"{t['tokens_per_s']:.0f} tokens/s, step median "
              f"{t['step_ms']:.1f} ms on {smi}")
        if not np.isfinite(t["losses"]).all():
            ok = False
            print(f"FAIL: 16(e) {key}: a loss is not finite")
        if key == "trainer_2bit" and t["wire_bytes"] != t["packed_bytes"]:
            ok = False
            print("FAIL: 16(e): the 2-bit wire is not the packed codes")
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    if not ok:
        raise SystemExit("FAIL: phase 16")
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s")

    def per_rank(part):
        return {k: r0[part]["launches"][k] for k in ("K1", "K2", "K3")}
    trainer = {k: r0["trainer"]["launches"][k] +
               r0["trainer_2bit"]["launches"][k] for k in ("K1", "K2", "K3")}
    return {"hand": {"dp_bert": per_rank("dp"), "tp_bert": per_rank("tp"),
                     "dist_trainer_bert": trainer},
            "native": native}


# ---------------------------------------------------------------------------
# phase 17: ring attention, DLRM over the vocab-sharded table, thin modules
# ---------------------------------------------------------------------------
SLICE17_DIR = Path(__file__).resolve().parent / "build" / "phase_slice17"
RING_SHAPE = (1, 12, 8192, 64)     # BERT-base's heads and head dim, S = 8192
RING_RANKS = 2                     # {"sp": 2}: blocks of S_local = 4096
RING_BLOCK = (1, 12, 4096, 64)
RING_F32_SHAPE = (1, 12, 1024, 64)
RING_TIMED = 5                     # calls timed a mode, the median kept
#: MLPerf Training's DLRM on Criteo 1TB (facebookresearch/dlrm:
#: --arch-sparse-feature-size=128, bottom MLP 13-512-256-128, top MLP
#: 1024-1024-512-256-1) in the reference's factorization (two layers a
#: tower, one shared table), the table cut from 40M rows to 2^23
DLRM_CFG = dict(dense_in=13, n_fields=26, bot_hidden=512, top_hidden=1024)
DLRM_DIM = 128
DLRM_VOCAB = 8_388_608
DLRM_BATCH = 2048
DLRM_LR = 0.05
DLRM_INIT_STD = 0.1                # the reference tests' N(0, 0.1^2) rows
DLRM_CHECK_STEPS = 4               # steps held bitwise / within tolerance
DLRM_WARMUP = 2
DLRM_TIMED = 10
DLRM_FEED_STEPS = 8
DLRM_DIST_TIMED = 4
DLRM_CHECK_ROWS = 4096             # touched rows compared (batch 0's ids)
DLRM_CPU_VOCAB = 65_536
SLICE17_JOB_TIMEOUT = 600
SLICE17_WORKER = [sys.executable, str(Path(__file__).resolve()),
                  "--slice17-worker"]


def _dev():
    return gpu(0).torch_device()


def ring_inputs(shape, dtype, seed):
    """q, k, v and the output gradient, (B, H, S, D), from one seeded
    generator on the card (every process draws the same)."""
    gen = torch.Generator(device=_dev()).manual_seed(seed + 17)
    return [torch.randn(shape, generator=gen, device=_dev()).to(dtype)
            for _ in range(4)]


def _leaves(*ts):
    return [t.detach().clone().requires_grad_() for t in ts]


def ring_one_process(q, k, v, dout, causal):
    """One process's K1-K3 over the whole sequence: the output and the
    gradients of q, k and v for the output gradient ``dout``."""
    q_, k_, v_ = _leaves(q, k, v)
    out = fa.flash_attention(q_, k_, v_, causal=causal)
    out.backward(dout)
    return [out.detach(), q_.grad, k_.grad, v_.grad]


def _dist(got, want):
    """max |got - want| over the four tensors, and the worst tensor's
    error relative to its own rows: for each row (the last axis), max
    |got - want| over max(max |want| of the row, RMS of the tensor), the
    RMS a floor for rows near 0 (the causal dq's first row is exactly
    0). A ring that rounds each block's bf16 output before its f32 merge
    stays within about one bf16 ulp of a row's largest entry (2^-7);
    a wrong row of a small output, or a wrong gradient, does not."""
    err, rel = 0.0, 0.0
    for a, b in zip(got, want):
        a, b = a.float().cpu(), b.float().cpu()
        d = (a - b).abs()
        floor = b.pow(2).mean().sqrt()
        row = torch.maximum(b.abs().amax(-1, keepdim=True), floor)
        err = max(err, d.max().item())
        rel = max(rel, (d / row).max().item())
    return err, rel


def ring_block_times(seed: int, smi: str):
    """K1, K2 and K3 at one rank's block (1, 12, 4096, 64) bf16, causal and
    not: each against its plain version (within TOL[bf16] x max(1,
    max|plain|), as phase 3 holds them), then through the wrappers and
    from CUDA graphs, beside the plain versions, SDPA and the bounds."""
    q, k, v, do = ring_inputs(RING_BLOCK, torch.bfloat16, seed + 1)
    scale = RING_BLOCK[-1] ** -0.5
    out = {}
    for causal in (False, True):
        o, lse = fa.flash_attention_fwd(q, k, v, scale, causal)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, scale,
                                              causal)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale,
                                            causal)
        torch.cuda.synchronize()
        errs, ok = [], True
        for got, want in (
                ((o, lse), fa.flash_attention_fwd_reference(
                    q, k, v, scale, causal)),
                ((dq, delta), fa.flash_attention_bwd_dq_reference(
                    q, k, v, o, do, lse, scale, causal)),
                ((dk, dv), fa.flash_attention_bwd_dkv_reference(
                    q, k, v, do, lse, delta, scale, causal))):
            e, good = _bwd_errors(got, want, torch.bfloat16)
            errs += e
            ok &= good
        print(f"17(a) K1/K2/K3 at {RING_BLOCK} bf16, causal={causal}, vs "
              f"their plain versions: max|d out|={errs[0]:.3g} max|d lse|="
              f"{errs[1]:.3g}; max|d dq|={errs[2]:.3g} max|d delta|="
              f"{errs[3]:.3g}; max|d dk|={errs[4]:.3g} max|d dv|="
              f"{errs[5]:.3g}; tol={TOL[torch.bfloat16]:g} x max(1, "
              f"max|plain|)")
        if not ok:
            raise SystemExit(f"FAIL: K1-K3 disagree with their plain "
                             f"versions at the ring's block {RING_BLOCK} "
                             f"causal={causal}")
        del dq, delta, dk, dv
        fwd = lambda: fa.flash_attention_fwd(q, k, v, scale, causal)  # noqa
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa
            q, k, v, is_causal=causal, scale=scale)
        bms, by, nbytes, flops = bound_ms(RING_BLOCK, torch.bfloat16,
                                          causal, "fwd")
        rec = {"fwd": {
            "ms": median_ms(fwd, calls=TIMED_CALLS), "device_ms": graph_ms(fwd),
            "plain_ms": median_ms(lambda: fa.flash_attention_fwd_reference(
                q, k, v, scale, causal), reps=5, warmup=1),
            "bound_ms": bms, "bound_by": by, "library_ms": graph_ms(sdpa),
            "max_abs_err": max(errs[:2])},
            "max_abs_err_dq": max(errs[2:4]),
            "max_abs_err_dkv": max(errs[4:])}
        f = rec["fwd"]
        print(f"17(a) K1 at {RING_BLOCK} bf16, causal={causal}: {f['ms']:.4f}"
              f" ms ({f['device_ms']:.4f} from a CUDA graph), plain "
              f"{f['plain_ms']:.4f}, SDPA {f['library_ms']:.4f} (graph), "
              f"bound {bms * 1e3:.1f} us ({by}: {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP) on {smi}")
        rec.update(time_backward(q, k, v, o, lse, do, scale, causal, smi,
                                 RING_BLOCK))
        out[causal] = rec
    return out


def ring_single(seed: int, smi: str):
    """17(a): with one rank ``ring_self_attention`` is one K1 call (and one
    K2 and K3) over the whole sequence, bitwise, at (1, 12, 8192, 64)
    bf16; the one-process runs (b) is held against, bf16 and f32."""
    from mxnet_tpu_torch import parallel
    mesh = make_mesh({"sp": 1})
    ok, refs = True, {}
    for dtype, shape in ((torch.bfloat16, RING_SHAPE),
                         (torch.float32, RING_F32_SHAPE)):
        q, k, v, do = ring_inputs(shape, dtype, seed)
        for causal in (False, True):
            want = ring_one_process(q, k, v, do, causal)
            refs[dtype, causal] = [t.float().cpu() for t in want]
            if dtype != torch.bfloat16:
                continue
            q_, k_, v_ = _leaves(q, k, v)
            _zero_counters()
            got = parallel.ring_self_attention(q_, k_, v_, mesh,
                                               causal=causal)
            got.backward(do)
            counts = _read_counters()
            same = all(torch.equal(a, b) for a, b in zip(
                [got.detach(), q_.grad, k_.grad, v_.grad], want))
            print(f"17(a) {{\"sp\": 1}} ring_self_attention at {shape} bf16,"
                  f" causal={causal}: output and q, k, v gradients bitwise "
                  f"one flash_attention call's: {same}; K1/K2/K3 launches "
                  f"{counts['K1']}/{counts['K2']}/{counts['K3']} (1 each)")
            if not same or [counts[k] for k in ("K1", "K2", "K3")] != \
                    [1, 1, 1]:
                ok = False
    return refs, ok


def ring_worker(seed: int):
    """17(b) on one rank of {"sp": 2}: the main path (both ``causal``
    settings, forward and backward, the counts set to 0 just before each
    and read just after), the times, and the f32 run; rank 0 saves the
    outputs and gradients."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.parallel import collectives
    mesh = make_mesh({"sp": RING_RANKS})
    rank = collectives.rank()
    res, saved = {"launches": {}, "ms": {}}, {}
    for dtype, shape in ((torch.bfloat16, RING_SHAPE),
                         (torch.float32, RING_F32_SHAPE)):
        q, k, v, do = ring_inputs(shape, dtype, seed)
        for causal in (False, True):
            q_, k_, v_ = _leaves(q, k, v)
            _zero_counters()
            out = parallel.ring_self_attention(q_, k_, v_, mesh,
                                               causal=causal)
            out.backward(do)
            torch.cuda.synchronize()
            counts = _read_counters()
            if dtype == torch.bfloat16:
                res["launches"][str(causal)] = counts
            saved[str(dtype), causal] = [t.float().cpu() for t in (
                out.detach(), q_.grad, k_.grad, v_.grad)]
    q, k, v, do = (collectives.scatter_to_axis(t, "sp", dim=2, mesh=mesh)
                   for t in ring_inputs(RING_SHAPE, torch.bfloat16, seed))
    for causal in (False, True):
        def fwd():
            return parallel.ring_attention(q, k, v, causal=causal, mesh=mesh)

        def both():
            q_, k_, v_ = _leaves(q, k, v)
            parallel.ring_attention(q_, k_, v_, causal=causal,
                                    mesh=mesh).backward(do)
        collectives.barrier()
        res["ms"][f"fwd_{causal}"] = host_ms(fwd, RING_TIMED)
        res["ms"][f"fwd_bwd_{causal}"] = host_ms(both, RING_TIMED)
    kv = torch.stack((k, v))
    perm = [(i, (i + 1) % RING_RANKS) for i in range(RING_RANKS)]
    collectives.barrier()
    res["ms"]["ppermute"] = host_ms(
        lambda: collectives.ppermute(kv, "sp", perm, mesh=mesh), RING_TIMED)
    res["ppermute_bytes"] = kv.numel() * kv.element_size()
    res["host_staged"] = collectives.host_staged()
    if rank == 0:
        torch.save(saved, SLICE17_DIR / "ring.pt")
    return res


def dlrm_batches(seed: int, n: int, vocab: int = DLRM_VOCAB):
    return synthetic_dlrm_batches(n, DLRM_BATCH, DLRM_CFG["dense_in"],
                                  DLRM_CFG["n_fields"], vocab, seed=seed)


def dlrm_check_ids(batches):
    """The touched rows compared: the first DLRM_CHECK_ROWS sorted unique
    ids of the first batch."""
    return torch.from_numpy(np.unique(batches[0][1])[:DLRM_CHECK_ROWS])


def dlrm_step(mesh, seed: int, mode: str, vocab: int = DLRM_VOCAB):
    """The full-width table, filled on the card from a seeded generator
    (every process draws the same ``vocab`` x 128 rows), and its step."""
    gen = torch.Generator(device=_dev()).manual_seed(seed + 170)
    full = torch.randn((vocab, DLRM_DIM), generator=gen,
                       device=_dev()).mul_(DLRM_INIT_STD)
    table = ShardedEmbedding(vocab, DLRM_DIM, mesh, axis="tp",
                             weight=full)
    del full
    torch.cuda.empty_cache()
    return table, DLRMTrainStep(table, **DLRM_CFG, lr=DLRM_LR, seed=seed,
                                mode=mode)


def _mlp_host(step):
    """A host copy of the MLP (the step updates it in place)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in step.mlp.items()}


def _halves_fp(weight):
    """Fingerprints of the table's two halves (the 2-rank block shards)."""
    half = weight.shape[0] // 2
    return [_fingerprint([weight[:half]]).item(),
            _fingerprint([weight[half:]]).item()]


def _update_error(got, want, start):
    """How far ``got``'s update from ``start`` is from ``want``'s, both
    after DLRM_CHECK_STEPS SGD steps: max |got - want| beyond
    DLRM_CHECK_STEPS ulps of ``want`` (the weight is rounded once a step,
    on either side), over max |want - start|. The table's rows move by
    about 1e-5 a step from values of about 0.1, so the weights themselves,
    compared absolutely, cannot show the update; a dropped, doubled or
    halved update reads here as 0.5-1."""
    got, want, start = (np.asarray(x, dtype=np.float32) for x in (
        got, want, start))
    excess = np.maximum(np.abs(got - want) -
                        DLRM_CHECK_STEPS * np.spacing(np.abs(want)), 0.0)
    return float(excess.max() / np.abs(want - start).max())


def _moved_rows(table, start):
    """Indices of the rows of a (rows, dim) table that differ from
    ``start``."""
    diff = np.asarray(table, dtype=np.float32) != np.asarray(
        start, dtype=np.float32)
    return np.flatnonzero(diff.any(axis=1))


def _timed_steps_ms(step, staged):
    """Host ms of each step, closed by the fetched loss."""
    times = []
    for s in staged:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(s)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def dlrm_one_process(seed: int, smi: str):
    """17(c): DLRM at MLPerf's widths on one process: four steps kept for
    (d), the timed steps, the profile, and the same steps through
    DeviceFeed."""
    mesh = make_mesh({"tp": 1})
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    table, step = dlrm_step(mesh, seed, "replicated")
    setup_s = time.perf_counter() - t0
    batches = dlrm_batches(seed, DLRM_CHECK_STEPS + DLRM_WARMUP + DLRM_TIMED
                           + DLRM_FEED_STEPS)
    ids = dlrm_check_ids(batches)
    start = {"rows0": table.gather(ids).cpu(), "mlp0": _mlp_host(step)}
    losses = [step(b) for b in batches[:DLRM_CHECK_STEPS]]
    ref = {"losses": losses, "mlp": _mlp_host(step),
           "rows": table.gather(ids).cpu(), "fp": _halves_fp(table.weight),
           **start}
    rest = batches[DLRM_CHECK_STEPS:DLRM_CHECK_STEPS + DLRM_WARMUP
                   + DLRM_TIMED]
    staged = [step.stage(b) for b in rest]
    torch.cuda.synchronize()
    times = _timed_steps_ms(step, staged)[DLRM_WARMUP:]
    step_ms = float(np.median(times))
    device_ms, busy = busy_share(lambda: step(staged[-1]), step_ms)
    lookups = DLRM_BATCH * DLRM_CFG["n_fields"]
    feed_data = batches[-DLRM_FEED_STEPS:]
    loader = gdata.DataLoader(gdata.ArrayDataset(*(
        np.stack([b[i] for b in feed_data]) for i in range(3))),
        batch_size=1, shuffle=False)
    def stage(b):
        return step.stage(tuple(a.asnumpy()[0] for a in b))
    # the feed's two parts alone, in this thread: the loader's batches,
    # then staging them (closed by a synchronize)
    t0 = time.perf_counter()
    raw = list(loader)
    loader_ms = (time.perf_counter() - t0) * 1e3 / len(raw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in raw:
        stage(b)
    torch.cuda.synchronize()
    stage_ms = (time.perf_counter() - t0) * 1e3 / len(raw)
    feed = DeviceFeed(loader, stage=stage)
    leads, feed_losses, feed_times = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in feed:
        leads.append(feed.lead)
        feed_losses.append(step(s))
        feed_times.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
    feed_ms = float(np.median(feed_times))
    waits = np.asarray(feed.wait_us[:DLRM_FEED_STEPS]) / 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"17(c) DLRM one process, dense 13, 26 fields, dim 128, bottom "
          f"512, top 1024, batch {DLRM_BATCH}, table {DLRM_VOCAB:,} x "
          f"{DLRM_DIM} f32 ({DLRM_VOCAB * DLRM_DIM * 4 / 1e9:.2f} GB, filled "
          f"on the card in {setup_s:.2f} s), SGD {DLRM_LR}: losses "
          f"{[round(v, 5) for v in losses]}; {1e3 / step_ms:.1f} steps/s, "
          f"{lookups * 1e3 / step_ms:,.0f} lookups/s, step median "
          f"{step_ms:.3f} ms (host clock to a fetched loss; "
          f"{DLRM_TIMED} steps after {DLRM_WARMUP}), device {device_ms:.3f} "
          f"ms a step (torch.profiler), busy {busy:.3f}, peak memory "
          f"{peak:.2f} GiB ({held:.2f} GiB of it held by earlier phases) on "
          f"{smi}")
    print(f"17(c) through DeviceFeed (depth {feed.depth}, stage = the copy "
          f"to the card and the dedup there): {feed_ms:.3f} ms a step "
          f"(median; each {[round(t, 2) for t in feed_times]}), wait "
          f"p50 {np.percentile(waits, 50):.3f} ms, p99 "
          f"{np.percentile(waits, 99):.3f} ms, lead {leads}; alone in one "
          f"thread: the loader {loader_ms:.3f} ms a batch, staging "
          f"{stage_ms:.3f} ms a batch; losses "
          f"{[round(v, 5) for v in feed_losses]}")
    ok = bool(np.isfinite(losses + feed_losses).all()) and \
        len(feed_losses) == DLRM_FEED_STEPS
    if not ok:
        print("FAIL: 17(c): a loss is not finite or the feed fell short")
    rec = {"step_ms": step_ms, "device_ms": device_ms, "busy": busy,
           "peak_gib": peak, "held_gib": held, "feed_ms": feed_ms,
           "loader_ms": loader_ms,
           "stage_ms": stage_ms}
    del table, step, staged, feed
    torch.cuda.empty_cache()
    return ref, rec, ok


def dlrm_card_vs_cpu(seed: int, smi: str):
    """17(c): the card against the port on the CPU at vocab 65,536, the
    same widths and batch, four steps from the same host weights (TF32 is
    off for products in the port): losses within TOL[f32] relative; the
    table's and the MLP's updates within TOL[f32] of the CPU's
    (:func:`_update_error`); the rows that moved are the rows the batches
    touch, on both."""
    rng = np.random.RandomState(seed + 171)
    w0 = (rng.standard_normal((DLRM_CPU_VOCAB, DLRM_DIM)) *
          DLRM_INIT_STD).astype(np.float32)
    batches = dlrm_batches(seed, DLRM_CHECK_STEPS, DLRM_CPU_VOCAB)
    touched = np.unique(np.concatenate([b[1].ravel() for b in batches]))
    runs = []
    for ctx in (gpu(0), cpu()):
        table = ShardedEmbedding(DLRM_CPU_VOCAB, DLRM_DIM,
                                 make_mesh({"tp": 1}, ctx=ctx), axis="tp",
                                 weight=w0)
        step = DLRMTrainStep(table, **DLRM_CFG, lr=DLRM_LR, seed=seed)
        m0 = _mlp_host(step)
        runs.append(([step(b) for b in batches], table.dense_weight(),
                     _mlp_host(step), m0))
    (lc, tc, mc, _), (lh, th, mh, m0) = runs
    tol = TOL[torch.float32]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    table_err = _update_error(tc, th, w0)
    mlp_err = max(_update_error(mc[k], mh[k], m0[k]) for k in mh)
    moved = [np.array_equal(_moved_rows(t, w0), touched) for t in (tc, th)]
    ok = loss_rel <= tol and table_err <= tol and mlp_err <= tol and \
        all(moved)
    print(f"17(c) card vs the port on the CPU, vocab {DLRM_CPU_VOCAB:,}, "
          f"{DLRM_CHECK_STEPS} steps f32: losses rel {loss_rel:.3g}; "
          f"updates (beyond {DLRM_CHECK_STEPS} ulps of the weight, of the "
          f"largest update) table {table_err:.3g}, MLP {mlp_err:.3g} (tol "
          f"{tol}); rows moved = the {touched.size:,} rows touched: card "
          f"{moved[0]}, CPU {moved[1]} on {smi}")
    if not ok:
        print("FAIL: 17(c): the card's DLRM is not within tolerance of the "
              "CPU's")
    return ok


def dlrm_worker(seed: int):
    """17(d) on one rank of {"tp": 2}: each mode's four checked steps from
    the seeded full-width table, its touched rows and its shard's
    fingerprint, the exchange bytes, then timed steps; rank 0 saves."""
    from mxnet_tpu_torch.parallel import collectives
    mesh = make_mesh({"tp": RING_RANKS})
    rank = collectives.rank()
    batches = dlrm_batches(seed, DLRM_CHECK_STEPS + DLRM_DIST_TIMED)
    ids = dlrm_check_ids(batches)
    res, saved = {}, {}
    for mode in ("replicated", "sharded"):
        table, step = dlrm_step(mesh, seed, mode)
        losses = [step(b) for b in batches[:DLRM_CHECK_STEPS]]
        n_ids = DLRM_BATCH * DLRM_CFG["n_fields"]
        want = [DLRM_CHECK_STEPS * v for v in table.exchange_cost_bytes(
            n_ids, dispatch=(mode == "sharded"))]
        saved[mode] = {"losses": losses, "mlp": _mlp_host(step),
                       "rows": table.gather(ids).cpu()}
        rec = {"mode": step.mode, "losses": losses,
               "fp": _fingerprint([table.weight]).item(),
               "exchange": dict(table.exchange_bytes),
               "exchange_cost": {"dispatch": want[0], "return": want[1]}}
        staged = [step.stage(b) for b in batches[DLRM_CHECK_STEPS:]]
        collectives.barrier()
        rec["step_ms"] = float(np.median(_timed_steps_ms(step, staged)[1:]))
        res[mode] = rec
        del table, step, staged
        torch.cuda.empty_cache()
    if rank == 0:
        torch.save(saved, SLICE17_DIR / "dlrm.pt")
    return res


def slice17_worker(seed: int) -> int:
    """One rank of phase 17's two-rank job (``chip_smoke.py
    --slice17-worker``, started by ``mxnet_tpu_torch/tools/launch.py``):
    17(b) and 17(d); prints one JSON line of its readings."""
    from mxnet_tpu_torch.parallel import collectives
    res = {"ring": ring_worker(seed), "dlrm": dlrm_worker(seed)}
    res.update(rank=collectives.rank(), backend=collectives.backend())
    os.write(1, (json.dumps(res) + "\n").encode())  # one write: shared pipe
    collectives.barrier()
    return 0


def _ring_report(ranks, refs, smi):
    ok = True
    saved = torch.load(SLICE17_DIR / "ring.pt")
    for dtype, shape in ((torch.bfloat16, RING_SHAPE),
                         (torch.float32, RING_F32_SHAPE)):
        tol = TOL[dtype]
        for causal in (False, True):
            err, rel = _dist(saved[str(dtype), causal], refs[dtype, causal])
            print(f"17(b) {{\"sp\": {RING_RANKS}}} ring_self_attention at "
                  f"{shape} {str(dtype).split('.')[-1]}, causal={causal}: "
                  f"output and q, k, v gradients vs one process's K1-K3 "
                  f"over the whole sequence: max |d| {err:.4g}; worst "
                  f"tensor {rel:.3g} of its rows' max(max|ref|, RMS) "
                  f"(tol {tol})")
            if not rel <= tol:
                ok = False
                print("FAIL: 17(b): the ring is not within tolerance")
    for rk in ranks:
        r = rk["rank"]
        for causal in (False, True):
            c = rk["ring"]["launches"][str(causal)]
            want = r + 1 if causal else RING_RANKS
            got = [c["K1"], c["K2"], c["K3"]]
            print(f"17(b) rank {r}, causal={causal}: K1/K2/K3 launches "
                  f"{got} (expected {want} each)")
            if got != [want] * 3:
                ok = False
                print("FAIL: 17(b): launches are not the ring's blocks")
    ms = ranks[0]["ring"]["ms"]
    print(f"17(b) rank 0 host ms a call at {RING_SHAPE} bf16 (S_local "
          f"{RING_BLOCK[2]}): forward {ms['fwd_False']:.2f}, causal "
          f"{ms['fwd_True']:.2f}; forward+backward {ms['fwd_bwd_False']:.2f},"
          f" causal {ms['fwd_bwd_True']:.2f}; one staged ppermute of K/V "
          f"({ranks[0]['ring']['ppermute_bytes'] / 1e6:.1f} MB) "
          f"{ms['ppermute']:.2f}; staged {ranks[0]['ring']['host_staged']} "
          f"(gloo, both ranks on one card) on {smi}")
    return ok


def _dlrm_report(ranks, ref, smi):
    ok = True
    saved = torch.load(SLICE17_DIR / "dlrm.pt")
    tol = TOL[torch.float32]
    rep = saved["replicated"]
    same = rep["losses"] == ref["losses"] and all(
        torch.equal(rep["mlp"][k], ref["mlp"][k]) for k in ref["mlp"]) and \
        torch.equal(rep["rows"], ref["rows"]) and \
        [rk["dlrm"]["replicated"]["fp"] for rk in ranks] == ref["fp"]
    r0 = ranks[0]["dlrm"]
    print(f"17(d) DLRM on {{\"tp\": {RING_RANKS}}}, the table vocab-sharded "
          f"(block, {DLRM_VOCAB // RING_RANKS:,} rows a rank), replicated "
          f"mode, {DLRM_CHECK_STEPS} steps: losses, MLP, {DLRM_CHECK_ROWS} "
          f"touched rows and each shard's fingerprint bitwise the one-process"
          f" run's: {same}; losses {[round(v, 5) for v in rep['losses']]}; "
          f"step median {r0['replicated']['step_ms']:.2f} ms; exchange bytes "
          f"{r0['replicated']['exchange']} vs exchange_cost_bytes "
          f"{r0['replicated']['exchange_cost']} on {smi}")
    if not same:
        ok = False
        print("FAIL: 17(d): the replicated mode is not bitwise one process")
    sh = saved["sharded"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(sh["losses"],
                                                       ref["losses"]))
    par = max([_update_error(sh["mlp"][k], ref["mlp"][k], ref["mlp0"][k])
               for k in ref["mlp"]] +
              [_update_error(sh["rows"], ref["rows"], ref["rows0"])])
    moved = [_moved_rows(r, ref["rows0"]).size == ref["rows0"].shape[0]
             for r in (ref["rows"], sh["rows"])]
    print(f"17(d) sharded mode (batch split, all_to_all dispatch): losses "
          f"rel {loss_rel:.3g}, MLP and touched rows' updates {par:.3g} of "
          f"the one-process run's (tol {tol}); every checked row moved: one "
          f"process {moved[0]}, sharded {moved[1]}; "
          f"step median {r0['sharded']['step_ms']:.2f} ms; exchange bytes "
          f"{r0['sharded']['exchange']} vs exchange_cost_bytes "
          f"{r0['sharded']['exchange_cost']}")
    if not (loss_rel <= tol and par <= tol and all(moved) and
            r0["sharded"]["mode"] == "sharded"):
        ok = False
        print("FAIL: 17(d): the sharded mode is not within tolerance")
    for rk in ranks:
        for mode in ("replicated", "sharded"):
            d = rk["dlrm"][mode]
            if d["exchange"] != d["exchange_cost"]:
                ok = False
                print(f"FAIL: 17(d): rank {rk['rank']} {mode}: the exchange "
                      "counter is not exchange_cost_bytes")
    return ok


def thin_modules(smi: str):
    """17(e): ``Features`` on the card and ``TensorInspector`` over a card
    tensor."""
    feats = runtime.Features()
    x = torch.tensor([[1.0, -2.0], [float("nan"), float("inf")]],
                     device=_dev())
    ti = TensorInspector(x, tag="card")
    checks = (ti.check_value("nan"), ti.check_value("abnormal"),
              ti.check_value("negative"))
    ok = feats.is_enabled("CUDA") and not feats.is_enabled("TPU") and \
        feats.card == torch.cuda.get_device_name(0) and \
        checks == ([(1, 0)], [(1, 0), (1, 1)], [(0, 1)])
    print(f"17(e) Features: CUDA {feats.is_enabled('CUDA')}, CUDNN "
          f"{feats.is_enabled('CUDNN')}, NCCL {feats.is_enabled('NCCL')}, "
          f"TPU {feats.is_enabled('TPU')}, card {feats.card!r}; "
          f"TensorInspector on a card tensor: nan {checks[0]}, abnormal "
          f"{checks[1]}, negative {checks[2]} on {smi}")
    if not ok:
        print("FAIL: 17(e)")
    return ok


def phase_slice17(seed: int, smi: str):
    """Phase 17: ring attention on K1-K3 over {"sp": 2}, DLRM at MLPerf's
    widths on one process and vocab-sharded over two ranks, the thin
    top-level modules."""
    SLICE17_DIR.mkdir(parents=True, exist_ok=True)
    t_phase = time.perf_counter()
    blocks = ring_block_times(seed, smi)
    refs, ok = ring_single(seed, smi)
    ref, rec, ok_c = dlrm_one_process(seed, smi)
    ok = ok_c and ok
    ok = dlrm_card_vs_cpu(seed, smi) and ok
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, MXNET_DIST_TIMEOUT="300",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    from mxnet_tpu_torch.tools import launch
    proc = launch.run(RING_RANKS, SLICE17_WORKER + ["--seed", str(seed)],
                      SLICE17_JOB_TIMEOUT, env)
    ranks = _job_lines(proc, RING_RANKS, "phase 17's two-rank job")
    print(f"17 job: backend {ranks[0]['backend']}")
    ok = _ring_report(ranks, refs, smi) and ok
    ok = _dlrm_report(ranks, ref, smi) and ok
    ok = thin_modules(smi) and ok
    shutil.rmtree(SLICE17_DIR, ignore_errors=True)
    if not ok:
        raise SystemExit("FAIL: phase 17")
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s")
    per_rank = {k: sum(ranks[0]["ring"]["launches"][c][k]
                       for c in ("False", "True")) for k in ("K1", "K2", "K3")}
    return {"hand": per_rank, "blocks": blocks, "dlrm": rec}


# ---------------------------------------------------------------------------
# phase 18: training resilience on BERT-base
# ---------------------------------------------------------------------------
SLICE18_DIR = Path(__file__).resolve().parent / "build" / "phase_resilience"
RES_STEPS = 8                  # (a)-(d): steps of the BERT-base run
RES_CRASH_AFTER = 5            # (b): the process dies after this step
RES_SAVE_EVERY = 2             # (b): a checkpoint every this many steps
RES_NAN_AT = 3                 # (c): nan_grad injected at this step
RES_CHECK_EVERY = 4            # (c): the guard's window
RES_PREEMPT_AT = 4             # (d): the notice polled after this step
RES_NONDET_STEPS = 3           # the check without deterministic algorithms
RES_RETRY_TURNS = 3            # (f): clean and faulted steps, in turns
RES_LAYERS = 4                 # (a)-(d), (f) and the nondeterministic
# check: BERT at full width with 4 of its 12 layers (a depth cut for the
# script's time: the checkpoint is 0.62 GB instead of 1.32 GB)
RES_TP_LAYERS = 2              # (e): BERT at full width, 2 layers, tp=2
RES_TP_STEPS, RES_TP_MORE = 3, 2
RES_DLRM_STEPS = 4
# (e): DLRM's table cut to 1,048,576 rows (its widths kept) for the sharded
# save and restore, which at 17(c)'s 2^23 rows took 22 s of the phase
RES_DLRM_VOCAB = DLRM_VOCAB // 8
SLICE18_WORKER = [sys.executable, str(Path(__file__).resolve()),
                  "--slice18-worker"]
SLICE18_TIMEOUT = 600
# cuBLAS keeps its reductions' order only with a fixed workspace; set
# before the process's first cuBLAS handle
RES_DET_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}


def _res_step(named, seed, layers=None, mesh=None, tp=False):
    """Phase 4's BERT-base step (bf16 over f32 masters, Adam, dropout 0.1)
    under a RetryPolicy without backoff sleeps."""
    from mxnet_tpu_torch.resilience import RetryPolicy
    step = _bert_step(named, mesh or make_mesh({"dp": 1}), 0.1, "bfloat16",
                      tp=tp, layers=layers, seed=seed)
    step._retry = RetryPolicy(max_attempts=4, base_ms=0.0, seed=seed)
    return step


def _res_loader(host):
    """A seeded shuffling DataLoader over the run's rows: each batch is
    (tokens, token types, positions, MLM labels, NSP labels)."""
    toks, (mlm, nsp), tt, pos = (a.reshape((-1,) + a.shape[2:])
                                 if isinstance(a, np.ndarray) else
                                 tuple(b.reshape((-1,) + b.shape[2:])
                                       for b in a) for a in host)
    return gdata.DataLoader(gdata.ArrayDataset(toks, tt, pos, mlm, nsp),
                            batch_size=TRAIN_BATCH, shuffle=True)


def _res_args(batch):
    toks, tt, pos, mlm, nsp = (a._data for a in batch)
    return toks, (mlm, nsp), tt, pos


def _res_digest(step):
    """sha256 over every parameter, aux state and optimizer state leaf of
    ``step`` (its state_dict's arrays, in order)."""
    import hashlib
    st = step.state_dict()
    h = hashlib.sha256()
    for k in sorted(st["params"], key=lambda k: int(k[1:])):
        h.update(st["params"][k].tobytes())
    for j in sorted(st["opt"], key=lambda k: int(k[1:])):
        for k in sorted(st["opt"][j], key=lambda k: int(k[1:])):
            h.update(st["opt"][j][k].tobytes())
    return h.hexdigest()


def _res_other(named):
    """Weights other than the run's (a restore must overwrite them)."""
    return {k: v * np.float32(0.5) for k, v in named.items()}


def _res_run(step, loader, n, start=0, after=None):
    """Steps ``start + 1`` .. ``n`` from ``loader`` (``after(i)`` after
    step i; True stops); the losses and each step's host ms."""
    losses, ms = [], []
    i = start
    for b in loader:
        i += 1
        t0 = time.perf_counter()
        losses.append(step(*_res_args(b)).item())
        ms.append((time.perf_counter() - t0) * 1e3)
        if (after and after(i)) or i >= n:
            break
    return losses, ms


def resilience_det(seed: int):
    """18(a)-(d) and (f) in this process, which runs under
    ``torch.use_deterministic_algorithms(True)`` with cuBLAS's workspace
    fixed (``chip_smoke.py --slice18-worker det``); one JSON dict."""
    from mxnet_tpu_torch.resilience import (CheckpointManager, NumericsGuard,
                                            PreemptionGuard, faults)
    torch.use_deterministic_algorithms(True)
    named = _first_layers(seeded_bert_weights(BERTForPretraining(
        bert_base(max_length=TRAIN_SEQ)), seed), RES_LAYERS)
    host = pretrain_batch(np.random.default_rng(seed + 18), RES_STEPS,
                          TRAIN_BATCH, TRAIN_SEQ, TRAIN_P)
    out, t_phase = {}, time.perf_counter()
    fa.launches = fa.launches_dq = fa.launches_dkv = 0
    computed = 0                        # steps whose compute ran

    # (a) the uninterrupted control
    random.seed(seed)
    step = _res_step(named, seed, layers=RES_LAYERS)
    want, ms_a = _res_run(step, _res_loader(host), RES_STEPS)
    want_digest = _res_digest(step)
    computed += RES_STEPS
    out["layers"] = len(step._block.inner.backbone.encoder._layers)
    out["a"] = {"losses": want, "digest": want_digest,
                "step_ms": float(np.median(ms_a[1:]))}
    del step
    torch.cuda.empty_cache()

    # (b) OOM every 3rd attempt, async checkpoints every 2 steps, a crash
    # after step 5, a new step from other weights, restore_latest
    d_b = SLICE18_DIR / "b"
    random.seed(seed)
    loader = _res_loader(host)
    step = _res_step(named, seed, layers=RES_LAYERS)
    cm = CheckpointManager(str(d_b), keep=2, async_save=True)
    blocked, fault_ms, clean_ms = [], [], []

    def save_every(i):
        if i % RES_SAVE_EVERY == 0:
            t0 = time.perf_counter()
            cm.save(i, train_step=step, dataloader=loader)
            blocked.append((time.perf_counter() - t0) * 1e3)
        return False

    got = []
    with faults.inject("device_oom", every_n=3) as oom:
        i = 0
        for b in loader:
            i += 1
            fires = oom.fires
            t0 = time.perf_counter()
            got.append(step(*_res_args(b)).item())
            (fault_ms if oom.fires > fires else clean_ms).append(
                (time.perf_counter() - t0) * 1e3)
            save_every(i)
            if i == RES_CRASH_AFTER:
                break
        computed += RES_CRASH_AFTER
        cm.wait()                 # the step-4 checkpoint has landed
        crashed = False
        try:
            with faults.inject("crash", site="train_step", every_n=1,
                               times=1):
                step(*_res_args(next(iter(loader))))
        except faults.SimulatedCrash:
            crashed = True
        del step, loader, cm
        torch.cuda.empty_cache()
        random.seed(seed + 99)            # the new process's own seed
        loader = _res_loader(host)
        step = _res_step(_res_other(named), seed + 99,
                              layers=RES_LAYERS)
        cm = CheckpointManager(str(d_b), keep=2, async_save=True)
        t0 = time.perf_counter()
        restored = cm.restore_latest(train_step=step, dataloader=loader)
        restore_ms = (time.perf_counter() - t0) * 1e3
        resumed_at = restored[0]
        got = got[:resumed_at]
        more, _ = _res_run(step, loader, RES_STEPS, start=resumed_at,
                           after=save_every)
        got += more
        computed += RES_STEPS - resumed_at
        cm.wait()
    out["b"] = {"losses": got, "bitwise": got == want
                and _res_digest(step) == want_digest, "crashed": crashed,
                "resumed_at": resumed_at, "oom_fires": oom.fires,
                "restore_ms": restore_ms, "ckpt_bytes": cm.last_save_bytes,
                "async_blocked_ms": blocked,
                "faulted_step_ms": fault_ms, "clean_step_ms": clean_ms}
    # (f) one synchronous save of the same state; then a fault's retry
    # cost with no writer running: steps in turns clean and with one
    # device_oom, each synchronized
    cm_sync = CheckpointManager(str(SLICE18_DIR / "f"), keep=1)
    t0 = time.perf_counter()
    cm_sync.save(RES_STEPS, train_step=step, dataloader=loader)
    sync_s = time.perf_counter() - t0
    turns = {False: [], True: []}
    for k in range(2 * RES_RETRY_TURNS):
        faulty = bool(k % 2)
        with faults.inject("device_oom", every_n=1,
                           times=1 if faulty else 0):
            t0 = time.perf_counter()
            step(*_at(host, 0))
            torch.cuda.synchronize()
            turns[faulty].append((time.perf_counter() - t0) * 1e3)
    computed += 2 * RES_RETRY_TURNS
    out["f"] = {"sync_save_ms": sync_s * 1e3,
                "sync_mb_s": cm_sync.last_save_bytes / 1e6 / sync_s,
                "ckpt_bytes": cm_sync.last_save_bytes,
                "retry_overhead_ms": float(np.median(turns[True])
                                           - np.median(turns[False])),
                "step_ms_turns": turns[False], "faulted_ms_turns":
                turns[True]}
    del step, loader, cm, cm_sync
    shutil.rmtree(d_b, ignore_errors=True)
    shutil.rmtree(SLICE18_DIR / "f", ignore_errors=True)
    torch.cuda.empty_cache()

    # (c) NumericsGuard, nan_grad at step 3: bitwise the run without it
    placed = [_at(host, i) for i in range(RES_STEPS)]
    step = _res_step(named, seed, layers=RES_LAYERS)
    guard = NumericsGuard(check_every_n=RES_CHECK_EVERY, policy="skip")
    guard.attach(step)
    ms_c = []
    with faults.inject("nan_grad", at=(RES_NAN_AT,)):
        for i in range(RES_STEPS):
            t0 = time.perf_counter()
            step(*placed[i])
            torch.cuda.synchronize()
            ms_c.append((time.perf_counter() - t0) * 1e3)
    guard.finalize()
    snap_bytes = guard.snapshot_bytes()
    digest_c = _res_digest(step)
    computed += RES_STEPS + RES_STEPS - guard.skipped_steps
    boundaries = guard.checks["clean"] + guard.checks["anomaly"]
    out["c"] = {"skipped": guard.skipped_steps,
                "anomaly": guard.last_anomaly, "host_reads": guard.host_reads,
                "boundaries": boundaries, "recoveries": guard.recoveries,
                "snapshot_bytes": snap_bytes,
                "guarded_step_ms": float(np.median(
                    [m for i, m in enumerate(ms_c)
                     if (i + 1) % RES_CHECK_EVERY])),
                "boundary_ms": [m for i, m in enumerate(ms_c)
                                if (i + 1) % RES_CHECK_EVERY == 0]}
    del step, guard
    torch.cuda.empty_cache()
    step = _res_step(named, seed, layers=RES_LAYERS)
    ms_o = []
    for i in range(RES_STEPS):
        if i == RES_NAN_AT - 1:
            continue
        t0 = time.perf_counter()
        step(*placed[i])
        torch.cuda.synchronize()
        ms_o.append((time.perf_counter() - t0) * 1e3)
    computed += RES_STEPS - 1
    out["c"]["bitwise"] = _res_digest(step) == digest_c
    out["c"]["unguarded_step_ms"] = float(np.median(ms_o[1:]))
    del step, placed
    torch.cuda.empty_cache()

    # (d) an injected preemption notice at step 4, the flush, the marker,
    # then a new step from other weights resumes
    d_d = SLICE18_DIR / "d"
    random.seed(seed)
    loader = _res_loader(host)
    step = _res_step(named, seed, layers=RES_LAYERS)
    cm = CheckpointManager(str(d_d), keep=2, async_save=True)
    pg = PreemptionGuard(cm, capture=dict(train_step=step,
                                          dataloader=loader))
    with pg, faults.inject("preempt", at=(RES_PREEMPT_AT,)):
        got, _ = _res_run(step, loader, RES_STEPS,
                          after=lambda i: pg.should_stop(i))
    computed += len(got)
    flush = dict(pg.last_flush)
    del step, loader, cm, pg
    torch.cuda.empty_cache()
    cm = CheckpointManager(str(d_d), keep=2)
    info = PreemptionGuard.resume_info(cm)
    random.seed(seed + 7)
    loader = _res_loader(host)
    step = _res_step(_res_other(named), seed + 7, layers=RES_LAYERS)
    restored = cm.restore_latest(train_step=step, dataloader=loader)
    more, _ = _res_run(step, loader, RES_STEPS, start=restored[0])
    computed += len(more)
    got += more
    out["d"] = {"losses": got, "bitwise": got == want
                and _res_digest(step) == want_digest, "flush": flush,
                "marker": info, "resumed_at": restored[0]}
    del step, loader, cm
    shutil.rmtree(d_d, ignore_errors=True)
    torch.cuda.synchronize()
    out["launches"] = {"K1": fa.launches, "K2": fa.launches_dq,
                       "K3": fa.launches_dkv}
    out["computed_steps"] = computed
    out["seconds"] = time.perf_counter() - t_phase
    return out


def resilience_tp(seed: int):
    """18(e) on one rank of {"tp": 2} (``chip_smoke.py --slice18-worker
    tp``): the 2-layer BERT's sharded checkpoint after 3 steps and 2 more
    steps; DLRM at MLPerf widths (RES_DLRM_VOCAB rows) vocab-sharded,
    without and with
    ``emb_exchange`` every 2nd dispatch under ``retry=``, and its sharded
    checkpoint. Rank 0 writes the gathered states."""
    from mxnet_tpu_torch.parallel import collectives
    from mxnet_tpu_torch.resilience import (CheckpointManager, RetryPolicy,
                                            faults)
    mesh = make_mesh({"tp": 2})
    rank = collectives.rank()
    named = _first_layers(seeded_bert_weights(BERTForPretraining(
        bert_base(max_length=TRAIN_SEQ)), seed), RES_TP_LAYERS)
    batches = _bert_batches(seed, RES_TP_STEPS + RES_TP_MORE)
    step = _res_step(named, seed, layers=RES_TP_LAYERS, mesh=mesh, tp=True)
    placed = step.place_batch_n(*batches)
    fa.launches = fa.launches_dq = fa.launches_dkv = 0
    losses = _run_steps(step, placed, RES_TP_STEPS)
    cm = CheckpointManager(str(SLICE18_DIR / "tp"), keep=1)
    t0 = time.perf_counter()
    cm.save(RES_TP_STEPS, train_step=step, sharded=True)
    save_ms = (time.perf_counter() - t0) * 1e3
    state = step.state_dict()
    if rank == 0:
        np.savez(SLICE18_DIR / "tp_state.npz", **_res_flat(state))
    for i in range(RES_TP_STEPS, RES_TP_STEPS + RES_TP_MORE):
        losses.append(step(*_at(placed, i)).item())
    counts = {"K1": fa.launches, "K2": fa.launches_dq, "K3": fa.launches_dkv}
    full = _host_params(step, gathered=True)
    if rank == 0:
        torch.save(full, SLICE18_DIR / "tp_after.pt")
    res = {"bert": {"losses": losses, "launches": counts,
                    "steps": RES_TP_STEPS + RES_TP_MORE,
                    "shard_save_ms": save_ms,
                    "ckpt_bytes": cm.last_save_bytes}}
    del step, placed, state, full
    torch.cuda.empty_cache()

    dl = dlrm_batches(seed, RES_DLRM_STEPS, RES_DLRM_VOCAB)
    runs = []
    for faulty in (False, True):
        table, st = dlrm_step(mesh, seed, "sharded", RES_DLRM_VOCAB)
        st._retry = RetryPolicy(max_attempts=3, base_ms=0.0, seed=seed)
        with faults.inject("emb_exchange", every_n=2 if faulty else 10 ** 9
                           ) as inj:
            dl_losses = [st(b) for b in dl]
        runs.append({"losses": dl_losses, "fires": inj.fires,
                     "fp": _fingerprint([table.weight]).item(),
                     "mlp": _mlp_host(st)})
        if faulty:
            cm = CheckpointManager(str(SLICE18_DIR / "dlrm"), keep=1,
                                   fsync=False)
            t0 = time.perf_counter()
            cm.save(RES_DLRM_STEPS, train_step=st, sharded=True)
            dl_save_ms = (time.perf_counter() - t0) * 1e3
            if rank == 0:
                torch.save(runs[-1]["mlp"], SLICE18_DIR / "dlrm_mlp.pt")
        del table, st
        torch.cuda.empty_cache()
    plain, faulty = runs
    res["dlrm"] = {"losses": faulty["losses"], "fires": faulty["fires"],
                   "fp": faulty["fp"],
                   "retry_bitwise": plain["losses"] == faulty["losses"]
                   and plain["fp"] == faulty["fp"]
                   and all(torch.equal(plain["mlp"][k], faulty["mlp"][k])
                           for k in plain["mlp"]),
                   "shard_save_ms": dl_save_ms,
                   "ckpt_bytes": cm.last_save_bytes}
    return res


def _res_flat(state):
    out = {f"params_{k}": v for k, v in state["params"].items()}
    for j, leaves in state["opt"].items():
        out.update({f"opt_{j}_{k}": v for k, v in leaves.items()})
    return out


def slice18_worker(mode: str, seed: int) -> int:
    """Phase 18's subprocesses: ``det`` (18(a)-(d), (f)) alone, ``tp`` one
    rank of 18(e)'s two-rank job; one JSON line."""
    if mode == "det":
        res = resilience_det(seed)
        os.write(1, (json.dumps(res) + "\n").encode())
        return 0
    from mxnet_tpu_torch.parallel import collectives
    res = resilience_tp(seed)
    res.update(rank=collectives.rank(), backend=collectives.backend())
    os.write(1, (json.dumps(res) + "\n").encode())  # one write: shared pipe
    collectives.barrier()
    return 0


def _res_nondeterministic(seed: int):
    """(a)'s control twice for RES_NONDET_STEPS steps in this process,
    without deterministic algorithms: bitwise or not (reported)."""
    named = _first_layers(seeded_bert_weights(BERTForPretraining(
        bert_base(max_length=TRAIN_SEQ)), seed), RES_LAYERS)
    host = pretrain_batch(np.random.default_rng(seed + 18), RES_STEPS,
                          TRAIN_BATCH, TRAIN_SEQ, TRAIN_P)
    runs = []
    for _ in range(2):
        random.seed(seed)
        step = _res_step(named, seed, layers=RES_LAYERS)
        losses, _ = _res_run(step, _res_loader(host), RES_NONDET_STEPS)
        runs.append((losses, _res_digest(step)))
        del step
        torch.cuda.empty_cache()
    return runs[0] == runs[1]


def _res_tp_report(ranks, seed, smi):
    """18(e) in this process: the two-rank checkpoints restored on one
    process against the job's states."""
    from mxnet_tpu_torch.resilience import CheckpointManager
    ok = True
    r0 = ranks[0]
    d = SLICE18_DIR / "tp" / f"ckpt-{RES_TP_STEPS:08d}"
    shards = sorted(f for f in os.listdir(d) if f.startswith("shard-"))
    named = _first_layers(seeded_bert_weights(BERTForPretraining(
        bert_base(max_length=TRAIN_SEQ)), seed), RES_TP_LAYERS)
    batches = _bert_batches(seed, RES_TP_STEPS + RES_TP_MORE)
    want = dict(np.load(SLICE18_DIR / "tp_state.npz"))
    cm = CheckpointManager(str(SLICE18_DIR / "tp"))
    conts = []
    for control in (False, True):
        step = _res_step(_res_other(named), seed + 3, layers=RES_TP_LAYERS)
        t0 = time.perf_counter()
        cm.restore_latest(train_step=step)
        restore_ms = (time.perf_counter() - t0) * 1e3
        if not control:
            got = _res_flat(step.state_dict())
            same = sorted(got) == sorted(want) and all(
                np.array_equal(got[k], want[k]) for k in want)
        handles = _row_split_hooks(step._block) if control else []
        placed = step.place_batch_n(*batches)
        losses = [step(*_at(placed, i)).item() for i in
                  range(RES_TP_STEPS, RES_TP_STEPS + RES_TP_MORE)]
        for h in handles:
            h.remove()
        conts.append((losses, _host_params(step)))
        del step, placed
        torch.cuda.empty_cache()
    job = torch.load(SLICE18_DIR / "tp_after.pt")
    job_losses = r0["bert"]["losses"][RES_TP_STEPS:]
    control = _bert_distance(conts[1][0], conts[1][1], conts[0][0],
                             conts[0][1], TRAIN_LR)
    limit = _limits(control)
    reading = _bert_distance(job_losses, job, conts[0][0], conts[0][1],
                             TRAIN_LR)
    b = r0["bert"]
    exp = RES_TP_LAYERS * b["steps"]
    print(f"18(e) BERT full width, {RES_TP_LAYERS} layers, {{\"tp\": 2}} "
          f"(two ranks on one card over {r0['backend']}): sharded save after "
          f"{RES_TP_STEPS} steps {shards} ({b['ckpt_bytes']} B, "
          f"{b['shard_save_ms']:.1f} ms on rank 0); restored on one process "
          f"in {restore_ms:.1f} ms, bitwise the job's gathered state: "
          f"{same}; the next {RES_TP_MORE} steps vs the job's: reading "
          f"{json.dumps(reading)}, control (row-parallel products split in "
          f"two) {json.dumps(control)}, limit {json.dumps(limit)}; K1-K3 "
          f"launches a rank {[rk['bert']['launches'] for rk in ranks]} "
          f"(expected {exp} each) on {smi}")
    if shards != ["shard-00000.npz", "shard-00001.npz"] or not same:
        ok = False
        print("FAIL: 18(e) the sharded BERT checkpoint")
    if not _within(reading, limit):
        ok = False
        print("FAIL: 18(e) the restored run is beyond its control's limit")
    if any(n != exp for rk in ranks for n in rk["bert"]["launches"].values()):
        ok = False
        print("FAIL: 18(e) K1-K3 launches do not match one a layer-step")

    dl = [rk["dlrm"] for rk in ranks]
    d = SLICE18_DIR / "dlrm" / f"ckpt-{RES_DLRM_STEPS:08d}"
    shards = sorted(f for f in os.listdir(d) if f.startswith("shard-"))
    one = make_mesh({"tp": 1})
    table = ShardedEmbedding(RES_DLRM_VOCAB, DLRM_DIM, one, axis="tp")
    step = DLRMTrainStep(table, **DLRM_CFG, lr=DLRM_LR, seed=seed + 1)
    t0 = time.perf_counter()
    CheckpointManager(str(SLICE18_DIR / "dlrm")).restore_latest(
        train_step=step)
    restore_ms = (time.perf_counter() - t0) * 1e3
    halves = _halves_fp(table.weight)
    mlp = torch.load(SLICE18_DIR / "dlrm_mlp.pt")
    same = halves == [x["fp"] for x in dl] and all(
        torch.equal(v.cpu(), mlp[k]) for k, v in step.mlp.items())
    print(f"18(e) DLRM at MLPerf widths, a {RES_DLRM_VOCAB:,}-row table "
          f"vocab-sharded over 2 ranks (sharded mode, {RES_DLRM_STEPS} "
          f"steps): emb_exchange every 2nd "
          f"dispatch under retry= ({[x['fires'] for x in dl]} fires) bitwise "
          f"the run without faults: {[x['retry_bitwise'] for x in dl]}; "
          f"sharded save {shards} ({dl[0]['ckpt_bytes']} B, "
          f"{dl[0]['shard_save_ms']:.1f} ms on rank 0, no fsync), restored "
          f"on one process in {restore_ms:.1f} ms, bitwise (each half's "
          f"fingerprint, the MLP): {same} on {smi}")
    if shards != ["shard-00000.npz", "shard-00001.npz"] or not same \
            or not all(x["retry_bitwise"] for x in dl):
        ok = False
        print("FAIL: 18(e) DLRM")
    del table, step
    torch.cuda.empty_cache()
    return ok


def phase_resilience(seed: int, smi: str):
    """Phase 18: training resilience on BERT-base through K1-K3."""
    shutil.rmtree(SLICE18_DIR, ignore_errors=True)
    SLICE18_DIR.mkdir(parents=True, exist_ok=True)
    t_phase = time.perf_counter()
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, **RES_DET_ENV, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    proc = subprocess.run(SLICE18_WORKER + ["det", "--seed", str(seed)],
                          env=env, capture_output=True, text=True,
                          timeout=SLICE18_TIMEOUT)
    if proc.returncode != 0:
        print(proc.stdout[-3000:])
        print(proc.stderr[-6000:])
        raise SystemExit(f"FAIL: 18(a)-(d) exited {proc.returncode}")
    det = json.loads([ln for ln in proc.stdout.splitlines()
                      if ln.startswith("{")][-1])
    fa.launches = fa.launches_dq = fa.launches_dkv = 0
    nondet = _res_nondeterministic(seed)
    nondet_counts = {"K1": fa.launches, "K2": fa.launches_dq,
                     "K3": fa.launches_dkv}
    env = dict(env, MXNET_DIST_TIMEOUT="300")
    from mxnet_tpu_torch.tools import launch
    job = launch.run(2, SLICE18_WORKER + ["tp", "--seed", str(seed)],
                     SLICE18_TIMEOUT, env)
    ranks = _job_lines(job, 2, "phase 18's two-rank job")
    ok = True
    a, b, c, d, f = (det[k] for k in "abcdf")
    exp = det["layers"] * det["computed_steps"]
    print(f"18 in a process under torch.use_deterministic_algorithms(True) "
          f"and CUBLAS_WORKSPACE_CONFIG={RES_DET_ENV['CUBLAS_WORKSPACE_CONFIG']}"
          f" ({det['seconds']:.1f} s): BERT at full width with "
          f"{det['layers']} layers, bf16 over f32 masters, "
          f"Adam, dropout 0.1, {TRAIN_BATCH} x {TRAIN_SEQ} (P = {TRAIN_P}) "
          f"from a seeded shuffling DataLoader; K1-K3 launches "
          f"{det['launches']} (expected {det['layers']} x "
          f"{det['computed_steps']} computed steps = {exp} each)")
    print(f"18(a) control: {RES_STEPS} steps, losses "
          f"{[round(v, 5) for v in a['losses']]}, step median "
          f"{a['step_ms']:.1f} ms (host clock to a fetched loss) on {smi}")
    print(f"18(b) device_oom every 3rd attempt ({b['oom_fires']} fires), "
          f"async checkpoints every {RES_SAVE_EVERY} steps (keep 2), a crash "
          f"after step {RES_CRASH_AFTER} (raised: {b['crashed']}), a new "
          f"step from other weights restored at step {b['resumed_at']} and "
          f"run to {RES_STEPS}: losses and every parameter and state "
          f"bitwise (a)'s: {b['bitwise']}")
    print(f"18(c) NumericsGuard(check_every_n={RES_CHECK_EVERY}), nan_grad "
          f"at step {RES_NAN_AT}: {c['skipped']} step skipped "
          f"({c['anomaly']['kind']} at t={c['anomaly']['t']}, "
          f"{c['anomaly']['action']}), bitwise the run without that batch: "
          f"{c['bitwise']}; {c['host_reads']} host reads of the health "
          f"scalars over {c['boundaries']} verified window(s) and "
          f"{c['recoveries']} recovery (one a verified window, one a "
          f"replay); step median {c['guarded_step_ms']:.1f}"
          f" ms guarded vs {c['unguarded_step_ms']:.1f} ms without "
          f"(synchronized each step), boundary steps "
          f"{[round(x, 1) for x in c['boundary_ms']]} ms (the last replays "
          f"{RES_STEPS - 1} steps); snapshots on the card "
          f"{c['snapshot_bytes']} B on {smi}")
    fl = d["flush"]
    print(f"18(d) preemption notice after step {RES_PREEMPT_AT}: flush "
          f"{fl['flush_elapsed_s']:.3f} s of a {fl['deadline_s']} s deadline "
          f"(saved {fl['saved']}, within {fl['within_deadline']}), marker "
          f"step {d['marker'] and d['marker']['step']}; resumed at step "
          f"{d['resumed_at']} from other weights, bitwise (a)'s: "
          f"{d['bitwise']} on {smi}")
    blocked = b["async_blocked_ms"]
    print(f"18(f) checkpoint {f['ckpt_bytes']} B; sync save "
          f"{f['sync_save_ms']:.1f} ms ({f['sync_mb_s']:.0f} MB/s, fsync, "
          f"sha256 manifest); the loop blocked under an async save "
          f"{[round(x, 1) for x in blocked]} ms; restore_latest "
          f"{b['restore_ms']:.1f} ms; retry overhead a fault "
          f"{f['retry_overhead_ms']:.2f} ms (median of {RES_RETRY_TURNS} "
          f"steps with one device_oom less {RES_RETRY_TURNS} without, "
          f"synchronized, no writer running, no backoff sleep; clean "
          f"{[round(x, 1) for x in f['step_ms_turns']]} ms, faulted "
          f"{[round(x, 1) for x in f['faulted_ms_turns']]}); guard "
          f"snapshots {c['snapshot_bytes']} B on {smi}")
    print(f"18 without deterministic algorithms (this process): "
          f"{RES_NONDET_STEPS} steps of (a) twice bitwise: {nondet}")
    for what, good in (("(b)", b["bitwise"] and b["crashed"]
                        and b["resumed_at"] == 4),
                       ("(c)", c["bitwise"] and c["skipped"] == 1
                        and c["host_reads"] <= c["boundaries"]
                        + c["recoveries"]),
                       ("(d)", d["bitwise"] and fl["saved"]
                        and fl["within_deadline"] and d["marker"]
                        and d["marker"]["step"] == RES_PREEMPT_AT),
                       ("launches", all(n == exp for n in
                                        det["launches"].values()))):
        if not good:
            ok = False
            print(f"FAIL: 18{what}")
    ok = _res_tp_report(ranks, seed, smi) and ok
    shutil.rmtree(SLICE18_DIR, ignore_errors=True)
    if not ok:
        raise SystemExit("FAIL: phase 18")
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s")
    return {"det": det["launches"], "nondet": nondet_counts,
            "tp": ranks[0]["bert"]["launches"]}


# ---------------------------------------------------------------------------
# phase 19: the pipelined multi-tenant server, hot swap, failover, the pool
# ---------------------------------------------------------------------------
SERVE19_DIR = Path(__file__).resolve().parent / "build" / "phase_serving19"
SERVE_DEVICE = "cuda"          # where every served response must lie
# tenant: (sequence length, largest bucket, SLO ms, clients, requests a
# client, most rows a request)
S19_TENANTS = {"bert512": (512, 32, 1000.0, 4, 24, 8),
               "bert128": (128, 8, 50.0, 4, 48, 2)}
S19_SCRIPT = {"bert512": (1, 3, 8, 2, 5, 7, 4, 6),   # (b): rows a request
              "bert128": (1, 2, 1, 2, 2, 1)}
S19_SWAP_CLIENTS = 2           # (c): clients a tenant while swapping
S19_FAILOVER_REQS = 12         # (d): requests of bert128 a drill
S19_WEDGE_S = 1.5              # (d): the hung step's length
S19_STALL_S = 0.25             # (d): the watchdog's stall threshold
S19_POOL_QUEUE = 32            # (e): rows a replica admits
S19_POOL_CLIENTS = 16          # (e): burst clients, 1-4 rows a request
S19_POOL_HEDGED = 8            # (e): hedged requests, one row each


def _s19_request(rng, seq, max_rows):
    r = int(rng.integers(1, max_rows + 1))
    return (rng.integers(0, 30522, (r, seq), dtype=np.int32),
            rng.integers(0, 2, (r, seq), dtype=np.int32))


def _s19_net(named):
    net = bert_base()
    load_jax_params(net, named, ctx=gpu())
    return net.to(torch.bfloat16).eval()


def _s19_endpoint(name, net, tenant):
    seq, top = S19_TENANTS[tenant][:2]
    return serving.ModelEndpoint(name, net, [(seq,), (seq,)], dtype="int32",
                                 max_batch_size=top, ctx=gpu())


def _s19_executed(ep):
    c = ep.stats.snapshot()["counters"]
    return c["batches"] + c["warmup_batches"] + c["swap_probes"]


def _s19_drive(submit, plan, seed, until=None):
    """Closed-loop clients: ``plan`` maps tenant -> (clients, requests a
    client or None to run until ``until`` is set, request maker); returns
    {tenant: [(inputs, outputs, latency s)]}, the wall s and the errors."""
    results = {n: [] for n in plan}
    errors = []
    lock = threading.Lock()

    def client(name, i, per, make):
        rng = np.random.default_rng(seed * 1000 + i)
        k = 0
        while (k < per) if per is not None else not until.is_set():
            x = make(rng)
            t0 = time.perf_counter()
            try:
                out = submit(name, x).result(timeout=300)
            except Exception as e:    # surfaced by the caller; phase fails
                errors.append(f"{name}: {e!r}")
                break
            with lock:
                results[name].append((x, out, time.perf_counter() - t0))
            k += 1

    threads = [threading.Thread(target=client, args=(n, 97 * j + i, per, mk))
               for j, (n, (clients, per, mk)) in enumerate(plan.items())
               for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    return results, threads, errors, t0


def _s19_join(threads, t0):
    for t in threads:
        t.join(600)
    if any(t.is_alive() for t in threads):
        raise SystemExit("FAIL: phase 19 clients did not finish")
    return time.perf_counter() - t0


def _s19_excess(net, responses):
    """Worst |served - direct| - (2e-2 + 2e-2 |direct|) (<= 0 passes) over
    ``responses``, per response; each response must lie on the card and be
    finite."""
    out = []
    with torch.inference_mode():
        for x, outs, _ in responses:
            want = net(*(torch.from_numpy(a).to(SERVE_DEVICE) for a in x))
            worst = -1.0
            for a, b in zip(outs, want):
                if a.device.type != SERVE_DEVICE or \
                        not torch.isfinite(a.float()).all():
                    raise SystemExit("FAIL: a response is off the card or "
                                     "not finite")
                a, b = a.float(), b.float()
                worst = max(worst, ((a - b).abs() - (2e-2 + 2e-2 * b.abs()))
                            .max().item())
            out.append(worst)
    return out


def _s19_quantiles(lat_s):
    a = np.asarray(lat_s) * 1e3
    return float(np.percentile(a, 50)), float(np.percentile(a, 99))


def _s19_k1_tally(nets):
    """K1 launches by model: the change of ``fa.launches`` over each of its
    forwards (one worker runs one forward at a time)."""
    tally = {n: 0 for n in nets}
    start = {}

    def pre(name):
        def hook(module, args):
            start[name] = fa.launches
        return hook

    def post(name):
        def hook(module, args, out):
            tally[name] += fa.launches - start[name]
        return hook

    handles = []
    for name, net in nets.items():
        handles.append(torch.nn.Module.register_forward_pre_hook(
            net, pre(name)))
        handles.append(torch.nn.Module.register_forward_hook(
            net, post(name)))
    return tally, handles


def _s19_multitenant(seed, smi, nets, layers):
    """(a) two tenants on one server, pipelined and serial; (b) bitwise."""
    ok = True
    served = {}
    runs = {}
    tally, handles = _s19_k1_tally(nets)
    for pipe in (True, False):
        tag = "pipelined" if pipe else "serial"
        for n in tally:
            tally[n] = 0
        fa.launches = 0
        eps = {n: _s19_endpoint(f"{n}_{tag}", nets[n], n) for n in nets}
        server = serving.InferenceServer(batch_timeout_ms=2.0, max_queue=512,
                                         pipeline=pipe)
        for n, ep in eps.items():
            server.register(ep, slo_ms=S19_TENANTS[n][2])
        server.start()
        plan = {}
        for n in eps:
            seq, _, _, clients, per, rows = S19_TENANTS[n]
            plan[eps[n].name] = (clients, per, lambda rng, s=seq, r=rows:
                                 _s19_request(rng, s, r))
        results, threads, errors, t0 = _s19_drive(server.submit, plan, seed)
        wall = _s19_join(threads, t0)
        overlap = server.health()["prep_overlap_ratio"]
        server.stop(drain=True)
        launches = fa.launches
        if errors:
            raise SystemExit(f"FAIL: 19(a) client errors {errors[:3]}")
        runs[tag] = {"launches": launches, "overlap": overlap}
        for n, ep in eps.items():
            snap = ep.stats.snapshot()
            res = results[ep.name]
            served[(tag, n)] = res
            exp = layers * _s19_executed(ep)
            lat = [r[2] for r in res]
            p50, p99 = _s19_quantiles(lat)
            slo_ms = S19_TENANTS[n][2]
            met = sum(v * 1e3 <= slo_ms for v in lat) / len(lat)
            qw, pr = snap["queue_wait"], snap["prep"]
            print(f"19(a) {tag} {n} (S={S19_TENANTS[n][0]}, buckets "
                  f"{ep.buckets[0]}-{ep.buckets[-1]}, SLO {slo_ms:g} ms): "
                  f"{len(res)} requests in {snap['counters']['batches']} "
                  f"batches, {len(res) / wall:.2f} requests/s, p50 "
                  f"{p50:.2f} ms, p99 {p99:.2f} ms, SLO met {met:.3f}, queue "
                  f"wait p50 {qw['p50_us'] / 1e3:.2f} ms p99 "
                  f"{qw['p99_us'] / 1e3:.2f} ms, prep p50 {pr['p50_us']:.0f} "
                  f"us p99 {pr['p99_us']:.0f} us, step p50 "
                  f"{snap['step']['p50_us'] / 1e3:.2f} ms; K1 launches "
                  f"{tally[n]} (expected {layers} x {_s19_executed(ep)} = "
                  f"{exp}) on {smi}")
            if tally[n] != exp:
                ok = False
                print(f"FAIL: 19(a) {tag} {n}: K1 launches")
            if snap["counters"]["completed"] != len(res):
                ok = False
                print(f"FAIL: 19(a) {tag} {n}: completed "
                      f"{snap['counters']['completed']} of {len(res)}")
        print(f"19(a) {tag}: wall {wall:.2f} s, prep overlap ratio "
              f"{overlap:.3f}, K1 launches {launches} (both tenants)")
        if launches != sum(tally.values()):
            ok = False
            print("FAIL: 19(a) K1 launches outside the tenants' forwards")
    for h in handles:
        h.remove()
    # phase 3's traffic (one tenant, 8 closed-loop clients) on both paths
    for pipe in (True, False):
        tag = "pipelined" if pipe else "serial"
        fa.launches = 0
        ep = _s19_endpoint(f"bert512_alone_{tag}", nets["bert512"], "bert512")
        server = serving.InferenceServer(batch_timeout_ms=2.0, max_queue=512,
                                         pipeline=pipe)
        server.register(ep)
        server.start()
        results, threads, errors, t0 = _s19_drive(
            server.submit, {ep.name: (N_CLIENTS, REQS_PER_CLIENT, lambda rng:
                                      _s19_request(rng, SEQ_LEN, 8))}, seed)
        wall = _s19_join(threads, t0)
        server.stop(drain=True)
        launches = fa.launches
        runs[tag]["launches"] += launches
        snap = ep.stats.snapshot()
        p50, p99 = _s19_quantiles([r[2] for r in results[ep.name]])
        print(f"19(a) {tag} bert512 alone, phase 3's traffic ({N_CLIENTS} "
              f"clients x {REQS_PER_CLIENT} requests of 1-8 rows): "
              f"{len(results[ep.name]) / wall:.2f} requests/s in "
              f"{snap['counters']['batches']} batches, occupancy "
              f"{snap['batch_occupancy']:.3f}, p50 {p50:.2f} ms, p99 "
              f"{p99:.2f} ms, step p50 {snap['step']['p50_us'] / 1e3:.2f} "
              f"ms, prep overlap {server.health()['prep_overlap_ratio']:.3f}; "
              f"K1 launches {launches} (expected {layers} x "
              f"{_s19_executed(ep)})")
        if errors or launches != layers * _s19_executed(ep):
            ok = False
            print(f"FAIL: 19(a) {tag} bert512 alone: errors {errors[:2]} or "
                  "K1 launches")

    # (b) every response of (a) against the direct forward, on the card
    worst = max(max(_s19_excess(nets[n], res))
                for (tag, n), res in served.items())
    print(f"19(b) {sum(len(r) for r in served.values())} responses of (a) "
          f"vs the direct forward: max(|d| - tol) = {worst:.4g} (pass if "
          f"<= 0, tol 2e-2 + 2e-2 |direct|), every one on the card")
    ok = ok and worst <= 0
    # a scripted stream, one request at a time: pipelined and serial
    # assemble the same rows into the same buckets
    fa.launches = 0
    outs, executed = {}, 0
    rng = np.random.default_rng(seed + 19)
    script = [(n, _s19_request_rows(rng, S19_TENANTS[n][0], r))
              for n in nets for r in S19_SCRIPT[n]]
    for pipe in (True, False):
        tag = "pipelined" if pipe else "serial"
        eps = {n: _s19_endpoint(f"{n}_script_{tag}", nets[n], n)
               for n in nets}
        server = serving.InferenceServer(batch_timeout_ms=1.0, pipeline=pipe)
        for ep in eps.values():
            server.register(ep, warmup=False)
        server.start()
        outs[tag] = [server.predict(eps[n].name, x, timeout=300)
                     for n, x in script]
        server.stop(drain=True)
        executed += sum(_s19_executed(ep) for ep in eps.values())
    same = all(torch.equal(a, b) for pa, pb in zip(outs["pipelined"],
                                                   outs["serial"])
               for a, b in zip(pa, pb))
    script_launches = fa.launches
    print(f"19(b) scripted stream ({len(script)} requests, "
          f"{[n for n, _ in script].count('bert512')} of bert512): "
          f"pipelined byte for byte the serial path: {same}; K1 launches "
          f"{script_launches} (expected {layers} x {executed} = "
          f"{layers * executed})")
    ok = ok and same and script_launches == layers * executed
    return ok, runs, script_launches


def _s19_request_rows(rng, seq, rows):
    return (rng.integers(0, 30522, (rows, seq), dtype=np.int32),
            rng.integers(0, 2, (rows, seq), dtype=np.int32))


def _s19_hot_swap(seed, smi, nets, named, layers):
    """(c) three hot-swap cycles under load, then two refused swaps."""
    ok = True
    shutil.rmtree(SERVE19_DIR, ignore_errors=True)
    SERVE19_DIR.mkdir(parents=True, exist_ok=True)
    base = named["bert512"]
    sets = {"base": base,
            "w1": seeded_bert_weights(bert_base(), seed + 101),
            "w2": seeded_bert_weights(bert_base(), seed + 102)}
    dirs = {}
    t0 = time.perf_counter()
    for tag in ("w1", "w2"):
        src = _s19_endpoint(f"bert512_src_{tag}", _s19_net(sets[tag]),
                            "bert512")
        dirs[tag] = str(SERVE19_DIR / tag)
        src.save_checkpoint(CheckpointManager(dirs[tag], fsync=False), 1,
                            probe_seed=seed + 7)
        serving.unregister(src.name)
        del src
    save_s = time.perf_counter() - t0
    fa.launches = 0
    eps = {n: _s19_endpoint(f"{n}_swap", nets[n], n) for n in nets}
    server = serving.InferenceServer(batch_timeout_ms=2.0, max_queue=512,
                                     pipeline=True)
    for n, ep in eps.items():
        server.register(ep, slo_ms=S19_TENANTS[n][2])
    server.start()
    stop = threading.Event()
    plan = {eps[n].name: (S19_SWAP_CLIENTS, None,
                          lambda rng, s=S19_TENANTS[n][0],
                          r=S19_TENANTS[n][5]: _s19_request(rng, s, r))
            for n in nets}
    results, threads, errors, t_load = _s19_drive(server.submit, plan,
                                                  seed + 3, until=stop)
    swap_s, reports = [], []
    try:
        time.sleep(0.5)
        for tag in ("w1", "w2", "w1"):
            t1 = time.perf_counter()
            reports.append(server.hot_swap("bert512_swap", dirs[tag],
                                           timeout=300))
            swap_s.append(time.perf_counter() - t1)
            time.sleep(0.3)
    finally:
        stop.set()
        _s19_join(threads, t_load)
    ep = eps["bert512"]
    epochs = [r["weights_epoch"] for r in reports]
    # two refused swaps: a corrupt checkpoint and a probe mismatch
    probe_x = _s19_request_rows(np.random.default_rng(seed + 5), 512, 2)
    before = server.predict("bert512_swap", probe_x, timeout=300)
    wrong = verify_checkpoint_dir(os.path.join(dirs["w2"], "ckpt-00000001"))
    wrong["model"]["params"]["p0"] = wrong["model"]["params"]["p0"] + 1.0
    npz = os.path.join(dirs["w2"], "ckpt-00000001", "state.npz")
    raw = bytearray(Path(npz).read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    Path(npz).write_bytes(bytes(raw))
    refused = {}
    for what, source in (("corrupt", dirs["w2"]), ("probe mismatch", wrong)):
        try:
            server.hot_swap("bert512_swap", source, timeout=300)
            refused[what] = "swapped"
        except serving.HotSwapError as e:
            refused[what] = str(e)
    after = server.predict("bert512_swap", probe_x, timeout=300)
    server.stop(drain=True)
    launches = fa.launches
    executed = sum(_s19_executed(e) for e in eps.values())
    kept = all(torch.equal(a, b) for a, b in zip(before, after))
    errs = len(errors)
    # every response within tolerance of the old or the new weights
    chk = {tag: _s19_net(w) for tag, w in sets.items()}
    res512 = results["bert512_swap"]
    matches = np.min([_s19_excess(chk[t], res512) for t in chk], axis=0)
    worst512 = float(matches.max()) if len(res512) else 0.0
    worst128 = max(_s19_excess(nets["bert128"], results["bert128_swap"]))
    lat = [r[2] for r in res512]
    p50, p99 = _s19_quantiles(lat)
    print(f"19(c) hot swap under load: 2 checkpoints saved in {save_s:.1f} s "
          f"(BERT-base f32 in CheckpointManager's format, recorded probes); "
          f"3 cycles w1, w2, w1 in {[round(s, 2) for s in swap_s]} s "
          f"(verify + stage + probe + cutover), weights_epoch "
          f"{ep.weights_epoch} (reports {epochs}); "
          f"{len(res512)} + {len(results['bert128_swap'])} requests "
          f"served during the swaps, {errs} errors, bert512 p50 {p50:.2f} "
          f"ms p99 {p99:.2f} ms; each bert512 response within tolerance of "
          f"the base, w1 or w2 weights' direct forward: max(|d| - tol) "
          f"{worst512:.4g}, bert128 {worst128:.4g}; refused: "
          f"{ {k: v[:60] for k, v in refused.items()} }; the "
          f"old weights kept serving bitwise: {kept}; K1 launches {launches} "
          f"(expected {layers} x {executed} = {layers * executed}) on {smi}")
    ok = (ok and errs == 0 and epochs == [1, 2, 3] and ep.weights_epoch == 3
          and worst512 <= 0 and worst128 <= 0 and kept
          and "checksum" in refused["corrupt"]
          and "rolled back" in refused["probe mismatch"]
          and launches == layers * executed)
    shutil.rmtree(SERVE19_DIR, ignore_errors=True)
    return ok, launches


def _s19_failover(seed, smi, nets, layers):
    """(d) a worker death and a wedge under a PoolSupervisor."""
    ok = True
    launches = 0
    old_hook = threading.excepthook

    def quiet(args):                  # the drill's killed worker
        if not isinstance(args.exc_value, faults.WorkerKilled):
            old_hook(args)

    threading.excepthook = quiet
    try:
        for drill in ("worker_kill", "wedge"):
            fa.launches = 0
            ep = _s19_endpoint(f"bert128_{drill}", nets["bert128"],
                               "bert128")
            server = serving.InferenceServer(
                batch_timeout_ms=2.0, max_queue=512, pipeline=True,
                watchdog_stall_s=S19_STALL_S if drill == "wedge" else None)
            server.register(ep)
            server.start()
            sup = serving.PoolSupervisor(server, poll_s=0.02).start()
            marks = []
            server.add_stall_listener(
                lambda name, dt: marks.append(time.perf_counter() - dt))
            rng = np.random.default_rng(seed + 23)
            xs = [_s19_request(rng, 128, 2) for _ in range(S19_FAILOVER_REQS)]
            done = [None] * len(xs)

            def stamp(i):
                return lambda f: done.__setitem__(i, time.perf_counter())

            def killed(kind, site, count):
                marks.append(time.perf_counter())
                return faults.WorkerKilled(kind, site, count, False,
                                           "drill: worker killed")

            rule = (faults.inject("worker_kill", site="serving_dispatch",
                                  at=(2,), exc=killed)
                    if drill == "worker_kill" else
                    faults.inject("hang", site="serving_dispatch",
                                  seconds=S19_WEDGE_S, at=(2,)))
            with rule as inj:
                futs = []
                for i, x in enumerate(xs):
                    f = server.submit(ep.name, x)
                    f.add_done_callback(stamp(i))
                    futs.append(f)
                outs = [f.result(timeout=300) for f in futs]
                fires = inj.fires
            time.sleep(S19_WEDGE_S + 0.2 if drill == "wedge" else 0.0)
            sup.stop()
            server.stop(drain=True)
            drill_launches = fa.launches
            launches += drill_launches
            snap = ep.stats.snapshot()["counters"]
            executed = _s19_executed(ep)
            excess = max(_s19_excess(nets["bert128"],
                                     [(x, o, 0) for x, o in zip(xs, outs)]))
            rep = sup.reports[0] if sup.reports else {}
            recover = (max(done) - marks[0]) * 1e3 if marks else float("nan")
            print(f"19(d) {drill}: {fires} fault(s), failover "
                  f"{rep.get('reason')} (epoch {rep.get('epoch')}), "
                  f"{rep.get('requeued')} requests requeued, "
                  f"{snap['completed']} of {len(xs)} completed once "
                  f"(submitted {snap['submitted']}), max(|d| - tol) "
                  f"{excess:.4g}; recovered {recover:.1f} ms after the "
                  f"fault; K1 launches {drill_launches} (expected {layers} x "
                  f"{executed} = {layers * executed}) on {smi}")
            want = "worker_dead" if drill == "worker_kill" else \
                "worker_wedged"
            if not (fires == 1 and rep.get("reason") == want
                    and rep.get("requeued", 0) >= 1
                    and snap["completed"] == len(xs) == snap["submitted"]
                    and excess <= 0
                    and drill_launches == layers * executed):
                ok = False
                print(f"FAIL: 19(d) {drill}")
    finally:
        threading.excepthook = old_hook
    return ok, launches


def _s19_pool(seed, smi, named, layers):
    """(e) a ServingPool of up to two replicas under an Autoscaler."""
    ok = True
    for obj in slo.MONITOR.objectives():  # (a)-(d)'s objectives are done
        slo.MONITOR.unregister(obj.name)
    built = []

    def factory(rid):
        net = _s19_net(named["bert128"])
        ep = _s19_endpoint("bert128_pool", net, "bert128")
        built.append((net, ep))
        srv = serving.InferenceServer(batch_timeout_ms=2.0,
                                      max_queue=S19_POOL_QUEUE,
                                      pipeline=True)
        srv.register(ep, slo_ms=1000.0)
        return srv

    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    fa.launches = 0
    t0 = time.perf_counter()
    pool = serving.ServingPool(factory, initial_replicas=1)
    scaler = serving.Autoscaler(pool, min_replicas=1, max_replicas=2,
                                poll_s=0.1, up_n=2, down_n=5,
                                cooldown_s=0.5, queue_high=0.5,
                                queue_low=0.05).start()
    shed = [0]

    def submit(name, x):
        while True:
            try:
                return pool.submit(name, x)
            except serving.ServerOverloadError:
                shed[0] += 1          # backpressure: back off and resubmit
                time.sleep(0.005)

    # a burst: queue pressure scales the pool up
    stop = threading.Event()
    burst, threads, errors, tb = _s19_drive(
        submit, {"bert128_pool": (S19_POOL_CLIENTS, None, lambda rng:
                                  _s19_request(rng, 128, 4))},
        seed + 29, until=stop)
    limit = time.perf_counter() + 60
    while pool.size() < 2 and time.perf_counter() < limit:
        time.sleep(0.05)
    up_s = time.perf_counter() - tb
    time.sleep(0.5)                   # both replicas serve the burst
    stop.set()
    _s19_join(threads, tb)
    scaler.stop()
    peak = torch.cuda.max_memory_allocated()
    replicas = [r.server for r in pool._rotation()]
    # hedged responses bitwise the unhedged ones of a replica
    rng = np.random.default_rng(seed + 31)
    xs = [_s19_request_rows(rng, 128, 1) for _ in range(S19_POOL_HEDGED)]
    alone = [[srv.predict("bert128_pool", x, timeout=300) for x in xs]
             for srv in replicas]
    knobs = {"MXNET_HEDGE_ENABLE": True, "MXNET_HEDGE_BUDGET_RATIO": 1.0,
             "MXNET_HEDGE_DELAY_MIN_MS": 0.0, "MXNET_HEDGE_DELAY_FACTOR": 0.0}
    saved = {k: mt_config.get(k) for k in knobs}
    for k, v in knobs.items():
        mt_config.set(k, v)
    tailguard.hedge_reset()
    before = dict(tailguard.hedge_counts)
    hedged = []
    try:
        for x in xs:
            # an empty latency ring: the hedge delay is 0 for each request
            tailguard.HEDGER.reset()
            hedged.append(pool.submit("bert128_pool", x).result(timeout=300))
    finally:
        for k, v in saved.items():
            mt_config.set(k, v)
        tailguard.hedge_reset()
    hedges = {k: tailguard.hedge_counts[k] - before[k] for k in before}
    bitwise = all(any(all(torch.equal(a, b) for a, b in zip(h, ref[i]))
                      for ref in alone) for i, h in enumerate(hedged))
    replicas_agree = all(torch.equal(a, b) for i in range(len(xs))
                         for a, b in zip(alone[0][i], alone[-1][i]))
    # quiet: the pool drains back to one replica, dropping nothing
    quiet_stop = threading.Event()
    trickle, threads, q_errors, tq = _s19_drive(
        pool.submit, {"bert128_pool": (2, None, lambda rng:
                                       _s19_request(rng, 128, 1))},
        seed + 37, until=quiet_stop)
    scaler.start()
    limit = time.perf_counter() + 30
    while pool.size() > 1 and time.perf_counter() < limit:
        time.sleep(0.05)
    time.sleep(0.3)
    quiet_stop.set()
    _s19_join(threads, tq)
    scaler.stop()
    after_quiet = pool.size()
    pool.stop(drain=True)
    wall = time.perf_counter() - t0
    launches = fa.launches
    # the replicas share one endpoint name, so one batches child counts
    # every replica's batches: the first replica's share covers the pool
    executed = built[0][1].stats.counters["batches"] + sum(
        ep.stats.counters["warmup_batches"] + ep.stats.counters["swap_probes"]
        for _, ep in built)
    responses = burst["bert128_pool"] + trickle["bert128_pool"]
    excess = max(_s19_excess(built[0][0], responses))
    actions = [(a["action"], a["replicas"], a["queue_pressure"])
               for a in scaler.actions]
    weights_b = sum(t.numel() * t.element_size()
                    for t in built[0][0].state_dict().values())
    print(f"19(e) pool of {len(built)} replicas built (its own server, "
          f"streams and weights each): burst of {S19_POOL_CLIENTS} "
          f"clients ({len(burst['bert128_pool'])} requests, {shed[0]} "
          f"overload resubmits) scaled up in {up_s:.2f} s; actions "
          f"{actions}; quiet: back to {after_quiet} replica(s) with "
          f"{len(trickle['bert128_pool'])} requests served during the "
          f"drain, errors {len(errors) + len(q_errors)}; hedged "
          f"{len(xs)}: bitwise a replica's unhedged response {bitwise} "
          f"(replicas agree bitwise: {replicas_agree}), hedges {hedges}; "
          f"every response within tolerance (max(|d| - tol) {excess:.4g}); "
          f"peak memory {peak / 2**30:.2f} GiB, {(peak - base_bytes) / 2**30:.2f} "
          f"GiB above the {base_bytes / 2**30:.2f} GiB held before the pool "
          f"({weights_b / 2**20:.0f} MiB of weights a replica); K1 "
          f"launches {launches} (expected "
          f"{layers} x {executed} = {layers * executed}); {wall:.1f} s on "
          f"{smi}")
    ups = [a for a in actions if a[0] == "up"]
    downs = [a for a in actions if a[0] == "down"]
    ok = (ok and ups and downs and not errors and not q_errors
          and bitwise and hedges["requests"] >= len(xs) // 2
          and excess <= 0
          and launches == layers * executed and after_quiet == 1)
    tailguard.BROWNOUT.reset()
    return ok, launches, peak


def phase_multitenant(seed: int, smi: str):
    """Phase 19: the pipelined multi-tenant server on BERT-base."""
    t_phase = time.perf_counter()
    named = {"bert512": seeded_bert_weights(bert_base(), seed),
             "bert128": seeded_bert_weights(bert_base(), seed + 1)}
    nets = {n: _s19_net(w) for n, w in named.items()}
    layers = len(nets["bert512"].encoder._layers)
    ok_a, runs, script = _s19_multitenant(seed, smi, nets, layers)
    ok_c, swap = _s19_hot_swap(seed, smi, nets, named, layers)
    ok_d, failover = _s19_failover(seed, smi, nets, layers)
    ok_e, pool, peak = _s19_pool(seed, smi, named, layers)
    for part, good in (("(a)-(b)", ok_a), ("(c)", ok_c), ("(d)", ok_d),
                       ("(e)", ok_e)):
        if not good:
            print(f"FAIL: 19{part}")
    if not (ok_a and ok_c and ok_d and ok_e):
        raise SystemExit("FAIL: phase 19")
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s")
    return {"serving_pipelined": runs["pipelined"]["launches"],
            "serving_serial": runs["serial"]["launches"],
            "serving_bitwise": script, "serving_hot_swap": swap,
            "serving_failover": failover, "serving_pool": pool}


# ---------------------------------------------------------------------------
# phase 20: the executable cache and the serving fabric
# ---------------------------------------------------------------------------
SLICE20_DIR = Path(__file__).resolve().parent / "build" / "phase_fabric20"
SLICE20_WORKER = [sys.executable, str(Path(__file__).resolve()),
                  "--slice20-worker"]
S20_WORKER_TIMEOUT = 300
S20_BWD_SHAPE = (2, 12, 128, 64)     # (a): K2 and K3 through the cache
S20_K4_SHAPE = (512, 256, 256)       # (a): K4 (M, K, N)
S20_RTC_N = 1 << 20                  # (a): values a run-time kernel takes
S20_SCRIPT = (1, 3, 8, 2, 5, 7, 4, 6, 16, 32, 11, 1)   # (b): rows a request
S20_CLIENTS, S20_PER_CLIENT = 4, 8   # (b): closed-loop clients, requests
S20_DECODE_SEQS, S20_DECODE_TOKENS = 8, 16             # (c)
# (d): tenant -> (sequence length, rows a request = the top bucket, so a
# batch is one request and a response one forward of its own rows)
S20_FD_TENANTS = {"fd_bert512": (512, 4), "fd_bert128": (128, 2)}
S20_FD_CLIENTS = 4                   # (d): closed-loop clients a tenant
S20_FD_WINDOW_S = 2.0                # (d): load before, between, after
S20_FD_HOSTS = ("h0", "h1", "h2")
#: the libraries (in load order: the poison drill counts cache loads)
S20_LIBS = (("K1", lambda: fa._kernel(), fa._LIB_NAME),
            ("K2+K3", lambda: fa._bwd_kernels(), fa._BWD_LIB_NAME),
            ("K4", lambda: fc._kernel(), fc._LIB_NAME))
S20_POISONED = 4                     # (c)'s poisoned load: the first cubin


def _s20_kernel_outputs(seed: int):
    """K1 at the serving shape, K2 and K3, K4 and every rtc example kernel
    on seeded inputs, on the card; returned on the host."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    q, k, v = (_randn(BERT_SHAPE, gen, torch.bfloat16) for _ in range(3))
    scale = BERT_SHAPE[-1] ** -0.5
    out["K1 out"], out["K1 lse"] = fa.flash_attention_fwd(q, k, v, scale,
                                                          False)
    q, k, v, do = (_randn(S20_BWD_SHAPE, gen, torch.bfloat16)
                   for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, scale, False)
    out["K2 dq"], delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse,
                                                    scale, False)
    out["K3 dk"], out["K3 dv"] = fa.flash_attention_bwd_dkv(
        q, k, v, do, lse, delta, scale, False)
    out["K4 y"], out["K4 sum"], out["K4 sumsq"] = fc.conv1x1_bn_act(
        *_k4_inputs(gen, *S20_K4_SHAPE, torch.bfloat16))
    x = nd.NDArray(torch.randn(S20_RTC_N, generator=gen, device="cuda"))
    y = nd.NDArray(torch.randn(S20_RTC_N, generator=gen, device="cuda"))
    xb = nd.NDArray(_randn((S20_RTC_N,), gen, torch.bfloat16))
    dy = nd.NDArray(_randn((S20_RTC_N,), gen, torch.bfloat16))
    rows = nd.NDArray(_randn((256, 4096), gen, torch.bfloat16))
    out["axpy"] = rx.axpy(x, y)
    out["scale"] = rx.scale(x)
    out["k"] = rx.identity(x)
    out["gelu_tanh_fwd"] = rx.gelu_tanh_fwd(xb)
    out["gelu_tanh_bwd"] = rx.gelu_tanh_bwd(xb, dy)
    out["log_softmax"] = rx.log_softmax(rows)
    twice = _s20_twice().get_kernel("twice<float>",
                                    "const float *x, int n, float *o")
    out["twice<float>"] = twice.launch([x, x.size], grid_dims=(
        S20_RTC_N // 256, 1, 1), block_dims=(256, 1, 1),
        out_shapes=[x.shape])
    return {n: (t.data if isinstance(t, nd.NDArray) else t).cpu()
            for n, t in out.items()}


_S20_TWICE = []


def _s20_twice():
    if not _S20_TWICE:
        _S20_TWICE.append(rtc.CudaModule(TEMPLATED_SOURCE,
                                          exports=("twice<float>",)))
    return _S20_TWICE[0]


def slice20_worker(mode: str, seed: int) -> int:
    """Phase 20(a)'s process ``mode``: A fills the store from nothing, B
    reads it (with a build directory of its own, so only the cache can
    spare a compile), C reads it with the first cubin's entry poisoned.
    Prints one JSON line; writes its kernels' outputs beside the store."""
    from mxnet_tpu_torch.cache import executable_cache as xc
    out_dir = Path(os.environ["S20_OUT"])
    if mode != "A":
        _build.BUILD_DIR = out_dir / f"build_{mode}"
    xc.reset_stats()
    rule = faults.inject("cache_poison", at=(S20_POISONED,)) \
        if mode == "C" else contextlib.nullcontext()
    libs, cubins = {}, {}
    with rule:
        for label, load, name in S20_LIBS:
            t0 = time.perf_counter()
            load()
            log = _build.build_log(name)
            libs[label] = {"ms": (time.perf_counter() - t0) * 1e3,
                           "source": log["source"],
                           "built_by": _build.built_by(Path(log["path"]))}
        sources = sorted(set(rx.SOURCES.values()))
        for src in sources + ["templated (exports twice<float>)"]:
            t0 = time.perf_counter()
            mod = rx.module(src) if src in sources else _s20_twice()
            t1 = time.perf_counter()
            lowered = next(iter(mod._lowered.values()), None) or next(
                n for n, s in rx.SOURCES.items() if s == src)
            mod._function(lowered, 0)         # cuModuleLoadData on the card
            cubins[src] = {"hit": mod.cache_hit,
                           "nvrtc_ms": mod.compile_seconds * 1e3,
                           "construct_ms": (t1 - t0) * 1e3,
                           "module_load_ms":
                               (time.perf_counter() - t1) * 1e3}
    outs = _s20_kernel_outputs(seed)
    torch.cuda.synchronize()
    torch.save(outs, out_dir / f"outputs_{mode}.pt")
    print(json.dumps({"mode": mode, "libs": libs, "cubins": cubins,
                      "toolkit": _build.nvcc_version(),
                      "stats": xc.stats()}))
    return 0


def _s20_cache(seed: int, smi: str) -> bool:
    """(a) the executable cache across three processes."""
    shutil.rmtree(SLICE20_DIR, ignore_errors=True)
    store = SLICE20_DIR / "store"
    store.mkdir(parents=True)
    env = dict(os.environ, MXNET_EXEC_CACHE_DIR=str(store),
               S20_OUT=str(SLICE20_DIR))
    rep = {}
    for mode in "ABC":
        t0 = time.perf_counter()
        proc = subprocess.run(SLICE20_WORKER + [mode, "--seed", str(seed)],
                              env=env, capture_output=True, text=True,
                              timeout=S20_WORKER_TIMEOUT)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:])
            raise SystemExit(f"FAIL: 20(a) worker {mode} exited "
                             f"{proc.returncode}")
        rep[mode] = json.loads(proc.stdout.strip().splitlines()[-1])
        rep[mode]["wall_s"] = time.perf_counter() - t0
    outs = {m: torch.load(SLICE20_DIR / f"outputs_{m}.pt") for m in "ABC"}
    n_libs, n_cubins = len(S20_LIBS), len(rep["A"]["cubins"])
    ok = True
    for m in "ABC":
        s = rep[m]["stats"]
        same = all(torch.equal(outs[m][n], outs["A"][n]) for n in outs["A"])
        print(f"20(a) process {m} ({rep[m]['wall_s']:.1f} s): hits "
              f"{s['hits']}, misses {s['misses_by_reason']}, stores "
              f"{s['stores']}, compiles {s['compiles']}, load "
              f"{s['load_s'] * 1e3:.1f} ms, store {s['bytes']} bytes; "
              f"outputs bitwise process A's: {same} "
              f"({len(outs[m])} tensors: K1 at {BERT_SHAPE} bf16, K2, K3, "
              f"K4, {n_cubins} modules' kernels)")
        for label, lib in rep[m]["libs"].items():
            note = "" if lib["source"] == "exec_cache" else (
                f" (built by nvcc {lib['built_by']}, its note beside the "
                f"file; the key's toolkit, from version.json: "
                f"{rep[m]['toolkit']})")
            print(f"20(a)   {m} {label} library: {lib['source']} in "
                  f"{lib['ms']:.1f} ms{note}")
        for src, c in rep[m]["cubins"].items():
            print(f"20(a)   {m} cubin {src}: "
                  f"{'cache hit' if c['hit'] else 'NVRTC'} "
                  f"{c['nvrtc_ms']:.1f} ms compile, "
                  f"{c['construct_ms']:.1f} ms to the module, "
                  f"{c['module_load_ms']:.2f} ms cuModuleLoadData")
        ok = ok and same
    a, b, c = (rep[m]["stats"] for m in "ABC")
    a_nvcc = sum(lib["source"] == "nvcc" for lib in rep["A"]["libs"].values())
    ok = ok and all(lib["built_by"] == rep["A"]["toolkit"]
                    for lib in rep["A"]["libs"].values())
    ok = ok and a["stores"] == n_libs + n_cubins and \
        a["compiles"] == {"nvcc": a_nvcc, "nvrtc": n_cubins}
    ok = ok and b["hits"] == n_libs + n_cubins and b["misses"] == 0 and \
        b["compiles"] == {"nvcc": 0, "nvrtc": 0} and \
        all(lib["source"] == "exec_cache" for lib in rep["B"]["libs"].values())
    ok = ok and c["misses_by_reason"]["corrupt"] == 1 and c["misses"] == 1 \
        and c["hits"] == n_libs + n_cubins - 1 and c["stores"] == 1 and \
        c["compiles"] == {"nvcc": 0, "nvrtc": 1}
    nvrtc = [v["nvrtc_ms"] for v in rep["A"]["cubins"].values()]
    loads = [v["construct_ms"] + v["module_load_ms"]
             for v in rep["B"]["cubins"].values()]
    print(f"20(a) cubins: NVRTC compile {sum(nvrtc):.1f} ms for "
          f"{len(nvrtc)} modules (A) against {sum(loads):.1f} ms to load "
          f"them from the cache (B); libraries: A "
          f"{sum(v['ms'] for v in rep['A']['libs'].values()):.1f} ms "
          f"({a_nvcc} built by nvcc, the rest reused from build/), B "
          f"{sum(v['ms'] for v in rep['B']['libs'].values()):.1f} ms from "
          f"the cache; C caught the poisoned entry before loading it "
          f"(corrupt {c['misses_by_reason']['corrupt']}), ran NVRTC "
          f"{c['compiles']['nvrtc']} time and nvcc "
          f"{c['compiles']['nvcc']} times; on {smi}")
    shutil.rmtree(SLICE20_DIR, ignore_errors=True)
    return ok


def _s20_sharded_serving(seed: int, smi: str, net, layers: int):
    """(b) ShardedEndpoint on a one-card slice against ModelEndpoint."""
    (sl,) = serving.plan_slices([1], devices=[gpu(0)])
    rng = np.random.default_rng(seed + 20)
    script = [_s19_request_rows(rng, SEQ_LEN, r) for r in S20_SCRIPT]
    runs = {}
    for kind in ("sharded", "plain"):
        if kind == "sharded":
            fa.launches = 0
            ep = serving.ShardedEndpoint(
                "s20_sharded", net, [(SEQ_LEN,), (SEQ_LEN,)], dtype="int32",
                max_batch_size=32, slice_spec=sl)
        else:
            ep = serving.ModelEndpoint("s20_plain", net,
                                       [(SEQ_LEN,), (SEQ_LEN,)],
                                       dtype="int32", max_batch_size=32,
                                       ctx=gpu())
        server = serving.InferenceServer(batch_timeout_ms=1.0, max_queue=512)
        server.register(ep)
        server.start()
        outs = [server.predict(ep.name, x, timeout=300) for x in script]
        results, threads, errors, t0 = _s19_drive(
            server.submit, {ep.name: (S20_CLIENTS, S20_PER_CLIENT,
                                      lambda r: _s19_request(r, SEQ_LEN, 8))},
            seed)
        wall = _s19_join(threads, t0)
        server.stop(drain=True)
        if errors:
            raise SystemExit(f"FAIL: 20(b) {kind} client errors {errors[:2]}")
        runs[kind] = {"outs": outs, "ep": ep, "executed": _s19_executed(ep),
                      "rps": len(results[ep.name]) / wall,
                      "responses": results[ep.name]}
        if kind == "sharded":
            launches = fa.launches
    sh = runs["sharded"]
    same = all(torch.equal(a, b) for pa, pb in zip(sh["outs"],
                                                   runs["plain"]["outs"])
               for a, b in zip(pa, pb))
    excess = max(_s19_excess(net, sh["responses"]))
    ep = sh["ep"]
    print(f"20(b) ShardedEndpoint {ep._device_label()} (capacity "
          f"{ep.capacity}, buckets {ep.buckets[0]}-{ep.buckets[-1]}) serving "
          f"bert_base bf16 at S = {SEQ_LEN}: scripted stream of "
          f"{len(script)} requests bitwise ModelEndpoint's: {same}; "
          f"{S20_CLIENTS} closed-loop clients {sh['rps']:.2f} requests/s "
          f"(ModelEndpoint {runs['plain']['rps']:.2f}), max(|d| - tol) vs "
          f"the direct forward {excess:.4g}; K1 launches {launches} "
          f"(expected {layers} x {sh['executed']} = "
          f"{layers * sh['executed']}) on {smi}")
    ok = same and excess <= 0 and ep.capacity == 1 and \
        launches == layers * sh["executed"]
    ok2, launches2 = _s20_dp2_serving(smi, net, layers, script)
    return ok and ok2, launches, launches2


def _outputs(out):
    return tuple(out) if isinstance(out, (list, tuple)) else (out,)


def _s20_dp2_serving(smi: str, net, layers: int, script):
    """(b) ShardedEndpoint on a two-group slice over the one card, with
    shard_params: every chunk it ran bitwise the direct forward of that
    chunk, 12 K1 launches a chunk, two chunks a batch."""
    (sl,) = serving.plan_slices([2], devices=[gpu(0), gpu(0)])
    ep = serving.ShardedEndpoint(
        "s20_dp2", net, [(SEQ_LEN,), (SEQ_LEN,)], dtype="int32",
        max_batch_size=32, slice_spec=sl, shard_params=True)
    chunks, run = [], ep._placement.run

    def recorded(g, method, args):          # each chunk's inputs, outputs
        out = run(g, method, args)
        chunks.append((g, tuple(a.clone() for a in args),
                       tuple(o.clone() for o in _outputs(out))))
        return out

    ep._placement.run = recorded
    executed0 = _s19_executed(ep)
    fa.launches = 0
    server = serving.InferenceServer(batch_timeout_ms=1.0, max_queue=512)
    server.register(ep)
    server.start()
    t0 = time.perf_counter()
    outs = [server.predict(ep.name, x, timeout=300) for x in script]
    wall = time.perf_counter() - t0
    server.stop(drain=True)
    launches = fa.launches
    batches = _s19_executed(ep) - executed0
    with torch.inference_mode():
        chunk_same = [all(torch.equal(a, b) for a, b in
                          zip(o, _outputs(net(*ins))))
                      for _, ins, o in chunks]
    groups = [sum(g == i for g, *_ in chunks) for i in range(2)]
    shards = [len(ep._placement.shards(g)) for g in range(2)]
    excess = max(_s19_excess(net, [(x, o, 0.0)
                                   for x, o in zip(script, outs)]))
    print(f"20(b) ShardedEndpoint {ep._device_label()} over [gpu(0), "
          f"gpu(0)] (capacity {ep.capacity}, buckets {ep.buckets[0]}-"
          f"{ep.buckets[-1]}, shard_params: {shards} leading-axis shards "
          f"a group, {ep._placement.gathers} gathers): {len(script)} "
          f"scripted requests in {batches} batches, {wall:.2f} s; "
          f"{len(chunks)} chunks ({groups} by group), each bitwise the "
          f"direct forward of that chunk: {all(chunk_same)}; max(|d| - "
          f"tol) of the responses vs the direct forward {excess:.4g}; K1 "
          f"launches {launches} (expected {layers} x 2 x {batches} = "
          f"{layers * 2 * batches}) on {smi}")
    ok = (all(chunk_same) and excess <= 0 and ep.capacity == 2 and
          groups == [batches, batches] and min(shards) > 0 and
          ep._placement.gathers > 0 and launches == layers * 2 * batches)
    return ok, launches


def _s20_batched(eng, prompts, steps: int, base: int):
    for i, p in enumerate(prompts):
        eng.pool.reserve(base + i, len(p) + steps + 1)
    toks = [[eng.prefill(p, eng.pool.table(base + i))]
            for i, p in enumerate(prompts)]
    for s in range(steps):
        nxt = eng.decode_step([(toks[i][-1], len(p) + s,
                                eng.pool.table(base + i))
                               for i, p in enumerate(prompts)])
        for i, t in enumerate(nxt):
            toks[i].append(t)
    for i in range(len(prompts)):
        eng.pool.free(base + i)
    return toks


def _s20_defrag_drill(eng, prompts, steps: int):
    """Two sequences prefilled, the first freed, the pool compacted, then
    the second decoded: (pages moved, its tokens)."""
    a, b = prompts[:2]
    eng.pool.reserve(6000, len(a) + 1)
    eng.prefill(a, eng.pool.table(6000))
    eng.pool.reserve(6001, len(b) + steps + 1)
    toks = [eng.prefill(b, eng.pool.table(6001))]
    eng.pool.free(6000)
    moved = eng.pool.defrag()
    for s in range(steps - 1):
        toks += list(eng.decode_step([(toks[-1], len(b) + s,
                                       eng.pool.table(6001))]))
    eng.pool.free(6001)
    return moved, toks


def _s20_sharded_decode(seed: int, smi: str):
    """(c) ShardedDecodeEndpoint on the one-card slice and on a two-group
    slice over the card, each against DecodeEndpoint, serial and
    batched."""
    lm = _lm(lm_weights(seed), torch.bfloat16)
    slices = {"dp1": serving.plan_slices([1], devices=[gpu(0)])[0],
              "dp2": serving.plan_slices([2], devices=[gpu(0), gpu(0)])[0]}
    toks, launches, info = {}, {}, {}
    for kind in ("plain", "dp1", "dp2"):
        if kind == "plain":
            eng = DecodeEndpoint("s20_dplain", lm, **GEN_ENGINE)
        else:
            fa.launches = 0
            eng = serving.ShardedDecodeEndpoint(
                f"s20_d{kind}", lm, slice_spec=slices[kind], **GEN_ENGINE)
        eng.warmup()
        prompts = gen_prompts(seed, eng.prefill_buckets)[:S20_DECODE_SEQS]
        t0 = time.perf_counter()
        serial = [serial_decode(eng, p, S20_DECODE_TOKENS, 4000 + i)[0]
                  for i, p in enumerate(prompts)]
        batched = _s20_batched(eng, prompts, S20_DECODE_TOKENS - 1, 5000)
        toks[kind] = (serial, batched, time.perf_counter() - t0,
                      _s20_defrag_drill(eng, prompts, S20_DECODE_TOKENS))
        if kind != "plain":
            launches[kind] = fa.launches
            # pages 1.. only: padding rows write scratch page 0, where
            # duplicate slots land in any order and nothing reads unmasked
            k0, v0 = eng.pool.replicas[0]
            info[kind] = (eng.capacity, eng._device_label(), all(
                torch.equal(k[:, 1:], k0[:, 1:]) and
                torch.equal(v[:, 1:], v0[:, 1:])
                for k, v in eng.pool.replicas[1:]))
        del eng
    ps, pb, pt, (pm, pd) = toks["plain"]
    ok = ps == pb and pm > 0
    for kind in ("dp1", "dp2"):
        ss, sb, st, (sm, sd) = toks[kind]
        capacity, label, replicas_same = info[kind]
        print(f"20(c) ShardedDecodeEndpoint {label} (capacity {capacity}, "
              f"{capacity} KV replica(s), their sequences' pages bitwise "
              f"equal after the run: {replicas_same}), TransformerLM at BERT-base width bf16, "
              f"batch {GEN_ENGINE['max_batch_size']}: {len(ss)} sequences "
              f"x {S20_DECODE_TOKENS} tokens serial and batched equal "
              f"DecodeEndpoint's: serial {ss == ps}, batched {sb == pb}, "
              f"batched = serial {ss == sb}; a compaction moved {sm} "
              f"pages (plain {pm}), the tokens after it equal "
              f"DecodeEndpoint's: {sd == pd}; {st:.2f} s against "
              f"{pt:.2f} s; K1 launches {launches[kind]} (prefills, "
              f"causal) on {smi}")
        ok = ok and ss == ps and sb == pb and replicas_same and \
            sm == pm and sd == pd and launches[kind] > 0
    return ok, launches["dp1"], launches["dp2"]


def _s20_frontdoor(seed: int, smi: str, nets, layers: int):
    """(d) a FrontDoor over three hosts on the card: a kill and an agent
    SIGKILL under closed-loop load."""
    def factory(name):
        server = serving.InferenceServer(batch_timeout_ms=2.0, max_queue=512)
        for t, (seq, rows) in S20_FD_TENANTS.items():
            server.register(serving.ModelEndpoint(
                t, nets[t], [(seq,), (seq,)], dtype="int32",
                max_batch_size=rows, ctx=gpu()))
        server.start()
        return server

    fa.launches = 0
    workdir = SLICE20_DIR / "frontdoor"
    workdir.mkdir(parents=True, exist_ok=True)
    fd = serving.FrontDoor(S20_FD_HOSTS, factory, workdir=str(workdir))
    try:
        t_wait = time.perf_counter()
        while any(fd.heartbeat_age(h) is None for h in S20_FD_HOSTS):
            if time.perf_counter() - t_wait > 120:
                raise SystemExit("FAIL: 20(d) an agent never beat")
            time.sleep(0.1)
        ages0 = {h: fd.heartbeat_age(h) for h in S20_FD_HOSTS}
        before = {t: fd.route(t) for t in S20_FD_TENANTS}
        done, errors, stop = [], [], threading.Event()
        lock = threading.Lock()

        def client(t, i):
            seq, rows = S20_FD_TENANTS[t]
            rng = np.random.default_rng(seed * 1000 + 31 * i + seq)
            while not stop.is_set():
                x = _s19_request_rows(rng, seq, rows)
                owner, t0 = fd.route(t), time.perf_counter()
                try:
                    out = fd.submit(t, x).result(timeout=300)
                except Exception as e:    # surfaced below; the phase fails
                    errors.append(f"{t}: {e!r}")
                    return
                with lock:
                    done.append((t, x, out, owner, t0, time.perf_counter()))

        threads = [threading.Thread(target=client, args=(t, i))
                   for t in S20_FD_TENANTS for i in range(S20_FD_CLIENTS)]
        t_start = time.perf_counter()
        for th in threads:
            th.start()
        time.sleep(S20_FD_WINDOW_S)
        victim1 = fd.route("fd_bert512")
        t_k1 = time.perf_counter()
        rep1 = fd.kill_host(victim1)
        time.sleep(S20_FD_WINDOW_S)
        victim2 = fd.route("fd_bert128")          # a survivor
        t_k2 = time.perf_counter()
        os.kill(fd.agent_pid(victim2), signal.SIGKILL)
        reps2 = []
        while not reps2 and time.perf_counter() - t_k2 < 30:
            reps2 = fd.check_hosts()
            time.sleep(0.02)
        t_d2 = time.perf_counter()
        time.sleep(S20_FD_WINDOW_S)
        stop.set()
        for th in threads:
            th.join(300)
        t_end = time.perf_counter()
        launches = fa.launches
        after = {t: fd.route(t) for t in S20_FD_TENANTS}
        ages1 = {h: fd.heartbeat_age(h) for h in fd.alive_hosts()}
        stats = (fd.moves, fd.resubmits, dict(fd.requests_by_host),
                 dict(fd.failovers))
    finally:
        fd.stop()
        for t in S20_FD_TENANTS:
            serving.unregister(t)
        shutil.rmtree(SLICE20_DIR, ignore_errors=True)
    dead = {victim1, victim2}
    moved_ok = all((after[t] != before[t]) == (before[t] in dead)
                   and after[t] not in dead for t in S20_FD_TENANTS)
    n_moved = sum(after[t] != before[t] for t in S20_FD_TENANTS)
    if errors or any(th.is_alive() for th in threads):
        raise SystemExit(f"FAIL: 20(d) client errors {errors[:3]}")
    bitwise = True
    with torch.inference_mode():
        for t, x, out, *_ in done:
            want = nets[t](*(torch.from_numpy(a).cuda() for a in x))
            bitwise = bitwise and all(torch.equal(a, b)
                                      for a, b in zip(out, want))

    def resubmitted(victim, t_kill):
        late = [d[5] - t_kill for d in done
                if d[3] == victim and d[4] < t_kill < d[5]]
        return (f"{len(late)} in flight, the last answered "
                f"{max(late) * 1e3:.1f} ms after it" if late else
                "none in flight")

    n_before = sum(d[5] < t_k1 for d in done)
    n_after = sum(d[4] >= t_d2 for d in done)
    print(f"20(d) FrontDoor over {len(S20_FD_HOSTS)} hosts (each an "
          f"InferenceServer of bert_base bf16 tenants "
          f"{ {t: v[0] for t, v in S20_FD_TENANTS.items()} }, agents on "
          f"gpu(0)), {S20_FD_CLIENTS} clients a tenant: {len(done)} "
          f"responses, 0 client errors, every one bitwise the direct "
          f"forward: {bitwise}; routes {before} -> {after}, {n_moved} "
          f"moved (the dead hosts' tenants only: {moved_ok}); moves "
          f"{stats[0]}, resubmits {stats[1]}, requests by host {stats[2]}, "
          f"failovers {stats[3]}")
    print(f"20(d) kill_host({victim1}, owner of fd_bert512): epoch "
          f"{rep1['epoch']}, moved {rep1['moved']}, "
          f"{resubmitted(victim1, t_k1)}; SIGKILL of {victim2}'s agent: "
          f"check_hosts declared it down ({[r['reason'] for r in reps2]}) "
          f"{(t_d2 - t_k2) * 1e3:.1f} ms later, {resubmitted(victim2, t_k2)}"
          f"; requests/s {n_before / (t_k1 - t_start):.2f} on 3 hosts, "
          f"{n_after / (t_end - t_d2):.2f} on 1; heartbeat ages at start "
          f"{ {h: round(a, 3) for h, a in ages0.items()} } s, at the end "
          f"{ {h: round(a, 3) for h, a in ages1.items()} } s; K1 launches "
          f"{launches} on {smi}")
    ok = (bitwise and moved_ok and len(reps2) == 1 and
          reps2[0]["reason"] == "agent_exit" and victim1 != victim2 and
          launches > 0 and n_after > 0)
    return ok, launches


def phase_fabric(seed: int, smi: str):
    """Phase 20: the executable cache and the serving fabric."""
    t_phase = time.perf_counter()
    ok_a = _s20_cache(seed, smi)
    named = {"fd_bert512": seeded_bert_weights(bert_base(), seed),
             "fd_bert128": seeded_bert_weights(bert_base(), seed + 1)}
    nets = {n: _s19_net(w) for n, w in named.items()}
    layers = len(nets["fd_bert512"].encoder._layers)
    ok_b, serving_launches, serving_dp2 = _s20_sharded_serving(
        seed, smi, nets["fd_bert512"], layers)
    ok_c, decode_launches, decode_dp2 = _s20_sharded_decode(seed, smi)
    ok_d, fd_launches = _s20_frontdoor(seed, smi, nets, layers)
    for part, good in (("(a)", ok_a), ("(b)", ok_b), ("(c)", ok_c),
                       ("(d)", ok_d)):
        if not good:
            print(f"FAIL: 20{part}")
    if not (ok_a and ok_b and ok_c and ok_d):
        raise SystemExit("FAIL: phase 20")
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s")
    return {"sharded_serving": serving_launches,
            "sharded_serving_dp2": serving_dp2,
            "sharded_decode": decode_launches,
            "sharded_decode_dp2": decode_dp2, "frontdoor": fd_launches}


# ---------------------------------------------------------------------------
# phase 21: telemetry and the profiler
# ---------------------------------------------------------------------------
SLICE21_DIR = Path(__file__).resolve().parent / "build" / "phase_telemetry21"
SLICE21_WORKER = [sys.executable, str(Path(__file__).resolve()),
                  "--slice21-worker"]
SLICE21_TIMEOUT = 300
TEL_CLIENTS = 4                # (a): closed-loop clients, 1-8 rows a request
TEL_REQS = 6                   # (a): requests a client
TEL_TRAIN_STEPS = 3            # (c): steps at 64 x 128
TEL_OOM_STEPS = 2              # (d): steps of each run, the first faulted
TEL_COST_CALLS = 100_000       # (e): calls a timed recording primitive
K1_KERNEL = "flash_fwd_kernel"  # the bf16 forward's __global__ function
_PROM_LINE = re.compile(
    r"^(?:# HELP [a-zA-Z_:][a-zA-Z0-9_:]* .*"
    r"|# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge|histogram|untyped)"
    r"|[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? -?[0-9.eE+-]+(?: [0-9]+)?)$")


def _tel_child(family, *labels):
    return telemetry.REGISTRY.get(family).labels(*labels)


def _tel_spans(name):
    return [s for s in flight.recent_spans() if s["name"] == name]


def _s21_serving(seed: int, smi: str, server, ep, layers: int):
    """(a) 4 closed-loop clients, each inside a smoke.client span."""
    completed = _tel_child("mxtpu_serving_requests_total", ep.name,
                           "completed")
    batches = _tel_child("mxtpu_serving_batches_total", ep.name)
    flight.RECORDER.clear()
    results = [[] for _ in range(TEL_CLIENTS)]
    traces, errors = [None] * TEL_CLIENTS, []

    def client(i):
        rng = np.random.default_rng(seed * 1000 + 210 + i)
        try:
            with telemetry.span("smoke.client", client=i) as sp:
                traces[i] = sp.trace_id
                for _ in range(TEL_REQS):
                    x = _s19_request_rows(rng, SEQ_LEN,
                                          int(rng.integers(1, 9)))
                    results[i].append((x, server.predict(ep.name, x,
                                                         timeout=300)))
        except Exception as e:        # surfaced below; the phase fails
            errors.append(repr(e))

    c0, b0 = completed.value, batches.value
    # ---- the main path: counts from 0 just before, read just after ----
    fa.launches = 0
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(TEL_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    launches = fa.launches
    # ---- end of the main path ----
    if errors or any(t.is_alive() for t in threads):
        raise SystemExit(f"FAIL: 21(a) client errors {errors[:3]}")
    responses = [r for rs in results for r in rs]
    d_completed, d_batches = completed.value - c0, batches.value - b0
    batch_spans = _tel_spans("serving.batch")
    step_spans = _tel_spans("serving.device_step")
    by_id = {s["span_id"]: s for s in batch_spans}
    ids = set(traces)
    carried = all(s["trace_id"] in ids for s in batch_spans) and all(
        s["parent_id"] in by_id and
        s["trace_id"] == by_id[s["parent_id"]]["trace_id"]
        for s in step_spans)
    excess = max(_s19_excess(ep.block, [(x, o, 0) for x, o in responses]))
    lines = telemetry.prometheus_text().splitlines()
    bad = [ln for ln in lines if ln and not _PROM_LINE.match(ln)]
    checks = {
        "trace ids": carried and len(batch_spans) == d_batches
        and len(step_spans) == d_batches,
        "completed": d_completed == len(responses),
        "batches x layers": d_batches * layers == launches,
        "responses": excess <= 0,
        "prometheus": not bad and len(lines) > 0}
    print(f"21(a) bert_base S={SEQ_LEN} bf16, {TEL_CLIENTS} closed-loop "
          f"clients in smoke.client spans: {len(responses)} responses in "
          f"{wall:.2f} s on {smi}")
    print(f"21(a) trace ids: {len(batch_spans)} serving.batch and "
          f"{len(step_spans)} serving.device_step spans, each carrying a "
          f"client's trace id ({len({s['trace_id'] for s in batch_spans})} "
          f"of {TEL_CLIENTS} clients lead a batch): {checks['trace ids']}")
    print(f"21(a) mxtpu_serving_requests_total{{event=completed}} delta "
          f"{d_completed:g} = {len(responses)} responses: "
          f"{checks['completed']}")
    print(f"21(a) mxtpu_serving_batches_total delta {d_batches:g} x {layers}"
          f" layers = {d_batches * layers:g} = K1 launches {launches}: "
          f"{checks['batches x layers']}")
    print(f"21(a) responses vs direct forward: max(|d| - tol) {excess:.4g}"
          f": {checks['responses']}")
    print(f"21(a) prometheus_text(): {len(lines)} lines, {len(bad)} "
          f"unparseable: {checks['prometheus']}")
    span_us = sorted(s["dur_us"] for s in batch_spans)
    return checks, launches, {"batch_span_p50_us": span_us[len(span_us) // 2]
                              if span_us else float("nan")}


def _s21_profiler(seed: int, smi: str, server, ep, layers: int):
    """(b) one request under a profile_all session."""
    SLICE21_DIR.mkdir(parents=True, exist_ok=True)
    dump = SLICE21_DIR / "profile.json"
    x = _s19_request_rows(np.random.default_rng(seed + 211), SEQ_LEN, 4)
    profiler.set_config(profile_all=True, filename=str(dump))
    # ---- the main path: counts from 0 just before, read just after ----
    fa.launches = 0
    profiler.start()
    try:
        with telemetry.span("smoke.profiled") as sp:
            server.predict(ep.name, x, timeout=300)
    finally:
        profiler.stop()
    launches = fa.launches
    # ---- end of the main path ----
    profiler.dump()
    profiler.set_config()
    events = json.load(open(dump))["traceEvents"]
    batch = [e for e in events if e["name"] == "serving.batch"]
    torch_trace = json.load(open(profiler.torch_trace_path()))["traceEvents"]
    k1 = [e for e in torch_trace if e.get("cat") == "kernel"
          and K1_KERNEL in e.get("name", "")]
    # CUPTI may drop a kernel record of a short session (one of 12 in a
    # run of the whole script, PR 21): the trace must hold K1's kernel,
    # and the counter counts every launch
    checks = {"span in chrome dump": bool(batch) and all(
                  e["args"]["trace_id"] == sp.trace_id for e in batch),
              "K1 in the device trace": 0 < len(k1) <= launches,
              "launches": launches == layers}
    print(f"21(b) profiler chrome dump: {len(events)} events, "
          f"serving.batch with the client's trace id: "
          f"{checks['span in chrome dump']}")
    durs = [e.get("dur", float("nan")) for e in k1]
    print(f"21(b) torch session trace: {len(k1)} device events of "
          f"{K1_KERNEL} (K1 launches {launches}, {layers} expected); the "
          f"first {k1[0]['name'][:80] if k1 else '-'!r}, duration "
          f"{durs[0] if durs else float('nan')} us, median "
          f"{sorted(durs)[len(durs) // 2] if durs else float('nan')} us "
          f"on {smi}: {checks['K1 in the device trace']}")
    return checks, launches


def _count_registry_calls():
    """Swap the registry's child methods for counting ones; returns the
    tally and the undo."""
    from mxnet_tpu_torch.telemetry import metrics as tm
    tally = {"inc": 0, "set": 0, "observe": 0, "span": 0}
    saved = []

    def wrap(cls, name, key):
        orig = getattr(cls, name)

        def counted(self, *a, **k):
            tally[key] += 1
            return orig(self, *a, **k)
        saved.append((cls, name, orig))
        setattr(cls, name, counted)

    wrap(tm._CounterChild, "inc", "inc")
    wrap(tm._GaugeChild, "inc", "inc")
    wrap(tm._GaugeChild, "dec", "inc")
    wrap(tm._GaugeChild, "set", "set")
    wrap(tm._HistogramChild, "observe", "observe")
    span = telemetry.span

    def counted_span(*a, **k):
        tally["span"] += 1
        return span(*a, **k)
    telemetry.span = counted_span

    def undo():
        telemetry.span = span
        for cls, name, orig in saved:
            setattr(cls, name, orig)
    return tally, undo


def _host_us(fn, n=TEL_COST_CALLS):
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def _s21_costs(seed: int, smi: str, server, ep, batch_us: float):
    """(e) the recording primitives' host cost, and one batch's calls."""
    from mxnet_tpu_torch.telemetry.metrics import MetricsRegistry
    reg = MetricsRegistry()
    fam = reg.counter("mxtpu_smoke_cost_total", labelnames=("endpoint",))
    child = fam.labels("e")
    hist = reg.histogram("mxtpu_smoke_cost_us")

    def one_span():
        with telemetry.span("smoke.cost"):
            pass
    cost = {"span_us": _host_us(one_span),
            "counter_inc_us": _host_us(child.inc),
            "counter_labels_inc_us": _host_us(lambda: fam.labels("e").inc()),
            "histogram_observe_us": _host_us(lambda: hist.observe(3.0))}
    x = _s19_request_rows(np.random.default_rng(seed + 212), SEQ_LEN, 1)
    tally, undo = _count_registry_calls()
    # ---- the main path: counts from 0 just before, read just after ----
    fa.launches = 0
    try:
        server.predict(ep.name, x, timeout=300)
    finally:
        undo()
    launches = fa.launches
    # ---- end of the main path ----
    spent = (tally["inc"] * cost["counter_inc_us"]
             + tally["set"] * cost["counter_inc_us"]
             + tally["observe"] * cost["histogram_observe_us"]
             + tally["span"] * cost["span_us"])
    print(f"21(e) host us a call over {TEL_COST_CALLS:,} calls: span "
          f"enter/exit {cost['span_us']:.3f}, labelled counter inc "
          f"{cost['counter_inc_us']:.3f} (with labels() lookup "
          f"{cost['counter_labels_inc_us']:.3f}), histogram observe "
          f"{cost['histogram_observe_us']:.3f} on {smi}")
    print(f"21(e) one served batch (1 row): {tally['inc']} inc, "
          f"{tally['set']} set, {tally['observe']} observe, "
          f"{tally['span']} spans ~ {spent:.1f} us of a {batch_us:.0f} us "
          f"serving.batch span (p50 of 21(a)): "
          f"{spent / batch_us * 100 if batch_us else float('nan'):.2f}% "
          f"(printed, not gated)")
    cost.update(tally=tally, share=spent / batch_us if batch_us else None)
    return cost, launches


def _s21_training(seed: int, smi: str):
    """(c) a few training steps, their spans, counts and memory."""
    rng = np.random.default_rng(seed + 213)
    named = seeded_bert_weights(BERTForPretraining(
        bert_base(max_length=TRAIN_SEQ)), seed)
    step = _train_step(named, 0.1, "bfloat16", seed=seed)
    layers = len(step._block.inner.backbone.encoder._layers)
    host = pretrain_batch(rng, TEL_TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ,
                          TRAIN_P)
    steps_fam = telemetry.REGISTRY.get("mxtpu_train_steps_total")
    s0 = steps_fam.value
    flight.RECORDER.clear()
    # ---- the main path: counts from 0 just before, read just after ----
    fa.launches = fa.launches_dq = fa.launches_dkv = 0
    losses = [step(*_at(host, i)) for i in range(TEL_TRAIN_STEPS)]
    torch.cuda.synchronize()
    counts = {"K1": fa.launches, "K2": fa.launches_dq,
              "K3": fa.launches_dkv}
    # ---- end of the main path ----
    losses = [float(v.item()) for v in losses]
    spans = _tel_spans("train.step")
    gc.collect()
    rec = memstats.reconcile()
    snap = telemetry.snapshot()
    g0 = rec.get("gpu:0", {})
    mem = snap["metrics"]["mxtpu_device_memory_bytes"]["series"]
    in_use = [s["value"] for s in mem
              if s["labels"] == {"device": "gpu:0", "stat": "bytes_in_use"}]
    holders = memstats.holders()
    checks = {
        "train.step spans": len(spans) == TEL_TRAIN_STEPS,
        "steps delta": steps_fam.value - s0 == TEL_TRAIN_STEPS,
        "launches": all(v == layers * TEL_TRAIN_STEPS
                        for v in counts.values()),
        "losses": all(math.isfinite(v) for v in losses),
        "attributed <= in use": bool(g0) and
        0 < g0["attributed"] <= g0["bytes_in_use"],
        "device memory gauge": bool(in_use) and in_use[0] > 0}
    print(f"21(c) {TEL_TRAIN_STEPS} ParallelTrainStep steps of BERT-base "
          f"bf16 at {TRAIN_BATCH} x {TRAIN_SEQ}: losses "
          f"{[round(v, 4) for v in losses]}; {len(spans)} train.step spans "
          f"(host us {[s['dur_us'] for s in spans]}), "
          f"mxtpu_train_steps_total delta {steps_fam.value - s0:g}: "
          f"{checks['train.step spans'] and checks['steps delta']}")
    print(f"21(c) K1-K3 launches {counts} (expected {layers} x "
          f"{TEL_TRAIN_STEPS} each): {checks['launches']}")
    print(f"21(c) memstats.reconcile() on gpu:0: attributed "
          f"{g0.get('attributed', 0):,} B of {g0.get('bytes_in_use', 0):,} B"
          f" in use (peak {g0.get('peak_bytes_in_use', 0):,} B), "
          f"unattributed {g0.get('unattributed', 0):,} B; holders "
          f"{[(h['holder'], h['bytes']) for h in holders[:4]]}: "
          f"{checks['attributed <= in use']}")
    print(f"21(c) mxtpu_device_memory_bytes{{device=gpu:0,stat=bytes_in_use}}"
          f" = {in_use[0] if in_use else None}: "
          f"{checks['device memory gauge']} on {smi}")
    del step
    torch.cuda.empty_cache()
    return checks, counts


def telemetry_oom(seed: int):
    """21(d) in a process under deterministic algorithms with
    MXNET_FLIGHT_DIR set (``chip_smoke.py --slice21-worker``): the
    uninterrupted run, then the same run with one device_oom injected into
    its first step; one JSON dict."""
    torch.use_deterministic_algorithms(True)
    named = seeded_bert_weights(BERTForPretraining(
        bert_base(max_length=TRAIN_SEQ)), seed)
    host = pretrain_batch(np.random.default_rng(seed + 214), TEL_OOM_STEPS,
                          TRAIN_BATCH, TRAIN_SEQ, TRAIN_P)
    fa.launches = fa.launches_dq = fa.launches_dkv = 0
    digests, fires = [], 0
    for faulted in (False, True):
        step = _res_step(named, seed)
        rule = faults.inject("device_oom", site="train_step", every_n=1,
                             times=1 if faulted else 0)
        with rule as inj:
            step(*_at(host, 0))
            fires += inj.fires
        for i in range(1, TEL_OOM_STEPS):
            step(*_at(host, i))
        torch.cuda.synchronize()
        digests.append(_res_digest(step))
        layers = len(step._block.inner.backbone.encoder._layers)
        del step
        torch.cuda.empty_cache()
    counts = {"K1": fa.launches, "K2": fa.launches_dq,
              "K3": fa.launches_dkv}
    bundles = flight.list_bundles(str(mt_config.get("MXNET_FLIGHT_DIR")))
    oom = []
    for b in bundles:
        bundle = flight.load_bundle(b)
        if bundle["trigger"]["kind"] == "oom":
            oom.append(bundle)
    first = oom[0] if oom else {}
    return {"bitwise": digests[0] == digests[1], "fires": fires,
            "launches": counts, "layers": layers,
            "computed_steps": 2 * TEL_OOM_STEPS,
            "bundles": len(bundles), "oom_bundles": len(oom),
            "trigger": first.get("trigger"),
            "metrics": len(first.get("metrics", {}).get("metrics", {})),
            "holders": [(h["holder"], h["bytes"]) for h in
                        first.get("memstats", {}).get("holders", [])],
            "threads": len(first.get("threads", {})),
            "spans": [s["name"] for s in first.get("spans", [])][-4:]}


def slice21_worker(seed: int) -> int:
    os.write(1, (json.dumps(telemetry_oom(seed)) + "\n").encode())
    return 0


def _s21_oom(seed: int, smi: str):
    """(d) run the worker and read its report."""
    d = SLICE21_DIR / "flight"
    shutil.rmtree(d, ignore_errors=True)
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, **RES_DET_ENV, MXNET_FLIGHT_DIR=str(d),
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run(SLICE21_WORKER + ["--seed", str(seed)], env=env,
                          capture_output=True, text=True,
                          timeout=SLICE21_TIMEOUT)
    if proc.returncode != 0:
        print(proc.stdout[-3000:])
        print(proc.stderr[-6000:])
        raise SystemExit(f"FAIL: 21(d) exited {proc.returncode}")
    r = json.loads([ln for ln in proc.stdout.splitlines()
                    if ln.startswith("{")][-1])
    exp = r["layers"] * r["computed_steps"]
    checks = {
        "bitwise": r["bitwise"] and r["fires"] == 1,
        "one oom bundle": r["oom_bundles"] == 1 and r["bundles"] == 1,
        "bundle contents": r["metrics"] > 0 and r["threads"] > 0
        and bool(r["spans"]) and any(h.startswith("train_step.state")
                                     for h, _ in r["holders"]),
        "launches": all(v == exp for v in r["launches"].values())}
    print(f"21(d) one device_oom in step 1 of {TEL_OOM_STEPS} under the "
          f"step's RetryPolicy ({r['fires']} fire), deterministic "
          f"algorithms: state bitwise the uninterrupted run's: "
          f"{checks['bitwise']}")
    print(f"21(d) MXNET_FLIGHT_DIR: {r['bundles']} bundle(s), "
          f"{r['oom_bundles']} oom (trigger {r['trigger']}): "
          f"{checks['one oom bundle']}")
    print(f"21(d) load_bundle: {r['metrics']} metric families, holders "
          f"{r['holders'][:3]}, {r['threads']} thread stacks, last spans "
          f"{r['spans']}: {checks['bundle contents']}")
    print(f"21(d) K1-K3 launches {r['launches']} (expected {r['layers']} x "
          f"{r['computed_steps']} computed steps = {exp} each: the faulted "
          f"attempt computes nothing): {checks['launches']} on {smi}")
    return checks, r["launches"]


def phase_telemetry(seed: int, smi: str):
    """Phase 21: telemetry and the profiler, on K1-K3's paths."""
    t_phase = time.perf_counter()
    shutil.rmtree(SLICE21_DIR, ignore_errors=True)
    SLICE21_DIR.mkdir(parents=True, exist_ok=True)
    # this phase's attribution: the holders of earlier phases' objects
    # (some alive, some sharing weights) are dropped
    memstats.reset()
    named = seeded_bert_weights(bert_base(), seed + 21)
    net = _s19_net(named)
    layers = len(net.encoder._layers)
    ep = serving.ModelEndpoint("s21_bert", net, [(SEQ_LEN,), (SEQ_LEN,)],
                               dtype="int32", max_batch_size=32, ctx=gpu())
    server = serving.InferenceServer(batch_timeout_ms=2.0, max_queue=512)
    server.register(ep)
    server.start()
    try:
        ok_a, k1_a, info = _s21_serving(seed, smi, server, ep, layers)
        ok_b, k1_b = _s21_profiler(seed, smi, server, ep, layers)
        cost, k1_e = _s21_costs(seed, smi, server, ep,
                                info["batch_span_p50_us"])
    finally:
        server.stop(drain=True)
        serving.unregister(ep.name)
    del ep, server, net
    torch.cuda.empty_cache()
    ok_c, train_counts = _s21_training(seed, smi)
    ok_d, oom_counts = _s21_oom(seed, smi)
    failed = [f"21{part} {name}" for part, checks in
              (("(a)", ok_a), ("(b)", ok_b), ("(c)", ok_c), ("(d)", ok_d))
              for name, good in checks.items() if not good]
    for f in failed:
        print(f"FAIL: {f}")
    if failed:
        raise SystemExit("FAIL: phase 21")
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s")
    return {"k1": {"telemetry_serving": k1_a,
                   "telemetry_profiled_request": k1_b,
                   "telemetry_cost_batch": k1_e},
            "hand": {"telemetry_training": dict(train_counts, K4=0, K5=0),
                     "telemetry_oom_retry": dict(oom_counts, K4=0, K5=0)},
            "cost": cost}


# ---------------------------------------------------------------------------
# phase 22: goodput, the fleet pane and the debug server, in a process of
# their own
# ---------------------------------------------------------------------------
SLICE22_DIR = Path(__file__).resolve().parent / "build" / "phase_fleet22"
SLICE22_WORKER = [sys.executable, str(Path(__file__).resolve()),
                  "--slice22-worker"]
SLICE22_TIMEOUT = 600          # the worker alone builds K1-K3 (nvcc)
FLEET_SCRAPED = ("/metricsz", "/metricsz?json=1", "/statusz", "/tracez",
                 "/memz", "/fleetz")
FLEET_FETCH_S = 60             # a debug page's fetch timeout
FLEET_SCRAPE_PAUSE_S = 0.2     # (a): a scraper's pause between fetches
FLEET_CONVOY_REQS = 1          # (a): one-row requests a switch interval
FLEET_SWITCH_S = 0.0005        # (a): the short interpreter switch interval
FLEET_TENANT = ("fl_bert128", 128, 8, 2)   # (c): name, S, top bucket, rows
FLEET_FD_CLIENTS = 2           # (c): closed-loop clients of the tenant
FLEET_FD_TICKS = 3             # (c): agent ticks the load spans at least
FLEET_FD_MIN_S = 1.0           # (c): and at least this long
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _http_get(url):
    """(status, body, ms) of one GET, 4xx/5xx included; loopback, never
    through a proxy (the card's host has no network)."""
    t0 = time.perf_counter()
    try:
        with _OPENER.open(url, timeout=FLEET_FETCH_S) as r:
            status, body = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read().decode()
    return status, body, (time.perf_counter() - t0) * 1e3


def _fam_total(snap, name, key="value", match=None):
    fam = snap["metrics"].get(name)
    return sum(float(s.get(key, 0.0)) for s in (fam or {}).get("series", [])
               if match is None or all(s["labels"].get(k) == v
                                       for k, v in match.items()))


def _span_ms(name):
    return [round(s["dur_us"] / 1e3, 3) for s in _tel_spans(name)]


def _s22_goodput(seed: int):
    """(b) goodput over a few BERT-base training steps and one checkpoint
    save, the first work of a fresh process: every source series starts
    at zero, so the buckets are the deltas of their series."""
    from mxnet_tpu_torch.telemetry import goodput
    goodput.reset()
    s0 = telemetry.REGISTRY.snapshot()
    named = seeded_bert_weights(BERTForPretraining(
        bert_base(max_length=TRAIN_SEQ)), seed)
    step = _train_step(named, 0.1, "bfloat16", seed=seed)
    layers = len(step._block.inner.backbone.encoder._layers)
    loader = _res_loader(pretrain_batch(np.random.default_rng(seed + 221),
                                        TEL_TRAIN_STEPS, TRAIN_BATCH,
                                        TRAIN_SEQ, TRAIN_P))
    flight.RECORDER.clear()
    # ---- the main path: counts from 0 just before, read just after ----
    fa.launches = fa.launches_dq = fa.launches_dkv = 0
    losses = [step(*_res_args(b)) for b in loader]
    ckpt = SLICE22_DIR / "ckpt"
    CheckpointManager(str(ckpt), keep=1, async_save=False).save(
        len(losses), train_step=step)
    counts = {"K1": fa.launches, "K2": fa.launches_dq, "K3": fa.launches_dkv}
    # ---- end of the main path ----
    buckets = goodput.account()
    s1 = telemetry.REGISTRY.snapshot()
    shutil.rmtree(ckpt, ignore_errors=True)
    losses = [float(v.item()) for v in losses]
    wall = s1["metrics"]["mxtpu_goodput_wall_seconds"]["series"][0]["value"]
    sources = {
        "compile": [("mxtpu_serving_compile_seconds_total", "value", 1.0),
                    ("mxtpu_exec_cache_deserialize_seconds_total", "value",
                     1.0)],
        "data_wait": [("mxtpu_dataloader_wait_us", "sum", 1e-6)],
        "step": [(n, "sum", 1e-6) for n in (
            "mxtpu_train_step_latency_us", "mxtpu_serving_step_latency_us",
            "mxtpu_decode_step_us", "mxtpu_decode_prefill_us")],
        "checkpoint_flush": [(n, "sum", 1e-6) for n in (
            "mxtpu_checkpoint_save_duration_us",
            "mxtpu_preempt_flush_duration_us")]}
    spans = {"retry_recovery": goodput.RECOVERY_SPANS,
             "drain": goodput.DRAIN_SPANS}
    start = {b: sum(_fam_total(s0, n, k) * f for n, k, f in src)
             for b, src in sources.items()}
    delta = {b: sum((_fam_total(s1, n, k) - _fam_total(s0, n, k)) * f
                    for n, k, f in src) for b, src in sources.items()}
    for b, names in spans.items():
        delta[b] = sum(
            _fam_total(s1, "mxtpu_span_duration_us", "sum", {"name": n})
            - _fam_total(s0, "mxtpu_span_duration_us", "sum", {"name": n})
            for n in names) / 1e6
    active = sum(delta.values())
    scale = wall / active if active > wall else 1.0
    published = {s["labels"]["bucket"]: s["value"] for s in
                 s1["metrics"]["mxtpu_goodput_seconds_total"]["series"]}
    checks = {
        "buckets sum to wall": abs(sum(buckets.values()) - wall)
        <= 1e-6 * wall,
        "sources start at zero": not any(start.values()),
        "step, data_wait, checkpoint_flush = source deltas": all(
            math.isclose(buckets[b], delta[b] * scale, rel_tol=1e-9,
                         abs_tol=1e-12)
            for b in ("step", "data_wait", "checkpoint_flush"))
        and delta["step"] > 0 and delta["data_wait"] > 0
        and delta["checkpoint_flush"] > 0,
        "mxtpu_goodput_seconds_total = attribution": all(
            math.isclose(published.get(b, 0.0), v, rel_tol=1e-9,
                         abs_tol=1e-12) for b, v in buckets.items()),
        "K1-K3 12 a step": all(v == layers * len(losses)
                               for v in counts.values()),
        "losses": len(losses) == TEL_TRAIN_STEPS
        and all(math.isfinite(v) for v in losses)}
    print(f"22(b) goodput over {len(losses)} ParallelTrainStep steps of "
          f"BERT-base bf16 at {TRAIN_BATCH} x {TRAIN_SEQ} (batches through "
          f"gluon.data.DataLoader) and one checkpoint save, wall "
          f"{wall:.6f} s (rescaled: {scale != 1.0}):")
    for b in goodput.BUCKETS:
        print(f"22(b)   {b:<17}{buckets[b]:12.6f} s {buckets[b] / wall:8.2%}"
              f"   sources {delta.get(b, float('nan')):.6f} s")
    print(f"22(b) step share {buckets['step'] / wall:.2%}: host time of the "
          f"step calls ({_span_ms('train.step')} ms train.step spans), which "
          f"return before the card finishes; the card's time the host did "
          f"not wait for is in idle")
    print(f"22(b) losses {[round(v, 4) for v in losses]}; K1-K3 launches "
          f"{counts} (expected {layers} x {len(losses)})")
    del step
    torch.cuda.empty_cache()
    return {"checks": checks, "launches": counts,
            "buckets": buckets, "wall_s": wall}


def _s22_serving(seed: int, net, layers: int):
    """(a) the debug pages under serving: one round of closed-loop clients
    without scrapers, one with six scraper threads that pause
    FLEET_SCRAPE_PAUSE_S between fetches; then one-row requests under six
    scrapers that do not pause, at the interpreter's default switch
    interval and at FLEET_SWITCH_S (if handler threads starve the serving
    thread by holding the interpreter, the requests' latency follows the
    switch interval)."""
    from mxnet_tpu_torch.telemetry import debug_server as dbg
    ep = serving.ModelEndpoint("fl_bert512", net, [(SEQ_LEN,), (SEQ_LEN,)],
                               dtype="int32", max_batch_size=32, ctx=gpu())
    server = serving.InferenceServer(batch_timeout_ms=2.0, max_queue=512)
    server.register(ep)
    web = dbg.DebugServer(port=0).start()
    scrapes = {p: 0 for p in FLEET_SCRAPED}
    statuses, errors, sets = [], [], []
    pages = ("metricsz", "statusz", "tracez", "memz", "fleetz")
    req_fam = telemetry.REGISTRY.get("mxtpu_debug_requests_total")
    batches = _tel_child("mxtpu_serving_batches_total", ep.name)

    def scraper(page, pause, halt):
        while not halt.is_set():
            try:
                st, _, _ = _http_get(web.url + page)
            except Exception as e:        # surfaced below; the phase fails
                errors.append(f"{page}: {e!r}")
                return
            statuses.append(st)
            scrapes[page] += 1
            halt.wait(pause)

    def scraping(pause):
        """Six scraper threads, one a page, until the set is halted."""
        halt = threading.Event()
        threads = [threading.Thread(target=scraper, args=(p, pause, halt),
                                    daemon=True) for p in FLEET_SCRAPED]
        sets.append((halt, threads))
        for t in threads:
            t.start()

    def halt_scraping():
        for halt, threads in sets:
            halt.set()
            for t in threads:
                t.join(120)

    def one_row_ms():
        """Median host ms of FLEET_CONVOY_REQS one-row requests in turn."""
        ms = []
        for _ in range(FLEET_CONVOY_REQS):
            t0 = time.perf_counter()
            server.predict(ep.name, one, timeout=300)
            ms.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ms))

    def round_(tag, n_seed):
        results = [[] for _ in range(TEL_CLIENTS)]
        traces, errs = [None] * TEL_CLIENTS, []

        def client(i):
            rng = np.random.default_rng(n_seed * 1000 + i)
            try:
                with telemetry.span("smoke.client", client=i,
                                    trace_id=telemetry.new_trace_id()) as sp:
                    traces[i] = sp.trace_id
                    for _ in range(TEL_REQS):
                        x = _s19_request_rows(rng, SEQ_LEN,
                                              int(rng.integers(1, 9)))
                        results[i].append((x, server.predict(
                            ep.name, x, timeout=300), 0))
            except Exception as e:        # surfaced below; the phase fails
                errs.append(repr(e))

        flight.RECORDER.clear()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(TEL_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        if errs or any(t.is_alive() for t in threads):
            raise SystemExit(f"FAIL: 22(a) {tag} client errors {errs[:3]}")
        batch_us = sorted(s["dur_us"] for s in _tel_spans("serving.batch"))
        return ([r for rs in results for r in rs], traces,
                batch_us[len(batch_us) // 2] / 1e3)

    one = _s19_request_rows(np.random.default_rng(seed + 222), SEQ_LEN, 1)
    req0 = {p: req_fam.labels(p).value for p in pages}
    server.start()
    try:
        st_up, _, _ = _http_get(web.url + "/healthz")
        # ---- the main path: counts from 0 just before, read just after --
        b0 = batches.value
        fa.launches = 0
        quiet, _, p50_quiet = round_("quiet", seed + 223)
        one_quiet_ms = one_row_ms()
        scraping(FLEET_SCRAPE_PAUSE_S)
        scraped, traces, p50_scraped = round_("scraped", seed + 224)
        _, tracez, _ = _http_get(web.url + "/tracez")
        under = server.predict(ep.name, one, timeout=300)
        halt_scraping()
        scraping(0.0)
        switch = sys.getswitchinterval()
        convoy = {switch: one_row_ms()}
        sys.setswitchinterval(FLEET_SWITCH_S)
        try:
            convoy[FLEET_SWITCH_S] = one_row_ms()
        finally:
            sys.setswitchinterval(switch)
        halt_scraping()
        alone = server.predict(ep.name, one, timeout=300)
        launches, d_batches = fa.launches, batches.value - b0
        # ---- end of the main path ----
        ms_metricsz = _http_get(web.url + "/metricsz")[2]
        ms_fleetz = _http_get(web.url + "/fleetz")[2]
        m0 = torch.cuda.memory_stats(0)
        _, memz, _ = _http_get(web.url + "/memz")
        m1 = torch.cuda.memory_stats(0)
        gauge = _tel_child("mxtpu_device_memory_bytes", "gpu:0",
                           "bytes_in_use").value
        flight_dir = str(mt_config.get("MXNET_FLIGHT_DIR"))
        n_bundles = len(flight.list_bundles(flight_dir))
        st_dump, dump_body, _ = _http_get(web.url + "/flightz?dump=1")
        bundles = flight.list_bundles(flight_dir)
        kinds = [flight.load_bundle(b)["trigger"]["kind"] for b in bundles]
        st_run, _, _ = _http_get(web.url + "/healthz")
        server.stop(drain=True)
        st_stop, stop_body, _ = _http_get(web.url + "/healthz")
        dbg.detach(server)
        st_gone, _, _ = _http_get(web.url + "/healthz")
    finally:
        halt_scraping()
        web.stop()
        server.stop(drain=False)
        dbg.detach(server)
        serving.unregister(ep.name)
    made = dict(scrapes, metricsz=scrapes["/metricsz"]
                + scrapes["/metricsz?json=1"])
    served = {p: req_fam.labels(p).value - req0[p] for p in pages}
    # beyond the scrapers: one /tracez, /metricsz, /fleetz and /memz fetch
    extra = {"metricsz": 1, "statusz": 0, "tracez": 1, "memz": 1,
             "fleetz": 1}
    excess = max(_s19_excess(net, quiet + scraped))
    mem_line = [ln.strip() for ln in memz.splitlines()
                if ln.strip().startswith("gpu:0:")]
    lo = m0["allocated_bytes.all.current"] - (
        m1["allocated_bytes.all.freed"] - m0["allocated_bytes.all.freed"])
    hi = m0["allocated_bytes.all.current"] + (
        m1["allocated_bytes.all.allocated"]
        - m0["allocated_bytes.all.allocated"])
    stop_state = json.loads(stop_body)["servers"][0]["state"] \
        if st_stop == 503 else None
    checks = {
        "no scrape error, every status 200": not errors and bool(statuses)
        and all(s == 200 for s in statuses),
        "mxtpu_debug_requests_total = scrapes": all(
            served[p] == (made[p] if p == "metricsz" else made[f"/{p}"])
            + extra[p] for p in pages),
        "responses": excess <= 0,
        "one row bitwise with and without scrapers": all(
            torch.equal(a, b) for a, b in zip(_outputs(under),
                                              _outputs(alone))),
        "batches x layers = K1": d_batches * layers == launches > 0,
        "tracez holds every client": all(t in tracez for t in traces),
        "memz gpu:0": bool(mem_line) and lo <= gauge <= hi,
        "flightz dump": st_dump == 200 and len(bundles) == n_bundles + 1
        and kinds.count("flightz") == 1,
        "healthz 200, 503 stopped, 200 detached": st_up == st_run == 200
        and st_stop == 503 and stop_state == "stopped" and st_gone == 200}
    print(f"22(a) bert_base S={SEQ_LEN} bf16 through the serial "
          f"InferenceServer behind DebugServer {web.url}: "
          f"{len(quiet)} responses without scrapers, {len(scraped)} with "
          f"{len(FLEET_SCRAPED)} scraper threads pausing "
          f"{FLEET_SCRAPE_PAUSE_S * 1e3:g} ms between fetches, then "
          f"{len(FLEET_SCRAPED)} without pauses ({made} fetches in all, "
          f"{len(errors)} errors, statuses {sorted(set(statuses))})")
    print(f"22(a) mxtpu_debug_requests_total deltas {served} (scrapers "
          f"plus {extra})")
    print(f"22(a) responses vs direct forward: max(|d| - tol) {excess:.4g}; "
          f"mxtpu_serving_batches_total delta {d_batches:g} x {layers} = "
          f"{d_batches * layers:g}, K1 launches {launches}")
    print(f"22(a) /memz: {mem_line[:1]}; its scrape set bytes_in_use "
          f"{gauge:,.0f}, torch.cuda.memory_stats(0) {lo:,}..{hi:,} around "
          f"it")
    print(f"22(a) /flightz?dump=1: {json.loads(dump_body).get('dumped')}; "
          f"bundle triggers {kinds}; /healthz {st_up} running, {st_stop} "
          f"({stop_state}) after stop(), {st_gone} after detach")
    print(f"22(a) one /metricsz scrape {ms_metricsz:.1f} ms, one /fleetz "
          f"{ms_fleetz:.1f} ms; served batch p50 {p50_quiet:.2f} ms without "
          f"scrapers, {p50_scraped:.2f} ms with scrapers pausing "
          f"{FLEET_SCRAPE_PAUSE_S * 1e3:g} ms (printed, not gated)")
    print(f"22(a) one-row requests, median of {FLEET_CONVOY_REQS}: "
          f"{one_quiet_ms:.2f} ms without scrapers; under "
          f"{len(FLEET_SCRAPED)} scrapers without pauses "
          + ", ".join(f"{ms:.2f} ms at a switch interval of {si * 1e3:g} ms"
                      for si, ms in convoy.items())
          + " (printed, not gated)")
    return {"checks": checks, "launches": launches,
            "ms_metricsz": ms_metricsz, "ms_fleetz": ms_fleetz,
            "p50_quiet_ms": p50_quiet, "p50_scraped_ms": p50_scraped,
            "one_row_quiet_ms": one_quiet_ms,
            "one_row_unpaced_ms": {str(k): v for k, v in convoy.items()}}


def _s22_frontdoor(seed: int, net, layers: int):
    """(c) the fleet pane over a two-host FrontDoor on the card."""
    from mxnet_tpu_torch.telemetry import fleet
    name, seq, top, rows = FLEET_TENANT
    endpoints = []

    def factory(host):
        server = serving.InferenceServer(batch_timeout_ms=2.0, max_queue=512)
        endpoints.append(serving.ModelEndpoint(
            name, net, [(seq,), (seq,)], dtype="int32", max_batch_size=top,
            ctx=gpu()))
        server.register(endpoints[-1])
        server.start()
        return server

    work = SLICE22_DIR / "frontdoor"
    work.mkdir(parents=True, exist_ok=True)
    dumps = {h: work / f"dump-{h}.json" for h in ("h0", "h1")}
    ticks = {h: set() for h in dumps}

    def tick_walls():
        for h, p in dumps.items():
            try:
                snap = json.loads(p.read_text())
                ticks[h].add(snap["metrics"]["mxtpu_goodput_wall_seconds"][
                    "series"][0]["value"])
            except (OSError, ValueError, KeyError):
                pass
        return min(len(v) for v in ticks.values())

    # both planes' endpoints share the name, so one family child counts
    # both planes' batches
    batches = _tel_child("mxtpu_serving_batches_total", name)
    # ---- the main path: counts from 0 just before, read just after ----
    b0 = batches.value
    fa.launches = 0
    fd = serving.FrontDoor(list(dumps), factory, workdir=str(work))
    try:
        t_wait = time.perf_counter()
        while tick_walls() < 1:
            if time.perf_counter() - t_wait > 120:
                raise SystemExit("FAIL: 22(c) an agent never dumped")
            time.sleep(0.05)
        for v in ticks.values():
            v.clear()
        done, errors, stop = [], [], threading.Event()

        def client(i):
            rng = np.random.default_rng(seed * 1000 + 225 + i)
            while not stop.is_set():
                x = _s19_request_rows(rng, seq, rows)
                try:
                    done.append(fd.submit(name, x).result(timeout=300))
                except Exception as e:    # surfaced below; the phase fails
                    errors.append(repr(e))
                    return

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(FLEET_FD_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        while tick_walls() < FLEET_FD_TICKS or \
                time.perf_counter() - t0 < FLEET_FD_MIN_S:
            time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join(300)
        window = time.perf_counter() - t0
        launches, d_batches = fa.launches, batches.value - b0
        # ---- end of the main path ----
        # each endpoint's construction probe and bucket warm-ups
        warm = sum(e.stats.counters["warmup_batches"] for e in endpoints)
        if errors or any(t.is_alive() for t in threads):
            raise SystemExit(f"FAIL: 22(c) client errors {errors[:3]}")
        doc = fd.fleet_collect()
        rec = fd.goodput_reconcile()
        health = fleet.health_rollup()
        fleet_health = telemetry.REGISTRY.get("mxtpu_fleet_health").value
        agent_dumps = {h: json.loads(p.read_text()) for h, p in dumps.items()}
        telemetry.spool_flush()
    finally:
        fd.stop()
        serving.unregister(name)
    merged = doc["merged"]["metrics"]

    def split(fam):
        per = [s for s in fam["series"] if s["labels"]["replica"] != "ALL"]
        return per, [s for s in fam["series"]
                     if s["labels"]["replica"] == "ALL"]

    def key(s):
        return tuple(sorted((k, v) for k, v in s["labels"].items()
                            if k != "replica"))

    req, req_all = split(merged["mxtpu_serving_requests_total"])
    by_source = sum(_fam_total(snap, "mxtpu_serving_requests_total")
                    for snap in [*agent_dumps.values()]) + sum(
        s["value"] for s in req
        if s["labels"]["replica"] == f"frontdoor-{os.getpid()}")
    sums_ok = sum(s["value"] for s in req) == by_source and all(
        a["value"] == sum(s["value"] for s in req if key(s) == key(a))
        for a in req_all)
    hist, hist_all = split(merged["mxtpu_span_duration_us"])
    (batch_all,) = [a for a in hist_all
                    if dict(key(a)).get("name") == "serving.batch"]
    parts = [s for s in hist if key(s) == key(batch_all)]
    hist_ok = len(parts) == 3 and batch_all["bucket_counts"] == [
        sum(c) for c in zip(*(s["bucket_counts"] for s in parts))]
    # what tools/fleet_report.py --verify and tools/trace_journey.py read,
    # computed by the port (both tools import the JAX package)
    report = fleet.merge_snapshots({f"dump-{h}.json": s
                                    for h, s in agent_dumps.items()})
    verify = {}
    for h, snap in agent_dumps.items():
        w = snap["metrics"]["mxtpu_goodput_wall_seconds"]["series"][0][
            "value"]
        total = _fam_total(snap, "mxtpu_goodput_seconds_total")
        verify[h] = (round(total, 6), round(w, 6),
                     abs(total - w) <= 0.01 * max(w, 1e-9))
    hops = telemetry.journey(os.environ["MXNET_TRACE_ID"],
                             os.environ["MXNET_SPAN_SPOOL_DIR"])
    agents = [h for h in hops if h["name"] == "fabric.host_agent"]
    sources = sorted(doc["sources"])
    checks = {
        "3 sources": doc["processes"] == 3 and sources == sorted(
            [f"frontdoor-{os.getpid()}", "host-h0", "host-h1"]),
        "requests merged = sum over sources": sums_ok,
        "histogram merged = element-wise sum": hist_ok,
        "goodput_reconcile ok": set(rec) == {"h0", "h1"}
        and all(r["ok"] for r in rec.values()),
        "health ok, mxtpu_fleet_health 0": health["status"] == "ok"
        and fleet_health == 0 and len(health["servers"]) == 2,
        "fleet report": bool(report["metrics"])
        and all(v[2] for v in verify.values()),
        "journey": sorted(h["attrs"].get("host") for h in agents)
        == ["h0", "h1"] and len({h["pid"] for h in agents}) == 2
        and os.getpid() not in {h["pid"] for h in agents},
        "K1 = 12 x (batches + warm-ups)": len(endpoints) == 2
        and launches == layers * (d_batches + warm) and d_batches > 0}
    print(f"22(c) FrontDoor over 2 host planes on the card ({name}: S={seq}, "
          f"buckets 1-{top}, agents on gpu(0)), {FLEET_FD_CLIENTS} "
          f"closed-loop clients for {window:.2f} s ({len(done)} responses, "
          f"agent ticks seen {[len(v) for v in ticks.values()]})")
    print(f"22(c) fleet_collect: {doc['processes']} sources {sources}; "
          f"mxtpu_serving_requests_total {sum(s['value'] for s in req):g} "
          f"merged = {by_source:g} over the sources; serving.batch span "
          f"histogram ALL = element-wise sum of {len(parts)}: {hist_ok}")
    print(f"22(c) goodput_reconcile {rec}; health {health['status']}, "
          f"mxtpu_fleet_health {fleet_health:g}")
    print(f"22(c) the agents' dumps as tools/fleet_report.py --verify reads "
          f"them (sum, wall, within 1%): {verify}; the spool's journey of "
          f"trace {os.environ['MXNET_TRACE_ID']}: {len(hops)} hops, "
          f"fabric.host_agent from pids {sorted(h['pid'] for h in agents)}")
    print(f"22(c) K1 launches {launches} = {layers} x ({d_batches:g} "
          f"batches of mxtpu_serving_batches_total + {warm} probe and "
          f"warm-up batches of the two planes) for {len(done)} requests")
    return {"checks": checks, "launches": launches}


def slice22_worker(seed: int) -> int:
    """Phase 22 in a process of its own (``chip_smoke.py --slice22-worker``,
    with ``MXNET_TRACE_ID``, ``MXNET_SPAN_SPOOL_DIR`` and
    ``MXNET_FLIGHT_DIR`` set): (b) first, while every source series is at
    zero, then (a) and (c) on one BERT-base. The last line is one JSON
    dict."""
    out = {"b": _s22_goodput(seed)}
    net = _s19_net(seeded_bert_weights(bert_base(), seed + 22))
    layers = len(net.encoder._layers)
    out["a"] = _s22_serving(seed, net, layers)
    out["c"] = _s22_frontdoor(seed, net, layers)
    sys.stdout.flush()
    os.write(1, (json.dumps(out, default=float) + "\n").encode())
    return 0


def phase_fleet(seed: int, smi: str):
    """Phase 22: goodput, the fleet pane and the debug server, in a worker
    process (the main process's stopped servers, full registry and old
    goodput clock would leak into its checks)."""
    t_phase = time.perf_counter()
    shutil.rmtree(SLICE22_DIR, ignore_errors=True)
    SLICE22_DIR.mkdir(parents=True)
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, MXNET_TRACE_ID=telemetry.new_trace_id(),
               MXNET_SPAN_SPOOL_DIR=str(SLICE22_DIR / "spool"),
               MXNET_FLIGHT_DIR=str(SLICE22_DIR / "flight"),
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    env.pop("MXNET_DEBUG_PORT", None)      # the agents would share one port
    proc = subprocess.run(SLICE22_WORKER + ["--seed", str(seed)], env=env,
                          capture_output=True, text=True,
                          timeout=SLICE22_TIMEOUT)
    lines = proc.stdout.splitlines()
    for ln in lines:
        if not ln.startswith("{"):
            print(ln)
    if proc.returncode != 0:
        print(proc.stderr[-6000:])
        raise SystemExit(f"FAIL: 22 worker exited {proc.returncode}")
    r = json.loads([ln for ln in lines if ln.startswith("{")][-1])
    failed = []
    for part in ("a", "b", "c"):
        for name, good in r[part]["checks"].items():
            print(f"22({part}) {name}: {good} on {smi}")
            if not good:
                failed.append(f"22({part}) {name}")
    if failed:
        print(proc.stderr[-6000:])
        raise SystemExit(f"FAIL: {failed[0]}" + (
            f" (and {len(failed) - 1} more)" if len(failed) > 1 else ""))
    shutil.rmtree(SLICE22_DIR, ignore_errors=True)
    print(f"phase 22: {time.perf_counter() - t_phase:.1f} s")
    return {"k1": {"fleet_serving": r["a"]["launches"],
                   "fleet_frontdoor": r["c"]["launches"]},
            "hand": {"fleet_training": dict(r["b"]["launches"], K4=0, K5=0)}}


# ---------------------------------------------------------------------------
# phase 23: the symbolic API (Symbol, Executor, Module, BucketingModule,
# the subgraph partitioner, Monitor, checkpoints) over a BERT-base-width
# encoder written in mx.sym
# ---------------------------------------------------------------------------
SYM_CFG = dict(layers=12, units=768, heads=12, ffn=3072, vocab=30522,
               classes=2)
SYM_BATCH, SYM_SEQ = 32, 128         # (a)-(c), (e)
SYM_SHAPE = (SYM_BATCH, 12, SYM_SEQ, 64)    # K1-K3's f32 instances here
SYM_FIT_BATCHES = 8                  # (c): one epoch
SYM_FIXED_STEPS = 5                  # (c): steps on one fixed batch
SYM_LR = 1e-4                        # (c): Adam
SYM_DROPOUT = 0.1
SYM_GLUON_BATCHES = 2                # (b)
SYM_GLUON_TOL = 1e-4                 # (b): x max(1, max|Gluon|)
SYM_CPU_BATCH = 2                    # (d)
SYM_SGD_LR = 0.01                    # (d)
SYM_LOSS_RTOL = 1e-4                 # (d)
SYM_DRIFT_FACTOR = 3.0               # (d): x the CPU's own f32 drift
SYM_PREDICT_BATCHES = 2              # (e)
SYM_BUCKETS = (64, 128)              # (f)
SYM_SUBGRAPH_BATCH = 8               # (g)
SYM_DIR = Path(__file__).resolve().parent / "build" / "phase_symbolic23"


def _sym_net(dropout):
    return symbol_bert(msym, seq=SYM_SEQ, dropout=dropout, **SYM_CFG)


def _sym_params(named, seed, ctx):
    """The graph's arguments from the Gluon model's seeded weights, the
    first-token head seeded beside them, as NDArrays on ``ctx``."""
    rng = np.random.default_rng(seed + 23)
    units, classes = SYM_CFG["units"], SYM_CFG["classes"]
    args = dict(gluon_arg_params(named))
    args["cls_weight"] = (rng.standard_normal((classes, units), np.float32)
                          * np.float32(units ** -0.5))
    args["cls_bias"] = np.zeros(classes, np.float32)
    return {k: nd.array(v, ctx=ctx, dtype="float32")
            for k, v in args.items()}


def _sym_batches(seed, n, batch, seq):
    rng = np.random.default_rng(seed + 230 + seq)
    tokens = rng.integers(0, SYM_CFG["vocab"], (n * batch, seq))
    labels = rng.integers(0, SYM_CFG["classes"], (n * batch,))
    return tokens.astype(np.float32), labels.astype(np.float32)


def _sym_module(net, ctx, batch, seq, params, for_training=True):
    m = mmod.Module(net, data_names=("data",),
                    label_names=("softmax_label",), context=ctx)
    m.bind(data_shapes=[("data", (batch, seq))],
           label_shapes=[("softmax_label", (batch,))],
           for_training=for_training)
    m.init_params(arg_params=params, aux_params={})
    return m


class _SymBatch:
    """One batch of a bucket, as ``BucketingModule.forward`` reads it."""

    def __init__(self, tokens, labels, ctx):
        self.bucket_key = tokens.shape[1]
        self.data = [nd.array(tokens, ctx=ctx)]
        self.label = [nd.array(labels, ctx=ctx)]
        self.provide_data = [("data", tokens.shape)]
        self.provide_label = [("softmax_label", labels.shape)]


def _xent(probs, labels):
    """Mean cross-entropy of SoftmaxOutput probabilities (a device scalar)."""
    y = labels.to(device=probs.device, dtype=torch.long)
    return -torch.log(probs.gather(1, y[:, None]).clamp_min(1e-30)).mean()


def _sym_loss(m, labels):
    """Mean cross-entropy of the bound module's outputs (a device
    scalar)."""
    return _xent(m.get_outputs()[0].data, labels.data)


def _k123():
    return fa.launches, fa.launches_dq, fa.launches_dkv


def _sym_alloc():
    """(requested bytes, allocations) so far on card 0 (the caching
    allocator's counts before its rounding)."""
    st = torch.cuda.memory_stats(0)
    return st["requested_bytes.all.allocated"], st["allocation.all.allocated"]


def _sym_bind(net, smi):
    """(a): the bind's shape inference and allocation, no launch."""
    ctx = gpu(0)
    _zero_counters()
    torch.cuda.synchronize()
    shapes = dict(data=(SYM_BATCH, SYM_SEQ), softmax_label=(SYM_BATCH,))
    before = _sym_alloc()
    t0 = time.perf_counter()
    net.infer_shape(**shapes)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    net.infer_shape(**shapes)
    infer_s = time.perf_counter() - t0
    inferred = _sym_alloc()
    t0 = time.perf_counter()
    m = mmod.Module(net, context=ctx)
    m.bind(data_shapes=[("data", shapes["data"])],
           label_shapes=[("softmax_label", shapes["softmax_label"])])
    torch.cuda.synchronize()
    bind_s = time.perf_counter() - t0
    after = _sym_alloc()
    ex = m._exec
    arrays = list(ex.arg_dict.values()) + list(ex.aux_dict.values()) + \
        list(ex.grad_dict.values())
    want = (sum(a.data.numel() * a.data.element_size() for a in arrays),
            len(arrays))
    got = (after[0] - inferred[0], after[1] - inferred[1])
    counts = _read_counters()
    print(f"23(a) bind BERT-base ({SYM_CFG['layers']} layers) at "
          f"{SYM_BATCH} x {SYM_SEQ} f32: shape inference {cold_s:.3f} s "
          f"the first time here (in a new process that includes loading "
          f"PyTorch's meta kernels), {infer_s:.3f} s the second "
          f"({inferred[0] - before[0]} bytes in "
          f"{inferred[1] - before[1]} allocations), bind {bind_s:.3f} s: "
          f"{len(ex.arg_dict)} arguments, {len(ex.grad_dict)} gradients, "
          f"{got[0]} bytes in {got[1]} allocations (the bound arrays: "
          f"{want[0]} bytes, {want[1]} arrays); launches {counts} on {smi}")
    return inferred == before and got == want and not any(counts.values())


def _sym_vs_gluon(named, params, seed, smi):
    """(b): the encoder's output against the Gluon BERTModel's sequence
    output, dropout 0, both on the card."""
    ctx = gpu(0)
    model = bert_base(max_length=SYM_SEQ, dropout=0.0)
    load_jax_params(model, named, ctx=ctx)
    enc = encoder_output(_sym_net(0.0), SYM_CFG["layers"])
    ex = enc.simple_bind(ctx, grad_req="null", data=(SYM_BATCH, SYM_SEQ))
    ex.copy_params_from(params, allow_extra_params=True)
    tokens, _ = _sym_batches(seed, SYM_GLUON_BATCHES, SYM_BATCH, SYM_SEQ)
    worst = 0.0
    for i in range(SYM_GLUON_BATCHES):
        tok = tokens[i * SYM_BATCH:(i + 1) * SYM_BATCH]
        got = ex.forward(data=tok)[0].data
        t = nd.array(tok, ctx=ctx, dtype="int32")
        want = model(t, nd.zeros(tok.shape, ctx=ctx, dtype="int32"))[0].data
        err = ((got - want).abs().max()
               / max(1.0, want.abs().max().item())).item()
        worst = max(worst, err)
    print(f"23(b) the symbolic encoder vs the Gluon BERTModel, "
          f"{SYM_GLUON_BATCHES} batches of {SYM_BATCH} x {SYM_SEQ} f32: "
          f"max|d| / max(1, max|Gluon|) = {worst:.3g} (tol "
          f"{SYM_GLUON_TOL:g}) on {smi}")
    return worst <= SYM_GLUON_TOL


def _sym_fit(params, seed, smi, prefix):
    """(c) Module.fit, the fixed batch, score; (e)'s first predict and
    do_checkpoint at the epoch's end. Returns the module's launches."""
    ctx = gpu(0)
    random.seed(seed)
    tokens, labels = _sym_batches(seed, SYM_FIT_BATCHES, SYM_BATCH, SYM_SEQ)
    train = io.NDArrayIter(tokens, labels, batch_size=SYM_BATCH,
                           label_name="softmax_label")
    m = mmod.Module(_sym_net(SYM_DROPOUT), context=ctx)
    losses, stamps = [], []

    def batch_end(param):
        losses.append(_sym_loss(m, param.locals["data_batch"].label[0]))
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m.fit(train, num_epoch=1, optimizer="adam",
          optimizer_params={"learning_rate": SYM_LR}, arg_params=params,
          aux_params={}, eval_metric="acc", batch_end_callback=batch_end,
          epoch_end_callback=mcallback.do_checkpoint(prefix))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    step_ms = float(np.median(np.diff([t0] + stamps)[1:])) * 1e3
    fit_counts = _k123()
    # (e): the module's predictions right after the epoch
    pred_iter = io.NDArrayIter(tokens[:SYM_PREDICT_BATCHES * SYM_BATCH],
                               labels[:SYM_PREDICT_BATCHES * SYM_BATCH],
                               batch_size=SYM_BATCH,
                               label_name="softmax_label")
    _zero_counters()
    saved_pred = m.predict(pred_iter).data.clone()
    predict_counts = _k123()
    # (c): SYM_FIXED_STEPS steps on one fixed batch, then score
    _zero_counters()
    fixed = io.DataBatch(data=[nd.array(tokens[:SYM_BATCH], ctx=cpu())],
                         label=[nd.array(labels[:SYM_BATCH], ctx=cpu())])
    fixed_losses = []
    t1 = time.perf_counter()
    for _ in range(SYM_FIXED_STEPS):
        m.forward_backward(fixed)
        m.update()
        fixed_losses.append(_sym_loss(m, fixed.label[0]))
    torch.cuda.synchronize()
    fixed_s = time.perf_counter() - t1
    score = dict(m.score(train, "acc"))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    k1, k2, k3 = (a + b for a, b in zip(fit_counts, _k123()))
    layers = SYM_CFG["layers"]
    forwards = SYM_FIT_BATCHES + SYM_FIXED_STEPS + SYM_FIT_BATCHES
    backwards = SYM_FIT_BATCHES + SYM_FIXED_STEPS
    all_losses = torch.stack(losses + fixed_losses).cpu()
    tokens_s = SYM_BATCH * SYM_SEQ * SYM_FIXED_STEPS / fixed_s
    print(f"23(c) Module.fit BERT-base f32, Adam({SYM_LR:g}), dropout "
          f"{SYM_DROPOUT}: {SYM_FIT_BATCHES} batches of {SYM_BATCH} x "
          f"{SYM_SEQ} in {fit_s:.2f} s (step median {step_ms:.1f} ms), "
          f"losses {[round(x, 4) for x in all_losses[:SYM_FIT_BATCHES].tolist()]}"
          f"; fixed batch {[round(x, 4) for x in all_losses[SYM_FIT_BATCHES:].tolist()]}"
          f" ({tokens_s:.0f} tokens/s over {SYM_FIXED_STEPS} forward_backward"
          f" + update); score {score}; K1 {k1} (want {layers * forwards}), "
          f"K2 {k2}, K3 {k3} (want {layers * backwards}); peak device "
          f"memory {peak / 2**30:.2f} GiB on {smi}")
    ok = bool(torch.isfinite(all_losses).all()) \
        and all_losses[-1] < all_losses[SYM_FIT_BATCHES] \
        and k1 == layers * forwards and k2 == k3 == layers * backwards \
        and predict_counts == (layers * SYM_PREDICT_BATCHES, 0, 0)
    return ok, {"fit": (k1, k2, k3), "predict": predict_counts,
                "pred_iter": pred_iter, "saved_pred": saved_pred}


def _sym_checkpoint(prefix, fit, smi):
    """(e): the epoch's checkpoint, written by do_checkpoint, loaded by
    Module.load; its predictions bitwise the saved module's."""
    files = sorted(p.name for p in SYM_DIR.iterdir())
    want_files = [f"{Path(prefix).name}-0001.params",
                  f"{Path(prefix).name}-symbol.json"]
    m = mmod.Module.load(prefix, 1, context=gpu(0))
    m.bind(data_shapes=[("data", (SYM_BATCH, SYM_SEQ))],
           label_shapes=[("softmax_label", (SYM_BATCH,))],
           for_training=False)
    _zero_counters()
    got = m.predict(fit["pred_iter"]).data
    counts = _k123()
    same = torch.equal(got, fit["saved_pred"])
    print(f"23(e) do_checkpoint wrote {files}; Module.load + predict of "
          f"{SYM_PREDICT_BATCHES} batches bitwise the saved module's: "
          f"{same}; K1 {counts[0]} on {smi}")
    return same and files == want_files and \
        counts == (SYM_CFG["layers"] * SYM_PREDICT_BATCHES, 0, 0), counts


def _sym_bucketing(params, seed, smi):
    """(f): buckets 64 and 128 over shared parameter objects."""
    ctx = gpu(0)

    def sym_gen(key):
        return _sym_net(0.0), ("data",), ("softmax_label",)

    bm = mmod.BucketingModule(sym_gen, default_bucket_key=SYM_BUCKETS[-1],
                              context=ctx)
    bm.bind(data_shapes=[("data", (SYM_BATCH, SYM_BUCKETS[-1]))],
            label_shapes=[("softmax_label", (SYM_BATCH,))])
    bm.init_params(arg_params=params, aux_params={})
    bm.init_optimizer(optimizer="sgd",
                      optimizer_params={"learning_rate": SYM_SGD_LR})
    batches = {s: _SymBatch(*_sym_batches(seed, 1, SYM_BATCH, s), ctx)
               for s in SYM_BUCKETS}
    _zero_counters()
    short, long_ = SYM_BUCKETS
    bm.forward(batches[short], is_train=False)
    before = bm.get_outputs()[0].data.clone()
    shared = all(bm._buckets[short]._exec.arg_dict[k]
                 is bm._buckets[long_]._exec.arg_dict[k]
                 for k in params)
    bm.forward(batches[long_], is_train=True)
    bm.backward()
    bm.update()
    bm.forward(batches[short], is_train=True)
    bm.backward()
    bm.update()
    bm.forward(batches[short], is_train=False)
    after = bm.get_outputs()[0].data
    w = "layer0_qkv_weight"
    seen = torch.equal(bm._buckets[short]._exec.arg_dict[w].data,
                       bm._buckets[long_]._exec.arg_dict[w].data)
    counts = _k123()
    layers = SYM_CFG["layers"]
    moved = not torch.equal(before, after)
    print(f"23(f) BucketingModule buckets {SYM_BUCKETS}: parameter objects "
          f"shared: {shared}; the bucket-{long_} update seen by bucket "
          f"{short}: {seen and moved}; K1 {counts[0]} (want {layers * 4}), "
          f"K2 {counts[1]}, K3 {counts[2]} (want {layers * 2}) on {smi}")
    return shared and seen and moved and \
        counts == (layers * 4, layers * 2, layers * 2), counts


def _sym_subgraph(params, seed, smi):
    """(g): optimize_for(net, "xla") against the unpartitioned graph,
    outputs and every gradient bitwise; the unpartitioned graph run twice
    as the control of run-to-run repeatability."""
    ctx = gpu(0)
    net = _sym_net(0.0)
    part = subgraph.optimize_for(net, "xla")
    regions = sum(n.op == "_CachedSubgraph" for n in part._topo())
    tokens, labels = _sym_batches(seed, 1, SYM_SUBGRAPH_BATCH, SYM_SEQ)
    runs = {}
    for name, s in (("plain", net), ("partitioned", part),
                    ("control", net)):
        ex = s.simple_bind(ctx, data=(SYM_SUBGRAPH_BATCH, SYM_SEQ),
                           softmax_label=(SYM_SUBGRAPH_BATCH,),
                           grad_req={k: "null" if k in (
                               "data", "softmax_label") else "write"
                               for k in s.list_arguments()})
        ex.copy_params_from(params)
        _zero_counters()
        out = ex.forward(is_train=True, data=tokens, softmax_label=labels)
        ex.backward()
        torch.cuda.synchronize()
        runs[name] = ([o.data.clone() for o in out],
                      {k: g.data.clone() for k, g in ex.grad_dict.items()},
                      _k123())
        del ex, out
    plain, part_run, control = (runs[k] for k in ("plain", "partitioned",
                                                  "control"))
    outs_same = all(torch.equal(a, b) for a, b in zip(part_run[0], plain[0]))
    unrepeatable = sorted(k for k in plain[1]
                          if not torch.equal(plain[1][k], control[1][k]))
    differ = sorted(k for k in plain[1]
                    if not torch.equal(part_run[1][k], plain[1][k]))
    # a leaf the unpartitioned graph itself does not repeat bitwise is held
    # within 1e-4 x max(1, max|grad|) (f32 sums in another order)
    loose = {k: ((part_run[1][k] - plain[1][k]).abs().max()
                 / max(1.0, plain[1][k].abs().max().item())).item()
             for k in unrepeatable}
    layers = SYM_CFG["layers"]
    print(f"23(g) optimize_for(net, 'xla'): {regions} _CachedSubgraph "
          f"node(s); outputs bitwise: {outs_same}; gradients bitwise: "
          f"{len(plain[1]) - len(differ)} of {len(plain[1])}; leaves the "
          f"unpartitioned graph does not repeat bitwise: {unrepeatable} "
          f"(partitioned within {loose}); launches {part_run[2]} on {smi}")
    return regions >= 1 and outs_same \
        and set(differ) <= set(unrepeatable) \
        and all(v <= 1e-4 for v in loose.values()) \
        and part_run[2] == (layers, layers, layers), part_run[2]


def _sym_monitor(params, seed, smi):
    """(h): Monitor(1, ".*attention.*") over one batch: one stat per
    attention node, each finite."""
    m = _sym_module(_sym_net(0.0), gpu(0), SYM_BATCH, SYM_SEQ, params,
                    for_training=False)
    mon = mmonitor.Monitor(1, pattern=".*attention.*")
    m.install_monitor(mon)
    tokens, labels = _sym_batches(seed, 1, SYM_BATCH, SYM_SEQ)
    mon.tic()
    m.forward(io.DataBatch(data=[nd.array(tokens, ctx=cpu())],
                           label=[nd.array(labels, ctx=cpu())]),
              is_train=False)
    rows = mon.toc()
    names = [name for _, name, _ in rows]
    vals = [float(text.split("\t")[0]) for _, _, text in rows]
    want = [f"layer{i}_attention_output" for i in range(SYM_CFG["layers"])]
    print(f"23(h) Monitor(1, '.*attention.*'): {len(rows)} stats, "
          f"{names[:2]} ... {names[-1:]}, mean |x| {min(vals):.4g} .. "
          f"{max(vals):.4g} on {smi}")
    return names == want and all(math.isfinite(v) for v in vals)


def _sym_card_vs_cpu(params_of, smi):
    """(d): one f32 SGD step at batch 2 on the card against the same step
    on the CPU (plain versions), each leaf's update (w before - w after)
    held against the step's f64 update lr x gradient (the graph bound in
    f64 on the CPU, every op and the attention's plain versions in f64):
    the card's distance to it at most SYM_DRIFT_FACTOR times the CPU's f32
    distance, in largest element and in norm, each plus one f32 ulp of the
    leaf's largest weight (an f32 update is a difference of two f32
    weights)."""
    tokens, labels = _sym_batches(0, 1, SYM_CPU_BATCH, SYM_SEQ)
    batch = io.DataBatch(data=[nd.array(tokens, ctx=cpu())],
                         label=[nd.array(labels, ctx=cpu())])
    runs = {}
    for name, ctx in (("card", gpu(0)), ("cpu", cpu())):
        m = _sym_module(_sym_net(0.0), ctx, SYM_CPU_BATCH, SYM_SEQ,
                        params_of(ctx))
        m.init_optimizer(optimizer="sgd",
                         optimizer_params={"learning_rate": SYM_SGD_LR})
        before = {k: v.data.detach().cpu().clone()
                  for k, v in m.get_params()[0].items()}
        m.forward_backward(batch)
        m.update()
        loss = _xent(m.get_outputs()[0].data, batch.label[0].data).item()
        runs[name] = (loss, {k: (before[k] - v.data.detach().cpu()).double()
                             for k, v in m.get_params()[0].items()}, before)
        del m
    net = _sym_net(0.0)
    args = {k: nd.array(v.asnumpy(), ctx=cpu(), dtype="float64")
            for k, v in params_of(cpu()).items()}
    args["data"] = nd.array(tokens, ctx=cpu(), dtype="float64")
    args["softmax_label"] = nd.array(labels, ctx=cpu(), dtype="float64")
    ex = net.bind(cpu(), args=args, grad_req={
        k: "null" if k in ("data", "softmax_label") else "write"
        for k in args})
    loss64 = _xent(ex.forward(is_train=True)[0].data,
                   torch.as_tensor(labels)).item()
    ex.backward()
    u64 = {k: SYM_SGD_LR * g.data for k, g in ex.grad_dict.items()}
    (l_gpu, u_gpu, w0), (l_cpu, u_cpu, _) = runs["card"], runs["cpu"]
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    eps = torch.finfo(torch.float32).eps
    worst = {"max": (0.0, None), "norm": (0.0, None)}
    fails, reading = [], 0.0
    for k in u64:
        ulp = eps * w0[k].abs().max().item()
        for kind, dist in (("max", lambda d: d.abs().max().item()),
                           ("norm", lambda d: d.norm().item())):
            card, own = dist(u_gpu[k] - u64[k]), dist(u_cpu[k] - u64[k])
            ratio = card / (SYM_DRIFT_FACTOR * own + ulp)
            if ratio > worst[kind][0]:
                worst[kind] = (ratio, k)
            if ratio > 1:
                fails.append(f"{k} ({kind})")
        reading = max(reading, (u_gpu[k] - u_cpu[k]).abs().max().item()
                      / u_cpu[k].abs().max().item())
    print(f"23(d) one f32 SGD step at {SYM_CPU_BATCH} x {SYM_SEQ}, card vs "
          f"CPU plain versions: loss {l_gpu:.7f} vs {l_cpu:.7f} (relative "
          f"{rel:.3g}, tol {SYM_LOSS_RTOL:g}; f64 {loss64:.7f}); each "
          f"leaf's update against the f64 step's: card distance / "
          f"({SYM_DRIFT_FACTOR:g} x the CPU's f32 distance + 1 ulp) at most "
          f"{worst['max'][0]:.3g} ({worst['max'][1]}) in largest element, "
          f"{worst['norm'][0]:.3g} ({worst['norm'][1]}) in norm (tol 1); "
          f"card vs CPU update, largest over leaves of max|d| / max|CPU "
          f"update|: {reading:.3g}; beyond: {fails[:4]} on {smi}")
    return rel <= SYM_LOSS_RTOL and not fails


def _sym_kernel_check(shape, gen, smi):
    """K1, K2 and K3 f32 at ``shape`` on the card against their plain
    versions on the same inputs (the q, k, v of a split QKV projection):
    ``(ok, K1's max|d|, inputs and K1's outputs)``."""
    B, H, S, D = shape
    dt = torch.float32
    q, k, v = split_qkv(shape, gen, dt)
    do = _randn((B, S, H, D), gen, dt).transpose(1, 2)
    scale = D ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, scale, False)
    ref, ref_lse = fa.flash_attention_fwd_reference(q, k, v, scale, False)
    err = max((out - ref).abs().max().item(),
              (lse - ref_lse).abs().max().item())
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, do, lse, scale, False)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale,
                                        False)
    want_dq = fa.flash_attention_bwd_dq_reference(q, k, v, out, do, lse,
                                                  scale, False)
    want_dkv = fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                    scale, False)
    errs_dq, ok_dq = _bwd_errors((dq, delta), want_dq, dt)
    errs_dkv, ok_dkv = _bwd_errors((dk, dv), want_dkv, dt)
    print(f"23 K1 f32 {shape}: max|d| vs plain {err:.3g} (tol {TOL[dt]:g});"
          f" K2 max|d dq|, |d delta| {errs_dq}; K3 max|d dk|, |d dv| "
          f"{errs_dkv} (tol {TOL[dt]:g} x max(1, max|plain|)) on {smi}")
    ok = err <= TOL[dt] and ok_dq and ok_dkv
    return ok, err, (max(errs_dq), max(errs_dkv)), (q, k, v, do, out, lse)


def _sym_kernel_times(seed, smi):
    """K1, K2 and K3 f32 against their plain versions at SYM_SHAPE and at
    the first bucket's (half of each 128-row f32 query block masked), then
    timed at SYM_SHAPE through their wrappers and from CUDA graphs, beside
    SDPA's f32 forward and backward and the bounds (TF32 off for SDPA's
    products, as everywhere in the port)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 23)
    dt = torch.float32
    ok_bucket = _sym_kernel_check(
        (SYM_BATCH, 12, SYM_BUCKETS[0], 64), gen, smi)[0]
    ok, err, (err_dq, err_dkv), (q, k, v, do, out, lse) = \
        _sym_kernel_check(SYM_SHAPE, gen, smi)
    D = SYM_SHAPE[3]
    scale = D ** -0.5
    qc, kc, vc = (x.contiguous() for x in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qc, kc, vc, scale=scale)

    ms = median_ms(lambda: fa.flash_attention_fwd(q, k, v, scale, False),
                   calls=TIMED_CALLS)
    dev = graph_ms(lambda: fa.flash_attention_fwd(q, k, v, scale, False))
    plain = median_ms(lambda: fa.flash_attention_fwd_reference(
        q, k, v, scale, False), reps=20, warmup=2, calls=TIMED_CALLS)
    lib = median_ms(sdpa, calls=TIMED_CALLS)
    lib_dev = graph_ms(sdpa)
    bms, by, nbytes, flops = bound_ms(SYM_SHAPE, dt, False)
    print(f"23 K1 f32 {SYM_SHAPE}: kernel {ms:.4f} ms ({dev:.4f} ms from a "
          f"CUDA graph), plain {plain:.4f} ms, sdpa f32 {lib:.4f} ms "
          f"({lib_dev:.4f} ms from a CUDA graph), bound {bms * 1e3:.1f} us "
          f"({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
          f"{bms / dev:.1%} of bound from the graph on {smi}")
    rec = {"fwd": {"ms": ms, "device_ms": dev, "plain_ms": plain,
                   "library_ms": lib, "library_device_ms": lib_dev,
                   "bound_ms": bms, "bound_by": by, "max_abs_err": err}}
    rec["bwd"] = time_backward(q, k, v, out, lse, do, scale, False, smi,
                               SYM_SHAPE, dtype=dt)
    rec["dq_err"], rec["dkv_err"] = err_dq, err_dkv
    return ok and ok_bucket, rec


def phase_symbolic(seed: int, smi: str):
    """Phase 23: the symbolic API over BERT-base in f32 (see the module
    docstring, item 23)."""
    t_phase = time.perf_counter()
    shutil.rmtree(SYM_DIR, ignore_errors=True)
    SYM_DIR.mkdir(parents=True)
    prefix = str(SYM_DIR / "symbert")
    named = seeded_bert_weights(bert_base(max_length=SYM_SEQ), seed)
    params = _sym_params(named, seed, gpu(0))
    checks, secs = {}, {}
    marks = [time.perf_counter()]

    def part(name, result):
        marks.append(time.perf_counter())
        secs[name] = marks[-1] - marks[-2]
        return result

    checks["a"] = part("a", _sym_bind(_sym_net(SYM_DROPOUT), smi))
    checks["b"] = part("b", _sym_vs_gluon(named, params, seed, smi))
    checks["c"], fit = part("c", _sym_fit(params, seed, smi, prefix))
    checks["e"], predict = part("e", _sym_checkpoint(prefix, fit, smi))
    checks["f"], bucketing = part("f", _sym_bucketing(params, seed, smi))
    checks["g"], sub = part("g", _sym_subgraph(params, seed, smi))
    checks["h"] = part("h", _sym_monitor(params, seed, smi))
    checks["d"] = part("d", _sym_card_vs_cpu(
        lambda ctx: _sym_params(named, seed, ctx), smi))
    torch.cuda.empty_cache()
    checks["kernels"], times = part("kernels", _sym_kernel_times(seed, smi))
    shutil.rmtree(SYM_DIR, ignore_errors=True)
    print("23 seconds by part: " + ", ".join(f"({k}) {v:.1f}"
                                             for k, v in secs.items()))
    for name in sorted(checks):
        print(f"23({name}) holds: {checks[name]} on {smi}")
    failed = [name for name in sorted(checks) if not checks[name]]
    if failed:
        raise SystemExit(f"FAIL: 23({failed[0]})" + (
            f" (and {len(failed) - 1} more)" if len(failed) > 1 else ""))
    print(f"phase 23: {time.perf_counter() - t_phase:.1f} s")
    paths = {"symbol_fit": fit["fit"],
             "symbol_predict": tuple(a + b for a, b in zip(fit["predict"],
                                                           predict)),
             "symbol_bucketing": bucketing, "symbol_subgraph": sub}
    return {"paths": paths, "times": times}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dist-worker", action="store_true",
                    help="run as one rank of phase 16's training job")
    ap.add_argument("--slice17-worker", action="store_true",
                    help="run as one rank of phase 17's two-rank job")
    ap.add_argument("--slice18-worker", choices=("det", "tp"),
                    help="run as phase 18's deterministic process (det) or "
                         "one rank of its two-rank job (tp)")
    ap.add_argument("--slice20-worker", choices=("A", "B", "C"),
                    help="run as one of phase 20(a)'s cache processes")
    ap.add_argument("--slice21-worker", action="store_true",
                    help="run as phase 21(d)'s deterministic process")
    ap.add_argument("--slice22-worker", action="store_true",
                    help="run as phase 22's process (goodput, the debug "
                         "server and the fleet pane)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    if args.dist_worker:
        return dist_worker(args.seed)
    if args.slice17_worker:
        return slice17_worker(args.seed)
    if args.slice18_worker:
        return slice18_worker(args.slice18_worker, args.seed)
    if args.slice20_worker:
        return slice20_worker(args.slice20_worker, args.seed)
    if args.slice21_worker:
        return slice21_worker(args.seed)
    if args.slice22_worker:
        return slice22_worker(args.seed)
    t_start = time.perf_counter()
    marks = [t_start]

    def timed(label, result=None):
        """Print the seconds since the previous mark (phases 1-14 print no
        time of their own; 15-22 do)."""
        now = time.perf_counter()
        print(f"phase {label}: {now - marks[-1]:.1f} s", flush=True)
        marks.append(now)
        return result

    smi = card()
    timed("1 environment", phase_environment(smi))
    record = timed("2 kernel", phase_kernel(args.seed, smi))
    bwd = timed("2b backward", phase_backward(args.seed, smi))
    k4 = timed("2c fused_conv", phase_fused_conv(args.seed, smi))
    serve_launches = timed("3 slice", phase_slice(args.seed, smi))
    train_launches = timed("4 train", phase_train(args.seed, smi))
    resnet = timed("5 resnet", phase_resnet(args.seed, smi))
    k5 = timed("6 rtc", phase_rtc(args.seed, smi))
    gen = timed("7 generate", phase_generate(args.seed, smi))
    glu = timed("8 gluon", phase_gluon(args.seed, smi))
    lm = timed("9 ops_rnn", phase_ops_rnn(args.seed, smi))
    det = timed("10 ssd", phase_ssd(args.seed, smi))
    amp_rec = timed("11 amp", phase_amp(args.seed, smi))
    sp = timed("12 sparse", phase_sparse(args.seed, smi))
    data = timed("13 data", phase_data(args.seed, smi, resnet))
    util = timed("14 utilities", phase_utilities(args.seed, smi, resnet,
                                                 data))
    quant = phase_quantization(args.seed, smi, resnet, util)
    dist = phase_distributed(args.seed, smi)
    s17 = phase_slice17(args.seed, smi)
    s18 = phase_resilience(args.seed, smi)
    s19 = phase_multitenant(args.seed, smi)
    s20 = phase_fabric(args.seed, smi)
    s21 = phase_telemetry(args.seed, smi)
    s22 = phase_fleet(args.seed, smi)
    s23 = phase_symbolic(args.seed, smi)
    sym_paths = s23["paths"]
    q_hand = {"int8_resnet": {k: quant["resnet"]["f32"]["hand"][k]
                              + quant["resnet"]["int8"]["hand"][k]
                              for k in ("K1", "K2", "K3", "K4", "K5")},
              "int8_bert": quant["bert"]["hand"],
              "kvstore_resnet": {k: sum(v["hand"][k] for v in
                                        quant["kvstore"].values())
                                 for k in ("K1", "K2", "K3", "K4", "K5")}}
    # per rank: K1-K3 on the paths of phases 16, 17 and 18 (rank 0), and
    # phase 18's and phase 21's one-process paths
    d_hand = {**dist["hand"], "ring_attention": s17["hand"],
              "resilience_bert": s18["det"],
              "resilience_nondeterministic_check": s18["nondet"],
              "resilience_tp_bert": s18["tp"], **s21["hand"],
              **s22["hand"]}
    ring = {c: s17["blocks"][c] for c in (False, True)}
    f16 = amp_rec["fp16"]
    amp_launches = {path: amp_rec[path]["launches"]
                    for path in ("amp_bf16", "amp_fp16")}
    r, tr = record["serving", torch.bfloat16], record["training", torch.bfloat16]
    pallas = "mxnet_tpu/ops/pallas/flash_attention.py"
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": f"{pallas}:213",
         "launches": serve_launches + train_launches["flash_attention_fwd"]
         + gen["launches"] + glu["launches"]["flash_attention_fwd"]
         + lm["k1_op_surface"] + lm["hand"]["K1"] + det["hand"]["K1"]
         + sum(c["flash_attention_fwd"] for c in amp_launches.values())
         + sp["hand"]["K1"] + data["hand"]["K1"] + util["hand"]["K1"]
         + sum(h["K1"] for h in q_hand.values())
         + sum(h["K1"] for h in d_hand.values()) + sum(s19.values())
         + sum(s20.values()) + sum(s21["k1"].values())
         + sum(s22["k1"].values()) + sum(c[0] for c in sym_paths.values()),
         "launches_by_path": {
             "serving": serve_launches,
             "training": train_launches["flash_attention_fwd"],
             "generate": gen["launches"],
             "gluon_training": glu["launches"]["flash_attention_fwd"],
             "nd_op_surface": lm["k1_op_surface"],
             "lstm_lm": lm["hand"]["K1"], "ssd": det["hand"]["K1"],
             "amp_bf16": amp_launches["amp_bf16"]["flash_attention_fwd"],
             "amp_fp16": amp_launches["amp_fp16"]["flash_attention_fwd"],
             "sparse_lm": sp["hand"]["K1"],
             "data_resnet": data["hand"]["K1"],
             "estimator_resnet": util["hand"]["K1"],
             **{path: h["K1"] for path, h in q_hand.items()},
             **{path: h["K1"] for path, h in d_hand.items()}, **s19,
             **s20, **s21["k1"], **s22["k1"],
             **{path: c[0] for path, c in sym_paths.items()}},
         "max_abs_err": max(r["max_abs_err"], tr["max_abs_err"],
                            gen["k1_max_abs_err"],
                            *(ring[c]["fwd"]["max_abs_err"]
                              for c in (False, True))),
         "ms": r["ms"], "ms_strided": r["ms_strided"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "library": "scaled_dot_product_attention forward",
         "shape": list(BERT_SHAPE), "dtype": "bfloat16",
         "ms_training_shape": tr["ms"],
         "ms_strided_training_shape": tr["ms_strided"],
         "plain_ms_training_shape": tr["plain_ms"],
         "bound_ms_training_shape": tr["bound_ms"],
         "library_ms_training_shape": tr["library_ms"],
         "device_ms": r["device_ms"],
         "library_device_ms": r["library_device_ms"],
         "device_ms_training_shape": tr["device_ms"],
         "library_device_ms_training_shape": tr["library_device_ms"],
         "causal_prefill": gen["k1_timed"],
         "max_abs_err_fp16": f16["fwd_err"],
         "ms_fp16": f16["serving"]["fwd"]["device_ms"],
         "plain_ms_fp16": f16["serving"]["fwd"]["plain_ms"],
         "bound_ms_fp16": f16["serving"]["fwd"]["bound_ms"],
         "library_ms_fp16": f16["serving"]["library_ms_fwd"],
         "ms_fp16_training_shape": f16["training"]["fwd"]["device_ms"],
         "bound_ms_fp16_training_shape": f16["training"]["fwd"]["bound_ms"],
         "library_ms_fp16_training_shape":
             f16["training"]["library_ms_fwd"],
         "ring_block_shape": list(RING_BLOCK),
         **{f"{key}_ring_block{'_causal' if c else ''}": ring[c]["fwd"][key]
            for c in (False, True)
            for key in ("ms", "device_ms", "plain_ms", "bound_ms",
                        "library_ms", "max_abs_err")},
         "host_us": record["host_us"]["k1"],
         "entry_host_us": record["host_us"]["entry"],
         "library_host_us": record["host_us"]["sdpa"],
         "symbolic_shape": list(SYM_SHAPE),
         **{f"{key}_f32_symbolic_shape": s23["times"]["fwd"][key]
            for key in ("ms", "device_ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms", "library_device_ms",
                        "max_abs_err")}}]
    for i, (name, wrapper, line, k) in enumerate((
            ("dq", "flash_attention_bwd_dq", 403, "K2"),
            ("dkv", "flash_attention_bwd_dkv", 421, "K3"))):
        t, sv = bwd["training"], bwd["serving"]
        sym_bwd = s23["times"]["bwd"]
        kernels.append({
            "name": wrapper, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"{pallas}:{line}",
            "launches": train_launches[wrapper] + glu["launches"][wrapper]
            + lm["hand"][k] + det["hand"][k]
            + sum(c[wrapper] for c in amp_launches.values())
            + sp["hand"][k] + data["hand"][k] + util["hand"][k]
            + sum(h[k] for h in q_hand.values())
            + sum(h[k] for h in d_hand.values())
            + sum(c[i + 1] for c in sym_paths.values()),
            "launches_by_path": {
                "training": train_launches[wrapper],
                "gluon_training": glu["launches"][wrapper],
                "lstm_lm": lm["hand"][k], "ssd": det["hand"][k],
                "amp_bf16": amp_launches["amp_bf16"][wrapper],
                "amp_fp16": amp_launches["amp_fp16"][wrapper],
                "sparse_lm": sp["hand"][k],
                "data_resnet": data["hand"][k],
                "estimator_resnet": util["hand"][k],
                **{path: h[k] for path, h in q_hand.items()},
                **{path: h[k] for path, h in d_hand.items()},
                **{path: c[i + 1] for path, c in sym_paths.items()}},
            "max_abs_err": max(bwd[f"{name}_err"], *(
                ring[c][f"max_abs_err_{name}"] for c in (False, True))),
            "ms": t[name]["ms"],
            "device_ms": t[name]["device_ms"],
            "plain_ms": t[name]["plain_ms"],
            "plain": f"{wrapper}_reference",
            "bound_ms": t[name]["bound_ms"], "bound_by": t[name]["bound_by"],
            "library_ms": t["library_ms"],
            "library_device_ms": t["library_device_ms"],
            "library": "scaled_dot_product_attention backward (dq, dk, dv "
                       "together)",
            "shape": list(TRAIN_SHAPE), "dtype": "bfloat16",
            "backward_ms": t["bwd"]["ms"],
            "backward_device_ms": t["bwd"]["device_ms"],
            "backward_bound_ms": t["bwd"]["bound_ms"],
            "ms_serving_shape": sv[name]["ms"],
            "device_ms_serving_shape": sv[name]["device_ms"],
            "plain_ms_serving_shape": sv[name]["plain_ms"],
            "bound_ms_serving_shape": sv[name]["bound_ms"],
            "library_ms_serving_shape": sv["library_ms"],
            "library_device_ms_serving_shape": sv["library_device_ms"],
            "ring_block_shape": list(RING_BLOCK),
            **{f"{key}_ring_block{'_causal' if c else ''}":
               ring[c][name][key] for c in (False, True)
               for key in ("ms", "device_ms", "plain_ms", "bound_ms")},
            **{f"library_ms_ring_block{'_causal' if c else ''}":
               ring[c]["library_device_ms"] for c in (False, True)},
            **{f"max_abs_err_ring_block{'_causal' if c else ''}":
               ring[c][f"max_abs_err_{name}"] for c in (False, True)},
            "max_abs_err_fp16": f16[f"{name}_err"],
            "ms_fp16": f16["training"][name]["device_ms"],
            "plain_ms_fp16": f16["training"][name]["plain_ms"],
            "bound_ms_fp16": f16["training"][name]["bound_ms"],
            "library_ms_fp16": f16["training"]["library_ms_bwd"],
            "ms_fp16_serving_shape": f16["serving"][name]["device_ms"],
            "bound_ms_fp16_serving_shape": f16["serving"][name]["bound_ms"],
            "library_ms_fp16_serving_shape":
                f16["serving"]["library_ms_bwd"],
            "symbolic_shape": list(SYM_SHAPE),
            **{f"{key}_f32_symbolic_shape": sym_bwd[name][key]
               for key in ("ms", "device_ms", "plain_ms", "bound_ms",
                           "bound_by")},
            "library_ms_f32_symbolic_shape": sym_bwd["library_ms"],
            "library_device_ms_f32_symbolic_shape":
                sym_bwd["library_device_ms"],
            "max_abs_err_f32_symbolic_shape": s23["times"][f"{name}_err"]})
    s2 = k4["shapes"]["s2_reduce"]
    kernels.append({
        "name": "conv1x1_bn_act", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/fused_conv1x1.cu",
        "replaces": "mxnet_tpu/ops/pallas/fused_conv1x1.py:84",
        "launches": resnet["k4_launches"] + resnet["train_launches"]
        + lm["hand"]["K4"] + det["hand"]["K4"]
        + sum(amp_rec[p]["others"]["K4"] for p in amp_launches)
        + sp["hand"]["K4"] + data["hand"]["K4"] + util["hand"]["K4"]
        + sum(h["K4"] for h in q_hand.values()),
        "launches_by_path": {"resnet50_training":
                             resnet["train_launches"],
                             "resnet50_bottleneck_sites":
                             resnet["k4_launches"],
                             "lstm_lm": lm["hand"]["K4"],
                             "ssd": det["hand"]["K4"],
                             "amp_bf16": amp_rec["amp_bf16"]["others"]["K4"],
                             "amp_fp16": amp_rec["amp_fp16"]["others"]["K4"],
                             "sparse_lm": sp["hand"]["K4"],
                             "data_resnet": data["hand"]["K4"],
                             "estimator_resnet": util["hand"]["K4"],
                             **{path: h["K4"] for path, h in
                                q_hand.items()}},
        "max_abs_err": k4["max_abs_err"], "ms": s2["ms"],
        "device_ms": s2["device_ms"], "plain_ms": s2["plain_ms"],
        "bound_ms": s2["bound_ms"], "bound_by": s2["bound_by"],
        "library_ms": s2["library_ms"],
        "library_device_ms": s2["library_device_ms"],
        "library": "torch.matmul of the pre-activated bf16 x with w (the "
                   "product alone)",
        "composition_ms": s2["composition_ms"],
        "composition_device_ms": s2["composition_device_ms"],
        "composition": "relu(addcmul(shift, x, scale)) to bf16, torch.mm "
                       "with an f32 result, y to bf16, column sums of y "
                       "and y^2 (tools/k4_compare.py)",
        "shape": [s2["M"], s2["K"], s2["N"]], "dtype": "bfloat16",
        "by_shape": k4["shapes"]})
    head = k5["by_kernel"]["gelu_tanh_fwd"]   # the differentiable path's
    kernels.append({
        "name": "rtc", "route": "cuda", "source": "mxnet_tpu_torch/rtc.py",
        "kernel_sources": sorted(f"mxnet_tpu_torch/csrc/rtc/{f}"
                                 for f in set(rx.SOURCES.values())),
        "replaces": "mxnet_tpu/rtc.py:64",
        "launches": k5["launches"] + lm["hand"]["K5"] + det["hand"]["K5"]
        + sum(amp_rec[p]["others"]["K5"] for p in amp_launches)
        + sp["hand"]["K5"] + data["hand"]["K5"] + util["hand"]["K5"]
        + sum(h["K5"] for h in q_hand.values()),
        "launches_by_path": {"rtc": k5["launches"],
                             "lstm_lm": lm["hand"]["K5"],
                             "ssd": det["hand"]["K5"],
                             "amp_bf16": amp_rec["amp_bf16"]["others"]["K5"],
                             "amp_fp16": amp_rec["amp_fp16"]["others"]["K5"],
                             "sparse_lm": sp["hand"]["K5"],
                             "data_resnet": data["hand"]["K5"],
                             "estimator_resnet": util["hand"]["K5"],
                             **{path: h["K5"] for path, h in
                                q_hand.items()}},
        "max_abs_err": max(v["max_abs_err"]
                           for v in k5["by_kernel"].values()),
        "ms": head["ms"], "device_ms": head["device_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "library_device_ms": head["library_device_ms"],
        "headline": "gelu_tanh_fwd",
        "compile_seconds": k5["compile_seconds"],
        "launch_host_us": k5["rtc_launch_us"],
        "torch_add_host_us": k5["torch_add_us"],
        "by_kernel": k5["by_kernel"]})
    print(f"chip_smoke.py phases 1-23: {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
