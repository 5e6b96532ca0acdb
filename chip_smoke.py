#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds every CUDA kernel of the port from ``analytics_zoo_tpu_torch/
   csrc`` with ``nvcc`` (into ``build/``; one ``nvcc`` per source, all
   started together) and prints the build time.
2. Forward kernel phase: holds K2 (bf16: wgmma on TMA-fed tiles; f32:
   CUDA-core FMAs) against its plain PyTorch version at BERT-base
   attention shapes (B=8, H=12, T=512, D=64; f32 and bf16, key padding, a
   causal case, a t_q != t_kv case, a fully masked row) and
   times it beside the plain version, ``scaled_dot_product_attention``
   (timed here only, as a yardstick) and its roofline bound.
3. Backward kernel phase: holds K3a (dq) and K3b (dk/dv) against their
   plain versions at the same shapes (key padding, causal, t_q != t_kv
   both ways, a fully masked batch row whose gradients must be exactly 0)
   and against themselves: the same bits on a second run.
4. Serving phase: a full-width BERT-base ``BERTClassifier`` (random
   weights from a seed, bf16 policy, ``zoo.pallas.attention=true``) behind
   ``InferenceModel`` and ``ClusterServing(batch_size=32)`` on a
   ``LocalBackend`` answers 256 records of 512 tokens. Every answer is
   checked (finite, sums to 1, agrees with the port's oracle attention
   route), and the kernel launch counts prove the path went through the
   kernels. Each serving run has its own ``MetricsRegistry``. The flood
   (256 pre-enqueued records) runs four times in turns: plain (no sinks,
   untraced records), traced (a ``JsonEventSink``, ``serve_metrics(0)``,
   trace ids), traced, plain, each run's records/s printed. Then the
   paced run: 1024 records enqueued by a producer thread at half the
   traced flood's records/s. For the traced flood and the paced run it
   prints p50/p95/p99 of queue wait, dispatch and end to end, the goodput
   split and ``/statusz``'s device memory row, and gates: the e2e and
   queue-wait summary counts equal the records answered, the dispatch
   count the batches; every traced record has its four phases in order
   with their parents and ``e2e_s`` at least its publish ``dur_s`` less
   1 ms; ``/healthz`` reads ok while serving; ``/statusz``'s device block
   reads ``gpu`` with memory in use and the card's size as limit; the
   goodput categories sum to the ledger's wall within 1%. In the paced
   run ``POST /profilez`` gives 200 (a second one 409) and the capture's
   trace names K2's kernel (``flash_fwd_wgmma``); the port's status CLI,
   a subprocess on the live endpoint, exits 0, and 2 under
   ``--slo-p99-ms 0.001``.
5. Training phase: the JAX package's seq-512 fine-tune configuration
   (BERT-base, vocab 30522, bf16 compute with f32 params, AdamW lr 2e-5,
   batch 32) through ``compile``/``fit`` on 256 seeded records: one
   warm-up epoch, then one timed epoch of 8 steps. Checks a finite loss,
   moved parameters, 12 launches per step of each of K2, K3a and K3b,
   and one step's gradients against the oracle attention route.

6. CE kernel phase: holds K4, K5a and K5b (the fused LM-head
   cross-entropy) against their plain versions at N=4100, H=512, in f32
   and bf16: V=8192 and a ragged V=8000, no bias, labels of -1 on every
   third row (loss 0, dh rows exactly 0), three over-range labels (NaN in
   those rows and in dW) and one bias entry of 100 over a ragged row tile.
   Each case runs twice and K5b's dW/db must be the same bits; every
   kernel must report its wgmma route in bf16 and its FMA route in f32.
7. LM training phase: the JAX package's 4k long-context configuration
   (``bench.py:415-438``: ``Sequential([TransformerLayer(vocab=8192,
   seq_len=4096, n_block=4, hidden_size=512, n_head=8, causal),
   Dense(8192)])``, Adam lr 3e-4, ``scce_with_logits``, bf16 compute with
   f32 params, batch 16) through ``compile``/``fit`` on 32 sequences of
   ``y = (7x + 13) mod 8192`` with every flag at ``auto``: a warm-up of
   two epochs, then two timed epochs of two steps. Checks the loss gate,
   1 launch per step of K4/K5a/K5b (every one on its wgmma route) and 4
   of K2/K3a/K3b, one step's
   gradients against the full-logits oracle, and that the fused route's
   peak memory over that step is at least one bf16 logits tensor lower.
   Then prints the JAX bench's ``fused_ce_speedup`` (``bench.py:254-325``:
   one forward and backward of the fused loss against the full-logits
   objective at 32,768 rows, best of three; not gated).
7b. 32k long-context phase: the JAX bench's second tag
   (``bench.py:424-428``: the 4k model at seq 32768, batch 1, 4
   sequences), uncut, with every flag at ``auto``, once for each
   ``zoo.train.remat`` mode (``false``, ``dots``, ``full``) from the same
   weights: the first step's loss and gradients through the loop's own
   step, its launches and peak memory, the bench's two fits of two
   epochs (tokens/s of the best timed epoch, ms a step, MFU by
   ``bench.py:457-460`` over the dense bf16 peak, peak memory over the
   fits, launches a step and the CE routes) and one profiled epoch's busy
   share. Gates: each fit's loss drop, one launch a step of K3a/K3b a
   block and of K5a/K5b, one of K2 a block and of K4 without remat and
   two under it (the recompute), every CE kernel on its wgmma route, and
   each remat mode's first step against ``false``'s: the loss's bits,
   every gradient leaf that ``false`` gives the same bits twice bit for
   bit and any other within ``LM_GRAD_REL_TOL``. Once more under
   ``zoo.train.scan_steps`` 2 with ``full`` (the step captured in CUDA
   graphs, the recompute drawing from each step generator's twin): its
   step losses against the eager ``full`` fit's (bits, else 1e-6
   relative). Then K2, K3a and K3b at T = 32768 (causal, bf16) against
   their plain versions on a cut (out, lse and dq on the last 2048 query
   rows against every key, dk and dv for one head at full length; the
   same gradient bits twice) and timed beside SDPA, and K4, K5a and K5b
   at the 32,768-row head as at the 4k LM's 65,536.
7c. BERT NER phase: ``BERTNER(num_entities=9)`` at BERT-base width and
   the JAX class's defaults (vocab 40990, seq 512) with ``attn_drop`` 0
   and hidden dropout 0.1, bf16 compute, AdamW 5e-5, batch 32, on 256
   rows (ids drawn as ``bench.py:196-197`` draws them, valid lengths
   64..512, tags ``id mod 9`` and -1 past each length): a warm-up and a
   timed epoch of 8 steps, samples/s and a profiled epoch's busy share.
   Gates: the loss falls, 12 launches a step of K2, K3a and K3b, the
   first batch's loss the same bits with other ids past the valid
   lengths, ``predict_tags`` = argmax ``predict``; then ``BERTSQuAD`` at
   the same width: ``predict_spans`` over a batch, end >= start.
7d. KNRM phase: a seeded corpus of a 20,000-word vocabulary (4096
   queries of 10 words, five docs of 40 each, the first relevant)
   through ``TextSet`` (tokenize, ``word2idx``, ``shape_sequence``) and
   relation pairs, ``KNRM`` at the JAX class's widths (embed 300, 21
   kernels) trained with ``rank_hinge`` for 3 epochs of batch 512:
   records/s, busy share, NDCG@3 and MAP over 256 held-out queries'
   lists. Gates:
   the loss falls, the metrics in [0, 1], and no hand-written kernel
   launched (none lies on this path).

8. CE hidden-width phase: K4/K5a/K5b against their plain versions at
   N=4100, V=8192, bf16, H = 100 (padded to 128), 1280 and 2048 (H staged
   in two slices), each timed.
9. Embedding kernel phase: K1 (the dedup'd expand) and SA (the dedup
   scatter-add) against their plain versions at the NCF path's shapes
   (the first batch's user and item ids, capacities 8192 and 4096, D=20)
   and at a DLRM-Terabyte width (D=128, N=2048x26 ids over a million
   rows, f32 and bf16): K1 bit for bit, SA bit for bit against the CPU's
   position-order sum and the same bits over two runs, both through the
   forward's sort (the engine's call: one device kernel) and standalone
   (it sorts first). Each is timed beside ``index_select`` /
   ``index_add_`` and its byte bound (SA's also beside the byte time of
   the int64 sorted positions and slots it reads in place of the ids).
10. NCF phase: the JAX package's NeuralCF bench configuration
   (``bench.py:50-52, 1279-1285``: ``NeuralCF(6040, 3706, 5)``, Adam lr
   1e-3, ``scce``, batch 8192, 1,000,000 MovieLens-1M-shaped ratings from
   numpy seed 0, ``FeatureSet.array(x, y, seed=0)``), then the same graph
   on ``ShardedEmbedding`` tables: a warm-up epoch and two timed epochs of
   122 steps each. Checks the loss gate (last epoch below the first and
   below ln 5), 4 launches per step of K1 and of SA on the sharded graph
   and none on the stock model, the device kernels of one forward and one
   backward of the sharded graph (a CUDA graph's kernel nodes: SA four times in
   the backward, no sort or search there), one step's gradients of the
   two from the same weights (1e-5 relative per leaf), the same dW bits
   over two
   backward passes, and ``recommend_for_user`` against a plain eager
   forward. Each configuration is fitted four times from the same start,
   in turns: the eager loop, the JAX bench's dispatch keys
   (``zoo.train.scan_steps=16``, ``device_cache=true``; ``fuse_epochs=2``
   for the two timed epochs, the bench's 12 cut), the keys again, the
   eager loop; each prints records/s, ms a step and the device's busy
   share over one more epoch under ``torch.profiler``; the keyed fits'
   K1 and SA count 4 a step under CUDA-graph replay. The keyed loop runs
   once more with the device permutation replaced by the FeatureSet's own
   order: its step losses against the eager loop's (the same bits, or
   within 1e-6 relative, printed which).
10a. Disk fit phase: the NCF phase's ratings saved as ``.npy`` files in a
   temporary directory, ``NeuralCF(6040, 3706, 5)`` fitted eagerly (every
   batch through ``prefetch_to_device``) on a ``DiskFeatureSet`` of two
   slices in rotation mode for one full pass, and again on
   ``FeatureSet.array`` of each slice in turn: the same step losses bit
   for bit; the IO path that read the files (``native``: the port's
   ``libzoo_io`` built into ``build/native``) and records/s of both.
10c. Out-of-core embedding phase: the JAX bench's
   ``bench_embedding_oocore`` (``bench.py:326-389``) at its 2 MB hot
   budget (8,192 hot rows of 81,920, d 64) and at the default 64 MB
   (262,144 of 2,621,440, a 671 MB table in host memory): 24 batches of
   4096 zipf(1.1) ids (numpy seed 7), plans staged by the prefetch thread,
   one upload and the two-tier gather each; prints
   ``embedding_oocore_recs_per_sec``, ``embedding_dedup_rows_saved_ratio``,
   ``embedding_oocore_cache_hit_rate`` and the table and hot row counts.
   Gates: the rows the master table's gather bit for bit, the counters
   what numpy's plan gives on the same ids, one batch's gradient through
   SA against the dense scatter-add (1e-6 relative) and the same bits
   twice, and a stream under an ``embed.prefetch`` error plan (calls 0
   and 2) the same rows with 2 errors counted.
10b. Wide & Deep phase: the JAX bench's Census configuration
   (``bench.py:105-160``: 200,000 synthetic rows from numpy seed 1,
   ``WideAndDeep("wide_n_deep", 2, hidden (40, 20, 10))``, wide dims 2,
   10, 20, indicator 16, embeds 10 -> 16 twice, two continuous columns)
   through ``NNClassifier`` (``feature_preprocessing`` =
   ``info.input_arrays``), Adam 1e-3, batch 8192, under the bench's keys
   (``scan_steps=16``, ``device_cache``, ``fuse_epochs=12``): a warm-up
   ``clf.fit(table)`` and a warm-up 6-epoch ``fit_feature_set``, then
   three timed 6-epoch dispatches, each in turns with the same fit on the
   eager loop; prints ``wide_deep_train_samples_per_sec`` (median of the
   dispatches' best epochs) and ``wide_deep_max_samples_per_sec``, and,
   for one profiled fit of each loop, the device's busy share, the top
   kernels with their share and the embedding gradient's share. Gates:
   the captured fit's per-epoch losses against the eager fit's in the
   same batch order (bits, else 1e-4), the loss falling,
   ``NNClassifierModel.transform`` = argmax of ``predict``, ``NNModel.save``
   here and ``NNModel.load(...).transform`` in a child process the same
   predictions bit for bit, and an ``Estimator(optim_methods={"dense":
   "sgd"}, model_dir=...)`` run resumed from its snapshot after epoch 2
   ending on the uninterrupted run's parameters (bits, else 1e-3).

11. int8 kernel phase: K6 (the int8 weight-only dequant-matmul,
   ``csrc/quantized.cu``) against its plain version in f32 and bf16 at
   the head's batch-1, batch-8 and batch-32 shapes (K = N = 4096; at 32
   also with the dense layer's bias and ReLU fused into the skinny kernel,
   which must give the bits of the unfused kernel followed by the two
   torch ops), BERT-base's qkv and fc/out products (M = 32 x 512), BERT's
   Dense(2) head, a ragged (17, 100, 10) and a (300, 100, 130) whose rows
   TMA cannot address, each checked for the kernel it takes (skinny at
   M <= 32, fma in f32, wgmma in bf16 where K % 8 and N % 16 are 0, else
   mma), in both modes (dequantize-first, which ``dense`` runs, and the
   Pallas contract's scale-after): f32 within 1e-4 of the case's largest
   value, bf16 within one bf16 step there, the same bits over two runs;
   each timed in the first mode (wrapper, CUDA-graph device time, plain,
   ``torch.matmul`` on the dequantized weight, bound; with the route and
   the K slices the C entry point reported for the timed calls, checked
   against the route expected; the fused case with the unfused
   sequence's device time beside) with the second mode's device time
   beside. The static path's padded ``torch._int_mm`` bit for bit against
   the CPU's int32 product at M = 1 and 32.
11b. Static int8 kernel phase (fault j): Q8 (the static int8 dense
   layer, ``csrc/quantized.cu``: quantize, int8 x int8 -> int32 by dp4a,
   rescale, bias, ReLU, split K with a PDL reduce) against its plain
   version (the static path's torch ops, the padded ``_int_mm``) on the
   card and on the CPU, bit for bit and the same bits twice, at M = 1, 7
   and 32 with K = N = 4096, at the head's Dense(8) (M = 1 and 32) and at
   K = 1000, each without and with the bias and the fused ReLU; each timed
   beside the plain version, ``torch._int_mm`` alone on the padded
   operands and with its padding, and the bound.
12. int8 serving phase (config B): the serving phase's BERT-base, records
   and adapter on the weight-only int8 ``InferenceModel`` that
   ``ClusterServing._wrap_model`` builds for ``dtype="int8"``: every matmul
   weight int8 on the device, 50 K6 and 12 K2 launches per dispatch (48
   of the K6 ones, every product over the 32 x 512 tokens, on the wgmma
   tile kernel, the pooler and the Dense(2) head on the skinny one), the
   answers within 2e-2 of bf16 serving on the dequantized weights (and,
   printed beside, of bf16 serving on the weights the JAX predict forms,
   ``bf16(q) * bf16(s)``, which K6's dequantize-first mode forms too).
12b. Lanes phase: K2 launched from a fresh thread as its first CUDA
   work gives the main thread's bits (fault m). Then one
   ``ClusterServing`` with two lanes on one stream, ``bert`` (the
   serving phase's BERT-base, bf16, behind its adapter) and ``head`` (the
   JAX bench's head as ``{"model": net, "dtype": "int8"}``), 256 records
   each, interleaved and pre-enqueued, in turns with ``bert`` alone:
   every record answered by its own lane, against each lane's predict
   of the same batches ``bert`` within 2e-2 and ``head`` within 1e-4
   relative (and within 2e-2 of one predict of all its rows: the compute
   policy is process-wide, as in the JAX package, so under BERT's bf16
   policy the head's products run K6 in bf16), 12 K2 launches a ``bert``
   dispatch and 4 K6 (all skinny) a ``head`` dispatch, 256 records a
   lane; records/s a lane, dispatch and e2e p50/p99, answer times, bucket
   hit rates and pad rows printed. Ragged waves (1, 3, 2, 3, 1) under
   ``shape_buckets="4,16,32"``: the model sees only those row counts,
   the pad rows are the rows seen less the records, the answers are the
   unpadded predict's (2e-2); five pre-enqueued batches two in flight
   give the bits of one at a time (an arena released early would show).
   1024 pre-enqueued records without and with ``shed_watermark=64``:
   answered + shed = 1024 exactly, the admitted e2e p99 under half the
   unshedded run's; the two lanes weighted 3:1 under watermark 16
   (admitted shares printed). 64 records past their ``deadline_ms``:
   ``deadline exceeded``, no K2 launch. Paced runs with
   ``adaptive_batch`` at queue-wait targets of 100 and 20 ms: the AIMD
   target's trajectory stays in [1, 32] and the gauges read the
   controller. A head-lane wrapper raising on marked
   records with ``dispatch_retries=1`` and a ``DeadLetterQueue``: the
   marked records dead-lettered and spilled with their lane, their
   batch-mates answered (2e-2), the ``bert`` lane's counts untouched;
   ``replay`` onto a server with the plain head under a ``serving.loop``
   fault fired once: one supervised restart, every record answered.
12c. Fleet phase: BERT-base replicas (bf16, K2 in 12 blocks), each on its
   own ``InferenceModel(concurrent_num=2)`` and ``RedisBackend``, against
   one ``MiniResp`` broker (this file's RESP server, the JAX test fake's
   command subset and replies, in a child process; it counts result
   writes a key). (a) One replica on 256 pre-enqueued records over RESP
   and over ``LocalBackend`` in turns (local, RESP, RESP, local),
   records/s each, answers against the oracle route within 2e-2. (b) Two
   replicas with endpoints on 512 records: records/s against (a)'s RESP
   replica, each one's share; K2 launches 12 a dispatch, every uri
   written once, 512 acks, an empty PEL. (e) On that pair: the
   ``FleetCollector`` finds both from the heartbeats, ``/fleetz`` lists 2
   live, ``fleet_cli check`` exits 0, the status CLI rolls up both
   endpoints, each ``/statusz`` ``scaling`` block printed; after a kill
   ``/fleetz`` lists 1 live and 1 down. (c) A victim reads 32 of 512
   records alone and holds them, two survivors start, the victim is
   killed: every uri written once, answered + shed + dead-lettered = 512
   with the victim at 0, 32 reclaimed from the victim, 512 acks, an empty
   PEL, K2 12 a dispatch, answers within 2e-2; the kill to the last
   reclaimed answer printed. (d) A held replica under
   ``shed_watermark=48``: a blind producer's extra records are shed; a
   fleet-aware one (``fleet_wait_s=0.2``) is refused with
   ``FleetSaturatedError`` while the fleet is saturated, nothing is shed,
   and the refused records enqueue and are answered once it drains. (f)
   A poison record dead-lettered to a ``dlq_dir``; ``python -m
   ...serving.dlq_cli`` ``list``, ``inspect`` and ``replay --host --port``
   over RESP; a healthy replica answers the replayed record.
13. int8 head phase (config A): the JAX bench's weight-streaming scoring
   head (``bench.py:797-815``: 3 x Dense(4096, relu) + Dense(8, softmax),
   f32, one epoch of Adam 1e-4 on 256 seeded rows, batch 64) served fp32,
   weight-only int8 (K6 on all four layers, bias and ReLU fused into its
   skinny kernel) and static int8 calibrated on 8 rows (Q8 on all four
   layers up to 32 rows, 4 launches a predict counted; the padded
   ``_int_mm`` above): resident weight bytes (int8 at most 0.3 x fp32),
   each int8 mode within 1e-4 relative of its float counterpart (static
   at 1, 8 and 32 rows and 8 of 256), top-1 agreement and batch-1 device
   time by CUDA-graph replay (weight-only also with the bias adds and
   ReLUs as torch ops of their own, as before the fusion; static also as
   before Q8; the device kernels one batch-1 ``_forward`` launches each
   way), fault j's gate ``fp32 / static int8 >= 1.5`` (the JAX bench's
   ``int8_stream_b1_speedup`` floor), and ``ClusterServing(model,
   dtype="int8")`` answering all 256 records with 4 K6 launches per
   dispatch, all on the skinny kernel.
14. Fault l phase: the fused LM-head cross-entropy on views (a column
   slice of a wider hidden array, a tied head's transposed embedding) at
   N=4100, H=512, V=8192, f32 and bf16: one launch each of K4/K5a/K5b,
   the loss rows and the three gradients against the plain route.
15. Captured BERT phase: BERT at two blocks of full width, seq 512, batch
   8, hidden dropout 0.1, four steps a captured graph: K2, K3a and K3b
   launch 2 a step under replay, every step of two replays draws a new
   dropout mask (sgd at lr 0 on one repeated record: 8 distinct step
   losses), the eager steps' masks; with dropout 0 and AdamW the captured
   fit's losses and parameters against the eager fit's.
16. Reliability phase (slice 15; run after the training phase): BERT-base
   as the training phase fine-tunes it, 3 epochs of 8 steps a run from
   the same initial weights, snapshots (keep 2, 1.31 GB each) under a
   temporary directory. (a) No checkpoint, ``EveryEpoch``,
   ``EveryEpoch``, no checkpoint, in turns: samples/s over each fit and
   in its epochs' records, each save's snapshot copy (one batched copy
   into pinned memory) and its writer's ms and bytes; the checkpointed
   fits end on the unchecked fits' bits, every snapshot verifies,
   ``ckpt_cli verify`` exits 0. (b) A second model object resumes
   ``ckpt-16`` and ends on the uninterrupted run's bits;
   ``InferenceModel.load_checkpoint`` answers as it; one flipped byte
   makes ``verify`` exit 2 and a restore fall back a snapshot. (c)
   ``recover`` under a ``train.grads`` plan (nan_grad, spike, nan_loss
   at calls 3, 10, 17): each kind counted once, 3 skips, the events'
   iterations, finite params, 12 launches a step of K2/K3a/K3b; the
   guarded step's cost in turns (off, recover, recover, off; an empty
   plan gives sentinel-off's bits). (d) A rollback past
   ``max_skips_per_epoch=1`` to ``ckpt-8``, the replay skipping the
   flagged steps; the ``train.grads`` site calls (30) and, for each
   flagged step, the calls made when the host read its flags: four
   dispatches late or at the epoch's end, the JAX loop's lag. (e) A child process fitting with ``on_sigterm`` is
   signalled at its epoch-1 callback and exits through
   ``TrainingPreempted`` with ``ckpt-9`` (signal to commit printed); a
   second child resumes it and ends on this process's resume's bits
   (SHA-256 per leaf). (f) The captured configuration (2 blocks, batch
   8, ``scan_steps=4``) under ``recover``: the sentinel-off bits with an
   empty plan, a ``nan_grad`` inside the second replay skipped with the
   count held and the eager guarded run's bits, ``device_cache`` turned
   off with the warning, one compile counted a capture. (g) Goodput
   plus badput is each ledger's wall on (c) and (d).
17. Image phases (slice 19; fp32, TF32 off). (a) C8, the static int8
   conv: bits against its plain version (the exact float64 conv of the
   int8 values) on the card, twice (slice 20: the wrapper's own weight
   repack, then one made beforehand), and against the library route
   (im2col and the padded ``_int_mm``) at every distinct conv of VGG-16's
   static paths (batch 32 and 1 at 112 pixels), ResNet-50's and
   Inception-v1's 7x7/2 stems (XLA's (2, 3) pads) and a dilated
   ``AtrousConvolution2D``; each with its route (``c8_wgmma``,
   ``c8_split`` or ``c8_small_c``), timed beside its plain version, the
   library route, cuDNN's fp32 conv and its bound, and on the wgmma
   routes the quantize pass and the repack bit for bit their plain
   versions and timed; C8's device ms summed over VGG-16's 13 convs at
   batch 32 and 1. (b) ``bench_int8_inference``: VGG-16 at 112
   pixels, 8 classes, trained 3 epochs on 512 seeded prototype images,
   served fp32 and static int8 at batch 32 (``image_infer_*_fps``,
   ``int8_top1_agreement_pct`` gated at 97.0), 12 weight repacks at the
   static install, 13 C8 (1 ``c8_small_c``, 12 on the wgmma routes after
   12 quantize passes, no repack) and 3 Q8 launches a predict, C8's
   kernels' device ms in one batch-32 and one batch-1 forward (profiled),
   the batch-1 device ms of each path, AlexNet's held-out top-1 fp32 and
   int8 after 16 epochs. (c) ``bench_transfer_learning``:
   Inception-v1's pooled features (``new_graph(["gap"])``) of 2048
   images on the card, a ``Dense(2)`` head trained on them 2 epochs
   (``transfer_learn_imgs_per_sec``, median of 3). (d) ResNet-50 serving
   (``bench_serving`` and ``bench_serving_device``: 256 frames, batch
   32; fp32, weight-only int8 with K6 on the head, both multiplexed).
   (e) ResNet-50 training with BatchNorm (112 pixels, batch 32, 8 steps,
   ``cudnn.deterministic``): eager and ``scan_steps`` 8 samples/s and
   busy share, the captured fit's losses and moving statistics the eager
   fit's bits, and a ``recover`` skip keeping the statistics' bits.
18. Recurrent and 3D phases (slice 21). (a) ``TextClassifier`` at the
   class defaults (200-wide tokens, 500 a sequence, encoder output 256,
   20 classes) on a seeded frozen 5,000 x 200 ``WordEmbedding``: the cnn,
   lstm and gru encoders fitted eager and captured (``scan_steps`` 4,
   batch 128; samples/s, busy share, capture seconds and the graph's
   kernel nodes; the captured step losses gated to the eager bits), then
   the cnn and lstm classifiers served in fp32, weight-only and static
   int8 (chunks of 32) and through a one-lane ``ClusterServing``:
   records/s, top-1 agreement with fp32, K6 (skinny) and Q8 launches on
   the two Dense layers gated. (b) ``AnomalyDetector`` at
   examples/anomaly_detection.py's configuration on a seeded
   100,000-point series (``detect_anomalies`` over all of it),
   ``SessionRecommender`` at its defaults with history
   (``recommend_for_session``), ``Seq2seq`` at
   examples/seq2seq_chatbot.py's configuration and as a two-layer GRU
   with ``densenonlinear`` (``infer`` with a stop sign): each fitted
   eager and captured, the bits gated. (c) ``ConvLSTM2D(64, 3)`` on
   Moving-MNIST's (16, 10, 64, 64, 1) and C3D's conv1a (``Convolution3D``
   3 -> 64, (8, 16, 112, 112, 3)): ms a training step. (d) The JAX
   bench's ``sentinel`` channel: ``sentinel_overhead_pct`` at the NCF
   shape on captured 16-step dispatches, off and recover windows
   interleaved, median of 5, against the bench's ceiling of 3.0 (slice
   22: fault r, printed as open with the guarded step's extra kernel
   nodes by family while over it); G1 and G2 (``csrc/guard.cu``) held to
   their plain versions bit for bit on the recover loop's own state, on
   good and bad steps, and timed beside them.
19. Mesh phase (slice 22): the mesh cases (BERT-base DP 2 with ZeRO-1
   and TP 2; the ``long_context_sharded`` width with ring attention, the
   vocab-sharded head, both at once, and Ulysses at T = 2048; NCF's
   row-sharded tables; ``SparseMoE`` over ``expert``; GPipe over
   ``pipe``) run as ``spawn``ed ranks — gloo ranks sharing one card
   (world 2 and 4), or one card a rank under NCCL where there are as
   many — each held to the same model's one-rank run on the card (step
   losses and gathered parameters, 1e-5), with K1/SA, K4/K5a/K5b and
   K2/K3a/K3b launching on every rank of their cases (gated); the CE
   and embedding kernels at their per-shard shapes against their plain
   versions; a 2-rank snapshot restored on one rank bit for bit; with
   two or more cards, a captured DP fit (NCCL), else the skip printed.

20. Object detection phase (slice 23): SSD300-VGG16 (21 classes, 300 x
   300, 8732 priors, seeded weights): ``ObjectDetector.detect`` in fp32
   at batch 1 and 32 (records/s, device ms of the forward and of the
   decode); static int8 through ``InferenceModel.from_keras(quantize=
   "int8", calibrate=...)`` (35 C8 launches a forward by route, each conv
   held to C8's plain version bit for bit on a real forward's inputs);
   N1 (``csrc/nms.cu``) on the real decode's 32 x 21 rows of 400 boxes,
   bit for bit its plain loop and timed beside it; a ``ClusterServing``
   stream of 64 frames decoded by the client; four training steps of
   batch 8 eager and captured with the same bits, then VOC mAP. C8's
   kernel cases (17a) hold SSD300's fc6 and its F = 126 head too.

21. Slice 24 (N1 and Q8 redesigned): N1's case times its phases on the
   real decode's rows (``scripts/nms_phases.py``'s builds) beside its
   re-derived bound; Q8's cases add the Dense(4096) at 9 and 16 rows and
   VGG-16's fc6 and fc8 at batch 1 and 32, each with the route it ran;
   Q8's launches are counted by route on every static path; config A's
   static batch-32 forward is timed beside fp32's; one
   ``slice24_paths`` line gathers SSD300's batch-32 decode ms, config
   A's static records/s at batch 32, VGG-16's images/s at batch 32 and
   TextClassifier's static records/s.

``python3 chip_smoke.py --only sentinel,mesh`` (or ``object_detection``,
``c8_kernel``, ``static_int8_kernel``, ``int8_head``, ``fleet``) runs
those phases alone after the build (their JSON, no final line).

Device kernel lists (``device_kernels``, ``step_kernels``) are read
from a CUDA graph of the call: its kernel nodes through the driver API,
each named without its return type, namespaces and arguments; copies
and fills are nodes of other types and left out.

The eager training loops (BERT's, NCF's and Wide & Deep's when their
keys are off) stream every batch through ``prefetch_to_device``.

Prints the card's name and power limit, one ``{"kernels": [...]}`` JSON
line (each kernel at its main path's shape, with its launches on that
path; K6's also from TextClassifier's weight-only int8 predicts and
served lane, Q8's from config A's, VGG-16's and TextClassifier's static
predicts, C8's and its
quantize pass's from VGG-16's, its weight repack's from VGG-16's static
install, K6's also from ResNet-50's int8 serving lane, SA's also from the oocore
gradient; K2-K5b also on the 32k, remat and BERT NER paths, with their
32k shapes' fields; K1-K5b also on each rank of each mesh case; G1 and
G2 from the sentinel fit; N1's and C8's also from SSD300's detection
paths; the attention kernels also checked against
their plain versions,
checked for the same gradient bits over two runs and timed at the LM
shape beside SDPA's causal forward and backward there, K1 and SA also at
the DLRM width), and last
``{"ok":
true, "device": {...}}``. Exits non-zero, printing no result, without a
CUDA device, outside the repository, or when any check fails.
"""

import contextlib
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# the CUDA-graph kernel-node reader (no CUDA work at import); outside a
# checkout of the repository this import fails and the script exits non-zero
from analytics_zoo_tpu_torch.ops.graph_kernels import (  # noqa: E402
    demangle, device_kernels, graph_kernel_names, is_kernel_event,
    kernel_name)

# H100 SXM published peaks (NVIDIA data sheet; dense, at 700 W)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
PEAK_BYTES_PER_S = 3.35e12

T_BATCH = 32          # ClusterServing and fit batch size: the kernels' B
N_RECORDS = 256
#: records of the paced serving run, enqueued at half the flood's rate
N_PACED = 1024
#: seconds of the profile armed over POST /profilez in the paced run
PROFILE_S = 0.5
SEQ = 512
#: the JAX package's seq-512 fine-tune configuration (bench.py:193-236)
TRAIN_CFG = dict(num_classes=2, vocab=30522, hidden_size=768, n_block=12,
                 n_head=12, seq_len=SEQ, intermediate_size=3072,
                 attn_drop=0.0)
#: per-leaf bound on |g_flash - g_oracle| / |g_oracle| for one bf16 step:
#: the two attention routes round the probabilities at different points
#: (the oracle rounds normalized f32 weights to bf16; K2 rounds
#: exponentials relative to a running max and normalizes after the
#: product, K3a/K3b round P and dS), so each attention output differs by
#: up to a bf16 step (2^-8) and the differences compound through 12
#: blocks forward and back. A missing attention gradient would put the
#: qkv leaves near 100%.
GRAD_REL_TOL = 0.1


#: the six kernels of the LM path, by the names of the kernels line
LM_KERNELS = ("fused_ce_fwd", "fused_ce_bwd_dh", "fused_ce_bwd_dw",
              "flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv")

#: the JAX package's 4k long-context configuration (bench.py:415-438)
LM_VOCAB, LM_SEQ, LM_BATCH, LM_SEQS = 8192, 4096, 16, 32
LM_CFG = dict(vocab=LM_VOCAB, seq_len=LM_SEQ, n_block=4, hidden_size=512,
              n_head=8, hidden_drop=0.0, attn_drop=0.0, embedding_drop=0.0,
              bidirectional=False)
#: per-leaf bound on |g_fused - g_oracle| / |g_oracle| for one bf16 LM
#: step. Both routes round the logits to bf16 at the same points (Dense's
#: rounding) and run the same attention kernels; they differ in the
#: softmax gradient: the oracle takes it from an f32 log-softmax of the
#: upcast logits and rounds it to bf16 in autograd's cast, the fused route
#: re-forms p from its own f32 lse and rounds dl to bf16. Entries near a
#: rounding boundary move by one bf16 step (2^-8), so each leaf differs by
#: well under 1%; 2% leaves room for the four blocks the difference
#: crosses on its way back. A missing head gradient would read 100%.
LM_GRAD_REL_TOL = 0.02
#: the JAX bench's 32k long-context configuration (bench.py:424-428): the
#: 4k model at seq 32768, batch 1, 4 sequences drawn as the 4k ones are
#: (numpy seed 7); nothing is cut
LC_SEQ, LC_BATCH, LC_SEQS = 32768, 1, 4
LC_CFG = dict(LM_CFG, seq_len=LC_SEQ)
#: the zoo.train.remat modes of the 32k phase; each mode's first step is
#: held to the first's
LC_REMAT = ("false", "dots", "full")
#: query rows of the 32k attention check: the last ones, which see the
#: most keys (causal masking is bottom-right aligned, so the plain
#: versions on these rows against every key give the full problem's rows)
LC_CUT_ROWS = 2048

#: BERT-base NER at the JAX class's defaults (tfpark/bert_ner.py) with
#: CoNLL-2003's nine BIO tags; attention dropout 0 keeps K2, K3a and K3b
#: on the path (self_attention._use_flash), hidden dropout 0.1
NER_CFG = dict(num_entities=9, vocab=40990, hidden_size=768, n_block=12,
               n_head=12, seq_len=SEQ, intermediate_size=3072,
               hidden_drop=0.1, attn_drop=0.0)
NER_STEPS = 8

#: KNRM at the JAX class's widths (models/textmatching/knrm.py) on a
#: seeded corpus of a 20,000-word vocabulary: queries of 10 words, docs of
#: 40, each query with one relevant doc (sharing 2 of its words) and four
#: others (sharing 0 to 2 others), trained on relation pairs with rank_hinge
KNRM_VOCAB, KNRM_T1, KNRM_T2 = 20000, 10, 40
KNRM_QUERIES, KNRM_CANDIDATES, KNRM_BATCH, KNRM_EPOCHS = 4096, 5, 512, 3
KNRM_EVAL_QUERIES = 256


#: the JAX package's NeuralCF bench configuration (bench.py:50-52,
#: 1279-1285): MovieLens-1M's shape
N_USERS, N_ITEMS, N_CLASSES = 6040, 3706, 5
N_EXAMPLES = 1_000_000
NCF_BATCH = 8192
#: one step's gradients, stock NeuralCF against its ShardedEmbedding
#: graph from the same weights: both gather the same f32 rows and sum the
#: repeated ids' cotangents in f32 (position order against the gather's
#: own backward), so they differ by summation order only
NCF_GRAD_REL_TOL = 1e-5
#: the JAX bench's dispatch keys (bench.py:53-54, 1258-1262), fuse_epochs
#: cut from its 12 to the phase's two timed epochs
NCF_KEYED_CONF = {"zoo.train.scan_steps": 16, "zoo.train.device_cache": True,
                  "zoo.train.fuse_epochs": 2}
#: the keyed loop's step losses against the eager loop's in the same batch
#: order: the same ops on the same values, so the same bits are expected;
#: this bounds any difference a captured kernel might still make
NCF_STEP_REL_TOL = 1e-6
#: DLRM-Terabyte's width: 26 sparse features of dimension 128, batch 2048
DLRM_D, DLRM_N, DLRM_V = 128, 2048 * 26, 1_000_000

#: the JAX bench's Wide & Deep configuration (bench.py:105-160): 200,000
#: Census-shaped rows from numpy seed 1, WideAndDeep("wide_n_deep", 2,
#: hidden (40, 20, 10)) through NNClassifier, Adam 1e-3, batch 8192, six
#: epochs a timed dispatch under the bench's keys (bench.py:1261-1262)
WD_ROWS, WD_BATCH, WD_EPOCHS = 200_000, 8192, 6
WD_KEYED_CONF = {"zoo.train.scan_steps": 16, "zoo.train.device_cache": True,
                 "zoo.train.fuse_epochs": 12}
#: the captured fit against the eager fit in the same batch order, and a
#: resumed Estimator fit against the uninterrupted one: the same ops on
#: the same values, so the same bits are expected and printed; but the
#: embedding tables' backward (``table[ids]``'s ``index_put_`` with
#: accumulation, 8,192 rows onto 10-row and 32-row tables) adds in an
#: order the card does not fix, and Adam turns the last bits of a
#: gradient that nearly cancels into a fraction of a step on that weight
#: (on the CPU, one weight of a 96-step Census fit moved 1.1e-4 that way
#: while the losses stayed within 1e-6): per-epoch losses are held to
#: 1e-4 relative and parameters to 1e-3 absolute when the bits differ
WD_LOSS_REL_TOL = 1e-4
WD_PARAM_TOL = 1e-3

#: config A, the JAX bench's weight-streaming scoring head
#: (bench.py:797-815): 3 x Dense(4096) + Dense(8), 256 seeded rows
HEAD_D, HEAD_CLASSES, HEAD_ROWS = 4096, 8, 256
#: K6's cases (M, K, N, fused bias + ReLU): the head at batch 1, 8 and
#: 32 and at 32 with the dense layer's epilogue fused, BERT-base's qkv and
#: fc/out products at 32 x 512 tokens, BERT's Dense(2) head, a ragged one,
#: and a tile-path shape TMA cannot address (K % 8, N % 16 not 0); then
#: TextClassifier's Dense(128, relu) and Dense(20) at batch 32
INT8_CASES = [(1, 4096, 4096, False), (8, 4096, 4096, False),
              (32, 4096, 4096, False), (32, 4096, 4096, True),
              (16384, 768, 2304, False), (16384, 3072, 768, False),
              (32, 768, 2, False), (17, 100, 10, False),
              (300, 100, 130, False), (32, 256, 128, True),
              (32, 128, 20, False)]
#: Q8's cases (M, K, N): the head's three Dense(4096) layers at batch 1,
#: 7 and 32, its Dense(8) layer at 1 and 32, a K that is not a multiple
#: of 32, and TextClassifier's Dense(128) and Dense(20) at batch 32; the
#: Dense(4096) at 9 and 16 rows (past the tensor-core crossover) and
#: VGG-16's fc6 (25088 -> 4096) and fc8 (4096 -> 1000) at batch 1 and 32;
#: each without and with the bias and the fused ReLU
STATIC_CASES = [(1, 4096, 4096), (7, 4096, 4096), (32, 4096, 4096),
                (1, 4096, 8), (32, 4096, 8), (5, 1000, 4096),
                (32, 256, 128), (32, 128, 20), (9, 4096, 4096),
                (16, 4096, 4096), (1, 25088, 4096), (32, 25088, 4096),
                (1, 4096, 1000), (32, 4096, 1000)]
#: the JAX bench's floor on fp32 / static int8 batch-1 ms of config A
#: (int8_stream_b1_speedup, bench.py:1524)
STATIC_B1_FLOOR = 1.5
#: the out-of-core embedding phase: the JAX bench's configuration
#: (bench.py:326-389: d 64, a 2 MB hot budget, a 10x table, batch 4096,
#: 24 batches of zipf(1.1) ids, numpy seed 7) and the default budget's
OOCORE_D, OOCORE_BATCH, OOCORE_BATCHES, OOCORE_SEED = 64, 4096, 24, 7
OOCORE_BUDGETS_MB = {"bench_2mb": 2.0, "default_64mb": 64.0}
OOCORE_DEVICE = "cuda"
#: the oocore gradient against the dense scatter-add of the same rows:
#: SA's position-order f32 sums against np.add.at's, the same order
OOCORE_GRAD_TOL = 1e-6
#: the DiskFeatureSet fit: NCF on the NCF phase's ratings, two slices in
#: rotation mode, one full pass
DISK_SLICES, DISK_BATCH = 2, 8192
#: the lanes phase: records a lane and the flood's pre-enqueued backlog
N_LANE = 256
N_OVERLOAD = 1024
#: the poison marker the head lane's wrapper raises on (a record's first
#: value), and the ragged bucket waves of the JAX lanes test
POISON = 12345.0
BUCKET_WAVES = (1, 3, 2, 3, 1)
#: the fleet phase: records of (a)'s one replica and of the two-replica,
#: kill and backpressure runs; the kill test's claim idle and heartbeat.
#: A reclaim takes any entry idle past ``claim_idle_ms``, a live
#: replica's too, and re-answers it, so (c)'s "every result written once"
#: holds only while a survivor reads, dispatches and acks a batch within
#: it. Two survivors share the card there with the held victim, each with
#: two batches in flight; their dispatch-to-publish p99 is 0.22-0.34 s on
#: an H100, and at 500 ms a slow stretch once had a survivor's live
#: entries reclaimed and answered twice, so the idle is 2 s
N_FLEET_ONE, N_FLEET = 256, 512
FLEET_CLAIM_IDLE_MS, FLEET_HEARTBEAT_S = 2000, 0.1
#: backpressure: the replica's watermark; the preload, at the shed point
#: (batch + watermark), so the first read sheds nothing; the records a
#: blind producer adds (enough to push the backlog past the shed point
#: once the held read is out of the stream) and the records a
#: fleet-aware producer is refused
FLEET_WATERMARK, FLEET_PRELOAD = 48, 80
FLEET_EXTRA_BLIND, FLEET_EXTRA = 40, 8
#: weight-only and static int8 against their float counterparts on the
#: same weights: the same products in another order (weight-only: scale
#: after the sum against a dequantized weight; static: the card's int32
#: product against the CPU's, the same f32 rescale), so the probabilities
#: differ by rounding only
INT8_REL_TOL = 1e-4


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


class MiniResp:
    """A RESP server for the fleet phase: the command subset Cluster
    Serving's ``RedisBackend`` speaks (XADD, XLEN, XREAD with BLOCK, XDEL,
    XGROUP CREATE, XREADGROUP, XACK, XPENDING summary and IDLE range,
    XCLAIM, HSET, HGETALL, HDEL, DEL, KEYS, PING) with the semantics and
    replies of the JAX package's test fake (``tests/test_serving_redis.py``
    ``_MiniRedisServer``): one handler thread a connection, one command at
    a time, all state under one condition. It also counts HSETs a key,
    read back by the extra command ``ZOOWRITES`` (``[key, count, ...]``):
    the fleet phase's "every uri answered exactly once" is a count of
    result writes. ``ZOOSTATS`` returns, a command name at a time, the
    calls served and the seconds spent in them (``[name, calls, seconds,
    ...]``), the broker's share of a run. Run it in a child process
    (:func:`mini_resp_child`), so its threads do not share a GIL with the
    replicas it serves."""

    def __init__(self, host="127.0.0.1", port=0):
        import socket
        import socketserver
        import threading

        state = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                # as Redis does for its clients: without it a pipeline's
                # small replies wait on the client's delayed ACK (Nagle),
                # about 40 ms a pipelined batch on Linux
                self.request.setsockopt(socket.IPPROTO_TCP,
                                        socket.TCP_NODELAY, 1)
                state._serve(self.request)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self.lock = threading.Condition()
        self.streams = {}       # name -> [(id, {field: value})]
        self.hashes = {}        # key -> {field: value}
        self.groups = {}        # (stream, group) -> {"last", "pel"}
        self.writes = {}        # key -> HSETs
        self.stats = {}         # command -> [calls, seconds]
        self.seq = 0
        self.server = Server((host, port), Handler)
        self.port = self.server.server_address[1]

    # -- framing ----------------------------------------------------------
    @staticmethod
    def _read_command(sock, buf):
        while b"\r\n" not in buf:
            chunk = sock.recv(65536)
            if not chunk:
                return None, buf
            buf += chunk
        line, buf = buf.split(b"\r\n", 1)
        parts = []
        for _ in range(int(line[1:])):
            while b"\r\n" not in buf:
                buf += sock.recv(65536)
            head, buf = buf.split(b"\r\n", 1)
            n = int(head[1:])
            while len(buf) < n + 2:
                buf += sock.recv(65536)
            parts.append(buf[:n])
            buf = buf[n + 2:]
        return parts, buf

    @staticmethod
    def _bulk(b):
        return b"$%d\r\n%s\r\n" % (len(b), b)

    @staticmethod
    def _array(items):
        return b"*%d\r\n%s" % (len(items), b"".join(items))

    @staticmethod
    def _id_key(eid):
        ms, _, seq = eid.partition(b"-")
        return (int(ms), int(seq or 0))

    def _entry(self, eid, fields):
        return self._array([self._bulk(eid), self._array(
            [self._bulk(x) for kv in fields.items() for x in kv])])

    @staticmethod
    def _has_command(buf):
        """Whether ``buf`` already holds a whole command frame."""
        end = buf.find(b"\r\n")
        if end < 0:
            return False
        pos = end + 2
        for _ in range(int(buf[1:end])):
            end = buf.find(b"\r\n", pos)
            if end < 0:
                return False
            pos = end + 2 + int(buf[pos + 1:end]) + 2
            if pos > len(buf):
                return False
        return True

    def _serve(self, sock):
        """Serve one connection, a command at a time. As Redis does, the
        replies to a pipeline's commands (all already in the buffer) go
        out in one write when the last of them is answered."""
        buf = b""
        replies = []
        while True:
            try:
                cmd, buf = self._read_command(sock, buf)
            except (ConnectionError, OSError):
                return
            if cmd is None:
                return
            name = cmd[0].upper().decode()
            do = getattr(self, "_do_" + name.lower(), None)
            t0 = time.perf_counter()
            reply = (do(cmd[1:]) if do is not None else
                     b"-ERR unknown command '%s'\r\n" % name.encode())
            spent = time.perf_counter() - t0
            with self.lock:
                st = self.stats.setdefault(name, [0, 0.0])
                st[0] += 1
                st[1] += spent
            replies.append(reply)
            if self._has_command(buf):
                continue
            try:
                sock.sendall(b"".join(replies))
            except OSError:
                return
            replies = []

    @staticmethod
    def _read_opts(args, i):
        """COUNT/BLOCK options and the STREAMS list from ``args[i:]``."""
        count = block = None
        streams, lasts = [], []
        while i < len(args):
            a = args[i].upper()
            if a == b"COUNT":
                count, i = int(args[i + 1]), i + 2
            elif a == b"BLOCK":
                block, i = int(args[i + 1]), i + 2
            elif a == b"STREAMS":
                rest = args[i + 1:]
                streams = rest[:len(rest) // 2]
                lasts = rest[len(rest) // 2:]
                break
            else:
                i += 1
        return count, block, streams, lasts

    def _wait_for(self, block, collect):
        """``collect()`` under the lock until it gives replies or the
        BLOCK window passes (no BLOCK: one pass)."""
        deadline = time.monotonic() + (block or 0) / 1000.0
        with self.lock:
            while True:
                out = collect()
                if out or block is None:
                    return out
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return out
                self.lock.wait(remaining)

    # -- commands ---------------------------------------------------------
    def _do_ping(self, args):
        return b"+PONG\r\n"

    def _do_zoostats(self, args):
        with self.lock:
            return self._array([self._bulk(str(x).encode())
                                for k, (n, t) in self.stats.items()
                                for x in (k, n, repr(t))])

    def _do_zoowrites(self, args):
        with self.lock:
            return self._array([self._bulk(x) for k, n in self.writes.items()
                                for x in (k.encode(), b"%d" % n)])

    def _do_xadd(self, args):
        stream = args[0].decode()
        fields = {args[i]: args[i + 1] for i in range(2, len(args), 2)}
        with self.lock:
            self.seq += 1
            eid = b"%d-%d" % (int(time.time() * 1000), self.seq)
            self.streams.setdefault(stream, []).append((eid, fields))
            self.lock.notify_all()
        return self._bulk(eid)

    def _do_xlen(self, args):
        with self.lock:
            return b":%d\r\n" % len(self.streams.get(args[0].decode(), []))

    def _do_xread(self, args):
        count, block, streams, lasts = self._read_opts(args, 0)

        def collect():
            out = []
            for s, last in zip(streams, lasts):
                entries = [(eid, f) for eid, f in
                           self.streams.get(s.decode(), [])
                           if last == b"0"
                           or self._id_key(eid) > self._id_key(last)]
                if count is not None:
                    entries = entries[:count]
                if entries:
                    out.append(self._array([self._bulk(s), self._array(
                        [self._entry(eid, f) for eid, f in entries])]))
            return out

        out = self._wait_for(block, collect)
        return self._array(out) if out else b"*-1\r\n"

    def _do_xdel(self, args):
        stream, eids = args[0].decode(), set(args[1:])
        with self.lock:
            entries = self.streams.get(stream, [])
            kept = [(i, f) for i, f in entries if i not in eids]
            self.streams[stream] = kept
            self.lock.notify_all()
            return b":%d\r\n" % (len(entries) - len(kept))

    def _do_xgroup(self, args):
        if args[0].upper() != b"CREATE":
            return b"-ERR unsupported XGROUP subcommand\r\n"
        key = (args[1].decode(), args[2].decode())
        with self.lock:
            if key in self.groups:
                return (b"-BUSYGROUP Consumer Group name already "
                        b"exists\r\n")
            self.groups[key] = {"last": b"0", "pel": {}}
        return b"+OK\r\n"

    def _do_xreadgroup(self, args):
        group, consumer = args[1].decode(), args[2]
        count, block, streams, _ = self._read_opts(args, 3)

        def collect():
            out = []
            for s in (x.decode() for x in streams):
                g = self.groups.get((s, group))
                if g is None:
                    continue
                last = self._id_key(g["last"])
                entries = [(eid, f) for eid, f in self.streams.get(s, [])
                           if self._id_key(eid) > last]
                if count is not None:
                    entries = entries[:count]
                if not entries:
                    continue
                now_ms = time.monotonic() * 1000.0
                for eid, _f in entries:
                    g["last"] = eid
                    g["pel"][eid] = [consumer, now_ms, 1]
                out.append(self._array([self._bulk(s.encode()), self._array(
                    [self._entry(eid, f) for eid, f in entries])]))
            return out

        out = self._wait_for(block, collect)
        return self._array(out) if out else b"*-1\r\n"

    def _do_xack(self, args):
        with self.lock:
            g = self.groups.get((args[0].decode(), args[1].decode()))
            n = 0
            if g is not None:
                for eid in args[2:]:
                    n += g["pel"].pop(eid, None) is not None
        return b":%d\r\n" % n

    def _do_xpending(self, args):
        with self.lock:
            g = self.groups.get((args[0].decode(), args[1].decode()))
            pel = dict(g["pel"]) if g else {}
        now_ms = time.monotonic() * 1000.0
        if len(args) == 2:          # the summary form
            if not pel:
                return self._array([b":0\r\n", b"$-1\r\n", b"$-1\r\n",
                                    b"*-1\r\n"])
            per = {}
            for consumer, _t, _n in pel.values():
                per[consumer] = per.get(consumer, 0) + 1
            ids = sorted(pel, key=self._id_key)
            return self._array([
                b":%d\r\n" % len(pel), self._bulk(ids[0]),
                self._bulk(ids[-1]),
                self._array([self._array([self._bulk(c),
                                          self._bulk(b"%d" % n)])
                             for c, n in per.items()])])
        i, min_idle = 2, 0          # [IDLE ms] - + count
        if args[i].upper() == b"IDLE":
            min_idle, i = int(args[i + 1]), i + 2
        count = int(args[i + 2])
        rows = []
        for eid in sorted(pel, key=self._id_key):
            consumer, t_ms, times = pel[eid]
            idle = now_ms - t_ms
            if idle < min_idle:
                continue
            rows.append(self._array([self._bulk(eid), self._bulk(consumer),
                                     b":%d\r\n" % int(idle),
                                     b":%d\r\n" % times]))
            if len(rows) >= count:
                break
        return self._array(rows)

    def _do_xclaim(self, args):
        stream, group = args[0].decode(), args[1].decode()
        consumer, min_idle = args[2], int(args[3])
        out = []
        with self.lock:
            g = self.groups.get((stream, group))
            if g is None:
                return b"*0\r\n"
            now_ms = time.monotonic() * 1000.0
            by_id = dict(self.streams.get(stream, []))
            for eid in args[4:]:
                pe = g["pel"].get(eid)
                if pe is None or now_ms - pe[1] < min_idle:
                    continue        # gone, or a racing claimer won it
                fields = by_id.get(eid)
                if fields is None:  # deleted from the stream: drop it
                    del g["pel"][eid]
                    continue
                g["pel"][eid] = [consumer, now_ms, pe[2] + 1]
                out.append(self._entry(eid, fields))
        return self._array(out)

    def _do_hset(self, args):
        key = args[0].decode()
        with self.lock:
            h = self.hashes.setdefault(key, {})
            added = 0
            for i in range(1, len(args), 2):
                added += args[i] not in h
                h[args[i]] = args[i + 1]
            self.writes[key] = self.writes.get(key, 0) + 1
            self.lock.notify_all()
        return b":%d\r\n" % added

    def _do_hgetall(self, args):
        with self.lock:
            h = self.hashes.get(args[0].decode(), {})
            return self._array([self._bulk(x) for kv in h.items()
                                for x in kv])

    def _do_hdel(self, args):
        with self.lock:
            h = self.hashes.get(args[0].decode(), {})
            n = sum(h.pop(f, None) is not None for f in args[1:])
        return b":%d\r\n" % n

    def _do_del(self, args):
        with self.lock:
            n = sum(self.hashes.pop(a.decode(), None) is not None
                    for a in args)
        return b":%d\r\n" % n

    def _do_keys(self, args):
        import fnmatch
        pat = args[0].decode()
        with self.lock:
            ks = [k for k in self.hashes if fnmatch.fnmatch(k, pat)]
        return self._array([self._bulk(k.encode()) for k in ks])

    def serve_forever(self):
        self.server.serve_forever()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def mini_resp_child():
    """Serve a :class:`MiniResp` until stdin closes; its port is the first
    line on stdout."""
    import threading
    srv = MiniResp()
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    print(srv.port, flush=True)
    sys.stdin.read()
    srv.close()


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=20):
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed between two events, so the host's launch cost stays
    out of the timed region (``time_ms`` of a wrapper that runs for a few
    microseconds reads the host's launch rate instead)."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return time_ms(graph.replay, iters=5, warmup=1) / iters


def attention_bound(q, k, mask, causal, flops_per_pair_per_d=4,
                    n_q_sized=2, n_kv_sized=2, n_row_f32=0):
    """Least time for the function on these inputs: the larger of the
    operations it needs (``flops_per_pair_per_d`` x D flops per visible
    (query, key) pair, counted from this mask) over the dtype's peak, and
    the bytes it must move over HBM bandwidth: ``n_q_sized`` tensors the
    size of q and ``n_kv_sized`` the size of k read or written once, the
    mask (if any) read once and ``n_row_f32`` f32 (B, H, Tq) rows (lse,
    delta).
    The forward (K2) is 4 flops per pair per D and reads q and writes out,
    reads k and v."""
    import torch
    b, h, t_q, d = q.shape
    t_kv = k.shape[2]
    keep = (torch.ones(b, t_kv, dtype=torch.bool, device=q.device)
            if mask is None else mask >= 1.0)
    vis = keep[:, None, :].expand(b, t_q, t_kv)
    if causal:
        tri = torch.ones(t_q, t_kv, dtype=torch.bool,
                         device=q.device).tril(t_kv - t_q)
        vis = vis & tri
    pairs = int(vis.sum().item()) * h
    flops = float(flops_per_pair_per_d) * d * pairs
    nbytes = ((q.numel() * n_q_sized + k.numel() * n_kv_sized)
              * q.element_size() + (0 if mask is None else mask.numel() * 4)
              + n_row_f32 * b * h * t_q * 4)
    dtype = str(q.dtype).replace("torch.", "")
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attention_inputs(b, h, tq, tk, d, dtype, g, empty_row=False,
                     lens_from=None):
    """Seeded q, k, v, dO on the card and a key-padding mask: valid
    lengths uniform in 64..tk, or the padding of ``lens_from`` ids."""
    import torch
    q, k, v, do = (torch.randn(b, h, t, d, generator=g).to("cuda", dtype)
                   for t in (tq, tk, tk, tq))
    if lens_from is not None:
        mask = torch.from_numpy((lens_from != 0).astype("float32")).cuda()
    else:
        lens = torch.randint(64, tk + 1, (b,), generator=g)
        mask = (torch.arange(tk)[None, :] < lens[:, None]).float().cuda()
    if empty_row:
        mask[0] = 0.0
    return q, k, v, do, mask


def kernel_phase():
    import torch
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import (
        flash_attention, flash_attention_reference)

    g = torch.Generator().manual_seed(0)
    cases = [  # name, dtype, tol, tq, tk, causal, empty_row
        ("bert_f32_padded", torch.float32, 1e-4, 512, 512, False, False),
        ("bert_bf16_padded", torch.bfloat16, 2e-2, 512, 512, False, False),
        ("bf16_causal", torch.bfloat16, 2e-2, 512, 512, True, False),
        ("f32_tq384_tk512", torch.float32, 1e-4, 384, 512, False, False),
        ("bf16_causal_tq512_tk384", torch.bfloat16, 2e-2, 512, 384, True,
         False),
        ("f32_fully_masked_row", torch.float32, 1e-4, 512, 512, False, True),
    ]
    rows = []
    for name, dtype, tol, tq, tk, causal, empty in cases:
        q, k, v, _, mask = attention_inputs(8, 12, tq, tk, 64, dtype, g,
                                            empty)
        out, lse = flash_attention(q, k, v, mask=mask, causal=causal,
                                   want_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_reference(q, k, v, mask, causal,
                                                 want_lse=True)
        err = (out.float() - ref.float()).abs().max().item()
        fin = torch.isfinite(ref_lse)
        check(torch.equal(fin, torch.isfinite(lse)), f"{name}: lse inf set")
        lse_err = (lse[fin] - ref_lse[fin]).abs().max().item()
        check(err <= tol, f"{name}: max |kernel - plain| {err} > {tol}")
        check(lse_err <= 1e-3, f"{name}: lse error {lse_err}")
        if empty:
            check(bool(torch.all(out[0] == 0)), f"{name}: empty row not 0")
        if causal and tq > tk:
            check(bool(torch.all(out[:, :, :tq - tk] == 0)),
                  f"{name}: rows before the diagonal not 0")
        row = {"case": name, "shape": [8, 12, tq, tk, 64],
               "dtype": str(dtype).replace("torch.", ""), "causal": causal,
               "max_abs_err": err, "tol": tol, "lse_err": lse_err}
        if name.startswith("bert_"):
            attn = (mask >= 1.0)[:, None, None, :]
            row["ms"] = time_ms(lambda: flash_attention(q, k, v, mask=mask))
            row["plain_ms"] = time_ms(
                lambda: flash_attention_reference(q, k, v, mask))
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       attn_mask=attn))
            row["bound_ms"], row["bound_by"] = attention_bound(q, k, mask,
                                                               False)
        rows.append(row)
        print(f"kernel case {json.dumps(row)}")
    return rows


class BertAdapter:
    """A served record is a (T,) int32 token row with pad id 0; the model
    takes BERT's four inputs."""

    def __init__(self, im):
        from analytics_zoo_tpu_torch.tfpark.bert_classifier import \
            make_bert_inputs
        self.im = im
        self.make = make_bert_inputs
        self.dispatches = 0

    def inputs(self, ids):
        return self.make(ids, attention_mask=(ids != 0))

    def predict_async(self, ids, block=True):
        collect = self.im.predict_async(self.inputs(ids), block=block)
        self.dispatches += collect is not None
        return collect


def serving_records(vocab, n=N_RECORDS, seed=0):
    """The served BERT records: ``n`` rows of 512 token ids from numpy
    seed ``seed``, valid lengths uniform in 64..512, pad id 0."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (n, SEQ)).astype(np.int32)
    lens = rng.integers(64, SEQ + 1, n)
    ids[np.arange(SEQ)[None, :] >= lens[:, None]] = 0
    return ids


def serve(make_server, records, counters, traced=True, live=None):
    """``make_server(backend)`` builds a ``ClusterServing`` on a fresh
    ``LocalBackend`` that holds ``records``, pre-enqueued (with trace ids
    unless ``traced`` is false); it answers them. ``live(server)`` runs
    after the first answer, while the loop still serves. Returns the
    answers, the wall time from server start to the last answer, and the
    stopped server. ``counters`` are set to 0 just before the start."""
    import numpy as np

    from analytics_zoo_tpu_torch.serving import (InputQueue, LocalBackend,
                                                 OutputQueue)
    from analytics_zoo_tpu_torch.serving.client import (INPUT_STREAM,
                                                        encode_tensor)
    backend = LocalBackend()
    server = make_server(backend)
    q = InputQueue(backend)
    for i, rec in enumerate(records):
        if traced:
            q.enqueue(f"rec-{i}", rec)
        else:
            backend.xadd(INPUT_STREAM, dict(encode_tensor(rec),
                                            uri=f"rec-{i}"))
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    server.start()
    out = OutputQueue(backend)
    try:
        got = [out.query("rec-0", timeout=300)]
        if live is not None:
            live(server)
        got += [out.query(f"rec-{i}", timeout=300)
                for i in range(1, len(records))]
        got = np.stack(got)
        wall = time.perf_counter() - t0
    finally:
        server.stop()
    return got, wall, server


def get_json(url, data=None):
    """``(status, JSON body)`` of one request to a serving endpoint."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, data=data, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def goodput_split(name, snap):
    """Print and return a goodput ledger snapshot's seconds by category
    with their shares of its wall."""
    wall = snap["wall_s"]
    print(f"serving {name}: goodput split of {wall:.4f} s: "
          + ", ".join(f"{k} {v:.4f} s ({v / wall * 100:.1f}%)"
                      for k, v in snap["seconds"].items()))
    return {"wall_s": wall, **snap["seconds"]}


def serving_latency(name, server, registry, events_path, n_answered,
                    split=None):
    """The latency report and gates of one traced serving run, read after
    ``stop()`` (which joins the publisher before it closes the sinks):
    p50/p95/p99 of queue wait, dispatch and end to end in ms, the summary
    counts against the records answered and the batches, each traced
    record's four phases in order with their parents, and the goodput
    categories in the registry against the ledger's wall. The split
    printed is ``split`` (a ledger snapshot taken earlier) or the
    ledger's at the end."""
    from analytics_zoo_tpu_torch.observability import (goodput_snapshot,
                                                       read_events)
    summaries = {m.name: m for m in registry.metrics()
                 if m.name.endswith("_quantiles_seconds")}
    snap = registry.snapshot()
    batches = snap["zoo_serving_batches_total"]["value"]
    report = {}
    for fam in ("queue_wait", "dispatch", "e2e"):
        s = summaries[f"zoo_serving_{fam}_quantiles_seconds"]
        report[fam] = {"count": s.count, **{
            f"p{int(q * 100)}_ms": s.quantile(q) * 1e3
            for q in (0.5, 0.95, 0.99)}}
        print(f"serving {name}: {fam} p50 {report[fam]['p50_ms']:.3f} / "
              f"p95 {report[fam]['p95_ms']:.3f} / p99 "
              f"{report[fam]['p99_ms']:.3f} ms ({s.count} observations)")
    check(report["e2e"]["count"] == n_answered
          and report["queue_wait"]["count"] == n_answered,
          f"{name}: e2e/queue-wait counts {report['e2e']['count']}/"
          f"{report['queue_wait']['count']} for {n_answered} answers")
    check(report["dispatch"]["count"] == batches,
          f"{name}: dispatch count {report['dispatch']['count']} for "
          f"{batches} batches")
    chains = {}
    for e in read_events(events_path, kind="request"):
        chains.setdefault(e["trace"], []).append(e)
    check(len(chains) == n_answered,
          f"{name}: {len(chains)} traces for {n_answered} records")
    parents = [None, "enqueue", "dequeue", "dispatch"]
    worst = 0.0
    for trace, chain in chains.items():
        check([e["phase"] for e in chain] == ["enqueue", "dequeue",
                                              "dispatch", "publish"]
              and [e["parent"] for e in chain] == parents,
              f"{name}: trace {trace} phases {[e['phase'] for e in chain]}")
        pub = chain[-1]
        worst = min(worst, pub["e2e_s"] - pub["dur_s"])
        check(pub["e2e_s"] >= pub["dur_s"] - 1e-3,
              f"{name}: trace {trace} e2e {pub['e2e_s']} under its "
              f"publish dur {pub['dur_s']}")
    gp = goodput_snapshot(registry)
    wall = server._goodput.wall()
    total = gp["goodput_s"] + sum(gp["badput_s"].values())
    check(abs(total - wall) <= 0.01 * wall,
          f"{name}: goodput categories {total} against the ledger's "
          f"wall {wall}")
    split = goodput_split(name, split or server._goodput.snapshot())
    print(f"serving {name}: {len(chains)} traces of 4 phases in order "
          f"(e2e - publish dur >= {worst * 1e3:.3f} ms)")
    report.update(batches=batches, goodput_s=split)
    return report


def status_cli(endpoint, *args):
    """The port's status CLI as a subprocess on ``endpoint``: its exit
    code and JSON document."""
    proc = subprocess.run(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.status",
         endpoint, "--json", *args], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    return proc.returncode, json.loads(proc.stdout)


def serve_paced(make_server, records, rate, live_at, live, done):
    """Serve ``records`` enqueued by a producer thread at ``rate``
    records/s, the server already running; ``live(server)`` runs once
    ``live_at`` answers arrived, ``done(server)`` after the last, before
    the stop. Returns the answers, the producer's achieved rate and the
    stopped server."""
    import threading

    import numpy as np

    from analytics_zoo_tpu_torch.serving import (InputQueue, LocalBackend,
                                                 OutputQueue)
    backend = LocalBackend()
    server = make_server(backend).start()
    q = InputQueue(backend)
    span = []

    def produce():
        t0 = time.perf_counter()
        for i, rec in enumerate(records):
            delay = t0 + i / rate - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            q.enqueue(f"rec-{i}", rec)
        span.append(time.perf_counter() - t0)

    producer = threading.Thread(target=produce, name="paced-producer")
    producer.start()
    out = OutputQueue(backend)
    try:
        got = []
        for i in range(len(records)):
            got.append(out.query(f"rec-{i}", timeout=300))
            if i + 1 == live_at:
                live(server)
        got = np.stack(got)
        done(server)
    finally:
        producer.join()
        server.stop()
    return got, (len(records) - 1) / span[0], server


def serving_phase():
    import tempfile

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.observability import MetricsRegistry
    from analytics_zoo_tpu_torch.observability.profiler import TRACE_FILE
    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import KERNEL
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving import ClusterServing
    from analytics_zoo_tpu_torch.tfpark.bert_classifier import \
        BERTClassifier

    tmp = tempfile.TemporaryDirectory(prefix="zoo-serving-")
    conf = {"zoo.pallas.attention": True, "zoo.compute.dtype": "bfloat16",
            "zoo.seed": 0, "zoo.profiler.dir": tmp.name,
            "zoo.profiler.duration_s": PROFILE_S}
    init_zoo_context(conf=conf)
    t0 = time.perf_counter()
    model = BERTClassifier(num_classes=2, device="cuda").init_weights()
    im = InferenceModel(concurrent_num=2, device="cuda").from_keras(
        model, dtype="bfloat16")
    cfg = model.get_config()
    del model                       # the runtime holds its bf16 copy
    n_block = cfg["n_block"]
    print(f"serving: BERT-base built in {time.perf_counter() - t0:.1f}s "
          f"({json.dumps(cfg)})")
    ids = serving_records(cfg["vocab"])
    adapter = BertAdapter(im)
    adapter.predict_async(ids[:T_BATCH])()          # warm-up, not counted
    card_bytes = torch.cuda.get_device_properties(0).total_memory

    def serving_server(registry, events=None):
        """A server factory on ``registry``; with ``events``, traced: a
        JSON event sink there and ``serve_metrics(0)``."""
        def make(backend):
            server = ClusterServing(adapter, backend=backend,
                                    batch_size=T_BATCH, registry=registry)
            if events is not None:
                server.set_json_events(events)
                server.serve_metrics(0)
            return server
        return make

    def statusz(server):
        code, st = get_json(f"http://127.0.0.1:{server._scrape.port}"
                            "/statusz")
        check(code == 200, f"/statusz gave {code}")
        dev = st["device"]
        mem = dev.get("memory", [{}])[0]
        check(dev["platform"] == "gpu" and mem.get("in_use", 0) > 0
              and mem.get("limit") == card_bytes,
              f"/statusz device block {dev} (card {card_bytes} bytes)")
        return mem

    # flood, in turns: plain (no sinks, untraced records), traced (a
    # JSON event sink, serve_metrics(0) and trace ids), traced, plain
    runs = []
    flood = None
    for turn, kind in enumerate(("plain", "traced", "traced", "plain")):
        registry = MetricsRegistry()
        events = os.path.join(tmp.name, f"flood-{turn}.jsonl")
        seen = {}

        def live(server):
            code, health = get_json(
                f"http://127.0.0.1:{server._scrape.port}/healthz")
            check(code == 200 and health["status"] == "ok"
                  and health["serving"]["running"],
                  f"/healthz while serving: {code} {health}")
            seen["memory"] = statusz(server)

        is_traced = kind == "traced"
        adapter.dispatches = 0
        got_i, wall_i, server_i = serve(
            serving_server(registry, events if is_traced else None), ids,
            [KERNEL], traced=is_traced, live=live if is_traced else None)
        print(f"serving flood {turn} ({kind}): {N_RECORDS} records in "
              f"{wall_i:.3f}s = {N_RECORDS / wall_i:.1f} records/s; "
              f"{adapter.dispatches} dispatches, {KERNEL.launches} "
              f"flash_attention_fwd launches")
        runs.append({"kind": kind, "records_per_s": N_RECORDS / wall_i,
                     "wall_s": wall_i, "goodput_s": goodput_split(
                         f"flood {turn}", server_i._goodput.snapshot())})
        if turn == 0:
            got, wall, server = got_i, wall_i, server_i
            launches, chunks = KERNEL.launches, adapter.dispatches
        if turn == 1:
            flood = serving_latency("flood", server_i, registry, events,
                                    N_RECORDS)
            flood["records_per_s"] = N_RECORDS / wall_i
            flood["statusz_memory"] = seen["memory"]
            print(f"serving flood: /statusz device memory {seen['memory']}")
    check(server.served == N_RECORDS, f"served {server.served}")
    check(got.shape == (N_RECORDS, 2), f"result shape {got.shape}")
    check(bool(np.isfinite(got).all()), "non-finite probabilities")
    sums = np.abs(got.sum(-1) - 1.0).max()
    check(sums <= 1e-2, f"probabilities sum off 1 by {sums}")
    check(launches == n_block * chunks and chunks > 0,
          f"{launches} kernel launches for {chunks} chunks of "
          f"{n_block} blocks")
    # one more plain flood under torch.profiler: the kernels' union over
    # the serving wall is the device's busy share, which splits the loop's
    # device_dispatch seconds into device work and host work
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall_prof, server_prof = serve(
            serving_server(MetricsRegistry()), ids, [], traced=False)
        torch.cuda.synchronize()
    kernels = [(e.time_range.start, e.time_range.end) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    check(kernels, "the profiled flood traced no device kernel")
    t_first = min(s_ for s_, _ in kernels)
    t_last = max(e_ for _, e_ in kernels)
    union_ms = busy_share(kernels, t_first, t_last) * (t_last - t_first) / 1e3
    kernel_ms = sum(e_ - s_ for s_, e_ in kernels) / 1e3
    device = {"wall_s": wall_prof, "kernel_union_ms": union_ms,
              "kernel_ms": kernel_ms, "kernels": len(kernels),
              "busy_share": union_ms / 1e3 / wall_prof,
              "goodput_s": goodput_split("flood profiled",
                                         server_prof._goodput.snapshot())}
    print(f"serving flood under torch.profiler: {N_RECORDS / wall_prof:.1f} "
          f"records/s; {len(kernels)} device kernels, {kernel_ms:.2f} ms "
          f"(union {union_ms:.2f} ms) over {wall_prof * 1e3:.2f} ms of "
          f"serving: the device {device['busy_share'] * 100:.1f}% busy")
    plain = [r["records_per_s"] for r in runs if r["kind"] == "plain"]
    traced = [r["records_per_s"] for r in runs if r["kind"] == "traced"]
    overhead = 1.0 - (sum(traced) / len(traced)) / (sum(plain) / len(plain))
    print(f"serving overhead: records/s plain {plain[0]:.1f}, traced "
          f"{traced[0]:.1f}, traced {traced[1]:.1f}, plain {plain[1]:.1f} "
          f"(traced {overhead * 100:.1f}% below plain, mean of two each)")

    # paced: a producer at half the traced flood's records/s; a profile
    # is armed over HTTP near the end, the status CLI run on the endpoint
    rate = 0.5 * flood["records_per_s"]
    paced_ids = serving_records(cfg["vocab"], N_PACED, seed=1)
    registry = MetricsRegistry()
    events = os.path.join(tmp.name, "paced.jsonl")
    seen = {}

    def paced_live(server):
        base = f"http://127.0.0.1:{server._scrape.port}"
        seen["profilez"] = get_json(base + "/profilez", data=b"")
        seen["again"] = get_json(base + "/profilez", data=b"")
        seen["memory"] = statusz(server)

    def paced_done(server):
        # the split as the last answer landed, before the CLI's idle time
        seen["split"] = server._goodput.snapshot()
        seen["cli"] = status_cli(f"127.0.0.1:{server._scrape.port}")
        seen["cli_slo"] = status_cli(f"127.0.0.1:{server._scrape.port}",
                                     "--slo-p99-ms", "0.001")

    paced_got, produced, server_p = serve_paced(
        serving_server(registry, events), paced_ids, rate,
        N_PACED - N_PACED // 8, paced_live, paced_done)
    check(paced_got.shape == (N_PACED, 2)
          and bool(np.isfinite(paced_got).all()),
          f"paced answers {paced_got.shape}")
    paced = serving_latency("paced", server_p, registry, events, N_PACED,
                            split=seen["split"])
    paced.update(rate=rate, produced_per_s=produced,
                 statusz_memory=seen["memory"])
    print(f"serving paced: {N_PACED} records offered at {rate:.1f} "
          f"records/s (produced at {produced:.1f}); /statusz device "
          f"memory {seen['memory']}")
    code, body = seen["profilez"]
    check(code == 200 and body.get("armed"),
          f"POST /profilez gave {code} {body}")
    check(seen["again"][0] == 409, f"a second arm gave {seen['again']}")
    trace_path = os.path.join(body["dir"], TRACE_FILE)
    with open(trace_path) as f:
        trace = json.load(f)["traceEvents"]
    k2 = [e for e in trace if "flash_fwd_wgmma" in e.get("name", "")]
    check(k2, f"the capture's trace names no flash_fwd_wgmma "
              f"({len(trace)} events)")
    print(f"serving paced: POST /profilez 200 then 409; capture of "
          f"{PROFILE_S}s: {len(trace)} trace events, {len(k2)} "
          f"flash_fwd_wgmma, {os.path.getsize(trace_path)} bytes")
    check(seen["cli"][0] == 0 and seen["cli"][1]["exit"] == 0,
          f"status CLI exit {seen['cli'][0]}")
    check(seen["cli_slo"][0] == 2 and seen["cli_slo"][1]["breaches"],
          f"status CLI under --slo-p99-ms 0.001 exit {seen['cli_slo'][0]}")
    print(f"serving paced: status CLI exits 0, and 2 under "
          f"--slo-p99-ms 0.001 ({seen['cli_slo'][1]['breaches'][0]})")
    paced["profile"] = {"trace_events": len(trace), "k2_events": len(k2)}
    tmp.cleanup()

    # the port's oracle attention route on the same records and batches
    init_zoo_context(conf={**conf, "zoo.pallas.attention": False})
    KERNEL.reset()
    want = np.concatenate([im.predict(adapter.inputs(ids[i:i + T_BATCH]))
                           for i in range(0, N_RECORDS, T_BATCH)])
    check(KERNEL.launches == 0, "the oracle route launched the kernel")
    diff = float(np.abs(got - want).max())
    print(f"serving: max |flash - oracle| probability {diff:.3e} "
          f"(bf16 tolerance 2e-2)")
    check(diff <= 2e-2, f"flash vs oracle route {diff}")
    return {"records_per_s": N_RECORDS / wall, "wall_s": wall,
            "dispatches": chunks, "launches": launches,
            "flash_vs_oracle": diff, "flood_runs": runs,
            "traced_overhead": overhead, "flood": flood, "paced": paced,
            "flood_device": device}


def bf16_step(v):
    """One bf16 step (unit in the last place) at magnitude ``v``."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def int8_bound(m, k, n, dtype, bias=False):
    """K6's least time: x read, the int8 weights and f32 scales (and the
    f32 bias) read, the output written once, against 2 M K N operations at
    the peak of x's dtype."""
    name = str(dtype).replace("torch.", "")
    es = 4 if name == "float32" else 2
    t_bytes = (m * k * es + k * n + n * 4 * (2 if bias else 1)
               + m * n * es) / PEAK_BYTES_PER_S
    t_ops = 2.0 * m * n * k / PEAK_FLOPS[name]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def cycling(fn, copies):
    """A zero-argument call of ``fn(j)`` that walks ``j`` over
    ``range(copies)`` call by call."""
    state = [0]

    def call():
        j = state[0] % copies
        state[0] += 1
        return fn(j)
    return call


def int8_kernel_phase():
    """K6 against its plain version at the shapes of the two int8 paths:
    the scoring head at batch 1, 8 and 32 (K = N = 4096; at 32 also with
    the dense layer's bias and ReLU fused into the skinny kernel),
    BERT-base's qkv and fc/out products at 32 x 512 tokens, BERT's Dense(2)
    head, and a ragged case; f32 and bf16; in both modes, dequantize-first
    (what ``dense``, hence both paths, runs: the row's numbers) and the
    Pallas contract's scale-after (checked and timed beside). The fused
    case must also give the bits of the unfused kernel followed by the
    bias add and ReLU as torch ops. Weight sets above 8 MB rotate over
    enough copies to exceed the 50 MB L2, so each timed call reads its
    weights from HBM, as a batch-1 predict through the 4-layer head does.
    Then the padded ``torch._int_mm`` of the static path, bit for bit
    against the CPU's int32 product."""
    import torch

    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        KERNEL_INT8_ROUTES, LAST_LAUNCH, int8_matmul, int8_matmul_reference,
        int8_product)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for m, k, n, epi in INT8_CASES:
            name = f"{str(dtype)[6:]}_{m}x{k}x{n}" + ("_bias_relu" if epi
                                                       else "")
            g = torch.Generator().manual_seed(m + k + n)
            x = torch.randn(m, k, generator=g).to("cuda", dtype)
            copies = math.ceil(64e6 / (k * n)) if k * n > 8e6 else 1
            ws = [torch.randint(-127, 128, (k, n), generator=g,
                                dtype=torch.int8).cuda()
                  for _ in range(copies)]
            sc = (torch.rand(n, generator=g) * 0.09 + 0.01).cuda()
            bias = (torch.randn(n, generator=g) * 4.0).cuda() if epi \
                else None
            bits = torch.int32 if dtype == torch.float32 else torch.int16
            errs = {}
            before = {r: c.launches for r, c in KERNEL_INT8_ROUTES.items()}
            for first in (True, False):
                out = int8_matmul(x, ws[0], sc, first, bias=bias, relu=epi)
                again = int8_matmul(x, ws[0], sc, first, bias=bias,
                                    relu=epi)
                torch.cuda.synchronize()
                ref = int8_matmul_reference(x, ws[0], sc, first, bias=bias,
                                            relu=epi)
                top = max(ref.float().abs().max().item(),
                          int8_matmul_reference(x, ws[0], sc, first)
                          .float().abs().max().item())
                tol = (1e-4 * top if dtype == torch.float32
                       else bf16_step(top))
                err = (out.float() - ref.float()).abs().max().item()
                same = torch.equal(out.view(bits), again.view(bits))
                mode = "dequantize-first" if first else "scale-after"
                check(err <= tol, f"K6 {name} {mode}: max |kernel - plain| "
                      f"{err} > {tol}")
                check(same, f"K6 {name} {mode}: two runs differ")
                if epi:
                    plain = int8_matmul(x, ws[0], sc, first)
                    unfused = torch.relu(plain + bias.to(dtype))
                    check(torch.equal(out.view(bits), unfused.view(bits)),
                          f"K6 {name} {mode}: the fused epilogue differs "
                          f"from the product + bias + ReLU as torch ops")
                errs[first] = (err, tol, same)
            err, tol, same = errs[True]
            routes = {r for r, c in KERNEL_INT8_ROUTES.items()
                      if c.launches != before[r]}
            want_route = (
                "skinny" if m <= 32 else "fma" if dtype == torch.float32
                else "wgmma" if k % 8 == 0 and n % 16 == 0 else "mma")
            check(routes == {want_route}, f"K6 {name}: routes {routes}, not "
                  f"{want_route}")
            deq = [w.to(dtype) * sc.to(dtype) for w in ws]
            bound_ms, bound_by = int8_bound(m, k, n, dtype, epi)

            def fused(j):
                return int8_matmul(x, ws[j], sc, True, bias=bias, relu=epi)
            ms = time_ms(cycling(fused, copies))
            # the route and K slices the entry point reported for the
            # timed calls (1 slice off the skinny route)
            check(LAST_LAUNCH.route == want_route, f"K6 {name}: timed on "
                  f"{LAST_LAUNCH.route}, not {want_route}")
            row = {
                "case": name, "m": m, "k": k, "n": n, "route": want_route,
                "splits": LAST_LAUNCH.splits,
                "dtype": str(dtype)[6:], "epilogue": "bias+relu" if epi
                else None, "max_abs_err": err, "tol": tol,
                "same_bits_two_runs": same, "weight_copies": copies,
                "max_abs_err_scale_after": errs[False][0],
                "ms": ms, "device_ms": graph_ms(cycling(fused, copies)),
                "device_ms_scale_after": graph_ms(cycling(
                    lambda j: int8_matmul(x, ws[j], sc, bias=bias,
                                          relu=epi), copies)),
                "plain_ms": time_ms(cycling(
                    lambda j: int8_matmul_reference(x, ws[j], sc, True,
                                                    bias=bias, relu=epi),
                    copies)),
                "library_ms": time_ms(cycling(
                    lambda j: torch.matmul(x, deq[j]), copies)),
                "library_device_ms": graph_ms(cycling(
                    lambda j: torch.matmul(x, deq[j]), copies)),
                "bound_ms": bound_ms, "bound_by": bound_by}
            if epi:
                # the same product with the bias add and ReLU as the two
                # torch ops they were before the fusion
                row["device_ms_unfused"] = graph_ms(cycling(
                    lambda j: torch.relu(int8_matmul(x, ws[j], sc, True)
                                         + bias.to(dtype)), copies))
            rows[name] = row
            print(f"int8 kernel case {json.dumps(row)}")
            del x, ws, deq, out, again, ref
    for m in (1, T_BATCH):
        g = torch.Generator().manual_seed(m)
        xq = torch.randint(-127, 128, (m, HEAD_D), generator=g,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (HEAD_D, HEAD_D), generator=g,
                           dtype=torch.int8)
        xc, wc = xq.cuda(), wq.cuda()
        got = int8_product(xc, wc)
        equal = torch.equal(got.cpu(), torch._int_mm(xq, wq))
        check(equal, f"padded _int_mm at M={m} differs from the CPU's")
        row = {"case": f"int_mm_{m}x{HEAD_D}x{HEAD_D}", "bit_equal": equal,
               "ms": time_ms(lambda: int8_product(xc, wc)),
               "device_ms": graph_ms(lambda: int8_product(xc, wc))}
        rows[row["case"]] = row
        print(f"int8 kernel case {json.dumps(row)}")
    return rows


def q8_bound(m, k, n, bias=False):
    """Q8's least time: x (f32) and x_scale read, the int8 weights and f32
    w_scale (and bias) read, the f32 output written once, against 2 M K N
    operations at the int8 peak."""
    t_bytes = (m * k * 4 + 4 + k * n + n * 4 * (2 if bias else 1)
               + m * n * 4) / PEAK_BYTES_PER_S
    t_ops = 2.0 * m * n * k / PEAK_FLOPS["int8"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def static_int8_kernel_phase():
    """Q8 (the static int8 dense layer, ``csrc/quantized.cu``) against its
    plain version, the static path's torch ops (the padded ``_int_mm``),
    on the card and on the CPU, bit for bit, at the head's shapes, a
    ragged K, TextClassifier's and VGG-16's fc6 and fc8, without and with
    the bias and the fused ReLU; the same bits twice; the route and K
    splits each case ran (printed). Each timed: the wrapper, CUDA-graph
    device time, the plain version, the padded ``_int_mm`` alone and with
    its padding and quantize (the library), and the bound; weights above
    8 MB rotate over enough copies to exceed the L2."""
    import torch

    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        LAST_STATIC_LAUNCH, int8_product, static_int8_dense,
        static_int8_dense_reference)
    rows = {}
    for m, k, n in STATIC_CASES:
        for epi in (False, True):
            name = f"{m}x{k}x{n}" + ("_bias_relu" if epi else "")
            g = torch.Generator().manual_seed(m * 7 + k + n)
            x = torch.randn(m, k, generator=g) * 3.0
            x[0, :3] = torch.tensor([0.125, -0.375, 6.4])  # exact .5 ties
            xs = torch.tensor(0.05)
            copies = math.ceil(64e6 / (k * n)) if k * n > 8e6 else 1
            ws = [torch.randint(-127, 128, (k, n), generator=g,
                                dtype=torch.int8) for _ in range(copies)]
            sc = torch.rand(n, generator=g) * 0.02 + 0.001
            bias = torch.randn(n, generator=g) * 2.0 if epi else None
            xc, xsc, scc = x.cuda(), xs.cuda(), sc.cuda()
            wc = [w.cuda() for w in ws]
            bc = None if bias is None else bias.cuda()
            out = static_int8_dense(xc, xsc, wc[0], scc, bc, epi)
            again = static_int8_dense(xc, xsc, wc[0], scc, bc, epi)
            torch.cuda.synchronize()
            ref = static_int8_dense_reference(xc, xsc, wc[0], scc, bc, epi)
            cpu = static_int8_dense_reference(x, xs, ws[0], sc, bias, epi)
            same = {what: torch.equal(out.cpu().view(torch.int32),
                                      want.cpu().view(torch.int32))
                    for what, want in (("plain_cuda", ref), ("plain_cpu", cpu),
                                       ("second_run", again))}
            err = (out - ref).abs().max().item()
            check(all(same.values()), f"Q8 {name}: not the plain version's "
                  f"bits {same} (max |diff| {err})")
            bound_ms, bound_by = q8_bound(m, k, n, epi)
            xq = torch.clamp(torch.round(xc / xsc), -127, 127).to(torch.int8)
            xq_pad = torch.nn.functional.pad(xq, (0, -k % 8, 0,
                                                  max(17 - m, 0)))
            w_pad = [torch.nn.functional.pad(w, (0, -n % 8, 0, -k % 8))
                     for w in wc]

            def q8(j):
                return static_int8_dense(xc, xsc, wc[j], scc, bc, epi)
            row = {"case": name, "m": m, "k": k, "n": n,
                   "epilogue": "bias+relu" if epi else None,
                   "bit_equal": same, "max_abs_err": err,
                   "weight_copies": copies,
                   "ms": time_ms(cycling(q8, copies)),
                   "route": LAST_STATIC_LAUNCH.route,
                   "splits": LAST_STATIC_LAUNCH.splits,
                   "device_ms": graph_ms(cycling(q8, copies)),
                   "plain_ms": time_ms(cycling(
                       lambda j: static_int8_dense_reference(
                           xc, xsc, wc[j], scc, bc, epi), copies)),
                   "plain_device_ms": graph_ms(cycling(
                       lambda j: static_int8_dense_reference(
                           xc, xsc, wc[j], scc, bc, epi), copies)),
                   "library_ms": time_ms(cycling(
                       lambda j: torch._int_mm(xq_pad, w_pad[j]), copies)),
                   "library_device_ms": graph_ms(cycling(
                       lambda j: torch._int_mm(xq_pad, w_pad[j]), copies)),
                   "library_by": "torch._int_mm alone on the padded int8 "
                                 "operands",
                   "padded_int_mm_path_device_ms": graph_ms(cycling(
                       lambda j: int8_product(xq, wc[j]), copies)),
                   "bound_ms": bound_ms, "bound_by": bound_by}
            rows[name] = row
            print(f"static int8 kernel case {json.dumps(row)}")
            del x, ws, wc, w_pad, out, again, ref, cpu
    return rows


def static_int8_kernel_row(static_rows, launches):
    """Q8's row of the kernels line: at config A's batch-1 Dense(4096)
    layer, the main path's shape, with M = 32, the Dense(8) layer,
    TextClassifier's layers and VGG-16's fc6 and fc8 beside; ``launches``
    by path and route ({path: {route: launches}})."""
    main = static_rows["1x4096x4096_bias_relu"]
    launches_by_route = {}
    for by in launches.values():
        for route, n in by.items():
            launches_by_route[route] = launches_by_route.get(route, 0) + n
    launches = {path: sum(by.values()) for path, by in launches.items()}
    row = {"name": "static_int8_dense", "route": "cuda",
           "source": "analytics_zoo_tpu_torch/csrc/quantized.cu",
           "replaces": "analytics_zoo_tpu/pipeline/api/keras/layers/"
                       "core.py:106 (Dense.quantized_call; XLA "
                       "dot_general, no Pallas kernel)",
           "launches": sum(launches.values()),
           "launches_by_path": launches,
           "launches_by_route": launches_by_route,
           "kernel_route": main["route"],
           "max_abs_err": max(r["max_abs_err"] for r in static_rows.values()),
           "ms": main["ms"], "plain_ms": main["plain_ms"],
           "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
           "library_ms": main["library_ms"],
           "library_by": main["library_by"],
           "device_ms": main["device_ms"],
           "plain_device_ms": main["plain_device_ms"],
           "library_device_ms": main["library_device_ms"],
           "padded_int_mm_path_device_ms":
               main["padded_int_mm_path_device_ms"],
           "splits": main["splits"]}
    for tag, case in (("b32", "32x4096x4096_bias_relu"),
                      ("dense8_b1", "1x4096x8_bias_relu"),
                      ("text_fc1", "32x256x128_bias_relu"),
                      ("text_fc2", "32x128x20_bias_relu"),
                      ("fc6_b1", "1x25088x4096_bias_relu"),
                      ("fc6_b32", "32x25088x4096_bias_relu"),
                      ("fc8_b1", "1x4096x1000_bias_relu"),
                      ("fc8_b32", "32x4096x1000_bias_relu")):
        for key in ("ms", "device_ms", "plain_ms", "library_ms",
                    "library_device_ms", "bound_ms", "route", "splits"):
            row[f"{key}_{tag}"] = static_rows[case][key]
    return row


def dequantized_copy(net, dtype=None):
    """A float copy of a weight-only int8 network: each int8 ``W`` becomes
    ``W.float() * w_scale`` (every other leaf already is what the runtime
    computes with) — the model the int8 path is held against. With
    ``dtype``, ``W.to(dtype) * w_scale.to(dtype)`` instead: the weights the
    JAX weight-only predict forms (``dequantize_int8``), which K6's
    dequantize-first mode forms too."""
    import copy

    import torch
    net = copy.deepcopy(net)
    for mod in net.modules():
        if "w_scale" in mod._buffers:
            w = mod._buffers.pop("W")
            s = mod._buffers.pop("w_scale")
            deq = (w.float() * s if dtype is None
                   else w.to(dtype) * s.to(dtype))
            mod.register_parameter("W", torch.nn.Parameter(
                deq, requires_grad=False))
    return net


def rel_err(a, b):
    """Largest elementwise |a - b| / |b| (|b| floored at 1e-6)."""
    import numpy as np
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-6)))


class unfused_epilogue:
    """Within the block, ``dense`` runs K6 without its fused epilogue: the
    product, then the bias add and the ReLU as torch ops of their own, the
    port's weight-only predict before the fusion (the same numbers)."""

    def __enter__(self):
        import torch

        from analytics_zoo_tpu_torch.pipeline.api.keras.layers import core
        self.core, self.fused = core, core.int8_matmul

        def unfused(x, w, s, first=False, bias=None, relu=False):
            y = self.fused(x, w, s, first)
            if bias is not None:
                y = y + bias.to(y.dtype)
            return torch.relu(y) if relu else y
        core.int8_matmul = unfused
        return self

    def __exit__(self, *exc):
        self.core.int8_matmul = self.fused
        return False


class static_before_q8:
    """Within the block, ``Dense.quantized_call`` runs the static path as
    it did before Q8 at every row count: the quantize, the padded
    ``torch._int_mm`` and the rescale, bias and activation as torch ops
    (Q8's plain version; the same numbers)."""

    def __enter__(self):
        from analytics_zoo_tpu_torch.pipeline.api.keras.layers import core
        self.core, self.q8 = core, core.static_int8_dense
        core.static_int8_dense = core.static_int8_dense_reference
        return self

    def __exit__(self, *exc):
        self.core.static_int8_dense = self.q8
        return False


def int8_head_phase():
    """Config A: the JAX bench's weight-streaming scoring head
    (``bench.py:797-815``) trained one epoch, then served three ways. The
    static path's predicts of at most 32 rows run Q8 on every layer
    (counted); fault j's gate: fp32 / static int8 batch-1 device ms at
    least ``STATIC_B1_FLOOR``."""
    import copy

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.feature.feature_set import FeatureSet
    from analytics_zoo_tpu_torch.observability import MetricsRegistry
    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        KERNEL_INT8_MATMUL, KERNEL_INT8_ROUTES, KERNEL_INT8_STATIC,
        KERNEL_INT8_STATIC_ROUTES)
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving import ClusterServing

    init_zoo_context(conf={"zoo.compute.dtype": "float32", "zoo.seed": 0})
    d = HEAD_D
    fm = Sequential([Dense(d, activation="relu", input_shape=(d,)),
                     Dense(d, activation="relu"),
                     Dense(d, activation="relu"),
                     Dense(HEAD_CLASSES, activation="softmax")],
                    device="cuda").init_weights()
    fm.compile(optimizer="adam", loss="scce", lr=1e-4)
    rng = np.random.default_rng(2)
    xf = rng.normal(size=(HEAD_ROWS, d)).astype(np.float32)
    yf = rng.integers(0, HEAD_CLASSES, HEAD_ROWS).astype(np.int32)
    hist = fm.fit(FeatureSet.array(xf, yf, seed=0), batch_size=64,
                  nb_epoch=1)
    check(bool(np.all(np.isfinite(hist["loss"]))), f"head loss {hist}")
    host = copy.deepcopy(fm).to("cpu")
    host.device = torch.device("cpu")

    def resident(build):
        """The runtime ``build()`` makes and the device bytes it holds."""
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        im = build()
        torch.cuda.synchronize()
        return im, torch.cuda.memory_allocated() - before

    fp, fp_bytes = resident(
        lambda: InferenceModel(device="cuda").from_keras(host))
    w8, w8_bytes = resident(lambda: InferenceModel(device="cuda").from_keras(
        host, quantize="int8"))
    st, st_bytes = resident(lambda: InferenceModel(device="cuda").from_keras(
        host, quantize="int8", calibrate=xf[:8]))
    print(f"int8 head: resident weight bytes fp32 {fp_bytes}, weight-only "
          f"int8 {w8_bytes} ({w8_bytes / fp_bytes:.4f}x), static int8 "
          f"{st_bytes} ({st_bytes / fp_bytes:.4f}x)")
    check(w8_bytes <= 0.3 * fp_bytes and st_bytes <= 0.3 * fp_bytes,
          f"int8 resident bytes {w8_bytes}, {st_bytes} vs fp32 {fp_bytes}")

    deq = InferenceModel(device="cuda").from_keras(dequantized_copy(w8._model))
    cpu_static = InferenceModel(device="cpu").from_keras(
        host, quantize="int8", calibrate=xf[:8])
    # the static path's main run: 256 rows (one chunk, the padded
    # _int_mm), then 1, 8 and 32 rows (Q8 on all four layers)
    for cnt in (KERNEL_INT8_STATIC, *KERNEL_INT8_STATIC_ROUTES.values()):
        cnt.reset()
    p_fp, p_w8, p_st = fp.predict(xf), w8.predict(xf), st.predict(xf)
    st_small = {m: st.predict(xf[:m]) for m in (1, 8, T_BATCH)}
    q8_launches = KERNEL_INT8_STATIC.launches
    q8_routes = {r: c.launches for r, c in KERNEL_INT8_STATIC_ROUTES.items()}
    w8_rel = rel_err(p_w8, deq.predict(xf))
    st_rel = max(rel_err(p, cpu_static.predict(xf[:m]))
                 for m, p in st_small.items())
    st_rel = max(st_rel, rel_err(p_st[:8], cpu_static.predict(xf[:8])))
    print(f"int8 head: weight-only vs fp32 on the dequantized weights "
          f"{w8_rel:.3e}, static vs its plain CPU route (1, 8, 32 rows on "
          f"Q8, 8 of 256 on the padded _int_mm) {st_rel:.3e} (relative, "
          f"limit {INT8_REL_TOL}); Q8 launches {q8_launches} for three "
          f"predicts of at most {T_BATCH} rows, by route "
          f"{json.dumps(q8_routes)}")
    check(w8_rel <= INT8_REL_TOL, f"weight-only int8 vs dequantized fp32 "
          f"{w8_rel}")
    check(st_rel <= INT8_REL_TOL, f"static int8 vs its CPU route {st_rel}")
    check(q8_launches == 4 * len(st_small)
          and sum(q8_routes.values()) == q8_launches, f"{q8_launches} Q8 "
          f"launches ({q8_routes}) for {len(st_small)} static predicts of "
          f"4 layers")
    top1 = {mode: float((p.argmax(1) == p_fp.argmax(1)).mean() * 100.0)
            for mode, p in (("int8_weight_only", p_w8),
                            ("int8_static", p_st))}

    x1 = torch.from_numpy(xf[:1]).cuda()
    b1 = {mode: graph_ms(lambda im=im: im._forward([x1]))
          for mode, im in (("fp32", fp), ("int8_weight_only", w8),
                           ("int8_static", st))}
    # a batch of 32 on the static path (Q8's tensor-core route on every
    # layer) beside fp32's: device ms of one forward, and records/s
    x32 = torch.from_numpy(xf[:T_BATCH]).cuda()
    b32 = {mode: graph_ms(lambda im=im: im._forward([x32]))
           for mode, im in (("fp32", fp), ("int8_static", st))}
    print(f"int8 head: batch-{T_BATCH} device ms {json.dumps(b32)}: "
          f"static int8 {T_BATCH / (b32['int8_static'] / 1e3):.1f} "
          f"records/s, fp32 {T_BATCH / (b32['fp32'] / 1e3):.1f}")
    launches_b1 = {"int8_weight_only": device_kernels(
        lambda: w8._forward([x1]))}
    with unfused_epilogue():
        # the weight-only predict as it ran before the epilogue fusion:
        # each bias add and ReLU a torch op of its own after K6
        b1["int8_weight_only_unfused"] = graph_ms(
            lambda: w8._forward([x1]))
        launches_b1["int8_weight_only_unfused"] = device_kernels(
            lambda: w8._forward([x1]))
    launches_b1["int8_static"] = device_kernels(lambda: st._forward([x1]))
    with static_before_q8():
        # the static predict as it ran before Q8: the padded _int_mm and
        # the quantize, rescale, bias and activation as torch ops
        b1["int8_static_before_q8"] = graph_ms(lambda: st._forward([x1]))
        launches_b1["int8_static_before_q8"] = device_kernels(
            lambda: st._forward([x1]))
    speedup = {mode: b1["fp32"] / b1[mode]
               for mode in ("int8_weight_only", "int8_static",
                            "int8_weight_only_unfused",
                            "int8_static_before_q8")}
    print(f"int8 head: top-1 agreement with fp32 over {HEAD_ROWS} rows "
          f"{json.dumps(top1)} (%); batch-1 device ms {json.dumps(b1)}; "
          f"fp32 / int8 {json.dumps(speedup)}")
    print(f"int8 head: device kernels of one batch-1 weight-only _forward, "
          f"fused epilogue {len(launches_b1['int8_weight_only'])}, before "
          f"the fusion {len(launches_b1['int8_weight_only_unfused'])}: "
          f"{json.dumps(launches_b1)}")
    check(len(launches_b1["int8_weight_only"])
          < len(launches_b1["int8_weight_only_unfused"]),
          f"the fused epilogue launched no fewer kernels: {launches_b1}")
    print(f"int8 head: device kernels of one batch-1 static _forward, Q8 "
          f"{len(launches_b1['int8_static'])}, before Q8 "
          f"{len(launches_b1['int8_static_before_q8'])}; fault j: fp32 / "
          f"static int8 batch-1 device ms {speedup['int8_static']:.4f} "
          f"(floor {STATIC_B1_FLOOR}; before Q8 "
          f"{speedup['int8_static_before_q8']:.4f})")
    check(sum("int8_static_skinny" in name
              for name in launches_b1["int8_static"]) == 4,
          f"the static _forward did not run Q8 on its 4 layers: "
          f"{launches_b1['int8_static']}")
    check(speedup["int8_static"] >= STATIC_B1_FLOOR,
          f"fault j: fp32 / static int8 batch-1 {speedup['int8_static']} "
          f"below the floor {STATIC_B1_FLOOR}")

    registry = MetricsRegistry()

    def make_server(backend):
        server = ClusterServing(fm, backend=backend, batch_size=T_BATCH,
                                dtype="int8", registry=registry)
        check(isinstance(server.model, InferenceModel)
              and server.model._quantize == "int8",
              "ClusterServing did not wrap the head on the int8 path")
        server.model.predict(xf[:T_BATCH])          # warm-up, not counted
        return server

    got, wall, server = serve(make_server, xf, [KERNEL_INT8_MATMUL,
                                                *KERNEL_INT8_ROUTES.values()])
    launches = KERNEL_INT8_MATMUL.launches
    routes = {name: c.launches for name, c in KERNEL_INT8_ROUTES.items()}
    batches = int(registry.snapshot()["zoo_serving_batches_total"]["value"])
    served_rel = rel_err(got, p_w8)
    print(f"int8 head: ClusterServing(dtype='int8') answered {HEAD_ROWS} "
          f"records in {wall:.3f}s = {HEAD_ROWS / wall:.1f} records/s; "
          f"{batches} dispatches, {launches} int8_matmul launches; vs "
          f"predict {served_rel:.3e}")
    check(server.served == HEAD_ROWS, f"served {server.served}")
    check(got.shape == (HEAD_ROWS, HEAD_CLASSES), f"shape {got.shape}")
    check(launches == 4 * batches and batches > 0,
          f"{launches} K6 launches for {batches} dispatches of 4 layers")
    check(routes["skinny"] == launches, f"K6 routes {routes}: a dispatch of "
          f"at most {T_BATCH} rows off the skinny kernel")
    check(served_rel <= INT8_REL_TOL, f"served vs predict {served_rel}")
    return {"loss": hist["loss"], "resident_bytes": {
        "fp32": fp_bytes, "int8_weight_only": w8_bytes,
        "int8_static": st_bytes},
        "weight_only_vs_dequantized": w8_rel, "static_vs_cpu": st_rel,
        "top1_agreement_pct": top1, "b1_device_ms": b1,
        "b1_speedup": speedup, "b1_device_kernels": {
            mode: len(names) for mode, names in launches_b1.items()},
        "q8_launches": q8_launches, "q8_launches_by_route": q8_routes,
        "static_b32_device_ms": b32, "static_b32_records_per_s": {
            mode: T_BATCH / (ms / 1e3) for mode, ms in b32.items()},
        "int8_stream_b1_speedup": speedup["int8_static"],
        "records_per_s": HEAD_ROWS / wall,
        "wall_s": wall, "dispatches": batches, "launches": launches,
        "launches_by_route": routes}


def int8_serving_phase(bf16_records_per_s):
    """Config B: BERT-base served through ClusterServing on the weight-only
    int8 InferenceModel that ``_wrap_model`` builds for ``dtype="int8"``,
    behind the serving phase's adapter and on its records."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import KERNEL
    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        KERNEL_INT8_MATMUL, KERNEL_INT8_ROUTES)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.self_attention \
        import DenseParams
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving import ClusterServing
    from analytics_zoo_tpu_torch.tfpark.bert_classifier import \
        BERTClassifier

    init_zoo_context(conf={"zoo.pallas.attention": True,
                           "zoo.compute.dtype": "bfloat16", "zoo.seed": 0})
    t0 = time.perf_counter()
    model = BERTClassifier(num_classes=2, device="cuda").init_weights()
    cfg = model.get_config()
    im = ClusterServing._wrap_model(model, "int8")
    del model
    check(isinstance(im, InferenceModel) and im._quantize == "int8"
          and im.concurrent_num == 2, "_wrap_model: not the int8 runtime")
    mats = [mod.W for mod in im._model.modules()
            if isinstance(mod, (Dense, DenseParams))]
    int8_weights = sum(w.numel() for w in mats if w.dtype == torch.int8)
    check(all(w.dtype == torch.int8 for w in mats),
          "a BERT matmul weight is not int8")
    print(f"int8 serving: BERT-base quantized in "
          f"{time.perf_counter() - t0:.1f}s; {len(mats)} matmul weights, "
          f"{int8_weights} int8 bytes on the device")
    check(int8_weights >= 85e6, f"{int8_weights} int8 matmul weights")
    deq = InferenceModel(concurrent_num=2, device="cuda").from_keras(
        dequantized_copy(im._model))
    deq_jax = InferenceModel(concurrent_num=2, device="cuda").from_keras(
        dequantized_copy(im._model, torch.bfloat16))
    n_block = cfg["n_block"]
    ids = serving_records(cfg["vocab"])
    adapter = BertAdapter(im)
    adapter.predict_async(ids[:T_BATCH])()          # warm-up, not counted
    adapter.dispatches = 0
    got, wall, server = serve(
        lambda backend: ClusterServing(adapter, backend=backend,
                                       batch_size=T_BATCH), ids,
        [KERNEL, KERNEL_INT8_MATMUL, *KERNEL_INT8_ROUTES.values()])
    k6, k2, chunks = KERNEL_INT8_MATMUL.launches, KERNEL.launches, \
        adapter.dispatches
    routes = {name: c.launches for name, c in KERNEL_INT8_ROUTES.items()}
    print(f"int8 serving: {N_RECORDS} records in {wall:.3f}s = "
          f"{N_RECORDS / wall:.1f} records/s (bf16 serving in this run: "
          f"{bf16_records_per_s:.1f}); {chunks} dispatches, {k6} "
          f"int8_matmul ({json.dumps(routes)} by route) and {k2} "
          f"flash_attention_fwd launches")
    check(server.served == N_RECORDS, f"served {server.served}")
    check(got.shape == (N_RECORDS, 2), f"result shape {got.shape}")
    check(bool(np.isfinite(got).all()), "non-finite probabilities")
    sums = float(np.abs(got.sum(-1) - 1.0).max())
    check(sums <= 1e-2, f"probabilities sum off 1 by {sums}")
    check(chunks > 0 and k6 == (4 * n_block + 2) * chunks,
          f"{k6} K6 launches for {chunks} dispatches")
    check(k2 == n_block * chunks, f"{k2} K2 launches for {chunks} dispatches")
    # every product over the 32 x 512 tokens (M > 32) on the wgmma tile
    # path; the pooler and the Dense(2) head (M = 32) on the skinny kernel
    check(routes == {"wgmma": 4 * n_block * chunks, "mma": 0,
                     "skinny": 2 * chunks, "fma": 0},
          f"K6 routes {routes} for {chunks} dispatches")
    want, want_jax = (
        np.concatenate([m.predict(adapter.inputs(ids[i:i + T_BATCH]))
                        for i in range(0, N_RECORDS, T_BATCH)])
        for m in (deq, deq_jax))
    diff = float(np.abs(got - want).max())
    diff_jax = float(np.abs(got - want_jax).max())
    print(f"int8 serving: max |int8 - bf16 on the dequantized weights| "
          f"probability {diff:.3e} (tolerance 2e-2); on the weights the JAX "
          f"predict forms, bf16(q) * bf16(s) in bf16: {diff_jax:.3e}")
    check(diff <= 2e-2, f"int8 vs dequantized bf16 {diff}")
    check(diff_jax <= 2e-2, f"int8 vs the JAX predict's weights {diff_jax}")
    return {"records_per_s": N_RECORDS / wall, "wall_s": wall,
            "bf16_records_per_s": bf16_records_per_s, "dispatches": chunks,
            "launches": k6, "launches_by_route": routes,
            "flash_launches": k2, "int8_bytes": int8_weights,
            "vs_dequantized": diff, "vs_jax_predict_weights": diff_jax}


def serve_lanes(make_server, records, counters=(), backend=None,
                waiting=()):
    """``make_server(backend)`` on ``backend`` (a fresh ``LocalBackend``
    unless given) holding ``records`` (``[(uri, array, lane)]``,
    pre-enqueued after whatever ``waiting`` — ``[(uri, lane)]`` — names
    already there); one consumer thread a lane reads its answers in
    order. ``counters`` are set to 0 just before the start. Returns the
    answers (``uri -> array or error text``), each lane's seconds from
    the start to its last answer, the answer times (seconds from the
    start) and the stopped server."""
    import threading

    from analytics_zoo_tpu_torch.serving import (InputQueue, LocalBackend,
                                                 OutputQueue, ServingError)
    backend = backend if backend is not None else LocalBackend()
    server = make_server(backend)
    q = InputQueue(backend)
    by_lane = {}
    for uri, lane in waiting:
        by_lane.setdefault(lane, []).append(uri)
    for uri, x, lane in records:
        q.enqueue(uri, x, model=lane)
        by_lane.setdefault(lane, []).append(uri)
    for c in counters:
        c.reset()
    got, at, lane_s = {}, {}, {}
    t0 = time.perf_counter()
    server.start()

    def consume(lane, uris):
        out = OutputQueue(backend)
        for uri in uris:
            try:
                got[uri] = out.query(uri, timeout=300)
            except ServingError as e:
                got[uri] = str(e)
            at[uri] = time.perf_counter() - t0
        lane_s[lane] = time.perf_counter() - t0

    threads = [threading.Thread(target=consume, args=item)
               for item in by_lane.items()]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        server.stop()
    return got, lane_s, at, server


def lanes_phase():
    """Two lanes on one stream at full width: ``bert`` (BERT-base, bf16,
    K2 in its 12 blocks) and ``head`` (the JAX bench's int8 weight-
    streaming head, K6's skinny route on its 4 products), then buckets,
    arenas, overload, deadlines, AIMD, poison with the DLQ and a
    supervised restart."""
    import tempfile
    import threading

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common import faults
    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.observability import MetricsRegistry
    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import (
        KERNEL, flash_attention)
    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        KERNEL_INT8_MATMUL, KERNEL_INT8_ROUTES)
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving import (ClusterServing,
                                                 DeadLetterQueue)
    from analytics_zoo_tpu_torch.tfpark.bert_classifier import \
        BERTClassifier

    out = {}
    # 1. fault m: K2 as a fresh thread's first CUDA work
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 12, SEQ, 64, generator=g).to(
        "cuda", torch.bfloat16) for _ in range(3))
    want = flash_attention(q, k, v)
    torch.cuda.synchronize()
    box = {}

    def first_work():
        try:
            box["out"] = flash_attention(q, k, v)
            torch.cuda.synchronize()
        except Exception as e:
            box["error"] = repr(e)
    t = threading.Thread(target=first_work, name="fault-m")
    t.start()
    t.join()
    check("error" not in box, f"fault m: K2 from a fresh thread raised "
          f"{box.get('error')}")
    check(torch.equal(box["out"].view(torch.int16), want.view(torch.int16)),
          "fault m: a fresh thread's K2 is not the main thread's bits")
    print("lanes: fault m: K2 launched as a fresh thread's first CUDA work, "
          "the main thread's bits")

    # 2. the two lanes
    init_zoo_context(conf={"zoo.pallas.attention": True,
                           "zoo.compute.dtype": "bfloat16", "zoo.seed": 0})
    t0 = time.perf_counter()
    bert = BERTClassifier(num_classes=2, device="cuda").init_weights()
    cfg = bert.get_config()
    im = InferenceModel(concurrent_num=2, device="cuda").from_keras(
        bert, dtype="bfloat16")
    del bert
    n_block = cfg["n_block"]
    init_zoo_context(conf={"zoo.compute.dtype": "float32", "zoo.seed": 0,
                           "zoo.pallas.attention": True})
    head_net = Sequential([Dense(HEAD_D, activation="relu",
                                 input_shape=(HEAD_D,)),
                           Dense(HEAD_D, activation="relu"),
                           Dense(HEAD_D, activation="relu"),
                           Dense(HEAD_CLASSES, activation="softmax")],
                          device="cuda").init_weights()
    init_zoo_context(conf={"zoo.pallas.attention": True,
                           "zoo.compute.dtype": "bfloat16", "zoo.seed": 0})
    head_im = ClusterServing._wrap_model(head_net, "int8")
    del head_net                    # the runtime holds its int8 copy
    print(f"lanes: BERT-base bf16 and the int8 head built in "
          f"{time.perf_counter() - t0:.1f}s")
    adapter = BertAdapter(im)
    ids = serving_records(cfg["vocab"], N_LANE, seed=5)
    rows = np.random.default_rng(6).normal(size=(N_LANE, HEAD_D)).astype(
        np.float32)
    adapter.predict_async(ids[:T_BATCH])()      # warm-up, not counted
    head_im.predict(rows[:T_BATCH])
    torch.cuda.synchronize()
    mixed = [r for i in range(N_LANE)
             for r in ((f"bert-{i}", ids[i], "bert"),
                       (f"head-{i}", rows[i], "head"))]
    counters = [KERNEL, KERNEL_INT8_MATMUL, *KERNEL_INT8_ROUTES.values()]

    def two_lanes(registry, **kw):
        def make(backend):
            return ClusterServing(
                {"bert": adapter, "head": {"model": head_im,
                                           "dtype": "int8"}},
                backend=backend, batch_size=T_BATCH, registry=registry, **kw)
        return make

    def bert_only(registry, **kw):
        return lambda backend: ClusterServing(
            {"bert": adapter}, backend=backend, batch_size=T_BATCH,
            registry=registry, **kw)

    # in turns: bert alone, both lanes, both lanes, bert alone; the main
    # path's launch counts are the first two-lane run's
    turns = []
    for turn, kind in enumerate(("bert", "mixed", "mixed", "bert")):
        registry = MetricsRegistry()
        recs = mixed if kind == "mixed" else [
            (f"bert-{i}", ids[i], "bert") for i in range(N_LANE)]
        adapter.dispatches = 0
        got, lane_s, at, server = serve_lanes(
            (two_lanes if kind == "mixed" else bert_only)(registry), recs,
            counters)
        snap = registry.snapshot()
        run = {"kind": kind, "lane_s": lane_s,
               "records_per_s": {n: N_LANE / s for n, s in lane_s.items()},
               "bert_dispatches": adapter.dispatches,
               "k2": KERNEL.launches, "k6": KERNEL_INT8_MATMUL.launches,
               "k6_routes": {n: c.launches
                             for n, c in KERNEL_INT8_ROUTES.items()}}
        for fam in ("dispatch", "e2e"):
            s = next(m for m in registry.metrics()
                     if m.name == f"zoo_serving_{fam}_quantiles_seconds")
            run[f"{fam}_ms"] = {f"p{int(p * 100)}": s.quantile(p) * 1e3
                                for p in (0.5, 0.99)}
        run["answer_ms"] = {lane: {
            f"p{p}": float(np.percentile(
                [at[u] for u, _x, n in recs if n == lane], p)) * 1e3
            for p in (50, 99)} for lane in lane_s}
        models = server._health_info()["serving"]["models"]
        run["models"] = {n: {key: r[key] for key in (
            "records", "bucket_hit_rate", "pad_rows", "breaker")}
            for n, r in models.items()}
        run["head_dispatches"] = snap.get(
            'zoo_serving_model_dispatches_total{model="head"}',
            {}).get("value", 0)
        print(f"lanes turn {turn} ({kind}): " + ", ".join(
            f"{n} {N_LANE} records in {s:.3f}s = {N_LANE / s:.1f} "
            f"records/s" for n, s in lane_s.items())
              + f"; dispatch p50/p99 {run['dispatch_ms']['p50']:.3f}/"
              f"{run['dispatch_ms']['p99']:.3f} ms, e2e p50/p99 "
              f"{run['e2e_ms']['p50']:.3f}/{run['e2e_ms']['p99']:.3f} ms; "
              f"answers (ms from start) {json.dumps(run['answer_ms'])}; "
              f"models {json.dumps(run['models'])}")
        turns.append(run)
        if turn == 1:
            main_got, main = got, run
    out["turns"] = turns
    bert_n = main["bert_dispatches"]
    head_n = int(main["head_dispatches"])
    bad = [u for u, a in main_got.items() if isinstance(a, str)]
    check(not bad, f"lanes: {len(bad)} errors, e.g. {bad[:3]}: "
          f"{main_got[bad[0]] if bad else ''}")
    check(main["models"]["bert"]["records"] == N_LANE
          and main["models"]["head"]["records"] == N_LANE,
          f"lanes: per-lane records {main['models']}")
    got_bert = np.stack([main_got[f"bert-{i}"] for i in range(N_LANE)])
    got_head = np.stack([main_got[f"head-{i}"] for i in range(N_LANE)])
    check(got_bert.shape == (N_LANE, 2) and got_head.shape == (
        N_LANE, HEAD_CLASSES), f"lanes: shapes {got_bert.shape}, "
          f"{got_head.shape}: a record answered by the wrong lane")
    # each lane's predict of the same rows, in the served batches (a read
    # takes 32 records of each lane, in order). The compute policy is
    # process-wide, as in the JAX package: under BERT's bf16 policy the
    # head's products run K6 in bf16 too, so the head's predict of all
    # 256 rows at once (M = 256, another route) agrees to bf16's 2e-2
    want_bert = np.concatenate([im.predict(adapter.inputs(ids[i:i + T_BATCH]))
                                for i in range(0, N_LANE, T_BATCH)])
    want_head = np.concatenate([head_im.predict(rows[i:i + T_BATCH])
                                for i in range(0, N_LANE, T_BATCH)])
    bert_err = float(np.abs(got_bert - want_bert).max())
    head_rel = rel_err(got_head, want_head)
    head_whole = float(np.abs(got_head - head_im.predict(rows)).max())
    print(f"lanes: bert vs its predict {bert_err:.3e} (bf16 2e-2), head vs "
          f"its predict {head_rel:.3e} relative (1e-4), vs one predict of "
          f"all {N_LANE} rows {head_whole:.3e} (2e-2); {bert_n} bert "
          f"dispatches, {main['k2']} K2 launches; {head_n} head dispatches, "
          f"{main['k6']} K6 launches {json.dumps(main['k6_routes'])}")
    check(bert_err <= 2e-2, f"lanes: bert answers vs predict {bert_err}")
    check(head_rel <= INT8_REL_TOL, f"lanes: head answers vs predict "
          f"{head_rel}")
    check(head_whole <= 2e-2, f"lanes: head answers vs one predict "
          f"{head_whole}")
    check(bert_n > 0 and main["k2"] == n_block * bert_n,
          f"lanes: {main['k2']} K2 launches for {bert_n} bert dispatches")
    check(head_n > 0 and main["k6"] == 4 * head_n
          and main["k6_routes"]["skinny"] == main["k6"],
          f"lanes: K6 {main['k6']} ({main['k6_routes']}) for {head_n} head "
          f"dispatches")
    out.update(main=main, bert_vs_predict=bert_err, head_vs_predict=head_rel,
               head_vs_one_predict=head_whole,
               launches={"k2": main["k2"], "k6": main["k6"]},
               k6_routes=main["k6_routes"])

    # 3. buckets: ragged waves through the bert lane, buckets {4, 16, 32}
    seen_rows = []

    class Recording(BertAdapter):
        def predict_async(self, x, block=True):
            collect = super().predict_async(x, block=block)
            if collect is not None:
                seen_rows.append(len(x))
            return collect

    from analytics_zoo_tpu_torch.serving import (InputQueue, LocalBackend,
                                                 OutputQueue)
    rec_adapter = Recording(im)
    registry = MetricsRegistry()
    backend = LocalBackend()
    server = ClusterServing({"bert": rec_adapter}, backend=backend,
                            batch_size=T_BATCH, registry=registry,
                            shape_buckets="4,16,32").start()
    wave_ids = serving_records(cfg["vocab"], sum(BUCKET_WAVES), seed=7)
    answers = []
    try:
        inq, outq = InputQueue(backend), OutputQueue(backend)
        i = 0
        for k_wave in BUCKET_WAVES:
            for j in range(i, i + k_wave):
                inq.enqueue(f"w-{j}", wave_ids[j], model="bert")
            answers += [outq.query(f"w-{j}", timeout=300)
                        for j in range(i, i + k_wave)]
            i += k_wave
    finally:
        server.stop()
    pad = registry.snapshot()[
        'zoo_serving_bucket_pad_rows_total{model="bert"}']["value"]
    unpadded = np.concatenate([im.predict(adapter.inputs(wave_ids[j:j + 1]))
                               for j in range(len(wave_ids))])
    wave_err = float(np.abs(np.stack(answers) - unpadded).max())
    print(f"lanes buckets: waves {BUCKET_WAVES}, rows the model saw "
          f"{seen_rows}, pad rows {pad}; vs unpadded predict {wave_err:.3e}")
    check(seen_rows and set(seen_rows) <= {4, 16, 32},
          f"lanes buckets: rows {seen_rows} outside {{4, 16, 32}}")
    check(pad == sum(seen_rows) - len(wave_ids),
          f"lanes buckets: pad rows {pad} for rows {seen_rows}")
    check(wave_err <= 2e-2, f"lanes buckets: vs unpadded {wave_err}")
    out["buckets"] = {"rows": seen_rows, "pad_rows": pad,
                      "vs_unpadded": wave_err}

    # arenas: batches in flight two at a time (arenas reused while one is
    # out) against one at a time, the same pre-enqueued batches
    arena_ids = serving_records(cfg["vocab"], 5 * T_BATCH, seed=8)
    arena_recs = [(f"a-{i}", arena_ids[i], "bert")
                  for i in range(len(arena_ids))]
    bits = []
    for inflight in (2, 1):
        got, _, _, _ = serve_lanes(
            bert_only(MetricsRegistry(), max_inflight=inflight), arena_recs)
        bits.append(np.stack([got[u] for u, _x, _n in arena_recs]))
    check(np.array_equal(bits[0], bits[1]),
          "lanes arenas: two in flight are not the bits of one at a time")
    print(f"lanes arenas: {len(arena_recs)} records, max_inflight 2 gives "
          f"the bits of max_inflight 1")

    # 4. overload: 1024 bert records without and with a watermark of 64
    over_ids = serving_records(cfg["vocab"], N_OVERLOAD, seed=9)
    over_recs = [(f"o-{i}", over_ids[i], "bert") for i in range(N_OVERLOAD)]
    over = {}
    for watermark in (0, 64):
        registry = MetricsRegistry()
        got, lane_s, _, server = serve_lanes(
            bert_only(registry, shed_watermark=watermark), over_recs)
        snap = registry.snapshot()
        shed = sum(isinstance(a, str) and a.endswith(
            "shed: server overloaded") for a in got.values())
        answered = sum(not isinstance(a, str) for a in got.values())
        e2e = next(m for m in registry.metrics()
                   if m.name == "zoo_serving_e2e_quantiles_seconds")
        over[watermark] = {
            "answered": answered, "shed": shed,
            "shed_total": snap['zoo_serving_shed_total{reason="depth"}'][
                "value"],
            "e2e_p50_ms": e2e.quantile(0.5) * 1e3,
            "e2e_p99_ms": e2e.quantile(0.99) * 1e3, "wall_s": lane_s["bert"]}
        print(f"lanes overload (watermark {watermark}): {answered} answered, "
              f"{shed} shed in {lane_s['bert']:.3f}s; admitted e2e p50/p99 "
              f"{over[watermark]['e2e_p50_ms']:.3f}/"
              f"{over[watermark]['e2e_p99_ms']:.3f} ms")
        check(answered + shed == N_OVERLOAD
              and shed == over[watermark]["shed_total"],
              f"lanes overload: {answered} + {shed} != {N_OVERLOAD}")
    check(over[0]["shed"] == 0 and over[64]["shed"] > 0,
          f"lanes overload: sheds {over[0]['shed']}, {over[64]['shed']}")
    check(over[64]["e2e_p99_ms"] * 2 < over[0]["e2e_p99_ms"],
          f"lanes overload: admitted p99 {over[64]['e2e_p99_ms']} not under "
          f"half of {over[0]['e2e_p99_ms']}")
    registry = MetricsRegistry()
    got, _, _, _ = serve_lanes(
        two_lanes(registry, shed_watermark=16,
                  weights={"bert": 3, "head": 1}), mixed)
    admitted = {n: sum(not isinstance(got[u], str)
                       for u, _x, lane in mixed if lane == n)
                for n in ("bert", "head")}
    shed = sum(isinstance(a, str) and a.endswith("shed: server overloaded")
               for a in got.values())
    check(sum(admitted.values()) + shed == len(mixed),
          f"lanes weighted: {admitted} + {shed} != {len(mixed)}")
    print(f"lanes weighted (3:1, watermark 16): admitted {admitted} "
          f"({admitted['bert'] / max(admitted['head'], 1):.2f}:1), {shed} "
          f"shed")
    over["weighted"] = {"admitted": admitted, "shed": shed}
    out["overload"] = over

    # 5. deadlines: records past their deadline launch no K2
    late = [(f"late-{i}", ids[i]) for i in range(64)]
    registry = MetricsRegistry()
    backend = LocalBackend()
    inq = InputQueue(backend)
    stamp = int(time.time() * 1000) - 1
    for uri, x in late:
        inq.enqueue(uri, x, deadline_ms=stamp, model="bert")
    server = ClusterServing({"bert": adapter}, backend=backend,
                            batch_size=T_BATCH, registry=registry)
    KERNEL.reset()
    server.start()
    try:
        outq = OutputQueue(backend)
        errs = []
        for uri, _x in late:
            try:
                outq.query(uri, timeout=60)
                errs.append("value")
            except Exception as e:
                errs.append(str(e))
    finally:
        server.stop()
    check(all(e.endswith("deadline exceeded") for e in errs)
          and KERNEL.launches == 0,
          f"lanes deadlines: {set(errs)}, {KERNEL.launches} K2 launches")
    print(f"lanes deadlines: {len(late)} expired records answered "
          f"'deadline exceeded', 0 K2 launches")

    # AIMD: paced runs with adaptive_batch at two queue-wait targets; the
    # target's trajectory (run-length printed), answers and e2e
    rate = 600.0
    paced_ids = serving_records(cfg["vocab"], N_LANE, seed=10)
    out["aimd"] = {}
    for target_s in (0.1, 0.02):
        registry = MetricsRegistry()
        backend = LocalBackend()
        server = ClusterServing({"bert": adapter}, backend=backend,
                                batch_size=T_BATCH, registry=registry,
                                adaptive_batch=True,
                                queue_wait_target_s=target_s)
        ctl = server._lanes["bert"].batch_ctl
        trajectory = []
        update = ctl.update

        def recording(breach, update=update, trajectory=trajectory):
            trajectory.append(update(breach))
            return trajectory[-1]
        ctl.update = recording
        server.start()
        try:
            inq, outq = InputQueue(backend), OutputQueue(backend)
            t0 = time.perf_counter()
            for i in range(N_LANE):
                delay = t0 + i / rate - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                inq.enqueue(f"p-{i}", paced_ids[i], model="bert")
            paced = [outq.query(f"p-{i}", timeout=300)
                     for i in range(N_LANE)]
            wall = time.perf_counter() - t0
        finally:
            server.stop()
        snap = registry.snapshot()
        gauge = snap["zoo_serving_batch_size_target"]["value"]
        lane_gauge = snap['zoo_serving_model_batch_target{model="bert"}'][
            "value"]
        e2e = next(m for m in registry.metrics()
                   if m.name == "zoo_serving_e2e_quantiles_seconds")
        runs = []
        for t in trajectory:
            if runs and runs[-1][0] == t:
                runs[-1][1] += 1
            else:
                runs.append([t, 1])
        shape = ", ".join(f"{t}" if n == 1 else f"{t} x{n}"
                          for t, n in runs)
        run = {"target_s": target_s, "trajectory": runs,
               "wall_s": wall, "e2e_p50_ms": e2e.quantile(0.5) * 1e3,
               "e2e_p99_ms": e2e.quantile(0.99) * 1e3,
               "batches": snap["zoo_serving_batches_total"]["value"]}
        print(f"lanes AIMD (target {target_s * 1e3:.0f} ms): {N_LANE} "
              f"records paced at {rate:.0f}/s answered in {wall:.3f}s in "
              f"{run['batches']:.0f} batches, e2e p50/p99 "
              f"{run['e2e_p50_ms']:.3f}/{run['e2e_p99_ms']:.3f} ms; target "
              f"trajectory {shape}; gauge {gauge}")
        check(trajectory and all(1 <= t <= T_BATCH for t in trajectory),
              f"lanes AIMD: trajectory {shape} outside [1, {T_BATCH}]")
        check(gauge == lane_gauge == ctl.value == trajectory[-1],
              f"lanes AIMD: gauges {gauge}/{lane_gauge} vs {ctl.value}")
        check(len(paced) == N_LANE
              and all(np.isfinite(p).all() for p in paced),
              "lanes AIMD: paced answers")
        out["aimd"][f"{target_s * 1e3:.0f}ms"] = run

    # 6. poison: the head lane raises in Python on marked records
    class PoisonHead:
        def __init__(self, model):
            self.model = model

        def _check(self, x):
            if np.any(np.asarray(x)[:, 0] == POISON):
                raise RuntimeError("poison record")

        def predict(self, x):
            self._check(x)
            return self.model.predict(x)

        def predict_async(self, x, block=True):
            self._check(x)
            return self.model.predict_async(x, block=block)

    tmp = tempfile.TemporaryDirectory(prefix="zoo-dlq-")
    dlq = DeadLetterQueue(tmp.name, registry=MetricsRegistry())
    poison_rows = rows[:64].copy()
    marked = {3, 20, 41}
    for i in marked:
        poison_rows[i, 0] = POISON
    recs = [r for i in range(64)
            for r in ((f"pb-{i}", ids[i], "bert"),
                      (f"ph-{i}", poison_rows[i], "head"))]
    registry = MetricsRegistry()
    adapter.dispatches = 0
    got, _, _, _ = serve_lanes(
        lambda backend: ClusterServing(
            {"bert": adapter, "head": PoisonHead(head_im)}, backend=backend,
            batch_size=T_BATCH, registry=registry, dispatch_retries=1,
            dlq=dlq), recs, [KERNEL])
    snap = registry.snapshot()
    dead = {u for u, a in got.items() if isinstance(a, str)}
    spilled = {r["uri"]: r.get("model") for _s, r in dlq.scan()}
    # batch-mates of a poison record were retried one at a time (M = 1):
    # against a predict of the same rows, bf16's 2e-2
    good_head = np.stack([got[f"ph-{i}"] for i in range(64)
                          if i not in marked])
    good_err = float(np.abs(good_head - head_im.predict(
        rows[[i for i in range(64) if i not in marked]])).max())
    print(f"lanes poison: {sorted(dead)} dead-lettered, DLQ {spilled}; "
          f"batch-mates vs predict {good_err:.3e}; bert "
          f"{snap['zoo_serving_model_records_total{model=\"bert\"}']['value']}"
          f" records, {KERNEL.launches} K2 for {adapter.dispatches} "
          f"dispatches")
    check(dead == {f"ph-{i}" for i in marked}
          and all(got[u].endswith("dead-lettered: dispatch crashed "
                                  "repeatedly") for u in dead),
          f"lanes poison: dead-lettered {dead}")
    check(spilled == {f"ph-{i}": "head" for i in marked},
          f"lanes poison: DLQ {spilled}")
    check(good_err <= 2e-2, f"lanes poison: batch-mates {good_err}")
    check(snap['zoo_serving_model_records_total{model="bert"}']["value"]
          == 64 and KERNEL.launches == n_block * adapter.dispatches,
          "lanes poison: the bert lane's counts moved")

    # replay onto a server with the fixed head model; serving.loop fires
    # once, on the loop's first iteration (before any read, so no answer
    # can race the crash), and the supervisor restarts the loop
    init_zoo_context(conf={"zoo.pallas.attention": True,
                           "zoo.compute.dtype": "bfloat16", "zoo.seed": 0,
                           "zoo.faults.enabled": True})
    registry = MetricsRegistry()
    backend = LocalBackend()
    replayed = dlq.replay(backend)
    tail = [(f"rb-{i}", ids[i], "bert") for i in range(16)]
    plan = faults.FaultPlan(seed=0).add("serving.loop", "error", at=(0,))
    with faults.activate(plan):
        got, _, _, _ = serve_lanes(
            lambda b: ClusterServing(
                {"bert": adapter, "head": head_im}, backend=b,
                batch_size=T_BATCH, registry=registry), tail,
            backend=backend,
            waiting=[(f"ph-{i}", "head") for i in sorted(marked)])
    restarts = registry.snapshot()[
        'zoo_serving_loop_restarts_total{loop="serve"}']["value"]
    init_zoo_context(conf={"zoo.pallas.attention": True,
                           "zoo.compute.dtype": "bfloat16", "zoo.seed": 0,
                           "zoo.faults.enabled": False})
    tmp.cleanup()
    replay_err = float(np.abs(
        np.stack([got[f"ph-{i}"] for i in sorted(marked)])
        - head_im.predict(poison_rows[sorted(marked)])).max())
    print(f"lanes replay: {replayed} re-enqueued with their lane; "
          f"serving.loop fired {len(plan.fired)}, loop restarts "
          f"{restarts}; {len(got)} answered, the replayed vs the fixed "
          f"head's predict {replay_err:.3e}")
    check(replayed == len(marked), f"lanes replay: {replayed}")
    check(restarts == 1 and len(plan.fired) == 1,
          f"lanes restart: {restarts} restarts, fired {plan.fired}")
    check(len(got) == len(tail) + len(marked)
          and all(not isinstance(a, str) for a in got.values()),
          "lanes replay: a record unanswered after the restart")
    check(replay_err <= 2e-2, f"lanes replay: {replay_err}")
    out["poison"] = {"dead": sorted(dead), "replayed": replayed,
                     "restarts": restarts}
    return out

class HeldAdapter(BertAdapter):
    """The BERT adapter whose first dispatch waits for ``release``: the
    replica holds its read entries in flight as long as the phase wants
    (the kill window, a saturated fleet)."""

    def __init__(self, im):
        import threading
        super().__init__(im)
        self.entered = threading.Event()
        self.release = threading.Event()

    def predict_async(self, ids, block=True):
        self.entered.set()
        check(self.release.wait(timeout=300), "held dispatch never released")
        return super().predict_async(ids, block=block)


class Broker:
    """A :class:`MiniResp` in a child process (its own GIL): ``port``,
    ``writes()`` (the HSETs a ``result:`` key), ``close()``."""

    def __init__(self):
        self.proc = subprocess.Popen(
            [sys.executable, "-c",
             f"import sys; sys.path.insert(0, {REPO!r}); import chip_smoke; "
             f"chip_smoke.mini_resp_child()"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.port = int(self.proc.stdout.readline())

    def backend(self, **kw):
        from analytics_zoo_tpu_torch.serving import RedisBackend
        return RedisBackend(host="127.0.0.1", port=self.port, **kw)

    def writes(self):
        raw = self.backend()._r.command("ZOOWRITES")
        return {k.decode()[len("result:"):]: int(v)
                for k, v in zip(raw[::2], raw[1::2])
                if k.startswith(b"result:")}

    def stats(self):
        """``{command: (calls, seconds in its handler)}`` so far."""
        raw = self.backend()._r.command("ZOOSTATS")
        return {raw[i].decode(): (int(raw[i + 1]), float(raw[i + 2]))
                for i in range(0, len(raw), 3)}

    def close(self):
        self.proc.stdin.close()
        self.proc.wait(timeout=30)


def fleet_enqueue(backend, ids, prefix, stream=None):
    """Pre-enqueue ``ids`` untraced (the serving phase's plain records)."""
    from analytics_zoo_tpu_torch.serving.client import (INPUT_STREAM,
                                                        encode_tensor)
    for i, rec in enumerate(ids):
        backend.xadd(stream or INPUT_STREAM,
                     dict(encode_tensor(rec), uri=f"{prefix}-{i}"))


def fleet_wait_served(servers, n, timeout=300):
    """Wait, without touching the backend, until ``servers`` have
    published ``n`` records between them: a RESP consumer polling the
    result keys while the replicas serve would hand the interpreter's
    lock back and forth with their loops, and time that instead."""
    deadline = time.monotonic() + timeout
    while sum(s.served for s in servers) < n:
        check(time.monotonic() < deadline, f"served "
              f"{sum(s.served for s in servers)} of {n} in {timeout}s")
        time.sleep(0.005)


def fleet_answers(backend, prefix, n, first=()):
    """Answers ``{prefix}-0..n-1`` in order, the uris of ``first`` read
    before the rest: ``(answers, perf_counter when each was seen)``."""
    import numpy as np

    from analytics_zoo_tpu_torch.serving import OutputQueue
    out = OutputQueue(backend)
    first = list(first)
    uris = first + [f"{prefix}-{i}" for i in range(n)
                    if f"{prefix}-{i}" not in set(first)]
    got, at = {}, {}
    for uri in uris:
        got[uri] = out.query(uri, timeout=300)
        at[uri] = time.perf_counter()
    return np.stack([got[f"{prefix}-{i}"] for i in range(n)]), at


def fleet_phase():
    """Fleet serving at full width over the RESP wire: BERT-base replicas
    (bf16, K2 in its 12 blocks), each on its own ``InferenceModel`` and
    ``RedisBackend``, against one :class:`MiniResp` broker in a child
    process. (a) one replica over RESP against ``LocalBackend`` in turns,
    (b) two replicas on one stream, (c) one killed with a batch in flight
    and reclaimed by two survivors, (d) fleet backpressure refusing and
    then admitting, (e) the fleet collector, ``/fleetz``, ``fleet_cli``
    and the status CLI on the fleet, (f) a dead letter replayed over RESP
    by ``dlq_cli``."""
    import tempfile
    import urllib.request

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.common.reliability import RetryPolicy
    from analytics_zoo_tpu_torch.observability import (FleetCollector,
                                                       FleetzServer,
                                                       MetricsRegistry)
    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import KERNEL
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving import (ClusterServing,
                                                 FleetSaturatedError,
                                                 FleetView, InputQueue,
                                                 LocalBackend, OutputQueue,
                                                 ServingError)
    from analytics_zoo_tpu_torch.serving.client import INPUT_STREAM
    from analytics_zoo_tpu_torch.tfpark.bert_classifier import \
        BERTClassifier

    out = {}
    conf = {"zoo.pallas.attention": True, "zoo.compute.dtype": "bfloat16",
            "zoo.seed": 0}
    init_zoo_context(conf=conf)
    t0 = time.perf_counter()
    bert = BERTClassifier(num_classes=2, device="cuda").init_weights()
    cfg = bert.get_config()
    # two replicas' runtimes and the victim's: each replica its own
    ims = [InferenceModel(concurrent_num=2, device="cuda").from_keras(
        bert, dtype="bfloat16") for _ in range(3)]
    del bert
    n_block = cfg["n_block"]
    print(f"fleet: three BERT-base runtimes built in "
          f"{time.perf_counter() - t0:.1f}s")
    ids = serving_records(cfg["vocab"], N_FLEET, seed=9)
    adapters = [BertAdapter(im) for im in ims[:2]]
    for a in adapters:
        a.predict_async(ids[:T_BATCH])()            # warm-up, not counted
    torch.cuda.synchronize()
    # the serving phase's oracle route on the same records and batches
    init_zoo_context(conf={**conf, "zoo.pallas.attention": False})
    KERNEL.reset()
    oracle = np.concatenate([ims[0].predict(adapters[0].inputs(
        ids[i:i + T_BATCH])) for i in range(0, N_FLEET, T_BATCH)])
    check(KERNEL.launches == 0, "fleet: the oracle route launched K2")
    init_zoo_context(conf=conf)

    def vs_oracle(name, got):
        """Answers to the first ``len(got)`` records against the oracle's,
        record by record, at bf16's 2e-2."""
        err = float(np.abs(got - oracle[:len(got)]).max())
        check(got.shape[1:] == (2,) and bool(np.isfinite(got).all())
              and err <= 2e-2, f"fleet {name}: answers vs oracle {err}")
        return err

    def total(registries, name):
        return sum(v["value"] for r in registries
                   for k, v in r.snapshot().items()
                   if k.split("{", 1)[0] == name)

    def dispatch_ms(registries):
        """Mean dispatch-to-publish ms over the registries' batches."""
        snaps = [r.snapshot()["zoo_serving_dispatch_seconds"]
                 for r in registries]
        return (sum(x["sum"] for x in snaps)
                / max(sum(x["count"] for x in snaps), 1) * 1e3)

    # (a) one replica, RESP against local, in turns; records/s from the
    # start to the last publish
    turns = []
    for turn, kind in enumerate(("local", "resp", "resp", "local")):
        broker = Broker() if kind == "resp" else None
        backend = broker.backend() if broker else LocalBackend()
        reader = broker.backend() if broker else backend
        fleet_enqueue(backend, ids[:N_FLEET_ONE], f"a{turn}")
        registry = MetricsRegistry()
        server = ClusterServing(adapters[0], backend=backend,
                                batch_size=T_BATCH, registry=registry)
        # the wall runs from the start to the server's last publish; the
        # answers are read after it
        t0 = time.time()
        server.start()
        try:
            try:
                fleet_wait_served([server], N_FLEET_ONE)
            finally:
                server.stop()       # joins the publisher: the last publish
            # the broker's own share: seconds in each command's handler
            # (a blocking read's wait included)
            handlers = ({k: round(t * 1e3, 3) for k, (_, t)
                         in broker.stats().items()} if broker else None)
            got, _ = fleet_answers(reader, f"a{turn}", N_FLEET_ONE)
        finally:
            if broker:
                broker.close()
        wall = server._last_flush_wall - t0
        err = vs_oracle(f"(a) {kind}", got)
        turns.append({"backend": kind, "wall_s": wall,
                      "records_per_s": N_FLEET_ONE / wall, "vs_oracle": err,
                      "dispatch_ms": dispatch_ms([registry]),
                      "goodput_s": server._goodput.snapshot()["seconds"],
                      "broker_handler_ms": handlers})
        print(f"fleet (a) turn {turn} ({kind}): {N_FLEET_ONE} records in "
              f"{wall:.3f}s = {N_FLEET_ONE / wall:.1f} records/s; dispatch "
              f"mean {turns[-1]['dispatch_ms']:.2f} ms; goodput "
              f"{json.dumps(turns[-1]['goodput_s'])}; broker handler ms "
              f"{json.dumps(handlers)}; vs oracle {err:.3e}")
    local = np.mean([t["records_per_s"] for t in turns
                     if t["backend"] == "local"])
    resp = np.mean([t["records_per_s"] for t in turns
                    if t["backend"] == "resp"])
    out["resp_vs_local"] = {"turns": turns, "local_records_per_s": local,
                            "resp_records_per_s": resp,
                            "resp_over_local": resp / local}
    print(f"fleet (a): RESP {resp:.1f} records/s against local "
          f"{local:.1f} ({(1 - resp / local) * 100:.1f}% below; mean of "
          f"two each)")

    # (b) two replicas on one stream, each with its endpoint; kept
    # running for (e)
    broker = Broker()
    try:
        fleet_enqueue(broker.backend(), ids, "b")
        regs = [MetricsRegistry(), MetricsRegistry()]
        reps = [ClusterServing(adapters[i], backend=broker.backend(),
                               batch_size=T_BATCH, registry=regs[i],
                               consumer_name=f"rep{i}",
                               heartbeat_s=FLEET_HEARTBEAT_S)
                for i in range(2)]
        for a in adapters:
            a.dispatches = 0
        scrapes = [r.serve_metrics(0) for r in reps]
        endpoints = [f"127.0.0.1:{sc.port}" for sc in scrapes]
        reader = broker.backend()
        KERNEL.reset()
        t0 = time.time()
        for r in reps:
            r.start()
        fleet_wait_served(reps, N_FLEET)
        time.sleep(0.01)            # the publishers' bookkeeping after acks
        wall = max(r._last_flush_wall for r in reps) - t0
        got, _ = fleet_answers(reader, "b", N_FLEET)
        probe = broker.backend()
        dispatches = [a.dispatches for a in adapters]
        launches = KERNEL.launches
        writes = broker.writes()
        acks = total(regs, "zoo_serving_acks_total")
        pel = probe.pending_len(INPUT_STREAM, "serving")
        err = vs_oracle("(b)", got)
        shares = [r.served / N_FLEET for r in reps]
        print(f"fleet (b): two replicas, {N_FLEET} records in {wall:.3f}s "
              f"= {N_FLEET / wall:.1f} records/s ({N_FLEET / wall / resp:.2f}"
              f"x one RESP replica); shares {shares[0]:.3f}/{shares[1]:.3f},"
              f" dispatches {dispatches}, dispatch mean "
              f"{dispatch_ms(regs):.2f} ms, {launches} K2 launches; acks "
              f"{acks:.0f}, PEL {pel}; vs oracle {err:.3e}")
        check(launches == n_block * sum(dispatches) and all(dispatches),
              f"fleet (b): {launches} K2 launches for {dispatches}")
        check(sorted(writes) == sorted(f"b-{i}" for i in range(N_FLEET))
              and set(writes.values()) == {1},
              f"fleet (b): result writes {len(writes)} keys, counts "
              f"{sorted(set(writes.values()))}")
        check(acks == N_FLEET and pel == 0,
              f"fleet (b): acks {acks}, PEL {pel}")
        out["two_replicas"] = {
            "wall_s": wall, "records_per_s": N_FLEET / wall,
            "over_one_resp_replica": N_FLEET / wall / resp,
            "shares": shares, "dispatches": dispatches,
            "dispatch_ms": dispatch_ms(regs), "launches": launches,
            "vs_oracle": err}
        fleet_launches = launches

        # (e) the collector, on the running pair
        creg = MetricsRegistry()
        collector = FleetCollector(backend=broker.backend(),
                                   stream=INPUT_STREAM, registry=creg,
                                   interval_s=0.2, registry_ttl_s=3.0,
                                   retry=RetryPolicy(max_attempts=1))
        fz = FleetzServer(collector, port=0)
        try:
            deadline = time.monotonic() + 30
            while collector.poll() < 2 and time.monotonic() < deadline:
                time.sleep(0.05)
            page = get_json(fz.url)[1]
            check(set(page["replicas"]) == set(endpoints)
                  and page["fleet"]["replicas_live"] == 2
                  and all(r["source"] == "registry"
                          for r in page["replicas"].values()),
                  f"fleet (e): /fleetz replicas {page['replicas']}")
            scaling = {ep: get_json(f"http://{ep}/statusz")[1]["serving"][
                "scaling"] for ep in endpoints}
            for ep, sc in scaling.items():
                print(f"fleet (e): {ep} /statusz scaling {json.dumps(sc)}")
            cli = subprocess.run(
                [sys.executable, "-m",
                 "analytics_zoo_tpu_torch.observability.fleet_cli", "check",
                 *endpoints], cwd=REPO, capture_output=True, text=True,
                timeout=120)
            check(cli.returncode == 0 and "2 live" in cli.stdout,
                  f"fleet (e): fleet_cli check exit {cli.returncode}: "
                  f"{cli.stdout[-500:]} {cli.stderr[-500:]}")
            status = subprocess.run(
                [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.status",
                 *endpoints, "--json"], cwd=REPO, capture_output=True,
                text=True, timeout=120)
            doc = json.loads(status.stdout)
            check(status.returncode == 0
                  and sorted(doc["endpoints"]) == sorted(
                      f"http://{ep}" for ep in endpoints),
                  f"fleet (e): status CLI exit {status.returncode}")
            print(f"fleet (e): /fleetz lists {page['fleet']['replicas_live']}"
                  f" live (verdict {page['saturation']['verdict']}); "
                  f"fleet_cli check exits 0; the status CLI rolls up "
                  f"{len(doc['endpoints'])} endpoints")
            # one replica killed: its endpoint and heartbeat die
            reps[1].kill()
            t_kill = time.monotonic()
            while True:
                collector.poll()
                page = get_json(fz.url)[1]
                if page["fleet"]["replicas_down"] == 1:
                    break
                check(time.monotonic() - t_kill < 3.0 + 1.0,
                      f"fleet (e): the killed replica never listed down")
                time.sleep(0.05)
            down_s = time.monotonic() - t_kill
            check(page["fleet"]["replicas_live"] == 1,
                  f"fleet (e): after the kill {page['fleet']}")
            print(f"fleet (e): after a kill /fleetz lists 1 live, 1 down "
                  f"in {down_s:.3f}s")
            out["collector"] = {"scaling": scaling, "down_after_s": down_s,
                                "fleet_cli_exit": cli.returncode,
                                "status_cli_exit": status.returncode}
        finally:
            fz.close()
            collector.close()
            reps[0].stop()
    finally:
        broker.close()

    # (c) kill and reclaim at full width
    broker = Broker()
    try:
        fleet_enqueue(broker.backend(), ids, "c")
        victim_model = HeldAdapter(ims[2])
        regs = [MetricsRegistry() for _ in range(3)]
        common = dict(batch_size=T_BATCH, claim_idle_ms=FLEET_CLAIM_IDLE_MS,
                      heartbeat_s=FLEET_HEARTBEAT_S)
        for a in adapters:
            a.dispatches = 0
        KERNEL.reset()
        victim = ClusterServing(victim_model, backend=broker.backend(),
                                registry=regs[2], consumer_name="victim",
                                **common).start()
        check(victim_model.entered.wait(60), "fleet (c): victim never read")
        probe = broker.backend()
        window = probe.xpending(INPUT_STREAM, "serving")
        window_uris = [f"c-{i}" for i in range(T_BATCH)]
        survivors = [ClusterServing(adapters[i], backend=broker.backend(),
                                    registry=regs[i],
                                    consumer_name=f"survivor{i}", **common)
                     for i in range(2)]
        for s_ in survivors:
            s_.start()
        victim.kill(join=False)
        t_kill = time.perf_counter()
        victim_model.release.set()
        victim.kill()
        # the window's answers are timed: a 1-2 ms poll
        reader = broker.backend(poll_policy=RetryPolicy(base_delay=0.001,
                                                        max_delay=0.002))
        got, at = fleet_answers(reader, "c", N_FLEET, first=window_uris)
        reclaim_s = max(at[u] for u in window_uris) - t_kill
        for s_ in survivors:
            s_.stop()
        snaps = regs[:2]
        writes = broker.writes()
        answered = total(snaps, "zoo_serving_records_total")
        shed = total(snaps, "zoo_serving_shed_total")
        dead = total(snaps, "zoo_serving_dead_letter_total")
        reclaimed = {k: v["value"] for r in snaps
                     for k, v in r.snapshot().items()
                     if k.startswith("zoo_serving_reclaimed_total")}
        from_victim = sum(v for k, v in reclaimed.items()
                          if k == 'zoo_serving_reclaimed_total{from="victim"}')
        acks = total(snaps, "zoo_serving_acks_total")
        pel = probe.pending_len(INPUT_STREAM, "serving")
        launches = KERNEL.launches
        dispatches = [a.dispatches for a in adapters] + [
            victim_model.dispatches]
        # the survivors' dispatch-to-publish p99, against the claim idle
        p99_ms = max(r.snapshot()["zoo_serving_dispatch_quantiles_seconds"][
            "quantiles"].get("0.99", 0.0) for r in snaps) * 1e3
        err = vs_oracle("(c)", got)
        print(f"fleet (c): kill window {window}; answered {answered:.0f} + "
              f"shed {shed:.0f} + dead-lettered {dead:.0f} of {N_FLEET}, "
              f"victim answered {victim.served}; reclaimed {reclaimed}; "
              f"acks {acks:.0f}, PEL {pel}; dispatches {dispatches}, "
              f"{launches} K2 launches; survivors' dispatch p99 "
              f"{p99_ms:.1f} ms; kill to last reclaimed answer "
              f"{reclaim_s:.3f}s (claim_idle_ms {FLEET_CLAIM_IDLE_MS}); vs "
              f"oracle {err:.3e}")
        check(window == {"victim": T_BATCH}, f"fleet (c): window {window}")
        check(set(reclaimed) == {'zoo_serving_reclaimed_total{from="victim"}'},
              f"fleet (c): a live survivor's entries went idle past "
              f"claim_idle_ms {FLEET_CLAIM_IDLE_MS} and were reclaimed: "
              f"{reclaimed}")
        check(sorted(writes) == sorted(f"c-{i}" for i in range(N_FLEET))
              and set(writes.values()) == {1},
              f"fleet (c): result writes not once each "
              f"({len(writes)} keys, counts {sorted(set(writes.values()))})")
        check(answered + shed + dead == N_FLEET and victim.served == 0,
              f"fleet (c): {answered} + {shed} + {dead}, victim "
              f"{victim.served}")
        check(from_victim == T_BATCH, f"fleet (c): reclaimed {reclaimed}")
        check(acks == N_FLEET and pel == 0,
              f"fleet (c): acks {acks}, PEL {pel}")
        check(launches == n_block * sum(dispatches),
              f"fleet (c): {launches} K2 launches for {dispatches}")
        out["kill_reclaim"] = {
            "window": window, "answered": answered, "shed": shed,
            "dead": dead, "reclaimed": reclaimed, "acks": acks,
            "kill_to_reclaimed_s": reclaim_s, "dispatches": dispatches,
            "dispatch_p99_ms": p99_ms,
            "claim_idle_ms": FLEET_CLAIM_IDLE_MS,
            "launches": launches, "vs_oracle": err}
        fleet_launches += launches
    finally:
        broker.close()

    # (d) fleet backpressure: a blind control sheds, a fleet-aware
    # producer is refused while the fleet is saturated, then admitted
    def saturated(preload, tag):
        broker_ = Broker()
        fleet_enqueue(broker_.backend(), ids[:preload], tag)
        model = HeldAdapter(ims[0])
        reg = MetricsRegistry()
        rep = ClusterServing(model, backend=broker_.backend(),
                             batch_size=T_BATCH, registry=reg,
                             consumer_name="rep",
                             shed_watermark=FLEET_WATERMARK,
                             heartbeat_s=0.05, fleet_ttl_s=30.0).start()
        check(model.entered.wait(60), "fleet (d): the replica never read")
        return broker_, model, reg, rep

    blind = ids[N_FLEET - FLEET_EXTRA_BLIND:]
    broker, model, reg, rep = saturated(FLEET_PRELOAD, "dc")
    try:
        inq = InputQueue(broker.backend(), fleet_backpressure=False)
        for i, x in enumerate(blind):
            inq.enqueue(f"dc-x{i}", x)
        model.release.set()
        outq = OutputQueue(broker.backend())
        shed_uris = []
        for uri in ([f"dc-{i}" for i in range(FLEET_PRELOAD)]
                    + [f"dc-x{i}" for i in range(FLEET_EXTRA_BLIND)]):
            try:
                outq.query(uri, timeout=300)
            except ServingError:
                shed_uris.append(uri)
        rep.stop()
    finally:
        broker.close()
    control_shed = total([reg], "zoo_serving_shed_total")
    # the preload alone sits at the shed point: what is shed, the newest
    # of the read after the release, is shed because of the extras
    check(control_shed > 0 and len(shed_uris) == control_shed,
          f"fleet (d): the blind control shed {control_shed}: {shed_uris}")
    extra = ids[N_FLEET - FLEET_EXTRA:]
    broker, model, reg, rep = saturated(FLEET_PRELOAD, "dt")
    try:
        backend = broker.backend()
        inq = InputQueue(backend, fleet_backpressure=True, fleet_wait_s=0.2,
                         fleet_view=FleetView(backend, INPUT_STREAM,
                                              cache_s=0.05, ttl_s=30.0))
        refused = 0
        for i, x in enumerate(extra):
            try:
                inq.enqueue(f"dt-x{i}", x)
            except FleetSaturatedError:
                refused += 1
        model.release.set()
        t_rel = time.perf_counter()
        remaining = dict(enumerate(extra))
        while remaining and time.perf_counter() - t_rel < 60:
            for i, x in list(remaining.items()):
                try:
                    inq.enqueue(f"dt-x{i}", x)
                    del remaining[i]
                except FleetSaturatedError:
                    time.sleep(0.02)
        admitted_s = time.perf_counter() - t_rel
        outq = OutputQueue(broker.backend())
        got = [outq.query(f"dt-{i}", timeout=300)
               for i in range(FLEET_PRELOAD)]
        got += [outq.query(f"dt-x{i}", timeout=300)
                for i in range(FLEET_EXTRA)]
        rep.stop()
    finally:
        broker.close()
    shed = total([reg], "zoo_serving_shed_total")
    print(f"fleet (d): blind control: {FLEET_EXTRA_BLIND} extra records "
          f"on a preload of {FLEET_PRELOAD} (watermark {FLEET_WATERMARK}) "
          f"shed {control_shed:.0f}; "
          f"fleet-aware producer refused {refused} of {FLEET_EXTRA} "
          f"(FleetSaturatedError), all admitted {admitted_s:.3f}s after the "
          f"release; the replica shed {shed:.0f}")
    check(refused == FLEET_EXTRA and not remaining and shed == 0
          and all(g is not None for g in got),
          f"fleet (d): refused {refused}, left {len(remaining)}, shed "
          f"{shed}")
    out["backpressure"] = {"control_shed": control_shed,
                           "control_shed_uris": shed_uris, "refused": refused,
                           "admitted_after_s": admitted_s,
                           "treatment_shed": shed}

    # (f) a poison record dead-lettered, replayed over RESP by dlq_cli
    class Poison(BertAdapter):
        def predict_async(self, x, block=True):
            if np.any(np.asarray(x)[:, 0] == int(POISON)):
                raise RuntimeError("poison record")
            return super().predict_async(x, block=block)

    tmp = tempfile.TemporaryDirectory(prefix="zoo-fleet-dlq-")
    broker = Broker()
    try:
        rows = ids[:4].copy()
        rows[2, 0] = int(POISON)
        fleet_enqueue(broker.backend(), rows, "f")
        sick = ClusterServing(Poison(ims[0]), backend=broker.backend(),
                              batch_size=T_BATCH,
                              registry=MetricsRegistry(), dlq_dir=tmp.name,
                              dispatch_retries=1, consumer_name="sick")
        sick.start()
        outq = OutputQueue(broker.backend())
        answers = {}
        for i in range(4):
            try:
                answers[i] = outq.query(f"f-{i}", timeout=300)
            except ServingError as e:
                answers[i] = str(e)
        sick.stop()
        check(isinstance(answers[2], str)
              and answers[2].endswith("dead-lettered: dispatch crashed "
                                      "repeatedly")
              and all(not isinstance(answers[i], str) for i in (0, 1, 3)),
              f"fleet (f): answers {answers}")

        def dlq_cli(*argv):
            return subprocess.run(
                [sys.executable, "-m",
                 "analytics_zoo_tpu_torch.serving.dlq_cli", *argv],
                cwd=REPO, capture_output=True, text=True, timeout=120)

        listed = dlq_cli("list", tmp.name)
        inspected = dlq_cli("inspect", tmp.name)
        check(listed.returncode == 0
              and "replayable: 1 record(s)" in listed.stdout,
              f"fleet (f): dlq_cli list {listed.stdout} {listed.stderr}")
        check(inspected.returncode == 0 and "f-2" in inspected.stdout,
              f"fleet (f): dlq_cli inspect {inspected.stdout}")
        replayed = dlq_cli("replay", tmp.name, "--host", "127.0.0.1",
                           "--port", str(broker.port))
        check(replayed.returncode == 0
              and "replayed 1 record(s)" in replayed.stdout,
              f"fleet (f): dlq_cli replay {replayed.returncode} "
              f"{replayed.stdout} {replayed.stderr}")
        healthy = ClusterServing(adapters[0], backend=broker.backend(),
                                 batch_size=T_BATCH,
                                 registry=MetricsRegistry(),
                                 consumer_name="healthy").start()
        try:
            fixed = outq.query("f-2", timeout=300)
        finally:
            healthy.stop()
        want = ims[0].predict(adapters[0].inputs(rows[2:3]))
        replay_err = float(np.abs(fixed - want[0]).max())
        print(f"fleet (f): f-2 dead-lettered; dlq_cli list, inspect and "
              f"replay over RESP exit 0; the replayed record answered by a "
              f"healthy replica ({replay_err:.3e} from its predict)")
        check(replay_err <= 2e-2, f"fleet (f): replayed answer {replay_err}")
        out["dlq_replay"] = {"replayed": 1, "vs_predict": replay_err}
    finally:
        broker.close()
        tmp.cleanup()
    out["launches"] = fleet_launches
    return out


def int8_kernel_row(int8_rows, launches, launches_by_route):
    """K6's row of the kernels line: at BERT's qkv shape (config B's
    largest product, the wgmma tile path), with the scoring head's batch-1
    and batch-32 shapes (config A's f32, the skinny route; bf16 too)
    beside."""
    main = int8_rows["bfloat16_16384x768x2304"]
    row = {"name": "int8_matmul", "route": "cuda",
           "source": "analytics_zoo_tpu_torch/csrc/quantized.cu",
           "replaces": "analytics_zoo_tpu/ops/pallas/quantized.py:63",
           "launches": sum(launches.values()),
           "launches_by_path": launches,
           "launches_by_route": launches_by_route,
           "max_abs_err": main["max_abs_err"], "ms": main["ms"],
           "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
           "bound_by": main["bound_by"], "library_ms": main["library_ms"],
           "library_by": "torch.matmul on the dequantized weight",
           "device_ms": main["device_ms"],
           "library_device_ms": main["library_device_ms"]}
    for tag, case in (("head_b1", "float32_1x4096x4096"),
                      ("head_b32", "float32_32x4096x4096"),
                      ("head_b1_bf16", "bfloat16_1x4096x4096"),
                      ("head_b32_bf16", "bfloat16_32x4096x4096"),
                      ("text_fc1", "float32_32x256x128_bias_relu"),
                      ("text_fc2", "float32_32x128x20")):
        for key in ("ms", "device_ms", "plain_ms", "library_ms",
                    "library_device_ms", "bound_ms", "splits"):
            row[f"{key}_{tag}"] = int8_rows[case][key]
    return row


def same_bits(a, b):
    """Same bits, bf16 or f32."""
    import torch
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return torch.equal(a.view(view), b.view(view))


def bwd_kernel_phase():
    """K3a and K3b against their plain versions on one forward's output and
    lse, and against themselves: the same bits on a second run.
    Tolerances relative to the case's largest gradient: f32 1e-4
    (summation order), bf16 2e-2 (one bf16 step where the two f32 sums
    fall on either side of a rounding boundary)."""
    import torch

    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import (
        bwd_dkv, bwd_dkv_reference, bwd_dq, bwd_dq_reference,
        flash_attention)

    g = torch.Generator().manual_seed(2)
    cases = [  # name, dtype, tol, tq, tk, causal, empty_row
        ("f32_padded", torch.float32, 1e-4, 512, 512, False, False),
        ("bf16_padded", torch.bfloat16, 2e-2, 512, 512, False, False),
        ("f32_causal", torch.float32, 1e-4, 512, 512, True, False),
        ("bf16_causal", torch.bfloat16, 2e-2, 512, 512, True, False),
        ("f32_tq384_tk512", torch.float32, 1e-4, 384, 512, False, False),
        ("bf16_causal_tq512_tk384", torch.bfloat16, 2e-2, 512, 384, True,
         False),
        ("f32_fully_masked_row", torch.float32, 1e-4, 512, 512, False, True),
        ("bf16_fully_masked_row", torch.bfloat16, 2e-2, 512, 512, True,
         True),
    ]
    rows = []
    for name, dtype, tol, tq, tk, causal, empty in cases:
        q, k, v, do, mask = attention_inputs(8, 12, tq, tk, 64, dtype, g,
                                             empty)
        out, lse = flash_attention(q, k, v, mask=mask, causal=causal,
                                   want_lse=True)
        delta = (do.float() * out.float()).sum(-1)
        dq = bwd_dq(q, k, v, mask, lse, delta, do, causal)
        dk, dv = bwd_dkv(q, k, v, mask, lse, delta, do, causal)
        again = (bwd_dq(q, k, v, mask, lse, delta, do, causal),
                 *bwd_dkv(q, k, v, mask, lse, delta, do, causal))
        torch.cuda.synchronize()
        want = (bwd_dq_reference(q, k, v, mask, lse, delta, do, causal),
                *bwd_dkv_reference(q, k, v, mask, lse, delta, do, causal))
        row = {"case": name, "shape": [8, 12, tq, tk, 64],
               "dtype": str(dtype).replace("torch.", ""), "causal": causal,
               "tol_rel": tol}
        for key, got, ref, got2 in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                       want, again):
            check(same_bits(got, got2), f"{name}: {key} not the same bits "
                  f"on a second run")
            check(bool(torch.isfinite(got).all()), f"{name}: {key} not "
                  f"finite")
            err = (got.float() - ref.float()).abs().max().item()
            top = ref.float().abs().max().item()
            row[f"{key}_max_abs_err"] = err
            row[f"{key}_max_abs"] = top
            check(err <= tol * top, f"{name}: {key} max |kernel - plain| "
                  f"{err} > {tol} x {top}")
            if empty:
                check(bool(torch.all(got[0] == 0)),
                      f"{name}: {key} of the empty batch row not 0")
        rows.append(row)
        print(f"bwd kernel case {json.dumps(row)}")
    return rows


def training_data(n: int):
    """``n`` seeded BERT input rows (valid lengths uniform in 64..512,
    pad id 0) and binary labels: ``(x, y, ids)``."""
    import numpy as np

    from analytics_zoo_tpu_torch.tfpark.bert_classifier import \
        make_bert_inputs
    rng = np.random.default_rng(0)
    ids = rng.integers(1, TRAIN_CFG["vocab"], (n, SEQ)).astype(np.int32)
    lens = rng.integers(64, SEQ + 1, n)
    ids[np.arange(SEQ)[None, :] >= lens[:, None]] = 0
    y = rng.integers(0, 2, n).astype(np.int32)
    return make_bert_inputs(ids, attention_mask=(ids != 0)), y, ids


def step_breakdown(model, xb, yb):
    """Separate device timings of one training step's parts on one batch:
    the forward with autograd recording, forward + backward, and the
    AdamW update with its parameter add."""
    import torch

    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import (
        apply_updates, scalar_rows)
    from analytics_zoo_tpu_torch.pipeline.api.keras.training import \
        step_generator
    loop = model._loop
    params = loop._params()
    row = scalar_rows(loop.optimizer, model.opt_state["count"], 1, "cuda")[0]

    def forward():
        return loop.loss(yb, model(xb, training=True,
                                   generator=step_generator(0, 0)))

    def forward_backward():
        model.zero_grad(set_to_none=True)
        forward().backward()

    grads = {n: torch.full_like(p, 1e-3) for n, p in params.items()}

    def update():
        upd, _ = loop.optimizer.update(dict(grads), model.opt_state["state"],
                                       params, row)
        apply_updates(params, upd)

    out = {"forward": time_ms(forward, iters=5, warmup=1),
           "forward_backward": time_ms(forward_backward, iters=5, warmup=1),
           "optimizer": time_ms(update, iters=5, warmup=1)}
    model.zero_grad(set_to_none=True)
    return out


def training_phase():
    """compile/fit of the seq-512 fine-tune configuration; returns the
    summary and the token ids of one batch (its padding is the kernels'
    main-path padding)."""
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import (
        KERNEL, KERNEL_BWD_DKV, KERNEL_BWD_DQ)
    from analytics_zoo_tpu_torch.pipeline.api.keras.training import (
        _to_device, step_generator)
    from analytics_zoo_tpu_torch.tfpark.bert_classifier import \
        BERTClassifier

    conf = {"zoo.pallas.attention": True, "zoo.compute.dtype": "bfloat16",
            "zoo.seed": 0}
    init_zoo_context(conf=conf)
    t0 = time.perf_counter()
    model = BERTClassifier(**TRAIN_CFG, device="cuda").init_weights()
    model.compile(optimizer="adamw", loss="scce", metrics=["accuracy"],
                  lr=2e-5)
    print(f"training: BERT-base built in {time.perf_counter() - t0:.1f}s "
          f"({json.dumps(model.get_config())}), bf16 compute, f32 params, "
          f"AdamW lr 2e-5")
    x, y, ids = training_data(N_RECORDS)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}

    t0 = time.perf_counter()
    model.fit(x, y, batch_size=T_BATCH, nb_epoch=1)     # warm-up
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0

    kernels = (KERNEL, KERNEL_BWD_DQ, KERNEL_BWD_DKV)
    for c in kernels:
        c.reset()
    records = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = model.fit(x, y, batch_size=T_BATCH, nb_epoch=1,
                     callbacks=[records.append])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [c.launches for c in kernels]
    steps = N_RECORDS // T_BATCH
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    loss = hist["loss"][0]
    summary = {"steps": steps, "batch": T_BATCH, "epoch_loss": loss,
               "samples_per_s": records[0]["throughput"],
               "ms_per_step": 1e3 * wall / steps, "wall_s": wall,
               "warmup_epoch_s": warm, "peak_memory_gb": peak_gb,
               "launches": dict(zip(("flash_attention_fwd",
                                     "flash_attention_bwd_dq",
                                     "flash_attention_bwd_dkv"), launches))}
    print(f"training: {steps} steps of {T_BATCH} in {wall:.3f}s = "
          f"{summary['samples_per_s']:.2f} samples/s, "
          f"{summary['ms_per_step']:.1f} ms/step (warm-up epoch "
          f"{warm:.1f}s, peak {peak_gb:.1f} GB); epoch loss {loss:.4f}; "
          f"launches K2/K3a/K3b {launches}")
    check(math.isfinite(loss), f"epoch loss {loss}")
    want = TRAIN_CFG["n_block"] * steps
    check(launches == [want] * 3, f"launches {launches}, want {want} each "
          f"(n_block x steps)")
    unmoved = [n for n, p in model.named_parameters()
               if not bool(torch.isfinite(p).all())
               or torch.equal(p.detach(), start[n])]
    check(not unmoved, f"parameters not moved or not finite: {unmoved}")
    del start

    xb = _to_device([a[:T_BATCH] for a in x], torch.device("cuda"))
    yb = _to_device(y[:T_BATCH], torch.device("cuda"))
    summary["step_breakdown_ms"] = step_breakdown(model, xb, yb)
    print(f"training: step parts (separate timings) "
          f"{json.dumps(summary['step_breakdown_ms'])}")

    # one step's gradients, flash route against the oracle route
    grads = {}
    for route in (True, False):
        init_zoo_context(conf={**conf, "zoo.pallas.attention": route})
        model.zero_grad(set_to_none=True)
        out = model(xb, training=True, generator=step_generator(0, 0))
        model._loop.loss(yb, out).backward()
        grads[route] = {n: p.grad.detach().clone()
                        for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    rel = {n: ((grads[True][n] - grads[False][n]).norm()
               / grads[False][n].norm().clamp_min(1e-30)).item()
           for n in grads[True]}
    worst = max(rel, key=rel.get)
    summary["grad_rel_err_max"] = rel[worst]
    summary["grad_rel_err_leaf"] = worst
    print(f"training: flash vs oracle route, one step's gradients: largest "
          f"per-leaf relative error {rel[worst]:.3e} ({worst}; bf16 "
          f"tolerance {GRAD_REL_TOL})")
    check(rel[worst] <= GRAD_REL_TOL, f"flash vs oracle gradients: {worst} "
          f"{rel[worst]}")
    init_zoo_context(conf=conf)
    return summary, ids[:T_BATCH]


def main_path_kernel_rows(ids, launches):
    """Every kernel at the shape the training path gave it: one batch of
    32 BERT-base records in bf16 with this run's key padding (B=32, H=12,
    T=512, D=64)."""
    import torch
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import (
        bwd_dkv, bwd_dkv_reference, bwd_dq, bwd_dq_reference,
        flash_attention, flash_attention_reference)
    g = torch.Generator().manual_seed(1)
    q, k, v, do, mask = attention_inputs(T_BATCH, 12, SEQ, SEQ, 64,
                                         torch.bfloat16, g, lens_from=ids)
    out, lse = flash_attention(q, k, v, mask=mask, want_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    dq = bwd_dq(q, k, v, mask, lse, delta, do)
    dk, dv = bwd_dkv(q, k, v, mask, lse, delta, do)
    again = (bwd_dq(q, k, v, mask, lse, delta, do),
             *bwd_dkv(q, k, v, mask, lse, delta, do))
    torch.cuda.synchronize()
    for key, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), again):
        check(same_bits(a, b), f"main-path shape: {key} not the same bits "
              f"on a second run")
    del again
    ref_out, _ = flash_attention_reference(q, k, v, mask, want_lse=True)
    ref_dq = bwd_dq_reference(q, k, v, mask, lse, delta, do)
    ref_dk, ref_dv = bwd_dkv_reference(q, k, v, mask, lse, delta, do)

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    fwd_err = err(out, ref_out)
    dq_err = err(dq, ref_dq)
    dkv_err = max(err(dk, ref_dk), err(dv, ref_dv))
    check(fwd_err <= 2e-2, f"main-path shape: K2 vs plain {fwd_err}")
    for name, e, ref in (("K3a", dq_err, ref_dq),
                         ("K3b", dkv_err, torch.stack([ref_dk, ref_dv]))):
        top = ref.float().abs().max().item()
        check(e <= 2e-2 * top, f"main-path shape: {name} vs plain {e} > "
              f"2e-2 x {top}")

    attn = (mask >= 1.0)[:, None, None, :]
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=attn)
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(
        sdpa_out, (qs, ks, vs), do, retain_graph=True))
    timings = {
        "flash_attention_fwd": (
            time_ms(lambda: flash_attention(q, k, v, mask=mask,
                                            want_lse=True)),
            time_ms(lambda: flash_attention_reference(q, k, v, mask,
                                                      want_lse=True)),
            time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn)),
            attention_bound(q, k, mask, False, n_row_f32=1)),
        "flash_attention_bwd_dq": (
            time_ms(lambda: bwd_dq(q, k, v, mask, lse, delta, do)),
            time_ms(lambda: bwd_dq_reference(q, k, v, mask, lse, delta, do)),
            sdpa_bwd_ms,
            # reads q, dO, k, v; writes dq; reads lse and delta
            attention_bound(q, k, mask, False, 6, n_q_sized=3,
                            n_kv_sized=2, n_row_f32=2)),
        "flash_attention_bwd_dkv": (
            time_ms(lambda: bwd_dkv(q, k, v, mask, lse, delta, do)),
            time_ms(lambda: bwd_dkv_reference(q, k, v, mask, lse, delta,
                                              do)),
            sdpa_bwd_ms,
            # reads q, dO, k, v; writes dk, dv; reads lse and delta
            attention_bound(q, k, mask, False, 8, n_q_sized=2,
                            n_kv_sized=4, n_row_f32=2)),
    }
    errors = {"flash_attention_fwd": fwd_err, "flash_attention_bwd_dq": dq_err,
              "flash_attention_bwd_dkv": dkv_err}
    src = "analytics_zoo_tpu_torch/csrc/"
    meta = {
        "flash_attention_fwd": (src + "flash_attention_fwd.cu",
                                "analytics_zoo_tpu/ops/pallas/"
                                "flash_attention.py:385"),
        "flash_attention_bwd_dq": (src + "flash_attention_bwd.cu",
                                   "analytics_zoo_tpu/ops/pallas/"
                                   "flash_attention.py:524"),
        "flash_attention_bwd_dkv": (src + "flash_attention_bwd.cu",
                                    "analytics_zoo_tpu/ops/pallas/"
                                    "flash_attention.py:544"),
    }
    rows = []
    for name, (ms, plain_ms, library_ms, (bound_ms, bound_by)) \
            in timings.items():
        rows.append({"name": name, "route": "cuda", "source": meta[name][0],
                     "replaces": meta[name][1],
                     "launches": launches[name],
                     "max_abs_err": errors[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms})
    return rows


#: CE kernels against their plain versions (tests/test_torch_port_cuda.py):
#: f32 only summation order differs; in bf16 a logit that the two f32
#: sums leave on either side of a rounding boundary moves by one bf16 step
#: (2^-8 relative), so lse 2e-2, the label logit one step of its size and
#: the gradients 2e-2 of the case's largest
CE_TOL = {"float32": dict(lse=1e-4, ll_rel=1e-5, grad=1e-4),
          "bfloat16": dict(lse=2e-2, ll_rel=2.0 ** -7, grad=2e-2)}


def bit_equal(a, b):
    """Same bits, NaN payloads included."""
    import torch
    return (a is None and b is None) or torch.equal(a.view(torch.int32),
                                                    b.view(torch.int32))


def ce_kernel_phase():
    """K4, K5a and K5b against their plain versions at N=4100, H=512."""
    import torch

    from analytics_zoo_tpu_torch.ops.pallas.cross_entropy import (
        LAST_DH_LAUNCH, LAST_DW_LAUNCH, LAST_FWD_LAUNCH, fused_ce_backward,
        fused_ce_backward_reference, fused_ce_forward,
        fused_ce_forward_reference)
    n, hidden = 4100, 512
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # name, dtype, V, bias, over-range labels, one bias of 100
        ("f32_v8192", f32, 8192, True, False, False),
        ("bf16_v8192", bf16, 8192, True, False, False),
        ("bf16_v8000_ragged_vocab", bf16, 8000, True, False, False),
        ("bf16_no_bias", bf16, 8192, False, False, False),
        ("f32_over_range", f32, 8000, True, True, False),
        ("bf16_over_range", bf16, 8192, True, True, False),
        ("bf16_bias100_ragged_rows", bf16, 8000, True, False, True),
    ]
    g = torch.Generator().manual_seed(4)
    rows = []
    for name, dtype, v, bias, over, big in cases:
        tol = CE_TOL[str(dtype).replace("torch.", "")]
        h = torch.randn(n, hidden, generator=g).to("cuda", dtype)
        w = (torch.randn(hidden, v, generator=g) * hidden ** -0.5).to(
            "cuda", dtype)
        b = (torch.randn(v, generator=g) * 0.5).cuda() if bias else None
        labels = torch.randint(0, v, (n,), generator=g,
                               dtype=torch.int32).cuda()
        labels[::3] = -1                                # masked rows
        bad = torch.zeros(n, dtype=torch.bool, device="cuda")
        if over:
            bad[[7, 2000, 4099]] = True
            labels[bad] = torch.tensor([v, v + 1, 10 ** 6],
                                       dtype=torch.int32, device="cuda")
        if big:
            b[3] = 100.0
        lse, ll = fused_ce_forward(h, w, b, labels)
        torch.cuda.synchronize()
        fwd_route = LAST_FWD_LAUNCH.route
        ref_lse, ref_ll = fused_ce_forward_reference(h, w, b, labels)
        lse_err = (lse - ref_lse).abs().max().item()
        ll_err = ((ll - ref_ll).abs() / ref_ll.abs().clamp_min(1.0)
                  ).max().item()
        check(lse_err <= tol["lse"], f"{name}: K4 lse {lse_err}")
        check(ll_err <= tol["ll_rel"], f"{name}: K4 label logit {ll_err}")
        valid = labels >= 0
        scale = torch.where(valid, 1.0 / valid.sum().float(),
                            torch.zeros((), device="cuda"))
        scale = torch.where(labels >= v, torch.full((), float("nan"),
                                                    device="cuda"), scale)
        runs = []
        for _ in range(2):
            runs.append(fused_ce_backward(h, w, b, labels, lse, scale))
            torch.cuda.synchronize()
        dh, dw, db = runs[0]
        want_route = "wgmma" if dtype == bf16 else "fma"
        routes = {"fused_ce_fwd": fwd_route,
                  "fused_ce_bwd_dh": LAST_DH_LAUNCH.route,
                  "fused_ce_bwd_dw": LAST_DW_LAUNCH.route}
        for kernel, route in routes.items():
            check(route == want_route, f"{name}: {kernel} took {route}, "
                  f"want {want_route}")
        dh_same = bit_equal(runs[0][0].float(), runs[1][0].float())
        check(dh_same, f"{name}: K5a dh differs between two runs")
        same = bit_equal(runs[0][1], runs[1][1]) and bit_equal(runs[0][2],
                                                               runs[1][2])
        check(same, f"{name}: K5b dW/db differ between two runs")
        ref = fused_ce_backward_reference(h, w, b, labels, lse, scale)
        check(bool(torch.all(dh[labels < 0] == 0)),
              f"{name}: masked rows' dh not exactly 0")
        row = {"case": name, "n": n, "hidden": hidden, "vocab": v,
               "dtype": str(dtype).replace("torch.", ""), "bias": bias,
               "lse_err": lse_err, "ll_rel_err": ll_err,
               "tol": tol, "dw_db_bit_identical": same,
               "routes": routes, "dh_bit_identical": dh_same}
        if over:
            check(bool(torch.isnan(dh[bad]).all()
                       and torch.isfinite(dh[~bad]).all()),
                  f"{name}: NaN rows of dh")
            check(bool(torch.isnan(dw).all()), f"{name}: dW not all NaN")
            row["nan_rows"] = int(torch.isnan(dh).any(dim=1).sum())
            pairs = (("dh", dh[~bad], ref[0][~bad]),)
        else:
            pairs = (("dh", dh, ref[0]), ("dw", dw, ref[1]),
                     ("db", db, ref[2]))
        for key, got, want in pairs:
            if want is None:
                check(got is None, f"{name}: {key} without a bias")
                continue
            check(bool(torch.isfinite(got).all()), f"{name}: {key} not "
                  f"finite")
            err = (got.float() - want.float()).abs().max().item()
            top = want.float().abs().max().item()
            row[f"{key}_max_abs_err"] = err
            row[f"{key}_max_abs"] = top
            check(err <= tol["grad"] * top, f"{name}: {key} {err} > "
                  f"{tol['grad']} x {top}")
        rows.append(row)
        print(f"ce kernel case {json.dumps(row)}")
    return rows


def lm_data(n: int = LM_SEQS, seq: int = LM_SEQ):
    """The bench's data: ``n`` sequences of ``seq`` ids from numpy seed 7
    and the learnable map y = (7x + 13) mod V."""
    import numpy as np
    rng = np.random.default_rng(7)
    x = rng.integers(0, LM_VOCAB, (n, seq)).astype(np.int32)
    return x, ((7 * x + 13) % LM_VOCAB).astype(np.int32)


def lm_phase():
    """compile/fit of the 4k causal LM with every flag at auto; returns
    the summary and the labels of one batch."""
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.fused_loss import \
        resolve_fused_loss
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Dense, TransformerLayer)
    from analytics_zoo_tpu_torch.pipeline.api.keras.training import (
        _to_device, step_generator)

    init_zoo_context(conf={"zoo.compute.dtype": "bfloat16", "zoo.seed": 0,
                           "zoo.pallas.attention": "auto",
                           "zoo.pallas.cross_entropy": "auto",
                           "zoo.train.fused_ce": "auto"})
    t0 = time.perf_counter()
    model = Sequential([TransformerLayer(**LM_CFG, input_shape=(LM_SEQ,)),
                        Dense(LM_VOCAB)]).init_weights()
    model.compile(optimizer="adam", loss="scce_with_logits", lr=3e-4)
    print(f"lm: built in {time.perf_counter() - t0:.1f}s "
          f"({json.dumps(LM_CFG)}, head Dense({LM_VOCAB})), bf16 compute, "
          f"f32 params, Adam lr 3e-4, batch {LM_BATCH}")
    x, y = lm_data()
    records = []
    t0 = time.perf_counter()
    model.fit(x, y, batch_size=LM_BATCH, nb_epoch=2,
              callbacks=[records.append])                 # warm-up
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0

    reset_lm_counts()
    timed = []
    t0 = time.perf_counter()
    model.fit(x, y, batch_size=LM_BATCH, nb_epoch=2,
              callbacks=[timed.append])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, ce_routes = lm_counts()
    records += timed
    steps = 2 * (LM_SEQS // LM_BATCH)
    loss_first, loss_last = records[0]["loss"], records[-1]["loss"]
    summary = {"steps": steps, "batch": LM_BATCH, "seq_len": LM_SEQ,
               "tokens_per_s": max(r["throughput"] for r in timed) * LM_SEQ,
               "ms_per_step": 1e3 * wall / steps, "wall_s": wall,
               "warmup_s": warm,
               "losses": [r["loss"] for r in records],
               "launches": launches, "ce_routes": ce_routes}
    print(f"lm: {steps} steps of {LM_BATCH}x{LM_SEQ} tokens in {wall:.3f}s "
          f"= {summary['tokens_per_s']:.1f} tokens/s (best epoch), "
          f"{summary['ms_per_step']:.1f} ms/step (warm-up {warm:.1f}s); "
          f"loss {loss_first:.4f} -> {loss_last:.4f}; launches "
          f"{json.dumps(launches)}; CE kernels by route "
          f"{json.dumps(ce_routes)}")
    check(math.isfinite(loss_last) and loss_last < 0.98 * loss_first,
          f"loss gate: {loss_first} -> {loss_last}")
    n_block = LM_CFG["n_block"]
    for name, count in launches.items():
        want = steps * (n_block if name.startswith("flash") else 1)
        check(count == want, f"{name}: {count} launches, want {want}")
    for name, routes in ce_routes.items():
        check(routes["wgmma"] == steps, f"{name} on the wgmma route "
              f"{routes}, want all {steps}")

    # one step's gradients and peak memory: the fused route against the
    # full-logits oracle on the same batch and weights
    loss_fn = model._loop.loss
    spec = resolve_fused_loss(model, loss_fn)
    check(spec is not None, "the fused loss did not resolve")
    xb = _to_device(x[:LM_BATCH], torch.device("cuda"))
    yb = _to_device(y[:LM_BATCH], torch.device("cuda"))
    grads, peaks, losses = {}, {}, {}
    for route in ("fused", "oracle"):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        gen = step_generator(0, 0)
        if route == "fused":
            loss = spec.apply_and_loss(model, xb, yb, generator=gen)
        else:
            loss = loss_fn(yb, model(xb, training=True, generator=gen))
        loss.backward()
        torch.cuda.synchronize()
        peaks[route] = torch.cuda.max_memory_allocated() - base
        losses[route] = loss.item()
        del loss
        grads[route] = {n: p.grad.detach().clone()
                        for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    rel = {n: ((grads["fused"][n] - grads["oracle"][n]).norm()
               / grads["oracle"][n].norm().clamp_min(1e-30)).item()
           for n in grads["fused"]}
    worst = max(rel, key=rel.get)
    saved = peaks["oracle"] - peaks["fused"]
    logits_bytes = LM_BATCH * LM_SEQ * LM_VOCAB * 2
    summary.update(grad_rel_err_max=rel[worst], grad_rel_err_leaf=worst,
                   step_losses=losses, peak_step_bytes=peaks,
                   peak_saved_bytes=saved)
    print(f"lm: fused vs oracle, one step: losses {losses['fused']:.6f} / "
          f"{losses['oracle']:.6f}; largest per-leaf gradient relative "
          f"error {rel[worst]:.3e} ({worst}; tolerance {LM_GRAD_REL_TOL}); "
          f"peak memory over the step {peaks['fused'] / 1e9:.3f} GB fused, "
          f"{peaks['oracle'] / 1e9:.3f} GB oracle ({saved / 1e9:.3f} GB "
          f"saved, at least {logits_bytes / 1e9:.3f} GB required)")
    check(rel[worst] <= LM_GRAD_REL_TOL, f"fused vs oracle gradients: "
          f"{worst} {rel[worst]}")
    check(saved >= logits_bytes, f"fused peak only {saved} bytes under the "
          f"oracle's")
    del grads
    return summary, y[:LM_BATCH]


def lm_kernel_rows(labels_np, launches, launches_by_route):
    """K4, K5a and K5b at the LM path's shape (N=65,536, H=512, V=8192,
    bf16, a bias, the run's labels), and the attention kernels at the LM's
    causal B=16, H=8, T=4096, D=64 (time, launches on the LM path and
    bound): ``(ce_rows, flash_lm)``."""
    import torch

    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import (
        bwd_dkv, bwd_dq, flash_attention)
    g = torch.Generator().manual_seed(3)
    rows = ce_rows_at(LM_BATCH * LM_SEQ, labels_np, g, launches,
                      launches_by_route)

    q, k, vv, do = (torch.randn(LM_BATCH, LM_CFG["n_head"], LM_SEQ, 64,
                                generator=g).to("cuda", torch.bfloat16)
                    for _ in range(4))
    out, lse = flash_attention(q, k, vv, causal=True, want_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    errors_lm = lm_attention_errors(q, k, vv, do, out, lse, delta)
    bounds_lm = causal_attention_bounds(q, k)
    flash_lm = {
        "flash_attention_fwd": time_ms(lambda: flash_attention(
            q, k, vv, causal=True, want_lse=True), iters=5, warmup=1),
        "flash_attention_bwd_dq": time_ms(lambda: bwd_dq(
            q, k, vv, None, lse, delta, do, True), iters=5, warmup=1),
        "flash_attention_bwd_dkv": time_ms(lambda: bwd_dkv(
            q, k, vv, None, lse, delta, do, True), iters=5, warmup=1),
    }
    # yardsticks only: SDPA forward and backward (dq, dk, dv in one call),
    # causal, at this shape
    sdpa_lm = lm_sdpa_ms(q, k, vv, do)
    print(f"lm attention SDPA yardsticks, causal bf16: {json.dumps(sdpa_lm)}")
    return rows, {name: {"launches_lm": launches[name], "ms_lm": ms,
                         "max_abs_err_lm": errors_lm[name],
                         "bound_ms_lm": bounds_lm[name][0],
                         "bound_by_lm": bounds_lm[name][1],
                         "library_ms_lm": sdpa_lm[
                             "fwd" if name == "flash_attention_fwd"
                             else "bwd"]}
                  for name, ms in flash_lm.items()}


def causal_attention_bounds(q, k):
    """K2's, K3a's and K3b's bounds on causal, unmasked inputs, with the
    operation and byte counts of ``main_path_kernel_rows``."""
    return {
        "flash_attention_fwd": attention_bound(q, k, None, True,
                                               n_row_f32=1),
        "flash_attention_bwd_dq": attention_bound(q, k, None, True, 6,
                                                  n_q_sized=3, n_kv_sized=2,
                                                  n_row_f32=2),
        "flash_attention_bwd_dkv": attention_bound(q, k, None, True, 8,
                                                   n_q_sized=2,
                                                   n_kv_sized=4,
                                                   n_row_f32=2),
    }


def ce_rows_at(n, labels_np, g, launches, launches_by_route,
               tag="LM shape"):
    """K4, K5a and K5b at ``n`` rows of the LM head (H=512, V=8192, bf16
    h and W, an f32 bias, ``labels_np``), inputs drawn from ``g``: each
    checked against its plain version and for its wgmma route, timed
    beside the plain version, the cuBLAS products and its bound; the
    kernels line's rows, with ``launches``; ``tag`` names the shape in
    the checks."""
    import torch

    from analytics_zoo_tpu_torch.ops.pallas.cross_entropy import (
        LAST_DH_LAUNCH, LAST_DW_LAUNCH, LAST_FWD_LAUNCH, fused_ce_backward_dh,
        fused_ce_backward_dw, fused_ce_backward_reference, fused_ce_forward,
        fused_ce_forward_reference)
    hidden, v = LM_CFG["hidden_size"], LM_VOCAB
    h = torch.randn(n, hidden, generator=g).to("cuda", torch.bfloat16)
    w = (torch.randn(hidden, v, generator=g) * hidden ** -0.5).to(
        "cuda", torch.bfloat16)
    b = (torch.randn(v, generator=g) * 0.1).cuda()
    labels = torch.from_numpy(labels_np.reshape(-1)).cuda()
    scale = torch.full((n,), 1.0 / n, device="cuda")
    lse, ll = fused_ce_forward(h, w, b, labels)
    dh = fused_ce_backward_dh(h, w, b, labels, lse, scale)
    dw, db = fused_ce_backward_dw(h, w, b, labels, lse, scale)
    torch.cuda.synchronize()
    routes = {"fused_ce_fwd": LAST_FWD_LAUNCH.route,
              "fused_ce_bwd_dh": LAST_DH_LAUNCH.route,
              "fused_ce_bwd_dw": LAST_DW_LAUNCH.route}
    for name, route in routes.items():
        check(route == "wgmma", f"{tag}: {name} took {route}")
    ref_lse, ref_ll = fused_ce_forward_reference(h, w, b, labels)
    ref_dh, ref_dw, ref_db = fused_ce_backward_reference(h, w, b, labels,
                                                         lse, scale)

    def err(a, c):
        return (a.float() - c.float()).abs().max().item()

    tol = CE_TOL["bfloat16"]
    lse_err = err(lse, ref_lse)
    ll_rel = ((ll - ref_ll).abs() / ref_ll.abs().clamp_min(1.0)).max().item()
    errors = {"fused_ce_fwd": max(lse_err, err(ll, ref_ll)),
              "fused_ce_bwd_dh": err(dh, ref_dh),
              "fused_ce_bwd_dw": max(err(dw, ref_dw), err(db, ref_db))}
    check(lse_err <= tol["lse"], f"{tag}: K4 lse {lse_err}")
    check(ll_rel <= tol["ll_rel"], f"{tag}: K4 label logit {ll_rel}")
    del ref_lse, ref_ll
    for name, ref in (("fused_ce_bwd_dh", ref_dh), ("fused_ce_bwd_dw",
                                                    ref_dw)):
        top = ref.float().abs().max().item()
        check(errors[name] <= tol["grad"] * top, f"{tag}: {name} "
              f"{errors[name]} > {tol['grad']} x {top}")
    del ref_dh, ref_dw, ref_db

    dl = torch.randn(n, v, device="cuda", dtype=torch.bfloat16)
    plain_bwd_ms = time_ms(lambda: fused_ce_backward_reference(
        h, w, b, labels, lse, scale), iters=5, warmup=1)
    flops_fwd = 2.0 * n * hidden * v
    bytes_in = n * hidden * 2 + hidden * v * 2 + v * 4 + n * 4
    timings = {
        "fused_ce_fwd": (
            time_ms(lambda: fused_ce_forward(h, w, b, labels)),
            time_ms(lambda: fused_ce_forward_reference(h, w, b, labels),
                    iters=5, warmup=1),
            time_ms(lambda: torch.matmul(h, w)),
            flops_fwd, bytes_in + 2 * n * 4),
        "fused_ce_bwd_dh": (
            time_ms(lambda: fused_ce_backward_dh(h, w, b, labels, lse,
                                                 scale)),
            plain_bwd_ms,
            time_ms(lambda: (torch.matmul(h, w), torch.matmul(dl, w.T))),
            2 * flops_fwd, bytes_in + 2 * n * 4 + n * hidden * 2),
        "fused_ce_bwd_dw": (
            time_ms(lambda: fused_ce_backward_dw(h, w, b, labels, lse,
                                                 scale)),
            plain_bwd_ms,
            time_ms(lambda: (torch.matmul(h, w), torch.matmul(h.T, dl))),
            2 * flops_fwd, bytes_in + 2 * n * 4 + hidden * v * 4 + v * 4),
    }
    del dl
    src = "analytics_zoo_tpu_torch/csrc/fused_cross_entropy.cu"
    replaces = {"fused_ce_fwd": "analytics_zoo_tpu/ops/pallas/"
                                "cross_entropy.py:325",
                "fused_ce_bwd_dh": "analytics_zoo_tpu/ops/pallas/"
                                   "cross_entropy.py:496",
                "fused_ce_bwd_dw": "analytics_zoo_tpu/ops/pallas/"
                                   "cross_entropy.py:525"}
    rows = []
    for name, (ms, plain_ms, lib_ms, flops, nbytes) in timings.items():
        t_ops = flops / PEAK_FLOPS["bfloat16"]
        t_bytes = nbytes / PEAK_BYTES_PER_S
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces[name],
                     "launches": launches[name],
                     "max_abs_err": errors[name], "ms": ms,
                     "plain_ms": plain_ms,
                     "bound_ms": max(t_ops, t_bytes) * 1e3,
                     "bound_by": ("operations" if t_ops >= t_bytes
                                  else "bytes"),
                     "library_ms": lib_ms,
                     "library_by": "cuBLAS products, no softmax"})
        if name != "fused_ce_fwd":
            rows[-1]["plain_by"] = ("the plain backward computes dh, dW "
                                    "and db together: the pair's time")
        rows[-1]["kernel_route"] = routes[name]
        rows[-1]["launches_by_route"] = launches_by_route[name]
    return rows


def fused_ce_speedup():
    """The JAX bench's ``fused_ce_speedup`` yardstick (``bench.py:254-325``):
    one forward and backward (gradients of h, W and b) of the fused LM-head
    loss against the full-logits objective as ``Dense`` +
    ``scce_with_logits`` run it, at T = 32,768 rows, V = 8192, H = 512, bf16
    h, f32 W and b, the inputs made as that function makes them (numpy seed
    11); tokens/s best of three each, and their ratio. Printed, not gated
    (the JAX bench floors it at 1.0, ``bench.py:1528``)."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.ops.fused_cross_entropy import \
        fused_sparse_cross_entropy
    from analytics_zoo_tpu_torch.pipeline.api.keras import objectives
    t, v, h_dim = 32768, 8192, 512
    rng = np.random.default_rng(11)
    h = torch.from_numpy(rng.normal(size=(t, h_dim)).astype(np.float32)).to(
        "cuda", torch.bfloat16).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(h_dim, v)).astype(np.float32)
                         * 0.02).cuda().requires_grad_()
    b = torch.zeros(v, device="cuda", requires_grad=True)
    y = torch.from_numpy(rng.integers(0, v, t).astype(np.int32)).cuda()

    def full_loss():
        logits = torch.matmul(h, w.to(h.dtype)) + b.to(h.dtype)
        return objectives.sparse_categorical_crossentropy_from_logits(
            y, logits)

    def fused_loss():
        return fused_sparse_cross_entropy(y, h, w, b)

    rates = {}
    for tag, fn in (("fullvocab", full_loss), ("fused", fused_loss)):
        torch.autograd.grad(fn(), (h, w, b))        # warm-up
        torch.cuda.synchronize()
        best = 0.0
        for _ in range(3):
            t0 = time.perf_counter()
            torch.autograd.grad(fn(), (h, w, b))
            torch.cuda.synchronize()
            best = max(best, t / (time.perf_counter() - t0))
        rates[tag] = best
    out = {f"{tag}_ce_tokens_per_sec": rate for tag, rate in rates.items()}
    out["fused_ce_speedup"] = rates["fused"] / rates["fullvocab"]
    print(f"fused ce speedup (T={t}, V={v}, H={h_dim}, bf16 h; the JAX "
          f"bench's yardstick, floored there at 1.0): {json.dumps(out)}")
    return out


def lm_sdpa_ms(q, k, v, do):
    """``scaled_dot_product_attention(is_causal=True)`` at the LM shape: the
    forward's time, and the backward's (one call computes dq, dk and dv:
    the K3a + K3b pair's yardstick). Timed here only; the port never calls
    it."""
    import torch
    import torch.nn.functional as F
    fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                         is_causal=True),
                  iters=5, warmup=1)
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    bwd = time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                              retain_graph=True),
                  iters=5, warmup=1)
    return {"fwd": fwd, "bwd": bwd}


def lm_attention_errors(q, k, v, do, out, lse, delta):
    """K2, K3a and K3b against their plain versions at the LM shape
    (causal, no mask, bf16), with the tolerances of the BERT-shape phases:
    K2's output 2e-2 absolute and its lse 1e-3, the gradients 2e-2 of the
    largest, and the same gradient bits on a second run. The plain versions form the f32 score matrix, 8.6 GB at this
    shape, so they run one batch row at a time. Returns each kernel's
    largest absolute error."""
    import torch

    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import (
        bwd_dkv, bwd_dkv_reference, bwd_dq, bwd_dq_reference,
        flash_attention_reference)
    dq = bwd_dq(q, k, v, None, lse, delta, do, True)
    dk, dv = bwd_dkv(q, k, v, None, lse, delta, do, True)
    again = (bwd_dq(q, k, v, None, lse, delta, do, True),
             *bwd_dkv(q, k, v, None, lse, delta, do, True))
    torch.cuda.synchronize()
    for key, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), again):
        check(same_bits(a, b), f"LM shape: {key} not the same bits on a "
              f"second run")
    del again
    got = {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
    err = dict.fromkeys(got, 0.0)
    top = dict.fromkeys(got, 0.0)
    for i in range(q.shape[0]):
        sl = slice(i, i + 1)
        args = (q[sl], k[sl], v[sl], None, lse[sl], delta[sl], do[sl], True)
        ref = dict(zip(("out", "lse"), flash_attention_reference(
            q[sl], k[sl], v[sl], None, True, want_lse=True)))
        ref["dq"] = bwd_dq_reference(*args)
        ref["dk"], ref["dv"] = bwd_dkv_reference(*args)
        for key, want in ref.items():
            err[key] = max(err[key], (got[key][sl].float() - want.float()
                                      ).abs().max().item())
            top[key] = max(top[key], want.float().abs().max().item())
        del ref
    print(f"lm attention kernels vs plain, B={q.shape[0]} H={q.shape[1]} "
          f"T={q.shape[2]} D={q.shape[3]} causal bf16: "
          f"{json.dumps({'max_abs_err': err, 'max_abs': top})}")
    check(err["out"] <= 2e-2, f"LM shape: K2 vs plain {err['out']}")
    check(err["lse"] <= 1e-3, f"LM shape: K2 lse {err['lse']}")
    for key in ("dq", "dk", "dv"):
        check(bool(torch.isfinite(got[key]).all()), f"LM shape: {key} not "
              f"finite")
        check(err[key] <= 2e-2 * top[key], f"LM shape: {key} vs plain "
              f"{err[key]} > 2e-2 x {top[key]}")
    return {"flash_attention_fwd": max(err["out"], err["lse"]),
            "flash_attention_bwd_dq": err["dq"],
            "flash_attention_bwd_dkv": max(err["dk"], err["dv"])}


def lm_counters():
    """The LM path's kernels' launch counters by the kernels line's names,
    and the CE kernels' counters by route."""
    from analytics_zoo_tpu_torch.ops.pallas.cross_entropy import (
        KERNEL_CE_BWD_DH, KERNEL_CE_BWD_DH_ROUTES, KERNEL_CE_BWD_DW,
        KERNEL_CE_BWD_DW_ROUTES, KERNEL_CE_FWD, KERNEL_CE_FWD_ROUTES)
    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import (
        KERNEL, KERNEL_BWD_DKV, KERNEL_BWD_DQ)
    kernels = dict(zip(LM_KERNELS, (KERNEL_CE_FWD, KERNEL_CE_BWD_DH,
                                    KERNEL_CE_BWD_DW, KERNEL, KERNEL_BWD_DQ,
                                    KERNEL_BWD_DKV)))
    routes = {"fused_ce_fwd": KERNEL_CE_FWD_ROUTES,
              "fused_ce_bwd_dh": KERNEL_CE_BWD_DH_ROUTES,
              "fused_ce_bwd_dw": KERNEL_CE_BWD_DW_ROUTES}
    return kernels, routes


def lm_counts():
    """``(launches, launches by CE route)`` as the counters read now."""
    kernels, routes = lm_counters()
    return ({n: c.launches for n, c in kernels.items()},
            {n: {k: c.launches for k, c in r.items()}
             for n, r in routes.items()})


def reset_lm_counts():
    kernels, routes = lm_counters()
    for c in list(kernels.values()) + [c for r in routes.values()
                                       for c in r.values()]:
        c.reset()


def count_diff(after, before):
    """``after - before`` of two (nested) launch-count dicts."""
    return {k: (count_diff(v, before[k]) if isinstance(v, dict)
                else v - before[k]) for k, v in after.items()}


def long_context_32k_fit(mode, x, y, scan_steps=1, twice=False):
    """One ``zoo.train.remat`` mode of the 32k configuration, from the
    weights every mode starts from (``zoo.seed`` 0), every other flag at
    auto: the first step's loss and gradients through the loop's own step
    (``TrainingLoop._grads``, where remat applies; run twice when
    ``twice``, to see which leaves come out the same bits run to run),
    its launches and peak memory (the gradients then held on the host),
    then the bench's two fits of two epochs (warm-up, timed; peak memory
    over both and above what is allocated at their start, and, eager, the
    same allocation after each) and one more epoch
    under ``torch.profiler`` for the busy share. The launch counters are
    zeroed at the start; the summary's ``launches`` are the whole mode's.
    Returns ``(summary, first)``, ``first`` the step's ``(loss, grads)``
    runs."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Dense, TransformerLayer)
    from analytics_zoo_tpu_torch.pipeline.api.keras.training import \
        _to_device
    tag = f"32k remat={mode}" + (f" scan_steps={scan_steps}"
                                 if scan_steps > 1 else "")
    init_zoo_context(conf={"zoo.compute.dtype": "bfloat16", "zoo.seed": 0,
                           "zoo.pallas.attention": "auto",
                           "zoo.pallas.cross_entropy": "auto",
                           "zoo.train.fused_ce": "auto",
                           "zoo.train.remat": mode,
                           "zoo.train.scan_steps": scan_steps})
    reset_lm_counts()
    # the previous mode's model and loop (which hold each other) and its
    # optimizer state go before this mode's fits are measured
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    model = Sequential([TransformerLayer(**LC_CFG, input_shape=(LC_SEQ,)),
                        Dense(LM_VOCAB)]).init_weights()
    model.compile(optimizer="adam", loss="scce_with_logits", lr=3e-4)
    loop = model._loop
    dev = torch.device("cuda")
    xb, yb = _to_device(x[:LC_BATCH], dev), _to_device(y[:LC_BATCH], dev)
    params = loop._params()
    first = []
    for _ in range(2 if twice else 1):
        before = lm_counts()[0]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, grads = loop._grads(xb, yb, loop._noise(0, 0, dev), params)
        torch.cuda.synchronize()
        step_peak = torch.cuda.max_memory_allocated() - base
        step_launches = count_diff(lm_counts()[0], before)
        # held for the comparison off the card, out of the fits' memory
        first.append((loss.cpu(), {n: g.cpu() for n, g in grads.items()}))
        del loss, grads
    remat = loop.remat_mode is not None
    want_step = {n: ((LC_CFG["n_block"] if n.startswith("flash") else 1)
                     * (2 if remat and n in ("fused_ce_fwd",
                                             "flash_attention_fwd") else 1))
                 for n in LM_KERNELS}
    check(step_launches == want_step, f"{tag}: one step's launches "
          f"{step_launches}, want {want_step}")

    torch.cuda.synchronize()
    fit_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    records, losses = [], []
    t0 = time.perf_counter()
    model.fit(x, y, batch_size=LC_BATCH, nb_epoch=2,
              callbacks=[records.append])                 # warm-up
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    after_fits = [torch.cuda.memory_allocated()]
    losses += [float(v) for e in loop.step_losses for v in e]
    before = lm_counts()
    timed = []
    t0 = time.perf_counter()
    model.fit(x, y, batch_size=LC_BATCH, nb_epoch=2,
              callbacks=[timed.append])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses += [float(v) for e in loop.step_losses for v in e]
    fit_peak = torch.cuda.max_memory_allocated()
    after_fits.append(torch.cuda.memory_allocated())
    steps = 2 * (LC_SEQS // LC_BATCH)
    fit_launches, fit_routes = (count_diff(a, b) for a, b in
                                zip(lm_counts(), before))
    busy, kernel_ms = profiled_busy_share(lambda: model.fit(
        x, y, batch_size=LC_BATCH, nb_epoch=1))
    launches, ce_routes = lm_counts()
    records += timed
    tokens_per_s = max(r["throughput"] for r in timed) * LC_SEQ
    hidden, n_block = LC_CFG["hidden_size"], LC_CFG["n_block"]
    # bench.py:457-460: 3 x the forward's flops a token, the causal
    # attention half of 4 T H
    fwd_per_tok = (n_block * (24 * hidden * hidden
                              + 4 * LC_SEQ * hidden * 0.5)
                   + 2 * hidden * LM_VOCAB)
    loss_first, loss_last = records[0]["loss"], records[-1]["loss"]
    summary = {"remat": mode, "scan_steps": scan_steps, "steps": steps,
               "tokens_per_s": tokens_per_s,
               "ms_per_step": 1e3 * wall / steps, "wall_s": wall,
               "warmup_s": warm,
               "mfu": 3.0 * fwd_per_tok * tokens_per_s
               / PEAK_FLOPS["bfloat16"],
               "peak_step_bytes": step_peak, "peak_fit_bytes": fit_peak,
               "fit_start_bytes": fit_start,
               "allocated_after_fits_bytes": after_fits,
               "busy_share": busy, "profiled_kernel_ms": kernel_ms,
               "launches_per_step": {n: c / steps
                                     for n, c in fit_launches.items()},
               "ce_routes": ce_routes, "launches": launches,
               "epoch_losses": [r["loss"] for r in records],
               "step_losses": losses}
    print(f"{tag}: {steps} steps of {LC_BATCH}x{LC_SEQ} tokens in "
          f"{wall:.3f}s = {tokens_per_s:.1f} tokens/s (best epoch), "
          f"{summary['ms_per_step']:.1f} ms/step, MFU "
          f"{summary['mfu']:.4f} (warm-up {warm:.1f}s); peak memory "
          f"{step_peak / 1e9:.3f} GB over one step, {fit_peak / 1e9:.3f} "
          f"GB over the fits ({(fit_peak - fit_start) / 1e9:.3f} GB above "
          f"the {fit_start / 1e9:.3f} GB allocated at their start; "
          f"allocated after each fit {after_fits[0] / 1e9:.4f} / "
          f"{after_fits[1] / 1e9:.4f} GB); busy {busy}; loss "
          f"{loss_first:.4f} -> "
          f"{loss_last:.4f}; launches a step "
          f"{json.dumps(summary['launches_per_step'])}; CE kernels by route "
          f"{json.dumps(fit_routes)}")
    check(math.isfinite(loss_last) and loss_last < 0.98 * loss_first,
          f"{tag}: loss gate {loss_first} -> {loss_last}")
    # eager steps leave nothing behind (a captured fit may capture anew)
    check(scan_steps > 1 or after_fits[0] == after_fits[1],
          f"{tag}: allocated after the warm-up fit {after_fits[0]} vs "
          f"after the timed fit {after_fits[1]}")
    check(fit_launches == {n: c * steps for n, c in want_step.items()},
          f"{tag}: {fit_launches} launches over {steps} steps, want "
          f"{want_step} a step")
    for name, r in fit_routes.items():
        check(r["wgmma"] == fit_launches[name], f"{tag}: {name} on the "
              f"wgmma route {r}, want all {fit_launches[name]}")
    check(np.all(np.isfinite(losses)), f"{tag}: step losses {losses}")
    return summary, first


def long_context_attention_rows():
    """K2, K3a and K3b at the 32k path's shape (B=1, H=8, T=32768, D=64,
    causal, bf16). The plain versions form the f32 score matrix, 34 GB at
    this shape, so they run on a cut: K2's output and lse and K3a's dq on
    the last ``LC_CUT_ROWS`` query rows against every key, K3b's dk and dv
    for one head at full length; tolerances as ``lm_attention_errors``
    but for the output, held to 2e-2 of the reference's largest value as
    the gradients are (each of these rows averages some 30k keys, so
    |out| is near sqrt(e / T), far under the 4k shape's absolute 2e-2),
    and the same gradient bits on a second run. Each kernel timed beside
    SDPA's causal forward and backward and its bound. Returns the rows'
    ``*_32k`` fields by kernel name."""
    import torch

    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import (
        bwd_dkv, bwd_dkv_reference, bwd_dq, bwd_dq_reference,
        flash_attention, flash_attention_reference)
    g = torch.Generator().manual_seed(11)
    shape = (LC_BATCH, LC_CFG["n_head"], LC_SEQ, 64)
    q, k, v, do = (torch.randn(*shape, generator=g).to("cuda", torch.bfloat16)
                   for _ in range(4))
    out, lse = flash_attention(q, k, v, causal=True, want_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    dq = bwd_dq(q, k, v, None, lse, delta, do, True)
    dk, dv = bwd_dkv(q, k, v, None, lse, delta, do, True)
    again = (bwd_dq(q, k, v, None, lse, delta, do, True),
             *bwd_dkv(q, k, v, None, lse, delta, do, True))
    torch.cuda.synchronize()
    for key, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), again):
        check(same_bits(a, b), f"32k: {key} not the same bits on a second "
              f"run")
    del again
    rows = slice(LC_SEQ - LC_CUT_ROWS, LC_SEQ)
    want = dict(zip(("out", "lse"), flash_attention_reference(
        q[:, :, rows], k, v, None, True, want_lse=True)))
    want["dq"] = bwd_dq_reference(q[:, :, rows], k, v, None,
                                  lse[:, :, rows], delta[:, :, rows],
                                  do[:, :, rows], True)
    got = {"out": out[:, :, rows], "lse": lse[:, :, rows],
           "dq": dq[:, :, rows]}
    head = slice(0, 1)
    want["dk"], want["dv"] = bwd_dkv_reference(
        q[:, head], k[:, head], v[:, head], None, lse[:, head],
        delta[:, head], do[:, head], True)
    got["dk"], got["dv"] = dk[:, head], dv[:, head]
    err = {key: (got[key].float() - w.float()).abs().max().item()
           for key, w in want.items()}
    top = {key: w.float().abs().max().item() for key, w in want.items()}
    del want
    torch.cuda.empty_cache()
    print(f"32k attention kernels vs plain, B={shape[0]} H={shape[1]} "
          f"T={shape[2]} D={shape[3]} causal bf16 (out, lse, dq: the last "
          f"{LC_CUT_ROWS} rows; dk, dv: head 0 at full length): "
          f"{json.dumps({'max_abs_err': err, 'max_abs': top})}")
    check(err["out"] <= 2e-2 * top["out"], f"32k: K2 vs plain "
          f"{err['out']} > 2e-2 x {top['out']}")
    check(err["lse"] <= 1e-3, f"32k: K2 lse {err['lse']}")
    for key in ("dq", "dk", "dv"):
        check(bool(torch.isfinite(got[key]).all()), f"32k: {key} not "
              f"finite")
        check(err[key] <= 2e-2 * top[key], f"32k: {key} vs plain "
              f"{err[key]} > 2e-2 x {top[key]}")
    errors = {"flash_attention_fwd": max(err["out"], err["lse"]),
              "flash_attention_bwd_dq": err["dq"],
              "flash_attention_bwd_dkv": max(err["dk"], err["dv"])}
    del got, dq, dk, dv
    bounds = causal_attention_bounds(q, k)
    ms = {
        "flash_attention_fwd": time_ms(lambda: flash_attention(
            q, k, v, causal=True, want_lse=True), iters=5, warmup=1),
        "flash_attention_bwd_dq": time_ms(lambda: bwd_dq(
            q, k, v, None, lse, delta, do, True), iters=5, warmup=1),
        "flash_attention_bwd_dkv": time_ms(lambda: bwd_dkv(
            q, k, v, None, lse, delta, do, True), iters=5, warmup=1),
    }
    sdpa = lm_sdpa_ms(q, k, v, do)
    print(f"32k attention kernels ms {json.dumps(ms)}, bounds "
          f"{json.dumps(bounds)}, SDPA causal {json.dumps(sdpa)}")
    return {name: {"ms_32k": ms[name], "max_abs_err_32k": errors[name],
                   "bound_ms_32k": bounds[name][0],
                   "bound_by_32k": bounds[name][1],
                   "library_ms_32k": sdpa[
                       "fwd" if name == "flash_attention_fwd" else "bwd"]}
            for name in ms}


def long_context_32k_phase():
    """The JAX bench's 32k long-context configuration, uncut, in each
    ``zoo.train.remat`` mode (``LC_REMAT``) and once more under
    ``zoo.train.scan_steps`` 2 with ``full``. Gates: each fit's loss drop
    (``bench.py:448-453``), the launches a step (K2 and K4 twice under
    remat: the recompute), the wgmma CE routes, each remat mode's first
    step against ``false``'s (the loss's bits; every gradient leaf that
    comes out the same bits twice under ``false`` bit for bit, any other
    at ``LM_GRAD_REL_TOL``), the captured fit's step losses against the
    eager ``full`` fit's (bits, else 1e-6 relative), and K2, K3a, K3b, K4,
    K5a and K5b at the 32k shapes against their plain versions. Returns
    the summary, the attention rows' and the CE rows' 32k fields, and the
    path's launches (``long_context_32k``: the ``false`` mode's;
    ``remat``: the rest)."""
    import torch
    x, y = lm_data(LC_SEQS, LC_SEQ)
    runs, firsts = {}, {}
    for mode in LC_REMAT:
        runs[mode], firsts[mode] = long_context_32k_fit(
            mode, x, y, twice=mode == LC_REMAT[0])
    (ref_loss, ref), (_, again) = firsts[LC_REMAT[0]]
    steady = sorted(n for n in ref if same_bits(ref[n], again[n]))
    print(f"32k remat={LC_REMAT[0]}: {len(steady)} of {len(ref)} gradient "
          f"leaves the same bits on a second step; the others "
          f"{sorted(set(ref) - set(steady))}")
    del again
    agreement = {}
    for mode in LC_REMAT[1:]:
        loss, grads = firsts[mode][0]
        bits = [n for n in ref if same_bits(grads[n], ref[n])]
        rel = {n: ((grads[n].float() - ref[n].float()).norm()
                   / ref[n].float().norm().clamp_min(1e-30)).item()
               for n in ref if n not in bits}
        worst = max(rel, key=rel.get) if rel else None
        agreement[mode] = {"loss_same_bits": same_bits(loss, ref_loss),
                           "leaves_same_bits": len(bits),
                           "leaves": len(ref),
                           "worst_rel_err": rel.get(worst, 0.0),
                           "worst_leaf": worst}
        print(f"32k remat={mode} vs {LC_REMAT[0]}, first step: loss "
              f"{loss.item():.6f} / {ref_loss.item():.6f} the same bits "
              f"{agreement[mode]['loss_same_bits']}; {len(bits)} of "
              f"{len(ref)} gradient leaves the same bits"
              + (f", the others' largest relative error {rel[worst]:.3e} "
                 f"({worst}; tolerance {LM_GRAD_REL_TOL})" if rel else ""))
        check(agreement[mode]["loss_same_bits"], f"32k remat={mode}: first "
              f"loss {loss.item()} vs {ref_loss.item()}")
        moved = [n for n in steady if n not in bits]
        check(not moved, f"32k remat={mode}: leaves that are the same bits "
              f"run to run differ from remat={LC_REMAT[0]}: {moved}")
        check(all(r <= LM_GRAD_REL_TOL for r in rel.values()),
              f"32k remat={mode}: {worst} {rel.get(worst)}")
    del firsts, ref
    captured, _ = long_context_32k_fit("full", x, y, scan_steps=2)
    same = bits_or_close("32k captured full vs eager full step losses",
                         captured["step_losses"],
                         runs["full"]["step_losses"], 1e-6, absolute=False)
    torch.cuda.empty_cache()
    attention = long_context_attention_rows()
    g = torch.Generator().manual_seed(13)
    ce = {r["name"]: r for r in ce_rows_at(
        LC_BATCH * LC_SEQ, y[:LC_BATCH], g, runs[LC_REMAT[0]]["launches"],
        runs[LC_REMAT[0]]["ce_routes"], tag="32k shape")}
    launches = {"long_context_32k": runs[LC_REMAT[0]]["launches"],
                "remat": {n: sum(r["launches"][n] for r in
                                 [runs[m] for m in LC_REMAT[1:]]
                                 + [captured])
                          for n in LM_KERNELS}}
    summary = {"runs": runs, "captured_full": captured,
               "captured_vs_eager": same, "first_step": agreement,
               "steady_leaves": len(steady)}
    return summary, attention, ce, launches


def ner_data(n):
    """``n`` NER rows: token ids drawn as the JAX BERT bench draws them
    (``bench.py:196-197``: numpy seed 3, ids in [1, 30000)), valid lengths
    uniform in 64..512 as the serving records', pad id 0 past them; each
    tag a function of its id (id mod 9), -1 past the row's length.
    Returns ``(ids, mask, tags)``."""
    import numpy as np
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 30000, (n, SEQ)).astype(np.int32)
    lens = rng.integers(64, SEQ + 1, n)
    pad = np.arange(SEQ)[None, :] >= lens[:, None]
    ids[pad] = 0
    tags = (ids % NER_CFG["num_entities"]).astype(np.int32)
    tags[pad] = -1
    return ids, (~pad).astype(np.float32), tags


def bert_ner_phase():
    """``BERTNER`` at BERT-base width (``NER_CFG``), bf16 compute, AdamW
    5e-5, batch 32: a warm-up epoch and a timed epoch of ``NER_STEPS``
    steps, then one more under ``torch.profiler`` for the busy share.
    Gates: the loss falls, 12 launches a step of K2, K3a and K3b, other
    ids past the valid lengths give the same loss bits, ``predict_tags``
    equals the argmax of ``predict``; then ``BERTSQuAD`` at the same width
    gives spans with end >= start for a batch. Returns the summary with
    the path's launches."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import (
        KERNEL, KERNEL_BWD_DKV, KERNEL_BWD_DQ)
    from analytics_zoo_tpu_torch.pipeline.api.keras.training import \
        _to_device
    from analytics_zoo_tpu_torch.tfpark import BERTNER, BERTSQuAD

    init_zoo_context(conf={"zoo.pallas.attention": True,
                           "zoo.compute.dtype": "bfloat16", "zoo.seed": 0})
    kernels = dict(zip(("flash_attention_fwd", "flash_attention_bwd_dq",
                        "flash_attention_bwd_dkv"),
                       (KERNEL, KERNEL_BWD_DQ, KERNEL_BWD_DKV)))
    for c in kernels.values():
        c.reset()

    def counts():
        return {n: c.launches for n, c in kernels.items()}

    t0 = time.perf_counter()
    model = BERTNER(**NER_CFG, device="cuda").init_weights()
    model.compile(optimizer="adamw", lr=5e-5)
    print(f"bert ner: built in {time.perf_counter() - t0:.1f}s "
          f"({json.dumps(model.get_config())}), bf16 compute, f32 params, "
          f"AdamW lr 5e-5, batch {T_BATCH}")
    ids, mask, tags = ner_data(NER_STEPS * T_BATCH)
    x = model.make_inputs(ids, attention_mask=mask)
    records = []
    t0 = time.perf_counter()
    model.fit(x, tags, batch_size=T_BATCH, nb_epoch=1,
              callbacks=[records.append])                 # warm-up
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    before = counts()
    t0 = time.perf_counter()
    model.fit(x, tags, batch_size=T_BATCH, nb_epoch=1,
              callbacks=[records.append])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_launches = {n: (c - before[n]) / NER_STEPS
                     for n, c in counts().items()}
    busy, kernel_ms = profiled_busy_share(lambda: model.fit(
        x, tags, batch_size=T_BATCH, nb_epoch=1))
    losses = [r["loss"] for r in records]
    summary = {"steps": NER_STEPS, "batch": T_BATCH,
               "samples_per_s": records[1]["throughput"],
               "ms_per_step": 1e3 * wall / NER_STEPS, "wall_s": wall,
               "warmup_epoch_s": warm, "epoch_losses": losses,
               "busy_share": busy, "profiled_kernel_ms": kernel_ms,
               "launches_per_step": step_launches}
    print(f"bert ner: {NER_STEPS} steps of {T_BATCH} in {wall:.3f}s = "
          f"{summary['samples_per_s']:.2f} samples/s, "
          f"{summary['ms_per_step']:.1f} ms/step (warm-up epoch "
          f"{warm:.1f}s); busy {busy}; epoch losses {losses}; launches a "
          f"step {json.dumps(step_launches)}")
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"bert ner: the loss did not fall {losses}")
    want = float(NER_CFG["n_block"])
    check(all(v == want for v in step_launches.values()),
          f"bert ner: launches a step {step_launches}, want {want} each")

    # other ids past the valid lengths: the same loss bits
    loop, dev = model._loop, torch.device("cuda")
    rng = np.random.default_rng(5)
    other = ids[:T_BATCH].copy()
    pad = mask[:T_BATCH] == 0
    other[pad] = rng.integers(1, 30000, int(pad.sum()))
    yb = _to_device(tags[:T_BATCH], dev)
    losses_pad = []
    for rows in (ids[:T_BATCH], other):
        xb = _to_device(model.make_inputs(rows,
                                          attention_mask=mask[:T_BATCH]), dev)
        with torch.no_grad():
            losses_pad.append(loop.loss(yb, model(
                xb, training=True, generator=loop._noise(0, 0, dev))))
    summary["padding_same_bits"] = same_bits(*losses_pad)
    print(f"bert ner: the first batch's loss {losses_pad[0].item():.6f}, "
          f"with other ids past the valid lengths {losses_pad[1].item():.6f}"
          f": the same bits {summary['padding_same_bits']}")
    check(summary["padding_same_bits"], "bert ner: padded positions moved "
          "the loss")
    xs = [a[:2 * T_BATCH] for a in x]
    logits = model.predict(xs, batch_size=T_BATCH)
    tags_pred = model.predict_tags(xs, batch_size=T_BATCH)
    check(tags_pred.shape == (2 * T_BATCH, SEQ)
          and np.array_equal(tags_pred, np.argmax(logits, axis=-1)),
          "bert ner: predict_tags is not the argmax of predict")
    del model, loop

    cfg = {k: v for k, v in NER_CFG.items() if k != "num_entities"}
    squad = BERTSQuAD(**cfg, device="cuda").init_weights()
    spans = squad.predict_spans([a[:T_BATCH] for a in x],
                                batch_size=T_BATCH)
    print(f"bert squad: predict_spans over {T_BATCH} rows, the first "
          f"{spans[:4].tolist()}")
    check(spans.shape == (T_BATCH, 2) and bool((spans[:, 1]
                                                >= spans[:, 0]).all()),
          f"bert squad: spans {spans.tolist()}")
    del squad
    summary["launches"] = counts()
    return summary


def knrm_corpus():
    """The KNRM phase's seeded corpus (numpy seed 17) over ``w0 ..
    w19999``: ``KNRM_QUERIES`` queries of ``KNRM_T1`` words, each with
    ``KNRM_CANDIDATES`` docs of ``KNRM_T2`` words, the first relevant (the
    query's first 2 words among its own) and the others not (0, 1 or 2
    of the query's next two words among theirs, uniformly). Returns
    ``(queries, docs, relations)``."""
    import numpy as np

    from analytics_zoo_tpu_torch.feature.text import Relation
    rng = np.random.default_rng(17)
    words = np.asarray([f"w{i}" for i in range(KNRM_VOCAB)])
    queries, docs, rels = {}, {}, []
    q_ids = rng.integers(0, KNRM_VOCAB, (KNRM_QUERIES, KNRM_T1))
    d_ids = rng.integers(0, KNRM_VOCAB,
                         (KNRM_QUERIES, KNRM_CANDIDATES, KNRM_T2))
    d_ids[:, 0, :2] = q_ids[:, :2]
    # the other docs share 0, 1 or 2 of the query's other words
    shares = rng.integers(0, 3, (KNRM_QUERIES, KNRM_CANDIDATES))
    for j in range(2):
        hit = (shares > j) & (np.arange(KNRM_CANDIDATES) > 0)
        d_ids[:, :, j] = np.where(hit, q_ids[:, 2 + j:3 + j],
                                  d_ids[:, :, j])
    for i in range(KNRM_QUERIES):
        queries[f"q{i}"] = " ".join(words[q_ids[i]])
        for c in range(KNRM_CANDIDATES):
            doc = rng.permutation(d_ids[i, c])
            docs[f"d{i}_{c}"] = " ".join(words[doc])
            rels.append(Relation(f"q{i}", f"d{i}_{c}", int(c == 0)))
    return queries, docs, rels


def knrm_phase():
    """KNRM trained through the text path: the seeded corpus
    (``knrm_corpus``) through ``TextSet`` (tokenize, one ``word2idx`` over
    both corpora, ``shape_sequence`` to 10 and 40), relation pairs
    (``generate_relation_pairs`` via ``relation_pairs_to_arrays``: rows
    alternate the relevant doc and another, as ``rank_hinge`` reads them),
    then ``KNRM`` at the JAX class's widths (embed 300, 21 kernels, sigma
    0.1, exact sigma 0.001) with Adam 1e-3 and ``rank_hinge``, batch 512,
    unshuffled, for ``KNRM_EPOCHS`` epochs on all queries but the first
    ``KNRM_EVAL_QUERIES``, whose lists give NDCG@3 and MAP. Gates: the loss falls, finite
    metrics in [0, 1], and no hand-written kernel launched (none lies on
    this path)."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.feature.text import (
        TextSet, generate_relation_pairs, relation_lists_to_groups,
        relation_pairs_to_arrays)
    from analytics_zoo_tpu_torch.models.textmatching import KNRM
    from analytics_zoo_tpu_torch.ops.launch_count import LaunchCount

    init_zoo_context(conf={"zoo.seed": 0})
    t0 = time.perf_counter()
    queries, docs, rels = knrm_corpus()
    c1 = TextSet.from_corpus(queries).tokenize()
    c2 = TextSet.from_corpus(docs).tokenize()
    both = TextSet(c1.features + c2.features).word2idx()
    c1.word_index = c2.word_index = both.get_word_index()
    c1.shape_sequence(KNRM_T1)
    c2.shape_sequence(KNRM_T2)
    # the first KNRM_EVAL_QUERIES queries are held out for the metrics
    held = KNRM_EVAL_QUERIES * KNRM_CANDIDATES
    pairs = generate_relation_pairs(rels[held:])
    x, y = relation_pairs_to_arrays(rels[held:], c1, c2)
    setup = time.perf_counter() - t0
    vocab = len(both.get_word_index())
    print(f"knrm: {len(queries)} queries, {len(docs)} docs, vocabulary "
          f"{vocab}, {len(pairs)} relation pairs -> x {x.shape} in "
          f"{setup:.1f}s (TextSet and relations)")
    before = [c.launches for c in LaunchCount.ALL]
    model = KNRM(KNRM_T1, KNRM_T2, vocab_size=vocab + 1, embed_size=300,
                 kernel_num=21, sigma=0.1, exact_sigma=0.001,
                 device="cuda").init_weights()
    model.compile(optimizer="adam", loss="rank_hinge", lr=1e-3)
    records = []
    t0 = time.perf_counter()
    model.fit(x, y, batch_size=KNRM_BATCH, nb_epoch=KNRM_EPOCHS,
              shuffle=False, callbacks=[records.append])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy, kernel_ms = profiled_busy_share(lambda: model.fit(
        x, y, batch_size=KNRM_BATCH, nb_epoch=1, shuffle=False))
    groups = relation_lists_to_groups(rels[:held], c1, c2)
    t0 = time.perf_counter()
    ndcg3 = model.evaluate_ndcg(groups, k=3)
    mean_ap = model.evaluate_map(groups)
    eval_s = time.perf_counter() - t0
    launched = sum(c.launches for c in LaunchCount.ALL) - sum(before)
    losses = [r["loss"] for r in records]
    summary = {"records_per_s": max(r["throughput"] for r in records),
               "epochs": KNRM_EPOCHS, "wall_s": wall, "setup_s": setup,
               "epoch_losses": losses, "ndcg_at_3": ndcg3, "map": mean_ap,
               "eval_s": eval_s, "busy_share": busy,
               "profiled_kernel_ms": kernel_ms, "vocab": vocab,
               "pairs": len(pairs), "kernel_launches": launched}
    print(f"knrm: {KNRM_EPOCHS} epochs in {wall:.3f}s, "
          f"{summary['records_per_s']:.1f} records/s (best epoch), busy "
          f"{busy}; epoch losses {losses}; NDCG@3 {ndcg3:.4f}, MAP "
          f"{mean_ap:.4f} over {len(groups)} queries ({eval_s:.1f}s); "
          f"no hand-written kernel lies on this path: {launched} launched")
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"knrm: the loss did not fall {losses}")
    check(0.0 <= ndcg3 <= 1.0 and 0.0 <= mean_ap <= 1.0,
          f"knrm: NDCG@3 {ndcg3}, MAP {mean_ap}")
    check(launched == 0, f"knrm: {launched} hand-written kernel launches")
    return summary


def fault_l_phase():
    """``fused_cross_entropy_rows`` on views the kernels do not take as
    they lie, a column slice of a wider hidden array and a tied head's
    transposed ``(V, H)`` embedding, at the CE phase's N=4100, H=512,
    V=8192 (f32 and bf16): one launch each of K4, K5a and K5b on dense
    copies, held to the plain route, the loss rows and the gradients of
    the wide array, the embedding and the bias (each in its caller's
    layout) at CE_TOL."""
    import torch

    from analytics_zoo_tpu_torch.ops.fused_cross_entropy import \
        fused_cross_entropy_rows
    from analytics_zoo_tpu_torch.ops.pallas.cross_entropy import (
        KERNEL_CE_BWD_DH, KERNEL_CE_BWD_DW, KERNEL_CE_FWD,
        fused_ce_forward_reference)
    n, hidden, v = 4100, 512, 8192
    out = {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        g = torch.Generator().manual_seed(11)
        wide = torch.randn(n, hidden + 64, generator=g).to("cuda", dtype)
        emb = (torch.randn(v, hidden, generator=g)
               * hidden ** -0.5).to("cuda", dtype)
        b = (torch.randn(v, generator=g) * 0.5).cuda()
        labels = torch.randint(0, v, (n,), generator=g, dtype=torch.int32)
        labels[::3] = -1
        labels = labels.cuda()

        def run(use_pallas):
            ts = [t.detach().clone().requires_grad_()
                  for t in (wide, emb, b)]
            rows = fused_cross_entropy_rows(ts[0][:, 32:32 + hidden],
                                            ts[1].T, ts[2], labels,
                                            use_pallas=use_pallas)
            grads = torch.autograd.grad(rows.sum(), ts)
            check(all(gr.shape == t.shape and gr.dtype == t.dtype
                      for t, gr in zip(ts, grads)),
                  "fault l: a gradient left its caller's layout")
            return rows.detach(), grads
        counters = (KERNEL_CE_FWD, KERNEL_CE_BWD_DH, KERNEL_CE_BWD_DW)
        before = [c.launches for c in counters]
        got, g_got = run(True)
        torch.cuda.synchronize()
        launched = [c.launches - n0 for c, n0 in zip(counters, before)]
        want, g_want = run(False)
        _, ll = fused_ce_forward_reference(
            wide[:, 32:32 + hidden].contiguous(), emb.T.contiguous(), b,
            labels)
        tol = CE_TOL[name]
        err = (got - want).abs().max().item()
        bound = tol["lse"] + tol["ll_rel"] * ll.abs().max().item()
        g_err = [((a.float() - c.float()).abs().max()
                  / c.float().abs().max()).item()
                 for a, c in zip(g_got, g_want)]
        out[name] = {"loss_err": err, "loss_tol": bound,
                     "grad_rel_err": g_err, "launches": launched}
        print(f"fault l ({name}): hidden[:, 32:544] and emb.T through the "
              f"kernels vs the plain route: loss rows {err:.3e} (tol "
              f"{bound:.3e}), gradients of the wide array, emb, b "
              f"{[f'{e:.3e}' for e in g_err]} of their largest (tol "
              f"{tol['grad']}); K4/K5a/K5b launches {launched}")
        check(launched == [1, 1, 1], f"fault l: launches {launched}")
        check(err <= bound and all(e <= tol["grad"] for e in g_err),
              f"fault l ({name}): {out[name]}")
    return out


#: the captured BERT check: BERT-base width, 2 blocks, seq 512, batch 8,
#: hidden dropout 0.1 (attention dropout 0, so the flash kernels run)
CAPTURE_CFG = dict(TRAIN_CFG, n_block=2, hidden_drop=0.1)
CAPTURE_BATCH, CAPTURE_STEPS = 8, 8


def captured_bert_phase():
    """BERT at two blocks of full width, four steps a captured graph
    (``zoo.train.scan_steps=4``): K2, K3a and K3b and the dropout draws run
    inside the graph. With sgd at lr 0 on one record repeated (so the
    weights and the batch never change), every step loss of the two
    replays differs (each step draws new masks) and equals the eager
    loop's at that iteration; with dropout 0 and AdamW, the captured
    fit's losses and final parameters against the eager fit's (the same
    bits, or within 1e-6 relative, said which)."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import (
        KERNEL, KERNEL_BWD_DKV, KERNEL_BWD_DQ)
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import reset_uids
    from analytics_zoo_tpu_torch.tfpark.bert_classifier import \
        BERTClassifier
    x, y, _ = training_data(CAPTURE_BATCH * CAPTURE_STEPS)
    counters = (KERNEL, KERNEL_BWD_DQ, KERNEL_BWD_DKV)

    def fit(keyed, drop, one_record):
        init_zoo_context(conf={"zoo.pallas.attention": True,
                               "zoo.compute.dtype": "bfloat16",
                               "zoo.seed": 0,
                               "zoo.train.scan_steps": 4 if keyed else 1})
        reset_uids()
        model = BERTClassifier(**dict(CAPTURE_CFG, hidden_drop=drop),
                               device="cuda").init_weights()
        if one_record:
            model.compile(optimizer="sgd", loss="scce", lr=0.0)
            xs = [np.repeat(a[:1], len(a), 0) for a in x]
            ys = np.repeat(y[:1], len(y), 0)
        else:
            model.compile(optimizer="adamw", loss="scce", lr=2e-5)
            xs, ys = x, y
        model.fit(xs, ys, batch_size=CAPTURE_BATCH, nb_epoch=1,
                  shuffle=False)                     # captures when keyed
        for c in counters:
            c.reset()
        model.fit(xs, ys, batch_size=CAPTURE_BATCH, nb_epoch=1,
                  shuffle=False)
        torch.cuda.synchronize()
        launches = [c.launches for c in counters]
        return (np.concatenate(model._loop.step_losses),
                [p.detach().clone() for p in model.parameters()], launches)

    keyed, _, launches = fit(True, 0.1, True)
    eager, _, _ = fit(False, 0.1, True)
    want = CAPTURE_CFG["n_block"] * CAPTURE_STEPS
    distinct = len(set(keyed.tolist()))
    masks_equal = bool(np.array_equal(keyed.view(np.int32),
                                      eager.view(np.int32)))
    print(f"captured BERT (2 blocks, seq 512, batch {CAPTURE_BATCH}, hidden "
          f"dropout 0.1, lr 0, one record): {CAPTURE_STEPS} step losses "
          f"over two replays, {distinct} distinct (a new mask every step); "
          f"the eager steps' losses, the same bits: {masks_equal}; "
          f"K2/K3a/K3b launches under replay {launches} (want {want} each)")
    check(distinct == CAPTURE_STEPS, f"captured dropout repeated a mask: "
          f"{keyed.tolist()}")
    check(masks_equal, f"captured dropout draws differ from the eager "
          f"steps': {keyed.tolist()} vs {eager.tolist()}")
    check(launches == [want] * 3, f"captured BERT launches {launches}")

    k_loss, k_params, _ = fit(True, 0.0, False)
    e_loss, e_params, _ = fit(False, 0.0, False)
    loss_bits = bool(np.array_equal(k_loss.view(np.int32),
                                    e_loss.view(np.int32)))
    param_bits = all(torch.equal(a, b) for a, b in zip(k_params, e_params))
    rel = max([float(np.max(np.abs(k_loss - e_loss) / np.abs(e_loss)))]
              + [((a - b).norm() / b.norm().clamp_min(1e-30)).item()
                 for a, b in zip(k_params, e_params)])
    print(f"captured BERT, dropout 0, AdamW 2e-5: captured vs eager step "
          f"losses the same bits {loss_bits}, final parameters the same "
          f"bits {param_bits}"
          + ("" if loss_bits and param_bits
             else f"; largest relative difference {rel:.3e} (tolerance "
                  f"1e-6)"))
    check((loss_bits and param_bits) or rel <= 1e-6,
          f"captured BERT differs from eager by {rel}")
    return {"distinct_step_losses": distinct,
            "dropout_masks_eager_bits": masks_equal,
            "launches": launches, "losses_same_bits": loss_bits,
            "params_same_bits": param_bits, "max_rel_diff": rel}


def ce_hidden_phase():
    """K4, K5a and K5b at hidden widths the kernels pad (H = 100 to 128)
    or slice (H = 1280 and 2048, two slices of 640 and 1024) against their
    plain versions, bf16, N=4100, V=8192, and their times."""
    import torch

    from analytics_zoo_tpu_torch.ops.pallas.cross_entropy import (
        fused_ce_backward_dh, fused_ce_backward_dw,
        fused_ce_backward_reference, fused_ce_forward,
        fused_ce_forward_reference)
    n, v = 4100, 8192
    tol = CE_TOL["bfloat16"]
    g = torch.Generator().manual_seed(5)
    rows = []
    for hidden in (100, 1280, 2048):
        h = torch.randn(n, hidden, generator=g).to("cuda", torch.bfloat16)
        w = (torch.randn(hidden, v, generator=g) * hidden ** -0.5).to(
            "cuda", torch.bfloat16)
        b = (torch.randn(v, generator=g) * 0.5).cuda()
        labels = torch.randint(0, v, (n,), generator=g,
                               dtype=torch.int32).cuda()
        labels[::3] = -1
        scale = torch.where(labels >= 0, 1.0 / n, 0.0).float()
        lse, ll = fused_ce_forward(h, w, b, labels)
        dh = fused_ce_backward_dh(h, w, b, labels, lse, scale)
        dw, db = fused_ce_backward_dw(h, w, b, labels, lse, scale)
        torch.cuda.synchronize()
        ref_lse, ref_ll = fused_ce_forward_reference(h, w, b, labels)
        ref = fused_ce_backward_reference(h, w, b, labels, lse, scale)
        row = {"case": f"bf16_h{hidden}", "n": n, "hidden": hidden,
               "vocab": v, "lse_err": (lse - ref_lse).abs().max().item(),
               "ll_rel_err": ((ll - ref_ll).abs()
                              / ref_ll.abs().clamp_min(1.0)).max().item()}
        check(row["lse_err"] <= tol["lse"], f"H={hidden}: K4 lse "
              f"{row['lse_err']}")
        check(row["ll_rel_err"] <= tol["ll_rel"], f"H={hidden}: K4 label "
              f"logit {row['ll_rel_err']}")
        check(dh.shape == h.shape and dw.shape == w.shape,
              f"H={hidden}: gradient shapes {dh.shape} {dw.shape}")
        for key, got, want in (("dh", dh, ref[0]), ("dw", dw, ref[1]),
                               ("db", db, ref[2])):
            err = (got.float() - want.float()).abs().max().item()
            top = want.float().abs().max().item()
            row[f"{key}_max_abs_err"], row[f"{key}_max_abs"] = err, top
            check(bool(torch.isfinite(got).all()) and err <= tol["grad"]
                  * top, f"H={hidden}: {key} {err} > {tol['grad']} x {top}")
        row["ms"] = {
            "fused_ce_fwd": time_ms(lambda: fused_ce_forward(h, w, b,
                                                             labels)),
            "fused_ce_bwd_dh": time_ms(lambda: fused_ce_backward_dh(
                h, w, b, labels, lse, scale)),
            "fused_ce_bwd_dw": time_ms(lambda: fused_ce_backward_dw(
                h, w, b, labels, lse, scale))}
        # the products' operations over the bf16 peak
        row["bound_ms"] = {
            "fused_ce_fwd": 2.0 * n * hidden * v / PEAK_FLOPS["bfloat16"]
            * 1e3,
            "fused_ce_bwd_dh": 4.0 * n * hidden * v / PEAK_FLOPS["bfloat16"]
            * 1e3,
            "fused_ce_bwd_dw": 4.0 * n * hidden * v / PEAK_FLOPS["bfloat16"]
            * 1e3}
        rows.append(row)
        print(f"ce hidden case {json.dumps(row)}")
        del h, w, dh, dw, ref
    return rows


def make_movielens_like(rng):
    """The JAX package's bench data (bench.py:87-102): ratings from a
    ground-truth latent-factor model, quantized to 5 balanced classes."""
    import numpy as np
    dim = 8
    uf = rng.normal(0, 1.0, (N_USERS + 1, dim))
    vf = rng.normal(0, 1.0, (N_ITEMS + 1, dim))
    users = rng.integers(1, N_USERS + 1, N_EXAMPLES).astype(np.int32)
    items = rng.integers(1, N_ITEMS + 1, N_EXAMPLES).astype(np.int32)
    score = np.einsum("nd,nd->n", uf[users], vf[items]) / np.sqrt(dim)
    score += rng.normal(0, 0.25, N_EXAMPLES)
    # quantize to 5 roughly-balanced classes
    edges = np.quantile(score, [0.2, 0.4, 0.6, 0.8])
    y = np.digitize(score, edges).astype(np.int32)
    x = np.stack([users, items], axis=1)
    return x, y


def host_ms_in_turns(*fns, rounds=5, iters=100):
    """Per-call ms of each of ``fns`` timed in turns (one batch of
    ``iters`` calls each, ``rounds`` times) and the median of each's
    rounds: where the host's launch rate sets the time, this keeps the
    drift of a shared host out of the comparison."""
    import statistics
    times = [[] for _ in fns]
    for _ in range(rounds):
        for fn, t in zip(fns, times):
            t.append(time_ms(fn, iters=iters))
    return [statistics.median(t) for t in times]


def bytes_bound_ms(nbytes):
    return nbytes / PEAK_BYTES_PER_S * 1e3


def embed_case(name, table, ids, dtype, g_seed):
    """K1 and SA on one lookup's dedup'd block: ``ids`` clamped, made
    unique at ``dedup_capacity``, the unique rows gathered; K1 expands
    them (bit for bit against ``rows[inv]``), SA sums a seeded cotangent
    per slot both ways: through the forward's sort (the engine's call, one
    device kernel) and standalone (it sorts first), each bit for bit
    against the CPU's index_add_ and the engine's call the same bits over
    two runs. Returns the case's row with times and byte bounds. ``ms``
    times calls of the wrapper, in turns with ``index_select`` /
    ``index_add_`` (medians of five rounds): at the NCF shapes it reads
    the host's launch rate; ``device_ms`` the same call's device work
    alone (``graph_ms``)."""
    import torch

    from analytics_zoo_tpu_torch.ops.pallas.embedding import (
        dedup_scatter_add, dedup_scatter_add_reference, embed_expand,
        embed_expand_reference)
    from analytics_zoo_tpu_torch.ops.sharded_embedding import (
        _dedup_sort, dedup_capacity)
    v, d = table.shape
    n = ids.shape[0]
    cap = dedup_capacity(n, v)
    uniq, inv, order, slot = _dedup_sort(ids.clamp(0, v - 1), cap, fill=v)
    rows = table.index_select(0, uniq.clamp(0, v - 1).long()).to(dtype)
    g = torch.randn(n, d, generator=torch.Generator().manual_seed(g_seed)
                    ).to("cuda", dtype)

    def sa_engine():
        return dedup_scatter_add(g, inv, cap, order=order, sorted_slot=slot)

    def sa_alone():
        return dedup_scatter_add(g, inv, cap)
    out = embed_expand(rows, inv)
    sums = [sa_engine() for _ in range(2)]
    alone = sa_alone()
    torch.cuda.synchronize()
    es = rows.element_size()
    n_unique = int(torch.unique(inv).numel())
    k1_ref = embed_expand_reference(rows, inv)
    sa_ref = dedup_scatter_add_reference(g.cpu(), inv.cpu(), cap)
    k1_equal = torch.equal(out.view(torch.int16), k1_ref.view(torch.int16))
    sa_same = torch.equal(sums[0].view(torch.int32), sums[1].view(torch.int32))
    sa_equal = torch.equal(sums[0].cpu().view(torch.int32),
                           sa_ref.view(torch.int32))
    alone_equal = torch.equal(alone.cpu().view(torch.int32),
                              sa_ref.view(torch.int32))
    check(k1_equal, f"{name}: K1 differs from rows[inv]")
    check(sa_equal, f"{name}: SA differs from the CPU's position-order sum")
    check(alone_equal, f"{name}: standalone SA differs from the CPU's sum")
    check(sa_same, f"{name}: SA differs between two runs")
    engine_kernels = device_kernels(sa_engine)
    check(len(engine_kernels) == 1, f"{name}: SA through the forward's sort "
          f"launched {engine_kernels}")
    inv64 = inv.long()
    acc = torch.zeros(cap, d, dtype=torch.float32, device="cuda")
    gf = g.float()
    row = {"case": name, "n": n, "capacity": cap, "unique": n_unique, "d": d,
           "dtype": str(dtype).replace("torch.", ""),
           "k1_bit_equal": k1_equal, "sa_bit_equal_cpu": sa_equal,
           "sa_standalone_bit_equal_cpu": alone_equal,
           "sa_same_bits_two_runs": sa_same,
           "embed_expand": {
               "max_abs_err": (out.float() - k1_ref.float()).abs().max()
               .item(),
               **dict(zip(("ms", "library_ms"), host_ms_in_turns(
                   lambda: embed_expand(rows, inv),
                   lambda: torch.index_select(rows, 0, inv64)))),
               "device_ms": graph_ms(lambda: embed_expand(rows, inv)),
               "plain_ms": time_ms(lambda: embed_expand_reference(rows, inv),
                                   iters=50),
               # the referenced unique rows and the ids read, the rows
               # written
               "bound_ms": bytes_bound_ms(n_unique * d * es + n * 4
                                          + n * d * es)},
           "dedup_scatter_add": {
               "max_abs_err": (sums[0].cpu() - sa_ref).abs().max().item(),
               **dict(zip(("ms", "ms_standalone", "library_ms"),
                          host_ms_in_turns(
                              sa_engine, sa_alone,
                              lambda: acc.index_add_(0, inv64, gf)))),
               "device_ms": graph_ms(sa_engine),
               "device_ms_standalone": graph_ms(sa_alone),
               "library_device_ms": graph_ms(
                   lambda: acc.index_add_(0, inv64, gf)),
               "device_kernels": len(engine_kernels),
               "device_kernels_standalone": len(device_kernels(sa_alone)),
               "plain_ms": time_ms(lambda: dedup_scatter_add_reference(
                   g, inv, cap), iters=50),
               # what the function needs: g and the int32 ids read, the
               # (capacity, D) f32 block written
               "bound_ms": bytes_bound_ms(n * d * es + n * 4
                                          + cap * d * 4),
               # the same with the int64 sorted positions and slots this
               # design reads in place of the ids
               "bytes_ms_as_read": bytes_bound_ms(n * d * es + 2 * n * 8
                                                  + cap * d * 4)}}
    print(f"embed kernel case {json.dumps(row)}")
    return row


def embed_kernel_phase(x):
    """K1 and SA at the NCF path's shapes (its first batch's user and item
    ids) and at a DLRM-Terabyte width."""
    import torch
    g = torch.Generator().manual_seed(6)
    batch = torch.from_numpy(x[:NCF_BATCH]).cuda()
    cases = [
        ("ncf_user", torch.randn(N_USERS + 1, 20, generator=g).cuda(),
         batch[:, 0].contiguous(), torch.float32),
        ("ncf_item", torch.randn(N_ITEMS + 1, 20, generator=g).cuda(),
         batch[:, 1].contiguous(), torch.float32)]
    dlrm_table = torch.randn(DLRM_V, DLRM_D, generator=g).cuda()
    dlrm_ids = torch.randint(0, DLRM_V, (DLRM_N,), generator=g,
                             dtype=torch.int32).cuda()
    cases += [("dlrm_f32", dlrm_table, dlrm_ids, torch.float32),
              ("dlrm_bf16", dlrm_table, dlrm_ids, torch.bfloat16)]
    rows = {name: embed_case(name, table, ids, dtype, i)
            for i, (name, table, ids, dtype) in enumerate(cases)}
    del dlrm_table
    return rows


def sharded_ncf(user_count, item_count, class_num, device="cuda"):
    """NeuralCF's graph (``models/recommendation/neural_cf.py``: embeddings
    20/20, MLP 40-20-10, MF 20) built with the functional API on
    ``ShardedEmbedding`` tables: what a user writes to put the tables on
    the dedup'd engine."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (Input,
                                                                   Model)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Dense, Merge, Select, ShardedEmbedding)
    inp = Input(shape=(2,))
    user = Select(1, 0)(inp)
    item = Select(1, 1)(inp)
    h = Merge(mode="concat", concat_axis=-1)([
        ShardedEmbedding(user_count + 1, 20, init="normal")(user),
        ShardedEmbedding(item_count + 1, 20, init="normal")(item)])
    for units in (40, 20, 10):
        h = Dense(units, activation="relu")(h)
    mf = Merge(mode="mul")([
        ShardedEmbedding(user_count + 1, 20, init="normal")(user),
        ShardedEmbedding(item_count + 1, 20, init="normal")(item)])
    h = Merge(mode="concat", concat_axis=-1)([h, mf])
    return Model(inp, Dense(class_num, activation="softmax")(h),
                 device=device)


def step_kernels(net, xb, yb, loss_fn):
    """The names of the device kernels one forward (with the loss) and one
    backward of ``net`` launch: one step read by :func:`device_kernels`,
    split at a marker kernel (``torch.cuda._sleep``) launched between the
    two."""
    import torch

    def step():
        net.zero_grad(set_to_none=True)
        loss = loss_fn(yb, net(xb, training=True))
        torch.cuda._sleep(1)
        loss.backward()
    names = device_kernels(step)
    net.zero_grad(set_to_none=True)
    cut = next(i for i, name in enumerate(names) if "spin_kernel" in name)
    return names[:cut], names[cut + 1:]


def ncf_plain_forward(params, pairs):
    """NeuralCF's forward written out on the weight tensors, in the
    order of ``neural_cf.py`` (the eager reference for the ranking)."""
    import torch
    p = list(params)
    mlp_u, mlp_i, d1w, d1b, d2w, d2b, d3w, d3b, mf_u, mf_i, ow, ob = p
    users, items = pairs[:, 0].long(), pairs[:, 1].long()
    h = torch.cat([mlp_u[users], mlp_i[items]], dim=-1)
    for w, b in ((d1w, d1b), (d2w, d2b), (d3w, d3b)):
        h = torch.relu(h @ w + b)
    h = torch.cat([h, mf_u[users] * mf_i[items]], dim=-1)
    return torch.softmax(h @ ow + ob, dim=-1)


def busy_share(intervals, t0, t1):
    """Fraction of [t0, t1] covered by the union of ``intervals``."""
    covered, end = 0.0, t0
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, t1)
        if e > s:
            covered += e - s
            end = e
    return covered / (t1 - t0) if t1 > t0 else 0.0


def profiled_busy_share(fn):
    """``fn()`` under ``torch.profiler``: the share of the wall window (the
    first to the last traced event) in which a device kernel ran, and the
    summed kernel ms; None when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, window = [], [float("inf"), float("-inf")]
    for evt in prof.events():
        tr = evt.time_range
        window[0] = min(window[0], tr.start)
        window[1] = max(window[1], tr.end)
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((tr.start, tr.end))
    if not kernels:
        return None, None
    return (busy_share(kernels, *window),
            sum(e - s for s, e in kernels) / 1e3)


def ncf_fit(name, model, fs, counters):
    """compile/fit: a warm-up epoch, then two timed epochs with the
    launch counters set to 0 just before and read just after."""
    import numpy as np
    import torch
    model.compile(optimizer="adam", loss="scce", metrics=["accuracy"],
                  lr=1e-3)
    records = []
    t0 = time.perf_counter()
    model.fit(fs, batch_size=NCF_BATCH, nb_epoch=1,
              callbacks=[records.append])
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    step_losses = list(model._loop.step_losses)
    for c in counters:
        c.reset()
    timed = []
    t0 = time.perf_counter()
    model.fit(fs, batch_size=NCF_BATCH, nb_epoch=2,
              callbacks=[timed.append])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [c.launches for c in counters]
    step_losses += model._loop.step_losses
    records += timed
    steps = 2 * fs.steps_per_epoch(NCF_BATCH)
    losses = [r["loss"] for r in records]
    summary = {"steps": steps, "batch": NCF_BATCH,
               "recs_per_s": max(r["throughput"] for r in timed),
               "ms_per_step": 1e3 * wall / steps, "wall_s": wall,
               "warmup_s": warm, "losses": losses,
               "step_losses": np.concatenate(step_losses),
               "launches": dict(zip(("embed_expand", "dedup_scatter_add"),
                                    launches))}
    print(f"ncf {name}: {steps} steps of {NCF_BATCH} in {wall:.3f}s = "
          f"{summary['recs_per_s']:.1f} recs/s (best epoch), "
          f"{summary['ms_per_step']:.2f} ms/step (warm-up {warm:.1f}s); "
          f"losses {losses}; launches {json.dumps(summary['launches'])}")
    check(all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[0] and losses[-1] < math.log(N_CLASSES),
          f"ncf {name} loss gate: {losses}")
    return summary


def ncf_build(kind, n_users, n_items):
    """A fresh NCF of ``kind`` (stock or sharded) with the seeded start
    weights (``zoo.seed`` 0, names from a reset uid counter): ``(model,
    net)``, ``net`` the module holding the parameters."""
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import reset_uids
    reset_uids()
    if kind == "stock":
        model = NeuralCF(n_users, n_items, N_CLASSES, device="cuda")
        model.init_weights()
        return model, model.model
    net = sharded_ncf(n_users, n_items, N_CLASSES).init_weights()
    return net, net


def ncf_conf(keyed):
    return {"zoo.seed": 0, "zoo.compute.dtype": "float32",
            "zoo.pallas.embed_gather": "auto",
            **(NCF_KEYED_CONF if keyed else {})}


def ncf_in_turns(kind, fs, counters, n_users, n_items):
    """``kind``'s fit four times from the same start, eager, keyed, keyed,
    eager (the host's speed moves NCF between machines, so the loops are
    compared within one call), each the device's busy share over one
    more epoch under the profiler after its timed epochs; then the keyed
    loop once more with the device permutation replaced by the
    FeatureSet's own order, its step losses held to the first eager
    run's."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.pipeline.api.keras import dispatch
    runs = {"eager": [], "keyed": []}
    first = None
    for mode in ("eager", "keyed", "keyed", "eager"):
        init_zoo_context(conf=ncf_conf(mode == "keyed"))
        model, net = ncf_build(kind, n_users, n_items)
        summary = ncf_fit(f"{kind} {mode} run {len(runs[mode]) + 1}",
                          model, fs, counters)
        share, kernel_ms = profiled_busy_share(
            lambda: model.fit(fs, batch_size=NCF_BATCH, nb_epoch=1))
        summary.update(busy_share=share, profiled_kernel_ms=kernel_ms)
        print(f"ncf {kind} {mode}: device busy "
              f"{'not measured' if share is None else f'{100 * share:.1f}%'}"
              f" of one profiled epoch ({kernel_ms} ms of kernels)")
        runs[mode].append(summary)
        if first is None:
            first = (model, net)
        else:
            del model, net
    order = dispatch.device_permutation
    dispatch.device_permutation = (
        lambda n, seed, device: torch.from_numpy(
            np.random.default_rng(seed).permutation(n)).to(device))
    try:
        init_zoo_context(conf=ncf_conf(True))
        model, _ = ncf_build(kind, n_users, n_items)
        same = ncf_fit(f"{kind} keyed in the FeatureSet's order", model, fs,
                       counters)
    finally:
        dispatch.device_permutation = order
    del model
    want = runs["eager"][0]["step_losses"]
    got = same["step_losses"]
    bits = bool(np.array_equal(got.view(np.int32), want.view(np.int32)))
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    print(f"ncf {kind}: keyed loop in the FeatureSet's order vs the eager "
          f"loop, {len(want)} step losses: the same bits {bits}"
          + ("" if bits else f", largest relative difference {rel:.3e} "
             f"(tolerance {NCF_STEP_REL_TOL})"))
    check(len(got) == len(want) and (bits or rel <= NCF_STEP_REL_TOL),
          f"ncf {kind}: keyed step losses differ from the eager loop's by "
          f"{rel}")
    for mode, rs in runs.items():
        for r in rs:
            r.pop("step_losses")
    return runs, {"same_bits": bits, "max_rel_diff": rel}, first


def ncf_phase(x, y):
    """Both NCF configurations through compile/fit at the bench width, each
    in turns eager and with the JAX bench's dispatch keys, their launch
    counts, one step's gradients against each other, the dW bits of two
    backward passes, and recommend_for_user."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.feature.feature_set import FeatureSet
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    from analytics_zoo_tpu_torch.ops.pallas.embedding import (
        KERNEL_EMBED_EXPAND, KERNEL_SCATTER_ADD)
    from analytics_zoo_tpu_torch.pipeline.api.keras import objectives

    counters = (KERNEL_EMBED_EXPAND, KERNEL_SCATTER_ADD)
    n_users = max(N_USERS, int(x[:, 0].max()))
    n_items = max(N_ITEMS, int(x[:, 1].max()))
    fs = FeatureSet.array(x, y, seed=0)
    steps_per_epoch = fs.steps_per_epoch(NCF_BATCH)
    out = {}
    nets = {}
    for kind in ("stock", "sharded"):
        runs, same, (model, net) = ncf_in_turns(kind, fs, counters, n_users,
                                                n_items)
        nets[kind] = (model, net)
        want = ({"embed_expand": 0, "dedup_scatter_add": 0}
                if kind == "stock" else
                {"embed_expand": 4 * runs["eager"][0]["steps"],
                 "dedup_scatter_add": 4 * runs["eager"][0]["steps"]})
        for mode, rs in runs.items():
            for r in rs:
                check(r["launches"] == want,
                      f"ncf {kind} {mode}: launches {r['launches']}, want "
                      f"{want} (4 tables x steps on the sharded graph, "
                      f"none on the stock model)")
        out[kind] = runs["eager"][0]
        out[kind + "_runs"] = runs
        out[kind + "_keyed_vs_eager"] = same
        print(f"ncf {kind}: records/s eager "
              f"{[r['recs_per_s'] for r in runs['eager']]}, keyed "
              f"{[r['recs_per_s'] for r in runs['keyed']]}; ms/step eager "
              f"{[r['ms_per_step'] for r in runs['eager']]}, keyed "
              f"{[r['ms_per_step'] for r in runs['keyed']]}; device busy "
              f"eager {[r['busy_share'] for r in runs['eager']]}, keyed "
              f"{[r['busy_share'] for r in runs['keyed']]}")
    init_zoo_context(conf=ncf_conf(False))
    stock, sharded = nets["stock"][0], nets["sharded"][1]
    start_stock = ncf_build("stock", n_users, n_items)[1]
    start = [p.detach().clone() for p in start_stock.parameters()]
    del start_stock

    # one step's gradients of the two from the same (starting) weights
    xb = torch.from_numpy(x[:NCF_BATCH]).cuda()
    yb = torch.from_numpy(y[:NCF_BATCH]).cuda()
    loss_fn = objectives.get_loss("scce")
    with torch.no_grad():
        for net in (stock.model, sharded):
            for p, p0 in zip(net.parameters(), start):
                p.copy_(p0)
    grads = {}
    for key, net in (("stock", stock.model), ("sharded", sharded),
                     ("sharded_again", sharded)):
        net.zero_grad(set_to_none=True)
        loss_fn(yb, net(xb, training=True)).backward()
        grads[key] = [p.grad.detach().clone() for p in net.parameters()]
    names = [n for n, _ in sharded.named_parameters()]
    rel = {n: ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
           for n, a, b in zip(names, grads["sharded"], grads["stock"])}
    worst = max(rel, key=rel.get)
    tables = [i for i, n in enumerate(names) if n.endswith("embeddings")]
    same_bits = all(torch.equal(grads["sharded"][i].view(torch.int32),
                                grads["sharded_again"][i].view(torch.int32))
                    for i in tables)
    print(f"ncf: one step, sharded graph vs stock NeuralCF: largest "
          f"per-leaf gradient relative error {rel[worst]:.3e} ({worst}; "
          f"tolerance {NCF_GRAD_REL_TOL}); the tables' dW the same bits "
          f"over two backward passes: {same_bits}")
    # the device kernels of one forward and one backward of the sharded
    # graph: SA once a table, nothing sorted or searched in the backward
    fwd_names, bwd_names = step_kernels(sharded, xb, yb, loss_fn)
    sa = [k for k in bwd_names if "segment_sum_sorted" in k]
    searched = [k for k in bwd_names if "radix" in k.lower()
                or "searchsorted" in k.lower()]
    print(f"ncf: one step of the sharded graph launches {len(fwd_names)} "
          f"device kernels forward and {len(bwd_names)} backward; SA "
          f"{len(sa)} in the backward, sorts and searches there "
          f"{len(searched)}")
    check(len(sa) == 4 and not searched, f"the sharded backward launched "
          f"SA {len(sa)} times and {searched}")
    out.update(step_kernels_fwd=len(fwd_names),
               step_kernels_bwd=len(bwd_names))
    check(rel[worst] <= NCF_GRAD_REL_TOL, f"ncf gradients: {worst} "
          f"{rel[worst]}")
    check(same_bits, "the sharded tables' dW differ between two runs")
    out.update(grad_rel_err_max=rel[worst], grad_rel_err_leaf=worst,
               dw_same_bits=same_bits, steps_per_epoch=steps_per_epoch)
    del grads

    # recommend_for_user against the plain eager forward
    items = np.arange(1, n_items + 1, dtype=np.int32)
    recs = {}
    for user in (1, 1234, n_users):
        got = stock.recommend_for_user(user, items, max_items=10,
                                       batch_size=NCF_BATCH)
        # the same (padded) batch predict runs: the last pair repeated
        pairs = np.stack([np.full_like(items, user), items], axis=1)
        pairs = np.concatenate([pairs, np.repeat(
            pairs[-1:], NCF_BATCH - len(items), axis=0)])
        with torch.no_grad():
            probs = ncf_plain_forward(stock.model.parameters(),
                                      torch.from_numpy(pairs).cuda())
        want = NeuralCF._top_ids(items, probs[:len(items)].cpu().numpy(), 10)
        check(np.array_equal(got, want), f"recommend_for_user({user}): "
              f"{got} vs the plain forward's {want}")
        recs[user] = got.tolist()
    print(f"ncf: recommend_for_user matches the plain forward: "
          f"{json.dumps(recs)}")
    out["recommend_for_user"] = recs
    return out


def oocore_plan_counters(v, hot_rows, batches, staged_rows=8192):
    """The out-of-core cache's counters after planning ``batches`` in
    order, from numpy and an LRU of this function's own (the plan's
    rules: np.unique's dedup, hot ids hits, staged cold rows hits moved to
    the LRU's end, the misses added in id order, then the oldest dropped
    past ``staged_rows``). Also each batch's distinct cold ids."""
    import collections

    import numpy as np
    lru = collections.OrderedDict()
    c = {"ids": 0, "dedup_saved": 0, "hits": 0, "misses": 0}
    cold_per_batch = []
    for ids in batches:
        flat = np.clip(ids.reshape(-1).astype(np.int64), 0, v - 1)
        uniq = np.unique(flat)
        c["ids"] += int(flat.size)
        c["dedup_saved"] += int(flat.size - uniq.size)
        hot = uniq < hot_rows
        c["hits"] += int(hot.sum())
        cold = uniq[~hot].tolist()
        cold_per_batch.append(len(cold))
        misses = []
        for i in cold:
            if i in lru:
                lru.move_to_end(i)
                c["hits"] += 1
            else:
                misses.append(i)
        c["misses"] += len(misses)
        for i in misses:
            lru[i] = True
        while len(lru) > staged_rows:
            lru.popitem(last=False)
    return c, cold_per_batch


def oocore_phase():
    """The JAX bench's ``bench_embedding_oocore`` (``bench.py:326-389``) on
    the port's ``OutOfCoreEmbeddingCache`` at the bench's 2 MB hot budget
    and at the default 64 MB: a table ten times the hot tier, 24 batches
    of 4096 zipf(1.1) ids (numpy seed 7, the table drawn first), each
    batch's plan staged by the prefetch thread, then one upload and the
    two-tier gather on the card, synchronised. Prints the bench's
    channels; gates: every batch's rows the master table's gather bit for
    bit, the counters what numpy's plan gives on the same ids, the
    gradient of one batch through SA against the dense scatter-add of the
    same cotangents (and the same bits twice), and a stream under an
    ``embed.prefetch`` error plan still giving the same rows."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common import faults
    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.observability import MetricsRegistry
    from analytics_zoo_tpu_torch.ops.pallas.embedding import \
        KERNEL_SCATTER_ADD
    from analytics_zoo_tpu_torch.ops.sharded_embedding import \
        OutOfCoreEmbeddingCache

    def fams(reg):
        out = {}
        for m in reg.metrics():
            out[m.name] = out.get(m.name, 0.0) + m.value
        return out

    results = {}
    sa_launches = 0
    for name, budget in OOCORE_BUDGETS_MB.items():
        init_zoo_context(conf={"zoo.seed": 0,
                               "zoo.embed.hot_rows_budget_mb": budget},
                         faults_enabled=True)
        d = OOCORE_D
        hot_rows = max(int(budget * (1 << 20) // (d * 4)), 1024)
        v = hot_rows * 10
        t0 = time.perf_counter()
        rng = np.random.default_rng(OOCORE_SEED)
        table = rng.normal(size=(v, d)).astype(np.float32)
        ids = [((rng.zipf(1.1, size=OOCORE_BATCH) - 1) % v).astype(np.int64)
               for _ in range(OOCORE_BATCHES)]
        reg = MetricsRegistry()
        cache = OutOfCoreEmbeddingCache(table, registry=reg,
                                        device=OOCORE_DEVICE)
        setup_s = time.perf_counter() - t0
        check(cache.hot_rows == hot_rows, f"oocore {name}: hot rows "
              f"{cache.hot_rows}, not the budget's {hot_rows}")
        p0 = cache.plan(ids[0])          # warm-up, as the bench's
        cache.rows(p0)
        torch.cuda.synchronize()
        got, rows_out = [], 0
        t0 = time.perf_counter()
        for ids_b, p in cache.stream(iter(ids)):
            got.append(cache.rows(p))
            torch.cuda.synchronize()
            rows_out += ids_b.size
        dt = time.perf_counter() - t0
        f = fams(reg)
        seen, saved = f["zoo_embed_ids_total"], \
            f["zoo_embed_dedup_saved_rows_total"]
        hits, misses = f["zoo_embed_cache_hits_total"], \
            f["zoo_embed_cache_misses_total"]
        channels = {
            "embedding_oocore_recs_per_sec": rows_out / dt,
            "embedding_dedup_rows_saved_ratio": saved / max(seen, 1.0),
            "embedding_oocore_table_rows": v,
            "embedding_oocore_hot_rows": cache.hot_rows,
            "embedding_oocore_cache_hit_rate": hits / max(hits + misses,
                                                          1.0)}
        bit_equal = all(torch.equal(r.cpu(), torch.from_numpy(table[i]))
                        for i, r in zip(ids, got))
        check(bit_equal, f"oocore {name}: rows differ from the master "
              f"table's gather")
        want, cold_per_batch = oocore_plan_counters(v, hot_rows,
                                                    [ids[0]] + ids)
        counters = {"ids": seen, "dedup_saved": saved, "hits": hits,
                    "misses": misses}
        check(counters == want and f["zoo_embed_prefetch_rows_total"]
              == sum(cold_per_batch[1:])
              and f["zoo_embed_prefetch_errors_total"] == 0,
              f"oocore {name}: counters {f} vs numpy's plan {want}, "
              f"prefetch rows {sum(cold_per_batch[1:])}")

        # the gradient of one batch: SA per distinct id in position order
        g = torch.Generator(device=OOCORE_DEVICE).manual_seed(1)
        cot = torch.randn(OOCORE_BATCH, d, generator=g,
                          device=OOCORE_DEVICE)
        KERNEL_SCATTER_ADD.reset()
        grads = []
        for _ in range(2):
            hot = cache.hot.detach().clone().requires_grad_()
            cold = torch.from_numpy(p0.cold).to(
                OOCORE_DEVICE).requires_grad_()
            (cache.rows(p0, hot=hot, cold=cold) * cot).sum().backward()
            grads.append((hot.grad, cold.grad))
        torch.cuda.synchronize()
        sa = KERNEL_SCATTER_ADD.launches
        sa_launches += sa
        same = all(torch.equal(a, b) for a, b in zip(*grads))
        dw = p0.scatter_grad(*grads[0])
        ref = np.zeros((v, d), np.float32)
        np.add.at(ref, ids[0], cot.cpu().numpy())
        grad_err = float(np.max(np.abs(dw - ref)
                                / np.maximum(np.abs(ref), 1e-6)))
        want_sa = 2 if OOCORE_DEVICE == "cuda" else 0  # the CPU: no kernel
        check(same and sa == want_sa and grad_err <= OOCORE_GRAD_TOL,
              f"oocore {name}: gradient same bits {same}, SA launches {sa}, "
              f"relative error {grad_err} (limit {OOCORE_GRAD_TOL})")

        # a failing prefetch degrades and gives the same rows
        freg = MetricsRegistry()
        fcache = OutOfCoreEmbeddingCache(table, registry=freg,
                                         device=OOCORE_DEVICE)
        plan = faults.FaultPlan(seed=7).add("embed.prefetch", "error",
                                            at=(0, 2))
        with faults.activate(plan):
            degraded = [(i, fcache.rows(p)) for i, p in
                        fcache.stream(iter(ids[:6]))]
        torch.cuda.synchronize()
        errors = fams(freg)["zoo_embed_prefetch_errors_total"]
        check(len(degraded) == len(ids[:6]) and errors == 2
              and all(torch.equal(r.cpu(), torch.from_numpy(table[i]))
                      for i, r in degraded),
              f"oocore {name}: the degraded stream ({errors} errors)")
        del fcache, degraded
        results[name] = {**channels, "wall_s": dt, "setup_s": setup_s,
                         "batches": OOCORE_BATCHES, "batch": OOCORE_BATCH,
                         "d": d, "counters": counters,
                         "rows_bit_equal": bit_equal,
                         "grad_rel_err": grad_err, "grad_same_bits": same,
                         "sa_launches": sa, "prefetch_errors_degraded":
                         errors,
                         "table_bytes": int(table.nbytes)}
        print(f"oocore {name}: {json.dumps(results[name])}")
        del cache, got, table
    results["sa_launches"] = sa_launches
    return results


def disk_fit_phase(x, y):
    """NCF (``NeuralCF(6040, 3706, 5)``, the NCF phase's ratings) fitted
    from ``.npy`` files in a temporary directory through a
    ``DiskFeatureSet`` of two slices in rotation mode for one full pass,
    eager, against the same model fitted on ``FeatureSet.array`` of each
    slice in turn: the same step losses bit for bit. Reports which IO path
    read the files and the disk fit's records/s."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.feature.feature_set import (DiskFeatureSet,
                                                             FeatureSet)
    tmp = tempfile.mkdtemp(prefix="zoo-disk-")
    try:
        xp, yp = os.path.join(tmp, "x.npy"), os.path.join(tmp, "y.npy")
        np.save(xp, x)
        np.save(yp, y)
        init_zoo_context(conf=ncf_conf(False))
        fs = DiskFeatureSet(xp, yp, num_slices=DISK_SLICES, shuffle=False)
        losses = {}
        walls = {}
        for kind in ("disk", "ram"):
            model, _ = ncf_build("stock", N_USERS, N_ITEMS)
            model.compile(optimizer="adam", loss="scce", lr=1e-3)
            steps = []
            t0 = time.perf_counter()
            if kind == "disk":
                model.fit(fs, batch_size=DISK_BATCH, nb_epoch=1)
                steps = list(model._loop.step_losses)
            else:
                for e in range(1, DISK_SLICES + 1):
                    idx = fs._slice_indices(e)
                    model.fit(FeatureSet.array(x[idx], y[idx],
                                               shuffle=False),
                              batch_size=DISK_BATCH, nb_epoch=1)
                    steps += list(model._loop.step_losses)
            torch.cuda.synchronize()
            walls[kind] = time.perf_counter() - t0
            losses[kind] = np.concatenate(steps)
        same = (losses["disk"].shape == losses["ram"].shape
                and np.array_equal(losses["disk"].view(np.int32),
                                   losses["ram"].view(np.int32)))
        n = DISK_SLICES * fs.steps_per_epoch(DISK_BATCH) * DISK_BATCH
        row = {"io_path": fs.io_path, "slices": DISK_SLICES,
               "steps": int(losses["disk"].size),
               "losses_bit_equal": same,
               "recs_per_s_disk": n / walls["disk"],
               "recs_per_s_ram": n / walls["ram"],
               "wall_s": walls}
        print(f"disk fit: {json.dumps(row)}")
        check(same and losses["disk"].size > 0, "disk fit: the step losses "
              "differ from the in-RAM fit over the same slices")
        check(np.all(np.isfinite(losses["disk"])), "disk fit: loss")
        fs.close()
        return row
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def embed_kernel_rows(embed_rows, launches):
    """The K1 and SA rows of the kernels line: at the NCF path's user-table
    shape, with the DLRM-width times beside."""
    src = "analytics_zoo_tpu_torch/csrc/embedding.cu"
    replaces = {"embed_expand": "analytics_zoo_tpu/ops/pallas/"
                                "embedding.py:104",
                "dedup_scatter_add": "analytics_zoo_tpu/ops/"
                                     "sharded_embedding.py:148 (XLA "
                                     "scatter; no Pallas kernel)"}
    main, dlrm = embed_rows["ncf_user"], embed_rows["dlrm_f32"]
    rows = []
    for name in ("embed_expand", "dedup_scatter_add"):
        t, td = main[name], dlrm[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces[name],
                     "launches": launches[name],
                     "max_abs_err": max(t["max_abs_err"], td["max_abs_err"]),
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": "bytes",
                     "library_ms": t["library_ms"],
                     "library_by": ("index_select" if name == "embed_expand"
                                    else "index_add_ (float atomics)"),
                     "device_ms": t["device_ms"],
                     "ms_dlrm": td["ms"], "device_ms_dlrm": td["device_ms"],
                     "plain_ms_dlrm": td["plain_ms"],
                     "bound_ms_dlrm": td["bound_ms"],
                     "library_ms_dlrm": td["library_ms"]})
        if name == "dedup_scatter_add":
            rows[-1].update({
                key + suffix: case[key]
                for key in ("ms_standalone", "device_ms_standalone",
                            "library_device_ms", "device_kernels",
                            "device_kernels_standalone", "bytes_ms_as_read")
                for suffix, case in (("", t), ("_dlrm", td))})
    return rows


#: the reliability phase (slice 15): BERT-base as in the training phase,
#: 3 epochs of 8 steps a run; snapshots keep 2 under a temporary directory
def wide_deep_table():
    """The JAX bench's synthetic Census rows (``bench.py:116-127``, numpy
    seed 1; ``WD_ROWS`` of them) and its ``ColumnFeatureInfo``
    (``:128-134``)."""
    import numpy as np
    n = WD_ROWS

    from analytics_zoo_tpu_torch.models.recommendation import \
        ColumnFeatureInfo
    rng = np.random.default_rng(1)
    table = {
        "gender": rng.integers(0, 2, n),
        "occupation": rng.integers(0, 10, n),
        "education": rng.integers(0, 16, n),
        "age_bucket": rng.integers(0, 10, n),
        "hours": rng.normal(size=n).astype(np.float32),
        "capital_gain": rng.normal(size=n).astype(np.float32),
    }
    table["gender_x_occupation"] = table["gender"] * 10 + table["occupation"]
    table["label"] = ((table["occupation"] + table["education"]) % 2
                      ).astype(np.int32)
    info = ColumnFeatureInfo(
        wide_base_cols=["gender", "occupation"], wide_base_dims=[2, 10],
        wide_cross_cols=["gender_x_occupation"], wide_cross_dims=[20],
        indicator_cols=["education"], indicator_dims=[16],
        embed_cols=["occupation", "age_bucket"], embed_in_dims=[10, 10],
        embed_out_dims=[16, 16],
        continuous_cols=["hours", "capital_gain"])
    return table, info


WD_CHILD = r"""
import sys
import numpy as np
sys.path.insert(0, {repo!r})
import chip_smoke
from analytics_zoo_tpu_torch.pipeline.nnframes import NNClassifierModel, NNModel
m = NNModel.load({path!r})
assert isinstance(m, NNClassifierModel), type(m).__name__
assert m.model._loop is None and m.model.opt_state is None
table, _ = chip_smoke.wide_deep_table()
np.save({out!r}, m.transform(table)["prediction"])
print("child: NNModel.load + transform on", m.model.device)
"""


def wide_deep_conf(keyed):
    return {"zoo.seed": 0, "zoo.compute.dtype": "float32",
            **(WD_KEYED_CONF if keyed else {})}


def wide_deep_model(info):
    """A fresh WideAndDeep at the bench's width on the card, its weights
    from ``zoo.seed`` 0 (names from a reset uid counter)."""
    from analytics_zoo_tpu_torch.models.recommendation import WideAndDeep
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import reset_uids
    reset_uids()
    return WideAndDeep("wide_n_deep", 2, info, hidden_layers=(40, 20, 10),
                       device="cuda").init_weights()


def top_kernels(fn, top=8):
    """``fn()`` under ``torch.profiler`` once: the device's busy share of
    the wall window (as :func:`profiled_busy_share`), each device kernel's
    summed time by :func:`kernel_name`, the largest ``top`` with their
    share of the kernels' time, and the embedding gradient's share
    (``index_put_``'s sort and accumulation, the tables' backward). None
    when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, spans, window = {}, [], [float("inf"), float("-inf")]
    for e in prof.events():
        tr = e.time_range
        window[0] = min(window[0], tr.start)
        window[1] = max(window[1], tr.end)
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and is_kernel_event(e.name)):
            name = kernel_name(e.name)
            by_name[name] = by_name.get(name, 0.0) + (tr.end - tr.start)
            spans.append((tr.start, tr.end))
    total = sum(by_name.values())
    if not total:
        return None
    order = sorted(by_name.items(), key=lambda kv: -kv[1])
    embed = sum(us for name, us in by_name.items()
                if "indexing_backward" in name
                or "radix" in name.lower().replace("_", ""))
    return {"busy_share": busy_share(spans, *window),
            "kernel_ms": total / 1e3, "kernels": len(by_name),
            "embedding_grad_share": embed / total,
            "top": [{"name": n, "share": us / total, "ms": us / 1e3}
                    for n, us in order[:top]]}


def wide_deep_estimator(info, optim_methods=None, model_dir=None):
    """An Estimator over a fresh :func:`wide_deep_model` (Adam 1e-3
    unless ``optim_methods`` says otherwise)."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import adam
    from analytics_zoo_tpu_torch.pipeline.estimator import Estimator
    return Estimator(wide_deep_model(info),
                     optim_methods=optim_methods or adam(1e-3),
                     model_dir=model_dir)


def wide_deep_fit(est, fs, epochs, keyed, callbacks=()):
    """``epochs`` more epochs of ``est``'s model (scce), under the bench's
    keys or on the eager loop; the per-epoch losses."""
    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    init_zoo_context(conf=wide_deep_conf(keyed))
    return est.train(fs, "scce", batch_size=WD_BATCH, nb_epoch=epochs,
                     callbacks=callbacks)["loss"]


def bits_or_close(name, got, want, tol, absolute):
    """Whether two float arrays are the same bits, and their largest
    difference (relative or absolute); checks it against ``tol`` when the
    bits differ."""
    import numpy as np
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bits = got.shape == want.shape and bool(np.array_equal(
        got.view(np.int32), want.view(np.int32)))
    diff = np.abs(got - want)
    diff = float(np.max(diff if absolute else diff / np.abs(want)))
    print(f"{name}: the same bits {bits}"
          + ("" if bits else f", largest {'absolute' if absolute else 'relative'}"
             f" difference {diff:.3e} (tolerance {tol})"))
    check(got.shape == want.shape and (bits or diff <= tol),
          f"{name}: differ by {diff}")
    return {"same_bits": bits, "max_diff": diff}


def wide_deep_phase():
    """The JAX bench's Wide & Deep channel on the card (``bench.py:
    105-160``): 200,000 Census-shaped rows, ``WideAndDeep("wide_n_deep",
    2, hidden (40, 20, 10))`` through ``NNClassifier`` with
    ``feature_preprocessing`` = ``info.input_arrays`` (a
    ``functools.partial``, so the fitted model pickles), Adam 1e-3, batch
    8192, under the bench's keys (``scan_steps=16``, ``device_cache``,
    ``fuse_epochs=12``): one warm-up ``clf.fit(table)``, one warm-up
    6-epoch ``fit_feature_set``, then three timed 6-epoch dispatches;
    ``wide_deep_train_samples_per_sec`` is the median over the dispatches
    of each one's best epoch throughput, ``wide_deep_max_samples_per_sec``
    the largest. In turns with each dispatch, the same 6-epoch fit on the
    eager loop (keys off) of a second model. One dispatch of each is
    profiled: the device's busy share and the top kernels with their
    share, the embedding gradient's among them.

    Gates: the captured fit against the eager fit from the same weights
    in the same batch order (the device permutation replaced by the
    FeatureSet's order), per-epoch losses: bits or ``WD_LOSS_REL_TOL``;
    the loss falls from the first epoch to the last;
    ``NNClassifierModel.transform``'s prediction is the argmax of
    ``model.predict`` (training accuracy printed); ``NNModel.save`` here
    and ``NNModel.load(...).transform`` in a child process give the same
    predictions bit for bit; ``Estimator(model, optim_methods={"dense":
    "sgd"}, model_dir=...)`` (the deep tower's Dense layers on sgd, the
    rest on Adam: ``multi_optimizer``'s slots) for 3 epochs with
    ``EveryEpoch`` snapshots, and a second model resumed from the
    snapshot after epoch 2 for the third: the uninterrupted run's
    parameters, bits or ``WD_PARAM_TOL``."""
    import functools
    import shutil
    import tempfile

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.feature import FeatureSet
    from analytics_zoo_tpu_torch.pipeline.api.keras import dispatch
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import adam
    from analytics_zoo_tpu_torch.pipeline.nnframes import NNClassifier
    from analytics_zoo_tpu_torch.utils.prediction import probs_to_classes

    t_phase = time.perf_counter()
    table, info = wide_deep_table()
    out = {"rows": WD_ROWS, "batch": WD_BATCH, "epochs_a_dispatch": WD_EPOCHS,
           "keys": WD_KEYED_CONF}

    # -- the bench's path under its keys ---------------------------------
    init_zoo_context(conf=wide_deep_conf(True))
    model = wide_deep_model(info)
    prep = functools.partial(info.input_arrays, model_type="wide_n_deep")
    clf = (NNClassifier(model, feature_preprocessing=prep)
           .set_optim_method(adam(1e-3)).set_batch_size(WD_BATCH)
           .set_max_epoch(1))
    t0 = time.perf_counter()
    fitted = clf.fit(table)                      # warm-up epoch (capture)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    fs = FeatureSet.array(clf._features(table), clf._label(table))
    loop = model._loop
    loop.fit_feature_set(fs, batch_size=WD_BATCH, nb_epoch=WD_EPOCHS)
    steps = WD_EPOCHS * fs.steps_per_epoch(WD_BATCH)

    # the eager loop's model (keys off), warmed up the same way
    init_zoo_context(conf=wide_deep_conf(False))
    eager = wide_deep_estimator(info)
    wide_deep_fit(eager, fs, 1, keyed=False)

    disp, eager_sps, losses = [], [], []
    for _ in range(3):
        init_zoo_context(conf=wide_deep_conf(True))
        records = []
        t0 = time.perf_counter()
        loop.fit_feature_set(fs, batch_size=WD_BATCH, nb_epoch=WD_EPOCHS,
                             callbacks=[records.append])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        disp.append(max(r["throughput"] for r in records))
        losses += [r["loss"] for r in records]
        records = []
        t0 = time.perf_counter()
        wide_deep_fit(eager, fs, WD_EPOCHS, keyed=False,
                      callbacks=[records.append])
        torch.cuda.synchronize()
        eager_sps.append(max(r["throughput"] for r in records))
        print(f"wide&deep: keyed dispatch {len(disp)}: {steps} steps in "
              f"{wall:.3f}s, best epoch {disp[-1]:.1f} samples/s; eager "
              f"best epoch {eager_sps[-1]:.1f} samples/s")
    out.update(wide_deep_train_samples_per_sec=float(np.median(disp)),
               wide_deep_max_samples_per_sec=float(max(disp)),
               keyed_dispatch_samples_per_sec=disp,
               eager_samples_per_sec=eager_sps,
               eager_median_samples_per_sec=float(np.median(eager_sps)),
               warmup_s=warm, steps_a_dispatch=steps)
    print(f"wide&deep: wide_deep_train_samples_per_sec "
          f"{out['wide_deep_train_samples_per_sec']:.1f}, "
          f"wide_deep_max_samples_per_sec "
          f"{out['wide_deep_max_samples_per_sec']:.1f} (bench keys, "
          f"median/max of 3 dispatches of {WD_EPOCHS} epochs); eager loop "
          f"median {out['eager_median_samples_per_sec']:.1f}; first "
          f"clf.fit (captures) {warm:.1f}s")

    # -- busy share and top kernels, one dispatch of each ----------------
    for name, keyed, fn in (
            ("keyed", True, lambda: loop.fit_feature_set(
                fs, batch_size=WD_BATCH, nb_epoch=WD_EPOCHS)),
            ("eager", False, lambda: wide_deep_fit(eager, fs, WD_EPOCHS,
                                                   keyed=False))):
        init_zoo_context(conf=wide_deep_conf(keyed))
        trace = top_kernels(fn)
        out[f"{name}_trace"] = trace
        if trace is None:
            print(f"wide&deep {name}: device busy share, kernels and the "
                  f"embedding gradient's share not measured (the profiler "
                  f"saw no device time)")
            continue
        print(f"wide&deep {name}: device busy "
              f"{100 * trace['busy_share']:.1f}% of one profiled "
              f"{WD_EPOCHS}-epoch fit ({trace['kernel_ms']:.3f} ms of "
              f"kernels, {trace['kernel_ms'] / steps:.4f} a step); the "
              f"embedding gradient (index_put sort + accumulate) "
              f"{100 * trace['embedding_grad_share']:.1f}% of kernel "
              f"time; top kernels {json.dumps(trace['top'])}")

    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"wide&deep loss gate: {losses}")

    # -- captured against eager in the FeatureSet's order ----------------
    order = dispatch.device_permutation
    dispatch.device_permutation = (
        lambda n, seed, device: torch.from_numpy(
            np.random.default_rng(seed).permutation(n)).to(device))
    try:
        init_zoo_context(conf=wide_deep_conf(True))
        a = wide_deep_estimator(info)
        ha = wide_deep_fit(a, fs, WD_EPOCHS, keyed=True)
    finally:
        dispatch.device_permutation = order
    init_zoo_context(conf=wide_deep_conf(False))
    b = wide_deep_estimator(info)
    hb = wide_deep_fit(b, fs, WD_EPOCHS, keyed=False)
    out["captured_vs_eager"] = bits_or_close(
        f"wide&deep captured vs eager fit, {WD_EPOCHS} per-epoch losses",
        ha, hb,
        WD_LOSS_REL_TOL, absolute=False)
    out["captured_vs_eager"]["losses"] = ha
    check(ha[-1] < ha[0], f"wide&deep captured fit loss gate: {ha}")
    del a, b

    # -- transform against predict; the NNModel file in a child ----------
    init_zoo_context(conf=wide_deep_conf(False))
    pred = fitted.transform(table)["prediction"]
    want = probs_to_classes(model.predict(prep(table), batch_size=WD_BATCH))
    check(pred.dtype == np.int32 and np.array_equal(pred, want),
          "wide&deep: transform's prediction is not predict's argmax")
    acc = float((pred == table["label"]).mean())
    out["train_accuracy"] = acc
    print(f"wide&deep: NNClassifierModel.transform = argmax(predict) on "
          f"{WD_ROWS} rows; training accuracy {acc:.4f}")
    tmp = tempfile.mkdtemp(prefix="wide_deep_")
    try:
        path = os.path.join(tmp, "fitted.nnmodel")
        fitted.save(path)
        check(next(model.parameters()).device.type == model.device.type,
              "wide&deep: save moved the live model off its device")
        npy = os.path.join(tmp, "child.npy")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", WD_CHILD.format(repo=REPO, path=path,
                                                   out=npy)],
            capture_output=True, text=True, timeout=300, cwd=REPO)
        check(proc.returncode == 0,
              f"wide&deep child failed: {proc.stdout}{proc.stderr[-3000:]}")
        child = np.load(npy)
        check(np.array_equal(child, pred),
              "wide&deep: the child's NNModel.load(...).transform differs "
              "from this process's predictions")
        print(f"wide&deep: NNModel.save ({os.path.getsize(path)} bytes) + "
              f"NNModel.load(...).transform in a child: the same {WD_ROWS} "
              f"predictions bit for bit ({time.perf_counter() - t0:.1f}s; "
              f"{proc.stdout.strip()})")

        # -- the Estimator's model_dir resume, multi_optimizer slots -----
        def estimator(d):
            return wide_deep_estimator(info, {"dense": "sgd"}, d)

        whole = estimator(os.path.join(tmp, "whole"))
        h_whole = wide_deep_fit(whole, fs, 3, keyed=True)
        cut_dir = os.path.join(tmp, "cut")
        wide_deep_fit(estimator(cut_dir), fs, 2, keyed=True)
        from analytics_zoo_tpu_torch.utils.checkpoint import \
            CheckpointManager
        steps_ep = fs.steps_per_epoch(WD_BATCH)
        mgr = CheckpointManager(cut_dir)
        check(mgr.latest() == 2 * steps_ep,
              f"wide&deep: newest snapshot {mgr.latest()}")
        meta = json.load(open(os.path.join(
            cut_dir, f"ckpt-{2 * steps_ep}", "manifest.json")))["meta"]
        check("opt_state_order" not in meta,
              f"wide&deep: multi_optimizer snapshot not in optax order "
              f"{meta}")
        resumed = estimator(cut_dir)
        h_res = wide_deep_fit(resumed, fs, 1, keyed=True)
        check(resumed.model.finished_epochs == 3 and len(h_res) == 1,
              f"wide&deep: the resume ran epochs "
              f"{resumed.model.finished_epochs}")
        pw = torch.cat([p.detach().flatten()
                        for p in whole.model.parameters()])
        pr = torch.cat([p.detach().flatten()
                        for p in resumed.model.parameters()])
        out["estimator_resume"] = bits_or_close(
            "wide&deep Estimator resumed from ckpt after epoch 2 vs "
            "uninterrupted, parameters", pr.cpu().numpy(), pw.cpu().numpy(), WD_PARAM_TOL,
            absolute=True)
        out["estimator_resume"]["epoch3_loss"] = [h_res[0], h_whole[2]]
        print(f"wide&deep: Estimator({{'dense': 'sgd'}}, model_dir) epoch 3 "
              f"loss resumed {h_res[0]!r} vs uninterrupted {h_whole[2]!r}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"wide&deep phase: {out['phase_s']:.1f}s")
    return out


REL_CFG = TRAIN_CFG
REL_DEVICE = "cuda"
REL_CAPTURE_CFG = CAPTURE_CFG
REL_EPOCHS = 3
#: train.grads plan of part (c): (call, kind, scale); the spike's scale
#: clears spike_factor 10 past the EWMA's five warm-up steps
REL_FAULTS = ((3, "nan_grad", 1.0), (10, "spike", 1e4), (17, "nan_loss", 1.0))
#: seconds the SIGTERM child's epoch-1 callback waits for the signal
REL_SIGNAL_WAIT_S = 60.0

#: the SIGTERM child (part e): imports only the port; one JSON argument
REL_CHILD = r"""
import hashlib, json, sys, time
args = json.loads(sys.argv[1])
sys.path.insert(0, args["repo"])
import numpy as np
from analytics_zoo_tpu_torch.common.context import init_zoo_context
from analytics_zoo_tpu_torch.common.triggers import Trigger
from analytics_zoo_tpu_torch.pipeline.api.keras.training import \
    TrainingPreempted
from analytics_zoo_tpu_torch.tfpark.bert_classifier import BERTClassifier


class Never(Trigger):
    def __call__(self, state):
        return False


init_zoo_context(conf=args["conf"])
data = np.load(args["data"])
x = [data["x%d" % i] for i in range(args["n_x"])]
y = data["y"]
model = BERTClassifier(**args["cfg"], device=args["device"]).init_weights()
model.compile(optimizer="adamw", loss="scce", lr=2e-5)
# a resume-only run reads the directory and writes no snapshot
model.set_checkpoint(args["dir"], keep=2,
                     trigger=None if args["signal"] else Never())


def callback(record):
    if args["signal"] and record["epoch"] == 1:
        print("EPOCH1", flush=True)
        deadline = time.time() + args["wait_s"]
        while (not model._loop._preempted.is_set()
               and time.time() < deadline):
            time.sleep(0.005)

try:
    model.fit(x, y, batch_size=args["batch"], nb_epoch=args["nb_epoch"],
              callbacks=[callback])
except TrainingPreempted:
    print("PREEMPTED " + json.dumps(
        {"iteration": model.finished_iterations}), flush=True)
    sys.exit(3)
print("DONE " + json.dumps({
    "epochs": model.finished_epochs,
    "sha256": {n: hashlib.sha256(p.detach().cpu().numpy().tobytes())
               .hexdigest() for n, p in model.named_parameters()}}),
    flush=True)
"""


class Never:
    """A trigger that never fires: a resume-only fit writes nothing."""

    def __call__(self, state):
        return False


class EventLog:
    """An in-memory event sink: the registry's events of one kind."""

    def __init__(self):
        self.events = []

    def write(self, event):
        self.events.append(dict(event))

    def of(self, kind):
        return [e for e in self.events if e["kind"] == kind]


class CallsAtAnomaly:
    """An event sink noting, at each ``train.anomaly`` event, the flagged
    iteration and the ``train.grads`` site calls (steps dispatched) the
    plan had seen when the host read that step's flags."""

    def __init__(self, plan):
        self.plan = plan
        self.seen = []

    def write(self, event):
        if event["kind"] == "train.anomaly":
            self.seen.append((event["iteration"],
                              self.plan.calls("train.grads")))


def param_digest(model):
    import hashlib
    return {n: hashlib.sha256(p.detach().cpu().numpy().tobytes()).hexdigest()
            for n, p in model.named_parameters()}


def max_param_diff(a, b):
    """Largest |a - b| over the leaves of two parameter dicts."""
    return max(float((a[n].float() - b[n].float()).abs().max()) for n in a)


def reliability_phase():
    """Slice 15 at BERT-base width (``REL_CFG``, bf16 compute, f32 params,
    AdamW 2e-5, batch 32, the 256 ``training_data`` records, 3 epochs of 8
    steps a run, every run from the same initial weights):

    (a) checkpoint cost in turns — no checkpoint, ``EveryEpoch``,
        ``EveryEpoch``, no checkpoint (keep 2): samples/s, each save's
        on-path snapshot copy and its writer's time and bytes; the
        checkpointed runs end on the unchecked runs' bits (or within the
        two unchecked runs' difference, printed as a fault), every
        snapshot verifies and ``ckpt_cli verify`` exits 0;
    (b) resume and serve: a second model object resumes a copy of (a)'s
        directory at ``ckpt-16`` and ends on the unchecked run's bits;
        ``InferenceModel.load_checkpoint`` answers within 2e-2 of its
        ``predict``; a flipped byte makes ``ckpt_cli verify`` exit 2 and a
        restore fall back to ``ckpt-16`` with ``zoo_ckpt_corrupt_total`` 1;
    (c) ``zoo.train.sentinel=recover`` under a ``train.grads`` plan
        (``REL_FAULTS``): one anomaly of each kind, 3 skipped steps, the
        events at iterations 3, 10, 17, finite params, no rollback, 12
        launches a step of K2, K3a and K3b; with an empty plan
        ``recover`` gives sentinel-off's bits; samples/s in turns (off,
        recover, recover, off);
    (d) rollback: ``max_skips_per_epoch=1`` and two ``nan_grad`` in epoch
        2 of a checkpointed fit: one rollback to ``ckpt-8``, the replay
        skipping the two flagged steps, finite params at epoch 3;
    (e) SIGTERM: a child process (``REL_CHILD``) fitting with
        ``zoo.checkpoint.on_sigterm`` is signalled at its epoch-1
        callback and exits through ``TrainingPreempted`` with a snapshot
        past iteration 8 (the signal-to-commit time printed); a second
        child resumes it and finishes, writing nothing; its final
        params' SHA-256 per leaf equal this process's resume from the
        same snapshot (a mid-epoch snapshot re-streams its epoch from the
        first batch, as in the JAX loop, so they are not the
        uninterrupted run's: the difference is printed);
    (f) captured (``REL_CAPTURE_CFG``, batch 8, ``scan_steps=4``):
        ``recover`` with an empty plan gives the captured sentinel-off
        bits; a ``nan_grad`` at call 5 (the second chunk) is skipped in the
        replay, the count ends one below the steps, and the params are the
        eager guarded run's; ``device_cache`` is turned off with the
        warning; ``zoo_jit_compile_total`` counts the captures;
    (g) goodput: on (c)'s and (d)'s fits goodput plus badput is the
        ledger's wall within 1%.
    Returns the summary and the K2/K3a/K3b launches of the phase."""
    import shutil
    import signal
    import tempfile

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common import faults
    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.observability import (MetricsRegistry,
                                                       default_registry)
    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import (
        KERNEL, KERNEL_BWD_DKV, KERNEL_BWD_DQ)
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import reset_uids
    from analytics_zoo_tpu_torch.pipeline.api.keras.training import (
        _param_tree, _SentinelMonitor, _shape_of)
    from analytics_zoo_tpu_torch.pipeline.inference.inference_model import \
        InferenceModel
    from analytics_zoo_tpu_torch.tfpark.bert_classifier import \
        BERTClassifier
    from analytics_zoo_tpu_torch.utils import checkpoint as ckpt_mod
    from analytics_zoo_tpu_torch.utils.checkpoint import CheckpointManager

    counters = (KERNEL, KERNEL_BWD_DQ, KERNEL_BWD_DKV)
    for c in counters:
        c.reset()
    root = tempfile.mkdtemp(prefix="zoo-reliability-")
    base_conf = {"zoo.pallas.attention": True,
                 "zoo.compute.dtype": "bfloat16", "zoo.seed": 0}
    reg = default_registry()
    events = EventLog()
    reg.add_event_sink(events)
    real_snapshot = ckpt_mod._snapshot_leaves
    out = {}
    try:
        init_zoo_context(conf=base_conf)
        reset_uids()
        x, y, _ = training_data(N_RECORDS)
        t0 = time.perf_counter()
        model = BERTClassifier(**REL_CFG, device=REL_DEVICE).init_weights()
        start = [p.detach().clone() for p in model.parameters()]
        print(f"reliability: BERT-base built in "
              f"{time.perf_counter() - t0:.1f}s")

        # the snapshot copy on the step path, timed where it runs
        snap_ms = []

        def timed_snapshot(tree):
            t = time.perf_counter()
            leaves = real_snapshot(tree)
            snap_ms.append(1e3 * (time.perf_counter() - t))
            return leaves
        ckpt_mod._snapshot_leaves = timed_snapshot

        def run(conf=None, ckpt=None, plan=None, nb_epoch=REL_EPOCHS,
                net=model, init=True, trigger=None):
            """One fit of ``net`` from the initial weights (unless
            ``init`` is False) under ``conf``, checkpointing into ``ckpt``
            on ``trigger`` (``EveryEpoch``); returns (history, records,
            wall seconds, the loop)."""
            init_zoo_context(conf={**base_conf, **(conf or {})})
            if init:
                with torch.no_grad():
                    for p, s in zip(net.parameters(), start):
                        p.copy_(s)
                net.opt_state = None
                net.finished_epochs = net.finished_iterations = 0
            net._checkpoint = None
            net.compile(optimizer="adamw", loss="scce", lr=2e-5)
            if ckpt is not None:
                net.set_checkpoint(ckpt, keep=2, trigger=trigger)
            records = []
            t = time.perf_counter()
            with (faults.activate(plan) if plan is not None
                  else contextlib.nullcontext()):
                hist = net.fit(x, y, batch_size=T_BATCH, nb_epoch=nb_epoch,
                               callbacks=[records.append])
            torch.cuda.synchronize() if REL_DEVICE == "cuda" else None
            return hist, records, time.perf_counter() - t, net._loop

        def params_of(net):
            return {n: p.detach().clone() for n, p in net.named_parameters()}

        def samples_per_s(records):
            return float(np.mean([r["throughput"] for r in records[1:]]))

        def bits_equal(a, b):
            return all(torch.equal(a[n], b[n]) for n in a)

        # -- (a) checkpoint cost in turns, after one warm-up epoch --------
        run(nb_epoch=1)
        a_runs, final = [], {}
        for i, with_ckpt in enumerate((False, True, True, False)):
            d = os.path.join(root, f"a{i}") if with_ckpt else None
            before = len(events.of("ckpt.save"))
            snap_ms.clear()
            hist, records, wall, _ = run(ckpt=d)
            saves = events.of("ckpt.save")[before:]
            final[i] = params_of(model)
            a_runs.append({
                "checkpoint": "EveryEpoch" if with_ckpt else None,
                "fit_samples_per_s": REL_EPOCHS * N_RECORDS / wall,
                "samples_per_s": samples_per_s(records),
                "epoch_samples_per_s": [r["throughput"] for r in records],
                "wall_s": wall, "snapshot_copy_ms": list(snap_ms),
                "writer_ms": [1e3 * e["dur_s"] for e in saves],
                "snapshot_bytes": [e["bytes"] for e in saves]})
            print(f"reliability (a) run {i} ({a_runs[-1]['checkpoint']}): "
                  f"{a_runs[-1]['fit_samples_per_s']:.2f} samples/s over "
                  f"the fit ({wall:.2f}s, the last writer joined), "
                  f"{a_runs[-1]['samples_per_s']:.2f} in epochs 2-3's "
                  f"records; snapshot copies ms "
                  f"{[round(v, 1) for v in snap_ms]}, writers ms "
                  f"{[round(v, 1) for v in a_runs[-1]['writer_ms']]}, "
                  f"bytes {a_runs[-1]['snapshot_bytes']}")
        control_diff = max_param_diff(final[0], final[3])
        if control_diff:
            print(f"reliability FAULT: two uninterrupted BERT-base fits "
                  f"differ by {control_diff:.3e} (max |a - b|); the resume "
                  f"gates are held at that difference")
        for i in (1, 2):
            diff = max_param_diff(final[i], final[0])
            check(diff <= control_diff, f"(a) checkpointed run {i} differs "
                  f"from the unchecked run by {diff}")
            mgr = CheckpointManager(os.path.join(root, f"a{i}"),
                                    registry=MetricsRegistry())
            check(mgr.steps() == [16, 24], f"(a) snapshots {mgr.steps()}")
            check(all(mgr.verify(s)[0] == "ok" for s in mgr.steps()),
                  f"(a) run {i}: a snapshot does not verify")
        cli = [sys.executable, "-m", "analytics_zoo_tpu_torch.utils.ckpt_cli"]
        r = subprocess.run(cli + ["verify", os.path.join(root, "a1")],
                           capture_output=True, text=True, cwd=REPO,
                           timeout=300)
        check(r.returncode == 0, f"(a) ckpt_cli verify: {r.returncode} "
              f"{r.stdout} {r.stderr}")
        out["checkpoint_cost"] = {"runs": a_runs,
                                  "control_max_diff": control_diff}
        shutil.rmtree(os.path.join(root, "a1"))

        # -- (b) resume and serve ----------------------------------------
        resume_dir = os.path.join(root, "b")
        shutil.move(os.path.join(root, "a2"), resume_dir)
        shutil.rmtree(os.path.join(resume_dir, "ckpt-24"))
        fresh = BERTClassifier(**REL_CFG, device=REL_DEVICE).init_weights(
            torch.Generator().manual_seed(1))
        t = time.perf_counter()
        _, records, wall, _ = run(ckpt=resume_dir, nb_epoch=1, net=fresh,
                                  init=False)
        resumed = params_of(fresh)
        diff = max_param_diff(resumed, final[0])
        print(f"reliability (b): a fresh model resumed ckpt-16 and trained "
              f"epoch {fresh.finished_epochs} in {wall:.2f}s; max |diff| "
              f"against the uninterrupted run {diff:.3e}")
        check(fresh.finished_epochs == 3 and records[0]["epoch"] == 3,
              f"(b) resumed at {records[0]['epoch']}")
        check(diff <= control_diff, f"(b) resume differs by {diff}")
        batch = [a[:T_BATCH] for a in x]
        served = InferenceModel(device=REL_DEVICE).load_checkpoint(
            BERTClassifier(**REL_CFG, device=REL_DEVICE).init_weights(
                torch.Generator().manual_seed(2)), resume_dir)
        serve_err = float(np.max(np.abs(served.predict(batch)
                                        - fresh.predict(batch))))
        print(f"reliability (b): load_checkpoint answers within "
              f"{serve_err:.2e} of the trained model's predict (2e-2)")
        check(serve_err <= 2e-2, f"(b) load_checkpoint predict {serve_err}")
        del served
        flip = os.path.join(resume_dir, "ckpt-24", "params.npz")
        with open(flip, "r+b") as f:
            f.seek(os.path.getsize(flip) // 2)
            b = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([b[0] ^ 0xFF]))
        r = subprocess.run(cli + ["verify", resume_dir], capture_output=True,
                           text=True, cwd=REPO, timeout=300)
        check(r.returncode == 2, f"(b) verify after a flip: {r.returncode}")
        probe = MetricsRegistry()
        got = CheckpointManager(resume_dir, registry=probe).restore_latest(
            {"params": _param_tree({n: _shape_of(p) for n, p in
                                    fresh.model.named_parameters()})})
        corrupt = probe.snapshot()["zoo_ckpt_corrupt_total"]["value"]
        check(got is not None and got[0] == 16 and corrupt == 1,
              f"(b) fallback to {got and got[0]}, corrupt {corrupt}")
        print(f"reliability (b): after one flipped byte verify exits 2 and "
              f"a restore falls back to ckpt-16 (zoo_ckpt_corrupt_total "
              f"{corrupt:g})")
        out["resume"] = {"max_diff": diff, "serve_max_err": serve_err,
                         "verify_rc_after_flip": r.returncode,
                         "fallback_step": got[0]}
        shutil.rmtree(resume_dir)

        # -- (c) the sentinel under a fault plan, then its cost in turns --
        anomaly_keys = ['zoo_train_anomaly_total{kind="nan_loss"}',
                        'zoo_train_anomaly_total{kind="nan_grad"}',
                        'zoo_train_anomaly_total{kind="spike"}',
                        "zoo_train_skipped_steps_total",
                        "zoo_train_rollback_total"]

        def counts():
            snap = reg.snapshot()
            return {k: snap.get(k, {}).get("value", 0) for k in anomaly_keys}

        plan = faults.FaultPlan(seed=0)
        for call, kind, scale in REL_FAULTS:
            plan.add("train.grads", kind, at=(call,), scale=scale)
        recover = {"zoo.train.sentinel": "recover",
                   "zoo.faults.enabled": True}
        c0, e0 = counts(), len(events.of("train.anomaly"))
        launches0 = [c.launches for c in counters]
        _, _, _, loop_c = run(conf=recover, plan=plan)
        launches_c = [c.launches - l for c, l in zip(counters, launches0)]
        delta = {k: v - c0[k] for k, v in counts().items()}
        anomalies = events.of("train.anomaly")[e0:]
        print(f"reliability (c): counters {json.dumps(delta)}; events at "
              f"iterations {[e['iteration'] for e in anomalies]} "
              f"({[e['kinds'] for e in anomalies]}); K2/K3a/K3b "
              f"{launches_c}")
        check([delta[k] for k in anomaly_keys] == [1, 1, 1, 3, 0],
              f"(c) counters {delta}")
        check([e["iteration"] for e in anomalies] == [3, 10, 17],
              f"(c) events {anomalies}")
        check(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
              "(c) non-finite params")
        want = REL_CFG["n_block"] * REL_EPOCHS * (N_RECORDS // T_BATCH)
        check(REL_DEVICE != "cuda" or launches_c == [want] * 3,
              f"(c) launches {launches_c}, want {want}")
        check(model.opt_state["count"] == REL_EPOCHS * 8 - 3,
              f"(c) count {model.opt_state['count']}")
        gp = {"sentinel": loop_c._goodput}
        turns = []
        for conf in (None, recover, recover, None):
            _, records, _, _ = run(
                conf=conf, plan=(faults.FaultPlan(seed=0) if conf
                                 else None))
            turns.append((conf is not None, samples_per_s(records),
                          params_of(model)))
        for sen, sps, params in turns:
            check(bits_equal(params, final[0]) or max_param_diff(
                params, final[0]) <= control_diff,
                  f"(c) {'recover' if sen else 'off'} with an empty plan "
                  f"is not sentinel-off's bits")
        off_sps = [s for sen, s, _ in turns if not sen]
        rec_sps = [s for sen, s, _ in turns if sen]
        cost = 1 - np.mean(rec_sps) / np.mean(off_sps)
        print(f"reliability (c): samples/s in turns off/recover/recover/off "
              f"{[round(s, 2) for _, s, _ in turns]}: the norm, flags and "
              f"select cost {100 * cost:.2f}%; recover with an empty plan "
              f"gives sentinel-off's bits")
        out["sentinel"] = {"counters": delta, "events": [
            e["iteration"] for e in anomalies], "launches": launches_c,
            "samples_per_s_turns": [s for _, s, _ in turns],
            "cost_fraction": float(cost)}
        del turns

        # -- (d) rollback ------------------------------------------------
        d_dir = os.path.join(root, "d")
        c0, r0 = counts(), len(events.of("train.rollback"))
        plan = faults.FaultPlan(seed=1).add("train.grads", "nan_grad",
                                            at=(10, 13))
        seen = CallsAtAnomaly(plan)
        reg.add_event_sink(seen)
        try:
            _, records, wall, loop_d = run(
                conf={**recover, "zoo.train.max_skips_per_epoch": 1},
                ckpt=d_dir, plan=plan)
        finally:
            reg.remove_event_sink(seen)
        delta = {k: v - c0[k] for k, v in counts().items()}
        rollbacks = events.of("train.rollback")[r0:]
        print(f"reliability (d): counters {json.dumps(delta)}; rollback "
              f"events {rollbacks}; epochs {[r['epoch'] for r in records]} "
              f"in {wall:.2f}s")
        # fault n: each dispatch's flags are read LAG dispatches late, as
        # the JAX loop reads them, or at the epoch's end (step 16 here)
        lag = _SentinelMonitor.LAG
        want = [(it, min(it + lag + 1, 16)) for it in (10, 13)]
        calls = plan.calls("train.grads")
        print(f"reliability (d): train.grads site calls {calls}; anomalies "
              f"(iteration, site calls when the host read them) "
              f"{seen.seen}, the escalation at iteration {seen.seen[-1][0]} "
              f"read after {seen.seen[-1][1]} calls (JAX lag {lag}: "
              f"{want})")
        check(seen.seen == want and calls == 16 + 6 + 8,
              f"(d) flags not read at the JAX lag: {seen.seen}, {calls} "
              f"site calls")
        check(delta["zoo_train_rollback_total"] == 1
              and len(rollbacks) == 1
              and rollbacks[0]["restore_step"] == 8,
              f"(d) rollback {delta} {rollbacks}")
        check(delta["zoo_train_skipped_steps_total"] == 4,
              f"(d) 2 skipped and 2 not replayed: {delta}")
        check(model.finished_epochs == REL_EPOCHS
              and all(bool(torch.isfinite(p).all())
                      for p in model.parameters()), "(d) final state")
        gp["rollback"] = loop_d._goodput
        out["rollback"] = {"counters": delta,
                           "restore_step": rollbacks[0]["restore_step"],
                           "train_grads_calls": calls,
                           "anomalies_read_at_calls": seen.seen}
        shutil.rmtree(d_dir)

        # -- (g) goodput on (c) and (d) -----------------------------------
        out["goodput"] = {}
        for name, led in gp.items():
            sec = led.seconds()
            total = led.goodput_seconds() + sum(led.badput_seconds().values())
            print(f"reliability (g) {name}: wall {led.wall():.3f}s, "
                  f"categories {json.dumps({k: round(v, 4) for k, v in sec.items()})}")
            check(abs(total - led.wall()) <= 0.01 * led.wall(),
                  f"(g) {name}: goodput + badput {total} vs {led.wall()}")
            out["goodput"][name] = {"wall_s": led.wall(), "seconds": sec}

        # -- (e) SIGTERM in a child, resumed in another ---------------------
        e_dir = os.path.join(root, "e")
        data = os.path.join(root, "data.npz")
        np.savez(data, y=y, **{f"x{i}": a for i, a in enumerate(x)})
        args = {"repo": REPO, "data": data, "n_x": len(x), "cfg": REL_CFG,
                "device": REL_DEVICE, "batch": T_BATCH, "dir": e_dir,
                "conf": {**base_conf, "zoo.checkpoint.on_sigterm": True},
                "signal": True, "wait_s": REL_SIGNAL_WAIT_S,
                "nb_epoch": REL_EPOCHS}
        child = subprocess.Popen([sys.executable, "-c", REL_CHILD,
                                  json.dumps(args)], stdout=subprocess.PIPE,
                                 text=True, cwd=REPO)
        try:
            line = child.stdout.readline()
            check(line.strip() == "EPOCH1", f"(e) child said {line!r}")
            t_signal = time.time()
            os.kill(child.pid, signal.SIGTERM)
            rest = child.communicate(timeout=600)[0]
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        check(child.returncode == 3 and "PREEMPTED" in rest,
              f"(e) child exit {child.returncode}: {rest}")
        cut = json.loads(rest.split("PREEMPTED ", 1)[1].splitlines()[0])
        step = cut["iteration"]
        manifest = os.path.join(e_dir, f"ckpt-{step}", "manifest.json")
        commit_s = os.path.getmtime(manifest) - t_signal
        check(step > 8 and CheckpointManager(
            e_dir, registry=MetricsRegistry()).verify(step)[0] == "ok",
              f"(e) snapshot ckpt-{step}")
        print(f"reliability (e): SIGTERM at the epoch-1 callback; the child "
              f"committed ckpt-{step} {commit_s:.2f}s after the signal and "
              f"exited through TrainingPreempted")
        # the resumes read the directory and write nothing to it
        args2 = dict(args, signal=False, conf=base_conf,
                     nb_epoch=REL_EPOCHS - 1)
        r = subprocess.run([sys.executable, "-c", REL_CHILD,
                            json.dumps(args2)], capture_output=True,
                           text=True, cwd=REPO, timeout=600)
        check(r.returncode == 0 and "DONE " in r.stdout,
              f"(e) resume child {r.returncode}: {r.stdout} {r.stderr[-2000:]}")
        done = json.loads(r.stdout.split("DONE ", 1)[1].splitlines()[0])
        run(ckpt=e_dir, nb_epoch=REL_EPOCHS - 1, net=fresh,
            trigger=Never())
        mine = param_digest(fresh)
        same = done["sha256"] == mine and done["epochs"] == REL_EPOCHS
        vs_uninterrupted = max_param_diff(params_of(fresh), final[0])
        print(f"reliability (e): the resumed child's final params, SHA-256 "
              f"per leaf, equal this process's resume from ckpt-{step}: "
              f"{same}; against the uninterrupted run (the resumed epoch "
              f"re-streams from its first batch, as in the JAX loop) max "
              f"|diff| {vs_uninterrupted:.3e}")
        check(same, "(e) the resumed child differs from this process's "
              "resume of the same snapshot")
        out["sigterm"] = {"snapshot_step": step, "signal_to_commit_s":
                          commit_s, "resumed_sha256_equal": same,
                          "max_diff_vs_uninterrupted": vs_uninterrupted}
        shutil.rmtree(e_dir)
        del fresh, model, start, final

        # -- (f) the guarded captured step --------------------------------
        out["captured"] = captured_guard_part(base_conf)
    finally:
        ckpt_mod._snapshot_leaves = real_snapshot
        reg.remove_event_sink(events)
        shutil.rmtree(root, ignore_errors=True)
    launches = [c.launches for c in counters]
    out["launches"] = dict(zip(("flash_attention_fwd",
                                "flash_attention_bwd_dq",
                                "flash_attention_bwd_dkv"), launches))
    print(f"reliability: K2/K3a/K3b launches over the phase {launches}")
    check(REL_DEVICE != "cuda" or all(n > 0 for n in launches),
          f"reliability launches {launches}")
    return out


def captured_guard_part(base_conf):
    """Part (f) of :func:`reliability_phase`: the captured configuration
    (``scan_steps=4``, 8 steps an epoch: two replays) with the sentinel."""
    import logging

    import torch

    from analytics_zoo_tpu_torch.common import faults
    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.observability import default_registry
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import reset_uids
    from analytics_zoo_tpu_torch.tfpark.bert_classifier import \
        BERTClassifier
    init_zoo_context(conf=base_conf)
    reset_uids()
    x, y, _ = training_data(CAPTURE_BATCH * CAPTURE_STEPS)
    model = BERTClassifier(**dict(REL_CAPTURE_CFG, hidden_drop=0.0),
                           device=REL_DEVICE).init_weights()
    start = [p.detach().clone() for p in model.parameters()]
    reg = default_registry()

    def compiles():
        return reg.snapshot().get("zoo_jit_compile_total", {}).get("value", 0)

    def fit(scan, sentinel, plan_at=None, cache=False):
        conf = {**base_conf, "zoo.train.scan_steps": scan,
                "zoo.train.device_cache": cache}
        if sentinel:
            conf.update({"zoo.train.sentinel": "recover",
                         "zoo.faults.enabled": True})
        init_zoo_context(conf=conf)
        with torch.no_grad():
            for p, s in zip(model.parameters(), start):
                p.copy_(s)
        model.opt_state = None
        model.finished_epochs = model.finished_iterations = 0
        model.compile(optimizer="adamw", loss="scce", lr=2e-5)
        plan = faults.FaultPlan(seed=0)
        if plan_at is not None:
            plan.add("train.grads", "nan_grad", at=(plan_at,))
        c0 = compiles()
        with (faults.activate(plan) if sentinel else contextlib.nullcontext()):
            model.fit(x, y, batch_size=CAPTURE_BATCH, nb_epoch=1,
                      shuffle=False)
        program = model._loop._program
        graphs = len(program[1].graphs) if program is not None else 0
        return ({n: p.detach().clone() for n, p in model.named_parameters()},
                model.opt_state["count"], compiles() - c0, graphs,
                len(plan.fired))

    def same(a, b):
        return all(torch.equal(a[n], b[n]) for n in a)

    off, off_count, off_c, off_g = fit(4, False)[:4]
    empty, empty_count, empty_c, empty_g = fit(4, True)[:4]
    warnings = []
    handler = logging.Handler()
    handler.emit = lambda record: warnings.append(record.getMessage())
    logger = logging.getLogger("analytics_zoo_tpu_torch")
    logger.addHandler(handler)
    try:
        skip, skip_count, skip_c, skip_g, fired = fit(4, True, plan_at=5,
                                                      cache=True)
    finally:
        logger.removeHandler(handler)
    eager, eager_count = fit(1, True, plan_at=5)[:2]
    rel = max(float(((skip[n] - eager[n]).norm()
                     / eager[n].norm().clamp_min(1e-30))) for n in skip)
    warned = any("zoo.train.device_cache disabled for this fit" in w
                 for w in warnings)
    cuda = REL_DEVICE == "cuda"
    print(f"reliability (f) captured (2 blocks, batch {CAPTURE_BATCH}, "
          f"scan_steps 4): recover with an empty plan gives the captured "
          f"sentinel-off bits {same(off, empty)}; nan_grad at call 5 "
          f"({fired} fired) skipped in the replay: count {skip_count} of "
          f"{CAPTURE_STEPS} steps; against the eager guarded run the same "
          f"bits {same(skip, eager)} (largest relative difference "
          f"{rel:.2e}), eager count {eager_count}; device_cache turned off "
          f"with the warning {warned}; zoo_jit_compile_total "
          f"{off_c}/{empty_c}/{skip_c} for {off_g}/{empty_g}/{skip_g} "
          f"captured graphs")
    check(same(off, empty), "(f) recover with an empty plan is not the "
          "captured sentinel-off bits")
    check(fired == 1 and skip_count == CAPTURE_STEPS - 1
          and eager_count == CAPTURE_STEPS - 1,
          f"(f) count {skip_count}/{eager_count}, fired {fired}")
    check(same(skip, eager) or rel <= 1e-6, f"(f) captured guarded run vs "
          f"the eager one: {rel}")
    check(warned, "(f) device_cache was not turned off with the warning")
    check((off_c, empty_c, skip_c) == (off_g, empty_g, skip_g)
          and (not cuda or min(off_g, empty_g, skip_g) >= 1),
          f"(f) compiles {(off_c, empty_c, skip_c)} vs graphs "
          f"{(off_g, empty_g, skip_g)}")
    return {"empty_plan_same_bits": same(off, empty),
            "skip_count": skip_count, "eager_same_bits": same(skip, eager),
            "max_rel_diff": rel, "device_cache_warning": warned,
            "compiles": [off_c, empty_c, skip_c]}


# ---------------------------------------------------------------------------
# slice 19: C8, the image int8 cells, transfer learning, ResNet-50 serving
# and training with BatchNorm
# ---------------------------------------------------------------------------

#: the JAX bench's image configurations (bench.py:568-796, 982-1228)
IMG_HW = 112
IMG_CLASSES, IMG_TRAIN, IMG_BATCH, IMG_REPS, IMG_WINDOWS = 8, 512, 32, 16, 4
IMG_AGREE_FLOOR = 97.0          # int8_top1_agreement_pct (bench.py:1521)
TRANSFER_N, TRANSFER_CHUNK = 2048, 512
RESNET_CLASSES, RESNET_FRAMES, RESNET_BATCH = 1000, 256, 32
RESNET_TRAIN_STEPS = 8
#: C8's shapes: (name, batch, h, w, c, f, k, stride, dilation, bias,
#: relu). Every distinct conv of VGG-16's two static paths (bias and
#: ReLU, batch 32 and 1 at 112 pixels), ResNet-50's stem (no bias, its
#: BatchNorm after), Inception-v1's stem (bias and ReLU), both 7x7/2 with
#: XLA's (2, 3) pads, a dilated AtrousConvolution2D, and SSD300's fc6 and
#: its F = 126 head
VGG_CONVS = [(3, 64, 112), (64, 64, 112), (64, 128, 56), (128, 128, 56),
             (128, 256, 28), (256, 256, 28), (256, 512, 14),
             (512, 512, 14), (512, 512, 7)]
C8_CASES = ([(f"vgg_b{b}_{c}x{f}_{hw}", b, hw, hw, c, f, 3, 1, 1, True,
              True) for b in (32, 1) for c, f, hw in VGG_CONVS]
            + [("resnet50_stem_b32", 32, 112, 112, 3, 64, 7, 2, 1, False,
                False),
               ("inception_v1_stem_b32", 32, 112, 112, 3, 64, 7, 2, 1, True,
                True),
               ("atrous_d2_b32_64x64_56", 32, 56, 56, 64, 64, 3, 1, 2, True,
                True),
               # SSD300's fc6 (atrous, dilation 6) and its widest head
               # (F = 126: a 504-byte output row)
               ("ssd_fc6_b32_512x1024_19", 32, 19, 19, 512, 1024, 3, 1, 6,
                True, True),
               ("ssd_mbox1_conf_b32_1024x126_19", 32, 19, 19, 1024, 126, 3,
                1, 1, True, False)])


def c8_bound(m, k, n, x_elems, bias):
    """C8's least time: x read once (f32), the int8 weights, w_scale (and
    bias) read, the f32 output written once, against 2 M N K operations
    at the int8 peak."""
    t_bytes = (x_elems * 4 + 4 + k * n + n * 4 * (2 if bias else 1)
               + m * n * 4) / PEAK_BYTES_PER_S
    t_ops = 2.0 * m * n * k / PEAK_FLOPS["int8"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def im2col_int_mm(x, xs, w_q, w_scale, bias, relu, strides, dilation, pads):
    """The library route of a static int8 conv, timed beside C8 (the port
    never calls it): quantize, zero-pad, im2col (each activation written
    kh * kw times), the padded ``torch._int_mm`` (``int8_product``), then
    the f32 epilogue in the static path's order."""
    import torch
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        int8_product, quantize_static)
    (kh, kw, c, f), (sh, sw), (dh, dw) = w_q.shape, strides, dilation
    (lh, hh), (lw, hw) = pads
    xq = F.pad(quantize_static(x, xs), (0, 0, lw, hw, lh, hh))
    b = xq.shape[0]
    cols = xq.unfold(1, (kh - 1) * dh + 1, sh).unfold(2, (kw - 1) * dw + 1,
                                                      sw)
    cols = cols[..., ::dh, ::dw]            # (B, Ho, Wo, C, kh, kw)
    ho, wo = cols.shape[1], cols.shape[2]
    a = cols.permute(0, 1, 2, 4, 5, 3).reshape(b * ho * wo, kh * kw * c)
    y = int8_product(a, w_q.reshape(kh * kw * c, f)).float() * (
        xs * w_scale)
    if bias is not None:
        y = y + bias
    if relu:
        y = torch.relu(y)
    return y.reshape(b, ho, wo, f)


def c8_kernel_phase():
    """C8 against its plain version (the exact float64 conv of the int8
    values, on the card) bit for bit at ``C8_CASES``, the same bits twice
    (the wrapper's own repack, then the one made beforehand) and the same
    bits as the library route; the quantize pass and the repack bit for
    bit their plain versions; each timed: the wrapper, its CUDA-graph
    device time, the plain version, the library route (im2col and the
    padded ``_int_mm``), cuDNN's fp32 conv at the same shape (TF32 off),
    the bound, and on the wgmma routes the quantize pass's and the
    repack's own device and wrapper times beside their plain versions'."""
    import torch
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        KERNEL_INT8_CONV, KERNEL_INT8_CONV_QUANTIZE, KERNEL_INT8_CONV_REPACK,
        LAST_CONV_LAUNCH, conv_takes_kmajor, quantize_static,
        repack_conv_weight, repack_conv_weight_reference, static_int8_conv2d,
        static_int8_conv2d_reference, static_int8_quantize)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.convolution \
        import o_major, same_pads
    counters = (KERNEL_INT8_CONV, KERNEL_INT8_CONV_REPACK,
                KERNEL_INT8_CONV_QUANTIZE)
    rows = {}
    for name, b, h, w, c, f, k, s, d, bias, relu in C8_CASES:
        g = torch.Generator().manual_seed(b * 131 + c * 7 + f + k)
        x = (torch.randn(b, h, w, c, generator=g) * 2.0).cuda()
        x.view(-1)[:3] = torch.tensor([0.125, -0.375, 6.4])   # .5 ties
        xs = torch.tensor(0.05).cuda()
        wq = torch.randint(-127, 128, (k, k, c, f), generator=g,
                           dtype=torch.int8).cuda()
        ws = (torch.rand(f, generator=g) * 0.01 + 1e-3).cuda()
        bb = torch.randn(f, generator=g).cuda() if bias else None
        st, dil = (s, s), (d, d)
        pads = [same_pads(n, k, s, d) for n in (h, w)]
        args = (x, xs, wq, ws, bb, relu, st, dil, pads)
        kmajor = conv_takes_kmajor(c)
        before = [cnt.launches for cnt in counters]
        out = static_int8_conv2d(*args)          # repacks the weight itself
        route, splits = LAST_CONV_LAUNCH.route, LAST_CONV_LAUNCH.splits
        wk = repack_conv_weight(wq) if kmajor else None
        again = static_int8_conv2d(*args, w_kmajor=wk)
        torch.cuda.synchronize()
        launches, repacks, quantizes = (cnt.launches - n for cnt, n in
                                        zip(counters, before))
        ref = static_int8_conv2d_reference(*args)
        lib = im2col_int_mm(*args)
        same = {what: torch.equal(out.view(torch.int32),
                                  want.view(torch.int32))
                for what, want in (("plain_cuda", ref), ("second_run", again),
                                   ("im2col_int_mm", lib))}
        if kmajor:
            same["quantize_pass"] = torch.equal(
                static_int8_quantize(x, xs), quantize_static(x, xs))
            same["repack"] = torch.equal(wk, repack_conv_weight_reference(wq))
        err = (out - ref).abs().max().item()
        check(all(same.values()) and launches == 2
              and (repacks, quantizes) == ((2, 2) if kmajor else (0, 0)),
              f"C8 {name}: not the plain version's bits {same} (max |diff| "
              f"{err}), launches {launches}, repacks {repacks}, quantize "
              f"passes {quantizes}")
        m = out.shape[0] * out.shape[1] * out.shape[2]
        bound_ms, bound_by = c8_bound(m, k * k * c, f, x.numel(), bias)
        wf = o_major(wq.float())                        # cuDNN's layout
        (lh, hh), (lw, hw) = pads
        xf = F.pad(x, (0, 0, 0, hw - lw, 0, hh - lh)).permute(0, 3, 1, 2)
        iters = 20 if m * f * k * k * c < 1e10 else 5
        row = {"case": name, "batch": b, "hw": [h, w], "c": c, "f": f,
               "k": k, "stride": s, "dilation": d, "pads": pads,
               "m": m, "kdim": k * k * c, "route": route, "splits": splits,
               "bit_equal": same,
               "max_abs_err": err, "launches": launches,
               "ms": time_ms(lambda: static_int8_conv2d(*args, w_kmajor=wk),
                             iters=iters),
               "device_ms": graph_ms(lambda: static_int8_conv2d(
                   *args, w_kmajor=wk), iters=iters),
               "plain_ms": time_ms(lambda: static_int8_conv2d_reference(
                   *args), iters=3, warmup=1),
               "library_ms": time_ms(lambda: im2col_int_mm(*args),
                                     iters=iters),
               "library_by": "im2col + padded torch._int_mm (int8_product)",
               "cudnn_fp32_ms": time_ms(lambda: F.conv2d(
                   xf, wf.permute(3, 2, 0, 1), stride=st, padding=(lh, lw),
                   dilation=dil), iters=iters),
               "bound_ms": bound_ms, "bound_by": bound_by}
        if kmajor:
            kdim = k * k * c
            row.update({
                "quantize_ms": time_ms(lambda: static_int8_quantize(x, xs),
                                       iters=iters),
                "quantize_device_ms": graph_ms(
                    lambda: static_int8_quantize(x, xs), iters=iters),
                "quantize_plain_ms": time_ms(
                    lambda: quantize_static(x, xs), iters=iters),
                "quantize_bound_ms": x.numel() * 5 / PEAK_BYTES_PER_S * 1e3,
                "repack_ms": time_ms(lambda: repack_conv_weight(wq),
                                     iters=iters),
                "repack_device_ms": graph_ms(
                    lambda: repack_conv_weight(wq), iters=iters),
                "repack_plain_ms": time_ms(
                    lambda: repack_conv_weight_reference(wq), iters=iters),
                "repack_bound_ms": 2 * kdim * f / PEAK_BYTES_PER_S * 1e3})
        rows[name] = row
        print(f"c8 kernel case {json.dumps(row)}")
        del x, wq, out, again, ref, lib, xf, wf, wk
    torch.cuda.empty_cache()
    return rows


#: how many of VGG-16's 13 convs each distinct shape of ``VGG_CONVS`` is
VGG_CONV_COUNT = {(256, 256, 28): 2, (512, 512, 14): 2, (512, 512, 7): 3}


def c8_profile(fn, gemms=13, tries=3):
    """``fn()`` under ``torch.profiler``: the device ms of C8's kernels
    (``conv_int8_*``) summed by kernel and in all, beside all the device
    kernels' ms. CUPTI can drop records late in a long process, so a
    trace that holds fewer than ``gemms`` of C8's GEMM kernels is taken
    again, up to ``tries`` times; ``complete`` says whether the last one
    held them all. None when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with torch.no_grad():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        by_name, counts, total = {}, {}, 0.0
        for e in prof.events():
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or not is_kernel_event(e.name)):
                continue
            us = e.time_range.end - e.time_range.start
            total += us
            name = kernel_name(e.name)
            if "conv_int8" in name:
                by_name[name] = by_name.get(name, 0.0) + us / 1e3
                counts[name] = counts.get(name, 0) + 1
        found = sum(n for name, n in counts.items()
                    if "wgmma" in name or "igemm" in name)
        if found == gemms:
            break
    if not total:
        return None
    return {"c8_ms": sum(by_name.values()), "by_kernel": by_name,
            "launches_by_kernel": counts, "complete": found == gemms,
            "all_kernels_ms": total / 1e3}


def c8_vgg_sums(c8_rows):
    """C8's device ms (a CUDA-graph replay of the wrapper: the quantize
    pass and the GEMM) summed over VGG-16's 13 convs at 112 pixels, batch
    32 and batch 1, beside their bounds and cuDNN's fp32 convs."""
    out = {}
    for b in (32, 1):
        rows = [(c8_rows[f"vgg_b{b}_{c}x{f}_{hw}"],
                 VGG_CONV_COUNT.get((c, f, hw), 1))
                for c, f, hw in VGG_CONVS]
        for key in ("device_ms", "bound_ms", "cudnn_fp32_ms"):
            out[f"vgg16_b{b}_{key}_sum"] = sum(r[key] * n for r, n in rows)
    return out


def c8_kernel_row(c8_rows, launches):
    """C8's row of the kernels line: at VGG-16's static batch-32 conv1_2
    (64 -> 64 at 112 pixels, the path's largest), every other case's
    numbers beside it in ``cases``."""
    main = c8_rows["vgg_b32_64x64_112"]
    row = {"name": "static_int8_conv2d", "route": "cuda",
           "source": "analytics_zoo_tpu_torch/csrc/conv_int8.cu",
           "replaces": "analytics_zoo_tpu/pipeline/api/keras/layers/"
                       "convolution.py:134 (Convolution2D.quantized_call; "
                       "XLA conv_general_dilated, no Pallas kernel)",
           "launches": sum(launches.values()),
           "launches_by_path": launches,
           "max_abs_err": max(r["max_abs_err"] for r in c8_rows.values()),
           "ms": main["ms"], "plain_ms": main["plain_ms"],
           "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
           "library_ms": main["library_ms"],
           "library_by": main["library_by"],
           "device_ms": main["device_ms"],
           "cudnn_fp32_ms": main["cudnn_fp32_ms"],
           "main_route": main["route"],
           **c8_vgg_sums(c8_rows),
           "cases": {name: {key: r[key] for key in (
               "ms", "device_ms", "plain_ms", "library_ms", "cudnn_fp32_ms",
               "bound_ms", "bound_by", "launches", "route", "splits",
               "quantize_device_ms", "repack_device_ms") if key in r}
               for name, r in c8_rows.items()}}
    return row


def c8_pass_rows(c8_rows, quantize_launches, repack_launches):
    """The rows of C8's two passes in the kernels line, at VGG-16's
    batch-32 conv1_2 (the quantize pass's largest input; the repack of its
    weight): the quantize pass (its launches in the static predicts) and
    the weight repack (its launches at the static install)."""
    main = c8_rows["vgg_b32_64x64_112"]
    replaces = ("analytics_zoo_tpu/pipeline/api/keras/layers/"
                "convolution.py:138 (Convolution2D.quantized_call's "
                "quantize; XLA, no Pallas kernel)")
    src = "analytics_zoo_tpu_torch/csrc/conv_int8.cu"
    kmajor = [r for r in c8_rows.values() if "quantize_ms" in r]
    return [
        {"name": "static_int8_quantize", "route": "cuda", "source": src,
         "replaces": replaces,
         "launches": sum(quantize_launches.values()),
         "launches_by_path": quantize_launches,
         "max_abs_err": 0 if all(r["bit_equal"]["quantize_pass"]
                                 for r in kmajor) else None,
         "ms": main["quantize_ms"], "device_ms": main["quantize_device_ms"],
         "plain_ms": main["quantize_plain_ms"],
         "bound_ms": main["quantize_bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "library_by": "none: torch.quantize_per_tensor clips to -128 and "
                       "multiplies by 1 / scale, another function"},
        {"name": "repack_conv_weight", "route": "cuda", "source": src,
         "replaces": "analytics_zoo_tpu/pipeline/api/keras/layers/"
                     "convolution.py:139 (the HWIO int8 weight XLA's conv "
                     "reads; no Pallas kernel)",
         "launches": sum(repack_launches.values()),
         "launches_by_path": repack_launches,
         "max_abs_err": 0 if all(r["bit_equal"]["repack"]
                                 for r in kmajor) else None,
         "ms": main["repack_ms"], "device_ms": main["repack_device_ms"],
         "plain_ms": main["repack_plain_ms"],
         "bound_ms": main["repack_bound_ms"], "bound_by": "bytes",
         "library_ms": main["repack_plain_ms"],
         "library_by": "w.reshape(K, F).t().contiguous(), one copy kernel "
                       "(also the plain version)"}]


def image_int8_phase():
    """``bench_int8_inference`` (``bench.py:636-796``) on the port: VGG-16
    at 112 pixels with an 8-class head trained 3 epochs (Adam 1e-4, batch
    64) on 512 seeded prototype images, served fp32 and static int8
    (calibrated on ``xeval[:8]``) at batch 32 over 16 device-resident
    rolled batches (``image_infer_{fp32,int8}_fps``, best of 4 windows;
    ``int8_top1_agreement_pct`` gated at 97.0); AlexNet trained 16 epochs
    (Adam 3e-4) scored on 512 held-out images fp32 and int8
    (``image_top1_*``, ``int8_top1_delta_pct``); the batch-1 device ms of
    each path's captured ``_forward`` (``image_infer_*_b1_fps``,
    ``int8_b1_speedup``); C8's weight repacks at the static install;
    C8's (by route, with its quantize passes) and Q8's launches in one
    batch-32 and one batch-1 predict, C8's kernels' device ms in one
    forward of each, and the device kernels of one static batch-1
    forward."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.feature.feature_set import FeatureSet
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        ImageClassifier
    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        KERNEL_INT8_CONV, KERNEL_INT8_CONV_QUANTIZE, KERNEL_INT8_CONV_REPACK,
        KERNEL_INT8_CONV_ROUTES, KERNEL_INT8_STATIC,
        KERNEL_INT8_STATIC_ROUTES)
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    init_zoo_context(conf={"zoo.compute.dtype": "float32", "zoo.seed": 0})
    rng = np.random.default_rng(2)
    hw, classes = IMG_HW, IMG_CLASSES
    protos = rng.normal(size=(classes, hw, hw, 3)).astype(np.float32)
    y = rng.integers(0, classes, IMG_TRAIN).astype(np.int32)
    x = (protos[y] * 0.6
         + rng.normal(size=(IMG_TRAIN, hw, hw, 3)) * 0.8).astype(np.float32)
    out = {}
    m = ImageClassifier("vgg-16", num_classes=classes,
                        input_shape=(hw, hw, 3)).init_weights()
    m.compile(optimizer="adam", loss="scce", lr=1e-4)
    t0 = time.perf_counter()
    hist = m.fit(FeatureSet.array(x, y, seed=0), batch_size=64, nb_epoch=3)
    out["vgg16_train_s"] = time.perf_counter() - t0
    out["vgg16_loss"] = hist["loss"]
    check(bool(np.all(np.isfinite(hist["loss"]))), f"VGG-16 loss {hist}")

    ye = rng.integers(0, classes, IMG_BATCH)
    xeval = (protos[ye] * 0.6 + rng.normal(size=(IMG_BATCH, hw, hw, 3))
             * 0.8).astype(np.float32)
    xs = torch.from_numpy(np.stack([np.roll(xeval, i + 1, axis=0)
                                    for i in range(IMG_REPS)])).cuda()
    KERNEL_INT8_CONV_REPACK.reset()
    models = {"fp32": InferenceModel().from_keras(m),
              "int8": InferenceModel().from_keras(m, quantize="int8",
                                                  calibrate=xeval[:8])}
    torch.cuda.synchronize()
    check(len(models["int8"]._act_scales) == 16,
          f"VGG-16 calibrated {len(models['int8']._act_scales)} layers")
    # C8's weight repack: once for each conv past the 3-channel stem, at
    # the static install
    out["repack_launches_install"] = KERNEL_INT8_CONV_REPACK.launches
    check(out["repack_launches_install"] == 12,
          f"static VGG-16 install: {out['repack_launches_install']} "
          f"repacks")
    tops = {}
    for mode, im in models.items():
        def many(stacked):
            return torch.stack([im._forward([xb]).argmax(-1)
                                for xb in stacked])
        with torch.no_grad():
            tops[mode] = many(xs).cpu().numpy()
            best = 0.0
            for w in range(IMG_WINDOWS):
                xs_w = torch.roll(xs, w + 1, dims=1)   # a fresh buffer
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                many(xs_w).cpu()                         # readback
                best = max(best, IMG_REPS * IMG_BATCH
                           / (time.perf_counter() - t0))
        out[f"image_infer_{mode}_fps"] = best
    agree = float((tops["fp32"] == tops["int8"]).mean()) * 100.0
    out["int8_top1_agreement_pct"] = agree
    check(agree >= IMG_AGREE_FLOOR, f"int8_top1_agreement_pct {agree} "
          f"below the floor {IMG_AGREE_FLOOR}")

    # C8's and Q8's launches a predict, batch 32 and batch 1: C8 on
    # c8_small_c for the 3-channel conv, on its wgmma routes for the other
    # 12 (each after one quantize pass, on the repack made at install)
    im8 = models["int8"]
    c8_counters = {"c8": KERNEL_INT8_CONV, "q8": KERNEL_INT8_STATIC,
                   "c8_quantize": KERNEL_INT8_CONV_QUANTIZE,
                   "c8_repack": KERNEL_INT8_CONV_REPACK,
                   **KERNEL_INT8_CONV_ROUTES, **KERNEL_INT8_STATIC_ROUTES}
    for tag, xb in (("b32", xeval), ("b1", xeval[:1])):
        for cnt in c8_counters.values():
            cnt.reset()
        im8.predict(xb)
        torch.cuda.synchronize()
        got = {key: cnt.launches for key, cnt in c8_counters.items()}
        out[f"launches_{tag}"] = {"c8": got["c8"], "q8": got["q8"]}
        out[f"c8_routes_{tag}"] = got
        check(out[f"launches_{tag}"] == {"c8": 13, "q8": 3},
              f"static VGG-16 {tag} predict: {out[f'launches_{tag}']}")
        check(got["c8_small_c"] == 1
              and got["c8_wgmma"] + got["c8_split"] == 12
              and got["c8_quantize"] == 12 and got["c8_repack"] == 0,
              f"static VGG-16 {tag} predict's C8 routes: {got}")
        # C8's kernels' device time in one predict's forward, by kernel
        out[f"c8_profile_{tag}"] = c8_profile(
            lambda: im8._forward([torch.from_numpy(xb).cuda()]))

    # batch 1: the device time of each path's captured _forward
    x1 = torch.from_numpy(xeval[:1]).cuda()
    b1 = {}
    with torch.no_grad():
        for mode, im in models.items():
            b1[mode] = graph_ms(lambda: im._forward([x1]), iters=10)
            out[f"image_infer_{mode}_b1_fps"] = 1000.0 / b1[mode]
        out["int8_b1_speedup"] = b1["fp32"] / b1["int8"]
        out["int8_b1_device_kernels"] = device_kernels(
            lambda: im8._forward([x1]))
    out["b1_device_ms"] = b1

    # the accuracy oracle: AlexNet
    am = ImageClassifier("alexnet", num_classes=classes,
                         input_shape=(hw, hw, 3)).init_weights()
    am.compile(optimizer="adam", loss="scce", lr=3e-4)
    t0 = time.perf_counter()
    ahist = am.fit(FeatureSet.array(x, y, seed=0), batch_size=64,
                   nb_epoch=16)
    out["alexnet_train_s"] = time.perf_counter() - t0
    check(ahist["loss"][-1] < ahist["loss"][0], f"AlexNet loss {ahist}")
    n_eval = 512
    y_acc = rng.integers(0, classes, n_eval).astype(np.int32)
    x_acc = (protos[y_acc] * 0.6 + rng.normal(size=(n_eval, hw, hw, 3))
             * 1.1).astype(np.float32)
    for mode, quant in (("fp32", None), ("int8", "int8")):
        aim = InferenceModel().from_keras(
            am, quantize=quant, calibrate=x[:8] if quant else None)
        pred = np.concatenate([aim.predict(x_acc[i:i + 64]).argmax(-1)
                               for i in range(0, n_eval, 64)])
        out[f"image_top1_{mode}_pct"] = float((pred == y_acc).mean()) * 100
    out["int8_top1_delta_pct"] = (out["image_top1_fp32_pct"]
                                  - out["image_top1_int8_pct"])
    for key in ("image_infer_fp32_fps", "image_infer_int8_fps",
                "int8_top1_agreement_pct", "image_top1_fp32_pct",
                "image_top1_int8_pct"):
        check(np.isfinite(out[key]) and out[key] > 0, f"{key} {out[key]}")
    print(f"image int8 {json.dumps(out)}")
    del m, am, models, im8, xs
    torch.cuda.empty_cache()
    return out


def transfer_phase():
    """``bench_transfer_learning`` (``bench.py:568-633``): Inception-v1 at
    112 pixels, 2048 seeded images on the card, the backbone cut at the
    pooled features (``model.new_graph(["gap"])``) run once in chunks of
    512 under ``no_grad``; the features stay on the card and a
    ``Dense(2)`` head trains 2 epochs at batch 64 from them
    (``zoo.train.device_cache``: the set is gathered on the card).
    ``transfer_learn_imgs_per_sec`` = images / (extract + head fit), the
    median of 3 timed runs after a warm-up."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.feature.feature_set import FeatureSet
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        ImageClassifier
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense

    init_zoo_context(conf={"zoo.compute.dtype": "float32", "zoo.seed": 0,
                           "zoo.train.device_cache": True})
    n, hw = TRANSFER_N, IMG_HW
    rng = np.random.default_rng(4)
    x = rng.normal(size=(n, hw, hw, 3)).astype(np.float32)
    y = rng.integers(0, 2, n).astype(np.int32)
    m = ImageClassifier("inception-v1", num_classes=1000,
                        input_shape=(hw, hw, 3)).init_weights()
    extractor = m.model.new_graph(["gap"])
    head = Sequential([Dense(2, activation="softmax", input_shape=(1024,))])
    head.init_weights()
    head.compile(optimizer="adam", loss="scce", lr=1e-3)
    x_dev = torch.from_numpy(x).cuda()
    y_dev = torch.from_numpy(y).cuda()
    info = {}

    def run():
        with torch.no_grad():
            feats = torch.cat([extractor(x_dev[i:i + TRANSFER_CHUNK])
                               for i in range(0, n, TRANSFER_CHUNK)])
        info["feats_device"] = str(feats.device)
        return head.fit(FeatureSet.array(feats, y_dev, seed=0),
                        batch_size=64, nb_epoch=2)

    run()                                          # warm-up
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = run()
        times.append(time.perf_counter() - t0)
    check(info["feats_device"].startswith("cuda")
          and bool(np.all(np.isfinite(hist["loss"]))),
          f"transfer: features on {info['feats_device']}, loss {hist}")
    out = {"transfer_learn_imgs_per_sec": n / float(np.median(times)),
           "seconds": times, "loss": hist["loss"]}
    print(f"transfer {json.dumps(out)}")
    del m, extractor, head, x_dev
    torch.cuda.empty_cache()
    return out


class CountedModel:
    """A served model that counts the serve loop's dispatches, their rows
    and each dispatch call's host seconds."""

    def __init__(self, im):
        self.im, self.dispatches, self.rows, self.host_s = im, 0, 0, 0.0

    def predict_async(self, x, block=True):
        t0 = time.perf_counter()
        collect = self.im.predict_async(x, block=block)
        if collect is not None:
            self.dispatches += 1
            self.rows += len(x)
            self.host_s += time.perf_counter() - t0
        return collect

    def summary(self):
        n = max(self.dispatches, 1)
        return {"dispatches": self.dispatches,
                "rows_per_dispatch": self.rows / n,
                "host_ms_per_dispatch": self.host_s / n * 1e3}


def resnet_serving_phase():
    """``bench_serving`` (``bench.py:982-1052``): ResNet-50 at 112 pixels,
    1000 classes, fp32, ``InferenceModel(concurrent_num=2)`` behind
    ``ClusterServing(batch_size=32)`` on a ``LocalBackend``, 256 frames
    from 4 producer threads, a warm pass then the median of 3
    (``serving_resnet50_records_per_sec``); then ``bench_serving_device``
    (``bench.py:1130-1228``): the same model's raw predict FPS at batch 32
    against pre-filled drains (``max_inflight=4``, fresh server a pass,
    median of 3 after a warm pass) of the fp32 model, the weight-only
    int8 model (K6 on the 2048 x 1000 head: its launches counted over the
    lane's timed passes) and both multiplexed; every answer checked
    (shape, finite, summing to 1). The fp32 server's dispatches are
    counted (rows a dispatch, host ms a dispatch call, the wait for a
    permit included), the last fp32 drain's goodput split printed, and
    the device kernels of one batch-32 forward counted by name (cuDNN's
    layout conversions among them)."""
    import threading

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        ImageClassifier
    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        KERNEL_INT8_MATMUL, KERNEL_INT8_ROUTES)
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving import (ClusterServing, InputQueue,
                                                 LocalBackend, OutputQueue)

    init_zoo_context(conf={"zoo.compute.dtype": "float32", "zoo.seed": 0,
                           "zoo.goodput.enabled": True})
    hw, n, batch = IMG_HW, RESNET_FRAMES, RESNET_BATCH
    rng = np.random.default_rng(5)
    m = ImageClassifier("resnet-50", num_classes=RESNET_CLASSES,
                        input_shape=(hw, hw, 3)).init_weights()
    frames = rng.normal(size=(n, hw, hw, 3)).astype(np.float32)

    def good(a):
        return (a is not None and a.shape == (RESNET_CLASSES,)
                and bool(np.all(np.isfinite(a)))
                and abs(float(a.sum()) - 1.0) < 1e-3)

    im = CountedModel(InferenceModel(concurrent_num=2).from_keras(m))
    backend = LocalBackend()
    serving = ClusterServing(im, backend=backend, batch_size=batch).start()
    inq, outq = InputQueue(backend), OutputQueue(backend)

    def run(tag):
        t0 = time.perf_counter()

        def producer(lo, hi):
            for i in range(lo, hi):
                inq.enqueue(f"{tag}-{i}", frames[i])
        threads = [threading.Thread(target=producer,
                                    args=(j * n // 4, (j + 1) * n // 4))
                   for j in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i in range(n):
            a = outq.query(f"{tag}-{i}", timeout=120.0)
            # the message names the record only: an f-string holding
            # ``a`` would print 1000 floats on every answer, on the clock
            check(good(a), f"serving record {tag}-{i} is not a finite "
                  f"distribution of {RESNET_CLASSES}")
        return n / (time.perf_counter() - t0)

    try:
        run("warm")
        rates = [run("t1"), run("t2"), run("t3")]
    finally:
        serving.stop(drain=False)
    out = {"serving_resnet50_records_per_sec": float(np.median(rates)),
           "serving_resnet50_passes": rates,
           "serving_resnet50_dispatches": im.summary()}

    im32 = InferenceModel(concurrent_num=4).from_keras(m)
    im8 = InferenceModel(concurrent_num=4).from_keras(m, quantize="int8")

    def raw_fps(model):
        model.predict(frames[:batch])
        best = 0.0
        for _ in range(3):
            t0 = time.perf_counter()
            for lo in range(0, n, batch):
                model.predict(frames[lo:lo + batch])
            best = max(best, n / (time.perf_counter() - t0))
        return best

    splits = {}

    def served_rps(models, route=None, tag_=""):
        backend = LocalBackend(maxlen=4 * n)
        inq, outq = InputQueue(backend), OutputQueue(backend)
        rates, k6 = [], 0
        for k in range(4):              # pass 0 warm, then 3 timed
            tag = f"p{k}"
            for i in range(n):
                inq.enqueue(f"{tag}-{i}", frames[i],
                            model=route[i % len(route)] if route else None)
            server = ClusterServing(models, backend=backend,
                                    batch_size=batch, block_ms=10,
                                    max_inflight=4)
            before = KERNEL_INT8_MATMUL.launches
            t0 = time.perf_counter()
            server.start()
            try:
                for i in range(n):
                    a = outq.query(f"{tag}-{i}", timeout=120.0)
                    check(good(a), f"serving-device record {tag}-{i} is "
                          f"not a finite distribution")
                if k:
                    rates.append(n / (time.perf_counter() - t0))
                    k6 += KERNEL_INT8_MATMUL.launches - before
            finally:
                server.stop(drain=False)
        if tag_:
            splits[tag_] = goodput_split(f"resnet50 {tag_}",
                                         server._goodput.snapshot())
        return float(np.median(rates)), k6

    raw = raw_fps(im32)
    served, _ = served_rps(im32, tag_="fp32 drain")
    skinny0 = KERNEL_INT8_ROUTES["skinny"].launches
    served_int8, k6_int8 = served_rps(im8)
    served_mm, k6_mm = served_rps({"fp32": im32, "int8": im8},
                                  route=["fp32", "int8"])
    check(k6_int8 >= 3 * n // batch,
          f"the int8 lane launched K6 {k6_int8} times in 3 passes")
    out.update({
        "serving_device_raw_fps": raw,
        "serving_device_records_per_sec": served,
        "serving_device_gap_x": raw / served,
        "serving_device_int8_records_per_sec": served_int8,
        "serving_device_multimodel_records_per_sec": served_mm,
        "k6_launches": {"int8_lane": k6_int8, "multimodel": k6_mm},
        "k6_skinny_launches": (KERNEL_INT8_ROUTES["skinny"].launches
                               - skinny0),
        "goodput_s": splits})
    x32 = torch.from_numpy(frames[:batch]).cuda()
    with torch.no_grad():
        names = device_kernels(lambda: im32._forward([x32]))
    counts = {}
    for name in names:
        counts[name] = counts.get(name, 0) + 1
    out["forward_kernels"] = {"total": len(names), "by_name": counts}
    print(f"resnet serving {json.dumps(out)}")
    del m, im, im32, im8
    torch.cuda.empty_cache()
    return out


def _resnet_fit(x, y, conf, epochs, plan=None, timed=False):
    """ResNet-50 at 112 pixels, 1000 classes, fp32, Adam 1e-3, batch 32
    from the same seeded weights; ``epochs`` fits of one epoch each (the
    last timed when ``timed``). Returns the model, its step losses, its
    moving statistics and params (host copies) and the timed epoch's
    seconds."""
    import torch

    from analytics_zoo_tpu_torch.common import faults
    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        ImageClassifier
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
        named_state, reset_uids)
    init_zoo_context(conf={"zoo.compute.dtype": "float32", "zoo.seed": 0,
                           **conf})
    reset_uids()
    m = ImageClassifier("resnet-50", num_classes=RESNET_CLASSES,
                        input_shape=(IMG_HW, IMG_HW, 3)).init_weights(
                            torch.Generator().manual_seed(0))
    m.compile(optimizer="adam", loss="scce", lr=1e-3)
    seconds = None
    for e in range(epochs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if plan is None:
            m.fit(x, y, batch_size=RESNET_BATCH, nb_epoch=1, shuffle=False)
        else:
            with faults.activate(plan):
                m.fit(x, y, batch_size=RESNET_BATCH, nb_epoch=1,
                      shuffle=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    losses = [v for a in m._loop.step_losses for v in a.tolist()]
    state = {k: v.detach().cpu().clone()
             for k, v in named_state(m.model).items()}
    params = {k: v.detach().cpu().clone()
              for k, v in m.model.named_parameters()}
    return m, losses, state, params, seconds if timed else None


def resnet_training_phase():
    """ResNet-50 training with BatchNorm (no JAX channel times it): 112
    pixels, batch 32, 8 steps an epoch, fp32, ``cudnn.deterministic``.
    Eager: a warm-up epoch and a timed one (samples/s), then a profiled
    epoch's busy share. Captured (``zoo.train.scan_steps`` 8): the same
    two epochs, whose step losses and 106 moving-statistics tensors must
    be the eager fit's bits. Then ``zoo.train.sentinel=recover`` with a
    ``nan_grad`` at the 8th step: the statistics and params must be the
    bits of the guarded fit of the first 7 steps (the skip keeps the
    pre-step state)."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common import faults
    torch.backends.cudnn.deterministic = True
    try:
        rng = np.random.default_rng(7)
        n = RESNET_TRAIN_STEPS * RESNET_BATCH
        x = rng.normal(size=(n, IMG_HW, IMG_HW, 3)).astype(np.float32)
        y = rng.integers(0, RESNET_CLASSES, n).astype(np.int32)
        out = {}
        eager, e_loss, e_state, e_params, e_s = _resnet_fit(
            x, y, {}, 2, timed=True)
        out["eager_samples_per_s"] = n / e_s
        share, kernel_ms = profiled_busy_share(lambda: eager.fit(
            x, y, batch_size=RESNET_BATCH, nb_epoch=1, shuffle=False))
        out["eager_busy_share"], out["eager_kernel_ms"] = share, kernel_ms
        del eager
        keyed, k_loss, k_state, _, k_s = _resnet_fit(
            x, y, {"zoo.train.scan_steps": RESNET_TRAIN_STEPS}, 2,
            timed=True)
        out["captured_samples_per_s"] = n / k_s
        share, kernel_ms = profiled_busy_share(lambda: keyed.fit(
            x, y, batch_size=RESNET_BATCH, nb_epoch=1, shuffle=False))
        out["captured_busy_share"] = share
        out["captured_kernel_ms"] = kernel_ms
        del keyed
        out["losses"] = {"eager": e_loss, "captured": k_loss}
        check(len(e_state) == 106 and all(
            torch.equal(e_state[k], k_state[k]) for k in e_state)
            and e_loss == k_loss,
              "ResNet-50: the captured fit's losses or moving statistics "
              "are not the eager fit's bits")
        check(not torch.equal(e_state["res5c_c_bn.moving_var"],
                              torch.ones_like(e_state[
                                  "res5c_c_bn.moving_var"])),
              "ResNet-50: the moving statistics did not move")
        out["statistics_bits_equal"] = True

        guard = {"zoo.faults.enabled": True, "zoo.train.sentinel": "recover"}
        plan = faults.FaultPlan(seed=1).add(
            "train.grads", "nan_grad", at=(RESNET_TRAIN_STEPS - 1,))
        _, _, p_state, p_params, _ = _resnet_fit(x, y, guard, 1, plan=plan)
        _, _, r_state, r_params, _ = _resnet_fit(
            x[:-RESNET_BATCH], y[:-RESNET_BATCH], guard, 1)
        same = (all(torch.equal(p_state[k], r_state[k]) for k in p_state)
                and all(torch.equal(p_params[k], r_params[k])
                        for k in p_params))
        check(same, "ResNet-50 recover: the skipped step moved the "
              "statistics or the params")
        out["recover_skip_keeps_statistics"] = True
        print(f"resnet training {json.dumps(out)}")
        torch.cuda.empty_cache()
        return out
    finally:
        torch.backends.cudnn.deterministic = False


# ---------------------------------------------------------------------------
# slice 21: the recurrent family (TextClassifier, AnomalyDetector,
# SessionRecommender, Seq2seq), ConvLSTM2D and Convolution3D, and the JAX
# bench's sentinel channel
# ---------------------------------------------------------------------------

#: TextClassifier at the class defaults (200-wide tokens, 500 a sequence,
#: encoder output 256), news20's 20 classes, a frozen 5,000 x 200 table
TC_VOCAB, TC_DIM, TC_SEQ, TC_OUT, TC_CLASSES = 5000, 200, 500, 256, 20
TC_BATCH, TC_ROWS, TC_SCAN = 128, 512, 4
#: the fits' timed epochs (eager, captured) by encoder: windows of about
#: half a second or more on the H100
TC_EPOCHS = {"cnn": (24, 24), "lstm": (1, 3), "gru": (1, 2)}
#: records served a window (about 0.2-0.4 s for cnn, 0.5 s for lstm on
#: the H100), windows a mode, the modes in turns
TC_SERVE_ROWS = {"cnn": 8192, "lstm": 128}
TC_SERVE_WINDOWS = 3
#: int8 against fp32: the least top-1 agreement (the VGG-16 phase's
#: floor); the weight-only forward against the same forward on K6's
#: plain version, on the probabilities (4.5e-8 at most on the H100)
TC_TOP1_FLOOR_PCT, TC_PLAIN_TOL = 97.0, 1e-6
#: examples/anomaly_detection.py: unroll 24, one feature, hidden (8, 32,
#: 15), batch 64; a seeded 100,000-point series
AD_POINTS, AD_UNROLL, AD_BATCH, AD_ROWS, AD_SCAN = 100_000, 24, 64, 1024, 8
AD_EPOCHS = (1, 5)
#: SessionRecommender at its defaults with history on (10 items a session
#: and of history)
SR_ITEMS, SR_BATCH, SR_ROWS, SR_SCAN = 10_000, 512, 4096, 8
SR_EPOCHS = (2, 14)
#: examples/seq2seq_chatbot.py: a 12-token vocabulary, 6 steps, batch 64
S2S_VOCAB, S2S_T, S2S_BATCH, S2S_ROWS, S2S_SCAN = 12, 6, 64, 768, 12
#: timed epochs (eager, captured): the LSTM, the two-layer GRU
S2S_EPOCHS = ((3, 18), (2, 10))
#: ConvLSTM2D(64, 3) on Moving-MNIST's (10, 64, 64, 1) clips, batch 16
#: (Shi et al., 2015), and C3D's first layer, Convolution3D 3 -> 64
#: 3x3x3 on (16, 112, 112, 3) clips, batch 8 (Tran et al., 2015)
CONV3D_STEPS = 3
CLSTM_CLIPS, CLSTM_FILTERS = (16, 10, 64, 64, 1), 64
C3D_CLIPS, C3D_FILTERS = (8, 16, 112, 112, 3), 64
#: the JAX bench's sentinel channel (bench.py:847-860): NCF at 6040 x
#: 3706 x 5, batch 8192, 16-step captured dispatches
SENTINEL_STEPS, SENTINEL_CEILING_PCT = 16, 3.0


def replay_ms(program, k, reps=3):
    """Device ms of one replay of a training loop's captured ``k``-step
    block (``StepProgram.replay``; CUDA events around ``reps`` back-to-back
    replays after one untimed replay): its kernels run without host gaps,
    so this is the replay's busy time."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    seeds = list(range(k))
    program.replay(k, seeds)
    start.record()
    for _ in range(reps):
        program.replay(k, seeds)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def capture_seconds(model):
    """The seconds the loop's registry has counted capturing training
    steps (``zoo_jit_compile_seconds`` of ``train.scan_chunk``), over the
    process so far."""
    hist = model._loop._registry.snapshot().get(
        'zoo_jit_compile_seconds{fn="train.scan_chunk"}', {})
    return hist.get("sum", 0.0)


def rnn_fit_in_turns(name, build, x, y, loss, batch, scan, epochs, lr=1e-3):
    """``build()``'s model (the seeded weights, names from a reset uid
    counter) fitted eager, then captured (``zoo.train.scan_steps`` =
    ``scan``, unshuffled as the eager fit), cuDNN deterministic: a
    warm-up epoch (the capture) and then ``epochs`` (eager, captured)
    timed epochs, a fixed count (so the model each mode leaves is the
    same in every run) sized for windows of about half a second on the
    H100. The busy share: eager, of one profiled step; captured, the
    replays' device time (CUDA events) over the timed epochs' wall.
    Returns each mode's samples/s, ms a step, busy share and
    first two epochs' step losses (the captured mode's capture seconds,
    as production captures, and the kernel nodes of one step, from a
    capture of its own) and the captured model; gates the captured step
    losses to the eager ones' bits."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import reset_uids
    n = len(x[0]) if isinstance(x, list) else len(x)
    steps = n // batch
    check(n % batch == 0 and steps % scan == 0,
          f"{name}: {n} rows must be whole chunks of {scan} steps of {batch}")
    x1 = [a[:batch] for a in x] if isinstance(x, list) else x[:batch]
    runs, model = {}, None
    # cuDNN's conv backward sums with atomics unless deterministic: the
    # bits then differ between any two fits, captured or not
    torch.backends.cudnn.deterministic = True
    for mode in ("eager", "captured"):
        del model
        gc.collect()
        conf = {"zoo.seed": 0}
        if mode == "captured":
            conf["zoo.train.scan_steps"] = scan
        init_zoo_context(conf=conf)
        reset_uids()
        model = build()
        model.compile(optimizer="adam", loss=loss, lr=lr)
        captures = capture_seconds(model)
        t0 = time.perf_counter()
        model.fit(x, y, batch_size=batch, nb_epoch=1, shuffle=False)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        losses = list(model._loop.step_losses)
        timed = epochs[0] if mode == "eager" else epochs[1]
        t0 = time.perf_counter()
        for epoch in range(timed):
            model.fit(x, y, batch_size=batch, nb_epoch=1, shuffle=False)
            if epoch == 0:
                losses += model._loop.step_losses
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = {"samples_per_s": timed * n / wall,
               "ms_per_step": 1e3 * wall / (timed * steps),
               "timed_epochs": timed,
               "first_epoch_s": first, "step_losses": np.concatenate(losses)}
        if mode == "eager":
            share, kernel_ms = profiled_busy_share(lambda: model.fit(
                x1, y[:batch], batch_size=batch, nb_epoch=1, shuffle=False))
            run.update(busy_share=share, profiled_step_kernel_ms=kernel_ms)
            how = "of a profiled step"
        else:
            program = model._loop._program[1]
            run["capture_s"] = capture_seconds(model) - captures
            run["replay_ms"] = replay_ms(program, scan)
            share = run["replay_ms"] * timed * (steps // scan) / (1e3 * wall)
            run["busy_share"] = share
            # one step captured on its own (it also runs once, as the
            # capture's warm-up): the loop's graphs are kept as production
            # builds them, which frees each graph's nodes once instantiated
            run["step_kernel_nodes"] = len(device_kernels(
                lambda: program._steps(1), program.noise[:1]))
            how = (f"(replays' device time over the epochs); capture "
                   f"{run['capture_s']:.2f}s, {run['step_kernel_nodes']} "
                   f"kernel nodes a step, a {scan}-step replay "
                   f"{run['replay_ms']:.3f} ms")
        print(f"{name} {mode}: {timed} x {steps} steps of {batch} in "
              f"{wall:.3f}s = {run['samples_per_s']:.1f} samples/s, "
              f"{run['ms_per_step']:.2f} ms/step (first epoch {first:.2f}s)"
              f"; device busy "
              f"{'not measured' if share is None else f'{100 * share:.1f}%'}"
              f" {how}")
        runs[mode] = run
    torch.backends.cudnn.deterministic = False
    want, got = runs["eager"]["step_losses"], runs["captured"]["step_losses"]
    bits = (len(got) == len(want)
            and bool(np.array_equal(got.view(np.int32), want.view(np.int32))))
    print(f"{name}: captured vs eager, {len(want)} step losses, the same "
          f"bits {bits}")
    check(np.isfinite(want).all(), f"{name}: eager losses {want}")
    check(bits, f"{name}: captured step losses {got} are not the eager "
          f"fit's {want}")
    for run in runs.values():
        run["step_losses"] = run["step_losses"].tolist()
    return runs, model


@contextlib.contextmanager
def plain_int8_dense():
    """Within the block, ``Dense`` layers run K6's and Q8's plain versions
    (``int8_matmul_reference``, ``static_int8_dense_reference``) where
    they would launch the kernels."""
    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        int8_matmul_reference, static_int8_dense_reference)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import core
    kept = core.int8_matmul, core.static_int8_dense
    core.int8_matmul = int8_matmul_reference
    core.static_int8_dense = static_int8_dense_reference
    try:
        yield
    finally:
        core.int8_matmul, core.static_int8_dense = kept


def text_classifier_serving(name, model, xs):
    """``model`` through ``InferenceModel`` in fp32, weight-only int8 and
    static int8 (``max_batch_size`` 32: K6's skinny route and Q8 on both
    Dense layers): ``TC_SERVE_WINDOWS`` windows of the records ``xs`` a
    mode, the modes in turns; records/s (median and spread), top-1
    agreement with fp32 and the launches, counted from 0 around each
    window. Each int8 forward of one chunk is held to the same forward on
    the kernels' plain versions. Then a one-lane ``ClusterServing`` of the
    weight-only model."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.observability import MetricsRegistry
    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        KERNEL_INT8_MATMUL, KERNEL_INT8_ROUTES, KERNEL_INT8_STATIC,
        KERNEL_INT8_STATIC_ROUTES)
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving import ClusterServing

    def runtime():
        return InferenceModel(device="cuda", max_batch_size=T_BATCH)
    ims = {"fp32": runtime().from_keras(model),
           "int8_weight_only": runtime().from_keras(model, quantize="int8"),
           "int8_static": runtime().from_keras(model, quantize="int8",
                                               calibrate=xs[:T_BATCH])}
    counters = [KERNEL_INT8_MATMUL, KERNEL_INT8_STATIC,
                *KERNEL_INT8_ROUTES.values(),
                *KERNEL_INT8_STATIC_ROUTES.values()]
    chunk = torch.from_numpy(xs[:T_BATCH]).cuda()
    plain_err = {}
    for mode, im in ims.items():
        im.predict(xs[:T_BATCH])                             # warm-up
        if mode != "fp32":
            got = im._forward([chunk])
            with plain_int8_dense():
                want = im._forward([chunk])
            plain_err[mode] = (got - want).abs().max().item()
            plain_err[f"{mode}_bits_equal"] = same_bits(got, want)
    torch.cuda.synchronize()
    dispatches = -(-len(xs) // T_BATCH)
    out = {mode: {"records_per_s_windows": [], "k6": 0, "k6_skinny": 0,
                  "q8": 0, "q8_routes": dict.fromkeys(
                      KERNEL_INT8_STATIC_ROUTES, 0)} for mode in ims}
    for _ in range(TC_SERVE_WINDOWS):
        probs = {}
        for mode, im in ims.items():
            for c in counters:
                c.reset()
            t0 = time.perf_counter()
            probs[mode] = im.predict(xs)
            wall = time.perf_counter() - t0
            r = out[mode]
            r["records_per_s_windows"].append(len(xs) / wall)
            launched = (KERNEL_INT8_MATMUL.launches,
                        KERNEL_INT8_ROUTES["skinny"].launches,
                        KERNEL_INT8_STATIC.launches)
            want = {"fp32": (0, 0, 0),
                    "int8_weight_only": (2 * dispatches, 2 * dispatches, 0),
                    "int8_static": (0, 0, 2 * dispatches)}[mode]
            check(launched == want, f"{name} {mode}: K6, K6 skinny, Q8 "
                  f"launches {launched}, not {want} for {dispatches} "
                  f"dispatches of two Dense layers")
            r["k6"] += launched[0]
            r["k6_skinny"] += launched[1]
            r["q8"] += launched[2]
            for route, cnt in KERNEL_INT8_STATIC_ROUTES.items():
                r["q8_routes"][route] += cnt.launches
            r["top1_agreement_pct"] = 100.0 * float(np.mean(
                probs[mode].argmax(1) == probs["fp32"].argmax(1)))
        check(all(np.isfinite(p).all() and np.allclose(p.sum(1), 1,
                                                       atol=1e-3)
                  for p in probs.values()), f"{name}: bad probabilities")
    for r in out.values():
        w = r["records_per_s_windows"]
        r.update(records_per_s=float(np.median(w)), min=min(w), max=max(w))
    registry = MetricsRegistry()

    def make_server(backend):
        server = ClusterServing(ims["int8_weight_only"], backend=backend,
                                batch_size=T_BATCH, registry=registry)
        server.model.predict(xs[:T_BATCH])               # warm-up
        return server

    got, wall, server = serve(make_server, list(xs), counters)
    batches = int(registry.snapshot()["zoo_serving_batches_total"]["value"])
    out["served_int8"] = {
        "records_per_s": len(xs) / wall, "dispatches": batches,
        "k6": KERNEL_INT8_MATMUL.launches,
        "k6_skinny": KERNEL_INT8_ROUTES["skinny"].launches,
        "top1_agreement_pct": 100.0 * float(np.mean(
            got.argmax(1) == probs["fp32"].argmax(1)))}
    out["plain_version_max_abs_err"] = plain_err
    for mode, r in out.items():
        if mode == "plain_version_max_abs_err":
            continue
        spread = (f" (median of {TC_SERVE_WINDOWS} windows, "
                  f"{r['min']:.1f}-{r['max']:.1f})" if "min" in r else "")
        print(f"text classifier {name} {mode}: {len(xs)} records = "
              f"{r['records_per_s']:.1f} records/s{spread}, top-1 "
              f"agreement with fp32 {r['top1_agreement_pct']:.2f}%, K6 "
              f"{r['k6']} ({r['k6_skinny']} skinny), Q8 {r.get('q8', 0)}")
    print(f"text classifier {name}: int8 forwards of {T_BATCH} records "
          f"against the kernels' plain versions: {plain_err}")
    check(plain_err["int8_static_bits_equal"], f"{name}: the static int8 "
          f"forward is not the bits of its plain version's {plain_err}")
    check(plain_err["int8_weight_only"] <= TC_PLAIN_TOL, f"{name}: the "
          f"weight-only forward is {plain_err['int8_weight_only']} from "
          f"its plain version's, over {TC_PLAIN_TOL}")
    for mode in ("int8_weight_only", "int8_static", "served_int8"):
        check(out[mode]["top1_agreement_pct"] >= TC_TOP1_FLOOR_PCT,
              f"{name} {mode}: top-1 agreement with fp32 "
              f"{out[mode]['top1_agreement_pct']}% < {TC_TOP1_FLOOR_PCT}%")
    check(server.served == len(xs) and out["served_int8"]["k6"]
          == 2 * batches, f"{name}: served {server.served}, "
          f"{out['served_int8']}")
    return out


def text_classifier_phase():
    """``TextClassifier`` at the class defaults on a seeded frozen
    ``WordEmbedding`` (the GloVe path): the cnn, lstm and gru encoders
    trained eager and captured (the captured step losses the eager bits),
    then the cnn and lstm classifiers served in fp32, weight-only and
    static int8 and through a one-lane ``ClusterServing``."""
    import numpy as np

    from analytics_zoo_tpu_torch.models.textclassification import \
        TextClassifier
    rng = np.random.default_rng(21)
    table = (rng.normal(size=(TC_VOCAB, TC_DIM)) * 0.1).astype(np.float32)
    x = rng.integers(1, TC_VOCAB, (TC_ROWS, TC_SEQ)).astype(np.int32)
    y = (x[:, :8].sum(1) % TC_CLASSES).astype(np.int32)
    serve_x = rng.integers(1, TC_VOCAB, (max(TC_SERVE_ROWS.values()),
                                         TC_SEQ)).astype(np.int32)
    out = {"fits": {}, "serving": {}}
    launches = {"k6": 0, "k6_skinny": 0, "q8": 0, "q8_routes": {}}
    for encoder in ("cnn", "lstm", "gru"):
        def build(encoder=encoder):
            return TextClassifier(TC_CLASSES, TC_DIM, TC_SEQ, encoder,
                                  TC_OUT, embedding_weights=table,
                                  device="cuda")
        runs, model = rnn_fit_in_turns(f"text classifier {encoder}", build,
                                       x, y, "scce", TC_BATCH, TC_SCAN,
                                       TC_EPOCHS[encoder])
        out["fits"][encoder] = runs
        if encoder != "gru":
            served = text_classifier_serving(
                encoder, model, serve_x[:TC_SERVE_ROWS[encoder]])
            out["serving"][encoder] = served
            launches["k6"] += (served["int8_weight_only"]["k6"]
                               + served["served_int8"]["k6"])
            launches["k6_skinny"] += (served["int8_weight_only"]["k6_skinny"]
                                      + served["served_int8"]["k6_skinny"])
            launches["q8"] += served["int8_static"]["q8"]
            for route, n in served["int8_static"]["q8_routes"].items():
                launches["q8_routes"][route] = (
                    launches["q8_routes"].get(route, 0) + n)
        del model
    out["launches"] = launches
    return out


def recurrent_models_phase():
    """AnomalyDetector (examples/anomaly_detection.py's configuration on a
    seeded 100,000-point series, then ``detect_anomalies`` over all of
    it), SessionRecommender at its defaults with history (then
    ``recommend_for_session``) and Seq2seq at examples/seq2seq_chatbot.py's
    configuration and a two-layer GRU with ``densenonlinear`` (then
    ``infer`` with a stop sign), each trained eager and captured with the
    bits gated."""
    import numpy as np

    from analytics_zoo_tpu_torch.models.anomalydetection import (
        AnomalyDetector, detect_anomalies, unroll)
    from analytics_zoo_tpu_torch.models.recommendation import \
        SessionRecommender
    from analytics_zoo_tpu_torch.models.seq2seq import Seq2seq
    rng = np.random.default_rng(0)
    out = {}
    t = np.arange(AD_POINTS, dtype=np.float32)
    series = (np.sin(t / 24 * 2 * np.pi)
              + rng.normal(0, 0.05, t.shape)).astype(np.float32)
    spikes = rng.choice(AD_POINTS, size=64, replace=False)
    series[spikes] += rng.choice([-2.5, 2.5], size=64).astype(np.float32)
    ax, ay, _ = unroll(series[:, None], AD_UNROLL)
    runs, model = rnn_fit_in_turns(
        "anomaly detector", lambda: AnomalyDetector((AD_UNROLL, 1),
                                                    device="cuda"),
        ax[:AD_ROWS], ay[:AD_ROWS, None], "mse", AD_BATCH, AD_SCAN,
        AD_EPOCHS)
    t0 = time.perf_counter()
    pred = model.predict(ax, batch_size=4096).reshape(-1)
    wall = time.perf_counter() - t0
    flagged = detect_anomalies(ay, pred, anomaly_size=64)
    hits = len(set(np.flatnonzero(~np.isnan(flagged)))
               & {s - AD_UNROLL for s in spikes if s >= AD_UNROLL})
    print(f"anomaly detector: predict over {len(ax)} windows in "
          f"{wall:.2f}s = {len(ax) / wall:.1f} windows/s; "
          f"detect_anomalies flagged 64, {hits} of them injected spikes")
    check(np.isfinite(pred).all() and (~np.isnan(flagged)).sum() == 64,
          "anomaly detector: bad predictions or flags")
    out["anomaly_detector"] = dict(runs, predict_windows_per_s=len(ax) / wall,
                                   spikes_hit=hits)
    del model

    sx = rng.integers(1, SR_ITEMS + 1, (SR_ROWS, 10)).astype(np.int32)
    sh = rng.integers(1, SR_ITEMS + 1, (SR_ROWS, 10)).astype(np.int32)
    sy = (sx[:, -1] - 1).astype(np.int32)
    runs, model = rnn_fit_in_turns(
        "session recommender", lambda: SessionRecommender(
            SR_ITEMS, include_history=True, history_length=10,
            device="cuda"), [sx, sh], sy, "scce", SR_BATCH, SR_SCAN,
        SR_EPOCHS)
    recs = model.recommend_for_session([sx[:64], sh[:64]], max_items=5)
    check(len(recs) == 64 and all(len(r) == 5 and all(
        0 <= i < SR_ITEMS and 0 <= p <= 1 for i, p in r) for r in recs),
        "session recommender: bad recommendations")
    print(f"session recommender: recommend_for_session of 64 sessions, "
          f"first {recs[0][:2]}")
    out["session_recommender"] = runs
    del model

    ids = rng.integers(2, S2S_VOCAB, (S2S_ROWS, S2S_T))
    eye = np.eye(S2S_VOCAB, dtype=np.float32)
    enc, tgt = eye[ids], eye[ids[:, ::-1]]
    dec = np.concatenate([np.zeros((S2S_ROWS, 1, S2S_VOCAB), np.float32),
                          tgt[:, :-1]], axis=1)
    for tag, kw, epochs in (
            ("lstm_dense", dict(rnn_type="lstm", num_layers=1,
                                bridge="dense"), S2S_EPOCHS[0]),
            ("gru2_densenonlinear", dict(rnn_type="gru", num_layers=2,
                                         bridge="densenonlinear"),
             S2S_EPOCHS[1])):
        runs, model = rnn_fit_in_turns(
            f"seq2seq {tag}", lambda kw=kw: Seq2seq(
                hidden_size=128, input_dim=S2S_VOCAB,
                generator_dim=S2S_VOCAB, generator_activation="softmax",
                device="cuda", **kw),
            [enc, dec], tgt, "cce", S2S_BATCH, S2S_SCAN, epochs, lr=2e-3)
        t0 = time.perf_counter()
        gen = model.infer(enc[:8], np.zeros((8, S2S_VOCAB), np.float32),
                          max_seq_len=S2S_T, stop_sign=eye[1])
        wall = time.perf_counter() - t0
        check(gen.shape[0] == 8 and gen.shape[2] == S2S_VOCAB
              and np.isfinite(gen).all(), f"seq2seq {tag}: infer {gen.shape}")
        acc = (float(np.mean(gen.argmax(-1) == ids[:8, ::-1]))
               if gen.shape[1] == S2S_T else None)
        print(f"seq2seq {tag}: infer of 8 sequences, {gen.shape[1]} steps "
              f"in {1e3 * wall:.1f} ms; greedy token accuracy {acc}")
        out[f"seq2seq_{tag}"] = dict(runs, infer_ms=1e3 * wall,
                                     infer_steps=gen.shape[1],
                                     greedy_accuracy=acc)
        del model
    return out


def conv3d_phase():
    """One training layer each at full width, a few Adam steps, ms a
    step: ``ConvLSTM2D(64, 3)`` over Moving-MNIST's (16, 10, 64, 64, 1)
    with a 1x1 conv head predicting the next frame, and C3D's first layer,
    ``Convolution3D`` 3 -> 64 3x3x3 over (8, 16, 112, 112, 3), under a
    pooled Dense head."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
        Sequential, reset_uids)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        ConvLSTM2D, Convolution2D, Convolution3D, Dense,
        GlobalAveragePooling3D)
    rng = np.random.default_rng(3)
    out = {}
    b, t, h, w, c = CLSTM_CLIPS
    cb, ct, ch, cw, cc = C3D_CLIPS
    cases = {
        "convlstm2d_moving_mnist": (
            lambda: [ConvLSTM2D(CLSTM_FILTERS, 3, input_shape=(t, h, w, c)),
                     Convolution2D(1, 1, 1, activation="sigmoid")],
            rng.random(CLSTM_CLIPS, np.float32),
            rng.random((b, h, w, 1), np.float32), "mse", b),
        "conv3d_c3d_conv1a": (
            lambda: [Convolution3D(C3D_FILTERS, 3, 3, 3, border_mode="same",
                                   activation="relu",
                                   input_shape=(ct, ch, cw, cc)),
                     GlobalAveragePooling3D(),
                     Dense(2, activation="softmax")],
            rng.random(C3D_CLIPS, np.float32),
            rng.integers(0, 2, cb).astype(np.int32), "scce", cb),
    }
    for name, (layers, x, y, loss, batch) in cases.items():
        init_zoo_context(conf={"zoo.seed": 0})
        reset_uids()
        net = Sequential(layers(), device="cuda").init_weights()
        net.compile(optimizer="adam", loss=loss, lr=1e-3)
        net.fit(x, y, batch_size=batch, nb_epoch=1, shuffle=False)
        torch.cuda.synchronize()
        xs = np.concatenate([x] * CONV3D_STEPS)
        ys = np.concatenate([y] * CONV3D_STEPS)
        t0 = time.perf_counter()
        hist = net.fit(xs, ys, batch_size=batch, nb_epoch=1, shuffle=False)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / CONV3D_STEPS
        share, kernel_ms = profiled_busy_share(lambda: net.fit(
            x, y, batch_size=batch, nb_epoch=1, shuffle=False))
        print(f"conv3d {name}: batch {batch}, {ms:.2f} ms a training step "
              f"({CONV3D_STEPS} timed), loss {hist['loss']}, device busy "
              f"{'not measured' if share is None else f'{100 * share:.1f}%'}"
              f" of a profiled step ({kernel_ms} ms of kernels)")
        check(all(math.isfinite(v) for v in hist["loss"]),
              f"conv3d {name}: loss {hist['loss']}")
        out[name] = {"ms_per_step": ms, "batch": batch,
                     "loss": hist["loss"], "busy_share": share,
                     "profiled_kernel_ms": kernel_ms}
        del net
        gc.collect()
    return out


def guard_nodes(program):
    """The kernel names of one captured step of a training loop's program
    (:func:`device_kernels` of ``program._steps(1)``), shortened."""
    return [kernel_name(n) for n in device_kernels(
        lambda: program._steps(1), program.noise[:1])]


def node_family(name):
    """The family of a kernel node for fault r's extra-node list."""
    for family, keys in (("G2 guard_check", ("guard_check",)),
                         ("G1 guard_commit", ("guard_commit",)),
                         ("foreach (multi-tensor)", ("multi_tensor",
                                                     "foreach", "lpnorm")),
                         ("where / select", ("where",)),
                         ("reduce (norm)", ("reduce", "norm")),
                         ("copy / fill", ("copy", "fill", "cat"))):
        if any(k in name for k in keys):
            return family
    return "elementwise / other"


def guard_kernel_rows(model, launches):
    """G1 and G2 at the sentinel fit's shapes: G1 over the recover loop's
    own step state (every parameter, both Adam moments), G2 on its guard
    scalars and per-step table. Each is held to its plain version bit for
    bit on a good step and on a bad one, and timed on the device (a CUDA
    graph of 20 calls) beside its plain version; G1's library figure is
    the per-tensor ``torch.where`` loop it replaced."""
    import torch

    from analytics_zoo_tpu_torch.ops import guard as gk
    from analytics_zoo_tpu_torch.pipeline.api.keras import dispatch
    loop = model._loop
    params = loop._params()
    state = [t.detach() for t in list(params.values())
             + dispatch._leaves(model.opt_state["state"])
             + loop._written_state()]
    nbytes = sum(t.numel() * t.element_size() for t in state)
    prev = [t.clone() for t in state]
    for p in prev:
        if p.is_floating_point():
            p.add_(1)
    flags = {}
    for bad in (False, True):
        flag = torch.tensor(bad, device="cuda")
        got, want = [t.clone() for t in state], [t.clone() for t in state]
        gk.guard_commit(got, prev, flag)
        gk.guard_commit_reference(want, prev, flag)
        torch.cuda.synchronize()
        same = all(torch.equal(a.view(-1).view(torch.uint8),
                               b.view(-1).view(torch.uint8))
                   for a, b in zip(got, want))
        check(same, f"G1 guard_commit differs from its plain version "
                    f"(bad={bad})")
        flags[bad] = flag
    work = [t.clone() for t in state]
    table = gk.commit_table(work, prev)
    g1 = {}
    for bad in (False, True):
        g1[bad] = {
            "ms": graph_ms(lambda: gk.guard_commit(work, prev, flags[bad],
                                                   table)),
            "plain_ms": graph_ms(lambda: gk.guard_commit_reference(
                work, prev, flags[bad]))}
    # G2 on the guard's scalars: a good step, each kind of bad one, and a
    # clipping step; each case's outputs against the torch chain
    guard = loop._guard
    rows_tab = torch.arange(16 * 4, dtype=torch.float32,
                            device="cuda").reshape(16, 4) / 9.0
    cases = [(0.7, 1.3, 1.1, 7.0), (float("nan"), 1.3, 1.1, 7.0),
             (0.7, float("inf"), 1.1, 7.0), (0.7, 50.0, 1.1, 7.0),
             (0.7, 3.0, 2.9, 7.0)]
    for clip in (0.0, 2.0):
        for loss_v, gnorm_v, ewma_v, obs_v in cases:
            outs = []
            for run in (gk.guard_check_reference, gk.guard_check):
                st = [torch.tensor(v, dtype=dt, device="cuda") for v, dt in
                      ((ewma_v, torch.float32), (obs_v, torch.float32),
                       (3, torch.int64))]
                res = run(torch.tensor(loss_v, device="cuda"),
                          torch.tensor(gnorm_v, device="cuda"), *st,
                          torch.tensor(0, device="cuda"), rows_tab,
                          sentinel=True, spike_factor=10.0, grad_clip=clip,
                          recover=True)
                outs.append([t for t in list(res) + st if t is not None])
            same = all(torch.equal(a.view(-1).view(torch.uint8),
                                   b.view(-1).view(torch.uint8))
                       for a, b in zip(*outs))
            check(same, f"G2 guard_check differs from its plain version "
                        f"({loss_v}, {gnorm_v}, clip {clip})")
    # G2 given the per-tensor norms, as the step launches it: the norm it
    # takes (read back as a first step's new EWMA value, the norm itself)
    # is anomaly.global_norm's bits, for tensors of the fit's parameter
    # shapes and for every count of tensors up to NORMS_MAX and past it,
    # on _foreach_norm's outputs and on copies of them
    from analytics_zoo_tpu_torch.common import anomaly
    pgen = torch.Generator(device="cuda").manual_seed(5)
    sets = [[torch.randn(t.shape, generator=pgen, device="cuda")
             for t in params.values()]]
    for n_t in range(1, gk.NORMS_MAX + 4):
        for scale in (1e-3, 1.0, 300.0):
            sets.append([torch.randn(1 + (i * 7) % 13, generator=pgen,
                                     device="cuda") * scale * (1 + i % 3)
                         for i in range(n_t)])
    zero = torch.tensor(0, device="cuda")
    wrong = []
    for ts in sets:
        norms = anomaly.tensor_norms(ts)
        want = anomaly.global_norm(ts)
        for given in (norms, [t.clone() for t in norms]):
            st = [torch.zeros((), device="cuda"),
                  torch.zeros((), device="cuda"),
                  torch.tensor(0, device="cuda")]
            gk.guard_check(torch.tensor(0.7, device="cuda"), None, *st,
                           zero, None, sentinel=True, spike_factor=10.0,
                           grad_clip=0.0, recover=True, norms=given)
            if not torch.equal(st[0].view(torch.int32),
                               want.view(torch.int32)):
                wrong.append((len(ts), st[0].item(), want.item()))
    check(not wrong, f"G2's norm of the per-tensor norms differs from "
                     f"vector_norm's: {wrong[:5]}")
    print(f"G2's norm of the norms: vector_norm's bits for "
          f"{2 * len(sets)} sets (1..{gk.NORMS_MAX + 3} tensors, and the "
          f"sentinel fit's {len(sets[0])} parameter shapes)")
    loss = torch.tensor(0.7, device="cuda")
    gnorm = torch.tensor(1.3, device="cuda")
    step_norms = anomaly.tensor_norms(sets[0])
    # G2's keep (recover mode): the state into the copies for a bad step
    # (a NaN loss), bit for bit; nothing for a good one
    copies = [torch.zeros_like(t) for t in state]
    keep = gk.commit_table(copies, state)
    for bad_loss in (0.7, float("nan")):
        gk.guard_check(torch.tensor(bad_loss, device="cuda"), gnorm,
                       torch.tensor(1.1, device="cuda"),
                       torch.tensor(7.0, device="cuda"),
                       torch.tensor(0, device="cuda"), guard.base, None,
                       sentinel=True, spike_factor=10.0, grad_clip=0.0,
                       recover=True, keep=keep)
        torch.cuda.synchronize()
        want = state if bad_loss != bad_loss else [torch.zeros_like(t)
                                                    for t in state]
        check(all(torch.equal(a.view(-1).view(torch.uint8),
                              b.view(-1).view(torch.uint8))
                  for a, b in zip(copies, want)),
              f"G2's keep wrong for loss {bad_loss}")

    def g2(run, **kw):
        # the count restarts each call: 20 calls in a window run past the
        # table's 16 rows (G2 answers a NaN row there, the plain
        # index_select a device fault); the fill's own time is taken off
        guard.count.fill_(0)
        run(loss, None, guard.ewma, guard.obs, guard.count, guard.base,
            rows_tab, sentinel=True, spike_factor=10.0, grad_clip=0.0,
            recover=True, norms=step_norms, **kw)
    # G2 as the recover step launches it (the per-tensor norms in, its
    # grid taking the keep's table); its plain version is the chain with
    # the norm of the norms and the multi-tensor keep
    g2_ms = graph_ms(lambda: g2(gk.guard_check, keep=keep))
    g2_plain = graph_ms(lambda: (torch._foreach_copy_(copies, state),
                                 g2(gk.guard_check_reference)))
    fill_ms = graph_ms(lambda: guard.count.fill_(0))
    src = "analytics_zoo_tpu_torch/csrc/guard.cu"
    g1_row = {"name": "guard_commit", "route": "cuda", "source": src,
              "replaces": "none: the jnp.where discard XLA fuses into the "
                          "JAX guarded step (analytics_zoo_tpu/pipeline/api/"
                          "keras/training.py, common/anomaly.py)",
              "launches": launches["guard_commit"], "max_abs_err": 0.0,
              "ms": g1[False]["ms"], "plain_ms": g1[False]["plain_ms"],
              "bound_ms": bytes_bound_ms(1), "bound_by": "bytes",
              "library_ms": g1[False]["plain_ms"],
              "library_by": "per-tensor torch.where loop",
              "bad_step_ms": g1[True]["ms"],
              "bad_step_plain_ms": g1[True]["plain_ms"],
              "bad_step_bound_ms": bytes_bound_ms(2 * nbytes + 1),
              "tensors": len(state), "state_bytes": nbytes}
    g2_row = {"name": "guard_check", "route": "cuda", "source": src,
              "replaces": "none: the scalar chain XLA fuses in "
                          "analytics_zoo_tpu/common/anomaly.py check / "
                          "clip_by_global_norm",
              "launches": launches["guard_check"], "max_abs_err": 0.0,
              "ms": g2_ms - fill_ms, "plain_ms": g2_plain - fill_ms,
              "bound_ms": bytes_bound_ms(4 * len(step_norms) + 4 * 4
                                         + 8 * 3 + 4 * 4 + 4 + 1 + 4),
              "norms": len(step_norms),
              "bound_by": "bytes", "library_ms": None}
    print(f"G1 guard_commit over {len(state)} tensors ({nbytes} bytes): "
          f"good step {g1[False]['ms']:.4f} ms (the per-tensor where loop "
          f"{g1[False]['plain_ms']:.4f}), bad step {g1[True]['ms']:.4f} "
          f"(loop {g1[True]['plain_ms']:.4f}, bound "
          f"{g1_row['bad_step_bound_ms']:.4f}); G2 guard_check "
          f"{g2_row['ms']:.4f} ms (the torch chain {g2_row['plain_ms']:.4f});"
          f" both bit for bit on good and bad steps")
    return [g1_row, g2_row]


def sentinel_phase():
    """The JAX bench's ``sentinel`` channel (``bench.py:847-914``):
    recover-mode sentinels against none at the NCF shape (6040 users,
    3706 items, 5 classes, batch 8192) on captured 16-step dispatches.
    Each mode's fit captures its graph; then five windows of three
    replays each (:func:`replay_ms`), the off and recover windows
    interleaved, timed on the device; ``sentinel_overhead_pct`` from the
    medians, as the bench computes it, against the bench's ceiling of
    3.0 (fault r: above it, printed as open with the extra nodes by
    family). The kernel nodes of one captured step of each mode,
    and the guarded step's extra nodes by family, are printed; then G1
    and G2 are held to their plain versions on the recover loop's state
    (:func:`guard_kernel_rows`)."""
    import collections

    import numpy as np

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    from analytics_zoo_tpu_torch.ops import guard as gk
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import reset_uids
    rng = np.random.default_rng(11)
    n = SENTINEL_STEPS * NCF_BATCH
    x = np.stack([rng.integers(1, N_USERS + 1, n),
                  rng.integers(1, N_ITEMS + 1, n)], axis=1).astype(np.int32)
    y = rng.integers(0, N_CLASSES, n).astype(np.int32)
    windows, models = {}, {}
    for counter in (gk.KERNEL_CHECK, gk.KERNEL_COMMIT):
        counter.reset()
    for mode in ("off", "recover"):
        init_zoo_context(conf={"zoo.seed": 0, "zoo.compute.dtype": "float32",
                               "zoo.train.scan_steps": SENTINEL_STEPS,
                               "zoo.train.sentinel": mode})
        reset_uids()
        model = NeuralCF(N_USERS, N_ITEMS, N_CLASSES,
                         device="cuda").init_weights()
        model.compile(optimizer="adam", loss="scce", lr=1e-3)
        model.fit(x, y, batch_size=NCF_BATCH, nb_epoch=1, shuffle=False)
        models[mode] = model
        windows[mode] = (lambda program=model._loop._program[1]: replay_ms(
            program, SENTINEL_STEPS) / SENTINEL_STEPS)
    times = {"off": [], "recover": []}
    for _ in range(5):
        for mode in ("off", "recover"):
            times[mode].append(windows[mode]())
    launches = {"guard_check": gk.KERNEL_CHECK.launches,
                "guard_commit": gk.KERNEL_COMMIT.launches}
    check(all(launches.values()),
          f"sentinel: G1/G2 not launched by the guarded fit: {launches}")
    off_ms = float(np.median(times["off"]))
    on_ms = float(np.median(times["recover"]))
    pct = max(0.0, on_ms / off_ms - 1.0) * 100.0
    nodes = {mode: guard_nodes(models[mode]._loop._program[1])
             for mode in ("off", "recover")}
    extra = collections.Counter(nodes["recover"])
    extra.subtract(collections.Counter(nodes["off"]))
    by_family = collections.Counter()
    for name, k in extra.items():
        if k > 0:
            by_family[node_family(name)] += k
    print(f"sentinel: NCF batch {NCF_BATCH}, {SENTINEL_STEPS}-step captured "
          f"dispatches, device ms a step off {off_ms:.4f} / recover "
          f"{on_ms:.4f} (windows {times}); sentinel_overhead_pct "
          f"{pct:.2f} (the JAX bench's ceiling {SENTINEL_CEILING_PCT}); "
          f"kernel nodes a step off {len(nodes['off'])} / recover "
          f"{len(nodes['recover'])}, the guarded step's extra nodes by "
          f"family {dict(by_family)}: "
          f"{sorted(n for n, k in extra.items() if k > 0)}")
    rows = guard_kernel_rows(models["recover"], launches)
    if pct > SENTINEL_CEILING_PCT:
        # fault r stays open (ROADMAP.md queue 3): printed with its nodes
        print(f"fault r open: sentinel_overhead_pct {pct:.2f} over the JAX "
              f"bench's ceiling {SENTINEL_CEILING_PCT}; the guarded step's "
              f"remaining extra nodes by family {dict(by_family)}")
    del models
    gc.collect()
    return {"sentinel_off_step_ms": off_ms, "sentinel_on_step_ms": on_ms,
            "sentinel_overhead_pct": pct, "windows_ms": times,
            "kernel_nodes": {m: len(v) for m, v in nodes.items()},
            "extra_nodes_by_family": dict(by_family),
            "launches": launches}, rows


#: the mesh phase (slice 22): the JAX bench's ``long_context_sharded``
#: width (``bench.py:474-530``: vocab 8192, hidden 512, 8 heads, 4
#: blocks), at a sequence the ranks sharing one card hold; Ulysses at
#: 2048, where K2/K3 take attention; f32, TF32 off
MESH_LM = dict(vocab=8192, n_block=4, hidden_size=512, n_head=8,
               hidden_drop=0.0, attn_drop=0.0, embedding_drop=0.0,
               bidirectional=False)
MESH_LM_SEQ, MESH_ULYSSES_SEQ, MESH_LM_BATCH = 1024, 2048, 2
MESH_BERT_SEQ, MESH_BERT_BATCH = 128, 8
#: the CPU tests' tolerances (f32: the same arithmetic, collectives in
#: another order than one rank's sums)
MESH_RTOL, MESH_ATOL = 1e-5, 1e-6
#: the kernels whose launches the mesh phase reads by rank
MESH_KERNELS = ("embed_expand", "dedup_scatter_add") + LM_KERNELS
#: (case, model, mesh axes): each run on its ranks and held to the same
#: model's run on one rank of the card
MESH_CASES = (
    ("bert_dp_zero", "bert", {"data": 2}, {"zoo.train.zero_sharding": True}),
    ("bert_tp", "bert", {"model": 2}, {}),
    ("lm_ring", "lm", {"seq": 2}, {"zoo.train.seq_attention": "ring"}),
    ("lm_vocab", "lm", {"model": 2}, {}),
    ("lm_seq_model", "lm", {"seq": 2, "model": 2},
     {"zoo.train.seq_attention": "ring"}),
    ("lm_ulysses", "lm_ulysses", {"seq": 2},
     {"zoo.train.seq_attention": "ulysses"}),
    ("ncf_rows", "ncf", {"model": 2}, {}),
    ("moe", "moe", {"expert": 2}, {}),
    ("gpipe", "gpipe", {"pipe": 2}, {}),
    ("bn_dp", "bn", {"data": 2}, {}),
)
#: the GPipe noise check: batch, width and microbatches of a pipe-2
#: schedule whose stages draw a keep mask from one device generator
GPIPE_NOISE = dict(batch=512, width=1024, n_micro=4)


def mesh_counters():
    from analytics_zoo_tpu_torch.ops.pallas.embedding import (
        KERNEL_EMBED_EXPAND, KERNEL_SCATTER_ADD)
    kernels, _ = lm_counters()
    return {"embed_expand": KERNEL_EMBED_EXPAND,
            "dedup_scatter_add": KERNEL_SCATTER_ADD, **kernels}


def mesh_model(kind, device):
    """A mesh case's model (seeded weights) and its two batches."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
        Sequential, reset_uids)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Activation, BatchNormalization, Dense, GPipe, SparseMoE,
        TransformerLayer)
    from analytics_zoo_tpu_torch.tfpark.bert_classifier import (
        BERTClassifier, make_bert_inputs)
    reset_uids()
    rng = np.random.default_rng(22)
    gen = torch.Generator().manual_seed(22)
    if kind == "bert":
        m = BERTClassifier(**dict(TRAIN_CFG, hidden_drop=0.0),
                           device=device).init_weights(gen)
        ids = rng.integers(1, TRAIN_CFG["vocab"],
                           (2 * MESH_BERT_BATCH, MESH_BERT_SEQ)).astype(
            np.int32)
        lens = rng.integers(MESH_BERT_SEQ // 4, MESH_BERT_SEQ + 1, len(ids))
        ids[np.arange(MESH_BERT_SEQ)[None, :] >= lens[:, None]] = 0
        return (m, make_bert_inputs(ids, attention_mask=(ids != 0)),
                rng.integers(0, 2, len(ids)).astype(np.int32),
                MESH_BERT_BATCH, "scce")
    if kind in ("lm", "lm_ulysses"):
        t = MESH_ULYSSES_SEQ if kind == "lm_ulysses" else MESH_LM_SEQ
        b = 1 if kind == "lm_ulysses" else MESH_LM_BATCH
        m = Sequential([TransformerLayer(**MESH_LM, seq_len=t,
                                         input_shape=(t,)),
                        Dense(MESH_LM["vocab"])], device=device)
        x = rng.integers(0, MESH_LM["vocab"], (2 * b, t)).astype(np.int32)
        return (m.init_weights(gen), x,
                ((7 * x + 13) % MESH_LM["vocab"]).astype(np.int32), b,
                "scce_with_logits")
    if kind == "ncf":
        m = sharded_ncf(N_USERS, N_ITEMS, N_CLASSES, device=device)
        x = np.stack([rng.integers(1, N_USERS + 1, 2 * NCF_BATCH),
                      rng.integers(1, N_ITEMS + 1, 2 * NCF_BATCH)],
                     axis=1).astype(np.int32)
        return (m.init_weights(gen), x,
                rng.integers(0, N_CLASSES, len(x)).astype(np.int32),
                NCF_BATCH, "scce")
    if kind == "moe":
        m = Sequential([Dense(512, activation="relu", input_shape=(256,)),
                        SparseMoE(8, 2048, top_k=2, capacity_factor=2.0),
                        Dense(16, activation="softmax")], device=device)
    elif kind == "bn":
        # global-batch statistics under data parallelism: the 2-rank run
        # is the one-rank run of the whole batch
        m = Sequential([Dense(1024, bias=False, input_shape=(256,)),
                        BatchNormalization(), Activation("relu"),
                        Dense(16, activation="softmax")], device=device)
    else:
        m = Sequential([Dense(1024, activation="relu", input_shape=(256,)),
                        GPipe(lambda: Dense(1024, activation="tanh"), 4),
                        Dense(16, activation="softmax")], device=device)
    x = rng.normal(size=(2 * 1024, 256)).astype(np.float32)
    return (m.init_weights(gen), x,
            rng.integers(0, 16, len(x)).astype(np.int32), 1024, "scce")


def mesh_fit(kind, conf, device):
    """Two eager SGD steps of a mesh case's model: ``(model, step
    losses)``."""
    import numpy as np

    from analytics_zoo_tpu_torch.common.context import (init_zoo_context,
                                                        reset_zoo_context)
    reset_zoo_context()
    init_zoo_context(conf={"zoo.seed": 0, "zoo.compute.dtype": "float32",
                           **conf})
    model, x, y, batch, loss = mesh_model(kind, device)
    model.compile(optimizer="sgd", loss=loss, lr=0.01)
    model.fit(x, y, batch_size=batch, nb_epoch=1, shuffle=False)
    return model, np.concatenate(model._loop.step_losses)


def mesh_full_params(model):
    from analytics_zoo_tpu_torch.parallel.mesh import full_tensor
    from analytics_zoo_tpu_torch.pipeline.api.keras.training import \
        tree_module
    return {n: full_tensor(p).detach().float().cpu().numpy()
            for n, p in tree_module(model).named_parameters()}


def mesh_rank(rank, world, ref_dir, cases, device="cuda"):
    """One rank of the mesh phase: each case's fit on its mesh, its step
    losses and gathered parameters held to the one-rank run's (saved in
    ``ref_dir``), and its kernels' launches on this rank."""
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name, kind, axes, conf in cases:
        counters = mesh_counters()
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        model, losses = mesh_fit(kind, {**conf, **{
            f"zoo.mesh.{k}": v for k, v in axes.items()}}, device)
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        ref = np.load(os.path.join(ref_dir, f"{kind}.npz"))
        full = mesh_full_params(model)
        err = max(float(np.max(np.abs(a - ref[n]) / (np.abs(ref[n])
                                                     + MESH_ATOL / MESH_RTOL)))
                  for n, a in full.items())
        loss_err = float(np.max(np.abs(losses - ref["__losses__"])
                                / (np.abs(ref["__losses__"]) + 1e-12)))
        out[name] = {"losses": losses.tolist(), "loss_rel_err": loss_err,
                     "param_rel_err": err, "seconds": seconds,
                     "launches": {k: c.launches
                                  for k, c in counters.items()}}
        del model
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def mesh_phase(device="cuda"):
    """Multi-GPU (slice 22): every mesh case of :data:`MESH_CASES` on its
    ranks — one rank a card under NCCL where the machine has as many
    cards, else processes sharing one card over gloo (world 2, and 4 for
    the two-axis case) — held to the same model's one-rank run on the
    card (step losses and gathered parameters at the CPU tests'
    tolerances), with each rank's launches of K1/SA (row-sharded NCF),
    K4/K5a/K5b (the vocab-sharded head) and K2/K3a/K3b (Ulysses at T =
    2048). Then the kernels at their per-shard shapes (K4/K5 on a V/2
    slice, K1/SA on V/2 rows) against their plain versions, an elastic
    restore of a 2-rank snapshot on one rank (bit for bit), and, with two
    or more cards, a captured data-parallel fit; the 128k channel
    (``bench.py:495-498``) is skipped with its reason on one card.
    ``device="cpu"`` runs the same cases on the CPU over gloo (no kernels
    launch there), a rehearsal at small sizes."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.parallel.launch import run_ranks
    cards = torch.cuda.device_count() if device == "cuda" else 0
    out = {"device_count": cards, "cases": {}}
    ref_dir = os.path.join(REPO, "build", "mesh_ref")
    shutil.rmtree(ref_dir, ignore_errors=True)
    os.makedirs(ref_dir)
    for kind in sorted({k for _, k, _, _ in MESH_CASES}):
        model, losses = mesh_fit(kind, {}, device)
        np.savez(os.path.join(ref_dir, f"{kind}.npz"),
                 __losses__=losses, **mesh_full_params(model))
        del model
        gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    for world in (2, 4):
        backend = "nccl" if cards >= world else "gloo"
        cases = [c for c in MESH_CASES
                 if int(np.prod(list(c[2].values()))) == world]
        print(f"mesh: backend {backend}, world size {world}, device count "
              f"{cards}; cases {[c[0] for c in cases]}; LM sequence "
              f"{MESH_LM_SEQ} (Ulysses {MESH_ULYSSES_SEQ}), batch "
              f"{MESH_LM_BATCH}")
        t0 = time.perf_counter()
        ranks = run_ranks(mesh_rank, world,
                          os.path.join(ref_dir, f"store{world}"),
                          args=(ref_dir, cases, device), backend=backend,
                          device=device, timeout=900)
        print(f"mesh: world {world} ran in "
              f"{time.perf_counter() - t0:.1f}s")
        for name, kind, axes, _ in cases:
            per_rank = [r[name] for r in ranks]
            worst = max(max(r["loss_rel_err"], r["param_rel_err"])
                        for r in per_rank)
            by_rank = [{k: v for k, v in r["launches"].items() if v}
                       for r in per_rank]
            print(f"mesh {name} {axes} ({backend}, world {world}): step "
                  f"losses {per_rank[0]['losses']}, worst relative error "
                  f"to one rank {worst:.3g} (losses and gathered params); "
                  f"launches by rank {by_rank}")
            check(worst <= MESH_RTOL,
                  f"mesh {name}: {worst} from the one-rank run")
            out["cases"][name] = {"axes": axes, "backend": backend,
                                  "world": world, "ranks": per_rank}
    launches = {name: [r["launches"] for r in c["ranks"]]
                for name, c in out["cases"].items()}
    for name, kernels in (("lm_vocab", ("fused_ce_fwd", "fused_ce_bwd_dh",
                                        "fused_ce_bwd_dw")),
                          ("ncf_rows", ("embed_expand",
                                        "dedup_scatter_add")),
                          ("lm_ulysses", ("flash_attention_fwd",
                                          "flash_attention_bwd_dq",
                                          "flash_attention_bwd_dkv"))):
        idle = [(rank, k) for rank, got in enumerate(launches[name])
                for k in kernels if not got[k]]
        check(not idle or device != "cuda",
              f"mesh {name}: kernels not launched on a rank: {idle}")
    if device == "cuda":
        out["shard_shapes"] = mesh_shard_kernels()
    noise = run_ranks(mesh_gpipe_noise, 2,
                      os.path.join(ref_dir, "store_noise"), args=(device,),
                      backend="nccl" if cards >= 2 else "gloo",
                      device=device, timeout=300)
    out["gpipe_noise"] = mesh_gpipe_noise_check(noise, device)
    ckpt = os.path.join(ref_dir, "elastic")
    saved = run_ranks(mesh_elastic_save_ckpt, 2,
                      os.path.join(ref_dir, "store_elastic"),
                      args=(ckpt, device),
                      backend="nccl" if cards >= 2 else "gloo",
                      device=device, timeout=600)[0]
    out["elastic"] = mesh_elastic_restore(ckpt, saved, device)
    if cards >= 2:
        out["captured_dp"] = run_ranks(
            mesh_captured_dp, 2, os.path.join(ref_dir, "store_captured"),
            backend="nccl", device="cuda", timeout=600)[0]
        print(f"mesh: captured DP fit over 2 cards (nccl): "
              f"{out['captured_dp']}")
        print("mesh: the 128k channel (long_context_sharded) needs a "
              "machine of its own measurement; not run here")
    else:
        print("mesh: the 128k long_context_sharded channel and the "
              "captured DP fit need two or more cards (bench.py:495-498): "
              "skipped on this one-card machine")
    out["mesh_launches"] = launches
    return out


def mesh_gpipe_noise_inputs(device):
    import torch
    g = torch.Generator().manual_seed(9)
    b, w = GPIPE_NOISE["batch"], GPIPE_NOISE["width"]
    return (torch.randn(b, w, generator=g).to(device),
            (torch.randn(2, w, w, generator=g) / w ** 0.5).to(device),
            torch.randn(b, w, generator=g).to(device))


def mesh_gpipe_noise(rank, world, device="cuda"):
    """A pipe-2 GPipe schedule whose stages draw a keep mask from one
    device generator (as a Dropout stage on the card does), each rank one
    stage: the output, the input's and this rank's weight's gradients, and
    the masks its forward drew."""
    import torch

    from analytics_zoo_tpu_torch.common.context import (init_zoo_context,
                                                        reset_zoo_context)
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.parallel.pipeline import gpipe_apply
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_zoo_context()
    init_zoo_context(conf={"zoo.mesh.pipe": 2})
    mesh = mesh_lib.global_mesh()
    r = mesh.group(mesh_lib.PIPE_AXIS).index
    x, w, c = mesh_gpipe_noise_inputs(device)
    x.requires_grad_()
    local = {"W": w[r:r + 1].clone().requires_grad_()}
    gen = (torch.Generator(device=device) if device != "cpu"
           else torch.Generator()).manual_seed(3)
    drawn = []

    def stage(p, h, g):
        keep = (torch.rand(h.shape, generator=g, device=h.device)
                < 0.5).to(h.dtype)
        drawn.append(keep)
        return torch.tanh(h @ p["W"]) * keep * 2.0
    y = gpipe_apply(stage, local, x, mesh=mesh,
                    n_micro=GPIPE_NOISE["n_micro"], generator=gen)
    (y * c).sum().backward()
    # numpy: tensors would cross to the parent through shared memory
    return {"y": y.detach().cpu().numpy(), "gx": x.grad.cpu().numpy(),
            "gw": local["W"].grad[0].cpu().numpy(),
            "masks": torch.stack(drawn).cpu().bool().numpy()}


def mesh_gpipe_noise_check(ranks, device="cuda"):
    """The GPipe noise run against the stages one after another on one
    rank with the masks each rank's forward drew (rank ``s``'s mask for
    microbatch ``i`` at tick ``i + s``): the output and gradients agree,
    so the backward used the forward's masks."""
    import torch
    x, w, c = mesh_gpipe_noise_inputs(device)
    x.requires_grad_()
    w.requires_grad_()
    n_micro = GPIPE_NOISE["n_micro"]
    mb = x.shape[0] // n_micro
    ys = []
    for i in range(n_micro):
        h = x[i * mb:(i + 1) * mb]
        for s_ in range(2):
            keep = torch.from_numpy(ranks[s_]["masks"][i + s_]).to(
                device).to(h.dtype)
            h = torch.tanh(h @ w[s_]) * keep * 2.0
        ys.append(h)
    y = torch.cat(ys)
    (y * c).sum().backward()

    def rel(a, b):
        a, b = torch.from_numpy(a), b.detach().cpu()
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
    err = max(max(rel(r["y"], y), rel(r["gx"], x.grad),
                  rel(r["gw"], w.grad[k])) for k, r in enumerate(ranks))
    print(f"mesh: GPipe at pipe 2 with stages drawing noise from one "
          f"device generator: output and gradients vs the stages in turn "
          f"on the forward's masks, worst relative error {err:.3g}")
    check(err <= 1e-4, f"mesh: GPipe noise gradients differ ({err})")
    return {"rel_err": err}


def mesh_elastic_save_ckpt(rank, world, ckpt, device="cuda"):
    """Two ranks of data parallelism fit the NCF one epoch with a
    snapshot; the whole parameters after."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    from analytics_zoo_tpu_torch.common.context import (init_zoo_context,
                                                        reset_zoo_context)
    reset_zoo_context()
    init_zoo_context(conf={"zoo.seed": 0, "zoo.mesh.data": 2})
    model, x, y, batch, loss = mesh_model("ncf", device)
    model.compile(optimizer="adam", loss=loss, lr=1e-3)
    model.set_checkpoint(ckpt)
    model.fit(x, y, batch_size=batch, nb_epoch=1, shuffle=False)
    return {"params": mesh_full_params(model)}


def mesh_elastic_restore(ckpt, saved, device="cuda"):
    """The 2-rank snapshot restored on one rank of the card: the
    parameters bit for bit, the elastic restore reported."""
    import numpy as np

    from analytics_zoo_tpu_torch.common.context import (init_zoo_context,
                                                        reset_zoo_context)
    from analytics_zoo_tpu_torch.observability import default_registry
    reset_zoo_context()
    init_zoo_context(conf={"zoo.seed": 0})
    model, _, _, _, loss = mesh_model("ncf", device)
    model.compile(optimizer="adam", loss=loss, lr=1e-3)
    model.set_checkpoint(ckpt)
    loop = model._loop
    events = []

    class Sink:
        def write(self, event):
            events.append(event)
    params = loop._params()
    opt = loop._opt_state(params)
    default_registry().add_event_sink(Sink())
    meta = loop._try_resume(loop._ckpt_manager(), params, opt)
    got = mesh_full_params(model)
    same = all(np.array_equal(got[n], a) for n, a in saved["params"].items())
    elastic = [e for e in events if e["kind"] == "ckpt.elastic_restore"]
    print(f"mesh: elastic restore of a {meta['mesh']['axes']} snapshot on "
          f"one rank: parameters bit for bit {same}; events {elastic}")
    check(same and elastic, "mesh: elastic restore from 2 ranks to 1")
    return {"bits": same, "event": elastic[0]}


def mesh_shard_kernels():
    """K4/K5a/K5b on a V/2 = 4096-column slice of the mesh LM's head and
    K1/SA on the NCF user table's V/2 rows, against their plain
    versions: the per-shard shapes the mesh cases give them."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.ops.pallas import cross_entropy as ce
    from analytics_zoo_tpu_torch.ops.pallas import embedding as emb
    g = torch.Generator(device="cuda").manual_seed(3)
    n, h, v = MESH_LM_SEQ * MESH_LM_BATCH, MESH_LM["hidden_size"], 4096
    hid = torch.randn(n, h, device="cuda", generator=g)
    w = torch.randn(h, v, device="cuda", generator=g) * 0.05
    b = torch.randn(v, device="cuda", generator=g) * 0.1
    labels = torch.randint(-1, 2 * v, (n,), device="cuda",
                           generator=g).to(torch.int32)
    labels = torch.where(labels >= v, torch.full_like(labels, -1), labels)
    lse, ll = ce.fused_ce_forward(hid, w, b, labels)
    lse_r, ll_r = ce.fused_ce_forward_reference(hid, w, b, labels)
    scale = torch.where(labels >= 0, torch.ones_like(lse),
                        torch.zeros_like(lse))
    dh, dw, db = ce.fused_ce_backward(hid, w, b, labels, lse, scale,
                                      torch.float32)
    dh_r, dw_r, db_r = ce.fused_ce_backward_reference(hid, w, b, labels,
                                                      lse, scale,
                                                      torch.float32)
    ce_err = max(float((a - r).abs().max() / r.abs().max().clamp(min=1e-30))
                 for a, r in ((lse, lse_r), (dh, dh_r), (dw, dw_r),
                              (db, db_r)))
    rows = (N_USERS + 1 + 1) // 2
    table = torch.randn(rows, 20, device="cuda", generator=g)
    inv = torch.randint(0, rows, (NCF_BATCH,), device="cuda", generator=g)
    k1 = emb.embed_expand(table, inv)
    gg = torch.randn(NCF_BATCH, 20, device="cuda", generator=g)
    sa = emb.dedup_scatter_add(gg, inv, rows)
    sa_ref = emb.dedup_scatter_add_reference(gg.cpu(), inv.cpu(), rows)
    emb_same = bool(torch.equal(k1, table[inv])
                    and torch.equal(sa.cpu(), sa_ref))
    print(f"mesh: per-shard shapes — K4/K5a/K5b at (N {n}, H {h}, V/2 {v}) "
          f"relative error {ce_err:.3g} (f32, 1e-4); K1/SA on {rows} rows "
          f"(V/2 of the user table), bits {emb_same}")
    check(ce_err <= 1e-4 and emb_same,
          "mesh: a kernel at its per-shard shape")
    return {"ce_rel_err": ce_err, "embed_bits": emb_same}


def mesh_captured_dp(rank, world):
    """Two cards under NCCL: a captured (scan_steps 4) data-parallel NCF
    fit, its step losses those of the eager fit."""
    import numpy as np
    eager = mesh_fit("ncf", {"zoo.mesh.data": 2}, "cuda")[1]
    captured = mesh_fit("ncf", {"zoo.mesh.data": 2,
                                "zoo.train.scan_steps": 2}, "cuda")[1]
    return {"eager": eager.tolist(), "captured": captured.tolist(),
            "max_rel": float(np.max(np.abs(captured - eager)
                                    / np.abs(eager)))}


# ---------------------------------------------------------------------------
# slice 23: object detection (SSD300-VGG16) and N1
# ---------------------------------------------------------------------------

#: SSD300-VGG16, the PASCAL VOC configuration of the reference's SSD.scala
#: (21 classes, 300 x 300 x 3 frames, 8732 priors), seeded weights; the
#: detect batches, the training batch and steps, the served frames
SSD_CLASSES, SSD_RES, SSD_PRIORS = 21, 300, 8732
SSD_BATCHES = (1, 32)
SSD_TRAIN_BATCH, SSD_TRAIN_STEPS = 8, 4
SSD_FRAMES, SSD_SERVE_BATCH = 64, 32
#: timed detect calls a batch size (after two untimed ones)
SSD_REPS = 5
#: the convs of SSD300 static int8 (23 in the trunk and extras, 12 heads)
SSD_CONVS = 35
#: f32 operations N1 does a box pair of a row's upper triangle: the IoU's
#: 2 min, 2 max, 3 subtractions, 2 clamps, 1 product, 1 addition, 1
#: division (the areas once a box), and the threshold compare
NMS_OPS_PER_PAIR = 13
#: the rate the CUDA cores issue f32 operations that are not FMAs: half of
#: PEAK_FLOPS["float32"], which counts an FMA as two (N1's are none)
F32_ISSUE_RATE = PEAK_FLOPS["float32"] / 2
NMS_BOUND_BASIS = ("operations: 13 f32 operations a pair of the upper "
                   "triangle (the division counted as one) at the f32 "
                   "issue rate, 33.5 T/s (half the FMA-counted 67 TFLOP/s); "
                   "the boxes read and the mask written at 3.35 TB/s")
#: served raw scores against the direct forward of the same frames (fp32,
#: TF32 off: the same convs at another batch size, cuDNN free to pick
#: another algorithm), relative to the largest score
SSD_SERVE_REL_TOL = 1e-4


def ssd_frames(rng, n):
    """``n`` seeded 300 x 300 frames with one to three bright squares each
    and their padded ``(n, 3, 5)`` ground truth (labels 1..20)."""
    import numpy as np
    x = rng.normal(0, 0.1, size=(n, SSD_RES, SSD_RES, 3)).astype(np.float32)
    gt = np.full((n, 3, 5), -1.0, np.float32)
    for i in range(n):
        for j in range(int(rng.integers(1, 4))):
            size = int(rng.integers(30, 150))
            x0 = int(rng.integers(0, SSD_RES - size))
            y0 = int(rng.integers(0, SSD_RES - size))
            x[i, y0:y0 + size, x0:x0 + size, j] = 1.0
            gt[i, j] = [int(rng.integers(1, SSD_CLASSES)), x0 / SSD_RES,
                        y0 / SSD_RES, (x0 + size) / SSD_RES,
                        (y0 + size) / SSD_RES]
    return x, gt


def nms_bound(rows, k, rate=F32_ISSUE_RATE):
    """N1's least time: the boxes read and the keep-mask written once,
    against the upper triangle's pairs' operations at ``rate`` (the f32
    issue rate; the earlier bound counted them at the FMA-counted
    peak)."""
    t_bytes = rows * k * (16 + 1) / PEAK_BYTES_PER_S
    t_ops = rows * k * (k - 1) / 2 * NMS_OPS_PER_PAIR / rate
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def nms_phase_ms(boxes, threshold):
    """N1's phases on ``boxes`` (``scripts/nms_phases.py``'s builds of
    ``csrc/nms.cu`` with the IoU phase or the scan left out, timed in
    turns): the device ms of each build and the phases' shares."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "nms_phases", os.path.join(REPO, "scripts", "nms_phases.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    src = os.path.join(REPO, "analytics_zoo_tpu_torch", "csrc", "nms.cu")
    libs = {ph: probe.variant("chip_smoke", src, code)
            for ph, code in probe.PHASES.items()}
    from analytics_zoo_tpu_torch.ops.cuda_build import build_all
    build_all(list(libs.values()))
    ms = {ph: sum(t) / len(t) for ph, t in
          probe.phase_ms(libs, boxes, graph_ms, threshold).items()}
    return {"device_ms": ms,
            "load_and_output_ms": ms["load_only"],
            "iou_phase_ms": ms["no_scan"] - ms["load_only"],
            "scan_ms": ms["all"] - ms["no_scan"]}


def nms_case(det, raw):
    """N1 on the real decode's candidates of ``raw`` (every image's and
    class's 400 best boxes): its keep-mask bit for bit its plain version's
    on the card, timed beside it (the wrapper, its CUDA-graph device time,
    the plain loop) with its bound; launches here are not the path's."""
    import torch

    from analytics_zoo_tpu_torch.models.image.objectdetection.bbox import \
        detection_candidates
    from analytics_zoo_tpu_torch.ops.nms import (KERNEL_NMS, nms_keep_mask,
                                                 nms_keep_mask_reference)
    p = det.post_param
    probs = torch.softmax(raw[..., 4:].float(), dim=-1)
    _, boxes = detection_candidates(
        raw[..., :4], probs, det.priors, num_classes=SSD_CLASSES,
        conf_thresh=p.conf_thresh, nms_topk=p.nms_topk)
    boxes = boxes.contiguous()
    before = KERNEL_NMS.launches
    got = nms_keep_mask(boxes, p.nms_thresh)
    want = nms_keep_mask_reference(boxes, p.nms_thresh)
    same = bool(torch.equal(got, want))
    rows, k = boxes.shape[0] * boxes.shape[1], boxes.shape[2]
    bound_ms, bound_by = nms_bound(rows, k)
    out = {"rows": rows, "k": k, "bit_equal": same,
           "kept": int(got.sum()), "launches": KERNEL_NMS.launches - before,
           "ms": time_ms(lambda: nms_keep_mask(boxes, p.nms_thresh)),
           "device_ms": graph_ms(lambda: nms_keep_mask(boxes,
                                                       p.nms_thresh)),
           "plain_ms": time_ms(lambda: nms_keep_mask_reference(
               boxes, p.nms_thresh), iters=3, warmup=1),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_basis": NMS_BOUND_BASIS,
           "bound_ms_fma_counted": nms_bound(rows, k,
                                             PEAK_FLOPS["float32"])[0]}
    check(same and out["launches"] == 1,
          f"N1 at {rows} rows of {k}: not its plain version's bits or "
          f"{out['launches']} launches")
    out["phases"] = nms_phase_ms(boxes, p.nms_thresh)
    print(f"N1 at {rows} rows of {k}: {out['device_ms']:.4f} device ms "
          f"(bound {bound_ms:.4f}, {bound_by}); phases "
          f"{json.dumps(out['phases'])}")
    return out


def conv_inputs(im8, x):
    """One static forward of ``x``, each conv's input recorded (a copy) as
    its ``quantized_call`` receives it: ``{layer name: (layer, input)}``
    in call order."""
    import torch

    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
        Convolution2D
    seen = {}
    convs = [m for m in im8._model.modules() if isinstance(m, Convolution2D)]
    for layer in convs:
        def record(t, layer=layer, call=layer.quantized_call):
            seen[layer.name] = (layer, t.clone())
            return call(t)
        layer.quantized_call = record
    try:
        im8._forward([torch.from_numpy(x).cuda()])
        torch.cuda.synchronize()
    finally:
        for layer in convs:
            del layer.quantized_call
    return seen


def ssd_c8_shapes(im8, x, tag):
    """C8 at each of SSD300's 35 convs on the inputs of a real static
    forward of ``x``: the same bits on a second call, its route and device
    ms, and bit for bit its plain version (the exact float64 conv) at
    batch 1 on every conv and at batch 32 on the shapes no earlier phase
    ran (dilation 6, 1 x 1, stride 2, valid, the heads), whose plain
    version is also timed. Launches here are not the path's."""
    import torch

    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        LAST_CONV_LAUNCH, static_int8_conv2d,
        static_int8_conv2d_reference)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.convolution \
        import ACTIVATIONS
    rows = {}
    for name, (layer, xin) in conv_inputs(im8, x).items():
        relu = layer.activation is ACTIVATIONS["relu"]
        args = (xin, layer.x_scale, layer.W, layer.w_scale, layer.b, relu,
                layer.subsample, layer.dilation, layer._pads(xin))
        kw = {"w_kmajor": getattr(layer, "W_kmajor", None)}
        out = static_int8_conv2d(*args, **kw)
        route, splits = LAST_CONV_LAUNCH.route, LAST_CONV_LAUNCH.splits
        again = static_int8_conv2d(*args, **kw)
        kh, kw_, c, f = layer.W.shape
        # the shapes VGG-16's phases never ran; at batch 1 every conv
        new = (layer.dilation != (1, 1) or kh == 1
               or layer.subsample != (1, 1) or out.shape[1] < 5
               or name.startswith("mbox"))
        same = bool(torch.equal(out.view(torch.int32),
                                again.view(torch.int32)))
        if new or x.shape[0] == 1:
            ref = static_int8_conv2d_reference(*args)
            same = same and bool(torch.equal(out.view(torch.int32),
                                             ref.view(torch.int32)))
            del ref
        row = {"in": list(xin.shape), "out": list(out.shape), "f": f,
               "k": kh, "stride": layer.subsample[0],
               "dilation": layer.dilation[0], "route": route,
               "splits": splits, "bit_equal": same,
               "plain_checked": bool(new or x.shape[0] == 1),
               "device_ms": graph_ms(lambda: static_int8_conv2d(*args, **kw),
                                     iters=10)}
        if new:
            row["plain_ms"] = time_ms(lambda: static_int8_conv2d_reference(
                *args), iters=1, warmup=1)
        rows[name] = row
        check(same, f"C8 at SSD300 {tag} {name} {row}: not its plain "
              f"version's bits")
        del xin, out, again
    check(len(rows) == SSD_CONVS, f"SSD300 {tag}: {len(rows)} convs")
    torch.cuda.empty_cache()
    return rows


def ssd_fit(x, gt, conf):
    """SSD300 from seeded weights trained for ``SSD_TRAIN_STEPS`` steps of
    batch ``SSD_TRAIN_BATCH`` (SGD 1e-3, MultiBoxLoss, fp32): the step
    losses, the parameters (host copies) and the fit's seconds."""
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.models.image.objectdetection import \
        ObjectDetector
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import reset_uids
    init_zoo_context(conf={"zoo.compute.dtype": "float32", "zoo.seed": 0,
                           **conf})
    reset_uids()
    det = ObjectDetector("ssd-vgg16-300", num_classes=SSD_CLASSES)
    det.init_weights(torch.Generator().manual_seed(0))
    det.compile(optimizer="sgd", loss=det.multibox_loss(), lr=1e-3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    det.fit(x, gt, batch_size=SSD_TRAIN_BATCH, nb_epoch=1, shuffle=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    losses = [v for a in det._loop.step_losses for v in a.tolist()]
    params = {k: v.detach().cpu().clone()
              for k, v in det.model.named_parameters()}
    return det, losses, params, seconds


def object_detection_phase():
    """SSD300-VGG16 (21 classes, 300 x 300, seeded weights) on the port:

    * ``ObjectDetector.detect`` in fp32 at batch 1 and 32: records/s (the
      best of ``SSD_REPS`` timed calls, host clock to the detections on
      the host) and the device ms of the forward and of the decode
      (softmax, box decode, the per-class stable top-400, N1 and the
      keep-top-200), by CUDA events;
    * static int8 (``InferenceModel.from_keras(quantize="int8",
      calibrate=batch)``): 35 convs calibrated, C8 launching 35 times a
      forward (by route; the quantize pass on the 34 past the 3-channel
      stem), each conv held to C8's plain version bit for bit on the
      inputs of a real forward at batch 1 and 32, and the int8 detect's
      records/s and device ms beside fp32's;
    * N1 on the real decode's 32 x 21 rows of 400 boxes, bit for bit its
      plain version (the torch loop), timed beside it;
    * ``ClusterServing(batch_size=32)`` streaming ``SSD_FRAMES`` frames
      from a producer thread, the client decoding each answer (the
      ``examples/streaming_object_detection.py`` flow): records/s, every
      answer's raw scores against the direct forward;
    * training: ``compile(loss=det.multibox_loss())`` and ``fit`` for
      ``SSD_TRAIN_STEPS`` steps of batch 8, eager and captured
      (``zoo.train.scan_steps``): the same step losses and parameters,
      bit for bit (``cudnn.deterministic``); then ``MeanAveragePrecision``
      over the trained detector's detections.

    N1's and C8's launches are counted on each path (reset just before,
    read just after) and gated."""
    import threading

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.models.image.objectdetection import (
        MeanAveragePrecision, ObjectDetector)
    from analytics_zoo_tpu_torch.ops.nms import KERNEL_NMS
    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        KERNEL_INT8_CONV, KERNEL_INT8_CONV_QUANTIZE, KERNEL_INT8_CONV_REPACK,
        KERNEL_INT8_CONV_ROUTES)
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import reset_uids
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving import (ClusterServing, InputQueue,
                                                 LocalBackend, OutputQueue)
    out = {"launches": {}, "c8_routes": {}}
    counters = {"n1": KERNEL_NMS, "c8": KERNEL_INT8_CONV,
                "c8_quantize": KERNEL_INT8_CONV_QUANTIZE,
                "c8_repack": KERNEL_INT8_CONV_REPACK,
                **KERNEL_INT8_CONV_ROUTES}

    def reset():
        for cnt in counters.values():
            cnt.reset()

    def read(path):
        torch.cuda.synchronize()
        got = {key: cnt.launches for key, cnt in counters.items()}
        out["launches"][path] = {"n1": got["n1"], "c8": got["c8"]}
        out["c8_routes"][path] = got
        return got

    init_zoo_context(conf={"zoo.compute.dtype": "float32", "zoo.seed": 0})
    reset_uids()
    rng = np.random.default_rng(23)
    x, gt = ssd_frames(rng, max(SSD_BATCHES))
    det = ObjectDetector("ssd-vgg16-300", num_classes=SSD_CLASSES)
    det.init_weights(torch.Generator().manual_seed(0))
    check(det.priors.shape == (SSD_PRIORS, 4), f"priors {det.priors.shape}")
    out["params"] = sum(p.numel() for p in det.parameters())

    def events_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        r = fn()
        end.record()
        torch.cuda.synchronize()
        return r, start.elapsed_time(end)

    # fp32 detect
    tables = {}
    for b in SSD_BATCHES:
        xb = x[:b]
        for _ in range(2):
            det.detect(xb)
        reset()
        best = float("inf")
        for _ in range(SSD_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            table = det.detect(xb)
            best = min(best, time.perf_counter() - t0)
        got = read(f"ssd300_fp32_b{b}")
        check(got["n1"] == SSD_REPS and got["c8"] == 0,
              f"fp32 detect b{b}: launches {got}")
        check(table.shape == (b, det.post_param.keep_topk, 6)
              and np.isfinite(table).all()
              and ((table[..., 0] >= -1) & (table[..., 0] < SSD_CLASSES))
              .all(), f"fp32 detect b{b}: table {table.shape}")
        tables[b] = table
        xd = torch.from_numpy(xb).cuda()
        with torch.no_grad():
            raw, fwd_ms = events_ms(lambda: det(xd))
            _, dec_ms = events_ms(lambda: det.decode_on_device(raw))
        out[f"fp32_b{b}"] = {"records_per_s": b / best,
                             "detect_ms": best * 1e3,
                             "forward_device_ms": fwd_ms,
                             "decode_device_ms": dec_ms,
                             "detections": int((table[..., 0] >= 0).sum())}
    # image 0 at batch 1 and in the batch of 32 (cuDNN may pick another
    # algorithm, and near-equal scores may then swap; printed, not gated)
    out["b1_b32_label_agreement_pct"] = float(
        (tables[1][0, :, 0] == tables[32][0, :, 0]).mean() * 100)
    with torch.no_grad():
        raw32 = det(torch.from_numpy(x).cuda())
    out["n1"] = nms_case(det, raw32)

    # static int8
    reset()
    im8 = InferenceModel().from_keras(det.model, quantize="int8",
                                      calibrate=x[:8])
    got = read("ssd300_static_install")
    out["repack_launches_install"] = got["c8_repack"]
    check(len(im8._act_scales) == SSD_CONVS and got["c8_repack"] == 34,
          f"static SSD300: {len(im8._act_scales)} calibrated, repacks "
          f"{got['c8_repack']}")
    for b in SSD_BATCHES:
        xb = x[:b]
        xd = torch.from_numpy(xb).cuda()

        def detect8():
            return det.decode_on_device(im8._forward([xd]))
        for _ in range(2):
            detect8()
        reset()
        best = float("inf")
        for _ in range(SSD_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            table8 = detect8().cpu().numpy()
            best = min(best, time.perf_counter() - t0)
        got = read(f"ssd300_static_b{b}")
        check(got["c8"] == SSD_CONVS * SSD_REPS
              and got["c8_small_c"] == SSD_REPS
              and got["c8_quantize"] == (SSD_CONVS - 1) * SSD_REPS
              and got["n1"] == SSD_REPS and got["c8_repack"] == 0,
              f"static SSD300 b{b}: launches {got}")
        with torch.no_grad():
            raw8, fwd_ms = events_ms(lambda: im8._forward([xd]))
            _, dec_ms = events_ms(lambda: det.decode_on_device(raw8))
            raw_f = det(xd)
        rel = float((raw8 - raw_f).abs().max() / raw_f.abs().max())
        check(np.isfinite(table8).all() and np.isfinite(rel),
              f"static detect b{b}")
        out[f"int8_b{b}"] = {"records_per_s": b / best,
                             "detect_ms": best * 1e3,
                             "forward_device_ms": fwd_ms,
                             "decode_device_ms": dec_ms,
                             "raw_rel_err_vs_fp32": rel,
                             "label_agreement_pct": float(
                                 (table8[..., 0] == tables[b][..., 0])
                                 .mean() * 100)}
        out[f"c8_shapes_b{b}"] = ssd_c8_shapes(im8, xb, f"b{b}")
    del im8, raw8
    torch.cuda.empty_cache()

    # streamed serving, decoded by the client
    im = InferenceModel(concurrent_num=2).from_keras(det.model)
    frames, _ = ssd_frames(np.random.default_rng(5), SSD_FRAMES)
    with torch.no_grad():
        direct = torch.cat([det(torch.from_numpy(frames[i:i + 32]).cuda())
                            for i in range(0, SSD_FRAMES, 32)]).cpu()
    backend = LocalBackend()
    reset()
    server = ClusterServing(im, backend=backend,
                            batch_size=SSD_SERVE_BATCH).start()
    inq, outq = InputQueue(backend), OutputQueue(backend)
    answers, worst = {}, 0.0
    t0 = time.perf_counter()
    try:
        def camera():
            for i in range(SSD_FRAMES):
                inq.enqueue(f"frame-{i:03d}", frames[i])
        producer = threading.Thread(target=camera)
        producer.start()
        deadline = time.time() + 300
        while len(answers) < SSD_FRAMES and time.time() < deadline:
            for uri, scores in outq.dequeue().items():
                i = int(uri.split("-")[1])
                scores = np.asarray(scores, np.float32)
                ref = direct[i].numpy()
                worst = max(worst, float(np.abs(scores - ref).max()
                                         / np.abs(ref).max()))
                answers[uri] = det.decode(scores)
            time.sleep(0.005)
        producer.join()
    finally:
        server.stop()
    seconds = time.perf_counter() - t0
    got = read("ssd300_serving")
    check(len(answers) == SSD_FRAMES and worst <= SSD_SERVE_REL_TOL
          and all(a.shape == (1, det.post_param.keep_topk, 6)
                  for a in answers.values())
          and got["n1"] == SSD_FRAMES,
          f"SSD300 serving: {len(answers)} of {SSD_FRAMES} answers, raw "
          f"scores {worst} from the direct forward, launches {got}")
    out["serving"] = {"records_per_s": SSD_FRAMES / seconds,
                      "raw_rel_err": worst, "frames": SSD_FRAMES}
    del im, det, raw32, direct
    torch.cuda.empty_cache()

    # training, eager and captured, then mAP
    torch.backends.cudnn.deterministic = True
    try:
        n = SSD_TRAIN_STEPS * SSD_TRAIN_BATCH
        tx, tgt = ssd_frames(np.random.default_rng(8), n)
        reset()
        eager, e_loss, e_params, e_s = ssd_fit(tx, tgt, {})
        got = read("ssd300_train_eager")
        del eager
        captured, k_loss, k_params, k_s = ssd_fit(
            tx, tgt, {"zoo.train.scan_steps": SSD_TRAIN_STEPS})
        same = e_loss == k_loss and all(
            torch.equal(e_params[k], k_params[k]) for k in e_params)
        check(same and np.isfinite(e_loss).all(),
              f"SSD300 training: the captured fit is not the eager fit's "
              f"bits (losses {e_loss} / {k_loss})")
        out["train"] = {"losses": e_loss, "bits_equal": same,
                        "eager_samples_per_s": n / e_s,
                        "captured_samples_per_s": n / k_s}
        reset()
        m = MeanAveragePrecision(num_classes=SSD_CLASSES)
        m.update(captured.detect(tx, batch_size=SSD_TRAIN_BATCH), tgt)
        mean_ap, _ = m.result()
        got = read("ssd300_evaluate")
        check(0.0 <= mean_ap <= 1.0 and got["n1"] == n // SSD_TRAIN_BATCH,
              f"SSD300 mAP {mean_ap}, launches {got}")
        out["train"]["map"] = mean_ap
        del captured
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    print(f"object detection {json.dumps(out)}")
    return out


def nms_kernel_row(det_out):
    """N1's row of the kernels line: at SSD300's batch-32 decode (32 x 21
    rows of 400 boxes), its launches on every detection path."""
    n1 = det_out["n1"]
    launches = {path: got["n1"] for path, got in det_out["launches"].items()
                if got["n1"]}
    return {"name": "nms_keep_mask", "route": "cuda",
            "source": "analytics_zoo_tpu_torch/csrc/nms.cu",
            "replaces": "analytics_zoo_tpu/models/image/objectdetection/"
                        "bbox.py:70 (nms_mask: an XLA fori_loop under two "
                        "vmaps, no Pallas kernel)",
            "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": 0 if n1["bit_equal"] else None,
            "ms": n1["ms"], "device_ms": n1["device_ms"],
            "plain_ms": n1["plain_ms"], "bound_ms": n1["bound_ms"],
            "bound_by": n1["bound_by"], "bound_basis": n1["bound_basis"],
            "bound_ms_fma_counted": n1["bound_ms_fma_counted"],
            "phases": n1["phases"], "library_ms": None,
            "library_by": "none: PyTorch has no NMS call (torchvision's "
                          "batched_nms is another package)",
            "rows": n1["rows"], "k": n1["k"]}


#: phases ``--only`` runs alone (after the build), for a short call that
#: checks one of them; the contract's run takes no arguments and runs all
ONLY_PHASES = ("sentinel", "mesh", "object_detection", "c8_kernel",
               "static_int8_kernel", "int8_head", "fleet")


def main(argv=()) -> int:
    import torch
    only = []
    if argv:
        if len(argv) != 2 or argv[0] != "--only" or not set(
                argv[1].split(",")) <= set(ONLY_PHASES):
            print(f"usage: chip_smoke.py [--only "
                  f"{'|'.join(ONLY_PHASES)}[,...]]", file=sys.stderr)
            return 2
        only = argv[1].split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from analytics_zoo_tpu_torch.ops.cuda_build import build_all
    from analytics_zoo_tpu_torch.ops.guard import LIBRARY as LIBRARY_GUARD
    from analytics_zoo_tpu_torch.ops.nms import LIBRARY as LIBRARY_NMS
    from analytics_zoo_tpu_torch.ops.pallas.cross_entropy import \
        LIBRARY as LIBRARY_CE
    from analytics_zoo_tpu_torch.ops.pallas.embedding import \
        LIBRARY as LIBRARY_EMB
    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import (
        LIBRARY, LIBRARY_BWD)
    from analytics_zoo_tpu_torch.ops.pallas.quantized import \
        LIBRARY as LIBRARY_Q
    from analytics_zoo_tpu_torch.ops.pallas.quantized import LIBRARY_CONV

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build_all([LIBRARY, LIBRARY_BWD, LIBRARY_CE, LIBRARY_EMB, LIBRARY_Q,
               LIBRARY_CONV, LIBRARY_GUARD, LIBRARY_NMS])
    print(f"build: flash_attention_fwd, flash_attention_bwd, "
          f"fused_cross_entropy, embedding, quantized, conv_int8, guard, "
          f"nms in "
          f"{time.perf_counter() - t0:.1f}s (nvcc sm_90a, in parallel)")

    if only:
        for name in only:
            result = globals()[f"{name}_phase"]()
            print(json.dumps({name: result}, default=str))
        return 0
    import numpy as np
    t0 = time.perf_counter()
    ncf_x, ncf_y = make_movielens_like(np.random.default_rng(0))
    print(f"ncf: {N_EXAMPLES} ratings made in {time.perf_counter() - t0:.1f}s")
    kernel_rows = kernel_phase()
    bwd_rows = bwd_kernel_phase()
    ce_rows = ce_kernel_phase()
    ce_hidden_rows = ce_hidden_phase()
    embed_rows = embed_kernel_phase(ncf_x)
    int8_rows = int8_kernel_phase()
    static_rows = static_int8_kernel_phase()
    serving = serving_phase()
    int8_serving = int8_serving_phase(serving["records_per_s"])
    lanes = lanes_phase()
    fleet = fleet_phase()
    int8_head = int8_head_phase()
    training, main_ids = training_phase()
    rows = main_path_kernel_rows(main_ids, training["launches"])
    reliability = reliability_phase()
    lm, lm_labels = lm_phase()
    ce_kernel_rows, flash_lm = lm_kernel_rows(lm_labels, lm["launches"],
                                              lm["ce_routes"])
    lm["fused_ce_speedup"] = fused_ce_speedup()
    long_context, attention_32k, ce_32k, lc_launches = \
        long_context_32k_phase()
    bert_ner = bert_ner_phase()
    knrm = knrm_phase()
    for row in rows:
        row.update(flash_lm[row["name"]])
    # K2 serves too: its launches on the lanes and fleet paths beside the
    # training's
    k2_row = next(r for r in rows if r["name"] == "flash_attention_fwd")
    k2_row["launches_by_path"] = {"bert_training": k2_row["launches"],
                                  "lanes": lanes["launches"]["k2"],
                                  "fleet": fleet["launches"]}
    k2_row["launches"] += lanes["launches"]["k2"] + fleet["launches"]
    # K2, K3a and K3b on the reliability path (slice 15)
    for row in rows:
        n = reliability["launches"][row["name"]]
        row.setdefault("launches_by_path",
                       {"bert_training": row["launches"]})
        row["launches_by_path"]["reliability"] = n
        row["launches"] += n
    rows += ce_kernel_rows
    # slice 18: the 32k LM (remat false), its remat modes and captured
    # remat fit, and BERT NER; the six kernels' 32k shapes
    for row in rows:
        name = row["name"]
        if name not in LM_KERNELS:
            continue
        row.update(attention_32k.get(name, {}))
        if name in ce_32k:
            row.update({f"{key}_32k": ce_32k[name][key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "max_abs_err")})
        new = {path: lc_launches[path][name] for path in lc_launches}
        if name in bert_ner["launches"]:
            new["bert_ner"] = bert_ner["launches"][name]
        row.setdefault("launches_by_path", {"lm_4k": row["launches"]})
        row["launches_by_path"].update(new)
        row["launches"] += sum(new.values())
    fault_l = fault_l_phase()
    ncf = ncf_phase(ncf_x, ncf_y)
    disk_fit = disk_fit_phase(ncf_x, ncf_y)
    wide_deep = wide_deep_phase()
    oocore = oocore_phase()
    captured_bert = captured_bert_phase()
    c8_rows = c8_kernel_phase()
    image_int8 = image_int8_phase()
    transfer = transfer_phase()
    resnet_serving = resnet_serving_phase()
    resnet_training = resnet_training_phase()
    text = text_classifier_phase()
    recurrent = recurrent_models_phase()
    conv3d = conv3d_phase()
    detection = object_detection_phase()
    sentinel, guard_rows = sentinel_phase()
    mesh = mesh_phase()
    rows = embed_kernel_rows(
        embed_rows, ncf["sharded_runs"]["keyed"][0]["launches"]) + rows
    # SA takes the out-of-core cache's gradient too (slice 17)
    sa_row = next(r for r in rows if r["name"] == "dedup_scatter_add")
    sa_row["launches_by_path"] = {"ncf_sharded_keyed": sa_row["launches"],
                                  "oocore": oocore["sa_launches"]}
    sa_row["launches"] += oocore["sa_launches"]
    k6_routes = {name: int8_head["launches_by_route"][name]
                 + int8_serving["launches_by_route"][name]
                 + lanes["k6_routes"][name]
                 for name in int8_serving["launches_by_route"]}
    # slice 19: ResNet-50's weight-only int8 serving lane (batch 32, the
    # skinny route)
    k6_routes["skinny"] += resnet_serving["k6_skinny_launches"]
    # slice 21: TextClassifier's two Dense layers, weight-only int8 (the
    # predicts and the served lane) and static int8, batch 32
    k6_routes["skinny"] += text["launches"]["k6_skinny"]
    rows.append(int8_kernel_row(int8_rows, {
        "head_serving": int8_head["launches"],
        "bert_serving": int8_serving["launches"],
        "lanes": lanes["launches"]["k6"],
        "resnet50_serving_int8": resnet_serving["k6_launches"]["int8_lane"],
        "resnet50_serving_multimodel":
            resnet_serving["k6_launches"]["multimodel"],
        "text_classifier_int8": text["launches"]["k6"]}, k6_routes))
    # Q8's launches by path and route (slice 24: the tensor-core routes)
    q8_names = [r for r in image_int8["c8_routes_b32"]
                if r.startswith("q8_")]
    rows.append(static_int8_kernel_row(static_rows, {
        "config_a_static": int8_head["q8_launches_by_route"],
        "vgg16_static_b32": {r: image_int8["c8_routes_b32"][r]
                             for r in q8_names},
        "vgg16_static_b1": {r: image_int8["c8_routes_b1"][r]
                            for r in q8_names},
        "text_classifier_static": text["launches"]["q8_routes"]}))
    # slice 23: SSD300's static detects (35 convs a forward)
    ssd_paths = [p for p in detection["c8_routes"]
                 if p.startswith("ssd300_static_b")]
    rows.append(c8_kernel_row(c8_rows, {
        "vgg16_static_b32": image_int8["launches_b32"]["c8"],
        "vgg16_static_b1": image_int8["launches_b1"]["c8"],
        **{p: detection["c8_routes"][p]["c8"] for p in ssd_paths}}))
    # slice 20: C8's quantize pass (in the predicts) and weight repack (at
    # the static install)
    rows += c8_pass_rows(c8_rows, {
        "vgg16_static_b32": image_int8["c8_routes_b32"]["c8_quantize"],
        "vgg16_static_b1": image_int8["c8_routes_b1"]["c8_quantize"],
        **{p: detection["c8_routes"][p]["c8_quantize"]
           for p in ssd_paths}}, {
        "vgg16_static_install": image_int8["repack_launches_install"],
        "ssd300_static_install": detection["repack_launches_install"]})
    rows.append(nms_kernel_row(detection))
    # slice 22: G1 and G2, the guarded step's kernels; the kernels'
    # launches on each rank of each mesh case
    rows += guard_rows
    for row in rows:
        for case, by_rank in mesh["mesh_launches"].items():
            for rank, counts in enumerate(by_rank):
                n = counts.get(row["name"], 0)
                if n:
                    row.setdefault("launches_by_path", {})[
                        f"mesh_{case}_rank{rank}"] = n
                    row["launches"] += n
    print(json.dumps({"kernel_cases": kernel_rows, "bwd_cases": bwd_rows,
                      "ce_cases": ce_rows, "ce_hidden_cases": ce_hidden_rows,
                      "embed_cases": embed_rows, "int8_cases": int8_rows,
                      "static_int8_cases": static_rows, "oocore": oocore,
                      "disk_fit": disk_fit,
                      "serving": serving, "int8_serving": int8_serving,
                      "lanes": lanes, "fleet": fleet, "int8_head": int8_head,
                      "training": training,
                      "lm": lm, "long_context_32k": long_context,
                      "bert_ner": bert_ner, "knrm": knrm,
                      "ncf": ncf, "wide_deep": wide_deep,
                      "fault_l": fault_l,
                      "captured_bert": captured_bert,
                      "c8_cases": c8_rows, "image_int8": image_int8,
                      "transfer": transfer,
                      "resnet_serving": resnet_serving,
                      "resnet_training": resnet_training,
                      "text_classifier": text, "recurrent": recurrent,
                      "conv3d": conv3d, "object_detection": detection,
                      "sentinel": sentinel,
                      "mesh": mesh,
                      "reliability": reliability, "card": card}))
    # slice 24's end-to-end readings beside the kernels
    print(json.dumps({"slice24_paths": {
        "ssd300_b32_decode_device_ms": {
            mode: detection[f"{mode}_b32"]["decode_device_ms"]
            for mode in ("fp32", "int8")},
        "n1_device_ms": detection["n1"]["device_ms"],
        "config_a_static_b32_records_per_s":
            int8_head["static_b32_records_per_s"],
        "vgg16_b32_images_per_s": {
            mode: image_int8[f"image_infer_{mode}_fps"]
            for mode in ("fp32", "int8")},
        "text_classifier_static_records_per_s": {
            enc: served["int8_static"]["records_per_s"]
            for enc, served in text["serving"].items()},
        "q8_launches_by_route": next(
            r for r in rows
            if r["name"] == "static_int8_dense")["launches_by_route"]}}))
    idle = [r["name"] for r in rows if not r["launches"]]
    check(not idle, f"kernels never launched on their main path: {idle}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
