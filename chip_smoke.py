#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mmlspark_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:
  1. build   — compile every kernel under mmlspark_tpu_torch/csrc/ with
               nvcc (sm_90a) and print the seconds it took, the card's
               name and power limit; then each flash kernel's registers,
               spills and shared memory (-Xptxas -v) and its count of
               HMMA instructions (cuobjdump -sass), and the blocks per SM
               and shared memory of the f32 forward, bf16 flash_dq and
               f32 flash_dq / flash_dkv at D = 128. Fails if a flash
               kernel (forward, flash_dq and flash_dkv, bf16 and f32 in
               3xTF32) has no HMMA, if one spills at D = 128, or without
               cuobjdump.
  2. kernels — call each kernel's wrapper on the card and hold it against
               its plain PyTorch version on the same inputs: float32
               within rtol 1e-5 / atol 1e-3 of the plain version in
               float64, integer stats bitwise, two launches bitwise equal;
               the hist cases include a fit's root (every row active), its
               mean masked right child (a scattered 5 % of the rows) and
               skewed bins (90 % in bin 0, binary, constant) in f32, int16
               and int8. Print the hist kernel's registers, spills, launch
               plan and blocks per SM. Time the kernel, its plain version,
               one library call computing the same function, and its bound
               (hist: at 80 % active as before, the root, the 5 % child and
               the 90 %-in-bin-0 root in f32; the root and the 5 % child
               in int16 at max_bin 255 and in int8 at max_bin 63).
  2b. flash  — the flash-attention kernel against its plain version in
               float64 (f32 within rtol 1e-4 / atol 1e-4; bf16 out within
               one bf16 rounding, rtol 2**-8), at the slice's shape
               (8, 1024, 16, 128) causal, the ragged, offset, fully
               masked and D = 160 cases, the tile edges (Lq, Lk in
               {1, 17, 65, 1000}, D in {8, 20, 64, 256}), a causal
               L = 8192 and unaligned views; two launches bitwise equal;
               in bf16, SDPA's error
               on the same inputs beside the kernel's. Time the kernel,
               its plain version, SDPA and the bound at the slice's shape
               in f32 and bf16.
  2c. flash backward — the flash_dq / flash_dkv kernels against their
               plain version in float64 on the same cases (dq, dk, dv with
               2b's tolerances); two launches bitwise equal; in bf16,
               SDPA's backward error beside them. At the slice's
               shape, time each kernel, the plain version, SDPA's backward
               and each kernel's bound, in f32 and bf16.
  3. GBDT slice — TPUBoostClassifier.fit -> transform on a 1M x 28
               HIGGS-shaped table (5 rounds, 63 leaves) through the
               kernel, at max_bin 255 and 63; launch counts are reset
               just before each fit and read just after. A third fit on
               the plain scatter path must reach the same holdout AUC
               (within 0.005), and a small fit on the card must agree
               with the same fit on the CPU.
  4. DNN slice — TPUModel.transform of 20 rows x 1024 tokens through the
               full-width LM of bench.py (LM_SPEC, seeded weights):
               exactly 8 flash launches per batch (24), finite logits of
               shape (20, 1024, 32000), rows 16-19 alone equal to the
               full run, and a depth-2 f32 model agreeing on the card
               and on the CPU (max |logit diff| <= 1e-3, argmax equal on
               >= 99.9 % of positions).
  5. training slice — TPULearner.fit of the full-width LM (LM_SPEC,
               token cross-entropy, AdamW at 1e-3, bf16 compute, device
               feed) over 32 rows x 1024 tokens for 2 epochs (8 steps of
               8): exactly 64 launches of each flash kernel, 8 finite
               losses with the last below the first, the returned model
               scoring finite logits; the same fit in f32 compute (the
               f32 flash kernels, strict-f32 GEMMs) with the same checks,
               step seconds, tokens/s and peak memory; then a depth-2
               f32 model trained 2
               SGD steps at batch 2, L = 512 on the card and on the CPU
               from the same weights (losses within rtol 1e-4, weights
               within 1e-3 of the largest update).
  6. serving slice — the max_bin 255 model of phase 3, saved with the
               port's save and loaded back with load_stage in a fresh
               process where jax cannot be imported: its transform of the
               holdout bitwise equal to phase 3's. Served on the card from
               the main process through serve_model(json_scoring_pipeline
               (model), port=0, batch_size=256, workers=2, max_wait_ms=5):
               2,000 one-row JSON requests from 16 client threads of a
               second (spawned) process, so that the clients do not
               share the engine's interpreter lock, every reply's
               prediction equal to transform's; through
               json_row_scoring_pipeline(model, reply_col="rawPrediction"):
               200 rows, each reply bitwise equal to transform's
               rawPrediction; and the MLP scorer of bench.py's
               bench_serving ([256, 128] -> 10 classes at input dim 128,
               seeded weights, batchSize 256, f32) after warmup returned
               len(bucket_sizes()): 400 replies equal to a direct
               transform. Prints requests/s, client p50 / p99, batches
               and rows per batch, the engine's queue_wait / decode /
               pipeline / respond ms p50; hist launches are counted
               around the serving (the forest walk is plain torch, so
               none).
  7. GBDT training options — on phase 3's 1M x 28 table (63 leaves,
               seed 7, the 100k holdout as validation data), each fit's
               launches counted by stats type just around it (seconds,
               phases; the first fit traced on the device for the hist
               kernels' share of the boost phase): (a) bagging 0.8 / 1
               and feature fraction 0.8 with early_stopping_round 5 over
               30 rounds —
               best_iteration is 1 + the argmin of the losses the run
               read and num_trees what the every-5-iterations cadence
               gives, on the holdout and on the holdout with its labels
               flipped (where the run must stop); the masks of iterations
               0-2 bitwise equal card vs CPU; (b) hist_bits=16 at max_bin
               255 (5 rounds): every launch int16, as many as histograms,
               holdout AUC above 0.8 and its gap to phase 3's f32 fit
               printed; q16 within 0.005 of f32 held at the size
               tests/test_gbdt_dist_quant.py pins it (4096 rows); (c)
               hist_bits=8 at max_bin 63: every launch int8, AUC finite
               and above 0.5; (d) q16 + sampling, 5 rounds with
               keepTrainingData then boost_more(5) bitwise equal to 10
               rounds in one call, then boost_more(5) on the holdout: 15
               iterations, finite scores; (e) a 20k-row q16 fit on the
               card and on the CPU (AUC within 0.005), the iteration-0 L1
               scales of each, and the q16 / q8 rounding of the same f32
               stats and the int16 / int8 root and masked-child
               histograms bitwise equal across the two.
  8. GBDT ingest beyond dense input — (a) the Bosch production-line
               shape of NVIDIA's gbm-bench as a CSRMatrix (1,183,747 rows
               x 968 float32 features, ~19 % nonzero, seed 7, drawn on
               the card; 100k more CSR rows held out) in a DataTable,
               TPUBoostClassifier (63 leaves, max_bin 255, 5 rounds) on
               the card, traced: fit s, train_timing, launches (one per
               histogram), hist share of the boost, holdout AUC;
               transform_sparse of 100k rows bitwise equal to the host
               library's dense transform and to the fit's bins; a 50k-row
               slice fitted from CSR and from its dense copy with equal
               upper_bounds and bitwise equal forests; predict on the CSR
               holdout bitwise equal to predict on its dense copy; the
               kernel on the table's bins at a root and a 5 % child
               against hist_plain in float64 (counts exact; g and h within
               rtol 1e-5 / atol 1e-3 + 2e-7 of the bin's absolute mass,
               since ~960k rows share a zero bin), with
               its time, the plain version's, a weighted bincount's and
               the bound. (b) phase 3's 1M x 28 table as .npy columns:
               ChunkedTable.from_npy (65,536-row chunks) fits with binFit
               'sample' and 'sketch', and booster.train on a list of (X,
               y) shards: fit s, OOCStats, holdout AUC within 0.005 of
               phase 3's dense fit, the chunk bytes alive at once (weakref
               count) within tracked_peak_bytes = (depth + 2) x peak
               chunk, the sketch cuts within 2 x sketch_eps in rank of an
               exact all-rows fit, and a sketch fit that never compacts
               (values on a 1/40 grid) giving the dense fit's cuts
               bitwise. (c) the host binning library (csrc/bins.cpp)
               bitwise equal to _numpy_bin_block on the 1M x 28 table in
               float32 and float64, all features and a range, with host
               ms and the OpenMP thread count.
  9. zoo networks — at the widths the repo uses, step counts cut: (a)
               bench.py's bench_cifar ConvNet ([64, 64, 64] / [256], 10
               classes, inputShape [32, 32, 3], batch 1024, bf16, device
               feed, lr 0.1, Nesterov momentum, cosine) on seeded
               CIFAR-shaped data for 1 epoch of 32 steps (bench.py: 9 of
               128); (b) bench_resnet's ResNet-20 the same way. Each prints
               imgs/s, step ms, peak memory and MFU; losses finite, the
               last below the first; ResNet-20's running statistics moved
               and finite, and its model's logits of rows 0-7 alone within
               2**-6 of theirs inside a 256-row batch (eval mode reads the
               running statistics). (c) a ResNet [1, 1] / width 16 trained
               2 SGD steps at batch 8 in f32 on the card and on the CPU
               from the same weights (losses within rtol 1e-4, weights and
               running statistics within 1e-3 of the largest update), and
               one f32 forward of the ConvNet, ResNet-20 and BiLSTM card
               vs CPU within 1e-4 of the output's scale, with the error
               TF32 would have left printed beside it. (d) the BiLSTM at
               examples/304_bilstm_tagger.py's shape (vocab 50, embed 32,
               hidden 64, 3 tags, T = 12, 512 rows, batch 128, adam 0.01,
               f32, 30 epochs): held-out per-token accuracy above 0.9,
               step ms. (e) ResNet-18 (imagenet stem, [2, 2, 2, 2], width
               64, 1000 classes, seeded weights): TPUModel.transform of
               1024 224 x 224 x 3 images at batch 256 in bf16 and f32,
               imgs/s of the second of two runs, finite logits of shape
               (1024, 1000).
 10. image path — at ResNet-18 width, on the card: (a) ImageTransformer
               resize(224, 224).gaussian_kernel(5, 0).flip() on a uniform
               batch of 256 seeded 375 x 500 x 3 uint8 images, ms a batch,
               uint8 outputs against the same stage on the CPU (at most 1
               apart in at most 0.1 % of the pixels). (d) a seeded
               torchvision-layout resnet18 state dict saved as .pth and
               as bf16 .safetensors, both imported
               (import_torchvision_resnet; the bf16 import equal to the
               .pth import rounded to bf16), published to a LocalRepo and
               fetched through ModelDownloader bitwise. (b) ImageFeaturizer
               (TORCHVISION_RESNET18_SPEC, cutOutputLayers=1: 512
               features, strict f32) over 1024 seeded Flowers-sized uint8
               images (heights 240-500, widths 320-500, two classes of
               pixel mean 60 / 180; no decode) at batchSize 64 and 256:
               imgs/s, the image_resize / image_forward medians, the
               card's idle share of a profiled transform, one forward
               shape each; images 0-7 against the CPU forward of the same
               weights (rtol 1e-4, atol 1e-5 of the scale). (c)
               TPUBoostClassifier on the card on those features: holdout
               accuracy above 0.9 on the last 256 images.
 11. AutoML slice — on bench_automl's table (profile_automl.automl_table:
               1M rows from seed 0 of x1 with 1 % NaN, x2, a 12-level
               color and token lists of 5-12 words of 2,000; label
               (x1 + x2) > 0.5): (a) Featurize (x1, x2, color, toks; hash
               width 64) fit and transform seconds, the hashing path
               (pyarrow or the numpy fallback), transform bitwise equal to
               transform_rowloop on the first 100,000 rows and, where
               pyarrow is installed, to the transform with it blocked
               (the numpy path, timed); (b)
               TrainClassifier with its default GBDT on the label as the
               strings '>50K' / '<=50K' (the ValueIndexer path), fitted on
               900,000 rows, scored on the other 100,000: hist launches
               counted around the fit (above 0), scored_labels
               round-tripping to the strings; the same table at 10 rounds
               through the kernel and the GBDT's plain scatter path,
               holdout AUCs from ComputeModelStatistics within 0.005; the kernel on the fit's own bins at a root
               against hist_plain in float64 (rtol 1e-5 / atol 1e-3), with
               its time, the plain version's, a bincount's and the bound;
               (c) TuneHyperparameters over bench_automl's space (8
               TPULogisticRegression(maxIter=20) candidates, 3 folds,
               accuracy) on the first 200,000 featurized rows: path
               'vmap' in 3 dispatches, the same bestParams as with
               batchTrials='off', walls and the tune_* histograms; (d)
               Featurize(sparse=True) at the reference's width 262,144 on
               200,000 rows and TPULogisticRegression on the CSR column
               (the logistic backend's fit): two card fits bitwise equal,
               holdout accuracy above 0.9, fit seconds; (e) a serial tune
               of two GBDT candidates (numIterations 5 and 10,
               minDataInLeaf 5, 2 folds, 100,000 rows) at parallelism 4 and
               1: equal history; (f) a dense logistic and a linear
               regression fit (maxIter 300, 20,000 rows) on the card and on
               the CPU: weights within rtol 1e-4 / atol 1e-5 of their
               largest magnitude, predictions equal (logistic) or within
               that rule (linear) on at least 99.9 % of the rows.
 12. models in and out — (a) tests/onnx_writer.py's resnet18 graph at
               width 64 / 1000 classes (seed 0) published with its
               onnx_summary manifest (20 Conv nodes) into a LocalRepo
               that the port's WebDAV server serves, read back through
               HTTPRepo sha256-verified, import_onnx_model(batch_size=256,
               input_shape=[3, 224, 224]) over 1024 seeded images: import
               s, first batch s, imgs/s; card vs CPU on 8 rows within
               rtol 2e-4 and atol 2e-4 of the logits' scale (the writer's
               weights do not preserve variance: logits ~1e8), argmax
               equal; the reference tests' BiLSTM, GRU and BERT-style
               block graphs card vs CPU within rtol / atol 2e-4. (b)
               LM_SPEC (seeded) quantized on 2 x 1024 tokens, 20 x 1024 at
               batch 8: 8 flash launches and 33 int8 GEMMs a batch, finite
               logits, rows 16-19 alone equal to the full run, seconds
               against the f32 transform, argmax agreement with f32; each
               int8 GEMM shape at M = 8192 bitwise equal to
               int8_matmul_host (all rows through an exact float64
               accumulator on the card, 16 rows literally) and its card
               weight quantization to quantize_weight's, timed as
               torch._int_mm, strict-f32 torch.matmul, its bound (1979
               TOP/s int8, 3.35 TB/s), the quantize and epilogue passes;
               a depth-2 int8 model card vs CPU: the first layer's int8
               inputs equal but for <= 0.1 % one step apart, and no
               further from the CPU than int8 is from f32 (argmax, max
               |diff|). (c) bench_lm's fit at LM_SPEC's width, depth cut
               to 2 (bf16, AdamW, constant schedule, device feed, 32 x
               1024 at batch 8, checkpointEvery 4): 2 epochs, then 1 epoch into a fresh
               directory and 2 epochs resuming from it, the last 4 losses
               and final weights bitwise equal (or, if not, within the
               full fit's own repeat difference); save / load seconds,
               bytes, free disk; a truncated newest leaves.npz falls back
               to step 4; bench.py's CIFAR ConvNet (batch 1024) through a
               webdav:// checkpoint directory, the same check.
 13. fused and streamed pipelines — at the reference benchmarks' own
               sizes: (a) bench.py's bench_pipeline (profile_pipeline.
               pipeline_table: 1M raw rows of x1 with 1 % NaN, x2, a
               128-level string, token lists of 3-6 words from 800;
               Featurize(32, one-hot) -> StandardScaler ->
               TPULogisticRegression(maxIter=40) -> DropColumns fitted
               on 100,000 rows) through PipelineModel.transform
               (staged_host), transform_staged (staged_device) and fused,
               cold (a fresh table view) and warm: fused bitwise
               staged_device, predictions equal staged_host but on
               near ties (top-two margin under 1e-5), probabilities
               within 1e-5, no new shape and no column re-shipped on
               warm repeats, one device round trip a transform; the
               warm transform profiled (torch.profiler) in a fresh
               interpreter (profile_pipeline.warm_profile): one
               device-to-host copy, its busy share printed; (e) that
               pipeline behind
               serve_model(json_scoring_pipeline(pm), port=0,
               batch_size=256, workers=2, max_wait_ms=5): 2,000 one-row
               raw JSON requests from 16 client threads of a spawned
               process, every reply equal to the fused transform of its
               row (near ties aside), one device-to-host copy a batch;
               (b) bench_ooc at 4M rows (its 10M cut for the time
               limit) made chunk by chunk (262,144,
               prefetch 3), Featurize fitted streamed, StandardScaler
               from a ChunkedTable, the logistic head, then
               fuse([...]).transform_chunked: the 1.5 GB host budget
               held on tracked_peak_bytes and on RSS growth (VmRSS
               sampled every 5 ms), exceeded by the materialized
               baseline, the first chunk's predictions bitwise its own
               fused transform, prediction sums within 1e-6 x rows; the
               decode / prepare / wait / dispatch sums, the overlap and
               decode-hidden fractions; SummarizeData on a 1M-row
               ChunkedTable against the materialized run (counts and
               moments within 1e-6, sketch percentiles within 0.005 in
               rank); (c) LM_SPEC's TPUModel (phase 4's seeded model,
               20 x 1024 tokens) as a one-stage PipelineModel,
               fused(batch_size=8): exactly 24 flash_fwd_tf32x3 launches,
               logits bitwise TPUModel.transform's; (d) bench_lm's fit
               (bf16, AdamW 1e-3, batch 8) on 32 rows x 1024 tokens from
               ChunkedTable.from_npy in chunks of 8 for 2 epochs: exactly
               64 launches of each bf16 flash kernel, 8 chunks decoded
               (no counting pass), losses bitwise the same fit from the
               list of the eight-row tables; (f) phase 3's max_bin 255
               model as a one-stage fused pipeline over the holdout:
               rawPrediction and prediction bitwise phase 3's transform.
 14. request tracing and serving telemetry — on by default in the engine,
               so phases 6 and 13(e) serve with it on and print their
               traces, SLO samples and alerts beside requests/s. (a) in a
               fresh interpreter (python3 -m
               mmlspark_tpu_torch.profile_telemetry, where torch.profiler
               sees the card): phase 3's 1M x 28 fit (63 leaves, max_bin
               255, 5 rounds) timed with the process tracer on and off,
               twice each, then traced under the profiler: one bin, ship
               and boost span, boost_chunk spans within 5 % of
               train_timing's boost, the gbdt_train_histograms counts up
               by one fit, and on the timeline merged by a clock marker
               every hist_partial / hist_reduce kernel inside a boost
               span, as many hist_partial kernels as hist launches; then
               that model served with phase 6's traffic (2,000 requests
               from 16 threads of a spawned client process, replies
               equal transform's), without and under the profiler, each
               device span against the card work launched in it;
               (b) bench_lm's bf16 fit (phase 5's 32 x 1024, 2 epochs)
               with memoryStatsEvery 4: one learner.fit trace with a
               step span a step, memory samples above 0 bytes, 64
               launches of each flash kernel, each step span against
               the card time it launched; (c)
               phase 6's model and client, 2,000 requests each carrying a
               traceparent, in two fresh engines through
               profile_telemetry.onoff_turns: the defaults and tracing,
               slo and flight_recorder False, in the turns on, off:
               requests/s, p50 / p99 and their ratios;
               replies equal transform's in every turn; in the first:
               /debug/traces valid chrome JSON whose request roots
               continue their client's trace under queue_wait, every
               device span linking the roots it served; /metrics clean
               under testing.metrics_check with the serving_slo_*, process and
               device_memory_* families (bytes_in_use above 0); /healthz's
               slo section; a log line from inside a request's device
               span carrying its trace id; (d) a 1 us latency objective:
               it fires, the recorder writes one bundle (traces, log
               ring, SLO status), stop() leaves no hook.
 15. model lifecycle and the client fleet — (a) phase 3's max_bin 255
               model (v1) refreshed by Booster.boost_more(5) on its
               training table: hist launches equal the histograms built
               (>= 5), v2's holdout AUC >= v1's - 0.005; then one engine
               of v1 driven by 16 threads of a spawned process (JAX
               blocked there, no CUDA) through ServingFleet.connect, for
               the steady state, and a 3-engine ServingFleet of v1 on the
               card (phase 6's batch 256, 2 workers, 5 ms) under the same
               client: (c) a PoisonedModel over v2 with a seeded error
               rate rolls back on the first engine and halts under 1,000
               requests, no client error, every reply v1's or (a clean
               canary batch) v2's and v1's after the rollback,
               swaps_rolled_back 1, a swap_rollback flight-recorder
               bundle; (b) rolling_swap to v2 (canary
               0.25, 8 batches) mid-way through 3,000 requests: every
               reply v1's or v2's prediction of its row, every request
               sent after the swap v2's, availability >= 99 %, three
               completed swaps in the fleet's and the engines' /metrics;
               requests/s and p50 / p99 before, during and after, and
               each engine's seconds in each swap state; (d) engine 1
               killed under 1,000 hedged requests: availability >= 99 %,
               the client's breaker open, the fleet's own breaker open
               and a circuit_open bundle; (e) one traced request: its
               client leg and the engine's request span share a trace id
               in merge_chrome_traces.
 16. the stage registry and AOT serving artifacts — (a) the CLI in this
               process: stages --json (every registered stage of the
               port), describe TPUBoostClassifier, codegen into build/
               (a doc per stage) and the generated smoke tests run
               in-process; (b) cli run of a JSON spec (TPUBoostClassifier,
               63 leaves, max_bin 255, 5 rounds) on phase 3's 1M x 28
               table written as .npz, in this process: exactly 315 hist
               launches, the saved forest bitwise phase 3's API fit; then
               cli score of the saved model in a fresh process, its
               outputs bitwise phase 3's transform; (c) experiment fuzzing
               of every TestObject (testing/fuzz_objects.py) whose stage
               has a device param, on the card and on the CPU, the tables
               equal within max(the object's tol, 1e-4) (the shapes only
               for a learner whose weights are drawn on the card); (d)
               serving/aot.py: phase 4's seeded LM_SPEC TPUModel (f32,
               depth 8, batch 8) exported (torch.export, the flash forward
               as the custom op) and loaded in this process: the 20 x
               1024 logits bitwise the in-process model's, exactly 8
               flash launches a forward, jit_cache_misses 0, export /
               load seconds, artifact bytes, warm transform eager against
               the loaded program; phase 3's forest behind a
               FastVectorAssembler of its 28 features as raw JSON fields
               (a JSON list decodes to a list column, which no device op
               reads), fused at batch 256, exported and loaded: every
               bucket's replies bitwise the in-process pipeline's and
               phase 3's transform, jit_cache_misses 0;
               then fresh-process cold starts of the LM artifact, one
               in each mode (trace, then aot): each mode's
               cold_start_to_first_200_ms, model_ready_ms,
               first_request_ms, jit_traces_total and
               jit_traces_at_request_time (0), where the time went, and
               their ratio.
 17. the multi-model plane — over phase 16's LM artifact (f32) and an
               int8 artifact of the same seeded model exported here:
               (a) bench_zoo's shape: 256 host models and the LM behind a
               2-engine in-process fleet sharing one ModelZoo (cache 32,
               2 workers each, default admission), 2,000 requests from
               16 clients over zipf(1.1) picks and 4 tenants, every 40th
               to the LM after one cold LM request: the cold request's
               ms and its activation's, requests/s, p50 / p99,
               availability (>= 99 %), activations, evictions,
               evictions_with_outstanding (0), exactly 8 flash launches
               a LM forward, every LM reply bitwise phase 16's loaded
               model's on the same row; (b) three versions of the LM
               artifact under the live memory probe (memory_headroom set
               halfway between two residents plus a forward's transient
               and three residents), requests v1 -> v2 -> v3 -> v1: the
               two evictions lru:memory_pressure of the LRU version,
               cost_source 'device' on each activation, memory_allocated
               falling by the victim's resident_bytes within 5 %, every
               request 200; (c) the [f32, int8] ladder (slo_ms (a)'s LM
               p99, declared costs 1 and 0.25) under a 24-client burst: a
               queue_pressure step down, replies from the int8 rung, the
               step back up within hold_s of the burst's end, each
               rung's p50 / p99; (d) a resident host model's p50 / p99
               under 4 clients with nothing activating and while an LM
               version activates.
 18. the control plane and host transports — (a) phase 3's max_bin 255
               forest served on the card (phase 6's settings) with a
               DriftMonitor of its training rows, driven by 16 threads of
               a spawned client: 1,000 steady holdout requests, then a
               drifted HIGGS-shaped stream (features 5-7 +4 sigma, 1-2 +1
               sigma, the same label rule) while a ContinuousTrainer
               (ReplayWindow of 262,144 rows fed as four 65,536-row
               labelled chunks, GatePolicy(shadow_rows=512),
               CanaryPolicy(0.5, 3)) triggers on the drift, refits by
               boost_more(5) over the window on its trainer thread, gates
               and cuts over: the timeline triggered, refit_ok,
               shadow_pass, promote_started, promoted; one hist launch a
               histogram; the candidate bitwise the same boost_more on
               this thread over the same snapshot; its drifted-holdout
               AUC above the base's and within 0.005 of the plain
               scatter refit's; availability 1.0000; replies after the
               cutover the candidate's batched prediction (near ties
               left out); reaction seconds and client p50 / p99 steady,
               during the refit and cutover and after; /healthz's
               controlplane field; /metrics' drift and control-plane
               families clean under testing.metrics_check; then a
               label-flipped refit by trigger_now: shadow_fail,
               quarantined with a bundle, serving unchanged. (b) four
               engine processes of testing/serving_worker.py (the forest
               on the card, batch 64, 1 worker) behind
               ServingFleet.connect with shm_transport True, then False:
               4 clients x 512-row post_columns, 1.5 s warm + 6 s each:
               rows/s and p50 / p99; shm fallbacks 0 and
               serving_shm_batches_total > 0; replies of both transports
               bitwise each other's and the in-process transform's;
               every slot free; the segment gone after stop_all; every
               worker exited.
Then one JSON line of the int8 GEMMs' times (a library call, not a
ported kernel), one JSON line of per-kernel numbers (the hist rows
include the int16 and int8 launches of 7(b) and 7(c), the F = 968
launches of 8(a), the launches of 11(b)'s fit on its featurized bins,
of 14(a)'s fit, of 15(a)'s boost_more, of 16(b)'s cli run and of
18(a)'s two refits; the flash
rows phase 12's, 13's, 14(b)'s, 16(d)'s and 17's launches),
the card's name and power limit, and as the last line
{"ok": true, "device": {...}}.

Needs a CUDA card; without one it exits 1 and prints no result.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate
# useful f32-contract work on the tensor cores: 3 TF32 products (3xTF32) per
# f32 product at the dense TF32 rate, the least time for f32 attention
F32_CONTRACT_OPS_PER_S = 495e12 / 3
N_TRAIN, N_TEST = 1_000_000, 100_000
# (B, Lq, Lk, H, D, causal, q_offset, k_offset): the slice's attention,
# the ragged cases of tests/test_flash_attention.py, shard offsets, a
# fully masked shard, a wide head, the tile edges of the tensor-core
# route (Lq, Lk in {1, 17, 65, 1000}, D in {8, 20, 64, 256}), and a long
# causal sequence, where sums accumulated inside the tensor cores (which
# truncate) would drift past the f32 tolerance
FLASH_MAIN = (8, 1024, 1024, 16, 128, True, 0, 0)
FLASH_CASES = [FLASH_MAIN,
               (2, 100, 100, 3, 16, True, 0, 0),
               (2, 300, 520, 3, 16, False, 0, 0),
               (2, 520, 300, 3, 16, True, 0, 0),
               (2, 100, 100, 3, 16, True, 64, 0),
               (2, 100, 100, 3, 16, True, 0, 1000),
               (1, 300, 300, 2, 160, True, 0, 0),
               (1, 1, 1, 2, 64, True, 0, 0),
               (1, 17, 65, 2, 20, False, 0, 0),
               (1, 65, 17, 2, 8, True, 0, 0),
               (1, 65, 1000, 2, 64, True, 935, 0),
               (1, 1000, 65, 3, 64, False, 0, 0),
               (2, 1000, 1000, 2, 256, True, 0, 0),
               (1, 8192, 8192, 1, 128, True, 0, 0)]
# q, k, v as views one element into wider rows: no row is 16-byte aligned
FLASH_UNALIGNED = (1, 300, 300, 2, 64, True, 0, 0)
# the tensor-core kernels by library (bf16, and f32 in 3xTF32); each must
# run HMMA instructions, and at D = 128 (the slice's head) spill nothing
TC_KERNELS = {"flash_fwd": ("flash_fwd_bf16", "flash_fwd_tf32x3"),
              "flash_bwd": ("flash_dkv_bf16", "flash_dq_bf16",
                            "flash_dkv_tf32x3", "flash_dq_tf32x3")}
TC_AT_128 = ("flash_fwd_bf16<128>", "flash_fwd_tf32x3<128>",
             "flash_dkv_bf16<128, 1>", "flash_dq_bf16<128, 1>",
             "flash_dkv_tf32x3<128>", "flash_dq_tf32x3<128, 1>")
# the kernels whose blocks per SM phase 1 prints at D = 128: (kernel,
# library, C entry)
OCCUPANCY = (("flash_fwd_tf32x3<128>", "flash_fwd",
              "mml_flash_fwd_f32_occupancy"),
             ("flash_dq_bf16<128, 1>", "flash_bwd",
              "mml_flash_dq_bf16_occupancy"),
             ("flash_dq_tf32x3<128, 1>", "flash_bwd",
              "mml_flash_dq_f32_occupancy"),
             ("flash_dkv_tf32x3<128>", "flash_bwd",
              "mml_flash_dkv_f32_occupancy"))


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def short_name(mangled: str) -> str:
    """``flash_fwd_bf16<128>`` for the mangled name of a kernel in the
    port's anonymous namespace (template arguments: ints, float, bf16)."""
    if not mangled.startswith("_ZN"):
        return mangled
    i, name = 3, mangled
    while True:      # length-prefixed components: namespace, then name
        m = re.compile(r"(\d+)").match(mangled, i)
        if m is None:
            break
        i = m.end() + int(m.group(1))
        name = mangled[m.end():i]
    if i >= len(mangled) or mangled[i] != "I":
        return name
    args, i = [], i + 1
    while i < len(mangled) and mangled[i] != "E":
        lit = re.compile(r"Li(-?\d+)E").match(mangled, i)
        num = re.compile(r"(\d+)").match(mangled, i)
        if lit:
            args.append(lit.group(1))
            i = lit.end()
        elif num:
            j = num.end() + int(num.group(1))
            args.append(mangled[num.end():j])
            i = j
        else:
            args.append({"f": "float", "i": "int", "s": "short",
                         "a": "signed char"}.get(mangled[i], mangled[i]))
            i += 1
    return f"{name}<{', '.join(args)}>"


def ptxas_table(log: str):
    """{kernel: [registers, spill store bytes, spill load bytes, shared
    bytes]} from the ``nvcc -Xptxas -v`` output of a build."""
    table, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", ln)
        if m:
            name = short_name(m.group(1))
            table.setdefault(name, [0, 0, 0, 0])
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            table[name][1:3] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            table[name][0] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", ln)
        if m:
            table[name][3] = int(m.group(1))
    return table


def hmma_counts(lib) -> dict:
    """{kernel: number of HMMA (tensor-core) instructions} in the SASS of
    a built library, read with cuobjdump; fails where cuobjdump is
    missing."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check(os.path.exists(exe), "cuobjdump not found: cannot show that the "
          "bf16 kernels run on the tensor cores")
    sass = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump -sass {lib}: {sass.stderr}")
    counts, name = {}, None
    for ln in sass.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = short_name(m.group(1))
            counts[name] = 0
        elif name is not None and "HMMA" in ln:
            counts[name] += 1
    return counts


def higgs_shape(n: int, seed: int = 7):
    """HIGGS-shaped synthetic binary task (the generator of
    tests/test_gbdt_dist_quant.py): 28 dense f32 features."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 28)).astype(np.float32)
    logit = (X[:, 0] + 0.6 * X[:, 1] * X[:, 2]
             + 0.4 * np.sin(2 * X[:, 3]) - 0.3 * X[:, 4] ** 2 + 0.3)
    y = (logit + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    return X, y


def auc(y, p) -> float:
    order = np.argsort(p, kind="stable")
    ranks = np.empty(len(p))
    ranks[order] = np.arange(1, len(p) + 1)
    n_pos = int((y == 1).sum())
    n_neg = len(y) - n_pos
    return float((ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def served(engine, label: str, bodies, n_threads: int,
           traceparents=None):
    """Drive ``engine`` with ``bodies`` through ``profile_serving.drive``
    (``n_threads`` keep-alive client threads of a spawned process;
    ``traceparents[i]`` rides request i), check that its source counted
    every reply and its threads live, print the numbers and the engine's
    telemetry (traces buffered, SLO samples, alerts). Returns (replies,
    numbers). Any non-200 reply or client error, or a client process
    that does not finish, fails the run."""
    from mmlspark_tpu_torch.profile_serving import drive, latency_numbers
    traces0 = (engine.tracer.buffer.stats()["added"]
               if engine.tracer is not None else 0)
    replies, lat, wall, errors = drive(engine, bodies, n_threads,
                                       traceparents)
    check(not errors, f"{label}: serving errors {errors[:5]}")
    n = len(bodies)
    check(engine.source.requests_answered == n,
          f"{label}: {engine.source.requests_answered} answered of {n}")
    check(engine.is_alive() and engine.workers_restarted == 0,
          f"{label}: an engine thread died "
          f"({engine.workers_restarted} restarts)")
    m = engine.metrics()
    numbers = {**latency_numbers(lat, wall),
               "traces": (engine.tracer.buffer.stats()["added"] - traces0
                          if engine.tracer is not None else 0),
               "slo_samples": (engine.slo.requests(3600.0)
                               if engine.slo is not None else 0),
               "alerts_fired": (engine.slo.alerts.stats()["fired_total"]
                                if engine.slo is not None else 0)}
    print(f"{label}: {n} requests from {n_threads} clients (a second "
          f"process) in {wall:.3f} s "
          f"({numbers['rps']:.1f} requests/s), client p50 "
          f"{numbers['p50_ms']:.3f} ms, p99 "
          f"{numbers['p99_ms']:.3f} ms; {m['batches_processed']} "
          f"batches, {m['batch_rows'].get('mean', 0):.2f} rows per batch; "
          f"p50 ms: queue_wait {m['queue_wait_ms'].get('p50')}, decode "
          f"{m['decode_ms'].get('p50')}, pipeline "
          f"{m['pipeline_ms'].get('p50')}, respond "
          f"{m['respond_ms'].get('p50')}; telemetry: tracing "
          f"{'on' if engine.tracer is not None else 'off'} "
          f"({numbers['traces']} request traces finished), SLO monitor "
          f"{'on' if engine.slo is not None else 'off'} "
          f"({numbers['slo_samples']:.0f} samples, "
          f"{numbers['alerts_fired']} alerts), flight recorder "
          f"{'on' if engine.flight_recorder is not None else 'off'}")
    return replies, numbers


RELOAD_CHECK = """
import sys
sys.modules["jax"] = None
sys.modules["mmlspark_tpu"] = None
import numpy as np
from mmlspark_tpu_torch.core.stage import load_stage
from mmlspark_tpu_torch.core.table import DataTable
model = load_stage(sys.argv[1])
assert model.get("device") == "cuda", model.get("device")
ref = np.load(sys.argv[2])
out = model.transform(DataTable({"features": ref["features"]}))
for col in ("rawPrediction", "probability", "prediction"):
    assert np.array_equal(np.asarray(out[col]), ref[col]), col
bad = [k for k, v in sys.modules.items() if v is not None
       and k.split(".")[0] in ("jax", "jaxlib", "flax", "mmlspark_tpu")]
assert not bad, bad
print("reload OK")
"""


def serving_slice(model, out, Xte, smi: str) -> None:
    """Phase 6: save -> reload (fresh jax-blocked process) -> serve."""
    import torch
    from mmlspark_tpu_torch.core.stage import load_stage
    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.gbdt import hist_kernels as HK
    from mmlspark_tpu_torch.models.networks import build_network
    from mmlspark_tpu_torch.models.tpu_model import TPUModel
    from mmlspark_tpu_torch.serving import (
        json_row_scoring_pipeline, json_scoring_pipeline, serve_model)

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "chip_smoke_serving")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "model_max_bin_255")
    t0 = time.perf_counter()
    model.save(path)
    save_s = time.perf_counter() - t0
    ref = os.path.join(work, "phase3_holdout.npz")
    np.savez(ref, features=Xte, **{c: np.asarray(out[c]) for c in (
        "rawPrediction", "probability", "prediction")})
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", RELOAD_CHECK, path, ref],
                       capture_output=True, text=True, cwd=root,
                       env={**os.environ, "PYTHONPATH": root}, timeout=300)
    check(r.returncode == 0 and "reload OK" in r.stdout,
          f"reload in a jax-blocked process failed: {r.stderr[-2000:]}")
    print(f"serving slice: saved in {save_s:.3f} s; reloaded in a fresh "
          f"jax-blocked process ({time.perf_counter() - t0:.1f} s): "
          f"transform of {len(Xte)} holdout rows bitwise equal to phase 3's")

    loaded = load_stage(path)
    raw = np.asarray(out["rawPrediction"])
    pred = np.asarray(out["prediction"])
    HK.reset_launches()
    engine = serve_model(json_scoring_pipeline(loaded), port=0,
                         batch_size=256, workers=2, max_wait_ms=5)
    try:
        bodies = [json.dumps({"features": Xte[i].tolist()}).encode()
                  for i in range(2000)]
        replies, _ = served(engine, "serving slice GBDT (json_scoring_"
                         "pipeline)", bodies, 16)
    finally:
        engine.stop()
    bad = [i for i, rep in enumerate(replies)
           if rep != {"prediction": int(pred[i])}]
    check(not bad, f"{len(bad)} GBDT replies differ from transform, first "
          f"{[(i, replies[i], pred[i]) for i in bad[:3]]}")
    engine = serve_model(json_row_scoring_pipeline(
        loaded, reply_col="rawPrediction"), port=0, batch_size=256,
        workers=2, max_wait_ms=5)
    try:
        bodies = [json.dumps({"features": Xte[i].tolist()}).encode()
                  for i in range(200)]
        replies, _ = served(engine, "serving slice GBDT (json_row_scoring_"
                         "pipeline, rawPrediction)", bodies, 16)
    finally:
        engine.stop()
    bad = [i for i, rep in enumerate(replies) if rep != raw[i].tolist()]
    check(not bad, f"{len(bad)} rawPrediction replies not bitwise equal "
          f"to transform's, first {[(i, replies[i]) for i in bad[:3]]}")
    launches = dict(HK.LAUNCHES)
    print(f"serving slice: 2000 predictions equal to transform's, 200 "
          f"rawPrediction replies bitwise equal; hist launches while "
          f"serving {launches} (the forest walk is plain torch)")

    # the MLP scorer of bench.py's bench_serving, on the card
    dim = 128
    net = build_network({"type": "mlp", "features": [256, 128],
                         "num_classes": 10, "in_features": dim},
                        device="cuda", seed=0)
    mlp = TPUModel.from_module(net, device="cuda", inputCol="features",
                               outputCol="scores", batchSize=256,
                               computeDtype="float32")
    x = np.random.default_rng(0).normal(size=(400, dim)).astype(np.float32)
    t0 = time.perf_counter()
    compiled = mlp.warmup({"features": x[:1]})
    warm_s = time.perf_counter() - t0
    check(compiled == len(mlp.bucket_sizes()),
          f"MLP warmup met {compiled} new shapes, not "
          f"{len(mlp.bucket_sizes())}")
    check(mlp.warmup({"features": x[:1]}) == 0, "second warmup not warm")
    want = mlp.transform(DataTable({"features": x}))["scores"].argmax(-1)
    torch.cuda.synchronize()
    engine = serve_model(json_scoring_pipeline(mlp), port=0,
                         batch_size=256, workers=2, max_wait_ms=5)
    try:
        bodies = [json.dumps({"features": row.tolist()}).encode()
                  for row in x]
        replies, _ = served(engine, "serving slice MLP (bench_serving "
                         "scorer)", bodies, 16)
    finally:
        engine.stop()
    bad = [i for i, rep in enumerate(replies)
           if rep != {"prediction": int(want[i])}]
    check(not bad, f"{len(bad)} MLP replies differ from transform")
    check(mlp.jit_cache_misses == len(mlp.bucket_sizes()),
          f"serving met new shapes after warmup: {mlp.jit_cache_misses}")
    print(f"serving slice: MLP warmup ran {compiled} buckets "
          f"{mlp.bucket_sizes()} in {warm_s:.3f} s, 400 replies equal to "
          f"transform, no new shape while serving; card: {smi}")


def traced_fit(label: str, table, test_t, yte, profiled: bool = True,
               **kw):
    """One main-path fit of TPUBoostClassifier (63 leaves, seed 7; counts
    set to 0 just before, read just after): seconds, phases, holdout AUC,
    and, when ``profiled`` (traced on the device), the hist kernels'
    share of the boost window. Returns (model, booster, AUC, launches by
    stats type, launches by route)."""
    import contextlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mmlspark_tpu_torch.gbdt import hist_kernels as HK
    from mmlspark_tpu_torch.gbdt.estimators import TPUBoostClassifier
    from mmlspark_tpu_torch.profile_fit import union_us
    HK.reset_launches()
    ctx = profile(activities=[ProfilerActivity.CUDA]) if profiled \
        else contextlib.nullcontext()
    with ctx as prof:
        t0 = time.perf_counter()
        model = TPUBoostClassifier(numLeaves=63, seed=7, **kw).fit(table)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = dict(HK.LAUNCHES_BY_TYPE)
    routes = dict(HK.LAUNCHES)
    booster = model.get_booster()
    prob = np.asarray(model.transform(test_t)["probability"])
    check(prob.shape == (len(yte), 2) and np.isfinite(prob).all(),
          f"{label}: outputs {prob.shape} not finite")
    a = auc(yte, prob[:, 1])
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA] \
        if profiled else []
    hist = [e for e in ev if "hist_" in e.name]
    share = ("not measured (no device events traced)" if profiled
             else "not profiled")
    if hist:
        hist_ms = sum(e.time_range.end - e.time_range.start
                      for e in hist) / 1e3
        w0 = min(e.time_range.start for e in hist)
        w1 = max(e.time_range.end for e in hist)
        busy = union_us([(max(e.time_range.start, w0),
                          min(e.time_range.end, w1)) for e in ev
                         if e.time_range.end > w0
                         and e.time_range.start < w1])
        boost_ms = 1e3 * booster.train_timing["boost"]
        share = (f"hist kernels {hist_ms:.3f} ms = "
                 f"{100 * hist_ms / boost_ms:.2f} % of the boost phase "
                 f"({boost_ms:.1f} ms); device busy "
                 f"{100 * busy / max(w1 - w0, 1e-9):.1f} % of the "
                 "first-to-last hist window")
    print(f"{label}: fit {secs:.2f} s"
          f"{' under the CUDA profiler' if profiled else ''} "
          f"({booster.train_timing}), {booster.num_trees} trees, holdout "
          f"AUC {a:.5f}, histograms {booster.train_info['histograms']}, "
          f"launches by stats type {launches}; {share}")
    return model, booster, a, launches, routes


def training_options(train_t, test_t, Xtr, ytr, Xte, yte, auc255: float,
                     smi: str) -> dict:
    """Phase 7: the GBDT training options at full width. Returns the
    int16 / int8 hist launches of the main-path fits (b) and (c)."""
    import torch
    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.gbdt import hist_kernels as HK
    from mmlspark_tpu_torch.gbdt import prng
    from mmlspark_tpu_torch.gbdt.binning import BinMapper
    from mmlspark_tpu_torch.gbdt.estimators import TPUBoostClassifier
    from mmlspark_tpu_torch.gbdt.objectives import get_objective
    from mmlspark_tpu_torch.gbdt.tree import (
        _sround, quant_scales, sample_iteration_masks)
    from mmlspark_tpu_torch.profile_fit import threefry_costs

    dev = torch.device("cuda")
    sampled = dict(baggingFraction=0.8, baggingFreq=1, featureFraction=0.8)

    # only (a)'s first fit runs under the profiler: a profiled fit's
    # events take seconds to read, and the other fits' launches are
    # counted all the same
    def fit(label, table=train_t, profiled=False, **kw):
        model, booster, a, launches, _ = traced_fit(
            f"training options {label}", table, test_t, yte,
            profiled=profiled, **kw)
        return model, booster, a, launches

    def int_route_only(label, booster, launches, sdt):
        h = booster.train_info["histograms"]
        check(launches[sdt] == h and all(
            v == 0 for k, v in launches.items() if k != sdt),
            f"training options {label}: launches {launches}, {h} "
            f"histograms, all of them expected as {sdt}")

    # (a) bagging + feature fraction with early stopping on the holdout;
    # then on the holdout with its labels flipped, where the validation
    # loss rises from the first tree on, so that the run stops
    def stop_checks(label, booster, n_iter, esr):
        losses = booster.train_info["valid_loss"]
        m = len(losses)
        check(booster.best_iteration == 1 + int(np.argmin(losses)),
              f"{label}: best_iteration {booster.best_iteration} vs "
              f"1 + argmin of {m} losses")
        stopped = m - booster.best_iteration >= esr
        sync = min(esr, 8)
        want = min(n_iter, -(-m // sync) * sync) if stopped else n_iter
        check(stopped or m == n_iter, f"{label}: {m} losses read")
        check(booster.num_trees == want,
              f"{label}: {booster.num_trees} trees, the cadence gives "
              f"{want}")
        print(f"training options {label}: best_iteration "
              f"{booster.best_iteration} = 1 + argmin of the {m} losses "
              f"read, stopped {stopped}, {booster.num_trees} trees as the "
              f"every-{sync}-iterations cadence gives")

    _, ba, auc_a, la = fit("(a) bagging 0.8/1, feature_fraction 0.8, "
                           "early_stopping_round 5", profiled=True,
                           numIterations=30, earlyStoppingRound=5,
                           validationData=test_t, **sampled)
    check(la["float32"] == ba.train_info["histograms"],
          f"(a): launches {la}")
    stop_checks("(a)", ba, 30, 5)
    flipped = DataTable({"features": Xte, "label": 1.0 - yte})
    _, bf, _, _ = fit("(a) on the label-flipped holdout", numIterations=30,
                      earlyStoppingRound=5, validationData=flipped,
                      **sampled)
    stop_checks("(a) flipped", bf, 30, 5)
    check(bf.num_trees < 30, "(a) flipped: the run did not stop")
    # the masks drawn on the card equal the CPU's, and what a draw costs
    key = prng.PRNGKey(7)
    ones = {d: (torch.ones(N_TRAIN, device=d), torch.ones(28, device=d))
            for d in (dev, torch.device("cpu"))}
    for it in range(3):
        (wg, fg), (wc, fc) = (sample_iteration_masks(
            key, it, *ones[d], (0.8, 1), 0.8, 28, 28)
            for d in (dev, torch.device("cpu")))
        check(torch.equal(wg.cpu(), wc) and torch.equal(fg.cpu(), fc),
              f"(a): the masks of iteration {it} differ card vs CPU")
    costs = threefry_costs(torch)
    print(f"training options (a): bagging / feature-fraction masks of "
          f"iterations 0-2 bitwise equal card vs CPU ({N_TRAIN} rows); "
          + "; ".join(f"{label}: {dev_ms:.3f} ms on the card"
                      for label, (dev_ms, _) in costs.items()))

    # (b) hist_bits=16 at max_bin 255: the int16 launch of the route of
    # _hist_kernel_nibble; (c) hist_bits=8 at max_bin 63: the int8 launch
    # of the route of _hist_kernel
    _, bb, auc_b, lb = fit("(b) hist_bits=16, max_bin 255",
                           numIterations=5, histBits=16)
    int_route_only("(b)", bb, lb, "int16")
    # the global-L1 scale leaves each row about Q / N of a step (0.016 at
    # 1M rows), so q16's gap to f32 grows with the rows: held here to
    # 0.01; the 0.005 rule of tests/test_gbdt_dist_quant.py:101 is held
    # at the size it pins (4096 rows)
    check(abs(auc_b - auc255) < 0.01, f"(b): q16 holdout AUC {auc_b} vs "
          f"f32 {auc255} at 1M rows")
    Xs, ys = higgs_shape(6000)
    small_kw = dict(numIterations=6, numLeaves=15, maxBin=63,
                    minDataInLeaf=5)
    small_t = DataTable({"features": Xs[:4096], "label": ys[:4096]})
    hold_t = DataTable({"features": Xs[4096:], "label": ys[4096:]})
    a16, a32 = (auc(ys[4096:], TPUBoostClassifier(histBits=bits, **small_kw)
                    .fit(small_t).transform(hold_t)["probability"][:, 1])
                for bits in (16, 32))
    check(abs(a16 - a32) < 0.005, f"(b): at 4096 rows q16 AUC {a16} vs "
          f"f32 {a32}")
    print(f"training options (b): q16 vs f32 (phase 3) holdout AUC "
          f"{auc_b:.5f} vs {auc255:.5f} at 1M rows (|diff| "
          f"{abs(auc_b - auc255):.5f} < 0.01); at tests/test_gbdt_dist_quant.py's "
          f"4096 rows on the card {a16:.5f} vs {a32:.5f} (|diff| "
          f"{abs(a16 - a32):.5f} < 0.005)")
    _, bc, auc_c, lc = fit("(c) hist_bits=8, max_bin 63", numIterations=5,
                           histBits=8, maxBin=63)
    int_route_only("(c)", bc, lc, "int8")
    check(np.isfinite(auc_c) and auc_c > 0.5, f"(c): q8 AUC {auc_c}")

    # (d) retained continuation: 5 + boost_more(5) == 10 in one call
    kw = dict(numLeaves=63, seed=7, histBits=16, **sampled)
    HK.reset_launches()
    m5 = TPUBoostClassifier(numIterations=5, keepTrainingData=True,
                            **kw).fit(train_t)
    grown = m5.get_booster().boost_more(5)
    m10 = TPUBoostClassifier(numIterations=10, **kw).fit(train_t)
    torch.cuda.synchronize()
    ld = dict(HK.LAUNCHES_BY_TYPE)
    one = m10.get_booster()
    for k in one.trees:
        check(np.array_equal(grown.trees[k], one.trees[k]),
              f"(d): boost_more(5) after 5 differs from 10 in {k!r}")
    fresh = grown.boost_more(5, Xte, yte)
    pf = fresh.predict(Xte)
    check(fresh.num_trees == 15 and np.isfinite(pf).all(),
          f"(d): fresh-data boost_more: {fresh.num_trees} trees")
    print(f"training options (d): q16 + sampling, 5 rounds + boost_more(5) "
          f"bitwise equal to 10 in one call (launches {ld}); "
          f"boost_more(5) on the holdout: 15 iterations, finite scores, "
          f"holdout AUC {auc(yte, pf):.5f}")

    # (e) the card against the CPU: a 20k-row quantized fit on each
    small = DataTable({"features": Xtr[:20000], "label": ytr[:20000]})
    skw = dict(numIterations=5, numLeaves=15, maxBin=63, histBits=16,
               seed=7)
    pg = TPUBoostClassifier(device="cuda", **skw).fit(small) \
        .transform(test_t)["probability"][:, 1]
    pc = TPUBoostClassifier(device="cpu", **skw).fit(small) \
        .transform(test_t)["probability"][:, 1]
    ag, ac = auc(yte, pg), auc(yte, pc)
    check(abs(ag - ac) < 0.005, f"(e): card AUC {ag} vs CPU {ac}")
    obj = get_objective("binary")
    ys = ytr[:20000].astype(np.float64)
    s0 = np.float32(obj.init_score(ys, np.ones_like(ys))[0])
    yc = torch.from_numpy(ytr[:20000].astype(np.float32))
    gc, hc = obj.grad_hess(torch.full((20000,), float(s0)), yc)
    wc = torch.ones(20000)
    gg, hg = obj.grad_hess(torch.full((20000,), float(s0), device=dev),
                           yc.to(dev))
    sc = quant_scales(gc, hc, wc, 16)
    sg = quant_scales(gg, hg, wc.to(dev), 16)
    print(f"training options (e): iteration-0 L1 scales (dg, dh, dc) on "
          f"the CPU {[float(v) for v in sc]}, on the card "
          f"{[float(v) for v in sg]}, equal "
          f"{all(float(a) == float(b) for a, b in zip(sc, sg))}")
    bins = torch.from_numpy(BinMapper.fit(Xtr[:20000], max_bin=63)
                            .transform_fm(Xtr[:20000]))
    B = int(bins.max()) + 1
    zero = torch.zeros(20000, dtype=torch.int32)
    tk = prng.fold_in(prng.fold_in(prng.fold_in(key, 0), 3), 0)
    for bits, sdt in ((16, torch.int16), (8, torch.int8)):
        sc = quant_scales(gc, hc, wc, bits)
        qc = [_sround(v, d, tk, ch, sdt)
              for ch, (v, d) in enumerate(zip((gc * wc, hc * wc, wc), sc))]
        qg = [_sround(v.to(dev), d.to(dev), tk, ch, sdt)
              for ch, (v, d) in enumerate(zip((gc * wc, hc * wc, wc), sc))]
        check(all(torch.equal(a, b.cpu()) for a, b in zip(qc, qg)),
              f"(e): {bits}-bit rounding differs card vs CPU")
        for what, mask in (("root", torch.ones(20000, dtype=sdt)),
                           ("masked child", (bins[0] > B // 2).to(sdt))):
            ref = HK.hist_plain(bins, qc[0], qc[1], mask, zero, 1, B, qc[2])
            got = HK.hist_device(bins.to(dev), qg[0], qg[1], mask.to(dev),
                                 zero.to(dev), 1, B, qg[2])
            check(torch.equal(got.cpu(), ref),
                  f"(e): {bits}-bit {what} histogram differs from plain")
    print(f"training options (e): q16 / q8 rounding of the same f32 stats "
          f"bitwise equal card vs CPU, int16 / int8 root and masked-child "
          f"histograms bitwise equal to hist_plain; 20k-row q16 fit holdout "
          f"AUC card {ag:.5f} vs CPU {ac:.5f} (|diff| {abs(ag - ac):.5f} "
          f"< 0.005); card: {smi}")
    for bits, max_bin in ((8, 63), (16, 255)):
        replay_on_cpu("phase 3's rows", Xtr[:20000], ytr[:20000], bits,
                      max_bin)
    # and on the table of tests/test_torch_cuda.py's quantized-fit test
    rng = np.random.default_rng(7)
    Xq = rng.normal(size=(24_000, 28)).astype(np.float32)
    yq = (Xq[:, 0] + 0.6 * Xq[:, 1] * Xq[:, 2] + 0.3
          + rng.normal(scale=0.5, size=24_000) > 0).astype(np.float32)
    replay_on_cpu("the card test's rows", Xq[:20_000], yq[:20_000], 8, 63)
    return {"int16": lb["int16"], "int8": lc["int8"]}


def replay_on_cpu(rows: str, X, y, bits: int, max_bin: int) -> None:
    """Phase 7(e), tree by tree: a 20k-row quantized fit on the card in
    which every int histogram is held bitwise to ``hist_plain`` on the
    same inputs, and each tree to the CPU grower's given that tree's
    inputs and the card's three scales (structure, gains, values, leaf of
    every row). Then tree 0 on the CPU with its own scales, to show where
    the one-ulp difference of the f32 L1 sums parts the two fits."""
    import torch
    from mmlspark_tpu_torch.gbdt import booster as booster_mod
    from mmlspark_tpu_torch.gbdt import hist_kernels as HK
    from mmlspark_tpu_torch.gbdt import tree as tree_mod

    grown, scales, n_hist = [], [], [0]
    grow, build, qs = (booster_mod.grow_tree, tree_mod.build_histogram,
                       tree_mod.quant_scales)

    def rec_grow(bins, grad, hess, w, fm, gp, quant_key=None):
        out = grow(bins, grad, hess, w, fm, gp, quant_key=quant_key)
        grown.append(([t.cpu() for t in (bins, grad, hess, w, fm)], gp,
                      quant_key, out[0], out[1].cpu()))
        return out

    def rec_scales(*a):
        scales.append(qs(*a))
        return scales[-1]

    def held_hist(bins, g, h, w, leaf, L, B, method, count_values):
        out = build(bins, g, h, w, leaf, L, B, method=method,
                    count_values=count_values)
        ref = HK.hist_plain(*(t.cpu() for t in (bins, g, h, w, leaf)), L, B,
                            count_values.cpu())
        check(torch.equal(out.cpu(), ref), f"(e) q{bits}: int histogram "
              f"{n_hist[0]} of the fit differs from hist_plain")
        n_hist[0] += 1
        return out

    booster_mod.grow_tree, tree_mod.quant_scales = rec_grow, rec_scales
    tree_mod.build_histogram = held_hist
    try:
        booster_mod.train({"objective": "binary", "num_iterations": 5,
                           "num_leaves": 15, "max_bin": max_bin,
                           "hist_bits": bits, "seed": 7}, X, y,
                          device="cuda")
    finally:
        booster_mod.grow_tree, tree_mod.build_histogram = grow, build
        tree_mod.quant_scales = qs
    check(len(grown) == len(scales) == 5, f"(e) q{bits}: {len(grown)} trees")

    def cpu_tree(t, deltas):
        inputs, gp, key, _, _ = grown[t]
        if deltas is not None:
            tree_mod.quant_scales = lambda *a: deltas
        try:
            tr, leaf_of_row, _, _ = tree_mod.grow_tree(*inputs, gp,
                                                       quant_key=key)
        finally:
            tree_mod.quant_scales = qs
        return tr, leaf_of_row

    for t, (_, _, _, card_tree, card_leaf) in enumerate(grown):
        tr, leaf_of_row = cpu_tree(t, scales[t].cpu())
        check(all(np.array_equal(getattr(tr, k), getattr(card_tree, k))
                  for k in tr._fields) and torch.equal(leaf_of_row,
                                                       card_leaf),
              f"(e) q{bits}: tree {t} on the CPU from the card's inputs "
              "and scales differs from the card's")
    own, _ = cpu_tree(0, None)
    own_scales = qs(*grown[0][0][1:4], bits)
    card0 = grown[0][3]
    split = np.flatnonzero(~card0.is_leaf)
    part = [j for j in split if (own.feature[j], own.bin_threshold[j])
            != (card0.feature[j], card0.bin_threshold[j])]
    where = "none"
    if part:
        j = part[0]
        where = (f"node {j}: card feature {card0.feature[j]} bin "
                 f"{card0.bin_threshold[j]} gain {card0.gain[j]!r}, CPU "
                 f"feature {own.feature[j]} bin {own.bin_threshold[j]} gain "
                 f"{own.gain[j]!r}")
    print(f"training options (e): q{bits} at max_bin {max_bin}, {rows}: "
          f"{n_hist[0]} int histograms of the card's fit bitwise equal to "
          f"hist_plain; its 5 trees bitwise equal to the CPU grower's given "
          f"the same inputs and the card's scales; tree 0's scales card "
          f"{[float(v) for v in scales[0]]} vs CPU "
          f"{[float(v) for v in own_scales]}; with its own scales the CPU's "
          f"tree 0 first parts from the card's at {where}")


# the Bosch production-line table of NVIDIA's gbm-bench (rows x float
# features, share of nonzero cells) and phase 8's holdout and chunk rows
BOSCH_ROWS, BOSCH_COLS, BOSCH_DENSITY = 1_183_747, 968, 0.19
BOSCH_HOLDOUT = 100_000
OOC_CHUNK = 65_536


def bosch_shape(dev, n: int, seed: int = 7):
    """Phase 8(a)'s table: n rows x 968 float32 features, each cell
    nonzero with probability 0.19, values N(0, 1), and a label drawn from
    the logistic of a sparse weight vector (a tenth of the features,
    N(0, 0.5)). Drawn on the card from a seeded generator in 65,536-row
    blocks and kept on the host as a CSRMatrix. Returns (CSR, y)."""
    import torch
    from mmlspark_tpu_torch.core.sparse import CSRMatrix
    g = torch.Generator(device=dev).manual_seed(seed)
    f = BOSCH_COLS
    wt = torch.where(torch.rand(f, generator=g, device=dev) < 0.1,
                     0.5 * torch.randn(f, generator=g, device=dev), 0.0)
    data, idx, counts, ys = [], [], [], []
    for lo in range(0, n, OOC_CHUNK):
        m = min(OOC_CHUNK, n - lo)
        vals = torch.randn((m, f), generator=g, device=dev)
        keep = torch.rand((m, f), generator=g, device=dev) < BOSCH_DENSITY
        vals = torch.where(keep, vals, 0.0)
        nz = vals != 0
        r, c = nz.nonzero(as_tuple=True)          # row-major: sorted rows
        data.append(vals[r, c].cpu().numpy())
        idx.append(c.to(torch.int32).cpu().numpy())
        counts.append(nz.sum(1).cpu().numpy())
        p = torch.sigmoid(vals @ wt)
        ys.append((torch.rand(m, generator=g, device=dev) < p)
                  .float().cpu().numpy())
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.concatenate(counts), out=indptr[1:])
    return (CSRMatrix(np.concatenate(data), np.concatenate(idx), indptr,
                      (n, f)), np.concatenate(ys))


def ingest_slice(auc255: float, Xtr, ytr, Xte, yte, test_t, measured,
                 smi: str) -> dict:
    """Phase 8: GBDT ingest beyond dense input. (a) a CSR fit at the
    Bosch shape, (b) out-of-core fits from .npy chunks and shard lists,
    (c) the host binning library against its plain version. Returns the
    hist launches of (a)'s fit by route."""
    import threading
    import weakref

    import torch
    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.gbdt import hist_kernels as HK
    from mmlspark_tpu_torch.gbdt import native_bins
    from mmlspark_tpu_torch.gbdt.binning import BinMapper
    from mmlspark_tpu_torch.gbdt.booster import train
    from mmlspark_tpu_torch.gbdt.estimators import TPUBoostClassifier
    from mmlspark_tpu_torch.io.ooc import (
        ChunkedTable, peak_rss_bytes, table_nbytes)
    from mmlspark_tpu_torch.profile_hist import (
        bincount_call, device_ms, hist_bound_ms, hist_inputs, time_ms)
    dev = torch.device("cuda")

    # ---- (a) CSR at the Bosch shape ----------------------------------------
    t0 = time.perf_counter()
    csr, yb = bosch_shape(dev, BOSCH_ROWS + BOSCH_HOLDOUT)
    tr, hold = csr[:BOSCH_ROWS], csr[BOSCH_ROWS:]
    ytb, yhb = yb[:BOSCH_ROWS], yb[BOSCH_ROWS:]
    host_gib = (csr.data.nbytes + csr.indices.nbytes
                + csr.indptr.nbytes) / 2**30
    print(f"ingest (a): Bosch-shape CSR table {tr.shape} + "
          f"{hold.shape[0]} holdout rows, {csr.nnz} nonzeros "
          f"({100 * csr.nnz / (csr.shape[0] * csr.shape[1]):.2f} %), "
          f"{host_gib:.2f} GiB on the host, made in "
          f"{time.perf_counter() - t0:.1f} s (seed 7, on the card)")
    train_b = DataTable({"features": tr, "label": ytb})
    hold_b = DataTable({"features": hold, "label": yhb})
    torch.cuda.reset_peak_memory_stats()
    model, booster, a_csr, _, routes = traced_fit(
        "ingest (a) CSR fit, 5 rounds, max_bin 255", train_b, hold_b, yhb,
        numIterations=5, keepTrainingData=True)
    h = booster.train_info["histograms"]
    mapper = booster.bin_mapper
    bins = booster._resume["run"].bins_d        # the fit's (F, N) bins
    F, N = bins.shape
    B = int(mapper.num_bins.max())
    # a mostly-zero feature's equal-frequency cuts give its zero one bin
    # and its nonzeros the rest, so B may fall below the nibble route's
    route = HK.tpu_route(1, B)
    check(sum(routes.values()) == h == routes[route],
          f"(a): launches {routes} for {h} histograms (route {route})")
    check(a_csr > 0.6, f"(a): holdout AUC {a_csr}")
    check((F, N) == (BOSCH_COLS, BOSCH_ROWS) and bins.dtype == torch.int32,
          f"(a): bins {tuple(bins.shape)} {bins.dtype}")
    zero_bin = np.asarray([np.searchsorted(u, 0.0) for u in
                           mapper.upper_bounds])
    in_zero = float((bins[:, :200_000].cpu().numpy()
                     == zero_bin[:, None]).mean())
    print(f"ingest (a): {h} launches of {route}, one per "
          f"histogram; bins on the card {F * N * 4 / 1e9:.3f} GB int32 "
          f"(F={F}, N={N}, B={B}), {100 * in_zero:.1f} % of cells in their "
          f"feature's zero bin; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; card: {smi}")

    # the sparse bins of a 100k-row slice equal the dense binning of it
    sl = tr[:100_000]
    b_sparse = mapper.transform_sparse(sl)
    b_dense = mapper.transform_fm(sl.toarray(), native=True)
    check(np.array_equal(b_sparse, b_dense),
          "(a): transform_sparse differs from the dense transform")
    check(np.array_equal(b_sparse, bins[:, :100_000].cpu().numpy()),
          "(a): the fit's bins differ from transform_sparse")
    print("ingest (a): transform_sparse of 100k rows bitwise equal to the "
          "library's dense transform of them and to the fit's bins")

    # a 50k-row slice fitted from CSR and from its dense copy
    s2, y2 = tr[:50_000], ytb[:50_000]
    fits = {}
    for kind, feats in (("CSR", s2), ("dense", s2.toarray())):
        t0 = time.perf_counter()
        m = TPUBoostClassifier(numIterations=5, numLeaves=63, seed=7).fit(
            DataTable({"features": feats, "label": y2}))
        fits[kind] = (m.get_booster(), time.perf_counter() - t0)
    (bs, ts), (bd, td) = fits["CSR"], fits["dense"]
    same_cuts = all(np.array_equal(u, v) for u, v in zip(
        bs.bin_mapper.upper_bounds, bd.bin_mapper.upper_bounds))
    same_trees = all(np.array_equal(bs.trees[k], bd.trees[k])
                     for k in bd.trees)
    check(same_cuts, "(a): 50k rows: CSR and dense cuts differ")
    check(same_trees, "(a): 50k rows: CSR and dense forests differ")
    print(f"ingest (a): 50k rows fitted from CSR ({ts:.2f} s, bin path "
          f"{bs.train_info['bin_path']}) and from the dense copy "
          f"({td:.2f} s, bin path {bd.train_info['bin_path']}): equal "
          f"upper_bounds, forests bitwise equal")
    del fits, bs, bd

    # predict on the CSR holdout equals predict on its dense copy
    t0 = time.perf_counter()
    p_csr = booster.predict(hold)
    t_csr = time.perf_counter() - t0
    p_dense = booster.predict(hold.toarray())
    check(np.array_equal(p_csr, p_dense),
          "(a): CSR and dense holdout predictions differ")
    print(f"ingest (a): predict on the 100k-row CSR holdout ({t_csr:.2f} s, "
          f"8192-row chunks) bitwise equal to predict on its dense copy; "
          f"holdout AUC {a_csr:.5f}")

    # the kernel on this table's bins: a root and a 5 % child
    for key, active, seed in (("bosch_root", 1.0, 81),
                              ("bosch_child", 0.05, 82)):
        _, grad, hess, w, leaf, _ = hist_inputs(
            dev, 1, N, 1, B, torch.float32, seed=seed, active=active)
        out = HK.hist_device(bins, grad, hess, w, leaf, 1, B)
        again = HK.hist_device(bins, grad, hess, w, leaf, 1, B)
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"(a) {key}: two launches differ")
        # float64 references, 128 features at a time: the sums, and each
        # bin's absolute mass (the sum of |g w| and |h w|)
        def plain64(g_, h_):
            return torch.cat([HK.hist_plain(bins[j:j + 128], g_, h_,
                                            w.double(), leaf, 1, B)
                              for j in range(0, F, 128)], 2)
        ref = plain64(grad.double(), hess.double())
        mass = plain64(grad.double().abs(), hess.double().abs())
        d = (out.double() - ref).abs()
        err = float(d.max())
        # counts exact; g and h within phase 2's rtol 1e-5 / atol 1e-3 plus
        # 2e-7 (~3.4 float32 ulps) of the bin's absolute mass: about 960k
        # rows share a feature's zero bin here, and a float32 sum of that
        # many terms strays past atol 1e-3 in any order (the plain version
        # in float32 strays ~30x further); a dropped or doubled row shows
        # in the exact counts
        tol = 1e-3 + 1e-5 * ref.abs() + 2e-7 * mass
        pf = torch.cat([HK.hist_plain(bins[j:j + 128], grad, hess, w, leaf,
                                      1, B) for j in range(0, F, 128)], 2)
        plain_err = float((pf[:2].double() - ref[:2]).abs().max())
        check(torch.equal(out[2].double(), ref[2]),
              f"(a) {key}: counts differ from the plain version")
        check(bool((d[:2] <= tol[:2]).all()),
              f"(a) {key}: max_abs_err {err} beyond rtol 1e-5, atol 1e-3 "
              f"+ 2e-7 of the bin's absolute mass")
        print(f"ingest (a) {key}: counts exact; g, h max_abs_err "
              f"{float(d[:2].max()):.3e} (worst share of the bound "
              f"{float((d[:2] / tol[:2]).max()):.3f}; phase 2's rtol 1e-5 / "
              f"atol 1e-3 alone is exceeded at "
              f"{int((d[:2] > 1e-3 + 1e-5 * ref[:2].abs()).sum())} of "
              f"{d[:2].numel()} entries); the plain version in float32: "
              f"{plain_err:.3e}")
        del ref, mass, d, tol, pf
        torch.cuda.empty_cache()
        k_ms = time_ms(lambda: HK.hist_device(bins, grad, hess, w, leaf,
                                              1, B))
        d_ms, _ = device_ms(lambda: HK.hist_device(bins, grad, hess, w,
                                                   leaf, 1, B))
        p_ms = time_ms(lambda: HK.hist_plain(bins, grad, hess, w, leaf, 1,
                                             B), reps=5)
        torch.cuda.empty_cache()
        lib = bincount_call(bins, grad, hess, w, leaf, 1, B, None)
        # one timed call after one warm-up: a call takes ~4.5 s here, and
        # eight of them a case took ~73 s of the script's time limit
        l_ms = time_ms(lib, reps=1, warmups=1)
        del lib
        torch.cuda.empty_cache()
        bd_ms, by = hist_bound_ms(F, N, w, 1, B, torch.float32, False)
        measured[key] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                             library_ms=l_ms, bound_ms=bd_ms, bound_by=by,
                             B=B, route=route)
        print(f"kernel float32 (F={F}, N={N}, L=1, B={B}, "
              f"{100 * active:g} % active, Bosch-shape CSR bins): "
              f"max_abs_err {err:.3e} vs float64 plain; repeat launch "
              f"bitwise equal; kernel {k_ms:.4f} ms "
              f"(device time {d_ms:.4f} ms), plain index_add_ {p_ms:.4f} "
              f"ms, bincount {l_ms:.4f} ms, bound {bd_ms:.4f} ms ({by})")
    del bins, booster, model, grad, hess, w, leaf, out, again
    torch.cuda.empty_cache()

    # ---- (b) out of core and streams ---------------------------------------
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_ooc")
    os.makedirs(work, exist_ok=True)
    paths = {"features": os.path.join(work, "features.npy"),
             "label": os.path.join(work, "label.npy")}
    np.save(paths["features"], Xtr)
    np.save(paths["label"], ytr)
    live = {"bytes": 0, "peak": 0}
    lock = threading.Lock()

    def release(nb):
        with lock:
            live["bytes"] -= nb

    def track(t):
        """Count the chunk's bytes while any reference to it lives."""
        nb = table_nbytes(t)
        with lock:
            live["bytes"] += nb
            live["peak"] = max(live["peak"], live["bytes"])
        weakref.finalize(t, release, nb)
        return t

    def ooc_fit(label, bin_fit):
        live["peak"] = 0
        src = ChunkedTable.from_npy(paths, chunk_rows=OOC_CHUNK)
        chunked = src.map(track)
        model, b, a, _, routes = traced_fit(
            f"ingest (b) ChunkedTable.from_npy, binFit={bin_fit!r}",
            chunked, test_t, yte, profiled=False, numIterations=5,
            binFit=bin_fit)
        st = chunked.stats
        check(routes["_hist_kernel_nibble"] == b.train_info["histograms"]
              and sum(routes.values()) == b.train_info["histograms"],
              f"(b) {label}: launches {routes}")
        check(abs(a - auc255) < 0.005, f"(b) {label}: AUC {a} vs dense "
              f"{auc255}")
        check(live["peak"] <= st.tracked_peak_bytes()
              <= (st.depth + 2) * st.peak_chunk_bytes,
              f"(b) {label}: {live['peak']} bytes of chunks alive at once "
              f"against the tracked {st.tracked_peak_bytes()}")
        print(f"ingest (b) {label}: holdout AUC {a:.5f} vs phase 3's "
              f"dense fit {auc255:.5f} (|diff| {abs(a - auc255):.5f} < "
              f"0.005); OOCStats {st.snapshot()}; chunk bytes alive at "
              f"once {live['peak']} <= tracked_peak_bytes "
              f"{st.tracked_peak_bytes()} = (depth {st.depth} + 2) x peak "
              f"chunk; sketch_eps {b.bin_mapper.sketch_eps:.6f}; host RSS "
              f"peak {peak_rss_bytes() / 2**30:.2f} GiB")
        return b

    ooc_fit("sample", "sample")
    b_sk = ooc_fit("sketch", "sketch")
    # the sketch's cuts against an exact all-rows fit, in rank
    eps = b_sk.bin_mapper.sketch_eps
    X64 = Xtr.astype(np.float64)
    exact = BinMapper.fit(X64, max_bin=255, sample_cnt=len(X64))
    drift = 0.0
    for j, (cs, ce) in enumerate(zip(b_sk.bin_mapper.upper_bounds,
                                     exact.upper_bounds)):
        check(len(cs) == len(ce), f"(b) sketch: feature {j} has {len(cs)} "
              f"cuts, the exact fit {len(ce)}")
        xs = np.sort(X64[:, j])
        rank = np.searchsorted(xs, cs) - np.searchsorted(xs, ce)
        drift = max(drift, float(np.abs(rank).max()) / len(xs))
    # the exact walk itself lands up to a row past each target, so its
    # cuts carry up to max_bin rows of slack
    check(0 < eps and drift <= 2 * eps + 255 / len(X64),
          f"(b) sketch: rank drift {drift} against 2 x eps {2 * eps}")
    print(f"ingest (b): sketch cuts within {drift:.6f} of the exact "
          f"all-rows fit's in rank (bound 2 x sketch_eps = {2 * eps:.6f})")
    del X64, exact
    # booster.train on a replayable list of (X, y) shards
    shards = [(Xtr[i:i + OOC_CHUNK], ytr[i:i + OOC_CHUNK])
              for i in range(0, len(Xtr), OOC_CHUNK)]
    HK.reset_launches()
    t0 = time.perf_counter()
    b_sh = train({"objective": "binary", "num_iterations": 5,
                  "num_leaves": 63, "seed": 7}, shards, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(HK.LAUNCHES)
    a_sh = auc(yte, b_sh.predict(Xte))
    check(launches["_hist_kernel_nibble"] == b_sh.train_info["histograms"],
          f"(b) shards: launches {launches}")
    check(abs(a_sh - auc255) < 0.005, f"(b) shards: AUC {a_sh}")
    print(f"ingest (b) booster.train on {len(shards)} (X, y) shards: fit "
          f"{secs:.2f} s ({b_sh.train_timing}), holdout AUC {a_sh:.5f} "
          f"(|diff| to dense {abs(a_sh - auc255):.5f} < 0.005), launches "
          f"{launches}")
    # a sketch fit that stays in one summary: the dense fit's cuts
    Xq = (np.round(Xtr * 40) / 40).astype(np.float32)
    qshards = [(Xq[i:i + OOC_CHUNK], ytr[i:i + OOC_CHUNK])
               for i in range(0, len(Xq), OOC_CHUNK)]
    b_q = train({"objective": "binary", "num_iterations": 1,
                 "num_leaves": 63, "max_bin": 63, "bin_fit": "sketch"},
                qshards, device="cuda")
    dense_q = BinMapper.fit(Xq, max_bin=63, sample_cnt=len(Xq))
    check(b_q.bin_mapper.sketch_eps == 0.0,
          f"(b): the quantized stream compacted (eps "
          f"{b_q.bin_mapper.sketch_eps})")
    check(all(np.array_equal(u, v) for u, v in zip(
        b_q.bin_mapper.upper_bounds, dense_q.upper_bounds)),
        "(b): uncompacted sketch cuts differ from the dense fit's")
    print(f"ingest (b): a 'sketch' fit of {len(Xq)} rows with at most "
          f"{max(len(np.unique(Xq[:, j])) for j in range(28))} distinct "
          f"values a feature (no compaction, sketch_eps 0): upper_bounds "
          f"bitwise equal to the dense all-rows fit's")
    del Xq, qshards

    # ---- (c) the host binning library against its plain version ----------
    m = BinMapper.fit(Xtr, max_bin=255)
    for X in (Xtr, Xtr.astype(np.float64)):
        tag = str(X.dtype)
        ref = m._numpy_bin_block(X, 0, X.shape[1])
        got = m.transform_fm(X, native=True)
        rng_got = m.transform_fm_range(X, 5, 17, native=True)
        check(np.array_equal(got, ref) and np.array_equal(rng_got,
                                                          ref[5:17]),
              f"(c) {tag}: bins.cpp differs from _numpy_bin_block")
        t_nat = host_ms(lambda: m.transform_fm(X, native=True))
        t_rng = host_ms(lambda: m.transform_fm_range(X, 5, 17, native=True))
        t_np = host_ms(lambda: m._numpy_bin_block(X, 0, X.shape[1]), 3)
        print(f"ingest (c) {tag} {X.shape}: bins.cpp bitwise equal to "
              f"_numpy_bin_block over all features and features [5, 17); "
              f"host ms bins.cpp {t_nat:.2f} (range {t_rng:.2f}), numpy "
              f"{t_np:.2f}; {native_bins.threads()} OpenMP threads, "
              f"{os.cpu_count()} cores")
    return routes


def host_ms(fn, reps: int = 5) -> float:
    """Median host wall milliseconds of fn() over ``reps`` calls after
    one warm-up."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(ts))


ZOO_STEPS = 32              # phase 9's CIFAR fits: 1 epoch of 32 steps
RESNET18 = {"type": "resnet", "stage_sizes": [2, 2, 2, 2], "width": 64,
            "num_classes": 1000, "stem": "imagenet"}
RESNET18_ROWS, RESNET18_BATCH = 1024, 256
BILSTM = {"type": "bilstm", "vocab_size": 50, "embed_dim": 32, "hidden": 64,
          "num_tags": 3}


def bilstm_data(n: int, seed: int):
    """examples/304_bilstm_tagger.py's tokens: the tag of a token depends
    on it and on the token before it."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, BILSTM["vocab_size"], size=(n, 12))
    prev = np.roll(toks, 1, axis=1)
    prev[:, 0] = 0
    return toks.astype(np.int64), ((toks + prev) % 3).astype(np.int64)


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def zoo_slice(dev, smi: str) -> None:
    """Phase 9: the zoo's ConvNet, ResNet and BiLSTMTagger on the card."""
    import contextlib
    import copy

    import torch

    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.models import networks
    from mmlspark_tpu_torch.models.learner import TPULearner
    from mmlspark_tpu_torch.models.networks import build_network
    from mmlspark_tpu_torch.models.tpu_model import TPUModel
    from mmlspark_tpu_torch.profile_train import (
        CIFAR_BATCH, CIFAR_SPECS, cifar_learner, cifar_table)

    # (a), (b): bench.py's CIFAR configurations, 1 epoch of 32 steps
    table = cifar_table(ZOO_STEPS * CIFAR_BATCH)
    for net in ("convnet", "resnet20"):
        learner = cifar_learner(net, 1, device=str(dev))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = learner.fit(table)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        losses = [h["loss"] for h in learner.history]
        check(len(losses) == ZOO_STEPS and all(np.isfinite(losses)),
              f"{net} losses {losses}")
        check(losses[-1] < losses[0], f"{net} loss did not fall: {losses}")
        tm = learner.timing
        check("mfu" in tm, f"{net}: no MFU in learner.timing {tm}")
        print(f"zoo (a/b) {net}: {ZOO_STEPS} steps of {CIFAR_BATCH} x 32 x "
              f"32 x 3, bf16, device feed, in {fit_s:.3f} s (first step "
              f"included); {tm['examples_per_sec']:.1f} imgs/s, "
              f"{1e3 * tm['wall_s'] / tm['steps_timed']:.3f} ms per step "
              f"after the first, peak memory {peak / 1e9:.3f} GB, MFU "
              f"{tm['mfu']:.4f} ({tm['model_flops_per_step'] / 1e9:.2f} "
              f"GFLOP a step); card {smi}")
        print(f"zoo (a/b) {net}: losses first {losses[0]:.4f}, last "
              f"{losses[-1]:.4f}")
        if net == "resnet20":
            w = model.get("weights")
            stats = {k: v for k, v in w.items() if ".running_" in k}
            check(all(bool(torch.isfinite(v).all()) for v in stats.values()),
                  "ResNet-20 running statistics not finite")
            still = [k for k, v in stats.items() if bool(torch.all(
                v == (1.0 if k.endswith("running_var") else 0.0)))]
            check(not still, f"ResNet-20 running statistics never moved: "
                  f"{still}")
            x = np.asarray(table["features"][:256])
            full = torch.from_numpy(model.transform(DataTable(
                {"features": x}))["scores"])
            alone = torch.from_numpy(model.transform(DataTable(
                {"features": x[:8]}))["scores"])
            err = rel_err(alone, full[:8])
            check(err <= 2.0 ** -6, f"ResNet-20 rows 0-7 alone vs in a "
                  f"256-row batch differ by {err} of the scale")
            print(f"zoo (b) resnet20: {len(stats)} running buffers moved, "
                  f"finite; rows 0-7 alone vs in a 256-row batch: "
                  f"{err:.3e} of the logits' scale (<= 2**-6)")
        del learner, model
        torch.cuda.empty_cache()
    del table

    # (c) card vs CPU in f32: 2 SGD steps of a small ResNet, then one
    # forward of each network
    spec_c = {"type": "resnet", "stage_sizes": [1, 1], "width": 16,
              "num_classes": 10}
    m0 = build_network(spec_c, device="cpu", seed=2)
    w0 = {k: t.clone() for k, t in m0.state_dict().items()}
    small = cifar_table(16, seed=3)

    def fit_small(device):
        lrn = TPULearner(moduleFactory=lambda: copy.deepcopy(m0),
                         device=str(device), optimizer="sgd",
                         schedule="constant", learningRate=0.1, batchSize=8,
                         epochs=1, inputShape=[32, 32, 3],
                         computeDtype="float32", logEvery=1)
        mod = lrn.fit(small)
        return [h["loss"] for h in lrn.history], {
            k: t.detach().cpu() for k, t in mod.get("weights").items()}
    l_card, w_card = fit_small(dev)
    l_cpu, w_cpu = fit_small("cpu")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
    upd = max(float((w_cpu[k] - w0[k]).abs().max()) for k in w0)
    w_diff = max(float((w_card[k] - w_cpu[k]).abs().max()) for k in w0)
    check(loss_rel <= 1e-4, f"ResNet card vs CPU losses {l_card} vs {l_cpu}")
    check(w_diff <= 1e-3 * upd, f"ResNet card vs CPU weights differ by "
          f"{w_diff}, largest update {upd}")
    print(f"zoo (c): ResNet [1, 1] / 16, 2 SGD steps f32, card vs CPU: "
          f"losses rel diff {loss_rel:.2e} (<= 1e-4), max |weight or running"
          f" stat diff| {w_diff:.3e} vs largest update {upd:.3e} (<= 1e-3 "
          "of it)")
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.uniform(
        0, 1, size=(64, 32, 32, 3)).astype(np.float32))
    tokens = torch.from_numpy(bilstm_data(64, 2)[0])
    for name, spec, x in (("convnet", CIFAR_SPECS["convnet"], images),
                          ("resnet20", CIFAR_SPECS["resnet20"], images),
                          ("bilstm", BILSTM, tokens)):
        module = build_network(spec, device="cpu", seed=5)
        with torch.no_grad():
            for buf_name, buf in module.named_buffers():
                if buf_name.endswith("running_var"):
                    buf.uniform_(0.5, 2.0)
            want = module(x)
            module = module.to(dev)
            got = module(x.to(dev)).cpu()
            err = rel_err(got, want)
            saved = networks.strict_f32
            tf32_before = torch.backends.cudnn.allow_tf32
            try:      # the same forward with TF32 left on, for contrast
                networks.strict_f32 = contextlib.nullcontext
                torch.backends.cudnn.allow_tf32 = True
                loose = rel_err(module(x.to(dev)).cpu(), want)
            finally:
                networks.strict_f32 = saved
                torch.backends.cudnn.allow_tf32 = tf32_before
        check(err <= 1e-4, f"{name} f32 forward card vs CPU: {err}")
        print(f"zoo (c): {name} f32 forward of {tuple(x.shape)}, card vs "
              f"CPU {err:.3e} of the output's scale (<= 1e-4); with cuDNN's "
              f"TF32 left on it would be {loose:.3e}")
    del m0, w0, w_card, w_cpu

    # (d) the BiLSTM tagger at examples/304_bilstm_tagger.py's shape
    toks, tags = bilstm_data(512, 0)
    learner = TPULearner(networkSpec=BILSTM, loss="token_cross_entropy",
                         epochs=30, batchSize=128, learningRate=0.01,
                         optimizer="adam", computeDtype="float32",
                         logEvery=50, device=str(dev))
    t0 = time.perf_counter()
    model = learner.fit(DataTable({"features": toks, "label": tags}))
    fit_s = time.perf_counter() - t0
    test_toks, test_tags = bilstm_data(128, 1)
    pred = model.transform(DataTable({"features": test_toks}))["scores"]
    acc = float(np.mean(np.argmax(pred, -1) == test_tags))
    check(acc > 0.9, f"BiLSTM held-out per-token accuracy {acc}")
    tm = learner.timing
    step_ms = 1e3 * tm["wall_s"] / tm["steps_timed"]
    # the LSTM products of a step (forward, and twice that backward),
    # which FlopCounterMode cannot see in cuDNN's RNN op
    lstm_flops = 3 * 2 * 2 * 12 * 128 * (BILSTM["embed_dim"]
                                         + BILSTM["hidden"]) \
        * 4 * BILSTM["hidden"]
    check(tm.get("model_flops_per_step", 0) >= lstm_flops,
          f"BiLSTM step flops {tm.get('model_flops_per_step')} leave out "
          f"the LSTM's {lstm_flops}")
    print(f"zoo (d) bilstm: 30 epochs x 4 steps of 128 x 12 tokens, f32, "
          f"adam, in {fit_s:.3f} s; {step_ms:.3f} ms per step after the "
          f"first; held-out per-token accuracy {acc:.4f} (> 0.9); "
          f"{tm['model_flops_per_step'] / 1e9:.3f} GFLOP a step (the "
          f"LSTM's {lstm_flops / 1e9:.3f}), MFU {tm['mfu']:.2e}")
    del learner, model

    # (e) ResNet-18 inference at 224 x 224
    images = np.random.default_rng(6).normal(
        size=(RESNET18_ROWS, 224, 224, 3)).astype(np.float32)
    table = DataTable({"image": images})
    state = build_network(RESNET18, device=dev, seed=11).state_dict()
    for dtype in ("bfloat16", "float32"):
        module = build_network(dict(RESNET18, dtype=dtype), device=dev)
        module.load_state_dict(state)
        model = TPUModel.from_module(module, device=dev, inputCol="image",
                                     outputCol="logits",
                                     batchSize=RESNET18_BATCH)
        secs = []
        for _ in range(2):
            t0 = time.perf_counter()
            logits = model.transform(table)["logits"]
            secs.append(time.perf_counter() - t0)
        check(logits.shape == (RESNET18_ROWS, 1000)
              and bool(np.isfinite(logits).all()),
              f"ResNet-18 {dtype} logits {logits.shape}, finite "
              f"{bool(np.isfinite(logits).all())}")
        print(f"zoo (e) resnet18 {dtype}: transform of {RESNET18_ROWS} x 224 "
              f"x 224 x 3 at batch {RESNET18_BATCH}: {secs[0]:.3f} s first, "
              f"{secs[1]:.3f} s second = {RESNET18_ROWS / secs[1]:.1f} imgs/s;"
              f" logits {logits.shape} finite")
        del module, model
    torch.cuda.empty_cache()


IMAGE_ROWS = 1024           # phase 10's Flowers-sized images
IMAGE_BATCHES = (64, 256)   # ImageFeaturizer's default batchSize, and 256
TRANSFORM_ROWS = 256        # phase 10(a)'s uniform 375 x 500 batch


def u8_diff(got, want):
    """(largest |difference|, share of differing values) of two uint8
    arrays."""
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return int(d.max()), float((d > 0).mean())


def image_slice(dev, smi: str) -> None:
    """Phase 10: the transfer-learning image path on the card."""
    import torch

    from mmlspark_tpu_torch.core.metrics import automl_histograms
    from mmlspark_tpu_torch.core.schema import ImageSchema
    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.downloader import LocalRepo, ModelDownloader
    from mmlspark_tpu_torch.gbdt.estimators import TPUBoostClassifier
    from mmlspark_tpu_torch.importers.torch_import import (
        TORCHVISION_RESNET18_SPEC, import_torchvision_resnet)
    from mmlspark_tpu_torch.profile_featurize import (
        device_busy, flowers_table, seeded_resnet18_state_dict)
    from mmlspark_tpu_torch.stages.featurizer import (
        RESIZE_WORKERS, ImageFeaturizer)
    from mmlspark_tpu_torch.stages.image import ImageTransformer
    from torch.profiler import ProfilerActivity, profile

    # (a) ImageTransformer's uniform path: one upload, the op list on the
    # card, uint8 there, one readback; against the same stage on the CPU
    rng = np.random.default_rng(8)
    photos = rng.integers(0, 256, (TRANSFORM_ROWS, 375, 500, 3),
                          dtype=np.uint8)
    table = DataTable({"image": [ImageSchema.make_row(f"p{i}", im)
                                 for i, im in enumerate(photos)]})

    def transformer(device):
        return ImageTransformer(device=device).resize(224, 224) \
            .gaussian_kernel(5, 0).flip()

    def images(out):
        return np.stack([r[ImageSchema.DATA] for r in out["image"]])
    stage = transformer(str(dev))
    secs = []
    for _ in range(4):
        t0 = time.perf_counter()
        got = images(stage.transform(table))
        secs.append(time.perf_counter() - t0)
    want = images(transformer("cpu").transform(table))
    worst, share = u8_diff(got, want)
    check(got.shape == (TRANSFORM_ROWS, 224, 224, 3) and worst <= 1
          and share <= 1e-3, f"image (a): card vs CPU uint8 {got.shape}, "
          f"max diff {worst}, {100 * share:.4f} % of pixels differ")
    print(f"image (a): ImageTransformer resize(224, 224).gaussian_kernel(5,"
          f" 0).flip() of {TRANSFORM_ROWS} x 375 x 500 x 3 uint8 on the "
          f"card: {1e3 * float(np.median(secs[1:])):.3f} ms a batch (median"
          f" of 3 after one; upload, ops, readback); card vs CPU max diff "
          f"{worst}, {100 * share:.5f} % of pixels differ (<= 1, <= 0.1 %)"
          f"; card {smi}")
    del photos, table, got, want

    # (d) the weights: a seeded torchvision-layout state dict, saved as
    # .pth and as bf16 .safetensors, imported, published, fetched
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_image")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    sd = seeded_resnet18_state_dict(seed=12)
    pth = os.path.join(work, "resnet18.pth")
    sft = os.path.join(work, "resnet18_bf16.safetensors")
    torch.save(sd, pth)
    header, blobs, off = {}, [], 0
    for key, t in sd.items():
        raw = t.to(torch.bfloat16).view(torch.int16).numpy().tobytes()
        header[key] = {"dtype": "BF16", "shape": list(t.shape),
                       "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    with open(sft, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head + b"".join(blobs))
    t0 = time.perf_counter()
    variables = import_torchvision_resnet(pth)
    from_bf16 = import_torchvision_resnet(sft)
    import_s = time.perf_counter() - t0

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        else:
            yield "/".join(path), tree
    flat = dict(leaves(variables))
    flat_bf16 = dict(leaves(from_bf16))
    check(list(flat) == list(flat_bf16), "image (d): .pth and .safetensors "
          "imports hold other leaves")
    for k, a in flat.items():
        rounded = torch.from_numpy(a).to(torch.bfloat16).float().numpy()
        check(np.array_equal(rounded, flat_bf16[k]), f"image (d): {k} of "
              "the bf16 .safetensors import is not the .pth import rounded")
    repo = LocalRepo(os.path.join(work, "repo"))
    schema = repo.publish("ResNet18_seeded", TORCHVISION_RESNET18_SPEC,
                          variables, dataset="seeded",
                          model_type="vision/classification",
                          input_shape=[224, 224, 3])
    downloader = ModelDownloader(os.path.join(work, "cache"), repo=repo)
    fetched = dict(leaves(downloader.load_variables(schema.name)))
    check(list(fetched) == list(flat) and all(
        fetched[k].dtype == a.dtype and np.array_equal(fetched[k], a)
        for k, a in flat.items()), "image (d): the LocalRepo publish -> "
        "download -> load round trip is not bitwise")
    print(f"image (d): torchvision-layout ResNet-18 ({len(sd)} tensors) "
          f"imported from .pth and bf16 .safetensors in {import_s:.3f} s: "
          f"{len(flat)} leaves, the bf16 import equal to the .pth import "
          f"rounded to bf16; publish -> download -> load bitwise "
          f"({schema.size} bytes, sha256 {schema.sha256[:12]})")

    # (b) ImageFeaturizer at full width, at two batch sizes
    flowers = flowers_table(IMAGE_ROWS, seed=13)
    hists = automl_histograms()
    feats = {}
    for bs in IMAGE_BATCHES:
        feat = ImageFeaturizer.from_model_schema(
            schema, downloader, cutOutputLayers=1, batchSize=bs)
        secs = []
        for _ in range(2):
            for h in hists.values():
                h.reset()
            t0 = time.perf_counter()
            out = feat.transform(flowers)["features"]
            secs.append(time.perf_counter() - t0)
        check(out.shape == (IMAGE_ROWS, 512) and bool(np.isfinite(out).all()),
              f"image (b): features {out.shape}, finite "
              f"{bool(np.isfinite(out).all())}")
        check(feat.jit_cache_misses == 1, f"image (b): {feat.jit_cache_misses}"
              " forward shapes at one batchSize")
        rs, fw = hists["image_resize"].summary(), \
            hists["image_forward"].summary()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            feat.transform(flowers)
            torch.cuda.synchronize()
            window_us = 1e6 * (time.perf_counter() - t0)
        busy = device_busy(prof, window_us)
        check(bool(busy), "image (b): the profiler saw no device activity")
        print(f"image (b): ImageFeaturizer ResNet-18 (imagenet stem, strict "
              f"f32, cut at the pool) over {IMAGE_ROWS} Flowers-sized images "
              f"at batchSize {bs}: {secs[0]:.3f} s first, {secs[1]:.3f} s "
              f"second = {IMAGE_ROWS / secs[1]:.1f} imgs/s; image_resize "
              f"p50 {rs['p50']} ms (mean {rs['mean']}) and image_forward p50"
              f" {fw['p50']} ms (mean {fw['mean']}) a batch (histogram); "
              f"card idle {100 * busy['idle_share']:.1f} % of the profiled "
              f"transform's {busy['window_us'] / 1e3:.3f} ms (host clock, "
              f"call to last sync); resize "
              f"pool {RESIZE_WORKERS} threads, torch intra-op threads "
              f"{torch.get_num_threads()}; card {smi}")
        feats[bs] = out
        del feat
    worst = rel_err(torch.from_numpy(feats[IMAGE_BATCHES[0]]),
                    torch.from_numpy(feats[IMAGE_BATCHES[1]]))
    check(worst <= 1e-4, f"image (b): batchSize {IMAGE_BATCHES} features "
          f"differ by {worst} of the scale")
    # 8 images' features against the CPU forward of the same weights
    cpu = ImageFeaturizer.from_model_schema(
        schema, downloader, cutOutputLayers=1, batchSize=8, device="cpu")
    first8 = DataTable({"image": list(flowers["image"][:8])})
    want = cpu.transform(first8)["features"]
    got = feats[IMAGE_BATCHES[0]][:8]
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    check(np.allclose(got, want, rtol=1e-4, atol=1e-5 * scale),
          f"image (b): card vs CPU features of 8 images: max |diff| {err}, "
          f"scale {scale}")
    print(f"image (b): features of images 0-7, card vs CPU: max |diff| "
          f"{err:.3e} at scale {scale:.3e} (rtol 1e-4, atol 1e-5 of the "
          f"scale); batchSize {IMAGE_BATCHES[0]} vs {IMAGE_BATCHES[1]} "
          f"{worst:.3e} of the scale (<= 1e-4)")

    # (c) a GBDT head on the card on those features
    x, y = feats[IMAGE_BATCHES[0]], np.asarray(flowers["label"])
    cut = 3 * IMAGE_ROWS // 4
    t0 = time.perf_counter()
    head = TPUBoostClassifier(numIterations=20, maxBin=32).fit(
        DataTable({"features": x[:cut], "label": y[:cut]}))
    fit_s = time.perf_counter() - t0
    pred = head.transform(DataTable({"features": x[cut:]}))["prediction"]
    acc = float(np.mean(pred == y[cut:]))
    check(acc > 0.9, f"image (c): holdout accuracy {acc}")
    print(f"image (c): TPUBoostClassifier (20 rounds, maxBin 32) on the "
          f"card on {cut} x 512 features in {fit_s:.3f} s: holdout accuracy "
          f"{acc:.4f} on {IMAGE_ROWS - cut} images (> 0.9)")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()


AUTOML_TRAIN = 900_000      # phase 11(b): fit rows; the rest are held out
AUTOML_SPARSE_ROWS = 200_000  # phase 11(d)
AUTOML_THREAD_ROWS = 100_000  # phase 11(e)
AUTOML_CPU_ROWS = 20_000      # phase 11(f)


def automl_slice(dev, smi: str) -> dict:
    """Phase 11: the AutoML path on bench_automl's 1M-row table (seed 0,
    profile_automl.automl_table). Returns the hist kernel's row for the
    kernels line, measured on 11(b)'s bins."""
    import torch
    from mmlspark_tpu_torch.automl import (
        ComputeModelStatistics, DiscreteHyperParam, Featurize, GridSpace,
        TrainClassifier, TuneHyperparameters)
    from mmlspark_tpu_torch.core.metrics import automl_histograms
    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.gbdt import hist_kernels as HK
    from mmlspark_tpu_torch.gbdt.estimators import TPUBoostClassifier
    from mmlspark_tpu_torch.models.linear import (
        TPULinearRegression, TPULogisticRegression)
    from mmlspark_tpu_torch.profile_automl import (
        AUTOML_HASH_WIDTH, AUTOML_N, AUTOML_TUNE_ROWS, FEATURE_COLUMNS,
        automl_table, hashing_path, transform_without_pyarrow, tuner)
    from mmlspark_tpu_torch.profile_hist import (
        bincount_call, device_ms, hist_bound_ms, hist_inputs, time_ms)
    hists = automl_histograms()
    t0 = time.perf_counter()
    table, label = automl_table(AUTOML_N)
    print(f"automl: bench_automl's table, {AUTOML_N} rows (x1 with 1 % "
          f"NaN, x2, a 12-level color, 5-12 tokens of 2,000), made in "
          f"{time.perf_counter() - t0:.1f} s; card: {smi}")

    # ---- (a) Featurize ----------------------------------------------------
    for h in hists.values():
        h.reset()
    feat = Featurize(featureColumns=FEATURE_COLUMNS,
                     numberOfFeatures=AUTOML_HASH_WIDTH)
    t0 = time.perf_counter()
    fm = feat.fit(table)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    X = fm.transform(table)["features"]
    tr_s = time.perf_counter() - t0
    want = (AUTOML_N, 3 + AUTOML_HASH_WIDTH)
    check(X.shape == want and X.dtype == np.float32
          and bool(np.isfinite(X).all()),
          f"(a): features {X.shape} {X.dtype}, want {want} finite float32")
    t0 = time.perf_counter()
    oracle = fm.transform_rowloop(table.slice(0, 100_000))["features"]
    loop_s = time.perf_counter() - t0
    check(np.array_equal(X[:100_000], oracle),
          "(a): transform differs from transform_rowloop")
    print(f"automl (a): Featurize fit {fit_s:.3f} s, transform "
          f"{tr_s:.3f} s of {X.shape} (hashing path {hashing_path()}); "
          f"the first 100,000 rows bitwise equal to transform_rowloop "
          f"({loop_s:.3f} s); featurize_fit {hists['featurize_fit'].summary()}"
          f", featurize_transform {hists['featurize_transform'].summary()}")
    del oracle
    if hashing_path() == "pyarrow":
        # the numpy path too, held bitwise to the pyarrow one
        Xn, np_s = transform_without_pyarrow(fm, table)
        check(np.array_equal(X, Xn["features"]),
              "(a): the numpy hashing path differs from pyarrow's")
        print(f"automl (a): transform with pyarrow blocked (the numpy "
              f"path) {np_s:.3f} s, bitwise equal to the pyarrow path")
        del Xn

    # ---- (b) TrainClassifier, default GBDT, string labels ---------------
    str_label = np.where(label > 0.5, ">50K", "<=50K")
    tc_table = table.with_column("label", str_label.tolist())
    train_t = tc_table.slice(0, AUTOML_TRAIN)
    hold_t = tc_table.slice(AUTOML_TRAIN, AUTOML_N)
    y_hold = label[AUTOML_TRAIN:]

    def classify(tag, model=None):
        kw = {} if model is None else {"model": model}
        HK.reset_launches()
        t0 = time.perf_counter()
        m = TrainClassifier(featureColumns=FEATURE_COLUMNS,
                            numFeatures=AUTOML_HASH_WIDTH, **kw).fit(train_t)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = dict(HK.LAUNCHES)
        t0 = time.perf_counter()
        scored = m.transform(hold_t)
        tr_s = time.perf_counter() - t0
        check(m.get("levels") == ["<=50K", ">50K"],
              f"(b) {tag}: label levels {m.get('levels')}")
        pred = np.asarray(scored["prediction"])
        check(list(scored["scored_labels"]) ==
              np.where(pred == 1.0, ">50K", "<=50K").tolist(),
              f"(b) {tag}: scored_labels do not round-trip to the strings")
        stats = ComputeModelStatistics().transform(DataTable({
            "label": y_hold, "prediction": pred,
            "probability": np.asarray(scored["probability"])}))
        a = float(stats.row(0)["auc"])
        acc = float(stats.row(0)["accuracy"])
        print(f"automl (b) {tag}: fit {fit_s:.3f} s on {AUTOML_TRAIN} rows, "
              f"transform {tr_s:.3f} s of {AUTOML_N - AUTOML_TRAIN}; holdout "
              f"AUC {a:.5f}, accuracy {acc:.5f}; hist launches {launches}; "
              f"predicted labels round-trip to '>50K' / '<=50K'")
        return m, a, launches, fit_s

    tc, auc_k, launches, fit_k = classify("default GBDT (kernel)")
    check(sum(launches.values()) > 0, f"(b): the fit launched no hist "
          f"kernel: {launches}")
    check(auc_k > 0.9, f"(b): holdout AUC {auc_k}")
    # the plain path against the kernel at 10 of the default 100 rounds:
    # the plain fit at 100 took 73-78 s of the script's time limit
    _, auc_k10, l_k10, _ = classify(
        "GBDT kernel, 10 rounds", TPUBoostClassifier(numIterations=10))
    _, auc_p, l_plain, _ = classify(
        "GBDT plain scatter path, 10 rounds",
        TPUBoostClassifier(histMethod="scatter", numIterations=10))
    check(sum(l_k10.values()) > 0 and sum(l_plain.values()) == 0,
          f"(b): kernel launches {l_k10}, plain path launches {l_plain}")
    check(abs(auc_k10 - auc_p) < 0.005, f"(b): kernel AUC {auc_k10} vs "
          f"plain {auc_p} at 10 rounds")
    print(f"automl (b): kernel vs plain holdout AUC at 10 rounds "
          f"{auc_k10:.5f} vs {auc_p:.5f} (|diff| "
          f"{abs(auc_k10 - auc_p):.5f} < 0.005)")
    # the kernel on this fit's bins: the featurized training rows binned
    # by the fit's own mapper, at a root (every row active)
    booster = tc.get("innerModel").get_booster()
    Xtr = tc.get("featurizer").transform(train_t)[
        "TrainClassifier_features"]
    mapper = booster.bin_mapper
    bins = torch.as_tensor(mapper.transform_fm(Xtr, native=True),
                           device=dev).to(torch.int32)
    F, N = bins.shape
    B = int(mapper.num_bins.max())
    route = HK.tpu_route(1, B)
    _, grad, hess, w, leaf, _ = hist_inputs(dev, 1, N, 1, B, torch.float32,
                                            seed=111, active=1.0)
    out = HK.hist_device(bins, grad, hess, w, leaf, 1, B)
    again = HK.hist_device(bins, grad, hess, w, leaf, 1, B)
    ref = HK.hist_plain(bins, grad.double(), hess.double(), w.double(),
                        leaf, 1, B)
    err = float((out.double() - ref).abs().max())
    check(torch.equal(out, again), "(b) hist: two launches differ")
    check(torch.allclose(out.double(), ref, rtol=1e-5, atol=1e-3),
          f"(b) hist: max_abs_err {err} beyond rtol 1e-5 / atol 1e-3")
    k_ms = time_ms(lambda: HK.hist_device(bins, grad, hess, w, leaf, 1, B))
    d_ms, _ = device_ms(lambda: HK.hist_device(bins, grad, hess, w, leaf,
                                               1, B))
    p_ms = time_ms(lambda: HK.hist_plain(bins, grad, hess, w, leaf, 1, B),
                   reps=5)
    lib = bincount_call(bins, grad, hess, w, leaf, 1, B, None)
    l_ms = time_ms(lib, reps=5)
    bd_ms, by = hist_bound_ms(F, N, w, 1, B, torch.float32, False)
    row = {"name": f"hist (single leaf, B={B}, F={F} featurized AutoML "
                   "bins, root)",
           "route": "cuda", "source": "mmlspark_tpu_torch/csrc/hist.cu",
           "replaces": "mmlspark_tpu/gbdt/pallas_hist.py:" + (
               "67" if route == "_hist_kernel_nibble" else "117"),
           "launches": launches[route], "max_abs_err": err, "ms": k_ms,
           "plain_ms": p_ms, "bound_ms": bd_ms, "bound_by": by,
           "library_ms": l_ms}
    print(f"automl (b) kernel float32 on the fit's bins (F={F}, N={N}, "
          f"B={B}, {route}, root): max_abs_err {err:.3e} vs float64 plain "
          f"(rtol 1e-5, atol 1e-3); repeat launch bitwise equal; kernel "
          f"{k_ms:.4f} ms (device time {d_ms:.4f} ms), plain index_add_ "
          f"{p_ms:.4f} ms, bincount {l_ms:.4f} ms, bound {bd_ms:.4f} ms "
          f"({by}); {launches[route]} launches in the {fit_k:.2f} s fit")
    del bins, grad, hess, w, leaf, out, again, ref, lib, Xtr, tc
    torch.cuda.empty_cache()

    # ---- (c) TuneHyperparameters, batched against serial ----------------
    tune_t = DataTable({"features": X[:AUTOML_TUNE_ROWS],
                        "label": label[:AUTOML_TUNE_ROWS]})
    runs = {}
    for mode in ("auto", "off"):
        for h in hists.values():
            h.reset()
        t0 = time.perf_counter()
        tuned = tuner(mode).fit(tune_t)
        secs = time.perf_counter() - t0
        runs[mode] = tuned
        summ = {n: hists[n].summary()
                for n in ("tune_fold_build", "tune_trials", "tune_refit")}
        print(f"automl (c) tune batchTrials={mode!r}: {secs:.3f} s, "
              f"{tuned.search_info}, bestParams {tuned.get('bestParams')}, "
              f"bestMetric {tuned.get('bestMetric'):.5f}; {summ}")
    info = runs["auto"].search_info
    check(info["path"] == "vmap" and info["dispatches"] == 3,
          f"(c): batched search_info {info}")
    check(runs["off"].search_info["path"] == "serial",
          f"(c): off search_info {runs['off'].search_info}")
    check(runs["auto"].get("bestParams") == runs["off"].get("bestParams"),
          "(c): batched and serial tunes select different bestParams")
    d_hist = max(abs(a["metric"] - b["metric"]) for a, b in zip(
        runs["auto"].get("history"), runs["off"].get("history")))
    print(f"automl (c): batched and serial select the same bestParams; "
          f"max |CV metric diff| over the 8 candidates {d_hist:.3e}")

    # ---- (d) the sparse logistic backend at width 262,144 ---------------
    head = table.slice(0, AUTOML_SPARSE_ROWS)
    t0 = time.perf_counter()
    sfm = Featurize(featureColumns=FEATURE_COLUMNS, sparse=True).fit(head)
    sparse_t = sfm.transform(head)
    sf_s = time.perf_counter() - t0
    csr = sparse_t["features"]
    check(type(csr).__name__ == "CSRMatrix" and csr.shape ==
          (AUTOML_SPARSE_ROWS, 3 + (1 << 18)),
          f"(d): features {type(csr).__name__} {getattr(csr, 'shape', '')}")
    cut = AUTOML_SPARSE_ROWS * 9 // 10
    fit_t, test_t = sparse_t.slice(0, cut), sparse_t.slice(
        cut, AUTOML_SPARSE_ROWS)
    fits = []
    for _ in range(2):
        t0 = time.perf_counter()
        m = TPULogisticRegression().fit(fit_t)
        torch.cuda.synchronize()
        fits.append((m, time.perf_counter() - t0))
    (m1, s1), (m2, s2) = fits
    w1, w2 = m1.get("weights"), m2.get("weights")
    check(all(np.array_equal(w1[k], w2[k]) for k in ("W", "b")),
          "(d): two sparse fits on the card differ")
    pred = np.asarray(m1.transform(test_t)["prediction"])
    acc = float((pred == label[cut:AUTOML_SPARSE_ROWS]).mean())
    check(acc > 0.9, f"(d): holdout accuracy {acc}")
    print(f"automl (d): Featurize(sparse=True) of {AUTOML_SPARSE_ROWS} rows "
          f"{sf_s:.3f} s ({csr.nnz} nonzeros of width {csr.shape[1]}); "
          f"TPULogisticRegression on the CSR column (maxIter 300) "
          f"{s1:.3f} s / {s2:.3f} s, two card fits bitwise equal; "
          f"holdout accuracy {acc:.5f}")
    del sparse_t, csr, fit_t, test_t, fits, m1, m2

    # ---- (e) two GBDT candidates fitted side by side in threads ---------
    thr_t = DataTable({"features": X[:AUTOML_THREAD_ROWS],
                       "label": label[:AUTOML_THREAD_ROWS]})
    space = GridSpace({"numIterations": DiscreteHyperParam([5, 10])})
    hist_by = {}
    for par in (4, 1):
        t0 = time.perf_counter()
        tuned = TuneHyperparameters(
            models=[TPUBoostClassifier(minDataInLeaf=5)], paramSpace=space,
            numFolds=2, parallelism=par).fit(thr_t)
        hist_by[par] = (tuned.get("history"), time.perf_counter() - t0)
        check(tuned.search_info["path"] == "serial",
              f"(e): {tuned.search_info}")
    check(hist_by[4][0] == hist_by[1][0],
          f"(e): history at parallelism 4 {hist_by[4][0]} differs from "
          f"parallelism 1 {hist_by[1][0]}")
    print(f"automl (e): serial tune of 2 GBDT candidates x 2 folds on "
          f"{AUTOML_THREAD_ROWS} rows, parallelism 4 ({hist_by[4][1]:.3f} s)"
          f" and 1 ({hist_by[1][1]:.3f} s): equal history "
          f"{[round(h['metric'], 6) for h in hist_by[1][0]]}")

    # ---- (f) dense linear fits, card against CPU -------------------------
    n = AUTOML_CPU_ROWS
    rng = np.random.default_rng(11)
    Xs = X[:n]
    y_reg = Xs.astype(np.float64) @ rng.normal(size=Xs.shape[1]) \
        + rng.normal(size=n)
    for est, y, wkey in ((TPULogisticRegression, label[:n], "W"),
                         (TPULinearRegression, y_reg, "w")):
        t = DataTable({"features": Xs, "label": y})
        t0 = time.perf_counter()
        mg = est(device="cuda").fit(t)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mc = est(device="cpu").fit(t)
        cpu_s = time.perf_counter() - t0
        wg, wc = mg.get("weights"), mc.get("weights")
        scale = max(float(np.abs(wc[wkey]).max()),
                    float(np.abs(wc["b"]).max()))
        w_err = max(float(np.abs(wg[k] - wc[k]).max()) for k in (wkey, "b"))
        ok = all(np.allclose(wg[k], wc[k], rtol=1e-4, atol=1e-5 * scale)
                 for k in (wkey, "b"))
        check(ok, f"(f) {est.__name__}: card vs CPU weights differ by "
              f"{w_err} (scale {scale})")
        pg = np.asarray(mg.transform(t)["prediction"])
        pc = np.asarray(mc.transform(t)["prediction"])
        if est is TPULogisticRegression:
            agree = float((pg == pc).mean())
        else:
            agree = float(np.isclose(pg, pc, rtol=1e-4, atol=1e-5 * float(
                np.abs(pc).max())).mean())
        check(agree >= 0.999, f"(f) {est.__name__}: predictions agree on "
              f"{agree}")
        print(f"automl (f) {est.__name__} (maxIter 300, {n} rows x "
              f"{Xs.shape[1]}): card {card_s:.3f} s, CPU {cpu_s:.3f} s; "
              f"max |weight diff| {w_err:.3e} of scale {scale:.3e} (rtol "
              f"1e-4, atol 1e-5 of it); predictions agree on "
              f"{100 * agree:.2f} % of rows")
    return row


INTERCHANGE_DIR = os.path.join("build", "chip_smoke_interchange")
INT8_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor-core rate
ONNX_ROWS = 1024            # phase 12(a)'s seeded 224 x 224 images
CKPT_ROWS = 32              # phase 12(c)'s LM rows (4 steps an epoch)
CKPT_DEPTH = 2              # phase 12(c)'s LM depth: LM_SPEC's width, cut
#                             from 8 blocks (its 6.4 GB checkpoints took
#                             ~60 s of the script's time limit)
CIFAR_CKPT_ROWS = 4096      # phase 12(c)'s ConvNet rows at batch 1024


def onnx_block_graph(path: str, ow, rng, T: int = 6, D: int = 16,
                     H: int = 4) -> None:
    """The BERT-style block of tests/test_onnx_import.py: LayerNorm as a
    ReduceMean / Sub / Pow / Sqrt / Div chain, fused QKV + Split, masked
    Softmax attention, erf GELU."""
    hd = D // H

    def w(shape, scale=0.25):
        return rng.normal(scale=scale, size=shape).astype(np.float32)

    inits = {"ln_g": np.ones(D, np.float32), "ln_b": w((D,), 0.1),
             "wqkv": w((D, 3 * D)), "bqkv": w((3 * D,), 0.05),
             "wo": w((D, D)), "bo": w((D,), 0.05),
             "ln2_g": np.ones(D, np.float32), "ln2_b": w((D,), 0.1),
             "w1": w((D, 4 * D)), "b1": w((4 * D,), 0.05),
             "w2": w((4 * D, D)), "b2": w((D,), 0.05),
             "eps": np.asarray([1e-5], np.float32),
             "half": np.asarray([0.5], np.float32),
             "one": np.asarray([1.0], np.float32),
             "sqrt2": np.asarray([np.sqrt(2.0)], np.float32),
             "scale": np.asarray([1.0 / np.sqrt(hd)], np.float32),
             "neg": np.asarray([-1e9], np.float32),
             "mask": np.tril(np.ones((T, T), bool)),
             "h_shape": np.asarray([0, 0, H, hd], np.int64),
             "m_shape": np.asarray([0, 0, D], np.int64),
             "two": np.asarray([2.0], np.float32)}
    n = ow.node

    def ln(x, g, b, p):
        return [n("ReduceMean", [x], [f"{p}mu"], axes=[-1], keepdims=1),
                n("Sub", [x, f"{p}mu"], [f"{p}c"]),
                n("Pow", [f"{p}c", "two"], [f"{p}c2"]),
                n("ReduceMean", [f"{p}c2"], [f"{p}v"], axes=[-1],
                  keepdims=1),
                n("Add", [f"{p}v", "eps"], [f"{p}ve"]),
                n("Sqrt", [f"{p}ve"], [f"{p}sd"]),
                n("Div", [f"{p}c", f"{p}sd"], [f"{p}n"]),
                n("Mul", [f"{p}n", g], [f"{p}ng"]),
                n("Add", [f"{p}ng", b], [f"{p}out"])]
    nodes = ln("x", "ln_g", "ln_b", "l1") + [
        n("MatMul", ["l1out", "wqkv"], ["qkv0"]),
        n("Add", ["qkv0", "bqkv"], ["qkv"]),
        n("Split", ["qkv"], ["q", "k", "v"], axis=-1, num_outputs=3)]
    for nm in ("q", "k", "v"):
        nodes += [n("Reshape", [nm, "h_shape"], [f"{nm}h"]),
                  n("Transpose", [f"{nm}h"], [f"{nm}t"], perm=[0, 2, 1, 3])]
    nodes += [n("Transpose", ["kt"], ["ktt"], perm=[0, 1, 3, 2]),
              n("MatMul", ["qt", "ktt"], ["sc0"]),
              n("Mul", ["sc0", "scale"], ["sc"]),
              n("Where", ["mask", "sc", "neg"], ["scm"]),
              n("Softmax", ["scm"], ["attn"], axis=-1),
              n("MatMul", ["attn", "vt"], ["ctx"]),
              n("Transpose", ["ctx"], ["ctxt"], perm=[0, 2, 1, 3]),
              n("Reshape", ["ctxt", "m_shape"], ["ctxm"]),
              n("MatMul", ["ctxm", "wo"], ["proj0"]),
              n("Add", ["proj0", "bo"], ["proj"]),
              n("Add", ["x", "proj"], ["res1"])]
    nodes += ln("res1", "ln2_g", "ln2_b", "l2") + [
        n("MatMul", ["l2out", "w1"], ["m0"]), n("Add", ["m0", "b1"], ["m1"]),
        n("Div", ["m1", "sqrt2"], ["g0"]), n("Erf", ["g0"], ["g1"]),
        n("Add", ["g1", "one"], ["g2"]), n("Mul", ["m1", "g2"], ["g3"]),
        n("Mul", ["g3", "half"], ["gelu"]),
        n("MatMul", ["gelu", "w2"], ["m2"]), n("Add", ["m2", "b2"], ["m3"]),
        n("Add", ["res1", "m3"], ["out"])]
    with open(path, "wb") as f:
        f.write(ow.model(nodes, inits, ("x", 1, ["N", T, D]),
                         ("out", 1, ["N", T, D])))


def int8_host_exact(x: np.ndarray, wq: np.ndarray, x_scale, w_scale,
                    dev) -> np.ndarray:
    """``int8_matmul_host``'s output at a size its numpy int32 product
    cannot reach in a run: the same host quantization and f32 epilogue,
    with the exact int32 accumulator taken from a float64 product (every
    partial sum is an integer below 2**53, so float64 is exact) on the
    card's float64 units, never through the int8 GEMM under test."""
    import torch
    from mmlspark_tpu_torch.core import quantize as PQ
    q = (x.astype(np.float32) / np.float32(x_scale)).astype(np.float32)
    with np.errstate(invalid="ignore"):
        xq = np.clip(np.round(q), -PQ.QMAX, PQ.QMAX)
    xq = np.nan_to_num(xq, nan=0.0).astype(np.int8)
    acc = (torch.from_numpy(xq).to(dev, torch.float64)
           @ torch.from_numpy(wq).to(dev, torch.float64))
    acc = acc.to(torch.int32).cpu().numpy()
    out = acc.astype(np.float32) * (
        np.float32(x_scale) * np.asarray(w_scale, np.float32))
    nan_row = np.isnan(x.astype(np.float32)).any(axis=-1, keepdims=True)
    return np.where(nan_row, np.float32(np.nan), out)


def interchange_slice(dev, smi: str) -> dict:
    """Phase 12: models entering and leaving the system on the card — the
    ONNX executor at ResNet-18 width, int8 at LM width, checkpoint /
    resume at LM width and on a WebDAV store. Returns the phase's flash
    launches: {"f32": forward launches of the int8 transform, "bf16":
    each kernel's launches over the checkpointed LM fits}, and the int8
    GEMMs' times."""
    import torch

    from mmlspark_tpu_torch.core import quantize as PQ
    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.downloader import HTTPRepo, LocalRepo
    from mmlspark_tpu_torch.importers import import_onnx_model, onnx_summary
    from mmlspark_tpu_torch.models import learner as PLM
    from mmlspark_tpu_torch.models import networks
    from mmlspark_tpu_torch.models.learner import TPULearner
    from mmlspark_tpu_torch.models.networks import build_network
    from mmlspark_tpu_torch.models.tpu_model import TPUModel
    from mmlspark_tpu_torch.ops import flash_attention as FA
    from mmlspark_tpu_torch.profile_hist import time_ms
    from mmlspark_tpu_torch.profile_train import (
        CIFAR_BATCH, CIFAR_SPECS, cifar_table, slice_table)
    from mmlspark_tpu_torch.profile_transform import (
        BATCH as LM_BATCH, LM_SPEC, ROWS as LM_ROWS)
    from mmlspark_tpu_torch.testing.webdav import serve_webdav
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "onnx_writer", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "tests", "onnx_writer.py"))
    ow = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ow)      # the repo's numpy-only ONNX writer

    shutil.rmtree(INTERCHANGE_DIR, ignore_errors=True)
    os.makedirs(INTERCHANGE_DIR)
    out = {"f32": 0, "bf16": {}, "int8_gemms": []}

    # ---- (a) ONNX at full ResNet-18 width ---------------------------------
    server, base = serve_webdav(os.path.join(INTERCHANGE_DIR, "dav"))
    try:
        src = os.path.join(INTERCHANGE_DIR, "resnet18.onnx")
        t0 = time.perf_counter()
        ow.resnet18_onnx(src, num_classes=1000, width=64, seed=0)
        summary = onnx_summary(src)
        check(summary["ops"].get("Conv") == 20,
              f"resnet18 graph ops {summary['ops']}")
        with open(src, "rb") as f:
            blob = f.read()
        # published into the directory the WebDAV server serves, read
        # back over HTTP with sha256 verification
        LocalRepo(os.path.join(INTERCHANGE_DIR, "dav", "zoo")).publish(
            "onnx_resnet18", {"format": "onnx", "onnx_summary": summary},
            blob=blob, model_type="classification")
        repo = HTTPRepo(f"{base}/zoo")
        schema = repo.get_schema("onnx_resnet18")
        fetched = repo.read_blob(schema, verify=True)
        check(fetched == blob and schema.network_spec["onnx_summary"]
              == summary, "ONNX blob or manifest changed over WebDAV")
        path = os.path.join(INTERCHANGE_DIR, "reload.onnx")
        with open(path, "wb") as f:
            f.write(fetched)
        print(f"interchange (a): resnet18 ONNX (width 64, 1000 classes, "
              f"{len(blob) / 1e6:.1f} MB, {summary['num_initializers']} "
              f"initializers, ops {summary['ops']}) written, published "
              f"and fetched sha256-verified over WebDAV in "
              f"{time.perf_counter() - t0:.2f} s")
    finally:
        server.shutdown()
        server.server_close()
    t0 = time.perf_counter()
    model = import_onnx_model(path, batch_size=256,
                              input_shape=[3, 224, 224])
    import_s = time.perf_counter() - t0
    rng = np.random.default_rng(11)
    images = rng.normal(size=(ONNX_ROWS, 3 * 224 * 224)).astype(np.float32)
    t0 = time.perf_counter()
    first = model.transform(DataTable({"images": images[:256]}))["scores"]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores = model.transform(DataTable({"images": images}))["scores"]
    torch.cuda.synchronize()
    onnx_s = time.perf_counter() - t0
    check(scores.shape == (ONNX_ROWS, 1000)
          and bool(np.isfinite(scores).all()),
          f"ONNX resnet18 scores {scores.shape}")
    check(np.array_equal(first, scores[:256]),
          "ONNX first batch differs between two transforms")
    cpu = import_onnx_model(path, batch_size=8, input_shape=[3, 224, 224],
                            device="cpu")
    ref = cpu.transform(DataTable({"images": images[:8]}))["scores"]
    err = float(np.abs(scores[:8] - ref).max())
    # the writer's seeded weights (normal(0.1), random BatchNorm
    # statistics) are not variance-preserving: the logits reach ~1e8, so
    # atol 2e-4 is taken of their scale
    scale = float(np.abs(ref).max())
    check(np.allclose(scores[:8], ref, rtol=2e-4, atol=2e-4 * scale)
          and np.array_equal(scores[:8].argmax(1), ref.argmax(1)),
          f"ONNX resnet18 card vs CPU: max |diff| {err} at scale {scale}")
    print(f"interchange (a): import {import_s:.3f} s; first batch of 256 "
          f"{first_s:.3f} s; {ONNX_ROWS} x 224 x 224 at batch 256 in "
          f"{onnx_s:.3f} s ({ONNX_ROWS / onnx_s:.1f} imgs/s, strict f32); "
          f"card vs CPU on 8 rows max |diff| {err:.3e} at a logit "
          f"scale of {scale:.3e} ({err / scale:.2e} of it; rtol 2e-4, "
          f"atol 2e-4 of the scale), argmax equal; card {smi}")
    del model, cpu, images, scores
    torch.cuda.empty_cache()

    # the BiLSTM, GRU and Transformer-block graphs of the reference's tests
    rng = np.random.default_rng(12)
    graphs = {}
    torch.manual_seed(0)
    emb = torch.nn.Embedding(50, 16)
    lstm = torch.nn.LSTM(16, 24, batch_first=True, bidirectional=True)
    fc = torch.nn.Linear(48, 7)
    sd = {f"embed.{k}": v for k, v in emb.state_dict().items()}
    sd.update({f"lstm.{k}": v for k, v in lstm.state_dict().items()})
    sd.update({f"fc.{k}": v for k, v in fc.state_dict().items()})
    p = os.path.join(INTERCHANGE_DIR, "bilstm.onnx")
    ow.bilstm_onnx(p, {k: v.detach().numpy() for k, v in sd.items()},
                   seq_len=12)
    graphs["bilstm"] = (p, rng.integers(0, 50, (5, 12)).astype(np.int32))
    gru = torch.nn.GRU(12, 16, bidirectional=True)
    gsd = {k: v.detach().numpy() for k, v in gru.state_dict().items()}

    def zrn(t):
        r, z, nn_ = np.split(t, 3, axis=0)
        return np.concatenate([z, r, nn_], axis=0)
    sfx = ("", "_reverse")
    inits = {"W": np.stack([zrn(gsd[f"weight_ih_l0{s}"]) for s in sfx]),
             "R": np.stack([zrn(gsd[f"weight_hh_l0{s}"]) for s in sfx]),
             "B": np.stack([np.concatenate([zrn(gsd[f"bias_ih_l0{s}"]),
                                            zrn(gsd[f"bias_hh_l0{s}"])])
                            for s in sfx]),
             "shape": np.asarray([0, 0, -1], np.int64)}
    nodes = [ow.node("GRU", ["input", "W", "R", "B"], ["y", "yh"],
                     hidden_size=16, linear_before_reset=1,
                     direction="bidirectional"),
             ow.node("Transpose", ["y"], ["yt"], perm=[0, 2, 1, 3]),
             ow.node("Reshape", ["yt", "shape"], ["output"])]
    p = os.path.join(INTERCHANGE_DIR, "gru.onnx")
    with open(p, "wb") as f:
        f.write(ow.model(nodes, inits, "input", "output"))
    graphs["gru"] = (p, rng.normal(size=(10, 4, 12)).astype(np.float32))
    p = os.path.join(INTERCHANGE_DIR, "block.onnx")
    onnx_block_graph(p, ow, rng)
    graphs["transformer block"] = (
        p, rng.normal(size=(2, 6, 16)).astype(np.float32))
    for name, (p, x) in graphs.items():
        got = import_onnx_model(p, batch_size=8).transform(
            DataTable({"images": x}))["scores"]
        want = import_onnx_model(p, batch_size=8, device="cpu").transform(
            DataTable({"images": x}))["scores"]
        err = float(np.abs(got - want).max())
        check(got.shape == want.shape and np.allclose(
            got, want, rtol=2e-4, atol=2e-4),
            f"ONNX {name} card vs CPU: max |diff| {err}")
        print(f"interchange (a): ONNX {name} graph {got.shape}: card vs "
              f"CPU max |diff| {err:.3e} (rtol 2e-4, atol 2e-4)")

    # ---- (b) int8 at full LM width ----------------------------------------
    lm = build_network(LM_SPEC, device="cuda", seed=0)
    tokens = np.random.default_rng(7).integers(
        0, LM_SPEC["vocab_size"], size=(LM_ROWS, LM_SPEC["max_len"]))
    table = DataTable({"tokens": tokens})
    f32m = TPUModel.from_module(lm, device="cuda", inputCol="tokens",
                                outputCol="logits", batchSize=LM_BATCH)
    f32m.transform(table)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f32_logits = f32m.transform(table)["logits"]
    torch.cuda.synchronize()
    f32_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    q = f32m.quantize({"tokens": tokens[:2]})
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    paths = PQ.quantized_paths(q.get("weights"))
    want_paths = sorted([f"block_{i}/{n}" for i in range(LM_SPEC["depth"])
                         for n in ("qkv", "proj", "mlp_up", "mlp_down")]
                        + ["lm_head"])
    check(paths == want_paths, f"int8 LM quantized {paths}")
    n_batches = -(-LM_ROWS // LM_BATCH)
    FA.reset_launches()
    PQ.reset_launches()
    t0 = time.perf_counter()
    logits = q.transform(table)["logits"]
    torch.cuda.synchronize()
    int8_first_s = time.perf_counter() - t0
    flash_l = FA.LAUNCHES["_fwd_kernel"]
    gemm_l = PQ.LAUNCHES["int8_mm"]
    out["f32"] = flash_l
    check(flash_l == LM_SPEC["depth"] * n_batches,
          f"int8 LM transform: {flash_l} flash launches, not "
          f"{LM_SPEC['depth']} x {n_batches}")
    check(gemm_l == 33 * n_batches,
          f"int8 LM transform: {gemm_l} int8 GEMMs, not 33 x {n_batches}")
    check(logits.shape == f32_logits.shape
          and bool(np.isfinite(logits).all()), "int8 LM logits not finite")
    t0 = time.perf_counter()
    q.transform(table)
    torch.cuda.synchronize()
    int8_s = time.perf_counter() - t0
    tail = q.transform(DataTable({"tokens": tokens[16:20]}))["logits"]
    tail_err = float(np.abs(tail - logits[16:20]).max())
    check(tail_err <= 1e-5, f"int8 rows 16-19 alone differ by {tail_err}")
    agree = float((logits.argmax(-1) == f32_logits.argmax(-1)).mean())
    print(f"interchange (b): quantize (2 x 1024 calibration tokens, "
          f"{len(paths)} layers) {quant_s:.3f} s; int8 transform of "
          f"{LM_ROWS} x 1024 at batch {LM_BATCH}: {int8_first_s:.3f} s "
          f"first, {int8_s:.3f} s warm, against the f32 transform's "
          f"{f32_s:.3f} s warm; {flash_l} flash and {gemm_l} int8 GEMM "
          f"launches ({n_batches} batches); rows 16-19 alone vs the full "
          f"run {tail_err:.3e}; argmax equal to the f32 model's on "
          f"{100 * agree:.2f} % of positions; card {smi}")
    del logits, f32_logits, tail

    # each distinct int8 GEMM shape of the forward, at M = 8192: bitwise
    # to the host mirror, and timed against strict-f32 torch.matmul
    qw = q.get("weights")
    want_x = {"block_0/qkv": None, "block_0/proj": None,
              "block_0/mlp_up": None, "block_0/mlp_down": None,
              "lm_head": None}
    paths_of = PQ.dense_paths(lm)

    def capture(x, lin, dtype):
        pth = paths_of.get(lin)
        if pth in want_x and want_x[pth] is None:
            want_x[pth] = x.detach().float().clone()
        return None
    token = networks.DENSE_HOOK.set(capture)
    try:
        with torch.inference_mode():
            lm(torch.from_numpy(tokens[:LM_BATCH]).to(dev))
    finally:
        networks.DENSE_HOOK.reset(token)
    gemm_rows = []
    for pth, x in want_x.items():
        x = x.reshape(-1, x.shape[-1])
        qd = qw[PQ.QUANT_KEY][pth]
        wq, xs, ws = qd["wq"], qd["x_scale"], qd["w_scale"]
        op = PQ.mm_operand(wq)
        m, k = x.shape
        n = wq.shape[1]
        got = PQ.int8_matmul(x, wq, xs, ws, operand=op).cpu().numpy()
        x_np = x.cpu().numpy()
        wq_np, xs_np, ws_np = (wq.cpu().numpy(), xs.cpu().numpy(),
                               ws.cpu().numpy())
        full = int8_host_exact(x_np, wq_np, xs_np, ws_np, dev)
        rows = np.random.default_rng(3).choice(m, 16, replace=False)
        host = PQ.int8_matmul_host(x_np[rows], wq_np, xs_np, ws_np)
        check(np.array_equal(got, full)
              and np.array_equal(got[rows], host),
              f"int8 GEMM {pth} ({m} x {k} x {n}) differs from the host "
              f"mirror")
        # the card's weight quantization is the host's, bit for bit
        kernel = qw[f"{pth.replace('/', '.')}.weight"].t().cpu().numpy()
        hq, hs = PQ.quantize_weight(kernel, axis=-1)
        check(np.array_equal(hq, wq_np) and np.array_equal(hs, ws_np),
              f"{pth}: quantize_weight_t on the card differs from "
              "quantize_weight on the host")
        xq = PQ.quantize_act(x, xs)
        acc = PQ.int8_mm(xq, op, n)
        w32 = torch.from_numpy(wq_np.astype(np.float32) * ws_np).to(dev)
        mm_ms = time_ms(lambda: torch._int_mm(xq, op))
        f32_ms = time_ms(lambda: torch.matmul(x, w32))
        qa_ms = time_ms(lambda: PQ.quantize_act(x, xs))
        ep_ms = time_ms(lambda: acc.float() * (xs * ws))
        bound = max(2.0 * m * n * k / INT8_OPS_PER_S,
                    (m * k + k * n + 4 * m * n) / HBM_BYTES_PER_S) * 1e3
        by = ("operations" if 2.0 * m * n * k / INT8_OPS_PER_S
              > (m * k + k * n + 4 * m * n) / HBM_BYTES_PER_S else "bytes")
        gemm_rows.append({"layer": pth, "m": m, "k": k, "n": n,
                          "int_mm_ms": mm_ms, "f32_matmul_ms": f32_ms,
                          "bound_ms": bound, "bound_by": by,
                          "quantize_ms": qa_ms, "epilogue_ms": ep_ms})
        print(f"interchange (b): int8 GEMM {pth} ({m} x {k} x {n}): "
              f"bitwise equal to int8_matmul_host (all rows through the "
              f"exact f64 accumulator, 16 rows literally), its int8 "
              f"weights and scales to quantize_weight's; torch._int_mm "
              f"{mm_ms:.4f} ms, strict-f32 torch.matmul {f32_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({by}); quantize {qa_ms:.4f} ms, "
              f"epilogue {ep_ms:.4f} ms")
        del got, full, acc, xq, w32
    out["int8_gemms"] = gemm_rows
    del q, f32m, lm, qw, want_x
    torch.cuda.empty_cache()

    # a depth-2 int8 model on the card against the CPU, quantized once on
    # the CPU so both run the same int8 weights and scales. An f32
    # activation that differs in its last bits between the two devices
    # moves one step where it sits on a rounding boundary, and each such
    # step shifts its whole output row, so the differences compound
    # layer by layer (phase 4's f32 rule cannot hold): the first layer's
    # int8 inputs are held to boundary flips (<= 0.1 %, one step), and
    # the logits to no further from the CPU's than the int8 model is
    # from the f32 one, in argmax agreement and in max |diff|
    spec2 = dict(LM_SPEC, depth=2, head_dtype="float32")
    row = DataTable({"tokens": tokens[:1]})
    m2 = TPUModel.from_module(build_network(spec2, device="cpu", seed=1),
                              device="cpu", inputCol="tokens",
                              outputCol="logits", batchSize=1)
    q2 = m2.quantize(row)
    real_qa = PQ.quantize_act
    res = {}
    try:
        for device in ("cpu", "cuda"):
            seen = res[device + "_q"] = []

            def recording(x, xs, _seen=seen):
                xq = real_qa(x, xs)
                _seen.append(xq.cpu())
                return xq
            PQ.quantize_act = recording
            q2.set("device", device)
            t0 = time.perf_counter()
            res[device] = q2.transform(row)["logits"]
            res[device + "_s"] = time.perf_counter() - t0
    finally:
        PQ.quantize_act = real_qa
    f32_cpu = m2.transform(row)["logits"]
    del q2, m2
    layer_stats = []
    for a, b in zip(res["cpu_q"], res["cuda_q"]):
        d = (a.int() - b.int()).abs()
        layer_stats.append((float((d > 0).double().mean()), int(d.max())))
    print(f"interchange (b): depth-2 int8 layer inputs card vs CPU (share "
          f"differing, largest step): {layer_stats}")
    check(len(layer_stats) == 9 and layer_stats[0][0] <= 1e-3
          and layer_stats[0][1] <= 1,
          f"depth-2 int8 first layer's inputs card vs CPU: "
          f"{layer_stats[0]}")
    agree2 = float((res["cuda"].argmax(-1)
                    == res["cpu"].argmax(-1)).mean())
    own = float((res["cpu"].argmax(-1) == f32_cpu.argmax(-1)).mean())
    d2 = float(np.abs(res["cuda"] - res["cpu"]).max())
    q_err = float(np.abs(res["cpu"] - f32_cpu).max())
    check(agree2 >= own and d2 <= q_err,
          f"depth-2 int8 card vs CPU: argmax agree {agree2} (int8 vs f32 "
          f"{own}), max |diff| {d2} (int8 vs f32 {q_err})")
    print(f"interchange (b): depth-2 int8, 1 x 1024 tokens, card vs CPU "
          f"(CPU {res['cpu_s']:.1f} s): argmax equal on "
          f"{100 * agree2:.2f} % of positions (int8 vs "
          f"f32 on the CPU: {100 * own:.2f} %), max |logit diff| "
          f"{d2:.3e} (int8 vs f32: {q_err:.3e})")
    torch.cuda.empty_cache()

    # ---- (c) checkpoint / resume ------------------------------------------
    saves, loads = [], []
    real_save = PLM._save_checkpoint
    real_load = PLM._load_checkpoint_pytree

    def timed_save(*a, **kw):
        t = time.perf_counter()
        real_save(*a, **kw)
        saves.append(time.perf_counter() - t)

    def timed_load(*a, **kw):
        t = time.perf_counter()
        r = real_load(*a, **kw)
        loads.append(time.perf_counter() - t)
        return r
    PLM._save_checkpoint = timed_save
    PLM._load_checkpoint_pytree = timed_load

    def host_weights(model):
        return {k: v.detach().cpu().clone()
                for k, v in model.get("weights").items()}

    def max_diff(a, b):
        return max(float((a[k].float() - b[k].float()).abs().max())
                   for k in a)

    def held(tag, full, resumed, repeat):
        """Bitwise, or within the repeat difference of the full fit."""
        (lf, wf), (lr, wr) = full, resumed
        if lf[-4:] == lr[-4:] and all(torch.equal(wf[k], wr[k])
                                      for k in wf):
            print(f"interchange (c) {tag}: the resumed fit's last 4 "
                  "losses and final weights equal the uninterrupted "
                  "fit's bitwise")
            return
        la, wa = repeat()
        rep = max_diff(wf, wa)
        got = max_diff(wf, wr)
        check(rep > 0 and got <= rep,
              f"{tag}: resumed fit differs by {got} (losses {lr[-4:]} vs "
              f"{lf[-4:]}); the full fit's own repeat differs by {rep}")
        print(f"interchange (c) {tag}: NOT bitwise — resumed vs full "
              f"max |weight diff| {got:.3e}, within the full fit's own "
              f"repeat difference {rep:.3e} (losses {lr[-4:]} vs "
              f"{lf[-4:]})")

    try:
        table = slice_table(CKPT_ROWS)
        kw = dict(networkSpec={**LM_SPEC, "depth": CKPT_DEPTH},
                  loss="token_cross_entropy",
                  optimizer="adamw", learningRate=1e-3, batchSize=LM_BATCH,
                  computeDtype="bfloat16", dataFeed="device",
                  schedule="constant", logEvery=1, checkpointEvery=4)
        FA.reset_launches()

        def lm_fit(epochs, ckpt=""):
            learner = TPULearner(epochs=epochs, checkpointDir=ckpt, **kw)
            model = learner.fit(table)
            torch.cuda.synchronize()
            w = host_weights(model)
            del model
            torch.cuda.empty_cache()
            return [h["loss"] for h in learner.history], w

        t0 = time.perf_counter()
        full = lm_fit(2)
        full_s = time.perf_counter() - t0
        ck = os.path.join(INTERCHANGE_DIR, "lm_ckpt")
        t0 = time.perf_counter()
        lm_fit(1, ck)
        part_s = time.perf_counter() - t0
        step4 = os.path.join(ck, "step_00000004", "leaves.npz")
        nbytes = os.path.getsize(step4)
        free = shutil.disk_usage(INTERCHANGE_DIR).free
        t0 = time.perf_counter()
        resumed = lm_fit(2, ck)
        res_s = time.perf_counter() - t0
        check(len(resumed[0]) == 4 and all(np.isfinite(resumed[0])),
              f"resumed LM fit losses {resumed[0]}")
        held("LM (bf16, AdamW, device feed)", full, resumed,
             lambda: lm_fit(2))
        print(f"interchange (c): LM checkpoint of {nbytes / 1e9:.3f} GB "
              f"(params + AdamW mu / nu, f32), {free / 1e9:.1f} GB free "
              f"after it; saves {[round(s, 3) for s in saves]} s, loads "
              f"{[round(s, 3) for s in loads]} s; fits: full 2 epochs "
              f"{full_s:.2f} s, 1 epoch + save {part_s:.2f} s, resume + 1 "
              f"epoch + save {res_s:.2f} s")
        # truncate the newest leaves.npz: the resume falls back to step 4
        newest = os.path.join(ck, "step_00000008", "leaves.npz")
        with open(newest, "r+b") as f:
            f.truncate(os.path.getsize(newest) // 2)
        learner = TPULearner(epochs=2, checkpointDir=ck, **kw)
        model = learner.fit(table)
        torch.cuda.synchronize()
        steps = [h["step"] for h in learner.history]
        fb = [h["loss"] for h in learner.history]
        check(steps == [5, 6, 7, 8] and fb == full[0][-4:],
              f"fallback resume ran steps {steps}, losses {fb}")
        print(f"interchange (c): newest leaves.npz truncated to half: the "
              f"resume fell back to step 4 and replayed steps 5-8 "
              f"(losses equal the full fit's)")
        del model, learner, full, resumed
        out["bf16"] = dict(FA.LAUNCHES)
        shutil.rmtree(ck, ignore_errors=True)
        torch.cuda.empty_cache()

        # bench.py's CIFAR ConvNet through a webdav:// checkpoint directory
        server, base = serve_webdav(os.path.join(INTERCHANGE_DIR, "dav2"))
        try:
            ctable = cifar_table(CIFAR_CKPT_ROWS, seed=5)
            ckw = dict(networkSpec=CIFAR_SPECS["convnet"],
                       inputShape=[32, 32, 3], batchSize=CIFAR_BATCH,
                       learningRate=0.1, computeDtype="bfloat16",
                       dataFeed="device", schedule="constant", logEvery=1,
                       checkpointEvery=2)

            def cifar_fit(epochs, ckpt=""):
                learner = TPULearner(epochs=epochs, checkpointDir=ckpt,
                                     **ckw)
                model = learner.fit(ctable)
                torch.cuda.synchronize()
                return ([h["loss"] for h in learner.history],
                        host_weights(model))
            n0 = len(saves)
            cfull = cifar_fit(2)
            cck = f"{base}/cifar_ckpt"
            cifar_fit(1, cck)
            cres = cifar_fit(2, cck)
            check(PLM._remote_steps(cck) == ["step_00000004",
                                             "step_00000006",
                                             "step_00000008"],
                  f"webdav checkpoints {PLM._remote_steps(cck)}")
            held("CIFAR ConvNet (bf16, momentum, webdav://)", cfull, cres,
                 lambda: cifar_fit(2))
            print(f"interchange (c): ConvNet over WebDAV: saves "
                  f"{[round(s, 3) for s in saves[n0:]]} s, load "
                  f"{loads[-1]:.3f} s")
        finally:
            server.shutdown()
            server.server_close()
    finally:
        PLM._save_checkpoint = real_save
        PLM._load_checkpoint_pytree = real_load
        shutil.rmtree(INTERCHANGE_DIR, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 13: fused and streamed pipelines
# ---------------------------------------------------------------------------

FUSED_REQUESTS = 2000       # phase 13(e)'s one-row raw JSON requests
PROFILE_WARM = """
import json
from mmlspark_tpu_torch.profile_pipeline import warm_profile
busy = warm_profile()
top = sorted(busy.pop("by_name").items(), key=lambda kv: -kv[1][1])[:4]
busy["top"] = [(k[:40], n, round(us / 1e3, 3)) for k, (n, us) in top]
print(json.dumps(busy))
"""
SUMMARY_ROWS = 1_000_000    # phase 13(b)'s SummarizeData stream
# phase 13(b)'s streamed rows: bench_ooc's 10M cut to 4M for the script's
# time limit (the materialized baseline still exceeds the 1.5 GB budget)
OOC_STREAM_ROWS = 4_000_000
LM_STREAM_CHUNK = 8         # phase 13(d)'s .npy chunk rows


def _status_kb(key: str) -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1])
    return 0


class RssPeak:
    """The resident set's growth over a block: the largest VmRSS that a
    sampler reads every 5 ms, less the resident set when the block
    began. The peak is sampled, so a spike shorter than 5 ms can slip
    between two reads. The process's own ru_maxrss and VmHWM cannot
    serve: earlier phases left them higher than anything this block
    reaches, and not every kernel lets /proc/self/clear_refs reset
    VmHWM."""

    def __enter__(self):
        import threading
        self.before = _status_kb("VmRSS") * 1024
        self.sampled = self.before
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.005):
                self.sampled = max(self.sampled,
                                   _status_kb("VmRSS") * 1024)

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.sampled = max(self.sampled, _status_kb("VmRSS") * 1024)
        self.growth = self.sampled - self.before
        return False


def _near_tie_rule(label: str, got, want, prob) -> int:
    """Predictions equal but on rows whose top-two probability margin is
    under 1e-5; returns the near-tie rows that differ."""
    top2 = np.sort(np.asarray(prob), axis=1)[:, -2:]
    near = (top2[:, 1] - top2[:, 0]) < 1e-5
    diff = np.asarray(got) != np.asarray(want)
    check(not (diff & ~near).any(),
          f"{label}: {int((diff & ~near).sum())} predictions differ off "
          f"a near tie")
    return int((diff & near).sum())


def fused_slice(dev, smi: str, model255=None, out255=None,
                test_t=None) -> dict:
    """Phase 13: fused and streamed pipelines on the card — bench.py's
    bench_pipeline and bench_ooc at their own sizes, the LM fused and
    fitted from a chunk stream, the fused scorer, the fused forest.
    Returns the phase's flash launches: {"f32": forward launches of the
    fused LM transform, "bf16": each kernel's launches over the streamed
    LM fit}."""
    import gc
    import torch

    from mmlspark_tpu_torch import profile_pipeline as PP
    from mmlspark_tpu_torch.core import metrics as MC
    from mmlspark_tpu_torch.core.fusion import fuse
    from mmlspark_tpu_torch.core.stage import PipelineModel
    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.io.ooc import ChunkedTable, table_nbytes
    from mmlspark_tpu_torch.models.learner import TPULearner
    from mmlspark_tpu_torch.models.networks import build_network
    from mmlspark_tpu_torch.models.tpu_model import TPUModel
    from mmlspark_tpu_torch.ops import flash_attention as FA
    from mmlspark_tpu_torch.profile_train import BATCH, slice_table
    from mmlspark_tpu_torch.profile_transform import (
        BATCH as LM_BATCH, LM_SPEC, ROWS as LM_ROWS)
    from mmlspark_tpu_torch.serving import json_scoring_pipeline, serve_model
    from mmlspark_tpu_torch.stages.dataprep import SummarizeData

    t_phase = time.perf_counter()

    # ---- (a) bench_pipeline: 1M raw rows three ways ----------------------
    t0 = time.perf_counter()
    table = PP.pipeline_table()
    make_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pm = PP.pipeline_stages().fit(table.slice(0, PP.PIPELINE_FIT_N))
    fit_s = time.perf_counter() - t0
    fused = pm.fused()
    warm = table.slice(0, 4096)
    pm.transform(warm)
    fused.transform(warm)
    fused.transform_staged(warm)
    fused.transform(PP.fresh_view(table))   # the 1M-row shape's first run
    host_s, out_h = PP.best_of(lambda: pm.transform(PP.fresh_view(table)),
                               2)
    staged_s, out_d = PP.best_of(
        lambda: fused.transform_staged(PP.fresh_view(table)), 2)
    misses = fused.jit_cache_misses
    cold_s, out_f = PP.best_of(lambda: fused.transform(PP.fresh_view(table)),
                               2)
    plan = fused.plan_for(table.schema)
    fused.transform(table)
    ships = plan.device_table.stats()["column_ships"]
    warm_s, _ = PP.best_of(lambda: fused.transform(table), 3)
    check(fused.jit_cache_misses == misses,
          f"(a) fused repeats met {fused.jit_cache_misses - misses} new "
          "shapes")
    check(plan.device_table.stats()["column_ships"] == ships,
          "(a) warm repeats shipped a column again")
    check(plan.last_roundtrips == 1,
          f"(a) {plan.last_roundtrips} device round trips a transform")
    check(len(plan.segments) == 1 and len(plan.segments[0].ops) == 3,
          f"(a) Featurize, the scaler and the head are not one fused "
          f"segment: {plan.describe()}")
    cols = ("rawPrediction", "probability", "prediction")
    for c in cols:
        check(np.array_equal(np.asarray(out_f[c]), np.asarray(out_d[c])),
              f"(a) fused {c} differs from transform_staged")
    flips = _near_tie_rule("(a) fused vs staged_host", out_f["prediction"],
                           out_h["prediction"], out_h["probability"])
    p_err = float(np.abs(np.asarray(out_f["probability"])
                         - np.asarray(out_h["probability"])).max())
    check(p_err <= 1e-5, f"(a) fused probabilities {p_err} from the host's")
    # the busy share comes from a fresh interpreter: after phases 1-12
    # torch.profiler recorded no device activity in this process
    root = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, "-c", PROFILE_WARM], cwd=root,
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": root})
    check(r.returncode == 0, f"(a) the profiled warm transform failed: "
          f"{r.stderr[-2000:]}")
    busy = json.loads(r.stdout.strip().splitlines()[-1])
    check(busy["d2h_copies"] == 1 and busy["busy_us"] > 0,
          f"(a) the profiled warm fused transform: {busy}")
    print(f"fused (a) bench_pipeline: {len(table)} raw rows (made in "
          f"{make_s:.1f} s), fit on {PP.PIPELINE_FIT_N} in {fit_s:.3f} s; "
          f"plan {plan.describe()}; staged_host {host_s:.3f} s, "
          f"staged_device {staged_s:.3f} s, fused cold {cold_s:.3f} s, "
          f"warm {warm_s:.6f} s; fused == staged_device bitwise, "
          f"predictions == staged_host ({flips} near-tie flips), max "
          f"|prob diff| {p_err:.3e}; 0 new shapes, no column re-shipped")
    print(f"fused (a) warm transform of {busy['rows']} rows profiled in a "
          f"fresh process: window {busy['window_us'] / 1e3:.3f} ms, busy "
          f"{busy['busy_us'] / 1e3:.3f} ms ({100 * (1 - busy['idle_share']):.1f}"
          f" %), {busy['d2h_copies']} device-to-host copy; top kernels "
          f"{busy['top']}")
    del out_h, out_d, out_f, warm
    gc.collect()

    # ---- (e) the fused scorer over (a)'s fitted pipeline -----------------
    rows = table.slice(0, FUSED_REQUESTS)
    want = fused.transform(rows)
    bodies = [json.dumps({"x1": float(rows["x1"][i]),
                          "x2": float(rows["x2"][i]),
                          "color": rows["color"][i],
                          "toks": rows["toks"][i]}).encode()
              for i in range(FUSED_REQUESTS)]
    scorer = json_scoring_pipeline(pm, batch_size=256)
    t0 = time.perf_counter()
    warmed = scorer.warmup(DataTable({c: rows[c][:1] for c in
                                      ("x1", "x2", "color", "toks")}))
    warm_e = time.perf_counter() - t0
    sc = scorer.scorer
    m0 = sc.fused.jit_cache_misses
    trips0, batches0 = sc.device_roundtrips, sc.batches_scored
    engine = serve_model(scorer, port=0, batch_size=256, workers=2,
                         max_wait_ms=5)
    try:
        replies, _ = served(engine, "fused (e) json_scoring_pipeline(pm)",
                         bodies, 16)
    finally:
        engine.stop()
    got = np.asarray([r["prediction"] for r in replies], np.float64)
    flips_e = _near_tie_rule("(e) replies vs fused transform", got,
                             want["prediction"], want["probability"])
    trips = sc.device_roundtrips - trips0
    batches = sc.batches_scored - batches0
    check(trips == batches > 0,
          f"(e) {trips} device round trips over {batches} batches")
    check(sc.fused.jit_cache_misses == m0,
          "(e) serving met a shape warmup had not run")
    print(f"fused (e): warmup ran {warmed} buckets in {warm_e:.3f} s; "
          f"every reply equals the fused transform of its row "
          f"({flips_e} near-tie flips); {trips / batches:.2f} "
          f"device-to-host copies a batch over {batches} batches")
    del pm, fused, table, rows, want, scorer, engine
    gc.collect()

    # ---- (b) bench_ooc: 4M rows streamed under a 1.5 GB budget -----------
    ooc, fz_s = PP.ooc_pipeline(rows=OOC_STREAM_ROWS)
    chunk0 = PP.ooc_chunk(0, PP.OOC_CHUNK)
    ooc_plan = ooc.plan_for(chunk0.schema)
    check(len(ooc_plan.steps) == 1 and len(ooc_plan.segments[0].ops) == 3,
          f"(b) the streamed plan is not one fused segment: "
          f"{ooc_plan.describe()}")
    for h in MC.ooc_histograms().values():
        h.reset()
    gc.collect()
    src = PP.ooc_source(rows=OOC_STREAM_ROWS)
    rows_seen, pred_sum, first = 0, 0.0, None
    with RssPeak() as rss:
        t0, cpu0 = time.perf_counter(), time.process_time()
        for out in ooc.transform_chunked(src):
            p = np.asarray(out["prediction"])
            if first is None:
                first = p.copy()
            rows_seen += len(p)
            pred_sum += float(p.sum())
            del out, p
        streamed_s = time.perf_counter() - t0
        cpu_s = time.process_time() - cpu0
    check(rows_seen == OOC_STREAM_ROWS, f"(b) streamed {rows_seen} rows")
    tracked = src.stats.tracked_peak_bytes()
    check(tracked < PP.OOC_BUDGET_BYTES,
          f"(b) streamed tracked bytes {tracked} over the budget")
    check(rss.growth < PP.OOC_BUDGET_BYTES,
          f"(b) streamed RSS growth {rss.growth} over the budget")
    check(np.array_equal(first, np.asarray(
        ooc.transform(chunk0)["prediction"])),
        "(b) the first chunk's streamed predictions differ from its fused "
        "transform")
    ph = {k: h.snapshot() for k, h in MC.ooc_histograms().items()}
    worker_s = (ph["decode"]["sum"] + ph["prepare"]["sum"]) / 1e3
    consumer_s = ph["dispatch"]["sum"] / 1e3
    overlap = 0.0
    if min(worker_s, consumer_s) > 0:
        overlap = max(0.0, min(1.0, (worker_s + consumer_s - streamed_s)
                               / min(worker_s, consumer_s)))
    hidden = (max(0.0, min(1.0, 1.0 - ph["wait"]["sum"]
                           / ph["decode"]["sum"]))
              if ph["decode"]["sum"] > 0 else 0.0)
    gc.collect()
    with RssPeak() as rss_m:
        t0 = time.perf_counter()
        mat = PP.ooc_source(rows=OOC_STREAM_ROWS, depth=0).materialize()
        scored = ooc.transform(mat)
        mat_s = time.perf_counter() - t0
    mat_pred = np.asarray(scored["prediction"])
    mat_tracked = table_nbytes(mat) + sum(
        np.asarray(scored[c]).nbytes for c in scored.column_names
        if c not in mat.column_names)
    check(mat_tracked > PP.OOC_BUDGET_BYTES,
          f"(b) the materialized path fit the budget: {mat_tracked}")
    check(rss_m.growth > PP.OOC_BUDGET_BYTES,
          f"(b) the materialized RSS growth {rss_m.growth} is under the "
          "budget")
    sum_diff = abs(float(mat_pred.sum()) - pred_sum)
    check(sum_diff < 1e-6 * OOC_STREAM_ROWS,
          f"(b) prediction sums differ by {sum_diff}")
    del mat, scored, mat_pred
    gc.collect()
    print(f"fused (b) bench_ooc: streamed Featurize fit {fz_s:.3f} s; "
          f"{OOC_STREAM_ROWS} rows in chunks of {PP.OOC_CHUNK}, prefetch "
          f"{PP.OOC_PREFETCH}: streamed {streamed_s:.3f} s, tracked peak "
          f"{tracked / 1e9:.3f} GB, RSS growth {rss.growth / 1e9:.3f} GB "
          f"(sampled every 5 ms; budget "
          f"{PP.OOC_BUDGET_BYTES / 1e9:.1f} GB); materialized "
          f"{mat_s:.3f} s, tracked {mat_tracked / 1e9:.3f} GB, RSS growth "
          f"{rss_m.growth / 1e9:.3f} GB; first chunk bitwise its own "
          f"transform, prediction sums {pred_sum:.0f} (diff {sum_diff:.0f})")
    print(f"fused (b) phases (s): decode {ph['decode']['sum'] / 1e3:.3f}, "
          f"prepare {ph['prepare']['sum'] / 1e3:.3f}, wait "
          f"{ph['wait']['sum'] / 1e3:.3f}, dispatch {consumer_s:.3f}; "
          f"overlap fraction {overlap:.3f}, decode hidden {hidden:.3f}; "
          f"process CPU {cpu_s:.3f} s over the {streamed_s:.3f} s wall "
          f"({cpu_s / streamed_s:.2f} cores)")
    summ = PP.ooc_source(rows=SUMMARY_ROWS)
    t0 = time.perf_counter()
    chunked_sum = SummarizeData().transform(summ)
    sum_c_s = time.perf_counter() - t0
    mat = PP.ooc_source(rows=SUMMARY_ROWS, depth=0).materialize()
    t0 = time.perf_counter()
    exact = SummarizeData().transform(mat)
    sum_e_s = time.perf_counter() - t0
    for name in ("a", "b"):
        i = list(exact["Feature"]).index(name)
        for k in ("Count", "Mean", "Min", "Max", "Sample_Variance",
                  "Sample_Skewness", "Sample_Kurtosis",
                  "Unique_Value_Count", "Missing_Value_Count"):
            a, b = float(exact[k][i]), float(chunked_sum[k][i])
            check(abs(a - b) <= 1e-6 * (1.0 + abs(a)),
                  f"(b) SummarizeData {name} {k}: {b} vs {a}")
        xs = np.sort(np.asarray(mat[name], np.float64))
        xs = xs[np.isfinite(xs)]
        for label, q in (("Median", 0.5), ("P25", 0.25), ("P75", 0.75),
                         ("P5", 0.05), ("P95", 0.95)):
            v = float(chunked_sum[label][i])
            rank = np.searchsorted(xs, v, side="right") / len(xs)
            check(abs(rank - q) < 0.005,
                  f"(b) SummarizeData {name} {label} at rank {rank}")
    print(f"fused (b) SummarizeData on {SUMMARY_ROWS} rows: chunked "
          f"{sum_c_s:.3f} s, materialized {sum_e_s:.3f} s; counts and "
          "moments within 1e-6, sketch percentiles within 0.005 in rank")
    del mat, exact, chunked_sum, ooc
    gc.collect()

    # ---- (c) the LM as a one-stage fused pipeline -------------------------
    lm = build_network(LM_SPEC, device="cuda", seed=0)
    tokens = np.random.default_rng(7).integers(
        0, LM_SPEC["vocab_size"], size=(LM_ROWS, LM_SPEC["max_len"]))
    lm_t = DataTable({"tokens": tokens})
    model = TPUModel.from_module(lm, device="cuda", inputCol="tokens",
                                 outputCol="logits", batchSize=LM_BATCH)
    ref = model.transform(lm_t)["logits"]
    lm_fused = PipelineModel(stages=[model]).fused(batch_size=8)
    lm_fused.transform(lm_t)   # its first run
    lm_plan = lm_fused.plan_for(lm_t.schema)
    torch.cuda.synchronize()
    FA.reset_launches()
    t0 = time.perf_counter()
    got = lm_fused.transform(lm_t)["logits"]
    lm_s = time.perf_counter() - t0
    f32_launches = FA.LAUNCHES["_fwd_kernel"]
    check(f32_launches == LM_SPEC["depth"] * -(-LM_ROWS // LM_BATCH),
          f"(c) the fused LM launched flash_fwd {f32_launches} times")
    check(len(lm_plan.steps) == 1 and len(lm_plan.segments) == 1
          and lm_plan.last_roundtrips == 1,
          f"(c) the LM did not run as one fused segment: plan "
          f"{lm_plan.describe()}, {lm_plan.last_roundtrips} round trips")
    check(got.shape == ref.shape and np.array_equal(got, ref),
          f"(c) fused logits differ from phase 4's transform: max |diff| "
          f"{float(np.abs(got - ref).max()) if got.shape == ref.shape else got.shape}")
    print(f"fused (c) LM_SPEC as a one-stage PipelineModel, fused(batch_"
          f"size=8): {LM_ROWS} x {LM_SPEC['max_len']} tokens in "
          f"{lm_s:.3f} s, plan {lm_plan.describe()}, flash_fwd_tf32x3 "
          f"launches {f32_launches}, logits bitwise TPUModel.transform's")
    del lm, model, lm_fused, ref, got
    torch.cuda.empty_cache()

    # ---- (d) the LM fitted from a .npy chunk stream ----------------------
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_fused")
    os.makedirs(work, exist_ok=True)
    lm_rows = 32
    lt = slice_table(lm_rows)
    paths = {}
    for c in ("features", "label"):
        paths[c] = os.path.join(work, f"{c}.npy")
        np.save(paths[c], np.asarray(lt[c]))
    stream = ChunkedTable.from_npy(paths, chunk_rows=LM_STREAM_CHUNK)
    check(stream.num_rows == lm_rows,
          f"(d) from_npy read {stream.num_rows} rows from the headers")

    def lm_learner():
        return TPULearner(networkSpec=LM_SPEC, loss="token_cross_entropy",
                          optimizer="adamw", learningRate=1e-3,
                          batchSize=BATCH, computeDtype="bfloat16",
                          epochs=2, logEvery=1)

    streamed = lm_learner()
    FA.reset_launches()
    t0 = time.perf_counter()
    streamed.fit(stream)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    bf16_launches = dict(FA.LAUNCHES)
    want_l = LM_SPEC["depth"] * 2 * lm_rows // BATCH
    check(all(v == want_l for v in bf16_launches.values()),
          f"(d) the streamed fit launched {bf16_launches}, not {want_l} "
          "each")
    decoded = stream.stats.snapshot()["chunks"]
    check(decoded == 2 * lm_rows // LM_STREAM_CHUNK,
          f"(d) the stream decoded {decoded} chunks over 2 epochs")
    listed = lm_learner()
    listed.fit([lt.slice(i, i + LM_STREAM_CHUNK)
                for i in range(0, lm_rows, LM_STREAM_CHUNK)])
    l_s = [h["loss"] for h in streamed.history]
    l_l = [h["loss"] for h in listed.history]
    check(len(l_s) == 2 * lm_rows // BATCH and l_s == l_l,
          f"(d) streamed losses {l_s} vs the shard list's {l_l}")
    print(f"fused (d) LM fit from ChunkedTable.from_npy (chunks of "
          f"{LM_STREAM_CHUNK}, 2 epochs, bf16): {stream_s:.3f} s, flash "
          f"launches {bf16_launches}, {decoded} chunks decoded (no "
          f"counting pass), losses bitwise the shard list's: "
          f"{[round(x, 4) for x in l_s]}")
    del streamed, listed
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- (f) phase 3's forest as a one-stage fused pipeline ---------------
    if model255 is not None:
        fz255 = fuse([model255], batch_size=256)
        t0 = time.perf_counter()
        fout = fz255.transform(test_t)
        torch.cuda.synchronize()
        f_s = time.perf_counter() - t0
        f_plan = fz255.plan_for(test_t.schema)
        check(len(f_plan.steps) == 1 and len(f_plan.segments) == 1
              and f_plan.last_roundtrips == 1,
              f"(f) the forest did not run as one fused segment: plan "
              f"{f_plan.describe()}, {f_plan.last_roundtrips} round trips")
        for c in ("rawPrediction", "prediction"):
            check(np.array_equal(np.asarray(fout[c]), np.asarray(out255[c])),
                  f"(f) fused forest {c} differs from phase 3's transform")
        p_err = float(np.abs(np.asarray(fout["probability"])
                             - np.asarray(out255["probability"])).max())
        check(p_err <= 1e-6, f"(f) fused forest probabilities {p_err} off")
        print(f"fused (f) phase 3's max_bin 255 forest fused over "
              f"{len(test_t)} holdout rows as {f_plan.describe()}: "
              f"{f_s:.3f} s, rawPrediction and "
              f"prediction bitwise phase 3's, max |prob diff| {p_err:.2e}")
    print(f"fused: phase 13 took {time.perf_counter() - t_phase:.1f} s; "
          f"card: {smi}")
    return {"f32": f32_launches, "bf16": bf16_launches}


class _LoggingScorer:
    """A served scorer that logs one line per batch from inside the
    worker's ``device`` span (phase 14(c)'s check of trace-correlated
    logs); otherwise the scorer it wraps."""

    def __init__(self, scorer):
        from mmlspark_tpu_torch.core.logging_utils import get_logger
        self.scorer = scorer
        self.log = get_logger("chip_smoke")

    def prepare_batch(self, table):
        return self.scorer.prepare_batch(table)

    def execute_prepared(self, table, prepped):
        self.log.info("phase 14 batch of %d rows", len(table))
        return self.scorer.execute_prepared(table, prepped)

    def transform(self, table):
        return self.scorer.transform(table)


def _http(url: str):
    import urllib.request
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def telemetry_slice(smi: str, model255, out255, Xte) -> dict:
    """Phase 14: the telemetry on the card. (a) and (b) run in a fresh
    interpreter (``profile_telemetry``, where the profiler sees the
    card); (c) serving with telemetry on and off, (d) an SLO the card
    cannot meet. Returns the hist launches of (a)'s profiled fit (by
    route) and the flash launches of (b)'s fit."""
    import torch
    from mmlspark_tpu_torch.core import trace as T
    from mmlspark_tpu_torch.core.flightrecorder import (
        FlightRecorder, get_recorder)
    from mmlspark_tpu_torch.core.slo import SLO, BurnRateRule, SLOMonitor
    from mmlspark_tpu_torch.profile_telemetry import onoff_turns
    from mmlspark_tpu_torch.serving import json_scoring_pipeline, serve_model
    from mmlspark_tpu_torch.testing import metrics_check as CHK

    # ---- (a), (b): the traced GBDT fit and bench_lm fit, profiled --------
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        "mmlspark_tpu_torch.profile_telemetry"], cwd=root,
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": root})
    check(r.returncode == 0, "(a)/(b) profile_telemetry failed: "
          f"{r.stdout[-1500:]} {r.stderr[-2500:]}")
    prof = json.loads(r.stdout.strip().splitlines()[-1])
    g, sv, lm = prof["gbdt"], prof["serving"], prof["lm"]
    for line in r.stdout.strip().splitlines()[:-1]:
        print(f"telemetry (a)-(b) {line}")
    print(f"telemetry (a) GBDT 1M x 28, 63 leaves, max_bin 255, 5 rounds, "
          f"in a fresh process ({time.perf_counter() - t0:.1f} s in all): "
          f"fit s with the process tracer on {g['fit_s_tracer_on']}, off "
          f"{g['fit_s_tracer_off']}: gap {g['fit_gap_s']:+.4f} s "
          f"({g['fit_gap_pct']:+.2f} %); spans {g['spans']}; boost_chunk "
          f"spans sum {g['boost_chunks_sum_s']:.4f} s against "
          f"train_timing boost {g['boost_s']:.3f} s; histograms rose "
          f"{g['histogram_rises']}; {g['launches']} hist launches, "
          f"{g['profile_hist_partial']} hist_partial in the profile; every "
          f"hist kernel inside a boost span on the merged timeline (worst "
          f"{g['kernel_outside_boost_us']:.2f} us outside, marker "
          f"+-{g['marker_half_width_us']:.2f} us); hist device "
          f"{g['hist_device_ms']:.3f} ms")
    print(f"telemetry (a) served batches ({sv['requests']} requests "
          f"from 16 client threads of a second process, twice, replies "
          f"equal transform's): device span "
          f"{sv['device_span_ms_mean_unprofiled']:.4f} ms "
          f"({sv['rows_mean_unprofiled']:.1f} rows) without the "
          f"profiler; under it {sv['device_spans']} device spans of "
          f"{sv['rows_mean']:.1f} rows: span {sv['device_span_ms_mean']:.4f}"
          f" ms, card work launched inside {sv['device_time_ms_mean']:.4f} "
          f"ms ({100 * sv['device_share_of_span']:.2f} % of the span)")
    print(f"telemetry (b) bench_lm bf16 fit: {lm['steps']} learner.step "
          f"spans, mean after the first "
          f"{lm['step_span_ms_mean_after_first_unprofiled']:.3f} ms "
          f"without the profiler, "
          f"{lm['step_span_ms_mean_after_first']:.3f} ms under it, "
          f"against {lm['step_device_ms_mean_after_first']:.3f} ms of "
          f"card time launched inside them (per step "
          f"{[round(x, 2) for x in lm['step_device_ms']]}); memory samples "
          f"{[(m['step'], m['bytes_in_use']) for m in lm['memory_samples']]}"
          f"; flash launches {lm['launches']}; root {lm['root']}")

    # ---- (c) serving with telemetry on and off --------------------------
    pred = np.asarray(out255["prediction"])
    n = 2000
    bodies = [json.dumps({"features": Xte[i].tolist()}).encode()
              for i in range(n)]
    tids = [f"c0ffee{i:026x}" for i in range(n)]
    parents = {t: f"{i + 1:016x}" for i, t in enumerate(tids)}
    tps = [f"00-{t}-{parents[t]}-01" for t in tids]
    tracer = T.get_tracer()
    tracer.buffer.clear()
    scorer = json_scoring_pipeline(model255)
    seen: dict = {}

    def inspect(engine, mode, replies):
        """Each turn: replies equal transform's. The first turn (on):
        the telemetry checks, on its still-running engine."""
        bad = [i for i, rep in enumerate(replies)
               if rep != {"prediction": int(pred[i])}]
        check(not bad, f"(c) {mode}: {len(bad)} replies differ from "
              "transform")
        if seen:
            return
        check(mode == "on" and engine.tracer is tracer
              and engine.slo is not None
              and engine.flight_recorder is get_recorder(),
              "(c) the engine's telemetry is not on by default")
        addr = engine.source.address
        status, _, raw = _http(addr + "/debug/traces")
        chrome = json.loads(raw)
        xs = [e for e in chrome["traceEvents"] if e["ph"] == "X"]
        check(status == 200 and xs and all(
            isinstance(e["name"], str) and e["ts"] >= 0 and e["dur"] >= 0
            and isinstance(e["pid"], int) and isinstance(e["tid"], int)
            for e in xs), "(c) /debug/traces is not valid chrome JSON")
        traces = [t for t in tracer.buffer.traces()
                  if t.root.name == "request"]
        check(traces and all(t.trace_id in parents and t.root.parent_id
                             == parents[t.trace_id] for t in traces),
              "(c) a request's trace id or parent is not its client's")
        check(all(any(s.name == "queue_wait"
                      and s.parent_id == t.root.span_id
                      for s in t.spans()) for t in traces),
              "(c) a request root has no queue_wait under it")
        members: dict = {}
        for t in traces:
            for sp in t.spans():
                if sp.name == "device":
                    members.setdefault(sp.span_id, (sp, set()))[1].add(
                        (t.trace_id, t.root.span_id))
        check(members and all(mem <= set(sp.links) and len(sp.links)
                              == sp.attrs["rows"]
                              for sp, mem in members.values()),
              "(c) a device span does not link the roots it served")
        status, ctype, raw = _http(addr + "/metrics")
        text = raw.decode()
        violations = CHK.audit_text(text)
        check(status == 200 and ctype.startswith("text/plain")
              and not violations, f"(c) /metrics audit: {violations[:5]}")
        mem = re.search(r"^device_memory_bytes_in_use (\S+)$", text, re.M)
        for fam in ("serving_slo_burn_rate", "serving_slo_latency_p99_ms",
                    "gbdt_train_phase_ms", "trace_buffer_traces",
                    "device_memory_bytes_limit"):
            check(f"# TYPE {fam} " in text, f"(c) /metrics lacks {fam}")
        check(mem is not None and float(mem.group(1)) > 0,
              "(c) device_memory_bytes_in_use is not above 0")
        _, _, raw = _http(addr + "/healthz")
        health = json.loads(raw)
        check("slo" in health and health["slo"]["requests_1h"] >= n,
              f"(c) /healthz slo section {health.get('slo')}")
        # a log line from inside a request's device span carries its id
        engine.pipeline = _LoggingScorer(scorer)
        tp = "00-5ca1ab1e0000000000000000000000aa-00000000000000bb-01"
        import urllib.request
        req = urllib.request.Request(addr, data=bodies[0], headers={
            "Content-Type": "application/json", "traceparent": tp})
        with urllib.request.urlopen(req, timeout=60) as resp:
            check(resp.headers["X-Trace-Id"]
                  == "5ca1ab1e0000000000000000000000aa",
                  "(c) the reply's X-Trace-Id is not the caller's")
        logs = [rec for rec in get_recorder().dump_bundle("check")["logs"]
                if rec["msg"] == "phase 14 batch of 1 rows"]
        check(logs and logs[-1].get("trace_id")
              == "5ca1ab1e0000000000000000000000aa",
              f"(c) the log line inside the request carries {logs[-1:]}")
        seen.update(traces=len(traces), devices=len(members),
                    families=text.count("# TYPE "),
                    bytes_in_use=float(mem.group(1)),
                    slo_samples=health["slo"]["requests_1h"])

    onoff = onoff_turns(scorer, bodies, tps, 2, inspect)
    for k, r in enumerate(onoff["turns"]):
        print(f"telemetry (c) turn {k + 1}, telemetry {r['mode']}: "
              f"{r['rps']:.1f} requests/s, p50 {r['p50_ms']:.3f} ms, p99 "
              f"{r['p99_ms']:.3f} ms, pipeline p50 {r['pipeline_p50_ms']} "
              f"ms, {r['rows_per_batch']:.2f} rows a batch")
    med = onoff["median"]
    print(f"telemetry (c): 2 turns (on, off), medians: on "
          f"{med['on']['rps']:.1f} requests/s, p50 {med['on']['p50_ms']:.3f}"
          f" ms, p99 {med['on']['p99_ms']:.3f} ms; off "
          f"{med['off']['rps']:.1f} requests/s, p50 "
          f"{med['off']['p50_ms']:.3f} ms, p99 {med['off']['p99_ms']:.3f} "
          f"ms; on / off: requests/s {onoff['rps_ratio']:.4f}, p50 "
          f"{onoff['p50_ms_ratio']:.4f}, p99 {onoff['p99_ms_ratio']:.4f} "
          f"(one turn a mode does not resolve a cost below the turns' "
          f"spread; profile_telemetry --turns 12 runs more); first turn: "
          f"{seen['traces']} traces and {seen['devices']} device spans "
          f"checked, {seen['slo_samples']:.0f} SLO samples; /metrics "
          f"{seen['families']} families, 0 audit violations, "
          f"device_memory_bytes_in_use {seen['bytes_in_use']:.0f}; a log "
          f"line inside a request carried its trace id")

    # ---- (d) an SLO the card cannot meet --------------------------------
    mon = SLOMonitor(
        slos=[SLO("latency_1us", "latency", target=0.99,
                  latency_threshold_ms=0.001)],
        rules=[BurnRateRule("fast_burn", 60.0, 5.0, 14.4, min_events=10)],
        windows=(5.0, 60.0), horizon_s=120.0)
    rec = FlightRecorder(min_interval_s=60.0)
    engine = serve_model(scorer, port=0, batch_size=256, workers=2,
                         max_wait_ms=5, slo=mon, flight_recorder=rec,
                         slo_eval_interval_s=0.1)
    try:
        served(engine, "telemetry (d) GBDT, a 1 us latency SLO",
               bodies[:200], 16)
        deadline = time.monotonic() + 30
        while not rec.bundles and time.monotonic() < deadline:
            time.sleep(0.05)
        check(mon.alerts.stats()["fired_total"] >= 1,
              "(d) the 1 us objective did not fire")
        check(len(rec.bundles) == 1, f"(d) {len(rec.bundles)} bundles")
        bundle = rec.bundles[0]
        st = bundle["slo"][f"engine@{engine.source.address}"]["status"]
        check(bundle["reason"] == "slo_breach:latency_1us:fast_burn"
              and any(e["name"] == "request"
                      for e in bundle["traces"]["traceEvents"])
              and any("SLO alert FIRED" in x["msg"]
                      for x in bundle["logs"])
              and st["active_alerts"][0]["name"]
              == "latency_1us:fast_burn",
              f"(d) the bundle lacks traces, the log ring or the status: "
              f"{bundle['reason']}, {st['active_alerts']}")
        json.dumps(bundle)
    finally:
        engine.stop()
    check(mon.on_fire is None and rec.stats()["tracers"] == 0
          and rec.stats()["slos"] == [],
          f"(d) stop() left hooks: on_fire {mon.on_fire}, {rec.stats()}")
    rec.close()
    print(f"telemetry (d): the 1 us objective fired "
          f"({mon.alerts.stats()}) after 200 requests; one bundle "
          f"({len(bundle['traces']['traceEvents'])} trace events, "
          f"{len(bundle['logs'])} log records, burn "
          f"{st['active_alerts'][0]['burn_short']}x); stop() left no hook; "
          f"card: {smi}")
    torch.cuda.empty_cache()
    return {"hist": g["hist_launches"], "flash": lm["launches"]}


# ---------------------------------------------------------------------------
# phase 15: model lifecycle and the client fleet
# ---------------------------------------------------------------------------

# phase 15(b)'s one-row requests, cut from 4,000 for the script's time
# limit; (c), (d) and the one-engine run take a fraction of them
LIFECYCLE_REQUESTS = 3000
LIFECYCLE_CLIENTS = 16      # client threads of the spawned process
LIFECYCLE_ROWS = 2000       # distinct holdout rows the requests carry
NEAR_TIE = 1e-4             # |raw score| under which a walk may round
#                             either way (a one-row walk sums its trees
#                             in another order than a batch)


def _windows(records, t_swap0: float, t_swap1: float) -> dict:
    """requests/s and client p50 / p99 (ms) of the requests answered
    before the swap began, sent and answered during it, and sent after
    it returned."""
    return {name: _lat_numbers([r for r in records if keep(r)])
            for name, keep in (
                ("before", lambda r: r[3] < t_swap0),
                ("during", lambda r: r[2] >= t_swap0 and r[3] <= t_swap1),
                ("after", lambda r: r[2] > t_swap1))}


def _lat_numbers(records) -> dict:
    """requests, requests/s and client p50 / p99 (ms) of spawned-client
    records ``(i, reply, t_sent, t_answered, error)``."""
    if len(records) < 2:
        return {"n": len(records)}
    lat = np.sort(np.asarray([r[3] - r[2] for r in records])) * 1e3
    span = max(r[3] for r in records) - min(r[2] for r in records)
    return {"n": len(records), "rps": len(records) / span,
            "p50_ms": float(lat[int(0.5 * (len(lat) - 1))]),
            "p99_ms": float(lat[int(0.99 * (len(lat) - 1))])}


def _state_times(engines, stop) -> list:
    """Sample each engine's swap_state every millisecond until ``stop``;
    returns per engine {state: seconds seen}."""
    seen = [dict() for _ in engines]
    last = [(e.swap_state, time.monotonic()) for e in engines]
    while not stop.is_set():
        now = time.monotonic()
        for k, e in enumerate(engines):
            st = e.swap_state
            prev, t_prev = last[k]
            if st != prev:
                seen[k][prev] = seen[k].get(prev, 0.0) + now - t_prev
                last[k] = (st, now)
        time.sleep(0.001)
    now = time.monotonic()
    for k, (st, t_prev) in enumerate(last):
        seen[k][st] = seen[k].get(st, 0.0) + now - t_prev
    return seen


def lifecycle_slice(dev, smi: str, model255, Xtr, ytr, Xte, yte,
                    auc255: float) -> dict:
    """Phase 15: (a) phase 3's max_bin 255 model (v1) refreshed by
    ``boost_more(5)`` on its training table through the hist kernel;
    (b) a 3-engine ``ServingFleet`` of v1 on the card, driven by a
    spawned client process through ``ServingFleet.connect``, swapped to
    v2 by ``rolling_swap`` mid-load; (c) a poisoned v2 rolled back on
    the first engine with every client reply served by v1; (d) an
    engine killed mid-load; (e) one request's trace across the client
    and the engine process. Returns the hist launches of (a) by
    route."""
    import torch
    from mmlspark_tpu_torch.core.flightrecorder import FlightRecorder
    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.core.trace import Tracer, merge_chrome_traces
    from mmlspark_tpu_torch.gbdt import hist_kernels as HK
    from mmlspark_tpu_torch.gbdt.estimators import (
        TPUBoostClassificationModel)
    from mmlspark_tpu_torch.serving import (
        CanaryPolicy, ServingFleet, json_scoring_pipeline)
    from mmlspark_tpu_torch.testing.chaos import FaultInjector, PoisonedModel
    from mmlspark_tpu_torch.testing.fleet_load import FleetLoad
    from mmlspark_tpu_torch.utils.resilience import CircuitBreaker

    t_phase = time.perf_counter()
    # ---- (a) refresh on the card -----------------------------------------
    v1_booster = model255.get_booster()
    HK.reset_launches()
    t0 = time.perf_counter()
    b2 = v1_booster.boost_more(5, Xtr, ytr)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    launches = dict(HK.LAUNCHES)
    hists = b2.train_info["histograms"]
    want = hists if dev.type == "cuda" else 0
    check(launches["_hist_kernel_nibble"] == want
          and sum(launches.values()) == want and hists >= 5,
          f"(a) boost_more launched {launches} for {hists} histograms")
    check(b2.num_trees == v1_booster.num_trees + 5,
          f"(a) {b2.num_trees} trees after boost_more(5)")
    v2 = TPUBoostClassificationModel(
        modelString=b2.model_to_string(), numClasses=2, device=dev.type)
    v2._booster = b2
    test_t = DataTable({"features": Xte})
    out1, out2 = model255.transform(test_t), v2.transform(test_t)
    auc2 = auc(yte, np.asarray(out2["probability"])[:, 1])
    check(auc2 >= auc255 - 0.005,
          f"(a) refreshed AUC {auc2:.5f} < v1's {auc255:.5f} - 0.005")
    print(f"lifecycle (a): boost_more(5) of phase 3's max_bin 255 model on "
          f"its {len(Xtr)} training rows in {refresh_s:.2f} s "
          f"({b2.train_timing}); {hists} histograms, hist launches "
          f"{launches}; holdout AUC v1 {auc255:.5f} -> v2 {auc2:.5f}")

    # the requests' rows: the holdout rows where v1 and v2 predict
    # apart first (they tell the versions apart), then others; rows
    # whose raw score sits within NEAR_TIE of 0 in either are left out
    raw1 = np.asarray(out1["rawPrediction"])[:, 1]
    raw2 = np.asarray(out2["rawPrediction"])[:, 1]
    p1 = np.asarray(out1["prediction"]).astype(int)
    p2 = np.asarray(out2["prediction"]).astype(int)
    clear = (np.abs(raw1) > NEAR_TIE) & (np.abs(raw2) > NEAR_TIE)
    differ = np.nonzero(clear & (p1 != p2))[0]
    same = np.nonzero(clear & (p1 == p2))[0]
    rows = np.concatenate([differ[:LIFECYCLE_ROWS // 2],
                           same[:LIFECYCLE_ROWS - min(
                               len(differ), LIFECYCLE_ROWS // 2)]])
    n_differ = min(len(differ), LIFECYCLE_ROWS // 2)
    want1, want2 = p1[rows], p2[rows]
    rng = np.random.default_rng(15)
    order = rng.integers(0, len(rows), LIFECYCLE_REQUESTS)

    tracer = Tracer(enabled=True)
    rec = FlightRecorder(min_interval_s=0.0)
    fleet = ServingFleet(json_scoring_pipeline(model255), n_engines=3,
                         base_port=0, batch_size=256, workers=2,
                         max_wait_ms=5, version="v1", tracer=tracer,
                         flight_recorder=rec, failure_threshold=2,
                         breaker_cooldown=60.0)
    load = None
    single = None
    try:
        load = FleetLoad(fleet.addresses, Xte[rows])
        # the steady state of ONE engine of the same model, same client
        # and settings (phase 6's): what three engines in one process
        # are held against
        single = ServingFleet(json_scoring_pipeline(model255), n_engines=1,
                              base_port=0, batch_size=256, workers=2,
                              max_wait_ms=5, tracer=tracer,
                              flight_recorder=False)
        recs1, _ = load.run(order[:LIFECYCLE_REQUESTS // 2],
                            LIFECYCLE_CLIENTS,
                            addresses=single.addresses)
        m1 = single.engines[0].metrics()
        single.stop_all()
        single = None
        check(all(r[4] is None for r in recs1), "(b) one-engine errors")
        one = _windows(recs1, float("inf"), float("inf"))["before"]
        print(f"lifecycle (b) steady state, ONE engine of v1, the same "
              f"client: {one}; {m1['batch_rows'].get('mean', 0):.2f} rows "
              f"a batch, pipeline p50 {m1['pipeline_ms'].get('p50')} ms, "
              f"queue_wait p50 {m1['queue_wait_ms'].get('p50')} ms")
        # ---- (c), first: a poisoned canary rolls back ------------------------
        # a per-row rate well above the canary's per-batch threshold
        # (0.34): the card's batches hold a few rows, and at 0.3 a row a
        # canary can pass 8 clean batches and be promoted (seen on one
        # H100)
        injector = FaultInjector(seed=15, error_rate=0.7)
        poisoned = PoisonedModel(injector.wrap(json_scoring_pipeline(v2)),
                                 fail_batches=0)
        load.start_run(order[:LIFECYCLE_REQUESTS // 4], LIFECYCLE_CLIENTS)
        load.wait_progress(LIFECYCLE_REQUESTS // 16)
        t0 = time.monotonic()
        report_c = fleet.rolling_swap(
            poisoned, "v2-poisoned",
            policy=CanaryPolicy(fraction=0.25, min_batches=8))
        t1 = time.monotonic()
        swap_c_s = t1 - t0
        records_c, stats_c = load.finish()
        check(not report_c["ok"] and report_c["rolled_back"] == 1
              and report_c["completed"] == 0
              and len(report_c["engines"]) == 1,
              f"(c) poisoned rollout report {report_c}")
        # a canary batch the injector spares is answered by the canary:
        # v2's prediction; a failing one is rescued whole on v1; after
        # the rollback only v1 answers
        bad = [r for r in records_c if r[4] is not None
               or r[1].get("prediction") not in (want1[r[0]], want2[r[0]])
               or (r[2] > t1 and r[1].get("prediction") != want1[r[0]])]
        check(not bad, f"(c) {len(bad)} clients saw a canary fault, a "
              f"reply of neither version, or a v2 reply after the "
              f"rollback: {bad[:3]}")
        by_canary = sum(1 for r in records_c if r[0] < n_differ
                        and r[1].get("prediction") == want2[r[0]])
        counters = fleet.counters()
        check(counters["swaps_rolled_back"] == 1,
              f"(c) swaps_rolled_back {counters['swaps_rolled_back']}")
        deadline = time.monotonic() + 10
        while not [b for b in list(rec.bundles)
                   if b["reason"].startswith("swap_rollback:")] \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        bundle = [b for b in list(rec.bundles)
                  if b["reason"].startswith("swap_rollback:")]
        check(bundle, "(c) no swap_rollback flight-recorder bundle")
        check(all(e.model_version == "v1" for e in fleet.engines),
              "(c) an engine left v1")
        print(f"lifecycle (c): poisoned v2 (seeded error rate 0.7, "
              f"{injector.injected_errors} failed canary batches) rolled "
              f"back on engine 0 in {swap_c_s:.3f} s and halted: "
              f"{report_c['engines']}; {len(records_c)} client replies, "
              f"none failed, {by_canary} of them by clean canary batches "
              f"(v2's on rows where the versions differ), every one sent "
              f"after the rollback v1's; bundle reason "
              f"{bundle[0]['reason'][:90]!r}")

        # ---- (b) rolling swap under load ---------------------------------
        load.start_run(order, LIFECYCLE_CLIENTS)
        reached = load.wait_progress(LIFECYCLE_REQUESTS // 8)
        check(reached >= LIFECYCLE_REQUESTS // 8,
              f"(b) the client answered {reached} requests before the swap")
        stop = threading.Event()
        states = {}
        poller = threading.Thread(
            target=lambda: states.update(
                v=_state_times(fleet.engines, stop)), daemon=True)
        poller.start()
        t_swap0 = time.monotonic()
        report = fleet.rolling_swap(
            json_scoring_pipeline(v2), "v2",
            warmup_example={"features": Xte[:1]},
            policy=CanaryPolicy(fraction=0.25, min_batches=8))
        t_swap1 = time.monotonic()
        stop.set()
        poller.join()
        records, stats = load.finish()
        check(report["ok"] and report["completed"] == 3,
              f"(b) rolling swap report {report}")
        errors = [r for r in records if r[4] is not None]
        avail = 1 - len(errors) / len(records)
        check(avail >= 0.99, f"(b) availability {avail:.4f} < 0.99; "
              f"first errors {errors[:3]}")
        bad, after, after_differ = [], 0, 0
        for k, (j, reply, ts, te, err) in enumerate(records):
            if err is not None:
                continue
            got = reply.get("prediction")
            if got not in (want1[j], want2[j]):
                bad.append((j, reply))
            if ts > t_swap1:
                after += 1
                after_differ += int(j < n_differ)
                if got != want2[j]:
                    bad.append((j, reply, "after cutover"))
        check(not bad, f"(b) {len(bad)} replies are neither v1's nor v2's "
              f"(or not v2's after cutover): {bad[:3]}")
        check(after > 0, "(b) no request was sent after the rolling swap")
        text = fleet.metrics_text()
        swaps = sum(float(line.rsplit(" ", 1)[1])
                    for line in text.splitlines()
                    if line.startswith("serving_swaps_completed_total{"))
        scraped = sum(
            float(line.rsplit(" ", 1)[1])
            for a in fleet.addresses
            for line in _http(a + "/metrics")[2].decode().splitlines()
            if line.startswith("serving_swaps_completed_total "))
        check(swaps == 3 and scraped == 3,
              f"(b) /metrics shows {swaps} (fleet) / {scraped} (engines) "
              "completed swaps, not 3")
        win = _windows(records, t_swap0, t_swap1)
        phases = [{k: round(v, 3) for k, v in sorted(st.items())}
                  for st in states["v"]]
        per_engine = [
            (round(m["batch_rows"].get("mean", 0), 2),
             m["pipeline_ms"].get("p50"), m["queue_wait_ms"].get("p50"))
            for m in (e.metrics() for e in fleet.engines)]
        print(f"lifecycle (b): {len(records)} one-row requests from "
              f"{LIFECYCLE_CLIENTS} threads of a spawned process through "
              f"ServingFleet.connect over 3 engines (batch 256, 2 workers, "
              f"5 ms); rolling_swap v1 -> v2 (canary 0.25, 8 batches) took "
              f"{t_swap1 - t_swap0:.3f} s: {report['engines']}; "
              f"availability {avail:.4f}; every reply v1's or v2's "
              f"prediction of its row, {after} sent after the swap all "
              f"v2's ({after_differ} on rows where v1 and v2 differ); "
              f"serving_swaps_completed_total 3; windows {win}; seconds "
              f"per swap state and engine {phases}; per engine (rows a "
              f"batch, pipeline p50 ms, queue_wait p50 ms) {per_engine}; "
              f"client {stats}")

        # ---- (d) an engine killed mid-load ------------------------------------
        hedge = dict(hedge_percentile=95.0, failure_threshold=2,
                     breaker_cooldown=60.0)
        load.start_run(order[:LIFECYCLE_REQUESTS // 4], LIFECYCLE_CLIENTS,
                       timeout=5.0, **hedge)
        load.wait_progress(LIFECYCLE_REQUESTS // 16)
        t_kill = time.monotonic()
        fleet.kill_engine(1)
        records_d, stats_d = load.finish()
        errors = [r for r in records_d if r[4] is not None]
        avail_d = 1 - len(errors) / len(records_d)
        check(avail_d >= 0.99, f"(d) availability {avail_d:.4f} < 0.99")
        check(stats_d["breakers"][1] == CircuitBreaker.OPEN,
              f"(d) the client's breaker of engine 1 is "
              f"{stats_d['breakers'][1]}")
        slow = [r[3] - r[2] for r in records_d if r[2] <= t_kill <= r[3]]
        # the in-process fleet's own breaker: its opening triggers the
        # flight recorder the engines share
        n_bundles = len(rec.bundles)
        for i in range(12):
            fleet.post({"features": Xte[rows[i]].tolist()}, timeout=10)
        check(fleet.breakers[1].state == CircuitBreaker.OPEN,
              "(d) the fleet's breaker of the killed engine did not open")
        deadline = time.monotonic() + 10
        while not [b for b in list(rec.bundles)[n_bundles:]
                   if b["reason"].startswith("circuit_open:engine1@")] \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        check([b for b in list(rec.bundles)
               if b["reason"].startswith("circuit_open:engine1@")],
              "(d) no circuit_open flight-recorder bundle")
        print(f"lifecycle (d): engine 1 killed mid-load: availability "
              f"{avail_d:.4f} over {len(records_d)} requests; client "
              f"transport errors {stats_d['transport_errors']}, hedges "
              f"{stats_d['hedged_requests']}, breakers "
              f"{stats_d['breakers']} (opened {stats_d['breakers_opened']}"
              f"); requests in flight at the kill took "
              f"{[round(x * 1e3, 1) for x in slow]} ms; the fleet's own "
              f"breaker opened and the recorder wrote a circuit_open "
              "bundle")

        # ---- (e) one trace across processes ----------------------------------
        reply, trace_id, client_json = load.traced_post(0)
        check(reply.get("prediction") == want2[0],
              f"(e) traced reply {reply}")
        deadline = time.monotonic() + 10
        server = []
        while not server and time.monotonic() < deadline:
            server = [t for t in tracer.buffer.traces()
                      if t.trace_id == trace_id and t.root.name == "request"]
            time.sleep(0.02)
        merged = merge_chrome_traces(json.loads(client_json),
                                     fleet.traces())
        events = [e for e in merged["traceEvents"] if e.get("ph") == "X"
                  and e.get("args", {}).get("trace_id") == trace_id]
        legs = [e for e in events if e["name"] == "client.post"]
        roots = [e for e in events if e["name"] == "request"]
        check(legs and roots and {e["pid"] for e in legs}.isdisjoint(
              {e["pid"] for e in roots}),
              f"(e) merged trace: {len(legs)} client legs, {len(roots)} "
              "engine request spans")
        check(all(e["args"].get("parent_id") in
                  {leg["args"].get("span_id") for leg in legs}
                  for e in roots),
              "(e) the engine's request span is not a child of the leg")
        print(f"lifecycle (e): trace {trace_id}: {len(legs)} client leg(s) "
              f"in the client process, {len(roots)} engine request "
              f"span(s) in this one, parented on the leg; "
              f"{len(events)} events of the trace after "
              "merge_chrome_traces")
    finally:
        if single is not None:
            single.stop_all()
        if load is not None:
            code = load.close()
            check(code == 0, f"the spawned client exited with {code}")
        fleet.stop_all()
        rec.close()
    print(f"lifecycle: phase 15 took {time.perf_counter() - t_phase:.1f} "
          f"s; card: {smi}")
    return {"hist": launches}


def _captured(argv) -> str:
    """Run the port's CLI in this process; its standard output."""
    import contextlib
    import io
    from mmlspark_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    check(rc == 0, f"cli {argv} returned {rc}")
    return buf.getvalue()


def _cold_start(root: str, art: str, mode: str) -> dict:
    """One fresh-process cold start of the AOT runner: its JSON line."""
    r = subprocess.run([sys.executable, "-m", "mmlspark_tpu_torch.serving.aot",
                        art, "--mode", mode, "--port", "0"], cwd=root,
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": root})
    check(r.returncode == 0, f"(d) cold start --mode {mode} failed: "
          f"{r.stderr[-2000:]}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    check(out["ok"] and out["jit_traces_at_request_time"] == 0,
          f"(d) cold start --mode {mode}: {out}")
    return out


def registry_aot_slice(smi: str, model255, out255, Xtr, ytr, Xte) -> dict:
    """Phase 16: (a) the stage registry through the CLI (stages --json,
    describe, codegen and the generated smoke tests); (b) ``cli run`` of
    a JSON spec at phase 3's shape, in this process, then ``cli score``
    in a fresh one; (c) experiment fuzzing of every TestObject whose
    stage has a ``device`` param, on the card against the CPU; (d) AOT
    artifacts of phase 4's seeded LM_SPEC TPUModel and of phase 3's
    forest as a fused pipeline, loaded in this process against the
    models they came from, then fresh-process cold starts in both
    modes. Returns the phase's launches: {"hist": by route (b), "f32":
    flash forward launches of the loaded LM (d)}, and for phase 17 the
    work directory, the LM artifact and the loaded LM's replies to rows
    0-3 alone ("work", "art", "lm_ref")."""
    import importlib.util
    import torch
    from mmlspark_tpu_torch import codegen
    from mmlspark_tpu_torch.core.fusion import fuse
    from mmlspark_tpu_torch.core.stage import load_stage
    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.gbdt import hist_kernels as HK
    from mmlspark_tpu_torch.models.networks import build_network
    from mmlspark_tpu_torch.models.tpu_model import TPUModel
    from mmlspark_tpu_torch.ops import flash_attention as FA
    from mmlspark_tpu_torch.profile_transform import (
        BATCH as LM_BATCH, LM_SPEC, ROWS as LM_ROWS)
    from mmlspark_tpu_torch.serving import aot
    from mmlspark_tpu_torch.stages import FastVectorAssembler
    from mmlspark_tpu_torch.testing import fuzz_objects as FO
    from mmlspark_tpu_torch.testing.equality import assert_table_equal
    from mmlspark_tpu_torch.testing.fuzzing import run_experiment_fuzzing

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "chip_smoke_registry")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    # ---- (a) the registry through the CLI --------------------------------
    t0 = time.perf_counter()
    manifest = json.loads(_captured(["stages", "--json"]))
    n_stages = len(manifest["stages"])
    check(n_stages == len(codegen.stage_manifest()["stages"]) > 0,
          f"(a) stages --json lists {n_stages} stages")
    md = _captured(["describe", "TPUBoostClassifier"])
    check("*Estimator*" in md and "| `numLeaves` |" in md
          and "| `device` |" in md, "(a) describe TPUBoostClassifier")
    gen = os.path.join(work, "generated")
    counts = json.loads(_captured(["codegen", gen]).strip().splitlines()[-1])
    docs = [d for d in os.listdir(os.path.join(gen, "docs"))
            if d != "index.md"]
    check(counts["stages"] == counts["docs"] == len(docs) == n_stages,
          f"(a) codegen {counts}, {len(docs)} docs")
    spec_ = importlib.util.spec_from_file_location(
        "generated_smoke", os.path.join(gen, "test_generated_smoke.py"))
    smoke = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(smoke)
    tests = [getattr(smoke, n) for n in dir(smoke) if n.startswith("test_")]
    for fn in tests:
        fn()
    check(len(tests) == counts["tests"], f"(a) {len(tests)} smoke tests")
    print(f"registry (a): stages --json lists {n_stages} stages; describe "
          f"TPUBoostClassifier: {md.count(chr(10) + '| `')} params; codegen "
          f"{counts}: {len(docs)} docs, {len(tests)} generated smoke tests "
          f"pass in-process ({time.perf_counter() - t0:.1f} s)")

    # ---- (b) cli run of a JSON spec at phase 3's shape --------------------
    data = os.path.join(work, "higgs.npz")
    np.savez(data, features=Xtr, label=ytr)
    spec_path = os.path.join(work, "spec.json")
    with open(spec_path, "w") as f:
        json.dump({"pipeline": [{"stage": "TPUBoostClassifier", "params": {
            "numIterations": 5, "numLeaves": 63, "maxBin": 255}}]}, f)
    saved = os.path.join(work, "model")
    HK.reset_launches()
    t0 = time.perf_counter()
    _captured(["run", spec_path, "--data", data, "--save", saved,
               "--device", "cuda"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    hist = dict(HK.LAUNCHES)
    check(hist["_hist_kernel_nibble"] == 5 * 63 and hist["_hist_kernel"] == 0,
          f"(b) cli run launched the hist kernel {hist}, not 315 times")
    pm = load_stage(saved)
    got = pm.get_stages()[0].get_booster().trees
    want = model255.get_booster().trees
    same = {k: bool(np.array_equal(got[k], want[k])) for k in want}
    check(all(same.values()), f"(b) cli run's forest differs from the API "
          f"fit's: {same}")
    test_npz = os.path.join(work, "holdout.npz")
    np.savez(test_npz, features=Xte)
    scored_dir = os.path.join(work, "scored")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "mmlspark_tpu_torch.cli",
                        "score", "--model", saved, "--data", test_npz,
                        "--out", scored_dir, "--device", "cuda"], cwd=root,
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": root})
    score_s = time.perf_counter() - t0
    check(r.returncode == 0, f"(b) cli score failed: {r.stderr[-2000:]}")
    scored = DataTable.load(scored_dir)
    for c in ("rawPrediction", "probability", "prediction"):
        check(np.array_equal(np.asarray(scored[c]), np.asarray(out255[c])),
              f"(b) cli score's {c} differs from phase 3's transform")
    print(f"registry (b): cli run of a TPUBoostClassifier spec (63 leaves, "
          f"max_bin 255, 5 rounds) on {Xtr.shape} from .npz in this process:"
          f" {run_s:.2f} s with the .npz read, hist launches {hist}; the "
          f"saved forest bitwise phase 3's API fit; cli score in a fresh "
          f"process over {len(Xte)} rows: {score_s:.1f} s, outputs bitwise "
          f"phase 3's transform")
    del pm, scored
    os.remove(data)

    # ---- (c) experiment fuzzing on the card against the CPU ---------------
    t0 = time.perf_counter()
    ran, bad, seeded = [], [], []
    for name, factories in sorted(FO.register_all().items()):
        for factory in factories:
            on_cpu = factory()
            if not FO.has_device_param(on_cpu.stage):
                continue
            want_t = run_experiment_fuzzing(on_cpu)
            on_card = factory()
            FO.on_device(on_card.stage, "cuda")
            got_t = run_experiment_fuzzing(on_card)
            try:
                if getattr(on_cpu, "device_seeded", False):
                    # weights drawn on the card: shapes only
                    for c in want_t.column_names:
                        g, w = got_t[c], want_t[c]
                        assert len(g) == len(w) and (
                            not isinstance(w, np.ndarray)
                            or np.shape(g) == w.shape), c
                    seeded.append(name)
                else:
                    assert_table_equal(got_t, want_t, check_schema=False,
                                       tol=max(on_cpu.tol, 1e-4))
            except AssertionError as e:
                bad.append(f"{name}: {str(e)[:300]}")
            ran.append(name)
    check(not bad, f"(c) card vs CPU fuzzing: {bad}")
    print(f"registry (c): experiment fuzzing of {len(ran)} TestObjects on "
          f"the card held to the CPU (tol max(object's, 1e-4); shapes only "
          f"for {seeded}, whose weights are drawn on the card): {ran} in "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- (d) AOT artifacts at full width ---------------------------------
    spec = LM_SPEC
    lm = build_network(spec, device="cuda", seed=0)
    model = TPUModel.from_module(lm, device="cuda", inputCol="tokens",
                                 outputCol="logits", batchSize=LM_BATCH)
    tokens = np.random.default_rng(7).integers(
        0, spec["vocab_size"], size=(LM_ROWS, spec["max_len"]))
    table = DataTable({"tokens": tokens})
    ref = model.transform(table)["logits"]
    art = os.path.join(work, "lm_aot")
    t0 = time.perf_counter()
    man = aot.export_model(model, table, art)
    export_s = time.perf_counter() - t0
    art_bytes = {f: os.path.getsize(os.path.join(art, f))
                 for f in os.listdir(art) if os.path.isfile(
                     os.path.join(art, f))}
    check(man["format"] == "torch_export" and man["programs"] == len(
        man["buckets"]) and "flash_fwd" in man["kernels"],
          f"(d) LM manifest {man}")
    t0 = time.perf_counter()
    loaded = aot.load_model(art)
    load_s = time.perf_counter() - t0
    FA.reset_launches()
    t0 = time.perf_counter()
    out = loaded.transform(table)["logits"]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    f32_launches = FA.LAUNCHES["_fwd_kernel"]
    n_batches = -(-LM_ROWS // LM_BATCH)
    check(f32_launches == spec["depth"] * n_batches,
          f"(d) the loaded LM launched the flash kernel {f32_launches} "
          f"times, not {spec['depth']} x {n_batches}")
    check(np.array_equal(out, ref), "(d) the loaded LM's logits differ from "
          "the in-process model's")
    check(loaded.jit_cache_misses == 0,
          f"(d) the loaded LM missed {loaded.jit_cache_misses} shapes")
    # what phase 17's zoo must answer: the loaded model's argmax for rows
    # 0-3, each alone (a one-row batch pads to the one bucket)
    lm_ref = {"tokens": tokens[:4], "replies": [
        loaded.transform(DataTable({"tokens": tokens[i:i + 1]}))[
            "logits"][0].argmax(-1).tolist() for i in range(4)]}
    walls = {}
    for label, m in (("eager", model), ("loaded", loaded), ("eager", model),
                     ("loaded", loaded)):
        t0 = time.perf_counter()
        m.transform(table)
        torch.cuda.synchronize()
        walls.setdefault(label, []).append(time.perf_counter() - t0)
    print(f"registry (d) LM_SPEC (depth {spec['depth']}, batch {LM_BATCH}) "
          f"AOT: export {export_s:.2f} s, {len(man['buckets'])} program(s) "
          f"for buckets {man['buckets']}, artifact bytes {art_bytes} "
          f"(total {sum(art_bytes.values()) / 1e9:.3f} GB), kernels "
          f"{man['kernels']}; load in this process {load_s:.2f} s; first "
          f"transform of {LM_ROWS} x {spec['max_len']} {first_s:.3f} s, "
          f"flash launches {f32_launches} ({spec['depth']} a forward), "
          f"logits bitwise the in-process model's, jit_cache_misses 0; "
          f"warm transform eager / loaded program "
          f"{[round(x, 4) for x in walls['eager']]} / "
          f"{[round(x, 4) for x in walls['loaded']]} s")
    del lm, model, loaded, ref, out
    torch.cuda.empty_cache()

    # phase 3's forest served from raw JSON rows: a JSON list decodes to
    # a list column, which no device op reads, so the 28 features arrive
    # as scalar fields and an assembler opens the fused segment
    names = [f"f{i}" for i in range(Xte.shape[1])]

    def raw_rows(n):
        return DataTable({c: Xte[:n, i] for i, c in enumerate(names)})

    fz = fuse([FastVectorAssembler(inputCols=names, outputCol="features"),
               model255], batch_size=256)
    fart = os.path.join(work, "forest_aot")
    t0 = time.perf_counter()
    fman = aot.export_model(fz, raw_rows(4), fart)
    fexport_s = time.perf_counter() - t0
    floaded = aot.load_model(fart)
    meta = aot._read_pickle(fart, "pipeline.pkl")
    plan_ref = fz.plan_for(meta["in_schema"], meta["final_needed"])
    plan_aot = floaded.plan_for(meta["in_schema"], meta["final_needed"])
    check(len(plan_aot.segments) == 1 == fman["programs"] // len(
        fman["buckets"]), f"(d) forest plan {plan_aot.describe()}")
    for b in fz.bucket_sizes():
        a = np.asarray(plan_ref.execute(raw_rows(b))[meta["reply_col"]])
        c = np.asarray(plan_aot.execute(raw_rows(b))[meta["reply_col"]])
        check(np.array_equal(a, c), f"(d) forest bucket {b}: the loaded "
              "pipeline's replies differ from the in-process one's")
        check(np.array_equal(c, np.asarray(out255["prediction"][:b])),
              f"(d) forest bucket {b}: replies differ from phase 3's")
    check(floaded.jit_cache_misses == 0 and floaded.aot,
          f"(d) the loaded forest missed {floaded.jit_cache_misses} shapes")
    print(f"registry (d) phase 3's forest behind FastVectorAssembler as a "
          f"fused pipeline: export {fexport_s:.2f} s, {fman['programs']} "
          f"programs for buckets {fman['buckets']} ({plan_aot.describe()});"
          f" every bucket's {meta['reply_col']} bitwise the in-process "
          f"pipeline's and phase 3's transform, jit_cache_misses 0")
    del fz, floaded

    # fresh-process cold starts, one of each mode (each pays ~10 s of
    # imports; the whole script's time limit does not hold two of each)
    best = {mode: _cold_start(root, art, mode) for mode in ("trace", "aot")}
    keys = ("cold_start_to_first_200_ms", "model_ready_ms",
            "first_request_ms", "jit_traces_total",
            "jit_traces_at_request_time")
    for mode, b in best.items():
        print(f"registry (d) cold start --mode {mode} (LM_SPEC depth "
              f"{spec['depth']}): {({k: b[k] for k in keys})}; phases "
              f"{b['phases_ms']}")
    ratio = (best["trace"]["cold_start_to_first_200_ms"]
             / best["aot"]["cold_start_to_first_200_ms"])
    print(f"registry (d): trace / aot cold start {ratio:.3f}; card: {smi}")
    print(f"registry: phase 16 took {time.perf_counter() - t_phase:.1f} s; "
          f"card: {smi}")
    # the work directory stays for phase 17 (its LM artifact), which
    # removes it
    return {"hist": hist, "f32": f32_launches, "work": work, "art": art,
            "lm_ref": lm_ref}


# ---------------------------------------------------------------------------
# phase 17: the multi-model plane
# ---------------------------------------------------------------------------

ZOO_MODELS = 256            # bench_zoo's shape (bench.py:1261-1264)
ZOO_MAX_RESIDENT = 32
ZOO_REQUESTS = 2000
ZOO_CLIENTS = 16
ZOO_LM_EVERY = 40           # 17(a): every 40th request goes to the LM
ZOO_DIM, ZOO_CLASSES = 16, 8
LADDER_CLIENTS = 24         # 17(c)'s burst: 24 clients x 2 requests
LADDER_HOLD_S = 2.0
ACTIVATION_CLIENTS = 4      # 17(d)'s resident-model clients


def _zoo_scoring_stage(tag: str, w):
    """bench_zoo's per-model host scorer: features @ w, argmax."""
    from mmlspark_tpu_torch.stages.basic import Lambda

    def handle(table):
        feats = np.asarray([json.loads(r["entity"].decode())["features"]
                            for r in table["request"]], np.float32)
        return table.with_column("reply", [
            {"model": tag, "prediction": int(s.argmax())}
            for s in feats @ w])
    return Lambda.apply(handle)


def _settled_allocated() -> int:
    """Allocated card bytes with nothing in flight, without the cuBLAS
    workspaces (one per stream that ran a GEMM)."""
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    return torch.cuda.memory_allocated()


def _link_tree(src: str, dst: str) -> None:
    """``dst`` as hard links of ``src``'s files (a copy where links fail):
    another version of the same artifact that loads its own weights."""
    os.makedirs(dst, exist_ok=True)
    for name in os.listdir(src):
        s, d = os.path.join(src, name), os.path.join(dst, name)
        if os.path.isdir(s):
            _link_tree(s, d)
            continue
        try:
            os.link(s, d)
        except OSError:
            shutil.copyfile(s, d)


def _zoo_post(addr: str, payload: dict, model: str, timeout: float = 300):
    """One routed request: (status, body, X-Model, ms)."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(addr, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json",
                                          "X-Model": model})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            body, code, served = json.loads(r.read()), r.status, \
                r.headers.get("X-Model")
    except urllib.error.HTTPError as e:
        body, code, served = None, e.code, None
    return code, body, served, (time.perf_counter() - t0) * 1e3


def _evict_all(zoo) -> None:
    """Unpin and evict every resident model (their card memory comes
    back), then stop the loader."""
    for row in zoo.stats()["models"]:
        if row["state"] == "resident":
            key = f"{row['model']}@{row['version']}"
            zoo.pin(key, pinned=False)
            zoo.evict(key)
    zoo.close()


def _pct(lat, q: float) -> float:
    return round(float(np.percentile(np.asarray(lat), q)), 3) if lat \
        else float("nan")


def _zoo_churn(smi: str, art: str, lm_payload, ref, device: str) -> dict:
    """17(a): bench_zoo's shape with the LM among 256 host models.
    Returns the LM requests' client p99 (ms)."""
    import concurrent.futures
    import urllib.error
    from mmlspark_tpu_torch.ops import flash_attention as FA
    from mmlspark_tpu_torch.serving import (
        AdmissionController, ModelZoo, ServingFleet, ServingUnavailable,
    )
    t_sub = time.perf_counter()
    rng = np.random.default_rng(0)
    zoo = ModelZoo(max_resident=ZOO_MAX_RESIDENT, memory_probe=None,
                   device=device)
    for i in range(ZOO_MODELS):
        w = rng.normal(size=(ZOO_DIM, ZOO_CLASSES)).astype(np.float32)
        zoo.register_factory(
            f"m{i:03d}", f"v{i % 8}",
            (lambda i=i, w=w: _zoo_scoring_stage(f"m{i:03d}", w)),
            metadata={"cost_bytes": int(w.nbytes)})
    zoo.register_artifact("lm", "v1", art)
    fleet = ServingFleet(n_engines=2, base_port=0, batch_size=64,
                         workers=2, max_wait_ms=3.0, zoo=zoo,
                         admission=AdmissionController(), tracing=False)
    ranks = np.arange(1, ZOO_MODELS + 1, dtype=np.float64)
    probs = 1.0 / ranks ** 1.1
    picks = rng.choice(ZOO_MODELS, size=ZOO_REQUESTS, p=probs / probs.sum())
    payload = {"features": rng.normal(size=ZOO_DIM).tolist()}
    n_rows = len(lm_payload)
    lock = threading.Lock()
    lat, lm_lat, failures, wrong = [], [], [], []

    def post(i):
        if i % ZOO_LM_EVERY == ZOO_LM_EVERY // 2:
            model_key, body_in = "lm", lm_payload[i % n_rows]
        else:
            model_key, body_in = f"m{picks[i]:03d}", payload
        t0 = time.perf_counter()
        try:
            body = fleet.post(body_in, model=model_key, tenant=f"t{i % 4}",
                              timeout=300)
            ok = (body["prediction"] == ref[i % n_rows]
                  if model_key == "lm" else body["model"] == model_key)
            if not ok:
                with lock:
                    wrong.append((i, model_key))
        except (urllib.error.HTTPError, ServingUnavailable) as e:
            with lock:
                failures.append(getattr(e, "code", 503))
            ok = False
        dt = (time.perf_counter() - t0) * 1e3
        with lock:
            (lm_lat if model_key == "lm" else lat).append(dt)
        return ok

    try:
        l0 = FA.LAUNCHES["_fwd_kernel"]
        t0 = time.perf_counter()
        body = fleet.post(lm_payload[0], model="lm", timeout=300)
        cold_ms = (time.perf_counter() - t0) * 1e3
        act = [e for e in zoo.events if e.kind == "activate"
               and e.model == "lm"][0]
        # the LM stays resident through the churn (as the reference's
        # floor pins its real model): its forwards count on one object
        zoo.pin("lm")
        lm_model = zoo.get("lm").model
        forwards = lm_model.histograms()["device_ms"].snapshot()["count"]
        launches = FA.LAUNCHES["_fwd_kernel"] - l0
        check(body["prediction"] == ref[0], "(17a) the zoo LM's reply "
              "differs from phase 16's loaded model on the same row")
        check(forwards == 2 and launches == 8 * forwards,
              f"(17a) {launches} flash launches over {forwards} LM "
              "forwards (warmup + request), not 8 a forward")
        check(act.stats["cost_source"] == "device",
              f"(17a) LM activation {act.stats}")
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(ZOO_CLIENTS) as ex:
            results = list(ex.map(post, range(ZOO_REQUESTS)))
        wall = time.perf_counter() - t0
        stats = zoo.stats()
        lm_forwards = lm_model.histograms()["device_ms"].snapshot()["count"]
        lm_launches = FA.LAUNCHES["_fwd_kernel"] - l0
        del lm_model
    finally:
        fleet.stop_all()
        _evict_all(zoo)
    availability = sum(results) / len(results)
    check(not wrong, f"(17a) wrong replies (model mixed or LM not "
          f"bitwise phase 16's): {wrong[:5]}")
    check(availability >= 0.99, f"(17a) availability {availability:.4f}, "
          f"failures {sorted(set(failures))}")
    check(stats["evictions_with_outstanding"] == 0,
          f"(17a) {stats['evictions_with_outstanding']} evictions with "
          "outstanding batches")
    check(lm_launches == 8 * lm_forwards,
          f"(17a) {lm_launches} flash launches over {lm_forwards} LM "
          "forwards")
    lm_p99 = _pct(lm_lat, 99)
    print(f"multimodel (a) bench_zoo's shape: {ZOO_MODELS} host models + "
          f"the LM_SPEC artifact behind a 2-engine in-process fleet sharing "
          f"one zoo (cache {ZOO_MAX_RESIDENT}, 2 workers each), "
          f"{ZOO_REQUESTS} requests from {ZOO_CLIENTS} clients, zipf(1.1), "
          f"4 tenants, every {ZOO_LM_EVERY}th to the LM: LM cold request "
          f"{cold_ms:.1f} ms (activation {act.stats['ms']} ms, cost "
          f"{act.stats['cost_bytes']} B from the device); "
          f"{ZOO_REQUESTS / wall:.1f} requests/s, p50 {_pct(lat + lm_lat, 50)}"
          f" ms, p99 {_pct(lat + lm_lat, 99)} ms (LM requests p50 "
          f"{_pct(lm_lat, 50)} / p99 {lm_p99} ms); availability "
          f"{availability:.4f}; activations {stats['activations']}, "
          f"evictions {stats['evictions']}, evictions_with_outstanding "
          f"{stats['evictions_with_outstanding']}; flash launches "
          f"{lm_launches} over {lm_forwards} LM forwards (8 a forward); "
          f"every LM reply bitwise phase 16's loaded model "
          f"({time.perf_counter() - t_sub:.1f} s); card: {smi}")
    return {"lm_p99": lm_p99}


def _zoo_residency(smi: str, vroot: str, lm_payload) -> None:
    """17(b): three versions of the LM under the live memory probe."""
    import torch
    from mmlspark_tpu_torch.serving import HTTPSource, ModelZoo, ServingEngine
    from mmlspark_tpu_torch.profile_transform import BATCH as LM_BATCH
    t_sub = time.perf_counter()
    zoo = ModelZoo(artifact_root=vroot, memory_headroom=1.0, device="cuda")
    source = HTTPSource(port=0)
    engine = ServingEngine(source, zoo=zoo, batch_size=LM_BATCH,
                           tracing=False, flight_recorder=False).start()
    limit = torch.cuda.get_device_properties(0).total_memory
    try:
        base = _settled_allocated()
        codes = [_zoo_post(source.address, lm_payload[1], "lm@v1")[0]]
        rb = zoo.entry_status("lm@v1")["cost_bytes"]
        states = [_settled_allocated()]
        torch.cuda.reset_peak_memory_stats()
        codes.append(_zoo_post(source.address, lm_payload[1], "lm@v1")[0])
        transient = torch.cuda.max_memory_allocated() - states[0]
        check(0 < transient < rb, f"(17b) a forward's transient {transient}"
              f" B against resident_bytes {rb} B leaves no threshold")
        # the probe fires above two residents plus a forward's transient
        # and below three: halfway between them
        zoo.memory_headroom = (base + 2.5 * rb + transient / 2) / limit
        steps = []
        for v in ("v2", "v3", "v1"):
            n_ev = len(zoo.events)
            code, body, served, ms = _zoo_post(source.address, lm_payload[1],
                                               f"lm@{v}")
            codes.append(code)
            # the loader's post-activation enforce may still be running
            deadline = time.monotonic() + 10
            while zoo.stats()["by_state"].get("resident", 0) > 2 and \
                    time.monotonic() < deadline:
                time.sleep(0.02)
            now = _settled_allocated()
            new = zoo.events[n_ev:]
            evs = [(e.version, e.reason) for e in new if e.kind == "evict"]
            acts = [e.stats for e in new if e.kind == "activate"]
            check(len(acts) == 1 and acts[0]["cost_source"] == "device",
                  f"(17b) {v}: activations {acts}")
            victims = sum(zoo.entry_status(f"lm@{ver}")["cost_bytes"]
                          for ver, _ in evs)
            steps.append({"to": v, "evicted": evs, "ms": round(ms, 1),
                          "allocated": now,
                          "fell": states[-1] + acts[0]["cost_bytes"] - now,
                          "victims_bytes": victims,
                          "activation_ms": acts[0]["ms"]})
            states.append(now)
        evictions = zoo.stats()["evictions"]
        headroom = zoo.memory_headroom
    finally:
        engine.stop()
        _evict_all(zoo)
    check(codes == [200] * 5, f"(17b) statuses {codes}")
    check([s["evicted"] for s in steps] == [
        [], [("v1", "lru:memory_pressure")], [("v2", "lru:memory_pressure")]],
        f"(17b) evictions {[(s['to'], s['evicted']) for s in steps]}")
    for s in steps:
        check(abs(s["fell"] - s["victims_bytes"]) <= 0.05 * rb,
              f"(17b) at {s['to']}, memory_allocated fell {s['fell']} B, "
              f"not the victims' {s['victims_bytes']} B")
    print(f"multimodel (b) LM residency under the live probe: three "
          f"versions of the artifact (hard links, each loads its own "
          f"{rb} B), baseline {base} B, a forward's transient {transient} B,"
          f" headroom {headroom:.4f} of {limit} B; rotation v1 -> v2 -> v3 "
          "-> v1: " + "; ".join(
              f"{s['to']} ({s['ms']} ms, activation {s['activation_ms']} "
              f"ms): evicted {s['evicted'] or 'nothing'}, allocated "
              f"{s['allocated']} B, fell {s['fell']} B against the "
              f"victims' {s['victims_bytes']} B" for s in steps)
          + f"; availability 1.0; evictions {evictions} "
          f"({time.perf_counter() - t_sub:.1f} s); card: {smi}")


def _zoo_ladder(smi: str, lroot: str, lm_payload, slo_ms: float,
                costs: dict, device: str) -> None:
    """17(c): the [f32, int8] variant ladder under a burst."""
    import concurrent.futures
    from mmlspark_tpu_torch.profile_transform import BATCH as LM_BATCH
    from mmlspark_tpu_torch.serving import (
        HTTPSource, ModelZoo, ServingEngine, VariantSelector,
    )
    t_sub = time.perf_counter()
    zoo = ModelZoo(artifact_root=lroot, memory_probe=None, device=device)
    sel = VariantSelector(zoo, decide_interval_s=0.1, hold_s=LADDER_HOLD_S,
                          pressure_limit=4)
    sel.declare("lm", ["lm", "lm_int8"], slo_ms=slo_ms, costs=costs)
    source = HTTPSource(port=0)
    engine = ServingEngine(source, zoo=zoo, variants=sel,
                           batch_size=LM_BATCH, max_wait_ms=3.0,
                           tracing=False, flight_recorder=False).start()
    n_rows = len(lm_payload)
    try:
        zoo.get("lm", timeout=300)
        zoo.get("lm_int8", timeout=300)
        check(sel.route("lm") == "lm@v1", "(17c) ladder starts off rung 0")

        def client(c):
            return [_zoo_post(source.address, lm_payload[(c + k) % n_rows],
                              "lm") for k in range(2)]

        t_burst = time.time()
        with concurrent.futures.ThreadPoolExecutor(LADDER_CLIENTS) as ex:
            done = [r for rs in ex.map(client, range(LADDER_CLIENTS))
                    for r in rs]
        t_end = time.time()
        # the route may come back to rung 0 by a selection while the
        # floor is open (rung 1 profiled over the SLO); the floor itself
        # closes hold_s after the pressure clears
        deadline = time.monotonic() + LADDER_HOLD_S + 10
        while not any(e.kind == "step_up" for e in sel.events) and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        deadline = time.monotonic() + 2.0      # the tick's route rebuild
        while sel.route("lm") != "lm@v1" and time.monotonic() < deadline:
            time.sleep(0.02)
        final_route = sel.route("lm")
        events = list(sel.events)
    finally:
        engine.stop()
        _evict_all(zoo)
    by_rung = {}
    for code, body, served, ms in done:
        check(code == 200, f"(17c) a burst request answered {code}")
        by_rung.setdefault(served, []).append(ms)
    down = [e for e in events if e.kind == "step_down"]
    up = [e for e in events if e.kind == "step_up"]
    check(down and down[0].reason == "queue_pressure",
          f"(17c) no step down under the burst: {events}")
    check(by_rung.get("lm_int8@v1"), f"(17c) no reply from the int8 rung: "
          f"{ {k: len(v) for k, v in by_rung.items()} }")
    check(final_route == "lm@v1" and up
          and up[-1].at - t_end <= LADDER_HOLD_S + 1.0,
          f"(17c) the route did not step back up within hold_s "
          f"({LADDER_HOLD_S} s) of the burst's end: {events}")
    print(f"multimodel (c) ladder [lm f32, lm int8] (slo_ms = (a)'s LM p99 "
          f"{slo_ms} ms, declared costs {costs}), {LADDER_CLIENTS} clients x "
          f"2 requests, pressure limit 4: step down {down[0].at - t_burst:.3f}"
          f" s after the burst began, the last step up "
          f"{up[-1].at - t_end:.3f} s after it ended (hold_s "
          f"{LADDER_HOLD_S}; {len(down)} step down(s), {len(up)} step up(s),"
          f" {sum(e.kind == 'select' for e in events)} selects: "
          f"{[(e.kind, e.variant, e.reason) for e in events[1:]]}); "
          f"replies by rung " + ", ".join(
              f"{k}: {len(v)} (p50 {_pct(v, 50)} / p99 {_pct(v, 99)} ms)"
              for k, v in sorted(by_rung.items()))
          + f" ({time.perf_counter() - t_sub:.1f} s); card: {smi}")


def _zoo_cold_activation(smi: str, vroot: str, lm_payload,
                         device: str) -> None:
    """17(d): a resident host model's latency with nothing activating
    and while an LM version activates."""
    from mmlspark_tpu_torch.serving import HTTPSource, ModelZoo, ServingEngine
    t_sub = time.perf_counter()
    rng = np.random.default_rng(1)
    w = rng.normal(size=(ZOO_DIM, ZOO_CLASSES)).astype(np.float32)
    payload = {"features": rng.normal(size=ZOO_DIM).tolist()}
    zoo = ModelZoo(artifact_root=vroot, memory_probe=None, device=device)
    zoo.register_factory("fast", "v1", lambda: _zoo_scoring_stage("fast", w))
    source = HTTPSource(port=0)
    engine = ServingEngine(source, zoo=zoo, batch_size=64, workers=2,
                           max_wait_ms=3.0, tracing=False,
                           flight_recorder=False).start()

    def hammer(stop, out):
        while not stop.is_set():
            code, _body, _served, ms = _zoo_post(source.address, payload,
                                                 "fast", timeout=60)
            out.append((time.perf_counter(), code, ms))

    def window(activate: bool):
        stop = threading.Event()
        outs = [[] for _ in range(ACTIVATION_CLIENTS)]
        ts = [threading.Thread(target=hammer, args=(stop, o)) for o in outs]
        for t in ts:
            t.start()
        time.sleep(0.5)
        t0 = time.perf_counter()
        if activate:
            res = _zoo_post(source.address, lm_payload[2], "lm@v3")
            check(res[0] == 200, f"(17d) cold LM request answered {res[0]}")
        else:
            time.sleep(3.0)
        t1 = time.perf_counter()
        stop.set()
        for t in ts:
            t.join(timeout=60)
        got = [(c, ms) for o in outs for (t, c, ms) in o if t0 <= t <= t1]
        check(got and all(c == 200 for c, _ in got),
              f"(17d) resident-model statuses {sorted({c for c, _ in got})}")
        return [ms for _, ms in got], (t1 - t0) * 1e3

    try:
        zoo.get("fast")
        quiet, quiet_ms = window(False)
        busy, busy_ms = window(True)
        act = [e for e in zoo.events if e.kind == "activate"
               and e.model == "lm"][0]
    finally:
        engine.stop()
        _evict_all(zoo)
    print(f"multimodel (d) resident model during a cold activation "
          f"({ACTIVATION_CLIENTS} clients): nothing activating {len(quiet)}"
          f" requests in {quiet_ms:.0f} ms, p50 {_pct(quiet, 50)} / p99 "
          f"{_pct(quiet, 99)} ms; while lm@v3 activates ({act.stats['ms']} "
          f"ms, {busy_ms:.0f} ms to its reply) {len(busy)} requests, p50 "
          f"{_pct(busy, 50)} / p99 {_pct(busy, 99)} ms "
          f"({time.perf_counter() - t_sub:.1f} s); card: {smi}")


def multimodel_slice(smi: str, art: str, work: str, lm_ref: dict) -> dict:
    """Phase 17: the multi-model plane on the card, over phase 16's
    LM_SPEC artifact and an int8 artifact of the same seeded model:
    (a) churn at bench_zoo's shape; (b) LM residency under the live
    memory probe; (c) the [f32, int8] variant ladder under a burst;
    (d) a resident model's latency while an LM version activates.
    Returns {"f32": the flash forward's launches in the phase}."""
    import torch
    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.models.networks import build_network
    from mmlspark_tpu_torch.models.tpu_model import TPUModel
    from mmlspark_tpu_torch.ops import flash_attention as FA
    from mmlspark_tpu_torch.profile_transform import BATCH as LM_BATCH, LM_SPEC
    from mmlspark_tpu_torch.serving import aot

    t_phase = time.perf_counter()
    launches0 = FA.LAUNCHES["_fwd_kernel"]
    toks, ref = lm_ref["tokens"], lm_ref["replies"]
    lm_payload = [{"tokens": toks[i].tolist()} for i in range(len(toks))]

    # the int8 artifact of the same seeded model (phase 16's is f32)
    t0 = time.perf_counter()
    model = TPUModel.from_module(build_network(LM_SPEC, device="cuda",
                                               seed=0),
                                 device="cuda", inputCol="tokens",
                                 outputCol="logits", batchSize=LM_BATCH)
    calib = DataTable({"tokens": np.resize(toks, (LM_BATCH, toks.shape[1]))})
    art_int8 = os.path.join(work, "lm_int8_aot")
    man8 = aot.export_model(model.quantize(calib), calib, art_int8)
    check(man8["precision"] == "int8", f"(17) int8 manifest {man8}")
    del model
    torch.cuda.empty_cache()
    wbytes = {k: os.path.getsize(os.path.join(a, "weights.pkl"))
              for k, a in (("f32", art), ("int8", art_int8))}
    print(f"multimodel: int8 LM_SPEC artifact exported in "
          f"{time.perf_counter() - t0:.1f} s; weights.pkl f32 / int8 "
          f"{wbytes['f32']} / {wbytes['int8']} B")

    churn = _zoo_churn(smi, art, lm_payload, ref, "cuda")
    vroot = os.path.join(work, "lm_versions")
    for v in ("v1", "v2", "v3"):
        _link_tree(art, os.path.join(vroot, "lm", v))
    _zoo_residency(smi, vroot, lm_payload)
    lroot = os.path.join(work, "ladder")
    _link_tree(art, os.path.join(lroot, "lm", "v1"))
    _link_tree(art_int8, os.path.join(lroot, "lm_int8", "v1"))
    # declared costs, as the reference's ladder tests declare them: the
    # int8 artifact's weights are no smaller (it keeps the f32 kernels
    # beside the int8 ones), so bytes would not rank it cheaper
    _zoo_ladder(smi, lroot, lm_payload, churn["lm_p99"],
                {"lm": 1.0, "lm_int8": 0.25}, "cuda")
    _zoo_cold_activation(smi, vroot, lm_payload, "cuda")
    f32 = FA.LAUNCHES["_fwd_kernel"] - launches0
    check(f32 > 0 and f32 % 8 == 0, f"(17) {f32} flash launches")
    print(f"multimodel: phase 17 took {time.perf_counter() - t_phase:.1f} s"
          f"; flash forward launches {f32}; card: {smi}")
    return {"f32": f32}


CONTROLPLANE_DIR = os.path.join("build", "chip_smoke_controlplane")
CP_WINDOW_ROWS = 262_144    # 18(a)'s ReplayWindow: four 65,536-row chunks
CP_CHUNK_ROWS = 65_536
CP_STEADY = 1000            # 18(a)'s steady one-row requests
CP_DRIFT_RUN = 1500         # drifted one-row requests a client run
CP_CLIENTS = 16
FABRIC_PROCS = 4            # 18(b): bench_fabric's shape (bench.py)
FABRIC_CLIENTS = 4
FABRIC_ROWS = 512
FABRIC_WARM_S = 1.5
FABRIC_LOAD_S = 3.0         # a turn; turns shm, HTTP, HTTP, shm: 6 s each


def higgs_drift(n: int, seed: int = 8):
    """``higgs_shape``'s stream after a shift: features 5-7, which the
    label rule does not read, move +4 sigma (they trip the drift
    monitor); features 1-2 move +1 sigma (they move the decision
    surface); then the same label rule."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 28)).astype(np.float32)
    X[:, 5:8] += 4.0
    X[:, 1:3] += 1.0
    logit = (X[:, 0] + 0.6 * X[:, 1] * X[:, 2]
             + 0.4 * np.sin(2 * X[:, 3]) - 0.3 * X[:, 4] ** 2 + 0.3)
    y = (logit + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    return X, y


def _fabric_run(fleet, X) -> dict:
    """bench_fabric's closed loop: FABRIC_CLIENTS threads post_columns
    512-row blocks of ``X`` for FABRIC_WARM_S unrecorded, then
    FABRIC_LOAD_S recorded. Returns rows/s, p50 / p99 and failures."""
    lock = threading.Lock()
    stop = threading.Event()
    rec = {"on": False, "rows": 0, "lat": [], "failed": []}

    def client(cid):
        k = cid
        while not stop.is_set():
            lo = (k * FABRIC_ROWS) % (len(X) - FABRIC_ROWS)
            k += FABRIC_CLIENTS
            t0 = time.perf_counter()
            try:
                rep = fleet.post_columns(
                    {"features": X[lo:lo + FABRIC_ROWS]}, timeout=30)
                ms = (time.perf_counter() - t0) * 1e3
                with lock:
                    if rec["on"]:
                        rec["rows"] += len(rep["prediction"])
                        rec["lat"].append(ms)
            except Exception as e:  # noqa: BLE001 — counted, checked
                with lock:
                    rec["failed"].append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(FABRIC_CLIENTS)]
    for t in threads:
        t.start()
    time.sleep(FABRIC_WARM_S)
    with lock:
        rec["on"] = True
    t0 = time.perf_counter()
    time.sleep(FABRIC_LOAD_S)
    with lock:
        rec["on"] = False
        wall = time.perf_counter() - t0
    stop.set()
    for t in threads:
        t.join(timeout=60)
    return {"rows_per_s": round(rec["rows"] / wall, 1),
            "requests": len(rec["lat"]), "p50_ms": _pct(rec["lat"], 50),
            "p99_ms": _pct(rec["lat"], 99), "failed": rec["failed"]}


def controlplane_slice(dev, smi: str, model255, Xtr, ytr, Xte, yte,
                       auc255: float) -> dict:
    """Phase 18: (a) the closed loop — phase 3's max_bin 255 forest
    served on the card with a drift monitor, a spawned client's steady
    then drifted traffic, a ContinuousTrainer whose refit is
    ``boost_more(5)`` over a 262,144-row ReplayWindow through the hist
    kernel on the trainer thread, its gate, canary and cutover, then a
    label-flipped refit quarantined; (b) the host transports — four
    engine processes of ``testing/serving_worker.py`` serving the same
    forest on the card behind ``ServingFleet.connect``, shm against
    HTTP+msgpack. Returns {"hist": the refits' hist launches}."""
    import copy
    import torch
    from mmlspark_tpu_torch.core.flightrecorder import FlightRecorder
    from mmlspark_tpu_torch.core.metrics import DriftMonitor
    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.gbdt import hist_kernels as HK
    from mmlspark_tpu_torch.gbdt.estimators import (
        TPUBoostClassificationModel, TPUBoostClassifier)
    from mmlspark_tpu_torch.io import shm as SHM
    from mmlspark_tpu_torch.io.ooc import ReplayWindow
    from mmlspark_tpu_torch.serving import (
        CanaryPolicy, ContinuousTrainer, GatePolicy, ModelRegistry,
        ServingFleet, TriggerPolicy, json_scoring_pipeline, serve_model)
    from mmlspark_tpu_torch.testing import metrics_check
    from mmlspark_tpu_torch.testing.fleet_load import FleetLoad

    t_phase = time.perf_counter()
    base = model255.get_booster()
    Xd, yd = higgs_drift(CP_WINDOW_ROWS + 100_000)
    Xw, yw = Xd[:CP_WINDOW_ROWS], yd[:CP_WINDOW_ROWS]
    Xh, yh = Xd[CP_WINDOW_ROWS:], yd[CP_WINDOW_ROWS:]
    check(0.2 <= float(yd.mean()) <= 0.8,
          f"(18a) drifted positive rate {yd.mean():.3f}")

    def as_model(booster):
        m = TPUBoostClassificationModel(
            modelString=booster.model_to_string(), numClasses=2,
            device=dev.type)
        m._booster = booster
        return m

    def window_xy(window):
        tab = window.materialize()
        return (np.asarray(tab["features"], np.float32),
                np.asarray(tab["label"], np.float32))

    refit_launches = {}

    def cycle_ended(kinds, n0):
        """Wait (120 s at most) until the trainer's timeline, past its
        first ``n0`` events, ends a cycle with one of ``kinds``: its
        counters move before its last event and its quarantine evidence
        land."""
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            last = (trainer.history[-1] if len(trainer.history) > n0
                    else None)
            if last is not None and last.kind in kinds and (
                    last.kind != "quarantined"
                    or last.version in trainer.quarantined):
                return True
            time.sleep(0.02)
        return False

    def refit(window, active):
        X, y = window_xy(window)
        n0 = HK.LAUNCHES["_hist_kernel_nibble"]
        b = base.boost_more(5, X=X, y=y)
        refit_launches["boost_more"] = (
            HK.LAUNCHES["_hist_kernel_nibble"] - n0,
            b.train_info["histograms"])
        return json_scoring_pipeline(as_model(b), drift_monitor=(
            DriftMonitor.from_matrix(X[:CP_CHUNK_ROWS])))

    def flipped(window, active):
        X, y = window_xy(window)
        n0 = HK.LAUNCHES["_hist_kernel_nibble"]
        m = TPUBoostClassifier(numIterations=5, numLeaves=63,
                               device=dev.type).fit(
            DataTable({"features": X, "label": 1.0 - y}))
        refit_launches["flipped"] = (
            HK.LAUNCHES["_hist_kernel_nibble"] - n0,
            m.get_booster().train_info["histograms"])
        return json_scoring_pipeline(m)

    # ---- (a) the closed loop ------------------------------------------------
    rec = FlightRecorder(min_interval_s=0.0)
    engine = serve_model(
        json_scoring_pipeline(model255, drift_monitor=(
            DriftMonitor.from_matrix(Xtr[:CP_CHUNK_ROWS]))),
        port=0, batch_size=256, workers=2, max_wait_ms=5, version="v1",
        flight_recorder=rec)
    registry = ModelRegistry()
    trainer = ContinuousTrainer(
        engine, refit, window=ReplayWindow(max_rows=CP_WINDOW_ROWS),
        registry=registry,
        triggers=TriggerPolicy(max_mean_delta_sigma=2.0,
                               min_window_rows=CP_CHUNK_ROWS,
                               cooldown_s=0.5, watch_slo_alerts=False),
        gate=GatePolicy(shadow_rows=512),
        canary=CanaryPolicy(fraction=0.5, min_batches=3),
        warmup_example={"features": Xte[:1]}, poll_interval_s=0.05)
    rows = np.concatenate([Xte[:CP_STEADY], Xh[:CP_DRIFT_RUN]])
    load = None
    records = []
    try:
        load = FleetLoad([engine.source.address], rows)
        trainer.start()
        steady, _ = load.run(range(CP_STEADY), CP_CLIENTS)
        records += steady
        for lo in range(0, CP_WINDOW_ROWS, CP_CHUNK_ROWS):
            trainer.ingest(DataTable({
                "features": Xw[lo:lo + CP_CHUNK_ROWS],
                "label": yw[lo:lo + CP_CHUNK_ROWS]}))
        snap = trainer.window.snapshot()
        HK.reset_launches()
        wall0 = time.time() - time.monotonic()   # event .at -> monotonic
        t_drift = time.monotonic()
        drifted = []
        deadline = t_drift + 120.0
        while trainer.promotions + trainer.quarantines \
                + trainer.refit_failures == 0 \
                and time.monotonic() < deadline:
            recs, _ = load.run(range(CP_STEADY, CP_STEADY + CP_DRIFT_RUN),
                               CP_CLIENTS)
            drifted += recs
        ended = cycle_ended(("promoted", "quarantined", "refit_failed",
                             "circuit_open"), 1)
        launches = dict(HK.LAUNCHES)
        check(ended and trainer.promotions == 1,
              f"(18a) no promotion: {trainer.status()} "
              f"{[(e.kind, e.reason) for e in trainer.history]}")
        after, _ = load.run(range(CP_STEADY, CP_STEADY + CP_DRIFT_RUN),
                            CP_CLIENTS)
        records += drifted + after
        ev = {e.kind: e for e in registry.events}
        kinds = [e.kind for e in registry.events]
        want = ["triggered", "refit_ok", "shadow_pass", "promote_started",
                "promoted"]
        it = iter(kinds)
        check(all(k in it for k in want),
              f"(18a) timeline {kinds} lacks {want} in order")
        check(engine.model_version == "ct-1",
              f"(18a) serving {engine.model_version}")
        n_launch, n_hist = refit_launches["boost_more"]
        on_card = n_hist if dev.type == "cuda" else 0
        check(n_hist > 0 and n_launch == on_card
              and launches["_hist_kernel_nibble"] == on_card
              and launches["_hist_kernel"] == 0,
              f"(18a) refit launched {launches} / {n_launch} for "
              f"{n_hist} histograms")
        cand = engine._active.pipeline.model.get_booster()
        t0 = time.perf_counter()
        Xs, ys = window_xy(snap)
        direct = base.boost_more(5, X=Xs, y=ys)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        direct_s = time.perf_counter() - t0
        check(cand.model_to_string() == direct.model_to_string(),
              "(18a) the trainer-thread candidate is not bitwise the "
              "direct boost_more over the same snapshot")
        plain_base = copy.copy(base)
        plain_base.params = {**base.params, "hist_method": "scatter"}
        plain = plain_base.boost_more(5, X=Xs, y=ys)
        hold = DataTable({"features": Xh})
        p_base = np.asarray(model255.transform(hold)["probability"])[:, 1]
        cmodel = as_model(cand)
        out_c = cmodel.transform(hold)
        p_cand = np.asarray(out_c["probability"])[:, 1]
        p_plain = np.asarray(as_model(plain).transform(hold)[
            "probability"])[:, 1]
        auc_b, auc_c, auc_p = (auc(yh, p_base), auc(yh, p_cand),
                               auc(yh, p_plain))
        check(abs(auc_c - auc_p) < 0.005,
              f"(18a) candidate AUC {auc_c:.5f} vs plain scatter "
              f"{auc_p:.5f}")
        check(auc_c > auc_b, f"(18a) candidate AUC {auc_c:.5f} <= base "
              f"{auc_b:.5f} on the drifted holdout")
        errors = [r for r in records if r[4] is not None]
        avail = 1 - len(errors) / len(records)
        check(not errors, f"(18a) availability {avail:.4f}: {errors[:3]}")
        # replies sent after the cutover: the candidate's batched
        # prediction of their row, but where the raw score is a near tie
        t_prom = ev["promoted"].at - wall0
        raw_c = np.asarray(out_c["rawPrediction"])[:, 1]
        pred_c = np.asarray(out_c["prediction"]).astype(int)
        late = [r for r in records if r[2] > t_prom]
        ties = [r for r in late if abs(raw_c[r[0] - CP_STEADY]) <= NEAR_TIE]
        bad = [r for r in late if abs(raw_c[r[0] - CP_STEADY]) > NEAR_TIE
               and r[1]["prediction"] != pred_c[r[0] - CP_STEADY]]
        check(late and not bad, f"(18a) {len(bad)} of {len(late)} replies "
              f"after the cutover are not the candidate's: {bad[:3]}")
        t_trig = ev["triggered"].at - wall0
        during = [r for r in drifted if r[2] >= t_trig and r[3] <= t_prom]
        refit_ms = ev["refit_ok"].stats["refit_ms"]
        verdict = ev["shadow_pass"].stats
        status, _, body = _http(engine.source.address + "/healthz")
        health = json.loads(body)
        cp = health.get("controlplane", {})
        check(status == 200 and cp.get("state") == "idle"
              and cp.get("promotions") == 1 and not cp.get("degraded"),
              f"(18a) /healthz controlplane {cp}")
        text = _http(engine.source.address + "/metrics")[2].decode()
        violations = metrics_check.audit_text(text)
        for fam in ("serving_drift_rows", "serving_drift_score",
                    "serving_controlplane_promotions_total",
                    "serving_controlplane_phase_ms"):
            check(fam in text, f"(18a) /metrics lacks {fam}")
        check(not violations, f"(18a) metrics_check: {violations[:3]}")
        print(f"controlplane (a): {CP_STEADY} steady then "
              f"{len(drifted) + len(after)} drifted one-row requests from "
              f"{CP_CLIENTS} threads of a spawned process (batch 256, 2 "
              f"workers, 5 ms); timeline {kinds}; trigger "
              f"{ev['triggered'].reason!r}; refit boost_more(5) over "
              f"{snap.num_rows} window rows on the trainer thread in "
              f"{refit_ms:.1f} ms under the load ({cand.train_timing}), "
              f"the same refit alone on this thread {direct_s:.3f} s "
              f"({direct.train_timing}); hist launches {launches} "
              f"({n_hist} histograms), candidate bitwise the direct "
              f"boost_more; gate {verdict}; drifted holdout AUC base "
              f"{auc_b:.5f} -> candidate {auc_c:.5f} (plain scatter "
              f"refit {auc_p:.5f}); reaction {t_prom - t_drift:.3f} s from "
              f"drift onset to the candidate serving (trigger at "
              f"{t_trig - t_drift:.3f} s); client steady "
              f"{_lat_numbers(steady)}, during refit and cutover "
              f"{_lat_numbers(during)}, after {_lat_numbers(after)}; "
              f"availability {avail:.4f} over {len(records)} requests; "
              f"{len(late)} replies after the cutover the candidate's "
              f"({len(ties)} near ties left out); /healthz controlplane "
              f"state {cp.get('state')} promotions {cp.get('promotions')}; "
              f"/metrics drift and control-plane families, metrics_check "
              f"violations {len(violations)}")

        # the label-flipped refit is quarantined; serving is unchanged
        trainer.refit = flipped
        q0 = trainer.quarantines
        n0 = len(trainer.history)
        trainer.trigger_now("label-flip drill")
        cycle_ended(("promoted", "quarantined", "refit_failed",
                     "circuit_open"), n0)
        kinds = [e.kind for e in registry.events]
        q = trainer.quarantined.get("ct-2", {})
        check(trainer.quarantines == q0 + 1 and trainer.promotions == 1
              and q.get("bundle") is not None
              and kinds[-2:] == ["shadow_fail", "quarantined"],
              f"(18a) label flip: {trainer.status()} {kinds[-4:]}")
        check(engine.model_version == "ct-1",
              f"(18a) serving {engine.model_version} after the quarantine")
        fl_launch, fl_hist = refit_launches["flipped"]
        check(fl_hist > 0
              and fl_launch == (fl_hist if dev.type == "cuda" else 0),
              f"(18a) flipped fit {fl_launch} launches / {fl_hist}")
        print(f"controlplane (a): label-flipped refit (a fresh 5 x 63 fit "
              f"on flipped labels, {fl_launch} hist launches) "
              f"{q['verdict']['reason']!r} -> {kinds[-2:]}, bundle "
              f"{q['bundle']['reason'][:60]!r}; serving still "
              f"{engine.model_version}")
    finally:
        trainer.stop()
        if load is not None:
            code = load.close()
            check(code == 0, f"(18a) the spawned client exited {code}")
        engine.stop()
        rec.close()
    t_a = time.perf_counter() - t_phase

    # ---- (b) host transports --------------------------------------------------
    os.makedirs(CONTROLPLANE_DIR, exist_ok=True)
    path = os.path.join(CONTROLPLANE_DIR, "model255.txt")
    with open(path, "w") as f:
        f.write(base.model_to_string())
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mmlspark_tpu_torch.testing.serving_worker",
         "0", str(wid), "--scorer", "forest", "--model", path,
         "--device", dev.type, "--batch-size", "64", "--workers", "1"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for wid in range(FABRIC_PROCS)]
    fleets = {}
    try:
        addrs = []
        for p in procs:
            parts = p.stdout.readline().split()
            check(parts[:1] == ["READY"], f"(18b) worker said {parts}: "
                  f"{p.stderr.read()[-2000:] if p.poll() is not None else ''}")
            addrs.append(parts[2])
        spawn_s = time.perf_counter() - t0
        block = Xte[:FABRIC_ROWS]
        want = np.asarray(model255.transform(DataTable(
            {"features": block}))["prediction"]).astype(int).tolist()
        fleets = {shm: ServingFleet.connect(addrs, shm_transport=shm,
                                            tracing=False, wait_ready_s=30)
                  for shm in (True, False)}
        turns = []
        for shm in (True, False, False, True):
            turns.append((shm, _fabric_run(fleets[shm], Xte)))
            check(not turns[-1][1]["failed"],
                  f"(18b) shm={shm}: {turns[-1][1]['failed'][:3]}")
        runs = {shm: {"rows_per_s": round(float(np.mean(
            [t["rows_per_s"] for s_, t in turns if s_ == shm])), 1)}
            for shm in (True, False)}
        replies = {shm: [fleets[shm].post_columns({"features": block})[
            "prediction"] for _ in range(len(addrs))]
            for shm in (True, False)}
        fleet = fleets[True]
        ring = fleet._shm_ring
        text = fleet.metrics_text()
        batches = [float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
                   if ln.startswith("serving_shm_batches_total ")]
        check(fleet._shm_fallbacks == 0 and batches and batches[0] > 0,
              f"(18b) shm fallbacks {fleet._shm_fallbacks}, "
              f"serving_shm_batches_total {batches}")
        check(fleets[False]._shm_ring is None,
              "(18b) the HTTP client made a ring")
        check(sorted(ring._free) == list(range(ring.nslots))
              and not ring._quarantine,
              f"(18b) ring slots free {ring._free}, quarantined "
              f"{ring._quarantine}")
        seg = ring.name
        for f in fleets.values():
            f.stop_all()
        check(not os.path.exists(f"/dev/shm/{seg}"),
              f"(18b) /dev/shm/{seg} outlived stop_all")
        for shm in (True, False):
            check(all(r == want for r in replies[shm]),
                  f"(18b) shm={shm}: replies differ from the in-process "
                  "batched transform")
        ratio = runs[True]["rows_per_s"] / max(runs[False]["rows_per_s"],
                                               1e-9)
        shown = [("shm" if shm else "HTTP+msgpack",
                  {k: v for k, v in t.items() if k != "failed"})
                 for shm, t in turns]
        print(f"controlplane (b): {FABRIC_PROCS} engine processes "
              f"(testing/serving_worker.py --scorer forest --device "
              f"{dev.type}, "
              f"batch 64, 1 worker) up in {spawn_s:.1f} s; "
              f"{FABRIC_CLIENTS} clients x {FABRIC_ROWS}-row post_columns, "
              f"turns of {FABRIC_WARM_S} s warm + {FABRIC_LOAD_S} s: "
              f"{shown}; mean rows/s shm {runs[True]['rows_per_s']}, "
              f"HTTP+msgpack {runs[False]['rows_per_s']}, shm / HTTP "
              f"{ratio:.3f}; shm fallbacks 0; replies "
              f"of both transports bitwise each other's and the in-process "
              f"transform's; every slot free; the segment unlinked; shm "
              f"stats {SHM.stats()}")
    finally:
        for fleet in fleets.values():
            fleet.stop_all()
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        shutil.rmtree(CONTROLPLANE_DIR, ignore_errors=True)
    check(all(p.returncode is not None for p in procs),
          "(18b) a worker process outlived the phase")
    print(f"controlplane: phase 18 took {time.perf_counter() - t_phase:.1f} "
          f"s ((a) {t_a:.1f} s); card: {smi}")
    return {"hist": {"_hist_kernel_nibble": n_launch + fl_launch,
                     "_hist_kernel": 0}}


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from mmlspark_tpu_torch import _build
        from mmlspark_tpu_torch.core.table import DataTable
        from mmlspark_tpu_torch.gbdt import hist_kernels as HK
        from mmlspark_tpu_torch.gbdt.binning import BinMapper
        from mmlspark_tpu_torch.gbdt.estimators import TPUBoostClassifier
        from mmlspark_tpu_torch.models.learner import TPULearner
        from mmlspark_tpu_torch.models.networks import build_network
        from mmlspark_tpu_torch.models.tpu_model import TPUModel
        from mmlspark_tpu_torch.ops import flash_attention as FA
        from mmlspark_tpu_torch.profile_hist import (
            bincount_call, device_ms, hist_bound_ms, hist_inputs, time_ms)
        from mmlspark_tpu_torch.profile_train import (
            BATCH as TRAIN_BATCH, slice_table)
        from mmlspark_tpu_torch.profile_transform import (
            BATCH as LM_BATCH, LM_SPEC, ROWS as LM_ROWS)
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    for name, (secs, log) in built.items():
        print(f"build: {_build.source_of(name)} built in {secs:.1f} s")
    print(f"build: all kernels ready in {time.perf_counter() - t0:.1f} s "
          f"({len(built)} compiled); card: {smi}")
    # registers, spills and tensor-core instructions of every flash kernel
    for lib, tcs in TC_KERNELS.items():
        ptx = ptxas_table(_build.build_log(lib))
        check(bool(ptx), f"no -Xptxas -v output kept for {lib}")
        hmma = hmma_counts(_build.library_path(lib))
        for kname in sorted(set(ptx) | set(hmma)):
            regs, sst, sld, sm = ptx.get(kname, [0, 0, 0, 0])
            print(f"build: {kname}: {regs} registers, spill stores {sst} B "
                  f"/ loads {sld} B, {sm} B static smem, "
                  f"{hmma.get(kname, 0)} HMMA")
            if kname.startswith(tcs):
                check(hmma.get(kname, 0) > 0,
                      f"{kname} runs no tensor-core (HMMA) instruction")
            if kname in TC_AT_128:
                check(sst == 0 and sld == 0,
                      f"{kname} spills at D = 128 ({sst} / {sld} B)")
        for tc in tcs:
            check(any(n.startswith(tc) for n in hmma),
                  f"no {tc} kernel in the SASS of {lib}")
    for kname, lib, entry in OCCUPANCY:
        occ = (ctypes.c_int * 2)()
        err = getattr(_build.load(lib), entry)(128, occ)
        check(err == 0 and occ[0] > 0, f"{entry}: cudaError_t {err}, "
              f"{occ[0]} blocks per SM")
        print(f"build: {kname}: {occ[0]} blocks per SM, {occ[1]} B of "
              "dynamic shared memory each")

    # ---- data and the main path's bin counts -----------------------------
    X, y = higgs_shape(N_TRAIN + N_TEST)
    Xtr, ytr, Xte, yte = X[:N_TRAIN], y[:N_TRAIN], X[N_TRAIN:], y[N_TRAIN:]
    b255 = int(BinMapper.fit(Xtr, max_bin=255).num_bins.max())
    b63 = int(BinMapper.fit(Xtr, max_bin=63).num_bins.max())
    print(f"data: {Xtr.shape} train, {Xte.shape} holdout; main-path bins "
          f"B={b255} (max_bin 255), B={b63} (max_bin 63)")

    # ---- 2. kernels vs their plain versions ------------------------------
    t_phase = time.perf_counter()
    plan = HK.launch_plan(28, N_TRAIN, 1, b255)
    occ = ctypes.c_int(0)
    err = _build.load("hist").mml_hist_occupancy(
        plan.n_warps, plan.smem_bytes, ctypes.byref(occ))
    check(err == 0 and occ.value > 0, f"mml_hist_occupancy: cudaError_t "
          f"{err}, {occ.value} blocks per SM")
    for kname, (regs, sst, sld, sm) in sorted(
            ptxas_table(_build.build_log("hist")).items()):
        print(f"build: {kname}: {regs} registers, spill stores {sst} B / "
              f"loads {sld} B, {sm} B static smem")
    print(f"kernel hist plan at (F=28, N={N_TRAIN}, L=1, B={b255}): {plan}; "
          f"{occ.value} blocks per SM")

    measured = {}
    # (F, N, L, B, stats type, active share, skew); the timed cases are
    # keyed by what they stand for in `measured`: the 80 %-active cases at
    # the main path's bin counts (as before), a fit's root (every row), a
    # fit's mean masked right child (a scattered 5 % of the rows), and the
    # skewed worst case (90 % of each feature's rows in bin 0, at a root)
    shapes = [(28, N_TRAIN, 1, 256, torch.float32, 0.8, None),
              (28, N_TRAIN, 1, 64, torch.float32, 0.8, None),
              (20, 700, 6, 16, torch.float32, 0.8, None),
              (28, N_TRAIN, 1, 256, torch.int16, 0.8, None),
              (28, N_TRAIN, 1, 256, torch.int8, 0.8, None),
              (28, N_TRAIN, 1, b255, torch.float32, 0.8, None),
              (28, N_TRAIN, 1, b63, torch.float32, 0.8, None),
              (28, N_TRAIN, 1, b255, torch.float32, 1.0, None),
              (28, N_TRAIN, 1, b255, torch.float32, 0.05, None)]
    shapes += [(28, N_TRAIN, 1, b255, sdt, 1.0, skew)
               for skew in ("bin0_90", "binary", "constant")
               for sdt in (torch.float32, torch.int16, torch.int8)]
    # the quantized fits' launches (phase 7): int16 at max_bin 255, int8
    # at max_bin 63, each at a root and at the 5 % child
    shapes += [(28, N_TRAIN, 1, B, sdt, active, None)
               for B, sdt in ((b255, torch.int16), (b63, torch.int8))
               for active in (1.0, 0.05)]
    f32 = torch.float32
    timed = {(28, N_TRAIN, 1, b255, f32, 0.8, None): b255,
             (28, N_TRAIN, 1, b63, f32, 0.8, None): b63,
             (28, N_TRAIN, 1, b255, f32, 1.0, None): "root",
             (28, N_TRAIN, 1, b255, f32, 0.05, None): "child",
             (28, N_TRAIN, 1, b255, f32, 1.0, "bin0_90"): "bin0_90",
             (28, N_TRAIN, 1, b255, torch.int16, 1.0, None): "root_i16",
             (28, N_TRAIN, 1, b255, torch.int16, 0.05, None): "child_i16",
             (28, N_TRAIN, 1, b63, torch.int8, 1.0, None): "root_i8",
             (28, N_TRAIN, 1, b63, torch.int8, 0.05, None): "child_i8"}
    for i, (F, N, L, B, sdt, active, skew) in enumerate(shapes):
        bins, grad, hess, w, leaf, cv = hist_inputs(
            dev, F, N, L, B, sdt, seed=i, active=active, skew=skew)
        out = HK.hist_device(bins, grad, hess, w, leaf, L, B, cv)
        again = HK.hist_device(bins, grad, hess, w, leaf, L, B, cv)
        torch.cuda.synchronize()
        check(torch.equal(out, again),
              f"two launches differ at {(F, N, L, B)} {sdt} {active} {skew}")
        tag = (f"kernel {str(sdt).split('.')[-1]} (F={F}, N={N}, L={L}, "
               f"B={B}" + (f", {100 * active:g} % active" if active != 0.8
                           else "") + (f", bins {skew}" if skew else "")
               + ")")
        if sdt == torch.float32:
            ref = HK.hist_plain(bins, grad.double(), hess.double(),
                                w.double(), leaf, L, B)
            err = float((out.double() - ref).abs().max())
            ok = torch.allclose(out.double(), ref, rtol=1e-5, atol=1e-3)
            check(ok, f"{tag}: max_abs_err {err} beyond rtol 1e-5 atol 1e-3")
            print(f"{tag}: max_abs_err {err:.3e} vs float64 plain "
                  "(rtol 1e-5, atol 1e-3); repeat launch bitwise equal")
        else:
            ref = HK.hist_plain(bins, grad, hess, w, leaf, L, B, cv)
            err = float((out.long() - ref.long()).abs().max())
            check(torch.equal(out, ref), f"{tag}: int sums differ ({err})")
            print(f"{tag}: bitwise equal to the plain version (exact "
                  "int32); repeat launch bitwise equal")
        key = timed.get((F, N, L, B, sdt, active, skew))
        if key is not None:
            lib = bincount_call(bins, grad, hess, w, leaf, L, B, cv)
            k_ms = time_ms(lambda: HK.hist_device(bins, grad, hess, w, leaf,
                                                  L, B, cv))
            p_ms = time_ms(lambda: HK.hist_plain(bins, grad, hess, w, leaf,
                                                 L, B, cv))
            l_ms = time_ms(lib)
            d_ms, _ = device_ms(lambda: HK.hist_device(
                bins, grad, hess, w, leaf, L, B, cv))
            bd, by = hist_bound_ms(F, N, w, L, B, sdt, cv is not None)
            measured[key] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                                 library_ms=l_ms, bound_ms=bd, bound_by=by)
            print(f"{tag}: kernel {k_ms:.4f} ms (device time {d_ms:.4f} ms, "
                  f"torch.profiler), plain index_add_ {p_ms:.4f} ms, "
                  f"bincount {l_ms:.4f} ms, bound {bd:.4f} ms ({by})")
            del lib
        del bins, grad, hess, w, leaf, cv, out, again, ref
    torch.cuda.empty_cache()

    print(f"chip_smoke: phase 2 took {time.perf_counter() - t_phase:.1f} s")
    # ---- 2b. flash-attention kernel vs its plain version -----------------
    t_phase = time.perf_counter()
    def flash_bound_ms(case, dtype):
        """Least time on these inputs: q, k, v read once and O, LSE
        written once at the memory rate, or 4*D flops per unmasked
        (query, key) pair at the input type's tensor-core peak (f32:
        3xTF32), whichever is larger."""
        b, lq, lk, h, d, causal, qo, ko = case
        item = torch.tensor([], dtype=dtype).element_size()
        pairs = lq * lk
        if causal:
            pairs = int(np.clip(np.arange(lq) + qo - ko + 1, 0, lk).sum())
        nbytes = item * b * h * d * (2 * lq + 2 * lk) + 4 * b * h * lq
        rate = (F32_CONTRACT_OPS_PER_S if dtype == torch.float32
                else BF16_OPS_PER_S)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = 4 * d * pairs * b * h / rate
        return (1e3 * max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")

    sdpa = torch.nn.functional.scaled_dot_product_attention

    def flash_qkv(case, dtype, g, unaligned):
        """q, k, v of a case; unaligned: views one element into rows of
        D + 1, so that no row starts on a 16-byte boundary."""
        b, lq, lk, h, d = case[:5]
        e = int(unaligned)
        return tuple(torch.randn((b, n, h, d + e), generator=g, device=dev
                                 ).to(dtype)[..., e:] for n in (lq, lk, lk))

    def sdpa_on(case, q, k, v, dout=None):
        """SDPA on the same inputs, masked on the same global positions:
        out, or (dq, dk, dv) for the output gradient dout. A yardstick of
        accuracy only; the port never calls it."""
        lq, lk, causal, qo, ko = case[1], case[2], *case[5:]
        mask = None
        if causal:
            mask = (torch.arange(lq, device=dev)[:, None] + qo
                    >= torch.arange(lk, device=dev)[None, :] + ko)
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(
            dout is not None) for t in (q, k, v))
        out = sdpa(qt, kt, vt, attn_mask=mask)
        if dout is None:
            return out.detach().transpose(1, 2)
        grads = torch.autograd.grad(out, (qt, kt, vt), dout.transpose(1, 2))
        return tuple(x.transpose(1, 2) for x in grads)

    def err_of(x, ref):
        """max |x - ref| over finite entries, and the non-finite count
        (SDPA gives NaN on rows whose keys are all masked)."""
        dx = (x.double() - ref).abs()
        fin = torch.isfinite(dx)
        return (float(dx[fin].max()) if bool(fin.any()) else float("nan"),
                int((~fin).sum()))

    def sdpa_note(errs):
        return "; SDPA max_abs_err " + ", ".join(
            f"{n} {e:.3e}" + (f" ({bad} non-finite)" if bad else "")
            for n, (e, bad) in errs.items())

    flash_all = ([(c, False) for c in FLASH_CASES]
                 + [(FLASH_UNALIGNED, True)])
    flash_measured = {}
    for ci, (case, unaligned) in enumerate(flash_all):
        b, lq, lk, h, d, causal, qo, ko = case
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(100 + ci)
            q, k, v = flash_qkv(case, dtype, g, unaligned)
            out, lse = FA.flash_forward(q, k, v, causal, qo, ko)
            out2, lse2 = FA.flash_forward(q, k, v, causal, qo, ko)
            torch.cuda.synchronize()
            tag = (f"flash {str(dtype).split('.')[-1]} (B={b}, Lq={lq}, "
                   f"Lk={lk}, H={h}, D={d}, causal={causal}, "
                   f"offsets={qo}/{ko}{', unaligned views' * unaligned})")
            check(torch.equal(out, out2) and torch.equal(lse, lse2),
                  f"{tag}: two launches differ")
            rout, rlse = FA.flash_forward_plain(q.double(), k.double(),
                                                v.double(), causal, qo, ko)
            err = float((out.double() - rout).abs().max())
            lerr = float((lse.double() - rlse).abs().max()
                         / max(1.0, float(rlse.abs().max())))
            rtol, atol = ((1e-4, 1e-4) if dtype == torch.float32
                          else (2 ** -8, 1e-5))
            check(torch.allclose(out.double(), rout, rtol=rtol, atol=atol),
                  f"{tag}: out max_abs_err {err} beyond rtol {rtol} "
                  f"atol {atol}")
            check(torch.allclose(lse.double(), rlse, rtol=1e-4, atol=1e-4),
                  f"{tag}: lse beyond rtol 1e-4 atol 1e-4")
            note = ("" if dtype == torch.float32 else sdpa_note(
                {"out": err_of(sdpa_on(case, q, k, v), rout)}))
            print(f"{tag}: out max_abs_err {err:.3e} vs float64 plain "
                  f"(rtol {rtol:g}, atol {atol:g}), lse rel err "
                  f"{lerr:.1e}; repeat launch bitwise equal{note}")
            if case == FLASH_MAIN:
                qt, kt, vt = (t.transpose(1, 2).contiguous()
                              for t in (q, k, v))
                k_ms = time_ms(lambda: FA.flash_forward(q, k, v, causal))
                p_ms = time_ms(lambda: FA.flash_forward_plain(q, k, v,
                                                              causal))
                l_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
                bd, by = flash_bound_ms(case, dtype)
                flash_measured[dtype] = dict(
                    max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                    bound_ms=bd, bound_by=by)
                print(f"{tag}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                      f"SDPA {l_ms:.4f} ms, bound {bd:.4f} ms ({by})")
                del qt, kt, vt
            del q, k, v, out, lse, out2, lse2, rout, rlse
    torch.cuda.empty_cache()

    print(f"chip_smoke: phase 2b took {time.perf_counter() - t_phase:.1f} s")
    # ---- 2c. flash-attention backward kernels vs their plain version -----
    t_phase = time.perf_counter()
    def flash_bwd_bound_ms(case, dtype, kernel):
        """Least time on these inputs: q, k, v, dO read once with LSE and
        delta, and the kernel's outputs (dQ, or dK and dV) written once,
        at the memory rate; or its flops per unmasked pair (6·D for dQ,
        8·D for dK and dV) at the input type's tensor-core peak (f32:
        3xTF32); whichever is larger."""
        b, lq, lk, h, d, causal, qo, ko = case
        item = torch.tensor([], dtype=dtype).element_size()
        outs = lq if kernel == "_dq_kernel" else 2 * lk
        nbytes = (item * b * h * d * (2 * lq + 2 * lk + outs)
                  + 2 * 4 * b * h * lq)
        rate = (F32_CONTRACT_OPS_PER_S if dtype == torch.float32
                else BF16_OPS_PER_S)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = (FA.FLOPS_PER_PAIR[kernel] * d * b * h
                 * FA.unmasked_pairs(lq, lk, causal, qo, ko) / rate)
        return (1e3 * max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")

    bwd_measured = {}
    for ci, (case, unaligned) in enumerate(flash_all):
        b, lq, lk, h, d, causal, qo, ko = case
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(200 + ci)
            q, k, v = flash_qkv(case, dtype, g, unaligned)
            out, lse = FA.flash_forward(q, k, v, causal, qo, ko)
            dout = torch.randn(out.shape, generator=g, device=dev).to(dtype)
            got = FA.flash_backward(q, k, v, out, lse, dout, causal, qo, ko)
            again = FA.flash_backward(q, k, v, out, lse, dout, causal, qo,
                                      ko)
            torch.cuda.synchronize()
            tag = (f"flash bwd {str(dtype).split('.')[-1]} (B={b}, Lq={lq}, "
                   f"Lk={lk}, H={h}, D={d}, causal={causal}, "
                   f"offsets={qo}/{ko}{', unaligned views' * unaligned})")
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"{tag}: two launches differ")
            ref = FA.flash_backward_plain(q.double(), k.double(), v.double(),
                                          out.double(), lse.double(),
                                          dout.double(), causal, qo, ko)
            rtol, atol = ((1e-4, 1e-4) if dtype == torch.float32
                          else (2 ** -8, 1e-5))
            errs = {}
            for name, x, r in zip(("dq", "dk", "dv"), got, ref):
                errs[name] = float((x.double() - r).abs().max())
                check(torch.allclose(x.double(), r, rtol=rtol, atol=atol),
                      f"{tag}: {name} max_abs_err {errs[name]} beyond rtol "
                      f"{rtol} atol {atol}")
            note = ("" if dtype == torch.float32 else sdpa_note(
                {n: err_of(x, r) for n, x, r in zip(
                    ("dq", "dk", "dv"), sdpa_on(case, q, k, v, dout), ref)}))
            print(f"{tag}: max_abs_err dq {errs['dq']:.3e} dk "
                  f"{errs['dk']:.3e} dv {errs['dv']:.3e} vs float64 plain "
                  f"(rtol {rtol:g}, atol {atol:g}); repeat launch bitwise "
                  f"equal{note}")
            if case == FLASH_MAIN:
                args = (q, k, v, out, lse, dout, causal)
                delta = FA.flash_delta(out, dout)
                kargs = (q, k, v, dout, lse, delta, causal)
                qt, kt, vt = (t.transpose(1, 2).contiguous()
                              .requires_grad_(True) for t in (q, k, v))
                sdpa_out = torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True)
                g_t = dout.transpose(1, 2).contiguous()
                dq_ms = time_ms(lambda: FA.flash_dq_cuda(*kargs))
                dkv_ms = time_ms(lambda: FA.flash_dkv_cuda(*kargs))
                p_ms = time_ms(lambda: FA.flash_backward_plain(*args))
                l_ms = time_ms(lambda: torch.autograd.grad(
                    sdpa_out, (qt, kt, vt), g_t, retain_graph=True))
                for kernel, ms, err in (
                        ("_dq_kernel", dq_ms, errs["dq"]),
                        ("_dkv_kernel", dkv_ms, max(errs["dk"], errs["dv"]))):
                    bd, by = flash_bwd_bound_ms(case, dtype, kernel)
                    bwd_measured[(kernel, dtype)] = dict(
                        max_abs_err=err, ms=ms, plain_ms=p_ms,
                        library_ms=l_ms, bound_ms=bd, bound_by=by)
                    print(f"{tag}: {kernel} {ms:.4f} ms, bound {bd:.4f} ms "
                          f"({by})")
                print(f"{tag}: plain backward (dq, dk, dv) {p_ms:.4f} ms, "
                      f"SDPA backward (dq, dk, dv) {l_ms:.4f} ms")
                del qt, kt, vt, sdpa_out, g_t, args, kargs, delta
            del q, k, v, out, lse, dout, got, again, ref
    torch.cuda.empty_cache()

    print(f"chip_smoke: phase 2c took {time.perf_counter() - t_phase:.1f} s")
    # ---- 3. the GBDT slice end to end ------------------------------------
    t_phase = time.perf_counter()
    train_t = DataTable({"features": Xtr, "label": ytr})
    test_t = DataTable({"features": Xte, "label": yte})

    def fit_transform(label, expect_route, **kw):
        HK.reset_launches()
        t0 = time.perf_counter()
        model = TPUBoostClassifier(numIterations=5, numLeaves=63,
                                   **kw).fit(train_t)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = model.transform(test_t)
        tr_s = time.perf_counter() - t0
        launches = dict(HK.LAUNCHES)
        prob = np.asarray(out["probability"])
        raw = np.asarray(out["rawPrediction"])
        check(prob.shape == (N_TEST, 2) and raw.shape == (N_TEST, 2),
              f"{label}: output shapes {prob.shape} {raw.shape}")
        check(np.isfinite(prob).all() and np.isfinite(raw).all(),
              f"{label}: non-finite outputs")
        check(((prob >= 0) & (prob <= 1)).all(),
              f"{label}: probabilities outside [0, 1]")
        check(set(np.unique(out["prediction"])) <= {0.0, 1.0},
              f"{label}: predictions not in {{0, 1}}")
        a = auc(yte, prob[:, 1])
        booster = model.get_booster()
        if expect_route is None:
            check(sum(launches.values()) == 0,
                  f"{label}: the plain path launched the kernel {launches}")
        else:
            check(booster.params["hist_method"] == "pallas",
                  f"{label}: hist_method {booster.params['hist_method']}")
            check(launches[expect_route] >= 5 * 63,
                  f"{label}: {launches[expect_route]} launches of "
                  f"{expect_route} < 5 x 63")
        print(f"slice {label}: fit {fit_s:.2f} s "
              f"({booster.train_timing}), transform {tr_s:.3f} s, holdout "
              f"AUC {a:.5f}, launches {launches}")
        return a, launches, model, out

    auc255, l255, model255, out255 = fit_transform(
        "max_bin=255 kernel", "_hist_kernel_nibble", histMethod="auto")
    auc63, l63, _, _ = fit_transform("max_bin=63 kernel", "_hist_kernel",
                                     maxBin=63, histMethod="auto")
    auc_plain, _, _, _ = fit_transform("max_bin=255 plain scatter", None,
                                       histMethod="scatter")
    check(abs(auc255 - auc_plain) < 0.005,
          f"kernel AUC {auc255} vs plain {auc_plain}")
    check(auc255 > 0.8, f"holdout AUC {auc255} too low: the model did not "
          "learn")
    print(f"slice: kernel vs plain holdout AUC {auc255:.5f} vs "
          f"{auc_plain:.5f} (|diff| {abs(auc255 - auc_plain):.5f} < 0.005)")

    # a small fit on the card against the same fit on the CPU (the plain
    # version): same trees unless a near-tie split flips
    small = DataTable({"features": Xtr[:20000], "label": ytr[:20000]})
    kw = dict(numIterations=5, numLeaves=15, maxBin=63)
    m_gpu = TPUBoostClassifier(device="cuda", **kw).fit(small)
    m_cpu = TPUBoostClassifier(device="cpu", **kw).fit(small)
    tg, tc = m_gpu.get_booster().trees, m_cpu.get_booster().trees
    same = all(np.array_equal(tg[k], tc[k]) for k in
               ("feature", "bin_threshold", "left", "right"))
    pg = m_gpu.transform(test_t)["probability"][:, 1]
    pc = m_cpu.transform(test_t)["probability"][:, 1]
    diff = float(np.abs(pg - pc).max())
    check(abs(auc(yte, pg) - auc(yte, pc)) < 0.005,
          "card and CPU fits disagree on holdout AUC")
    check(not same or diff < 1e-4,
          f"identical trees but predictions differ by {diff}")
    print(f"slice: 20k-row fit on the card vs on the CPU: trees identical "
          f"{same}, max |p diff| {diff:.3e}")

    print(f"chip_smoke: phase 3 took {time.perf_counter() - t_phase:.1f} s")
    # ---- 4. the DNN slice: TPUModel.transform through the full-width LM --
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = build_network(LM_SPEC, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    w_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    tokens = np.random.default_rng(7).integers(
        0, LM_SPEC["vocab_size"], size=(LM_ROWS, LM_SPEC["max_len"]))
    table = DataTable({"tokens": tokens})
    model = TPUModel.from_module(lm, device="cuda", inputCol="tokens",
                                 outputCol="logits", batchSize=LM_BATCH)
    FA.reset_launches()
    t0 = time.perf_counter()
    scored = model.transform(table)
    torch.cuda.synchronize()
    tr_s = time.perf_counter() - t0
    lm_launches = FA.LAUNCHES["_fwd_kernel"]
    n_batches = -(-LM_ROWS // LM_BATCH)
    check(lm_launches == LM_SPEC["depth"] * n_batches,
          f"LM transform launched the flash kernel {lm_launches} times, "
          f"not {LM_SPEC['depth']} x {n_batches}")
    met = model.metrics()
    logits = scored["logits"]
    want = (LM_ROWS, LM_SPEC["max_len"], LM_SPEC["vocab_size"])
    check(logits.shape == want and logits.dtype == np.float32,
          f"logits {logits.shape} {logits.dtype}, want {want} float32")
    check(bool(np.isfinite(logits).all()), "non-finite logits")
    peak = torch.cuda.max_memory_allocated()
    n_tok = LM_ROWS * LM_SPEC["max_len"]
    print(f"LM slice: {w_bytes / 1e9:.3f} GB of weights on the card "
          f"(init {init_s:.2f} s), peak device memory {peak / 1e9:.3f} GB")
    print(f"LM slice: transform {LM_ROWS} x {LM_SPEC['max_len']} tokens in "
          f"{tr_s:.3f} s ({n_tok / tr_s:.0f} tokens/s), {n_batches} batches "
          f"of {LM_BATCH}, flash launches {lm_launches}; pad_ms "
          f"{met['pad_ms']}, device_ms {met['device_ms']}")
    print(f"LM slice: readback of {logits.nbytes / 1e9:.3f} GB of f32 "
          f"logits, readback_ms {met['readback_ms']}")
    t0 = time.perf_counter()
    model.transform(table)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"LM slice: warm transform {warm_s:.3f} s "
          f"({n_tok / warm_s:.0f} tokens/s)")
    tail = model.transform(DataTable({"tokens": tokens[16:20]}))["logits"]
    tail_err = float(np.abs(tail - logits[16:20]).max())
    check(tail_err <= 1e-5, f"rows 16-19 alone differ from the full run by "
          f"{tail_err}")
    print(f"LM slice: rows 16-19 alone vs the full run: max |diff| "
          f"{tail_err:.3e} (<= 1e-5)")
    del lm, model, scored, logits, tail
    torch.cuda.empty_cache()

    # the same depth-2 f32 model on the card (flash kernel) and on the CPU
    # (its plain version); an f32 head, since a bf16 head rounds logits to
    # 2**-8 relative, above the 1e-3 held here
    spec2 = dict(LM_SPEC, depth=2, head_dtype="float32")
    m2 = build_network(spec2, device="cuda", seed=1)
    row = torch.from_numpy(tokens[:1])
    with torch.inference_mode():
        on_card = m2(row.to(dev)).cpu()
    m2 = m2.to("cpu")
    with torch.inference_mode():
        on_cpu = m2(row)
    l_diff = float((on_card - on_cpu).abs().max())
    agree = float((on_card.argmax(-1) == on_cpu.argmax(-1)).double().mean())
    check(l_diff <= 1e-3, f"depth-2 card vs CPU logits differ by {l_diff}")
    check(agree >= 0.999, f"depth-2 card vs CPU argmax agree on {agree}")
    print(f"LM slice: depth-2 f32 card vs CPU: max |logit diff| "
          f"{l_diff:.3e} (<= 1e-3), argmax equal on {100 * agree:.2f} % "
          "of positions")
    del m2, on_card, on_cpu

    print(f"chip_smoke: phase 4 took {time.perf_counter() - t_phase:.1f} s")
    # ---- 5. the training slice: TPULearner.fit of the full-width LM ------
    t_phase = time.perf_counter()
    train_rows = 32
    train_table = slice_table(train_rows)
    n_steps = 2 * train_rows // TRAIN_BATCH

    def train_slice(dtype: str) -> dict:
        """Fit the full-width LM for 2 epochs in compute type dtype; check
        the launches, losses and scores; return the flash launches. The
        tokens are random, so the loss falls only where the second epoch
        repeats rows."""
        learner = TPULearner(
            networkSpec=LM_SPEC, loss="token_cross_entropy",
            optimizer="adamw", learningRate=1e-3, batchSize=TRAIN_BATCH,
            computeDtype=dtype, dataFeed="device", epochs=2, logEvery=1)
        torch.cuda.reset_peak_memory_stats()
        FA.reset_launches()
        t0 = time.perf_counter()
        trained = learner.fit(train_table)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = dict(FA.LAUNCHES)
        want_l = LM_SPEC["depth"] * n_steps
        check(all(v == want_l for v in launches.values()),
              f"{dtype} training launched the flash kernels {launches} "
              f"times, not {want_l} each")
        losses = [h["loss"] for h in learner.history]
        check(len(losses) == n_steps and all(np.isfinite(losses)),
              f"{dtype} training losses {losses}")
        check(losses[-1] < losses[0],
              f"{dtype} training loss did not fall: {losses}")
        peak = torch.cuda.max_memory_allocated()
        tm = learner.timing
        step_s = tm["wall_s"] / tm["steps_timed"]
        tag = f"training slice {dtype}"
        print(f"{tag}: {n_steps} steps of {TRAIN_BATCH} x "
              f"{LM_SPEC['max_len']} tokens (AdamW, allow_tf32 "
              f"{torch.backends.cuda.matmul.allow_tf32}) in {fit_s:.3f} s "
              f"(build and first step included); flash launches "
              f"{launches}; peak device memory {peak / 1e9:.3f} GB")
        print(f"{tag}: losses {[round(x, 4) for x in losses]}")
        print(f"{tag}: {step_s:.4f} s per step after the first, "
              f"{tm['examples_per_sec'] * LM_SPEC['max_len']:.0f} "
              f"tokens/s; timing {tm}")
        scores = trained.transform(DataTable(
            {"features": np.asarray(train_table["features"][:4])}))["scores"]
        want = (4, LM_SPEC["max_len"], LM_SPEC["vocab_size"])
        check(scores.shape == want and bool(np.isfinite(scores).all()),
              f"{dtype}-trained model scores {scores.shape}, finite "
              f"{bool(np.isfinite(scores).all())}")
        print(f"{tag}: the returned model scores {scores.shape} finite "
              "logits")
        del learner, trained, scores
        torch.cuda.empty_cache()
        return launches

    train_launches = train_slice("bfloat16")
    # f32: the f32 flash_dq / flash_dkv (3xTF32) at the slice's shape;
    # torch keeps allow_tf32 False, so the GEMMs run strict f32
    f32_launches = train_slice("float32")

    # a depth-2 f32 model trained 2 SGD steps on the card (flash kernels)
    # and on the CPU (their plain versions) from the same weights
    import copy
    spec2 = dict(LM_SPEC, depth=2, head_dtype="float32")
    m0 = build_network(spec2, device="cpu", seed=2)
    w0 = {k: t.clone() for k, t in m0.state_dict().items()}
    toks2 = np.asarray(train_table["features"][:4, :512])
    small = DataTable({"features": toks2,
                       "label": np.roll(toks2.astype(np.int64), -1, 1)})

    def fit_small(device):
        lrn = TPULearner(moduleFactory=lambda: copy.deepcopy(m0),
                         device=device, loss="token_cross_entropy",
                         optimizer="sgd", schedule="constant",
                         learningRate=0.1, batchSize=2, epochs=1,
                         computeDtype="float32", logEvery=1)
        mod = lrn.fit(small)
        return [h["loss"] for h in lrn.history], {
            k: t.detach().cpu() for k, t in mod.get("weights").items()}
    FA.reset_launches()
    l_card, w_card = fit_small("cuda")
    check(FA.LAUNCHES["_dq_kernel"] == 4, f"depth-2 fit {FA.LAUNCHES}")
    t0 = time.perf_counter()
    l_cpu, w_cpu = fit_small("cpu")
    cpu_s = time.perf_counter() - t0
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
    upd = max(float((w_cpu[k] - w0[k]).abs().max()) for k in w0)
    w_diff = max(float((w_card[k] - w_cpu[k]).abs().max()) for k in w0)
    check(loss_rel <= 1e-4, f"depth-2 card vs CPU losses {l_card} vs "
          f"{l_cpu}")
    check(w_diff <= 1e-3 * upd, f"depth-2 card vs CPU weights differ by "
          f"{w_diff}, largest update {upd}")
    print(f"training slice: depth-2 f32, 2 SGD steps, card vs CPU ({cpu_s:.1f}"
          f" s there): losses rel diff {loss_rel:.2e} (<= 1e-4), max |weight "
          f"diff| {w_diff:.3e} vs largest update {upd:.3e} (<= 1e-3 of it)")
    del m0, w0, w_card, w_cpu

    print(f"chip_smoke: phase 5 took {time.perf_counter() - t_phase:.1f} s")
    # ---- 6. the serving slice: save, reload, serve over HTTP --------------
    t_phase = time.perf_counter()
    serving_slice(model255, out255, Xte, smi)

    print(f"chip_smoke: phase 6 took {time.perf_counter() - t_phase:.1f} s")
    # ---- 7. the GBDT training options at full width ----------------------
    t_phase = time.perf_counter()
    int_launches = training_options(train_t, test_t, Xtr, ytr, Xte, yte,
                                    auc255, smi)

    print(f"chip_smoke: phase 7 took {time.perf_counter() - t_phase:.1f} s")
    # ---- 8. GBDT ingest beyond dense input --------------------------------
    t_phase = time.perf_counter()
    ingest_routes = ingest_slice(auc255, Xtr, ytr, Xte, yte, test_t,
                                 measured, smi)

    print(f"chip_smoke: phase 8 took {time.perf_counter() - t_phase:.1f} s")
    # ---- 9. the zoo's ConvNet, ResNet and BiLSTM ---------------------------
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    zoo_slice(dev, smi)
    print(f"zoo: phase 9 took {time.perf_counter() - t0:.1f} s")

    # ---- 10. the transfer-learning image path -----------------------------
    t0 = time.perf_counter()
    image_slice(dev, smi)
    print(f"image: phase 10 took {time.perf_counter() - t0:.1f} s")

    # ---- 11. the AutoML slice ---------------------------------------------
    t0 = time.perf_counter()
    automl_row = automl_slice(dev, smi)
    print(f"automl: phase 11 took {time.perf_counter() - t0:.1f} s")

    # ---- 12. models entering and leaving the system -----------------------
    t0 = time.perf_counter()
    inter = interchange_slice(dev, smi)
    print(f"interchange: phase 12 took {time.perf_counter() - t0:.1f} s")
    for k, v in inter["bf16"].items():
        train_launches[k] += v

    # ---- 13. fused and streamed pipelines --------------------------------
    fused_launches = fused_slice(dev, smi, model255, out255, test_t)
    for k, v in fused_launches["bf16"].items():
        train_launches[k] += v

    # ---- 14. request tracing and serving telemetry -----------------------
    t0 = time.perf_counter()
    tele = telemetry_slice(smi, model255, out255, Xte)
    print(f"telemetry: phase 14 took {time.perf_counter() - t0:.1f} s")
    for k, v in tele["hist"].items():
        l255[k] += v
    for k, v in tele["flash"].items():
        train_launches[k] += v

    # ---- 15. model lifecycle and the client fleet -------------------------
    life = lifecycle_slice(dev, smi, model255, Xtr, ytr, Xte, yte, auc255)
    for k, v in life["hist"].items():
        l255[k] += v

    # ---- 16. the stage registry and AOT serving artifacts ------------------
    reg = registry_aot_slice(smi, model255, out255, Xtr, ytr, Xte)
    for k, v in reg["hist"].items():
        l255[k] += v

    # ---- 17. the multi-model plane (phase 16's LM artifact) ---------------
    try:
        multi = multimodel_slice(smi, reg["art"], reg["work"], reg["lm_ref"])
    finally:
        shutil.rmtree(reg["work"], ignore_errors=True)

    # ---- 18. the control plane and host transports ------------------------
    cp = controlplane_slice(dev, smi, model255, Xtr, ytr, Xte, yte, auc255)
    for k, v in cp["hist"].items():
        l255[k] += v
    print(json.dumps({"int8_gemms": inter["int8_gemms"]}))
    print(f"chip_smoke: all phases took {time.perf_counter() - t_start:.1f} "
          "s")

    kernels = []
    for name, route, key, launches, line in (
            (f"hist (single leaf, B={b255})", "_hist_kernel_nibble", b255,
             l255, 67),
            (f"hist (single leaf, B={b63})", "_hist_kernel", b63, l63, 117),
            (f"hist (single leaf, B={b255}, 5 % child)",
             "_hist_kernel_nibble", "child", l255, 67),
            (f"hist (single leaf, B={b255}, root)", "_hist_kernel_nibble",
             "root", l255, 67)):
        m = measured[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mmlspark_tpu_torch/csrc/hist.cu",
            "replaces": f"mmlspark_tpu/gbdt/pallas_hist.py:{line}",
            "launches": launches[route], "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"]})
    # the int16 / int8 instantiations, launched by phase 7's quantized fits
    # (b) and (c); times from phase 2
    for name, sdt, key, line in (
            (f"hist int16 (single leaf, B={b255}, root)", "int16",
             "root_i16", 67),
            (f"hist int16 (single leaf, B={b255}, 5 % child)", "int16",
             "child_i16", 67),
            (f"hist int8 (single leaf, B={b63}, root)", "int8", "root_i8",
             117),
            (f"hist int8 (single leaf, B={b63}, 5 % child)", "int8",
             "child_i8", 117)):
        m = measured[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mmlspark_tpu_torch/csrc/hist.cu",
            "replaces": f"mmlspark_tpu/gbdt/pallas_hist.py:{line}",
            "launches": int_launches[sdt], "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"]})
    # the kernel on phase 8(a)'s Bosch-shape CSR bins (F = 968), launched
    # by its CSR fit; times from phase 8(a)
    for what, key in (("root", "bosch_root"), ("5 % child", "bosch_child")):
        m = measured[key]
        kernels.append({
            "name": f"hist (single leaf, B={m['B']}, F=968 Bosch-shape "
                    f"CSR bins, {what})", "route": "cuda",
            "source": "mmlspark_tpu_torch/csrc/hist.cu",
            "replaces": "mmlspark_tpu/gbdt/pallas_hist.py:" + (
                "67" if m["route"] == "_hist_kernel_nibble" else "117"),
            "launches": ingest_routes[m["route"]],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"]})
    # the kernel on phase 11(b)'s featurized bins, launched by its
    # TrainClassifier fit; times from phase 11(b)
    kernels.append(automl_row)
    # the forward in both types: f32 on the LM transform's path, bf16
    # (the tensor-core body) on the training slice's
    for dtype, tname, launches in (
            (torch.float32, "f32",
             lm_launches + inter["f32"] + fused_launches["f32"]
             + reg["f32"] + multi["f32"]),
            (torch.bfloat16, "bf16", train_launches["_fwd_kernel"])):
        m = flash_measured[dtype]
        kernels.append({
            "name": f"flash_fwd ({tname}, B=8, L=1024, H=16, D=128, causal)",
            "route": "cuda",
            "source": "mmlspark_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "mmlspark_tpu/ops/flash_attention.py:93",
            "launches": launches, "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"]})
    # the backward in both types: bf16 on the training slice's bf16 fit,
    # f32 on its f32 fit; library_ms is SDPA's whole backward (dq, dk,
    # dv) in that type, plain_ms the whole plain backward
    for dtype, tname, launches in (
            (torch.bfloat16, "bf16", train_launches),
            (torch.float32, "f32", f32_launches)):
        for kernel, name, line in (("_dq_kernel", "flash_dq", 148),
                                   ("_dkv_kernel", "flash_dkv", 190)):
            m = bwd_measured[(kernel, dtype)]
            kernels.append({
                "name": f"{name} ({tname}, B=8, L=1024, H=16, D=128, "
                        "causal)",
                "route": "cuda",
                "source": "mmlspark_tpu_torch/csrc/flash_bwd.cu",
                "replaces": f"mmlspark_tpu/ops/flash_attention.py:{line}",
                "launches": launches[kernel],
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": m["bound_by"], "library_ms": m["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
