#!/usr/bin/env python3
"""Smoke run of torchmetrics_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failed check raises, so the exit code is
not 0 and no result line is printed:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build: compile csrc/bincount.cu and csrc/tdigest.cu with nvcc for
   sm_90a and the host library csrc/tm_native.cpp with g++ (the JAX
   package's flags), one compiler for each, started together, timed;
3. kernel: the CUDA kernel through weighted_bincount_batched (the metric
   path's batched calls) and weighted_bincount (1-D), against the plain
   PyTorch versions on the card, at the metric path's shapes, past the
   largest cluster, at the sparse plan's shape (the ImageNet-1k confusion
   matrix), at the group-fairness count of the Jigsaw path, at the
   BootStrapper's 3 x 10 rows of the composition path and at edge
   cases; each call must launch once. Timed beside the plain version, torch.bincount (a yardstick only; the package
   never calls it: its device time from a profiler trace, and its host
   round trip) and the memory-bandwidth bound. The t-digest compress kernel
   (tdigest_compress_sorted) at the sketch paths' shapes, S=1 digest of
   M=65,664 centroids and S=256 of 4,224, a decayed digest's update (S=1,
   M=65,664, non-integer weights) and a windowed metric's merge of 8 slots
   (S=1, M=1,024): one launch each, bitwise equal to its plain version run
   on the host on a copy of the inputs, weights bitwise (the decayed
   digest's within 1e-5 relative) and means within 1e-5 relative of the
   plain version on the card (whose cumsum and index_add_ add in another
   order); timed beside that plain version and its bound (no PyTorch call
   computes the same function);
4. paths: each a MetricCollection driven through update -> compute and
   through the pure init_state / update_state / compute_state API, with
   kernel launches counted over each drive, compute groups checked, states
   equal to a device="cpu" run on the same inputs bitwise and computed
   values within 1e-6 of it and of their direct definitions (matrices
   elementwise, int32 ones bitwise), and a torch.profiler breakdown of
   steady-state updates:
   - bench_config2 / imagenet1k_val: MulticlassAccuracy(micro),
     MulticlassF1Score(macro) and MulticlassAUROC(thresholds=64) at bench
     config 2's shape (C=100, batch 1024, 200 steps) and ImageNet-1k
     validation's (C=1000, batch 1000, 50 steps); 3 launches on the first
     stateful update, then 2; 2 per pure update;
   - mvtec_pixel_binary: BinaryAUROC and BinaryAveragePrecision
     (thresholds=64), BinaryPrecision, BinaryRecall, BinarySpecificity and
     BinaryF1Score over 32 score maps of 256 x 256 per update, 8 updates;
     2 launches on the first stateful update, then 1; 1 per pure update;
   - coco_multilabel: MultilabelAveragePrecision and MultilabelAUROC (macro,
     thresholds=64), MultilabelF1Score, MultilabelPrecision,
     MultilabelRecall, MultilabelHammingDistance and MultilabelExactMatch
     at 80 labels, batch 1,024, 40 updates; 2 launches, then 1; 1 per pure
     update;
   - cityscapes_miou: semantic-segmentation evaluation as mmsegmentation
     runs it on Cityscapes val: MulticlassJaccardIndex (mIoU),
     MulticlassConfusionMatrix (normalize="true"), MulticlassAccuracy
     (micro: pixel accuracy) and Dice (macro), 19 classes,
     ignore_index=255, one 1024 x 2048 image of float32 logits per update,
     10 updates; 4 launches on the first stateful update (every member runs
     before the two groups are found), then 2; 2 per pure update;
   - imagenet1k_confmat: MulticlassConfusionMatrix, MulticlassCohenKappa,
     MulticlassMatthewsCorrCoef (one confusion-matrix group, 1,000,000
     cells: the kernel's sparse plan) and MulticlassCalibrationError
     (n_bins=15) at C=1000, batch 1000, 50 updates; 3 launches, then 1; 1
     per pure update; and 1 per compute, where the calibration error bins
     its cat states;
   - imagenet1k_exact: MulticlassAUROC, MulticlassAveragePrecision and
     MulticlassRecallAtFixedPrecision(min_precision=0.5) at their default
     thresholds=None (exact: padded cat states of 50,000 x 1,000 scores,
     sorted on the card at compute) and MulticlassHingeLoss, C=1000, batch
     1000, 50 updates; no launches;
   - jigsaw_fairness_binary: exact BinaryAUROC, BinaryAveragePrecision,
     BinarySpecificityAtSensitivity(min_sensitivity=0.9) and
     BinaryFairness(num_groups=9) over 97,320 comments in batches of 4,096
     and a ragged last one of 3,112; 1 launch per update (the fairness
     count);
   - coco_multilabel_exact: exact MultilabelAveragePrecision (macro mAP)
     and MultilabelPrecisionAtFixedRecall(min_recall=0.5) beside coverage
     error, label ranking AP and ranking loss at 80 labels, batch 1,024, 40
     updates; no launches.
   The three exact paths also run their stateful loop under
   list_layout="list", whose states and values must equal the padded
   run's and the CPU run's, and compute under
   torch.cuda.set_sync_debug_mode("error"), so a host sync fails them;
   their values are held within 1e-6 of float64 numpy definitions (exact
   AUROC and AP by sorting, hinge, ranking metrics, fairness rates from the
   counts). Every path reports its peak device memory.
   The reference-image paths launch no kernel; float states within 1e-5
   relative of the CPU run (which covers a path's first ``cpu_steps``
   updates, against a card run of those), values within 1e-5 (relative
   above 1) of it and of float64 definitions (separable float64 filters):
   - div2k_val_x4_sr: PSNR, SSIM, MS-SSIM, UQI, VIF over the 100 DIV2K
     validation images at 3 x 1356 x 2040, batch 1; its record adds the
     TF32 check (SSIM and VIF with torch.backends.cudnn.allow_tf32 = True
     set by the caller, within 1e-5 of float64; the same without the
     port's IEEE pin, for comparison; SSIM against scipy.ndimage) and one
     lone SSIM over four image sizes (one capture each);
   - wv3_pansharpening_reduced: SAM, ERGAS, SCC, RASE, RMSE-SW and UQI over
     20 WorldView-3 samples of 8 x 256 x 256;
   - wv3_pansharpening_full: D_s and QNR over 20 samples (8 x 512 x 512
     fused, 8 x 128 x 128 ms, the pan band repeated over 8), batches of 4;
     D_lambda alone; whole images as cat states, bitwise;
   - live1_jpeg_deblock: PSNR, PSNR-B and SSIM over 29 grayscale images of
     1 x 512 x 768 with 8 x 8 block offsets; total variation alone;
   each followed by phase lone: every image metric of the path updated
   alone, one replay per update after its capture (RASE: two captures, its
   first update reshapes its states), states bitwise equal to an eager
   twin (jit=False), host ms per update of both routes;
   composition: the wrappers, the composition and the online
   metrics at bench config 2's width (C=100, batch 1,024, float32 logits),
   200 updates as 4 epochs of 50 (see CompositionStep): a MetricTracker of
   Accuracy + F1 + binned AUROC, a poisson and a multinomial BootStrapper
   of 10 replicas, ClasswiseWrapper, MinMaxMetric, Running,
   (Accuracy + F1) / 2, a MultitaskWrapper and RunningMean, WindowedMean and
   DecayedMean of the loss; each wrapper's launches per update (1 per
   BootStrapper update for all 10 replicas, 1 per wrapped stat-score
   update, and 1 more once where a wrapper's inner metric, updated alone,
   warms up before its capture), every state against a device="cpu" run (integer states, the
   BootStrapper's stacked ones included, bitwise), the online updates and
   computes under set_sync_debug_mode("error"), the profiler breakdown and
   the peak device memory.
   The collection paths' slice runs update every member eagerly
   (jit=False). Phase fused then runs each path's default route, where
   after group discovery the captured members run as one CUDA graph replay
   per update: captured and eager members, states against the eager loop
   (int32 and cat bitwise, floats within 1e-6 relative; the calibration
   error's value, whose compute adds float32 rows with atomics, 1e-5),
   launches per update equal to the eager route's, one replay per update,
   states handed out before a fused update unchanged after it, host ms per
   update beside the eager loop's and the profiler breakdown; a member
   whose update reads the host (capture_refusal) must raise CaptureError,
   in a collection and alone;
5. streaming: bench config 2 through MetricCollection.buffered(window=K),
   K in 1, 8, 32, 200 updates (a short last window at K=32): states against
   the eager loop, one replay per flush, ms per step, ring memory;
6. config1: bench.py's config 1 (MulticlassAccuracy, C=100, 1,000 steps of
   batch 1,024) through update_state_batched, the stateful loop eagerly
   (jit=False) and through the lone metric's captured update (one replay
   per update), and buffered(window=32): updates/s of each, int32 states
   equal;
7. step_overhead: bench.py's step-overhead MLP (bf16, 2048 -> 8192 x 4 ->
   100, batch 512, SGD) in eager PyTorch, with bench config 2's collection
   updated per step eagerly, fused, and buffered at K in 1, 8, 32: each
   variant's cost as the median of paired (on - off) epoch times, and its
   share of the metrics-off step;
8. sync_free_compute: the filled exact functions the class computes use
   (binary AUROC, multiclass AUROC and AP) at those paths' shapes, timed,
   under torch.cuda.set_sync_debug_mode("error");
9. dist_sync: state sync over torch.distributed, in two parts.
   (a) NCCL at world size 1 in this process: MetricCollection.reduce_state
   and Metric.reduce_state (the pure route) on bench_config2's collection
   (C=100, batch 1,024, 200 updates) and on imagenet1k_exact's states,
   under torch.cuda.set_sync_debug_mode("error"), and HostSync.sync_tensor
   and sync_cat_padded called directly: every result bitwise equal to the
   unsynced state. (b) Two ranks on the one card, spawned, over gloo with
   CUDA tensors (NCCL refuses two ranks on one GPU): each rank updates half
   of bench_config2 (100 of 200 updates), of imagenet1k_exact (25,000 of
   50,000 rows at C=1000) and of a collection of the five aggregators
   (rank 1 gives CatMetric no rows), then syncs every member through
   HostSync (timed, with the wire ledger), computes, and syncs the pure
   states with MetricCollection.reduce_state; rank 0 compares with one
   process over all the data (cat and integer states bitwise, float states
   and values within 1e-6) and both ranks' synced states must hash alike.
   Each timed sync starts at a barrier, after one untimed sync of the same
   states (the first collectives of a group set up its connections);
10. the model-based image metrics, before dist_sync, each network at its
   published widths on seeded random weights (the pretrained files are
   not in the repository), every update eager and no graph captured, the
   bincount never launched, with ms per update, compute ms, peak device
   memory over the inputs, a torch.profiler breakdown (device busy and idle
   share, top kernels) and each value against a device="cpu" run of the
   same weights and inputs (tolerances at FEATURE_RTOL and below):
   - cifar10_fid: FID (2048), KID (100 subsets of 1,000), IS
     (logits_unbiased, 10 splits) and MiFID in one MetricCollection over
     5,000 real and 5,000 fake 32 x 32 images in [0, 255] (CIFAR-10 as
     torch-fidelity evaluates it, cut from 50,000), batches of 200, one
     FID-InceptionV3 forward at 299 x 299 per batch (make_fid_inception,
     seed 0); FID also against float64 numpy/scipy on the same features;
     the CPU run covers 32 images a side;
   - bapps_lpips: LPIPS (AlexNet, random backbone, the trained heads of
     lpips_heads.npz, reduction "mean") over 10,000 pairs of 64 x 64
     patches in [-1, 1], batches of 50; the VGG and SqueezeNet trunks one
     batch each against the CPU;
   - ppl_vgg: PerceptualPathLength with the VGG LPIPS, epsilon 1e-4, resize
     64, lerp and slerp_unit, 2,000 samples (cut from 100,000) of a seeded
     generator from 512-wide latents to 3 x 256 x 256 images;
   - model_tf32: with torch.backends.cudnn.allow_tf32 = True and matmul
     precision "high" set by the caller, Inception's features equal the
     pinned run's within TF32_CHECK_RTOL, and KID's Gram and FID's
     covariance products are within it of float64.

11. sketches (ROADMAP A12), before the model paths, each reporting ms per
   update and its kernel launches (counts set to 0 before each drive):
   - latency_quantiles_tdigest: ApproxQuantile(q=(0.5, 0.9, 0.99, 0.999),
     compression=128) over 200 updates of 65,536 log-normal latencies,
     eager and captured (digests bitwise), windowed(horizon=64, slots=8)
     and decayed(halflife=32.0); each estimate's rank in the data it covers
     within the documented envelope, the exact twin's torch.quantile
     beside it, the first 3 updates bitwise against a CPU run, and a
     profile with the compress kernel's device ms;
   - ctr_reservoir_auroc_ece: ApproxAUROC and ApproxCalibrationError
     (capacity 65,536, 15 bins) fused in one collection over 100 updates
     of 65,536 (score, click) pairs at about 3% positive; within
     3/sqrt(capacity) of the exact twins; reservoirs against a CPU run of
     the first 25 updates (payload bitwise, keys within 2 ulp: CUDA's logf
     and the CPU's log differ by an ulp; the rows are counted);
   - item_popularity_countmin: ApproxFrequency(track=<the 1,000 hottest
     ids>, depth=4, width=65,536) over 100 updates of 65,536 Zipf(1.1) ids
     of 1,000,000 items; one bincount launch per update; tables bitwise
     eager, captured and on the CPU; overestimate-only, excess within
     e·N/width but for a fraction e^-4;
   - tenant_fleet: TenantStack of MulticlassAccuracy(1000 classes, macro)
     over 1,000 tenants (1,024 slots) and of ApproxQuantile over 256
     tenants; 16 sampled tenants against single metrics (bitwise), one
     replay and one kernel launch per stacked update, no capture on churn
     within the capacity and one at growth past it.
   dist_sync's two gloo ranks also sync ApproxQuantile, ApproxAUROC and
   ApproxFrequency: both ranks' states bitwise equal to merge_states of
   the two ranks' local states.
12. a11a (ROADMAP A11.a), after the sketches, each path's bincount
   launches counted from 0 (phase kernel also holds their five shapes:
   contingency, nominal update, cluster counts, cluster sums with the
   (D, N) copy they need timed beside them, and Fleiss kappa's count):
   - imagenet_clustering_labels: the nine label scores (MI, NMI, AMI,
     Rand, ARI, FMI, homogeneity, completeness, V-measure) in one
     MetricCollection over ImageNet-1k val's 50,000 images in 50 updates
     of 1,000 (clusters are the classes permuted, 30% scattered); updates
     append only, eager and replayed, cat states bitwise against a CPU
     run; each member's compute one launch (its 1,000 x 1,000 contingency)
     with its ms and peak MB, AMI's EMI timed apart over its feasible
     terms; scores within A11A_RTOL of float64 numpy/scipy, the EMI within
     EMI_RTOL;
   - imagenet_clustering_embeddings: Calinski-Harabasz, Davies-Bouldin and
     Dunn over 50,000 x 2,048 float32 features of a seeded mixture of 1,000
     Gaussians (50 updates of 1,000 rows, 410 MB of cat states); 2, 3 and 2
     launches per compute, each compute's peak under half the 8.2 GB
     (k, k, D) array, scores within A11A_RTOL of float64 on the card;
   - model_agreement_nominal: Cramer's V, Tschuprow's T, Pearson's C and
     Theil's U at 1,000 classes between two classifiers' top-1 labels on
     ImageNet-1k val (50 updates of 1,000): one compute group, one launch
     per update after discovery, tables bitwise eager, replayed and on the
     CPU, values within NOMINAL_RTOL of float64; FleissKappa over
     CIFAR-10H's shape (10,000 images, 10 classes, 51 ratings) in both
     modes, counts bitwise, one launch per "probs" update; the four
     *_matrix functionals over a 48,842-row table of UCI Adult's nine
     categorical columns with its missing values, both NaN strategies, one
     launch per column pair, against a CPU run;
   - pairwise_gallery: cosine, Euclidean and linear for 10,000 queries
     against a 50,000 x 2,048 gallery (2 GB outputs, one at a time),
     Manhattan and Minkowski (p = 3) for 1,000 queries against 10,000;
     ms, peak MB, sampled blocks against float64 on the card;
   - brats_surface: erosion, dilation, mask_edges (spacing 1 mm) and the
     neighbour codes of 240 x 240 x 155 tumour masks bitwise against a CPU
     run; distance_transform and surface_distance over the 155 axial slices
     against scipy's float64 distance_transform_edt.

13. a11b (ROADMAP A11.b), after a11a, each path's bincount launches counted
   from 0 (phase kernel also holds the panoptic table's shape: one 1024 x
   2048 image's 2,097,152 pixel pairs into its P·T bins):
   - coco_val2017_bbox: MeanAveragePrecision(iou_type="bbox",
     class_metrics=True) over 5,000 seeded COCO val2017-like images, 80
     classes, 100 detections an image, 36,800 or so ground-truth boxes
     (41/34/25% small/medium/large, 1% crowd), updates of 16 images under
     set_sync_debug_mode("error"); compute split into the host copy, the
     IoU batch, the stage match and the accumulation; every output key on
     the first 500 images bitwise against device="cpu"; no launch;
   - coco_iou_family: IoU, GIoU, DIoU and CIoU (respect_labels,
     class_metrics) on those boxes, updates sync-free, values on the first
     500 images within 1e-6 of device="cpu";
   - coco_val2017_segm: MeanAveragePrecision(iou_type="segm") over 500
     images of 480 x 640 with 20 detection and 8 ground-truth dense bool
     masks an image (3.9 GB on the card), every tenth image as RLE
     dicts with pycocotools' compressed strings; compute with its mask
     intersections (one float64 product per image on the card); bitwise
     against device="cpu" on the first 50 images;
   - cityscapes_panoptic: PanopticQuality and ModifiedPanopticQuality (8
     thing and 11 stuff categories, unknown predictions allowed) over 500
     seeded 1024 x 2048 images, batch 1: ms and host synchronisations an
     update, one bincount launch an update (the table of intersections,
     its bins reported), the four states bitwise against device="cpu" on
     the first 4 images.
   The native line gives the g++ build's seconds, each host-library entry
   point the paths called (calls and seconds) and a check of the library
   against its plain numpy versions on this machine.

14. a11c (ROADMAP A11.c), after a11b: audio and the speech-recognition
   error rates, no kernel on their path (the bincount and the compress
   kernel must launch no time there), all data seeded on the card:
   - wsj0_2mix_separation: 3,000 two-speaker mixtures of 4 s at 8 kHz, 16
     an update: PIT(SI-SDR) speaker-wise and permutation-wise, and SDR
     (512 taps), SA-SDR, SI-SNR and SNR on the pit_permutate'd estimates,
     captured (all but SDR, eager by declaration) and eagerly: ms an update,
     host synchronisations, captures, SDR's solve ms, peak MB; PIT's
     permutations equal an exhaustive float64 search and its SI-SDR within
     1e-3 dB of it, SDR within 5e-3 dB of a float64 solve, states against
     device="cpu" on the first 64 mixtures; a 5-speaker sub-phase (200
     mixtures, 8 an update) through the host assignment, permutations
     equal to scipy's;
   - dns_enhancement: 150 clips of 10 s at 16 kHz, 10 an update, noisy,
     delayed, every fifth with a delay jump and a transient: PESQ wb and
     nb, STOI, extended STOI, SI-SDR and SNR, ms a clip, PESQ's host part
     apart, its second passes; PESQ's decisions and MOS and STOI against
     device="cpu" on the first 8 clips, the two ITU anchors on the card;
   - reverb_srmr: 200 clips of 8 s at 16 kHz reverberated at RT60 0.25,
     0.5 and 0.7 s, 8 an update, SRMR at the defaults, norm=True and
     fast=True: ms an update and peak MB (under the frames it does not
     build); the first 8 clips against device="cpu", k* equal;
   - librispeech_wer: WER, CER, MER, WIL and WIP over 2,620 utterances and
     52,576 reference words, 32 an update: ms an update and the host
     library's share; states bitwise against device="cpu" and the plain
     Levenshtein counts on the first 200 utterances.

15. a11d (ROADMAP A11.d), after a11c: text and multimodal, no kernel on
   their path (the bincount and the compress kernel must launch no time
   there), the model metrics through stand-in encoders built here from
   torch.nn at published widths with seeded weights (no pretrained files
   can be had offline), each path's record printed as it ends:
   - wmt14_translation: BLEU, SacreBLEU (13a), chrF, chrF++, TER, the
     character EditDistance over newstest2014 en-de's 3,003 seeded segments
     of 10-60 words (40,000-word Zipf vocabulary, 20% substitutions,
     shifted spans), EED over the first 256 (its character DP is the
     slowest host code), 64 an update: ms an update per metric; states
     after the first 512 (EED 64) bitwise against device="cpu", corpus
     scores against float64 formulas over the states;
   - wmt14_bertscore_infolm: BERTScore (idf off and on) through a
     roberta-large-wide stand-in and InfoLM (KL, Fisher-Rao, temperature
     0.25) through a bert-base-wide masked LM, over the same 3,003 pairs in
     chunks of 64: compute s split into encoder and the rest, peak MB; the
     first chunk's matching and measures against float64 on the card,
     target-chunked matching against dense, 8 pairs against device="cpu";
   - cnndm_rouge_squad: ROUGE-1/2/L/Lsum (best) over the first 4,000 of
     CNN/DailyMail test's 11,490 seeded highlights and SQuAD over v1.1
     dev's 10,570 questions: ms an update, states after 512 bitwise
     against device="cpu";
   - wikitext_perplexity: Perplexity at GPT-2's 50,257 words over 280
     sequences of 1,024 tokens, 8 an update (1.65 GB of logits), 5%
     ignored, captured and eager: ms an update beside the byte bound, peak
     MB; the value against float64 log_softmax, a probability input taking
     the log branch, the first update against device="cpu";
   - coco_clipscore_koniq_clipiqa: CLIPScore through a ViT-L/14-wide
     stand-in over the first 2,500 of MS-COCO Karpathy test's 5,000 seeded
     640 x 480 images with captions, 50 an update, image-image on the
     first 500, and
     CLIP-IQA (quality, sharpness, noisiness, brightness) through a
     ViT-B/16-wide one over KonIQ-10k test's 2,015 images at 1024 x 768:
     ms an image, peak MB; cosines and prompt softmaxes against float64 of
     the same features, 2 images against device="cpu", and CLIPScore()
     raising ModuleNotFoundError (no local files of its default model).

16. a13 (ROADMAP A13), after a11d: sharded cat state and elastic sync,
   all data seeded on the card:
   - criteo_dlrm_eval_auroc: BinaryAUROC over MLPerf DLRM-DCNv2's
     evaluation set (Criteo 1TB day 23's validation half, 89,137,319
     scores at 3.4% positives, exact AUROC near the 0.8025 target) in
     batches of 65,536, as three layouts on the same updates: replicated
     exact, cat_layout="sharded" exact on the card's own mesh (one shard),
     and hist_bins=8192 over a mesh listing the card 4 times: ms an update
     and peak MB per layout, compute ms; the sharded exact value bitwise the
     replicated one, the histograms of 1 and 4 shards bitwise, the
     histogram AUROC within its tie bound of the exact value (one bincount
     launch per shard), sharded_topk(1000) bitwise torch.topk of the dense
     rows, sharded_moments within 1e-6 of float64, reshard 4 -> 1 rows
     bitwise, the first 2 M rows' states bitwise and values equal against
     device="cpu"; the kernel at the histogram's shape (89.1 M joint indices
     into 16,384 bins, int32) beside its bound, index_add_ and torch.bincount;
   - imagenet_chaos_soak: ImageNet-1k validation's 50,000 images over 4
     emulated ranks and 200 windows, MulticlassAccuracy and
     MulticlassCalibrationError(n_bins=15) on the card, rank 0 through
     ElasticSync over ChaosSync/FakeSync under the JAX package's seeded soak
     schedule: every full-coverage window's synced states bitwise the
     fault-free twin's, every degraded window's coverage the injected
     membership; a preempted rank's checkpoint merged back, full coverage.
   dist_sync's two gloo ranks add part (c): FID's SUM states at 2,048
   features (33.6 MB) synced exactly and under quantize_bits 16 and 8
   (Metric.sync twice, reduce_state_in_graph): every element within its
   chunk's quantization bound, the wire bytes beside the exact sync's; a
   transient timeout recovering bitwise; a preempted rank 1: rank 0
   degrades to coverage 1/2, raises CoverageError under min_coverage=0.75
   with its state intact, and merges rank 1's checkpoint bitwise.
17. a14 (ROADMAP A14), after a13: observability and debug over bench
   config 2, one line per part:
   (a) 2 warm-up updates with the ledger armed, then 5 rounds of four
       interleaved passes of 2,000 updates: an untraced twin, the metric
       inside tracing(), ledger_observing() and
       strict_mode(max_new_executables=0) with the sync debug guard armed,
       the twin, the metric with fence_every=10: no capture, no
       synchronising call, states bitwise the twin's; medians with their
       spread; one ledger entry per captured graph, its
       bincount launches with the kernel phase's bound bytes; the Perfetto
       file under chiprun_out/ read back; the graph, wire and ledger
       Prometheus families; ms an update untraced, traced and fenced,
       spans an update, phase totals, rooflines at the replay rate;
   (b) an .item() on a state, a new batch size (named through
       describe_key) refused by strict_mode(), max_retraces=1 letting it
       through; whether a pageable host-to-device copy is refused;
   (c) tenant_fleet's 1,000-tenant classifier stack at its 1,024 slots:
       churn with updates between under strict_mode(max_new_executables=0)
       and the guard captures nothing and reads nothing back; the ledger
       renders update[TenantStack[MulticlassAccuracy]×1024];
   (d) the autotuner on bench config 2 at world 1, cold then warm through
       a ProfileCache under chiprun_out/: the warm run observes and
       measures nothing, and after its own captures 200 updates under
       strict_mode(max_new_executables=0);
   (e) the chaos soak over 40 windows under strict_mode(transfer_guard=None,
       max_degraded_syncs=N), N counted in a first run: StrictStats counts
       N, as elastic_stats() and the registry's elastic.* do; N - 1 raises.

18. a15 (ROADMAP A15, ring attention and the train template), after the
   model paths and before dist_sync, one line: parts (a) and (b) at NCCL
   world size 1 in this process, then in two gloo ranks spawned on the one
   card (a deadline, file:// init, as dist_sync):
   (a) the counterpart of the JAX package's multichip program 2 at
       Llama-2-7B's attention widths (32 heads of 128, vocabulary 32,000,
       context 4,096, batch 4): causal ring attention over sp (1, then
       2: 2,048 rows a rank), the heads merged and projected to logits,
       Perplexity reduced over dp and sp, bench config 2's fused
       Accuracy + F1 + binned AUROC collection reduced over dp; the
       attention within 1e-5 of full attention in one process (float32,
       TF32 off), bf16 within 0.05 returning bf16, the two ranks' reduced
       states against the world-1 run's (counts bitwise, floats within
       1e-6 relative); ms a step and the ring exchange's share of the
       attention;
   (b) the dp x pp x tp train template (program 1) at the JAX entry's
       widths for 40 steps (the loss falls by more than 0.5) and at
       Llama-2-7B's MLP widths (d_model 4,096, d_hidden 11,008, vocabulary
       32,000, batch 8 x 512) for 3, on (1, 1, 1), then (1, 1, 2) (experts
       on tp) and (2, 1, 1): the first step's loss and parameters within
       1e-5 of the model's one-process reference, Accuracy and Perplexity
       updated on the logits each step, ms a step;
   (c) plotting: _MATPLOTLIB_AVAILABLE as find_spec says, the package's
       import pulling in no matplotlib, and without it Metric.plot,
       MetricCollection.plot and the curve and confusion plots raising the
       JAX package's ModuleNotFoundError (with it: figures under Agg).
   Its bincount launches are counted into the kernels line.

The last lines are the native record, the kernels' record, the card's name
and power limit, and {"ok": true, "device": {...}}.
"""
import contextlib
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def hbm_bytes_per_s() -> float:
    """The card's peak device-memory rate, from the ledger's table of peaks
    (the H100 SXM data sheet's 3.35 TB/s)."""
    from torchmetrics_tpu_torch.observability.ledger import device_peaks

    return device_peaks()[1]


# past this many rows the torch.bincount yardstick is one call over row-offset
# indices, not one call (and one host round trip) per row
LIBRARY_FLAT_ROWS = 32
SLEEP_CYCLES = 20_000_000  # about 10 ms of the H100's clock
VALUE_TOL = 1e-6
# kernel cases timed beside their bound, the plain version and torch.bincount
TIMED_CASES = ("stat_scores_c100", "curve_c100_t64", "stat_scores_c1000", "curve_c1000_t64",
               "curve_c1000_t64_1d", "curve_binary_pixel_t64", "curve_multilabel_l80_t64", "past_cluster",
               "unweighted_int32", "random_f32_weights", "confmat_cityscapes", "stat_scores_cityscapes",
               "confmat_imagenet1k", "calibration_imagenet1k", "fairness_jigsaw", "bootstrap_c100_b10",
               "countmin_popularity", "ece_ctr_compute", "tenant_stack_c1000", "contingency_imagenet1k",
               "nominal_update_c1000", "cluster_counts_imagenet1k", "cluster_sums_imagenet1k", "fleiss_cifar10h",
               "panoptic_intersections_cityscapes")
# the cases of the confusion, calibration, fairness, bootstrap, sketch, A11.a, A11.b and A13 paths, reported
# beside the main one in the kernels line (phase a13 times its own case at the Criteo histogram's shape)
SLICE_CASES = ("confmat_cityscapes", "stat_scores_cityscapes", "confmat_imagenet1k", "calibration_imagenet1k",
               "fairness_jigsaw", "bootstrap_c100_b10", "countmin_popularity", "ece_ctr_compute",
               "tenant_stack_c1000", "contingency_imagenet1k", "nominal_update_c1000", "cluster_counts_imagenet1k",
               "cluster_sums_imagenet1k", "fleiss_cifar10h", "panoptic_intersections_cityscapes",
               "histogram_criteo_auroc")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, rounds: int = 5) -> tuple:
    """(device ms, host ms) per call, medians over ``rounds``.

    A sleep kernel holds the stream while the host enqueues ``reps`` calls,
    so the CUDA events around them time the calls back to back on the
    device, without the host's launch latency between them; the host time
    is the Python-side enqueue cost of one call. ``covered`` is False when
    the host took longer than the sleep, which would inflate the device time.
    """
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    dev, host, covered = [], [], True
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        sleep_end = torch.cuda.Event(enable_timing=True)
        sleep_start = torch.cuda.Event(enable_timing=True)
        sleep_start.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        sleep_end.record()
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        covered = covered and enqueue_ms < sleep_start.elapsed_time(sleep_end)
        dev.append(start.elapsed_time(end) / reps)
        host.append(enqueue_ms / reps)
    return statistics.median(dev), statistics.median(host), covered


def kernel_cases(device):
    """(name, entry, idx, weights, num_bins, exact): the metric path's shapes
    through the batched entry, the 1-D entry at the largest of them, then
    edges. ``exact`` cases must equal the plain version bitwise."""
    import torch

    g = torch.Generator(device=device).manual_seed(0)

    def ints(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=g, device=device, dtype=torch.int32)

    def mask01(shape):
        return (torch.rand(shape, generator=g, device=device) < 0.9).to(torch.float32)

    mis_idx, mis_w = ints((1_000_001,), -3, 65_003), mask01((2, 1_000_001))
    # Cityscapes: one 1024 x 2048 label map, about 10% of the pixels ignored
    # (index -1, which the kernel drops)
    city = ints((1, 2_097_152), 0, 361)
    city = torch.where(torch.rand(city.shape, generator=g, device=device) < 0.1, -1, city)
    conf = torch.rand((50_000,), generator=g, device=device)
    # one Cityscapes image's panoptic table of intersections (its own generator)
    pan_idx, pan_bins = _panoptic_pair_index(*_cityscapes_panoptic(torch.Generator(device=device).manual_seed(150),
                                                                   device))
    ctr_conf = 0.5 + 0.5 * torch.rand((65_536,), generator=g, device=device)  # binary confidences are >= 0.5
    return [
        # stat scores at bench config 2: S=3 rows of N = batch, bins = C
        ("stat_scores_c100", "batched", ints((3, 1024), 0, 100), mask01((3, 1024)), 100, True),
        # binned curve at bench config 2: shared idx of N = batch * C, S=2, bins = C * (T + 1)
        ("curve_c100_t64", "batched", ints((102_400,), 0, 6_500), mask01((2, 102_400)), 6_500, True),
        # stat scores at ImageNet-1k
        ("stat_scores_c1000", "batched", ints((3, 1000), 0, 1000), mask01((3, 1000)), 1000, True),
        # binned curve at ImageNet-1k: 130,000 counters need a cluster
        ("curve_c1000_t64", "batched", ints((1_000_000,), 0, 65_000), mask01((2, 1_000_000)), 65_000, True),
        # the 1-D entry at that shape (one call per weight row before the batched entry)
        ("curve_c1000_t64_1d", "1d", ints((1_000_000,), 0, 65_000), mask01((1_000_000,)), 65_000, True),
        # binary pixel curve (32 masks of 256 x 256 per update): shared idx of
        # N = 2,097,152 bins in [0, T], S=2, 65 bins: a grid of CTAs that each
        # hold all 130 counters
        ("curve_binary_pixel_t64", "batched", ints((2_097_152,), 0, 65), mask01((2, 2_097_152)), 65, True),
        # multilabel curve at COCO's 80 labels, batch 1,024: shared idx of
        # N = 81,920, S=2, bins = L * (T + 1) = 5,200
        ("curve_multilabel_l80_t64", "batched", ints((81_920,), 0, 5_200), mask01((2, 81_920)), 5_200, True),
        # past the largest cluster (16 CTAs of 227 KB): the bins are tiled
        ("past_cluster", "1d", ints((1_000_000,), 0, 1_000_000), mask01((1_000_000,)), 1_000_000, True),
        ("unweighted_int32", "batched", ints((2, 1_000_000), 0, 65_000), None, 65_000, True),
        ("out_of_range", "batched", ints((200_000,), -50_000, 120_000), mask01((2, 200_000)), 65_000, True),
        ("empty", "batched", ints((0,), 0, 10), mask01((2, 0)), 10, True),
        # clusters with scalar inputs: a view off 16-byte alignment (scalar
        # head and tail), ragged rows (N % 4 != 0: every input scalar), and
        # few bins with ragged rows
        ("misaligned_1d", "1d", mis_idx[1:], mis_w[0, 1:], 65_000, True),
        ("misaligned_shared", "batched", mis_idx[1:], mis_w[:, 1:], 65_000, True),
        ("ragged_per_row", "batched", ints((3, 100_001), -5, 65_005), None, 65_000, True),
        ("ragged_small_bins", "batched", ints((5, 10_001), -5, 700), mask01((5, 10_001)), 700, True),
        # more weight rows than the kernel specialises (S=6)
        ("six_rows_shared", "batched", ints((300_000,), 0, 900), mask01((6, 300_000)), 900, True),
        ("six_rows_cluster", "batched", ints((300_000,), 0, 20_000), mask01((6, 300_000)), 20_000, True),
        ("random_f32_weights", "batched", ints((1_000_000,), 0, 65_000),
         torch.rand((2, 1_000_000), generator=g, device=device), 65_000, False),
        # confusion matrix at Cityscapes (19 classes): int32 counts of one
        # image's pixels into 19^2 cells
        ("confmat_cityscapes", "batched", city, None, 361, True),
        # the stat scores of Dice and pixel accuracy there: 3 rows of 2,097,152
        ("stat_scores_cityscapes", "batched", ints((3, 2_097_152), 0, 19), mask01((3, 2_097_152)), 19, True),
        # confusion matrix at ImageNet-1k: 1,000 samples into 1,000,000 cells,
        # the sparse plan
        ("confmat_imagenet1k", "batched", ints((1, 1000), 0, 1_000_000), None, 1_000_000, True),
        # calibration error over ImageNet-1k val: counts, confidence and
        # accuracy sums of 50,000 samples in 15 bins over one shared index;
        # the confidences are arbitrary float32 weights
        ("calibration_imagenet1k", "batched", torch.clamp((conf * 15).to(torch.int32), 0, 14),
         torch.stack([torch.ones_like(conf), conf, mask01((50_000,))]), 15, False),
        # group fairness over Jigsaw: one batch of 4,096 comments' tp/fp/tn/fn
        # cells (group * 4 + stat) of 9 groups, int32 counts into 36 bins
        ("fairness_jigsaw", "1d", ints((4096,), 0, 36), None, 36, True),
        # BootStrapper's 10 replicas at bench config 2 (C=100, batch 1,024):
        # 3 x 10 rows [correct, valid, valid] x per-sample counts over a
        # per-row index [tgt, tgt, prd] x 10, in one call; the counts are
        # small integers (Poisson draws), so the sums are exact
        ("bootstrap_c100_b10", "batched", ints((3, 1024), 0, 100).repeat(10, 1),
         mask01((30, 1024)) * torch.randint(0, 4, (30, 1024), generator=g, device=device), 100, True),
        # the sketch paths: a count-min update of item_popularity
        # (depth 4 rows of 65,536 hashed columns, int32 into 65,536 bins), the
        # ECE compute of ctr_reservoir (three f32 rows of the 65,536-row
        # sample over 15 bins) and a stacked update of tenant_fleet (3 rows
        # of 64 per tenant, 1,024 tenants, per-row indices, 1,000 classes)
        ("countmin_popularity", "batched", ints((4, 65_536), 0, 65_536), None, 65_536, True),
        ("ece_ctr_compute", "batched", torch.clamp((ctr_conf * 15).to(torch.int32), 0, 14),
         torch.stack([torch.ones_like(ctr_conf), ctr_conf, mask01((65_536,))]), 15, False),
        ("tenant_stack_c1000", "batched", ints((3 * 1024, 64), 0, 1000), mask01((3 * 1024, 64)), 1000, True),
        # the A11.a paths: the contingency matrix of ImageNet-1k clustering
        # (50,000 joint labels into 1,000 x 1,000 cells, the sparse plan), a
        # nominal update (1,000 pairs of top-1 labels into 1,000 x 1,000
        # cells), the per-cluster counts (50,000 labels, 1,000 clusters), the
        # per-cluster sums of 50,000 x 2,048 float32 features (2,048 weight
        # rows over one shared index) and Fleiss kappa's "probs" count over
        # CIFAR-10H (10,000 images x 51 raters into 10,000 x 10 bins)
        ("contingency_imagenet1k", "1d", ints((50_000,), 0, 1000) * 1000 + ints((50_000,), 0, 1000), None,
         1_000_000, True),
        ("nominal_update_c1000", "1d", ints((1000,), 0, 1000) * 1000 + ints((1000,), 0, 1000), None, 1_000_000, True),
        ("cluster_counts_imagenet1k", "1d", ints((50_000,), 0, 1000), None, 1000, True),
        ("cluster_sums_imagenet1k", "batched", ints((50_000,), 0, 1000),
         torch.randn((2048, 50_000), generator=g, device=device), 1000, False),
        ("fleiss_cifar10h", "1d", (torch.arange(10_000, device=device, dtype=torch.int32)[:, None] * 10
                                   + ints((10_000, 51), 0, 10)).reshape(-1), None, 100_000, True),
        # the A11.b path: panoptic quality's table of intersections of one
        # 1024 x 2048 image, int32 counts of 2,097,152 pixel pairs into P·T bins
        ("panoptic_intersections_cityscapes", "1d", pan_idx, None, pan_bins, True),
    ]


def library_call(idx, w, bins: int):
    """The torch.bincount yardstick for a case, as a zero-argument callable:
    one call per row, or, past LIBRARY_FLAT_ROWS rows, one call over
    row-offset indices (bin b of row r at r * bins + b), which counts the
    same. torch.bincount refuses negative indices: dropped ones count in
    bin 0."""
    import torch

    idx64 = idx.long().clamp_min(0)
    rows = w.shape[0] if w is not None and w.dim() == 2 else (idx.shape[0] if idx.dim() == 2 else 1)
    if rows > LIBRARY_FLAT_ROWS:
        offsets = torch.arange(rows, device=idx.device)[:, None] * bins
        flat = (idx64.expand(rows, idx64.shape[-1]) + offsets).reshape(-1)
        flat_w = None if w is None else w.reshape(-1)
        return lambda: torch.bincount(flat, flat_w, minlength=rows * bins)
    i_rows = [idx64] * rows if idx64.dim() == 1 else list(idx64)
    w_rows = [None] * rows if w is None else ([w] if w.dim() == 1 else list(w))
    return lambda: [torch.bincount(i, ww, minlength=bins) for i, ww in zip(i_rows, w_rows)]


def library_device_ms(idx, w, bins: int, reps: int = 10) -> float:
    """Device time of torch.bincount for the same counts (``library_call``):
    the kernels (and memsets) of a torch.profiler trace, so the host round
    trip by which torch.bincount sizes its output (a device-to-host copy and
    a wait) is left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call = library_call(idx, w, bins)
    call()
    torch.cuda.synchronize()
    total_us = 0.0
    for _ in range(3):  # a trace that caught no device activity is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        total_us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA and "memcpy" not in e.name.lower())
        if total_us > 0:
            break
    if total_us <= 0:
        raise AssertionError("torch.profiler recorded no device time for torch.bincount")
    return total_us / reps / 1e3


def check_kernel(device) -> dict:
    import torch

    from torchmetrics_tpu_torch.ops import bincount

    results = []
    max_abs_err = 0.0
    for name, entry, idx, w, bins, exact in kernel_cases(device):
        if entry == "1d":
            call = lambda idx=idx, w=w, bins=bins: bincount.weighted_bincount(idx, w, bins)  # noqa: E731
            plain = lambda idx=idx, w=w, bins=bins: bincount.weighted_bincount_plain(idx, w, bins)  # noqa: E731
        else:
            call = lambda idx=idx, w=w, bins=bins: bincount.weighted_bincount_batched(idx, w, bins)  # noqa: E731
            plain = lambda idx=idx, w=w, bins=bins: bincount.weighted_bincount_batched_plain(idx, w, bins)  # noqa: E731
        before = bincount.weighted_bincount.launches
        got = call()
        launched = bincount.weighted_bincount.launches - before
        want = plain()
        torch.cuda.synchronize()
        n = idx.shape[-1]
        rows = idx.shape[0] if idx.dim() == 2 else 1
        s = w.shape[0] if w is not None and w.dim() == 2 else rows
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        # a shared index with more weight rows than one launch stages takes one launch per group of rows
        group = bincount.shared_rows_per_launch(n, s, bins) if rows == 1 and s > 1 and w is not None else s
        if n and launched != -(-s // group):
            raise AssertionError(f"kernel {name}: {launched} launches, expected {-(-s // group)}")
        if exact:
            # int32 counts and sums of 0/1 weights are exact in any order
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError(f"kernel {name}: not bitwise equal to the plain version")
        else:
            # float32 shared-memory atomics add in another order than
            # index_add_: agree per bin within rtol 1e-5
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
        max_abs_err = max(max_abs_err, err)
        plan = bincount.launch_plan(n, rows, group, bins, w is not None, sms)
        row = {"case": name, "entry": entry, "s": s, "n": n, "bins": bins, "shared_idx": rows == 1 and s > 1,
               "weighted": w is not None, "plan": plan._asdict(), "rows_per_launch": group, "launches": launched,
               "bitwise": bool(torch.equal(got, want)), "max_abs_err": err}
        if n and name in TIMED_CASES:
            row["ms"], row["host_ms"], row["ms_covered"] = time_ms(call)
            row["plain_ms"], row["plain_host_ms"], row["plain_covered"] = time_ms(plain)
            row["library_device_ms"] = library_device_ms(idx, w, bins)
            # torch.bincount reads the largest index back to the host to size
            # its output, so every call waits for the device: this is a host
            # round trip per call ("library_covered" comes out False)
            row["library_ms"], _, row["library_covered"] = time_ms(library_call(idx, w, bins), reps=5)
            row["bound_ms"] = bincount.bound_bytes(idx, w, bins) / hbm_bytes_per_s() * 1e3
            row["bound_by"] = "bytes"
        if name == "cluster_sums_imagenet1k":
            # the per-cluster sums take the (N, D) features as D weight rows:
            # the (D, N) copy that the kernel's contiguous rows need, timed alike
            features = w.T.contiguous()
            row["transpose_ms"], row["transpose_host_ms"], _ = time_ms(lambda f=features: f.T.contiguous())
            del features
        results.append(row)
    return {"cases": results, "max_abs_err": max_abs_err}


def multiclass_path(num_classes: int, batch: int, steps: int) -> dict:
    """The main path: Accuracy (micro) + F1 (macro) + binned AUROC over C classes."""

    def make(device, jit=True):
        from torchmetrics_tpu_torch import MetricCollection
        from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassAUROC, MulticlassF1Score
        from torchmetrics_tpu_torch.regression import MeanSquaredError

        kw = dict(num_classes=num_classes, validate_args=False, device=device, jit=jit)
        return MetricCollection({
            "acc": MulticlassAccuracy(average="micro", **kw),
            "f1": MulticlassF1Score(average="macro", **kw),
            "auroc": MulticlassAUROC(thresholds=64, **kw),
        })

    def inputs(g, dev):
        import torch

        preds = torch.softmax(torch.randn(steps, batch, num_classes, generator=g, device=dev), dim=-1)
        return preds, torch.randint(0, num_classes, (steps, batch), generator=g, device=dev)

    def direct(preds, target):
        return {"acc": (preds.argmax(-1) == target).double().mean().item()}

    return {"make": make, "inputs": inputs, "direct": direct, "steps": steps,
            "groups": {0: ["acc", "f1"], 1: ["auroc"]}, "launches": (3, 2, 2, 0),
            "shape": {"num_classes": num_classes, "batch": batch, "thresholds": 64}}


def pixel_binary_path(masks: int = 32, side: int = 256, steps: int = 8) -> dict:
    """Pixel-level binary evaluation, as anomaly-detection evaluations on
    MVTec AD score every pixel of every test mask: per update ``masks``
    score maps of side x side probabilities against {0, 1} masks. Binned
    AUROC and AP (one curve group, one kernel launch per update) beside
    precision, recall, specificity and F1 (one stat-scores group, counted
    without the kernel)."""

    def make(device, jit=True):
        from torchmetrics_tpu_torch import MetricCollection
        from torchmetrics_tpu_torch.classification import (BinaryAUROC, BinaryAveragePrecision, BinaryF1Score,
                                                           BinaryPrecision, BinaryRecall, BinarySpecificity)

        kw = dict(validate_args=False, device=device, jit=jit)
        return MetricCollection({
            "auroc": BinaryAUROC(thresholds=64, **kw), "ap": BinaryAveragePrecision(thresholds=64, **kw),
            "precision": BinaryPrecision(**kw), "recall": BinaryRecall(**kw),
            "specificity": BinarySpecificity(**kw), "f1": BinaryF1Score(**kw),
        })

    def inputs(g, dev):
        import torch

        target = (torch.rand(steps, masks, side, side, generator=g, device=dev) < 0.05).to(torch.int64)
        logits = torch.randn(steps, masks, side, side, generator=g, device=dev) + 3.0 * target - 2.0
        return torch.sigmoid(logits), target

    def direct(preds, target):
        hit = (preds > 0.5) & (target == 1)
        return {"recall": (hit.double().sum() / (target == 1).double().sum()).item(),
                "precision": (hit.double().sum() / (preds > 0.5).double().sum()).item()}

    return {"make": make, "inputs": inputs, "direct": direct, "steps": steps,
            "groups": {0: ["ap", "auroc"], 1: ["f1", "precision", "recall", "specificity"]},
            "launches": (2, 1, 1, 0), "shape": {"masks": masks, "side": side, "pixels_per_update": masks * side * side,
                                             "thresholds": 64}}


def coco_multilabel_path(labels: int = 80, batch: int = 1024, steps: int = 40) -> dict:
    """MS-COCO 80-label image classification, where mAP is the reported
    metric: 40 updates of 1,024 images (about the 40,504-image val2014 set).
    Binned mAP and AUROC (one curve group, one launch per update) beside F1,
    precision, recall and Hamming (one stat-scores group) and exact match."""

    def make(device, jit=True):
        from torchmetrics_tpu_torch import MetricCollection
        from torchmetrics_tpu_torch.classification import (MultilabelAUROC, MultilabelAveragePrecision,
                                                           MultilabelExactMatch, MultilabelF1Score,
                                                           MultilabelHammingDistance, MultilabelPrecision,
                                                           MultilabelRecall)

        kw = dict(num_labels=labels, validate_args=False, device=device, jit=jit)
        return MetricCollection({
            "map": MultilabelAveragePrecision(average="macro", thresholds=64, **kw),
            "auroc": MultilabelAUROC(average="macro", thresholds=64, **kw),
            "f1": MultilabelF1Score(**kw), "precision": MultilabelPrecision(**kw), "recall": MultilabelRecall(**kw),
            "hamming": MultilabelHammingDistance(**kw), "exact_match": MultilabelExactMatch(**kw),
        })

    def inputs(g, dev):
        import torch

        # about 2.9 labels per image, as in COCO
        target = (torch.rand(steps, batch, labels, generator=g, device=dev) < 0.036).to(torch.int64)
        logits = torch.randn(steps, batch, labels, generator=g, device=dev) + 4.0 * target - 2.5
        return torch.sigmoid(logits), target

    def direct(preds, target):
        return {"exact_match": ((preds > 0.5) == (target == 1)).all(-1).double().mean().item(),
                "hamming": ((preds > 0.5) != (target == 1)).double().mean().item()}

    return {"make": make, "inputs": inputs, "direct": direct, "steps": steps,
            "groups": {0: ["auroc", "map"], 1: ["exact_match"], 2: ["f1", "hamming", "precision", "recall"]},
            "launches": (2, 1, 1, 0), "shape": {"labels": labels, "batch": batch, "thresholds": 64}}


def cityscapes_miou_path(num_classes: int = 19, height: int = 1024, width: int = 2048, steps: int = 10) -> dict:
    """Semantic-segmentation evaluation as mmsegmentation runs it on
    Cityscapes val: one 1024 x 2048 image of float32 logits (1, 19, H, W)
    per update against a label map with about 10% of the pixels at 255
    (ignored), 10 updates (the val set has 500 images). mIoU (macro) and the
    row-normalised confusion matrix form one confusion-matrix group (one
    int32 launch per update, 361 cells), pixel accuracy and Dice (macro)
    one stat-scores group (one launch of 3 rows)."""

    def make(device, jit=True):
        from torchmetrics_tpu_torch import Dice, MetricCollection
        from torchmetrics_tpu_torch.classification import (MulticlassAccuracy, MulticlassConfusionMatrix,
                                                           MulticlassJaccardIndex)

        kw = dict(num_classes=num_classes, ignore_index=255, validate_args=False, device=device, jit=jit)
        return MetricCollection({
            "miou": MulticlassJaccardIndex(**kw),
            "confmat": MulticlassConfusionMatrix(normalize="true", **kw),
            "pixel_acc": MulticlassAccuracy(average="micro", **kw),
            "dice": Dice(average="macro", **kw),
        })

    def inputs(g, dev):
        import torch

        # skewed class frequencies (a few classes cover most pixels, as in
        # street scenes), about 10% ignored pixels, logits that favour the
        # true class
        weights = 0.75 ** torch.arange(num_classes, dtype=torch.float64, device=dev)
        cdf = torch.cumsum(weights / weights.sum(), 0).to(torch.float32)
        u = torch.rand(steps, 1, height, width, generator=g, device=dev)
        target = torch.clamp(torch.searchsorted(cdf, u), max=num_classes - 1)
        ignored = torch.rand(steps, 1, height, width, generator=g, device=dev) < 0.1
        logits = torch.randn(steps, 1, num_classes, height, width, generator=g, device=dev)
        logits.scatter_add_(2, target.unsqueeze(2), torch.full_like(target, 2.5, dtype=torch.float32).unsqueeze(2))
        return logits, torch.where(ignored, 255, target)

    def direct(preds, target):
        import torch

        pred = preds.argmax(2).reshape(-1)
        tgt = target.reshape(-1)
        keep = tgt != 255
        cm = torch.bincount(num_classes * tgt[keep] + pred[keep], minlength=num_classes**2)
        cm = cm.reshape(num_classes, num_classes).double()
        tp, rows, cols = cm.diagonal(), cm.sum(1), cm.sum(0)
        union = rows + cols - tp
        present = union > 0
        dice_den = rows + cols
        return {"miou": (tp[present] / union[present]).mean().item(),
                "pixel_acc": (tp.sum() / cm.sum()).item(),
                "dice": (2 * tp[dice_den > 0] / dice_den[dice_den > 0]).mean().item(),
                "confmat": cm / rows.clamp_min(1)[:, None]}

    return {"make": make, "inputs": inputs, "direct": direct, "steps": steps,
            "groups": {0: ["confmat", "miou"], 1: ["dice", "pixel_acc"]}, "launches": (4, 2, 2, 0),
            "shape": {"num_classes": num_classes, "height": height, "width": width, "ignore_index": 255}}


def imagenet1k_confmat_path(num_classes: int = 1000, batch: int = 1000, steps: int = 50) -> dict:
    """ImageNet-1k validation at C=1000, batch 1000, 50 updates (the
    50,000-image set): the confusion matrix, Cohen's kappa and MCC (one
    group over 1,000,000 int32 cells, one sparse-plan launch per update)
    and the expected calibration error (15 bins; one launch at compute)."""

    def make(device, jit=True):
        from torchmetrics_tpu_torch import MetricCollection
        from torchmetrics_tpu_torch.classification import (MulticlassCalibrationError, MulticlassCohenKappa,
                                                           MulticlassConfusionMatrix, MulticlassMatthewsCorrCoef)

        kw = dict(num_classes=num_classes, validate_args=False, device=device, jit=jit)
        return MetricCollection({
            "confmat": MulticlassConfusionMatrix(**kw), "kappa": MulticlassCohenKappa(**kw),
            "mcc": MulticlassMatthewsCorrCoef(**kw), "ece": MulticlassCalibrationError(n_bins=15, **kw),
        })

    def inputs(g, dev):
        import torch

        # softmax probabilities as multiclass_path makes them, with the true
        # class's logit raised by a uniform amount in [0, 10): about two in
        # three top-1 predictions are right, at confidences spread over all
        # 15 bins
        target = torch.randint(0, num_classes, (steps, batch), generator=g, device=dev)
        logits = torch.randn(steps, batch, num_classes, generator=g, device=dev)
        logits.scatter_add_(2, target.unsqueeze(2), 10.0 * torch.rand(steps, batch, 1, generator=g, device=dev))
        return torch.softmax(logits, dim=-1), target

    def direct(preds, target):
        import numpy as np
        import torch

        pred = preds.argmax(-1).reshape(-1)
        tgt = target.reshape(-1)
        cm = torch.bincount(num_classes * tgt + pred, minlength=num_classes**2).reshape(num_classes, num_classes)
        cmd = cm.cpu().numpy().astype(np.float64)
        n, rows, cols, correct = cmd.sum(), cmd.sum(1), cmd.sum(0), np.trace(cmd)
        disagree = 1.0 - np.eye(num_classes)
        kappa = 1.0 - (disagree * cmd).sum() / (disagree * np.outer(rows, cols) / n).sum()
        mcc = (correct * n - (rows * cols).sum()) / np.sqrt((n**2 - (cols**2).sum()) * (n**2 - (rows**2).sum()))
        conf = preds.amax(-1).reshape(-1)
        bins = torch.clamp((conf * 15).to(torch.int32), 0, 14).long().cpu().numpy()
        conf64 = conf.double().cpu().numpy()
        hit = (pred == tgt).double().cpu().numpy()
        count = np.bincount(bins, minlength=15)
        seen = count > 0
        gap = np.abs(np.bincount(bins, hit, 15)[seen] / count[seen] - np.bincount(bins, conf64, 15)[seen] / count[seen])
        return {"confmat": cm, "kappa": float(kappa), "mcc": float(mcc),
                "ece": float((gap * count[seen] / count.sum()).sum())}

    return {"make": make, "inputs": inputs, "direct": direct, "steps": steps,
            "groups": {0: ["confmat", "kappa", "mcc"], 1: ["ece"]}, "launches": (3, 1, 1, 1),
            "shape": {"num_classes": num_classes, "batch": batch, "n_bins": 15}}


def _exact_auroc_ap_f64(scores, labels) -> tuple:
    """Exact AUROC and AP of each row of (C, N) scores against 0/1 labels, in
    float64 numpy: AUROC as the Mann-Whitney statistic with average ranks
    (the trapezoidal area, tied scores as diagonal segments), AP as the mean
    over positives of the precision at the end of the positive's block of
    tied scores (sklearn's ``average_precision_score``)."""
    import numpy as np
    from scipy.stats import rankdata

    s = np.asarray(scores, np.float64)
    y = np.asarray(labels, np.float64)
    n = s.shape[1]
    n_pos = y.sum(1)
    n_neg = n - n_pos
    auroc = (np.sum(rankdata(s, axis=1) * y, axis=1) - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
    order = np.argsort(-s, axis=1, kind="stable")
    ss, yy = np.take_along_axis(s, order, 1), np.take_along_axis(y, order, 1)
    tps = np.cumsum(yy, axis=1)
    end = np.ones(ss.shape, bool)
    end[:, :-1] = ss[:, :-1] != ss[:, 1:]
    ends = np.where(end, np.arange(n)[None, :], n)
    block_end = np.minimum.accumulate(ends[:, ::-1], axis=1)[:, ::-1]  # the first block end at or after k
    precision = np.take_along_axis(tps, block_end, 1) / (block_end + 1)
    return auroc, np.sum(yy * precision, axis=1) / n_pos


def imagenet1k_exact_path(num_classes: int = 1000, batch: int = 1000, steps: int = 50) -> dict:
    """ImageNet-1k validation (C=1000, batch 1000, 50 updates: the
    50,000-image set) with TorchMetrics' default AUROC: MulticlassAUROC and
    MulticlassAveragePrecision at ``thresholds=None`` (exact: cat states of
    50,000 x 1,000 scores in padded buffers, one sort of the (C, N) matrix at
    compute), MulticlassRecallAtFixedPrecision(min_precision=0.5) on the same
    states, and MulticlassHingeLoss. No bincount launches."""

    def make(device, list_layout="padded", jit=True):
        from torchmetrics_tpu_torch import MetricCollection
        from torchmetrics_tpu_torch.classification import (MulticlassAUROC, MulticlassAveragePrecision,
                                                           MulticlassHingeLoss, MulticlassRecallAtFixedPrecision)

        kw = dict(num_classes=num_classes, validate_args=False, device=device, list_layout=list_layout, jit=jit)
        return MetricCollection({
            "auroc": MulticlassAUROC(**kw), "ap": MulticlassAveragePrecision(**kw),
            "rfp": MulticlassRecallAtFixedPrecision(min_precision=0.5, **kw), "hinge": MulticlassHingeLoss(**kw),
        })

    def inputs(g, dev):
        import torch

        # softmax probabilities whose true class is raised by a uniform
        # amount in [0, 10), as imagenet1k_confmat_path makes them
        target = torch.randint(0, num_classes, (steps, batch), generator=g, device=dev)
        logits = torch.randn(steps, batch, num_classes, generator=g, device=dev)
        logits.scatter_add_(2, target.unsqueeze(2), 10.0 * torch.rand(steps, batch, 1, generator=g, device=dev))
        return torch.softmax(logits, dim=-1), target

    def direct(preds, target):
        import numpy as np

        p = preds.reshape(-1, num_classes).double().cpu().numpy()
        t = target.reshape(-1).cpu().numpy()
        onehot = t[None, :] == np.arange(num_classes)[:, None]
        auroc, ap = _exact_auroc_ap_f64(p.T, onehot)
        rows = np.arange(p.shape[0])
        others = p.copy()
        others[rows, t] = -np.inf
        hinge = np.maximum(0.0, 1.0 - (p[rows, t] - others.max(1))).mean()
        return {"auroc": float(auroc.mean()), "ap": float(ap.mean()), "hinge": float(hinge)}

    return {"make": make, "inputs": inputs, "direct": direct, "steps": steps, "layouts": True,
            "sync_free_compute": True, "groups": {0: ["ap", "auroc", "rfp"], 1: ["hinge"]},
            "launches": (0, 0, 0, 0), "shape": {"num_classes": num_classes, "batch": batch, "thresholds": None}}


def jigsaw_fairness_path(comments: int = 97_320, batch: int = 4096, num_groups: int = 9) -> dict:
    """Binary toxicity scoring over the Jigsaw Unintended Bias in Toxicity
    Classification test set's size: 97,320 comments, about 8% toxic, each
    in one of 9 identity subgroups, in batches of 4,096 (23 full and a
    ragged last one of 3,112). Exact BinaryAUROC and BinaryAveragePrecision
    and BinarySpecificityAtSensitivity(min_sensitivity=0.9) share one set of
    cat states; BinaryFairness counts tp/fp/tn/fn per group in one int32
    bincount launch per update (4,096 inputs into 36 bins)."""
    steps = -(-comments // batch)

    def make(device, list_layout="padded", jit=True):
        from torchmetrics_tpu_torch import MetricCollection
        from torchmetrics_tpu_torch.classification import (BinaryAUROC, BinaryAveragePrecision, BinaryFairness,
                                                           BinarySpecificityAtSensitivity)

        kw = dict(validate_args=False, device=device, list_layout=list_layout, jit=jit)
        return MetricCollection({
            "auroc": BinaryAUROC(**kw), "ap": BinaryAveragePrecision(**kw),
            "spec_at_sens": BinarySpecificityAtSensitivity(min_sensitivity=0.9, **kw),
            "fairness": BinaryFairness(num_groups=num_groups, **kw),
        })

    def inputs(g, dev):
        import torch

        # skewed subgroup sizes, toxicity about 8%, and scores that lean
        # toward some groups, so the rates differ between groups
        weights = 0.8 ** torch.arange(num_groups, dtype=torch.float64, device=dev)
        group = torch.multinomial(weights, comments, replacement=True, generator=g)
        target = (torch.rand(comments, generator=g, device=dev) < 0.08).to(torch.int64)
        bias = torch.linspace(-0.5, 0.5, num_groups, device=dev)[group]
        logits = torch.randn(comments, generator=g, device=dev) + 3.0 * target - 2.5 + bias
        split = lambda x: list(torch.split(x, batch))  # noqa: E731
        return split(torch.sigmoid(logits)), split(target), {"groups": split(group)}

    def direct(preds, target, groups):
        import numpy as np
        import torch

        p = torch.cat(preds).double().cpu().numpy()
        t = torch.cat(target).cpu().numpy()
        grp = torch.cat(groups).cpu().numpy()
        auroc, ap = _exact_auroc_ap_f64(p[None, :], (t == 1)[None, :])
        hit = p > 0.5
        pos_rate, tpr = [], []
        for k in range(num_groups):
            in_k = grp == k
            tp, fp = np.sum(hit & (t == 1) & in_k), np.sum(hit & (t == 0) & in_k)
            fn = np.sum(~hit & (t == 1) & in_k)
            pos_rate.append((tp + fp) / in_k.sum())
            tpr.append(tp / (tp + fn))
        return {"auroc": float(auroc[0]), "ap": float(ap[0]), "DP": min(pos_rate) / max(pos_rate),
                "EO": min(tpr) / max(tpr)}

    return {"make": make, "inputs": inputs, "direct": direct, "steps": steps, "layouts": True,
            "sync_free_compute": True, "groups": {0: ["ap", "auroc", "spec_at_sens"], 1: ["fairness"]},
            "launches": (1, 1, 1, 0),
            "shape": {"comments": comments, "batch": batch, "last_batch": comments - (steps - 1) * batch,
                      "groups": num_groups}}


def coco_multilabel_exact_path(labels: int = 80, batch: int = 1024, steps: int = 40) -> dict:
    """COCO 80-label classification with the mAP multilabel papers report:
    MultilabelAveragePrecision at ``thresholds=None`` and
    MultilabelPrecisionAtFixedRecall(min_recall=0.5) on the same cat states,
    beside the three ranking metrics (coverage error, label ranking AP,
    ranking loss), batch 1,024, 40 updates. No bincount launches."""

    def make(device, list_layout="padded", jit=True):
        from torchmetrics_tpu_torch import MetricCollection
        from torchmetrics_tpu_torch.classification import (MultilabelAveragePrecision, MultilabelCoverageError,
                                                           MultilabelPrecisionAtFixedRecall,
                                                           MultilabelRankingAveragePrecision, MultilabelRankingLoss)

        kw = dict(num_labels=labels, validate_args=False, device=device, list_layout=list_layout, jit=jit)
        return MetricCollection({
            "map": MultilabelAveragePrecision(average="macro", **kw),
            "pafr": MultilabelPrecisionAtFixedRecall(min_recall=0.5, **kw),
            "coverage": MultilabelCoverageError(**kw), "lrap": MultilabelRankingAveragePrecision(**kw),
            "ranking_loss": MultilabelRankingLoss(**kw),
        })

    def inputs(g, dev):
        import torch

        # about 2.9 labels per image, as coco_multilabel_path makes them
        target = (torch.rand(steps, batch, labels, generator=g, device=dev) < 0.036).to(torch.int64)
        logits = torch.randn(steps, batch, labels, generator=g, device=dev) + 4.0 * target - 2.5
        return torch.sigmoid(logits), target

    def direct(preds, target):
        import numpy as np

        p = preds.reshape(-1, labels).double().cpu().numpy()
        y = target.reshape(-1, labels).cpu().numpy() == 1
        _, ap = _exact_auroc_ap_f64(p.T, y.T)
        n_rel, n_irr = y.sum(1), (~y).sum(1)
        min_rel = np.where(y, p, np.inf).min(1)
        coverage = np.where(n_rel > 0, (p >= min_rel[:, None]).sum(1), 0)
        # ranks by decreasing score, ties in label order (a stable sort)
        ranks = np.empty(p.shape, np.int64)
        np.put_along_axis(ranks, np.argsort(-p, axis=1, kind="stable"), np.arange(1, labels + 1)[None, :], axis=1)
        lrap, loss = [], []
        for lo in range(0, p.shape[0], 4096):
            r, yy, pp = ranks[lo:lo + 4096], y[lo:lo + 4096], p[lo:lo + 4096]
            above = (r[:, None, :] <= r[:, :, None]) & yy[:, None, :]  # [i, j, k]: relevant k ranked at or above j
            score = np.where(yy, above.sum(2) / r, 0.0).sum(1)
            nr = yy.sum(1)
            lrap.append(np.where(nr > 0, score / np.maximum(nr, 1), 1.0))
            bad = ((pp[:, :, None] <= pp[:, None, :]) & yy[:, :, None] & ~yy[:, None, :]).sum((1, 2))
            pairs = nr * (~yy).sum(1)
            loss.append(np.where(pairs > 0, bad / np.maximum(pairs, 1), 0.0))
        return {"map": float(ap.mean()), "coverage": float(coverage.mean()),
                "lrap": float(np.concatenate(lrap).mean()), "ranking_loss": float(np.concatenate(loss).mean())}

    return {"make": make, "inputs": inputs, "direct": direct, "steps": steps, "layouts": True,
            "sync_free_compute": True,
            "groups": {0: ["coverage"], 1: ["lrap"], 2: ["map", "pafr"], 3: ["ranking_loss"]},
            "launches": (0, 0, 0, 0), "shape": {"labels": labels, "batch": batch, "thresholds": None}}


def nyu_depth_path(images: int = 654, batch: int = 8, height: int = 480, width: int = 640) -> dict:
    """Monocular depth estimation evaluated on the 654 NYU Depth v2 test
    images at 480 x 640, in batches of 8: 82 updates of 2,457,600 pixels (a
    ragged last one of 6 images), the depths in metres drawn in [0.5, 10]
    and the predictions off by a log-normal factor. RMSE, MAE, squared log
    error, AbsRel (MAPE), R2, explained variance, log-cosh and Pearson over
    the flattened pixels: float32 sum states (Pearson's running moments),
    no bincount launch. Float states are held against the CPU run within
    ``state_rtol`` 1e-5: a float32 sum of n terms in any tree order is
    within ceil(log2 n) * 2^-24 of the sum of magnitudes (22 * 6e-8 =
    1.3e-6 at n = 2,457,600), and the moment sums cancel to about a tenth
    of their magnitude sums (1.3e-5 at worst); roundings of random sign
    grow as the square root of that, and the H100 reading is 3.2e-7
    (PERF.md, section 5)."""
    steps = -(-images // batch)

    def make(device, jit=True):
        from torchmetrics_tpu_torch import MetricCollection
        from torchmetrics_tpu_torch.regression import (ExplainedVariance, LogCoshError, MeanAbsoluteError,
                                                       MeanAbsolutePercentageError, MeanSquaredError,
                                                       MeanSquaredLogError, PearsonCorrCoef, R2Score)

        kw = dict(device=device, jit=jit)
        return MetricCollection({
            "rmse": MeanSquaredError(squared=False, **kw), "mae": MeanAbsoluteError(**kw),
            "msle": MeanSquaredLogError(**kw), "abs_rel": MeanAbsolutePercentageError(**kw), "r2": R2Score(**kw),
            "explained_variance": ExplainedVariance(**kw), "log_cosh": LogCoshError(**kw),
            "pearson": PearsonCorrCoef(**kw),
        })

    def inputs(g, dev):
        import torch

        target = 0.5 + 9.5 * torch.rand(images, height * width, generator=g, device=dev)
        factor = torch.exp(0.15 * torch.randn(images, height * width, generator=g, device=dev))
        preds = torch.clamp(target * factor, 0.5, 10.0)
        del factor
        split = lambda x: [c.reshape(-1) for c in torch.split(x, batch)]  # noqa: E731
        return split(preds), split(target)

    def direct(preds, target):
        import math

        import torch

        s = torch.zeros(12, dtype=torch.float64, device=preds[0].device)
        for p, t in zip(preds, target):
            p, t = p.double(), t.double()
            d = p - t
            s += torch.stack([d.pow(2).sum(), d.abs().sum(), (torch.log1p(p) - torch.log1p(t)).pow(2).sum(),
                              (d.abs() / t.abs()).sum(), t.sum(), t.pow(2).sum(), p.sum(), p.pow(2).sum(),
                              (p * t).sum(), d.sum(), (d.abs() + torch.log1p(torch.exp(-2 * d.abs()))).sum(),
                              torch.tensor(float(p.numel()), dtype=torch.float64, device=p.device)])
        sse, sae, ssle, sape, st, stt, sp, spp, spt, sd, slc, n = s.tolist()
        tss = stt - st * st / n
        var_p, var_t, cov = spp - sp * sp / n, tss, spt - sp * st / n
        return {"rmse": math.sqrt(sse / n), "mae": sae / n, "msle": ssle / n, "abs_rel": sape / n,
                "r2": 1 - sse / tss, "explained_variance": 1 - (sse / n - (sd / n) ** 2) / (tss / n),
                "log_cosh": slc / n - math.log(2.0), "pearson": cov / math.sqrt(var_p * var_t)}

    return {"make": make, "inputs": inputs, "direct": direct, "steps": steps, "launches": (0, 0, 0, 0),
            "groups": {0: ["abs_rel"], 1: ["explained_variance"], 2: ["log_cosh"], 3: ["mae"], 4: ["msle"],
                       5: ["pearson"], 6: ["r2"], 7: ["rmse"]},
            "state_rtol": 1e-5, "value_tol": 1e-5, "sync_free_update": True,
            "sync_free_compute": True,
            "shape": {"images": images, "batch": batch, "height": height, "width": width,
                      "pixels_per_update": batch * height * width, "last_batch": images - (steps - 1) * batch}}


def stsb_correlation_path(pairs: int = 1500, batch: int = 32) -> dict:
    """A GLUE STS-B dev evaluation: 1,500 sentence pairs in batches of 32
    (46 full and a ragged last one of 28), gold similarities on the
    benchmark's 0-5 scale in steps of 0.2 (many ties), predictions the gold
    plus noise. Spearman and Kendall tau-b keep float32 cat states (bitwise
    against the CPU run); Pearson and concordance (one group of moment
    states, merged per update) and MSE keep float32 sums, held within
    ``state_rtol`` 1e-5 (n = 32 per update)."""
    steps = -(-pairs // batch)

    def make(device, list_layout="padded", jit=True):
        from torchmetrics_tpu_torch import MetricCollection
        from torchmetrics_tpu_torch.regression import (ConcordanceCorrCoef, KendallRankCorrCoef, MeanSquaredError,
                                                       PearsonCorrCoef, SpearmanCorrCoef)

        kw = dict(device=device, jit=jit)
        return MetricCollection({
            "spearman": SpearmanCorrCoef(list_layout=list_layout, **kw),
            "kendall": KendallRankCorrCoef(variant="b", list_layout=list_layout, **kw),
            "pearson": PearsonCorrCoef(**kw), "concordance": ConcordanceCorrCoef(**kw), "mse": MeanSquaredError(**kw),
        })

    def inputs(g, dev):
        import torch

        gold = torch.round(25 * torch.rand(pairs, generator=g, device=dev)) / 5
        preds = torch.clamp(gold + 0.8 * torch.randn(pairs, generator=g, device=dev), 0.0, 5.0)
        return list(torch.split(preds, batch)), list(torch.split(gold, batch))

    def direct(preds, target):
        import numpy as np
        import torch
        from scipy import stats

        p = torch.cat(preds).double().cpu().numpy()
        t = torch.cat(target).double().cpu().numpy()
        cov = np.mean((p - p.mean()) * (t - t.mean()))
        return {"spearman": stats.spearmanr(p, t).statistic, "kendall": stats.kendalltau(p, t).statistic,
                "pearson": np.corrcoef(p, t)[0, 1], "mse": np.mean((p - t) ** 2),
                "concordance": 2 * cov / (p.var() + t.var() + (p.mean() - t.mean()) ** 2)}

    return {"make": make, "inputs": inputs, "direct": direct, "steps": steps, "layouts": True,
            "launches": (0, 0, 0, 0), "groups": {0: ["concordance", "pearson"], 1: ["kendall", "spearman"],
                                                 2: ["mse"]},
            "state_rtol": 1e-5, "value_tol": 1e-5, "sync_free_update": True,
            "sync_free_compute": True, "extra": kendall_50k_check,
            "shape": {"pairs": pairs, "batch": batch, "last_batch": pairs - (steps - 1) * batch}}


def kendall_50k_check(dev) -> dict:
    """``kendall_rank_corrcoef`` (tau-b) alone at n = 50,000 tied pairs
    against ``scipy.stats.kendalltau`` in float64: 1.25e9 pairs counted in
    int64 over row tiles. Timed (CUDA events, median of 3), with the device
    memory it peaks at over its inputs."""
    import torch
    from scipy import stats

    from torchmetrics_tpu_torch.functional.regression import kendall_rank_corrcoef

    n = 50_000
    g = torch.Generator(device=dev).manual_seed(99)
    gold = torch.round(25 * torch.rand(n, generator=g, device=dev)) / 5
    preds = torch.round(4 * (gold + torch.randn(n, generator=g, device=dev))) / 4
    want = stats.kendalltau(preds.double().cpu().numpy(), gold.double().cpu().numpy()).statistic
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        tau = kendall_rank_corrcoef(preds, gold, variant="b")
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    err = abs(float(tau) - want)
    if not err <= 1e-5:
        raise AssertionError(f"kendall at n={n}: tau {float(tau)} against scipy's {want}")
    return {"kendall_50k": {"n": n, "tau": float(tau), "scipy_tau": want, "abs_err": err, "tol": 1e-5,
                            "ms": statistics.median(times),
                            "peak_over_inputs_mb": (torch.cuda.max_memory_allocated() - base) / 2**20}}


def msmarco_rerank_path(queries: int = 6980, candidates: int = 1000, batch_queries: int = 100) -> dict:
    """MS MARCO passage dev re-ranking: 6,980 queries of 1,000 candidates
    each, 100 queries per update (69 of 100,000 rows and a ragged last one
    of 80,000), rows shuffled within each update, query ids sparse in
    [0, 1,102,704). One relevant passage per query, two with p = 0.065,
    none within the candidates with p = 0.1 (the default ``"neg"`` action
    scores those 0). Scores are distinct within a query (a rank order with
    the relevant passages drawn toward the top), so the float64 direct
    definitions sort them the same way. The ten metrics share one set of
    cat states: int32 ids, float32 scores, int32 targets, 6.98 M rows (84
    MB); each compute groups them by query on the card with one host read."""
    steps = -(-queries // batch_queries)

    def make(device, list_layout="padded", jit=True):
        from torchmetrics_tpu_torch import MetricCollection
        from torchmetrics_tpu_torch.retrieval import (RetrievalAUROC, RetrievalFallOut, RetrievalHitRate,
                                                      RetrievalMAP, RetrievalMRR, RetrievalNormalizedDCG,
                                                      RetrievalPrecision, RetrievalPrecisionRecallCurve,
                                                      RetrievalRecall, RetrievalRPrecision)

        kw = dict(device=device, list_layout=list_layout, jit=jit)
        return MetricCollection({
            "mrr_10": RetrievalMRR(top_k=10, **kw), "ndcg_10": RetrievalNormalizedDCG(top_k=10, **kw),
            "map": RetrievalMAP(**kw), "recall_100": RetrievalRecall(top_k=100, **kw),
            "precision_10": RetrievalPrecision(top_k=10, **kw), "hit_rate_10": RetrievalHitRate(top_k=10, **kw),
            "r_precision": RetrievalRPrecision(**kw), "fall_out_10": RetrievalFallOut(top_k=10, **kw),
            "auroc": RetrievalAUROC(**kw), "pr_curve": RetrievalPrecisionRecallCurve(max_k=100, **kw),
        })

    def inputs(g, dev):
        import torch

        qids = torch.sort(torch.randperm(1_102_704, generator=g, device=dev)[:queries]).values
        u = torch.rand(queries, 3, generator=g, device=dev)
        n_rel = torch.where(u[:, 0] < 0.1, 0, torch.where(u[:, 1] < 0.065, 2, 1))
        target = (torch.arange(candidates, device=dev)[None, :] < n_rel[:, None]).to(torch.int64)
        key = torch.rand(queries, candidates, generator=g, device=dev)
        key = key - target * torch.rand(queries, candidates, generator=g, device=dev)
        rank = torch.argsort(torch.argsort(key, dim=1, stable=True), dim=1)
        scores = ((candidates - rank).to(torch.float32) / candidates)
        ids = qids[:, None].expand(queries, candidates)
        preds, targets, indexes = [], [], []
        for lo in range(0, queries, batch_queries):
            p, t, i = (x[lo:lo + batch_queries].reshape(-1) for x in (scores, target, ids))
            perm = torch.randperm(p.shape[0], generator=g, device=dev)
            preds.append(p[perm])
            targets.append(t[perm])
            indexes.append(i[perm].contiguous())
        return preds, targets, {"indexes": indexes}

    def direct(preds, target, indexes):
        import numpy as np
        import torch

        p = torch.cat(preds).cpu().numpy()
        t = torch.cat(target).cpu().numpy()
        i = torch.cat(indexes).cpu().numpy()
        order = np.lexsort((-p.astype(np.float64), i))
        rel = t[order].reshape(-1, candidates).astype(np.float64)  # each query's targets by descending score
        n_pos = rel.sum(1)
        has = n_pos > 0
        ranks = np.arange(1, candidates + 1)
        cum = np.cumsum(rel, 1)
        first = np.argmax(rel, 1)
        rr = np.where(has & (first < 10), 1.0 / (first + 1), 0.0)
        ap = np.where(has, (cum / ranks * rel).sum(1) / np.maximum(n_pos, 1), 0.0)
        disc = 1.0 / np.log2(ranks[:10] + 1)
        idcg = np.array([disc[:int(min(k, 10))].sum() for k in n_pos])
        ndcg = np.where(has, (rel[:, :10] * disc).sum(1) / np.maximum(idcg, 1e-12), 0.0)
        rprec = np.where(has, np.array([cum[q, int(k) - 1] if k else 0.0 for q, k in enumerate(n_pos)])
                         / np.maximum(n_pos, 1), 0.0)
        neg = 1.0 - rel
        neg_after = neg.sum(1, keepdims=True) - np.cumsum(neg, 1)  # negatives ranked below each position
        auroc = np.where(has, (rel * neg_after).sum(1) / np.maximum(n_pos, 1) / neg.sum(1), 0.0)
        ks = np.arange(1, 101)
        at_k = cum[:, np.minimum(ks, candidates) - 1]  # relevant passages within the top k, k = 1..100
        prec_k = np.where(has[:, None], at_k / ks, 0.0)
        rec_k = np.where(has[:, None], at_k / np.maximum(n_pos, 1)[:, None], 0.0)
        return {"mrr_10": rr.mean(), "ndcg_10": ndcg.mean(), "map": ap.mean(),
                "recall_100": np.where(has, at_k[:, 99] / np.maximum(n_pos, 1), 0.0).mean(),
                "precision_10": np.where(has, at_k[:, 9] / 10, 0.0).mean(),
                "hit_rate_10": np.where(has, at_k[:, 9] > 0, 0.0).mean(), "r_precision": rprec.mean(),
                "fall_out_10": (neg[:, :10].sum(1) / neg.sum(1)).mean(), "auroc": auroc.mean(),
                "pr_curve": (torch.from_numpy(prec_k.mean(0)), torch.from_numpy(rec_k.mean(0)),
                             torch.arange(1, 101, dtype=torch.int32))}

    return {"make": make, "inputs": inputs, "direct": direct, "steps": steps, "layouts": True,
            "launches": (0, 0, 0, 0),
            "groups": {0: ["auroc", "fall_out_10", "hit_rate_10", "map", "mrr_10", "ndcg_10", "pr_curve",
                           "precision_10", "r_precision", "recall_100"]},
            "compute_host_reads": 1,
            "shape": {"queries": queries, "candidates": candidates, "queries_per_update": batch_queries,
                      "rows_per_update": batch_queries * candidates,
                      "last_rows": (queries - (steps - 1) * batch_queries) * candidates}}


# ---------------------------------------------------------------------------
# the reference-image paths: float64 definitions, the data, the paths
# ---------------------------------------------------------------------------

def _filter64(x, taps_h, taps_w):
    """A separable float64 filter of (N, C, H, W) ``x``, valid padding: one
    (kh, 1) and one (1, kw) depthwise pass (the port filters with one 2-D
    float32 pass)."""
    import torch.nn.functional as F

    c = x.shape[1]
    x = F.conv2d(x, taps_h.reshape(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    return F.conv2d(x, taps_w.reshape(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)


def _gauss64(size: int, sigma: float, device):
    import torch

    x = torch.arange(size, dtype=torch.float64, device=device) - (size - 1) / 2
    g = torch.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def _ssim64(p, t, data_range: float = 1.0, size: int = 11, sigma: float = 1.5):
    """Per-sample SSIM and contrast sensitivity in float64: reflect-padded
    Gaussian moments, the pad margins cropped."""
    import torch.nn.functional as F

    pad = (size - 1) // 2
    g = _gauss64(size, sigma, p.device)
    p, t = F.pad(p, (pad,) * 4, mode="reflect"), F.pad(t, (pad,) * 4, mode="reflect")
    mp, mt, pp, tt, pt = (_filter64(v, g, g) for v in (p, t, p * p, t * t, p * t))
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    vp, vt, cov = pp - mp * mp, tt - mt * mt, pt - mp * mt
    cs = (2 * cov + c2) / (vp + vt + c2)
    sim = (2 * mp * mt + c1) / (mp * mp + mt * mt + c1) * cs
    crop = (slice(None), slice(None), slice(pad, -pad), slice(pad, -pad))
    n = p.shape[0]
    return sim[crop].reshape(n, -1).mean(1), cs[crop].reshape(n, -1).mean(1)


def _ms_ssim64(p, t, data_range: float = 1.0, betas=(0.0448, 0.2856, 0.3001, 0.2363, 0.1333)):
    import torch
    import torch.nn.functional as F

    sims, css = [], []
    for i in range(len(betas)):
        sim, cs = _ssim64(p, t, data_range)
        sims.append(torch.relu(sim))
        css.append(torch.relu(cs))
        if i < len(betas) - 1:
            p, t = F.avg_pool2d(p, 2), F.avg_pool2d(t, 2)
    out = sims[-1] ** betas[-1]
    for cs, beta in zip(css[:-1], betas[:-1]):
        out = out * cs**beta
    return out


def _uqi64(p, t, size: int = 11, sigma: float = 1.5):
    """Per-sample UQI in float64 (variances clamped at 0, float32's eps in
    the denominator, as the definition the JAX package keeps)."""
    import torch
    import torch.nn.functional as F

    pad = (size - 1) // 2
    g = _gauss64(size, sigma, p.device)
    p, t = F.pad(p, (pad,) * 4, mode="reflect"), F.pad(t, (pad,) * 4, mode="reflect")
    mp, mt, pp, tt, pt = (_filter64(v, g, g) for v in (p, t, p * p, t * t, p * t))
    vp, vt = torch.clamp(pp - mp * mp, min=0.0), torch.clamp(tt - mt * mt, min=0.0)
    q = (2 * mp * mt) * (2 * (pt - mp * mt)) / ((mp * mp + mt * mt) * (vp + vt) + torch.finfo(torch.float32).eps)
    n = p.shape[0]
    return q[:, :, pad:-pad, pad:-pad].reshape(n, -1).mean(1)


def _vif64(p, t, sigma_n_sq: float = 2.0):
    """Per-sample VIF-p (channel mean) in float64."""
    import torch

    eps = 1e-10
    per_channel = []
    for c in range(p.shape[1]):
        x, y = p[:, c : c + 1], t[:, c : c + 1]
        num = torch.zeros(p.shape[0], dtype=torch.float64, device=p.device)
        den = torch.zeros_like(num)
        for scale in range(4):
            n = 2.0 ** (4 - scale) + 1.0
            g = _gauss64(int(n), n / 5.0, p.device)
            if scale > 0:
                x, y = _filter64(x, g, g)[:, :, ::2, ::2], _filter64(y, g, g)[:, :, ::2, ::2]
            mx, my = _filter64(x, g, g), _filter64(y, g, g)
            vx = torch.clamp(_filter64(x * x, g, g) - mx * mx, min=0.0)
            vy = torch.clamp(_filter64(y * y, g, g) - my * my, min=0.0)
            cxy = _filter64(x * y, g, g) - mx * my
            gain = cxy / (vy + eps)
            sv = vx - gain * cxy
            gain, sv, vy = (torch.where(vy >= eps, gain, 0.0), torch.where(vy >= eps, sv, vx),
                            torch.where(vy >= eps, vy, 0.0))
            gain, sv = torch.where(vx >= eps, gain, 0.0), torch.where(vx >= eps, sv, 0.0)
            sv = torch.where(gain >= 0, sv, vx)
            gain, sv = torch.clamp(gain, min=0.0), torch.clamp(sv, min=eps)
            num = num + torch.log2(1 + gain**2 * vy / (sv + sigma_n_sq)).sum((1, 2, 3))
            den = den + torch.log2(1 + vy / sigma_n_sq).sum((1, 2, 3))
        per_channel.append(num / (den + eps))
    return torch.stack(per_channel).mean(0)


def _sym_pad64(x, before: int, after: int):
    import torch

    x = torch.cat([x[..., :before, :].flip(-2), x, x[..., x.shape[-2] - after:, :].flip(-2)], -2)
    return torch.cat([x[..., :before].flip(-1), x, x[..., x.shape[-1] - after:].flip(-1)], -1)


def _box64(x, size: int, before: int, after: int):
    """Window means over symmetric padding in float64."""
    import torch

    box = torch.full((size,), 1.0 / size, dtype=torch.float64, device=x.device)
    return _filter64(_sym_pad64(x, before, after), box, box)


def _hp64(x):
    """SCC's Laplacian high-pass, times 2, over symmetric padding of 1."""
    import torch.nn.functional as F

    lap = -F.pad(x.new_ones(1, 1, 1, 1), (1, 1, 1, 1), value=1.0)
    lap[0, 0, 1, 1] = 8.0
    c = x.shape[1]
    return F.conv2d(_sym_pad64(x, 1, 1), lap.expand(c, 1, 3, 3), groups=c) * 2.0


def _scc64(p, t, window: int = 8):
    """Per-sample SCC in float64: the high-passed images' local correlation
    over zero-padded windows."""
    import torch
    import torch.nn.functional as F

    hp, ht = _hp64(p), _hp64(t)
    before, after = -(-(window - 1) // 2), (window - 1) // 2
    box = torch.full((window,), 1.0 / window, dtype=torch.float64, device=p.device)

    def mean(v):
        return _filter64(F.pad(v, (before, after, before, after)), box, box)

    mp, mt = mean(hp), mean(ht)
    vp, vt = torch.clamp(mean(hp * hp) - mp * mp, min=0.0), torch.clamp(mean(ht * ht) - mt * mt, min=0.0)
    den = torch.sqrt(vp) * torch.sqrt(vt)
    scc = torch.where(den == 0, 0.0, (mean(hp * ht) - mp * mt) / torch.where(den == 0, 1.0, den))
    return scc.mean((1, 2, 3))


def _rmse_maps64(p, t, window: int = 8):
    """(per-sample RMSE-SW maps, window-mean target over window**2) in float64."""
    import torch

    before, after = window // 2, window // 2 + window % 2 - 1
    rmse = torch.sqrt(torch.clamp(_box64((p - t) ** 2, window, before, after), min=0.0))
    return rmse, _box64(t, window, before, after) / window**2


def _crop64(x, window: int):
    cs = round(window / 2)
    return x[..., cs:-cs, cs:-cs]


def _d_lambda64(fused, ms):
    """D_lambda (p = 1) of whole sets, in float64."""
    bands = fused.shape[1]
    total = 0.0
    for k in range(bands):
        for r in range(k + 1, bands):
            q_ms = _uqi64(ms[:, k : k + 1], ms[:, r : r + 1]).mean()
            q_fused = _uqi64(fused[:, k : k + 1], fused[:, r : r + 1]).mean()
            total += 2 * abs(float(q_ms) - float(q_fused))
    return total / (bands * (bands - 1))


def _d_s64(fused, ms, pan, window: int = 7):
    """D_s (norm order 1, pan_lr made from pan) of whole sets, in float64."""
    import torch.nn.functional as F

    degraded = _box64(pan, window, window // 2, (window - 1) // 2)
    degraded = F.interpolate(degraded, size=ms.shape[-2:], mode="bilinear", align_corners=False, antialias=False)
    diffs = [abs(float(_uqi64(ms[:, i : i + 1], degraded[:, i : i + 1]).mean())
                 - float(_uqi64(fused[:, i : i + 1], pan[:, i : i + 1]).mean())) for i in range(fused.shape[1])]
    return sum(diffs) / len(diffs)


def _psnrb64(p, t, block: int = 8):
    """PSNR-B of a (N, 1, H, W) set in float64, by its definition: the mean
    squared error plus the blockiness of the predictions."""
    import math

    import torch

    n_img, _, h, w = p.shape
    dh, dv = (p[..., :, 1:] - p[..., :, :-1]) ** 2, (p[..., 1:, :] - p[..., :-1, :]) ** 2
    col = torch.arange(w - 1, device=p.device) % block == block - 1
    row = (torch.arange(h - 1, device=p.device) % block == block - 1)[:, None]
    bef = 0.0
    for i in range(n_img):
        d_b = (dh[i] * col).sum() + (dv[i] * row).sum()
        d_bc = (dh[i] * ~col).sum() + (dv[i] * ~row).sum()
        n_hb, n_vb = h * (w / block) - 1, w * (h / block) - 1
        d_b, d_bc = float(d_b) / (n_hb + n_vb), float(d_bc) / (h * (w - 1) - n_hb + w * (h - 1) - n_vb)
        bef += math.log2(block) / math.log2(min(h, w)) * (d_b - d_bc) if d_b > d_bc else 0.0
    mse = float(((p - t) ** 2).sum()) / t.numel() + bef
    rng = float(t.max() - t.min())
    return 10 * math.log10((rng**2 if rng > 2 else 1.0) / mse)


def _blur(x, sigma: float):
    """A Gaussian blur (9 taps, reflect padding) in float32: the degradation
    of the synthetic predictions."""
    import torch.nn.functional as F

    g = _gauss64(9, sigma, x.device).float()
    c = x.shape[1]
    x = F.pad(x, (4, 4, 4, 4), mode="reflect")
    x = F.conv2d(x, g.reshape(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    return F.conv2d(x, g.reshape(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)


def _natural(g, dev, n: int, channels: int, height: int, width: int):
    """(n, C, H, W) float32 images in [0, 1] with a photograph's spectrum,
    roughly: smooth random fields at three scales and fine texture."""
    import torch
    import torch.nn.functional as F

    img = torch.zeros(n, channels, height, width, device=dev)
    for cells, weight in ((8, 0.5), (64, 0.3), (256, 0.15)):
        low = torch.rand(n, channels, max(2, height // cells), max(2, width // cells), generator=g, device=dev)
        img += weight * F.interpolate(low, size=(height, width), mode="bilinear", align_corners=False)
    img += 0.05 * torch.rand(n, channels, height, width, generator=g, device=dev)
    return torch.clamp(img, 0.0, 1.0)


def div2k_sr_path(images: int = 100, height: int = 1356, width: int = 2040, cpu_steps: int = 2) -> dict:
    """DIV2K validation x4 super-resolution evaluation (Agustsson & Timofte,
    NTIRE 2017), as BasicSR and the SR papers report it: 100 HR images, here
    all 3 x 1356 x 2040 float32 in [0, 1] (cut: the set mixes sizes), batch
    1; the predictions are the target blurred (sigma 1.2) with Gaussian noise
    (0.02). PSNR, SSIM and MS-SSIM (data_range 1.0), UQI and VIF: float32
    sums, UQI's cat state of per-image values. The CPU run covers the first
    ``cpu_steps`` updates (an image costs it seconds); float states within
    1e-5 relative of it, values within 1e-5 of it and of float64
    definitions (separable float64 filters); each member also runs alone.
    The extra check is the TF32 check and SSIM against scipy.ndimage."""

    def make(device, jit=True):
        from torchmetrics_tpu_torch import MetricCollection
        from torchmetrics_tpu_torch.image import (MultiScaleStructuralSimilarityIndexMeasure, PeakSignalNoiseRatio,
                                                  StructuralSimilarityIndexMeasure, UniversalImageQualityIndex,
                                                  VisualInformationFidelity)

        kw = dict(device=device, jit=jit)
        return MetricCollection({
            "psnr": PeakSignalNoiseRatio(data_range=1.0, **kw), "ssim": StructuralSimilarityIndexMeasure(
                data_range=1.0, **kw), "ms_ssim": MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, **kw),
            "uqi": UniversalImageQualityIndex(**kw), "vif": VisualInformationFidelity(**kw)})

    def inputs(g, dev):
        import torch

        target = torch.cat([_natural(g, dev, 1, 3, height, width) for _ in range(images)])
        preds = torch.cat([torch.clamp(_blur(t[None], 1.2) + 0.02 * torch.randn(t[None].shape, generator=g,
                                                                                 device=dev), 0.0, 1.0)
                           for t in target])
        return preds[:, None], target[:, None]

    def direct(preds, target):
        import math

        sse = sum(float(((p.double() - t.double()) ** 2).sum()) for p, t in zip(preds, target))
        per = {"ssim": [], "ms_ssim": [], "uqi": [], "vif": []}
        for p, t in zip(preds, target):
            p, t = p.double(), t.double()
            per["ssim"].append(float(_ssim64(p, t)[0].mean()))
            per["ms_ssim"].append(float(_ms_ssim64(p, t).mean()))
            per["uqi"].append(float(_uqi64(p, t).mean()))
            per["vif"].append(float(_vif64(p, t).mean()))
        out = {k: sum(v) / len(v) for k, v in per.items()}
        out["psnr"] = 10 * math.log10(1.0 / (sse / (preds.numel())))
        return out

    def lone(device, jit):
        return dict(make(device, jit).items(keep_base=True, copy_state=False))

    return {"make": make, "inputs": inputs, "direct": direct, "steps": images, "launches": (0, 0, 0, 0),
            "groups": {0: ["ms_ssim"], 1: ["psnr"], 2: ["ssim"], 3: ["uqi"], 4: ["vif"]},
            "state_rtol": 1e-5, "value_tol": 1e-5, "sync_free_update": True, "sync_free_compute": True,
            "compute_host_reads": 0, "cpu_steps": cpu_steps, "lone": lone, "float_cat_states": ("uqi.vals",),
            "value_relative": True,
            "extra": lambda dev: {**tf32_check(dev, height, width), **ssim_sizes_check(dev)},
            "shape": {"images": images, "batch": 1, "channels": 3, "height": height, "width": width,
                      "reduced": ["every image at the set's most common size, 1356 x 2040"]}}


def wv3_reduced_path(samples: int = 20, bands: int = 8, size: int = 256, cpu_steps: int = 4) -> dict:
    """The PanCollection WorldView-3 reduced-resolution test set (Deng et
    al., IEEE GRSM 2022): 20 samples of 8 x 256 x 256 fused images against
    their ground truth, one per update. SAM, ERGAS (ratio 4), SCC, RASE,
    RMSE-SW and UQI; RASE's states become (8, 256, 256) maps at its first
    update. Float states within 1e-5 relative of the CPU run (its first
    ``cpu_steps`` updates), cat states bitwise; values within 1e-5 relative
    of the CPU run and of float64 definitions."""

    def make(device, jit=True):
        from torchmetrics_tpu_torch import MetricCollection
        from torchmetrics_tpu_torch.image import (ErrorRelativeGlobalDimensionlessSynthesis,
                                                  RelativeAverageSpectralError, RootMeanSquaredErrorUsingSlidingWindow,
                                                  SpatialCorrelationCoefficient, SpectralAngleMapper,
                                                  UniversalImageQualityIndex)

        kw = dict(device=device, jit=jit)
        return MetricCollection({
            "sam": SpectralAngleMapper(**kw), "ergas": ErrorRelativeGlobalDimensionlessSynthesis(ratio=4.0, **kw),
            "scc": SpatialCorrelationCoefficient(**kw), "rase": RelativeAverageSpectralError(**kw),
            "rmse_sw": RootMeanSquaredErrorUsingSlidingWindow(**kw), "uqi": UniversalImageQualityIndex(**kw)})

    def inputs(g, dev):
        import torch

        target = _natural(g, dev, samples, bands, size, size)
        preds = torch.clamp(_blur(target, 1.0) + 0.01 * torch.randn(target.shape, generator=g, device=dev), 0, 1)
        return preds[:, None], target[:, None]

    def direct(preds, target):
        import torch

        p, t = preds[:, 0].double(), target[:, 0].double()
        cos_num = torch.linalg.vector_norm(p / torch.linalg.vector_norm(p, dim=1, keepdim=True)
                                           - t / torch.linalg.vector_norm(t, dim=1, keepdim=True), dim=1)
        cos_den = torch.linalg.vector_norm(p / torch.linalg.vector_norm(p, dim=1, keepdim=True)
                                           + t / torch.linalg.vector_norm(t, dim=1, keepdim=True), dim=1)
        rmse_band = torch.sqrt(((p - t) ** 2).mean((2, 3)))
        ergas = 400.0 * torch.sqrt(((rmse_band / t.mean((2, 3))) ** 2).mean(1))
        rmse_map, target_map = _rmse_maps64(p, t)
        rase_map = 100.0 / (target_map.mean(0).mean(0)) * torch.sqrt((rmse_map.mean(0) ** 2).mean(0))
        return {"sam": float((2 * torch.atan2(cos_num, cos_den)).mean()), "ergas": float(ergas.mean()),
                "scc": float(torch.cat([_scc64(p[i : i + 1], t[i : i + 1]) for i in range(len(p))]).mean()),
                "rase": float(_crop64(rase_map, 8).mean()),
                "rmse_sw": float(_crop64(rmse_map, 8).mean((1, 2, 3)).mean()),
                "uqi": float(torch.cat([_uqi64(p[i : i + 1], t[i : i + 1]) for i in range(len(p))]).mean())}

    def lone(device, jit):
        return dict(make(device, jit).items(keep_base=True, copy_state=False))

    return {"make": make, "inputs": inputs, "direct": direct, "steps": samples, "launches": (0, 0, 0, 0),
            "groups": {0: ["ergas"], 1: ["rase"], 2: ["rmse_sw"], 3: ["sam"], 4: ["scc"], 5: ["uqi"]},
            "state_rtol": 1e-5, "value_tol": 1e-5, "sync_free_update": True, "sync_free_compute": True,
            "compute_host_reads": 0, "cpu_steps": cpu_steps, "lone": lone,
            "value_relative": True, "float_cat_states": ("sam.vals", "ergas.vals", "scc.vals", "uqi.vals"),
            "shape": {"samples": samples, "batch": 1, "bands": bands, "height": size, "width": size}}


def wv3_full_path(samples: int = 20, batch: int = 4, bands: int = 8, size: int = 512, ratio: int = 4,
                  cpu_steps: int = 1) -> dict:
    """The PanCollection WorldView-3 full-resolution test set: 20 samples,
    fused images of 8 x 512 x 512 from multispectral ones of 8 x 128 x 128
    and a 512 x 512 panchromatic band (repeated over the 8 bands), in
    batches of 4. D_s and QNR (pan_lr=None, so each compute makes the
    degraded pan: a 7 x 7 mean filter and the bilinear resize) take
    ``target={"ms", "pan"}``; D_lambda takes the ms as its target, so it runs
    alone. The three keep whole images as cat states: bitwise against the
    CPU run (its first batch), values within 1e-5 of it and of float64
    definitions."""

    def make(device, jit=True):
        from torchmetrics_tpu_torch import MetricCollection
        from torchmetrics_tpu_torch.image import QualityWithNoReference, SpatialDistortionIndex

        kw = dict(device=device, jit=jit)
        return MetricCollection({"d_s": SpatialDistortionIndex(**kw), "qnr": QualityWithNoReference(**kw)})

    def inputs(g, dev):
        import torch

        ms = _natural(g, dev, samples, bands, size // ratio, size // ratio)
        up = torch.nn.functional.interpolate(ms, scale_factor=ratio, mode="bicubic", align_corners=False)
        pan = torch.clamp(up.mean(1, keepdim=True) + 0.05 * _natural(g, dev, samples, 1, size, size), 0, 1)
        preds = torch.clamp(up + 0.5 * (pan - up.mean(1, keepdim=True)), 0, 1)
        pan = pan.repeat(1, bands, 1, 1)
        split = lambda x: list(torch.split(x, batch))  # noqa: E731
        return split(preds), [{"ms": m, "pan": q} for m, q in zip(split(ms), split(pan))]

    def direct(preds, target):
        import torch

        fused = torch.cat(preds).double()
        ms = torch.cat([t["ms"] for t in target]).double()
        pan = torch.cat([t["pan"] for t in target]).double()
        d_s = _d_s64(fused, ms, pan)
        return {"d_s": d_s, "qnr": (1 - _d_lambda64(fused, ms)) * (1 - d_s)}

    def lone(device, jit):
        from torchmetrics_tpu_torch.image import SpectralDistortionIndex

        return {"d_lambda": SpectralDistortionIndex(device=device, jit=jit),
                **dict(make(device, jit).items(keep_base=True, copy_state=False))}

    def lone_args(preds, target):
        return (preds, target["ms"])

    def lone_direct(preds, target):
        import torch

        return {"d_lambda": _d_lambda64(torch.cat(preds).double(), torch.cat([t["ms"] for t in target]).double())}

    return {"make": make, "inputs": inputs, "direct": direct, "steps": -(-samples // batch),
            "launches": (0, 0, 0, 0), "groups": {0: ["d_s", "qnr"]},
            "state_rtol": 1e-5, "value_tol": 1e-5, "sync_free_update": True, "sync_free_compute": True,
            "compute_host_reads": 0, "cpu_steps": cpu_steps, "lone": lone,
            "value_relative": True,
            "lone_args": {"d_lambda": lone_args}, "lone_direct": lone_direct,
            "shape": {"samples": samples, "batch": batch, "bands": bands, "height": size, "width": size,
                      "ms_size": size // ratio}}


def live1_deblock_path(images: int = 29, height: int = 512, width: int = 768) -> dict:
    """JPEG deblocking evaluated on LIVE1 (29 images) in grayscale, as the
    ARCNN/DnCNN line of work reports PSNR, PSNR-B and SSIM: here each
    1 x 512 x 768 (cut: the set mixes sizes), batch 1; the predictions carry
    a constant offset per 8 x 8 block (uniform in +-0.03) and faint noise.
    PSNR, PSNR-B and SSIM in a collection; total variation takes one input,
    so it runs alone on the predictions. Float states within 1e-5 relative
    of the CPU run, values within 1e-5 of it and of float64 definitions."""

    def make(device, jit=True):
        from torchmetrics_tpu_torch import MetricCollection
        from torchmetrics_tpu_torch.image import (PeakSignalNoiseRatio, PeakSignalNoiseRatioWithBlockedEffect,
                                                  StructuralSimilarityIndexMeasure)

        kw = dict(device=device, jit=jit)
        return MetricCollection({"psnr": PeakSignalNoiseRatio(data_range=1.0, **kw),
                                 "psnrb": PeakSignalNoiseRatioWithBlockedEffect(**kw),
                                 "ssim": StructuralSimilarityIndexMeasure(data_range=1.0, **kw)})

    def inputs(g, dev):
        import torch

        target = _natural(g, dev, images, 1, height, width)
        offsets = 0.06 * torch.rand(images, 1, height // 8, width // 8, generator=g, device=dev) - 0.03
        blocks = offsets.repeat_interleave(8, dim=2).repeat_interleave(8, dim=3)
        preds = torch.clamp(target + blocks + 0.005 * torch.randn(target.shape, generator=g, device=dev), 0, 1)
        return preds[:, None], target[:, None]

    def direct(preds, target):
        import math

        p, t = preds[:, 0].double(), target[:, 0].double()
        ssim = [float(_ssim64(p[i : i + 1], t[i : i + 1])[0].mean()) for i in range(len(p))]
        return {"psnr": 10 * math.log10(1.0 / float(((p - t) ** 2).mean())), "psnrb": _psnrb64(p, t),
                "ssim": sum(ssim) / len(ssim)}

    def lone(device, jit):
        from torchmetrics_tpu_torch.image import TotalVariation

        return {"tv": TotalVariation(device=device, jit=jit), **dict(make(device, jit).items(keep_base=True,
                                                                                           copy_state=False))}

    def lone_direct(preds, target):
        p = preds[:, 0].double()
        return {"tv": float((p[..., 1:, :] - p[..., :-1, :]).abs().sum() + (p[..., 1:] - p[..., :-1]).abs().sum())}

    return {"make": make, "inputs": inputs, "direct": direct, "steps": images, "launches": (0, 0, 0, 0),
            "groups": {0: ["psnr"], 1: ["psnrb"], 2: ["ssim"]},
            "state_rtol": 1e-5, "value_tol": 1e-5, "sync_free_update": True, "sync_free_compute": True,
            "compute_host_reads": 0, "lone": lone, "value_relative": True,
            "lone_args": {"tv": lambda preds, target: (preds,)}, "lone_direct": lone_direct,
            "shape": {"images": images, "batch": 1, "channels": 1, "height": height, "width": width,
                      "reduced": ["every image at 512 x 768"]}}


def tf32_check(dev, height: int, width: int) -> dict:
    """SSIM and VIF of one DIV2K-sized pair with
    ``torch.backends.cudnn.allow_tf32 = True`` set by the caller: within
    1e-5 of their float64 definitions, since the port pins cuDNN's float32
    convolutions to IEEE; the same with the pin taken out (cuDNN free to
    multiply in TF32), for comparison; and the float64 SSIM of the pair
    against scipy.ndimage's Gaussian filter on the host, within 1e-5."""
    import numpy as np
    import scipy.ndimage
    import torch

    from torchmetrics_tpu_torch.functional.image import (helper, structural_similarity_index_measure,
                                                         visual_information_fidelity)

    g = torch.Generator(device=dev).manual_seed(99)
    target = _natural(g, dev, 1, 3, height, width)
    preds = torch.clamp(_blur(target, 1.2) + 0.02 * torch.randn(target.shape, generator=g, device=dev), 0, 1)
    funcs = {"ssim": lambda: structural_similarity_index_measure(preds, target, data_range=1.0),
             "vif": lambda: visual_information_fidelity(preds, target)}
    wants = {"ssim": float(_ssim64(preds.double(), target.double())[0].mean()),
             "vif": float(_vif64(preds.double(), target.double()).mean())}
    gots, unpinned = {}, {}
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for name, fn in funcs.items():
            gots[name] = float(fn())
        pin = helper.ieee_fp32_convolutions
        helper.ieee_fp32_convolutions = contextlib.nullcontext
        try:
            for name, fn in funcs.items():
                unpinned[name] = float(fn())
        finally:
            helper.ieee_fp32_convolutions = pin
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    for name, want in wants.items():
        if not abs(gots[name] - want) <= 1e-5:
            raise AssertionError(f"tf32 check: {name} {gots[name]} against its float64 definition {want} with TF32 "
                                 "allowed")
    got, want = gots["ssim"], wants["ssim"]
    p, t = preds[0].double().cpu().numpy(), target[0].double().cpu().numpy()
    trunc = 5 / 1.5
    vals = []
    for c in range(p.shape[0]):
        def f(v):
            return scipy.ndimage.gaussian_filter(v, 1.5, truncate=trunc, mode="reflect")

        x, y = p[c], t[c]
        mx, my = f(x), f(y)
        cs = (2 * (f(x * y) - mx * my) + 9e-4) / (f(x * x) - mx * mx + f(y * y) - my * my + 9e-4)
        vals.append((((2 * mx * my + 1e-4) / (mx * mx + my * my + 1e-4)) * cs)[5:-5, 5:-5].mean())
    scipy_value = float(np.mean(vals))
    if not abs(scipy_value - want) <= 1e-5 or not abs(got - scipy_value) <= 1e-5:
        raise AssertionError(f"tf32 check: SSIM {got}, float64 {want}, scipy.ndimage {scipy_value}")
    return {"tf32_check": {"allow_tf32_by_caller": True, "tol": 1e-5, "ssim_scipy_ndimage": scipy_value,
                           "abs_err_scipy": abs(got - scipy_value),
                           **{name: {"value": gots[name], "float64": want, "abs_err": abs(gots[name] - want),
                                     "tf32_unpinned": unpinned[name],
                                     "abs_err_tf32_unpinned": abs(unpinned[name] - want)}
                              for name, want in wants.items()}}}


def ssim_sizes_check(dev, sizes=((1356, 2040), (1152, 2040), (1356, 1536), (648, 1020))) -> dict:
    """One lone SSIM fed four image sizes, two images each: one capture per
    size, one replay per update, states bitwise equal to an eager twin's."""
    import torch

    from torchmetrics_tpu_torch import _capture
    from torchmetrics_tpu_torch.image import StructuralSimilarityIndexMeasure

    g = torch.Generator(device=dev).manual_seed(5)
    lone = StructuralSimilarityIndexMeasure(data_range=1.0, device=dev)
    eager = StructuralSimilarityIndexMeasure(data_range=1.0, device=dev, jit=False)
    before = _capture.graph_stats()
    for h, w in sizes:
        for _ in range(2):
            target = _natural(g, dev, 1, 3, h, w)
            preds = torch.clamp(_blur(target, 1.2), 0, 1)
            lone.update(preds, target)
            eager.update(preds, target)
    captures = _capture.graph_stats()["captures"] - before["captures"]
    replays = _capture.graph_stats()["replays"] - before["replays"]
    if captures != len(sizes) or replays != 2 * len(sizes) or len(lone._update_graphs) != len(sizes):
        raise AssertionError(f"ssim sizes: {captures} captures and {replays} replays over {len(sizes)} sizes")
    for k, v in eager.metric_state.items():
        if not torch.equal(lone.metric_state[k], v):
            raise AssertionError(f"ssim sizes: state {k} differs from the eager twin")
    return {"ssim_sizes": {"sizes": [list(s) for s in sizes], "captures": captures, "replays": replays,
                           "states_equal_eager": True}}


def run_lone(label: str, path: dict, card: str, dev, inputs: tuple) -> dict:
    """Phase ``lone``: each metric of ``path["lone"]`` updated alone over the
    path's ``steps`` updates, through the captured route and through an
    eager twin (jit=False): states bitwise equal, values equal. The captured
    metric runs the steps twice. The first pass captures a graph per
    signature (RASE two: its states change shape at the first update), each
    update timed alone between syncs, so the updates that captured are timed
    apart; after a reset the second pass replays a graph at every update and
    is timed as a loop, like the eager twin's. A metric also named in
    ``lone_direct`` (one not in the collection) has its value held against
    its float64 definition and its states against a CPU run of
    ``cpu_steps`` updates."""
    import torch

    from torchmetrics_tpu_torch import _capture
    from torchmetrics_tpu_torch.interop import state_to_numpy

    preds, target, _ = inputs
    pick = path.get("lone_args", {})
    direct = path["lone_direct"](preds, target) if "lone_direct" in path else {}
    steps = path["steps"]
    card_run = dev.type == "cuda"  # CPU tensors update eagerly
    rows = {}
    for name, lone in path["lone"](dev, True).items():
        eager = path["lone"](dev, False)[name]
        args = pick.get(name, lambda p, t: (p, t))

        def drive(m, first=0, last=steps):
            for i in range(first, last):
                m.update(*args(preds[i], target[i]))

        drive(eager, 0, 1)  # allocator and library handles
        eager.reset()
        _sync(dev)
        t0 = time.perf_counter()
        drive(eager)
        _sync(dev)
        eager_s = time.perf_counter() - t0

        # first pass: every update timed alone, captures apart from replays
        stats = _capture.graph_stats()
        capture_s, captured, first_replay_s = [], 0, 0.0
        for i in range(steps):
            before = _capture.graph_stats()["captures"]
            _sync(dev)
            t0 = time.perf_counter()
            drive(lone, i, i + 1)
            _sync(dev)
            took = time.perf_counter() - t0
            if _capture.graph_stats()["captures"] > before:
                capture_s.append(took)
            else:
                first_replay_s += took
        captures = _capture.graph_stats()["captures"] - stats["captures"]
        first_replays = _capture.graph_stats()["replays"] - stats["replays"]
        # second pass: every signature has its graph, each update replays one
        lone.reset()
        stats = _capture.graph_stats()
        _sync(dev)
        t0 = time.perf_counter()
        drive(lone)
        _sync(dev)
        lone_s = time.perf_counter() - t0
        recaptures = _capture.graph_stats()["captures"] - stats["captures"]
        replays = _capture.graph_stats()["replays"] - stats["replays"]
        want_replays = steps if card_run else 0
        if ((captures >= 1) != card_run or recaptures or first_replays != want_replays
                or replays != want_replays):
            raise AssertionError(f"lone {label}.{name}: {captures} captures and {first_replays} replays over the "
                                 f"first {steps} updates, {recaptures} and {replays} over the second; expected a "
                                 "capture per signature in the first pass, none in the second, and one replay "
                                 "per update")
        _compare_states(f"lone {label}.{name}", "captured against eager", {name: state_to_numpy(lone)},
                        {name: state_to_numpy(eager)})
        value, want = lone.compute(), eager.compute()
        if not all(torch.equal(a, b) for a, b in zip(value if isinstance(value, tuple) else (value,),
                                                      want if isinstance(want, tuple) else (want,))):
            raise AssertionError(f"lone {label}.{name}: the captured value differs from the eager one")
        row = {"captures": captures, "replays_per_update": replays / steps, "steps": steps,
               "eager_ms_per_update": eager_s / steps * 1e3, "replay_ms_per_update": lone_s / steps * 1e3,
               "capture_update_ms": [t * 1e3 for t in capture_s],
               "first_pass_replay_ms_synced": first_replay_s / max(1, steps - len(capture_s)) * 1e3,
               "states_equal_eager": "bitwise"}
        if name in direct:
            row["value"] = float(value)
            row["value_err_direct"] = _check_value(f"lone {label}", f"{name} against its definition", value,
                                                   direct[name], _value_tol(path, direct[name]))
            k = path.get("cpu_steps", steps)
            ref, snap = path["lone"]("cpu", False)[name], path["lone"](dev, False)[name]
            for i in range(k):
                ref.update(*_on_cpu(list(args(preds[i], target[i]))))
                snap.update(*args(preds[i], target[i]))
            row["float_state_max_rel_err_cpu"] = _compare_states(
                f"lone {label}.{name}", f"card at update {k} against the CPU", {name: state_to_numpy(snap)},
                {name: state_to_numpy(ref)}, path.get("state_rtol"), path.get("float_cat_states", ()))
            want_cpu = ref.compute()
            row["value_err_cpu"] = _check_value(f"lone {label}", f"{name} against the CPU run", snap.compute(),
                                                want_cpu, _value_tol(path, want_cpu))
            del ref, snap
        rows[name] = row
        del lone, eager
    return {"phase": "lone", "path": label, "metrics": rows, "card": card}


def _value_tol(path: dict, want) -> float:
    """A path's value tolerance for ``want``: absolute, or with
    ``value_relative`` relative to the value where it exceeds 1 (RASE and
    PSNR run to hundreds and tens)."""
    import torch

    tol = path.get("value_tol", VALUE_TOL)
    if not path.get("value_relative"):
        return tol
    return tol * max(1.0, float(torch.as_tensor(want).double().abs().max()))


def sync_free_exact_computes(card: str) -> dict:
    """The filled exact functions the class computes go through, on the card
    at the new paths' shapes, under ``torch.cuda.set_sync_debug_mode("error")``:
    binary AUROC (97,320 scores), multiclass AUROC and AP (50,000 x 1,000).
    A host sync raises. Each is timed (CUDA events, median of 3)."""
    import torch

    from torchmetrics_tpu_torch.functional.classification import _exact_jit

    g = torch.Generator(device="cuda").manual_seed(7)
    scores = torch.rand(97_320, generator=g, device="cuda")
    labels = (torch.rand(97_320, generator=g, device="cuda") < 0.08).to(torch.int32)
    probs = torch.softmax(torch.randn(50_000, 1000, generator=g, device="cuda"), dim=-1)
    classes = torch.randint(0, 1000, (50_000,), generator=g, device="cuda")
    cases = [("binary_auroc_exact", lambda: _exact_jit.binary_auroc_exact(scores, labels)),
             ("multiclass_auroc_exact", lambda: _exact_jit.multiclass_auroc_exact(probs, classes)),
             ("multiclass_ap_exact", lambda: _exact_jit.multiclass_ap_exact(probs, classes))]
    out = []
    for name, fn in cases:
        fn()  # warm-up, outside the sync check
        torch.cuda.synchronize()
        times = []
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.set_sync_debug_mode("error")
            try:
                start.record()
                value = fn()
                end.record()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            end.synchronize()
            times.append(start.elapsed_time(end))
        if not torch.isfinite(value).all():
            raise AssertionError(f"{name}: {value}")
        out.append({"name": name, "ms": statistics.median(times), "value": float(value),
                    "peak_over_inputs_mb": (torch.cuda.max_memory_allocated() - base) / 2**20})
    return {"phase": "sync_free_compute", "sync_debug_mode": "error", "cases": out, "card": card}


def _check_value(label: str, what: str, got, want, tol: float = VALUE_TOL) -> float:
    """``got`` (a tensor, or a tuple of them) against ``want`` (the same, or
    floats): finite, of the same shape, integer values equal and float ones
    within ``tol`` elementwise; returns the largest difference."""
    import torch

    if isinstance(got, tuple):
        return max((_check_value(label, f"{what}[{i}]", g, w, tol) for i, (g, w) in enumerate(zip(got, want))),
                   default=0.0)
    got = got.detach().cpu()
    want = torch.as_tensor(want).detach().cpu()
    if not torch.isfinite(got.double()).all() or got.shape != want.shape:
        raise AssertionError(f"{label}: {what} = {got} (want shape {tuple(want.shape)})")
    if not got.is_floating_point() and not want.is_floating_point():
        if not torch.equal(got.long(), want.long()):
            raise AssertionError(f"{label}: {what} integer values differ")
        return 0.0
    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    if err > tol:
        raise AssertionError(f"{label}: {what} differs by {err} (tolerance {tol})")
    return err


def _summary(value):
    if isinstance(value, tuple):
        return [_summary(v) for v in value]
    return float(value) if value.numel() == 1 else {"shape": list(value.shape), "sum": float(value.double().sum())}


def _flat(values: dict) -> dict:
    """A collection's pure-API results with dict-valued members spread into
    their keys, as ``compute`` gives them."""
    out = {}
    for k, v in values.items():
        out.update(v if isinstance(v, dict) else {k: v})
    return out


def _step_inputs(inputs) -> tuple:
    """(preds, target, extra): per-step sequences (stacked tensors or lists
    of tensors; a ragged last step needs a list) and a dict of further
    per-step keyword inputs."""
    preds, target, *rest = inputs
    return preds, target, (rest[0] if rest else {})


def _on_cpu(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _on_cpu(v) for k, v in x.items()}
    return [_on_cpu(e) for e in x]


def _head(x, k: int):
    """The first ``k`` steps of per-step inputs (a stack, a list, or a dict
    of them)."""
    return {n: _head(v, k) for n, v in x.items()} if isinstance(x, dict) else x[:k]


def _shape(x):
    """A step input's shape (a dict of tensors: each one's)."""
    return tuple(sorted((k, tuple(v.shape)) for k, v in x.items())) if isinstance(x, dict) else tuple(x.shape)


def _update(coll, preds, target, extra, i: int) -> None:
    coll.update(preds[i], target[i], **{k: v[i] for k, v in extra.items()})


def profile_updates(coll, preds, target, extra, first: int, steps: int) -> dict:
    """Where one stateful update's time goes: :func:`profile_steps` over
    ``steps`` steady-state updates (steps ``first`` on)."""
    return profile_steps(lambda i: _update(coll, preds, target, extra, i), range(first, first + steps), "update")


def profile_steps(step, indices, unit: str = "step") -> dict:
    """Where the time of ``step(i)`` over ``indices`` goes, from a
    torch.profiler trace, per ``unit``: wall time, device busy time (the
    union of the trace's device intervals), its idle share, the bincount
    kernels' share of it, and the busiest device kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    indices = list(indices)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in indices:
            step(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        by_name[e.name] = by_name.get(e.name, 0.0) + (end - start)
    busy_us, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            busy_us += end - start
            reach = end
        elif end > reach:
            busy_us += end - reach
            reach = end
    ours = sum(v for k, v in by_name.items() if "histogram_kernel" in k)
    compress = sum(v for k, v in by_name.items() if "compress_kernel" in k)
    by_short = {}  # kernels whose names share their first 60 characters, summed
    for k, v in by_name.items():
        by_short[k[:60]] = by_short.get(k[:60], 0.0) + v
    top = sorted(by_short.items(), key=lambda kv: -kv[1])[:6]
    n = len(indices)
    return {
        f"profiled_{unit}s": n,
        f"wall_ms_per_{unit}": wall_us / n / 1e3,
        f"device_busy_ms_per_{unit}": busy_us / n / 1e3 if spans else None,
        "device_idle_share": 1.0 - busy_us / wall_us if spans else None,
        f"bincount_kernel_ms_per_{unit}": ours / n / 1e3 if spans else None,
        f"tdigest_kernel_ms_per_{unit}": compress / n / 1e3 if spans else None,
        f"device_ops_per_{unit}": len(spans) / n,
        f"top_device_ms_per_{unit}": {k: v / n / 1e3 for k, v in top},
    }


def _compare_states(label: str, how: str, got_states: dict, ref_states: dict, rtol=None, float_cats=()) -> float:
    """Every state of every member bitwise equal (a cat state, in either
    layout, as the concatenation of its valid rows); with ``rtol``, float
    tensor states, and the cat states named ``member.state`` in
    ``float_cats`` (rows of computed values, not copies of the inputs),
    within ``rtol`` of the reference elementwise, relative to its value.
    Returns the largest relative difference of those."""
    import numpy as np

    def whole(value):
        return np.concatenate(value) if isinstance(value, list) else value

    worst = 0.0
    for member, ref_state in ref_states.items():
        for key, want in ref_state.items():
            is_cat = isinstance(want, list)
            want, got = whole(want), whole(got_states[member][key])
            if got.dtype != want.dtype or got.shape != want.shape:
                raise AssertionError(f"{label}: {how} state {member}.{key} differs from the CPU run")
            relative = not is_cat or f"{member}.{key}" in float_cats
            if rtol is not None and relative and np.issubdtype(want.dtype, np.floating):
                diff = np.abs(got.astype(np.float64) - want)
                err = float(np.max(diff / np.maximum(np.abs(want), np.finfo(np.float32).tiny))) if want.size else 0.0
                worst = max(worst, err)
                if not err <= rtol:
                    raise AssertionError(f"{label}: {how} float state {member}.{key} differs from the CPU run by "
                                         f"{err} (relative; tolerance {rtol})")
            elif not (got == want).all():
                raise AssertionError(f"{label}: {how} state {member}.{key} differs from the CPU run")
    return worst


def count_host_reads(fn) -> tuple:
    """(result, synchronising CUDA calls, where each was made) of ``fn()``,
    counted under ``torch.cuda.set_sync_debug_mode("warn")``: one warning
    per call, attributed to the Python line that made it."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = [f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    return out, len(where), where


@contextlib.contextmanager
def _sync_debug(mode: str, on: bool):
    """``torch.cuda.set_sync_debug_mode(mode)`` for the block when ``on``."""
    import torch

    if on:
        torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        if on:
            torch.cuda.set_sync_debug_mode("default")


def run_path(label: str, path: dict, card: str, dev) -> int:
    """Drive one path's collection through the stateful and the pure loop,
    check groups, launch counts, states against a CPU run and values against
    it and against their direct definitions; returns the kernel launches.
    A path with ``layouts`` runs its stateful loop again under
    ``list_layout="list"``, whose states and values must equal the padded
    run's and the CPU run's; one with ``sync_free_compute`` computes under
    ``torch.cuda.set_sync_debug_mode("error")``: no host sync, and one with
    ``sync_free_update`` updates so after group discovery (the stateful and
    the pure loop). A path may also state ``state_rtol`` (float tensor
    states against the CPU run, relative; bitwise without it),
    ``value_tol`` (values against the CPU run and against their direct
    definitions, absolute; ``VALUE_TOL`` without it),
    ``compute_host_reads`` (the synchronising calls each member's compute
    must make, counted under ``set_sync_debug_mode("warn")``) and ``extra``
    (a check of its own, run after the path, whose record joins the
    path's)."""
    import torch

    from torchmetrics_tpu_torch.interop import state_to_numpy
    from torchmetrics_tpu_torch.ops.bincount import weighted_bincount

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    make, steps = path["make"], path["steps"]
    first_want, later_want, pure_want, compute_want = path["launches"]
    g = torch.Generator(device=dev).manual_seed(1234)
    preds, target, extra = _step_inputs(path["inputs"](g, dev))
    sync()

    # warm-up (allocator, library handles) on a throwaway collection; the
    # stateful loop of this phase runs every member eagerly (jit=False), the
    # fused phase below runs the default route
    warm = make(dev, jit=False)
    for i in range(min(3, steps)):
        _update(warm, preds, target, extra, i)
    warm.compute()
    warm.update_state(warm.init_state(), preds[0], target[0], **{k: v[0] for k, v in extra.items()})
    del warm
    sync()

    # stateful update loop -> compute, with the device memory it peaks at
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
    coll = make(dev, jit=False)
    weighted_bincount.launches = 0
    _update(coll, preds, target, extra, 0)
    sync()
    first = weighted_bincount.launches
    sync_free_update = bool(path.get("sync_free_update")) and dev.type == "cuda"
    t0 = time.perf_counter()
    with _sync_debug("error", sync_free_update):  # a host sync in an update raises
        for i in range(1, steps):
            _update(coll, preds, target, extra, i)
    sync()
    loop_s = time.perf_counter() - t0
    later = weighted_bincount.launches - first
    sync_free = bool(path.get("sync_free_compute")) and dev.type == "cuda"
    t0 = time.perf_counter()
    if sync_free:
        torch.cuda.set_sync_debug_mode("error")  # a host sync in compute raises
    try:
        values = coll.compute()
    finally:
        if sync_free:
            torch.cuda.set_sync_debug_mode("default")
    sync()
    compute_s = time.perf_counter() - t0
    computed = weighted_bincount.launches - first - later
    memory = None
    if dev.type == "cuda":
        memory = {"inputs_and_resident_mb": resident / 2**20,
                  "peak_mb": torch.cuda.max_memory_allocated() / 2**20,
                  "peak_over_resident_mb": (torch.cuda.max_memory_allocated() - resident) / 2**20}
    if first != first_want or later != later_want * (steps - 1) or computed != compute_want:
        raise AssertionError(f"{label}: stateful launches {first} then {later}, {computed} at compute; "
                             f"expected {first_want} then {later_want * (steps - 1)}, {compute_want}")
    if coll.compute_groups != path["groups"]:
        raise AssertionError(f"{label}: compute groups {coll.compute_groups}")

    # pure API
    weighted_bincount.launches = 0
    t0 = time.perf_counter()
    state = coll.init_state()
    with _sync_debug("error", sync_free_update):
        for i in range(steps):
            state = coll.update_state(state, preds[i], target[i], **{k: v[i] for k, v in extra.items()})
    sync()
    pure_s = time.perf_counter() - t0
    pure_launches = weighted_bincount.launches
    pure_values = _flat(coll.compute_state(state))
    sync()
    pure_computed = weighted_bincount.launches - pure_launches
    if pure_launches != pure_want * steps or pure_computed != compute_want:
        raise AssertionError(f"{label}: pure launches {pure_launches}, {pure_computed} at compute; "
                             f"expected {pure_want * steps}, {compute_want}")

    # the same run on the CPU (the kernel's plain version) over the same
    # inputs; a path with ``cpu_steps`` K runs the CPU over its first K
    # updates only, against a card run of those K updates, and holds its
    # pure run against its stateful one
    state_rtol, value_tol = path.get("state_rtol"), path.get("value_tol", VALUE_TOL)
    cpu_steps = path.get("cpu_steps", steps)
    ref = make("cpu", jit=False)
    preds_cpu, target_cpu, extra_cpu = (_on_cpu(_head(x, cpu_steps)) for x in (preds, target, extra))
    t0 = time.perf_counter()
    for i in range(cpu_steps):
        _update(ref, preds_cpu, target_cpu, extra_cpu, i)
    ref_values = ref.compute()
    cpu_s = time.perf_counter() - t0
    ref_states = state_to_numpy(ref)
    del ref, preds_cpu, target_cpu, extra_cpu

    if cpu_steps < steps:
        snap = make(dev, jit=False)
        for i in range(cpu_steps):
            _update(snap, preds, target, extra, i)
        runs = [(state_to_numpy(snap), snap.compute(), f"card at update {cpu_steps}")]
        del snap
        _compare_states(label, "pure against stateful", state_to_numpy(state), state_to_numpy(coll), state_rtol,
                        path.get("float_cat_states", ()))
        for key, want in values.items():
            _check_value(label, f"pure {key} against the stateful loop", pure_values[key], want,
                         _value_tol(path, want))
    else:
        runs = [(state_to_numpy(coll), values, "stateful"), (state_to_numpy(state), pure_values, "pure")]
    list_s = list_compute_s = None
    if path.get("layouts"):
        listed = make(dev, list_layout="list", jit=False)
        _update(listed, preds, target, extra, 0)  # group discovery, outside the timing
        sync()
        t0 = time.perf_counter()
        for i in range(1, steps):
            _update(listed, preds, target, extra, i)
        sync()
        list_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        list_values = listed.compute()
        sync()
        list_compute_s = time.perf_counter() - t0
        runs.append((state_to_numpy(listed), list_values, "list-layout"))
        del listed, list_values
    state_err = value_err = direct_err = 0.0
    for got_states, got_values, how in runs:
        state_err = max(state_err, _compare_states(label, how, got_states, ref_states, state_rtol,
                                                   path.get("float_cat_states", ())))
        for key, want in ref_values.items():
            value_err = max(value_err, _check_value(label, f"{how} {key} against the CPU run", got_values[key],
                                                    want, _value_tol(path, want)))
    del runs, state, pure_values
    # values against their definitions, computed directly in float64
    for key, want in path["direct"](preds, target, **extra).items():
        direct_err = max(direct_err, _check_value(label, f"{key} against its direct definition", values[key],
                                                  want, _value_tol(path, want)))

    # each member's compute again, its synchronising calls counted
    host_reads = None
    if "compute_host_reads" in path and dev.type == "cuda":
        host_reads, where = {}, {}
        for name, m in coll.items(keep_base=True, copy_state=False):
            m._computed = None
            _, host_reads[name], where[name] = count_host_reads(m.compute)
        if any(n != path["compute_host_reads"] for n in host_reads.values()):
            raise AssertionError(f"{label}: host reads per compute {host_reads}, expected "
                                 f"{path['compute_host_reads']} each; made at {where}")

    breakdown = None
    if dev.type == "cuda":
        prof_coll = make(dev, jit=False)
        _update(prof_coll, preds, target, extra, 0)  # group discovery, outside the trace
        breakdown = profile_updates(prof_coll, preds, target, extra, 1, min(20, steps - 1))
        del prof_coll

    emit({
        "phase": "slice", "path": label, **path["shape"], "steps": steps,
        "launches_first_update": first, "launches_per_later_update": later / (steps - 1),
        "launches_per_pure_update": pure_launches / steps,
        "stateful_updates_per_s": (steps - 1) / loop_s, "stateful_ms_per_update": loop_s / (steps - 1) * 1e3,
        "pure_updates_per_s": steps / pure_s, "pure_ms_per_update": pure_s / steps * 1e3,
        "compute_ms": compute_s * 1e3, "compute_sync_free": sync_free,
        "list_layout_ms_per_update": None if list_s is None else list_s / (steps - 1) * 1e3,
        "list_layout_compute_ms": None if list_compute_s is None else list_compute_s * 1e3,
        "launches_per_compute": computed, "values": {k: _summary(v) for k, v in values.items()},
        "cpu_steps": cpu_steps, "cpu_run_s": cpu_s,
        "states_equal_cpu": True if state_rtol is None else f"within {state_rtol} relative (floats)",
        "float_state_max_rel_err": state_err, "value_tol": value_tol, "value_max_err_cpu_run": value_err,
        "value_max_err_direct": direct_err,
        "update_sync_free": sync_free_update, "compute_host_reads": host_reads,
        "memory": memory, "profile": breakdown, "card": card,
        **(path["extra"](dev) if "extra" in path and dev.type == "cuda" else {}),
    })
    fused = run_fused(label, path, card, dev, coll, values, (preds, target, extra), loop_s / (steps - 1) * 1e3,
                      breakdown)
    if "lone" in path:
        del coll
        emit(run_lone(label, path, card, dev, (preds, target, extra)))
    return first + later + computed + pure_launches + pure_computed + fused


def _held_states(coll, names) -> tuple:
    """Each named member's ``metric_state`` as handed out, a state read as an
    attribute, and host copies of both, to check after an update."""
    held = {}
    for name in names:
        m = coll[name]
        state = m.metric_state
        for k in m._defaults:
            if k in m._list_states:
                continue
            held[(name, k)] = state[k]
            held[(name, k, "attr")] = getattr(m, k)
    copies = {key: v.detach().cpu().clone() for key, v in held.items()}
    return held, copies


def run_fused(label: str, path: dict, card: str, dev, eager, eager_values: dict, inputs: tuple, eager_ms: float,
              eager_profile) -> int:
    """Phase ``fused``: the path's stateful loop through the default route,
    where a collection runs its captured representatives as one CUDA graph
    replay per update after group discovery (update 0); update 1 captures.
    Against the eager loop ``eager`` (jit=False) of the same inputs: int32
    and cat states bitwise, float states within 1e-6 relative (values too;
    the calibration error, whose compute adds float32 rows with atomics,
    within 1e-5), the same kernel launches per update, one replay per
    update; states handed out before a fused update (``metric_state`` of a
    representative and of a grouped member, a state read as an attribute)
    unchanged after it. Returns the phase's launches."""
    import torch

    from torchmetrics_tpu_torch import _capture
    from torchmetrics_tpu_torch.interop import state_to_numpy
    from torchmetrics_tpu_torch.ops.bincount import weighted_bincount

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    preds, target, extra = inputs
    make, steps, later_want = path["make"], path["steps"], path["launches"][1]
    coll = make(dev)
    weighted_bincount.launches = 0
    _update(coll, preds, target, extra, 0)  # group discovery, every member eagerly
    captured, eager_reps = coll._fused_update_plan()
    if not captured:
        emit({"phase": "fused", "path": label, "captured": [], "eager": [n for n, _ in eager_reps], "card": card})
        return weighted_bincount.launches
    stats = _capture.graph_stats()
    before = weighted_bincount.launches
    _update(coll, preds, target, extra, 1)  # warm-up, capture and the first replay
    sync()
    build_launches = weighted_bincount.launches - before
    captures = _capture.graph_stats()["captures"] - stats["captures"]

    # states handed out before a fused update keep their values after it
    groups = coll.compute_groups
    grouped = next((g for g in groups.values() if len(g) > 1), None)
    names = [grouped[0], grouped[1]] if grouped else [next(iter(groups.values()))[0]]
    held, copies = _held_states(coll, names)
    _update(coll, preds, target, extra, 2)
    sync()
    for key, value in held.items():
        if _capture.is_graph_slot(value) or not torch.equal(value.detach().cpu(), copies[key]):
            raise AssertionError(f"fused {label}: state {key} handed out before a fused update changed after it")
    rep = coll._metrics[names[0]]
    tensor_states = [k for k in rep._defaults if k not in rep._list_states]
    if dev.type == "cuda" and tensor_states and not any(_capture.is_graph_slot(rep._buffers[k]) for k in tensor_states):
        raise AssertionError(f"fused {label}: the representative {names[0]} holds no graph slot after a replay")
    del held, copies

    launches0, stats = weighted_bincount.launches, _capture.graph_stats()

    def new_shape(i):
        return any(_shape(x[i]) != _shape(x[i - 1]) for x in (preds, target, *extra.values()))

    # an update whose inputs change shape (Jigsaw's ragged last batch) warms
    # up and captures a graph of its own: timed apart, between two syncs
    loop_s = new_shape_s = 0.0
    new_shapes = 0
    t0 = time.perf_counter()
    for i in range(3, steps):
        if new_shape(i):
            new_shapes += 1
            sync()
            t1 = time.perf_counter()
            loop_s += t1 - t0
            _update(coll, preds, target, extra, i)
            sync()
            t0 = time.perf_counter()
            new_shape_s += t0 - t1
        else:
            _update(coll, preds, target, extra, i)
    sync()
    loop_s += time.perf_counter() - t0
    n = steps - 3
    later = weighted_bincount.launches - launches0
    replays = _capture.graph_stats()["replays"] - stats["replays"]
    # a new input signature (Jigsaw's ragged last batch) captures a graph of
    # its own, whose warm-up runs the step once more
    new_graphs = _capture.graph_stats()["captures"] - stats["captures"]
    if later != later_want * (n + new_graphs) or replays != (n if dev.type == "cuda" else 0):
        raise AssertionError(f"fused {label}: {later} launches and {replays} replays over {n} updates, {new_graphs} "
                             f"graphs captured; expected {later_want} launches per update (the eager route's) and "
                             f"per warm-up, and {n} replays")
    captures += new_graphs
    int_states = _compare_nested(f"fused {label}", state_to_numpy(coll), state_to_numpy(eager))
    values = coll.compute()
    for key, want in eager_values.items():
        tol = VALUE_TOL
        if key == "ece" or path.get("value_relative"):
            tol = (1e-5 if key == "ece" else VALUE_TOL) * max(1.0, float(torch.as_tensor(want).double().abs().max()))
        _check_value(f"fused {label}", f"{key} against the eager loop", values[key], want, tol)
    total = weighted_bincount.launches
    del coll, values

    breakdown = None
    if dev.type == "cuda":
        prof_coll = make(dev)
        for i in range(2):  # group discovery and the capture, outside the trace
            _update(prof_coll, preds, target, extra, i)
        breakdown = profile_updates(prof_coll, preds, target, extra, 2, min(20, steps - 2))
        del prof_coll
    emit({
        "phase": "fused", "path": label, "captured": [name for name, _ in captured],
        "eager": [name for name, _ in eager_reps], "graphs_captured": captures,
        "launches_capture_update": build_launches, "launches_per_update": (later - later_want * new_graphs) / n,
        "eager_launches_per_update": later_want, "replays_per_update": replays / n,
        "fused_ms_per_update": loop_s / (n - new_shapes) * 1e3, "new_shape_update_ms": new_shape_s * 1e3,
        "eager_ms_per_update": eager_ms,
        "states_equal_eager": True, "integer_states_compared": int_states,
        "handed_out_states_unchanged": names,
        "profile": breakdown, "eager_profile": eager_profile, "card": card,
    })
    return total


class HostRead:
    """A metric whose update reads a value on the host (``.item()``): it
    declares itself capturable (the default), so a collection's fused
    update must refuse it, naming the member and the line."""

    @staticmethod
    def make(device):
        import torch

        from torchmetrics_tpu_torch import Metric

        class _HostRead(Metric):
            def __init__(self, **kwargs):
                super().__init__(**kwargs)
                self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

            def update(self, x):
                self.total = self.total + x.sum().item()

            def compute(self):
                return self.total

        return _HostRead(device=device)


def check_capture_refusal(card: str, dev) -> dict:
    """A member declared capturable whose update syncs with the host: the
    fused update raises ``CaptureError`` naming it and its line, and does
    not fall back to the eager loop."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection, _capture

    coll = MetricCollection({"host_read": HostRead.make(dev)})
    x = torch.ones(4, device=dev)
    coll.update(x)  # group discovery, eager
    try:
        coll.update(x)
    except _capture.CaptureError as err:
        message = str(err)
    else:
        raise AssertionError("capture_refusal: a host read inside a captured update was not refused")
    if "'host_read'" not in message or "chip_smoke.py" not in message or ".item()" not in message:
        raise AssertionError(f"capture_refusal: the error names no member or line: {message}")
    lone = HostRead.make(dev)
    try:
        lone.update(x)
    except _capture.CaptureError as err:
        lone_message = str(err)
    else:
        raise AssertionError("capture_refusal: a host read inside a lone captured update was not refused")
    if "_HostRead.update" not in lone_message or ".item()" not in lone_message:
        raise AssertionError(f"capture_refusal: the lone error names no class or line: {lone_message}")
    return {"phase": "fused", "path": "capture_refusal", "raised": "CaptureError", "message": message,
            "lone_message": lone_message, "card": card}


# ---------------------------------------------------------------------------
# path composition: the wrappers, the composition and the online metrics
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _host_sync_raises(device):
    """On the card, a host sync inside the block raises."""
    import torch

    if device.type == "cuda":
        torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        if device.type == "cuda":
            torch.cuda.set_sync_debug_mode("default")


class CompositionStep:
    """One evaluation step of a training loop as Lightning users write it,
    at bench config 2's width: a MetricTracker over Accuracy (micro), F1
    (macro) and binned AUROC (T=64); a poisson and a multinomial
    BootStrapper (10 replicas) of Accuracy and macro F1, and a poisson one
    of MeanSquaredError on a regression head's outputs (its copies loop,
    eagerly: a resample's size changes per update); Accuracy per class
    (ClasswiseWrapper), its min and max (MinMaxMetric) and over the last 5
    updates (Running); (Accuracy + F1) / 2; a MultitaskWrapper of Accuracy
    and the mean per-sample loss; and RunningMean (window 50), WindowedMean
    (horizon 64, 8 slots) and DecayedMean (half-life 50) of the per-step
    loss, ``nan_strategy="ignore"`` (a NaN step is skipped), updated under
    ``torch.cuda.set_sync_debug_mode("error")`` on the card. ``launches``
    counts each wrapper's bincount launches, ``captures`` the graphs each
    captures."""

    def __init__(self, device, num_classes: int, bootstraps: int):
        import torch

        from torchmetrics_tpu_torch import (BootStrapper, ClasswiseWrapper, DecayedMean, MeanMetric, MetricCollection,
                                            MetricTracker, MinMaxMetric, MultitaskWrapper, Running, RunningMean,
                                            WindowedMean)
        from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassAUROC, MulticlassF1Score
        from torchmetrics_tpu_torch.regression import MeanSquaredError

        kw = dict(num_classes=num_classes, validate_args=False, device=device)
        dev = dict(device=device)
        self.device = torch.device(device)
        self.wrappers = {
            "tracker": MetricTracker(MetricCollection({
                "acc": MulticlassAccuracy(average="micro", **kw), "f1": MulticlassF1Score(average="macro", **kw),
                "auroc": MulticlassAUROC(thresholds=64, **kw)}), **dev),
            "boot_poisson": BootStrapper(MulticlassAccuracy(**kw), num_bootstraps=bootstraps, quantile=[0.025, 0.975],
                                         raw=True, **dev),
            "boot_multinomial": BootStrapper(MulticlassF1Score(average="macro", **kw), num_bootstraps=bootstraps,
                                             sampling_strategy="multinomial", quantile=[0.025, 0.975], raw=True, **dev),
            "boot_mse_poisson": BootStrapper(MeanSquaredError(**dev), num_bootstraps=bootstraps, **dev),
            "classwise": ClasswiseWrapper(MulticlassAccuracy(average=None, **kw), **dev),
            "minmax": MinMaxMetric(MulticlassAccuracy(**kw), **dev),
            "running": Running(MulticlassAccuracy(**kw), window=5, **dev),
            "composition": (MulticlassAccuracy(**kw) + MulticlassF1Score(**kw)) / 2,
            "multitask": MultitaskWrapper({"cls": MulticlassAccuracy(**kw), "loss": MeanMetric(**dev)}, **dev),
        }
        self.online = {"running_mean": RunningMean(window=50, nan_strategy="ignore", **dev),
                       "windowed_mean": WindowedMean(horizon=64, slots=8, nan_strategy="ignore", **dev),
                       "decayed_mean": DecayedMean(halflife=50.0, nan_strategy="ignore", **dev)}
        self.launches = dict.fromkeys(self.wrappers, 0)
        self.captures = dict.fromkeys(self.wrappers, 0)
        # host seconds in each wrapper's update (no sync: the device idles
        # through most of an update, so this is mostly the host's own cost)
        self.host_s = dict.fromkeys([*self.wrappers, "online"], 0.0)
        self.wrappers["tracker"].increment()

    def update(self, preds, target, loss, step_loss, reg_preds, reg_target) -> None:
        from torchmetrics_tpu_torch import _capture
        from torchmetrics_tpu_torch.ops.bincount import weighted_bincount

        for name, m in self.wrappers.items():
            before, captured, t0 = weighted_bincount.launches, _capture.graph_stats()["captures"], time.perf_counter()
            if name == "multitask":
                m.update({"cls": preds, "loss": loss}, {"cls": target, "loss": 1.0})
            elif name == "boot_mse_poisson":
                m.update(reg_preds, reg_target)
            else:
                m.update(preds, target)
            self.host_s[name] += time.perf_counter() - t0
            self.launches[name] += weighted_bincount.launches - before
            self.captures[name] += _capture.graph_stats()["captures"] - captured
        t0 = time.perf_counter()
        with _host_sync_raises(self.device):
            for m in self.online.values():
                m.update(step_loss)
        self.host_s["online"] += time.perf_counter() - t0

    def compute(self) -> dict:
        """Every result as a flat {name: tensor} dict; the online computes
        run under the sync check too."""
        import torch

        out = {}

        def add(prefix, value):
            if isinstance(value, dict):
                for k, v in value.items():
                    add(f"{prefix}.{k}", v)
            else:
                out[prefix] = torch.as_tensor(value)

        for name, m in self.wrappers.items():
            add(name, m.compute())
        add("tracker_all", self.wrappers["tracker"].compute_all())
        best, step = self.wrappers["tracker"].best_metric(return_step=True)
        add("tracker_best", best)
        add("tracker_best_step", step)
        with _host_sync_raises(self.device):
            for name, m in self.online.items():
                add(name, m.compute())
        return out

    def states(self) -> dict:
        from torchmetrics_tpu_torch.interop import state_to_numpy

        return {name: state_to_numpy(m) for name, m in {**self.wrappers, **self.online}.items()}


def _compare_nested(label: str, got, want, where: str = "") -> int:
    """``got`` against ``want`` (nested numpy states): integer leaves
    bitwise, float leaves within ``VALUE_TOL`` relative to the value above 1
    (the card sums in another order than the CPU). Returns the number of
    integer leaves compared."""
    import numpy as np

    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{label}: {where} keys {sorted(got)} differ from the CPU run's {sorted(want)}")
        return sum(_compare_nested(label, got[k], want[k], f"{where}.{k}") for k in want)
    if isinstance(want, list):
        if len(got) != len(want):
            raise AssertionError(f"{label}: {where} has {len(got)} entries, the CPU run {len(want)}")
        return sum(_compare_nested(label, g, w, f"{where}[{i}]") for i, (g, w) in enumerate(zip(got, want)))
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{label}: {where} is {got.dtype}{got.shape}, the CPU run's {want.dtype}{want.shape}")
    if not np.issubdtype(want.dtype, np.floating):
        if not (got == want).all():
            raise AssertionError(f"{label}: integer state {where} differs from the CPU run")
        return 1
    err = float(np.max(np.abs(got.astype(np.float64) - want) / np.maximum(1.0, np.abs(want)))) if want.size else 0.0
    if not err <= VALUE_TOL:
        raise AssertionError(f"{label}: float state {where} differs from the CPU run by {err}")
    return 0


def _composition_inputs(g, dev, num_classes: int, batch: int, steps: int) -> tuple:
    """Float32 logits, labels, per-sample cross-entropy and its per-step
    mean, and a regression head's outputs and targets."""
    import torch

    logits = torch.randn(steps, batch, num_classes, generator=g, device=dev)
    target = torch.randint(0, num_classes, (steps, batch), generator=g, device=dev)
    loss = torch.nn.functional.cross_entropy(logits.reshape(-1, num_classes), target.reshape(-1),
                                             reduction="none").reshape(steps, batch)
    reg_target = torch.rand(steps, batch, generator=g, device=dev)
    reg_preds = reg_target + 0.1 * torch.randn(steps, batch, generator=g, device=dev)
    return logits, target, {"loss": loss, "step_loss": loss.mean(1), "reg_preds": reg_preds,
                            "reg_target": reg_target}


def _drive_composition(step: CompositionStep, preds, target, extra, epochs: int, per_epoch: int) -> None:
    for e in range(epochs):
        if e:
            step.wrappers["tracker"].increment()
        for i in range(e * per_epoch, (e + 1) * per_epoch):
            _update(step, preds, target, extra, i)


def run_composition(card: str, dev, num_classes: int = 100, batch: int = 1024, epochs: int = 4,
                    per_epoch: int = 50, bootstraps: int = 10) -> int:
    """Path ``composition`` at bench config 2's width (C=100, batch 1,024,
    float32 logits), 200 updates as 4 epochs of 50: every wrapper's
    bincount launches per update (1 per BootStrapper update for all its
    replicas, 1 per wrapped stat-score update and, on the card, 1 more at
    the warm-up before the inner metric's own capture, the tracker's collection 3
    on an epoch's first update, 2 + 2 on the second, whose fused update
    warms up and captures its graph, and 2 after), every state (the BootStrapper's
    stacked int32 ones included) and value against a device="cpu" run on the
    same inputs (integer states bitwise, floats within 1e-6 relative above
    1), a few values against their direct definitions, the windowed and
    decayed updates and computes under set_sync_debug_mode("error"), a
    torch.profiler breakdown and the peak device memory. Returns the
    launches of the driven run."""
    import torch

    from torchmetrics_tpu_torch.ops.bincount import weighted_bincount

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    steps = epochs * per_epoch
    g = torch.Generator(device=dev).manual_seed(4321)
    preds, target, extra = _composition_inputs(g, dev, num_classes, batch, steps)
    sync()
    warm = CompositionStep(dev, num_classes, bootstraps)  # allocator, library handles
    for i in range(3):
        _update(warm, preds, target, extra, i)
    warm.compute()
    del warm
    sync()

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
    step = CompositionStep(dev, num_classes, bootstraps)
    weighted_bincount.launches = 0
    t0 = time.perf_counter()
    _drive_composition(step, preds, target, extra, epochs, per_epoch)
    sync()
    loop_s = time.perf_counter() - t0
    launches = weighted_bincount.launches
    t0 = time.perf_counter()
    values = step.compute()
    sync()
    compute_s = time.perf_counter() - t0
    computed = weighted_bincount.launches - launches
    memory = None
    if dev.type == "cuda":
        memory = {"inputs_and_resident_mb": resident / 2**20, "peak_mb": torch.cuda.max_memory_allocated() / 2**20,
                  "peak_over_resident_mb": (torch.cuda.max_memory_allocated() - resident) / 2**20}
    card_run = dev.type == "cuda"
    want = {name: steps for name in step.launches}
    # the tracker's collection of each epoch: 3 at group discovery, then one
    # graph replay of 2 per update, and on the card the warm-up before its
    # capture 2 more (CPU tensors take the plain step, with no warm-up)
    want["tracker"] = epochs * 3 + (steps - epochs) * 2 + (epochs * 2 if card_run else 0)
    want["composition"] = 2 * steps + (2 if card_run else 0)
    # an inner stat-score metric the wrapper updates alone replays its own
    # graph on the card, whose warm-up launches once more at its capture
    for name in ("classwise", "minmax", "multitask"):
        want[name] += 1 if card_run else 0
    want["boot_mse_poisson"] = 0  # MeanSquaredError launches no bincount
    if step.launches != want or computed or launches != sum(want.values()):
        raise AssertionError(f"composition: launches {step.launches} ({launches} in all), {computed} at compute; "
                             f"expected {want}, none at compute")
    # a Poisson resample's size changes per update: its copies stay eager
    if step.captures["boot_mse_poisson"]:
        raise AssertionError(f"composition: the poisson BootStrapper's copies captured "
                             f"{step.captures['boot_mse_poisson']} graphs")

    ref = CompositionStep(torch.device("cpu"), num_classes, bootstraps)
    preds_cpu, target_cpu, extra_cpu = _on_cpu(preds), _on_cpu(target), _on_cpu(extra)
    _drive_composition(ref, preds_cpu, target_cpu, extra_cpu, epochs, per_epoch)
    int_states = _compare_nested("composition", step.states(), ref.states())
    ref_values = ref.compute()
    if set(values) != set(ref_values):
        raise AssertionError(f"composition: results {sorted(set(values) ^ set(ref_values))} differ in name")
    for key, want_value in ref_values.items():
        _check_value("composition", f"{key} against the CPU run", values[key], want_value)
    stacked = step.wrappers["boot_poisson"].tp
    if stacked.dtype != torch.int32 or tuple(stacked.shape) != (bootstraps, num_classes):
        raise AssertionError(f"composition: stacked BootStrapper state {stacked.dtype}{tuple(stacked.shape)}")
    del ref

    # values against their definitions, in float64
    last = slice((epochs - 1) * per_epoch, steps)
    direct = {
        "tracker.acc": (preds[last].argmax(-1) == target[last]).double().mean().item(),
        "multitask.loss": extra["loss"].double().mean().item(),
        "running_mean": extra["step_loss"][-50:].double().mean().item(),
    }
    for key, want_value in direct.items():
        got = values[key].double().item()
        if not abs(got - want_value) <= VALUE_TOL * max(1.0, abs(want_value)):
            raise AssertionError(f"composition: {key} = {got}, its definition {want_value}")

    breakdown = None
    if dev.type == "cuda":
        prof_step = CompositionStep(dev, num_classes, bootstraps)
        for i in range(2):  # group discovery and the tracker's capture, outside the trace
            _update(prof_step, preds, target, extra, i)
        breakdown = profile_updates(prof_step, preds, target, extra, 2, min(20, steps - 2))
        del prof_step

    emit({
        "phase": "slice", "path": "composition", "num_classes": num_classes, "batch": batch, "epochs": epochs,
        "steps": steps, "bootstraps": bootstraps,
        "launches_per_update": {k: v / steps for k, v in step.launches.items()}, "captures": step.captures,
        "host_ms_per_update": {k: v / steps * 1e3 for k, v in step.host_s.items()},
        "launches": launches, "launches_per_compute": computed,
        "stateful_updates_per_s": steps / loop_s, "stateful_ms_per_update": loop_s / steps * 1e3,
        "compute_ms": compute_s * 1e3, "online_sync_debug_mode": "error" if dev.type == "cuda" else None,
        "integer_states_equal_cpu": int_states, "values": {k: _summary(v) for k, v in values.items()
                                                           if v.numel() <= 16},
        "memory": memory, "profile": breakdown, "card": card,
    })
    return launches


# ---------------------------------------------------------------------------
# phases streaming, config1 and step_overhead: the captured update path
# ---------------------------------------------------------------------------

def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def run_streaming(card: str, dev, num_classes: int = 100, batch: int = 1024, steps: int = 200,
                  windows: tuple = (1, 8, 32)) -> tuple:
    """Phase ``streaming``: bench config 2 (Accuracy + F1 + binned AUROC,
    C=100, batch 1,024) through ``coll.buffered(window=K)`` over ``steps``
    updates, for each K (200 = 6 x 32 + 8: the last window at K=32 is
    short). Each K runs once to capture its K-step graph, is reset, and runs
    again timed: updates plus the last flush, synchronised; then compute.
    States against an eager loop (jit=False) of the same inputs as in
    ``fused``; one replay per flush. Returns the record and the launches."""
    import torch

    from torchmetrics_tpu_torch import _capture
    from torchmetrics_tpu_torch.interop import state_to_numpy
    from torchmetrics_tpu_torch.ops.bincount import weighted_bincount
    from torchmetrics_tpu_torch.streaming import stream_stats

    path = multiclass_path(num_classes=num_classes, batch=batch, steps=steps)
    g = torch.Generator(device=dev).manual_seed(1234)
    preds, target = path["inputs"](g, dev)
    eager = path["make"](dev, jit=False)
    for i in range(steps):
        eager.update(preds[i], target[i])
    eager_values = eager.compute()
    ref = state_to_numpy(eager)
    del eager
    rows, launches = [], 0
    for window in windows:
        handle = path["make"](dev).buffered(window=window)
        for i in range(steps):
            handle.update(preds[i], target[i])
        handle.compute()  # captures the K-step graph (and flushes the short window)
        handle.reset()
        _sync(dev)
        weighted_bincount.launches = 0
        flushes0, replays0 = stream_stats()["flushes"], _capture.graph_stats()["replays"]
        t0 = time.perf_counter()
        for i in range(steps):
            handle.update(preds[i], target[i])
        staged_s = time.perf_counter() - t0
        handle.flush()
        _sync(dev)
        total_s = time.perf_counter() - t0
        run_launches = weighted_bincount.launches
        flushes = stream_stats()["flushes"] - flushes0
        replays = _capture.graph_stats()["replays"] - replays0
        want_flushes = -(-steps // window)
        if flushes != want_flushes or (dev.type == "cuda" and replays != flushes):
            raise AssertionError(f"streaming K={window}: {flushes} flushes and {replays} replays; expected "
                                 f"{want_flushes} flushes, one replay each")
        if not run_launches:
            raise AssertionError(f"streaming K={window}: the bincount kernel was launched no time")
        int_states = _compare_nested(f"streaming K={window}", state_to_numpy(handle.collection), ref)
        values = handle.compute()
        for key, want in eager_values.items():
            _check_value(f"streaming K={window}", f"{key} against the eager loop", values[key], want)
        launches += run_launches
        rows.append({"window": window, "flushes": flushes, "replays_per_flush": replays / flushes,
                     "launches_per_step": run_launches / steps, "ms_per_step": total_s / steps * 1e3,
                     "staging_ms_per_step": staged_s / steps * 1e3, "updates_per_s": steps / total_s,
                     "ring_mb": handle.ring_bytes() / 2**20, "integer_states_compared": int_states,
                     "states_equal_eager": True})
        del handle, values
    return {"phase": "streaming", "path": "bench_config2", "num_classes": num_classes, "batch": batch,
            "steps": steps, "windows": rows, "card": card}, launches


def run_config1(card: str, dev, num_classes: int = 100, batch: int = 1024, steps: int = 1000,
                window: int = 32) -> tuple:
    """Phase ``config1``, the counterpart of ``bench.py:133``
    ``bench_config1``: MulticlassAccuracy (C=100, micro,
    validate_args=False) over 1,000 steps of batch 1,024 (the inputs take
    410 MB), through ``update_state_batched`` (a Python loop over the
    steps, then the merge by reduction), the stateful loop eagerly
    (jit=False) and through the lone metric's captured update (one replay
    per update), and ``buffered(window=32)`` (1,000 = 31 x 32 + 8). Updates
    per second of each, host clock around work that ends in a
    synchronisation; the int32 states of the four routes bitwise equal.
    Returns the record and the launches."""
    import torch

    from torchmetrics_tpu_torch import _capture
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy
    from torchmetrics_tpu_torch.ops.bincount import weighted_bincount

    g = torch.Generator(device=dev).manual_seed(0)
    preds = torch.softmax(torch.randn(steps, batch, num_classes, generator=g, device=dev), dim=-1)
    target = torch.randint(0, num_classes, (steps, batch), generator=g, device=dev)
    _sync(dev)

    def make(jit=True):
        return MulticlassAccuracy(num_classes=num_classes, average="micro", validate_args=False, device=dev, jit=jit)

    routes, states, launches = {}, {}, 0

    def timed(name, fn):
        nonlocal launches
        _sync(dev)
        weighted_bincount.launches = 0
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        seconds = time.perf_counter() - t0
        if not weighted_bincount.launches:
            raise AssertionError(f"config1 {name}: the bincount kernel was launched no time")
        launches += weighted_bincount.launches
        routes[name] = {"updates_per_s": steps / seconds, "ms_per_update": seconds / steps * 1e3,
                        "launches_per_update": weighted_bincount.launches / steps}
        return out

    batched = make()
    batched.update_state_batched(batched.init_state(), preds[:4], target[:4])  # warm-up
    state = timed("update_state_batched", lambda: batched.update_state_batched(batched.init_state(), preds, target))
    states["update_state_batched"] = state

    def loop(metric):
        for i in range(steps):
            metric.update(preds[i], target[i])

    # the eager stateful loop (jit=False), and the same loop where the lone
    # metric replays its captured update (captured at the warm-up)
    for name, jit in (("stateful", False), ("stateful_captured", True)):
        stateful = make(jit)
        for i in range(3):  # warm-up
            stateful.update(preds[i], target[i])
        stateful.reset()
        graphs = _capture.graph_stats()
        timed(name, lambda: loop(stateful))
        replays = _capture.graph_stats()["replays"] - graphs["replays"]
        captures = _capture.graph_stats()["captures"] - graphs["captures"]
        if (replays, captures) != ((steps, 0) if jit and dev.type == "cuda" else (0, 0)):
            raise AssertionError(f"config1 {name}: {replays} replays and {captures} captures over {steps} updates")
        routes[name]["replays_per_update"] = replays / steps
        states[name] = stateful.metric_state

    buffered_metric = make()
    handle = buffered_metric.buffered(window=window)
    for i in range(2 * window):  # captures the graph
        handle.update(preds[i], target[i])
    handle.reset()

    def buffered_loop():
        for i in range(steps):
            handle.update(preds[i], target[i])
        handle.flush()

    timed(f"buffered(window={window})", buffered_loop)
    states["buffered"] = buffered_metric.metric_state
    for name in ("stateful", "stateful_captured", "buffered"):
        for k, want in states["update_state_batched"].items():
            got = states[name][k]
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError(f"config1: {name} state {k} differs from update_state_batched's")
    value = buffered_metric.compute()
    want = (preds.argmax(-1) == target).double().mean().item()
    _check_value("config1", "accuracy against its definition", value, want)
    return {"phase": "config1", "metric": "MulticlassAccuracy(micro)", "num_classes": num_classes, "batch": batch,
            "steps": steps, "inputs_mb": (preds.numel() * 4 + target.numel() * 8) / 1e6, "routes": routes,
            "states_equal": True, "accuracy": float(value), "card": card}, launches


def run_step_overhead(card: str, dev, d_in: int = 2048, d_h: int = 8192, depth: int = 4, num_classes: int = 100,
                      batch: int = 512, steps: int = 100, reps: int = 9, buffered_steps: int = 96,
                      windows: tuple = (1, 8, 32), buffered_reps: int = 5) -> tuple:
    """Phase ``step_overhead``, the counterpart of ``bench.py:1462-1560``
    in eager PyTorch: a bf16 MLP (``d_in`` 2048, ``d_h`` 8192, depth 4,
    tanh; its matmuls ``torch.matmul``, as the JAX package leaves them to
    XLA) trained by SGD (lr 0.01) on batch 512, C=100, 100 steps an epoch.
    Variants, in paired interleaved repetitions: metrics off; bench config
    2's collection updated per step with the softmax of the logits, every
    member eager (jit=False); the same through the fused update; and
    ``buffered(window=K)`` for K in 1, 8, 32 over 96 steps, with a compute
    at the epoch's end (its flush). The cost of a variant is the median of
    the per-repetition (on - off) epoch times (``bench.py:1517-1530``), its
    share that over the median metrics-off epoch. Returns the record and
    the launches."""
    import statistics as st

    import torch
    import torch.nn.functional as F

    from torchmetrics_tpu_torch.ops.bincount import weighted_bincount

    g = torch.Generator(device=dev).manual_seed(2)

    def weight(rows, cols):
        return (torch.randn(rows, cols, generator=g, device=dev) * 0.02).to(torch.bfloat16).requires_grad_()

    params = [weight(d_in, d_h)] + [weight(d_h, d_h) for _ in range(depth)] + [weight(d_h, num_classes)]
    xs = torch.randn(steps, batch, d_in, generator=g, device=dev)
    ys = torch.randint(0, num_classes, (steps, batch), generator=g, device=dev)
    path = multiclass_path(num_classes=num_classes, batch=batch, steps=steps)

    def train_step(x, y):
        h = torch.tanh(torch.matmul(x.to(torch.bfloat16), params[0]))
        for w in params[1:-1]:
            h = torch.tanh(torch.matmul(h, w))
        logits = torch.matmul(h, params[-1]).to(torch.float32)
        grads = torch.autograd.grad(F.cross_entropy(logits, y), params)
        with torch.no_grad():
            for p, grad in zip(params, grads):
                p.sub_(grad, alpha=0.01)
        return logits.detach()

    def epoch(n, update=None, finish=None):
        t0 = time.perf_counter()
        for i in range(n):
            logits = train_step(xs[i], ys[i])
            if update is not None:
                update(torch.softmax(logits, dim=-1), ys[i])
        if finish is not None:
            finish()
        _sync(dev)
        return time.perf_counter() - t0

    colls = {"eager": path["make"](dev, jit=False), "fused": path["make"](dev)}
    for coll in colls.values():  # group discovery and the capture
        epoch(3, coll.update)
    epoch(3)
    weighted_bincount.launches = 0
    times = {"off": [], "eager": [], "fused": []}
    for _ in range(reps):
        times["off"].append(epoch(steps))
        for name, coll in colls.items():
            coll.reset()
            times[name].append(epoch(steps, coll.update))
    launches = weighted_bincount.launches
    if not launches:
        raise AssertionError("step_overhead: the bincount kernel was launched no time")
    off = st.median(times["off"])
    variants = {}
    for name in ("eager", "fused"):
        diff = st.median([on - o for on, o in zip(times[name], times["off"])])
        variants[name] = {"metrics_ms_per_step": diff / steps * 1e3, "share_of_step": diff / off}
    for window in windows:
        handle = path["make"](dev).buffered(window=window)
        epoch(buffered_steps, handle.update, handle.compute)  # discovery and the capture
        handle.reset()
        diffs, offs = [], []
        before = weighted_bincount.launches
        for _ in range(buffered_reps):
            o = epoch(buffered_steps)
            on = epoch(buffered_steps, handle.update, handle.compute)
            handle.reset()
            diffs.append(on - o)
            offs.append(o)
        launches += weighted_bincount.launches - before
        diff = st.median(diffs)
        variants[f"buffered(window={window})"] = {"metrics_ms_per_step": diff / buffered_steps * 1e3,
                                                  "share_of_step": diff / st.median(offs)}
        del handle
    return {"phase": "step_overhead", "model": {"d_in": d_in, "d_h": d_h, "depth": depth, "dtype": "bfloat16",
                                                "num_classes": num_classes, "batch": batch, "lr": 0.01},
            "steps": steps, "reps": reps, "step_ms_metrics_off": off / steps * 1e3, "variants": variants,
            "card": card}, launches


# ---------------------------------------------------------------------------
# phases cifar10_fid, bapps_lpips, ppl_vgg, model_tf32: the model-based image
# metrics, whose networks run at their published widths on seeded random
# weights; every update eager (jittable = False), no graph captured
# ---------------------------------------------------------------------------

# card against a device="cpu" run of the same inputs and weights: cuDNN's and
# oneDNN's float32 convolutions (both IEEE, the port pins cuDNN's) add in
# different orders through ~50 layers, and eigh runs on cuSOLVER against
# LAPACK
FEATURE_RTOL = 1e-4  # network outputs, relative to each tap's largest magnitude
# FID and MiFID of 32 images a side (covariances of rank 31 at width 2048), and
# their computes on the same states: float32 eigh resolves an eigenvalue to
# ~1e-7 of the largest, and the square-root trace sums 2,048 of them
FID_CPU_RTOL = 1e-2
SCORE_CPU_RTOL = 1e-3  # KID and IS of 32 images a side, relative to the mean
LPIPS_CPU_RTOL = 1e-5  # LPIPS distances
PPL_CPU_RTOL = 2e-2  # PPL at epsilon 1e-4: distances of images 1e-4 apart, divided by 1e-8
# FID from float32 moments of 5,000 images a side, against float64 numpy/scipy: the
# same float32 eigh, on a spectrum a random network concentrates in a few directions
FID_F64_RTOL = 2e-2
TF32_CHECK_RTOL = 1e-5  # Inception features with TF32 allowed by the caller, against the pinned run


def _rel_err(got, want) -> float:
    """Largest difference of ``got`` from ``want`` relative to ``want``'s
    largest magnitude (tensors, or tuples of them taken as one: a (mean,
    std) pair is held relative to the mean), on any devices."""
    import torch

    def flat(x):
        if isinstance(x, (tuple, list)):
            return torch.cat([flat(e) for e in x])
        return torch.as_tensor(x).detach().double().cpu().reshape(-1)

    got, want = flat(got), flat(want)
    if got.shape != want.shape or not torch.isfinite(got).all():
        return float("inf")
    scale = float(want.abs().max()) if want.numel() else 0.0
    return float((got - want).abs().max()) / scale if scale else float((got - want).abs().max())


def _hold(label: str, what: str, err: float, tol: float) -> float:
    if not err <= tol:
        raise AssertionError(f"{label}: {what} differs by {err} relative (tolerance {tol})")
    return err


class _ModelRun:
    """Counts kept over one path's driven run: graphs captured (none may be:
    the six metrics update eagerly), bincount launches (none: the kernel is
    not on these paths) and the device memory peak over what was resident."""

    def __init__(self, dev):
        import torch

        from torchmetrics_tpu_torch import _capture
        from torchmetrics_tpu_torch.ops.bincount import weighted_bincount

        self.dev, self._capture, self._bincount = dev, _capture, weighted_bincount
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self.resident = torch.cuda.memory_allocated()
        self.graphs = _capture.graph_stats()
        weighted_bincount.launches = 0

    def close(self, label: str, metrics) -> dict:
        import torch

        captures = self._capture.graph_stats()["captures"] - self.graphs["captures"]
        replays = self._capture.graph_stats()["replays"] - self.graphs["replays"]
        held = sum(len(m._update_graphs) for m in metrics)
        if captures or replays or held:
            raise AssertionError(f"{label}: {captures} graphs captured, {replays} replays, {held} held by the metrics")
        if self._bincount.launches:
            raise AssertionError(f"{label}: {self._bincount.launches} bincount launches on a path without the kernel")
        out = {"captures": 0, "bincount_launches": 0}
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
            out["memory"] = {"inputs_and_resident_mb": self.resident / 2**20,
                             "peak_mb": torch.cuda.max_memory_allocated() / 2**20,
                             "peak_over_resident_mb": (torch.cuda.max_memory_allocated() - self.resident) / 2**20}
        return out


def _sync_dev(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def _network_flops(net, x) -> int:
    """Floating-point operations of one forward of ``net`` on ``x``: two per
    multiply-add of every convolution and linear layer, from their output
    shapes (pools, BatchNorm and activations left out)."""
    import torch

    total = [0]

    def count(module, inputs, output):
        if isinstance(module, torch.nn.Conv2d):
            kh, kw = module.kernel_size
            total[0] += 2 * output.numel() * module.in_channels // module.groups * kh * kw
        elif isinstance(module, torch.nn.Linear):
            total[0] += 2 * output.numel() * module.in_features

    hooks = [m.register_forward_hook(count) for m in net.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            net(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def _fid_taps(net):
    """The 2048 features and the 1008 logits of one forward of ``net`` per
    input batch (a NetworkCache keyed on the tensor), for the four metrics."""
    from torchmetrics_tpu_torch.wrappers.feature_share import NetworkCache

    cache = NetworkCache(net, max_size=2)
    return (lambda imgs: cache(imgs)[2048]), (lambda imgs: cache(imgs)["logits_unbiased"])


def _fid_collection(device, net, kid_subsets: int, kid_subset_size: int, is_splits: int):
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.image import (FrechetInceptionDistance, InceptionScore, KernelInceptionDistance,
                                              MemorizationInformedFrechetInceptionDistance)

    features, logits = _fid_taps(net)
    return MetricCollection({
        "fid": FrechetInceptionDistance(feature=features, device=device),
        "kid": KernelInceptionDistance(feature=features, subsets=kid_subsets, subset_size=kid_subset_size,
                                       device=device),
        "is": InceptionScore(feature=logits, splits=is_splits, device=device),
        "mifid": MemorizationInformedFrechetInceptionDistance(feature=features, device=device),
    })


def _cifar_images(g, dev, n: int, fake: bool):
    """(n, 3, 32, 32) float32 images in [0, 255] at CIFAR-10's size; the
    fake side blurred, dimmed and noisier, as a weak generator's."""
    import torch

    img = _natural(g, dev, n, 3, 32, 32)
    if fake:
        img = torch.clamp(0.6 * _blur(img, 1.0) + 0.1 + 0.05 * torch.randn(img.shape, generator=g, device=dev),
                          0.0, 1.0)
    return img * 255.0


def _fid64(real, fake) -> float:
    """FID of two feature sets in float64 on the host (numpy moments, scipy's
    LAPACK eigh): |mu_r - mu_f|^2 + tr S_r + tr S_f - 2 tr (S_r^1/2 S_f S_r^1/2)^1/2."""
    import numpy as np
    import scipy.linalg

    r, f = real.double().cpu().numpy(), fake.double().cpu().numpy()
    mu_r, mu_f = r.mean(axis=0), f.mean(axis=0)
    s_r, s_f = np.cov(r, rowvar=False), np.cov(f, rowvar=False)
    vals, vecs = scipy.linalg.eigh(s_r)
    root = (vecs * np.sqrt(np.clip(vals, 0, None))) @ vecs.T
    inner = np.clip(scipy.linalg.eigvalsh(root @ s_f @ root), 0, None)
    return float(((mu_r - mu_f) ** 2).sum() + np.trace(s_r) + np.trace(s_f) - 2 * np.sqrt(inner).sum())


def run_cifar10_fid(card: str, dev, per_side: int = 5000, batch: int = 200, check: int = 32,
                    kid_subsets: int = 100, kid_subset_size: int = 1000, is_splits: int = 10) -> dict:
    """Path ``cifar10_fid``: torch-fidelity's CIFAR-10 evaluation (32 x 32
    RGB in [0, 255], resized to 299 in the network) through one
    MetricCollection of FID (2048), KID (100 subsets of 1,000), IS
    (logits_unbiased, 10 splits) and MiFID, over ``per_side`` real and as
    many fake images in batches of ``batch`` (cut from the protocol's
    50,000), real and fake updates in turn; every metric reads one forward
    of the FID-InceptionV3 per batch (random init, make_fid_inception seed
    0), and IS sees both sides, as a collection hands it every update.
    Eager updates and zero captures; ms per update and compute ms; FID
    against float64 numpy/scipy on the same features (KID's cat states);
    and, on ``check`` images a side, the network's features and every value
    against a device="cpu" run of the same weights, and the card's compute
    against the CPU's compute on the card's own states."""
    import copy

    import torch

    from torchmetrics_tpu_torch.models import make_fid_inception
    from torchmetrics_tpu_torch.utils.data import dim_zero_cat

    label = "cifar10_fid"
    net, _, _ = make_fid_inception((2048, "logits_unbiased"), rng_seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(1010)
    real = _cifar_images(g, dev, per_side, fake=False)
    fake = _cifar_images(g, dev, per_side, fake=True)
    steps = per_side // batch
    with torch.no_grad():
        net(real[:batch])  # cuDNN's handles and the allocator
    flops_per_image = _network_flops(net, real[:1])
    _sync_dev(dev)

    run = _ModelRun(dev)
    coll = _fid_collection(dev, net, kid_subsets, kid_subset_size, is_splits)
    t0 = time.perf_counter()
    for i in range(steps):
        coll.update(real[i * batch:(i + 1) * batch], real=True)
        coll.update(fake[i * batch:(i + 1) * batch], real=False)
    _sync_dev(dev)
    loop_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    values = coll.compute()
    _sync_dev(dev)
    compute_s = time.perf_counter() - t0
    record = run.close(label, coll.values())

    # FID against float64 on the features KID keeps (the same extractor's)
    kid = coll["kid"]
    real_feats = dim_zero_cat(kid.metric_state["real_features"])
    fake_feats = dim_zero_cat(kid.metric_state["fake_features"])
    fid_state = coll["fid"].metric_state
    moment_err = max(_rel_err(fid_state["real_features_sum"], real_feats.double().sum(0)),
                     _rel_err(fid_state["fake_features_sum"], fake_feats.double().sum(0)))
    _hold(label, "FID's feature sums against KID's features", moment_err, 1e-4)
    fid64 = _fid64(real_feats, fake_feats)
    fid_f64_err = _hold(label, "FID against float64 numpy/scipy", abs(float(values["fid"]) - fid64) / abs(fid64),
                        FID_F64_RTOL)
    del real_feats, fake_feats

    # the card against a device="cpu" run of the same weights on `check` images a side
    cpu = torch.device("cpu")
    net_cpu = copy.deepcopy(net).to(cpu)
    r_chk, f_chk = real[:check], fake[:check]
    small = dict(kid_subsets=10, kid_subset_size=check // 2, is_splits=2)
    card_small = _fid_collection(dev, net, **small)
    cpu_small = _fid_collection(cpu, net_cpu, **small)
    for m, (r, f) in ((card_small, (r_chk, f_chk)), (cpu_small, (r_chk.cpu(), f_chk.cpu()))):
        m.update(r, real=True)
        m.update(f, real=False)
    # the network's two taps, as KID's and IS's cat states keep them
    feature_err = _hold(label, "network taps against the CPU", max(
        _rel_err(dim_zero_cat(card_small[name].metric_state[key]), dim_zero_cat(cpu_small[name].metric_state[key]))
        for name, key in (("kid", "real_features"), ("kid", "fake_features"), ("is", "features"))), FEATURE_RTOL)
    got, want = card_small.compute(), cpu_small.compute()
    cpu_errs = {k: _hold(label, f"{k} against the CPU run", _rel_err(got[k], want[k]),
                         FID_CPU_RTOL if k in ("fid", "mifid") else SCORE_CPU_RTOL) for k in want}
    # the compute alone: the CPU's compute on the card's states (eigh on LAPACK against cuSOLVER)
    same_state = {}
    for name in ("fid", "mifid"):
        twin = _fid_collection(cpu, net_cpu, **small)[name]
        if name == "fid":
            twin._ensure_states(card_small[name]._num_features)  # FID sizes its states at its first update
        twin.load_state({k: (v.cpu() if isinstance(v, torch.Tensor) else [dim_zero_cat(v).cpu()])
                         for k, v in card_small[name].metric_state.items()})
        twin._update_count = 1
        same_state[name] = _hold(label, f"{name} compute against the CPU's on the same states",
                                 _rel_err(got[name], twin.compute()), FID_CPU_RTOL)

    profile = None
    if dev.type == "cuda":
        prof = _fid_collection(dev, net, kid_subsets, kid_subset_size, is_splits)
        prof.update(real[:batch], real=True)  # group discovery, outside the trace
        profile = profile_steps(lambda i: prof.update((real if i % 2 else fake)[i * batch:(i + 1) * batch],
                                                      real=bool(i % 2)), range(1, 5))
        del prof
    return {"phase": "slice", "path": label, "images_per_side": per_side, "batch": batch, "size": [3, 32, 32],
            "network": "FID-InceptionV3 at 299 x 299, random init (make_fid_inception, seed 0)",
            "reduced": ["5,000 real and 5,000 fake images, cut from 50,000", "random weights: the torch-fidelity "
                        "checkpoint is not in the repository"],
            "updates": 2 * steps, "ms_per_update": loop_s / (2 * steps) * 1e3,
            "images_per_s": 2 * per_side / loop_s, "compute_ms": compute_s * 1e3,
            "network_gflop_per_image": flops_per_image / 1e9,
            "network_tflop_per_s_of_busy_time": (None if profile is None else flops_per_image * batch
                                                 / (profile["device_busy_ms_per_step"] * 1e-3) / 1e12),
            "values": {k: _summary(v) for k, v in values.items()}, "compute_groups": coll.compute_groups,
            "fid_float64": fid64, "fid_float64_rel_err": fid_f64_err, "fid_float64_tol": FID_F64_RTOL,
            "fid_moments_rel_err": moment_err,
            "cpu_check": {"images_per_side": check, "feature_rel_err": feature_err, "feature_tol": FEATURE_RTOL,
                          "value_rel_err": cpu_errs, "value_tol": {"fid_mifid": FID_CPU_RTOL, "kid_is": SCORE_CPU_RTOL},
                          "compute_on_same_states_rel_err": same_state},
            **record, "profile": profile, "card": card}


def _patches(g, dev, n: int, size: int = 64):
    """BAPPS-like pairs: (n, 3, size, size) reference patches in [-1, 1] and
    a distorted copy (blur, noise, a colour shift)."""
    import torch

    ref = _natural(g, dev, n, 3, size, size) * 2 - 1
    shift = 0.1 * (torch.rand(n, 3, 1, 1, generator=g, device=dev) - 0.5)
    dist = _blur(ref, 0.7) + 0.05 * torch.randn(ref.shape, generator=g, device=dev) + shift
    return ref, torch.clamp(dist, -1.0, 1.0)


def run_bapps_lpips(card: str, dev, pairs: int = 10_000, batch: int = 50, check: int = 32) -> dict:
    """Path ``bapps_lpips``: LPIPS (AlexNet trunk, random init, with the
    reference's trained heads from lpips_heads.npz; reduction "mean") over
    ``pairs`` pairs of 64 x 64 patches in [-1, 1], BAPPS 2AFC's patch size,
    in batches of ``batch``: eager updates, zero captures, ms per update,
    compute ms; ``check`` pairs against a device="cpu" run of the same
    weights; the VGG and SqueezeNet trunks one batch each against the CPU."""
    import copy
    import warnings

    import torch

    from torchmetrics_tpu_torch.image import LearnedPerceptualImagePatchSimilarity
    from torchmetrics_tpu_torch.models import make_lpips

    label = "bapps_lpips"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # random backbones under trained heads: expected here
        nets = {t: make_lpips(t, rng_seed=0, device=dev)[0] for t in ("alex", "vgg", "squeeze")}
    g = torch.Generator(device=dev).manual_seed(2020)
    ref, dist = _patches(g, dev, pairs)
    steps = pairs // batch
    with torch.no_grad():
        nets["alex"](ref[:batch], dist[:batch])
    _sync_dev(dev)

    run = _ModelRun(dev)
    metric = LearnedPerceptualImagePatchSimilarity(net_type=nets["alex"], reduction="mean", device=dev)
    t0 = time.perf_counter()
    for i in range(steps):
        metric.update(ref[i * batch:(i + 1) * batch], dist[i * batch:(i + 1) * batch])
    _sync_dev(dev)
    loop_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    value = metric.compute()
    _sync_dev(dev)
    compute_s = time.perf_counter() - t0
    record = run.close(label, [metric])
    if float(metric.total) != pairs:
        raise AssertionError(f"{label}: {float(metric.total)} pairs counted, {pairs} given")

    cpu = torch.device("cpu")
    errs = {}
    for net_type, net in nets.items():
        net_cpu = copy.deepcopy(net).to(cpu)
        with torch.no_grad():
            got = net(ref[:check], dist[:check])
            want = net_cpu(ref[:check].cpu(), dist[:check].cpu())
        errs[net_type] = _hold(label, f"{net_type} distances against the CPU", _rel_err(got, want), LPIPS_CPU_RTOL)
    card_m = LearnedPerceptualImagePatchSimilarity(net_type=nets["alex"], device=dev)
    cpu_m = LearnedPerceptualImagePatchSimilarity(net_type=copy.deepcopy(nets["alex"]).to(cpu), device=cpu)
    card_m.update(ref[:check], dist[:check])
    cpu_m.update(ref[:check].cpu(), dist[:check].cpu())
    value_err = _hold(label, "LPIPS against the CPU run", _rel_err(card_m.compute(), cpu_m.compute()),
                      LPIPS_CPU_RTOL)

    profile = None
    if dev.type == "cuda":
        prof = LearnedPerceptualImagePatchSimilarity(net_type=nets["alex"], device=dev)
        profile = profile_steps(lambda i: prof.update(ref[i * batch:(i + 1) * batch], dist[i * batch:(i + 1) * batch]),
                                range(20))
    return {"phase": "slice", "path": label, "pairs": pairs, "batch": batch, "size": [3, 64, 64],
            "network": "LPIPS AlexNet trunk, random init (make_lpips, seed 0), trained heads",
            "reduced": ["random backbone weights: the torchvision checkpoints are not in the repository"],
            "updates": steps, "ms_per_update": loop_s / steps * 1e3, "pairs_per_s": pairs / loop_s,
            "compute_ms": compute_s * 1e3, "value": float(value),
            "cpu_check": {"pairs": check, "distance_rel_err": errs, "value_rel_err": value_err,
                          "tol": LPIPS_CPU_RTOL},
            **record, "profile": profile, "card": card}


class SyntheticGenerator:
    """A seeded convolutional generator at StyleGAN's interface widths:
    512-wide latents to 3 x 256 x 256 images in [-1, 1] (a linear map to
    512 x 4 x 4, six doublings of nearest upsampling, 3 x 3 convolution and
    leaky ReLU, halving the channels down to 16, then a 3 x 3 convolution to
    RGB and tanh). Latents are drawn on the host from a seeded generator, on
    the unit sphere, and uploaded, so a card run and a CPU run see the same
    ones."""

    def __init__(self, device, seed: int = 0, latent: int = 512):
        import torch
        from torch import nn

        from torchmetrics_tpu_torch.models.inception import random_init_

        widths = (512, 256, 128, 64, 32, 16, 16)
        layers = [nn.Linear(latent, widths[0] * 16), nn.Unflatten(1, (widths[0], 4, 4))]
        for c_in, c_out in zip(widths[:-1], widths[1:]):
            layers += [nn.Upsample(scale_factor=2), nn.Conv2d(c_in, c_out, 3, padding=1), nn.LeakyReLU(0.2)]
        layers += [nn.Conv2d(widths[-1], 3, 3, padding=1), nn.Tanh()]
        self.body = random_init_(nn.Sequential(*layers), seed).requires_grad_(False).to(device)
        self.latent, self.device, self.seed = latent, torch.device(device), seed
        self._rng = torch.Generator().manual_seed(seed)

    def sample(self, num_samples: int):
        """Latents on the unit sphere (slerp_unit's domain)."""
        import torch

        z = torch.randn(num_samples, self.latent, generator=self._rng)
        return (z / z.norm(dim=1, keepdim=True)).to(self.device)

    def __call__(self, z):
        from torchmetrics_tpu_torch.functional.image.helper import ieee_fp32_convolutions

        with ieee_fp32_convolutions():
            return self.body(z * self.latent ** 0.5)  # unit latents back to N(0, 1)'s scale

    def on(self, device) -> "SyntheticGenerator":
        """A twin on ``device``: the same weights, its latent stream restarted."""
        import copy

        import torch

        twin = copy.copy(self)
        twin.body, twin.device = copy.deepcopy(self.body).to(device), torch.device(device)
        twin._rng = torch.Generator().manual_seed(self.seed)
        return twin


def run_ppl_vgg(card: str, dev, num_samples: int = 2000, batch: int = 100, check: int = 32) -> dict:
    """Path ``ppl_vgg``: PerceptualPathLength with the VGG16 LPIPS (random
    backbone, trained heads), epsilon 1e-4, images resized to 64, over
    ``num_samples`` latent pairs (cut from StyleGAN's 100,000) of
    :class:`SyntheticGenerator`, with lerp and with slerp_unit: compute ms
    (the whole evaluation runs in compute), ms per batch of ``batch``,
    zero captures; ``check`` pairs against a device="cpu" run of the same
    generator and network."""
    import copy
    import warnings

    import torch

    from torchmetrics_tpu_torch.image import PerceptualPathLength
    from torchmetrics_tpu_torch.models import make_lpips

    label = "ppl_vgg"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        vgg = make_lpips("vgg", rng_seed=1, device=dev)[0]
    gen = SyntheticGenerator(dev, seed=3)
    with torch.no_grad():
        vgg(torch.zeros(batch, 3, 64, 64, device=dev), torch.zeros(batch, 3, 64, 64, device=dev))
        gen(gen.sample(batch))
    _sync_dev(dev)

    run = _ModelRun(dev)
    results, metrics = {}, []
    for method in ("lerp", "slerp_unit"):
        metric = PerceptualPathLength(distance_fn=vgg, num_samples=num_samples, batch_size=batch,
                                      interpolation_method=method, epsilon=1e-4, resize=64, device=dev)
        metrics.append(metric)
        t0 = time.perf_counter()
        metric.update(gen)
        with torch.no_grad():
            mean, std, dists = metric.compute()
        _sync_dev(dev)
        compute_s = time.perf_counter() - t0
        if not (torch.isfinite(dists).all() and dists.numel() > 0.9 * num_samples):
            raise AssertionError(f"{label}: {method} kept {dists.numel()} finite distances of {num_samples}")
        results[method] = {"mean": float(mean), "std": float(std), "kept": dists.numel(),
                           "compute_ms": compute_s * 1e3, "ms_per_batch": compute_s * 1e3 / (num_samples / batch)}
    record = run.close(label, metrics)

    cpu = torch.device("cpu")
    vgg_cpu = copy.deepcopy(vgg).to(cpu)
    errs = {}
    for method in ("lerp", "slerp_unit"):
        kw = dict(num_samples=check, batch_size=check, interpolation_method=method, epsilon=1e-4, resize=64)
        card_m = PerceptualPathLength(distance_fn=vgg, **kw, device=dev)
        cpu_m = PerceptualPathLength(distance_fn=vgg_cpu, **kw, device=cpu)
        card_m.update(gen.on(dev))
        cpu_m.update(gen.on(cpu))
        with torch.no_grad():
            errs[method] = _hold(label, f"{method} against the CPU run", _rel_err(card_m.compute()[:2],
                                                                                  cpu_m.compute()[:2]), PPL_CPU_RTOL)

    profile = None
    if dev.type == "cuda":
        prof = PerceptualPathLength(distance_fn=vgg, num_samples=batch, batch_size=batch, epsilon=1e-4, resize=64,
                                    lower_discard=None, upper_discard=None, device=dev)
        prof.update(gen)

        def step(i):
            prof._computed = None
            with torch.no_grad():
                prof.compute()

        profile = profile_steps(step, range(4))
    return {"phase": "slice", "path": label, "num_samples": num_samples, "batch": batch,
            "generator": "SyntheticGenerator: 512 -> 3 x 256 x 256, seed 3", "resize": 64, "epsilon": 1e-4,
            "network": "LPIPS VGG16 trunk, random init (make_lpips, seed 1), trained heads",
            "reduced": ["2,000 samples, cut from 100,000", "a synthetic generator and random VGG weights"],
            "results": results, "cpu_check": {"samples": check, "value_rel_err": errs, "tol": PPL_CPU_RTOL},
            **record, "profile": profile, "card": card}


def model_tf32_check(card: str, dev, images: int = 32) -> dict:
    """The network pins with TF32 allowed by the caller
    (torch.backends.cudnn.allow_tf32 = True and
    torch.set_float32_matmul_precision("high")): Inception's 2048 features
    and logits within TF32_CHECK_RTOL of the pinned run under the defaults,
    and the same with the pins taken out, for comparison; KID's Gram
    product and FID's covariance product under the caller's setting within
    TF32_CHECK_RTOL of float64."""
    import torch

    from torchmetrics_tpu_torch.image import FrechetInceptionDistance
    from torchmetrics_tpu_torch.image import kid as kid_module
    from torchmetrics_tpu_torch.models import inception as inception_module
    from torchmetrics_tpu_torch.models import make_fid_inception

    net, _, _ = make_fid_inception((2048, "logits_unbiased"), rng_seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(77)
    x = _cifar_images(g, dev, images, fake=False)
    feats = torch.randn(1000, 2048, generator=g, device=dev)
    with torch.no_grad():
        pinned = net(x)
    prev_conv, prev_matmul = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        with torch.no_grad():
            caller = net(x)
            gram = kid_module.poly_kernel(feats, feats)
            fid = FrechetInceptionDistance(feature=lambda t: t, device=dev)
            fid.update(feats, real=True)
            cov_sum = fid.real_features_cov_sum
            pins = (inception_module.ieee_fp32_convolutions, inception_module.highest_fp32_matmuls)
            inception_module.ieee_fp32_convolutions = inception_module.highest_fp32_matmuls = contextlib.nullcontext
            try:
                unpinned = net(x)
            finally:
                inception_module.ieee_fp32_convolutions, inception_module.highest_fp32_matmuls = pins
    finally:
        torch.backends.cudnn.allow_tf32 = prev_conv
        torch.set_float32_matmul_precision(prev_matmul)
    f64 = feats.double()
    gram_err = _hold("model_tf32", "KID's Gram product against float64",
                     _rel_err(gram, (f64 @ f64.T / 2048 + 1.0) ** 3), TF32_CHECK_RTOL)
    cov_err = _hold("model_tf32", "FID's covariance product against float64", _rel_err(cov_sum, f64.T @ f64),
                    TF32_CHECK_RTOL)
    errs = {str(k): _hold("model_tf32", f"tap {k} with TF32 allowed by the caller", _rel_err(caller[k], pinned[k]),
                          TF32_CHECK_RTOL) for k in (2048, "logits_unbiased")}
    unpinned_errs = {str(k): _rel_err(unpinned[k], pinned[k]) for k in (2048, "logits_unbiased")}
    return {"phase": "model_tf32", "allow_tf32_by_caller": True, "matmul_precision_by_caller": "high",
            "images": images, "tol": TF32_CHECK_RTOL, "tap_rel_err": errs, "kid_gram_rel_err_f64": gram_err,
            "fid_cov_rel_err_f64": cov_err,
            "tap_rel_err_without_the_pins": unpinned_errs, "card": card}


def run_model_paths(card: str, dev) -> list:
    """The three model paths and the TF32 check, one record each."""
    return [run_cifar10_fid(card, dev), run_bapps_lpips(card, dev), run_ppl_vgg(card, dev),
            model_tf32_check(card, dev)]


# ---------------------------------------------------------------------------
# phase sketches: the t-digest, reservoir and count-min metrics, TenantStack
# ---------------------------------------------------------------------------

LATENCY_QS = (0.5, 0.9, 0.99, 0.999)
# (S, M, C, input) of the compress kernel on the sketch paths: one latency
# update (a 128-slot digest and 65,536 new values), tenant_fleet (b)'s 256
# tenants of 4,096 values, a decayed latency update (the digest's weights
# scaled by powers of 2^(-1/32)) and a windowed metric's merge of 8 slots
TDIGEST_CASES = ((1, 65_664, 128, "update"), (256, 4_224, 128, "update"), (1, 65_664, 128, "decayed"),
                 (1, 1_024, 128, "window_merge"))
# the kernel's means (and a decayed digest's weights) against the plain
# version run on the card, whose cumsum and index_add_ add in another order
TDIGEST_CARD_PLAIN_RTOL = 1e-5
# reservoir keys log(u)/w: torch's CPU log and CUDA's logf differ by an ulp
# on some inputs, which moves neither the order nor the kept rows
RESERVOIR_KEY_ULPS = 2


def _latencies(g, dev, shape):
    """Log-normal request latencies in ms (median about 49 ms)."""
    import torch

    return torch.exp(3.9 + 0.6 * torch.randn(shape, generator=g, device=dev))


def _tdigest_kernel_input(g, dev, s: int, m: int, compression: int, kind: str = "update"):
    """S sorted centroid lists. ``update``: as an update gives them, a
    digest's C slots after earlier data (integer weights) and M - C new
    unit-weight values; ``decayed``: the same with each slot's weight
    scaled by 2^(-r/32), r in [0, 256); ``window_merge``: the C slots of
    each of M / C digests (one per window slot) merged into one list."""
    import torch

    from torchmetrics_tpu_torch.ops.tdigest import tdigest_compress_sorted_plain
    from torchmetrics_tpu_torch.sketches.tdigest import _sort_centroids

    def points(rows, n):
        vals = _latencies(g, dev, (rows, n))
        return torch.stack([vals, torch.ones_like(vals)], dim=-1)

    sort = torch.func.vmap(_sort_centroids)
    if kind == "window_merge":
        slots = m // compression
        empty = torch.tensor([float("inf"), 0.0], device=dev).expand(slots, compression, 2)
        bodies = tdigest_compress_sorted_plain(sort(torch.cat([empty, points(slots, 4_096)], dim=1)), compression)
        return sort(bodies.reshape(s, m, 2))
    empty = torch.tensor([float("inf"), 0.0], device=dev).expand(s, compression, 2)
    body = tdigest_compress_sorted_plain(sort(torch.cat([empty, points(s, m - compression)], dim=1)), compression)
    if kind == "decayed":
        r = torch.randint(0, 256, (s, compression), generator=g, device=dev)
        body = torch.stack([body[..., 0], body[..., 1] * torch.exp2(-r.float() / 32)], dim=-1)
    return sort(torch.cat([body, points(s, m - compression)], dim=1))


def check_tdigest_kernel(dev) -> dict:
    """The compress kernel at the sketch paths' shapes: one launch each;
    weights and means bitwise equal to the plain version run on the host on
    a copy of the same inputs; weights bitwise (integer weights; a decayed
    digest's within TDIGEST_CARD_PLAIN_RTOL) and means within
    TDIGEST_CARD_PLAIN_RTOL of the plain version run on the card. Timed
    beside the plain version on the card and the bound."""
    import torch

    from torchmetrics_tpu_torch.ops import tdigest

    g = torch.Generator(device=dev).manual_seed(7)
    cases, worst = [], 0.0
    for s, m, c, kind in TDIGEST_CASES:
        name = f"tdigest_s{s}_m{m}_c{c}" + ("" if kind == "update" else f"_{kind}")
        cent = _tdigest_kernel_input(g, dev, s, m, c, kind)
        before = tdigest.tdigest_compress_sorted.launches
        got = tdigest.tdigest_compress_sorted(cent, c)
        launched = tdigest.tdigest_compress_sorted.launches - before
        card_plain = tdigest.tdigest_compress_sorted_plain(cent, c)
        host_plain = tdigest.tdigest_compress_sorted_plain(cent.cpu(), c)
        torch.cuda.synchronize()
        if launched != 1:
            raise AssertionError(f"kernel {name}: {launched} launches, expected 1")
        if not torch.equal(got.cpu(), host_plain):
            raise AssertionError(f"kernel {name}: not bitwise equal to the plain version run on the host")
        weight_rel = float(((got[..., 1] - card_plain[..., 1]).abs().double()
                            / card_plain[..., 1].abs().double().clamp(min=1e-38)).max())
        if kind == "decayed":
            if not weight_rel <= TDIGEST_CARD_PLAIN_RTOL:
                raise AssertionError(f"kernel {name}: centroid weights {weight_rel} off the plain version on the "
                                     f"card (relative; tolerance {TDIGEST_CARD_PLAIN_RTOL})")
        elif not torch.equal(got[..., 1], card_plain[..., 1]) or not torch.equal(got[..., 1], got[..., 1].round()):
            raise AssertionError(f"kernel {name}: centroid weights differ from the plain version on the card")
        finite = torch.isfinite(card_plain[..., 0])
        if not torch.equal(finite, torch.isfinite(got[..., 0])):
            raise AssertionError(f"kernel {name}: empty slots differ from the plain version on the card")
        diff = (got[..., 0] - card_plain[..., 0]).abs()[finite].double()
        rel = float((diff / card_plain[..., 0].abs()[finite].double()).max())
        if not rel <= TDIGEST_CARD_PLAIN_RTOL:
            raise AssertionError(f"kernel {name}: means {rel} off the plain version on the card (relative; "
                                 f"tolerance {TDIGEST_CARD_PLAIN_RTOL})")
        err = float(diff.max())
        worst = max(worst, err)
        ms, host_ms, covered = time_ms(lambda: tdigest.tdigest_compress_sorted(cent, c))
        plain_ms = statistics.median(_timed(lambda: tdigest.tdigest_compress_sorted_plain(cent, c))[1]
                                     for _ in range(3))
        cases.append({
            "case": name, "s": s, "m": m, "compression": c, "input": kind, "launches": launched,
            "cluster": tdigest.cluster_size(s, m, torch.cuda.get_device_properties(dev).multi_processor_count),
            "bitwise_host_plain": True, "weights_bitwise_card_plain": weight_rel == 0.0,
            "weight_rel_err_card_plain": weight_rel, "mean_rel_err_card_plain": rel,
            "max_abs_err": err, "slots_used": int((got[0, :, 1] > 0).sum()), "ms": ms, "host_ms": host_ms,
            "ms_covered": covered, "plain_ms": plain_ms,
            "bound_ms": tdigest.bound_bytes(s, m, c) / hbm_bytes_per_s() * 1e3, "bound_by": "bytes",
        })
    return {"cases": cases, "max_abs_err": worst}


def _kernel_counts():
    from torchmetrics_tpu_torch.ops.bincount import weighted_bincount
    from torchmetrics_tpu_torch.ops.tdigest import tdigest_compress_sorted

    return {"weighted_bincount": weighted_bincount.launches, "tdigest_compress": tdigest_compress_sorted.launches}


def _zero_kernel_counts() -> None:
    from torchmetrics_tpu_torch.ops.bincount import weighted_bincount
    from torchmetrics_tpu_torch.ops.tdigest import tdigest_compress_sorted

    weighted_bincount.launches = 0
    tdigest_compress_sorted.launches = 0


def _rank_of(sorted_values, estimates) -> list:
    """The fraction of ``sorted_values`` at or below each estimate."""
    import torch

    at = torch.searchsorted(sorted_values, estimates.to(sorted_values.dtype), right=True)
    return (at.double() / sorted_values.numel()).tolist()


def _envelope(q: float, compression: int) -> float:
    """ApproxQuantile's documented rank-error envelope at ``q``."""
    delta = 2.0 * (compression - 2)
    return max(8.0 * q * (1.0 - q) / delta, 4.0 / delta)


def _hold_ranks(label: str, what: str, ranks: list, compression: int) -> float:
    worst = 0.0
    for q, rank in zip(LATENCY_QS, ranks):
        err = abs(rank - q)
        if not err <= _envelope(q, compression):
            raise AssertionError(f"{label}: {what} estimate at q={q} has rank {rank} (envelope "
                                 f"{_envelope(q, compression)})")
        worst = max(worst, err / _envelope(q, compression))
    return worst


def run_latency_quantiles(card: str, dev, updates: int = 200, batch: int = 65_536, compression: int = 128,
                          cpu_steps: int = 3) -> tuple:
    """Path ``latency_quantiles_tdigest``: a serving fleet's request-latency
    quantiles, ApproxQuantile(q=(0.5, 0.9, 0.99, 0.999), compression=128)
    over 200 updates of 65,536 log-normal latencies (13.1 M values), updated
    eagerly (jit=False) and captured (one replay per update), digests
    bitwise equal; each estimate's rank in the data within the documented
    envelope, and the exact twin's torch.quantile beside it; windowed
    (horizon 64 in 8 slots: the last 64 updates) and decayed (halflife 32:
    update i weighs d^(199 - i)) views held the same way against the data
    they cover; the first ``cpu_steps`` updates' digest bitwise equal to a
    device="cpu" run. Returns (record, kernel launches)."""
    import torch

    from torchmetrics_tpu_torch import ApproxQuantile
    from torchmetrics_tpu_torch._capture import graph_stats

    label = "latency_quantiles_tdigest"
    g = torch.Generator(device=dev).manual_seed(2024)
    data = _latencies(g, dev, (updates, batch))

    def mk(device=dev, **kw):
        return ApproxQuantile(q=LATENCY_QS, compression=compression, device=device, **kw)

    def drive(m, steps, source=data) -> float:
        _sync(dev)
        t0 = time.perf_counter()
        for i in steps:
            m.update(source[i])
        _sync(dev)
        return (time.perf_counter() - t0) * 1e3

    warm = mk()
    drive(warm, range(2))
    del warm
    launches = dict.fromkeys(("weighted_bincount", "tdigest_compress"), 0)
    routes, metrics = {}, {}
    for route, kw in (("eager", {"jit": False}), ("captured", {})):
        m = mk(**kw)
        graphs = graph_stats()
        _zero_kernel_counts()
        ms = drive(m, range(updates))
        counts = _kernel_counts()
        for k in launches:
            launches[k] += counts[k]
        after = graph_stats()
        routes[route] = {"ms_per_update": ms / updates, "compress_launches": counts["tdigest_compress"],
                         "bincount_launches": counts["weighted_bincount"],
                         "captures": after["captures"] - graphs["captures"],
                         "replays_per_update": (after["replays"] - graphs["replays"]) / updates}
        metrics[route] = m
    if not torch.equal(metrics["eager"].digest, metrics["captured"].digest):
        raise AssertionError(f"{label}: the captured digest differs from the eager one")
    on_card = dev.type == "cuda"
    if routes["eager"]["compress_launches"] != (updates if on_card else 0) or \
            routes["captured"]["replays_per_update"] != (1.0 if on_card else 0.0):
        raise AssertionError(f"{label}: launches or replays {routes}")

    exact = mk(exact=True)
    drive(exact, range(updates))
    everything = torch.sort(data.reshape(-1)).values
    estimates = metrics["captured"].compute()
    exact_values = exact.compute()
    worst = {"stream": _hold_ranks(label, "stream", _rank_of(everything, estimates), compression)}
    rel_to_exact = ((estimates - exact_values).abs() / exact_values).tolist()

    _zero_kernel_counts()
    windowed = mk().windowed(horizon=64, slots=8)
    window_ms = drive(windowed, range(updates))
    decayed = mk().decayed(halflife=32.0)
    decayed_ms = drive(decayed, range(updates))
    counts = _kernel_counts()
    for k in launches:
        launches[k] += counts[k]
    covered = torch.sort(data[max(updates - 64, 0):].reshape(-1)).values
    worst["windowed"] = _hold_ranks(label, "windowed", _rank_of(covered, windowed.compute()), compression)
    d = decayed.decay_factor
    weights = torch.tensor(d, dtype=torch.float64, device=dev) ** torch.arange(updates - 1, -1, -1, device=dev)
    order = torch.argsort(data.reshape(-1))
    cum_w = torch.cumsum(weights.repeat_interleave(batch)[order], dim=0)
    at = torch.searchsorted(data.reshape(-1)[order], decayed.compute(), right=True)
    below = torch.where(at > 0, cum_w[(at - 1).clamp_min(0)], 0.0)
    decayed_ranks = (below / cum_w[-1]).tolist()
    worst["decayed"] = _hold_ranks(label, "decayed", decayed_ranks, compression)

    # the first cpu_steps updates on the card and on the CPU: bitwise (the
    # kernel and the plain version agree bitwise, and so do the sorts)
    card_head, cpu_head = mk(jit=False), mk(device=torch.device("cpu"))
    drive(card_head, range(cpu_steps))
    data_cpu = data[:cpu_steps].cpu()
    for i in range(cpu_steps):
        cpu_head.update(data_cpu[i])
    if not torch.equal(card_head.digest.cpu(), cpu_head.digest):
        raise AssertionError(f"{label}: the digest after {cpu_steps} updates differs from the CPU run")

    profile = None
    if dev.type == "cuda":
        prof = mk()
        drive(prof, range(2))
        profile = profile_steps(lambda i: prof.update(data[i]), range(2, 12), "update")
    record = {"phase": "sketches", "path": label, "updates": updates, "batch": batch, "compression": compression,
              "q": list(LATENCY_QS), "routes": routes, "estimates": estimates.tolist(),
              "exact": exact_values.tolist(), "rel_to_exact": rel_to_exact,
              "rank_err_over_envelope": worst, "windowed_ms_per_update": window_ms / updates,
              "decayed_ms_per_update": decayed_ms / updates, "cpu_steps_bitwise": cpu_steps,
              "profile": profile, "card": card}
    return record, launches


def _ctr_inputs(g, dev, updates: int, batch: int):
    """(scores, clicks): a click-through model's predicted click
    probabilities and the clicks, about 3% positive."""
    import torch

    logit = -4.2 + 1.2 * torch.randn(updates, batch, generator=g, device=dev)
    clicks = (torch.rand(updates, batch, generator=g, device=dev) < torch.sigmoid(logit)).to(torch.float32)
    scores = torch.sigmoid(logit + 0.3 * torch.randn(updates, batch, generator=g, device=dev))
    return scores, clicks


def _reservoir_rows_agree(label: str, got, want) -> int:
    """Header and payload rows bitwise, in the same order; keys within
    RESERVOIR_KEY_ULPS. Returns the number of rows whose key differs."""
    import torch

    got, want = got.cpu(), want.cpu()
    if not torch.equal(got[0], want[0]) or not torch.equal(got[1:, 1:], want[1:, 1:]):
        raise AssertionError(f"{label}: reservoir header or payload rows differ from the CPU run")
    keys_g, keys_w = got[1:, 0], want[1:, 0]
    same = keys_g == keys_w
    ulps = (keys_g.view(torch.int32).long() - keys_w.view(torch.int32).long()).abs()
    if not bool((same | (ulps <= RESERVOIR_KEY_ULPS)).all()):
        raise AssertionError(f"{label}: reservoir keys differ from the CPU run by more than {RESERVOIR_KEY_ULPS} ulp")
    return int((~same).sum())


def run_ctr_reservoir(card: str, dev, updates: int = 100, batch: int = 65_536, capacity: int = 65_536,
                      n_bins: int = 15, cpu_steps: int = 25) -> tuple:
    """Path ``ctr_reservoir_auroc_ece``: a click-through model's streaming
    AUROC and calibration, ApproxAUROC and ApproxCalibrationError (capacity
    65,536, 15 bins) in one MetricCollection, fused (one replay per update),
    over 100 updates of 65,536 (score, click) pairs at about 3% positive;
    states bitwise equal to the eager loop's; values within 3/sqrt(capacity)
    of the exact twins over the 6.55 M rows; the first ``cpu_steps``
    updates' reservoirs against a device="cpu" run (payload bitwise, keys
    within RESERVOIR_KEY_ULPS; rows with a differing key reported). The
    ECE's compute is one bincount launch. Returns (record, kernel launches)."""
    import torch

    from torchmetrics_tpu_torch import ApproxAUROC, ApproxCalibrationError, MetricCollection
    from torchmetrics_tpu_torch._capture import graph_stats

    label = "ctr_reservoir_auroc_ece"
    g = torch.Generator(device=dev).manual_seed(77)
    scores, clicks = _ctr_inputs(g, dev, updates, batch)

    def mk(device=dev, **kw):
        return MetricCollection({"auroc": ApproxAUROC(capacity=capacity, device=device, **kw),
                                 "ece": ApproxCalibrationError(capacity=capacity, n_bins=n_bins, device=device,
                                                               **kw)})

    def drive(coll, steps, s=scores, c=clicks) -> float:
        _sync(dev)
        t0 = time.perf_counter()
        for i in steps:
            coll.update(s[i], c[i])
        _sync(dev)
        return (time.perf_counter() - t0) * 1e3

    launches = dict.fromkeys(("weighted_bincount", "tdigest_compress"), 0)
    routes, colls = {}, {}
    for route, kw in (("eager", {"jit": False}), ("fused", {})):
        coll = mk(**kw)
        graphs = graph_stats()
        _zero_kernel_counts()
        ms = drive(coll, range(updates))
        update_counts = _kernel_counts()
        values = coll.compute()
        _sync(dev)
        counts = _kernel_counts()
        for k in launches:
            launches[k] += counts[k]
        after = graph_stats()
        routes[route] = {"ms_per_update": ms / updates, "bincount_launches_per_update":
                         update_counts["weighted_bincount"] / updates,
                         "bincount_launches_at_compute": counts["weighted_bincount"] - update_counts["weighted_bincount"],
                         "captures": after["captures"] - graphs["captures"],
                         "replays_per_update": (after["replays"] - graphs["replays"]) / updates,
                         "values": {k: float(v) for k, v in values.items()}}
        colls[route] = coll
    for name in ("auroc", "ece"):
        if not torch.equal(colls["eager"][name].sample, colls["fused"][name].sample):
            raise AssertionError(f"{label}: the fused {name} reservoir differs from the eager one")
    if routes["fused"]["bincount_launches_at_compute"] != (1 if dev.type == "cuda" else 0) or \
            routes["fused"]["bincount_launches_per_update"]:
        raise AssertionError(f"{label}: launches {routes['fused']}")

    exact = mk(exact=True)
    drive(exact, range(updates))
    exact_values = {k: float(v) for k, v in exact.compute().items()}
    bound = 3.0 / capacity ** 0.5
    gaps = {k: abs(routes["fused"]["values"][k] - exact_values[k]) for k in exact_values}
    for k, gap in gaps.items():
        if not gap <= bound:
            raise AssertionError(f"{label}: {k} {routes['fused']['values'][k]} is {gap} from the exact twin's "
                                 f"{exact_values[k]} (bound {bound})")

    card_head, cpu_head = mk(jit=False), mk(device=torch.device("cpu"))
    drive(card_head, range(cpu_steps))
    s_cpu, c_cpu = scores[:cpu_steps].cpu(), clicks[:cpu_steps].cpu()
    for i in range(cpu_steps):
        cpu_head.update(s_cpu[i], c_cpu[i])
    key_rows = {name: _reservoir_rows_agree(label, card_head[name].sample, cpu_head[name].sample)
                for name in ("auroc", "ece")}
    record = {"phase": "sketches", "path": label, "updates": updates, "batch": batch, "capacity": capacity,
              "n_bins": n_bins, "positive_rate": float(clicks.mean()), "routes": routes, "exact": exact_values,
              "gap_to_exact": gaps, "bound": bound, "cpu_steps": cpu_steps,
              "rows_with_key_ulp_differences_vs_cpu": key_rows, "card": card}
    return record, launches


def _zipf_ids(g, dev, shape, items: int, s: float):
    """Item ids drawn from Zipf(s) over ``items`` ranks, mapped to ids by a
    seeded permutation; returns (ids int32, the id of each rank)."""
    import torch

    pmf = torch.arange(1, items + 1, device=dev, dtype=torch.float64) ** -s
    cdf = torch.cumsum(pmf, dim=0)
    cdf = cdf / cdf[-1]
    ranks = torch.searchsorted(cdf, torch.rand(shape, generator=g, device=dev, dtype=torch.float64))
    id_of_rank = torch.randperm(items, generator=g, device=dev).to(torch.int32)
    return id_of_rank[ranks.clamp_max(items - 1)], id_of_rank


def run_item_popularity(card: str, dev, updates: int = 100, batch: int = 65_536, items: int = 1_000_000,
                        track: int = 1000, depth: int = 4, width: int = 65_536, zipf_s: float = 1.1) -> tuple:
    """Path ``item_popularity_countmin``: a recommender's item-popularity
    counts, ApproxFrequency(track=<the 1,000 hottest ids>, depth=4,
    width=65,536) over 100 updates of 65,536 ids from Zipf(1.1) over
    1,000,000 items; one bincount launch per update; the table bitwise equal
    eager, captured and on the CPU; every estimate at or above the exact
    count, and the excess within e·N/width for all but a fraction e^-4 of
    the tracked ids. Returns (record, kernel launches)."""
    import math

    import torch

    from torchmetrics_tpu_torch import ApproxFrequency
    from torchmetrics_tpu_torch._capture import graph_stats

    label = "item_popularity_countmin"
    g = torch.Generator(device=dev).manual_seed(99)
    ids, id_of_rank = _zipf_ids(g, dev, (updates, batch), items, zipf_s)
    tracked = id_of_rank[:track].tolist()

    def mk(device=dev, **kw):
        return ApproxFrequency(track=tracked, depth=depth, width=width, device=device, **kw)

    launches = dict.fromkeys(("weighted_bincount", "tdigest_compress"), 0)
    routes, metrics = {}, {}
    for route, kw in (("eager", {"jit": False}), ("captured", {})):
        m = mk(**kw)
        graphs = graph_stats()
        _zero_kernel_counts()
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(updates):
            m.update(ids[i])
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        counts = _kernel_counts()
        for k in launches:
            launches[k] += counts[k]
        after = graph_stats()
        routes[route] = {"ms_per_update": ms / updates, "bincount_launches": counts["weighted_bincount"],
                         "captures": after["captures"] - graphs["captures"],
                         "replays_per_update": (after["replays"] - graphs["replays"]) / updates}
        metrics[route] = m
    per_update = 1 if dev.type == "cuda" else 0
    warmups = routes["captured"]["captures"]  # a capture's warm-up runs the update once more
    if routes["eager"]["bincount_launches"] != per_update * updates or \
            routes["captured"]["bincount_launches"] != per_update * (updates + warmups):
        raise AssertionError(f"{label}: bincount launches {routes}, expected one per update")
    cpu = mk(device=torch.device("cpu"))
    ids_cpu = ids.cpu()
    for i in range(updates):
        cpu.update(ids_cpu[i])
    for route, m in metrics.items():
        if m.table.dtype != torch.int32 or not torch.equal(m.table.cpu(), cpu.table):
            raise AssertionError(f"{label}: the {route} table differs from the CPU run")
    est = metrics["captured"].compute().long()
    true = torch.bincount(ids.reshape(-1).long(), minlength=items)[id_of_rank[:track].long()]
    n = ids.numel()
    excess = est - true
    if bool((excess < 0).any()):
        raise AssertionError(f"{label}: an estimate is below the exact count")
    eps_n = math.e * n / width
    over = int((excess > eps_n).sum())
    if over > math.exp(-depth) * track:
        raise AssertionError(f"{label}: {over} of {track} estimates exceed e·N/width = {eps_n}")
    record = {"phase": "sketches", "path": label, "updates": updates, "batch": batch, "items": items,
              "zipf_s": zipf_s, "tracked": track, "depth": depth, "width": width, "routes": routes,
              "table_bitwise_cpu": True, "max_excess": int(excess.max()), "mean_excess": float(excess.double().mean()),
              "eps_n": eps_n, "over_eps_n": over, "hottest_true_count": int(true[0]), "card": card}
    return record, launches


def _timed_updates(fn, steps) -> float:
    """Host ms of ``fn(i)`` over ``steps``, between two synchronisations."""
    import torch

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    total = 0.0
    for i in steps:
        sync()
        t0 = time.perf_counter()
        fn(i)
        sync()
        total += time.perf_counter() - t0
    return total * 1e3


def run_tenant_fleet(card: str, dev, tenants: int = 1000, rows: int = 64, num_classes: int = 1000,
                     updates: int = 20, sampled: int = 16, q_tenants: int = 256, q_rows: int = 4096,
                     compression: int = 128, churn: int = 10) -> tuple:
    """Path ``tenant_fleet``: per-cohort evaluation of one model.

    (a) TenantStack(MulticlassAccuracy(num_classes=1000, average="macro"),
    tenants=1000), 1,024 slots, 20 updates of 64 rows of float32 logits per
    tenant; 16 sampled tenants' single metrics updated with their rows:
    int32 states bitwise, values equal. Then 10 tenants removed and 10
    added within the capacity, with no new capture at the next update, and
    25 more added: the 25th doubles the slots to 2,048 and the next update
    captures once; a tenant added into a freed slot starts from the defaults.
    (b) TenantStack(ApproxQuantile(q=(0.5, 0.99), compression=128),
    tenants=256), 20 updates of 4,096 latencies per tenant: one compress
    launch per update for every tenant; 16 sampled singles' digests bitwise
    (each CTA computes one digest alone), two of them also on the CPU.
    Replays and launches per update, and ms per update stacked against a
    loop over the 16 singles. Returns (record, kernel launches)."""
    import torch

    from torchmetrics_tpu_torch import ApproxQuantile, TenantStack
    from torchmetrics_tpu_torch._capture import graph_stats
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy

    label = "tenant_fleet"
    g = torch.Generator(device=dev).manual_seed(555)
    launches = dict.fromkeys(("weighted_bincount", "tdigest_compress"), 0)

    def accuracy(device=dev):
        return MulticlassAccuracy(num_classes=num_classes, average="macro", device=device)

    def classify_inputs(slots):
        return (torch.randn(slots, rows, num_classes, generator=g, device=dev),
                torch.randint(0, num_classes, (slots, rows), generator=g, device=dev))

    # (a) the classifier fleet
    stack = TenantStack(accuracy(), tenants=range(tenants))
    picks = torch.randperm(tenants, generator=torch.Generator().manual_seed(1))[:sampled].tolist()
    singles = {t: accuracy() for t in picks}
    stack_ms = loop_ms = 0.0
    stack_graphs = {"captures": 0, "replays": 0}
    _zero_kernel_counts()
    single_counts = dict.fromkeys(launches, 0)
    for _ in range(updates):
        preds, target = classify_inputs(stack.slots)
        graphs = graph_stats()
        stack_ms += _timed_updates(lambda i: stack.update(preds, target), [0])
        after = graph_stats()
        for k in stack_graphs:
            stack_graphs[k] += after[k] - graphs[k]
        before = _kernel_counts()
        loop_ms += _timed_updates(lambda i: [singles[t].update(preds[t], target[t]) for t in picks], [0])
        after = _kernel_counts()
        for k in single_counts:
            single_counts[k] += after[k] - before[k]
    counts = _kernel_counts()
    stacked_counts = {k: counts[k] - single_counts[k] for k in counts}
    for k in launches:
        launches[k] += counts[k]
    _zero_kernel_counts()
    out = stack.compute()
    state = stack.metric_state
    for t in picks:
        for name, value in singles[t].metric_state.items():
            if not torch.equal(state[name][t], value):
                raise AssertionError(f"{label}: tenant {t}'s {name} differs from its single metric")
        _check_value(label, f"tenant {t}'s accuracy", out[t], singles[t].compute())
    fleet_a = {"tenants": tenants, "slots": stack.slots, "rows": rows, "num_classes": num_classes, "updates": updates,
               "stack_ms_per_update": stack_ms / updates, "loop_of_sampled_singles_ms_per_update": loop_ms / updates,
               "stack_bincount_launches_per_update": stacked_counts["weighted_bincount"] / updates,
               "stack_replays_per_update": stack_graphs["replays"] / updates, "stack_captures": stack_graphs["captures"]}
    if dev.type == "cuda" and (stack_graphs != {"captures": 1, "replays": updates}
                               or stacked_counts["weighted_bincount"] != updates + 1):  # + the capture's warm-up
        raise AssertionError(f"{label}: {stacked_counts['weighted_bincount']} stacked bincount launches over "
                             f"{updates} updates, expected one per update (and the warm-up)")

    # churn within the capacity: no new capture
    captures = graph_stats()["captures"]
    removed = list(range(churn))
    for t in removed:
        stack.remove_tenant(t)
    added = [tenants + i for i in range(churn)]
    freed = [stack.add_tenant(t) for t in added]
    preds, target = classify_inputs(stack.slots)
    stack.update(preds, target)
    churn_captures = graph_stats()["captures"] - captures
    if dev.type == "cuda" and churn_captures:
        raise AssertionError(f"{label}: churn within the capacity captured {churn_captures} new graphs")
    fresh = accuracy()
    fresh.update(preds[freed[0]], target[freed[0]])
    for name, value in fresh.metric_state.items():
        if not torch.equal(stack.metric_state[name][freed[0]], value):
            raise AssertionError(f"{label}: a tenant added into a freed slot did not start from the defaults")
    # past the capacity: one growth, one new capture
    captures = graph_stats()["captures"]
    capacity = stack.slots
    for i in range(capacity - len(stack) + 1):
        stack.add_tenant(tenants + churn + i)
    preds, target = classify_inputs(stack.slots)
    stack.update(preds, target)
    for k, v in _kernel_counts().items():
        launches[k] += v
    grow_captures = graph_stats()["captures"] - captures
    if stack.slots != 2 * capacity or (dev.type == "cuda" and grow_captures != 1):
        raise AssertionError(f"{label}: growth gave {stack.slots} slots and {grow_captures} captures")
    fleet_a.update({"churn_removed": churn, "churn_added": churn, "captures_after_churn": churn_captures,
                    "slots_after_growth": stack.slots, "captures_after_growth": grow_captures,
                    "values_sample": [float(out[t]) for t in picks[:4]]})
    del stack, singles, preds, target, fresh

    # (b) the latency fleet
    def quantile(device=dev):
        return ApproxQuantile(q=(0.5, 0.99), compression=compression, device=device)

    qstack = TenantStack(quantile(), tenants=range(q_tenants))
    qpicks = torch.randperm(q_tenants, generator=torch.Generator().manual_seed(2))[:sampled].tolist()
    qsingles = {t: quantile() for t in qpicks}
    cpu_singles = {t: quantile(torch.device("cpu")) for t in qpicks[:2]}
    stack_ms = loop_ms = 0.0
    stack_graphs = {"captures": 0, "replays": 0}
    _zero_kernel_counts()
    single_counts = dict.fromkeys(launches, 0)
    for _ in range(updates):
        lat = _latencies(g, dev, (q_tenants, q_rows))
        graphs = graph_stats()
        stack_ms += _timed_updates(lambda i: qstack.update(lat), [0])
        after = graph_stats()
        for k in stack_graphs:
            stack_graphs[k] += after[k] - graphs[k]
        before = _kernel_counts()
        loop_ms += _timed_updates(lambda i: [qsingles[t].update(lat[t]) for t in qpicks], [0])
        after = _kernel_counts()
        for k in single_counts:
            single_counts[k] += after[k] - before[k]
        for t, m in cpu_singles.items():
            m.update(lat[t].cpu())
    counts = _kernel_counts()
    stacked_counts = {k: counts[k] - single_counts[k] for k in counts}
    for k in launches:
        launches[k] += counts[k]
    if dev.type == "cuda" and (stack_graphs != {"captures": 1, "replays": updates}
                               or stacked_counts["tdigest_compress"] != updates + 1):  # + the capture's warm-up
        raise AssertionError(f"{label}: {stacked_counts['tdigest_compress']} stacked compress launches over "
                             f"{updates} updates, expected one per update (and the warm-up)")
    qout = qstack.compute()
    for t in qpicks:
        if not torch.equal(qstack.digest[t], qsingles[t].digest):
            raise AssertionError(f"{label}: tenant {t}'s digest differs from its single metric")
        _check_value(label, f"tenant {t}'s quantiles", qout[t], qsingles[t].compute())
    for t, m in cpu_singles.items():
        if not torch.equal(qstack.digest[t].cpu(), m.digest):
            raise AssertionError(f"{label}: tenant {t}'s digest differs from the CPU run")
    fleet_b = {"tenants": q_tenants, "rows": q_rows, "compression": compression, "updates": updates,
               "stack_ms_per_update": stack_ms / updates, "loop_of_sampled_singles_ms_per_update": loop_ms / updates,
               "stack_compress_launches_per_update": stacked_counts["tdigest_compress"] / updates,
               "stack_replays_per_update": stack_graphs["replays"] / updates, "stack_captures": stack_graphs["captures"],
               "cpu_tenants_bitwise": len(cpu_singles),
               "values_sample": [qout[t].tolist() for t in qpicks[:4]]}
    record = {"phase": "sketches", "path": label, "sampled": sampled, "classifier_fleet": fleet_a,
              "latency_fleet": fleet_b, "card": card}
    return record, launches


def run_sketch_paths(card: str, dev) -> tuple:
    """The four A12 paths; (records, launches of each kernel over them)."""
    records, launches = [], {"weighted_bincount": 0, "tdigest_compress": 0}
    for run in (run_latency_quantiles, run_ctr_reservoir, run_item_popularity, run_tenant_fleet):
        t0 = time.perf_counter()
        record, counts = run(card, dev)
        record["seconds"] = time.perf_counter() - t0
        records.append(record)
        for k, v in counts.items():
            launches[k] += v
    return records, launches


# ---------------------------------------------------------------------------
# A11.a: clustering, nominal association, pairwise distances, segmentation
# ---------------------------------------------------------------------------

LABEL_SCORES = ("MutualInfoScore", "NormalizedMutualInfoScore", "AdjustedMutualInfoScore", "RandScore",
                "AdjustedRandScore", "FowlkesMallowsIndex", "HomogeneityScore", "CompletenessScore", "VMeasureScore")
EMBEDDING_SCORES = ("CalinskiHarabaszScore", "DaviesBouldinScore", "DunnIndex")
NOMINAL_TABLES = ("CramersV", "TschuprowsT", "PearsonsContingencyCoefficient", "TheilsU")
# float32 scores against float64 references, relative to max(1, |reference|)
A11A_RTOL = 1e-5
# the nominal statistics sum float32 chi-squared terms over up to 10^6 cells
NOMINAL_RTOL = 1e-4
# the EMI in float64 on the card (torch.lgamma) against scipy's gammaln
EMI_RTOL = 1e-8
# UCI Adult's categorical columns: workclass, education, marital-status,
# occupation, relationship, race, sex, native-country, income; and the share
# of rows whose value is missing (NaN) in each
ADULT_CATEGORIES = (8, 16, 7, 14, 6, 5, 2, 41, 2)
ADULT_MISSING = {0: 0.057, 3: 0.058, 7: 0.018}


def _timed_peak(dev, fn):
    """(fn(), host ms between two synchronisations, peak device MB above the
    memory allocated before the call; None on the CPU)."""
    import torch

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20 if cuda else None
    return out, ms, peak


def _hold_f64(label: str, what: str, got, want: float, rtol: float = A11A_RTOL) -> float:
    """A float32 result against its float64 reference, relative to max(1, |want|)."""
    got = float(got)
    err = abs(got - want) / max(1.0, abs(want))
    if not err <= rtol:
        raise AssertionError(f"{label}: {what} = {got}, float64 reference {want} (relative {err}, tolerance {rtol})")
    return err


def _drive_collection(coll, steps, args_of, dev) -> dict:
    """Update ``coll`` over ``steps``: ms per update (median of the updates
    after the first two, and the first two), the bincount launches over all
    updates and over the steady ones (from the third), graph captures and
    replays per update."""
    from torchmetrics_tpu_torch._capture import graph_stats

    graphs = graph_stats()
    _zero_kernel_counts()
    times, steady_from = [], 0
    for i in range(steps):
        if i == 2:
            steady_from = _kernel_counts()["weighted_bincount"]
        _sync(dev)
        t0 = time.perf_counter()
        coll.update(*args_of(i))
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    launches = _kernel_counts()["weighted_bincount"]
    after = graph_stats()
    return {"ms_per_update": statistics.median(times[2:]) if steps > 2 else times[-1], "first_ms": times[:2],
            "bincount_launches": launches, "steady_launches_per_update": (launches - steady_from) / max(steps - 2, 1),
            "captures": after["captures"] - graphs["captures"],
            "replays_per_update": (after["replays"] - graphs["replays"]) / steps}


def _member_computes(coll, dev) -> tuple:
    """Each member's compute, timed alone: (values, {name: {ms, peak_mb,
    bincount_launches}})."""
    values, costs = {}, {}
    for name, m in coll.items():
        _zero_kernel_counts()
        values[name], ms, peak = _timed_peak(dev, m.compute)
        costs[name] = {"ms": ms, "peak_mb": peak, "bincount_launches": _kernel_counts()["weighted_bincount"]}
    return values, costs


def _warm_computes(coll, args) -> int:
    """One update and compute of a throwaway collection at one batch, so the
    timed computes leave out first calls (library handles, lazy imports);
    returns its bincount launches."""
    _zero_kernel_counts()
    coll.update(*args)
    coll.compute()
    return _kernel_counts()["weighted_bincount"]


def _cat_equal(a, b) -> bool:
    from torchmetrics_tpu_torch.utils.data import dim_zero_cat

    a, b = dim_zero_cat(a), dim_zero_cat(b)
    return a.dtype == b.dtype and a.shape == b.shape and bool((a.cpu() == b.cpu()).all())


def _imagenet_cluster_labels(g, dev, classes: int, per_class: int, noise: float):
    """ImageNet-1k val's 50 images of each of 1,000 classes in a seeded
    order; the predicted cluster of an image is its class under a fixed
    permutation, or, for a share ``noise`` of the images, a random cluster."""
    import torch

    n = classes * per_class
    target = torch.arange(classes, device=dev).repeat_interleave(per_class)[torch.randperm(n, generator=g, device=dev)]
    preds = torch.randperm(classes, generator=g, device=dev)[target]
    scattered = torch.rand(n, generator=g, device=dev) < noise
    preds = torch.where(scattered, torch.randint(0, classes, (n,), generator=g, device=dev), preds)
    return preds.to(torch.int32), target.to(torch.int32)


def _np_label_scores(preds, target) -> tuple:
    """float64 numpy/scipy definitions of the nine label scores (sklearn's,
    average_method="arithmetic"), the EMI by a loop over rows with each
    row's feasible nij; returns (scores, emi, feasible terms)."""
    import numpy as np
    from scipy.special import gammaln

    _, p = np.unique(preds, return_inverse=True)
    _, t = np.unique(target, return_inverse=True)
    r, c = int(p.max()) + 1, int(t.max()) + 1
    cont = np.bincount(p * c + t, minlength=r * c).reshape(r, c).astype(np.float64)
    a, b, n = cont.sum(1), cont.sum(0), cont.sum()
    nz = cont > 0
    mi = float(np.sum(cont[nz] / n * (np.log(cont[nz]) + np.log(n) - np.log(np.outer(a, b)[nz]))))

    def entropy(x):
        x = x[x > 0] / n
        return float(-np.sum(x * np.log(x)))

    h_p, h_t = entropy(a), entropy(b)
    big_n = int(n)
    logfact = gammaln(np.arange(big_n + 1, dtype=np.float64) + 1.0)  # log(k!)
    ai_all, bj = a.astype(np.int64), b.astype(np.int64)
    emi, terms = 0.0, 0
    for ai in ai_all:
        lo = np.maximum(1, ai + bj - big_n)
        hi = np.minimum(ai, bj)
        nij = np.arange(1, int(hi.max()) + 1)[None, :]
        feasible = (nij >= lo[:, None]) & (nij <= hi[:, None])
        terms += int(feasible.sum())
        k = np.where(feasible, nij, 1)
        log_p = (logfact[ai] + logfact[bj][:, None] + logfact[big_n - ai] + logfact[big_n - bj][:, None]
                 - logfact[big_n] - logfact[k] - logfact[np.maximum(ai - k, 0)]
                 - logfact[np.maximum(bj[:, None] - k, 0)] - logfact[np.maximum(big_n - ai - bj[:, None] + k, 0)])
        term = k / n * (np.log(n) + np.log(k) - np.log(float(ai) * bj[:, None]))
        emi += float(np.sum(np.where(feasible, term * np.exp(log_p), 0.0)))

    def comb2(x):
        return float(np.sum(x * (x - 1.0) / 2.0))

    cells, rows, cols, total = comb2(cont), comb2(a), comb2(b), comb2(np.array([n]))
    expected = rows * cols / total
    mean_h = 0.5 * (h_p + h_t)
    homogeneity, completeness = mi / h_t, mi / h_p
    scores = {"MutualInfoScore": mi, "NormalizedMutualInfoScore": mi / mean_h,
              "AdjustedMutualInfoScore": (mi - emi) / (mean_h - emi),
              "RandScore": (total + 2.0 * cells - rows - cols) / total,
              "AdjustedRandScore": (cells - expected) / (0.5 * (rows + cols) - expected),
              "FowlkesMallowsIndex": cells / np.sqrt(rows * cols), "HomogeneityScore": homogeneity,
              "CompletenessScore": completeness,
              "VMeasureScore": 2.0 * homogeneity * completeness / (homogeneity + completeness)}
    return scores, emi, terms


def run_imagenet_clustering_labels(card: str, dev, classes: int = 1000, per_class: int = 50, batch: int = 1000,
                                   noise: float = 0.3) -> tuple:
    """Path ``imagenet_clustering_labels``: deep-clustering evaluation of
    ImageNet-1k val as DeepCluster and SCAN report it (NMI, AMI, ARI and the
    rest): the nine label scores in one MetricCollection over 50 updates of
    1,000 (predicted cluster, class) pairs. Updates append only (no launch);
    each member's compute builds its 1,000 x 1,000 contingency matrix (one
    launch, the sparse plan) and AMI's EMI visits its feasible terms. Cat
    states bitwise equal eager, replayed and on the CPU; every score within
    A11A_RTOL of a float64 numpy/scipy reference. Returns (record, launches)."""
    import torch

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.functional.clustering.extrinsic import _contingency
    from torchmetrics_tpu_torch.functional.clustering.utils import expected_mutual_info

    label = "imagenet_clustering_labels"
    g = torch.Generator(device=dev).manual_seed(131)
    preds, target = _imagenet_cluster_labels(g, dev, classes, per_class, noise)
    steps = preds.numel() // batch

    def make(device, jit=True):
        return tm.MetricCollection({name: getattr(tm, name)(device=device, jit=jit) for name in LABEL_SCORES})

    def args_of(i):
        return preds[i * batch:(i + 1) * batch], target[i * batch:(i + 1) * batch]

    launches, routes, colls = 0, {}, {}
    for route, jit in (("eager", False), ("replayed", True)):
        colls[route] = make(dev, jit)
        routes[route] = _drive_collection(colls[route], steps, args_of, dev)
        launches += routes[route]["bincount_launches"]
        if routes[route]["bincount_launches"]:
            raise AssertionError(f"{label}: the {route} updates launched the bincount")
    if len(colls["replayed"].compute_groups) != 1:
        raise AssertionError(f"{label}: groups {colls['replayed'].compute_groups}, expected one")
    cpu = make(torch.device("cpu"))
    for i in range(steps):
        cpu.update(*(x.cpu() for x in args_of(i)))
    rep = colls["replayed"]["MutualInfoScore"]
    for other, what in ((colls["eager"]["MutualInfoScore"], "eager"), (cpu["MutualInfoScore"], "CPU")):
        for state in ("preds", "target"):
            if not _cat_equal(getattr(rep, state), getattr(other, state)):
                raise AssertionError(f"{label}: the replayed {state} state differs from the {what} run's")
    launches += _warm_computes(make(dev), args_of(0))
    values, computes = _member_computes(colls["replayed"], dev)
    for name, cost in computes.items():
        launches += cost["bincount_launches"]
        if cost["bincount_launches"] != 1:
            raise AssertionError(f"{label}: {name}'s compute launched {cost['bincount_launches']}, expected 1")
    _zero_kernel_counts()
    cont = _contingency(preds, target)  # the EMI's input, timed alone
    launches += _kernel_counts()["weighted_bincount"]
    emi, emi_ms, emi_peak = _timed_peak(dev, lambda: expected_mutual_info(cont))
    want, want_emi, terms = _np_label_scores(preds.cpu().numpy(), target.cpu().numpy())
    errors = {name: _hold_f64(label, name, values[name], want[name]) for name in LABEL_SCORES}
    errors["emi"] = _hold_f64(label, "EMI", emi, want_emi, rtol=EMI_RTOL)
    r, c = cont.shape
    record = {"phase": "a11a", "path": label, "samples": preds.numel(), "batch": batch, "updates": steps,
              "classes": classes, "noise": noise, "routes": routes, "cat_states_bitwise": ["eager", "cpu"],
              "compute": computes, "emi": {"ms": emi_ms, "peak_mb": emi_peak, "value": float(emi),
                                           "feasible_terms": terms, "jax_grid_entries": r * c * int(preds.numel())},
              "values": {k: float(v) for k, v in values.items()}, "max_rel_err_f64": errors, "card": card}
    return record, launches


def _f64_intrinsic(data, labels) -> dict:
    """float64 definitions of the three embedding scores on the card (the
    centroid distances in float64 without the matmul expansion)."""
    import torch

    x = data.double()
    _, lbl = torch.unique(labels, sorted=True, return_inverse=True)
    k = int(lbl.max()) + 1
    n = x.shape[0]
    counts = torch.zeros(k, dtype=torch.float64, device=x.device).index_add_(0, lbl, torch.ones_like(x[:, 0]))
    means = torch.zeros((k, x.shape[1]), dtype=torch.float64, device=x.device).index_add_(0, lbl, x) / counts[:, None]
    resid = x - means[lbl]
    bgss = torch.sum(counts * torch.sum((means - x.mean(0)) ** 2, dim=1))
    wgss = torch.sum(resid**2)
    dist = torch.linalg.vector_norm(resid, dim=1)
    del resid
    scatter = torch.zeros(k, dtype=torch.float64, device=x.device).index_add_(0, lbl, dist) / counts
    centre = torch.cdist(means, means, compute_mode="donot_use_mm_for_euclid_dist")
    eye = torch.eye(k, dtype=torch.bool, device=x.device)
    ratio = torch.where(eye, -torch.inf, (scatter[:, None] + scatter[None, :]) / centre)
    widest = torch.full((k,), -torch.inf, dtype=torch.float64, device=x.device)
    widest.scatter_reduce_(0, lbl, dist, "amax", include_self=False)
    return {"CalinskiHarabaszScore": float(bgss / wgss * (n - k) / (k - 1)),
            "DaviesBouldinScore": float(torch.mean(torch.max(ratio, dim=1).values)),
            "DunnIndex": float(torch.min(torch.where(eye, torch.inf, centre)) / torch.max(widest))}


def run_imagenet_clustering_embeddings(card: str, dev, classes: int = 1000, per_class: int = 50, dim: int = 2048,
                                       batch: int = 1000) -> tuple:
    """Path ``imagenet_clustering_embeddings``: Calinski-Harabasz,
    Davies-Bouldin and Dunn over 50,000 x 2,048 float32 features (ResNet-50's
    pooled width) from a seeded mixture of 1,000 Gaussians, with their 1,000
    labels: 50 updates of 1,000 rows (cat states of 410 MB). Each compute
    counts (one int32 launch) and sums (2,048 float32 rows over the shared
    labels) per cluster; Davies-Bouldin adds one launch for its scatter. The peak
    device memory of each compute stays under half the (k, k, D) array the
    JAX formula builds. Scores within A11A_RTOL of float64 on the card.
    (The sums are 36 launches of 57 rows on the card: a launch stages every
    weight row of a shared index, see ``ops.bincount.shared_rows_per_launch``.)
    Returns (record, launches)."""
    import torch

    import torchmetrics_tpu_torch as tm

    label = "imagenet_clustering_embeddings"
    g = torch.Generator(device=dev).manual_seed(132)
    n = classes * per_class
    labels = torch.arange(classes, device=dev).repeat_interleave(per_class)[torch.randperm(n, generator=g, device=dev)]
    centres = 2.0 * torch.randn((classes, dim), generator=g, device=dev)
    data = torch.randn((n, dim), generator=g, device=dev).add_(centres[labels])
    labels = labels.to(torch.int32)
    del centres
    steps = n // batch
    coll = tm.MetricCollection({name: getattr(tm, name)(device=dev) for name in EMBEDDING_SCORES})
    drive = _drive_collection(coll, steps, lambda i: (data[i * batch:(i + 1) * batch],
                                                      labels[i * batch:(i + 1) * batch]), dev)
    if drive["bincount_launches"]:
        raise AssertionError(f"{label}: the updates launched the bincount")
    if len(coll.compute_groups) != 1:
        raise AssertionError(f"{label}: groups {coll.compute_groups}, expected one")
    if not _cat_equal(coll["DunnIndex"].data, data):
        raise AssertionError(f"{label}: the data state differs from the features")
    launches = _warm_computes(tm.MetricCollection({name: getattr(tm, name)(device=dev) for name in EMBEDDING_SCORES}),
                              (data[:batch], labels[:batch]))
    values, computes = _member_computes(coll, dev)
    # the counts are one launch; the D sums rows over the shared label index take one launch per group of
    # rows the kernel stages (the plain version on the CPU is one call)
    sums = 1
    if dev.type == "cuda":
        from torchmetrics_tpu_torch.ops.bincount import shared_rows_per_launch

        sums = -(-dim // shared_rows_per_launch(n, dim, classes))
    want_launches = {"CalinskiHarabaszScore": 1 + sums, "DaviesBouldinScore": 2 + sums, "DunnIndex": 1 + sums}
    kkd_mb = classes * classes * dim * 4 / 2**20
    for name, cost in computes.items():
        launches += cost["bincount_launches"]
        if cost["bincount_launches"] != want_launches[name]:
            raise AssertionError(f"{label}: {name}'s compute launched {cost['bincount_launches']}, "
                                 f"expected {want_launches[name]}")
        if cost["peak_mb"] is not None and cost["peak_mb"] >= kkd_mb / 2:
            raise AssertionError(f"{label}: {name}'s compute peaked at {cost['peak_mb']} MB, the (k, k, D) array "
                                 f"is {kkd_mb} MB")
    want, ref_ms, _ = _timed_peak(dev, lambda: _f64_intrinsic(data, labels))
    errors = {name: _hold_f64(label, name, values[name], want[name]) for name in EMBEDDING_SCORES}
    record = {"phase": "a11a", "path": label, "samples": n, "dim": dim, "clusters": classes, "batch": batch,
              "updates": steps, "update": drive, "state_mb": n * dim * 4 / 2**20, "compute": computes,
              "kkd_array_mb": kkd_mb, "values": {k: float(v) for k, v in values.items()},
              "f64": want, "f64_ms": ref_ms, "max_rel_err_f64": errors, "card": card}
    return record, launches


def _np_nominal(confmat) -> dict:
    """float64 numpy definitions of the four table statistics of a
    (preds x target) table: empty rows and columns dropped, chi-squared with
    Yates' correction at one degree of freedom, bias-corrected V and T."""
    import numpy as np

    m = np.asarray(confmat, dtype=np.float64)
    m = m[m.sum(1) != 0]
    m = m[:, m.sum(0) != 0]
    n = m.sum()
    expected = np.outer(m.sum(1), m.sum(0)) / n
    r, c = m.shape
    obs = m
    if (r - 1) * (c - 1) == 1:
        diff = expected - m
        obs = m + np.sign(diff) * np.minimum(0.5, np.abs(diff))
    phi2 = np.sum((obs - expected) ** 2 / expected) / n
    phi2c = max(0.0, phi2 - (r - 1) * (c - 1) / (n - 1))
    rc, cc = r - (r - 1) ** 2 / (n - 1), c - (c - 1) ** 2 / (n - 1)
    p_xy = m.T / n  # Theil's U conditions on the rows of the target-by-preds table
    p_y = np.broadcast_to(p_xy.sum(1, keepdims=True), p_xy.shape)
    nz = p_xy > 0
    s_xy = np.sum(p_xy[nz] * np.log(p_y[nz] / p_xy[nz]))
    p_x = p_xy.sum(0)
    s_x = -np.sum(p_x[p_x > 0] * np.log(p_x[p_x > 0]))
    return {"CramersV": min(1.0, np.sqrt(phi2c / min(rc - 1, cc - 1))),
            "TschuprowsT": min(1.0, np.sqrt(phi2c / np.sqrt((rc - 1) * (cc - 1)))),
            "PearsonsContingencyCoefficient": np.sqrt(phi2 / (1 + phi2)),
            "TheilsU": (s_x - s_xy) / s_x}


def _adult_table(g, dev, rows: int):
    """A (rows, 9) float32 table of UCI Adult's categorical shape: each
    column draws from a shared latent class with probability 0.6 (so columns
    associate), else uniformly; NaN at Adult's missing rates."""
    import torch

    latent = torch.randint(0, 12, (rows,), generator=g, device=dev)
    cols = []
    for j, k in enumerate(ADULT_CATEGORIES):
        tied = (latent * (j + 5)) % k
        col = torch.where(torch.rand(rows, generator=g, device=dev) < 0.6, tied,
                          torch.randint(0, k, (rows,), generator=g, device=dev)).to(torch.float32)
        if j in ADULT_MISSING:
            col = torch.where(torch.rand(rows, generator=g, device=dev) < ADULT_MISSING[j], torch.nan, col)
        cols.append(col)
    return torch.stack(cols, 1)


def _cifar10h_ratings(g, dev, images: int, classes: int, raters: int):
    """CIFAR-10H's shape (Peterson et al., 2019): each of ``raters`` picks the
    image's class with probability 0.9, else a random class. Returns the
    (images, classes) int32 counts and (images, classes, raters) float32
    scores whose argmax over classes is each rater's pick."""
    import torch

    truth = torch.randint(0, classes, (images, 1), generator=g, device=dev)
    picks = torch.where(torch.rand((images, raters), generator=g, device=dev) < 0.9, truth,
                        torch.randint(0, classes, (images, raters), generator=g, device=dev))
    onehot = picks[:, None, :] == torch.arange(classes, device=dev)[None, :, None]
    counts = onehot.sum(2).to(torch.int32)
    probs = 0.5 * torch.rand((images, classes, raters), generator=g, device=dev) + onehot.to(torch.float32)
    return counts, probs


def _np_fleiss(counts) -> float:
    import numpy as np

    c = np.asarray(counts, dtype=np.float64)
    raters = c.sum(1).max()
    p_i = c.sum(0) / (c.shape[0] * raters)
    p_j = (np.sum(c**2, 1) - raters) / (raters * (raters - 1))
    pe = np.sum(p_i**2)
    return float((p_j.mean() - pe) / (1 - pe + 1e-5))


def run_model_agreement_nominal(card: str, dev, classes: int = 1000, samples: int = 50_000, batch: int = 1000,
                                images: int = 10_000, raters: int = 51, cifar_classes: int = 10,
                                fleiss_batch: int = 1000, adult_rows: int = 48_842) -> tuple:
    """Path ``model_agreement_nominal``: Cramer's V, Tschuprow's T, Pearson's
    C and Theil's U at num_classes=1000 between two classifiers' top-1
    predictions on ImageNet-1k val (76% accurate, agreeing on 85%), 50
    updates of 1,000 in one MetricCollection: one compute group, one
    launch per update of it (the 1,000 x 1,000 table, the sparse plan)
    after discovery; tables bitwise eager, replayed and on the CPU; values
    within NOMINAL_RTOL of float64. FleissKappa over CIFAR-10H's shape
    (10,000 images, 10 classes, 51 ratings), counts and probs (one launch
    per probs update), counts bitwise, kappa against float64. The four
    ``*_matrix`` functionals over a table of UCI Adult's shape under both
    NaN strategies: one launch per column pair, against a CPU run, and
    Cramer's V against float64. Returns (records, launches)."""
    import numpy as np
    import torch

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.functional import nominal as nf

    label = "model_agreement_nominal"
    g = torch.Generator(device=dev).manual_seed(133)
    target = torch.randint(0, classes, (samples,), generator=g, device=dev)
    model_a = torch.where(torch.rand(samples, generator=g, device=dev) < 0.76, target,
                          torch.randint(0, classes, (samples,), generator=g, device=dev)).to(torch.int32)
    model_b = torch.where(torch.rand(samples, generator=g, device=dev) < 0.85, model_a,
                          torch.randint(0, classes, (samples,), generator=g, device=dev)).to(torch.int32)
    steps = samples // batch

    def make(device, jit=True):
        return tm.MetricCollection({name: getattr(tm, name)(num_classes=classes, device=device, jit=jit)
                                    for name in NOMINAL_TABLES})

    def args_of(i):
        return model_a[i * batch:(i + 1) * batch], model_b[i * batch:(i + 1) * batch]

    launches, routes, colls = 0, {}, {}
    members = len(NOMINAL_TABLES)
    for route, jit in (("eager", False), ("replayed", True)):
        colls[route] = make(dev, jit)
        routes[route] = _drive_collection(colls[route], steps, args_of, dev)
        r = routes[route]
        launches += r["bincount_launches"]
        # group discovery runs every member once; a capture's warm-up runs the group's update once more
        want = members + (steps - 1) + r["captures"]
        if r["bincount_launches"] != want or r["steady_launches_per_update"] != 1:
            raise AssertionError(f"{label}: {route} launches {r}, expected {want} and 1 per update")
        if len(colls[route].compute_groups) != 1:
            raise AssertionError(f"{label}: groups {colls[route].compute_groups}, expected one")
    cpu = make(torch.device("cpu"))
    for i in range(steps):
        cpu.update(*(x.cpu() for x in args_of(i)))
    table = colls["replayed"]["CramersV"].confmat
    for other, what in ((colls["eager"]["CramersV"].confmat, "eager"), (cpu["CramersV"].confmat, "CPU")):
        if table.dtype != torch.float32 or not torch.equal(table.cpu(), other.cpu()):
            raise AssertionError(f"{label}: the replayed table differs from the {what} run's")
    launches += _warm_computes(make(dev), args_of(0))
    values, computes = _member_computes(colls["replayed"], dev)
    want = _np_nominal(table.cpu().numpy())
    errors = {name: _hold_f64(label, name, values[name], want[name], NOMINAL_RTOL) for name in NOMINAL_TABLES}
    records = [{"phase": "a11a", "path": label, "samples": samples, "batch": batch, "updates": steps,
                "classes": classes, "routes": routes, "table_bitwise": ["eager", "cpu"], "compute": computes,
                "values": {k: float(v) for k, v in values.items()}, "f64": want, "max_rel_err_f64": errors,
                "card": card}]

    # Fleiss kappa over CIFAR-10H's shape, both modes
    counts, probs = _cifar10h_ratings(g, dev, images, cifar_classes, raters)
    fleiss = {}
    for mode, ratings in (("counts", counts), ("probs", probs)):
        m = tm.FleissKappa(mode=mode, device=dev)
        drive = _drive_collection(m, images // fleiss_batch,
                                  lambda i, r=ratings: (r[i * fleiss_batch:(i + 1) * fleiss_batch],), dev)
        launches += drive["bincount_launches"]
        per_update = 1 if mode == "probs" else 0
        if drive["bincount_launches"] != per_update * (images // fleiss_batch + drive["captures"]):
            raise AssertionError(f"{label}: FleissKappa({mode}) launches {drive}")
        if not _cat_equal(m.counts, counts):
            raise AssertionError(f"{label}: FleissKappa({mode})'s counts differ from the ratings' counts")
        value, ms, peak = _timed_peak(dev, m.compute)
        fleiss[mode] = {"update": drive, "compute_ms": ms, "compute_peak_mb": peak, "value": float(value),
                        "max_rel_err_f64": _hold_f64(label, f"FleissKappa({mode})", value, _np_fleiss(counts.cpu()))}
    if fleiss["counts"]["value"] != fleiss["probs"]["value"]:
        raise AssertionError(f"{label}: FleissKappa differs between the modes: {fleiss}")
    records.append({"phase": "a11a", "path": label + "_fleiss_cifar10h", "images": images, "classes": cifar_classes,
                    "raters": raters, "batch": fleiss_batch, "modes": fleiss, "card": card})

    # the matrix functionals over a table of UCI Adult's shape
    adult = _adult_table(g, dev, adult_rows)
    adult_cpu = adult.cpu()
    pairs = len(ADULT_CATEGORIES) * (len(ADULT_CATEGORIES) - 1) // 2
    matrices = {}
    for name in ("cramers_v_matrix", "tschuprows_t_matrix", "pearsons_contingency_coefficient_matrix",
                 "theils_u_matrix"):
        for strategy in ("replace", "drop"):
            fn = getattr(nf, name)
            _zero_kernel_counts()
            got, ms, peak = _timed_peak(dev, lambda fn=fn, s=strategy: fn(adult, nan_strategy=s))
            n_launch = _kernel_counts()["weighted_bincount"]
            launches += n_launch
            if n_launch != pairs:
                raise AssertionError(f"{label}: {name}({strategy}) launched {n_launch}, expected {pairs}")
            err = _check_value(label, f"{name}({strategy}) against the CPU", got, fn(adult_cpu, nan_strategy=strategy),
                               A11A_RTOL)
            matrices[f"{name}_{strategy}"] = {"ms": ms, "peak_mb": peak, "launches": n_launch,
                                              "max_abs_err_cpu": err, "off_diagonal_mean": float(
                                                  (got.sum() - got.diagonal().sum()) / (got.numel() - got.shape[0]))}
            if name == "cramers_v_matrix" and strategy == "drop":
                a_np = adult_cpu.numpy()
                f64_err = 0.0
                for i in range(a_np.shape[1]):
                    for j in range(i + 1, a_np.shape[1]):
                        keep = ~(np.isnan(a_np[:, i]) | np.isnan(a_np[:, j]))
                        x, y = a_np[keep, i].astype(np.int64), a_np[keep, j].astype(np.int64)
                        k = int(max(x.max(), y.max())) + 1
                        tab = np.bincount(x * k + y, minlength=k * k).reshape(k, k)
                        f64_err = max(f64_err, _hold_f64(label, f"cramers_v_matrix[{i}, {j}]", got[i, j],
                                                         _np_nominal(tab)["CramersV"]))
                matrices[f"{name}_{strategy}"]["max_rel_err_f64"] = f64_err
    records.append({"phase": "a11a", "path": label + "_adult_matrices", "rows": adult_rows,
                    "categories": list(ADULT_CATEGORIES), "missing": {str(k): v for k, v in ADULT_MISSING.items()},
                    "column_pairs": pairs, "matrices": matrices, "card": card})
    return records, launches


def run_pairwise_gallery(card: str, dev, gallery: int = 50_000, queries: int = 10_000, dim: int = 2048,
                         l1_queries: int = 1000, l1_gallery: int = 10_000, block: int = 16) -> tuple:
    """Path ``pairwise_gallery``: image-retrieval similarity against an
    ImageNet-1k val gallery of 50,000 x 2,048 features (non-negative, as
    pooled ReLU features are): cosine, Euclidean and linear for 10,000
    queries (a 2 GB output each, one at a time), Manhattan and Minkowski
    (p = 3) for 1,000 queries against 10,000 gallery rows. ms (a second
    call, after one that warms the libraries up) and peak MB; sampled
    blocks of 16 rows by 512 columns against float64 on the card within
    A11A_RTOL of the block's largest magnitude. No bincount launch.
    Returns (record, launches)."""
    import torch

    from torchmetrics_tpu_torch.functional import pairwise as pw

    label = "pairwise_gallery"
    g = torch.Generator(device=dev).manual_seed(134)
    feats = torch.relu(torch.randn((gallery, dim), generator=g, device=dev) + 0.5)
    q_feats = torch.relu(torch.randn((queries, dim), generator=g, device=dev) + 0.5)

    def cosine64(x, y):
        return (x / torch.linalg.vector_norm(x, dim=1, keepdim=True)) @ (y / torch.linalg.vector_norm(y, dim=1,
                                                                                                     keepdim=True)).T

    def diff64(x, y, p):
        return torch.sum(torch.abs(x[:, None, :] - y[None, :, :]) ** p, dim=-1) ** (1.0 / p)

    cases = (("pairwise_cosine_similarity", {}, q_feats, feats, cosine64),
             ("pairwise_euclidean_distance", {}, q_feats, feats, lambda x, y: diff64(x, y, 2.0)),
             ("pairwise_linear_similarity", {}, q_feats, feats, lambda x, y: x @ y.T),
             ("pairwise_manhattan_distance", {}, q_feats[:l1_queries], feats[:l1_gallery],
              lambda x, y: diff64(x, y, 1.0)),
             ("pairwise_minkowski_distance", {"exponent": 3}, q_feats[:l1_queries], feats[:l1_gallery],
              lambda x, y: diff64(x, y, 3.0)))
    _zero_kernel_counts()
    results = {}
    for name, kw, x, y, ref in cases:
        fn = getattr(pw, name)
        fn(x, y, **kw)  # warms the libraries up; its output is dropped at once
        out, ms, peak = _timed_peak(dev, lambda fn=fn, x=x, y=y, kw=kw: fn(x, y, **kw))
        rows = torch.randint(0, x.shape[0], (block,), generator=g, device=dev)
        cols = torch.randint(0, y.shape[0], (512,), generator=g, device=dev)
        want = ref(x[rows].double(), y[cols].double())
        err = _hold(label, name, _rel_err(out[rows][:, cols], want), A11A_RTOL)
        results[name] = {"queries": x.shape[0], "gallery": y.shape[0], "ms": ms, "peak_mb": peak,
                         "output_mb": out.numel() * 4 / 2**20, "max_rel_err_f64_block": err}
        del out
    launches = _kernel_counts()["weighted_bincount"]
    if launches:
        raise AssertionError(f"{label}: the pairwise functionals launched the bincount")
    return {"phase": "a11a", "path": label, "dim": dim, "functionals": results, "card": card}, launches


def _tumour_masks(g, dev, shape):
    """Seeded tumour masks of a BraTS volume: the target a union of three
    ellipsoids, the prediction the same ellipsoids moved by a few voxels and
    scaled by up to 10%."""
    import torch

    axes = [torch.arange(s, device=dev, dtype=torch.float32) for s in shape]
    grid = torch.meshgrid(*axes, indexing="ij")
    size = torch.tensor(shape, dtype=torch.float32, device=dev)
    target = torch.zeros(shape, dtype=torch.bool, device=dev)
    preds = torch.zeros(shape, dtype=torch.bool, device=dev)
    for _ in range(3):
        centre = size * (0.3 + 0.4 * torch.rand(3, generator=g, device=dev))
        radii = 6.0 + 20.0 * torch.rand(3, generator=g, device=dev)
        shift = 4.0 * torch.rand(3, generator=g, device=dev) - 2.0
        scale = 0.9 + 0.2 * torch.rand(3, generator=g, device=dev)
        for mask, c, r in ((target, centre, radii), (preds, centre + shift, radii * scale)):
            mask |= sum(((grid[d] - c[d]) / r[d]) ** 2 for d in range(3)) <= 1.0
    return preds.to(torch.int32), target.to(torch.int32)


def _edt_slices(target_slices):
    """float64 scipy distances, slice by slice, to each slice's target
    foreground (inf where a slice has none), as ``surface_distance`` defines
    them, and each slice's transform of its own foreground."""
    import numpy as np
    from scipy import ndimage

    to_target = np.stack([ndimage.distance_transform_edt(1 - s) if s.any() else np.full(s.shape, np.inf)
                          for s in target_slices])
    transform = np.stack([ndimage.distance_transform_edt(s) for s in target_slices])
    return to_target, transform


def run_brats_surface(card: str, dev, shape=(240, 240, 155)) -> tuple:
    """Path ``brats_surface``: the segmentation toolbox on BraTS 2021 volumes
    (240 x 240 x 155 at 1 mm): binary_erosion and binary_dilation of a
    (1, 1, 240, 240, 155) mask, mask_edges with spacing (1, 1, 1) on a pair
    of seeded tumour masks (and the neighbour codes under it), and
    distance_transform and surface_distance on the 155 axial slices of
    240 x 240. Erosions, dilations, edges, areas and codes bitwise against a
    CPU run; distances within A11A_RTOL relative of scipy's float64
    distance_transform_edt. No bincount launch. Returns (record, launches)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from torchmetrics_tpu_torch.functional import segmentation as seg
    from torchmetrics_tpu_torch.functional.segmentation.utils import neighbour_codes

    label = "brats_surface"
    g = torch.Generator(device=dev).manual_seed(135)
    preds, target = _tumour_masks(g, dev, shape)
    cpu_preds, cpu_target = preds.cpu(), target.cpu()
    _zero_kernel_counts()
    ops = {}
    volume = target.to(torch.float32)[None, None]
    for name, fn in (("binary_erosion", seg.binary_erosion), ("binary_dilation", seg.binary_dilation)):
        out, ms, peak = _timed_peak(dev, lambda fn=fn: fn(volume))
        if not torch.equal(out.cpu(), fn(volume.cpu())):
            raise AssertionError(f"{label}: {name} differs from the CPU run")
        ops[name] = {"ms": ms, "peak_mb": peak, "foreground": int(out.sum()), "bitwise_cpu": True}
    edges, ms, peak = _timed_peak(dev, lambda: seg.mask_edges(preds, target, spacing=(1, 1, 1)))
    cpu_edges = seg.mask_edges(cpu_preds, cpu_target, spacing=(1, 1, 1))
    for i, (got, want) in enumerate(zip(edges, cpu_edges)):
        if got.dtype != want.dtype or not torch.equal(got.cpu(), want):
            raise AssertionError(f"{label}: mask_edges output {i} differs from the CPU run")
    _, again_ms, _ = _timed_peak(dev, lambda: seg.mask_edges(preds, target, spacing=(1, 1, 1)))
    ops["mask_edges"] = {"ms": ms, "ms_table_built": again_ms, "peak_mb": peak,
                         "edge_voxels": [int(edges[0].sum()), int(edges[1].sum())],
                         "surface_mm2": [float(edges[2].double().sum()), float(edges[3].double().sum())],
                         "bitwise_cpu": True}
    _, kernel = seg.get_neighbour_tables((1.0, 1.0, 1.0), device=dev)
    padded = F.pad(torch.stack([preds, target]), (1, 1) * 3)
    codes = neighbour_codes(padded, kernel)
    if not torch.equal(codes.cpu(), neighbour_codes(padded.cpu(), kernel.cpu())):
        raise AssertionError(f"{label}: the neighbour codes differ from the CPU run")
    ops["neighbour_codes"] = {"shape": list(codes.shape), "distinct": int(torch.unique(codes).numel()),
                              "bitwise_cpu": True}
    p_slices = preds.permute(2, 0, 1).contiguous()
    t_slices = target.permute(2, 0, 1).contiguous()
    to_target, transform = _edt_slices(t_slices.cpu().numpy())
    dt, ms, peak = _timed_peak(dev, lambda: seg.distance_transform(t_slices))
    err = float(np.max(np.abs(dt.cpu().numpy().astype(np.float64) - transform) / np.maximum(transform, 1.0)))
    _hold(label, "distance_transform", err, A11A_RTOL)
    ops["distance_transform"] = {"slices": list(t_slices.shape), "ms": ms, "peak_mb": peak,
                                 "max_rel_err_scipy": err}
    sd, ms, peak = _timed_peak(dev, lambda: seg.surface_distance(p_slices, t_slices))
    want = to_target[p_slices.cpu().numpy().astype(bool)]
    got = sd.cpu().numpy().astype(np.float64)
    finite = np.isfinite(want)
    if got.shape != want.shape or not np.array_equal(np.isfinite(got), finite):
        raise AssertionError(f"{label}: surface_distance has {got.shape} values, scipy {want.shape}")
    err = float(np.max(np.abs(got[finite] - want[finite]) / np.maximum(want[finite], 1.0), initial=0.0))
    _hold(label, "surface_distance", err, A11A_RTOL)
    ops["surface_distance"] = {"ms": ms, "peak_mb": peak, "distances": int(got.size),
                               "mean_mm": float(got[finite].mean()) if finite.any() else None,
                               "max_rel_err_scipy": err}
    launches = _kernel_counts()["weighted_bincount"]
    if launches:
        raise AssertionError(f"{label}: the segmentation toolbox launched the bincount")
    return {"phase": "a11a", "path": label, "shape": list(shape), "voxels": int(np.prod(shape)),
            "tumour_voxels": [int(preds.sum()), int(target.sum())], "ops": ops, "card": card}, launches


def run_a11a_paths(card: str, dev) -> tuple:
    """The five A11.a paths; (records, bincount launches over them)."""
    records, launches = [], 0
    for run in (run_imagenet_clustering_labels, run_imagenet_clustering_embeddings, run_model_agreement_nominal,
                run_pairwise_gallery, run_brats_surface):
        t0 = time.perf_counter()
        out, n = run(card, dev)
        out = out if isinstance(out, list) else [out]
        out[0]["seconds"] = time.perf_counter() - t0
        out[0]["bincount_launches"] = n
        records += out
        launches += n
    return records, launches


# ---------------------------------------------------------------------------
# A11.b: the host C++ library and detection
# ---------------------------------------------------------------------------

# the host library's public entry points, counted and timed over the run
NATIVE_ENTRY_POINTS = ("edit_distance_batch", "edit_distance_counts_batch", "linear_sum_assignment",
                       "rle_from_coco_string", "rle_to_coco_string", "rle_encode", "rle_decode", "rle_area",
                       "rle_iou", "box_iou", "box_iou_batch", "coco_match", "coco_stage_match_batch")
COCO_CLASSES = 80
COCO_SIZE = (480, 640)  # (height, width) of most COCO val2017 images
# COCO val2017: 36,781 boxes over 5,000 images, about 1% crowd, areas about
# 41 / 34 / 24% small / medium / large (side below 32, 32 to 96, above 96)
COCO_GT_PER_IMAGE = 36_781 / 5_000
COCO_AREA_SHARES = (0.41, 0.34, 0.25)
COCO_SIDES = (4.0, 32.0, 96.0, 400.0)
COCO_CROWD = 0.01
# Cityscapes' panoptic label ids: 8 thing and 11 stuff categories; 0
# (unlabeled) is void; UNKNOWN_CATEGORY is painted into predictions only
CITYSCAPES_THINGS = (24, 25, 26, 27, 28, 31, 32, 33)
CITYSCAPES_STUFFS = (7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23)
UNKNOWN_CATEGORY = 99
IOU_FAMILY = ("IntersectionOverUnion", "GeneralizedIntersectionOverUnion", "DistanceIntersectionOverUnion",
              "CompleteIntersectionOverUnion")
# the IoU family's float64 means, card against CPU (the tests' tolerance against JAX)
IOU_MEAN_RTOL = 1e-6


@contextlib.contextmanager
def _timed_calls(targets):
    """Wrap each ``(owner, attribute)`` for the block: every call adds one
    to ``totals[attribute][0]`` and its host seconds to ``[1]``."""
    totals = {name: [0, 0.0] for _, name in targets}
    saved = []
    for owner, name in targets:
        fn = getattr(owner, name)

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                totals[_name][0] += 1
                totals[_name][1] += time.perf_counter() - t0

        setattr(owner, name, wrapped)
        saved.append((owner, name, fn))
    try:
        yield totals
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def _log_uniform(g, dev, n: int, lo, hi):
    import torch

    lo, hi = torch.as_tensor(lo, device=dev), torch.as_tensor(hi, device=dev)
    return torch.exp(torch.log(lo) + (torch.log(hi) - torch.log(lo)) * torch.rand(n, generator=g, device=dev))


def _coco_scene(g, dev, images: int, dets: int = 100, classes: int = COCO_CLASSES) -> tuple:
    """Seeded COCO val2017-like boxes on the card: (preds, targets) lists of
    per-image dicts and the ground-truth count of each image. Ground truth:
    a Poisson number of xyxy boxes an image (mean 36,781 / 5,000), sides
    log-uniform within the small / medium / large ranges in COCO's shares,
    aspect ratios up to 2:1, a quarter of the labels the first class
    (person), the rest uniform, 1% crowd. Detections: ``dets`` scored boxes
    an image; the first two per ground-truth box jitter it (90% keep its
    label, scores in [0.3, 1)), the rest are random boxes (scores in
    [0, 0.6)). One host read (the counts), at set-up."""
    import torch

    h, w = COCO_SIZE
    n_gt = torch.poisson(torch.full((images,), COCO_GT_PER_IMAGE, device=dev), generator=g).to(torch.int64)
    n_gt = torch.clamp(n_gt, max=dets // 2)
    counts = n_gt.tolist()
    total = sum(counts)
    size = torch.multinomial(torch.tensor(COCO_AREA_SHARES, device=dev), max(total, 1), replacement=True,
                             generator=g)[:total]
    sides = torch.tensor(COCO_SIDES, device=dev)
    side = _log_uniform(g, dev, total, sides[size], sides[size + 1])
    ratio = torch.exp((torch.rand(total, generator=g, device=dev) - 0.5) * 1.4).sqrt()
    bw, bh = torch.clamp(side * ratio, max=w - 1.0), torch.clamp(side / ratio, max=h - 1.0)
    x1 = torch.rand(total, generator=g, device=dev) * (w - bw)
    y1 = torch.rand(total, generator=g, device=dev) * (h - bh)
    gt_boxes = torch.stack([x1, y1, x1 + bw, y1 + bh], 1)
    probs = torch.full((classes,), 0.75 / (classes - 1), device=dev)
    probs[0] = 0.25
    gt_labels = torch.multinomial(probs, max(total, 1), replacement=True, generator=g)[:total]
    crowd = (torch.rand(total, generator=g, device=dev) < COCO_CROWD).to(torch.int64)

    slot = torch.arange(dets, device=dev)[None, :]
    first = torch.cumsum(n_gt, 0) - n_gt
    tp = slot < 2 * n_gt[:, None]
    base = torch.where(tp, first[:, None] + slot % torch.clamp(n_gt[:, None], min=1), 0)
    base = torch.clamp(base, max=max(total - 1, 0))
    src = gt_boxes[base] if total else torch.zeros((images, dets, 4), device=dev)
    wh = (src[..., 2:] - src[..., :2]).repeat(1, 1, 2)
    jittered = src + (torch.rand((images, dets, 4), generator=g, device=dev) - 0.5) * 0.3 * wh
    r_side = _log_uniform(g, dev, images * dets, 8.0, 300.0).reshape(images, dets)
    rx = torch.rand((images, dets), generator=g, device=dev) * (w - r_side).clamp(min=1.0)
    ry = torch.rand((images, dets), generator=g, device=dev) * (h - r_side).clamp(min=1.0)
    random_boxes = torch.stack([rx, ry, rx + r_side, ry + r_side], -1)
    det_boxes = torch.where(tp[..., None], jittered, random_boxes)
    det_boxes[..., 2:] = torch.maximum(det_boxes[..., 2:], det_boxes[..., :2] + 1.0)
    keep = tp & (torch.rand((images, dets), generator=g, device=dev) < 0.9)
    rand_labels = torch.randint(0, classes, (images, dets), generator=g, device=dev)
    det_labels = torch.where(keep, gt_labels[base] if total else rand_labels, rand_labels)
    u = torch.rand((images, dets), generator=g, device=dev)
    det_scores = torch.where(tp, 0.3 + 0.7 * u, 0.6 * u)
    preds = [{"boxes": b, "scores": s, "labels": lab}
             for b, s, lab in zip(det_boxes.unbind(0), det_scores.unbind(0), det_labels.unbind(0))]
    targets = [{"boxes": b, "labels": lab, "iscrowd": c}
               for b, lab, c in zip(torch.split(gt_boxes, counts), torch.split(gt_labels, counts),
                                    torch.split(crowd, counts))]
    return preds, targets, counts


def _on_cpu_items(items) -> list:
    return [{k: (v.cpu() if hasattr(v, "cpu") else v) for k, v in d.items()} for d in items]


def _results_bitwise(label: str, got: dict, want: dict) -> int:
    """Every key of two compute results (tensors, or dicts of them) bitwise
    equal; returns the number of tensors compared."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: result keys differ: {sorted(got)} and {sorted(want)}")
    n = 0
    for k, w in want.items():
        pairs = [(got[k][kk], w[kk]) for kk in w] if isinstance(w, dict) else [(got[k], w)]
        for a, b in pairs:
            a, b = a.cpu().numpy(), b.cpu().numpy()
            if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
                raise AssertionError(f"{label}: {k} differs from the device='cpu' run: {a} and {b}")
            n += 1
    return n


def _timed_detection_updates(metrics, batches, dev, sync_free: bool) -> list:
    """Update each metric with each ``(preds, targets)`` batch; host ms of
    each update (all metrics), under set_sync_debug_mode("error") when
    ``sync_free`` on the card."""
    times = []
    for preds, targets in batches:
        _sync(dev)
        t0 = time.perf_counter()
        with _sync_debug("error", sync_free and dev.type == "cuda"):
            for m in metrics:
                m.update(preds, targets)
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _batches(preds, targets, batch: int, images: int) -> list:
    return [(preds[i:i + batch], targets[i:i + batch]) for i in range(0, images, batch)]


def _peak_reset(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _peak_mb(dev):
    import torch

    return torch.cuda.max_memory_allocated() / 2**20 if dev.type == "cuda" else None


def run_coco_bbox(card: str, dev, scene, batch: int = 16, check: int = 500) -> tuple:
    """Path ``coco_val2017_bbox``: MeanAveragePrecision(iou_type="bbox",
    class_metrics=True) over COCO val2017's 5,000 images (``scene`` from
    :func:`_coco_scene`), 80 classes, 100 detections an image, in updates of
    ``batch`` images under set_sync_debug_mode("error"); compute timed and
    split into the host copy of the states, the IoU batch, the stage match
    and the accumulation; every output key on the first ``check`` images
    bitwise against device="cpu". No bincount launch. Returns (record, launches)."""
    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch import _native
    from torchmetrics_tpu_torch.functional.detection import coco_eval

    label = "coco_val2017_bbox"
    preds, targets, counts = scene
    images = len(preds)
    _zero_kernel_counts()
    _peak_reset(dev)
    metric = tm.MeanAveragePrecision(iou_type="bbox", class_metrics=True, device=dev)
    times = _timed_detection_updates([metric], _batches(preds, targets, batch, images), dev, sync_free=True)
    stages = ((tm.MeanAveragePrecision, "_host_states"), (_native, "box_iou_batch"),
              (_native, "coco_stage_match_batch"), (coco_eval, "accumulate"))
    with _timed_calls(stages) as spent:
        t0 = time.perf_counter()
        result = metric.compute()
        compute_s = time.perf_counter() - t0
    peak = _peak_mb(dev)
    launches = _kernel_counts()["weighted_bincount"]
    if launches:
        raise AssertionError(f"{label}: mAP launched the bincount")
    card_sub = tm.MeanAveragePrecision(iou_type="bbox", class_metrics=True, device=dev)
    cpu_sub = tm.MeanAveragePrecision(iou_type="bbox", class_metrics=True, device="cpu")
    for p, t in _batches(preds, targets, batch, check):
        card_sub.update(p, t)
        cpu_sub.update(_on_cpu_items(p), _on_cpu_items(t))
    compared = _results_bitwise(label, card_sub.compute(), cpu_sub.compute())
    return {"phase": "a11b", "path": label, "images": images, "classes": COCO_CLASSES, "detections_per_image": 100,
            "ground_truth": sum(counts), "batch": batch, "updates": len(times),
            "update_ms_per_image": statistics.median(times) / batch, "first_update_ms": times[0],
            # any host read raises under set_sync_debug_mode("error")
            "update_host_reads": 0 if dev.type == "cuda" else None,
            "compute_s": compute_s, "compute_split_s": {name: spent[name][1] for _, name in stages},
            "peak_mb": peak, "values": {k: float(result[k]) for k in ("map", "map_50", "map_75", "map_small",
                                                                       "map_medium", "map_large", "mar_100")},
            "bitwise_cpu": {"images": check, "tensors": compared}, "card": card}, launches


def run_coco_iou_family(card: str, dev, scene, batch: int = 16, check: int = 500) -> tuple:
    """Path ``coco_iou_family``: IoU, GIoU, DIoU and CIoU with
    respect_labels=True and class_metrics=True on ``coco_val2017_bbox``'s
    boxes, updates of ``batch`` images under set_sync_debug_mode("error"),
    each compute timed; on the first ``check`` images every value within
    IOU_MEAN_RTOL of device="cpu". No bincount launch. Returns (record, launches)."""
    import torch

    import torchmetrics_tpu_torch as tm

    label = "coco_iou_family"
    preds, targets, _ = scene
    images = len(preds)
    _zero_kernel_counts()
    _peak_reset(dev)
    make = {name: (lambda device, name=name: getattr(tm, name)(respect_labels=True, class_metrics=True,
                                                               device=device)) for name in IOU_FAMILY}
    metrics = {name: mk(dev) for name, mk in make.items()}
    times = _timed_detection_updates(list(metrics.values()), _batches(preds, targets, batch, images), dev, sync_free=True)
    computes, values = {}, {}
    for name, m in metrics.items():
        values[name], ms, peak = _timed_peak(dev, m.compute)
        computes[name] = {"ms": ms, "peak_mb": peak, "entries": int(sum(x.numel() for x in m.iou_matrix))}
    peak = _peak_mb(dev)
    launches = _kernel_counts()["weighted_bincount"]
    if launches:
        raise AssertionError(f"{label}: the IoU family launched the bincount")
    errors = {}
    for name, mk in make.items():
        card_sub, cpu_sub = mk(dev), mk(torch.device("cpu"))
        for p, t in _batches(preds, targets, batch, check):
            card_sub.update(p, t)
            cpu_sub.update(_on_cpu_items(p), _on_cpu_items(t))
        got, want = card_sub.compute(), cpu_sub.compute()
        if sorted(got) != sorted(want):
            raise AssertionError(f"{label}: {name}'s keys differ from the CPU run's")
        err = 0.0
        for k in want:
            a, b = float(got[k]), float(want[k])
            if a != b:
                err = max(err, abs(a - b) / abs(b))
        errors[name] = _hold(label, f"{name} against device='cpu'", err, IOU_MEAN_RTOL)
    return {"phase": "a11b", "path": label, "images": images, "batch": batch, "metrics": list(IOU_FAMILY),
            "update_ms_per_image_all_four": statistics.median(times) / batch,
            "update_host_reads": 0 if dev.type == "cuda" else None, "compute": computes, "peak_mb": peak,
            "values": {n: float(v[metrics[n]._iou_type]) for n, v in values.items()},
            "classes_reported": {n: len(v) - 1 for n, v in values.items()},
            "max_rel_err_cpu": errors, "cpu_images": check, "card": card}, launches


def _coco_masks(g, dev, images: int, height: int, width: int, dets: int = 20, gts: int = 8) -> tuple:
    """Seeded instance masks on the card: per image ``gts`` ground-truth
    ellipses and ``dets`` detections (each ground truth jittered, the rest
    random), (N, H, W) bool, labels over 80 classes, scores; ~1% crowd."""
    import torch

    ys = torch.arange(height, device=dev, dtype=torch.float32)[None, :, None]
    xs = torch.arange(width, device=dev, dtype=torch.float32)[None, None, :]

    def ellipses(params):
        cx, cy, ax, ay = params.unbind(1)
        return ((xs - cx[:, None, None]) / ax[:, None, None]) ** 2 + \
               ((ys - cy[:, None, None]) / ay[:, None, None]) ** 2 <= 1.0

    extra = dets - gts
    preds, targets = [], []
    for _ in range(images):
        ax = _log_uniform(g, dev, gts, 6.0, width / 4)
        ay = ax * torch.exp((torch.rand(gts, generator=g, device=dev) - 0.5) * 1.2)
        gt = torch.stack([torch.rand(gts, generator=g, device=dev) * width,
                          torch.rand(gts, generator=g, device=dev) * height, ax, ay], 1)
        jit = gt + (torch.rand((gts, 4), generator=g, device=dev) - 0.5) * 0.3 * gt[:, 2:].repeat(1, 2)
        rnd = torch.stack([torch.rand(extra, generator=g, device=dev) * width,
                           torch.rand(extra, generator=g, device=dev) * height,
                           _log_uniform(g, dev, extra, 6.0, width / 4), _log_uniform(g, dev, extra, 6.0, width / 4)], 1)
        dt = torch.cat([jit, rnd])
        g_labels = torch.randint(0, COCO_CLASSES, (gts,), generator=g, device=dev)
        keep = torch.rand(gts, generator=g, device=dev) < 0.9
        d_labels = torch.cat([torch.where(keep, g_labels, torch.randint(0, COCO_CLASSES, (gts,), generator=g,
                                                                        device=dev)),
                              torch.randint(0, COCO_CLASSES, (extra,), generator=g, device=dev)])
        u = torch.rand(dets, generator=g, device=dev)
        scores = torch.where(torch.arange(dets, device=dev) < gts, 0.3 + 0.7 * u, 0.6 * u)
        crowd = (torch.rand(gts, generator=g, device=dev) < COCO_CROWD).to(torch.int64)
        preds.append({"masks": ellipses(dt), "scores": scores, "labels": d_labels})
        targets.append({"masks": ellipses(gt), "labels": g_labels, "iscrowd": crowd})
    return preds, targets


def _as_coco_rle(masks) -> list:
    """Dense (N, H, W) bool masks as pycocotools' RLE dicts with compressed strings."""
    from torchmetrics_tpu_torch import _native

    host = masks.cpu().numpy().astype("uint8")
    return [{"size": list(m.shape), "counts": _native.rle_to_coco_string(_native.rle_encode(m))} for m in host]


def run_coco_segm(card: str, dev, images: int = 500, height: int = 480, width: int = 640, batch: int = 8,
                  check: int = 50, rle_every: int = 10) -> tuple:
    """Path ``coco_val2017_segm``: MeanAveragePrecision(iou_type="segm") over
    ``images`` images of ``height`` x ``width`` with 20 dense bool detection
    masks and 8 ground-truth masks an image (3.9 GB of dense states on the
    card at 500 images of 480 x 640); every ``rle_every``-th
    image's masks given as RLE dicts with pycocotools' compressed strings.
    Update ms, compute seconds (of which the dense-mask intersections, one
    float64 product per image on the card), peak memory; every output key
    on the first ``check`` images bitwise against device="cpu". Returns
    (record, launches)."""
    import torch

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.functional.detection import coco_eval

    label = "coco_val2017_segm"
    g = torch.Generator(device=dev).manual_seed(141)
    t0 = time.perf_counter()
    preds, targets = _coco_masks(g, dev, images, height, width)
    for i in range(0, images, rle_every):
        preds[i] = {**preds[i], "masks": _as_coco_rle(preds[i]["masks"])}
        targets[i] = {**targets[i], "masks": _as_coco_rle(targets[i]["masks"])}
    _sync(dev)
    setup_s = time.perf_counter() - t0
    dense_bytes = sum(d["masks"].numel() for d in preds + targets if isinstance(d["masks"], torch.Tensor))
    _zero_kernel_counts()
    _peak_reset(dev)
    metric = tm.MeanAveragePrecision(iou_type="segm", device=dev)
    times = _timed_detection_updates([metric], _batches(preds, targets, batch, images), dev, sync_free=True)
    with _timed_calls(((coco_eval, "dense_mask_overlaps"),)) as spent:
        t0 = time.perf_counter()
        result = metric.compute()
        compute_s = time.perf_counter() - t0
    peak = _peak_mb(dev)
    launches = _kernel_counts()["weighted_bincount"]
    if launches:
        raise AssertionError(f"{label}: mAP launched the bincount")
    card_sub = tm.MeanAveragePrecision(iou_type="segm", device=dev)
    cpu_sub = tm.MeanAveragePrecision(iou_type="segm", device="cpu")
    for p, t in _batches(preds, targets, batch, check):
        card_sub.update(p, t)
        cpu_sub.update(_on_cpu_items(p), _on_cpu_items(t))
    compared = _results_bitwise(label, card_sub.compute(), cpu_sub.compute())
    return {"phase": "a11b", "path": label, "images": images, "height": height, "width": width, "batch": batch,
            "masks": {"detections": sum(len(p["labels"]) for p in preds),
                      "ground_truth": sum(len(t["labels"]) for t in targets),
                      "rle_images": len(range(0, images, rle_every)), "dense_state_bytes": dense_bytes},
            "setup_s": setup_s, "update_ms_per_image": statistics.median(times) / batch,
            "update_host_reads": 0 if dev.type == "cuda" else None, "compute_s": compute_s,
            "mask_intersections_s": spent["dense_mask_overlaps"][1],
            "mask_intersection_calls": spent["dense_mask_overlaps"][0], "peak_mb": peak,
            "values": {k: float(result[k]) for k in ("map", "map_50", "map_75", "mar_100")},
            "bitwise_cpu": {"images": check, "tensors": compared}, "card": card}, launches


def _cityscapes_panoptic(g, dev, height: int = 1024, width: int = 2048, instances: int = 20, cell: int = 32):
    """One seeded Cityscapes-like (1, H, W, 2) target and prediction on the
    card. Stuff: ``cell``-pixel cells drawn by height band (sky and
    buildings above, vegetation and structures, then sidewalk and road),
    4% void (unlabeled) cells; things: ``instances`` boxes of the 8 thing
    categories, sides log-uniform from 16 to 400 pixels, later ones on top.
    The prediction redraws 10% of the stuff cells, shifts each instance by
    up to 8 pixels, drops two and adds one, and paints 2% of its cells an
    unknown category."""
    import torch

    gh, gw = height // cell, width // cell
    bands = torch.tensor([[23, 23, 11, 11], [11, 21, 17, 20], [21, 22, 12, 13], [7, 7, 8, 19]], device=dev)
    band = (torch.arange(gh, device=dev) * bands.shape[0] // gh)[:, None].expand(gh, gw)

    def stuff_cells():
        return bands[band, torch.randint(0, bands.shape[1], (gh, gw), generator=g, device=dev)]

    t_cells = torch.where(torch.rand((gh, gw), generator=g, device=dev) < 0.04, 0, stuff_cells())
    p_cells = torch.where(torch.rand((gh, gw), generator=g, device=dev) < 0.1, stuff_cells(), t_cells)
    p_cells = torch.where(torch.rand((gh, gw), generator=g, device=dev) < 0.02, UNKNOWN_CATEGORY, p_cells)
    things = torch.tensor(CITYSCAPES_THINGS, device=dev)
    cats = things[torch.randint(0, len(CITYSCAPES_THINGS), (instances + 1,), generator=g, device=dev)]
    bw, bh = _log_uniform(g, dev, instances + 1, 16.0, 400.0), _log_uniform(g, dev, instances + 1, 16.0, 400.0)
    x1 = torch.rand(instances + 1, generator=g, device=dev) * (width - bw)
    y1 = torch.rand(instances + 1, generator=g, device=dev) * (height - bh)
    boxes = torch.stack([x1, y1, x1 + bw, y1 + bh], 1)
    shifted = boxes + ((torch.rand((instances + 1, 2), generator=g, device=dev) - 0.5) * 16).repeat(1, 2)
    ys = torch.arange(height, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(width, device=dev, dtype=torch.float32)[None, :]

    def paint(cells, bxs, present):
        top = torch.zeros((height, width), dtype=torch.int64, device=dev)
        for k in range(len(bxs)):  # later boxes on top
            inside = (xs >= bxs[k, 0]) & (xs < bxs[k, 2]) & (ys >= bxs[k, 1]) & (ys < bxs[k, 3]) & present[k]
            top = torch.where(inside, k + 1, top)
        stuff = cells.repeat_interleave(cell, 0).repeat_interleave(cell, 1)
        cat = torch.where(top > 0, cats[torch.clamp(top - 1, min=0)], stuff)
        return torch.stack([cat, top], -1)[None].to(torch.int64)

    t_present = torch.arange(instances + 1, device=dev) < instances
    p_present = torch.arange(instances + 1, device=dev) >= 2  # two dropped, one extra
    return paint(p_cells, shifted, p_present), paint(t_cells, boxes, t_present)


def _panoptic_pair_index(pred, target):
    """The int32 pair index of one sample's table of intersections and its
    bins (P·T), as ``functional.detection.panoptic_quality`` forms it."""
    import torch

    dev = pred.device
    cats = torch.tensor(sorted(CITYSCAPES_THINGS + CITYSCAPES_STUFFS), device=dev)
    p, t = pred.reshape(-1, 2), target.reshape(-1, 2)
    offset = torch.cat([p[:, 1], t[:, 1], torch.zeros(1, dtype=torch.int64, device=dev)]).max() + 2
    pk = torch.where(torch.isin(p[:, 0], cats), p[:, 0] * offset + p[:, 1], -1)
    tk = torch.where(torch.isin(t[:, 0], cats), t[:, 0] * offset + t[:, 1], -1)
    _, p_inv = torch.unique(pk, sorted=True, return_inverse=True)
    t_keys, t_inv = torch.unique(tk, sorted=True, return_inverse=True)
    n_t = t_keys.numel()
    bins = (int(p_inv.max()) + 1) * n_t
    return (p_inv * n_t + t_inv).to(torch.int32), bins


def run_cityscapes_panoptic(card: str, dev, images: int = 500, height: int = 1024, width: int = 2048,
                            check: int = 4) -> tuple:
    """Path ``cityscapes_panoptic``: PanopticQuality and
    ModifiedPanopticQuality (Cityscapes' 8 thing and 11 stuff categories,
    allow_unknown_preds_category=True) over ``images`` seeded images of
    ``height`` x ``width`` (:func:`_cityscapes_panoptic`), batch 1: update
    ms an image, host synchronisations an update, bincount launches an
    update (one: the table of intersections) and the table's bins an image;
    the four states of both metrics after the first ``check`` images
    bitwise against device="cpu". Returns (record, launches)."""
    import importlib

    import torch

    import torchmetrics_tpu_torch as tm

    label = "cityscapes_panoptic"
    pq_mod = importlib.import_module("torchmetrics_tpu_torch.functional.detection.panoptic_quality")
    g = torch.Generator(device=dev).manual_seed(151)
    kw = dict(things=set(CITYSCAPES_THINGS), stuffs=set(CITYSCAPES_STUFFS), allow_unknown_preds_category=True)
    metrics = {"PanopticQuality": tm.PanopticQuality(**kw, device=dev),
               "ModifiedPanopticQuality": tm.ModifiedPanopticQuality(**kw, device=dev)}
    cpu = {name: type(m)(**kw, device="cpu") for name, m in metrics.items()}
    states = ("iou_sum", "true_positives", "false_positives", "false_negatives")
    bins, times, reads = [], {name: [] for name in metrics}, {}
    setup_s = 0.0
    _zero_kernel_counts()
    _peak_reset(dev)
    real = pq_mod.weighted_bincount

    def recording(idx, weights=None, num_bins=0):
        bins.append(num_bins)
        return real(idx, weights, num_bins)

    pq_mod.weighted_bincount = recording
    try:
        for i in range(images):
            t0 = time.perf_counter()
            pred, target = _cityscapes_panoptic(g, dev, height, width)
            _sync(dev)
            setup_s += time.perf_counter() - t0
            for name, m in metrics.items():
                if i == 2 and dev.type == "cuda":
                    _, reads[name], _ = count_host_reads(lambda m=m: m.update(pred, target))
                    continue
                _sync(dev)
                t0 = time.perf_counter()
                m.update(pred, target)
                _sync(dev)
                times[name].append((time.perf_counter() - t0) * 1e3)
            if i < check:
                for c in cpu.values():
                    c.update(pred.cpu(), target.cpu())
            if i == check - 1:
                for name, m in metrics.items():
                    for s in states:
                        a, b = getattr(m, s).cpu(), getattr(cpu[name], s)
                        if a.dtype != b.dtype or not torch.equal(a, b):
                            raise AssertionError(f"{label}: {name}.{s} differs from the device='cpu' run")
    finally:
        pq_mod.weighted_bincount = real
    launches = _kernel_counts()["weighted_bincount"]
    if dev.type == "cuda" and launches != 2 * images:
        raise AssertionError(f"{label}: {launches} bincount launches over {images} images of two metrics, "
                             f"expected one an update")
    values, computes = {}, {}
    for name, m in metrics.items():
        values[name], ms, _ = _timed_peak(dev, m.compute)
        computes[name] = ms
    return {"phase": "a11b", "path": label, "images": images, "height": height, "width": width, "batch": 1,
            "pixels": height * width, "setup_s": setup_s,
            "update_ms_per_image": {n: statistics.median(t) for n, t in times.items()},
            "host_syncs_per_update": reads or None, "launches_per_update": launches / (2 * images),
            "table_bins": {"min": min(bins), "median": statistics.median(bins), "max": max(bins)},
            "table_calls": len(bins), "compute_ms": computes, "peak_mb": _peak_mb(dev),
            "values": {n: float(v) for n, v in values.items()},
            "states_bitwise_cpu": {"images": check, "states": list(states)}, "card": card}, launches


def native_check() -> dict:
    """The host library on this machine against its plain numpy versions
    on seeded inputs: box IoU within 4 float64 ulp (the FMA ``-march=native``
    may contract), the rest equal. Returns the largest errors."""
    import numpy as np

    from torchmetrics_tpu_torch import _native

    rng = np.random.RandomState(0)
    dt, gt = rng.rand(200, 4) * 500, rng.rand(60, 4) * 500
    dt[:, 2:] += dt[:, :2] + 1
    gt[:, 2:] += gt[:, :2] + 1
    crowd = rng.rand(60) < 0.1
    got, want = _native.box_iou(dt, gt, crowd), _native.box_iou_plain(dt, gt, crowd)
    ulps = float(np.max(np.abs(got - want) / np.spacing(np.maximum(np.abs(want), np.finfo(float).tiny))))
    if ulps > 4:
        raise AssertionError(f"native: box_iou is {ulps} ulp off its plain version")
    ious = [np.round(rng.rand(d, g), 2) for d, g in rng.randint(0, 12, (40, 2))]
    args = (ious, [rng.rand(len(i)) for i in ious], [rng.rand(len(i)) * 1e4 for i in ious],
            [rng.rand(i.shape[1]) * 1e4 for i in ious], [(rng.rand(i.shape[1]) < 0.2).astype(np.uint8) for i in ious],
            np.array([0.0, 0.0, 1024.0, 9216.0]), np.array([1e10, 1024.0, 9216.0, 1e10]),
            np.linspace(0.5, 0.95, 10), 100)
    for a_cell, b_cell in zip(_native.coco_stage_match_batch(*args), _native.coco_stage_match_batch_plain(*args)):
        if not all(np.array_equal(a, b) for a, b in zip(a_cell, b_cell)):
            raise AssertionError("native: coco_stage_match_batch differs from its plain version")
    words = [[f"w{t}" for t in rng.randint(0, 8, rng.randint(0, 20))] for _ in range(64)]
    refs = [[f"w{t}" for t in rng.randint(0, 8, rng.randint(0, 20))] for _ in range(64)]
    if not np.array_equal(_native.edit_distance_counts_batch(words, refs),
                          _native.edit_distance_counts_batch_plain(words, refs)):
        raise AssertionError("native: edit_distance_counts_batch differs from its plain version")
    cost = rng.rand(30, 40)
    r, c = _native.linear_sum_assignment(cost)
    pr, pc = _native.linear_sum_assignment_plain(cost)
    if not (np.array_equal(r, pr) and np.array_equal(c, pc)):
        raise AssertionError("native: linear_sum_assignment differs from scipy's")
    return {"box_iou_max_ulps": ulps, "stage_match_cells": len(ious), "edit_pairs": len(words),
            "assignment": list(cost.shape)}


def run_a11b_paths(card: str, dev, images: int = 5000, segm_images: int = 500, panoptic_images: int = 500,
                   coco_check: int = 500) -> tuple:
    """The four A11.b paths; (records, bincount launches over them, the host
    library's calls and seconds per entry point over them)."""
    import torch

    from torchmetrics_tpu_torch import _native

    records, launches = [], 0
    with _timed_calls(tuple((_native, name) for name in NATIVE_ENTRY_POINTS)) as native:
        g = torch.Generator(device=dev).manual_seed(140)
        t0 = time.perf_counter()
        scene = _coco_scene(g, dev, images)
        _sync(dev)
        scene_s = time.perf_counter() - t0
        runs = ((run_coco_bbox, (scene,), {"check": coco_check}),
                (run_coco_iou_family, (scene,), {"check": coco_check}),
                (run_coco_segm, (), {"images": segm_images}),
                (run_cityscapes_panoptic, (), {"images": panoptic_images}))
        for run, args, kwargs in runs:
            t0 = time.perf_counter()
            record, n = run(card, dev, *args, **kwargs)
            record["seconds"] = time.perf_counter() - t0
            record["bincount_launches"] = n
            records.append(record)
            launches += n
        records[0]["scene_setup_s"] = scene_s
    calls = {name: {"calls": c, "seconds": s} for name, (c, s) in native.items() if c}
    return records, launches, calls


# ---------------------------------------------------------------------------
# A11.c: audio and the speech-recognition error rates
# ---------------------------------------------------------------------------

SEP_SI_SDR_DB = 1e-3  # PIT's SI-SDR against float64 on the card, dB
SEP_SDR_DB = 5e-3  # SDR against a float64 solve, dB (the JAX package's own bound)
SNR_CPU_RTOL = 1e-4  # the SNR family, SA-SDR and PIT against device="cpu" (the tests' bound)
SDR_CPU_DB = 1e-3  # SDR against device="cpu", dB (the tests' bound)
PESQ_MOS_ATOL = 1e-3  # PESQ against device="cpu" (the tests' bound)
PESQ_ANCHORS = {("nb", 8000): 2.2076, ("wb", 16000): 1.7359}  # the ITU executable's scores of the anchors
PESQ_ANCHOR_ATOL = 5e-3
STOI_CPU_ATOL = 1e-5
SRMR_CPU_RTOL = 1e-4
RT60_S = (0.25, 0.5, 0.7)  # the REVERB Challenge's small, medium and large rooms


def _speech_like(g, dev, lead: tuple, n: int, fs: int):
    """(*lead, n) float32 speech-like signals on ``dev``: voices of 100-250 Hz
    with 8 partials under a 2-5 Hz syllable envelope whose level is
    modulated by smoothed noise, gated by pauses of a 0.2-0.5 Hz gate."""
    import torch

    def u(*shape):
        return torch.rand(*lead, *shape, generator=g, device=dev)

    t = torch.arange(n, device=dev, dtype=torch.float32) / fs
    f0, phase = 100.0 + 150.0 * u(1), 2 * torch.pi * u(8)
    voice = torch.zeros(*lead, n, device=dev)
    for k in range(1, 9):
        voice += torch.sin(2 * torch.pi * k * f0 * t + phase[..., k - 1:k]) / k
    syllables = torch.clamp(torch.sin(2 * torch.pi * (2.0 + 3.0 * u(1)) * t + 2 * torch.pi * u(1)), min=0.0)
    gate = (torch.sin(2 * torch.pi * (0.2 + 0.3 * u(1)) * t + 2 * torch.pi * u(1)) > -0.2).float()
    noise = torch.randn(*lead, n, generator=g, device=dev).reshape(-1, 1, n)
    level = 1.0 + 2.0 * torch.nn.functional.avg_pool1d(noise, 401, stride=1, padding=200).reshape(*lead, n)
    hiss = torch.randn(*lead, n, generator=g, device=dev)
    return 0.3 * voice * syllables.sqrt() * gate * level.clamp(min=0.2) + 1e-4 * hiss


def _mixtures(g, dev, batch: int, spk: int, n: int, fs: int):
    """(estimates, references), each (batch, spk, n): every estimate is a
    reference of a random speaker order, with 10-30% of another speaker
    leaking in and white noise 10-25 dB down."""
    import torch

    target = _speech_like(g, dev, (batch, spk), n, fs)
    order = torch.argsort(torch.rand(batch, spk, generator=g, device=dev), dim=1)
    est = torch.take_along_dim(target, order[..., None], dim=1)
    leak = 0.1 + 0.2 * torch.rand(batch, spk, 1, generator=g, device=dev)
    est = est + leak * torch.roll(est, 1, dims=1)
    rms = est.square().mean(-1, keepdim=True).sqrt()
    snr = 10.0 + 15.0 * torch.rand(batch, spk, 1, generator=g, device=dev)
    return est + rms * 10 ** (-snr / 20) * torch.randn(est.shape, generator=g, device=dev), target


def _si_sdr64(preds, target):
    """SI-SDR in float64 (zero_mean=False), the JAX package's formula."""
    import torch

    p, t = preds.double(), target.double()
    eps = 1.1920929e-07
    alpha = ((p * t).sum(-1, keepdim=True) + eps) / (t.square().sum(-1, keepdim=True) + eps)
    ts = alpha * t
    return 10 * torch.log10((ts.square().sum(-1) + eps) / ((ts - p).square().sum(-1) + eps))


def _exhaustive64(preds, target):
    """(best mean SI-SDR, permutation) of each sample by an exhaustive float64 search."""
    from itertools import permutations

    import torch

    spk = target.shape[1]
    mat = _si_sdr64(preds[:, :, None, :].expand(-1, -1, spk, -1), target[:, None, :, :].expand(-1, spk, -1, -1))
    perms = torch.tensor(list(permutations(range(spk))), device=preds.device)
    per_perm = mat[:, torch.arange(spk, device=preds.device), perms].mean(-1)  # (B, P)
    best, idx = per_perm.max(-1)
    return best, perms[idx], per_perm


def _sdr64(preds, target, filter_length: int = 512):
    """SDR with a float64 Toeplitz solve (torch.linalg.solve), the JAX package's formula."""
    import torch

    from torchmetrics_tpu_torch.functional.audio import sdr as sdr_mod

    p, t = preds.double(), target.double()
    t = t / t.norm(dim=-1, keepdim=True).clamp(min=1e-6)
    p = p / p.norm(dim=-1, keepdim=True).clamp(min=1e-6)
    r_0, b = sdr_mod._compute_autocorr_crosscorr(t, p, filter_length)
    sol = torch.linalg.solve(sdr_mod._symmetric_toeplitz(r_0), b[..., None])[..., 0]
    coh = (b * sol).sum(-1)
    return 10 * torch.log10((coh / (1 - coh).clamp(min=1e-12)).clamp(min=1e-12))


def _mean_state(m) -> float:
    return float(m.sum_value) / float(m.total)


def _timed_update(dev, m, *args) -> float:
    _sync(dev)
    t0 = time.perf_counter()
    m.update(*args)
    _sync(dev)
    return (time.perf_counter() - t0) * 1e3


def run_wsj0_2mix(card: str, dev, mixtures: int = 3000, batch: int = 16, seconds: float = 4.0, fs: int = 8000,
                  check: int = 64, five_mixtures: int = 200, five_batch: int = 8) -> dict:
    """Path ``wsj0_2mix_separation``: two-speaker separation as WSJ0-2mix
    test scores it, ``mixtures`` seeded mixtures of ``seconds`` at ``fs``,
    ``batch`` an update: PIT(SI-SDR) speaker-wise and permutation-wise on
    the raw estimates, and SDR (512 taps), SA-SDR, SI-SNR and SNR on the
    ``pit_permutate``d ones, each by its default route (captured but SDR)
    and eagerly (jit=False): ms an update, host reads an update, captures,
    SDR's solve ms, peak MB. Checks: PIT's permutations equal an exhaustive
    float64 search and its SI-SDR within SEP_SI_SDR_DB of it on every
    update; SDR within SEP_SDR_DB of a float64 solve on the first ``check``
    mixtures; every state against device="cpu" there. Then a 5-speaker
    sub-phase (WSJ0-5mix): ``five_mixtures`` of ``five_batch``, speaker-wise
    through the host assignment (eager from its first update), permutations
    equal to scipy's on the same float64 matrices."""
    import torch

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch import _native
    from torchmetrics_tpu_torch.functional.audio import permutation_invariant_training, pit_permutate
    from torchmetrics_tpu_torch.functional.audio import pit as pit_mod
    from torchmetrics_tpu_torch.functional.audio import scale_invariant_signal_distortion_ratio as si_sdr
    from torchmetrics_tpu_torch.functional.audio import sdr as sdr_mod

    label = "wsj0_2mix_separation"
    n = int(seconds * fs)

    def metrics(device, jit=True):
        return {"pit_speaker_wise": tm.PermutationInvariantTraining(si_sdr, device=device, jit=jit),
                "pit_permutation_wise": tm.PermutationInvariantTraining(si_sdr, mode="permutation-wise",
                                                                        device=device, jit=jit),
                "sdr": tm.SignalDistortionRatio(filter_length=512, device=device, jit=jit),
                "sa_sdr": tm.SourceAggregatedSignalDistortionRatio(device=device, jit=jit),
                "si_snr": tm.ScaleInvariantSignalNoiseRatio(device=device, jit=jit),
                "snr": tm.SignalNoiseRatio(device=device, jit=jit)}

    routes = {"default": metrics(dev), "eager": metrics(dev, jit=False)}
    cpu = metrics("cpu")
    times = {r: {k: [] for k in routes[r]} for r in routes}
    reads, setup_s, pit_ms = {}, 0.0, []
    worst = {"si_sdr_db": 0.0, "sdr_db": 0.0}
    g = torch.Generator(device=dev).manual_seed(153)
    _zero_kernel_counts()
    _peak_reset(dev)
    for i, start in enumerate(range(0, mixtures, batch)):
        b = min(batch, mixtures - start)
        t0 = time.perf_counter()
        preds, target = _mixtures(g, dev, b, 2, n, fs)
        _sync(dev)
        setup_s += time.perf_counter() - t0
        _sync(dev)
        t0 = time.perf_counter()
        best, perm = permutation_invariant_training(preds, target, si_sdr)
        est = pit_permutate(preds, perm)
        _sync(dev)
        pit_ms.append((time.perf_counter() - t0) * 1e3)
        best64, perm64, _ = _exhaustive64(preds, target)
        if not torch.equal(perm, perm64):
            raise AssertionError(f"{label}: update {i}: PIT's permutations differ from the float64 search")
        worst["si_sdr_db"] = max(worst["si_sdr_db"], float((best.double() - best64).abs().max()))
        args = {"pit_speaker_wise": (preds, target), "pit_permutation_wise": (preds, target)}
        for route, ms in routes.items():
            for name, m in ms.items():
                a = args.get(name, (est, target))
                if i == 2 and route == "default" and dev.type == "cuda":
                    _, reads[name], _ = count_host_reads(lambda m=m, a=a: m.update(*a))
                    continue
                times[route][name].append(_timed_update(dev, m, *a))
        if start < check:
            worst["sdr_db"] = max(worst["sdr_db"], float(
                (sdr_mod.signal_distortion_ratio(est, target).double() - _sdr64(est, target)).abs().max()))
            for name, m in cpu.items():
                m.update(*(x.cpu() for x in args.get(name, (est, target))))
            if start + b >= check:
                for name, m in cpu.items():
                    got, want = _mean_state(routes["default"][name]), _mean_state(m)
                    tol = SDR_CPU_DB if name == "sdr" else SNR_CPU_RTOL * abs(want)
                    if not abs(got - want) <= tol or float(routes["default"][name].total) != float(m.total):
                        raise AssertionError(f"{label}: {name} {got} against {want} on the CPU")
    if worst["si_sdr_db"] > SEP_SI_SDR_DB or worst["sdr_db"] > SEP_SDR_DB:
        raise AssertionError(f"{label}: {worst} dB from float64 (limits {SEP_SI_SDR_DB}, {SEP_SDR_DB})")
    peak = _peak_mb(dev)
    values = {name: float(m.compute()) for name, m in routes["default"].items()}
    for name, m in routes["eager"].items():
        if abs(float(m.compute()) - values[name]) > 1e-5 * max(1.0, abs(values[name])):
            raise AssertionError(f"{label}: {name} eager {float(m.compute())} against {values[name]}")
    captures = {name: len(m._update_graphs) for name, m in routes["default"].items()}
    if dev.type == "cuda" and (captures["sdr"] or not all(v for k, v in captures.items() if k != "sdr")):
        raise AssertionError(f"{label}: captures {captures}: every update but SDR's should replay a graph")
    # SDR's solve alone: the (batch, 2) Toeplitz systems of 512 of a full update
    preds, target = _mixtures(g, dev, batch, 2, n, fs)
    r_0, rhs = sdr_mod._compute_autocorr_crosscorr(target, preds, 512)
    r = sdr_mod._symmetric_toeplitz(r_0)
    solve_ms = []
    for _ in range(5):
        _sync(dev)
        t0 = time.perf_counter()
        torch.linalg.solve_ex(r, rhs[..., None], check_errors=False)
        _sync(dev)
        solve_ms.append((time.perf_counter() - t0) * 1e3)

    # the 5-speaker sub-phase: speaker-wise through the host assignment
    five = tm.PermutationInvariantTraining(si_sdr, device=dev)
    five_ms, five_reads, mismatches = [], None, 0
    for i, start in enumerate(range(0, five_mixtures, five_batch)):
        preds, target = _mixtures(g, dev, min(five_batch, five_mixtures - start), 5, n, fs)
        matrix = pit_mod._pair_metric_matrix(preds, target, si_sdr).double().cpu().numpy()
        _, perm = permutation_invariant_training(preds, target, si_sdr)
        want = [_native.linear_sum_assignment_plain(-mat)[1] for mat in matrix]
        mismatches += int(sum(not (perm[k].cpu().numpy() == w).all() for k, w in enumerate(want)))
        if i == 1 and dev.type == "cuda":
            _, five_reads, _ = count_host_reads(lambda: five.update(preds, target))
            continue
        five_ms.append(_timed_update(dev, five, preds, target))
    if mismatches:
        raise AssertionError(f"{label}: {mismatches} 5-speaker permutations differ from scipy's assignment")
    if five._use_jit or five._update_graphs:
        raise AssertionError(f"{label}: the 5-speaker PIT should update eagerly by declaration")
    return {"phase": "a11c", "path": label, "mixtures": mixtures, "batch": batch, "samples": n, "fs": fs,
            "setup_s": setup_s,
            "ms_per_update": {r: {k: statistics.median(v) for k, v in t.items()} for r, t in times.items()},
            "pit_and_permutate_ms": statistics.median(pit_ms), "host_syncs_per_update": reads or None,
            "captures": captures, "sdr_solve_ms": statistics.median(solve_ms),
            "sdr_systems": [*r.shape[:-2], 512], "peak_mb": peak, "values": values,
            "worst_db_from_float64": worst, "cpu_check_mixtures": check,
            "five_speakers": {"mixtures": five_mixtures, "batch": five_batch,
                              "ms_per_update": statistics.median(five_ms), "host_syncs_per_update": five_reads,
                              "value": float(five.compute()), "permutations_equal_scipy": True},
            "card": card}


def _degraded(g, dev, clean, fs: int, jump_every: int = 5, first: int = 0):
    """``clean`` (B, n) delayed by 1-8 ms plus white noise at -5 to 20 dB
    SNR; every ``jump_every``-th clip (by index from ``first``) is delayed
    20 ms more from mid-clip and carries a 150 ms transient 20 dB above the
    speech at 40% of the clip (PESQ's bad intervals: the second pass)."""
    import torch

    out = torch.zeros_like(clean)
    n = clean.shape[-1]
    rms = clean.square().mean(-1, keepdim=True).sqrt()
    delays = (1 + 7 * torch.rand(len(clean), generator=g, device=dev)).mul(fs / 1000).long().tolist()
    burst = slice(int(0.4 * n), int(0.4 * n) + int(0.150 * fs))
    for k, d in enumerate(delays):
        out[k, d:] = clean[k, :n - d]
        if (first + k) % jump_every == jump_every - 1:
            half, d1 = n // 2, d + int(0.020 * fs)
            out[k, half:] = clean[k, half - d1:n - d1]
            out[k, burst] += 10.0 * rms[k] * torch.randn(burst.stop - burst.start, generator=g, device=dev)
    snr = -5.0 + 25.0 * torch.rand(len(clean), 1, generator=g, device=dev)
    return out + rms * 10 ** (-snr / 20) * torch.randn(clean.shape, generator=g, device=dev)


def run_dns_enhancement(card: str, dev, clips: int = 150, batch: int = 10, seconds: float = 10.0,
                        fs: int = 16000, check: int = 8) -> dict:
    """Path ``dns_enhancement``: the DNS Challenge's synthetic no-reverb test
    set as it is scored: ``clips`` seeded clips of ``seconds`` at ``fs``,
    ``batch`` an update, the degraded ones noisy (-5 to 20 dB), delayed and
    every fifth with a delay jump mid-clip: PESQ wb and nb, STOI, extended
    STOI, SI-SDR and SNR: ms a clip per metric, PESQ's host part (input
    filter, alignment, bad-interval search) apart from the rest, its model
    passes and second passes, host reads an update, peak MB. Checks: PESQ's
    decisions on the first ``check`` clips equal a device="cpu" run's and
    its MOS within PESQ_MOS_ATOL; the two ITU anchors on the card; STOI and
    extended STOI there within STOI_CPU_ATOL of the CPU."""
    import numpy as np
    import torch

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.functional.audio import pesq as pesq_mod
    from torchmetrics_tpu_torch.functional.audio import short_time_objective_intelligibility as stoi

    label = "dns_enhancement"
    n = int(seconds * fs)
    metrics = {"pesq_wb": tm.PerceptualEvaluationSpeechQuality(fs, "wb", implementation="native", device=dev),
               "pesq_nb": tm.PerceptualEvaluationSpeechQuality(fs, "nb", implementation="native", device=dev),
               "stoi": tm.ShortTimeObjectiveIntelligibility(fs, device=dev),
               "estoi": tm.ShortTimeObjectiveIntelligibility(fs, extended=True, device=dev),
               "si_sdr": tm.ScaleInvariantSignalDistortionRatio(device=dev),
               "snr": tm.SignalNoiseRatio(device=dev)}
    times = {k: [] for k in metrics}
    reads, setup_s = {}, 0.0
    passes, calls = [], []
    real_pass, real_batch = pesq_mod._model_pass, pesq_mod._pesq_batch

    def counted_pass(ref, deg, fs_):
        passes.append(ref.shape[0])
        return real_pass(ref, deg, fs_)

    def counted_batch(*args):
        calls.append(1)
        return real_batch(*args)

    g = torch.Generator(device=dev).manual_seed(154)
    _zero_kernel_counts()
    _peak_reset(dev)
    first = None
    pesq_mod._model_pass, pesq_mod._pesq_batch = counted_pass, counted_batch
    try:
        with _timed_calls(((pesq_mod, "_host_alignment"), (pesq_mod, "_realign_bad"))) as host:
            for i, start in enumerate(range(0, clips, batch)):
                t0 = time.perf_counter()
                clean = _speech_like(g, dev, (min(batch, clips - start),), n, fs)
                deg = _degraded(g, dev, clean, fs, first=start)
                _sync(dev)
                setup_s += time.perf_counter() - t0
                if first is None:
                    first = (deg[:check].clone(), clean[:check].clone())
                for name, m in metrics.items():
                    if i == 1 and dev.type == "cuda":
                        _, reads[name], _ = count_host_reads(lambda m=m: m.update(deg, clean))
                        continue
                    times[name].append(_timed_update(dev, m, deg, clean) / len(clean))
            host_s = {k: v[1] for k, v in host.items()}
    finally:
        pesq_mod._model_pass, pesq_mod._pesq_batch = real_pass, real_batch
    peak = _peak_mb(dev)
    values = {name: float(m.compute()) for name, m in metrics.items()}
    second_passes = len(passes) - len(calls)
    if not second_passes:
        raise AssertionError(f"{label}: no PESQ update ran its second pass")

    # checks on the first clips: PESQ's decisions and MOS, STOI, against the CPU
    deg, clean = first
    ref_np, deg_np = clean.cpu().numpy(), deg.cpu().numpy()
    pesq_check = {}
    for mode in ("wb", "nb"):
        s_card, rec_card = pesq_mod._pesq_batch(ref_np, deg_np, fs, mode, dev)
        s_cpu, rec_cpu = pesq_mod._pesq_batch(ref_np, deg_np, fs, mode, torch.device("cpu"))
        for key in ("regions", "bad", "second_pass"):
            if rec_card[key] != rec_cpu[key]:
                raise AssertionError(f"{label}: PESQ {mode} {key} differ between the card and the CPU")
        if not np.array_equal(rec_card["active"], rec_cpu["active"]):
            raise AssertionError(f"{label}: PESQ {mode} active frames differ between the card and the CPU")
        mos = [[pesq_mod._calibrated_mos(float(v), mode) for v in s.cpu().tolist()] for s in (s_card, s_cpu)]
        err = float(np.max(np.abs(np.subtract(*mos))))
        if err > PESQ_MOS_ATOL:
            raise AssertionError(f"{label}: PESQ {mode} MOS {err} from the CPU run")
        pesq_check[mode] = {"mos_max_abs_err": err, "bad_intervals": sum(map(len, rec_card["bad"])),
                            "second_pass": rec_card["second_pass"]}
    anchors = {}
    for (mode, afs), want in PESQ_ANCHORS.items():
        torch.manual_seed(1)
        a_preds, a_target = torch.randn(8000).to(dev), torch.randn(8000).to(dev)
        got = float(tm.functional.audio.perceptual_evaluation_speech_quality(a_preds, a_target, afs, mode,
                                                                             implementation="native"))
        if abs(got - want) > PESQ_ANCHOR_ATOL:
            raise AssertionError(f"{label}: ITU anchor {mode} {afs}: {got} against {want}")
        anchors[f"{mode}_{afs}"] = got
    stoi_err = {}
    for extended in (False, True):
        got = stoi(deg, clean, fs, extended)
        want = stoi(deg.cpu(), clean.cpu(), fs, extended)
        stoi_err["estoi" if extended else "stoi"] = err = float((got.cpu() - want).abs().max())
        if err > STOI_CPU_ATOL:
            raise AssertionError(f"{label}: STOI (extended={extended}) {err} from the CPU run")
    pesq_clip_ms = {k: statistics.median(times[k]) for k in ("pesq_wb", "pesq_nb")}
    return {"phase": "a11c", "path": label, "clips": clips, "batch": batch, "samples": n, "fs": fs,
            "setup_s": setup_s, "ms_per_clip": {k: statistics.median(v) for k, v in times.items()},
            "pesq_host_s": host_s, "pesq_host_ms_per_clip": {
                "alignment": host_s["_host_alignment"] * 1e3 / (2 * clips),
                "bad_interval_search": host_s["_realign_bad"] * 1e3 / (2 * clips)},
            "pesq_rest_ms_per_clip": {  # the model passes on the card, the copies and the aggregation
                k: statistics.median(times[k]) - sum(host_s.values()) * 1e3 / (2 * clips) for k in pesq_clip_ms},
            "pesq_model_passes": len(passes), "pesq_second_passes": second_passes,
            "pesq_second_pass_samples": sum(passes) - clips * 2,
            "pesq_clip_ms_both_modes": sum(pesq_clip_ms.values()),
            "host_syncs_per_update": reads or None, "peak_mb": peak, "values": values,
            "checks": {"pesq_first_clips": pesq_check, "itu_anchors_on_card": anchors,
                       "stoi_max_abs_err_cpu": stoi_err, "clips": check},
            "card": card}


def _reverberant(g, dev, clean, fs: int, first: int = 0):
    """``clean`` (B, n) convolved with exponentially decaying noise impulse
    responses of RT60 0.25, 0.5 and 0.7 s in turn (by clip index from
    ``first``), a unit direct path, the convolution by FFT."""
    import torch

    b, n = clean.shape
    length = int(max(RT60_S) * fs)
    t = torch.arange(length, device=dev, dtype=torch.float32) / fs
    rt60 = torch.tensor([RT60_S[(first + k) % len(RT60_S)] for k in range(b)], device=dev)[:, None]
    ir = torch.randn(b, length, generator=g, device=dev) * torch.exp(-6.9078 * t / rt60) * 0.1
    ir[:, 0] = 1.0
    size = 1 << (n + length - 1).bit_length()
    return torch.fft.irfft(torch.fft.rfft(clean, size) * torch.fft.rfft(ir, size), size)[:, :n].contiguous()


def run_reverb_srmr(card: str, dev, clips: int = 200, batch: int = 8, seconds: float = 8.0, fs: int = 16000,
                    check: int = 8) -> dict:
    """Path ``reverb_srmr``: SRMR as the REVERB Challenge scores
    dereverberated speech: ``clips`` seeded reverberant clips of ``seconds``
    at ``fs`` (RT60 0.25, 0.5, 0.7 s), ``batch`` an update, at the defaults,
    with norm=True and with fast=True: ms an update and peak MB of each;
    every peak must stay under the (B, C, M, S, W) frames the JAX package
    builds and the port does not. Checks the first ``check``
    clips against device="cpu" within SRMR_CPU_RTOL with k* equal."""
    import torch

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.functional.audio import srmr as srmr_mod

    label = "reverb_srmr"
    n = int(seconds * fs)
    configs = {"default": {}, "norm": {"norm": True}, "fast": {"fast": True}}
    metrics = {k: tm.SpeechReverberationModulationEnergyRatio(fs, **kw, device=dev) for k, kw in configs.items()}
    times = {k: [] for k in configs}
    peaks = {k: 0.0 for k in configs}
    setup_s, first = 0.0, None
    g = torch.Generator(device=dev).manual_seed(155)
    _zero_kernel_counts()
    for start in range(0, clips, batch):
        t0 = time.perf_counter()
        sig = _reverberant(g, dev, _speech_like(g, dev, (min(batch, clips - start),), n, fs), fs, first=start)
        _sync(dev)
        setup_s += time.perf_counter() - t0
        if first is None:
            first = sig[:check].clone()
        for name, m in metrics.items():
            _peak_reset(dev)
            base = torch.cuda.memory_allocated() / 2**20 if dev.type == "cuda" else 0.0
            times[name].append(_timed_update(dev, m, sig))
            peak = _peak_mb(dev)
            peaks[name] = max(peaks[name], (peak or 0.0) - base)
    values = {name: float(m.compute()) for name, m in metrics.items()}
    win, hop = int(0.256 * fs), int(0.064 * fs)
    frames_mb = batch * 23 * 8 * ((n - win) // hop + 1) * win * 4 / 2**20
    if dev.type == "cuda" and not max(peaks.values()) < frames_mb:
        raise AssertionError(f"{label}: peak {peaks} MB: the framed energies seem to build the frames")
    checks = {}
    for name, kw in configs.items():
        max_cf = 30.0 if kw.get("norm") else 128.0
        args = (fs, 23, 125.0, 4.0, max_cf, kw.get("norm", False), kw.get("fast", False))
        s_card, rec_card = srmr_mod._srmr_batch(first, *args)
        s_cpu, rec_cpu = srmr_mod._srmr_batch(first.cpu(), *args)
        err = float(((s_card.cpu() - s_cpu).abs() / s_cpu.abs()).max())
        if err > SRMR_CPU_RTOL or not torch.equal(rec_card["kstar"].cpu(), rec_cpu["kstar"]):
            raise AssertionError(f"{label}: {name}: {err} from the CPU run, k* {rec_card['kstar'].tolist()} "
                                 f"against {rec_cpu['kstar'].tolist()}")
        perc = rec_cpu["perc_cum"]
        margin = float((perc - 90.0).abs().min())
        checks[name] = {"max_rel_err": err, "kstar": rec_card["kstar"].tolist(), "perc_cum_min_gap_to_90": margin}
    return {"phase": "a11c", "path": label, "clips": clips, "batch": batch, "samples": n, "fs": fs,
            "rt60_s": list(RT60_S), "setup_s": setup_s,
            "ms_per_update": {k: statistics.median(v) for k, v in times.items()},
            "peak_mb_over_inputs": peaks, "frames_not_built_mb": frames_mb,
            "values": values, "checks_first_clips": checks, "card": card}


def _librispeech_like(utterances: int, words: int, vocab: int, seed: int = 156) -> tuple:
    """(hypotheses, references): ``utterances`` references of ``words``
    words in all over a ``vocab``-word vocabulary of Zipf frequencies, and
    hypotheses with about 5% substitutions, 5% deletions and 5% insertions."""
    import numpy as np

    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz'"))
    vocabulary = np.array(["".join(rng.choice(letters, k)) for k in rng.randint(2, 11, vocab)])
    lengths = np.maximum(1, np.round(rng.gamma(2.5, 8.0, utterances) * words / (2.5 * 8.0 * utterances))).astype(int)
    while lengths.sum() != words:
        k = rng.randint(utterances)
        lengths[k] = max(1, lengths[k] + (1 if lengths.sum() < words else -1))
    p = 1.0 / np.arange(1, vocab + 1)
    ids = rng.choice(vocab, words, p=p / p.sum())
    refs, hyps, pos = [], [], 0
    for length in lengths:
        ref = vocabulary[ids[pos:pos + length]]
        pos += length
        r = rng.rand(length)  # below 0.05 a substitution, from 0.05 to 0.10 a deletion
        hyp = list(np.where(r < 0.05, vocabulary[rng.randint(0, vocab, length)], ref)[(r < 0.05) | (r >= 0.10)])
        inserts = rng.rand(len(hyp)) < 0.05
        for k in np.flatnonzero(inserts)[::-1]:
            hyp.insert(k + 1, vocabulary[rng.randint(vocab)])
        refs.append(" ".join(ref))
        hyps.append(" ".join(hyp))
    return hyps, refs


def run_librispeech_wer(card: str, dev, utterances: int = 2620, words: int = 52_576, vocab: int = 20_000,
                        batch: int = 32, check: int = 200) -> dict:
    """Path ``librispeech_wer``: WER, CER, MER, WIL and WIP over
    LibriSpeech test-clean's 2,620 utterances and 52,576 reference words
    (seeded over a 20,000-word vocabulary, about 5% substitutions,
    deletions and insertions), ``batch`` utterances an update: ms an
    update, split between the host library's call and the rest. Checks the
    states after the first ``check`` utterances bitwise against device="cpu"
    and against the plain Levenshtein counts
    (edit_distance_counts_batch_plain)."""
    import numpy as np
    import torch

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch import _native

    label = "librispeech_wer"
    t0 = time.perf_counter()
    hyps, refs = _librispeech_like(utterances, words, vocab)
    setup_s = time.perf_counter() - t0
    names = ("WordErrorRate", "CharErrorRate", "MatchErrorRate", "WordInfoLost", "WordInfoPreserved")
    _zero_kernel_counts()

    def drive(device, count):
        ms = {name: getattr(tm, name)(device=device) for name in names}
        times = {name: [] for name in names}
        for start in range(0, count, batch):
            stop = min(start + batch, count)
            for name, m in ms.items():
                times[name].append(_timed_update(dev, m, hyps[start:stop], refs[start:stop]))
        return ms, times

    with _timed_calls(((_native, "edit_distance_batch"),)) as native:
        metrics, times = drive(dev, utterances)
    native_calls, native_s = native["edit_distance_batch"]
    updates = len(times["WordErrorRate"])
    if native_calls != len(names) * updates:
        raise AssertionError(f"{label}: {native_calls} library calls over {updates} updates of {len(names)} metrics")
    values = {name: float(m.compute()) for name, m in metrics.items()}
    # the first utterances: card against the CPU and against the plain counts, bitwise
    card_m, _ = drive(dev, check)
    cpu_m, _ = drive("cpu", check)
    words_h, words_r = [h.split() for h in hyps[:check]], [r.split() for r in refs[:check]]
    wc = _native.edit_distance_counts_batch_plain(words_h, words_r)
    cc = _native.edit_distance_counts_batch_plain([list(h) for h in hyps[:check]], [list(r) for r in refs[:check]])
    w_err, c_err = int(wc[:, :3].sum()), int(cc[:, :3].sum())
    longest = sum(max(len(a), len(b)) for a, b in zip(words_h, words_r))
    n_ref, n_hyp = sum(map(len, words_r)), sum(map(len, words_h))
    want = {"WordErrorRate": {"errors": w_err, "total": n_ref},
            "CharErrorRate": {"errors": c_err, "total": sum(map(len, refs[:check]))},
            "MatchErrorRate": {"errors": w_err, "total": longest},
            "WordInfoLost": {"errors": w_err - longest, "target_total": n_ref, "preds_total": n_hyp},
            "WordInfoPreserved": {"errors": w_err - longest, "target_total": n_ref, "preds_total": n_hyp}}
    for name, states in want.items():
        for state, value in states.items():
            a, b = getattr(card_m[name], state).cpu(), getattr(cpu_m[name], state)
            if a.dtype != torch.float32 or not torch.equal(a, b) or not torch.equal(b, torch.tensor(float(value))):
                raise AssertionError(f"{label}: {name}.{state}: card {a}, cpu {b}, plain counts {value}")
    total_ms = sum(sum(t) for t in times.values())
    return {"phase": "a11c", "path": label, "utterances": utterances, "reference_words": words, "vocabulary": vocab,
            "batch": batch, "updates": updates, "setup_s": setup_s,
            "ms_per_update": {k: statistics.median(v) for k, v in times.items()},
            "library_ms_per_update": native_s * 1e3 / native_calls, "rest_ms_per_update":
                (total_ms - native_s * 1e3) / native_calls,
            "word_edits": int(np.sum(_native.edit_distance_batch([h.split() for h in hyps],
                                                                 [r.split() for r in refs]))),
            "values": values, "states_bitwise": {"utterances": check, "against": ["device='cpu'", "plain counts"]},
            "card": card}


def run_a11c_paths(card: str, dev) -> tuple:
    """The four A11.c paths; (records, bincount launches over them, which must be none)."""
    records = []
    for run in (run_wsj0_2mix, run_dns_enhancement, run_reverb_srmr, run_librispeech_wer):
        t0 = time.perf_counter()
        record = run(card, dev)
        record["seconds"] = time.perf_counter() - t0
        record["kernel_launches"] = _kernel_counts()
        records.append(record)
    launches = sum(r["kernel_launches"]["weighted_bincount"] for r in records)
    if launches or any(r["kernel_launches"]["tdigest_compress"] for r in records):
        raise AssertionError(f"a11c: the audio and speech-recognition paths launched a kernel: "
                             f"{[r['kernel_launches'] for r in records]}")
    return records, launches


# ---------------------------------------------------------------------------
# phase a11d: text and multimodal (no kernel on the path)
# ---------------------------------------------------------------------------

A11D_RTOL = 1e-5  # float32 scores and measures against float64 of the same inputs


def _word_id(word: str, vocab: int, first: int = 3) -> int:
    """A word's id in a stand-in vocabulary: a CRC of its text (Python's str
    hash changes between processes)."""
    import zlib

    return first + zlib.crc32(word.encode()) % (vocab - first)


def _zipf_pool(rng, words, n: int):
    """An endless iterator of words drawn with Zipf frequencies, ``n`` at a
    time in one vectorised draw."""
    import numpy as np

    p = 1.0 / np.arange(1, len(words) + 1)
    p /= p.sum()
    while True:
        yield from (str(w) for w in words[rng.choice(len(words), n, p=p)])


def _wmt14_like(segments: int = 3003, vocab: int = 40_000, seed: int = 161) -> tuple:
    """(hypotheses, references): newstest2014-like segments of 10-60 words
    over a ``vocab``-word Zipf vocabulary (some capitalised words, numbers,
    hyphens, commas, a full stop at the end), hypotheses with about 20% of
    the words substituted, a shifted span in a third of them, and about 3%
    deletions and insertions."""
    import numpy as np

    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = ["".join(rng.choice(letters, k)) for k in rng.randint(2, 12, vocab)]
    for i in rng.choice(vocab, vocab // 10, replace=False):
        words[i] = words[i].capitalize()
    for i in rng.choice(vocab, vocab // 50, replace=False):
        words[i] = str(rng.randint(1, 10_000)) if rng.rand() < 0.5 else words[i] + "-" + words[(i + 1) % vocab]
    words = np.array(words)
    draw = _zipf_pool(rng, words, segments * 80)
    hyps, refs = [], []
    for length in rng.randint(10, 61, segments):
        ref = [next(draw) for _ in range(length)]
        hyp = [next(draw) if r < 0.2 else w for w, r in zip(ref, rng.rand(length))]
        if rng.rand() < 1 / 3:
            span = rng.randint(2, 7)
            start = rng.randint(0, len(hyp) - span)
            moved, rest = hyp[start:start + span], hyp[:start] + hyp[start + span:]
            dest = rng.randint(0, len(rest) + 1)
            hyp = rest[:dest] + moved + rest[dest:]
        hyp = [w for w in hyp if rng.rand() >= 0.03]
        for k in np.flatnonzero(rng.rand(len(hyp)) < 0.03)[::-1]:
            hyp.insert(k + 1, next(draw))
        for seq in (ref, hyp):
            for k in np.flatnonzero(rng.rand(len(seq)) < 0.06):
                seq[k] = seq[k] + ","
        refs.append(" ".join(ref) + ".")
        hyps.append(" ".join(hyp) + ".")
    return hyps, refs


def _states_of(metric) -> dict:
    """Every state of a metric as a CPU tensor (cat states concatenated)."""
    import torch

    from torchmetrics_tpu_torch.utils.data import dim_zero_cat

    out = {}
    for name in metric._defaults:
        value = getattr(metric, name)
        if not isinstance(value, torch.Tensor):
            value = dim_zero_cat(value) if len(value) else torch.zeros(0)
        out[name] = value.detach().cpu().clone()
    return out


def _states_bitwise(label: str, card: dict, cpu: dict) -> int:
    import torch

    for name, want in cpu.items():
        got = card[name]
        if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{label}: state {name} differs between the card and device='cpu'")
    return len(cpu)


def _drive_host_metrics(makers: dict, hyps, refs, dev, batch: int, check: int, shape_target) -> tuple:
    """Each metric over all the segments on ``dev``, ``batch`` an update:
    ({name: metric}, {name: [ms of each update]}); the states after the
    first ``check`` segments must equal bitwise those of a device="cpu" run
    over them."""
    metrics = {name: make(dev) for name, make in makers.items()}
    times = {name: [] for name in makers}
    snapshots = {}
    for start in range(0, len(hyps), batch):
        h, r = hyps[start:start + batch], shape_target(refs[start:start + batch])
        for name, m in metrics.items():
            times[name].append(_timed_update(dev, m, h, r))
        if start + batch == check:
            snapshots = {name: _states_of(m) for name, m in metrics.items()}
    for name, make in makers.items():
        cpu = make("cpu")
        for start in range(0, check, batch):
            cpu.update(hyps[start:start + batch], shape_target(refs[start:start + batch]))
        _states_bitwise(f"{name} (first {check})", snapshots[name], _states_of(cpu))
    return metrics, times


def _f64_bleu(st: dict, n_gram: int = 4) -> float:
    import math

    num, den = st["numerator"].double().tolist(), st["denominator"].double().tolist()
    if min(num) == 0:
        return 0.0
    log_prec = sum(math.log(n / max(d, 1.0)) / n_gram for n, d in zip(num, den))
    ratio = float(st["preds_len"]) / max(float(st["target_len"]), 1.0)
    brevity = 1.0 if ratio > 1.0 else math.exp(1.0 - 1.0 / max(ratio, 1e-9))
    return brevity * math.exp(log_prec)


def _f64_chrf(st: dict, beta: float = 2.0) -> float:
    m, p, r = (st[k].double() for k in ("matching", "pred_total", "ref_total"))
    prec = (m / p.clamp(min=1.0)).where(p > 0, 0.0)
    rec = (m / r.clamp(min=1.0)).where(r > 0, 0.0)
    return float(((1 + beta**2) * prec * rec / (beta**2 * prec + rec).clamp(min=1e-16)).mean())


def run_wmt14_translation(card: str, dev, segments: int = 3003, vocab: int = 40_000, batch: int = 64,
                          check: int = 512, eed_segments: int = 256, eed_check: int = 64) -> dict:
    """Path ``wmt14_translation``: BLEU (4-gram), SacreBLEU (13a), chrF and
    chrF++, TER, EED and the character EditDistance over newstest2014 en-de's
    3,003 seeded segments (``_wmt14_like``), ``batch`` an update: ms an
    update per metric. EED runs over the first ``eed_segments`` (its
    character DP is the slowest host code: a cut of depth). Checks each
    metric's states after the first ``check`` segments (``eed_check`` for
    EED) bitwise against device="cpu", and the corpus scores against a
    float64 formula over the states."""
    import numpy as np

    import torchmetrics_tpu_torch as tm

    label = "wmt14_translation"
    t0 = time.perf_counter()
    hyps, refs = _wmt14_like(segments, vocab)
    setup_s = time.perf_counter() - t0
    _zero_kernel_counts()
    listed = lambda rs: [[r] for r in rs]  # noqa: E731  (one reference a segment, as a list)
    plain = lambda rs: list(rs)  # noqa: E731
    makers = {
        "BLEUScore": lambda d: tm.BLEUScore(n_gram=4, device=d),
        "SacreBLEUScore": lambda d: tm.SacreBLEUScore(tokenize="13a", device=d),
        "CHRFScore_chrF": lambda d: tm.CHRFScore(n_word_order=0, device=d),
        "CHRFScore_chrF++": lambda d: tm.CHRFScore(n_word_order=2, device=d),
        "TranslationEditRate": lambda d: tm.TranslationEditRate(device=d),
    }
    metrics, times = _drive_host_metrics(makers, hyps, refs, dev, batch, check, listed)
    edit_metrics, edit_times = _drive_host_metrics(
        {"EditDistance": lambda d: tm.EditDistance(device=d)}, hyps, refs, dev, batch, check, plain)
    eed_metrics, eed_times = _drive_host_metrics(
        {"ExtendedEditDistance": lambda d: tm.ExtendedEditDistance(device=d)}, hyps[:eed_segments],
        refs[:eed_segments], dev, batch, eed_check, listed)
    metrics.update(edit_metrics)
    metrics.update(eed_metrics)
    times.update(edit_times)
    times.update(eed_times)
    values = {name: float(m.compute()) for name, m in metrics.items()}
    states = {name: _states_of(m) for name, m in metrics.items()}
    want = {
        "BLEUScore": _f64_bleu(states["BLEUScore"]),
        "SacreBLEUScore": _f64_bleu(states["SacreBLEUScore"]),
        "CHRFScore_chrF": _f64_chrf(states["CHRFScore_chrF"]),
        "CHRFScore_chrF++": _f64_chrf(states["CHRFScore_chrF++"]),
        "TranslationEditRate": float(states["TranslationEditRate"]["total_num_edits"].double()
                                     / states["TranslationEditRate"]["total_tgt_length"].double()),
        "EditDistance": float(states["EditDistance"]["edit_scores_list"].double().mean()),
        "ExtendedEditDistance": float(states["ExtendedEditDistance"]["sentence_eed"].double().mean()),
    }
    errors = {name: _hold_f64(label, name, values[name], want[name], A11D_RTOL) for name in want}
    return {"phase": "a11d", "path": label, "segments": segments, "vocabulary": vocab, "batch": batch,
            "eed_segments": eed_segments, "reduced": f"EED over the first {eed_segments} of {segments} segments",
            "setup_s": setup_s, "ms_per_update": {k: statistics.median(v) for k, v in times.items()},
            "s_total": {k: sum(v) / 1e3 for k, v in times.items()},
            "ms_per_segment": {k: sum(v) / (eed_segments if k == "ExtendedEditDistance" else segments)
                               for k, v in times.items()},
            "values": values, "value_err_f64": errors,
            "states_bitwise": {"segments": check, "eed_segments": eed_check, "against": "device='cpu'"},
            "reference_words": int(np.sum([len(r.split()) for r in refs])), "card": card}


class _TimedEncoder:
    """A stand-in encoder as ``user_forward_fn``: no grad, and the seconds of
    its forwards (between two synchronisations) counted."""

    def __init__(self, module, dev):
        self.module, self.dev, self.seconds, self.calls = module, dev, 0.0, 0

    def __call__(self, input_ids, attention_mask):
        import torch

        _sync(self.dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            out = self.module(input_ids, attention_mask)
        _sync(self.dev)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out


def _hf_init(module):
    """Weights drawn as ``transformers`` initialises BERT-style models
    (``initializer_range`` 0.02): linear and embedding weights normal with
    std 0.02, biases zero, LayerNorms one and zero. torch's defaults (an
    embedding of unit variance) give a masked LM logits of std ~28, whose
    temperature-0.25 softmax is one-hot to float32 noise."""
    from torch import nn

    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding, nn.Conv2d)):
            nn.init.normal_(m.weight, std=0.02)
            if getattr(m, "bias", None) is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    return module


def _text_encoder(vocab: int, width: int, layers: int, heads: int, ffn: int, positions: int, lm_head: bool):
    """A stand-in transformer encoder built from ``torch.nn`` at a published
    width: token and position embeddings, a LayerNorm, ``layers`` post-norm
    GELU encoder layers; the last hidden state, or with ``lm_head`` a masked
    LM head (dense, GELU, LayerNorm, the embedding's transpose and a bias)
    giving (B, L, vocab) logits. Seeded random weights; not a trained model."""
    import torch
    from torch import nn

    class Encoder(nn.Module):
        def __init__(self):
            super().__init__()
            self.tokens = nn.Embedding(vocab, width)
            self.positions = nn.Embedding(positions, width)
            self.norm = nn.LayerNorm(width)
            layer = nn.TransformerEncoderLayer(width, heads, ffn, dropout=0.0, activation="gelu", batch_first=True)
            self.encoder = nn.TransformerEncoder(layer, layers, enable_nested_tensor=False)
            if lm_head:
                self.dense, self.head_norm = nn.Linear(width, width), nn.LayerNorm(width)
                self.bias = nn.Parameter(torch.zeros(vocab))

        def forward(self, input_ids, attention_mask):
            pos = torch.arange(input_ids.shape[1], device=input_ids.device)
            x = self.norm(self.tokens(input_ids) + self.positions(pos)[None])
            x = self.encoder(x, src_key_padding_mask=attention_mask == 0)
            if not lm_head:
                return x
            h = self.head_norm(torch.nn.functional.gelu(self.dense(x)))
            return h @ self.tokens.weight.T + self.bias

    return _hf_init(Encoder()).eval()


def _hash_tokenizer(vocab: int, bos: int, eos: int, pad: int, max_positions: int):
    """``user_tokenizer``: words to stand-in ids between BOS and EOS, padded
    to the longest sentence, int64 CPU tensors (the metric moves them)."""
    import torch

    def tokenize(texts, max_length=None):
        limit = min(max_length or max_positions, max_positions)
        rows = [[bos] + [_word_id(w, vocab, 5) for w in t.split()][:limit - 2] + [eos] for t in texts]
        width = max(map(len, rows))
        ids = torch.full((len(rows), width), pad, dtype=torch.int64)
        mask = torch.zeros((len(rows), width), dtype=torch.int64)
        for i, row in enumerate(rows):
            ids[i, :len(row)] = torch.tensor(row)
            mask[i, :len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}

    return tokenize


def _f64_bert(pe, pm, te, tm) -> dict:
    """BERTScore's matching in float64 (no IDF)."""
    p = pe.double() / pe.double().norm(dim=-1, keepdim=True).clamp(min=1e-12)
    t = te.double() / te.double().norm(dim=-1, keepdim=True).clamp(min=1e-12)
    pmf, tmf = pm.double(), tm.double()
    sim = p @ t.transpose(1, 2) - 2 * (1 - pmf[:, :, None]) - 2 * (1 - tmf[:, None, :])
    prec = (sim.amax(2) * pmf).sum(1) / pmf.sum(1)
    rec = (sim.amax(1) * tmf).sum(1) / tmf.sum(1)
    return {"precision": prec, "recall": rec, "f1": 2 * prec * rec / (prec + rec)}


def _f64_infolm(logits_p, mask_p, logits_t, mask_t, temperature: float, measure: str):
    import torch

    def dist(logits, mask):
        probs = torch.softmax(logits.double() / temperature, dim=-1)
        w = mask.double()
        return (probs * w[:, :, None]).sum(1) / w.sum(1, keepdim=True)

    p, q = dist(logits_p, mask_p), dist(logits_t, mask_t)
    if measure == "kl_divergence":
        return (p * (torch.log(p + 1e-12) - torch.log(q + 1e-12))).sum(-1)
    return 2.0 * torch.arccos(torch.sqrt(p * q).sum(-1).clamp(0.0, 1.0))


def _max_rel(got, want) -> float:
    return float(((got.double().cpu() - want.double().cpu()).abs() / want.double().cpu().abs().clamp(min=1.0)).max())


def run_wmt14_bertscore_infolm(card: str, dev, segments: int = 3003, batch: int = 64, cpu_pairs: int = 8) -> dict:
    """Path ``wmt14_bertscore_infolm``: BERTScore (idf off and on) through a
    stand-in encoder at roberta-large's widths (24 layers, 1,024 wide, 16
    heads, FFN 4,096, vocabulary 50,265, 514 positions) and InfoLM (KL and
    Fisher-Rao, temperature 0.25) through a stand-in masked LM at
    bert-base-uncased's (12 layers, 768, 12 heads, vocabulary 30,522), both
    as ``user_forward_fn`` with a word-hash ``user_tokenizer``, over the
    3,003 WMT14 pairs, ``batch`` sentences a chunk. Compute s split into the
    encoder and the rest (tokenizing, matching or measure), peak MB. Checks
    the first chunk's matching and measures against float64 on the card of
    the same embeddings and logits, the target-chunked matching against the
    dense one, and one chunk of ``cpu_pairs`` pairs against device="cpu"
    (the stand-ins copied to the CPU)."""
    import copy

    import torch

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.functional.text import bert as bert_mod

    infolm_mod = sys.modules["torchmetrics_tpu_torch.functional.text.infolm"]
    label = "wmt14_bertscore_infolm"
    hyps, refs = _wmt14_like(segments)
    _zero_kernel_counts()
    torch.manual_seed(162)
    with torch.device(dev):
        roberta = _text_encoder(50_265, 1024, 24, 16, 4096, 514, lm_head=False)
        bert_mlm = _text_encoder(30_522, 768, 12, 12, 3072, 512, lm_head=True)
    roberta_tok = _hash_tokenizer(50_265, 0, 2, 1, 512)
    bert_tok = _hash_tokenizer(30_522, 101, 102, 0, 512)
    records = {}
    for name, make, encoder in (
        ("BERTScore", lambda fwd, d, n: tm.BERTScore(user_tokenizer=roberta_tok, user_forward_fn=fwd, idf=False,
                                                     max_length=512, batch_size=n, device=d), roberta),
        ("BERTScore_idf", lambda fwd, d, n: tm.BERTScore(user_tokenizer=roberta_tok, user_forward_fn=fwd, idf=True,
                                                         max_length=512, batch_size=n, device=d), roberta),
        ("InfoLM_kl", lambda fwd, d, n: tm.InfoLM(user_tokenizer=bert_tok, user_forward_fn=fwd, temperature=0.25,
                                                  information_measure="kl_divergence", idf=False, batch_size=n,
                                                  return_sentence_level_score=True, device=d), bert_mlm),
        ("InfoLM_fisher_rao", lambda fwd, d, n: tm.InfoLM(user_tokenizer=bert_tok, user_forward_fn=fwd,
                                                          temperature=0.25, information_measure="fisher_rao_distance",
                                                          idf=False, batch_size=n, return_sentence_level_score=True,
                                                          device=d), bert_mlm),
    ):
        fwd = _TimedEncoder(encoder, dev)
        metric = make(fwd, dev, batch)
        for start in range(0, segments, batch):
            metric.update(hyps[start:start + batch], refs[start:start + batch])
        out, ms, peak = _timed_peak(dev, metric.compute)
        values = out if isinstance(out, dict) else {"score": out[0], "sentences": out[1]}
        for key, value in values.items():
            if not bool(torch.isfinite(value).all()):
                raise AssertionError(f"{label}: {name} {key} is not finite")
        records[name] = {"compute_s": ms / 1e3, "encoder_s": fwd.seconds, "rest_s": ms / 1e3 - fwd.seconds,
                         "encoder_calls": fwd.calls, "peak_mb": peak,
                         "value": {k: float(v.mean()) for k, v in values.items()}}
        # one chunk of cpu_pairs on the CPU, the stand-in copied there, against the card
        cpu_metric = make(_TimedEncoder(copy.deepcopy(encoder).cpu(), torch.device("cpu")), "cpu", cpu_pairs)
        card_metric = make(_TimedEncoder(encoder, dev), dev, cpu_pairs)
        for m in (cpu_metric, card_metric):
            m.update(hyps[:cpu_pairs], refs[:cpu_pairs])
        got, want = card_metric.compute(), cpu_metric.compute()
        got = got if isinstance(got, dict) else {"score": got[0], "sentences": got[1]}
        want = want if isinstance(want, dict) else {"score": want[0], "sentences": want[1]}
        records[name]["cpu_chunk_err"] = _hold(label, f"{name} card against CPU", max(
            _max_rel(got[k], want[k]) for k in want), 1e-4)

    # the first chunk's matching and measures against float64 of the same embeddings and logits
    tok_p, tok_t = roberta_tok(hyps[:batch], 512), roberta_tok(refs[:batch], 512)
    tok_p, tok_t = ({k: v.to(dev) for k, v in t.items()} for t in (tok_p, tok_t))
    with torch.no_grad():
        emb_p = roberta(tok_p["input_ids"], tok_p["attention_mask"])
        emb_t = roberta(tok_t["input_ids"], tok_t["attention_mask"])
    dense = bert_mod.bert_score_from_embeddings(emb_p, tok_p["attention_mask"], emb_t, tok_t["attention_mask"])
    chunked = bert_mod.bert_score_from_embeddings_chunked(emb_p, tok_p["attention_mask"], emb_t,
                                                          tok_t["attention_mask"], chunk_size=16)
    f64 = _f64_bert(emb_p, tok_p["attention_mask"], emb_t, tok_t["attention_mask"])
    matching_err = _hold(label, "matching against float64", max(_max_rel(dense[k], f64[k]) for k in f64), A11D_RTOL)
    chunked_err = _hold(label, "chunked matching against dense", max(
        float((chunked[k] - dense[k]).abs().max()) for k in dense), 1e-6)
    tok_p, tok_t = bert_tok(hyps[:batch], 512), bert_tok(refs[:batch], 512)
    tok_p, tok_t = ({k: v.to(dev) for k, v in t.items()} for t in (tok_p, tok_t))
    with torch.no_grad():
        logits_p = bert_mlm(tok_p["input_ids"], tok_p["attention_mask"])
        logits_t = bert_mlm(tok_t["input_ids"], tok_t["attention_mask"])
    measure_err = {}
    for measure in ("kl_divergence", "fisher_rao_distance"):
        dist_p = infolm_mod._sentence_distribution_from_logits(logits_p / 0.25, tok_p["attention_mask"])
        dist_t = infolm_mod._sentence_distribution_from_logits(logits_t / 0.25, tok_t["attention_mask"])
        got = infolm_mod._InformationMeasure(measure)(dist_p, dist_t)
        want = _f64_infolm(logits_p, tok_p["attention_mask"], logits_t, tok_t["attention_mask"], 0.25, measure)
        measure_err[measure] = _hold(label, f"{measure} against float64", _max_rel(got, want), A11D_RTOL)
    del roberta, bert_mlm, emb_p, emb_t, logits_p, logits_t
    return {"phase": "a11d", "path": label, "pairs": segments, "batch_size": batch,
            "stand_ins": {"BERTScore": "roberta-large widths: 24 x 1024, 16 heads, FFN 4096, vocab 50265",
                          "InfoLM": "bert-base-uncased widths: 12 x 768, 12 heads, FFN 3072, vocab 30522, MLM head"},
            "metrics": records, "matching_err_f64": matching_err, "chunked_vs_dense_abs": chunked_err,
            "measure_err_f64": measure_err, "cpu_chunk_pairs": cpu_pairs, "card": card}


def _cnndm_like(summaries: int = 11_490, vocab: int = 30_000, seed: int = 163) -> tuple:
    """(predictions, references): CNN/DailyMail-test-like highlights of 3-4
    newline-separated sentences of about 56 words in all, and generated
    summaries that copy about 60% of the reference words, in sentences."""
    import numpy as np

    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = np.array(["".join(rng.choice(letters, k)) for k in rng.randint(2, 11, vocab)])
    draw = _zipf_pool(rng, words, summaries * 100)
    preds, refs = [], []
    for count in rng.randint(3, 5, summaries):
        lengths = np.maximum(4, rng.poisson(56 / count, count))
        ref_sents = [[next(draw) for _ in range(n)] for n in lengths]
        pred_sents = [[w if r < 0.6 else next(draw) for w, r in zip(s, rng.rand(len(s)))] for s in ref_sents]
        refs.append("\n".join(" ".join(s).capitalize() + "." for s in ref_sents))
        preds.append("\n".join(" ".join(s).capitalize() + "." for s in pred_sents))
    return preds, refs


def _squad_like(questions: int = 10_570, seed: int = 164) -> tuple:
    """SQuAD v1.1 dev-like predictions and targets: 1-3 answers of 1-6 words
    a question; predictions exact, off by an article or punctuation, partly
    overlapping or wrong."""
    import numpy as np

    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = np.array(["".join(rng.choice(letters, k)) for k in rng.randint(2, 10, 5000)])
    preds, target = [], []
    for i in range(questions):
        answers = [" ".join(rng.choice(vocab, rng.randint(1, 7))) for _ in range(rng.randint(1, 4))]
        r = rng.rand()
        if r < 0.6:
            pred = answers[0]
        elif r < 0.7:
            pred = "The " + answers[-1] + "."
        elif r < 0.9:
            pred = " ".join(answers[0].split()[:2] + list(rng.choice(vocab, 2)))
        else:
            pred = " ".join(rng.choice(vocab, rng.randint(1, 5)))
        preds.append({"prediction_text": pred, "id": f"{i:024x}"})
        target.append({"answers": {"answer_start": [0] * len(answers), "text": answers}, "id": f"{i:024x}"})
    return preds, target


def run_cnndm_rouge_squad(card: str, dev, summaries: int = 4000, questions: int = 10_570, batch: int = 64,
                          check: int = 512) -> dict:
    """Path ``cnndm_rouge_squad``: ROUGEScore (rouge1, rouge2, rougeL,
    rougeLsum, accumulate="best") over the first ``summaries`` of
    CNN/DailyMail test's 11,490 seeded highlights (``_cnndm_like``; a cut
    of depth for the script's time) and SQuAD over SQuAD v1.1 dev's 10,570
    questions (``_squad_like``), ``batch`` an update: ms an update. Checks
    the states after the first ``check`` items bitwise against device="cpu",
    and the scores against float64 means of the states."""
    import torchmetrics_tpu_torch as tm

    label = "cnndm_rouge_squad"
    t0 = time.perf_counter()
    preds, refs = (items[:summaries] for items in _cnndm_like())
    q_preds, q_target = _squad_like(questions)
    setup_s = time.perf_counter() - t0
    _zero_kernel_counts()
    keys = ("rouge1", "rouge2", "rougeL", "rougeLsum")
    rouge, rouge_times = _drive_host_metrics(
        {"ROUGEScore": lambda d: tm.ROUGEScore(rouge_keys=keys, accumulate="best", device=d)}, preds, refs, dev,
        batch, check, lambda rs: [[r] for r in rs])
    squad, squad_times = _drive_host_metrics({"SQuAD": lambda d: tm.SQuAD(device=d)}, q_preds, q_target, dev,
                                                batch, check, lambda ts: ts)
    rouge_out = rouge["ROUGEScore"].compute()
    st = _states_of(rouge["ROUGEScore"])
    errors = {}
    for key in keys:
        trip = st[f"{key}_triplets"].double()
        for i, part in enumerate(("precision", "recall", "fmeasure")):
            errors[f"{key}_{part}"] = _hold_f64(label, f"{key}_{part}", rouge_out[f"{key}_{part}"],
                                                float(trip[:, i].mean()), A11D_RTOL)
    squad_out = squad["SQuAD"].compute()
    sq = _states_of(squad["SQuAD"])
    for key, state in (("exact_match", "exact_match"), ("f1", "f1_score")):
        errors[key] = _hold_f64(label, key, float(squad_out[key]) / 100, float(sq[state].double() / sq["total"].double()),
                                A11D_RTOL)
    if int(sq["total"]) != questions:
        raise AssertionError(f"{label}: SQuAD counted {int(sq['total'])} of {questions} questions")
    return {"phase": "a11d", "path": label, "summaries": summaries, "questions": questions, "batch": batch,
            "reduced": f"ROUGE over the first {summaries} of 11,490 summaries",
            "setup_s": setup_s, "ms_per_update": {"ROUGEScore": statistics.median(rouge_times["ROUGEScore"]),
                                                  "SQuAD": statistics.median(squad_times["SQuAD"])},
            "s_total": {"ROUGEScore": sum(rouge_times["ROUGEScore"]) / 1e3, "SQuAD": sum(squad_times["SQuAD"]) / 1e3},
            "values": {**{k: float(v) for k, v in rouge_out.items()}, **{k: float(v) for k, v in squad_out.items()}},
            "value_err_f64": errors, "states_bitwise": {"items": check, "against": "device='cpu'"}, "card": card}


def run_wikitext_perplexity(card: str, dev, sequences: int = 280, seq_len: int = 1024, vocab: int = 50_257,
                            batch: int = 8) -> dict:
    """Path ``wikitext_perplexity``: Perplexity(ignore_index=-100) at
    GPT-2's 50,257-word vocabulary over WikiText-103 test's ~280 sequences of
    1,024 tokens, ``batch`` an update (1.65 GB of float32 logits), 5% of the
    targets ignored; captured (one graph replay an update) and eager (jit=False):
    ms an update, the byte bound, peak MB. Checks the value against float64
    log_softmax on the card, one probability input taking the log branch,
    and the first update's states against device="cpu"."""
    import torch

    import torchmetrics_tpu_torch as tm

    label = "wikitext_perplexity"
    _zero_kernel_counts()
    updates = sequences // batch
    g = torch.Generator(device=dev)

    def data(step):
        g.manual_seed(165 + step)
        logits = 4.0 * torch.randn((batch, seq_len, vocab), generator=g, device=dev)
        target = torch.randint(0, vocab, (batch, seq_len), generator=g, device=dev)
        drop = torch.rand((batch, seq_len), generator=g, device=dev) < 0.05
        return logits, target.masked_fill(drop, -100)

    captured, eager = tm.Perplexity(ignore_index=-100, device=dev), tm.Perplexity(ignore_index=-100, jit=False,
                                                                                 device=dev)
    times = {"captured": [], "eager": []}
    nll64 = torch.zeros((), dtype=torch.float64, device=dev)
    tokens, peak = 0, 0.0
    for step in range(updates):
        logits, target = data(step)
        _peak_reset(dev)
        base = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        times["captured"].append(_timed_update(dev, captured, logits, target))
        times["eager"].append(_timed_update(dev, eager, logits, target))
        if dev.type == "cuda":
            peak = max(peak, (torch.cuda.max_memory_allocated() - base) / 2**20)
        keep = target != -100
        lp = torch.log_softmax(logits.double(), dim=-1).gather(-1, target.clamp(min=0)[..., None])[..., 0]
        nll64 -= (lp * keep).sum()
        tokens += int(keep.sum())
        del lp
    want = float(torch.exp(nll64 / tokens))
    value = float(captured.compute())
    err = _hold(label, "perplexity against float64", abs(value - want) / want, A11D_RTOL)
    for state in ("total_log_probs", "count"):
        if not torch.equal(getattr(captured, state), getattr(eager, state)):
            raise AssertionError(f"{label}: captured and eager {state} differ")
    # a probability input takes the log branch: its value is exp(mean -log p[t])
    logits, target = data(0)
    probs = torch.softmax(logits, dim=-1)
    probe = tm.Perplexity(ignore_index=-100, device=dev)
    probe.update(probs, target)
    keep = target != -100
    lp = torch.log(probs.double().gather(-1, target.clamp(min=0)[..., None])[..., 0].clamp(min=1e-20))
    probs_want = float(torch.exp(-(lp * keep).sum() / keep.sum()))
    probs_err = _hold(label, "probability input against float64 log", abs(float(probe.compute()) - probs_want)
                      / probs_want, A11D_RTOL)
    del probs, lp
    # the first update against device="cpu"
    cpu = tm.Perplexity(ignore_index=-100, device="cpu")
    cpu.update(logits.cpu(), target.cpu())
    first = tm.Perplexity(ignore_index=-100, device=dev)
    first.update(logits, target)
    cpu_err = _hold(label, "first update against the CPU", max(
        abs(float(getattr(first, s)) - float(getattr(cpu, s))) / abs(float(getattr(cpu, s)))
        for s in ("total_log_probs", "count")), A11D_RTOL)
    captures = len(captured._update_graphs)
    logit_bytes = batch * seq_len * vocab * 4
    return {"phase": "a11d", "path": label, "sequences": updates * batch, "seq_len": seq_len, "vocab": vocab,
            "batch": batch, "updates": updates, "ms_per_update": {k: statistics.median(v) for k, v in times.items()},
            "bound_ms": logit_bytes / hbm_bytes_per_s() * 1e3, "bound_is": "bytes of the float32 logits read once / 3.35 TB/s",
            "logit_bytes_per_update": logit_bytes, "captured_graphs": captures, "peak_mb_over_inputs": peak,
            "value": value,
            "value_err_f64": err, "probs_branch_err_f64": probs_err, "first_update_err_cpu": cpu_err, "card": card}


def _vit(width: int, layers: int, heads: int, patch: int, image: int, out_dim: int):
    """A CLIP-style vision tower from ``torch.nn``: patch convolution, class
    token, learned positions, pre-norm GELU layers, the class token's
    LayerNorm and a projection."""
    import torch
    from torch import nn

    class Vision(nn.Module):
        def __init__(self):
            super().__init__()
            self.patch = nn.Conv2d(3, width, patch, stride=patch, bias=False)
            self.cls = nn.Parameter(torch.randn(width) * 0.02)
            self.positions = nn.Parameter(torch.randn((image // patch) ** 2 + 1, width) * 0.02)
            self.pre = nn.LayerNorm(width)
            layer = nn.TransformerEncoderLayer(width, heads, 4 * width, dropout=0.0, activation="gelu",
                                               batch_first=True, norm_first=True)
            self.encoder = nn.TransformerEncoder(layer, layers, enable_nested_tensor=False)
            self.post = nn.LayerNorm(width)
            self.proj = nn.Linear(width, out_dim, bias=False)

        def forward(self, pixels):
            x = self.patch(pixels).flatten(2).transpose(1, 2)
            x = torch.cat([self.cls.expand(x.shape[0], 1, -1), x], dim=1) + self.positions[None]
            return self.proj(self.post(self.encoder(self.pre(x))[:, 0]))

    return Vision()


def _clip_text(width: int, layers: int, heads: int, vocab: int, positions: int, out_dim: int):
    """A CLIP-style text tower: token and position embeddings, causal
    pre-norm GELU layers, the final LayerNorm at each caption's EOS (its last
    token) and a projection."""
    import torch
    from torch import nn

    class Text(nn.Module):
        def __init__(self):
            super().__init__()
            self.tokens = nn.Embedding(vocab, width)
            self.positions = nn.Parameter(torch.randn(positions, width) * 0.01)
            layer = nn.TransformerEncoderLayer(width, heads, 4 * width, dropout=0.0, activation="gelu",
                                               batch_first=True, norm_first=True)
            self.encoder = nn.TransformerEncoder(layer, layers, enable_nested_tensor=False)
            self.final = nn.LayerNorm(width)
            self.proj = nn.Linear(width, out_dim, bias=False)

        def forward(self, input_ids, attention_mask):
            n = input_ids.shape[1]
            x = self.tokens(input_ids) + self.positions[:n][None]
            causal = torch.triu(torch.ones((n, n), dtype=torch.bool, device=x.device), diagonal=1)
            x = self.final(self.encoder(x, mask=causal, src_key_padding_mask=attention_mask == 0))
            eos = attention_mask.sum(1) - 1
            return self.proj(x[torch.arange(x.shape[0], device=x.device), eos])

    return Text()


def _clip_stand_in(vision: dict, text: dict, projection: int, image: int):
    """(model, processor): a stand-in CLIP at published widths with seeded
    random weights, exposing ``get_image_features``/``get_text_features`` and
    a ``config.text_config.max_position_embeddings``, and a processor that
    resizes (bicubic, antialiased) and centre-crops images to ``image`` and
    normalises them with CLIP's mean and std on the card, and hashes caption
    words to ids between BOS and EOS."""
    import types

    import torch
    from torch import nn

    class StandInCLIP(nn.Module):
        def __init__(self):
            super().__init__()
            self.vision = _vit(out_dim=projection, image=image, **vision)
            self.text = _clip_text(out_dim=projection, **text)
            self.config = types.SimpleNamespace(text_config=types.SimpleNamespace(
                max_position_embeddings=text["positions"]))

        def get_image_features(self, pixel_values):
            return self.vision(pixel_values)

        def get_text_features(self, input_ids, attention_mask):
            return self.text(input_ids, attention_mask)

    mean = torch.tensor([0.48145466, 0.4578275, 0.40821073])
    std = torch.tensor([0.26862954, 0.26130258, 0.27577711])
    vocab, positions = text["vocab"], text["positions"]

    def processor(text=None, images=None, return_tensors="np", padding=True):
        out = {}
        if images is not None:
            x = torch.stack(list(images))
            h, w = x.shape[-2:]
            scale = image / min(h, w)
            x = torch.nn.functional.interpolate(x, size=(max(image, round(h * scale)), max(image, round(w * scale))),
                                                mode="bicubic", antialias=True, align_corners=False)
            top, left = (x.shape[-2] - image) // 2, (x.shape[-1] - image) // 2
            x = x[..., top:top + image, left:left + image]
            out["pixel_values"] = (x - mean.to(x.device)[:, None, None]) / std.to(x.device)[:, None, None]
        if text is not None:
            rows = [[vocab - 2] + [_word_id(w, vocab - 2, 1) for w in t.lower().split()] + [vocab - 1] for t in text]
            width = max(map(len, rows))
            ids = torch.zeros((len(rows), width), dtype=torch.int64)
            mask = torch.zeros((len(rows), width), dtype=torch.int64)
            for i, row in enumerate(rows):
                ids[i, :len(row)] = torch.tensor(row)
                mask[i, :len(row)] = 1
            out["input_ids"], out["attention_mask"] = ids, mask
        return out

    return _hf_init(StandInCLIP()).eval(), processor


def _captions(n: int, seed: int) -> list:
    import numpy as np

    rng = np.random.RandomState(seed)
    nouns = ["man", "woman", "dog", "cat", "bus", "train", "pizza", "table", "street", "kitchen", "horse", "boat"]
    verbs = ["sitting on", "standing near", "riding", "holding", "next to", "in front of", "walking past"]
    return [f"a {rng.choice(['large', 'small', 'red', 'white', 'young'])} {rng.choice(nouns)} "
            f"{rng.choice(verbs)} a {rng.choice(nouns)} {rng.choice(['in a park', 'on a street', 'at night', ''])}"
            .strip() for _ in range(n)]


def run_coco_clipscore_koniq_clipiqa(card: str, dev, images: int = 2500, batch: int = 50, pair_images: int = 500,
                                     koniq: int = 2015, koniq_batch: int = 32, cpu_images: int = 2) -> dict:
    """Path ``coco_clipscore_koniq_clipiqa``: CLIPScore through a stand-in
    CLIP at ViT-L/14's widths (vision 24 x 1024, 16 heads, patch 14 at 224;
    text 12 x 768, 12 heads, 77 positions, vocabulary 49,408; projection
    768; the default ``openai/clip-vit-large-patch14``) over the first
    ``images`` of MS-COCO Karpathy test's 5,000 images at 640 x 480 with one
    caption each (a cut of depth for the script's time), ``batch`` an
    update, and image-image pairs over the first ``pair_images``;
    CLIPImageQualityAssessment through a stand-in at
    ViT-B/16's widths (12 x 768, patch 16; text 12 x 512; projection 512)
    over KonIQ-10k test's 2,015 images at 1024 x 768 with the prompts
    quality, sharpness, noisiness and brightness. ms an image, peak MB.
    Checks the cosines and prompt softmaxes of the first batch against
    float64 on the card of the same features, the states after
    ``cpu_images`` images against device="cpu" (the stand-ins copied
    there), and that ``CLIPScore()``, whose default model has no local
    files here, raises ModuleNotFoundError without asking the network."""
    import copy

    import torch

    import torchmetrics_tpu_torch as tm

    cs_mod = sys.modules["torchmetrics_tpu_torch.functional.multimodal.clip_score"]
    label = "coco_clipscore_koniq_clipiqa"
    _zero_kernel_counts()
    torch.manual_seed(166)
    with torch.device(dev):
        clip_l = _clip_stand_in({"width": 1024, "layers": 24, "heads": 16, "patch": 14},
                                {"width": 768, "layers": 12, "heads": 12, "vocab": 49_408, "positions": 77}, 768, 224)
        clip_b = _clip_stand_in({"width": 768, "layers": 12, "heads": 12, "patch": 16},
                                {"width": 512, "layers": 12, "heads": 8, "vocab": 49_408, "positions": 77}, 512, 224)
    g = torch.Generator(device=dev)
    captions = _captions(images, 167)

    def coco(step, n=batch):
        g.manual_seed(168 + step)
        return torch.rand((n, 3, 480, 640), generator=g, device=dev)

    prompts = ("quality", "sharpness", "noisiness", "brightness")
    score = tm.CLIPScore(model_name_or_path=clip_l, device=dev)
    pair_score = tm.CLIPScore(model_name_or_path=clip_l, device=dev)
    iqa = tm.CLIPImageQualityAssessment(model_name_or_path=clip_b, prompts=prompts, device=dev)
    times = {"image_text": [], "image_image": [], "iqa": []}
    _peak_reset(dev)
    for step in range(images // batch):
        x = coco(step)
        times["image_text"].append(_timed_update(dev, score, x, captions[step * batch:(step + 1) * batch]))
        if (step + 1) * batch <= pair_images:
            times["image_image"].append(_timed_update(dev, pair_score, x, coco(10_000 + step)))
    clip_peak = _peak_mb(dev)

    def koniq_images(step, n):
        g.manual_seed(20_000 + step)
        return torch.rand((n, 3, 768, 1024), generator=g, device=dev)

    _peak_reset(dev)
    for step, start in enumerate(range(0, koniq, koniq_batch)):
        times["iqa"].append(_timed_update(dev, iqa, koniq_images(step, min(koniq_batch, koniq - start))))
    iqa_peak = _peak_mb(dev)
    values = {"clip_score": float(score.compute()), "clip_score_image_image": float(pair_score.compute()),
              "mean_100_cosine_image_text": float(score.score / score.n_samples)}
    iqa_out = iqa.compute()
    for key, value in iqa_out.items():
        if value.shape != (koniq,) or not bool(((value >= 0) & (value <= 1)).all()):
            raise AssertionError(f"{label}: CLIP-IQA {key} has shape {tuple(value.shape)} or leaves [0, 1]")
        values[f"iqa_{key}"] = float(value.mean())
    if int(score.n_samples) != images or int(pair_score.n_samples) != pair_images:
        raise AssertionError(f"{label}: CLIPScore counted {int(score.n_samples)} and {int(pair_score.n_samples)}")

    # the first batch's cosines and softmaxes against float64 of the same features
    model, processor = clip_l
    x, caps = coco(0), captions[:batch]
    # the raw features under the metric's own pins (cs_mod._forward: no grad, float32 in full precision)
    raw_i = cs_mod._forward(model.get_image_features, processor(images=list(x))["pixel_values"])
    tok = {k: v.to(dev) for k, v in processor(text=caps).items()}
    raw_t = cs_mod._forward(model.get_text_features, tok["input_ids"], tok["attention_mask"])
    got_cos = (cs_mod._image_features(x, model, processor, dev) * cs_mod._text_features(caps, model, processor, dev)
               ).sum(-1)
    i64, t64 = (f.double() / f.double().norm(dim=-1, keepdim=True) for f in (raw_i, raw_t))
    cos_err = _hold(label, "cosines against float64", float((got_cos.double() - (i64 * t64).sum(-1)).abs().max()),
                    A11D_RTOL)
    b_model, b_proc = clip_b
    iqa_mod = sys.modules["torchmetrics_tpu_torch.functional.multimodal.clip_iqa"]
    flat, _ = iqa_mod._format_prompts(prompts)
    y = koniq_images(0, 8)
    raw_i = cs_mod._forward(b_model.get_image_features, b_proc(images=list(y))["pixel_values"])
    tok = {k: v.to(dev) for k, v in b_proc(text=flat).items()}
    raw_a = cs_mod._forward(b_model.get_text_features, tok["input_ids"], tok["attention_mask"])
    i64, a64 = (f.double() / f.double().norm(dim=-1, keepdim=True) for f in (raw_i, raw_a))
    want_probs = torch.softmax((100.0 * i64 @ a64.T).reshape(8, -1, 2), dim=-1)[..., 0]
    got_probs = iqa_mod._clip_iqa_update(y, iqa.anchors, b_model, b_proc)
    softmax_err = _hold(label, "prompt softmaxes against float64",
                        float((got_probs.double() - want_probs).abs().max()), A11D_RTOL)

    # the first images against device="cpu", the stand-ins copied there
    cpu_l, cpu_b = (copy.deepcopy(m).cpu() for m in (clip_l[0], clip_b[0]))
    card_score, cpu_score = tm.CLIPScore(clip_l, device=dev), tm.CLIPScore((cpu_l, clip_l[1]), device="cpu")
    card_score.update(x[:cpu_images], caps[:cpu_images])
    cpu_score.update(x[:cpu_images].cpu(), caps[:cpu_images])
    card_iqa = tm.CLIPImageQualityAssessment(clip_b, prompts=prompts, device=dev)
    cpu_iqa = tm.CLIPImageQualityAssessment((cpu_b, clip_b[1]), prompts=prompts, device="cpu")
    card_iqa.update(y[:cpu_images])
    cpu_iqa.update(y[:cpu_images].cpu())
    cpu_err = max(abs(float(card_score.score) - float(cpu_score.score)) / 100.0,
                  float((_states_of(card_iqa)["probs_list"] - _states_of(cpu_iqa)["probs_list"]).abs().max()))
    _hold(label, "first images against the CPU", cpu_err, 1e-4)
    if int(card_score.n_samples) != int(cpu_score.n_samples):
        raise AssertionError(f"{label}: n_samples differ between the card and the CPU")
    # the default model: no transformers, or no local files of it, raises (the network is never asked)
    try:
        tm.CLIPScore(device=dev)
    except ModuleNotFoundError as err:
        no_model = f"ModuleNotFoundError: {err}"
    else:
        raise AssertionError(f"{label}: CLIPScore() found no local model and did not raise")
    transformers_version = None
    if cs_mod._TRANSFORMERS_AVAILABLE:
        import transformers

        transformers_version = transformers.__version__
    del clip_l, clip_b, cpu_l, cpu_b
    return {"phase": "a11d", "path": label, "coco_images": images, "batch": batch, "pair_images": pair_images,
            "reduced": f"COCO: the first {images} of 5,000 images, image-image pairs on {pair_images}",
            "koniq_images": koniq, "koniq_batch": koniq_batch, "prompts": list(prompts),
            "stand_ins": {"CLIPScore": "ViT-L/14 widths: vision 24 x 1024 patch 14 at 224, text 12 x 768, 77 "
                                       "positions, vocab 49408, projection 768",
                          "CLIP-IQA": "ViT-B/16 widths: vision 12 x 768 patch 16 at 224, text 12 x 512, "
                                      "projection 512"},
            "ms_per_image": {"image_text": statistics.median(times["image_text"]) / batch,
                             "image_image": statistics.median(times["image_image"]) / batch,
                             "iqa": statistics.median(times["iqa"]) / koniq_batch},
            "s_total": {k: sum(v) / 1e3 for k, v in times.items()}, "peak_mb": {"clip": clip_peak, "iqa": iqa_peak},
            "values": values, "cosine_err_f64": cos_err, "softmax_err_f64": softmax_err, "cpu_images": cpu_images,
            "cpu_err": cpu_err, "no_model": no_model, "transformers": transformers_version, "card": card}


def run_a11d_paths(card: str, dev) -> tuple:
    """The five A11.d paths; (records, bincount launches over them, which must be none)."""
    records = []
    for run in (run_wmt14_translation, run_wmt14_bertscore_infolm, run_cnndm_rouge_squad, run_wikitext_perplexity,
                run_coco_clipscore_koniq_clipiqa):
        t0 = time.perf_counter()
        record = run(card, dev)
        record["seconds"] = time.perf_counter() - t0
        record["kernel_launches"] = _kernel_counts()
        records.append(record)
        emit(record)
    launches = sum(r["kernel_launches"]["weighted_bincount"] for r in records)
    if launches or any(r["kernel_launches"]["tdigest_compress"] for r in records):
        raise AssertionError(f"a11d: the text and multimodal paths launched a kernel: "
                             f"{[r['kernel_launches'] for r in records]}")
    return records, launches


# ---------------------------------------------------------------------------
# phase a13: sharded cat state, the histogram AUROC, elastic sync
# ---------------------------------------------------------------------------

CRITEO_ROWS = 89_137_319  # MLPerf DLRM-DCNv2 on Criteo 1TB: the validation half of day 23
CRITEO_BATCH = 65_536
CRITEO_POSITIVES = 0.034  # the click rate of the Criteo 1TB logs, about 3.4%
# logits N(bias + gap·label, 1): the exact AUROC is Phi(gap / sqrt 2), 0.8025 at this gap,
# the reference's target (MLPerf Training's DLRM-DCNv2 quality target)
CRITEO_GAP = 1.2028
CRITEO_BIAS = -3.4
CRITEO_HIST_BINS = 8192
CRITEO_SHARDS = 4  # the histogram metric's mesh lists the card this many times
MOMENTS_TOL = 1e-6
# the 4-rank soak over ImageNet-1k validation: the JAX package's schedule rates
SOAK_RATES = dict(p_delay=0.05, p_timeout=0.08, p_drop=0.04, p_rejoin=0.5, max_delay_s=0.001)


def _tree_bitwise(label: str, what: str, got: dict, want: dict) -> int:
    """State dicts (tensors, CatBuffers, ShardedCatBuffers) equal bitwise,
    cat states as rows in the same order; returns how many were compared."""
    import torch

    from torchmetrics_tpu_torch.buffers import CatBuffer

    for key, w in want.items():
        g = got[key]
        g = g.materialize() if isinstance(g, CatBuffer) else g
        w = w.materialize() if isinstance(w, CatBuffer) else w
        if isinstance(g, list):
            g = torch.cat(g) if g else torch.zeros(0)
        if isinstance(w, list):
            w = torch.cat(w) if w else torch.zeros(0)
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g.cpu(), w.cpu()):
            raise AssertionError(f"{label}: {what}: state {key} differs bitwise")
    return len(want)


def _criteo_batches(dev, rows: int, seed: int = 171):
    """Seeded scores and 0/1 labels on ``dev``: labels at CRITEO_POSITIVES,
    float32 scores sigmoid(bias + gap·label + N(0, 1))."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    target = (torch.rand(rows, generator=g, device=dev) < CRITEO_POSITIVES).to(torch.int32)
    logits = torch.randn(rows, generator=g, device=dev)
    logits += CRITEO_BIAS
    logits += CRITEO_GAP * target
    return torch.sigmoid(logits), target


def _auroc_layouts(dev, shards: int, bins: int) -> dict:
    """The three BinaryAUROCs of the path: replicated exact, sharded exact on
    the device's own mesh, and the histogram over a mesh listing it ``shards`` times."""
    from torchmetrics_tpu_torch.buffers import use_eval_mesh
    from torchmetrics_tpu_torch.classification import BinaryAUROC

    out = {"replicated": BinaryAUROC(device=dev), "sharded_exact": BinaryAUROC(cat_layout="sharded", device=dev)}
    with use_eval_mesh([dev] * shards):
        out["sharded_hist"] = BinaryAUROC(cat_layout="sharded", hist_bins=bins, device=dev)
    return out


def _resident_mb(metric) -> float:
    from torchmetrics_tpu_torch.buffers import ShardedCatBuffer

    total = 0
    for name in ("preds", "target"):
        buf = getattr(metric, name)
        total += sum(buf.per_shard_nbytes()) if isinstance(buf, ShardedCatBuffer) else \
            buf.buffer.numel() * buf.buffer.element_size()
    return total / 2**20


def run_criteo_auroc(card: str, dev, rows: int = CRITEO_ROWS, batch: int = CRITEO_BATCH,
                     bins: int = CRITEO_HIST_BINS, shards: int = CRITEO_SHARDS, cpu_rows: int = 2_000_000,
                     topk: int = 1000) -> tuple:
    """Path ``criteo_dlrm_eval_auroc``: BinaryAUROC over the DLRM-DCNv2
    evaluation set in batches of 65,536 (the last ragged), as three layouts
    on the same updates. Returns (record, bincount launches, the kernel row
    of the histogram's shape)."""
    import torch

    from torchmetrics_tpu_torch.ops import bincount
    from torchmetrics_tpu_torch.parallel import sharded_compute as sc
    from torchmetrics_tpu_torch.utils.data import dim_zero_cat, sharded_oracle

    label = "criteo_dlrm_eval_auroc"
    preds, target = _criteo_batches(dev, rows)
    starts = range(0, rows, batch)
    _zero_kernel_counts()
    metrics = _auroc_layouts(dev, shards, bins)
    ms_update, peak_mb = {}, {}
    for name, m in metrics.items():
        _peak_reset(dev)
        base_mb = torch.cuda.memory_allocated() / 2**20 if dev.type == "cuda" else 0.0
        t0 = time.perf_counter()
        for s in starts:
            m.update(preds[s:s + batch], target[s:s + batch])
        _sync(dev)
        ms_update[name] = (time.perf_counter() - t0) * 1e3 / len(starts)
        peak_mb[name] = _peak_mb(dev) - base_mb if dev.type == "cuda" else None
    rep, exact, hist = metrics["replicated"], metrics["sharded_exact"], metrics["sharded_hist"]
    if exact.preds.n_shards != 1 or hist.preds.n_shards != shards or hist.preds.count != rows:
        raise AssertionError(f"{label}: shards {exact.preds.n_shards}/{hist.preds.n_shards}, rows {hist.preds.count}")
    values, compute_ms = {}, {}
    for name, m in metrics.items():
        m.compute()  # the first compute in a process imports modules: warm it
        m._computed = None
        before = bincount.weighted_bincount.launches
        values[name], compute_ms[name] = _timed(m.compute)
        if name == "sharded_hist":
            hist_launches = bincount.weighted_bincount.launches - before
    if hist_launches != shards:
        raise AssertionError(f"{label}: the histogram compute launched the bincount {hist_launches} times, "
                             f"expected one per shard ({shards})")
    v_rep, v_exact, v_hist = (float(values[k]) for k in ("replicated", "sharded_exact", "sharded_hist"))
    if not torch.equal(values["replicated"], values["sharded_exact"]):
        raise AssertionError(f"{label}: the sharded exact AUROC {v_exact!r} is not bitwise the replicated {v_rep!r}")
    counts = {}
    for name, m in (("one_shard", exact), (f"{shards}_shards", hist)):
        counts[name] = (sc.sharded_histogram(m.preds, bins), sc.sharded_histogram(m.preds, bins, weights=m.target))
    for a, b in zip(*counts.values()):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{label}: sharded_histogram differs between 1 and {shards} shards")
    every, pos = counts["one_shard"][0].long(), counts["one_shard"][1].long()
    neg = every - pos
    p_total, n_total = int(pos.sum()), int(neg.sum())
    tie_bound = 0.5 * float((pos.double() * neg.double()).sum()) / (p_total * n_total)
    gap = abs(v_hist - v_exact)
    if not gap <= tie_bound + VALUE_TOL:  # the float32 arithmetic of the two values
        raise AssertionError(f"{label}: histogram AUROC {v_hist} is {gap} from the exact {v_exact}, "
                             f"past its tie bound {tie_bound}")
    with sharded_oracle():
        dense = dim_zero_cat(hist.preds)
    if not torch.equal(sc.sharded_topk(hist.preds, topk), torch.topk(dense, topk).values):
        raise AssertionError(f"{label}: sharded_topk({topk}) differs from torch.topk of the dense rows")
    mean, var = sc.sharded_moments(hist.preds)
    d64 = dense.double()
    moments_err = max(abs(float(mean) - float(d64.mean())), abs(float(var) - float(d64.var(unbiased=False))))
    _hold(label, "sharded_moments against float64", moments_err, MOMENTS_TOL)
    del d64
    one = sc.reshard(hist.preds, devices=[dev])
    if one.n_shards != 1 or not torch.equal(one.materialize(), hist.preds.materialize()):
        raise AssertionError(f"{label}: reshard from {shards} shards to 1 changed the rows")
    del one
    launches = bincount.weighted_bincount.launches

    # the first cpu_rows (whole batches) on the card and on the CPU
    cpu_dev = torch.device("cpu")
    n_cpu = min(rows, -(-cpu_rows // batch) * batch)
    card_small, cpu_small = _auroc_layouts(dev, shards, bins), _auroc_layouts(cpu_dev, shards, bins)
    p_cpu, t_cpu = preds[:n_cpu].cpu(), target[:n_cpu].cpu()
    for s in range(0, n_cpu, batch):
        for name in metrics:
            card_small[name].update(preds[s:s + batch], target[s:s + batch])
            cpu_small[name].update(p_cpu[s:s + batch], t_cpu[s:s + batch])
    cpu_errs = {}
    for name in metrics:
        _tree_bitwise(label, f"{name} states against the CPU", card_small[name].metric_state,
                      cpu_small[name].metric_state)
        cpu_errs[name] = _check_value(label, f"{name} value against the CPU", card_small[name].compute(),
                                      cpu_small[name].compute())
    launches = bincount.weighted_bincount.launches  # with the small run's histogram compute on the card
    del card_small, cpu_small, p_cpu, t_cpu, dense

    # the kernel row at the histogram's shape: every row's joint index into 2·bins
    x, t = exact.preds.valid_shards()[0], exact.target.valid_shards()[0]
    idx = sc.score_buckets(x, bins) + bins * t.to(torch.int32)
    kernel_row = {"case": "histogram_criteo_auroc", "entry": "1d", "s": 1, "n": rows, "bins": 2 * bins,
                  "shared_idx": False, "weighted": False}
    got = bincount.weighted_bincount(idx, None, 2 * bins)
    want = bincount.weighted_bincount_plain(idx, None, 2 * bins)
    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{label}: the kernel's histogram is not bitwise its plain version")
    kernel_row["max_abs_err"] = 0.0
    kernel_row["bitwise"] = True
    if dev.type == "cuda":
        kernel_row["ms"], kernel_row["host_ms"], kernel_row["ms_covered"] = time_ms(
            lambda: bincount.weighted_bincount(idx, None, 2 * bins))
        kernel_row["plain_ms"], kernel_row["plain_host_ms"], _ = time_ms(
            lambda: bincount.weighted_bincount_plain(idx, None, 2 * bins), reps=5)
        kernel_row["plain_is"] = "index_add_ of the plain version"
        kernel_row["library_device_ms"] = library_device_ms(idx, None, 2 * bins)
        kernel_row["library_ms"], _, kernel_row["library_covered"] = time_ms(library_call(idx, None, 2 * bins), reps=5)
        kernel_row["bound_ms"] = bincount.bound_bytes(idx, None, 2 * bins) / hbm_bytes_per_s() * 1e3
        kernel_row["bound_by"] = "bytes"
    del idx, got, want
    record = {"phase": "a13", "path": label, "rows": rows, "batch": batch, "updates": len(starts),
              "positives": p_total, "negatives": n_total, "hist_bins": bins, "shards": shards,
              "ms_per_update": ms_update, "compute_ms": compute_ms, "peak_mb_over_updates": peak_mb,
              "resident_mb": {k: _resident_mb(m) for k, m in metrics.items()},
              "values": {"exact_replicated": v_rep, "exact_sharded": v_exact, "histogram": v_hist},
              "exact_bitwise_replicated": True, "histogram_gap": gap, "histogram_tie_bound": tie_bound,
              "histogram_launches_per_compute": hist_launches, "topk": topk, "topk_bitwise": True,
              "moments_err_f64": moments_err, "reshard_4_to_1": "rows bitwise",
              "cpu_rows": n_cpu, "cpu_states": "bitwise", "cpu_value_err": cpu_errs, "card": card}
    return record, launches, kernel_row


def _soak_members(dev, classes: int) -> dict:
    import torchmetrics_tpu_torch as tm

    return {"acc": tm.MulticlassAccuracy(num_classes=classes, validate_args=False, device=dev),
            "ece": tm.MulticlassCalibrationError(num_classes=classes, n_bins=15, validate_args=False, device=dev)}


def run_imagenet_chaos_soak(card: str, dev, images: int = 50_000, world: int = 4, windows: int = 200,
                            classes: int = 1000, seed: int = 11) -> tuple:
    """Path ``imagenet_chaos_soak``: ImageNet-1k validation's images over
    ``world`` emulated ranks and ``windows`` sync windows (a window's images
    split as evenly as they go), MulticlassAccuracy and
    MulticlassCalibrationError(n_bins=15) on the card, rank 0 syncing
    through ElasticSync over ChaosSync/FakeSync under the JAX package's
    seeded soak schedule while every rank keeps updating (partition
    semantics), beside a fault-free twin. Then rank 3 is preempted (its
    checkpoint taken, one round without it), rank 0 merges the checkpoint
    and rank 3 rejoins empty: full coverage, the twin's value. Returns
    (record, bincount launches)."""
    import torch

    from torchmetrics_tpu_torch.ops import bincount
    from torchmetrics_tpu_torch.parallel import (ChaosSchedule, ElasticSync, FakeSync, SyncPolicy, chaos_group,
                                                 checkpoint_metric, elastic_stats, reset_elastic_stats)

    label = "imagenet_chaos_soak"
    g = torch.Generator(device=dev).manual_seed(173)
    probs = torch.softmax(2.0 * torch.randn((images, classes), generator=g, device=dev), dim=-1)
    labels = torch.randint(0, classes, (images,), generator=g, device=dev)
    per_window = images // windows
    split = [per_window // world + (r < per_window % world) for r in range(world)]
    policy = SyncPolicy(retry_attempts=2, backoff_base_s=0.001)
    _zero_kernel_counts()
    chaos = [_soak_members(dev, classes) for _ in range(world)]
    twin = [_soak_members(dev, classes) for _ in range(world)]
    chaos_grp, twin_grp = [{} for _ in range(world)], [{} for _ in range(world)]
    backs = chaos_group(chaos_grp, ChaosSchedule(seed=seed, n_rounds=windows, world=world, **SOAK_RATES))
    for m in chaos[0].values():
        m._sync_backend = ElasticSync(backs[0], policy=policy)
    for m in twin[0].values():
        m._sync_backend = FakeSync(twin_grp, 0)
    ctrl = backs[0].controller
    reset_elastic_stats()

    def refresh(ranks, grp):
        for r in range(world):
            grp[r].clear()
            for m in ranks[r].values():
                grp[r].update(m.metric_state)

    def synced_round(r0, twin0):
        """Sync rank 0 and its twin, compare, compute; the coverage records."""
        out = {}
        for name in r0:
            r0[name].sync()
            twin0[name].sync()
            full = r0[name].coverage.fraction == 1.0
            if full:
                _tree_bitwise(label, f"window {len(records)} {name}", r0[name].metric_state,
                              twin0[name].metric_state)
            got, want = r0[name].compute(), twin0[name].compute()
            err = float((got.double() - want.double()).abs().max()) if full else 0.0
            if full and name == "acc" and not torch.equal(got, want):
                raise AssertionError(f"{label}: window {len(records)}: accuracy {got} != {want} at full coverage")
            r0[name].unsync()
            twin0[name].unsync()
            out[name] = (r0[name].coverage.as_dict(), err)
        return out

    records, full_windows, value_err = [], 0, 0.0
    offset = 0
    t0 = time.perf_counter()
    for w in range(windows):
        for r in range(world):
            p, t = probs[offset:offset + split[r]], labels[offset:offset + split[r]]
            offset += split[r]
            for name in chaos[r]:
                chaos[r][name].update(p, t)
                twin[r][name].update(p, t)
        refresh(chaos, chaos_grp)
        refresh(twin, twin_grp)
        ctrl.advance()
        present = world - len(ctrl.down)
        rnd = synced_round(chaos[0], twin[0])
        for name, (cov, err) in rnd.items():
            if cov["ranks_present"] != present:
                raise AssertionError(f"{label}: window {w} {name}: coverage {cov} but {present} ranks present")
            if cov["fraction"] < 1.0 and cov["ranks_present"] >= world:
                raise AssertionError(f"{label}: window {w}: degraded with every rank present")
            value_err = max(value_err, err)
        full_windows += rnd["acc"][0]["fraction"] == 1.0
        records.append(rnd["acc"][0])
    soak_s = time.perf_counter() - t0
    _hold(label, "calibration error against the fault-free twin", value_err, VALUE_TOL)
    stats = elastic_stats()
    if full_windows < windows // 2 or full_windows == windows or not stats["recoveries"] or not stats["rejoins"]:
        raise AssertionError(f"{label}: the schedule did not exercise both regimes: {full_windows} full windows, "
                             f"stats {stats}")

    # rank 3 preempted: its checkpoint, one round without it, the merge, its rejoin
    blobs = {name: checkpoint_metric(m) for name, m in chaos[world - 1].items()}
    backs2 = chaos_group(chaos_grp, ChaosSchedule({0: [("drop", world - 1)], 1: [("rejoin", world - 1)]}))
    for m in chaos[0].values():
        m._sync_backend = ElasticSync(backs2[0], policy=policy)
    refresh(chaos, chaos_grp)
    backs2[0].controller.advance()
    degraded = {}
    for name, m in chaos[0].items():
        m._computed = None
        degraded[name] = (m.compute(), m.coverage.as_dict())
        if m.coverage.ranks_present != world - 1:
            raise AssertionError(f"{label}: coverage {m.coverage} with rank {world - 1} preempted")
    recovered = {name: m._sync_backend.merge_on_rejoin(m, blobs[name]) for name, m in chaos[0].items()}
    chaos[world - 1] = _soak_members(dev, classes)  # the rejoined process starts empty
    refresh(chaos, chaos_grp)
    backs2[0].controller.advance()
    rejoin_err = {}
    for name, m in chaos[0].items():
        m._computed = None
        twin[0][name]._computed = None
        got, want = m.compute(), twin[0][name].compute()
        if m.coverage.fraction != 1.0:
            raise AssertionError(f"{label}: coverage {m.coverage} after the rejoin")
        rejoin_err[name] = _check_value(label, f"{name} after the rejoin against the twin", got, want)
    launches = bincount.weighted_bincount.launches
    return {"phase": "a13", "path": label, "images": images, "world": world, "windows": windows,
            "images_per_rank_per_window": split, "members": ["MulticlassAccuracy", "MulticlassCalibrationError"],
            "schedule": dict(seed=seed, n_rounds=windows, world=world, **SOAK_RATES),
            "full_windows": full_windows, "degraded_windows": windows - full_windows, "elastic_stats": stats,
            "soak_seconds": soak_s, "ece_max_err_full_coverage": value_err,
            "preempt": {"degraded_coverage": {k: v[1] for k, v in degraded.items()},
                        "recovered_rows": recovered, "rejoin_coverage": 1.0, "rejoin_err": rejoin_err},
            "card": card}, launches


def run_a13_paths(card: str, dev) -> tuple:
    """Phase a13's two in-process paths; (records, bincount launches, the
    histogram's kernel row)."""
    records = []
    t0 = time.perf_counter()
    record, launches, kernel_row = run_criteo_auroc(card, dev)
    record["seconds"] = time.perf_counter() - t0
    emit(record)
    records.append(record)
    t0 = time.perf_counter()
    record, soak_launches = run_imagenet_chaos_soak(card, dev)
    record["seconds"] = time.perf_counter() - t0
    record["kernel_launches"] = soak_launches
    emit(record)
    records.append(record)
    if not launches or not soak_launches:
        raise AssertionError(f"a13: the bincount launched {launches} and {soak_launches} times on the two paths")
    return records, launches + soak_launches, kernel_row


# ---------------------------------------------------------------------------
# phase a14: observability and debug over the main path
# ---------------------------------------------------------------------------

A14_FENCE_EVERY = 10
# part (a): interleaved rounds of passes, each long enough that a pass's
# spread on the host clock is below a span's cost
A14_PASSES = 5
A14_PASS_UPDATES = 2000
# the soak's schedule over 40 windows: seed 11 (phase a13's, over 200) plans
# no drop in its first 40 rounds; 12 is the first seed whose 40-round plan
# drops and rejoins a rank (8 degraded windows) and times out a gather
A14_SOAK_SEED = 12
A14_FAMILIES = ("tmtpu_graph_", "tmtpu_wire_", "tmtpu_ledger_")


def _out_dir():
    """``chiprun_out/`` beside this script (``.gitignore`` lists it)."""
    import pathlib

    out = pathlib.Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    return out


def _timed_loop(dev, fn, steps) -> float:
    """ms per step of ``fn(i)`` over ``steps``: a host clock that ends in a
    synchronise."""
    _sync(dev)
    t0 = time.perf_counter()
    for i in steps:
        fn(i)
    _sync(dev)
    return (time.perf_counter() - t0) / len(steps) * 1e3


def _graph_delta(before: dict) -> dict:
    from torchmetrics_tpu_torch._capture import graph_stats

    return {k: v - before[k] for k, v in graph_stats().items()}


def _spread(samples: list) -> dict:
    return {"median": statistics.median(samples), "min": min(samples), "max": max(samples), "passes": samples}


def _a14_traced_main_path(card: str, dev, num_classes: int, batch: int, steps: int, passes: int,
                          pass_updates: int) -> dict:
    """(a) Bench config 2 over 2 warm-up updates (ledger armed: the group
    discovery, then the fused graph's capture), then ``passes`` rounds of
    four interleaved passes of ``pass_updates`` updates each, cycling over
    ``steps`` batches: an untraced twin, the metric inside tracing(),
    ledger_observing() and strict_mode(max_new_executables=0) with the guard
    armed, the twin again, and the metric traced with fence_every=10
    sampling. Medians with their spread. States bitwise the twin's after
    every round, no capture, no synchronising call (the guard raises on
    one); one ledger entry per captured graph, whose bincount launches carry
    the bytes of the kernel phase's bound for bench config 2's two shapes;
    the Perfetto file (the first traced pass) read back; the Prometheus
    families."""
    import torch

    from torchmetrics_tpu_torch._capture import graph_stats
    from torchmetrics_tpu_torch.debug import strict_mode
    from torchmetrics_tpu_torch.interop import state_to_numpy
    from torchmetrics_tpu_torch.observability import (drain_spans, executable_ledger, kernel_rooflines,
                                                      ledger_observing, phase_totals, reset_ledger, to_prometheus,
                                                      tracing, write_perfetto)
    from torchmetrics_tpu_torch.ops.bincount import bound_bytes

    label = "a14 (a)"
    path = multiclass_path(num_classes=num_classes, batch=batch, steps=2 + steps)
    g = torch.Generator(device=dev).manual_seed(1814)
    preds, target = path["inputs"](g, dev)
    coll, twin = path["make"](dev), path["make"](dev)
    order = [2 + i % steps for i in range(pass_updates)]
    reset_ledger()
    drain_spans()
    before = graph_stats()
    with ledger_observing():
        for i in range(2):
            coll.update(preds[i], target[i])
    warm = _graph_delta(before)
    for i in range(2):
        twin.update(preds[i], target[i])

    def twin_update(i):
        twin.update(preds[i], target[i])

    def coll_update(i):
        coll.update(preds[i], target[i])

    fenced_key = f"traced_fence_every_{A14_FENCE_EVERY}"
    times = {"untraced": [], "traced": [], fenced_key: []}
    spans = fenced = None
    n_fenced = []
    before = graph_stats()
    for _ in range(passes):
        times["untraced"].append(_timed_loop(dev, twin_update, order))
        with tracing(), ledger_observing(), strict_mode(max_new_executables=0) as stats:
            times["traced"].append(_timed_loop(dev, coll_update, order))
        traced_spans = drain_spans()
        spans = spans or traced_spans
        if stats.compiles or stats.retraces:
            raise AssertionError(f"{label}: {stats} under strict_mode after the warm-up")
        times["untraced"].append(_timed_loop(dev, twin_update, order))
        with tracing(fence_every=A14_FENCE_EVERY), strict_mode(max_new_executables=0):
            times[fenced_key].append(_timed_loop(dev, coll_update, order))
        fenced = drain_spans()
        n_fenced.append(sum(s.fenced for s in fenced))
        _compare_nested(label, state_to_numpy(coll), state_to_numpy(twin))  # bitwise, every state
    traced = _graph_delta(before)
    if traced["captures"] or traced["recaptures"]:
        raise AssertionError(f"{label}: {traced} graphs after the warm-up")
    # the graph counters are the process's: the twin's passes replay too
    if dev.type == "cuda" and traced["replays"] != 4 * passes * pass_updates:
        raise AssertionError(f"{label}: {traced['replays']} replays over {4 * passes} passes of {pass_updates}")
    if dev.type == "cuda" and set(n_fenced) != {pass_updates // A14_FENCE_EVERY}:
        raise AssertionError(f"{label}: {n_fenced} fenced spans a pass at fence_every={A14_FENCE_EVERY}")

    entries = executable_ledger()
    if len(entries) != warm["captures"] or any("analysis_error" in e for e in entries):
        raise AssertionError(f"{label}: {len(entries)} ledger entries for {warm['captures']} captures: {entries}")
    # the launches each entry lists carry the kernel phase's bound bytes of
    # bench config 2's two shapes (kernel_cases' stat_scores_c100 and
    # curve_c100_t64: S=3 rows of N = batch into C bins, and a shared index
    # of N = batch·C into C·(T + 1) bins with S=2 weight rows)
    def meta(*shape):
        return torch.empty(shape, device="meta")

    want = sorted([bound_bytes(meta(3, batch), meta(3, batch), num_classes),
                   bound_bytes(meta(batch * num_classes), meta(2, batch * num_classes), num_classes * 65)])
    got = sorted(launch["bytes"] for e in entries for launch in e["launches"])
    if dev.type == "cuda" and got != want:
        raise AssertionError(f"{label}: ledger launch bytes {got}, the kernel phase's bounds {want}")
    trace = write_perfetto(str(_out_dir() / "a14_trace.json"), spans)
    with open(trace) as fh:
        names = {e["name"] for e in json.load(fh)["traceEvents"] if e["ph"] != "M"}
    if names != {s.name for s in spans} or not names:
        raise AssertionError(f"{label}: the Perfetto file holds {sorted(names)}")
    prom = to_prometheus()
    missing = [f for f in A14_FAMILIES if f not in prom]
    if missing:
        raise AssertionError(f"{label}: Prometheus families {missing} missing")
    ms = {k: _spread(v) for k, v in times.items()}
    replay_rate = 1e3 / ms["traced"]["median"]
    return {"num_classes": num_classes, "batch": batch, "passes": passes, "updates_per_pass": pass_updates,
            "distinct_batches": steps, "order": "untraced, traced, untraced, fenced; per round",
            "warm_up_graphs": warm, "traced_graphs": traced, "ms_per_update": ms,
            "traced_over_untraced_median": ms["traced"]["median"] / ms["untraced"]["median"],
            "fenced_over_untraced_median": ms[fenced_key]["median"] / ms["untraced"]["median"],
            "spans_per_update": len(spans) / pass_updates, "fenced_spans_per_pass": n_fenced,
            "phase_totals": phase_totals(spans), "strict": {"compiles": 0, "retraces": 0, "host_syncs": 0,
                                                           "guard": "disallow"},
            "states_bitwise_untraced_twin": True,
            "ledger": [{k: e.get(k) for k in ("key", "flops", "bytes_accessed", "input_bytes", "state_bytes",
                                               "output_bytes", "launches", "launch_bytes", "compiles", "retraces")}
                       for e in entries],
            "kernel_phase_bound_bytes": want, "perfetto": trace.rsplit("/", 2)[-2:], "perfetto_names": sorted(names),
            "prometheus_families": list(A14_FAMILIES), "prometheus_lines": prom.count("\n"),
            "rooflines_at_replay_rate": kernel_rooflines(replay_rate), "replays_per_s": replay_rate, "card": card}


def _a14_guard_faults(dev, num_classes: int, batch: int) -> dict:
    """(b) What the guard and the budgets must catch on the card (JAX
    tests/test_strict_mode.py:63,74,83): an .item() on a state, a new batch
    size against a warm graph (named through describe_key), and
    max_retraces=1 letting that change through. Then whether a host-to-device
    copy is refused too, from pageable memory and asynchronously from
    pinned memory (recorded, not held)."""
    import torch

    from torchmetrics_tpu_torch.classification import MulticlassAccuracy
    from torchmetrics_tpu_torch.debug import StrictModeViolation, strict_mode

    label = "a14 (b)"
    path = multiclass_path(num_classes=num_classes, batch=batch, steps=3)
    g = torch.Generator(device=dev).manual_seed(1815)
    preds, target = path["inputs"](g, dev)
    small_p, small_t = preds[2, : batch - 24], target[2, : batch - 24]

    def warm_accuracy():
        m = MulticlassAccuracy(num_classes=num_classes, average="micro", validate_args=False, device=dev)
        for i in range(2):
            m.update(preds[i], target[i])
        return m

    out = {}
    m = warm_accuracy()
    if dev.type == "cuda":
        try:
            with strict_mode():
                m.tp.sum().item()
        except StrictModeViolation as err:
            out["item_on_state"] = str(err)[:160]
        else:
            raise AssertionError(f"{label}: .item() on a state under strict_mode() was not refused")
    messages = {}
    for name, owner in (("lone", m), ("collection", path["make"](dev))):
        if name == "collection":
            for i in range(2):
                owner.update(preds[i], target[i])
        try:
            with strict_mode():
                owner.update(small_p, small_t)
        except StrictModeViolation as err:
            messages[name] = str(err).split(" (graph key=")[0]
        else:
            if dev.type == "cuda":
                raise AssertionError(f"{label}: a new batch size under strict_mode() was not refused ({name})")
    if dev.type == "cuda" and not all("MulticlassAccuracy" in v for v in messages.values()):
        raise AssertionError(f"{label}: the violations do not name the metric: {messages}")
    out["new_batch_size"] = messages
    m = warm_accuracy()
    with strict_mode(max_retraces=1) as stats:
        m.update(small_p, small_t)
    if dev.type == "cuda" and (stats.retraces, stats.new_executables) != (1, 0):
        raise AssertionError(f"{label}: max_retraces=1 saw {stats}")
    out["max_retraces_1"] = {"retraces": stats.retraces, "new_executables": stats.new_executables}
    host = torch.ones(4)
    pinned = host.pin_memory() if dev.type == "cuda" else host
    for name, copy in (("pageable_h2d_copy", lambda: host.to(dev)),
                       ("pinned_async_h2d_copy", lambda: pinned.to(dev, non_blocking=True))):
        try:
            with strict_mode():
                copy()
            out[name] = "not refused"
        except StrictModeViolation as err:
            out[name] = "refused: " + str(err)[:120]
    return out


def _a14_tenant_churn(dev, tenants: int, rows: int, num_classes: int, updates: int) -> dict:
    """(c) tenant_fleet's classifier stack at its capacity: a 1,000-tenant
    TenantStack of MulticlassAccuracy(1000, macro) in 1,024 slots, captured
    with the ledger armed, then add_tenant/remove_tenant within the
    capacity with updates between, under strict_mode(max_new_executables=0)
    and the default guard (JAX tests/test_multitenant.py:281-295): no
    capture, no synchronising read; the ledger renders the stacked graph
    with its slot count (:318)."""
    import torch

    from torchmetrics_tpu_torch import TenantStack
    from torchmetrics_tpu_torch._capture import graph_stats
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy
    from torchmetrics_tpu_torch.debug import strict_mode
    from torchmetrics_tpu_torch.observability import executable_ledger, ledger_observing, reset_ledger

    label = "a14 (c)"
    g = torch.Generator(device=dev).manual_seed(1816)
    stack = TenantStack(MulticlassAccuracy(num_classes=num_classes, average="macro", device=dev),
                        tenants=range(tenants))
    feed = [(torch.randn(stack.slots, rows, num_classes, generator=g, device=dev),
             torch.randint(0, num_classes, (stack.slots, rows), generator=g, device=dev)) for _ in range(2)]
    reset_ledger()
    with ledger_observing():
        stack.update(*feed[0])
    (entry,) = executable_ledger() if dev.type == "cuda" else [None]
    free = tenants
    stack.add_tenant(free)  # the churn's first moves, outside the guard
    stack.remove_tenant(free)
    before = graph_stats()
    t0 = time.perf_counter()
    with strict_mode(max_new_executables=0) as stats:
        for k in range(updates):
            stack.add_tenant(free + k)
            stack.update(*feed[k % 2])
            stack.remove_tenant(k)
            stack.update(*feed[(k + 1) % 2])
    _sync(dev)
    churn_s = time.perf_counter() - t0
    delta = _graph_delta(before)
    if delta["captures"] or stats.compiles:
        raise AssertionError(f"{label}: churn within the capacity captured: {delta}, {stats}")
    if dev.type == "cuda" and delta["replays"] != 2 * updates:
        raise AssertionError(f"{label}: {delta['replays']} replays for {2 * updates} stacked updates")
    want = f"update[TenantStack[MulticlassAccuracy]×{stack.slots}]"
    if entry is not None and entry["key"] != want:
        raise AssertionError(f"{label}: the ledger renders {entry['key']!r}, not {want!r}")
    return {"tenants": tenants, "slots": stack.slots, "rows": rows, "num_classes": num_classes,
            "churn_rounds": updates, "graphs": delta, "strict": {"compiles": stats.compiles, "host_syncs": 0},
            "ms_per_churn_round": churn_s / updates * 1e3, "ledger_key": None if entry is None else entry["key"],
            "ledger_entry": None if entry is None else {k: entry[k] for k in ("flops", "bytes_accessed",
                                                                              "launches", "tenant_slots")}}


def _a14_autotune(dev, num_classes: int, batch: int, feed_steps: int, strict_updates: int) -> dict:
    """(d) Bench config 2 tuned cold at world 1 (the wire dimension
    skipped, JAX tests/test_ledger_autotune.py:291) with a ProfileCache
    under chiprun_out/, then warm: no observation, no measurement, one
    cache hit; the winner's metric captures its own graphs over its first
    updates, and ``strict_updates`` more run under
    strict_mode(max_new_executables=0)."""
    import torch

    from torchmetrics_tpu_torch._capture import graph_stats
    from torchmetrics_tpu_torch.debug import strict_mode
    from torchmetrics_tpu_torch.observability import Autotuner, ProfileCache
    from torchmetrics_tpu_torch.observability.autotune import _TUNE_STATS

    label = "a14 (d)"
    path = multiclass_path(num_classes=num_classes, batch=batch, steps=max(feed_steps, strict_updates + 64))
    g = torch.Generator(device=dev).manual_seed(1817)
    preds, target = path["inputs"](g, dev)
    feed = [(preds[i], target[i]) for i in range(feed_steps)]
    cache_path = _out_dir() / "a14_profile.json"
    if cache_path.exists():
        cache_path.unlink()
    t0 = time.perf_counter()
    cold = Autotuner(ProfileCache(str(cache_path)), observe_windows=2, steps_per_window=32).tune(
        lambda: path["make"](dev), feed, world=1)
    cold_s = time.perf_counter() - t0
    counts = dict(_TUNE_STATS)
    t0 = time.perf_counter()
    warm = Autotuner(ProfileCache(str(cache_path)), observe_windows=2, steps_per_window=32).tune(
        lambda: path["make"](dev), feed, world=1)
    warm_s = time.perf_counter() - t0
    activity = {k: _TUNE_STATS[k] - counts[k] for k in counts}
    if (cold.source, warm.source, warm.windows_observed) != ("observed", "cache", 0) or activity != {
            "observations": 0, "measurements": 0, "cache_hits": 1, "cache_misses": 0} or warm.config != cold.config:
        raise AssertionError(f"{label}: cold {cold.source}, warm {warm.source} {warm.windows_observed} windows, "
                             f"activity {activity}")
    handle = warm.config.wrap(path["make"](dev))
    first = 1 + max(warm.config.window, 1)  # group discovery, then one window: the winner's own captures
    before = graph_stats()
    for i in range(first):
        handle.update(preds[i], target[i])
    if hasattr(handle, "flush"):
        handle.flush()
    own = _graph_delta(before)
    before = graph_stats()
    with strict_mode(max_new_executables=0, max_retraces=0) as stats:
        for i in range(first, first + strict_updates):
            handle.update(preds[i], target[i])
        if hasattr(handle, "flush"):
            handle.flush()
    after = _graph_delta(before)
    if after["captures"] or stats.compiles:
        raise AssertionError(f"{label}: the warm run captured after its first updates: {after}")
    return {"config": warm.config.as_dict(), "cold_seconds": cold_s, "warm_seconds": warm_s,
            "candidates": [m["config"] for m in cold.measurements],
            "step_ms": [m["step_s"] * 1e3 for m in cold.measurements],
            "winner_step_ms_warm": next(m["step_s_warm"] for m in cold.measurements if "step_s_warm" in m) * 1e3,
            "observation": {k: cold.observation[k] for k in ("windows", "steps_per_window", "scan_fraction",
                                                             "retraces", "collectives_issued")},
            "warm": {"windows_observed": warm.windows_observed, "activity": activity,
                     "own_graphs_first_updates": own, "strict_updates": strict_updates, "graphs_after": after},
            "profile_cache": "chiprun_out/a14_profile.json"}


def _a14_degrade_budget(card: str, dev, windows: int, **soak) -> dict:
    """(e) The chaos soak (phase a13) over ``windows`` windows, with the
    schedule of seed ``A14_SOAK_SEED``, under
    strict_mode(transfer_guard=None, max_degraded_syncs=...) (JAX
    tests/parallel/test_elastic_sync.py:186-200): counted once with no
    budget to speak of, which gives N; then at budget N, where
    StrictStats.degraded_syncs must be N (elastic_stats' count, and the
    registry's elastic.* equal elastic_stats()); then at N - 1, which must
    raise. Returns the record and the bincount launches."""
    from torchmetrics_tpu_torch.debug import StrictModeViolation, strict_mode
    from torchmetrics_tpu_torch.observability import REGISTRY
    from torchmetrics_tpu_torch.ops.bincount import weighted_bincount
    from torchmetrics_tpu_torch.parallel import elastic_stats

    label = "a14 (e)"
    launches = 0
    with strict_mode(transfer_guard=None, max_degraded_syncs=10 ** 9) as counted:
        record, _ = run_imagenet_chaos_soak(card, dev, windows=windows, **soak)
    launches += weighted_bincount.launches
    n = counted.degraded_syncs
    with strict_mode(transfer_guard=None, max_degraded_syncs=n) as stats:
        record, _ = run_imagenet_chaos_soak(card, dev, windows=windows, **soak)
    launches += weighted_bincount.launches
    es = elastic_stats()
    registry = {k[len("elastic."):]: int(v) for k, v in REGISTRY.as_dict("elastic.").items()}
    if stats.degraded_syncs != n or es["degraded_syncs"] != n or not n:
        raise AssertionError(f"{label}: {stats.degraded_syncs} degraded syncs under the budget {n}; "
                             f"elastic_stats {es['degraded_syncs']}")
    if registry != {k: v for k, v in es.items() if k != "last_coverage"}:
        raise AssertionError(f"{label}: the registry's elastic.* {registry} != elastic_stats() {es}")
    try:
        with strict_mode(transfer_guard=None, max_degraded_syncs=n - 1):
            run_imagenet_chaos_soak(card, dev, windows=windows, **soak)
    except StrictModeViolation as err:
        refused = str(err)[:200]
    else:
        raise AssertionError(f"{label}: budget {n - 1} let {n} degraded syncs through")
    launches += weighted_bincount.launches
    return {"windows": windows, "seed": soak.get("seed"), "full_windows": record["full_windows"],
            "degraded_windows": record["degraded_windows"], "degraded_syncs": n,
            "degraded_syncs_of_the_preempted_round": n - 2 * record["degraded_windows"],
            "strict_degraded_syncs": stats.degraded_syncs, "coverage_fraction": stats.coverage_fraction,
            "elastic_stats": es, "elastic_registry_equals_view": True, "budget_n_minus_1": refused}, launches


def run_a14(card: str, dev, num_classes: int = 100, batch: int = 1024, steps: int = 200,
            passes: int = A14_PASSES, pass_updates: int = A14_PASS_UPDATES, tenants: int = 1000, tenant_rows: int = 64, tenant_classes: int = 1000, churn: int = 10,
            tune_feed: int = 64, soak_windows: int = 40, soak: dict = None) -> tuple:
    """Phase a14 (observability and debug) on bench config 2, parts (a)-(e),
    each printed as its own line. Returns the bincount launches."""
    from torchmetrics_tpu_torch.observability import disable_ledger, disable_tracing, reset_ledger
    from torchmetrics_tpu_torch.ops.bincount import weighted_bincount

    t_phase = time.perf_counter()
    launches = 0
    parts = (
        ("a", lambda: _a14_traced_main_path(card, dev, num_classes, batch, steps, passes, pass_updates)),
        ("b", lambda: _a14_guard_faults(dev, num_classes, batch)),
        ("c", lambda: _a14_tenant_churn(dev, tenants, tenant_rows, tenant_classes, churn)),
        ("d", lambda: _a14_autotune(dev, num_classes, batch, tune_feed, steps)),
    )
    for part, run in parts:
        _zero_kernel_counts()
        t0 = time.perf_counter()
        record = run()
        _sync(dev)
        record["seconds"] = time.perf_counter() - t0
        record["kernel_launches"] = weighted_bincount.launches
        launches += weighted_bincount.launches
        emit({"phase": "a14", "part": part, **record})
    t0 = time.perf_counter()
    _zero_kernel_counts()
    record, soak_launches = _a14_degrade_budget(card, dev, soak_windows, **{"seed": A14_SOAK_SEED, **(soak or {})})
    record.update(seconds=time.perf_counter() - t0, kernel_launches=soak_launches)
    launches += soak_launches
    emit({"phase": "a14", "part": "e", **record})
    disable_tracing()
    disable_ledger()
    reset_ledger()
    emit({"phase": "a14", "part": "total", "seconds": time.perf_counter() - t_phase, "kernel_launches": launches,
          "card": card})
    return launches


# ---------------------------------------------------------------------------
# phase dist_sync: state sync over torch.distributed
# ---------------------------------------------------------------------------

DIST_TIMEOUT_S = 60  # every process group's collective timeout
DIST_DEADLINE_S = 480  # the two ranks of part (b) must have ended by then


def aggregation_path(steps: int = 8, batch: int = 4096) -> dict:
    """The five aggregators in one collection, over multiples of 1/8 (values
    in [-8, 8), weights in [1/8, 2)), so every float sum is exact in any
    order and a synced state equals the single-process one bitwise. In a
    two-rank run, rank 1 gives CatMetric no rows (``cat_rank0_only``)."""
    def make(device):
        from torchmetrics_tpu_torch import CatMetric, MaxMetric, MeanMetric, MetricCollection, MinMetric, SumMetric
        return MetricCollection({"sum": SumMetric(device=device), "mean": MeanMetric(device=device),
                                 "max": MaxMetric(device=device), "min": MinMetric(device=device),
                                 "cat": CatMetric(device=device)})

    def inputs(g, dev):
        import torch
        values = torch.randint(-64, 64, (steps, batch), generator=g, device=dev).to(torch.float32) / 8
        weights = torch.randint(1, 16, (steps, batch), generator=g, device=dev).to(torch.float32) / 8
        return values, {"weight": weights}

    return {"make": make, "inputs": inputs, "steps": steps, "cat_rank0_only": True}


def pearson_retrieval_path(steps: int = 20, batch: int = 4096, queries: int = 500) -> dict:
    """PearsonCorrCoef and RetrievalMAP in one collection, over float32
    scores independent of the 0/1 targets (about 10% relevant) and query ids
    in [0, 500), so each query's rows are split between the ranks. The MAP's
    cat states gather in rank order, the single process's row order:
    bitwise. Pearson's ``dist_reduce_fx=None`` moments come back as
    ``(world,)`` stacks, which ``_final_aggregation`` merges
    (``moment_members``) before they are held against one process's moments
    within ``float_tol`` 1e-5 relative: the merge adds the ranks' moments in
    another arithmetic than one process's running update. The cross moment
    of independent inputs cancels to near zero, so its error is taken
    relative to the size of its terms (``_check_synced``)."""
    def make(device):
        from torchmetrics_tpu_torch import MetricCollection
        from torchmetrics_tpu_torch.regression import PearsonCorrCoef
        from torchmetrics_tpu_torch.retrieval import RetrievalMAP
        return MetricCollection({"pearson": PearsonCorrCoef(device=device), "map": RetrievalMAP(device=device)})

    def inputs(g, dev):
        import torch
        preds = torch.rand(steps, batch, generator=g, device=dev)
        target = (torch.rand(steps, batch, generator=g, device=dev) < 0.1).to(torch.int64)
        indexes = torch.randint(0, queries, (steps, batch), generator=g, device=dev)
        return preds, target, {"indexes": indexes}

    return {"make": make, "inputs": inputs, "steps": steps, "moment_members": ("pearson",), "float_tol": 1e-5}


def sketch_dist_path(steps: int = 8, batch: int = 4096) -> dict:
    """ApproxQuantile, ApproxAUROC and ApproxFrequency in one collection,
    each updated with its own arguments (``member_args``): latencies,
    (score, click) pairs and Zipf item ids. A merged sketch is not the sketch
    of all the data in one process, so both ranks' synced states (and pure
    reduced states) are held bitwise against ``merge_states`` of the two
    ranks' local states (``merge_check``), which rank 0 makes again from the
    same inputs."""
    def make(device):
        from torchmetrics_tpu_torch import ApproxAUROC, ApproxFrequency, ApproxQuantile, MetricCollection
        return MetricCollection({"quantile": ApproxQuantile(q=(0.5, 0.99), compression=128, device=device),
                                 "auroc": ApproxAUROC(capacity=4096, device=device),
                                 "frequency": ApproxFrequency(track=tuple(range(100)), width=4096, device=device)})

    def inputs(g, dev):
        import torch
        latencies = _latencies(g, dev, (steps, batch))
        scores, clicks = _ctr_inputs(g, dev, steps, batch)
        items = torch.minimum(torch.floor(1.0 / torch.rand(steps, batch, generator=g, device=dev)), torch.tensor(
            1e6, device=dev)).to(torch.int32)
        return {"quantile": (latencies,), "auroc": (scores, clicks), "frequency": (items,)}

    def member_args(name, inputs, i):
        return tuple(x[i] for x in inputs[name])

    return {"make": make, "inputs": inputs, "steps": steps, "member_args": member_args, "merge_check": True}


def _merged_moments(states: dict, members) -> dict:
    """Each named member's synced ``(world,)`` moment stacks merged as its
    compute merges them, as numpy."""
    import torch

    from torchmetrics_tpu_torch.functional.regression.pearson import _final_aggregation
    names = ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")
    out = dict(states)
    for member in members:
        merged = _final_aggregation(*(torch.from_numpy(states[member][k]) for k in names))
        out[member] = {k: v.numpy() for k, v in zip(names, merged)}
    return out


def _dist_paths() -> list:
    return [("bench_config2", multiclass_path(num_classes=100, batch=1024, steps=200)),
            ("imagenet1k_exact", imagenet1k_exact_path()),
            ("aggregation", aggregation_path()),
            ("pearson_retrieval", pearson_retrieval_path()),
            ("sketches", sketch_dist_path())]


def _drive(coll, path: dict, inputs, steps, pure: bool, cat_steps=()):
    """Update ``coll`` (or its pure state) with ``steps``; the aggregation
    path's CatMetric takes only those also in ``cat_steps``; a path with
    ``member_args`` updates each member with its own arguments."""
    if "member_args" in path:
        state = coll.init_state() if pure else None
        for i in steps:
            for name, m in coll.items(keep_base=True, copy_state=False):
                args = path["member_args"](name, inputs, i)
                if pure:
                    state[name] = m.update_state(state[name], *args)
                else:
                    m.update(*args)
        return state
    if path.get("cat_rank0_only"):
        values, extra = inputs
        state = coll.init_state() if pure else None
        for i in steps:
            for name, m in coll.items(keep_base=True, copy_state=False):
                if name == "cat" and i not in cat_steps:
                    continue
                args = (values[i], extra["weight"][i]) if name == "mean" else (values[i],)
                if pure:
                    state[name] = m.update_state(state[name], *args)
                else:
                    m.update(*args)
        return state
    preds, target, extra = _step_inputs(inputs)
    state = coll.init_state() if pure else None
    for i in steps:
        kw = {k: v[i] for k, v in extra.items()}
        if pure:
            state = coll.update_state(state, preds[i], target[i], **kw)
        else:
            coll.update(preds[i], target[i], **kw)
    return state


def _rows_equal(got, want) -> bool:
    import numpy as np
    got = np.concatenate(got) if isinstance(got, list) and got else got
    want = np.concatenate(want) if isinstance(want, list) and want else want
    if isinstance(got, list) or isinstance(want, list):
        return isinstance(got, list) and isinstance(want, list)  # both empty
    return got.dtype == want.dtype and got.shape == want.shape and bool((got == want).all())


def _check_synced(label: str, how: str, got: dict, want: dict, cat_states: set, tol: float = VALUE_TOL) -> dict:
    """``got`` against ``want`` ({member: {state: numpy}}): cat and integer
    states bitwise; float states within ``tol`` (1e-6 by default), relative
    to the value above 1 (each rank sums its half, then the halves are
    added: another order than one process's). A cross moment ``corr_xy``,
    the sum of dx*dy, is taken relative to sqrt(var_x * var_y), the
    Cauchy-Schwarz bound on it and the size of its terms: it cancels to near
    zero when x and y are independent, and its rounding does not."""
    import numpy as np
    worst = 0.0
    for member, states in want.items():
        for key, w in states.items():
            g = got[member][key]
            if (member, key) in cat_states or isinstance(w, list) or not np.issubdtype(w.dtype, np.floating):
                if not _rows_equal(g, w):
                    raise AssertionError(f"dist_sync {label}: {how} state {member}.{key} differs bitwise")
                continue
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(f"dist_sync {label}: {how} state {member}.{key} dtype or shape differs")
            scale = np.maximum(1.0, np.abs(w))
            if key == "corr_xy":
                scale = np.maximum(scale, np.sqrt(states["var_x"].astype(np.float64) * states["var_y"]))
            err = float(np.max(np.abs(g.astype(np.float64) - w) / scale)) if w.size else 0.0
            worst = max(worst, err)
            if not err <= tol:
                raise AssertionError(f"dist_sync {label}: {how} state {member}.{key} differs by {err}")
    return {"float_state_max_rel_err": worst, "float_tol": tol}


def _digest(states: dict) -> str:
    import hashlib

    import numpy as np
    h = hashlib.sha256()
    for member in sorted(states):
        for key in sorted(states[member]):
            v = states[member][key]
            for part in (v if isinstance(v, list) else [v]):
                h.update(f"{member}.{key}{part.dtype}{part.shape}".encode())
                h.update(np.ascontiguousarray(part).tobytes())
    return h.hexdigest()


def _timed(fn):
    """(result, host ms) of ``fn()`` between two synchronisations of the card."""
    import torch
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


FID_FEATURES = 2048  # FID's pool3 width: its SUM states are 2 x (2048 + 2048^2) float32, 33.6 MB
FID_SAMPLES = 1024  # per side and rank
PREEMPT_TIMEOUT_S = 2.0  # rank 0's HostSync watchdog in the preempted-rank part
PREEMPT_SLEEP_S = 12.0  # rank 1 stalls past rank 0's two degraded syncs, then exits


def _acc_batch(rank: int, dev) -> tuple:
    import torch

    g = torch.Generator(device=dev).manual_seed(191 + rank)
    return (torch.softmax(torch.randn((4096, 100), generator=g, device=dev), -1),
            torch.randint(0, 100, (4096,), generator=g, device=dev))


def _fid_sums(rank: int, dev, policy=None):
    """FID over identity features (its SUM states at 2,048 features) and an
    int32-state accuracy, on this rank's seeded data."""
    import torch

    import torchmetrics_tpu_torch as tm

    g = torch.Generator(device=dev).manual_seed(181 + rank)
    fid = tm.FrechetInceptionDistance(feature=lambda x: x, device=dev, sync_policy=policy)
    fid.update(torch.randn((FID_SAMPLES, FID_FEATURES), generator=g, device=dev), real=True)
    fid.update(0.5 * torch.randn((FID_SAMPLES, FID_FEATURES), generator=g, device=dev) + 0.25, real=False)
    acc = tm.MulticlassAccuracy(num_classes=100, device=dev, sync_policy=policy)
    acc.update(*_acc_batch(rank, dev))
    return fid, acc


def _flat_sums(states: dict):
    import torch

    return torch.cat([states[k].reshape(-1).double() for k in sorted(states)])


def _chunk_absmax(flat, chunk: int = 256):
    import torch

    pad = (-flat.numel()) % chunk
    return torch.cat([flat, flat.new_zeros(pad)]).abs().reshape(-1, chunk).amax(1)


def _dist_a13(rank: int, world: int, dev, out_dir) -> dict:
    """Part (c) of dist_sync, on the spawned gloo ranks: the quantized sync of
    FID's SUM states (16 and 8 bits; Metric.sync twice for the residual
    carry, and reduce_state_in_graph), a transient timeout over real
    collectives, and a preempted rank 1 (its checkpoint written, then a
    stall past rank 0's timeouts, then exit). Rank 0 checks every bound;
    returns this rank's record."""
    import pickle

    import torch

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.ops.bincount import weighted_bincount
    from torchmetrics_tpu_torch.parallel import (ChaosSchedule, ChaosSync, CoverageError, ElasticSync, HostSync,
                                                 Reduction, SyncPolicy, checkpoint_metric, elastic_stats,
                                                 merge_checkpoint, reduce_state_in_graph, reset_elastic_stats,
                                                 reset_wire_stats, wire_stats)

    label = "dist_sync a13"
    rec = {"quantized": {}}
    launches = weighted_bincount.launches
    fid, acc = _fid_sums(rank, dev)
    names = [k for k in fid._defaults]
    local = {k: getattr(fid, k) for k in names}
    flats = HostSync().sync_tensor(_flat_sums(local).float(), Reduction.NONE).double()  # every rank's local bucket
    exact_sum = flats.sum(0)
    reset_wire_stats()
    fid.sync()
    exact_bytes = sum(wire_stats()["last_sync"][k] for k in ("bytes_reduced", "bytes_gathered"))
    fid.unsync()
    acc_ref = {k: v.clone() for k, v in acc.metric_state.items()}
    acc.sync()
    acc_synced = {k: v.clone() for k, v in acc.metric_state.items()}
    acc.unsync()
    for bits, qmax in ((16, 32767), (8, 127)):
        policy = SyncPolicy(quantize_bits=bits)
        q_fid, q_acc = _fid_sums(rank, dev, policy)
        rounds, wire = [], []
        for _ in range(2):
            reset_wire_stats()
            _, ms = _timed(q_fid.sync)
            wire.append(sum(wire_stats()["last_sync"][k] for k in ("bytes_reduced", "bytes_gathered")))
            rounds.append((_flat_sums({k: getattr(q_fid, k) for k in names}), ms))
            q_fid.unsync()
        reset_wire_stats()
        pure, pure_ms = _timed(lambda: reduce_state_in_graph(q_fid.as_state(), policy=policy))
        pure_wire = dict(wire_stats()["last_sync"])
        q_acc.sync()
        scales = torch.stack([_chunk_absmax(f) for f in flats]) / qmax  # (world, chunks)
        n = exact_sum.numel()
        slack = 1e-6 * exact_sum.abs()  # float32 rounding of the sums themselves
        eager_bound = (scales.sum(0) / 2).repeat_interleave(256)[:n] + slack
        s_in = scales.amax(0)
        s_out = (_chunk_absmax(exact_sum) + world * s_in / 2) / qmax
        pure_bound = (world * s_in / 2 + s_out / 2).repeat_interleave(256)[:n] + slack
        first, second = rounds[0][0], rounds[1][0]
        errs = {"eager_round1": (first - exact_sum).abs(), "eager_round2": (second - exact_sum).abs(),
                "eager_mean_of_rounds": ((first + second) / 2 - exact_sum).abs(),
                "pure": (_flat_sums({k: pure[k] for k in names}) - exact_sum).abs()}
        # the two rounds' mean errs by the second round's residual alone, whose
        # scales come from x plus the first residual: at most half a step larger
        limits = {"eager_round1": eager_bound, "eager_round2": 2 * eager_bound,
                  "eager_mean_of_rounds": eager_bound / 2 * (1 + 1 / qmax) + slack, "pure": pure_bound}
        for what, err in errs.items():
            if not bool((err <= limits[what]).all()):
                worst = int(torch.argmax(err - limits[what]))
                raise AssertionError(f"{label}: {bits}-bit {what} element {worst} off by {float(err[worst])}, "
                                     f"bound {float(limits[what][worst])}")
        for k, v in acc_synced.items():
            if not torch.equal(getattr(q_acc, k), v):
                raise AssertionError(f"{label}: {bits}-bit policy changed the int32 state {k}")
        rec["quantized"][bits] = {
            "eager_wire_bytes": wire, "exact_wire_bytes": exact_bytes, "eager_sync_ms": [r[1] for r in rounds],
            "pure_ms": pure_ms, "pure_wire": {k: pure_wire[k] for k in ("bytes_reduced", "bytes_gathered",
                                                                        "collectives_issued")},
            "max_err": {k: float(v.max()) for k, v in errs.items()},
            "max_err_over_bound": {k: float((errs[k] / limits[k]).max()) for k in errs}}
    rec["quantized"]["elements"] = int(exact_sum.numel())
    del flats, exact_sum, fid, local

    # a transient timeout in round 1: one retry; its recovery barrier is a real gather
    reset_elastic_stats()
    chaos = ChaosSync(HostSync(timeout_s=5), ChaosSchedule({1: [("timeout", 1)]}))
    es = ElasticSync(chaos, SyncPolicy(retry_attempts=1, backoff_base_s=0.01))
    for rnd in range(2):
        chaos.advance_round()
        _, ms = _timed(lambda: acc.sync(sync_backend=es))
        for k, v in acc_synced.items():
            if not torch.equal(getattr(acc, k), v):
                raise AssertionError(f"{label}: round {rnd} with a transient timeout: {k} differs bitwise")
        if es.last_coverage.fraction != 1.0:
            raise AssertionError(f"{label}: round {rnd} coverage {es.last_coverage}")
        acc.unsync()
        rec[f"transient_round{rnd}_ms"] = ms
    stats = elastic_stats()
    if not stats["retries"] or not stats["recoveries"] or stats["degraded_syncs"] or chaos.poisoned:
        raise AssertionError(f"{label}: the transient timeout: {stats}, poisoned {chaos.poisoned}")
    rec["transient"] = {"elastic_stats": stats, "states": "bitwise the fault-free round", "coverage": 1.0}
    torch.distributed.barrier()

    # a preempted rank 1: it checkpoints, stalls past rank 0's timeouts, and exits
    ckpt = out_dir / "rank1_a13.ckpt"
    if rank == 1:
        tmp = out_dir / "rank1_a13.tmp"
        tmp.write_bytes(pickle.dumps(checkpoint_metric(acc)))
        tmp.rename(ckpt)
        rec["launches"] = weighted_bincount.launches - launches
        time.sleep(PREEMPT_SLEEP_S)
        rec["preempted"] = "checkpointed, stalled, exited"
        return rec
    t0 = time.monotonic()
    try:
        es = ElasticSync(HostSync(timeout_s=PREEMPT_TIMEOUT_S), SyncPolicy(retry_attempts=0))
        acc.sync(sync_backend=es)
        cov = es.last_coverage
        for k, v in acc_ref.items():
            if not torch.equal(getattr(acc, k), v):
                raise AssertionError(f"{label}: the degraded sync changed {k}")
        acc.unsync()
    except Exception as e:  # gloo's own error when the peer exited first
        raise AssertionError(f"{label}: rank 0's degraded sync raised {type(e).__name__}: {e}") from e
    if (cov.ranks_present, cov.ranks_expected, cov.fraction) != (1, 2, 0.5):
        raise AssertionError(f"{label}: degraded coverage {cov}")
    try:
        acc.sync(sync_backend=ElasticSync(HostSync(timeout_s=PREEMPT_TIMEOUT_S),
                                          SyncPolicy(retry_attempts=0, min_coverage=0.75)))
        raise AssertionError(f"{label}: min_coverage=0.75 did not raise at coverage 1/2")
    except CoverageError as e:
        coverage_error = str(e)
    if acc._is_synced or any(not torch.equal(getattr(acc, k), v) for k, v in acc_ref.items()):
        raise AssertionError(f"{label}: the refused sync left the state changed")
    degrade_s = time.monotonic() - t0
    while not ckpt.exists():
        time.sleep(0.05)
    merge_checkpoint(acc, pickle.loads(ckpt.read_bytes()))
    one = tm.MulticlassAccuracy(num_classes=100, device=dev)
    for r in range(world):
        one.update(*_acc_batch(r, dev))
    for k, v in one.metric_state.items():
        if not torch.equal(getattr(acc, k), v):
            raise AssertionError(f"{label}: after merging rank 1's checkpoint {k} is not one process's")
    rec["preempt"] = {"degraded_coverage": cov.as_dict(), "min_coverage_0.75": "CoverageError",
                      "coverage_error": coverage_error[:200], "seconds_for_both_syncs": degrade_s,
                      "merged": "bitwise one process over all the data", "peer_error": None}
    rec["launches"] = weighted_bincount.launches - launches
    return rec


def _dist_rank(rank: int, world: int, init_file: str, out_dir: str, device: str = "cuda") -> None:
    """One rank of part (b): join the gloo group, update this rank's half of
    each path, sync (``Metric.sync`` through ``HostSync`` and
    ``MetricCollection.reduce_state``) and compute; rank 0 then runs each
    path in one process over all the data and compares. Writes
    ``rank{r}.json``, or ``rank{r}.err`` with the traceback. ``device``
    other than ``cuda`` is for a rehearsal on the CPU."""
    import datetime
    import pathlib
    import traceback

    import torch
    import torch.distributed as dist
    out = pathlib.Path(out_dir)
    try:
        if device == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
        from torchmetrics_tpu_torch.interop import state_to_numpy
        from torchmetrics_tpu_torch.ops.bincount import weighted_bincount
        from torchmetrics_tpu_torch.ops.tdigest import tdigest_compress_sorted
        from torchmetrics_tpu_torch.parallel import HostSync, NoSync, reset_wire_stats, wire_stats
        dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
        report = {"rank": rank, "paths": {}}
        for label, path in _dist_paths():
            g = torch.Generator(device=dev).manual_seed(1234)
            inputs = path["inputs"](g, dev)
            half = -(-path["steps"] // world)
            mine = range(rank * half, min((rank + 1) * half, path["steps"]))
            cat_steps = range(0, half)  # rank 0's: rank 1 gives CatMetric no rows
            coll = path["make"](dev)
            weighted_bincount.launches = tdigest_compress_sorted.launches = 0
            _drive(coll, path, inputs, mine, False, cat_steps)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            launches, tdigest_launches = weighted_bincount.launches, tdigest_compress_sorted.launches
            members = list(coll.items(keep_base=True))
            backends = {type(m.sync_backend).__name__ for _, m in members}
            synced = {}
            for name, m in members:
                m.sync()
                synced[name] = state_to_numpy(m)
                m.unsync()
            # the sync of every member, timed from a barrier, with its wire ledger
            dist.barrier()
            reset_wire_stats()
            _, sync_ms = _timed(lambda: [(m.sync(), m.unsync()) for _, m in members])
            stats = wire_stats()
            dist.barrier()
            values, compute_ms = _timed(coll.compute)
            state = _drive(coll, path, inputs, mine, True, cat_steps)
            reduced_np = state_to_numpy(coll.reduce_state(state))
            dist.barrier()
            reset_wire_stats()
            _, reduce_ms = _timed(lambda: coll.reduce_state(state))
            reduce_stats = wire_stats()
            wire = ("collectives_issued", "bytes_reduced", "bytes_gathered")
            row = {"launches": launches, "tdigest_launches": tdigest_launches, "backends": sorted(backends),
                   "steps": len(mine),
                   "sync_ms": sync_ms, "sync_wire": {k: stats[k] for k in wire},
                   "compute_ms": compute_ms, "reduce_state_ms": reduce_ms,
                   "reduce_state_wire": {k: reduce_stats[k] for k in wire},
                   "synced_digest": _digest(synced), "reduced_digest": _digest(reduced_np)}
            if rank == 0 and path.get("merge_check"):
                locals_, pure_locals = [], []
                for r in range(world):
                    theirs = range(r * half, min((r + 1) * half, path["steps"]))
                    local = path["make"](dev)
                    for _, m in local.items(keep_base=True, copy_state=False):
                        m._sync_backend = NoSync()
                    _drive(local, path, inputs, theirs, False, cat_steps)
                    locals_.append({n: m._tensor_state() for n, m in local.items(keep_base=True, copy_state=False)})
                    pure_locals.append(_drive(local, path, inputs, theirs, True, cat_steps))
                for route, got, per_rank in (("synced", synced, locals_), ("reduced", reduced_np, pure_locals)):
                    merged = {n: state_to_numpy(m.merge_states([loc[n] for loc in per_rank]))
                              for n, m in local.items(keep_base=True, copy_state=False)}
                    _compare_states(f"dist_sync {label}", f"{route} against merge_states", got, merged)
                row["stateful"] = row["pure"] = {"merge_states": "bitwise"}
                row["values"] = {k: _summary(v) for k, v in values.items()}
            elif rank == 0:
                ref = path["make"](dev)
                for _, m in ref.items(keep_base=True, copy_state=False):
                    m._sync_backend = NoSync()
                everything = range(path["steps"])
                _drive(ref, path, inputs, everything, False, cat_steps)
                ref_states = state_to_numpy(ref)
                cat_states = {(n, k) for n, m in members for k in m._list_states}
                moments, tol = path.get("moment_members", ()), path.get("float_tol", VALUE_TOL)
                row["stateful"] = _check_synced(label, "synced", _merged_moments(synced, moments), ref_states,
                                                cat_states, tol)
                ref_values = ref.compute()
                for key, want in ref_values.items():
                    _check_value(f"dist_sync {label}", f"{key} against one process", values[key], want, tol)
                ref_pure = state_to_numpy(_drive(ref, path, inputs, everything, True, cat_steps))
                row["pure"] = _check_synced(label, "reduced", _merged_moments(reduced_np, moments), ref_pure,
                                            cat_states, tol)
                row["values"] = {k: _summary(v) for k, v in values.items()}
            report["paths"][label] = row
            del coll, inputs, state, reduced_np, synced
        dist.barrier()
        (out / f"rank{rank}.json").write_text(json.dumps(report))
        # part (c) last: rank 1 leaves the group in its preempted-rank part
        (out / f"rank{rank}_a13.json").write_text(json.dumps(_dist_a13(rank, world, dev, out)))
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def dist_sync_one_rank_nccl(tmpdir: str, device: str = "cuda") -> tuple:
    """Part (a): NCCL at world size 1, in this process. The pure route
    (``MetricCollection.reduce_state``, ``Metric.reduce_state``) on
    bench_config2's collection and imagenet1k_exact's states, each timed
    once under ``torch.cuda.set_sync_debug_mode("error")`` (a host read
    raises), and ``HostSync.sync_tensor`` / ``sync_cat_padded`` called
    directly; every result bitwise equal to the unsynced state. Returns the
    phase's record and the bincount launches. ``device`` other than ``cuda``
    (a rehearsal on the CPU) runs the same over gloo."""
    import datetime

    import torch
    import torch.distributed as dist
    from torchmetrics_tpu_torch.buffers import CatBuffer
    from torchmetrics_tpu_torch.interop import state_to_numpy
    from torchmetrics_tpu_torch.ops.bincount import weighted_bincount
    from torchmetrics_tpu_torch.parallel import HostSync, Reduction
    dist.init_process_group("nccl" if device == "cuda" else "gloo", init_method=f"file://{tmpdir}/nccl_init",
                            world_size=1, rank=0, timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    out, launches = {"backend": dist.get_backend()}, 0
    try:
        for label, path in _dist_paths()[:2]:
            g = torch.Generator(device=dev).manual_seed(1234)
            inputs = path["inputs"](g, dev)
            coll = path["make"](dev)
            weighted_bincount.launches = 0
            state = _drive(coll, path, inputs, range(path["steps"]), True)
            _drive(coll, path, inputs, range(path["steps"]), False)
            torch.cuda.synchronize()
            launches += weighted_bincount.launches
            coll.reduce_state(state)  # NCCL sets its communicator up at the first collective
            member = next(m for _, m in coll.items(keep_base=True, copy_state=False))
            as_state = member.as_state()
            member.reduce_state(as_state)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                reduced, ms = _timed(lambda: coll.reduce_state(state))
                member_reduced = member.reduce_state(as_state)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            _compare_states(f"dist_sync {label}", "NCCL world-1 reduce_state", state_to_numpy(reduced),
                            state_to_numpy(state))
            _compare_states(f"dist_sync {label}", "NCCL world-1 Metric.reduce_state",
                            {"m": state_to_numpy(dict(member_reduced))}, {"m": state_to_numpy(dict(as_state))})
            if type(member_reduced).__name__ != "MetricState":
                raise AssertionError(f"dist_sync {label}: a MetricState came back as {type(member_reduced)}")
            out[label] = {"reduce_state_ms": ms, "sync_debug_mode": "error"}
            del state, reduced, coll, member, as_state, member_reduced, inputs
        hs = HostSync()
        x = torch.randn(1000, 100, device=dev)
        buf = CatBuffer.allocate(torch.randn(700, 1000, device=dev))
        for name, got, want in (
                ("sync_tensor sum", hs.sync_tensor(x, Reduction.SUM), x),
                ("sync_tensor cat", hs.sync_tensor(x, Reduction.CAT), x),
                ("sync_cat_padded", hs.sync_cat_padded(buf.buffer, buf.count), buf.materialize())):
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError(f"dist_sync: HostSync {name} at world size 1 is not the identity")
        out["hostsync_direct"] = "identity, bitwise"
    finally:
        dist.destroy_process_group()
    if not launches:
        raise AssertionError("dist_sync: the NCCL part launched the bincount kernel no time")
    return out, launches


def dist_sync_two_ranks_gloo(tmpdir: str, world: int = 2, device: str = "cuda") -> tuple:
    """Part (b): ``world`` ranks on the one card, spawned with
    ``torch.multiprocessing``, over gloo with CUDA tensors (NCCL refuses two
    ranks on one GPU). Joined with a deadline; ranks still running then are
    killed and the phase fails. Returns the phase's record and the ranks'
    kernel launches ({kernel: count})."""
    import pathlib

    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_dist_rank, args=(r, world, f"{tmpdir}/gloo_init", tmpdir, device))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DIST_DEADLINE_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    errors = [f.read_text() for f in sorted(pathlib.Path(tmpdir).glob("rank*.err"))]
    if errors or hung or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"dist_sync: ranks failed (hung: {len(hung)}, exit codes "
                             f"{[p.exitcode for p in procs]}):\n" + "\n".join(errors))
    reports = [json.loads((pathlib.Path(tmpdir) / f"rank{r}.json").read_text()) for r in range(world)]
    out, launches = {}, {"weighted_bincount": 0, "tdigest_compress": 0}
    for label in reports[0]["paths"]:
        rows = [rep["paths"][label] for rep in reports]
        for key in ("synced_digest", "reduced_digest"):
            if len({row[key] for row in rows}) != 1:
                raise AssertionError(f"dist_sync {label}: the ranks' {key.split('_')[0]} states differ")
        if any(row["backends"] != ["HostSync"] for row in rows):
            raise AssertionError(f"dist_sync {label}: backends {[row['backends'] for row in rows]}")
        launches["weighted_bincount"] += sum(row["launches"] for row in rows)
        launches["tdigest_compress"] += sum(row["tdigest_launches"] for row in rows)
        out[label] = {"launches_per_rank": [row["launches"] for row in rows],
                      "tdigest_launches_per_rank": [row["tdigest_launches"] for row in rows],
                      "steps_per_rank": [row["steps"] for row in rows],
                      **{k: [row[k] for row in rows] for k in ("sync_ms", "compute_ms", "reduce_state_ms")},
                      "sync_wire": rows[0]["sync_wire"], "reduce_state_wire": rows[0]["reduce_state_wire"],
                      "stateful": rows[0]["stateful"], "pure": rows[0]["pure"], "values": rows[0]["values"]}
    if not any(row["launches"] for rep in reports for row in rep["paths"].values()):
        raise AssertionError("dist_sync: no rank launched the bincount kernel")
    a13 = [json.loads((pathlib.Path(tmpdir) / f"rank{r}_a13.json").read_text()) for r in range(world)]
    launches["weighted_bincount"] += sum(rec["launches"] for rec in a13)
    out["a13"] = {"quantized_fid_sums": a13[0]["quantized"], "transient_timeout": a13[0]["transient"],
                  "transient_round_ms": [a13[0][f"transient_round{i}_ms"] for i in range(2)],
                  "preempted_rank": a13[0]["preempt"], "rank1": a13[1].get("preempted"),
                  "launches_per_rank": [rec["launches"] for rec in a13]}
    if device == "cuda" and not launches["tdigest_compress"]:
        raise AssertionError("dist_sync: no rank launched the t-digest compress kernel")
    return out, launches


# ---------------------------------------------------------------------------
# phase a15: ring attention, the expert all-to-all, the train template, plotting
# ---------------------------------------------------------------------------

# Llama-2-7B's published config (Meta's Llama-2-7b-hf config.json): the
# attention and MLP widths of part (a) and of part (b)'s second run
LLAMA2_7B = {"heads": 32, "head_dim": 128, "hidden": 4096, "ffn": 11008, "vocab": 32000, "context": 4096}
A15_EVAL = {"batch": 4, "steps": 3, "classes": 100, "cls_batch": 1024, "seed": 150}
A15_ATTN_TOL = 1e-5  # ring attention against full attention, float32, TF32 off
A15_BF16_TOL = 0.05
A15_VALUE_RTOL = 1e-6  # reduced float states and values against the world-1 run
A15_TRAIN_TOL = 1e-5  # the first step's loss and parameters against the one-process reference
# the JAX entry's widths (vocab 32, d_model 16, d_hidden 32, 2 microbatches) at
# the JAX test's batch and rate, 40 steps; then Llama-2-7B's MLP widths
DEMO_RUNS = {
    "jax_entry": {"vocab": 32, "d_model": 16, "d_hidden": 32, "batch": 8, "seq": 8, "lr": 1.0, "steps": 40},
    "llama2_7b_mlp": {"vocab": LLAMA2_7B["vocab"], "d_model": LLAMA2_7B["hidden"], "d_hidden": LLAMA2_7B["ffn"],
                      "batch": 8, "seq": 512, "lr": 0.1, "steps": 3},
}
A15_DEADLINE_S = 600
PLOT_ERROR = "Plotting requires matplotlib. Install it with `pip install matplotlib`."


def _a15_init(device: str, world: int, rank: int, init_file: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist
    if device == "cuda":
        torch.cuda.set_device(0)
    backend = "nccl" if device == "cuda" and world == 1 else "gloo"
    dist.init_process_group(backend, init_method=f"file://{init_file}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))


def _a15_mesh(dev, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def _full_attention_rows(q, k, v, first: int, heads_per_chunk: int = 8):
    """Causal softmax attention of the query rows ``first ..`` of the
    sequence against all of ``k``, ``v``, in one process, a few heads at a
    time (each head is independent)."""
    import torch
    t_q, t_k = q.shape[-2], k.shape[-2]
    keep = (first + torch.arange(t_q, device=q.device))[:, None] >= torch.arange(t_k, device=q.device)[None, :]
    outs = []
    for h in range(0, q.shape[1], heads_per_chunk):
        s = q[:, h:h + heads_per_chunk] @ k[:, h:h + heads_per_chunk].transpose(-1, -2) * q.shape[-1] ** -0.5
        outs.append(torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1) @ v[:, h:h + heads_per_chunk])
        del s
    return torch.cat(outs, dim=1)


def _a15_eval_data(dev, batch: int, context: int, classes: int, cls_batch: int, seed: int) -> dict:
    """Part (a)'s global inputs, drawn on the card: q, k, v of (B, 32, T, 128),
    the 4,096 -> 32,000 output projection (scaled so the logits are of
    order one), the target tokens and bench config 2's classifier batch."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    h, dh, vocab = LLAMA2_7B["heads"], LLAMA2_7B["head_dim"], LLAMA2_7B["vocab"]
    q, k, v = (torch.randn(batch, h, context, dh, generator=g, device=dev) for _ in range(3))
    wo = torch.randn(h * dh, vocab, generator=g, device=dev) * (h * dh) ** -0.5
    tokens = torch.randint(0, vocab, (batch, context), generator=g, device=dev)
    preds = torch.softmax(torch.randn(cls_batch, classes, generator=g, device=dev), dim=-1)
    labels = torch.randint(0, classes, (cls_batch,), generator=g, device=dev)
    return {"q": q, "k": k, "v": v, "wo": wo, "tokens": tokens, "preds": preds, "labels": labels}


def _a15_eval(dev, batch: int = A15_EVAL["batch"], context: int = LLAMA2_7B["context"],
              steps: int = A15_EVAL["steps"], classes: int = A15_EVAL["classes"],
              cls_batch: int = A15_EVAL["cls_batch"]) -> dict:
    """Part (a) on this rank, the counterpart of the JAX package's multichip
    program 2: a (dp, sp) = (1, world) mesh; each step runs causal ring
    attention over this rank's (B, 32, T / sp, 128) block, merges the heads,
    projects to 32,000 logits, updates Perplexity reduced over dp then sp,
    and updates a fused Accuracy + F1 + binned AUROC collection on the
    classifier batch, reduced over dp. Returns the record and the reduced
    states (numpy) of the last step."""
    import torch
    import torch.distributed as dist
    from torchmetrics_tpu_torch.interop import state_to_numpy
    from torchmetrics_tpu_torch.ops.bincount import weighted_bincount
    from torchmetrics_tpu_torch.parallel import ring_attention
    from torchmetrics_tpu_torch.parallel.ring import ring_shift
    from torchmetrics_tpu_torch.text import Perplexity

    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = _a15_mesh(dev, (1, world), ("dp", "sp"))
    sp_group, dp_group = mesh.get_group("sp"), mesh.get_group("dp")
    data = _a15_eval_data(dev, batch, context, classes, cls_batch, A15_EVAL["seed"])
    t_loc = context // world
    rows = slice(rank * t_loc, (rank + 1) * t_loc)
    q, k, v = (data[n][:, :, rows].contiguous() for n in ("q", "k", "v"))
    tokens = data["tokens"][:, rows].contiguous()
    coll = multiclass_path(num_classes=classes, batch=cls_batch, steps=1)["make"](dev)
    ppl = Perplexity(device=dev)

    def step():
        attn = ring_attention(q, k, v, group=sp_group, causal=True)
        b, h, t, dh = attn.shape
        logits = attn.transpose(1, 2).reshape(b, t, h * dh) @ data["wo"]
        ps = ppl.update_state(ppl.init_state(), logits, tokens)
        ps = ppl.reduce_state(ppl.reduce_state(ps, dp_group), sp_group)
        cs = coll.reduce_state(coll.update_state(coll.init_state(), data["preds"], data["labels"]), dp_group)
        return attn, ps, cs

    weighted_bincount.launches = 0
    step_ms = []
    with torch.no_grad():
        for _ in range(steps):
            dist.barrier()
            (attn, ps, cs), ms = _timed(step)
            step_ms.append(ms)
        launches = weighted_bincount.launches
        want = _full_attention_rows(q, data["k"], data["v"], rank * t_loc)
        attn_err = float((attn - want).abs().max())
        del want
        if not attn_err <= A15_ATTN_TOL:
            raise AssertionError(f"a15 eval: ring attention is {attn_err} off full attention (tol {A15_ATTN_TOL})")
        bf16 = ring_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), group=sp_group, causal=True)
        bf16_err = float((bf16.float() - attn).abs().max())
        if bf16.dtype != torch.bfloat16 or not bf16_err <= A15_BF16_TOL:
            raise AssertionError(f"a15 eval: bf16 ring attention gave {bf16.dtype}, {bf16_err} off float32")
        del bf16
        dist.barrier()
        _, ring_ms = _timed(lambda: ring_attention(q, k, v, group=sp_group, causal=True))
        dist.barrier()
        kv = torch.stack((k, v))
        exchange_ms = _timed(lambda: ring_shift(kv, sp_group))[1] * (world - 1)
        del kv
    ppl_value = float(ppl.compute_state(ps))
    values = {k: _summary(x) for k, x in coll.compute_state(cs).items()}
    record = {"world": world, "sp": world, "dp": 1, "backend": dist.get_backend(),
              "shape": {"batch": batch, "heads": LLAMA2_7B["heads"], "t_local": t_loc, "head_dim": LLAMA2_7B["head_dim"],
                        "vocab": LLAMA2_7B["vocab"], "classes": classes, "cls_batch": cls_batch},
              "step_ms": step_ms, "ms_per_step": statistics.median(step_ms[1:] or step_ms),
              "ring_attention_ms": ring_ms, "exchange_ms": exchange_ms, "attention_alone_ms": ring_ms - exchange_ms,
              "exchange_share": exchange_ms / ring_ms, "attn_max_abs_err": attn_err, "bf16_max_abs_err": bf16_err,
              "launches": launches, "perplexity": ppl_value, "values": values,
              "peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20 if dev.type == "cuda" else None}
    states = {"perplexity": {k: x.tolist() for k, x in state_to_numpy(ps).items()},
              "collection": {k: x.tolist() for k, x in _flat_numpy(state_to_numpy(cs)).items()}}
    return record, states


def _flat_numpy(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, x in tree.items():
            out.update(_flat_numpy(x, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _demo_reference(params: dict, tokens, targets, lr: float, experts: int) -> tuple:
    """The train template's model and SGD step in one process, on the global
    batch: the stages in order, each with ``experts`` experts over the
    hidden dim's slices, expert ``e`` on the ``e``-th slice of positions.
    Returns (loss, updated parameters)."""
    import torch
    import torch.nn.functional as F
    p = {k: x.detach().clone().requires_grad_(True) for k, x in params.items()}
    x = p["embed"][tokens]
    t, dh = x.shape[1], p["w1"].shape[-1]
    for s in range(p["w1"].shape[0]):
        x = x + F.gelu(x @ p["w1"][s], approximate="tanh") @ p["w2"][s]
        parts = []
        for e in range(experts):
            hid = slice(e * dh // experts, (e + 1) * dh // experts)
            xe = x[:, e * t // experts:(e + 1) * t // experts]
            parts.append(F.gelu(xe @ p["we1"][s][:, hid], approximate="tanh") @ p["we2"][s][hid])
        x = x + torch.cat(parts, dim=1)
    logits = x @ p["out"]
    loss = -torch.log_softmax(logits, dim=-1).gather(-1, targets[..., None]).mean()
    loss.backward()
    return float(loss.detach()), {k: (x - lr * x.grad).detach() for k, x in p.items()}


def _a15_train(dev, mesh_shape: tuple, run: str) -> dict:
    """Part (b) on this rank: the train template on a (pp, dp, tp) mesh at
    one of DEMO_RUNS' widths. The first step's loss and this rank's
    parameters after it against the one-process reference; then the run's
    remaining steps on the same batch with Accuracy and Perplexity updated
    on the logits each step."""
    import torch
    import torch.distributed as dist
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy
    from torchmetrics_tpu_torch.ops.bincount import weighted_bincount
    from torchmetrics_tpu_torch.parallel import init_demo_params, make_demo_train_step
    from torchmetrics_tpu_torch.parallel.train_demo import local_batch, local_demo_params
    from torchmetrics_tpu_torch.text import Perplexity

    cfg = DEMO_RUNS[run]
    pp, dp, tp = mesh_shape
    mesh = _a15_mesh(dev, mesh_shape, ("pp", "dp", "tp"))
    g = torch.Generator(device=dev).manual_seed(151)
    full = init_demo_params(g, cfg["vocab"], cfg["d_model"], cfg["d_hidden"], pp=pp, tp=tp, device=dev)
    tokens, targets = (torch.randint(0, cfg["vocab"], (cfg["batch"], cfg["seq"]), generator=g, device=dev)
                       for _ in range(2))
    ref_loss, ref_params = _demo_reference(full, tokens, targets, cfg["lr"], experts=tp)
    ref_local = local_demo_params(ref_params, mesh)
    params = local_demo_params(full, mesh)
    del full, ref_params
    tok, tgt = local_batch(tokens, mesh), local_batch(targets, mesh)
    step = make_demo_train_step(mesh, microbatches=2, lr=cfg["lr"])
    acc = MulticlassAccuracy(num_classes=cfg["vocab"], average="micro", device=dev)
    ppl = Perplexity(device=dev)
    weighted_bincount.launches = 0
    losses, step_ms = [], []
    for i in range(cfg["steps"]):
        dist.barrier()
        (params, loss, logits), ms = _timed(lambda: step(params, tok, tgt))
        step_ms.append(ms)
        acc.update(logits.reshape(-1, cfg["vocab"]), tgt.reshape(-1))
        ppl.update(logits, tgt)
        losses.append(float(loss))
        if i == 0:
            loss_err = abs(losses[0] - ref_loss)
            param_err = {k: float((params[k] - ref_local[k]).abs().max()) for k in params}
            del ref_local
            if not (loss_err <= A15_TRAIN_TOL and max(param_err.values()) <= A15_TRAIN_TOL):
                raise AssertionError(f"a15 train {run} {mesh_shape}: first step off the one-process reference by "
                                     f"{loss_err} (loss), {param_err} (parameters)")
    launches = weighted_bincount.launches
    if run == "jax_entry" and not losses[-1] < losses[0] - 0.5:
        raise AssertionError(f"a15 train {run} {mesh_shape}: the loss fell from {losses[0]} to {losses[-1]} only")
    acc_value, ppl_value = float(acc.compute()), float(ppl.compute())
    if not (0.0 <= acc_value <= 1.0 and ppl_value > 1.0 and ppl_value == ppl_value):
        raise AssertionError(f"a15 train {run}: accuracy {acc_value}, perplexity {ppl_value}")
    return {"mesh": {"pp": pp, "dp": dp, "tp": tp}, "backend": dist.get_backend(), **cfg,
            "first_loss": losses[0], "last_loss": losses[-1], "loss_err": loss_err,
            "param_max_abs_err": max(param_err.values()), "accuracy": acc_value, "perplexity": ppl_value,
            "step_ms": step_ms, "ms_per_step": statistics.median(step_ms[1:] or step_ms), "launches": launches}


def _a15_run(device: str, world: int, rank: int, init_file: str, meshes: tuple) -> dict:
    """Parts (a) and (b) in one process group: the eval step, then each
    train mesh at each width."""
    import torch
    import torch.distributed as dist
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    _a15_init(device, world, rank, init_file)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        eval_record, eval_states = _a15_eval(dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        train = {f"{run}_pp{m[0]}_dp{m[1]}_tp{m[2]}": _a15_train(dev, m, run) for m in meshes for run in DEMO_RUNS}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        dist.destroy_process_group()
    return {"rank": rank, "eval": eval_record, "eval_states": eval_states, "train": train}


def _a15_rank(rank: int, world: int, init_file: str, out_dir: str, device: str = "cuda") -> None:
    """One gloo rank of a15's two-rank run; writes ``a15_rank{r}.json`` or
    ``a15_rank{r}.err``."""
    import pathlib
    import traceback
    out = pathlib.Path(out_dir)
    try:
        report = _a15_run(device, world, rank, init_file, ((1, 1, 2), (2, 1, 1)))
        (out / f"a15_rank{rank}.json").write_text(json.dumps(report))
    except BaseException:
        (out / f"a15_rank{rank}.err").write_text(traceback.format_exc())
        raise


def _a15_same_states(label: str, got: dict, want: dict) -> float:
    """Integer-valued states bitwise, float ones within A15_VALUE_RTOL
    relative; returns the largest relative error."""
    import numpy as np
    worst = 0.0
    for part in want:
        for k, w in want[part].items():
            g, w = np.asarray(got[part][k]), np.asarray(w)
            if np.array_equal(w, np.round(w)) and np.abs(w).max(initial=0) < 2 ** 24:
                if not np.array_equal(g, w):
                    raise AssertionError(f"a15 {label}: {part}/{k} counts differ from the world-1 run")
                continue
            rel = float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-30)))
            worst = max(worst, rel)
            if not rel <= A15_VALUE_RTOL:
                raise AssertionError(f"a15 {label}: {part}/{k} is {rel} off the world-1 run (rtol {A15_VALUE_RTOL})")
    return worst


def a15_plotting() -> dict:
    """Part (c): without matplotlib every plot raises the JAX package's
    error; with it, bench config 2's collection, a MulticlassROC and the
    Cityscapes confusion matrix render under Agg. Importing the package in
    a fresh process must not import matplotlib."""
    import importlib.util

    import torch
    from torchmetrics_tpu_torch.classification import MulticlassConfusionMatrix, MulticlassROC
    from torchmetrics_tpu_torch.utils import imports

    present = importlib.util.find_spec("matplotlib") is not None
    if imports._MATPLOTLIB_AVAILABLE != present:
        raise AssertionError(f"a15 plot: _MATPLOTLIB_AVAILABLE is {imports._MATPLOTLIB_AVAILABLE}, "
                             f"find_spec says {present}")
    probe = subprocess.run([sys.executable, "-c", "import sys, torchmetrics_tpu_torch; "
                            "print('matplotlib' in sys.modules)"], capture_output=True, text=True, timeout=300)
    if probe.returncode != 0 or probe.stdout.strip() != "False":
        raise AssertionError(f"a15 plot: importing the package imported matplotlib ({probe.stdout!r} {probe.stderr})")
    dev = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    g = torch.Generator(device=dev).manual_seed(152)
    coll = multiclass_path(num_classes=100, batch=1024, steps=1)["make"](dev)
    preds = torch.softmax(torch.randn(1024, 100, generator=g, device=dev), dim=-1)
    labels = torch.randint(0, 100, (1024,), generator=g, device=dev)
    coll.update(preds, labels)
    roc = MulticlassROC(num_classes=100, thresholds=64, device=dev)
    roc.update(preds, labels)
    confmat = MulticlassConfusionMatrix(num_classes=19, ignore_index=255, device=dev)
    confmat.update(torch.randint(0, 19, (512, 1024), generator=g, device=dev),
                   torch.randint(0, 19, (512, 1024), generator=g, device=dev))
    calls = {"Metric.plot": lambda: coll["acc"].plot(), "MetricCollection.plot": coll.plot,
             "MulticlassROC.plot": roc.plot, "MulticlassConfusionMatrix.plot": confmat.plot}
    out = {"matplotlib": present}
    if not present:
        for name, call in calls.items():
            try:
                call()
            except ModuleNotFoundError as err:
                if str(err) != PLOT_ERROR:
                    raise AssertionError(f"a15 plot: {name} raised {err!r}") from err
            else:
                raise AssertionError(f"a15 plot: {name} drew without matplotlib")
        out["without_matplotlib"] = {name: "ModuleNotFoundError, the JAX message" for name in calls}
        return out
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    drawn = {}
    for name, call in calls.items():
        figs = call()
        figs = figs if isinstance(figs, list) else [figs]
        drawn[name] = len(figs)
        for fig, _ in figs:
            fig.canvas.draw()
            plt.close(fig)
    out["figures"] = drawn
    return out


def run_a15(card: str, device: str = "cuda") -> tuple:
    """Phase a15: (a) and (b) at NCCL world 1 in this process, then in two
    gloo ranks spawned on the one card, their eval states held against the
    world-1 run's; then (c). Returns the record and the bincount launches.
    ``device`` other than ``cuda`` rehearses on the CPU (gloo throughout)."""
    import pathlib
    import tempfile

    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmpdir:
        one = _a15_run(device, 1, 0, f"{tmpdir}/a15_world1", ((1, 1, 1),))
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_a15_rank, args=(r, 2, f"{tmpdir}/a15_gloo", tmpdir, device)) for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + A15_DEADLINE_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
        errors = [f.read_text() for f in sorted(pathlib.Path(tmpdir).glob("a15_rank*.err"))]
        if errors or hung or any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"a15: ranks failed (hung: {len(hung)}, exit codes {[p.exitcode for p in procs]}):\n"
                                 + "\n".join(errors))
        ranks = [json.loads((pathlib.Path(tmpdir) / f"a15_rank{r}.json").read_text()) for r in range(2)]
    worst = max(_a15_same_states(f"eval rank {r['rank']}", r["eval_states"], one["eval_states"]) for r in ranks)
    launches = one["eval"]["launches"] + sum(t["launches"] for t in one["train"].values())
    launches += sum(r["eval"]["launches"] + sum(t["launches"] for t in r["train"].values()) for r in ranks)
    if not one["eval"]["launches"] or not all(r["eval"]["launches"] for r in ranks):
        raise AssertionError("a15: an eval run launched the bincount kernel no time")
    record = {"phase": "a15", "card": card, "seconds": time.perf_counter() - t0,
              "eval_world1": one["eval"], "eval_two_ranks": [r["eval"] for r in ranks],
              "eval_states_max_rel_err_vs_world1": worst,
              "train_world1": one["train"], "train_two_ranks": [r["train"] for r in ranks],
              "plot": a15_plotting(), "kernel_launches": launches}
    return record, launches


def dist_sync(card: str) -> tuple:
    """Phase dist_sync: part (a), then part (b); any failure raises.
    Returns the record and each kernel's launches."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmpdir:
        one_rank, launches_a = dist_sync_one_rank_nccl(tmpdir)
        two_ranks, launches_b = dist_sync_two_ranks_gloo(tmpdir)
    launches_b["weighted_bincount"] += launches_a
    return {"phase": "dist_sync", "card": card, "nccl_world_1": one_rank,
            "gloo_two_ranks_one_card": two_ranks}, launches_b


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import torchmetrics_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from torchmetrics_tpu_torch import _native
    from torchmetrics_tpu_torch.ops import bincount, tdigest

    card = card_line()
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})

    def timed(build):
        t0 = time.perf_counter()
        return build(), time.perf_counter() - t0

    t0 = time.perf_counter()
    # one nvcc for each CUDA source and g++ for the host library, started together
    with ThreadPoolExecutor(3) as pool:
        libs = list(pool.map(timed, (bincount.build, tdigest.build, _native.build)))
    bincount._library()
    tdigest._library()
    _native._library()
    native_build_s = libs[2][1]
    emit({"phase": "build", "libraries": [lib.name for lib, _ in libs], "seconds": time.perf_counter() - t0,
          "each_seconds": [s for _, s in libs]})

    kernel = check_kernel(torch.device("cuda"))
    tdigest_kernel = check_tdigest_kernel(torch.device("cuda"))
    emit({"phase": "kernel", "card": card, **kernel, "tdigest_compress": tdigest_kernel})

    dev = torch.device("cuda")
    paths = [
        ("bench_config2", multiclass_path(num_classes=100, batch=1024, steps=200)),
        ("imagenet1k_val", multiclass_path(num_classes=1000, batch=1000, steps=50)),
        ("mvtec_pixel_binary", pixel_binary_path()),
        ("coco_multilabel", coco_multilabel_path()),
        ("cityscapes_miou", cityscapes_miou_path()),
        ("imagenet1k_confmat", imagenet1k_confmat_path()),
        ("imagenet1k_exact", imagenet1k_exact_path()),
        ("jigsaw_fairness_binary", jigsaw_fairness_path()),
        ("coco_multilabel_exact", coco_multilabel_exact_path()),
        ("nyu_depth_v2_regression", nyu_depth_path()),
        ("stsb_dev_correlation", stsb_correlation_path()),
        ("msmarco_dev_rerank", msmarco_rerank_path()),
        ("div2k_val_x4_sr", div2k_sr_path()),
        ("wv3_pansharpening_reduced", wv3_reduced_path()),
        ("wv3_pansharpening_full", wv3_full_path()),
        ("live1_jpeg_deblock", live1_deblock_path()),
    ]
    launches = sum(run_path(label, path, card, dev) for label, path in paths)
    emit(check_capture_refusal(card, dev))
    launches += run_composition(card, dev)
    for run in (run_streaming, run_config1, run_step_overhead):
        record, phase_launches = run(card, dev)
        emit(record)
        launches += phase_launches
    emit(sync_free_exact_computes(card))
    sketch_records, sketch_launches = run_sketch_paths(card, dev)
    for record in sketch_records:
        emit(record)
    launches += sketch_launches["weighted_bincount"]
    tdigest_launches = sketch_launches["tdigest_compress"]
    a11a_records, a11a_launches = run_a11a_paths(card, dev)
    for record in a11a_records:
        emit(record)
    launches += a11a_launches
    a11b_records, a11b_launches, native_calls = run_a11b_paths(card, dev)
    for record in a11b_records:
        emit(record)
    launches += a11b_launches
    a11c_records, a11c_launches = run_a11c_paths(card, dev)
    for record in a11c_records:
        emit(record)
    launches += a11c_launches
    _, a11d_launches = run_a11d_paths(card, dev)  # emits each path's record as it ends
    launches += a11d_launches
    _, a13_launches, a13_kernel_row = run_a13_paths(card, dev)  # emits each path's record as it ends
    launches += a13_launches
    launches += run_a14(card, dev)  # emits each part's record as it ends
    kernel["cases"].append(a13_kernel_row)
    for record in run_model_paths(card, dev):
        emit(record)
    record, a15_launches = run_a15(card)
    emit(record)
    launches += a15_launches
    record, dist_launches = dist_sync(card)
    emit(record)
    launches += dist_launches["weighted_bincount"]
    tdigest_launches += dist_launches["tdigest_compress"]

    emit({"native": {"source": "torchmetrics_tpu_torch/csrc/tm_native.cpp", "compiler": " ".join(
        ("g++",) + _native.CXX_FLAGS), "library": libs[2][0].name, "build_seconds": native_build_s,
        "entry_points_called": native_calls, "check_against_plain": native_check()}})
    main_case = next(c for c in kernel["cases"] if c["case"] == "curve_c1000_t64")
    td_main = tdigest_kernel["cases"][0]
    emit({"kernels": [{
        "name": "weighted_bincount",
        "route": "cuda",
        "source": "torchmetrics_tpu_torch/csrc/bincount.cu",
        "replaces": "torchmetrics_tpu/ops/bincount.py:38",
        "launches": launches,
        "max_abs_err": kernel["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "library_device_ms": main_case["library_device_ms"],
        "library_ms_is": "host round trip per row (torch.bincount sizes its output on the host)",
        "host_ms": main_case["host_ms"],
        "shape": {"s": main_case["s"], "n": main_case["n"], "bins": main_case["bins"], "shared_idx": True,
                  "weighted": True},
        "slice_cases": {c["case"]: {k: c[k] for k in ("ms", "host_ms", "plain_ms", "bound_ms", "library_device_ms",
                                                      "library_ms", "max_abs_err", "plan", "transpose_ms", "n", "bins")
                                    if k in c}
                        for c in kernel["cases"] if c["case"] in SLICE_CASES},
    }, {
        "name": "tdigest_compress",
        "route": "cuda",
        "source": "torchmetrics_tpu_torch/csrc/tdigest.cu",
        "replaces": "torchmetrics_tpu/sketches/tdigest.py:86 (lax.scan)",
        "launches": tdigest_launches,
        "max_abs_err": tdigest_kernel["max_abs_err"],
        "ms": td_main["ms"],
        "plain_ms": td_main["plain_ms"],
        "bound_ms": td_main["bound_ms"],
        "bound_by": td_main["bound_by"],
        "library_ms": None,
        "library_ms_is": "null: no single PyTorch call computes the greedy k1 slot scan and its per-slot sums",
        "host_ms": td_main["host_ms"],
        "shape": {"s": td_main["s"], "m": td_main["m"], "compression": td_main["compression"]},
        "cases": {c["case"]: {k: c[k] for k in ("ms", "host_ms", "plain_ms", "bound_ms", "max_abs_err",
                                                "mean_rel_err_card_plain", "slots_used")}
                  for c in tdigest_kernel["cases"]},
    }]})
    print(f"card: {card}", flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
