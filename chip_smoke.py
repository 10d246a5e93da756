#!/usr/bin/env python3
"""Smoke test of the PyTorch port (warpdemux_tpu_torch) on one CUDA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. Print the card's name and power limit (nvidia-smi), build the CUDA
   kernels of csrc/ from source and print what ptxas reported for each
   (registers, spills).
2. For each kernel K1-K16, on numpy-seeded inputs at the step's shapes
   (B=1000 reads, L=10000 samples, A=6272 adapter samples, N=851 and 2601
   support vectors), compare the kernel with its plain PyTorch version on
   the card and time both (the kernel twice: as a caller sees it, and with
   the launches queued behind a spin kernel, which leaves the device's
   time alone); print its bound (the larger of its bytes over
   the card's memory rate and its operations over the float32 rate, from
   this run's inputs) and the share of it reached. K1's entry is the SVM's
   kernel matrix, exp(-gamma D) stored by K1 itself (K16's element), held
   bit for bit against its plain version and against K1 then K16 on every
   variant at K1_EXP_GAMMAS and K1_EXP_EDGES, and timed in turns beside K1
   then K16; K1 is also held at its
   wide kernel (every lattice but m = 25, window 15), at edge tiles, on non-finite fingerprints and at a
   cell whose sum lands on a float32 tie (`k1_tie_case`); K6 at
   lengths off the scan's block size, with windows longer than the row and
   at a row too long for shared memory (its device-scratch variant, K9's
   too), and it must allocate nothing beside its outputs at L=10000. K4 is
   also timed at the two other shapes the paths launch it with, beside an
   empty launch of its grid, and held at ranges of 1, 2 and 3 samples,
   all-equal ranges, signed zeros, infinities and NaNs, range starts off
   the vector alignment and a row too long for shared memory (its
   streaming variant). K7 is held at short and odd lengths, windows longer
   than the row, row starts off the vector alignment, constant masks and
   a row too long for its uint16 prefix counts (its direct variant).
   K3 is held on rows of 1 to 6272 positions, distances from 1 to above
   max_distance, reaches to 32, empty and full masks, runs of equal scores,
   staircases of peaks, peaks at the row's ends and across its bit words'
   boundaries and non-finite scores, on both of its variants (bit words in
   shared memory; byte flags in device memory, which a max_distance above
   32 takes), must allocate nothing beside its output, and the rounds its
   fixpoint takes on the step's batch are printed (largest and mean a row).
   K2 is held bit for bit (its scores and the n_scores it writes) on rows
   of every width from 1 to 12, widths outside [1, w_max], rows shorter
   than two windows, windows of equal samples, a subnormal sum of squares,
   NaN and infinite samples and lengths off its vectors and tiles, and at
   K2_LONG_CASES (w_max = 8,987, past shared memory: the windows read from
   device memory; a row of 67,108,865 samples, past 65,535 tiles), timed
   beside its plain version there. K5 is
   held at both of the step's shapes (the refine windows, one and two a
   read from the one signal; the adapter extraction with lengths) and on
   starts that leave the row, lengths of 0 and beyond, sizes off the
   vectors and three windows a row, and on two windows of 67,108,865
   samples (past 65,535 chunks), with and without lengths.
   K5 and K7 are timed beside the one PyTorch call that computes the same
   function (torch.gather, F.conv1d), as called and on the device alone.
   K8 is also held against K4 and timed beside it, at R=2 and R=1, and held
   on ranges of 1, 2 and 3 samples, empty and inverted ranges, all-equal
   ranges, heavy ties, the keys -32768 and 32767, range starts off the
   vector alignment and rows at and beyond its staging limit, on both of
   its variants (keys staged in shared memory; the streaming bisection); K9
   against K6 and K7 (at edge lengths too) and timed beside K6 + 2 x K7 on
   the same inputs. K10 (the tRNA path's subsequence DTW, new: no Pallas
   counterpart) is held bit for bit at 1000 series of 121 events against
   the 84-event consensus, and on series lengths of 0, 1 and below the
   query's, psi_2b at and beyond the width, constant series, exact ties,
   NaN and infinite values, other widths and the warp kernel's seams
   (query lengths 1 to 258, series of 1 and 31 events), on both of its
   variants (one warp a read, for queries of at most 256; one block a
   read, which longer queries take), and both are timed in turns at the
   step's shape. K11 (the masked row means and stds of the region
   statistics and the [mvs_polya] gate in XLA's order, new: no Pallas
   counterpart) is held bit for bit, on its three variants (one block a
   row, the covered span staged once; one warp a range and row, which rows
   beyond the block's shared memory take; the warp kernel with its window
   sums in a global workspace, which rows past 431,104 samples take), at
   the step's shapes (three
   ranges with stds over the calibrated reads, the gate's one range of
   means, float rows) and on rows of 1, 31, 32, 33, 1024, 1025, 10000,
   10001, 10003, 15000, 32769, 431,105 and 1,048,577 samples (a fourth
   level of the sum tree), empty, inverted, out-of-row,
   identical and nested ranges, ranges at 0 and at L, a range in the last
   window alone beside whole rows, one row, rows of length 0, NaN and inf,
   constant rows, -0.0 and cancellations, with and without the
   calibration; the variants are timed in turns at each step shape beside
   its bound, the workspace kernel at 64 reads of 431,105 and 1,048,577
   samples, and the wrapper beside torch.where(mask, x, 0).sum(-1). K12
   (the SVM's decision values and the DTW-MLP's layers in XLA:CPU's
   summation order, new: no Pallas counterpart; a block R rows, a thread a
   chain of the order, operands staged by cp.async) is held bit for bit at
   the shapes of the models that take it (WDX4 at B = 1000, 32, 16 and 2,
   the tRNA model, WDX6 at B = 16 and 1000, WDX10 at B = 64 and 1000) and,
   in its fixed order, at shapes whose XLA order is not known (WDX4 at
   B = 1, WDX10 at B = 16, WDX8 and WDX12 of RNA002), and K13 (the SVM's
   probabilities: the Platt sigmoid and the Wu-Lin coupling in the jitted
   JAX operations, one warp a row, new) on K12's decision values there and
   on rows of NaN, inf and 0; both are timed beside their bounds at
   B = 1000 and the lane's 16 / 32 (K13's operations counted from the
   coupling passes each row takes, and its latency floor from those
   passes and a timed chain of divisions), K12 beside torch.addmm, each
   beside its time before the redesign. XLA:CPU's float32 log, elementwise
   (`wdx_xla_log`, which no step launches since K14 took the LLR cost
   whole), is held bit for bit against its plain version at the LLR's
   variance shapes, on edge values and on every float32 bit pattern, and
   timed beside its bound and torch.log (not bit-equal: another log). K14
   (the LLR changepoint split: the cost of every split of a window from
   its prefix sums, XLA's log inlined, and the first argmin, one block a
   window, new) is held split for split against its plain version at
   LLR_SHAPES (the refinement's 2 x B windows of 800, the tRNA adapter's
   B windows of 6000 with each row's own end) on windows from a seed and
   on the edge rows of LLR_EDGES, and timed beside its bound and the
   torch operations it replaced. K16 (XLA:CPU's exp of -gamma times the
   powered DTW distances, the SVM's kernel matrix at pwr_dist != 1, new)
   is held bit for bit at
   K16_SHAPES and K16_SCALES, on edge values, on a view off its 16-byte
   vectors and on every float32 bit pattern, and timed beside its bound
   and torch.exp. K15
   (XLA:CPU's float32 softmax of the DTW-MLP and Fpt-Boost families, new:
   one warp a row, the sum in XLA's order by shuffles) is held bit for bit
   against its plain version at K15_SHAPES, on logits from a seed and on
   the edge rows of K15_EDGE_ROWS (subnormal quotients, +-inf, NaN), and
   timed beside its bound and torch.softmax (not bit-equal). The shapes
   past the shipped models' (faults F, G, H): K13 at WIDE_CLASSES (17-64
   classes) on each of its kernels that takes k (one warp a row up to 32;
   one block a row, Q in shared memory or in a global workspace), K1 at
   LONG_FINGERPRINTS (25-100 events, windows 15 and m) on each of its
   kernels that takes the shape (the register kernel at 25 and 15 alone;
   the wide kernel, its DP rows in shared memory or a workspace), K15 also at K15_WIDE_SHAPES
   (1,025 and 12,288 classes) and on each of its kernels that takes the
   width (lanes, warp, block, global), all bit for bit their plain
   versions and each timed on the device in turns; K15's lanes and warp
   kernels in turns with torch.softmax at K15_TIMED (the families' 5 and
   13 classes, at 1,000 and 100,000 rows). An
   empty launch is timed as called
   through `_cuda.launch` and through a launch that resolves the entry
   point, the device context and the stream object every time. Fault K:
   K11 (the mean and std) and K4 (the median and MAD) at one range a row
   on the adapter buffer of B reads and NORM_EDGES (constant, MAD 0,
   lengths 0-2, a single inf, -inf or NaN sample), bit for bit their
   plain versions, NaN for NaN, timed beside them and their bounds; the
   pre-normalization whole (`fingerprint.normalize_prefix`) against the
   CPU.
3. Three main paths of the WDX4 step on the first 256 reads of
   synthetic.synth_minibatch(default_rng(0), 1000, 10000), each run on the GPU
   with every launch count at 0 beforehand and read right after:
   a. the adc feed, decision outputs: every kernel but K9, K10, K15, K16
      and the elementwise log must launch;
      (success, fail_code, pred) must agree with the CPU path on at least
      255 of 256 rows, and the CPU result must hit the repository's pins;
   b. the vbz feed (the reads packed into the VBZ wire by the port's numpy
      helpers), full outputs: the GPU decode must equal the int16 reads,
      K8, K4 and K11 must launch, and the packed columns must agree with
      the CPU step (integer, median, MAD, mean and std columns exactly on
      at least 255 rows, the other floats within the CPU tests'
      tolerances);
   c. the adc feed, decision outputs, fused_rolling=True: K9 must launch
      once per step and K6 and K7 never; the decisions must equal path a's
      on every row.
4. Reads/s of each of the three paths over three B=1000 minibatches after
   one warm-up, in two rounds of alternating order.
5. One step of each path under torch.profiler: its device operations
   (kernels, copies, memsets) are counted and printed beside the count
   before K11 (the adc decision and vbz full steps may not exceed it by
   more than 20) and before K5's callers stopped copying for it; those of
   the tRNA and RNA002 steps, and of one micro-batch of the live lane;
   no path may take more than before K14 (DEVICE_OPS_BEFORE_K14), every
   path fewer than before K14's redesign and K16 (DEVICE_OPS_BEFORE_K16)
   and than before K1 stored the SVM's exp (DEVICE_OPS_BEFORE_K1_EXP), and
   no more than DEVICE_OPS_PINNED. Runs
   after phase 10, before phase 13: an attached profiler slows every later
   launch.
6. The live read-until lane (warpdemux_tpu_torch/live/) on the card:
   a. the lane program (`Session._classify_on_device`: one copy in, K5,
      K4, K2, K3 and K1, one fetch) on 64 replay reads cut at poly(A) plus
      padding, each held in every signal-length bucket, at max_batch 32 and
      16, against the CPU lane: (ok, pred) must agree on all but one row of
      each, and every micro-batch must launch K1-K5, K12 and K13 once (K1
      storing the kernel matrix's exp) and K6-K9 and K16 never;
   b. each of the seven kernels at the lane's shapes (B = 16 and 32; K5 at
      L = 2048 and 12288) against its plain version, timed beside its
      bound, and the lane program a micro-batch as called;
   c. a whole session on the replay client through the port's
      tools/live_latency.measure (126 channels, 100 ms chunks, 400 reads,
      max_batch 16, a read_count balancer), with four classifier threads
      and with one: every delivered read decided, 30% or more classified,
      no classifier thread raised, the lane's kernels launched once a
      micro-batch; the decision latency's percentiles are printed;
   d. the port's tools/live_soak in a process of its own on the card
      (SOAK_READS reads, no pacing): every read decided and written once;
      the report, with the RSS and the device memory at a third of the
      decisions and at the end, is printed.

7. The offline run loop (pipeline/run.demux_minibatches, the loop behind
   `python -m warpdemux_tpu_torch.cli demux`) on phase 4's four
   minibatches, the last cut to 617 rows (3,617 reads, uuid read ids), in
   four runs with batch_size_output 1500: a. the vbz wire, predictions
   only (the CLI's default run: the two-stage wire, stage1_preload 7168);
   a'. the same with stage1_preload 0 (the one-shot wire); b. the adc
   wire, predictions only; c. the vbz wire, prep (boundaries and
   fingerprints). Each run must account for every read once (predictions
   or boundaries, or failed_reads), count 3,617 reads, write fingerprint
   rows equal to its boundary rows and launch each kernel its step's count
   x 4, run a x (4 + the minibatches whose stage 2 ran, printed; at least
   one); runs a, a' and b must write equal CSV text, and run a must agree
   with a CPU run of the loop on the first 256 reads (barcode and fail
   reason on 255 or more, the confidence within 0.001). Each run's reads/s
   (host clock, call to return) is printed beside phase 4's step rate;
   run a with stage 2 on the dispatching thread (the default), run a with
   it on the postprocess thread and run a' are timed in turns (three
   rounds, each writing run a's text), and run a again on eight
   minibatches (the loop's cost a minibatch beyond its fixed cost); phase
   5 prints the device's busy time in run a against run a's time. Runs
   after phase 4, before phase 11.
8. The tRNA chemistry (WDX4_tRNA_rna004_v1_0, rna004_130bps@v1.0_tRNA:
   start_peak detect, the [real_range] and [med_shift] gates, consensus-
   refined fingerprints with K10) on trna_minibatch(default_rng(0), 1000):
   a. the adc feed, decision outputs, on the first 256 rows: the launch
      counts of LAUNCHES["trna_adc_decision"], (success, fail_code, pred)
      equal to the CPU step's on at least 255 rows, each branch's rows and
      fail codes printed, 0.9 of the called planted barcodes as planted;
   b. the vbz feed, full outputs: LAUNCHES["trna_vbz_full"], every column
      (cons_i, the consensus match, included) as in phase 3b;
   c. reads/s of both over three B=1000 minibatches after one warm-up, in
      the rounds of phase 4;
   d. one demux_minibatches run (the vbz wire, predictions and boundaries)
      over the four minibatches: every read once, the consensus columns in
      the boundaries rows, launches 4 x the vbz full step's.
   Runs after phase 11, before phase 9; phase 5 counts the device
   operations of both tRNA steps too.
9. The model families and RNA002 (runs after phase 8, before phase 6):
   a. DTW-MLP (the WDX4 bundle's 851 reference fingerprints, one hidden
      layer of 100, 5 classes) and Fpt-Boost (1,000 oblivious trees of
      depth 6), arrays from a seed (family_arrays), predict the 1000
      fingerprints of the seed-0 mRNA step on the card: pred, conf and
      probs bit for bit the CPU's (K1, K12 and K15 are their plain
      versions' bits), the launches of LAUNCHES["<family>_predict"];
   b. the predict run (pipeline/run.run_predict_from_fpts) with each family
      over those fingerprints saved as a prep run saves them: every read
      predicted, (read_id, barcode) equal to a CPU run's on 999 or more;
   c. the RNA002 step (WDX4 and WDX10 rna002_v0_4_4, rna002_70bps@v0.4.4:
      LLR detect, no CNN) on rna002_minibatch(default_rng(0), 1000) at
      L=15000, adc decision and vbz full: the launches of
      LAUNCHES["rna002_..."] at B=1000, (success, fail_code, pred) equal to
      the CPU step's on 255 of the first 256 rows or more (vbz full: every
      int, median and MAD column compared as in phase 3b), and reads/s.
10. One worker process a device, what `-j N` runs (after phase 6, before
   phase 5's profiler): parallel/multihost.run_workers over every card,
   or two processes on cuda:0 on a machine of one card, each running the
   run loop (adc wire, predictions) over its round-robin share of
   WORKER_MINIBATCHES minibatches of B rows (127,617 reads) with its rank's
   shard tag; rounds of one process on cuda:0 and of the mesh in turns
   (one, mesh, mesh, one). Each run's merged predictions and failed_reads
   rows must equal, as text, those of the first one-process run; each
   process's `GLOBAL (n hosts)` line its totals and class counts; each
   process's launches its minibatches x LAUNCHES["adc_decision"]. Reads/s
   of each round, timed in the processes from one barrier to the next
   after one warm-up step each, printed beside the card.
11. The two-stage wire (pipeline/step.make_twostage_decision_step) on the
   card, for WDX4 and WDX10 (rna004_130bps@v1.0, stage1_len 7168), after
   phase 7, before phase 8: three B=1000 bench minibatches (default_rng(0))
   packed whole, and 1000 reads of default_rng(11) cut to lengths in
   [2200, 7168] and packed ragged, as the pod5 feed packs them. Each
   through stage 1, the host's read of `resolved` and, where a row is
   unresolved, its tails and stage 2, against the one-shot vbz decision
   step: pred, conf, fail_code, success and probs equal on every row;
   stage 1 and a stage 2 that runs each launch LAUNCHES["adc_decision"];
   the ragged batch resolved in stage 1 alone. The resolved share and the
   wire bytes a read (stage 1 plus tails, against the whole wire) are
   printed, and the two-stage minibatch and the one-shot step timed in
   turns (5 rounds of the 3 staged bench minibatches): median, range and
   their ratio.
12. The trainers (warpdemux_tpu_torch/tools/) on the card, after phase 9,
   before phase 6:
   a. the boundary-CNN trainer at full width (ARCH, 48 reads of 10,000
      samples a step, input cap 7168, seed 0) for CNN_TRAIN_STEPS steps,
      twice on the card and once on the CPU: the two card runs' weights
      and losses equal bit for bit, every loss within CNN_LOSS_RTOL of
      the CPU's and every weight within CNN_WEIGHT_ATOL, no kernel of
      csrc/ launched, the cuDNN and TF32 switches as before; steps/s of
      each run (the host's make_batch share printed). A control run on
      the card with TF32 in the backward convolutions (the forward in
      full float32, as when only the forward is scoped) must break both
      limits, so that they are shown to catch it; The trained weights
      then serve the adc decision step on the seed-0 bench batch
      (LAUNCHES["trained_cnn_adc_decision"]; GPU against CPU on 255 of
      the first 256 rows or more);
   b. the tRNA trainer's device half at its default arguments
      (WDX4_tRNA, 720 reads in prep steps of 128 on the pa feed, seed
      11): its prep step at B = 128, 80 and 22 on trna_minibatch rows,
      every column against the CPU step's as in phase 3b (all rows); the
      713 fingerprints and classes equal to the CPU's, the shipped
      bundle's 495 support vectors among them, each prep step launching
      LAUNCHES["trna_prep"]; the Gram matrix, K1 at 713 x 713, bit for bit
      its plain version, timed beside its bound; both holdout families
      (150 reads each) through the shipped bundle, fingerprints and pred
      equal to the CPU's.
   (The SVC fit is sklearn's, which the card's machine lacks.)
13. The port's profiling tools (warpdemux_tpu_torch/tools/profile_step_trace,
   profile_detect_trace, profile_stages) on the card at B = 1000, run last,
   after phase 5: the step traces of the adc decision and vbz full paths,
   the detect trace (detect alone on calibrated signals) and the stage
   table, each printed. Each trace must list every kernel of csrc/ its path
   launches, with the calls a step of the path's LAUNCHES pin
   (LAUNCHES["pa_detect"] for the detect trace), and no other: a profiler
   that missed the ctypes launches fails here. The stage table's dtw and
   svm proba rows must launch their kernels (K1, which stores the kernel
   matrix's exp itself; K12 and K13) once a call.
14. The port's throughput tools and boundary validation
   (warpdemux_tpu_torch/tools/bench_models, sweep_minibatch, bench_trna,
   validate_boundaries) on the card, after phase 13, in a process of its
   own (no profiler attached there), each through the function its command
   line calls with every launch count at 0 before it and read after it:
   a. bench_models at WDX4 / WDX6 / WDX10, the full and decision steps on
      16 staged B=1000 adc minibatches (TOOL_DISTINCT drawn, the rest
      copies), TOOL_ROUNDS rounds in turns: the JSON line of each model and
      each round's reads/s;
   b. sweep_minibatch at B = 500, 1000, 2000 and 4000 (16,000 reads a
      measurement), the Markdown table with the peak memory of each B;
   c. bench_trna at B = 1000 (the tRNA step on the pa feed): its line;
   every step of a-c launching its path's LAUNCHES pin and nothing else;
   d. validate_boundaries.validate on 400 synthetic mRNA reads
      (validate_batches) on the card and on the CPU: every table line
      equal, the launches of LAUNCHES["validate_boundaries"] a minibatch;
   e. K12 at the WDX6 and WDX10 step shapes (B = 1000): bit for bit its
      plain version, timed beside its bound and torch.addmm (TF32 off).
15. Shapes past the shipped models' on the card against the CPU (after
   phase 3, before phase 4): a. the classify chain (K1 with the kernel
   matrix's exp, K12, K13) of a synthetic SVM (svm_arrays: 40 support
   vectors a class, RNA004's gamma) at WIDE_CLASSES, one predict of
   CHAIN_ROWS fingerprints: the launches of LAUNCHES["dtw_svm_predict"],
   pred, conf and probs bit for bit the CPU's; the same of a 5-class SVM of
   pwr_dist 2 (K1, then K16 over the squared distances: the one path K16
   keeps) at LAUNCHES["dtw_svm_pwr_dist_2_predict"];
   b. the adc step, full outputs, on phase 3's N_ROWS reads with a
   24-class SVM, then with fingerprints of 40 events (the config's
   barcode_num_events and barcode_seg_num_events) and a 5-class SVM of
   40-event support vectors: each at its LAUNCHES pin, every row agreeing
   as phase 3b compares them, (success, pred) equal on every row;
   c. the WDX4 adc step, full outputs, with the chemistry's
   sig_preload_size at LONG_ROW_SAMPLES (450,000, past K11's warp kernel)
   on synth_minibatch(default_rng(0), 16, 450,000): at
   LAUNCHES["long_rows_adc_full"], all 16 rows agreeing as in b, the step's
   ms as called printed;
   d. sig_extract.normalization = "mean" and "median" (fault K), each
   through: the WDX4 step, full outputs, on the adc feed (the B seed-0
   reads and NORM_ADC_EDGES) and on the pa feed (NORM_ROWS reads ending in
   NORM_EDGES: a single inf, -inf or NaN sample among them), every column
   as in b, NaN for NaN, (success, pred) on every row; the tRNA step (adc,
   full) on NORM_TRNA_ROWS reads of trna_minibatch; one micro-batch of the
   live lane (NORM_LANE_ROWS reads, a constant one and one with a NaN
   sample among them): ok, pred and fingerprints equal; one offline run of
   one adc minibatch with the setting as `--export` gives it: its CSV
   text the CPU run's. Each at its LAUNCHES pin (one more K11 or K4 a
   fingerprint call than the path's "none" pin), the step's ms as called
   printed; phase 5 counts each step's device operations beside the
   "none" step's on the same rows.

The line before last is a JSON object with per-kernel results; the last
line is {"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
"""

import contextlib
import json
import subprocess
import sys
import time
from collections import Counter

MODEL = "WDX4_rna004_v1_0"
B, L = 1000, 10000
N_ROWS = 256  # rows held against the CPU path and the pins
PINS = (237, {-1: 236, 7: 1}, {2: 15, 5: 4})  # tests/test_bench_population.py
# NVIDIA's published peaks of one H100 SXM: device memory rate, and the
# float32 rate outside the tensor cores (integer compares and adds are
# counted at the same rate)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Operations a sample that the function needs, whatever algorithm computes
# it: an exact selection (a median) takes a handful of compares a sample,
# a MAD a subtract and an abs more and a second selection
SELECT_OPS = 4
MAD_OPS = 2 + SELECT_OPS

KERNELS = {  # launch-count key -> (name, source, TPU kernel it replaces)
    "wdx_dtw": ("K1 dtw", "dtw.cu", "warpdemux_tpu/ops/dtw_pallas.py:94"),
    "wdx_ttest": ("K2 ttest", "ttest.cu", "warpdemux_tpu/ops/ttest_pallas.py:77"),
    "wdx_suppress": ("K3 peak suppression", "peaks.cu", "warpdemux_tpu/ops/peaks_pallas.py:79"),
    "wdx_range_median_mad": ("K4 range median/MAD", "select.cu", "warpdemux_tpu/ops/select_pallas.py:123"),
    "wdx_shift_rows": ("K5 window gather", "window_gather.cu", "warpdemux_tpu/ops/window_gather.py:36"),
    "wdx_rolling_mean_var": ("K6 rolling mean/var", "rolling.cu", "warpdemux_tpu/ops/rolling_pallas.py:77"),
    "wdx_run_sum": ("K7 rolling run-sum", "rolling.cu", "warpdemux_tpu/ops/rolling_pallas.py:123"),
    "wdx_range_median_adc": ("K8 ADC-domain range median", "select.cu", "warpdemux_tpu/ops/select_pallas.py:279"),
    "wdx_rolling_detect": ("K9 fused rolling detect", "rolling.cu", "warpdemux_tpu/ops/rolling_pallas.py:206"),
    "wdx_subseq_dtw": ("K10 subsequence DTW", "subsequence.cu",
                       "new, no Pallas counterpart (warpdemux_tpu/ops/subsequence.py:60, a lax.scan)"),
    "wdx_rowstats": ("K11 masked row mean/std", "rowstats.cu",
                     "new, no Pallas counterpart (XLA's row sums: warpdemux_tpu/ops/normalize.py:55, "
                     "warpdemux_tpu/detect/boundaries.py:695)"),
    "wdx_svm_dot": ("K12 SVM decision values in XLA's order", "svmdot.cu",
                    "new, no Pallas counterpart (XLA:CPU's dot: warpdemux_tpu/ops/svm.py:74)"),
    "wdx_svm_probs": ("K13 SVM probabilities (Platt, Wu-Lin coupling)", "svmprob.cu",
                      "new, no Pallas counterpart (warpdemux_tpu/ops/svm.py:94, a lax.while_loop)"),
    "wdx_xla_log": ("K14 elementwise log (no step launches it)", "xlalog.cu",
                    "new, no Pallas counterpart (XLA:CPU's log: warpdemux_tpu/detect/boundaries.py:224, :259)"),
    "wdx_xla_softmax": ("K15 XLA's float32 softmax", "xlasoftmax.cu",
                        "new, no Pallas counterpart (XLA:CPU's jax.nn.softmax: warpdemux_tpu/models/dtw_mlp.py:42, "
                        "warpdemux_tpu/models/fpt_boost.py:101)"),
    "wdx_llr_split": ("K14 LLR changepoint split", "xlalog.cu",
                      "new, no Pallas counterpart (XLA:CPU's cost and argmin: warpdemux_tpu/detect/boundaries.py:201 "
                      "_llr_refine, :229 _llr_split_window)"),
    "wdx_xla_exp_scaled": ("K16 XLA's float32 exp of the SVM kernel matrix", "xlaexp.cu",
                           "new, no Pallas counterpart (XLA:CPU's exp: warpdemux_tpu/ops/svm.py:184 pdist_kernel)"),
}
PATHS = ("adc_decision", "vbz_full", "fused_decision")
# device operations a step of each path before K5's callers stopped copying
# for it and K2 wrote n_scores itself: `count_device_ops` on commit 7cdf228
DEVICE_OPS_BEFORE = {"adc_decision": 1747, "vbz_full": 1862, "fused_decision": 1746}
# launches a step of each path, in KERNELS' order (K1 .. K13, the
# elementwise log, K15, K14, K16); K11 once for the [mvs_polya] gate's
# poly(A) mean of each detect pass (the CNN's and the LLR fallback's) and
# once for the region statistics of full outputs; K12 and K13 once a
# classified SVM batch (the decision values, the probabilities), K1 storing
# the kernel matrix's exp itself at pwr_dist = 1 (every shipped bundle's),
# K16 the exp only for an SVM of another pwr_dist (phase 15a); K14 once
# a detect pass for the LLR refinement's split (the tRNA paths: the
# refinement and the adapter's split window); the
# elementwise log nowhere since K14 took the whole cost; K15 once a
# classified batch of the DTW-MLP or Fpt-Boost families (their softmax)
LAUNCHES = {"adc_decision": (1, 1, 1, 1, 3, 1, 2, 3, 0, 0, 2, 1, 1, 0, 0, 2, 0),
            "vbz_full": (1, 1, 1, 2, 3, 1, 2, 3, 0, 0, 3, 1, 1, 0, 0, 2, 0),
            "fused_decision": (1, 1, 1, 1, 3, 0, 0, 3, 1, 0, 2, 1, 1, 0, 0, 2, 0),
            "live_lane": (1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0),  # one micro-batch of the lane program
            # the offline run loop's steps (phase 7): the vbz decode is torch
            # ops, and prep classifies nothing
            "vbz_decision": (1, 1, 1, 1, 3, 1, 2, 3, 0, 0, 2, 1, 1, 0, 0, 2, 0),
            "vbz_prep": (0, 1, 1, 2, 3, 1, 2, 3, 0, 0, 3, 0, 0, 0, 0, 2, 0),
            # the tRNA paths (phase 8): K3 twice (the adapter's events, then
            # the barcode's from its start), K4 for the clip and the gates
            # (with the adapter MAD) or the four region statistics, K5 for the
            # refine windows, the split window and the adapter, K8 for the
            # adapter-level proxy, K10 for the consensus match, K11 for the
            # region statistics of full outputs (no [mvs_polya] gate)
            "trna_adc_decision": (1, 1, 2, 2, 3, 1, 1, 1, 0, 1, 0, 1, 1, 0, 0, 2, 0),
            "trna_vbz_full": (1, 1, 2, 2, 3, 1, 1, 1, 0, 1, 1, 1, 1, 0, 0, 2, 0),
            # phase 9: the model families' predict (K1 for DTW-MLP's
            # distances, K12 for each of its two layers, K15 for either
            # family's softmax) and the predict run over one fingerprint file; the
            # RNA002 steps (LLR detect, no CNN: one detect pass, one gate)
            "dtw_mlp_predict": (1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 0, 0, 1, 0, 0),
            "fpt_boost_predict": (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0),
            "rna002_adc_decision": (1, 1, 1, 1, 2, 1, 1, 2, 0, 0, 1, 1, 1, 0, 0, 1, 0),
            "rna002_vbz_full": (1, 1, 1, 2, 2, 1, 1, 1, 0, 0, 2, 1, 1, 0, 0, 1, 0),
            # phase 12: the tRNA trainer's prep step (the pa feed, full
            # outputs, no model: K4 for the proxy median where the adc feeds
            # take K8, no K1); the mRNA step served by the trained CNN
            "trna_prep": (0, 1, 2, 3, 3, 1, 1, 0, 0, 1, 1, 0, 0, 0, 0, 2, 0),
            "trained_cnn_adc_decision": (1, 1, 1, 1, 3, 1, 2, 3, 0, 0, 2, 1, 1, 0, 0, 2, 0),
            # phase 13's detect trace: detect_boundaries_with_fallback alone
            # on calibrated float signals (no adc: K4 where the adc feeds
            # take K8), with its region statistics, no fingerprint
            "pa_detect": (0, 0, 0, 4, 2, 1, 2, 0, 0, 0, 3, 0, 0, 0, 0, 2, 0),
            # phase 14: bench_trna's step (the tRNA step on the pa feed, full
            # outputs: K4 for the adapter-level proxy where the adc feeds
            # take K8); one minibatch of validate_boundaries.validate (four
            # detect configurations on float signals, the three fingerprinted
            # ones through K1, K12 and K13)
            "trna_pa_full": (1, 1, 2, 3, 3, 1, 1, 0, 0, 1, 1, 1, 1, 0, 0, 2, 0),
            "validate_boundaries": (3, 3, 3, 13, 9, 4, 5, 0, 0, 0, 9, 3, 3, 0, 0, 6, 0),
            # phase 15: the adc step, full outputs, with a 24-class SVM, with
            # 40-event fingerprints and on rows of LONG_ROW_SAMPLES (each a
            # vbz full step's launches); one predict of a synthetic SVM (K1
            # with the kernel matrix's exp, K12 and K13), and of one of
            # pwr_dist 2 (K1, then K16 over the squared distances)
            "wide_classes_adc_full": (1, 1, 1, 2, 3, 1, 2, 3, 0, 0, 3, 1, 1, 0, 0, 2, 0),
            "long_fingerprints_adc_full": (1, 1, 1, 2, 3, 1, 2, 3, 0, 0, 3, 1, 1, 0, 0, 2, 0),
            "long_rows_adc_full": (1, 1, 1, 2, 3, 1, 2, 3, 0, 0, 3, 1, 1, 0, 0, 2, 0),
            "dtw_svm_predict": (1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0),
            "dtw_svm_pwr_dist_2_predict": (1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 0, 1),
            # phase 15d: sig_extract.normalization = "mean" / "median" (fault
            # K): the paths' pins above with one more K11 ("mean") or K4
            # ("median") a fingerprint call: the mRNA step on the adc and pa
            # feeds (full outputs), the tRNA step (adc, full), a micro-batch of
            # the live lane, the offline run's adc decision step
            "mean_adc_full": (1, 1, 1, 2, 3, 1, 2, 3, 0, 0, 4, 1, 1, 0, 0, 2, 0),
            "median_adc_full": (1, 1, 1, 3, 3, 1, 2, 3, 0, 0, 3, 1, 1, 0, 0, 2, 0),
            "mean_pa_full": (1, 1, 1, 5, 3, 1, 2, 0, 0, 0, 4, 1, 1, 0, 0, 2, 0),
            "median_pa_full": (1, 1, 1, 6, 3, 1, 2, 0, 0, 0, 3, 1, 1, 0, 0, 2, 0),
            "trna_mean_adc_full": (1, 1, 2, 2, 3, 1, 1, 1, 0, 1, 2, 1, 1, 0, 0, 2, 0),
            "trna_median_adc_full": (1, 1, 2, 3, 3, 1, 1, 1, 0, 1, 1, 1, 1, 0, 0, 2, 0),
            "live_lane_mean": (1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0),
            "live_lane_median": (1, 1, 1, 2, 1, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0),
            "offline_mean_adc_decision": (1, 1, 1, 1, 3, 1, 2, 3, 0, 0, 3, 1, 1, 0, 0, 2, 0),
            "offline_median_adc_decision": (1, 1, 1, 2, 3, 1, 2, 3, 0, 0, 2, 1, 1, 0, 0, 2, 0)}
FAMILIES = ("dtw_mlp", "fpt_boost")
RNA002_PATHS = ("rna002_adc_decision", "rna002_vbz_full")
# device operations a step before K11 (`count_device_ops` on commit
# 3f76e42, torch 2.11.0 on the card, PERF.md section 5)
DEVICE_OPS_BEFORE_K11 = {"adc_decision": 1874, "vbz_full": 1989, "fused_decision": 1873,
                         "trna_adc_decision": 1901, "trna_vbz_full": 2025}
# device operations a step or micro-batch of each path before K14, once
# K12 and K13 had replaced the torch coupling (`count_device_ops` on commit
# 2a0ac67, torch 2.11.0 on the card, PERF.md section 5): no later change
# may add any
DEVICE_OPS_BEFORE_K14 = {"adc_decision": 1740, "vbz_full": 1790, "fused_decision": 1739,
                   "trna_adc_decision": 1879, "trna_vbz_full": 1917,
                   "rna002_adc_decision": 1183, "rna002_vbz_full": 1223, "live_lane": 758}
# ... and before K14 took the LLR cost whole and K16 the SVM's exp
# (`count_device_ops` on commit 29601bf, torch 2.11.0 on the card, PERF.md
# section 5): every path must now take fewer
DEVICE_OPS_BEFORE_K16 = {"adc_decision": 1600, "vbz_full": 1650, "fused_decision": 1599,
                         "trna_adc_decision": 1739, "trna_vbz_full": 1777,
                         "rna002_adc_decision": 1113, "rna002_vbz_full": 1153, "live_lane": 758}
# ... and before K1 stored the SVM's exp itself (`count_device_ops` with
# K14 the whole LLR split and K16, torch 2.11.0 on the card, PERF.md
# section 5): every path classifies, so every path must now take fewer
DEVICE_OPS_BEFORE_K1_EXP = {"adc_decision": 1129, "vbz_full": 1179, "fused_decision": 1128,
                     "trna_adc_decision": 1257, "trna_vbz_full": 1295,
                     "rna002_adc_decision": 744, "rna002_vbz_full": 784, "live_lane": 491}
# ... and since (`count_device_ops` with K1 storing the SVM's exp, torch
# 2.11.0 on the card, PERF.md section 5): no later change may add any
DEVICE_OPS_PINNED = {"adc_decision": 1128, "vbz_full": 1178, "fused_decision": 1127,
                     "trna_adc_decision": 1256, "trna_vbz_full": 1294,
                     "rna002_adc_decision": 743, "rna002_vbz_full": 783, "live_lane": 490}
TRNA_PATHS = ("trna_adc_decision", "trna_vbz_full")
# phase 8's run of the offline loop: the vbz wire, predictions and boundaries
TRNA_OFFLINE_RUN = "trna_offline_vbz_boundaries"
# phase 7's runs: name -> (wire, prep, stage1_preload, step path of LAUNCHES,
# phase 4's path printed beside it); run a is the CLI's default, the
# two-stage wire, run a' the one-shot wire
STAGE1_LEN = 7168  # the CLI's --stage1_preload
OFFLINE_RUNS = {"offline_vbz_decision": ("vbz", False, STAGE1_LEN, "vbz_decision", "adc_decision"),
                "offline_vbz_decision_one_shot": ("vbz", False, 0, "vbz_decision", "adc_decision"),
                "offline_adc_decision": ("adc", False, STAGE1_LEN, "adc_decision", "adc_decision"),
                "offline_vbz_prep": ("vbz", True, STAGE1_LEN, "vbz_prep", "vbz_full")}
TWO_STAGE_RUN = "offline_vbz_decision"
# phase 7's runs timed in turns: name -> stage1_preload
OFFLINE_TIMED = {"two-stage wire": STAGE1_LEN, "one-shot wire": 0}
OFFLINE_TIMED_ROUNDS = 3
# phase 11: the two-stage wire's step against the one-shot vbz step
TWO_STAGE_MODELS = ("WDX4_rna004_v1_0", "WDX10_rna004_v1_0")
TWO_STAGE_ROUNDS = 5
SOAK_READS = 4000  # phase 6d's soak
# phase 14: the throughput tools at their models and sizes, each path timed
# TOOL_ROUNDS times in turns; TOOL_DISTINCT minibatches drawn a measurement
# and the rest staged as copies of them (the host draws ~1,400 reads/s);
# validate_boundaries.validate on VALIDATE_READS reads in minibatches of 200
TOOL_MODELS = ("WDX4_rna004_v1_0", "WDX6_rna004_v1_0", "WDX10_rna004_v1_0")
SWEEP_SIZES = (500, 1000, 2000, 4000)
TOOL_ROUNDS = 3
TOOL_DISTINCT = 2
VALIDATE_READS = 400
K12_WIDE_MODELS = ("WDX6_rna004_v1_0", "WDX10_rna004_v1_0")  # K12 timed at their step shapes in phase 14
OFFLINE_LAST_ROWS = 617  # the last of the four minibatches: 3,617 reads, one short batch
# phase 10's run: the data of WORKER_DISTINCT minibatches (each drawn once a
# process) in WORKER_MINIBATCHES minibatches of read ids of their own, the
# last cut to OFFLINE_LAST_ROWS rows
WORKER_MINIBATCHES = 128
WORKER_DISTINCT = 8
WORKER_ROUNDS = ("one", "mesh", "mesh", "one")
# phase 12: the CNN trainer at full width (ARCH, the trainer's batch of 48
# reads of 10,000 samples, its input cap 7168), CNN_TRAIN_STEPS steps from
# seed 0 on the card twice and on the CPU once. Tolerances, card against
# CPU: cuDNN and oneDNN sum the convolutions and their gradients in other
# orders; the gradients differ by ~5e-7 of their largest at step 0 and the
# weights by ~3e-7 after 3 steps (the port against the JAX trainer on the
# CPU, tests/test_torch_train_cnn.py), and the difference grows with the
# steps. Each limit lies between the sound card run's reading after 50
# steps (losses 1.85e-5 relative, weights 1.83e-4) and the control's, TF32
# in the backward convolutions (6.80e-5, 1.17e-3), which must break both
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md)
CNN_TRAIN_STEPS = 50
CNN_LOSS_RTOL = 3.5e-5
CNN_WEIGHT_ATOL = 5e-4
TRAINED_CNN = "chip_smoke_cnn"  # the trained bundle's name in a temporary weights directory
TRNA_TRAIN_FPTS = 713  # training fingerprints of the tRNA trainer's defaults (WDX4_tRNA)


TRNA_MODEL = "WDX4_tRNA_rna004_v1_0"
TRNA_BARCODES = (3, 4, 5, 7)  # the model's classes, in the order of trna_barcode_patterns
# the branches of the tRNA path a minibatch reaches, one kind a row in turn
TRNA_KINDS = ("poly(A)", "poly(A)", "poly(A)", "poly(A)", "no poly(A)", "no poly(A)",
              "real dwell", "no spike", "body at adapter level", "mRNA")


def trna_minibatch(rng, n, length=L):
    """(adc (n, length) int16, offset, scale, lens, kind, barcode): tRNA
    reads of the port's utils/synthetic, row k of kind TRNA_KINDS[k % 10]:
    barcoded reads with a 600-sample poly(A), without one (the split
    path), with real-fitted dwell times; tRNA reads without a capture
    spike (rna start peak not found), with the body at the adapter's level
    (med shift check failed); and synthetic.synth_minibatch mRNA rows (no
    consensus: real signal check failed or consensus query outlier).
    barcode is the planted class, -1 where none was planted."""
    import numpy as np

    from warpdemux_tpu_torch.utils.synthetic import ADC_OFFSET, ADC_SCALE, synth_minibatch
    from warpdemux_tpu_torch.utils.synthetic import (
        real_dwell_sampler,
        synth_trna_barcoded_read,
        synth_trna_read,
        trna_barcode_patterns,
    )

    pats = trna_barcode_patterns(4, 25)
    kind = np.arange(n) % len(TRNA_KINDS)
    m_adc, m_off, m_sc, m_lens = synth_minibatch(rng, int((kind == 9).sum()), length)
    adc = np.zeros((n, length), np.int16)
    offset = np.full(n, ADC_OFFSET, np.float32)
    scale = np.full(n, ADC_SCALE, np.float32)
    lens = np.zeros(n, np.int32)
    barcode = np.full(n, -1, np.int32)
    m = 0
    for k in range(n):
        name = TRNA_KINDS[kind[k]]
        if name == "mRNA":
            adc[k], offset[k], scale[k], lens[k] = m_adc[m], m_off[m], m_sc[m], m_lens[m]
            m += 1
            continue
        if name == "no spike":
            sig, _ = synth_trna_read(rng, spike_idx=None)
        elif name == "body at adapter level":
            sig, _ = synth_trna_read(rng, trna_level=70.0)
        else:
            kw = {"no poly(A)": {"polya_len": 0}, "real dwell": {"dwell": real_dwell_sampler()}}.get(name, {})
            sig, _ = synth_trna_barcoded_read(rng, pats[k % 4], **kw)
            barcode[k] = TRNA_BARCODES[k % 4]
        a = np.clip(np.rint(sig / ADC_SCALE - ADC_OFFSET), -32768, 32767).astype(np.int16)
        lens[k] = min(length, a.size)
        adc[k, : lens[k]] = a[: lens[k]]
    return adc, offset, scale, lens, kind, barcode


RNA002_MODELS = ("WDX4_rna002_v0_4_4", "WDX10_rna002_v0_4_4")  # rna002_70bps@v0.4.4
RNA002_L = 15000  # the chemistry's sig_preload_size


def rna002_minibatch(rng, n, length=RNA002_L):
    """(adc (n, length) int16, offset, scale, lens): the port's
    utils/synthetic.synth_batch mRNA reads quantized to ADC counts with
    synthetic.synth_minibatch's calibration."""
    import numpy as np

    from warpdemux_tpu_torch.utils.synthetic import ADC_OFFSET, ADC_SCALE
    from warpdemux_tpu_torch.utils.synthetic import synth_batch

    sigs, lens, _ = synth_batch(rng, n, L=length)
    adc = np.clip(np.rint(sigs / ADC_SCALE - ADC_OFFSET), -32768, 32767).astype(np.int16)
    adc[np.arange(length)[None, :] >= lens[:, None]] = 0
    return adc, np.full(n, ADC_OFFSET, np.float32), np.full(n, ADC_SCALE, np.float32), lens


def time_ms(fn, reps=10, queued=False):
    """Mean time of fn() in ms: CUDA events around `reps` calls made back
    to back, after two warm-ups. That is the larger of the device's time
    and the host's time to make one call, which is what a kernel of a few
    tens of microseconds costs a caller. queued=True keeps the device busy
    with a spin kernel of about 10 ms while the host enqueues the calls, so
    the events bracket the device's time alone."""
    import torch

    for _ in range(2):
        fn()
    if queued:
        torch.cuda._sleep(20_000_000)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs(a, b):
    import torch

    a, b = a.double(), b.double()
    same = (torch.isnan(a) & torch.isnan(b)) | (a == b)  # equal infinities too
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def bits_equal(a, b):
    """float32 tensors equal bit for bit, any NaN equal to any NaN (the
    card's default NaN is not the CPU's)."""
    import torch

    return bool(((a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())).all())


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes moved over its memory rate and the operations over its
    float32 rate."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


# K1's float32 tie: x and d as float32 bits (numerics.fma, K1's cell)
K1_TIE_BITS = (0x37C501F4, 0x3FDC920A)


def k1_tie_case():
    """(X (256, 25), Y (1, 25), window, penalty): DTW inputs whose cell
    (1, 1), fma(d, d, x * x rounded), has a float64 sum that lands exactly
    on a float32 half-way point a quarter of a float64 ulp from the exact
    sum: a fused multiply-add rounds it to one neighbour, the float64 sum
    rounded again to float32 to the other. X's rows are [x, d, e, 0, ...]
    against a reference of zeros with penalty 0, e from a seed; the third
    sample carries the tie into the distance on 77 of the 256 rows."""
    import numpy as np

    X = np.zeros((256, 25), np.float32)
    X[:, :2] = np.array(K1_TIE_BITS, np.uint32).view(np.float32)
    X[:, 2] = np.random.default_rng(0).uniform(0.5, 3, 256).astype(np.float32)
    return X, np.zeros((1, 25), np.float32), 15, 0.0


def k7_edge_cases():
    """[(name, mask (B, L) bool, w)]: the run-sum inputs that K7, its plain
    version and the JAX package are all held to: rows of 1, 7 and 9999
    samples with windows from 1 to longer than the row, and constant masks."""
    import numpy as np

    rng = np.random.default_rng(7)
    cases = [
        (f"L={L} w={w}", rng.random((5 if L == 1 else 33, L)) < 0.4, w)
        for L in (1, 7, 9999) for w in (1, 3, 100, 5000)
    ]
    cases.append(("L=300 w=5000", rng.random((33, 300)) < 0.4, 5000))
    for L, w in ((9999, 100), (10000, 100), (7, 3)):
        cases.append((f"all-True L={L} w={w}", np.ones((9, L), bool), w))
        cases.append((f"all-False L={L} w={w}", np.zeros((9, L), bool), w))
    return cases


def k4_edge_cases(with_nan=True):
    """[(name, x (B, L) float32, starts (R, B), ends (R, B))]: the ranges
    that K4, its plain version and (without NaNs) the JAX package are all
    held to, median and MAD."""
    import numpy as np

    rng = np.random.default_rng(4)
    i32 = lambda rows, B: np.repeat(np.asarray(rows, np.int32)[:, None], B, axis=1)
    cases = []
    x = rng.normal(80, 12, (6, 40)).astype(np.float32)
    cases.append(("n = 1, 2, 3", x, i32([5, 7, 11], 6), i32([6, 9, 14], 6)))
    x = np.full((4, 50), 73.25, np.float32)
    x[1], x[2] = -0.0, 0.0
    cases.append(("all-equal", x, i32([0, 3, 10], 4), i32([50, 33, 11], 4)))
    x = rng.normal(0, 1, (6, 101)).astype(np.float32)
    x[:, ::5], x[:, 1::5] = 0.0, -0.0
    x[3, :60] = np.where(np.arange(60) % 2 == 0, 0.0, -0.0)
    cases.append(("mixed signs with -0.0 and +0.0", x, i32([0, 0, 2], 6), i32([101, 100, 52], 6)))
    x = (np.round(rng.normal(80, 12, (6, 700)) / 4) * 4).astype(np.float32)
    cases.append(("heavy ties", x, i32([0, 1, 100], 6), i32([700, 651, 356], 6)))
    x = rng.normal(80, 12, (6, 32)).astype(np.float32)
    x[0, 3], x[1, 5], x[1, 6], x[2, :] = np.inf, -np.inf, np.inf, np.inf
    x[3, 4:20] = np.inf
    cases.append(("inf", x, i32([0, 1, 4], 6), i32([32, 31, 9], 6)))
    x = rng.normal(80, 12, (6, 256)).astype(np.float32)
    cases.append(("range starts off the vector alignment", x, i32([1, 2, 3], 6), i32([256, 131, 8], 6)))
    if with_nan:
        x = rng.normal(80, 12, (6, 32)).astype(np.float32)
        x[0, 3], x[0, 9] = np.inf, np.nan
        x[1, :20] = np.nan  # the median itself
        x[2, 7] = np.copysign(np.float32(np.nan), np.float32(-1))  # sorts below -inf
        x[3, 2], x[3, 3] = np.nan, -np.inf
        cases.append(("inf and NaN", x, i32([0, 1, 4], 6), i32([32, 31, 9], 6)))
        x, n = norm_buffer(4)
        cases.append(("the adapter buffer's edge rows, R = 1 (fault K)", x, np.zeros((1, len(n)), np.int32), n[None]))
    return cases


def k3_edge_cases():
    """[(name, scores (B, L) float32, is_peak (B, L) bool, distance (B,)
    int32, max_distance)]: the suppression inputs that K3 (both variants),
    its plain version and the JAX package are all held to. A flagged score
    of -inf stands only where a winner within reach kills it or the
    distance is 1: elsewhere no version of the fixpoint resolves it. The
    last two rows are the longest that take the bit-word kernel, and one
    position more."""
    import numpy as np

    rng = np.random.default_rng(3)
    i32 = lambda v: np.asarray(v, np.int32)

    def maxima(s):  # local maxima, the later of two equal neighbours
        m = np.zeros(s.shape, bool)
        m[:, 1:-1] = (s[:, 1:-1] >= s[:, :-2]) & (s[:, 1:-1] > s[:, 2:])
        return m

    cases = []
    for L in (1, 2, 7, 6271, 6272):
        s = (np.round(rng.gamma(2.0, 1.0, (6, L)) * 4) / 4).astype(np.float32)
        flags = maxima(s) if L > 2 else np.ones((6, L), bool)
        cases.append((f"L={L}", s, flags, i32([1, 2, 3, 5, 6, 9]), 7))
    s = rng.gamma(2.0, 1.0, (5, 700)).astype(np.float32)
    cases.append(("distance 1 (nothing suppressed)", s, maxima(s), i32([1] * 5), 7))
    cases.append(("distance above max_distance (clamped)", s, maxima(s), i32([7, 8, 9, 100, 6]), 7))
    cases.append(("max_distance 32, distances to 32", s, rng.random(s.shape) < 0.5, i32([32, 31, 17, 40, 2]), 32))
    cases.append(("max_distance 33, distances to 32", s, rng.random(s.shape) < 0.5, i32([32, 31, 17, 40, 2]), 33))
    cases.append(("no peak", s, np.zeros(s.shape, bool), i32([3] * 5), 7))
    cases.append(("every position flagged", s, np.ones(s.shape, bool), i32([1, 2, 4, 6, 7]), 7))
    flat = np.full((4, 200), 2.5, np.float32)
    flat[2, 100:] = 1.0
    flat[3, ::7] = 3.0
    cases.append(("equal scores over a run", flat, np.ones(flat.shape, bool), i32([2, 5, 6, 3]), 7))
    stairs = np.zeros((2, 1024), np.float32)
    stairs[0, ::2] = np.arange(512, 0, -1)  # falls: one winner a round, from the left
    stairs[1, ::2] = np.arange(1, 513)  # rises: from the right
    cases.append(("staircases of peaks two apart", stairs, stairs > 0, i32([3, 3]), 7))
    s = rng.gamma(2.0, 1.0, (4, 200)).astype(np.float32)
    flags = np.zeros(s.shape, bool)
    flags[:, [0, 1, 30, 31, 32, 33, 63, 64, 65, 95, 96, 198, 199]] = True
    s[1, [31, 32]] = 9.0  # a tie across the word boundary
    s[2, [0, 199]] = 9.0
    cases.append(("peaks at the ends and across word boundaries", s, flags, i32([2, 3, 6, 40]), 32))
    s = rng.gamma(2.0, 1.0, (5, 96)).astype(np.float32)
    flags = np.zeros(s.shape, bool)
    flags[:, [10, 11, 20, 22, 30, 31, 33, 60, 64, 90]] = True
    s[:, 10], s[:, 11] = -np.inf, 5.0  # killed by its neighbour in round one
    s[:, [20, 22]] = np.inf  # a tie of infinities: the later wins
    s[:, [30, 33]] = np.nan  # dominates nothing, is dominated by nothing
    s[:, 40:50] = -np.inf  # not flagged
    s[4, 64] = -np.inf  # distance 1: wins
    cases.append(("inf, -inf and NaN scores", s, flags, i32([4, 2, 6, 3, 1]), 7))
    for L in (619808, 619809):  # the longest row whose bit words fit shared memory, and one beyond
        s = rng.gamma(2.0, 1.0, (2, L)).astype(np.float32)
        cases.append((f"L={L}", s, rng.random(s.shape) < 0.3, i32([3, 6]), 7))
    return cases


def k8_edge_cases():
    """[(name, x (B, L) float32, adc (B, L) int16, starts (R, B), ends
    (R, B))]: the ranges that K8 (both variants), its plain version and the
    JAX package are all held to; x is the calibrated image of adc."""
    import numpy as np

    rng = np.random.default_rng(8)
    i32 = lambda rows, B: np.repeat(np.asarray(rows, np.int32)[:, None], B, axis=1)

    def calibrated(adc):
        off = rng.uniform(-260, -200, adc.shape[0]).astype(np.float32)
        sc = rng.uniform(0.1, 0.3, adc.shape[0]).astype(np.float32)
        return (adc.astype(np.float32) + off[:, None]) * sc[:, None], adc

    def reads(B, L):
        return np.clip(rng.normal(500, 80, (B, L)), -32768, 32767).astype(np.int16)

    cases = []
    cases.append(("n = 1, 2, 3", *calibrated(reads(6, 40)), i32([5, 7, 11], 6), i32([6, 9, 14], 6)))
    cases.append(("empty and inverted ranges", *calibrated(reads(6, 40)), i32([5, 9, 0, 40], 6), i32([5, 3, 0, 40], 6)))
    adc = np.full((4, 64), 511, np.int16)
    adc[1], adc[2] = -32768, 32767
    cases.append(("all-equal", *calibrated(adc), i32([0, 3, 10], 4), i32([64, 33, 11], 4)))
    adc = np.where(rng.permuted(np.arange(100)[None].repeat(4, 0), axis=1) < 50, 5, 9).astype(np.int16)
    cases.append(("heavy ties, even count, middle keys differ", *calibrated(adc), i32([0], 4), i32([100], 4)))
    adc = np.where(rng.permuted(np.arange(100)[None].repeat(4, 0), axis=1) < 60, 5, 9).astype(np.int16)
    cases.append(("heavy ties, even count, middle keys equal", *calibrated(adc), i32([0, 1], 4), i32([100, 99], 4)))
    adc = rng.integers(-32768, 32768, (6, 256)).astype(np.int16)
    adc[0, ::2], adc[0, 1::2] = -32768, 32767
    adc[1, :128] = -32768
    adc[2, 128:] = 32767
    cases.append(("the keys -32768 and 32767", *calibrated(adc), i32([0, 0, 100], 6), i32([256, 255, 156], 6)))
    cases.append(("range starts odd and off the vector alignment", *calibrated(reads(6, 256)),
                  i32([1, 3, 9, 8, 250], 6), i32([256, 131, 16, 9, 256], 6)))
    for L in (65528, 65535, 65536):  # the longest staged rows (whole vectors or not), and one beyond
        adc = reads(3, L)
        adc[:, :3000] = adc[:, :3000] // 16 * 16
        st = np.stack([np.zeros(3), rng.integers(0, L // 2, 3)]).astype(np.int32)
        en = np.stack([np.full(3, L), st[1] + rng.integers(1, L // 2, 3)]).astype(np.int32)
        cases.append((f"L={L}", *calibrated(adc), st, en))
    return cases


def k2_edge_cases():
    """[(name, x (B, L) float32, n_valid (B,) int32, w (B,) int32, w_max)]:
    the t-test inputs that K2 (both variants) and its plain version are held
    to: every width, widths outside [1, w_max], rows shorter than two
    windows, full rows, windows of equal samples (vsum = 0), a subnormal
    vsum, NaN and infinite samples, lengths off the vector size."""
    import numpy as np

    rng = np.random.default_rng(2)
    i32 = lambda v: np.asarray(v, np.int32)
    noise = lambda B, L: rng.normal(80, 12, (B, L)).astype(np.float32)
    cases = []
    widths = i32(range(1, 13))
    cases.append(("w = 1 to 12", noise(12, 1000), rng.integers(200, 1001, 12).astype(np.int32), widths, 12))
    cases.append(("w = 1 to 12, n_valid = L", noise(12, 1000), i32([1000] * 12), widths, 12))
    cases.append(("w = 0, 13, -1 and 40 (outside [1, w_max])", noise(4, 400), i32([400, 400, 300, 400]), i32([0, 13, -1, 40]), 12))
    cases.append(("w = 13 to 16 of w_max = 16", noise(4, 400), i32([400, 333, 64, 400]), i32([13, 14, 15, 16]), 16))
    cases.append(("n_valid < 2w, = 2w and 2w + 1", noise(8, 200), i32([0, 1, 5, 23, 24, 25, 3, 200]), i32([12, 12, 12, 12, 12, 12, 1, 7]), 12))
    x = noise(4, 600)
    x[0], x[1, 100:300], x[2, ::2], x[3, 200:224] = 73.25, 80.0, 5.0, -0.0
    cases.append(("equal samples over a window (vsum = 0)", x, i32([600, 600, 600, 600]), i32([12, 5, 1, 12]), 12))
    x = (rng.normal(0, 1, (3, 400)) * 1e-20).astype(np.float32)
    cases.append(("subnormal vsum", x, i32([400, 400, 399]), i32([1, 3, 12]), 12))
    x = noise(5, 400)
    x[0, 50], x[1, 60], x[1, 200], x[2, 70], x[3, 100:140], x[4, 3] = np.nan, np.inf, -np.inf, 3e38, np.inf, np.nan
    x[2, 71] = -3e38
    cases.append(("NaN, infinite and huge samples", x, i32([400, 400, 390, 400, 400]), i32([12, 4, 2, 7, 1]), 12))
    for L in (1, 7, 1001, 6271):
        B = 6
        cases.append((f"L={L} (no multiple of 4)", noise(B, L), rng.integers(L // 2, L + 1, B).astype(np.int32), i32([1, 2, 3, 6, 11, 12]), 12))
    cases.append(("L=6272, n_valid = L", noise(3, 6272), i32([6272] * 3), i32([1, 9, 12]), 12))
    return cases


# K2 past the grid and shared-memory limits it had (faults J and the grid
# cap): t-test windows past 8,986 samples, whose tile and halo outgrow
# shared memory; a row past 65,535 tiles of 1,024 positions
K2_LONG_CASES = ("w_max = 8,987, w drawn from [1, 8,987]", "B = 1, L = 67,108,865")
K2_WIDE_W = 8987
K2_LONG_ROW = 67_108_865


def k2_long_case(name):
    """(x (B, L) float32, n_valid (B,) int32, w (B,) int32, w_max) of the
    K2_LONG_CASES case `name`: at w_max = K2_WIDE_W, 24 rows of 40,000
    samples with w from [1, K2_WIDE_W] (row 0 at K2_WIDE_W with every
    sample valid, some rows too short to score) and NaN past n_valid where
    nothing may read it; at K2_LONG_ROW, one full row of w = 12."""
    import numpy as np

    rng = np.random.default_rng(23)
    if name == K2_LONG_CASES[0]:
        B, L = 24, 40_000
        x = (rng.standard_normal((B, L), dtype=np.float32) * 12 + 80).astype(np.float32)
        w = rng.integers(1, K2_WIDE_W + 1, B).astype(np.int32)
        n = rng.integers(L // 2, L + 1, B).astype(np.int32)
        w[0], n[0] = K2_WIDE_W, L
        for r in range(1, 6):
            x[r, n[r]:] = np.nan
        return x, n, w, K2_WIDE_W
    x = (rng.standard_normal((1, K2_LONG_ROW), dtype=np.float32) * 12 + 80).astype(np.float32)
    return x, np.array([K2_LONG_ROW], np.int32), np.array([12], np.int32), 12


K5_LONG_WINDOW = 67_108_865  # past 65,535 chunks of 1,024 samples


def k5_long_case():
    """(x (1, L) float32, starts (2,) int32, out_len, lengths (2,) int32):
    two windows of K5_LONG_WINDOW samples from one row a few samples
    longer, one starting before the row."""
    import numpy as np

    rng = np.random.default_rng(55)
    x = (rng.standard_normal((1, K5_LONG_WINDOW + 5), dtype=np.float32) * 12 + 80).astype(np.float32)
    return (x, np.array([-3, 4], np.int32), K5_LONG_WINDOW,
            np.array([K5_LONG_WINDOW, 50_000_001], np.int32))


def k5_edge_cases():
    """[(name, x (B, L) float32, starts (K * B,) int32, out_len, lengths
    (K * B,) int32 or None)]: the windows that K5 and its plain version are
    held to: starts that leave the row with and without lengths, lengths of
    0, out_len and beyond, an out_len and an L off the vector size (rows
    that do not start on 16 bytes), K = 1 and 3 windows a row."""
    import numpy as np

    rng = np.random.default_rng(5)
    i32 = lambda v: np.asarray(v, np.int32)
    noise = lambda B, L: rng.normal(80, 12, (B, L)).astype(np.float32)
    cases = []
    outside = i32([-20, -1, 0, 1, 2, 3, 199, 200, 201, 250, 299, 300, 400])
    cases.append(("starts below 0 and above L - out_len, clamped", noise(13, 300), outside, 100, None))
    cases.append(("starts below 0 and above L - out_len, zero-filled", noise(13, 300), outside, 100, i32([100] * 13)))
    lengths = i32([0, 100, 1, 2, 3, 4, 5, 97, 98, 99, 150, -3, 50])
    cases.append(("lengths 0, out_len, beyond and below 0", noise(13, 300), rng.integers(0, 200, 13).astype(np.int32), 100, lengths))
    cases.append(("out_len no multiple of 4", noise(6, 400), i32([0, 1, 2, 3, 301, 350]), 99, None))
    cases.append(("out_len no multiple of 4, lengths", noise(6, 400), i32([0, 1, 2, 3, 301, 350]), 99, i32([99, 98, 50, 0, 99, 99])))
    cases.append(("L no multiple of 4 (row starts off 16 bytes)", noise(7, 1001), rng.integers(-5, 950, 7).astype(np.int32), 100, None))
    cases.append(("L no multiple of 4, lengths", noise(7, 1001), rng.integers(0, 950, 7).astype(np.int32), 100, rng.integers(0, 120, 7).astype(np.int32)))
    cases.append(("K = 3 windows a row", noise(5, 1000), rng.integers(-10, 900, 15).astype(np.int32), 200, None))
    cases.append(("K = 3 windows a row, lengths", noise(5, 1000), rng.integers(0, 900, 15).astype(np.int32), 200, rng.integers(0, 260, 15).astype(np.int32)))
    cases.append(("K = 2, out_len above two chunks", noise(3, 10000), rng.integers(0, 10000, 6).astype(np.int32), 6272, rng.integers(0, 6273, 6).astype(np.int32)))
    cases.append(("out_len above L", noise(3, 64), i32([0, 10, 63]), 100, i32([100, 54, 1])))
    return cases


def k10_step_series(rng, n):
    """(query (84,), series (n, 121), lens (n,)): the consensus adapter
    and series of normalized event means at the tRNA path's shape, the
    consensus planted (with noise) at a random offset in every other row."""
    import numpy as np

    from warpdemux_tpu_torch.models.consensus_data import CONSENSUS

    q = np.asarray(CONSENSUS["rna004_130bps_v1_0"], np.float32)
    s = rng.normal(0, 1, (n, 121)).astype(np.float32)
    for b in range(0, n, 2):
        o = int(rng.integers(0, 121 - q.size + 1))
        s[b, o : o + q.size] = q + rng.normal(0, 0.3, q.size)
    return q, s, np.full(n, 121, np.int32)


def k10_edge_cases():
    """[(name, query (m,), series (B, C), lens (B,), psi)]: the matches that
    K10 and its plain version are held to: series lengths of 0, 1 and
    shorter than the query, psi_2b at and beyond the series' width,
    constant series, exact ties, non-finite values, other widths and
    query lengths, and the warp kernel's seams: query lengths where a
    lane's rows, the busy lanes or the variant change, series of 1 and 31
    events, a row of length 0 among full ones, NaN only in the last busy
    lane's query rows."""
    import numpy as np

    rng = np.random.default_rng(10)
    q, s, full = k10_step_series(rng, 33)
    cases = [("step shape, psi (5, 0, 40, 0)", q, s, full, (5, 0, 40, 0))]
    short = rng.integers(0, q.size, 33).astype(np.int32)
    short[:3] = [0, 1, q.size - 1]
    cases.append(("series_len < m (0, 1, m - 1 and random)", q, s, short, (5, 0, 40, 0)))
    cases.append(("psi_2b = c", q, s, full, (5, 0, 121, 0)))
    cases.append(("psi_2b > c, psi_1b = m", q, s, full, (84, 0, 300, 0)))
    const = np.full((5, 121), 0.5, np.float32)
    const[1], const[2] = 0.0, q[10]
    cases.append(("constant series", q, const, np.int32([121, 121, 121, 60, 0]), (5, 0, 40, 0)))
    ties = np.round(s[:9] * 2) / 2
    cases.append(("exact ties (half-integer series and query)", np.round(q * 2) / 2, ties, full[:9], (5, 0, 40, 0)))
    bad = s[:8].copy()
    bad[0, 5], bad[1, :], bad[2, 50], bad[3, :], bad[4, 7] = np.nan, np.nan, np.inf, np.inf, -np.inf
    bad[5, 100:] = np.nan
    cases.append(("NaN and infinite values", q, bad, np.int32([121, 121, 121, 121, 121, 90, 121, 0]), (5, 0, 40, 0)))
    for m, C in ((1, 7), (31, 1), (32, 300), (200, 64)):
        qe = rng.normal(0, 1, m).astype(np.float32)
        se = rng.normal(0, 1, (6, C)).astype(np.float32)
        cases.append((f"m={m} C={C}", qe, se, rng.integers(0, C + 2, 6).astype(np.int32), (2, 0, 3, 0)))
    # the warp kernel's seams: R = 3 rows a lane (m = 33, 63, 96) or 8 (the
    # others), the last busy lane full or not, all 32 busy, the largest m it
    # takes (256) and the block kernel's first
    for m in (1, 31, 32, 33, 63, 64, 65, 95, 96, 97, 255, 256, 257, 258):
        qe = rng.normal(0, 1, m).astype(np.float32)
        se = rng.normal(0, 1, (6, 121)).astype(np.float32)
        cases.append((f"m={m} C=121", qe, se, np.int32([121, 0, 1, 60, 121, 126]), (5, 0, 40, 0)))
    for C in (1, 31):
        se = rng.normal(0, 1, (6, C)).astype(np.float32)
        cases.append((f"m=84 C={C}", q, se, np.int32([C, 0, 1, C, C // 2, C + 3]), (5, 0, 40, 0)))
    cases.append(("a row of length 0 among full rows", q, s[:8], np.int32([121, 121, 121, 0, 121, 121, 121, 121]), (5, 0, 40, 0)))
    last = q.copy()
    last[-3:] = np.nan  # the three rows of the last busy lane at m = 84
    cases.append(("NaN only in the last lane's query rows (m=84)", last, s[:6], full[:6], (5, 0, 40, 0)))
    q85 = np.append(q, np.float32(np.nan))  # m = 85 (R = 8): row 85 in the last lane, rows past it copying it
    cases.append(("NaN only in the last lane's query row (m=85)", q85, s[:6], full[:6], (5, 0, 40, 0)))
    return cases


K11_LONG_ROWS = (431_105, 1_048_577)  # past the warp kernel's 431,104 samples; a fourth level past 1,048,576
K11_LONG_TIMED_ROWS = 64  # reads of K11_LONG_ROWS samples its workspace kernel is timed on


def k11_step_ranges(rng, b, length):
    """(starts, ends), each (3, b) int32: adapter, poly(A) and RNA ranges
    of reads of the step's shape, the RNA to a read length below `length`."""
    import numpy as np

    lens = rng.integers(length // 3, length + 1, b)
    a0 = rng.integers(0, 400, b)
    a1 = np.minimum(a0 + rng.integers(2500, 5500, b), lens)
    p1 = np.minimum(a1 + rng.integers(500, 3000, b), lens)
    return np.stack([a0, a1, p1]).astype(np.int32), np.stack([a1, p1, lens]).astype(np.int32)


def k11_edge_cases():
    """[(name, x (B, L) float32, calibration (adc (B, L) int16, offset (B,),
    scale (B,)) or None, starts (R, B), ends (R, B))]: the ranges that K11,
    its plain version and the JAX package are all held to. With the
    calibration, x is (adc + offset) * scale as the step forms it."""
    import numpy as np

    rng = np.random.default_rng(11)
    cases = []

    def ranges(b, length):  # whole row, halves, one sample, empty, inverted, off the row
        cand = [(0, length), (0, length // 2), (length // 3, length), (length - 1, length),
                (length // 2, length // 2), (length // 2, length // 4), (-5, length + 7), (length, length)]
        pick = rng.integers(0, len(cand), (3, b))
        pick[:, : min(b, len(cand))] = np.arange(min(b, len(cand)))[None, :]
        st = np.array([[cand[k][0] for k in row] for row in pick], np.int32)
        en = np.array([[cand[k][1] for k in row] for row in pick], np.int32)
        return st, en

    x = np.array([[2.5], [-0.0], [np.nan], [7.0]], np.float32)
    st = np.array([[0, 0, 0, 1], [0, 1, -3, 0]], np.int32)
    en = np.array([[1, 1, 1, 1], [0, 1, 5, 1]], np.int32)
    cases.append(("L=1", x, None, st, en))
    for length in (31, 32, 33, 1024, 1025, 10000, 32769):
        b = 3 if length > 10000 else 9
        x = rng.normal(80, 15, (b, length)).astype(np.float32)
        cases.append((f"L={length}", x, None, *ranges(b, length)))
    x = rng.normal(80, 15, (6, 10000)).astype(np.float32)
    st, en = k11_step_ranges(rng, 6, 10000)
    x[0, st[1, 0] + 3] = np.nan  # inside the poly(A) range
    x[1, st[0, 1]] = np.nan  # the adapter's first sample
    x[2, en[2, 2] - 1] = np.nan  # the RNA's last sample
    x[3, en[0, 3]] = np.inf  # the adapter's end: inside the poly(A)
    if st[0, 4] > 0:
        x[4, st[0, 4] - 1] = np.nan  # before every range
    x[5, -1] = np.nan  # at the row's end
    cases.append(("NaN and inf in rows", x, None, st, en))
    x = rng.normal(80, 15, (5, 10000)).astype(np.float32)
    z = np.zeros((3, 5), np.int32)
    cases.append(("rows of length 0", x, None, z, z))
    cases.append(("ranges at 0 and at L", x, None,
                  np.array([[0] * 5, [9990] * 5, [10000] * 5], np.int32),
                  np.array([[10] * 5, [10000] * 5, [10000] * 5], np.int32)))
    x = np.full((4, 100), 3.0, np.float32)
    x[1] = -0.0
    x[2, ::2], x[2, 1::2] = 1e30, -1e30
    cases.append(("constant rows, -0.0, cancellations", x, None, *ranges(4, 100)))
    for length in (31, 33, 10000, 15000):
        b = 8
        adc = rng.integers(-2000, 3000, (b, length)).astype(np.int16)
        off = rng.uniform(-5, 20, b).astype(np.float32)
        sc = rng.uniform(0.1, 0.3, b).astype(np.float32)
        x = ((adc.astype(np.float32) + off[:, None]) * sc[:, None]).astype(np.float32)
        st, en = k11_step_ranges(rng, b, length) if length > 1000 else ranges(b, length)
        cases.append((f"adc L={length}", x, (adc, off, sc), st, en))
    # the block kernel's seams: odd row lengths (every row after the first
    # starts off the 16-byte alignment of its loads) on both feeds, one row,
    # identical and nested ranges, a range in the last window alone beside
    # whole rows, the float feed at RNA002's length
    def calibrated(b, length):
        adc = rng.integers(-2000, 3000, (b, length)).astype(np.int16)
        off = rng.uniform(-5, 20, b).astype(np.float32)
        sc = rng.uniform(0.1, 0.3, b).astype(np.float32)
        return ((adc.astype(np.float32) + off[:, None]) * sc[:, None]).astype(np.float32), (adc, off, sc)

    for length in (10001, 10003):
        x, cal = calibrated(6, length)
        cases.append((f"adc L={length}, step ranges", x, cal, *k11_step_ranges(rng, 6, length)))
        cases.append((f"pa L={length}, step ranges", x, None, *k11_step_ranges(rng, 6, length)))
    x, cal = calibrated(1, 10000)
    cases.append(("adc B=1 L=10000, step ranges", x, cal, *k11_step_ranges(rng, 1, 10000)))
    x = rng.normal(80, 15, (4, 10000)).astype(np.float32)
    s0 = rng.integers(0, 3000, 4)
    e0 = s0 + rng.integers(2000, 7000, 4)
    st = np.stack([s0, s0, s0 + 700]).astype(np.int32)  # identical, then nested
    en = np.stack([e0, e0, e0 - 650]).astype(np.int32)
    cases.append(("identical and nested ranges", x, None, st, en))
    x, cal = calibrated(4, 10000)  # the last window holds samples 9976-9999 (8 zeros in front)
    st = np.array([[9980, 0, 0, 0], [5, 0, 0, 0]], np.int32)
    en = np.array([[9997, 10000, 10000, 10000], [5, 10000, 10000, 10000]], np.int32)
    cases.append(("a range in the last window beside whole rows", x, cal, st, en))
    cases.append(("the same, on the float feed", x, None, st, en))
    x = rng.normal(80, 15, (6, 15000)).astype(np.float32)
    cases.append(("pa L=15000, step ranges", x, None, *k11_step_ranges(rng, 6, 15000)))
    # rows past the warp kernel's shared memory (fault I), the workspace
    # kernel's: at 431,105 samples, and at 1,048,577, where the sum tree
    # takes a fourth level; two rows, three ranges, both feeds
    for length in K11_LONG_ROWS:
        x, cal = calibrated(2, length)
        cases.append((f"adc L={length:,}, step ranges", x, cal, *k11_step_ranges(rng, 2, length)))
        cases.append((f"pa L={length:,}, whole row, halves, edges", x, None, *ranges(2, length)))
    x, n = norm_buffer(4)
    cases.append(("the adapter buffer's edge rows, R = 1 (fault K)", x, None, np.zeros((1, len(n)), np.int32), n[None]))
    return cases


# fault K: sig_extract.normalization = "mean" / "median" (phase 2's K11
# and K4 at R = 1 on the adapter buffer, phase 15d, the CPU tests against
# JAX): edge rows made from a float read of the seed-0 batch: a constant
# read, one whose samples are three quarters equal (MAD 0), reads of 0, 1
# and 2 samples, and a single inf, -inf or NaN sample at NORM_SAMPLE, which
# every synth_minibatch adapter covers (it spans [0, >= 2800)). The adc
# feed carries no single non-finite sample: its edge rows (NORM_ADC_EDGES)
# are a constant read, MAD 0, lengths 0, 1 and 2, a spike to -32768, half
# the read saturated at 32767 and a read of two alternating levels
NORM_METHODS = ("mean", "median")
NORM_EDGES = ("constant", "MAD 0", "length 0", "length 1", "length 2", "inf sample", "-inf sample", "NaN sample")
NORM_ADC_EDGES = ("constant", "MAD 0", "length 0", "length 1", "length 2", "spike", "saturated", "two levels")
NORM_SAMPLE = 1500
NORM_WIDTH = 6272  # the RNA004 adapter buffer (FingerprintConfig.buffer_len)
NORM_ROWS = 256  # phase 15d's pa-feed step: the first NORM_ROWS - len(NORM_EDGES) reads, then NORM_EDGES
NORM_TRNA_ROWS = 64  # phase 15d's tRNA step: reads of trna_minibatch
NORM_LANE_ROWS = 32  # phase 15d's live-lane micro-batch (max_batch)
NORM_OFFLINE_ROWS = 256  # phase 15d's offline run: one minibatch


def norm_edge_row(kind, row, n):
    """(row, length) of the float edge row `kind` made from `row` of n
    samples."""
    import numpy as np

    row = np.array(row, np.float32)
    if kind == "constant":
        row[:] = 85.0
    elif kind == "MAD 0":
        row[np.arange(row.size) % 4 != 0] = 85.0
    elif kind.startswith("length"):
        n = int(kind.split()[1])
    else:
        row[NORM_SAMPLE] = {"inf sample": np.inf, "-inf sample": -np.inf, "NaN sample": np.nan}[kind]
    return row, n


def norm_edge_adc(kind, adc, n):
    """(adc row, length) of the adc-feed edge row `kind` made from the int16
    row `adc` of n samples."""
    import numpy as np

    adc = np.array(adc, np.int16)
    if kind == "constant":
        adc[:] = 724
    elif kind == "MAD 0":
        adc[np.arange(adc.size) % 4 != 0] = 724
    elif kind.startswith("length"):
        n = int(kind.split()[1])
    elif kind == "spike":
        adc[NORM_SAMPLE] = -32768
    elif kind == "saturated":
        adc[: adc.size // 2] = 32767
    else:  # two levels
        adc[:] = np.where(np.arange(adc.size) % 2 == 0, 700, 760)
    return adc, n


def norm_buffer(b, seed=0):
    """(x (b + len(NORM_EDGES), NORM_WIDTH) float32, lengths int32): the
    adapter buffer that K11 ("mean") and K4 ("median") take at R = 1, the
    range [0, length) a row: the first NORM_WIDTH calibrated samples of b
    seed reads at lengths from the seed (the whole buffer in the first),
    then a row of each of NORM_EDGES made from the first read."""
    import numpy as np

    from warpdemux_tpu_torch.utils.synthetic import synth_minibatch

    rng = np.random.default_rng(seed)
    adc, off, sc, _ = synth_minibatch(rng, b, L)
    x = ((adc[:, :NORM_WIDTH].astype(np.float32) + off[:, None]) * sc[:, None]).astype(np.float32)
    n = rng.integers(1, NORM_WIDTH + 1, b)
    n[0] = NORM_WIDTH
    edges = [norm_edge_row(kind, x[0], NORM_WIDTH) for kind in NORM_EDGES]
    rows = np.concatenate([x, np.stack([r for r, _ in edges])])
    return rows, np.concatenate([n, [k for _, k in edges]]).astype(np.int32)


def k11_work(st, en, width, with_std, calibrated):
    """A range's samples read once (the int16 preimage and its calibration
    where calibrated), the means (and stds) written once; the function sums
    the masked row, L adds a (range, row), and again its squared
    deviations."""
    n = sum(covered(st, en, width))
    n_bytes = n * (2 if calibrated else 4) + st.numel() * (8 + 4 * (1 + with_std)) + 8 * st.shape[1] * calibrated
    return n_bytes, st.numel() * width * (1 + with_std)


def check_k11(dev, card):
    """Phase 2, K11: the masked row means and stds against their plain
    version bit for bit, on every variant (the block kernel, the wrapper's
    choice at the step's shapes; the warp kernel and the workspace kernel,
    forced), at the step's shapes (the region statistics of full outputs:
    three ranges with stds over the calibrated reads; the [mvs_polya] gate:
    the poly(A) mean alone; the pa feed: float rows) and on
    k11_edge_cases() (the wrapper's choice and every kernel that takes the
    rows: the workspace kernel alone past 431,104 samples); the variants
    timed in turns at each step shape beside that shape's bound, and the
    workspace kernel at K11_LONG_ROWS; the wrapper timed beside the one
    PyTorch call of the same sums in another order, torch.where(mask, x,
    0).sum(-1). Returns the kernel's entry of the `kernels` line."""
    import numpy as np
    import torch

    from warpdemux_tpu_torch.ops import rowstats

    rng = np.random.default_rng(12)
    t = lambda a: torch.as_tensor(a, device=dev)

    def same(a, b):
        return a is None and b is None or (torch.equal(a.isnan(), b.isnan()) and torch.equal(
            a.nan_to_num().view(torch.int32), b.nan_to_num().view(torch.int32)))

    def run(x, calibration, st, en, with_std, variant=None):
        k = rowstats.range_mean_std(x, st, en, with_std, calibration, variant=variant)
        p = rowstats.range_mean_std_plain(x, st, en, with_std, calibration)
        return k, p, all(same(a, b) for a, b in zip(k, p))

    adc = rng.integers(-1500, 2500, (B, L)).astype(np.int16)
    off = rng.uniform(-5, 20, B).astype(np.float32)
    sc = rng.uniform(0.1, 0.3, B).astype(np.float32)
    cal = (t(adc), t(off), t(sc))
    x = (cal[0].to(torch.float32) + cal[1][:, None]) * cal[2][:, None]
    st, en = (t(a) for a in k11_step_ranges(rng, B, L))
    k, p, ok = run(x, cal, st, en, True)
    require(ok, "K11 at the region statistics' shape: differs from the plain version")
    err = max(max_abs(a, b) for a, b in zip(k, p))
    shapes = {  # name -> (x, calibration, starts, ends, with_std)
        "region statistics, calibrated R=3 with stds": (x, cal, st, en, True),
        "gate, calibrated R=1": (x, cal, st[1:2], en[1:2], False),
        "pa feed R=3 with stds": (x, None, st, en, True),
    }
    for name, (xs, cals, sts, ens, with_std) in shapes.items():
        chosen = rowstats._variant(L, sts.shape[0], cals is not None, None)[0]
        for variant in rowstats.VARIANTS:  # every kernel takes the step's rows
            require(run(xs, cals, sts, ens, with_std, variant)[2], f"K11 {name} ({variant} kernel): differs from the plain version")
        n_bytes, n_ops = k11_work(sts, ens, L, with_std, cals is not None)
        bound_ms, bound_by = bound(n_bytes, n_ops)
        print(f"K11 {name} B={B} L={L}: every kernel bit-equal to the plain version; the wrapper takes the "
              f"{chosen} kernel; bound_ms={bound_ms!r} by {bound_by} ({n_bytes} bytes, {n_ops} operations) on {card}")
        for variant in ("block", "warp", "global", "global", "warp", "block"):  # in turns
            fn = lambda: rowstats.range_mean_std(xs, sts, ens, with_std, cals, variant=variant)
            ms, device_ms = time_ms(fn), time_ms(fn, queued=True)
            print(f"K11 {name}, {variant} kernel: kernel_ms={ms!r} device_ms={device_ms!r} "
                  f"share of bound reached={bound_ms / ms!r} (of the device's time alone {bound_ms / device_ms!r})")
    for name, xe, cale, ste, ene in k11_edge_cases():
        xe_t = t(xe)
        cale_t = None if cale is None else tuple(t(a) for a in cale)
        kinds = [v for v in rowstats.VARIANTS if rowstats.takes(xe.shape[1], ste.shape[0], cale is not None, v)]
        for variant in (None, *kinds):
            for with_std in (True, False):
                require(run(xe_t, cale_t, t(ste), t(ene), with_std, variant)[2],
                        f"K11 {name} ({variant or 'default'} kernel, with_std={with_std}): "
                        "differs from the plain version")
        print(f"K11 {name}: means and stds bit-equal to the plain version, the wrapper's choice "
              f"({rowstats._variant(xe.shape[1], ste.shape[0], cale is not None, None)[0]}) and every kernel that "
              f"takes the rows ({', '.join(kinds)})")
    # the workspace kernel timed at rows past the warp kernel's, the three
    # region ranges with stds over calibrated reads
    for length in K11_LONG_ROWS:
        adc_l = t(rng.integers(-1500, 2500, (K11_LONG_TIMED_ROWS, length)).astype(np.int16))
        cal_l = (adc_l, cal[1][:K11_LONG_TIMED_ROWS], cal[2][:K11_LONG_TIMED_ROWS])
        x_l = (adc_l.to(torch.float32) + cal_l[1][:, None]) * cal_l[2][:, None]
        st_l, en_l = (t(a) for a in k11_step_ranges(rng, K11_LONG_TIMED_ROWS, length))
        chosen = rowstats._variant(length, 3, True, None)[0]
        k_l, p_l, ok = run(x_l, cal_l, st_l, en_l, True)
        require(ok and chosen == "global", f"K11 B={K11_LONG_TIMED_ROWS} L={length}: differs from the plain version")
        n_bytes, n_ops = k11_work(st_l, en_l, length, True, True)
        bound_ms, bound_by = bound(n_bytes, n_ops)
        fn = lambda: rowstats.range_mean_std(x_l, st_l, en_l, True, cal_l)
        device_ms = time_ms(fn, queued=True)
        print(f"K11 region statistics, calibrated R=3 with stds, B={K11_LONG_TIMED_ROWS} L={length}: the wrapper takes "
              f"the {chosen} kernel, bit-equal to the plain version; kernel_ms={time_ms(fn)!r} "
              f"device_ms={device_ms!r} plain_device_ms="
              f"{time_ms(lambda: rowstats.range_mean_std_plain(x_l, st_l, en_l, True, cal_l), reps=2, queued=True)!r} "
              f"bound_ms={bound_ms!r} by {bound_by} share={bound_ms / device_ms!r} on {card}")
        del adc_l, cal_l, x_l, k_l, p_l
    pos = torch.arange(L, device=dev)
    masks = (pos >= st[:, :, None]) & (pos < en[:, :, None])
    return time_kernel(
        "wdx_rowstats", card, err,
        lambda: rowstats.range_mean_std(x, st, en, True, cal),
        lambda: rowstats.range_mean_std_plain(x, st, en, True, cal),
        *k11_work(st, en, L, True, True),
        library=lambda: torch.where(masks, x, 0.0).sum(-1),
    )


def check_prenormalization(dev, card):
    """Phase 2, fault K: K11 ("mean": the mean and std) and K4 ("median":
    the median and MAD) at R = 1 on the adapter buffer of B seed reads and
    NORM_EDGES (`norm_buffer(B)`), the range [0, length) a row, each bit for
    bit its plain version on the card, NaN for NaN (K11 on every kernel that
    takes the rows); each timed beside its plain version and its bound; then
    `fingerprint.normalize_prefix` whole (the statistics and the
    elementwise pass) on the card against the CPU."""
    import numpy as np
    import torch

    from warpdemux_tpu_torch.ops import fingerprint, rowstats, select

    x_np, n_np = norm_buffer(B)
    x, n = torch.as_tensor(x_np, device=dev), torch.as_tensor(n_np, device=dev)
    st, en = torch.zeros_like(n)[None], n[None]
    rows, width = x.shape
    stats = {
        "K11 R=1, mean and std": (lambda v=None: rowstats.range_mean_std(x, st, en, variant=v),
                                  lambda: rowstats.range_mean_std_plain(x, st, en), k11_work(st, en, width, True, False)),
        "K4 R=1, median and MAD": (lambda v=None: select.range_median_mad(x, st, en),
                                   lambda: select.range_median_mad_plain(x, st, en),
                                   k4_work(st, en, width, (True,), True, False)),
    }
    for name, (kernel, plain, work) in stats.items():
        want = plain()
        variants = [v for v in rowstats.VARIANTS if rowstats.takes(width, 1, False, v)] if name.startswith("K11") else [None]
        for v in variants:
            got = kernel(v)
            require(all(bits_equal(a, b) for a, b in zip(got, want)),
                    f"fault K, {name} ({v or 'default'} kernel): differs from the plain version")
        err = max(max_abs(a, b) for a, b in zip(kernel(), want))
        ms, device_ms, plain_ms = time_ms(kernel), time_ms(kernel, queued=True), time_ms(plain, reps=3)
        bound_ms, bound_by = bound(*work)
        print(f"fault K, {name} on the adapter buffer ({rows} x {width}: {B} reads and {', '.join(NORM_EDGES)}): "
              f"max_abs_err={err!r} (NaN where the plain version has NaN: {int(want[0].isnan().sum())} NaN "
              f"statistics) on {', '.join(v or 'the default' for v in variants)} kernel(s); kernel_ms={ms!r} "
              f"device_ms={device_ms!r} plain_ms={plain_ms!r} bound_ms={bound_ms!r} by {bound_by} "
              f"share={bound_ms / device_ms!r} on {card}")
    for method in NORM_METHODS:
        got = fingerprint.normalize_prefix(x, n, method).cpu()
        want = fingerprint.normalize_prefix(x.cpu(), n.cpu(), method)
        require(bits_equal(got, want), f"fault K: normalize_prefix({method!r}) on the card differs from the CPU")
        print(f"fault K, normalize_prefix({method!r}) on the adapter buffer: the card's bits the CPU's, "
              f"{int(got.isnan().any(1).sum())} rows with NaN, {int(got.isinf().any(1).sum())} with inf; "
              f"{time_ms(lambda: fingerprint.normalize_prefix(x, n, method))!r} ms as called on {card}")


# the model families' widths (phase 9): no bundle ships, so their arrays
# come from a seed at the widths users train: DTW-MLP on the shipped WDX4
# bundle's 851 reference fingerprints with sklearn MLPClassifier's default
# hidden layer of 100; Fpt-Boost at catboost's defaults, 1,000 trees of
# depth 6; both with 5 classes, the last the noise class
# K12 at the shapes of the models that take it: (model, batch rows); the
# step's B, the live lane's max_batch 16 / 32, two reads, and seven and
# eleven classes on each side of their orders' switch at 51 rows; then
# shapes whose XLA order is not known (K12 sums them in the lanes order):
# one read, eleven classes at the lane's 16 rows, nine and thirteen classes
K12_SHAPES = (("WDX4_rna004_v1_0", 1000), ("WDX4_rna004_v1_0", 16), ("WDX4_rna004_v1_0", 32),
              ("WDX4_rna004_v1_0", 2), ("WDX4_tRNA_rna004_v1_0", 1000), ("WDX6_rna004_v1_0", 16),
              ("WDX6_rna004_v1_0", 1000), ("WDX10_rna004_v1_0", 64), ("WDX10_rna004_v1_0", 1000),
              ("WDX4_rna004_v1_0", 1), ("WDX10_rna004_v1_0", 16), ("WDX8_rna002_v0_4_4", 16),
              ("WDX12_rna002_v0_4_4", 32))
SVM_SIGMOID_OPS = 25  # the Platt sigmoid of one decision value: fma, abs, XLA's exp (~20), add, div
WIDE_CLASSES = (17, 24, 32, 33, 48, 64)  # K13 and the classify chain past 16 classes (phases 2 and 15)
# K1 past 32 events (phase 2), and at the shipped 25 and at 32, where the
# wide kernel serves every window but the register kernel's 15 at 25
LONG_FINGERPRINTS = (25, 32, 33, 40, 64, 100)
LONG_FINGERPRINT_ROWS = 256  # queries of phase 2's K1 checks past 32 events, against 851 references
WIDE_STEP_CLASSES, LONG_STEP_EVENTS = 24, 40  # phase 15's steps
CHAIN_ROWS = 128  # fingerprints through phase 15's classify chain
# phase 15a's SVM of pwr_dist 2, the one path left to K16: 5 classes, a
# gamma at which exp(-gamma D**2) of its distances spans (0, 1)
PWR_DIST_2_CLASSES, PWR_DIST_2_GAMMA = 5, 0.05
# phase 15c: the step at a sig_preload_size past K11's warp kernel (fault I)
LONG_ROW_READS, LONG_ROW_SAMPLES = 16, 450_000
# K12's and K13's device ms before their redesign (commit 2a0ac67's
# kernels: one thread an output; one thread a row) at WDX4's shapes:
# PERF.md section 6, NVIDIA H100 80GB HBM3, 700.00 W
SVM_DEVICE_MS_BEFORE = {("wdx_svm_dot", 1000): 0.0390, ("wdx_svm_dot", 16): 0.0371, ("wdx_svm_dot", 32): 0.0366,
                      ("wdx_svm_probs", 1000): 0.0222, ("wdx_svm_probs", 16): 0.0187,
                      ("wdx_svm_probs", 32): 0.0224}


def k12_work(B, N, P):
    """K12's bytes (kernel rows, coefficients and intercepts read once,
    decision values written once) and operations (a multiply and an add a
    term, the intercept's add)."""
    return (B * N + N * P + P + B * P) * 4, 2 * B * N * P + B * P


def k13_work(dec, params):
    """K13's bytes (decision values and Platt parameters read once,
    probabilities written once) and the operations these decision values
    need: each row's Platt sigmoids and matrix, and the coupling's passes
    that row takes, counted as the plain version runs them (on the CPU).
    A head (Q p, p Q p, the largest error) costs 2k^2 + 5k, a pass
    k (4k + 10)."""
    import torch

    from warpdemux_tpu_torch.ops import svm

    B, P = dec.shape
    k = params.n_classes
    eps = torch.tensor(0.005 / k, dtype=torch.float32)
    passes = torch.zeros(B, dtype=torch.int64)
    real = svm._p_dot

    def counted(p, Qp):
        pQp = real(p, Qp)
        passes.add_(((Qp - pQp[:, None]).abs().amax(1) >= eps).long())
        return pQp

    svm._p_dot = counted
    try:
        svm.probabilities_plain(dec.cpu(), svm.SVMParams(*(a if a is None else a.cpu() for a in params[:4]), k))
    finally:
        svm._p_dot = real
    heads = passes + (passes < max(100, k)).long()
    ops = int((heads * (2 * k * k + 5 * k) + passes * k * (4 * k + 10)).sum()) + B * P * SVM_SIGMOID_OPS + B * 3 * k * k
    return (B * P + 2 * P + B * k) * 4, ops, int(passes.max()), float(passes.float().mean())


def division_ns(dev):
    """ns a correctly rounded float32 division takes when each waits for the
    last: one thread's chain of 2n divisions less its chain of n, over n
    (csrc/svmprob.cu's probe), from CUDA events."""
    import torch

    from warpdemux_tpu_torch import _cuda

    fn = _cuda.library().wdx_div_chain
    x = torch.tensor([1.0, 1.0000001], device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n = 1 << 16
    ms = {}
    for reps in (n, 2 * n, n, 2 * n):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        require(fn(x.data_ptr(), reps, stream) == 0, "wdx_div_chain: launch failed")
        start.record()
        require(fn(x.data_ptr(), reps, stream) == 0, "wdx_div_chain: launch failed")
        stop.record()
        torch.cuda.synchronize()
        ms[reps] = start.elapsed_time(stop)
    return (ms[2 * n] - ms[n]) / n * 1e6


def check_svm(dev, card):
    """Phase 2's K12 and K13: each at the shapes of the models that take
    it, bit for bit against its plain version on the same inputs (kernel
    rows exp(-U(0, 8)) from a seed against the shipped models'
    coefficients; K13 on K12's decision values, plus rows of NaN, inf and
    zero); timed beside its bound and its time before the redesign at the step's B = 1000
    and the lane's B = 16 / 32, K12 also beside torch.addmm (TF32 off), K13
    also beside its latency floor (its slowest row's passes, each a chain
    of two dependent divisions a class, at the division's time measured
    here). Then K12 at the DTW-MLP's two layers, bit for bit against its
    plain version and timed beside torch.addmm."""
    import numpy as np
    import torch

    from warpdemux_tpu_torch import _cuda
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.ops import numerics, svm

    results = {}
    div_ns = division_ns(dev)
    print(f"a correctly rounded float32 division that waits for the last: {div_ns!r} ns on {card}")
    models = {name: load_model(name, dev) for name in dict(K12_SHAPES)}
    for name, b in K12_SHAPES:
        m = models[name]
        n, p = m.coef.shape
        K = torch.as_tensor(np.exp(-np.random.default_rng(b).uniform(0, 8, (b, n))).astype(np.float32), device=dev)
        order = numerics.dot_order(b, n, p)
        known = numerics.xla_dot_order(b, n, p) is not None
        before = _cuda.launches["wdx_svm_dot"]
        dec = svm.decision_values(K, m.params)
        require(_cuda.launches["wdx_svm_dot"] == before + 1, f"K12 {name} B={b}: not launched")
        want = svm.decision_values_plain(K, m.params)
        require(torch.equal(dec, want), f"K12 {name} B={b}: differs from the plain version")
        dec[: min(b, 3)] = torch.tensor([float("nan"), float("inf"), 0.0], device=dev)[: min(b, 3), None]
        probs, probs_plain = svm.probabilities(dec, m.params), svm.probabilities_plain(dec, m.params)
        require(probs.isnan().equal(probs_plain.isnan()) and probs.nan_to_num().equal(probs_plain.nan_to_num()),
                f"K13 {name} B={b}: differs from the plain version")
        dec = svm.decision_values(K, m.params)
        print(f"K12 {name} B={b} N={n} P={p} (order {'lanes' if order[0] == numerics.LANES else 'chain'}, kc={order[1]}"
              f"{'' if known else ', XLA order not known'}): "
              f"max_abs_err=0.0; K13 k={m.n_classes} on its decision values and rows of NaN, inf, 0: max_abs_err=0.0")
        if name != MODEL or b <= 2:  # timed at the step's and the lane's shapes
            continue
        k13_bytes, k13_ops, most, mean = k13_work(dec, m.params)
        print(f"K13 {name} B={b}: coupling passes a row: largest {most}, mean {mean!r}")
        if b == B:
            with numerics.full_float32():
                results["wdx_svm_dot"] = time_kernel(
                    "wdx_svm_dot", card, 0.0, lambda: svm.decision_values(K, m.params),
                    lambda: svm.decision_values_plain(K, m.params), *k12_work(b, n, p),
                    library=lambda: torch.addmm(m.intercept, K, m.coef), plain_reps=3)
            results["wdx_svm_probs"] = time_kernel(
                "wdx_svm_probs", card, 0.0, lambda: svm.probabilities(dec, m.params),
                lambda: svm.probabilities_plain(dec, m.params), k13_bytes, k13_ops, plain_reps=3)
            device_ms = {key: results[key]["device_ms"] for key in ("wdx_svm_dot", "wdx_svm_probs")}
        else:
            device_ms = {}
            for key, fn, work in (("wdx_svm_dot", lambda: svm.decision_values(K, m.params), k12_work(b, n, p)),
                                  ("wdx_svm_probs", lambda: svm.probabilities(dec, m.params), (k13_bytes, k13_ops))):
                ms, device_ms[key] = time_ms(fn), time_ms(fn, queued=True)
                bound_ms, bound_by = bound(*work)
                print(f"live lane {KERNELS[key][0]} B={b}: max_abs_err=0.0 kernel_ms={ms!r} "
                      f"device_ms={device_ms[key]!r} bound_ms={bound_ms!r} by {bound_by} "
                      f"share={bound_ms / device_ms[key]!r} on {card}")
        for key, ms in device_ms.items():
            print(f"{KERNELS[key][0]} B={b}: device_ms={ms!r} against {SVM_DEVICE_MS_BEFORE[(key, b)]} before the "
                  f"redesign (commit 2a0ac67; {SVM_DEVICE_MS_BEFORE[(key, b)] / ms!r}x) on {card}")
        # a Gauss-Seidel step's chain: diff's division, then the new p Q p's
        # and (Q p)[j]'s side by side, which the next step's diff waits for
        floor_ms = most * m.n_classes * 2 * div_ns * 1e-6
        print(f"K13 {name} B={b}: latency floor {floor_ms!r} ms (the largest row's {most} passes x k={m.n_classes} "
              f"x 2 dependent divisions x {div_ns!r} ns a division); share of the floor reached "
              f"{floor_ms / device_ms['wdx_svm_probs']!r} on {card}")
    check_mlp_products(dev, card)
    return results


def check_mlp_products(dev, card):
    """K12 at the DTW-MLP's two layers at the step's B, as phase 9's
    forward launches it: the hidden (B, 851) x (851, 100) + b and the
    output (B, 100) x (100, 5) + b on family_arrays' weights, the hidden
    layer's input standard normal (distances after the scaler), the output
    layer's the ReLU of the hidden layer. Each launched once and bit for bit
    its plain version; timed beside its bound and torch.addmm (TF32 off)."""
    import numpy as np
    import torch

    from warpdemux_tpu_torch import _cuda
    from warpdemux_tpu_torch.models.registry import load_model_arrays
    from warpdemux_tpu_torch.ops import numerics, svm

    X_ref = load_model_arrays(MODEL)["X_sv"].astype(np.float32)
    arrays = family_arrays("dtw_mlp", np.random.default_rng(4), X_ref)
    h = torch.as_tensor(np.random.default_rng(5).normal(0, 1, (B, X_ref.shape[0])).astype(np.float32), device=dev)
    for layer, what in enumerate(("hidden", "output")):
        W = torch.as_tensor(arrays[f"mlp_w{layer}"], device=dev)
        bias = torch.as_tensor(arrays[f"mlp_b{layer}"], device=dev)
        n, p = W.shape
        before = _cuda.launches["wdx_svm_dot"]
        got = svm.dot_bias(h, W, bias)
        require(_cuda.launches["wdx_svm_dot"] == before + 1, f"K12 DTW-MLP {what} layer: not launched")
        require(torch.equal(got, svm.dot_bias_plain(h, W, bias)),
                f"K12 DTW-MLP {what} layer: differs from the plain version")
        order = numerics.dot_order(B, n, p)
        known = numerics.xla_dot_order(B, n, p) is not None
        kernel = lambda: svm.dot_bias(h, W, bias)
        ms, device_ms = time_ms(kernel), time_ms(kernel, queued=True)
        with numerics.full_float32():
            library = lambda: torch.addmm(bias, h, W)
            library_ms, library_device_ms = time_ms(library), time_ms(library, queued=True)
        bound_ms, bound_by = bound(*k12_work(B, n, p))
        print(f"K12 DTW-MLP {what} layer B={B} N={n} P={p} (order {'lanes' if order[0] == numerics.LANES else 'chain'}, "
              f"kc={order[1]}{'' if known else ', XLA order not known'}): max_abs_err=0.0 (bit for bit) kernel_ms={ms!r} "
              f"device_ms={device_ms!r} bound_ms={bound_ms!r} by {bound_by} share={bound_ms / device_ms!r}; "
              f"torch.addmm (TF32 off) ms={library_ms!r} device_ms={library_device_ms!r} on {card}")
        h = torch.relu(got)


# K14 at the step's LLR shapes: the refinement's cost over 2 boundaries x B
# windows of 800 samples (splits 1..799), the tRNA adapter's split window
# of 6000 (`numerics.xla_log` of the stacked variances)
K14_SHAPES = {"LLR refinement": (2, 2 * B, 799), "tRNA adapter split window": (2, B, 5999)}
K14_EDGES = (0.0, -0.0, 1e-45, -1e-45, 1e-40, 1.1754944e-38, -1.0, float("inf"), float("-inf"), float("nan"),
             1.0, 0.5, 2.0, 0.70710677, 0.7071068, 1e-6, 1e6, 3.4e38)
K14_OPS = 36  # an element: the reduction's 9, eleven multiply-adds at 2, two products, the specials' 3
K14_SWEEP_CHUNKS = 64  # the 2**32 float32 bit patterns in chunks of 2**26


def k14_variances(shape, seed):
    """Variances as the LLR cost hands them to the log: log-uniform over
    [1e-6, 1e4], every 97th at the cost's clamp 1e-6."""
    import numpy as np

    v = np.exp(np.random.default_rng(seed).uniform(np.log(1e-6), np.log(1e4), shape)).astype(np.float32)
    v.reshape(-1)[::97] = np.float32(1e-6)
    return v


def check_k14(dev, card):
    """Phase 2's K14: XLA:CPU's float32 log bit for bit against its plain
    version at the step's LLR shapes, on edge values and on every float32
    bit pattern (in chunks of 2**26); timed at the refinement's shape beside
    its bound and torch.log."""
    import torch

    from warpdemux_tpu_torch import _cuda
    from warpdemux_tpu_torch.ops import numerics

    result = None
    for i, (name, shape) in enumerate(K14_SHAPES.items()):
        x = torch.as_tensor(k14_variances(shape, i), device=dev)
        before = _cuda.launches["wdx_xla_log"]
        got = numerics.xla_log(x)
        require(_cuda.launches["wdx_xla_log"] == before + 1, f"K14 {name}: not launched")
        require(bits_equal(got, numerics.xla_log_plain(x)), f"K14 {name}: differs from the plain version")
        off = int((torch.log(x).view(torch.int32) != got.view(torch.int32)).sum())
        print(f"K14 {name} {tuple(shape)}: max_abs_err=0.0 (bit for bit); torch.log differs on {off} of {x.numel()}")
        if result is None:
            result = time_kernel("wdx_xla_log", card, 0.0, lambda: numerics.xla_log(x),
                                 lambda: numerics.xla_log_plain(x), 8 * x.numel(), K14_OPS * x.numel(),
                                 library=lambda: torch.log(x), plain_reps=3)
            print("K14: library_ms is torch.log, another log (not bit-equal: the count above)")
    x = torch.tensor(K14_EDGES, dtype=torch.float32, device=dev)
    require(bits_equal(numerics.xla_log(x), numerics.xla_log_plain(x)), "K14 edges: differ from the plain version")
    t0 = time.perf_counter()
    off = 0
    for c in range(K14_SWEEP_CHUNKS):
        x = torch.arange(c << 26, (c + 1) << 26, dtype=torch.int64, device=dev).to(torch.int32).view(torch.float32)
        got, want = numerics.xla_log(x), numerics.xla_log_plain(x)
        off += int(((got.view(torch.int32) != want.view(torch.int32)) & ~(got.isnan() & want.isnan())).sum())
    require(off == 0, f"K14: {off} float32 bit patterns differ from the plain version")
    print(f"K14 on every float32 bit pattern ({K14_SWEEP_CHUNKS} x 2**26, {time.perf_counter() - t0:.1f} s): max_abs_err=0.0 "
          f"against the plain version; edges {K14_EDGES}: 0.0")
    return result


# K14, the LLR split (`detect/boundaries.llr_split`), at the step's shapes:
# the refinement's 2 x B windows of 800 samples (every split counts, the
# second segment to the window's end), and the tRNA adapter's B windows of
# 6000 (each row's own end, splits from LLR_MIN_SPLIT); its inputs are the
# windows' prefix sums, as the callers hand them over
LLR_SHAPES = {"LLR refinement": (2 * B, 800, False), "tRNA adapter split window": (B, 6000, True)}
LLR_MIN_SPLIT = 2000  # min_obs_adapter of rna004_130bps@v1.0_tRNA
# edge rows (llr_edge_windows): variances that all clamp, palindromes whose
# two end splits tie to the last bit, NaN and inf samples, squares that
# overflow, a NaN past the row's end, and row ends that mask every split,
# all but one, or leave the row one sample long
LLR_EDGES = ("constant", "zeros", "palindrome", "integer palindrome", "two levels", "NaN sample", "NaN first",
             "inf sample", "overflowing squares", "NaN past the row's end", "every split masked", "row end 1",
             "one split")
# a split: four divisions, two multiply-adds and clamps, two subtractions,
# two logs, the last product and multiply-add, the argmin's compare
LLR_OPS = 2 * K14_OPS + 18


def llr_windows(R, W, seed):
    """(windows (R, W) float32, row ends (R,) int32): a level of ~90 pA with
    a noise of 6, a step of 15 pA at a random position in every other row;
    the row ends anywhere in 1..W, every fourth at W."""
    import numpy as np

    rng = np.random.default_rng(seed)
    win = rng.normal(90, 6, (R, W)).astype(np.float32)
    cut = rng.integers(1, W, R)
    step = (np.arange(W)[None, :] >= cut[:, None]) & (np.arange(R) % 2 == 0)[:, None]
    win += np.where(step, np.float32(15), np.float32(0))
    weff = rng.integers(1, W + 1, R).astype(np.int32)
    weff[::4] = W
    return win, weff


def llr_edge_windows(W, min_split=LLR_MIN_SPLIT, seed=0):
    """(windows (len(LLR_EDGES), W) float32, row ends (len(LLR_EDGES),)
    int32): one row a name of LLR_EDGES, in that order."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rows = np.round(rng.normal(90, 6, (len(LLR_EDGES), W))).astype(np.float32)
    weff = np.full(len(LLR_EDGES), W, np.int32)
    edge = {name: i for i, name in enumerate(LLR_EDGES)}
    rows[edge["constant"]] = 90.0
    rows[edge["zeros"]] = 0.0
    rows[edge["palindrome"]] = tied_palindrome(W, lambda r: np.round(r.normal(90, 6, W // 2)))
    rows[edge["integer palindrome"]] = tied_palindrome(W, lambda r: r.integers(85, 95, W // 2))
    rows[edge["two levels"]] = np.where(np.arange(W) < W // 2, 80.0, 100.0)
    rows[edge["NaN sample"], W // 3] = np.nan
    rows[edge["NaN first"], 0] = np.nan
    rows[edge["inf sample"], W // 2] = np.inf
    rows[edge["overflowing squares"]] = 1e20
    rows[edge["NaN past the row's end"], 3 * W // 4] = np.nan
    weff[edge["NaN past the row's end"]] = W // 2
    weff[edge["every split masked"]] = min(min_split, W)
    weff[edge["row end 1"]] = 1
    weff[edge["one split"]] = min(min_split + 1, W)
    return rows, weff


def tied_palindrome(W, draw):
    """The first window [h, h reversed] of halves h = draw(default_rng(k)),
    k = 0, 1, ..., whose first and last splits cost the same to the last
    bit and least of all (the plain cost, on the CPU): the split must be
    the first one."""
    import numpy as np
    import torch

    from warpdemux_tpu_torch.detect import boundaries as bd

    for k in range(64):
        half = np.asarray(draw(np.random.default_rng(k)), np.float32)
        win = np.concatenate([half, half[::-1]])
        cost = bd._llr_cost(torch.from_numpy(win[None]))[0]
        if cost[0] == cost[-1] == cost.min():
            return win
    raise AssertionError(f"no palindrome of {W} samples ties at both ends")


def llr_work(R, W, weff, min_split):
    """(bytes, operations) of one K14 call: the two (R, W + 1) prefix sums
    and the row ends read once, the splits written once; LLR_OPS a split
    whose cost is computed, one compare a masked one."""
    import numpy as np

    n_bytes = 2 * R * (W + 1) * 4 + R * 4 + (0 if weff is None else R * 4)
    if weff is None:
        computed = R * (W - 1)
    else:
        computed = int(np.maximum(np.clip(weff, 1, W) - max(min_split, 1), 0).sum())
    return n_bytes, computed * LLR_OPS + (R * (W - 1) - computed)


def check_llr_split(dev, card):
    """Phase 2's K14: the LLR split bit for bit against its plain version at
    LLR_SHAPES, on windows from a seed and on the edge rows of LLR_EDGES;
    timed at each shape beside its bound and beside the design it replaced
    (the cost in torch operations around the elementwise log kernel)."""
    import torch

    from warpdemux_tpu_torch import _cuda
    from warpdemux_tpu_torch.detect import boundaries as bd
    from warpdemux_tpu_torch.ops import numerics

    def before(c1, c2, weff, min_split):
        """The design this kernel replaced: the cost in torch operations,
        its log through `wdx_xla_log`, then the first argmin."""
        saved = bd.xla_log_plain
        bd.xla_log_plain = numerics.xla_log
        try:
            return bd.llr_split_plain(c1, c2, weff, min_split)
        finally:
            bd.xla_log_plain = saved

    result = None
    for i, (name, (R, W, with_end)) in enumerate(LLR_SHAPES.items()):
        min_split = LLR_MIN_SPLIT if with_end else 1
        for what, (win, ends) in (("windows", llr_windows(R, W, i)), ("edge rows", llr_edge_windows(W))):
            x = torch.as_tensor(win, device=dev)
            c1, c2 = numerics.prefix_sums(x), numerics.prefix_sums(x * x)
            weff = torch.as_tensor(ends, device=dev) if with_end else None
            n = _cuda.launches["wdx_llr_split"]
            got = bd.llr_split(c1, c2, weff, min_split)
            require(_cuda.launches["wdx_llr_split"] == n + 1, f"K14 {name} {what}: not launched")
            want = bd.llr_split_plain(c1, c2, weff, min_split)
            require(torch.equal(got, want), f"K14 {name} {what}: splits differ from the plain version "
                                            f"on rows {(got != want).nonzero().flatten().tolist()[:8]}")
            require(torch.equal(before(c1, c2, weff, min_split), want), f"K14 {name} {what}: the design before differs")
        print(f"K14 {name} ({R} windows of {W}): max_abs_err=0 (every split equal) on windows and on the edge rows "
              f"{LLR_EDGES}{' (every row its own end)' if with_end else ''}")
        x = torch.as_tensor(llr_windows(R, W, i)[0], device=dev)
        c1, c2 = numerics.prefix_sums(x), numerics.prefix_sums(x * x)
        weff = torch.as_tensor(llr_windows(R, W, i)[1], device=dev) if with_end else None
        print(f"K14 {name}, timed ({R} windows of {W}):")
        entry = time_kernel("wdx_llr_split", card, 0.0, lambda: bd.llr_split(c1, c2, weff, min_split),
                            lambda: bd.llr_split_plain(c1, c2, weff, min_split),
                            *llr_work(R, W, None if weff is None else weff.cpu().numpy(), min_split), plain_reps=3)
        old = lambda: before(c1, c2, weff, min_split)  # noqa: E731
        print(f"K14 {name}: the design before (torch operations around wdx_xla_log) ms={time_ms(old, reps=3)!r} "
              f"device_ms={time_ms(old, reps=3, queued=True)!r} on {card}")
        result = result or entry
    return result


# K16 at the SVM's kernel matrix: the step's B x 851 support vectors of WDX4
# and the live lane's 16 and 32 rows, at -gamma of the shipped RNA004 models
# (1.0) and of RNA002's (1.2)
K16_SHAPES = ((B, 851), (16, 851), (32, 851))
K16_SCALES = (-1.0, -1.2)
K16_EDGES = (0.0, -0.0, 1e-45, -1e-45, 1e-40, -1.0, 1.0, 0.5, 72.9, 73.2, 87.8, -87.8, 88.8, -88.8, 103.0,
             -103.0, 1e30, -1e30, 3.4e38, float("inf"), float("-inf"), float("nan"))
K16_OPS = 36  # an element: the product, XLA's exp (its clamps at 2, eight multiply-adds at 2, floor, the shift and scale, the flush)
K16_SWEEP_CHUNKS = 64  # the 2**32 float32 bit patterns in chunks of 2**26
# K1 storing the SVM's kernel matrix: RNA004's and RNA002's gamma; the
# wide kernel's shapes (m, window, penalty, B, N) it is also held at
K1_EXP_GAMMAS = (1.0, 1.2)
K1_EXP_EDGES = ((25, 15, 0.1, 37, 131), (40, 15, 0.1, 37, 131), (32, 32, 0.5, 9, 300))


def svm_distances(shape, seed):
    """DTW distances as the step hands them to the kernel matrix: U(0, 8)
    (the kernel rows check_svm gives K12)."""
    import numpy as np

    return np.random.default_rng(seed).uniform(0, 8, shape).astype(np.float32)


def check_k16(dev, card):
    """Phase 2's K16: XLA:CPU's exp of -gamma * D bit for bit against its
    plain version (a NaN as a NaN) at K16_SHAPES and K16_SCALES, on
    distances from a seed, on edge values and at a start and length off
    its 16-byte vectors; on every float32 bit pattern at the shipped
    models' -gamma; timed at each shape beside its bound and torch.exp of
    -gamma * D (one call on the product)."""
    import torch

    from warpdemux_tpu_torch import _cuda
    from warpdemux_tpu_torch.ops import numerics

    result = None
    edges = torch.tensor(K16_EDGES, dtype=torch.float32, device=dev)
    for i, shape in enumerate(K16_SHAPES):
        D = torch.as_tensor(svm_distances(shape, i), device=dev)
        for scale in K16_SCALES:
            for what, x in (("distances", D), ("edges", edges), ("unaligned", D.reshape(-1)[1:-2])):
                n = _cuda.launches["wdx_xla_exp_scaled"]
                got = numerics.xla_exp(x, scale)
                require(_cuda.launches["wdx_xla_exp_scaled"] == n + 1, f"K16 {shape} {what}: not launched")
                require(bits_equal(got, numerics.xla_exp_plain(x, scale)),
                        f"K16 {shape} {what} scale {scale}: differs from the plain version")
        off = int((torch.exp(-1.0 * D).view(torch.int32) != numerics.xla_exp(D, -1.0).view(torch.int32)).sum())
        print(f"K16 {shape}: max_abs_err=0.0 (bit for bit) on distances, edges and an unaligned view at scales "
              f"{K16_SCALES}; torch.exp differs on {off} of {D.numel()}")
        print(f"K16 {shape}, timed:")
        entry = time_kernel("wdx_xla_exp_scaled", card, 0.0, lambda: numerics.xla_exp(D, -1.0),
                            lambda: numerics.xla_exp_plain(D, -1.0), 8 * D.numel(), K16_OPS * D.numel(),
                            library=lambda: torch.exp(-1.0 * D), plain_reps=3)
        print(f"K16 {shape}: library_ms is torch.exp of -gamma * D, another exp (not bit-equal: the count above)")
        result = result or entry
    t0 = time.perf_counter()
    off = 0
    for c in range(K16_SWEEP_CHUNKS):
        x = torch.arange(c << 26, (c + 1) << 26, dtype=torch.int64, device=dev).to(torch.int32).view(torch.float32)
        got, want = numerics.xla_exp(x, -1.0), numerics.xla_exp_plain(x, -1.0)
        off += int(((got.view(torch.int32) != want.view(torch.int32)) & ~(got.isnan() & want.isnan())).sum())
    require(off == 0, f"K16: {off} float32 bit patterns differ from the plain version")
    print(f"K16 on every float32 bit pattern at scale -1.0 ({K16_SWEEP_CHUNKS} x 2**26, "
          f"{time.perf_counter() - t0:.1f} s): max_abs_err=0.0 against the plain version")
    return result


# K15 at the shapes its callers give it: the families' 5 classes at the
# step's B, one read; 13 classes (WDX10's label count); 7 at B = 1; and 33,
# past one window of XLA's sum
K15_SHAPES = ((1000, 5), (1000, 13), (16, 5), (1, 7), (64, 33))
K15_WIDE_SHAPES = ((1000, 1025), (16, 12288))  # past one level of XLA's windows: the block kernels
# the families' widths, timed beside torch.softmax in turns: a minibatch,
# and 100 of them at once
K15_TIMED = ((1000, 5), (1000, 13), (100000, 5), (100000, 13))
# rows of 5 logits on which the softmax's edges show (each cut or padded
# with -inf to k classes by k15_edge_rows): quotients that are subnormal
# (XLA flushes them to 0), infinities, NaN, subnormal and signed-zero
# logits, exp's clamps, a difference that overflows
K15_EDGE_ROWS = ((0.0, 0.0, 0.0, -87.0, -87.2), (0.0, 0.0, 0.0, 0.0, -86.9), (float("inf"), 1.0, 2.0, 3.0, 4.0),
                 (float("-inf"), 1.0, 2.0, 3.0, 4.0), (float("-inf"),) * 5, (float("inf"),) * 5,
                 (float("nan"), 1.0, 2.0, 3.0, 4.0), (1.0, float("nan"), float("-inf"), float("inf"), 0.0),
                 (1e-40, -1e-40, 0.0, -0.0, 3.0), (88.0, -88.0, 0.0, 1.0, 2.0), (3.4e38, -3.4e38, 0.0, 0.0, 0.0),
                 (-87.5,) * 5)
K15_OPS = 30  # a class: the max's compare, the subtraction, XLA's exp (~25 with the clamps), the add, the division


def k13_wide_case(dev, k, b=B):
    """(decision values, SVMParams) of k classes from a seed: b rows normal
    with a spread of 3, rows of NaN, inf and 0 first; Platt slopes and
    offsets of the shipped models' scale."""
    import numpy as np
    import torch

    from warpdemux_tpu_torch.ops import svm

    P = k * (k - 1) // 2
    rng = np.random.default_rng(k)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    params = svm.SVMParams(None, None, t(rng.normal(-2, 0.5, P)), t(rng.normal(0, 0.3, P)), k)
    dec = t(rng.normal(0, 3, (b, P)))
    dec[:3] = torch.tensor([float("nan"), float("inf"), 0.0], device=dev)[:, None]
    return dec, params


def k13_variants(k):
    from warpdemux_tpu_torch.ops import svm

    return [v for v in svm.VARIANTS if not (v == "warp" and k > 32)
            and not (v == "shared" and svm._k13_variant(k, None) == "global")]


def check_k13_wide(dev, card):
    """Phase 2's K13 past 16 classes: at WIDE_CLASSES, B = 1000 rows of
    `k13_wide_case`, each variant that takes k (the warp kernel up to 32
    classes, the block kernel with Q in shared memory and in a global
    workspace) bit for bit the plain version and timed on the device in
    turns, beside the bound from the passes this batch takes."""
    from warpdemux_tpu_torch import _cuda
    from warpdemux_tpu_torch.ops import svm

    for k in WIDE_CLASSES:
        dec, params = k13_wide_case(dev, k)
        want = svm.probabilities_plain(dec, params)
        variants = k13_variants(k)
        for v in variants:
            before = _cuda.launches["wdx_svm_probs"]
            got = svm.probabilities(dec, params, variant=v)
            require(_cuda.launches["wdx_svm_probs"] == before + 1, f"K13 k={k} {v}: not launched once")
            require(bits_equal(got, want), f"K13 k={k} {v} kernel: differs from the plain version")
        k13_bytes, k13_ops, most, mean = k13_work(dec, params)
        bound_ms, bound_by = bound(k13_bytes, k13_ops)
        turns = variants + variants[::-1]
        times = [(v, time_ms(lambda: svm.probabilities(dec, params, variant=v), queued=True)) for v in turns]
        default = svm._k13_variant(k, None)
        print(f"K13 k={k} B={B}: max_abs_err=0.0 on every variant ({', '.join(variants)}; default {default}); "
              f"coupling passes a row: largest {most}, mean {mean!r}; bound_ms={bound_ms!r} by {bound_by}")
        for v, ms in times:
            print(f"K13 k={k} B={B} {v} kernel: device_ms={ms!r} share={bound_ms / ms!r} on {card}")


def k15_logits(shape, seed):
    """Logits as the families give them: normal with a spread of 4."""
    import numpy as np

    return np.random.default_rng(seed).normal(0, 4, shape).astype(np.float32)


def k15_edge_rows(k):
    """K15_EDGE_ROWS at k classes: (12, k) float32, each row cut to its
    first k logits or padded with -inf (which adds 0 to the sum)."""
    import numpy as np

    rows = np.full((len(K15_EDGE_ROWS), max(k, 5)), -np.inf, np.float32)
    rows[:, :5] = K15_EDGE_ROWS
    return rows[:, :k]


def k15_variants(k):
    from warpdemux_tpu_torch.ops import numerics

    return [v for v in numerics.SOFTMAX_VARIANTS if not (v == "lanes" and k > 32)
            and not (v == "warp" and k > 32 * 32)]


def check_k15(dev, card):
    """Phase 2's K15: XLA:CPU's float32 softmax bit for bit against its plain
    version (a NaN as a NaN: the card's default NaN is not the CPU's) at
    K15_SHAPES and K15_WIDE_SHAPES, on logits from a seed and on the edge
    rows at each width, on each of its kernels that takes the width (a warp
    a row by lanes or by windows, a block a row with its sums in shared
    memory or a workspace); then the lanes kernel (the default up to 32
    classes), the warp kernel (the default there before) and torch.softmax
    (another softmax: not bit-equal, the count printed) timed in turns at
    K15_TIMED beside the bound; the default at (1000, 5) in the kernels
    line."""
    import torch

    from warpdemux_tpu_torch import _cuda
    from warpdemux_tpu_torch.ops import numerics

    result = None
    for i, shape in enumerate(K15_SHAPES + K15_WIDE_SHAPES):
        variants = k15_variants(shape[1])
        for what, z in (("logits", k15_logits(shape, i)), ("edge rows", k15_edge_rows(shape[1]))):
            z = torch.as_tensor(z, device=dev)
            want = numerics.xla_softmax_plain(z)
            for v in (None, *variants):
                before = _cuda.launches["wdx_xla_softmax"]
                got = numerics.xla_softmax(z, variant=v)
                require(_cuda.launches["wdx_xla_softmax"] == before + 1, f"K15 {shape} {what} {v}: not launched")
                require(bits_equal(got, want), f"K15 {shape} {what} {v}: differs from the plain version")
        z = torch.as_tensor(k15_logits(shape, i), device=dev)
        off = int((torch.softmax(z, -1).view(torch.int32) != numerics.xla_softmax(z).view(torch.int32)).sum())
        print(f"K15 {shape}: max_abs_err=0.0 (bit for bit) on logits and on the {len(K15_EDGE_ROWS)} edge rows at "
              f"k={shape[1]}, on every kernel that takes it ({', '.join(variants)}); torch.softmax differs on "
              f"{off} of {z.numel()}")
        if result is None:
            result = time_kernel("wdx_xla_softmax", card, 0.0, lambda: numerics.xla_softmax(z),
                                 lambda: numerics.xla_softmax_plain(z), 8 * z.numel(), K15_OPS * z.numel(),
                                 library=lambda: torch.softmax(z, -1), plain_reps=3)
            print("K15: library_ms is torch.softmax, another softmax (not bit-equal: the count above)")
        if shape in K15_WIDE_SHAPES:
            for v in ("block", "global", "global", "block"):
                ms = time_ms(lambda: numerics.xla_softmax(z, variant=v), queued=True)
                bound_ms, bound_by = bound(8 * z.numel(), K15_OPS * z.numel())
                print(f"K15 {shape} {v} kernel: device_ms={ms!r} bound_ms={bound_ms!r} by {bound_by} "
                      f"share={bound_ms / ms!r} on {card}")
    for i, shape in enumerate(K15_TIMED):
        z = torch.as_tensor(k15_logits(shape, 100 + i), device=dev)
        want = numerics.xla_softmax_plain(z)
        for v in ("lanes", "warp"):
            require(bits_equal(numerics.xla_softmax(z, variant=v), want), f"K15 {shape} {v}: differs")
        bound_ms, bound_by = bound(8 * z.numel(), K15_OPS * z.numel())
        calls = {"lanes kernel": lambda: numerics.xla_softmax(z, variant="lanes"),
                 "warp kernel": lambda: numerics.xla_softmax(z, variant="warp"),
                 "torch.softmax": lambda: torch.softmax(z, -1)}
        for name in (*calls, *reversed(calls)):
            ms, device_ms = time_ms(calls[name]), time_ms(calls[name], queued=True)
            print(f"K15 {shape} in turns, {name}: kernel_ms={ms!r} device_ms={device_ms!r} bound_ms={bound_ms!r} "
                  f"by {bound_by} share={bound_ms / device_ms!r} on {card}")
    return result


FAMILY_LABELS = (3, 4, 5, 7, -1)
MLP_HIDDEN = 100
FOREST_TREES, FOREST_DEPTH = 1000, 6


def family_arrays(kind, rng, X_ref=None, trees=FOREST_TREES, depth=FOREST_DEPTH, hidden=MLP_HIDDEN,
                  scaler=None):
    """A model bundle's arrays of family `kind` ("dtw_mlp": reference
    fingerprints X_ref (n, m), standard scaling by `scaler` = (mean, scale)
    of the distances, else drawn, one ReLU layer of `hidden`; "fpt_boost":
    `trees` oblivious trees of `depth` over 25 features), drawn from `rng`,
    the classes of FAMILY_LABELS."""
    import numpy as np

    k = len(FAMILY_LABELS)
    common = dict(
        model_type=np.str_(kind),
        label_map=np.array(FAMILY_LABELS, np.int32),
        thresholds=np.array([0.2] * (k - 1) + [1.01], np.float32),
        noise_class=np.bool_(True),
    )
    if kind == "dtw_mlp":
        n = X_ref.shape[0]
        return dict(
            common, X_sv=np.asarray(X_ref, np.float32), n_layers=np.int64(2), window=np.int64(15),
            penalty=np.float64(0.1),
            scaler_mean=np.asarray(scaler[0] if scaler else rng.uniform(2.0, 6.0, n), np.float32),
            scaler_scale=np.asarray(scaler[1] if scaler else rng.uniform(0.5, 2.0, n), np.float32),
            mlp_w0=(rng.normal(0, 1, (n, hidden)) / np.sqrt(n)).astype(np.float32),
            mlp_b0=rng.normal(0, 0.1, hidden).astype(np.float32),
            mlp_w1=(rng.normal(0, 3, (hidden, k)) / np.sqrt(hidden)).astype(np.float32),
            mlp_b1=rng.normal(0, 0.1, k).astype(np.float32),
        )
    m = 25
    return dict(
        common, fingerprint_len=np.int64(m),
        feat=rng.integers(0, m, (trees, depth)).astype(np.int32),
        thr=rng.normal(0, 1, (trees, depth)).astype(np.float32),
        leaf_values=(rng.normal(0, 1, (trees, 2**depth, k)) * 1.5 / np.sqrt(trees)).astype(np.float32),
        bias=rng.normal(0, 0.1, k).astype(np.float32),
    )


def svm_arrays(k, rng, m=25, per_class=40, pwr_dist=1):
    """A DTW-SVM bundle's arrays of k classes from `rng`: per_class support
    vectors a class (N = per_class k fingerprints of m events, normal), the
    libsvm dual coefficients (k - 1, N; U(-8, 8), so that the reads' kernel
    rows, not the intercepts, pick the class), intercepts and Platt
    parameters of the shipped models' ranges, RNA004's gamma (1.0), the
    kernel's power of the distances `pwr_dist` (every shipped bundle's is
    1), the last class the noise class, thresholds of 0.2 / k (a mix of
    noise calls and classes on the bench reads); what the port's
    registry.dtw_svm_from_arrays and the JAX DTWSVMModel.from_arrays both
    read."""
    import numpy as np

    n = per_class * k
    P = k * (k - 1) // 2
    X = rng.normal(0, 1, (n, m))
    return dict(
        X_sv=X.astype(np.float32), X_sv_f64=X.astype(np.float32).astype(np.float64),
        dual_coef=rng.uniform(-8, 8, (k - 1, n)), n_support=np.full(k, per_class, np.int64),
        intercept=rng.normal(0, 0.3, P), probA=rng.uniform(-6, -4, P), probB=rng.normal(0, 0.3, P),
        classes=np.arange(k, dtype=np.int64), label_map=np.array([*range(k - 1), -1], np.int32),
        thresholds=np.array([0.2 / k] * (k - 1) + [1.01]), window=np.int64(15), penalty=np.float64(0.1),
        gamma=np.float64(1.0), pwr_dist=np.int64(pwr_dist), block_size=np.int64(500), noise_class=np.bool_(True),
        n_classes=np.int64(k),
    )


def live_lane_reads(X_sv, n=64):
    """[(read, cut)]: n barcoded replay reads on the model's support vectors,
    drawn as tools/live_latency.py draws them, each also cut where the live
    session cuts it: at the poly(A) that the streaming detector finds on its
    first max_chunk_size samples, plus the fingerprint's padding."""
    import numpy as np

    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.detect.streaming import mean_var_shift_polya_detect
    from warpdemux_tpu_torch.live.dummy import synth_barcoded_read
    from warpdemux_tpu_torch.live.session import SessionConfig

    rng = np.random.default_rng(5)
    cfg = SessionConfig()
    pad = get_model_spc_config(MODEL).fingerprint.padding
    reads = []
    for _ in range(n):
        read = synth_barcoded_read(rng, X_sv[rng.integers(0, len(X_sv))])
        polya = mean_var_shift_polya_detect(read[: cfg.max_chunk_size], cfg.streaming)
        require(polya > 0, "live lane: a replay read has no poly(A) in its first chunks")
        reads.append((read, read[: polya + pad]))
    return reads


def live_bucket_batches(reads, bucket, max_batch):
    """The cut reads in micro-batches of max_batch, held in one signal-length
    bucket: every row at most `bucket` samples, and the first row of each
    micro-batch its read's first `bucket` samples, so that the longest row
    takes the micro-batch into that bucket."""
    return [
        [read[:bucket] if j == 0 else cut[:bucket] for j, (read, cut) in enumerate(reads[i : i + max_batch])]
        for i in range(0, len(reads), max_batch)
    ]


def dtw_band_cells(m, window):
    return sum(1 for i in range(m) for j in range(m) if abs(i - j) <= window - 1)


# (bytes, operations) each kernel's function needs on given inputs: every
# input byte read once, every output byte written once, the operations of
# the function and not of the kernel's own algorithm


def k1_work(b, n, m=25, window=15, exp=False):
    """(b, m) against (n, m): the in-band cells, 6 operations each (sub,
    min, add, min, fma (2)); with `exp` (the SVM's kernel matrix), K16_OPS
    more an output."""
    return (b + n) * m * 4 + b * n * 4, b * n * (dtw_band_cells(m, window) * 6 + K16_OPS * exp)


def k2_work(n_valid, w, width):
    """The valid samples read once, the scores and n_scores written once; a
    window's mean and squared deviations once (w adds, a quotient, 3 w for
    the deviations), 14 a score for the rest (sum, difference, compare, the
    rsqrt's two Newton steps, the product)."""
    n_scores = (n_valid - 2 * w).clamp_min(0)
    n_ops = int(((n_scores + w) * (4 * w + 1) * (n_scores > 0)).sum()) + int(n_scores.sum()) * 14
    rows = n_valid.shape[0]
    return int(n_valid.clamp(max=width).sum()) * 4 + rows * width * 4 + 3 * rows * 4, n_ops


def k3_work(is_peak, dist):
    """Scores, flags and keep mask once; one round of the fixpoint: every
    peak compared with its 2 (d - 1) neighbours."""
    rows, width = is_peak.shape
    return rows * width * (4 + 1 + 1) + rows * 4, int((is_peak.sum(1) * 2 * (dist - 1)).sum())


def covered(st, en, width):
    """Samples inside each of the R ranges."""
    return (en.clamp(0, width) - st.clamp(0, width)).clamp_min(0).sum(1).tolist()


def k4_work(st, en, width, searched, with_mad, calibrated):
    """A range's samples read once; a selection a median (`searched`: per
    range, False where it is given), a MAD on top, two more to calibrate a
    sample."""
    n = covered(st, en, width)
    n_bytes = sum(n) * (6 if calibrated else 4) + st.numel() * (8 + 4 * (1 + with_mad))
    return n_bytes, sum(c * (SELECT_OPS * find + MAD_OPS * with_mad + 2 * calibrated) for c, find in zip(n, searched))


def k5_work(lengths, out_len):
    """The samples below the lengths read, the windows written."""
    rows = lengths.shape[0]
    return int(lengths.clamp(0, out_len).sum()) * 4 + rows * out_len * 4 + 2 * rows * 4, 0


def k10_work(m, lens, width):
    """The series (below the lengths), the query, the lengths and the three
    outputs moved once; 7 operations a cell of the m x length grid (a
    subtract, a square, two adds, three compares)."""
    rows = lens.shape[0]
    cells = int(lens.clamp(0, width).sum()) * m
    return int(lens.clamp(0, width).sum()) * 4 + m * 4 + rows * 4 + rows * 12, 7 * cells


def time_kernel(key, card, err, kernel, plain, n_bytes, n_ops, library=None, plain_reps=10):
    """The `kernels` line's entry of kernel `key`: its max_abs_err `err`, the
    wrapper `kernel` timed as a caller sees it and the device's time alone,
    its `plain` version, the one `library` call, and the bound from the
    function's bytes and operations on this run's inputs."""
    ms, device_ms = time_ms(kernel), time_ms(kernel, queued=True)
    plain_ms = time_ms(plain, reps=plain_reps)
    library_ms = None if library is None else time_ms(library)
    library_device_ms = None if library is None else time_ms(library, queued=True)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    print(f"{KERNELS[key][0]}: max_abs_err={err!r} kernel_ms={ms!r} device_ms={device_ms!r} plain_ms={plain_ms!r}")
    print(f"{KERNELS[key][0]}: bound_ms={bound_ms!r} by {bound_by} ({n_bytes} bytes, {n_ops} operations); "
          f"share of bound reached={bound_ms / ms!r} (of the device's time alone {bound_ms / device_ms!r}); "
          f"library_ms={library_ms!r} library_device_ms={library_device_ms!r} on {card}")
    return {
        "max_abs_err": err, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "library_device_ms": library_device_ms,
    }


def check_kernels(dev, card):
    """Phase 2: kernel vs plain version on the card, at the step's shapes,
    with each kernel's bound from this run's inputs (every input byte read
    once, every output byte written once; the operations the function needs
    on these inputs, not those of the kernel's own algorithm) and, for K5
    and K7, one PyTorch call of the same function."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from warpdemux_tpu_torch.utils.synthetic import synth_minibatch
    from warpdemux_tpu_torch import _cuda
    from warpdemux_tpu_torch.detect import boundaries as bd
    from warpdemux_tpu_torch.models.registry import load_model_arrays
    from warpdemux_tpu_torch.ops import dtw, numerics, peaks, segmentation, select, subsequence, window_gather

    rng = np.random.default_rng(1)
    t = lambda a: torch.as_tensor(a, device=dev)
    results = {}

    def record(key, *args, **kw):
        results[key] = time_kernel(key, card, *args, **kw)

    def same_bits(a, b):  # equal, NaN where the other has NaN
        return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())

    def bits(a):
        return a.contiguous().view(torch.int32)

    @contextlib.contextmanager
    def long_row_variant(module, helper):
        """Inside, the wrapper of `module` takes its kernel's variant for
        long rows (`helper`, its shared-memory size, says 0) at any shape."""
        saved = getattr(module, helper)
        setattr(module, helper, lambda *shape: 0)
        try:
            yield
        finally:
            setattr(module, helper, saved)

    def both_ms(fn):  # as a caller sees it, and the device's time alone
        return f"kernel_ms={time_ms(fn)!r} device_ms={time_ms(fn, queued=True)!r}"

    # the host's time a launch: _cuda.launch (entry point resolved once, no
    # device context on the current device, the raw stream handle) beside a
    # launch that resolves all three every time, in turns
    def launch_unresolved(blocks, threads):
        fn = getattr(_cuda.library(), "wdx_empty_launch")
        with torch.cuda.device(dev):
            err = fn(blocks, threads, torch.cuda.current_stream(dev).cuda_stream)
        require(err == 0, f"empty launch failed with {err}")

    for turn in (1, 2):
        print(f"empty launch of {B} blocks of 256 threads as called, turn {turn}: "
              f"everything resolved a launch kernel_ms={time_ms(lambda: launch_unresolved(B, 256), reps=50)!r} | "
              f"_cuda.launch kernel_ms={time_ms(lambda: _cuda.empty_launch(dev, B, 256), reps=50)!r} | "
              f"device_ms={time_ms(lambda: _cuda.empty_launch(dev, B, 256), reps=50, queued=True)!r} on {card}")

    # K1: banded DTW against WDX4 (N=851) and WDX10 (N=2601) support
    # vectors (the static m=25, window=15 instance), then the wide kernel
    # at other lattices and edge tiles, non-finite fingerprints included
    X = t(rng.normal(0, 1, (B, 25)).astype(np.float32))
    for model in ("WDX10_rna004_v1_0", MODEL):  # WDX4 last: its numbers are kept
        Y = t(load_model_arrays(model)["X_sv"].astype(np.float32))
        k = dtw.dtw_distance_matrix(X, Y, 15, 0.1)
        p = dtw.dtw_distance_matrix_plain(X, Y, 15, 0.1)
        require(torch.equal(k, p), f"K1 N={Y.shape[0]}: differs from the plain version")
        n_bytes, n_ops = k1_work(B, Y.shape[0])
        ms = time_ms(lambda: dtw.dtw_distance_matrix(X, Y, 15, 0.1))
        print(f"K1 N={Y.shape[0]}: max_abs_err={max_abs(k, p)!r} kernel_ms={ms!r} "
              f"bound_ms={bound(n_bytes, n_ops)[0]!r} on {card}")
    k1_ms = time_ms(lambda: dtw.dtw_distance_matrix(X, Y, 15, 0.1), queued=True)
    print(f"K1 N={Y.shape[0]}, distances alone: device_ms={k1_ms!r} on {card}")
    # the SVM's kernel matrix (the main path's K1): exp(-gamma * D) stored
    # by K1 itself, the bits of K1 then K16 and of the plain version, on
    # every variant that takes the shape, at RNA004's and RNA002's gamma
    for gamma in K1_EXP_GAMMAS:
        kx = dtw.dtw_kernel_matrix(X, Y, 15, 0.1, gamma)
        px = dtw.dtw_kernel_matrix_plain(X, Y, 15, 0.1, gamma)
        require(bits_equal(kx, px), f"K1 kernel matrix gamma={gamma}: differs from the plain version")
        for v in k1_variants(25, 15):
            got = dtw.dtw_kernel_matrix(X, Y, 15, 0.1, gamma, variant=v)
            two = numerics.xla_exp(dtw.dtw_distance_matrix(X, Y, 15, 0.1, variant=v), -gamma)
            require(bits_equal(got, two) and bits_equal(got, px),
                    f"K1 kernel matrix gamma={gamma} ({v} kernel): differs from K1 then K16")
        print(f"K1 kernel matrix B={B} N={Y.shape[0]} gamma={gamma}: max_abs_err={max_abs(kx, px)!r}, bits equal to "
              f"the plain version and to K1 then K16 on {', '.join(k1_variants(25, 15))}")
    gamma = K1_EXP_GAMMAS[0]
    fused = lambda: dtw.dtw_kernel_matrix(X, Y, 15, 0.1, gamma)
    unfused = lambda: numerics.xla_exp(dtw.dtw_distance_matrix(X, Y, 15, 0.1), -gamma)
    for turn in ("fused", "K1 then K16", "K1 then K16", "fused"):  # in turns
        fn = fused if turn == "fused" else unfused
        print(f"K1 kernel matrix B={B} N={Y.shape[0]}, {turn}: kernel_ms={time_ms(fn)!r} "
              f"device_ms={time_ms(fn, queued=True)!r} on {card}")
    rx = np.random.default_rng(16)  # its own draws: the later kernels' inputs stay as they were
    for m, window, penalty, b, n in K1_EXP_EDGES:  # the wide kernel, non-finite fingerprints
        Xe = rx.normal(0, 1, (b, m)).astype(np.float32)
        Ye = rx.normal(0, 1, (n, m)).astype(np.float32)
        Xe[1, 3], Xe[2, m - 1], Xe[3, 0], Ye[n - 1, 2] = np.nan, np.inf, -np.inf, np.nan
        want = dtw.dtw_kernel_matrix_plain(t(Xe), t(Ye), window, penalty, gamma)
        for v in k1_variants(m, window):
            got = dtw.dtw_kernel_matrix(t(Xe), t(Ye), window, penalty, gamma, variant=v)
            require(bits_equal(got, want), f"K1 kernel matrix m={m} window={window} ({v} kernel): differs")
        print(f"K1 kernel matrix m={m} window={window} B={b} N={n} (non-finite rows included): bits equal on "
              f"{', '.join(k1_variants(m, window))}")
    n_bytes, n_ops = k1_work(B, Y.shape[0], exp=True)
    record(
        "wdx_dtw", max_abs(kx, px), fused, lambda: dtw.dtw_kernel_matrix_plain(X, Y, 15, 0.1, gamma),
        n_bytes, n_ops, plain_reps=2,
    )
    for m, window, penalty, b, n in ((25, 15, 0.1, 37, 131), (20, 8, 0.1, 37, 131), (32, 32, 0.5, 9, 300), (25, 1, 0.0, 5, 7)):
        Xe = rng.normal(0, 1, (b, m)).astype(np.float32)
        Ye = rng.normal(0, 1, (n, m)).astype(np.float32)
        Xe[1, 3], Xe[2, m - 1], Xe[3, 0], Ye[n - 1, 2] = np.nan, np.inf, -np.inf, np.nan
        k = dtw.dtw_distance_matrix(t(Xe), t(Ye), window, penalty)
        p = dtw.dtw_distance_matrix_plain(t(Xe), t(Ye), window, penalty)
        require(same_bits(k, p), f"K1 m={m} window={window} B={b} N={n}: differs from the plain version")
        require(bool(k[1].isnan().all()) and bool(torch.isfinite(k[0, : n - 1]).all()), "K1: NaN pattern")
        print(f"K1 m={m} window={window} B={b} N={n} (non-finite rows included): max_abs_err={max_abs(k, p)!r}")
    Xt, Yt, window, penalty = k1_tie_case()
    k = dtw.dtw_distance_matrix(t(Xt), t(Yt), window, penalty)
    p = dtw.dtw_distance_matrix_plain(t(Xt), t(Yt), window, penalty)
    require(same_bits(k, p), "K1 at a float32 tie of its fused multiply-add: differs from the plain version")
    print(f"K1 at a float32 tie of its fused multiply-add (B={Xt.shape[0]}): max_abs_err={max_abs(k, p)!r}")

    # K2: t-test scores over (B, 6272) adapter buffers, bit for bit, and
    # the n_scores it writes; then the edge cases
    A = 6272
    xa = t(rng.normal(80, 12, (B, A)).astype(np.float32))
    n_valid = t(rng.integers(1000, A + 1, B).astype(np.int32))
    w = torch.clamp(torch.round(n_valid.float() / 110).int(), 1, 12)
    k, k_scores = segmentation.windowed_t_test(xa, n_valid, w, 12)
    p = segmentation.windowed_t_test_plain(xa, n_valid, w, 12)
    n_scores = torch.clamp_min(n_valid - 2 * w, 0)
    require(same_bits(k, p), "K2: differs from the plain version")
    require(torch.equal(k_scores, n_scores), "K2: n_scores differ")
    for name, xe, ne, we, w_max in k2_edge_cases():
        args = (t(xe), t(ne), t(we), w_max)
        ke, ke_scores = segmentation.windowed_t_test(*args)
        want = segmentation.windowed_t_test_plain(*args)
        require(same_bits(ke, want), f"K2 {name}: differs from the plain version")
        require(torch.equal(ke_scores, torch.clamp_min(args[1] - 2 * args[2], 0)), f"K2 {name}: n_scores differ")
        print(f"K2 {name}: max_abs_err={max_abs(ke, want)!r}, {int(want.isnan().sum())} NaN and "
              f"{int(want.isinf().sum())} infinite scores, bits equal")
    for name in K2_LONG_CASES:
        xe, ne, we, w_max = (c if isinstance(c, int) else t(c) for c in k2_long_case(name))
        ke, ke_scores = segmentation.windowed_t_test(xe, ne, we, w_max)
        want = segmentation.windowed_t_test_plain(xe, ne, we, w_max)
        require(bits_equal(ke, want), f"K2 {name}: differs from the plain version")
        require(torch.equal(ke_scores, torch.clamp_min(ne - 2 * we, 0)), f"K2 {name}: n_scores differ")
        lb, lo = k2_work(ne, we, xe.shape[1])
        print(f"K2 {name}: max_abs_err={max_abs(ke, want)!r}, {int((want > 0).sum())} scores, bits equal; "
              f"{both_ms(lambda: segmentation.windowed_t_test(xe, ne, we, w_max))} plain_device_ms="
              f"{time_ms(lambda: segmentation.windowed_t_test_plain(xe, ne, we, w_max), reps=2, queued=True)!r} "
              f"bound_ms={bound(lb, lo)[0]!r} by {bound(lb, lo)[1]} on {card}")
        del xe, ke, want
    n_bytes, n_ops = k2_work(n_valid, w, A)
    record(
        "wdx_ttest", max_abs(k, p),
        lambda: segmentation.windowed_t_test(xa, n_valid, w, 12),
        lambda: segmentation.windowed_t_test_plain(xa, n_valid, w, 12),
        n_bytes, n_ops,
    )
    print(f"K2: bound_ms with the whole buffer read (as counted until this kernel skipped the samples past n_valid)="
          f"{bound(2 * B * A * 4 + 3 * B * 4, n_ops)[0]!r}")

    # K3: distance suppression of the t-score peaks (the bit-word kernel at
    # the step's shape), then both variants on the edge cases, and the rounds
    # the fixpoint takes on this batch
    scores = p
    is_peak, _ = peaks.peak_mask_batch(scores, torch.clamp_min(n_valid - 2 * w, 0))
    dist = torch.clamp(torch.round(n_valid.float() / 220).int(), 1, 6)
    require(peaks._suppress_shared_bytes(A, 7) > 0 and peaks._suppress_shared_bytes(A, 33) == 0,
            "K3: the step's shape does not take the bit-word kernel")
    k = peaks.suppress_by_distance(scores, is_peak, dist, 7)
    p, rounds = peaks.suppress_by_distance_plain(scores, is_peak, dist, 7, count_rounds=True)
    require(torch.equal(k, p), "K3: keep masks differ")
    print(f"K3 rounds of the fixpoint on this batch: largest {int(rounds.max())}, mean a row {float(rounds.float().mean())!r}; "
          f"{int(is_peak.sum())} peaks flagged, {int(k.sum())} kept")
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    k2 = peaks.suppress_by_distance(scores, is_peak, dist, 7)
    extra = torch.cuda.max_memory_allocated() - before - B * A
    require(extra < 2**16, f"K3 allocated {extra} bytes beside its output")
    print(f"K3 at L={A}: {extra} bytes allocated beside the output")
    del k2
    for name, se, fe, de, W in k3_edge_cases():
        args = (t(se), t(fe), t(de), W)
        want = peaks.suppress_by_distance_plain(*args)
        variant = "bit words" if peaks._suppress_shared_bytes(se.shape[1], W) else "byte flags"
        require(torch.equal(peaks.suppress_by_distance(*args), want), f"K3 {name} ({variant}): differs from the plain version")
        with long_row_variant(peaks, "_suppress_shared_bytes"):
            require(torch.equal(peaks.suppress_by_distance(*args), want), f"K3 {name} (byte flags): differs from the plain version")
        print(f"K3 {name} ({variant}, and byte flags): max_abs_err=0.0, {int(want.sum())} of {int(fe.sum())} kept")
    with long_row_variant(peaks, "_suppress_shared_bytes"):
        require(torch.equal(peaks.suppress_by_distance(scores, is_peak, dist, 7), p), "K3 (byte flags): keep masks differ")
        print(f"K3 byte-flag variant at the step's shape: {both_ms(lambda: peaks.suppress_by_distance(scores, is_peak, dist, 7))}")
    record(
        "wdx_suppress", max_abs(k.int(), p.int()),
        lambda: peaks.suppress_by_distance(scores, is_peak, dist, 7),
        lambda: peaks.suppress_by_distance_plain(scores, is_peak, dist, 7),
        *k3_work(is_peak, dist),
    )

    # K4: gate medians (R=2 over L=10000, empty ranges included), the
    # outlier-clip median + MAD (R=1 over A=6272) and the full step's
    # region statistics (R=3, the adapter and poly(A) medians given, MAD
    # deviations through the calibration). The step launches it with the
    # last two.
    adc16, off, sc, _ = synth_minibatch(np.random.default_rng(2), B, L)
    adc16 = t(adc16)
    adc16[:, :3000] = adc16[:, :3000] // 16 * 16  # heavy ties
    off, sc = t(off), t(sc)
    x = (adc16.float() + off[:, None]) * sc[:, None]
    starts = t(np.stack([np.zeros(B), rng.integers(0, L, B)]).astype(np.int32))
    ends = t(np.stack([rng.integers(0, 6000, B), rng.integers(0, L + 1, B)]).astype(np.int32))
    ends[:, :50] = starts[:, :50]  # empty ranges
    a_len = n_valid[None]
    zero = torch.zeros_like(a_len)
    s3 = torch.cat([starts, starts[1:]])
    e3 = torch.cat([ends, torch.full_like(ends[1:], L)])

    meds3 = select.range_median_mad(x, s3, e3, False)[0]
    errs = []
    for args in (
        (x, starts, ends, False),
        (xa, zero, a_len, True),
        (x, s3, e3, True, None, (), (adc16, off, sc)),
        (x, s3, e3, True, meds3, (True, True, False), (adc16, off, sc)),
    ):
        km, kd = select.range_median_mad(*args)
        pm, pd = select.range_median_mad_plain(*args)
        errs += [max_abs(km, pm)] + ([max_abs(kd, pd)] if args[3] else [])
        require(torch.equal(km.isnan(), pm.isnan()), "K4: NaN pattern differs")
    require(max(errs) == 0.0, f"K4: errors {errs}")
    # edge ranges, then a row at the largest length the staged variant takes
    # and one beyond it (the streaming variant): bits equal, NaNs included
    long_cases = []
    for length in (select._STAGED_MAX_LEN, select._STAGED_MAX_LEN + 1):
        xe = rng.normal(80, 12, (4, length)).astype(np.float32)
        xe[:, :3000] = np.round(xe[:, :3000])
        st = np.stack([np.zeros(4), rng.integers(0, length // 2, 4)]).astype(np.int32)
        en = np.stack([np.full(4, length), st[1] + rng.integers(1, length // 2, 4)]).astype(np.int32)
        long_cases.append((f"L={length}", xe, st, en))
    for name, xe, st, en in k4_edge_cases() + long_cases:
        variant = "staged in shared memory" if select._staged_bytes(xe.shape[1]) else "streaming"
        km, kd = select.range_median_mad(t(xe), t(st), t(en), True)
        pm, pd = select.range_median_mad_plain(t(xe), t(st), t(en), True)
        require(torch.equal(bits(km), bits(pm)) and torch.equal(bits(kd), bits(pd)),
                f"K4 {name} ({variant}): differs from the plain version")
        print(f"K4 {name} ({variant}): max_abs_err={max(max_abs(km, pm), max_abs(kd, pd))!r}, "
              f"{int(km.isnan().sum())} NaN medians and {int(kd.isnan().sum())} NaN MADs, bits equal")
    require(select._staged_bytes(select._STAGED_MAX_LEN) > 0 and select._staged_bytes(select._STAGED_MAX_LEN + 1) == 0
            and select._staged_bytes(L) > 0,
            "K4: the variants were not both run")
    print(f"empty launch of K4's clip grid ({B} blocks of 256 threads): "
          f"{both_ms(lambda: _cuda.empty_launch(dev, B, 256))} on {card}")
    # what the clip's time is made of: the launch, the staging pass (an
    # all-equal range is selected without a round), the median's rounds, the
    # MAD's restaging and rounds
    flat = torch.full_like(xa, 80.0)
    clip_meds = select.range_median_mad(xa, zero, a_len, False)[0]
    for name, args in (
        ("all-equal rows, median only (staging, no round)", (flat, zero, a_len, False)),
        ("median only", (xa, zero, a_len, False)),
        ("median given, MAD only", (xa, zero, a_len, True, clip_meds, (True,))),
    ):
        print(f"K4 clip, {name}: {both_ms(lambda: select.range_median_mad(*args))}")
    stats_args = (x, s3, e3, True, meds3, (True, True, False), (adc16, off, sc))
    for name, args, work in (
        ("gate medians, R=2 over L=10000 (K8's shape)", (x, starts, ends, False), k4_work(starts, ends, L, (True, True), False, False)),
        ("region statistics of the full output, R=3, two medians given, calibrated MADs", stats_args, k4_work(s3, e3, L, (False, False, True), True, True)),
    ):
        print(f"K4 {name}: {both_ms(lambda: select.range_median_mad(*args))} "
              f"bound_ms={bound(*work)[0]!r} by {bound(*work)[1]} on {card}")
    record(  # the launch every path makes: the outlier clip on the adapter buffer
        "wdx_range_median_mad", max(errs),
        lambda: select.range_median_mad(xa, zero, a_len, True),
        lambda: select.range_median_mad_plain(xa, zero, a_len, True),
        *k4_work(zero, a_len, A, (True,), True, False),
    )

    # K8: the same gate medians (R=2) and the adapter-level proxy (R=1)
    # selected over the int16 ADC counts; exact against its plain version
    # and against K4, both variants; then the edge ranges
    proxy = (zero.expand(1, B), torch.full((1, B), 2000, dtype=torch.int32, device=dev))
    require(select._adc_staged_bytes(L) > 0, "K8: the step's shape does not take the staged kernel")
    errs = []
    for st, en in ((starts, ends), proxy):
        wants = (select.range_medians_adc_plain(x, adc16, st, en), select.range_median_mad(x, st, en, False)[0])
        got = [select.range_medians_adc(x, adc16, st, en)]
        with long_row_variant(select, "_adc_staged_bytes"):
            got.append(select.range_medians_adc(x, adc16, st, en))
        for k in got:
            for want in wants:
                require(torch.equal(bits(k), bits(want)), "K8: differs from its plain version or from K4")
                errs.append(max_abs(k, want))
    require(max(errs) == 0.0, f"K8: errors {errs}")
    for name, xe, ae, st, en in k8_edge_cases():
        args = (t(xe), t(ae), t(st), t(en))
        want = select.range_medians_adc_plain(*args)
        variant = "staged in shared memory" if select._adc_staged_bytes(xe.shape[1]) else "streaming"
        require(torch.equal(bits(select.range_medians_adc(*args)), bits(want)), f"K8 {name} ({variant}): differs from the plain version")
        require(torch.equal(bits(select.range_median_mad(*args[:1], *args[2:], False)[0]), bits(want)), f"K8 {name}: K4 differs")
        with long_row_variant(select, "_adc_staged_bytes"):
            require(torch.equal(bits(select.range_medians_adc(*args)), bits(want)), f"K8 {name} (streaming): differs from the plain version")
        print(f"K8 {name} ({variant}, and streaming): max_abs_err=0.0, {int(want.isnan().sum())} NaN medians, bits equal, K4's too")
    require(select._adc_staged_bytes(65535) > 0 and select._adc_staged_bytes(65536) == 0, "K8: the variants were not both run")

    def k8_work(st, en):
        """(bytes, operations): the 2-byte keys of a range's samples decide
        its median; of x it needs two values a range; starts, ends, output."""
        n = sum(covered(st, en, L))
        return n * 2 + st.numel() * (8 + 8 + 4), n * SELECT_OPS

    for (st, en), shape in (((starts, ends), "R=2"), (proxy, "R=1")):
        print(f"K8 {shape}: {both_ms(lambda: select.range_medians_adc(x, adc16, st, en))} "
              f"beside K4 {both_ms(lambda: select.range_median_mad(x, st, en, False))} "
              f"bound_ms={bound(*k8_work(st, en))[0]!r} by {bound(*k8_work(st, en))[1]} on {card}")
    with long_row_variant(select, "_adc_staged_bytes"):
        print(f"K8 streaming variant, R=2: {both_ms(lambda: select.range_medians_adc(x, adc16, starts, ends))}")
    record(
        "wdx_range_median_adc", max(errs),
        lambda: select.range_medians_adc(x, adc16, starts, ends),
        lambda: select.range_medians_adc_plain(x, adc16, starts, ends),
        *k8_work(starts, ends),
    )

    # K5: the step's shapes: the LLR refine windows (800 of 10000; one a
    # read, and two a read from the one signal) and the adapter extraction
    # (6272 of 10000 with lengths: full ones, and this batch's adapter
    # lengths); then the edge cases. The library call is torch.gather on a
    # prebuilt index, the same function where every window lies inside its
    # row at full length
    s800 = t(rng.integers(0, L - 800, 2 * B).astype(np.int32))
    sA = t(rng.integers(0, L - A + 1, B).astype(np.int32))
    full = torch.full((B,), A, dtype=torch.int32, device=dev)
    xpad = torch.cat([x, torch.zeros((B, A), device=dev)], 1)
    sP = t(rng.integers(0, L, B).astype(np.int32))  # windows that leave the signal
    k5_shapes = (
        ("refine windows, B x 800", (x, s800[:B], 800)),
        ("refine windows, 2B x 800 of B rows", (x, s800, 800)),
        ("adapter extraction, full lengths", (x, sA, A, full)),
        ("adapter extraction, this batch's adapter lengths", (x, sA, A, n_valid)),
        ("adapter extraction, windows that leave the signal", (x, sP, A, n_valid)),
        ("adapter extraction from a zero-padded copy, no lengths", (xpad, sP, A)),
    )
    errs = []
    for name, args in k5_shapes:
        k = window_gather.shift_rows(*args)
        p = window_gather.shift_rows_plain(*args)
        require(torch.equal(bits(k), bits(p)), f"K5 {name}: differs from the plain version")
        errs.append(max_abs(k, p))
        print(f"K5 {name}: max_abs_err={errs[-1]!r} {both_ms(lambda: window_gather.shift_rows(*args))}")
    # the lengths do what the padded copy and the mask did
    mask = torch.arange(A, device=dev)[None, :] < n_valid[:, None]
    want = torch.where(mask, window_gather.shift_rows(xpad, sP, A), torch.zeros((), device=dev))
    require(torch.equal(window_gather.shift_rows(x, sP, A, n_valid), want), "K5: lengths differ from pad and mask")
    require(torch.equal(window_gather.shift_rows(x, s800, 800), window_gather.shift_rows(x.repeat(2, 1), s800, 800)),
            "K5: two windows a row differ from a repeated signal")
    for name, xe, se, n, le in k5_edge_cases():
        args = (t(xe), t(se), n, None if le is None else t(le))
        require(torch.equal(bits(window_gather.shift_rows(*args)), bits(window_gather.shift_rows_plain(*args))),
                f"K5 {name}: differs from the plain version")
        print(f"K5 {name}: max_abs_err=0.0")
    xe, se, n, le = k5_long_case()
    xe, se = t(xe), t(se)
    for lengths in (None, t(le)):
        ke = window_gather.shift_rows(xe, se, n, lengths)
        want = window_gather.shift_rows_plain(xe, se, n, lengths)
        require(torch.equal(bits(ke), bits(want)), f"K5 a window of {n} samples: differs from the plain version")
        lens = torch.full_like(se, n) if lengths is None else lengths
        print(f"K5 windows of {n} samples ({se.shape[0]} of one row of {xe.shape[1]}, "
              f"{'clamped' if lengths is None else 'with lengths'}): max_abs_err={max_abs(ke, want)!r}; "
              f"{both_ms(lambda: window_gather.shift_rows(xe, se, n, lengths))} plain_device_ms="
              f"{time_ms(lambda: window_gather.shift_rows_plain(xe, se, n, lengths), reps=2, queued=True)!r} "
              f"bound_ms={bound(*k5_work(lens, n))[0]!r} on {card}")
        del ke, want
    del xe, se
    xo = torch.cat([x.new_zeros(1), x[:33].reshape(-1)])[1:].view(33, L)  # rows off 16 bytes
    require(xo.data_ptr() % 16 != 0 and xo.is_contiguous(), "K5: the view is aligned")
    require(torch.equal(window_gather.shift_rows(xo, s800[:33], 800), window_gather.shift_rows_plain(xo, s800[:33], 800)),
            "K5 row starts off the vector alignment: differs from the plain version")
    index = sA[:, None].long() + torch.arange(A, device=dev)[None, :]
    require(torch.equal(torch.gather(x, 1, index), window_gather.shift_rows(x, sA, A, full)), "K5: torch.gather differs")
    record(  # the adapter extraction: the samples below the lengths read, the buffer written
        "wdx_shift_rows", max(errs),
        lambda: window_gather.shift_rows(x, sA, A, full),
        lambda: window_gather.shift_rows_plain(x, sA, A, full),
        *k5_work(full, A),
        library=lambda: torch.gather(x, 1, index),
    )

    # K6: rolling mean/var of the calibrated signal (w 200 and 500); the
    # row's prefix sums live in shared memory, so the launch allocates its
    # three outputs and nothing else
    k = bd.rolling_mean_var(x, 200, 500)
    p = bd.rolling_mean_var_plain(x, 200, 500)
    err = max(max_abs(a, b) for a, b in zip(k, p))
    require(all(same_bits(a, b) for a, b in zip(k, p)), "K6: differs from the plain version")
    del k
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    k = bd.rolling_mean_var(x, 200, 500)
    extra = torch.cuda.max_memory_allocated() - before - 3 * B * L * 4
    require(extra < 2**20, f"K6 allocated {extra} bytes beside its outputs")
    print(f"K6 at L={L}: {extra} bytes allocated beside the three outputs")
    record(
        "wdx_rolling_mean_var", err,
        lambda: bd.rolling_mean_var(x, 200, 500),
        lambda: bd.rolling_mean_var_plain(x, 200, 500),
        4 * B * L * 4, B * L * 24,  # per sample: 2 prefix adds, a square, 6 + 4 edge adds and differences, 4 quotients, 2 fma (4), 2 clamps
    )
    # edge lengths: no multiple of 16 (nor of 4: scalar loads), shorter than
    # a block, windows longer than the row, and a row too long for shared
    # memory (the device-scratch variant)
    for b, length, w_mean, w_var in ((33, 9999, 200, 500), (33, 7, 3, 5), (33, 300, 400, 1000), (33, 4100, 200, 500), (8, 30000, 200, 500)):
        xe = t(rng.normal(80, 12, (b, length)).astype(np.float32))
        variant = "shared memory" if bd._scan_buffers(b, length, dev)[2] is None else "device scratch"
        k = bd.rolling_mean_var(xe, w_mean, w_var)
        p = bd.rolling_mean_var_plain(xe, w_mean, w_var)
        require(all(same_bits(a, b) for a, b in zip(k, p)), f"K6 L={length} ({variant}): differs from the plain version")
        print(f"K6 B={b} L={length} w=({w_mean}, {w_var}) ({variant}): max_abs_err={max(max_abs(a, b) for a, b in zip(k, p))!r}")
    require(bd._scan_buffers(B, L, dev)[2] is None and bd._scan_buffers(8, 30000, dev)[2] is not None,
            "K6: the variants were not both run")

    # K7: sustained-run counts of a candidate mask (w 100); the library call
    # is a convolution of the float mask (right-padded) with a ones kernel
    mask = t(rng.random((B, L)) < 0.4)
    k, p = bd.run_sum(mask, 100), bd.run_sum_plain(mask, 100)
    require(torch.equal(k, p), "K7 differs")
    padded = F.pad(mask.float(), (0, 99))[:, None, :]
    ones = torch.ones((1, 1, 100), device=dev)
    require(torch.equal(F.conv1d(padded, ones)[:, 0].to(torch.int32), k), "K7: conv1d differs")
    # edge lengths and windows, constant masks, row starts off the 16-byte
    # alignment, and a row too long for uint16 counts (the direct variant)
    cases = [(name, t(m), w) for name, m, w in k7_edge_cases()]
    cases.append(("row starts off the vector alignment, L=9984 w=100", t(rng.random(33 * 9984 + 1) < 0.4)[1:].view(33, 9984), 100))
    require(cases[-1][1].data_ptr() % 16 != 0 and cases[-1][1].is_contiguous(), "K7: the view is aligned")
    cases.append(("L=70000 w=100", t(rng.random((4, 70000)) < 0.4), 100))
    for name, m, w in cases:
        variant = "prefix count" if bd._run_sum_shared_bytes(m.shape[1]) else "direct"
        require(torch.equal(bd.run_sum(m, w), bd.run_sum_plain(m, w)), f"K7 {name} ({variant}): differs from the plain version")
        print(f"K7 {name} ({variant}): max_abs_err=0.0")
    require(bd._run_sum_shared_bytes(L) > 0 and bd._run_sum_shared_bytes(70000) == 0, "K7: the variants were not both run")
    record(
        "wdx_run_sum", max_abs(k, p),
        lambda: bd.run_sum(mask, 100),
        lambda: bd.run_sum_plain(mask, 100),
        B * L * (1 + 4), B * L * 2,  # a sliding count: one sample in, one out
        library=lambda: F.conv1d(padded, ones),
    )

    # K9: rolling stats + both candidate run sums of the calibrated reads,
    # a random 0/1 region (in blocks of 500 samples, so that sustained runs
    # fall inside it) and per-row thresholds; every output exact
    region = t(np.repeat(rng.random((B, L // 500)) < 0.5, 500, axis=1).astype(np.float32))
    lens = t(rng.integers(3000, L + 1, B).astype(np.int32))
    thr = 1.3 * select.range_medians_adc(x, adc16, *proxy)[0]
    args = (x, region, thr, lens, 200, 500, 100, 30.0)
    k = bd.rolling_detect(*args)
    p = bd.rolling_detect_plain(*args)
    for name, a, b in zip(("mean_f", "var_f", "var_w", "rs_plain", "rs_masked"), k, p):
        require(torch.equal(a, b), f"K9: {name} differs from the plain version")
    for name, a, b in zip(("mean_f", "var_f", "var_w"), k, bd.rolling_mean_var(x, 200, 500)):
        require(torch.equal(a, b), f"K9: {name} differs from K6")
    require(int(k[4].max()) > 0, "K9: the masked run sums are all 0")
    print(f"K9 candidates: {int((k[3] == 100).sum())} sustained, {int((k[4] == 100).sum())} inside the region")
    # the device-scratch variant (a row too long for shared memory)
    xe = t(rng.normal(100, 3, (8, 30000)).astype(np.float32))
    long_args = (xe, t(np.ones((8, 30000), np.float32)), t(np.full(8, 99.0, np.float32)),
                 t(np.full(8, 29000, np.int32)), 200, 500, 100, 30.0)
    require(all(torch.equal(a, b) for a, b in zip(bd.rolling_detect(*long_args), bd.rolling_detect_plain(*long_args))),
            "K9 L=30000 (device scratch): differs from the plain version")
    print("K9 B=8 L=30000 (device scratch): max_abs_err=0.0")
    # edge lengths of the shared-memory variant's packed prefix counts
    for b, length, w_run in ((33, 9999, 100), (5, 7, 3), (33, 300, 500), (9, 1, 1)):
        xe = t(rng.normal(100, 3, (b, length)).astype(np.float32))
        edge = (xe, t((rng.random((b, length)) < 0.7).astype(np.float32)), t(np.full(b, 99.5, np.float32)),
                t(rng.integers(length // 2, length + 1, b).astype(np.int32)), 20, 50, w_run, 30.0)
        require(bd._scan_buffers(b, length, dev, extra_shared=length)[2] is None, "K9: not the shared-memory variant")
        for name, a, want in zip(("mean_f", "var_f", "var_w", "rs_plain", "rs_masked"), bd.rolling_detect(*edge), bd.rolling_detect_plain(*edge)):
            require(same_bits(a, want) if a.is_floating_point() else torch.equal(a, want),
                    f"K9 B={b} L={length}: {name} differs from the plain version")
        print(f"K9 B={b} L={length} w_run={w_run} (shared memory): max_abs_err=0.0")
    k9_shared = bd._scan_buffers(B, L, dev, extra_shared=-(-L // 16) * 16, static_shared=bd._RUN_SUM_STATIC_BYTES)[1]
    require(0 < 2 * (k9_shared + bd._RUN_SUM_STATIC_BYTES + 1024) <= 233472, "K9: two blocks no longer fit an SM")
    print(f"K9 at L={L}: {k9_shared} bytes of dynamic shared memory a block; two blocks fit an SM's 233472")

    def unfused():  # K6 + 2 x K7 on the masks the unfused detect builds
        m, _, vw = bd.rolling_mean_var(x, 200, 500)
        pos = torch.arange(L, device=dev)[None, :]
        base = (m > thr[:, None]) & (vw < 30.0) & (pos < lens[:, None]) & (pos + 100 <= lens[:, None])
        return bd.run_sum(base, 100), bd.run_sum(base & (region > 0), 100)

    require(all(torch.equal(a, b) for a, b in zip(unfused(), k[3:])), "K9: run sums differ from K6 + K7")
    print(f"K9 beside K6 + 2 x K7 (with the mask building between them): "
          f"K9 kernel_ms={time_ms(lambda: bd.rolling_detect(*args))!r} "
          f"unfused_ms={time_ms(unfused)!r}; the device's time alone: "
          f"K9 {time_ms(lambda: bd.rolling_detect(*args), queued=True)!r} unfused {time_ms(unfused, queued=True)!r}")
    record(
        "wdx_rolling_detect", max(max_abs(a, b) for a, b in zip(k, p)),
        lambda: bd.rolling_detect(*args),
        lambda: bd.rolling_detect_plain(*args),
        B * L * (4 + 4 + 12 + 8) + B * 8, B * L * (24 + 6 + 2 * 2),  # K6, the mask's compares, two sliding counts
    )

    # K10: the consensus (m=84) matched into B series of E=121 normalized
    # event means (the tRNA path's shape), bit for bit, then the edge cases
    def k10_same(k, p):
        return torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]) and same_bits(k[2], p[2])

    q, s_np, lens_np = k10_step_series(rng, B)
    q, series, slens = t(q), t(s_np), t(lens_np)
    require(subsequence._warp_rows(q.shape[0]) == 3, "K10: the step's shape does not take the warp kernel")
    k = subsequence.subsequence_dtw(q, series, slens)
    p = subsequence.subsequence_dtw_plain(q, series, slens)
    require(k10_same(k, p), "K10 at the step shape: differs from the plain version")
    with long_row_variant(subsequence, "_warp_rows"):
        require(k10_same(subsequence.subsequence_dtw(q, series, slens), p),
                "K10 (block kernel) at the step shape: differs from the plain version")
    planted = torch.arange(B, device=dev) % 2 == 0
    require(bool((k[1] - k[0])[planted].float().mean() > 70), "K10: the planted consensus was not matched")
    for name, qe, se, le, psi in k10_edge_cases():
        args = (t(qe), t(se), t(le), 1.5, psi)
        want = subsequence.subsequence_dtw_plain(*args)
        variant = "warp" if subsequence._warp_rows(qe.size) else "block"
        require(k10_same(subsequence.subsequence_dtw(*args), want), f"K10 {name} ({variant} kernel): differs from the plain version")
        with long_row_variant(subsequence, "_warp_rows"):
            require(k10_same(subsequence.subsequence_dtw(*args), want), f"K10 {name} (block kernel): differs from the plain version")
        print(f"K10 {name} ({variant} kernel, and the block kernel): start, end and dist bit-equal to the plain version")
    # the two variants at the step's shape in turns (warp, block, block, warp)
    def k10_warp():
        return subsequence.subsequence_dtw(q, series, slens)

    def k10_block():
        with long_row_variant(subsequence, "_warp_rows"):
            return subsequence.subsequence_dtw(q, series, slens)

    k10_turns = [(name, time_ms(fn), time_ms(fn, queued=True))
                 for name, fn in (("warp", k10_warp), ("block", k10_block), ("block", k10_block), ("warp", k10_warp))]
    for name, ms, device_ms in k10_turns:
        print(f"K10 {name} kernel at the step's shape: kernel_ms={ms!r} device_ms={device_ms!r} on {card}")
    record(
        "wdx_subseq_dtw", max_abs(k[2], p[2]),
        lambda: subsequence.subsequence_dtw(q, series, slens),
        lambda: subsequence.subsequence_dtw_plain(q, series, slens),
        *k10_work(q.shape[0], slens, series.shape[1]), plain_reps=3,
    )
    check_k1_long(dev, card)
    results["wdx_rowstats"] = check_k11(dev, card)
    results.update(check_svm(dev, card))
    check_k13_wide(dev, card)
    results["wdx_xla_log"] = check_k14(dev, card)
    results["wdx_xla_softmax"] = check_k15(dev, card)
    results["wdx_llr_split"] = check_llr_split(dev, card)
    results["wdx_xla_exp_scaled"] = check_k16(dev, card)
    check_prenormalization(dev, card)
    return results


def k1_variants(m, window):
    from warpdemux_tpu_torch.ops import dtw

    return [v for v in dtw.VARIANTS if not (v == "registers" and (m, window) != dtw.REGISTER_SHAPE)
            and not (v == "shared" and not dtw.wide_threads(m))]


def check_k1_long(dev, card):
    """Phase 2's K1 past 32 events: at LONG_FINGERPRINTS, LONG_FINGERPRINT_ROWS
    queries against 851 references from a seed (NaN and infinite samples
    planted), windows 15 and m (the full lattice), each variant that takes
    the shape (the register kernel at m = 25, window 15 alone; the wide
    kernel, its DP rows in shared memory or in a global workspace) bit for
    bit the plain version; at window 15, B = 1000 queries, each timed on the
    device in turns beside its bound."""
    import numpy as np
    import torch

    from warpdemux_tpu_torch import _cuda
    from warpdemux_tpu_torch.ops import dtw

    for m in LONG_FINGERPRINTS:
        rng = np.random.default_rng(m)
        X = rng.normal(0, 1, (B, m)).astype(np.float32)
        Y = rng.normal(0, 1, (851, m)).astype(np.float32)
        X[1, 3], X[2, m - 1], X[3, 0], Y[850, 2] = np.nan, np.inf, -np.inf, np.nan
        X, Y = torch.as_tensor(X, device=dev), torch.as_tensor(Y, device=dev)
        Xc = X[:LONG_FINGERPRINT_ROWS]
        for window in (15, m):
            want = dtw.dtw_distance_matrix_plain(Xc, Y, window, 0.1)
            for v in k1_variants(m, window):
                before = _cuda.launches["wdx_dtw"]
                got = dtw.dtw_distance_matrix(Xc, Y, window, 0.1, variant=v)
                require(_cuda.launches["wdx_dtw"] == before + 1, f"K1 m={m} window={window} {v}: not launched once")
                require(bits_equal(got, want), f"K1 m={m} window={window} {v}: differs from the plain version")
        variants = k1_variants(m, 15)
        bound_ms, bound_by = bound(*k1_work(B, 851, m, 15))
        print(f"K1 m={m}: max_abs_err=0.0 at windows 15 and {m} on every variant that takes them ({', '.join(variants)} "
              f"at 15; default {dtw._k1_variant(m, 15, None)}); at B={B} N=851 window=15 bound_ms={bound_ms!r} by {bound_by}")
        for v in variants + variants[::-1]:
            ms = time_ms(lambda: dtw.dtw_distance_matrix(X, Y, 15, 0.1, variant=v), queued=True)
            print(f"K1 m={m} B={B} N=851 window=15 {v} kernel: device_ms={ms!r} share={bound_ms / ms!r} on {card}")


def _steps(dev):
    """The three main-path steps on `dev` (and their CPU twins)."""
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    spc = get_model_spc_config(MODEL)
    kw = {
        "adc_decision": dict(input_format="adc", outputs="decision", fused_rolling=False),
        "vbz_full": dict(input_format="vbz", outputs="full", fused_rolling=False),
        "fused_decision": dict(input_format="adc", outputs="decision", fused_rolling=True),
    }
    return {path: make_demux_step(load_model(MODEL, dev), spc, device=dev, **kw[path]) for path in PATHS}


def vbz_batch(adc, off, sc, lens):
    """Reads packed into the VBZ wire with the port's numpy helpers, at
    synthetic.VBZ_WIDTH data bytes a row, or the multiple of 1024 that holds
    the longest (rows of more than 10,000 samples)."""
    from warpdemux_tpu_torch.tools._trace import vbz_pack

    return (*vbz_pack(adc), off, sc, lens)


def _decisions(out):
    succ = out.success.cpu().numpy()
    pred = out.pred.cpu().numpy()
    fail = out.fail_code.cpu().numpy() if hasattr(out, "fail_code") else out.unpack().fail_code
    return succ, fail, pred


def _check_pins(name, out):
    succ, fail, pred = _decisions(out)
    counts = (
        int(succ.sum()),
        dict(Counter(pred[succ].tolist())),
        dict(Counter(fail[~succ].tolist())),
    )
    print(f"{name}: passes={counts[0]} calls={counts[1]} fails={counts[2]}")
    return counts


def _drive(path, step, args):
    """One main-path run with every launch count at 0 before it."""
    import torch

    from warpdemux_tpu_torch import _cuda

    _cuda.reset_launches()
    out = step(*args)
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    print(f"launches in the {path} run: {launches}")
    require(launches == dict(zip(KERNELS, LAUNCHES[path])), f"{path}: launches differ from {LAUNCHES[path]}")
    return out, launches


def _tolerance(name, is_int):
    """(rtol, atol) of a full-output column GPU vs CPU; None = exact.
    Integers, order statistics and the region means / stds (K11 and its
    plain version sum in one order) exact; probabilities to float32
    summation order, fingerprints and adapter event statistics to 1e-4."""
    if name == "fpt" or name.startswith("adapter_event_"):
        return (0.0, 1e-4)
    if is_int or name.endswith(("_med", "_mad", "_mean", "_std")) or name.startswith("mvs_"):
        return None
    if name == "probs":
        return (1e-5, 1e-6)
    raise AssertionError(f"no tolerance for column {name}")


def _compare_full(gpu, cpu, exact_rows=None):
    """Rows agreeing exactly on every integer, median and MAD column (and
    where `exact_rows`, a (B,) bool of rows agreeing on other columns, says
    so), NaN for NaN; the other floats must be within tolerance, NaN where
    the CPU has NaN. The fingerprint columns are held where the fingerprint
    succeeded (an empty adapter's changepoints are unspecified)."""
    import numpy as np

    from warpdemux_tpu_torch.pipeline.schema import PackSchema

    gi, gf = gpu.big_i.cpu().numpy(), gpu.big_f.cpu().numpy()
    ci, cf = cpu.big_i.numpy(), cpu.big_f.numpy()
    schema = PackSchema.from_buffers(ci, cf)
    cpu_cols = {**schema.unpack(ci, np.int32), **schema.unpack(cf, np.float32)}
    gpu_cols = {**schema.unpack(gi, np.int32), **schema.unpack(gf, np.float32)}
    n = ci.shape[0]
    ok = cpu_cols["fpt_ok"] == 1
    same = np.ones(n, bool) if exact_rows is None else np.asarray(exact_rows, bool).copy()
    for name, c in cpu_cols.items():
        g = gpu_cols[name]
        rows = ok if name == "dwell" or name.startswith(("fpt", "adapter_dt_", "adapter_event_")) else np.ones(n, bool)
        tol = _tolerance(name, name in schema.int_slices)
        both_nan = np.isnan(g) & np.isnan(c)
        if tol is None:
            same &= ~(((g != c) & ~both_nan).reshape(n, -1).any(1) & rows)
        else:
            off = (np.abs(g - c) > tol[1] + tol[0] * np.abs(c)) | (np.isnan(g) != np.isnan(c))
            bad = off.reshape(n, -1).any(1) & rows
            require(not bad.any(), f"vbz full: column {name} off tolerance on rows {np.nonzero(bad)[0][:10]}")
    return int(same.sum())


def count_device_ops(step, args):
    """Device operations (kernels, copies, memsets) of one step, as
    torch.profiler records them after a warm-up step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(*args)
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


@contextlib.contextmanager
def captured_kernel_calls():
    """Inside, every call of the live lane's seven kernel wrappers is
    recorded as {launch-count key: (wrapper, args, plain version)}: the
    arguments the lane program gives each kernel (K1's: the SVM's kernel
    matrix, which it stores with its exp)."""
    import importlib

    from warpdemux_tpu_torch.models import dtw_svm
    from warpdemux_tpu_torch.ops import dtw, fingerprint, peaks, segmentation, select, svm, window_gather

    # the module: the package exports the function `normalize` under its name
    normalize = importlib.import_module("warpdemux_tpu_torch.ops.normalize")
    sites = (  # (module that calls it, name there, key, plain version)
        (fingerprint, "shift_rows", "wdx_shift_rows", window_gather.shift_rows_plain),
        (normalize, "range_median_mad", "wdx_range_median_mad", select.range_median_mad_plain),
        (segmentation, "windowed_t_test", "wdx_ttest", segmentation.windowed_t_test_plain),
        (peaks, "suppress_by_distance", "wdx_suppress", peaks.suppress_by_distance_plain),
        (dtw_svm, "dtw_kernel_matrix", "wdx_dtw", dtw.dtw_kernel_matrix_plain),
        (svm, "decision_values", "wdx_svm_dot", svm.decision_values_plain),
        (svm, "probabilities", "wdx_svm_probs", svm.probabilities_plain),
    )
    calls = {}

    def recorder(fn, key, plain):
        def call(*args):  # every lane call site passes its arguments by position
            calls[key] = (fn, args, plain)
            return fn(*args)
        return call

    saved = [(module, name, getattr(module, name)) for module, name, _, _ in sites]
    for module, name, key, plain in sites:
        setattr(module, name, recorder(getattr(module, name), key, plain))
    try:
        yield calls
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def lane_kernel_work(key, args):
    """(bytes, operations) of one lane kernel call, from its arguments."""
    if key == "wdx_shift_rows":
        _, _, out_len, lengths = args
        return k5_work(lengths, out_len)
    if key == "wdx_range_median_mad":
        x, starts, ends = args[:3]
        return k4_work(starts, ends, x.shape[1], (True,), True, False)
    if key == "wdx_ttest":
        x, n_valid, w, _ = args
        return k2_work(n_valid, w, x.shape[1])
    if key == "wdx_suppress":
        return k3_work(args[1], args[2])
    if key == "wdx_svm_dot":
        K, params = args
        return k12_work(K.shape[0], *params.coef.shape)
    if key == "wdx_svm_probs":
        return k13_work(*args[:2])[:2]
    X, Y = args[:2]
    return k1_work(X.shape[0], Y.shape[0], X.shape[1], args[2], exp=True)


def run_live_lane(dev, card):
    """Phase 6: the live read-until lane on the card. Returns the launch
    counts of one micro-batch of the lane program, and that program (B=16,
    the reads' own bucket) as a function of no argument."""
    import tempfile

    import numpy as np
    import torch

    from warpdemux_tpu_torch import _cuda
    from warpdemux_tpu_torch.live.balancer import BalancerConfig, BarcodeBalancers
    from warpdemux_tpu_torch.live.session import Session, SessionConfig
    from warpdemux_tpu_torch.models.registry import load_model

    models = {"gpu": load_model(MODEL, dev), "cpu": load_model(MODEL, "cpu")}
    reads = live_lane_reads(models["cpu"].X_sv.numpy())
    # the bucket the cut reads fall in; K5 is also timed at the ladder's ends
    natural = next(b for b in Session._LEN_BUCKETS if b >= max(cut.size for _, cut in reads))
    timed = (Session._LEN_BUCKETS[0], natural, Session._LEN_BUCKETS[-1])
    save = tempfile.TemporaryDirectory()

    def session(where, max_batch):
        cfg = SessionConfig(model_name=MODEL, save_path=save.name, run_id=f"{where}{max_batch}",
                            max_batch=max_batch)
        balancers = BarcodeBalancers.from_configs(
            4, [BalancerConfig(balance_type="adapter_count")], [1.0], n_channels=126)
        return Session(None, cfg, balancers, model=models[where], device=dev if where == "gpu" else "cpu")

    def by_read(lane):  # each read's (kept, prediction), the packed rows mapped back
        pred = np.full(lane.ok.shape, -2, np.int32)
        pred[lane.ok] = lane.pred[: int(lane.ok.sum())]
        return lane.ok, pred

    # 6a. the lane program, every read in every bucket, GPU against CPU;
    # the first micro-batch's launch counts are the path's
    one_batch = None
    calls = {}
    for max_batch in (32, 16):
        gpu, cpu = session("gpu", max_batch), session("cpu", max_batch)
        for bucket in Session._LEN_BUCKETS:
            same = n = 0
            conf_err = 0.0
            for rows in live_bucket_batches(reads, bucket, max_batch):
                _cuda.reset_launches()
                with captured_kernel_calls() as captured:
                    got = gpu._classify_on_device(rows)
                torch.cuda.synchronize()
                launches = dict(_cuda.launches)
                require(launches == dict(zip(KERNELS, LAUNCHES["live_lane"])),
                        f"live lane B={max_batch} L={bucket}: launches {launches}, want {LAUNCHES['live_lane']}")
                one_batch = one_batch or launches
                if bucket in timed:
                    calls.setdefault((max_batch, bucket), captured)
                want = cpu._classify_on_device(rows)
                (g_ok, g_pred), (c_ok, c_pred) = by_read(got), by_read(want)
                same += int(((g_ok == c_ok) & (g_pred == c_pred)).sum())
                n += len(rows)
                both = g_ok & c_ok
                if both.any():
                    g_conf, c_conf = np.zeros(len(rows), np.float32), np.zeros(len(rows), np.float32)
                    g_conf[g_ok], c_conf[c_ok] = got.conf[: int(g_ok.sum())], want.conf[: int(c_ok.sum())]
                    conf_err = max(conf_err, float(np.abs(g_conf - c_conf)[both].max()))
            print(f"live lane B={max_batch} L={bucket}: rows agreeing GPU vs CPU on (ok, pred) {same}/{n}; "
                  f"max |conf gpu - cpu| = {conf_err!r}")
            require(same >= n - 1, f"live lane B={max_batch} L={bucket}: GPU and CPU disagree")
        gpu.reporter.close()
        cpu.reporter.close()
    print(f"launches of one micro-batch of the live lane: {one_batch}")

    # 6b. the seven kernels at the lane's shapes, held against their plain
    # versions; then the lane program as a whole
    for (max_batch, bucket), captured in sorted(calls.items()):
        require(set(captured) == {k for k, n in zip(KERNELS, LAUNCHES["live_lane"]) if n},
                f"live lane: captured {sorted(captured)}")
        for key, (fn, args, plain) in captured.items():
            if key == "wdx_shift_rows" or bucket == natural:  # only K5's shape depends on L
                k, p = fn(*args), plain(*args)
                k = k[0] if key == "wdx_ttest" else k
                err = max(max_abs(a, b) for a, b in zip(k, p)) if key == "wdx_range_median_mad" else max_abs(k, p)
                require(err == 0.0, f"live lane {KERNELS[key][0]} B={max_batch} L={bucket}: max_abs_err {err}")
                ms, device_ms = time_ms(lambda: fn(*args)), time_ms(lambda: fn(*args), queued=True)
                bound_ms, bound_by = bound(*lane_kernel_work(key, args))
                print(f"live lane {KERNELS[key][0]} B={max_batch} L={bucket}: max_abs_err={err!r} kernel_ms={ms!r} "
                      f"device_ms={device_ms!r} bound_ms={bound_ms!r} by {bound_by} "
                      f"share={bound_ms / device_ms!r} on {card}")
    for max_batch in (16, 32):
        gpu = session("gpu", max_batch)
        for bucket in Session._LEN_BUCKETS:
            rows = live_bucket_batches(reads, bucket, max_batch)[0]
            gpu._classify_on_device(rows)
            lanes, t0 = [], time.perf_counter()
            for _ in range(10):
                lanes.append(gpu._classify_on_device(rows))
            ms = (time.perf_counter() - t0) / 10 * 1e3
            fp = sum(lane.seconds_fingerprint for lane in lanes) / 10 * 1e3
            cls = sum(lane.seconds_classify for lane in lanes) / 10 * 1e3
            print(f"live lane program B={max_batch} L={bucket}: {ms!r} ms a micro-batch as called (signals to fetched "
                  f"decisions); on the stream: fingerprint {fp!r} ms, pack and classify {cls!r} ms on {card}")
        gpu.reporter.close()

    # 6c. a whole session on the replay client through the port's
    # tools/live_latency (four classifier threads, the configured count,
    # then one): the decision latency, and no classifier thread may raise
    from warpdemux_tpu_torch.tools import live_latency

    for threads in (4, 1):
        run = live_latency.measure(reads=400, channels=126, max_batch=16, batch_wait=0.005,
                                   nproc_classification=threads, device=dev, save=save.name)
        name = f"live session, {threads} classifier thread{'s' if threads > 1 else ''}"
        require(not run.errors, f"{name}: a classifier thread raised: {run.errors}")
        print(f"launches in the {name}: {run.launches}")
        counts = [run.launches[k] for k, n in zip(KERNELS, LAUNCHES["live_lane"]) if n]
        require(min(counts) > 0 and len(set(counts)) == 1, f"{name}: the lane's kernels not launched once a micro-batch")
        require(all(run.launches[k] == 0 for k, n in zip(KERNELS, LAUNCHES["live_lane"]) if not n), f"{name}: K6-K11 ran")
        require(run.undecided == 0, f"{name}: {run.undecided} delivered reads got no decision")
        reported = sum(run.counters["accept"].values()) + sum(run.counters["reject"].values())
        classified = run.counters["accept"]["classified"] + run.counters["reject"]["classified"]
        print(f"{name}: {run.delivered} reads delivered, {reported} reported, {classified} classified, "
              f"{counts[0]} micro-batches (6 of them the warm-up), wall {run.wall_s!r} s; counters {run.counters}")
        require(classified >= 0.3 * reported, f"{name}: fewer than 30% of reads classified")
        print("\n".join(f"{name} {line}" for line in live_latency.table(run.percentiles)))
        for stage, v in run.percentiles.items():
            print(f"{name} {stage}: n={v['n']} p50={v['p50'] * 1e3!r} p90={v['p90'] * 1e3!r} "
                  f"p99={v['p99'] * 1e3!r} max={v['max'] * 1e3!r} ms on {card}")
        p99 = run.percentiles["total"]["p99"]
        print(f"{name}: p99 decision latency {p99 * 1e3!r} ms {'within' if p99 <= 0.1 else 'over'} "
              f"one 100 ms chunk period on {card}")

    # 6d. the port's tools/live_soak on the card, in a process of its own
    # (its RSS is the lane's alone): every read decided and written once,
    # the report's RSS and device memory at a third of the decisions and at
    # the end
    out = subprocess.run([sys.executable, "-m", "warpdemux_tpu_torch.tools.live_soak", "--reads", str(SOAK_READS)],
                         capture_output=True, text=True, timeout=600)
    require(out.returncode == 0, f"live soak: exit {out.returncode}: {out.stderr[-3000:]}")
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    print(f"live soak report: {json.dumps(rep)}")
    require(rep["reads"] == rep["decided"] == rep["csv_rows"] == SOAK_READS,
            f"live soak: {rep['decided']} decided, {rep['csv_rows']} CSV rows of {rep['reads']} reads")
    require(rep["device"] == torch.cuda.get_device_name(0), f"live soak ran on {rep['device']}")
    growth = rep["rss_mb_final"] / rep["rss_mb_third"] - 1.0
    print(f"live soak, {SOAK_READS} reads, {rep['reads_per_s']!r} reads/s: RSS {rep['rss_mb_third']!r} MB at a third "
          f"of the decisions, {rep['rss_mb_final']!r} MB at the end (growth {growth!r}, the tests' limit 0.15); "
          f"device memory allocated {rep['device_mb_third']!r} / {rep['device_mb_final']!r} MB, its peak "
          f"{rep['device_max_mb_third']!r} / {rep['device_max_mb_final']!r} MB; latency p99 "
          f"{rep['latency_p99_ms']} ms on {card}")
    lane = session("gpu", 16)
    lane.reporter.close()
    save.cleanup()
    rows = live_bucket_batches(reads, natural, 16)[0]
    return one_batch, lambda: lane._classify_on_device(rows)


def device_busy_ms(fn):
    """Milliseconds in which the device ran at least one operation during
    fn(), as torch.profiler records them (overlapping operations counted
    once)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from warpdemux_tpu_torch.tools._trace import busy_us

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return busy_us(prof.events()) / 1e3


def count_step_ops(steps, lane_program, offline_run, trna, rna002, norm):
    """Device operations a step of each path on phase 3's rows, of each
    tRNA path on phase 8's (`trna`: (steps, rows)), of each RNA002 path on
    phase 9's (`rna002`), of each step of phase 15d (`norm`: {path: (step,
    rows, the step of "none")}) beside the step of "none" on its rows, and
    of one micro-batch of the live lane; the device's busy time in phase
    7's run a. Run last:
    once the profiler has been attached, every launch costs the host
    more."""
    import numpy as np

    from warpdemux_tpu_torch.utils.synthetic import synth_minibatch

    adc, off, sc, lens = synth_minibatch(np.random.default_rng(0), B, L)
    rows = (adc[:N_ROWS], off[:N_ROWS], sc[:N_ROWS], lens[:N_ROWS])
    def check(path, what, n_ops):
        require(n_ops > 0, f"{path}: the profiler recorded no device operation")
        print(f"{what}: {n_ops} device operations ({DEVICE_OPS_PINNED[path]} pinned, {DEVICE_OPS_BEFORE_K1_EXP[path]} "
              f"before K1 stored the SVM's exp, {DEVICE_OPS_BEFORE_K16[path]} "
              f"before K14's redesign and K16, {DEVICE_OPS_BEFORE_K14[path]} before K14"
              + (f", {DEVICE_OPS_BEFORE_K11[path]} before K11" if path in DEVICE_OPS_BEFORE_K11 else "")
              + (f", {DEVICE_OPS_BEFORE[path]} on commit 7cdf228)" if path in DEVICE_OPS_BEFORE else ")"))
        require(n_ops <= DEVICE_OPS_BEFORE_K14[path], f"{path}: more device operations than before K14")
        require(n_ops < DEVICE_OPS_BEFORE_K16[path], f"{path}: no fewer device operations than before K16")
        require(n_ops < DEVICE_OPS_BEFORE_K1_EXP[path], f"{path}: no fewer device operations than before K1's exp")
        require(n_ops <= DEVICE_OPS_PINNED[path], f"{path}: more device operations than pinned")

    for path in PATHS:
        check(path, f"{path} step", count_device_ops(steps[path], vbz_batch(*rows) if path == "vbz_full" else rows))
    trna_steps, trna_rows = trna
    for path in TRNA_PATHS:
        check(path, f"{path} step",
              count_device_ops(trna_steps[path], vbz_batch(*trna_rows) if "vbz" in path else trna_rows))
    rna002_steps, rna002_rows = rna002
    for path in RNA002_PATHS:
        check(path, f"{RNA002_MODELS[0]} {path} step",
              count_device_ops(rna002_steps[path], vbz_batch(*rna002_rows) if "vbz" in path else rna002_rows))
    check("live_lane", "live lane program, B=16 (a micro-batch)", count_device_ops(lane_program, ()))
    for path, (step, rows, base) in norm.items():
        n_ops, n_base = count_device_ops(step, rows), count_device_ops(base, rows)
        require(n_ops > 0, f"{path}: the profiler recorded no device operation")
        print(f"{path} step, B={len(rows[-1])}: {n_ops} device operations, {n_base} with "
              f"sig_extract.normalization='none' on the same rows ({n_ops - n_base:+d})")
    run, wall_ms = offline_run
    busy = device_busy_ms(run)
    require(busy > 0, "offline run: the profiler recorded no device operation")
    print(f"offline_vbz_decision run: the device busy {busy!r} ms of the unprofiled run's {wall_ms!r} ms "
          f"(idle share {1 - busy / wall_ms!r})")


STEP_TRACES = (("adc", "decision", "adc_decision"), ("vbz", "full", "vbz_full"))  # phase 13: (feed, outputs, path)


def run_profiling_tools(dev, card):
    """Phase 13: the port's profiling tools (warpdemux_tpu_torch/tools/) on
    the card at B = 1000: the step trace of the adc decision and the vbz full
    paths, the detect trace and the stage table, each table printed. Every
    kernel of csrc/ a path launches must be in its trace with the calls a
    step of that path's LAUNCHES pin, and no other; the stage table's dtw and
    svm proba rows must launch their kernels once a call. Run last: the
    profiler slows every later launch."""
    from warpdemux_tpu_torch.tools.profile_detect_trace import TOP as DETECT_TOP
    from warpdemux_tpu_torch.tools.profile_detect_trace import profile_detect
    from warpdemux_tpu_torch.tools.profile_stages import stage_table
    from warpdemux_tpu_torch.tools.profile_step_trace import TOP as STEP_TOP
    from warpdemux_tpu_torch.tools.profile_step_trace import profile_step

    def check(what, trace, path):
        pinned = {key: n for key, n in zip(KERNELS, LAUNCHES[path]) if n}
        calls = trace.kernel_calls()
        print(f"phase 13 {what}: kernels a call in the trace {calls} (LAUNCHES[{path!r}]: {pinned})")
        require(calls == pinned, f"phase 13 {what}: the trace's kernels differ from LAUNCHES[{path!r}]")
        require(trace.busy_ms > 0, f"phase 13 {what}: the profiler recorded no device time")

    for feed, outputs, path in STEP_TRACES:
        trace = profile_step(B, outputs, feed, dev)
        print(f"phase 13 step trace ({feed}, {outputs}), B={B}: wall {trace.wall_ms!r} ms/minibatch unprofiled, "
              f"{B / trace.wall_ms * 1e3!r} reads/s, on {card}")
        print(trace.summary())
        print("\n".join(trace.table(STEP_TOP)))
        check(f"step trace ({feed}, {outputs})", trace, path)
    trace = profile_detect(B, dev)
    print(f"phase 13 detect trace, B={B}: wall {trace.wall_ms!r} ms/minibatch unprofiled on {card}")
    print(trace.summary())
    print("\n".join(trace.table(DETECT_TOP)))
    check("detect trace", trace, "pa_detect")
    table = stage_table(B, dev)
    print(f"phase 13 stage table, B={B}, on {table.device}")
    print("\n".join(table.table()))
    launches = {stage.name: stage.launches for stage in table.stages}
    require(launches["dtw (B x 851)"] == {"wdx_dtw": 1}, f"phase 13 stage dtw: {launches['dtw (B x 851)']}")
    require(launches["svm proba"] == {"wdx_svm_dot": 1, "wdx_svm_probs": 1},
            f"phase 13 stage svm proba: {launches['svm proba']}")


def run_main_paths(dev, steps):
    """Phase 3: the three main paths on the GPU, held against the CPU."""
    import numpy as np
    import torch

    from warpdemux_tpu_torch.utils.synthetic import synth_minibatch
    from warpdemux_tpu_torch.ops.vbz_device import vbz_decode_batch

    cpu_steps = _steps("cpu")
    adc, off, sc, lens = synth_minibatch(np.random.default_rng(0), B, L)
    rows = (adc[:N_ROWS], off[:N_ROWS], sc[:N_ROWS], lens[:N_ROWS])
    by_path = {}

    # a. adc feed, decision outputs
    out, by_path["adc_decision"] = _drive("adc_decision", steps["adc_decision"], rows)
    for key, n in by_path["adc_decision"].items():
        # the fused and the tRNA paths' kernels, the DTW-MLP / Fpt-Boost softmax (phase 9),
        # the elementwise log, which no step launches, and K16, which K1's stored exp
        # replaces at every shipped bundle's pwr_dist (phase 15a)
        if key not in ("wdx_rolling_detect", "wdx_subseq_dtw", "wdx_xla_softmax", "wdx_xla_log",
                       "wdx_xla_exp_scaled"):
            require(n > 0, f"{key} was never launched by the adc decision path")
    ref = cpu_steps["adc_decision"](*rows)
    probs = out.probs.cpu()
    require(probs.shape == (N_ROWS, 5), f"probs shape {tuple(probs.shape)}")
    require(bool(torch.isfinite(probs).all()), "non-finite probabilities")
    same = int(np.logical_and.reduce([a == b for a, b in zip(_decisions(out), _decisions(ref))]).sum())
    print(f"adc decision: rows agreeing GPU vs CPU on (success, fail_code, pred): {same}/{N_ROWS}")
    require(same >= N_ROWS - 1, "GPU and CPU decisions disagree")
    _check_pins("adc decision gpu", out)
    require(_check_pins("adc decision cpu", ref) == PINS, f"CPU path misses the pins {PINS}")
    print(f"max |probs gpu - cpu| = {float((probs - ref.probs).abs().max())!r}")

    # b. vbz feed, full outputs
    wire = vbz_batch(*rows)
    dec = vbz_decode_batch(torch.as_tensor(wire[0], device=dev), torch.as_tensor(wire[1], device=dev), L)
    require(torch.equal(dec.to(torch.int16).cpu(), torch.from_numpy(rows[0])), "GPU VBZ decode differs")
    full, by_path["vbz_full"] = _drive("vbz_full", steps["vbz_full"], wire)
    for key in ("wdx_range_median_adc", "wdx_range_median_mad", "wdx_rowstats"):
        require(by_path["vbz_full"][key] > 0, f"{key} was never launched by the vbz full path")
    full_ref = cpu_steps["vbz_full"](*wire)
    same = _compare_full(full, full_ref)
    print(f"vbz full: rows agreeing GPU vs CPU on every int, median, MAD, mean and std column: {same}/{N_ROWS}")
    require(same >= N_ROWS - 1, "GPU and CPU full outputs disagree")
    _check_pins("vbz full gpu", full)
    require(_check_pins("vbz full cpu", full_ref) == PINS, f"CPU path misses the pins {PINS}")

    # c. adc feed, decision outputs, fused rolling detect (K9)
    fused, by_path["fused_decision"] = _drive("fused_decision", steps["fused_decision"], rows)
    n = by_path["fused_decision"]
    require(n["wdx_rolling_detect"] == 1, f"K9 launched {n['wdx_rolling_detect']} times, want 1")
    require(n["wdx_rolling_mean_var"] == 0 and n["wdx_run_sum"] == 0, "K6 or K7 ran in the fused path")
    for name, a, b in zip(("success", "fail_code", "pred"), _decisions(fused), _decisions(out)):
        require(bool((a == b).all()), f"fused decision: {name} differs from the unfused GPU step")
    print(f"fused decision: (success, fail_code, pred) equal to the unfused GPU step on {N_ROWS}/{N_ROWS} rows")

    return by_path


def time_throughput(steps, card, paths, batches):
    """Phase 4 (and 8): reads/s of each path over three B=1000 minibatches
    (`batches`: four (adc, offset, scale, lens)) after one warm-up, in two
    rounds (the second in reverse path order, since the host clock drifts
    within a run). A vbz path reads the batches packed into the wire."""
    import torch

    wires = [vbz_batch(*b[:4]) for b in batches]
    inputs = {path: wires if "vbz" in path else [b[:4] for b in batches] for path in paths}
    for path in paths:
        steps[path](*inputs[path][0])
    torch.cuda.synchronize()
    rates = {path: [] for path in paths}
    for order in (paths, paths[::-1]):
        for path in order:
            t0 = time.perf_counter()
            for batch in inputs[path][1:]:
                steps[path](*batch)
            torch.cuda.synchronize()
            rates[path].append(3 * B / (time.perf_counter() - t0))
    for path, r in rates.items():
        mean = sum(r) / len(r)
        print(f"{path} step: {mean!r} reads/s ({B / mean * 1e3!r} ms per B={B} batch; "
              f"rounds {r[0]!r}, {r[1]!r} reads/s) on {card}")
    return rates


def offline_config(out, wire, prep, batch_size=B, model=MODEL, boundaries=None, stage1_preload=STAGE1_LEN):
    """The run configuration of phase 7's and 8's runs (the CLI's demux /
    prep; boundaries: a demux that also saves the boundaries)."""
    from warpdemux_tpu_torch.config import config as c
    from warpdemux_tpu_torch.config.utils import get_model_spc_config

    boundaries = prep if boundaries is None else boundaries
    return c.Config(
        c.InputConfig(),
        c.OutputConfig(output_dir=str(out), save_fpts=prep, save_boundaries=boundaries, save_predictions=not prep),
        c.BatchConfig(minibatch_size=batch_size, batch_size_output=1500, wire=wire, stage1_preload=stage1_preload),
        c.TaskConfig(command="prep" if prep else "demux", predict=not prep),
        c.ClassifConfig(model_name=model),
        get_model_spc_config(model),
    )


def offline_batches(adc_batches, read_ids, wire):
    """The feed's tuples (`yield_vbz_batches` / `yield_adc_batches`) of
    in-memory (adc, offset, scale, lengths) minibatches."""
    out, k = [], 0
    for adc, off, sc, lens, *_ in adc_batches:
        ids = read_ids[k : k + len(adc)]
        k += len(adc)
        arrays = vbz_batch(adc, off, sc, lens) if wire == "vbz" else (adc, off, sc, lens)
        out.append((*arrays, lens, ids))
    return out


def shard_rows(run, sub):
    """The rows (header left out) of a run's CSV shards of one kind, in
    shard order."""
    import csv
    import gzip
    import re
    from pathlib import Path

    paths = sorted(Path(run, sub).glob("*.csv.gz"), key=lambda p: int(re.findall(r"(\d+)\.csv\.gz$", p.name)[0]))
    rows = []
    for path in paths:
        with gzip.open(path, "rt", encoding="utf-8", newline="") as fh:
            rows += list(csv.reader(fh))[1:]
    return rows


def shard_header(run, sub):
    """The header of a run's first CSV shard of one kind."""
    import csv
    import gzip
    from pathlib import Path

    path = sorted(Path(run, sub).glob("*.csv.gz"))[0]
    with gzip.open(path, "rt", encoding="utf-8", newline="") as fh:
        return next(csv.reader(fh))


def shard_texts(run):
    """{relative path: text} of a run's CSV shards."""
    import gzip
    from pathlib import Path

    return {str(p.relative_to(run)): gzip.open(p, "rt").read() for p in sorted(Path(run).glob("*/*.csv.gz"))}


def run_calls(run):
    """{read_id: (barcode or None, confidence or None, fail_reason or None)}
    of a predictions run."""
    calls = {}
    preds = shard_rows(run, "predictions")
    for row in preds:
        calls[row[0]] = (row[1], float(row[2]), None)
    fails = shard_rows(run, "failed_reads")
    for row in fails:
        calls[row[0]] = (None, None, row[-1])
    return calls


def check_offline_run(run, stats, read_ids, prep):
    """Every read once in predictions (boundaries for prep) or
    failed_reads, RunStats counting them all, and for prep the fingerprint
    rows equal to the boundary rows."""
    import numpy as np
    from pathlib import Path

    passed = shard_rows(run, "boundaries" if prep else "predictions")
    failed = shard_rows(run, "failed_reads")
    ids = [r[0] for r in passed] + [r[0] for r in failed]
    require(len(ids) == len(set(ids)), f"{run}: a read is written twice")
    require(set(ids) == set(read_ids.tolist()), f"{run}: {len(set(read_ids.tolist()) - set(ids))} reads missing")
    require(stats.total == len(read_ids), f"{run}: RunStats.total {stats.total}, want {len(read_ids)}")
    require(stats.failed == len(failed), f"{run}: RunStats.failed {stats.failed} but {len(failed)} failed rows")
    if prep:
        fpt_ids = []
        for path in sorted(Path(run, "fingerprints").glob("*.npz"), key=lambda p: int(p.stem.rsplit("_", 1)[1])):
            with np.load(path, allow_pickle=True) as z:
                fpt_ids += z["read_ids"].tolist()
                require(z["signals"].shape == (len(z["read_ids"]), 25), f"{path.name}: signals shape")
                require(bool(np.isfinite(z["signals"]).all()), f"{path.name}: non-finite fingerprints")
        require(fpt_ids == [r[0] for r in passed], f"{run}: fingerprint rows differ from the boundary rows")


def step_pin(path):
    """LAUNCHES[path] of the step as this process runs it: with
    WDX_FUSED_ROLLING=1, K9 once in place of K6 and both K7."""
    from warpdemux_tpu_torch.detect.boundaries import fused_rolling_default

    per_step = list(LAUNCHES[path])
    if fused_rolling_default():
        per_step[5:9] = [0, 0, per_step[7], 1]
    return per_step


def run_offline_loop(dev, card, step_rates):
    """Phase 7: the offline run loop on the card, four runs, the two-stage
    and the one-shot wire timed in turns, and run a again on eight
    minibatches. Returns the launch counts of each run, and (a function
    that runs run a again, run a's milliseconds) for phase 5."""
    import statistics
    import tempfile
    import uuid

    import numpy as np
    import torch

    from warpdemux_tpu_torch.utils.synthetic import synth_minibatch
    from warpdemux_tpu_torch import _cuda
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.run import demux_minibatches

    rng = np.random.default_rng(0)
    adc_batches = [synth_minibatch(rng, B, L) for _ in range(4)]  # phase 4's batches
    adc_batches[-1] = tuple(a[:OFFLINE_LAST_ROWS] for a in adc_batches[-1])
    id_rng = np.random.default_rng(17)
    n = sum(len(b[0]) for b in adc_batches)
    read_ids = np.array([str(uuid.UUID(int=int.from_bytes(id_rng.bytes(16), "big"))) for _ in range(n)], object)
    feeds = {wire: offline_batches(adc_batches, read_ids, wire) for wire in ("vbz", "adc")}
    model = load_model(MODEL, dev)
    by_run, dirs, seconds_by = {}, {}, {}
    tmp = tempfile.TemporaryDirectory()
    for name, (wire, prep, stage1, path, beside) in OFFLINE_RUNS.items():
        dirs[name] = f"{tmp.name}/{name}"
        _cuda.reset_launches()
        t0 = time.perf_counter()
        stats = demux_minibatches(offline_config(dirs[name], wire, prep, stage1_preload=stage1),
                                  None if prep else model, feeds[wire], device=dev)
        seconds_by[name] = time.perf_counter() - t0
        torch.cuda.synchronize()
        by_run[name] = dict(_cuda.launches)
        check_offline_run(dirs[name], stats, read_ids, prep)
        per_step = step_pin(path)
        # the two-stage wire: stage 1 on every minibatch, stage 2 (the same
        # chain at full width) on those with a row stage 1 left unresolved
        runs_of_step = len(adc_batches) + stats.stage2_minibatches
        if name == TWO_STAGE_RUN:
            print(f"{name} run: the two-stage wire, stage 2 ran on {stats.stage2_minibatches} of "
                  f"{len(adc_batches)} minibatches")
            require(stats.stage2_minibatches > 0, f"{name}: no stage 2 ran on the bench population")
        else:
            require(stats.stage2_minibatches == 0, f"{name}: a stage 2 ran off the two-stage wire")
        want = {key: runs_of_step * k for key, k in zip(KERNELS, per_step)}
        print(f"launches in the {name} run: {by_run[name]}")
        require(by_run[name] == want, f"{name}: launches differ from {runs_of_step} x {per_step}")
        rate = sum(step_rates[beside]) / len(step_rates[beside])
        print(f"{name} run: {n / seconds_by[name]!r} reads/s ({seconds_by[name]!r} s for {n} reads: "
              f"{stats.passed} pass, {stats.failed} fail, {stats.predicted} predicted) beside the {beside} "
              f"step's {rate!r} reads/s (phase 4) on {card}")

    # the two-stage and the one-shot wire, in turns
    timed = {name: [] for name in OFFLINE_TIMED}
    for i in range(OFFLINE_TIMED_ROUNDS):
        for name, stage1 in OFFLINE_TIMED.items():
            out = f"{tmp.name}/timed_{i}_{stage1}"
            t0 = time.perf_counter()
            demux_minibatches(offline_config(out, "vbz", False, stage1_preload=stage1), model, feeds["vbz"],
                              device=dev)
            timed[name].append(n / (time.perf_counter() - t0))
            require(shard_texts(out) == shard_texts(dirs[TWO_STAGE_RUN]), f"offline run ({name}) wrote other text")
    for name, rates in timed.items():
        print(f"offline run a, {name}: median {statistics.median(rates)!r} reads/s (range {min(rates)!r} to "
              f"{max(rates)!r}; rounds {rates!r}) on {card}")
    one = statistics.median(timed["one-shot wire"])
    print(f"offline run a, the two-stage wire: {statistics.median(timed['two-stage wire']) / one!r} x the "
          f"one-shot wire's reads/s")

    # the loop's own cost a minibatch: run a again on twice the minibatches
    more_ids = np.array([str(uuid.UUID(int=int.from_bytes(id_rng.bytes(16), "big"))) for _ in range(n)], object)
    twice = feeds["vbz"] + offline_batches(adc_batches, more_ids, "vbz")

    def run_a(batches, out):
        t0 = time.perf_counter()
        stats = demux_minibatches(offline_config(out, "vbz", False), model, batches, device=dev)
        return stats, time.perf_counter() - t0

    stats, seconds8 = run_a(twice, f"{tmp.name}/twice")
    check_offline_run(f"{tmp.name}/twice", stats, np.concatenate([read_ids, more_ids]), False)
    step_ms = B / (sum(step_rates["adc_decision"]) / 2) * 1e3
    seconds_a = seconds_by[TWO_STAGE_RUN]
    print(f"offline_vbz_decision run on 8 minibatches: {2 * n / seconds8!r} reads/s ({seconds8!r} s); "
          f"{(seconds8 - seconds_a) / 4 * 1e3!r} ms a minibatch more than on 4, against {step_ms!r} "
          f"ms a step (phase 4); {(seconds_a - 4 * step_ms / 1e3) * 1e3!r} ms of run a beyond 4 steps")

    a = dirs[TWO_STAGE_RUN]
    texts = shard_texts(a)
    for other in ("offline_adc_decision", "offline_vbz_decision_one_shot"):
        require(texts == shard_texts(dirs[other]), f"{other} wrote other CSV text than run a")
    print(f"offline runs a, a' and b: {len(texts)} CSV shards, equal text")

    # run a against a CPU run of the same loop on the first 256 reads
    cpu_dir = f"{tmp.name}/cpu"
    first = [tuple(x[:N_ROWS] for x in adc_batches[0])]
    demux_minibatches(offline_config(cpu_dir, "vbz", False, N_ROWS), load_model(MODEL, "cpu"),
                      offline_batches(first, read_ids[:N_ROWS], "vbz"), device="cpu")
    gpu, cpu = run_calls(a), run_calls(cpu_dir)
    ids = read_ids[:N_ROWS].tolist()
    same = [i for i in ids if (gpu[i][0], gpu[i][2]) == (cpu[i][0], cpu[i][2])]
    conf = max((abs(gpu[i][1] - cpu[i][1]) for i in same if gpu[i][1] is not None), default=0.0)
    print(f"offline run a vs a CPU run, first {N_ROWS} reads: (barcode, fail reason) equal on "
          f"{len(same)}/{N_ROWS}, max |confidence gpu - cpu| = {conf!r}")
    require(len(same) >= N_ROWS - 1, "offline run: GPU and CPU calls disagree")
    require(conf <= 0.001 + 1e-9, "offline run: a confidence differs by more than 0.001")
    return by_run, (lambda: run_a(feeds["vbz"], tempfile.mkdtemp(dir=tmp.name)), seconds_a * 1e3)


def vbz_ragged(adc, off, sc, in_lens):
    """Reads packed into the VBZ wire as the pod5 feed packs them: each row
    the body of exactly in_len samples, key bits and data zero past it."""
    import numpy as np

    from warpdemux_tpu_torch.utils.synthetic import VBZ_WIDTH
    from warpdemux_tpu_torch.ops.vbz_device import inner_layout_from_adc

    keys = np.zeros((len(adc), (adc.shape[1] + 7) // 8), np.uint8)
    data = np.zeros((len(adc), VBZ_WIDTH), np.uint8)
    for i, m in enumerate(np.asarray(in_lens, int)):
        body = np.frombuffer(inner_layout_from_adc(adc[i, :m]), np.uint8)
        klen = (m + 7) // 8
        keys[i, :klen] = body[:klen]
        data[i, : body.size - klen] = body[klen:]
    return keys, data, off, sc, in_lens


def run_twostage_wire(dev, card):
    """Phase 11: the two-stage wire's step (stage 1, the host's read of
    `resolved` and its tails, stage 2) against the one-shot vbz decision
    step on the card, for each of TWO_STAGE_MODELS. Returns the launch
    counts of its two-stage runs."""
    import statistics

    import numpy as np
    import torch

    from warpdemux_tpu_torch.utils.synthetic import synth_minibatch
    from warpdemux_tpu_torch import _cuda
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.ops.vbz_device import pack_tails_host, split_wire_host
    from warpdemux_tpu_torch.pipeline.run import _to_device
    from warpdemux_tpu_torch.pipeline.step import make_demux_step, make_twostage_decision_step, twostage_stage2

    rng = np.random.default_rng(0)
    batches = {f"bench {i}": vbz_batch(*synth_minibatch(rng, B, L)) for i in range(3)}
    rng = np.random.default_rng(11)
    adc, off, sc, _ = synth_minibatch(rng, B, L)
    batches["ragged"] = vbz_ragged(adc, off, sc, rng.integers(2200, STAGE1_LEN + 1, B).astype(np.int32))
    per_step = dict(zip(KERNELS, step_pin("adc_decision")))
    counts = dict.fromkeys(KERNELS, 0)
    for name in TWO_STAGE_MODELS:
        model, spc = load_model(name, dev), get_model_spc_config(name)
        one = make_demux_step(model, spc, input_format="vbz", outputs="decision", device=dev)
        stage1, stage2 = make_twostage_decision_step(model, spc, STAGE1_LEN, device=dev)
        staged = {}
        for label, (keys, data, off, sc, lens) in batches.items():
            keys1, data1, off1 = split_wire_host(keys, data, lens, STAGE1_LEN)
            staged[label] = (
                _to_device((keys1, data1, off, sc, lens), dev), (keys, data, lens, off1),
                _to_device((keys, data, off, sc, lens), dev),
            )

        def two_stage(dev1, host_wire, pins=False):
            """One minibatch through the two-stage wire, by the run loop's
            own stage-2 protocol (pipeline/step.twostage_stage2):
            (decisions, resolved, tail bytes, stage 2 ran); with `pins`,
            each stage's launches held."""
            if pins:
                _cuda.reset_launches()
            h = stage1(*dev1)
            resolved = h.resolved.cpu().numpy()
            if pins:
                got = dict(_cuda.launches)
                require(got == per_step, f"{name} stage 1: launches {got}, want {per_step}")
                for key, k in got.items():
                    counts[key] += k
                _cuda.reset_launches()
            out, tails = twostage_stage2(stage2, h, resolved, host_wire, B, L, put=lambda t: _to_device(t, dev))
            if out is None:
                return h.out1, resolved, 0, False
            if pins:
                torch.cuda.synchronize()
                got = dict(_cuda.launches)
                require(got == per_step, f"{name} stage 2: launches {got}, want {per_step}")
                for key, k in got.items():
                    counts[key] += k
            return out, resolved, sum(t.nbytes for t in tails), True

        n_res = n_rows = wire1 = wire_full = 0
        for label, (keys, data, off, sc, lens) in batches.items():
            dev1, host_wire, dev_full = staged[label]
            got, resolved, tail_bytes, ran = two_stage(dev1, host_wire, pins=True)
            if ran:  # the host's packing of the tails alone, timed
                t0 = time.perf_counter()
                pack_tails_host(*host_wire, np.nonzero(~resolved)[0], STAGE1_LEN, L)
                pack_ms = (time.perf_counter() - t0) * 1e3
            want = one(*dev_full)
            for field in want._fields:
                require(torch.equal(getattr(got, field), getattr(want, field)),
                        f"{name} {label}: two-stage {field} differs from the one-shot step")
            s1_bytes = dev1[0].nbytes + dev1[1].nbytes + 12 * B
            full_bytes = keys.nbytes + data.nbytes + 12 * B
            print(f"{name} {label}: two-stage decisions equal to the one-shot step's on {B}/{B} rows; "
                  f"stage 1 resolved {int(resolved.sum())}/{B}, stage 2 {'ran' if ran else 'skipped'}; wire "
                  f"{(s1_bytes + tail_bytes) / B!r} B a read (stage 1 {s1_bytes / B!r}, tails "
                  f"{tail_bytes / B!r}) against {full_bytes / B!r} one-shot"
                  + (f"; the host packed {B - int(resolved.sum())} tails in {pack_ms!r} ms" if ran else ""))
            if label == "ragged":
                require(bool(resolved.all()), f"{name}: a read that fits stage 1 was left unresolved")
                require(not ran, f"{name}: stage 2 ran on the ragged batch")
            else:
                n_res += int(resolved.sum())
                n_rows += B
                wire1 += s1_bytes + tail_bytes
                wire_full += full_bytes
        print(f"{name}, the 3 bench minibatches: stage 1 resolved {n_res / n_rows!r} of the reads; wire "
              f"{wire1 / n_rows!r} B a read against {wire_full / n_rows!r} one-shot on {card}")

        # reads/s in turns, 3 staged minibatches a round
        timed = [staged[f"bench {i}"] for i in range(3)]
        paths = {"two-stage": lambda st: two_stage(st[0], st[1])[0], "one-shot": lambda st: one(*st[2])}
        for fn in paths.values():
            fn(timed[0])
        torch.cuda.synchronize()
        rates = {path: [] for path in paths}
        for _ in range(TWO_STAGE_ROUNDS):
            for path, fn in paths.items():
                t0 = time.perf_counter()
                for st in timed:
                    fn(st)
                torch.cuda.synchronize()
                rates[path].append(3 * B / (time.perf_counter() - t0))
        med = {path: statistics.median(r) for path, r in rates.items()}
        for path, r in rates.items():
            print(f"{name} {path} decision step: median {med[path]!r} reads/s (range {min(r)!r} to "
                  f"{max(r)!r}; rounds {r!r}) on {card}")
        print(f"{name}: the two-stage step at {med['two-stage'] / med['one-shot']!r} x the one-shot vbz "
              f"decision step's reads/s on {card}")
    return {"twostage_decision": counts}


def _trna_steps(dev):
    """Phase 8's two tRNA steps on `dev`."""
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    spc, model = get_model_spc_config(TRNA_MODEL), load_model(TRNA_MODEL, dev)
    return {
        "trna_adc_decision": make_demux_step(model, spc, input_format="adc", outputs="decision", device=dev),
        "trna_vbz_full": make_demux_step(model, spc, input_format="vbz", outputs="full", device=dev),
    }


def run_trna_path(dev, card):
    """Phase 8: the tRNA chemistry (WDX4_tRNA) on the card: the two paths
    held against the CPU, their reads/s, and one offline run with the
    boundaries saved. Returns (launch counts by path, the steps, phase 3's
    rows of the tRNA minibatch) for phase 5."""
    import tempfile
    import uuid
    from pathlib import Path

    import numpy as np
    import torch

    from warpdemux_tpu_torch import _cuda
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.run import demux_minibatches

    rng = np.random.default_rng(0)
    batches = [trna_minibatch(rng, B) for _ in range(4)]
    steps, cpu_steps = _trna_steps(dev), _trna_steps("cpu")
    adc, off, sc, lens, kind, barcode = (a[:N_ROWS] for a in batches[0])
    rows = (adc, off, sc, lens)
    by_path = {}

    # a. adc feed, decision outputs
    out, by_path["trna_adc_decision"] = _drive("trna_adc_decision", steps["trna_adc_decision"], rows)
    ref = cpu_steps["trna_adc_decision"](*rows)
    require(bool(torch.isfinite(out.probs).all()) and out.probs.shape == (N_ROWS, 5), "tRNA: probabilities")
    gpu_d, cpu_d = _decisions(out), _decisions(ref)
    same = int(np.logical_and.reduce([a == b for a, b in zip(gpu_d, cpu_d)]).sum())
    print(f"tRNA adc decision: rows agreeing GPU vs CPU on (success, fail_code, pred): {same}/{N_ROWS}")
    require(same >= N_ROWS - 1, "tRNA: GPU and CPU decisions disagree")
    succ, fail, pred = cpu_d
    for k, name in enumerate(TRNA_KINDS):
        if name in TRNA_KINDS[:k]:
            continue
        sel = np.isin(kind, [j for j, n in enumerate(TRNA_KINDS) if n == name])
        print(f"tRNA branch {name!r}: {int(sel.sum())} rows, fail codes {dict(sorted(Counter(fail[sel].tolist()).items()))}")
    planted = barcode >= 0
    called = succ & planted & (pred != -1)
    print(f"tRNA planted barcodes: {int(planted.sum())} rows, {int((succ & planted).sum())} pass, "
          f"{int(called.sum())} called, {int((pred[called] == barcode[called]).sum())} as planted")
    require({0, 6, 9, 13} <= set(fail.tolist()), f"tRNA: a branch was not reached: {Counter(fail.tolist())}")
    require((pred[called] == barcode[called]).mean() >= 0.9, "tRNA: planted barcodes not recovered")

    # b. vbz feed, full outputs: the columns and the consensus match
    wire = vbz_batch(*rows)
    full, by_path["trna_vbz_full"] = _drive("trna_vbz_full", steps["trna_vbz_full"], wire)
    full_ref = cpu_steps["trna_vbz_full"](*wire)
    same_rows = _compare_full(full, full_ref, exact_rows=(full.cons_i.cpu() == full_ref.cons_i).all(1).numpy())
    print(f"tRNA vbz full: rows agreeing GPU vs CPU on every int, median, MAD and consensus column: {same_rows}/{N_ROWS}")
    require(same_rows >= N_ROWS - 1, "tRNA: GPU and CPU full outputs disagree")
    for path in TRNA_PATHS:
        require(by_path[path]["wdx_subseq_dtw"] == 1, f"{path}: K10 not launched once")

    # c. reads/s of both paths
    rates = time_throughput(steps, card, TRNA_PATHS, batches)

    # d. the offline run loop on the four minibatches, boundaries saved
    id_rng = np.random.default_rng(19)
    read_ids = np.array([str(uuid.UUID(int=int.from_bytes(id_rng.bytes(16), "big"))) for _ in range(4 * B)], object)
    tmp = tempfile.TemporaryDirectory()
    run = f"{tmp.name}/{TRNA_OFFLINE_RUN}"
    _cuda.reset_launches()
    t0 = time.perf_counter()
    stats = demux_minibatches(
        offline_config(run, "vbz", False, model=TRNA_MODEL, boundaries=True), load_model(TRNA_MODEL, dev),
        offline_batches(batches, read_ids, "vbz"), device=dev,
    )
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    by_path[TRNA_OFFLINE_RUN] = dict(_cuda.launches)
    check_offline_run(run, stats, read_ids, False)
    header = shard_header(run, "boundaries")
    require({"seg_cons_query_start", "seg_cons_query_end", "sig_barcode_start"} <= set(header),
            "tRNA run: the boundaries lack the consensus columns")
    require(sorted(r[0] for r in shard_rows(run, "boundaries")) == sorted(r[0] for r in shard_rows(run, "predictions")),
            "tRNA run: the boundaries rows are not the predicted reads")
    want = {key: 4 * k for key, k in zip(KERNELS, LAUNCHES["trna_vbz_full"])}
    print(f"launches in the {TRNA_OFFLINE_RUN} run: {by_path[TRNA_OFFLINE_RUN]}")
    require(by_path[TRNA_OFFLINE_RUN] == want, f"{TRNA_OFFLINE_RUN}: launches differ from 4 x {LAUNCHES['trna_vbz_full']}")
    print(f"{TRNA_OFFLINE_RUN} run: {4 * B / seconds!r} reads/s ({seconds!r} s for {4 * B} reads: {stats.passed} pass, "
          f"{stats.failed} fail, {stats.predicted} predicted; {len(list(Path(run, 'boundaries').glob('*.csv.gz')))} "
          f"boundaries shards) beside the trna_vbz_full step's {sum(rates['trna_vbz_full']) / 2!r} reads/s on {card}")
    tmp.cleanup()
    return by_path, steps, rows


def _rna002_steps(dev, name):
    """Phase 9's two RNA002 steps of model `name` on `dev`."""
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    spc, model = get_model_spc_config(name), load_model(name, dev)
    return {
        "rna002_adc_decision": make_demux_step(model, spc, input_format="adc", outputs="decision", device=dev),
        "rna002_vbz_full": make_demux_step(model, spc, input_format="vbz", outputs="full", device=dev),
    }


def run_families_and_rna002(dev, card, mrna_full_step):
    """Phase 9: the DTW-MLP and Fpt-Boost families and the RNA002 chemistry
    on the card. Returns (launch counts by path, WDX4's RNA002 steps and
    phase 9's rows) for phase 5."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from warpdemux_tpu_torch.utils.synthetic import synth_minibatch
    from warpdemux_tpu_torch import _cuda
    from warpdemux_tpu_torch.config import config as c
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.dtw_mlp import mlp_logits
    from warpdemux_tpu_torch.models.registry import load_model_arrays, model_from_arrays
    from warpdemux_tpu_torch.ops import dtw
    from warpdemux_tpu_torch.pipeline.run import run_predict_from_fpts

    by_path = {}
    # a. the families' predict on the fingerprints of the B=1000 seed-0 mRNA
    # step (rows that failed zeroed, as the step classifies them)
    out = mrna_full_step(*vbz_batch(*synth_minibatch(np.random.default_rng(0), B, L))).unpack()
    fpts = np.where(out.success[:, None], np.nan_to_num(out.fpt.fpt.astype(np.float32)), 0.0)
    fpts = fpts.astype(np.float32)
    X_ref = load_model_arrays(MODEL)["X_sv"].astype(np.float32)
    # the DTW-MLP's scaler fitted to these fingerprints' distances, as a
    # trained StandardScaler is to its training set's
    D = dtw.dtw_distance_matrix(torch.as_tensor(fpts, device=dev), torch.as_tensor(X_ref, device=dev), 15, 0.1)
    scaler = (D.mean(0).cpu().numpy(), D.std(0).clamp_min(1e-3).cpu().numpy())
    for kind in FAMILIES:
        arrays = family_arrays(kind, np.random.default_rng(4), X_ref, scaler=scaler)
        gpu_model, cpu_model = model_from_arrays(arrays, dev, kind), model_from_arrays(arrays, "cpu", kind)
        _cuda.reset_launches()
        gpu = gpu_model.predict(fpts)
        torch.cuda.synchronize()
        path = f"{kind}_predict"
        by_path[path] = dict(_cuda.launches)
        print(f"launches in the {path} run: {by_path[path]}")
        require(by_path[path] == dict(zip(KERNELS, LAUNCHES[path])), f"{path}: launches differ from {LAUNCHES[path]}")
        cpu = cpu_model.predict(fpts)
        same = int((gpu[0] == cpu[0]).sum())
        bits = [int((g.view(np.int32) != c.view(np.int32)).sum()) for g, c in zip(gpu[1:], cpu[1:])]
        print(f"{kind} predict, {B} fingerprints of the seed-0 step: pred equal GPU vs CPU on {same}/{B} rows, "
              f"conf and probs off the CPU's bits in {bits[0]} and {bits[1]} cells, "
              f"calls {dict(sorted(Counter(gpu[0].tolist()).items()))}")
        require(same == B and bits == [0, 0], f"{kind}: pred, conf and probs GPU and CPU not bit for bit")
        fpts_t = torch.as_tensor(fpts, device=dev)
        if kind == "dtw_mlp":  # the logits, on the card's distances, bit for bit the CPU model's
            D = dtw.dtw_distance_matrix(fpts_t, gpu_model.X_ref, gpu_model.window, gpu_model.penalty)
            logits = [mlp_logits(D.to(model.X_ref.device), *model.layers(), model.scaler_mean, model.scaler_scale)
                      for model in (gpu_model, cpu_model)]
            require(torch.equal(logits[0].cpu(), logits[1]), "dtw_mlp: logits GPU and CPU differ")
            print(f"dtw_mlp logits, B={B}: GPU (K12) bit for bit the CPU's (xla_dot) on the same distances")
        print(f"{kind} forward, B={B}: kernel_ms={time_ms(lambda: gpu_model(fpts_t))!r} "
              f"device_ms={time_ms(lambda: gpu_model(fpts_t), queued=True)!r} on {card}")

        # b. the predict run (`python -m warpdemux_tpu_torch.cli predict`)
        # over the fingerprints saved as a prep run saves them
        tmp = tempfile.TemporaryDirectory()
        fpt_file = Path(tmp.name, "barcode_fpts_0.npz")
        ids = np.array([f"read{i:04d}" for i in range(B)], object)
        np.savez(fpt_file, num_reads=B, read_ids=ids, signals=fpts)
        runs = {}
        for where, model in (("gpu", gpu_model), ("cpu", cpu_model)):
            run = Path(tmp.name, where)
            config = c.Config(
                c.InputConfig(files=[str(fpt_file)]),
                c.OutputConfig(output_dir=str(run), save_predictions=True),
                c.BatchConfig(batch_size_output=400), c.TaskConfig(command="predict", preprocess=False, predict=True),
                c.ClassifConfig(model_name=MODEL), get_model_spc_config(MODEL),
            )
            _cuda.reset_launches()
            stats = run_predict_from_fpts(config, model, device=dev if where == "gpu" else "cpu")
            if where == "gpu":
                by_path[f"{kind}_predict_run"] = dict(_cuda.launches)
                require(by_path[f"{kind}_predict_run"] == by_path[path], f"{kind} predict run: launches")
            require(stats.predicted == B, f"{kind} predict run ({where}): {stats.predicted} of {B} predicted")
            runs[where] = shard_rows(run, "predictions")
        same = sum(a[:2] == b[:2] for a, b in zip(runs["gpu"], runs["cpu"]))
        print(f"{kind} predict run on the card: {len(runs['gpu'])} predictions in "
              f"{len(list(Path(tmp.name, 'gpu', 'predictions').glob('*.csv.gz')))} shards; "
              f"(read_id, barcode) equal to a CPU run on {same}/{B} rows")
        require(len(runs["gpu"]) == B and same >= B - 1, f"{kind} predict run: GPU and CPU shards disagree")
        tmp.cleanup()

    # c. RNA002 (rna002_70bps@v0.4.4: LLR detect, no CNN, the 15,000-sample
    # preload), B=1000 of synth_batch, adc decision and vbz full
    batch = rna002_minibatch(np.random.default_rng(0), B)
    rows = tuple(a[:N_ROWS] for a in batch)
    inputs = {  # (the batch, its first N_ROWS rows) as each path's feed takes them
        "rna002_adc_decision": (batch, rows),
        "rna002_vbz_full": (vbz_batch(*batch), vbz_batch(*rows)),
    }
    first_steps = None
    for name in RNA002_MODELS:
        steps, cpu_steps = _rna002_steps(dev, name), _rna002_steps("cpu", name)
        first_steps = first_steps or steps
        for path in RNA002_PATHS:
            whole, head = inputs[path]
            _, by_path[f"{name}:{path}"] = _drive(path, steps[path], whole)
            gpu, cpu = steps[path](*head), cpu_steps[path](*head)
            same = int(np.logical_and.reduce([a == b for a, b in zip(_decisions(gpu), _decisions(cpu))]).sum())
            detail = ""
            if "vbz" in path:
                detail = f"; every int, median, MAD, mean and std column on {_compare_full(gpu, cpu)}/{N_ROWS}"
            succ, fail, pred = _decisions(cpu)
            print(f"{name} {path}: rows agreeing GPU vs CPU on (success, fail_code, pred): {same}/{N_ROWS}{detail}; "
                  f"CPU passes={int(succ.sum())} calls={dict(sorted(Counter(pred[succ].tolist()).items()))} "
                  f"fails={dict(sorted(Counter(fail[~succ].tolist()).items()))}")
            require(same >= N_ROWS - 1, f"{name} {path}: GPU and CPU decisions disagree")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                steps[path](*whole)
            torch.cuda.synchronize()
            print(f"{name} {path} step: {3 * B / (time.perf_counter() - t0)!r} reads/s (B={B}, L={RNA002_L}) on {card}")
    return by_path, first_steps, rows


def phase10_worker(device, out, n_batches, batch_size, last_rows):
    """One process of phase 10's run (parallel/multihost.run_workers): the
    run loop on `device`, adc wire, predictions, over minibatches rank,
    rank + world, ... of the run with its rank's shard tag; one step first
    to warm up, then timed from a barrier of every process to the barrier
    after the last one's run. Returns (total, passed, failed, predicted,
    class counts, launches, seconds, the GLOBAL line or None, the seconds
    of its own run loop)."""
    import logging

    import numpy as np
    import torch
    import torch.distributed as dist

    from warpdemux_tpu_torch.utils.synthetic import synth_minibatch
    from warpdemux_tpu_torch import _cuda
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.parallel.multihost import host_shard_tag, init_distributed
    from warpdemux_tpu_torch.pipeline.run import demux_minibatches
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    rank, world = init_distributed()
    data = {}

    def distinct(j):
        if j not in data:
            data[j] = synth_minibatch(np.random.default_rng(100 + j), batch_size, L)
        return data[j]

    feed = []
    for k in range(rank, n_batches, world):
        arrays = distinct(k % WORKER_DISTINCT)
        if k == n_batches - 1:
            arrays = tuple(a[:last_rows] for a in arrays)
        ids = np.array([f"{k:05d}-{i:05d}" for i in range(len(arrays[0]))], object)
        feed.append((*arrays, arrays[-1], ids))
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    logging.getLogger().addHandler(Keep())
    logging.getLogger().setLevel(logging.INFO)
    model = load_model(MODEL, device)
    config = offline_config(out, "adc", False, batch_size)
    if world > 1:
        config.output.shard_tag = host_shard_tag(rank) + "_"
    warm = make_demux_step(model, config.sig_proc, input_format="adc", outputs="decision", device=device)
    sync = torch.cuda.synchronize if device.type == "cuda" else lambda _: None
    warm(*distinct(rank % WORKER_DISTINCT))
    sync(device)
    dist.barrier()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    stats = demux_minibatches(config, model, feed, device=device)
    sync(device)
    own = time.perf_counter() - t0
    dist.barrier()
    seconds = time.perf_counter() - t0
    return (stats.total, stats.passed, stats.failed, stats.predicted, stats.class_counts.tolist(),
            dict(_cuda.launches), seconds, next((x for x in lines if x.startswith("GLOBAL")), None), own)


def worker_runs(devices, out, n_batches=WORKER_MINIBATCHES, batch_size=B, last_rows=OFFLINE_LAST_ROWS):
    """Phase 10's run in one process a device of `devices`; each process's
    phase10_worker result, in device order."""
    from warpdemux_tpu_torch.parallel.multihost import run_workers

    return run_workers(phase10_worker, (str(out), n_batches, batch_size, last_rows), devices)


def check_worker_runs(name, run, res, one_run, one_res, n_batches=WORKER_MINIBATCHES):
    """Phase 10's checks of a run of len(res) processes against a run of
    one: the merged predictions and failed_reads rows equal as text (the
    shard tags apart), each process's GLOBAL line the one-process totals
    and class counts, each process's launches its minibatches x the adc
    decision step's pin. Returns the summed launches."""
    from warpdemux_tpu_torch.detect.boundaries import fused_rolling_default

    per_step = list(LAUNCHES["adc_decision"])
    if fused_rolling_default():  # K9 for K6 and both K7
        per_step[5:9] = [0, 0, per_step[7], 1]
    world = len(res)
    for sub in ("predictions", "failed_reads"):
        require(shard_header(run, sub) == shard_header(one_run, sub), f"{name}: {sub} headers differ")
        got, want = sorted(shard_rows(run, sub)), sorted(shard_rows(one_run, sub))
        require(got == want, f"{name}: the merged {sub} rows differ from one process's "
                             f"({len(set(map(tuple, got)) ^ set(map(tuple, want)))} rows in one of the two)")
    total, passed, failed, predicted, classes = one_res[0][:5]
    want = f"{total} reads ({passed} pass / {failed} fail / {predicted} predicted)"
    want += " class counts " + "/".join(map(str, classes))
    summed = Counter()
    for rank, r in enumerate(res):
        steps = len(range(rank, n_batches, world))
        require(r[5] == {key: steps * k for key, k in zip(KERNELS, per_step)},
                f"{name}: process {rank} launched {r[5]}, not {steps} x {per_step}")
        summed.update(r[5])
        if world > 1:
            require(r[7] == f"GLOBAL ({world} hosts): {want}", f"{name}: process {rank}'s line {r[7]!r}, not {want!r}")
    require(tuple(sum(r[j] for r in res) for j in range(4)) == (total, passed, failed, predicted),
            f"{name}: the processes' counts do not add up to one process's")
    print(f"{name}: merged predictions and failed_reads rows equal to one process's; {world} process(es): {want}")
    return {key: summed[key] for key in KERNELS}


def run_worker_processes(card):
    """Phase 10: rounds of one process on cuda:0 and of one process a
    device of the mesh (every card; on one card two on cuda:0), in turns.
    Returns the launch counts of the first mesh round."""
    import tempfile

    import torch

    from warpdemux_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh() if torch.cuda.device_count() > 1 else [torch.device("cuda", 0)] * 2
    name = f"offline_adc_decision {len(mesh)} processes"
    print(f"phase 10: one process a device over {', '.join(map(str, mesh))} on {card}")
    runs, rates, launches = [], {"one": [], "mesh": []}, None
    with tempfile.TemporaryDirectory() as tmp:
        for i, which in enumerate(WORKER_ROUNDS):
            devices = [torch.device("cuda", 0)] if which == "one" else mesh
            out = f"{tmp}/{i}_{which}"
            t0 = time.perf_counter()
            res = worker_runs(devices, out)
            wall = time.perf_counter() - t0
            total, seconds = sum(r[0] for r in res), max(r[6] for r in res)
            rates[which].append(total / seconds)
            print(f"phase 10 round {i}: {len(devices)} process(es), {total} reads in {seconds!r} s: "
                  f"{total / seconds!r} reads/s ({wall!r} s with start-up; each process's run loop "
                  f"{[r[8] for r in res]!r} s) on {card}")
            runs.append((out, res))
        for i, (out, res) in enumerate(runs[1:], 1):
            counts = check_worker_runs(f"phase 10 round {i}", out, res, *runs[0])
            if i == 1:
                launches = counts
    one, many = sum(rates["one"]) / 2, sum(rates["mesh"]) / 2
    print(f"phase 10: {len(mesh)} processes {many!r} reads/s against one process {one!r} "
          f"({many / one!r}x) on {card}")
    return {name: launches}


def wide_spc(spc, m):
    """`spc` with fingerprints of m events (barcode_num_events and
    barcode_seg_num_events, the config TOML's `barcode_num_events`)."""
    import dataclasses

    return dataclasses.replace(
        spc, fingerprint=dataclasses.replace(spc.fingerprint, barcode_num_events=m),
        seg_extra=dataclasses.replace(spc.seg_extra, barcode_seg_num_events=m))


def long_row_spc(spc, length):
    """`spc` with reads of `length` samples (the chemistry's
    sig_preload_size, and the detector's max_obs_trace it comes from)."""
    import dataclasses

    return dataclasses.replace(spc, sig_preload_size=length,
                               detect=dataclasses.replace(spc.detect, max_obs_trace=length))


def run_wide_shapes(dev, card):
    """Phase 15: the shapes past the shipped models' on the card against the
    CPU. a. the classify chain (K1 with the kernel matrix's exp, K12, K13)
    of a synthetic SVM (`svm_arrays`, 40 support vectors a class) at
    WIDE_CLASSES, one predict of CHAIN_ROWS fingerprints from a seed: each
    kernel launched once, pred, conf and probs bit for bit the CPU's; then
    the same of an SVM of pwr_dist 2 (K1, K16 over the squared distances,
    K12, K13); b. the adc step, full outputs, on the first N_ROWS seed-0
    bench reads with a WIDE_STEP_CLASSES-class SVM, then with fingerprints
    of LONG_STEP_EVENTS events (a 5-class SVM of such support vectors): the
    launches of the path's pin, every row agreeing as phase 3b compares
    them, and (success, pred) equal on every row; c. the WDX4 adc step,
    full outputs, at a sig_preload_size of LONG_ROW_SAMPLES (past K11's
    warp kernel: its workspace kernel, K4's and K8's streaming and K6's
    device-scratch variants in one step) on LONG_ROW_READS seed-0 bench
    reads of that length, checked as b, timed as called."""
    import numpy as np

    import torch

    from warpdemux_tpu_torch import _cuda
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import dtw_svm_from_arrays, load_model
    from warpdemux_tpu_torch.ops import rowstats
    from warpdemux_tpu_torch.pipeline.step import make_demux_step
    from warpdemux_tpu_torch.utils.synthetic import synth_minibatch

    by_path = {}
    chain = dict(zip(KERNELS, LAUNCHES["dtw_svm_predict"]))
    for k in WIDE_CLASSES:
        arrays = svm_arrays(k, np.random.default_rng(k))
        fpts = np.random.default_rng(k + 1).normal(0, 1, (CHAIN_ROWS, 25)).astype(np.float32)
        model = dtw_svm_from_arrays(arrays, dev)
        _cuda.reset_launches()
        got = model.predict(fpts)
        require(dict(_cuda.launches) == chain, f"chain k={k}: launches {dict(_cuda.launches)}")
        want = dtw_svm_from_arrays(arrays, "cpu").predict(fpts)
        require(all(np.array_equal(g.view(np.int32), w.view(np.int32)) for g, w in zip(got, want)),
                f"chain k={k}: pred, conf or probs differ from the CPU's")
        t0 = time.perf_counter()
        for _ in range(5):
            model.predict(fpts)
        print(f"classify chain k={k} (N={40 * k} support vectors, P={k * (k - 1) // 2} pairs), {CHAIN_ROWS} "
              f"fingerprints: K1 (with the exp), K12 and K13 each launched once; pred, conf and probs bit for bit "
              f"the CPU's; {(time.perf_counter() - t0) / 5 * 1e3!r} ms a predict as called on {card}")
    by_path["dtw_svm_predict"] = chain
    path = "dtw_svm_pwr_dist_2_predict"
    arrays = {**svm_arrays(PWR_DIST_2_CLASSES, np.random.default_rng(2), pwr_dist=2),
              "gamma": np.float64(PWR_DIST_2_GAMMA)}
    fpts = np.random.default_rng(3).normal(0, 1, (CHAIN_ROWS, 25)).astype(np.float32)
    model = dtw_svm_from_arrays(arrays, dev)
    _cuda.reset_launches()
    got = model.predict(fpts)
    by_path[path] = dict(_cuda.launches)
    require(by_path[path] == dict(zip(KERNELS, LAUNCHES[path])), f"{path}: launches {by_path[path]}")
    want = dtw_svm_from_arrays(arrays, "cpu").predict(fpts)
    require(all(np.array_equal(g.view(np.int32), w.view(np.int32)) for g, w in zip(got, want)),
            f"{path}: pred, conf or probs differ from the CPU's")
    K = model.kernel_matrix(torch.as_tensor(fpts, device=dev))
    print(f"classify chain of pwr_dist 2 ({PWR_DIST_2_CLASSES} classes, gamma {PWR_DIST_2_GAMMA}), {CHAIN_ROWS} "
          f"fingerprints: K1, K16, K12 and K13 each launched once; pred, conf and probs bit for bit the CPU's; "
          f"kernel matrix in [{float(K.min())!r}, {float(K.max())!r}]; calls {dict(Counter(want[0].tolist()))}")
    adc, off, sc, lens = synth_minibatch(np.random.default_rng(0), B, L)
    rows = (adc[:N_ROWS], off[:N_ROWS], sc[:N_ROWS], lens[:N_ROWS])
    spc = get_model_spc_config(MODEL)
    for path, k, m in (("wide_classes_adc_full", WIDE_STEP_CLASSES, 25),
                       ("long_fingerprints_adc_full", 5, LONG_STEP_EVENTS)):
        arrays = svm_arrays(k, np.random.default_rng(k), m=m)
        steps = [make_demux_step(dtw_svm_from_arrays(arrays, d), wide_spc(spc, m), input_format="adc", device=d)
                 for d in (dev, "cpu")]
        out, by_path[path] = _drive(path, steps[0], rows)
        ref = steps[1](*rows)
        fpt = out.unpack().fpt.fpt
        require(tuple(out.probs.shape) == (N_ROWS, k) and fpt.shape == (N_ROWS, m),
                f"{path}: probs {tuple(out.probs.shape)}, fingerprints {fpt.shape}")
        same = _compare_full(out, ref)
        decided = all(np.array_equal(getattr(out, c).cpu().numpy(), getattr(ref, c).numpy()) for c in ("success", "pred"))
        print(f"{path} ({k} classes, fingerprints of {m}): rows agreeing GPU vs CPU on every int, median, MAD, mean "
              f"and std column: {same}/{N_ROWS}; (success, pred) equal on every row: {decided}; calls "
              f"{dict(Counter(ref.pred.numpy().tolist()))}")
        require(same == N_ROWS and decided, f"{path}: GPU and CPU steps disagree")
    path = "long_rows_adc_full"
    rows = synth_minibatch(np.random.default_rng(0), LONG_ROW_READS, LONG_ROW_SAMPLES)
    spc_l = long_row_spc(spc, LONG_ROW_SAMPLES)
    steps = [make_demux_step(load_model(MODEL, d), spc_l, input_format="adc", outputs="full", device=d)
             for d in (dev, "cpu")]
    out, by_path[path] = _drive(path, steps[0], rows)
    ref = steps[1](*rows)
    same = _compare_full(out, ref)
    decided = all(np.array_equal(getattr(out, c).cpu().numpy(), getattr(ref, c).numpy()) for c in ("success", "pred"))
    t0 = time.perf_counter()
    for _ in range(5):
        steps[0](*rows)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 5 * 1e3
    print(f"{path} (sig_preload_size {LONG_ROW_SAMPLES:,}, B={LONG_ROW_READS}; K11's "
          f"{rowstats._variant(LONG_ROW_SAMPLES, 3, True, None)[0]} kernel): rows agreeing GPU vs CPU on every int, "
          f"median, MAD, mean and std column: {same}/{LONG_ROW_READS}; (success, pred) equal on every row: {decided}; "
          f"calls {dict(Counter(ref.pred.numpy().tolist()))}; {ms!r} ms a step as called on {card}")
    require(same == LONG_ROW_READS and decided, f"{path}: GPU and CPU steps disagree")
    return by_path


def norm_spc(spc, method):
    """`spc` with sig_extract.normalization = `method`."""
    import dataclasses

    return dataclasses.replace(spc, fingerprint=dataclasses.replace(spc.fingerprint, extract_normalization=method))


def norm_rows(b=None, n_pa=None):
    """Phase 15d's rows: the adc feed's (b seed-0 reads, B by default, then
    NORM_ADC_EDGES made from the first) and the pa feed's (the first n_pa -
    len(NORM_EDGES) reads calibrated, n_pa NORM_ROWS by default, then
    NORM_EDGES)."""
    import numpy as np

    from warpdemux_tpu_torch.utils.synthetic import synth_minibatch

    b, n_pa = b or B, n_pa or NORM_ROWS
    adc, off, sc, lens = synth_minibatch(np.random.default_rng(0), b, L)
    edges = [norm_edge_adc(kind, adc[0], L) for kind in NORM_ADC_EDGES]
    k = len(edges)
    adc_rows = (np.concatenate([adc, np.stack([a for a, _ in edges])]), np.concatenate([off, np.repeat(off[:1], k)]),
                np.concatenate([sc, np.repeat(sc[:1], k)]),
                np.concatenate([lens, [n for _, n in edges]]).astype(np.int32))
    m = n_pa - len(NORM_EDGES)
    x = ((adc[:m].astype(np.float32) + off[:m, None]) * sc[:m, None]).astype(np.float32)
    rows = [norm_edge_row(kind, x[0], L) for kind in NORM_EDGES]
    pa_rows = (np.concatenate([x, np.stack([r for r, _ in rows])]),
               np.concatenate([lens[:m], [n for _, n in rows]]).astype(np.int32))
    return adc_rows, pa_rows


def run_prenormalization(dev, card):
    """Phase 15d: sig_extract.normalization = "mean" and "median" (fault
    K) through every path on the card against the CPU, each path at its
    LAUNCHES pin: the WDX4 step on the adc feed, full outputs, on the B
    seed-0 reads and NORM_ADC_EDGES, and on the pa feed on NORM_ROWS reads
    ending in NORM_EDGES (every column as phase 3b compares it, NaN for
    NaN, and (success, pred) on every row); the tRNA step (adc feed, full
    outputs) on NORM_TRNA_ROWS reads of trna_minibatch; one micro-batch of
    the live lane at max_batch NORM_LANE_ROWS (the replay reads, a constant
    read and one with a NaN sample); one offline run of one adc minibatch
    (NORM_OFFLINE_ROWS rows ending in NORM_ADC_EDGES) with the setting
    given as `--export` takes it, its CSV text equal to a CPU run's.
    Returns (launch counts by path, {path: (card step, its rows, the card
    step of sig_extract.normalization = "none")} for phase 5)."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from warpdemux_tpu_torch import _cuda
    from warpdemux_tpu_torch.config.utils import get_model_spc_config, parse_export_overrides
    from warpdemux_tpu_torch.live.balancer import BalancerConfig, BarcodeBalancers
    from warpdemux_tpu_torch.live.session import Session, SessionConfig
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.run import demux_minibatches
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    adc_rows, pa_rows = norm_rows()
    trna = trna_minibatch(np.random.default_rng(0), NORM_TRNA_ROWS)[:4]
    models = {d: {m: load_model(m, d) for m in (MODEL, TRNA_MODEL)} for d in (dev, "cpu")}
    lane_reads = [cut for _, cut in live_lane_reads(models["cpu"][MODEL].X_sv.numpy(), NORM_LANE_ROWS - 2)]
    lane_reads += [np.full_like(lane_reads[0], 85.0), lane_reads[0].copy()]
    lane_reads[-1][NORM_SAMPLE % len(lane_reads[-1])] = np.nan
    by_path, timed = {}, {}
    tmp = tempfile.TemporaryDirectory()
    for method in NORM_METHODS:
        for path, model, feed, rows in ((f"{method}_adc_full", MODEL, "adc", adc_rows),
                                        (f"{method}_pa_full", MODEL, "pa", pa_rows),
                                        (f"trna_{method}_adc_full", TRNA_MODEL, "adc", trna)):
            spc = norm_spc(get_model_spc_config(model), method)
            steps = [make_demux_step(models[d][model], spc, input_format=feed, outputs="full", device=d)
                     for d in (dev, "cpu")]
            out, by_path[path] = _drive(path, steps[0], rows)
            ref = steps[1](*rows)
            n = len(rows[-1])
            exact = (out.cons_i.cpu() == ref.cons_i).all(1).numpy() if out.cons_i is not None else None
            same = _compare_full(out, ref, exact_rows=exact)
            decided = all(np.array_equal(getattr(out, c).cpu().numpy(), getattr(ref, c).numpy())
                          for c in ("success", "pred"))
            t0 = time.perf_counter()
            for _ in range(5):
                steps[0](*rows)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / 5 * 1e3
            print(f"{path} (sig_extract.normalization={method!r}, B={n}): rows agreeing GPU vs CPU on every int, "
                  f"median, MAD, mean and std column, NaN for NaN, {same}/{n}; (success, pred) equal on "
                  f"every row: {decided}; passes {int(ref.success.sum())}, fingerprints ok "
                  f"{int(ref.unpack().fpt.ok.sum())}; {ms!r} ms a step as called on {card}")
            require(same == n and decided, f"{path}: GPU and CPU steps disagree")
            base = make_demux_step(models[dev][model], get_model_spc_config(model), input_format=feed,
                                   outputs="full", device=dev)
            timed[path] = (steps[0], rows, base)

        path = f"live_lane_{method}"
        sessions = []
        for d in (dev, "cpu"):
            cfg = SessionConfig(model_name=MODEL, save_path=tmp.name, run_id=f"{method}{d}", max_batch=NORM_LANE_ROWS)
            balancers = BarcodeBalancers.from_configs(4, [BalancerConfig(balance_type="adapter_count")], [1.0],
                                                      n_channels=126)
            sessions.append(Session(None, cfg, balancers, model=models[d][MODEL], device=d,
                                    spc=norm_spc(get_model_spc_config(MODEL), method)))
        _cuda.reset_launches()
        got = sessions[0]._classify_on_device(lane_reads)
        torch.cuda.synchronize()
        by_path[path] = dict(_cuda.launches)
        require(by_path[path] == dict(zip(KERNELS, LAUNCHES[path])), f"{path}: launches {by_path[path]}")
        want = sessions[1]._classify_on_device(lane_reads)
        for s in sessions:
            s.reporter.close()
        k = int(want.ok.sum())
        lane_same = (np.array_equal(got.ok, want.ok) and np.array_equal(got.pred[:k], want.pred[:k])
                     and bits_equal(torch.from_numpy(got.fpt), torch.from_numpy(want.fpt)))
        print(f"{path}: one micro-batch of {len(lane_reads)} reads (a constant read and a NaN sample among them): "
              f"launches {by_path[path]}; ok, pred and fingerprints (NaN for NaN) equal GPU vs CPU: {lane_same}; "
              f"{k} kept; max |conf gpu - cpu| {float(np.abs(got.conf[:k] - want.conf[:k]).max(initial=0.0))!r}")
        require(lane_same, f"{path}: GPU and CPU disagree")

        path = f"offline_{method}_adc_decision"
        m = NORM_OFFLINE_ROWS - len(NORM_ADC_EDGES)
        rows = tuple(np.concatenate([a[:m], a[B:]]) for a in adc_rows)
        read_ids = np.array([f"read{i:04d}" for i in range(NORM_OFFLINE_ROWS)], object)
        spc = get_model_spc_config(MODEL, parse_export_overrides([f"sig_extract.normalization={method}"]))
        require(spc.fingerprint.extract_normalization == method, f"{path}: --export did not reach the config")
        dirs = {}
        for d in (dev, "cpu"):
            dirs[d] = f"{tmp.name}/{path}_{d}"
            cfg = dataclasses.replace(offline_config(dirs[d], "adc", False, NORM_OFFLINE_ROWS), sig_proc=spc)
            _cuda.reset_launches()
            stats = demux_minibatches(cfg, models[d][MODEL], offline_batches([rows], read_ids, "adc"), device=d)
            if d == dev:
                torch.cuda.synchronize()
                by_path[path] = dict(_cuda.launches)
            check_offline_run(dirs[d], stats, read_ids, False)
        require(by_path[path] == dict(zip(KERNELS, LAUNCHES[path])), f"{path}: launches {by_path[path]}")
        texts = [shard_texts(dirs[d]) for d in (dev, "cpu")]
        print(f"{path} (--export sig_extract.normalization={method}): {NORM_OFFLINE_ROWS} reads in one minibatch, "
              f"{stats.passed} pass, {stats.failed} fail; launches {by_path[path]}; its {len(texts[0])} CSV shards "
              f"equal the CPU run's as text: {texts[0] == texts[1]}")
        require(texts[0] == texts[1], f"{path}: the card's CSV text differs from the CPU run's")
    tmp.cleanup()
    return by_path, timed


def run_trainers(dev, card):
    """Phase 12: the trainers of warpdemux_tpu_torch/tools/ on the card.
    Returns the launch counts by path. Writes nothing under the repository
    (the trained CNN goes to a temporary weights directory)."""
    import io
    import tempfile
    from dataclasses import replace
    from pathlib import Path

    import numpy as np
    import torch

    from warpdemux_tpu_torch.utils.synthetic import synth_minibatch
    from warpdemux_tpu_torch import _cuda
    from warpdemux_tpu_torch.config import utils as config_utils
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models import registry
    from warpdemux_tpu_torch.ops import dtw
    from warpdemux_tpu_torch.ops.numerics import full_float32
    from warpdemux_tpu_torch.pipeline.step import make_demux_step
    from warpdemux_tpu_torch.tools import train_cnn, train_trna_model

    by_path = {}
    zeros = dict.fromkeys(KERNELS, 0)

    # a. the CNN trainer's command line (python -m warpdemux_tpu_torch.tools.
    # train_cnn --steps CNN_TRAIN_STEPS): two runs on the card, one on the
    # CPU, each writing its bundle into a temporary weights directory
    def switches():
        return (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)

    @contextlib.contextmanager
    def tf32_backward():
        # the control: the step's cuDNN switches, but TF32 left on outside
        # a forward scoped to full float32
        saved = switches()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) = saved

    def forward_in_float32(*a):
        with full_float32():
            return sound[1](*a)

    def cnn_run(device, out):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            params, history = train_cnn.main(["--steps", str(CNN_TRAIN_STEPS), "--out", out, "--device", device])
        lines = printed.getvalue().splitlines()
        print("\n".join(f"CNN trainer on {device} ({out}): {line}" for line in lines))
        require(lines[-1].startswith("eval: polyA reads ") and f"saved {weights / out}.npz" in lines,
                f"CNN trainer on {device}: no bundle or eval line")
        return params, history

    before = switches()
    saved_dir = config_utils.CNN_DIR
    tmp = tempfile.TemporaryDirectory()
    weights = Path(tmp.name)
    config_utils.CNN_DIR = weights
    try:
        _cuda.reset_launches()
        gpu_params, gpu_hist = cnn_run(dev.type, TRAINED_CNN)
        by_path["cnn_trainer"] = dict(_cuda.launches)
        require(switches() == before, f"the CNN trainer left the cuDNN / TF32 switches at {switches()}, not {before}")
        require(by_path["cnn_trainer"] == zeros, f"cnn_trainer: launches {by_path['cnn_trainer']}, no kernel expected")
        gpu2_params, gpu2_hist = cnn_run(dev.type, "run2")
        cpu_params, cpu_hist = cnn_run("cpu", "cpu")
        sound = train_cnn.training_numerics, train_cnn.loss_fn
        train_cnn.training_numerics, train_cnn.loss_fn = tf32_backward, forward_in_float32
        try:
            tf32_params, tf32_hist = cnn_run(dev.type, "tf32_control")
        finally:
            train_cnn.training_numerics, train_cnn.loss_fn = sound
        # the trained bundle serves the mRNA step on the seed-0 bench batch
        spc = replace(get_model_spc_config(MODEL), cnn_model_name=TRAINED_CNN)
        steps = {d: make_demux_step(registry.load_model(MODEL, d), spc, input_format="adc", outputs="decision",
                                    fused_rolling=False, device=d) for d in (dev, "cpu")}
    finally:
        config_utils.CNN_DIR = saved_dir
        tmp.cleanup()
    differing = sum(int((gpu_params[k] != gpu2_params[k]).sum()) for k in gpu_params)

    def off_cpu(params, hist):
        """(max relative loss difference, its step, max weight difference) against the CPU run."""
        rel = np.abs(hist.losses.astype(np.float64) - cpu_hist.losses) / cpu_hist.losses
        return rel.max(), int(rel.argmax()), max(float((params[k].cpu() - cpu_params[k]).abs().max()) for k in cpu_params)

    loss_rel, loss_step, w_diff = off_cpu(gpu_params, gpu_hist)
    ctl_loss_rel, ctl_loss_step, ctl_w_diff = off_cpu(tf32_params, tf32_hist)
    print(f"CNN trainer, two runs on the card: {differing} weights differ; losses equal: "
          f"{np.array_equal(gpu_hist.losses, gpu2_hist.losses)}")
    print(f"CNN trainer, card against CPU over {CNN_TRAIN_STEPS} steps: max relative loss difference {loss_rel!r} "
          f"(step {loss_step}; limit {CNN_LOSS_RTOL}), max weight difference {w_diff!r} (limit "
          f"{CNN_WEIGHT_ATOL}); last loss {float(gpu_hist.losses[-1])!r} card, {float(cpu_hist.losses[-1])!r} CPU")
    require(differing == 0 and np.array_equal(gpu_hist.losses, gpu2_hist.losses),
            "two CNN training runs on the card gave different weights")
    print(f"CNN trainer control, TF32 in the backward convolutions, against the CPU: max relative loss difference "
          f"{ctl_loss_rel!r} (step {ctl_loss_step}), max weight difference {ctl_w_diff!r} on {card}")
    require(loss_rel <= CNN_LOSS_RTOL, "CNN trainer: the card's losses are off the CPU's")
    require(w_diff <= CNN_WEIGHT_ATOL, "CNN trainer: the card's weights are off the CPU's")
    require(ctl_loss_rel > CNN_LOSS_RTOL and ctl_w_diff > CNN_WEIGHT_ATOL,
            "CNN trainer: the limits do not catch TF32 in the backward convolutions")
    for name, h in (("card, run 1", gpu_hist), ("card, run 2", gpu2_hist)):
        print(f"CNN trainer ({name}): {CNN_TRAIN_STEPS / h.seconds!r} steps/s ({h.seconds!r} s for {CNN_TRAIN_STEPS} "
              f"steps of 48 reads, {h.batch_seconds!r} s of it the host's make_batch) on {card}")
    print(f"CNN trainer (the card's host CPU, for comparison): {CNN_TRAIN_STEPS / cpu_hist.seconds!r} steps/s")

    adc, off, sc, lens = synth_minibatch(np.random.default_rng(0), B, L)
    out, by_path["trained_cnn_adc_decision"] = _drive("trained_cnn_adc_decision", steps[dev], (adc, off, sc, lens))
    succ, _fail, _pred = _decisions(out)
    rows = tuple(a[:N_ROWS] for a in (adc, off, sc, lens))
    gpu_d, cpu_d = _decisions(steps[dev](*rows)), _decisions(steps["cpu"](*rows))
    same = int(np.logical_and.reduce([a == b for a, b in zip(gpu_d, cpu_d)]).sum())
    print(f"the trained CNN's adc decision step: {int(succ.sum())}/{B} pass; rows agreeing GPU vs CPU on "
          f"(success, fail_code, pred): {same}/{N_ROWS}")
    require(same >= N_ROWS - 1, "trained CNN: GPU and CPU decisions disagree")

    # b. the tRNA trainer's device half at its default arguments
    args = train_trna_model.build_parser().parse_args([])
    name = args.model
    barcodes, pats = train_trna_model.MODEL_BARCODES[name], train_trna_model.patterns(name)
    preps = {d: train_trna_model.prep_step(name, d) for d in (dev, "cpu")}
    n_reads = len(barcodes) * args.per_bc + args.noise_n
    prep = dict(zip(KERNELS, LAUNCHES["trna_prep"]))

    def fingerprints(device, *sizes, family="real", seed=args.seed):
        t0 = time.perf_counter()
        X, y = train_trna_model.make_fingerprints(np.random.default_rng(seed), *sizes, preps[device], pats,
                                                  barcodes, family)
        return X, y, time.perf_counter() - t0

    # the prep step at the trainer's chunk shapes (128 reads, the ragged 80
    # of its training set and 22 of each holdout) on tRNA minibatch rows:
    # every column against the CPU step's, as in phase 3b
    for n in (train_trna_model.CHUNK, n_reads % train_trna_model.CHUNK,
              (len(barcodes) + 1) * args.holdout_per_bc % train_trna_model.CHUNK):
        adc, off, sc, lens, _kind, _bc = trna_minibatch(np.random.default_rng(n), n)
        pa = ((adc.astype(np.float32) + off[:, None]) * sc[:, None]).astype(np.float32)
        out, _ = _drive("trna_prep", preps[dev], (pa, lens))
        ref = preps["cpu"](pa, lens)
        same_rows = _compare_full(out, ref, exact_rows=(out.cons_i.cpu() == ref.cons_i).all(1).numpy())
        print(f"tRNA trainer prep step, B={n}: rows agreeing GPU vs CPU on every int, median, MAD and consensus "
              f"column: {same_rows}/{n}")
        require(same_rows == n, f"tRNA trainer prep step, B={n}: GPU and CPU full outputs disagree")

    _cuda.reset_launches()
    X, y, seconds = fingerprints(dev, args.per_bc, args.noise_n)
    by_path["trna_trainer_prep"] = dict(_cuda.launches)
    Xc, yc, cpu_seconds = fingerprints("cpu", args.per_bc, args.noise_n)
    n_steps = -(-n_reads // train_trna_model.CHUNK)
    off_rows = int((X != Xc).any(1).sum()) if X.shape == Xc.shape else -1
    print(f"tRNA trainer prep: {len(X)} fingerprints of {n_reads} reads in {n_steps} steps, "
          f"{n_reads / seconds!r} reads/s on {card} ({n_reads / cpu_seconds!r} on the host CPU); rows off the CPU's: "
          f"{off_rows}; launches {by_path['trna_trainer_prep']}")
    require(len(X) == TRNA_TRAIN_FPTS and np.array_equal(X, Xc) and np.array_equal(y, yc),
            "tRNA trainer: the card's fingerprints differ from the CPU's")
    require(by_path["trna_trainer_prep"] == {k: n_steps * n for k, n in prep.items()},
            f"trna_trainer_prep: launches differ from {n_steps} x {LAUNCHES['trna_prep']}")
    mine = {r.tobytes() for r in X}
    shipped = registry.load_model_arrays(name)["X_sv_f64"]
    found = sum(r.tobytes() in mine for r in shipped)
    print(f"tRNA trainer: {found}/{len(shipped)} support vectors of the shipped {name} among the card's fingerprints")
    require(found == len(shipped), "tRNA trainer: the shipped support vectors are not among the fingerprints")

    # the Gram matrix: K1 at n x n against its plain version
    Xf = torch.as_tensor(X.astype(np.float32), device=dev)
    _cuda.reset_launches()
    D = train_trna_model.gram_distances(X, dev)
    by_path["trna_trainer_gram"] = dict(_cuda.launches)
    plain = dtw.dtw_distance_matrix_plain(Xf, Xf, 15, 0.1)
    err = max_abs(torch.as_tensor(D, device=dev), plain)
    require(by_path["trna_trainer_gram"] == {**zeros, "wdx_dtw": 1}, "trna_trainer_gram: K1 not launched once")
    require(np.array_equal(D, plain.cpu().numpy().astype(np.float64)), "K1 at the Gram shape differs from its plain version")
    n = len(X)
    kernel = lambda: dtw.dtw_distance_matrix(Xf, Xf, 15, 0.1)
    ms, device_ms = time_ms(kernel), time_ms(kernel, queued=True)
    plain_ms = time_ms(lambda: dtw.dtw_distance_matrix_plain(Xf, Xf, 15, 0.1), reps=2)
    n_bytes, n_ops = k1_work(n, n)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    print(f"K1 dtw at the Gram shape {n} x {n}: max_abs_err={err!r} kernel_ms={ms!r} device_ms={device_ms!r} "
          f"plain_ms={plain_ms!r}")
    print(f"K1 dtw at the Gram shape: bound_ms={bound_ms!r} by {bound_by} ({n_bytes} bytes, {n_ops} operations); "
          f"share of bound reached={bound_ms / ms!r} (of the device's time alone {bound_ms / device_ms!r}) on {card}")

    # the holdout families through the shipped bundle
    models = {d: registry.load_model(name, d) for d in (dev, "cpu")}
    _cuda.reset_launches()
    for family in ("real", "legacy"):
        sizes = (args.holdout_per_bc, args.holdout_per_bc)
        Xh, yh, _ = fingerprints(dev, *sizes, family=family, seed=args.seed + 1)
        pred = models[dev].predict(Xh.astype(np.float32))[0]
        Xhc, _yhc, _ = fingerprints("cpu", *sizes, family=family, seed=args.seed + 1)
        pred_cpu = models["cpu"].predict(Xhc.astype(np.float32))[0]
        want = np.array([barcodes[c] if c < len(barcodes) else -1 for c in yh])
        print(f"tRNA trainer holdout[{family}]: n={len(yh)}, pred equal to the CPU's on "
              f"{int((pred == pred_cpu).sum()) if pred.shape == pred_cpu.shape else -1}/{len(yh)}, "
              f"accuracy {float((pred == want).mean())!r}")
        require(np.array_equal(Xh, Xhc) and np.array_equal(pred, pred_cpu),
                f"tRNA trainer holdout[{family}]: the card's fingerprints or pred differ from the CPU's")
    by_path["trna_trainer_holdout"] = dict(_cuda.launches)
    hold_steps = 2 * -(-(len(barcodes) + 1) * args.holdout_per_bc // train_trna_model.CHUNK)
    want_hold = {k: hold_steps * n for k, n in prep.items()}
    for key in ("wdx_dtw", "wdx_svm_dot", "wdx_svm_probs"):  # each predict: K1 with the kernel matrix's exp, K12, K13
        want_hold[key] += 2
    print(f"launches in the trna_trainer_holdout run: {by_path['trna_trainer_holdout']}")
    require(by_path["trna_trainer_holdout"] == want_hold,
            f"trna_trainer_holdout: launches differ from {hold_steps} prep steps and two predicts")
    return by_path


def validate_batches(n=VALIDATE_READS, batch=200):
    """(sigs, in_lens, full_lens, read_ids) minibatches of `n` synthetic mRNA
    reads in picoamps: half barcoded reads planted from WDX4's support
    vectors (live/dummy.synth_barcoded_read, the classes in turn, seed 0),
    so that the barcode calls are not all noise, half rows of
    synth_minibatch(default_rng(0), n / 2, L), every eighth cut to 300 to
    2,400 samples."""
    import numpy as np

    from warpdemux_tpu_torch.live.dummy import synth_barcoded_read
    from warpdemux_tpu_torch.models.registry import load_model_arrays
    from warpdemux_tpu_torch.utils.synthetic import synth_minibatch

    arrays = load_model_arrays(MODEL)
    X, n_classes = arrays["X_sv"], len(arrays["label_map"]) - 1  # the noise class has no reads
    bounds = np.concatenate([[0], np.cumsum(arrays["n_support"])])
    rng = np.random.default_rng(0)
    sigs = np.zeros((n, L), np.float32)
    in_lens = np.zeros(n, np.int32)
    full_lens = np.zeros(n, np.int32)
    for i in range(n // 2):
        ci = i % n_classes
        sig = synth_barcoded_read(rng, X[rng.integers(bounds[ci], bounds[ci + 1])])
        in_lens[i], full_lens[i] = min(L, sig.size), sig.size
        sigs[i, : in_lens[i]] = sig[: in_lens[i]]
    adc, off, sc, lens = synth_minibatch(np.random.default_rng(0), n - n // 2, L)
    pa = (adc.astype(np.float32) + off[:, None]) * sc[:, None]
    row = np.arange(len(lens))
    cut = np.where(row % 8 == 7, 300 * (1 + (row // 8) % 8), lens)
    for j in range(len(lens)):
        sigs[n // 2 + j, : cut[j]] = pa[j, : cut[j]]
    in_lens[n // 2:] = full_lens[n // 2:] = cut
    ids = np.array([f"read{i}" for i in range(n)], object)
    return [(sigs[k : k + batch], in_lens[k : k + batch], full_lens[k : k + batch], ids[k : k + batch])
            for k in range(0, n, batch)]


def check_tool_launches(by_path, name, rates, path):
    """A tool path's launches, each of its `rates.calls` steps the pin of
    LAUNCHES[path]; recorded under `name`."""
    want = {key: n * rates.calls for key, n in zip(KERNELS, LAUNCHES[path]) if n}
    print(f"phase 14 {name}: {rates.calls} steps launched {rates.launches} (LAUNCHES[{path!r}] x {rates.calls})")
    require(rates.launches == want, f"phase 14 {name}: launches differ from LAUNCHES[{path!r}] x {rates.calls}")
    by_path[name] = {key: rates.launches.get(key, 0) for key in KERNELS}


def run_tools(dev, card):
    """Phase 14: the port's throughput tools and boundary validation
    (warpdemux_tpu_torch/tools/) on the card, each driven through the
    function its command line calls, every launch count at 0 before each
    tool and read after it:
    a. bench_models at WDX4 / WDX6 / WDX10 (16 staged B=1000 minibatches),
       the full and decision steps in turns;
    b. sweep_minibatch at B = 500-4000 (16,000 reads a measurement), with
       the peak memory each B took;
    c. bench_trna at B = 1000 (12 staged copies of one tRNA minibatch);
    d. validate_boundaries.validate on validate_batches() on the card and on
       the CPU: the tables equal line for line;
    e. K12 at the WDX6 and WDX10 step shapes (B = 1000): bit for bit its
       plain version, timed beside its bound and torch.addmm.
    a-c with TOOL_ROUNDS rounds each; every step's launches its path's
    LAUNCHES pin (adc full steps: "vbz_full"'s, whose vbz decode launches
    nothing). Returns the launch counts by path."""
    import numpy as np
    import torch

    from warpdemux_tpu_torch import _cuda
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_cnn, load_model
    from warpdemux_tpu_torch.ops import numerics, svm
    from warpdemux_tpu_torch.tools import _throughput, bench_models, bench_trna, sweep_minibatch
    from warpdemux_tpu_torch.tools import validate_boundaries as vb

    by_path = {}

    def launched_only(paths, what):
        total = {key: n for key, n in _cuda.launches.items() if n}
        summed = {key: sum(by_path[p][key] for p in paths) for key in KERNELS}
        require(total == {key: n for key, n in summed.items() if n}, f"phase 14 {what}: launches outside its steps")

    # a. the model sweep
    t0 = time.perf_counter()
    _cuda.reset_launches()
    rows = bench_models.bench_models(TOOL_MODELS, dev, TOOL_ROUNDS, distinct=TOOL_DISTINCT)
    names = []
    for row, rates in rows:
        print(json.dumps(row))
        print("\n".join(f"# {row['model']} {line[2:]}" for line in _throughput.round_lines(rates, card)))
        require(all(r > 0 for path in rates.values() for r in path.rounds), f"phase 14 {row['model']}: a rate of 0")
        for outputs, path in (("full", "vbz_full"), ("decision", "adc_decision")):
            names.append(f"bench_models {row['model']} {outputs}")
            check_tool_launches(by_path, names[-1], rates[outputs], path)
    launched_only(names, "bench_models")
    print(f"phase 14 bench_models: {time.perf_counter() - t0!r} s")

    # b. the minibatch sweep
    t0 = time.perf_counter()
    _cuda.reset_launches()
    print(f"# {sweep_minibatch.MODEL}, adc feed, inputs on the device, {sweep_minibatch.N_READS} reads a "
          f"measurement, rounds={TOOL_ROUNDS}, {TOOL_DISTINCT} distinct minibatches a B, on {card}")
    print("\n".join(sweep_minibatch.HEADER))
    names = []
    for row in sweep_minibatch.sweep(SWEEP_SIZES, dev, TOOL_ROUNDS, distinct=TOOL_DISTINCT):
        print("| " + " | ".join(row.cells()) + " |")
        print("\n".join(f"# B={row.B} {line[2:]}" for line in _throughput.round_lines(row.rates, card)))
        print(f"# B={row.B}: {row.n_batches} minibatches a measurement, peak allocated {row.peak_bytes} bytes")
        require(row.peak_bytes > 0, f"phase 14 sweep B={row.B}: no device memory")
        for outputs, path in (("full", "vbz_full"), ("decision", "adc_decision")):
            names.append(f"sweep_minibatch B={row.B} {outputs}")
            check_tool_launches(by_path, names[-1], row.rates[outputs], path)
    launched_only(names, "sweep_minibatch")
    print(f"phase 14 sweep_minibatch: {time.perf_counter() - t0!r} s")

    # c. the tRNA step
    t0 = time.perf_counter()
    _cuda.reset_launches()
    run = bench_trna.bench_trna(B, dev, TOOL_ROUNDS)
    print("\n".join(_throughput.round_lines({"tRNA": run.rates}, card)))
    print(bench_trna.line(run, dev))
    require(run.rates.n_pass > 0, "phase 14 bench_trna: no read passed")
    check_tool_launches(by_path, "bench_trna", run.rates, "trna_pa_full")
    launched_only(["bench_trna"], "bench_trna")
    print(f"phase 14 bench_trna: {time.perf_counter() - t0!r} s")

    # d. the boundary validation, card against CPU
    t0 = time.perf_counter()
    batches = validate_batches()
    spc = get_model_spc_config(vb.MODEL)
    _cuda.reset_launches()
    gpu = vb.validate(batches, spc, load_model(vb.MODEL, dev), load_cnn(spc.cnn_model_name, dev))
    by_path["validate_boundaries"] = {key: _cuda.launches[key] for key in KERNELS}
    want = {key: n * len(batches) for key, n in zip(KERNELS, LAUNCHES["validate_boundaries"])}
    print(f"phase 14 validate_boundaries: {len(batches)} minibatches launched "
          f"{ {k: n for k, n in by_path['validate_boundaries'].items() if n} }")
    require(by_path["validate_boundaries"] == want, "phase 14 validate: launches differ from LAUNCHES x minibatches")
    t_gpu = time.perf_counter() - t0
    cpu = vb.validate(batches, spc, load_model(vb.MODEL, "cpu"), load_cnn(spc.cnn_model_name, "cpu"))
    print(f"# {sum(len(b[3]) for b in batches)} synthetic mRNA reads, validate on {card}")
    print("\n".join(gpu.lines))
    same = sum(a == b for a, b in zip(gpu.lines, cpu.lines))
    print(f"phase 14 validate: table lines equal GPU vs CPU {same}/{len(cpu.lines)} "
          f"(card {t_gpu!r} s, CPU {time.perf_counter() - t0 - t_gpu!r} s)")
    require(gpu.lines == cpu.lines, "phase 14 validate: the card's tables differ from the CPU's")
    require(int(gpu.res["cnn+fb"]["success"].sum()) > 0 and any(p >= 0 for p in gpu.preds["llr"]),
            "phase 14 validate: no read passed or no barcode was called")

    # e. K12 at the wide models' step shapes
    for name in K12_WIDE_MODELS:
        m = load_model(name, dev)
        n, p = m.coef.shape
        K = torch.as_tensor(np.exp(-np.random.default_rng(B).uniform(0, 8, (B, n))).astype(np.float32), device=dev)
        require(torch.equal(svm.decision_values(K, m.params), svm.decision_values_plain(K, m.params)),
                f"K12 {name} B={B}: differs from the plain version")
        with numerics.full_float32():
            ms = time_ms(lambda: svm.decision_values(K, m.params))
            device_ms = time_ms(lambda: svm.decision_values(K, m.params), queued=True)
            plain_ms = time_ms(lambda: svm.decision_values_plain(K, m.params), reps=3)
            lib_ms = time_ms(lambda: torch.addmm(m.intercept, K, m.coef))
            lib_device_ms = time_ms(lambda: torch.addmm(m.intercept, K, m.coef), queued=True)
        bound_ms, bound_by = bound(*k12_work(B, n, p))
        print(f"K12 {name} B={B} N={n} P={p} (the step's shape in bench_models): max_abs_err=0.0 kernel_ms={ms!r} "
              f"device_ms={device_ms!r} plain_ms={plain_ms!r} bound_ms={bound_ms!r} by {bound_by} "
              f"share={bound_ms / device_ms!r} library_ms={lib_ms!r} library_device_ms={lib_device_ms!r} "
              f"(torch.addmm, TF32 off) on {card}")
    return by_path


def phase14_main(out_path) -> int:
    """Phase 14 in a process of its own (`run_tool_process`): no profiler has
    been attached to it, so its launches cost what a tool's cost. Loads the
    kernel library the parent built and writes the launch counts by path to
    `out_path` as JSON."""
    import torch

    from warpdemux_tpu_torch import _cuda

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    _cuda.library()
    by_path = run_tools(dev, card)
    with open(out_path, "w") as fh:
        json.dump(by_path, fh)
    return 0


def run_tool_process(card):
    """Phase 14 (run_tools) in a child process on cuda:0, after phase 13:
    its output goes to this process's, its launch counts come back."""
    import tempfile
    from pathlib import Path

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        out = Path(d) / "launches.json"
        sys.stdout.flush()
        proc = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; sys.exit(chip_smoke.phase14_main(sys.argv[1]))",
             str(out)],
            cwd=Path(__file__).resolve().parent, timeout=900,
        )
        require(proc.returncode == 0, f"phase 14: the tools' process exited {proc.returncode}")
        by_path = json.loads(out.read_text())
    print(f"phase 14: {time.perf_counter() - t0!r} s in a process of its own on {card}")
    return by_path


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from warpdemux_tpu_torch.utils.synthetic import synth_minibatch  # fails outside the repository
    from warpdemux_tpu_torch import _cuda

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _cuda.library()
    print(f"kernel build + load: {time.perf_counter() - t0:.1f} s")
    print("\n".join(_cuda.ptxas_summary(_cuda.build_log(_cuda.build()).read_text())))

    results = check_kernels(dev, card)
    steps = _steps(dev)
    by_path = run_main_paths(dev, steps)
    by_path.update(run_wide_shapes(dev, card))
    norm_counts, norm_steps = run_prenormalization(dev, card)
    by_path.update(norm_counts)
    rng = np.random.default_rng(0)
    step_rates = time_throughput(steps, card, PATHS, [synth_minibatch(rng, B, L) for _ in range(4)])
    offline_counts, offline_run = run_offline_loop(dev, card, step_rates)
    by_path.update(offline_counts)
    by_path.update(run_twostage_wire(dev, card))
    trna_counts, trna_steps, trna_rows = run_trna_path(dev, card)
    by_path.update(trna_counts)
    family_counts, rna002_steps, rna002_rows = run_families_and_rna002(dev, card, steps["vbz_full"])
    by_path.update(family_counts)
    by_path.update(run_trainers(dev, card))
    by_path["live_lane"], lane_program = run_live_lane(dev, card)
    by_path.update(run_worker_processes(card))
    count_step_ops(steps, lane_program, offline_run, (trna_steps, trna_rows), (rna002_steps, rna002_rows), norm_steps)
    run_profiling_tools(dev, card)
    by_path.update(run_tool_process(card))

    kernels = []
    for key, (name, source, replaces) in KERNELS.items():
        counts = {path: n[key] for path, n in by_path.items()}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"warpdemux_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": sum(counts.values()),
            "launches_by_path": counts,
            **results[key],
        })
    # every kernel a path is pinned to launch was launched; the elementwise
    # log is pinned to none since K14 took the LLR cost whole (phase 2 holds it)
    pinned = {key for counts in LAUNCHES.values() for key, n in zip(KERNELS, counts) if n}
    require(pinned == set(KERNELS) - {"wdx_xla_log"}, f"kernels pinned to no path: {set(KERNELS) - pinned}")
    require(all(k["launches"] > 0 for key, k in zip(KERNELS, kernels) if key in pinned),
            "a kernel was launched by no main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
