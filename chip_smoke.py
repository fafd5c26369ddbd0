#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (diffwave_sashimi_torch).

    python3 chip_smoke.py            # from the repository root, one GPU

Phases, each fatal on failure (non-zero exit, no result line):

1. build the CUDA kernels from ``diffwave_sashimi_torch/csrc`` (with
   ``nvcc -Xptxas -v`` of ``csrc/cauchy.cu``, ``csrc/fftconv.cu``,
   ``csrc/fftconv_long.cu``, ``csrc/chmix.cu``, ``csrc/fftconv_int8.cu``
   and ``csrc/wavenet_gate.cu`` beside the build: the registers and
   spills of each kernel-4 instance ``<K>``, each kernel-8 instance ``<K,
   PAIRED>``, each instance ``<M, Q, T>`` of kernels 5 and 5f's radix-16
   route, each f32 instance ``<M, FUSED, float>`` of kernel 1's, kernel
   5L's two passes and each instance ``<N1, N2, NT, T>`` of its cluster
   kernel, each instance of kernel 9's three passes (KERNEL_9_PASSES), the
   3xTF32 kernels of kernels 2, 3, 6, 7 and 11 (each ``<P, blocks an SM>``
   or ``<P>`` they are built for, and their weights' splits) and each
   kernel-12 instance ``<T, threads>``, none of which may spill; and, by
   ``cuobjdump -sass``, the tf32 ``HMMA`` instructions in
   each 3xTF32 kernel, which must have some) and require a CUDA device;
2. build the shipped SC09 model (d_model 128, n_layers 6, pool [4, 4],
   expand 2, ff 2, L 16000) from a seed, with a perturbed (normally
   zero-initialised) final conv, and save it as a checkpoint in a
   temporary ``exp/`` directory;
3. hold each of the four kernels against its plain PyTorch version on the
   card at the shapes the sampling path gives it at all three UNet tiers;
   kernel 1 also on both its routes (``ops.fftconv.conv_plan``: the
   radix-16 kernel, two calls bit-equal, its relative L2 error against a
   float64 evaluation at most twice the plain version's; the Stockham
   kernel against the plain version), the two timed in CUDA graphs in
   turns beside a cuFFT conv of the shapes (a yardstick); kernels 2 and 3
   (f32, their products in 3xTF32) two calls bit-equal, their float64
   error at most twice the plain version's, their time by part, in CUDA
   graphs beside their products as f32 ``torch.matmul`` calls (TF32 off;
   a yardstick) and at every (P, blocks an SM) they are built for; kernel
   4 (its (K, M, Lz, 2) output) also two calls bit-equal, against a
   complex128 evaluation of the sum at most twice the plain version's
   error, timed in a CUDA graph, its plan printed;
4. the main path: ``generate()`` at T = 200, f32, a few samples, with every
   kernel's launch count set to 0 just before and read just after (each
   must be > 0), and finite output of the right shape; then (4b) the
   shipped command, ``runtime.generate.main(["experiment=sc09",
   "generate.n_samples=4"])`` with no precision override (bf16: kernels
   1f, 2f and 3f exactly 6000 times each, kernel 4 30 times, no f32 form),
   and again with ``+compute.conv_int8=true`` (kernel 12 6000 times, 1f
   never), counts read around each run;
5. one eps forward through the kernels against the plain path on the card;
6. timings (CUDA events, after warm-up): each kernel and its plain
   version, and the eps forward (one sampling step) both ways at the main
   path's batch and at batch 16; then (6b) kernels 1f, 2f, 3f and 12 (its
   bf16 and f32 epilogues) against their plain versions at the three
   tiers, B4, timed, 1f on both its routes (two calls of its radix-16
   kernel bit-equal, the route ``ops.fftconv.conv_plan`` does not take
   held against the plain version and timed in turns with the one it
   takes, a cuFFT conv of the shapes beside them as ``cufft_conv_ms``, a
   yardstick), 3f also at F = H (off the shipped F = 2H), 2f also
   at H 1024 (d_model 256's deepest tier, L 1000) and on its element-wise
   path (L 1001 at H 128 and 256, B2; y and res one element off a
   16-byte boundary), kernel 12 against an
   f64 direct conv and, at B4 and B16 with both epilogues, two calls
   bit-equal, timed in a CUDA graph beside a cuFFT conv and kernel 1f of
   its shapes, beside 2f its channel product as one bf16
   ``torch.matmul`` (``gemm_ms``) and beside 3f its two as two
   (``gemm_pair_ms``; yardsticks, not library calls of their functions),
   and 3f's entry with the f32 weights
   rounded in the kernel instead of by a pass into a scratch (equal
   outputs; ``weights_in_kernel_ms`` beside ``weights_scratch_ms``); (6c)
   bf16 and int8 eps through the kernels against the bf16 plain path, and
   the quality gate: a 50-step reverse process with one injected noise
   stack, whose bf16 and int8 x_0 must correlate >= 0.99999 with f32's;
   (6d) the bf16 and int8 eps step timed at B4 and B16 and traced at both
   (kernel 1f's time apart in the bf16 steps, kernel 12's in the int8
   ones, each with its share of the busy time and the device's idle
   share; a trace with no device time fails);
7. the training kernels (kernel 1's training entry and its conjugate
   form, kernels 4-8) against their plain versions at the three tiers,
   with their times, kernel 1 held on both its routes as in phase 3,
   kernel 4 held beyond that as in phase 3 and at four
   shapes off the shipped ones (odd K, K 8, blocks of fewer threads, N
   800 past 48 KB of records) against its plain version, two calls
   bit-equal; kernels 7 and 6 (f32, their per-position products in
   3xTF32 on the tensor cores; 6 also at every (P, blocks an SM) it is
   built for, ``p_ms``) at each tier also two calls bit-equal,
   the worst error of their outputs against a float64 evaluation at most
   twice the plain version's (a tensor's relative L2 error; kernel 7's
   sums dm and ds as |err| over the sum of their terms' magnitudes),
   their device time by part from a trace (a kernel-7 call launches
   nothing but its seven kernels), and timed in CUDA graphs in turns with
   their products as f32 ``torch.matmul`` calls (TF32 off; a yardstick),
   7 also at F = H, on its element-wise path (B2 L1001, H 128 and 256)
   and at H 24, F 40 (widths that pad the last m-tile; with kernel 6 at
   H 24); then (7b) their bf16 forms (1f's training entry and its
   conjugate form, each on both routes as in 6b, 5f, 6f, 7f) at the
   three tiers, B4, timed, 7f also
   at F = H, 6f and 7f also on their element-wise paths (B2, L 1001, H
   128 and 256); at each tier two 7f calls and two 6f calls must agree
   bit for bit, a trace gives each one's time by part (its pass, the
   weight-gradient contractions, the reductions; a 6f call must launch
   nothing else), 6f runs at every P its kernel is built for whose tiles
   fit (each held against the plain version and timed in turns), and
   beside 7f its three channel products as three bf16 ``torch.matmul``
   calls and its two weight gradients as two f32 ones with TF32 off,
   beside 6f its two as two bf16 calls and its weight gradient as one f32
   call (yardsticks, not library calls of their functions); at each tier
   two kernel-8 calls must agree bit for bit, and kernel 8 and its plain
   version are held against a complex128 evaluation of the same formulas
   (kernel 8's error at most twice the plain version's), kernel 8 timed in
   a CUDA graph; kernel 8 also at three shapes off the shipped ones (N
   below 32, odd K, partial chunks) against its plain version; kernel 5
   (and 5f in 7b, and at d_model 256's tiers in phase 24) also at B1, B3
   and B6 (2, 6 and 8 transforms a channel, B6 in two chunks of 4 rows)
   against its plain version, two calls bit-equal at every batch, its
   relative L2 error against complex128 at most twice the plain
   version's, the Stockham kernel held against the plain version, timed
   in CUDA graphs in turns with the radix-16 route and at each chunk size
   the plan could take (``rows_ms``), beside one ``torch.fft.rfft`` of u
   and g stacked (``cufft_rfft_ms``, a yardstick); (7c) the training
   route past FFT size 32768 at the ljspeech_harder top tier's shapes (B2
   H128 L44000, n 2^17) and at B4 H128 L30000 (n 2^16): kernel 9's
   training entries (the conv and its conjugate form, f32 and bf16)
   against ``fftconv_long_ref``, the bf16 entry bit-equal to the f32 entry
   on the widened input, narrowed, and timed in CUDA graphs in turns with
   that composite, a cuFFT conv of the shapes beside them (a yardstick);
   kernel 5L on its cluster route (``dkf_long_plan``), on f32 and bf16
   inputs, against its plain version at TOL_KERNEL, two calls bit-equal,
   one allocation a call (its output: no scratch), its L2 error against
   complex128 at most twice the plain version's, its two-pass route held
   against the plain version, the two timed in CUDA graphs in turns,
   beside a ``torch.fft.rfft`` of u and g (a yardstick), and the clusters
   the card holds at once at each n (none fails);
8. the training path: a seeded synthetic SC09 corpus (one-second 16 kHz
   ``*_nohash_*.wav`` clips, a few per digit folder) and the port's
   ``runtime.train.main`` with ``experiment=sc09 compute.precision=f32``
   for 4 iterations at full width and batch 4 (checkpoint at 2), then a
   resume from 'max' for one more step; every kernel the training step
   runs must have launched, the losses must be finite and the checkpoint
   must exist; then (8b) the shipped training command,
   ``runtime.train.main(["experiment=sc09", ...])`` with no precision
   override (bf16), 4 iterations and a resume on the same corpus: exact
   launch counts (kernel 1f's training entry 240, kernels 2f, 3f, 4, 5f,
   6f, 7f and 8 120 each, no f32 form), finite losses, an f32 checkpoint;
9. one training step's loss and every parameter gradient through the
   kernels (ops.FUSED) and through torch autograd of the plain versions
   (ops.PLAIN), on the same batch, t and z; then (9b) the same at bf16,
   and the bf16 gradients' distance from the f32 ones; (9c) the quality
   gate of bf16 training: TRAJ_STEPS Adam steps from one init on the
   same batches, t and z at bf16 and at f32, through the kernels, whose
   per-step losses must agree within TRAJ_TOL;
10. the training step (forward, backward, Adam) timed both ways; (10b) the
    bf16 training step against its plain path and against the f32 step,
    and a trace of two bf16 steps that reports kernel 7f's pass, 6f's
    pass, the weight-gradient contractions and the reductions apart from
    the rest (6f's pass must be its tensor-core kernel and its rounding
    instance, with no kernel-6 instance) and kernel 1f's, 5f's, kernel
    8's, kernel 4's and PyTorch's elementwise copies' times apart (5f must
    be its radix-16 kernel);
11. a torch.profiler trace of two training steps with the kernels: device
    time by kernel, the port's kernels' share, kernel 8's time (its lanes
    kernel and its reduce pass; both traces fail without the lanes
    kernel, without kernel 4's ``cauchy_fwd_kernel``, and without kernel
    5's or 5f's radix-16 kernel), kernel 7's pass, the contractions of
    kernels 6 and 7, their sums and kernel 6's pass (its split and its
    3xTF32 kernel) apart (the f32 trace
    fails without kernel 7's 3xTF32 kernels), the device's idle share;
    each trace fails if the profiler recorded no device time, or if in
    TRACE_ATTEMPTS traces it lacked a kernel that the host launched;
12. the vocoder: the shipped LJSpeech model (``experiment=ljspeech``:
    d_model 128, n_layers 6, pool [4, 4], L 16000, mel_upsample [16, 16],
    hop 256 at 22050 Hz) from a seed, with a perturbed final conv, saved as
    a checkpoint under its ``_L16000_hop256_cond`` run name, and a seeded
    synthetic 6.5 s int16 utterance (harmonics, a chirp, noise) as
    ``LJ001-0001.wav`` in a temporary data_path;
13. the vocoding path: ``generate(mel_name=...)`` at T = 50, 2 samples of
    560 frames x 256 = 143360 samples, with every launch count set to 0
    just before and read just after: kernel 9 24 x 50 times (the top and
    middle tiers, n 2^18 and 2^16), kernel 1 6 x 50 (the deepest, n 16384),
    kernels 2 and 3 30 x 50, kernel 4 30; finite output of that length and
    a fidelity.json; then (13b) the shipped vocoding command,
    ``runtime.generate.main(["experiment=ljspeech", "generate.n_samples=2",
    "dataset.data_path=..."])`` with no precision override (bf16): kernel
    9f exactly 24 x 50 times, 1f 6 x 50, 2f and 3f 30 x 50 each, kernel 4
    30, no f32 form; finite wavs of 143360 samples and a fidelity.json;
14. the precomputed-mel route: the port's ``mel2samp`` CLI writes the
    utterance's mel, which loads equal to the one computed on the fly;
15. kernel 9 (both entries, three passes; the f32 sampling form also two
    calls bit-equal, its float64 L2 error at most twice the plain
    version's, and timed in a CUDA graph beside a cuFFT conv, by
    ``hold_9_f32``) against its plain version at
    the top and middle tiers' shapes (B2 H128 L143360 n 2^18, H256 L35840
    n 2^16), at B2 H128 L100000 (n 2^17), n 4096 (H512 L3000) and n 2^19
    (H128 L300000), kernel 1 at the deepest tier (n 16384 < 2L; on both
    its routes as in phase 3) and kernels 2 and 3 at the three tiers (as
    phase 3 holds them), timed; (15b) kernel 9f at the same five shapes (bf16 activations; its
    cluster route, one thread-block cluster a transform row, at n 2^16
    and 2^17, its three passes at the others), kernel 1f at the deepest
    tier (B2 H512 L8960 n 16384: L > n/2, the whole transform) on both
    its routes as in 6b, and kernels 3f and 2f at
    the vocoder's three tiers (B2: H128 L143360, H256 L35840, H512
    L8960), timed, 3f with its two weight designs as in 6b and 2f with
    its ``gemm_ms``.  At n 2^16, 2^17 and 2^18, two calls of 9f's cluster
    kernel must be bit-equal, the route 9f does not take there is held
    against the plain version and timed in turns with the one it takes
    (``three_pass_ms`` or ``cluster_ms``), and a cuFFT conv of the same
    shapes is timed beside it (``cufft_conv_ms``; both yardsticks, which
    the port never calls); the clusters of each size the card holds at
    once are printed first;
16. one vocoder eps forward through the kernels against the plain path;
    (16b) the same at bf16 against the bf16 plain path, and the quality
    gate: a 50-step reverse process at the vocoder's schedule with one
    injected noise stack, whose bf16 x_0 must correlate >= 0.99999 with
    f32's;
17. the vocoder step's eps forward timed both ways at B2 (ms per step, the
    realtime factor), and a torch.profiler trace of two steps; (17b) the
    bf16 step against its plain path and, in turns, against the f32 step,
    and, in turns, against the bf16 step with 9f on the three passes at
    every n, and a trace of two bf16 steps; each trace must show kernel
    9's three passes, the bf16 one also its cluster kernel and the f32
    one not (each route's share of the device's busy time reported);
18. the WaveNet: the shipped ``experiment=sc09_wavenet`` model (res 256,
    skip 256, 36 layers, dilation cycle 12) from a seed, with a perturbed
    final conv, saved as a checkpoint under its ``wnet_h256_d36`` run name;
19. kernel 11 (the gate + res/skip tail) against its plain version at the
    sampling path's shape (B4 C256 S256 L16000), at B16, and at a ragged
    length with S != C (C128 S256 L8960), timed; (19b) kernel 11f at the
    same cases (bf16 activations), timed, and at C24 S40 L333 (a width
    that is a multiple of 8 but not 16, S != C, a ragged L: the zero
    padding of its rounded weights and gate tile); two calls at the top
    case bit-equal; one bf16 ``torch.matmul`` of the stacked weight by
    the gate's shape beside it (``gemm_ms``, a yardstick);
20. the WaveNet sampling path: ``generate()`` at T = 200, B4, with every
    launch count set to 0 just before and read just after: kernel 11
    exactly 36 x 200 times, every other kernel never; finite output of
    shape (4, 1, 16000) in the ``<iter//1000>k_<i>.wav`` layout; then
    (20b) the shipped command, ``runtime.generate.main(
    ["experiment=sc09_wavenet", "generate.n_samples=4"])`` with no
    precision override (bf16): kernel 11f exactly 36 x 200 times, every
    other kernel never, finite wavs;
21. one WaveNet eps forward through the kernel against the plain path,
    and the same for a conditional WaveNet of that width (mel_upsample
    [16, 16], a seeded mel of 63 frames, L 16128); (21b) both at bf16
    against the bf16 plain path, and the quality gate: 50 steps with one
    injected noise stack, bf16 x_0 vs f32's, corr >= 0.99999;
22. the WaveNet eps forward timed both ways at B4 and B16 (ms per step,
    the realtime factor at T = 200), and a torch.profiler trace of two
    steps: device time in kernel 11, in the convolution and GEMM library
    kernels (the dilated conv), and the rest, and the idle share; (22b)
    the bf16 step at B4 and B16 against its plain path and, in turns,
    against the f32 step, and a trace of two bf16 steps split the same
    way;
23. WaveNet training: ``runtime.train.main`` with ``experiment=sc09_wavenet
    compute.precision=f32`` for 3 iterations at B4 on phase 8's synthetic
    corpus (checkpoint at 2), then a resume from 'max' for one more
    (checkpoint 3, whose Adam state must show 4 steps); finite losses, no
    kernel launched (the training form has none, as in JAX); then the
    training step timed; (23b) the shipped WaveNet training command, bf16
    with no precision override, 3 iterations (no kernel launched, finite
    losses, an f32 checkpoint), and the bf16 trajectory gate: TRAJ_STEPS
    Adam steps at bf16 and at f32 from one init, per-step losses within
    TRAJ_TOL;
24. a wider SaShiMi, d_model 256 (tiers H 256, 512, 1024) at L 16000 from
    a seed, depth cut to n_layers 1: the channel mixers (kernels 2, 3, 6,
    7 and their f forms) against their plain versions at its H 1024 tier
    (B4, L 1000; the fp32 plans narrow P to 16, and to 8 for kernel 7, so
    the tiles fit one block; 3f, 6f and 7f run at P 16), timed; kernels 4
    and 8 at its three tiers as in phases 3 and 7 (vs plain, bit-equal, vs
    complex128 beside the plain version, timed in a CUDA graph), and
    kernels 2, 3, 6 and 7 (f32) there as phases 3 and 7 hold them; at f32
    and
    at bf16 one eps forward and one training step through the kernels
    against the plain path, each with exact launch counts of every kernel,
    and the eps step timed;
25. vocoder training: seeded synthetic 22050 Hz LJSpeech clips and the
    port's ``runtime.train.main(["experiment=ljspeech", ...])`` at its
    shipped bf16 and at f32, 3 iterations each at full width and B4,
    exact launch counts (the SC09 training kernels' per step), finite
    losses, checkpoint 2; one training step of the seeded full-width
    vocoder (mel terms through autograd) at each of two seeded batches,
    kernels vs plain at phase 9's bar (f32) and phase 9b's (bf16; its
    per-tensor bar over the tensors with the scalar gradients stacked by
    kind), and the bf16 step timed;
26. ``experiment=ljspeech_harder`` (L 44000, hop 2048, mel_upsample [32,
    64], B2) through ``main`` at bf16, 3 iterations: per step exactly 24
    launches of kernel 9's training entry (12 of them its conjugate form)
    and 12 of kernel 5L (the top tier, n 2^17), 1f 36 and 5f 18 (n 32768
    and 8192),
    30 each of 2f, 3f, 4, 6f, 7f, 8; its gradients kernels vs plain as in
    phase 25 at depth cut to n_layers 2 (HARDER_GRAD_LAYERS: the plain
    path's memory), the bf16 step timed at full depth and traced (one
    step: the device's idle share, its top kernels, and per step exactly
    12 launches of 5L's cluster kernel and 24 of each of kernel 9's bf16
    training entry's three passes, no two-pass 5L kernel and no f32
    entry; a trace with no device time fails); kernels 4 and 8 at its top tier (Lz 22001), 6f and 7f at L
    44000, 1f and 5f at L 11000 vs plain;
27. data parallelism at the main path's width (SC09 SaShiMi d128 n6
    L16000, a global B4 of B2 a rank, phase 2's seeded model built anew:
    no state of phase 10's Adam steps), through ``parallel.launch`` and
    ``runtime.train.train_ranks``: (a) two ranks on this card over gloo
    (NCCL refuses two ranks on one card) with CUDA tensors, their DDP step
    through the kernels at f32 and bf16 against one 1-rank B4 step on
    phase 9's batch, t and z (phase 9's f32 bar, 9b's bf16 bars), both
    ranks' gradients and parameters after each of two steps bit-equal,
    each rank's launches each step exactly the 1-rank step's, each rank's
    step time printed (two processes sharing one card: not a scaling
    figure); then the shipped bf16 training at two ranks for 3 iterations:
    the ranks' parameters bit-equal, their launches exact, one checkpoint
    and one metrics.jsonl, rank 0's, with no ``module.`` in the names;
    (b) NCCL at one rank through the same function: its losses equal the
    plain world-1 run's, phase 8b's first 3 (iteration 0 bit-equal, the
    rest within 1e-5); (c) NCCL at two ranks across two cards with (a)'s
    gates where the machine has two (``dp_cards.py`` runs phase 27 alone
    on such a machine), else one line saying it was not run and why;
    (d, after phase 4) ``generate(rank=1, world=2)`` writes ``1k_4`` to
    ``1k_7`` and draws other samples than rank 0.  The training phases
    through ``main()`` above pin ``mesh.data=1``: they read this process's
    launch counts.

It prints the card's name and power limit, one JSON line with the kernels
(each with its bound: the larger of its bytes over the HBM rate and its
operations over the peak rate of their type, fp32, bf16, int8 or TF32 (a
3xTF32 product three TF32 ones), at the top tier's shapes of the path
that runs it; kernels 2, 3, 7 and 11 also with ``fp32_bound_ms``, every
product on the fp32 FMAs), and last ``{"ok": true, "device": {...}}``.
The config blocks below are ``load_config(["experiment=sc09"])``,
``load_config(["experiment=ljspeech"])``, the model and dataset blocks of
``load_config(["experiment=ljspeech_harder"])`` and the model block of
``load_config(["experiment=sc09_wavenet"])`` written out (a CPU test pins
them), so this script imports nothing of the JAX package.
"""

import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

SEED = 0
N_SAMPLES = 4                 # the main path's batch
TOL_KERNEL = 1e-4             # |kernel - plain| <= TOL * max(1, max|plain|)
# the bf16 forms (1f, 2f, 3f): about one bf16 rounding of the output; the
# int8 conv (12): rare flips of a quantization tie between the two
TOL_BF16 = 1e-2               # |kernel - plain| <= TOL * max(1, max|plain|)
TOL_INT8 = 1e-2               # the same bar
TOL_INT8_F64 = 3e-2           # kernel 12 vs an f64 direct conv, of max|ref|
TOL_EPS = (1e-3, 1e-2)        # eps: |kernel - plain| <= atol + rtol * |plain|
# bf16 / int8 eps through the kernels vs the same precision's plain path:
# the kernels' bf16 roundings may land the other way and compound through
# 30 blocks; max |kernel - plain| <= TOL * max|plain|
TOL_EPS_BF16 = 4e-2
# int8 eps: the int8 conv's own error on a row offset by the step bias
# reaches ~1.5e-1 of its max at the top tier (phase 6b) and enters eps
# through 30 blocks, at the same level through the kernels as through the
# plain path; held to rms(kernels - bf16 plain) <= TOL * rms(int8 plain -
# bf16 plain) + 1e-3, both relative to rms(bf16 plain)
TOL_EPS_INT8 = 1.1
CORR_MIN = 0.99999            # x_0 vs f32 over 50 steps (BASELINE.md:316)
TOL_GRAD = 1e-3               # |grad kernels - plain| <= TOL * max(1, max|plain|)
PEAK_OPS = {"fp32": 67e12,    # H100 SXM: fp32 outside the tensor cores,
            "bf16": 989e12,   # dense bf16, int8 and TF32 on the tensor cores
            "int8": 1979e12,
            "tf32": 495e12}
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
# a trace first launches TRACE_LEAD one-element adds that it does not
# account for, then the calls it accounts for, inside a range of this
# name: the profiler loses the device kernels of a trace's first launches,
# a count that grew over a run from 1 to 22 (all but one call of a
# 5-call trace of kernel 6 late in a run), whatever the host did before
TRACE_RANGE = "dwst_traced_calls"
TRACE_LEAD = 256
# traces taken of the same calls before a trace that still lacks a kernel
# fails the phase: each short one is logged
TRACE_ATTEMPTS = 3
# the host's kernel-launch calls as the profiler names them (runtime and
# driver API; cluster launches go through the Ex forms)
LAUNCH_API = re.compile(r"cu(da)?Launch\w*Kernel")
QUALITY_CFG = {"T": 50, "beta_0": 0.0001, "beta_T": 0.02, "beta": None}
# the training phases through main() run on one card (mesh.data=1; the
# shipped -1 is every card): they read the launch counts of this process
TRAIN_OVERRIDES = ["experiment=sc09", "compute.precision=f32",
                   "train.n_iters=3", "train.iters_per_ckpt=2",
                   "train.iters_per_logging=1", "generate.n_samples=0",
                   "mesh.data=1"]
# the shipped training command: experiment=sc09 trains at bf16
TRAIN_BF16_OVERRIDES = [o for o in TRAIN_OVERRIDES
                        if not o.startswith("compute.precision")]
# its first run, 4 iterations of 30 blocks: kernel 1f's training entry
# twice a block (the conv and its conjugate, the input gradient), the rest
# once
TRAIN_BF16_LAUNCHES = {"fftconv_bf16": 4 * 60, "fftconv_dkf_bf16": 4 * 30,
                       "glu_res_bwd_bf16": 4 * 30,
                       "ln_ff_res_bwd_bf16": 4 * 30, "glu_res_bf16": 4 * 30,
                       "ln_ff_res_bf16": 4 * 30, "cauchy": 4 * 30,
                       "cauchy_bwd": 4 * 30}
# bf16 gradients, kernels vs the bf16 plain path, per tensor |a - b|_2 /
# |b|_2: the median over the tensors, the worst tensor, and the largest
# entry error over the largest plain gradient (the loss is held to the
# entry bar, relative).  The two differ where a bf16 rounding (of a
# product's operand, of an activation) lands the other way after sums
# taken in other orders, and the plain path's weight gradients are rounded
# to bf16 by its casts' backward; scalar gradients that cancel over every
# position (norm1.s) move most.  A first card run of this phase measured
# median 2.0e-3, worst 0.12, entry 2.2e-3; the bf16 gradients' distance
# from the f32 ones was median 8.8e-3, entry 4.4e-3: the median and entry
# bars sit between the two.
TOL_GRAD_BF16 = {"median": 5e-3, "worst": 0.25, "entry": 5e-3}
# phases 25 and 26 hold the vocoder's bf16 gradients at those bars, its
# scalar gradients (TransposedLN's m and s, the mel upsampler's weight_g
# and bias) stacked by kind: each is a sum over every position that
# cancels up to some hundredfold, so bf16 roundings move it by its own
# size on either bf16 path (vocoder_grads.py at five seeds: single scalars
# kernels vs plain up to 4.09 relative, the plain bf16 path vs f32 up to
# 8.88), while each kind across the blocks (the parameter's name without
# its block, as norm2.m) as one tensor agrees within 0.024 and the mel
# upsampler's effective weight gradients within 0.091; at VOC_GRAD_SEEDS,
# two seeded batches
VOC_GRAD_SEEDS = (SEED + 31, SEED + 33)
# the quality gate of bf16 training: per-step losses of TRAJ_STEPS Adam
# steps at bf16 vs f32 from one init, |bf16 - f32| <= atol + rtol |f32|
# (the JAX suite's trajectory bar, tests/test_train_dynamics.py:116)
TRAJ_STEPS = 20
TRAJ_TOL = {"rtol": 3e-2, "atol": 2e-3}

DIFFUSION_CFG = {"T": 200, "beta_0": 0.0001, "beta_T": 0.02, "beta": None}
MODEL_CFG = {"_name_": "sashimi", "unconditional": True, "in_channels": 1,
             "out_channels": 1, "diffusion_step_embed_dim_in": 128,
             "diffusion_step_embed_dim_mid": 512,
             "diffusion_step_embed_dim_out": 512, "unet": True,
             "d_model": 128, "n_layers": 6, "pool": [4, 4], "expand": 2,
             "ff": 2, "L": 16000}
DATASET_CFG = {"_name_": "sc09", "data_path": "data/sc09",
               "segment_length": 16000, "sampling_rate": 16000}

VOC_SAMPLES = 2               # the vocoder's batch (generate.n_samples)
VOC_SECONDS = 6.5             # a typical LJSpeech utterance
VOC_MEL = "LJ001-0001"        # generate.mel_name of experiment=ljspeech
# phase 15's added long-conv shapes (H128): n 2^17 on the cluster route,
# n 2^19 on the three-pass route
VOC_L_2_17, VOC_L_2_19 = 100000, 300000
VOC_DIFFUSION_CFG = {"T": 50, "beta_0": 0.0001, "beta_T": 0.05,
                     "beta": None}
VOC_MODEL_CFG = dict(MODEL_CFG, unconditional=False, mel_upsample=[16, 16])
VOC_DATASET_CFG = {"_name_": "ljspeech",
                   "data_path": "data/LJSpeech-1.1/wavs",
                   "segment_length": 16000, "sampling_rate": 22050,
                   "valid": False, "filter_length": 1024, "hop_length": 256,
                   "win_length": 1024, "mel_fmin": 0.0, "mel_fmax": 8000.0}

WNET_MODEL_CFG = {"_name_": "wavenet", "unconditional": True,
                  "in_channels": 1, "out_channels": 1,
                  "diffusion_step_embed_dim_in": 128,
                  "diffusion_step_embed_dim_mid": 512,
                  "diffusion_step_embed_dim_out": 512, "res_channels": 256,
                  "skip_channels": 256, "num_res_layers": 36,
                  "dilation_cycle": 12}   # its diffusion and dataset: sc09's
WNET_COND_CFG = dict(WNET_MODEL_CFG, unconditional=False,
                     mel_upsample=[16, 16])
WNET_MEL_FRAMES = 63          # x hop 256: L 16128 (phase 21)
WNET_LAUNCHES = {"gate_res_skip": 36 * 200}   # generate() at T = 200
# the shipped WaveNet command (phase 20b): bf16, kernel 11f in every block
# (a wrapper call, counted once, launches 11f's two kernels: the weights'
# rounding pass and the tensor-core kernel, KERNELS_11F)
WNET_BF16_LAUNCHES = {"gate_res_skip_bf16": 36 * 200}
# the shipped SC09 command at T = 200 (30 blocks a step, kernel 4 once per
# block and run): bf16, then with +compute.conv_int8=true
BF16_LAUNCHES = {"fftconv_ln_bias_gelu_d_bf16": 30 * 200,
                 "glu_res_bf16": 30 * 200, "ln_ff_res_bf16": 30 * 200,
                 "cauchy": 30}
INT8_LAUNCHES = dict(BF16_LAUNCHES, fftconv_ln_bias_gelu_d_bf16=0,
                     fftconv_int8=30 * 200)
# phase 24: a wider SaShiMi, d_model 256 (tiers H 256, 512, 1024) at full
# width and L 16000, depth cut to n_layers 1 (5 blocks: H 256, 512, 1024,
# 512, 256), every block through the kernels.  Exact counts of one eps
# forward (its spectra built before) and of one training step, at f32 and
# at bf16
D256_CFG = dict(MODEL_CFG, d_model=256, n_layers=1)
D256_EPS_LAUNCHES = {"fftconv_ln_bias_gelu_d": 5, "glu_res": 5,
                     "ln_ff_res": 5}
D256_EPS_BF16_LAUNCHES = {"fftconv_ln_bias_gelu_d_bf16": 5,
                          "glu_res_bf16": 5, "ln_ff_res_bf16": 5}
D256_TRAIN_LAUNCHES = {"cauchy": 5, "cauchy_bwd": 5, "fftconv": 10,
                       "fftconv_dkf": 5, "glu_res": 5, "glu_res_bwd": 5,
                       "ln_ff_res": 5, "ln_ff_res_bwd": 5}
D256_TRAIN_BF16_LAUNCHES = {"cauchy": 5, "cauchy_bwd": 5, "fftconv_bf16": 10,
                            "fftconv_dkf_bf16": 5, "glu_res_bf16": 5,
                            "glu_res_bwd_bf16": 5, "ln_ff_res_bf16": 5,
                            "ln_ff_res_bwd_bf16": 5}
WNET_TRAIN_OVERRIDES = ["experiment=sc09_wavenet", "compute.precision=f32",
                        "train.iters_per_logging=1", "generate.n_samples=0",
                        "mesh.data=1"]
# kernel 11's cases (B, C, S, L): the sampling path's, B16, and a ragged
# length with S != C (wavenet_small's widths)
GATE_CASES = ((N_SAMPLES, 256, 256, 16000), (16, 256, 256, 16000),
              (N_SAMPLES, 128, 256, 8960))
# kernel 8's cases (K, M, N, Lz) off the shipped shapes: N below a warp's
# 32 lanes (the rest masked), odd K and K = 8, partial chunks and splits
KERNEL_8_RAGGED = ((3, 24, 20, 777), (8, 40, 32, 1001), (1, 4, 7, 65))
# kernel 4's beside them: the same, and N 800, whose records pass a
# block's default 48 KB of shared memory (the launch opts in)
KERNEL_4_RAGGED = KERNEL_8_RAGGED + ((6, 8, 800, 501),)
# kernels 5's and 5f's batches off the shipped B4: 2 and 6 transforms a
# channel, and B6 in two chunks (4 rows, then 2)
DKF_BATCHES = (1, 3, 6)
# kernel 11f's case beside them: C a multiple of 8 but not 16, S != C and a
# ragged L, so its zero padding runs on the card
GATE_BF16_RAGGED = (2, 24, 40, 333)
# phase 7c: the training route past FFT size 32768, (B, H, L, n): the
# ljspeech_harder top tier's shapes (B2, L 44000, n 2^17) and one n 2^16
# shape (B4, L 30000)
LONG_TRAIN_CASES = ((2, 128, 44000, 1 << 17), (4, 128, 30000, 1 << 16))
# phases 25 and 26: vocoder training through runtime.train.main on seeded
# synthetic LJSpeech clips (phase 12's utterance at VOC_TRAIN_CLIPS
# pitches), VOC_TRAIN_ITERS iterations (n_iters + 1), checkpoint at 2
VOC_TRAIN_CLIPS = 4
VOC_TRAIN_ITERS = 3
VOC_TRAIN_ARGS = ["train.n_iters=2", "train.iters_per_ckpt=2",
                  "train.iters_per_logging=1", "generate.n_samples=0",
                  "mesh.data=1"]
# one bf16 (f32) SaShiMi training step whose 30 blocks all convolve at FFT
# sizes up to 32768 (SC09, experiment=ljspeech): kernel 1f's (1's)
# training entry twice a block (the conv and its conjugate form), the rest
# once
TRAIN_BF16_STEP = {"fftconv_bf16": 60, "fftconv_dkf_bf16": 30,
                   "glu_res_bf16": 30, "glu_res_bwd_bf16": 30,
                   "ln_ff_res_bf16": 30, "ln_ff_res_bwd_bf16": 30,
                   "cauchy": 30, "cauchy_bwd": 30}
TRAIN_F32_STEP = {"fftconv": 60, "fftconv_dkf": 30, "glu_res": 30,
                  "glu_res_bwd": 30, "ln_ff_res": 30, "ln_ff_res_bwd": 30,
                  "cauchy": 30, "cauchy_bwd": 30}
# experiment=ljspeech_harder at bf16: its top tier's 12 blocks (L 44000, n
# 2^17) take kernel 9's training entry twice (the conv and its conjugate
# form) and kernel 5L once, the 18 below (n 32768 and 8192) kernels 1f and
# 5f
HARDER_BF16_STEP = dict(TRAIN_BF16_STEP, fftconv_bf16=36,
                        fftconv_dkf_bf16=18, fftconv_long=24,
                        fftconv_dkf_long=12)
# its config (load_config(["experiment=ljspeech_harder"]), pinned by a CPU
# test)
HARDER_MODEL_CFG = dict(VOC_MODEL_CFG, L=44000, mel_upsample=[32, 64])
HARDER_DATASET_CFG = dict(VOC_DATASET_CFG, segment_length=44000,
                          hop_length=2048)
HARDER_SAMPLES = 2                # its train.batch_size_per_gpu
# phase 26's gradients kernels vs plain at depth cut to n_layers 2: the
# plain path's S4 kernel construction at Lz 22001 keeps (H, N, Lz)
# complex intermediates under autograd, 0.72 GB each at the top tier's H
# 128, and at the full depth's 30 blocks its step passes the card's 80 GB
HARDER_GRAD_LAYERS = 2
# phase 27: data parallelism at the main path's width (SC09 SaShiMi d128
# n6 L16000), DP_RANKS ranks of N_SAMPLES / DP_RANKS rows: the shipped
# global batch of 4; the trainer runs 3 iterations (checkpoint 2) of the
# shipped bf16 command
DP_RANKS = 2
DP_OVERRIDES = TRAIN_BF16_OVERRIDES + ["train.n_iters=2"]
DP_ITERS = 3

# name -> (source, TPU kernel it replaces, the paths that launch it)
KERNELS = {
    "fftconv_ln_bias_gelu_d": ("diffwave_sashimi_torch/csrc/fftconv.cu",
                               "diffwave_sashimi_tpu/ops/fftconv2.py:427",
                               ("generate",)),
    "glu_res": ("diffwave_sashimi_torch/csrc/chmix.cu",
                "diffwave_sashimi_tpu/ops/chmix.py:119",
                ("generate", "train")),
    "ln_ff_res": ("diffwave_sashimi_torch/csrc/chmix.cu",
                  "diffwave_sashimi_tpu/ops/chmix.py:182",
                  ("generate", "train")),
    "cauchy": ("diffwave_sashimi_torch/csrc/cauchy.cu",
               "diffwave_sashimi_tpu/ops/cauchy_pallas.py:54",
               ("generate", "train", "train_bf16")),
    "fftconv": ("diffwave_sashimi_torch/csrc/fftconv.cu",
                "diffwave_sashimi_tpu/ops/fftconv2.py:427", ("train",)),
    "fftconv_dkf": ("diffwave_sashimi_torch/csrc/fftconv.cu",
                    "diffwave_sashimi_tpu/ops/fftconv2.py:707", ("train",)),
    "glu_res_bwd": ("diffwave_sashimi_torch/csrc/chmix.cu",
                    "diffwave_sashimi_tpu/ops/chmix.py:414", ("train",)),
    "ln_ff_res_bwd": ("diffwave_sashimi_torch/csrc/chmix.cu",
                      "diffwave_sashimi_tpu/ops/chmix.py:362", ("train",)),
    "cauchy_bwd": ("diffwave_sashimi_torch/csrc/cauchy.cu",
                   "diffwave_sashimi_tpu/ops/cauchy_pallas.py:91",
                   ("train", "train_bf16")),
    # kernel 9 replaces fftconv_pallas.py:78 (_kernel) and, as the same
    # function, :126 (_kernel_batched)
    "fftconv_long_ln_bias_gelu_d": (
        "diffwave_sashimi_torch/csrc/fftconv_long.cu",
        "diffwave_sashimi_tpu/ops/fftconv_pallas.py:78", ("vocode",)),
    # its TPU contract, the conv the training route takes past FFT size
    # 32768, and the same with conj(K), its input gradient
    "fftconv_long": ("diffwave_sashimi_torch/csrc/fftconv_long.cu",
                     "diffwave_sashimi_tpu/ops/fftconv_pallas.py:78",
                     ("vocoder_train_harder",)),
    # kernel 5L: fftconv2.py:707's function past kernel 5's FFT sizes
    "fftconv_dkf_long": ("diffwave_sashimi_torch/csrc/fftconv_long.cu",
                         "diffwave_sashimi_tpu/ops/fftconv2.py:707",
                         ("vocoder_train_harder",)),
    "gate_res_skip": ("diffwave_sashimi_torch/csrc/wavenet_gate.cu",
                      "diffwave_sashimi_tpu/ops/wavenet_gate.py:58",
                      ("wavenet",)),
    # the bf16 path's forms (fast=True) of kernels 1-3, and kernel 12, the
    # int8 branch of fftconv2.py:427 (qscale, _consts_q8 :293)
    "fftconv_ln_bias_gelu_d_bf16": ("diffwave_sashimi_torch/csrc/fftconv.cu",
                                    "diffwave_sashimi_tpu/ops/fftconv2.py:427",
                                    ("generate_bf16", "vocode_bf16")),
    "glu_res_bf16": ("diffwave_sashimi_torch/csrc/chmix.cu",
                     "diffwave_sashimi_tpu/ops/chmix.py:119",
                     ("generate_bf16", "generate_int8", "train_bf16",
                      "vocode_bf16")),
    "ln_ff_res_bf16": ("diffwave_sashimi_torch/csrc/chmix.cu",
                       "diffwave_sashimi_tpu/ops/chmix.py:182",
                       ("generate_bf16", "generate_int8", "train_bf16",
                        "vocode_bf16")),
    "fftconv_int8": ("diffwave_sashimi_torch/csrc/fftconv_int8.cu",
                     "diffwave_sashimi_tpu/ops/fftconv2.py:427",
                     ("generate_int8",)),
    # the bf16 training path's forms (fast=True) of kernels 1 (training
    # entry and conjugate form), 5, 6 and 7
    "fftconv_bf16": ("diffwave_sashimi_torch/csrc/fftconv.cu",
                     "diffwave_sashimi_tpu/ops/fftconv2.py:427",
                     ("train_bf16", "vocoder_train",
                      "vocoder_train_harder")),
    "fftconv_dkf_bf16": ("diffwave_sashimi_torch/csrc/fftconv.cu",
                         "diffwave_sashimi_tpu/ops/fftconv2.py:707",
                         ("train_bf16", "vocoder_train",
                          "vocoder_train_harder")),
    "glu_res_bwd_bf16": ("diffwave_sashimi_torch/csrc/chmix.cu",
                         "diffwave_sashimi_tpu/ops/chmix.py:414",
                         ("train_bf16", "vocoder_train",
                          "vocoder_train_harder")),
    "ln_ff_res_bwd_bf16": ("diffwave_sashimi_torch/csrc/chmix.cu",
                           "diffwave_sashimi_tpu/ops/chmix.py:362",
                           ("train_bf16", "vocoder_train",
                            "vocoder_train_harder")),
    # the bf16 sampling forms (fast=True) of kernels 9 and 11
    "fftconv_long_ln_bias_gelu_d_bf16": (
        "diffwave_sashimi_torch/csrc/fftconv_long.cu",
        "diffwave_sashimi_tpu/ops/fftconv_pallas.py:78", ("vocode_bf16",)),
    "gate_res_skip_bf16": ("diffwave_sashimi_torch/csrc/wavenet_gate.cu",
                           "diffwave_sashimi_tpu/ops/wavenet_gate.py:58",
                           ("wavenet_bf16",)),
}
PATHS = ("generate", "train", "vocode", "wavenet", "wavenet_train",
         "generate_bf16", "generate_int8", "train_bf16", "vocode_bf16",
         "wavenet_bf16", "d256_eps", "d256_eps_bf16", "d256_train",
         "d256_train_bf16", "vocoder_train", "vocoder_train_f32",
         "vocoder_train_harder", "wavenet_train_bf16")
# the tier of the JSON line's entry, where it is not H128 at the path's L
# (5L's at the bf16 path's dtype)
TOP_TIER = {"gate_res_skip": f"B{N_SAMPLES}_C256_S256_L16000",
            "gate_res_skip_bf16": f"B{N_SAMPLES}_C256_S256_L16000",
            "fftconv_long": "H128_L44000_bf16",
            "fftconv_dkf_long": "H128_L44000_bf16"}
# kernel 9's entries compute kernel 1's functions (at larger n), kernel
# 5L kernel 5's
SAME_FUNCTION = {"fftconv_long_ln_bias_gelu_d": "fftconv_ln_bias_gelu_d",
                 "fftconv_long": "fftconv",
                 "fftconv_dkf_long": "fftconv_dkf"}
# vocoding at T = 50: launches of each kernel of the path (24 blocks at
# n > 32768, 6 at n = 16384, 30 in all; kernel 4 once per block and run)
VOC_LAUNCHES = {"fftconv_long_ln_bias_gelu_d": 24 * 50,
                "fftconv_ln_bias_gelu_d": 6 * 50, "glu_res": 30 * 50,
                "ln_ff_res": 30 * 50, "cauchy": 30}
# the shipped vocoding command (phase 13b): the same at bf16 (9f, 1f, 2f,
# 3f; kernel 4 builds the spectra in f32 at any precision)
VOC_BF16_LAUNCHES = {"fftconv_long_ln_bias_gelu_d_bf16": 24 * 50,
                     "fftconv_ln_bias_gelu_d_bf16": 6 * 50,
                     "glu_res_bf16": 30 * 50, "ln_ff_res_bf16": 30 * 50,
                     "cauchy": 30}
# the port's kernels, by the name of their __global__ function
PORT_KERNELS = ("fftconv_kernel", "fftconv_r16_kernel",
                "fftconv_dkf_kernel", "fftconv_dkf_r16_kernel",
                "glu_res_tf32_kernel",
                "glu_res_tc_kernel", "glu_res_bwd_tf32_kernel",
                "glu_res_bwd_tc_kernel", "ln_ff_res_tf32_kernel",
                "ln_ff_res_tc_kernel", "round_weights_kernel",
                "ln_ff_res_bwd_tf32_kernel", "split_weights_tf32_kernel",
                "ln_ff_res_bwd_tc_kernel", "round_weights_t_kernel",
                "wgrad_kernel",
                "reduce_splits_kernel", "reduce_long_kernel",
                "cauchy_fwd_kernel", "cauchy_bwd_lanes_kernel",
                "cauchy_bwd_reduce_kernel",
                "cols_fwd_kernel",
                "rows_kernel", "cols_inv_kernel", "fftconv_cluster_kernel",
                "dkf_cols_kernel", "dkf_rows_kernel", "dkf_cluster_kernel",
                "gate_res_skip_tf32_kernel", "gate_res_skip_tc_kernel",
                "round_gate_weights_kernel", "fftconv_int8_kernel")
# kernel 9's two routes: 9f's cluster kernel (n 2^16 and 2^17, the
# vocoder's middle tier) and the three passes (every other n, and the f32
# forms at every n)
KERNEL_9_CLUSTER = "fftconv_cluster_kernel"
KERNEL_9_THREE_PASS = ("cols_fwd_kernel", "rows_kernel", "cols_inv_kernel")
# the three passes' instances in ptxas' report: the column passes <FUSED,
# T> of each entry, the row pass with N2 at compile time at N2 64 .. 512
# and at runtime (<0>; csrc rows_instance)
KERNEL_9_PASSES = (*(f"{k}<{fused}, {t}>"
                     for k in ("cols_fwd_kernel", "cols_inv_kernel")
                     for fused in ("true", "false") for t in ("float", "bf16")),
                   *(f"rows_kernel<{N2}>" for N2 in (0, 64, 128, 256, 512)))
KERNEL_9_GROUPS = {
    "kernel_9_cluster": lambda name: in_group(name, (KERNEL_9_CLUSTER,)),
    "kernel_9_three_pass": lambda name: in_group(name, KERNEL_9_THREE_PASS)}

# kernels 1's and 1f's two routes (ops.fftconv.conv_plan): the radix-16
# kernel and the Stockham kernel, each with instances of both activation
# types; traces report the sum of 1f's bf16 instances as 1f's time, of
# kernel 1's f32 instances as kernel 1's
def is_1f(name):
    return name.startswith(("fftconv_r16_kernel<", "fftconv_kernel<")) and (
        "bfloat16" in name)


def is_1(name):
    return name.startswith(("fftconv_r16_kernel<", "fftconv_kernel<")) and (
        "bfloat16" not in name)


KERNEL_1F_GROUPS = {"fftconv_1f": is_1f}
KERNEL_1_GROUPS = {"fftconv_1": is_1}
# kernel 12's instances <T, threads>; traces report their sum
KERNEL_12 = "fftconv_int8_kernel"
KERNEL_12_GROUPS = {"fftconv_int8": lambda name: in_group(name,
                                                          (KERNEL_12,))}

# kernels 5's and 5f's two routes (ops.fftconv.dkf_plan): the radix-16
# kernel and the Stockham kernel; traces report 5f's sum
def is_5f(name):
    return name.startswith("fftconv_dkf") and "bfloat16" in name


KERNEL_5F_GROUPS = {"fftconv_dkf_bf16": is_5f}

# kernels 2f's and 3f's wrappers launch two of them a call: the weights'
# rounding pass (an instance named for its kernel), then the tensor-core
# kernel; traces report their sum as 2f's and 3f's time
KERNELS_2F = ("glu_res_tc_kernel", "round_weights_kernel<2>")
KERNELS_3F = ("ln_ff_res_tc_kernel", "round_weights_kernel<3>")
# kernel 11's and 11f's: 11f's wrapper launches two a call, the stacked
# weight's rounding pass and the tensor-core kernel; traces report their sum
KERNELS_11F = ("gate_res_skip_tc_kernel", "round_gate_weights_kernel")
# kernels 2's, 3's and 11's (f32) wrappers launch two a call, in two parts
# that traces report apart: the weights' split (an instance named for its
# kernel) and the 3xTF32 kernel
KERNELS_2 = {"split": ("split_weights_tf32_kernel<2>",),
             "kernel": ("glu_res_tf32_kernel",)}
KERNELS_3 = {"split": ("split_weights_tf32_kernel<3>",),
             "kernel": ("ln_ff_res_tf32_kernel",)}
KERNELS_11 = {"split": ("split_weights_tf32_kernel<11>",),
              "kernel": ("gate_res_skip_tf32_kernel",)}
# kernel 7f's wrapper launches seven a call, in three parts that traces
# report apart: its pass (the weights' rounding and transposing pass, an
# instance named for its kernel, then the tensor-core pass), its two
# weight-gradient contractions (shared with kernels 6, 6f and 7), and the
# fixed-order sums of their split-K partials and of the pass's (dm, ds)
# partials; kernel 6f's four, in the same parts: its pass (its rounding
# instance, then the tensor-core pass), its contraction and that one's sum
KERNELS_7F = {"pass": ("ln_ff_res_bwd_tc_kernel",
                       "round_weights_t_kernel<7>"),
              "contractions": ("wgrad_kernel",),
              "reduce": ("reduce_splits_kernel", "reduce_long_kernel")}
KERNELS_6F = {"pass": ("glu_res_bwd_tc_kernel", "round_weights_t_kernel<6>"),
              "contractions": ("wgrad_kernel",),
              "reduce": ("reduce_splits_kernel",)}
# kernel 7's (f32) seven, in the same parts: its pass (the weights' split,
# then the 3xTF32 pass), its two contractions and the sums; kernel 6's
# four: its pass (the split of W's halves and W^T, then the 3xTF32 pass),
# its contraction and that one's sum; both contract on the fp32 FMAs
# (wgrad_kernel, 6f's and 7f's)
KERNELS_7 = {"pass": ("ln_ff_res_bwd_tf32_kernel",
                      "split_weights_tf32_kernel<7>"),
             "contractions": ("wgrad_kernel",),
             "reduce": ("reduce_splits_kernel", "reduce_long_kernel")}
KERNELS_6 = {"pass": ("glu_res_bwd_tf32_kernel",
                      "split_weights_tf32_kernel<6>"),
             "contractions": ("wgrad_kernel",),
             "reduce": ("reduce_splits_kernel",)}
# kernel 7's widths off the shipped ones: multiples of 8 but not of 16, so
# that the split weights' zero rows pad the last m-tile (B, H, F, L)
KERNEL_7_RAGGED = (2, 24, 40, 1001)
# kernel 8's wrapper launches its lanes kernel and, where the plan splits a
# channel's positions over blocks, the fixed-order sum of their partials;
# traces report their sum as kernel 8's time.
KERNELS_8 = ("cauchy_bwd_lanes_kernel", "cauchy_bwd_reduce_kernel")
KERNEL_8_GROUPS = {"cauchy_bwd": lambda name: in_group(name, KERNELS_8)}
# kernel 4's one kernel, and PyTorch's elementwise copies (its copy kernel
# and device-to-device memcpy), which the bf16 training trace reports
# beside it
KERNEL_4 = "cauchy_fwd_kernel"
KERNEL_4_GROUPS = {
    "cauchy": lambda name: in_group(name, (KERNEL_4,)),
    "copies": lambda name: ("direct_copy_kernel" in name
                            or name.startswith("Memcpy DtoD"))}


def log(msg):
    print(msg, flush=True)


# the sources whose instances phase 1 reads ptxas's report of
PTXAS_SOURCES = ("cauchy.cu", "fftconv.cu", "fftconv_long.cu", "chmix.cu",
                 "fftconv_int8.cu", "wavenet_gate.cu")
# kernel 7's instances (its 3xTF32 pass at each P it is built for, its
# weights' split)
KERNEL_7_TF32 = ("ln_ff_res_bwd_tf32_kernel", "split_weights_tf32_kernel<7>")
KERNEL_7_PS = (64, 32, 16, 8)
# the 3xTF32 kernels of kernels 2, 3, 6, 7 and 11 (f32) and the instances
# each is built for (<P, blocks an SM>; kernel 7's <P>); the weights'
# split of each, by the kernel that launches it
TF32_KERNELS = {"glu_res_tf32_kernel": ("64, 2", "32, 2", "32, 1", "16, 1",
                                        "8, 1"),
                "glu_res_bwd_tf32_kernel": ("64, 2", "64, 1", "32, 1",
                                            "16, 1", "8, 1"),
                "ln_ff_res_tf32_kernel": ("128, 1", "64, 2", "64, 1",
                                          "32, 1", "16, 1", "8, 1"),
                "ln_ff_res_bwd_tf32_kernel": tuple(map(str, KERNEL_7_PS)),
                "gate_res_skip_tf32_kernel": ("128, 1", "64, 2", "64, 1",
                                              "32, 3", "32, 1", "16, 1",
                                              "8, 1")}
TF32_SPLITS = tuple(f"split_weights_tf32_kernel<{k}>"
                    for k in (2, 3, 6, 7, 11))
# kernel 1's f32 instances of its radix-16 kernel, <M, FUSED, float> at
# each M = n/2 of ops.fftconv.RADIX16_SIZES
KERNEL_1_R16 = "fftconv_r16_kernel"
# their tensor-core products in the built code: sm_90's SASS of mma.sync
# with tf32 operands and f32 sums (HMMA.<shape>.F32.TF32)
TF32_MMA_SASS = r"HMMA\.\w+\.F32\.TF32"
# kernel 5L's instances: its two-pass route's pass A by input type and
# pass B, its cluster kernel <N1, N2, NT> at n 2^16 and 2^17 (N1 N2 the
# n/2-point transform, NT threads a block), by input type
KERNEL_5L_CLUSTER = "dkf_cluster_kernel"
KERNEL_5L = ("dkf_cols_kernel<float>", "dkf_cols_kernel<bf16>",
             "dkf_rows_kernel",
             *(f"{KERNEL_5L_CLUSTER}<{inst}, {t}>"
               for inst in ("128, 256, 512", "256, 256, 1024")
               for t in ("float", "bf16")))
# the kernels of kernel 9's training entry in its bf16 form, the three
# passes (their bf16 instances without the sampling prologue)
KERNEL_9_TRAIN_BF16 = tuple(f"{k}<false, __nv_bfloat16>"
                            for k in ("cols_fwd_kernel", "cols_inv_kernel"))


def kernel_parts(name, ptxas, tf32_sass=None):
    """The kernels line's parts of kernel ``name``: the global kernels it
    launches and the ptxas report (``ptxas_report``) of its instances,
    where the line lists them; for kernels 3, 6, 7 and 11 (f32) the count
    of TF32_MMA_SASS instructions in their 3xTF32 kernels
    (``tf32_mma_sass``)."""
    f32_parts = {"ln_ff_res_bwd": KERNELS_7, "glu_res_bwd": KERNELS_6,
                 "ln_ff_res": KERNELS_3, "gate_res_skip": KERNELS_11,
                 "glu_res": KERNELS_2}
    if name in f32_parts:
        parts = f32_parts[name]
        names = [k for group in parts.values() for k in group]
        return {"global_kernels": names,
                "ptxas": {k: v for k, v in ptxas.items()
                          if in_group(k, names)},
                "tf32_mma_sass": {k: v for k, v in (tf32_sass or {}).items()
                                  if in_group(k, names)}}
    if name == "cauchy_bwd":
        return {"global_kernels": list(KERNELS_8),
                "ptxas": {k: v for k, v in ptxas.items()
                          if k.startswith("cauchy_bwd")}}
    if name == "cauchy":
        return {"global_kernels": [KERNEL_4],
                "ptxas": {k: v for k, v in ptxas.items()
                          if k.startswith(KERNEL_4)}}
    if name == "fftconv_dkf_long":
        return {"global_kernels": [KERNEL_5L_CLUSTER, "dkf_cols_kernel",
                                   "dkf_rows_kernel"],
                "ptxas": {k: ptxas[k] for k in KERNEL_5L}}
    if name.startswith("fftconv_dkf"):
        return {"ptxas": {k: v for k, v in ptxas.items()
                          if k.startswith("fftconv_dkf")}}
    if name == "fftconv_long":
        return {"global_kernels": list(KERNEL_9_THREE_PASS)}
    if name == "fftconv_long_ln_bias_gelu_d":
        return {"global_kernels": list(KERNEL_9_THREE_PASS),
                "ptxas": {k: ptxas[k] for k in KERNEL_9_PASSES
                          if k in ptxas}}
    if name == "fftconv_int8":
        return {"ptxas": {k: v for k, v in ptxas.items()
                          if k.startswith(KERNEL_12)}}
    if name in ("fftconv_ln_bias_gelu_d", "fftconv"):
        return {"global_kernels": [KERNEL_1_R16, "fftconv_kernel"],
                "ptxas": {k: v for k, v in ptxas.items()
                          if k.startswith(KERNEL_1_R16)}}
    return {}


def start_ptxas():
    """Beside the build: ``nvcc -Xptxas -v`` of each of PTXAS_SOURCES (the
    library's flags), into the build directory; read by
    :func:`ptxas_report`."""
    from diffwave_sashimi_torch.ops import cuda_lib
    out = cuda_lib._BUILD / "ptxas"
    out.mkdir(parents=True, exist_ok=True)
    return [subprocess.Popen(
        [cuda_lib._nvcc(), *cuda_lib._FLAGS, "-Xptxas", "-v", "-c",
         str(cuda_lib._CSRC / src), "-o", str(out / (src + ".o"))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in PTXAS_SOURCES]


def ptxas_report(procs):
    """{__global__ instance: registers a thread, spill stores and loads in
    bytes} from ptxas's reports, of kernel 4 (``cauchy_fwd_kernel<K>``),
    of kernel 8 (``name<K, PAIRED>``), of kernels 5 and 5f's radix-16
    route (``fftconv_dkf_r16_kernel<M, Q, T>``), of kernel 1's radix-16
    route (``fftconv_r16_kernel<M, FUSED, float>``), of kernel 5L's two
    passes and cluster kernel (KERNEL_5L), of kernel 9's three passes
    (KERNEL_9_PASSES), of the 3xTF32 kernels of kernels 2, 3, 6, 7 and 11 at
    each P (TF32_KERNELS) and their weights' splits (TF32_SPLITS) and of
    kernel 12 (``fftconv_int8_kernel<T, threads>``); raise if nvcc
    failed, an instance spills or one of kernels 4's and 8's K 1-8, of the
    routes' M (n 2048 .. 32768, each with its transforms a block Q, or
    both forms) and T (float, bf16), of 5L's, of 9's three passes, of the
    3xTF32 kernels' or of kernel 12's T and threads (ops.int8conv.THREADS)
    is missing."""
    fc = importlib.import_module("diffwave_sashimi_torch.ops.fftconv")
    from diffwave_sashimi_torch.ops import int8conv
    out = {}
    for src, proc in zip(PTXAS_SOURCES, procs):
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v of {src} failed:\n{text}")
        lines = text.splitlines()
        for i, line in enumerate(lines):
            k8 = re.search(r"Compiling entry function '\w*?(cauchy_bwd\w*?"
                           r"_kernel)(?:ILi(\d+)ELb([01])E)?", line)
            k4 = re.search(r"Compiling entry function '\w*?(cauchy_fwd_"
                           r"kernel)ILi(\d+)E", line)
            dkf = re.search(r"Compiling entry function '\w*?(fftconv_dkf_r16_"
                            r"kernel)ILi(\d+)ELi(\d+)E(f|13__nv_bfloat16)E",
                            line)
            k5l = re.search(r"Compiling entry function '\w*?\d(dkf_(?:cols|"
                            r"rows)_kernel)(?:I(f|13__nv_bfloat16)E)?", line)
            k5c = re.search(r"Compiling entry function '\w*?(dkf_cluster_"
                            r"kernel)ILi(\d+)ELi(\d+)ELi(\d+)E(f|13__nv_"
                            r"bfloat16)E", line)
            k7 = re.search(r"Compiling entry function '\w*?\d("
                           + "|".join((*TF32_KERNELS,
                                       "split_weights_tf32_kernel"))
                           + r")(?:I((?:Li\d+E)+)E)?", line)
            k12 = re.search(r"Compiling entry function '\w*?\d(fftconv_int8_"
                            r"kernel)I(f|13__nv_bfloat16)Li(\d+)E", line)
            k1 = re.search(r"Compiling entry function '\w*?\d(fftconv_r16_"
                           r"kernel)ILi(\d+)ELb([01])EfE", line)
            k9 = re.search(r"Compiling entry function '\w*?\d(cols_(?:fwd|inv)"
                           r"_kernel)ILb([01])E(f|13__nv_bfloat16)E|Compiling "
                           r"entry function '\w*?\d(rows_kernel)ILi(\d+)EE",
                           line)
            if k9:
                name = (f"{k9.group(1)}<"
                        f"{'true' if k9.group(2) == '1' else 'false'}, "
                        f"{'float' if k9.group(3) == 'f' else 'bf16'}>"
                        if k9.group(1) else f"rows_kernel<{k9.group(5)}>")
            elif k1:
                name = (f"{k1.group(1)}<{k1.group(2)}, "
                        f"{'true' if k1.group(3) == '1' else 'false'}, "
                        f"float>")
            elif k12:
                name = (f"{k12.group(1)}<"
                        f"{'float' if k12.group(2) == 'f' else 'bf16'}, "
                        f"{k12.group(3)}>")
            elif k7:
                name = tf32_instance(k7)
            elif k8:
                name = k8.group(1) + (
                    f"<{k8.group(2)}, "
                    f"{'true' if k8.group(3) == '1' else 'false'}>"
                    if k8.group(2) else "")
            elif k4:
                name = f"{k4.group(1)}<{k4.group(2)}>"
            elif dkf:
                name = (f"{dkf.group(1)}<{dkf.group(2)}, {dkf.group(3)}, "
                        f"{'float' if dkf.group(4) == 'f' else 'bf16'}>")
            elif k5c:
                name = (f"{k5c.group(1)}<{k5c.group(2)}, {k5c.group(3)}, "
                        f"{k5c.group(4)}, "
                        f"{'float' if k5c.group(5) == 'f' else 'bf16'}>")
            elif k5l:
                name = k5l.group(1) + (
                    "" if k5l.group(2) is None else
                    f"<{'float' if k5l.group(2) == 'f' else 'bf16'}>")
            else:
                continue
            props = " ".join(lines[i + 1:i + 5])
            regs = re.search(r"Used (\d+) registers", props)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", props)
            out[name] = {
                "registers": int(regs.group(1)) if regs else None,
                "spill_stores": int(spill.group(1)) if spill else None,
                "spill_loads": int(spill.group(2)) if spill else None}
    want = {f"{k}<{P}>" for k, ps in TF32_KERNELS.items() for P in ps} | {
        *TF32_SPLITS} | {
        f"{KERNEL_1_R16}<{n // 2}, {f}, float>" for n in fc.RADIX16_SIZES
        for f in ("true", "false")} | {
        f"cauchy_bwd_lanes_kernel<{K}, {p}>" for K in range(1, 9)
        for p in ("true", "false")} | {
        f"cauchy_fwd_kernel<{K}>" for K in range(1, 9)} | {
        f"fftconv_dkf_r16_kernel<{n // 2}, {q}, {t}>"
        for n, q in fc.DKF_PER_BLOCK.items() for t in ("float", "bf16")} | {
        *KERNEL_5L} | {*KERNEL_9_PASSES} | {
        f"{KERNEL_12}<{t}, {nt}>" for t in ("float", "bf16")
        for nt in int8conv.THREADS}
    spills = [k for k, v in out.items()
              if v["spill_stores"] != 0 or v["spill_loads"] != 0]
    if want - out.keys() or spills:
        raise RuntimeError(f"ptxas: instances missing "
                           f"{sorted(want - out.keys())}, spilling or "
                           f"unread {spills}:\n{out}")
    return out


def tf32_instance(match):
    """``name<args>`` of a 3xTF32 kernel or split instance from its mangled
    name's match (group 1 the name, group 2 its int template arguments)."""
    if match.group(2) is None:
        return match.group(1)
    args = re.findall(r"Li(\d+)E", match.group(2))
    return f"{match.group(1)}<{', '.join(args)}>"


def tf32_mma_sass():
    """{3xTF32 kernel instance (TF32_KERNELS at each P, TF32_SPLITS): its
    count of TF32_MMA_SASS instructions} in ``cuobjdump -sass`` of phase
    1's chmix.cu and wavenet_gate.cu objects (ptxas_report's build); raise
    unless each instance of kernels 3's, 7's and 11's 3xTF32 kernels
    multiplies on the tensor cores."""
    from diffwave_sashimi_torch.ops import cuda_lib
    counts, name = {}, None
    for src in ("chmix.cu", "wavenet_gate.cu"):
        obj = cuda_lib._BUILD / "ptxas" / (src + ".o")
        text = subprocess.run(
            [os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump"),
             "-sass", str(obj)], capture_output=True, text=True,
            check=True).stdout
        for line in text.splitlines():
            fn = re.search(r"Function : \w*?\d("
                           + "|".join((*TF32_KERNELS,
                                       "split_weights_tf32_kernel"))
                           + r")(?:I((?:Li\d+E)+)E)?", line)
            if "Function : " in line:
                name = None if fn is None else tf32_instance(fn)
                if name is not None:
                    counts[name] = 0
            elif name is not None and re.search(TF32_MMA_SASS, line):
                counts[name] += 1
    want = [f"{k}<{P}>" for k, ps in TF32_KERNELS.items() for P in ps]
    if any(counts.get(k, 0) == 0 for k in want):
        raise RuntimeError(f"the 3xTF32 kernels' {TF32_MMA_SASS} "
                           f"instructions: {counts}")
    return counts


def cuda_ms(fn, reps):
    """Mean ms per call of fn() by CUDA events, after 3 warm-up calls."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def paired_ms(kernel_fn, plain_fn, reps):
    """Times in turns (plain, kernel, kernel, plain); mean of each pair."""
    p1 = cuda_ms(plain_fn, reps)
    k1 = cuda_ms(kernel_fn, reps)
    k2 = cuda_ms(kernel_fn, reps)
    p2 = cuda_ms(plain_fn, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def max_err(out, ref):
    """(max |out - ref|, max |ref|), in f32 (complex values as they are)."""
    if not out.is_complex():
        out, ref = out.float(), ref.float()
    return float((out - ref).abs().max()), float(ref.abs().max())


def work(name, B, H, L, n, K=6, N=32, S=None, bpe=4, F=None):
    """({operand type: operations}, bytes) of one call at these shapes:
    each input read once and each output written once; a real FFT of
    length n counted as 2.5 n log2 n fp32 operations.  For kernel 11, H is
    C and S the skip width (C by default); F is the FF hidden width (2H by
    default).  The _bf16 forms move bf16
    activations and multiply bf16 operands where JAX's fast=True kernels
    do (the forwards' products; the backward passes' per-position products,
    its _bmm, while their weight gradients, its _bmmc, stay fp32); kernel
    12 moves activations of bpe bytes and multiplies int8 ones (its
    four-step layout's products).  Kernels 2, 3, 6, 7 and 11 (f32) take their
    per-position products in 3xTF32: three TF32 products each."""
    base = name.removesuffix("_bf16")
    if base != name:
        bpe = 2
    gemm = "fp32" if base == name else "bf16"
    F, Lz = F or 2 * H, L // 2 + 1
    S = H if S is None else S
    fft = 2.5 * n * math.log2(n)
    act = B * H * L * bpe                # one (B, H, L) activation tensor
    spec = H * (n // 2 + 1) * 8          # one (H, n/2+1) spectrum
    glu_w, ff_w = (2 * H * H + 2 * H) * 4, (2 * F * H + F + H + 2) * 4
    coef = (2 * K * H * N + 2 * H * N) * 4
    cauchy_io = Lz * 8 + K * H * Lz * 8
    conv_io = 2 * act + spec + 2 * B * L * 4 + B * H * 4 + H * 4
    if base == "fftconv_int8":
        from diffwave_sashimi_torch.ops.int8conv import int8_layout
        R, Sq, Rc = int8_layout(n, L)
        return ({"int8": 8 * Sq * R * (Rc + Sq) * B * H,
                 "fp32": 14 * B * H * L}, conv_io + H * L * 4)   # + W
    ops, nbytes = {
        "fftconv_ln_bias_gelu_d": (B * H * (2 * fft + 3 * n) + 12 * B * H * L,
                                   conv_io),
        "fftconv": (B * H * (2 * fft + 3 * n), 2 * act + spec),
        "fftconv_dkf": (B * H * (2 * fft + 4 * n), 2 * act + spec),
        "glu_res": (4 * H * H * B * L, 3 * act + glu_w),
        "glu_res_bwd": (12 * H * H * B * L, 3 * act + 2 * glu_w),
        "ln_ff_res": (4 * F * H * B * L, 3 * act + 2 * B * L * 4 + ff_w),
        "ln_ff_res_bwd": (10 * F * H * B * L, 3 * act + 2 * ff_w),
        # the fewer flops of the two forms: (a z + b) G0 for each k, or
        # G1 = z G0 once and a G1 + b G0 for each k (csrc/cauchy.cu)
        "cauchy": (min(13 + 11 * K, 19 + 8 * K) * H * N * Lz,
                   coef + cauchy_io),
        "cauchy_bwd": ((30 + 16 * K) * H * N * Lz, 2 * coef + cauchy_io),
        "gate_res_skip": (2 * B * L * H * (H + S),
                          (4 * H + S) * B * L * bpe
                          + (H * H + H + S * H + S) * 4),
    }[SAME_FUNCTION.get(base, base)]
    # operations of the per-position products, of the weight gradients
    split = {"glu_res": (ops, 0), "ln_ff_res": (ops, 0),
             "gate_res_skip": (ops, 0),
             "glu_res_bwd": (8 * H * H * B * L, 4 * H * H * B * L),
             "ln_ff_res_bwd": (6 * F * H * B * L, 4 * F * H * B * L)}
    if base not in split:
        return {"fp32": ops}, nbytes
    prod, wgrad = split[base]
    if name in ("ln_ff_res_bwd", "ln_ff_res", "gate_res_skip", "glu_res",
                "glu_res_bwd"):
        by_type = {"fp32": wgrad, "tf32": 3 * prod}
    else:
        by_type = {"fp32": wgrad}
        by_type[gemm] = by_type.get(gemm, 0) + prod
    return {t: v for t, v in by_type.items() if v}, nbytes


def bound(name, B, H, L, n, S=None, bpe=4, F=None):
    """(bound_ms, bound_by): the least time of one call on the card: the
    larger of its bytes over the HBM rate and its operations over the peak
    rate of their type (summed over the types)."""
    ops, nbytes = work(name, B, H, L, n, S=S, bpe=bpe, F=F)
    t_ops = sum(v / PEAK_OPS[t] for t, v in ops.items())
    t_bytes = nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def compare(name, H, L, kfn, pfn, reps, results, B=N_SAMPLES, n=None,
            S=None, tier=None, tol=TOL_KERNEL, bpe=4, F=None):
    """Hold one kernel wrapper against its plain version at tier (H, L)
    (each output of a tuple against its own bound, tol x max(1, its
    max|plain|)), time both, record with the bound at batch B, FFT size n
    (by default the SC09 paths': the next power of two >= 2L), skip width
    S (kernel 11), FF hidden width F (2H by default) and bpe bytes an
    activation; raise on a miss."""
    import torch
    tier = tier or f"H{H}_L{L}"
    out, ref = kfn(), pfn()
    torch.cuda.synchronize()
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    errs = [max_err(o, r) for o, r in zip(outs, refs)]
    ok = all(e <= tol * max(1.0, sc) for e, sc in errs) and all(
        bool(torch.isfinite(o).all()) for o in outs)
    err = max(e for e, _ in errs)
    scale = max(sc for _, sc in errs)
    ms, plain_ms = paired_ms(kfn, pfn, reps)
    log(f"kernel {name} {tier}: max_abs_err {err:.3e} (per output "
        f"{', '.join(f'{e:.2e}/{sc:.2e}' for e, sc in errs)} of max|plain|) "
        f"bound {tol} x max(1, max|plain|) {'ok' if ok else 'FAIL'}; "
        f"{ms:.4f} ms vs plain {plain_ms:.4f} ms")
    r = results.setdefault(name, {"max_abs_err": 0.0, "tiers": {}})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["tiers"].setdefault(tier, {"max_abs_err": 0.0, "max_abs_plain": 0.0})
    t = r["tiers"][tier]
    t.update(max_abs_err=max(t["max_abs_err"], err),
             max_abs_plain=max(t["max_abs_plain"], scale))
    t.setdefault("ms", ms)
    t.setdefault("plain_ms", plain_ms)
    t["bound_ms"], t["bound_by"] = bound(
        name, B, H, L, n or 1 << (2 * L - 1).bit_length(), S, bpe, F)
    if not ok:
        raise AssertionError(f"kernel {name} disagrees at {tier}")


def build_model(torch, cfg=MODEL_CFG):
    from diffwave_sashimi_torch.models import construct_model
    gen = torch.Generator().manual_seed(SEED)
    model = construct_model(cfg, "f32", generator=gen)
    fc2 = model.final_conv[2].conv
    with torch.no_grad():     # zero-init head: perturb, or eps is all 0
        fc2.weight.copy_(0.1 * torch.randn(fc2.weight.shape, generator=gen))
        fc2.bias.copy_(0.1 * torch.randn(fc2.bias.shape, generator=gen))
    return model


def tier_blocks(model):
    """(H, L, block) for the first block of each UNet tier."""
    from diffwave_sashimi_torch.models.sashimi import DiffWaveBlock
    seen, out = set(), []
    for blk in model.modules():
        if isinstance(blk, DiffWaveBlock):
            H = blk.layer.D.shape[1]
            if H not in seen:
                seen.add(H)
                out.append((H, blk.layer.l_max, blk))
    return sorted(out, key=lambda t: t[0])


def conv_inputs(torch, blk, L, B, gen, dev):
    """A block's conv inputs at length L and batch B: x, norm1 as a, c, the
    step bias, D and the conv-kernel spectrum (capped at the trained
    length, at the power-of-two n >= L_k + L)."""
    from diffwave_sashimi_torch import ops
    layer = blk.layer
    H = layer.D.shape[1]
    khat = layer.compute_kernel_freq(L, ops.PLAIN)
    x = torch.randn(B, H, L, device=dev, generator=gen)
    var, mean = torch.var_mean(x, dim=1, unbiased=False)
    a = blk.norm1.s * torch.rsqrt(var)
    return dict(x=x, a=a, c=(blk.norm1.m - mean) * a, khat=khat,
                n=2 * (khat.shape[-1] - 1), D=layer.D[0],
                bias=blk.fc_t(torch.randn(B, 512, device=dev, generator=gen)))


def tier_inputs(torch, blk, L, gen, dev):
    """Inputs of one tier's kernels at the main paths' shapes (batch
    N_SAMPLES), from the tier's first block."""
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.models.s4 import _fft_nodes
    B, layer = N_SAMPLES, blk.layer
    H = layer.D.shape[1]
    d = conv_inputs(torch, blk, L, B, gen, dev)
    ff1, ff2 = blk.ff["ff"][0], blk.ff["ff"][2]
    v, wt, _ = layer.kernel["kernel"].cauchy_operands()
    z = torch.from_numpy(_fft_nodes(L)[1]).to(dev)
    quad = ops.cauchy.quad_operands(v, wt)
    d.update(lin=layer.output_linear[0], m2=blk.norm2.m, s2=blk.norm2.s,
             w1=ff1.effective_weight()[:, :, 0], b1=ff1.bias,
             w2=ff2.effective_weight()[:, :, 0], b2=ff2.bias,
             skip=torch.randn(B, H, L, device=dev, generator=gen),
             g=torch.randn(B, H, L, device=dev, generator=gen),
             v=v, wt=wt, z=z, quad=quad,
             g_re=torch.randn(*quad[0].shape[:2], z.shape[0], device=dev,
                              generator=gen),
             g_im=torch.randn(*quad[0].shape[:2], z.shape[0], device=dev,
                              generator=gen))
    d["y"] = ops.fftconv_ln_bias_gelu_d_ref(d["x"], d["a"], d["c"],
                                            d["bias"], d["khat"], d["D"])
    return d


def check_kernels(torch, model, dev, results):
    """Phase 3 (+ kernel timings): the sampling kernels vs their plain
    versions at the sampling path's shapes of every tier; kernels 1, 2, 4
    and 3 beyond that by ``hold_1_routes``, ``hold_glu``, ``hold_kernel_4``
    and ``hold_ff``."""
    from diffwave_sashimi_torch import ops
    fc = importlib.import_module("diffwave_sashimi_torch.ops.fftconv")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for H, L, blk in tier_blocks(model):
        d = tier_inputs(torch, blk, L, gen, dev)
        x, lin = d["x"], d["lin"]
        cases = {
            "fftconv_ln_bias_gelu_d": (
                lambda: ops.fftconv_ln_bias_gelu_d(x, d["a"], d["c"],
                                                   d["bias"], d["khat"],
                                                   d["D"]),
                lambda: ops.fftconv_ln_bias_gelu_d_ref(x, d["a"], d["c"],
                                                       d["bias"], d["khat"],
                                                       d["D"])),
            "glu_res": (
                lambda: ops.mix_glu_res(d["y"], x, lin.weight, lin.bias),
                lambda: ops.glu_res_ref(d["y"], x, lin.weight, lin.bias)),
            "ln_ff_res": (
                lambda: ops.ln_ff_res(x, d["m2"], d["s2"], d["w1"], d["b1"],
                                      d["w2"], d["b2"], d["skip"], True),
                lambda: ops.ln_ff_res_ref(x, d["m2"], d["s2"], d["w1"],
                                          d["b1"], d["w2"], d["b2"],
                                          d["skip"], True)),
            "cauchy": (
                lambda: ops.cauchy_quad(*d["quad"], d["z"]).unbind(-1),
                lambda: ops.cauchy_quad_ref(*d["quad"], d["z"])),
        }
        for name, (kfn, pfn) in cases.items():
            compare(name, H, L, kfn, pfn, 3 if name == "cauchy" else 20,
                    results)
        conv = (d["a"], d["c"], d["bias"], d["khat"], d["D"])
        hold_1_routes(torch, "fftconv_ln_bias_gelu_d", f"H{H}_L{L}", d["n"],
                      lambda p: fc.launch_sampling(x, *conv, p),
                      ops.fftconv_ln_bias_gelu_d_ref(x, *conv),
                      direct_conv_f64(torch, x, *conv, fast=False),
                      cufft_conv_ms(torch, x, d["khat"], L), results)
        hold_glu(torch, (d["y"], x, lin.weight, lin.bias), f"H{H}_L{L}",
                 results)
        hold_kernel_4(torch, d, f"H{H}_L{L}", results)
        hold_ff(torch, (x, d["m2"], d["s2"], d["w1"], d["b1"], d["w2"],
                        d["b2"], d["skip"]), f"H{H}_L{L}", results)


def direct_conv_f64(torch, x, a, c, bias, khat, D, fast):
    """Kernel 1's sampling function in f64 on the card: the prologue, the
    conv by an f64 FFT of the f64 spectrum, the D-skip and the GELU (the
    polynomial one for the bf16 form)."""
    from diffwave_sashimi_torch import ops
    L, n = x.shape[-1], 2 * (khat.shape[-1] - 1)
    xn = (x.double() * a.double()[:, None] + c.double()[:, None]
          + bias.double()[:, :, None])
    y = torch.fft.irfft(torch.fft.rfft(xn, n=n) * khat.to(torch.complex128),
                        n=n)[..., :L] + D.double()[:, None] * xn
    return ops.gelu_fast(y) if fast else torch.nn.functional.gelu(y)


def time_ff_weight_designs(torch, ff, result, tier):
    """Kernel 3f's two designs for its f32 weights, held equal and timed
    in turns at one tier: the shipped one (the wrapper: a pass rounds them
    to bf16 into a scratch, which every block then reads) and the other
    (the same entry with a null scratch: every block reads the f32 weights
    and rounds them as they load, with no extra launch).  Both round the
    same values and sum in the same order, so their outputs are equal
    bit for bit.  Recorded as ``weights_scratch_ms`` and
    ``weights_in_kernel_ms``; the port calls only the first."""
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.ops import chmix, cuda_lib
    x, m, s, w1, b1, w2, b2, skip, _ = ff
    B, H, L = x.shape
    F = w1.shape[0]
    P, smem = chmix.ff_bf16_plan(B, H, F, L, cuda_lib.sm_count(x.device))

    def in_kernel():
        out = torch.empty_like(x)
        mean = x.new_empty((B, L), dtype=torch.float32)
        var = torch.empty_like(mean)
        cuda_lib.launch("dwst_ln_ff_res_bf16",
                        *chmix._ptrs(x, skip, w1, b1, w2, b2, m, s, out,
                                     mean, var, None), B, H, F, L, P, smem)
        return out, mean, var

    shipped = lambda: ops.ln_ff_res_bf16(*ff)    # noqa: E731
    if not all(torch.equal(a, b) for a, b in zip(in_kernel(), shipped())):
        raise AssertionError(f"kernel 3f's weight designs differ at {tier}")
    t_in, t_scratch = paired_ms(in_kernel, shipped, 10)
    result["tiers"][tier].update(weights_scratch_ms=t_scratch,
                                 weights_in_kernel_ms=t_in)
    log(f"kernel ln_ff_res_bf16 {tier}: weights rounded by a pass into a "
        f"scratch {t_scratch:.4f} ms, rounded as they load {t_in:.4f} ms "
        f"(equal outputs)")


def check_bf16_kernels(torch, model, dev, results):
    """The bf16 forms of kernels 1-3 (1f, 2f, 3f) and kernel 12 with both
    epilogues vs their plain versions at the sampling path's shapes of
    every tier (B4, bf16 activations), timed; 1f on both its routes
    (``hold_1f_routes``); kernel 12 also vs an f64 direct conv of the same
    inputs."""
    from diffwave_sashimi_torch import ops
    fc = importlib.import_module("diffwave_sashimi_torch.ops.fftconv")
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    bf = torch.bfloat16
    f64 = {}
    for H, L, blk in tier_blocks(model):
        d = tier_inputs(torch, blk, L, gen, dev)
        x, skip, lin = d["x"].to(bf), d["skip"].to(bf), d["lin"]
        conv = (d["a"], d["c"], d["bias"], d["khat"], d["D"])
        W = ops.int8_spectrum(d["khat"], L)[1]       # the main path's form
        y = ops.fftconv_ln_bias_gelu_d_ref(x, *conv)
        ff = (x, d["m2"], d["s2"], d["w1"], d["b1"], d["w2"], d["b2"], skip,
              True)
        cases = [
            ("fftconv_ln_bias_gelu_d_bf16",
             lambda: ops.fftconv_ln_bias_gelu_d_bf16(x, *conv),
             lambda: ops.fftconv_ln_bias_gelu_d_ref(x, *conv), TOL_BF16,
             None, 2),
            ("glu_res_bf16",
             lambda: ops.mix_glu_res_bf16(y, x, lin.weight, lin.bias),
             lambda: ops.glu_res_ref(y, x, lin.weight, lin.bias), TOL_BF16,
             None, 2),
            ("ln_ff_res_bf16", lambda: ops.ln_ff_res_bf16(*ff),
             lambda: ops.ln_ff_res_ref(*ff), TOL_BF16, None, 2),
            ("fftconv_int8", lambda: ops.fftconv_int8(x, *conv, W),
             lambda: ops.fftconv_int8_ref(x, *conv, W), TOL_INT8, None, 2),
            ("fftconv_int8", lambda: ops.fftconv_int8(d["x"], *conv, W),
             lambda: ops.fftconv_int8_ref(d["x"], *conv, W), TOL_INT8,
             f"H{H}_L{L}_f32", 4),
        ]
        for name, kfn, pfn, tol, tier, bpe in cases:
            compare(name, H, L, kfn, pfn, 10, results, tol=tol, tier=tier,
                    bpe=bpe)
        hold_kernel_12(torch, blk, L, d, W, gen, dev,
                       results["fftconv_int8"]["tiers"][f"H{H}_L{L}"])
        hold_1f_routes(torch, "fftconv_ln_bias_gelu_d_bf16", f"H{H}_L{L}",
                       d["n"], lambda p: fc.launch_sampling(x, *conv, p),
                       ops.fftconv_ln_bias_gelu_d_ref(x, *conv),
                       cufft_conv_ms(torch, d["x"], d["khat"], L), results)
        gemm_ms(torch, "glu_res_bf16", results, f"H{H}_L{L}", lin.weight, y)
        time_ff_weight_designs(torch, ff, results["ln_ff_res_bf16"],
                               f"H{H}_L{L}")
        # F = H (a config's model.ff 1), off the shipped F = 2H: the GEMM 2
        # output tile is then larger than the GELU tile it reuses
        ffh = ff[:3] + (d["w1"][:H].contiguous(), d["b1"][:H],
                        d["w2"][:, :H].contiguous()) + ff[6:]
        compare("ln_ff_res_bf16", H, L, lambda: ops.ln_ff_res_bf16(*ffh),
                lambda: ops.ln_ff_res_ref(*ffh), 10, results, tol=TOL_BF16,
                tier=f"H{H}_L{L}_F{H}", bpe=2, F=H)
        # 3f's two channel products alone, as two bf16 torch.matmul calls
        # (cuBLAS on the tensor cores): a yardstick of the tensor-core part
        # only (no LN, GELU, residual or statistics), never called by the
        # port
        w1b, w2b = d["w1"].to(bf), d["w2"].to(bf)
        pair_ms = cuda_ms(lambda: torch.matmul(w2b, torch.matmul(w1b, x)), 10)
        results["ln_ff_res_bf16"]["tiers"][f"H{H}_L{L}"]["gemm_pair_ms"] = (
            pair_ms)
        log(f"yardstick ln_ff_res_bf16 H{H}_L{L}: two bf16 torch.matmul "
            f"{pair_ms:.4f} ms")
        # vs f64, with the step bias (each row offset by a constant) and
        # without; and the JAX algorithm (no mean split, W None) on the
        # offset rows, recorded: the offset's window spectrum then sets
        # every stage's per-tensor scale
        a_, c_, bias, khat, D = conv
        for form, xin in (("bf16", x), ("f32", d["x"])):
            for case, b_, w_ in (("", bias, W),
                                 ("_no_step_bias", torch.zeros_like(bias), W),
                                 ("_no_mean_split", bias, None)):
                cv = (a_, c_, b_, khat, D)
                out = ops.fftconv_int8(xin, *cv, w_).double()
                ref = direct_conv_f64(torch, xin, *cv, fast=form == "bf16")
                rel = float((out - ref).abs().max() / ref.abs().max())
                key = f"H{H}_L{L}_{form}{case}"
                f64[key] = rel
                ok = w_ is None or rel <= TOL_INT8_F64
                log(f"kernel fftconv_int8 {key}: vs an f64 direct conv "
                    f"max_abs_err / max|ref| {rel:.3e} ("
                    + ("recorded" if w_ is None else
                       f"bound {TOL_INT8_F64} {'ok' if ok else 'FAIL'}")
                    + ")")
                if not ok:
                    raise AssertionError(f"kernel 12 vs f64 at {key}")
    results["fftconv_int8"]["vs_f64_max_rel"] = f64
    hold_kernel_12_split(torch, dev, gen, results)
    # 2f at H 1024 (d_model 256's deepest tier: L 1000, B4), with seeded
    # weights of scale 1 / sqrt(H)
    H, L = 1024, 1000
    y, x = (torch.randn(N_SAMPLES, H, L, device=dev, generator=gen).to(bf)
            for _ in range(2))
    w = torch.randn(2 * H, H, device=dev, generator=gen) / math.sqrt(H)
    b = 0.1 * torch.randn(2 * H, device=dev, generator=gen)
    compare("glu_res_bf16", H, L, lambda: ops.mix_glu_res_bf16(y, x, w, b),
            lambda: ops.glu_res_ref(y, x, w, b), 10, results, tol=TOL_BF16,
            bpe=2)
    gemm_ms(torch, "glu_res_bf16", results, f"H{H}_L{L}", w, y)
    # 2f's element-wise path (its 16-byte one needs L % 8 == 0 and aligned
    # tensors): L 1001 at H 128 (P 128) and H 256 (P 64, so the last block
    # is ragged too), and y and res one element past a 16-byte boundary
    for B, H, L, off in ((2, 128, 1001, 0), (2, 256, 1001, 0),
                         (2, 128, 1000, 1)):
        y, x = (torch.randn(B * H * L + off, device=dev, generator=gen)
                .to(bf)[off:].view(B, H, L) for _ in range(2))
        w = torch.randn(2 * H, H, device=dev, generator=gen) / math.sqrt(H)
        b = 0.1 * torch.randn(2 * H, device=dev, generator=gen)
        compare("glu_res_bf16", H, L,
                lambda: ops.mix_glu_res_bf16(y, x, w, b),
                lambda: ops.glu_res_ref(y, x, w, b), 3, results, B=B,
                tol=TOL_BF16, bpe=2,
                tier=f"B{B}_H{H}_L{L}" + (f"_offset{off}" if off else ""))


def hold_kernel_12(torch, blk, L, d, W, gen, dev, result):
    """Kernel 12 at one tier beyond its bar, at B4 (phase 6b's inputs ``d``,
    rows offset by the step bias, the mean split by ``W``) and B16, on
    bf16 and f32 activations: two calls bit-equal; its time a call in a
    CUDA graph; beside it a cuFFT conv of the same shapes (f32,
    ``cufft_conv_ms``) and, in a graph, kernel 1f's sampling form on the
    bf16 activations: yardsticks the int8 path never calls.
    Recorded in ``result["graphs"]`` by batch and form, and the B4 bf16
    time as ``graph_ms``."""
    from diffwave_sashimi_torch import ops
    graphs = result.setdefault("graphs", {})
    for B in (N_SAMPLES, 16):
        e = d if B == N_SAMPLES else conv_inputs(torch, blk, L, B, gen, dev)
        conv = (e["a"], e["c"], e["bias"], e["khat"], e["D"])
        n = e["n"]
        for form, x in (("bf16", e["x"].to(torch.bfloat16)),
                        ("f32", e["x"])):
            def run():
                return ops.fftconv_int8(x, *conv, W)
            one, two = run(), run()
            torch.cuda.synchronize()
            if not torch.equal(one, two):
                raise AssertionError(f"kernel 12 at H{x.shape[1]} L{L} B{B} "
                                     f"{form}: two calls differ")
            r = {"graph_ms": graph_ms(torch, run)}
            r["cufft_conv_ms"] = cufft_conv_ms(torch, e["x"], e["khat"], L)
            if form == "bf16":
                r["fftconv_1f_graph_ms"] = graph_ms(
                    torch, lambda: ops.fftconv_ln_bias_gelu_d_bf16(x, *conv))
            graphs[f"B{B}_{form}"] = r
            log(f"kernel fftconv_int8 H{x.shape[1]}_L{L} B{B} {form}: two "
                f"calls bit-equal; {r['graph_ms']:.4f} ms in a CUDA graph; "
                f"yardsticks: cuFFT conv "
                f"{r['cufft_conv_ms']:.4f} ms"
                + (f", kernel 1f {r['fftconv_1f_graph_ms']:.4f} ms"
                   if form == "bf16" else ""))
    result["graph_ms"] = graphs[f"B{N_SAMPLES}_bf16"]["graph_ms"]


def hold_kernel_12_split(torch, dev, gen, results):
    """Kernel 12 off SC09's layouts, at B2 H8 L20000 n 32768 (Rc 256, so
    ``int8_plan`` stages Dr in panels over kr and Er a chunk at a time,
    and x passes the words a thread holds in registers), both forms,
    against its plain version at TOL_INT8 (seeded inputs, rows offset by
    a step bias, the mean split)."""
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.ops import int8conv
    B, H, L, n = 2, 8, 20000, 32768
    plan = int8conv.int8_plan(n, L)
    if plan.panels == 1 or not plan.er_chunked:
        raise AssertionError(f"kernel 12's split layout is not split: {plan}")
    x = torch.randn(B, H, L, device=dev, generator=gen)
    a = 0.5 + torch.rand(B, L, device=dev, generator=gen)
    c = 0.3 * torch.randn(B, L, device=dev, generator=gen)
    bias = 1.5 * torch.randn(B, H, device=dev, generator=gen)
    D = torch.randn(H, device=dev, generator=gen)
    khat = torch.fft.rfft(0.05 * torch.randn(H, L, device=dev,
                                             generator=gen), n=n)
    W = ops.int8_spectrum(khat, L)[1]
    for form, u in (("bf16", x.to(torch.bfloat16)), ("f32", x)):
        compare("fftconv_int8", H, L,
                lambda: ops.fftconv_int8(u, a, c, bias, khat, D, W),
                lambda: ops.fftconv_int8_ref(u, a, c, bias, khat, D, W), 3,
                results, B=B, n=n, tier=f"B{B}_H{H}_L{L}_{form}",
                tol=TOL_INT8, bpe=2 if form == "bf16" else 4)


def gemm_ms(torch, name, results, tier, w, y):
    """Kernel ``name``'s channel product alone at one tier, as one bf16
    ``torch.matmul`` of the weight ``w`` by ``y`` (2f: (2H x H) by each
    batch row's (H x L); 11f: the stacked (C + S) x C weight by a (C x B
    L) operand; cuBLAS on the tensor cores, with none of the kernel's
    bias, activations or residual): a yardstick recorded as ``gemm_ms``,
    never called by the port."""
    wb = w.to(torch.bfloat16)
    ms = cuda_ms(lambda: torch.matmul(wb, y), 10)
    results[name]["tiers"][tier]["gemm_ms"] = ms
    log(f"yardstick {name} {tier}: one bf16 torch.matmul {ms:.4f} ms")


def cufft_conv_ms(torch, x, khat, L):
    """One torch.fft.rfft -> product -> irfft conv of x (f32) with the half
    spectrum khat at its FFT size, cut to L (cuFFT, no prologue or
    epilogue): a yardstick of kernels 1f and 9f, never called by the
    port."""
    n = 2 * (khat.shape[-1] - 1)
    return cuda_ms(lambda: torch.fft.irfft(torch.fft.rfft(x, n=n) * khat,
                                           n=n)[..., :L], 10)


def hold_1f_routes(torch, name, tier, n, launch, ref, cufft_ms, results,
                   key=""):
    """Kernel 1f (``name``: its sampling form or its training entry) at one
    tier beyond its bar: two calls on its radix-16 route bit-equal; the
    route ops.fftconv.conv_plan does not take at n held against the plain
    version ``ref`` at TOL_BF16 and timed in turns with the route it takes
    (``<key>stockham_ms`` or ``<key>radix16_ms``, beside
    ``<key>ms_vs_stockham`` or ``<key>ms_vs_radix16``); a cuFFT conv of the
    same shapes (``cufft_conv_ms``), a yardstick the port never calls.
    ``launch(plan)`` runs 1f on the plan's route."""
    fc = importlib.import_module("diffwave_sashimi_torch.ops.fftconv")
    r16, shipped = fc.radix16_plan(n), fc.conv_plan(n)
    other = fc.STOCKHAM if shipped == r16 else r16
    one, two = launch(r16), launch(r16)
    alt = launch(other)
    torch.cuda.synchronize()
    if not torch.equal(one, two):
        raise AssertionError(f"kernel {name} {tier} {key}: two calls of "
                             f"the radix-16 route differ")
    err, scale = max_err(alt, ref)
    if not (err <= TOL_BF16 * max(1.0, scale)
            and bool(torch.isfinite(alt).all())):
        raise AssertionError(f"kernel {name} {tier} {key}on its {other.route}"
                             f" route disagrees: {err:.3e} of {scale:.3e}")
    ms, other_ms = paired_ms(lambda: launch(shipped), lambda: launch(other),
                             10)
    t = results[name]["tiers"][tier]
    t.update({f"{key}{other.route}_ms": other_ms,
              f"{key}ms_vs_{other.route}": ms,
              f"{key}{other.route}_max_abs_err": err,
              "cufft_conv_ms": cufft_ms})
    form = f" {key.rstrip('_')}" if key else ""
    log(f"kernel {name} {tier}{form}: radix-16 route, two calls bit-equal; "
        f"its {shipped.route} route {ms:.4f} ms vs the {other.route} route "
        f"{other_ms:.4f} ms in turns (that one {err:.3e} of {scale:.3e} off "
        f"the plain version); cuFFT conv {cufft_ms:.4f} ms")


def hold_1_routes(torch, name, tier, n, launch, ref, wide, cufft_ms,
                  results, key=""):
    """Kernel 1 (f32; ``name``: its sampling form or its training entry,
    ``key`` "conj_" for the training entry's conjugate form) at one tier
    beyond its bar: conv_plan takes its radix-16 route at n, and two calls
    there are bit-equal; its relative L2 error against ``wide``, a float64
    evaluation of the function on the same inputs, at most twice that of
    the plain version ``ref`` (cuFFT's); the Stockham kernel held against
    the plain version at TOL_KERNEL, its float64 error recorded; the two
    routes timed in CUDA graphs in turns (``<key>graph_ms``,
    ``<key>stockham_graph_ms``) beside a cuFFT conv of the same shapes
    (``cufft_conv_ms``, a yardstick the port never calls).
    ``launch(plan)`` runs kernel 1 on the plan's route."""
    fc = importlib.import_module("diffwave_sashimi_torch.ops.fftconv")
    r16, old = fc.radix16_plan(n), fc.STOCKHAM
    if fc.conv_plan(n) != r16:
        raise AssertionError(f"kernel {name} {tier}: conv_plan({n}) is not "
                             f"its radix-16 route")
    one, two, alt = launch(r16), launch(r16), launch(old)
    torch.cuda.synchronize()
    if not torch.equal(one, two):
        raise AssertionError(f"kernel {name} {tier} {key}: two calls of "
                             f"the radix-16 route differ")

    def l2(out):
        return float((out.double() - wide).norm() / wide.norm())
    err, scale = max_err(alt, ref)
    errs = {f"{key}c64_err": l2(one), f"{key}plain_c64_err": l2(ref),
            f"{key}stockham_c64_err": l2(alt),
            f"{key}stockham_max_abs_err": err}
    ok = (errs[f"{key}c64_err"] <= 2 * errs[f"{key}plain_c64_err"]
          and err <= TOL_KERNEL * max(1.0, scale)
          and bool(torch.isfinite(alt).all()))
    del one, two, alt
    o1 = graph_ms(torch, lambda: launch(old))
    k1, k2 = (graph_ms(torch, lambda: launch(r16)) for _ in range(2))
    o2 = graph_ms(torch, lambda: launch(old))
    t = results[name]["tiers"][tier]
    t.update(errs, bit_equal=True, cufft_conv_ms=cufft_ms,
             **{f"{key}graph_ms": (k1 + k2) / 2,
                f"{key}stockham_graph_ms": (o1 + o2) / 2})
    form = f" {key.rstrip('_')}" if key else ""
    log(f"kernel {name} {tier}{form}: radix-16 route, two calls bit-equal; "
        f"vs float64 L2 {errs[f'{key}c64_err']:.3e} (plain "
        f"{errs[f'{key}plain_c64_err']:.3e}, Stockham "
        f"{errs[f'{key}stockham_c64_err']:.3e}; bar 2x plain) "
        f"{'ok' if ok else 'FAIL'}; in CUDA graphs, in turns: radix-16 "
        f"{t[f'{key}graph_ms']:.4f} ms vs Stockham "
        f"{t[f'{key}stockham_graph_ms']:.4f} ms (its max_abs_err {err:.3e} "
        f"of {scale:.3e}); cuFFT conv {cufft_ms:.4f} ms")
    if not ok:
        raise AssertionError(f"kernel {name} {tier}{form}: its float64 "
                             f"error is past twice the plain version's, or "
                             f"the Stockham kernel disagrees")


def run_shipped_command(torch, run, launches):
    """The shipped SC09 command, ``runtime.generate.main(["experiment=sc09",
    "generate.n_samples=4"])`` with no precision override (bf16), then with
    ``+compute.conv_int8=true``: exact launch counts, finite wavs.  Returns
    the wall seconds of each."""
    secs = {}
    for path, extra, want in (
            ("generate_bf16", [], BF16_LAUNCHES),
            ("generate_int8", ["+compute.conv_int8=true"], INT8_LAUNCHES)):
        secs[path] = run_shipped_command_counted(
            torch, path, ["experiment=sc09",
                          f"generate.n_samples={N_SAMPLES}"] + extra,
            want, launches)
        read_wavs(run, N_SAMPLES, 16000, path)
    return secs


def check_bf16_path(torch, model, dev):
    """The bf16 and int8 sampling paths on the same parameters as the f32
    model: eps through the kernels vs the bf16 plain path (int8: vs the
    int8 plain path's own distance to it); the eps step timed at B4 and B16
    (kernels vs plain); a trace of two bf16 steps and two int8 steps; then
    a 50-step reverse process (QUALITY_CFG) with one injected noise stack,
    x_0 of bf16, bf16 + int8 and f32 + int8 against f32's; the bf16 step
    against the f32 step, in turns, at both batches.  Returns a dict."""
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.diffusion.sampling import sampling
    from diffwave_sashimi_torch.diffusion.schedule import schedule_from_cfg
    bfm = bf16_copy(torch, model)
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    x = torch.randn(N_SAMPLES, 1, 16000, device=dev, generator=g)
    steps = torch.tensor([199, 120, 40, 3][:N_SAMPLES], device=dev)
    routes = {"bf16": (ops.FUSED, ops.PLAIN),
              "int8": (ops.FUSED_INT8, ops.PLAIN_INT8)}
    # each route's spectra (the int8 ones carry the window convs)
    spectra = {o: bfm.compute_kernels(16000, o)
               for pair in routes.values() for o in pair}
    out = {"eps_err": {}, "quality": {}, "step_ms": {}, "step_plain_ms": {},
           "step_ms_vs_f32": {}, "f32_step_ms": {}, "trace": {}}
    ref = bfm(x, steps, spectra[ops.PLAIN], ops.PLAIN)   # bf16 plain path

    def rel_rms(e):
        return float(((e - ref).square().mean() / ref.square().mean()).sqrt())
    for label, (fused, plain) in routes.items():
        eps = bfm(x, steps, spectra[fused], fused)
        err, scale = max_err(eps, ref)
        r = {"max_abs_err": err, "max_abs_plain": scale,
             "rel_rms": rel_rms(eps)}
        ok = eps.dtype == torch.float32 and bool(torch.isfinite(eps).all()) \
            and scale > 0
        if label == "bf16":
            bar = f"max_abs_err <= {TOL_EPS_BF16} x max|plain|"
            ok = ok and err <= TOL_EPS_BF16 * scale
        else:
            r["plain_rel_rms"] = rel_rms(bfm(x, steps, spectra[plain], plain))
            bar = f"rel_rms <= {TOL_EPS_INT8} x plain_rel_rms + 1e-3"
            ok = ok and r["rel_rms"] <= TOL_EPS_INT8 * r["plain_rel_rms"] \
                + 1e-3
        out["eps_err"][label] = r
        log(f"phase {label} eps: kernels vs the bf16 plain path "
            f"{json.dumps(r)} ({bar}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label} eps through the kernels disagrees")

    k32 = model.compute_kernels(16000, ops.FUSED)
    for B in (N_SAMPLES, 16):
        xb = torch.randn(B, 1, 16000, device=dev, generator=g)
        sb = torch.randint(0, 200, (B,), device=dev, generator=g)
        for label, (fused, plain) in routes.items():
            key = f"{label}_B{B}"
            out["step_ms"][key], out["step_plain_ms"][key] = paired_ms(
                lambda: bfm(xb, sb, spectra[fused], fused),
                lambda: bfm(xb, sb, spectra[plain], plain), 5)
            log(f"timing: {label} eps forward (one sampling step) at B{B} "
                f"{out['step_ms'][key]:.3f} ms with kernels vs "
                f"{out['step_plain_ms'][key]:.3f} ms plain")
        # the bf16 step against the f32 step, both through the kernels
        key = f"B{B}"
        out["step_ms_vs_f32"][key], out["f32_step_ms"][key] = paired_ms(
            lambda: bfm(xb, sb, spectra[ops.FUSED], ops.FUSED),
            lambda: model(xb, sb, k32, ops.FUSED), 5)
        log(f"timing: bf16 eps forward at B{B} "
            f"{out['step_ms_vs_f32'][key]:.3f} ms vs the f32 step's "
            f"{out['f32_step_ms'][key]:.3f} ms in turns")
    # each route's step at B4 and at B16, where the card is fuller: kernel
    # 1f's share of the bf16 steps, kernel 12's of the int8 ones
    x16 = torch.randn(16, 1, 16000, device=dev, generator=g)
    s16 = torch.randint(0, 200, (16,), device=dev, generator=g)
    for label, (fused, _) in routes.items():
        groups, kernel = ((KERNEL_1F_GROUPS, "fftconv_1f") if label == "bf16"
                          else (KERNEL_12_GROUPS, "fftconv_int8"))
        for key, xs, ss in ((label, x, steps), (f"{label}_B16", x16, s16)):
            tr = trace_steps(torch, lambda: bfm(xs, ss, spectra[fused],
                                                fused), groups=groups)
            if tr is None:
                raise AssertionError(f"the profiler recorded no device time "
                                     f"in the {key} sampling step")
            out["trace"][key] = tr
            k_ms = tr["groups_ms_per_step"][kernel]
            tr[f"{kernel}_share"] = k_ms / tr["device_busy_ms_per_step"]
            log(f"trace: {key} sampling step with the kernels: "
                f"{json.dumps(tr)}")
            log(f"trace: kernel {'1f' if label == 'bf16' else '12'} "
                f"{k_ms:.3f} ms of {tr['device_busy_ms_per_step']:.3f} busy "
                f"ms a {key} sampling step ({tr[f'{kernel}_share']:.3f} of "
                f"the busy time); the device idle {tr['idle_share']:.3f} of "
                f"the window")

    sched = schedule_from_cfg(QUALITY_CFG, fast=True)
    shape = (N_SAMPLES, 1, 16000)
    noise = torch.randn(sched.T + 1, *shape, device=dev, generator=g)
    x32 = sampling(model, shape, sched, device=dev, noise=noise)
    failed = []
    for label, m, o in (("bf16", bfm, ops.FUSED),
                        ("int8", bfm, ops.FUSED_INT8),
                        ("int8_f32", model, ops.FUSED_INT8)):
        xq = sampling(m, shape, sched, device=dev, noise=noise, ops=o)
        out["quality"][label], ok = quality_gate(torch, label, x32, xq)
        failed += [] if ok else [label]

    if failed:
        raise AssertionError(f"x_0 fails the quality gate: {failed}")
    return out


def check_training_kernels(torch, model, dev, results):
    """Phase 7: kernel 1's training entry (and its conjugate form) and
    kernels 4-8 vs their plain versions at every tier, timed (kernel 1
    beyond that by ``hold_1_routes``, kernels 4 and 8 by ``hold_kernel_4``
    and ``hold_kernel_8``, kernel 5 by ``hold_dkf``)."""
    from diffwave_sashimi_torch import ops
    fc = importlib.import_module("diffwave_sashimi_torch.ops.fftconv")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    for H, L, blk in tier_blocks(model):
        d = tier_inputs(torch, blk, L, gen, dev)
        x, g, khat, lin = d["x"], d["g"], d["khat"], d["lin"]
        ff = (x, d["m2"], d["s2"], d["w1"], d["b1"], d["w2"], d["b2"], g)
        cauchy = (*d["quad"], d["z"], d["g_re"], d["g_im"])
        cases = [
            ("fftconv", lambda: ops.fftconv(x, khat),
             lambda: ops.fftconv_ref(x, khat)),
            ("fftconv", lambda: ops.fftconv(g, khat, conj=True),
             lambda: ops.fftconv_ref(g, khat, conj=True)),
            ("glu_res_bwd",
             lambda: ops.glu_res_bwd(d["y"], lin.weight, lin.bias, g),
             lambda: ops.glu_res_bwd_ref(d["y"], lin.weight, lin.bias, g)),
            ("ln_ff_res_bwd", lambda: ops.ln_ff_res_bwd(*ff),
             lambda: ops.ln_ff_res_bwd_ref(*ff)),
            ("cauchy_bwd", lambda: ops.cauchy_bwd(*cauchy),
             lambda: ops.cauchy_bwd_ref(*cauchy)),
            ("cauchy",
             lambda: ops.cauchy_quad(*d["quad"], d["z"]).unbind(-1),
             lambda: ops.cauchy_quad_ref(*d["quad"], d["z"])),
        ]
        for name, kfn, pfn in cases:
            compare(name, H, L, kfn, pfn,
                    3 if name.startswith("cauchy") else 10, results)
        n, k64 = d["n"], khat.to(torch.complex128)
        cufft = cufft_conv_ms(torch, x, khat, L)
        for key, inp, conj in (("", x, False), ("conj_", g, True)):
            wide = torch.fft.irfft(torch.fft.rfft(inp.double(), n=n) * (
                k64.conj() if conj else k64), n=n)[..., :L]
            hold_1_routes(torch, "fftconv", f"H{H}_L{L}", n,
                          lambda p: fc.launch_conv(inp, khat, conj, p),
                          ops.fftconv_ref(inp, khat, conj), wide, cufft,
                          results, key)
            del wide
        hold_kernel_4(torch, d, f"H{H}_L{L}", results)
        hold_kernel_8(torch, d, f"H{H}_L{L}", results)
        hold_dkf(torch, "fftconv_dkf", d, results)
        hold_f32_mixers(torch, d, f"H{H}_L{L}", results)
        # 7 at F = H (a config's model.ff 1), off the shipped F = 2H, and on
        # its element-wise path (L 1001, B2: L not a multiple of 4)
        ffh = ff[:3] + (d["w1"][:H].contiguous(), d["b1"][:H],
                        d["w2"][:, :H].contiguous()) + ff[6:]
        compare("ln_ff_res_bwd", H, L, lambda: ops.ln_ff_res_bwd(*ffh),
                lambda: ops.ln_ff_res_bwd_ref(*ffh), 10, results,
                tier=f"H{H}_L{L}_F{H}", F=H)
        if H <= 256:
            xr, gr = (torch.randn(2, H, 1001, device=dev, generator=gen)
                      for _ in range(2))
            ffr = (xr,) + ff[1:7] + (gr,)
            compare("ln_ff_res_bwd", H, 1001,
                    lambda: ops.ln_ff_res_bwd(*ffr),
                    lambda: ops.ln_ff_res_bwd_ref(*ffr), 3, results, B=2,
                    tier=f"B2_H{H}_L1001")
    hold_kernel_7_ragged(torch, dev, results)
    hold_kernel_8_ragged(torch, dev)
    hold_kernel_4_ragged(torch, dev)


def hold_f32_mixers(torch, d, tier, results):
    """Kernels 7 and 6 (f32) at one tier's shapes (d: ``tier_inputs``)
    beyond ``compare``'s bar (``hold_f32_mixer``)."""
    from diffwave_sashimi_torch import ops
    ff = (d["x"], d["m2"], d["s2"], d["w1"], d["b1"], d["w2"], d["b2"],
          d["g"])
    glu = (d["y"], d["lin"].weight, d["lin"].bias, d["g"])
    hold_f32_mixer(torch, "ln_ff_res_bwd", lambda: ops.ln_ff_res_bwd(*ff),
                   ops.ln_ff_res_bwd_ref, ff, tier, results, KERNELS_7,
                   ff_yardstick(torch, ff))
    hold_glu_bwd(torch, glu, tier, results)


def hold_glu_bwd(torch, glu, tier, results):
    """Kernel 6 (f32) at one tier beyond ``compare``'s bar
    (``hold_f32_mixer``): ``glu`` = (y, W, b, g); in CUDA graphs beside the
    f32 ``torch.matmul`` yardstick of its products; and at every (P, blocks
    an SM) it is built for whose tiles fit (``p_ms``, CUDA graphs, the
    whole call)."""
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.ops import chmix, cuda_lib
    y, w, b, g = glu
    B, H, L = y.shape
    hold_f32_mixer(torch, "glu_res_bwd", lambda: ops.glu_res_bwd(*glu),
                   ops.glu_res_bwd_ref, glu, tier, results, KERNELS_6,
                   glu_yardstick(torch, glu))
    dy, dz, tc, part, grads = chmix._glu_bwd_buffers(torch.float32, *glu)
    wf = w.new_empty((chmix.glu_bwd_tf32_split_floats(H),))
    ptrs = chmix._ptrs(y, g, w, b, dy, dz, part, grads, wf)
    p_ms = {}
    for P, blocks in (*chmix.GLU_BWD_TF32_SHARED,
                      *((P, 1) for P in chmix.GLU_BWD_TF32_PS)):
        smem = chmix.glu_bwd_tf32_smem(H, P)
        if blocks * (smem + chmix.SMEM_RESERVED) > chmix.SMEM_SM or (
                smem > chmix.SMEM_LIMIT):
            continue
        p_ms[f"({P}, {blocks})"] = graph_ms(torch, lambda: cuda_lib.launch(
            "dwst_glu_res_bwd", *ptrs, B, H, L, tc, P, blocks, smem))
    results["glu_res_bwd"]["tiers"][tier]["p_ms"] = p_ms
    log(f"kernel glu_res_bwd {tier}: plan "
        f"{chmix.glu_bwd_tf32_plan(B, H, L, cuda_lib.sm_count(y.device))}; "
        f"in CUDA graphs by (P, blocks an SM) {json.dumps(p_ms)}")


def hold_kernel_7_ragged(torch, dev, results):
    """Kernel 7 at KERNEL_7_RAGGED (H and F multiples of 8 but not 16, L
    1001: the split weights' zero rows, the element-wise path) and kernel
    6 at its H, vs their plain versions at TOL_KERNEL, two calls
    bit-equal."""
    from diffwave_sashimi_torch import ops
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    B, H, Fd, L = KERNEL_7_RAGGED

    def f(*shape, sc=1.0):
        return sc * torch.randn(*shape, device=dev, generator=gen)
    ff = (f(B, H, L), f(1, sc=0.1), 1.0 + f(1, sc=0.1), f(Fd, H, sc=0.3),
          f(Fd, sc=0.1), f(H, Fd, sc=0.3), f(H, sc=0.1), f(B, H, L))
    glu = (f(B, H, L), f(2 * H, H, sc=0.3), f(2 * H, sc=0.1), f(B, H, L))
    tier = f"B{B}_H{H}_F{Fd}_L{L}"
    for name, kfn, pfn in (
            ("ln_ff_res_bwd", lambda: ops.ln_ff_res_bwd(*ff),
             lambda: ops.ln_ff_res_bwd_ref(*ff)),
            ("glu_res_bwd", lambda: ops.glu_res_bwd(*glu),
             lambda: ops.glu_res_bwd_ref(*glu))):
        compare(name, H, L, kfn, pfn, 3, results, B=B, tier=tier, F=Fd)
        if not all(torch.equal(a, b) for a, b in zip(kfn(), kfn())):
            raise AssertionError(f"kernel {name} does not repeat bit for "
                                 f"bit at {tier}")


def hold_kernel_4_ragged(torch, dev):
    """Phase 7's kernel 4 off the shipped shapes (KERNEL_4_RAGGED: odd K,
    K 8, blocks of fewer threads, N past 48 KB of records), on seeded
    residues and poles of negative real part: vs its plain version at
    TOL_KERNEL x max(1, max|plain|), two calls bit-equal."""
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.models.s4 import _fft_nodes
    from diffwave_sashimi_torch.ops import cauchy, cuda_lib
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    for K, M, N, Lz in KERNEL_4_RAGGED:
        w = torch.complex(-0.1 - torch.rand(M, N, device=dev, generator=gen),
                          10 * torch.randn(M, N, device=dev, generator=gen))
        v = torch.randn(K, M, N, dtype=torch.complex64, device=dev,
                        generator=gen)
        args = (*cauchy.quad_operands(v, w),
                torch.from_numpy(_fft_nodes(2 * (Lz - 1))[1]).to(dev))
        one, two = ops.cauchy_quad(*args), ops.cauchy_quad(*args)
        ref = torch.stack(ops.cauchy_quad_ref(*args), -1)
        torch.cuda.synchronize()
        err, sc = max_err(one, ref)
        ok = err <= TOL_KERNEL * max(1.0, sc) and torch.equal(one, two)
        log(f"kernel cauchy K{K} M{M} N{N} Lz{Lz}: {err:.2e}/{sc:.2e} of "
            f"max|plain|, two calls bit-equal, plan "
            f"{cauchy.cauchy_fwd_plan(K, M, N, Lz, cuda_lib.sm_count(dev))} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel cauchy disagrees at K{K} M{M} "
                                 f"N{N} Lz{Lz}")


def hold_kernel_8_ragged(torch, dev):
    """Phase 7's kernel 8 off the shipped shapes (KERNEL_8_RAGGED: N below
    a warp's 32 lanes, odd K, partial chunks and splits), on seeded
    coefficients over the eigenvalues of an S4 kernel of that width: vs
    its plain version at TOL_KERNEL x max(1, max|plain|), two calls on the
    views of one complex cotangent bit-equal, and equal to the call on
    two planes."""
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.models.s4 import SSKernelNPLR, _fft_nodes
    from diffwave_sashimi_torch.ops import cauchy
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    for K, M, N, Lz in KERNEL_8_RAGGED:
        L = 2 * (Lz - 1)
        kern = SSKernelNPLR(M, N=2 * N, l_max=L, channels=1,
                            generator=torch.Generator().manual_seed(K))
        with torch.no_grad():
            w = kern.cauchy_operands()[1].to(dev)
        v = torch.randn(K, M, N, dtype=torch.complex64, device=dev,
                        generator=gen)
        args = (*cauchy.quad_operands(v, w),
                torch.from_numpy(_fft_nodes(L)[1]).to(dev))
        G = torch.randn(K, M, Lz, dtype=torch.complex64, device=dev,
                        generator=gen)
        views = ops.cauchy_bwd(*args, G.real, G.imag)
        again = ops.cauchy_bwd(*args, G.real, G.imag)
        planes = ops.cauchy_bwd(*args, G.real.contiguous(),
                                G.imag.contiguous())
        ref = ops.cauchy_bwd_ref(*args, G.real, G.imag)
        torch.cuda.synchronize()
        errs = [max_err(o, r) for o, r in zip(views, ref)]
        ok = all(e <= TOL_KERNEL * max(1.0, sc) for e, sc in errs) and all(
            torch.equal(x, y) and torch.equal(x, p)
            for x, y, p in zip(views, again, planes))
        log(f"kernel cauchy_bwd K{K} M{M} N{N} Lz{Lz}: per output "
            f"{', '.join(f'{e:.2e}/{sc:.2e}' for e, sc in errs)} of "
            f"max|plain|, calls bit-equal on views and planes "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel cauchy_bwd disagrees at K{K} M{M} "
                                 f"N{N} Lz{Lz}")


def hold_kernel_8(torch, d, tier, results):
    """Kernel 8 at one tier beyond its bar, on the cotangent as the training
    path hands it over (the real and imaginary views of one complex
    tensor, read in place): two calls bit-equal, and equal to the call on
    two planes that ``compare`` held against the plain version; it and its
    plain version against a complex128 evaluation of the same formulas,
    their errors side by side (each output's max |error| over max(1, its
    max|complex128|), the worst of the four), the kernel's at most twice
    the plain version's; its device time in a CUDA graph (``graph_ms``: at
    the lower tiers a call's host time exceeds its kernels'); the plan it
    ran."""
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.ops import cauchy, cuda_lib
    G = torch.complex(d["g_re"], d["g_im"])
    args = (*d["quad"], d["z"], G.real, G.imag)
    one, two = ops.cauchy_bwd(*args), ops.cauchy_bwd(*args)
    planes = ops.cauchy_bwd(*d["quad"], d["z"], d["g_re"], d["g_im"])
    plain = ops.cauchy_bwd_ref(*args)
    wide = ops.cauchy_bwd_ref(*(t.double() for t in d["quad"]),
                              d["z"].to(torch.complex128),
                              d["g_re"].double(), d["g_im"].double())
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) and torch.equal(x, p)
               for x, y, p in zip(one, two, planes)):
        raise AssertionError(f"kernel cauchy_bwd {tier}: two calls differ, "
                             f"or the views' call differs from the planes'")

    def worst(outs):
        return max(float((o.double() - w).abs().max()) / max(
            1.0, float(w.abs().max())) for o, w in zip(outs, wide))
    err, plain_err = worst(one), worst(plain)
    del wide, plain
    dev_ms = graph_ms(torch, lambda: ops.cauchy_bwd(*args))
    K, M, N = d["quad"][0].shape
    plan = cauchy.cauchy_bwd_plan(K, M, N, d["z"].shape[0],
                                  cuda_lib.sm_count(d["z"].device))
    t = results["cauchy_bwd"]["tiers"][tier]
    t.update(bit_equal=True, c128_err=err, plain_c128_err=plain_err,
             device_ms=dev_ms, plan=list(plan))
    ok = err <= 2 * plain_err and all(
        bool(torch.isfinite(o).all()) for o in one)
    log(f"kernel cauchy_bwd {tier}: two calls bit-equal, equal on planes; "
        f"vs complex128 {err:.3e} (plain {plain_err:.3e}) "
        f"{'ok' if ok else 'FAIL'}; in a CUDA graph {dev_ms:.4f} ms; plan "
        f"{tuple(plan)}")
    if not ok:
        raise AssertionError(f"kernel cauchy_bwd {tier}: its error against "
                             f"complex128 is past twice the plain "
                             f"version's")


def hold_kernel_4(torch, d, tier, results):
    """Kernel 4 at one tier beyond its bar: two calls bit-equal; it and its
    plain version against a complex128 evaluation of the same sum (max
    |error| over max(1, max|complex128|)), the kernel's at most twice the
    plain version's; its device time in a CUDA graph (``graph_ms``: at the
    lower tiers a call's host time exceeds its kernel's); the plan it
    ran."""
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.ops import cauchy, cuda_lib
    args = (*d["quad"], d["z"])
    one, two = ops.cauchy_quad(*args), ops.cauchy_quad(*args)
    plain = torch.stack(ops.cauchy_quad_ref(*args), -1)
    wide = torch.stack(ops.cauchy_quad_ref(
        *(t.double() for t in d["quad"]), d["z"].to(torch.complex128)), -1)
    torch.cuda.synchronize()
    if not torch.equal(one, two):
        raise AssertionError(f"kernel cauchy {tier}: two calls differ")

    def worst(out):
        return float((out.double() - wide).abs().max()) / max(
            1.0, float(wide.abs().max()))
    err, plain_err = worst(one), worst(plain)
    del wide, plain
    K, M, N = d["quad"][0].shape
    plan = cauchy.cauchy_fwd_plan(K, M, N, d["z"].shape[0],
                                  cuda_lib.sm_count(d["z"].device))
    t = results["cauchy"]["tiers"][tier]
    t.update(bit_equal=True, c128_err=err, plain_c128_err=plain_err,
             graph_ms=graph_ms(torch, lambda: ops.cauchy_quad(*args)),
             plan=list(plan))
    ok = err <= 2 * plain_err and bool(torch.isfinite(one).all())
    log(f"kernel cauchy {tier}: two calls bit-equal; vs complex128 "
        f"{err:.3e} (plain {plain_err:.3e}) {'ok' if ok else 'FAIL'}; in a "
        f"CUDA graph {t['graph_ms']:.4f} ms; plan {tuple(plan)}")
    if not ok:
        raise AssertionError(f"kernel cauchy {tier}: its error against "
                             f"complex128 is past twice the plain "
                             f"version's")


def graph_ms(torch, fn, reps=10, replays=5):
    """Device time per call of fn(), with no host time in it: ``reps``
    calls captured in one CUDA graph (after 3 uncaptured ones), the graph
    replayed ``replays`` times between CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / (reps * replays)


def hold_dkf(torch, name, d, results):
    """Kernel 5 (``name`` fftconv_dkf, u and g f32) or 5f
    (fftconv_dkf_bf16, bf16) at one tier's shapes (d: ``tier_inputs``),
    B4: vs its plain version (TOL_KERNEL or TOL_BF16 x max(1, max|plain|),
    ``compare``), and at each of DKF_BATCHES on inputs of its own; two
    calls bit-equal at every batch.  At B4 also: it, the plain version and
    the Stockham kernel against a complex128 evaluation of the function on
    the same inputs, as relative L2 errors (``c128_l2``: the kernel's at
    most twice the plain version's, cuFFT's) and max |error| over
    max|complex128| (``c128_err``); the Stockham kernel against the plain
    version at the same bar; the radix-16 route and the Stockham kernel
    timed in CUDA graphs in turns (``graph_ms``, ``stockham_graph_ms``;
    graphs: at the lower tiers a call's host time exceeds its kernel's),
    the radix-16 route at every chunk size up to the plan's (``rows_ms``,
    each timed twice, in one order and then the other), and one
    ``torch.fft.rfft`` of u and g stacked at the FFT size
    (``cufft_rfft_ms``, a yardstick the port never calls)."""
    from diffwave_sashimi_torch import ops
    fc = importlib.import_module("diffwave_sashimi_torch.ops.fftconv")
    bf = name.endswith("_bf16")
    dtype = torch.bfloat16 if bf else torch.float32
    tol, bpe = (TOL_BF16, 2) if bf else (TOL_KERNEL, 4)
    x, g, n = d["x"].to(dtype), d["g"].to(dtype), d["n"]
    B, H, L = x.shape
    tier = f"H{H}_L{L}"
    gen = torch.Generator(device=x.device).manual_seed(SEED + 28 + H)
    for b, (xb, gb) in [(B, (x, g))] + [
            (b, tuple(torch.randn(b, H, L, device=x.device, generator=gen)
                      .to(dtype) for _ in range(2))) for b in DKF_BATCHES]:
        compare(name, H, L, lambda: ops.fftconv_dkf(xb, gb, n),
                lambda: ops.fftconv_dkf_ref(xb, gb, n), 10 if b == B else 3,
                results, B=b, n=n, tier=tier if b == B else f"B{b}_{tier}",
                tol=tol, bpe=bpe)
        plan = fc.dkf_plan(n, b)
        one, two = fc.launch_dkf(xb, gb, n, plan), fc.launch_dkf(xb, gb, n,
                                                                 plan)
        torch.cuda.synchronize()
        if not torch.equal(one, two):
            raise AssertionError(f"kernel {name} B{b} {tier}: two calls "
                                 f"differ")
    del xb, gb
    plan = fc.dkf_plan(n, B)
    one = fc.launch_dkf(x, g, n, plan)
    old = fc.launch_dkf(x, g, n, fc.DKF_STOCKHAM)
    plain = ops.fftconv_dkf_ref(x, g, n)
    wide = ops.fftconv_dkf_ref(x.double(), g.double(), n)
    torch.cuda.synchronize()

    def l2(out):
        return float((out.to(torch.complex128) - wide).abs().norm()
                     / wide.abs().norm())

    def rel_max(out):
        return float((out.to(torch.complex128) - wide).abs().max()
                     / wide.abs().max())
    old_err, scale = max_err(old, plain)
    errs = {"c128_l2": l2(one), "plain_c128_l2": l2(plain),
            "stockham_c128_l2": l2(old), "c128_err": rel_max(one),
            "plain_c128_err": rel_max(plain), "stockham_max_abs_err": old_err}
    del wide, plain, old
    ok = errs["c128_l2"] <= 2 * errs["plain_c128_l2"] and \
        old_err <= tol * max(1.0, scale)

    def launch(p):
        return lambda: fc.launch_dkf(x, g, n, p)
    o1 = graph_ms(torch, launch(fc.DKF_STOCKHAM))
    k1, k2 = graph_ms(torch, launch(plan)), graph_ms(torch, launch(plan))
    o2 = graph_ms(torch, launch(fc.DKF_STOCKHAM))
    rows = range(1, plan.rows + 1)
    fwd = [graph_ms(torch, launch(fc.dkf_plan(n, B, r))) for r in rows]
    back = [graph_ms(torch, launch(fc.dkf_plan(n, B, r)))
            for r in reversed(rows)][::-1]
    cufft = cuda_ms(lambda: torch.fft.rfft(torch.stack([x, g]).float(),
                                           n=n), 10)
    t = results[name]["tiers"][tier]
    t.update(errs, bit_equal=True, graph_ms=(k1 + k2) / 2,
             stockham_graph_ms=(o1 + o2) / 2, plan=list(plan),
             rows_ms={str(r): (a + b) / 2 for r, a, b in zip(rows, fwd,
                                                             back)},
             cufft_rfft_ms=cufft)
    log(f"kernel {name} {tier}: two calls bit-equal at B{B} and "
        f"{DKF_BATCHES}; vs complex128 L2 {errs['c128_l2']:.3e} (plain "
        f"{errs['plain_c128_l2']:.3e}, Stockham "
        f"{errs['stockham_c128_l2']:.3e}), max {errs['c128_err']:.3e} "
        f"(plain {errs['plain_c128_err']:.3e}) {'ok' if ok else 'FAIL'}; "
        f"in CUDA graphs, in turns: radix-16 route {t['graph_ms']:.4f} ms "
        f"vs Stockham {t['stockham_graph_ms']:.4f} ms (its max_abs_err "
        f"{old_err:.3e} of {scale:.3e}); by rows a chunk "
        f"{json.dumps(t['rows_ms'])}; cuFFT rfft of u and g "
        f"{cufft:.4f} ms; plan {tuple(plan)}")
    if not ok:
        raise AssertionError(f"kernel {name} {tier}: its L2 error against "
                             f"complex128 is past twice the plain "
                             f"version's, or the Stockham kernel disagrees")


def check_bf16_training_kernels(torch, model, dev, results):
    """Phase 7b: the bf16 training forms (kernel 1f's training entry and
    its conjugate form, both on both routes, 5f (``hold_dkf``), 6f, 7f) vs
    their plain
    versions at every tier (B4, bf16 activations), timed; 7f also at F =
    H; 6f and 7f, at H 128
    and 256, on their element-wise paths (B2, L 1001), and at every tier
    their repeats, their times by part and their yardsticks
    (``ff_bwd_bf16_parts``, ``glu_bwd_bf16_parts``)."""
    from diffwave_sashimi_torch import ops
    fc = importlib.import_module("diffwave_sashimi_torch.ops.fftconv")
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    bf = torch.bfloat16
    for H, L, blk in tier_blocks(model):
        d = tier_inputs(torch, blk, L, gen, dev)
        x, g, y, khat, lin = (d["x"].to(bf), d["g"].to(bf), d["y"].to(bf),
                              d["khat"], d["lin"])
        ff = (x, d["m2"], d["s2"], d["w1"], d["b1"], d["w2"], d["b2"], g)
        cases = [
            ("fftconv_bf16", lambda: ops.fftconv_bf16(x, khat),
             lambda: ops.fftconv_ref(x, khat)),
            ("fftconv_bf16", lambda: ops.fftconv_bf16(g, khat, conj=True),
             lambda: ops.fftconv_ref(g, khat, conj=True)),
            ("glu_res_bwd_bf16",
             lambda: ops.glu_res_bwd_bf16(y, lin.weight, lin.bias, g),
             lambda: ops.glu_res_bwd_ref(y, lin.weight, lin.bias, g)),
            ("ln_ff_res_bwd_bf16", lambda: ops.ln_ff_res_bwd_bf16(*ff),
             lambda: ops.ln_ff_res_bwd_ref(*ff)),
        ]
        for name, kfn, pfn in cases:
            compare(name, H, L, kfn, pfn, 10, results, tol=TOL_BF16, bpe=2)
        hold_dkf(torch, "fftconv_dkf_bf16", d, results)
        # 1f's training entry and its conjugate form on both routes
        cufft_ms = cufft_conv_ms(torch, d["x"], khat, L)
        for key, inp, conj in (("", x, False), ("conj_", g, True)):
            hold_1f_routes(torch, "fftconv_bf16", f"H{H}_L{L}", d["n"],
                           lambda p, inp=inp, conj=conj:
                           fc.launch_conv(inp, khat, conj, p),
                           ops.fftconv_ref(inp, khat, conj), cufft_ms,
                           results, key)
        # 7f at F = H (a config's model.ff 1), off the shipped F = 2H, and
        # on its element-wise path (L 1001, B2: the last block ragged)
        ffh = ff[:3] + (d["w1"][:H].contiguous(), d["b1"][:H],
                        d["w2"][:, :H].contiguous()) + ff[6:]
        compare("ln_ff_res_bwd_bf16", H, L,
                lambda: ops.ln_ff_res_bwd_bf16(*ffh),
                lambda: ops.ln_ff_res_bwd_ref(*ffh), 10, results,
                tol=TOL_BF16, tier=f"H{H}_L{L}_F{H}", bpe=2, F=H)
        if H <= 256:
            xr, gr = (torch.randn(2, H, 1001, device=dev, generator=gen)
                      .to(bf) for _ in range(2))
            ffr = (xr,) + ff[1:7] + (gr,)
            compare("ln_ff_res_bwd_bf16", H, 1001,
                    lambda: ops.ln_ff_res_bwd_bf16(*ffr),
                    lambda: ops.ln_ff_res_bwd_ref(*ffr), 3, results, B=2,
                    tol=TOL_BF16, tier=f"B2_H{H}_L1001", bpe=2)
        ff_bwd_bf16_parts(torch, ff, results["ln_ff_res_bwd_bf16"],
                          f"H{H}_L{L}")
        # 6f on its element-wise path (L 1001, B2: the last block ragged;
        # inputs from a generator of its own), then its repeat, its time by
        # part, at every P and its yardsticks
        glu = (y, lin.weight, lin.bias, g)
        if H <= 256:
            g6 = torch.Generator(device=dev).manual_seed(SEED + 26 + H)
            yr, gr = (torch.randn(2, H, 1001, device=dev, generator=g6)
                      .to(bf) for _ in range(2))
            glr = (yr, lin.weight, lin.bias, gr)
            compare("glu_res_bwd_bf16", H, 1001,
                    lambda: ops.glu_res_bwd_bf16(*glr),
                    lambda: ops.glu_res_bwd_ref(*glr), 3, results, B=2,
                    tol=TOL_BF16, tier=f"B2_H{H}_L1001", bpe=2)
        glu_bwd_bf16_parts(torch, glu, results["glu_res_bwd_bf16"],
                           f"H{H}_L{L}")


def glu_bwd_bf16_parts(torch, glu, result, tier):
    """Kernel 6f at one tier beyond its bar: two calls on the same inputs
    must give equal outputs, bit for bit (the sums are in a fixed order);
    the device time of a call by part (KERNELS_6F: the pass, the
    contraction, its sum), from a trace of five calls in which every
    kernel must be one of those (the wrapper launches no PyTorch transpose
    or copy); the call at every P its kernel is built for whose tiles fit
    one block, each held against the plain version (TOL_BF16) and timed,
    in turns (``p_ms``, and whether it equals the plan's call bit for bit,
    ``p_bit_equal``); and two yardsticks, never called by the port: the
    pass's two channel products as two bf16 ``torch.matmul`` calls
    (``gemm_pair_ms``; cuBLAS on the tensor cores, no sigmoid or
    epilogue) and the weight gradient as one f32 ``torch.matmul`` with
    TF32 off (``wgrad_gemm_ms``; on operands already laid out as the
    contraction needs them, without the bias sums)."""
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.ops import chmix, cuda_lib
    y, w, b, g = glu
    B, H, L = y.shape
    bf = torch.bfloat16
    one, two = ops.glu_res_bwd_bf16(*glu), ops.glu_res_bwd_bf16(*glu)
    if not all(torch.equal(a, c) for a, c in zip(one, two)):
        raise AssertionError(f"kernel 6f does not repeat bit for bit at "
                             f"{tier}")
    groups = {part: (lambda n, names=names: in_group(n, names))
              for part, names in KERNELS_6F.items()}
    trace = trace_steps(torch, lambda: ops.glu_res_bwd_bf16(*glu), steps=5,
                        groups=groups)
    split = None
    if trace is not None:
        split = trace["groups_ms_per_step"]
        other = [n for n in trace["top_kernels_ms_per_step"]
                 if not any(in_group(n, names)
                            for names in KERNELS_6F.values())]
        if other:
            raise AssertionError(f"a kernel 6f call launched {other} at "
                                 f"{tier}")

    def at(P, smem):             # the wrapper's call with P given
        dy, dz, tc, part, grads = chmix._glu_bwd_buffers(bf, y, w, b, g)
        wb = w.new_empty((4 * H * H,), dtype=bf)
        cuda_lib.launch("dwst_glu_res_bwd_bf16",
                        *chmix._ptrs(y, g, w, b, dy, dz, part, grads, wb),
                        B, H, L, tc, P, smem)
        return dy, grads[:2 * H * H].view(2 * H, H), grads[2 * H * H:]
    ref = ops.glu_res_bwd_ref(*glu)
    calls, p_equal = {}, {}
    for P in chmix.GLU_BWD_BF16_PS:
        smem = chmix.glu_bwd_bf16_smem(H, P)
        if smem > chmix.SMEM_LIMIT:
            continue
        out = at(P, smem)
        torch.cuda.synchronize()
        errs = [max_err(o, r) for o, r in zip(out, ref)]
        if not all(e <= TOL_BF16 * max(1.0, sc) for e, sc in errs):
            raise AssertionError(f"kernel 6f at P {P} disagrees at {tier}: "
                                 f"{errs}")
        p_equal[P] = all(torch.equal(a, c) for a, c in zip(out, one))
        calls[P] = lambda P=P, smem=smem: at(P, smem)
    order = list(calls) + list(calls)[::-1]
    times = [(P, cuda_ms(calls[P], 10)) for P in order]
    p_ms = {P: sum(t for q, t in times if q == P) / 2 for P in calls}
    wb16, wtb = w.to(bf), w.t().contiguous().to(bf)
    dzb = torch.matmul(wb16, y)                   # a bf16 (B, 2H, L) operand
    pair = cuda_ms(lambda: (torch.matmul(wb16, y), torch.matmul(wtb, dzb)),
                   10)
    del dzb
    # f32 (2H, B L) and (H, B L) operands: dz and y
    rows_z = torch.randn(2 * H, B * L, device=y.device)
    rows_y = y.float().transpose(0, 1).reshape(H, B * L).contiguous()
    wgrad = cuda_ms(lambda: torch.matmul(rows_z, rows_y.t()), 10)
    del rows_z, rows_y
    plan_p = chmix.glu_bwd_bf16_plan(B, H, L, cuda_lib.sm_count(y.device))[0]
    result["tiers"][tier].update(repeat_bit_equal=True, split_ms=split,
                                 plan_P=plan_p, p_ms=p_ms,
                                 p_bit_equal=p_equal, gemm_pair_ms=pair,
                                 wgrad_gemm_ms=wgrad)
    log(f"kernel glu_res_bwd_bf16 {tier}: two calls bit-equal; device ms a "
        f"call by part {json.dumps(split)}; ms at each P (the plan's "
        f"{plan_p}) {json.dumps(p_ms)}, bit-equal to the plan's "
        f"{json.dumps(p_equal)}; yardsticks: two bf16 torch.matmul "
        f"{pair:.4f} ms, one f32 torch.matmul (TF32 off) {wgrad:.4f} ms")


def ff_bwd_bf16_parts(torch, ff, result, tier):
    """Kernel 7f at one tier beyond its bar: two calls on the same inputs
    must give equal outputs and gradients, bit for bit (the sums are in a
    fixed order); the device time of a call by part (KERNELS_7F: the pass,
    the contractions, the reductions), from a trace of five calls; and two
    yardsticks, never called by the port: the pass's three channel
    products as three bf16 ``torch.matmul`` calls (``gemm_triple_ms``;
    cuBLAS on the tensor cores, no LN, GELU or epilogue) and the two weight
    gradients as two f32 ``torch.matmul`` calls with TF32 off
    (``wgrad_gemm_pair_ms``; on operands already laid out as the
    contraction needs them, without the bias sums)."""
    from diffwave_sashimi_torch import ops
    x, m, s, w1, b1, w2, b2, g = ff
    B, H, L = x.shape
    F = w1.shape[0]
    one, two = ops.ln_ff_res_bwd_bf16(*ff), ops.ln_ff_res_bwd_bf16(*ff)
    if not all(torch.equal(a, b) for a, b in zip(one, two)):
        raise AssertionError(f"kernel 7f does not repeat bit for bit at "
                             f"{tier}")
    groups = {part: (lambda n, names=names: in_group(n, names))
              for part, names in KERNELS_7F.items()}
    trace = trace_steps(torch, lambda: ops.ln_ff_res_bwd_bf16(*ff), steps=5,
                        groups=groups)
    split = None if trace is None else trace["groups_ms_per_step"]
    bf = torch.bfloat16
    w1b, w2tb = w1.to(bf), w2.t().contiguous().to(bf)
    w1tb = w1.t().contiguous().to(bf)
    dzb = torch.matmul(w2tb, g)                   # a bf16 (B, F, L) operand
    triple = cuda_ms(lambda: (torch.matmul(w2tb, g), torch.matmul(w1b, x),
                              torch.matmul(w1tb, dzb)), 10)
    del dzb
    # f32 (F, B L) and (H, B L) operands: dz and xn, g and the GELU output
    rows_f = torch.randn(F, B * L, device=x.device)
    rows_h = g.float().transpose(0, 1).reshape(H, B * L).contiguous()
    pair = cuda_ms(lambda: (torch.matmul(rows_f, rows_h.t()),
                            torch.matmul(rows_h, rows_f.t())), 10)
    del rows_f, rows_h
    result["tiers"][tier].update(repeat_bit_equal=True, split_ms=split,
                                 gemm_triple_ms=triple,
                                 wgrad_gemm_pair_ms=pair)
    log(f"kernel ln_ff_res_bwd_bf16 {tier}: two calls bit-equal; device ms "
        f"a call by part {json.dumps(split)}; yardsticks: three bf16 "
        f"torch.matmul {triple:.4f} ms, two f32 torch.matmul (TF32 off) "
        f"{pair:.4f} ms")


def c64_err(outs, refs, scales=None):
    """Each output's error against a float64 evaluation: ||out - ref||_2 /
    ||ref||_2, or, for output i in ``scales``, ||out - ref||_2 /
    scales[i].  ``ff_sum_scales`` gives kernel 7's sums dm and ds theirs:
    a sum that cancels has its rounding error bounded by the sum of its
    terms' magnitudes, not by its value."""
    scales = scales or {}
    return [float((o.double() - r).norm()
                  / (scales[i] if i in scales else r.norm().clamp_min(1e-300)))
            for i, (o, r) in enumerate(zip(outs, refs))]


def ff_sum_scales(torch, ff):
    """{1: sum |dxn r|, 2: sum |dxn rstd (xc + m)|} over every (b, h, l),
    in float64: the magnitudes of the terms of kernel 7's dm and ds
    (outputs 1 and 2 of ``ln_ff_res_bwd_ref``, whose algebra this
    repeats)."""
    from diffwave_sashimi_torch.ops import chmix
    x, m, s, w1, b1, w2, _, g = (a.double() for a in ff)
    mean = x.mean(dim=1, keepdim=True)
    rstd = torch.rsqrt((x * x).mean(dim=1, keepdim=True) - mean * mean)
    xc = x - mean
    z = torch.einsum("bhl,fh->bfl", s * rstd * (xc + m), w1) + b1[:, None]
    dz = chmix._gelu_grad(z) * torch.einsum("bhl,hf->bfl", g, w2)
    dxn = torch.einsum("bfl,fh->bhl", dz, w1)
    return {1: float((dxn * s * rstd).abs().sum()),
            2: float((dxn * rstd * (xc + m)).abs().sum())}


def ff_yardstick(torch, ff):
    """Kernel 7's products as f32 ``torch.matmul`` calls (TF32 off, cuBLAS
    on the fp32 cores), a yardstick the port never calls: the pass's three
    (dh, z, dxn) and the two weight gradients on operands laid out as the
    contraction needs them, no LN, GELU, bias sums or epilogue."""
    x, m, s, w1, b1, w2, b2, g = ff
    B, H, L = x.shape
    Fd = w1.shape[0]
    w2t, w1t = w2.t().contiguous(), w1.t().contiguous()
    dz = torch.matmul(w2t, g)                      # an f32 (B, F, L) operand
    rows_f = dz.transpose(0, 1).reshape(Fd, B * L).contiguous()
    rows_h = g.transpose(0, 1).reshape(H, B * L).contiguous()
    return lambda: (torch.matmul(w2t, g), torch.matmul(w1, x),
                    torch.matmul(w1t, dz),
                    torch.matmul(rows_f, rows_h.t()),
                    torch.matmul(rows_h, rows_f.t()))


def glu_yardstick(torch, glu):
    """Kernel 6's products as f32 ``torch.matmul`` calls (TF32 off): the
    pass's two and the weight gradient, as ``ff_yardstick``."""
    y, w, b, g = glu
    B, H, L = y.shape
    wt = w.t().contiguous()
    dz = torch.matmul(w, y)                        # an f32 (B, 2H, L) operand
    rows_z = dz.transpose(0, 1).reshape(2 * H, B * L).contiguous()
    rows_y = y.transpose(0, 1).reshape(H, B * L).contiguous()
    return lambda: (torch.matmul(w, y), torch.matmul(wt, dz),
                    torch.matmul(rows_z, rows_y.t()))


def hold_f32_mixer(torch, name, kfn, plain_fn, args, tier, results, parts,
                   yard):
    """Kernel 2, 3, 6, 7 or 11 at f32 (``name`` glu_res, ln_ff_res,
    glu_res_bwd, ln_ff_res_bwd or gate_res_skip), beyond ``compare``'s
    bar: two calls bit-equal (fixed-order sums); the kernel's float64
    error (the worst of ``c64_err`` over its outputs, against
    ``plain_fn`` on float64 copies of ``args``; kernel 7's dm and ds on
    the scale of ``ff_sum_scales``) at most twice the plain f32 version's
    on the same scales; its device time by part (``parts``: KERNELS_2, 3,
    6, 7 or 11) from a trace of five calls, which must record device time
    and in which a call must launch nothing else;
    and in CUDA graphs (``graph_ms``), in turns, the kernel and ``yard``,
    its products as f32 ``torch.matmul`` calls (TF32 off; a
    yardstick)."""
    one, two = kfn(), kfn()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(one, two)):
        raise AssertionError(f"kernel {name} does not repeat bit for bit at "
                             f"{tier}")
    ref = plain_fn(*args)
    r64 = plain_fn(*(a.double() for a in args))
    scales = ff_sum_scales(torch, args) if name == "ln_ff_res_bwd" else None
    errs_k, errs_p = c64_err(one, r64, scales), c64_err(ref, r64, scales)
    e_k, e_p = max(errs_k), max(errs_p)
    del two, r64
    groups = {part: (lambda n, names=names: in_group(n, names))
              for part, names in parts.items()}
    trace = trace_steps(torch, kfn, steps=5, groups=groups)
    if trace is None:
        raise AssertionError(f"the profiler recorded no device time in "
                             f"kernel {name}'s calls at {tier}")
    split = trace["groups_ms_per_step"]
    other = [n for n in trace["top_kernels_ms_per_step"]
             if not any(in_group(n, names) for names in parts.values())]
    if other:
        raise AssertionError(f"a kernel {name} call launched {other} at "
                             f"{tier}")
    fns = {"graph_ms": kfn, "yardstick_graph_ms": yard}
    order = list(fns) + list(fns)[::-1]
    times = [(k, graph_ms(torch, fns[k])) for k in order]
    ms = {k: sum(t for q, t in times if q == k) / 2 for k in fns}
    t = results[name]["tiers"][tier]
    t.update(c64_err=e_k, plain_c64_err=e_p, c64_errs=errs_k,
             plain_c64_errs=errs_p, repeat_bit_equal=True, split_ms=split,
             **ms)
    log(f"kernel {name} {tier}: two calls bit-equal; error vs float64, "
        f"worst output {e_k:.3e} (plain {e_p:.3e}; bar 2x) "
        f"{'ok' if e_k <= 2 * e_p else 'FAIL'}, each output "
        f"{', '.join(f'{a:.2e}/{b:.2e}' for a, b in zip(errs_k, errs_p))} "
        f"(kernel/plain); device ms a call by part "
        f"{json.dumps(split)}; in CUDA graphs, in turns, "
        f"{json.dumps(ms)}")
    if e_k > 2 * e_p:
        raise AssertionError(f"kernel {name}'s float64 error {e_k:.3e} is "
                             f"over twice the plain version's {e_p:.3e} at "
                             f"{tier}")


def ff_fwd_yardstick(torch, x, w1, w2):
    """Kernel 3's two products as f32 ``torch.matmul`` calls (TF32 off,
    cuBLAS on the fp32 cores), a yardstick the port never calls: z = W1 x
    and W2 z, no LN, GELU, bias or residual."""
    z = torch.matmul(w1, x)                        # an f32 (B, F, L) operand
    return lambda: (torch.matmul(w1, x), torch.matmul(w2, z))


def gate_yardstick(torch, h, wr, ws):
    """Kernel 11's product as one f32 ``torch.matmul`` (TF32 off) of the
    stacked weight [W_r; W_s] and an f32 (B, C, L) operand, a yardstick the
    port never calls: no gate, bias or residual."""
    w = torch.cat([wr, ws])
    out = h[:, :wr.shape[0]].contiguous()
    return lambda: (torch.matmul(w, out),)


def hold_ff(torch, ff, tier, results):
    """Kernel 3 (f32) at one tier beyond ``compare``'s bar
    (``hold_f32_mixer``): ``ff`` = (x, m, s, w1, b1, w2, b2, skip), with
    the statistics; in CUDA graphs beside the f32 ``torch.matmul``
    yardstick of its products; and at every (P, blocks an SM) it is built
    for whose tiles fit (``p_ms``, CUDA graphs)."""
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.ops import chmix, cuda_lib
    x, m, s, w1, b1, w2, b2, skip = ff
    B, H, L = x.shape
    Fd = w1.shape[0]
    plain = lambda *a: ops.ln_ff_res_ref(*a, emit_stats=True)  # noqa: E731
    hold_f32_mixer(torch, "ln_ff_res", lambda: ops.ln_ff_res(*ff, True),
                   plain, ff, tier, results, KERNELS_3,
                   ff_fwd_yardstick(torch, x, w1, w2))
    p_ms = {}
    for P, blocks in ((64, 2), *((P, 1) for P in chmix.FF_TF32_PS)):
        room = (chmix.SMEM_SM // blocks - chmix.SMEM_RESERVED if blocks > 1
                else chmix.SMEM_LIMIT)
        plan = next(((P, FC, blocks, sm)
                     for FC in (Fd, 128 * 4, 128 * 2, 128)
                     for sm in [chmix.ff_tf32_smem(H, Fd, P, FC)]
                     if FC <= Fd and sm <= room
                     and (FC == Fd or FC % (16 * chmix._tf32_mt(P)) == 0)),
                    None)
        if plan is None:
            continue
        out = torch.empty_like(x)
        wf = w1.new_empty((chmix.ff_tf32_split_floats(H, Fd),))
        ptrs = chmix._ptrs(x, skip, w1, b1, w2, b2, m, s, out, None, None,
                           wf)
        p_ms[str(plan)] = graph_ms(torch, lambda: cuda_lib.launch(
            "dwst_ln_ff_res", *ptrs, B, H, Fd, L, *plan))
    results["ln_ff_res"]["tiers"][tier]["p_ms"] = p_ms
    log(f"kernel ln_ff_res {tier}: plan {chmix.ff_tf32_plan(H, Fd)}; in "
        f"CUDA graphs by (P, FC, blocks an SM, bytes) {json.dumps(p_ms)}")


def hold_gate(torch, args, tier, results):
    """Kernel 11 (f32) at one tier beyond ``compare``'s bar
    (``hold_f32_mixer``): ``args`` = (h, x, W_r, b_r, W_s, b_s); in CUDA
    graphs beside the f32 ``torch.matmul`` yardstick of
    its product; and at every (P, blocks an SM) it is built for whose tiles
    fit (``p_ms``, CUDA graphs)."""
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.ops import cuda_lib, wavenet_gate as wg
    h, x, wr, br, ws, bs = args
    B, C, L = x.shape
    S = ws.shape[0]
    hold_f32_mixer(torch, "gate_res_skip", lambda: ops.gate_res_skip(*args),
                   ops.gate_res_skip_ref, args, tier, results, KERNELS_11,
                   gate_yardstick(torch, h, wr, ws))
    p_ms = {}
    res, skip = torch.empty_like(x), x.new_empty((B, S, L))
    wf = x.new_empty((wg.gate_tf32_split_floats(C, S),))
    for P, blocks in (*wg.GATE_TF32_SHARED,
                      *((P, 1) for P in wg.GATE_TF32_PS)):
        smem = wg.gate_tf32_smem(C, P)
        if blocks * (smem + wg.SMEM_RESERVED) > wg.SMEM_SM or (
                smem > wg.SMEM_LIMIT):
            continue
        p_ms[f"({P}, {blocks})"] = graph_ms(torch, lambda: cuda_lib.launch(
            "dwst_gate_res_skip", *(t.data_ptr() for t in (
                h, x, wr, br, ws, bs, res, skip, wf)), B, C, S, L, P,
            blocks, smem))
    results["gate_res_skip"]["tiers"][tier]["p_ms"] = p_ms
    log(f"kernel gate_res_skip {tier}: plan "
        f"{wg.gate_tf32_plan(B, C, S, L, cuda_lib.sm_count(x.device))}; in "
        f"CUDA graphs by (P, blocks an SM) {json.dumps(p_ms)}")


def glu_fwd_yardstick(torch, y, w):
    """Kernel 2's product as one f32 ``torch.matmul`` (TF32 off) of W (2H x
    H) by y, a yardstick the port never calls: no bias, gate or
    residual."""
    return lambda: (torch.matmul(w, y),)


def hold_glu(torch, args, tier, results):
    """Kernel 2 (f32) at one tier beyond ``compare``'s bar
    (``hold_f32_mixer``): ``args`` = (y, res, W, b); in CUDA graphs beside
    the f32 ``torch.matmul`` yardstick of its product; and at every (P,
    blocks an SM) it is built for whose tiles fit (``p_ms``, CUDA
    graphs)."""
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.ops import chmix, cuda_lib
    y, res, w, b = args
    B, H, L = y.shape
    hold_f32_mixer(torch, "glu_res", lambda: (ops.mix_glu_res(*args),),
                   lambda *a: (ops.glu_res_ref(*a),), args, tier, results,
                   KERNELS_2, glu_fwd_yardstick(torch, y, w))
    out = torch.empty_like(res)
    wf = w.new_empty((chmix.glu_tf32_split_floats(H),))
    ptrs = [t.data_ptr() for t in (y, res, w, b, out, wf)]
    p_ms = {}
    for P, blocks in (*chmix.GLU_TF32_SHARED,
                      *((P, 1) for P in chmix.GLU_TF32_PS)):
        smem = chmix.glu_tf32_smem(H, P)
        if blocks * (smem + chmix.SMEM_RESERVED) > chmix.SMEM_SM or (
                smem > chmix.SMEM_LIMIT):
            continue
        p_ms[f"({P}, {blocks})"] = graph_ms(torch, lambda: cuda_lib.launch(
            "dwst_glu_res", *ptrs, B, H, L, P, blocks, smem))
    results["glu_res"]["tiers"][tier]["p_ms"] = p_ms
    log(f"kernel glu_res {tier}: plan "
        f"{chmix.glu_tf32_plan(B, H, L, cuda_lib.sm_count(y.device))}; in "
        f"CUDA graphs by (P, blocks an SM) {json.dumps(p_ms)}")


def write_corpus(root, per_digit=3):
    """Seeded synthetic SC09: one-second 16 kHz int16 clips, ``per_digit``
    in each digit folder, named like SpeechCommands (``*_nohash_*``)."""
    import numpy as np
    from scipy.io import wavfile
    rng = np.random.RandomState(SEED)
    t = np.arange(16000) / 16000.0
    for i, digit in enumerate(("zero", "one", "two", "three", "four", "five",
                               "six", "seven", "eight", "nine")):
        os.makedirs(os.path.join(root, digit))
        for j in range(per_digit):
            f0 = 150.0 + 40.0 * i + 10.0 * j
            wav = (0.3 * np.sin(2 * np.pi * f0 * t) * np.hanning(16000)
                   + 0.01 * rng.randn(16000))
            wavfile.write(os.path.join(root, digit,
                                       f"spk{j:02d}_nohash_{j}.wav"),
                          16000, (wav * 32767).astype(np.int16))


def run_training(torch, exp_dir, launches):
    """Phase 8: the training CLI, from scratch and resumed, with the launch
    counts of the first run."""
    import numpy as np
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.runtime import train as train_mod
    from diffwave_sashimi_torch.utils.exp import local_directory
    data = os.path.join(exp_dir, "sc09")
    write_corpus(data)
    overrides = TRAIN_OVERRIDES + [f"dataset.data_path={data}"]
    for fn in ops.COUNTED.values():
        fn.launches = 0
    t0 = time.perf_counter()
    train_mod.main(overrides)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches["train"] = {k: f.launches for k, f in ops.COUNTED.items()}
    t0 = time.perf_counter()
    train_mod.main(overrides)                  # resumes from 'max' (2)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    run, ckpt = local_directory(None, MODEL_CFG, DIFFUSION_CFG, DATASET_CFG,
                                "checkpoint", makedirs=False)
    with open(os.path.join("exp", run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [(r["step"], r["train/loss"]) for r in recs
              if "train/loss" in r]
    log(f"phase train: main() 4 iterations in {first_s:.2f} s wall, resume "
        f"1 iteration in {resume_s:.2f} s wall (each includes building the "
        f"model); losses {losses}; checkpoints {sorted(os.listdir(ckpt))}; "
        f"launches {launches['train']}")
    if [i for i, _ in losses] != [0, 1, 2, 3, 3] or not all(
            np.isfinite(v) for _, v in losses):
        raise AssertionError(f"training losses {losses}")
    if not os.path.exists(os.path.join(ckpt, "2.pkl")):
        raise AssertionError("checkpoint 2.pkl was not written")
    missing = [k for k, (_, _, paths) in KERNELS.items()
               if "train" in paths and launches["train"][k] == 0]
    if missing:
        raise AssertionError(f"kernels never ran in training: {missing}")
    return losses


def run_training_bf16(torch, exp_dir, launches):
    """Phase 8b: the shipped training command (bf16, no precision
    override), from scratch and resumed, with exact launch counts of the
    first run; the checkpoint's tensors must be f32."""
    import numpy as np
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.runtime import train as train_mod
    from diffwave_sashimi_torch.utils.exp import local_directory
    data = os.path.join(exp_dir, "sc09")
    write_corpus(data)
    overrides = TRAIN_BF16_OVERRIDES + [f"dataset.data_path={data}"]
    for fn in ops.COUNTED.values():
        fn.launches = 0
    t0 = time.perf_counter()
    train_mod.main(overrides)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches["train_bf16"] = {k: f.launches for k, f in ops.COUNTED.items()}
    t0 = time.perf_counter()
    train_mod.main(overrides)                  # resumes from 'max' (2)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    run, ckpt = local_directory(None, MODEL_CFG, DIFFUSION_CFG, DATASET_CFG,
                                "checkpoint", makedirs=False)
    with open(os.path.join("exp", run, "metrics.jsonl")) as f:
        losses = [(r["step"], r["train/loss"]) for r in map(json.loads, f)
                  if "train/loss" in r]
    saved = torch.load(os.path.join(ckpt, "2.pkl"), weights_only=True)
    dtypes = {str(t.dtype) for t in saved["model_state_dict"].values()}
    adam = {int(st["step"]) for st in
            saved["optimizer_state_dict"]["state"].values()}
    log(f"phase train_bf16: main() with no precision override, 4 iterations "
        f"in {first_s:.2f} s wall, resume 1 iteration in {resume_s:.2f} s "
        f"wall (each includes building the model); losses {losses}; "
        f"checkpoints {sorted(os.listdir(ckpt))}, 2.pkl tensors {dtypes}, "
        f"Adam steps {adam}; launches {launches['train_bf16']}")
    expect = {k: TRAIN_BF16_LAUNCHES.get(k, 0) for k in ops.COUNTED}
    if launches["train_bf16"] != expect:
        raise AssertionError(f"bf16 training launches "
                             f"{launches['train_bf16']}, expected {expect}")
    if [i for i, _ in losses] != [0, 1, 2, 3, 3] or not all(
            np.isfinite(v) for _, v in losses):
        raise AssertionError(f"bf16 training losses {losses}")
    if dtypes != {"torch.float32"} or adam != {3}:
        raise AssertionError(f"bf16 checkpoint: tensors {dtypes}, Adam "
                             f"steps {adam}")
    return {"losses": losses, "first_s": first_s, "resume_s": resume_s}


def bf16_copy(torch, model):
    """The model's parameters in a copy that runs at bf16
    (``construct_model(..., "bf16")`` with the same weights)."""
    import copy
    bfm = copy.deepcopy(model)
    bfm.act_dtype = torch.bfloat16
    return bfm


def grad_batch(torch, dev):
    """Phases 9 and 9b's seeded (audio, t, z)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    return (0.3 * torch.randn(N_SAMPLES, 1, 16000, device=dev, generator=g),
            torch.randint(0, 200, (N_SAMPLES,), device=dev, generator=g),
            torch.randn(N_SAMPLES, 1, 16000, device=dev, generator=g))


def step_grads(torch, model, audio, t, z, route, mel=None,
               diffusion=DIFFUSION_CFG):
    """(loss, {name: grad}) of one training step through ``route`` (a
    conditional model's ``mel``; ``diffusion``'s schedule)."""
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.diffusion.loss import training_loss
    from diffwave_sashimi_torch.diffusion.schedule import schedule_from_cfg
    model.zero_grad(set_to_none=True)
    loss = training_loss(model, audio, schedule_from_cfg(diffusion),
                         t=t, z=z, ops=getattr(ops, route), mel=mel)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def grad_distance(mine, ref):
    """Per tensor |a - b|_2 / |b|_2: its median and worst over the tensors
    (init_conv's weight_v left out: its gradient is exactly 0 but for
    roundoff, W = g sign(v)), and the largest entry error over the largest
    entry of ref."""
    names = [n for n in ref if n != "init_conv.0.conv.weight_v"]
    per = {n: float((mine[n] - ref[n]).norm() / ref[n].norm()) for n in names}
    worst = max(per, key=per.get)
    errs = {n: float((mine[n] - ref[n]).abs().max()) for n in names}
    entry = max(errs, key=errs.get)
    return {"median": float(sorted(per.values())[len(per) // 2]),
            "worst": per[worst], "worst_tensor": worst,
            "entry": errs[entry] / max(float(ref[n].abs().max())
                                       for n in names),
            "entry_tensor": entry}


def check_gradients_bf16(torch, model, dev):
    """Phase 9b: loss and every parameter gradient of one bf16 training
    step, kernels vs the bf16 plain path, on phase 9's batch, t and z, at
    TOL_GRAD_BF16; and the bf16 gradients' distance from the f32 ones
    (through the kernels)."""
    batch = grad_batch(torch, dev)
    bfm = bf16_copy(torch, model)
    loss, grads = step_grads(torch, bfm, *batch, "FUSED")
    loss_plain, grads_plain = step_grads(torch, bfm, *batch, "PLAIN")
    loss32, grads32 = step_grads(torch, model, *batch, "FUSED")
    vs_plain = grad_distance(grads, grads_plain)
    vs_f32 = grad_distance(grads, grads32)
    finite = all(bool(torch.isfinite(v).all()) for v in grads.values())
    ok = finite and all(vs_plain[k] <= TOL_GRAD_BF16[k]
                        for k in TOL_GRAD_BF16) and abs(
        loss - loss_plain) <= TOL_GRAD_BF16["entry"] * abs(loss_plain)
    out = {"loss": loss, "loss_plain": loss_plain, "loss_f32": loss32,
           "vs_plain": vs_plain, "vs_f32": vs_f32}
    log(f"phase grads_bf16: {json.dumps(out)} (bars {TOL_GRAD_BF16}, the "
        f"loss to the entry bar) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("bf16 gradients through the kernels disagree")
    return out


def check_bf16_trajectory(torch, model, dev, label="trajectory_bf16"):
    """Phase 9c (23b for the WaveNet): TRAJ_STEPS Adam steps (lr 2e-4)
    from the model's parameters at f32 and at bf16, through the kernels,
    on the same seeded batches, t and z; per-step losses within
    TRAJ_TOL."""
    import copy
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.diffusion.loss import training_loss
    from diffwave_sashimi_torch.diffusion.schedule import schedule_from_cfg
    from diffwave_sashimi_torch.runtime.train import make_optimizer
    g = torch.Generator(device=dev).manual_seed(SEED + 15)
    draws = [(0.3 * torch.randn(N_SAMPLES, 1, 16000, device=dev, generator=g),
              torch.randint(0, 200, (N_SAMPLES,), device=dev, generator=g),
              torch.randn(N_SAMPLES, 1, 16000, device=dev, generator=g))
             for _ in range(TRAJ_STEPS)]
    schedule = schedule_from_cfg(DIFFUSION_CFG)
    losses = {}
    for dt, m in (("f32", copy.deepcopy(model)),
                  ("bf16", bf16_copy(torch, model))):
        optim = make_optimizer(m, 2e-4)
        losses[dt] = []
        for audio, t, z in draws:
            optim.zero_grad(set_to_none=True)
            loss = training_loss(m, audio, schedule, t=t, z=z, ops=ops.FUSED)
            loss.backward()
            optim.step()
            losses[dt].append(loss.item())
        del m, optim
    diff = [abs(b - f) for b, f in zip(losses["bf16"], losses["f32"])]
    ok = all(math.isfinite(v) for v in losses["bf16"]) and all(
        d <= TRAJ_TOL["atol"] + TRAJ_TOL["rtol"] * abs(f)
        for d, f in zip(diff, losses["f32"]))
    out = {"losses": losses, "max_abs_diff": max(diff),
           "max_rel_diff": max(d / abs(f) for d, f in
                               zip(diff, losses["f32"]))}
    log(f"phase {label}: {TRAJ_STEPS} Adam steps, per-step losses "
        f"bf16 vs f32 {json.dumps(out)} (bar {TRAJ_TOL}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("bf16 training leaves the f32 trajectory")
    return out


def check_gradients(torch, model, dev):
    """Phase 9: loss and every parameter gradient of one training step,
    kernels vs plain, on one batch, t and z."""
    grads, losses = {}, {}
    for route in ("FUSED", "PLAIN"):
        losses[route], grads[route] = step_grads(
            torch, model, *grad_batch(torch, dev), route)
    return hold_gradients("grads", losses, grads)


def hold_gradients(label, losses, grads):
    """Each gradient through the kernels (FUSED) within TOL_GRAD x max(1,
    max|plain grad|) of the plain path's (PLAIN), and the loss within
    TOL_GRAD x max(1, |plain loss|); returns (worst share of its bound,
    its tensor)."""
    worst, bad = (0.0, ""), []
    for name, gp in grads["PLAIN"].items():
        err = float((grads["FUSED"][name] - gp).abs().max())
        tol = TOL_GRAD * max(1.0, float(gp.abs().max()))
        worst = max(worst, (err / tol, name))
        if not err <= tol:
            bad.append(name)
    lerr = abs(losses["FUSED"] - losses["PLAIN"])
    log(f"phase {label}: loss {losses['FUSED']:.6f} with kernels vs "
        f"{losses['PLAIN']:.6f} plain; {len(grads['PLAIN'])} gradient "
        f"tensors within {TOL_GRAD} x max(1, max|plain grad|), worst "
        f"{worst[0]:.3e} of its bound ({worst[1]})")
    if bad or not lerr <= TOL_GRAD * max(1.0, abs(losses["PLAIN"])):
        raise AssertionError(f"{label}: gradients disagree: {bad}, loss err "
                             f"{lerr}")
    return worst


def check_harder_trace(torch, step, label):
    """Phase 26: a torch.profiler trace of one ljspeech_harder bf16
    training step (``trace_steps``), the long route's kernels apart (5L's
    cluster kernel, the three passes of kernel 9's bf16 training entry);
    raise unless the step launched 5L's cluster kernel exactly
    HARDER_BF16_STEP's 12 times and each of the bf16 entry's passes 24
    times, with no two-pass 5L kernel and no f32 training entry, or if the
    profiler recorded no device time."""
    groups = {"kernel_5l_cluster": lambda n: in_group(n, (KERNEL_5L_CLUSTER,)),
              "kernel_9_train_bf16": lambda n: in_group(
                  n, KERNEL_9_TRAIN_BF16 + ("rows_kernel",)),
              "kernel_5l_two_pass": lambda n: in_group(
                  n, ("dkf_cols_kernel", "dkf_rows_kernel"))}
    groups.update(KERNEL_1F_GROUPS)
    groups.update(KERNEL_5F_GROUPS)
    groups.update(KERNEL_8_GROUPS)
    groups.update(KERNEL_4_GROUPS)
    trace = trace_steps(torch, step, steps=1, groups=groups)
    if trace is None:
        raise AssertionError(f"{label}: the profiler recorded no device "
                             f"time, so the step's kernels are unchecked")
    log(f"trace: {label} bf16 training step with the kernels: "
        f"{json.dumps(trace)}")
    count = trace["port_launches_per_step"]
    cluster = sum(c for n, c in count.items()
                  if in_group(n, (KERNEL_5L_CLUSTER,)))
    passes = {k: count.get(k, 0) for k in KERNEL_9_TRAIN_BF16}
    stale = [n for n in count if in_group(
        n, ("dkf_cols_kernel", "dkf_rows_kernel", "cols_fwd_kernel<false, "
            "float>", "cols_inv_kernel<false, float>"))]
    want = HARDER_BF16_STEP["fftconv_long"]
    busy = trace["device_busy_ms_per_step"]
    log(f"trace: {label}: 5L's cluster kernel {cluster:g} launches, "
        f"{trace['groups_ms_per_step']['kernel_5l_cluster']:.3f} ms; kernel "
        f"9's bf16 training entry {passes}, "
        f"{trace['groups_ms_per_step']['kernel_9_train_bf16']:.3f} ms; of "
        f"{busy:.3f} busy ms a step, idle {trace['idle_share']:.1%}")
    if cluster != HARDER_BF16_STEP["fftconv_dkf_long"] or stale or any(
            c != want for c in passes.values()):
        raise AssertionError(f"{label}: the traced step launched 5L's "
                             f"cluster kernel {cluster} times, kernel 9's "
                             f"bf16 entry {passes}, and {stale}")
    return trace


def counted_run(torch, path, want, launches, fn):
    """fn() with every launch count set to 0 just before and read just
    after into ``launches[path]``, which must equal ``want`` (0 for every
    count it does not name); returns fn's result."""
    from diffwave_sashimi_torch import ops
    for f in ops.COUNTED.values():
        f.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches[path] = {k: f.launches for k, f in ops.COUNTED.items()}
    expect = {k: want.get(k, 0) for k in ops.COUNTED}
    if launches[path] != expect:
        raise AssertionError(f"{path} launches {launches[path]}, expected "
                             f"{expect}")
    return out


def check_wide_mixers(torch, blk, L, dev, results):
    """Phase 24's kernel checks: the channel mixers (kernels 2, 3, 6, 7 and
    their f forms) vs their plain versions at the d_model 256 model's H
    1024 tier (B4, L 1000, the block's own weights), where the fp32 plans
    narrow P to fit one block (3 and 6 at 16, 7 at 8) and 3f, 6f and 7f
    run at P 16, and kernel 3 at F = 4H (seeded weights: ff 4, which
    only its chunked hidden rows take); timed.  Returns each kernel's P
    there."""
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.ops import chmix
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    bf = torch.bfloat16
    d = tier_inputs(torch, blk, L, gen, dev)
    H, lin = d["x"].shape[1], d["lin"]
    w = (d["w1"], d["b1"], d["w2"], d["b2"])
    for dt, tol, bpe in ((torch.float32, TOL_KERNEL, 4), (bf, TOL_BF16, 2)):
        x, y, g, skip = (d[k].to(dt) for k in ("x", "y", "g", "skip"))
        sfx = "_bf16" if dt == bf else ""
        cases = [
            ("glu_res", lambda: ops.mix_glu_res(y, x, lin.weight, lin.bias),
             lambda: ops.glu_res_ref(y, x, lin.weight, lin.bias)),
            ("ln_ff_res",
             lambda: ops.ln_ff_res(x, d["m2"], d["s2"], *w, skip, True),
             lambda: ops.ln_ff_res_ref(x, d["m2"], d["s2"], *w, skip, True)),
            ("glu_res_bwd",
             lambda: ops.glu_res_bwd(y, lin.weight, lin.bias, g),
             lambda: ops.glu_res_bwd_ref(y, lin.weight, lin.bias, g)),
            ("ln_ff_res_bwd",
             lambda: ops.ln_ff_res_bwd(x, d["m2"], d["s2"], *w, g),
             lambda: ops.ln_ff_res_bwd_ref(x, d["m2"], d["s2"], *w, g)),
        ]
        for name, kfn, pfn in cases:
            compare(name + sfx, H, L, kfn, pfn, 3, results, tol=tol, bpe=bpe)
    # kernel 3 at F = 4H (d_model 256 with ff 4), its hidden rows in chunks
    x = d["x"]
    w4 = (torch.randn(4 * H, H, device=dev, generator=gen) / math.sqrt(H),
          d["b1"].repeat(2), torch.randn(H, 4 * H, device=dev, generator=gen)
          / math.sqrt(4 * H), d["b2"])
    compare("ln_ff_res", H, L,
            lambda: ops.ln_ff_res(x, d["m2"], d["s2"], *w4, d["skip"], True),
            lambda: ops.ln_ff_res_ref(x, d["m2"], d["s2"], *w4, d["skip"],
                                      True),
            3, results, tier=f"H{H}_L{L}_F{4 * H}", F=4 * H)
    return {"glu": chmix.glu_tf32_plan(N_SAMPLES, H, L)[:2],
            "ff": chmix.ff_tf32_plan(H, 2 * H)[0],
            "glu_bwd": chmix.glu_bwd_tf32_plan(N_SAMPLES, H, L)[:2],
            "ff_bwd": chmix.ff_bwd_plan(H, 2 * H)[0],
            "glu_bf16": chmix.glu_bf16_plan(N_SAMPLES, H, L)[0],
            "ff_bf16": chmix.ff_bf16_plan(N_SAMPLES, H, 2 * H, L)[0],
            "glu_bwd_bf16": chmix.glu_bwd_bf16_plan(N_SAMPLES, H, L)[0],
            "ff_bwd_bf16": chmix.ff_bwd_bf16_plan(H, 2 * H)[0]}


def check_wide_s4_kernels(torch, model, dev, results):
    """Phase 24's kernels 4, 8, 5f, 6, 7, 3 and 2 (f32): vs their plain
    versions at every tier of the d_model 256 model (its own S4
    coefficients and weights, seeded inputs and cotangents), timed; beyond
    that as phases 3, 7 and 7b hold them (``hold_kernel_4``,
    ``hold_kernel_8``, ``hold_dkf``, ``hold_f32_mixers``, ``hold_ff``,
    ``hold_glu``)."""
    from diffwave_sashimi_torch import ops
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    for H, L, blk in tier_blocks(model):
        d = tier_inputs(torch, blk, L, gen, dev)
        args = (*d["quad"], d["z"], d["g_re"], d["g_im"])
        compare("cauchy", H, L,
                lambda: ops.cauchy_quad(*d["quad"], d["z"]).unbind(-1),
                lambda: ops.cauchy_quad_ref(*d["quad"], d["z"]), 3, results)
        hold_kernel_4(torch, d, f"H{H}_L{L}", results)
        compare("cauchy_bwd", H, L, lambda: ops.cauchy_bwd(*args),
                lambda: ops.cauchy_bwd_ref(*args), 3, results)
        hold_kernel_8(torch, d, f"H{H}_L{L}", results)
        hold_dkf(torch, "fftconv_dkf_bf16", d, results)
        ff = (d["x"], d["m2"], d["s2"], d["w1"], d["b1"], d["w2"], d["b2"],
              d["g"])
        glu = (d["y"], d["lin"].weight, d["lin"].bias, d["g"])
        compare("ln_ff_res_bwd", H, L, lambda: ops.ln_ff_res_bwd(*ff),
                lambda: ops.ln_ff_res_bwd_ref(*ff), 3, results)
        compare("glu_res_bwd", H, L, lambda: ops.glu_res_bwd(*glu),
                lambda: ops.glu_res_bwd_ref(*glu), 3, results)
        hold_f32_mixers(torch, d, f"H{H}_L{L}", results)
        gl = (d["y"], d["x"], d["lin"].weight, d["lin"].bias)
        compare("glu_res", H, L, lambda: ops.mix_glu_res(*gl),
                lambda: ops.glu_res_ref(*gl), 3, results)
        hold_glu(torch, gl, f"H{H}_L{L}", results)
        fwd = ff[:7] + (d["skip"],)
        compare("ln_ff_res", H, L, lambda: ops.ln_ff_res(*fwd, True),
                lambda: ops.ln_ff_res_ref(*fwd, True), 3, results)
        hold_ff(torch, fwd, f"H{H}_L{L}", results)
        del d, args, ff, glu, fwd, gl
        torch.cuda.empty_cache()


def check_wide_model(torch, dev, launches, results):
    """Phase 24: the d_model 256 SaShiMi (D256_CFG) from a seed: the
    channel mixers at its H 1024 tier (``check_wide_mixers``); at f32 and
    at bf16, one eps forward through the kernels against the plain path
    (TOL_EPS; bf16 TOL_EPS_BF16 x max|plain|) and one training step's
    loss and gradients against the plain path (TOL_GRAD; bf16
    TOL_GRAD_BF16 against the bf16 plain path), each run through the
    kernels with exact launch counts; the eps step timed both ways.
    Returns a dict."""
    from diffwave_sashimi_torch import ops
    t0 = time.perf_counter()
    model = build_model(torch, D256_CFG).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(SEED + 24)
    x = torch.randn(N_SAMPLES, 1, 16000, device=dev, generator=g)
    steps = torch.tensor([199, 120, 40, 3][:N_SAMPLES], device=dev)
    log(f"phase d256: d_model 256, n_layers 1, L 16000 built in "
        f"{time.perf_counter() - t0:.1f} s")
    H, L, blk = tier_blocks(model)[-1]
    with torch.no_grad():
        out = {f"plans_P_H{H}": check_wide_mixers(torch, blk, L, dev,
                                                  results)}
        check_wide_s4_kernels(torch, model, dev, results)
    log(f"phase d256 mixers: positions a block at H{H} "
        f"{json.dumps(out[f'plans_P_H{H}'])}")
    for label, m, want_eps, want_train in (
            ("f32", model, D256_EPS_LAUNCHES, D256_TRAIN_LAUNCHES),
            ("bf16", bf16_copy(torch, model), D256_EPS_BF16_LAUNCHES,
             D256_TRAIN_BF16_LAUNCHES)):
        sfx = "" if label == "f32" else "_bf16"
        with torch.no_grad():
            kf = m.compute_kernels(16000, ops.FUSED)
            kp = m.compute_kernels(16000, ops.PLAIN)
            eps = counted_run(torch, f"d256_eps{sfx}", want_eps, launches,
                              lambda: m(x, steps, kf, ops.FUSED))
            ref = m(x, steps, kp, ops.PLAIN)
            err, scale = max_err(eps, ref)
            if label == "f32":
                atol, rtol = TOL_EPS
                ok = bool(((eps - ref).abs() <= atol + rtol * ref.abs()).all())
            else:
                ok = err <= TOL_EPS_BF16 * scale
            ok = ok and bool(torch.isfinite(eps).all()) and scale > 0
            ms, plain_ms = paired_ms(lambda: m(x, steps, kf, ops.FUSED),
                                     lambda: m(x, steps, kp, ops.PLAIN), 3)
        log(f"phase d256 eps {label}: kernels vs plain max_abs_err {err:.3e} "
            f"(max|plain| {scale:.3e}) {'ok' if ok else 'FAIL'}; step "
            f"{ms:.3f} ms vs {plain_ms:.3f} ms plain at B{N_SAMPLES}")
        if not ok:
            raise AssertionError(f"d256 {label} eps through the kernels "
                                 f"disagrees")
        batch = grad_batch(torch, dev)
        loss, grads = counted_run(
            torch, f"d256_train{sfx}", want_train, launches,
            lambda: step_grads(torch, m, *batch, "FUSED"))
        loss_plain, grads_plain = step_grads(torch, m, *batch, "PLAIN")
        r = {"eps_max_abs_err": err, "eps_max_abs_plain": scale,
             "step_ms": ms, "step_plain_ms": plain_ms, "loss": loss,
             "loss_plain": loss_plain}
        if label == "f32":
            r["grad_worst_of_bound"] = hold_gradients(
                "d256 grads f32", {"FUSED": loss, "PLAIN": loss_plain},
                {"FUSED": grads, "PLAIN": grads_plain})[0]
        else:
            r["grads_vs_plain"] = dist = grad_distance(grads, grads_plain)
            ok = all(bool(torch.isfinite(v).all()) for v in grads.values()) \
                and all(dist[k] <= TOL_GRAD_BF16[k] for k in TOL_GRAD_BF16) \
                and abs(loss - loss_plain) <= TOL_GRAD_BF16["entry"] * abs(
                    loss_plain)
            log(f"phase d256 grads bf16: {json.dumps(r)} (bars "
                f"{TOL_GRAD_BF16}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("d256 bf16 gradients through the "
                                     "kernels disagree")
        out[label] = r
    del model
    torch.cuda.empty_cache()
    return out


def profile_train_step(torch, model, dev, steps=2):
    """Phase 11: a torch.profiler trace of ``steps`` training steps with the
    kernels (see :func:`trace_steps`), kernel 8's kernels, kernel 7's
    parts (its pass, the 3xTF32 contractions of kernels 6 and 7, the sums)
    and kernel 6's pass summed apart."""
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.diffusion.schedule import schedule_from_cfg
    from diffwave_sashimi_torch.runtime.train import make_optimizer, train_step
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    audio = 0.3 * torch.randn(N_SAMPLES, 1, 16000, device=dev, generator=g)
    schedule = schedule_from_cfg(DIFFUSION_CFG)
    optim = make_optimizer(model, 2e-4)
    groups = dict(KERNEL_8_GROUPS, **KERNEL_1_GROUPS)
    groups.update({f"ln_ff_res_bwd_{part}": (lambda n, names=names:
                                             in_group(n, names))
                   for part, names in KERNELS_7.items()})
    groups["glu_res_bwd_pass"] = lambda n: in_group(n, KERNELS_6["pass"])
    trace = trace_steps(
        torch, lambda: train_step(model, optim, audio, schedule, g,
                                  ops.FUSED), steps, groups=groups)
    check_training_trace(trace, "f32")
    return trace


def check_training_trace(trace, label):
    """Raise unless a traced training step ran kernel 4's kernel, kernel
    8's lanes kernel and kernel 5's (f32) or 5f's (bf16) radix-16 kernel,
    and (f32) kernels 7's and 3's 3xTF32 kernels (KERNEL_7_TF32,
    KERNELS_3), or when the profiler recorded no device time."""
    if trace is None:
        raise AssertionError(f"the profiler recorded no device time in the "
                             f"{label} training step")
    names = trace["port_kernels_by_name_ms_per_step"]
    if not any(in_group(n, (KERNEL_4,)) for n in names):
        raise AssertionError(f"the {label} training step's kernel 4 is not "
                             f"{KERNEL_4}: {sorted(names)}")
    if not any(in_group(n, KERNELS_8[:1]) for n in names):
        raise AssertionError(f"the {label} training step's kernel 8 is not "
                             f"its lanes kernel: {sorted(names)}")
    if not any(n.startswith("fftconv_dkf_r16_kernel")
               and ("bfloat16" in n) == (label == "bf16") for n in names):
        raise AssertionError(f"the {label} training step's kernel 5 is not "
                             f"its radix-16 kernel: {sorted(names)}")
    for k, tf32 in (("7", KERNEL_7_TF32),
                    ("3", [n for g in KERNELS_3.values() for n in g])):
        if label == "f32" and not all(any(in_group(n, (t,)) for n in names)
                                      for t in tf32):
            raise AssertionError(f"the f32 training step's kernel {k} is not "
                                 f"its 3xTF32 kernels {tf32}: "
                                 f"{sorted(names)}")


def trace_steps(torch, step, steps=2, groups=None):
    """A torch.profiler trace of ``steps`` calls of ``step`` after two
    untraced ones, behind TRACE_LEAD launches inside the trace that it
    does not account for (see TRACE_RANGE).  Returns the device time by kernel
    name (ms per step),
    the share of it in the port's kernels and their launches a step, and
    the device's idle share of the window from the first kernel's start to
    the last one's end; with
    ``groups`` (label -> predicate on a kernel's short name), also the
    device time of each group and of the rest.  A trace in which a kernel
    launch of the host has no device event is logged and taken again, up
    to TRACE_ATTEMPTS traces; raises if the last is still short; returns
    None if it holds no device time."""
    from torch.profiler import ProfilerActivity, profile, record_function
    for _ in range(2):
        step()
    lead = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_LEAD):
                lead.add_(1)
            torch.cuda.synchronize()
            with record_function(TRACE_RANGE):
                for _ in range(steps):
                    step()
                torch.cuda.synchronize()
        kern, calls, extra, short = launch_gaps(torch, prof.events())
        if not kern:
            return None
        if not short:
            break
        log(f"trace attempt {attempt} of {TRACE_ATTEMPTS} lacks {short}")
    else:
        raise AssertionError(f"the profiler's trace lacks kernels after "
                             f"{TRACE_ATTEMPTS} attempts: {short}")
    first_ms = None if not calls else (
        min(e.time_range.start for e in kern)
        - min(e.time_range.start for e in calls)) / 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, (cur_a, cur_b) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    window = spans[-1][1] - spans[0][0]
    by_name, count = {}, {}
    for e in kern:
        name = short_name(e.name)
        by_name[name] = by_name.get(name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3 / steps
        count[name] = count.get(name, 0) + 1 / steps
    port = {name: ms for name, ms in by_name.items()
            if name.split("<")[0] in PORT_KERNELS}
    glu_bf16, ff_bf16 = (sum(ms for name, ms in port.items()
                             if in_group(name, group))
                         for group in (KERNELS_2F, KERNELS_3F))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    split = None
    if groups:
        split = {label: sum(ms for name, ms in by_name.items() if pred(name))
                 for label, pred in groups.items()}
        split["rest"] = sum(by_name.values()) - sum(split.values())
    return {"window_ms_per_step": window / 1e3 / steps,
            "trace_attempts": attempt, "kernel_launch_calls": len(calls),
            **extra,
            "first_launch_to_kernel_ms": first_ms,
            "device_busy_ms_per_step": busy / 1e3 / steps,
            "idle_share": 1.0 - busy / window,
            "port_kernels_ms_per_step": sum(port.values()),
            "other_kernels_ms_per_step": sum(by_name.values())
            - sum(port.values()),
            "launches_per_step": len(kern) / steps,
            "port_kernels_by_name_ms_per_step": port,
            "port_launches_per_step": {name: count[name] for name in port},
            "glu_res_bf16_ms_per_step": glu_bf16,
            "ln_ff_res_bf16_ms_per_step": ff_bf16,
            "top_kernels_ms_per_step": dict(top),
            "groups_ms_per_step": split}


def launch_gaps(torch, events):
    """A trace's device kernels of positive duration (all but the lead's,
    see TRACE_RANGE), the host's kernel launch calls inside its
    TRACE_RANGE range, the number of device events of no positive
    duration and of the lead's launches with no device event, and None,
    or what the profiler lost of those launches: the launches (by order,
    and ms into the launches) with no correlated device event, the first
    device events (correlation id, name, start in ms after the first
    launch, duration in us) and the least, middle and largest start of a
    kernel after its launch in ms.  A device event of no positive
    duration counts as recorded; the trace's device time leaves it out."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    span = next(e.time_range for e in events
                if e.name == TRACE_RANGE and e.device_type == cpu)
    launched = [e for e in events
                if e.device_type == cpu and LAUNCH_API.match(e.name)]
    before = {e.id for e in events if e.device_type == cpu
              and e.name.startswith("cu") and e.time_range.start < span.start}
    calls = sorted((e for e in launched
                    if span.start <= e.time_range.start <= span.end),
                   key=lambda e: e.time_range.start)
    dev = [e for e in events if e.device_type == cuda
           and not e.is_user_annotation and e.id not in before]
    kern = [e for e in dev if e.time_range.end > e.time_range.start]
    by_id = {e.id: e for e in dev}
    lost, after = [], []
    for i, c in enumerate(calls):
        k = by_id.get(c.id)
        if k is None:
            lost.append((i, round((c.time_range.start
                                   - calls[0].time_range.start) / 1e3, 3)))
        else:
            after.append((k.time_range.start - c.time_range.start) / 1e3)
    extra = {"device_events_of_no_duration": len(dev) - len(kern),
             "lead_launches_lost": len({
                 e.id for e in launched if e.id in before} - {
                 e.id for e in events if e.device_type == cuda})}
    if not lost:
        return kern, calls, extra, None
    after.sort()
    t0 = calls[0].time_range.start
    first = sorted(dev, key=lambda e: e.time_range.start)[:3]
    return kern, calls, extra, {
        "launches": len(calls), "device_events": len(dev),
        "lost": lost[:8], "n_lost": len(lost),
        "first_launch_ids": [c.id for c in calls[:3]],
        "first_device_events": [
            (e.id, short_name(e.name)[:40],
             round((e.time_range.start - t0) / 1e3, 3),
             round(e.time_range.end - e.time_range.start, 3))
            for e in first],
        "start_after_launch_ms": [round(after[j], 3) for j in
                                  (0, len(after) // 2, -1)] if after
        else None}


def in_group(name, group):
    """Whether a kernel's short name is one of ``group``: by its full
    name, or by its template's name."""
    return name in group or name.split("<")[0] in group


def short_name(name):
    """A device kernel's name without its return type, namespace and
    parameter list, e.g. ``ln_ff_res_kernel<128>``; at most 80 chars."""
    name = name.removeprefix("void ").removeprefix("(anonymous namespace)::")
    return name.split("(")[0][:80]


def time_train_step(torch, model, dev):
    """Phase 10: one training step (forward, backward, Adam) with the
    kernels and plain, at the main path's batch; returns (ms, plain ms)."""
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.diffusion.schedule import schedule_from_cfg
    from diffwave_sashimi_torch.runtime.train import make_optimizer, train_step
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    audio = 0.3 * torch.randn(N_SAMPLES, 1, 16000, device=dev, generator=g)
    schedule = schedule_from_cfg(DIFFUSION_CFG)
    optim = make_optimizer(model, 2e-4)
    return paired_ms(
        lambda: train_step(model, optim, audio, schedule, g, ops.FUSED),
        lambda: train_step(model, optim, audio, schedule, g, ops.PLAIN), 3)


def time_train_step_bf16(torch, model, dev):
    """Phase 10b: the bf16 training step (forward, backward, Adam) with the
    kernels, against its plain path and against the f32 step with the
    kernels, each pair timed in turns in this call, at the main path's
    batch; then a trace of two bf16 steps, with kernel 7f's pass, 6f's
    pass, the weight-gradient contractions and the reductions apart from
    the rest.  Returns a dict."""
    import copy
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.diffusion.schedule import schedule_from_cfg
    from diffwave_sashimi_torch.runtime.train import make_optimizer, train_step
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    audio = 0.3 * torch.randn(N_SAMPLES, 1, 16000, device=dev, generator=g)
    schedule = schedule_from_cfg(DIFFUSION_CFG)
    bfm, fm = bf16_copy(torch, model), copy.deepcopy(model)
    opt_b, opt_f = make_optimizer(bfm, 2e-4), make_optimizer(fm, 2e-4)

    def bf16_step(o=ops.FUSED):
        return train_step(bfm, opt_b, audio, schedule, g, o)
    out = {}
    out["ms"], out["plain_ms"] = paired_ms(
        bf16_step, lambda: bf16_step(ops.PLAIN), 3)
    out["ms_vs_f32"], out["f32_ms"] = paired_ms(
        bf16_step, lambda: train_step(fm, opt_f, audio, schedule, g,
                                      ops.FUSED), 3)
    # kernel 7f's pass and 6f's and, apart, the weight-gradient
    # contractions (of 6f and 7f) and the reductions, as KERNELS_7F and
    # KERNELS_6F name them; 6f's pass must be its tensor-core kernel, with
    # no kernel-6 instance on this bf16 path
    groups = {f"ln_ff_res_bwd_bf16_{part}": (lambda n, names=names:
                                             in_group(n, names))
              for part, names in KERNELS_7F.items()}
    groups["glu_res_bwd_bf16_pass"] = (
        lambda n: in_group(n, KERNELS_6F["pass"]))
    groups.update(KERNEL_1F_GROUPS)
    groups.update(KERNEL_5F_GROUPS)
    groups.update(KERNEL_8_GROUPS)
    groups.update(KERNEL_4_GROUPS)
    out["trace"] = trace_steps(torch, bf16_step, groups=groups)
    check_training_trace(out["trace"], "bf16")
    if out["trace"] is not None:
        names = out["trace"]["port_kernels_by_name_ms_per_step"]
        if (any(in_group(n, ("glu_res_bwd_kernel",)) for n in names)
                or not all(any(in_group(n, (k,)) for n in names)
                           for k in KERNELS_6F["pass"])):
            raise AssertionError(f"the bf16 training step's 6f pass is not "
                                 f"its tensor-core kernel: {sorted(names)}")
    log(f"timing: bf16 training step at B{N_SAMPLES} {out['ms']:.3f} ms with "
        f"kernels vs {out['plain_ms']:.3f} ms plain; {out['ms_vs_f32']:.3f} "
        f"ms vs the f32 step's {out['f32_ms']:.3f} ms in turns")
    log("trace: bf16 training step with the kernels: " + (
        "no device time in the profiler's events (not measured)"
        if out["trace"] is None else json.dumps(out["trace"])))
    if out["trace"] is not None:
        tr = out["trace"]
        busy = tr["device_busy_ms_per_step"]
        for label, key in (("kernel 5f", "fftconv_dkf_bf16"),
                           ("kernel 4", "cauchy"),
                           ("PyTorch's elementwise copies", "copies")):
            ms = tr["groups_ms_per_step"][key]
            log(f"trace: {label} {ms:.3f} ms of {busy:.3f} busy ms a bf16 "
                f"training step ({ms / busy:.2%})")
    return out


def write_utterance(path, pitch=1.0):
    """Phase 12: a seeded synthetic utterance of VOC_SECONDS at 22050 Hz,
    int16: five harmonics of a gliding pitch (times ``pitch``), a chirp
    and noise."""
    import numpy as np
    from scipy.io import wavfile
    sr = VOC_DATASET_CFG["sampling_rate"]
    n = int(VOC_SECONDS * sr)
    t = np.arange(n) / sr
    f0 = pitch * (120.0 + 30.0 * np.sin(2 * np.pi * 0.4 * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(0.2 / k * np.sin(k * phase) for k in range(1, 6))
    wav = wav + 0.05 * np.sin(2 * np.pi * (200.0 + 300.0 * t) * t)
    wav = wav + 0.01 * np.random.RandomState(SEED).randn(n)
    wavfile.write(path, sr, (0.5 * 32767 * wav / np.abs(wav).max())
                  .astype(np.int16))


def run_vocoder(torch, root, launches, dev):
    """Phases 12-14: the vocoder checkpoint and utterance, vocoding through
    generate() with its launch counts (13b: the shipped command at bf16),
    the precomputed-mel route.  Returns (model, mel (1, 80, frames) numpy,
    audio length, {path: generate() wall s})."""
    import numpy as np
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.data import mel2samp
    from diffwave_sashimi_torch.runtime.checkpoint import save_checkpoint
    from diffwave_sashimi_torch.runtime.generate import (generate,
                                                         resolve_condition)
    from diffwave_sashimi_torch.utils.exp import local_directory
    t0 = time.perf_counter()
    model = build_model(torch, VOC_MODEL_CFG)
    run, ckpt = local_directory(None, VOC_MODEL_CFG, VOC_DIFFUSION_CFG,
                                VOC_DATASET_CFG, "checkpoint")
    save_checkpoint(ckpt, 1000, model)
    data = os.path.join(root, "wavs")
    os.makedirs(data)
    write_utterance(os.path.join(data, VOC_MEL + ".wav"))
    dataset = dict(VOC_DATASET_CFG, data_path=data)
    log(f"phase vocoder model: {run} built and saved, utterance written, "
        f"in {time.perf_counter() - t0:.1f} s")

    for fn in ops.COUNTED.values():
        fn.launches = 0
    t0 = time.perf_counter()
    audio = generate(VOC_DIFFUSION_CFG, VOC_MODEL_CFG, dataset,
                     ckpt_iter="max", n_samples=VOC_SAMPLES,
                     mel_name=VOC_MEL, seed=SEED, device=dev)
    gen_s = time.perf_counter() - t0
    launches["vocode"] = {k: f.launches for k, f in ops.COUNTED.items()}
    log(f"phase vocode: {gen_s:.2f} s wall; launches {launches['vocode']}")
    want = {k: VOC_LAUNCHES.get(k, 0) for k in ops.COUNTED}
    if launches["vocode"] != want:
        raise AssertionError(f"vocoding launches {launches['vocode']}, "
                             f"expected {want}")
    hop = VOC_DATASET_CFG["hop_length"]
    frames = 1 + int(VOC_SECONDS * VOC_DATASET_CFG["sampling_rate"]) // hop
    L = frames * hop
    if audio.shape != (VOC_SAMPLES, 1, L) or not np.isfinite(audio).all():
        raise AssertionError(f"bad vocoder output {audio.shape}")
    with open(os.path.join("exp", run, "waveforms", "1000",
                           "fidelity.json")) as f:
        fidelity = json.load(f)
    log(f"output: shape {audio.shape}, finite, std {audio.std():.4f}; "
        f"fidelity.json {fidelity}")
    secs = {"vocode": gen_s,
            "vocode_bf16": run_shipped_vocoding(torch, run, data, L,
                                                launches)}

    mels = os.path.join(root, "mels")
    n = mel2samp.main(["experiment=ljspeech", f"dataset.data_path={data}",
                       f"+output_dir={mels}"])
    pre, L_pre = resolve_condition(dataset, mels, VOC_MEL)
    mel, L_fly = resolve_condition(dataset, None, VOC_MEL)
    log(f"phase mel_path: {n} mel written by the mel2samp CLI, shape "
        f"{pre.shape}, equal to the mel computed on the fly: "
        f"{np.array_equal(pre, mel)}")
    if n != 1 or not np.array_equal(pre, mel) or not L_pre == L_fly == L:
        raise AssertionError("the precomputed mel differs")
    return model.to(dev).eval(), mel, L, secs


def run_shipped_command_counted(torch, path, argv, want, launches):
    """``runtime.generate.main(argv)`` with every launch count set to 0
    just before and read just after into ``launches[path]``, which must
    equal ``want`` (0 for every kernel it does not name).  Returns its wall
    seconds."""
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.runtime import generate as generate_mod
    for fn in ops.COUNTED.values():
        fn.launches = 0
    t0 = time.perf_counter()
    generate_mod.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches[path] = {k: f.launches for k, f in ops.COUNTED.items()}
    log(f"phase {path}: main({argv}) {secs:.2f} s wall; launches "
        f"{launches[path]}")
    expect = {k: want.get(k, 0) for k in ops.COUNTED}
    if launches[path] != expect:
        raise AssertionError(f"{path} launches {launches[path]}, expected "
                             f"{expect}")
    return secs


def read_wavs(run, n, L, label):
    """The n wavs ``1k_<i>.wav`` of checkpoint 1000 in ``exp/<run>``; each
    must hold L finite samples."""
    import numpy as np
    from scipy.io import wavfile
    wav_dir = os.path.join("exp", run, "waveforms", "1000")
    wavs = [wavfile.read(os.path.join(wav_dir, f"1k_{i}.wav"))[1]
            for i in range(n)]
    if any(w.shape != (L,) or not np.isfinite(w).all() for w in wavs):
        raise AssertionError(f"bad {label} output")
    log(f"output: {n} wavs of {L} samples, finite, std {np.std(wavs):.4f}")
    return wav_dir


def run_shipped_vocoding(torch, run, data, L, launches):
    """Phase 13b: the shipped vocoding command with no precision override
    (bf16) on phase 12's checkpoint and utterance: exact launch counts,
    finite wavs of L samples, a fidelity.json.  Returns its wall s."""
    shutil.rmtree(os.path.join("exp", run, "waveforms"))
    secs = run_shipped_command_counted(
        torch, "vocode_bf16", ["experiment=ljspeech",
                               f"generate.n_samples={VOC_SAMPLES}",
                               f"dataset.data_path={data}"],
        VOC_BF16_LAUNCHES, launches)
    wav_dir = read_wavs(run, VOC_SAMPLES, L, "bf16 vocoding")
    with open(os.path.join(wav_dir, "fidelity.json")) as f:
        log(f"fidelity.json {json.load(f)}")
    return secs


def check_vocoder_kernels(torch, model, L, dev, results):
    """Phase 15: kernel 9 (both entries; 15b: 9f) at the top and middle
    tiers and at n 4096, kernel 1 at the deepest tier (n 16384 < 2L), and
    kernels 2 and 3 (15b: and 3f) at the vocoder's tiers, against their
    plain versions, timed; kernel 3 beyond that by ``hold_ff``."""
    from diffwave_sashimi_torch import ops
    fl = importlib.import_module("diffwave_sashimi_torch.ops.fftconv_long")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    (H0, _, b0), (H1, _, b1), (H2, _, b2) = tier_blocks(model)
    B = VOC_SAMPLES
    clusters = {str(fl.cluster_plan(n).cluster): fl.max_active_clusters(n)
                for n in fl.CLUSTER_SIZES}
    log(f"phase 15: clusters of 9f's cluster kernel the card holds at once "
        f"(cudaOccupancyMaxActiveClusters), by blocks a cluster: "
        f"{json.dumps(clusters)}")
    if not all(clusters.values()):
        raise AssertionError(f"a cluster size the card cannot hold: "
                             f"{clusters}")
    # 9f's cluster route at n 2^17 and 2^16, its three passes at n 2^18,
    # 4096 and 2^19; the f32 forms' three passes at every n
    for H, Lt, blk in ((H0, L, b0), (H0, VOC_L_2_17, b0), (H1, L // 4, b1),
                       (H2, 3000, b2), (H0, VOC_L_2_19, b0)):
        d = conv_inputs(torch, blk, Lt, B, gen, dev)
        x, a, c, bias, D = d["x"], d["a"], d["c"], d["bias"], d["D"]
        kp = ops.long_spectrum(d["khat"])
        log(f"phase 15: H{H} L{Lt} n {d['n']}: 9f {fl.long_plan(d['n'])}")
        compare("fftconv_long_ln_bias_gelu_d", H, Lt,
                lambda: ops.fftconv_long_ln_bias_gelu_d(x, a, c, bias, kp, D),
                lambda: ops.fftconv_long_ln_bias_gelu_d_ref(x, a, c, bias,
                                                            kp, D),
                10, results, B, d["n"])
        hold_9_f32(torch, fl, f"H{H}_L{Lt}", d["n"], (x, a, c, bias, kp, D),
                   results)
        compare("fftconv_long", H, Lt, lambda: ops.fftconv_long(x, kp),
                lambda: ops.fftconv_long_ref(x, kp), 10, results, B, d["n"])
        xb = x.to(torch.bfloat16)
        ref = ops.fftconv_long_ln_bias_gelu_d_bf16_ref(xb, a, c, bias, kp, D)
        compare("fftconv_long_ln_bias_gelu_d_bf16", H, Lt,
                lambda: ops.fftconv_long_ln_bias_gelu_d_bf16(xb, a, c, bias,
                                                             kp, D),
                lambda: ops.fftconv_long_ln_bias_gelu_d_bf16_ref(
                    xb, a, c, bias, kp, D),
                10, results, B, d["n"], tol=TOL_BF16, bpe=2)
        if d["n"] in fl.CLUSTER_SIZES:
            half = d["khat"]
            cufft_ms = cuda_ms(lambda: torch.fft.irfft(
                torch.fft.rfft(x, n=d["n"]) * half, n=d["n"])[..., :Lt], 10)
            hold_9f_routes(torch, fl, f"H{H}_L{Lt}", d["n"],
                           lambda p: fl.launch_sampling(xb, a, c, bias, kp,
                                                        D, p),
                           ref, cufft_ms, results)
        del d, x, xb, kp, ref
        torch.cuda.empty_cache()
    results["fftconv_long_ln_bias_gelu_d_bf16"]["max_active_clusters"] = \
        clusters
    for H, Lt, blk in ((H0, L, b0), (H1, L // 4, b1), (H2, L // 16, b2)):
        d = conv_inputs(torch, blk, Lt, B, gen, dev)
        x, a, c, bias, D = d["x"], d["a"], d["c"], d["bias"], d["D"]
        if blk is b2:
            compare("fftconv_ln_bias_gelu_d", H, Lt,
                    lambda: ops.fftconv_ln_bias_gelu_d(x, a, c, bias,
                                                       d["khat"], D),
                    lambda: ops.fftconv_ln_bias_gelu_d_ref(x, a, c, bias,
                                                           d["khat"], D),
                    10, results, B, d["n"])
            # 1 and 1f at n 16384 with L 8960 > n/2: the whole transform
            xb, conv = x.to(torch.bfloat16), (a, c, bias, d["khat"], D)
            fc = importlib.import_module("diffwave_sashimi_torch.ops.fftconv")
            hold_1_routes(torch, "fftconv_ln_bias_gelu_d", f"H{H}_L{Lt}",
                          d["n"], lambda p: fc.launch_sampling(x, *conv, p),
                          ops.fftconv_ln_bias_gelu_d_ref(x, *conv),
                          direct_conv_f64(torch, x, *conv, fast=False),
                          cufft_conv_ms(torch, x, d["khat"], Lt), results)
            compare("fftconv_ln_bias_gelu_d_bf16", H, Lt,
                    lambda: ops.fftconv_ln_bias_gelu_d_bf16(xb, *conv),
                    lambda: ops.fftconv_ln_bias_gelu_d_ref(xb, *conv),
                    10, results, B, d["n"], tol=TOL_BF16, bpe=2)
            hold_1f_routes(torch, "fftconv_ln_bias_gelu_d_bf16",
                           f"H{H}_L{Lt}", d["n"],
                           lambda p: fc.launch_sampling(xb, *conv, p),
                           ops.fftconv_ln_bias_gelu_d_ref(xb, *conv),
                           cufft_conv_ms(torch, x, d["khat"], Lt), results)
        lin, ff1, ff2 = blk.layer.output_linear[0], *(blk.ff["ff"][i]
                                                     for i in (0, 2))
        ff = (x, blk.norm2.m, blk.norm2.s, ff1.effective_weight()[:, :, 0],
              ff1.bias, ff2.effective_weight()[:, :, 0], ff2.bias, x, True)
        compare("glu_res", H, Lt,
                lambda: ops.mix_glu_res(x, x, lin.weight, lin.bias),
                lambda: ops.glu_res_ref(x, x, lin.weight, lin.bias),
                10, results, B, d["n"])
        hold_glu(torch, (x, x, lin.weight, lin.bias), f"H{H}_L{Lt}", results)
        compare("ln_ff_res", H, Lt, lambda: ops.ln_ff_res(*ff),
                lambda: ops.ln_ff_res_ref(*ff), 10, results, B, d["n"])
        hold_ff(torch, ff[:8], f"H{H}_L{Lt}", results)
        xb = x.to(torch.bfloat16)
        ffb = (xb,) + ff[1:7] + (xb, True)
        compare("ln_ff_res_bf16", H, Lt, lambda: ops.ln_ff_res_bf16(*ffb),
                lambda: ops.ln_ff_res_ref(*ffb), 10, results, B, d["n"],
                tol=TOL_BF16, bpe=2)
        compare("glu_res_bf16", H, Lt,
                lambda: ops.mix_glu_res_bf16(xb, xb, lin.weight, lin.bias),
                lambda: ops.glu_res_ref(xb, xb, lin.weight, lin.bias),
                10, results, B, d["n"], tol=TOL_BF16, bpe=2)
        gemm_ms(torch, "glu_res_bf16", results, f"H{H}_L{Lt}", lin.weight,
                xb)
        time_ff_weight_designs(torch, ffb, results["ln_ff_res_bf16"],
                               f"H{H}_L{Lt}")


def hold_9_f32(torch, fl, tier, n, args, results):
    """Phase 15 at each n: kernel 9's f32 sampling form beyond
    ``compare``'s bar: two calls bit-equal, its float64 L2 error at most
    twice the plain version's; its time in a CUDA graph (``graph_ms``) and
    a cuFFT conv's of the same shapes with no prologue or epilogue
    (``cufft_conv_ms``), a yardstick the port never calls."""
    x, a, c, bias, kp, D = args
    L = x.shape[-1]
    one, two = (fl.launch_sampling(*args) for _ in range(2))
    torch.cuda.synchronize()
    if not torch.equal(one, two):
        raise AssertionError(f"kernel 9 (f32) {tier}: two calls differ")
    ref = fl.fftconv_long_ln_bias_gelu_d_ref(*args)
    r64 = fl.fftconv_long_ln_bias_gelu_d_ref(
        *(t.to(torch.complex128 if t.is_complex() else torch.float64)
          for t in args))
    (e_k,), (e_p,) = c64_err([one], [r64]), c64_err([ref], [r64])
    del one, two, r64, ref
    ms = {"graph_ms": graph_ms(torch, lambda: fl.launch_sampling(*args)),
          "cufft_conv_ms": graph_ms(torch, lambda: torch.fft.irfft(
              torch.fft.rfft(x, n=n) * fl.half_spectrum(kp), n=n)[..., :L])}
    t = results["fftconv_long_ln_bias_gelu_d"]["tiers"][tier]
    t.update(c64_err=e_k, plain_c64_err=e_p, repeat_bit_equal=True, **ms)
    log(f"kernel 9 (f32) {tier}: two calls bit-equal; error vs float64 "
        f"{e_k:.3e} (plain {e_p:.3e}; bar 2x) "
        f"{'ok' if e_k <= 2 * e_p else 'FAIL'}; in CUDA graphs "
        f"{json.dumps(ms)}")
    if e_k > 2 * e_p:
        raise AssertionError(f"kernel 9 (f32)'s float64 error {e_k:.3e} is "
                             f"over twice the plain version's {e_p:.3e} at "
                             f"{tier}")


def hold_9f_routes(torch, fl, tier, n, launch, ref, cufft_ms, results):
    """Phase 15b at a size the cluster kernel has an instance for: 9f on
    its cluster route, two calls bit-equal; 9f on the route long_plan does
    not take at n (the three passes at 2^16 and 2^17, the cluster at 2^18)
    held against the plain version ``ref`` at TOL_BF16 and timed in turns
    with the route it takes (``three_pass_ms`` or ``cluster_ms``, beside
    ``ms_vs_three_pass`` or ``ms_vs_cluster``); a cuFFT conv of the same
    shapes, with no prologue or epilogue (``cufft_conv_ms``).  The two are
    yardsticks, not library calls of the function: the port calls
    neither."""
    cluster, shipped = fl.cluster_plan(n), fl.long_plan(n)
    other = fl.THREE_PASS if shipped == cluster else cluster
    one, two = launch(cluster), launch(cluster)
    alt = launch(other)
    torch.cuda.synchronize()
    if not torch.equal(one, two):
        raise AssertionError(f"kernel 9f {tier}: two calls differ")
    err, scale = max_err(alt, ref)
    if not (err <= TOL_BF16 * max(1.0, scale)
            and bool(torch.isfinite(alt).all())):
        raise AssertionError(f"kernel 9f {tier} on its {other.route} route "
                             f"disagrees: {err:.3e} of {scale:.3e}")
    ms, other_ms = paired_ms(lambda: launch(shipped), lambda: launch(other),
                             10)
    t = results["fftconv_long_ln_bias_gelu_d_bf16"]["tiers"][tier]
    t.update({f"{other.route}_ms": other_ms, f"ms_vs_{other.route}": ms,
              f"{other.route}_max_abs_err": err, "cufft_conv_ms": cufft_ms})
    log(f"kernel 9f {tier}: cluster route, two calls bit-equal; its "
        f"{shipped.route} route {ms:.4f} ms vs the {other.route} route "
        f"{other_ms:.4f} ms in turns (that one {err:.3e} of {scale:.3e} "
        f"off the plain version); cuFFT conv {cufft_ms:.4f} ms")


def check_eps(torch, model, x, steps, label, kernels=([], []), **cond):
    """eps through the kernels (ops.FUSED, with kernels[0]) against the
    plain path (ops.PLAIN, with kernels[1]) on the same inputs, at TOL_EPS;
    returns the max abs error."""
    from diffwave_sashimi_torch import ops
    eps = model(x, steps, kernels[0], ops.FUSED, **cond)
    eps_plain = model(x, steps, kernels[1], ops.PLAIN, **cond)
    err, scale = max_err(eps, eps_plain)
    atol, rtol = TOL_EPS
    ok = bool(torch.isfinite(eps).all()) and bool(
        ((eps - eps_plain).abs() <= atol + rtol * eps_plain.abs()).all())
    log(f"phase {label}: kernels vs plain max_abs_err {err:.3e} "
        f"(max|plain| {scale:.3e}, atol {atol} rtol {rtol}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok or scale == 0.0:
        raise AssertionError(f"{label} through the kernels disagrees")
    return err


def check_vocoder_step(torch, model, mel, L, dev):
    """Phases 16 and 17: one vocoder eps forward through the kernels
    against the plain path; then the step timed both ways at B2 and
    traced.  Returns (ms, plain ms, trace)."""
    from diffwave_sashimi_torch import ops
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    B = VOC_SAMPLES
    x = torch.randn(B, 1, L, device=dev, generator=g)
    steps = torch.tensor([49, 7][:B], device=dev)
    conds = model.compute_mel_conds(torch.from_numpy(mel).to(dev), L)
    k_fused = model.compute_kernels(L, ops.FUSED)
    k_plain = model.compute_kernels(L, ops.PLAIN)
    check_eps(torch, model, x, steps, "vocoder eps", (k_fused, k_plain),
              mel_conds=conds)
    ms, plain_ms = paired_ms(
        lambda: model(x, steps, k_fused, ops.FUSED, mel_conds=conds),
        lambda: model(x, steps, k_plain, ops.PLAIN, mel_conds=conds), 3)
    trace = trace_steps(
        torch, lambda: model(x, steps, k_fused, ops.FUSED, mel_conds=conds),
        groups=dict(KERNEL_9_GROUPS, **KERNEL_1_GROUPS))
    kernel_9_route(trace, "vocoder step", cluster=False)
    return ms, plain_ms, trace


def kernel_9_route(trace, label, cluster):
    """A vocoder step's trace went through kernel 9's three passes (the
    top tier, n 2^18) and, where ``cluster`` (9f's middle tier, n 2^16),
    through the cluster kernel, and else not; records each route's share
    of the device's busy time; raises on a trace with no device time."""
    if trace is None:
        raise AssertionError(f"the profiler recorded no device time in the "
                             f"{label}")
    split, busy = trace["groups_ms_per_step"], trace["device_busy_ms_per_step"]
    ms = {route: split[f"kernel_9_{route}"]
          for route in ("cluster", "three_pass")}
    for route, t in ms.items():
        trace[f"kernel_9_{route}_share"] = t / busy
    log(f"trace: {label}: kernel 9's {KERNEL_9_CLUSTER} {ms['cluster']:.3f}"
        f" ms a step ({ms['cluster'] / busy:.3f} of the device's busy "
        f"time), its three passes {ms['three_pass']:.3f} ms "
        f"({ms['three_pass'] / busy:.3f})")
    if ms["three_pass"] <= 0 or (ms["cluster"] > 0) != cluster:
        raise AssertionError(f"{label}: kernel 9 off its routes")


def quality_gate(torch, label, x32, xq):
    """x_0 of a reduced precision vs f32's over the same noise: corr must
    reach CORR_MIN.  Returns the numbers."""
    corr = float(torch.corrcoef(torch.stack([xq.flatten(),
                                             x32.flatten()]))[0, 1])
    q = {"corr": corr, "max_abs_diff": float((xq - x32).abs().max()),
         "signal_std": float(x32.std())}
    ok = corr >= CORR_MIN and bool(torch.isfinite(xq).all())
    log(f"phase quality {label}: x_0 vs f32: corr {corr:.7f} (gate "
        f"{CORR_MIN}), max abs diff {q['max_abs_diff']:.4f} on signal std "
        f"{q['signal_std']:.4f} {'ok' if ok else 'FAIL'}")
    return q, ok


def check_eps_bf16(torch, bfm, args, fused, plain, label):
    """bf16 eps through the kernels vs the bf16 plain path, max abs error
    <= TOL_EPS_BF16 x max|plain|; ``fused`` and ``plain`` are (kernels,
    ops).  Returns (max abs err, max|plain|)."""
    eps = bfm(*args, *fused[:2], **fused[2])
    ref = bfm(*args, *plain[:2], **plain[2])
    err, scale = max_err(eps, ref)
    ok = eps.dtype == torch.float32 and bool(torch.isfinite(eps).all()) \
        and 0 < scale and err <= TOL_EPS_BF16 * scale
    log(f"phase {label}: kernels vs the bf16 plain path max_abs_err "
        f"{err:.3e} (max|plain| {scale:.3e}, bar {TOL_EPS_BF16} x "
        f"max|plain|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} through the kernels disagrees")
    return err, scale


def check_vocoder_bf16(torch, model, mel, L, dev):
    """Phases 16b and 17b: the bf16 vocoder (the same parameters): eps
    through the kernels vs the bf16 plain path; the quality gate over
    VOC_DIFFUSION_CFG's 50 steps; the step timed vs its plain path and, in
    turns, vs the f32 step, at B2; a trace of two bf16 steps.  Returns a
    dict."""
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.diffusion.sampling import sampling
    from diffwave_sashimi_torch.diffusion.schedule import schedule_from_cfg
    bfm = bf16_copy(torch, model)
    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    B = VOC_SAMPLES
    x = torch.randn(B, 1, L, device=dev, generator=g)
    steps = torch.tensor([49, 7][:B], device=dev)
    m = torch.from_numpy(mel).to(dev)
    conds, conds32 = bfm.compute_mel_conds(m, L), model.compute_mel_conds(m, L)
    k_fused = bfm.compute_kernels(L, ops.FUSED)
    k_plain = bfm.compute_kernels(L, ops.PLAIN)
    fused = (k_fused, ops.FUSED, {"mel_conds": conds})
    out = {}
    out["eps_err"], out["eps_max_plain"] = check_eps_bf16(
        torch, bfm, (x, steps), fused, (k_plain, ops.PLAIN,
                                        {"mel_conds": conds}),
        "vocoder eps bf16")

    sched = schedule_from_cfg(VOC_DIFFUSION_CFG, fast=True)
    shape = (B, 1, L)
    noise = torch.randn(sched.T + 1, *shape, device=dev, generator=g)
    x32 = sampling(model, shape, sched, device=dev, noise=noise,
                   mel_conds=conds32)
    xq = sampling(bfm, shape, sched, device=dev, noise=noise,
                  mel_conds=conds)
    out["quality"], ok = quality_gate(torch, "vocoder_bf16", x32, xq)
    del noise, x32, xq
    if not ok:
        raise AssertionError("bf16 vocoder x_0 fails the quality gate")

    def step(m_, k, o, c):
        return lambda: m_(x, steps, k, o, mel_conds=c)
    k32 = model.compute_kernels(L, ops.FUSED)
    bf16_step = step(bfm, k_fused, ops.FUSED, conds)
    out["step_ms"], out["step_plain_ms"] = paired_ms(
        bf16_step, step(bfm, k_plain, ops.PLAIN, conds), 3)
    out["step_ms_vs_f32"], out["f32_step_ms"] = paired_ms(
        bf16_step, step(model, k32, ops.FUSED, conds32), 3)
    out["step_ms_vs_three_pass"], out["three_pass_step_ms"] = paired_ms(
        bf16_step, three_pass_9f(bf16_step), 3)
    audio_s = B * L / VOC_DATASET_CFG["sampling_rate"]
    out["realtime_factor_step"] = audio_s / (
        VOC_DIFFUSION_CFG["T"] * out["step_ms"] / 1000)
    log(f"timing: bf16 vocoder eps forward at B{B} L{L} "
        f"{out['step_ms']:.3f} ms with kernels vs {out['step_plain_ms']:.3f}"
        f" ms plain; {out['step_ms_vs_f32']:.3f} ms vs the f32 step's "
        f"{out['f32_step_ms']:.3f} ms in turns; "
        f"{out['step_ms_vs_three_pass']:.3f} ms vs "
        f"{out['three_pass_step_ms']:.3f} ms with 9f on the three passes at "
        f"every n, in turns; "
        f"{out['realtime_factor_step']:.3f}x realtime from the step time")
    out["trace"] = trace_steps(torch, bf16_step, groups=KERNEL_9_GROUPS)
    log("trace: bf16 vocoder step with the kernels: " + (
        "no device time in the profiler's events (not measured)"
        if out["trace"] is None else json.dumps(out["trace"])))
    kernel_9_route(out["trace"], "bf16 vocoder step", cluster=True)
    return out


def three_pass_9f(step):
    """``step`` with kernel 9f on its three passes at every n (long_plan
    swapped for the length of the call): the bf16 step's yardstick for
    what the cluster route gives it."""
    fl = importlib.import_module("diffwave_sashimi_torch.ops.fftconv_long")

    def run():
        shipped, fl.long_plan = fl.long_plan, lambda n: fl.THREE_PASS
        try:
            return step()
        finally:
            fl.long_plan = shipped
    return run


def build_wavenet(torch):
    """Phase 18: the seeded full-width WaveNet saved as checkpoint 1000
    under its run name in the current directory's ``exp/``; returns (model
    on the CPU, run name)."""
    from diffwave_sashimi_torch.runtime.checkpoint import save_checkpoint
    from diffwave_sashimi_torch.utils.exp import local_directory
    t0 = time.perf_counter()
    model = build_model(torch, WNET_MODEL_CFG)
    run, ckpt = local_directory(None, WNET_MODEL_CFG, DIFFUSION_CFG,
                                DATASET_CFG, "checkpoint")
    save_checkpoint(ckpt, 1000, model)
    log(f"phase wavenet model: {run} built and saved in "
        f"{time.perf_counter() - t0:.1f} s")
    return model, run


def check_gate_kernel(torch, model, dev, results):
    """Phase 19: kernel 11 (19b: 11f, bf16 h and x) vs its plain version at
    GATE_CASES, with the first block's weights where the width is the
    model's and seeded ones (scale 1/sqrt(C)) elsewhere, timed; kernel 11
    beyond that by ``hold_gate``."""
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.ops.conv import weight_norm
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    blk = model.residual_layer["residual_blocks"][0]
    for B, C, S, L in (*GATE_CASES, GATE_BF16_RAGGED):
        if (C, S) == (256, 256):
            wr = weight_norm(blk.res_conv)[:, :, 0]
            ws = weight_norm(blk.skip_conv)[:, :, 0]
            br, bs = blk.res_conv["bias"], blk.skip_conv["bias"]
        else:
            wr, br, ws, bs = (torch.randn(*shape, device=dev, generator=gen)
                              / math.sqrt(C) for shape in
                              ((C, C), (C,), (S, C), (S,)))
        h = torch.randn(B, 2 * C, L, device=dev, generator=gen)
        x = torch.randn(B, C, L, device=dev, generator=gen)
        tier = f"B{B}_C{C}_S{S}_L{L}"
        if (B, C, S, L) in GATE_CASES:
            compare("gate_res_skip", C, L,
                    lambda: ops.gate_res_skip(h, x, wr, br, ws, bs),
                    lambda: ops.gate_res_skip_ref(h, x, wr, br, ws, bs),
                    10 if B > N_SAMPLES else 20, results, B=B, S=S,
                    tier=tier)
            hold_gate(torch, (h, x, wr, br, ws, bs), tier, results)
        hb, xb = h.to(torch.bfloat16), x.to(torch.bfloat16)
        compare("gate_res_skip_bf16", C, L,
                lambda: ops.gate_res_skip_bf16(hb, xb, wr, br, ws, bs),
                lambda: ops.gate_res_skip_ref(hb, xb, wr, br, ws, bs),
                10 if B > N_SAMPLES else 20, results, B=B, S=S,
                tier=tier, tol=TOL_BF16, bpe=2)
        if tier == TOP_TIER["gate_res_skip_bf16"]:
            outs = [ops.gate_res_skip_bf16(hb, xb, wr, br, ws, bs)
                    for _ in range(2)]
            if not all(torch.equal(a, b) for a, b in zip(*outs)):
                raise AssertionError("kernel 11f: two calls differ")
            log(f"kernel gate_res_skip_bf16 {tier}: two calls bit-equal")
        if L >= 8960:
            gemm_ms(torch, "gate_res_skip_bf16", results, tier,
                    torch.cat([wr, ws]),
                    torch.randn(C, B * L, device=dev).to(torch.bfloat16))


def run_wavenet_generate(torch, run, launches, dev):
    """Phase 20: generate() from the WaveNet checkpoint with its launch
    counts; (20b) the shipped command at bf16 on the same checkpoint.
    Returns {path: wall seconds}."""
    import numpy as np
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.runtime.generate import generate
    for fn in ops.COUNTED.values():
        fn.launches = 0
    t0 = time.perf_counter()
    audio = generate(DIFFUSION_CFG, WNET_MODEL_CFG, DATASET_CFG,
                     ckpt_iter="max", n_samples=N_SAMPLES, seed=SEED,
                     device=dev)
    gen_s = time.perf_counter() - t0
    launches["wavenet"] = {k: f.launches for k, f in ops.COUNTED.items()}
    log(f"phase wavenet generate: {gen_s:.2f} s wall; launches "
        f"{launches['wavenet']}")
    want = {k: WNET_LAUNCHES.get(k, 0) for k in ops.COUNTED}
    if launches["wavenet"] != want:
        raise AssertionError(f"wavenet sampling launches "
                             f"{launches['wavenet']}, expected {want}")
    if audio.shape != (N_SAMPLES, 1, 16000) or not np.isfinite(audio).all():
        raise AssertionError(f"bad wavenet output {audio.shape}")
    wavs = sorted(os.listdir(os.path.join("exp", run, "waveforms", "1000")))
    if wavs != [f"1k_{i}.wav" for i in range(N_SAMPLES)]:
        raise AssertionError(f"wav layout {wavs}")
    log(f"output: shape {audio.shape}, finite, std {audio.std():.4f}, "
        f"wavs {wavs}")
    shutil.rmtree(os.path.join("exp", run, "waveforms"))
    bf16_s = run_shipped_command_counted(
        torch, "wavenet_bf16", ["experiment=sc09_wavenet",
                                f"generate.n_samples={N_SAMPLES}"],
        WNET_BF16_LAUNCHES, launches)
    read_wavs(run, N_SAMPLES, 16000, "bf16 wavenet")
    return {"wavenet": gen_s, "wavenet_bf16": bf16_s}


def build_wavenet_cond(torch, dev):
    """Phase 21's conditional WaveNet of the shipped width (seeded, on the
    card), a seeded mel of WNET_MEL_FRAMES frames and an input of that
    length: (model, mel, x)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    L = WNET_MEL_FRAMES * 256
    return (build_model(torch, WNET_COND_CFG).to(dev).eval(),
            torch.randn(N_SAMPLES, 80, WNET_MEL_FRAMES, device=dev,
                        generator=g),
            torch.randn(N_SAMPLES, 1, L, device=dev, generator=g))


def wavenet_groups(kernel, names):
    """The trace groups of a WaveNet step: the tail kernel (its __global__
    functions ``names``), the convolution and GEMM library kernels (the
    dilated conv, the 1x1 convs), the rest."""
    def is_library(name):
        lo = name.lower()
        return any(s in lo for s in ("conv", "xmma", "gemm", "cudnn",
                                     "cutlass", "implicit", "winograd"))
    return {f"gate_res_skip (kernel {kernel})":
            lambda n: in_group(n, names),
            "convolution and GEMM library kernels": is_library}


def check_wavenet_step(torch, model, cond, dev):
    """Phases 21 and 22: eps kernel vs plain (unconditional, then the
    conditional model of the same width with its seeded mel, ``cond``),
    then the step timed both ways at B4 and B16 and traced at B4.  Returns
    a dict."""
    from diffwave_sashimi_torch import ops
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    x = torch.randn(N_SAMPLES, 1, 16000, device=dev, generator=g)
    steps = torch.tensor([199, 120, 40, 3][:N_SAMPLES], device=dev)
    out = {"eps_err": check_eps(torch, model, x, steps, "wavenet eps")}
    cond_model, mel, xc = cond
    conds = cond_model.compute_mel_conds(mel, xc.shape[-1])
    out["cond_eps_err"] = check_eps(torch, cond_model, xc, steps,
                                    "wavenet conditional eps",
                                    mel_conds=conds)
    del conds
    out["step_ms"], out["step_plain_ms"] = {}, {}
    for B in (N_SAMPLES, 16):
        xb = torch.randn(B, 1, 16000, device=dev, generator=g)
        sb = torch.randint(0, 200, (B,), device=dev, generator=g)
        out["step_ms"][str(B)], out["step_plain_ms"][str(B)] = paired_ms(
            lambda: model(xb, sb, [], ops.FUSED),
            lambda: model(xb, sb, [], ops.PLAIN), 3)
    T = DIFFUSION_CFG["T"]
    out["realtime_factor"] = {B: int(B) * 16000 / 16000 / (T * ms / 1000)
                              for B, ms in out["step_ms"].items()}
    for B, ms in out["step_ms"].items():
        log(f"timing: wavenet eps forward (one sampling step) at B{B} "
            f"{ms:.3f} ms with kernel 11 vs {out['step_plain_ms'][B]:.3f} ms "
            f"plain; T={T} -> {out['realtime_factor'][B]:.3f}x realtime "
            f"from the step time")

    out["trace"] = trace_steps(
        torch, lambda: model(x, steps, [], ops.FUSED),
        groups=wavenet_groups("11", [k for names in KERNELS_11.values()
                                     for k in names]))
    log("trace: wavenet step with kernel 11: " + (
        "no device time in the profiler's events (not measured)"
        if out["trace"] is None else json.dumps(out["trace"])))
    return out


def check_wavenet_bf16(torch, model, cond, dev):
    """Phases 21b and 22b: the bf16 WaveNet (the same parameters): eps
    through kernel 11f vs the bf16 plain path, unconditional and for the
    conditional model ``cond``; the quality gate over QUALITY_CFG's 50
    steps; the step at B4 and B16 vs its plain path and, in turns, vs the
    f32 step; a trace of two bf16 steps.  Returns a dict."""
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.diffusion.sampling import sampling
    from diffwave_sashimi_torch.diffusion.schedule import schedule_from_cfg
    bfm = bf16_copy(torch, model)
    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    x = torch.randn(N_SAMPLES, 1, 16000, device=dev, generator=g)
    steps = torch.tensor([199, 120, 40, 3][:N_SAMPLES], device=dev)
    out = {"eps_err": check_eps_bf16(torch, bfm, (x, steps),
                                     ([], ops.FUSED, {}),
                                     ([], ops.PLAIN, {}), "wavenet eps bf16")}
    cond_bf16 = bf16_copy(torch, cond[0])
    mc = {"mel_conds": cond_bf16.compute_mel_conds(cond[1],
                                                   cond[2].shape[-1])}
    out["cond_eps_err"] = check_eps_bf16(
        torch, cond_bf16, (cond[2], steps), ([], ops.FUSED, mc),
        ([], ops.PLAIN, mc), "wavenet conditional eps bf16")
    del cond_bf16, mc

    sched = schedule_from_cfg(QUALITY_CFG, fast=True)
    shape = (N_SAMPLES, 1, 16000)
    noise = torch.randn(sched.T + 1, *shape, device=dev, generator=g)
    out["quality"], ok = quality_gate(
        torch, "wavenet_bf16",
        sampling(model, shape, sched, device=dev, noise=noise),
        sampling(bfm, shape, sched, device=dev, noise=noise))
    if not ok:
        raise AssertionError("bf16 WaveNet x_0 fails the quality gate")

    for key in ("step_ms", "step_plain_ms", "step_ms_vs_f32", "f32_step_ms"):
        out[key] = {}
    for B in (N_SAMPLES, 16):
        xb = torch.randn(B, 1, 16000, device=dev, generator=g)
        sb = torch.randint(0, 200, (B,), device=dev, generator=g)
        k = str(B)
        out["step_ms"][k], out["step_plain_ms"][k] = paired_ms(
            lambda: bfm(xb, sb, [], ops.FUSED),
            lambda: bfm(xb, sb, [], ops.PLAIN), 3)
        out["step_ms_vs_f32"][k], out["f32_step_ms"][k] = paired_ms(
            lambda: bfm(xb, sb, [], ops.FUSED),
            lambda: model(xb, sb, [], ops.FUSED), 3)
        log(f"timing: bf16 wavenet eps forward at B{B} "
            f"{out['step_ms'][k]:.3f} ms with kernel 11f vs "
            f"{out['step_plain_ms'][k]:.3f} ms plain; "
            f"{out['step_ms_vs_f32'][k]:.3f} ms vs the f32 step's "
            f"{out['f32_step_ms'][k]:.3f} ms in turns")
    T = DIFFUSION_CFG["T"]
    out["realtime_factor"] = {B: int(B) * 16000 / 16000 / (T * ms / 1000)
                              for B, ms in out["step_ms"].items()}
    out["trace"] = trace_steps(torch, lambda: bfm(x, steps, [], ops.FUSED),
                               groups=wavenet_groups("11f", KERNELS_11F))
    log("trace: bf16 wavenet step with kernel 11f: " + (
        "no device time in the profiler's events (not measured)"
        if out["trace"] is None else json.dumps(out["trace"])))
    if out["trace"] is not None:
        tr = out["trace"]
        tail = tr["groups_ms_per_step"]["gate_res_skip (kernel 11f)"]
        busy = tr["device_busy_ms_per_step"]
        tr["kernel_11f_share_of_busy"] = tail / busy
        log(f"trace: kernel 11f {tail:.3f} ms a bf16 wavenet step, "
            f"{tr['kernel_11f_share_of_busy']:.3f} of the device's busy "
            f"time; idle share {tr['idle_share']:.3f}")
    return out


def run_wavenet_training(torch, root, model, launches, dev):
    """Phase 23: the training CLI on the synthetic corpus, 3 iterations
    (checkpoint 2), then resumed for one more (checkpoint 3); then the
    training step of ``model`` timed.  Returns (losses, step ms)."""
    import numpy as np
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.diffusion.schedule import schedule_from_cfg
    from diffwave_sashimi_torch.runtime import train as train_mod
    from diffwave_sashimi_torch.utils.exp import local_directory
    data = os.path.join(root, "sc09")
    write_corpus(data)
    overrides = WNET_TRAIN_OVERRIDES + [f"dataset.data_path={data}"]
    for fn in ops.COUNTED.values():
        fn.launches = 0
    t0 = time.perf_counter()
    train_mod.main(overrides + ["train.n_iters=2", "train.iters_per_ckpt=2"])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_mod.main(overrides + ["train.n_iters=3", "train.iters_per_ckpt=3"])
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    launches["wavenet_train"] = {k: f.launches
                                 for k, f in ops.COUNTED.items()}
    run, ckpt = local_directory(None, WNET_MODEL_CFG, DIFFUSION_CFG,
                                DATASET_CFG, "checkpoint", makedirs=False)
    with open(os.path.join("exp", run, "metrics.jsonl")) as f:
        losses = [(r["step"], r["train/loss"]) for r in map(json.loads, f)
                  if "train/loss" in r]
    saved = torch.load(os.path.join(ckpt, "3.pkl"), weights_only=True)
    adam = {int(st["step"]) for st in
            saved["optimizer_state_dict"]["state"].values()}
    log(f"phase wavenet train: main() 3 iterations in {first_s:.2f} s wall, "
        f"resume 1 iteration in {resume_s:.2f} s wall (each includes "
        f"building the model); losses {losses}; checkpoints "
        f"{sorted(os.listdir(ckpt))}; Adam steps in 3.pkl {adam}; launches "
        f"{launches['wavenet_train']}")
    if [i for i, _ in losses] != [0, 1, 2, 3] or not all(
            np.isfinite(v) for _, v in losses):
        raise AssertionError(f"wavenet training losses {losses}")
    if sorted(os.listdir(ckpt)) != ["2.pkl", "3.pkl"] or adam != {4}:
        raise AssertionError("wavenet checkpoints or resumed Adam state")
    if any(launches["wavenet_train"].values()):
        raise AssertionError("a kernel ran in wavenet training, which has "
                             "none")
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    audio = 0.3 * torch.randn(N_SAMPLES, 1, 16000, device=dev, generator=g)
    schedule = schedule_from_cfg(DIFFUSION_CFG)
    optim = train_mod.make_optimizer(model, 2e-4)
    model.train()
    step_ms = cuda_ms(lambda: train_mod.train_step(model, optim, audio,
                                                   schedule, g), 3)
    log(f"timing: wavenet training step (forward, backward, Adam) at "
        f"B{N_SAMPLES} {step_ms:.3f} ms (no kernel of the port: cuDNN "
        f"convs and the plain tail under autograd)")
    return losses, step_ms


def check_long_training_kernels(torch, dev, results):
    """Phase 7c: the training route past FFT size 32768 at
    LONG_TRAIN_CASES, on seeded u, g and a decaying seeded kernel's
    spectrum: kernel 9's training entry (``fftconv_long``, the three
    passes, and its conjugate form, the ``_conj`` tiers) on f32 and bf16
    activations against ``fftconv_long_ref`` (``compare``, TOL_KERNEL and
    TOL_BF16; the bf16 entry also in ``hold_long_bf16_entry``), a cuFFT
    conv of the shapes beside them (``cufft_conv_ms``, a yardstick the
    port never calls); kernel 5L (``fftconv_dkf_long``, f32 and bf16
    inputs) against its plain version (``fftconv_dkf_ref``) at TOL_KERNEL
    x max(1, max|plain|), timed (``compare``), and in ``hold_dkf_long``
    on both routes.  First the clusters of 5L's cluster route the card
    holds at once at each of its sizes (none fails)."""
    from diffwave_sashimi_torch import ops
    fl = importlib.import_module("diffwave_sashimi_torch.ops.fftconv_long")
    clusters = {f"n{n}": fl.max_active_dkf_clusters(n)
                for n in fl.DKF_CLUSTER_NS}
    log(f"kernel fftconv_dkf_long: cudaOccupancyMaxActiveClusters of its "
        f"cluster route, by FFT size: {clusters}")
    if not all(clusters.values()):
        raise AssertionError(f"kernel fftconv_dkf_long: a cluster the card "
                             f"cannot hold: {clusters}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    for B, H, L, n in LONG_TRAIN_CASES:
        base = f"H{H}_L{L}" if B == 2 else f"B{B}_H{H}_L{L}"
        decay = torch.exp(-torch.arange(n, device=dev) / (n / 16))
        khat = torch.fft.rfft(0.01 * decay * torch.randn(
            H, n, device=dev, generator=gen), n=n)
        kp = ops.long_spectrum(khat)
        u, g = (torch.randn(B, H, L, device=dev, generator=gen)
                for _ in range(2))
        cufft = cufft_conv_ms(torch, u, khat, L)
        for dtype, bpe, tol, tag in ((torch.float32, 4, TOL_KERNEL, ""),
                                     (torch.bfloat16, 2, TOL_BF16, "_bf16")):
            for conj, x in ((False, u), (True, g)):
                tier = base + tag + ("_conj" if conj else "")
                xd = x.to(dtype)
                compare("fftconv_long", H, L,
                        lambda: ops.fftconv_long(xd, kp, conj),
                        lambda: fl.fftconv_long_ref(xd, kp, conj), 5,
                        results, B=B, n=n, tier=tier, tol=tol, bpe=bpe)
                results["fftconv_long"]["tiers"][tier]["cufft_conv_ms"] = \
                    cufft
                if dtype == torch.bfloat16:
                    hold_long_bf16_entry(torch, fl, xd, kp, conj, tier,
                                         results)
        for dtype, bpe, tier in ((torch.float32, 4, base),
                                 (torch.bfloat16, 2, base + "_bf16")):
            ud, gd = u.to(dtype), g.to(dtype)
            compare("fftconv_dkf_long", H, L,
                    lambda: ops.fftconv_dkf_long(ud, gd, n),
                    lambda: ops.fftconv_dkf_ref(ud, gd, n), 5, results, B=B,
                    n=n, tier=tier, bpe=bpe)
            hold_dkf_long(torch, fl, ud, gd, n, tier, results)
        del u, g, kp, khat
        torch.cuda.empty_cache()
    results["fftconv_dkf_long"]["max_active_clusters"] = clusters


def hold_long_bf16_entry(torch, fl, x, kp, conj, tier, results):
    """Kernel 9's bf16 training entry at one tier beyond its bar: bit-equal
    to the f32 entry on the widened input, narrowed to bf16 (the
    composite the bf16 route took before the entry existed), and the two
    timed in CUDA graphs in turns (``graph_ms``, ``composite_graph_ms``)."""
    def entry():
        return fl.launch_long(x, kp, conj)

    def composite():
        return fl.launch_long(x.float(), kp, conj).to(torch.bfloat16)
    equal = torch.equal(entry(), composite())
    c1 = graph_ms(torch, composite)
    k1, k2 = graph_ms(torch, entry), graph_ms(torch, entry)
    c2 = graph_ms(torch, composite)
    t = results["fftconv_long"]["tiers"][tier]
    t.update(bit_equal_composite=equal, graph_ms=(k1 + k2) / 2,
             composite_graph_ms=(c1 + c2) / 2)
    log(f"kernel fftconv_long {tier}: the bf16 entry "
        f"{'bit-equal to' if equal else 'DIFFERS from'} the f32 entry on "
        f"the widened input, narrowed; in CUDA graphs, in turns: "
        f"{t['graph_ms']:.4f} ms vs that composite's "
        f"{t['composite_graph_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms; "
        f"cuFFT conv {t['cufft_conv_ms']:.4f} ms")
    if not equal:
        raise AssertionError(f"kernel fftconv_long {tier}: the bf16 entry "
                             f"differs from the widened f32 entry narrowed")


def hold_dkf_long(torch, fl, u, g, n, tier, results):
    """Kernel 5L at one tier beyond its bar: on the route dkf_long_plan
    takes (the cluster route at LONG_TRAIN_CASES' n), two calls bit-equal
    and one allocation a call (its output: no scratch); it, its two-pass
    route and the plain version against a complex128 evaluation of the
    function, as relative L2 errors (``c128_l2``: the route's at most twice
    the plain version's, ``two_pass_c128_l2``); the two-pass route against
    the plain version at TOL_KERNEL x max(1, max|plain|); the two timed
    in CUDA graphs in turns (``graph_ms``, ``two_pass_graph_ms``), and
    one ``torch.fft.rfft`` of u and g stacked (``cufft_rfft_ms``, a
    yardstick the port never calls)."""
    from diffwave_sashimi_torch import ops
    plan = fl.dkf_long_plan(n)
    if plan.route != "cluster":
        raise AssertionError(f"kernel fftconv_dkf_long {tier}: "
                             f"dkf_long_plan({n}) is {plan}, not the "
                             f"cluster route")
    torch.cuda.synchronize()
    count = torch.cuda.memory_stats()["allocation.all.allocated"]
    one = fl.launch_dkf_long(u, g, n)
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - count
    two = fl.launch_dkf_long(u, g, n)
    other = fl.launch_dkf_long(u, g, n, fl.DKF_TWO_PASS)
    plain = ops.fftconv_dkf_ref(u, g, n)
    wide = ops.fftconv_dkf_ref(u.double(), g.double(), n)
    torch.cuda.synchronize()

    def l2(out):
        return float((out.to(torch.complex128) - wide).abs().norm()
                     / wide.abs().norm())
    other_err, scale = max_err(other, plain)
    errs = {"c128_l2": l2(one), "plain_c128_l2": l2(plain),
            "two_pass_c128_l2": l2(other), "two_pass_max_abs_err": other_err}
    equal = torch.equal(one, two)
    del one, two, other, plain, wide

    def launch(p):
        return lambda: fl.launch_dkf_long(u, g, n, p)
    o1 = graph_ms(torch, launch(fl.DKF_TWO_PASS))
    k1, k2 = graph_ms(torch, launch(plan)), graph_ms(torch, launch(plan))
    o2 = graph_ms(torch, launch(fl.DKF_TWO_PASS))
    t = results["fftconv_dkf_long"]["tiers"][tier]
    t.update(errs, bit_equal=equal, allocations=allocs, plan=list(plan),
             graph_ms=(k1 + k2) / 2, two_pass_graph_ms=(o1 + o2) / 2,
             cufft_rfft_ms=cuda_ms(lambda: torch.fft.rfft(
                 torch.stack([u, g]).float(), n=n), 5))
    ok = equal and allocs == 1 and \
        errs["c128_l2"] <= 2 * errs["plain_c128_l2"] and \
        other_err <= TOL_KERNEL * max(1.0, scale)
    log(f"kernel fftconv_dkf_long {tier} n {n}: cluster route, two calls "
        f"{'bit-equal' if equal else 'DIFFER'}, {allocs} allocation(s) a "
        f"call; vs complex128 L2 {errs['c128_l2']:.3e} (plain "
        f"{errs['plain_c128_l2']:.3e}, two passes "
        f"{errs['two_pass_c128_l2']:.3e}) {'ok' if ok else 'FAIL'}; in CUDA "
        f"graphs, in turns: {t['graph_ms']:.4f} ms vs the two passes' "
        f"{t['two_pass_graph_ms']:.4f} ms (their max_abs_err "
        f"{other_err:.3e} of {scale:.3e}); rfft of u and g "
        f"{t['cufft_rfft_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms; plan "
        f"{tuple(plan)}")
    if not ok:
        raise AssertionError(f"kernel fftconv_dkf_long {tier}: two calls "
                             f"differ, a call allocates more than its "
                             f"output, its L2 error against complex128 is "
                             f"past twice the plain version's, or the two "
                             f"passes disagree")


def write_clips(root):
    """Phases 25 and 26: VOC_TRAIN_CLIPS seeded synthetic LJSpeech clips
    (phase 12's utterance at pitches 1, 1.1, 1.2, ...) in ``root``."""
    os.makedirs(root)
    for i in range(VOC_TRAIN_CLIPS):
        write_utterance(os.path.join(root, f"LJ000-{i:04d}.wav"),
                        1.0 + 0.1 * i)


def run_vocoder_training(torch, root, launches, runs, model_cfg,
                         dataset_cfg):
    """Phases 25 and 26: for each (path, overrides, per-step launches) of
    ``runs``, ``runtime.train.main`` (VOC_TRAIN_ARGS) on the synthetic
    clips in a directory of its own, with every launch count set to 0
    just before and read just after: exactly VOC_TRAIN_ITERS times the
    step's counts, finite losses of every iteration, checkpoint 2.
    Returns {path: {"losses", "s"}}."""
    import numpy as np
    from diffwave_sashimi_torch.runtime import train as train_mod
    from diffwave_sashimi_torch.utils.exp import local_directory
    data = os.path.join(root, "wavs")
    write_clips(data)
    out = {}
    for path, overrides, step in runs:
        work = os.path.join(root, path)
        os.makedirs(work)
        os.chdir(work)
        argv = overrides + VOC_TRAIN_ARGS + [f"dataset.data_path={data}"]
        t0 = time.perf_counter()
        counted_run(torch, path, {k: VOC_TRAIN_ITERS * v
                                  for k, v in step.items()}, launches,
                    lambda: train_mod.main(argv))
        secs = time.perf_counter() - t0
        run, ckpt = local_directory(None, model_cfg, VOC_DIFFUSION_CFG,
                                    dataset_cfg, "checkpoint",
                                    makedirs=False)
        with open(os.path.join("exp", run, "metrics.jsonl")) as f:
            losses = [(r["step"], r["train/loss"])
                      for r in map(json.loads, f) if "train/loss" in r]
        log(f"phase {path}: main({' '.join(overrides)}) "
            f"{VOC_TRAIN_ITERS} iterations in {secs:.2f} s wall (building "
            f"the model and the loader included); losses {losses}; "
            f"checkpoints {sorted(os.listdir(ckpt))}; launches "
            f"{launches[path]}")
        if [i for i, _ in losses] != list(range(VOC_TRAIN_ITERS)) or \
                not all(np.isfinite(v) for _, v in losses):
            raise AssertionError(f"{path} losses {losses}")
        if not os.path.exists(os.path.join(ckpt, "2.pkl")):
            raise AssertionError(f"{path}: checkpoint 2.pkl was not written")
        out[path] = {"losses": losses, "s": secs}
    return out


def stack_scalars(grads):
    """grads with its scalars stacked by kind, a kind being the parameter's
    name without its block (``c_layers.1.norm2.m`` -> ``scalars:norm2.m``);
    the other tensors as they are."""
    import torch
    out, kinds = {}, {}
    for n, g in grads.items():
        if g.numel() > 1:
            out[n] = g
        else:
            kinds.setdefault(re.sub(r"^[a-z]+_layers\.\d+\.", "", n),
                             []).append(g.reshape(()))
    out.update({f"scalars:{k}": torch.stack(v) for k, v in kinds.items()})
    return out


def hold_vocoder_grads_bf16(torch, label, loss, loss_plain, grads,
                            grads_plain, grads32):
    """Phases 25 and 26's bf16 hold of one step, kernels vs the bf16 plain
    path: phase 9b's median and entry bars over the tensors (the loss to
    the entry bar) and its per-tensor bar over the tensors with the
    scalars stacked by kind (``stack_scalars``).  Returns the distances,
    the stacked ones, and the plain bf16 path's from the plain f32 path
    (``grads32``)."""
    vs_plain = grad_distance(grads, grads_plain)
    stacked = grad_distance(stack_scalars(grads), stack_scalars(grads_plain))
    finite = all(bool(torch.isfinite(v).all()) for v in grads.values())
    ok = finite and stacked["worst"] <= TOL_GRAD_BF16["worst"] and all(
        vs_plain[k] <= TOL_GRAD_BF16[k] for k in ("median", "entry")) and \
        abs(loss - loss_plain) <= TOL_GRAD_BF16["entry"] * abs(loss_plain)
    out = {"loss": loss, "loss_plain": loss_plain, "vs_plain": vs_plain,
           "stacked_vs_plain": stacked,
           "plain_vs_f32": grad_distance(grads_plain, grads32),
           "stacked_plain_vs_f32": grad_distance(
               stack_scalars(grads_plain), stack_scalars(grads32))}
    log(f"phase {label}: {json.dumps(out)} (bars {TOL_GRAD_BF16}: median "
        f"and entry over the tensors, the loss to the entry bar, worst over "
        f"the tensors with the scalars stacked by kind) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: bf16 gradients through the kernels "
                             f"disagree")
    return out


def check_vocoder_train_grads(torch, cfg, dataset_cfg, B, dev, label,
                              grad_layers=None, trace=False):
    """Phases 25 and 26: one training step of the vocoder ``cfg`` (built
    from a seed, full width; depth cut to ``grad_layers`` where given) on
    a seeded (audio, t, z, mel) at its segment length and batch B, at each
    of VOC_GRAD_SEEDS: at f32 every gradient through the kernels held
    against torch autograd of the plain versions (ops.PLAIN) on the card at
    phase 9's bar (``hold_gradients``), at bf16 at phase 9b's
    (``hold_vocoder_grads_bf16``); then the training step (forward,
    backward, Adam) of ``cfg`` at full depth timed at the bf16 path and,
    with ``trace``, traced (``check_harder_trace``).  Returns its
    numbers."""
    from diffwave_sashimi_torch.diffusion.schedule import schedule_from_cfg
    from diffwave_sashimi_torch.runtime.train import (make_optimizer,
                                                      train_step)
    L, hop = dataset_cfg["segment_length"], dataset_cfg["hop_length"]
    model = build_model(torch, dict(cfg, n_layers=grad_layers)
                        if grad_layers else cfg).to(dev)
    T = VOC_DIFFUSION_CFG["T"]
    out = {"grad_layers": grad_layers or cfg["n_layers"], "seeds": {}}
    for seed in VOC_GRAD_SEEDS:
        gen = torch.Generator(device=dev).manual_seed(seed)
        audio = 0.3 * torch.randn(B, 1, L, device=dev, generator=gen)
        t = torch.randint(0, T, (B,), device=dev, generator=gen)
        z = torch.randn(B, 1, L, device=dev, generator=gen)
        mel = torch.randn(B, 80, L // hop + 1, device=dev, generator=gen)
        batch = (audio, t, z)
        losses, grads = {}, {}
        for route in ("FUSED", "PLAIN"):
            losses[route], grads[route] = step_grads(
                torch, model, *batch, route, mel, VOC_DIFFUSION_CFG)
        f32_worst = hold_gradients(f"{label}_grads_seed{seed}", losses,
                                   grads)
        grads32 = grads.pop("PLAIN")
        del grads
        bfm = bf16_copy(torch, model)
        loss, grads = step_grads(torch, bfm, *batch, "FUSED", mel,
                                 VOC_DIFFUSION_CFG)
        loss_plain, grads_plain = step_grads(torch, bfm, *batch, "PLAIN",
                                             mel, VOC_DIFFUSION_CFG)
        del bfm
        out["seeds"][str(seed)] = dict(hold_vocoder_grads_bf16(
            torch, f"{label}_grads_bf16_seed{seed}", loss, loss_plain,
            grads, grads_plain, grads32), f32_worst=f32_worst)
        del grads, grads_plain, grads32
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    bfm = bf16_copy(torch, build_model(torch, cfg).to(dev))
    schedule = schedule_from_cfg(VOC_DIFFUSION_CFG)
    optim = make_optimizer(bfm, 2e-4)
    bfm.train()
    out["step_ms_bf16"] = cuda_ms(lambda: train_step(
        bfm, optim, audio, schedule, gen, mel=mel), 3)
    log(f"timing: {label} bf16 training step (forward, backward, Adam) at "
        f"B{B} L{L} {out['step_ms_bf16']:.3f} ms")
    if trace:
        out["trace"] = check_harder_trace(torch, lambda: train_step(
            bfm, optim, audio, schedule, gen, mel=mel), label)
    del bfm, optim
    torch.cuda.empty_cache()
    return out


def check_harder_kernels(torch, dev, results):
    """Phase 26: the ljspeech_harder model's kernels off SC09's shapes, vs
    their plain versions at its tiers (B4, bf16 activations, a seeded
    full-width model): kernels 4 and 8 at the top tier (Lz 22001), held as
    in phase 7 (``hold_kernel_4``, ``hold_kernel_8``), 6f and 7f at L
    44000, and 1f's training entry, its conjugate form and 5f at L 11000
    (n 32768, the radix-16 route)."""
    from diffwave_sashimi_torch import ops
    model = build_model(torch, HARDER_MODEL_CFG).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    bf = torch.bfloat16
    for H, L, blk in tier_blocks(model)[:2]:
        d = tier_inputs(torch, blk, L, gen, dev)
        x, g, y, khat, lin = (d["x"].to(bf), d["g"].to(bf), d["y"].to(bf),
                              d["khat"], d["lin"])
        tier = f"H{H}_L{L}"
        if L == 44000:
            ff = (x, d["m2"], d["s2"], d["w1"], d["b1"], d["w2"], d["b2"], g)
            cauchy = (*d["quad"], d["z"], d["g_re"], d["g_im"])
            cases = [
                ("cauchy",
                 lambda: ops.cauchy_quad(*d["quad"], d["z"]).unbind(-1),
                 lambda: ops.cauchy_quad_ref(*d["quad"], d["z"]),
                 TOL_KERNEL, 4),
                ("cauchy_bwd", lambda: ops.cauchy_bwd(*cauchy),
                 lambda: ops.cauchy_bwd_ref(*cauchy), TOL_KERNEL, 4),
                ("glu_res_bwd_bf16",
                 lambda: ops.glu_res_bwd_bf16(y, lin.weight, lin.bias, g),
                 lambda: ops.glu_res_bwd_ref(y, lin.weight, lin.bias, g),
                 TOL_BF16, 2),
                ("ln_ff_res_bwd_bf16", lambda: ops.ln_ff_res_bwd_bf16(*ff),
                 lambda: ops.ln_ff_res_bwd_ref(*ff), TOL_BF16, 2)]
        else:
            n = d["n"]
            cases = [
                ("fftconv_bf16", lambda: ops.fftconv_bf16(x, khat),
                 lambda: ops.fftconv_ref(x, khat), TOL_BF16, 2),
                ("fftconv_bf16", lambda: ops.fftconv_bf16(g, khat, conj=True),
                 lambda: ops.fftconv_ref(g, khat, conj=True), TOL_BF16, 2),
                ("fftconv_dkf_bf16", lambda: ops.fftconv_dkf_bf16(x, g, n),
                 lambda: ops.fftconv_dkf_ref(x, g, n), TOL_BF16, 2)]
        for name, kfn, pfn, tol, bpe in cases:
            compare(name, H, L, kfn, pfn, 3, results, tol=tol, bpe=bpe)
        if L == 44000:
            hold_kernel_4(torch, d, tier, results)
            hold_kernel_8(torch, d, tier, results)
        del d
    del model
    torch.cuda.empty_cache()


def run_wavenet_training_bf16(torch, root, model, launches, dev):
    """Phase 23b: the shipped WaveNet training command (bf16, no precision
    override) on phase 8's synthetic corpus, 3 iterations (checkpoint 2),
    with no kernel launched (the training form has none, as in JAX),
    finite losses and an f32 checkpoint; then the quality gate of bf16
    training: TRAJ_STEPS Adam steps at bf16 and at f32 from ``model``'s
    parameters (``check_bf16_trajectory``)."""
    import numpy as np
    from diffwave_sashimi_torch.runtime import train as train_mod
    from diffwave_sashimi_torch.utils.exp import local_directory
    data = os.path.join(root, "sc09")
    write_corpus(data)
    argv = [o for o in WNET_TRAIN_OVERRIDES
            if not o.startswith("compute.precision")] + [
        "train.n_iters=2", "train.iters_per_ckpt=2",
        f"dataset.data_path={data}"]
    t0 = time.perf_counter()
    counted_run(torch, "wavenet_train_bf16", {}, launches,
                lambda: train_mod.main(argv))
    secs = time.perf_counter() - t0
    run, ckpt = local_directory(None, WNET_MODEL_CFG, DIFFUSION_CFG,
                                DATASET_CFG, "checkpoint", makedirs=False)
    with open(os.path.join("exp", run, "metrics.jsonl")) as f:
        losses = [(r["step"], r["train/loss"]) for r in map(json.loads, f)
                  if "train/loss" in r]
    saved = torch.load(os.path.join(ckpt, "2.pkl"), weights_only=True)
    dtypes = {str(t.dtype) for t in saved["model_state_dict"].values()}
    log(f"phase wavenet_train_bf16: main() with no precision override, 3 "
        f"iterations in {secs:.2f} s wall (building the model included); "
        f"losses {losses}; 2.pkl tensors {dtypes}; launches "
        f"{launches['wavenet_train_bf16']}")
    if [i for i, _ in losses] != [0, 1, 2] or not all(
            np.isfinite(v) for _, v in losses) or dtypes != {
            "torch.float32"}:
        raise AssertionError(f"bf16 wavenet training: losses {losses}, "
                             f"checkpoint tensors {dtypes}")
    traj = check_bf16_trajectory(torch, model, dev, "wavenet_trajectory_bf16")
    return {"losses": losses, "s": secs, "trajectory": traj}



def dp_grad_rank(rank, world, device, state_path):
    """Phase 27's rank (a spawned process): at f32 and at bf16, phase 2's
    model through DDP and the kernels on this rank's rows of phase 9's
    batch, t and z, two Adam steps (lr 2e-4).  Per precision: the first
    step's loss, the loss's mean over the ranks and the all-reduced
    gradients; each step's launch counts (every count set to 0 just
    before the step); the parameters' digest after each step; and the
    step's ms (CUDA events, with the other ranks on their cards, or on
    this one)."""
    import torch
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.diffusion.loss import training_loss
    from diffwave_sashimi_torch.diffusion.schedule import schedule_from_cfg
    from diffwave_sashimi_torch.models import construct_model
    from diffwave_sashimi_torch.parallel import (all_reduce_mean,
                                                 data_parallel, row_range)
    from diffwave_sashimi_torch.runtime.checkpoint import load_into
    from diffwave_sashimi_torch.runtime.train import (make_optimizer,
                                                      params_sha256)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lo, hi = row_range(rank, world, N_SAMPLES)
    audio, t, z = (x[lo:hi] for x in grad_batch(torch, device))
    schedule = schedule_from_cfg(DIFFUSION_CFG)
    state = torch.load(state_path, map_location=device, weights_only=True)
    out = {}
    for precision in ("f32", "bf16"):
        with torch.device(device):
            model = construct_model(MODEL_CFG, precision)
        load_into(model, state)
        net = data_parallel(model)
        optim = make_optimizer(model, 2e-4)

        def step():
            optim.zero_grad(set_to_none=True)
            loss = training_loss(net, audio, schedule, t=t, z=z,
                                 ops=ops.FUSED)
            loss.backward()
            return loss
        res = {"launches": [], "sha256": []}
        for k in range(2):
            for f in ops.COUNTED.values():
                f.launches = 0
            loss = step()
            torch.cuda.synchronize()
            res["launches"].append({n: f.launches
                                    for n, f in ops.COUNTED.items()})
            if k == 0:
                res["loss"] = loss.item()
                res["loss_mean"] = all_reduce_mean(loss).item()
                res["grads"] = {n: p.grad.detach().cpu()
                                for n, p in model.named_parameters()}
            optim.step()
            res["sha256"].append(params_sha256(model))
        res["step_ms"] = cuda_ms(lambda: (step(), optim.step()), 3)
        out[precision] = res
        del model, net, optim
        torch.cuda.empty_cache()
    return out


def hold_dp_grads(torch, label, ranks_out, ref, want_launches):
    """Phase 27's gates on ``ranks_out`` (dp_grad_rank's results) against
    the 1-rank step ``ref`` ({precision: (loss, grads)}): every rank's
    gradients and its parameters after each step bit-equal to rank 0's;
    each rank's launches each step exactly the 1-rank step's
    (``want_launches``); the f32 loss and gradients at phase 9's bar, the
    bf16 ones at phase 9b's.  Returns the readings."""
    out = {}
    for precision, (loss1, grads1) in ref.items():
        rk = [r[precision] for r in ranks_out]
        same = all(r["sha256"] == rk[0]["sha256"] for r in rk) and all(
            torch.equal(r["grads"][n], rk[0]["grads"][n])
            for r in rk for n in grads1)
        launches_ok = all(c == want_launches[precision]
                          for r in rk for c in r["launches"])
        mine = {n: g.to(grads1[n].device) for n, g in rk[0]["grads"].items()}
        loss = rk[0]["loss_mean"]
        if precision == "f32":
            share = max(float((mine[n] - g).abs().max())
                        / (TOL_GRAD * max(1.0, float(g.abs().max())))
                        for n, g in grads1.items())
            loss_share = abs(loss - loss1) / (TOL_GRAD * max(1.0, abs(loss1)))
            ok = share <= 1 and loss_share <= 1
            reading = {"worst_share_of_bar": share,
                       "loss_share_of_bar": loss_share}
        else:
            reading = grad_distance(mine, grads1)
            ok = all(reading[k] <= TOL_GRAD_BF16[k] for k in TOL_GRAD_BF16) \
                and abs(loss - loss1) <= TOL_GRAD_BF16["entry"] * abs(loss1)
        reading.update(loss=loss, loss_1rank=loss1,
                       rank_losses=[r["loss"] for r in rk],
                       ranks_bit_equal=same, launches_exact=launches_ok,
                       step_ms=[r["step_ms"] for r in rk])
        out[precision] = reading
        ok = ok and same and launches_ok
        log(f"phase {label} {precision}: {json.dumps(reading)} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label} {precision}: the ranks' step "
                                 f"disagrees with the 1-rank step or each "
                                 f"other, or launched other kernels")
    return out


def run_dp_training(torch, root, world, backend):
    """The shipped bf16 training command's train() arguments (DP_OVERRIDES)
    at the global batch N_SAMPLES through ``runtime.train.train_ranks`` at
    ``world`` ranks over ``backend``, in ``root``: every rank's parameters
    bit-equal at the end, its launches exactly DP_ITERS steps', finite
    losses, one checkpoint and one metrics.jsonl (rank 0's) whose names
    carry no ``module.``.  Returns (the ranks' summaries, the logged
    losses, the wall seconds)."""
    import numpy as np
    from diffwave_sashimi_torch.config import load_config
    from diffwave_sashimi_torch.runtime.train import train_kwargs, train_ranks
    from diffwave_sashimi_torch.utils.exp import local_directory
    data = os.path.join(root, "sc09")
    if not os.path.isdir(data):
        write_corpus(data)
    os.chdir(root)
    kwargs = train_kwargs(load_config(overrides=DP_OVERRIDES + [
        f"dataset.data_path={data}",
        f"train.batch_size_per_gpu={N_SAMPLES // world}"]))
    t0 = time.perf_counter()
    ranks_out = train_ranks(kwargs, world, backend, "cuda")
    secs = time.perf_counter() - t0
    run, ckpt = local_directory(None, MODEL_CFG, DIFFUSION_CFG, DATASET_CFG,
                                "checkpoint", makedirs=False)
    with open(os.path.join("exp", run, "metrics.jsonl")) as f:
        losses = [(r["step"], r["train/loss"]) for r in map(json.loads, f)
                  if "train/loss" in r]
    saved = torch.load(os.path.join(ckpt, "2.pkl"), weights_only=True)
    want = {k: DP_ITERS * TRAIN_BF16_STEP.get(k, 0)
            for k in ranks_out[0]["launches"]}
    prefixed = [k for k in saved["model_state_dict"]
                if k.startswith("module.")]
    log(f"phase dp_train {backend} x{world}: train_ranks() {DP_ITERS} "
        f"iterations in {secs:.2f} s wall (process start and model build "
        f"included); logged losses {losses}; checkpoints "
        f"{sorted(os.listdir(ckpt))}; ranks' losses "
        f"{[r['losses'] for r in ranks_out]}; parameter digests equal "
        f"{len({r['params_sha256'] for r in ranks_out}) == 1}; launches "
        f"{[r['launches'] for r in ranks_out]}")
    if len({r["params_sha256"] for r in ranks_out}) != 1 or any(
            r["launches"] != want for r in ranks_out):
        raise AssertionError(f"dp_train {backend}: ranks' parameters differ "
                             f"or launches are not {want}")
    if [i for i, _ in losses] != list(range(DP_ITERS)) or not all(
            np.isfinite(v) for _, v in losses) or any(
            r["losses"] != ranks_out[0]["losses"] for r in ranks_out):
        raise AssertionError(f"dp_train {backend}: logged losses {losses}")
    if sorted(os.listdir(ckpt)) != ["2.pkl"] or prefixed or sorted(
            os.listdir(os.path.join("exp", run))) != ["checkpoint",
                                                      "metrics.jsonl"]:
        raise AssertionError(f"dp_train {backend}: checkpoint files or names "
                             f"({prefixed[:3]})")
    return ranks_out, losses, secs


def check_data_parallel(torch, model, dev, launches, plain_losses):
    """Phase 27: data parallelism at the main path's width.  (a) DP_RANKS
    ranks on this one card over gloo (NCCL refuses two ranks on one
    card), CUDA tensors: their DDP step through the kernels against one
    1-rank step of the global B4 at f32 and bf16 (hold_dp_grads), then the
    shipped bf16 training through ``train_ranks`` (run_dp_training);
    (b) NCCL at one rank through the same function, whose logged losses
    must equal ``plain_losses``, the plain world-1 run's (phase 8b's
    first DP_ITERS: the same command, corpus and seed); (c) NCCL at
    DP_RANKS ranks across DP_RANKS cards, with (a)'s gates, where the
    machine has them."""
    from diffwave_sashimi_torch.parallel import launch
    ref, want = {}, {}
    for precision, m, step in (("f32", model, TRAIN_F32_STEP),
                               ("bf16", bf16_copy(torch, model),
                                TRAIN_BF16_STEP)):
        ref[precision] = counted_run(
            torch, f"dp_ref_{precision}", step, launches,
            lambda: step_grads(torch, m, *grad_batch(torch, dev), "FUSED"))
        want[precision] = {k: step.get(k, 0) for k in launches[
            f"dp_ref_{precision}"]}
    cwd = os.getcwd()
    root = tempfile.TemporaryDirectory(prefix="dwst_smoke_dp_")
    out = {}
    try:
        state = os.path.join(root.name, "state.pt")
        torch.save(model.state_dict(), state)
        cards = torch.cuda.device_count()
        cases = [("gloo", DP_RANKS, "on one card" if cards == 1
                  else "on their own cards")]
        if cards >= DP_RANKS:
            cases.append(("nccl", DP_RANKS, "across cards"))
        else:
            log(f"phase dp nccl x{DP_RANKS}: not run: NCCL takes one card a "
                f"rank, and this machine has {cards}")
        for backend, world, where in cases:
            label = f"dp_{backend}_x{world}"
            t0 = time.perf_counter()
            ranks_out = launch(dp_grad_rank, world, backend, "cuda",
                               (state,))
            out[label] = hold_dp_grads(torch, label, ranks_out, ref, want)
            out[label]["s"] = time.perf_counter() - t0
            for precision, r in out[label].items():
                if precision != "s":
                    log(f"timing: {label} {precision} training step at "
                        f"B{N_SAMPLES // world} a rank (global "
                        f"B{N_SAMPLES}), {world} processes {where}: "
                        f"{r['step_ms']} ms (CUDA events per rank; not a "
                        f"scaling figure)")
            run_root = os.path.join(root.name, label)
            os.makedirs(run_root)
            _, losses, secs = run_dp_training(torch, run_root, world, backend)
            out[label]["train_losses"], out[label]["train_s"] = losses, secs
            os.chdir(cwd)
        # (b) NCCL at one rank against the plain world-1 run
        nccl_root = os.path.join(root.name, "dp_nccl_x1")
        os.makedirs(nccl_root)
        _, losses, secs = run_dp_training(torch, nccl_root, 1, "nccl")
        plain = [tuple(x) for x in plain_losses[:DP_ITERS]]
        equal = [a == b for a, b in zip(losses, plain)]
        rel = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(losses, plain))
        out["dp_nccl_x1"] = {"losses": losses, "plain_losses": plain,
                             "bit_equal": equal, "max_rel_diff": rel,
                             "s": secs}
        ok = len(losses) == len(plain) == DP_ITERS and equal[0] and \
            rel <= 1e-5
        log(f"phase dp_nccl_x1: losses {losses} vs the plain world-1 run's "
            f"(phase 8b) {plain}; bit-equal {equal}, max relative "
            f"difference {rel:.3e} (bar: iteration 0 bit-equal, the rest "
            f"1e-5) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("NCCL at one rank trains otherwise than the "
                                 "plain world-1 run")
    finally:
        os.chdir(cwd)
        root.cleanup()
    return out


def check_generate_rank(torch, run, audio0):
    """Phase 27d: ``generate(rank=1, world=2)`` from phase 4's checkpoint
    writes the wavs ``1k_4`` to ``1k_7`` and draws other samples than rank
    0 (phase 4's, at world 1: the same seed)."""
    import numpy as np
    from diffwave_sashimi_torch.runtime.generate import generate
    audio1 = generate(DIFFUSION_CFG, MODEL_CFG, DATASET_CFG, ckpt_iter="max",
                      n_samples=N_SAMPLES, seed=SEED, device="cuda", rank=1,
                      world=2)
    wavs = sorted(os.listdir(os.path.join("exp", run, "waveforms", "1000")))
    want = [f"1k_{i}.wav" for i in range(2 * N_SAMPLES)]
    diff = float(np.abs(audio1 - audio0).max())
    log(f"phase generate_rank: rank 1 of 2 wrote {wavs}; max |rank 1 - "
        f"rank 0| {diff:.4f}, std {audio1.std():.4f}")
    if wavs != want or not np.isfinite(audio1).all() or diff < 0.1:
        raise AssertionError(f"generate(rank=1, world=2): wavs {wavs}, "
                             f"difference from rank 0 {diff}")
    return {"wavs": wavs, "max_abs_diff_vs_rank0": diff}


def main():
    t_start = time.perf_counter()
    import numpy as np
    import torch
    from diffwave_sashimi_torch import ops
    from diffwave_sashimi_torch.ops import cuda_lib
    from diffwave_sashimi_torch.runtime.checkpoint import save_checkpoint
    from diffwave_sashimi_torch.runtime.generate import generate
    from diffwave_sashimi_torch.utils.exp import local_directory

    # phase 1: build (and ptxas's report on kernels 1, 2, 3, 4, 5, 5f, 5L,
    # 7, 8, 11 and 12 beside it, and the 3xTF32 kernels' tensor-core
    # products in their code), then require the card
    t0 = time.perf_counter()
    ptxas = start_ptxas()
    cuda_lib.library()
    ptxas = ptxas_report(ptxas)
    tf32_sass = tf32_mma_sass()
    log(f"phase build: kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s; ptxas, kernels 4, 8, 5 and 5f's "
        f"and kernel 1's radix-16 routes, 5L, 12 and the 3xTF32 kernels: "
        f"{json.dumps(ptxas)}; {TF32_MMA_SASS} instructions in the 3xTF32 "
        f"kernels' code {json.dumps(tf32_sass)}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the smoke test runs on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(f"card: {smi[0]}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # phase 2: the seeded full-width model, saved as a checkpoint
    t0 = time.perf_counter()
    model = build_model(torch)
    cwd = os.getcwd()
    exp_root = tempfile.TemporaryDirectory(prefix="dwst_smoke_")
    os.chdir(exp_root.name)
    try:
        run, _ = local_directory(None, MODEL_CFG, DIFFUSION_CFG, DATASET_CFG,
                                 "checkpoint")
        save_checkpoint(os.path.join("exp", run, "checkpoint"), 1000, model)
        model = model.to(dev).eval()
        log(f"phase model: d128/n6/L16000 built and saved in "
            f"{time.perf_counter() - t0:.1f} s")

        # phase 3: kernels vs plain at every tier
        results = {}
        with torch.no_grad():
            check_kernels(torch, model, dev, results)

        # phase 4: the sampling path through generate()
        for fn in ops.COUNTED.values():
            fn.launches = 0
        t0 = time.perf_counter()
        audio = generate(DIFFUSION_CFG, MODEL_CFG, DATASET_CFG,
                         ckpt_iter="max", n_samples=N_SAMPLES, seed=SEED,
                         device="cuda")
        gen_s = time.perf_counter() - t0
        launches = {"generate": {k: f.launches
                                 for k, f in ops.COUNTED.items()}}
        log(f"phase generate: {gen_s:.2f} s wall; launches "
            f"{launches['generate']}")
        missing = [k for k, (_, _, paths) in KERNELS.items()
                   if "generate" in paths and launches["generate"][k] == 0]
        if missing:
            raise AssertionError(f"kernels never ran on the sampling path: "
                                 f"{missing}")
        if audio.shape != (N_SAMPLES, 1, 16000) or \
                not np.isfinite(audio).all():
            raise AssertionError(f"bad output {audio.shape}")
        wavs = os.listdir(os.path.join("exp", run, "waveforms", "1000"))
        if sorted(wavs) != [f"1k_{i}.wav" for i in range(N_SAMPLES)]:
            raise AssertionError(f"wav layout {sorted(wavs)}")
        log(f"output: shape {audio.shape}, finite, std {audio.std():.4f}, "
            f"wavs {sorted(wavs)}")
        # phase 27d: rank 1 of 2 samples from the same checkpoint
        dp_generate = check_generate_rank(torch, run, audio)

        # phase 4b: the shipped command, bf16 and int8, through main()
        shipped_s = run_shipped_command(torch, run, launches)
    finally:
        os.chdir(cwd)
        exp_root.cleanup()

    # phase 5: eps through the kernels vs the plain path, on the card
    with torch.no_grad():
        g = torch.Generator(device=dev).manual_seed(SEED + 2)
        x = torch.randn(N_SAMPLES, 1, 16000, device=dev, generator=g)
        steps = torch.tensor([199, 120, 40, 3][:N_SAMPLES], device=dev)
        k_fused = model.compute_kernels(16000, ops.FUSED)
        k_plain = model.compute_kernels(16000, ops.PLAIN)
        check_eps(torch, model, x, steps, "eps", (k_fused, k_plain))

        # phase 6: one sampling step's eps forward, kernels vs plain, at
        # the main path's batch and at 16
        steps_ms = {}
        for B in (N_SAMPLES, 16):
            xb = torch.randn(B, 1, 16000, device=dev, generator=g)
            sb = torch.randint(0, 200, (B,), device=dev, generator=g)
            steps_ms[B] = paired_ms(
                lambda: model(xb, sb, k_fused, ops.FUSED),
                lambda: model(xb, sb, k_plain, ops.PLAIN), 5)
    T, sr = DIFFUSION_CFG["T"], DATASET_CFG["sampling_rate"]
    rtf = {B: B * 16000 / sr / (T * ms / 1000) for B, (ms, _) in
           steps_ms.items()}
    for B, (ms, plain_ms) in steps_ms.items():
        log(f"timing: eps forward (one sampling step) at B{B} {ms:.3f} ms "
            f"with kernels vs {plain_ms:.3f} ms plain; T={T} -> "
            f"{rtf[B]:.3f}x realtime from the step time")
    log(f"timing: generate() at B{N_SAMPLES}: "
        f"{N_SAMPLES * 16000 / sr / gen_s:.3f}x realtime from its wall time "
        f"(model build + load, S4 kernels, {T} steps, wav writes)")

    # phases 6b-6d: the bf16 and int8 kernels at every tier; eps, quality,
    # timing and traces of the bf16 and int8 paths
    with torch.no_grad():
        check_bf16_kernels(torch, model, dev, results)
        bf16_path = check_bf16_path(torch, model, dev)
    bf16_path["generate_s"] = shipped_s

    # phase 7: the training kernels vs plain at every tier; 7b their bf16
    # forms
    with torch.no_grad():
        check_training_kernels(torch, model, dev, results)
        check_bf16_training_kernels(torch, model, dev, results)
        # phase 7c: the training route past FFT size 32768 (kernel 9's
        # training entries, kernel 5L)
        check_long_training_kernels(torch, dev, results)

    # phase 8: the training path through runtime.train.main; 8b the
    # shipped (bf16) training command, in a directory of its own
    def in_temp_dir(label, run_fn):
        root = tempfile.TemporaryDirectory(prefix=f"dwst_smoke_{label}_")
        os.chdir(root.name)
        try:
            return run_fn(torch, root.name, launches)
        finally:
            os.chdir(cwd)
            root.cleanup()
    in_temp_dir("train", run_training)
    train_bf16 = {"main": in_temp_dir("train_bf16", run_training_bf16)}

    # phases 9 and 10: gradients kernels vs plain (9b at bf16), the bf16
    # trajectory (9c), then the step's time
    check_gradients(torch, model, dev)
    train_bf16["grads"] = check_gradients_bf16(torch, model, dev)
    train_bf16["trajectory"] = check_bf16_trajectory(torch, model, dev)
    train_ms, train_plain_ms = time_train_step(torch, model, dev)
    log(f"timing: training step (forward, backward, Adam) at B{N_SAMPLES} "
        f"{train_ms:.3f} ms with kernels vs {train_plain_ms:.3f} ms plain")
    trace = profile_train_step(torch, model, dev)
    log("trace: training step with the kernels: " + (
        "no device time in the profiler's events (not measured)"
        if trace is None else json.dumps(trace)))
    train_bf16["step"] = time_train_step_bf16(torch, model, dev)

    # phases 12-14: the vocoder through generate(), the precomputed mel
    voc_root = tempfile.TemporaryDirectory(prefix="dwst_smoke_voc_")
    os.chdir(voc_root.name)
    try:
        voc_model, mel, voc_L, voc_secs = run_vocoder(
            torch, voc_root.name, launches, dev)
        voc_gen_s = voc_secs["vocode"]
    finally:
        os.chdir(cwd)
        voc_root.cleanup()

    # phases 15-17: the vocoder's kernels (15b: 9f), eps and step; 16b and
    # 17b at bf16
    with torch.no_grad():
        check_vocoder_kernels(torch, voc_model, voc_L, dev, results)
        voc_ms, voc_plain_ms, voc_trace = check_vocoder_step(
            torch, voc_model, mel, voc_L, dev)
        voc_bf16 = check_vocoder_bf16(torch, voc_model, mel, voc_L, dev)
    voc_T = VOC_DIFFUSION_CFG["T"]
    voc_audio_s = VOC_SAMPLES * voc_L / VOC_DATASET_CFG["sampling_rate"]
    voc_rtf = voc_audio_s / (voc_T * voc_ms / 1000)
    log(f"timing: vocoder eps forward (one sampling step) at "
        f"B{VOC_SAMPLES} L{voc_L} {voc_ms:.3f} ms with kernels vs "
        f"{voc_plain_ms:.3f} ms plain; T={voc_T} -> {voc_rtf:.3f}x realtime "
        f"from the step time; generate() {voc_audio_s / voc_gen_s:.3f}x "
        f"realtime from its wall time (model build + load, mel, mel terms, "
        f"S4 kernels, {voc_T} steps, wav and fidelity writes)")
    log("trace: vocoder step with the kernels: " + (
        "no device time in the profiler's events (not measured)"
        if voc_trace is None else json.dumps(voc_trace)))
    voc_bf16["generate_s"] = voc_secs["vocode_bf16"]
    voc_bf16["realtime_factor_generate"] = (voc_audio_s
                                            / voc_secs["vocode_bf16"])
    log(f"timing: the shipped vocoding command at bf16: "
        f"{voc_bf16['realtime_factor_generate']:.3f}x realtime from its wall "
        f"time (as phase 13's, plus the config's load)")
    del voc_model
    torch.cuda.empty_cache()

    # phases 25 and 26: vocoder training through runtime.train.main on
    # synthetic clips, experiment=ljspeech at bf16 and f32 and
    # experiment=ljspeech_harder at bf16, each with exact launch counts;
    # their gradients, kernels vs plain; 26's kernels at its tiers
    def train_vocoder(runs, cfg, dataset):
        return lambda torch, root, launches: run_vocoder_training(
            torch, root, launches, runs, cfg, dataset)
    voc_train = in_temp_dir("voc_train", train_vocoder(
        [("vocoder_train", ["experiment=ljspeech"], TRAIN_BF16_STEP),
         ("vocoder_train_f32", ["experiment=ljspeech",
                                "compute.precision=f32"], TRAIN_F32_STEP)],
        VOC_MODEL_CFG, VOC_DATASET_CFG))
    voc_train["grads"] = check_vocoder_train_grads(
        torch, VOC_MODEL_CFG, VOC_DATASET_CFG, N_SAMPLES, dev,
        "vocoder_train")
    harder = in_temp_dir("harder_train", train_vocoder(
        [("vocoder_train_harder", ["experiment=ljspeech_harder"],
          HARDER_BF16_STEP)], HARDER_MODEL_CFG, HARDER_DATASET_CFG))
    harder["grads"] = check_vocoder_train_grads(
        torch, HARDER_MODEL_CFG, HARDER_DATASET_CFG, HARDER_SAMPLES, dev,
        "vocoder_train_harder", HARDER_GRAD_LAYERS, trace=True)
    with torch.no_grad():
        check_harder_kernels(torch, dev, results)

    # phases 18-20: the WaveNet checkpoint, kernel 11, sampling through
    # generate()
    wn_root = tempfile.TemporaryDirectory(prefix="dwst_smoke_wnet_")
    os.chdir(wn_root.name)
    try:
        wn_model, wn_run = build_wavenet(torch)
        wn_model = wn_model.to(dev).eval()
        with torch.no_grad():
            check_gate_kernel(torch, wn_model, dev, results)
        wn_secs = run_wavenet_generate(torch, wn_run, launches, dev)
    finally:
        os.chdir(cwd)
        wn_root.cleanup()

    # phases 21 and 22: WaveNet eps kernel vs plain, step times, a trace;
    # 21b and 22b at bf16
    with torch.no_grad():
        cond = build_wavenet_cond(torch, dev)
        wn = check_wavenet_step(torch, wn_model, cond, dev)
        wn_bf16 = check_wavenet_bf16(torch, wn_model, cond, dev)
    del cond
    torch.cuda.empty_cache()
    for out, path in ((wn, "wavenet"), (wn_bf16, "wavenet_bf16")):
        out["generate_s"] = wn_secs[path]
        out["realtime_factor_generate"] = N_SAMPLES / wn_secs[path]
        log(f"timing: {path} sampling at B{N_SAMPLES}: "
            f"{out['realtime_factor_generate']:.3f}x realtime from its wall "
            f"time (model build + load, {DIFFUSION_CFG['T']} steps, wav "
            f"writes)")

    # phase 23: WaveNet training through runtime.train.main
    wn_train_root = tempfile.TemporaryDirectory(
        prefix="dwst_smoke_wnet_train_")
    os.chdir(wn_train_root.name)
    try:
        wn["train_losses"], wn["train_step_ms"] = run_wavenet_training(
            torch, wn_train_root.name, wn_model, launches, dev)
    finally:
        os.chdir(cwd)
        wn_train_root.cleanup()
    # phase 23b: the shipped (bf16) WaveNet training command and the bf16
    # trajectory gate
    wn_train_bf16 = in_temp_dir(
        "wnet_train_bf16", lambda torch, root, launches:
        run_wavenet_training_bf16(torch, root, wn_model, launches, dev))
    del wn_model
    torch.cuda.empty_cache()

    # phase 24: the d_model 256 model through the kernels
    d256 = check_wide_model(torch, dev, launches, results)

    # phase 27: data parallelism at the main path's width
    # (its own seeded model, phase 2's before any training phase: phase
    # 10's Adam steps do not repeat bit for bit from call to call)
    data_parallel = check_data_parallel(torch, build_model(torch).to(dev),
                                        dev, launches,
                                        train_bf16["main"]["losses"])
    data_parallel["generate_rank"] = dp_generate
    log(f"card: {smi[0]}")

    entries = []
    for name, (src, rep, paths) in KERNELS.items():
        tier = TOP_TIER.get(name) or (
            f"H128_L{voc_L}" if name.startswith("fftconv_long")
            else "H128_L16000")
        r, top = results[name], results[name]["tiers"][tier]
        per_path = {p: launches[p][name] for p in PATHS}
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(per_path.values()),
            "launches_per_path": per_path,
            "max_abs_err": r["max_abs_err"], "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None,
            "tiers": r["tiers"]})
        for key in ("gemm_ms", "gemm_pair_ms", "weights_scratch_ms",
                    "weights_in_kernel_ms", "gemm_triple_ms",
                    "wgrad_gemm_pair_ms", "wgrad_gemm_ms", "split_ms",
                    "plan_P", "p_ms", "three_pass_ms",
                    "ms_vs_three_pass", "cluster_ms", "ms_vs_cluster",
                    "cufft_conv_ms", "stockham_ms", "ms_vs_stockham",
                    "radix16_ms", "ms_vs_radix16", "conj_stockham_ms",
                    "conj_ms_vs_stockham", "conj_radix16_ms",
                    "conj_ms_vs_radix16", "c128_err", "plain_c128_err",
                    "bit_equal", "plan", "device_ms", "c128_l2",
                    "plain_c128_l2", "stockham_c128_l2", "graph_ms",
                    "stockham_graph_ms", "rows_ms", "cufft_rfft_ms",
                    "stockham_max_abs_err", "two_pass_graph_ms",
                    "two_pass_c128_l2", "two_pass_max_abs_err",
                    "allocations", "bit_equal_composite",
                    "composite_graph_ms", "c64_err", "plain_c64_err",
                    "repeat_bit_equal", "c64_errs",
                    "plain_c64_errs", "stockham_c64_err",
                    "conj_graph_ms", "conj_stockham_graph_ms",
                    "conj_c64_err", "conj_plain_c64_err",
                    "conj_stockham_c64_err", "conj_stockham_max_abs_err",
                    "yardstick_graph_ms", "graphs"):
            # yardsticks and parts, not library calls
            if key in top:
                entries[-1][key] = top[key]
        for key in ("vs_f64_max_rel", "max_active_clusters"):
            if key in r:
                entries[-1][key] = r[key]
        entries[-1].update(kernel_parts(name, ptxas, tf32_sass))
        if name in ("ln_ff_res_bwd", "ln_ff_res", "gate_res_skip",
                    "glu_res"):
            # the bound with every product on the fp32 FMAs, as before the
            # 3xTF32 products (a tf32 count is three products' operations)
            ops_, nbytes = work(name, N_SAMPLES, *(
                (256, 16000, 32768, 6, 32, 256) if name == "gate_res_skip"
                else (128, 16000, 32768)))
            fp32 = ops_.get("fp32", 0) + ops_.get("tf32", 0) / 3
            entries[-1]["fp32_bound_ms"] = 1e3 * max(
                fp32 / PEAK_OPS["fp32"], nbytes / PEAK_BYTES)
        if name.startswith("fftconv_long"):     # the same function
            entries[-1]["also_replaces"] = (
                "diffwave_sashimi_tpu/ops/fftconv_pallas.py:126")
    log(json.dumps({
        "kernels": entries,
        "step_ms": {str(B): ms for B, (ms, _) in steps_ms.items()},
        "step_plain_ms": {str(B): p for B, (_, p) in steps_ms.items()},
        "realtime_factor": {str(B): r for B, r in rtf.items()},
        "train_step_ms": {str(N_SAMPLES): train_ms},
        "train_step_plain_ms": {str(N_SAMPLES): train_plain_ms},
        "train_step_trace": trace,
        "vocode": {"step_ms": {str(VOC_SAMPLES): voc_ms},
                   "step_plain_ms": {str(VOC_SAMPLES): voc_plain_ms},
                   "realtime_factor_step": voc_rtf,
                   "realtime_factor_generate": voc_audio_s / voc_gen_s,
                   "generate_s": voc_gen_s, "trace": voc_trace},
        "wavenet": wn,
        "wavenet_bf16": wn_bf16,
        "vocode_bf16": voc_bf16,
        "bf16_int8": bf16_path,
        "train_bf16": train_bf16,
        "vocoder_train": voc_train,
        "vocoder_train_harder": harder,
        "wavenet_train_bf16": wn_train_bf16,
        "d256": d256,
        "data_parallel": data_parallel,
        "seconds": time.perf_counter() - t_start}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # any failed phase: non-zero exit, no result
        import traceback
        traceback.print_exc()
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
