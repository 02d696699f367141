#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``avsr_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero before the final line:

1. device  — require CUDA; print ``nvidia-smi`` name and power limit.
2. build   — compile the CUDA kernels from ``avsr_tpu_torch/csrc`` into
             ``build/`` (one nvcc per source, all started together,
             sm_90a) and print the build time.
3. K1      — the BiLSTM recurrence kernel (one cluster launch per call,
             ``kernels.lstm_family`` "cluster") against its plain PyTorch
             version on the card at [G=2, H=256], bf16, ragged lengths with a
             0-length row, at every (T, B) the paths launch (``K1_SHAPES``:
             T = 50, 99, 150, 197 at B=128; B=8 and B=1; 16 s, T=531, at
             B=4; ``K1_BUCKET_SHAPES``: the train buckets' 17 more of
             phases 46-47, T = 17-531 at B = 128, 64, 32): max errors, two launches bit-equal, the 0-length row's
             state kept; device ms and per-step us; the cluster kernels'
             registers, spills and HMMA count (ptxas -v, cuobjdump), their
             shared memory against ``kernels.lstm_cluster_smem`` and their
             max active clusters; median CUDA-event times (B=128, B=8); and,
             as a reference point that computes more (the input product
             too), cuDNN's bidirectional ``nn.LSTM`` at the same T, B, H.
4. K3      — the post-DFT log-mel kernel (three launches: the banded mel
             product, the statistics, the writer) against its plain version
             at B=128 and B=8, 6 s and 16 s (S=96000 and 256000 at 16 kHz),
             ragged lengths with a row of no full frame and one shorter than
             a stack: errors, equal lengths, two launches bit-equal; times,
             device ms of the call and of each launch apart, the bound.
5. serve   — the full-width ``lrs2_av_fast`` model (random weights from a
             seeded generator) behind a CUDA ``Predictor`` with compact
             transfer, batch 8, 6 s audio / 150 frames, width-10 beam with
             horizon 150: transcribe 3 requests of 8 ragged utterances,
             require that the serving kernels (K1 fwd, K3, K4 fwd) launched
             during those requests, check the ids' shape and range, and
             hold the fused decoder memory of the kernel path against the
             plain path on the card.
6. K1 bwd  — the LSTM backward kernel against its plain twin on the same
             residuals and random cotangents at phase 3's shapes: errors on
             dxw, db, dh0, dc0 and dWh, two launches bit-equal, the 0-length
             row passing dhT/dcT through; device ms and per-step us; times
             at B=128 and B=8.
7. K4      — the fusion attention kernels (tensor cores), forward and
             backward, against their plain twins at [B=128, 4 heads,
             T_a=50, T_v=150, A=dv=128] (the fast model), T_a=197 (v2),
             the 16 s limits [B=4, T_a=133 and 531, T_v=401] and the
             (A, dv) = (128, 64) instance, ragged video lengths including 0
             (uniform weights required there), both backwards fed the plain
             forward's row statistics: errors on ctx, P, the weights the
             kernel's statistics give, dq, dk, dv; two launches bit-equal;
             the backward's allocations (no [B, nh, T_a, T_v] tensor); the
             kernels' registers, spills and HMMA count (as phase 20); at the
             fast and v2 shapes times, device times of the kernels and of
             the library yardstick (scaled_dot_product_attention and its
             backward, as in phase 25) and the bounds.
8. train   — the full-width ``lrs2_av_fast`` train step at B=128, 6 s,
             label cap 80, AU targets, dropout 0.1, noise mixing on (a
             seeded synthetic two-type bank): (a) the loss and every
             gradient leaf of the kernel path against the plain path with
             the same generator seed, each kernel-path gradient present,
             finite and not all zero; (b) every kernel launched during the
             training steps; (c) 10 steps on one batch at a constant lr,
             the last loss below the first; (d) median ms per step after 2
             warm-up steps, 10 ms audio frames/s, peak device memory.
9. K5      — the teacher-forced decoder attention kernels (tensor cores;
             the cross attention on decoder_cross_attention.cuh's own
             kernels), forward and backward, against their plain twins: causal self
             attention [B=128, Q=S=80, 4 heads, dk=dv=64] and at the
             150-label horizon (Q=S=150), cross attention under the memory
             bias [B=128, Q=80, dk=128, dv=256] over the fast model's memory
             (S=50), v2's (S=197) and v2's 16 s limit [B=4, Q=80 and 150,
             S=531], each memory with a row of length 0 (uniform weights
             required there), both backwards fed the plain forward's row
             statistics: errors on ctx, the weights the kernel's statistics
             give, dq, dk, dv; two launches bit-equal; the backward's
             allocations (no [B, nh, Q, S] tensor); registers, spills and
             HMMA count (as phase 20); at the fast and v2 shapes times,
             device times of the kernels and of the library yardstick
             (scaled_dot_product_attention and its backward, same mask) and
             the bounds; then one lrs2_av_v2 train step at B=4 with a 16 s
             utterance (loss finite, every gradient leaf present).
10. K6     — single-query decode attention against its plain twin at a
             beam step (N=80 rows: B=8 utterances of W=10 beams, the memory
             untiled) and a greedy step (N=128, W=1): self at pos 0/37/149
             over the KV cache [L=150, 4x64], cross over the fast, the v2
             and the 16 s memories [S=50, 197, 531, dk=128, dv=256] with a
             length-0 row (its beams read the mean of its values), and off
             the main path (self at 4x32, cross at (64, 96) with W=3); two
             launches bit-equal; the routes' shared memory against the
             library's; times, device times (self and cross apart), the
             bound (the untiled memory read once, beside the beam-tiled
             read's) and the yardstick of one step's pair at both
             memories, and of greedy's pair.
11. K7     — the fused beam step against its plain twin at (B, W, V) =
             (8, 10, 44), (8, 10, 31), (128, 10, 44), (1, 10, 44), (8, 1,
             44), (8, 32, 44) and the largest W * V the wrapper takes, (8,
             1, 6128) and (8, 10, 612): random logits and states with dead
             and finished beams, no finished beam, every beam finished,
             crafted exact ties (lower flat index first), alpha 0 and 0.6
             (identical parents, tokens, flat parents, lens, finished, feeds
             and settled flags; logp within tolerance); at each shape the
             CUDA-event ms of a search's step (``kernels.BeamStep``) and of
             the one-shot call, the device ms, and beside them the device
             ms of an empty kernel, the floor of a launch.
12. greedy — greedy decode of one B=128 batch of 6 s utterances, horizon
             150, on the kernel path (K6 launches counted) and on the plain
             path: decode ms, steps; at most 16 rows whose ids differ.
13. K8     — the AV-Align fusion scan's forward (one persistent launch of
             16-CTA clusters a call, ``kernels.av_align_family`` "cluster")
             against its plain twin at [H=256, A=128, Dv=512], bf16, ragged
             audio and video lengths with a 0-length row of each, at the
             serving, train and 16 s shapes (``K8_FWD_SHAPES``: [T_a=197,
             B=8 and 128, T_v=150], [531, 32, 401]), in save mode: errors on
             hs, ctxs, aligns, the final and the saved carries; exact zeros
             of the empty rows; reruns (and the run without save)
             bit-equal; the kernel's registers, spills and HMMA count, its
             shared memory against ``kernels.av_align_fwd_smem`` and max
             active clusters; device ms at each shape, us a step in one
             cluster with and without masked steps; times.
14. K10    — the Bahdanau read against its plain twin at N=80 and 128,
             S=197, A=128, Dv=768, with a length-0 row (zero context and
             weights required): errors on ctx and weights; times.
15. serve-align — the full-width ``lrs2_av_align`` model (AV-Align fusion,
             attention-LSTM decoder; random weights from a seeded
             generator) behind a CUDA ``Predictor`` as in phase 5: 3 requests
             of 8 ragged 2-6 s utterances, width-10 beam, horizon 150;
             requires K1 fwd, K3, K8, K10 and K7 launches, holds the fused
             memory and the beam on the same memories against the plain
             path.
16. greedy-align — a B=128, 6 s, horizon 150 greedy decode of the same
             model, kernel path against plain path (K10 launches counted).
17. K8 bwd — the AV-Align fusion scan's backward against its plain twin at
             [T_a=197, B=128, H=256, T_v=150, A=128, Dv=512] on the kernel
             forward's saved carries and random cotangents, ragged with a
             0-length audio row and a 0-length video row, and at the 16 s
             limits [T_a=531, B=16, T_v=401]: errors on dxw, db, dq,
             dkeys, dvalues and the weight gradients dWh, dctx_proj, dwq,
             dv; the empty rows' gradients exactly zero; two launches
             bit-equal; its kernels' registers, spills and HMMA count and
             the recurrence's max active clusters; times, the device ms of
             its three stages apart (the regate and the queries, the
             recurrence, the memory's gradients) and the bound.
18. K10 bwd — the Bahdanau read's backward as the teacher-forced loop runs
             it: a K=80 read loop at N=128, S=197, A=128, Dv=768 with a
             length-0 row, each step's kernel (dquery and the saved rows
             dsc, dctx, q, dq, dv) in reverse order, then the memory's sums
             once (``av_align_bwd.cuh``'s, routed by width), against the
             plain mirror on the same weights: errors on dquery, the rows,
             dkeys, dvalues, dwq, dv; the length-0 row's exactly zero; a
             second run bit-equal; one loop at S=531 (N=16, K=8); registers
             and spills of every instance, the shared memory and max active
             clusters (two CTAs a row); a step's device ms and the sums' per
             loop, beside their bounds.
19. train-align — the full-width ``lrs2_av_align`` train step at B=128,
             6 s, label cap 80, AU targets, dropout 0.1, noise mixing on,
             as phase 8: (a) with scheduled sampling off, the loss and every
             gradient leaf of the kernel path against the plain path with
             the same generator, every leaf present, finite and nonzero;
             (b) with the preset's sampling probability 0.1, every kernel
             of the path launched (K8 and K10 forward and backward among
             them); (c) 10 steps at a constant lr 1e-4, the loss falling;
             (d) ms per step, frames/s, peak memory and a profile.
20. K11    — the transformer encoder's self-attention core (tensor cores)
             against its plain version at [B=128, 8 heads, T=197, dh=64] on
             one [B, T, 3, 8, 64] product, at the video layer's T=150 and at
             the 16 s limit (T=531, B=4), ragged lengths with a 0-length row
             (the mean of all T values required there): errors on ctx, two
             launches bit-equal; the kernels' registers and spills (ptxas
             -v: none may spill) and HMMA count (cuobjdump: none may have
             zero); times, device time, the bound and the library yardstick
             (scaled_dot_product_attention, same mask).
21. K9     — the conformer conv module between its pointwise products
             against its plain version at [T=197, B=128, d=512, k=15],
             ragged with a 0-length row, and again at T=531, B=4: errors;
             times, device time, the bound and a yardstick covering part of
             the function (the depthwise conv1d alone).
22. serve-v2 — the full-width scan-free ``lrs2_av_v2`` model (transformer
             encoders with the conformer conv, cross-attention fusion,
             transformer decoder; random weights from a seeded generator)
             behind a CUDA ``Predictor`` as in phase 5: 3 requests of 8
             ragged 2-6 s utterances, width-10 beam, horizon 150; requires
             K3, K11, K9, K4, K6 and K7 launches, holds the fused memory
             [8, 197, 1024] and the beam on the same memories against the
             plain path.
23. greedy-v2 — a B=128, 6 s, horizon 150 greedy decode of the same model,
             kernel path against plain path.
24. no-autograd — phase 23's batch once more through ``Predictor.encode``
             and ``greedy_decode`` with every parameter ``requires_grad`` (a
             train state's): no output may carry a graph, no autograd
             Function of the port may be entered and every decoder step
             must run with autograd off.
25. K11 bwd — the encoder self-attention backward (and the save-mode
             forward that writes the softmax's row statistics) against the
             plain twins at phase 20's three shapes, both backwards fed the
             plain forward's statistics, ragged with a 0-length row (its dv
             must be the mean of dctx): errors on ctx, the weights the
             kernel's statistics give, dq, dk, dv; two launches bit-equal;
             times, device time, the bound and the library yardstick
             (scaled_dot_product_attention's backward, same mask).
26. K9 bwd — the conformer conv module's backward against its plain twin at
             [T=197, B=128, d=512, k=15] and at T=531, B=4 (the fused
             route: one pass over time per item) and at [T=70, B=5,
             d=1024] (the general route), ragged with a 0-length row:
             errors on du, db_in, ddw, dln_scale, dln_bias, each to its own
             tolerance; the padded steps' du exactly zero; two runs
             bit-equal; the plan's shared memory against the library's;
             times and the yardstick (the depthwise conv1d backward alone).
27. train-v2 — the full-width ``lrs2_av_v2`` train step at B=128, 6 s,
             label cap 80, AU targets, encoder dropout 0.1, noise mixing on,
             as phase 8: (a) the loss and every gradient leaf of the kernel
             path against the plain path with the same generator, every
             leaf present, finite and nonzero; (b) every kernel of the path
             launched (K11 and K9 forward and backward among them); (c) 10
             steps at a constant lr 3e-5, the loss falling; (d) ms per step,
             frames/s, peak memory and a profile with K11's share of the
             device time.
28. K2     — the one-direction LSTM scan (K1's kernels at G=1, counted
             apart) against the plain twins at [G=1, H=256] and (T, B) =
             (197, 128), (150, 128), (197, 8), (197, 1) and (531, 4), bf16,
             ragged with a 0-length row and a nonzero h0/c0 (which that row
             must return as hT/cT, passing dhT/dcT through to dh0/dc0):
             errors on ys, hT, cT and dWh, db, dxw, dh0, dc0; two launches
             bit-equal; times, device times, per-step us and the bounds.
29. K10 Luong — the Luong read (the dot score of ``bahdanau_core.cuh``)
             against the plain twin at N=80 and 128, S=197, Hk=Dv=512 (one
             bf16 memory as keys and values), with a length-0 row (zero
             context and weights required); its backward as phase 18's
             read loop (K=80 at N=128, and S=531); times and the bounds.
30. K8 Luong — the AV-Align fusion scan's Luong instance [H=256,
             Hk=Dv=256], forward as phase 13, and its backward at B=128 and
             at the 16 s limits, as phase 17: errors, exact zeros of the
             empty rows, bit-equal reruns, times, the stages apart and the
             bounds.
31. serve-uni-luong — the full-width ``lrs2_av_align_uni_luong`` model
             (``lrs2_av_align`` with one-direction encoders and Luong reads)
             behind a CUDA ``Predictor`` as in phase 15; requires K2, K3, the
             Luong K8 and K10 and K7 launches; fused memory [8, 197, 512].
32. greedy-uni-luong — a B=128, 6 s, horizon 150 greedy decode of the same
             model, kernel path against plain path (Luong K10 launches).
33. no-autograd-uni-luong — phase 32's batch through ``Predictor.encode``
             and ``greedy_decode`` with ``requires_grad`` parameters, as 24.
34. train-uni-luong — ten full-width ``lrs2_av_align_uni_luong`` train
             steps at B=128, as phase 19: the loss and every gradient leaf
             against the plain path, every leaf present, finite and nonzero,
             every kernel of the path launched (K2 and the Luong K8 and K10
             forward and backward), the loss falling; ms per step, frames/s,
             peak memory and a profile.
35. core route — one head width per attention kernel with no tensor-core
             instance, on the CUDA-core kernels through the module's
             autograd Function, forward and backward, against the plain
             twins: K11 at dh=32 (d=512, 16 heads), K4 at A=dv=64, K5's self
             attention at dh=32 and its cross attention at (64, 128); K10's
             read loop (both reads) at widths whose memory sums take the
             CUDA-core kernel (A=40, Dv=72; Luong Hk=Dv=72).
36. LSTM step route — the per-step LSTM kernels at a width the cluster
             kernels do not take (H=512: the [512 x 256] Wh slice, 256 KB,
             does not fit one CTA of an 8-CTA cluster; ``lstm_family``
             "step"), forward and backward against the plain twins at
             [T=50, G=2, B=20, H=512] ragged with a 0-length row, and at G=1
             with a nonzero h0/c0.

37. K8 step route — K8 forward's per-step kernels at widths only they take
             (Bahdanau at A=64, Luong at Hk=Dv=192; ``av_align_family``
             "step") against the plain twins, as phase 13's checks; K8
             backward's per-step kernels (``av_align_bwd_family`` "step")
             at widths the cluster recurrence refuses (Bahdanau A=72, Luong
             Hk=Dv=192) against the plain twin, as phase 17's checks, their
             build (no spill), and a fusion train step at both widths
             through ``AVAlignScan``: every gradient leaf present, finite and
             nonzero, K8 launched, each leaf against the same step on the
             plain twins.
38. serve-audio — the full-width ``audio_tcdtimit`` model (log-mel, 3-layer
             BiLSTM without time reduction, attention-LSTM decoder reading
             the [8, 197, 512] audio memory with Bahdanau's score) behind a
             CUDA ``Predictor`` as in phase 5, audio-only requests; requires
             K3, K1, the grouped K10 read at Dv = 512 and K7.
39. serve-video — the full-width ``video_tcdtimit`` model (lip-ROI CNN,
             1-layer BiLSTM, the decoder over [8, 150, 512]), video-only
             requests; requires K1, the grouped K10 and K7.
40. serve-video-au — the same with ``video.use_au_features``: float32
             AU-intensity requests [T_v, 2] through the linear bypass.
41. serve-bimodal — the full-width ``bimodal_tcdtimit`` model: the decoder
             reads the audio [8, 197, 512] and the video [8, 150, 512]
             memories, two grouped K10 reads a beam step; both memories
             held against the plain path.
42. greedy-bimodal — a B=128, 6 s, horizon 150 greedy decode of the same
             model, kernel path against plain path (two row reads a step).
43. no-autograd-bimodal — phase 42's batch through ``Predictor.encode``
             and ``greedy_decode`` with ``requires_grad`` parameters, as 24.
44. train-bimodal — ten full-width ``bimodal_tcdtimit`` train steps at
             B=128, as phase 19: the loss and every gradient leaf against the
             plain path, every leaf present, finite and nonzero, K1 and K3,
             and K10's row read, step backward and memory sums at Dv = 512
             over two read loops open at once; the loss falling.
45. eval-noisy — the records-to-CER eval of the full-width
             ``av_align_noisy`` model: synthetic records and a babble / cafe
             noise bank written and read back with the port's record code,
             the bucketing loader, ``to_model_batch``, the fixed-SNR encode
             (``eval_snr``), ``loss_given_encode`` and the width-10 beam on
             the same encode, scored by ``ErrorRateAccumulator`` at clean,
             babble 0 dB and cafe -5 dB; the card's fixed-SNR mix of one
             batch against the CPU's (the host's draws, equal by
             construction); CER, WER, loss and ms per condition, and which
             host path (native library or Python) framed and scored.
46. trainer-align — the ``AVSR`` API on the full-width ``lrs2_av_align``
             preset (random weights from its seed) on the card: 288
             synthetic train and 48 eval utterances of 1.6-6 s
             (``character_lrs2``) and a babble / cafe noise bank written
             with the port's record code, read through ``noise.bank_records``;
             run A warms up (a step per bucket), trains 2 epochs with
             checkpoints every 2 steps and a beam eval an epoch; run B is
             stopped by ``request_stop`` after the first step of epoch 2;
             run C, a new ``AVSR`` over B's directory, resumes it (its
             restored state must equal B's bit for bit, its losses A's
             within ``RESUME_LOSS_REL_TOL``; whether they are bit-equal is
             printed), averages the checkpoints, evaluates
             ``checkpoint="best"``, runs the clean / babble 0 dB / cafe 0 dB
             matrix and ``predict(n_best=3)``; every checkpoint needs its
             files, its extra and ``best.json``; prints train ms a step
             (CUDA events), the epochs' frames/s, the synchronizing calls a
             step (``set_sync_debug_mode("warn")``), warm-up seconds,
             checkpoint save ms and MB, eval seconds and utterances/s per
             condition, the warm-up steps' losses (all finite); requires
             K1, K3, K8, K10's row read, step backward and sums, K10's
             grouped read and K7.
47. cli-fast — ``cli.main`` in process on the full-width ``lrs2_av_fast``
             preset: ``write-records``, ``show-config`` with the records and
             1 epoch, ``train``, ``train --resume --epochs 2``, ``evaluate
             --greedy``, ``average-checkpoints``, ``decode``; requires K1,
             K3, K4 and K5 forward and backward, K6 and K7.
49. export — the serving artifacts of phases 46-47's runs in the 2, 6
             and 10 s buckets (``SERVE_BUCKETS``: B = 8, compact transfer):
             ``lrs2_av_fast`` through ``cli export --seconds 2,6,10 --n-best
             3``, ``lrs2_av_align`` through ``export_serving_artifact`` with
             the beam and greedy; each loaded by ``load_predictor`` onto the
             card decodes a B = 8 ragged request in each bucket (routed there
             by its lengths), ids and scores bit-equal to the in-process
             ``Predictor`` on the same parameters and padded batch, and so
             are the encoder's memories, the search's whole result and (the
             RNN decoder) teacher-forced logits over random tokens
             (``artifact_internals``); ``transcribe`` / ``transcribe_nbest``
             give those ids' texts; ``cli transcribe`` of a ``.wav`` and two
             ``.npy`` waveforms with ``.npy`` ROIs from the fast artifact;
             the launches counted are each artifact's decodes alone
             (``artifact_*``) and the command's (``cli_transcribe``);
             requires K1, K3, K4, K6 and K7 (fast, and the command), K1, K3,
             K8, K10's grouped read and K7 (align beam), K10's row read
             (align greedy), none of another route; prints export and load
             seconds, MB, decode ms a bucket.
50. serve-http — ``serve_host.make_server`` on the fast artifact on
             127.0.0.1 in a thread: 24 single-utterance requests of 1.6-9 s
             on the compact wire from 24 concurrent clients, then from one
             client in sequence (each its utterance's n-best alone, three
             held equal to ``transcribe_nbest`` of it), then concurrently
             under the profiler; every reply 200, fewer batches than
             requests under concurrency, at most ``SERVE_MAX_DIFF_TEXTS``
             concurrent replies other than the utterance's alone (its text,
             or a shared hypothesis's score past ``SERVE_SCORE_RTOL``), every
             reply bit-equal to its utterance decoded alone in the bucket its
             batch took, no two utterances' n-best lists equal; prints p50
             / p90 latency at 1 and 24 clients, utterances/s, utterances a
             batch, hits per bucket and the device busy share.
51. K1 rd  — K1 / K2 under a recurrent-dropout mask (1/0.8, not a power
             of two; ``kernels.LAUNCHES`` ``lstm_scan[_uni]_rd_*``), forward in
             save mode and backward, against the masked plain twins at G=2,
             H=256 (the cluster route) at the two paths' shapes [T=197 and
             150, B=128 and 8] and the train buckets' audio and video steps,
             at G=1 [197, 128] and [531, 4] (nonzero h0/c0), and at H=80 (the
             per-step route, G=2 and 1, [50, 20]), ragged with a 0-length
             row: errors on ys, hT, cT, the saved operand bf16(h * rd) and c,
             dWh, db, dxw, dh0, dc0; reruns bit-equal; the 0-length row's
             state and cotangents passed through; at [197, 128] device ms a
             call and us a step beside the unmasked kernel's at the same
             shape, times and the bound.
52. K12    — the GRU scan forward in save mode and backward against the
             plain twins at phase 51's shapes, each call's family printed:
             the cluster route (``csrc/gru_cluster.cuh``, one launch a call)
             at H = 256, the per-step kernels (``csrc/gru_scan.cu``) at H =
             80: errors on ys, hT, h_res, dWh, db, dxw, dh0; reruns
             bit-equal; the 0-length row; both routes' shared memory
             against ``kernels.gru_step_smem`` / ``gru_cluster_smem``,
             resident clusters; registers and spills (``ptxas -v``; a
             cluster instance's spill fails); at [197, 128] and the step
             route's [50, 20] device ms, us a step, times, the bound and,
             as a reference point that computes more (the input product)
             with its own rounding, cuDNN's bidirectional ``nn.GRU`` (b_hh
             = 0) on a packed sequence.
53. train-rd-residual — five full-width train steps (``CELL_OPTION_STEPS``) of
             ``lrs2_av_align_rd_residual`` (``rd_residual_cfg``: recurrent
             dropout 0.2 in both encoders, residual audio layers 1-2) at
             B=128, as phase 19: the loss and every gradient leaf against the
             plain path on the same draws, every leaf present, finite and
             nonzero; the masked K1 launched and the unmasked one not.
54. serve-rd-residual — the same model behind a CUDA ``Predictor`` as phase
             15 (B=8 requests, width-10 beam): the unmasked K1 launched, the
             masked one not.
55. train-gru-highway — five full-width train steps of
             ``lrs2_av_align_gru_highway`` (``gru_highway_cfg``: GRU cells in
             both encoders, highway audio layers 1-2, ``hw_w`` / ``hw_b``
             among the leaves), as phase 53; K12 forward and backward
             launched on its cluster route, no LSTM scan.
56. serve-gru-highway — the same model served as phase 54; K12's forward
             launched on its cluster route, no LSTM scan.
57. k13 — K13, the LN-LSTM scan, forward in save mode and backward against
             the plain twins, with and without an rd mask, at G = 2 and 1,
             each call's family printed: the cluster route
             (``csrc/ln_lstm_cluster.cuh``) at the paths' shapes, the train
             and serving buckets', G = 1 at [197, 128] and [531, 4]; the
             block kernel (``csrc/ln_lstm_scan.cu``) at H = 80; 0-length
             rows exact, reruns bit-equal; ptxas registers and spills (a
             cluster instance's spill fails), the library's shared memory
             against ``kernels.ln_lstm_smem`` / ``ln_lstm_cluster_smem``,
             resident clusters; device ms, times and bounds.
58. k3-options — K3's option instances (the spectrogram, no deltas, global
             or no normalization) against the plain twin at B = 8 and 128,
             6 s and 16 s and the serving buckets; reruns bit-equal.
59. train-ln — ten full-width train steps of ``lrs2_av_align_ln``
             (``ln_cfg``: LN-LSTM encoders, recurrent dropout 0.2 in the
             video one) as phase 19, every leaf (the ``ln_*`` ones among
             them) present, finite and nonzero; the kernel path against the
             plain path within ``SPREAD_FACTOR`` times the plain path's own
             spread, and every K13 call of the kernel path's step held on its
             own activations (``hold_k13_calls``: each forward step by step
             from the kernel's states, each backward against the twin);
             K13 masked and unmasked launched on its cluster route, no K1 /
             K2.
60. serve-ln — the same model served as phase 15, its encode's K13 calls
             held the same way.
61. train-spectrogram — ten full-width train steps of
             ``lrs2_av_fast_spectrogram`` (``spectrogram_cfg``: the
             spectrogram without deltas, global normalization, SpecAugment,
             LAMB) as phase 8; K3's option instance launched, not the
             presets'.
62. serve-spectrogram — the same model served as phase 5.
63. k1-fp32 — K1's fp32 instance (the per-step kernels, the fp32 policy),
             forward in save mode and backward, against the plain fp32
             twins at [G=2, H=256] and the fp32 paths' (T, B)
             (``K1F32_SHAPES``: T = 99, 50, 150 at B = 128 and 8; 16 s at B
             = 4), operands with full fp32 mantissas (``full_f32``): errors
             at fp32 tolerances, fp32 outputs and residuals, reruns
             bit-equal, the 0-length row; device ms, per-step us, times,
             bounds at the fp32 peak, cuDNN's fp32 ``nn.LSTM`` as a
             reference point.
64. attention-fp32 — the CUDA-core attention family's fp32 instance as K4
             (the fast shapes, B = 8, the 16 s limits T_a = 133 and 531 at
             T_v = 401) and K5 (the fast self and cross pair, Q = 150, the
             16 s memories S = 133 and 531) against the plain fp32 twins:
             ctx, the weights, the backward from them, the length-0 row
             uniform, reruns bit-equal; the family's shared memory against
             ``kernels.attention_core_smem``; times, device times, bounds
             and ``scaled_dot_product_attention`` in fp32 (its backward
             too) with the same additive mask.
65. k6-fp32 — K6's fp32 instance (the general kernel) at a beam step (N =
             80 over the untiled memory) and a greedy step (N = 128): self
             at pos 0/37/149 over the 150-step cache, cross over the fast
             memories S = 50 and 133 with a length-0 row, and greedy's
             warm-up over a 4-step cache; reruns bit-equal; a step's pair
             timed with its bound and the library yardstick.
66. train-fp32 — ``lrs2_av_fast`` under ``train.compute_dtype="float32"``
             (``fp32_cfg``) trained at full width, B = 128, 6 s, as phase 8
             for ``FP32_TRAIN_STEPS`` steps: the loss and every gradient
             leaf against the plain fp32 path at fp32 tolerances
             (``FP32_*_TOL``), every leaf present, finite and nonzero; the
             fp32 instances of K1, K4 and K5 launched, never their bf16 ones
             (``OTHER_ROUTES``), K3 as on every path.
67. serve-fp32 — the same model served as phase 5: the fused memory
             within ``FP32_MEMORY_TOL`` of the plain path's and the
             request's ids equal to the whole plain path's; K1, K4 and K6
             in fp32, K3 and K7 launched.
68. greedy-fp32 — the same model's B = 128 greedy decode, its encode
             counted too: every row's ids equal to the plain fp32 path's.
69. remat-align — ``lrs2_full()`` (lrs2_av_align) trained at full width
             from one seed without ``train.remat``, with it and without it
             again (``phase_remat``): the remat step's loss bit-equal, every
             gradient leaf bit-equal where the two runs without remat are
             bit-equal (else within ``RESUME_LOSS_REL_TOL``: the card's
             atomic sums), ``CELL_OPTION_STEPS`` steps' losses the same;
             each run's peak device memory (``max_memory_allocated``, reset
             between runs), ms per step and a step's device busy ms.
70. remat-rd-residual — the same for ``rd_residual_cfg()`` (recurrent
             dropout 0.2, encoder dropout and residual layers): the
             recompute replays the step's masks.
71. k8-fp32 — K8's fp32 instance (the per-step kernels: the chunked gate
             launch and the read, the regate, the row and the product
             launches) against the plain fp32 twins at ``K8F32_SHAPES``
             (the train batch [T_a = 197, B = 128, T_v = 150], a ragged B =
             8 request, the 16 s limits T_a = 531, T_v = 401 at B = 4; H =
             256, A = 128, Dv = Dc = 512), operands with full fp32 mantissas
             (``full_f32``): the forward in save mode and serving, the
             backward with every weight gradient, at ``K8F32_*_TOL``, the
             empty rows exactly 0, reruns bit-equal; the fp32 instances'
             registers and spills, the gate launch's shared memory against
             ``kernels.av_align_step_smem``; device ms at each shape, grid
             launches a call, times and bounds at the train shape.
72. k10-fp32 — K10's fp32 instances against the plain fp32 twins: the
             general kernel at a beam step (N = 80 over 8 rows), one query
             a row (N = 128: greedy, the teacher-forced loop), each over S =
             197 and 531 (Hq = 256, A = 128, Dv = 768); the loop's per-step
             backward and CUDA-core sums at N = 128, K = 80 and at S = 531;
             the length-0 row exactly 0, reruns bit-equal; shared memory
             against ``kernels.attend_general_smem`` /
             ``attend_step_bwd_smem``; device ms, times, bounds; then K8's
             and K10's Luong reads and K2 refuse the fp32 policy on the
             card by name, launching nothing.
73. train-align-fp32 — ``lrs2_av_align`` under the fp32 policy
             (``align_fp32_cfg``) trained at full width, B = 128, 6 s, as
             phase 66: the loss and every gradient leaf against the plain
             fp32 path, ``FP32_TRAIN_STEPS`` steps (label cap 80, sampling
             0.1, AU loss); the fp32 instances of K1, K8 and K10 launched,
             never a bf16 one of those families (``OTHER_ROUTES``).
74. serve-align-fp32 — the same model served as phase 15: the fused
             memory within ``FP32_MEMORY_TOL`` of the plain path's, the
             request's ids equal to the whole plain path's.
75. greedy-align-fp32 — the same model's B = 128 greedy decode, its encode
             counted too: every row's ids equal to the plain fp32 decode's
             on the kernel path's memories, and a row that differs from the
             whole plain fp32 path parts from it at a tie of the two
             tokens' logits within ``GREEDY_F32_TIE_TOL`` on both paths
             (the encoders' fp32 sums in another order move the logits by
             a few fp32 ulps).
48. shapes — every call of a kernel wrapper in phases 46-47, 49-50,
             53-56, 59-62, 66-70 and 73-75 (``COVERED_PHASES``: each of the five train buckets,
             ``TRAIN_BUCKETS``, their warm-ups, the evals, and the three
             serving buckets, ``SERVE_BUCKETS``) must have been made at the
             same tensor shapes in a phase that holds that kernel against
             its plain twin (``KERNEL_PHASES``; ``record_shapes``): the
             kernel phases take the buckets' shapes (``*_BUCKET_SHAPES``,
             ``K10_BUCKET_READS``, ``*_SERVE_SHAPES``, ``K6_SERVE_CROSS``,
             ``K10_SERVE_READS``, ``RNN_OPTION_*``; phases 3, 4, 6, 7, 9, 10,
             13, 14, 17, 18, 51, 52, 57, 58, 63-65, 71-72)
             at their own tolerances; prints each kernel's shapes on the
             paths and held.
Serve (5, 15, 22, 31, 38-41, 54, 56) also beams the same memories through the plain path
and holds the best scores to a tolerance.  Each serve and greedy path and the
train path end with a ``torch.profiler`` reading of one run: the device's
busy share of the host span, device events per beam, train or decode step,
and the top kernels.  The line before the last is a JSON object with one
entry per kernel (launches by path, errors, kernel / plain / library ms
from CUDA events, the kernel's device ms from CUDA events with the calls
queued behind a spin kernel, the bound from this run's shapes); the last
line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np

K1_TOL = 2e-2    # bf16 outputs (one bf16 ulp near 1 is 3.9e-3) and fp32 states
K3_TOL = 1e-3    # normalized fp32 features; sums in another order
MEMORY_TOL = 5e-2  # fused memory after 3+1 bf16 BiLSTM layers and the fusion
# K1 backward, max abs error over max |plain|: dgates are rounded to bf16
# (2^-8 relative) and feed the next step's dh product, so a one-ulp flip
# moves dh by about that much; dWh sums T*B such products in fp32.
K1B_REL_TOL = 2e-2
# K4: ctx is bf16 (abs 2e-2 at values of order 1); P is fp32 in [0, 1] but
# its scores are rounded to bf16 before the softmax, so a sum order that
# flips one rounding moves a weight by ~0.4% of itself; gradients are bf16
# (relative to the largest plain value).
K4_CTX_TOL = 2e-2
K4_P_TOL = 5e-3
K4_GRAD_REL_TOL = 2e-2
# train step, kernel path against plain path with the same draws: bf16
# rounding flips through 4 recurrent layers, forward and backward.
LOSS_REL_TOL = 1e-2
# A model whose own outputs move far more than its arithmetic's ulps (the
# full-width LN-LSTM model at init, under the bf16 policy: one part in 1e6 on
# every weight moves the plain path's loss by ~1e-4 and its gradient leaves
# by a median 0.2-0.5, its bf16 roundings flipping and the layer norms
# amplifying the flips; the JAX package's own spread at this width is not
# measured) is compared with its plain path within SPREAD_FACTOR times the
# plain path's own spread under that perturbation (SPREAD_EPS), or the
# usual tolerance where that is larger.  That comparison catches only a
# path gone wrong wholesale; what holds the kernels there is
# ``hold_k13_calls``: every K13 call of the path on its own activations.
SPREAD_EPS = 1e-6
# train steps of phases 53 and 55 (the other paths take ten)
CELL_OPTION_STEPS = 5
SPREAD_FACTOR = 4.0
GRAD_LEAF_REL_TOL = 5e-2
# K5: the K4 tolerances, for the same reasons (bf16 ctx and gradients, fp32
# P from bf16-rounded scores).
K5_CTX_TOL = 2e-2
K5_P_TOL = 5e-3
K5_GRAD_REL_TOL = 2e-2
# K6: bf16 context of order one; a score whose bf16 rounding flips after
# another summation order moves its weight by ~0.4% of itself.
K6_TOL = 2e-2
# K7: parents, tokens, lens, finished and feeds identical; the new log probs
# add a log-softmax whose max/sum are reduced in another order (fp32 ulps of
# values up to ~30): |kernel - plain| <= 1e-4 + 1e-6 * |plain|.
K7_LOGP_ATOL, K7_LOGP_RTOL = 1e-4, 1e-6
# K8, kernel against plain twin over 197 recurrent steps: the fp32 states
# and contexts start from K1_TOL (bf16 rounding of h and ctx before each
# product; a flip moves a gate by 2^-9 of a weight and is carried on by the
# recurrence) widened to MEMORY_TOL's 5e-2 for the length of the chain;
# the alignments are weights in [0, 1] whose energies are rounded to bf16:
# a flipped energy moves a score by 2^-9 |v_a|, a weight by ~1e-3 of itself.
K8_TOL = 5e-2
K8_ALIGN_TOL = 1e-2
# K10: a weight moves only by the score sums' order (fp32 ulps) unless an
# energy's bf16 rounding flips (~1e-3 of the weight); the context is fp32
# from bf16 weights x bf16 values of order one: K6's 2e-2.
K10_W_TOL = 1e-3
K10_CTX_TOL = 2e-2
# K8 and K10 backward, max abs error over max |plain|: the twins round the
# same cotangents to bf16 (dw, deb, dvalues, dquery, the carries' products);
# a sum in another order can flip one rounding (2^-8 of that element), and
# K8's reverse recurrence carries such a flip over 197 steps, as K1's does.
K8B_REL_TOL = 2e-2
K10B_REL_TOL = 1e-2
# Luong reads (K8's and K10's dot-score instances): unscaled dot products of
# 256 to 512 bf16 products summed in fp32; scores of order 10 move by the
# summation order's fp32 ulps (~1e-5), a weight by that much of itself.
# K8's alignments also follow its recurrent states, held at K8_TOL; a
# state that moves by 5e-2 moves a score by up to |keys| |wq| 5e-2.
K10L_W_TOL = 1e-3
K8L_ALIGN_TOL = 1e-2
# K11: K4's, for the same reasons (bf16 context of order one; a score whose
# bf16 rounding flips after another summation order moves its weight by
# ~0.4% of itself).
K11_CTX_TOL = 2e-2
# K9: bf16 output of order one (swish of a LayerNorm'd row); the 15-tap
# conv and the row statistics are fp32 sums in another order, and a sum
# that lands on the other side of the final bf16 rounding moves the output
# by one bf16 ulp: 2e-2 abs plus one ulp of the value (2^-7 of it at most;
# the swish reaches 4-5, where one ulp is 3.1e-2).
K9_TOL = 2e-2
K9_ULP = 2.0 ** -7
# K11 backward: K4's, for the same reasons (bf16 gradients, relative to the
# largest plain value); the weights that the kernel's saved row statistics
# give, against the plain ones, as K4's P.
K11_GRAD_REL_TOL = K4_GRAD_REL_TOL
# K9 backward, max abs error over max |plain|: du is bf16, and an fp32 sum
# of the conv's transpose that lands on the other side of dy's bf16
# rounding moves da and dgate by one ulp of dy (2^-8 to 2^-7 of it): 2e-2.
# ddw and the LayerNorm's gradients are fp32 sums over B*T = 25,216 rows of
# fp32 terms taken in another order, with cancellation: 1e-3 of the largest.
# db_in is the fp32 sum of du rounded to bf16: du's one-ulp flips and one
# bf16 rounding (2^-8): 1e-2.
K9_DU_REL_TOL = 2e-2
K9_PARAM_REL_TOL = 1e-3
K9_DB_REL_TOL = 1e-2
# serve: best beam scores of the kernel and the plain path, 150 steps of
# log probs (~-600) whose logits differ by bf16 ulps at each K6 read; near
# ties may send the two beams down different, equally scored paths.
BEAM_SCORE_REL_TOL = 1e-2
# greedy, kernel path against plain path over 150 steps: a near tie of two
# logits that a bf16 ulp of a context flips changes a row from there on.
# Random weights leave many near ties: lrs2_av_align's rows differed in 10
# of 128, the transformer decoders' in none.  More than 16 (1 in 8) is a
# fault, not ties.
GREEDY_MAX_DIFF_ROWS = 16

# the profiler's names of the tensor-core attention kernels, told apart by
# their masks: K11's whole-row instances (head width 64) and K4's streamed
# ones under the length mask, K5's causal instance, and K5's cross kernels
# (decoder_cross_attention.cuh)
K11_SHARE = ("K11 fwd + bwd", ("attn_mma_", "<64,", "LengthMask"))
K4_SHARE = ("K4 fwd + bwd", ("attn_mma_stream_", "LengthMask"))
K5_SHARES = (("K5 self fwd + bwd", ("attn_mma_", "CausalMask")),
             ("K5 cross fwd + bwd", ("xattn_",)))

# the bytes an attention backward may ask for beyond its outputs and D
# (requested bytes, exact: no [B, nh, T_q, T_k] tensor, 1.36 MB in bf16 at
# the smallest shape held, fits under it)
SLACK_BYTES = 1 << 16

# H100 SXM peaks (NVIDIA data sheet): the bounds of the kernels line
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}

# the fp32 policy (phases 63-68): lrs2_av_fast under train.compute_dtype = "float32"
# K1's fp32 instance (the per-step kernels) at G = 2, H = 256, (T, B): the
# fast audio encoder's layers (T = 99, 50) and the video encoder (150) at
# B = 128 (the train step, greedy) and B = 8 (a serve request), 16 s (the
# first audio layer's 266 steps, the video's 401 frames) at B = 4, and
# lrs2_av_align's audio layers (T = 197, no time reduction; phases 73-75)
K1F32_SHAPES = ((99, 128), (50, 128), (150, 128), (99, 8), (50, 8), (150, 8), (266, 4), (401, 4),
                (197, 128), (197, 8))
# fp32 outputs of order one against the plain twin's fp32 bmm: only the
# order of the fp32 sums differs (about 1e-6 of a value, carried through
# the recurrence); the backward relative to the largest plain value (db
# and dWh sum T * B terms)
K1F32_TOL = 2e-5
K1F32_BWD_REL_TOL = 5e-5
# K4's fp32 shapes (B, T_a, T_v) at 4 heads, A = dv = 128: the fast model's
# train / greedy and serve shapes, its 16 s limit (T_a = 133 audio steps at
# T_v = 401 frames) and the family's (T_a = 531, kernels.ATTEND_MAX_S)
K4F32_SHAPES = ((128, 50, 150), (8, 50, 150), (4, 133, 401), (4, 531, 401))
# K5's fp32 shapes (label, B, Q, S, dk, dv, causal): the fast model's self
# and cross pair (80 labels, memory S = 50), the self attention at the
# 150-label horizon, the cross attention at the fast model's 16 s memory
# (S = 133) and the family's (S = 531) with 150 labels
K5F32_SHAPES = (("fast self", 128, 80, 80, 64, 64, True),
                ("fast cross", 128, 80, 50, 128, 256, False),
                ("self Q=150", 128, 150, 150, 64, 64, True),
                ("16 s cross Q=150", 4, 150, 133, 128, 256, False),
                ("16 s cross S=531", 4, 150, 531, 128, 256, False))
# fp32 contexts of order one and fp32 weights: sums in another order
ATTN_F32_TOL = 2e-5
ATTN_F32_P_TOL = 2e-6
ATTN_F32_GRAD_REL_TOL = 2e-5
K6F32_TOL = 2e-5
K6F32_MEMORIES = (50, 133)  # the fast model's memory at 6 s and at 16 s
# the fp32 train step against the plain fp32 path with the same draws: the
# same fp32 arithmetic summed in other orders through 4 recurrent layers
# and the decoder, forward and backward (relative: the loss; each leaf's
# gradient by its norm); the fused memory's values are of order one
FP32_LOSS_REL_TOL = 1e-5
FP32_GRAD_LEAF_REL_TOL = 1e-3
FP32_MEMORY_TOL = 1e-4
FP32_TRAIN_STEPS = 3
TRAIN_FP32_KERNELS = ("lstm_scan_f32_fwd", "lstm_scan_f32_bwd", "logmel_post_dft",
                      "fusion_attention_f32_fwd", "fusion_attention_f32_bwd",
                      "decoder_attention_f32_fwd", "decoder_attention_f32_bwd")
SERVE_FP32_KERNELS = ("lstm_scan_f32_fwd", "logmel_post_dft", "fusion_attention_f32_fwd",
                      "decode_attention_f32", "beam_step")
GREEDY_FP32_KERNELS = ("lstm_scan_f32_fwd", "logmel_post_dft", "fusion_attention_f32_fwd",
                       "decode_attention_f32")
# the bf16 instances of the families the fp32 paths run in fp32
BF16_MAIN_KERNELS = ("lstm_scan_fwd", "lstm_scan_bwd", "fusion_attention_fwd",
                     "fusion_attention_bwd", "decoder_attention_fwd", "decoder_attention_bwd",
                     "decode_attention")

# the fp32 policy on lrs2_av_align (phases 71-75): align_fp32_cfg()
# K8's fp32 instance (the per-step kernels) at H = 256, A = 128, Dv = Dc =
# 512, (T_a, B, T_v): the train batch and greedy (B = 128), a serve request
# (B = 8, ragged) and the 16 s limits (T_a = 531, T_v = 401) at B = 4
K8F32_SHAPES = ((197, 128, 150), (197, 8, 150), (531, 4, 401))
# fp32 states and contexts of order one against the plain twin's fp32
# products: only the order of the fp32 sums differs (about 1e-6 of a value a
# step), carried 197 (531) steps through the recurrence and the context fed
# back through ctx_proj, so two orders of magnitude of room; a bf16
# rounding of any operand (the inputs carry full fp32 mantissas, full_f32)
# moves them by ~2^-9, 20 times past it.  The alignments are weights in
# [0, 1] from scores moved by those states; the backward relative to the
# largest plain value (db, dWh and the memory's gradients sum T * B terms)
K8F32_TOL = 1e-4
K8F32_ALIGN_TOL = 1e-5
K8F32B_REL_TOL = 1e-4
# K10's fp32 instance (the general kernel) at the align decoder's widths
# (Hq = 256, A = 128, Dv = 768): (label, N, W, S): the beam step of a serve
# request (8 utterances of 10 beams over the untiled memory), greedy's and
# the teacher-forced loop's one query a row (N = 128), each at 6 s and at
# the 16 s limit (S = 531)
K10F32_CASES = (("beam step", 80, 10, 197), ("one query a row", 128, 1, 197),
                ("beam step, 16 s", 80, 10, 531), ("one query a row, 16 s", 128, 1, 531))
# fp32 contexts of order one and weights, sums in another order (K6's fp32
# tolerances); the loop's backward relative to the largest plain value
# (its sums run over the K = 80 steps of the loop and the N rows)
K10F32_CTX_TOL = 2e-5
K10F32_W_TOL = 2e-6
K10F32B_REL_TOL = 5e-5
# greedy under fp32 over align's 197-step fusion: the encoders' fp32 sums
# in another order move the fused memory by ~2e-5 (phase 74) and so the
# logits by a few fp32 ulps (logits of order 10: an ulp ~1e-6), so a row
# whose two best logits lie that close may part from the whole plain path.  Phase 75 holds the decode
# on the kernel path's memories bit for bit in ids (every row), and each
# row that parts from the whole plain path must part at such a tie: both
# paths' gaps between the two tokens within this of 0 (logits, absolute)
GREEDY_F32_TIE_TOL = 1e-5
TRAIN_ALIGN_FP32_KERNELS = ("lstm_scan_f32_fwd", "lstm_scan_f32_bwd", "logmel_post_dft",
                            "av_align_scan_f32", "av_align_scan_f32_bwd", "bahdanau_attend_f32",
                            "bahdanau_attend_f32_bwd", "bahdanau_attend_f32_sums")
SERVE_ALIGN_FP32_KERNELS = ("lstm_scan_f32_fwd", "logmel_post_dft", "av_align_scan_f32",
                            "bahdanau_attend_f32", "beam_step")
GREEDY_ALIGN_FP32_KERNELS = ("lstm_scan_f32_fwd", "logmel_post_dft", "av_align_scan_f32",
                             "bahdanau_attend_f32")
# the bf16 instances (every route) of the families the align fp32 paths run
# in fp32: K1, K8 and K10
BF16_ALIGN_KERNELS = ("lstm_scan_fwd", "lstm_scan_bwd", "av_align_scan", "av_align_scan_bwd",
                      "bahdanau_attend", "bahdanau_attend_grouped", "bahdanau_attend_row",
                      "bahdanau_attend_bwd", "bahdanau_attend_sums")
# the align fp32 instances, which the fast fp32 paths do not run
ALIGN_F32_KERNELS = ("av_align_scan_f32", "av_align_scan_f32_bwd", "bahdanau_attend_f32",
                     "bahdanau_attend_f32_bwd", "bahdanau_attend_f32_sums")



SERVE_KERNELS = ("lstm_scan_fwd", "logmel_post_dft", "fusion_attention_fwd",
                 "decode_attention", "beam_step")
TRAIN_KERNELS = ("lstm_scan_fwd", "lstm_scan_bwd", "logmel_post_dft", "fusion_attention_fwd",
                 "fusion_attention_bwd", "decoder_attention_fwd", "decoder_attention_bwd")
GREEDY_KERNELS = ("decode_attention",)
SERVE_ALIGN_KERNELS = ("lstm_scan_fwd", "logmel_post_dft", "av_align_scan",
                       "bahdanau_attend_grouped", "beam_step")
GREEDY_ALIGN_KERNELS = ("bahdanau_attend_row",)
TRAIN_ALIGN_KERNELS = ("lstm_scan_fwd", "lstm_scan_bwd", "logmel_post_dft", "av_align_scan",
                       "av_align_scan_bwd", "bahdanau_attend_row", "bahdanau_attend_bwd",
                       "bahdanau_attend_sums")
# the keys every phase's report entry has; any other (what a library call
# covers, a second shape's times) is carried into the kernels line as is
REPORT_KEYS = ("max_abs_err", "ms", "plain_ms", "bound", "library_ms", "device_ms")
SERVE_V2_KERNELS = ("logmel_post_dft", "encoder_attention_fwd", "conformer_conv_fwd",
                    "fusion_attention_fwd", "decode_attention", "beam_step")
TRAIN_V2_KERNELS = ("logmel_post_dft", "encoder_attention_fwd", "encoder_attention_bwd",
                    "conformer_conv_fwd", "conformer_conv_bwd", "fusion_attention_fwd",
                    "fusion_attention_bwd", "decoder_attention_fwd", "decoder_attention_bwd")
SERVE_UL_KERNELS = ("lstm_scan_uni_fwd", "logmel_post_dft", "av_align_scan_luong",
                    "luong_attend_grouped", "beam_step")
# the K10 forward kernels a path must not launch: a beam step's reads (10
# beams a memory row) take the grouped read, greedy's and the teacher-forced
# loop's (a query row per memory row) the row read; no path of the presets
# takes the general kernel (a block per query row, for other widths).  The
# v2 paths' K9 forward takes the pass over time, never the tiles (other
# shapes).
OTHER_ROUTES = {"serve_align": ("bahdanau_attend", "bahdanau_attend_row"),
                "serve_uni_luong": ("luong_attend", "luong_attend_row"),
                "greedy_align": ("bahdanau_attend", "bahdanau_attend_grouped"),
                "greedy_uni_luong": ("luong_attend", "luong_attend_grouped"),
                "train_align": ("bahdanau_attend", "bahdanau_attend_grouped"),
                "train_uni_luong": ("luong_attend", "luong_attend_grouped"),
                "serve_v2": ("conformer_conv_fwd_tiles",),
                "greedy_v2": ("conformer_conv_fwd_tiles",),
                "train_v2": ("conformer_conv_fwd_tiles",),
                "serve_audio": ("bahdanau_attend", "bahdanau_attend_row"),
                "serve_video": ("bahdanau_attend", "bahdanau_attend_row"),
                "serve_video_au": ("bahdanau_attend", "bahdanau_attend_row"),
                "serve_bimodal": ("bahdanau_attend", "bahdanau_attend_row"),
                "greedy_bimodal": ("bahdanau_attend", "bahdanau_attend_grouped"),
                "train_bimodal": ("bahdanau_attend", "bahdanau_attend_grouped"),
                # the eval loss reads one query a row, its beam 10
                "eval_noisy": ("bahdanau_attend",),
                "trainer_align": ("bahdanau_attend",),
                "artifact_align": ("bahdanau_attend", "bahdanau_attend_row"),
                "artifact_align_greedy": ("bahdanau_attend", "bahdanau_attend_grouped"),
                # the encoder options (phases 53-56): the masked K1 in the
                # rd_residual training only, the unmasked one in its serving,
                # no LSTM scan on the GRU paths
                "train_rd_residual": ("lstm_scan_fwd", "lstm_scan_bwd", "bahdanau_attend",
                                      "bahdanau_attend_grouped"),
                "serve_rd_residual": ("lstm_scan_rd_fwd", "lstm_scan_rd_bwd", "bahdanau_attend",
                                      "bahdanau_attend_row"),
                # (H = 256: K12 on its cluster route, never the per-step one)
                "train_gru_highway": ("lstm_scan_fwd", "lstm_scan_bwd", "lstm_scan_rd_fwd",
                                      "lstm_scan_rd_bwd", "gru_scan_step_fwd",
                                      "gru_scan_step_bwd", "bahdanau_attend",
                                      "bahdanau_attend_grouped"),
                "serve_gru_highway": ("lstm_scan_fwd", "lstm_scan_bwd", "lstm_scan_rd_fwd",
                                      "lstm_scan_rd_bwd", "gru_scan_bwd", "gru_scan_step_fwd",
                                      "gru_scan_step_bwd", "bahdanau_attend",
                                      "bahdanau_attend_row"),
                # the LN-LSTM paths (phases 59-60): no K1 or K2, the masked
                # K13 in the training only, K13 on its cluster route (H =
                # 256), never the block one; the spectrogram paths (61-62):
                # K3's option instance, never the presets' one
                "train_ln": ("lstm_scan_fwd", "lstm_scan_bwd", "lstm_scan_rd_fwd",
                             "lstm_scan_rd_bwd", "ln_lstm_scan_block_fwd",
                             "ln_lstm_scan_block_bwd", "bahdanau_attend",
                             "bahdanau_attend_grouped"),
                "serve_ln": ("lstm_scan_fwd", "lstm_scan_rd_fwd", "ln_lstm_scan_rd_fwd",
                             "ln_lstm_scan_bwd", "ln_lstm_scan_rd_bwd", "ln_lstm_scan_block_fwd",
                             "ln_lstm_scan_block_bwd", "bahdanau_attend", "bahdanau_attend_row"),
                "train_spectrogram": ("logmel_post_dft",),
                "serve_spectrogram": ("logmel_post_dft",),
                # the fp32 paths (phases 66-68): the fp32 instances of K1,
                # K4, K5 and K6, never their bf16 ones (nor K8's or K10's)
                "train_fp32": BF16_MAIN_KERNELS + ALIGN_F32_KERNELS,
                "serve_fp32": BF16_MAIN_KERNELS + ALIGN_F32_KERNELS,
                "greedy_fp32": BF16_MAIN_KERNELS + ALIGN_F32_KERNELS,
                # the align fp32 paths (phases 73-75): the fp32 instances of
                # K1, K8 and K10, never a bf16 one of those families
                "train_align_fp32": BF16_ALIGN_KERNELS, "serve_align_fp32": BF16_ALIGN_KERNELS,
                "greedy_align_fp32": BF16_ALIGN_KERNELS,
                # the remat runs (phases 69-70) take their paths' routes
                "remat_align": ("bahdanau_attend", "bahdanau_attend_grouped"),
                "remat_rd_residual": ("lstm_scan_fwd", "lstm_scan_bwd", "bahdanau_attend",
                                      "bahdanau_attend_grouped")}
# the reference's unimodal and bimodal regimes (audio_tcdtimit,
# video_tcdtimit with the ROI CNN or AU features, bimodal_tcdtimit: the RNN
# decoder reads each memory with Bahdanau's score, at Dv = 512) and the
# records-to-CER eval of av_align_noisy under fixed-SNR noise, whose
# teacher-forced loss reads one query a row and whose beam reads 10
SERVE_AUDIO_KERNELS = ("lstm_scan_fwd", "logmel_post_dft", "bahdanau_attend_grouped",
                       "beam_step")
SERVE_VIDEO_KERNELS = ("lstm_scan_fwd", "bahdanau_attend_grouped", "beam_step")
SERVE_BIMODAL_KERNELS = SERVE_AUDIO_KERNELS
GREEDY_BIMODAL_KERNELS = ("bahdanau_attend_row",)
TRAIN_BIMODAL_KERNELS = ("lstm_scan_fwd", "lstm_scan_bwd", "logmel_post_dft",
                         "bahdanau_attend_row", "bahdanau_attend_bwd", "bahdanau_attend_sums")
EVAL_NOISY_KERNELS = ("lstm_scan_fwd", "logmel_post_dft", "av_align_scan",
                      "bahdanau_attend_grouped", "bahdanau_attend_row", "beam_step")
# the card's fixed-SNR mix against the CPU's on the same draws: fp32 powers
# of up to 2^17 squares summed in another order (relative 1e-6 of the
# scale), on waveforms of order one
MIX_TOL = 1e-5
# kernels no path launches, listed in the kernels line with their phases'
# numbers and 0 launches: routes of other shapes, and the one-direction
# instances of the encoder options (a one-direction GRU layer, a
# one-direction LSTM layer under recurrent dropout), which phases 51-52 hold
# at G = 1 but no configuration on the card uses, and K13's one-direction
# instances (phase 57), and the routes K12 and K13 take at widths off the
# presets' (the per-step and block kernels, phases 52 and 57 at H = 80)
OFF_PATH = ("bahdanau_attend", "luong_attend", "conformer_conv_fwd_tiles",
            "lstm_scan_uni_rd_fwd", "lstm_scan_uni_rd_bwd", "gru_scan_uni_fwd", "gru_scan_uni_bwd",
            "ln_lstm_scan_uni_fwd", "ln_lstm_scan_uni_bwd", "ln_lstm_scan_uni_rd_fwd",
            "ln_lstm_scan_uni_rd_bwd", "gru_scan_step_fwd", "gru_scan_step_bwd",
            "ln_lstm_scan_block_fwd", "ln_lstm_scan_block_bwd")
# the training loop, checkpoints, API and CLI: lrs2_av_align's train step
# (K1, K3, K8 and K10's teacher-forced loop), its eval loss (K10's row
# read) and beam (K10's grouped read, K7); lrs2_av_fast's train step, greedy
# and beam eval through the CLI
TRAINER_ALIGN_KERNELS = ("lstm_scan_fwd", "lstm_scan_bwd", "logmel_post_dft", "av_align_scan",
                         "av_align_scan_bwd", "bahdanau_attend_row", "bahdanau_attend_bwd",
                         "bahdanau_attend_sums", "bahdanau_attend_grouped", "beam_step")
CLI_FAST_KERNELS = ("lstm_scan_fwd", "lstm_scan_bwd", "logmel_post_dft", "fusion_attention_fwd",
                    "fusion_attention_bwd", "decoder_attention_fwd", "decoder_attention_bwd",
                    "decode_attention", "beam_step")
# a resumed run's losses against the uninterrupted run's at the same steps:
# the card's backward sums some gradients with atomics (the embedding's),
# so the restored state can differ from the uninterrupted run's by fp32 ulps
# and Adam carries that on for the two steps compared; 1e-4 is that drift.
# The runs on the H100 were bit-equal.  A step's randomness taken from the
# wrong step or micro-batch (dropout, scheduled sampling) moves the loss by
# far more.
RESUME_LOSS_REL_TOL = 1e-4
GREEDY_UL_KERNELS = ("luong_attend_row",)
# the serving artifacts (phases 49-50): lrs2_av_fast exported through the
# CLI (the width-10 beam, n-best 3), lrs2_av_align through
# export_serving_artifact (the beam, and greedy), each in the 2, 6 and 10 s
# buckets, and the fast artifact behind the HTTP host
ARTIFACT_FAST_KERNELS = SERVE_KERNELS
ARTIFACT_ALIGN_KERNELS = SERVE_ALIGN_KERNELS
ARTIFACT_GREEDY_KERNELS = ("lstm_scan_fwd", "logmel_post_dft", "av_align_scan",
                           "bahdanau_attend_row")
SERVE_HTTP_KERNELS = SERVE_KERNELS
# HTTP replies under concurrency against each utterance's transcription
# alone: a coalesced batch takes the bucket of its longest utterance, so an
# utterance that alone fits the 2 or 6 s bucket is decoded over a longer
# padded memory (other GEMM shapes for the memory's projections, other
# tiles of the masked sums: bf16 ulps), beside other partners.  On weights
# barely trained past random, a near tie of two beams flips on such an ulp
# (as GREEDY_MAX_DIFF_ROWS allows for greedy rows).  More than 6 of the 24
# replies (1 in 4) is a fault, not ties.  A reply with its utterance's
# text alone must hold the scores of the hypotheses both n-best lists
# have within SERVE_SCORE_RTOL of them, relatively: two bf16 ulps (2^-6;
# on the H100 the others came out bit-equal or within 3.1e-3).  Scores
# this close cannot tell utterances apart (two utterances' replies came
# within 1.5e-4 of each other), so each reply is also held bit-equal to
# its utterance decoded alone in the bucket its batch took.
SERVE_MAX_DIFF_TEXTS = 6
SERVE_SCORE_RTOL = 2.0 ** -6
TRAIN_UL_KERNELS = ("lstm_scan_uni_fwd", "lstm_scan_uni_bwd", "logmel_post_dft",
                    "av_align_scan_luong", "av_align_scan_luong_bwd", "luong_attend_row",
                    "luong_attend_bwd", "luong_attend_sums")


def fail(phase: str, msg: str) -> None:
    print(f"FAIL [{phase}]: {msg}", file=sys.stderr)
    sys.exit(1)


# the paths of phases 59-62: K13 runs on the LN paths only, K3's option
# instances on the spectrogram paths only; the fp32 instances run on the
# fp32 paths of phases 66-68 and 73-75 only
LN_PATHS = ("train_ln", "serve_ln")
K3_OPTION_PATHS = ("train_spectrogram", "serve_spectrogram")
FP32_PATHS = ("train_fp32", "serve_fp32", "greedy_fp32", "train_align_fp32", "serve_align_fp32",
              "greedy_align_fp32")


def check_other_route(label, launches):
    """Fails where the path ``label`` launched a K10 forward or K9 forward
    kernel of another route (``OTHER_ROUTES``): every call took the route
    its shape gives; or K13 off the LN paths, K3's option instances off
    the spectrogram paths, an fp32 instance off the fp32 paths or a bf16
    instance of K1, K4, K5 or K6 on them."""
    others = list(OTHER_ROUTES.get(label, ()))
    if label not in LN_PATHS:
        others += [n for n in launches if n.startswith("ln_lstm_scan")]
    if label not in K3_OPTION_PATHS:
        others.append("logmel_post_dft_options")
    if label not in FP32_PATHS:
        others += [n for n in launches if "_f32" in n]
    for other in others:
        if launches[other] != 0:
            fail(label, f"{launches[other]} calls launched {other}, another route's kernel")


# the kernel wrappers of ``avsr_tpu_torch.kernels`` whose calls
# ``record_shapes`` logs (K7's ``BeamStep`` too, as ``beam_step``)
WRAPPERS = ("lstm_scan_fwd", "lstm_scan_bwd", "gru_scan_fwd", "gru_scan_bwd",
            "ln_lstm_scan_fwd", "ln_lstm_scan_bwd",
            "logmel_post_dft", "fusion_attention_fwd",
            "fusion_attention_bwd", "decoder_attention_fwd", "decoder_attention_bwd",
            "attention_bwd_core", "decode_attention", "beam_step", "av_align_scan",
            "av_align_scan_bwd", "bahdanau_attend", "attend_step_bwd", "attend_loop_sums",
            "encoder_attention_fwd", "encoder_attention_bwd", "encoder_attention_bwd_core",
            "conformer_conv_fwd", "conformer_conv_bwd")
# the wrappers whose fp32 calls (the fp32 policy's instances) ``record_shapes``
# logs apart, as "<name> fp32": a shape held in bf16 does not cover it; each
# with the position of the argument whose dtype is the compute dtype (K10's
# query and keys are fp32 under either policy: its wq, or its v, tells)
F32_WRAPPERS = {"lstm_scan_fwd": 0, "lstm_scan_bwd": 0, "fusion_attention_fwd": 0,
                "decoder_attention_fwd": 0, "attention_bwd_core": 1, "decode_attention": 0,
                "av_align_scan": 0, "av_align_scan_bwd": 0, "bahdanau_attend": 1,
                "attend_step_bwd": 1, "attend_loop_sums": 1}
# the phases that hold kernels against their plain twins: the shapes their
# calls take are the shapes checked
KERNEL_PHASES = (3, 4, 6, 7, 9, 10, 11, 13, 14, 17, 18, 20, 21, 25, 26, 28, 29, 30, 35, 36, 37,
                 51, 52, 57, 58, 63, 64, 65, 71, 72)
# the phases whose shapes must all be among KERNEL_PHASES' (phase 48)
COVERED_PHASES = (46, 47, 49, 50, 53, 54, 55, 56, 59, 60, 61, 62, 66, 67, 68, 69, 70, 73, 74, 75)


@contextlib.contextmanager
def record_shapes(into):
    """Within: each call of a kernel wrapper (``WRAPPERS``) adds (its name,
    with " fp32" where an fp32-capable one (``F32_WRAPPERS``) takes fp32
    operands, the shapes of its tensor arguments, None for a None argument)
    to the set ``into``; K7 adds (beam_step, (B, W, V)) whether a ``BeamStep`` or
    ``kernels.beam_step`` launches it.  A call that raises adds nothing."""
    import torch

    from avsr_tpu_torch import kernels

    def shapes(args, kwargs):
        return tuple(None if x is None else tuple(x.shape)
                     for x in (*args, *kwargs.values()) if x is None or torch.is_tensor(x))

    def recorded(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            if name == "beam_step":  # (logits [B * W, V], logp [B, W], ...)
                into.add((name, (*args[1].shape, args[0].shape[1])))
            else:
                at = F32_WRAPPERS.get(name)
                fp32 = (at is not None and at < len(args) and torch.is_tensor(args[at])
                        and args[at].dtype == torch.float32)
                into.add((name + (" fp32" if fp32 else ""), shapes(args, kwargs)))
            return out
        return call

    class RecordedBeamStep(kernels.BeamStep):
        def __init__(self, lp_table, tokens, parents, carries, V):
            super().__init__(lp_table, tokens, parents, carries, V)
            into.add(("beam_step", (*tokens.shape[1:], V)))

    with contextlib.ExitStack() as stack:
        for name in WRAPPERS:
            stack.enter_context(mock.patch.object(kernels, name,
                                                  recorded(name, getattr(kernels, name))))
        stack.enter_context(mock.patch.object(kernels, "BeamStep", RecordedBeamStep))
        yield into


def phase_shapes_covered(held, launched):
    """Fails where ``COVERED_PHASES`` called a kernel at shapes (``record_shapes``)
    that no kernel-vs-plain phase held it at; prints each kernel's count of
    shapes on the paths and among the held ones."""
    # shapes hold None for a None argument (an unmasked scan's rd), so they
    # sort by their text
    missing = sorted(launched - held, key=repr)
    for name in sorted({n for n, _ in launched}):
        on_path = sorted((s for n, s in launched if n == name), key=repr)
        print(f"shapes {name}: {len(on_path)} on phases {COVERED_PHASES}, "
              f"{sum(1 for n, _ in held if n == name)} held against the plain twin; "
              f"not held: {[s for n, s in missing if n == name]}")
    if missing:
        fail("shapes", f"{len(missing)} kernel calls of phases {COVERED_PHASES} at shapes no "
                       f"kernel-vs-plain phase held: {missing}")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call of ``fn``, in milliseconds."""
    import torch

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


def device_events(fn):
    """Run ``fn`` under ``torch.profiler``: (the device's kernel and copy
    events as (start us, end us, name), the host span of the run in us)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = prof.events()
    dev = [(e.time_range.start, e.time_range.end, e.name) for e in evs
           if e.device_type == DeviceType.CUDA]
    host = [e.time_range for e in evs if e.device_type == DeviceType.CPU]
    span = (max(r.end for r in host) - min(r.start for r in host)) if host else 0.0
    return dev, span


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn``, host dispatch hidden: the timed
    calls are queued behind a spin kernel that outlasts their enqueueing
    (twice the host time of ``reps`` calls, at 2 GHz), so the device runs
    them back to back between two CUDA events.  ``fn`` must not wait on
    the device."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    enqueue_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * enqueue_s * 2e9) + 1_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def busy_share(dev, span):
    """(device busy us, busy share of the host span): the union of the
    device events' intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for start, end, _ in sorted(dev):
        if cur_e is None or start > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, (busy / span if span else 0.0)


def profile_report(label, fn, per=1, per_name="call", shares=()):
    """Profile one run of ``fn``: device busy share, device events per
    ``per_name``, the device time of the top kernels and, for each (label,
    name part, or a tuple of parts) of ``shares``, the share of the device's
    busy time taken by the kernels whose name holds every part."""
    import collections

    dev, span = device_events(fn)
    busy, share = busy_share(dev, span)
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for start, end, name in dev:
        by_name[name][0] += 1
        by_name[name][1] += end - start
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    print(f"profile {label}: host span {span / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, "
          f"busy share {share:.3f}, {len(dev)} device events ({len(dev) / per:.1f} per "
          f"{per_name})")
    for name, (n, us) in top:
        print(f"  {us / 1e3:8.3f} ms {n:6d}x  {name[:100]}")
    for what, parts in shares:
        hit = [(c, t) for name, (c, t) in by_name.items()
               if all(p in name for p in ((parts,) if isinstance(parts, str) else parts))]
        n = sum(c for c, _ in hit)
        us = sum(t for _, t in hit)
        print(f"profile {label}: {what} {us / 1e3:.3f} ms of device time over {n} launches "
              f"({us / 1e3 / per:.3f} ms per {per_name}), share of device busy "
              f"{us / busy if busy else 0.0:.3f}")


def bound(nbytes: float, flops, dtype: str = "bf16"):
    """The least time the card could take: (ms, what bounds it), the larger
    of the bytes over HBM bandwidth and the operations over the peak rate
    (``flops`` a count in ``dtype``, or a {dtype: count} dict)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ops = flops.items() if isinstance(flops, dict) else [(dtype, flops)]
    t_ops = sum(f / PEAK_FLOPS[d] for d, f in ops) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def requested_by(fn):
    """(fn's result, the most device memory its allocations asked for beyond
    what was live before it), from the caching allocator's requested-bytes
    counters: the sizes asked for, which its block rounding does not
    inflate (a block's unsplit remainder, up to 1 MB, counts as allocated)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_stats()["requested_bytes.all.current"]
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.memory_stats()["requested_bytes.all.peak"] - before


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_err(a, b) -> float:
    """Max abs error over the largest |plain| value."""
    return max_err(a, b) / max(float(b.float().abs().max()), 1e-30)


def k1_inputs(T, G, B, H, dev, seed=0):
    import torch

    g = torch.Generator().manual_seed(seed)
    wh = torch.randn((G, H, 4 * H), generator=g) / H ** 0.5
    b = 0.1 * torch.randn((G, 4 * H), generator=g)
    xw = torch.randn((T, G, B, 4 * H), generator=g).to(torch.bfloat16)
    lengths = torch.randint(1, T + 1, (B,), generator=g)
    lengths[0] = T
    if B > 1:
        lengths[1] = 0  # a row with no valid step
    m = (torch.arange(T)[:, None] < lengths[None, :]).float()
    mask = torch.stack([m, torch.flip(m, (0,))], dim=1)[:, :G]
    h0 = torch.zeros((G, B, H))
    c0 = torch.zeros((G, B, H))
    return [x.to(dev) for x in (wh, b, xw, mask, h0, c0)]


def k1_bwd_inputs(T, G, B, H, dev, seed=0):
    """K1 operands, the kernel forward's residuals and random cotangents."""
    import torch

    from avsr_tpu_torch.ops import rnn

    wh, b, xw, mask, h0, c0 = k1_inputs(T, G, B, H, dev, seed)
    _, (h_res, c_res) = rnn.scan_core_fwd(wh, b, xw, mask, h0, c0, torch.bfloat16, save=True)
    g = torch.Generator().manual_seed(seed + 1)
    dys = torch.randn((T, G, B, H), generator=g).to(torch.bfloat16).to(dev)
    dhT = torch.randn((G, B, H), generator=g).to(dev)
    dcT = torch.randn((G, B, H), generator=g).to(dev)
    return [wh, b, xw, mask, h_res, c_res, dys, dhT, dcT, torch.bfloat16]


def k3_inputs(cfg, B, S, dev, seed=1):
    import torch

    from avsr_tpu_torch.ops import audio_features as af

    g = torch.Generator().manual_seed(seed)
    wav = 0.3 * torch.randn((B, S), generator=g)
    lengths = torch.randint(S // 2, S + 1, (B,), generator=g, dtype=torch.int32)
    lengths[0] = S
    lengths[1] = 300   # no full 400-sample frame: zero frames, zero output
    lengths[2] = 1000  # 4 frames, fewer than one 8-frame stack
    wav = wav * (torch.arange(S)[None, :] < lengths[:, None])
    wav, lengths = wav.to(dev), lengths.to(dev)
    re, im = af.stft(wav, cfg.frame_length, cfg.frame_step, cfg.fft_length, torch.bfloat16)
    feat_len = torch.where(
        lengths >= cfg.frame_length,
        1 + torch.div(lengths - cfg.frame_length, cfg.frame_step, rounding_mode="floor"),
        torch.zeros_like(lengths)).to(torch.int32)
    return re.contiguous(), im.contiguous(), feat_len


def k4_inputs(B, nh, Ta, Tv, A, dev, seed=2, dv=None):
    import torch

    dv = dv or A
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, Ta, nh, A), generator=g).to(torch.bfloat16)
    k = torch.randn((B, Tv, nh, A), generator=g).to(torch.bfloat16)
    v = torch.randn((B, Tv, nh, dv), generator=g).to(torch.bfloat16)
    vlen = torch.randint(1, Tv + 1, (B,), generator=g, dtype=torch.int32)
    vlen[0] = Tv
    vlen[1] = 0  # no video: the reference's uniform softmax over all keys
    dctx = torch.randn((B, Ta, nh, dv), generator=g).to(torch.bfloat16)
    return [x.to(dev) for x in (q, k, v, vlen, dctx)]


def sdpa(q, k, v, mask):
    """The library yardstick: one ``scaled_dot_product_attention`` call on
    the same [B, T, heads, d] operands and additive mask (timed here only;
    the port never calls it)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), attn_mask=mask)


def request(rng, n, seconds=6.0, fps=25.0, low=None):
    """n utterances of ``low`` (default 2 s, or half of ``seconds``) to
    ``seconds``: a two-tone waveform with noise and uniform 36x36 ROIs."""
    audio, video = [], []
    for _ in range(n):
        sec = float(rng.uniform(min(2.0, seconds / 2) if low is None else low, seconds))
        ns = int(sec * 16000)
        t = np.arange(ns) / 16000.0
        f0 = rng.uniform(120, 300)
        wav = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.2 * np.sin(2 * np.pi * 3.1 * f0 * t)
        audio.append((wav + 0.05 * rng.standard_normal(ns)).astype(np.float32))
        nf = min(int(np.ceil(sec * fps)), int(np.ceil(seconds * fps)))
        video.append(rng.uniform(0, 1, (nf, 36, 36, 1)).astype(np.float32))
    return audio, video


def regime_request(cfg):
    """``request`` for ``cfg``'s architecture: its audio and ROI video, AU
    intensities in [0, 1] for an AU-feature frontend, and None for a
    modality the architecture does not read."""
    from avsr_tpu_torch.models import seq2seq

    def make(rng, n, seconds=6.0):
        audio, video = request(rng, n, seconds)
        if cfg.video.use_au_features:
            video = [rng.uniform(0, 1, (len(v), cfg.video.au_dim)).astype(np.float32)
                     for v in video]
        return (audio if seq2seq.uses_audio(cfg) else None,
                video if seq2seq.uses_video(cfg) else None)
    return make


def train_batch(cfg, vocab_size, dev, B=128, seconds=6.0, label_cap=80, seed=3):
    """One bucket-3 batch as the loader ships it: int16 PCM, uint8 ROI
    crops, ragged 2-6 s utterances, EOS-terminated targets up to the label
    cap, AU targets at the frontend rate.  Returns (batch, 10 ms audio
    frames per step as ``bench.py`` counts them)."""
    from avsr_tpu_torch.data.units import EOS_ID
    from avsr_tpu_torch.models import seq2seq

    rng = np.random.default_rng(seed)
    S = int(seconds * 16000)
    T_v = int(np.ceil(seconds * 25))
    audio, video = request(rng, B, seconds)
    arrays = {
        "audio": np.zeros((B, S), np.int16),
        "audio_lengths": np.array([len(a) for a in audio], np.int32),
        "video": np.zeros((B, T_v, 36, 36, 1), np.uint8),
        "video_lengths": np.array([len(v) for v in video], np.int32),
        "targets": np.zeros((B, label_cap), np.int32),
        "target_lengths": rng.integers(10, label_cap + 1, B).astype(np.int32),
        "au_row_weights": np.ones((B,), np.float32),
    }
    for i, (a, v) in enumerate(zip(audio, video)):
        arrays["audio"][i, :len(a)] = np.round(np.clip(a, -1, 1) * 32767).astype(np.int16)
        arrays["video"][i, :len(v)] = np.round(v * 255).astype(np.uint8)
        n = arrays["target_lengths"][i]
        arrays["targets"][i, :n - 1] = rng.integers(3, vocab_size, n - 1)
        arrays["targets"][i, n - 1] = EOS_ID
    T_front = (int((S - cfg.audio.frame_length) / cfg.audio.frame_step + 1)
               - cfg.audio.frame_stacking) // cfg.audio.frame_skipping + 1
    # AU intensities: a level per utterance in [0, 1] with small frame noise
    # (learnable, as real slowly varying intensities are; N(0, 1) targets
    # would sit at the loss floor from the first step)
    level = rng.uniform(0.0, 1.0, (B, 1, cfg.fusion.au_dim))
    arrays["au_targets"] = (level + 0.05 * rng.standard_normal(
        (B, T_front, cfg.fusion.au_dim))).astype(np.float32)
    return seq2seq.batch_to_device(arrays, dev), B * int(
        (S - cfg.audio.frame_length) / cfg.audio.frame_step + 1)


def noise_bank(cfg, dev, seed=4, rows=8, length=120000):
    """A synthetic two-type bank from a seed: tone mixtures ("babble") and
    white noise ("cafe"), longer than the 6 s waveform."""
    from avsr_tpu_torch.ops.noise import NoiseBank

    rng = np.random.default_rng(seed)
    t = np.arange(length) / 16000.0
    babble = sum(np.sin(2 * np.pi * rng.uniform(100, 400, (rows, 1)) * t[None, :]
                        + rng.uniform(0, 6.3, (rows, 1))) for _ in range(5))
    cafe = rng.standard_normal((rows, length))
    banks = {"babble": 0.1 * babble, "cafe": 0.05 * cafe}
    return NoiseBank.create({n: banks[n].astype(np.float32) for n in cfg.noise.noise_types},
                            device=dev)


@contextlib.contextmanager
def plain_cores():
    """Route every kernel wrapper to its plain version (reference runs)."""
    from avsr_tpu_torch.decode import beam
    from avsr_tpu_torch.models import fusion as fus
    from avsr_tpu_torch.models import transformer as tfm
    from avsr_tpu_torch.models import transformer_decoder as tdec
    from avsr_tpu_torch.ops import attention as attn
    from avsr_tpu_torch.ops import audio_features as af
    from avsr_tpu_torch.ops import rnn

    plain = ((rnn, "scan_core_fwd", rnn.bilstm_scan_core_fwd_impl),
             (rnn, "scan_core_bwd", rnn.bilstm_scan_core_bwd_plain),
             (rnn, "gru_core_fwd", rnn.gru_scan_core_fwd_plain),
             (rnn, "gru_core_bwd", rnn.gru_scan_core_bwd_plain),
             (rnn, "ln_core_fwd", rnn.ln_lstm_scan_core_fwd_plain),
             (rnn, "ln_core_bwd", rnn.ln_lstm_scan_core_bwd_plain),
             (af, "logmel_post_dft", af.logmel_post_dft_plain),
             (fus, "fusion_attention_fwd", fus.fusion_attention_fwd_plain),
             (fus, "fusion_attention_bwd", fus.fusion_attention_bwd_plain),
             (tdec, "decoder_attention_fwd", tdec.decoder_attention_fwd_plain),
             (tdec, "decoder_attention_bwd", tdec.decoder_attention_bwd_plain),
             (tdec, "decode_attention", tdec.decode_attention_plain),
             (beam, "beam_stepper", beam.plain_stepper),
             (fus, "av_align_scan_fwd", fus.av_align_scan_fwd_plain),
             (fus, "av_align_scan_bwd", fus.av_align_scan_bwd_plain),
             (attn, "attend_fwd", attn.attend_plain),
             (attn, "read_fwd", attn.read_fwd_plain),
             (attn, "read_step_bwd", attn.read_step_bwd_plain),
             (attn, "read_loop_sums", attn.read_loop_sums_plain),
             (tfm, "encoder_self_attention_fwd", tfm.encoder_self_attention_fwd_plain),
             (tfm, "encoder_self_attention_bwd", tfm.encoder_self_attention_bwd_plain),
             (tfm, "conformer_conv_fwd", tfm.conformer_conv_plain),
             (tfm, "conformer_conv_bwd", tfm.conformer_conv_bwd_plain))
    with contextlib.ExitStack() as stack:
        for module, name, twin in plain:
            stack.enter_context(mock.patch.object(module, name, twin))
        yield


# K1's (T, B) at G = 2, H = 256: the fast audio encoder's layers (T = 99,
# then 50), the video encoder (150) and lrs2_av_align's audio layers (197) at
# B = 128; a ragged B = 8 (a serve request) with a 0-length row, B = 1, and
# 16 s of audio (T = 531, the longest the presets take) at B = 4
K1_SHAPES = ((99, 128), (50, 128), (150, 128), (197, 128), (99, 8), (99, 1), (531, 4))
# The train buckets of lrs2_av_align and lrs2_av_fast (2, 4, 6, 10 and 16 s
# of audio; phases 46-47 step each, their warm-ups the 10 s and 16 s ones):
# (B, STFT frames, T_a after stacking, T_v, label cap).  The kernel phases
# hold each kernel at the shapes these give (the ``*_BUCKET_SHAPES``), and
# phase 48 fails where phases 46-47 call a kernel at shapes no kernel phase
# held.
TRAIN_BUCKETS = ((128, 200, 65, 51, 30), (128, 400, 131, 101, 55), (128, 600, 198, 151, 80),
                 (64, 1000, 331, 251, 130), (32, 1600, 531, 401, 150))
# The serving buckets of phases 49-50: artifacts of 2, 6 and 10 s of audio at
# B = 8 (a request padded to its bucket), the beam's horizon 150, in
# TRAIN_BUCKETS' form.  The kernel phases hold the serving kernels (K1 fwd,
# K3, K4 fwd, K6, K7, K8 fwd, K10) at these shapes too (``*_SERVE_SHAPES``,
# ``K10_SERVE_READS``).
SERVE_SECONDS = (2, 6, 10)
SERVE_BUCKETS = ((8, 198, 64, 50, 150), (8, 598, 197, 150, 150), (8, 998, 331, 250, 150))
# K1 at the buckets: align's audio layers (T_a) and both video encoders
# (T_v), fast's audio layers (T_a, then halved twice: 65 -> 33 -> 17)
K1_BUCKET_SHAPES = tuple(sorted({(T, B) for B, _, Ta, Tv, _ in TRAIN_BUCKETS
                                 for T in (Ta, -(-Ta // 2), -(-Ta // 4), Tv)}
                                - set(K1_SHAPES)))
K1_SERVE_SHAPES = tuple(sorted({(T, B) for B, _, Ta, Tv, _ in SERVE_BUCKETS
                                for T in (Ta, -(-Ta // 2), -(-Ta // 4), Tv)}
                               - set(K1_SHAPES) - set(K1_BUCKET_SHAPES)))
K2_SHAPES = ((197, 128), (150, 128), (197, 8), (197, 1), (531, 4))
_LSTM_INFO = {}  # the cluster kernels' build report and occupancy, read once


def lstm_cluster_info():
    """The cluster LSTM kernels as built: registers, spills and HMMA count
    of every instance (fails on a spill or an instance without HMMA), each
    width's shared memory from the library against
    ``kernels.lstm_cluster_smem`` and ``lstm_family``, and the max active
    clusters of the H = 256 launches."""
    from avsr_tpu_torch import kernels

    if _LSTM_INFO:
        return _LSTM_INFO
    widths = [H for H in range(16, 1025, 16) if kernels.lstm_family(2, 1, H) == "cluster"]
    build = build_report("K1", "lstm_scan", {
        f"{kind}<{H}>": (f"lstm_cluster_{kind}ILi{H}E",) for kind in ("fwd", "bwd")
        for H in widths})
    lib = kernels._load()
    for H in range(16, 1025, 16):
        cluster = kernels.lstm_family(2, 1, H) == "cluster"
        for bwd in (0, 1):
            smem = lib.avsr_lstm_cluster_smem(H, bwd)
            want = kernels.lstm_cluster_smem(H, bool(bwd)) if cluster else -1
            if smem != want:
                fail("K1", f"H={H}: the library's cluster instance takes {smem} bytes, "
                           f"lstm_family / lstm_cluster_smem expect {want}")
    occ = {kind: lib.avsr_lstm_cluster_max_active(256, bwd)
           for kind, bwd in (("fwd", 0), ("bwd", 1))}
    print(f"K1 cluster kernels: instances at H {widths}; shared memory per CTA at H=256 "
          f"{kernels.lstm_cluster_smem(256, False)} / {kernels.lstm_cluster_smem(256, True)} B "
          f"(fwd / bwd); max active clusters of 8 CTAs at H=256 {occ} (cudaOccupancy"
          f"MaxActiveClusters)")
    if min(occ.values()) < 1:
        fail("K1", f"a cluster kernel cannot be resident: {occ}")
    _LSTM_INFO.update(build=build, max_active_clusters=occ)
    return _LSTM_INFO


def lstm_kept(ys, hT, cT, h0, c0):
    """Row 1 has no valid step: h0 and c0 come back as hT and cT, its
    outputs are zero (True where there is no row 1)."""
    import torch

    return ys.shape[2] < 2 or (torch.equal(hT[:, 1], h0[:, 1]) and torch.equal(cT[:, 1], c0[:, 1])
                               and float(ys[:, :, 1].float().abs().max()) == 0.0)


def lstm_passed(dxw, dh0, dc0, dhT, dcT):
    """Row 1 has no valid step: its dxw is zero and dhT / dcT reach dh0 /
    dc0 unchanged (True where there is no row 1)."""
    import torch

    return dxw.shape[2] < 2 or (float(dxw[:, :, 1].float().abs().max()) == 0.0
                                and torch.equal(dh0[:, 1], dhT[:, 1])
                                and torch.equal(dc0[:, 1], dcT[:, 1]))


def lstm_bwd_kernel(args):
    """The kernel wrapper's call for ``rnn.scan_core_bwd``'s arguments: the
    cluster backward alone, without the caller's dWh product."""
    import torch

    from avsr_tpu_torch import kernels

    wh, b, xw, mask, h_res, c_res, dys, dhT, dcT, _ = args
    bf = torch.bfloat16
    ka = (wh.to(bf).contiguous(), b.float().contiguous(), xw.to(bf).contiguous(),
          mask.float().contiguous(), h_res, c_res, dys, dhT, dcT)
    return lambda: kernels.lstm_scan_bwd(*ka)


def cudnn_lstm_ms(T, B, H, dev, D=512):
    """(forward, backward) device ms of cuDNN's bidirectional ``nn.LSTM``
    (fp16, input width D) at [T, B, H]: a reference point, not a library
    call for K1's function: it also multiplies the input (K1 takes the
    hoisted product) and has no mask."""
    import torch

    lstm = torch.nn.LSTM(D, H, bidirectional=True).to(dev, torch.float16)
    g = torch.Generator().manual_seed(T + B)
    x = torch.randn((T, B, D), generator=g).to(dev, torch.float16).requires_grad_(True)
    dy = torch.randn((T, B, 2 * H), generator=g).to(dev, torch.float16)
    with torch.no_grad():
        fwd = device_ms(lambda: lstm(x))
    both = device_ms(lambda: lstm(x)[0].backward(dy))
    return fwd, both - fwd


def phase_k1(dev, report):
    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.ops import rnn

    info = lstm_cluster_info()
    bf = torch.bfloat16
    errs, dms = {}, {}
    for T, B in K1_SHAPES + K1_BUCKET_SHAPES + K1_SERVE_SHAPES:
        args = k1_inputs(T, 2, B, 256, dev, seed=T + B)
        out_k = rnn.bilstm_scan_core(*args, bf)
        again = rnn.bilstm_scan_core(*args, bf)
        out_p = rnn.bilstm_scan_core_plain(*args, bf)
        torch.cuda.synchronize()
        e = {n: max_err(a, b_) for n, a, b_ in zip(("ys", "hT", "cT"), out_k, out_p)}
        same = all(torch.equal(a, b_) for a, b_ in zip(out_k, again))
        kept = lstm_kept(*out_k, args[4], args[5])
        family = kernels.lstm_family(2, B, 256)
        dms[(T, B)] = device_ms(lambda: rnn.bilstm_scan_core(*args, bf))
        print(f"K1 [T={T},G=2,B={B},H=256] family {family}: max abs err {e} (tol {K1_TOL}); two "
              f"launches bit-equal: {same}; the 0-length row kept its state: {kept}; device "
              f"{dms[(T, B)]:.4f} ms, {dms[(T, B)] / T * 1e3:.3f} us per step")
        if not (family == "cluster" and all(torch.isfinite(x.float()).all() for x in out_k)
                and max(e.values()) <= K1_TOL and same and kept):
            fail("K1", f"kernel disagrees with the plain version at T={T}, B={B}: {e}, bit-equal "
                       f"{same}, 0-length row kept {kept}, family {family}")
        errs[(T, B)] = max(e.values())
    wh, b, xw, mask, h0, c0 = k1_inputs(99, 2, 128, 256, dev, seed=99 + 128)
    ys_k, hT_k, cT_k = rnn.bilstm_scan_core(wh, b, xw, mask, h0, c0, bf)
    k1 = {}
    for B in (128, 8):
        args = k1_inputs(99, 2, B, 256, dev, seed=99 + B)
        k1[B] = (time_ms(lambda: rnn.bilstm_scan_core(*args, bf)),
                 time_ms(lambda: rnn.bilstm_scan_core_plain(*args, bf), reps=5))
        print(f"K1 [T=99,G=2,B={B},H=256] kernel {k1[B][0]:.4f} ms  plain {k1[B][1]:.4f} ms")
    cud = cudnn_lstm_ms(99, 128, 256, dev)
    print(f"reference point, not K1's function: cuDNN bidirectional nn.LSTM (fp16, input width "
          f"512, no mask; it also computes the input product) at [T=99,B=128,H=256] device "
          f"{cud[0]:.4f} ms forward, {cud[1]:.4f} ms backward")
    flops = 2 * 99 * 2 * 128 * 256 * 1024  # h @ Wh at every step, both directions
    report["lstm_scan_fwd"] = dict(
        max_abs_err=max(errs.values()), ms=k1[128][0], plain_ms=k1[128][1], library_ms=None,
        device_ms=dms[(99, 128)],
        bound=bound(nbytes(wh, b, xw, mask, h0, c0, ys_k, hT_k, cT_k), flops),
        per_step_us=dms[(99, 128)] / 99 * 1e3,
        device_ms_by_shape={f"T={T},B={B}": x for (T, B), x in dms.items()},
        registers={k: r["registers"] for k, r in info["build"].items() if k.startswith("fwd")},
        hmma={k: r.get("hmma") for k, r in info["build"].items() if k.startswith("fwd")},
        max_active_clusters=info["max_active_clusters"]["fwd"],
        cudnn_reference_device_ms=cud[0])


K3_SHAPES = ((128, 96000), (8, 96000), (128, 256000), (8, 256000))  # (B, S): 6 s and 16 s
# the train buckets' padded audio (S = (frames - 1) * 160 + 400 samples)
K3_BUCKET_SHAPES = tuple((B, (F - 1) * 160 + 400) for B, F, *_ in TRAIN_BUCKETS)
# a serving bucket's request holds exactly its horizon's samples
K3_SERVE_SHAPES = tuple((B, s * 16000) for (B, *_), s in zip(SERVE_BUCKETS, SERVE_SECONDS)
                        if (B, s * 16000) not in K3_SHAPES)


def k3_stage_ms(args, cfg):
    """Device ms of K3's three launches apart (the mel product, the
    statistics, the writer) on ``args``, each timed on the scratch the
    launches before it filled."""
    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.ops import audio_features as af

    re, im, feat_len = args
    B, T, _ = re.shape
    band = af._mel_band(cfg, re.device)
    kw = dict(log_floor=cfg.log_floor, delta_window=cfg.delta_window,
              stack=cfg.frame_stacking, skip=cfg.frame_skipping)
    scratch = kernels.logmel_scratch(B, T, cfg.num_mel_bins, cfg.frame_stacking,
                                     cfg.frame_skipping, re.device)
    kernels.logmel_stages(re, im, feat_len, *band, scratch, stages=kernels.LOGMEL_STAGES, **kw)
    return {name: device_ms(lambda: kernels.logmel_stages(re, im, feat_len, *band, scratch,
                                                          stages=bit, **kw))
            for name, bit in (("mel", 1), ("stats", 2), ("writer", 4))}


def k3_bound(args, out, new_len, cfg):
    """K3's least time: re, im, the lengths and the banded mel table read
    once, the features and lengths written once; or the power and the
    banded product at the fp32 rate."""
    from avsr_tpu_torch.ops import audio_features as af

    re, im, feat_len = args
    band, weights = af._mel_band(cfg, re.device)
    B, T, F = re.shape
    return bound(nbytes(re, im, feat_len, out, new_len, band, weights),
                 B * T * (3 * F + 2 * weights.numel()), "fp32")


def phase_k3(dev, report, cfg):
    import torch

    from avsr_tpu_torch.ops import audio_features as af

    from avsr_tpu_torch import kernels

    lib = kernels._load()
    for chunk in kernels.LOGMEL_CHUNKS:
        want = kernels.logmel_writer_smem(cfg.audio.num_mel_bins, chunk, cfg.audio.frame_stacking,
                                          cfg.audio.frame_skipping, cfg.audio.delta_window)
        got = lib.avsr_logmel_writer_smem(cfg.audio.num_mel_bins, chunk, cfg.audio.frame_stacking,
                                          cfg.audio.frame_skipping, cfg.audio.delta_window, 1)
        if got != want:
            fail("K3", f"chunk {chunk}: the writer's shared memory {got} is not "
                       f"kernels.logmel_writer_smem's {want}")
    worst, times = 0.0, {}
    for B, S in K3_SHAPES + K3_BUCKET_SHAPES + K3_SERVE_SHAPES:
        args = k3_inputs(cfg.audio, B, S, dev, seed=B + S)
        f_k, n_k = af.logmel_post_dft(*args, cfg.audio)
        f_p, n_p = af.logmel_post_dft_plain(*args, cfg.audio)
        torch.cuda.synchronize()
        err = max_err(f_k, f_p)
        worst = max(worst, err)
        tag = f"B={B},S={S}"
        print(f"K3 [{tag}] max abs err {err} (tol {K3_TOL}); out {tuple(f_k.shape)}")
        if not torch.equal(n_k, n_p):
            fail("K3", f"{tag}: kernel and plain lengths differ")
        if not (err <= K3_TOL) or not torch.isfinite(f_k).all():
            fail("K3", f"{tag}: kernel disagrees with the plain version: {err}")
        f_again, _ = af.logmel_post_dft(*args, cfg.audio)
        if not torch.equal(f_again, f_k):
            fail("K3", f"{tag}: two launches differ")
        t = dict(ms=time_ms(lambda: af.logmel_post_dft(*args, cfg.audio)),
                 plain_ms=time_ms(lambda: af.logmel_post_dft_plain(*args, cfg.audio), reps=5),
                 device_ms=device_ms(lambda: af.logmel_post_dft(*args, cfg.audio)),
                 stages=k3_stage_ms(args, cfg.audio),
                 bound=k3_bound(args, f_k, n_k, cfg.audio))
        times[tag] = t
        print(f"K3 [{tag}] kernel {t['ms']:.4f} ms, device {t['device_ms']:.4f} ms (launches: "
              + ", ".join(f"{k} {x:.4f}" for k, x in t["stages"].items())
              + f"), plain {t['plain_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms "
              f"({t['bound'][1]})")
    main = times["B={},S={}".format(*K3_SHAPES[0])]  # the train step's, B=128, 6 s
    report["logmel_post_dft"] = dict(
        max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"], library_ms=None,
        device_ms=main["device_ms"], bound=main["bound"], stage_device_ms=main["stages"],
        by_shape={tag: dict(ms=t["ms"], device_ms=t["device_ms"], stage_device_ms=t["stages"],
                            bound_ms=t["bound"][0]) for tag, t in times.items()})


def phase_serve(dev, card, cfg, label="serve", needed=SERVE_KERNELS,
                mem_shapes=((8, 50, 1024),), spread=False, mem_tol=MEMORY_TOL, exact=False):
    """Serve 3 full-width requests of ``cfg``'s model through a CUDA
    ``Predictor``; ``needed`` kernels must launch, the memories (of
    ``mem_shapes``, one a memory; within ``mem_tol``) and the beam must
    agree with the plain path (with ``spread``, the memories within
    ``SPREAD_FACTOR`` times the plain path's own spread under ``scaled``
    parameters, and every K13 call of the encode held by
    ``hold_k13_calls``); with ``exact``, the request's ids equal the whole
    plain path's (its encode and its beam)."""
    import torch

    from avsr_tpu_torch.data.units import builtin_unit_dict
    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.models import seq2seq
    from avsr_tpu_torch.serve import Predictor
    from avsr_tpu_torch.utils.params import param_count

    units = builtin_unit_dict(cfg.data.unit)
    t0 = time.perf_counter()
    params = seq2seq.model_init(cfg, units.vocab_size, torch.Generator().manual_seed(0), dev)
    pred = Predictor(params, cfg, units, device=dev, batch_size=8, audio_seconds=6.0,
                     transfer="compact")
    print(f"{label}: {cfg.name} model_init {time.perf_counter() - t0:.3f} s, "
          f"{param_count(params)} params")
    rng = np.random.default_rng(0)
    make_request = regime_request(cfg)
    requests = [make_request(rng, 8) for _ in range(4)]
    pred.transcribe(audio=requests[0][0], video=requests[0][1])  # warm-up request
    torch.cuda.synchronize()

    kernels.reset_launches()
    latencies, texts = [], []
    for audio, video in requests[1:]:
        t0 = time.perf_counter()
        texts.append(pred.transcribe(audio=audio, video=video))
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
    launches = dict(kernels.LAUNCHES)
    print(f"{label} launches {launches}")
    for name in needed:
        if launches[name] == 0:
            fail(label, f"kernel {name} was not launched by the serving path")
    check_other_route(label, launches)
    if any(len(t) != 8 for t in texts):
        fail(label, "wrong number of transcripts")

    arrays, _ = pred.assemble(*requests[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with k13_calls() if spread else contextlib.nullcontext() as calls:
        enc_k = pred.encode(arrays)
    torch.cuda.synchronize()
    t_enc = (time.perf_counter() - t0) * 1e3
    if spread:
        hold_k13_calls(label, calls)
        del calls
    res = pred.beam(enc_k)
    t_beam = (time.perf_counter() - t0) * 1e3 - t_enc
    ids = res.ids
    V = units.vocab_size
    if tuple(ids.shape) != (8, cfg.decode.max_decode_length) or int(ids.min()) < 0 \
            or int(ids.max()) >= V:
        fail(label, f"ids of shape {tuple(ids.shape)} in [{int(ids.min())}, {int(ids.max())}]")
    before = dict(kernels.LAUNCHES)
    with plain_cores():
        enc_p = pred.encode(arrays)
        t0 = time.perf_counter()
        res_p = pred.beam(enc_k)  # the same memories through the plain decode kernels
        torch.cuda.synchronize()
        t_beam_p = (time.perf_counter() - t0) * 1e3
        res_pp = pred.beam(enc_p) if exact else None
    if kernels.LAUNCHES != before:
        fail(label, "the plain reference run launched a kernel")
    if exact:
        print(f"{label} the request's ids against the whole plain path's (its encode and its "
              f"beam): equal {torch.equal(res.ids, res_pp.ids)}")
        if not torch.equal(res.ids, res_pp.ids):
            fail(label, "the kernel path's ids differ from the plain path's")
    same = [bool(torch.equal(a, b)) for a, b in zip(res.ids, res_p.ids)]
    score_rel = float(((res.scores - res_p.scores).abs() / res_p.scores.abs()).max())
    print(f"{label} beam kernel path vs plain path on the same memories: {sum(same)} of 8 rows "
          f"with identical ids; best scores {[round(float(x), 3) for x in res.scores]} vs "
          f"{[round(float(x), 3) for x in res_p.scores]}, max rel diff {score_rel:.3e} "
          f"(tol {BEAM_SCORE_REL_TOL}); steps {res.steps} / {res_p.steps}; plain beam "
          f"{t_beam_p:.3f} ms")
    if not score_rel <= BEAM_SCORE_REL_TOL:
        fail(label, f"kernel path beam scores disagree with the plain path: {score_rel}")
    if len(enc_k.memories) != len(mem_shapes):
        fail(label, f"{len(enc_k.memories)} memories, expected {len(mem_shapes)}")
    enc_s = None
    if spread:
        params = pred.params
        pred.params = scaled(params)
        with plain_cores():
            enc_s = pred.encode(arrays)
        pred.params = params
    for i, (m_k, m_p, shape) in enumerate(zip(enc_k.memories, enc_p.memories, mem_shapes)):
        mk, mp = m_k.values, m_p.values
        what = "fused memory" if cfg.architecture == "av_align" else f"memory {i}"
        if tuple(mk.shape) != shape or not torch.isfinite(mk).all():
            fail(label, f"{what} of shape {tuple(mk.shape)} or not finite")
        mem_err = max_err(mk, mp)
        mem_mean = float((mk - mp).abs().mean())
        tol = mem_tol
        if enc_s is not None:
            own = max_err(enc_s.memories[i].values, mp)
            tol = max(mem_tol, SPREAD_FACTOR * own)
            print(f"{label} {what}: the plain path's own spread at parameters times (1 + "
                  f"{SPREAD_EPS}): max abs {own}")
        print(f"{label} {what} {tuple(mk.shape)}: max abs err {mem_err} mean {mem_mean} "
              f"(tol {tol}) vs the plain path")
        if not mem_err <= tol:
            fail(label, f"kernel path memory disagrees with the plain path: {mem_err}")
    print(f"{label} [{card}] per-request latency ms (B=8, 6 s, beam 10, horizon 150): "
          f"{[round(x, 3) for x in latencies]} median {statistics.median(latencies):.3f}; "
          f"encode {t_enc:.3f} ms, beam {t_beam:.3f} ms ({res.steps} steps)")
    print(f"{label} sample transcript: {texts[0][0][:60]!r}")
    profile_report(f"{label} request (B=8, width 10)",
                   lambda: pred.transcribe(audio=requests[1][0], video=requests[1][1]),
                   per=res.steps, per_name="beam step")
    return launches


def phase_k1_bwd(dev, report):
    import torch

    from avsr_tpu_torch.ops import rnn

    info = lstm_cluster_info()
    names = ("dWh", "db", "dxw", "dh0", "dc0")
    errs, abs_errs, dms = {}, {}, {}
    for T, B in K1_SHAPES + K1_BUCKET_SHAPES:
        args = k1_bwd_inputs(T, 2, B, 256, dev, seed=T + B)
        out_k = rnn.scan_core_bwd(*args)
        again = rnn.scan_core_bwd(*args)
        out_p = rnn.bilstm_scan_core_bwd_plain(*args)
        torch.cuda.synchronize()
        e = {n: rel_err(a, b_) for n, a, b_ in zip(names, out_k, out_p)}
        same = all(torch.equal(a, b_) for a, b_ in zip(out_k, again))
        passed = lstm_passed(out_k[2], out_k[3], out_k[4], args[7], args[8])
        dms[(T, B)] = device_ms(lstm_bwd_kernel(args))
        with_dwh = device_ms(lambda: rnn.scan_core_bwd(*args))
        print(f"K1 bwd [T={T},G=2,B={B},H=256] max error relative to max |plain| "
              f"{ {n: f'{x:.3e}' for n, x in e.items()} } (tol {K1B_REL_TOL}); two launches "
              f"bit-equal: {same}; the 0-length row passes dhT/dcT through: {passed}; device "
              f"{dms[(T, B)]:.4f} ms, {dms[(T, B)] / T * 1e3:.3f} us per step ({with_dwh:.4f} ms "
              f"with the caller's dWh product)")
        if (T, B) == (99, 128):
            dms_dwh = with_dwh
        if not (all(torch.isfinite(x.float()).all() for x in out_k)
                and max(e.values()) <= K1B_REL_TOL and same and passed):
            fail("K1 bwd", f"kernel disagrees with the plain twin at T={T}, B={B}: {e}, "
                           f"bit-equal {same}, 0-length row {passed}")
        errs[(T, B)] = max(e.values())
        abs_errs[(T, B)] = max(max_err(a, b_) for a, b_ in zip(out_k, out_p))
    args = k1_bwd_inputs(99, 2, 128, 256, dev, seed=99 + 128)
    out_k = rnn.scan_core_bwd(*args)
    times = {}
    for B in (128, 8):
        a = k1_bwd_inputs(99, 2, B, 256, dev, seed=99 + B)
        times[B] = (time_ms(lambda: rnn.scan_core_bwd(*a)),
                    time_ms(lambda: rnn.bilstm_scan_core_bwd_plain(*a), reps=5))
        print(f"K1 bwd [T=99,G=2,B={B},H=256] kernel {times[B][0]:.4f} ms  "
              f"plain {times[B][1]:.4f} ms")
    flops = 2 * 2 * 99 * 2 * 128 * 256 * 1024  # gate recompute, dh product (dWh is the caller's)
    report["lstm_scan_bwd"] = dict(
        max_abs_err=max(abs_errs.values()), ms=times[128][0], plain_ms=times[128][1],
        library_ms=None, device_ms=dms[(99, 128)],
        bound=bound(nbytes(*args[:9], *out_k[1:]), flops), max_rel_err=max(errs.values()),
        device_ms_with_dwh=dms_dwh,
        per_step_us=dms[(99, 128)] / 99 * 1e3,
        device_ms_by_shape={f"T={T},B={B}": x for (T, B), x in dms.items()},
        registers={k: r["registers"] for k, r in info["build"].items() if k.startswith("bwd")},
        hmma={k: r.get("hmma") for k, r in info["build"].items() if k.startswith("bwd")},
        max_active_clusters=info["max_active_clusters"]["bwd"])


# K4's shapes (B, T_a, T_v, dv) at 4 heads, A = 128: the fast model's, the
# v2 model's (T_a = 197, no time reduction), the 16 s limits of the fast
# (T_a = 133) and the v2 model (T_a = 531) at T_v = 401 (the largest
# bucket's video frames, ``kernels.FUSION_MAX_TV``), and the (128, 64)
# instance (memory_value_dim = 256 over 4 heads) at the fast shape
K4_SHAPES = ((128, 50, 150, 128), (128, 197, 150, 128), (4, 133, 401, 128), (4, 531, 401, 128),
             (128, 50, 150, 64))


# the fast model's fusion at the train buckets: its audio halved twice
K4_BUCKET_SHAPES = tuple((B, -(-Ta // 4), Tv, 128) for B, _, Ta, Tv, _ in TRAIN_BUCKETS)
K4_SERVE_SHAPES = tuple((B, -(-Ta // 4), Tv, 128) for B, _, Ta, Tv, _ in SERVE_BUCKETS)


def k4_bounds(q, k, v, vlen, ctx, P, dctx, grads):
    """(forward, backward) bounds from the function's own bytes: the forward
    reads q, k, v and the lengths and writes ctx and P; the backward reads
    q, k, v, the lengths and dctx and writes dq, dk, dv, and forms the
    scores again (its input holds no weights): five products."""
    B, Ta, nh, A = q.shape
    Tv, dv = k.shape[1], v.shape[-1]
    pairs = B * nh * Ta * Tv
    return (bound(nbytes(q, k, v, vlen, ctx, P), 2 * pairs * (A + dv)),
            bound(nbytes(q, k, v, vlen, dctx, *grads), 2 * pairs * (3 * A + 2 * dv)))


def phase_k4(dev, report):
    import torch

    from avsr_tpu_torch.models import fusion as fus

    build = build_report("K4", "cross_attention", {
        f"attn_mma_stream_{kind}<{dk},{dv}>": (f"attn_mma_stream_{kind}ILi{dk}ELi{dv}E",
                                               "LengthMask")
        for dk, dv in ((128, 128), (128, 64)) for kind in ("fwd", "bwd_q", "bwd_kv")})
    errs, abs_errs, timed = {}, {}, {}
    for B, Ta, Tv, dv in K4_SHAPES + K4_BUCKET_SHAPES + K4_SERVE_SHAPES:
        q, k, v, vlen, dctx = k4_inputs(B, 4, Ta, Tv, 128, dev, seed=Ta + Tv + dv, dv=dv)
        ctx_k, w_k, st_k = fus.fusion_attention_fwd(q, k, v, vlen, save=True)
        ctx_k2, w_k2, st_k2 = fus.fusion_attention_fwd(q, k, v, vlen, save=True)
        ctx_serve, w_serve, none = fus.fusion_attention_fwd(q, k, v, vlen)
        ctx_p, w_p, st_p = fus.fusion_attention_fwd_plain(q, k, v, vlen, save=True)
        # the backward from the plain statistics: no [B, nh, T_a, T_v] tensor
        g_k, grew = requested_by(lambda: fus.fusion_attention_bwd(q, k, v, vlen, *st_p, dctx))
        g_k2 = fus.fusion_attention_bwd(q, k, v, vlen, *st_p, dctx)
        g_p = fus.fusion_attention_bwd_plain(q, k, v, vlen, *st_p, dctx)
        w_stats = fus.fusion_attention_weights(q, k, vlen, *st_k)
        torch.cuda.synchronize()
        same = (torch.equal(ctx_k, ctx_k2) and torch.equal(w_k, w_k2)
                and all(torch.equal(a, b) for a, b in zip(st_k, st_k2))
                and torch.equal(ctx_k, ctx_serve) and torch.equal(w_k, w_serve) and none is None
                and all(torch.equal(a, b) for a, b in zip(g_k, g_k2)))
        fwd = {"ctx": max_err(ctx_k, ctx_p), "P": max_err(w_k, w_p),
               "P_from_stats": max_err(w_stats, w_p), "row_max": max_err(st_k[0], st_p[0]),
               "row_sum_rel": rel_err(st_k[1], st_p[1])}
        rel = {n: rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), g_k, g_p)}
        # the length-0 row: the uniform softmax over exactly T_v keys
        uni = max_err(w_k[1], torch.full_like(w_k[1], 1.0 / Tv))
        scratch = nbytes(*g_k) + B * 4 * Ta * 4 + SLACK_BYTES
        print(f"K4 [B={B},4 heads,T_a={Ta},T_v={Tv},A=128,dv={dv}] forward max abs err {fwd} "
              f"(tol ctx {K4_CTX_TOL}, P {K4_P_TOL}); dq/dk/dv relative to max |plain| {rel} "
              f"(tol {K4_GRAD_REL_TOL}); length-0 row's weights against 1/T_v: {uni}; two "
              f"launches bit-equal (and the save-mode outputs the serving ones): {same}; the "
              f"backward allocated {grew} bytes (outputs and D: {scratch - SLACK_BYTES})")
        if not (torch.isfinite(ctx_k.float()).all() and all(torch.isfinite(g.float()).all()
                                                            for g in g_k)
                and fwd["ctx"] <= K4_CTX_TOL and fwd["P"] <= K4_P_TOL
                and fwd["P_from_stats"] <= K4_P_TOL and max(rel.values()) <= K4_GRAD_REL_TOL
                and uni <= K4_P_TOL and same):
            fail("K4", f"kernels disagree with the plain twins at B={B}, T_a={Ta}, T_v={Tv}, "
                       f"dv={dv}: {fwd} {rel}, length-0 row {uni}, bit-equal reruns {same}")
        if grew > scratch:
            fail("K4", f"the backward allocated {grew} bytes at B={B}, T_a={Ta}, T_v={Tv}: more "
                       f"than its outputs and D")
        errs[(B, Ta, Tv, dv)] = max(fwd["ctx"], fwd["P"])
        abs_errs[(B, Ta, Tv, dv)] = max(max_err(a, b) for a, b in zip(g_k, g_p))
        if (B, Tv, dv) == (128, 150, 128):  # the fast and the v2 model's shapes: times
            lib_mask = ((torch.arange(Tv, device=dev)[None, :] >= vlen[:, None]).float()
                        * -1e9).to(torch.bfloat16)[:, None, None, :]
            st = st_p
            t = timed[Ta] = {
                "fwd": time_ms(lambda: fus.fusion_attention_fwd(q, k, v, vlen)),
                "fwd_device": device_ms(lambda: fus.fusion_attention_fwd(q, k, v, vlen)),
                "fwd_save_device": device_ms(
                    lambda: fus.fusion_attention_fwd(q, k, v, vlen, save=True)),
                "fwd_plain": time_ms(lambda: fus.fusion_attention_fwd_plain(q, k, v, vlen)),
                "fwd_library": time_ms(lambda: sdpa(q, k, v, lib_mask)),
                "fwd_library_device": device_ms(lambda: sdpa(q, k, v, lib_mask)),
                "bwd": time_ms(lambda: fus.fusion_attention_bwd(q, k, v, vlen, *st, dctx)),
                "bwd_device": device_ms(lambda: fus.fusion_attention_bwd(q, k, v, vlen, *st,
                                                                         dctx)),
                "bwd_plain": time_ms(lambda: fus.fusion_attention_bwd_plain(q, k, v, vlen, *st,
                                                                            dctx)),
                "bwd_library_device": sdpa_bwd_device_ms(q, k, v, lib_mask, dctx),
            }
            t["bound_fwd"], t["bound_bwd"] = k4_bounds(q, k, v, vlen, ctx_k, w_k, dctx, g_k)
            print(f"K4 [B=128,4 heads,T_a={Ta},T_v=150,A=dv=128] fwd kernel {t['fwd']:.4f} ms "
                  f"(device {t['fwd_device']:.4f} ms; save mode {t['fwd_save_device']:.4f})  "
                  f"plain {t['fwd_plain']:.4f} ms  library (scaled_dot_product_attention, same "
                  f"mask) {t['fwd_library']:.4f} ms (device {t['fwd_library_device']:.4f} ms)  "
                  f"bound {t['bound_fwd'][0]:.5f} ms ({t['bound_fwd'][1]}); bwd kernel "
                  f"{t['bwd']:.4f} ms (device {t['bwd_device']:.4f} ms)  plain "
                  f"{t['bwd_plain']:.4f} ms  library (its backward, device) "
                  f"{t['bwd_library_device']:.4f} ms  bound {t['bound_bwd'][0]:.5f} ms "
                  f"({t['bound_bwd'][1]})")
    fast, v2 = timed[50], timed[197]
    report["fusion_attention_fwd"] = dict(
        max_abs_err=max(errs.values()), ms=fast["fwd"], plain_ms=fast["fwd_plain"],
        library_ms=fast["fwd_library"], device_ms=fast["fwd_device"], bound=fast["bound_fwd"],
        library_device_ms=fast["fwd_library_device"], save_device_ms=fast["fwd_save_device"],
        v2_device_ms=v2["fwd_device"], v2_library_device_ms=v2["fwd_library_device"],
        v2_bound_ms=v2["bound_fwd"][0],
        registers={kind: r["registers"] for kind, r in build.items() if "fwd" in kind},
        hmma={kind: r.get("hmma") for kind, r in build.items() if "fwd" in kind})
    report["fusion_attention_bwd"] = dict(
        max_abs_err=max(abs_errs.values()), ms=fast["bwd"], plain_ms=fast["bwd_plain"],
        library_ms=fast["bwd_library_device"], device_ms=fast["bwd_device"],
        bound=fast["bound_bwd"], v2_device_ms=v2["bwd_device"],
        v2_library_device_ms=v2["bwd_library_device"], v2_bound_ms=v2["bound_bwd"][0],
        registers={kind: r["registers"] for kind, r in build.items() if "bwd" in kind},
        hmma={kind: r.get("hmma") for kind, r in build.items() if "bwd" in kind})


def scaled(params, eps=SPREAD_EPS):
    """A copy of the parameter tree with every leaf times (1 + eps), leaves
    that want a gradient as the originals."""
    import torch

    from avsr_tpu_torch.utils.params import tree_map

    with torch.no_grad():
        return tree_map(lambda t: (t * (1 + eps)).requires_grad_(t.requires_grad), params)


def phase_train(dev, card, cfg, label="train", needed=TRAIN_KERNELS, lr=1e-4, shares=(),
                spread=False, steps=10, loss_tol=LOSS_REL_TOL, leaf_tol=GRAD_LEAF_REL_TOL):
    """The full-width train step of ``cfg``'s model; ``needed`` kernels
    must launch during its ``steps`` steps, which run at the constant ``lr``;
    ``shares`` as ``profile_report``'s.  The kernel path's loss and every
    gradient leaf (the worst and the median) are held against the plain
    path's within ``loss_tol`` and ``leaf_tol``.  With ``spread`` the kernel
    path is held against the plain path within ``SPREAD_FACTOR`` times the
    plain path's own spread under ``scaled`` parameters, and every K13 call
    of its loss and gradients by ``hold_k13_calls``."""
    import dataclasses

    import torch

    from avsr_tpu_torch.configs import NoiseConfig
    from avsr_tpu_torch.data.units import builtin_unit_dict
    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.train import step as tstep
    from avsr_tpu_torch.utils import rng as trng
    from avsr_tpu_torch.utils.params import tree_leaves

    cfg = cfg.replace(noise=NoiseConfig(enabled=True))
    V = builtin_unit_dict(cfg.data.unit).vocab_size
    batch, frames_per_step = train_batch(cfg, V, dev)
    bank = noise_bank(cfg, dev)
    state, _ = tstep.create_train_state(cfg, V, torch.Generator().manual_seed(0), dev)
    names = ["/".join(map(str, p)) for p, _ in tree_leaves(state.params)]

    # (a) agreement with the plain path, same draws.  Scheduled sampling is
    # off here: the paths' logits differ in bf16 ulps, and a near-tied
    # sample would feed them different tokens.
    cfg_a = cfg.replace(decoder=dataclasses.replace(cfg.decoder, sampling_probability=0.0))
    with k13_calls() if spread else contextlib.nullcontext() as calls:
        m_k, g_k = tstep.loss_and_grads(state.params, batch, cfg=cfg_a,
                                        generator=trng.generator_for(7, dev), noise_bank=bank)
    if spread:
        hold_k13_calls(f"{label} (a)", calls)
        del calls
    before = dict(kernels.LAUNCHES)
    with plain_cores():
        m_p, g_p = tstep.loss_and_grads(state.params, batch, cfg=cfg_a,
                                        generator=trng.generator_for(7, dev), noise_bank=bank)
    torch.cuda.synchronize()
    if kernels.LAUNCHES != before:
        fail(label, "the plain reference run launched a kernel")
    for n, g in zip(names, g_k):
        if g is None:
            fail(label, f"no gradient reaches {n} on the kernel path")
        if not torch.isfinite(g).all() or not bool((g != 0).any()):
            fail(label, f"gradient of {n} is non-finite or all zero on the kernel path")
    loss_rel = abs(float(m_k["loss"]) - float(m_p["loss"])) / abs(float(m_p["loss"]))
    rels = {n: float((a - b).norm() / b.norm()) for n, a, b in zip(names, g_k, g_p)}
    worst = max(rels, key=rels.get)
    median_tol = leaf_tol
    if spread:
        with plain_cores():
            m_s, g_s = tstep.loss_and_grads(scaled(state.params), batch, cfg=cfg_a,
                                            generator=trng.generator_for(7, dev),
                                            noise_bank=bank)
        spread_loss = abs(float(m_s["loss"]) - float(m_p["loss"])) / abs(float(m_p["loss"]))
        spread_rels = [float((a - b).norm() / b.norm()) for a, b in zip(g_s, g_p)]
        loss_tol = max(LOSS_REL_TOL, SPREAD_FACTOR * spread_loss)
        leaf_tol = float("inf")  # a single leaf's spread is itself noise: the median decides
        median_tol = max(GRAD_LEAF_REL_TOL, SPREAD_FACTOR * statistics.median(spread_rels))
        print(f"{label} (a) the plain path's own spread at parameters times (1 + "
              f"{SPREAD_EPS}): loss rel {spread_loss:.3e}, gradient leaves worst "
              f"{max(spread_rels):.3e} median {statistics.median(spread_rels):.3e}")
    print(f"{label} (a) loss kernel {float(m_k['loss']):.6f} plain {float(m_p['loss']):.6f} "
          f"(rel diff {loss_rel:.3e}, tol {loss_tol:.3e}); {len(names)} gradient leaves, "
          f"all present, finite, nonzero; worst leaf rel err {rels[worst]:.3e} ({worst}, tol "
          f"{leaf_tol:.3e}), median {statistics.median(rels.values()):.3e} (tol "
          f"{median_tol:.3e})")
    if not (loss_rel <= loss_tol and rels[worst] <= leaf_tol
            and statistics.median(rels.values()) <= median_tol):
        fail(label, "kernel path disagrees with the plain path")

    # (b)-(d): ``steps`` steps on the batch at a constant lr, launches counted.  The
    # presets warm up to 1e-3 over 400 steps; a constant 1e-3 from random
    # weights overshoots (Adam's first steps move every weight by ~lr), so
    # the check runs at a tenth of the peak, or lower where the model needs
    # it.
    cfg_c = cfg.replace(train=dataclasses.replace(cfg.train, lr_schedule="constant",
                                                  learning_rate=lr))
    state, opt = tstep.create_train_state(cfg_c, V, torch.Generator().manual_seed(0), dev)
    gen = torch.Generator().manual_seed(11)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses, parts, times = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = tstep.train_step(state, batch, cfg=cfg_c, optimizer=opt,
                                          generator=gen, noise_bank=bank)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        parts.append((float(metrics["ce_loss"]), float(metrics.get("au_loss", float("nan")))))
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"{label} (b) launches over {steps} steps at scheduled-sampling p "
          f"{tstep.host_sampling_p(cfg_c, 0)} {launches}")
    for name in needed:
        if launches[name] == 0:
            fail(label, f"kernel {name} was not launched by the training steps")
    check_other_route(label, launches)
    print(f"{label} (c) losses {[round(x, 4) for x in losses]} (ce, au) "
          f"{[(round(c, 4), round(a, 4)) for c, a in parts]}; grad_norm last "
          f"{float(metrics['grad_norm']):.4f}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(label, f"the loss did not fall over {steps} steps")
    step_ms = statistics.median(times[2:])

    def three_steps():
        st = state
        for _ in range(3):
            st, _ = tstep.train_step(st, batch, cfg=cfg_c, optimizer=opt, generator=gen,
                                     noise_bank=bank)

    profile_report(f"{label} (B=128, 3 steps)", three_steps, per=3, per_name="step",
                   shares=shares)
    print(f"{label} (d) [{card}] {cfg.name} B=128 6 s: ms/step {[round(x, 3) for x in times]} "
          f"median after 2 warm-up {step_ms:.3f}; {frames_per_step / step_ms * 1e3:.0f} "
          f"10 ms audio frames/s; peak memory {peak / 2**30:.3f} GiB")
    return launches


def k5_inputs(B, Q, S, dk, dv, dev, causal, seed, nh=4):
    """q, k, v, the key bias (None: causal) and a context cotangent; the
    bias masks a ragged tail of each row and every key of row 1."""
    import torch

    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, Q, nh, dk), generator=g).to(torch.bfloat16)
    k = torch.randn((B, S, nh, dk), generator=g).to(torch.bfloat16)
    v = torch.randn((B, S, nh, dv), generator=g).to(torch.bfloat16)
    dctx = torch.randn((B, Q, nh, dv), generator=g).to(torch.bfloat16)
    bias = None
    if not causal:
        lens = torch.randint(1, S + 1, (B,), generator=g)
        lens[0], lens[1] = S, 0  # row 1: a memory of length 0
        bias = (1.0 - (torch.arange(S)[None, :] < lens[:, None]).float()) * -1e30
    return [None if x is None else x.to(dev) for x in (q, k, v, bias, dctx)]


# K5's shapes, (label, B, Q, S, dk, dv, causal): lrs2_av_fast's self and
# cross pair (memory S = 50), lrs2_av_v2's cross (S = 197, every audio
# step), the self attention at the 150-label horizon and the cross
# attention at v2's 16 s limit (S = 531) with 80 and 150 labels; then the
# cross attention past its own kernels' lengths, on the streamed tiles
# (``kernels.decoder_cross_route``): 200 labels (the backward) and a
# memory of 6000 steps (the forward)
K5_SHAPES = (("fast self", 128, 80, 80, 64, 64, True), ("fast cross", 128, 80, 50, 128, 256, False),
             ("v2 cross", 128, 80, 197, 128, 256, False), ("self Q=150", 128, 150, 150, 64, 64, True),
             ("16 s cross", 4, 80, 531, 128, 256, False),
             ("16 s cross Q=150", 4, 150, 531, 128, 256, False),
             ("cross Q=200", 8, 200, 197, 128, 256, False),
             ("cross S=6000", 2, 80, 6000, 128, 256, False))


def k5_cross_layout_check():
    """The wrapper's mirror of the cross kernels' layouts
    (``kernels.decoder_cross_fwd_strips`` / ``decoder_cross_fwd_smem`` /
    ``DECODER_CROSS_MAX_Q``, which ``decoder_cross_route`` reads) against
    the library's own (``FwdLayout``, ``fwd_config``, ``BwdLayout``) over a
    grid of lengths: a drift would send a shape to a kernel that refuses it."""
    from avsr_tpu_torch import kernels

    lib = kernels._load()
    bad = []
    for Q in (1, 16, 37, 80, 150, 160, 161, 200, 400):
        for S in (1, 50, 197, 531, 900, 4000, 5376, 5377, 6000):
            got, want = lib.avsr_decoder_cross_fwd_strips(Q, S), kernels.decoder_cross_fwd_strips(Q, S)
            if got != want:
                bad.append(f"fwd strips Q={Q} S={S}: library {got}, mirror {want}")
    for ns in range(1, 6):
        for S in (1, 50, 197, 531, 4000, 5376):
            for slots in range(3, 9):
                got = lib.avsr_decoder_cross_fwd_smem(ns, S, slots)
                want = kernels.decoder_cross_fwd_smem(ns, S, slots)
                if got != want:
                    bad.append(f"fwd smem ns={ns} S={S} slots={slots}: library {got}, mirror {want}")
    for ns in range(1, 13):
        got = lib.avsr_decoder_cross_bwd_smem(ns) >= 0
        if got != (16 * ns <= kernels.DECODER_CROSS_MAX_Q):
            bad.append(f"bwd at {16 * ns} queries: library takes it {got}, "
                       f"DECODER_CROSS_MAX_Q {kernels.DECODER_CROSS_MAX_Q}")
    print(f"K5 cross layouts: the wrapper's mirror against the library's, "
          f"{'agree' if not bad else bad}")
    if bad:
        fail("K5", f"the cross kernels' layouts drift from kernels' mirror: {bad}")


def k5_bounds(q, k, v, bias, ctx, stats, dctx, grads):
    """(forward, backward) bounds from the function's own bytes: the forward
    reads q, k, v and the bias and writes ctx and the row statistics; the
    backward reads q, k, v, the bias, the statistics and dctx and writes dq,
    dk, dv, and forms the scores again (its input holds no weights): five
    products."""
    B, Q, nh, dk = q.shape
    S, dv = k.shape[1], v.shape[-1]
    pairs = B * nh * Q * S
    return (bound(nbytes(q, k, v, bias, ctx, *stats), 2 * pairs * (dk + dv)),
            bound(nbytes(q, k, v, bias, *stats, dctx, *grads), 2 * pairs * (3 * dk + 2 * dv)))


# the fast decoder's self and cross pair at the train buckets (Q the label
# cap, S the fused memory: the audio halved twice); bucket 2's are "fast
# self" and "fast cross"
K5_BUCKET_SHAPES = tuple(
    x for B, _, Ta, _, L in TRAIN_BUCKETS if L != 80
    for x in ((f"bucket self Q={L}", B, L, L, 64, 64, True),
              (f"bucket cross Q={L}", B, L, -(-Ta // 4), 128, 256, False)))


def phase_k5(dev, report):
    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.models import transformer_decoder as tdec

    build = build_report("K5", "decoder_attention", {
        **{f"self {kind}<64>": (f"attn_mma_{kind}ILi64E", "CausalMask")
           for kind in ("fwd", "bwd_q", "bwd_kv")},
        **{f"cross {kind}<128,256>": (f"xattn_{kind}",) for kind in ("fwd", "bwd")},
        **{f"cross stream {kind}<128,256>": (f"attn_mma_stream_{kind}ILi128ELi256E", "BiasMask")
           for kind in ("fwd", "bwd_q", "bwd_kv")}})
    k5_cross_layout_check()
    fwd_err, bwd_err, timed = {}, {}, {}
    for name, B, Q, S, dk, dv, causal in K5_SHAPES + K5_BUCKET_SHAPES:
        routes = ("causal", "causal") if causal else tuple(
            kernels.decoder_cross_route(Q, S, backward=d) for d in (False, True))
        q, k, v, bias, dctx = k5_inputs(B, Q, S, dk, dv, dev, causal, seed=Q + S + dv)
        ctx_k, st_k = tdec.decoder_attention_fwd(q, k, v, bias, save=True)
        ctx_k2, st_k2 = tdec.decoder_attention_fwd(q, k, v, bias, save=True)
        ctx_serve, none = tdec.decoder_attention_fwd(q, k, v, bias)
        ctx_p, st_p = tdec.decoder_attention_fwd_plain(q, k, v, bias, save=True)
        # the backward from the plain statistics: no [B, nh, Q, S] tensor
        g_k, grew = requested_by(lambda: tdec.decoder_attention_bwd(q, k, v, bias, *st_p, dctx))
        g_k2 = tdec.decoder_attention_bwd(q, k, v, bias, *st_p, dctx)
        g_p = tdec.decoder_attention_bwd_plain(q, k, v, bias, *st_p, dctx)
        w_p = tdec.decoder_attention_weights(q, k, bias, *st_p)
        w_k = tdec.decoder_attention_weights(q, k, bias, *st_k)
        torch.cuda.synchronize()
        same = (torch.equal(ctx_k, ctx_k2) and torch.equal(ctx_k, ctx_serve) and none is None
                and all(torch.equal(a, b) for a, b in zip(st_k, st_k2))
                and all(torch.equal(a, b) for a, b in zip(g_k, g_k2)))
        fwd = {"ctx": max_err(ctx_k, ctx_p), "P_from_stats": max_err(w_k, w_p),
               "row_max": max_err(st_k[0], st_p[0]), "row_sum_rel": rel_err(st_k[1], st_p[1])}
        rel = {n: rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), g_k, g_p)}
        # the outputs, and D (fp32 [B, nh, Q]) but on the cross kernels'
        # resident route, which keeps it in shared memory
        with_d = routes[1] != "resident"
        scratch = nbytes(*g_k) + (B * 4 * Q * 4 if with_d else 0) + SLACK_BYTES
        extra = ""
        if not causal:  # the length-0 memory: the uniform softmax over exactly S keys
            uni = max_err(w_k[1], torch.full_like(w_k[1], 1.0 / S))
            extra = f"; length-0 memory row's weights against 1/S: {uni}"
            if uni > 1e-6:
                fail("K5", f"{name}: the fully masked row is not uniform ({uni})")
        print(f"K5 {name} [B={B},Q={Q},S={S},4 heads,dk={dk},dv={dv}; routes fwd/bwd "
              f"{routes[0]}/{routes[1]}] forward max abs err {fwd} "
              f"(tol ctx {K5_CTX_TOL}, P {K5_P_TOL}); dq/dk/dv relative to max |plain| {rel} "
              f"(tol {K5_GRAD_REL_TOL}){extra}; two launches bit-equal (and the save-mode ctx "
              f"the serving one): {same}; the backward allocated {grew} bytes (outputs"
              f"{' and D' if with_d else ''}: {scratch - SLACK_BYTES})")
        if not (torch.isfinite(ctx_k.float()).all()
                and all(torch.isfinite(g.float()).all() for g in g_k)
                and fwd["ctx"] <= K5_CTX_TOL and fwd["P_from_stats"] <= K5_P_TOL
                and max(rel.values()) <= K5_GRAD_REL_TOL and same):
            fail("K5", f"kernels disagree with the plain twins at {name}: {fwd} {rel}, "
                       f"bit-equal reruns {same}")
        if grew > scratch:
            fail("K5", f"the backward allocated {grew} bytes at {name}: more than its outputs "
                       f"{'and D' if with_d else '(no scratch)'}")
        fwd_err[name] = max(fwd["ctx"], fwd["P_from_stats"])
        bwd_err[name] = max(max_err(a, b) for a, b in zip(g_k, g_p))
        if name in ("fast self", "fast cross", "v2 cross"):
            mask = (torch.triu(torch.full((Q, S), -1e9, device=dev), diagonal=1) if causal
                    else bias[:, None, None, :]).to(torch.bfloat16)
            st = st_p
            t = timed[name] = {
                "fwd": time_ms(lambda: tdec.decoder_attention_fwd(q, k, v, bias, save=True)),
                "fwd_device": device_ms(
                    lambda: tdec.decoder_attention_fwd(q, k, v, bias, save=True)),
                "fwd_plain": time_ms(lambda: tdec.decoder_attention_fwd_plain(q, k, v, bias)),
                "fwd_library": time_ms(lambda: sdpa(q, k, v, mask)),
                "fwd_library_device": device_ms(lambda: sdpa(q, k, v, mask)),
                "bwd": time_ms(lambda: tdec.decoder_attention_bwd(q, k, v, bias, *st, dctx)),
                "bwd_device": device_ms(
                    lambda: tdec.decoder_attention_bwd(q, k, v, bias, *st, dctx)),
                "bwd_plain": time_ms(
                    lambda: tdec.decoder_attention_bwd_plain(q, k, v, bias, *st, dctx)),
                "bwd_library_device": sdpa_bwd_device_ms(q, k, v, mask, dctx),
            }
            t["bound_fwd"], t["bound_bwd"] = k5_bounds(q, k, v, bias, ctx_k, st_k, dctx, g_k)
            print(f"K5 {name} fwd kernel {t['fwd']:.4f} ms (device {t['fwd_device']:.4f})  plain "
                  f"{t['fwd_plain']:.4f}  library (scaled_dot_product_attention, same mask) "
                  f"{t['fwd_library']:.4f} (device {t['fwd_library_device']:.4f})  bound "
                  f"{t['bound_fwd'][0]:.5f} ({t['bound_fwd'][1]}); bwd kernel {t['bwd']:.4f} ms "
                  f"(device {t['bwd_device']:.4f})  plain {t['bwd_plain']:.4f}  library (its "
                  f"backward, device) {t['bwd_library_device']:.4f}  bound "
                  f"{t['bound_bwd'][0]:.5f} ({t['bound_bwd'][1]})")
    phase_k5_v2_16s(dev)

    # one decoder layer runs the self and the cross instance: the entries
    # time the fast model's pair, and carry v2's cross instance apart
    def pair(key):
        return timed["fast self"][key] + timed["fast cross"][key]

    def pair_bound(key):
        b = [timed[n][key] for n in ("fast self", "fast cross")]
        return (b[0][0] + b[1][0], b[0][1] if b[0][1] == b[1][1] else "bytes+operations")

    v2 = timed["v2 cross"]
    for d in ("fwd", "bwd"):
        report[f"decoder_attention_{d}"] = dict(
            max_abs_err=max((fwd_err if d == "fwd" else bwd_err).values()), ms=pair(d),
            plain_ms=pair(f"{d}_plain"),
            library_ms=pair(f"{d}_library_device" if d == "bwd" else f"{d}_library"),
            device_ms=pair(f"{d}_device"), bound=pair_bound(f"bound_{d}"),
            library_device_ms=pair(f"{d}_library_device"),
            self_device_ms=timed["fast self"][f"{d}_device"],
            self_library_device_ms=timed["fast self"][f"{d}_library_device"],
            self_bound_ms=timed["fast self"][f"bound_{d}"][0],
            cross_device_ms=timed["fast cross"][f"{d}_device"],
            cross_library_device_ms=timed["fast cross"][f"{d}_library_device"],
            cross_bound_ms=timed["fast cross"][f"bound_{d}"][0],
            v2_cross_device_ms=v2[f"{d}_device"], v2_cross_library_device_ms=v2[f"{d}_library_device"],
            v2_cross_bound_ms=v2[f"bound_{d}"][0],
            registers={kind: r["registers"] for kind, r in build.items() if d in kind},
            hmma={kind: r.get("hmma") for kind, r in build.items() if d in kind})


def phase_k5_v2_16s(dev):
    """A short lrs2_av_v2 train step on the card at B=4 with one 16 s
    utterance (its memory S = 531 steps, where K5's cross attention once
    raised): the loss finite, every gradient leaf present and finite, K5's
    forward and backward launched."""
    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.configs import lrs2_av_v2
    from avsr_tpu_torch.data.units import builtin_unit_dict
    from avsr_tpu_torch.train import step as tstep
    from avsr_tpu_torch.utils import rng as trng
    from avsr_tpu_torch.utils.params import tree_leaves

    cfg = lrs2_av_v2()
    V = builtin_unit_dict(cfg.data.unit).vocab_size
    batch, _ = train_batch(cfg, V, dev, B=4, seconds=16.0, label_cap=80, seed=16)
    audio_len = batch.audio_lengths.clone()
    audio_len[0] = batch.audio.shape[1]  # one utterance of the full 16 s
    batch = batch._replace(audio_lengths=audio_len)
    state, _ = tstep.create_train_state(cfg, V, torch.Generator().manual_seed(0), dev)
    names = ["/".join(map(str, p)) for p, _ in tree_leaves(state.params)]
    before = dict(kernels.LAUNCHES)
    metrics, grads = tstep.loss_and_grads(state.params, batch, cfg=cfg,
                                          generator=trng.generator_for(16, dev))
    torch.cuda.synchronize()
    ran = {n: kernels.LAUNCHES[n] - before[n] for n in ("decoder_attention_fwd",
                                                         "decoder_attention_bwd")}
    missing = [n for n, g in zip(names, grads) if g is None or not torch.isfinite(g).all()]
    print(f"K5 v2 train step [B=4, one 16 s utterance, audio lengths "
          f"{audio_len.tolist()}]: loss {float(metrics['loss']):.6f}; {len(names)} gradient "
          f"leaves, missing or non-finite: {missing}; K5 launches {ran}")
    if not (np.isfinite(float(metrics["loss"])) and not missing and all(ran.values())):
        fail("K5", "the v2 train step with a 16 s utterance failed")


def k6_inputs(N, B, L, dk, dv, dev, cross, seed, nh=4):
    """q [N, nh, dk] against B key rows [L, nh, dk] and values [L, nh, dv]
    (self: B = N, a cache row per query row; cross: an untiled memory read
    by W = N / B beams a row), cross mode's bias [B, L] ragged with row 1
    of length 0."""
    import torch

    g = torch.Generator().manual_seed(seed)
    q = torch.randn((N, nh, dk), generator=g).to(torch.bfloat16)
    k = torch.randn((B, L, nh, dk), generator=g).to(torch.bfloat16)
    v = torch.randn((B, L, nh, dv), generator=g).to(torch.bfloat16)
    bias = None
    if cross:
        lens = torch.randint(1, L + 1, (B,), generator=g)
        lens[0], lens[min(1, B - 1)] = L, 0  # row 1: a memory of length 0
        bias = (1.0 - (torch.arange(L)[None, :] < lens[:, None]).float()) * -1e30
    return [None if x is None else x.to(dev) for x in (q, k, v, bias)]


# K6's shapes: a serve request's beam step (N = 80 rows, B = 8 utterances
# of W = 10 beams) and a greedy step (N = 128 rows of one beam); the self
# read over the 150-step cache at positions 0, 37, 149; the cross read over
# the fast and the v2 model's memories (S = 50, 197) and v2's 16 s limit
# (S = 531); off the main path, the self read at 4 heads of 32 (the
# general kernel) and the cross read at (dk, dv) = (64, 96) with 3 beams
K6_ROWS = ((80, 8), (128, 128))
K6_POS = (0, 37, 149)
K6_MEMORIES = (50, 197, 531)
# the eval of phase 47 at the train buckets its 1.6-6 s utterances fill (B
# = 128): greedy (N = B) and the width-10 beam (N = 10 B) over the fast
# memories (the audio halved twice), the beam's self read over its cache
K6_BUCKET_CROSS = tuple(sorted({(N, B, -(-Ta // 4)) for B, _, Ta, _, _ in TRAIN_BUCKETS[:3]
                                for N in (B, 10 * B)} - {(128, 128, 50)}))
K6_BUCKET_SELF = (1280,)
# the fast artifacts' width-10 beam (N = 80 over B = 8) over each serving
# bucket's memory
K6_SERVE_CROSS = tuple((10 * B, B, -(-Ta // 4)) for B, _, Ta, _, _ in SERVE_BUCKETS
                       if -(-Ta // 4) not in K6_MEMORIES)


def k6_pair_bytes(N, B, pos, S, dk=128, dv=256, dh=64, nh=4):
    """The bytes one decode step's pair (self at pos, cross over S) must
    move at N query rows over B memory rows: the cache's keys and values
    0..pos, the queries, the memory's keys, values and bias read once, the
    contexts written once."""
    self_nb = (pos + 1) * N * nh * dh * 2 * 2 + 2 * N * nh * dh * 2
    cross_nb = B * S * nh * (dk + dv) * 2 + B * S * 4 + N * nh * (dk + dv) * 2
    return self_nb + cross_nb


def phase_k6(dev, report):
    """K6 against its plain version in self mode over the 150-step cache and
    in cross mode over the untiled fast, v2 and 16 s memories, each with a
    length-0 row, at a beam step (N = 80, W = 10) and a greedy step (N =
    128, W = 1), and off the main path; two launches bit-equal; times one
    decode step's pair at both memories and greedy's pair."""
    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.models import transformer_decoder as tdec

    def check(label, q, k, v, bias, n_keys, W=1):
        route = kernels.decode_attention_route(q.shape[0], k.shape[0], k.shape[1], n_keys,
                                               q.shape[1], q.shape[2], v.shape[-1],
                                               bias is not None)
        out_k = tdec.decode_attention(q, k, v, bias, n_keys)
        same = torch.equal(out_k, tdec.decode_attention(q, k, v, bias, n_keys))
        err = max_err(out_k, tdec.decode_attention_plain(q, k, v, bias, n_keys))
        uni = 0.0
        if bias is not None:  # memory row 1 is empty: its beams read the mean of its values
            mean = v[1].float().mean(dim=0).to(torch.bfloat16)
            uni = max_err(out_k[W:2 * W], mean[None].expand(W, -1, -1))
        print(f"K6 {label} ({route}) max abs err {err} (tol {K6_TOL}); length-0 row against "
              f"the plain mean of its values: {uni}; two launches bit-equal: {same}")
        if not (err <= K6_TOL and uni <= K6_TOL and same):
            fail("K6", f"{label} disagrees: {err}, length-0 row {uni}, bit-equal {same}")
        return err

    # the routes' shared-memory mirrors against the library's layouts
    lib = kernels._load()
    bad = [(n, nh) for n in (1, 31, 32, 150, 207) for nh in (1, 4, 8)
           if lib.avsr_decode_rows_smem(n, nh) != kernels.decode_rows_smem(n, nh)]
    bad += [(W, S, dk, dvs) for W in (1, 10, 17) for S in (1, 50, 197, 531)
            for dk, dvs in ((128, 64), (128, 16), (64, 96), (16, 16))
            if lib.avsr_decode_grouped_smem(W, S, dk, dvs)
            != kernels.decode_grouped_smem(W, S, dk, dvs)]
    if bad:
        fail("K6", f"the routes' shared memory differs from the library's at {bad}")
    worst = 0.0
    for N, B in K6_ROWS:
        W = N // B
        for pos in K6_POS:
            q, k, v, _ = k6_inputs(N, N, 150, 64, 64, dev, False, seed=N + pos)
            worst = max(worst, check(f"self [N={N},L=150,pos={pos},4x64]", q, k, v, None,
                                     pos + 1))
        for S in K6_MEMORIES:
            q, k, v, bias = k6_inputs(N, B, S, 128, 256, dev, True, seed=N + S)
            worst = max(worst, check(f"cross [N={N},B={B},W={W},S={S},dk=128,dv=256]",
                                     q, k, v, bias, S, W))
    for N in K6_BUCKET_SELF:
        for pos in K6_POS:
            q, k, v, _ = k6_inputs(N, N, 150, 64, 64, dev, False, seed=N + pos)
            worst = max(worst, check(f"self, train bucket eval [N={N},L=150,pos={pos},4x64]",
                                     q, k, v, None, pos + 1))
    for tag, shapes in (("train bucket eval", K6_BUCKET_CROSS), ("serving bucket",
                                                                 K6_SERVE_CROSS)):
        for N, B, S in shapes:
            q, k, v, bias = k6_inputs(N, B, S, 128, 256, dev, True, seed=N + S)
            worst = max(worst, check(f"cross, {tag} [N={N},B={B},W={N // B},S={S},dk=128,"
                                     f"dv=256]", q, k, v, bias, S, N // B))
    q, k, v, _ = k6_inputs(16, 16, 40, 32, 32, dev, False, seed=5)
    check("self off the main path [N=16,L=40,pos=19,4x32]", q, k, v, None, 20)
    q, k, v, bias = k6_inputs(30, 10, 40, 64, 96, dev, True, seed=6)
    check("cross off the main path [N=30,B=10,W=3,S=40,dk=64,dv=96]", q, k, v, bias, 40, 3)

    # one decode step's pair at the serve shape (N = 80 beams of B = 8
    # utterances; self at the last position, cross over the fast and the v2
    # memory) and at greedy's (N = 128 rows of one beam)
    pos = 149
    pairs = {}
    for N, B in K6_ROWS:
        W = N // B
        qs, ks, vs, _ = k6_inputs(N, N, 150, 64, 64, dev, False, seed=1)
        self_mask = torch.zeros((N, 1, 1, 150), device=dev)
        self_mask[..., pos + 1:] = -1e9
        self_mask = self_mask.to(torch.bfloat16)
        self_t = (time_ms(lambda: tdec.decode_attention(qs, ks, vs, None, pos + 1)),
                  time_ms(lambda: tdec.decode_attention_plain(qs, ks, vs, None, pos + 1)),
                  time_ms(lambda: sdpa(qs[:, None], ks, vs, self_mask)),
                  device_ms(lambda: tdec.decode_attention(qs, ks, vs, None, pos + 1)))
        for S in (50, 197):
            qc, kc, vc, bc = k6_inputs(N, B, S, 128, 256, dev, True, seed=2)
            # the library call reads the untiled memory too: W queries a row
            cross_mask = bc[:, None, None, :].to(torch.bfloat16)
            qw = qc.view(B, W, 4, 128)
            cross_t = (time_ms(lambda: tdec.decode_attention(qc, kc, vc, bc, S)),
                       time_ms(lambda: tdec.decode_attention_plain(qc, kc, vc, bc, S)),
                       time_ms(lambda: sdpa(qw, kc, vc, cross_mask)),
                       device_ms(lambda: tdec.decode_attention(qc, kc, vc, bc, S)))
            tk, tp, tl, td = cross_t
            fl = 2 * N * 4 * ((pos + 1) * 128 + S * 384)
            pairs[(N, S)] = dict(
                ms=self_t[0] + tk, plain_ms=self_t[1] + tp, library_ms=self_t[2] + tl,
                device_ms=self_t[3] + td, self_device_ms=self_t[3], cross_device_ms=td,
                bound=bound(k6_pair_bytes(N, B, pos, S), fl),
                # the beam-tiled read's bytes, the yardstick of earlier PRs
                bound_tiled=bound(k6_pair_bytes(N, N, pos, S), fl))
            r = pairs[(N, S)]
            print(f"K6 pair at N={N} (W={W}), pos {pos}, cross over S={S}: kernel {r['ms']:.4f} ms "
                  f"(device {r['device_ms']:.4f}: self {self_t[3]:.4f} + cross {td:.4f})  plain "
                  f"{r['plain_ms']:.4f} ms  library {r['library_ms']:.4f} ms  bound "
                  f"{r['bound'][0]:.5f} ms ({r['bound'][1]}; beam-tiled memory "
                  f"{r['bound_tiled'][0]:.5f})")

    def entry(key, shape):
        r = pairs[key]
        return {"shape": shape, "ms": r["ms"], "plain_ms": r["plain_ms"],
                "library_ms": r["library_ms"], "device_ms": r["device_ms"],
                "self_device_ms": r["self_device_ms"], "cross_device_ms": r["cross_device_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "bound_tiled_ms": r["bound_tiled"][0]}

    fast = pairs[(80, 50)]
    report["decode_attention"] = dict(
        max_abs_err=worst, ms=fast["ms"], plain_ms=fast["plain_ms"],
        library_ms=fast["library_ms"], device_ms=fast["device_ms"], bound=fast["bound"],
        bound_tiled_ms=fast["bound_tiled"][0],
        at_v2_memory=entry((80, 197), "one step's pair at N=80 (B=8, W=10), cross over S=197"),
        greedy=entry((128, 50), "greedy's pair at N=128 (W=1), cross over S=50"),
        greedy_v2=entry((128, 197), "greedy's pair at N=128 (W=1), cross over S=197"))


def k7_inputs(B, W, V, dev, seed, ties=False, p_finished=0.3):
    import torch

    g = torch.Generator().manual_seed(seed)
    if ties:  # every beam the same uniform row and score: W (V - 2) exact ties
        logits = torch.zeros((B * W, V))
        logp = torch.zeros((B, W))
        finished = torch.zeros((B, W), dtype=torch.bool)
    else:
        logits = 3.0 * torch.randn((B * W, V), generator=g)
        logp = -20.0 * torch.rand((B, W), generator=g)
        logp[0, 3:] = -1e30  # dead beams, as after the first step
        finished = torch.rand((B, W), generator=g) < p_finished
    lens = torch.randint(0, 60, (B, W), generator=g, dtype=torch.int32)
    if ties:
        lens.zero_()  # one length penalty for every candidate
    return [x.to(dev) for x in (logits, logp, lens, finished)]


def run_beam_step(fn, args, lp_table, dev):
    """(token row, parent row, the new carry's StepOut) of one call of
    ``fn`` (``beam.beam_step`` or ``beam.beam_step_plain``)."""
    import torch

    from avsr_tpu_torch.decode import beam

    B, W = args[1].shape
    tok = torch.full((B, W), -1, dtype=torch.int64, device=dev)
    par = torch.full((B, W), -1, dtype=torch.int64, device=dev)
    out = fn(*args, lp_table, tok, par, beam.step_buffers(B, W, dev))
    return (tok, par) + tuple(out)


# K7's (B, W, V): a serve request's beam step (the presets' vocabulary of
# 44, and 31), a B = 128 batch, one utterance, one beam, 32 beams, and the
# largest W * V the wrapper takes at one beam and at ten (6128 = (48 KB -
# 128) / 8); the level-1 route of each is printed
K7_SHAPES = ((8, 10, 44), (8, 10, 31), (128, 10, 44), (1, 10, 44), (8, 1, 44), (8, 32, 44),
             (8, 1, 6128), (8, 10, 612))


def k7_check(B, W, V, dev):
    """K7 at (B, W, V) against the twin: random states with finished and
    dead beams, no finished beam, every beam finished, exact ties; alpha 0
    and 0.6.  Returns the worst logp error."""
    import torch

    from avsr_tpu_torch.decode import beam

    names = ("token", "parent", "flat_parent", "feed", "logp", "lens", "finished", "settled")
    worst = 0.0
    for case, kw in (("random", {}), ("no finished", dict(p_finished=0.0)),
                     ("all finished", dict(p_finished=1.1)), ("ties", dict(ties=True))):
        for alpha in (0.0, 0.6):
            args = k7_inputs(B, W, V, dev, seed=7 + W + V, **kw)
            lp_table = beam.length_penalty_table(150, alpha, dev)
            out_k = run_beam_step(beam.beam_step, args, lp_table, dev)
            out_p = run_beam_step(beam.beam_step_plain, args, lp_table, dev)
            torch.cuda.synchronize()
            for n, a, b in zip(names, out_k, out_p):
                if n == "logp":
                    dev_ = (a - b).abs() / (K7_LOGP_ATOL + K7_LOGP_RTOL * b.abs())
                    worst = max(worst, max_err(a, b))
                    if float(dev_.max()) > 1.0:
                        fail("K7", f"{(B, W, V)} {case}, alpha {alpha}: logp differs by "
                                   f"{max_err(a, b)}")
                elif not torch.equal(a, b.to(a.dtype)):
                    fail("K7", f"{(B, W, V)} {case}, alpha {alpha}: {n} differs from the twin")
            if case == "ties":  # every candidate ties: lower flat index first
                want = torch.arange(2, 2 + W, device=dev)  # EOS, then the units
                if not (bool((out_k[1] == 0).all()) and bool((out_k[0] == want).all())):
                    fail("K7", f"{(B, W, V)}: exact ties not resolved to the lower flat index")
    return worst


def phase_k7(dev, report):
    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.decode import beam

    lib = kernels._load()
    worst = 0.0
    for B, W, V in K7_SHAPES:
        if lib.avsr_beam_step_smem(W, V) != kernels.beam_step_smem(W, V):
            fail("K7", f"W={W}, V={V}: the library's shared memory "
                       f"{lib.avsr_beam_step_smem(W, V)} is not kernels.beam_step_smem's")
        worst = max(worst, k7_check(B, W, V, dev))
        print(f"K7 [B={B},W={W},V={V}] ({kernels.beam_step_level1(W, V)}): tokens, parents, "
              f"flat parents, feeds, lens, finished and settled identical to the twin over "
              f"random, no-finished, all-finished and tied states, alpha 0 and 0.6")
    stream = torch.cuda.current_stream(dev).cuda_stream  # looked up once, as BeamStep does
    floor_dev = device_ms(lambda: kernels.launch_floor(stream))
    floor_ms = time_ms(lambda: kernels.launch_floor(stream))
    print(f"launch floor (an empty kernel): device {floor_dev:.4f} ms, "
          f"CUDA events {floor_ms:.4f} ms")
    times = {}
    for B, W, V in K7_SHAPES:
        args = k7_inputs(B, W, V, dev, seed=8)
        lp_table = beam.length_penalty_table(150, 0.0, dev)
        L = 4
        tokens = torch.empty((L, B, W), dtype=torch.int64, device=dev)
        parents = torch.empty((L, B, W), dtype=torch.int64, device=dev)
        carries = (beam.step_buffers(B, W, dev), beam.step_buffers(B, W, dev))
        for x, y in zip(carries[0][2:5], args[1:]):
            x.copy_(y)
        step = beam.beam_stepper(lp_table, tokens, parents, carries, V)
        logits = args[0]
        out = beam.step_buffers(B, W, dev)
        one = (*args, lp_table, tokens[0], parents[0], out)
        t = dict(ms=time_ms(lambda: step(logits, 0, 0)),
                 one_shot_ms=time_ms(lambda: beam.beam_step(*one)),
                 device_ms=device_ms(lambda: step(logits, 0, 0)),
                 plain_ms=time_ms(lambda: beam.beam_step_plain(*one)),
                 bound=bound(nbytes(*args, lp_table, tokens[0], parents[0], *out),
                             6 * B * W * V, "fp32"))
        times[(B, W, V)] = t
        print(f"K7 [B={B},W={W},V={V}] a search's step {t['ms']:.4f} ms (one-shot call "
              f"{t['one_shot_ms']:.4f} ms), device {t['device_ms']:.4f} ms (launch floor "
              f"{floor_dev:.4f}), plain {t['plain_ms']:.4f} ms, bound {t['bound'][0]:.7f} ms")
    main = times[K7_SHAPES[0]]  # a serve request's step
    report["beam_step"] = dict(
        max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"], library_ms=None,
        device_ms=main["device_ms"], bound=main["bound"], one_shot_ms=main["one_shot_ms"],
        launch_floor_device_ms=floor_dev, launch_floor_ms=floor_ms,
        by_shape={f"B={B},W={W},V={V}": dict(ms=t["ms"], device_ms=t["device_ms"],
                                             level1=kernels.beam_step_level1(W, V))
                  for (B, W, V), t in times.items()})


def greedy_partings(params, cfg, mems_k, mems_p, horizon, cdt):
    """Greedy on the kernel path's memories ``mems_k`` with the kernels and
    on ``mems_p`` with the plain cores, step by step in lockstep (each as
    ``greedy_decode`` runs it) -> {row: (the step where its tokens first
    part, the kernel path's gap between its token's logit and the plain
    path's token's, the plain path's gap the other way)} over the rows not
    yet finished on both paths."""
    import torch

    from avsr_tpu_torch.data.units import EOS_ID, GO_ID, PAD_ID
    from avsr_tpu_torch.models import decoder as dec
    from avsr_tpu_torch.ops import attention as attn

    pd, dc = params["decoder"], cfg.decoder
    B, dev = mems_k[0].values.shape[0], mems_k[0].values.device

    def prepared(m):  # as greedy_decode prepares a memory
        values = m.values.to(cdt).contiguous()
        keys = values if m.keys is m.values else (
            None if m.keys is None else m.keys.contiguous())
        return attn.AttentionMemory(values=values, keys=keys, mask=m.mask.contiguous(),
                                    bias=m.bias.contiguous())

    def start(mems):  # the prepared memories, the state, the cross keys, the token, done
        mems = [prepared(m) for m in mems]
        state = dec.initial_state(dc, B, horizon, cdt, dev,
                                  memory_dims=[m.values.shape[-1] for m in mems])
        return [mems, state, dec.prepare_cross(pd, dc, mems, cdt),
                torch.full((B,), GO_ID, dtype=torch.long, device=dev),
                torch.zeros((B,), dtype=torch.bool, device=dev)]

    paths, parted = (start(mems_k), start(mems_p)), {}
    for t in range(horizon):
        logits = []
        for i, run in enumerate(paths):
            mems, state, cross, tok, _ = run
            with plain_cores() if i else contextlib.nullcontext():
                run[1], lg = dec.decoder_step(pd, dc, tok, state, mems, cross, cdt)
            lg[:, PAD_ID] = -1e30
            lg[:, GO_ID] = -1e30
            logits.append(lg)
        nk, np_ = (lg.argmax(-1) for lg in logits)
        live = ~(paths[0][4] | paths[1][4])
        for r in torch.nonzero(live & (nk != np_)).flatten().tolist():
            if r not in parted:
                a, b = int(nk[r]), int(np_[r])
                parted[r] = (t, float(logits[0][r, a] - logits[0][r, b]),
                             float(logits[1][r, b] - logits[1][r, a]))
        for run, nxt in zip(paths, (nk, np_)):
            run[3] = torch.where(run[4], torch.full_like(nxt, EOS_ID), nxt)
            run[4] = run[4] | (nxt == EOS_ID)
    return parted


def phase_greedy(dev, card, cfg, label="greedy", needed=GREEDY_KERNELS, exact=False,
                 tie_tol=None):
    """Greedy-decode one B=128 batch of ``cfg``'s model on the kernel path
    and on the plain path -> (the kernel path's launches, (params, batch,
    result)).  With ``exact`` the launches count the encode too, the plain
    path encodes with the plain cores as well, and every row's ids must
    equal the plain path's; with ``tie_tol`` too, every row's ids must
    equal the plain decode's on the kernel path's memories, and a row that
    differs from the whole plain path must part from it at a tie
    (``greedy_partings``: both paths' gaps between the two tokens within
    ``tie_tol``)."""
    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.data.units import builtin_unit_dict
    from avsr_tpu_torch.decode.greedy import greedy_decode as greedy_cdt
    from avsr_tpu_torch.models import seq2seq
    from avsr_tpu_torch.utils.numerics import compute_dtype_of, full_precision

    def greedy_decode(*args):  # in the config's compute dtype
        return greedy_cdt(*args, cdt=compute_dtype_of(cfg))

    V = builtin_unit_dict(cfg.data.unit).vocab_size
    params = seq2seq.model_init(cfg, V, torch.Generator().manual_seed(0), dev)
    batch, _ = train_batch(cfg, V, dev, seed=12)
    horizon = cfg.decode.max_decode_length
    with torch.no_grad():
        if exact:
            kernels.reset_launches()
        mems = seq2seq.encode(params, cfg, batch).memories
        greedy_decode(params["decoder"], cfg.decoder, mems, 4)  # warm-up
        torch.cuda.synchronize()
        if not exact:
            kernels.reset_launches()
        t0 = time.perf_counter()
        res = greedy_decode(params["decoder"], cfg.decoder, mems, horizon)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(kernels.LAUNCHES)
        with plain_cores():
            mems_p = seq2seq.encode(params, cfg, batch).memories if exact else mems
            t0 = time.perf_counter()
            res_p = greedy_decode(params["decoder"], cfg.decoder, mems_p, horizon)
            torch.cuda.synchronize()
            ms_p = (time.perf_counter() - t0) * 1e3
            res_pk = (greedy_decode(params["decoder"], cfg.decoder, mems, horizon)
                      if tie_tol is not None else None)
        if kernels.LAUNCHES != launches:
            fail(label, "the plain reference run launched a kernel")
        ties = None
        if tie_tol is not None and not torch.equal(res.ids, res_p.ids):
            with full_precision(compute_dtype_of(cfg)):
                ties = greedy_partings(params, cfg, mems, mems_p, horizon,
                                       compute_dtype_of(cfg))
    for name in needed:
        if launches[name] == 0:
            fail(label, f"kernel {name} was not launched by greedy decode")
    check_other_route(label, launches)
    ids = res.ids
    if tuple(ids.shape) != (128, horizon) or int(ids.min()) < 0 or int(ids.max()) >= V:
        fail(label, f"ids of shape {tuple(ids.shape)} in [{int(ids.min())}, {int(ids.max())}]")
    with torch.no_grad():
        profile_report(f"{label} (B=128)", lambda: greedy_decode(
            params["decoder"], cfg.decoder, mems, horizon), per=res.steps,
            per_name="decode step")
    same = int((res.ids == res_p.ids).all(dim=1).sum())
    allowed = 0 if exact else GREEDY_MAX_DIFF_ROWS
    if tie_tol is not None:
        same_k = int((res.ids == res_pk.ids).all(dim=1).sum())
        differ = torch.nonzero(~(res.ids == res_p.ids).all(dim=1)).flatten().tolist()
        print(f"{label}: {same_k} of 128 rows with ids identical to the plain decode's on the "
              f"kernel path's memories (all 128 required); the rows that differ from the whole "
              f"plain path {differ} part from it at (row: step, kernel gap, plain gap) {ties} "
              f"(ties: both gaps within {tie_tol})")
        if same_k != 128:
            fail(label, f"{128 - same_k} rows differ from the plain decode on the same memories")
        if ties is not None and (sorted(ties) != differ or any(
                abs(gk) > tie_tol or abs(gp) > tie_tol for _, gk, gp in ties.values())):
            fail(label, f"rows {differ} part from the plain path away from a tie: {ties}")
        allowed = len(differ)
    print(f"{label} [{card}] {cfg.name} B=128, 6 s, horizon {horizon}: decode {ms:.3f} ms, "
          f"{res.steps} steps ({ms / max(res.steps, 1):.3f} ms per step), "
          f"launches {({n: launches[n] for n in needed})}; "
          f"plain path {ms_p:.3f} ms; {same} of 128 rows with ids identical to the plain path's "
          f"(at least {128 - allowed})")
    if 128 - same > allowed:
        fail(label, f"{128 - same} of 128 rows differ from the plain path's (at most {allowed})")
    return launches, (params, batch, res)


def decode_records_no_autograd(dev, cfg, params, batch, res, label):
    """``Predictor.encode`` and ``greedy_decode`` of ``batch`` with every
    parameter ``requires_grad``: the memories carry no graph, no autograd
    Function of the port is entered (each is patched to raise), and every
    decoder step runs with autograd off."""
    import torch

    from avsr_tpu_torch.data.units import builtin_unit_dict
    from avsr_tpu_torch.decode.greedy import greedy_decode
    from avsr_tpu_torch.models import decoder as dec
    from avsr_tpu_torch.models import fusion as fus
    from avsr_tpu_torch.models import transformer as tfm
    from avsr_tpu_torch.models import transformer_decoder as tdec
    from avsr_tpu_torch.ops import attention as attn
    from avsr_tpu_torch.ops import rnn
    from avsr_tpu_torch.serve import Predictor
    from avsr_tpu_torch.utils.params import tree_map

    params_rg = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    B = batch.audio.shape[0]
    arrays = {k: getattr(batch, k).cpu().numpy()
              for k in ("audio", "audio_lengths", "video", "video_lengths")
              if getattr(batch, k) is not None}
    grad_in_steps = []
    step = dec.decoder_step

    def recording_step(*args, **kwargs):
        grad_in_steps.append(torch.is_grad_enabled())
        return step(*args, **kwargs)

    with contextlib.ExitStack() as stack:
        for fn in (rnn.BiLSTMScanCore, fus.AVAlignScan, fus.FusionAttention,
                   tdec.DecoderAttention, attn.BahdanauAttend, tfm.EncoderSelfAttention,
                   tfm.ConformerConv):
            stack.enter_context(mock.patch.object(
                fn, "apply", side_effect=RuntimeError(f"{fn.__name__} was entered")))
        stack.enter_context(mock.patch.object(dec, "decoder_step", recording_step))
        pred = Predictor(params_rg, cfg, builtin_unit_dict(cfg.data.unit), device=dev,
                         batch_size=B, audio_seconds=6.0)
        t0 = time.perf_counter()
        try:
            mems = pred.encode(arrays).memories
            res_rg = greedy_decode(params_rg["decoder"], cfg.decoder, mems,
                                   cfg.decode.max_decode_length)
        except RuntimeError as e:
            fail(label, f"decoding with requires_grad parameters: {e}")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    graph = [f"{i}/{n}" for i, mem in enumerate(mems) for n in ("values", "mask", "bias")
             if getattr(mem, n).grad_fn is not None or getattr(mem, n).requires_grad]
    if graph or not grad_in_steps or any(grad_in_steps):
        fail(label, f"decoding with requires_grad parameters recorded autograd: memory fields "
                    f"{graph} with a graph, autograd on in {sum(grad_in_steps)} of "
                    f"{len(grad_in_steps)} decoder steps")
    same = int((res_rg.ids == res.ids).all(dim=1).sum())
    print(f"{label} with requires_grad parameters: Predictor.encode + greedy_decode {ms:.3f} ms, "
          f"no graph on the memory, no autograd Function entered, autograd off in all "
          f"{len(grad_in_steps)} decoder steps; {same} of {B} rows with ids identical to the "
          f"kernel path's")


def k8_inputs(B, dev, seed, T=197, H=256, Tv=150, A=128, Dv=512):
    """K8 operands at the lrs2_av_align fusion's widths: the cell, the
    context projection, the attention, the fp32 input product, a ragged
    audio mask with a 0-length row (1) and a prepared bf16 video memory
    with a 0-length row (2)."""
    import torch

    from avsr_tpu_torch.ops import attention as attn

    g = torch.Generator().manual_seed(seed)
    cell = {"wh": torch.randn((H, 4 * H), generator=g) / H ** 0.5,
            "b": 0.1 * torch.randn((4 * H,), generator=g)}
    ctx_proj = torch.randn((Dv, 4 * H), generator=g) / Dv ** 0.5
    att = {"wq": torch.randn((H, A), generator=g) / H ** 0.5,
           "v": torch.randn((A,), generator=g) / A ** 0.5,
           "wm": torch.randn((Dv, A), generator=g) / Dv ** 0.5}
    xw = torch.randn((T, B, 4 * H), generator=g)
    alen = torch.randint(1, T + 1, (B,), generator=g)
    alen[0], alen[1] = T, 0
    mask = (torch.arange(T)[:, None] < alen[None, :]).float()
    video = torch.randn((B, Tv, Dv), generator=g).to(torch.bfloat16)
    vlen = torch.randint(1, Tv + 1, (B,), generator=g)
    vlen[0], vlen[2] = Tv, 0
    cell, att = ({k: x.to(dev) for k, x in d.items()} for d in (cell, att))
    mem = attn.prepare_memory("bahdanau", att, video.to(dev), vlen.to(dev), torch.bfloat16)
    return [cell, att, ctx_proj.to(dev), xw.to(dev), mask.to(dev), mem, torch.bfloat16]


# K8 forward's shapes (T_a, B, T_v): a serving request, the train batch, the
# 16 s limits
K8_FWD_SHAPES = ((197, 8, 150), (197, 128, 150), (531, 32, 401))
# lrs2_av_align's fusion at the train buckets (phase 46)
K8_BUCKET_SHAPES = tuple((Ta, B, Tv) for B, _, Ta, Tv, _ in TRAIN_BUCKETS)
K8_SERVE_SHAPES = tuple((Ta, B, Tv) for B, _, Ta, Tv, _ in SERVE_BUCKETS)
_K8F_INFO = {}  # K8 forward's build report, shared memory and occupancy, read once


def k8_fwd_build_info():
    """K8 forward's cluster kernel as built (``csrc/av_align_fwd.cuh``):
    registers, spills and HMMA count of both read instances (fails on a
    spill or one without HMMA); the library's shared memory of both routes
    over a grid of widths against ``kernels.av_align_fwd_smem`` /
    ``av_align_step_smem`` and ``av_align_family``; the max active 16-CTA
    clusters at one and two rows a CTA at both presets' widths."""
    from avsr_tpu_torch import kernels

    if _K8F_INFO:
        return _K8F_INFO
    build = build_report("K8 fwd", "av_align_scan", {
        "fwd<bahdanau>": ("align_fwd_scanILb0E",), "fwd<luong>": ("align_fwd_scanILb1E",)})
    lib = kernels._load()
    for H in (64, 128, 192, 256, 512):
        for Dv in (64, 256, 512, 768, 1024):
            for A in (64, 128, 256):
                for S in (1, 150, 400):
                    if lib.avsr_av_align_smem(H, Dv, A, S, Dv) != kernels.av_align_step_smem(
                            H, Dv, A, S):
                        fail("K8", f"per-step shared memory at H={H}, Dv={Dv}, A={A}, S={S}: "
                                   f"library {lib.avsr_av_align_smem(H, Dv, A, S, Dv)}")
                    try:
                        cluster = kernels.av_align_family(H, Dv, A, S, Dv) == "cluster"
                    except ValueError:
                        cluster = False
                    for rpc in (1, 2):
                        want = kernels.av_align_fwd_smem(H, Dv, A, S, Dv, rpc)
                        want = want if cluster and want <= kernels.SMEM_LIMIT else -1
                        got = lib.avsr_av_align_fwd_smem(H, Dv, A, S, Dv, rpc)
                        if got != want:
                            fail("K8", f"H={H}, Dv={Dv}, A={A}, S={S}, rows_per_cta={rpc}: the "
                                       f"library's cluster forward takes {got} bytes, "
                                       f"av_align_family / av_align_fwd_smem expect {want}")
    occ = {f"{kind} rows_per_cta={r}": {
        "smem": kernels.av_align_fwd_smem(*w, r),
        "max_active_clusters": int(lib.avsr_av_align_fwd_max_active(*w, int(dot), r))}
        for kind, w, dot in (("bahdanau", (256, 512, 128, 150, 512), False),
                             ("luong", (256, 256, 256, 150, 256), True))
        for r in (1, 2)}
    print(f"K8 fwd cluster kernel: shared memory per CTA and max active clusters of 16 CTAs "
          f"(cudaOccupancyMaxActiveClusters): {occ}")
    if min(o["max_active_clusters"] for o in occ.values()) < 1:
        fail("K8 fwd", f"the cluster forward cannot be resident: {occ}")
    _K8F_INFO.update(build=build, occupancy=occ)
    return _K8F_INFO


def k8_fwd_check(label, args, attention_type, align_tol, route="cluster", tol=K8_TOL):
    """K8 forward (either read) against its plain twin on the same operands,
    in save mode (the train launch): the max abs error of hs, ctxs, aligns,
    the final carries and the saved carries h_res, c_res, ctx_res; fails
    past ``tol`` (aligns: ``align_tol``), on a non-finite value, a route
    other than ``route``, a 0-length row (1: no audio step, 2: no video
    frame) that is not exactly zero, a full row whose alignments do not sum
    to 1, a rerun or a run without save that is not bit-equal.  Returns the
    largest error."""
    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.models import fusion as fus

    kw = {"attention_type": attention_type}
    cell, att, ctx_proj, xw, mask, mem, cdt = args
    T, B, H4 = xw.shape
    S, A, Dv = mem.keys.shape[1], mem.keys.shape[2], mem.values.shape[-1]
    family = kernels.av_align_family(H4 // 4, 0 if ctx_proj is None else Dv, A, S, Dv, cdt)
    out, res = fus.av_align_scan_fwd(*args, save=True, **kw)
    out2, res2 = fus.av_align_scan_fwd(*args, save=True, **kw)
    out3, _ = fus.av_align_scan_fwd(*args, save=False, **kw)
    out_p, res_p = fus.av_align_scan_fwd_plain(*args, save=True, **kw)
    torch.cuda.synchronize()
    names = ("hs", "ctxs", "aligns", "hT", "cT", "ctxT", "h_res", "c_res", "ctx_res")
    e = {n: max_err(a, b) for n, a, b in zip(names, (*out, *res), (*out_p, *res_p))}
    hs, ctxs, al = out[:3]
    zeros = (float(hs[:, 1].abs().max()), float(ctxs[:, 1].abs().max()),
             float(al[:, 1].abs().max()), float(ctxs[:, 2].abs().max()),
             float(al[:, 2].abs().max()), float(res[2][:, 1].abs().max()))
    rows2 = float(al[: int(mask[:, 0].sum()), 0].sum(-1).sub(1).abs().max())
    same = (all(torch.equal(a, b) for a, b in zip((*out, *res), (*out2, *res2)))
            and all(torch.equal(a, b) for a, b in zip(out, out3)))
    print(f"{label}: family {family}; max abs err {e} (tol {tol}, aligns {align_tol}); "
          f"0-length audio row hs/ctxs/aligns/ctx_res and 0-length video row ctxs/aligns "
          f"max |x| {zeros}; full row's alignments sum to 1 within {rows2}; reruns (and save "
          f"off) bit-equal {same}")
    if family != route:
        fail(label, f"family {family}, expected {route}")
    if not all(torch.isfinite(x).all() for x in (*out, *res)):
        fail(label, "non-finite kernel output")
    if max(zeros) != 0.0:
        fail(label, f"a 0-length row is not exactly zero: {zeros}")
    if not same:
        fail(label, "two launches on the same operands differ")
    if not (max(v for n, v in e.items() if n != "aligns") <= tol and e["aligns"] <= align_tol
            and rows2 <= 1e-5):
        fail(label, f"kernel disagrees with the plain twin: {e}")
    return max(e.values())


def k8_fwd_bound(args, attention_type, out):
    """(ms, what bounds it) of K8 forward on these operands: the inputs read
    once (the memory once where keys are values), the outputs written once;
    per step the gate products, q, the score and the context (bf16
    operands) and Bahdanau's energies (fp32)."""
    cell, att, ctx_proj, xw, mask, mem, _ = args
    T, B, H4 = xw.shape
    S, A, Dv = mem.keys.shape[1], mem.keys.shape[2], mem.values.shape[-1]
    H, Dc = H4 // 4, 0 if ctx_proj is None else Dv
    luong = attention_type == "luong"
    memory = (mem.values,) if luong else (mem.keys, mem.values)
    nb = (nbytes(xw, mask, *memory, mem.bias, mem.mask, *out)
          + 2 * (H * H4 + Dc * H4 + H * A + (0 if luong else A)) + 4 * H4)
    flops = {"bf16": T * 2 * B * ((H + Dc) * H4 + H * A + S * A + S * Dv)}
    if not luong:
        flops["fp32"] = T * 2 * B * S * A
    return bound(nb, flops)


def k8_fwd_phase(dev, report, key, label, attention_type, make, seed, align_tol, widths,
                 extra=()):
    """Phases 13 and 30: K8 forward (one read) against the plain twin at
    ``K8_FWD_SHAPES`` and the (T_a, B, T_v) of ``extra``, its build report, device ms, us a step in one
    cluster with and without masked steps, and the kernels
    line's entry ``key`` (the serving shape's times, B = 128's beside)."""
    import torch

    from avsr_tpu_torch.models import fusion as fus

    info = k8_fwd_build_info()
    kw = {"attention_type": attention_type}
    errs, by_shape = [], {}
    for i, (T, B, Tv) in enumerate(K8_FWD_SHAPES + tuple(x for x in extra
                                                         if x not in K8_FWD_SHAPES)):
        args = make(B, dev, seed + B + T, T=T, Tv=Tv)
        errs.append(k8_fwd_check(f"{label} [T_a={T},B={B},T_v={Tv},{widths}]", args,
                                 attention_type, align_tol))
        run = lambda: fus.av_align_scan_fwd(*args, **kw)  # noqa: E731
        train = lambda: fus.av_align_scan_fwd(*args, save=True, **kw)  # noqa: E731
        r = {"device_ms": device_ms(run, reps=5), "device_ms_save": device_ms(train, reps=5)}
        if i < 2:  # the serving and the train shape
            r["ms"] = time_ms(run, reps=10)
            r["plain_ms"] = time_ms(lambda: fus.av_align_scan_fwd_plain(*args, **kw), reps=3,
                                    warmup=1)
            r["bound"] = k8_fwd_bound(args, attention_type, run()[0])
        r["us_per_step"] = r["device_ms"] * 1e3 / T
        by_shape[(T, B, Tv)] = r
        print(f"{label} [T_a={T},B={B},T_v={Tv}]: {r}")
        del args
    # the step's latency in one cluster (B = 16), and with every step masked
    # (no read: the exchanges, the products and the cell update)
    args = make(16, dev, seed + 16)
    live_us = device_ms(lambda: fus.av_align_scan_fwd(*args, **kw), reps=5) * 1e3 / 197
    args[4] = torch.zeros_like(args[4])
    masked_us = device_ms(lambda: fus.av_align_scan_fwd(*args, **kw), reps=5) * 1e3 / 197
    print(f"{label} [T_a=197,B=16,T_v=150] one cluster: {live_us:.3f} us a step, "
          f"{masked_us:.3f} us a step with every step masked")
    s8, s128, s16 = (by_shape[s] for s in K8_FWD_SHAPES)
    report[key] = dict(
        max_abs_err=max(errs), ms=s8["ms"], plain_ms=s8["plain_ms"], library_ms=None,
        device_ms=s8["device_ms"], bound=s8["bound"], us_per_step=s8["us_per_step"],
        ms_B128=s128["ms"],
        device_ms_B128=s128["device_ms"], device_ms_B128_save=s128["device_ms_save"],
        bound_ms_B128=s128["bound"][0], us_per_step_B128=s128["us_per_step"],
        device_ms_T531_B32=s16["device_ms"], us_per_step_one_cluster=live_us,
        us_per_step_one_cluster_masked=masked_us,
        build={k: v for k, v in info["build"].items() if attention_type in k},
        occupancy={k: v for k, v in info["occupancy"].items() if k.startswith(attention_type)})


def phase_k8(dev, report):
    k8_fwd_phase(dev, report, "av_align_scan", "K8", "bahdanau", k8_inputs, 13, K8_ALIGN_TOL,
                 "H=256,A=128,Dv=512", extra=K8_BUCKET_SHAPES + K8_SERVE_SHAPES)


def k10_inputs(N, dev, seed, S=197, Hq=256, A=128, Dv=768, W=1):
    """K10 operands at the lrs2_av_align decoder's widths: the top layer's
    h [N, Hq], the attention, and a prepared fused memory ([h ; ctx], fp32)
    of N / W rows with bf16 values, as the beam search gives it untiled
    (query row n reads memory row n // W), with a length-0 row (1)."""
    import torch

    from avsr_tpu_torch.ops import attention as attn

    g = torch.Generator().manual_seed(seed)
    B = N // W
    query = 0.5 * torch.randn((N, Hq), generator=g)
    att = {"wq": torch.randn((Hq, A), generator=g) / Hq ** 0.5,
           "v": torch.randn((A,), generator=g) / A ** 0.5,
           "wm": torch.randn((Dv, A), generator=g) / Dv ** 0.5}
    memory = torch.randn((B, S, Dv), generator=g)
    lens = torch.randint(1, S + 1, (B,), generator=g)
    lens[0], lens[1] = S, 0
    att = {k: x.to(dev) for k, x in att.items()}
    mem = attn.prepare_memory("bahdanau", att, memory.to(dev), lens.to(dev), torch.bfloat16)
    mem = mem._replace(values=mem.values.to(torch.bfloat16))
    return ["bahdanau", att, query.to(dev), mem, torch.bfloat16]


# K10's forward shapes: (label, N, W, S, widths, the route attend_route gives):
# the beam step of a serve request (8 utterances, 10 beams) over 6 s and 16 s
# memories, 3 beams, greedy's and the teacher-forced loop's one query a row
# at N = 128 (also over 16 s, and with Luong's keys a tensor apart from its
# values: the row read's two passes), key widths off the tensor cores'
# 16-column steps (a beam step and one beam a row), and 17 column groups of
# q (A = 272) over a cluster of 8, where the CTAs own 2 or 3; and the
# TCD-TIMIT presets' widths (Bahdanau Dv = 512) over their audio memory
# (S = 197) and video memory (S = 150), a beam step and one beam a row, as
# the unimodal and bimodal serve, greedy and train paths read them
K10_FWD_CASES = (("beam step", 80, 10, 197, "preset", "grouped"),
                 ("3 beams", 24, 3, 197, "preset", "grouped"),
                 ("beam step, 16 s", 80, 10, 531, "preset", "grouped"),
                 ("one beam", 128, 1, 197, "preset", "row"),
                 ("one beam, 16 s", 128, 1, 531, "preset", "row"),
                 ("one beam, keys apart", 128, 1, 197, "apart", "row"),
                 ("beam step, odd width", 80, 10, 197, "odd", "general"),
                 ("one beam, odd width", 128, 1, 197, "odd", "general"),
                 ("beam step, 17 q groups", 80, 10, 197, "groups", "grouped"),
                 ("one beam, 17 q groups", 128, 1, 197, "groups", "row"),
                 ("beam step, regime widths", 80, 10, 197, "regime", "grouped"),
                 ("beam step, regime widths, S = 150", 80, 10, 150, "regime", "grouped"),
                 ("one beam, regime widths", 128, 1, 197, "regime", "row"),
                 ("one beam, regime widths, S = 150", 128, 1, 150, "regime", "row"))


# the K10 forward kernels by route, as k10_launch takes them
K10_ROUTES = ("grouped", "row", "general")

# the beam steps (10 beams) timed on both kernels, (memory rows B, S): a
# serve request's over 6 s and 16 s memories, and 32 utterances
K10_TIMED = ((8, 197), (8, 531), (32, 197))


def k10_launch(route, query, wq, v, keys, values, bias, mask):
    """One K10 forward launch on ``route`` ("grouped", "row" or "general")
    straight through the library, whatever ``kernels.attend_route`` would
    pick, and uncounted: the timings' other kernels.  -> (ctx, weights)."""
    import torch

    from avsr_tpu_torch import kernels

    N, Hq = query.shape
    B, S, A = keys.shape
    Dv, dot = values.shape[-1], v is None
    ctx = torch.empty((N, Dv), dtype=torch.float32, device=query.device)
    w = torch.empty((N, S), dtype=torch.float32, device=query.device)
    args = (query.data_ptr(), wq.data_ptr(), kernels._ptr(v), keys.data_ptr(),
            values.data_ptr(), bias.data_ptr(), mask.data_ptr(), ctx.data_ptr(), w.data_ptr())
    stream = torch.cuda.current_stream(query.device).cuda_stream
    lib = kernels._load()
    if route == "grouped":
        C = kernels.attend_grouped_cluster(B, N // B, S, Hq, A, Dv, dot)
        err = lib.avsr_attend_grouped(*args, B, N // B, Hq, A, S, Dv, C, int(dot), stream)
    elif route == "row":
        err = lib.avsr_attend_row(*args, N, N // B, Hq, A, S, Dv, int(dot), stream)
    else:
        err = lib.avsr_bahdanau_attend(*args, N, N // B, Hq, A, S, Dv, int(dot), stream)
    kernels._raise_on(err, f"K10 {route} launch")
    return ctx, w


def k10_fwd_check(tag, args, w_tol, W, ctx_tol=K10_CTX_TOL):
    """K10's forward (``attn.attend``, routed by shape) against the plain
    twin: errors within ``ctx_tol`` and ``w_tol``, the beams of the length-0
    memory row exactly 0, a rerun bit-equal.  -> the worst error."""
    import torch

    from avsr_tpu_torch.ops import attention as attn

    ctx, w = attn.attend(*args)
    ctx2, w2 = attn.attend(*args)
    ctx_p, w_p = attn.attend_plain(*args)
    torch.cuda.synchronize()
    e = {"ctx": max_err(ctx, ctx_p), "weights": max_err(w, w_p)}
    empty = (float(ctx[W:2 * W].abs().max()), float(w[W:2 * W].abs().max()))
    same = bool(torch.equal(ctx, ctx2) and torch.equal(w, w2))
    others = (w.sum(-1) - 1)[2 * W:].abs()
    print(f"{tag}: max abs err {e} (tol ctx {ctx_tol}, weights {w_tol}); length-0 row's "
          f"beams max |ctx|, |w| {empty}; rerun bit-equal {same}; weight sums of the other "
          f"rows within {float(others.max()) if others.numel() else 0.0} of 1; largest weight "
          f"{float(w.max()):.4f}")
    if not (torch.isfinite(ctx).all() and e["ctx"] <= ctx_tol and e["weights"] <= w_tol):
        fail(tag, f"kernel disagrees with the plain twin: {e}")
    if empty != (0.0, 0.0):
        fail(tag, f"a length-0 memory does not give a zero context and weights: {empty}")
    if not same:
        fail(tag, "a rerun is not bit-equal")
    return max(e.values())


def k10_row_build_info():
    """K10's row read as built: registers and spills of both instances
    (fails on a spill or a missing one) and its shared memory a CTA, the
    library's against ``kernels.attend_row_smem`` over a grid of shapes
    (fails where they differ)."""
    from avsr_tpu_torch import kernels

    rep = {k: r for k, r in kernels.ptxas_report("bahdanau_attend").items()
           if "attend_row_kernel" in k}
    if len(rep) != 2 or any(r["spill_stores"] or r["spill_loads"] for r in rep.values()):
        fail("K10 row", f"a row-read kernel spills or is missing: {rep}")
    lib = kernels._load()
    bad = [(Hq, A, S, Dv, dot) for Hq in (16, 256, 512) for A in (16, 128, 272, 512)
           for S in (1, 197, 531) for Dv in (16, 512, 768, 2048) for dot in (False, True)
           if lib.avsr_attend_row_smem(Hq, A, S, Dv, int(dot))
           != (kernels.attend_row_smem(Hq, A, S, Dv, dot)
               if kernels.attend_row_admits(Hq, A, S, Dv, dot) else -1)]
    occ = {kind: kernels.attend_row_info(*widths)["max_active_clusters"]
           for kind, widths in (("bahdanau", (256, 128, 197, 768, False)),
                                ("luong", (256, 512, 197, 512, True)))}
    print(f"K10 row read (ptxas -v): {rep}; its shared memory a CTA at the presets' widths "
          f"{kernels.attend_row_smem(256, 128, 197, 768, False)} B (Luong "
          f"{kernels.attend_row_smem(256, 512, 197, 512, True)} B); clusters of "
          f"{kernels.ATTEND_ROW_CLUSTER} resident at once {occ} (N = 128 rows: 64)")
    if bad:
        fail("K10 row", f"kernels.attend_row_smem differs from the library's Layout at {bad}")
    if min(occ.values()) < 1:
        fail("K10 row", f"a cluster of the row read cannot be resident: {occ}")
    return rep


def k10_fwd_phase(dev, report, key, label, make, w_tol, odd, groups, regime):
    """K10's forward for one read (``make``: ``k10_inputs`` or
    ``k10_luong_inputs``; ``odd`` their widths off the tensor cores' steps,
    ``groups`` widths of 17 column groups of q, ``regime`` the TCD-TIMIT
    presets' widths): every K10_FWD_CASES shape on
    the route ``kernels.attend_route`` gives it against the plain twin, each
    grouped shape's shared memory (``kernels.attend_grouped_smem``) and
    resident clusters (``kernels.ATTEND_GROUP_WAVE``) against the library's.
    Then the device ms of the grouped read and the general kernel at the
    beam steps of K10_TIMED, of the general kernel over the memory tiled 10
    times (the read before the memory was untiled), and at one beam a row
    (N = 128, greedy's and the teacher-forced loop's, over S = 197 and 531)
    of the row read, the general kernel (the route there before the row
    read) and the grouped read, with the bounds.  Reports the row read as ``key``_row
    and the general kernel as ``key`` (both at one beam a row), the grouped
    read as ``key``_grouped (at the beam step)."""
    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.ops import attention as attn

    worst = {"row": 0.0, "grouped": 0.0, "general": 0.0}
    for i, (what, N, W, S, widths, want) in enumerate(K10_FWD_CASES):
        kw = {"preset": {}, "apart": {}, "odd": odd, "groups": groups, "regime": regime}[widths]
        args = make(N, dev, seed=i + N + S, S=S, W=W, **kw)
        mem = args[3]
        if widths == "apart" and mem.keys is mem.values:
            args[3] = mem = mem._replace(keys=mem.values.clone())
        B, S_, A = mem.keys.shape
        N, Hq = args[2].shape
        Dv = mem.values.shape[-1]
        dot = args[0] == "luong"
        route = kernels.attend_route(N, B, S_, Hq, A, Dv, dot)
        C = kernels.attend_grouped_cluster(B, W, S_, Hq, A, Dv, dot) if route == "grouped" else 0
        tag = (f"{label} {what} [N={N}={B}x{W},S={S_},Hq={Hq},A={A},Dv={Dv}] route {route}"
               + (f" (clusters of {C})" if C else ""))
        if route != want:
            fail(label, f"{tag}: expected the {want} route")
        if C:
            info = kernels.attend_grouped_info(W, S_, Hq, A, Dv, C, dot)
            mirror = kernels.attend_grouped_smem(W, S_, Hq, A, Dv, C, dot)
            print(f"{tag}: shared memory a CTA {info['smem']} B (mirror {mirror}), "
                  f"{info['max_active_clusters']} clusters resident at once "
                  f"(ATTEND_GROUP_WAVE {kernels.ATTEND_GROUP_WAVE[C]})")
            if info["smem"] != mirror:
                fail(label, f"{tag}: kernels.attend_grouped_smem gives {mirror} B, the "
                            f"library's Layout {info['smem']} B")
            if info["max_active_clusters"] != kernels.ATTEND_GROUP_WAVE[C]:
                fail(label, f"{tag}: the library holds {info['max_active_clusters']} clusters "
                            f"of {C} at once, kernels.ATTEND_GROUP_WAVE plans "
                            f"{kernels.ATTEND_GROUP_WAVE[C]}")
        if route == "row":
            plan = kernels.attend_row_plan(S_, A, Dv, dot, mem.keys is mem.values)
            tag += f" (chunks {plan})"
        before = dict(kernels.LAUNCHES)
        worst[route] = max(worst[route], k10_fwd_check(tag, args, w_tol, W))
        counter = kernels.attend_counter(route, dot)
        if kernels.LAUNCHES[counter] - before[counter] != 2:
            fail(label, f"{tag}: two reads launched {counter} "
                        f"{kernels.LAUNCHES[counter] - before[counter]} times")
        if widths == "apart" and dot:
            # the same chunks, read twice (keys, then values) or once (the
            # row resident): the same bits
            one = attn.attend(*args[:3], args[3]._replace(keys=args[3].values), args[4])
            two = attn.attend(*args)
            same = all(torch.equal(a, b) for a, b in zip(one, two))
            print(f"{tag}: equal bit for bit to the resident read of the same row: {same}")
            if not same:
                fail(label, f"{tag}: the two-pass read differs from the resident one")

    def ops(args, route, tile=1):
        # one read as attn.attend issues it (the operands' casts included) on
        # ``route``, over the memory tiled ``tile`` times
        typ, att, query, mem, cdt = args
        if tile > 1:
            rows = lambda x: x.repeat_interleave(tile, dim=0).contiguous()  # noqa: E731
            values = rows(mem.values)
            keys = values if mem.keys is mem.values else rows(mem.keys)
            mem = attn.AttentionMemory(values=values, keys=keys, mask=rows(mem.mask),
                                       bias=rows(mem.bias))
        q = query.float().contiguous()
        return lambda: k10_launch(route, q, *attn.kernel_operands(typ, att, mem, cdt),
                                  mem.bias, mem.mask)

    def bounds(args, tile=1):
        # the bound of the read's bytes (each memory row read once, or
        # ``tile`` times) and operations
        typ, att, query, mem, _ = args
        ctx, w = attn.attend(*args)
        N, Hq = query.shape
        S, A = mem.keys.shape[1:]
        Dv = mem.values.shape[-1]
        wq = att["wq"].to(torch.bfloat16)
        v = None if typ == "luong" else att["v"].to(torch.bfloat16)
        memory = [mem.values] if mem.keys is mem.values else [mem.keys, mem.values]
        nb = nbytes(query, wq, v, ctx, w) + tile * nbytes(*memory, mem.bias, mem.mask)
        flops = {"bf16": 2 * N * (Hq * A + S * A + S * Dv)}
        if typ != "luong":
            flops["fp32"] = 2 * N * S * A
        return bound(nb, flops), nb

    times = {}
    for B, S in K10_TIMED:
        args = make(10 * B, dev, seed=B + S, S=S, W=10)
        dot = args[0] == "luong"
        A = args[3].keys.shape[-1]
        Hq, Dv = args[2].shape[1], args[3].values.shape[-1]
        C = kernels.attend_grouped_cluster(B, 10, S, Hq, A, Dv, dot)
        route = kernels.attend_route(10 * B, B, S, Hq, A, Dv, dot)
        t = {"grouped": device_ms(ops(args, "grouped")), "general": device_ms(ops(args, "general")),
             "route": route, "cluster": C}
        if (B, S) == (8, 197):
            t["tiled_general"] = device_ms(ops(args, "general", tile=10))
            t["ms"] = time_ms(lambda: attn.attend(*args))
            t["plain_ms"] = time_ms(lambda: attn.attend_plain(*args))
            (t["bound"], nb), (b_tiled, nb_tiled) = bounds(args), bounds(args, tile=10)
            t["bound_tiled_ms"] = b_tiled[0]
        print(f"{label} beam step [N={10 * B}={B}x10,S={S}]: device ms grouped {t['grouped']:.5f} "
              f"(clusters of {C}, {kernels.ATTEND_GROUP_WAVE[C]} resident at once), general "
              f"kernel {t['general']:.5f}"
              + (f", general kernel over the tiled memory {t['tiled_general']:.5f}; "
                 f"ms {t['ms']:.4f} (host clock), plain {t['plain_ms']:.4f}; "
                 f"bound {t['bound'][0]:.5f} ms ({t['bound'][1]}, untiled "
                 f"{nb / 1e6:.2f} MB), tiled {b_tiled[0]:.5f} ms "
                 f"({nb_tiled / 1e6:.2f} MB)" if (B, S) == (8, 197) else "")
              + f"; the route: {route}")
        times[B, S] = t
    one = {}
    for S in (197, 531):
        g1 = make(128, dev, seed=128 + S, S=S)
        o = {r: device_ms(ops(g1, r)) for r in ("row", "general", "grouped")}
        o["bound"], nb = bounds(g1)
        if S == 197:
            o["ms"] = time_ms(lambda: attn.attend(*g1))
            o["ms_general"] = time_ms(ops(g1, "general"))
            o["plain_ms"] = time_ms(lambda: attn.attend_plain(*g1))
        print(f"{label} one beam a row [N=128=128x1,S={S}]: device ms row {o['row']:.5f} (the "
              f"route), general {o['general']:.5f}, grouped {o['grouped']:.5f}; "
              + (f"ms {o['ms']:.4f} (host clock; general {o['ms_general']:.4f}), plain "
                 f"{o['plain_ms']:.4f}; " if S == 197 else "")
              + f"bound {o['bound'][0]:.5f} ms ({o['bound'][1]}, {nb / 1e6:.2f} MB)")
        one[S] = o
    build = k10_row_build_info()
    o, o16 = one[197], one[531]
    t, t16, t32 = times[8, 197], times[8, 531], times[32, 197]
    report[f"{key}_row"] = dict(
        max_abs_err=worst["row"], ms=o["ms"], plain_ms=o["plain_ms"], library_ms=None,
        device_ms=o["row"], bound=o["bound"], device_ms_general=o["general"],
        device_ms_grouped=o["grouped"], device_ms_16s=o16["row"],
        device_ms_16s_general=o16["general"], bound_16s_ms=o16["bound"][0],
        registers={k.split("kernel")[-1][:4]: r["registers"] for k, r in build.items()})
    report[key] = dict(max_abs_err=worst["general"], ms=o["ms_general"], plain_ms=o["plain_ms"],
                       library_ms=None, device_ms=o["general"], bound=o["bound"],
                       device_ms_16s=o16["general"], bound_16s_ms=o16["bound"][0])
    report[f"{key}_grouped"] = dict(
        max_abs_err=worst["grouped"], ms=t["ms"], plain_ms=t["plain_ms"], library_ms=None,
        device_ms=t["grouped"], bound=t["bound"], cluster=t["cluster"],
        device_ms_general=t["general"], device_ms_tiled_general=t["tiled_general"],
        bound_tiled_ms=t["bound_tiled_ms"], device_ms_16s=t16["grouped"],
        device_ms_16s_general=t16["general"], attend_route_16s=t16["route"],
        cluster_16s=t16["cluster"], device_ms_B32=t32["grouped"],
        device_ms_B32_general=t32["general"], attend_route_B32=t32["route"],
        cluster_B32=t32["cluster"])


# lrs2_av_align's reads at the train buckets (phase 46), (N, W, S): the
# loss's one query a row at N = B over S = T_a, and the eval's width-10
# beam over the buckets its 1.6-6 s utterances fill
K10_BUCKET_READS = (tuple((B, 1, Ta) for B, _, Ta, _, _ in TRAIN_BUCKETS)
                    + tuple((10 * B, 10, Ta) for B, _, Ta, _, _ in TRAIN_BUCKETS[:3]))
# the align artifacts at the serving buckets: the width-10 beam's read (N =
# 80 over B = 8) and greedy's (N = B)
K10_SERVE_READS = tuple((W * B, W, Ta) for B, _, Ta, _, _ in SERVE_BUCKETS for W in (10, 1))


def phase_k10(dev, report):
    from avsr_tpu_torch import kernels

    k10_fwd_phase(dev, report, "bahdanau_attend", "K10", k10_inputs, K10_W_TOL, {"A": 72},
                  {"Hq": 512, "A": 272}, {"Dv": 512})
    for N, W, S in K10_BUCKET_READS + K10_SERVE_READS:
        args = k10_inputs(N, dev, seed=N + S, S=S, W=W)
        route = kernels.attend_route(N, N // W, S, 256, 128, 768, False)
        if route != ("row" if W == 1 else "grouped"):
            fail("K10", f"bucket read [N={N},W={W},S={S}] takes the {route} route")
        worst = k10_fwd_check(f"K10 bucket read [N={N}={N // W}x{W},S={S}] route {route}",
                              args, K10_W_TOL, W)
        r = report[f"bahdanau_attend_{route}"]
        r["max_abs_err"] = max(r["max_abs_err"], worst)
    # keys past |k| = 40, where the grouped read's factored energies could
    # leave fp32's range and it takes tanhf(k + q) instead, and where the row
    # read's energies saturate
    for N, W, route in ((80, 10, "grouped"), (128, 1, "row")):
        args = k10_inputs(N, dev, seed=41, W=W)
        args[3] = args[3]._replace(keys=args[3].keys * 30.0)
        worst = k10_fwd_check(f"K10 keys x 30 (the tanhf energies) [N={N}={N // W}x{W},S=197] "
                              f"route {route}", args, K10_W_TOL, W)
        r = report[f"bahdanau_attend_{route}"]
        r["max_abs_err"] = max(r["max_abs_err"], worst)


def k8_bwd_inputs(B, dev, seed, attention_type="bahdanau", make=None, **widths):
    """K8 backward operands: ``make``'s (by default ``k8_inputs``,
    ``k8_luong_inputs`` for Luong), the kernel forward's alignments and
    saved carries, random cotangents of the outputs and final carries."""
    import torch

    from avsr_tpu_torch.models import fusion as fus

    if make is None:
        make = k8_luong_inputs if attention_type == "luong" else k8_inputs
    cell, att, ctx_proj, xw, mask, mem, cdt = make(B, dev, seed, **widths)
    (_, _, aligns, *_), res = fus.av_align_scan_fwd(cell, att, ctx_proj, xw, mask, mem, cdt,
                                                    save=True, attention_type=attention_type)
    T, B, H4 = xw.shape
    H, Dv = H4 // 4, mem.values.shape[-1]
    g = torch.Generator().manual_seed(seed + 1)
    cot = [torch.randn(s, generator=g).to(dev)
           for s in ((T, B, H), (T, B, Dv), (B, H), (B, H), (B, Dv))]
    return [cell, att, ctx_proj, xw, mask, mem, aligns, res, *cot, cdt]


_K8B_INFO = {}  # K8 backward's build report and occupancy, read once


def k8_bwd_layout_check():
    """The wrapper's mirror of K8 backward's recurrence layout
    (``kernels.av_align_bwd_smem``, which ``av_align_bwd_family`` and
    ``av_align_bwd_rows_per_cta`` read) against the library's
    (``avsr_av_align_bwd_smem``: the layout with Bahdanau's wq, 2 H A
    bytes, staged where it fits; -1 where the recurrence does not take the
    shape) over a grid of widths, both reads, at 1 and 2 rows a CTA: a
    drift would send a shape to the cluster route that its kernels refuse."""
    from avsr_tpu_torch import kernels

    lib = kernels._load()
    bad, n = [], 0
    for H in (64, 128, 192, 256, 320, 512, 576):
        for Dv in (64, 256, 512):
            for Dc in (0, Dv):
                for A in (64, 72, 128, 256):
                    for S in (1, 150, 400):
                        for dot in (False, True):
                            try:
                                family = kernels.av_align_bwd_family(H, Dc, A, S, Dv, dot)
                            except ValueError:
                                continue
                            for rpc in (1, 2):
                                want = kernels.av_align_bwd_smem(H, Dc, A, S, Dv, dot, rpc)
                                if family != "cluster" or want > kernels.SMEM_LIMIT:
                                    want = -1
                                elif not dot and want + 2 * H * A <= kernels.SMEM_LIMIT:
                                    want += 2 * H * A
                                got = lib.avsr_av_align_bwd_smem(H, Dc, A, S, Dv, int(dot), rpc)
                                n += 1
                                if got != want:
                                    bad.append((H, Dc, A, S, Dv, dot, rpc, got, want))
    print(f"K8 bwd layout: the wrapper's mirror against the library's at {n} shapes "
          f"(H, Dc, A, S, Dv, dot, rows a CTA, library, mirror): "
          f"{'agree' if not bad else bad[:8]}")
    if bad:
        fail("K8 bwd", f"the recurrence's layout drifts from kernels.av_align_bwd_smem: {bad[:8]}")


def k8_bwd_build_info():
    """K8 backward's kernels as built (``csrc/av_align_bwd.cuh``):
    registers, spills and HMMA count of the tensor-core ones (the
    recurrence at either read, the regate, the query launch, the
    outer-product sums; fails on a spill or one without HMMA), registers
    and spills of the energy pass (CUDA cores), and the recurrence's shared
    memory and max active 16-CTA clusters at both instances' widths."""
    from avsr_tpu_torch import kernels

    if _K8B_INFO:
        return _K8B_INFO
    build = build_report("K8 bwd", "av_align_scan", {
        "scan<bahdanau>": ("align_bwd_scanILb0E",), "scan<luong>": ("align_bwd_scanILb1E",),
        "regate": ("align_regate_mma",), "query": ("align_query_kernel",),
        "outer_sum<dvalues>": ("align_outer_sumILb0E",),
        "outer_sum<luong dkeys>": ("align_outer_sumILb1E",)})
    cores = {k: r for k, r in kernels.ptxas_report("av_align_scan").items()
             if "align_dkeys_energy" in k}
    if any(r["spill_stores"] or r["spill_loads"] for r in cores.values()) or len(cores) != 1:
        fail("K8 bwd", f"the energy pass spills or is missing: {cores}")
    k8_bwd_layout_check()
    occ = {f"{kind} rows_per_cta={r}": kernels.av_align_bwd_info(*widths, rows_per_cta=r)
           for kind, widths in (("bahdanau", (256, 512, 128, 150, 512, False)),
                                ("luong", (256, 256, 256, 150, 256, True)))
           for r in (1, 2)}
    print(f"K8 bwd CUDA-core kernel (ptxas -v): "
          f"{ {k.split('align_')[-1][:24]: r for k, r in cores.items()} }; the recurrence's "
          f"shared memory per CTA and max active clusters of 16 CTAs (cudaOccupancyMax"
          f"ActiveClusters): {occ}")
    if min(o["max_active_clusters"] for o in occ.values()) < 1:
        fail("K8 bwd", f"the recurrence cannot be resident: {occ}")
    _K8B_INFO.update(build=build, occupancy=occ)
    return _K8B_INFO


def k8_bwd_split(args, attention_type, rows_per_cta=None):
    """Device ms of K8 backward's stages run apart on the kernel's operands
    (``kernels.av_align_scan_bwd_stages``, at ``rows_per_cta`` or the
    wrapper's default; each timed as ``device_ms``): prep (the regate and
    the query launch), scan (the recurrence), sums (the memory's gradients
    after the scan)."""
    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.models import fusion as fus
    from avsr_tpu_torch.ops import attention as attn

    cell, att, ctx_proj, xw, mask, mem, aligns, res, dhs, dctxs, dhT, dcT, dctxT, cdt = args
    wq, v, keys, values = attn.kernel_operands(attention_type, att, mem, cdt)
    rpc = {} if rows_per_cta is None else {"rows_per_cta": rows_per_cta}
    stages, _ = kernels.av_align_scan_bwd_stages(
        *fus._cell_operands(cell, ctx_proj, cdt), wq, v, xw, mask, keys, values, aligns, *res, dhs,
        dctxs, dhT, dcT, dctxT, **rpc)
    for name in ("prep", "scan", "sums"):
        stages[name]()
    return {name: device_ms(stages[name], reps=5, warmup=1) for name in ("prep", "scan", "sums")}


def k8_bwd_against_plain(label, args, attention_type, tol=K8B_REL_TOL):
    """K8 backward (either read) against its plain twin on the same
    operands: the max abs error and the error relative to max |plain| of
    every output and weight gradient; fails past ``tol``, on a
    non-finite value, a v factor from a Luong read (or none from a
    Bahdanau one), an empty row's gradient that is not exactly 0 (row 1 has
    no audio step, row 2 no video frame) or a rerun that is not bit-equal.
    Returns (the largest max abs error, the relative errors)."""
    import torch

    from avsr_tpu_torch.models import fusion as fus

    kw = {"attention_type": attention_type}
    ctx_proj, res, cdt = args[2], args[7], args[-1]
    out_k = fus.av_align_scan_bwd(*args, **kw)
    out_k2 = fus.av_align_scan_bwd(*args, **kw)
    out_p = fus.av_align_scan_bwd_plain(*args, **kw)
    w_k = fus.av_align_weight_grads(res, ctx_proj, out_k[0], out_k[2], out_k[3], out_k[6], cdt)
    w_p = fus.av_align_weight_grads(res, ctx_proj, out_p[0], out_p[2], out_p[3], out_p[6], cdt)
    torch.cuda.synchronize()
    names = ("dxw", "db", "dq", "dv_rows", "dkeys", "dvalues", "hnew", "dWh", "dctx_proj", "dwq",
             "dv")
    pairs = [(n, a, b) for n, a, b in zip(names, (*out_k, *w_k), (*out_p, *w_p))
             if b is not None]
    errs = {n: rel_err(a, b) for n, a, b in pairs}
    abs_errs = {n: max_err(a, b) for n, a, b in pairs}
    same = all(torch.equal(a, b) for a, b in zip(out_k, out_k2) if a is not None)
    zeros = (float(out_k[0][:, 1].abs().max()), float(out_k[2][:, 1].abs().max()),
             float(out_k[4][2].abs().max()), float(out_k[5][2].abs().max()))
    print(f"{label} max abs err {abs_errs}; relative to max |plain| {errs} (tol {tol}); "
          f"rerun bit-equal {same}; 0-length audio row dxw/dq and 0-length video row "
          f"dkeys/dvalues max |x| {zeros}")
    luong = attention_type == "luong"
    if (out_k[3] is None) != luong or (w_k[3] is None) != luong:
        fail(label, "a v factor from a Luong read, or none from a Bahdanau read")
    if not all(torch.isfinite(a).all() for _, a, _ in pairs):
        fail(label, "non-finite kernel output")
    if max(zeros) != 0.0:
        fail(label, f"an empty row's gradient is not exactly zero: {zeros}")
    if not same:
        fail(label, "two launches on the same operands differ")
    if not max(errs.values()) <= tol:
        fail(label, f"kernel disagrees with the plain twin: {errs}")
    return max(abs_errs.values()), errs


def k8_bwd_16s(attention_type, dev, seed):
    """K8 backward at the 16 s limits, T_a = 531 and T_v = 401, B=16 (one
    cluster), against the plain twin; (max abs error, device ms)."""
    from avsr_tpu_torch.models import fusion as fus

    args = k8_bwd_inputs(16, dev, seed, attention_type=attention_type, T=531, Tv=401)
    err, _ = k8_bwd_against_plain(f"K8 {attention_type} bwd [T_a=531,B=16,T_v=401]", args,
                                  attention_type)
    dms = device_ms(lambda: fus.av_align_scan_bwd(*args, attention_type=attention_type), reps=3,
                    warmup=1)
    print(f"K8 {attention_type} bwd [T_a=531,B=16,T_v=401] device {dms} ms")
    return err, dms


def phase_k8_bwd(dev, report):
    from avsr_tpu_torch.models import fusion as fus

    info = k8_bwd_build_info()
    args = k8_bwd_inputs(128, dev, seed=29)
    cell, att, ctx_proj, xw, mask, mem, aligns, res, *_, cdt = args
    err, _ = k8_bwd_against_plain("K8 bwd [T_a=197,B=128,H=256,T_v=150,A=128,Dv=512]", args,
                                  "bahdanau")
    err16, dms16 = k8_bwd_16s("bahdanau", dev, seed=31)
    for T, B, Tv in K8_BUCKET_SHAPES:
        e, _ = k8_bwd_against_plain(f"K8 bwd, train bucket [T_a={T},B={B},T_v={Tv}]",
                                    k8_bwd_inputs(B, dev, seed=T + B, T=T, Tv=Tv), "bahdanau")
        err16 = max(err16, e)
    t_k = time_ms(lambda: fus.av_align_scan_bwd(*args), reps=5, warmup=1)
    t_p = time_ms(lambda: fus.av_align_scan_bwd_plain(*args), reps=2, warmup=1)
    dms = device_ms(lambda: fus.av_align_scan_bwd(*args), reps=5, warmup=1)
    split = k8_bwd_split(args, "bahdanau")
    out_k = fus.av_align_scan_bwd(*args)
    T, B, H4 = xw.shape
    S, A, Dv = mem.keys.shape[1], mem.keys.shape[2], mem.values.shape[-1]
    H = H4 // 4
    # the read's work covers the live steps' valid keys (a masked step and a
    # zero-weight key are skipped); the regate and the carries' products
    # every step and row
    live = float(mask.sum())
    keys_read = float((mask * mem.mask.sum(-1)[None, :]).sum())
    flops = {"bf16": 2 * T * B * 2 * (H + Dv) * H4 + 2 * live * 2 * H * A
             + 2 * keys_read * 2 * Dv,
             "fp32": keys_read * A * 8}
    nb = (nbytes(xw, mask, mem.keys, mem.values, aligns, *res, *args[8:13], *out_k)
          + 2 * (H * H4 + Dv * H4 + H * A + A) + 4 * H4)
    b = bound(nb, flops)
    print(f"K8 bwd B=128 kernel {t_k:.4f} ms (device {dms} ms; stages apart: {split})  plain "
          f"{t_p:.4f} ms  bound {b[0]:.5f} ms ({b[1]}, {nb / 1e6:.2f} MB)")
    report["av_align_scan_bwd"] = dict(
        max_abs_err=max(err, err16), ms=t_k, plain_ms=t_p, library_ms=None, device_ms=dms,
        bound=b, device_ms_stages=split, device_ms_T531_B16=dms16,
        recurrence={k: o for k, o in info["occupancy"].items() if k.startswith("bahdanau")})


K10_LOOP = 80  # the train cell's label positions: the reads of one K10 loop
_K10B_INFO = {}  # K10 backward's build report and occupancy, read once


def k10_bwd_build_info():
    """K10 backward's kernels as built (``csrc/bahdanau_attend.cu``):
    registers and spills of the per-step kernel and of the CUDA-core sums at
    each read (fails on a spill or a missing one), and the per-step kernel's
    shared memory and max active clusters (two CTAs a row) at both reads'
    train widths."""
    from avsr_tpu_torch import kernels

    if _K10B_INFO:
        return _K10B_INFO
    rep = {k: r for k, r in kernels.ptxas_report("bahdanau_attend").items()
           if "attend_step_bwd" in k or "attend_loop_sums" in k}
    # both reads' bf16 instances and the Bahdanau read's fp32 one, of each
    if len(rep) != 6 or any(r["spill_stores"] or r["spill_loads"] for r in rep.values()):
        fail("K10 bwd", f"a backward kernel spills or is missing: {rep}")
    occ = {kind: kernels.attend_bwd_info(*widths)
           for kind, widths in (("bahdanau", (256, 128, 197, 768, False)),
                                ("luong", (256, 512, 197, 512, True)))}

    def short(name):  # the instance of a mangled name: its kernel and template arguments
        base = "step_bwd" if "attend_step_bwd" in name else "loop_sums"
        return f"{base}<{name.split('kernel')[-1][:4]}{', f32' if f32_instance(name) else ''}>"

    print(f"K10 bwd kernels (ptxas -v): { {short(k): r for k, r in rep.items()} }; the per-step "
          f"kernel's shared memory per CTA and max active clusters of a row "
          f"(cudaOccupancyMaxActiveClusters): {occ}")
    if min(o["max_active_clusters"] for o in occ.values()) < 1:
        fail("K10 bwd", f"a cluster cannot be resident: {occ}")
    _K10B_INFO.update(build=rep, occupancy=occ)
    return _K10B_INFO


def k10_loop_inputs(args, K, seed):
    """K queries [K, N, Hq] and context cotangents [K, N, Dv] for a read
    loop over ``args``' memory (``k10_inputs`` / ``k10_luong_inputs``)."""
    import torch

    _, _, query, mem, _ = args
    g = torch.Generator().manual_seed(seed)
    N, Hq = query.shape
    queries = 0.5 * torch.randn((K, N, Hq), generator=g)
    dctxs = torch.randn((K, N, mem.values.shape[-1]), generator=g)
    return queries.to(query.device), dctxs.to(query.device)


def k10_loop(args, queries, dctxs, plain=False, weights=None):
    """K10's read loop without autograd, as ``ops/attention.py``'s route
    runs it: K forward reads (the kernel's weights, or ``weights``), each
    step's backward in reverse order, then the loop's gradients; on the
    kernels, or on the plain mirror (``plain``).  -> (the loop's state, its
    outputs by name: dquery [K, N, Hq], the saved rows, dkeys, dvalues, dwq
    and dv)."""
    import torch

    from avsr_tpu_torch.ops import attention as attn

    typ, att, _, mem, cdt = args
    K = queries.shape[0]
    st = attn.LoopState(typ, mem, cdt, K)
    st.bind(mem.keys, mem.values, att["wq"], att.get("v"))
    for k in range(K):
        st.next_step()
        st.queries[k] = queries[k]
        st.weights[k] = attn.read_fwd(st, queries[k])[1] if weights is None else weights[k]
    step = attn.read_step_bwd_plain if plain else attn.read_step_bwd
    dquery = [None] * K
    for k in reversed(range(K)):
        dquery[k] = step(st, k, queries[k], st.weights[k], dctxs[k])
        st.done[k] = True
    sums = attn.read_loop_sums_plain if plain else attn.read_loop_sums
    with mock.patch.object(attn, "read_loop_sums", sums):
        dkeys, dvalues, dwq, dv = attn.loop_gradients(st)
    out = {"dquery": torch.stack(dquery), "dsc": st.dsc.clone(), "q": st.q.clone(),
           "dq": st.dq.clone(), "dv_rows": None if st.dv_rows is None else st.dv_rows.clone(),
           "dkeys": dkeys, "dvalues": dvalues, "dwq": dwq, "dv": dv}
    return st, {n: x for n, x in out.items() if x is not None}


def k10_bwd_check(label, args, K, seed, tol=K10B_REL_TOL):
    """K10's backward loop on the kernels against the plain mirror (the
    same queries, cotangents and forward weights), twice on the kernels
    (bit-equal), the length-0 row (1) exactly 0.  -> (state, the kernels'
    outputs, queries, cotangents, worst abs error)."""
    import torch

    queries, dctxs = k10_loop_inputs(args, K, seed)
    st, out_k = k10_loop(args, queries, dctxs)
    _, out_k2 = k10_loop(args, queries, dctxs)
    _, out_p = k10_loop(args, queries, dctxs, plain=True, weights=st.weights)
    torch.cuda.synchronize()
    errs = {n: rel_err(out_k[n], out_p[n]) for n in out_k}
    abs_errs = {n: max_err(out_k[n], out_p[n]) for n in out_k}
    same = all(torch.equal(out_k[n], out_k2[n]) for n in out_k)
    empty = max(float((out_k[n][1] if n in ("dkeys", "dvalues") else out_k[n][:, 1]).abs().max())
                for n in out_k if n not in ("q", "dwq", "dv"))
    print(f"{label} loop of K={K}: max abs err {abs_errs}; relative to max |plain| {errs} (tol "
          f"{tol}); reruns bit-equal {same}; length-0 row's gradients max |x| {empty}")
    if not all(torch.isfinite(x).all() for x in out_k.values()):
        fail(label, "non-finite kernel output")
    if not same:
        fail(label, "two runs of the kernels differ")
    if empty != 0.0:
        fail(label, f"a length-0 memory's gradients are not zero: {empty}")
    if not max(errs.values()) <= tol:
        fail(label, f"kernels disagree with the plain mirror: {errs}")
    return st, out_k, queries, dctxs, max(abs_errs.values())


def k10_bwd_times(label, args, st, queries, dctxs, out_k):
    """Device ms of one step's kernel and of the loop's sums, beside their
    bounds: (step entry, sums entry) for the kernels line."""
    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.ops import attention as attn

    typ, att, _, mem, cdt = args
    K, N, _ = queries.shape
    S, A, Dv = mem.keys.shape[1], mem.keys.shape[2], mem.values.shape[-1]
    Hq = queries.shape[-1]
    k = K - 1
    step = lambda: attn.read_step_bwd(st, k, queries[k], st.weights[k], dctxs[k])
    plain = lambda: attn.read_step_bwd_plain(st, k, queries[k], st.weights[k], dctxs[k])
    _, v, keys, values = st.operands
    dms = device_ms(step)
    t_k, t_p = time_ms(step), time_ms(plain)
    sums = lambda: attn.read_loop_sums(st)
    sums_plain = lambda: attn.read_loop_sums_plain(st)
    s_dms, s_k, s_p = device_ms(sums, reps=5), time_ms(sums, reps=5), time_ms(sums_plain, reps=3)
    keys_read = float(mem.mask.sum())  # zero-weight (padded) keys are skipped
    # the bytes of a key, its value row counted once where the keys are the
    # values (a Luong memory without wv: one bf16 buffer)
    kb = 0 if st.shared else A * keys.element_size()
    wq_b = nbytes(st.operands[0], v)
    # a step: its keys and values read once, the query, weights and
    # cotangent, dquery and the saved rows written
    nb_step = (keys_read * (kb + Dv * values.element_size()) + wq_b
               + nbytes(queries[k], st.weights[k], dctxs[k], out_k["dquery"][k])
               + N * (S + Dv + 3 * A) * 4)
    ops_step = {"bf16": 2 * N * 2 * Hq * A + 2 * keys_read * Dv,
                "fp32": keys_read * A * (8 if v is not None else 2)}
    # the sums: the loop's rows read once, (Bahdanau's keys,) the outputs
    # written once (one gradient where the keys are the values); the terms
    # of the nonzero weights
    nb_sums = (K * N * (2 * S + A + Dv) * 4 + (nbytes(keys, v) if v is not None else 0)
               + N * S * (Dv if st.shared else A + Dv) * 4)
    ops_sums = {"bf16": 2 * K * keys_read * (Dv + (A if v is None else 0)),
                "fp32": K * keys_read * A * 8 if v is not None else 0}
    if values.dtype == torch.float32:  # the fp32 policy: every product on fp32 operands
        ops_step = {"fp32": sum(ops_step.values())}
        ops_sums = {"fp32": sum(ops_sums.values())}
    b_step, b_sums = bound(nb_step, ops_step), bound(nb_sums, ops_sums)
    sums_route = kernels.attend_sums_family(A, Dv, values.dtype)
    info = k10_bwd_build_info()
    print(f"{label} per step [N={N},S={S},A={A},Dv={Dv}]: kernel {t_k:.4f} ms (device {dms} "
          f"ms)  plain {t_p:.4f} ms  bound {b_step[0]:.5f} ms ({b_step[1]}, "
          f"{nb_step / 1e6:.2f} MB)")
    print(f"{label} sums per loop of K={K} ({sums_route} route): "
          f"{s_k:.4f} ms (device {s_dms} ms)  plain {s_p:.4f} ms  bound {b_sums[0]:.5f} ms "
          f"({b_sums[1]}, {nb_sums / 1e6:.2f} MB); the loop's backward kernels "
          f"{K * dms + s_dms:.4f} ms device")
    step_entry = dict(ms=t_k, plain_ms=t_p, library_ms=None, device_ms=dms, bound=b_step,
                      occupancy=info["occupancy"])
    sums_entry = dict(ms=s_k, plain_ms=s_p, library_ms=None, device_ms=s_dms, bound=b_sums,
                      sums_route=sums_route)
    return step_entry, sums_entry


def phase_k10_bwd(dev, report):
    """K10's backward, the Bahdanau read: a K=80 loop at N=128 (the train
    batch) on the kernels against the plain mirror, reruns bit-equal, the
    length-0 row exactly 0; one loop at S=531 (16 s, N=16); loops at N=128
    at the TCD-TIMIT presets' Dv = 512 over their audio and video memories
    (S = 197 and 150, the bimodal train step's two read loops); device ms."""
    args = k10_inputs(128, dev, seed=131)
    st, out_k, queries, dctxs, worst = k10_bwd_check(
        "K10 bwd [N=128,S=197,A=128,Dv=768]", args, K10_LOOP, seed=7)
    worst = max(worst, k10_bwd_check("K10 bwd [N=16,S=531,A=128,Dv=768]",
                                     k10_inputs(16, dev, seed=531, S=531), 8, seed=8)[-1])
    for S in (197, 150):
        worst = max(worst, k10_bwd_check(f"K10 bwd [N=128,S={S},A=128,Dv=512]",
                                         k10_inputs(128, dev, seed=512 + S, S=S, Dv=512),
                                         K10_LOOP, seed=S)[-1])
    for B, _, Ta, _, L in TRAIN_BUCKETS:  # the teacher-forced loops of phase 46
        worst = max(worst, k10_bwd_check(f"K10 bwd, train bucket [N={B},S={Ta},A=128,Dv=768]",
                                         k10_inputs(B, dev, seed=B + Ta, S=Ta), L,
                                         seed=L)[-1])
    step, sums = k10_bwd_times("K10 bwd", args, st, queries, dctxs, out_k)
    report["bahdanau_attend_bwd"] = dict(max_abs_err=worst, **step)
    report["bahdanau_attend_sums"] = dict(max_abs_err=worst, **sums)


# K11's check shapes: the audio layers at 6 s, the video layer at 6 s, the
# preset's 16 s limit
K11_SHAPES = ((128, 197), (128, 150), (4, 531))


def k11_inputs(B, T, dev, seed, nh=8, dh=64):
    """One [B, T, 3, nh, dh] bf16 product (q, k, v views) and ragged
    lengths: row 0 full, row 1 of length 0."""
    import torch

    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((B, T, 3, nh, dh), generator=g).to(torch.bfloat16)
    lens = torch.randint(1, T + 1, (B,), generator=g, dtype=torch.int32)
    lens[0], lens[1] = T, 0
    return qkv.to(dev), lens.to(dev)


_SASS = {}  # library path -> cuobjdump -sass text


def f32_instance(name):
    """Whether the mangled kernel ``name`` is the fp32 policy's instance of
    a kernel templated on its element type (or named for it): no bf16
    among the template arguments that follow the kernel's name."""
    rest = name.split("kernel", 1)[-1]
    return "f32" in name or "__nv_bfloat16" not in rest.split("Ev", 1)[0]


def build_report(phase, stem, kinds):
    """The tensor-core attention kernels of ``csrc/<stem>.cu`` as built, one
    entry per kind of ``kinds`` (label -> the parts of the mangled name,
    which carries the template widths and the mask, that a kernel of the
    kind holds): registers and spills from ``ptxas -v`` and, where
    ``cuobjdump`` is present, the count of tensor-core (HMMA) instructions.
    Fails when a kernel spills, has no HMMA or is missing."""
    import os
    import shutil

    from avsr_tpu_torch import kernels

    def kind_of(name):
        return next((k for k, parts in kinds.items() if all(p in name for p in parts)), None)

    found = {}
    for name, r in kernels.ptxas_report(stem).items():
        kind = kind_of(name)
        if kind:  # the most registers and the spills of the kind's instances
            f = found.setdefault(kind, {"registers": 0, "spill_stores": 0, "spill_loads": 0,
                                        "instances": 0})
            f["registers"] = max(f["registers"], r["registers"])
            f["spill_stores"] += r["spill_stores"]
            f["spill_loads"] += r["spill_loads"]
            f["instances"] += 1
    cuobjdump = shutil.which("cuobjdump") or os.path.join(os.path.dirname(kernels._nvcc()),
                                                          "cuobjdump")
    if os.path.exists(cuobjdump):
        lib = str(kernels.build())
        if lib not in _SASS:  # one disassembly per library, shared by the phases
            _SASS[lib] = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                                        text=True, timeout=300).stdout
        sass = _SASS[lib]
        kind = None
        for kind_ in kinds:
            found.setdefault(kind_, {})["hmma"] = 0
        for line in sass.splitlines():
            if "Function :" in line:
                kind = kind_of(line)
            elif kind and "HMMA" in line:
                found[kind]["hmma"] += 1
    else:
        print(f"{phase} build: cuobjdump not found; HMMA count not read")
    print(f"{phase} build ({stem}.cu; ptxas -v, cuobjdump -sass): {found}")
    for kind in kinds:
        r = found.get(kind, {})
        if "registers" not in r:
            fail(phase, f"no ptxas report for {kind}")
        if r["spill_stores"] or r["spill_loads"]:
            fail(phase, f"{kind} spills registers: {r}")
        if r.get("hmma", 1) == 0:
            fail(phase, f"{kind} has no tensor-core (HMMA) instruction")
    return found


def phase_k11(dev, report):
    import torch

    from avsr_tpu_torch.models import transformer as tfm

    build = build_report("K11", "encoder_attention", {
        f"attn_mma_{kind}": (f"attn_mma_{kind}ILi64E", "LengthMask")
        for kind in ("fwd", "bwd_q", "bwd_kv")})
    errs, dms_at = {}, {}
    for B, T in K11_SHAPES:
        qkv, lens = k11_inputs(B, T, dev, seed=T)
        ctx_k = tfm.encoder_self_attention(qkv, lens)
        again = tfm.encoder_self_attention(qkv, lens)
        ctx_p = tfm.encoder_self_attention_plain(qkv, lens)
        torch.cuda.synchronize()
        err = max_err(ctx_k, ctx_p)
        same = torch.equal(ctx_k, again)
        # a row of length 0: the uniform softmax over exactly T keys
        uni = max_err(ctx_k[1], qkv[1, :, 2].float().mean(dim=0).expand_as(ctx_k[1]))
        print(f"K11 [B={B},8 heads,T={T},dh=64] max abs err {err} (tol {K11_CTX_TOL}); length-0 "
              f"row against the mean of its T values: {uni}; two launches bit-equal: {same}")
        if not (torch.isfinite(ctx_k.float()).all() and err <= K11_CTX_TOL
                and uni <= K11_CTX_TOL and same):
            fail("K11", f"kernel disagrees with the plain version at B={B}, T={T}: {err}, "
                        f"length-0 row {uni}, bit-equal reruns {same}")
        errs[(B, T)] = err
        if B == 128:
            dms_at[T] = device_ms(lambda: tfm.encoder_self_attention(qkv, lens))
    qkv, lens = k11_inputs(128, 197, dev, seed=197)
    B, T, _, nh, dh = qkv.shape
    q, k, v = qkv.unbind(2)
    lib_mask = ((torch.arange(T, device=dev)[None, :] >= lens[:, None]).float()
                * -1e9).to(torch.bfloat16)[:, None, None, :]
    ctx = tfm.encoder_self_attention(qkv, lens)
    tk = time_ms(lambda: tfm.encoder_self_attention(qkv, lens))
    tp = time_ms(lambda: tfm.encoder_self_attention_plain(qkv, lens))
    tl = time_ms(lambda: sdpa(q, k, v, lib_mask))
    dms = device_ms(lambda: tfm.encoder_self_attention(qkv, lens))
    tl_dev = device_ms(lambda: sdpa(q, k, v, lib_mask))
    b = bound(nbytes(qkv, lens, ctx), 2 * B * nh * T * T * 2 * dh)
    print(f"K11 [B=128,8 heads,T=197,dh=64] kernel {tk:.4f} ms (device {dms:.4f} ms)  plain "
          f"{tp:.4f} ms  library (scaled_dot_product_attention, same mask) {tl:.4f} ms (device "
          f"{tl_dev:.4f} ms)  bound {b[0]:.5f} ms ({b[1]}); device ms at B=128 by T {dms_at}")
    report["encoder_attention_fwd"] = dict(
        max_abs_err=max(errs.values()), ms=tk, plain_ms=tp, library_ms=tl, device_ms=dms, bound=b,
        library_device_ms=tl_dev, device_ms_t150=dms_at[K11_SHAPES[1][1]],
        registers={kind: r["registers"] for kind, r in build.items()},
        hmma={kind: r.get("hmma") for kind, r in build.items()})


def k9_inputs(B, T, dev, seed, d=512, k=15):
    """The first pointwise product u [T, B, 2d] bf16, the conv module's
    bias, depthwise kernel [k, 1, d] and LayerNorm, ragged lengths: row 0
    full, row 1 of length 0."""
    import torch

    g = torch.Generator().manual_seed(seed)
    u = torch.randn((T, B, 2 * d), generator=g).to(torch.bfloat16)
    b_in = 0.1 * torch.randn((2 * d,), generator=g)
    dw = torch.randn((k, 1, d), generator=g) / k ** 0.5
    ln_scale = 1.0 + 0.1 * torch.randn((d,), generator=g)
    ln_bias = 0.1 * torch.randn((d,), generator=g)
    lens = torch.randint(1, T + 1, (B,), generator=g, dtype=torch.int32)
    lens[0], lens[1] = T, 0
    return [x.to(dev) for x in (u, b_in, dw, ln_scale, ln_bias, lens)]


def k9_launch(route, u, b_in, dw, ln_scale, ln_bias, lengths):
    """One K9 forward launch on ``route`` ("fused" or "tiles") straight
    through the library with the wrapper's operands, whatever
    ``kernels.conformer_fwd_plan`` would pick, and uncounted: the timings'
    other kernel.  -> out [T, B, d] bf16."""
    import torch

    from avsr_tpu_torch import kernels

    T, B, d2 = u.shape
    d, k = d2 // 2, dw.shape[0]
    ops = (u.contiguous(), b_in.to(torch.bfloat16).contiguous(),
           dw.float().reshape(k, -1).contiguous(), ln_scale.float().contiguous(),
           ln_bias.float().contiguous(), lengths.to(torch.int32).contiguous())
    out = torch.empty((T, B, d), dtype=torch.bfloat16, device=u.device)
    ptrs = [x.data_ptr() for x in ops] + [out.data_ptr()]
    stream = torch.cuda.current_stream(u.device).cuda_stream
    lib = kernels._load()
    if route == "fused":
        plan = kernels.conformer_fwd_plan(T, B, d, k)
        err = lib.avsr_conformer_conv_fwd_fused(*ptrs, None, T, B, d, k, plan["chunk"],
                                                plan["chunks"], stream)
    else:
        err = lib.avsr_conformer_conv(*ptrs, T, B, d, k, stream)
    kernels._raise_on(err, f"K9 {route} launch")
    return out


# K9's forward shapes: (B, T, d): lrs2_av_v2's train batch, a request's B =
# 8, the 16 s limit (B = 4, T = 531); a width past the pass over time (d =
# 1024: the tiles)
K9_SHAPES = ((128, 197, 512), (8, 197, 512), (4, 531, 512), (5, 70, 1024))


def phase_k9(dev, report):
    """K9's forward at every K9_SHAPES shape on the route
    ``kernels.conformer_fwd_plan`` gives it, against the plain twin (within
    K9_TOL + K9_ULP |plain|), a rerun bit-equal; on the pass over time, its
    LayerNorm output z against the fused backward's recompute of it, bit for
    bit, and its shared memory against ``kernels.conformer_fwd_fused_smem``;
    the device ms of both kernels at the presets' shapes, the bound, the
    plain twin and cuDNN's depthwise conv1d alone."""
    import torch
    import torch.nn.functional as F

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.models import transformer as tfm

    lib = kernels._load()
    bad = [d for d in range(8, kernels.CONV_BWD_MAX_D + 1, 8)
           if lib.avsr_conformer_conv_fwd_fused_smem(d) != kernels.conformer_fwd_fused_smem(d)]
    if bad:
        fail("K9", f"kernels.conformer_fwd_fused_smem differs from the library's at d={bad}")
    # the pass over time and its instance that also writes z for the checks
    rep = {"z" if "ILb1" in n else "out": r
           for n, r in kernels.ptxas_report("conformer_conv").items()
           if "conv_fwd_fused_kernel" in n}
    occ = lib.avsr_conformer_conv_fwd_fused_occupancy(512)
    print(f"K9 fused forward (ptxas -v): {rep}; blocks an SM at d = 512: {occ} "
          f"(kernels.CONV_FWD_CTAS_PER_SM {kernels.CONV_FWD_CTAS_PER_SM})")
    if len(rep) != 2 or any(r["spill_stores"] or r["spill_loads"] for r in rep.values()):
        fail("K9", f"the fused forward spills or is missing: {rep}")
    if occ != kernels.CONV_FWD_CTAS_PER_SM:
        fail("K9", f"an SM holds {occ} blocks of the fused forward, the plan's wave "
                   f"{kernels.CONV_FWD_CTAS_PER_SM}")
    errs = {"fused": 0.0, "tiles": 0.0}
    times = {}
    for B, T, d in K9_SHAPES:
        args = k9_inputs(B, T, dev, seed=T + B + 1, d=d)
        plan = kernels.conformer_fwd_plan(T, B, d, 15)
        route = plan["route"]
        counter = "conformer_conv_fwd" if route == "fused" else "conformer_conv_fwd_tiles"
        before = kernels.LAUNCHES[counter]
        out_k = tfm.conformer_conv(*args)
        out_k2 = tfm.conformer_conv(*args)
        out_p = tfm.conformer_conv_plain(*args)
        torch.cuda.synchronize()
        if kernels.LAUNCHES[counter] - before != 2:
            fail("K9", f"[T={T},B={B},d={d}]: two calls launched {counter} "
                       f"{kernels.LAUNCHES[counter] - before} times")
        diff = (out_k.float() - out_p.float()).abs()
        err = float(diff.max())
        errs[route] = max(errs[route], err)
        over = float((diff - K9_TOL - K9_ULP * out_p.float().abs()).max())
        same = bool(torch.equal(out_k, out_k2))
        line = (f"K9 [T={T},B={B},d={d},k=15] route {route} (chunks {plan['chunks']} of "
                f"{plan['chunk']}) max abs err {err} mean {float(diff.mean())} (tol {K9_TOL} + "
                f"{K9_ULP} |plain|: margin {-over}); rerun bit-equal {same}")
        if route == "fused":
            u, b_in, dw, ln_scale, ln_bias, lens = args
            ops = (u, b_in.to(torch.bfloat16), dw.float().reshape(15, d).contiguous(),
                   ln_scale.float(), ln_bias.float(), lens.to(torch.int32))
            z_f = torch.empty((T, B, d), device=dev)
            z_b = torch.full((T, B, d), float("nan"), device=dev)
            kernels.conformer_conv_fwd(*ops, z=z_f)
            dout = torch.randn((T, B, d), generator=torch.Generator().manual_seed(T)).to(
                torch.bfloat16).to(dev)
            kernels.conformer_conv_bwd(*ops, dout, z=z_b)
            torch.cuda.synchronize()
            z_same = bool(torch.equal(z_f, z_b))
            line += (f"; its z equals the fused backward's recompute bit for bit: {z_same} "
                     f"(backward chunks {kernels.conformer_bwd_plan(T, B, d, 15)['chunks']})")
            if not z_same:
                fail("K9", f"[T={T},B={B}]: the forward's z differs from the backward's "
                           f"recompute at {int((z_f != z_b).sum())} elements")
        print(line)
        if not (torch.isfinite(out_k.float()).all() and over <= 0.0 and same):
            fail("K9", f"kernel disagrees with the plain version at T={T}, B={B}, d={d}: {err}, "
                       f"rerun bit-equal {same}")
        if d == 512:
            times[B, T] = {r: device_ms(lambda: k9_launch(r, *args)) for r in ("fused", "tiles")}
            times[B, T]["bound"] = bound(nbytes(*args, out_k), T * B * d * (2 * 15 + 18), "fp32")
            print(f"K9 [T={T},B={B},d=512] device ms: pass over time {times[B, T]['fused']:.5f}, "
                  f"tiles {times[B, T]['tiles']:.5f}; bound {times[B, T]['bound'][0]:.5f} "
                  f"ms ({times[B, T]['bound'][1]})")
    args = k9_inputs(128, 197, dev, seed=198)
    u, _, dw, *_ = args
    T, B, d2 = u.shape
    d, k = d2 // 2, dw.shape[0]
    out = tfm.conformer_conv(*args)
    x = torch.randn((B, d, T), device=dev)
    w = dw.float()[:, 0, :].t()[:, None, :].contiguous()
    tk = time_ms(lambda: tfm.conformer_conv(*args))
    t_tiles = time_ms(lambda: k9_launch("tiles", *args))
    tp = time_ms(lambda: tfm.conformer_conv_plain(*args))
    tl = time_ms(lambda: F.conv1d(x, w, padding=k // 2, groups=d))
    dms = device_ms(lambda: tfm.conformer_conv(*args))
    # per output element: the k-tap conv (2k), the bias and GLU (~6), the
    # LayerNorm (~7) and the swish (~5), fp32
    b = bound(nbytes(*args, out), T * B * d * (2 * k + 18), "fp32")
    t8, t16 = times[8, 197], times[4, 531]
    print(f"K9 [T=197,B=128,d=512,k=15] kernel {tk:.4f} ms (device {dms:.4f} ms; tiles "
          f"{t_tiles:.4f} ms)  plain {tp:.4f} ms  library (the depthwise conv1d alone) {tl:.4f} ms "
          f" bound {b[0]:.5f} ms ({b[1]})")
    report["conformer_conv_fwd"] = dict(
        max_abs_err=errs["fused"], ms=tk, plain_ms=tp, library_ms=tl, device_ms=dms, bound=b,
        library_covers="the depthwise conv1d alone", device_ms_tiles=times[128, 197]["tiles"],
        device_ms_B8=t8["fused"], device_ms_B8_tiles=t8["tiles"], bound_B8_ms=t8["bound"][0],
        device_ms_16s=t16["fused"], device_ms_16s_tiles=t16["tiles"],
        bound_16s_ms=t16["bound"][0],
        registers=rep["out"]["registers"], blocks_per_sm=occ)
    report["conformer_conv_fwd_tiles"] = dict(
        max_abs_err=errs["tiles"], ms=t_tiles, plain_ms=tp, library_ms=tl,
        device_ms=times[128, 197]["tiles"], bound=b,
        library_covers="the depthwise conv1d alone")


def sdpa_bwd_device_ms(q, k, v, mask, dctx):
    """The library yardstick of an attention backward: the device time of
    autograd's forward and backward through scaled_dot_product_attention on
    the same [B, T, heads, d] operands and additive mask, less its forward's
    (a difference of host-clocked calls swings with the host's dispatch)."""
    import torch
    import torch.nn.functional as F

    qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    dct = dctx.transpose(1, 2).contiguous()

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
        torch.autograd.grad(out, (qs, ks, vs), dct)

    with torch.no_grad():
        t_fwd = device_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask))
    return device_ms(fwd_bwd) - t_fwd


def phase_k11_bwd(dev, report):
    import torch

    from avsr_tpu_torch.models import transformer as tfm

    errs, abs_errs, dms_at = {}, {}, {}
    for B, T in K11_SHAPES:
        qkv, lens = k11_inputs(B, T, dev, seed=T + 2)
        g = torch.Generator().manual_seed(T + 3)
        dctx = torch.randn((B, T, 8, 64), generator=g).to(torch.bfloat16).to(dev)
        ctx_k, st_k = tfm.encoder_self_attention_fwd(qkv, lens, save=True)
        ctx_k2, st_k2 = tfm.encoder_self_attention_fwd(qkv, lens, save=True)
        ctx_serve, _ = tfm.encoder_self_attention_fwd(qkv, lens, save=False)
        ctx_p, st_p = tfm.encoder_self_attention_fwd_plain(qkv, lens, save=True)
        g_k = tfm.encoder_self_attention_bwd(qkv, lens, *st_p, dctx)
        g_k2 = tfm.encoder_self_attention_bwd(qkv, lens, *st_p, dctx)
        g_p = tfm.encoder_self_attention_bwd_plain(qkv, lens, *st_p, dctx)
        # the weights as the kernel's statistics give them, against the plain ones
        w_err = max_err(tfm.encoder_self_attention_weights(qkv, lens, *st_k),
                        tfm.encoder_self_attention_weights(qkv, lens, *st_p))
        torch.cuda.synchronize()
        same = (torch.equal(ctx_k, ctx_k2) and torch.equal(ctx_k, ctx_serve)
                and all(torch.equal(a, b) for a, b in zip(st_k, st_k2))
                and torch.equal(g_k, g_k2))
        fwd = {"ctx": max_err(ctx_k, ctx_p), "P": w_err,
               "row_max": max_err(st_k[0], st_p[0]), "row_sum_rel": rel_err(st_k[1], st_p[1])}
        rel = {n: rel_err(g_k[:, :, i], g_p[:, :, i]) for i, n in enumerate(("dq", "dk", "dv"))}
        # a row of length 0 attends uniformly over its T keys: each of its
        # values takes the mean of dctx over the queries
        uni = max_err(g_k[1, :, 2], dctx[1].float().mean(dim=0).expand_as(g_k[1, :, 2]))
        print(f"K11 bwd [B={B},8 heads,T={T},dh=64] save-mode forward max abs err {fwd} (tol ctx "
              f"{K11_CTX_TOL}, P {K4_P_TOL}); dqkv relative to max |plain| {rel} (tol "
              f"{K11_GRAD_REL_TOL}); length-0 row's dv against the mean of dctx: {uni}; two "
              f"launches bit-equal (and the save-mode ctx the serving one's): {same}")
        if not (torch.isfinite(g_k.float()).all() and fwd["ctx"] <= K11_CTX_TOL
                and fwd["P"] <= K4_P_TOL and max(rel.values()) <= K11_GRAD_REL_TOL
                and uni <= K11_CTX_TOL and same):
            fail("K11 bwd", f"kernels disagree with the plain twins at B={B}, T={T}: {fwd} {rel} "
                            f"{uni}, bit-equal reruns {same}")
        errs[(B, T)] = max(rel.values())
        abs_errs[(B, T)] = max_err(g_k, g_p)
        if B == 128:
            dms_at[T] = device_ms(lambda: tfm.encoder_self_attention_bwd(qkv, lens, *st_p, dctx))
    qkv, lens = k11_inputs(128, 197, dev, seed=199)
    B, T, _, nh, dh = qkv.shape
    dctx = torch.randn((B, T, nh, dh), generator=torch.Generator().manual_seed(200))
    dctx = dctx.to(torch.bfloat16).to(dev)
    _, st = tfm.encoder_self_attention_fwd_plain(qkv, lens, save=True)
    dqkv = tfm.encoder_self_attention_bwd(qkv, lens, *st, dctx)
    tk = time_ms(lambda: tfm.encoder_self_attention_bwd(qkv, lens, *st, dctx))
    tp = time_ms(lambda: tfm.encoder_self_attention_bwd_plain(qkv, lens, *st, dctx))
    dms = device_ms(lambda: tfm.encoder_self_attention_bwd(qkv, lens, *st, dctx))
    t_save = time_ms(lambda: tfm.encoder_self_attention_fwd(qkv, lens, save=True))
    dms_save = device_ms(lambda: tfm.encoder_self_attention_fwd(qkv, lens, save=True))
    lib_mask = ((torch.arange(T, device=dev)[None, :] >= lens[:, None]).float()
                * -1e9).to(torch.bfloat16)[:, None, None, :]
    tl = sdpa_bwd_device_ms(*qkv.unbind(2), lib_mask, dctx)
    # the function's five products: the scores (recomputed: its input is the
    # statistics), dP, dQ, dK and dV
    b = bound(nbytes(qkv, lens, *st, dctx, dqkv), 5 * 2 * B * nh * T * T * dh)
    print(f"K11 bwd [B=128,8 heads,T=197,dh=64] kernel {tk:.4f} ms (device {dms:.4f} ms)  plain "
          f"{tp:.4f} ms  library (scaled_dot_product_attention backward, same mask, device) "
          f"{tl:.4f} ms  bound {b[0]:.5f} ms ({b[1]}); the save-mode forward {t_save:.4f} ms "
          f"(device {dms_save:.4f} ms); device ms at B=128 by T {dms_at}")
    report["encoder_attention_bwd"] = dict(max_abs_err=max(abs_errs.values()), ms=tk, plain_ms=tp,
                                           library_ms=tl, device_ms=dms, bound=b,
                                           max_rel_err=max(errs.values()),
                                           save_forward_ms=t_save,
                                           save_forward_device_ms=dms_save,
                                           device_ms_t150=dms_at[K11_SHAPES[1][1]])


def phase_k9_bwd(dev, report):
    import torch
    import torch.nn.functional as F

    from avsr_tpu_torch.models import transformer as tfm

    from avsr_tpu_torch import kernels

    names = ("du", "db_in", "ddw", "dln_scale", "dln_bias")
    tols = (K9_DU_REL_TOL, K9_DB_REL_TOL, K9_PARAM_REL_TOL, K9_PARAM_REL_TOL, K9_PARAM_REL_TOL)
    # the plan's shared memory against the library's, at every width the
    # fused route takes and at general ones
    lib = kernels._load()
    bad = [d for d in range(8, kernels.CONV_BWD_MAX_D + 1, 8)
           if lib.avsr_conformer_conv_bwd_fused_smem(d) != kernels.conformer_bwd_fused_smem(d)]
    bad += [(d, k) for d in (2, 200, 512, 1000, 1024) for k in (3, 15, 31)
            if lib.avsr_conformer_conv_smem(d, k) != kernels.conformer_general_smem(d, k)]
    if bad:
        fail("K9 bwd", f"the plan's shared memory differs from the library's at {bad}")
    abs_errs = {}
    # the train batch and the 16 s limit on the fused route; a width past it
    # (d = 1024: the general route's three launches)
    for B, T, d in ((128, 197, 512), (4, 531, 512), (5, 70, 1024)):
        args = k9_inputs(B, T, dev, seed=T + 5, d=d)
        lens = args[-1]
        route = kernels.conformer_bwd_plan(T, B, d, 15)["route"]
        dout = torch.randn((T, B, d), generator=torch.Generator().manual_seed(T + 6))
        dout = dout.to(torch.bfloat16).to(dev)
        g_k = tfm.conformer_conv_bwd(*args, dout)
        g_p = tfm.conformer_conv_bwd_plain(*args, dout)
        g_k2 = tfm.conformer_conv_bwd(*args, dout)
        torch.cuda.synchronize()
        rel = {n: rel_err(a, b) for n, a, b in zip(names, g_k, g_p)}
        same = all(torch.equal(a, b) for a, b in zip(g_k, g_k2))
        padded = (torch.arange(T, device=dev)[:, None] >= lens[None, :])
        pad_zero = bool((g_k[0][padded] == 0).all())
        print(f"K9 bwd [T={T},B={B},d={d},k=15] ({route}) relative to max |plain| "
              f"{ {n: f'{e:.3e}' for n, e in rel.items()} } (tol du {K9_DU_REL_TOL}, db_in "
              f"{K9_DB_REL_TOL}, ddw / dln {K9_PARAM_REL_TOL}); padded steps' du zero: "
              f"{pad_zero}; two runs bit-equal: {same}")
        if not (all(torch.isfinite(x.float()).all() for x in g_k) and pad_zero and same
                and all(rel[n] <= t for n, t in zip(names, tols))):
            fail("K9 bwd", f"kernels disagree with the plain twin at T={T}, d={d}: {rel}, "
                           f"padded rows zero {pad_zero}, deterministic {same}")
        abs_errs[(T, d)] = max(max_err(a, b) for a, b in zip(g_k, g_p))
    args = k9_inputs(128, 197, dev, seed=203)
    u, _, dw, *_ = args
    T, B, d2 = u.shape
    d, k = d2 // 2, dw.shape[0]
    dout = torch.randn((T, B, d), generator=torch.Generator().manual_seed(204))
    dout = dout.to(torch.bfloat16).to(dev)
    grads = tfm.conformer_conv_bwd(*args, dout)
    tk = time_ms(lambda: tfm.conformer_conv_bwd(*args, dout))
    tp = time_ms(lambda: tfm.conformer_conv_bwd_plain(*args, dout))
    dms = device_ms(lambda: tfm.conformer_conv_bwd(*args, dout))
    # the library yardstick covers part of the function: cuDNN's depthwise
    # conv1d backward alone (the device time of autograd's forward and
    # backward less the forward's)
    x = torch.randn((B, d, T), device=dev, requires_grad=True)
    w = dw.float()[:, 0, :].t()[:, None, :].contiguous().requires_grad_(True)
    gz = torch.randn((B, d, T), device=dev)

    def lib_fwd_bwd():
        torch.autograd.grad(F.conv1d(x, w, padding=k // 2, groups=d), (x, w), gz)

    with torch.no_grad():
        t_lib_fwd = device_ms(lambda: F.conv1d(x, w, padding=k // 2, groups=d))
    tl = device_ms(lib_fwd_bwd) - t_lib_fwd
    # per element: the forward recomputed (2k + 18), the swish and LayerNorm
    # backward (~18), the transposed conv and ddw (4k), the GLU backward (~10)
    b = bound(nbytes(*args, dout, *grads), T * B * d * (6 * k + 46), "fp32")
    print(f"K9 bwd [T=197,B=128,d=512,k=15] kernel {tk:.4f} ms (device {dms:.4f} ms)  plain "
          f"{tp:.4f} ms  library (the depthwise conv1d backward alone, device) {tl:.4f} ms  bound "
          f"{b[0]:.5f} ms ({b[1]})")
    report["conformer_conv_bwd"] = dict(max_abs_err=max(abs_errs.values()), ms=tk, plain_ms=tp,
                                        library_ms=tl, device_ms=dms, bound=b,
                                        library_covers="the depthwise conv1d backward alone")


def uni_luong_cfg():
    """``lrs2_av_align_uni_luong``: the lrs2_av_align preset with
    one-direction encoders (K2) and Luong reads in the fusion (K8) and the
    decoder (K10)."""
    from avsr_tpu_torch.configs import lrs2_full

    return lrs2_full().override({
        "audio_encoder.bidirectional": False, "video_encoder.bidirectional": False,
        "fusion.attention_type": "luong", "decoder.attention_type": "luong",
        "name": "lrs2_av_align_uni_luong"})


def k2_inputs(T, B, H, dev, seed):
    """K1's operands at G = 1 (one direction; a ragged mask with a 0-length
    row 1) and a nonzero initial state."""
    import torch

    wh, b, xw, mask, _, _ = k1_inputs(T, 1, B, H, dev, seed)
    g = torch.Generator().manual_seed(seed + 1)
    h0 = 0.5 * torch.randn((1, B, H), generator=g)
    c0 = torch.randn((1, B, H), generator=g)
    return [wh, b, xw, mask, h0.to(dev), c0.to(dev)]


def phase_k2(dev, report):
    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.ops import rnn

    bf = torch.bfloat16
    runs = {}
    for T, B in K2_SHAPES:
        args = k2_inputs(T, B, 256, dev, seed=40 + B + T)
        wh, b, xw, mask, h0, c0 = args
        H = xw.shape[-1] // 4
        out_k = rnn.bilstm_scan_core(*args, bf)
        again = rnn.bilstm_scan_core(*args, bf)
        out_p = rnn.bilstm_scan_core_plain(*args, bf)
        _, (h_res, c_res) = rnn.scan_core_fwd(*args, bf, save=True)
        g = torch.Generator().manual_seed(B + T + 2)
        cot = [torch.randn((T, 1, B, H), generator=g).to(bf).to(dev),
               torch.randn((1, B, H), generator=g).to(dev),
               torch.randn((1, B, H), generator=g).to(dev)]
        bargs = [wh, b, xw, mask, h_res, c_res, *cot, bf]
        g_k = rnn.scan_core_bwd(*bargs)
        g_again = rnn.scan_core_bwd(*bargs)
        g_p = rnn.bilstm_scan_core_bwd_plain(*bargs)
        torch.cuda.synchronize()
        e = {n: max_err(a, b_) for n, a, b_ in zip(("ys", "hT", "cT"), out_k, out_p)}
        names = ("dWh", "db", "dxw", "dh0", "dc0")
        ge = {n: rel_err(a, b_) for n, a, b_ in zip(names, g_k, g_p)}
        same = (all(torch.equal(a, b_) for a, b_ in zip(out_k, again))
                and all(torch.equal(a, b_) for a, b_ in zip(g_k, g_again)))
        # row 1 has no valid step: h0 and c0 come back as hT and cT, its
        # outputs and dxw are zero, and dhT / dcT reach h0 / c0 unchanged
        kept = lstm_kept(*out_k, h0, c0) and lstm_passed(g_k[2], g_k[3], g_k[4], cot[1], cot[2])
        family = kernels.lstm_family(1, B, H)
        print(f"K2 [T={T},G=1,B={B},H=256] family {family}: max abs err {e} (tol {K1_TOL}); bwd "
              f"relative to max |plain| { {n: f'{x:.3e}' for n, x in ge.items()} } (tol "
              f"{K1B_REL_TOL}); two launches bit-equal: {same}; the 0-length row keeps h0/c0 "
              f"and passes dhT/dcT through exactly: {kept}")
        if not (family == "cluster"
                and all(torch.isfinite(x.float()).all() for x in (*out_k, *g_k))
                and max(e.values()) <= K1_TOL and max(ge.values()) <= K1B_REL_TOL and same
                and kept):
            fail("K2", f"kernels disagree with the plain twins at T={T}, B={B}: {e}, {ge}; "
                       f"bit-equal {same}; the 0-length row kept its state: {kept}")
        dms = (device_ms(lambda: rnn.bilstm_scan_core(*args, bf)),
               device_ms(lstm_bwd_kernel(bargs)), device_ms(lambda: rnn.scan_core_bwd(*bargs)))
        print(f"K2 [T={T},B={B}] device fwd {dms[0]:.4f} ms ({dms[0] / T * 1e3:.3f} us per step), "
              f"bwd {dms[1]:.4f} ms ({dms[1] / T * 1e3:.3f} us per step; {dms[2]:.4f} ms with the "
              f"caller's dWh product)")
        runs[(T, B)] = dict(args=args, bargs=bargs, out=out_k, grads=g_k, dms=dms,
                            fwd_err=max(e.values()),
                            bwd_err=max(max_err(a, b_) for a, b_ in zip(g_k, g_p)))
    r = runs[(197, 128)]
    T, H4 = 197, 1024
    H = H4 // 4
    t = {}
    for B in (128, 8):
        a, ba = runs[(197, B)]["args"], runs[(197, B)]["bargs"]
        t[B] = (time_ms(lambda: rnn.bilstm_scan_core(*a, bf)),
                time_ms(lambda: rnn.bilstm_scan_core_plain(*a, bf), reps=3, warmup=1),
                time_ms(lambda: rnn.scan_core_bwd(*ba)),
                time_ms(lambda: rnn.bilstm_scan_core_bwd_plain(*ba), reps=3, warmup=1))
        print(f"K2 B={B} fwd kernel {t[B][0]:.4f} ms  plain {t[B][1]:.4f} ms; bwd kernel "
              f"{t[B][2]:.4f} ms  plain {t[B][3]:.4f} ms")
    flops = 2 * T * 128 * H * H4  # h @ Wh at every step
    by_shape = [{f"T={T_},B={B_}": x["dms"][i] for (T_, B_), x in runs.items()} for i in (0, 1)]
    report["lstm_scan_uni_fwd"] = dict(
        max_abs_err=max(x["fwd_err"] for x in runs.values()), ms=t[128][0], plain_ms=t[128][1],
        library_ms=None, device_ms=r["dms"][0], bound=bound(nbytes(*r["args"], *r["out"]), flops),
        per_step_us=r["dms"][0] / T * 1e3, device_ms_by_shape=by_shape[0])
    report["lstm_scan_uni_bwd"] = dict(
        max_abs_err=max(x["bwd_err"] for x in runs.values()), ms=t[128][2], plain_ms=t[128][3],
        library_ms=None, device_ms=r["dms"][1],
        bound=bound(nbytes(*r["bargs"][:9], *r["grads"][1:]), 2 * flops),
        per_step_us=r["dms"][1] / T * 1e3, device_ms_by_shape=by_shape[1],
        device_ms_with_dwh=r["dms"][2])
    for name in ("lstm_scan_uni_fwd", "lstm_scan_uni_bwd"):
        print(f"{name} [T=197,G=1,B=128,H=256] device {report[name]['device_ms']:.4f} ms  bound "
              f"{report[name]['bound'][0]:.5f} ms ({report[name]['bound'][1]})")


def k10_luong_inputs(N, dev, seed, S=197, Hq=256, Hk=512, W=1):
    """The Luong read at the lrs2_av_align_uni_luong decoder's widths: the
    top layer's h [N, Hq], ``wq`` [256, 512] and the fused memory [h ; ctx]
    of N / W rows as one bf16 tensor serving as keys and values, untiled as
    the beam search gives it, with a length-0 row (1)."""
    import torch

    from avsr_tpu_torch.ops import attention as attn

    g = torch.Generator().manual_seed(seed)
    B = N // W
    query = 0.5 * torch.randn((N, Hq), generator=g)
    att = {"wq": (torch.randn((Hq, Hk), generator=g) / Hq ** 0.5).to(dev)}
    memory = 0.5 * torch.randn((B, S, Hk), generator=g)
    lens = torch.randint(1, S + 1, (B,), generator=g)
    lens[0], lens[1] = S, 0
    mem = attn.prepare_memory("luong", att, memory.to(torch.bfloat16).to(dev), lens.to(dev),
                              torch.bfloat16)
    return ["luong", att, query.to(dev), mem, torch.bfloat16]


def phase_k10_luong(dev, report):
    # the regime cases: no preset reads Luong at the TCD-TIMIT widths; they
    # run at its own (Hk = Dv = 512) over S = 150 too
    k10_fwd_phase(dev, report, "luong_attend", "K10 Luong", k10_luong_inputs, K10L_W_TOL,
                  {"Hk": 200}, {"Hk": 272}, {})

    # backward: a K=80 loop at N = 128 (the teacher-forced decoder's reads)
    # and one at S = 531
    args = k10_luong_inputs(128, dev, seed=133)
    st, out_k, queries, dctxs, worst_abs = k10_bwd_check(
        "K10 Luong bwd [N=128,S=197,Hk=Dv=512]", args, K10_LOOP, seed=9)
    worst_abs = max(worst_abs, k10_bwd_check("K10 Luong bwd [N=16,S=531,Hk=Dv=512]",
                                             k10_luong_inputs(16, dev, seed=535, S=531), 8,
                                             seed=10)[-1])
    step, sums = k10_bwd_times("K10 Luong bwd", args, st, queries, dctxs, out_k)
    report["luong_attend_bwd"] = dict(max_abs_err=worst_abs, **step)
    report["luong_attend_sums"] = dict(max_abs_err=worst_abs, **sums)


def k8_luong_inputs(B, dev, seed, T=197, H=256, Tv=150, Dv=256):
    """K8's Luong operands at the lrs2_av_align_uni_luong fusion's widths:
    ``k8_inputs``' cell, context projection, input product and ragged masks
    (a 0-length audio row 1 and video row 2), ``wq`` [256, 256], and the
    bf16 video memory as one tensor for keys and values."""
    import torch

    from avsr_tpu_torch.ops import attention as attn

    cell, _, ctx_proj, xw, mask, mem, cdt = k8_inputs(B, dev, seed, T=T, H=H, Tv=Tv, Dv=Dv)
    g = torch.Generator().manual_seed(seed + 2)
    att = {"wq": (torch.randn((H, Dv), generator=g) / H ** 0.5).to(dev)}
    mem = attn.prepare_memory("luong", att, 0.5 * mem.values, mem.mask.sum(-1).long(), cdt)
    return [cell, att, ctx_proj, xw, mask, mem, cdt]


def phase_k8_luong(dev, report):
    from avsr_tpu_torch.models import fusion as fus

    luong = {"attention_type": "luong"}
    k8_fwd_phase(dev, report, "av_align_scan_luong", "K8 Luong", "luong", k8_luong_inputs, 53,
                 K8L_ALIGN_TOL, "H=256,Hk=Dv=256")

    # backward at B = 128, on the kernel forward's saved carries
    info = k8_bwd_build_info()
    args = k8_bwd_inputs(128, dev, seed=61, attention_type="luong")
    cell, att, ctx_proj, xw, mask, mem, aligns, res, *_, cdt = args
    err, _ = k8_bwd_against_plain("K8 Luong bwd [T_a=197,B=128,H=256,T_v=150,Hk=Dv=256]", args,
                                  "luong")
    err16, dms16 = k8_bwd_16s("luong", dev, seed=63)
    t_k = time_ms(lambda: fus.av_align_scan_bwd(*args, **luong), reps=5, warmup=1)
    t_p = time_ms(lambda: fus.av_align_scan_bwd_plain(*args, **luong), reps=2, warmup=1)
    dms = device_ms(lambda: fus.av_align_scan_bwd(*args, **luong), reps=5, warmup=1)
    split = k8_bwd_split(args, "luong")
    out_k = fus.av_align_scan_bwd(*args, **luong)
    got = (*out_k[:3], *out_k[4:])
    T, B, H4 = xw.shape
    S, Hk, Dv = mem.keys.shape[1], mem.keys.shape[2], mem.values.shape[-1]
    H = H4 // 4
    live = float(mask.sum())
    keys_read = float((mask * mem.mask.sum(-1)[None, :]).sum())
    # the regate and the carries' products every step and row; the read's q
    # and dquery products on live steps; dw, dq over the read keys (bf16
    # operands); the fp32 dkeys / dvalues products
    flops = {"bf16": 2 * T * B * 2 * (H + Dv) * H4 + 2 * live * 2 * H * Hk
             + 2 * keys_read * (Hk + Dv), "fp32": keys_read * (Hk + Dv)}
    nb = (nbytes(xw, mask, mem.values, aligns, *res, *args[8:13], *got[:6])
          + 2 * (H * H4 + Dv * H4 + H * Hk) + 4 * H4)
    b = bound(nb, flops)
    print(f"K8 Luong bwd B=128 kernel {t_k:.4f} ms (device {dms} ms; stages apart: {split})  "
          f"plain {t_p:.4f} ms  bound {b[0]:.5f} ms ({b[1]}, {nb / 1e6:.2f} MB)")
    report["av_align_scan_luong_bwd"] = dict(
        max_abs_err=max(err, err16), ms=t_k, plain_ms=t_p, library_ms=None, device_ms=dms,
        bound=b, device_ms_stages=split, device_ms_T531_B16=dms16,
        recurrence={k: o for k, o in info["occupancy"].items() if k.startswith("luong")})


def phase_core_route(dev):
    """One head width per attention kernel that has no tensor-core instance,
    run on the CUDA-core kernels (``kernels.attention_family`` "core")
    through the module's autograd Function, forward and backward, against
    the plain twins on the same operands: K11 at dh=32 (d=512, 16 heads),
    K4 at A=dv=64, K5's self attention at dh=32 and its cross attention at
    (dk, dv) = (64, 128), ragged with a length-0 row; and K10's read loop
    (both reads, K=8) at widths whose memory sums run on the CUDA cores
    (``kernels.attend_sums_family`` "cuda_core")."""
    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.models import fusion as fus
    from avsr_tpu_torch.models import transformer as tfm
    from avsr_tpu_torch.models import transformer_decoder as tdec

    def grads(fn, *xs, dout):
        xs = [x.detach().clone().requires_grad_(True) for x in xs]
        out = fn(*xs)
        out = out[0] if isinstance(out, tuple) else out
        out.backward(dout)
        return out.detach(), [x.grad for x in xs]

    cases = []
    qkv, lens = k11_inputs(32, 197, dev, seed=32, nh=16, dh=32)
    dctx = torch.randn((32, 197, 16, 32), generator=torch.Generator().manual_seed(33))
    dctx = dctx.to(torch.bfloat16).to(dev)
    ctx_p, st_p = tfm.encoder_self_attention_fwd_plain(qkv, lens, save=True)
    cases.append(("K11 [B=32,16 heads,T=197,dh=32]", ("encoder_attention", 32, 32),
                  grads(lambda x: tfm.EncoderSelfAttention.apply(x, lens), qkv, dout=dctx),
                  (ctx_p, [tfm.encoder_self_attention_bwd_plain(qkv, lens, *st_p, dctx)]),
                  K11_CTX_TOL, K11_GRAD_REL_TOL))
    q, k, v, vlen, dctx = k4_inputs(32, 4, 50, 150, 64, dev, seed=64)
    ctx_p, _, st_p = fus.fusion_attention_fwd_plain(q, k, v, vlen, save=True)
    cases.append(("K4 [B=32,4 heads,T_a=50,T_v=150,A=dv=64]", ("fusion_attention", 64, 64),
                  grads(lambda a, b, c: fus.FusionAttention.apply(a, b, c, vlen), q, k, v,
                        dout=dctx),
                  (ctx_p, fus.fusion_attention_bwd_plain(q, k, v, vlen, *st_p, dctx)),
                  K4_CTX_TOL, K4_GRAD_REL_TOL))
    for label, (Q, S, dk, dv, causal) in (("K5 self", (80, 80, 32, 32, True)),
                                          ("K5 cross", (80, 50, 64, 128, False))):
        q, k, v, bias, dctx = k5_inputs(32, Q, S, dk, dv, dev, causal, seed=dk + dv)
        ctx_p, st_p = tdec.decoder_attention_fwd_plain(q, k, v, bias, save=True)
        kind = "decoder_self_attention" if causal else "decoder_cross_attention"
        cases.append((f"{label} [B=32,Q={Q},S={S},4 heads,dk={dk},dv={dv}]", (kind, dk, dv),
                      grads(lambda a, b, c: tdec.DecoderAttention.apply(a, b, c, bias), q, k, v,
                            dout=dctx),
                      (ctx_p, tdec.decoder_attention_bwd_plain(q, k, v, bias, *st_p, dctx)),
                      K5_CTX_TOL, K5_GRAD_REL_TOL))
    for label, route, (ctx_k, g_k), (ctx_p, g_p), ctx_tol, grad_tol in cases:
        family = kernels.attention_family(*route)
        err = max_err(ctx_k, ctx_p)
        rel = max(rel_err(a, b) for a, b in zip(g_k, g_p))
        print(f"core route {label}: family {family}; ctx max abs err {err} (tol {ctx_tol}); "
              f"gradients relative to max |plain| {rel} (tol {grad_tol})")
        if family != "core" or not (torch.isfinite(ctx_k.float()).all() and err <= ctx_tol
                                    and rel <= grad_tol):
            fail("core route", f"{label}: family {family}, ctx err {err}, gradients {rel}")
    # K10's read loop at widths the tensor-core sums do not take: the
    # per-step kernel and the CUDA-core sums against the plain mirror
    for label, args in (("K10 bwd [N=32,S=197,A=40,Dv=72]",
                         k10_inputs(32, dev, seed=40, A=40, Dv=72)),
                        ("K10 Luong bwd [N=32,S=197,Hk=Dv=72]",
                         k10_luong_inputs(32, dev, seed=72, Hk=72))):
        A, Dv = args[3].keys.shape[-1], args[3].values.shape[-1]
        family = kernels.attend_sums_family(A, Dv)
        print(f"core route {label}: sums family {family}")
        if family != "cuda_core":
            fail("core route", f"{label}: sums family {family}")
        k10_bwd_check(f"core route {label}", args, 8, seed=A + Dv)


def phase_lstm_step_route(dev):
    """The per-step LSTM kernels (``kernels.lstm_family`` "step") at H = 512,
    forward and backward, against the plain twins: G = 2 and G = 1 (a
    nonzero h0/c0), T = 50, B = 20, ragged with a 0-length row."""
    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.ops import rnn

    bf = torch.bfloat16
    T, B, H = 50, 20, 512
    for G in (2, 1):
        args = k1_inputs(T, 2, B, H, dev, seed=H) if G == 2 else k2_inputs(T, B, H, dev, seed=H)
        family = kernels.lstm_family(G, B, H)
        out_k = rnn.bilstm_scan_core(*args, bf)
        out_p = rnn.bilstm_scan_core_plain(*args, bf)
        _, (h_res, c_res) = rnn.scan_core_fwd(*args, bf, save=True)
        g = torch.Generator().manual_seed(G)
        cot = [torch.randn((T, G, B, H), generator=g).to(bf).to(dev),
               torch.randn((G, B, H), generator=g).to(dev),
               torch.randn((G, B, H), generator=g).to(dev)]
        bargs = [*args[:4], h_res, c_res, *cot, bf]
        g_k = rnn.scan_core_bwd(*bargs)
        g_p = rnn.bilstm_scan_core_bwd_plain(*bargs)
        torch.cuda.synchronize()
        e = max(max_err(a, b_) for a, b_ in zip(out_k, out_p))
        ge = max(rel_err(a, b_) for a, b_ in zip(g_k, g_p))
        kept = (lstm_kept(*out_k, args[4], args[5])
                and lstm_passed(g_k[2], g_k[3], g_k[4], cot[1], cot[2]))
        print(f"LSTM step route [T={T},G={G},B={B},H={H}]: family {family}; fwd max abs err {e} "
              f"(tol {K1_TOL}); bwd relative to max |plain| {ge} (tol {K1B_REL_TOL}); the "
              f"0-length row kept its state: {kept}")
        if not (family == "step" and all(torch.isfinite(x.float()).all() for x in (*out_k, *g_k))
                and e <= K1_TOL and ge <= K1B_REL_TOL and kept):
            fail("LSTM step route", f"G={G}: family {family}, fwd {e}, bwd {ge}, kept {kept}")


def phase_align_step_route(dev):
    """K8 at widths the cluster kernels do not take.  The forward's per-step
    kernels (``kernels.av_align_family`` "step") against the plain twin:
    Bahdanau at A=64 (q's A/16 columns a CTA would not fill an n-tile) and
    Luong at Hk=Dv=192 (nor would they there, and a ctx tile row of 24
    chunks), [T_a=50, B=20, H=256, T_v=60], ragged with a 0-length audio and
    video row; the backward's per-step route (``av_align_bwd_family``
    "step") at A=72 and Luong Hk=Dv=192 against its twin, with its device
    ms a call, and a train step through it at both widths."""
    for label, kind, make, tol in (
            ("K8 step route [T_a=50,B=20,H=256,T_v=60,A=64,Dv=512]", "bahdanau",
             lambda: k8_inputs(20, dev, 70, T=50, Tv=60, A=64), K8_ALIGN_TOL),
            ("K8 Luong step route [T_a=50,B=20,H=256,T_v=60,Hk=Dv=192]", "luong",
             lambda: k8_luong_inputs(20, dev, 71, T=50, Tv=60, Dv=192), K8L_ALIGN_TOL)):
        k8_fwd_check(label, make(), kind, tol, route="step")
    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.models import fusion as fus

    # the backward at widths the cluster recurrence refuses: its
    # per-step route against the plain twin, then a train step through it
    for label, kind, widths in (
            ("K8 step bwd [T_a=50,B=20,H=256,T_v=60,A=72,Dv=512]", "bahdanau", {"A": 72}),
            ("K8 Luong step bwd [T_a=50,B=20,H=256,T_v=60,Hk=Dv=192]", "luong", {"Dv": 192})):
        args = k8_bwd_inputs(20, dev, 72, attention_type=kind, T=50, Tv=60, **widths)
        mem = args[5]
        route = kernels.av_align_bwd_family(256, mem.values.shape[-1], mem.keys.shape[-1], 60,
                                            mem.values.shape[-1], kind == "luong")
        if route != "step":
            fail("K8 step bwd", f"{label}: routed to {route}")
        k8_bwd_against_plain(label, args, kind)
        kw = {"attention_type": kind}
        dev_ms = device_ms(lambda: fus.av_align_scan_bwd(*args, **kw))
        plain = time_ms(lambda: fus.av_align_scan_bwd_plain(*args, **kw), reps=3, warmup=1)
        print(f"{label} device {dev_ms:.4f} ms a call ({dev_ms / 50 * 1e3:.2f} us a step); "
              f"plain {plain:.3f} ms")
    steps = {name: r for name, r in kernels.ptxas_report("av_align_scan").items()
             if any(k in name for k in ("align_regate_kernel", "align_bwd_product_kernel",
                                        "align_bwd_row_kernel"))}
    kinds = ("align_regate_kernel", "align_bwd_product_kernel", "align_bwd_row_kernel")
    short = {next(k for k in kinds if k in n) + ("<luong>" if "ILb1E" in n else "")
             + ("<f32>" if f32_instance(n) else ""): r for n, r in steps.items()}
    print(f"K8 step bwd build (ptxas -v; CUDA cores): {short}")
    # the bf16 instances (the row launch at both reads) and the fp32 ones
    # (the Bahdanau read): 4 + 3
    if len(steps) != 7 or any(r["spill_stores"] or r["spill_loads"] for r in steps.values()):
        fail("K8 step bwd", f"the per-step backward's kernels missing or spilling: {steps}")
    align_step_train(dev)


def align_step_train(dev):
    """One AV-Align fusion train step (forward, loss, backward through
    ``AVAlignScan``) at a Bahdanau width (A = 72) and a Luong width (Hk = Dv =
    192) that the cluster recurrence refuses, [T_a=50, B=20, H=256,
    T_v=60], ragged with a 0-length audio and video row: every gradient leaf
    present, finite and nonzero, K8's forward and backward launched, and
    each leaf against the same step with the plain twins (``fusion.av_align_scan_fwd``
    / ``_bwd`` swapped for ``_plain``) within ``K8B_REL_TOL`` of its largest value."""
    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.configs import FusionConfig
    from avsr_tpu_torch.models import fusion as fus
    from avsr_tpu_torch.utils.params import tree_leaves

    T, B, D, H, Tv = 50, 20, 512, 256, 60
    for label, kind, Hv, cfg in (
            ("K8 step train [A=72, Dv=512]", "bahdanau", 512,
             FusionConfig(attention_units=72, au_loss_weight=1.0, au_dim=2)),
            ("K8 Luong step train [Hk=Dv=192]", "luong", 192,
             FusionConfig(attention_type="luong", au_loss_weight=1.0, au_dim=2))):
        g = torch.Generator().manual_seed(Hv)
        params = fus.av_align_init(g, cfg, D, H, Hv, dev)
        audio = torch.randn((T, B, D), generator=g).to(dev)
        video = torch.randn((B, Tv, Hv), generator=g).to(dev)
        a_len = torch.randint(1, T + 1, (B,), generator=g)
        v_len = torch.randint(1, Tv + 1, (B,), generator=g)
        a_len[0], a_len[1], v_len[0], v_len[2] = T, 0, Tv, 0
        a_len, v_len = a_len.to(dev), v_len.to(dev)
        cot = torch.randn((T, B, H + Hv), generator=g).to(dev)

        def step():
            leaves = [x.detach().clone().requires_grad_(True)
                      for _, x in tree_leaves(params) if torch.is_tensor(x)]
            leaves += [audio.clone().requires_grad_(True), video.clone().requires_grad_(True)]
            it = iter(leaves)
            p = tree_map_like(params, it)
            out = fus.av_align_apply(p, cfg, leaves[-2], a_len, leaves[-1], v_len,
                                     torch.bfloat16)
            loss = (out.fused * cot).sum() + out.au_predictions.float().square().sum()
            return torch.autograd.grad(loss, leaves, allow_unused=True)

        names = ["/".join(map(str, path)) for path, x in tree_leaves(params)
                 if torch.is_tensor(x)] + ["audio", "video"]
        before = dict(kernels.LAUNCHES)
        got = step()
        torch.cuda.synchronize()
        suffix = "_luong" if kind == "luong" else ""
        ran = {n: kernels.LAUNCHES[n] - before[n]
               for n in (f"av_align_scan{suffix}", f"av_align_scan{suffix}_bwd")}
        saved = fus.av_align_scan_fwd, fus.av_align_scan_bwd
        fus.av_align_scan_fwd, fus.av_align_scan_bwd = (fus.av_align_scan_fwd_plain,
                                                        fus.av_align_scan_bwd_plain)
        try:
            want = step()
        finally:
            fus.av_align_scan_fwd, fus.av_align_scan_bwd = saved
        torch.cuda.synchronize()
        bad = [n for n, x in zip(names, got)
               if x is None or not torch.isfinite(x).all() or not bool(x.abs().max() > 0)]
        errs = {n: rel_err(a, b) for n, a, b in zip(names, got, want) if a is not None}
        print(f"{label} [T_a={T},B={B},H={H},T_v={Tv}]: {len(names)} gradient leaves, missing, "
              f"non-finite or zero: {bad}; K8 launches {ran}; relative to the plain twins' step "
              f"(max abs error over max |plain|): {errs} (tol {K8B_REL_TOL})")
        if bad or not all(ran.values()) or not max(errs.values()) <= K8B_REL_TOL:
            fail("K8 step train", f"{label}: leaves {bad}, launches {ran}, errors {errs}")


def eval_records(tmp, cfg, seed=7):
    """Write a synthetic eval corpus (48 utterances of 4-12 characters at
    0.4 s each, 1.6-4.8 s) and a two-type noise bank (``babble`` and
    ``cafe``: ``synthetic.make_noise_bank`` rows of 10 s, one record file a
    type, as the JAX package's CLI writes banks) under ``tmp`` with the
    port's record writer; read them back -> (a record source of the
    corpus, {type: [N, L] float32})."""
    import os

    from avsr_tpu_torch.data import grain_loader, synthetic, tfrecord

    spec = synthetic.SyntheticSpec(num_utterances=48, min_chars=4, max_chars=12,
                                   char_duration_s=0.4, seed=seed)
    corpus = os.path.join(tmp, "eval.tfrecord")
    tfrecord.write_dataset(synthetic.generate(spec), corpus, video_codec="uint8")
    banks = {}
    for i, ntype in enumerate(cfg.noise.noise_types):
        path = os.path.join(tmp, f"noise_{ntype}.tfrecord")
        rows = synthetic.make_noise_bank(num_rows=4, row_samples=160_000, seed=seed + 1 + i)
        tfrecord.write_dataset([synthetic.Utterance(uid=f"noise{j}", transcript="", waveform=r)
                                for j, r in enumerate(rows)], path)
        banks[ntype] = np.stack([u.waveform for u in tfrecord.read_dataset(path)])
    return grain_loader.TFRecordDataSource(corpus), banks


def phase_eval_noisy(dev, card, cfg, label="eval_noisy", needed=EVAL_NOISY_KERNELS):
    """The records-to-CER eval of ``cfg``'s full-width model (random
    weights from a seeded generator) at three conditions, clean, babble
    0 dB and cafe -5 dB, as the JAX package's
    ``Trainer.evaluate_noise_matrix`` runs them: records through the
    bucketing loader, ``to_model_batch`` onto the card, the fixed-SNR encode
    (``eval_snr``), ``loss_given_encode`` and the width-10 beam on the same
    encode, hypotheses scored by ``ErrorRateAccumulator``.  The card's mixed
    waveform of one batch is held against the same batch mixed on the CPU
    (the draws are the host's, equal by construction)."""
    import dataclasses
    import tempfile

    import torch

    from avsr_tpu_torch import kernels, native
    from avsr_tpu_torch.data import loader
    from avsr_tpu_torch.data.units import builtin_unit_dict
    from avsr_tpu_torch.decode.beam import beam_search
    from avsr_tpu_torch.eval.metrics import ErrorRateAccumulator
    from avsr_tpu_torch.models import encoder as enc
    from avsr_tpu_torch.models import seq2seq
    from avsr_tpu_torch.ops import noise as noise_ops
    from avsr_tpu_torch.utils.numerics import compute_dtype_of

    units = builtin_unit_dict(cfg.data.unit)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        source, banks = eval_records(tmp, cfg)
        au_stacking = ((cfg.audio.frame_stacking, cfg.audio.frame_skipping)
                       if cfg.fusion.au_loss_weight > 0 else None)
        eval_loader = loader.BucketingLoader(
            source, units, cfg.data, require_audio=True, require_video=True,
            frame_step=cfg.audio.frame_step, frame_length=cfg.audio.frame_length,
            au_target_stacking=au_stacking, au_dim=cfg.fusion.au_dim)
        batches = list(eval_loader.epoch(shuffle=False))
    t_data = (time.perf_counter() - t0) * 1e3
    bank = noise_ops.NoiseBank.create(banks, device=dev)
    params = seq2seq.model_init(cfg, units.vocab_size, torch.Generator().manual_seed(0), dev)
    H = cfg.audio_encoder.hidden_units[-1]
    Dv = enc.encoder_output_dim(cfg.video_encoder)
    S_v = max(nb["video"].shape[1] for _, nb in batches)
    print(f"{label}: {len(source)} records, {len(batches)} batches "
          f"{[(b, nb['audio'].shape, nb['num_real']) for b, nb in batches]}, noise bank "
          f"{ {t: a.shape for t, a in banks.items()} }; records + loader {t_data:.3f} ms; host "
          f"framing and scoring on the {'native library' if native.available() else 'Python path'}"
          f"; K8 route {kernels.av_align_family(H, Dv, cfg.fusion.attention_units, S_v, Dv)!r} "
          f"at [H={H}, A={cfg.fusion.attention_units}, T_v={S_v}, Dv={Dv}]")

    # (3) the card's mix of one batch against the CPU's: same host draws
    nb = batches[0][1]
    b = loader.to_model_batch(nb, device=dev)
    wav = b.audio.float() / 32767.0 if b.audio.dtype == torch.int16 else b.audio
    mixes = {}
    for where, w, ln, bk in (("card", wav, b.audio_lengths, bank),
                             ("cpu", wav.cpu(), b.audio_lengths.cpu(),
                              noise_ops.NoiseBank.create(banks))):
        mixes[where] = noise_ops.mix_fixed_snr(w, ln, bk, -5.0, noise_type="cafe",
                                               uid_hashes=b.uid_hashes)
    mix_err = max_err(mixes["card"].cpu(), mixes["cpu"])
    moved = max_err(mixes["cpu"], wav.cpu())
    print(f"{label} fixed-SNR mix [B={wav.shape[0]}, S={wav.shape[1]}, cafe -5 dB]: card vs CPU "
          f"max abs err {mix_err:.3e} (tol {MIX_TOL}); the mix moved the waveform by {moved:.3f}")
    if not (mix_err <= MIX_TOL and moved > 0.1):
        fail(label, f"the card's fixed-SNR mix disagrees with the CPU's: {mix_err}")

    def run(ccfg, snr):
        acc = ErrorRateAccumulator()
        losses, weights = [], []
        ev = None if snr is None else torch.tensor(snr, dtype=torch.float32)
        with torch.no_grad():
            for _, nb in batches:
                batch = loader.to_model_batch(nb, device=dev)
                out = seq2seq.encode(params, ccfg, batch, noise_bank=bank, eval_snr=ev)
                _, metrics = seq2seq.loss_given_encode(params, ccfg, batch, out)
                res = beam_search(params["decoder"], ccfg.decoder, out.memories,
                                  ccfg.decode.max_decode_length,
                                  beam_width=ccfg.decode.beam_width,
                                  length_penalty=ccfg.decode.length_penalty,
                                  cdt=compute_dtype_of(ccfg))
                ids = res.ids.numpy()
                n_real = nb["num_real"]
                losses.append(float(metrics["loss"]))
                weights.append(int(np.minimum(nb["target_lengths"][:n_real],
                                              nb["targets"].shape[1]).sum()))
                for j in range(n_real):
                    acc.update(nb["references"][j], units.decode(ids[j]), nb["uids"][j])
        summary = acc.summary()
        summary["loss"] = float(np.average(losses, weights=np.maximum(weights, 1)))
        return summary

    conditions = (("clean", None, None), ("babble_0dB", "babble", 0.0),
                  ("cafe_-5dB", "cafe", -5.0))
    cfgs = {tag: cfg.replace(noise=dataclasses.replace(
        cfg.noise, eval_snr_db=snr, eval_noise_type=ntype or cfg.noise.eval_noise_type))
        for tag, ntype, snr in conditions}
    run(cfgs["babble_0dB"], 0.0)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    results = {}
    for tag, _, snr in conditions:
        t0 = time.perf_counter()
        summary = run(cfgs[tag], snr)
        torch.cuda.synchronize()
        summary["ms"] = (time.perf_counter() - t0) * 1e3
        results[tag] = summary
    launches = dict(kernels.LAUNCHES)
    print(f"{label} launches over the three conditions {launches}")
    for name in needed:
        if launches[name] == 0:
            fail(label, f"kernel {name} was not launched by the eval pass")
    check_other_route(label, launches)
    for tag, r in results.items():
        if not (np.isfinite(r["loss"]) and 0.0 <= r["cer"] and r["num_utterances"] == len(source)):
            fail(label, f"{tag}: {r}")
        print(f"{label} [{card}] {cfg.name} {tag}: CER {r['cer']:.4f} WER {r['wer']:.4f} loss "
              f"{r['loss']:.4f} over {r['num_utterances']} utterances, {len(batches)} batches; "
              f"{r['ms']:.3f} ms ({r['ms'] / len(batches):.3f} ms per batch of "
              f"{cfg.data.batch_size})")
    if results["clean"]["loss"] == results["cafe_-5dB"]["loss"]:
        fail(label, "the noisy condition left the loss unchanged: no noise was mixed")
    return launches


def trainer_records(tmp, n_train, n_eval, seconds, seed=31, bank_rows=4, bank_samples=160_000):
    """Write a synthetic train and eval corpus of ``seconds`` (min, max)
    utterances (0.4 s a character) and a babble / cafe noise bank (one
    record file a type) under ``tmp`` with the port's record writer ->
    (train path, eval path, ((type, bank path), ...))."""
    import os

    from avsr_tpu_torch.data import synthetic, tfrecord

    chars = (int(round(seconds[0] / 0.4)), int(round(seconds[1] / 0.4)))
    paths = []
    for name, n, s in (("train", n_train, seed), ("eval", n_eval, seed + 1)):
        spec = synthetic.SyntheticSpec(num_utterances=n, min_chars=chars[0], max_chars=chars[1],
                                       char_duration_s=0.4, seed=s)
        paths.append(os.path.join(tmp, f"{name}.tfrecord"))
        tfrecord.write_dataset(synthetic.generate(spec), paths[-1], video_codec="uint8")
    banks = []
    for i, ntype in enumerate(("babble", "cafe")):
        rows = synthetic.make_noise_bank(num_rows=bank_rows, row_samples=bank_samples,
                                         seed=seed + 2 + i)
        banks.append((ntype, os.path.join(tmp, f"noise_{ntype}.tfrecord")))
        tfrecord.write_dataset([synthetic.Utterance(uid=f"{ntype}{j}", transcript="", waveform=r)
                                for j, r in enumerate(rows)], banks[-1][1])
    return paths[0], paths[1], tuple(banks)


def instrument_steps(trainer, records, count_syncs=False):
    """Wrap ``trainer._train_step``: each step appends (its loss as a device
    tensor, CUDA events before and after it, the synchronizing calls it
    made under ``torch.cuda.set_sync_debug_mode("warn")`` or None, its
    bucket) to ``records``.  Neither the events nor the stored loss wait on
    the card."""
    import warnings

    import torch

    inner = trainer._train_step

    def step(bucket, batch):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        syncs = None
        start.record()
        if count_syncs:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    metrics = inner(bucket, batch)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            syncs = sum("synchroniz" in str(w.message) for w in seen)
        else:
            metrics = inner(bucket, batch)
        end.record()
        records.append((metrics["loss"].detach(), start, end, syncs, bucket))
        return metrics

    trainer._train_step = step


def timed_prefetch(waits):
    """A ``loader.prefetch`` that appends to ``waits`` the host milliseconds
    the train loop waited for each batch of the prefetch thread."""
    from avsr_tpu_torch.data import loader

    def wrapped(iterator, depth=2):
        it = loader.prefetch(iterator, depth)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            waits.append((time.perf_counter() - t0) * 1e3)
            yield item

    return wrapped


def warmup_losses(trainer, losses):
    """Wrap ``trainer.warmup``: the loss of each of its steps (a device
    tensor) is appended to ``losses``."""
    from avsr_tpu_torch.train import loop

    inner, step = trainer.warmup, loop.step_lib.train_step

    def train_step(*args, **kwargs):
        state, metrics = step(*args, **kwargs)
        losses.append(metrics["loss"].detach())
        return state, metrics

    def warmup():
        with mock.patch.object(loop.step_lib, "train_step", train_step):
            return inner()

    trainer.warmup = warmup


def timed_method(obj, name, times):
    """Wrap ``obj.name``: each call appends its host milliseconds to ``times``."""
    inner = getattr(obj, name)

    def call(*args, **kwargs):
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(obj, name, call)


def state_tensors(state):
    from avsr_tpu_torch.utils.params import tree_leaves

    opt = state.opt_state
    return ([t for _, t in tree_leaves(state.params)]
            + [m for k in ("mu", "nu", "trace") if k in opt for m in opt[k]])


def phase_trainer_align(dev, card, cfg, label="trainer_align", needed=TRAINER_ALIGN_KERNELS,
                        n_train=288, n_eval=48, seconds=(1.6, 6.0), n_predict=4, work=None,
                        keep=None):
    """The ``AVSR`` API on ``cfg``'s model (the full-width ``lrs2_av_align``
    preset, random weights from its seed) from synthetic records: an
    uninterrupted run A (warm-up, 2 epochs with checkpoints every 2 steps
    and a beam eval an epoch); run B, the same, stopped by ``request_stop``
    after the first step of epoch 2; run C, a new ``AVSR`` over B's run
    directory that resumes it (``train(try_restore_latest_checkpoint=
    True)``), then ``average_checkpoints``, ``evaluate(checkpoint="best")``,
    the clean / babble 0 dB / cafe 0 dB noise matrix and
    ``predict(n_best=3)``.  Returns the launches of all of it.  With
    ``work`` the runs are written there and kept, and ``keep["align"]`` is
    run C's ``AVSR`` (phase 49 exports it)."""
    import json
    import os
    from unittest import mock

    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.avsr import AVSR
    from avsr_tpu_torch.data import tfrecord

    with work_dir(work) as tmp:
        train_path, eval_path, banks = trainer_records(tmp, n_train, n_eval, seconds)
        cfg = cfg.override({"data.audio_train_records": train_path,
                            "data.audio_eval_records": eval_path,
                            "train.save_every_steps": 2, "train.num_epochs": 2,
                            "noise.bank_records": [list(b) for b in banks]})
        predict_utts = tfrecord.read_dataset(eval_path)[:n_predict]

        def avsr(name):
            return AVSR(config=cfg, run_dir=os.path.join(tmp, name), device=dev)

        torch.cuda.synchronize()
        kernels.reset_launches()
        t_phase = time.perf_counter()
        a = avsr("A")
        loader = a.trainer.train_loader
        steps_a, warm_a, saves_a, waits_a, warm_loss = [], [], [], [], []
        instrument_steps(a.trainer, steps_a, count_syncs=True)
        warmup_losses(a.trainer, warm_loss)
        timed_method(a.trainer, "warmup", warm_a)
        write = a.trainer.ckpt._write

        def timed_write(step, state):
            t0 = time.perf_counter()
            write(step, state)
            d = a.trainer.ckpt._step_dir(step)
            saves_a.append(((time.perf_counter() - t0) * 1e3,
                            sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)) / 1e6))

        a.trainer.ckpt._write = timed_write
        with mock.patch("avsr_tpu_torch.train.loop.prefetch", timed_prefetch(waits_a)):
            a.train()
        torch.cuda.synchronize()
        n_epoch = len(steps_a) // 2
        buckets = [x[4] for x in steps_a]
        print(f"{label} data: {n_train} train / {n_eval} eval records of {seconds[0]}-"
              f"{seconds[1]} s; buckets of the steps {buckets} (batch sizes "
              f"{[loader.batch_size_for(b) for b in buckets]}); checkpoints "
              f"{a.trainer.ckpt.all_steps()}")
        if (a.trainer._host_step != 2 * n_epoch or n_epoch < 2
                or sorted(buckets[:n_epoch]) != sorted(buckets[n_epoch:])):
            fail(label, f"run A took {a.trainer._host_step} steps of 2 epochs: buckets {buckets}")

        # run B: stopped after the first step of epoch 2
        b = avsr("B")
        stop_at = n_epoch + 1
        inner = b.trainer._train_step

        def stopping(bucket, batch):
            metrics = inner(bucket, batch)
            if b.trainer._host_step + 1 == stop_at:
                b.trainer.request_stop()
            return metrics

        b.trainer._train_step = stopping
        b.train()
        saved = [t.clone() for t in state_tensors(b.trainer.state)]
        saved_meta = (b.trainer.state.step, b.trainer.state.opt_state["count"])
        # run C: a new session resumes B's run directory
        c = avsr("B")
        steps_c, warm_c = [], []
        restored = {}
        inner_restore = c.trainer.restore_checkpoint

        def restore(step=None):
            out = inner_restore(step)
            restored["equal"] = (
                all(torch.equal(x, y) for x, y in zip(state_tensors(c.trainer.state), saved))
                and (c.trainer.state.step, c.trainer.state.opt_state["count"]) == saved_meta)
            restored["at"] = (out, c.trainer.epoch, c.trainer._resume_batches)
            return out

        c.trainer.restore_checkpoint = restore
        instrument_steps(c.trainer, steps_c)
        warmup_losses(c.trainer, warm_loss)
        timed_method(c.trainer, "warmup", warm_c)
        c.train(try_restore_latest_checkpoint=True)
        torch.cuda.synchronize()
        if restored.get("at") != (stop_at, 1, 1) or not restored["equal"]:
            fail(label, f"resume: restored {restored}, expected step {stop_at}, epoch 1, 1 batch, "
                        "the saved state bit for bit")
        losses_a = [float(x[0]) for x in steps_a]
        losses_c = [float(x[0]) for x in steps_c]
        rel = [abs(x - y) / abs(y) for x, y in zip(losses_c, losses_a[stop_at:])]
        bit_equal = losses_c == losses_a[stop_at:]
        print(f"{label} resume: run B stopped at step {stop_at} (epoch 1, 1 batch); run C "
              f"restored step, epoch, batches {restored['at']}, state bit-equal to the saved "
              f"one: {restored['equal']}; C's losses {[round(x, 5) for x in losses_c]} against "
              f"A's {[round(x, 5) for x in losses_a[stop_at:]]}: rel diff "
              f"{[f'{r:.2e}' for r in rel]} (tol {RESUME_LOSS_REL_TOL}); bit-equal {bit_equal}")
        if len(losses_c) != n_epoch - 1 or not max(rel) <= RESUME_LOSS_REL_TOL:
            fail(label, "the resumed run's losses left the uninterrupted run's")
        warm = [float(x) for x in warm_loss]
        n_buckets = len(loader.bucket_shapes())
        print(f"{label} warm-up losses (a step per bucket, runs A and C): "
              f"{[round(x, 4) for x in warm]}")
        if not (np.isfinite(losses_a).all() and np.isfinite(losses_c).all()
                and np.isfinite(warm).all() and len(warm) == 2 * n_buckets):
            fail(label, f"non-finite losses or missing warm-up steps: A {losses_a}, C {losses_c}, "
                        f"warm-up {warm} ({n_buckets} buckets, 2 runs)")

        # every checkpoint on disk complete, its extra beside it, best.json
        for run, tr in (("A", a.trainer), ("B", c.trainer)):
            steps = tr.ckpt.all_steps()
            missing = [s for s in steps for f in ("params.npz", "opt_state.npz", "meta.json")
                       if not os.path.exists(os.path.join(tr.ckpt.directory, str(s), f))]
            missing += [f"extra_{s}.json" for s in steps
                        if not os.path.exists(os.path.join(tr.ckpt.directory, f"extra_{s}.json"))]
            if not steps or missing or not os.path.exists(os.path.join(tr.run_dir, "best.json")):
                fail(label, f"run {run}: checkpoints {steps}, missing {missing} or best.json")

        new_step = c.trainer.average_checkpoints()
        with open(os.path.join(c.trainer.run_dir, "best.json")) as f:
            best = json.load(f)
        ev_best = c.evaluate(checkpoint="best")
        if c.trainer._host_step != best["step"]:
            fail(label, f"evaluate(checkpoint='best') left step {c.trainer._host_step}, "
                        f"best.json names {best['step']}")
        matrix = c.evaluate_noise_matrix(snrs=(None, 0.0))
        nbest = c.predict(predict_utts, n_best=3)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        if keep is not None:
            keep["align"] = c
        seconds_all = time.perf_counter() - t_phase
        with open(os.path.join(a.trainer.run_dir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]

    step_ms = [s.elapsed_time(e) for _, s, e, _, _ in steps_a]
    syncs = [x[3] for x in steps_a]
    fps = [r["frames_per_sec"] for r in records if r["kind"] == "epoch"]
    evals = [r for r in records if r["kind"] == "eval"]
    print(f"{label} [{card}] {cfg.name}: train ms a step (CUDA events, run A) "
          f"{[round(x, 3) for x in step_ms]}, median after the first "
          f"{statistics.median(step_ms[1:]):.3f}; epoch frames/s (10 ms audio frames) "
          f"{[round(x) for x in fps]}; losses {[round(x, 4) for x in losses_a]}")
    print(f"{label} syncs a step between log steps (set_sync_debug_mode warn): {syncs}; the "
          f"loop's host wait for each batch of the prefetch thread, ms "
          f"{[round(x, 1) for x in waits_a]}")
    print(f"{label} warmup (one step per bucket, {len(loader.bucket_shapes())} buckets): run A "
          f"{[round(x / 1e3, 3) for x in warm_a]} s, run C {[round(x / 1e3, 3) for x in warm_c]} s")
    print(f"{label} checkpoint save (params.npz, opt_state.npz, meta.json; run A): ms "
          f"{[round(ms, 1) for ms, _ in saves_a]}, median "
          f"{statistics.median(ms for ms, _ in saves_a):.1f}; {saves_a[-1][1]:.2f} MB a step")
    for r in evals:
        print(f"{label} in-loop eval epoch {int(r['epoch'])} (run A): CER {r['cer']:.4f} loss "
              f"{r['loss']:.4f}, {r['seconds']} s, {r['utterances_per_sec']} utterances/s")
    print(f"{label} average_checkpoints -> step {new_step}; evaluate(checkpoint='best') step "
          f"{best['step']} (CER {best['cer']:.4f} in-loop): CER {ev_best['cer']:.4f}, "
          f"{ev_best['seconds']} s, {ev_best['utterances_per_sec']} utterances/s")
    for tag, r in matrix.items():
        print(f"{label} noise matrix [{card}] {tag}: CER {r['cer']:.4f} WER {r['wer']:.4f} loss "
              f"{r['loss']:.4f} over {r['num_utterances']} utterances, {r['seconds']} s, "
              f"{r['utterances_per_sec']} utterances/s")
    print(f"{label} predict n_best=3: {[(u, [h for h, _ in alts][:3]) for u, alts in nbest]}")
    print(f"{label} launches {launches}; {seconds_all:.1f} s")
    for name in needed:
        if launches[name] == 0:
            fail(label, f"kernel {name} was not launched by the API run")
    check_other_route(label, launches)
    bad = [t for t, r in matrix.items() if not np.isfinite(r["loss"])]
    if bad or set(matrix) != {"clean", "babble_0dB", "cafe_0dB"} or len(nbest) != n_predict \
            or any(len(alts) != 3 for _, alts in nbest):
        fail(label, f"noise matrix {sorted(matrix)} (non-finite {bad}) or predict {nbest}")
    return launches


def work_dir(work):
    """``work`` as a context (kept after it), or a temporary directory."""
    import tempfile

    return contextlib.nullcontext(work) if work else tempfile.TemporaryDirectory()


def run_cli(argv):
    """``cli.main(argv)`` in this process (the kernel counters see its
    launches): (its standard output, seconds)."""
    import io

    from avsr_tpu_torch import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    if rc != 0:
        fail("cli", f"{argv[0]} returned {rc}")
    return out.getvalue(), time.perf_counter() - t0


def phase_cli_fast(dev, card, preset="lrs2_av_fast", label="cli_fast", needed=CLI_FAST_KERNELS,
                   n_train=160, n_eval=32, extra_sets=(), work=None, keep=None):
    """The CLI on ``preset`` at full width, in process: ``write-records``
    (synthetic train and eval corpora of 1.6-6 s), ``show-config`` with the
    records and 1 epoch set, ``train``, ``train --resume --epochs 2``,
    ``evaluate --greedy``, ``average-checkpoints`` and ``decode``, each on
    ``--device`` of ``dev``.  Returns the launches of the commands after
    ``show-config``.  With ``work`` the run is written there and kept, and
    ``keep["fast"]`` is the run's arguments (phase 49 exports it)."""
    import json
    import os

    import torch

    from avsr_tpu_torch import kernels

    with work_dir(work) as tmp:
        paths = {}
        for name, n, seed in (("train", n_train, 41), ("eval", n_eval, 42)):
            paths[name] = os.path.join(tmp, f"{name}.tfrecord")
            run_cli(["write-records", "--synthetic", str(n), "--out", paths[name], "--seed",
                     str(seed), "--min-chars", "4", "--max-chars", "15", "--char-duration",
                     "0.4", "--video-codec", "uint8"])
        sets = [f"data.audio_train_records={paths['train']}",
                f"data.audio_eval_records={paths['eval']}", "train.num_epochs=1", *extra_sets]
        cfg_json, _ = run_cli(["show-config", "--preset", preset,
                               *[x for s in sets for x in ("--set", s)]])
        cfg_path = os.path.join(tmp, "cfg.json")
        with open(cfg_path, "w") as f:
            f.write(cfg_json)
        run = ["--config", cfg_path, "--run-dir", os.path.join(tmp, "run"), "--device", str(dev)]
        if keep is not None:
            keep["fast"] = run
        torch.cuda.synchronize()
        kernels.reset_launches()
        results = {}
        for name, argv in (("train", ["train", *run]),
                           ("resume", ["train", *run, "--resume", "--epochs", "2"]),
                           ("evaluate_greedy", ["evaluate", *run, "--greedy"]),
                           ("average", ["average-checkpoints", *run, "--last", "2"]),
                           ("decode", ["decode", *run])):
            out, secs = run_cli(argv)
            results[name] = (json.loads(out.strip().splitlines()[-1]), secs)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        with open(os.path.join(tmp, "run", "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
    fps = [round(r["frames_per_sec"]) for r in records if r["kind"] == "epoch"]
    for name, (res, secs) in results.items():
        res = res.get("final", res)
        keys = {k: (round(v, 4) if isinstance(v, float) else v) for k, v in res.items()}
        print(f"{label} [{card}] {preset} {name}: {secs:.2f} s; {keys}")
    print(f"{label} epoch frames/s (10 ms audio frames) {fps}; launches {launches}")
    for name in needed:
        if launches[name] == 0:
            fail(label, f"kernel {name} was not launched by the CLI run")
    check_other_route(label, launches)
    final = results["resume"][0]["final"]
    if results["average"][0]["averaged_step"] < 2 or not all(
            np.isfinite(r.get("final", r).get("loss", 0.0)) for r, _ in results.values()
            if r.get("final", r)) or final.get("num_utterances") != n_eval:
        fail(label, f"results {results}")
    return launches


def phase_export(dev, card, keep, work, label="export"):
    """Phase 49: the serving artifacts from phases 46-47's runs, in the 2, 6
    and 10 s buckets (``SERVE_SECONDS``) at B = 8, compact transfer:
    ``lrs2_av_fast`` through ``cli export --seconds 2,6,10 --n-best 3``
    (its latest checkpoint), ``lrs2_av_align`` through
    ``export_serving_artifact`` (run C's state) with the beam and greedy.
    Each is loaded by ``load_predictor`` onto the card and decodes a B = 8
    ragged request in each bucket (routed there by its lengths), its ids
    and scores bit-equal to the in-process ``Predictor`` on the same
    parameters (the fast checkpoint restored by a new ``AVSR``) and the same
    padded batch, and so are its internals (``artifact_internals``);
    ``transcribe`` / ``transcribe_nbest`` give those ids' texts; then ``cli
    transcribe`` of ``.wav`` and ``.npy`` files from the fast artifact.
    Returns the launches of each artifact's own decodes (label
    ``artifact_*``; the reference's decodes and the checks after them are
    not counted) and of the command (``cli_transcribe``), the needed
    kernels held as each path's."""
    import os

    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.avsr import AVSR
    from avsr_tpu_torch.configs import ExperimentConfig
    from avsr_tpu_torch.serve import (BucketedPredictor, Predictor, export_serving_artifact,
                                      load_predictor)
    from avsr_tpu_torch.utils.params import tree_map

    outs, secs = {}, {}
    t0 = time.perf_counter()
    outs["artifact_fast"] = os.path.join(work, "artifact_fast")
    out, _ = run_cli(["export", *keep["fast"], "--out", outs["artifact_fast"], "--seconds",
                      ",".join(str(x) for x in SERVE_SECONDS), "--n-best", "3"])
    if json.loads(out.strip().splitlines()[-1]) != {"artifact": outs["artifact_fast"]}:
        fail(label, f"cli export printed {out!r}")
    secs["artifact_fast"] = time.perf_counter() - t0
    align = keep["align"]
    for name, use_beam in (("artifact_align", True), ("artifact_align_greedy", False)):
        t0 = time.perf_counter()
        outs[name] = export_serving_artifact(align, os.path.join(work, name), use_beam=use_beam,
                                             audio_seconds=SERVE_SECONDS)
        secs[name] = time.perf_counter() - t0
    keep["artifacts"] = outs

    # the parameters in process: the fast run's latest checkpoint restored by
    # the checkpoint code (not the artifact's loader), run C's live state
    run = keep["fast"]
    with open(run[run.index("--config") + 1]) as f:
        fast_cfg = ExperimentConfig.from_json(f.read())
    fast = AVSR(config=fast_cfg, run_dir=run[run.index("--run-dir") + 1], device=dev)
    fast.trainer.state, _, step = fast.trainer.ckpt.restore(fast.trainer.state)
    fast.trainer._host_step = int(step)

    # the train state's tensors without their gradient flag, as the loaded
    # ones are (on the CPU a convolution over a weight that requires a
    # gradient takes another route, which rounds otherwise)
    def detached(params):
        return tree_map(lambda t: t.detach(), params)

    refs = {"artifact_fast": (fast, True, 3, ARTIFACT_FAST_KERNELS),
            "artifact_align": (align, True, 1, ARTIFACT_ALIGN_KERNELS),
            "artifact_align_greedy": (align, False, 1, ARTIFACT_GREEDY_KERNELS)}
    rng = np.random.default_rng(49)
    results = {}
    for name, out in outs.items():
        avsr, use_beam, n_best, needed = refs[name]
        mb = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(out)
                 for f in fs) / 1e6
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = load_predictor(out, device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        metas = [p.meta for p in getattr(pred, "buckets", ())]
        if not isinstance(pred, BucketedPredictor) or [m["audio_seconds"] for m in metas] != [
                float(x) for x in SERVE_SECONDS] or any(
                (m["use_beam"], m["n_best"], m["transfer"], m["checkpoint_step"])
                != (use_beam, n_best, "compact", avsr.trainer._host_step) for m in metas):
            fail(name, f"loaded {type(pred).__name__} with buckets {metas}")
        print(f"{name} [{card}] {avsr.config.name}: export {secs[name]:.2f} s, {mb:.1f} MB, "
              f"load {t_load:.2f} s ({len(pred.buckets)} buckets, checkpoint step "
              f"{metas[0]['checkpoint_step']}, use_beam {use_beam}, n_best {n_best})")
        launches = dict.fromkeys(kernels.LAUNCHES, 0)
        for bucket, sec, low in zip(pred.buckets, SERVE_SECONDS, (1.6,) + SERVE_SECONDS[:-1]):
            audio, video = request(rng, 8, seconds=float(sec), low=low)
            if pred._pick(audio, video) is not bucket:
                fail(name, f"a request of {low}-{sec} s was not routed to the {sec} s bucket")
            arrays, _ = bucket.assemble(audio, video)
            ref = Predictor(detached(avsr.trainer.state.params), avsr.config, avsr.unit_dict,
                            device=dev, batch_size=8, audio_seconds=sec, transfer="compact",
                            use_beam=use_beam, n_best=n_best)
            want = ref(**arrays)
            # the counts hold the artifact's own decodes and nothing else
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            got = bucket(**arrays)
            ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            for k, v in kernels.LAUNCHES.items():
                launches[k] += v
            got, want = (got if n_best > 1 else (got,)), (want if n_best > 1 else (want,))
            if not all(np.array_equal(a, b) for a, b in zip(got, want)):
                fail(name, f"{sec} s bucket: the artifact's ids / scores differ from the "
                           "in-process Predictor's on the same parameters and batch")
            held = artifact_internals(name, sec, bucket, ref, arrays, rng)
            texts = [bucket.decode_ids(got[0][i, 0] if n_best > 1 else got[0][i])
                     for i in range(8)]
            if n_best > 1:
                alts = pred.transcribe_nbest(audio=audio, video=video)
                bad = [a for i, a in enumerate(alts) if a[0][0] != texts[i]
                       or [s_ for _, s_ in a] != [float(x) for x in got[1][i]]]
            else:
                bad = [t for t, want_t in zip(pred.transcribe(audio=audio, video=video), texts)
                       if t != want_t]
            if bad:
                fail(name, f"{sec} s bucket: transcribe gave {bad}, not the ids' texts")
            print(f"{name} bucket {sec} s [{card}]: B=8 ragged {low}-{sec} s, artifact decode "
                  f"{ms:.1f} ms; ids{' and scores' if n_best > 1 else ''} bit-equal to the "
                  f"in-process Predictor, and {held}; sample {texts[0][:40]!r}")
        print(f"{name} launches (the artifact's decodes alone) {launches}")
        for k in needed:
            if launches[k] == 0:
                fail(name, f"kernel {k} was not launched by the artifact's decodes")
        check_other_route(name, launches)
        results[name] = launches
        if name == "artifact_fast":
            results["cli_transcribe"] = cli_transcribe(dev, card, pred, out,
                                                       os.path.join(work, "media"), rng)
    return results


def artifact_internals(name, sec, bucket, ref, arrays, rng, n_tokens=24):
    """Holds, bit for bit, what an artifact's ids alone may hide (a beam that
    stops on EOS, a greedy row of repeats): every tensor of the encoder's
    memories, the search's whole result (its scores, lengths and step
    count), and for an RNN decoder the teacher-forced logits over
    ``n_tokens`` random tokens, of the loaded ``bucket`` against the
    in-process ``ref`` on the same padded ``arrays``.  Returns what it held,
    as text."""
    import torch

    from avsr_tpu_torch.models import decoder

    enc, enc_ref = bucket.encode(arrays), ref.encode(arrays)
    pairs = [(f"memory {i}.{f}", getattr(m, f), getattr(r, f))
             for i, (m, r) in enumerate(zip(enc.memories, enc_ref.memories))
             for f in m._fields if getattr(m, f) is not None]
    res = bucket.beam(enc) if bucket.use_beam else bucket.greedy(enc)
    res_ref = ref.beam(enc_ref) if ref.use_beam else ref.greedy(enc_ref)
    pairs += [(f"result.{f}", getattr(res, f), getattr(res_ref, f)) for f in res._fields]
    held = [f"memories ({len(enc.memories)})", f"the {'beam' if bucket.use_beam else 'greedy'}"
            f" result ({', '.join(res._fields)})"]
    if not decoder._is_transformer(bucket.cfg.decoder):
        vocab = bucket.params["decoder"]["embedding"].shape[0]
        tokens = torch.as_tensor(rng.integers(3, vocab, (8, n_tokens)), device=bucket.device)
        lengths = torch.full((8,), n_tokens, dtype=torch.int32, device=bucket.device)
        with torch.inference_mode():
            logits = [decoder.teacher_forced_logits(p.params["decoder"], p.cfg.decoder, tokens,
                                                    lengths, e.memories, p._cdt)
                      for p, e in ((bucket, enc), (ref, enc_ref))]
        pairs.append(("teacher-forced logits", *logits))
        held.append(f"teacher-forced logits over {n_tokens} random tokens (spread "
                    f"{float(logits[0].std()):.3f})")
    bad = [k for k, a, b in pairs
           if not (torch.equal(a, b) if torch.is_tensor(a) else a == b)]
    if bad:
        fail(name, f"{sec} s bucket: the artifact's {bad} differ from the in-process "
                   "Predictor's")
    if bucket.use_beam:
        held.append(f"scores {[round(float(x), 4) for x in res.scores[:3]]}...")
    return "; ".join(held)


def cli_transcribe(dev, card, pred, artifact, media, rng, needed=ARTIFACT_FAST_KERNELS):
    """``cli transcribe`` of a ``.wav`` and two ``.npy`` waveforms with
    ``.npy`` ROI videos from the fast artifact, ``--n-best 2``: its lines
    name the files in order and hold ``pred.transcribe_nbest``'s
    hypotheses and scores on the same files.  Returns the command's own
    launches (its artifact load and decode)."""
    import os
    import wave

    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.data.ingest import load_wav

    os.makedirs(media, exist_ok=True)
    audio, video = request(rng, 3, seconds=9.0, low=1.6)
    files, videos = [], []
    for i, (a, v) in enumerate(zip(audio, video)):
        if i == 0:
            files.append(os.path.join(media, "u0.wav"))
            with wave.open(files[-1], "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes(np.clip(np.round(a * 32767.0), -32768, 32767)
                              .astype("<i2").tobytes())
        else:
            files.append(os.path.join(media, f"u{i}.npy"))
            np.save(files[-1], a)
        videos.append(os.path.join(media, f"v{i}.npy"))
        np.save(videos[-1], v[..., 0])  # [T, h, w]: the command adds the channel
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out, _ = run_cli(["transcribe", "--artifact", artifact, *files,
                      *[x for v in videos for x in ("--video", v)], "--n-best", "2",
                      "--device", str(dev)])
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    lines = [json.loads(line) for line in out.strip().splitlines()]
    want = pred.transcribe_nbest(audio=[load_wav(files[0])] + [np.load(f) for f in files[1:]],
                                 video=[np.load(v)[..., None] for v in videos])
    got = [(line["file"], line["text"], [(a["text"], a["score"]) for a in line["alternatives"]])
           for line in lines]
    if got != [(f, w[0][0], w[:2]) for f, w in zip(files, want)]:
        fail("cli_transcribe", f"lines {got} against {want}")
    print(f"cli_transcribe [{card}]: {len(lines)} files (.wav, .npy; .npy ROIs) in {secs:.2f} s "
          f"(artifact load included); lines equal transcribe_nbest's; launches {launches}")
    for k in needed:
        if launches[k] == 0:
            fail("cli_transcribe", f"kernel {k} was not launched by the command")
    check_other_route("cli_transcribe", launches)
    return launches


def phase_serve_http(dev, card, artifact, label="serve_http", needed=SERVE_HTTP_KERNELS, n=24,
                     max_wait_ms=20.0, n_best=3):
    """Phase 50: ``serve_host.make_server(artifact, port=0)`` on 127.0.0.1
    in a thread, the fast n-best artifact of phase 49 on the card: ``n``
    ragged 1.6-9 s single-utterance requests on the compact wire (base64
    int16 PCM and uint8 ROIs) from ``n`` concurrent client threads, then the
    same from one client in sequence (each a batch of one: its
    transcription alone), then the concurrent run once more under the
    profiler.  Every reply must be 200, ``/stats`` must count fewer batches
    than requests under concurrency and one a request in sequence, the
    sequential replies of the shortest, a middle and the longest utterance
    must equal ``transcribe_nbest`` of it alone, at most
    ``SERVE_MAX_DIFF_TEXTS`` concurrent replies may differ from the
    sequential ones (the text, or the score of a hypothesis both n-best
    lists hold by more than ``SERVE_SCORE_RTOL``, relatively), every reply
    must be bit-equal to its utterance decoded alone in the bucket its batch
    took, and no two utterances' n-best lists may be equal.  Prints p50 /
    p90 request latency at 1 and ``n`` clients, utterances/s, utterances a
    batch, hits per bucket and the device busy share of the concurrent run.
    Returns the launches."""
    import base64
    import threading
    import urllib.error
    import urllib.request

    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.serve_host import make_server

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server, batcher = make_server(artifact, port=0, max_wait_ms=max_wait_ms, device=dev)
    t_load = time.perf_counter() - t0
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    pred = batcher._pred
    hits, routes = {}, {}  # per run: decodes a bucket; utterance length -> its bucket
    pick = pred._pick

    def counted(audio, video):
        p = pick(audio, video)
        hits[p.meta["audio_seconds"]] = hits.get(p.meta["audio_seconds"], 0) + 1
        routes.update((len(a), p.meta["audio_seconds"]) for a in audio)
        return p

    pred._pick = counted
    audio, video = request(np.random.default_rng(50), n, seconds=9.0, low=1.6)
    wire = [(np.clip(np.round(a * 32767.0), -32768, 32767).astype(np.int16),
             np.round(v * 255.0).astype(np.uint8)) for a, v in zip(audio, video)]

    def b64(x):
        return base64.b64encode(x.tobytes()).decode()

    bodies = [json.dumps({"audio": [{"b64": b64(a), "dtype": "int16"}],
                          "video": [{"b64": b64(v), "dtype": "uint8", "shape": list(v.shape)}],
                          "n_best": n_best}).encode() for a, v in wire]

    def post(body):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/transcribe", data=body,
                                     headers={"Content-Type": "application/json"})
        t = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                status, reply = r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            status, reply = e.code, json.loads(e.read())
        return status, reply, (time.perf_counter() - t) * 1e3

    def stats():
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=60) as r:
            return json.loads(r.read())

    def concurrent():
        got = [None] * n

        def client(i):
            got[i] = post(bodies[i])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        return got, time.perf_counter() - t

    order = np.argsort([len(a) for a in audio])
    probes = [int(order[0]), int(order[n // 2]), int(order[-1])]
    try:
        for i in probes:  # warm-up: each bucket once, the worker thread's first decodes
            post(bodies[i])
        torch.cuda.synchronize()
        kernels.reset_launches()
        s0 = stats()
        hits.clear()
        routes.clear()
        conc, wall_c = concurrent()
        s1 = stats()
        hits_c, route_c = dict(hits), dict(routes)
        hits.clear()
        routes.clear()
        seq, t = [], time.perf_counter()
        for body in bodies:
            seq.append(post(body))
        wall_s = time.perf_counter() - t
        s2 = stats()
        hits_s, route_s = dict(hits), dict(routes)
        # the host span is the run's wall clock: the worker thread, not this
        # one, makes the torch calls
        prof = {}
        dev_events, _ = device_events(lambda: prof.update(wall=concurrent()[1]))
        span = prof["wall"] * 1e6
    finally:
        server.shutdown()
        batcher.close()
        server.server_close()
        thread.join(timeout=30)
    launches = dict(kernels.LAUNCHES)
    pred._pick = pick
    bad = [(i, st, r) for i, (st, r, _) in enumerate(conc + seq) if st != 200]
    if bad:
        fail(label, f"replies not 200: {bad[:3]}")
    d_c = {k: s1[k] - s0[k] for k in ("requests", "batches", "utterances")}
    d_s = {k: s2[k] - s1[k] for k in ("requests", "batches", "utterances")}
    if not (d_c["requests"] == d_s["requests"] == d_s["batches"] == n
            and d_c["batches"] < n):
        fail(label, f"/stats under concurrency {d_c}, in sequence {d_s}")

    def alts(reply):  # [(text, score), ...] of the reply's one utterance
        return [(t, s_) for t, s_ in reply["alternatives"][0]]

    alone = [pred.transcribe_nbest(audio=[wire[i][0]], video=[wire[i][1]])[0][:n_best]
             for i in probes]
    if alone != [alts(seq[i][1]) for i in probes]:
        fail(label, f"sequential replies {[alts(seq[i][1]) for i in probes]} are not the "
                    f"utterances' n-best alone {alone}")
    # against the utterance alone (its own bucket): a reply differs when its
    # text does, or the score of a hypothesis both n-best lists hold does
    # (near-tied lower ranks may trade places)
    def dist(a, b):
        if a[0][0] != b[0][0]:
            return float("inf")
        sb = dict(b)
        return max(abs(x - sb[t]) / max(abs(x), abs(sb[t]), 1e-30) for t, x in a if t in sb)

    own = [dist(alts(conc[i][1]), alts(seq[i][1])) for i in range(n)]
    diff = [i for i in range(n) if own[i] > SERVE_SCORE_RTOL]
    same = [d for d in own if d != float("inf")]
    # against the utterance alone in the bucket its coalesced batch took:
    # the same program on the same row, so bit-equal whatever its partners;
    # a reply delivered to the wrong client shows unless two utterances'
    # n-best lists are equal, which fails too
    keys = [len(a) for a, _ in wire]
    if len(set(keys)) != n or set(route_c) != set(keys) or set(route_s) != set(keys):
        fail(label, f"utterance lengths {keys} are not one a request, or a run's routes "
                    f"{route_c} / {route_s} miss one")
    buckets = {p.meta["audio_seconds"]: p for p in pred.buckets}
    in_bucket = [alts(seq[i][1]) if route_s[k] == route_c[k] else
                 buckets[route_c[k]].transcribe_nbest(audio=[wire[i][0]],
                                                      video=[wire[i][1]])[0][:n_best]
                 for i, k in enumerate(keys)]
    moved = [i for i in range(n) if alts(conc[i][1]) != in_bucket[i]]
    twins = [(i, j) for i in range(n) for j in range(i + 1, n) if in_bucket[i] == in_bucket[j]]
    busy, share = busy_share(dev_events, span)
    lat_c = [ms for _, _, ms in conc]
    lat_s = [ms for _, _, ms in seq]

    def pct(x):
        return f"p50 {np.percentile(x, 50):.1f} ms, p90 {np.percentile(x, 90):.1f} ms"

    print(f"{label} [{card}] {n} requests of one 1.6-9 s utterance, fast n-best artifact, "
          f"max_wait_ms {max_wait_ms}, max_batch {batcher.max_batch}; server start "
          f"{t_load:.2f} s")
    print(f"{label} [{card}] {n} concurrent clients: {pct(lat_c)}; {n / wall_c:.2f} "
          f"utterances/s ({wall_c:.2f} s); {d_c['batches']} batches, "
          f"{d_c['utterances'] / d_c['batches']:.2f} utterances a batch; hits per bucket "
          f"{dict(sorted(hits_c.items()))}")
    print(f"{label} [{card}] 1 client in sequence: {pct(lat_s)}; {n / wall_s:.2f} "
          f"utterances/s ({wall_s:.2f} s); {d_s['batches']} batches; hits per bucket "
          f"{dict(sorted(hits_s.items()))}")
    print(f"{label} [{card}] concurrent run under the profiler: host span {span / 1e3:.1f} ms, "
          f"device busy {busy / 1e3:.1f} ms, busy share {share:.3f}")
    print(f"{label} concurrent replies differing from the utterance's alone (the text, or "
          f"a shared hypothesis's score by more than {SERVE_SCORE_RTOL:.4g} relative): "
          f"{len(diff)} of {n} (tol {SERVE_MAX_DIFF_TEXTS}) {diff}; of the {len(same)} with "
          f"the same text, {sum(d == 0.0 for d in same)} bit-equal, the others' relative "
          f"score distances {[f'{d:.3g}' for d in sorted(d for d in same if d)]}; "
          f"sequential = transcribe_nbest alone at {len(probes)} probes; launches {launches}")
    print(f"{label} concurrent replies against the utterance alone in the bucket its batch "
          f"took ({sum(route_s[k] != route_c[k] for k in keys)} decoded again there): "
          f"{n - len(moved)} of {n} bit-equal (texts and scores); utterances with equal n-best "
          f"lists {twins}")
    if len(diff) > SERVE_MAX_DIFF_TEXTS:
        fail(label, f"{len(diff)} concurrent replies differ from the utterances' alone")
    if moved or twins:
        fail(label, f"replies {moved} are not their utterance's in the same bucket, or "
                    f"utterances {twins} cannot be told apart by their replies")
    for k in needed:
        if launches[k] == 0:
            fail(label, f"kernel {k} was not launched by the HTTP requests")
    check_other_route(label, launches)
    return launches


# ---------------------------------------------------------------------------
# the encoder's cell options: recurrent dropout on K1 / K2, GRU cells on K12,
# residual and highway layers (phases 51-56)
# ---------------------------------------------------------------------------


def rd_residual_cfg():
    """``lrs2_av_align_rd_residual``: the lrs2_av_align preset with
    variational recurrent dropout 0.2 in both encoders (K1 with a mask in
    training) and residual audio layers (layers 1-2 of the 3 x 256 BiLSTM,
    512 -> 512; layer 0, 720 -> 512, and the video layer, 128 -> 512, take
    no wrapper)."""
    from avsr_tpu_torch.configs import lrs2_full

    return lrs2_full().override({
        "audio_encoder.recurrent_dropout_rate": 0.2, "video_encoder.recurrent_dropout_rate": 0.2,
        "audio_encoder.residual": True, "name": "lrs2_av_align_rd_residual"})


def gru_highway_cfg():
    """``lrs2_av_align_gru_highway``: the lrs2_av_align preset with GRU cells
    in both encoders (K12) and highway audio layers (a gate on layers 1-2)."""
    from avsr_tpu_torch.configs import lrs2_full

    return lrs2_full().override({
        "audio_encoder.cell_type": "gru", "video_encoder.cell_type": "gru",
        "audio_encoder.highway": True, "name": "lrs2_av_align_gru_highway"})


# the two paths' (T, B) at G = 2, H = 256: the train step's audio (197) and
# video (150) layers at B = 128 and a serve request's at B = 8; the train
# buckets' audio and video steps (what the Trainer would call); G = 1 at the
# train step's audio and the 16 s limit; the per-step route at H = 80
RNN_OPTION_SHAPES = ((197, 128), (150, 128), (197, 8), (150, 8))
RNN_OPTION_BUCKET_SHAPES = tuple(sorted({(T, B) for B, _, Ta, Tv, _ in TRAIN_BUCKETS
                                         for T in (Ta, Tv)} - set(RNN_OPTION_SHAPES)))
RNN_OPTION_UNI_SHAPES = ((197, 128), (531, 4))
RNN_OPTION_STEP_ROUTE = ((50, 2, 20), (50, 1, 20))  # (T, G, B) at H = 80
RD_KEEP = 0.8  # the masks' keep: 1/keep = 1.25 is not a power of two
# masked train path: K1 with the mask only; its serve path the unmasked K1
TRAIN_RD_KERNELS = ("lstm_scan_rd_fwd", "lstm_scan_rd_bwd", "logmel_post_dft", "av_align_scan",
                    "av_align_scan_bwd", "bahdanau_attend_row", "bahdanau_attend_bwd",
                    "bahdanau_attend_sums")
SERVE_RD_KERNELS = SERVE_ALIGN_KERNELS
TRAIN_GRU_KERNELS = ("gru_scan_fwd", "gru_scan_bwd", "logmel_post_dft", "av_align_scan",
                     "av_align_scan_bwd", "bahdanau_attend_row", "bahdanau_attend_bwd",
                     "bahdanau_attend_sums")
SERVE_GRU_KERNELS = ("gru_scan_fwd", "logmel_post_dft", "av_align_scan",
                     "bahdanau_attend_grouped", "beam_step")


def rd_mask(G, B, H, dev, seed):
    """A recurrent-dropout mask [G, B, H]: 0 or 1/RD_KEEP."""
    import torch

    g = torch.Generator().manual_seed(seed)
    return ((torch.rand((G, B, H), generator=g) < RD_KEEP).float() / RD_KEEP).to(dev)


def k12_inputs(T, G, B, H, dev, seed):
    """K12's operands: Wh [G, H, 3H], b, the bf16 input product, a ragged
    mask with a 0-length row 1 (the backward stream flipped at G = 2) and
    h0 (zero at G = 2, as a bidirectional layer starts; nonzero at G = 1)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    wh = torch.randn((G, H, 3 * H), generator=g) / H ** 0.5
    b = 0.1 * torch.randn((G, 3 * H), generator=g)
    xw = torch.randn((T, G, B, 3 * H), generator=g).to(torch.bfloat16)
    lengths = torch.randint(1, T + 1, (B,), generator=g)
    lengths[0] = T
    if B > 1:
        lengths[1] = 0
    m = (torch.arange(T)[:, None] < lengths[None, :]).float()
    mask = torch.stack([m, torch.flip(m, (0,))], dim=1)[:, :G]
    h0 = torch.zeros((G, B, H)) if G == 2 else 0.5 * torch.randn((G, B, H), generator=g)
    return [x.to(dev) for x in (wh, b, xw, mask, h0)]


def rnn_option_cases():
    """(G, H, T, B) of phases 51-52, the full width's first."""
    return ([(2, 256, T, B) for T, B in RNN_OPTION_SHAPES + RNN_OPTION_BUCKET_SHAPES]
            + [(1, 256, T, B) for T, B in RNN_OPTION_UNI_SHAPES]
            + [(G, 80, T, B) for T, G, B in RNN_OPTION_STEP_ROUTE])


def phase_k1_rd(dev, report):
    """K1 / K2 under a recurrent-dropout mask, forward (save mode) and
    backward, against the masked plain twins."""
    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.ops import rnn

    bf = torch.bfloat16
    names = ("dWh", "db", "dxw", "dh0", "dc0")
    runs = {}
    for G, H, T, B in rnn_option_cases():
        seed = 500 + T + B + G + H
        args = k1_inputs(T, 2, B, H, dev, seed) if G == 2 else k2_inputs(T, B, H, dev, seed)
        rd = rd_mask(G, B, H, dev, seed)
        out_k, res_k = rnn.scan_core_fwd(*args, bf, True, rd)
        again, res_again = rnn.scan_core_fwd(*args, bf, True, rd)
        out_p, res_p = rnn.bilstm_scan_core_fwd_impl(*args, bf, True, rd)
        g = torch.Generator().manual_seed(seed + 1)
        cot = [torch.randn((T, G, B, H), generator=g).to(bf).to(dev),
               torch.randn((G, B, H), generator=g).to(dev),
               torch.randn((G, B, H), generator=g).to(dev)]
        bargs = [*args[:4], *res_k, *cot, bf, rd]
        g_k = rnn.scan_core_bwd(*bargs)
        g_again = rnn.scan_core_bwd(*bargs)
        g_p = rnn.bilstm_scan_core_bwd_plain(*bargs)
        torch.cuda.synchronize()
        e = {n: max_err(a, b_) for n, a, b_ in zip(("ys", "hT", "cT", "h_res", "c_res"),
                                                   (*out_k, *res_k), (*out_p, *res_p))}
        ge = {n: rel_err(a, b_) for n, a, b_ in zip(names, g_k, g_p)}
        same = all(torch.equal(a, b_) for a, b_ in zip((*out_k, *res_k, *g_k),
                                                       (*again, *res_again, *g_again)))
        kept = lstm_kept(*out_k, args[4], args[5]) and lstm_passed(g_k[2], g_k[3], g_k[4],
                                                                   cot[1], cot[2])
        family = kernels.lstm_family(G, B, H)
        want = "cluster" if H == 256 else "step"
        print(f"K1 rd [T={T},G={G},B={B},H={H}] family {family}: fwd max abs err "
              f"{ {n: f'{x:.3e}' for n, x in e.items()} } (tol {K1_TOL}); bwd relative to max "
              f"|plain| { {n: f'{x:.3e}' for n, x in ge.items()} } (tol {K1B_REL_TOL}); reruns "
              f"bit-equal: {same}; the 0-length row kept its state, passed dhT/dcT: {kept}")
        if not (family == want
                and all(torch.isfinite(x.float()).all() for x in (*out_k, *res_k, *g_k))
                and max(e.values()) <= K1_TOL and max(ge.values()) <= K1B_REL_TOL and same
                and kept):
            fail("K1 rd", f"kernels disagree with the masked twins at G={G}, T={T}, B={B}, "
                          f"H={H}: {e}, {ge}; bit-equal {same}; kept {kept}; family {family}")
        runs[(G, H, T, B)] = dict(args=args, rd=rd, bargs=bargs, out=(*out_k, *res_k), grads=g_k,
                                  fwd_err=max(e.values()),
                                  bwd_err=max(max_err(a, b_) for a, b_ in zip(g_k, g_p)))
    for G, (T, B) in ((2, (197, 128)), (1, (197, 128))):
        r = runs[(G, 256, T, B)]
        a, rd, ba = r["args"], r["rd"], r["bargs"]
        fwd = lambda rd_=rd: rnn.scan_core_fwd(*a, bf, True, rd_)  # noqa: E731
        ka = [ba[0].to(bf).contiguous(), *ba[1:9]]  # the wrapper's operands
        dms = dict(fwd=device_ms(fwd), fwd_unmasked=device_ms(lambda: fwd(None)),
                   bwd=device_ms(lambda: kernels.lstm_scan_bwd(*ka, rd=rd)),
                   bwd_unmasked=device_ms(lambda: kernels.lstm_scan_bwd(*ka)),
                   bwd_with_dwh=device_ms(lambda: rnn.scan_core_bwd(*ba)))
        ms = dict(fwd=time_ms(fwd), plain_fwd=time_ms(
            lambda: rnn.bilstm_scan_core_fwd_impl(*a, bf, True, rd), reps=3, warmup=1),
                  bwd=time_ms(lambda: rnn.scan_core_bwd(*ba)), plain_bwd=time_ms(
            lambda: rnn.bilstm_scan_core_bwd_plain(*ba), reps=3, warmup=1))
        H4 = 1024
        flops = 2 * T * G * B * 256 * H4
        kind = "" if G == 2 else "_uni"
        print(f"K1 rd [T={T},G={G},B={B},H=256] device fwd (save) {dms['fwd']:.4f} ms "
              f"({dms['fwd'] / T * 1e3:.3f} us a step; unmasked {dms['fwd_unmasked']:.4f} ms), "
              f"bwd {dms['bwd']:.4f} ms ({dms['bwd'] / T * 1e3:.3f} us a step; unmasked "
              f"{dms['bwd_unmasked']:.4f} ms; {dms['bwd_with_dwh']:.4f} ms with the caller's dWh); "
              f"kernel {ms['fwd']:.4f} / {ms['bwd']:.4f} ms, plain {ms['plain_fwd']:.4f} / "
              f"{ms['plain_bwd']:.4f} ms (fwd / bwd)")
        shapes = [k for k in runs if k[0] == G]
        report[f"lstm_scan{kind}_rd_fwd"] = dict(
            max_abs_err=max(runs[k]["fwd_err"] for k in shapes), ms=ms["fwd"],
            plain_ms=ms["plain_fwd"], library_ms=None, device_ms=dms["fwd"],
            bound=bound(nbytes(*a, rd, *r["out"]), flops), per_step_us=dms["fwd"] / T * 1e3,
            unmasked_device_ms=dms["fwd_unmasked"], shape=f"T={T},G={G},B={B},H=256")
        report[f"lstm_scan{kind}_rd_bwd"] = dict(
            max_abs_err=max(runs[k]["bwd_err"] for k in shapes), ms=ms["bwd"],
            plain_ms=ms["plain_bwd"], library_ms=None, device_ms=dms["bwd"],
            bound=bound(nbytes(*ba[:9], rd, *r["grads"][1:]), 2 * flops),
            per_step_us=dms["bwd"] / T * 1e3, unmasked_device_ms=dms["bwd_unmasked"],
            device_ms_with_dwh=dms["bwd_with_dwh"], shape=f"T={T},G={G},B={B},H=256")


def cluster_build_info(label, stem, cluster_tag, route_names, n_cluster, n_route):
    """Registers and spills of a scan's kernels (``ptxas -v`` of
    ``csrc/<stem>.cu``): its cluster instances (mangled names holding
    ``cluster_tag``) and its other route's kernels (``route_names``), in
    the counts the library instantiates; fails on a spill of a cluster
    instance."""
    from avsr_tpu_torch import kernels

    report = kernels.ptxas_report(stem)
    cl = {n: r for n, r in report.items() if cluster_tag in n}
    other = {n: r for n, r in report.items() if any(k in n for k in route_names)}
    print(f"{label} build ({stem}.cu; ptxas -v): cluster {cl}; other route {other}")
    if len(cl) != n_cluster or len(other) != n_route:
        fail(label, f"expected {n_cluster} cluster and {n_route} other kernels in the ptxas "
                    f"report, got {sorted(cl)} and {sorted(other)}")
    spilled = [n for n, r in cl.items() if r["spill_stores"] or r["spill_loads"]]
    if spilled:
        fail(label, f"cluster kernels spill: {spilled}")
    return {**cl, **other}


def k12_build_info():
    """Registers and spills of K12's kernels: 6 cluster instances (forward
    and backward at H = 128, 256, 384) and the three per-step kernels."""
    return cluster_build_info("K12", "gru_scan", "gru_cl", ("gru_step_kernel",
                                                             "gru_bwd_step_kernel",
                                                             "gru_bwd_final_kernel"), 6, 3)


def cudnn_gru_ms(T, B, H, lengths, dev, D=512):
    """(forward, backward) device ms of cuDNN's bidirectional ``nn.GRU``
    (fp16, input width D, b_hh = 0) on a packed sequence of ``lengths`` at
    [T, B, H]: a reference point, timed only, never on a path; it computes
    K12's cell function but also the input product, with its own rounding."""
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence

    gru = torch.nn.GRU(D, H, bidirectional=True).to(dev, torch.float16)
    with torch.no_grad():
        for name, p in gru.named_parameters():
            if name.startswith("bias_hh"):
                p.zero_()
    g = torch.Generator().manual_seed(T + B + 1)
    x = torch.randn((T, B, D), generator=g).to(dev, torch.float16).requires_grad_(True)
    lens = lengths.clamp(min=1).cpu()  # a packed sequence has no empty row
    packed = lambda: pack_padded_sequence(x, lens, enforce_sorted=False)  # noqa: E731
    with torch.no_grad():
        fwd = device_ms(lambda: gru(packed()))
    both = device_ms(lambda: gru(packed())[0].data.float().sum().backward())
    return fwd, both - fwd


def phase_k12(dev, report):
    """K12, the GRU scan, forward (save mode) and backward, against the plain
    twins."""
    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.ops import rnn

    bf = torch.bfloat16
    build = k12_build_info()
    lib = kernels._load()
    for H in (80, 256, 512):
        for bwd in (0, 1):
            if lib.avsr_gru_step_smem(H, bwd) != kernels.gru_step_smem(H, bool(bwd)):
                fail("K12", f"H={H}: the library's step kernel takes "
                            f"{lib.avsr_gru_step_smem(H, bwd)} bytes, gru_step_smem "
                            f"{kernels.gru_step_smem(H, bool(bwd))}")
    active = {}
    for H in (128, 256, 384):
        for bwd in (0, 1):
            if lib.avsr_gru_cluster_smem(H, bwd) != kernels.gru_cluster_smem(H, bool(bwd)):
                fail("K12", f"H={H}: the library's cluster CTA takes "
                            f"{lib.avsr_gru_cluster_smem(H, bwd)} bytes, gru_cluster_smem "
                            f"{kernels.gru_cluster_smem(H, bool(bwd))}")
            active[(H, "bwd" if bwd else "fwd")] = lib.avsr_gru_cluster_max_active(H, bwd)
    print(f"K12 cluster: max active 8-CTA clusters {active}")
    names = ("dWh", "db", "dxw", "dh0")
    runs = {}
    for G, H, T, B in rnn_option_cases():
        seed = 700 + T + B + G + H
        args = k12_inputs(T, G, B, H, dev, seed)
        (ys, hT), h_res = rnn.gru_core_fwd(*args, bf, True)
        (ys2, hT2), h_res2 = rnn.gru_core_fwd(*args, bf, True)
        (ys_p, hT_p), h_res_p = rnn.gru_scan_core_fwd_plain(*args, bf, True)
        g = torch.Generator().manual_seed(seed + 1)
        dys = torch.randn((T, G, B, H), generator=g).to(bf).to(dev)
        dhT = torch.randn((G, B, H), generator=g).to(dev)
        bargs = [*args[:4], h_res, dys, dhT, bf]
        g_k = rnn.gru_core_bwd(*bargs)
        g_again = rnn.gru_core_bwd(*bargs)
        g_p = rnn.gru_scan_core_bwd_plain(*bargs)
        torch.cuda.synchronize()
        e = {n: max_err(a, b_) for n, a, b_ in zip(("ys", "hT", "h_res"), (ys, hT, h_res),
                                                   (ys_p, hT_p, h_res_p))}
        ge = {n: rel_err(a, b_) for n, a, b_ in zip(names, g_k, g_p)}
        same = all(torch.equal(a, b_) for a, b_ in zip((ys, hT, h_res, *g_k),
                                                       (ys2, hT2, h_res2, *g_again)))
        kept = B < 2 or (torch.equal(hT[:, 1], args[4][:, 1])
                         and float(ys[:, :, 1].float().abs().max()) == 0.0
                         and float(g_k[2][:, :, 1].float().abs().max()) == 0.0
                         and torch.equal(g_k[3][:, 1], dhT[:, 1]))
        family = kernels.gru_family(G, B, H)
        want = "cluster" if H == 256 else "step"
        print(f"K12 [T={T},G={G},B={B},H={H}] family {family}: fwd max abs err "
              f"{ {n: f'{x:.3e}' for n, x in e.items()} } (tol {K1_TOL}); bwd relative to max "
              f"|plain| { {n: f'{x:.3e}' for n, x in ge.items()} } (tol {K1B_REL_TOL}); reruns "
              f"bit-equal: {same}; the 0-length row kept h0 and passed dhT: {kept}")
        if not (family == want and all(torch.isfinite(x.float()).all() for x in (ys, hT, *g_k))
                and max(e.values()) <= K1_TOL and max(ge.values()) <= K1B_REL_TOL and same
                and kept):
            fail("K12", f"kernels disagree with the plain twins at G={G}, T={T}, B={B}, H={H}: "
                        f"{e}, {ge}; bit-equal {same}; kept {kept}; family {family}")
        runs[(G, H, T, B)] = dict(args=args, bargs=bargs, out=(ys, hT, h_res), grads=g_k,
                                  fwd_err=max(e.values()),
                                  bwd_err=max(max_err(a, b_) for a, b_ in zip(g_k, g_p)))
    T80, G80, B80 = RNN_OPTION_STEP_ROUTE[0]
    for G, H, T, B in ((2, 256, 197, 128), (1, 256, 197, 128), (G80, 80, T80, B80)):
        r = runs[(G, H, T, B)]
        a, ba = r["args"], r["bargs"]
        ka = [ba[0].to(bf).contiguous(), *ba[1:7]]  # the wrapper's operands
        dms = dict(fwd=device_ms(lambda: rnn.gru_core_fwd(*a, bf, True)),
                   fwd_serve=device_ms(lambda: rnn.gru_core_fwd(*a, bf, False)),
                   bwd=device_ms(lambda: kernels.gru_scan_bwd(*ka)),
                   bwd_with_dwh=device_ms(lambda: rnn.gru_core_bwd(*ba)))
        ms = dict(fwd=time_ms(lambda: rnn.gru_core_fwd(*a, bf, True)),
                  plain_fwd=time_ms(lambda: rnn.gru_scan_core_fwd_plain(*a, bf, True), reps=3,
                                    warmup=1),
                  bwd=time_ms(lambda: rnn.gru_core_bwd(*ba)),
                  plain_bwd=time_ms(lambda: rnn.gru_scan_core_bwd_plain(*ba), reps=3, warmup=1))
        flops = 2 * T * G * B * H * 3 * H
        cud = (cudnn_gru_ms(T, B, H, a[3][:, 0].sum(0).long(), dev) if (G, H) == (2, 256)
               else None)
        family = kernels.gru_family(G, B, H)
        print(f"K12 [T={T},G={G},B={B},H={H}] {family} route: device fwd (save) "
              f"{dms['fwd']:.4f} ms "
              f"({dms['fwd'] / T * 1e3:.3f} us a step; {dms['fwd_serve']:.4f} ms without "
              f"save), bwd {dms['bwd']:.4f} ms ({dms['bwd'] / T * 1e3:.3f} us a step; "
              f"{dms['bwd_with_dwh']:.4f} ms with the caller's dWh); kernel {ms['fwd']:.4f} / "
              f"{ms['bwd']:.4f} ms, plain {ms['plain_fwd']:.4f} / {ms['plain_bwd']:.4f} ms "
              f"(fwd / bwd)"
              + ("" if cud is None else
                 f"; reference point, not K12's function: cuDNN bidirectional nn.GRU (fp16, "
                 f"input width 512, b_hh = 0, packed sequence; it also computes the input "
                 f"product) device {cud[0]:.4f} ms forward, {cud[1]:.4f} ms backward"))
        kind = "_step" if family == "step" else "" if G == 2 else "_uni"
        shapes = [k for k in runs if kernels.gru_family(k[0], k[3], k[1]) == family
                  and (family == "step" or k[0] == G)]
        common = dict(shape=f"T={T},G={G},B={B},H={H}", library_ms=None, family=family,
                      registers={k: x["registers"] for k, x in build.items()},
                      spill_bytes={k: x["spill_stores"] + x["spill_loads"]
                                   for k, x in build.items()})
        report[f"gru_scan{kind}_fwd"] = dict(
            common, max_abs_err=max(runs[k]["fwd_err"] for k in shapes), ms=ms["fwd"],
            plain_ms=ms["plain_fwd"], device_ms=dms["fwd"], device_ms_serve=dms["fwd_serve"],
            bound=bound(nbytes(*a, *r["out"]), flops), per_step_us=dms["fwd"] / T * 1e3,
            **({} if cud is None else {"cudnn_reference_device_ms": cud[0]}))
        report[f"gru_scan{kind}_bwd"] = dict(
            common, max_abs_err=max(runs[k]["bwd_err"] for k in shapes), ms=ms["bwd"],
            plain_ms=ms["plain_bwd"], device_ms=dms["bwd"],
            # The function's own operands: wh, b, xw, mask, h_res, dys, dhT
            # in; db, dxw, dh0 out (dWh left out, as for K1).  dhw, the fp32
            # recurrent cotangent this design writes for the caller's dWh, is
            # an intermediate: its bytes are reported apart, not bounded.
            bound=bound(nbytes(*ka, *r["grads"][1:]), 2 * flops),
            dhw_write_bytes=T * G * B * 3 * H * 4,
            per_step_us=dms["bwd"] / T * 1e3, device_ms_with_dwh=dms["bwd_with_dwh"],
            **({} if cud is None else {"cudnn_reference_device_ms": cud[1]}))


# ---------------------------------------------------------------------------
# LN-LSTM encoders on K13, the frontend's options on K3, SpecAugment and LAMB
# (phases 57-62)
# ---------------------------------------------------------------------------


def ln_cfg():
    """``lrs2_av_align_ln``: the lrs2_av_align preset with LN-LSTM cells in
    both encoders (K13) and recurrent dropout 0.2 in the video encoder, so
    training runs K13 unmasked (audio) and masked (video)."""
    from avsr_tpu_torch.configs import lrs2_full

    return lrs2_full().override({
        "audio_encoder.layer_norm": True, "video_encoder.layer_norm": True,
        "video_encoder.recurrent_dropout_rate": 0.2, "name": "lrs2_av_align_ln"})


def spectrogram_cfg():
    """``lrs2_av_fast_spectrogram``: the lrs2_av_fast preset with the log
    power spectrogram (257 bins), no deltas, global normalization (K3's
    option instance), SpecAugment and LAMB (weight decay 1e-4)."""
    from avsr_tpu_torch.configs import lrs2_av_fast

    return lrs2_av_fast().override({
        "audio.feature_type": "spectrogram", "audio.add_deltas": False,
        "audio.normalization": "global", "audio.spec_augment": True,
        "train.optimizer": "lamb", "train.weight_decay": 1e-4,
        "name": "lrs2_av_fast_spectrogram"})


# K13's (T, B) at G = 2, H = 256 beyond RNN_OPTION_SHAPES and the train
# buckets': the serving buckets' audio and video steps at B = 8
K13_SERVE_SHAPES = tuple(sorted({(T, B) for B, _, Ta, Tv, _ in SERVE_BUCKETS for T in (Ta, Tv)}
                                - set(RNN_OPTION_SHAPES) - set(RNN_OPTION_BUCKET_SHAPES)))
TRAIN_LN_KERNELS = ("ln_lstm_scan_fwd", "ln_lstm_scan_bwd", "ln_lstm_scan_rd_fwd",
                    "ln_lstm_scan_rd_bwd", "logmel_post_dft", "av_align_scan",
                    "av_align_scan_bwd", "bahdanau_attend_row", "bahdanau_attend_bwd",
                    "bahdanau_attend_sums")
SERVE_LN_KERNELS = ("ln_lstm_scan_fwd", "logmel_post_dft", "av_align_scan",
                    "bahdanau_attend_grouped", "beam_step")
TRAIN_SPEC_KERNELS = tuple("logmel_post_dft_options" if k == "logmel_post_dft" else k
                           for k in TRAIN_KERNELS)
SERVE_SPEC_KERNELS = tuple("logmel_post_dft_options" if k == "logmel_post_dft" else k
                           for k in SERVE_KERNELS)
# LAMB moves each leaf by lr times its own norm (the trust ratio), so its lr
# is a relative step: 1e-2, where Adam's 1e-4 is an absolute one
SPEC_LR = 1e-2


K13_STAT_BYTES = 4 * 2 * 4  # the 4 gate blocks' mean and rstd, fp32, a row-step
# K13's fp32 pre-LN gates z against xw + h_res @ bf16(Wh) on the same
# operands: exact products of bf16 values summed in fp32 in another order
# (H of them, |z| of order 1-5)
K13_Z_TOL = 1e-3


def k13_inputs(T, G, B, H, dev, seed):
    """K13's operands: Wh [G, H, 4H], b, ln_gamma, ln_cell_gamma,
    ln_cell_beta (perturbed from their init), the bf16 input product, a
    ragged mask with a 0-length row 1 (the backward stream flipped at G = 2),
    h0 and c0 (zero at G = 2, as a bidirectional layer starts; nonzero at
    G = 1)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    wh = torch.randn((G, H, 4 * H), generator=g) / H ** 0.5
    b = 0.1 * torch.randn((G, 4 * H), generator=g)
    lng = 1 + 0.1 * torch.randn((G, 4 * H), generator=g)
    lncg = 1 + 0.1 * torch.randn((G, H), generator=g)
    lncb = 0.1 * torch.randn((G, H), generator=g)
    xw = torch.randn((T, G, B, 4 * H), generator=g).to(torch.bfloat16)
    lengths = torch.randint(1, T + 1, (B,), generator=g)
    lengths[0] = T
    if B > 1:
        lengths[1] = 0
    m = (torch.arange(T)[:, None] < lengths[None, :]).float()
    mask = torch.stack([m, torch.flip(m, (0,))], dim=1)[:, :G]
    if G == 2:
        h0, c0 = torch.zeros((G, B, H)), torch.zeros((G, B, H))
    else:
        h0 = 0.5 * torch.randn((G, B, H), generator=g)
        c0 = 0.5 * torch.randn((G, B, H), generator=g)
    return [x.to(dev) for x in (wh, b, lng, lncg, lncb, xw, mask, h0, c0)]


def k13_cases():
    """(G, H, T, B) of phase 57, the full width's first: the paths' shapes,
    the train buckets', the serving buckets', G = 1 at the train step's
    audio and the 16 s limit, and an off-multiple width (H = 80)."""
    return ([(2, 256, T, B) for T, B in RNN_OPTION_SHAPES + RNN_OPTION_BUCKET_SHAPES
             + K13_SERVE_SHAPES]
            + [(1, 256, T, B) for T, B in RNN_OPTION_UNI_SHAPES]
            + [(G, 80, T, B) for T, G, B in RNN_OPTION_STEP_ROUTE])


@contextlib.contextmanager
def k13_calls():
    """Records every K13 call of the block (``rnn.ln_core_fwd`` /
    ``ln_core_bwd``, as the path makes it): {"fwd": [(args, out)], "bwd":
    [(args, out)]}, the tensors as the path handed them."""
    from avsr_tpu_torch.ops import rnn

    calls = {"fwd": [], "bwd": []}

    def recorder(kind, fn):
        def call(*args):
            out = fn(*args)
            calls[kind].append((args, out))
            return out
        return call

    with mock.patch.object(rnn, "ln_core_fwd", recorder("fwd", rnn.ln_core_fwd)), \
            mock.patch.object(rnn, "ln_core_bwd", recorder("bwd", rnn.ln_core_bwd)):
        yield calls


def k13_stepwise_errs(args, out, res):
    """K13's forward on a path's call, held step by step from the kernel's
    own saved states, so that no difference compounds over the steps (the
    full-width LN model at init is chaotic: a whole scan of the same inputs
    in another summation order ends elsewhere): z[t] against xw[t] +
    h_res[t] @ bf16(Wh), and each step's cell, from the kernel's z[t] and
    c_res[t] through the twin's ``_ln_cell``, against ys[t], the next
    step's h_res and c_res, and (hT, cT).  -> {name: max abs error}."""
    import torch

    from avsr_tpu_torch.ops import rnn

    wh, b, lng, lncg, lncb, xw, mask, h0, c0, cdt = args[:10]
    rd = args[11] if len(args) > 11 else None
    ys, hT, cT = out
    h_res, c_res, z = res
    T, G, B, H4 = z.shape
    z_p = xw.float() + torch.einsum("tgbh,ghk->tgbk", h_res.float(),
                                    wh.to(torch.bfloat16).float())

    def flat(x):
        return x.float().permute(1, 0, 2, 3).reshape(G, T * B, x.shape[-1])

    _, (_, _, _, o), _, c_new, tc = rnn._ln_cell(flat(z), b.float(), lng.float(), lncg.float(),
                                                 lncb.float(), flat(c_res))
    h_new, c_new = ((x.reshape(G, T, B, H4 // 4).permute(1, 0, 2, 3)) for x in (o * tc, c_new))
    m = mask.float()[..., None]
    c_next = m * c_new + (1.0 - m) * c_res
    h, hs = h0.float(), []
    for t in range(T):
        h = m[t] * h_new[t] + (1.0 - m[t]) * h
        hs.append(h)
    hs = torch.stack(hs)
    rdm = 1.0 if rd is None else rd
    return dict(z=max_err(z, z_p), ys=max_err(ys, (h_new * m).to(cdt)),
                h_res=max_err(h_res, torch.cat([(h0 * rdm)[None], hs[:-1] * rdm]).to(cdt)),
                c_res=max_err(c_res, torch.cat([c0[None], c_next[:-1]])),
                hT=max_err(hT, hs[-1]), cT=max_err(cT, c_next[-1]))


def hold_k13_calls(label, calls):
    """Every K13 call a path made, on its own activations: each forward
    step by step (``k13_stepwise_errs``; a serving call's forward is rerun
    in save mode for its states, its outputs held against the call's), each
    backward against the plain twin on the call's own operands (the
    kernel's saved states and the path's cotangents), at K1's tolerances."""
    import torch

    from avsr_tpu_torch.ops import rnn

    if not calls["fwd"]:
        fail(label, "the path made no K13 call")
    for i, (args, (out, res)) in enumerate(calls["fwd"]):
        extra = ""
        if res is None:
            out_s, res = rnn.ln_core_fwd(*args[:10], True, *args[11:])
            same = all(torch.equal(x, y) for x, y in zip(out, out_s))
            serve_err = max(max_err(x, y) for x, y in zip(out, out_s))
            extra = f"; the call's outputs against its save-mode rerun {serve_err:.3e} " \
                    f"(bit-equal: {same})"
            if not serve_err <= K1_TOL:
                fail(label, f"K13 forward call {i}: save mode changed its outputs by {serve_err}")
        e = k13_stepwise_errs(args, out, res)
        rd = len(args) > 11 and args[11] is not None
        print(f"{label} K13 fwd call {i} [T,G,B,4H={tuple(res[2].shape)}{',rd' if rd else ''}] "
              f"step by step from the kernel's states, max abs err "
              f"{ {n: f'{x:.3e}' for n, x in e.items()} } (tol z {K13_Z_TOL}, others "
              f"{K1_TOL}){extra}")
        if not (e.pop("z") <= K13_Z_TOL and max(e.values()) <= K1_TOL):
            fail(label, f"K13 forward call {i} disagrees with the twin's step: {e}")
    names = ("dWh", "db", "dln_gamma", "dln_cell_gamma", "dln_cell_beta", "dxw", "dh0", "dc0")
    for i, (args, g_k) in enumerate(calls["bwd"]):
        g_p = rnn.ln_lstm_scan_core_bwd_plain(*args)
        ge = {n: rel_err(a, b) for n, a, b in zip(names, g_k, g_p)}
        print(f"{label} K13 bwd call {i} [T,G,B,4H={tuple(args[8].shape)}"
              f"{',rd' if args[13] is not None else ''}] against the twin on its operands, "
              f"relative to max |plain| { {n: f'{x:.3e}' for n, x in ge.items()} } "
              f"(tol {K1B_REL_TOL})")
        if not (all(torch.isfinite(x.float()).all() for x in g_k)
                and max(ge.values()) <= K1B_REL_TOL):
            fail(label, f"K13 backward call {i} disagrees with the plain twin: {ge}")


def phase_k13(dev, report):
    """K13, the LN-LSTM scan, forward (save mode) and backward, with and
    without a recurrent-dropout mask, against the plain twins."""
    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.ops import rnn

    bf = torch.bfloat16
    # 25 cluster instances (forward and backward, with and without the rd
    # mask, and the statistics launch, at H = 128..384) and the block
    # route's 9 kernels
    build = cluster_build_info("K13", "ln_lstm_scan", "ln_cl",
                               ("ln_lstm_fwd_kernel", "ln_lstm_bwd_kernel",
                                "ln_lstm_part_reduce"), 25, 9)
    lib = kernels._load()
    for H in (80, 256, 512):
        for bwd in (0, 1):
            if lib.avsr_ln_lstm_smem(H, bwd) != kernels.ln_lstm_smem(H, bool(bwd)):
                fail("K13", f"H={H}: the library's block takes {lib.avsr_ln_lstm_smem(H, bwd)} "
                            f"bytes, ln_lstm_smem {kernels.ln_lstm_smem(H, bool(bwd))}")
    active = {}
    for H in (128, 192, 256, 320, 384):
        for bwd in (0, 1):
            if lib.avsr_ln_lstm_cluster_smem(H, bwd) != kernels.ln_lstm_cluster_smem(H, bool(bwd)):
                fail("K13", f"H={H}: the library's cluster CTA takes "
                            f"{lib.avsr_ln_lstm_cluster_smem(H, bwd)} bytes, ln_lstm_cluster_smem "
                            f"{kernels.ln_lstm_cluster_smem(H, bool(bwd))}")
            active[(H, "bwd" if bwd else "fwd")] = lib.avsr_ln_lstm_cluster_max_active(H, bwd)
    print(f"K13 cluster: max active 8-CTA clusters {active}")
    names = ("dWh", "db", "dln_gamma", "dln_cell_gamma", "dln_cell_beta", "dxw", "dh0", "dc0")
    runs = {}
    for G, H, T, B in k13_cases():
        for masked in (False, True):
            seed = 900 + T + B + G + H + masked
            args = k13_inputs(T, G, B, H, dev, seed)
            rd = rd_mask(G, B, H, dev, seed) if masked else None
            out_k, res_k = rnn.ln_core_fwd(*args, bf, True, rd)
            again, res_again = rnn.ln_core_fwd(*args, bf, True, rd)
            out_p, res_p = rnn.ln_lstm_scan_core_fwd_plain(*args, bf, True, rd)
            g = torch.Generator().manual_seed(seed + 1)
            cot = [torch.randn((T, G, B, H), generator=g).to(bf).to(dev),
                   torch.randn((G, B, H), generator=g).to(dev),
                   torch.randn((G, B, H), generator=g).to(dev)]
            bargs = [*args[:5], args[6], *res_k, *cot, bf, rd]
            g_k = rnn.ln_core_bwd(*bargs)
            g_again = rnn.ln_core_bwd(*bargs)
            g_p = rnn.ln_lstm_scan_core_bwd_plain(*bargs)
            torch.cuda.synchronize()
            e = {n: max_err(a, b_) for n, a, b_ in zip(("ys", "hT", "cT", "h_res", "c_res", "z"),
                                                       (*out_k, *res_k), (*out_p, *res_p))}
            ge = {n: rel_err(a, b_) for n, a, b_ in zip(names, g_k, g_p)}
            same = all(torch.equal(a, b_) for a, b_ in zip((*out_k, *res_k, *g_k),
                                                           (*again, *res_again, *g_again)))
            kept = lstm_kept(*out_k, args[7], args[8]) and lstm_passed(g_k[5], g_k[6], g_k[7],
                                                                       cot[1], cot[2])
            tag = f"T={T},G={G},B={B},H={H}" + (",rd" if masked else "")
            family = kernels.ln_lstm_family(G, B, H)
            print(f"K13 [{tag}] {family} route: fwd max abs err "
                  f"{ {n: f'{x:.3e}' for n, x in e.items()} } (tol {K1_TOL}); bwd relative to max "
                  f"|plain| { {n: f'{x:.3e}' for n, x in ge.items()} } (tol {K1B_REL_TOL}); reruns "
                  f"bit-equal: {same}; the 0-length row kept its state, passed dhT/dcT: {kept}")
            if not (family == ("cluster" if H == 256 else "block")
                    and all(torch.isfinite(x.float()).all() for x in (*out_k, *res_k, *g_k))
                    and max(e.values()) <= K1_TOL and max(ge.values()) <= K1B_REL_TOL and same
                    and kept):
                fail("K13", f"kernels disagree with the plain twins at {tag}: {e}, {ge}; "
                            f"bit-equal {same}; kept {kept}; family {family}")
            runs[(G, H, T, B, masked)] = dict(
                args=args, rd=rd, bargs=bargs, out=(*out_k, *res_k), grads=g_k,
                fwd_err=max(e.values()), bwd_err=max(max_err(a, b_) for a, b_ in zip(g_k, g_p)))
    T80, G80, B80 = RNN_OPTION_STEP_ROUTE[0]
    for G, H, T, B, masked in ((2, 256, 197, 128, False), (2, 256, 197, 128, True),
                               (1, 256, 197, 128, False), (1, 256, 197, 128, True),
                               (G80, 80, T80, B80, False)):
        r = runs[(G, H, T, B, masked)]
        a, rd, ba = r["args"], r["rd"], r["bargs"]
        ka = [ba[0].to(bf).contiguous(), *ba[1:6], *ba[7:12]]  # the wrapper's operands
        fwd = lambda: rnn.ln_core_fwd(*a, bf, True, rd)  # noqa: E731
        dms = dict(fwd=device_ms(fwd, reps=5, warmup=1),
                   fwd_serve=device_ms(lambda: rnn.ln_core_fwd(*a, bf, False, rd), reps=5,
                                       warmup=1),
                   bwd=device_ms(lambda: kernels.ln_lstm_scan_bwd(*ka, rd=rd), reps=5, warmup=1),
                   bwd_with_dwh=device_ms(lambda: rnn.ln_core_bwd(*ba), reps=5, warmup=1))
        ms = dict(fwd=time_ms(fwd, reps=5, warmup=1),
                  plain_fwd=time_ms(lambda: rnn.ln_lstm_scan_core_fwd_plain(*a, bf, True, rd),
                                    reps=3, warmup=1),
                  bwd=time_ms(lambda: rnn.ln_core_bwd(*ba), reps=5, warmup=1),
                  plain_bwd=time_ms(lambda: rnn.ln_lstm_scan_core_bwd_plain(*ba), reps=3,
                                    warmup=1))
        flops = 2 * T * G * B * H * 4 * H
        family = kernels.ln_lstm_family(G, B, H)
        print(f"K13 [T={T},G={G},B={B},H={H}{',rd' if masked else ''}] {family} route: device "
              f"fwd (save) "
              f"{dms['fwd']:.4f} ms ({dms['fwd'] / T * 1e3:.3f} us a step; "
              f"{dms['fwd_serve']:.4f} ms without save), bwd {dms['bwd']:.4f} ms "
              f"({dms['bwd'] / T * 1e3:.3f} us a step; {dms['bwd_with_dwh']:.4f} ms with the "
              f"caller's dWh); kernel {ms['fwd']:.4f} / {ms['bwd']:.4f} ms, plain "
              f"{ms['plain_fwd']:.4f} / {ms['plain_bwd']:.4f} ms (fwd / bwd)")
        if family == "block":
            kind = "_block"
            shapes = [k for k in runs if kernels.ln_lstm_family(k[0], k[3], k[1]) == "block"]
        else:
            kind = ("" if G == 2 else "_uni") + ("_rd" if masked else "")
            shapes = [k for k in runs if k[0] == G and k[4] == masked and k[1] == 256]
        common = dict(shape=f"T={T},G={G},B={B},H={H}", library_ms=None, family=family,
                      registers={k: x["registers"] for k, x in build.items()},
                      spill_bytes={k: x["spill_stores"] + x["spill_loads"]
                                   for k, x in build.items()})
        # The function's own operands, with the least a backward needs
        # saved: the operand h_res, the carry c_res and the gate blocks'
        # statistics (mean and rstd, K13_STAT_BYTES a row-step).  z, the
        # fp32 pre-LN gates this design saves instead of recomputing them,
        # is reported apart (z_write_bytes), not bounded; the backward's
        # bound reads xw and h_res in its place and recomputes the product.
        ys, hT, cT, h_res, c_res, z = r["out"]
        stats = T * G * B * K13_STAT_BYTES
        report[f"ln_lstm_scan{kind}_fwd"] = dict(
            common, max_abs_err=max(runs[k]["fwd_err"] for k in shapes), ms=ms["fwd"],
            plain_ms=ms["plain_fwd"], device_ms=dms["fwd"], device_ms_serve=dms["fwd_serve"],
            bound=bound(nbytes(*a, rd, ys, hT, cT, h_res, c_res) + stats, flops),
            z_write_bytes=nbytes(z), per_step_us=dms["fwd"] / T * 1e3)
        # wh, b, the LN leaves, mask, xw, h_res, c_res, the statistics, dys,
        # dhT, dcT, rd in; db, the LN leaves' sums, dxw, dh0, dc0 out (dWh
        # the caller's, as for K1); the recomputed product and dh's product
        report[f"ln_lstm_scan{kind}_bwd"] = dict(
            common, max_abs_err=max(runs[k]["bwd_err"] for k in shapes), ms=ms["bwd"],
            plain_ms=ms["plain_bwd"], device_ms=dms["bwd"],
            bound=bound(nbytes(*ka[:6], a[5], h_res, c_res, *ka[8:], rd, *r["grads"][1:])
                        + stats, 2 * flops),
            z_read_bytes=nbytes(z), per_step_us=dms["bwd"] / T * 1e3,
            device_ms_with_dwh=dms["bwd_with_dwh"])


K3_OPTIONS = tuple((ft, d, nm) for ft in ("logmel", "spectrogram") for d in (True, False)
                   for nm in ("per_utterance", "global", "none")
                   if (ft, d, nm) != ("logmel", True, "per_utterance"))
K3_OPTION_PATH = ("spectrogram", False, "global")  # spectrogram_cfg()'s


def phase_k3_options(dev, report, cfg):
    """K3's option instances (every (feature_type, add_deltas,
    normalization) but the presets') against the plain twin at B = 8 and
    128, 6 s and 16 s, and the serving buckets; reruns bit-equal."""
    import dataclasses

    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.ops import audio_features as af

    lib = kernels._load()
    a0 = cfg.audio
    for ft, deltas, norm in K3_OPTIONS:
        c = dataclasses.replace(a0, feature_type=ft, add_deltas=deltas, normalization=norm)
        M = af._mel_band(c, dev)[0].shape[0]
        for chunk in kernels.LOGMEL_CHUNKS:
            want = kernels.logmel_writer_smem(M, chunk, c.frame_stacking, c.frame_skipping,
                                              c.delta_window, deltas)
            got = lib.avsr_logmel_writer_smem(M, chunk, c.frame_stacking, c.frame_skipping,
                                              c.delta_window, int(deltas))
            if got != want:
                fail("K3 options", f"{ft}/{deltas}/{norm} chunk {chunk}: the writer's shared "
                                   f"memory {got} is not kernels.logmel_writer_smem's {want}")
    worst, times = 0.0, {}
    for B, S in K3_SHAPES + K3_SERVE_SHAPES:
        args = k3_inputs(a0, B, S, dev, seed=B + S)
        for ft, deltas, norm in K3_OPTIONS:
            c = dataclasses.replace(a0, feature_type=ft, add_deltas=deltas, normalization=norm)
            f_k, n_k = af.logmel_post_dft(*args, c)
            f_again, _ = af.logmel_post_dft(*args, c)
            f_p, n_p = af.logmel_post_dft_plain(*args, c)
            torch.cuda.synchronize()
            err = max_err(f_k, f_p)
            worst = max(worst, err)
            tag = f"{ft},deltas={deltas},{norm},B={B},S={S}"
            D = (3 if deltas else 1) * (af._mel_band(c, dev)[0].shape[0])
            if f_k.shape[-1] != D * c.frame_stacking or not torch.equal(n_k, n_p):
                fail("K3 options", f"{tag}: features {tuple(f_k.shape)} or lengths differ")
            if not (err <= K3_TOL) or not torch.isfinite(f_k).all() \
                    or not torch.equal(f_again, f_k):
                fail("K3 options", f"{tag}: kernel disagrees with the plain version ({err}) "
                                   f"or two launches differ")
            if B == 8 or (ft, deltas, norm) == K3_OPTION_PATH or S == K3_SHAPES[0][1]:
                t = dict(device_ms=device_ms(lambda: af.logmel_post_dft(*args, c), reps=5),
                         bound=k3_bound(args, f_k, n_k, c))
                if (ft, deltas, norm) == K3_OPTION_PATH:
                    t.update(ms=time_ms(lambda: af.logmel_post_dft(*args, c), reps=5),
                             plain_ms=time_ms(lambda: af.logmel_post_dft_plain(*args, c), reps=3))
                times[tag] = t
                print(f"K3 option [{tag}] max abs err {err:.3e} (tol {K3_TOL}); device "
                      f"{t['device_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms ({t['bound'][1]})")
    main = times["{},deltas={},{},B=128,S={}".format(*K3_OPTION_PATH, K3_SHAPES[0][1])]
    report["logmel_post_dft_options"] = dict(
        max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"], library_ms=None,
        device_ms=main["device_ms"], bound=main["bound"],
        shape="spectrogram, no deltas, global, B=128, 6 s",
        by_option={tag: dict(device_ms=t["device_ms"], bound_ms=t["bound"][0])
                   for tag, t in times.items()})


# ---------------------------------------------------------------------------
# The fp32 policy (phases 63-68) and train.remat (phases 69-70)
# ---------------------------------------------------------------------------

def fp32_cfg():
    """lrs2_av_fast under the fp32 compute policy."""
    from avsr_tpu_torch.configs import lrs2_av_fast

    return lrs2_av_fast().override({"train.compute_dtype": "float32"})


def align_fp32_cfg():
    """lrs2_av_align (``lrs2_full``) under the fp32 compute policy."""
    from avsr_tpu_torch.configs import lrs2_full

    return lrs2_full().override({"train.compute_dtype": "float32"})


def full_f32(tensors, seed):
    """The float tensors of ``tensors`` in fp32 with a relative 2^-12 of
    noise added, so that no value is a bf16 value (a kernel that rounded an
    operand to bf16 would show); other tensors and None as they are."""
    import torch

    g = torch.Generator().manual_seed(seed)
    out = []
    for t in tensors:
        if t is None or not t.is_floating_point():
            out.append(t)
            continue
        x = t.float()
        noise = torch.randn(x.shape, generator=g).to(x.device)
        # masks, biases of 0 / -1e30 and zero states stay exact
        keep = (x == 0) | (x.abs() >= 1e8) | (x == 1)
        out.append(torch.where(keep, x, x * (1 + 2.0 ** -12 * noise)).contiguous())
    return out


def phase_k1_f32(dev, report):
    """K1's fp32 instance (``lstm_scan_f32_*``, the per-step kernels) against
    the plain fp32 twins at ``K1F32_SHAPES``: the forward (and its saved
    residuals), the backward on those residuals with random cotangents;
    two launches bit-equal, the 0-length row kept / passed through; device
    ms, per-step us, times, bounds; cuDNN's fp32 ``nn.LSTM`` as a reference
    point."""
    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.ops import rnn

    f32 = torch.float32
    lib = kernels._load()
    for H in (256, 272):
        for bwd in (0, 1):
            if kernels.lstm_step_smem(H, bool(bwd), 4) > kernels.SMEM_LIMIT:
                fail("K1 fp32", f"H={H}: the per-step kernels' fp32 shared memory "
                                f"{kernels.lstm_step_smem(H, bool(bwd), 4)} exceeds the card's")
    names = ("dWh", "db", "dxw", "dh0", "dc0")
    errs, bwd_errs, bwd_abs, dms, bdms = {}, {}, {}, {}, {}
    for T, B in K1F32_SHAPES:
        args = full_f32(k1_inputs(T, 2, B, 256, dev, seed=T + B + 7), seed=T + B)
        family = kernels.lstm_family(2, B, 256, f32)
        out_k = rnn.bilstm_scan_core(*args, f32)
        again = rnn.bilstm_scan_core(*args, f32)
        (ys_s, hT_s, cT_s), res_k = rnn.scan_core_fwd(*args, f32, save=True)
        out_p, res_p = rnn.bilstm_scan_core_fwd_impl(*args, f32, save=True)
        e = {n: max_err(a, b_) for n, a, b_ in zip(("ys", "hT", "cT"), out_k, out_p)}
        e.update(h_res=max_err(res_k[0], res_p[0]), c_res=max_err(res_k[1], res_p[1]))
        same = (all(torch.equal(a, b_) for a, b_ in zip(out_k, again))
                and all(torch.equal(a, b_) for a, b_ in zip(out_k, (ys_s, hT_s, cT_s))))
        kept = lstm_kept(*out_k, args[4], args[5])
        g = torch.Generator().manual_seed(T * B)
        dys = torch.randn((T, 2, B, 256), generator=g).to(dev)
        dhT, dcT = (torch.randn((2, B, 256), generator=g).to(dev) for _ in range(2))
        bargs = (args[0], args[1], args[2], args[3], *res_k, dys, dhT, dcT, f32)
        g_k = rnn.scan_core_bwd(*bargs)
        g_k2 = rnn.scan_core_bwd(*bargs)
        g_p = rnn.bilstm_scan_core_bwd_plain(*bargs)
        torch.cuda.synchronize()
        rel = {n: rel_err(a, b_) for n, a, b_ in zip(names, g_k, g_p)}
        bsame = all(torch.equal(a, b_) for a, b_ in zip(g_k, g_k2))
        passed = lstm_passed(g_k[2], g_k[3], g_k[4], dhT, dcT)
        types = {x.dtype for x in (*out_k[:1], *res_k, g_k[2])}
        dms[(T, B)] = device_ms(lambda: rnn.bilstm_scan_core(*args, f32), reps=5)
        print(f"K1 fp32 [T={T},G=2,B={B},H=256] family {family}: forward max abs err {e} (tol "
              f"{K1F32_TOL}); backward relative to max |plain| "
              f"{ {n: f'{x:.3e}' for n, x in rel.items()} } (tol {K1F32_BWD_REL_TOL}); reruns "
              f"bit-equal {same and bsame}; the 0-length row kept {kept}, passed {passed}; "
              f"ys/residuals/dxw {sorted(map(str, types))}; forward device {dms[(T, B)]:.4f} ms, "
              f"{dms[(T, B)] / T * 1e3:.3f} us per step")
        if not (family == "step" and types == {f32} and max(e.values()) <= K1F32_TOL
                and max(rel.values()) <= K1F32_BWD_REL_TOL and same and bsame and kept
                and passed and all(torch.isfinite(x).all() for x in (*out_k, *g_k))):
            fail("K1 fp32", f"kernels disagree with the plain fp32 twins at T={T}, B={B}: {e} "
                            f"{rel}, bit-equal {same}/{bsame}, 0-length row {kept}/{passed}, "
                            f"family {family}, dtypes {types}")
        errs[(T, B)] = max(e.values())
        bwd_errs[(T, B)] = max(rel.values())
        bwd_abs[(T, B)] = max(max_err(a, b_) for a, b_ in zip(g_k, g_p))
        if (T, B) == K1F32_SHAPES[0]:
            timed = dict(
                fwd=time_ms(lambda: rnn.bilstm_scan_core(*args, f32), reps=5),
                fwd_plain=time_ms(lambda: rnn.bilstm_scan_core_plain(*args, f32), reps=3),
                bwd=time_ms(lambda: rnn.scan_core_bwd(*bargs), reps=5),
                bwd_plain=time_ms(lambda: rnn.bilstm_scan_core_bwd_plain(*bargs), reps=3),
                bwd_device=device_ms(lambda: kernels.lstm_scan_bwd(*bargs[:9]), reps=5),
                bwd_device_with_dwh=device_ms(lambda: rnn.scan_core_bwd(*bargs), reps=5))
            fwd_nb = nbytes(*args, *out_k)
            bwd_nb = nbytes(*bargs[:9], *g_k[1:])
    T, B = K1F32_SHAPES[0]  # the fast audio encoder's first layer at B = 128
    cud = cudnn_lstm_ms_f32(T, B, 256, dev)
    t = timed
    flops = 2 * T * 2 * B * 256 * 1024  # h @ Wh at every step, both directions
    b_fwd, b_bwd = bound(fwd_nb, flops, "fp32"), bound(bwd_nb, 2 * flops, "fp32")
    print(f"K1 fp32 [T={T},G=2,B={B},H=256] fwd kernel {t['fwd']:.4f} ms (device "
          f"{dms[(T, B)]:.4f})  plain {t['fwd_plain']:.4f} ms  bound {b_fwd[0]:.5f} ms "
          f"({b_fwd[1]}); bwd kernel {t['bwd']:.4f} ms (device {t['bwd_device']:.4f}, "
          f"{t['bwd_device_with_dwh']:.4f} with the caller's dWh)  plain {t['bwd_plain']:.4f} ms  "
          f"bound {b_bwd[0]:.5f} ms ({b_bwd[1]}); reference point, not K1's function: cuDNN's "
          f"fp32 bidirectional nn.LSTM (input width 512, no mask, TF32 off) device "
          f"{cud[0]:.4f} ms forward, {cud[1]:.4f} ms backward")
    report["lstm_scan_f32_fwd"] = dict(
        max_abs_err=max(errs.values()), ms=t["fwd"], plain_ms=t["fwd_plain"], library_ms=None,
        device_ms=dms[(T, B)], bound=b_fwd, per_step_us=dms[(T, B)] / T * 1e3,
        device_ms_by_shape={f"T={T},B={B}": x for (T, B), x in dms.items()},
        cudnn_fp32_reference_device_ms=cud[0])
    report["lstm_scan_f32_bwd"] = dict(
        max_abs_err=max(bwd_abs.values()), max_rel_err=max(bwd_errs.values()), ms=t["bwd"],
        plain_ms=t["bwd_plain"], library_ms=None, device_ms=t["bwd_device"], bound=b_bwd,
        device_ms_with_dwh=t["bwd_device_with_dwh"], per_step_us=t["bwd_device"] / T * 1e3,
        cudnn_fp32_reference_device_ms=cud[1])


def cudnn_lstm_ms_f32(T, B, H, dev, D=512):
    """(forward, backward) device ms of cuDNN's fp32 bidirectional
    ``nn.LSTM`` at [T, B, H] (TF32 off): a reference point that computes
    more than K1 (the input product) and has no mask."""
    import torch

    lstm = torch.nn.LSTM(D, H, bidirectional=True).to(dev)
    g = torch.Generator().manual_seed(T + B)
    x = torch.randn((T, B, D), generator=g).to(dev).requires_grad_(True)
    dy = torch.randn((T, B, 2 * H), generator=g).to(dev)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        with torch.no_grad():
            fwd = device_ms(lambda: lstm(x), reps=5)
        both = device_ms(lambda: lstm(x)[0].backward(dy), reps=5)
    return fwd, both - fwd


def attn_f32_bounds(q, k, v, ctx, P, dctx, grads, extra=()):
    """(forward, backward) bounds of the CUDA-core family's fp32 instance
    from the function's own bytes: the forward reads q, k, v (and the
    mask's operand) and writes ctx and the weights; the backward reads q,
    k, v, the weights and dctx and writes dq, dk, dv; fp32 FMAs: the
    forward's two products, the backward's four."""
    B, Tq, nh, A = q.shape
    Tk, dv = k.shape[1], v.shape[-1]
    pairs = B * nh * Tq * Tk
    return (bound(nbytes(q, k, v, *extra, ctx, P), 2 * pairs * (A + dv), "fp32"),
            bound(nbytes(q, k, v, P, dctx, *grads), 2 * pairs * (2 * A + 2 * dv), "fp32"))


def phase_attn_f32(dev, report):
    """The fp32 instance of the CUDA-core attention family as K4
    (``fusion_attention_f32_*``) and K5 (``decoder_attention_f32_*``)
    against the plain fp32 twins at ``K4F32_SHAPES`` / ``K5F32_SHAPES``:
    ctx, the weights (the residual), the backward from them; reruns
    bit-equal; the length-0 row uniform; the family's shared memory against
    ``kernels.attention_core_smem``; times, device times, bounds and the
    library yardstick (``scaled_dot_product_attention`` in fp32, same
    additive mask, TF32 off)."""
    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.models import fusion as fus
    from avsr_tpu_torch.models import transformer_decoder as tdec

    f32 = torch.float32
    lib = kernels._load()
    bad = [(Tq, Tk, dk, dv, es) for Tq in (1, 50, 531) for Tk in (1, 150, 401)
           for dk, dv in ((128, 128), (64, 64), (128, 256), (8, 24)) for es in (2, 4)
           if lib.avsr_attn_core_smem(Tq, Tk, dk, dv, int(es == 4))
           != kernels.attention_core_smem(Tq, Tk, dk, dv, es)]
    if bad:
        fail("attention fp32", f"the CUDA-core family's shared memory differs from "
                               f"kernels.attention_core_smem at {bad}")

    def check(tag, kind, q, k, v, mask_arg, dctx, plain_fwd, uniform_over=None):
        if kind == "fusion_attention":
            ctx_k, w_k, res = fus.fusion_attention_fwd(q, k, v, mask_arg, save=True)
            ctx_k2, w_k2, _ = fus.fusion_attention_fwd(q, k, v, mask_arg, save=True)
            ctx_s, _, none = fus.fusion_attention_fwd(q, k, v, mask_arg)
        else:  # the fp32 instance's residual is the weights (the CPU's: statistics)
            ctx_k, res = tdec.decoder_attention_fwd(q, k, v, mask_arg, save=True)
            ctx_k2, res2 = tdec.decoder_attention_fwd(q, k, v, mask_arg, save=True)
            ctx_s, none = tdec.decoder_attention_fwd(q, k, v, mask_arg)
            w_k, w_k2 = (r[0] if len(r) == 1 else tdec.decoder_attention_weights(q, k, mask_arg, *r)
                         for r in (res, res2))
        ctx_p, w_p = plain_fwd()
        g_k = fus.core_route_bwd(kind, q, k, v, w_k, dctx)
        g_k2 = fus.core_route_bwd(kind, q, k, v, w_k, dctx)
        g_p = fus.attention_bwd_from_weights(q, k, v, w_p, dctx)
        torch.cuda.synchronize()
        fwd = {"ctx": max_err(ctx_k, ctx_p), "P": max_err(w_k, w_p)}
        rel = {n: rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), g_k, g_p)}
        same = (torch.equal(ctx_k, ctx_k2) and torch.equal(w_k, w_k2) and none is None
                and torch.equal(ctx_k, ctx_s) and all(torch.equal(a, b) for a, b in zip(g_k, g_k2)))
        types = {x.dtype for x in (ctx_k, *g_k)}
        uni = 0.0
        if uniform_over:
            uni = max_err(w_k[1], torch.full_like(w_k[1], 1.0 / uniform_over))
        print(f"{tag}: forward max abs err {fwd} (tol ctx {ATTN_F32_TOL}, P {ATTN_F32_P_TOL}); "
              f"dq/dk/dv relative to max |plain| {rel} (tol {ATTN_F32_GRAD_REL_TOL}); length-0 "
              f"row against uniform {uni}; reruns bit-equal (and the serving ctx the save "
              f"mode's) {same}; ctx/grads {sorted(map(str, types))}")
        if not (types == {f32} and fwd["ctx"] <= ATTN_F32_TOL and fwd["P"] <= ATTN_F32_P_TOL
                and max(rel.values()) <= ATTN_F32_GRAD_REL_TOL and uni <= ATTN_F32_P_TOL
                and same and torch.isfinite(ctx_k).all()):
            fail("attention fp32", f"{tag}: the kernels disagree with the plain fp32 twins: "
                                   f"{fwd} {rel}, uniform {uni}, bit-equal {same}, {types}")
        return ctx_k, w_k, g_k, max(fwd.values()), max(max_err(a, b) for a, b in zip(g_k, g_p))

    def times(fwd_k, fwd_p, bwd_k, bwd_p, q, k, v, lib_mask, dctx):
        return dict(
            fwd=time_ms(fwd_k), fwd_device=device_ms(fwd_k), fwd_plain=time_ms(fwd_p),
            fwd_library=time_ms(lambda: sdpa(q, k, v, lib_mask)),
            fwd_library_device=device_ms(lambda: sdpa(q, k, v, lib_mask)),
            bwd=time_ms(bwd_k), bwd_device=device_ms(bwd_k), bwd_plain=time_ms(bwd_p),
            bwd_library_device=sdpa_bwd_device_ms(q, k, v, lib_mask, dctx))

    k4_err, k4_berr, timed = 0.0, 0.0, {}
    for B, Ta, Tv in K4F32_SHAPES:
        q, k, v, vlen, dctx = full_f32(k4_inputs(B, 4, Ta, Tv, 128, dev, seed=Ta + Tv + 3),
                                       seed=Ta + Tv)
        ctx_k, w_k, g_k, e, be = check(
            f"K4 fp32 [B={B},4 heads,T_a={Ta},T_v={Tv},A=dv=128]", "fusion_attention", q, k, v,
            vlen, dctx, lambda: fus.fusion_attention_fwd_plain(q, k, v, vlen)[:2], Tv)
        k4_err, k4_berr = max(k4_err, e), max(k4_berr, be)
        if (B, Ta, Tv) == K4F32_SHAPES[0]:
            lib_mask = ((torch.arange(Tv, device=dev)[None, :] >= vlen[:, None]).float()
                        * -1e9)[:, None, None, :]
            w_p = fus.fusion_attention_fwd_plain(q, k, v, vlen)[1]
            t = timed["K4"] = times(
                lambda: fus.fusion_attention_fwd(q, k, v, vlen, save=True),
                lambda: fus.fusion_attention_fwd_plain(q, k, v, vlen),
                lambda: fus.core_route_bwd("fusion_attention", q, k, v, w_p, dctx),
                lambda: fus.attention_bwd_from_weights(q, k, v, w_p, dctx), q, k, v, lib_mask,
                dctx)
            t["bound_fwd"], t["bound_bwd"] = attn_f32_bounds(q, k, v, ctx_k, w_k, dctx, g_k,
                                                             (vlen,))
    k5_err, k5_berr = {}, {}
    for name, B, Q, S, dk, dv, causal in K5F32_SHAPES:
        q, k, v, bias, dctx = full_f32(k5_inputs(B, Q, S, dk, dv, dev, causal, seed=Q + S + 5),
                                       seed=Q + S)

        def plain():
            ctx, st = tdec.decoder_attention_fwd_plain(q, k, v, bias, save=True)
            return ctx, tdec.decoder_attention_weights(q, k, bias, *st)

        ctx_k, w_k, g_k, e, be = check(
            f"K5 fp32 {name} [B={B},Q={Q},S={S},4 heads,dk={dk},dv={dv}]", "decoder_attention",
            q, k, v, bias, dctx, plain, None if causal else S)
        k5_err[name], k5_berr[name] = e, be
        if name in ("fast self", "fast cross"):
            lib_mask = (torch.triu(torch.full((Q, S), -1e9, device=dev), diagonal=1) if causal
                        else bias[:, None, None, :])
            w_p = plain()[1]
            t = timed[name] = times(
                lambda: tdec.decoder_attention_fwd(q, k, v, bias, save=True),
                lambda: tdec.decoder_attention_fwd_plain(q, k, v, bias),
                lambda: fus.core_route_bwd("decoder_attention", q, k, v, w_p, dctx),
                lambda: fus.attention_bwd_from_weights(q, k, v, w_p, dctx), q, k, v, lib_mask,
                dctx)
            t["bound_fwd"], t["bound_bwd"] = attn_f32_bounds(
                q, k, v, ctx_k, w_k, dctx, g_k, () if bias is None else (bias,))
    for key, t in timed.items():
        print(f"attention fp32 {key}: fwd kernel {t['fwd']:.4f} ms (device "
              f"{t['fwd_device']:.4f})  plain {t['fwd_plain']:.4f}  library "
              f"(scaled_dot_product_attention, fp32, same mask) {t['fwd_library']:.4f} (device "
              f"{t['fwd_library_device']:.4f})  bound {t['bound_fwd'][0]:.5f} "
              f"({t['bound_fwd'][1]}); bwd kernel {t['bwd']:.4f} ms (device "
              f"{t['bwd_device']:.4f})  plain {t['bwd_plain']:.4f}  library (its backward, "
              f"device) {t['bwd_library_device']:.4f}  bound {t['bound_bwd'][0]:.5f} "
              f"({t['bound_bwd'][1]})")
    k4 = timed["K4"]
    for d in ("fwd", "bwd"):
        report[f"fusion_attention_f32_{d}"] = dict(
            max_abs_err=k4_err if d == "fwd" else k4_berr, ms=k4[d], plain_ms=k4[f"{d}_plain"],
            library_ms=k4[f"{d}_library_device" if d == "bwd" else f"{d}_library"],
            device_ms=k4[f"{d}_device"], bound=k4[f"bound_{d}"],
            library_device_ms=k4[f"{d}_library_device"],
            shape="B=128, 4 heads, T_a=50, T_v=150, A=dv=128")

        def pair(key):
            return timed["fast self"][key] + timed["fast cross"][key]

        b = [timed[n][f"bound_{d}"] for n in ("fast self", "fast cross")]
        report[f"decoder_attention_f32_{d}"] = dict(
            max_abs_err=max((k5_err if d == "fwd" else k5_berr).values()), ms=pair(d),
            plain_ms=pair(f"{d}_plain"),
            library_ms=pair(f"{d}_library_device" if d == "bwd" else f"{d}_library"),
            device_ms=pair(f"{d}_device"),
            bound=(b[0][0] + b[1][0], b[0][1] if b[0][1] == b[1][1] else "bytes+operations"),
            library_device_ms=pair(f"{d}_library_device"),
            self_device_ms=timed["fast self"][f"{d}_device"],
            cross_device_ms=timed["fast cross"][f"{d}_device"],
            shape="the fast model's self (Q=S=80, 4x64) and cross (S=50, 128/256) pair, B=128")


def phase_k6_f32(dev, report):
    """K6's fp32 instance (``decode_attention_f32``, the general kernel)
    against the plain fp32 twin at a beam step (N = 80, W = 10 over the
    untiled memory) and a greedy step (N = 128): self over the 150-step
    cache at positions 0, 37, 149, cross over the fast model's 6 s and 16 s
    memories with a length-0 row; reruns bit-equal; one step's pair timed
    with its bound and the library yardstick."""
    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.models import transformer_decoder as tdec

    f32 = torch.float32

    def check(label, q, k, v, bias, n_keys, W=1):
        route = kernels.decode_attention_route(q.shape[0], k.shape[0], k.shape[1], n_keys,
                                               q.shape[1], q.shape[2], v.shape[-1],
                                               bias is not None, q.dtype)
        out_k = tdec.decode_attention(q, k, v, bias, n_keys)
        same = torch.equal(out_k, tdec.decode_attention(q, k, v, bias, n_keys))
        err = max_err(out_k, tdec.decode_attention_plain(q, k, v, bias, n_keys))
        uni = 0.0
        if bias is not None:  # memory row 1 is empty: its beams read the mean of its values
            uni = max_err(out_k[W:2 * W], v[1].mean(dim=0)[None].expand(W, -1, -1))
        print(f"K6 fp32 {label} ({route}) max abs err {err} (tol {K6F32_TOL}); length-0 row "
              f"against the mean of its values: {uni}; two launches bit-equal: {same}")
        if not (route == "general" and out_k.dtype == f32 and err <= K6F32_TOL
                and uni <= K6F32_TOL and same):
            fail("K6 fp32", f"{label} disagrees: {err}, length-0 row {uni}, bit-equal {same}, "
                            f"route {route}, {out_k.dtype}")
        return err

    worst = 0.0
    for N, B in K6_ROWS:
        W = N // B
        for pos in K6_POS:
            q, k, v, _ = full_f32(k6_inputs(N, N, 150, 64, 64, dev, False, seed=N + pos + 1),
                                  seed=pos)
            worst = max(worst, check(f"self [N={N},L=150,pos={pos},4x64]", q, k, v, None,
                                     pos + 1))
        for S in K6F32_MEMORIES:
            q, k, v, bias = full_f32(k6_inputs(N, B, S, 128, 256, dev, True, seed=N + S + 1),
                                     seed=S)
            worst = max(worst, check(f"cross [N={N},B={B},W={W},S={S},dk=128,dv=256]",
                                     q, k, v, bias, S, W))
    # phase 68's warm-up: greedy over a 4-step horizon
    q, k, v, _ = full_f32(k6_inputs(128, 128, 4, 64, 64, dev, False, seed=9), seed=9)
    worst = max(worst, check("self, a 4-step horizon [N=128,L=4,pos=3,4x64]", q, k, v, None, 4))
    pos, pairs = 149, {}
    for N, B in K6_ROWS:
        W = N // B
        qs, ks, vs, _ = full_f32(k6_inputs(N, N, 150, 64, 64, dev, False, seed=1), seed=1)
        self_mask = torch.zeros((N, 1, 1, 150), device=dev)
        self_mask[..., pos + 1:] = -1e9
        qc, kc, vc, bc = full_f32(k6_inputs(N, B, 50, 128, 256, dev, True, seed=2), seed=2)
        qw = qc.view(B, W, 4, 128)

        def step_pair():
            tdec.decode_attention(qs, ks, vs, None, pos + 1)
            tdec.decode_attention(qc, kc, vc, bc, 50)

        def plain_pair():
            tdec.decode_attention_plain(qs, ks, vs, None, pos + 1)
            tdec.decode_attention_plain(qc, kc, vc, bc, 50)

        def library_pair():
            sdpa(qs[:, None], ks, vs, self_mask)
            sdpa(qw, kc, vc, bc[:, None, None, :])

        fl = 2 * N * 4 * ((pos + 1) * 128 + 50 * 384)
        nb = (pos + 1) * N * 4 * 64 * 4 * 2 + 2 * N * 4 * 64 * 4 \
            + B * 50 * 4 * 384 * 4 + B * 50 * 4 + N * 4 * 384 * 4
        r = pairs[N] = dict(
            ms=time_ms(step_pair), plain_ms=time_ms(plain_pair), library_ms=time_ms(library_pair),
            device_ms=device_ms(step_pair), bound=bound(nb, fl, "fp32"))
        print(f"K6 fp32 pair at N={N} (W={W}), pos {pos}, cross over S=50: kernel "
              f"{r['ms']:.4f} ms (device {r['device_ms']:.4f})  plain {r['plain_ms']:.4f} ms  "
              f"library {r['library_ms']:.4f} ms  bound {r['bound'][0]:.5f} ms ({r['bound'][1]})")
    beam, greedy = (pairs[N] for N, _ in K6_ROWS)
    report["decode_attention_f32"] = dict(
        max_abs_err=worst, ms=beam["ms"], plain_ms=beam["plain_ms"],
        library_ms=beam["library_ms"], device_ms=beam["device_ms"], bound=beam["bound"],
        shape="one beam step's pair at N=80 (B=8, W=10), self pos 149, cross over S=50",
        greedy={"ms": greedy["ms"], "plain_ms": greedy["plain_ms"],
                "library_ms": greedy["library_ms"], "device_ms": greedy["device_ms"],
                "bound_ms": greedy["bound"][0], "bound_by": greedy["bound"][1]})


def k8_f32_inputs(B, dev, seed, T=197, Tv=150):
    """``k8_inputs`` as the fp32 policy holds them: the weights, the input
    product and the prepared video memory (fp32 keys and values) with full
    fp32 mantissas (``full_f32``: a kernel that rounded one to bf16 would
    show); the masks and the memory bias exact."""
    import torch

    cell, att, ctx_proj, xw, mask, mem, _ = k8_inputs(B, dev, seed, T=T, Tv=Tv)
    wh, b, cp, wq, v, wm, xw, values, keys = full_f32(
        (cell["wh"], cell["b"], ctx_proj, att["wq"], att["v"], att["wm"], xw, mem.values,
         mem.keys), seed)
    mem = mem._replace(values=values, keys=keys)
    return [{"wh": wh, "b": b}, {"wq": wq, "v": v, "wm": wm}, cp, xw, mask, mem, torch.float32]


def k10_f32_inputs(N, dev, seed, S=197, W=1):
    """``k10_inputs`` as the fp32 policy holds them: the query, the attention
    and the prepared fused memory (fp32 keys and values) with full fp32
    mantissas (``full_f32``); the mask and the bias exact."""
    import torch

    typ, att, query, mem, _ = k10_inputs(N, dev, seed, S=S, W=W)
    wq, v, wm, query, keys, values = full_f32(
        (att["wq"], att["v"], att["wm"], query, mem.keys, mem.values), seed)
    return [typ, {"wq": wq, "v": v, "wm": wm}, query, mem._replace(keys=keys, values=values),
            torch.float32]


def f32_build(phase, stem, parts):
    """The fp32 instances of ``csrc/<stem>.cu``'s kernels whose mangled names
    hold one of ``parts``: registers and spills (``ptxas -v``); fails on a
    spill or a missing one."""
    from avsr_tpu_torch import kernels

    rep = {next(p for p in parts if p in n): r for n, r in kernels.ptxas_report(stem).items()
           if f32_instance(n) and any(p in n for p in parts)}
    print(f"{phase} fp32 instances (ptxas -v; CUDA cores): {rep}")
    if len(rep) != len(parts) or any(r["spill_stores"] or r["spill_loads"] for r in rep.values()):
        fail(phase, f"an fp32 instance spills or is missing: {rep}")
    return rep


def phase_k8_f32(dev, report):
    """K8's fp32 instance (``av_align_scan_f32[_bwd]``, the per-step
    kernels) against the plain fp32 twins at ``K8F32_SHAPES``: the forward in
    save mode and serving (``k8_fwd_check``: hs, ctxs, aligns, the final and
    saved carries, the empty rows exactly 0, reruns bit-equal), the backward
    on the forward's carries with random cotangents (``k8_bwd_against_plain``:
    every output and weight gradient); the chunked gate launch's shared
    memory against the library's; device ms, the grid launches a call, times
    and bounds at the train shape, and at the others' device ms."""
    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.models import fusion as fus

    f32 = torch.float32
    lib = kernels._load()
    bad = [(H, Dv, A, S) for H in (64, 256, 512) for Dv in (64, 512, 768) for A in (64, 128, 512)
           for S in (1, 150, kernels.FUSION_MAX_TV)
           if lib.avsr_av_align_f32_smem(H, Dv, A, S, Dv) != kernels.av_align_step_smem(
               H, Dv, A, S, 4)]
    if bad:
        fail("K8 fp32", f"kernels.av_align_step_smem(..., 4) differs from the library's at {bad}")
    build = f32_build("K8 fp32", "av_align_scan", (
        "align_gate_f32_kernel", "align_read_kernel_t", "align_regate_kernel",
        "align_bwd_product_kernel", "align_bwd_row_kernel"))
    errs, berrs, babs, by_shape = [], [], [], {}
    for T, B, Tv in K8F32_SHAPES:
        tag = f"[T_a={T},B={B},H=256,T_v={Tv},A=128,Dv=512]"
        smem = kernels.av_align_step_smem(256, 512, 128, Tv, 4)
        args = k8_f32_inputs(B, dev, seed=T + B + 11, T=T, Tv=Tv)
        errs.append(k8_fwd_check(f"K8 fp32 {tag} (gate launch {smem} B a block)", args,
                                 "bahdanau", K8F32_ALIGN_TOL, route="step", tol=K8F32_TOL))
        bargs = k8_bwd_inputs(B, dev, seed=T + B + 13, make=k8_f32_inputs, T=T, Tv=Tv)
        route = kernels.av_align_bwd_family(256, 512, 128, Tv, 512, False, f32)
        if route != "step" or any(r.dtype != f32 for r in bargs[7]):
            fail("K8 fp32", f"{tag}: backward route {route}, residuals "
                            f"{[r.dtype for r in bargs[7]]}")
        e, rel = k8_bwd_against_plain(f"K8 fp32 bwd {tag}", bargs, "bahdanau", K8F32B_REL_TOL)
        babs.append(e)
        berrs.append(max(rel.values()))
        fwd = lambda: fus.av_align_scan_fwd(*args)  # noqa: E731
        train = lambda: fus.av_align_scan_fwd(*args, save=True)  # noqa: E731
        bwd = lambda: fus.av_align_scan_bwd(*bargs)  # noqa: E731
        r = {"device_ms": device_ms(fwd, reps=3, warmup=1),
             "device_ms_save": device_ms(train, reps=3, warmup=1),
             "bwd_device_ms": device_ms(bwd, reps=3, warmup=1)}
        if (T, B, Tv) == K8F32_SHAPES[0]:  # the train shape: times, bounds, launches
            r.update(ms=time_ms(train, reps=5, warmup=1),
                     plain_ms=time_ms(lambda: fus.av_align_scan_fwd_plain(*args, save=True),
                                      reps=2, warmup=1),
                     bwd_ms=time_ms(bwd, reps=5, warmup=1),
                     bwd_plain_ms=time_ms(lambda: fus.av_align_scan_bwd_plain(*bargs), reps=2,
                                          warmup=1),
                     # the route's host loop: a gate and a read launch a step;
                     # the backward's regate, then a row launch a step and a
                     # product launch between two steps
                     grid_launches=2 * T, bwd_grid_launches=2 * T)
            cell, att, ctx_proj, xw, mask, mem, _ = args
            H4, S, A, Dv = xw.shape[-1], mem.keys.shape[1], mem.keys.shape[2], mem.values.shape[-1]
            H, Dc = H4 // 4, Dv
            # what this run's data needs: the live steps' gates and reads, the
            # context and the backward's key terms over the valid keys
            live = float(mask.sum())
            keys_read = float((mask * mem.mask.sum(-1)[None, :]).sum())
            w_bytes = nbytes(cell["wh"], cell["b"], ctx_proj, att["wq"], att["v"])
            out, res = train()
            r["bound"] = bound(
                nbytes(xw, mask, mem.keys, mem.values, mem.bias, mem.mask, *out, *res) + w_bytes,
                2 * live * ((H + Dc) * H4 + H * A + S * A) + 2 * keys_read * Dv, "fp32")
            r["bound_gates_ms"] = 2 * T * B * (H + Dc) * H4 / PEAK_FLOPS["fp32"] * 1e3
            out_b = bwd()
            b_xw, b_mask, b_mem, aligns, res_b = bargs[3], bargs[4], bargs[5], bargs[6], bargs[7]
            r["bwd_bound"] = bound(
                nbytes(b_xw, b_mask, b_mem.keys, b_mem.values, aligns, *res_b, *bargs[8:13],
                       *out_b) + w_bytes,
                4 * live * (H + Dc) * H4 + 4 * live * H * A + 4 * keys_read * Dv
                + 8 * keys_read * A, "fp32")
        r["us_per_step"] = r["device_ms_save"] * 1e3 / T
        r["bwd_us_per_step"] = r["bwd_device_ms"] * 1e3 / T
        by_shape[(T, B, Tv)] = r
        print(f"K8 fp32 {tag}: {r}")
        del args, bargs
    t, s8, s16 = (by_shape[x] for x in K8F32_SHAPES)
    T = K8F32_SHAPES[0][0]
    print(f"K8 fp32 [T_a={T},B=128] forward (save) kernel {t['ms']:.4f} ms (device "
          f"{t['device_ms_save']:.4f}, {t['grid_launches']} grid launches, "
          f"{t['us_per_step']:.2f} us a step)  plain {t['plain_ms']:.4f} ms  bound "
          f"{t['bound'][0]:.5f} ms ({t['bound'][1]}; the gate products alone "
          f"{t['bound_gates_ms']:.5f}); backward kernel {t['bwd_ms']:.4f} ms (device "
          f"{t['bwd_device_ms']:.4f}, {t['bwd_grid_launches']} grid launches)  plain "
          f"{t['bwd_plain_ms']:.4f} ms  bound {t['bwd_bound'][0]:.5f} ms ({t['bwd_bound'][1]}); "
          f"no single PyTorch call computes the scan")
    report["av_align_scan_f32"] = dict(
        max_abs_err=max(errs), ms=t["ms"], plain_ms=t["plain_ms"], library_ms=None,
        device_ms=t["device_ms_save"], bound=t["bound"], shape="T_a=197, B=128, save mode",
        device_ms_no_save=t["device_ms"], grid_launches_per_call=t["grid_launches"],
        us_per_step=t["us_per_step"], bound_gate_products_ms=t["bound_gates_ms"],
        device_ms_B8=s8["device_ms"], device_ms_T531_B4=s16["device_ms"],
        build={k: v for k, v in build.items() if k in ("align_gate_f32_kernel",
                                                       "align_read_kernel_t")})
    report["av_align_scan_f32_bwd"] = dict(
        max_abs_err=max(babs), max_rel_err=max(berrs), ms=t["bwd_ms"],
        plain_ms=t["bwd_plain_ms"], library_ms=None, device_ms=t["bwd_device_ms"],
        bound=t["bwd_bound"], shape="T_a=197, B=128", grid_launches_per_call=t["bwd_grid_launches"],
        us_per_step=t["bwd_us_per_step"], device_ms_B8=s8["bwd_device_ms"],
        device_ms_T531_B4=s16["bwd_device_ms"],
        build={k: v for k, v in build.items() if k not in ("align_gate_f32_kernel",
                                                           "align_read_kernel_t")})


def unported_raise(dev):
    """The families whose fp32 instance is still to be ported refuse the fp32
    policy on the card by name, launching nothing: K8's and K10's Luong
    reads and K2."""
    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.models import fusion as fus
    from avsr_tpu_torch.ops import attention as attn
    from avsr_tpu_torch.ops import rnn

    f32 = torch.float32
    k8l = k8_luong_inputs(4, dev, seed=5, T=20, Tv=15)[:-1]
    _, att, query, mem, _ = k10_luong_inputs(4, dev, seed=6, S=20)
    wh, b, xw, mask, h0, c0 = k1_inputs(20, 1, 4, 256, dev)
    calls = (("K8 Luong", lambda: fus.av_align_scan_fwd(*k8l, f32, attention_type="luong")),
             ("K10 Luong", lambda: attn.attend_fwd("luong", att, query, mem, f32)),
             ("K2", lambda: rnn.scan_core_fwd(wh, b, xw.float(), mask, h0, c0, f32, False)))
    for family, call in calls:
        before = dict(kernels.LAUNCHES)
        try:
            call()
        except ValueError as e:
            said = str(e)
        else:
            said = None
        torch.cuda.synchronize()
        print(f"fp32 policy, {family} on the card: {said!r}")
        if said is None or not said.startswith(f"{family}: the fp32 instance"):
            fail("fp32 unported", f"{family} under fp32 did not raise its named ValueError")
        if kernels.LAUNCHES != before:
            fail("fp32 unported", f"{family} under fp32 launched a kernel")


def phase_k10_f32(dev, report):
    """K10's fp32 instances against the plain fp32 twins: the general kernel
    (``bahdanau_attend_f32``) at ``K10F32_CASES`` (the empty row exactly 0,
    reruns bit-equal), the read loop's backward (``bahdanau_attend_f32_bwd``
    per step, ``bahdanau_attend_f32_sums`` once a loop) at N = 128, K = 80
    and over the 16 s memory; the general kernel's and the per-step
    kernel's shared memory against the library's; device ms, times and
    bounds at the beam step, greedy's read and the loop; then the named
    refusal of the families still to be ported (``unported_raise``)."""
    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.ops import attention as attn

    f32 = torch.float32
    lib = kernels._load()
    bad = [(Hq, A, S, Dv) for Hq in (16, 256, 512) for A in (8, 128, 512) for S in (1, 197, 531)
           for Dv in (8, 768, 2048)
           if lib.avsr_bahdanau_smem(Hq, A, S) != kernels.attend_general_smem(Hq, A, S)
           or lib.avsr_attend_step_bwd_smem(Hq, A, S, Dv) != kernels.attend_step_bwd_smem(
               Hq, A, S, Dv)]
    if bad:
        fail("K10 fp32", f"kernels.attend_general_smem / attend_step_bwd_smem differ from the "
                         f"library's at {bad}")
    build = f32_build("K10 fp32", "bahdanau_attend", (
        "bahdanau_attend_kernel", "attend_step_bwd_kernel", "attend_loop_sums_kernel"))
    worst, times = 0.0, {}
    for i, (what, N, W, S) in enumerate(K10F32_CASES):
        args = k10_f32_inputs(N, dev, seed=N + S + i, S=S, W=W)
        B = N // W
        route = kernels.attend_route(N, B, S, 256, 128, 768, False, f32)
        tag = f"K10 fp32 {what} [N={N}={B}x{W},S={S},Hq=256,A=128,Dv=768] route {route}"
        if route != "general":
            fail("K10 fp32", f"{tag}: expected the general kernel")
        before = kernels.LAUNCHES["bahdanau_attend_f32"]
        worst = max(worst, k10_fwd_check(tag, args, K10F32_W_TOL, W, ctx_tol=K10F32_CTX_TOL))
        if kernels.LAUNCHES["bahdanau_attend_f32"] - before != 2:
            fail("K10 fp32", f"{tag}: two reads did not launch bahdanau_attend_f32 twice")
        typ, att, query, mem, _ = args
        read = lambda: attn.attend(*args)  # noqa: E731
        t = {"device_ms": device_ms(read)}
        if S == 197:
            ctx, w = read()
            memory = nbytes(mem.keys, mem.values, mem.bias, mem.mask)
            nb = nbytes(query, att["wq"], att["v"], ctx, w) + memory
            t.update(ms=time_ms(read), plain_ms=time_ms(lambda: attn.attend_plain(*args)),
                     bound=bound(nb, 2 * N * (256 * 128 + 2 * S * 128 + S * 768), "fp32"),
                     memory_streamed_mb=N * memory / B / 1e6)
        times[what] = t
        print(f"{tag}: {t}")
    args = k10_f32_inputs(128, dev, seed=131)
    st, out_k, queries, dctxs, bw = k10_bwd_check(
        "K10 fp32 bwd [N=128,S=197,A=128,Dv=768]", args, K10_LOOP, seed=7, tol=K10F32B_REL_TOL)
    bw = max(bw, k10_bwd_check("K10 fp32 bwd [N=16,S=531,A=128,Dv=768]",
                               k10_f32_inputs(16, dev, seed=531, S=531), 8, seed=8,
                               tol=K10F32B_REL_TOL)[-1])
    step, sums = k10_bwd_times("K10 fp32 bwd", args, st, queries, dctxs, out_k)
    if sums["sums_route"] != "cuda_core" or st.operands[0].dtype != f32:
        fail("K10 fp32", f"the loop's sums took {sums['sums_route']}, operands "
                         f"{st.operands[0].dtype}")
    beam, one = times["beam step"], times["one query a row"]
    report["bahdanau_attend_f32"] = dict(
        max_abs_err=worst, ms=beam["ms"], plain_ms=beam["plain_ms"], library_ms=None,
        device_ms=beam["device_ms"], bound=beam["bound"], shape="beam step N=80 (B=8, W=10), S=197",
        memory_streamed_mb=beam["memory_streamed_mb"],
        greedy={"ms": one["ms"], "plain_ms": one["plain_ms"], "device_ms": one["device_ms"],
                "bound_ms": one["bound"][0], "bound_by": one["bound"][1]},
        device_ms_16s_beam=times["beam step, 16 s"]["device_ms"],
        device_ms_16s_one=times["one query a row, 16 s"]["device_ms"],
        registers=build["bahdanau_attend_kernel"]["registers"])
    report["bahdanau_attend_f32_bwd"] = dict(max_abs_err=bw, **step,
                                             registers=build["attend_step_bwd_kernel"]["registers"])
    report["bahdanau_attend_f32_sums"] = dict(
        max_abs_err=bw, **sums, registers=build["attend_loop_sums_kernel"]["registers"])
    unported_raise(dev)


def phase_remat(dev, card, cfg, label, needed, steps=CELL_OPTION_STEPS):
    """``cfg`` trained at full width from one seed without ``train.remat``,
    with it, and without it again (B = 128, 6 s, noise and dropout on): the
    first step's loss and every gradient leaf of the remat run bit-equal to
    the first run's where the two runs without remat are bit-equal to each
    other, and within ``RESUME_LOSS_REL_TOL`` (relative; the card's atomic
    sums) where they are not; the same for the losses of ``steps`` steps;
    each run's peak device memory (``max_memory_allocated``, reset between
    runs), ms per step and one more step's device busy ms (profiler).  -> launches over the three runs."""
    import dataclasses

    import torch

    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.configs import NoiseConfig
    from avsr_tpu_torch.data.units import builtin_unit_dict
    from avsr_tpu_torch.train import step as tstep
    from avsr_tpu_torch.utils import rng as trng
    from avsr_tpu_torch.utils.params import tree_leaves

    cfg = cfg.replace(noise=NoiseConfig(enabled=True))
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, lr_schedule="constant",
                                                learning_rate=1e-4))
    V = builtin_unit_dict(cfg.data.unit).vocab_size
    batch, _ = train_batch(cfg, V, dev)
    bank = noise_bank(cfg, dev)
    runs = {}
    kernels.reset_launches()
    for tag, remat in (("no remat", False), ("remat", True), ("no remat again", False)):
        c = cfg.replace(train=dataclasses.replace(cfg.train, remat=remat))
        state, opt = tstep.create_train_state(c, V, torch.Generator().manual_seed(0), dev)
        names = ["/".join(map(str, p)) for p, _ in tree_leaves(state.params)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        m, g = tstep.loss_and_grads(state.params, batch, cfg=c,
                                    generator=trng.generator_for(7, dev), noise_bank=bank)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        gen = torch.Generator().manual_seed(11)
        losses, times = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, metrics = tstep.train_step(state, batch, cfg=c, optimizer=opt, generator=gen,
                                              noise_bank=bank)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics["loss"].detach().clone())
        events, span = device_events(lambda: tstep.train_step(
            state, batch, cfg=c, optimizer=opt, generator=gen, noise_bank=bank))
        busy = busy_share(events, span)[0] / 1e3
        runs[tag] = dict(loss=m["loss"], grads=g, losses=losses, peak=peak, live=live,
                         ms=statistics.median(times[1:]), busy=busy)
        print(f"{label} [{card}] {tag}: loss {float(m['loss']):.6f}; peak device memory of the "
              f"step {peak / 2**30:.3f} GiB (max_memory_allocated; {(peak - live) / 2**30:.3f} "
              f"GiB above the {live / 2**30:.3f} GiB live before it); {steps} steps "
              f"{[round(float(x), 4) for x in losses]}, median ms/step after the first "
              f"{runs[tag]['ms']:.3f}; one more step's device busy time {busy:.3f} ms "
              f"({len(events)} device events)")
        del state, opt, g
    launches = dict(kernels.LAUNCHES)
    a, r, a2 = runs["no remat"], runs["remat"], runs["no remat again"]
    det, nondet = 0, []
    for n, x, y, z in zip(names, a["grads"], r["grads"], a2["grads"]):
        if x is None or y is None or not torch.isfinite(y).all():
            fail(label, f"gradient of {n} missing or non-finite")
        if torch.equal(x, z):
            det += 1
            if not torch.equal(x, y):
                fail(label, f"{n}: the remat gradient differs from the run without remat "
                            f"({rel_err(y, x):.3e}) where two runs without it are bit-equal")
        else:
            nondet.append((n, float((y - x).norm() / x.norm()), float((z - x).norm() / x.norm())))
            if nondet[-1][1] > RESUME_LOSS_REL_TOL:
                fail(label, f"{n}: the remat gradient is {nondet[-1][1]:.3e} from the run "
                            f"without remat, past {RESUME_LOSS_REL_TOL}")
    steps_equal = []
    for i, (x, y, z) in enumerate(zip(a["losses"], r["losses"], a2["losses"])):
        if torch.equal(x, z) and not torch.equal(x, y):
            fail(label, f"step {i + 1}: the remat loss {float(y)} differs from {float(x)} where "
                        f"two runs without remat agree")
        if abs(float(y) - float(x)) > RESUME_LOSS_REL_TOL * abs(float(x)):
            fail(label, f"step {i + 1}: the remat loss {float(y)} is not {float(x)}")
        steps_equal.append(bool(torch.equal(x, y)))
    if not torch.equal(a["loss"], r["loss"]):
        fail(label, f"the remat step's loss {float(r['loss'])} is not {float(a['loss'])}")
    for name in needed:
        if launches[name] == 0:
            fail(label, f"kernel {name} was not launched by the training runs")
    check_other_route(label, launches)
    saved = (a["peak"] - a["live"]) - (r["peak"] - r["live"])
    print(f"{label} [{card}] {cfg.name} B=128 6 s: loss bit-equal with and without remat; "
          f"{det} of {len(names)} gradient leaves bit-equal (where the two runs without remat "
          f"are); {len(nondet)} leaves differ between the two runs without remat (the card's "
          f"atomics) and there the remat run is within {RESUME_LOSS_REL_TOL}: {nondet}; "
          f"{steps} steps' losses bit-equal {steps_equal}; peak of the step above live memory "
          f"{(a['peak'] - a['live']) / 2**30:.3f} GiB without remat, "
          f"{(r['peak'] - r['live']) / 2**30:.3f} GiB with it (saved {saved / 2**30:.3f} GiB); "
          f"ms/step {a['ms']:.3f} / {a2['ms']:.3f} without, {r['ms']:.3f} with remat; device busy "
          f"ms a step {a['busy']:.3f} / {a2['busy']:.3f} without, {r['busy']:.3f} with")
    return launches


def tree_map_like(tree, values):
    """``tree`` with its tensor leaves replaced, in ``tree_leaves`` order,
    by the next items of the iterator ``values``."""
    if isinstance(tree, dict):
        return {k: tree_map_like(x, values) for k, x in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_like(x, values) for x in tree)
    import torch

    return next(values) if torch.is_tensor(tree) else tree


def main() -> int:
    import os
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from avsr_tpu_torch.configs import (audio_only_tcdtimit, av_align_noisy, bimodal_tcdtimit,
                                            lrs2_av_fast, lrs2_av_v2, lrs2_full,
                                            video_only_tcdtimit)
        from avsr_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail("device", f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # 2. build
    t0 = time.perf_counter()
    try:
        lib = kernels.build()
    except RuntimeError as e:
        fail("build", str(e))
    print(f"build: {time.perf_counter() - t0:.3f} s -> {lib.name} "
          f"(nvcc {kernels.BUILD_SECONDS if kernels.BUILD_SECONDS is not None else 'cached'} s)")

    cfg = lrs2_av_fast()
    align_cfg = lrs2_full()  # the lrs2_av_align preset
    v2_cfg = lrs2_av_v2()
    ul_cfg = uni_luong_cfg()
    rd_cfg, gru_cfg = rd_residual_cfg(), gru_highway_cfg()
    ln, spec = ln_cfg(), spectrogram_cfg()
    f32, af32 = fp32_cfg(), align_fp32_cfg()
    audio_cfg, video_cfg, bimodal_cfg = (audio_only_tcdtimit(), video_only_tcdtimit(),
                                         bimodal_tcdtimit())
    au_cfg = video_cfg.override({"video.use_au_features": True})
    noisy_cfg = av_align_noisy()
    report, paths, greedy_runs = {}, {}, {}
    held, launched = set(), set()  # (kernel, shapes) of KERNEL_PHASES and COVERED_PHASES
    # phases 46-47's runs, kept for phase 49's exports, and its artifacts
    work, keep = tempfile.TemporaryDirectory(prefix="chip_smoke_"), {}

    def subdir(name):
        os.makedirs(os.path.join(work.name, name))
        return os.path.join(work.name, name)

    def greedy(c, label, needed):
        paths[label], greedy_runs[label] = phase_greedy(dev, card, c, label, needed)

    for n, run in ((3, lambda: phase_k1(dev, report)),
                   (4, lambda: phase_k3(dev, report, cfg)),
                   (5, lambda: paths.update(serve=phase_serve(dev, card, cfg))),
                   (6, lambda: phase_k1_bwd(dev, report)),
                   (7, lambda: phase_k4(dev, report)),
                   (8, lambda: paths.update(train=phase_train(dev, card, cfg,
                                                              shares=(K4_SHARE, *K5_SHARES)))),
                   (9, lambda: phase_k5(dev, report)),
                   (10, lambda: phase_k6(dev, report)),
                   (11, lambda: phase_k7(dev, report)),
                   (12, lambda: greedy(cfg, "greedy", GREEDY_KERNELS)),
                   (13, lambda: phase_k8(dev, report)),
                   (14, lambda: phase_k10(dev, report)),
                   (15, lambda: paths.update(serve_align=phase_serve(
                       dev, card, align_cfg, "serve_align", SERVE_ALIGN_KERNELS, ((8, 197, 768),)))),
                   (16, lambda: greedy(align_cfg, "greedy_align", GREEDY_ALIGN_KERNELS)),
                   (17, lambda: phase_k8_bwd(dev, report)),
                   (18, lambda: phase_k10_bwd(dev, report)),
                   (19, lambda: paths.update(train_align=phase_train(
                       dev, card, align_cfg, "train_align", TRAIN_ALIGN_KERNELS))),
                   (20, lambda: phase_k11(dev, report)),
                   (21, lambda: phase_k9(dev, report)),
                   (22, lambda: paths.update(serve_v2=phase_serve(
                       dev, card, v2_cfg, "serve_v2", SERVE_V2_KERNELS, ((8, 197, 1024),)))),
                   (23, lambda: greedy(v2_cfg, "greedy_v2", GREEDY_KERNELS)),
                   (24, lambda: decode_records_no_autograd(
                       dev, v2_cfg, *greedy_runs.pop("greedy_v2"), "greedy_v2")),
                   (25, lambda: phase_k11_bwd(dev, report)),
                   (26, lambda: phase_k9_bwd(dev, report)),
                   # at 1e-4 from random weights the v2 model's AU loss rose
                   # 5x on the second step (the loss barely fell over 10);
                   # 3e-5 is about its preset's warmup lr at step 12
                   (27, lambda: paths.update(train_v2=phase_train(
                       dev, card, v2_cfg, "train_v2", TRAIN_V2_KERNELS, lr=3e-5,
                       shares=(K11_SHARE, K4_SHARE, *K5_SHARES)))),
                   (28, lambda: phase_k2(dev, report)),
                   (29, lambda: phase_k10_luong(dev, report)),
                   (30, lambda: phase_k8_luong(dev, report)),
                   (31, lambda: paths.update(serve_uni_luong=phase_serve(
                       dev, card, ul_cfg, "serve_uni_luong", SERVE_UL_KERNELS, ((8, 197, 512),)))),
                   (32, lambda: greedy(ul_cfg, "greedy_uni_luong", GREEDY_UL_KERNELS)),
                   (33, lambda: decode_records_no_autograd(
                       dev, ul_cfg, *greedy_runs.pop("greedy_uni_luong"), "greedy_uni_luong")),
                   (34, lambda: paths.update(train_uni_luong=phase_train(
                       dev, card, ul_cfg, "train_uni_luong", TRAIN_UL_KERNELS))),
                   (35, lambda: phase_core_route(dev)),
                   (36, lambda: phase_lstm_step_route(dev)),
                   (37, lambda: phase_align_step_route(dev)),
                   (38, lambda: paths.update(serve_audio=phase_serve(
                       dev, card, audio_cfg, "serve_audio", SERVE_AUDIO_KERNELS,
                       ((8, 197, 512),)))),
                   (39, lambda: paths.update(serve_video=phase_serve(
                       dev, card, video_cfg, "serve_video", SERVE_VIDEO_KERNELS,
                       ((8, 150, 512),)))),
                   (40, lambda: paths.update(serve_video_au=phase_serve(
                       dev, card, au_cfg, "serve_video_au", SERVE_VIDEO_KERNELS,
                       ((8, 150, 512),)))),
                   (41, lambda: paths.update(serve_bimodal=phase_serve(
                       dev, card, bimodal_cfg, "serve_bimodal", SERVE_BIMODAL_KERNELS,
                       ((8, 197, 512), (8, 150, 512))))),
                   (42, lambda: greedy(bimodal_cfg, "greedy_bimodal", GREEDY_BIMODAL_KERNELS)),
                   (43, lambda: decode_records_no_autograd(
                       dev, bimodal_cfg, *greedy_runs.pop("greedy_bimodal"), "greedy_bimodal")),
                   (44, lambda: paths.update(train_bimodal=phase_train(
                       dev, card, bimodal_cfg, "train_bimodal", TRAIN_BIMODAL_KERNELS))),
                   (45, lambda: paths.update(eval_noisy=phase_eval_noisy(dev, card, noisy_cfg))),
                   (46, lambda: paths.update(trainer_align=phase_trainer_align(
                       dev, card, align_cfg, work=subdir("align"), keep=keep))),
                   (47, lambda: paths.update(cli_fast=phase_cli_fast(
                       dev, card, work=subdir("fast"), keep=keep))),
                   (49, lambda: paths.update(phase_export(dev, card, keep, work.name))),
                   (50, lambda: paths.update(serve_http=phase_serve_http(
                       dev, card, keep["artifacts"]["artifact_fast"]))),
                   (51, lambda: phase_k1_rd(dev, report)),
                   (52, lambda: phase_k12(dev, report)),
                   (53, lambda: paths.update(train_rd_residual=phase_train(
                       dev, card, rd_cfg, "train_rd_residual", TRAIN_RD_KERNELS,
                       steps=CELL_OPTION_STEPS))),
                   (54, lambda: paths.update(serve_rd_residual=phase_serve(
                       dev, card, rd_cfg, "serve_rd_residual", SERVE_RD_KERNELS,
                       ((8, 197, 768),)))),
                   (55, lambda: paths.update(train_gru_highway=phase_train(
                       dev, card, gru_cfg, "train_gru_highway", TRAIN_GRU_KERNELS,
                       steps=CELL_OPTION_STEPS))),
                   (56, lambda: paths.update(serve_gru_highway=phase_serve(
                       dev, card, gru_cfg, "serve_gru_highway", SERVE_GRU_KERNELS,
                       ((8, 197, 768),)))),
                   (57, lambda: phase_k13(dev, report)),
                   (58, lambda: phase_k3_options(dev, report, cfg)),
                   (59, lambda: paths.update(train_ln=phase_train(
                       dev, card, ln, "train_ln", TRAIN_LN_KERNELS, spread=True))),
                   (60, lambda: paths.update(serve_ln=phase_serve(
                       dev, card, ln, "serve_ln", SERVE_LN_KERNELS, ((8, 197, 768),),
                       spread=True))),
                   (61, lambda: paths.update(train_spectrogram=phase_train(
                       dev, card, spec, "train_spectrogram", TRAIN_SPEC_KERNELS, lr=SPEC_LR))),
                   (62, lambda: paths.update(serve_spectrogram=phase_serve(
                       dev, card, spec, "serve_spectrogram", SERVE_SPEC_KERNELS))),
                   (63, lambda: phase_k1_f32(dev, report)),
                   (64, lambda: phase_attn_f32(dev, report)),
                   (65, lambda: phase_k6_f32(dev, report)),
                   (66, lambda: paths.update(train_fp32=phase_train(
                       dev, card, f32, "train_fp32", TRAIN_FP32_KERNELS,
                       steps=FP32_TRAIN_STEPS, loss_tol=FP32_LOSS_REL_TOL,
                       leaf_tol=FP32_GRAD_LEAF_REL_TOL))),
                   (67, lambda: paths.update(serve_fp32=phase_serve(
                       dev, card, f32, "serve_fp32", SERVE_FP32_KERNELS, mem_tol=FP32_MEMORY_TOL,
                       exact=True))),
                   (68, lambda: paths.update(greedy_fp32=phase_greedy(
                       dev, card, f32, "greedy_fp32", GREEDY_FP32_KERNELS, exact=True)[0])),
                   (69, lambda: paths.update(remat_align=phase_remat(
                       dev, card, align_cfg, "remat_align", TRAIN_ALIGN_KERNELS))),
                   (70, lambda: paths.update(remat_rd_residual=phase_remat(
                       dev, card, rd_cfg, "remat_rd_residual", TRAIN_RD_KERNELS))),
                   (71, lambda: phase_k8_f32(dev, report)),
                   (72, lambda: phase_k10_f32(dev, report)),
                   (73, lambda: paths.update(train_align_fp32=phase_train(
                       dev, card, af32, "train_align_fp32", TRAIN_ALIGN_FP32_KERNELS,
                       steps=FP32_TRAIN_STEPS, loss_tol=FP32_LOSS_REL_TOL,
                       leaf_tol=FP32_GRAD_LEAF_REL_TOL))),
                   (74, lambda: paths.update(serve_align_fp32=phase_serve(
                       dev, card, af32, "serve_align_fp32", SERVE_ALIGN_FP32_KERNELS,
                       ((8, 197, 768),), mem_tol=FP32_MEMORY_TOL, exact=True))),
                   (75, lambda: paths.update(greedy_align_fp32=phase_greedy(
                       dev, card, af32, "greedy_align_fp32", GREEDY_ALIGN_FP32_KERNELS,
                       exact=True, tie_tol=GREEDY_F32_TIE_TOL)[0]))):
        t0 = time.perf_counter()
        with (record_shapes(held) if n in KERNEL_PHASES
              else record_shapes(launched) if n in COVERED_PHASES else contextlib.nullcontext()):
            run()
        print(f"phase {n}: {time.perf_counter() - t0:.1f} s")
        if n == 37:
            t_new = time.perf_counter()
        if n == 45:
            print(f"phases 38-45 (the unimodal and bimodal regimes, the noisy eval) "
                  f"{time.perf_counter() - t_new:.1f} s")
            t_new = time.perf_counter()
        if n == 47:
            print(f"phases 46-47 (the training loop, checkpoints, API and CLI) "
                  f"{time.perf_counter() - t_new:.1f} s")
            t_new = time.perf_counter()
        if n == 50:
            print(f"phases 49-50 (the serving artifacts, their CLI and the HTTP host) "
                  f"{time.perf_counter() - t_new:.1f} s")
            t_new = time.perf_counter()
            keep.clear()
            work.cleanup()
        if n == 56:
            print(f"phases 51-56 (the encoder's cell options: recurrent dropout, GRU, residual, "
                  f"highway) {time.perf_counter() - t_new:.1f} s")
            t_new = time.perf_counter()
        if n == 62:
            print(f"phases 57-62 (LN-LSTM on K13, the frontend's options on K3, SpecAugment, "
                  f"LAMB) {time.perf_counter() - t_new:.1f} s")
            t_new = time.perf_counter()
        if n == 70:
            print(f"phases 63-70 (the fp32 policy on K1, K4, K5 and K6; train.remat) "
                  f"{time.perf_counter() - t_new:.1f} s")
            t_new = time.perf_counter()
    print(f"phases 71-75 (the fp32 policy on lrs2_av_align: K8 and K10) "
          f"{time.perf_counter() - t_new:.1f} s")
    phase_shapes_covered(held, launched)  # 48
    print(f"total {time.perf_counter() - t_start:.1f} s")

    td = "avsr_tpu/models/transformer_decoder.py"
    sources = {
        "lstm_scan_fwd": ("avsr_tpu_torch/csrc/lstm_scan.cu", "avsr_tpu/ops/rnn.py:341"),
        "lstm_scan_bwd": ("avsr_tpu_torch/csrc/lstm_scan.cu", "avsr_tpu/ops/rnn.py:382"),
        "logmel_post_dft": ("avsr_tpu_torch/csrc/logmel.cu",
                            "avsr_tpu/ops/audio_features.py:242"),
        "fusion_attention_fwd": ("avsr_tpu_torch/csrc/cross_attention.cu",
                                 "avsr_tpu/models/fusion.py:226"),
        "fusion_attention_bwd": ("avsr_tpu_torch/csrc/cross_attention.cu",
                                 "avsr_tpu/models/fusion.py:226"),
        "decoder_attention_fwd": ("avsr_tpu_torch/csrc/decoder_attention.cu", f"{td}:305"),
        "decoder_attention_bwd": ("avsr_tpu_torch/csrc/decoder_attention.cu", f"{td}:305"),
        "decode_attention": ("avsr_tpu_torch/csrc/decode_attention.cu", f"{td}:217"),
        "beam_step": ("avsr_tpu_torch/csrc/beam_step.cu", "avsr_tpu/decode/beam.py:142"),
        "av_align_scan": ("avsr_tpu_torch/csrc/av_align_fwd.cuh",
                          "avsr_tpu/models/fusion.py:118"),
        "av_align_scan_bwd": ("avsr_tpu_torch/csrc/av_align_scan.cu",
                              "avsr_tpu/models/fusion.py:118"),
        "bahdanau_attend": ("avsr_tpu_torch/csrc/bahdanau_attend.cu",
                            "avsr_tpu/ops/attention.py:125"),
        "bahdanau_attend_grouped": ("avsr_tpu_torch/csrc/attend_grouped.cuh",
                                    "avsr_tpu/ops/attention.py:125"),
        "bahdanau_attend_row": ("avsr_tpu_torch/csrc/attend_row.cuh",
                                "avsr_tpu/ops/attention.py:125"),
        "bahdanau_attend_bwd": ("avsr_tpu_torch/csrc/bahdanau_attend.cu",
                                "avsr_tpu/ops/attention.py:125"),
        "bahdanau_attend_sums": ("avsr_tpu_torch/csrc/av_align_bwd.cuh",
                                 "avsr_tpu/models/decoder.py:267"),
        "encoder_attention_fwd": ("avsr_tpu_torch/csrc/encoder_attention.cu",
                                  "avsr_tpu/models/transformer.py:204"),
        "encoder_attention_bwd": ("avsr_tpu_torch/csrc/encoder_attention.cu",
                                  "avsr_tpu/models/transformer.py:204"),
        "conformer_conv_fwd": ("avsr_tpu_torch/csrc/conformer_conv.cu",
                               "avsr_tpu/models/transformer.py:231"),
        "conformer_conv_fwd_tiles": ("avsr_tpu_torch/csrc/conformer_conv.cu",
                                     "avsr_tpu/models/transformer.py:231"),
        "conformer_conv_bwd": ("avsr_tpu_torch/csrc/conformer_conv.cu",
                               "avsr_tpu/models/transformer.py:231"),
        "lstm_scan_uni_fwd": ("avsr_tpu_torch/csrc/lstm_scan.cu", "avsr_tpu/ops/rnn.py:184"),
        "lstm_scan_uni_bwd": ("avsr_tpu_torch/csrc/lstm_scan.cu", "avsr_tpu/ops/rnn.py:236"),
        "luong_attend": ("avsr_tpu_torch/csrc/bahdanau_attend.cu",
                         "avsr_tpu/ops/attention.py:152"),
        "luong_attend_grouped": ("avsr_tpu_torch/csrc/attend_grouped.cuh",
                                 "avsr_tpu/ops/attention.py:152"),
        "luong_attend_row": ("avsr_tpu_torch/csrc/attend_row.cuh",
                             "avsr_tpu/ops/attention.py:152"),
        "luong_attend_bwd": ("avsr_tpu_torch/csrc/bahdanau_attend.cu",
                             "avsr_tpu/ops/attention.py:152"),
        "luong_attend_sums": ("avsr_tpu_torch/csrc/av_align_bwd.cuh",
                              "avsr_tpu/models/decoder.py:267"),
        "av_align_scan_luong": ("avsr_tpu_torch/csrc/av_align_fwd.cuh",
                                "avsr_tpu/models/fusion.py:118"),
        "av_align_scan_luong_bwd": ("avsr_tpu_torch/csrc/av_align_scan.cu",
                                    "avsr_tpu/models/fusion.py:118"),
        "lstm_scan_rd_fwd": ("avsr_tpu_torch/csrc/lstm_scan.cu", "avsr_tpu/ops/rnn.py:654"),
        "lstm_scan_rd_bwd": ("avsr_tpu_torch/csrc/lstm_scan.cu", "avsr_tpu/ops/rnn.py:654"),
        "lstm_scan_uni_rd_fwd": ("avsr_tpu_torch/csrc/lstm_scan.cu", "avsr_tpu/ops/rnn.py:535"),
        "lstm_scan_uni_rd_bwd": ("avsr_tpu_torch/csrc/lstm_scan.cu", "avsr_tpu/ops/rnn.py:535"),
        "gru_scan_fwd": ("avsr_tpu_torch/csrc/gru_cluster.cuh", "avsr_tpu/ops/rnn.py:576"),
        "gru_scan_bwd": ("avsr_tpu_torch/csrc/gru_cluster.cuh", "avsr_tpu/ops/rnn.py:576"),
        "gru_scan_uni_fwd": ("avsr_tpu_torch/csrc/gru_cluster.cuh", "avsr_tpu/ops/rnn.py:576"),
        "gru_scan_uni_bwd": ("avsr_tpu_torch/csrc/gru_cluster.cuh", "avsr_tpu/ops/rnn.py:576"),
        "gru_scan_step_fwd": ("avsr_tpu_torch/csrc/gru_scan.cu", "avsr_tpu/ops/rnn.py:576"),
        "gru_scan_step_bwd": ("avsr_tpu_torch/csrc/gru_scan.cu", "avsr_tpu/ops/rnn.py:576"),
        "ln_lstm_scan_fwd": ("avsr_tpu_torch/csrc/ln_lstm_cluster.cuh",
                                 "avsr_tpu/ops/rnn.py:535"),
        "ln_lstm_scan_bwd": ("avsr_tpu_torch/csrc/ln_lstm_cluster.cuh",
                                 "avsr_tpu/ops/rnn.py:535"),
        "ln_lstm_scan_rd_fwd": ("avsr_tpu_torch/csrc/ln_lstm_cluster.cuh",
                                 "avsr_tpu/ops/rnn.py:535"),
        "ln_lstm_scan_rd_bwd": ("avsr_tpu_torch/csrc/ln_lstm_cluster.cuh",
                                 "avsr_tpu/ops/rnn.py:535"),
        "ln_lstm_scan_uni_fwd": ("avsr_tpu_torch/csrc/ln_lstm_cluster.cuh",
                                 "avsr_tpu/ops/rnn.py:535"),
        "ln_lstm_scan_uni_bwd": ("avsr_tpu_torch/csrc/ln_lstm_cluster.cuh",
                                 "avsr_tpu/ops/rnn.py:535"),
        "ln_lstm_scan_uni_rd_fwd": ("avsr_tpu_torch/csrc/ln_lstm_cluster.cuh",
                                 "avsr_tpu/ops/rnn.py:535"),
        "ln_lstm_scan_uni_rd_bwd": ("avsr_tpu_torch/csrc/ln_lstm_cluster.cuh",
                                 "avsr_tpu/ops/rnn.py:535"),
        "ln_lstm_scan_block_fwd": ("avsr_tpu_torch/csrc/ln_lstm_scan.cu",
                                   "avsr_tpu/ops/rnn.py:535"),
        "ln_lstm_scan_block_bwd": ("avsr_tpu_torch/csrc/ln_lstm_scan.cu",
                                   "avsr_tpu/ops/rnn.py:535"),
        "logmel_post_dft_options": ("avsr_tpu_torch/csrc/logmel.cu",
                                    "avsr_tpu/ops/audio_features.py:269"),
        "lstm_scan_f32_fwd": ("avsr_tpu_torch/csrc/lstm_scan.cu", "avsr_tpu/ops/rnn.py:341"),
        "lstm_scan_f32_bwd": ("avsr_tpu_torch/csrc/lstm_scan.cu", "avsr_tpu/ops/rnn.py:382"),
        "fusion_attention_f32_fwd": ("avsr_tpu_torch/csrc/attention_core.cuh",
                                     "avsr_tpu/models/fusion.py:226"),
        "fusion_attention_f32_bwd": ("avsr_tpu_torch/csrc/attention_core.cuh",
                                     "avsr_tpu/models/fusion.py:226"),
        "decoder_attention_f32_fwd": ("avsr_tpu_torch/csrc/attention_core.cuh", f"{td}:305"),
        "decoder_attention_f32_bwd": ("avsr_tpu_torch/csrc/attention_core.cuh", f"{td}:305"),
        "decode_attention_f32": ("avsr_tpu_torch/csrc/decode_attention.cu", f"{td}:217"),
        "av_align_scan_f32": ("avsr_tpu_torch/csrc/av_align_scan.cu",
                              "avsr_tpu/models/fusion.py:118"),
        "av_align_scan_f32_bwd": ("avsr_tpu_torch/csrc/av_align_step_bwd.cuh",
                                  "avsr_tpu/models/fusion.py:118"),
        "bahdanau_attend_f32": ("avsr_tpu_torch/csrc/bahdanau_attend.cu",
                                "avsr_tpu/ops/attention.py:125"),
        "bahdanau_attend_f32_bwd": ("avsr_tpu_torch/csrc/bahdanau_attend.cu",
                                    "avsr_tpu/ops/attention.py:125"),
        "bahdanau_attend_f32_sums": ("avsr_tpu_torch/csrc/bahdanau_attend.cu",
                                     "avsr_tpu/models/decoder.py:267"),
    }
    entries = []
    for name, (src, rep) in sources.items():
        by_path = {p: counts[name] for p, counts in paths.items()}
        r = report[name]
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            "device_ms": r["device_ms"],
            **{k: x for k, x in r.items() if k not in REPORT_KEYS}})
        if name in OFF_PATH:
            entries[-1]["off_path"] = True
            if entries[-1]["launches"] != 0:
                fail("kernels", f"kernel {name}, off every path, was launched by {by_path}")
        elif entries[-1]["launches"] == 0:
            fail("kernels", f"kernel {name} was launched by no path")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
