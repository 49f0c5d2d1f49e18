#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py              # the whole run, from a checkout
    python3 chip_smoke.py --layers 8   # cut every phase's depth (width is
                                       # never cut)
    python3 chip_smoke.py --phases qwen2.5-14b-prefix   # some phases only

Phases (each raises on failure, so the script exits non-zero):

1. card   — requires ``torch.cuda.is_available()``; prints
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
2. build  — builds the five CUDA libraries from ``src/repro_torch/csrc``
   with ``nvcc`` (sm_90a), one ``nvcc`` per source, all started together,
   then the Triton kernel; prints the seconds and ``ptxas``' register and
   spill lines.
3. kernels — each kernel's wrapper against its plain PyTorch version on
   the card: paged GQA decode at qwen2.5-14b decode shapes (and at the
   frontends': musicgen-large's 32 / 32 heads of 64, group 1, and
   internvl2-2b's 16 / 8 heads of 128 behind 256 patch positions, each
   with the last tile left out and rows mixed up planted) and paged MLA
   decode at minicpm3-4b's (each: its split boundaries, its combine
   kernel against the plain combine on the split kernel's own partials,
   bf16 held row by row, and two planted faults the row check must
   reject), the SSD scan at mamba2-780m's prefill shapes (batch 1 and 16)
   and jamba-v0.1-52b's (128 heads, N 16; B and C also in the model's own
   layout, one group read in place; bf16 y held row by row against the
   plain version in f32, and a planted fault between its phases the row
   check must reject), the SSD backward (``check_ssd_bwd``: through
   autograd in the model's layout against the plain backward, f32 and
   bf16 row by row, at the reference's grid, a short last chunk,
   mamba2-780m's train microbatch and jamba's shape; in bf16 also with
   per-head B and C (one C B^T per head), equal bit for bit to the group
   view's; the phases one at a time with C B^T held to its plain version;
   four planted faults: the carried state's gradient dropped, one chunk's
   dB zeroed, dB times the group's head count, one tile pair of the C B^T
   scratch zeroed; the launches' blocks, shared memory and blocks an SM
   holds), flash attention
   at qwen2.5-14b's (1 x 2048, 16 x 512), mixtral-8x7b's, musicgen-large's
   (1 x 2048, MHA, D 64) and internvl2-2b's (1 x 2304) prefill shapes (at
   the frontends' with each head reading the next KV head planted),
   RMSNorm, each with the edge cases of the reference's kernel
   tests, and RMSNorm's backward (through autograd, at qwen2.5-14b's
   training shape 4096 x 5120 and the forward's grid, f32 and bf16: dx
   row by row, dw by its relative error, with the mean term dropped and
   one row block left out of dw planted), and the backward of its
   given-statistic entry (``check_rms_norm_rstd_bwd``: a row of
   mamba2-780m's d_inner split over two ranks at 4096 rows, each half's
   dx and dw against the whole row's plain backward, the row term not
   summed planted); then CUDA-event times of
   kernel, plain version and one PyTorch library call where there is
   one, beside the least time the card could take (``bound_ms``); for
   the paged decodes, flash attention, the SSD scan and RMSNorm's
   backward, also the device time alone (``torch.profiler``), where the
   trace holds every launch.
4. serve  — the port's main paths at full width, one after the other,
   each behind ``repro_torch.serve.ServeEngine`` on the UMT runtime with
   seeded bf16 weights made on the card by the engine's weights task, at
   the depth ``PHASES`` gives each (the cuts and their reason beside
   it): qwen2.5-14b (paged, ``paged_kernel=True``, flash prefill; 12 of
   48 layers), minicpm3-4b (MLA, paged, ``paged_kernel=True``; 48 of 62
   layers), mamba2-780m (SSD, ``page_size="auto"``; 12 of 48), each with
   32 requests with prompt lengths from {256, 512, 1024, 2048} and 16
   slots; then mixtral-8x7b (MoE, sliding-window rings, flash prefill) at
   4 of its 32 layers (the whole model does not fit one card), 16
   requests, each prompt length of {1024, 2048, 6144, 8192} four times,
   8 slots; then the two frontends at full width with the prefix trie
   on (internvl2-2b at 12 of 24 layers, musicgen-large at 12 of 48):
   internvl2-2b (32
   requests of {256, 512, 1024, 2048} text tokens, each behind 256 patch
   embeddings drawn on the card at ``PATCH_STD``, 16 slots, cache_len
   2336; no vision request may look up or enter the trie) and
   musicgen-large (qwen's traffic as (P, 4) codebook prompts; its
   embedding and heads scaled by ``AUDIO_EMBED_GAIN`` and
   ``AUDIO_HEAD_GAIN``, the reasons beside them; every check per
   codebook); then chunked prefill and
   the shared-prefix cache, qwen2.5-14b (``qwen2.5-14b-prefix``, 6 of
   its 48 layers) and minicpm3-4b (``minicpm3-4b-prefix``, full depth): 4
   prefixes of 1001 tokens, each heading 8 prompts with tails of 24-1000
   tokens, chunks of 512, one prompt per prefix first and the other 28
   once those have 2 tokens out (28 hits, each forking a partial page);
   then on-demand paging with eviction and restore (``policy="ondemand"``,
   ``qwen2.5-14b-ondemand`` and ``mamba2-780m-ondemand`` at 6 layers):
   the cold
   phases' traffic into a pool of two worst cases (``ONDEMAND_PAGES``),
   so that slots grow page by page and the youngest is evicted and
   restored — by prefill-replay through 512-token chunks on qwen2.5-14b,
   by decode-replay through the serve step on mamba2-780m; then
   speculative decoding (``qwen2.5-14b-spec``, full width,
   ``spec_k=4``, 16 requests, each prompt length four times): three legs
   on one set of weights with the same prompts and arrivals, (a) spec
   off, (b) a drafter that never drafts (every window one token), (c)
   an oracle drafter of leg (b)'s continuation with one rejected lane
   every third window (``serve_spec``; 12 of 48 layers); then
   jamba-v0.1-52b at full width and 8 of its 32 layers, one block (1
   attention, 7 SSM, 4 MoE layers; qwen's traffic, the dropless MoE, paged-kernel
   decode; mixtral's route check; planted faults in its first SSM layer
   and its first attention layer).
   32 tokens each, staggered arrivals; each phase's requests must finish
   within ``DRAIN_S`` (``repro_torch.serve.drain``).  Launch counters are zeroed right
   before each phase and read right after; the engine's steps are counted
   by wrapping them (one-shot prefills, chunks, gathers, ticks) and each
   phase's identities are checked, with the prefix counters and no page
   leaked after shutdown.  Then
   the teacher-forced checks: one forward of the port over prompt +
   emitted tokens must put each emitted token at (or within ``LOGIT_TOL``
   of) its argmax, and the engine's step path fed the same tokens must
   give that forward's logits within ``REL_TOL`` at every position —
   while each fault planted in that path (``PLANTED``) must fail both
   checks.  The forward of the checks runs plain attention
   (``full_attention`` with the true window mask) and mamba2's the plain
   SSD scan, so a fault of a kernel or of the ring cannot sit on both
   sides; mamba2's conv weights are scaled up (``SSM_CONV_W_GAIN``, the
   reason beside it) so that a fault of the scan or state can show at
   all; mixtral's forward takes the expert ids the step path picked (the
   reason is in ``serve``) and computes everything else itself, while
   the route check holds those ids to the forward's own wherever its
   choice is clear (``ROUTE_MARGIN``, ``ROUTE_MARGIN_FIRST``), and the
   registry's capacity MoE dispatch, which the phase does not serve, is
   held at mixtral's layer shape against its rule
   (``check_capacity_dispatch``).  The prefix phases' step path is the
   engine's own hit path (gather, the tail's chunks at the matched
   offset, an insert with the shared pages masked, paged-kernel decode),
   with three planted faults of it (``HIT_FAULTS``).  The on-demand
   phases' step path grows each slot's table as its position crosses a
   page and restores each request where the engine evicted it, with
   planted faults of the restore and the growth (``RESTORE_FAULTS``);
   their bars: pages grown, evictions, restores = evictions, no page
   leaked, and every restore that re-derived another token than the one
   emitted (``restore_divergences``) within the token tolerance there.
   The verify check (``verify_check``; the spec phase and minicpm3-4b's
   phase) feeds the verify step the emitted tokens in windows of
   ``VERIFY_S`` lanes over the paged pools and holds every lane's logits
   within ``REL_TOL`` of the forward's, with the window written one
   position late (and, on qwen2.5-14b, the in-window mask dropped)
   planted; the spec phase's bars: every leg's tokens within
   ``LOGIT_TOL``, leg (c) drafts, accepts and rolls back in fewer
   dispatches than leg (a), no page leaked, and leg (c) rerun with the
   engine committing its drafts must fail the token check.  Its launch
   identities hold per leg: the paged decode only in leg (a), a verify
   call as a tick for RMSNorm.  Then the training path
   (``qwen2.5-14b-train``, ``train_phase``): qwen2.5-14b at full width
   and 2 of its 48 layers (``TRAIN``: the train state bounds the depth),
   f32 masters and AdamW state, bf16 compute, remat "full", microbatches
   of 4 x 1024 tokens, accum 2, through ``steps.make_train_step`` on the
   UMT runtime with ``UMTPrefetcher`` and an async ``CheckpointManager``;
   bars (a)-(h) in its docstring, among them one step through the
   kernels against the plain norm, accumulation against one large
   microbatch, two planted faults, and a save, restore and continuation
   that ends at the uninterrupted run's params; then ``mamba2-780m-train``,
   the same bars at full width and all 48 layers with the SSD scan's
   forward and backward kernels on the path (and an SSD-backward fault
   planted).
5. cli    — ``repro_torch.launch.serve`` on the card at full width, as
   an engine (paged kernel, ``--chunk 512 --prefix-cache on``) and one
   shot: each run's kernels launched, and both token sets held by the
   teacher-forced token check; qwen2.5-14b, then musicgen-large's
   codebook prompts (``CLI_AUDIO``).  Then ``repro_torch.launch.train`` with
   ``examples/train_100m.py``'s model (``check_train_cli``): a run with
   checkpoints, the run resumed from its step-10 save, and ``--umt-off``,
   each with the same losses where they overlap; then mamba2-780m's tiny
   shape through the same CLI, launching the SSD kernels.
5b. tp     — tensor-parallel serving (``tp_section``; ``--phases tp``):
   a mesh of two ranks, this process and one follower process
   (``repro_torch.launch.mesh``, started on a thread right after the
   build so the follower's start overlaps the kernel checks), both on
   the one card over gloo when the machine has one card, on two cards
   over nccl when it has more (printed); qwen2.5-14b (2 of 48 layers,
   qwen's mix of 16 requests), minicpm3-4b (2 layers) and mamba2-780m
   (4 layers), 8 requests each, and mixtral-8x7b (2 of 32 layers, 8 of
   mixtral's requests to 8192 tokens, the dropless MoE: every expert on
   both ranks at half its d_ff columns) in turn at full
   width through ``ServeEngine(mesh=...)``; each leg's bars on rank 0
   against the single-device forward from the same full weights (the
   teacher-forced token check, the TP step path's logits within
   ``REL_TOL``), planted TP faults on every rank that must fail them
   (``TP_LEGS``), and per rank the launch identities, the collectives
   per tick, the pool bytes against the single-device pool and the last
   tick's tokens, mask and block table (the same bytes on every rank);
   mixtral's also the route check on the TP step path, the ranks'
   expert ids equal by digest and the per-rank expert bytes.  Phase 3
   also holds every serve kernel at the two ranks' local shapes
   (``check_tp_kernels``).
5c. fsdp  — the sharded train state (``fsdp_section``; ``--phases
   fsdp``): a 2,1 mesh of this process and one follower (started right
   after the build, as the TP section's), both on the one card over gloo
   (two cards: nccl); mamba2-780m (2 of 48 layers) at full width through
   ``launch.train.MeshTrain``, f32 masters, bf16 compute, remat "full",
   f32 AdamW (``FSDP_LEGS``; qwen2.5-14b's leg moved to 5d); bars (a)-(e)
   in ``fsdp_section``: the sharded gradient step against this
   process's single-rank step, per-rank state bytes, a checkpoint
   restored onto the mesh and onto one device, planted FSDP faults
   (``FSDP_FAULTS``), gathers and sums by formula and the RMSNorm and
   SSD launch identities on both ranks, whose launches the kernel table
   counts.
5d. tp_train — tensor parallelism in training (``tp_train_section``;
   ``--phases tp_train``): a 2,2 mesh of this process and three
   followers on the one card over gloo (four cards: nccl);
   qwen2.5-14b (1 layer, one step), mamba2-780m (2 layers, two steps,
   the planted faults of ``TP_TRAIN_FAULTS``, a checkpoint restored onto
   one device and onto 2,1) and mixtral-8x7b (1 layer, one step, the
   capacity MoE dispatch, its experts split on both axes) at full width;
   bars (a)-(f) in
   ``tp_train_section``.  Each mesh's followers warm their Triton
   kernels on a thread while the serve phases run (``warm_mesh``).
6. summary — one ``kernels`` JSON line, then the ``ok`` line.

Nothing of JAX or of the ``repro`` package is imported.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet; dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# the train phases (``train_phase``), each at full width with its depth in
# ``PHASES``.  qwen2.5-14b at 1 of its 48 layers (first 4, then 2, each
# cut for the script's time when a section came: the FSDP section, then
# the tensor-parallel train section).  Memory, from
# configs/archs.py: embedding + untied head 2 x 152064 x 5120 = 1.557 B
# params, each layer 275.3 M; at 1 layer 1.832 B params x 16 B (f32
# param, grad, m, v) = 29.3 GB, plus 3.7 GB of bf16 compute copies, the
# f32 logits (2.5 GB a copy at 4096 tokens) and one layer's f32 scores
# under remat (0.67 GB): about 40 GB (2 layers 45 GB, 4 about 60 GB).
# Full depth is about 235 GB.  mamba2-780m at 24 of its 48 layers (all
# 48 until the tensor-parallel train section came): 0.51 B params x 16
# B = 8.1 GB (13.7 GB at 48), plus the f32 logits (0.82 GB a copy at
# 4096 tokens of its 50280 vocab) and one layer's scan under remat.
# Both: microbatches
# of 4 x 1024 tokens, accum 2; AdamW at lr 1e-3 after 2 warmup steps over
# the phase's 10 steps, on one fixed batch.
TRAIN = dict(micro=4, seq=1024, accum=2, steps=10, ckpt_at=5,
             hp=dict(lr=1e-3, warmup=2, total_steps=10))
TRAIN_CUT = ("the train state at full depth, about 235 GB, does not fit "
             "one 80 GB card; 1 layer, a whole repeat, takes about 40 GB "
             "and keeps the script's time")
# mamba2-780m-train's depth: its planted faults stay far outside the bars
# at any depth (dw zeroed moves the norm weights by 1.0, a microbatch
# dropped every leaf by about 0.7, dB times 48 overflows); 24 layers keep
# the script's time
TRAIN_CUT_SSM = ("24 of 48 layers keep the script's time; every planted "
                 "fault stays rejected")
# (a): the synthetic labels are the tokens themselves (the reference's
# SyntheticTokenSource), which the embedding and head learn to copy in a
# few AdamW steps; 10 steps on one batch must take the loss down by at
# least 1 nat, 8 % of its start near ln(152064) = 11.9: an optimizer
# that does not move the weights keeps it within a few hundredths.
LOSS_DROP = 1.0
# (c), (d): two bf16 steps against each other.  Both round the norms'
# and the GEMMs' outputs to bf16 (2^-8 relative), at other places: a
# kernel vs plain norm output may differ by one bf16 ulp, and accum 1 x 8
# runs every GEMM at another shape than accum 2 x 4.  Loss within 1e-3
# relative, the global grad norm 1e-2, each parameter leaf's gradient
# within 5e-2 of its L2 norm.  The planted faults move a leaf by about
# 1 (dw zeroed: the norm weights' gradients vanish) or 0.5 (a microbatch
# dropped: every gradient is about halved).  On mamba2-780m (c) also
# swaps the SSD kernels for the plain scan (``ssd_scan_ref``, autograd
# through it); the kernel's forward rounds x w, the state entering a
# chunk and the weighted C B^T to bf16 where the plain scan rounds C B^T
# o L and its einsums' outputs, the same 2^-8 at other places.  Its
# planted SSD-backward fault is dB times the group's 48 heads (what a
# group sum handed back through the stride-0 view would do).
TRAIN_TOL = dict(loss=1e-3, grad_norm=1e-2, leaf=5e-2)
# (c) on mamba2-780m (measured at all 48 layers; the phase now runs 24,
# under the same bounds), whose conv weights the phase
# scales by ``SSM_CONV_W_GAIN`` as the serve phases do: at the repo's init
# the scan adds about 1e-5 of each mixer's output, so little flows through
# its backward (on an H100, without the gain, dB times 48 moved the
# leaves by 6.7 % against 5.8 % as built).  In bf16 the kernels' step and
# the plain step round apart layer after layer: on an H100 each leaf
# differs by up to 11.4 %, while the same two steps in f32 compute agree
# within 6.7e-5 a leaf and accum 2 x 4 against 1 x 8 (one computation at
# two shapes) differs by 0.9 % — bf16 rounding carried through 48
# layers, not a kernel's error.  So at 48 layers (c) holds the bf16 step
# by a leaf bound of 0.25 and the f32 step by ``TRAIN_TOL``.  The planted
# faults stay far outside: dw zeroed moves the norm weights' leaves by
# 1.0, and dB times 48 compounds through the 48 layers' backward until
# the gradients overflow.
TRAIN_TOL_DEEP = dict(TRAIN_TOL, leaf=0.25)
# the serve CLI's second run on the card: musicgen-large at full width and
# depth, 4 prompts of 256 codes on each of its 4 codebooks
CLI_AUDIO = dict(arch="musicgen-large", prompt_len=256)
# the train CLI with an SSD family on the card (``check_train_cli``):
# mamba2-780m's tiny shape at d_model 512, 8 layers, 10 steps — the SSD
# kernels forward and backward through the CLI
TRAIN_CLI_SSM = ["--arch", "mamba2-780m", "--tiny", "--d-model", "512",
                 "--n-layers", "8", "--vocab", "32000", "--batch", "8",
                 "--seq", "256", "--steps", "10", "--log-every", "1"]
# the train CLI on the card through the train_100m example
# (``repro_torch.examples.train_100m``: qwen2.5-14b family, d_model 512,
# 16 layers, vocab 32000, about 92 M params, batch 8 x 128), 30 steps
TRAIN_100M = ["--steps", "30", "--log-every", "1"]

# the reference's kernel-test tolerances (tests/test_kernels.py:15-17;
# the SSD scan's :220-221: its plain version rounds its intermediates to
# bf16 where the kernel sums in f32)
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SSD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
           "bfloat16": dict(rtol=4e-2, atol=4e-2)}
# Flash attention in bf16, row by row: the error of each (b, s, h) output
# row over that row's norm.  TOL's bf16 2e-2 is as large as a typical
# output value of a row that attends over thousands of keys (about
# sqrt(e / n) for N(0, 1) inputs: 0.026 at mixtral's window of 4096), so
# at the serve shapes it could not see a key tile left out.  The kernel's
# own error is bf16 rounding (P before the P.V product, the output), a
# few 1e-3 of a row's norm; a row missing one 64-key tile of 4096 is off
# by about 0.12.  Bounds: the RMS over rows and the worst row.  The
# capacity MoE dispatch is held to the same row bounds
# (``check_capacity_dispatch``).
ROW_TOL = dict(rms=1e-2, worst=5e-2)
# the RMSNorm backward's dw, by its relative L2 error: in f32 a sum over
# up to 4096 rows in another order than the plain version's; in bf16
# both round the same f32 sums to bf16, and an entry that rounds the
# other way is 2^-8 off: 2e-3 allows some 6 % of entries to (an H100
# reads 1.1e-4 at worst).  One program's block of rows left out
# (16 of 4096) moves dw by 1/256 where dy leans along x, as in the
# planted case, and by about 1/sqrt(264) where dy is independent of x.
DW_TOL = {"float32": 1e-5, "bfloat16": 2e-3}
# The SSD scan in bf16, row by row: each (b, s, h) row of y against the
# plain version computed in f32 from the same bf16 inputs.  SSD_TOL's
# bf16 4e-2 holds the kernel against the plain version in bf16, whose own
# intermediates round to bf16; here the kernel's error alone is held.
# Its bf16 roundings: x * w in the chunk states, the state entering a
# chunk, the decay-weighted C B^T (P before P.V, as in attention) and y
# itself, each a relative error up to 2^-8 (RMS about 1.1e-3), about
# 2.5e-3 of a row's norm for four in a chain; a row's 64 values average
# the rest.  So the bounds of ROW_TOL (RMS 1e-2, worst row 5e-2) leave a
# factor of 4 at the RMS.  A row that loses the cross-chunk term (the
# planted fault: one chunk's state not handed on) is off by about its
# whole norm in the first ~30 rows of the chunk, RMS over rows above
# 0.05.
SSD_ROW_TOL = dict(rms=1e-2, worst=5e-2)
# The SSD backward (``check_ssd_bwd``), through autograd in the model's
# layout against autograd through the plain scan in f32 from the same
# inputs.  f32: each gradient elementwise within 1e-4 of itself plus 1e-4
# of its largest value — sums over up to 256 positions and 128 states in
# another order; ddt and da come out of a reverse cumsum whose terms
# cancel, so each is held against its own scale.  bf16, row by row (dx's
# (b, s, h) rows, the group's dB and dC rows (b, s), ddt's rows (b, s)
# over the heads, da one row): the kernel's products take bf16 operands
# (the inputs as read; h_prev, D and the masked Z and M tiles rounded
# once) with f32 sums, it rounds dx, dB and dC to bf16, and autograd sums
# a group's per-head dB and dC in bf16.  On an H100 the rows of
# dx, dB and dC read an RMS of 2.4-3.1e-3 (worst row 1.6e-2), those of
# ddt and da 1.6-4.0e-4 (the kernel keeps the sums that dcum cancels to
# about 16 bits); so the bounds of SSD_ROW_TOL leave a factor of 3 at
# the RMS.  The planted faults (the gradient of the carried state
# dropped, one chunk's dB zeroed, dB times the group's head count, one
# tile pair of the C B^T scratch zeroed) move whole rows: relative errors
# near 1, or the head count less one.
SSD_BWD_TOL = dict(rtol=1e-4, atol_of_max=1e-4)
# Token check: an emitted token may trail the teacher-forced forward's
# argmax by at most this many logit units.  The engine's tokens come from
# a qchunk prefill plus paged-kernel decode ticks (f32 softmax inside the
# kernel), the check's from one full-attention forward (scores rounded to
# bf16 before the softmax); both carry a bf16 residual stream through 48
# layers, so near-ties flip.  On an H100 (qwen2.5-14b, 48 layers) the
# random-weight model's logits have a standard deviation of about 1.4, a
# median top-two margin of about 0.22, and emitted tokens trail by at most
# 0.56; the argmax of each planted fault below trails by 9 or more.
LOGIT_TOL = 1.0
# Logit check: the engine's step path (prefill step, paged insert,
# paged-kernel decode), teacher-forced with the engine's tokens, against
# the forward's logits at each position: ||path - fwd|| over
# ||fwd - mean(fwd)||.  On an H100 the worst position reads about 0.14
# (independent bf16 rounding in the two paths); each planted fault moves
# some position past 1.3, as far as an unrelated model would.
REL_TOL = 0.3
# Faults planted in each phase's path as controls: each must fail both
# the token check and the logit check, or the checks prove nothing.  The
# SSD faults act in the prefill (the scan and the state it hands over) or
# in the decode recurrence; the paged attention faults in the decode
# tick; mixtral's in the flash prefill (query head h reads kv head
# h % Hkv), in the MoE (the second pick's weight dropped, prefill and
# decode) and in the ring a prefill hands decode (the reference's
# placement: the last ``ring`` positions unrolled, wrong for a prompt past
# the window and no multiple of it — 6144 here).
PLANTED = {
    "qwen2.5-14b": ("rope_pos_plus_1", "kv_group_order", "slot_pos_rolled",
                    "newest_kv_left_out"),
    "minicpm3-4b": ("rope_pos_plus_1", "slot_pos_rolled",
                    "newest_kv_left_out", "q_rope_next_head"),
    "mamba2-780m": ("state_not_handed", "dt_one_late", "conv_tail_rolled"),
    "mixtral-8x7b": ("flash_kv_group_order", "moe_second_pick_dropped",
                     "ring_not_rolled"),
    # the frontends: the vision prefill without its patches while the
    # positions still count them (the text at positions 256 onwards, the
    # patch rows of the cache never written), and decode positions that
    # lose the 256-patch offset (RoPE, the cache write and the mask at the
    # text's own index: what a slot position that left out the patches
    # would do); the audio embedding summing K - 1 codebooks, decode adding
    # the sinusoid of pos + 1, and head k emitting codebook k + 1's logits
    "internvl2-2b": ("patches_dropped", "text_pos_restarts"),
    "musicgen-large": ("codebook_dropped", "sinusoid_pos_plus_1",
                       "codebook_heads_rolled"),
    # the prefix phases' hit path: the gather reads the table one page
    # on; the COW fork's page is not copied (its positions of the
    # gathered row zeroed, and the slot's own page for it left empty:
    # the one matched position alone, zeroed, is below what the checks
    # see at minicpm3-4b — worst rel 0.19, gap 0.63 on an H100); a
    # tail chunk's q_off is one late (RoPE and the causal mask shifted)
    "qwen2.5-14b-prefix": ("gather_table_shifted", "fork_not_copied",
                           "tail_q_off_plus_1"),
    "minicpm3-4b-prefix": ("gather_table_shifted", "fork_not_copied",
                           "tail_q_off_plus_1"),
    # the on-demand phases' restore and growth: a prefill-replay over one
    # token too few (the slot resumes a position early), a page grown
    # into the slot but never published in the block table (the tick
    # writes and reads the garbage page), a decode-replay that starts
    # from a blank state (every leaf of its prefilled row zeroed)
    "qwen2.5-14b-ondemand": ("restore_drops_last_token",
                             "grown_page_not_published"),
    "mamba2-780m-ondemand": ("restore_state_dropped",),
    # jamba: one layer of each kind — the first SSM layer's prefill hands
    # decode a zero state, and the first attention layer's decode tick
    # reads KV head h % Hkv for query head h (the other 13 SSM and 1
    # attention layers as built)
    "jamba-v0.1-52b": ("ssm_layer_state_not_handed",
                       "attn_layer_kv_group_order"),
}
# mixtral's teacher-forced forward takes the expert ids of the step path
# (the reason is in ``serve``), so a wrong top-k on the card would sit on
# both sides of the logit checks.  The route check holds it: wherever the
# forward's own k-th and (k+1)-th router probabilities lie more than a
# bound apart, the path must have picked the forward's own top-k set.  At
# random init bf16 rounding differences between the two computations grow
# through the layers (the logits of a position differ by up to 0.13 of
# their spread) and flip picks at wide margins too: on an H100 the widest
# margin of a flip read 0.1492 over 1,122,048 (layer, position) pairs, p99
# 0.0562, and 1096 pairs above 0.05 differed.  The bound is twice the
# widest; about 1 % of the pairs lie above it.  In the first MoE layer the
# two computations differ only by one attention layer and its widest flip
# read 0.0107, so there the bound is 0.03 and covers most positions.
# ``ROUTE_FAULTS`` are planted in the routing itself, so that the forward
# takes the faulty ids too: each must fail the route check.
ROUTE_MARGIN = 0.3
ROUTE_MARGIN_FIRST = 0.03
ROUTE_FAULTS = ("moe_ids_permuted",)
PREFILL_FAULTS = ("state_not_handed", "dt_one_late", "flash_kv_group_order",
                  "moe_second_pick_dropped", "ring_not_rolled",
                  "patches_dropped", "ssm_layer_state_not_handed")
HIT_FAULTS = ("gather_table_shifted", "fork_not_copied", "tail_q_off_plus_1")
# A serve phase's requests must all finish within this many seconds of
# the last submission (``repro_torch.serve.drain``), or the phase fails
# with the engine's stats and every thread's stack.
DRAIN_S = 600
RESTORE_FAULTS = ("restore_drops_last_token", "grown_page_not_published",
                  "restore_state_dropped")
# The verify check's window: the spec phase's spec_k drafts + the last
# committed token (``verify_check``).
VERIFY_S = 5
# The SSM phases' conv weights (serving and training) are scaled by this
# gain from the repo's normal 0.02 to std 1.0, so that the checks can see
# a fault of the scan, of its backward or of the state.  At 0.02 the depthwise conv (fan-in 4) outputs x, B
# and C of about 0.016, so C.B is about 0.003 and the SSD scan adds about
# 1e-5 of D*x to each mixer's output: the state faults then move the
# logits no more than bf16 noise does.  Every other leaf keeps the repo's
# init.
SSM_CONV_W_GAIN = 50.0
# The audio phase's codebook tables are scaled by ``AUDIO_EMBED_GAIN``
# from the repo's normal 0.02 to std 0.24, so that the checks can see a
# fault of the embedding.  musicgen adds the sinusoid unscaled, as the
# reference does: its norm is sqrt(d_model / 2) = 32, while four codebook
# rows at std 0.02 sum to a norm of about 0.02 sqrt(4 d_model) = 1.8, so at
# the repo's init a prompt's codes hardly move the logits (a codebook left
# out moved them by 0.03 of their spread, rehearsed on the CPU at full
# width and 4 layers).  At std 0.24 the codes' sum has a norm of about 22,
# and a codebook left out and a sinusoid one position late change a
# position's input by about 28 % and 19 % (at std 0.5, 41 % and 13 %: the
# late sinusoid fell under the bounds at 24 layers).  Its K heads are
# scaled by ``AUDIO_HEAD_GAIN`` from std 0.02 to 0.032, so that its logits
# spread as qwen2.5-14b's do (std about 1.4, where ``LOGIT_TOL`` was set;
# 0.9 at the repo's init, d_model 2048 against 5120).  Every other leaf
# keeps the repo's init.
AUDIO_EMBED_GAIN = 12.0
AUDIO_HEAD_GAIN = 1.6
# Traffic of a phase: slots, cache_len, prompt lengths (drawn at random,
# or ``each`` length n_req / len(lens) times in a seeded order), requests,
# tokens per request.
TRAFFIC = dict(slots=16, cache_len=2080, lens=(256, 512, 1024, 2048),
               each=False, n_req=32, gen=32)
# mixtral-8x7b: prompts inside the 4096 window, at multiples of it, and
# past it but no multiple (the ring's hard case); cache_len holds the
# longest prompt + 32 tokens
MIXTRAL_TRAFFIC = dict(slots=8, cache_len=8224, lens=(1024, 2048, 6144, 8192),
                       each=True, n_req=16, gen=32)
# A chat or agent service: 4 shared prefixes (system prompts) of 1001
# tokens, each heading 8 prompts with a tail of its own, two of each
# length: prompts of 1025, 1201, 1537 and 2001 tokens.  Wave 1 is one
# prompt per prefix; wave 2, the other 28, arrives once every wave-1
# request has emitted 2 tokens (so it is admitted and its pages are in
# the trie).  1001 is no multiple of the page size 8, so every hit also
# forks a partial page.
PREFIX_TRAFFIC = dict(slots=16, cache_len=2080, n_req=32, gen=32,
                      n_prefix=4, prefix_len=1001, tails=(24, 200, 536, 1000))
# On-demand paging: a pool of 520 usable pages of 8, two of the longest
# requests at their worst (2 x 260 pages; about 0.8 GiB of qwen's K/V
# against 6.5 GiB for the 16 x 260 pages of the cold phase).  The pool,
# not the slots, then bounds admission, and the requests admitted
# together grow into it until the youngest is evicted.  A pool of 1024
# pages mostly outlasts this traffic's growth (31 positions, 4 pages, per
# request against prompts of 32-256 pages): rehearsed on the CPU with the
# tiny configs, same lengths and arrivals, it rarely evicted at all.
ONDEMAND_PAGES = 521
# Speculative decoding: 16 requests, each prompt length four times, the
# same prompts and arrivals in every leg (``serve_spec``): a service that
# turns speculation on for its decode-bound streams.
SPEC_TRAFFIC = dict(slots=16, cache_len=2080, lens=(256, 512, 1024, 2048),
                    each=True, n_req=16, gen=32)
# The vision phase (internvl2-2b): qwen's traffic of text tokens, each
# prompt behind 256 precomputed patch embeddings; cache_len 2048 + 256 +
# 32.  The patches are drawn from a seeded torch.Generator at the std of
# the embedding table (``PATCH_STD``, the repo's normal init of 0.02), so
# that after the first norm they weigh as much as text positions do.
VISION_TRAFFIC = dict(TRAFFIC, cache_len=2336)
PATCH_STD = 0.02
# The frontends' decode shapes on the card (phase 3): (B, H, Hkv, Dh,
# cache_len, page size) and the patch positions in front of each prompt
# (the slots' positions as their serve phases give them: ``frontend_pos``)
FRONTEND_DECODE = {"musicgen": ((16, 32, 32, 64, 2080, 8), 0),
                   "internvl2": ((16, 16, 8, 128, 2336, 8), 256)}
# Per phase: decode attention through its paged kernel?  For each kernel
# of the phase, the engine step whose calls its launches follow once per
# layer of the kind that launches it (attention or SSD: ``kind_layers``;
# the decode tick or the one-shot prefill, counted by wrapping the
# engine's steps; None: no launch at all — mixtral's attention leaves are
# rings, which decode reads without the paged kernel, as the reference
# does); RMSNorm at every norm site of the blocks (``norm_sites``) in each
# tick, one-shot prefill and prefill chunk (+ the final norm, which a
# chunk that skips the LM head skips too); the traffic; the depth cut;
# the engine's options.  Chunks
# attend in plain ``full_attention`` and gathers launch nothing, as in the
# reference.  qwen2.5-14b and minicpm3-4b run with the prefix cache on
# (``prefix_cache="auto"``); their random prompts must never hit.
# Depth cuts, to keep the script well inside its time limit (ROADMAP,
# "The time budget of the chip script"): the cold phases of qwen2.5-14b,
# mamba2-780m and musicgen-large (each from 24 to 12, to make room for
# the TP section), internvl2-2b and qwen2.5-14b's spec phase at 12
# layers; qwen2.5-14b's prefix and on-demand phases and the on-demand
# mamba2-780m at 6 (from 12); jamba at 8, mixtral-8x7b at 4 (8 before
# the TP section's mixtral leg); minicpm3-4b's cold phase at 48 of 62.
# Every layer of a family runs the same kernels at the same widths.  At
# their deeper depth these phases' planted faults trailed the forward by
# 0.48 or more in relative logit error and by 1.8 or more in its argmax,
# against bars of 0.3 and 1.0 (PERF.md section 6).  minicpm3-4b's prefix
# phase keeps all 62 layers: at 31 two of its faults were no longer
# rejected, and at 62 one trails by 1.08.
PHASES = {
    "qwen2.5-14b": dict(paged_kernel=True, traffic=TRAFFIC, layers=12,
                        kernels={"paged_decode_attention": "decode",
                                 "flash_attention": "prefill"}),
    # minicpm3-4b also holds the MLA verify mode over its paged latent
    # pools (``verify_check``), with the window-late fault planted
    "minicpm3-4b": dict(paged_kernel=True, traffic=TRAFFIC, layers=48,
                        kernels={"paged_mla_decode_attention": "decode"},
                        verify_faults=("window_late",)),
    "mamba2-780m": dict(paged_kernel=False, traffic=TRAFFIC, layers=12,
                        kernels={"ssd_scan": "prefill"}),
    # 4 of 32 layers: full depth is 93.4 GB of bf16 weights, more than
    # the card holds; 16 layers would be 46.4 GB + 0.5 GB of embedding and
    # head; 8 kept the script's time until the TP section's mixtral leg
    # (4 since then: at 8 its narrowest planted fault trailed by 1.3749
    # relative and 6.2109 logits against 0.3 / 1.0).
    # The dropless MoE dispatch, as Mixtral is served: at this init the
    # capacity dispatch (the registry's default) drops some (token, pick)
    # pairs of every long prompt, and which ones depends on the sequence
    # length — so prefill + decode and the checks' one forward over prompt
    # + tokens would differ by construction (``check_capacity_dispatch``
    # holds that dispatch on the card).
    "mixtral-8x7b": dict(paged_kernel=True, traffic=MIXTRAL_TRAFFIC,
                         layers=4, moe_impl="ragged",
                         kernels={"flash_attention": "prefill",
                                  "paged_decode_attention": None}),
    # the frontends at full width (internvl2-2b at 12 of its 24 layers,
    # musicgen-large at 12 of 48), behind the prefix trie
    # (``prefix_cache="auto"``): a vision request never looks up or enters
    # it (asserted), musicgen's random code prompts never hit
    "internvl2-2b": dict(paged_kernel=True, traffic=VISION_TRAFFIC,
                         layers=12,
                         kernels={"paged_decode_attention": "decode",
                                  "flash_attention": "prefill"}),
    "musicgen-large": dict(paged_kernel=True, traffic=TRAFFIC, layers=12,
                           kernels={"paged_decode_attention": "decode",
                                    "flash_attention": "prefill"}),
    # chunked prefill and the shared-prefix cache: every prompt is longer
    # than the chunk, so no one-shot prefill (and no flash launch) is due.
    # qwen2.5-14b's at 6 layers, for the script's time: what it holds
    # (the gather, the tail's chunks at an offset, shared-page admission)
    # is the same in every layer (at 12, its narrowest fault was rejected
    # at 1.0549 / 4.5859 against 0.3 / 1.0).  minicpm3-4b's stays at full
    # depth: at 31 layers two of its planted faults were no longer
    # rejected.
    "qwen2.5-14b-prefix": dict(
        arch="qwen2.5-14b", paged_kernel=True,
        traffic=PREFIX_TRAFFIC, prefill_chunk=512, prefix_cache="on",
        layers=6, kernels={"paged_decode_attention": "decode",
                           "flash_attention": None}),
    "minicpm3-4b-prefix": dict(
        arch="minicpm3-4b", paged_kernel=True,
        traffic=PREFIX_TRAFFIC, prefill_chunk=512, prefix_cache="on",
        kernels={"paged_mla_decode_attention": "decode"}),
    # on-demand paging, eviction and restore: prefill-replay through 512-
    # token chunks (qwen2.5-14b: prompts past 512 chunk too, so flash runs
    # for the 256- and 512-token prompts only; a restore re-hits the trie
    # with the pages its eviction handed over), decode-replay through the
    # serve step (mamba2-780m: the prompt's one-shot prefill with the SSD
    # kernel, then one batch-1 serve step per emitted token)
    # both at 6 layers, for the script's time: growth, eviction and
    # restore are the same in every layer (mamba2-780m's planted fault
    # was rejected at 1.3550 / 4.4102 against 0.3 / 1.0 at 24 layers, at
    # 1.3615 / 5.2734 at 12; qwen2.5-14b's narrowest at 1.2475 / 7.9141 at
    # 12)
    "qwen2.5-14b-ondemand": dict(
        arch="qwen2.5-14b", paged_kernel=True, traffic=TRAFFIC,
        prefill_chunk=512, policy="ondemand", num_pages=ONDEMAND_PAGES,
        layers=6,
        kernels={"paged_decode_attention": "decode",
                 "flash_attention": "prefill"}),
    "mamba2-780m-ondemand": dict(
        arch="mamba2-780m", paged_kernel=False, traffic=TRAFFIC,
        policy="ondemand", num_pages=ONDEMAND_PAGES, layers=6,
        kernels={"ssd_scan": "prefill"}),
    # speculative decoding, full width, three legs on one set of
    # weights (``serve_spec``): (a) spec off, paged-kernel decode ticks;
    # (b) and (c) every tick a verify dispatch spec_k + 1 lanes wide
    # (gather path, no paged kernel: ``spec_kernels``), (b) drafting
    # nothing (one-token windows), (c) an oracle drafter with a rejected
    # lane every third window.  Planted: the verify window written one
    # position late (lane j's K/V at pos + j + 1; minicpm3-4b's verify
    # check too) and the in-window causal mask dropped (lane j also sees
    # lane j + 1), each in ``verify_check``; and the engine committing
    # its drafts instead of the verify step's argmaxes, in a rerun of leg
    # (c) that must fail the token check (its corrupted lanes land in the
    # stream)
    # qwen2.5-14b-spec at 12 layers, for the script's time: drafting,
    # verifying and rolling back are the same in every layer
    "qwen2.5-14b-spec": dict(
        arch="qwen2.5-14b", paged_kernel=True, traffic=SPEC_TRAFFIC,
        spec_k=4, verify_faults=("window_late", "mask_dropped"), layers=12,
        kernels={"paged_decode_attention": "decode",
                 "flash_attention": "prefill"},
        spec_kernels={"paged_decode_attention": None,
                      "flash_attention": "prefill"}),
    # the training path (``train_phase``, ``TRAIN``): RMSNorm forward and
    # backward are its kernels, and on the SSD family the scan forward and
    # backward; attention runs plain (the reference's train mode), and the
    # other kernels raise under autograd.  ``cut``: why the depth is cut
    "qwen2.5-14b-train": dict(arch="qwen2.5-14b", train=TRAIN, layers=1,
                              cut=TRAIN_CUT),
    "mamba2-780m-train": dict(arch="mamba2-780m", train=TRAIN, layers=24,
                              cut=TRAIN_CUT_SSM,
                              tol=TRAIN_TOL_DEEP),
    # jamba at full width and 8 of its 32 layers, one whole block (1
    # attention, 7 SSM, 4 MoE): full depth is 102.9 GB of bf16 weights,
    # 16 layers 52.0 GB, 8 keep the script's time.
    # Served as mixtral is (the dropless MoE, paged-kernel decode), with
    # qwen's traffic; flash and the paged decode run in its attention
    # layers only, the SSD scan in its SSM layers only.  One prompt per
    # prefill: two equal-length prompts prefilled together run the
    # expert GEMMs at other row counts, whose bf16 sums round apart, and
    # at its 16-expert router's near-ties that flips routes the checks'
    # one-prompt prefills do not take (on an H100, one such batched
    # prefill left 28 of 1024 engine tokens unreproduced by the step path
    # and one trailing the forward's argmax by 1.56)
    "jamba-v0.1-52b": dict(paged_kernel=True, traffic=TRAFFIC, layers=8,
                           moe_impl="ragged", max_prefill_batch=1,
                           kernels={"paged_decode_attention": "decode",
                                    "flash_attention": "prefill",
                                    "ssd_scan": "prefill"}),
}


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------------ helpers
def card():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this run needs an NVIDIA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: {ROOT} is not a checkout of the "
                         "repository (src/repro_torch is missing)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return smi


def time_ms(fn, iters=20, warmup=5, reps=5):
    """Median over ``reps`` batches of ``iters`` calls, CUDA events around
    each batch: one slow batch (clocks still ramping, a neighbour on the
    host) does not decide the number."""
    import statistics

    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def device_ms(fn, iters=20, per_call=None, lead=1):
    """Device time per call: the kernels' time in a ``torch.profiler``
    trace of ``iters`` calls after warm-up, summed over every kernel the
    call launches (``device_ms_by_kernel``, logged by kernel).  Unlike
    ``time_ms`` it leaves out the host's time to enqueue, which on a slow
    host exceeds a short kernel's.  None where the trace misses a
    launch."""
    by_kernel = device_ms_by_kernel(fn, iters, per_call, lead)
    if by_kernel is None:
        return None
    log("  device ms per call by kernel: " + ", ".join(
        f"{k} {v:.4f}" for k, v in by_kernel.items()))
    return sum(by_kernel.values())


def device_ms_by_kernel(fn, iters=20, per_call=None, lead=1):
    """Device ms per call by kernel name, from a ``torch.profiler`` trace
    of ``iters`` calls after warm-up.  The trace must hold every launch,
    or a sum would read low: ``lead`` more calls run first inside the
    trace (the profiler can miss a window's first launches: of 21 and of
    9 flash calls of 0.1-1.3 ms it held 16 and 5), and of each kernel
    name, launched k times a call, the last k * ``iters`` launches are
    summed, which the trace must hold — each with a duration, and
    ``per_call`` kernels a call where the caller knows the number.
    Otherwise it returns None (no device time)."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters + lead):
            fn()
        torch.cuda.synchronize()
    by_name = collections.defaultdict(list)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name].append(e)
    kernels, whole = [], bool(by_name)
    for evs in by_name.values():
        k = -(-len(evs) // (iters + lead))       # launches of it per call
        whole &= len(evs) >= k * (iters + lead) - lead
        kernels += sorted(evs, key=lambda e: e.time_range.start)[
            -k * iters:]
    whole = (whole and all(e.time_range.elapsed_us() > 0 for e in kernels)
             and (per_call is None or len(kernels) == per_call * iters))
    if not whole:
        counts = {k: len(v) for k, v in by_name.items()}
        log(f"device_ms: the trace does not hold every launch of the last "
            f"{iters} of {iters + lead} calls ({counts}); no device time")
        return None
    by_kernel = collections.Counter()
    for e in kernels:      # "void (anonymous namespace)::f<T>(args)" -> f<T>
        name = e.name.replace("(anonymous namespace)::", "")
        by_kernel[name.split("(")[0].split()[-1]] += e.time_range.elapsed_us()
    return {k: v / iters / 1e3 for k, v in by_kernel.items()}


def ms_text(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


# The H100's L2 holds 50 MB: a kernel called again and again on inputs
# smaller than that reads them from L2, not HBM, and can beat its bytes
# bound.  Such a kernel is timed over copies of its inputs, taken in turn,
# that together pass ``ROTATE_BYTES``, so that each call's inputs were
# last read two L2-fulls ago.
L2_BYTES = 50e6
ROTATE_BYTES = 100e6


def rotated(fn, args, nbytes):
    """A call of ``fn`` that takes the next of ``n`` copies of its tensor
    ``args`` in turn (other arguments shared), ``n`` enough that the copies
    pass ``ROTATE_BYTES`` (``nbytes``: what one call reads and writes), or
    ``fn(*args)`` itself for a working set above L2.  Returns (the call,
    ``n``)."""
    import torch

    if nbytes >= L2_BYTES:
        return (lambda: fn(*args)), 1
    n = -(-int(ROTATE_BYTES) // int(nbytes)) + 1
    copies = [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                             for a in args) for _ in range(n - 1)]
    turn = [0]

    def call():
        turn[0] = (turn[0] + 1) % n
        return fn(*copies[turn[0]])
    return call, n


def clocks():
    """SM clock, power draw and temperature right now (nvidia-smi)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def close(got, want, dtype, what, tols=TOL):
    import torch

    tol = tols[str(dtype).replace("torch.", "")]
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), **tol):
        raise AssertionError(f"{what}: kernel vs plain max |err| {err:.3e} "
                             f"outside rtol/atol {tol['rtol']}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    return err


# ------------------------------------------------------------ paged decode
def held_rows(got, want, dt, what, rows_err):
    """A paged decode's output held to its plain version: elementwise TOL;
    in bf16 also the row bound ROW_TOL over each (slot, head) output row
    (into ``rows_err[what]``): at 2000 positions a typical output is about
    0.04, as large as TOL's 2e-2."""
    import torch

    err = close(got, want, dt, what)
    if dt == torch.bfloat16:
        rows_err[what] = rows_close(got, want, what)
    return err


def planted_rows(kernel, shape, faults, want, elementwise_tol):
    """Planted kernel faults: each output must fail the row check (ROW_TOL
    or the bound given); what the elementwise tolerance alone says of it
    is logged."""
    import torch

    for name, (got, tol) in faults.items():
        rms, worst = row_rel(got, want)
        elementwise = torch.allclose(got.float(), want.float(),
                                     **elementwise_tol)
        log(f"{kernel} planted fault ({name}, {shape}): row error RMS "
            f"{rms:.3e} / worst {worst:.3e}; elementwise tolerance alone "
            f"{'passes' if elementwise else 'rejects'} it")
        if rms <= tol["rms"] and worst <= tol["worst"]:
            raise AssertionError(f"{kernel}: the row check does not reject "
                                 f"the planted fault ({name})")


def decode_pos():
    """Ragged positions of 16 decode slots as in the serve phases: prompt
    lengths of ``TRAFFIC`` plus up to 31 generated tokens, slot 0 full."""
    import numpy as np

    rng = np.random.default_rng(0)
    pos = (rng.choice([256, 512, 1024, 2048], 16)
           + rng.integers(0, 32, 16) - 1)
    pos[0] = 2079
    return pos


def paged_table(b, cache_len, ps, pos, rng, garbage_rest=True):
    """Block table covering each slot's pos with shuffled physical pages;
    the rest on garbage page 0 (or allocated ahead of pos)."""
    import numpy as np

    pps = cache_len // ps
    num_pages = 1 + b * pps
    phys = rng.permutation(np.arange(1, num_pages)).astype(np.int32)
    table = np.zeros((b, pps), np.int32)
    nxt = 0
    for i in range(b):
        n = pps if not garbage_rest else -(-(int(pos[i]) + 1) // ps)
        table[i, :n] = phys[nxt:nxt + n]
        nxt += n
    return table, num_pages


def paged_case(b, h, hkv, dh, cache_len, ps, dtype, seed, window=None,
               pos=None, garbage_rest=True):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    if pos is None:
        pos = rng.integers(0, cache_len, b)
        pos[0] = cache_len - 1
    pos = np.asarray(pos, np.int32)
    table, num_pages = paged_table(b, cache_len, ps, pos, rng, garbage_rest)
    dev = "cuda"
    q = torch.tensor(rng.standard_normal((b, 1, h, dh), np.float32),
                     device=dev).to(dtype)
    kp = torch.tensor(rng.standard_normal((num_pages, ps, hkv, dh),
                                          np.float32), device=dev).to(dtype)
    vp = torch.tensor(rng.standard_normal((num_pages, ps, hkv, dh),
                                          np.float32), device=dev).to(dtype)
    return (q, kp, vp, torch.tensor(table, device=dev),
            torch.tensor(pos, device=dev)), dict(page_size=ps, window=window)


def check_paged_decode():
    import numpy as np
    import torch

    from repro_torch.kernels.paged_attention import (
        paged_decode_attention as kern, paged_decode_attention_ref as plain)
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.paged_attention import ref as paged_ref

    f32, bf16 = torch.float32, torch.bfloat16
    n = 0
    rows_err = {}

    def held(got, want, dt, what):
        return held_rows(got, want, dt, what, rows_err)

    # the reference's grid (tests/test_kernels.py:99-121) in both dtypes
    for dt in (f32, bf16):
        for shape in [(2, 4, 4, 32, 16, 4), (3, 8, 2, 64, 32, 8),
                      (2, 4, 1, 32, 16, 2), (2, 6, 3, 16, 12, 1),
                      (1, 2, 2, 32, 8, 8)]:
            args, kw = paged_case(*shape, dt, seed=7)
            held(kern(*args, **kw), plain(*args, **kw), dt,
                 f"paged grid {shape} {dt}")
            n += 1
        # every GQA group size in REGISTRY (1, 2, 4, 5, 6, 8, 12)
        for g in (1, 2, 4, 5, 6, 8, 12):
            for dh in (64, 128):
                args, kw = paged_case(3, 2 * g, 2, dh, 40, 8, dt, seed=g)
                held(kern(*args, **kw), plain(*args, **kw), dt,
                     f"paged group {g} dh {dh} {dt}")
                n += 1
    for dt in (f32, bf16):
        # windows (tests/test_kernels.py:123-137)
        for w in (1, 3, 7, 100):
            args, kw = paged_case(3, 4, 2, 32, 24, 4, dt, seed=8, window=w)
            held(kern(*args, **kw), plain(*args, **kw), dt,
                 f"window {w} {dt}")
            n += 1
        # poisoned garbage page must be inert (:165-182): bit-identical
        for w in (None, 3):
            args, kw = paged_case(3, 4, 2, 32, 16, 4, dt, seed=10,
                                  pos=[0, 5, 15], window=w)
            q, kp, vp, table, pos = args
            clean = kern(*args, **kw)
            kp2, vp2 = kp.clone(), vp.clone()
            kp2[0] = 1e4
            vp2[0] = 1e4
            poisoned = kern(q, kp2, vp2, table, pos, **kw)
            if not torch.equal(clean, poisoned) or \
                    not torch.isfinite(poisoned).all():
                raise AssertionError(f"garbage page leaked into the kernel "
                                     f"output ({dt}, window {w})")
            n += 1
        # allocated-but-future pages are masked (:185-201)
        args, kw = paged_case(2, 2, 2, 16, 16, 4, dt, seed=11, pos=[2, 9],
                              garbage_rest=False)
        held(kern(*args, **kw), plain(*args, **kw), dt,
             f"future pages {dt}")
        n += 1
        # a view of a pool's heads, read in place (replicated KV heads
        # under tensor parallelism: mixtral on 16, a rank's 2 query heads
        # read KV head 2 of 8; grok on 16, 3 heads of 8); planted: KV head
        # 0's view in its place must differ
        for h, first in ((2, 2), (3, 5)):
            args, kw = paged_case(3, h, 8, 128, 40, 8, dt, seed=13)
            q, kp, vp, table, pos = args
            view = (kp[:, :, first:first + 1], vp[:, :, first:first + 1])
            got = kern(q, *view, table, pos, **kw)
            held(got, plain(q, *view, table, pos, **kw), dt,
                 f"head view {first} of 8, {h} query heads {dt}")
            wrong = plain(q, kp[:, :, :1], vp[:, :, :1], table, pos, **kw)
            if (got.float() - wrong.float()).abs().max().item() < 0.1:
                raise AssertionError(f"head view {first} of 8 ({dt}): the "
                                     "kernel read KV head 0")
            n += 1
    # split boundaries at qwen's width: positions at and around the split
    # length, a slot at 0, a window that empties whole splits
    n_split, split_len = paged_ops.split_plan(2080, 8)
    edge = [split_len - 2, split_len - 1, split_len, 0, 2079,
            2 * split_len - 1, 2 * split_len, 1]
    for dt in (f32, bf16):
        for w in (None, 100, split_len):
            args, kw = paged_case(8, 40, 8, 128, 2080, 8, dt, seed=12,
                                  pos=edge, window=w)
            held(kern(*args, **kw), plain(*args, **kw), dt,
                 f"split edges (n_split {n_split}, split_len "
                 f"{split_len}) window {w} {dt}")
            n += 1
    # the combine kernel against its plain version on the split kernel's
    # own partials (qwen's decode shape; these launches are not counted)
    comb_err = {}
    rng = np.random.default_rng(0)
    cpos = (rng.choice([256, 512, 1024, 2048], 16)
            + rng.integers(0, 32, 16) - 1)
    for dt in (f32, bf16):
        args, kw = paged_case(16, 40, 8, 128, 2080, 8, dt, seed=13,
                              pos=cpos, window=1000 if dt == f32 else None)
        ns, sl = paged_ops.split_plan(2080, 8)
        acc, m, l = paged_ops.paged_decode_partials(
            *args, n_split=ns, split_len=sl, **kw)
        comb_err[dt] = held(paged_ops.paged_decode_combine(acc, m, l, dt),
                            paged_ref.paged_decode_combine_ref(acc, m, l,
                                                               dt),
                            dt, f"combine {dt}")
        if not torch.equal(l == 0, m == -torch.inf):
            raise AssertionError("an empty split's partial is not "
                                 "(m = -inf, l = 0)")
        n += 1
    log(f"paged_decode combine: kernel vs plain on the split kernel's "
        f"partials ({ns} splits of {sl}) max|err| f32 {comb_err[f32]:.3e} "
        f"bf16 {comb_err[bf16]:.3e}")

    # qwen2.5-14b decode shapes: 16 slots, Hkv 8, group 5, Dh 128, ps 8,
    # cache_len 2080, ragged pos up to 2079 (prompt lengths of the serve
    # phase + up to 31 generated tokens)
    qpos = decode_pos()
    errs = {}
    for dt in (f32, bf16):
        args, kw = paged_case(16, 40, 8, 128, 2080, 8, dt, seed=1,
                              pos=qpos)
        errs[dt] = held(kern(*args, **kw), plain(*args, **kw), dt,
                        f"qwen shapes {dt}")
        n += 1
    worst = max(rows_err, key=lambda k: rows_err[k][1])
    log(f"paged_decode: {n} cases match the plain version "
        f"(f32 rtol/atol 2e-5, bf16 2e-2 and row error {ROW_TOL}); qwen "
        f"shapes max|err| f32 {errs[f32]:.3e} bf16 {errs[bf16]:.3e}; bf16 "
        f"row error RMS / worst: qwen shapes "
        f"{rows_err[f'qwen shapes {bf16}'][0]:.3e} / "
        f"{rows_err[f'qwen shapes {bf16}'][1]:.3e}, combine "
        f"{rows_err[f'combine {bf16}'][0]:.3e} / "
        f"{rows_err[f'combine {bf16}'][1]:.3e}; worst row of all bf16 "
        f"cases {rows_err[worst][1]:.3e} ({worst})")

    # planted kernel faults at qwen's decode shape in bf16: the last
    # 64-position tile of every slot left out (a bound one tile short),
    # and each row's last non-empty split dropped from the combine (on
    # the split kernel's own partials).  The row check must reject both;
    # what the elementwise bf16 tolerance says of each is logged.
    args, kw = paged_case(16, 40, 8, 128, 2080, 8, bf16, seed=1, pos=qpos)
    q, kp, vp, table, pos = args
    want = plain(*args, **kw)
    acc, m, l = paged_ops.paged_decode_partials(
        *args, n_split=n_split, split_len=split_len, **kw)
    last, slots = pos.long() // split_len, torch.arange(16, device="cuda")
    m[last, slots] = -torch.inf
    l[last, slots] = 0
    planted_rows("paged_decode", "qwen shapes", {
        "last tile of each slot left out":
        (kern(q, kp, vp, table, pos - 64, **kw), ROW_TOL),
        "last split of each row dropped from the combine":
        (paged_ops.paged_decode_combine(acc, m, l, bf16), ROW_TOL)},
        want, TOL["bfloat16"])
    del acc, m, l

    rows = [paged_decode_row("qwen", (16, 40, 8, 128, 2080, 8), qpos,
                             errs[bf16])]
    # the frontends' decode shapes (``FRONTEND_DECODE``), each held row by
    # row in both dtypes, with two planted faults the row check must
    # reject: every slot's last 64-position tile left out, and each output
    # row computed from the next head's query (rows mixed up: at group 1,
    # musicgen's, 15 of the 16 rows of a KV head's mma.sync tile are
    # padding, and a padding row that leaked into a real one would show
    # here as well)
    for name, (shape, n_patches) in FRONTEND_DECODE.items():
        fpos = frontend_pos(n_patches, shape[4])
        ferr = {}
        for dt in (f32, bf16):
            args, kw = paged_case(*shape, dt, seed=2, pos=fpos)
            want = plain(*args, **kw)
            ferr[dt] = held(kern(*args, **kw), want, dt, f"{name} {dt}")
            n += 1
        q, kp, vp, table, pos = args
        planted_rows("paged_decode", f"{name} shapes", {
            "last tile of each slot left out":
            (kern(q, kp, vp, table, pos - 64, **kw), ROW_TOL),
            "rows mixed up (each row from the next head's query)":
            (kern(q.roll(-1, dims=2).contiguous(), kp, vp, table, pos,
                  **kw), ROW_TOL)}, want, TOL["bfloat16"])
        log(f"paged_decode {name} shapes {shape}: max|err| f32 "
            f"{ferr[f32]:.3e} bf16 {ferr[bf16]:.3e}; bf16 row error RMS / "
            f"worst {rows_err[f'{name} {bf16}'][0]:.3e} / "
            f"{rows_err[f'{name} {bf16}'][1]:.3e}")
        del args, q, kp, vp, want
        rows.append(paged_decode_row(name, shape, fpos, ferr[bf16]))
    return rows


def frontend_pos(n_patches, cache_len, seed=3):
    """Ragged positions of 16 decode slots of a frontend's serve phase:
    prompts of ``TRAFFIC`` lengths behind ``n_patches`` patch positions,
    up to 31 generated tokens, slot 0 full."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pos = (rng.choice([256, 512, 1024, 2048], 16) + n_patches
           + rng.integers(0, 32, 16) - 1)
    pos[0] = cache_len - 1
    return pos


def paged_decode_row(name, shape, pos, max_err):
    """The paged GQA decode timed at one serve shape in bf16 (kernel,
    plain version, SDPA over pre-gathered K/V, the device time alone of
    the kernel and of SDPA) beside its bound; the ``kernels`` row."""
    import torch

    from repro_torch.kernels.paged_attention import (
        paged_decode_attention as kern, paged_decode_attention_ref as plain)

    b, h, hkv, dh, cache_len, ps = shape
    args, kw = paged_case(*shape, torch.bfloat16, seed=1 if name == "qwen"
                          else 2, pos=pos)
    q, kp, vp, table, pos = args
    k_ms = time_ms(lambda: kern(*args, **kw))
    p_ms = time_ms(lambda: plain(*args, **kw), iters=5)
    # library yardstick: SDPA (GQA) over K/V gathered dense beforehand —
    # the gather is not timed; the port never calls SDPA
    kd = kp[table.long()].reshape(b, -1, hkv, dh).transpose(1, 2)
    vd = vp[table.long()].reshape(b, -1, hkv, dh).transpose(1, 2)
    mask = (torch.arange(kd.shape[2], device="cuda")[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    qh = q.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    l_ms = time_ms(lambda: sdpa(qh, kd, vd, attn_mask=mask,
                                enable_gqa=hkv != h))
    k_dev = device_ms(lambda: kern(*args, **kw), per_call=2)  # + combine
    l_dev = device_ms(lambda: sdpa(qh, kd, vd, attn_mask=mask,
                                   enable_gqa=hkv != h))
    live = int((pos.long() + 1).sum().item())
    nbytes = (live * hkv * dh * 2 * 2 + 2 * q.numel() * 2
              + table.numel() * 4 + pos.numel() * 4)
    flops = live * h * dh * 2 * 2
    bound = max(nbytes / HBM_BPS, flops / BF16_FLOPS) * 1e3
    bound_by = "bytes" if nbytes / HBM_BPS >= flops / BF16_FLOPS \
        else "operations"
    log(f"paged_decode {name} bf16 (B {b}, H {h}/{hkv}, Dh {dh}, ps {ps}, "
        f"live positions {live}): max_err {max_err:.3e} kernel_ms "
        f"{k_ms:.4f} plain_ms {p_ms:.4f} library_ms {l_ms:.4f} bound_ms "
        f"{bound:.4f} ({bound_by}: {nbytes} B); device time alone "
        f"(profiler): kernel {ms_text(k_dev)} library {ms_text(l_dev)}")
    del args, q, kp, vp, kd, vd
    torch.cuda.empty_cache()
    return {"name": "paged_decode_attention", "shape": name, "route": "cuda",
            "device_ms": k_dev, "library_device_ms": l_dev,
            "source": "src/repro_torch/csrc/paged_decode.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:121",
            "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": l_ms}


# ------------------------------------------------------------------ rmsnorm
def check_rms_norm():
    import numpy as np
    import torch

    from repro_torch.kernels.rmsnorm import rms_norm as kern
    from repro_torch.kernels.rmsnorm import rms_norm_ref as plain

    rng = np.random.default_rng(6)
    out = {}
    # qwen2.5-14b's width; minicpm3-4b's (2560, q_ln 768, kv_ln 256) and
    # mamba2-780m's (1536, gated 3072); the reference grid
    shapes = [(16, 1, 5120), (16 * 2048, 5120), (16, 1, 2560),
              (2048, 768), (16, 1, 256), (2048, 1536), (16, 1, 3072),
              (128, 256), (4, 32, 512), (1, 64)]
    for dt in (torch.float32, torch.bfloat16):
        for shape in shapes:
            x = torch.tensor(rng.standard_normal(shape, np.float32),
                             device="cuda").to(dt)
            w = torch.tensor(rng.standard_normal(shape[-1], np.float32)
                             * 0.1 + 1.0, device="cuda")
            for wt in (w, w.to(dt)):
                err = close(kern(x, w=wt), plain(x, wt), dt,
                            f"rms_norm {shape} {dt} w {wt.dtype}")
            out[(shape, dt)] = (x, w.to(dt), err)
    log(f"rms_norm: {2 * len(shapes) * 2} cases match the plain version "
        "(f32 rtol/atol 2e-5, bf16 2e-2)")
    lib = torch.nn.functional.rms_norm
    rows = []
    for shape in [(16 * 2048, 5120), (16, 1, 5120)]:
        x, w, err = out[(shape, torch.bfloat16)]
        k_ms = time_ms(lambda: kern(x, w))
        p_ms = time_ms(lambda: plain(x, w))
        l_ms = time_ms(lambda: lib(x, (shape[-1],), w, 1e-5))
        k_dev = device_ms(lambda: kern(x, w), per_call=1)
        l_dev = device_ms(lambda: lib(x, (shape[-1],), w, 1e-5))
        nbytes = 2 * x.numel() * 2 + w.numel() * 2
        flops = 4 * x.numel()
        bound = max(nbytes / HBM_BPS, flops / F32_FLOPS) * 1e3
        bound_by = "bytes" if nbytes / HBM_BPS >= flops / F32_FLOPS \
            else "operations"
        log(f"rms_norm {shape} bf16: max_err {err:.3e} kernel_ms "
            f"{k_ms:.4f} plain_ms {p_ms:.4f} library_ms {l_ms:.4f} "
            f"bound_ms {bound:.4f} ({bound_by}: {nbytes} B); device time "
            f"alone (profiler): kernel {ms_text(k_dev)}, F.rms_norm "
            f"{ms_text(l_dev)}")
        rows.append({"name": "rms_norm", "route": "triton",
                     "device_ms": k_dev, "library_device_ms": l_dev,
                     "source": "src/repro_torch/kernels/rmsnorm/kernel.py",
                     "replaces": "src/repro/kernels/rmsnorm/kernel.py:27",
                     "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                     "bound_ms": bound, "bound_by": bound_by,
                     "library_ms": l_ms})
    return rows[0]          # the prefill shape carries the bytes


def check_rms_norm_bwd():
    """The RMSNorm backward kernel (``rms_norm_bwd``, through autograd's
    ``RMSNormFn`` as training calls it) against the plain backward
    (``rms_norm_bwd_ref``) at qwen2.5-14b's training shape (4096 x 5120:
    a microbatch of 4 x 1024 tokens) and the forward check's grid, in f32
    and bf16: dx elementwise (``TOL``) and, in bf16, row by row
    (``ROW_TOL``); dw by its relative L2 error (``DW_TOL``).  Two planted
    faults must fail: the mean term dropped from dx, and one program's
    block of rows left out of dw (from the kernel's own partials).  Then
    the times at the training shape in bf16: kernel, plain, and
    ``torch.autograd.grad`` through ``F.rms_norm`` on the backward
    alone."""
    import numpy as np
    import torch

    from repro_torch.kernels import rms_norm, rms_norm_bwd, rms_norm_bwd_ref
    from repro_torch.kernels.rmsnorm import kernel as rk

    rng = np.random.default_rng(7)
    shapes = [(4096, 5120), (16, 1, 5120), (16, 1, 2560), (2048, 768),
              (16, 1, 256), (2048, 1536), (16, 1, 3072), (128, 256),
              (4, 32, 512), (1, 64)]
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        for shape in shapes:
            x, dy = (torch.tensor(rng.standard_normal(shape, np.float32),
                                  device="cuda").to(dt) for _ in range(2))
            w = torch.tensor(rng.standard_normal(shape[-1], np.float32)
                             * 0.1 + 1.0, device="cuda").to(dt)
            xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
            dx, dw = torch.autograd.grad(rms_norm(xg, wg), (xg, wg), dy)
            pdx, pdw = rms_norm_bwd_ref(x, w, dy)
            what = f"rms_norm_bwd {shape} {dt}"
            err = close(dx, pdx, dt, what + " dx")
            if dt == torch.bfloat16:
                rows_close(dx, pdx, what + " dx")
            rel = ((dw.float() - pdw.float()).norm()
                   / pdw.float().norm()).item()
            if rel > DW_TOL[str(dt)[6:]]:
                raise AssertionError(f"{what}: dw relative error {rel:.3e} "
                                     f"> {DW_TOL[str(dt)[6:]]}")
            errs[(shape, dt)] = (err, rel)
    log(f"rms_norm_bwd: {2 * len(shapes)} cases match the plain backward "
        f"(dx f32 rtol/atol 2e-5, bf16 2e-2 and rows {ROW_TOL}; dw "
        f"relative L2 {DW_TOL}); worst dw error "
        f"{max(r for _, r in errs.values()):.3e}")

    # planted faults at the training shape, bf16; dy leans along x, as a
    # loss gradient does along the norm's output, so that the mean term
    # is large (with independent dy it is about 0.014 of a row)
    bf16 = torch.bfloat16
    shape = (4096, 5120)
    x, dy = (torch.tensor(rng.standard_normal(shape, np.float32),
                          device="cuda") for _ in range(2))
    x, dy = x.to(bf16), (0.5 * x + dy).to(bf16)
    w = torch.tensor(rng.standard_normal(5120, np.float32) * 0.1 + 1.0,
                     device="cuda").to(bf16)
    rstd = torch.rsqrt(x.float().square().mean(-1) + 1e-5)
    pdx, pdw = rms_norm_bwd_ref(x, w, dy)
    dx, dw = rms_norm_bwd(x, w, dy, rstd)
    xh = x.float() * rstd[:, None]
    mean_term = (xh * (xh * w.float() * dy.float()).mean(-1, keepdim=True)
                 * rstd[:, None])
    planted_rows("rms_norm_bwd dx", "4096 x 5120", {
        "mean term dropped": ((dx.float() + mean_term).to(bf16), ROW_TOL)},
        pdx, TOL["bfloat16"])
    n = rk.programs(shape[0], x.device)
    partials = torch.empty((n, 5120), dtype=torch.float32, device="cuda")
    rk.launch_bwd(x, w, dy, rstd, torch.empty_like(x),
                  torch.empty(5120, dtype=bf16, device="cuda"), partials)
    short = (partials.sum(0) - partials[n // 2]).to(bf16)
    rel = ((short.float() - pdw.float()).norm() / pdw.float().norm()).item()
    log(f"rms_norm_bwd planted fault (one row block of {n} left out of dw, "
        f"4096 x 5120): dw relative error {rel:.3e}")
    if rel <= DW_TOL["bfloat16"]:
        raise AssertionError("rms_norm_bwd: the dw check does not reject "
                             "one row block left out")

    # times at the training shape, bf16
    k_ms = time_ms(lambda: rms_norm_bwd(x, w, dy, rstd))
    p_ms = time_ms(lambda: rms_norm_bwd_ref(x, w, dy))
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = torch.nn.functional.rms_norm(xg, (5120,), wg, 1e-5)
    l_ms = time_ms(lambda: torch.autograd.grad(y, (xg, wg), dy,
                                               retain_graph=True))
    k_dev = device_ms(lambda: rms_norm_bwd(x, w, dy, rstd), per_call=2,
                      lead=8)
    l_dev = device_ms(lambda: torch.autograd.grad(y, (xg, wg), dy,
                                                  retain_graph=True))
    nbytes = 3 * x.numel() * 2 + w.numel() * 2      # x, dy, w in; dx out
    flops = 9 * x.numel()
    bound = max(nbytes / HBM_BPS, flops / F32_FLOPS) * 1e3
    bound_by = "bytes" if nbytes / HBM_BPS >= flops / F32_FLOPS \
        else "operations"
    err, rel = errs[(shape, bf16)]
    log(f"rms_norm_bwd {shape} bf16: max_err {err:.3e} (dw rel {rel:.3e}) "
        f"kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} library_ms {l_ms:.4f} "
        f"bound_ms {bound:.4f} ({bound_by}: {nbytes} B); device time "
        f"alone (profiler): kernel (both launches) {ms_text(k_dev)}, "
        f"autograd through F.rms_norm {ms_text(l_dev)}")
    return {"name": "rms_norm_bwd", "route": "triton",
            "source": "src/repro_torch/kernels/rmsnorm/kernel.py",
            "replaces": "src/repro/models/layers.py:11",
            "shape": "4096 x 5120 bf16", "device_ms": k_dev,
            "library_device_ms": l_dev,
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": l_ms}

def check_rms_norm_rstd_bwd():
    """The given-statistic backward (pass 1 ``rms_norm_dot``, then pass 2
    ``rms_norm_bwd_rstd``: tensor parallelism's gated norm in training)
    at mamba2-780m's two-rank shape, 4096 rows (a microbatch of 4 x 1024)
    of d_inner 3072 in two halves of 1536, and at its model-4 shape, four
    quarters of 768: the statistic from the whole row, each part's row
    term ``s_loc`` from pass 1 and the parts' terms added (the all-reduce
    over the model group); each part's dx and dw against the plain
    backward of the whole row (``rms_norm_bwd_ref``), in f32 and bf16: dx
    elementwise (``TOL``) and in bf16 row by row (``ROW_TOL``), dw by
    ``DW_TOL``; the row terms and the sum of pass 1's ``dw`` partials
    against ``rms_norm_dot_ref``.  dy leans along x, as a loss gradient
    does along the norm's output, so that the statistic's term is large.
    Then the halves through autograd (``rms_norm_rstd`` with the sum as
    its ``reduce``).  Two planted faults must fail: each half's own
    ``s_loc`` not summed with the other's (dx, row by row), and one of
    pass 1's ``dw`` partials left out of pass 2's sum (dw, ``DW_TOL``).
    Then the times of one half, both launches, in bf16: device time over
    rotating inputs and CUDA-event time beside the bound with x and dy
    read once (which pass 2 reaches only from L2) and read twice, and
    the plain version; no PyTorch call applies a given statistic."""
    import numpy as np
    import torch

    from repro_torch.kernels import (rms_norm_bwd_ref, rms_norm_bwd_rstd,
                                     rms_norm_bwd_rstd_ref, rms_norm_dot,
                                     rms_norm_dot_ref, rms_norm_rstd)

    rng = np.random.default_rng(11)
    rows, width, eps = 4096, 3072, 1e-5
    half = width // 2
    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.tensor(rng.standard_normal((rows, width), np.float32),
                         device="cuda")
        dy = (0.5 * x + torch.tensor(rng.standard_normal((rows, width),
                                                         np.float32),
                                     device="cuda")).to(dt)
        x = x.to(dt)
        w = torch.tensor(rng.standard_normal(width, np.float32) * 0.1 + 1.0,
                         device="cuda").to(dt)
        rstd = torch.rsqrt(x.float().square().mean(-1) + eps)
        pdx, pdw = rms_norm_bwd_ref(x, w, dy, eps)
        tag = str(dt)[6:]
        for ranks in (2, 4):
            cut = width // ranks
            parts = [slice(k * cut, (k + 1) * cut) for k in range(ranks)]
            ops = [(x[:, p].contiguous(), w[p].contiguous(),
                    dy[:, p].contiguous()) for p in parts]
            dots = [rms_norm_dot(*o, rstd) for o in ops]
            for o, (s_k, partials) in zip(ops, dots):
                want, want_dw = rms_norm_dot_ref(*o, rstd)
                rel = ((s_k - want).norm() / want.norm()).item()
                rel_dw = ((partials.sum(0) - want_dw[0]).norm()
                          / want_dw[0].norm()).item()
                if rel > 1e-5 or rel_dw > 1e-5:
                    raise AssertionError(
                        f"rms_norm_dot {tag} ({rows}, {cut}): row terms off "
                        f"by {rel:.3e}, the dw partials' sum by {rel_dw:.3e}")
            s = sum(s_k for s_k, _ in dots)
            for k, p in enumerate(parts):
                dx, dw = rms_norm_bwd_rstd(*ops[k], rstd, s, width,
                                           dots[k][1])
                what = f"rms_norm_bwd_rstd ({rows}, {cut}) {tag} part {k}"
                err = close(dx, pdx[:, p], dt, what + " dx")
                if dt == torch.bfloat16:
                    rows_close(dx, pdx[:, p], what + " dx")
                rel = ((dw.float() - pdw[p].float()).norm()
                       / pdw[p].float().norm()).item()
                if rel > DW_TOL[tag]:
                    raise AssertionError(f"{what}: dw relative error "
                                         f"{rel:.3e} > {DW_TOL[tag]}")
                worst[(tag, ranks, k)] = (err, rel)
        # through autograd, the halves' row terms summed by ``reduce``
        halves = [slice(0, half), slice(half, width)]
        s_loc = [rms_norm_dot_ref(x[:, p], w[p], dy[:, p], rstd)[0]
                 for p in halves]
        xs = [x[:, p].contiguous().requires_grad_() for p in halves]
        ws = [w[p].contiguous().requires_grad_() for p in halves]
        for k in range(2):
            y = rms_norm_rstd(xs[k], ws[k], rstd, width=width,
                              reduce=lambda t, o=s_loc[1 - k]: t + o)
            y.backward(dy[:, halves[k]])
            close(xs[k].grad, pdx[:, halves[k]], dt,
                  f"rms_norm_rstd autograd {tag} half {k} dx")
    log(f"rms_norm_bwd_rstd: the halves and the quarters of ({rows}, "
        f"{width}) in f32 and bf16 match the whole row's plain backward (dx "
        f"{TOL}, bf16 rows {ROW_TOL}; dw {DW_TOL}); worst dx error "
        f"{max(e for e, _ in worst.values()):.3e}, dw "
        f"{max(r for _, r in worst.values()):.3e}; the halves the same "
        f"through autograd")

    # the planted faults (bf16): a half's own row term, not the sum; one
    # of pass 1's dw partials left out of pass 2's sum
    bf16 = torch.bfloat16
    xh, wh, dyh = (t[:, :half].contiguous() if t.dim() == 2 else
                   t[:half].contiguous() for t in (x, w, dy))
    s_own, partials = rms_norm_dot(xh, wh, dyh, rstd)
    dx, _ = rms_norm_bwd_rstd(xh, wh, dyh, rstd, s_own, width, partials)
    planted_rows("rms_norm_bwd_rstd dx", f"{rows} x {half}", {
        "s_loc not all-reduced": (dx, ROW_TOL)}, pdx[:, :half],
        TOL["bfloat16"])
    n = partials.shape[0]
    short = partials.clone()
    short[n // 2] = 0.0
    _, dw = rms_norm_bwd_rstd(xh, wh, dyh, rstd, s_own + s_loc[1], width,
                              short)
    rel = ((dw.float() - pdw[:half].float()).norm()
           / pdw[:half].float().norm()).item()
    log(f"rms_norm_bwd_rstd planted fault (one dw partial of {n} left out, "
        f"{rows} x {half}): dw relative error {rel:.3e}")
    if rel <= DW_TOL["bfloat16"]:
        raise AssertionError("rms_norm_bwd_rstd: the dw check does not "
                             "reject one dw partial left out")

    # times of one half (one rank's work), both launches, bf16
    def plain():
        s_p, parts_p = rms_norm_dot_ref(xh, wh, dyh, rstd)
        rms_norm_bwd_rstd_ref(xh, wh, dyh, rstd, s_p, width, parts_p)

    def both(a, b, c, r):
        s_k, parts_k = rms_norm_dot(a, b, c, r)
        return rms_norm_bwd_rstd(a, b, c, r, s_k, width, parts_k)

    # x and dy read, dx written, w read and dw written, once each; rstd
    # read, s written by pass 1 and read by pass 2 (the all-reduce between
    # them); pass 2 reads x and dy again, from L2 at best
    nbytes = 3 * xh.numel() * 2 + 2 * wh.numel() * 2 + rows * 4 * 3
    nbytes2 = nbytes + 2 * xh.numel() * 2
    # 38 MB, under L2: the kernel timed over rotating copies of its inputs
    rot, n_rot = rotated(both, (xh, wh, dyh, rstd), nbytes)
    k_ms, p_ms = time_ms(rot), time_ms(plain)
    k_dev = device_ms(rot, per_call=2, lead=8)
    del rot
    flops = 11 * xh.numel()
    bound = max(nbytes / HBM_BPS, flops / F32_FLOPS) * 1e3
    bound2 = max(nbytes2 / HBM_BPS, flops / F32_FLOPS) * 1e3
    bound_by = "bytes" if nbytes / HBM_BPS >= flops / F32_FLOPS \
        else "operations"
    share = ("not measured" if k_dev is None else
             f"{bound / k_dev:.0%} of the one-read bound, "
             f"{bound2 / k_dev:.0%} of the two-read bound")
    err, rel = worst[("bfloat16", 2, 0)]
    log(f"rms_norm_bwd_rstd ({rows}, {half}) bf16: max_err {err:.3e} (dw rel "
        f"{rel:.3e}) kernel_ms {k_ms:.4f} by events (rms_norm_dot + "
        f"rms_norm_bwd_rstd, 2 launches a call) plain_ms {p_ms:.4f} "
        f"library_ms none (no call applies a given statistic) bound_ms "
        f"{bound:.4f} ({bound_by}: {nbytes} B, x and dy read once) and "
        f"{bound2:.4f} (read twice: {nbytes2} B); device time alone "
        f"(profiler, the 2 launches) {ms_text(k_dev)}: {share}; timed over "
        f"{n_rot} rotating copies of its inputs")
    return {"name": "rms_norm_bwd_rstd", "route": "triton",
            "source": "src/repro_torch/kernels/rmsnorm/kernel.py",
            "replaces": "src/repro/models/layers.py:11",
            "shape": f"mamba2 2 ranks gated norm ({rows}, {half}) bf16, "
                     "given statistic", "device_ms": k_dev,
            "library_device_ms": None, "max_abs_err": err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound, "bound_by": bound_by,
            "bound_two_reads_ms": bound2, "library_ms": None}



# ---------------------------------------------------------------- paged MLA
def mla_case(b, h, rkv, dr, cache_len, ps, dtype, seed, pos=None,
             garbage_rest=True):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    if pos is None:
        pos = rng.integers(0, cache_len, b)
        pos[0] = cache_len - 1
    pos = np.asarray(pos, np.int32)
    table, num_pages = paged_table(b, cache_len, ps, pos, rng, garbage_rest)

    def t(shape):
        return torch.tensor(rng.standard_normal(shape, np.float32),
                            device="cuda").to(dtype)
    return (t((b, 1, h, rkv)), t((b, 1, h, dr)), t((num_pages, ps, rkv)),
            t((num_pages, ps, dr)), torch.tensor(table, device="cuda"),
            torch.tensor(pos, device="cuda"))


def check_paged_mla():
    import torch

    from repro_torch.kernels import (paged_mla_decode_attention as kern,
                                     paged_mla_decode_attention_ref as plain)
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.paged_attention import ref as paged_ref

    f32, bf16 = torch.float32, torch.bfloat16
    n = 0
    rows_err = {}

    def held(got, want, dt, what):
        return held_rows(got, want, dt, what, rows_err)

    # the reference's grid (tests/test_kernels.py:140-163) in both dtypes,
    # at its scale (rkv + dr)^-1/2; 40 heads (not a power of two)
    for dt in (f32, bf16):
        for shape in [(2, 4, 32, 16, 16, 4), (3, 2, 16, 8, 12, 1),
                      (1, 8, 64, 32, 8, 8), (3, 40, 256, 32, 40, 8),
                      (2, 6, 128, 64, 24, 2)]:
            args = mla_case(*shape, dt, seed=9)
            kw = dict(page_size=shape[-1],
                      scale=(shape[2] + shape[3]) ** -0.5)
            held(kern(*args, **kw), plain(*args, **kw), dt,
                 f"mla grid {shape} {dt}")
            n += 1
    # poisoned garbage page must be inert, bit for bit (one split and
    # split shapes); future pages masked
    for dt in (f32, bf16):
        for shape, pos in (((3, 4, 32, 16, 16, 4), [0, 5, 15]),
                           ((4, 40, 256, 32, 2080, 8), [0, 255, 1000, 2079])):
            args = mla_case(*shape, dt, seed=10, pos=pos)
            kw = dict(page_size=shape[-1], scale=0.2)
            clean = kern(*args, **kw)
            args[2][0] = 1e4
            args[3][0] = 1e4
            poisoned = kern(*args, **kw)
            if not torch.equal(clean, poisoned) or \
                    not torch.isfinite(poisoned).all():
                raise AssertionError(f"garbage page leaked into the MLA "
                                     f"output ({dt}, {shape})")
            n += 1
        args = mla_case(2, 2, 16, 8, 16, 4, dt, seed=11, pos=[2, 9],
                        garbage_rest=False)
        kw = dict(page_size=4, scale=0.2)
        held(kern(*args, **kw), plain(*args, **kw), dt,
             f"mla future pages {dt}")
        n += 1
    # minicpm3-4b decode widths: 40 heads, Rkv 256, Dr 32, ps 8,
    # cache_len 2080, the model's scale (nope + rope)^-1/2
    kw = dict(page_size=8, scale=(64 + 32) ** -0.5)
    n_split, split_len = paged_ops.split_plan(2080, 8)
    # split boundaries: positions at and around the split length, a slot
    # at 0, the last position
    edge = [split_len - 2, split_len - 1, split_len, 0, 2079,
            2 * split_len - 1, 2 * split_len, 1]
    for dt in (f32, bf16):
        args = mla_case(8, 40, 256, 32, 2080, 8, dt, seed=12, pos=edge)
        held(kern(*args, **kw), plain(*args, **kw), dt,
             f"mla split edges (n_split {n_split}, split_len {split_len}) "
             f"{dt}")
        n += 1
    qpos = decode_pos()
    errs = {}
    for dt in (f32, bf16):
        args = mla_case(16, 40, 256, 32, 2080, 8, dt, seed=1, pos=qpos)
        errs[dt] = held(kern(*args, **kw), plain(*args, **kw), dt,
                        f"minicpm3 shapes {dt}")
        n += 1
    # the shared combine kernel against its plain version on the bf16
    # split kernel's own partials (these launches are not counted)
    args = mla_case(16, 40, 256, 32, 2080, 8, bf16, seed=1, pos=qpos)
    want = plain(*args, **kw)
    acc, m, l = paged_ops.paged_mla_decode_partials(
        *args, n_split=n_split, split_len=split_len, **kw)
    if not torch.equal(l == 0, m == -torch.inf):
        raise AssertionError("an empty MLA split's partial is not (m = "
                             "-inf, l = 0)")
    comb_err = held(paged_ops.paged_decode_combine(acc, m, l, bf16),
                    paged_ref.paged_decode_combine_ref(acc, m, l, bf16),
                    bf16, f"mla combine {bf16}")
    n += 1
    worst = max(rows_err, key=lambda k: rows_err[k][1])
    log(f"paged_mla_decode: {n} cases match the plain version (f32 "
        f"rtol/atol 2e-5, bf16 2e-2 and row error {ROW_TOL}); minicpm3 "
        f"shapes max|err| f32 {errs[f32]:.3e} bf16 {errs[bf16]:.3e}; bf16 "
        f"row error RMS / worst: minicpm3 shapes "
        f"{rows_err[f'minicpm3 shapes {bf16}'][0]:.3e} / "
        f"{rows_err[f'minicpm3 shapes {bf16}'][1]:.3e}, combine on the "
        f"split kernel's partials ({n_split} splits of {split_len}) max|err| "
        f"{comb_err:.3e}; worst row of all bf16 cases "
        f"{rows_err[worst][1]:.3e} ({worst})")

    # planted kernel faults at minicpm3's decode shape in bf16: the last
    # 64-position tile of every slot left out, and each row's last
    # non-empty split dropped from the combine (on the split kernel's
    # own partials); the row check must reject both
    ql, qr, cp, kp, table, pos = args
    last, slots = pos.long() // split_len, torch.arange(16, device="cuda")
    m[last, slots] = -torch.inf
    l[last, slots] = 0
    planted_rows("paged_mla_decode", "minicpm3 shapes", {
        "last tile of each slot left out":
        (kern(ql, qr, cp, kp, table, pos - 64, **kw), ROW_TOL),
        "last split of each row dropped from the combine":
        (paged_ops.paged_decode_combine(acc, m, l, bf16), ROW_TOL)},
        want, TOL["bfloat16"])
    del acc, m, l

    live = int((pos.long() + 1).sum().item())
    nbytes = (live * (256 + 32) * 2 + (ql.numel() + qr.numel()) * 2
              + ql.numel() * 2 + table.numel() * 4 + pos.numel() * 4)
    # 10.3 MB, under L2: timed over rotating copies of its inputs
    rot, n_rot = rotated(lambda *a: kern(*a, **kw), args, nbytes)
    k_ms = time_ms(rot)
    p_ms = time_ms(lambda: plain(*args, **kw), iters=5)
    # library yardstick: SDPA over [ckv || krope] keys (E 288) and ckv
    # values (Ev 256) gathered dense beforehand, one kv head broadcast to
    # the 40 query heads (the gather is not timed; the port never calls
    # SDPA)
    cd = cp[table.long()].reshape(16, 1, -1, 256)
    kd = torch.cat([cd, kp[table.long()].reshape(16, 1, -1, 32)], dim=-1)
    qh = torch.cat([ql, qr], dim=-1).transpose(1, 2)       # (16, 40, 1, 288)
    mask = (torch.arange(kd.shape[2], device="cuda")[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        return sdpa(qh, kd, cd, attn_mask=mask, scale=kw["scale"],
                    enable_gqa=True)
    l_ms = time_ms(library)
    k_dev = device_ms(rot, per_call=2, lead=8)  # + combine
    l_dev = device_ms(library, lead=8)
    del rot
    flops = live * 40 * (256 + 32 + 256) * 2
    bound = max(nbytes / HBM_BPS, flops / BF16_FLOPS) * 1e3
    bound_by = "bytes" if nbytes / HBM_BPS >= flops / BF16_FLOPS \
        else "operations"
    log(f"paged_mla_decode minicpm3 bf16 (B 16, H 40, Rkv 256, Dr 32, ps 8, "
        f"live positions {live}, {n_split} splits of {split_len}): max_err "
        f"{errs[bf16]:.3e} kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
        f"library_ms {l_ms:.4f} bound_ms {bound:.4f} ({bound_by}: {nbytes} "
        f"B, {flops} FLOP); device time alone (profiler): kernel "
        f"{ms_text(k_dev)} library {ms_text(l_dev)}; the kernel timed over "
        f"{n_rot} rotating copies of its inputs")
    return {"name": "paged_mla_decode_attention", "route": "cuda",
            "device_ms": k_dev, "library_device_ms": l_dev,
            "source": "src/repro_torch/csrc/paged_mla_decode.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:200",
            "max_abs_err": errs[bf16], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": l_ms}


# ----------------------------------------------------------------- SSD scan
# the SSD forward's model shapes on the card (batch, heads, state; S 2048,
# P 64, chunk 256): mamba2-780m's prefill at batch 1 and 16, jamba-v0.1-
# 52b's at batch 1
SSD_SHAPES = ((1, 48, 128), (16, 48, 128), (1, 128, 16))


def ssd_case(b, s, h, p, n, dtype, seed):
    """tests/test_kernels.py:211-216, drawn with numpy on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0, dt=dtype):
        return (torch.tensor(rng.standard_normal(shape, np.float32),
                             device="cuda") * scale).to(dt)
    x = t((b, s, h, p))
    dt = torch.nn.functional.softplus(t((b, s, h), dt=torch.float32)) * 0.1
    a = -torch.exp(t((h,), 0.3, torch.float32))
    return x, dt, a, t((b, s, h, n), 0.5), t((b, s, h, n), 0.5)


def ssd_model_layout(b, s, h, p, n, dtype, seed):
    """x, dt, a, B and C as ``models/ssm.py`` hands them to the scan at
    mamba2-780m's ``ssm_ngroups = 1``: x a view of the conv output (B, S,
    H*P + 2N), B and C its one group expanded to every head (head stride
    0), read in place."""
    import torch

    x, dt, a, bmat, cmat = ssd_case(b, s, h, p, n, dtype, seed)
    conv = torch.cat([x.flatten(2), bmat[:, :, 0], cmat[:, :, 0]], -1)
    bc = conv[..., h * p:].unflatten(-1, (2, 1, n))
    return (conv[..., :h * p].unflatten(-1, (h, p)), dt, a,
            bc[:, :, 0].expand(b, s, h, n), bc[:, :, 1].expand(b, s, h, n))


def check_ssd():
    import torch

    from repro_torch.kernels import ssd_scan as kern
    from repro_torch.kernels import ssd_scan_ref as plain
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops

    f32, bf16 = torch.float32, torch.bfloat16
    n = 0
    rows_err = {}

    def plain_f32(args, chunk):
        """The plain version in f32 from the same (bf16) inputs."""
        x, dt, a, bmat, cmat = args
        return plain(x.float(), dt, a, bmat.float(), cmat.float(),
                     chunk=chunk)

    def both(args, chunk, dt, what, plain_chunk=None):
        y, hf = kern(*args, chunk=chunk)
        y_r, hf_r = plain(*args, chunk=plain_chunk or chunk)
        err = max(close(y, y_r, dt, f"{what} y", SSD_TOL),
                  close(hf, hf_r, dt, f"{what} h_final", SSD_TOL))
        if dt == bf16:      # y row by row against the f32 plain version
            rows_err[what] = rows_close(
                y, plain_f32(args, plain_chunk or chunk)[0], f"{what} y",
                SSD_ROW_TOL)
        return err

    # the reference's grid (tests/test_kernels.py:205-243) in both dtypes
    for dt in (f32, bf16):
        for b, s, h, p, nn, chunk in [(1, 128, 2, 64, 32, 32),
                                      (2, 256, 4, 32, 64, 64),
                                      (1, 64, 1, 16, 16, 64)]:
            both(ssd_case(b, s, h, p, nn, dt, seed=4), chunk, dt,
                 f"ssd grid {(b, s, h, p, nn, chunk)} {dt}")
            n += 1
    # chunk invariance, and a short last chunk (S not a multiple of the
    # chunk) against the plain version over one chunk of all S positions
    for dt in (f32, bf16):
        args = ssd_case(1, 128, 2, 32, 32, dt, seed=5)
        ys = [kern(*args, chunk=c)[0] for c in (16, 32, 128)]
        for y in ys[1:]:
            close(y, ys[0], dt, f"ssd chunk invariance {dt}", SSD_TOL)
        for s, chunk in ((100, 32), (300, 256), (2047, 256)):
            both(ssd_case(2, s, 3, 64, 128, dt, seed=6), chunk, dt,
                 f"ssd partial last chunk S {s} {dt}", plain_chunk=s)
        n += 4
    # mamba2-780m prefill shapes (48 heads, P 64, N 128, chunk 256, S
    # 2048, batch 1 and 16) and jamba-v0.1-52b's (128 heads, P 64, N 16):
    # per-head B and C, then B and C in the model's own layout (one group
    # broadcast to every head, read in place): the same numbers bit for bit
    errs = {}
    for b, h, nn in SSD_SHAPES:
        for dt in (f32, bf16):
            args = ssd_model_layout(b, 2048, h, 64, nn, dt, seed=1)
            per_head = [t.contiguous() for t in args]
            what = f"{ssd_name(b, h)} {dt}"
            errs[(b, h, dt)] = both(per_head, 256, dt, what)
            y, hf = kern(*args, chunk=256)
            y2, hf2 = kern(*per_head, chunk=256)
            if not (torch.equal(y, y2) and torch.equal(hf, hf2)):
                raise AssertionError(f"{what}: B and C read in place (head "
                                     "stride 0) differ from per-head copies")
            n += 2
    worst = max(rows_err, key=lambda k: rows_err[k][1])
    b1 = rows_err[f"{ssd_name(1, 48)} {bf16}"]
    log(f"ssd_scan: {n} cases match the plain version (f32 rtol/atol 1e-4, "
        f"bf16 4e-2, and bf16 y row by row against the plain version in f32 "
        f"{SSD_ROW_TOL}); model shapes max|err| "
        + ", ".join(f"{ssd_name(b, h)} {str(dt)[6:]} {e:.3e}"
                    for (b, h, dt), e in errs.items())
        + f"; bf16 row error RMS / worst at mamba2 B 1: {b1[0]:.3e} / "
        f"{b1[1]:.3e}; worst row of all bf16 cases {rows_err[worst][1]:.3e} "
        f"({worst})")

    # the bf16 phases one by one, and a planted fault between them: the
    # state entering chunk 4 of 8 not handed on (zeroed).  The row check
    # must reject it.
    args = ssd_model_layout(1, 2048, 48, 64, 128, bf16, seed=1)
    want = plain_f32(args, 256)[0]
    states, decay = ssd_ops.ssd_chunk_states(*args, chunk=256)
    h_prev, _ = ssd_ops.ssd_state_pass(states, decay)
    rows_close(ssd_ops.ssd_chunk_output(*args, h_prev, chunk=256), want,
               "ssd phases one by one", SSD_ROW_TOL)
    h_prev[:, :, 4] = 0
    planted_rows("ssd_scan", "mamba2 shapes B 1", {
        "state entering chunk 4 not handed on":
        (ssd_ops.ssd_chunk_output(*args, h_prev, chunk=256), SSD_ROW_TOL)},
        want, SSD_TOL["bfloat16"])
    del states, decay, h_prev

    rows = []
    for b, h, nn in SSD_SHAPES:
        args = ssd_model_layout(b, 2048, h, 64, nn, bf16, seed=1)
        k_ms = time_ms(lambda: kern(*args, chunk=256))
        k_dev = device_ms(lambda: kern(*args, chunk=256), per_call=3,
                          lead=8)
        p_ms = time_ms(lambda: plain(*args, chunk=256), iters=2, warmup=1)
        s, p, q = 2048, 64, 256
        # x, dt and a read once, y and h_final written once; B and C once
        # per group (ngroups 1): the kernel reads the model's broadcast
        # view in place, so the 48 heads share one copy in device memory.
        # The count of the first version, B and C once per head (what its
        # wrapper's copies wrote out), is logged beside it.
        rest = (b * s * h * p * 2 + b * s * h * 4 + h * 4
                + b * s * h * p * 2 + b * h * p * nn * 4)
        nbytes = rest + b * s * 2 * nn * 2
        nbytes_head = rest + b * s * h * 2 * nn * 2
        per_chunk = q * (q + 1) // 2 * (nn + p) + 2 * q * p * nn
        flops = 2 * b * h * (s // q) * per_chunk
        bound = max(nbytes / HBM_BPS, flops / BF16_FLOPS) * 1e3
        bound_head = max(nbytes_head / HBM_BPS, flops / BF16_FLOPS) * 1e3
        bound_by = "bytes" if nbytes / HBM_BPS >= flops / BF16_FLOPS \
            else "operations"
        log(f"ssd_scan {ssd_name(b, h)} bf16 (S 2048, H {h}, P 64, N {nn}, "
            f"chunk 256, B and C in the model's layout): max_err "
            f"{errs[(b, h, bf16)]:.3e} kernel_ms {k_ms:.4f} plain_ms "
            f"{p_ms:.4f} library_ms none (no single PyTorch call computes "
            f"it) bound_ms {bound:.4f} ({bound_by}: {nbytes} B with B and "
            f"C once per group, {flops} FLOP) [B and C once per head: "
            f"{bound_head:.4f} ms, {nbytes_head} B]; device time alone "
            f"(profiler, three launches) {ms_text(k_dev)}")
        rows.append({"name": "ssd_scan", "route": "cuda",
                     "device_ms": k_dev,
                     "source": "src/repro_torch/csrc/ssd_chunk.cu",
                     "replaces": "src/repro/kernels/ssd_chunk/kernel.py:80",
                     "max_abs_err": errs[(b, h, bf16)], "ms": k_ms,
                     "plain_ms": p_ms, "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": None})
    return rows[0]          # mamba2 batch 1: the serve phase's prefill


def ssd_name(b, h):
    return f"{'jamba' if h == 128 else 'mamba2'} B {b}"


# --------------------------------------------------------- SSD backward
# the SSD backward's cases on the card (B, S, H, P, N, chunk): the
# reference's grid (tests/test_kernels.py:205-209), a short last chunk,
# mamba2-780m's train microbatch and jamba-v0.1-52b's prefill
SSD_BWD_SHAPES = [(1, 128, 2, 64, 32, 32), (2, 256, 4, 32, 64, 64),
                  (1, 64, 1, 16, 16, 64), (2, 300, 3, 64, 128, 256),
                  (4, 1024, 48, 64, 128, 256), (1, 2048, 128, 64, 16, 256)]
SSD_TRAIN_SHAPE = (4, 1024, 48, 64, 128, 256)


def ssd_grad_case(b, s, h, p, n, dtype, seed):
    """The scan's inputs in the model's layout as autograd leaves — the
    conv output (B, S, H*P + 2N) whose views are x and the one group's B
    and C, dt and a (``ssd_views``) — and an output gradient dy (B, S, H,
    P) and dh_final (B, H, P, N)."""
    import numpy as np
    import torch

    x, dt, a, bmat, cmat = ssd_case(b, s, h, p, n, dtype, seed)
    conv = torch.cat([x.flatten(2), bmat[:, :, 0], cmat[:, :, 0]], -1)
    rng = np.random.default_rng(seed + 100)
    dy = torch.tensor(rng.standard_normal((b, s, h, p), np.float32),
                      device="cuda").to(dtype)
    dhf = torch.tensor(rng.standard_normal((b, h, p, n), np.float32),
                       device="cuda")
    return [conv, dt, a], dy, dhf


def ssd_views(conv, dt, a, h, p, n):
    """x, dt, a, B, C as ``models/ssm.py`` hands them to the scan."""
    b, s = conv.shape[:2]
    bc = conv[..., h * p:].unflatten(-1, (2, 1, n))
    return (conv[..., :h * p].unflatten(-1, (h, p)), dt, a,
            bc[:, :, 0].expand(b, s, h, n), bc[:, :, 1].expand(b, s, h, n))


def ssd_grads(scan, leaves, dy, dhf, shape, per_head=False):
    """{dx, dB, dC (the group's), ddt, da} through autograd from
    ``scan(*ssd_views(leaves))``; ``per_head``: B and C copied to every
    head first (head stride N: the backward's per-head C B^T route)."""
    import torch

    _, _, h, p, n, chunk = shape
    leaves = [t.detach().requires_grad_() for t in leaves]
    views = ssd_views(*leaves, h, p, n)
    if per_head:
        views = views[:3] + tuple(t.contiguous() for t in views[3:])
    y, hf = scan(*views, chunk=chunk)
    dconv, ddt, da = torch.autograd.grad((y, hf), leaves,
                                         (dy.to(y.dtype), dhf))
    return {"dx": dconv[..., :h * p].unflatten(-1, (h, p)),
            "dB": dconv[..., h * p:h * p + n],
            "dC": dconv[..., h * p + n:], "ddt": ddt, "da": da}


def grads_rows(got, want):
    """Each gradient's (row error RMS, worst row) against ``want``."""
    return {k: row_rel(got[k], want[k]) for k in want}


def rows_rejected(rows, tol=SSD_ROW_TOL):
    return [k for k, (rms, worst) in rows.items()
            if rms > tol["rms"] or worst > tol["worst"]]


def ssd_bwd_plan_text(plan):
    """The backward's launches: blocks, shared memory a block and blocks
    an SM holds (the CUDA runtime's occupancy calculator)."""
    return ", ".join(f"{k} {v['blocks']} x {v['threads']} ({v['smem']} B, "
                     f"{v['per_sm']}/SM)" for k, v in plan.items())


def check_ssd_bwd():
    """The SSD backward kernel (``ssd_scan_bwd``, through autograd's
    ``SSDScanFn`` as training calls it, in the model's layout: B and C
    one group's view of stride 0 over the heads) against autograd through
    the plain scan in f32 from the same inputs, at ``SSD_BWD_SHAPES`` in
    f32 (``SSD_BWD_TOL``) and bf16 (row by row, ``SSD_ROW_TOL``): dx,
    the group's dB and dC, ddt and da; in bf16 also with B and C copied
    to every head (the per-head C B^T route, G = H), whose five raw
    gradients must equal the group route's (G = 1) bit for bit.  Then
    the bf16 backward's phases one at a time at mamba2's train shape
    (states and passes, C B^T held to ``ssd_cb_ref``, the within-chunk
    gradients), and four planted faults the row check must reject: the
    gradient of the carried state dropped (the reverse pass does not
    propagate), one chunk's dB zeroed, dB times the group's head count,
    and one tile pair of the C B^T scratch zeroed.  Then the launches'
    blocks, shared memory and occupancy (rows and columns must hold two
    blocks an SM at P 64 and N 128; states, rows and columns launch at
    least 132 blocks at the timed shapes), and the times at mamba2's
    train shape and jamba's, in bf16: kernel, plain backward, device time
    alone."""
    import torch

    from repro_torch.kernels import ssd_scan, ssd_scan_bwd, ssd_scan_bwd_ref
    from repro_torch.kernels import ssd_scan_ref
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    from repro_torch.kernels.ssd_chunk import ssd_cb_ref

    f32, bf16 = torch.float32, torch.bfloat16
    worst_rows, abs_err, worst_f32 = {}, {}, 0.0
    n_cases = 0
    for dt in (f32, bf16):
        for shape in SSD_BWD_SHAPES:
            leaves, dy, dhf = ssd_grad_case(*shape[:5], dt, seed=3)
            want = ssd_grads(ssd_scan_ref, [t.float() for t in leaves],
                             dy.float(), dhf, shape)
            for per_head in ((False,) if dt == f32 else (False, True)):
                got = ssd_grads(ssd_scan, leaves, dy, dhf, shape, per_head)
                n_cases += 1
                what = (f"ssd_scan_bwd {shape} {dt}"
                        f"{' per-head B and C' if per_head else ''}")
                for k, g in got.items():
                    if not torch.isfinite(g.float()).all():
                        raise AssertionError(f"{what}: non-finite {k}")
                if dt == f32:
                    for k, w in want.items():
                        err = (got[k] - w).abs()
                        tol = (SSD_BWD_TOL["rtol"] * w.abs()
                               + SSD_BWD_TOL["atol_of_max"] * w.abs().max())
                        if (err > tol).any():
                            raise AssertionError(
                                f"{what}: {k} max |err| "
                                f"{err.max().item():.3e} outside "
                                f"{SSD_BWD_TOL}")
                        worst_f32 = max(worst_f32, (err.max()
                                                    / w.abs().max()).item())
                    continue
                rows = grads_rows(got, want)
                bad = rows_rejected(rows)
                if bad:
                    raise AssertionError(f"{what}: rows of {bad} outside "
                                         f"{SSD_ROW_TOL}: {rows}")
                worst_rows[shape, per_head] = rows
                abs_err[shape, per_head] = max(
                    (got[k].float() - want[k]).abs().max().item()
                    for k in want)
            if dt == bf16:      # the two C B^T routes give the same bits
                _, _, h, p, n, chunk = shape
                views = ssd_views(*leaves, h, p, n)
                heads = views[:3] + tuple(t.contiguous() for t in views[3:])
                one = ssd_scan_bwd(*views, dy, dhf, chunk=chunk)
                many = ssd_scan_bwd(*heads, dy, dhf, chunk=chunk)
                for k, g1, gh in zip(("dx", "ddt", "da", "dB", "dC"), one,
                                     many):
                    if not torch.equal(g1, gh):
                        raise AssertionError(
                            f"ssd_scan_bwd {shape}: per-head B and C (G = "
                            f"H) give another {k} than the group's view")
    log(f"ssd_scan_bwd: {n_cases} cases match the plain backward in the "
        f"model's layout (f32 {SSD_BWD_TOL}: worst error {worst_f32:.3e} "
        f"of a gradient's largest value; bf16 row by row {SSD_ROW_TOL}, "
        f"B and C as one group's view and per head, the two routes equal "
        f"bit for bit)")
    for shape in (SSD_TRAIN_SHAPE, SSD_BWD_SHAPES[-1], SSD_BWD_SHAPES[3]):
        for per_head in (False, True):
            log(f"  bf16 {shape}{' per head' if per_head else ''} rows "
                f"(RMS / worst): " + ", ".join(
                    f"{k} {r[0]:.3e} / {r[1]:.3e}"
                    for k, r in worst_rows[shape, per_head].items()))

    # the phases one at a time at mamba2's train shape, bf16, and the
    # planted faults between and after them
    shape = SSD_TRAIN_SHAPE
    b, s, h, p, n, chunk = shape
    leaves, dy, dhf = ssd_grad_case(b, s, h, p, n, bf16, seed=3)
    views = ssd_views(*leaves, h, p, n)
    want = ssd_grads(ssd_scan_ref, [t.float() for t in leaves], dy.float(),
                     dhf, shape)

    def parts(grads):
        dx, ddt, da, db, dc = grads
        return {"dx": dx, "dB": db.float().sum(2), "dC": dc.float().sum(2),
                "ddt": ddt, "da": da}
    scratch = ssd_ops.ssd_bwd_states(*views, dy, dhf, chunk=chunk)
    cb = ssd_ops.ssd_bwd_cb(*views, dy, scratch, chunk=chunk)
    cb_want = ssd_cb_ref(*views[3:], chunk=chunk)
    cb_err = (cb.tril() - cb_want).abs().max().item()
    if cb.shape != cb_want.shape or \
            cb_err > 1e-4 * cb_want.abs().max().item():
        raise AssertionError(f"ssd_bwd_cb {tuple(cb.shape)}: max |err| "
                             f"{cb_err:.3e} against the plain C B^T")
    clean = parts(ssd_ops.ssd_bwd_grads(*views, dy, scratch, chunk=chunk))
    rows = grads_rows(clean, want)
    if rows_rejected(rows):
        raise AssertionError(f"ssd_scan_bwd phases one by one: {rows}")
    log(f"ssd_scan_bwd phases one by one ({shape} bf16): C B^T "
        f"{tuple(cb.shape)} max |err| {cb_err:.3e} against ssd_cb_ref; "
        f"rows " + ", ".join(f"{k} {r[0]:.3e} / {r[1]:.3e}"
                             for k, r in rows.items()))
    kept = cb[:, 1, :, 64:128, 64:128].clone()  # chunk 1's 2nd diagonal tile
    cb[:, 1, :, 64:128, 64:128] = 0
    tile = parts(ssd_ops.ssd_bwd_grads(*views, dy, scratch, chunk=chunk))
    cb[:, 1, :, 64:128, 64:128] = kept
    scratch["dstate"][:, :, :-1] = 0
    dropped = parts(ssd_ops.ssd_bwd_grads(*views, dy, scratch, chunk=chunk))
    zeroed = dict(clean, dB=clean["dB"].clone())
    zeroed["dB"][:, chunk:2 * chunk] = 0
    faults = {"the carried state's gradient dropped": dropped,
              "chunk 1's dB zeroed": zeroed,
              f"dB times the group's {h} heads": dict(clean,
                                                      dB=clean["dB"] * h),
              "one tile pair of the C B^T scratch zeroed": tile}
    for fault, grads in faults.items():
        frows = grads_rows(grads, want)
        log(f"ssd_scan_bwd planted fault ({fault}, {shape} bf16): rows "
            + ", ".join(f"{k} {r[0]:.3e} / {r[1]:.3e}"
                        for k, r in frows.items())
            + f"; rejected by {rows_rejected(frows)}")
        if not rows_rejected(frows):
            raise AssertionError(f"ssd_scan_bwd: the row check does not "
                                 f"reject the planted fault ({fault})")
    del scratch, clean, dropped, zeroed, tile, faults, want, cb, cb_want, kept

    # times, bf16, in the model's layout as training calls it (no
    # dh_final: the train step does not use h_final)
    out = []
    for shape in (SSD_TRAIN_SHAPE, SSD_BWD_SHAPES[-1]):
        b, s, h, p, n, chunk = shape
        leaves, dy, _ = ssd_grad_case(b, s, h, p, n, bf16, seed=3)
        args = ssd_views(*leaves, h, p, n)
        plan = ssd_ops.bwd_plan(*args[:1], *args[3:], chunk=chunk)
        few = [k for k in ("states", "rows", "cols")
               if plan[k]["blocks"] < 132]
        if few or (p, n) == (64, 128) and min(
                plan["rows"]["per_sm"], plan["cols"]["per_sm"]) < 2:
            raise AssertionError(f"ssd_scan_bwd {shape}: launches "
                                 f"{ssd_bwd_plan_text(plan)}")
        k_ms = time_ms(lambda: ssd_scan_bwd(*args, dy, chunk=chunk), iters=5)
        k_dev = device_ms(lambda: ssd_scan_bwd(*args, dy, chunk=chunk),
                          iters=5, per_call=6, lead=4)
        p_ms = time_ms(lambda: ssd_scan_bwd_ref(*args, dy, chunk=chunk),
                       iters=2, warmup=1, reps=3)
        # read once: x, dy (bf16), dt, a, B and C once per group; written
        # once: dx, ddt, da and the group's dB and dC (the kernel writes
        # them per head, logged beside).  Products on the lower triangle
        # where masked: dY X^T (P), Z B, Z^T C (N), M^T dY (P) per head and
        # C B^T (N) once per group (one here); whole: dY h_prev, X D,
        # B D^T and the chunk states S_c, E_c (P N each)
        nbytes = (2 * b * s * h * p * 2 + b * s * h * 4 + h * 4
                  + 2 * b * s * n * 2 + b * s * h * p * 2 + b * s * h * 4
                  + h * 4 + 2 * b * s * n * 2)
        head_bytes = 2 * b * s * (h - 1) * n * 2
        flops = 0
        for c0 in range(0, s, chunk):
            q = min(chunk, s - c0)
            tri = q * (q + 1) // 2
            flops += 2 * b * (h * (tri * (2 * n + 2 * p) + 5 * q * p * n)
                              + tri * n)
        bound = max(nbytes / HBM_BPS, flops / BF16_FLOPS) * 1e3
        bound_by = "bytes" if nbytes / HBM_BPS >= flops / BF16_FLOPS \
            else "operations"
        log(f"ssd_scan_bwd {shape} bf16 (model layout, no dh_final): "
            f"kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} (autograd through "
            f"the plain scan) library_ms none (no single PyTorch call "
            f"computes it) bound_ms {bound:.4f} ({bound_by}: {nbytes} B, "
            f"{flops} FLOP; per-head dB and dC add {head_bytes} B); device "
            f"time alone (profiler, six launches) {ms_text(k_dev)}; "
            f"launches: {ssd_bwd_plan_text(plan)}")
        out.append({"name": "ssd_scan_bwd", "route": "cuda",
                    "source": "src/repro_torch/csrc/ssd_chunk_bwd.cu",
                    "replaces": "src/repro/models/ssm.py:60",
                    "shape": f"{shape} bf16", "device_ms": k_dev,
                    "max_abs_err": abs_err[shape, False],
                    "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                    "bound_by": bound_by, "library_ms": None})
    return out[0]           # mamba2's train microbatch: the train phase's


# ---------------------------------------------------------- flash attention
def row_rel(got, want):
    """Per output row (the last axis): ||got - want|| / ||want||, rows with
    ``want`` all zero left out.  Returns (RMS over rows, worst row)."""
    g, w = got.float(), want.float()
    n2 = w.square().sum(-1)
    live = n2 > 0
    r = (g - w).square().sum(-1)[live] / n2[live]
    return r.mean().sqrt().item(), r.max().sqrt().item()


def rows_close(got, want, what, tol=ROW_TOL):
    rms, worst = row_rel(got, want)
    if rms > tol["rms"] or worst > tol["worst"]:
        raise AssertionError(
            f"{what}: kernel vs plain row error RMS {rms:.3e} / worst "
            f"{worst:.3e} outside {tol}")
    return rms, worst


def flash_case(b, sq, sk, h, hkv, d, dtype, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def t(shape):
        return torch.tensor(rng.standard_normal(shape, np.float32),
                            device="cuda").to(dtype)
    return t((b, sq, h, d)), t((b, sk, hkv, d)), t((b, sk, hkv, d))


def flash_pairs(sq, sk, causal, window):
    """(query, key) pairs the mask leaves: the work of one head."""
    import numpy as np

    i = np.arange(sq)
    hi = np.minimum(i, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(sq, int)
    return int(np.maximum(0, hi - lo + 1).sum())


def check_flash():
    import torch

    from repro_torch.kernels import flash_attention as kern
    from repro_torch.kernels import flash_attention_ref as plain

    f32, bf16 = torch.float32, torch.bfloat16
    n = 0
    rows_err = {}

    def both(shape, dt, what, seed=0, **kw):
        args = flash_case(*shape, dt, seed)
        got, want = kern(*args, **kw), plain(*args, **kw)
        err = close(got, want, dt, what)
        if dt == bf16:
            rows_err[what] = rows_close(got, want, what)
        return err, args

    # the reference's grid (tests/test_kernels.py:26-77) in both dtypes,
    # lengths no multiple of a tile, the registry's group sizes, windows,
    # non-causal
    for dt in (f32, bf16):
        for shape in [(1, 128, 128, 2, 2, 64), (2, 256, 256, 4, 1, 64),
                      (1, 128, 256, 8, 2, 128), (1, 64, 64, 2, 2, 32),
                      (2, 100, 100, 4, 2, 64), (1, 300, 300, 6, 1, 128)]:
            both(shape, dt, f"flash grid {shape} {dt}")
            n += 1
        for g in (1, 2, 4, 5, 6, 8, 12):
            both((2, 130, 130, 2 * g, 2, 64), dt, f"flash group {g} {dt}",
                 seed=g, window=40)
            n += 1
        for w in (1, 16, 100):
            both((2, 300, 300, 8, 2, 128), dt, f"flash window {w} {dt}",
                 window=w)
            n += 1
        for w in (None, 30):
            both((2, 64, 128, 4, 2, 64), dt, f"flash non-causal w {w} {dt}",
                 causal=False, window=w)
            n += 1
        # Sq > Sk + window - 1: rows past Sk + window - 2 see no key
        _, args = both((1, 200, 40, 4, 2, 32), dt, f"flash dead rows {dt}",
                       window=16)
        dead = kern(*args, window=16)[:, 40 + 16 - 1:]
        if not torch.equal(dead, torch.zeros_like(dead)):
            raise AssertionError("flash: rows with no valid key are not 0")
        n += 1
    # f32 at the tiny configs' head dim 16 (the examples' and the CLIs'
    # --tiny prefill on the card): 4 / 4 heads, odd lengths, a window
    for shape, w in (((2, 24, 24, 4, 4, 16), None),
                     ((1, 300, 300, 4, 2, 16), 40)):
        both(shape, f32, f"flash tiny D 16 {shape} w {w}", window=w)
        n += 1
    # the serve paths' prefill shapes: qwen2.5-14b (1 x 2048 and 16 x 512,
    # causal, 40 / 8 heads), mixtral-8x7b (1 x 8192, window 4096, 32 / 8),
    # musicgen-large (1 x 2048, MHA 32 / 32 heads of 64: the cp.async
    # mma.sync path) and internvl2-2b (1 x 2304: 256 patches + 2048 text
    # tokens, 16 / 8 heads of 128)
    serve = {"qwen 1x2048": ((1, 2048, 2048, 40, 8, 128), None),
             "qwen 16x512": ((16, 512, 512, 40, 8, 128), None),
             "mixtral 1x8192": ((1, 8192, 8192, 32, 8, 128), 4096),
             "musicgen 1x2048": ((1, 2048, 2048, 32, 32, 64), None),
             "internvl2 1x2304": ((1, 2304, 2304, 16, 8, 128), None)}
    errs = {}
    for name, (shape, w) in serve.items():
        for dt in (f32, bf16):
            errs[(name, dt)], _ = both(shape, dt, f"flash {name} {dt}",
                                       window=w)
            n += 1
            torch.cuda.empty_cache()
    worst = max(rows_err, key=lambda k: rows_err[k][0])
    log(f"flash_attention: {n} cases match the plain version (f32 "
        f"rtol/atol 2e-5, bf16 2e-2 and row error {ROW_TOL}); serve "
        "shapes max|err| " + ", ".join(f"{k} {str(dt)[6:]} {e:.3e}"
                                       for (k, dt), e in errs.items())
        + "; bf16 row error RMS / worst: " + ", ".join(
            f"{k} {rows_err[f'flash {k} {bf16}'][0]:.3e} / "
            f"{rows_err[f'flash {k} {bf16}'][1]:.3e}" for k in serve)
        + f"; largest RMS of all bf16 cases {rows_err[worst][0]:.3e} "
        f"({worst})")

    # planted kernel fault: mixtral's window one 64-key tile short, as a
    # kernel whose window bound is off by a tile would compute it.  The
    # row check must reject it; what the elementwise bf16 tolerance says
    # of it is logged.
    q, k, v = flash_case(1, 8192, 8192, 32, 8, 128, bf16, 0)
    got, want = kern(q, k, v, window=4096 - 64), plain(q, k, v, window=4096)
    rms, worst = row_rel(got, want)
    elementwise = torch.allclose(got.float(), want.float(), **TOL["bfloat16"])
    log(f"flash planted fault (window one tile short, mixtral 1x8192): row "
        f"error RMS {rms:.3e} / worst {worst:.3e}; elementwise bf16 "
        f"tolerance alone {'passes' if elementwise else 'rejects'} it")
    if rms <= ROW_TOL["rms"] and worst <= ROW_TOL["worst"]:
        raise AssertionError("flash: the row check does not reject the "
                             "planted fault (window one tile short)")
    del q, k, v, got, want
    # planted at the frontends' shapes: every query head reads the next KV
    # head (rows mixed up); the row check must reject it
    for name in ("musicgen 1x2048", "internvl2 1x2304"):
        q, k, v = flash_case(*serve[name][0], bf16, 0)
        planted_rows("flash_attention", name, {
            "rows mixed up (each head reads the next KV head)":
            (kern(q, k.roll(1, dims=2).contiguous(),
                  v.roll(1, dims=2).contiguous()), ROW_TOL)},
            plain(q, k, v), TOL["bfloat16"])
        del q, k, v
    torch.cuda.empty_cache()

    rows = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, (shape, w) in serve.items():
        b, sq, sk, h, hkv, d = shape
        q, k, v = flash_case(*shape, bf16, seed=0)
        k_ms = time_ms(lambda: kern(q, k, v, window=w))
        p_ms = time_ms(lambda: plain(q, k, v, window=w), iters=2, warmup=1,
                       reps=3)
        torch.cuda.empty_cache()
        # library yardstick: SDPA on (B, H, S, D) views, GQA expanded by
        # the call; the window as an explicit boolean mask (the port never
        # calls SDPA)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        if w is None:
            def library():
                return sdpa(qh, kh, vh, is_causal=True, enable_gqa=hkv != h)
        else:
            i = torch.arange(sq, device="cuda")[:, None]
            j = torch.arange(sk, device="cuda")[None, :]
            mask = (j <= i) & (j > i - w)

            def library():
                return sdpa(qh, kh, vh, attn_mask=mask, enable_gqa=True)
        l_ms = time_ms(library)
        # the device time alone, of the kernel and of SDPA (profiler; 8
        # calls after 8 inside the trace, which may miss the first few)
        k_dev = device_ms(lambda: kern(q, k, v, window=w), iters=8,
                          per_call=1, lead=8)
        l_dev = device_ms(library, iters=8, lead=8)
        del library
        pairs = flash_pairs(sq, sk, True, w)
        flops = 4 * b * h * pairs * d
        nbytes = 2 * (2 * b * sq * h * d + 2 * b * sk * hkv * d)
        bound = max(nbytes / HBM_BPS, flops / BF16_FLOPS) * 1e3
        bound_by = "bytes" if nbytes / HBM_BPS >= flops / BF16_FLOPS \
            else "operations"
        log(f"flash_attention {name} bf16 (H {h}/{hkv}, D {d}, window {w}): "
            f"max_err {errs[(name, bf16)]:.3e} kernel_ms {k_ms:.4f} "
            f"plain_ms {p_ms:.4f} library_ms {l_ms:.4f} bound_ms "
            f"{bound:.4f} ({bound_by}: {flops} FLOP over {pairs} pairs per "
            f"head, {nbytes} B; f32 CUDA-core floor "
            f"{flops / F32_FLOPS * 1e3:.4f} ms); {flops / k_ms / 1e9:.1f} "
            f"TFLOP/s; device time alone (profiler): kernel "
            f"{ms_text(k_dev)} library {ms_text(l_dev)}")
        rows.append({"name": "flash_attention", "shape": name,
                     "route": "cuda", "device_ms": k_dev,
                     "library_device_ms": l_dev,
                     "source": "src/repro_torch/csrc/flash_attention.cu",
                     "replaces":
                         "src/repro/kernels/flash_attention/kernel.py:106",
                     "max_abs_err": errs[(name, bf16)], "ms": k_ms,
                     "plain_ms": p_ms, "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": l_ms})
        del q, k, v
        torch.cuda.empty_cache()
    return rows             # one row per serve shape


def check_tp_kernels():
    """Each serve kernel at the local shapes a rank of the TP section's
    two-rank legs hands it, held against its plain version in bf16 row by
    row (``ROW_TOL``; the SSD scan ``SSD_ROW_TOL`` against the plain
    version in f32) and timed beside its bound: the paged GQA decode at
    qwen2.5-14b's 20 / 4 heads, the paged MLA decode at minicpm3-4b's 20
    heads (a partial head tile of 16 + 4), flash attention at qwen's 20 /
    4 heads (1 x 2048), the SSD scan at mamba2-780m's 24 of 48 heads (B
    and C one group, stride 0), and RMSNorm's given-statistic entry at
    mamba2's gated norm (d_inner / 2 = 1536 of 3072 per rank, 2048
    rows).  The three attention kernels are also timed against SDPA on
    the same inputs, as at their single-device shapes; the SSD scan and
    a norm given its statistic have no PyTorch call of their own.  Rows
    of the ``kernels`` line with a ``shape`` key."""
    import torch

    from repro_torch.kernels import (flash_attention, flash_attention_ref,
                                     paged_decode_attention,
                                     paged_decode_attention_ref,
                                     paged_mla_decode_attention,
                                     paged_mla_decode_attention_ref,
                                     rms_norm_rstd, rms_norm_rstd_ref,
                                     ssd_scan, ssd_scan_ref)

    bf16 = torch.bfloat16
    rows = []

    sdpa = torch.nn.functional.scaled_dot_product_attention

    def row(name, shape, source, replaces, err, k_ms, p_ms, k_dev, nbytes,
            flops, peak, library=None, n_rot=1):
        """``library``: one PyTorch call computing the same function on
        the same inputs (timed here, used nowhere in the port), or None
        where there is none; ``n_rot``: the rotating copies of its inputs
        the kernel was timed over (``rotated``)."""
        l_ms = l_dev = None
        if library is not None:
            l_ms = time_ms(library)
            l_dev = device_ms(library, iters=8, lead=8)
        bound = max(nbytes / HBM_BPS, flops / peak) * 1e3
        bound_by = "bytes" if nbytes / HBM_BPS >= flops / peak \
            else "operations"
        lib_text = ("none" if l_ms is None else
                    f"{l_ms:.4f} (device alone {ms_text(l_dev)})")
        log(f"{name} [{shape}] bf16: max_err {err:.3e} kernel_ms "
            f"{k_ms:.4f} plain_ms {p_ms:.4f} library_ms {lib_text} "
            f"bound_ms {bound:.4f} ({bound_by}: {nbytes} B, {flops} FLOP); "
            f"device time alone (profiler) {ms_text(k_dev)}"
            + (f"; timed over {n_rot} rotating copies of its inputs"
               if n_rot > 1 else ""))
        rows.append({"name": name, "shape": shape, "route": (
            "triton" if name == "rms_norm" else "cuda"), "device_ms": k_dev,
            "library_device_ms": l_dev,
            "source": source, "replaces": replaces, "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": l_ms})

    # paged GQA decode, qwen2.5-14b's 16 slots at 20 / 4 heads per rank
    shape = (16, 20, 4, 128, 2080, 8)
    args, kw = paged_case(*shape, bf16, seed=1, pos=decode_pos())
    got, want = paged_decode_attention(*args, **kw), \
        paged_decode_attention_ref(*args, **kw)
    err = close(got, want, bf16, "paged_decode 2 ranks")
    rows_close(got, want, "paged_decode 2 ranks")
    q, kp, vp, table, pos = args
    live = int((pos.long() + 1).sum().item())
    # library yardstick, as ``paged_decode_row``'s: SDPA (GQA) over K/V
    # gathered dense beforehand (the gather is not timed)
    kd = kp[table.long()].reshape(16, -1, 4, 128).transpose(1, 2)
    vd = vp[table.long()].reshape(16, -1, 4, 128).transpose(1, 2)
    mask = (torch.arange(kd.shape[2], device="cuda")[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    qh = q.transpose(1, 2)
    row("paged_decode_attention", "qwen 2 ranks (16 slots, 20/4 heads)",
        "src/repro_torch/csrc/paged_decode.cu",
        "src/repro/kernels/paged_attention/kernel.py:121", err,
        time_ms(lambda: paged_decode_attention(*args, **kw)),
        time_ms(lambda: paged_decode_attention_ref(*args, **kw), iters=5),
        device_ms(lambda: paged_decode_attention(*args, **kw), lead=8),
        live * 4 * 128 * 2 * 2 + 2 * q.numel() * 2 + table.numel() * 4
        + pos.numel() * 4, live * 20 * 128 * 2 * 2, BF16_FLOPS,
        lambda: sdpa(qh, kd, vd, attn_mask=mask, enable_gqa=True))
    del args, q, kp, vp, kd, vd, qh, got, want
    # paged MLA decode, minicpm3-4b's 20 of 40 query heads per rank
    args = mla_case(16, 20, 256, 32, 2080, 8, bf16, seed=12,
                    pos=decode_pos())
    kw = dict(page_size=8, scale=(64 + 32) ** -0.5)
    got, want = paged_mla_decode_attention(*args, **kw), \
        paged_mla_decode_attention_ref(*args, **kw)
    err = close(got, want, bf16, "paged_mla_decode 2 ranks")
    rows_close(got, want, "paged_mla_decode 2 ranks")
    ql, qr, cp, kp, table, pos = args
    live = int((pos.long() + 1).sum().item())
    nbytes = (live * (256 + 32) * 2 + (ql.numel() + qr.numel()) * 2
              + ql.numel() * 2 + table.numel() * 4 + pos.numel() * 4)
    rot, n_rot = rotated(lambda *a: paged_mla_decode_attention(*a, **kw),
                         args, nbytes)
    # library yardstick, as ``check_paged_mla``'s: SDPA over [ckv || krope]
    # keys and ckv values gathered dense beforehand, one kv head broadcast
    # to the 20 query heads (the gather is not timed)
    cd = cp[table.long()].reshape(16, 1, -1, 256)
    kd = torch.cat([cd, kp[table.long()].reshape(16, 1, -1, 32)], dim=-1)
    qh = torch.cat([ql, qr], dim=-1).transpose(1, 2)       # (16, 20, 1, 288)
    mask = (torch.arange(kd.shape[2], device="cuda")[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    row("paged_mla_decode_attention", "minicpm3 2 ranks (16 slots, 20 "
        "heads: tiles of 16 + 4)", "src/repro_torch/csrc/paged_mla_decode.cu",
        "src/repro/kernels/paged_attention/kernel.py:200", err,
        time_ms(rot),
        time_ms(lambda: paged_mla_decode_attention_ref(*args, **kw),
                iters=5),
        device_ms(rot, lead=8), nbytes,
        live * 20 * (256 + 32 + 256) * 2, BF16_FLOPS,
        lambda: sdpa(qh, kd, cd, attn_mask=mask, scale=kw["scale"],
                     enable_gqa=True), n_rot)
    del args, ql, qr, cp, kp, cd, kd, qh, got, want, rot
    # flash attention, qwen2.5-14b's prefill at 20 / 4 heads per rank
    q, k, v = flash_case(1, 2048, 2048, 20, 4, 128, bf16, seed=0)
    got, want = flash_attention(q, k, v), flash_attention_ref(q, k, v)
    err = close(got, want, bf16, "flash 2 ranks")
    rows_close(got, want, "flash 2 ranks")
    pairs = flash_pairs(2048, 2048, True, None)
    row("flash_attention", "qwen 2 ranks 1 x 2048 (20/4 heads)",
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:106", err,
        time_ms(lambda: flash_attention(q, k, v)),
        time_ms(lambda: flash_attention_ref(q, k, v), iters=2, warmup=1,
                reps=3),
        device_ms(lambda: flash_attention(q, k, v), iters=8, per_call=1,
                  lead=8),
        2 * (2 * 2048 * 20 * 128 + 2 * 2048 * 4 * 128),
        4 * 20 * pairs * 128, BF16_FLOPS,
        # library yardstick, as ``check_flash``'s: SDPA on (B, H, S, D)
        # views, causal, GQA expanded by the call
        lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                     is_causal=True, enable_gqa=True))
    del q, k, v, got, want
    # the SSD scan, mamba2-780m's prefill at 24 of 48 heads per rank
    args = ssd_model_layout(1, 2048, 24, 64, 128, bf16, seed=1)
    y, hf = ssd_scan(*args, chunk=256)
    x, dt, a, bmat, cmat = args
    yw, _ = ssd_scan_ref(x.float(), dt, a, bmat.float(), cmat.float(),
                         chunk=256)
    rows_close(y, yw, "ssd_scan 2 ranks", SSD_ROW_TOL)
    err = (y.float() - yw).abs().max().item()
    b, s, h, p, nn, qq = 1, 2048, 24, 64, 128, 256
    per_chunk = qq * (qq + 1) // 2 * (nn + p) + 2 * qq * p * nn
    row("ssd_scan", "mamba2 2 ranks 1 x 2048 (24 of 48 heads, B and C "
        "stride 0)", "src/repro_torch/csrc/ssd_chunk.cu",
        "src/repro/kernels/ssd_chunk/kernel.py:80", err,
        time_ms(lambda: ssd_scan(*args, chunk=256)),
        time_ms(lambda: ssd_scan_ref(*args, chunk=256), iters=2, warmup=1),
        device_ms(lambda: ssd_scan(*args, chunk=256), per_call=3, lead=8),
        (b * s * h * p * 2 + b * s * h * 4 + h * 4 + b * s * h * p * 2
         + b * h * p * nn * 4 + b * s * 2 * nn * 2),
        2 * b * h * (s // qq) * per_chunk, BF16_FLOPS)
    del args, x, y, yw
    # RMSNorm given each row's statistic: mamba2's gated norm per rank
    g = torch.Generator("cuda").manual_seed(4)
    x = torch.randn((2048, 1536), generator=g, device="cuda").to(bf16)
    w = (torch.randn(1536, generator=g, device="cuda") * 0.1 + 1).to(bf16)
    r = torch.rand(2048, generator=g, device="cuda") + 0.5
    got, want = rms_norm_rstd(x, w, r), rms_norm_rstd_ref(x, w, r)
    err = close(got, want, bf16, "rms_norm_rstd 2 ranks")
    rows_close(got, want, "rms_norm_rstd 2 ranks")
    nbytes = 2 * x.numel() * 2 + w.numel() * 2 + r.numel() * 4
    rot, n_rot = rotated(rms_norm_rstd, (x, w, r), nbytes)
    row("rms_norm", "mamba2 2 ranks gated norm (2048, 1536), given rstd",
        "src/repro_torch/kernels/rmsnorm/kernel.py",
        "src/repro/kernels/rmsnorm/kernel.py:27", err, time_ms(rot),
        time_ms(lambda: rms_norm_rstd_ref(x, w, r)),
        device_ms(rot, per_call=1, lead=8), nbytes, 2 * x.numel(),
        F32_FLOPS, n_rot=n_rot)
    del rot
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------- main path
def arch_of(cfg):
    """The phase's arch name (a ``tiny()`` config for a CPU rehearsal
    carries a suffix)."""
    return cfg.name.removesuffix("-tiny")


# the kind of layer each kernel runs in
KERNEL_KIND = {"paged_decode_attention": "attn", "flash_attention": "attn",
               "paged_mla_decode_attention": "attn", "ssd_scan": "ssm",
               "ssd_scan_bwd": "ssm"}


def kind_layers(cfg, kind):
    """Layers of ``kind`` ("attn" or "ssm") in the config's depth."""
    return cfg.n_repeats * sum(spec.kind == kind for spec in cfg.pattern)


def norm_sites(cfg):
    """RMSNorm launches of one pass through the blocks: per layer its
    mixer's norm (an MLA mixer also norms its q and kv latents, an SSD
    mixer its gated output) and its MLP's, if it has one."""
    return cfg.n_repeats * sum(
        1 + 2 * (spec.kind == "attn" and spec.attn == "mla")
        + (spec.kind == "ssm") + (spec.mlp != "none")
        for spec in cfg.pattern)


def frontend_shape(cfg):
    """(the codebook dim of a step's token, () unless audio; the patch
    positions in front of each prompt, 0 unless vision)."""
    extra = ((cfg.n_codebooks,) if cfg.frontend == "audio_codebooks"
             else ())
    return extra, (cfg.n_patches if cfg.frontend == "vision_patches" else 0)


def request_patches(cfg, n, device, seed):
    """``n`` requests' patch embeddings (n, n_patches, d_model) in the
    compute dtype, drawn on ``device`` from a seeded ``torch.Generator``
    at ``PATCH_STD``; None unless the config is vision's."""
    import torch

    if cfg.frontend != "vision_patches":
        return None
    g = torch.Generator(device).manual_seed(seed)
    return torch.randn((n, cfg.n_patches, cfg.d_model), generator=g,
                       device=device).mul_(PATCH_STD).to(
                           getattr(torch, cfg.dtype))


def steps_alone(cfg, params, smi, paged_kernel, traffic, ps=8,
                verify_k=None):
    """Where a tick's time goes: one decode tick of the phase's shapes
    (``traffic``'s slots, cache_len and prompt lengths) and one prefill of
    its longest prompt (behind the patches of a vision config), run alone
    (no engine, no other thread), host-timed around a synchronize, and
    each once more under torch.profiler for the device's busy time (the
    tick's by kernel).  With
    ``verify_k``: the same for one verify dispatch over the same live
    slots at S=1 and at S=verify_k+1 ("verify alone")."""
    import numpy as np
    import torch

    from repro_torch.steps import (init_paged_slot_cache, make_decode_step,
                                   make_prefill_step, make_verify_step)

    slots, cache_len = traffic["slots"], traffic["cache_len"]
    extra, n_patches = frontend_shape(cfg)
    rng = np.random.default_rng(5)
    pps = cache_len // ps
    num_pages = 1 + slots * pps
    cache = init_paged_slot_cache(cfg, slots, cache_len, torch.bfloat16, ps,
                                  num_pages, "cuda")
    pos = (rng.choice(traffic["lens"], slots) + n_patches
           + rng.integers(0, 31, slots))
    pos_dev = torch.tensor(pos.astype(np.int32), device="cuda")
    cache["pos"] = pos_dev.clone()
    table = torch.tensor(rng.permutation(np.arange(1, num_pages))
                         .reshape(slots, pps).astype(np.int32),
                         device="cuda")
    toks = torch.tensor(rng.integers(0, cfg.vocab, (slots, 1) + extra)
                        .astype(np.int32), device="cuda")
    active = torch.ones(slots, dtype=torch.bool, device="cuda")
    decode = make_decode_step(cfg, cache_len=cache_len, page_size=ps,
                              paged_kernel=paged_kernel)

    def tick():
        nonlocal cache
        _, cache = decode(params, cache, toks, active, table)
        cache["pos"] = pos_dev.clone()      # a device copy: no host sync

    def host_ms(fn, n):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e3

    def measured(fn):
        """Host ms over 5 calls; device busy ms and (kernel, ms, count)
        rows, largest first, from one more call under torch.profiler."""
        host = host_ms(fn, 5)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        by_name: dict = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                ms, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3,
                                   n + 1)
        rows = sorted(((k, ms, n) for k, (ms, n) in by_name.items()),
                      key=lambda r: -r[1])
        # one stream: kernels serialise
        return host, sum(r[1] for r in rows), rows

    tick_ms, busy, rows = measured(tick)
    verified, lane0 = [], []
    if verify_k:
        verify = make_verify_step(cfg, cache_len=cache_len, page_size=ps)
        # positions kept inside the table: pos + S <= cache_len
        vpos = torch.tensor(np.minimum(pos, cache_len - verify_k - 1)
                            .astype(np.int32), device="cuda")
        win = torch.tensor(rng.integers(0, cfg.vocab, (slots, verify_k + 1))
                           .astype(np.int32), device="cuda")
        for s in (1, verify_k + 1):
            n_tok = torch.full((slots,), s, dtype=torch.int32,
                               device="cuda")

            def one():
                return verify(params, cache, win[:, :s], vpos, n_tok, table)
            verified.append((s, *measured(one)))
            lane0.append(one()[0][:, 0])    # the same lane-0 token and pos
    del cache
    prefill = make_prefill_step(cfg, cache_len=cache_len)
    plen = max(traffic["lens"])
    ptoks = torch.tensor(rng.integers(0, cfg.vocab, (1, plen) + extra)
                         .astype(np.int32), device="cuda")
    patches = request_patches(cfg, 1, "cuda", seed=5)
    pre_ms, pre_busy, _ = measured(lambda: prefill(params, ptoks, patches))
    log(f"steps alone ({cfg.name}, {smi}): decode tick ({slots} slots"
        f"{', paged kernel' if paged_kernel else ''}) {tick_ms:.2f} ms "
        f"host; device busy {busy:.2f} ms in one profiled tick (idle "
        f"{max(0.0, 1 - busy / tick_ms) * 100:.0f} %); prefill (1 x "
        f"{n_patches + plen}{' with the patches' if n_patches else ''}) "
        f"{pre_ms:.2f} ms host; device busy {pre_busy:.2f} ms (idle "
        f"{max(0.0, 1 - pre_busy / pre_ms) * 100:.0f} %)")
    for key, ms, n in rows[:8]:
        log(f"  tick kernel {ms:8.3f} ms x{n:5d}  {key[:90]}")
    if lane0:
        log(f"verify alone ({cfg.name}): lane 0's argmax (the same token at "
            f"the same position) equal at S=1 and S={verify_k + 1} in "
            f"{int((lane0[0] == lane0[1]).sum())}/{slots} slots")
    for s, host, vbusy, vrows in verified:
        log(f"verify alone ({cfg.name}, {smi}): one verify dispatch, S={s} "
            f"over {slots} live slots, extent {cache_len} (gather path): "
            f"{host:.2f} ms host; device busy {vbusy:.2f} ms (idle "
            f"{max(0.0, 1 - vbusy / host) * 100:.0f} %); the decode tick "
            f"beside it {tick_ms:.2f} / {busy:.2f} ms")
        for key, ms, n in vrows[:8]:
            log(f"  verify S={s} kernel {ms:8.3f} ms x{n:5d}  {key[:90]}")


def prefix_steps_alone(cfg, params, smi, traffic, chunk, ps=8):
    """The hit path's two steps alone (no engine, no other thread): one
    gather of a prefix's pages into a row, and one ``chunk``-token chunk
    of the tail at the prefix's offset (extent bucket as the engine sets
    it, no LM head); host-timed around a synchronize over 3 calls, and
    the device's busy time per call in a ``torch.profiler`` trace of more
    calls (kernel time summed, as ``steps_alone`` reads a tick; the
    kernel count per call says whether the trace holds every launch), with
    the chunk's largest kernels."""
    import numpy as np
    import torch

    from repro_torch.steps import (init_paged_slot_cache,
                                   make_prefill_chunk_step,
                                   make_prefix_gather_step)

    cache_len, m = traffic["cache_len"], traffic["prefix_len"]
    pps = cache_len // ps
    pool = init_paged_slot_cache(cfg, 1, cache_len, torch.bfloat16, ps,
                                 1 + pps, "cuda")
    trow = torch.arange(1, pps + 1, dtype=torch.int32, device="cuda")
    trow[-(-m // ps):] = 0
    gather = make_prefix_gather_step(cfg, cache_len=cache_len, page_size=ps)
    step = make_prefill_chunk_step(cfg, cache_len)
    rows = gather(pool, trow, m)
    toks = torch.tensor(np.random.default_rng(6).integers(
        0, cfg.vocab, (1, chunk)).astype(np.int32), device="cuda")
    ext = min(cache_len, -(-(m + chunk) // chunk) * chunk)

    def one_gather():
        gather(pool, trow, m)

    def one_chunk():
        step(params, rows, toks, m, attn_extent=ext, want_logits=False)

    out, top = {}, {}
    for what, fn, n in (("gather", one_gather, 20), ("chunk", one_chunk, 3)):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t) / 3 * 1e3
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        for e in evs:
            ms, k = top.get((what, e.name), (0.0, 0))
            top[what, e.name] = (ms + e.time_range.elapsed_us() / 1e3 / n,
                                 k + 1)
        busy = sum(e.time_range.elapsed_us() for e in evs) / n / 1e3
        out[what] = (host, busy, len(evs) / n)
    log(f"prefix steps alone ({cfg.name}, {smi}): one gather of {m} tokens "
        f"({-(-m // ps)} pages of {ps}) {out['gather'][0]:.2f} ms host, "
        f"device busy {out['gather'][1]:.4f} ms ({out['gather'][2]:.0f} "
        f"kernels); one {chunk}-token chunk at offset {m} (extent {ext}, "
        f"no LM head) {out['chunk'][0]:.2f} ms host, device busy "
        f"{out['chunk'][1]:.3f} ms ({out['chunk'][2]:.0f} kernels)")
    for (what, key), (ms, k) in sorted(top.items(), key=lambda r: -r[1][0])[:8]:
        log(f"  {what} kernel {ms:8.3f} ms a call (x{k}) {key[:90]}")


def restore_alone(cfg, params, smi, traffic, chunk, n_out=16):
    """One restore of the phase's longest prompt with ``n_out`` tokens out,
    alone (no engine, no other thread), as the engine runs it: a
    prefill-replay of prompt + emitted[:-1] through ``chunk``-token chunks
    (the last with the LM head), or, where ``chunk`` is None (the config
    does not chunk exactly), decode-replay: the prompt's one-shot prefill
    and ``n_out - 1`` batch-1 serve steps.  Host-timed around a
    synchronize (median of 3), and the device's busy time in one profiled
    call (kernel time summed, as ``steps_alone`` reads a tick)."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.models.lm import init_cache
    from repro_torch.steps import (make_prefill_chunk_step,
                                   make_prefill_step, make_serve_step)

    cache_len, plen = traffic["cache_len"], max(traffic["lens"])
    n = plen + n_out - 1
    t = torch.tensor(np.random.default_rng(7).integers(
        0, cfg.vocab, (1, n)).astype(np.int32), device="cuda")
    if chunk is None:
        prefill = make_prefill_step(cfg, cache_len=cache_len)
        step = make_serve_step(cfg)
        what = (f"decode-replay: prefill 1 x {plen} + {n_out - 1} serve "
                "steps")

        def one():
            rows, _ = prefill(params, t[:, :plen])
            for k in range(plen, n):
                _, rows = step(params, rows, t[:, k:k + 1])
    else:
        step = make_prefill_chunk_step(cfg, cache_len)
        what = f"prefill-replay: {n} tokens in chunks of {chunk}"

        def one():
            rows, c0 = init_cache(cfg, 1, cache_len, torch.bfloat16,
                                  "cuda"), 0
            while c0 < n:
                c1 = min(c0 + chunk, n)
                rows, _ = step(params, rows, t[:, c0:c1], c0,
                               attn_extent=min(cache_len,
                                               -(-c1 // chunk) * chunk),
                               want_logits=c1 == n)
                c0 = c1

    one()
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        one()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in evs) / 1e3
    log(f"restore alone ({cfg.name}, {smi}): {what}: "
        f"{statistics.median(host):.2f} ms host, device busy {busy:.3f} ms "
        f"({len(evs)} kernels)")


def plain_ssd(x, dt, a, bmat, cmat, *, chunk):
    """The reference model's own SSD math (``ssd_chunked``, state carried
    in the activation dtype from a zero state) in place of the kernel."""
    import torch

    from repro_torch.models.ssm import ssd_chunked

    b, _, h, p = x.shape
    init = torch.zeros((b, h, p, bmat.shape[-1]), dtype=x.dtype,
                       device=x.device)
    return ssd_chunked(x, dt, a, bmat, cmat, chunk, init)


@contextlib.contextmanager
def swapped(*swaps):
    """Module attributes swapped for the block: (module, name, value)."""
    saved = [(m, k, getattr(m, k)) for m, k, _ in swaps]
    for m, k, v in swaps:
        setattr(m, k, v)
    try:
        yield
    finally:
        for m, k, v in saved:
            setattr(m, k, v)


def planted(fault, cfg=None):
    """The path with one fault of ``PLANTED`` swapped into its module
    (``None``: as it is); ``cfg`` gives the frontends' faults their
    patch count."""
    import torch

    from repro_torch import steps
    from repro_torch.models import attention as att
    from repro_torch.models import blocks, lm, moe, ssm

    rope, kern, mla = (att.apply_rope, att.paged_decode_attention,
                       att.paged_mla_decode_attention)
    from repro_torch.serve import engine

    scan, ssm_apply = ssm.ssd_scan, blocks.ssm_apply
    flash, route = att.flash_attention, moe.route
    scatter_window, verify = att.page_scatter_window, att.verify_attention

    def rope_pos_plus_1(x, pos, theta=10_000.0):
        return rope(x, pos + 1, theta)

    def kv_group_order(q, kp, vp, table, pos, **kw):
        # flat head h reads kv head h % Hkv instead of h // group
        b, _, h, dh = q.shape
        g = h // kp.shape[2]
        qs = q.view(b, 1, g, h // g, dh).transpose(2, 3).reshape(q.shape)
        o = kern(qs.contiguous(), kp, vp, table, pos, **kw)
        return o.view(b, 1, h // g, g, dh).transpose(2, 3).reshape(q.shape)

    def pos_fault(fn, shift):
        def wrapped(*args, **kw):
            *front, pos = args
            return fn(*front, shift(pos), **kw)
        return wrapped

    def q_rope_next_head(q_lat, q_rope, *args, **kw):
        # head h scores with the rope query of head h + 1
        return mla(q_lat, q_rope.roll(-1, dims=2).contiguous(), *args, **kw)

    def state_not_handed(*args, **kw):
        y, hf = scan(*args, **kw)
        return y, torch.zeros_like(hf)

    def dt_one_late(x, dt, *args, **kw):
        return scan(x, torch.cat([dt[:, :1], dt[:, :-1]], 1), *args, **kw)

    def conv_tail_rolled(x, p, cfg, spec, *, mode, cache=None, **kw):
        if mode == "decode":
            cache["conv"].copy_(cache["conv"].roll(1, dims=1))
        return ssm_apply(x, p, cfg, spec, mode=mode, cache=cache, **kw)

    def flash_kv_group_order(q, k, v, **kw):
        # flat head h reads kv head h % Hkv instead of h // group
        b, s, h, d = q.shape
        g = h // k.shape[2]
        qs = q.view(b, s, g, h // g, d).transpose(2, 3).reshape(q.shape)
        o = flash(qs.contiguous(), k, v, **kw)
        return o.view(b, s, h // g, g, d).transpose(2, 3).reshape(q.shape)

    def moe_second_pick_dropped(*args, **kw):
        topv, topi, lb = route(*args, **kw)
        return topv * torch.tensor([1.0, 0.0], device=topv.device), topi, lb

    def moe_ids_permuted(xn, router, cfg, aux=True, data=None):
        # each pick goes to the next expert, with its own weight
        topv, topi, lb = route(xn, router, cfg, aux, data)
        return topv, (topi + 1) % cfg.n_experts, lb

    def ring_not_rolled(t, ring):
        # the reference's placement: the last ring positions unrolled
        return t[:, t.shape[1] - ring:]

    def window_late(pool, table, ps, pos, update, n_tok):
        return scatter_window(pool, table, ps, pos + 1, update, n_tok)

    def mask_dropped(q, k, v, pos, **kw):
        # lane j's mask ends at pos + j + 1: it sees lane j + 1
        return verify(q, k, v, pos + 1, **kw)

    def commits_drafts(draft, argmax):
        return len(draft), list(draft) + [int(argmax[len(draft)])]

    gqa, fwd = att.gqa_apply, steps.forward
    embed, sinusoid, logits = lm.embed_tokens, lm.sinusoidal_pos, \
        lm.lm_logits

    def patches_dropped(params, cfg_, tokens, *, mode="train", patches=None,
                        **kw):
        # the prefill step's forward: the text alone, at positions past
        # the patches, into a row cache whose patch rows stay empty
        if mode != "prefill" or patches is None:
            return fwd(params, cfg_, tokens, mode=mode, patches=patches, **kw)
        rows = lm.init_cache(cfg_, tokens.shape[0], kw["cache_len"],
                             getattr(torch, cfg_.dtype), tokens.device)
        return fwd(params, cfg_, tokens, mode="prefill_chunk",
                   pos=patches.shape[1], cache=rows,
                   cache_len=kw["cache_len"])

    def text_pos_restarts(x, p, cfg_, spec, *, mode, pos, **kw):
        if mode == "decode":
            # (a padding slot's position 0 stays in the table)
            pos = (pos - cfg.n_patches).clamp_min(0)
        return gqa(x, p, cfg_, spec, mode=mode, pos=pos, **kw)

    def codebook_dropped(tokens, p_embed, cfg_, dtype):
        return embed(tokens, p_embed,
                     cfg_.replace(n_codebooks=cfg_.n_codebooks - 1), dtype)

    def sinusoid_pos_plus_1(pos, dim, device=None):
        return sinusoid(torch.as_tensor(pos, device=device) + 1, dim)

    def codebook_heads_rolled(x, params, cfg_):
        return logits(x, params, cfg_).roll(-1, dims=2)

    def in_one_layer(fault, orig, kind):
        """``fault`` in the first layer of ``kind`` of every pass through
        the blocks (its first of each n calls), ``orig`` in the others."""
        every, calls = max(1, kind_layers(cfg, kind)) if cfg else 1, [0]

        def run(*args, **kw):
            k = calls[0] % every
            calls[0] += 1
            return (fault if k == 0 else orig)(*args, **kw)
        return run

    def roll(pos):
        return pos.roll(1)

    def older(pos):
        return pos - 1

    swaps = {
        None: (),
        "rope_pos_plus_1": ((att, "apply_rope", rope_pos_plus_1),),
        "kv_group_order": ((att, "paged_decode_attention", kv_group_order),),
        "slot_pos_rolled": ((att, "paged_decode_attention",
                             pos_fault(kern, roll)),
                            (att, "paged_mla_decode_attention",
                             pos_fault(mla, roll))),
        "newest_kv_left_out": ((att, "paged_decode_attention",
                                pos_fault(kern, older)),
                               (att, "paged_mla_decode_attention",
                                pos_fault(mla, older))),
        "q_rope_next_head": ((att, "paged_mla_decode_attention",
                              q_rope_next_head),),
        "state_not_handed": ((ssm, "ssd_scan", state_not_handed),),
        "ssm_layer_state_not_handed": ((ssm, "ssd_scan", in_one_layer(
            state_not_handed, scan, "ssm")),),
        "attn_layer_kv_group_order": ((att, "paged_decode_attention",
                                       in_one_layer(kv_group_order, kern,
                                                    "attn")),),
        "dt_one_late": ((ssm, "ssd_scan", dt_one_late),),
        "conv_tail_rolled": ((blocks, "ssm_apply", conv_tail_rolled),),
        "flash_kv_group_order": ((att, "flash_attention",
                                  flash_kv_group_order),),
        "moe_second_pick_dropped": ((moe, "route", moe_second_pick_dropped),),
        "moe_ids_permuted": ((moe, "route", moe_ids_permuted),),
        "ring_not_rolled": ((att, "ring_from_prefill", ring_not_rolled),),
        "window_late": ((att, "page_scatter_window", window_late),),
        "mask_dropped": ((att, "verify_attention", mask_dropped),),
        "commits_drafts": ((engine, "accept_window", commits_drafts),),
        "patches_dropped": ((steps, "forward", patches_dropped),),
        "text_pos_restarts": ((att, "gqa_apply", text_pos_restarts),),
        "codebook_dropped": ((lm, "embed_tokens", codebook_dropped),),
        "sinusoid_pos_plus_1": ((lm, "sinusoidal_pos",
                                 sinusoid_pos_plus_1),),
        "codebook_heads_rolled": ((lm, "lm_logits", codebook_heads_rolled),),
    }
    return swapped(*swaps[fault])


def path_check(cfg, params, prompts, toks, ref, device, paged_kernel,
               slots=16, cache_len=2080, ps=8, names=None, phase=None,
               plan=None, chunk=512, evictions=None, replay=False,
               patches=None):
    """The engine's step path teacher-forced with its emitted tokens: each
    prompt through the prefill step and the paged insert, then the tokens
    one tick at a time through the decode forward (paged kernel where the
    phase has one), ``slots`` requests per round — as built and under each
    planted fault of ``phase`` (a fault of the prefill side gets its own
    prefill), or under ``names`` only.  ``plan`` (the prefix phases): per
    request (source request, matched tokens), or (None, 0) for a cold
    prompt; each prompt is chunk-prefilled in ``chunk``-token chunks, and
    a hit takes the engine's hit path: gather of its source's pages (the
    fork page included), the tail's chunks from the matched offset, an
    insert with the shared pages masked; its table row then starts with
    its source's pages.  Returns name -> {"rel": aggregate relative logit
    error against ``ref``, "rel_max": worst position, "effect": the same
    distance from the path as built, "gap": worst gap of the path's
    argmax under ``ref``, "same": path argmax equal to the emitted token}
    ({} when ``ref`` is None: the path only runs).

    ``evictions`` (the on-demand phases): per request, the numbers of
    tokens it had out when the engine evicted it.  Admission then writes
    only the pages of the prompt, the table grows a page as a slot's
    write position crosses into it, and before the tick that follows an
    eviction the request is restored as the engine restores it, onto the
    slot's other set of pages: prompt + emitted[:-1] through
    ``chunk``-token chunks, or (``replay``) the prompt's prefill and the
    emitted tokens through the serve step one at a time.  (The engine's
    restore may re-hit the trie and chunk its tail only; here it is
    computed whole.)

    The frontends (cold phases only): ``patches`` (vision), per request
    its (n_patches, d_model) embeddings, ride its prefill, and its decode
    positions start past them; an audio step is fed (K,) codes and its
    logits are (K, V) a position, each codebook a row of the checks."""
    import numpy as np
    import torch

    from repro_torch.models.lm import forward, init_cache
    from repro_torch.steps import (cast_tree, init_paged_slot_cache,
                                   make_batched_insert_step,
                                   make_prefill_chunk_step,
                                   make_prefill_step,
                                   make_prefix_gather_step, make_serve_step)

    p = cast_tree(params, cfg.dtype)
    dt = getattr(torch, cfg.dtype)
    insert = make_batched_insert_step(cfg, cache_len=cache_len, page_size=ps)
    pps = cache_len // ps
    g = torch.Generator().manual_seed(3)
    if plan is None:
        prefill = make_prefill_step(cfg, cache_len=cache_len)
        n_rows = slots * (1 if evictions is None else 2)
        num_pages = 1 + n_rows * pps
        rows_of = (1 + torch.randperm(n_rows * pps, generator=g)).int().view(
            n_rows, pps)
        if evictions is not None:
            restore_step = (make_serve_step(cfg) if replay
                            else make_prefill_chunk_step(cfg, cache_len))
    else:
        chunk_step = make_prefill_chunk_step(cfg, cache_len)
        gather = make_prefix_gather_step(cfg, cache_len=cache_len,
                                         page_size=ps)
        shared = [m // ps if src is not None else 0 for src, m in plan]
        num_pages = 1 + sum(pps - k for k in shared)
        perm = (1 + torch.randperm(num_pages - 1, generator=g)).int()
        rows_of, k0 = [], 0
        for (src, _), k in zip(plan, shared):
            own = perm[k0:k0 + pps - k]
            k0 += pps - k
            rows_of.append(own if src is None
                           else torch.cat([rows_of[src][:k], own]))
    cache = init_paged_slot_cache(cfg, slots, cache_len, dt, ps, num_pages,
                                  device)
    if names is None:
        names = [None, *PLANTED[phase or arch_of(cfg)]]
    acc = {n: new_tally() for n in names}
    gen = len(toks[0])
    extra, n_patches = frontend_shape(cfg)

    def zero_page(rows, k):
        for blk in rows["blocks"]:
            for leaf in blk.values():
                leaf[:, :, k * ps:(k + 1) * ps] = 0

    def chunked_round(idx, fault):
        """The prefix phases' prefill side, request by request (a hit
        gathers pages an earlier request of the round inserted)."""
        nonlocal cache
        firsts = []
        for s, i in enumerate(idx):
            src, m = plan[i]
            n_tok = len(prompts[i])
            t = torch.tensor(prompts[i][None], device=device)
            ins_row = rows_of[i].clone()
            c0 = off = 0
            if src is None:
                rows = init_cache(cfg, 1, cache_len, dt, device)
            else:
                k = m // ps
                trow = torch.zeros(pps, dtype=torch.int32)
                held = k + int(m % ps > 0)             # + the fork page
                trow[:held] = rows_of[src][:held]
                if fault == "gather_table_shifted":
                    trow = torch.cat([trow[1:], trow[:1] * 0])
                rows = gather(cache, trow.to(device), m)
                if fault == "fork_not_copied":
                    zero_page(rows, k)
                c0, off = m, int(fault == "tail_q_off_plus_1")
                ins_row[:k] = 0             # the garbage page: not written
            while c0 < n_tok:
                c1 = min(c0 + chunk, n_tok)
                rows, lg = chunk_step(
                    p, rows, t[:, c0:c1], c0 + off,
                    attn_extent=min(cache_len, -(-c1 // chunk) * chunk),
                    want_logits=c1 == n_tok)
                c0 = c1
            if fault == "fork_not_copied" and src is not None:
                zero_page(rows, m // ps)        # the slot's page: empty
            cache = insert(cache, rows, 0, s, ins_row.to(device))
            firsts.append(lg[0, -1].float())
            del rows
        return firsts

    od = {}                     # the on-demand slots' pages and positions

    def admit_row(s, n_tok):
        """Slot s's insert row at an on-demand admission of ``n_tok``
        positions: their pages, the rest at the garbage page."""
        k = -(-n_tok // ps)
        row = od["own"][s].clone()
        row[k:] = 0
        od["pub"][s] = k
        return row.to(device)

    def restore(s, i, j, fault):
        """Request i, evicted with j + 1 tokens out, restored into slot s
        on the slot's other pages."""
        nonlocal cache
        od["own"][s], od["spare"][s] = od["spare"][s], od["own"][s]
        if replay:
            rows, _ = prefill(p, torch.tensor(prompts[i][None],
                                              device=device))
            if fault == "restore_state_dropped":
                for blk in rows["blocks"]:
                    for leaf in blk.values():
                        leaf.zero_()
            for k in range(j):
                fed = torch.tensor([[int(toks[i][k])]], dtype=torch.int32,
                                   device=device)
                _, rows = restore_step(p, rows, fed)
            n_tok = len(prompts[i]) + j
        else:
            seq = np.concatenate([prompts[i], toks[i][:j]])
            if fault == "restore_drops_last_token":
                seq = seq[:-1]
            n_tok = len(seq)
            t = torch.tensor(seq[None], device=device)
            rows, c0 = init_cache(cfg, 1, cache_len, dt, device), 0
            while c0 < n_tok:
                c1 = min(c0 + chunk, n_tok)
                rows, _ = restore_step(
                    p, rows, t[:, c0:c1], c0,
                    attn_extent=min(cache_len, -(-c1 // chunk) * chunk),
                    want_logits=False)
                c0 = c1
        cache = insert(cache, rows, 0, s, admit_row(s, n_tok))
        od["pos"][s] = n_tok

    def before_tick(j, idx, pages, fault):
        """Restores due before tick j, then each slot's table grown to its
        write position; returns the positions tick j writes."""
        for s, i in enumerate(idx):
            if j + 1 in evictions[i]:
                restore(s, i, j, fault)
        tab = torch.zeros((slots, pps), dtype=torch.int32)
        for s in range(len(idx)):
            k = od["pub"][s]
            if fault != "grown_page_not_published":
                k = max(k, od["pos"][s] // ps + 1)
            tab[s, :k] = od["own"][s][:k]
        pages["table"] = tab.to(device)
        return torch.tensor(od["pos"] + [0] * (slots - len(idx)),
                            dtype=torch.int32, device=device)

    for r0 in range(0, len(prompts), slots):
        idx = list(range(r0, min(r0 + slots, len(prompts))))
        pad = slots - len(idx)
        pos0 = torch.tensor([len(prompts[i]) + n_patches for i in idx]
                            + [0] * pad, dtype=torch.int32, device=device)
        feed = torch.tensor(np.stack([toks[i] for i in idx]
                                     + [np.zeros((gen,) + extra, np.int32)]
                                     * pad), device=device)
        trows = ([rows_of[s] for s in range(len(idx))] if plan is None
                 else [rows_of[i] for i in idx])
        table = torch.stack(trows + [torch.zeros(pps, dtype=torch.int32)]
                            * pad).to(device)
        pages = {"table": table, "page_size": ps, "cache_len": cache_len,
                 "kernel": paged_kernel}

        def prefill_round():
            return [prefill(p, torch.tensor(prompts[i][None], device=device),
                            None if patches is None else patches[i][None])
                    for i in idx]

        clean = prefill_round() if plan is None else None
        for n in names:
            if evictions is not None:
                od.update(own=list(rows_of[:slots]),
                          spare=list(rows_of[slots:]), pub=[0] * slots,
                          pos=[len(prompts[i]) for i in idx])
            with planted(None if n in HIT_FAULTS + RESTORE_FAULTS else n,
                         cfg):
                if plan is not None:
                    rows = [torch.stack(chunked_round(idx, n))]
                else:
                    rounds = (prefill_round() if n in PREFILL_FAULTS
                              else clean)
                    for s, (rc, _) in enumerate(rounds):
                        cache = insert(cache, rc, 0, s, table[s]
                                       if evictions is None else
                                       admit_row(s, len(prompts[idx[s]])))
                    rows = [torch.stack([lg[0, -1].float()
                                         for _, lg in rounds])]
                    del rounds
                for j in range(gen - 1):
                    pos = pos0 + j
                    if evictions is not None:
                        pos = before_tick(j, idx, pages, n)
                        od["pos"] = [q + 1 for q in od["pos"]]
                    o = forward(p, cfg, feed[:, j:j + 1], mode="decode",
                                pos=pos, cache=cache, pages=pages)
                    rows.append(o["logits"][:len(idx), 0].float())
            lg = torch.stack(rows, dim=1)               # (round, gen, V)
            if ref is None:
                continue
            if n is None:
                built = lg
            tally(acc[n], lg, built, ref, toks, idx)
        del clean
    if ref is None:
        return {}
    return summary(acc)


def new_tally():
    return {"d2": 0.0, "r2": 0.0, "e2": 0.0, "rel_max": 0.0, "gap": 0.0,
            "same": 0}


def tally(a, lg, built, ref, toks, idx):
    """Adds one round of a step path's logits ``lg`` (round, gen, V), or
    (round, gen, K, V) for audio, to ``a``: against the forward's ``ref``
    of requests ``idx`` and against the path as built (``built``).  Each
    (position, codebook) is a row: its own relative error and gap."""
    import torch

    v = lg.shape[-1]
    for s, i in enumerate(idx):
        got, want = lg[s].reshape(-1, v), ref[i].reshape(-1, v)
        d = got - want
        c = want - want.mean(dim=-1, keepdim=True)
        d2, r2 = d.square().sum(-1), c.square().sum(-1)
        a["d2"] += d2.sum().item()
        a["r2"] += r2.sum().item()
        a["e2"] += (got - built[s].reshape(-1, v)).square().sum().item()
        a["rel_max"] = max(a["rel_max"], (d2 / r2).sqrt().max().item())
        am = got.argmax(-1)
        gap = want.max(-1).values - want.gather(1, am[:, None])[:, 0]
        a["gap"] = max(a["gap"], gap.max().item())
        a["same"] += int((am.cpu() == torch.as_tensor(toks[i]).reshape(-1)
                          .long()).sum())


def summary(acc):
    """name -> {"rel": aggregate relative logit error, "rel_max": worst
    position, "effect": distance from the path as built, "gap": worst gap
    of the path's argmax under the forward, "same": argmaxes equal to the
    emitted tokens}."""
    return {n: {"rel": (a["d2"] / a["r2"]) ** 0.5, "rel_max": a["rel_max"],
                "effect": (a["e2"] / a["r2"]) ** 0.5, "gap": a["gap"],
                "same": a["same"]} for n, a in acc.items()}


def verify_check(cfg, params, prompts, toks, ref, device, names, slots=16,
                 cache_len=2080, ps=8, s=VERIFY_S):
    """The verify step teacher-forced: each prompt through the prefill
    step and the paged insert, as the engine admits it; then the emitted
    tokens in windows of ``s`` lanes (a committed token and the s - 1
    after it as drafts, every lane accepted) at offsets 0, s, 2s, ... of
    the stream, one verify forward a window over ``slots`` requests a
    round, paged with the gather path as the engine's verify step runs
    it; the last window is short (masked lanes).  Lane j's logits are held
    to the forward's ``ref`` at that position, the first token's to the
    prefill's — as built and under each planted fault of ``names``.
    Returns ``summary``'s dict."""
    import numpy as np
    import torch

    from repro_torch.models.lm import forward
    from repro_torch.steps import (cast_tree, init_paged_slot_cache,
                                   make_batched_insert_step,
                                   make_prefill_step)

    p = cast_tree(params, cfg.dtype)
    prefill = make_prefill_step(cfg, cache_len=cache_len)
    insert = make_batched_insert_step(cfg, cache_len=cache_len, page_size=ps)
    pps = cache_len // ps
    g = torch.Generator().manual_seed(4)
    own = (1 + torch.randperm(slots * pps, generator=g)).int().view(slots,
                                                                    pps)
    cache = init_paged_slot_cache(cfg, slots, cache_len,
                                  getattr(torch, cfg.dtype), ps,
                                  1 + slots * pps, device)
    acc = {n: new_tally() for n in names}
    gen = len(toks[0])
    for r0 in range(0, len(prompts), slots):
        idx = list(range(r0, min(r0 + slots, len(prompts))))
        pad = slots - len(idx)
        table = torch.cat([own[:len(idx)],
                           torch.zeros((pad, pps), dtype=torch.int32)])
        pages = {"table": table.to(device), "page_size": ps,
                 "cache_len": cache_len, "kernel": False}
        rows = [prefill(p, torch.tensor(prompts[i][None], device=device))
                for i in idx]
        first = torch.stack([lg[0, -1].float() for _, lg in rows])
        feed = torch.zeros((slots, gen + s), dtype=torch.int32)
        feed[:len(idx), :gen] = torch.tensor(np.stack([toks[i] for i in idx]))
        feed = feed.to(device)
        plen = torch.tensor([len(prompts[i]) for i in idx] + [0] * pad,
                            dtype=torch.int32, device=device)
        for n in names:
            for slot, (rc, _) in enumerate(rows):
                cache = insert(cache, rc, 0, slot, pages["table"][slot])
            lanes = [first[:, None]]
            with planted(n):
                for j0 in range(0, gen - 1, s):
                    k = min(s, gen - 1 - j0)
                    n_tok = torch.tensor([k] * len(idx) + [0] * pad,
                                         dtype=torch.int32, device=device)
                    o = forward(p, cfg, feed[:, j0:j0 + s], mode="verify",
                                pos=plen + j0, cache=cache,
                                cache_len=cache_len, pages=pages,
                                n_tok=n_tok)
                    lanes.append(o["logits"][:len(idx), :k].float())
            lg = torch.cat(lanes, dim=1)                # (round, gen, V)
            if n is None:
                built = lg
            tally(acc[n], lg, built, ref, toks, idx)
        del rows
    return summary(acc)


def moe_layers(cfg):
    return cfg.n_repeats * sum(spec.mlp == "moe" for spec in cfg.pattern)


@contextlib.contextmanager
def routes_recorded(store):
    """Every MoE routing in the block appends its (B, S, K) expert ids to
    ``store``."""
    from repro_torch.models import moe

    route = moe.route

    def recorded(*args, **kw):
        out = route(*args, **kw)
        store.append(out[1])
        return out
    with swapped((moe, "route", recorded)):
        yield


def path_routes(store, cfg, lens, slots, gen):
    """Per request, per MoE layer, the (S + gen - 1, K) expert ids that
    ``path_check`` (as built) gave each position, from the order it routes
    in: per round of ``slots`` requests, each request's prefill, then
    gen - 1 decode ticks over the round's slots."""
    import torch

    n = moe_layers(cfg)
    it = iter(store)
    out = []
    for r0 in range(0, len(lens), slots):
        idx = range(r0, min(r0 + slots, len(lens)))
        pre = [[next(it)[0] for _ in range(n)] for _ in idx]
        dec = [[next(it) for _ in range(n)] for _ in range(gen - 1)]
        for s in range(len(idx)):
            out.append([torch.cat([pre[s][layer]]
                                  + [dec[j][layer][s] for j in range(gen - 1)])
                        for layer in range(n)])
    return out


@contextlib.contextmanager
def routes_forced(layers, flips):
    """MoE layers route, in call order, to the expert ids ``layers`` gives
    (a serve path's (S, K) per request, or a train step's (B, S, K));
    their weights and load-balance term come from this forward's own
    router.  ``flips`` gets, per call, which (row, position) pairs would
    have picked another top-k set on their own, and the margin between
    the forward's own k-th and (k+1)-th router probabilities there."""
    from repro_torch.models import moe

    it = iter(layers)

    def forced(xn, router, cfg, aux=True, data=None):
        probs = moe.router_probs(xn, router)
        topi = next(it).to(probs.device).reshape(
            probs.shape[:-1] + (cfg.top_k,))
        own_v, own = probs.topk(cfg.top_k + 1, dim=-1)
        own = own[..., :cfg.top_k]
        flips.append(((own.sort(-1).values != topi.sort(-1).values)
                      .any(-1).reshape(-1),
                      (own_v[..., -2] - own_v[..., -1]).reshape(-1)))
        topv = probs.gather(-1, topi)
        return (topv / topv.sum(dim=-1, keepdim=True), topi,
                moe.load_balance(probs, topi, cfg, data) if aux else None)
    with swapped((moe, "route", forced)):
        yield


def recorded_routes(cfg, params, plist, toks, device, phase, fault=None):
    """Per request, per MoE layer, the expert ids of one run of
    ``path_check`` over ``plist`` — the path as built, or with ``fault``
    planted in its routing."""
    store = []
    with planted(fault), routes_recorded(store):
        path_check(cfg, params, plist, toks, None, device,
                   phase["paged_kernel"], slots=phase["traffic"]["slots"],
                   cache_len=phase["traffic"]["cache_len"], names=[None])
    return path_routes(store, cfg, [len(x) for x in plist],
                       phase["traffic"]["slots"], len(toks[0]))


def route_check(flips, n_moe, starts, layers=None):
    """Route check over the ``flips`` of ``routes_forced`` (one forward
    per request, in order; ``starts``: each request's first checked
    position; ``layers``: per call, its MoE layer, by default the calls'
    order modulo ``n_moe``).  Returns its figures; ``wide_flips`` counts
    the (layer, position) pairs whose margin is above the layer's bound
    (``ROUTE_MARGIN_FIRST`` in the first MoE layer, ``ROUTE_MARGIN``
    after it) and whose path picked another top-k set."""
    import torch

    if layers is None:
        layers = [k % n_moe for k in range(len(flips))]
    flip = torch.cat([f for f, _ in flips])
    margin = torch.cat([m for _, m in flips])
    checked = torch.cat([
        torch.arange(len(f), device=f.device) >= starts[k // n_moe]
        for k, (f, _) in enumerate(flips)])
    first = torch.cat([torch.full_like(f, layers[k] == 0)
                       for k, (f, _) in enumerate(flips)])
    sure = margin > torch.where(first, ROUTE_MARGIN_FIRST, ROUTE_MARGIN)
    at_flips = margin[flip]
    return {
        "pairs": flip.numel(), "flips": flip.sum().item(),
        "flips_checked": (flip & checked).sum().item(),
        "sure": sure.sum().item(), "sure_first": (sure & first).sum().item(),
        "pairs_first": first.sum().item(),
        "widest_flip": at_flips.max().item() if at_flips.numel() else 0.0,
        "flip_margin_p99": torch.quantile(
            at_flips[:2 ** 24].float(), 0.99).item()
        if at_flips.numel() else 0.0,
        "wide_flips": (flip & sure).sum().item(),
        "widest_by_layer": [
            max((m[f].max().item() for (f, m), j in zip(flips, layers)
                 if j == i and f.any()), default=0.0)
            for i in range(n_moe)]}


def route_line(what, f):
    return (f"{what}: the forward's own top-k differs from the path's at "
            f"{f['flips']} of {f['pairs']} (layer, position) pairs "
            f"({f['flips_checked']} at checked positions); margin at those "
            f"p99 {f['flip_margin_p99']:.4f} widest {f['widest_flip']:.4f}; "
            f"{f['sure']} pairs have a margin above the bound "
            f"({f['sure_first']} of the first MoE layer's {f['pairs_first']} "
            f"above {ROUTE_MARGIN_FIRST}, the rest above {ROUTE_MARGIN}), "
            f"{f['wide_flips']} of them differ; widest flip margin by layer "
            + " ".join(f"{m:.4f}" for m in f["widest_by_layer"]))


def check_capacity_dispatch(cfg, params, device, seed=0):
    """The registry's capacity dispatch (``moe_mlp``) on the card at the
    phase's layer shape and first MoE layer's weights, for 2 x 4096
    tokens: against the dropless dispatch with the weights of the picks
    that overflow zeroed, the overflow found by a numpy walk of the
    reference's rule (per batch row, token-major, pick-minor; a pick
    keeps the next slot of its expert's queue, dropped past
    ``capacity``).  At capacity factor 0.9 (below an even share) the
    rule must drop picks; the registry's factor is checked too.  Returns
    the drops at the registry's factor."""
    import numpy as np
    import torch

    from repro_torch.models import moe

    first = next(i for i, spec in enumerate(cfg.pattern)
                 if spec.mlp == "moe")
    p = {k: v[0] for k, v in params["blocks"][first]["mlp"].items()}
    g = torch.Generator(device).manual_seed(seed)
    xn = torch.randn((2, 4096, cfg.d_model), generator=g, device=device,
                     dtype=getattr(torch, cfg.dtype))
    route = moe.route
    drops = {}
    for cf in (0.9, cfg.capacity_factor):
        c_cfg = cfg.replace(capacity_factor=cf)
        got, _ = moe.moe_mlp(xn, p, c_cfg, aux=False)
        topv, topi, _ = route(xn, p["router"], c_cfg, aux=False)
        c = moe.capacity(xn.shape[1], c_cfg)
        ids = topi.reshape(topi.shape[0], -1).cpu().numpy()
        keep = np.zeros(ids.shape, bool)
        for b in range(ids.shape[0]):
            for e in range(cfg.n_experts):
                at = np.flatnonzero(ids[b] == e)
                keep[b, at[:c]] = True
        drops[cf] = int((~keep).sum())
        mask = torch.as_tensor(keep, device=device).view(topv.shape)

        def masked(*args, **kw):
            v, i, lb = route(*args, **kw)
            return v * mask, i, lb
        with swapped((moe, "route", masked)):
            want, _ = moe.moe_mlp_ragged(xn, p, c_cfg, aux=False)
        rms, worst = row_rel(got, want)
        log(f"MoE capacity dispatch ({cfg.name}, 2 x 4096 tokens, d "
            f"{cfg.d_model}, d_ff {cfg.d_ff}, capacity factor {cf}: "
            f"{c} slots per expert): {drops[cf]} of {ids.size} picks "
            f"dropped; against dropless with those picks zeroed, row error "
            f"RMS {rms:.3e} / worst {worst:.3e} (bounds "
            f"{ROW_TOL})")
        if rms > ROW_TOL["rms"] or worst > ROW_TOL["worst"]:
            raise AssertionError(f"{cfg.name}: the capacity dispatch differs "
                                 f"from its rule at capacity factor {cf}")
        del got, want
    if drops[0.9] == 0:
        raise AssertionError(f"{cfg.name}: capacity factor 0.9 dropped no "
                             "pick; the check saw no overflow")
    return drops[cfg.capacity_factor]


def reference_forward():
    """The forward of the checks: the port's model, with the SSD scan's
    plain version in place of the kernel (the reference model's own math)
    so that a fault of the kernel cannot sit on both sides."""
    from repro_torch.models import ssm

    return swapped((ssm, "ssd_scan", plain_ssd))


def prefix_prompts(cfg, traffic, rng):
    """The prefix phases' prompts, wave 1 first (one per prefix), then
    wave 2 in a seeded order; and per prompt its (source request, matched
    tokens) by the trie's rule: the common run with its prefix's wave-1
    prompt, at most all but the last token ((None, 0) for wave 1).
    Prefix j's k-th prompt has tail ``tails[(j + k // 2) % 4]``: two of
    each length, and the four wave-1 prompts one of each."""
    import numpy as np

    n_pre, tails = traffic["n_prefix"], traffic["tails"]
    per = traffic["n_req"] // n_pre
    prompts = {}
    for j in range(n_pre):
        head = rng.integers(0, cfg.vocab, traffic["prefix_len"])
        for k in range(per):
            tail = rng.integers(0, cfg.vocab, tails[(j + k // 2) % len(tails)])
            prompts[j, k] = np.concatenate([head, tail]).astype(np.int32)
    wave2 = [(j, k) for j in range(n_pre) for k in range(1, per)]
    order = [(j, 0) for j in range(n_pre)] + [
        wave2[i] for i in rng.permutation(len(wave2))]
    plist = [prompts[key] for key in order]
    plan = []
    for (j, k), pr in zip(order, plist):
        if k == 0:
            plan.append((None, 0))
            continue
        n = min(len(pr) - 1, len(plist[j]))
        diff = np.flatnonzero(pr[:n] != plist[j][:n])
        plan.append((j, int(diff[0]) if len(diff) else n))
    return plist, plan


def ssm_gain(params):
    """Every SSD mixer's conv weights times ``SSM_CONV_W_GAIN`` (the
    reason beside it), in place."""
    for blk in params["blocks"]:
        if "conv_w" in blk["mixer"]:
            blk["mixer"]["conv_w"].mul_(SSM_CONV_W_GAIN)


def weights_task(cfg, seed, device, box):
    """The engine's weights task: seeded weights made on ``device`` into
    ``box["params"]``, the seconds it took into ``box["weights_s"]``."""
    import torch

    from repro_torch.models.lm import init_params

    def weights():
        t = time.perf_counter()
        box["params"] = init_params(
            cfg, torch.Generator(device).manual_seed(seed), device)
        ssm_gain(box["params"])
        if cfg.frontend == "audio_codebooks":
            box["params"]["embed"]["tok"].mul_(AUDIO_EMBED_GAIN)
            box["params"]["lm_head"].mul_(AUDIO_HEAD_GAIN)
        if device == "cuda":
            torch.cuda.synchronize()
        box["weights_s"] = time.perf_counter() - t
        return box["params"]
    return weights


def forced_logits(cfg, params, prompt, toks, device, patches=None):
    """The forward of the checks over [patches +] prompt + toks[:-1], f32
    logits (len(toks), V) — (len(toks), K, V) for audio — at the
    positions that predict each of ``toks``."""
    import numpy as np
    import torch

    from repro_torch.models.lm import forward

    seq = np.concatenate([prompt, toks[:-1]])
    with reference_forward():
        lg = forward(params, cfg, torch.tensor(seq[None], device=device),
                     mode="train",
                     patches=None if patches is None else patches[None])[
                         "logits"][0, len(prompt) - 1:]
    return lg.float()


def token_gaps(lg, toks):
    """How far each emitted token's logit trails the row's max: per
    position, and per codebook for audio (rows of (…, V) logits)."""
    import torch

    v = lg.shape[-1]
    lg = lg.reshape(-1, v)
    t = torch.as_tensor(toks, device=lg.device).reshape(-1).long()
    return lg.max(dim=-1).values - lg.gather(1, t[:, None])[:, 0]


def log_checks(what, name, res, total):
    for n, m in res.items():
        log(f"{what} [{name}, {n or 'as built'}]: worst position rel err "
            f"{m['rel_max']:.4f} (tolerance {REL_TOL}), all positions "
            f"{m['rel']:.4f}, off the path as built by {m['effect']:.4f}; "
            f"its argmax trails the forward's by at most {m['gap']:.4f} "
            f"(token tolerance {LOGIT_TOL}); {m['same']}/{total} equal the "
            "engine's tokens")


def serve(cfg, smi, device="cuda", seed=0, name=None):
    """Drive one main path (phase ``name``, by default the config's
    arch); returns (launch counts, engine stats, engine step calls)."""
    import collections
    import threading

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.models.lm import forward
    from repro_torch.serve import Request, ServeEngine, drain
    from repro_torch.serve.watchdog import abandon

    name = name or arch_of(cfg)
    phase = PHASES[name]
    traffic = phase["traffic"]
    paged_kernel = phase["paged_kernel"]
    counted = (*phase["kernels"], "rms_norm")
    cuda = device == "cuda"
    moe = any(spec.mlp == "moe" for spec in cfg.pattern)
    slots, cache_len, n_req, gen = (traffic[k] for k in (
        "slots", "cache_len", "n_req", "gen"))
    extra, n_patches = frontend_shape(cfg)
    n_rows = n_req * gen * int(np.prod(extra))      # token rows checked
    rng = np.random.default_rng(seed)
    prefix = "prefix_len" in traffic
    plan = None
    if prefix:
        prompts, plan = prefix_prompts(cfg, traffic, rng)
        lens = np.array([len(x) for x in prompts])
        wave1 = [i for i, (src, _) in enumerate(plan) if src is None]
    elif traffic["each"]:
        lens = rng.permutation(np.repeat(traffic["lens"],
                                         n_req // len(traffic["lens"])))
    else:
        lens = rng.choice(traffic["lens"], n_req)
    if not prefix:
        prompts = [rng.integers(0, cfg.vocab, (n,) + extra).astype(np.int32)
                   for n in lens]
    # vision: each request's patch embeddings, made on the device
    patches = request_patches(cfg, n_req, device, seed + 1)
    gaps = rng.exponential(0.03, n_req)
    box = {}
    weights = weights_task(cfg, seed, device, box)
    t_phase = time.perf_counter()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ondemand = phase.get("policy") == "ondemand"
    eng = ServeEngine(cfg, weights, slots=slots, cache_len=cache_len,
                      page_size="auto", paged_kernel=paged_kernel,
                      sync_ticks=True, device=device,
                      prefill_chunk=phase.get("prefill_chunk"),
                      prefix_cache=phase.get("prefix_cache"),
                      policy=phase.get("policy"),
                      num_pages=phase.get("num_pages"),
                      max_prefill_batch=phase.get("max_prefill_batch"))
    # the engine's steps, counted: one-shot prefills, chunks with and
    # without the LM head, gathers, decode ticks
    calls, calls_lock = collections.Counter(), threading.Lock()

    def counting(fn, key):
        def run(*a, **kw):
            with calls_lock:
                calls[key(kw) if callable(key) else key] += 1
            return fn(*a, **kw)
        return run
    eng.prefill = counting(eng.prefill, "prefill")
    eng.decode = counting(eng.decode, "decode")
    if eng.chunk is not None:
        eng.chunk = counting(eng.chunk, lambda kw: "chunk"
                             if kw["want_logits"] else "chunk_mid")
    if eng.gather is not None:
        eng.gather = counting(eng.gather, "gather")
    eng.replay = counting(eng.replay, "replay")
    # per request, the tokens it had out at each eviction (through the
    # class's function and the ``eng`` variable, never a bound method: the
    # engine must not reach itself once ``eng`` is dropped, or its pool
    # and weights outlive the phase until a garbage collection)
    evicted = collections.defaultdict(list)

    def recorded_evict(s):
        req = eng._slot_req[s]
        evicted[req.rid].append(len(req.out_tokens))
        return ServeEngine._evict_slot(eng, s)
    eng._evict_slot = recorded_evict
    for k in counted:
        getattr(kernels, k).launches.reset()
    t0 = time.perf_counter()
    reqs = [Request(i, prompts[i], max_new_tokens=gen,
                    patches=None if patches is None else patches[i])
            for i in range(n_req)]
    eng.start()
    for i, (r, g) in enumerate(zip(reqs, gaps)):
        if prefix and i == len(wave1):
            # wave 2 once every wave-1 request has 2 tokens out: it was
            # admitted, and its pages are in the trie
            t_w = time.perf_counter()
            while any(len(reqs[w].out_tokens) < 2 for w in wave1):
                for w in wave1:
                    if reqs[w].error is not None:   # failed in the engine
                        abandon(eng, f"{name}: request {w} failed: "
                                     f"{reqs[w].error!r}")
                if time.perf_counter() - t_w > DRAIN_S:
                    abandon(eng, f"{name}: wave 1 stalled")
                time.sleep(0.005)
        eng.submit(r)
        time.sleep(float(g))
    # every request and the engine's tasks within DRAIN_S, or the phase
    # fails with the engine's stats and every thread's stack
    stats = drain(eng, reqs, DRAIN_S)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pager, divergences = eng.pager, list(eng.restore_divergences)
    eng_chunkable = eng.chunk is not None
    eng = None                          # drop the pool before what follows
    launches = {k: getattr(kernels, k).launches.value for k in counted}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    params = box["params"]
    for r in reqs:
        toks = r.wait()
        if len(toks) != gen:
            raise AssertionError(f"request {r.rid}: {len(toks)} tokens")
    log(f"serve [{name}]: {cfg.name} d {cfg.d_model} layers {cfg.n_layers} "
        f"{cfg.dtype}, "
        f"{n_req} requests x {gen} tokens, {slots} slots, cache_len "
        f"{cache_len}, page_size {stats['page_size']}, paged_kernel "
        f"{paged_kernel}, prefill_chunk {phase.get('prefill_chunk')}, "
        f"prefix_cache {stats['prefix_cache']}; decode dispatches "
        f"{stats['decode_dispatches']}, prefill calls "
        f"{stats['prefill_calls']}, step calls {dict(calls)}, launches "
        f"{launches}")
    if ondemand:
        per = sorted(evicted.items())
        log(f"on-demand [{name}]: pool {phase['num_pages'] - 1} pages, "
            f"pages_grown {stats['pages_grown']} pages_grown_multi "
            f"{stats['pages_grown_multi']} admission_blocks "
            f"{stats['admission_blocks']} evictions {stats['evictions']} "
            f"restores {stats['restores']} restore_divergences "
            f"{stats['restore_divergences']}; replay steps "
            f"{calls['replay']}; {len(per)} requests evicted, at most "
            f"{max((len(v) for _, v in per), default=0)} times one; tokens "
            f"out at each eviction {dict(per)}")
    log(f"prefix and chunks [{name}]: prefix_hits {stats['prefix_hits']} "
        f"prefix_tokens_saved {stats['prefix_tokens_saved']} cow_forks "
        f"{stats['cow_forks']} prefill_chunks {stats['prefill_chunks']} "
        f"prefill_chunk_tasks {stats['prefill_chunk_tasks']} trie lookups "
        f"{stats.get('prefix_lookups')} inserted pages "
        f"{stats.get('prefix_inserted_pages')}; pager after "
        f"shutdown: live_refs {pager.live_refs} used_pages "
        f"{pager.used_pages} cached_pages {pager.cached_pages}")
    waves = ""
    if prefix:
        ttft = [sorted(r.ttft for r in reqs if (plan[r.rid][0] is None) == w)
                for w in (True, False)]
        waves = (f" p50_ttft_wave1_s {np.median(ttft[0]):.4f} "
                 f"p50_ttft_wave2_s {np.median(ttft[1]):.4f}")
    log(f"serve figures ({name}, {smi}): tokens_s "
        f"{stats['tokens_out'] / wall:.2f} "
        f"wall_s {wall:.3f} p50_ttft_s {stats['p50_ttft_s']:.4f}{waves} "
        f"p50_tick_s {stats['p50_tick_s']:.4f} p99_tick_s "
        f"{stats['p99_tick_s']:.4f} peak_mem_gb {peak / 1e9:.2f} "
        f"(weights task included: {box['weights_s']:.2f} s)")
    if prefix:
        n_hit = sum(src is not None for src, _ in plan)
        saved = sum(m for _, m in plan)
        if not (stats["prefix_hits"] == n_hit
                and stats["prefix_tokens_saved"] == saved
                and stats["cow_forks"] >= n_hit
                and stats["prefill_chunks"] > 0):
            raise AssertionError(
                f"{name}: prefix_hits {stats['prefix_hits']} (want "
                f"{n_hit}), prefix_tokens_saved "
                f"{stats['prefix_tokens_saved']} (want {saved}), cow_forks "
                f"{stats['cow_forks']} (want >= {n_hit}), prefill_chunks "
                f"{stats['prefill_chunks']} (want > 0)")
    elif stats["prefix_hits"] > stats["restores"]:
        # random prompts: only a restore can re-hit (its own pages)
        raise AssertionError(f"{name}: {stats['prefix_hits']} prefix hits "
                             f"on random prompts, {stats['restores']} "
                             "restores")
    if n_patches and stats["prefix_cache"] and (
            stats["prefix_lookups"] or stats["prefix_inserted_pages"]):
        raise AssertionError(
            f"{name}: vision requests touched the prefix trie: "
            f"{stats['prefix_lookups']} lookups, "
            f"{stats['prefix_inserted_pages']} pages inserted")
    if pager.live_refs or pager.used_pages != pager.cached_pages:
        raise AssertionError(f"{name}: pages leaked: live_refs "
                             f"{pager.live_refs}, used {pager.used_pages} "
                             f"!= cached {pager.cached_pages}")
    if ondemand:
        n_ev = sum(len(v) for v in evicted.values())
        if not (stats["pages_grown"] > 0 and stats["evictions"] > 0
                and stats["restores"] == stats["evictions"] == n_ev):
            raise AssertionError(
                f"{name}: pages_grown {stats['pages_grown']} (want > 0), "
                f"evictions {stats['evictions']} (want > 0, = {n_ev} "
                f"recorded), restores {stats['restores']} (want = "
                "evictions)")
    if moe:
        check_capacity_dispatch(cfg, params, device)
    if cuda and ondemand:
        restore_alone(cfg, params, smi, traffic, phase.get("prefill_chunk"))
    elif cuda and prefix:
        prefix_steps_alone(cfg, params, smi, traffic, phase["prefill_chunk"])
    elif cuda:
        steps_alone(cfg, params, smi, paged_kernel, traffic)

    # teacher-forced forward over prompt + emitted[:-1]: the gap is how
    # far each emitted token's logit trails that forward's max.  With MoE
    # the forward takes the expert ids of the step path as built (one run
    # of it recorded first): at random init, bf16 rounding differences
    # between any two computations flip near-tied top-2 choices, each flip
    # moves a token's MoE output by O(1), and neither check could tell a
    # fault from that.  The route check holds which experts the path
    # picks wherever the forward's own choice is clear (``ROUTE_MARGIN``,
    # ``ROUTE_MARGIN_FIRST``);
    # the CPU tests hold them to the reference (tests/test_torch_moe.py).
    # Everything else, the pick weights included, the forward computes
    # itself.
    toks_all = [np.asarray(r.out_tokens, np.int32) for r in reqs]
    plist = [prompts[r.rid] for r in reqs]
    routes = flips = None
    if moe:
        flips = []
        routes = recorded_routes(cfg, params, plist, toks_all, device, phase)
    ref, gaps_all, top2, spread, exact = [], [], [], [], 0
    for k, (r, toks) in enumerate(zip(reqs, toks_all)):
        with routes_forced(routes[k], flips) if moe \
                else contextlib.nullcontext():
            lg = forced_logits(cfg, params, prompts[r.rid], toks, device,
                               None if patches is None else patches[r.rid])
        if tuple(lg.shape) != (gen,) + extra + (cfg.vocab,) or \
                not torch.isfinite(lg).all():
            raise AssertionError(f"request {r.rid}: bad logits "
                                 f"{tuple(lg.shape)}")
        ref.append(lg)
        t = torch.tensor(toks, device=device).long()
        exact += int((lg.argmax(dim=-1) == t).sum().item())
        gaps_all.append(token_gaps(lg, toks).cpu())
        rows = lg.reshape(-1, cfg.vocab)
        v2 = rows.topk(2, dim=-1).values
        top2.append((v2[:, 0] - v2[:, 1]).cpu())
        spread.append(rows.std(dim=-1).cpu())
    gaps_all = torch.cat(gaps_all)
    top2, spread = torch.cat(top2), torch.cat(spread)
    worst = gaps_all.max().item()
    q = torch.quantile(gaps_all, torch.tensor([0.5, 0.99])).tolist()
    log(f"teacher-forced ({name}): {exact}/{n_rows} emitted tokens "
        f"{'(each codebook a token) ' if extra else ''}are the forward's "
        f"argmax; gap p50 {q[0]:.4f} p99 {q[1]:.4f} max "
        f"{worst:.4f} (tolerance {LOGIT_TOL}); forward's top-2 margin p50 "
        f"{top2.median().item():.4f}, logit std p50 "
        f"{spread.median().item():.4f}")
    # a restore that re-derived another token than the one emitted (the
    # engine recorded it and fed the emitted one on): both must be within
    # the token tolerance of the forward's argmax there, a near-tie
    div_worst = 0.0
    for rid, k, want, got in divergences:
        lg = ref[rid][k]
        g_want, g_got = ((lg.max() - lg[t]).item() for t in (want, got))
        div_worst = max(div_worst, g_want, g_got)
        log(f"restore divergence ({name}): request {rid} token {k}: "
            f"emitted {want} (gap {g_want:.4f}), re-derived {got} (gap "
            f"{g_got:.4f}); forward's top-2 margin there "
            f"{(lg.topk(2).values[0] - lg.topk(2).values[1]).item():.4f}")
    peak_checks = torch.cuda.max_memory_allocated() if cuda else 0
    built, route_missed = {"wide_flips": 0}, []
    if moe:
        n_moe = moe_layers(cfg)
        starts = [len(x) - 1 for x in plist]
        built = route_check(flips, n_moe, starts)
        log(route_line(f"route check [{cfg.name}, as built]", built))
        del routes, flips
        # planted in the routing: recorded from the path under the fault
        # and forced on the forward, over one round of requests
        for fault in ROUTE_FAULTS:
            k_f = min(slots, n_req)
            routes = recorded_routes(cfg, params, plist[:k_f],
                                     toks_all[:k_f], device, phase, fault)
            flips = []
            for k in range(k_f):
                seq = np.concatenate([plist[k], toks_all[k][:-1]])
                with reference_forward(), routes_forced(routes[k], flips):
                    forward(params, cfg, torch.tensor(seq[None],
                                                      device=device),
                            mode="train")
            f = route_check(flips, n_moe, starts[:k_f])
            log(route_line(f"route check [{cfg.name}, {fault}]", f))
            if f["wide_flips"] == 0:
                route_missed.append(fault)
            del routes, flips

    # logit check of the step path, as built and with each planted fault
    res = path_check(cfg, params, plist, toks_all, ref, device,
                     paged_kernel, slots=slots, cache_len=cache_len,
                     phase=name, plan=plan,
                     chunk=phase.get("prefill_chunk") or 512,
                     evictions=([set(evicted[r.rid]) for r in reqs]
                                if ondemand else None),
                     replay=ondemand and not eng_chunkable, patches=patches)
    log_checks("logit check", name, res, n_rows)
    # the verify mode over the same paged pools, where the phase asks
    vres = {}
    if phase.get("verify_faults"):
        vres = verify_check(cfg, params, plist, toks_all, ref, device,
                            [None, *phase["verify_faults"]], slots=slots,
                            cache_len=cache_len)
        log_checks(f"verify check (S={VERIFY_S})", name, vres, n_req * gen)
    del ref

    if worst > LOGIT_TOL:
        raise AssertionError(f"{name}: an emitted token trails the "
                             f"forward's argmax by {worst:.4f} > {LOGIT_TOL}")
    if div_worst > LOGIT_TOL:
        raise AssertionError(f"{name}: a restore re-derived a token that "
                             f"trails the forward's argmax by "
                             f"{div_worst:.4f} > {LOGIT_TOL}")
    for what, r in (("step path", res), ("verify step", vres)):
        if r and r[None]["rel_max"] > REL_TOL:
            raise AssertionError(f"{name}: {what} logits off the forward's "
                                 f"by {r[None]['rel_max']:.4f} > {REL_TOL}")
    if built["wide_flips"]:
        raise AssertionError(
            f"{cfg.name}: the step path's experts differ from the forward's "
            f"own at {built['wide_flips']} (layer, position) pairs whose "
            f"margin is above the bound")
    missed = route_missed + [n for n in res if n is not None and (
        res[n]["rel_max"] <= REL_TOL or res[n]["gap"] <= LOGIT_TOL)] + \
        verify_missed(vres)
    if missed:
        raise AssertionError(f"{name}: the checks do not reject the "
                             f"planted faults {missed}")
    log(f"phase {name}: {time.perf_counter() - t_phase:.1f} s; peak "
        f"device memory of the teacher-forced forward "
        f"{peak_checks / 1e9:.2f} GB")
    return launches, stats, calls


def verify_missed(vres):
    """The verify check's planted faults it does not reject: each must
    move some position past ``REL_TOL``."""
    return [n for n, m in vres.items()
            if n is not None and m["rel_max"] <= REL_TOL]


def drafter_policy(drafter):
    """The reserve policy with ``drafter`` plugged in through its
    ``spec_drafter`` hook (the engine untouched, as the reference's
    ``OraclePolicy`` does)."""
    from repro_torch.serve import SchedulerPolicy

    class DrafterPolicy(SchedulerPolicy):
        def spec_drafter(self, eng, mode):
            return drafter
    return DrafterPolicy()


class NeverDrafter:
    """Drafts nothing: every window of its leg is one token a slot."""

    name = "never"

    def draft(self, ctx, k):
        return []


class OracleDrafter:
    """Proposes a stream's continuation in ``streams`` (prompt + tokens)
    while the context still matches it; in every third window it changes
    the last lane, so that lane is rejected (a rollback)."""

    name = "oracle"

    def __init__(self, streams, vocab):
        self.streams = [list(map(int, x)) for x in streams]
        self.vocab = vocab
        self.windows = 0

    def draft(self, ctx, k):
        n = len(ctx)
        for st in self.streams:
            if n < len(st) and st[n - 1] == ctx[-1] and st[:n] == ctx:
                d = st[n:n + k]
                self.windows += 1
                if self.windows % 3 == 0:
                    d[-1] = (d[-1] + 1) % self.vocab
                return d
        return []


def serve_spec(cfg, smi, device="cuda", seed=0, name="qwen2.5-14b-spec"):
    """Speculative decoding on one set of weights, the same prompts and
    arrivals in three legs: (a) spec off; (b) spec on, a drafter that
    never drafts (every window one token a slot); (c) spec on, an oracle
    drafter proposing leg (b)'s continuation, one rejected lane every
    third window.  Bars: every stream of every leg within ``LOGIT_TOL``
    of the forward's argmax; no prefix hit (random prompts), no page
    leaked; leg (c) drafts, accepts and rolls back, in fewer dispatches
    than leg (a); the verify step teacher-forced (``verify_check``, S =
    ``VERIFY_S``) within ``REL_TOL`` of the forward, rejecting the
    planted verify faults; leg (c) rerun with the engine committing its
    drafts must fail the token check.  Returns, per leg, (kernels of the
    leg, launch counts, engine stats, engine step calls) for
    ``check_launches``."""
    import collections
    import threading

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.serve import Request, ServeEngine, drain

    phase = PHASES[name]
    traffic, spec_k = phase["traffic"], phase["spec_k"]
    slots, cache_len, n_req, gen = (traffic[k] for k in (
        "slots", "cache_len", "n_req", "gen"))
    counted = (*phase["kernels"], "rms_norm")
    rng = np.random.default_rng(seed)
    lens = rng.permutation(np.repeat(traffic["lens"],
                                     n_req // len(traffic["lens"])))
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    gaps = rng.exponential(0.03, n_req)
    box = {}
    t_phase = time.perf_counter()

    cuda = device == "cuda"

    def leg(drafter, params):
        """One engine over the phase's traffic; its counts and figures."""
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        eng = ServeEngine(
            cfg, params, slots=slots, cache_len=cache_len, page_size="auto",
            paged_kernel=True, sync_ticks=True, device=device,
            prefix_cache=phase.get("prefix_cache"),
            policy=None if drafter is None else drafter_policy(drafter),
            spec=None if drafter is None else drafter.name, spec_k=spec_k)
        calls, lock = collections.Counter(), threading.Lock()

        def counting(fn, key):
            def run(*a, **kw):
                with lock:
                    calls[key] += 1
                return fn(*a, **kw)
            return run
        for key in ("prefill", "decode", "verify", "gather", "replay"):
            if getattr(eng, key) is not None:
                setattr(eng, key, counting(getattr(eng, key), key))
        for k in counted:
            getattr(kernels, k).launches.reset()
        t0 = time.perf_counter()
        reqs = [Request(i, prompts[i], max_new_tokens=gen)
                for i in range(n_req)]
        eng.start()
        for r, g in zip(reqs, gaps):
            eng.submit(r)
            time.sleep(float(g))
        stats = drain(eng, reqs, DRAIN_S)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: getattr(kernels, k).launches.value for k in counted}
        pager = eng.pager
        eng = None                      # the pool, before what follows
        toks = [np.asarray(r.wait(), np.int32) for r in reqs]
        if any(len(t) != gen for t in toks):
            raise AssertionError(f"{name}: a stream of {[len(t) for t in toks]}"
                                 f" tokens, want {gen}")
        if stats["prefix_hits"] or pager.live_refs \
                or pager.used_pages != pager.cached_pages:
            raise AssertionError(
                f"{name}: prefix hits {stats['prefix_hits']} on random "
                f"prompts, or pages leaked: live_refs {pager.live_refs}, "
                f"used {pager.used_pages} != cached {pager.cached_pages}")
        return dict(toks=toks, stats=stats, calls=calls, launches=launches,
                    wall=wall,
                    peak=torch.cuda.max_memory_allocated() if cuda else 0)

    legs = {"a": leg(None, weights_task(cfg, seed, device, box))}
    params = box["params"]
    legs["b"] = leg(NeverDrafter(), params)
    streams = [np.concatenate([p, t]) for p, t in zip(prompts,
                                                      legs["b"]["toks"])]
    legs["c"] = leg(OracleDrafter(streams, cfg.vocab), params)
    with planted("commits_drafts"):
        legs["commits_drafts"] = leg(OracleDrafter(streams, cfg.vocab),
                                     params)

    # the token check of every leg: one forward per distinct stream
    gaps_of, ref = {}, []
    for key, g in legs.items():
        g["worst"] = 0.0
        for i, t in enumerate(g["toks"]):
            memo = (i, t.tobytes())
            if memo not in gaps_of:         # leg (a)'s are all new
                lg = forced_logits(cfg, params, prompts[i], t, device)
                gap = lg.max(-1).values - lg.gather(
                    1, torch.tensor(t, device=device).long()[:, None])[:, 0]
                gaps_of[memo] = gap.max().item()
                if key == "a":
                    ref.append(lg)
            g["worst"] = max(g["worst"], gaps_of[memo])
    fault = legs.pop("commits_drafts")

    def shared(x, y):
        return sum(int((u == v).sum()) for u, v in zip(legs[x]["toks"],
                                                       legs[y]["toks"]))

    for key, what in (("a", "spec off"), ("b", "no drafts"),
                      ("c", "oracle drafts")):
        g = legs[key]
        st = g["stats"]
        log(f"spec leg ({key}) [{name}, {what}, {smi}]: tokens_s "
            f"{st['tokens_out'] / g['wall']:.2f} wall_s {g['wall']:.3f} "
            f"p50_ttft_s {st['p50_ttft_s']:.4f} p50_tick_s "
            f"{st['p50_tick_s']:.4f} p99_tick_s {st['p99_tick_s']:.4f} "
            f"peak_mem_gb {g['peak'] / 1e9:.2f} decode_dispatches "
            f"{st['decode_dispatches']} dispatches_per_token "
            f"{st['dispatches_per_token']:.4f} spec_drafted "
            f"{st['spec_drafted']} spec_accepted {st['spec_accepted']} "
            f"spec_rollbacks {st['spec_rollbacks']} accept_rate "
            f"{st['spec_accept_rate']:.4f}; step calls {dict(g['calls'])}; "
            f"worst token gap {g['worst']:.4f} (tolerance {LOGIT_TOL})")
    log(f"spec legs [{name}]: leg (b) shares {shared('b', 'a')}/"
        f"{n_req * gen} tokens with leg (a), leg (c) {shared('c', 'b')} with "
        f"leg (b); weights task {box['weights_s']:.2f} s")
    log(f"spec fault [{name}, commits_drafts]: the engine committing its "
        f"drafts in leg (c): worst token gap {fault['worst']:.4f} "
        f"(must exceed {LOGIT_TOL}); spec_drafted "
        f"{fault['stats']['spec_drafted']}")
    if cuda:
        steps_alone(cfg, params, smi, True, traffic, verify_k=spec_k)
    vres = verify_check(cfg, params, prompts, legs["a"]["toks"], ref, device,
                        [None, *phase["verify_faults"]], slots=slots,
                        cache_len=cache_len)
    log_checks(f"verify check (S={VERIFY_S})", name, vres, n_req * gen)
    del ref
    c, a = legs["c"]["stats"], legs["a"]["stats"]
    bad = [k for k in "abc" if legs[k]["worst"] > LOGIT_TOL]
    if bad:
        raise AssertionError(f"{name}: an emitted token of leg(s) {bad} "
                             f"trails the forward's argmax by more than "
                             f"{LOGIT_TOL}")
    if not (c["spec_drafted"] > 0 and c["spec_accepted"] > 0
            and c["spec_rollbacks"] > 0
            and c["decode_dispatches"] < a["decode_dispatches"]):
        raise AssertionError(
            f"{name}: leg (c) spec_drafted {c['spec_drafted']}, "
            f"spec_accepted {c['spec_accepted']}, spec_rollbacks "
            f"{c['spec_rollbacks']} (each > 0), decode_dispatches "
            f"{c['decode_dispatches']} (< leg (a)'s "
            f"{a['decode_dispatches']})")
    if vres[None]["rel_max"] > REL_TOL:
        raise AssertionError(f"{name}: verify step logits off the forward's "
                             f"by {vres[None]['rel_max']:.4f} > {REL_TOL}")
    missed = verify_missed(vres) + (
        ["commits_drafts"] if fault["worst"] <= LOGIT_TOL else [])
    if missed:
        raise AssertionError(f"{name}: the checks do not reject the planted "
                             f"faults {missed}")
    log(f"phase {name}: {time.perf_counter() - t_phase:.1f} s")
    spec = phase["spec_kernels"]
    return [(phase["kernels"] if k == "a" else spec, legs[k]["launches"],
             legs[k]["stats"], legs[k]["calls"]) for k in "abc"]


# ------------------------------------------------------------------ train
def leaf_names(tree, prefix=""):
    """Names of a dict/tuple tree's leaves in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [n for i, t in enumerate(tree)
                for n in leaf_names(t, f"{prefix}[{i}]")]
    return [prefix]


def grad_gaps(got, want):
    """Per leaf ||got - want|| / ||want|| (f32), in ``tree_leaves``
    order."""
    from repro_torch.models.layers import tree_leaves

    out = []
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        den = w.float().norm().item()
        out.append((g.float() - w.float()).norm().item() / (den or 1.0))
    return out


def worst_gap(gaps, names):
    i = max(range(len(gaps)), key=gaps.__getitem__)
    return gaps[i], names[i]


@contextlib.contextmanager
def host_rise(every_s=0.01):
    """Yields a dict whose ``gb`` is, after the block, how far this
    process's resident memory rose above its level at the block's start,
    at its highest (``/proc/self/statm`` read every ``every_s`` s on a
    thread)."""
    import resource
    import threading

    page = resource.getpagesize()

    def rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * page
    box, start, stop = {}, rss(), threading.Event()
    top = [start]

    def watch():
        while not stop.wait(every_s):
            top[0] = max(top[0], rss())
    th = threading.Thread(target=watch, daemon=True, name="host-rise")
    th.start()
    try:
        yield box
    finally:
        stop.set()
        th.join()
        box["gb"] = (max(top[0], rss()) - start) / 1e9


def traced(fn):
    """One call of ``fn`` under ``torch.profiler``: (its result, host s,
    device busy s, [(kernel, ms)] largest first).  The port runs on one
    stream, so the kernels' durations add up to the busy time."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
    by = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            # "void ns::f<T, ...>(args)" -> "ns::f<T, ...", cut short
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].removeprefix("void ").strip()
            by[name[:56]] += e.time_range.elapsed_us()
    return out, host, sum(by.values()) / 1e6, [
        (k, v / 1e3) for k, v in by.most_common()]


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms for the block (the embedding's backward
    accumulates rows by sorting instead of atomics), so that two runs of
    the same steps give the same bits; ops without such a version only
    warn."""
    import warnings

    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        torch.use_deterministic_algorithms(False)


class FixedBatch:
    """A ``SyntheticTokenSource``-like source whose every step is one
    batch made on the card from ``seed``: (accum, micro, seq) tokens,
    labels = tokens as the reference's synthetic source sets them."""

    def __init__(self, vocab, accum, micro, seq, seed, device="cuda"):
        import torch

        g = torch.Generator(device).manual_seed(seed)
        tok = torch.randint(0, vocab, (accum, micro, seq), generator=g,
                            device=device, dtype=torch.int32)
        self.batch = {"tokens": tok, "labels": tok}

    def fetch(self, step):
        del step
        return self.batch


def train_identities(cfg, got, micro_steps, tp=False):
    """The train path's launch identities on one process over
    ``micro_steps`` microbatches: RMSNorm forward at every norm site,
    twice under remat "full", and the final norm; its backward once a
    site and the final norm; the SSD scan forward twice and its backward
    once an SSM layer.  ``tp`` (a model axis above 1): an SSM layer's
    gated norm takes the given-statistic backward instead, its two
    entries (``rms_norm_dot``, ``rms_norm_bwd_rstd``) once each.  Returns
    (want, the identities as text, with ``got``'s counts)."""
    norms, n_ssm = norm_sites(cfg), kind_layers(cfg, "ssm")
    given = n_ssm if tp else 0
    want = {"rms_norm": micro_steps * (2 * norms + 1),
            "rms_norm_bwd": micro_steps * (norms - given + 1)}
    if tp:
        want.update(rms_norm_dot=micro_steps * given,
                    rms_norm_bwd_rstd=micro_steps * given)
    if n_ssm:
        want.update(ssd_scan=micro_steps * 2 * n_ssm,
                    ssd_scan_bwd=micro_steps * n_ssm)
    text = (f"rms_norm {got['rms_norm']} = {micro_steps} x (2 x {norms} + "
            f"1: forward, remat recompute, final norm); rms_norm_bwd "
            f"{got['rms_norm_bwd']} = {micro_steps} x ({norms} - {given} + "
            f"1)" + (f"; rms_norm_dot {got['rms_norm_dot']} and "
                     f"rms_norm_bwd_rstd {got['rms_norm_bwd_rstd']} = "
                     f"{micro_steps} x {given} (the gated norms)"
                     if given else "") + (
                f"; ssd_scan {got['ssd_scan']} = {micro_steps} x 2 x "
                f"{n_ssm} (forward, remat recompute); ssd_scan_bwd "
                f"{got['ssd_scan_bwd']} = {micro_steps} x {n_ssm}"
                if n_ssm else ""))
    return want, text


def train_phase(cfg, smi, name="qwen2.5-14b-train", seed=0, device="cuda"):
    """The port's training path at full width (the phase's settings in
    ``PHASES[name]``: its ``TRAIN``, depth and the reason for a cut):
    seeded f32 master weights on the card, bf16 compute, remat "full",
    f32 AdamW state, microbatches of ``micro`` x ``seq`` tokens, ``accum``
    2, through ``steps.make_train_step`` on the UMT runtime with
    ``UMTPrefetcher`` and an async ``CheckpointManager``.  Bars (each
    raises): (a) the first loss is finite and ``steps`` steps on one batch
    lower it by ``LOSS_DROP``; (b) every parameter leaf gets a finite,
    nonzero gradient; (c) one step's gradients through the kernels agree
    with the same step through the plain norm, and on an SSD family the
    plain scan (``TRAIN_TOL``; at mamba2's 48 layers ``TRAIN_TOL_DEEP``,
    and the same step in f32 compute by ``TRAIN_TOL``, the reason beside
    them); (d) accum 2 of ``micro`` rows agrees with
    accum 1 of 2 x ``micro`` rows; (e) the planted faults (the backward's
    dw zeroed; on an SSD family the scan backward's dB times the group's
    head count; the second microbatch's gradient dropped) fail (c) and
    (d); (f) a save at step ``ckpt_at``, restored into a fresh state and
    continued, ends at the uninterrupted run's params (rtol 1e-5 / atol
    1e-6, the reference's bar); (g) the launch identities of RMSNorm
    forward and backward and, on an SSD family, of the scan forward (its
    remat recompute included) and backward; (h) peak device memory under
    80 GB.  Returns the main path's launches (the timed run).
    ``device="cpu"`` rehearses it on a tiny config (no memory bar, no
    launches)."""
    import shutil
    import statistics

    import torch

    from repro_torch import kernels
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get
    from repro_torch.core import UMTRuntime
    from repro_torch.data import UMTPrefetcher
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    from repro_torch.models import attention, blocks, layers, lm, ssm
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.optim import OptHParams, adamw_init
    from repro_torch.steps import make_grad_step, make_train_step

    t_phase = time.perf_counter()
    phase = PHASES[name]
    tr = phase["train"]
    accum, micro, seq, n = tr["accum"], tr["micro"], tr["seq"], tr["steps"]
    tokens = accum * micro * seq
    n_ssm = kind_layers(cfg, "ssm")
    counted = ("rms_norm", "rms_norm_bwd") + (
        ("ssd_scan", "ssd_scan_bwd") if n_ssm else ())
    card = device == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    if card:
        torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, torch.Generator(device).manual_seed(seed),
                            device, dtype=cfg.param_dtype)
    ssm_gain(params)
    names = leaf_names(params, "params")
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_blocks = sum(t.numel() for t in tree_leaves(params["blocks"]))
    full = get(arch_of(cfg)).n_layers
    cut = (f" ({phase.get('cut', 'cut for this run')})"
           if cfg.n_layers < full else "")
    log(f"{name} ({smi}): {cfg.n_layers} of {full} layers{cut}; "
        f"{n_params / 1e9:.3f} B params ({cfg.param_dtype} masters, "
        f"{cfg.dtype} compute, {cfg.opt_dtype} AdamW state, remat "
        f"{cfg.remat}); microbatches {micro} x {seq}, accum {accum}")
    src = FixedBatch(cfg.vocab, accum, micro, seq, seed + 1, device)
    batch = src.batch
    grad_step = make_grad_step(cfg)

    def launches():
        return {k: getattr(kernels, k).launches.value for k in counted}

    def identities(got, micro_steps, what):
        want, text = train_identities(cfg, got, micro_steps)
        if card and got != want:
            raise AssertionError(f"{name}: launches {got} != {want} "
                                 f"({what}; identity of the train path)")
        return text

    # (b), (c), (e): one step's gradients, kernels against the plain norm
    for k in counted:
        getattr(kernels, k).launches.reset()
    g_k, loss_k = grad_step(params, batch)
    sync()
    log(f"{name}: launch identities (one grad step): "
        + identities(launches(), accum, "one grad step"))
    bad = [nm for nm, g in zip(names, tree_leaves(g_k))
           if not bool(torch.isfinite(g).all()) or g.abs().max().item() == 0]
    if bad or not torch.isfinite(loss_k):
        raise AssertionError(f"{name}: loss {float(loss_k)}; leaves with a "
                             f"zero or non-finite gradient: {bad}")
    log(f"{name}: (b) every one of {len(names)} parameter leaves has a "
        "finite, nonzero gradient")
    plain = [(m, "rms_norm", kernels.rms_norm_ref)
             for m in (attention, blocks, layers, lm, ssm)]
    if n_ssm:
        plain.append((ssm, "ssd_scan", kernels.ssd_scan_ref))

    def dw_zeroed(x, w, dy, rstd):
        dx, dw = kernels.rms_norm_bwd(x, w, dy, rstd)
        return dx, torch.zeros_like(dw)
    # the wrapper counts through its module's name, which the swap takes
    dw_zeroed.launches = kernels.rms_norm_bwd.launches

    def db_times_heads(*args, **kw):
        dx, ddt, da, db, dc = kernels.ssd_scan_bwd(*args, **kw)
        return dx, ddt, da, db * (cfg.ssm_nheads // cfg.ssm_ngroups), dc
    db_times_heads.launches = kernels.ssd_scan_bwd.launches
    faults = [("dw zeroed", (rms_ops, "rms_norm_bwd", dw_zeroed))]
    if n_ssm:
        faults.append((f"the scan backward's dB times the group's "
                       f"{cfg.ssm_nheads // cfg.ssm_ngroups} heads",
                       (ssd_ops, "ssd_scan_bwd", db_times_heads)))

    def compare(g_a, l_a, g_b, l_b, what, tol=TRAIN_TOL):
        gaps = grad_gaps(g_a, g_b)
        n_a = torch.stack([g.float().norm() for g in tree_leaves(g_a)]
                          ).norm().item()
        n_b = torch.stack([g.float().norm() for g in tree_leaves(g_b)]
                          ).norm().item()
        dl = abs(float(l_a) - float(l_b)) / abs(float(l_b))
        dn = abs(n_a - n_b) / n_b
        gap, where = worst_gap(gaps, names)
        ok = dl <= tol["loss"] and dn <= tol["grad_norm"] \
            and gap <= tol["leaf"]
        log(f"{name}: {what}: loss {float(l_a):.6f} vs {float(l_b):.6f} "
            f"(rel {dl:.3e}), grad norm {n_a:.6f} vs {n_b:.6f} (rel "
            f"{dn:.3e}), worst leaf {where} rel {gap:.3e}, median leaf "
            f"{statistics.median(gaps):.3e} -> "
            f"{'within' if ok else 'outside'} {tol}")
        return ok

    plain_what = "plain norm" + (" and scan" if n_ssm else "")
    tol = phase.get("tol", TRAIN_TOL)
    with swapped(*plain):
        g_p, loss_p = grad_step(params, batch)
    if not compare(g_k, loss_k, g_p, loss_p,
                   f"(c) kernels vs {plain_what}", tol):
        raise AssertionError(f"{name}: (c) the kernels' step disagrees "
                             f"with the {plain_what}'s")
    for what, swap in faults if card else ():   # the CPU has no backward
        with swapped(swap):                        # kernels
            g_f, loss_f = grad_step(params, batch)
        if compare(g_f, loss_f, g_p, loss_p, f"(e) planted: {what}", tol):
            raise AssertionError(f"{name}: (c) does not reject the "
                                 f"backward with {what}")
        del g_f
    del g_p
    if tol is not TRAIN_TOL:    # (c) again in f32 compute, by TRAIN_TOL
        step32 = make_grad_step(cfg.replace(dtype="float32"))
        g_a, loss_a = step32(params, batch)
        with swapped(*plain):
            g_b, loss_b = step32(params, batch)
        if not compare(g_a, loss_a, g_b, loss_b,
                       f"(c) in f32 compute: kernels vs {plain_what}"):
            raise AssertionError(f"{name}: (c) the kernels' f32 step "
                                 f"disagrees with the {plain_what}'s")
        del g_a, g_b

    # (d), (e): accum 2 of micro rows against accum 1 of 2 * micro rows
    whole = {k: v.reshape(1, accum * micro, seq) for k, v in batch.items()}
    g_1, loss_1 = grad_step(params, whole)
    if not compare(g_k, loss_k, g_1, loss_1,
                   f"(d) accum {accum} x {micro} vs accum 1 x "
                   f"{accum * micro}"):
        raise AssertionError(f"{name}: (d) accumulation disagrees with "
                             "one large microbatch")
    calls = [0]
    fwd = lm.forward

    def second_dropped(*a, **kw):
        out = fwd(*a, **kw)
        calls[0] += 1
        if calls[0] == 2:          # the second microbatch: no gradient
            lg = out["logits"]
            out = dict(out, logits=lg.detach() + 0 * lg)
        return out
    from repro_torch import steps as steps_mod
    with swapped((steps_mod, "forward", second_dropped)):
        g_d, loss_d = grad_step(params, batch)
    if compare(g_d, loss_d, g_1, loss_1,
               "(e) planted: second microbatch's gradient dropped"):
        raise AssertionError(f"{name}: (d) does not reject the dropped "
                             "microbatch")
    del g_k, g_1, g_d
    gc.collect()
    if card:
        torch.cuda.empty_cache()

    # (a), (f), (g): the main path, then a restore and its continuation
    hp = OptHParams(**tr["hp"])
    state = {"params": params, "opt": adamw_init(params, cfg.opt_dtype),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    del params
    step_fn = make_train_step(cfg, hp)
    ckpt = ROOT / "build" / "train_phase_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    losses, times = [], []
    with deterministic(), UMTRuntime(n_cores=2, umt=True) as rt:
        mgr = CheckpointManager(str(ckpt), rt=rt, keep=1)
        pf = UMTPrefetcher(src, rt, depth=2)
        for k in counted:
            getattr(kernels, k).launches.reset()
        for step in range(n):
            t0 = time.perf_counter()
            if card and step == tr["ckpt_at"]:   # the first step the
                # checkpoint's writes overlap, traced: host or device?
                (state, m), host_s, busy_s, _ = traced(
                    lambda: step_fn(state, pf.get(step)))
                log(f"{name}: the step after the save, traced: host "
                    f"{host_s * 1e3:.2f} ms, device busy "
                    f"{busy_s * 1e3:.2f} ms")
            else:
                state, m = step_fn(state, pf.get(step))
            losses.append(float(m["loss"]))             # waits for the step
            times.append(time.perf_counter() - t0)
            if step + 1 == tr["ckpt_at"]:
                t0 = time.perf_counter()
                mgr.save(state, step + 1, wait=False)
                t_snap = time.perf_counter() - t0
        got = launches()
        sync()
        t0 = time.perf_counter()
        mgr.wait()
        t_wait = time.perf_counter() - t0
        host = rt.stats()
        straight = [t.to("cpu") for t in tree_leaves(state["params"])]
        template = tree_map(lambda t: torch.empty(
            t.shape, dtype=t.dtype, device="meta"), state)
        del state, m
        gc.collect()
        if card:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with host_rise() as rise:
            state, rstep = mgr.restore(template, device=device)
        t_restore = time.perf_counter() - t0
        if rstep != tr["ckpt_at"] or int(state["step"]) != rstep:
            raise AssertionError(f"{name}: restored step {rstep} / "
                                 f"{int(state['step'])}")
        clean = times[2:rstep]      # no checkpoint write in flight
        for step in range(rstep, n - 1):
            t0 = time.perf_counter()
            state, m = step_fn(state, pf.get(step))
            m["loss"].item()
            clean.append(time.perf_counter() - t0)
        if card:                    # the last step traced: where time goes
            (state, m), host_s, busy_s, top = traced(
                lambda: step_fn(state, pf.get(n - 1)))
            log(f"{name}: one step traced: host {host_s * 1e3:.2f} ms, "
                f"device busy {busy_s * 1e3:.2f} ms (idle share "
                f"{1 - busy_s / host_s:.3f}); largest kernels: "
                + ", ".join(f"{k} {v:.2f}" for k, v in top[:8]))
        else:
            state, m = step_fn(state, pf.get(n - 1))
        worst = 0.0
        for i, (a, b) in enumerate(zip(straight,
                                       tree_leaves(state["params"]))):
            a = a.to(device)
            if not torch.allclose(b, a, rtol=1e-5, atol=1e-6):
                raise AssertionError(
                    f"{name}: (f) {names[i]} after restore + "
                    f"{n - rstep} steps differs from the uninterrupted "
                    f"run by {(b - a).abs().max().item():.3e}")
            worst = max(worst, (b - a).abs().max().item())
    shutil.rmtree(ckpt, ignore_errors=True)
    log(f"{name}: (f) saved at step {tr['ckpt_at']} (host snapshot "
        f"{t_snap:.2f} s, writes done {t_wait:.2f} s after the last "
        f"step), restored in {t_restore:.2f} s (host memory up by at "
        f"most {rise['gb']:.2f} GB meanwhile), {n - rstep} steps on: "
        f"params equal the uninterrupted run's (max |diff| {worst:.3e}; "
        "rtol 1e-5 / atol 1e-6)")
    log(f"{name}: launch identities ({n} steps): "
        + identities(got, n * accum, f"{n} train steps"))
    log(f"{name}: losses " + " ".join(f"{x:.4f}" for x in losses))
    if not (losses[0] == losses[0] and abs(losses[0]) < float("inf")) \
            or losses[-1] > losses[0] - LOSS_DROP:
        raise AssertionError(f"{name}: (a) loss {losses[0]:.4f} -> "
                             f"{losses[-1]:.4f}, not down by {LOSS_DROP}")
    peak = torch.cuda.max_memory_allocated() if card else 0
    if peak >= 80e9:
        raise AssertionError(f"{name}: (h) peak memory {peak / 1e9:.2f} GB")
    # the steady step: after warm-up, with no checkpoint write in flight
    # (steps 3-5 and the restored run's untraced steps); the steps the
    # writes overlap are printed as they came
    s_step = statistics.median(clean)
    flops = 6 * n_params * tokens + 2 * n_blocks * tokens
    log(f"{name} ({smi}): s/step {s_step:.4f} (median of {len(clean)} "
        f"steps with no checkpoint write in flight: "
        f"{' '.join(f'{t:.3f}' for t in clean)}; the first run's steps: "
        f"{' '.join(f'{t:.3f}' for t in times)}), trained tokens/s "
        f"{tokens / s_step:.1f}, model FLOP rate {flops / s_step / 1e12:.1f} "
        f"TFLOP/s = {flops / s_step / BF16_FLOPS:.4f} of 989 (6 x "
        f"{n_params / 1e9:.3f} B params x {tokens} tokens + remat 2 x "
        f"{n_blocks / 1e9:.3f} B x {tokens} = {flops / 1e12:.1f} TFLOP a "
        f"step; attention's and the scan's products not counted), peak device memory "
        f"{peak / 1e9:.2f} GB (under 80), host runtime: cpu_util "
        f"{host['cpu_util']:.3f}, wakes {host['wakes']}, oversub "
        f"{host['oversub_frac']:.4f}, prefetches reissued {pf.reissued}; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    del state, m, straight, template
    return got


def check_train_cli(smi, device="cuda"):
    """The port's train CLI (``repro_torch.launch.train``) on the card
    through the train_100m example (``repro_torch.examples.train_100m``,
    ``TRAIN_100M``): 30 steps with checkpoints every 10 (UMT on); the run
    resumed from its step-10 checkpoint; and 30 steps with ``--umt-off``
    (into a directory of its own: the example always resumes); then
    mamba2-780m's tiny shape (``TRAIN_CLI_SSM``) through the CLI itself,
    which must launch the SSD kernels.  Bars: the resumed run's
    losses are the first run's from step 10 on, and UMT on and off give
    the same losses (the host runtime must not change the numbers); both
    under deterministic algorithms.  Each leg's kernels launch; each
    leg's median s/step and host stats are printed.  ``device="cpu"``
    rehearses it (no launches there)."""
    import io
    import shutil
    import statistics

    import numpy as np

    from repro_torch import kernels
    from repro_torch.examples import train_100m
    from repro_torch.launch import train as cli

    ckpt = ROOT / "build" / "train_cli_ckpt"
    ckpt_off = ROOT / "build" / "train_cli_ckpt_off"
    for d in (ckpt, ckpt_off):
        shutil.rmtree(d, ignore_errors=True)

    def run(leg, extra, main=None, used=("rms_norm", "rms_norm_bwd")):
        for k in used:
            getattr(kernels, k).launches.reset()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            if main is None:
                train_100m.main(TRAIN_100M + ["--device", device] + extra)
            else:
                main(extra + ["--device", device])
        lines = [json.loads(ln) for ln in out.getvalue().splitlines()
                 if ln.startswith("{")]
        steps = {ln["step"]: ln for ln in lines if "step" in ln}
        got = {k: getattr(kernels, k).launches.value for k in used}
        if device == "cuda" and min(got.values()) <= 0:
            raise AssertionError(f"train CLI {leg}: launches {got}")
        end = lines[-1]
        first, last = min(steps), max(steps)
        s_step = statistics.median(steps[s]["s_per_step"]
                                   for s in steps if s > first)
        log(f"train CLI {leg} ({smi}): steps {first}-{last}, losses "
            f"{steps[first]['loss']} -> {steps[last]['loss']}, median "
            f"s_per_step {s_step:.4f}, "
            f"wall_s {end['wall_s']}, host_cpu_util {end['host_cpu_util']}, "
            f"host_wakes {end['host_wakes']}, host_oversub "
            f"{end['host_oversub']}; launches {got}")
        return {s: ln["loss"] for s, ln in steps.items()}

    with deterministic():
        on = run("UMT on", ["--ckpt-dir", str(ckpt), "--ckpt-every", "10"])
        for s in (20, 30):                # resume from the step-10 save
            shutil.rmtree(ckpt / f"step_{s:06d}")
        resumed = run("resumed at step 10", ["--ckpt-dir", str(ckpt),
                                              "--resume"])
        off = run("UMT off", ["--ckpt-dir", str(ckpt_off), "--umt-off"])
    for d in (ckpt, ckpt_off):
        shutil.rmtree(d, ignore_errors=True)
    if sorted(resumed) != list(range(10, 30)) or any(
            resumed[s] != on[s] for s in resumed):
        raise AssertionError(f"train CLI: the resumed losses {resumed} do "
                             f"not continue the run's {on}")
    if off != on:
        raise AssertionError(f"train CLI: UMT off gives {off}, on {on}")
    log("train CLI: the resumed run's 20 losses are the first run's; UMT "
        "on and off give the same 30 losses")
    # an SSD family through the CLI: the scan's kernels, forward and
    # backward, and finite losses
    ssm = run("mamba2-780m", TRAIN_CLI_SSM, cli.train,
              ("rms_norm", "rms_norm_bwd", "ssd_scan", "ssd_scan_bwd"))
    if not all(np.isfinite(v) for v in ssm.values()):
        raise AssertionError(f"train CLI mamba2-780m: losses {ssm}")


# ------------------------------------------------------------------ tools
# The launch tools (``repro_torch.launch``), remat "dots" and the examples,
# after the CLIs.  The dry run (``launch.dryrun``) runs on meta, on the
# host alone: the CPU tests drive it (``tests/test_torch_launch.py``),
# not this script, whose phases it would share the host with (or, after
# them, lengthen by 45.1 s).
# ``launch.profile_cell`` on the card, each cell cut to fit the section's
# time: qwen2.5-14b's 32k prefill at batch 1 and 8 of 48 layers (flash and
# RMSNorm), mamba2-780m's train step at the train phase's microbatch of 4
# x 1024, accum 1, all 48 layers (RMSNorm and the SSD scan, forward and
# backward); each with the kernels its call must launch
PROFILE_CELLS = (
    (dict(arch="qwen2.5-14b", shape_name="prefill_32k", layers=8, batch=1),
     ("flash_attention", "rms_norm")),
    (dict(arch="mamba2-780m", shape_name="train_4k", batch=4, seq=1024,
          accum=1),
     ("rms_norm", "rms_norm_bwd", "ssd_scan", "ssd_scan_bwd")),
)
# remat "dots" against "full": one grad step of qwen2.5-14b at full
# width and ``REMAT_LAYERS`` of 48 layers on the train phases' ``TRAIN``
# batch.  Both run the
# same kernels on the same inputs: "full" recomputes every product and
# kernel of a repeat in the backward, "dots" keeps the products' outputs
# and recomputes the kernels (launched through ctypes, out of the
# policy's sight).  The loss is held by ``TRAIN_TOL``, each gradient
# leaf row by row by ``ROW_TOL``.
REMAT_LAYERS = 4


def check_remat_dots(smi, seed=0):
    """Remat "dots" against "full" on the card (``REMAT_LAYERS``): loss
    and gradients, and each one's peak memory and seconds."""
    import torch

    from repro_torch.configs import get
    from repro_torch.models import lm
    from repro_torch.models.layers import tree_leaves
    from repro_torch.steps import make_grad_step

    cfg = get("qwen2.5-14b").replace(n_layers=REMAT_LAYERS)
    params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(seed),
                            "cuda", dtype=cfg.param_dtype)
    names = leaf_names(params, "params")
    batch = FixedBatch(cfg.vocab, TRAIN["accum"], TRAIN["micro"],
                       TRAIN["seq"], seed + 1).batch
    res = {}
    for remat in ("full", "dots"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        g, loss = make_grad_step(cfg.replace(remat=remat))(params, batch)
        loss = float(loss)
        res[remat] = (g, loss, torch.cuda.max_memory_allocated(),
                      time.perf_counter() - t0)
    (g_f, l_f, p_f, t_f), (g_d, l_d, p_d, t_d) = res["full"], res["dots"]
    dl = abs(l_d - l_f) / abs(l_f)
    rows = [(row_rel(d.reshape(-1, d.shape[-1]), f.reshape(-1, f.shape[-1])),
             nm) for nm, d, f in zip(names, tree_leaves(g_d),
                                     tree_leaves(g_f))]
    (rms, worst), where = max(rows, key=lambda r: r[0][1])
    log(f"remat dots vs full (qwen2.5-14b-train, {REMAT_LAYERS} layers, "
        f"{smi}): loss {l_d:.6f} vs {l_f:.6f} (rel {dl:.3e}); worst leaf "
        f"{where}: row error RMS {rms:.3e} / worst {worst:.3e}; peak "
        f"memory dots {p_d / 1e9:.2f} GB, full {p_f / 1e9:.2f} GB; grad "
        f"step {t_d:.2f} s vs {t_f:.2f} s")
    if dl > TRAIN_TOL["loss"] or any(
            r > ROW_TOL["rms"] or w > ROW_TOL["worst"]
            for (r, w), _ in rows):
        raise AssertionError(f"remat dots: gradients differ from full's "
                             f"(loss rel {dl:.3e}, worst leaf {where} "
                             f"{rms:.3e} / {worst:.3e}; {TRAIN_TOL['loss']}"
                             f", {ROW_TOL})")
    del params, res, g_f, g_d


# io_overlap_demo's timed steps in the script (its default is 14): both
# legs took 17.9 s of the tools section at 14 on an H100 machine
IO_DEMO_STEPS = 7


def check_examples(smi):
    """The examples on the card (``repro_torch.examples``; train_100m runs
    in ``check_train_cli``): quickstart, whose UMT leg must beat its
    baseline leg on this host; serve_batch (tiny jamba, one shot and
    engine: f32 flash at head dim 16); io_overlap_demo, both walls
    printed."""
    import numpy as np

    from repro_torch.examples import io_overlap_demo, quickstart, serve_batch

    q = quickstart.main(["--device", "cuda"])
    log(f"quickstart ({smi}): 4 x 0.2 s blocking ops on one core: umt off "
        f"{q['umt_off_s']:.3f} s, umt on {q['umt_on_s']:.3f} s; tiny "
        f"mixtral losses {q['losses'][0]:.4f} -> {q['losses'][-1]:.4f}")
    if not q["umt_on_s"] < q["umt_off_s"]:
        raise AssertionError(f"quickstart: UMT {q['umt_on_s']:.3f} s is not "
                             f"faster than without {q['umt_off_s']:.3f} s")
    oneshot, engine = serve_batch.main(["--device", "cuda"])
    if np.asarray(oneshot).shape != (4, 12) \
            or np.asarray(engine).shape != (8, 12):
        raise AssertionError(f"serve_batch: tokens {np.asarray(oneshot).shape}"
                             f" / {np.asarray(engine).shape}")
    io_ = io_overlap_demo.main(["--device", "cuda", "--steps",
                                str(IO_DEMO_STEPS + 1)])
    log(f"io_overlap_demo ({smi}): {IO_DEMO_STEPS} steps with a fsync'd "
        f"checkpoint each: synchronous {io_['sync_s']:.2f} s, UMT "
        f"{io_['umt_s']:.2f} s")


def check_tools(smi):
    """The tools section on the card: ``profile_cell`` for
    ``PROFILE_CELLS``, remat "dots" and the examples.  The counters are
    zeroed before and read after, like a phase's; returns the launches."""
    import torch

    from repro_torch import kernels
    from repro_torch.launch import profile_cell

    t0 = time.perf_counter()
    for k in profile_cell.COUNTED:
        getattr(kernels, k).launches.reset()
    for cell, used in PROFILE_CELLS:
        t1 = time.perf_counter()
        r = profile_cell.profile(**cell)
        sys.stdout.flush()
        # one stream: the kernels of a call cannot outlast the call
        if not (r["share"] and r["share"] > 0) \
                or r["device_ms"] > r["host_ms"] \
                or min(r["launches"][k] for k in used) <= 0:
            raise AssertionError(f"profile_cell {cell}: share {r['share']}, "
                                 f"device {r['device_ms']} ms, host "
                                 f"{r['host_ms']} ms, launches "
                                 f"{r['launches']}")
        log(f"profile_cell {cell['arch']} {cell['shape_name']} ({smi}): "
            f"device {r['device_ms']:.2f} ms, host {r['host_ms']:.2f} ms, "
            f"bound {r['bound_ms']:.2f} ms ({r['bottleneck']}), share "
            f"{r['share']:.4f}; peak {r['peak'] / 1e9:.2f} GB against the "
            f"meta estimate {r['peak_meta'] / 1e9:.2f}; "
            f"{time.perf_counter() - t1:.1f} s")
        del r
        gc.collect()
        torch.cuda.empty_cache()
    for part in (check_remat_dots, check_examples):
        t1 = time.perf_counter()
        part(smi)
        log(f"{part.__name__}: {time.perf_counter() - t1:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    got = {k: getattr(kernels, k).launches.value
           for k in profile_cell.COUNTED}
    log(f"tools section: launches {got}; {time.perf_counter() - t0:.1f} s")
    return got


# ------------------------------------------------------ tensor parallelism
# The TP section (``tp_section``): one pair of ranks (this process and one
# follower, ``repro_torch.launch.mesh``) serves four families in turn at
# full width: two ranks on the one card over gloo when the machine has
# one card, on two cards over nccl when it has two or more.  qwen2.5-14b
# is the main path (flash prefill and the paged insert, paged-kernel
# decode) at 2 of 48 layers (12 before, cut for the script's time when
# the FSDP section came, 4 until the mixtral leg came: its planted faults
# trailed by 1.3405 / 8.5938 and 1.4377 / 9.5469 at 12, by 1.2699 /
# 7.2734 and 1.4204 / 10.2656 at 4, against bars of 0.3 / 1.0) with
# qwen's mix,
# 8 requests of {256, 512,
# 1024, 2048} tokens, each length twice (16 until the replicated-heads
# section came: its 1,3 leg's time paid for by this cut and mixtral's;
# the faults' check runs the 4 shortest requests either way), 16 slots,
# cache_len 2080, page 8; minicpm3-4b (the paged MLA decode) and
# mamba2-780m (the SSD scan in prefill, conv weights times
# ``SSM_CONV_W_GAIN``), 8 requests each:
# minicpm3-4b at 2 layers (4 before, cut for the script's time),
# mamba2-780m at 4.  Planted TP faults, each on every rank: the all-reduce
# after the attention output projection left out (each rank adds only
# its own heads' share); each rank's query heads taken from the next
# rank's columns of wq (minicpm3: of wq_b), so they attend with KV groups
# not theirs; mamba2's gated norm with per-rank statistics.
TP_TRAFFIC = dict(slots=16, cache_len=2080, lens=(256, 512, 1024, 2048),
                  each=True, gen=32)
TP_LEGS = {
    "qwen2.5-14b": dict(layers=2, n_req=8, paged_kernel=True,
                        faults=("wo_all_reduce_left_out", "wq_next_rank"),
                        kernels={"paged_decode_attention": "decode",
                                 "flash_attention": "prefill"}),
    "minicpm3-4b": dict(layers=2, n_req=8, paged_kernel=True,
                        faults=("wo_all_reduce_left_out", "wq_next_rank"),
                        kernels={"paged_mla_decode_attention": "decode"}),
    # the per-rank statistic moves each rank's half of the gated norm by
    # the ratio of its own sum of squares to the half of the whole: at 4
    # layers over 4 requests x 8 positions (an H100 run) 0.5360 relative
    # but a worst gap of 0.7969, so its check runs every request and
    # position; at 2 layers even that is too little (0.4424 relative, a
    # gap of 0.7031 in a full-width rehearsal on the CPU), so the leg
    # keeps 4
    "mamba2-780m": dict(layers=4, n_req=8, paged_kernel=False,
                        faults=("gated_norm_per_rank",), fault_req=8,
                        fault_pos=32, kernels={"ssd_scan": "prefill"}),
    # MoE under tensor parallelism: every expert on both ranks at half its
    # d_ff columns, the dropless dispatch as its single-rank phase serves
    # it, mixtral's traffic (prompts of 1024 to 8192 tokens: half of them
    # pass the 4096 window, 6144 no multiple of it, so every rank rolls
    # its ring of its 4 KV heads; 4 requests, each length once, since the
    # replicated-heads section came: 8 before, whose 8192-token prefills
    # each all-reduced 5 x 134 MB of f32 through gloo; the faults' check
    # runs the 4 either way).  Its sliding-window rings decode
    # without the paged kernel, as in the single-rank phase.  Planted: the
    # rank's partial MoE output added unsummed; each rank's w_gate columns
    # taken from the next rank's.  The route check and the expert ids'
    # digests run on the step path as built (``tp_path_check``)
    "mixtral-8x7b": dict(layers=2, n_req=4, paged_kernel=True,
                         traffic=MIXTRAL_TRAFFIC, moe_impl="ragged",
                         faults=("moe_all_reduce_left_out",
                                 "moe_ff_next_rank"),
                         kernels={"flash_attention": "prefill",
                                  "paged_decode_attention": None}),
}
# Replicated heads (``tp_heads_section``; ``--phases tp_heads``): three
# ranks on a 1,3 mesh (gloo on the one card, nccl on three), qwen2.5-14b
# at full width and 2 of 48 layers as the TP section's qwen leg: 40 query
# and 8 KV heads do not split 3 ways, and neither do wq's, wo's 5120
# columns, so every rank holds and runs every head (flash and the paged
# decode at 40/8 against a whole pool of 8 KV heads) with no collective
# after the attention; d_ff 13824 and the vocab 152064 split in thirds.
# 8 requests.  Planted: each rank's w_gate columns taken from the next
# rank's (its MLP's thirds misplaced) and the whole attention output
# all-reduced, as a cut wo's partials would be (3 times the output: a
# fault of replicated heads).  The mid-head gather of 16-way layouts runs
# in the CPU tests only (``tests/test_torch_tp_heads.py``): 16 ranks on
# one card do not fit the script's time.
TP_HEADS_LEGS = {
    "qwen2.5-14b-heads": dict(arch="qwen2.5-14b", layers=2, n_req=8,
                              paged_kernel=True,
                              faults=("ff_next_rank",
                                      "wo_whole_all_reduced"),
                              kernels={"paged_decode_attention": "decode",
                                       "flash_attention": "prefill"},
                              # the CPU rehearsal's tiny shape keeps the
                              # layout: heads and wq whole, d_ff and the
                              # vocab in thirds
                              tiny=dict(n_heads=10, n_kv_heads=2, d_ff=192,
                                        vocab=264)),
}
# a leg's traffic (``traffic``, by default TP_TRAFFIC; ``n_req`` is the
# leg's, each length n_req / 4 times); on the CPU (a rehearsal at the
# tiny configs) prompts of 8 to 32 tokens, and the windowed configs'
# window cut to ``TP_CPU_WINDOW`` so that prompts pass it (24: no
# multiple)
TP_CPU_TRAFFIC = dict(slots=8, cache_len=48, lens=(8, 16, 24, 32), gen=8)
TP_CPU_WINDOW = 16
# the planted faults' path check runs over this many of a leg's requests,
# the shortest prompts first, and their first this many positions (the
# as-built path over every request and position), unless the leg says
# otherwise (``fault_req``, ``fault_pos``)
TP_FAULT_REQ = 4
TP_FAULT_POS = 8


class TPWeights:
    """The TP legs' weights on every rank: the seeded init of the serve
    phases (``weights_task``'s, conv weights times ``SSM_CONV_W_GAIN``),
    made whole on the rank's device and cut to its shard."""
    per_rank = True

    def __init__(self, seed=0):
        self.seed = seed

    def __call__(self, cfg, mesh, device):
        import torch

        from repro_torch.models.lm import init_params
        from repro_torch.params import shard_params

        full = init_params(cfg, torch.Generator(device).manual_seed(
            self.seed), device)
        ssm_gain(full)
        return shard_params(full, cfg, mesh)


def make_forced_decode(cfg, *, cache_len, page_size=None, paged_kernel=False,
                       mesh=None):
    """The path check's decode: the engine's decode forward fed given
    tokens at given per-slot positions, returning the tick's f32 logits
    (B, V) and the cache (updated in place), under the TP serve rules on
    ``mesh``."""
    import contextlib

    from repro_torch.models.lm import forward
    from repro_torch.sharding import sharding_ctx
    from repro_torch.steps import TP_SERVE_RULES, cast_tree

    def step(params, cache, tokens, pos, table=None):
        pages = None if page_size is None else {
            "table": table, "page_size": page_size, "cache_len": cache_len,
            "kernel": paged_kernel}
        ctx = (sharding_ctx(mesh, TP_SERVE_RULES) if mesh is not None
               else contextlib.nullcontext())
        with ctx:
            out = forward(cast_tree(params, cfg.dtype), cfg, tokens,
                          mode="decode", pos=pos, cache=cache, pages=pages)
        return out["logits"][:, 0].float(), out["cache"]

    return step


def _wo_all_reduce_left_out(x):
    return x


def _per_rank_gated_norm(x, z, w, eps=1e-5, width=None):
    from repro_torch.models.layers import gated_rms_norm

    return gated_rms_norm(x, z, w, eps)


def tp_fault_on(state, name):
    """``Session.run``: plant TP fault ``name`` on this rank (kept in
    ``state.extra`` until ``tp_fault_off``)."""
    from repro_torch.models import attention as att
    from repro_torch.models import moe, ssm

    if name == "wo_all_reduce_left_out":
        ctx = swapped((att, "tp_all_reduce", _wo_all_reduce_left_out))
    elif name == "moe_all_reduce_left_out":
        ctx = swapped((moe, "tp_all_reduce", _wo_all_reduce_left_out))
    elif name == "gated_norm_per_rank":
        ctx = swapped((ssm, "gated_rms_norm", _per_rank_gated_norm))
    elif name == "wq_next_rank":
        ctx = _next_rank(state, "mixer", ("wq", "bq", "wq_b"))
    elif name == "moe_ff_next_rank":
        ctx = _next_rank(state, "mlp", ("w_gate",), moe=True)
    elif name == "ff_next_rank":
        ctx = _next_rank(state, "mlp", ("w_gate",))
    elif name in HEADS_FAULTS:
        ctx = swapped(_heads_faults()[name])
    else:
        raise ValueError(name)
    ctx.__enter__()
    state.extra[name] = ctx
    return state.mesh.rank


def tp_fault_off(state, name):
    state.extra.pop(name).__exit__(None, None, None)


@contextlib.contextmanager
def _next_rank(state, part, keys, moe=False):
    """Each rank's block of the leaves ``keys`` of each layer's ``part``
    (``"mixer"``: its query columns ``wq``, ``bq``, MLA ``wq_b``;
    ``"mlp"`` of the MoE layers (``moe``): the experts' ``w_gate``
    columns) replaced by the next rank's, gathered over the data plane;
    restored after."""
    import torch

    mesh, n = state.mesh, state.mesh.size
    saved = []
    for blk in state.params["blocks"]:
        leaves = blk.get(part, {})
        if moe and "router" not in leaves:
            continue
        for key in keys:
            if key in leaves:
                parts = mesh.all_gather(leaves[key].float())
                saved.append((leaves, key, leaves[key]))
                leaves[key] = parts[(mesh.rank + 1) % n].to(
                    leaves[key].dtype)
                del parts
    if state.device.type == "cuda":
        torch.cuda.empty_cache()
    try:
        yield
    finally:
        for leaves, key, t in saved:
            leaves[key] = t


def tp_peak(state, reset=False):
    """``Session.run``: this rank's peak device memory (bytes), zeroed
    after reading when ``reset``; 0 on the CPU."""
    import torch

    if state.device.type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated(state.device)
    if reset:
        torch.cuda.reset_peak_memory_stats(state.device)
    return peak


def tp_routes_on(state):
    """``Session.run``: record this rank's MoE expert ids
    (``routes_recorded``) into ``state.extra["routes"]`` until
    ``tp_routes_off``."""
    store = state.extra["routes"] = []
    ctx = routes_recorded(store)
    ctx.__enter__()
    state.extra["routes_ctx"] = ctx
    return state.mesh.rank


def tp_routes_off(state, send=False):
    """``Session.run``: stop recording; (MoE calls, the ``serve.tp.
    digest`` of every recorded expert id in call order).  Rank 0 keeps
    its ids in ``state.extra["routes"]``, the followers drop theirs;
    with ``send`` every rank drops them and returns them too, on the
    host, as a third item."""
    import torch

    from repro_torch.serve.tp import digest

    state.extra.pop("routes_ctx").__exit__(None, None, None)
    store = state.extra["routes"]
    ids = (torch.cat([t.reshape(-1) for t in store]).to("cpu", torch.int32)
           if store else torch.zeros(0, dtype=torch.int32))
    if state.mesh.rank or send:
        del state.extra["routes"]
    if send:
        return len(store), digest(ids), [t.cpu() for t in store]
    return len(store), digest(ids)


def tp_path_check(sess, cfg, prompts, toks, ref, idx, faults,
                  paged_kernel, device, fault_req=TP_FAULT_REQ,
                  fault_pos=TP_FAULT_POS, traffic=TP_TRAFFIC):
    """The TP step path teacher-forced with the engine's tokens, on every
    rank: each prompt of ``idx`` through the prefill step and the insert
    into a pool of ``traffic``'s slots, then the tokens one tick at a
    time through the decode forward (paged kernel where the leg has one),
    as built (``None``) and under each planted fault of ``faults`` (on
    every rank).  ``ref``: the forward's logits per request, or, with MoE
    layers, a function that makes them from the expert ids of the path as
    built (``routes_recorded``'s store, rank 0's): every rank records its
    ids on that run, and their digests must be equal.  Returns (name ->
    the ``summary`` of ``tally``, the as-built logits, the ranks' (MoE
    calls, digest) or None)."""
    import numpy as np
    import torch

    from repro_torch.steps import (make_batched_insert_step,
                                   make_pool_step, make_prefill_step)

    slots, cache_len = traffic["slots"], traffic["cache_len"]
    ps = 8 if paged_kernel else None
    sp = sess.params
    prefill = sess.step("fprefill", make_prefill_step, cache_len=cache_len)
    insert = sess.step("finsert", make_batched_insert_step,
                       cache_len=cache_len, page_size=ps)
    pool_step = sess.step("fpool", make_pool_step, slots=slots,
                          cache_len=cache_len, dtype=cfg.dtype,
                          page_size=ps, device=device)
    decode = sess.step("fdecode", make_forced_decode, cache_len=cache_len,
                       page_size=ps, paged_kernel=paged_kernel)
    gen = len(toks[0])
    pps = cache_len // 8
    acc, built, ids = {}, None, None
    for name in (None, *faults):
        if name is not None:
            sess.run(tp_fault_on, name)
        routed = name is None and callable(ref)
        if routed:
            sess.run(tp_routes_on)
        sel = idx if name is None else idx[:fault_req]
        pad = slots - len(sel)
        pool = pool_step(1 + slots * pps if ps else None)
        table = torch.arange(1, 1 + slots * pps, dtype=torch.int32,
                             device=device).view(slots, pps)
        firsts = []
        for s, i in enumerate(sel):
            rows, lg = prefill(sp, torch.tensor(prompts[i][None],
                                                device=device))
            firsts.append(lg[0, -1].float())
            args = (pool, rows, 0, s) + ((table[s],) if ps else ())
            pool = insert(*args)
            del rows
        out = [torch.stack(firsts)]
        pos0 = torch.tensor([len(prompts[i]) for i in sel] + [0] * pad,
                            dtype=torch.int32, device=device)
        feed = torch.tensor(np.stack([toks[i] for i in sel]
                                     + [np.zeros(gen, np.int32)] * pad),
                            device=device)
        n_pos = gen if name is None else min(gen, fault_pos)
        for j in range(n_pos - 1):
            args = (sp, pool, feed[:, j:j + 1], pos0 + j) + (
                (table,) if ps else ())
            lg, pool = decode(*args)
            out.append(lg[:len(sel)])
        lg = torch.stack(out, dim=1)                  # (round, gen, V)
        del pool, out
        if routed:
            ids = sess.run(tp_routes_off)
            if any(d != ids[0] for d in ids):
                raise AssertionError(f"tp {cfg.name}: the ranks picked "
                                     f"other experts: {ids}")
            ref = ref(sess.local.extra.pop("routes"))
        if name is None:
            built = lg
        acc[name] = new_tally()
        tally(acc[name], lg, built[:len(sel), :n_pos],
              [r[:n_pos] for r in ref], [t[:n_pos] for t in toks], sel)
        if name is not None:
            sess.run(tp_fault_off, name)
    return summary(acc), built, ids


def tp_collectives(cfg, n):
    """(all-reduces a pass through the model, all-gathers a pass that
    makes logits, all-gathers a pass) of ``cfg`` on a model axis of
    ``n``, from its layout (``models.attention``, ``models.layers``): the
    vocab-parallel embedding's all-reduce and the logits' gather where
    the vocab splits; per layer an SSD mixer's two (the gated norm's
    statistic, the output), an attention's one where ``wo``'s rows are
    cut, and one gather where its heads are whole but a projection's
    columns are cut (GQA's q, k and v, or MLA's up-projections, in one
    collective); a dense or MoE MLP's one where d_ff splits."""
    reduces = gathers = 0
    for spec in cfg.pattern * (cfg.n_layers // len(cfg.pattern)):
        if spec.kind == "ssm":
            reduces += 2
        elif spec.attn == "mla":
            h = cfg.n_heads
            reduces += h * cfg.v_head_dim % n == 0
            gathers += h % n != 0 and any(
                c % n == 0 for c in (h * (cfg.qk_nope_dim + cfg.qk_rope_dim),
                                     h * cfg.qk_nope_dim,
                                     h * cfg.v_head_dim))
        else:
            h, hkv = cfg.n_heads, cfg.n_kv_heads
            q, kv = h * cfg.head_dim, hkv * cfg.head_dim
            # query heads whole where n does not divide them, or where a
            # split would read KV heads of uneven groups (``tp_heads``)
            q_whole = h % n != 0 or (hkv % n != 0
                                     and (h // hkv) % (h // n) != 0)
            reduces += q % n == 0
            gathers += (q % n == 0 and q_whole) or (
                kv % n == 0 and hkv % n != 0)
        reduces += spec.mlp != "none" and cfg.d_ff % n == 0
    split = cfg.vocab % n == 0
    return reduces + split, int(split), gathers


def tp_leg(mesh, arch, smi, device="cuda", seed=0, layers=None):
    """One TP leg (``arch``: a key of ``TP_LEGS`` or ``TP_HEADS_LEGS``,
    whose ``arch`` names the family where it differs): the engine on
    every rank, the checks on rank 0; returns the per-rank launch counts
    (summed) for the ``kernels`` line.  ``device="cpu"``: a rehearsal at
    the tiny config (with the leg's ``tiny`` overrides) and
    ``TP_CPU_TRAFFIC``."""
    import collections
    import dataclasses
    import threading

    import numpy as np
    import torch

    from repro_torch.configs import get
    from repro_torch.models.lm import param_meta
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.tp import counters, seen, tree_bytes
    from repro_torch.serve.watchdog import abandon
    from repro_torch.steps import init_paged_slot_cache, init_slot_cache

    leg = {**TP_LEGS, **TP_HEADS_LEGS}[arch]
    name, arch = arch, leg.get("arch", arch)
    t_leg = time.perf_counter()
    cuda = device == "cuda"
    cfg = get(arch)
    t = leg.get("traffic", TP_TRAFFIC)
    if not cuda:                        # the rehearsal's tiny shapes
        cfg, t = cfg.tiny(**leg.get("tiny", {})), TP_CPU_TRAFFIC
        cfg = cfg.replace(pattern=tuple(
            dataclasses.replace(spec, window=TP_CPU_WINDOW)
            if spec.window else spec for spec in cfg.pattern))
    n_layers = layers or leg["layers"]
    if n_layers != cfg.n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    cfg = cfg.replace(moe_impl=leg.get("moe_impl", cfg.moe_impl))
    moe = any(spec.mlp == "moe" for spec in cfg.pattern)
    slots, cache_len, gen, n_req = (t["slots"], t["cache_len"], t["gen"],
                                    leg["n_req"])
    rng = np.random.default_rng(seed)
    lens = rng.permutation(np.repeat(t["lens"], n_req // len(t["lens"])))
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    gaps = rng.exponential(0.03, n_req)
    paged = leg["paged_kernel"]
    eng = ServeEngine(cfg, TPWeights(seed), slots=slots, cache_len=cache_len,
                      mesh=mesh, page_size=8 if paged else "auto",
                      paged_kernel=paged, sync_ticks=True, device=device)
    sess = eng._tp
    sess.run(counters, True)
    sess.run(tp_peak, True)
    calls, lock = collections.Counter(), threading.Lock()

    def counting(fn, key):
        def run(*a, **kw):
            with lock:
                calls[key(kw) if callable(key) else key] += 1
            return fn(*a, **kw)
        return run
    eng.prefill = counting(eng.prefill, "prefill")
    eng.decode = counting(eng.decode, "decode")
    eng.replay = counting(eng.replay, "replay")
    if eng.chunk is not None:
        eng.chunk = counting(eng.chunk, lambda kw: "chunk"
                             if kw["want_logits"] else "chunk_mid")
    if eng.gather is not None:
        eng.gather = counting(eng.gather, "gather")
    reqs = [Request(i, prompts[i], max_new_tokens=gen) for i in range(n_req)]
    t0 = time.perf_counter()
    eng.start()
    for r, g in zip(reqs, gaps):
        eng.submit(r)
        time.sleep(float(g))
    eng.close()
    for r in reqs:
        if not r.done.wait(max(0.0, DRAIN_S - (time.perf_counter() - t0))):
            abandon(eng, f"tp {arch}: request {r.rid} not done")
    eng.join()
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = eng.stats()
    per_rank = sess.run(counters)
    peaks = sess.run(tp_peak)
    pools = sess.run(tree_bytes, eng.kv.cache)
    held = sess.run(tree_bytes, sess.params)
    handed = sess.run(seen, "decode")   # the last tick's tensor arguments
    num_pages = eng.kv.pager.capacity + 1 if eng.paged else None
    toks = [np.asarray(r.wait(), np.int32) for r in reqs]
    for r, tk in zip(reqs, toks):
        if len(tk) != gen:
            raise AssertionError(f"tp {arch}: request {r.rid}: {len(tk)} "
                                 "tokens")
    shared = mesh.backend == "gloo"
    n_tp = mesh.shape["model"]
    label = (f"{n_tp} ranks sharing one card (gloo)" if shared
             else f"{n_tp} cards ({mesh.backend})")
    log(f"tp [{name}] {label}, {smi}: d {cfg.d_model} layers "
        f"{cfg.n_layers} {cfg.dtype}, {n_req} requests x {gen} tokens, "
        f"{slots} slots; tokens_s {stats['tokens_out'] / wall:.2f} wall_s "
        f"{wall:.3f} p50_ttft_s {stats['p50_ttft_s']:.4f} p50_tick_s "
        f"{stats['p50_tick_s']:.4f} p99_tick_s {stats['p99_tick_s']:.4f}; "
        f"peak device memory per rank "
        f"{[round(p / 1e9, 2) for p in peaks]} GB"
        + (" (not a TP throughput: the ranks share the card)" if shared
           else ""))
    # launch identities on every rank (each rank launches per layer per
    # tick and prefill; a CPU rehearsal's plain versions launch nothing)
    for rank, got in enumerate(per_rank):
        if cuda:
            check_launches(cfg, got, stats, calls, name=arch,
                           kernels=leg["kernels"])
        log(f"  rank {rank} launches: " + ", ".join(
            f"{k} {got[k]}" for k in (*leg["kernels"], "rms_norm")))
    # collectives: per pass through the model (a decode tick, a prefill,
    # a chunk, a replay step) by the layout (``tp_collectives``: at model
    # 2 two all-reduces a layer, after the mixer's output projection, or
    # the SSD's gated-norm statistic and its output projection, and after
    # the MLP's, and one for the vocab-parallel embedding; on 1,3 the
    # attention's whole heads take none), and one all-gather of the
    # logits where the pass makes logits (not a chunk that skips the LM
    # head)
    per_pass, lm_gather, attn_gather = tp_collectives(cfg, n_tp)
    heads = (calls["decode"] + calls["prefill"] + calls["chunk"]
             + calls["replay"])
    passes = heads + calls["chunk_mid"]
    want_gather = lm_gather * heads + attn_gather * passes
    for rank, got in enumerate(per_rank):
        if got["tp_all_reduce"] != per_pass * passes or \
                got["tp_all_gather"] != want_gather:
            raise AssertionError(
                f"tp {name} rank {rank}: {got['tp_all_reduce']} all-reduces"
                f" (want {per_pass} x {passes}), {got['tp_all_gather']} "
                f"all-gathers (want {want_gather})")
    log(f"  collectives per decode tick on each rank: {per_pass} "
        f"all-reduces ({cfg.n_layers} layers + the embedding, by the "
        f"layout on model {n_tp}) + {lm_gather + attn_gather} "
        f"all-gathers (the logits, the layers' columns); on each rank "
        f"{calls['decode']} ticks, "
        f"{calls['prefill']} prefills, {calls['chunk']} + "
        f"{calls['chunk_mid']} chunks (with and without the LM head), "
        f"{calls['gather']} gathers, {stats['prefix_hits']} prefix hits")
    # per-rank pool bytes against the single-device pool, leaf by leaf
    dt = getattr(torch, cfg.dtype)
    whole = (init_paged_slot_cache(cfg, slots, cache_len, dt, 8, num_pages,
                                   "meta") if paged else
             init_slot_cache(cfg, slots, cache_len, dt, "meta"))
    want = {k: b for k, (b, _) in tree_bytes(None, whole).items()}
    # K/V on their heads where the model axis divides them (whole on every
    # rank where it does not), the SSM state on its heads, the conv tail
    # by the port's layout
    conv_share = None
    if arch == "mamba2-780m":
        tail = 2 * cfg.ssm_ngroups * cfg.ssm_state
        conv_share = (cfg.d_inner // n_tp + tail) / (cfg.d_inner + tail)
    kv_share = 1 / n_tp if cfg.n_kv_heads % n_tp == 0 else 1.0
    for rank, pool in enumerate(pools):
        for path, full_b in want.items():
            leaf, got = path.rsplit("/", 1)[-1], pool[path][0]
            share = (kv_share if leaf in ("k", "v") else 1 / n_tp
                     if leaf == "state" else conv_share
                     if leaf == "conv" else 1.0)
            if got != full_b * share:
                raise AssertionError(f"tp {name} rank {rank}: {path} holds "
                                     f"{got} B, want {share} x {full_b}")
    # the last tick's tokens, mask and block table: whole on every rank,
    # the same bytes (shape, dtype, crc32)
    tabled = len(handed[0]) == 3            # a paged engine's tick
    if any(h != handed[0] for h in handed) or (
            tabled and handed[0][-1][0] != (slots, cache_len // 8)):
        raise AssertionError(f"tp {arch}: the ranks were handed other "
                             f"tensors for the last tick: {handed}")
    log(f"  the last tick's tensors, the same on every rank: "
        + ", ".join(f"{shape} {dtype} crc {crc:08x}"
                    for shape, dtype, crc in handed[0])
        + (" (tokens, active mask, block table)" if tabled
           else " (tokens, active mask)"))
    log(f"  pool bytes per rank / single-device pool: " + ", ".join(
        f"{p} {pools[0][p][0]} / {b}" for p, b in want.items())
        + (f" (conv: (d_inner/2 + 2 N G) / conv_dim = {conv_share:.4f})"
           if conv_share else ""))
    del whole
    if moe:
        # every expert on every rank at half its d_ff columns, the router
        # whole: per-rank expert bytes half of one device's
        size = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
        experts = router = 0
        for i, (spec, blk) in enumerate(zip(cfg.pattern,
                                            param_meta(cfg)["blocks"])):
            if spec.mlp != "moe":
                continue
            for k, m in blk["mlp"].items():
                full_b = int(np.prod(m.shape)) * size
                share = 0.5 if k in ("w_gate", "w_up", "w_down") else 1.0
                for rank, h in enumerate(held):
                    got = h[f"/blocks[{i}]/mlp/{k}"][0]
                    if got != full_b * share:
                        raise AssertionError(
                            f"tp {arch} rank {rank}: blocks[{i}] mlp {k} "
                            f"holds {got} B, want {share} x {full_b}")
                experts += full_b * (share < 1)
                router += full_b * (k == "router")
        per = [sum(b for p, (b, _) in h.items() if p.rsplit("/", 1)[-1]
                   in ("w_gate", "w_up", "w_down")) for h in held]
        log(f"  expert bytes per rank: {[round(b / 1e9, 3) for b in per]}"
            f" GB of one device's {experts / 1e9:.3f} (1/2: each rank every "
            f"expert at half its d_ff columns); router {router / 1e6:.2f} "
            "MB whole on each rank")

    # the checks: the single-device forward on rank 0 from the same full
    # weights, then the TP step path on every rank (as built and under each
    # fault) in the engine's session, its pool still held.  With MoE the
    # forward takes the expert ids of the TP path as built (the reason is
    # in ``serve``), recorded on every rank, and the route check holds
    # them where the forward's own choice is clear
    full = TPWeights(seed)(cfg, None, device)
    order = sorted(range(n_req), key=lambda i: len(prompts[i]))
    box = {"flips": []}

    def forward_refs(store=None):
        nonlocal full
        per = (None if store is None else path_routes(
            store, cfg, [len(prompts[i]) for i in order], slots, gen))
        ref = [None] * n_req
        for k, i in enumerate(order):
            with (routes_forced(per[k], box["flips"]) if per
                  else contextlib.nullcontext()):
                ref[i] = forced_logits(cfg, full, prompts[i], toks[i],
                                       device)
        full = None
        box["ref"] = ref
        return ref
    if not moe:
        forward_refs()
    try:
        res, _, ids = tp_path_check(
            sess, cfg, prompts, toks, forward_refs if moe else box["ref"],
            order, leg["faults"], paged, device,
            leg.get("fault_req", TP_FAULT_REQ),
            leg.get("fault_pos", TP_FAULT_POS), traffic=t)
    finally:
        eng.shutdown()
    ref = box["ref"]
    worst = max(token_gaps(lg, tk).max().item()
                for lg, tk in zip(ref, toks))
    del eng, sess, ref
    routes = None
    if moe:
        routes = route_check(box["flips"], moe_layers(cfg),
                             [len(prompts[i]) - 1 for i in order])
        log(route_line(f"tp route check [{arch}, as built]", routes))
        log(f"  expert ids of the step path as built, on every rank: "
            f"{ids[0][0]} MoE calls, digest {ids[0][1][0]} "
            f"{ids[0][1][1]} crc {ids[0][1][2]:08x} (the same on "
            f"{len(ids)} ranks)")
    log_checks("tp logit check", arch, {None: res[None]}, n_req * gen)
    log_checks("tp logit check", arch, {n: res[n] for n in leg["faults"]},
               min(leg.get("fault_req", TP_FAULT_REQ), n_req)
               * min(gen, leg.get("fault_pos", TP_FAULT_POS)))
    log(f"  tp token check ({arch}): emitted tokens trail the single-device "
        f"forward's argmax by at most {worst:.4f} (tolerance {LOGIT_TOL})")
    if worst > LOGIT_TOL:
        raise AssertionError(f"tp {arch}: an emitted token trails the "
                             f"forward's argmax by {worst:.4f}")
    if res[None]["rel_max"] > REL_TOL:
        raise AssertionError(f"tp {arch}: step-path logits off the "
                             f"forward's by {res[None]['rel_max']:.4f}")
    if routes is not None and routes["wide_flips"]:
        raise AssertionError(
            f"tp {arch}: the step path's experts differ from the forward's "
            f"own at {routes['wide_flips']} (layer, position) pairs whose "
            "margin is above the bound")
    missed = [n for n in leg["faults"] if res[n]["rel_max"] <= REL_TOL
              or res[n]["gap"] <= LOGIT_TOL]
    if missed:
        raise AssertionError(f"tp {arch}: the checks do not reject the "
                             f"planted TP faults {missed}")
    log(f"phase tp {name}: {time.perf_counter() - t_leg:.1f} s")
    total = collections.Counter()
    for got in per_rank:
        total.update({k: v for k, v in got.items() if not k.startswith("tp")})
    return dict(total)


def tp_section(smi, device="cuda", layers=None, started=None):
    """The TP section: the mesh ``start_mesh("1,2")`` started (or one
    made now), the three legs in turn, the mesh closed; returns the
    launches of every rank, summed."""
    import torch

    t0 = time.perf_counter()
    mesh = take_mesh(started or start_mesh("1,2", device), "tp")
    launches = {}
    try:
        for arch in TP_LEGS:
            for k, n in tp_leg(mesh, arch, smi, device, layers=layers
                               ).items():
                launches[k] = launches.get(k, 0) + n
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
    finally:
        mesh.close()
    log(f"tp section: {time.perf_counter() - t0:.1f} s")
    return launches


def tp_heads_section(smi, device="cuda", layers=None, started=None):
    """The replicated-heads section: the mesh ``start_mesh("1,3")``
    started (or one made now), the legs of ``TP_HEADS_LEGS`` in turn,
    the mesh closed; returns the launches of every rank, summed."""
    import torch

    t0 = time.perf_counter()
    mesh = take_mesh(started or start_mesh("1,3", device), "tp_heads")
    launches = {}
    try:
        for name in TP_HEADS_LEGS:
            for k, n in tp_leg(mesh, name, smi, device, layers=layers
                               ).items():
                launches[k] = launches.get(k, 0) + n
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
    finally:
        mesh.close()
    log(f"tp_heads section: {time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------------------------- fsdp
# The FSDP section (``fsdp_section``; ``--phases fsdp``): the sharded train
# state on a 2,1 mesh, this process and one follower on the one card over
# gloo (two cards: nccl), each leg at full width through
# ``launch.train.MeshTrain`` with seeded f32 masters, bf16 compute, remat
# "full" and f32 AdamW, on one fixed batch of ``FSDP_BATCH`` (each rank
# 2 rows) whose first row keeps half its labels, so the global count of
# labelled tokens is all-reduced.  mamba2-780m at 2 of 48 layers (4
# until the TP section's mixtral leg came; at 4 its planted faults moved
# a leaf by 0.709 and 1.416 and the clip norm by 0.29 against a bar of
# 0.05 and 0.01: none of them a per-layer effect), the SSD scan's kernels
# forward and backward under FSDP, 1.4-1.7 s a step at 4 layers (an H100
# 80GB HBM3 at 700 W): the planted faults (d) and the checkpoint (c) run
# there.  The section's qwen2.5-14b leg (1 layer: 4.2 GB of bf16
# weights gathered and 7.3 GB of f32 gradients all-reduced a step and
# rank, 13.2-19.7 s a step on that card) moved onto the tensor-parallel
# train section's 2,2 mesh (``TP_TRAIN_LEGS``), whose data axis holds
# the FSDP bars (a), (b) and (e) at that width.
FSDP_LEGS = {
    "mamba2-780m": dict(layers=2, steps=2, faults=True, ckpt=True),
}
FSDP_BATCH = dict(micro=4, seq=1024, accum=1)
FSDP_HP = dict(lr=1e-3, warmup=2, total_steps=10)
# (d): the gather's backward keeping this rank's gradient unsummed, the
# blocks gathered in reversed rank order, the clip norm taken from the
# rank's own shards; each on every rank, each must fail bar (a)
FSDP_FAULTS = ("sum_dropped", "blocks_reversed", "clip_norm_local")


class FSDPState:
    """The FSDP and TP train legs' state on every rank: the seeded f32
    masters of ``train_phase`` (conv weights times ``SSM_CONV_W_GAIN``)
    made whole on the rank's device and cut to its blocks on both axes,
    m and v zeros of their shapes."""
    per_rank = True

    def __init__(self, seed=0):
        self.seed = seed

    def params(self, cfg, device):
        import torch

        from repro_torch.models.lm import init_params

        params = init_params(cfg, torch.Generator(device).manual_seed(
            self.seed), device, dtype=cfg.param_dtype)
        ssm_gain(params)
        return params

    def __call__(self, cfg, mesh, device):
        import torch

        from repro_torch.optim import adamw_init
        from repro_torch.params import train_shard

        params = train_shard(self.params(cfg, device), cfg, mesh)
        if device.type == "cuda":       # the whole params' cache, freed:
            torch.cuda.empty_cache()    # four ranks share one card
        return {"params": params, "opt": adamw_init(params, cfg.opt_dtype),
                "step": torch.zeros((), dtype=torch.int32, device=device)}


def _batch(rs, tokens, labels):
    return {"tokens": tokens.to(rs.device), "labels": labels.to(rs.device)}


def _train_cfg(rs, dtype):
    return rs.cfg if dtype is None else rs.cfg.replace(dtype=dtype)


def _plan_leaves(rs):
    """(data dims, model splits) of the session's parameter leaves."""
    from repro_torch.models.layers import tree_leaves
    from repro_torch.steps import train_plan

    plan = train_plan(rs.cfg, rs.mesh)
    return (tree_leaves(plan.dims),
            tree_leaves(plan.tp))


def fsdp_single(rs, seed, tokens, labels, dtype=None, routes=None):
    """Bar (a)'s single rank, on rank 0 (``rs``: its ``RankState``,
    ``Session.local``): the whole seeded params (``FSDPState``'s) through
    ``steps.make_grad_step(cfg)`` without a mesh on the whole batch
    (``dtype``: the compute dtype, default the config's; ``routes``: a
    MoE step's (expert ids per call, flips), forced by
    ``routes_forced``).  Returns (loss, clip norm, the gradient leaves);
    ``single_blocks`` hands every rank its blocks of them."""
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.steps import make_grad_step

    cfg = _train_cfg(rs, dtype)
    params = FSDPState(seed).params(cfg, rs.device)
    with (routes_forced(*routes) if routes is not None
          else contextlib.nullcontext()):
        grads, loss = make_grad_step(cfg)(params,
                                          _batch(rs, tokens, labels))
    del params
    return float(loss), float(adamw.global_norm(grads)), tree_leaves(grads)


def single_blocks(rs, grads):
    """``Session.run``: this rank's blocks on both axes of rank 0's
    single-rank gradients ``grads`` (``fsdp_single``), kept in
    ``extra["single"]``.  A follower receives them as CUDA IPC handles of
    rank 0's tensors (``torch.multiprocessing``'s pickling, on a card
    every rank can reach), so no gradient goes through the host and no
    follower runs the whole model: a follower's first whole-model step
    paid 13-14 s of one-time Triton launches (each kernel's first call in
    a process), the ranks in turn."""
    from repro_torch.sharding.fsdp import shard_leaf

    rs.extra["single"] = [shard_leaf(g, d, sp, rs.mesh).to(rs.device)
                          for g, d, sp in zip(grads, *_plan_leaves(rs))]


def single_step(tr, seed, tokens, labels, dtype=None, routes=None):
    """Bar (a)'s single rank on a leg's trainer ``tr``: computed on rank 0
    (``routes``: ``fsdp_single``'s) and each rank's blocks kept
    (``single_blocks``); returns (loss, clip norm, seconds)."""
    import torch

    t0 = time.perf_counter()
    loss, norm, grads = fsdp_single(tr.sess.local, seed, tokens, labels,
                                    dtype, routes)
    tr.sess.run(single_blocks, grads)
    del grads
    gc.collect()
    if tr.sess.local.device.type == "cuda":
        torch.cuda.empty_cache()
    return loss, norm, time.perf_counter() - t0


def _gaps(rs, got, factor=1.0):
    """Per leaf ||got - factor x single|| / ||factor x single|| over the
    whole leaf: this rank's blocks ``got`` against its blocks of the
    single rank's gradients, the squares summed over the axes each part
    of a leaf is split on (a part whole on an axis counted once),
    uncounted: a check's collectives, not the path's."""
    import torch

    from repro_torch.sharding.fsdp import model_parts

    dims, tps = _plan_leaves(rs)
    m = rs.mesh.shape["model"]
    split = torch.zeros((2, len(got)), dtype=torch.float32, device=rs.device)
    whole = torch.zeros_like(split)
    for i, (a, b, sp) in enumerate(zip(got, rs.extra["single"], tps)):
        w = b.float() * factor
        for k, t in enumerate((a.float() - w, w)):
            ps, pw = model_parts(t, sp, m)
            if ps is not None:
                split[k, i] = ps.square().sum()
            if pw is not None:
                whole[k, i] = pw.square().sum()
    rs.mesh.all_reduce(split, "model")
    tot = split + whole
    on = torch.tensor([d is not None for d in dims], device=rs.device)
    part = torch.where(on, tot, 0.0).contiguous()
    rs.mesh.all_reduce(part, "data")
    tot = part + torch.where(on, 0.0, tot)
    return (tot[0] / tot[1].clamp_min(1e-30)).sqrt().tolist()


def fsdp_probe(rs, state, tokens, labels, dtype=None):
    """``Session.run``: one sharded gradient step
    (``steps.make_grad_step(cfg, mesh)``, ``dtype`` the compute dtype) on
    this rank's params, held to the single rank's: (loss, clip norm as
    AdamW takes it, the leaves' gaps)."""
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.steps import make_grad_step

    grad_step = make_grad_step(_train_cfg(rs, dtype), rs.mesh)
    grads, loss = grad_step(state["params"], _batch(rs, tokens, labels))
    norm = adamw.global_norm(grads, grad_step.plan)
    return float(loss), float(norm), _gaps(rs, tree_leaves(grads))


def fsdp_moments(rs, state, factor):
    """``Session.run``, after the first AdamW step from zero moments, when
    m is ``(1 - b1)`` times the clipped gradient: this rank's blocks of m
    against ``factor`` (``(1 - b1) x`` the single rank's clip scale) times
    the single rank's gradients; the leaves' gaps."""
    from repro_torch.models.layers import tree_leaves

    return _gaps(rs, tree_leaves(state["opt"]["m"]), factor)


def _fsdp_faults():
    import torch

    from repro_torch.optim import adamw
    from repro_torch.sharding import fsdp

    norm = adamw.global_norm

    def sum_dropped(grad, dim, mesh):
        return fsdp.block(grad.float(), dim, mesh)

    def blocks_reversed(local, dim, mesh):
        fsdp.gather.calls.add()
        return torch.cat(mesh.all_gather(local)[::-1], dim=dim)

    def clip_norm_local(tree, plan=None):
        return norm(tree)

    return {"sum_dropped": (fsdp, "sum_blocks", sum_dropped),
            "blocks_reversed": (fsdp, "gather_blocks", blocks_reversed),
            "clip_norm_local": (adamw, "global_norm", clip_norm_local)}


def _tp_train_faults():
    from repro_torch.models import layers, ssm
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import adamw
    from repro_torch.sharding import fsdp

    norm = adamw.global_norm

    def enter_bwd_unsummed(grad, mesh):
        layers.tp_enter.calls.add()
        return grad

    def gated_norm_dot_local(s, mesh):
        layers.tp_norm_dot.calls.add()
        return s

    def bc_grad_unsummed(t):
        return t

    def bc_grad_twice(t):
        return layers.tp_enter(layers.tp_enter(t))

    def clip_norm_replicated_m_times(tree, plan=None):
        if plan is None:
            return norm(tree)
        # every leaf's squares summed over model, whole parts too
        return norm(tree, plan._replace(tp=tree_map(
            lambda sp: fsdp.TPSplit(0), plan.tp)))

    def fsdp_over_all_ranks(grad, dim, mesh):
        fsdp.data_sum.calls.add()
        return fsdp.block(mesh.all_reduce(grad.float().contiguous(), "all"),
                          dim, mesh)

    return {"enter_bwd_unsummed": (layers, "_enter_sum", enter_bwd_unsummed),
            "gated_norm_dot_local": (layers, "_norm_dot_sum",
                                     gated_norm_dot_local),
            "bc_grad_unsummed": (ssm, "bc_shared", bc_grad_unsummed),
            "bc_grad_twice": (ssm, "bc_shared", bc_grad_twice),
            "clip_norm_replicated_m_times": (
                adamw, "global_norm", clip_norm_replicated_m_times),
            "fsdp_over_all_ranks": (fsdp, "sum_blocks", fsdp_over_all_ranks)}


def _moe_train_faults():
    import torch

    from repro_torch.models import layers, moe
    from repro_torch.sharding import fsdp

    class SummedBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, mesh):
            ctx.mesh = mesh
            return fsdp.data_sum(x.clone(), mesh)

        @staticmethod
        def backward(ctx, grad):
            return fsdp.data_sum(grad.clone(), ctx.mesh), None

    def weights_not_entered(xn, topv):
        return layers.tp_enter(xn), topv

    def aux_local(stats, mesh):
        return stats

    return {"moe_weights_enter_left_out": (moe, "enter",
                                           weights_not_entered),
            "aux_local": (moe, "global_stats", aux_local),
            "aux_bwd_summed": (moe, "data_all_reduce", SummedBackward.apply)}


def _heads_faults():
    """The planted faults of replicated heads (``models.attention``), each
    a swap of one of its module's names: the whole attention output
    all-reduced where ``wo`` is whole (serving and training: the output
    n times over); each rank's query heads reading its KV view counted
    from KV head 0 (``Heads.reads`` with ``q0`` 0: only rank 0's heads
    read theirs); in training, the normed input entering the layer as a
    whole (``rms_norm``'s outputs entered: the gradient of ``xn`` and of
    MLA's latents summed n times over), and the whole output narrowed to
    the rank's rows of ``wo`` without entering (the whole attention's
    backward on each rank from its own columns only)."""
    from repro_torch.models import attention as att
    from repro_torch.models import layers

    def out_all_reduced(out, wo, cut, whole):
        if cut and whole:
            c = wo.shape[0]
            out = layers.tp_enter(out).narrow(-1, layers.tp_coord("tp") * c,
                                              c)
        return layers.tp_all_reduce(out @ wo)

    def out_unentered(out, wo, cut, whole):
        if cut and whole:
            c = wo.shape[0]
            out = out.narrow(-1, layers.tp_coord("tp") * c, c)
        y = out @ wo
        return layers.tp_all_reduce(y) if cut else y

    def heads_from_0(n_heads, n_kv_heads=None):
        return layers.tp_heads(n_heads, n_kv_heads)._replace(q0=0)

    def entered_norm(*a, **kw):
        return layers.tp_enter(layers.rms_norm(*a, **kw))

    return {"wo_whole_all_reduced": (att, "_out_proj", out_all_reduced),
            "kv_read_from_0": (att, "tp_heads", heads_from_0),
            "xn_enters_whole": (att, "rms_norm", entered_norm),
            "out_narrowed_unentered": (att, "_out_proj", out_unentered)}


HEADS_FAULTS = ("wo_whole_all_reduced", "kv_read_from_0", "xn_enters_whole",
                "out_narrowed_unentered")


def fsdp_on(rs, name):
    """``Session.run``: plant FSDP fault ``name`` (``FSDP_FAULTS``), TP
    train fault ``name`` (``TP_TRAIN_FAULTS``) or MoE train fault
    ``name`` (``MOE_TRAIN_FAULTS``), a fault of replicated heads
    (``HEADS_FAULTS``) on this rank, or ``"deterministic"``
    (``deterministic()``), until ``fsdp_off``."""
    ctx = (deterministic() if name == "deterministic"
           else swapped({**_fsdp_faults(), **_tp_train_faults(),
                         **_moe_train_faults(), **_heads_faults()}[name]))
    ctx.__enter__()
    rs.extra[name] = ctx
    return rs.mesh.rank


def fsdp_off(rs, name):
    rs.extra.pop(name).__exit__(None, None, None)


def fsdp_keep(rs, state):
    """``Session.run``: a host copy of this rank's params, kept for
    ``fsdp_same``."""
    from repro_torch.models.layers import tree_leaves

    rs.extra["kept"] = [t.to("cpu", copy=True)
                        for t in tree_leaves(state["params"])]


def fsdp_same(rs, state):
    """``Session.run``: this rank's params against the kept copy: (every
    leaf within rtol 1e-5 / atol 1e-6, the largest |diff|)."""
    import torch

    from repro_torch.models.layers import tree_leaves

    ok, worst = True, 0.0
    for a, b in zip(rs.extra.pop("kept"), tree_leaves(state["params"])):
        b = b.to("cpu")
        ok = ok and torch.allclose(b, a, rtol=1e-5, atol=1e-6)
        worst = max(worst, (b - a).abs().max().item())
    return ok, worst


def fsdp_verdict(name, what, got, one, names, tol=TRAIN_TOL):
    """Bar (a)'s verdict: ``got`` (loss, clip norm, the leaves' gaps)
    against the single rank's ``one`` (loss, clip norm) by ``tol``;
    prints the margins, returns whether all hold."""
    import statistics

    loss, norm, gaps = got
    dl = abs(loss - one[0]) / abs(one[0])
    dn = abs(norm - one[1]) / one[1]
    i = max(range(len(gaps)), key=gaps.__getitem__)
    ok = dl <= tol["loss"] and dn <= tol["grad_norm"] and \
        gaps[i] <= tol["leaf"]
    log(f"{name}: {what}: loss {loss:.6f} vs {one[0]:.6f} (rel {dl:.3e}), "
        f"clip norm {norm:.6f} vs {one[1]:.6f} (rel {dn:.3e}), worst leaf "
        f"{names[i]} rel {gaps[i]:.3e}, median leaf "
        f"{statistics.median(gaps):.3e} -> "
        f"{'within' if ok else 'outside'} {tol}")
    return ok


def state_meta(cfg):
    """A whole train state of ``cfg`` on the meta device (shapes and
    dtypes, no memory): a checkpoint's template."""
    import torch

    from repro_torch.models.layers import tree_map
    from repro_torch.models.lm import _is_meta, param_meta

    def tree(dtype):
        return tree_map(lambda m: torch.empty(m.shape, device="meta",
                                              dtype=getattr(torch, dtype)),
                        param_meta(cfg), is_leaf=_is_meta)
    return {"params": tree(cfg.param_dtype),
            "opt": {"m": tree(cfg.opt_dtype), "v": tree(cfg.opt_dtype)},
            "step": torch.empty((), device="meta", dtype=torch.int32)}


def fsdp_checkpoint(tr, cfg, hp, batch, n, name, device):
    """Bar (c) on a leg's trainer after ``n`` steps: a save on the mesh
    (rank 0's UMT writes); one step on (the uninterrupted run); restored
    onto the mesh and one step on, equal to it; restored onto one device
    and one step on, equal to the same step from the save's snapshot
    handed to one device in memory; each rtol 1e-5 / atol 1e-6 under
    ``deterministic()`` on every rank.  Closes ``tr``."""
    import shutil

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import _unflatten as unflatten
    from repro_torch.core import UMTRuntime
    from repro_torch.models.layers import tree_leaves
    from repro_torch.steps import make_train_step

    ckpt = ROOT / "build" / "fsdp_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    tr.sess.run(fsdp_on, "deterministic")
    try:
        with deterministic(), UMTRuntime(n_cores=2, umt=True) as rt:
            mgr = CheckpointManager(str(ckpt), rt=rt, keep=1)
            t0 = time.perf_counter()
            hosts = tr._snapshot(tr.state)
            t_snap = time.perf_counter() - t0
            mgr.save(tr.state, n, hosts=hosts)
            tr.state, m = tr.step(tr.state, batch)  # the uninterrupted step
            l_mesh = float(m["loss"])
            tr.sess.run(fsdp_keep, tr.state)
            t0 = time.perf_counter()
            mgr.wait()
            t_wait = time.perf_counter() - t0
            t0 = time.perf_counter()
            tr.state, rstep = tr.restore(str(ckpt), tr.state)
            t_mesh = time.perf_counter() - t0
            if rstep != n:
                raise AssertionError(f"{name}: (c) restored step {rstep}")
            tr.state, m = tr.step(tr.state, batch)
            same = tr.sess.run(fsdp_same, tr.state)
            tr.close()
            if not all(ok for ok, _ in same):
                raise AssertionError(f"{name}: (c) restored onto the mesh, "
                                     f"one step on: {same}")
            step1 = make_train_step(cfg, hp)
            template = state_meta(cfg)
            whole = unflatten(template, [
                torch.from_numpy(raw).view(getattr(torch, dt)).reshape(
                    shape).to(device) for raw, shape, dt in hosts])
            del hosts
            whole, _ = step1(whole, batch)
            mem = [t.clone() for t in tree_leaves(whole["params"])]
            del whole
            t0 = time.perf_counter()
            whole, _ = mgr.restore(template, device=device)
            t_one = time.perf_counter() - t0
            whole, m1 = step1(whole, batch)
            worst = 0.0
            for a, b in zip(mem, tree_leaves(whole["params"])):
                worst = max(worst, (b - a).abs().max().item())
                if not torch.allclose(b, a, rtol=1e-5, atol=1e-6):
                    raise AssertionError(f"{name}: (c) restored onto one "
                                         "device, one step on: params off "
                                         f"by {worst}")
            del whole, mem
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    dl = abs(float(m1["loss"]) - l_mesh) / abs(l_mesh)
    log(f"{name}: (c) saved at step {n} (the whole state's snapshot on "
        f"rank 0 {t_snap:.2f} s, writes done {t_wait:.2f} s after the "
        f"next step), restored onto the mesh in {t_mesh:.2f} s and one "
        f"step on: params equal the uninterrupted step's (max |diff| per "
        f"rank {[f'{w:.3e}' for _, w in same]}); restored onto one device "
        f"in {t_one:.2f} s and one step on: equal to the snapshot's own "
        f"step (max |diff| {worst:.3e}; rtol 1e-5 / atol 1e-6); its loss "
        f"{float(m1['loss']):.6f} vs the mesh's {l_mesh:.6f} (rel "
        f"{dl:.3e})")
    if dl > TRAIN_TOL["loss"]:
        raise AssertionError(f"{name}: (c) one device's loss after the "
                             "restore is off the mesh's")


def fsdp_leg(mesh, arch, smi, device="cuda", seed=0):
    """One FSDP leg (``FSDP_LEGS[arch]``; the bars in ``fsdp_section``);
    returns the main path's launches, every rank's summed.
    ``device="cpu"``: a rehearsal at the tiny config."""
    import collections

    import torch

    from repro_torch.configs import get
    from repro_torch.launch.train import MeshTrain
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim import OptHParams
    from repro_torch.serve.tp import counters, tree_bytes
    from repro_torch.steps import train_plan

    t_leg = time.perf_counter()
    leg = FSDP_LEGS[arch]
    micro, seq, accum = (FSDP_BATCH[k] for k in ("micro", "seq", "accum"))
    card = device == "cuda"
    cfg = get(arch)
    if card:
        cfg = cfg.replace(n_layers=leg["layers"])
    else:                               # the rehearsal's tiny shapes
        cfg, seq = cfg.tiny(remat="full"), 16
    assert cfg.remat == "full"
    n, name = leg["steps"], f"fsdp {arch}"
    hp = OptHParams(**FSDP_HP)
    plan = train_plan(cfg, mesh)
    split = [d is not None for d in tree_leaves(plan.dims)]
    names = leaf_names(plan.dims)
    template = state_meta(cfg)
    n_params = sum(t.numel() for t in tree_leaves(template["params"]))
    g = torch.Generator(device).manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (accum, micro, seq), generator=g,
                           device=device, dtype=torch.int32).cpu()
    labels = tokens.clone()
    labels[0, 0, :seq // 2] = -1     # rank 0's rows: fewer labels
    batch = {"tokens": tokens, "labels": labels}
    data = mesh.shape["data"]
    log(f"{name} ({smi}): {cfg.n_layers} of {get(arch).n_layers} layers, "
        f"d {cfg.d_model}, {n_params / 1e6:.1f} M params ({cfg.param_dtype}"
        f" masters, {cfg.dtype} compute, {cfg.opt_dtype} AdamW, remat "
        f"{cfg.remat}); microbatches {micro} x {seq} (each rank "
        f"{micro // data} rows), accum {accum}; {mesh.describe()}")
    tr = MeshTrain(cfg, hp, mesh, device, FSDPState(seed))
    try:
        tr.sess.run(tp_peak, True)
        # (b) each rank's params, m and v: half of every split leaf
        whole_b = {p: b for p, (b, _) in tree_bytes(None,
                                                      template).items()}
        per_rank = tr.sess.run(tree_bytes, tr.state)
        for rank, held in enumerate(per_rank):
            for path, b in whole_b.items():
                leaf = next((path[len(pre):] for pre in (
                    "/params", "/opt/m", "/opt/v") if path.startswith(pre)),
                    path)
                s = leaf in names and split[names.index(leaf)]
                if held[path][0] * (data if s else 1) != b:
                    raise AssertionError(
                        f"{name}: (b) rank {rank} holds {held[path][0]} B "
                        f"of {path}, {b} B whole (split: {s})")
        held = [sum(b for p, (b, _) in h.items() if p != "/step")
                for h in per_rank]
        log(f"{name}: (b) params, m and v per rank "
            f"{[round(h / 1e9, 3) for h in held]} GB of "
            f"{sum(whole_b.values()) / 1e9:.3f}: every split leaf exactly "
            f"1/{data}; whole on every rank: "
            + ", ".join(p for p, s in zip(names, split) if not s))

        # (a)'s single rank, each rank's blocks of it kept
        t0 = time.perf_counter()
        one = single_step(tr, seed, tokens, labels)
        log(f"{name}: the single rank's gradient step (on rank 0, each "
            f"rank keeps its blocks): loss {one[0]:.6f}, clip norm "
            f"{one[1]:.6f} ({one[2]:.1f} s)")
        # (d) the planted faults, each through a sharded gradient step
        if leg["faults"]:
            got = tr.sess.run(fsdp_probe, tr.state, tokens, labels)[0]
            if not fsdp_verdict(name, "(a) a sharded gradient step", got,
                                one, names):
                raise AssertionError(f"{name}: (a) the sharded gradient "
                                     "step disagrees with the single rank's")
            for fault in FSDP_FAULTS:
                tr.sess.run(fsdp_on, fault)
                got = tr.sess.run(fsdp_probe, tr.state, tokens, labels)[0]
                tr.sess.run(fsdp_off, fault)
                if fsdp_verdict(name, f"(d) planted: {fault}", got, one,
                                names):
                    raise AssertionError(f"{name}: (a) does not reject the "
                                         f"planted fault {fault}")

        # the main path: ``n`` train steps on every rank, counted; (a) on
        # its first step: loss, grad norm and m against the single rank
        tr.sess.run(counters, True)
        losses, times = [], []
        for step in range(n):
            t0 = time.perf_counter()
            tr.state, m = tr.step(tr.state, batch)
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t0)
            if step == 0:
                norm0 = float(m["grad_norm"])
                scale = min(1.0, hp.clip_norm / (one[1] + 1e-9))
                gaps = tr.sess.run(fsdp_moments, tr.state,
                                   (1 - hp.b1) * scale)[0]
        per_rank = tr.sess.run(counters)
        if not fsdp_verdict(name, "(a) the first train step (its m is (1 - "
                            "b1) x the clipped gradient)",
                            (losses[0], norm0, gaps), one, names):
            raise AssertionError(f"{name}: (a) the sharded train step "
                                 "disagrees with the single rank's")
        # (e) gathers and sums a step, and the kernels' identities
        in_blocks = cfg.n_repeats * sum(
            s for s, p in zip(split, names) if p.startswith("/blocks"))
        outside = sum(split) - in_blocks // cfg.n_repeats
        want = {"fsdp_gather": n * accum * (2 * in_blocks + outside),
                "fsdp_sum": n * (accum * (in_blocks + outside) + 4)}
        ids, text = train_identities(cfg, per_rank[0], n * accum)
        for rank, c in enumerate(per_rank):
            bad = {k: (c[k], w) for k, w in want.items() if c[k] != w}
            if card:
                bad.update({k: (c[k], w) for k, w in ids.items()
                            if c[k] != w})
            if bad:
                raise AssertionError(f"{name}: (e) rank {rank}: got / want "
                                     f"{bad}")
        gb = per_rank[0]["fsdp_gather_bytes"] / n / 1e9
        sb = per_rank[0]["fsdp_sum_bytes"] / n / 1e9
        log(f"{name}: (e) per rank and step {want['fsdp_gather'] // n} "
            f"gathers ({accum} x (2 x {in_blocks} repeat leaves + {outside}"
            f" embedding / head)), {want['fsdp_sum'] // n} sums ({accum} x "
            f"{in_blocks + outside} + 4: whole leaves, label counts, loss, "
            f"clip norm); {gb:.3f} GB gathered and {sb:.3f} GB summed a step"
            f"; launches on each rank: {text}")
        log(f"{name}: losses {' '.join(f'{x:.4f}' for x in losses)}; "
            f"s/step {' '.join(f'{t:.3f}' for t in times)}"
            + (" (two ranks sharing one device over gloo: not an FSDP "
               "throughput)" if mesh.backend == "gloo" else ""))
        peaks = tr.sess.run(tp_peak)
        if leg["ckpt"]:
            fsdp_checkpoint(tr, cfg, hp, batch, n, name, device)
    finally:
        tr.close()
    total = collections.Counter()
    for c in per_rank:
        total.update({k: v for k, v in c.items()
                      if not k.startswith(("tp", "fsdp"))})
    log(f"{name}: peak device memory per rank "
        f"{[round(p / 1e9, 2) for p in peaks]} GB; leg "
        f"{time.perf_counter() - t_leg:.1f} s")
    return dict(total)


def start_mesh(spec, device="cuda"):
    """A mesh (``spec``: "1,2" for the TP section, "2,1" for the FSDP
    section, "2,2" for the TP train section; gloo on one card, nccl on a
    card a rank) made on a thread: the followers start (their imports,
    the rendezvous) while the kernel checks run.  ``take_mesh`` joins
    it."""
    import threading

    import torch

    from repro_torch.launch.mesh import make_mesh_from_devices

    box = {"t0": time.perf_counter()}

    def make():
        try:
            if device == "cuda":
                data, model = (int(p) for p in spec.split(","))
                backend = ("gloo" if torch.cuda.device_count() < data * model
                           else "nccl")
                box["mesh"] = make_mesh_from_devices(spec, backend=backend)
            else:
                box["mesh"] = make_mesh_from_devices(spec,
                                                     device_type="cpu")
        except BaseException as e:      # noqa: BLE001 — raised by the join
            box["error"] = e
        box["s"] = time.perf_counter() - box["t0"]
    box["thread"] = threading.Thread(target=make, daemon=True,
                                     name=f"mesh-{spec}")
    box["thread"].start()
    return box


# the row widths (and the bf16 and f32 compute) whose RMSNorm kernels a
# section's follower runs: qwen2.5-14b, mamba2-780m (its gated norm whole
# and halved), minicpm3-4b (model, q and kv latents), internvl2-2b
WARM_WIDTHS = (5120, 3072, 2560, 2048, 1536, 768, 256)


def mesh_warm(rs):
    """``Session.run``: on a follower on the card, the first calls of the
    Triton RMSNorm entries (forward, backward, the given-statistic pair)
    at ``WARM_WIDTHS`` and at 16, 2048 and 4096 rows, in bf16 and f32,
    and of cuBLAS.  A Triton kernel's first call in a process costs
    seconds (its launcher and cubin loaded), so a follower's first
    whole-model train step took 13.3-14.4 s against rank 0's 0.09 (an
    H100 80GB HBM3 at 700 W, its disk cache warm); warmed here, on a
    thread while the serve phases run, a section does not wait for it.
    Returns the seconds (0 on rank 0 or the CPU)."""
    import torch

    from repro_torch.kernels import rms_norm, rms_norm_rstd

    if rs.mesh.rank == 0 or rs.device.type != "cuda":
        return 0.0
    t0 = time.perf_counter()
    with torch.enable_grad():
        for dt in (torch.bfloat16, torch.float32):
            a = torch.ones(64, 64, device=rs.device, dtype=dt)
            a @ a
            for d in WARM_WIDTHS:
                for rows in (16, 2048, 4096):
                    x = torch.randn(rows, d, device=rs.device, dtype=dt,
                                    requires_grad=True)
                    w = torch.ones(d, device=rs.device, dtype=dt,
                                   requires_grad=True)
                    rms_norm(x, w).sum().backward()
                    r = torch.ones(rows, device=rs.device)
                    rms_norm_rstd(x, w, r, width=2 * d,
                                  reduce=lambda s: s).sum().backward()
    torch.cuda.synchronize(rs.device)
    return time.perf_counter() - t0


def warm_mesh(started):
    """On a thread: once the mesh ``start_mesh`` started is up, every
    follower's ``mesh_warm`` in a session of its own; ``take_mesh`` waits
    for it (its error raised there)."""
    import threading

    from repro_torch.serve.tp import Session

    def run():
        started["thread"].join()
        if "error" in started:
            return
        t0 = time.perf_counter()
        try:
            mesh = started["mesh"]
            sess = Session(mesh, None, mesh.device_type)
            try:
                started["warm_s"] = (max(sess.run(mesh_warm)),
                                     time.perf_counter() - t0)
            finally:
                sess.close()
        except BaseException as e:      # noqa: BLE001 — raised by the join
            started["error"] = e
    started["warm"] = threading.Thread(target=run, daemon=True,
                                       name="mesh-warm")
    started["warm"].start()


def take_mesh(started, what):
    """The mesh ``start_mesh`` started, once up and, where ``warm_mesh``
    ran, its followers warmed (its error raised)."""
    t0 = time.perf_counter()
    started["thread"].join()
    if "warm" in started:
        started["warm"].join()
    if "error" in started:
        raise started["error"]
    mesh = started["mesh"]
    warm = ("" if "warm_s" not in started else
            "; its followers' kernels warmed in {:.1f} s ({:.1f} s with the "
            "session)".format(*started["warm_s"]))
    log(f"{what}: {mesh.describe()} (started in {started['s']:.1f} s, "
        f"waited {time.perf_counter() - t0:.1f} s for it{warm})")
    return mesh


def fsdp_section(smi, device="cuda", started=None, close=True):
    """The FSDP section: the mesh ``start_mesh("2,1")`` started (or one
    made now), the legs of ``FSDP_LEGS`` in turn, the mesh closed (left
    open for the TP train section's restore when ``close`` is False);
    returns the main paths' launches, every rank's summed.  Bars, each
    raising and printing its margin: (a) the first sharded train step
    against the single-rank gradient step on the same batch and state:
    loss, grad norm, and every leaf of m (then ``(1 - b1)`` times the
    clipped gradient) against the single rank's gradient, within
    ``TRAIN_TOL``:
    each rank's bf16 products over its half of the rows, summed in f32,
    against one bf16 product over all of them, rounded at other places
    as accum 2 x 4 against 1 x 8 is in ``train_phase``; (b) each rank's
    params, m and v bytes exactly half the whole tree's for every split
    leaf, the whole leaves listed; (c) on the legs with ``ckpt``:
    ``fsdp_checkpoint``; (d) on the legs with ``faults``: a sharded
    gradient step as built passes (a)'s comparison and each planted
    fault of ``FSDP_FAULTS`` fails it; (e) gathers and sums per step by
    their formula, the RMSNorm and SSD launch identities on both ranks.
    Each leg prints s/step and the bytes gathered and summed a step.
    ``device="cpu"``: a rehearsal at the tiny configs."""
    import torch

    t0 = time.perf_counter()
    mesh = take_mesh(started or start_mesh("2,1", device), "fsdp")
    launches = {}
    try:
        for arch in FSDP_LEGS:
            for k, n in fsdp_leg(mesh, arch, smi, device).items():
                launches[k] = launches.get(k, 0) + n
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
    except BaseException:
        mesh.close()
        raise
    if close:
        mesh.close()
    log(f"fsdp section: {time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------------------- tp train
# The tensor-parallel train section (``tp_train_section``; ``--phases
# tp_train``): a 2,2 mesh (rank = data x 2 + model), this process and
# three followers, all on the one card over gloo (four cards: nccl), so
# it shows the layout and its numbers, not a throughput.  Each leg at full
# width through ``launch.train.MeshTrain`` with the FSDP section's seeded
# f32 masters, bf16 compute, remat "full", the config's AdamW (bf16
# moments for mixtral) and its batch (``FSDP_BATCH``: each data rank 2
# of the 4 rows, the two ranks of a model group the same 2).  qwen2.5-14b
# at 1 layer,
# 1 step, no faults: its data axis also holds the FSDP bars (a), (b) and
# (e) that the FSDP section's qwen2.5-14b leg held on 2,1.  Its logits
# are 2 x 1024 rows x 76032 vocab columns a rank, 0.31 GB in bf16,
# gathered over the model group to 0.62 GB through the host.
# mamba2-780m at 2 layers, 2 steps, the planted faults (d) and the
# checkpoint (f).  mixtral-8x7b at 1 layer, 1 step: its bar (a)'s single
# rank takes the sharded step's expert ids (``moe_single``), held by a
# route check.  The MoE faults are planted in the CPU tests
# (``MOE_TRAIN_FAULTS``).
TP_TRAIN_LEGS = {
    "qwen2.5-14b": dict(layers=1, steps=1, faults=False, ckpt=False),
    "mamba2-780m": dict(layers=2, steps=2, faults=True, ckpt=True),
    # MoE under FSDP and tensor parallelism: every expert's d_model rows
    # over data and its d_ff columns over model, the registry's capacity
    # dispatch, the load-balance term's means over both data ranks'
    # rows; 1 of 32 layers (1.70 B params with the embedding and head)
    "mixtral-8x7b": dict(layers=1, steps=1, faults=False, ckpt=False),
}
# (d), each on every rank, each must fail bar (a): the enter op's backward
# not all-reducing; the gated norm's row term s_loc not all-reduced; the
# SSD's B/C weight gradient not summed over model, or summed twice; the
# clip norm counting the parts whole on every model rank M times; FSDP's
# gradient sum over the whole mesh's group in place of the data group
TP_TRAIN_FAULTS = ("enter_bwd_unsummed", "gated_norm_dot_local",
                   "bc_grad_unsummed", "bc_grad_twice",
                   "clip_norm_replicated_m_times", "fsdp_over_all_ranks")
# a MoE layer's, planted in the CPU tests (tests/test_torch_moe_mesh.py),
# each on every rank, each must fail the bars there: the combine weights
# not entering this rank's expert columns (the router's gradient from
# the token loss a per-rank partial sum); each data rank's own
# load-balance term; the term's data sum with a summing backward
MOE_TRAIN_FAULTS = ("moe_weights_enter_left_out", "aux_local",
                    "aux_bwd_summed")
# (a) and (d) on the faults' leg are also held in f32 compute, by this
# tighter bound: in bf16 a gradient's rounding differs by up to a few
# 1e-2 of a leaf between the sharded and the single step (``TRAIN_TOL``),
# while a wrong row term of the gated norm moves its input's gradient by
# about 1 / sqrt(2 x d_inner) = 1.3e-2 of its norm at mamba2's d_inner
# 3072 when the output gradient does not lean along the output, and the
# clip norm counting the whole parts twice moves it by about 6 % at 2
# layers (1.2e-4 at the rehearsal's tiny shape); in f32 the sharded and
# single steps differ only by the order of f32 sums (2.6e-7 in the norm,
# 1.1e-6 at worst in a leaf, in the rehearsal)
TRAIN_TOL_F32 = dict(loss=1e-5, grad_norm=1e-5, leaf=1e-4)


def tp_train_same(rs, state):
    """``Session.run``, bar (c): every part of this rank's params, m and v
    that is whole on every model rank (a leaf the rules leave whole on
    ``model``, the SSD mixer's B and C columns), gathered over the model
    group (uncounted: a check's collective) and held bit for bit against
    this rank's.  Returns (parts checked, their bytes, names that
    differ)."""
    import torch

    from repro_torch.models.layers import tree_leaves
    from repro_torch.sharding.fsdp import model_parts
    from repro_torch.steps import train_plan

    plan = train_plan(rs.cfg, rs.mesh)
    m = rs.mesh.shape["model"]
    n = nbytes = 0
    bad = []
    for name, t, sp in zip(leaf_names(state), tree_leaves(state),
                           tree_leaves(plan.state_tp())):
        _, part = model_parts(t, sp, m)
        if part is None:
            continue
        n += 1
        nbytes += part.numel() * part.element_size()
        parts = rs.mesh.all_gather(part.contiguous(), "model")
        if not all(torch.equal(p, parts[0]) for p in parts[1:]):
            bad.append(name)
    return n, nbytes, bad


def tp_train_collectives(cfg, plan, n, accum):
    """Bar (e)'s collectives of ``n`` steps on one rank by formula, each
    group's apart.  Model group, per microbatch: the forward all-reduces
    (the vocab-parallel embedding once; per layer its mixer's output, the
    gated norm's statistic in an SSD layer, a dense or MoE MLP's output;
    under remat "full" each repeat's again but its last: the recompute
    stops once it has remade every tensor the backward saved, before the
    repeat's closing all-reduce), one all-gather of the
    logits, the backward all-reduces of the enter op (per GQA layer its
    ``xn``, per MLA layer its q latent, ``ckv`` and ``k_rope``, per SSD
    layer its ``xn`` and the B/C columns of ``wxBC``, ``conv_w`` and
    ``conv_b``, per dense MLP its input, per MoE layer its input and its
    combine weights, the LM head's input once) and of the gated norm's
    row term (per SSD layer); per step the clip norm's one.  Data group:
    FSDP's gathers and sums (``fsdp_leg``'s formula) and, per MoE layer
    and microbatch, the load-balance term's means (again in the
    recompute under remat "full").  Returns (want, the formula as
    text)."""
    from repro_torch.models.layers import tree_leaves

    full = cfg.remat == "full"
    remat = 2 if full else 1
    fwd = enter = dot = moe = 0
    for spec in cfg.pattern:
        ssm = spec.kind == "ssm"
        mla = spec.kind == "attn" and spec.attn == "mla"
        mlp = spec.mlp != "none"
        fwd += 1 + ssm + mlp
        enter += (4 if ssm else 3 if mla else 1) + mlp + (spec.mlp == "moe")
        dot += ssm
        moe += spec.mlp == "moe"
    r = cfg.n_repeats
    again = r * (fwd - 1) if full else 0
    want = {"tp_all_reduce": n * accum * (1 + r * fwd + again),
            "tp_all_gather": n * accum,
            "tp_enter": n * accum * (1 + r * enter),
            "tp_norm_dot": n * accum * r * dot, "tp_sum": n}
    split = [d is not None for d in tree_leaves(plan.dims)]
    names = leaf_names(plan.dims)
    in_blocks = r * sum(s for s, p in zip(split, names)
                        if p.startswith("/blocks"))
    outside = sum(split) - in_blocks // r
    want["fsdp_gather"] = n * accum * (remat * in_blocks + outside)
    want["fsdp_sum"] = n * (accum * (in_blocks + outside + remat * r * moe)
                            + 4) if plan.mesh.shape["data"] > 1 else 0
    text = (f"model group: {want['tp_all_reduce'] // n} all-reduces "
            f"({accum} x (1 + {r} x {fwd} + {again} in the recompute)), "
            f"{want['tp_all_gather'] // n} all-gather, "
            f"{want['tp_enter'] // n} enter all-reduces ({accum} x (1 + {r}"
            f" x {enter})), {want['tp_norm_dot'] // n} row-term all-reduces,"
            f" 1 clip-norm sum; data group: {want['fsdp_gather'] // n} "
            f"gathers ({accum} x ({remat} x {in_blocks} + {outside})), "
            f"{want['fsdp_sum'] // n} sums"
            + (f" ({accum} x {remat} x {r * moe} of them the MoE "
               "load-balance term's means)" if moe and want["fsdp_sum"]
               else ""))
    return want, text


def tp_train_bytes(cfg, plan, template):
    """Bar (b)'s bytes of each leaf of a rank's train state by rule:
    {path: (bytes, class)}; classes "both" (1/(D M)), "data" (1/D),
    "model" (1/M), "tp_local" (the SSD's x channels 1/M, B and C whole)
    and "whole"."""
    from repro_torch.models.layers import tree_leaves

    d_n, m_n = plan.mesh.shape["data"], plan.mesh.shape["model"]
    out = {}
    for path, t, d, sp in zip(leaf_names(template), tree_leaves(template),
                              tree_leaves(plan.state_dims()),
                              tree_leaves(plan.state_tp())):
        b = t.numel() * t.element_size()
        if d is not None:
            b //= d_n
        if sp is None:
            kind = "data" if d is not None else "whole"
        else:
            full = t.shape[sp.dim]
            loc = (full // m_n if sp.width is None
                   else sp.width // m_n + full - sp.width)
            b = b * loc // full
            kind = ("tp_local" if sp.width is not None else
                    "both" if d is not None else "model")
        out[path] = (b, kind)
    return out


def tp_train_checkpoint(tr, cfg, hp, n, name, device, mesh21, seed):
    """Bar (f) on a leg's trainer after ``n`` steps: a save on the 2,2
    mesh (rank 0's UMT writes, each leaf assembled over both axes), then
    restored onto one device and onto the 2,1 mesh ``mesh21``, each equal
    to the saved state byte for byte.  Closes ``tr``."""
    import shutil

    import numpy as np

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import _host_bytes
    from repro_torch.core import UMTRuntime
    from repro_torch.launch.train import MeshTrain
    from repro_torch.models.layers import tree_leaves

    def differ(got, want):
        return [i for i, (a, b) in enumerate(zip(got, want))
                if a[1:] != b[1:] or not np.array_equal(a[0], b[0])]

    ckpt = ROOT / "build" / "tp_train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        with UMTRuntime(n_cores=2, umt=True) as rt:
            mgr = CheckpointManager(str(ckpt), rt=rt, keep=1)
            t0 = time.perf_counter()
            hosts = tr._snapshot(tr.state)
            t_snap = time.perf_counter() - t0
            mgr.save(tr.state, n, hosts=hosts, wait=True)
        tr.close()
        t0 = time.perf_counter()
        one, step = mgr.restore(state_meta(cfg), device=device)
        t_one = time.perf_counter() - t0
        bad_one = differ([_host_bytes(t) for t in tree_leaves(one)], hosts)
        del one
        t0 = time.perf_counter()
        tr21 = MeshTrain(cfg, hp, mesh21, device, FSDPState(seed))
        try:
            tr21.state, step21 = tr21.restore(str(ckpt), tr21.state)
            bad_21 = differ(tr21._snapshot(tr21.state), hosts)
        finally:
            tr21.close()
        t_21 = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    log(f"{name}: (f) saved on the 2,2 mesh at step {n} (the whole state "
        f"assembled on rank 0 in {t_snap:.2f} s, {len(hosts)} leaves); "
        f"restored onto one device in {t_one:.2f} s: {len(bad_one)} leaves "
        f"differ; onto a 2,1 mesh (restore and its snapshot) in "
        f"{t_21:.2f} s: {len(bad_21)} leaves differ (byte for byte)")
    if step != n or step21 != n or bad_one or bad_21:
        raise AssertionError(f"{name}: (f) the restores are not the saved "
                             f"state: steps {step} / {step21}, leaves "
                             f"{bad_one} / {bad_21}")


def moe_single(tr, cfg, ids, seed, tokens, labels, hp, name):
    """Bar (a)'s single rank for a MoE leg, after its one sharded step:
    the step's expert ids, recorded on every rank (``tp_routes_off``),
    must be equal across each model group by digest; the single-rank
    step routes to them in call order (each call's ids: the data ranks'
    rows in rank order) and the route check holds them where the single
    step's own choice is clear (``ROUTE_MARGIN_FIRST`` in the first MoE
    layer, which follows one attention layer; the calls in the order the
    step makes them: every repeat's forward, then under remat "full" the
    repeats' recomputes last to first).  At random init two bf16
    computations flip near-tied picks (1.6 % of the (layer, position)
    pairs of mixtral's TP serve path), and a flipped token's gradient is
    another token's: unforced, mixtral's single and sharded first steps
    differed by 7.6 % in the median leaf of m (an H100 80GB HBM3 at
    700 W).  Returns
    (``single_step``'s result, the leaves' gaps of m)."""
    import torch

    d_n, m_n = tr.sess.mesh.shape["data"], tr.sess.mesh.shape["model"]
    for d in range(d_n):
        group = ids[d * m_n:(d + 1) * m_n]
        if any(g[:2] != group[0][:2] for g in group):
            raise AssertionError(f"{name}: the model ranks of data group {d} "
                                 "picked other experts: "
                                 f"{[g[:2] for g in group]}")
    forced = [torch.cat([ids[d * m_n][2][j] for d in range(d_n)])
              for j in range(ids[0][0])]
    flips = []
    one = single_step(tr, seed, tokens, labels, routes=(forced, flips))
    scale = min(1.0, hp.clip_norm / (one[1] + 1e-9))
    gaps = tr.sess.run(fsdp_moments, tr.state, (1 - hp.b1) * scale)[0]
    per_rep = sum(spec.mlp == "moe" for spec in cfg.pattern)
    order = list(range(cfg.n_repeats))
    if cfg.remat == "full":
        order += order[::-1]
    layers = [r * per_rep + i for r in order for i in range(per_rep)]
    layers *= len(flips) // len(layers)
    assert len(layers) == len(flips), (len(layers), len(flips))
    f = route_check(flips, moe_layers(cfg), [0] * len(flips), layers)
    log(f"{name}: the single rank's gradient step (on rank 0, each rank "
        f"keeps its blocks), routed as the sharded step ({ids[0][0]} MoE "
        f"calls, digests equal in each model group: "
        + ", ".join(f"crc {g[1][2]:08x}" for g in ids[::m_n])
        + f"): loss {one[0]:.6f}, clip norm {one[1]:.6f} ({one[2]:.1f} s)")
    log(route_line(f"{name}: route check", f)
        + f" (the recompute's calls counted again; {len(flips[0][0])} "
        "pairs a call)")
    if f["wide_flips"]:
        raise AssertionError(f"{name}: the sharded step's experts differ from "
                             f"the single step's own at {f['wide_flips']} "
                             "pairs whose margin is above the bound")
    return one, gaps


def tp_train_leg(mesh, arch, smi, device="cuda", seed=0, mesh21=None):
    """One tensor-parallel train leg (``TP_TRAIN_LEGS[arch]``; the bars in
    ``tp_train_section``); returns the main path's launches, every rank's
    summed.  ``device="cpu"``: a rehearsal at the tiny config."""
    import collections

    import torch

    from repro_torch.configs import get
    from repro_torch.launch.train import MeshTrain
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim import OptHParams
    from repro_torch.serve.tp import counters, tree_bytes
    from repro_torch.steps import train_plan

    t_leg = time.perf_counter()
    leg = TP_TRAIN_LEGS[arch]
    micro, seq, accum = (FSDP_BATCH[k] for k in ("micro", "seq", "accum"))
    card = device == "cuda"
    cfg = get(arch)
    if card:
        cfg = cfg.replace(n_layers=leg["layers"])
    else:                               # the rehearsal's tiny shapes
        cfg, seq = cfg.tiny(remat="full"), 16
    assert cfg.remat == "full"
    n, name = leg["steps"], f"tp_train {arch}"
    hp = OptHParams(**FSDP_HP)
    plan = train_plan(cfg, mesh)
    names = leaf_names(plan.dims)
    template = state_meta(cfg)
    n_params = sum(t.numel() for t in tree_leaves(template["params"]))
    g = torch.Generator(device).manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (accum, micro, seq), generator=g,
                           device=device, dtype=torch.int32).cpu()
    labels = tokens.clone()
    labels[0, 0, :seq // 2] = -1     # data rank 0's rows: fewer labels
    batch = {"tokens": tokens, "labels": labels}
    data, model = mesh.shape["data"], mesh.shape["model"]
    log(f"{name} ({smi}): {cfg.n_layers} of {get(arch).n_layers} layers, "
        f"d {cfg.d_model}, {n_params / 1e6:.1f} M params ({cfg.param_dtype}"
        f" masters, {cfg.dtype} compute, {cfg.opt_dtype} AdamW, remat "
        f"{cfg.remat}); microbatches {micro} x {seq} (each data rank "
        f"{micro // data} rows), accum {accum}; {mesh.describe()}")
    tr = MeshTrain(cfg, hp, mesh, device, FSDPState(seed))
    try:
        tr.sess.run(tp_peak, True)
        # (b) each rank's params, m and v by rule
        want_b = tp_train_bytes(cfg, plan, template)
        per_rank = tr.sess.run(tree_bytes, tr.state)
        for rank, held in enumerate(per_rank):
            bad = {p: (held[p][0], b) for p, (b, _) in want_b.items()
                   if held[p][0] != b}
            if bad:
                raise AssertionError(f"{name}: (b) rank {rank} holds / "
                                     f"should hold {bad}")
        kinds = collections.Counter(k for _, k in want_b.values())
        held = [sum(b for p, (b, _) in h.items() if p != "/step")
                for h in per_rank]
        whole_b = sum(t.numel() * t.element_size()
                      for t in tree_leaves(template))
        log(f"{name}: (b) params, m and v per rank "
            f"{[round(h / 1e9, 3) for h in held]} GB of "
            f"{whole_b / 1e9:.3f}, every leaf by rule: {kinds['both']} "
            f"split on both axes (1/{data * model}), {kinds['data']} on data "
            f"(1/{data}), {kinds['model']} on model (1/{model}), "
            f"{kinds['tp_local']} the SSD's TP_LOCAL (x channels 1/{model}, "
            "B and C whole), whole on every rank: " + ", ".join(
                p for p, (_, k) in want_b.items()
                if k == "whole" and p.startswith("/params")))
        if leg["faults"]:
            # (a) in f32 compute, and (d): each planted fault through a
            # sharded gradient step must fail it
            t0 = time.perf_counter()
            one = single_step(tr, seed, tokens, labels, "float32")
            got = tr.sess.run(fsdp_probe, tr.state, tokens, labels,
                              "float32")[0]
            if not fsdp_verdict(name, "(a) a sharded gradient step in f32 "
                                "compute", got, one, names, TRAIN_TOL_F32):
                raise AssertionError(f"{name}: (a) the sharded f32 gradient "
                                     "step disagrees with the single rank's")
            for fault in TP_TRAIN_FAULTS:
                tr.sess.run(fsdp_on, fault)
                got = tr.sess.run(fsdp_probe, tr.state, tokens, labels,
                                  "float32")[0]
                tr.sess.run(fsdp_off, fault)
                if fsdp_verdict(name, f"(d) planted: {fault}", got, one,
                                names, TRAIN_TOL_F32):
                    raise AssertionError(f"{name}: (a) does not reject the "
                                         f"planted fault {fault}")
            log(f"{name}: (d) in f32 compute {time.perf_counter() - t0:.1f}"
                " s")
        # (a)'s single rank, each rank's blocks of it kept; with MoE it
        # takes the expert ids of the sharded step (recorded on every
        # rank, ``moe_single``), so it runs after that step
        moe = moe_layers(cfg) > 0
        if not moe:
            one = single_step(tr, seed, tokens, labels)
            log(f"{name}: the single rank's gradient step (on rank 0, each "
                f"rank keeps its blocks): loss {one[0]:.6f}, clip norm "
                f"{one[1]:.6f} ({one[2]:.1f} s)")

        # the main path: ``n`` train steps on every rank, counted; (a) on
        # its first step, (c) after each
        tr.sess.run(counters, True)
        if moe:
            assert n == 1, "a MoE leg's bar (a) follows its one step"
            tr.sess.run(tp_routes_on)
        losses, times, same = [], [], []
        for step in range(n):
            t0 = time.perf_counter()
            tr.state, m = tr.step(tr.state, batch)
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t0)
            if step == 0:
                norm0 = float(m["grad_norm"])
                if moe:
                    ids = tr.sess.run(tp_routes_off, True)
                else:
                    scale = min(1.0, hp.clip_norm / (one[1] + 1e-9))
                    gaps = tr.sess.run(fsdp_moments, tr.state,
                                       (1 - hp.b1) * scale)[0]
            same.append(tr.sess.run(tp_train_same, tr.state))
        per_rank = tr.sess.run(counters)
        if moe:
            one, gaps = moe_single(tr, cfg, ids, seed, tokens, labels, hp,
                                   name)
        if not fsdp_verdict(name, "(a) the first train step (its m is (1 - "
                            "b1) x the clipped gradient)",
                            (losses[0], norm0, gaps), one, names):
            raise AssertionError(f"{name}: (a) the sharded train step "
                                 "disagrees with the single rank's")
        bad = [(k, r, s[2]) for k, ranks in enumerate(same)
               for r, s in enumerate(ranks) if s[2]]
        log(f"{name}: (c) after each step, on every rank, {same[0][0][0]} "
            f"parts of params, m and v whole on every model rank "
            f"({same[0][0][1] / 1e6:.1f} MB) equal to the model group's "
            f"bit for bit: {'no' if not bad else len(bad)} differences")
        if bad:
            raise AssertionError(f"{name}: (c) replicated parts differ "
                                 f"across the model group: {bad[:4]}")
        # (e) collectives a step on each group, the kernels' identities
        want, text = tp_train_collectives(cfg, plan, n, accum)
        ids, id_text = train_identities(cfg, per_rank[0], n * accum,
                                        tp=model > 1)
        for rank, c in enumerate(per_rank):
            bad = {k: (c[k], w) for k, w in want.items() if c[k] != w}
            if card:
                bad.update({k: (c[k], w) for k, w in ids.items()
                            if c[k] != w})
            if bad:
                raise AssertionError(f"{name}: (e) rank {rank}: got / want "
                                     f"{bad}")
        c0 = per_rank[0]
        model_b = sum(c0[f"{k}_bytes"] for k in (
            "tp_all_reduce", "tp_all_gather", "tp_enter", "tp_norm_dot",
            "tp_sum")) / n / 1e9
        data_b = (c0["fsdp_gather_bytes"] + c0["fsdp_sum_bytes"]) / n / 1e9
        log(f"{name}: (e) per rank and step {text}; bytes a step on rank 0: "
            f"model group {model_b:.3f} GB (the logits' gather "
            f"{c0['tp_all_gather_bytes'] / n / 1e9:.3f}), data group "
            f"{data_b:.3f} GB ({c0['fsdp_gather_bytes'] / n / 1e9:.3f} "
            f"gathered, {c0['fsdp_sum_bytes'] / n / 1e9:.3f} summed); "
            f"launches on each rank: {id_text}")
        log(f"{name}: losses {' '.join(f'{x:.4f}' for x in losses)}; "
            f"s/step {' '.join(f'{t:.3f}' for t in times)}"
            + (" (four ranks sharing one device over gloo: not a "
               "throughput)" if mesh.backend == "gloo" else ""))
        peaks = tr.sess.run(tp_peak)
        if leg["ckpt"]:
            tp_train_checkpoint(tr, cfg, hp, n, name, device, mesh21, seed)
    finally:
        tr.close()
    total = collections.Counter()
    for c in per_rank:
        total.update({k: v for k, v in c.items()
                      if not k.startswith(("tp", "fsdp"))})
    log(f"{name}: peak device memory per rank "
        f"{[round(p / 1e9, 2) for p in peaks]} GB; leg "
        f"{time.perf_counter() - t_leg:.1f} s")
    return dict(total)


def tp_train_section(smi, device="cuda", started=None, mesh21=None):
    """The tensor-parallel train section: the mesh ``start_mesh("2,2")``
    started (or one made now), the legs of ``TP_TRAIN_LEGS`` in turn, the
    mesh closed (and ``mesh21``, the 2,1 mesh the checkpoint restores
    onto: the FSDP section's, or one made now); returns the main paths'
    launches, every rank's summed.  Bars, each raising and printing its
    margin: (a) the first train step against the single-rank gradient
    step on the same batch and state: loss, grad norm and every leaf of m
    within ``TRAIN_TOL`` (the FSDP section's (a)), and on the faults' leg
    a sharded gradient step in f32 compute within ``TRAIN_TOL_F32``; on
    a MoE leg the single rank routes as the sharded step did, its route
    check held (``moe_single``); (b)
    each rank's params, m and v bytes by rule (``tp_train_bytes``), the
    whole leaves listed; (c) after every step, every part whole on every
    model rank equal across the model group bit for bit
    (``tp_train_same``); (d) on the faults' leg each planted fault of
    ``TP_TRAIN_FAULTS`` fails (a) in f32; (e) the collectives a step on
    each group by formula (``tp_train_collectives``) and the launch
    identities of RMSNorm (forward, backward and the given-statistic
    backward's two entries) and of the SSD scan forward and backward on
    all four ranks; (f) on the checkpoint's leg a save on 2,2 restored
    onto one device and onto 2,1, byte for byte.  Each leg prints s/step
    and the bytes a step on each group.  ``device="cpu"``: a rehearsal at
    the tiny configs."""
    import torch

    t0 = time.perf_counter()
    mesh = take_mesh(started or start_mesh("2,2", device), "tp_train")
    own = mesh21 is None
    launches = {}
    # a CPU rehearsal's rank 0 computes on one thread, as its followers
    # do: bar (c) is the bit-equality of one computation in one order
    threads = torch.get_num_threads()
    if device == "cpu":
        torch.set_num_threads(1)
    try:
        if own:
            mesh21 = take_mesh(start_mesh("2,1", device), "tp_train restore")
        for arch in TP_TRAIN_LEGS:
            for k, n in tp_train_leg(mesh, arch, smi, device,
                                     mesh21=mesh21).items():
                launches[k] = launches.get(k, 0) + n
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
    finally:
        torch.set_num_threads(threads)
        mesh.close()
        if mesh21 is not None:
            mesh21.close()
    log(f"tp_train section: {time.perf_counter() - t0:.1f} s")
    return launches


def check_launches(cfg, launches, stats, calls, name=None, kernels=None):
    """The phase's launch identities: each kernel once per layer of the
    kind that launches it (``kind_layers``) in each decode tick (paged
    attention) or one-shot prefill (SSD scan, flash attention), or never
    (a kernel the phase's path must not take); RMSNorm at every norm site
    (``norm_sites``) of every tick, one-shot prefill and chunk
    (a chunk that skips the LM head skips the final norm too); gathers
    launch none.  The engine's step calls (``calls``) are first held to
    its own counters.  ``kernels`` (a spec leg): the leg's own kernel
    map in place of the phase's; a verify call counts as a tick."""
    name = name or arch_of(cfg)
    phase = PHASES[name]
    kernels = phase["kernels"] if kernels is None else kernels
    n_chunks = calls["chunk"] + calls["chunk_mid"]
    ticks = calls["decode"] + calls["verify"]
    held = {"decode_dispatches": (ticks, stats["decode_dispatches"]),
            "prefill_calls": (calls["prefill"] + calls["chunk"],
                              stats["prefill_calls"]),
            "prefill_chunks": (n_chunks, stats["prefill_chunks"]),
            "prefix_hits": (calls["gather"], stats["prefix_hits"])}
    for k, (got, want) in held.items():
        if got != want:
            raise AssertionError(f"{name}: step calls give {k} {got}, the "
                                 f"engine counted {want}")
    norms = norm_sites(cfg)
    per_kind = {k: kind_layers(cfg, KERNEL_KIND[k]) for k in kernels}
    want = {k: per_kind[k] * calls[per] if per else 0
            for k, per in kernels.items()}
    want["rms_norm"] = (norms + 1) * (ticks + calls["prefill"]
                                      + calls["chunk"] + calls["replay"]) \
        + norms * calls["chunk_mid"]
    for k, n in want.items():
        if launches[k] != n or (n <= 0 and kernels.get(k, True)):
            raise AssertionError(f"{name}: {k} launches {launches[k]} != "
                                 f"{n} (identity of the main path)")
    parts = [f"{k} {launches[k]} = " + (
        f"{per_kind[k]} {KERNEL_KIND[k]} layers x {calls[per]} {per}"
        if per else "0 (not on this path)") for k, per in kernels.items()]
    log(f"launch identities ({name}): " + "; ".join(parts)
        + f"; rms_norm {launches['rms_norm']} = {norms + 1} x "
        f"({calls['decode']} decode + {calls['verify']} verify + "
        f"{calls['prefill']} prefill + "
        f"{calls['chunk']} final chunks + {calls['replay']} replay steps) "
        f"+ {norms} x {calls['chunk_mid']} other chunks; {calls['gather']} "
        "gathers")


def check_cli(smi, arch="qwen2.5-14b", seed=1, prompt_len=1000):
    """The port's CLI (``repro_torch.launch.serve``) on the card at full
    width and depth: the engine (paged kernel, chunked prefill, prefix
    cache on) and the one-shot path, same weights (seed 0) and prompts
    (``seed``; (P, K) codebook ids for musicgen-large).  Each run's
    launches of its kernels must be above zero, and each token set is
    held by the teacher-forced token check (``LOGIT_TOL``, each codebook
    a token for audio), so the two are equal within that tolerance; how
    many tokens agree exactly is printed."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get
    from repro_torch.launch import serve as cli
    from repro_torch.models.lm import init_params

    cfg = get(arch)
    extra, _ = frontend_shape(cfg)
    argv = ["--arch", arch, "--batch", "4", "--requests", "4",
            "--prompt-len", str(prompt_len), "--gen", "16", "--seed",
            str(seed)]
    legs = {"engine": (["--paged-kernel", "--chunk", "512",
                        "--prefix-cache", "on"],
                       ("paged_decode_attention", "rms_norm")),
            "oneshot": (["--mode", "oneshot"],
                        ("flash_attention", "rms_norm"))}
    out = {}
    for leg, (more, used) in legs.items():
        for k in used:
            getattr(kernels, k).launches.reset()
        toks = np.asarray(cli.serve(argv + more), np.int32)
        got = {k: getattr(kernels, k).launches.value for k in used}
        if tuple(toks.shape) != (4, 16) + extra or min(got.values()) <= 0:
            raise AssertionError(f"CLI {leg}: tokens {toks.shape}, "
                                 f"launches {got}")
        out[leg] = toks
        log(f"CLI {leg} ({arch}, {smi}): launches {got}")
        torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
    prompts, patches = cli._prompts(cfg, 4, prompt_len, seed)
    worst = {}
    for leg, toks in out.items():
        gaps = [token_gaps(forced_logits(
            cfg, params, p, t, "cuda",
            None if patches is None else torch.tensor(patches[i],
                                                      device="cuda")),
            t).max().item() for i, (p, t) in enumerate(zip(prompts, toks))]
        worst[leg] = max(gaps)
    same = int((out["engine"] == out["oneshot"]).sum())
    log(f"CLI token sets ({arch}): {same}/{out['engine'].size} equal; "
        f"worst teacher-forced gap engine {worst['engine']:.4f}, oneshot "
        f"{worst['oneshot']:.4f} (tolerance {LOGIT_TOL})")
    if max(worst.values()) > LOGIT_TOL:
        raise AssertionError(f"CLI: a token trails the forward's argmax by "
                             f"{max(worst.values()):.4f} > {LOGIT_TOL}")
    del params


# the sections on a mesh, by their mesh spec ("DATA,MODEL")
SECTIONS = {"tp": "1,2", "tp_heads": "1,3", "fsdp": "2,1", "tp_train": "2,2"}


def build_all():
    """Every kernel library built at once: one ``nvcc`` per source, started
    together, then the Triton kernel compiled by a first call."""
    import threading

    import torch

    from repro_torch.kernels import build, rms_norm
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops

    t0 = time.perf_counter()
    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:            # noqa: BLE001 — re-raised below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(fn,)) for fn in (
        paged_ops.library, paged_ops.mla_library, ssd_ops.library,
        ssd_ops.bwd_library, flash_ops.library)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    t_nvcc = time.perf_counter() - t0
    x = torch.ones(2, 64, device="cuda")
    rms_norm(x, torch.ones(64, device="cuda"))          # Triton compiles
    torch.cuda.synchronize()
    log(f"build: five nvcc builds in parallel, all ready in {t_nvcc:.2f} s; "
        f"triton first call {time.perf_counter() - t0 - t_nvcc:.2f} s")
    for name, info in build.build_log.items():
        log(f"  {name}: nvcc {info['seconds']:.2f} s")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log("    ptxas:", line.strip())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=0,
                    help="cut every serve phase to this depth (0: full "
                         "depth; width is never cut)")
    ap.add_argument("--phases", default=",".join((*PHASES, *SECTIONS)),
                    help="comma-separated phases to run (default: all, in "
                         "order; \"tp\" is the tensor-parallel section, "
                         "\"tp_heads\" its replicated heads on 1,3, "
                         "\"fsdp\" the sharded train state's, \"tp_train\" "
                         "tensor parallelism in training)")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not set(phases) <= {*PHASES, *SECTIONS}:
        ap.error(f"--phases: pick from {', '.join((*PHASES, *SECTIONS))}")

    smi = card()
    import torch

    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def timed(fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        log(f"{fn.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    timed(build_all)
    meshes = {name: start_mesh(spec) for name, spec in SECTIONS.items()
              if name in phases}
    rows = [*timed(check_paged_decode), timed(check_rms_norm),
            timed(check_rms_norm_bwd), timed(check_rms_norm_rstd_bwd),
            timed(check_paged_mla), timed(check_ssd), timed(check_ssd_bwd),
            *timed(check_flash), *timed(check_tp_kernels)]
    log(f"clocks after the kernel timings (sm, power, temp): {clocks()}")
    for started in meshes.values():     # after the timings: no contention
        warm_mesh(started)
    from repro_torch.configs import get

    launches = {}
    for name in phases:
        if name in SECTIONS:        # every rank's launches, summed
            if name in ("tp", "tp_heads"):
                section = tp_section if name == "tp" else tp_heads_section
                got = timed(section, smi, layers=args.layers or None,
                            started=meshes[name])
            elif name == "fsdp":    # its mesh is tp_train's 2,1, if it runs
                got = timed(fsdp_section, smi, started=meshes[name],
                            close="tp_train" not in phases)
            else:
                got = timed(tp_train_section, smi, started=meshes[name],
                            mesh21=meshes.get("fsdp", {}).get("mesh"))
            for k, n in got.items():
                launches[k] = launches.get(k, 0) + n
            continue
        phase = PHASES[name]
        arch = phase.get("arch", name)
        cfg = get(arch)
        layers = args.layers or phase.get("layers", cfg.n_layers)
        if phase.get("train"):    # the train state bounds its depth
            layers = min(layers, phase.get("layers", cfg.n_layers))
        if layers != cfg.n_layers:
            log(f"depth cut: {layers} of {cfg.n_layers} layers "
                f"({name})")
            cfg = cfg.replace(n_layers=layers)
        cfg = cfg.replace(moe_impl=phase.get("moe_impl", cfg.moe_impl))
        if phase.get("train"):
            runs = [({}, train_phase(cfg, smi, name=name), None,
                     None)]
        elif "spec_k" in phase:
            runs = serve_spec(cfg, smi, name=name)
        else:
            runs = [(None, *serve(cfg, smi, name=name))]
        for kernels, got, stats, calls in runs:
            if calls is not None:   # the train phase checks its own
                check_launches(cfg, got, stats, calls, name=name,
                               kernels=kernels)
            for k, n in got.items():    # every phase's sum
                launches[k] = launches.get(k, 0) + n
        gc.collect()                # the phase's engine, if a cycle
        torch.cuda.empty_cache()    # the next phase's weights
    timed(check_cli, smi)
    # musicgen-large's codebook prompts through the CLI (CLI_AUDIO)
    timed(check_cli, smi, **CLI_AUDIO)
    timed(check_train_cli, smi)
    for k, n in timed(check_tools, smi).items():
        launches[k] = launches.get(k, 0) + n
    for row in rows:
        row["launches"] = launches.get(row["name"], 0)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    keys = ["name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"]
    extra = ["shape", "device_ms", "library_device_ms"]
    log(json.dumps({"kernels": [
        {k: row[k] for k in keys + extra if k in row} for row in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
