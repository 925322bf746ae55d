#!/usr/bin/env python3
"""Run the PyTorch port's serve and train paths on one NVIDIA card and
check them.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``) and
the repository's ``src/``; imports ``repro_torch``, ``torch`` and numpy,
never JAX.  Phases, each printing one JSON line:

1. ``device``      — the card (``nvidia-smi`` name and power limit), torch
                     and CUDA versions;
2. ``build``       — builds the CUDA kernels from ``src/repro_torch/kernels/
                     csrc`` with ``nvcc`` for ``sm_90a`` (into ``build/``);
3. ``kernels``     — each kernel against its plain PyTorch version on the
                     card, element by element, at the main paths'
                     full-width shapes and at edge cases (among them the
                     paged plane's admission prefill shapes, the other
                     configs' head groups (flash at llama4's, starcoder2's
                     and yi's 4 x 512 prefills, its backward at pixtral's
                     GQA train shape, the paged round at groups 4, 5, 7,
                     8 and 12, each timed; the paged kernel's ptxas lines
                     by instance in the build line), ragged and all-zero
                     quantization blocks, the SSD scan's ragged and short
                     sequences, initial states and extreme timesteps),
                     (among them MLA's prefill and train shapes at head
                     dims 192 | 128, forward and backward, and f32,
                     unaligned, D = 136 and Dv = 64 cases at D > 128,
                     each launch's route counted; the RMSNorm backward at
                     MLA's norm widths, 1536 and 512; the int8 AdamW on
                     a 2.52e9-element expert leaf and on pixtral_12b's
                     w_up, embedding and head; the RMSNorm and its
                     backward at xlstm_350m's 8192 rows of 1024 and
                     2048, the fp32 AdamW on its leaves of last dims 8
                     and 1365; the sLSTM recurrence forward and backward
                     at its 4 x 2048 positions of 4 heads of 256, bf16
                     and fp32, the states and cotangents element by
                     element, bit for bit over two calls, and at one
                     head, S = 1, strided gates, fp32 from a state), with
                     its time, the
                     plain version's, one PyTorch library call's where one
                     computes the same function, and the least time the
                     card could take; each redesigned kernel also beside
                     the route it took before (``was_ms``: the flash
                     kernels' CUDA-core route, the scalar routes of the
                     fused AdamW, the paged decode kernel, the SSD scan,
                     its backward and the RMSNorm backward), on a copy of
                     its input one element off alignment, held by the same
                     check (the RMSNorm forward's scalar route on the same
                     inputs, at every main-path shape, MLA's kv_a[..., :512]
                     slice read in place among them, each also timed with
                     the L2 flushed clean, and its decode rows in a
                     captured graph beside the floor of its smallest call;
                     its edge cases' routes checked, its vector route's
                     ptxas lines free of spills); the flash backward, the
                     paged kernel, the SSD
                     scan, its backward and the RMSNorm backward twice,
                     bit for bit; the SSD scan's, its backward's and the
                     RMSNorm backward's kernels timed apart
                     (``passes_ms``), each held under a guard time
                     (``GUARD_MS``); the SSD backward's seven cotangents
                     each element by element at zamba2_2p7b's train shape
                     and at edge cases, each case's route checked, and
                     its tensor-core kernels' ptxas lines free of spills;
4. ``serve_dense`` — ``repro_torch.launch.serve`` on deepseek_7b at full
                     width (random bf16 weights from the seed): batched
                     prefill + greedy decode, the decode steps as CUDA
                     graph replays (one capture, a replay a step, no
                     eager decode step), the kernels' launches exactly,
                     the prefill logits against the same path with
                     ``impl="torch"``, and 31 replays against 31 eager
                     steps from one state (every token and the cache's
                     bits equal; ``captured_vs_eager``), with a sampling
                     job's captured decode against its eager one on both
                     planes at smoke size (``sampled_vs_eager``);
5. ``serve_paged`` — a paged serve ``BlockRuntime`` on the same model: 12
                     generate sessions through 8 slots, the decode rounds
                     as graph replays, the launches exactly, the logits
                     of two admission prefills (two prompt buckets) and
                     of the first decode round against ``impl="torch"``,
                     tokens/s and TTFT, then the same traffic with the
                     rounds run eagerly from the same (empty) state: every
                     session's tokens and the pool's bits equal;
5b. ``serve_sharded`` — the serve block on a mesh (item 8c) under a
                     process group of one rank (NCCL, a ``HashStore``):
                     serve_dense's job through the launcher on a (1, 1)
                     DeviceMesh, every param a DTensor gathered a group
                     at a time inside the captured decode's graph, its
                     tokens serve_dense's bit for bit and its launches
                     exactly; warm prefill and decode, the graph's
                     capture time and pool, the host's enqueue of a
                     replay and of an eager step, peak memory; a save
                     and ``suspend()`` halfway, a fresh block restoring
                     the decode context bit for bit and decoding the
                     rest equal; serve_paged's 12 sessions on a (1, 1)
                     mesh, their tokens and launches serve_paged's; the
                     dense plane through the tensor-parallel path of
                     item 8d at M = 1 (its ``tp`` dict: M, heads, the
                     rules that kept 8a's layout, the bytes gathered
                     over ``model`` a step, 0 by construction at M = 1,
                     and the leaves ``full`` handed back as their model
                     shard);
6. ``serve_hybrid`` — ``repro_torch.launch.serve`` on zamba2_2p7b (the
                     hybrid family: Mamba2 + shared attention) at full
                     width, 54 layers, random bf16 weights from the seed:
                     4 x 1000 prompt tokens, 32 generated, the decode
                     steps as graph replays held against eager ones as in
                     ``serve_dense``; the launches of
                     one prefill and one decode step, exactly; the prefill
                     logits and the first decode step's (from the state
                     each prefill left) against ``impl="torch"`` in fp32
                     (the weights upcast) within 0.1% of their range, and
                     in bf16 each group's output, fed the same input,
                     within 5% of the range of its update, and the SSM
                     states within 5% of theirs (``hybrid_group_check``);
7. ``serve_vlm``   — ``repro_torch.launch.serve`` on pixtral_12b (the VLM:
                     mistral_nemo_12b's backbone behind the patch stub) at
                     full size, 40 layers, random bf16 weights from the
                     seed: 4 prompts of 2048 positions (256 image patches,
                     then 1792 text tokens), 32 generated, the decode
                     steps as graph replays held against eager ones as in
                     ``serve_dense``; the launches exactly; the prefill
                     logits against ``impl="torch"``; the decode steps
                     written at positions n_patches + T onward;
8. ``serve_moe``   — ``repro_torch.launch.serve``'s ``run`` on
                     deepseek_v2_236b (the moe family: MLA attention, 2
                     shared and 160 routed experts, top-6) at full width,
                     cut to 7 of its 60 layers, random bf16 weights from
                     the seed: 4 x 512 prompt tokens, 32 generated, held
                     as ``serve_dense`` (MLA's prefill runs flash at head
                     dim 192, its absorbed decode plain einsums; the
                     logits checked with the plain run's routing replayed,
                     a top-k swap near a tie moving the capacity's slots
                     of later tokens, and read with their own); besides,
                     the share of routing choices the capacity dropped in
                     the prefill and a decode step, the decode bound (the
                     weights' bytes over the memory rate), its idle share
                     and the expert products' share of the prefill;
9. ``serve_xlstm`` — ``repro_torch.launch.serve`` on xlstm_350m (the xlstm
                     family: 3 groups of 7 mLSTM and 1 sLSTM blocks) at
                     full size, random bf16 weights from the seed: 4 x
                     2048 prompt tokens, 32 generated, the decode steps as
                     graph replays held against eager ones; the launches
                     of one prefill and one decode step exactly (49
                     RMSNorms and 3 sLSTM recurrences each); the prefill
                     logits and the first
                     decode step's against ``impl="torch"`` in fp32 (the
                     weights upcast, the sLSTM's bf16 stacking taken out)
                     within 0.5% of their range, in bf16 each sublayer,
                     fed the same input, within 5% of the range of its
                     update, and the recurrent states within 5% of theirs
                     (``xlstm_sublayer_check``); the sLSTM blocks' share
                     of a warm prefill;
8b. ``serve_llama4`` — ``run`` on llama4_maverick_400b (the moe family
                     with GQA 40 / 8: a dense layer, then a MoE layer of
                     128 routed experts top-1 and a shared one) at full
                     width, cut to one group (2 of its 48 layers, 37.1
                     GB), held as ``serve_moe`` (4 x 512 prompt tokens,
                     32 generated, the logits with the plain run's
                     routing replayed, the drops, the decode bound);
8c. ``serve_llama4_paged`` — the same cut on the paged plane, held as
                     ``serve_paged`` (serve_paged's traffic, the rounds
                     captured over the {dense, moe} pool, the logits with
                     the routing replayed), the paged kernel at the
                     group of 5; the choices the capacity dropped of the
                     live and the idle slots, the prompts' tokens and
                     their page padding; the round against its bound;
8d. ``serve_dense_groups`` — starcoder2_15b (LayerNorm and a plain GELU
                     MLP: no RMSNorm launch; GQA 48 / 4) and yi_34b (GQA
                     56 / 8, 68.8 GB) whole, each through the dense
                     plane (4 x 512 prompt tokens, 16 generated, held as
                     ``serve_dense``) and the paged plane (12 sessions
                     of 8 tokens, held as ``serve_paged``), each block
                     freed before the next is built;
10. ``train``       — a train ``BlockRuntime`` on deepseek_7b at full width
                     (30 layers, random bf16 weights from the seed, int8
                     AdamW moments, 2 x 2048 tokens a step, remat): the
                     step-0 loss and grad norm against ``impl="torch"``,
                     then six steps with their losses, tokens/s, step time,
                     peak memory, the kernels' launches per step (held
                     exactly, as in every train phase) and a profiled
                     warm step;
10b. ``train_overlap`` — the compressed cross-pod gradient all-reduce
                     (item 9): deepseek_7b at full width cut to 8 of 30
                     layers, 2 x 2048 tokens in 2 microbatches, on a
                     (1, 1, 1) ``("pod", "data", "model")`` mesh of one
                     NCCL rank; with int8 moments, then fp32, the serial
                     step, then ``make_train_step(overlap_comm=True)``
                     from the same seed: step 0's loss bit for bit, its
                     grad norm within the last microbatch's residual,
                     the launches the serial path's, with fp32 moments
                     the 6 losses within rtol/atol 0.05 (int8's diverge
                     on both paths: printed), the codec on the card the
                     CPU's bit for bit; step times, peak memories, the
                     error feedback's bytes, the codec's profiled device
                     time; with int8 moments two more runs that tell the
                     overlap's ordering from the algorithm: (a) the
                     overlapped step with the device synchronized around
                     each pod reduce, (b) a serial step through
                     ``compressed_psum_pod``, their losses printed beside
                     the serial and overlapped ones;
10c. ``dryrun``     — the port's dry run (item 10) of ``train``'s job in
                     a CPU subprocess on a fake process group: status
                     ``ok``, its state bytes ``train``'s exactly, its
                     predicted peak and roofline step time beside
                     ``train``'s measured ones;
11. ``train_f32``   — the same width cut to 4 layers with fp32 moments and
                     2 microbatches: the fp32 AdamW variant and the serial
                     gradient accumulation;
12. ``blocks``     — two tenant blocks at once in one ``ClusterDaemon``,
                     each on a mesh and process groups of its own, under
                     a process group of one rank (NCCL, a ``HashStore``)
                     whose topology maps 3 chips onto that rank: alice's
                     train block runs train_f32's job on the sharded
                     runtime, carol's serve block serve_hybrid's job, two
                     rounds of ``step_all``; alice saves at step 2, her
                     chip fails, the controller migrates her onto the
                     spare chip (her old state released first) and
                     restores her state bit for bit; her 3 losses and
                     grad norms train_f32's and carol's 32 tokens
                     serve_hybrid's, bit for bit, the launches exactly
                     theirs; failure-to-first-step, save and restore
                     seconds, peak memory across the migration, each
                     block's step time co-resident against alone;
13. ``train_hybrid`` — a train ``BlockRuntime`` on zamba2_2p7b at full width
                     (54 layers, random bf16 weights from the seed, fp32
                     AdamW moments, 2 x 2048 tokens a step, remat): step 0
                     in fp32 (the weights upcast) against ``impl="torch"``
                     under the dense phases' limits, and the bf16 step 0
                     against the fp32 one, within 1.25 times the plain
                     version's bf16 distance (``step0_upcast_check``),
                     then 4 steps, the kernels' launches per step held
                     exactly (the SSD scan's backward kernel among them),
                     tokens/s, step time, peak memory and a profiled step;
13b. ``hybrid_sharded`` — the hybrid family through the sharded runtime
                     (item 8g, part 1) under a process group of one rank
                     (NCCL, a ``HashStore``): train_hybrid's job and
                     serve_hybrid's launcher job on a (1, 1) DeviceMesh,
                     the Mamba2 heads, shared attention, MLP and
                     vocabulary on the tensor-parallel path at M = 1;
                     the losses, grad norms, tokens, prefill and first
                     decode logits and launches theirs, bit for bit;
13c. ``serve_long`` — zamba2_2p7b at full width, B = 1, on long_500k's
                     524288-position cache (48.3 GB of K/V): a
                     32768-token prefill and 16 captured greedy decode
                     steps, unsharded, then through the sharded runtime
                     at (1, 1) on the sequence-split cache's path (item
                     8g, part 3), taken at one data rank by the phase's
                     own context (``seq_split_forced``: the runtime's
                     rule keeps a batch that splits over one data rank
                     whole) and printed (``seq_split``), tokens and
                     logits bit for bit; the chunked decode
                     attention against the whole softmax on one layer's
                     full-size cache; the decode step against its bound,
                     the peak memory against the dry run's for the same
                     cell, each kernel's largest tensor against 2^31
                     elements;
14. ``train_encoder`` — a train ``BlockRuntime`` on hubert_xlarge (the
                     encoder: LayerNorm, plain GELU MLP, bidirectional
                     attention at head dim 80, the frame stub, the
                     masked-frame loss) at full size, 48 layers, fp32
                     moments, 8 x 1024 frames a step: step 0 as
                     ``train_hybrid``'s, 5 steps with their launches held
                     exactly (no RMSNorm), frames/s, MFU, a profiled step;
14b. ``train_vlm`` — a train ``BlockRuntime`` on pixtral_12b at full
                     width, cut to 20 of its 40 layers, int8 moments, 2 x
                     2048 positions a step (the stub's 256 patches, then
                     text): step 0 as ``train_hybrid``'s, run before the
                     block's state exists, then 5 steps with their
                     launches held exactly (the flash backward's dk/dv
                     summed over the group of 4 on the tensor cores),
                     tok/s, MFU, peak memory and what it leaves free, a
                     profiled step;
15. ``train_moe``  — ``repro_torch.launch.train``'s ``run(args, cfg)`` on
                     deepseek_v2_236b (MLA, 160 routed experts top-6 and 2
                     shared) at full width, cut to 2 of its 60 layers,
                     random bf16 weights from seed 0, int8 moments, 2 x
                     2048 tokens a step: step 0 first, before the block's
                     optimizer state exists, against ``impl="torch"``
                     under the train phases' limits with the plain run's
                     routing replayed (``RoutingTape``: the gates and the
                     router's gradient from the kernels' run), read beside
                     the kernels' run with its own routing, remat's
                     recompute held to route as the forward did; then 6
                     steps through the launcher, the launches per step
                     exactly (flash at head dim 192 forward twice and
                     backward once a layer, 4 RMSNorms a layer forward,
                     again in the recompute and backward, one int8 AdamW
                     a leaf, none on a scalar or CUDA-core route),
                     tok/s, peak memory, MFU, a profiled step, the
                     capacity's dropped share and ``host_probe``'s
                     enqueue against wall;
15b. ``moe_sharded`` — deepseek_v2_236b through the sharded runtime
                     under a process group of one rank (NCCL, a
                     ``HashStore``): serve_moe's launcher job (7 layers,
                     4 x 512 prompt tokens, 32 generated, the decode
                     captured), then train_moe's (2 layers, int8
                     moments, 2 x 2048 tokens, 6 steps) on a (1, 1)
                     DeviceMesh, MLA's heads (item 8g, part 2), the
                     experts, the shared expert and the vocabulary on the
                     tensor-parallel path at M = 1; the tokens, the
                     prefill's and first decode step's logits, the
                     losses, grad norms and launches theirs, bit for bit;
                     the steady train step and host enqueue, the replay's
                     wall and device time and peak memory beside theirs;
15c. ``serve_long_mla`` — deepseek_v2_236b at full width cut to 2
                     layers, B = 1, a cache of 131072 positions (its
                     published 128K context): a 32768-token prefill and
                     16 captured greedy decode steps, unsharded, then
                     through the sharded runtime at (1, 1) on the
                     sequence-split path at one data rank (as
                     ``serve_long``), tokens and logits bit for bit; the
                     absorbed decode's attention over four slices merged
                     against the whole softmax on one layer's full-size
                     compressed cache; the decode step against its
                     bound, the peak memory against the dry run's, each
                     kernel's largest tensor against 2^31 elements;
16. ``train_xlstm`` — a train ``BlockRuntime`` on xlstm_350m at full size,
                     all 24 layers, fp32 moments,
                     4 x 2048 tokens a step, remat: step 0
                     in fp32 (the weights upcast) against ``impl="torch"``
                     under the train phases' limits, the bf16 step 0 read
                     beside it; 3 steps, their launches held exactly, the
                     last one profiled (the device's activity only);
                     tok/s, MFU, peak memory;
16b. ``xlstm_sharded`` — xlstm_350m through the sharded runtime under a
                     process group of one rank (NCCL, a ``HashStore``) on
                     a (1, 1) DeviceMesh, the tensor-parallel path of its
                     mLSTM and sLSTM heads, the sLSTM's feed-forward and
                     the tied vocabulary at M = 1: train_xlstm's job, a
                     step and a warm step's host enqueue against its wall
                     (``host_probe``), their losses and grad norms and
                     the launches a step train_xlstm's bit for bit;
                     serve_xlstm's job through the launcher, its tokens,
                     launches, launches a replay and the prefill's and
                     first decode step's logits serve_xlstm's bit for
                     bit; the layout (``tp_summary``), warm replays and
                     peak memory beside serve_xlstm's;
17. ``preempt``    — checkpoints and preempt/resume at full width
                     (``BlockRuntime.suspend``/``resume`` through
                     ``repro_torch.checkpoint.manager``, under a temporary
                     directory): train_hybrid's job suspended after 3
                     steps and resumed, its 4 losses and grad norms
                     train_hybrid's bit for bit and the resumed step's
                     launches exact; serve_paged's 12 sessions suspended
                     after a third of their rounds, each session's tokens
                     those of a run without a break; serve_hybrid's dense
                     decode with an async save after 4 steps and a
                     suspend after 8, its 16 tokens a row those of 16
                     uninterrupted steps.  Each suspend releases the
                     block's decode graph and leaves under 1% of the
                     state's bytes on the card, each resume is a hit of
                     the compile cache (no new miss) and captures once
                     again, and it restores the state's per-leaf
                     checksums; save, suspend and
                     resume seconds and GB/s, the async save's overlap
                     with the steps, ``progress_lost`` before and after
                     the save, disk space and peak memory;
18. ``control``    — the control plane on the card: a background-mode
                     ``ClusterDaemon`` on one chip, Alice's train block
                     (train_hybrid's job) autostepping toward 4 steps,
                     preempted after 2 by Bob's priority-1 paged serve
                     block (serve_paged's job), whose 12 sessions run
                     through ``daemon.generate`` and the engine's decode
                     rounds (graph replays) until his period ends and the
                     pump's tick resumes Alice; her losses and grad norms
                     train_hybrid's and his tokens serve_paged's, bit for
                     bit, the events in order, her resume a compile-cache
                     hit, the memory while Bob runs, the launches exactly;
                     admission, preemption, first-token and resume
                     seconds, each block's tok/s inside the daemon and
                     Alice's MFU on the H100 roofline;
19. ``gateway``    — the web gateway in front of a background
                     ``ClusterDaemon`` on one chip, every step a real HTTP
                     call: Alice walks the paper's explicit workflow
                     (register, admin review, confirm, activate, run, 2
                     steps, download, expire) with train_hybrid's job;
                     Bob submits serve_paged's job and opens its 12
                     sessions as 12 concurrent generate requests (11 SSE
                     streams, one long-poll); an admin preempts his block
                     mid-stream and posts its resume, and keeps the
                     cluster-wide SSE feed open throughout.  Held: each
                     session's streamed tokens serve_paged's bit for bit,
                     no frame lost or repeated across the preemption,
                     the launches exactly, the resume a compile-cache
                     hit, the admin's frames the bus's in order, ``/ui``
                     served, every body and frame encoded without
                     ``default=``; HTTP TTFT and tok/s beside the direct
                     run, the preempt and resume seconds.
20. ``service``    — the daemon's service mode across ranks: the same
                     gateway through ``core.service``'s leader under a
                     one-rank process group (every command, tick and
                     engine round an entry of its log, passed through
                     the control group); Alice's train_hybrid job under
                     autostep to 2 steps, Bob's 12 sessions with a
                     preemption and a resume, then ``launch.train
                     --autostep`` on train_f32's job for 3 steps.  Held:
                     Alice's and the launcher's losses and grad norms
                     train_hybrid's and train_f32's, Bob's tokens
                     serve_paged's, bit for bit, the launches exactly, the
                     log's entries above 0 and no tripwire; HTTP TTFT
                     against the gateway phase's, the leader's host time
                     per entry, the log's entries and bytes.

Then one JSON line (``decode_capture``) giving each decode path's step
wall time, idle share and tok/s run eagerly and as graph replays, its
capture time and graph pool, beside the ``nvidia-smi`` line; one JSON line
listing every kernel (its launches inside graphs among them), the
``nvidia-smi`` line, and as the last line ``{"ok": true, "device":
{...}}``.  Every JSON line is also
written to ``build/chip_smoke.jsonl`` beside the script, whole (the
kernels line is longer than a terminal's tail).  Any failed check exits
non-zero without that line; so does a machine without CUDA or a
directory without the package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

_CSRC = "src/repro_torch/kernels/csrc/"
KERNEL_META = {
    "flash_attention": {
        "source": _CSRC + "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:27"},
    "rmsnorm": {
        "source": _CSRC + "rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:19"},
    "paged_attention": {
        "source": _CSRC + "paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:40"},
    # the backward kernels' counterparts are JAX's gradients, not TPU
    # kernels: the custom VJP _flash_bwd_rule and autodiff of ops.rmsnorm
    "flash_attention_bwd": {
        "source": _CSRC + "flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/ops.py:125"},
    "rmsnorm_bwd": {
        "source": _CSRC + "rmsnorm.cu",
        "replaces": "src/repro/kernels/ops.py:243"},
    "fused_adamw": {
        "source": _CSRC + "fused_adamw.cu",
        "replaces": "src/repro/kernels/fused_adamw.py:73"},
    "ssd_scan": {
        "source": _CSRC + "ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:20"},
    # the SSD backward's counterpart is autodiff of the reference's jnp
    # scan (its Pallas kernel has no VJP), not a TPU kernel
    "ssd_scan_bwd": {
        "source": _CSRC + "ssd_scan_bwd.cu",
        "replaces": "src/repro/kernels/ops.py:319"},
    # not TPU kernels: the reference's sLSTM recurrence is a lax.scan of
    # its step (ssm.py:203), and its backward autodiff of that scan (:223)
    "slstm_scan": {
        "source": _CSRC + "slstm.cu",
        "replaces": "src/repro/models/ssm.py:203"},
    "slstm_scan_bwd": {
        "source": _CSRC + "slstm.cu",
        "replaces": "src/repro/models/ssm.py:223"},
}

# kernel-name substrings that ``profile_steps`` sums device time over
KERNEL_FAMILIES = ("flash_", "rmsnorm", "paged_decode", "fused_adamw",
                   "ssd_scan", "ssd_bwd", "slstm")

# launch counter -> (kernel module, counter attribute)
COUNTERS = {
    "flash_attention": ("flash_attention", "LAUNCHES"),
    "flash_attention_bwd": ("flash_attention", "BWD_LAUNCHES"),
    # the forward launches that took the CUDA-core kernel (none on a main
    # path: bf16 operands the TMA loads take), and the backward's
    "flash_attention_cuda_core": ("flash_attention", "LAUNCHES_CUDA_CORE"),
    "flash_attention_bwd_cuda_core": ("flash_attention",
                                      "BWD_LAUNCHES_CUDA_CORE"),
    "rmsnorm": ("rmsnorm", "LAUNCHES"),
    "rmsnorm_bwd": ("rmsnorm", "BWD_LAUNCHES"),
    "paged_attention": ("paged_attention", "LAUNCHES"),
    "fused_adamw_i8": ("fused_adamw", "LAUNCHES_I8"),
    "fused_adamw_f32": ("fused_adamw", "LAUNCHES_F32"),
    "ssd_scan": ("ssd_scan", "LAUNCHES"),
    "ssd_scan_bwd": ("ssd_scan", "BWD_LAUNCHES"),
    "slstm_scan": ("slstm", "LAUNCHES"),
    "slstm_scan_bwd": ("slstm", "BWD_LAUNCHES"),
    # the calls of the kernels above that took their scalar route
    "fused_adamw_scalar": ("fused_adamw", "LAUNCHES_SCALAR"),
    "paged_attention_scalar": ("paged_attention", "LAUNCHES_SCALAR"),
    "ssd_scan_scalar": ("ssd_scan", "LAUNCHES_SCALAR"),
    "rmsnorm_scalar": ("rmsnorm", "LAUNCHES_SCALAR"),
    "rmsnorm_bwd_scalar": ("rmsnorm", "BWD_LAUNCHES_SCALAR"),
    "ssd_scan_bwd_scalar": ("ssd_scan", "BWD_LAUNCHES_SCALAR"),
}

# the GQA prefills the kernels phase times beside deepseek_7b's (4 x 512,
# D 128) and the paged decode's groups beside its (8 slots): (name, query
# heads, kv heads)
GQA_PREFILLS = (("llama4", 40, 8), ("starcoder2", 48, 4), ("yi", 56, 8))

# guard limits, in ms at the main path's shape: a redesigned kernel slower
# than this has lost its redesign (the routes before read 1.23, 0.0795 and
# 2.155; NVIDIA H100 80GB HBM3, 700 W).  The RMSNorm forward's two: at
# (2048, 4096) under ``time_ms``, where both routes read 0.0179-0.0186 (a
# 0.0060 floor and the flush's write-backs in every reading), a gross
# loss only; a (8, 7168) decode call in a captured graph, where the
# redesign reads 0.00205-0.00209 and the scalar route 0.00322-0.00329
GUARD_MS = {"ssd_scan": 0.6, "rmsnorm_bwd": 0.07, "ssd_scan_bwd": 1.0,
            "rmsnorm": 0.020, "rmsnorm_graph_8x7168": 0.0026}

# each kernel's counter of the calls that took its route before (the
# kernels line gives their main-path sums beside the launches)
SCALAR_COUNTERS = {"flash_attention": "flash_attention_cuda_core",
                   "flash_attention_bwd": "flash_attention_bwd_cuda_core",
                   "rmsnorm": "rmsnorm_scalar",
                   "rmsnorm_bwd": "rmsnorm_bwd_scalar",
                   "paged_attention": "paged_attention_scalar",
                   "fused_adamw": "fused_adamw_scalar",
                   "ssd_scan": "ssd_scan_scalar",
                   "ssd_scan_bwd": "ssd_scan_bwd_scalar"}


_RECORD = None     # main() opens build/chip_smoke.jsonl here
_CARD = None       # phase_device's nvidia-smi line, beside every time


def emit(phase: str, **data) -> None:
    line = json.dumps({"phase": phase, **data})
    print(line, flush=True)
    if _RECORD is not None:
        _RECORD.write(line + "\n")
        _RECORD.flush()


_T0 = time.perf_counter()


def progress(msg: str) -> None:
    """A timestamped note on stderr, so a cut run shows where it was."""
    print(f"[{time.perf_counter() - _T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# --------------------------------------------------------------- counters

def _counter(name):
    import importlib
    mod, attr = COUNTERS[name]
    return importlib.import_module(f"repro_torch.kernels.{mod}"), attr


def counts():
    out = {}
    for n in COUNTERS:
        mod, attr = _counter(n)
        out[n] = getattr(mod, attr)
    return out


def set_counts(values):
    for n in COUNTERS:
        mod, attr = _counter(n)
        setattr(mod, attr, values[n])


def zero_counts():
    set_counts({n: 0 for n in COUNTERS})


def route_of(counter, fn, routes):
    """Call ``fn``; return its result and the route its kernel took:
    ``routes[1]`` when the scalar-route counter ``counter`` moved, else
    ``routes[0]``."""
    mod, attr = _counter(counter)
    before = getattr(mod, attr)
    res = fn()
    return res, routes[int(getattr(mod, attr) > before)]


# ----------------------------------------------------------------- timing

_FLUSH = None


def flush_l2(clean: bool = False) -> None:
    """Overwrite the 50 MB L2 so the next launch reads its inputs cold,
    as it does on the serving path where the other layers' weights pass
    through the cache in between.  By writing 64 MB, which leaves the L2
    full of dirty lines that the next launch writes back as it evicts
    them (as a layer finds the last one's outputs), or, ``clean``, by
    reading them (its lines clean: the launch's own traffic alone)."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    if clean:
        _FLUSH.max()
    else:
        _FLUSH.zero_()


def time_ms(fn, iters: int = 20, warmup: int = 3,
            clean: bool = False) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each between
    its own CUDA events with a cold L2 (``flush_l2(clean)``).  A spin
    kernel queued before the first event keeps the card busy while the
    host enqueues the event, ``fn`` and the second event, so the host's
    launch overhead (the ctypes call, PyTorch's dispatch) falls outside
    the measured span."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush_l2(clean)
        torch.cuda._sleep(2_000_000)      # ~1 ms at the H100's clocks
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_profile():
    """A ``torch.profiler`` window over the device's activities only: the
    records read are the device's, and recording the host's ops too
    takes minutes over the ~5e5 small launches of an xlstm train
    step."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def profile_steps(fn, n: int = 3, top: int = 8):
    """Host wall time per call of ``fn`` (warm, ending in a device sync),
    then the device kernel time per call over ``n`` more calls under
    ``torch.profiler`` (``device_profile``), the device's idle share, and
    the ``top`` kernels that take the most device time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    with device_profile() as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return profile_summary(prof, wall, n, top)


def profile_summary(prof, wall, n: int = 1, top: int = 8):
    """``profile_steps``'s record from a finished ``torch.profiler``
    window over ``n`` calls, each ``wall`` ms on the host clock: the
    device's activities summed by name from the profiler's raw events
    (what ``key_averages`` sums, without building an event tree: that
    takes minutes for the ~5e5 launches of an xlstm train step)."""
    from torch.autograd import DeviceType
    ns, count = {}, {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == DeviceType.CUDA
                and not e.is_user_annotation() and not e.is_hidden_event()):
            ns[e.name()] = ns.get(e.name(), 0) + e.duration_ns()
            count[e.name()] = count.get(e.name(), 0) + 1
    dev = sum(ns.values()) / 1e6 / n
    names = sorted(ns, key=lambda k: -ns[k])
    top = [{"kernel": k[:80], "ms_per_call": ns[k] / 1e6 / n,
            "count_per_call": count[k] / n} for k in names[:top]]
    # the port's kernels by family: device ms per call and share of the
    # device time (the flash family counts forward, backward and delta)
    fam = {}
    for family in KERNEL_FAMILIES:
        ms = sum(t for k, t in ns.items() if family in k) / 1e6 / n
        fam[family] = {"ms_per_call": ms, "share": ms / dev if dev else 0.0}
    return {"wall_ms": wall, "device_ms": dev,
            "idle_share": max(0.0, 1.0 - dev / wall), "top": top,
            "families": fam}


def bound(nbytes: float, flops: float, flop_rate: float = BF16_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def rms(t) -> float:
    return float(t.float().pow(2).mean().sqrt())


def close(got, want, rtol: float):
    """Element by element, |got - want| <= rtol * (|want| + rms(want)).

    Returns (max abs error, worst error / tolerance over the elements);
    the check passes when the second is at most 1.  A bf16 output rounds
    to within 2^-8 of its magnitude, so the kernel and its plain version
    (both fp32 inside) may land one bf16 step apart: rtol 2e-2 leaves room
    for that and no more.  The rms term keeps values near 0 from needing
    bit equality; a fault that spoils a subset of rows moves them by about
    their own size, far past either term."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    tol = (rtol * (w.abs() + rms(w))).clamp_min(1e-30)
    return float(diff.max()), float((diff / tol).max())


def logits_check(got, want, rtol: float = 5e-2) -> dict:
    """A whole path's logits against the same path with ``impl="torch"``,
    within ``rtol`` of the logits' range, 5% by default: each of the 30
    layers rounds its bf16 activations, and a kernel and its plain version
    may round a value to neighbouring bf16 steps; those differences pass
    through the rest of the stack.  The kernels themselves are held
    element by element (``close``) in the kernels phase."""
    err = max_err(got, want)
    tol = rtol * max(1.0, float(want.float().abs().max()))
    check(bool(torch.isfinite(got).all()), "logits not finite")
    return {"max_abs_err": err, "tol": tol, "passed": err <= tol,
            "rms_err": rms(got.float() - want.float()), "rms_want": rms(want),
            "argmax_agree": float((torch.argmax(got, -1)
                                   == torch.argmax(want, -1)).float().mean())}


# The hybrid's checks (``serve_hybrid``).  In fp32 (the same weights
# upcast, every kernel in its fp32 instantiation, TF32 off) the whole
# stack's logits with the kernels lie within HYBRID_F32_RTOL of their range
# of ``impl="torch"`` (17x the 5.9e-5 read on the H100).  In bf16 the
# random-weight stack grows one bf16 step of difference in a layer's
# output to 6-7% of the logits' range over its 9 groups (read on the H100;
# the bf16 plain run lies as far from an fp32 run as the bf16 kernel run
# does), so the whole stack's bf16 logits are read, not checked.  bf16 is
# held group by group (``hybrid_group_check``): each group with the
# kernels against the same group with ``impl="torch"``, fed the same
# input, within HYBRID_GROUP_RTOL of the range of the group's update (its
# output less its input; read at most 3.1% in the prefill and 2.1% in the
# decode step), and the SSM states the prefill leaves within the same
# share of their range (read 0.43%).  One head of one bf16 SSD scan zeroed
# reads 41-53% (at smoke size on the CPU).
HYBRID_F32_RTOL = 1e-3
HYBRID_GROUP_RTOL = 5e-2

# The xlstm's checks (``serve_xlstm``).  Its 24 recurrent layers carry a
# last-bit difference much farther than the hybrid's 54 do: in fp32 (the
# weights upcast, every kernel in its fp32 instantiation, TF32 off, the
# sLSTM's bf16 stacking taken out of both runs) the whole stack's logits
# with the kernels lie 5.5e-4 (prefill) and 7.3e-4 (first decode step) of
# their range from ``impl="torch"``, 1.9e-3 with the stacking kept (read
# on the H100), so the fp32 whole stack is held within XLSTM_F32_RTOL.  In
# bf16 the whole stack's two runs part by 27% of the range (argmax agreeing
# on half the rows) and a whole group's by up to 10% of its update, so
# bf16 is held one sublayer at a time (``xlstm_sublayer_check``): each
# mLSTM or sLSTM sublayer with the kernels against itself with
# ``impl="torch"``, fed the same input, within HYBRID_GROUP_RTOL of its
# update's range, and the recurrent states after the prefill within the
# same share of theirs; the whole stack's distances are read.
XLSTM_F32_RTOL = 5e-3


def update_check(x_in, got, want) -> dict:
    """One group's output with the kernels (``got``) against its output
    with the plain versions (``want``) from the same input ``x_in``, in
    units of the range of the plain group's update ``want - x_in``."""
    upd = want.float() - x_in.float()
    err, span = max_err(got, want), float(upd.abs().max())
    return {"max_abs_err": err, "update_range": span,
            "err_over_range": err / max(span, 1e-30),
            "rms_err": rms(got.float() - want.float()), "rms_update": rms(upd),
            "finite": bool(torch.isfinite(got).all())}


#: the recurrent states a group or sublayer check holds after the
#: prefill, by family: (record key, the state's path in the cache)
GROUP_STATES = {
    "hybrid": (("ssm_state_after_prefill", ("mamba", "ssm")),),
    "xlstm": (("mlstm_state_after_prefill", ("mlstm", "mlstm", 0)),
              ("slstm_state_after_prefill", ("slstm", "slstm", 1)))}


@torch.no_grad()
def hybrid_group_check(params, cfg, tokens, first) -> dict:
    """The bf16 stack one group at a time, the kernels' stream carried on:
    group g with the kernels and with ``impl="torch"`` on the same input,
    each writing its own cache; first the prefill of ``tokens``, then the
    decode step of ``first``, where each variant steps from the state its
    own prefill left (the kernel's final SSM state against the plain
    version's).  Returns the per-group ``update_check`` rows and the SSM
    states' distance after the prefill."""
    from repro_torch.models import model
    from repro_torch.models import transformer as tf
    B, P = tokens.shape
    ng = tf.n_groups(cfg)
    groups = tf._unbind(params["layers"], ng)
    caches = {impl: model.init_cache(cfg, B, P + 1, tokens.device)
              for impl in ("auto", "torch")}
    rows = {}
    for step, toks, start in (("prefill", tokens, 0), ("decode", first, P)):
        x = model.embed_inputs(params, cfg, {"tokens": toks})
        pos = start + torch.arange(toks.shape[1], device=x.device)
        rows[step] = []
        for g, gp in enumerate(groups):
            out = {impl: tf.group_fwd(gp, x, cfg, positions=pos,
                                      cache=tf._index(caches[impl], g),
                                      cache_len=start, extra=params["extra"],
                                      impl=impl)[0]
                   for impl in ("auto", "torch")}
            rows[step].append(update_check(x, out["auto"], out["torch"]))
            x = out["auto"]
        if step == "prefill":
            rows.update(state_distances(cfg, caches))
    return rows


def state_distances(cfg, caches) -> dict:
    """The recurrent states (``GROUP_STATES``) of the kernels' cache
    against the plain version's: {record key: distances}."""
    out = {}
    for key, path in GROUP_STATES[cfg.family]:
        hs = []
        for c in (caches["auto"], caches["torch"]):
            for p in path:
                c = c[p]
            hs.append(c)
        out[key] = {
            "max_abs_err": max_err(*hs),
            "err_over_range": max_err(*hs) / float(hs[1].abs().max()),
            "rms_err": rms(hs[0] - hs[1]), "rms_state": rms(hs[1])}
    return out


@torch.no_grad()
def xlstm_sublayer_check(params, cfg, tokens, first) -> dict:
    """``hybrid_group_check`` one sublayer at a time, for the xlstm: each
    mLSTM and sLSTM sublayer (its pre-norm, the block and the residual)
    with the kernels and with ``impl="torch"`` on the same input, each
    writing its own cache, the kernels' stream carried on; the prefill of
    ``tokens``, then the decode step of ``first`` from the states each
    variant's prefill left.  Returns the per-sublayer ``update_check``
    rows (g * k + i: group g, sublayer i, the sLSTM last) and the
    recurrent states' distances after the prefill."""
    from repro_torch.models import model, ssm
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import apply_norm
    B, P = tokens.shape
    ng, k = tf.n_groups(cfg), cfg.xlstm.slstm_every
    caches = {impl: model.init_cache(cfg, B, P + 1, tokens.device)
              for impl in ("auto", "torch")}

    def sublayer(lp, x, st, impl, block):
        h = apply_norm(lp["ln"], x, cfg.norm, impl=impl)
        return x + block(lp["blk"], h, cfg.xlstm, cfg.d_model, state=st,
                         impl=impl)[0]

    rows = {}
    for step, toks in (("prefill", tokens), ("decode", first)):
        x = model.embed_inputs(params, cfg, {"tokens": toks})
        rows[step] = []
        for g, gp in enumerate(tf._unbind(params["layers"], ng)):
            subs = [(lp, ssm.mlstm_fwd, lambda c, i=i: tf._index(
                tf._index(c, g)["mlstm"], i))
                for i, lp in enumerate(tf._unbind(gp["mlstm"], k - 1))]
            subs.append((gp["slstm"], ssm.slstm_fwd,
                         lambda c: tf._index(c, g)["slstm"]))
            for lp, block, state in subs:
                out = {impl: sublayer(lp, x, state(caches[impl]), impl,
                                      block)
                       for impl in ("auto", "torch")}
                rows[step].append(update_check(x, out["auto"],
                                               out["torch"]))
                x = out["auto"]
        if step == "prefill":
            rows.update(state_distances(cfg, caches))
    return rows


def _chunks(*ts, n: int = 1 << 26):
    """Matching flat slices of same-shaped tensors, ``n`` elements at a
    time (a full-width optimizer leaf has 1.35e9 elements: whole-tensor
    temporaries in int64 would not fit beside it)."""
    flat = [t.reshape(-1) for t in ts]
    for i in range(0, flat[0].numel(), n):
        yield [f[i:i + n] for f in flat]


def ulp_dist(got, want) -> int:
    """Largest distance between two float tensors of one dtype in units in
    the last place (0 where they are bitwise equal; -0 and +0 are 0
    apart)."""
    it = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[want.dtype]
    lo = -(1 << (8 * want.element_size() - 1))

    def ordered(t):
        i = t.contiguous().view(it).long()
        return torch.where(i >= 0, i, lo - i)

    return max((int((ordered(g) - ordered(w)).abs().max())
                for g, w in _chunks(got, want)), default=0)


# ------------------------------------------------------------ the phases

def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    info = {"nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "capability": list(torch.cuda.get_device_capability(0))}
    global _CARD
    _CARD = smi
    emit("device", **info)
    return info


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    path = _build.load()._name
    build_s = time.perf_counter() - t0
    log = os.path.join(os.path.dirname(path), "build.log")
    ptxas, per_kernel, name = [], {}, None
    if os.path.exists(log):
        with open(log) as f:
            for ln in f:
                if "Compiling entry function" in ln:
                    name = ln.split("'")[1] if "'" in ln else None
                if "registers" in ln or "spill" in ln:
                    ptxas.append(ln.strip())
                    if name and any(k in name for k in PTXAS_KERNELS):
                        per_kernel.setdefault(name, []).append(
                            ln.split(":", 1)[-1].strip())
    emit("build", seconds=build_s, library=os.path.relpath(path, ROOT),
         ptxas=ptxas, ptxas_by_kernel=per_kernel,
         sass_instructions=sass_counts(path))
    # the SSD backward's six tensor-core kernels, the RMSNorm forward's
    # fifteen vector-route instances (bf16 and f32: a warp a row at 1, 2,
    # 4, 6, 8 vectors a lane, a block a row at 1, 2, and f32's at 4) and
    # the sLSTM kernels' 8 (forward and backward, bf16 and f32 gates, bf16
    # and f32 stacking) keep their registers: no spills
    for family, n, sub in (("ssd_bwd", 6, "tc_"), ("rmsnorm_fwd", 15, ""),
                           ("slstm", 8, "")):
        got = {k: v for k, v in per_kernel.items()
               if family in k and sub in k}
        check(len(got) == n and all(
            any("0 bytes spill stores, 0 bytes spill loads" in ln
                for ln in v) for v in got.values()),
            f"{family} kernels' ptxas lines: {got}")
    return build_s


SASS_FAMILIES = ("fused_adamw", "paged_decode")
# kernels whose registers, shared memory and spills the build line gives
# by name (ptxas -v): the SSD scan's, its backward's, the RMSNorm
# forward's vector route and its backward's, the flash backward's and the
# paged decode's (an instance a head chunk GC)
PTXAS_KERNELS = ("ssd_scan", "ssd_bwd", "rmsnorm_fwd", "rmsnorm_bwd",
                 "rmsnorm_dscale", "flash_bwd", "paged_decode", "slstm")


def sass_counts(lib: str) -> dict:
    """Static SASS instruction count of each fused AdamW and paged decode
    kernel in the built library (``cuobjdump -sass``; slow paths and
    both branches included), by mangled name; {} without cuobjdump."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.default_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :", 1)[1].strip()
            name = name if any(f in name for f in SASS_FAMILIES) else None
            if name:
                counts[name] = 0
        elif name and ln.strip().startswith("/*") and ";" in ln:
            counts[name] += 1
    return counts


def _gen(seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


def _randn(shape, g, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def misaligned(t):
    """A contiguous copy of ``t`` one element off 16-byte alignment: the
    flash entry points then take their CUDA-core route (the TMA loads of
    the tensor-core route need 16-byte aligned rows), the fused AdamW and
    the paged decode kernel their scalar route (16-byte vector loads)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def flash_case(B, Hq, Hkv, Sq, Sk, D, Dv, causal=True, window=0,
               q_offset=0, dtype=torch.bfloat16, seed=0):
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_torch)
    g = _gen(seed)
    q = _randn((B, Hq, Sq, D), g, dtype)
    k = _randn((B, Hkv, Sk, D), g, dtype)
    v = _randn((B, Hkv, Sk, Dv), g, dtype)
    kw = dict(causal=causal, sliding_window=window, q_offset=q_offset)
    got = flash_attention_cuda(q, k, v, **kw)
    want = flash_attention_torch(q, k, v, **kw)
    torch.cuda.synchronize()
    return (q, k, v, kw), got, want


def flash_pairs(B, H, S, causal=True) -> int:
    """(query, key) pairs a square attention computes: the lower triangle
    with the causal mask, every pair without."""
    return B * H * (S * (S + 1) // 2 if causal else S * S)


def sdpa(q, k, v, causal):
    """PyTorch's one call for the same attention (GQA heads shared)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=q.shape[1] != k.shape[1])


def rms_case(rows, d, dtype=torch.bfloat16, seed=1, offset=0, width=None):
    """x: (rows, d) from ``seed``, ``offset`` elements off 16-byte
    alignment (the scalar route), or the first d columns of (rows, width)
    rows (a strided view, as MLA's kv_a[..., :R]); returns (x, s), the
    kernel's output, the plain version's and the route the kernel took."""
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_torch
    g = _gen(seed)
    w = width or d
    x = _randn((rows * w + offset,), g, dtype)[offset:].view(rows, w)[:, :d]
    s = _randn((d,), g, dtype)
    got, route = route_of("rmsnorm_scalar", lambda: rmsnorm_cuda(x, s),
                          ("vector", "scalar"))
    want = rmsnorm_torch(x, s)
    torch.cuda.synchronize()
    return (x, s), got, want, route


def rms_scalar(x, s):
    """The RMSNorm forward's scalar route (the design before the vector
    route) on the same inputs, for ``was_ms``: the wrapper's own launch
    with the route named."""
    from repro_torch.kernels import rmsnorm as rn
    return rn._launch(x, s, 1e-6, "scalar")


def graph_ms(fn, n: int = 100, replays: int = 11) -> float:
    """Device ms a call of ``fn`` over ``n`` back-to-back calls captured in
    one CUDA graph (as a decode step's kernels run): the median replay
    over ``n``.  The inputs stay in L2 from replay to replay (warm)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    del graph
    return float(np.median(times))


def paged_case(lens, Hq, Hkv, D, Dv, page=16, maxp=64, dtype=torch.bfloat16,
               seed=2, poison_trash=False):
    """A decode round's inputs, the kernel's output, the plain version's
    and the kernel's route ("split" or "scalar")."""
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_torch)
    B = len(lens)
    n_pages = B * maxp + 1
    g = _gen(seed)
    k_pages = _randn((n_pages, page, Hkv, D), g, dtype)
    v_pages = _randn((n_pages, page, Hkv, Dv), g, dtype)
    if poison_trash:
        k_pages[0], v_pages[0] = 1e4, -1e4
    q = _randn((B, Hq, D), g, dtype)
    rng = np.random.default_rng(seed)
    free = list(rng.permutation(np.arange(1, n_pages)))
    table = np.zeros((B, maxp), np.int32)
    for b, ln in enumerate(lens):
        for j in range(-(-ln // page)):
            table[b, j] = free.pop()
    pt = torch.from_numpy(table).cuda()
    sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got, route = route_of("paged_attention_scalar", lambda: (
        paged_attention_cuda(q, k_pages, v_pages, pt, sl)),
        ("split", "scalar"))
    want = paged_attention_torch(q, k_pages, v_pages, pt, sl)
    torch.cuda.synchronize()
    return (q, k_pages, v_pages, pt, sl), got, want, route


def ssd_inputs(Bt, S, H, P, N, chunk, dtype=torch.bfloat16, h0="zeros",
               dt_max=None, zero_dt_block=False, seed=6, misalign=False):
    """The SSD scan's inputs as the Mamba2 layer gives them: x, B and C
    strided slices of one conv output (its base one element off 16-byte
    alignment with ``misalign``), dt softplus'd (scaled to reach
    ``dt_max``, or 0 over the first chunk), A = -exp(.), h0 zeros (as a
    prefill from a fresh cache), random or None.  Returns ((x, dt, A, B,
    C, D), h0, the generator, to draw more from)."""
    import torch.nn.functional as F
    g = _gen(seed)
    di = H * P
    conv = _randn((Bt * S * (di + 2 * N) + int(misalign),), g, dtype)
    conv = conv[int(misalign):].view(Bt, S, di + 2 * N)
    x = conv[..., :di].reshape(Bt, S, H, P)
    B, C = conv[..., di:di + N], conv[..., di + N:]
    dt = F.softplus(_randn((Bt, S, H), g, torch.float32) - 1.0)
    if dt_max is not None:
        dt = dt * (dt_max / dt.max())
    if zero_dt_block:
        dt[:, :min(chunk, S)] = 0.0
    A = -torch.exp(_randn((H,), g, torch.float32, 0.5))
    D = _randn((H,), g, torch.float32)
    h = {"zeros": torch.zeros((Bt, H, P, N), device="cuda"), "none": None,
         "random": _randn((Bt, H, P, N), g, torch.float32, 0.5)}[h0]
    return (x, dt, A, B, C, D), h, g


def ssd_case(Bt, S, H, P, N, chunk, dtype=torch.bfloat16, h0="zeros",
             dt_max=None, zero_dt_block=False, seed=6):
    """The SSD scan on ``ssd_inputs``: (inputs, the kernel's (y,
    h_final), the plain version's, the kernel's route, "chunked" or
    "scalar")."""
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_torch
    args, h, _ = ssd_inputs(Bt, S, H, P, N, chunk, dtype, h0, dt_max,
                            zero_dt_block, seed)
    got, route = route_of("ssd_scan_scalar", lambda: ssd_scan_cuda(
        *args, chunk=chunk, h0=h), ("chunked", "scalar"))
    want = ssd_scan_torch(*args, chunk=chunk, h0=h)
    torch.cuda.synchronize()
    return (args, chunk, h), got, want, route


def ssd_cost(x, B, h0, chunk):
    """(bytes, flops) of one SSD scan: every input read once and y and the
    final state written once; the chunked form's operations over the
    chunks this sequence has (C.B^T and the weighted sum over j <= t per
    head, the inter-chunk product and the state update)."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    es = x.element_size()
    nbytes = (2 * x.numel() * es + 2 * B.numel() * es + 4 * Bt * S * H
              + 8 * H + 4 * Bt * H * P * N * (2 if h0 is not None else 1))
    Q = min(chunk, S)
    lens = [Q] * (S // Q) + ([S % Q] if S % Q else [])
    flops = Bt * H * sum(q * (q + 1) * (N + P) + 4 * q * N * P
                         for q in lens)
    return nbytes, flops


def ssd_bwd_cost(x, B, h0, dh_final, chunk):
    """(bytes, flops) of one SSD backward: every input (x, dt, A, B, C, D,
    dy, h0 and dh_final where given) read once and every cotangent written
    once; the operations the chunked backward needs over the chunks this
    sequence has, per head: dy_t . x_j and sum_t W[t, j] dy_t over the
    causal triangle, and five (P, N) products of a chunk's rows (the
    chunk's state, the entering state's cotangent, and the state terms of
    dx, dB and dC); per (batch, chunk), shared by the heads: C.B^T and
    the two products of dCB with B and C."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    es = x.element_size()
    states = 4 * Bt * H * P * N
    nbytes = (3 * x.numel() * es + 2 * 2 * B.numel() * es
              + 2 * 4 * Bt * S * H + 2 * 8 * H + states
              + (states if h0 is not None else 0)
              + (states if dh_final is not None else 0))
    Q = min(chunk, S)
    lens = [Q] * (S // Q) + ([S % Q] if S % Q else [])
    flops = Bt * sum(H * (2 * q * (q + 1) * P + 10 * q * P * N)
                     + 3 * q * (q + 1) * N for q in lens)
    return nbytes, flops


SSD_BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")


def ssd_bwd_rtol(name, dtype):
    """dx, dB and dC in bf16 within 2e-2 (one bf16 step, as every bf16
    output here); every fp32 cotangent within 1e-3 (what fp32 summation
    order alone moves is read at the train shape: the fp32 plain version
    against its own float64 run, ``fp32_plain_vs_f64``)."""
    return (2e-2 if name in ("dx", "dB", "dC") and dtype == torch.bfloat16
            else 1e-3)


def ssd_bwd_case(Bt, S, H, P, N, chunk, dtype=torch.bfloat16, h0="zeros",
                 dh="random", dt_max=None, zero_dt_block=False, seed=7,
                 misalign=False):
    """The SSD backward kernel and its plain version on ``ssd_inputs``
    with a random cotangent dy of y (x's dtype) and dh of the final state
    (fp32, or None).  Returns ((inputs, dy, dh, chunk, h0), the kernel's
    seven cotangents, the plain version's, the kernel's route,
    "tensor_core" or "scalar")."""
    from repro_torch.kernels.ssd_scan import (ssd_scan_bwd_cuda,
                                              ssd_scan_bwd_torch)
    args, h, g = ssd_inputs(Bt, S, H, P, N, chunk, dtype, h0, dt_max,
                            zero_dt_block, seed, misalign)
    dy = _randn((Bt, S, H, P), g, dtype)
    dhf = (_randn((Bt, H, P, N), g, torch.float32, 0.5) if dh == "random"
           else None)
    got, route = route_of("ssd_scan_bwd_scalar", lambda: ssd_scan_bwd_cuda(
        *args, dy, dhf, chunk=chunk, h0=h), ("tensor_core", "scalar"))
    want = ssd_scan_bwd_torch(*args, dy, dhf, chunk=chunk, h0=h)
    torch.cuda.synchronize()
    return (args, dy, dhf, chunk, h), got, want, route


def ssd_bwd_held(what, got, want, dtype):
    """Every cotangent element by element against the plain version
    (``ssd_bwd_rtol``): {name: max_err, rtol, err_over_tol}; fails on one
    outside its tolerance or not finite."""
    res = {}
    for name, g, w in zip(SSD_BWD_NAMES, got, want):
        rtol = ssd_bwd_rtol(name, dtype)
        err, ratio = close(g, w, rtol)
        res[name] = {"max_err": err, "rtol": rtol, "err_over_tol": ratio}
        check(ratio <= 1.0 and bool(torch.isfinite(g).all()),
              f"ssd_scan_bwd {what} {name}: max_abs_err {err}, {ratio} x "
              f"its tolerance (rtol {rtol})")
    return res


def check_ssd_bwd_kernel(out, edge, edges):
    """The SSD backward at zamba2_2p7b's train shape (timed) and at edge
    cases, every cotangent element by element against the plain version
    (``ssd_bwd_rtol``).  bf16 takes the tensor-core route, which is also
    held against its passes in plain PyTorch
    (``ssd_scan_bwd_passes_torch``), twice on the same inputs, bit for bit,
    and under its guard time; its seven kernels are timed apart
    (``passes_ms``); the scalar route on a copy of x one element off
    alignment is held and timed (``was_route``).  At the train shape also
    the fp32 plain version's distance from its own float64 run (what fp32
    summation order alone moves)."""
    from repro_torch.kernels.ssd_scan import (ssd_scan_bwd_cuda,
                                              ssd_scan_bwd_passes_torch,
                                              ssd_scan_bwd_torch)
    progress("kernels: ssd_scan_bwd")
    (args, dy, dhf, chunk, h0), got, want, route = ssd_bwd_case(
        2, 2048, 80, 64, 64, 256)
    check(route == "tensor_core",
          f"ssd_scan_bwd train shape: {route} route")
    dtype = args[0].dtype
    res = ssd_bwd_held("train shape", got, want, dtype)
    again = ssd_scan_bwd_cuda(*args, dy, dhf, chunk=chunk, h0=h0)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "ssd_scan_bwd: two calls on the same inputs differ")
    del again
    passes = ssd_scan_bwd_passes_torch(*args, dy, dhf, chunk=chunk, h0=h0)
    vs_passes = {n: r["err_over_tol"] for n, r in ssd_bwd_held(
        "train shape against its passes in plain PyTorch", got, passes,
        dtype).items()}
    del passes
    # the fp32 plain version against its float64 run: what fp32 summation
    # order alone moves each fp32 cotangent, in units of its rtol
    f64 = ssd_scan_bwd_torch(*(t.double() for t in args), dy.double(),
                             dhf.double(), chunk=chunk, h0=h0.double())
    vs64 = {}
    for name, w, w64 in zip(SSD_BWD_NAMES, want, f64):
        if w.dtype == torch.float32:
            vs64[name] = close(w, w64, ssd_bwd_rtol(name, w.dtype))[1]
    del f64
    nbytes, flops = ssd_bwd_cost(args[0], args[3], h0, dhf, chunk)
    b_ms, b_by = bound(nbytes, flops)
    # the scalar route on the same values, x one element off alignment
    margs = (misaligned(args[0]),) + args[1:]
    sgot, sroute = route_of("ssd_scan_bwd_scalar", lambda: ssd_scan_bwd_cuda(
        *margs, dy, dhf, chunk=chunk, h0=h0), ("tensor_core", "scalar"))
    check(sroute == "scalar", f"ssd_scan_bwd on a misaligned x: {sroute} "
          f"route")
    sres = ssd_bwd_held("scalar route", sgot, want, dtype)
    del sgot

    def kernel():
        return ssd_scan_bwd_cuda(*args, dy, dhf, chunk=chunk, h0=h0)

    kernel_ms = time_ms(kernel)
    check(kernel_ms <= GUARD_MS["ssd_scan_bwd"],
          f"ssd_scan_bwd train shape: {kernel_ms} ms, above its "
          f"{GUARD_MS['ssd_scan_bwd']} ms guard")
    out["ssd_scan_bwd"] = {
        "shape": {"x": list(args[0].shape), "N": args[3].shape[-1],
                  "chunk": chunk, "h0": "zeros", "dh_final": "random"},
        "route": route,
        "max_err": max(r["max_err"] for r in res.values()),
        "outputs": res, "vs_passes_plain": vs_passes,
        "fp32_plain_vs_f64": vs64, "bitwise_reproducible": True,
        "kernel_ms": kernel_ms,
        "plain_ms": time_ms(lambda: ssd_scan_bwd_torch(
            *args, dy, dhf, chunk=chunk, h0=h0), iters=3),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "bytes": nbytes, "flops": flops,
        # the tensor-core route's nine kernels, apart
        "passes_ms": {t["kernel"]: t["ms_per_call"] for t in profile_steps(
            kernel, 5, top=12)["top"] if "ssd_bwd" in t["kernel"]},
        "was_route": {"route": "scalar", "outputs": sres,
                      "kernel_ms": time_ms(lambda: ssd_scan_bwd_cuda(
                          *margs, dy, dhf, chunk=chunk, h0=h0), iters=5)}}
    out["ssd_scan_bwd"]["tflops"] = flops / kernel_ms / 1e9
    del args, margs, dy, dhf, h0, got, want
    for name, shape, kw in [
            ("S1000_ragged", (2, 1000, 80, 64, 64, 256), {}),
            ("S17_lt_chunk", (2, 17, 80, 64, 64, 256), {}),
            # a short last chunk of whole 64-row tiles; P and N narrower
            # than 64 and unequal
            ("S640_tiles_not_chunks", (2, 640, 16, 64, 64, 256),
             dict(h0="random")),
            ("P32_N48", (2, 300, 8, 32, 48, 128), dict(h0="random")),
            ("h0_random", (2, 600, 16, 64, 64, 256), dict(h0="random")),
            ("dh_final_none", (2, 300, 16, 64, 64, 256),
             dict(dh="none", h0="none")),
            ("f32", (2, 600, 16, 64, 64, 256),
             dict(dtype=torch.float32, h0="random")),
            ("zero_dt_block", (2, 600, 16, 64, 64, 256),
             dict(zero_dt_block=True, h0="random")),
            ("dt_max_20", (2, 600, 16, 64, 64, 256),
             dict(dt_max=20.0, h0="random")),
            # every case reads B and C as strided views of a conv output;
            # here its base is one element off 16-byte alignment
            ("misaligned_base", (2, 300, 16, 64, 64, 256),
             dict(misalign=True, h0="random")),
            ("smoke_width", (2, 40, 8, 16, 16, 16), dict(h0="random"))]:
        (args, dy, dhf, chunk, h0), got, want, route = ssd_bwd_case(
            *shape, **kw)
        expect = ("scalar" if name in ("f32", "misaligned_base")
                  else "tensor_core")
        check(route == expect, f"ssd_scan_bwd {name}: {route} route, want "
              f"{expect}")
        for gname, g, w in zip(SSD_BWD_NAMES, got, want):
            edge("ssd_scan_bwd", f"{name}_{gname}", g, w,
                 ssd_bwd_rtol(gname, args[0].dtype))
            edges[-1]["route"] = route
        if name in ("misaligned_base", "S1000_ragged"):
            again = ssd_scan_bwd_cuda(*args, dy, dhf, chunk=chunk, h0=h0)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"ssd_scan_bwd {name}: two calls differ")


def check_ssd_kernel(out, edge, edges):
    """The SSD scan at zamba2_2p7b's prefill shape (timed) and at edge
    cases: y within rtol 2e-2 (bf16) or 1e-4 (f32), the fp32 final state
    within 1e-4 of the plain version (the same chunked algorithm).  At
    the prefill shape, with a random h0 and with dt up to 20 the kernel is
    also held against the sequential oracle ``ref.ssd_scan`` (another
    algorithm: fp32 y and the final state within 5e-3, the JAX tests'
    rtol against the reference's oracle; bf16 y within 2e-2).  bf16 takes
    the chunked route, which is also held against its passes in plain
    PyTorch (``ssd_scan_passes_torch``) and twice on the same inputs, bit
    for bit; its four kernels are timed apart; the scalar route on a copy
    of x one element off alignment is held and timed (``was_route``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import (ssd_scan_cuda,
                                              ssd_scan_passes_torch,
                                              ssd_scan_torch)

    def vs_oracle(case, args, chunk, h0, y, hf):
        yo, ho = ref.ssd_scan(*args, h0=h0)
        edge("ssd_scan", f"{case}_y_vs_oracle", y, yo,
             5e-3 if y.dtype == torch.float32 else 2e-2)
        edge("ssd_scan", f"{case}_h_final_vs_oracle", hf, ho, 5e-3)

    progress("kernels: ssd_scan")
    (args, chunk, h0), got, want, route = ssd_case(4, 1000, 80, 64, 64, 256)
    (y, hf), (yw, hw) = got, want
    err, ratio = close(y, yw, 2e-2)
    h_err, h_ratio = close(hf, hw, 1e-4)
    check(route == "chunked" and ratio <= 1.0 and h_ratio <= 1.0
          and bool(torch.isfinite(y.float()).all()),
          f"ssd_scan full width: {route} route, y max_abs_err {err} "
          f"({ratio} x tol), h_final {h_err} ({h_ratio} x tol)")
    vs_oracle("full_width", args, chunk, h0, y, hf)
    again = ssd_scan_cuda(*args, chunk=chunk, h0=h0)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "ssd_scan: two calls on the same inputs differ")
    yp, hp = ssd_scan_passes_torch(*args, chunk=chunk, h0=h0)
    p_err, p_ratio = close(y, yp, 2e-2)
    ph_err, ph_ratio = close(hf, hp, 1e-4)
    check(p_ratio <= 1.0 and ph_ratio <= 1.0,
          f"ssd_scan full width against its passes in plain PyTorch: y "
          f"{p_err} ({p_ratio} x tol), h_final {ph_err} ({ph_ratio} x tol)")
    del again, yp, hp
    nbytes, flops = ssd_cost(args[0], args[3], h0, chunk)
    b_ms, b_by = bound(nbytes, flops)
    xm = misaligned(args[0])
    margs = (xm,) + args[1:]
    (sy, shf), sroute = route_of("ssd_scan_scalar", lambda: ssd_scan_cuda(
        *margs, chunk=chunk, h0=h0), ("chunked", "scalar"))
    s_err, s_ratio = close(sy, yw, 2e-2)
    sh_err, sh_ratio = close(shf, hw, 1e-4)
    check(sroute == "scalar" and s_ratio <= 1.0 and sh_ratio <= 1.0,
          f"ssd_scan on a misaligned x: {sroute} route, y {s_err} "
          f"({s_ratio} x tol), h_final {sh_err} ({sh_ratio} x tol)")
    kernel_ms = time_ms(lambda: ssd_scan_cuda(*args, chunk=chunk, h0=h0))
    check(kernel_ms <= GUARD_MS["ssd_scan"],
          f"ssd_scan full width: {kernel_ms} ms, above its "
          f"{GUARD_MS['ssd_scan']} ms guard")
    out["ssd_scan"] = {
        "shape": {"x": list(args[0].shape), "N": args[3].shape[-1],
                  "chunk": chunk, "h0": "zeros"},
        "route": route, "max_err": err, "rtol": 2e-2, "err_over_tol": ratio,
        "h_final_max_err": h_err, "h_final_err_over_tol": h_ratio,
        "bitwise_reproducible": True,
        "vs_passes_plain": {"y_err_over_tol": p_ratio,
                            "h_final_err_over_tol": ph_ratio},
        "kernel_ms": kernel_ms,
        "plain_ms": time_ms(lambda: ssd_scan_torch(*args, chunk=chunk,
                                                   h0=h0), iters=3),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "bytes": nbytes, "flops": flops,
        # the chunked route's four kernels, apart
        "passes_ms": {t["kernel"]: t["ms_per_call"] for t in profile_steps(
            lambda: ssd_scan_cuda(*args, chunk=chunk, h0=h0), 20)["top"]
            if "ssd_scan" in t["kernel"]},
        "was_route": {"route": "scalar", "max_err": s_err,
                      "err_over_tol": s_ratio,
                      "h_final_err_over_tol": sh_ratio,
                      "kernel_ms": time_ms(lambda: ssd_scan_cuda(
                          *margs, chunk=chunk, h0=h0), iters=5)}}
    del args, margs, xm, got, want, y, hf, yw, hw, sy, shf
    for name, shape, kw in [
            # the hybrid train step's forward: 8 whole chunks, no h0
            ("train_shape", (2, 2048, 80, 64, 64, 256), dict(h0="none")),
            ("S17_lt_chunk", (2, 17, 80, 64, 64, 256), {}),
            ("S256_one_chunk", (2, 256, 80, 64, 64, 256), {}),
            ("S1000_ragged_B1", (1, 1000, 80, 64, 64, 256), {}),
            # S a multiple of 64 but not of the chunk: a short last chunk
            # of whole 64-row tiles
            ("S640_tiles_not_chunks", (2, 640, 16, 64, 64, 256),
             dict(h0="random")),
            ("Bt1_H1", (1, 700, 1, 64, 64, 256), dict(h0="random")),
            ("h0_random", (2, 600, 80, 64, 64, 256), dict(h0="random")),
            ("h0_none", (2, 300, 16, 64, 64, 256), dict(h0="none")),
            ("f32", (2, 600, 16, 64, 64, 256),
             dict(dtype=torch.float32, h0="random")),
            ("smoke_width", (2, 40, 8, 16, 16, 16), dict(h0="random")),
            ("dt_max_20", (2, 600, 16, 64, 64, 256),
             dict(dt_max=20.0, h0="random")),
            ("zero_dt_block", (2, 600, 16, 64, 64, 256),
             dict(zero_dt_block=True, h0="random"))]:
        (args, chunk, h0), (y, hf), (yw, hw), route = ssd_case(*shape, **kw)
        f32 = kw.get("dtype") == torch.float32
        check(route == ("scalar" if f32 else "chunked"),
              f"ssd_scan {name}: {route} route")
        rel = 1e-4 if f32 else 2e-2
        edge("ssd_scan", f"{name}_y", y, yw, rel)
        edges[-1]["route"] = route
        edge("ssd_scan", f"{name}_h_final", hf, hw, 1e-4)
        edges[-1]["route"] = route
        if name in ("h0_random", "dt_max_20"):
            vs_oracle(name, args, chunk, h0, y, hf)


# the sLSTM kernels' tolerances (``close``): the fp32 states and
# cotangents, and what the kernels write in bf16
SLSTM_RTOL = {"state": 1e-4, "bf16": 2e-2, "cotangent": 1e-3}
SLSTM_STATES = ("h", "c", "n", "m")


def slstm_inputs(B, S, H, Dh, dtype=torch.bfloat16, state=False, seed=11,
                 layout="contiguous"):
    """gates_x (B, S, 4, H, Dh) ~ N(0, 1), as ``x @ w_gates`` of a
    normalised x and a He-initialised ``w_gates``; r (H, Dh, 4 Dh) at
    ``r_gates``' He scale, in the gates' dtype (the model's); a random
    state (|n| >= 1) or None.
    ``layout="strided"``: the gates a transposed view of a (S, B, ...)
    buffer, read through its strides."""
    g = _gen(seed)
    if layout == "strided":
        gx = _randn((S, B, 4, H, Dh), g, dtype).transpose(0, 1)
    else:
        gx = _randn((B, S, 4, H, Dh), g, dtype)
    r = _randn((H, Dh, 4 * Dh), g, dtype, 1.0 / Dh ** 0.5)
    st = None
    if state:
        st = [_randn((B, H, Dh), g, torch.float32) for _ in range(4)]
        st[2] = st[2].abs() + 1.0
        st = tuple(st)
    return gx, r, st


def slstm_held(got, want, stack_dtype):
    """hs (``stack_dtype``) and the four fp32 final states element by
    element (``SLSTM_RTOL``): {name: max_err, rtol, err_over_tol}."""
    res = {}
    hs_rtol = SLSTM_RTOL["bf16" if stack_dtype == torch.bfloat16
                         else "state"]
    for name, g, w, rtol in [("hs", got[0], want[0], hs_rtol)] + [
            (n, a, b, SLSTM_RTOL["state"])
            for n, a, b in zip(SLSTM_STATES, got[1], want[1])]:
        err, ratio = close(g, w, rtol)
        res[name] = {"max_err": err, "rtol": rtol, "err_over_tol": ratio,
                     "finite": bool(torch.isfinite(g).all())}
    return res


def slstm_gap_by_position(got_hs, want_hs, n: int = 8) -> list:
    """The hs gap between the kernel and the plain loop along the
    sequence: for each of ``n`` equal spans of positions, the worst
    |got - want| / (|want| + rms(want)) in it (rms over the whole)."""
    g, w = got_hs.float(), want_hs.float()
    scale = w.abs() + rms(w)
    rel = ((g - w).abs() / scale).amax(dim=(0, 2, 3))
    return [float(x.max()) for x in rel.chunk(n)]


def slstm_cost(gx, r, stack_dtype):
    """The forward's bytes from the zero state (the gates and r read
    once, hs and the final state written once) and FLOPs
    (``ops.slstm_flops``)."""
    from repro_torch.kernels import ops
    B, S, _, H, Dh = gx.shape
    nbytes = (gx.numel() * gx.element_size() + r.numel() * r.element_size()
              + B * S * H * Dh * torch.finfo(stack_dtype).bits // 8
              + 4 * B * H * Dh * 4)
    return nbytes, ops.slstm_flops(B, S, H, Dh)


def slstm_bwd_cost(r, saved, dhs, dgx_dtype):
    """The backward's bytes (the saved gates and states, dhs and r read
    once, the gates' cotangent, the fp32 dR and the initial state's
    written once) and FLOPs (dg R^T in the kernel, dR after it: twice
    the forward's)."""
    from repro_torch.kernels import ops
    G, states = saved
    B, S, H, Dh = dhs.shape
    nbytes = (G.numel() * 4 + states.numel() * 4
              + dhs.numel() * dhs.element_size()
              + r.numel() * (r.element_size() + 4)
              + B * S * 4 * H * Dh * torch.finfo(dgx_dtype).bits // 8
              + 4 * B * H * Dh * 4)
    return nbytes, 2 * ops.slstm_flops(B, S, H, Dh)


def check_slstm_kernel(out, edge):
    """The sLSTM forward and backward kernels against their plain
    versions, element by element (``SLSTM_RTOL``): at xlstm_350m's train
    and prefill shape (4 rows x 2048 positions, 4 heads of 256, bf16
    gates and stacking: the main path's), timed, twice on the same inputs
    bit for bit; there with fp32 gates and stacking (``f32``), the hs gap
    along the sequence read (``gap_by_position``); at edge cases (one
    head with a state, as a rank of four under tensor parallelism; S = 1
    from a state, the decode step; gates read through other strides;
    fp32 from a state).  The backward is held on the forward kernel's saved
    gates and states (the same inputs for both).  The plain versions are
    timed over two calls (~0.5 s and ~2 s each)."""
    from repro_torch.kernels.slstm import (slstm_scan_bwd_cuda,
                                           slstm_scan_bwd_torch,
                                           slstm_scan_cuda, slstm_scan_torch)
    progress("kernels: slstm_scan")
    # the plain loop's bmm in full fp32, as the kernel's FMAs
    check(not torch.backends.cuda.matmul.allow_tf32,
          "slstm_scan: TF32 is on for fp32 matmuls")
    B, S, H, Dh = 4, 2048, 4, 256
    bf16 = torch.bfloat16
    rows = {}
    for name, dtype in (("bf16", bf16), ("f32", torch.float32)):
        gx, r, _ = slstm_inputs(B, S, H, Dh, dtype)
        got = slstm_scan_cuda(gx, r, None, stack_dtype=dtype)[:2]
        want = slstm_scan_torch(gx, r, None, stack_dtype=dtype)
        res = slstm_held(got, want, dtype)
        again = slstm_scan_cuda(gx, r, None, stack_dtype=dtype)[:2]
        bitwise = (torch.equal(got[0], again[0])
                   and all(torch.equal(a, b)
                           for a, b in zip(got[1], again[1])))
        check(bitwise, f"slstm_scan {name}: two calls on the same inputs "
              f"differ")
        row = {"shape": [B, S, H, Dh], "gates": str(dtype),
               "outputs": res,
               "gap_by_position": slstm_gap_by_position(got[0], want[0]),
               "bitwise_reproducible": bitwise}
        check(all(v["err_over_tol"] <= 1.0 and v["finite"]
                  for v in res.values()), f"slstm_scan {name}: {row}")
        if name == "bf16":
            nbytes, flops = slstm_cost(gx, r, dtype)
            b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
            # one step from a state: the decode call
            g1, r1, st1 = slstm_inputs(B, 1, H, Dh, dtype, state=True)
            row["s1_ms"] = time_ms(lambda: slstm_scan_cuda(
                g1, r1, st1, stack_dtype=dtype))
            row.update(
                kernel_ms=time_ms(lambda: slstm_scan_cuda(
                    gx, r, None, stack_dtype=dtype)),
                plain_ms=time_ms(lambda: slstm_scan_torch(
                    gx, r, None, stack_dtype=dtype), iters=2, warmup=0),
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                bytes=nbytes, flops=flops)
            row["step_us"] = row["kernel_ms"] / S * 1e3
            row["max_err"] = max(v["max_err"] for v in res.values())
        rows[name] = row
        del gx, r, got, want, again
    out["slstm_scan"] = rows.pop("bf16")
    out["slstm_scan"]["f32"] = rows["f32"]

    # the backward at the same shape, bf16 gates and stacking; the final
    # state's cotangents None, as in training
    progress("kernels: slstm_scan_bwd")
    rows = {}
    for name, dtype in (("bf16", bf16), ("f32", torch.float32)):
        gx, r, _ = slstm_inputs(B, S, H, Dh, dtype, seed=12)
        dhs = _randn((B, S, H, Dh), _gen(13), dtype)
        _, _, saved = slstm_scan_cuda(gx, r, None, stack_dtype=dtype,
                                      save=True)
        got = slstm_scan_bwd_cuda(r, saved, dhs, dtype=dtype)
        want = slstm_scan_bwd_torch(gx, r, None, dhs, saved=saved)
        again = slstm_scan_bwd_cuda(r, saved, dhs, dtype=dtype)
        bitwise = (torch.equal(got[0], again[0])
                   and torch.equal(got[1], again[1])
                   and all(torch.equal(a, b)
                           for a, b in zip(got[2], again[2])))
        check(bitwise, f"slstm_scan_bwd {name}: two calls on the same "
              f"inputs differ")
        res = {}
        named = [("dgates", got[0], want[0],
                  SLSTM_RTOL["bf16" if dtype == bf16 else "cotangent"]),
                 ("dr", got[1], want[1], SLSTM_RTOL["cotangent"])] + [
                     (f"d{n}0", a, b, SLSTM_RTOL["cotangent"])
                     for n, a, b in zip(SLSTM_STATES, got[2], want[2])]
        for oname, g, w, rtol in named:
            err, ratio = close(g, w, rtol)
            res[oname] = {"max_err": err, "rtol": rtol,
                          "err_over_tol": ratio}
            check(ratio <= 1.0 and bool(torch.isfinite(g).all()),
                  f"slstm_scan_bwd {name} {oname}: max_abs_err {err}, "
                  f"{ratio} x its tolerance (rtol {rtol})")
        row = {"shape": [B, S, H, Dh], "gates": str(dtype), "outputs": res,
               "bitwise_reproducible": bitwise}
        if name == "bf16":
            nbytes, flops = slstm_bwd_cost(r, saved, dhs, dtype)
            b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
            row.update(
                kernel_ms=time_ms(lambda: slstm_scan_bwd_cuda(
                    r, saved, dhs, dtype=dtype)),
                plain_ms=time_ms(lambda: slstm_scan_bwd_torch(
                    gx, r, None, dhs, saved=saved), iters=2, warmup=0),
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                bytes=nbytes, flops=flops,
                max_err=max(v["max_err"] for v in res.values()))
            row["step_us"] = row["kernel_ms"] / S * 1e3
        rows[name] = row
        del gx, r, dhs, saved, got, want, again
    out["slstm_scan_bwd"] = rows.pop("bf16")
    out["slstm_scan_bwd"]["f32"] = rows["f32"]

    # edge cases, forward and backward, each held as above
    for name, shape, kw in [
            ("H1_state", (4, 300, 1, 256), dict(state=True)),
            ("S1_state_decode", (4, 1, 4, 256), dict(state=True)),
            ("strided_gates", (2, 200, 4, 256),
             dict(state=True, layout="strided")),
            ("f32_state", (3, 100, 2, 256),
             dict(dtype=torch.float32, state=True))]:
        gx, r, st = slstm_inputs(*shape, seed=len(name), **kw)
        dtype = gx.dtype
        got = slstm_scan_cuda(gx, r, st, stack_dtype=dtype, save=True)
        want = slstm_scan_torch(gx, r, st, stack_dtype=dtype)
        edge("slstm_scan", f"{name}_hs", got[0], want[0],
             SLSTM_RTOL["bf16" if dtype == bf16 else "state"])
        for n, a, b in zip(SLSTM_STATES, got[1], want[1]):
            edge("slstm_scan", f"{name}_{n}", a, b, SLSTM_RTOL["state"])
        dhs = _randn(tuple(want[0].shape), _gen(14), dtype)
        dfin = tuple(_randn(tuple(t.shape), _gen(15 + i), torch.float32)
                     for i, t in enumerate(want[1]))
        bgot = slstm_scan_bwd_cuda(r, got[2], dhs, dfin, dtype=dtype)
        bwant = slstm_scan_bwd_torch(gx, r, st, dhs, dfin, saved=got[2])
        edge("slstm_scan_bwd", f"{name}_dgates", bgot[0], bwant[0],
             SLSTM_RTOL["bf16" if dtype == bf16 else "cotangent"])
        edge("slstm_scan_bwd", f"{name}_dr", bgot[1], bwant[1],
             SLSTM_RTOL["cotangent"])
        for n, a, b in zip(SLSTM_STATES, bgot[2], bwant[2]):
            edge("slstm_scan_bwd", f"{name}_d{n}0", a, b,
                 SLSTM_RTOL["cotangent"])


def phase_slstm():
    """``check_slstm_kernel`` alone, as the kernels phase runs it (to
    iterate on the sLSTM kernels: ``benchmarks/config_phases.py
    slstm``)."""
    out, edges = {}, []
    check_slstm_kernel(out, edge_check(edges))
    emit("slstm_kernel", full_width=out, edge_cases=edges)
    return out


def flash_bwd_case(B, Hq, Hkv, Sq, Sk, D, Dv, causal=True, window=0,
                   q_offset=0, dtype=torch.bfloat16, seed=3):
    """The forward kernel's o and lse beside its plain version's, then the
    backward kernel and its plain version on the same (q, k, v, o, lse,
    do)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_torch,
        flash_attention_cuda, flash_attention_torch)
    g = _gen(seed)
    q = _randn((B, Hq, Sq, D), g, dtype)
    k = _randn((B, Hkv, Sk, D), g, dtype)
    v = _randn((B, Hkv, Sk, Dv), g, dtype)
    do = _randn((B, Hq, Sq, Dv), g, dtype)
    kw = dict(causal=causal, sliding_window=window, q_offset=q_offset)
    o, lse = flash_attention_cuda(q, k, v, with_lse=True, **kw)
    o_plain, lse_plain = flash_attention_torch(q, k, v, with_lse=True, **kw)
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    want = flash_attention_bwd_torch(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    return (q, k, v, o, lse, do, kw), got, want, (o, o_plain, lse, lse_plain)


def rms_bwd_case(rows, d, dtype=torch.bfloat16, seed=4, offset=0):
    from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_cuda,
                                             rmsnorm_bwd_torch)
    g = _gen(seed)
    x = _randn((rows * d + offset,), g, dtype)[offset:].view(rows, d)
    s = _randn((d,), g, dtype)
    gy = _randn((rows * d + offset,), g, dtype)[offset:].view(rows, d)
    got, route = route_of("rmsnorm_bwd_scalar", lambda: rmsnorm_bwd_cuda(
        x, s, gy), ("vector", "scalar"))
    want = rmsnorm_bwd_torch(x, s, gy)
    torch.cuda.synchronize()
    return (x, s, gy), got, want, route


ADAM_HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
ADAM_SCALARS = (3e-4, 0.7, 0.1, 0.05)       # lr, clip scale, bc1, bc2


def adamw_run(p, g, m, v, sc, hyper, misalign=False):
    """The kernel in place on copies of (p, m, v), p one element off
    16-byte alignment with ``misalign`` (the scalar route); returns the
    copies and the route the kernel took ("vector" or "scalar")."""
    from repro_torch.kernels.fused_adamw import fused_adamw_cuda

    def copy(t):
        return ({k: x.clone() for k, x in t.items()} if isinstance(t, dict)
                else t.clone())

    got = (misaligned(p) if misalign else p.clone(), copy(m), copy(v))
    _, route = route_of("fused_adamw_scalar", lambda: fused_adamw_cuda(
        got[0], g, got[1], got[2], sc, **hyper), ("vector", "scalar"))
    torch.cuda.synchronize()
    return got, route


def adamw_case(shape, quant, p_dtype=torch.bfloat16, g_dtype=torch.bfloat16,
               seed=5, zero_block=False, misalign=False):
    """A leaf's update by the plain version, then by the kernel in place
    on copies of the same inputs (``adamw_run``).  Returns (inputs, the
    kernel's (p, m, v), the plain version's, the kernel's route)."""
    from repro_torch.kernels.fused_adamw import fused_adamw_torch
    from repro_torch.train import quantized_state as qs
    gen = _gen(seed)
    p = _randn(shape, gen, p_dtype, 0.02)
    g = _randn(shape, gen, g_dtype, 1e-3)
    m = _randn(shape, gen, torch.float32, 1e-3)
    v = _randn(shape, gen, torch.float32, 1e-3) ** 2
    if zero_block:      # a quant block whose new m and v are all 0
        for t in (g, m, v):
            t[..., :256] = 0
    if quant:
        m, v = qs.quantize(m), qs.quantize(v)
    sc = torch.tensor(ADAM_SCALARS, dtype=torch.float32, device="cuda")
    hyper = dict(ADAM_HYPER, apply_wd=len(shape) >= 2)
    want = fused_adamw_torch(p, g, m, v, lr=sc[0], scale=sc[1], bc1=sc[2],
                             bc2=sc[3], **hyper)
    got, route = adamw_run(p, g, m, v, sc, hyper, misalign)
    return (p, g, m, v, sc, hyper), got, want, route


def same_bits(a, b) -> bool:
    """Two updates (p, m, v), moments fp32 or {"q", "s"}, bit for bit."""
    flat = [(x, y) for x, y in zip(a, b) if not isinstance(x, dict)]
    flat += [(x[k], y[k]) for x, y in zip(a, b) if isinstance(x, dict)
             for k in x]
    return all(bool(torch.equal(cx, cy)) for x, y in flat
               for cx, cy in _chunks(x.reshape(-1).view(torch.uint8),
                                     y.reshape(-1).view(torch.uint8)))


def adamw_check(got, want):
    """Params within 1 bf16 (or f32) ulp; fp32 moments within 1 ulp; int8
    codes at most 1 apart on at most 1e-5 of the elements (an FMA that
    nvcc contracted would move a value across a rounding boundary; the
    kernel's _rn intrinsics should leave none) and scales within 1 ulp.
    Returns the measured distances and whether they pass."""
    res = {"p_ulp": ulp_dist(got[0], want[0]),
           "p_max_abs_err": max((max_err(g, w) for g, w in
                                 _chunks(got[0], want[0])), default=0.0)}
    if isinstance(want[1], dict):
        for name, g, w in (("m", got[1], want[1]), ("v", got[2], want[2])):
            most, differ = 0, 0
            for a, b in _chunks(g["q"], w["q"]):
                d = (a.int() - b.int()).abs()
                most = max(most, int(d.max()))
                differ += int((d > 0).sum())
            res[f"{name}_code_max_diff"] = most
            res[f"{name}_code_diff_share"] = differ / max(1, w["q"].numel())
            res[f"{name}_scale_ulp"] = ulp_dist(g["s"], w["s"])
        ok = all(res[f"{n}_code_max_diff"] <= 1
                 and res[f"{n}_code_diff_share"] <= 1e-5
                 and res[f"{n}_scale_ulp"] <= 1 for n in "mv")
    else:
        res["m_ulp"] = ulp_dist(got[1], want[1])
        res["v_ulp"] = ulp_dist(got[2], want[2])
        ok = res["m_ulp"] <= 1 and res["v_ulp"] <= 1
    res["passed"] = ok and res["p_ulp"] <= 1
    return res


def check_train_kernels(out, edge, edges):
    """The train path's kernels: the flash backward, the RMSNorm backward
    and both fused AdamW variants, at the train shapes (timed) and at
    edge cases."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_torch,
        flash_attention_cuda)
    from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_cuda,
                                             rmsnorm_bwd_torch)

    def worst(got, want, rtol):
        errs = [close(g, w, rtol) for g, w in zip(got, want)]
        return max(e for e, _ in errs), max(r for _, r in errs)

    def fwd_ok(fwd, case, rtol):
        """The forward's o (rtol as the backward's) and lse (fp32, rtol
        1e-4) with the lse output on, against the plain version's."""
        o, o_plain, lse, plain = fwd
        err, ratio = close(o, o_plain, rtol)
        check(ratio <= 1.0 and bool(torch.isfinite(o).all()),
              f"flash forward o with lse, {case}: max_abs_err {err}, "
              f"{ratio} x tol")
        live = plain > -1e29
        check(bool(torch.equal(live, lse > -1e29)),
              f"flash forward lse, {case}: fully masked rows disagree")
        lse_err, lse_ratio = close(lse[live], plain[live], 1e-4)
        check(lse_ratio <= 1.0, f"flash forward lse, {case}: max_abs_err "
              f"{lse_err}, {lse_ratio} x tol")
        return {"o_max_err": err, "o_err_over_tol": ratio,
                "lse_max_err": lse_err, "lse_err_over_tol": lse_ratio}

    progress("kernels: flash backward")
    # ---- flash backward: (2, 32, 2048, 128) causal bf16, the train step's
    (q, k, v, o, lse, do, kw), got, want, fwd = flash_bwd_case(
        2, 32, 32, 2048, 2048, 128, 128)
    # the forward at the train shape, lse written: held and timed, and
    # reported in the flash_attention row
    fa = out["flash_attention"]
    B, H, S, D = q.shape
    pairs = flash_pairs(B, H, S)
    fwd_flops = pairs * 2 * (D + v.shape[-1])
    b_ms, b_by = bound(2 * 4 * q.numel() + 4 * lse.numel(), fwd_flops)
    fa["train_shape"] = {
        "shape": list(q.shape), "rtol": 2e-2, **fwd_ok(fwd, "train shape",
                                                       2e-2),
        "kernel_ms": time_ms(lambda: flash_attention_cuda(
            q, k, v, with_lse=True, **kw)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
        "bound_ms": b_ms, "bound_by": b_by, "flops": fwd_flops}
    fa["train_shape"]["tflops"] = (fwd_flops / fa["train_shape"]["kernel_ms"]
                                   / 1e9)
    fa["max_err"] = max(fa["max_err"], fa["train_shape"]["o_max_err"],
                        *(out[f"flash_attention_{k}"]["max_err"]
                          for k in ("hybrid", "vlm", "encoder",
                                    *(g[0] for g in GQA_PREFILLS))))
    err, ratio = worst(got, want, 2e-2)
    check(ratio <= 1.0 and all(bool(torch.isfinite(t).all()) for t in got),
          f"flash_attention_bwd full width: max_abs_err {err}, {ratio} x tol")
    # no atomics: a second call gives the same bits
    again = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "flash_attention_bwd: two calls on the same inputs differ")
    del again
    nbytes = 2 * 8 * q.numel() + 4 * lse.numel()
    bwd_flops = pairs * 2 * (3 * D + 2 * D)
    b_ms, b_by = bound(nbytes, bwd_flops)
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    out["flash_attention_bwd"] = {
        "shape": [B, H, S, D], "max_err": err, "rtol": 2e-2,
        "err_over_tol": ratio,
        "kernel_ms": time_ms(lambda: flash_attention_bwd_cuda(
            q, k, v, o, lse, do, **kw)),
        "plain_ms": time_ms(lambda: flash_attention_bwd_torch(
            q, k, v, o, lse, do, **kw), iters=5),
        "library_ms": time_ms(lambda: torch.autograd.grad(
            ol, (ql, kl, vl), do, retain_graph=True)),
        "bound_ms": b_ms, "bound_by": b_by, "flops": bwd_flops,
        "bitwise_reproducible": True}
    fb = out["flash_attention_bwd"]
    fb["tflops"] = bwd_flops / fb["kernel_ms"] / 1e9
    qm = misaligned(q)
    cc = flash_attention_bwd_cuda(qm, k, v, o, lse, do, **kw)
    cc_err, cc_ratio = worst(cc, want, 2e-2)
    check(cc_ratio <= 1.0, f"flash_attention_bwd CUDA-core route: "
          f"max_abs_err {cc_err}, {cc_ratio} x tol")
    fb["was_route"] = {
        "route": "cuda_core", "max_err": cc_err, "err_over_tol": cc_ratio,
        "kernel_ms": time_ms(lambda: flash_attention_bwd_cuda(
            qm, k, v, o, lse, do, **kw), iters=5)}
    del q, k, v, o, lse, do, got, want, fwd, ql, kl, vl, ol, qm, cc
    # ---- the other train shapes: zamba2_2p7b's shared block, (2, 32,
    # 2048, 80) causal, and hubert_xlarge's bidirectional attention, (8,
    # 16, 1024, 80) without the mask (every kv tile full: the kernels'
    # non-causal branches)
    flash_train_shape(out, "hybrid_train_shape",
                      (2, 32, 32, 2048, 2048, 80, 80), True, fwd_ok, worst)
    flash_train_shape(out, "encoder_train_shape",
                      (8, 16, 16, 1024, 1024, 80, 80), False, fwd_ok, worst)
    # pixtral_12b's train shape, GQA 32 / 8: dk and dv summed over the
    # group of 4, each launch's route counted
    from repro_torch.kernels import flash_attention as fa_mod
    n0 = (fa_mod.BWD_LAUNCHES, fa_mod.BWD_LAUNCHES_CUDA_CORE)
    row = flash_train_shape(out, "vlm_train_shape",
                            (2, 32, 8, 2048, 2048, 128, 128), True, fwd_ok,
                            worst)
    cc = fa_mod.BWD_LAUNCHES_CUDA_CORE - n0[1]
    row["routes"] = {"wgmma": fa_mod.BWD_LAUNCHES - n0[0] - cc,
                     "cuda_core": cc}
    check(cc == 0, f"flash_attention_bwd vlm_train: {cc} launches on the "
          f"CUDA-core route")
    # deepseek_v2_236b's MLA train shape and the backward's cases at D > 128
    check_mla_flash_bwd(out, edge, fwd_ok, worst)
    for name, args, kw2 in [
            ("gqa_g4", (2, 8, 2, 100, 100, 64, 64), {}),
            ("gqa_g12", (1, 48, 4, 100, 100, 128, 128), {}),
            ("mqa_dv_ne_d_noncausal", (1, 4, 1, 77, 130, 128, 64),
             dict(causal=False)),
            ("window_50", (1, 4, 4, 200, 200, 128, 128), dict(window=50)),
            ("q_offset_64", (1, 4, 4, 33, 97, 128, 128), dict(q_offset=64)),
            ("fully_masked_rows", (1, 2, 2, 70, 70, 128, 128),
             dict(q_offset=-10)),
            # the tensor-core route's padding: the hybrid's D = Dv = 80,
            # and D = 72, Dv = 40 (neither a multiple of 16); GQA groups
            # over several 128-row tiles
            ("d80", (1, 4, 4, 200, 200, 80, 80), {}),
            ("d72_dv40", (1, 4, 2, 100, 100, 72, 40), {}),
            ("gqa_g4_tiles128", (1, 16, 4, 300, 300, 128, 128), {}),
            ("gqa_g12_tiles128", (1, 48, 4, 300, 300, 128, 128), {}),
            ("f32_small_heads", (2, 4, 2, 65, 65, 16, 8),
             dict(dtype=torch.float32))]:
        _, got, want, fwd = flash_bwd_case(*args, **kw2)
        rel = 1e-4 if kw2.get("dtype") == torch.float32 else 2e-2
        edges.append({"kernel": "flash_attention", "case":
                      f"with_lse_{name}", "rtol": rel,
                      **fwd_ok(fwd, name, rel), "passed": True})
        for gname, g, w in zip(("dq", "dk", "dv"), got, want):
            edge("flash_attention_bwd", f"{name}_{gname}", g, w, rel)
        if name == "fully_masked_rows":
            check(bool((got[0][:, :, :10] == 0).all()),
                  "flash_attention_bwd: fully masked rows' dq is not 0")

    progress("kernels: rmsnorm backward")
    # ---- rmsnorm backward: (4096, 4096), the train step's rows; the
    # vector route, twice bit for bit, and the scalar route on copies of x
    # and g one element off alignment (``was_route``)
    (x, s, gy), got, want, route = rms_bwd_case(4096, 4096)
    err, ratio = worst(got, want, 2e-2)
    check(route == "vector" and ratio <= 1.0,
          f"rmsnorm_bwd (4096, 4096): {route} route, max_abs_err {err}, "
          f"{ratio} x tol")
    again = rmsnorm_bwd_cuda(x, s, gy)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "rmsnorm_bwd: two calls on the same inputs differ")
    xm, gm = misaligned(x), misaligned(gy)
    sgot, sroute = route_of("rmsnorm_bwd_scalar", lambda: rmsnorm_bwd_cuda(
        xm, s, gm), ("vector", "scalar"))
    s_err, s_ratio = worst(sgot, want, 2e-2)
    check(sroute == "scalar" and s_ratio <= 1.0,
          f"rmsnorm_bwd on misaligned x and g: {sroute} route, max_abs_err "
          f"{s_err}, {s_ratio} x tol")
    b_ms, b_by = bound(2 * (3 * x.numel() + 2 * s.numel()), 10 * x.numel(),
                       F32_FLOPS)
    kernel_ms = time_ms(lambda: rmsnorm_bwd_cuda(x, s, gy))
    check(kernel_ms <= GUARD_MS["rmsnorm_bwd"],
          f"rmsnorm_bwd (4096, 4096): {kernel_ms} ms, above its "
          f"{GUARD_MS['rmsnorm_bwd']} ms guard")
    xl, sl = (t.detach().requires_grad_(True) for t in (x, s))
    yl = F.rms_norm(xl, (4096,), sl, 1e-6)
    out["rmsnorm_bwd"] = {
        "shape": [4096, 4096], "route": route, "max_err": err, "rtol": 2e-2,
        "err_over_tol": ratio, "bitwise_reproducible": True,
        "kernel_ms": kernel_ms,
        "plain_ms": time_ms(lambda: rmsnorm_bwd_torch(x, s, gy)),
        "library_ms": time_ms(lambda: torch.autograd.grad(
            yl, (xl, sl), gy, retain_graph=True)),
        "bound_ms": b_ms, "bound_by": b_by,
        # the vector route's row kernel and its dscale sum, apart
        "passes_ms": {t["kernel"]: t["ms_per_call"] for t in profile_steps(
            lambda: rmsnorm_bwd_cuda(x, s, gy), 20)["top"]
            if "rmsnorm" in t["kernel"]},
        "was_route": {"route": "scalar", "max_err": s_err,
                      "err_over_tol": s_ratio,
                      "kernel_ms": time_ms(lambda: rmsnorm_bwd_cuda(
                          xm, s, gm))}}
    del x, s, gy, got, want, again, xm, gm, sgot, xl, sl, yl
    # the other train steps' rows, 2 x 2048 tokens, held and timed: the
    # hybrid's widest, the Mamba2 gated norm's (4096, 5120), and
    # deepseek_v2_236b's MLA norms, q_norm (4096, 1536) and kv_norm
    # (4096, 512); xlstm_350m's 4 x 2048 rows at d_model 1024 and the mLSTM
    # out_norm's 2048
    for rows, d, key in ((4096, 5120, "hybrid_d5120"),
                         (4096, 1536, "moe_q_norm"),
                         (4096, 512, "moe_kv_norm"),
                         (8192, 1024, "xlstm_d1024"),
                         (8192, 2048, "xlstm_d2048")):
        (x, s, gy), got, want, route = rms_bwd_case(rows, d)
        err, ratio = worst(got, want, 2e-2)
        check(route == "vector" and ratio <= 1.0,
              f"rmsnorm_bwd ({rows}, {d}): {route} route, max_abs_err "
              f"{err}, {ratio} x tol")
        b_ms, b_by = bound(2 * (3 * x.numel() + 2 * s.numel()),
                           10 * x.numel(), F32_FLOPS)
        xl, sl = (t.detach().requires_grad_(True) for t in (x, s))
        yl = F.rms_norm(xl, (d,), sl, 1e-6)
        out["rmsnorm_bwd"][key] = {
            "shape": [rows, d], "route": route, "max_err": err,
            "rtol": 2e-2, "err_over_tol": ratio,
            "kernel_ms": time_ms(lambda: rmsnorm_bwd_cuda(x, s, gy)),
            "plain_ms": time_ms(lambda: rmsnorm_bwd_torch(x, s, gy)),
            "library_ms": time_ms(lambda: torch.autograd.grad(
                yl, (xl, sl), gy, retain_graph=True)),
            "bound_ms": b_ms, "bound_by": b_by}
        out["rmsnorm_bwd"]["max_err"] = max(out["rmsnorm_bwd"]["max_err"],
                                            err)
        del x, s, gy, got, want, xl, sl, yl
    for name, args, kw2, expect in [
            ("d8_f32", (3, 8), dict(dtype=torch.float32), "vector"),
            ("d4100_scalar_path", (5, 4100), {}, "scalar"),
            ("misaligned", (6, 4096), dict(offset=3), "scalar"),
            ("rows_1000_ragged_chunks", (1000, 4096), {}, "vector"),
            ("one_row", (1, 64), {}, "vector"),
            # 512 threads of 4 f32 vectors; a width that leaves threads idle
            ("d8192_f32", (77, 8192), dict(dtype=torch.float32), "vector"),
            ("d2560", (300, 2560), {}, "vector")]:
        _, got, want, route = rms_bwd_case(*args, **kw2)
        check(route == expect, f"rmsnorm_bwd {name}: {route} route, want "
              f"{expect}")
        rel = 1e-4 if kw2.get("dtype") == torch.float32 else 2e-2
        for gname, g, w in zip(("dx", "dscale"), got, want):
            edge("rmsnorm_bwd", f"{name}_{gname}", g, w, rel)
            edges[-1]["route"] = route

    check_adamw_kernel(out, edges)


# the distances adamw_check measures: the vector route may be no farther
# from the plain version than the scalar route on the same inputs
ADAM_DISTANCES = ("p_ulp", "p_max_abs_err", "m_ulp", "v_ulp",
                  "m_code_max_diff", "m_code_diff_share", "m_scale_ulp",
                  "v_code_max_diff", "v_code_diff_share", "v_scale_ulp")


def flash_train_shape(out, key, args, causal, fwd_ok, worst):
    """A train step's attention shape (``flash_bwd_case``'s ``args``)
    recorded as ``key`` in both flash rows: the forward with lse held and
    timed beside its plain version and SDPA, the backward held element by
    element, bit for bit over two calls, and timed beside its plain
    version and SDPA's backward.  The bounds count q and k (and dq, dk)
    at D, v and o (and dv, do) at Dv: the backward's five products are S
    and dP at D and Dv, dQ and dK at D, dV at Dv.  Returns the backward's
    row."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_torch,
        flash_attention_cuda, flash_attention_torch)
    progress(f"kernels: flash backward, {key}")
    (q, k, v, o, lse, do, kw), got, want, fwd = flash_bwd_case(
        *args, causal=causal)
    fa, fb = out["flash_attention"], out["flash_attention_bwd"]
    B, H, S, D = q.shape
    Dv = v.shape[-1]
    pairs = flash_pairs(B, H, S, causal)
    fwd_flops = pairs * 2 * (D + Dv)
    elems = q.numel() + k.numel() + v.numel() + o.numel()
    b_ms, b_by = bound(2 * elems + 4 * lse.numel(), fwd_flops)
    fa[key] = {
        "shape": list(q.shape), "causal": causal, "rtol": 2e-2,
        **fwd_ok(fwd, key, 2e-2),
        "kernel_ms": time_ms(lambda: flash_attention_cuda(
            q, k, v, with_lse=True, **kw)),
        "plain_ms": time_ms(lambda: flash_attention_torch(
            q, k, v, with_lse=True, **kw), iters=5),
        "library_ms": time_ms(lambda: sdpa(q, k, v, causal)),
        "bound_ms": b_ms, "bound_by": b_by, "flops": fwd_flops}
    fa["max_err"] = max(fa["max_err"], fa[key]["o_max_err"])
    err, ratio = worst(got, want, 2e-2)
    check(ratio <= 1.0 and all(bool(torch.isfinite(t).all()) for t in got),
          f"flash_attention_bwd {key}: max_abs_err {err}, {ratio} x tol")
    again = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"flash_attention_bwd {key}: two calls differ")
    del again
    flops = pairs * 2 * (3 * D + 2 * Dv)
    b_ms, b_by = bound(2 * 2 * elems + 4 * lse.numel(), flops)
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal,
                                        enable_gqa=H != k.shape[1])
    row = {
        "shape": [B, H, S, D], "v_head_dim": Dv, "causal": causal,
        "max_err": err,
        "rtol": 2e-2, "err_over_tol": ratio,
        "kernel_ms": time_ms(lambda: flash_attention_bwd_cuda(
            q, k, v, o, lse, do, **kw)),
        "plain_ms": time_ms(lambda: flash_attention_bwd_torch(
            q, k, v, o, lse, do, **kw), iters=5),
        "library_ms": time_ms(lambda: torch.autograd.grad(
            ol, (ql, kl, vl), do, retain_graph=True)),
        "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
        "bitwise_reproducible": True}
    row["tflops"] = flops / row["kernel_ms"] / 1e9
    fb[key] = row
    fb["max_err"] = max(fb["max_err"], err)
    return row


def check_mla_flash_bwd(out, edge, fwd_ok, worst):
    """The backward at MLA's head dims (q and k at 128 + 64 = 192, v at
    128): deepseek_v2_236b's train shape, (2, 128, 2048, 192 | 128)
    causal bf16, held, bit for bit over two calls and timed
    (``flash_train_shape``, ``mla_train_shape`` in both flash rows); then
    f32 at D = 192 and bf16 at D = 192 from a base one element off
    alignment (the CUDA-core kernels, a lane's 12 columns), D = 136 and
    D = 192 with Dv = 64 (the tensor-core route's three-half instances,
    the dk/dv pass split in two launches), each against its plain version
    with the route its launch took, as the wrapper counts it."""
    from repro_torch.kernels import flash_attention as fa
    n0 = (fa.BWD_LAUNCHES, fa.BWD_LAUNCHES_CUDA_CORE)
    row = flash_train_shape(out, "mla_train_shape",
                            (2, 128, 128, 2048, 2048, 192, 128), True,
                            fwd_ok, worst)
    # its launches: the case, a second call, warm-up and timing
    cc = fa.BWD_LAUNCHES_CUDA_CORE - n0[1]
    routes = {"mla_train": {"wgmma": fa.BWD_LAUNCHES - n0[0] - cc,
                            "cuda_core": cc}}
    check(cc == 0, f"flash_attention_bwd mla_train: {cc} launches on the "
          f"CUDA-core route")
    for name, args, kw2, want in [
            ("mla_f32_d192", (1, 8, 8, 130, 130, 192, 128),
             dict(dtype=torch.float32), "cuda_core"),
            ("mla_d192_misaligned", (1, 8, 8, 130, 130, 192, 128), {},
             "cuda_core"),
            ("d136_third_half", (1, 4, 2, 150, 150, 136, 128), {}, "wgmma"),
            ("mla_d192_dv64", (1, 4, 4, 200, 200, 192, 64), {}, "wgmma"),
            ("mla_d192_window_gqa", (1, 8, 2, 300, 300, 192, 128),
             dict(window=70), "wgmma")]:
        (q, k, v, o, lse, do, kw), _, want_g, _ = flash_bwd_case(*args,
                                                                 **kw2)
        qb = misaligned(q) if "misaligned" in name else q
        n0 = (fa.BWD_LAUNCHES, fa.BWD_LAUNCHES_CUDA_CORE)
        got = fa.flash_attention_bwd_cuda(qb, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        cc = fa.BWD_LAUNCHES_CUDA_CORE - n0[1]
        routes[name] = {"wgmma": fa.BWD_LAUNCHES - n0[0] - cc,
                        "cuda_core": cc}
        check(routes[name] == {"wgmma": int(want == "wgmma"),
                               "cuda_core": int(want == "cuda_core")},
              f"flash_attention_bwd {name}: routes {routes[name]}, want "
              f"{want}")
        rel = 1e-4 if q.dtype == torch.float32 else 2e-2
        for gname, g, w in zip(("dq", "dk", "dv"), got, want_g):
            edge("flash_attention_bwd", f"{name}_{gname}", g, w, rel)
        del q, k, v, o, lse, do, got, want_g, qb
    row.update(route="wgmma", routes=routes)


def check_adamw_kernel(out, edges):
    """Both fused AdamW instances (int8 and fp32 moments) at deepseek_7b's
    largest, widest and smallest leaves (timed) and at edge cases; the
    int8 one also at pixtral_12b's ``VLM_ADAMW_LEAVES`` (timed) and at
    deepseek_v2_236b's expert leaf.  Each
    vector-route case also runs the scalar route on a copy of p one
    element off alignment: that route is held by the same check, it is
    no nearer the plain version than the vector route, both give the same
    bits, and at full width its time is the row's ``was_route``."""
    from repro_torch.kernels.fused_adamw import (fused_adamw_cuda,
                                                 fused_adamw_torch)

    def both_routes(case, inputs, got, want, route, expect):
        chk = adamw_check(got, want)
        check(chk["passed"] and route == expect,
              f"fused_adamw {case}: {route} route (want {expect}), {chk}")
        if route != "vector":
            return chk, None, None
        sgot, sroute = adamw_run(*inputs, misalign=True)
        schk = adamw_check(sgot, want)
        check(schk["passed"] and sroute == "scalar",
              f"fused_adamw {case}: {sroute} route on a misaligned p, {schk}")
        farther = [k for k in ADAM_DISTANCES if k in chk and chk[k] > schk[k]]
        check(not farther, f"fused_adamw {case}: the vector route is farther "
              f"from the plain version than the scalar one in {farther}: "
              f"{chk} against {schk}")
        chk["bitwise_equal_to_scalar_route"] = same_bits(got, sgot)
        check(chk["bitwise_equal_to_scalar_route"],
              f"fused_adamw {case}: the two routes' bits differ")
        return chk, sgot, schk

    def timed_leaf(variant, quant, leaf, shape):
        """One leaf checked on both routes, the kernel timed on each, the
        plain version and (fp32 moments) the library yardstick."""
        progress(f"kernels: fused_adamw {variant} {leaf}")
        inputs, got, want, route = adamw_case(shape, quant)
        p, g, m, v, sc, hyper = inputs
        chk, sgot, schk = both_routes(f"{variant} {leaf}", inputs, got,
                                      want, route, "vector")
        n = p.numel()
        nb = n // shape[-1] * -(-shape[-1] // 256)
        nbytes = 10 * n + 16 * nb if quant else 22 * n
        b_ms, b_by = bound(nbytes, 20 * n, F32_FLOPS)
        lr, scale, bc1, bc2 = sc
        del want
        row = {"shape": list(shape), "route": route, **chk,
               "kernel_ms": time_ms(lambda: fused_adamw_cuda(
                   got[0], g, got[1], got[2], sc, **hyper)),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
               "was_route": {"route": "scalar", **schk,
                             "kernel_ms": time_ms(lambda: (
                                 fused_adamw_cuda(sgot[0], g, sgot[1],
                                                  sgot[2], sc, **hyper)))}}
        del got, sgot
        row["plain_ms"] = time_ms(lambda: fused_adamw_torch(
            p, g, m, v, lr=lr, scale=scale, bc1=bc1, bc2=bc2, **hyper),
            iters=3)
        del m, v
        if not quant:
            # yardstick, not the same function: one fused
            # torch.optim.AdamW step on the same bf16 param and grad
            # keeps bf16 moments (as the param), not fp32 ones, so it
            # moves 14 bytes an element where the kernel moves 22;
            # library_bound_ms is its own byte bound
            lp = torch.nn.Parameter(p.clone())
            lp.grad = g.clone()
            optim = torch.optim.AdamW([lp], lr=ADAM_SCALARS[0],
                                      betas=(ADAM_HYPER["b1"],
                                             ADAM_HYPER["b2"]),
                                      eps=ADAM_HYPER["eps"],
                                      weight_decay=ADAM_HYPER[
                                          "weight_decay"], fused=True)
            row["library_ms"] = time_ms(optim.step, iters=5)
            row["library_bound_ms"] = bound(14 * n, 20 * n, F32_FLOPS)[0]
            del lp, optim
        del p, g
        torch.cuda.empty_cache()
        return row

    leaves = {"layers/mlp/w_up": (30, 4096, 11008), "embed": (102400, 4096),
              "final_norm/scale": (4096,)}
    res = {}
    for variant, quant in (("i8", True), ("f32", False)):
        per_leaf = {leaf: timed_leaf(variant, quant, leaf, shape)
                    for leaf, shape in leaves.items()}
        res[variant] = per_leaf
        for name, shape, kw2, expect in [
                ("ragged_L300", (7, 300), {}, "scalar"),
                ("scalar_leaf", (), {}, "scalar"),
                ("zero_block", (4, 512), dict(zero_block=True), "vector"),
                ("g_f32", (3, 1000), dict(g_dtype=torch.float32), "scalar"),
                ("g_f32_vector", (3, 4096), dict(g_dtype=torch.float32),
                 "vector"),
                ("p_f32_g_f32", (5, 256), dict(p_dtype=torch.float32,
                                               g_dtype=torch.float32),
                 "vector"),
                # 4112 = 16 x 257: the last quant block of a row holds 16
                # elements, masked 16 at a time
                ("L4112_ragged_block_vector", (3, 4112), {}, "vector"),
                ("misaligned_scalar_route", (5, 4096), dict(misalign=True),
                 "scalar"),
                # hubert_xlarge's largest leaf and its LM head, 504 wide,
                # and xlstm_350m's largest leaf and its three leaves of a
                # last dim no multiple of 16, w_if (8) and the sLSTM's
                # w_ff_gate and w_ff_up (1365) (their moments are fp32)
                ("hubert_w_up", (48, 1280, 5120), {}, "vector"),
                ("hubert_lm_head", (1280, 504), {}, "scalar"),
                ("xlstm_w_up", (3, 7, 1024, 4096), {}, "vector"),
                ("xlstm_w_if", (3, 7, 2048, 8), {}, "scalar"),
                ("xlstm_w_ff_gate", (3, 1024, 1365), {}, "scalar")]:
            if quant and name.startswith(("hubert", "xlstm")):
                continue
            inputs, got, want, route = adamw_case(shape, quant, **kw2)
            chk = both_routes(f"{variant} {name}", inputs, got, want, route,
                              expect)[0]
            edges.append({"kernel": "fused_adamw",
                          "case": f"{variant}_{name}", "route": route,
                          **chk})
            if name == "zero_block" and quant:
                check(bool((got[1]["s"][..., 0] == 1.0).all()
                           and (got[1]["q"][..., :256] == 0).all()),
                      "fused_adamw i8: an all-zero block's scale is not 1")
    w_up = res["i8"]["layers/mlp/w_up"]
    f32 = res["f32"]["layers/mlp/w_up"]
    out["fused_adamw"] = {
        "shape": list(leaves["layers/mlp/w_up"]),
        "max_err": w_up["p_max_abs_err"],
        **{k: w_up[k] for k in ("kernel_ms", "plain_ms", "bound_ms",
                                "bound_by", "was_route")},
        "library_ms": None,
        "f32": {"ms": f32["kernel_ms"],
                "was_ms": f32["was_route"]["kernel_ms"],
                "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
                "library_ms": f32["library_ms"],
                "library_bound_ms": f32["library_bound_ms"]},
        "variants": res}
    out["fused_adamw"]["moe_expert_leaf"] = check_adamw_expert_leaf()
    out["fused_adamw"]["vlm_i8_leaves"] = {
        leaf: timed_leaf("i8", True, f"pixtral_12b {leaf}", shape)
        for leaf, shape in VLM_ADAMW_LEAVES.items()}


# pixtral_12b's largest int8 leaves as train_vlm steps them, at its
# VLM_TRAIN_LAYERS layers: the MLP's up projection, the embedding and the
# head (its rows 131072 wide, 512 quant blocks each)
VLM_ADAMW_LEAVES = {"layers/mlp/w_up": (20, 5120, 14336),
                    "embed": (131072, 5120), "lm_head": (5120, 131072)}


# deepseek_v2_236b's largest leaves at train_moe's 2 layers: each routed
# expert projection, (layers, experts, d_model, d_ff_expert)
MOE_EXPERT_LEAF = (2, 160, 5120, 1536)


def check_adamw_expert_leaf():
    """int8 AdamW on ``MOE_EXPERT_LEAF`` (``layers/moe/w_gate``'s shape at
    2 layers): 2.52e9 elements, past 2^31, in one launch, as the
    train_moe step runs it (the element offsets 64-bit, its 9.8e6 quant
    blocks within the kernel's 32-bit division).  The moments are random
    int8 codes and scales.  The plain version would need ~60 GB of fp32
    temporaries for the whole leaf; it runs on slices of whole rows (a
    row's quant blocks are its own, so each slice is the same function)
    against the kernel's update, slice by slice, under ``adamw_check``.
    Timed: the kernel, the plain version over all the slices once, the
    bound."""
    from repro_torch.kernels.fused_adamw import (fused_adamw_cuda,
                                                 fused_adamw_torch)
    progress("kernels: fused_adamw i8 on a 2.52e9-element expert leaf")
    shape, L = MOE_EXPERT_LEAF, MOE_EXPERT_LEAF[-1]
    gen = _gen(7)
    p = _randn(shape, gen, torch.bfloat16, 0.02)
    g = _randn(shape, gen, torch.bfloat16, 1e-3)
    n, nb = p.numel(), -(-L // 256)
    rows = n // L

    def moment(lo):
        return {"q": torch.randint(lo, 128, shape, generator=gen,
                                   device="cuda", dtype=torch.int8),
                "s": torch.rand((*shape[:-1], nb), generator=gen,
                                device="cuda") * 1e-4 + 1e-6}

    m, v = moment(-127), moment(0)
    sc = torch.tensor(ADAM_SCALARS, dtype=torch.float32, device="cuda")
    hyper = dict(ADAM_HYPER, apply_wd=True)
    got, route = adamw_run(p, g, m, v, sc, hyper)
    step = (1 << 26) // L

    def part(t, r0):
        if isinstance(t, dict):
            return {"q": t["q"].view(rows, L)[r0:r0 + step],
                    "s": t["s"].view(rows, nb)[r0:r0 + step]}
        return t.view(rows, L)[r0:r0 + step]

    def plain(r0):
        return fused_adamw_torch(part(p, r0), part(g, r0), part(m, r0),
                                 part(v, r0), lr=sc[0], scale=sc[1],
                                 bc1=sc[2], bc2=sc[3], **hyper)

    res = {}
    for r0 in range(0, rows, step):
        chk = adamw_check(tuple(part(t, r0) for t in got), plain(r0))
        k = min(step, rows - r0) * L
        for name, x in chk.items():
            if name.endswith("_share"):     # a count over the whole leaf
                res[name] = res.get(name, 0.0) + x * k / n
            elif name == "passed":
                res[name] = res.get(name, True) and x
            else:
                res[name] = max(res.get(name, 0), x)
    check(res["passed"] and route == "vector",
          f"fused_adamw i8 {list(shape)}: {route} route, {res}")
    del got
    b_ms, b_by = bound(10 * n + 16 * rows * nb, 20 * n, F32_FLOPS)
    row = {"shape": list(shape), "elements": n, "route": route, **res,
           "kernel_ms": time_ms(lambda: fused_adamw_cuda(
               p, g, m, v, sc, **hyper), iters=5),
           "plain_ms": time_ms(lambda: [plain(r0) for r0 in
                                        range(0, rows, step)],
                               iters=1, warmup=0),
           "plain_slices": -(-rows // step), "library_ms": None,
           "bound_ms": b_ms, "bound_by": b_by}
    del p, g, m, v
    torch.cuda.empty_cache()
    return row


def check_paged_kernel(out, edge, edges):
    """Paged decode attention at deepseek_7b's paged round (8 slots, 32
    heads, D 128, page 16, lengths 17-1000; timed) and at edge cases.  The
    split route is held against the plain version and its partition-and-
    merge arithmetic (``paged_attention_split_torch``), and twice on the
    same inputs, bit for bit (its merge is ordered); the scalar route on a
    copy of q one element off alignment is held and timed
    (``was_route``)."""
    from repro_torch.kernels.paged_attention import (
        PARTITION, paged_attention_cuda, paged_attention_split_torch,
        paged_attention_torch)
    progress("kernels: paged_attention")
    lens = [17, 157, 298, 438, 579, 719, 860, 1000]
    (q, kp, vp, pt, sl), got, want, route = paged_case(lens, 32, 32, 128,
                                                       128)
    err, ratio = close(got, want, 2e-2)
    check(route == "split" and ratio <= 1.0,
          f"paged_attention full width: {route} route, max_abs_err {err}, "
          f"{ratio} x tol")
    again = paged_attention_cuda(q, kp, vp, pt, sl)
    check(bool(torch.equal(got.view(torch.int16), again.view(torch.int16))),
          "paged_attention: two calls on the same inputs differ")
    s_err, s_ratio = close(got, paged_attention_split_torch(
        q, kp, vp, pt, sl, part=PARTITION), 2e-2)
    check(s_ratio <= 1.0, f"paged_attention full width against the split "
          f"plain version: max_abs_err {s_err}, {s_ratio} x tol")
    Hkv, D = kp.shape[2], kp.shape[3]
    live = sum(lens)
    nbytes = (2 * (q.numel() + got.numel()) + 2 * live * Hkv * (D + D)
              + 4 * (len(lens) + sum(-(-n // 16) for n in lens)))
    b_ms, b_by = bound(nbytes, live * q.shape[1] * 2 * (D + D))
    qm = misaligned(q)
    cc, cc_route = route_of("paged_attention_scalar", lambda: (
        paged_attention_cuda(qm, kp, vp, pt, sl)), ("split", "scalar"))
    cc_err, cc_ratio = close(cc, want, 2e-2)
    check(cc_route == "scalar" and cc_ratio <= 1.0,
          f"paged_attention on a misaligned q: {cc_route} route, "
          f"max_abs_err {cc_err}, {cc_ratio} x tol")
    out["paged_attention"] = {
        "shape": {"lens": lens, "Hq": 32, "Hkv": 32, "D": 128, "page": 16,
                  "partition": PARTITION},
        "route": route, "max_err": err, "rtol": 2e-2, "err_over_tol": ratio,
        "bitwise_reproducible": True,
        "vs_split_plain": {"max_err": s_err, "err_over_tol": s_ratio},
        "kernel_ms": time_ms(lambda: paged_attention_cuda(q, kp, vp, pt, sl)),
        "plain_ms": time_ms(lambda: paged_attention_torch(q, kp, vp, pt, sl)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        # the split route's two kernels, apart
        "kernels_ms": {t["kernel"]: t["ms_per_call"] for t in profile_steps(
            lambda: paged_attention_cuda(q, kp, vp, pt, sl), 20)["top"]
            if "paged_decode" in t["kernel"]},
        "was_route": {"route": "scalar", "max_err": cc_err,
                      "err_over_tol": cc_ratio,
                      "kernel_ms": time_ms(lambda: paged_attention_cuda(
                          qm, kp, vp, pt, sl))}}
    del q, kp, vp, pt, sl, got, want, again, qm, cc
    # the other GQA groups' rounds at full width, the same lengths: held,
    # bit for bit over two calls and timed (llama4's G = 5 runs the GC = 5
    # instance, starcoder2's G = 12 two GC = 6 blocks a kv head, yi's
    # G = 7 the GC = 7 instance; 32 / 8 and 64 / 8 the GC = 4 and GC = 8
    # instances beside them, on the same kv bytes)
    for key, hq, hkv in GQA_PREFILLS + (("g4", 32, 8), ("g8", 64, 8)):
        (q, kp, vp, pt, sl), got, want, route = paged_case(lens, hq, hkv,
                                                           128, 128)
        err, ratio = close(got, want, 2e-2)
        again = paged_attention_cuda(q, kp, vp, pt, sl)
        check(route == "split" and ratio <= 1.0 and bool(torch.equal(
            got.view(torch.int16), again.view(torch.int16))),
              f"paged_attention {key} ({hq} / {hkv}): {route} route, "
              f"max_abs_err {err}, {ratio} x tol, or two calls differ")
        nbytes = (2 * (q.numel() + got.numel()) + 2 * live * hkv * 2 * D
                  + 4 * (len(lens) + sum(-(-n // 16) for n in lens)))
        b_ms, b_by = bound(nbytes, live * hq * 2 * 2 * D)
        G = hq // hkv
        out["paged_attention"][key] = {
            "shape": {"Hq": hq, "Hkv": hkv, "group": G, "gc": paged_gc(G)},
            "route": route, "max_err": err, "err_over_tol": ratio,
            "bitwise_reproducible": True,
            "kernel_ms": time_ms(lambda: paged_attention_cuda(
                q, kp, vp, pt, sl)),
            "plain_ms": time_ms(lambda: paged_attention_torch(
                q, kp, vp, pt, sl)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        out["paged_attention"]["max_err"] = max(
            out["paged_attention"]["max_err"], err)
        del q, kp, vp, pt, sl, got, want, again
    for name, args, kw2, expect in [
            ("empty_and_len1_slots", ([0, 1, 16, 17], 8, 8, 128, 128), {},
             "split"),
            ("poisoned_trash_page", ([5, 33, 64], 4, 4, 128, 128),
             dict(poison_trash=True, maxp=8), "split"),
            ("gqa_g4_dv_ne_d", ([40, 300], 8, 2, 128, 64), {}, "split"),
            # starcoder2_15b's group (48 / 4 = 12 runs as 2 chunks of 6)
            # and yi_34b's (56 / 8 = 7)
            ("gqa_g12_two_chunks", ([40, 300, 1], 48, 4, 128, 128), {},
             "split"),
            ("gqa_g7", ([33, 200], 56, 8, 128, 128), {}, "split"),
            ("f32_g8", ([9, 100, 31], 8, 1, 64, 64),
             dict(dtype=torch.float32, page=8, maxp=16), "split"),
            # lengths on, just past and just short of the 128-position
            # partitions, and one position
            ("partition_boundaries", ([127, 128, 129, 256, 1], 8, 8, 128,
                                      128), {}, "split"),
            # a head dim that is no whole number of 16-byte words
            ("d100_scalar_route", ([40, 300], 8, 8, 100, 100), {},
             "scalar"),
            # page 8 (16 pages a partition), lengths ending mid-partition
            ("f32_page8", ([9, 100, 131, 250], 8, 2, 128, 128),
             dict(dtype=torch.float32, page=8, maxp=32), "split")]:
        _, got, want, route = paged_case(*args, **kw2)
        check(route == expect, f"paged_attention {name}: {route} route, "
              f"want {expect}")
        rel = 1e-4 if kw2.get("dtype") == torch.float32 else 2e-2
        edge("paged_attention", name, got, want, rel)
        edges[-1]["route"] = route
        if name == "empty_and_len1_slots":
            check(bool((got[0] == 0).all()), "paged: empty slot is not 0")


def check_mla_flash(row, edge):
    """The flash forward at MLA's head dims past the main shape (held and
    timed in ``row`` by ``flash_row``): f32 at D = 192 (the CUDA-core
    kernel, its rows staged 193 floats wide), bf16 at D = 192 from a base
    one element off alignment (the CUDA-core kernel), D = 136 (a third
    64-column half mostly zeros) and D = 192 with Dv = 64 (the wgmma
    route's three-half instances), each against its plain version, and
    the route each launch took, as the wrapper counts it (the backward's
    cases: ``check_mla_flash_bwd``)."""
    from repro_torch.kernels import flash_attention as fa
    routes = {}
    for name, args, kw2, want in [
            ("mla_main", (4, 128, 128, 512, 512, 192, 128), {}, "wgmma"),
            ("mla_f32_d192", (1, 8, 8, 130, 130, 192, 128),
             dict(dtype=torch.float32), "cuda_core"),
            ("mla_d192_misaligned", (1, 8, 8, 130, 130, 192, 128),
             dict(misalign=True), "cuda_core"),
            ("d136_third_half", (1, 4, 2, 150, 150, 136, 128), {}, "wgmma"),
            ("mla_d192_dv64", (1, 4, 4, 200, 200, 192, 64), {}, "wgmma")]:
        misalign = kw2.pop("misalign", False)
        n0 = (fa.LAUNCHES, fa.LAUNCHES_CUDA_CORE)
        (q, k, v, kw), got, want_o = flash_case(*args, **kw2)
        if misalign:
            n0 = (fa.LAUNCHES, fa.LAUNCHES_CUDA_CORE)
            got = fa.flash_attention_cuda(misaligned(q), k, v, **kw)
            torch.cuda.synchronize()
        cc = fa.LAUNCHES_CUDA_CORE - n0[1]
        routes[name] = {"wgmma": fa.LAUNCHES - n0[0] - cc, "cuda_core": cc}
        check(routes[name] == {"wgmma": int(want == "wgmma"),
                               "cuda_core": int(want == "cuda_core")},
              f"flash_attention {name}: routes {routes[name]}, want {want}")
        if name != "mla_main":
            rel = 1e-4 if q.dtype == torch.float32 else 2e-2
            edge("flash_attention", name, got, want_o, rel)
        del q, k, v, got, want_o
    row["routes"] = routes


def edge_check(edges):
    """``edge(name, case, got, want, rtol)``: hold an edge case within
    ``rtol`` (``close``), finite, and record it in ``edges``."""
    def edge(name, case, got, want, rtol):
        err, ratio = close(got, want, rtol)
        ok = bool(torch.isfinite(got).all()) and ratio <= 1.0
        edges.append({"kernel": name, "case": case, "max_err": err,
                      "rtol": rtol, "err_over_tol": ratio, "passed": ok})
        check(ok, f"{name} {case}: max_abs_err {err}, {ratio} x its "
              f"tolerance (rtol {rtol})")
    return edge


# the RMSNorm forward at the main paths' rows, bf16: deepseek_7b's prefill
# (2048, 4096), decode (4, 4096) and train step (4096, 4096); pixtral's
# prefill (8192, 5120) and decode; zamba2_2p7b's prefill (4000 rows) and
# decode (4 rows) at d_model 2560 and at the Mamba2 gated norm's 5120;
# deepseek_v2_236b's prefill (2048 rows) and decode (4) at d_model 5120
# and MLA's q_norm (1536) and kv_norm (512, a slice of kv_a's 576-wide
# rows, read in place); xlstm_350m's prefill (8192 rows) and decode (4) at
# d_model 1024 and the mLSTM out_norm's 2048; yi_34b's prefill, decode and
# paged round (8 slots) at d_model 7168, and llama4's paged round at 5120:
# (rows, d, width of the rows x is a slice of or None, key)
RMSNORM_SHAPES = (
    (2048, 4096, None, "rmsnorm"), (4, 4096, None, "rmsnorm_decode"),
    (4096, 4096, None, "rmsnorm_train"), (8192, 5120, None, "rmsnorm_vlm"),
    (4, 5120, None, "rmsnorm_vlm_decode"),
    (4000, 2560, None, "rmsnorm_hybrid_d2560"),
    (4000, 5120, None, "rmsnorm_hybrid_d5120"),
    (4, 2560, None, "rmsnorm_hybrid_decode_d2560"),
    (4, 5120, None, "rmsnorm_hybrid_decode_d5120"),
    (2048, 5120, None, "rmsnorm_moe_d5120"),
    (2048, 1536, None, "rmsnorm_moe_q_norm"),
    (2048, 512, None, "rmsnorm_moe_kv_norm"),
    (2048, 512, 576, "rmsnorm_moe_kv_norm_strided"),
    (4, 1536, None, "rmsnorm_moe_decode_q_norm"),
    (4, 512, None, "rmsnorm_moe_decode_kv_norm"),
    (4, 512, 576, "rmsnorm_moe_decode_kv_norm_strided"),
    (8192, 1024, None, "rmsnorm_xlstm_d1024"),
    (8192, 2048, None, "rmsnorm_xlstm_d2048"),
    (4, 1024, None, "rmsnorm_xlstm_decode_d1024"),
    (4, 2048, None, "rmsnorm_xlstm_decode_d2048"),
    (2048, 7168, None, "rmsnorm_yi_d7168"),
    (4, 7168, None, "rmsnorm_yi_decode_d7168"),
    (8, 7168, None, "rmsnorm_yi_round_d7168"),
    (8, 5120, None, "rmsnorm_llama4_round_d5120"))

# edge cases: (name, rms_case arguments, keywords, the route it must take);
# together with the shapes above they launch every vector-route instance
RMSNORM_EDGES = (
    ("d8_f32", (3, 8), dict(dtype=torch.float32), "vector"),
    ("d8", (3, 8), {}, "vector"),
    ("d512_3_rows", (3, 512), {}, "vector"),
    ("d512_33000_rows", (33000, 512), {}, "vector"),
    ("d1024_f32", (5, 1024), dict(dtype=torch.float32), "vector"),
    ("d2000", (9, 2000), {}, "vector"),
    ("d6000", (3, 6000), {}, "vector"),
    ("d4096_f32", (3, 4096), dict(dtype=torch.float32), "vector"),
    ("d8192_f32", (3, 8192), dict(dtype=torch.float32), "vector"),
    ("d8192", (7, 8192), {}, "vector"),
    ("d4100_scalar_path", (5, 4100), {}, "scalar"),
    ("d6_f32", (3, 6), dict(dtype=torch.float32), "scalar"),
    ("misaligned", (6, 4096), dict(offset=3), "scalar"),
    ("stride_4100", (6, 4096), dict(width=4100), "scalar"))

RMSNORM_KEYS = tuple(key for *_, key in RMSNORM_SHAPES)

# the decode rows timed inside a captured graph, beside the floor
RMSNORM_GRAPH_SHAPES = ((4, 4096), (4, 512), (8, 7168))


def check_rmsnorm_kernel(out, edge):
    """The RMSNorm forward at ``RMSNORM_SHAPES``, each held against its
    plain version by both routes (the vector route the wrapper takes, the
    scalar route on the same inputs) and timed beside ``F.rms_norm``;
    the (2048, 4096) time under ``GUARD_MS``; ``RMSNORM_EDGES`` held with
    their routes; the decode rows in a captured graph beside the floor
    (N launches of the port's smallest call, (1, 8) f32)."""
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_torch
    for rows, d, width, key in RMSNORM_SHAPES:
        (x, s), got, want, route = rms_case(rows, d, width=width)
        check(route == "vector", f"rmsnorm ({rows}, {d}) width {width}: "
              f"{route} route")
        err, ratio = close(got, want, 2e-2)
        check(ratio <= 1.0, f"rmsnorm ({rows}, {d}) width {width}: "
              f"max_abs_err {err}, {ratio} x tol")
        sgot = rms_scalar(x, s)
        serr, sratio = close(sgot, want, 2e-2)
        check(sratio <= 1.0, f"rmsnorm scalar route ({rows}, {d}) width "
              f"{width}: max_abs_err {serr}, {sratio} x tol")
        b_ms, b_by = bound(2 * (2 * x.numel() + s.numel()), 4 * x.numel(),
                           F32_FLOPS)
        row = {
            "shape": [rows, d], "row_stride": width or d, "route": route,
            "max_err": err, "rtol": 2e-2, "err_over_tol": ratio,
            "kernel_ms": time_ms(lambda: rmsnorm_cuda(x, s)),
            "was_route": {
                "route": "scalar", "max_err": serr, "err_over_tol": sratio,
                "kernel_ms": time_ms(lambda: rms_scalar(x, s))},
            "plain_ms": time_ms(lambda: rmsnorm_torch(x, s)),
            "library_ms": time_ms(lambda: F.rms_norm(x, (d,), s, 1e-6)),
            "bound_ms": b_ms, "bound_by": b_by}
        row["bound_share"] = b_ms / row["kernel_ms"]
        row["was_ms"] = row["was_route"]["kernel_ms"]
        # the same three with the L2 flushed clean: the call's own bytes
        # alone, without the write-back of the lines a flush left dirty
        row["clean_l2"] = {
            "kernel_ms": time_ms(lambda: rmsnorm_cuda(x, s), clean=True),
            "was_ms": time_ms(lambda: rms_scalar(x, s), clean=True),
            "library_ms": time_ms(lambda: F.rms_norm(x, (d,), s, 1e-6),
                                  clean=True)}
        row["clean_l2"]["bound_share"] = b_ms / row["clean_l2"]["kernel_ms"]
        out[key] = row
    kernel_ms = out["rmsnorm"]["kernel_ms"]
    check(kernel_ms <= GUARD_MS["rmsnorm"],
          f"rmsnorm (2048, 4096): {kernel_ms} ms, above its "
          f"{GUARD_MS['rmsnorm']} ms guard")
    # the kernels line's error is the worst over the main paths' shapes
    out["rmsnorm"]["max_err"] = max(out[k]["max_err"] for k in out
                                    if k.startswith("rmsnorm"))
    for name, args, kw2, expect in RMSNORM_EDGES:
        _, got, want, route = rms_case(*args, **kw2)
        check(route == expect, f"rmsnorm {name}: {route} route, want "
              f"{expect}")
        rel = 1e-5 if kw2.get("dtype") == torch.float32 else 2e-2
        edge("rmsnorm", name, got, want, rel)
    graphs = {}
    for rows, d in RMSNORM_GRAPH_SHAPES:
        (x, s), _, _, _ = rms_case(rows, d)
        graphs[f"{rows}x{d}"] = {
            "vector_ms": graph_ms(lambda: rmsnorm_cuda(x, s)),
            "scalar_ms": graph_ms(lambda: rms_scalar(x, s))}
    in_graph = graphs["8x7168"]["vector_ms"]
    check(in_graph <= GUARD_MS["rmsnorm_graph_8x7168"],
          f"rmsnorm (8, 7168) in a graph: {in_graph} ms a call, above its "
          f"{GUARD_MS['rmsnorm_graph_8x7168']} ms guard")
    (x, s), _, _, _ = rms_case(1, 8, dtype=torch.float32)
    graphs["floor_ms"] = graph_ms(lambda: rmsnorm_cuda(x, s))
    # the same call alone between events (``time_ms``): what a shape's
    # kernel_ms holds beside its bytes
    graphs["floor_time_ms"] = time_ms(lambda: rmsnorm_cuda(x, s))
    graphs["floor_time_ms_clean_l2"] = time_ms(lambda: rmsnorm_cuda(x, s),
                                               clean=True)
    graphs["floor"] = "rmsnorm_cuda (1, 8) f32, vector route: one warp"
    graphs["launches_a_replay"] = 100
    out["rmsnorm"]["decode_in_graph"] = graphs


def phase_rmsnorm():
    """``check_rmsnorm_kernel`` alone, as the kernels phase runs it (to
    iterate on the RMSNorm forward: ``benchmarks/config_phases.py
    rmsnorm``)."""
    out, edges = {}, []
    check_rmsnorm_kernel(out, edge_check(edges))
    emit("rmsnorm_kernel", full_width=out, edge_cases=edges)
    return out


def phase_kernels():
    """Every kernel vs its plain version at full width (timed) and at edge
    cases.  Launches made here are checks, not the main path's."""
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_torch)
    out = {}
    edges = []
    edge = edge_check(edges)

    def flash_row(*shape, causal=True):
        """A bf16 prefill (or, ``causal=False``, encoder) shape, held and
        timed."""
        (q, k, v, kw), got, want = flash_case(*shape, causal=causal)
        err, ratio = close(got, want, 2e-2)
        check(ratio <= 1.0 and bool(torch.isfinite(got).all()),
              f"flash_attention {list(q.shape)} causal={causal}: "
              f"max_abs_err {err}, {ratio} x tol")
        B, H, S, D = q.shape
        pairs = flash_pairs(B, H, S, causal)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + got.numel())
        flops = pairs * 2 * (D + v.shape[-1])
        b_ms, b_by = bound(nbytes, flops)
        row = {
            "shape": [B, H, S, D], "kv_heads": k.shape[1], "causal": causal,
            "max_err": err, "rtol": 2e-2, "err_over_tol": ratio,
            "kernel_ms": time_ms(lambda: flash_attention_cuda(q, k, v, **kw)),
            "plain_ms": time_ms(lambda: flash_attention_torch(q, k, v, **kw)),
            "library_ms": time_ms(lambda: sdpa(q, k, v, causal)),
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops}
        row["tflops"] = flops / row["kernel_ms"] / 1e9
        # the CUDA-core route (the bf16 design before the tensor cores,
        # kept for f32) on the same inputs, held and timed
        qm = misaligned(q)
        cc = flash_attention_cuda(qm, k, v, **kw)
        cc_err, cc_ratio = close(cc, want, 2e-2)
        check(cc_ratio <= 1.0, f"flash_attention CUDA-core route "
              f"{list(q.shape)}: max_abs_err {cc_err}, {cc_ratio} x tol")
        row["was_route"] = {
            "route": "cuda_core", "max_err": cc_err, "err_over_tol": cc_ratio,
            "kernel_ms": time_ms(lambda: flash_attention_cuda(qm, k, v,
                                                              **kw))}
        return row

    # ---- flash attention: deepseek_7b's prefill, q/k/v (4, 32, 512, 128),
    # and zamba2_2p7b's shared attention block, (4, 32, 1000, 80); causal
    out["flash_attention"] = flash_row(4, 32, 32, 512, 512, 128, 128)
    out["flash_attention_hybrid"] = flash_row(4, 32, 32, 1000, 1000, 80, 80)
    # pixtral_12b's prefill, GQA 32/8 at 4 x 2048 positions (patches and
    # text), and hubert_xlarge's bidirectional attention, (8, 16, 1024, 80)
    out["flash_attention_vlm"] = flash_row(4, 32, 8, 2048, 2048, 128, 128)
    out["flash_attention_encoder"] = flash_row(8, 16, 16, 1024, 1024, 80, 80,
                                               causal=False)
    # deepseek_v2_236b's MLA prefill: q and k at 128 + 64 = 192, v at 128
    out["flash_attention_mla"] = flash_row(4, 128, 128, 512, 512, 192, 128)
    check_mla_flash(out["flash_attention_mla"], edge)
    # the other GQA groups' prefills at 4 x 512: llama4_maverick_400b's
    # 40 / 8 (G = 5), starcoder2_15b's 48 / 4 (G = 12), yi_34b's 56 / 8
    # (G = 7)
    for key, hq, hkv in GQA_PREFILLS:
        out[f"flash_attention_{key}"] = flash_row(4, hq, hkv, 512, 512, 128,
                                                  128)
    # the kernels line's error is the worst over the main paths' prefill
    # shapes; serve_moe's is MLA's
    out["flash_attention"]["max_err"] = max(
        out["flash_attention"]["max_err"],
        out["flash_attention_mla"]["max_err"])
    for name, args, kw2 in [
            ("gqa_g4", (2, 8, 2, 100, 100, 64, 64), {}),
            ("gqa_g12", (1, 48, 4, 100, 100, 128, 128), {}),
            # the paged plane's admission prefills: batch 1, a page-multiple
            # prompt bucket with a partial last kv tile (80) and the longest
            ("admission_bucket_80", (1, 32, 32, 80, 80, 128, 128), {}),
            ("admission_bucket_704", (1, 32, 32, 704, 704, 128, 128), {}),
            ("mqa_dv_ne_d_noncausal", (1, 4, 1, 77, 130, 128, 64),
             dict(causal=False)),
            ("window_50", (1, 4, 4, 200, 200, 128, 128), dict(window=50)),
            ("q_offset_64", (1, 4, 4, 33, 97, 128, 128), dict(q_offset=64)),
            ("fully_masked_rows", (1, 2, 2, 70, 70, 128, 128),
             dict(q_offset=-10)),
            # the tensor-core route's padding (neither a multiple of 16)
            # and GQA groups over several 128-row tiles
            ("d72_dv40", (1, 4, 2, 100, 100, 72, 40), {}),
            ("gqa_g4_tiles128", (1, 16, 4, 300, 300, 128, 128), {}),
            ("gqa_g12_tiles128", (1, 48, 4, 300, 300, 128, 128), {}),
            ("f32_small_heads", (2, 4, 2, 65, 65, 16, 8),
             dict(dtype=torch.float32))]:
        _, got, want = flash_case(*args, **kw2)
        rel = 1e-4 if kw2.get("dtype") == torch.float32 else 2e-2
        edge("flash_attention", name, got, want, rel)
        if name == "fully_masked_rows":
            check(bool((got[:, :, :10] == 0).all()),
                  "flash_attention: fully masked rows are not 0")

    check_rmsnorm_kernel(out, edge)
    check_paged_kernel(out, edge, edges)
    check_ssd_kernel(out, edge, edges)
    check_ssd_bwd_kernel(out, edge, edges)
    check_train_kernels(out, edge, edges)
    check_slstm_kernel(out, edge)
    emit("kernels", launches=counts(), full_width=out, edge_cases=edges)
    return out


def dense_launches(cfg):
    """The kernels' launches in one dense prefill (or paged admission),
    one decode step and one paged round: a layer (a moe family's dense or
    MoE sublayer alike) runs one flash attention (prefill only) or one
    paged attention (a paged round) and two RMSNorms, four with MLA (its
    q_norm and kv_norm too; its absorbed decode is plain einsums), the
    final norm one; a LayerNorm config none."""
    zero = {n: 0 for n in COUNTERS}
    per = 4 if cfg.attention.is_mla else 2
    # LayerNorm (starcoder2_15b's) is plain PyTorch: no RMSNorm launch
    per = per if cfg.norm == "rms" else 0
    L, norms = cfg.n_layers, per * cfg.n_layers + int(cfg.norm == "rms")
    return ({**zero, "flash_attention": L, "rmsnorm": norms},
            {**zero, "rmsnorm": norms},
            {**zero, "paged_attention": L, "rmsnorm": norms})


def digest(t) -> str:
    """The sha256 of a tensor's bytes, read on the host."""
    import hashlib
    b = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
    return hashlib.sha256(memoryview(b.numpy())).hexdigest()


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone(v) for v in tree)
    return tree.clone()


def _eager_calls():
    from repro_torch.train import compile_cache
    return compile_cache.EAGER_CALLS


def _zero_eager_calls():
    from repro_torch.train import compile_cache
    compile_cache.EAGER_CALLS = 0


def graph_check(name, graph, steps, eager_calls, device):
    """The main path's decode ran as graph replays: one capture, a replay
    a step, and no eager decode step (on the CPU: every step eager)."""
    st = graph.stats()
    if torch.device(device).type == "cuda":
        check(st["captures"] == 1 and st["replays"] == steps
              and st["eager_calls"] == 0 and eager_calls == 0,
              f"{name}: {steps} decode steps on the main path, graph "
              f"{st}, {eager_calls} eager decode steps")
    else:
        check(st["captures"] == st["replays"] == 0
              and st["eager_calls"] == steps,
              f"{name}: {steps} decode steps on the CPU, graph {st}")
    return {**st, "card": _CARD}


def restart(rt):
    """A dense-plane block's cache back to its initial values (zeros; the
    xlstm's mLSTM m at -inf and sLSTM n at 1), in place: the graph keeps
    its cache."""
    from repro_torch.models import model
    shape = rt.job.shape
    fresh = model.init_cache(rt.job.cfg, shape.global_batch, shape.seq_len,
                             rt.device)
    for t, f in zip(_tensors(rt.cache), _tensors(fresh)):
        t.copy_(f)


def captured_vs_eager(rt, batch, n):
    """A dense-plane block's captured decode against its step function run
    eagerly, from one state (a prefill of ``batch`` into the block's
    zeroed cache, and a copy of it): ``n`` steps each, every token and
    the final cache's bit checksums equal.  Each loop ends every step in
    the launcher's ``token.cpu()``: their seconds and tok/s are decode
    before and after capture.  Returns the record, the eager copy of the
    cache and its position scalar (for a profile of the eager step); the
    check's launches are not the main path's."""
    saved = counts()
    graph = rt.decode_graph
    restart(rt)
    rt.prefill(batch)
    params, B, P = rt.state["params"], rt.token.shape[0], rt.cache_len
    cache, first = _clone(rt.cache), rt.token.clone()
    pos = torch.zeros((), dtype=torch.int32, device=rt.device)
    rt._sync()
    t0 = time.perf_counter()
    tok, eager = first, []
    for i in range(n):
        pos.fill_(P + i)
        tok, _ = graph.fn(params, tok, cache, pos, None)
        eager.append(tok.cpu())
    eager_s = time.perf_counter() - t0
    replays = graph.replays
    t0 = time.perf_counter()
    captured = []
    for _ in range(n):
        rt.step()
        captured.append(rt.token.cpu())
    captured_s = time.perf_counter() - t0
    set_counts(saved)
    out = {"steps": n,
           "tokens_equal": all(torch.equal(a, b)
                               for a, b in zip(eager, captured)),
           "cache_bitwise_equal": bit_checksums(cache)
           == bit_checksums(rt.cache),
           "replays": graph.replays - replays,
           "eager_s": eager_s, "captured_s": captured_s,
           "eager_tok_s": B * n / eager_s,
           "captured_tok_s": B * n / captured_s, "card": _CARD}
    check(out["tokens_equal"] and out["cache_bitwise_equal"],
          f"captured decode against eager from one state: {out}")
    if rt.device.type == "cuda":
        check(out["replays"] == n, f"captured decode: {out}")
    return out, cache, first, pos


def sampled_vs_eager(device):
    """A sampling job's decode on the dense and the paged plane, at
    deepseek_7b's smoke size: captured with its generator registered,
    against the same block (the same seed) run eagerly, token for token
    over 8 steps (4 sessions of 8 tokens on the paged plane, whose
    admissions draw eagerly in between).  The check's launches are not
    the main path's."""
    import repro_torch.configs as configs
    from repro_torch.core.runtime import JobSpec
    from repro_torch.data import pipeline
    from repro_torch.models.config import ShapeConfig
    saved = counts()
    cfg = configs.get_smoke("deepseek_7b")
    prompt = pipeline.synthetic_batch(
        cfg, ShapeConfig("p", "prefill", 16, 2), step=0, seed=0)["tokens"]
    out = {}
    for plane in ("dense", "paged"):
        runs = []
        for capture in (False, True):
            if plane == "dense":
                job = JobSpec(cfg, ShapeConfig("s", "serve", 32, 2),
                              kind="serve", seed=0, decode_sample=True)
            else:
                job = dataclasses.replace(_paged_job(True),
                                          decode_sample=True)
            rt = _block(job, device)
            rt.init_state()
            rt.decode_graph.capture = capture
            if plane == "dense":
                rt.prefill({"tokens": prompt})
                toks = []
                for _ in range(8):
                    rt.step()
                    toks.append(rt.token.cpu())
                toks = torch.cat(toks, 1).tolist()
            else:
                for p in _paged_prompts(cfg, True)[:4]:
                    rt.start_session(p, max_new_tokens=8)
                toks = [(e["session"], e["token"]) for e in _feed(rt)[0]
                        if e["event"] == "token"]
            runs.append((toks, rt.decode_graph.stats()))
            del rt
        (want, _), (got, st) = runs
        out[plane] = {"tokens_equal": got == want, "graph": st}
        on_card = torch.device(device).type == "cuda"
        check(got == want and (not on_card or (
            st["captures"] == 1 and st["replays"] > 0
            and st["eager_calls"] == 0)),
            f"sampled {plane} decode, captured against eager: {out}")
    set_counts(saved)
    return out


def prefill_pair(params, cfg, batch, B, P, device):
    """The prefill's logits with the kernels and with their plain
    versions: (checked, plain, the kernels' as the runtime computes them,
    what else was read)."""
    from repro_torch.models import model
    got, _ = model.prefill(params, cfg, batch,
                           model.init_cache(cfg, B, P, device))
    want, _ = model.prefill(params, cfg, batch,
                            model.init_cache(cfg, B, P, device),
                            impl="torch")
    return got, want, got, {}


class RoutingTape:
    """Stands in for ``models.moe.route`` while it is open, each MoE layer
    known by its router's storage.  ``record`` keeps every layer's
    routing of a run (its expert choices ``idx`` and slots); ``replay``
    hands each layer the recorded choices and slots, with the probabilities
    and the gates computed from this run's router at the recorded
    choices, so that the router keeps its gradient (through the gates and
    the aux loss's mean probabilities) in this run's graph; ``compare``
    routes afresh and counts, layer by layer, the tokens whose chosen
    experts and the (token, k) choices whose slots differ from the
    recording.  A layer routed again within one run (remat's recompute in
    the backward) gets the same entry as its first call in every mode,
    and is held to route as that call did (``recompute_changed`` counts
    the choices and slots that differ, over every run).  ``dropped`` is
    each layer's count of choices the capacity dropped in the last run.
    ``tally`` routes afresh and, every call on its own, adds the (token, k)
    choices the capacity dropped and the choices made to ``tallies``: the
    rows in ``live`` under ``where[0]``, the others under ``where[1]``
    (``set("tally", live, where)`` before each call)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.route = moe, moe.route
        self.rec, self.tallies = {}, {}
        self.recompute_changed = 0
        self.set("record")

    def __enter__(self):
        self.moe.route = self
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route

    def set(self, mode, live=None, where=None):
        self.mode, self.first = mode, {}
        self.tokens_changed, self.slots_changed, self.dropped = [], [], []
        self.live, self.where = live, where

    def replayed(self, xs, router, mcfg, idx, slots, C):
        """``moe.route``'s outputs at the recorded ``idx`` and ``slots``:
        the probabilities from this call's router, the gates renormalised
        over the recorded choices, 0 where the recording dropped one."""
        probs = torch.softmax(xs.float() @ router, dim=-1)
        gates = torch.gather(probs, 1, idx)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        kept = slots != mcfg.n_experts * C
        return probs, idx, slots, (gates.T * kept).to(xs.dtype), C

    def __call__(self, xs, router, mcfg):
        key = router.data_ptr()
        if self.mode == "replay":
            r = self.replayed(xs, router, mcfg, *self.rec[key])
        else:
            r = self.route(xs, router, mcfg)
        if self.mode == "tally":
            dropped = (r[2] == mcfg.n_experts * r[4]).sum(0)     # (T,)
            for where, rows in zip(self.where, (self.live, ~self.live)):
                d, n = self.tallies.setdefault(where, (0, 0))
                self.tallies[where] = (d + int(dropped[rows].sum()),
                                       n + r[2].shape[0] * int(rows.sum()))
            return r
        if key in self.first:           # the layer's recompute
            idx, slots = self.first[key]
            self.recompute_changed += int((r[1] != idx).sum()
                                          + (r[2] != slots).sum())
            return r
        self.first[key] = (r[1], r[2])
        self.dropped.append(int((r[2] == mcfg.n_experts * r[4]).sum()))
        if self.mode == "record":
            self.rec[key] = (r[1], r[2], r[4])
        elif self.mode == "compare":
            idx, slots, _ = self.rec[key]
            same = (torch.sort(r[1], -1)[0] == torch.sort(idx, -1)[0])
            self.tokens_changed.append(int((~same.all(-1)).sum()))
            self.slots_changed.append(int((r[2] != slots).sum()))
        return r

    def tally_summary(self):
        return {k: {"dropped": d, "choices": n,
                    "dropped_share": d / n if n else None}
                for k, (d, n) in self.tallies.items()}


def moe_prefill_pair(params, cfg, batch, B, P, device):
    """``prefill_pair`` for the moe family.  Routing is a discrete choice:
    a kernel and its plain version may round an RMSNorm output to
    neighbouring bf16 steps, which can swap a token's k-th and (k+1)-th
    experts near a tie, and a swap moves the capacity's slots of every
    later token of those experts (the last tokens, whose logits are read,
    have the lowest priority).  So the plain run's routing is recorded
    and replayed into the kernels' run, whose logits are checked; the
    kernels' run with its own routing (the runtime's first tokens) is
    read beside it, with the tokens and choices whose routing changed."""
    from repro_torch.models import model

    def run(impl):
        return model.prefill(params, cfg, batch,
                             model.init_cache(cfg, B, P, device),
                             impl=impl)[0]

    own = {}

    def own_routing(tape, want):
        tape.set("compare")
        own["logits"] = run("auto")
        return {"own_routing": {**logits_check(own["logits"], want),
                                "tokens_rerouted_by_layer":
                                    tape.tokens_changed,
                                "choices_reslotted_by_layer":
                                    tape.slots_changed}}

    got, want, read = logits_pair(cfg, run, then=own_routing)
    free = own["logits"]
    return got, want, free, read


def dense_plane(name, argv, device, positions=None, cfg=None, extra=None,
                logits_pair=prefill_pair):
    """A dense-plane serve block through the launcher's entry point
    (``argv``, on ``cfg`` when given, else the config ``argv`` names):
    the decode steps as graph replays, each kernel's launches exact, the
    tokens in range, the prefill logits against ``impl="torch"`` and the
    first token their argmax, then the captured decode against the eager
    one from one state, and the warm prefill and decode steps profiled.
    ``positions(rt, batch, args)``, if given, reads the cache the
    launcher's decode left before anything else touches it;
    ``extra(rt, batch, args, out)``, if given, adds its keys to the
    record at the end; ``logits_pair`` gives the logits checked
    (``prefill_pair``).  Returns the phase's record."""
    from repro_torch.launch import serve
    from repro_torch.models import model
    args = serve.parse_args(argv)
    zero_counts()
    _zero_eager_calls()
    res = serve.run(args, cfg)
    launches = counts()
    rt, cfg = res["runtime"], res["cfg"]
    B, P, G = args.batch, args.prompt_len, args.gen
    graph = graph_check(name, rt.decode_graph, G - 1, _eager_calls(),
                        device)
    pre, dec, _ = dense_launches(cfg)
    if rt.device.type != "cuda":
        pre = dec = {n: 0 for n in COUNTERS}
    check(launches == {n: pre[n] + (G - 1) * dec[n] for n in COUNTERS},
          f"{name} main path launches {launches}: not one prefill {pre} and "
          f"{G - 1} decode steps {dec}")
    toks = res["tokens"]
    check(toks.shape == (B, G) and toks.min() >= 0
          and toks.max() < cfg.vocab_size, f"{name} tokens {toks.shape}")
    batch = {k: torch.as_tensor(v, device=rt.device)
             for k, v in res["batch"].items()}
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "batch": B,
           "prompt_len": P, "gen": G,
           "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
           # the prompt's positions (a VLM's patches among them)
           "prefill_tok_s": B * P / res["prefill_s"],
           "decode_tok_s": B * (G - 1) / res["decode_s"],
           "launches": launches, "decode_graph": graph,
           "tokens": toks.tolist()}
    if positions is not None:
        out["positions"] = positions(rt, batch, args)

    # the same prefill with the kernels and with their plain versions
    params = rt.state["params"]
    got, want, free, read = logits_pair(params, cfg, batch, B, P, rt.device)
    out["logits_check"] = chk = {**logits_check(got, want), **read}
    check(chk["passed"], f"{name} prefill logits: {chk}")
    check(bool((torch.argmax(free, -1).cpu().numpy() == toks[:, 0]).all()),
          f"{name}: the runtime's first token is not the prefill logits' "
          f"argmax")
    del got, want, free
    out["captured_vs_eager"], eager_cache, first, pos = captured_vs_eager(
        rt, batch, G - 1)
    if rt.device.type == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        # warm: the timed run above includes first-call costs (cuBLAS
        # handles and heuristics, lazy module loading)
        cache = model.init_cache(cfg, B, P, rt.device)
        out["warm_prefill"] = profile_steps(
            lambda: model.prefill(params, cfg, batch, cache), 2)
        del cache
        rt.prefill(batch)                      # cache_len back to P
        out["warm_decode_step"] = profile_steps(rt.step, 3)
        # the same step eagerly, on the check's copy of the cache
        pos.fill_(P)
        out["warm_decode_step_eager"] = profile_steps(
            lambda: rt.decode_graph.fn(params, first, eager_cache, pos,
                                       None), 3)
    if extra is not None:
        out.update(extra(rt, batch, args, out))
    return out


def serve_dense_argv(device, smoke):
    """serve_dense's launcher flags (``serve_sharded`` runs the same
    job)."""
    argv = ["--arch", "deepseek_7b", "--batch", "4", "--prompt-len", "512",
            "--gen", "32", "--seed", "0", "--device", device]
    if smoke:
        argv = argv[:2] + ["--smoke", "--batch", "2", "--prompt-len", "24",
                           "--gen", "6", "--device", device]
    return argv


def eager_probe(rt, n: int = 2) -> dict:
    """A dense-plane block's decode step run eagerly (its step function on
    a copy of its cache, at its position): the host's time to enqueue it
    and its wall time to the device's end, over ``n`` warm steps; where
    the first is near the second, the host paces the eager step.  The
    probe's launches are not the main path's."""
    saved = counts()
    fn, params = rt.decode_graph.fn, rt.state["params"]
    cache, tok = _clone(rt.cache), rt.token.clone()
    pos = torch.full((), rt.cache_len, dtype=torch.int32, device=rt.device)
    fn(params, tok, cache, pos, None)
    rt._sync()
    enq, wall = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        fn(params, tok, cache, pos, None)
        t1 = time.perf_counter()
        rt._sync()
        enq.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
    set_counts(saved)
    return {"enqueue_ms": enq, "wall_ms": wall}


def phase_serve_dense(device="cuda", smoke=False):
    """deepseek_7b's dense data plane through the launcher's entry point
    (``dense_plane``; besides, ``eager_probe``'s host time of its eager
    decode step), and a sampling job's captured decode against its eager
    one on both planes at smoke size."""
    out = dense_plane(
        "serve_dense", serve_dense_argv(device, smoke), device,
        extra=lambda rt, batch, args, out: (
            {"host_probe_eager": eager_probe(rt)}
            if rt.device.type == "cuda" else {}))
    out["sampled_vs_eager"] = sampled_vs_eager(device)
    emit("serve_dense", **out)
    return out


def phase_serve_paged(device="cuda", smoke=False):
    """The paged data plane: 12 generate sessions through 8 slots
    (``paged_plane`` on deepseek_7b)."""
    job = _paged_job(smoke)
    out, tokens = paged_plane(
        "serve_paged", job, _paged_prompts(job.cfg, smoke),
        PAGED_NEW_TOKENS_SMOKE if smoke else PAGED_NEW_TOKENS, device)
    emit("serve_paged", **out)
    # each session's tokens, for the control phase (not printed)
    out["session_tokens"] = tokens
    return out


def logits_pair(cfg, run, then=None):
    """``run(impl)``'s logits with the kernels and with their plain
    versions, (kernels, plain, what was read), their launches restored
    out of the main path's counts.  A moe family's plain run's routing is
    recorded and replayed into the kernels' run (``RoutingTape``:
    near-tied experts swap in bf16), its drops read from the plain run;
    ``then(tape, plain)``, when given, runs last with the recording and
    adds its keys to what was read."""
    saved = counts()
    read = {}
    if cfg.family == "moe":
        with RoutingTape() as tape:
            want = run("torch")
            read["plain_dropped_by_layer"] = list(tape.dropped)
            tape.set("replay")
            got = run("auto")
            if then is not None:
                read.update(then(tape, want))
        read["routing"] = "the plain run's, replayed"
    else:
        want = run("torch")
        got = run("auto")
    set_counts(saved)
    return got, want, read


def paged_plane(name, job, prompts, max_new, device):
    """A paged serve ``BlockRuntime`` on ``job``: the prompts submitted at
    once through its slots, the decode rounds as graph replays, the
    launches exactly, the logits of two admission prefills (two prompt
    buckets, the second ending in a partial 64-row kv tile) and of the
    first decode round against ``impl="torch"`` (``logits_pair``),
    tokens/s and TTFT, then the same traffic with the rounds run eagerly
    from the same (empty) state: every session's tokens and the pool's
    bits equal; for a moe family, its drops over that traffic
    (``RoutingTape``'s tally).  Returns the phase's record and each session's
    tokens."""
    from repro_torch.models import model
    cfg = job.cfg
    rt = _block(job, device)
    rt.init_state()
    sch = rt.sessions
    n_sess, lens = len(prompts), [len(p) for p in prompts]

    # hold the first admission prefill, the first one of another prompt
    # bucket that ends in a partial 64-row kv tile, and the first decode
    # round against impl="torch" on the same inputs (the decode round on
    # copies of the pool); those launches are restored out of the main
    # path's counts
    admit, decode = sch._admit_prefill, sch._decode_step
    tap = {"rounds": 0, "admit_checks": [], "check": None}

    def tapped_admit(tokens, pages, last_idx):
        S = tokens.shape[1]
        done = tap["admit_checks"]
        if not done or (len(done) == 1 and S != done[0]["bucket"]
                        and S % 64):
            def run(impl):
                x = model.embed_inputs(sch.params, cfg, {"tokens": tokens})
                lg, _, _ = model.forward(
                    sch.params, cfg, x,
                    positions=torch.arange(S, device=x.device),
                    cache=model.init_cache(cfg, 1, S, x.device),
                    cache_len=0, impl=impl)
                return lg[0, last_idx][None]
            got, want, read = logits_pair(cfg, run)
            done.append({"bucket": S, **logits_check(got, want), **read})
        return admit(tokens, pages, last_idx)

    def tapped_decode(tokens, page_table, seq_lens):
        if tap["rounds"] == 0:
            def run(impl):
                lg, _ = model.decode_step_paged(
                    sch.params, cfg, tokens, _clone(sch.pool), page_table,
                    seq_lens, impl=impl)
                return lg
            got, want, read = logits_pair(cfg, run)
            live = seq_lens > 0
            tap["check"] = {"slots": int(live.sum()),
                            **logits_check(got[live], want[live]), **read}
        tap["rounds"] += 1
        return decode(tokens, page_table, seq_lens)

    sch._admit_prefill, sch._decode_step = tapped_admit, tapped_decode
    zero_counts()
    _zero_eager_calls()
    emissions, elapsed, ttft = _paged_traffic(rt, prompts, max_new)
    launches = counts()
    rounds = tap["rounds"]
    graph = graph_check(name, sch.decode_graph, rounds, _eager_calls(),
                        device)
    pre, _, per_round = dense_launches(cfg)
    if rt.device.type != "cuda":
        pre = per_round = {n: 0 for n in COUNTERS}
    check(launches == {n: sch.admissions * pre[n] + rounds * per_round[n]
                       for n in COUNTERS},
          f"{name} main path launches {launches}: not {sch.admissions} "
          f"admissions {pre} and {rounds} rounds {per_round}")
    want_tokens = {s.sid: list(s.generated) for s in sch.sessions.values()}
    want_pool = bit_checksums(sch.pool)
    finished = [e for e in emissions if e["event"] == "finished"]
    n_tokens = sum(1 for e in emissions if e["event"] == "token")
    check(len(finished) == n_sess and sch.finished == n_sess,
          f"{name}: {len(finished)} of {n_sess} sessions finished")
    check(n_tokens == n_sess * max_new,
          f"{name}: {n_tokens} tokens generated")
    for sess in sch.sessions.values():
        check(len(sess.generated) == max_new and all(
            0 <= t < cfg.vocab_size for t in sess.generated),
              f"{name}: session {sess.sid} tokens")
    chk, admits = tap["check"], tap["admit_checks"]
    check(chk is not None and chk["passed"],
          f"{name}: first paged decode round logits: {chk}")
    check(len(admits) == 2 and all(c["passed"] for c in admits),
          f"{name}: admission prefill logits: {admits}")
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "sessions": n_sess,
           "slots": job.max_slots, "prompt_lens": lens,
           "max_new_tokens": max_new,
           "n_pages": sch.n_pages, "decode_rounds": rounds,
           "admissions": sch.admissions, "evictions": sch.evictions,
           "elapsed_s": elapsed, "tokens": n_tokens,
           "tok_s": n_tokens / elapsed,
           "ttft_p50_s": float(np.percentile(ttft, 50)),
           "ttft_p99_s": float(np.percentile(ttft, 99)),
           "launches": launches, "decode_graph": graph,
           "logits_check": chk, "admission_logits_checks": admits}
    if rt.device.type == "cuda":
        out["pool_gb"] = tree_bytes(sch.pool) / 1e9
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["warm_decode_round"] = _warm_round(rt, prompts, max_new)

    # the same traffic from the same state (a fresh scheduler: an empty
    # pool) with the decode round run eagerly: every session's tokens and
    # the pool's bits equal; its seconds and tok/s are before capture
    saved = counts()
    del sch._admit_prefill, sch._decode_step     # the taps' cycle
    sch.decode_graph.release()
    rt.sessions = sch = None
    _free(device)
    rt.sessions = sch = rt._make_scheduler(rt.state["params"])
    sch.decode_graph.capture = False
    tally = None
    if cfg.family == "moe":
        # the eager rounds' routing, tapped: the drops of the live slots
        # and the idle ones, of the prompt's tokens and its page padding
        tally = RoutingTape()
        admit, decode = sch._admit_prefill, sch._decode_step

        def tally_admit(tokens, pages, last_idx):
            tally.set("tally", torch.arange(
                tokens.shape[1], device=tokens.device) <= last_idx,
                ("admission_prompt", "admission_pad"))
            return admit(tokens, pages, last_idx)

        def tally_decode(tokens, page_table, seq_lens):
            tally.set("tally", seq_lens > 0, ("decode_live", "decode_idle"))
            return decode(tokens, page_table, seq_lens)

        sch._admit_prefill, sch._decode_step = tally_admit, tally_decode
    with tally or contextlib.nullcontext():
        ems, eager_s, eager_ttft = _paged_traffic(rt, prompts, max_new)
    got_tokens = {s.sid: list(s.generated) for s in sch.sessions.values()}
    out["captured_vs_eager"] = {
        "rounds": sch.decode_graph.eager_calls,
        "tokens_equal": got_tokens == want_tokens,
        "pool_bitwise_equal": bit_checksums(sch.pool) == want_pool,
        "eager_s": eager_s, "captured_s": elapsed,
        "eager_tok_s": n_tokens / eager_s, "captured_tok_s": out["tok_s"],
        "eager_ttft_p50_s": float(np.percentile(eager_ttft, 50)),
        "card": _CARD}
    check(out["captured_vs_eager"]["tokens_equal"]
          and out["captured_vs_eager"]["pool_bitwise_equal"]
          and out["captured_vs_eager"]["rounds"] == rounds,
          f"{name}: paged rounds captured against eager from one state: "
          f"{out['captured_vs_eager']}")
    if tally is not None:
        del sch._admit_prefill, sch._decode_step
        out["capacity_drop"] = tally.tally_summary()
        for v in out["capacity_drop"].values():
            check(v["dropped_share"] is None
                  or 0.0 <= v["dropped_share"] <= 1.0,
                  f"{name}: drop shares {out['capacity_drop']}")
    if rt.device.type == "cuda":
        out["warm_decode_round_eager"] = _warm_round(rt, prompts, max_new)
    set_counts(saved)
    return out, want_tokens


def _paged_traffic(rt, prompts, max_new):
    """The prompts submitted at once and fed to the end: (emissions,
    seconds, each session's time to its first token)."""
    t0 = time.perf_counter()
    submit_t, first_t = {}, {}
    for p in prompts:
        sid = rt.start_session(p, max_new_tokens=max_new)
        submit_t[sid] = time.perf_counter()
    emissions = []
    while not rt.idle_serve:
        ems = rt.feed()
        now = time.perf_counter()          # feed() ends in a host sync
        for e in ems:
            if e["event"] == "token" and e["session"] not in first_t:
                first_t[e["session"]] = now
        emissions.extend(ems)
    elapsed = time.perf_counter() - t0
    return emissions, elapsed, np.asarray(
        [first_t[s] - submit_t[s] for s in submit_t])


def _warm_round(rt, prompts, max_new):
    """A warm decode round with all 8 slots busy (after their admission):
    the sessions outlast the admission's feed and ``profile_steps``' 7
    (at least 9 tokens each)."""
    for p in prompts[:8]:
        rt.start_session(p, max_new_tokens=max(max_new, 9))
    rt.feed()
    return profile_steps(rt.feed, 3)


def hybrid_launches(cfg):
    """The kernels' launches in one hybrid prefill and one decode step:
    a Mamba2 sublayer runs one SSD scan (prefill only) and two RMSNorms
    (its pre-norm and the gated norm), a shared attention block one flash
    attention (prefill only) and two RMSNorms, and the final norm one."""
    from repro_torch.models.transformer import n_groups
    ng, m = n_groups(cfg), cfg.hybrid.mamba_per_group
    norms = ng * (2 * m + 2) + 1
    zero = {n: 0 for n in COUNTERS}
    return ({**zero, "ssd_scan": ng * m, "flash_attention": ng,
             "rmsnorm": norms}, {**zero, "rmsnorm": norms})


def serve_hybrid_argv(device, smoke):
    """serve_hybrid's launcher flags (``blocks`` runs the same job)."""
    argv = ["--arch", "zamba2_2p7b", "--batch", "4", "--prompt-len", "1000",
            "--gen", "32", "--seed", "0", "--device", device]
    if smoke:
        argv = argv[:2] + ["--smoke", "--batch", "2", "--prompt-len", "24",
                           "--gen", "6", "--device", device]
    return argv


def phase_serve_hybrid(device="cuda", smoke=False):
    """The hybrid family (zamba2_2p7b) through the launcher's entry point
    on the dense plane, then each kernel's launches in one prefill and one
    decode step, and the logits of the prefill and of the first decode
    step (each from the state its own prefill left, so the kernel's final
    SSM state feeds the step) against ``impl="torch"``: the whole stack in
    fp32, and group by group in bf16 (see HYBRID_F32_RTOL)."""
    from repro_torch.launch import serve
    from repro_torch.models import model
    from repro_torch.models.transformer import flatten, unflatten
    args = serve.parse_args(serve_hybrid_argv(device, smoke))
    zero_counts()
    _zero_eager_calls()
    res = serve.run(args)
    launches = counts()
    rt, cfg = res["runtime"], res["cfg"]
    # the main path's peak, before the checks' fp32 copy of the weights
    peak = (torch.cuda.max_memory_allocated() / 1e9
            if rt.device.type == "cuda" else None)
    B, P, G = args.batch, args.prompt_len, args.gen
    graph = graph_check("serve_hybrid", rt.decode_graph, G - 1,
                        _eager_calls(), device)
    toks = res["tokens"]
    check(toks.shape == (B, G) and toks.min() >= 0
          and toks.max() < cfg.vocab_size, f"hybrid tokens {toks.shape}")

    # the checks' launches are not the main path's: counted apart, then
    # the main path's counts are put back
    params, tokens = rt.state["params"], torch.as_tensor(
        res["batch"]["tokens"], device=rt.device)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    params32 = unflatten((k, v.float()) for k, v in flatten(params))
    logits, per_call, first = {}, {}, None
    for dt_name, c, p in (("bf16", cfg, params), ("f32", cfg32, params32)):
        for impl in ("auto", "torch"):
            key = f"{dt_name}_{impl}"
            zero_counts()
            cache = model.init_cache(c, B, P + 1, rt.device)
            lg, _ = model.prefill(p, c, {"tokens": tokens}, cache, impl=impl)
            per_call[key] = counts()
            if first is None:
                # every decode check steps from the main path's first token
                first = torch.argmax(lg, -1)[:, None].to(torch.int32)
            zero_counts()
            step, _ = model.decode_step(p, c, first, cache, P, impl=impl)
            per_call[f"decode_{key}"] = counts()
            logits[key] = (lg.float(), step.float())
            del cache
    del params32
    # the kernels' bf16 prefill and first decode step, for hybrid_sharded
    digests = {"prefill": digest(logits["bf16_auto"][0]),
               "decode": digest(logits["bf16_auto"][1])}
    groups = hybrid_group_check(params, cfg, tokens, first)
    set_counts(launches)
    check(bool((first[:, 0].cpu().numpy() == toks[:, 0]).all()),
          "the runtime's first token is not the prefill logits' argmax")
    # fp32: checked; bf16 whole stack: its spread, read and not checked
    chk, chk_dec = ({"f32": logits_check(logits["f32_auto"][i],
                                         logits["f32_torch"][i],
                                         HYBRID_F32_RTOL),
                     "bf16_whole_stack": {
                         k: v for k, v in logits_check(
                             logits["bf16_auto"][i],
                             logits["bf16_torch"][i]).items()
                         if k not in ("tol", "passed")}}
                    for i in (0, 1))
    check(chk["f32"]["passed"], f"hybrid prefill logits: {chk}")
    check(chk_dec["f32"]["passed"],
          f"hybrid first decode step logits: {chk_dec}")
    worst = {step: max(r["err_over_range"] for r in groups[step])
             for step in ("prefill", "decode")}
    groups["limit"], groups["worst"] = HYBRID_GROUP_RTOL, worst
    check(all(r["finite"] for step in ("prefill", "decode")
              for r in groups[step])
          and max(worst.values()) <= HYBRID_GROUP_RTOL
          and groups["ssm_state_after_prefill"]["err_over_range"]
          <= HYBRID_GROUP_RTOL,
          f"hybrid bf16 groups, kernels against impl=\"torch\": {groups}")
    del logits

    want_pre, want_dec = hybrid_launches(cfg)
    if rt.device.type != "cuda":
        want_pre = want_dec = {n: 0 for n in COUNTERS}
    # the fp32 stack's SSD scans take the scalar route, its flash
    # attention the CUDA-core kernel
    want_f32 = dict(want_pre, ssd_scan_scalar=want_pre["ssd_scan"],
                    flash_attention_cuda_core=want_pre["flash_attention"])
    check(per_call["bf16_auto"] == want_pre
          and per_call["decode_bf16_auto"] == want_dec
          and per_call["f32_auto"] == want_f32
          and per_call["decode_f32_auto"] == want_dec
          and all(set(per_call[k].values()) == {0} for k in per_call
                  if k.endswith("torch")),
          f"hybrid launches per prefill and decode step {per_call} (want "
          f"{want_pre} ({want_f32} in fp32) and {want_dec} with the "
          f"kernels, none without)")
    check(launches == {n: want_pre[n] + (G - 1) * want_dec[n]
                       for n in COUNTERS},
          f"hybrid main path launches {launches}: not one prefill and "
          f"{G - 1} decode steps")
    vs_eager, eager_cache, first, pos = captured_vs_eager(
        rt, {"tokens": tokens}, G - 1)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "batch": B,
           "prompt_len": P, "gen": G,
           "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
           "prefill_tok_s": B * P / res["prefill_s"],
           "decode_tok_s": B * (G - 1) / res["decode_s"],
           "launches": launches, "decode_graph": graph,
           "captured_vs_eager": vs_eager,
           "launches_per_prefill": per_call["bf16_auto"],
           "launches_per_decode_step": per_call["decode_bf16_auto"],
           "logits_check": chk, "first_decode_logits_check": chk_dec,
           "bf16_group_check": groups, "tokens": toks.tolist(),
           "logits_digests": digests}
    if rt.device.type == "cuda":
        out["peak_mem_gb"] = peak
        cache = model.init_cache(cfg, B, P, rt.device)
        out["warm_prefill"] = profile_steps(
            lambda: model.prefill(params, cfg, {"tokens": tokens}, cache), 2)
        del cache
        # a fresh decode context, in the graph's own cache: the SSM states
        # restart from zeros and cache_len goes back to P
        restart(rt)
        rt.prefill({"tokens": tokens})
        out["warm_decode_step"] = profile_steps(rt.step, 3)
        pos.fill_(P)
        out["warm_decode_step_eager"] = profile_steps(
            lambda: rt.decode_graph.fn(params, first, eager_cache, pos,
                                       None), 3)
    emit("serve_hybrid", **out)
    return out


def phase_serve_vlm(device="cuda", smoke=False):
    """pixtral_12b (the VLM: mistral_nemo_12b's backbone behind the patch
    stub) through the launcher's entry point at full size
    (``dense_plane``), all 40 layers, random bf16 weights from seed 0: 4
    prompts of 2048 positions each (the stub's 256 image patches, then
    1792 text tokens), 32 tokens generated.  Held besides: the decode
    steps wrote the cache at positions n_patches + T onward (the
    reference's runtime starts them at T)."""
    argv = ["--arch", "pixtral_12b", "--batch", "4", "--prompt-len", "2048",
            "--gen", "32", "--seed", "0", "--device", device]
    if smoke:
        argv = ["--arch", "pixtral_12b", "--smoke", "--batch", "2",
                "--prompt-len", "32", "--gen", "6", "--device", device]

    def positions(rt, batch, args):
        """The prefill filled n_p + T = P cache rows; the G - 1 decode
        steps wrote rows P .. P + G - 2, and the cache's last row is
        empty."""
        P, G = args.prompt_len, args.gen
        n_p, T = batch["patches"].shape[1], batch["tokens"].shape[1]
        rows = rt.cache["k"].abs().amax(dim=(0, 1, 3, 4)) > 0
        got = {"n_patches": n_p, "text_tokens": T,
               "cache_len": rt.cache_len, "rows_written": int(rows.sum()),
               "cache_rows": P + G}
        check(n_p + T == P and rt.cache_len == P + G - 1
              and bool(rows[:P + G - 1].all()) and not bool(rows[P + G - 1]),
              f"vlm decode positions: {got}")
        return got

    out = dense_plane("serve_vlm", argv, device, positions)
    emit("serve_vlm", **out)
    return out


#: deepseek_v2_236b's layers in ``serve_moe``: 7 of 60 at full width
#: (7 x 7.95 GB of layers and 2.1 GB of embedding and LM head, 57.7 GB of
#: bf16 weights)
MOE_LAYERS = 7


def moe_reads(rt, batch, args, out):
    """``serve_moe``'s reads beside the main path (its launches restored
    afterwards): a prefill of the same batch and one decode step with
    every MoE layer's routing tapped, giving the share of (token, k)
    choices the capacity dropped in each (the reference's per-call
    capacity: C = 96 for 2048 prefill tokens, C = 1 for a decode step's 4),
    and the experts the decode step's tokens chose; the decode bound, the
    weights' bytes over the memory rate (the expert products read every
    expert, even at C = 1), beside the bytes of the chosen experts alone
    and beside the weights' bytes with only the looked-up rows of the
    embedding table;
    on the card, the decode step's idle share and the expert products'
    share of the warm prefill (three batched products of one layer timed
    alone, times the layers, over the prefill's device time).  The
    prefill's and the decode step's logits (``logits_digests``, their
    values the tap leaves as they are) are what ``moe_sharded`` holds its
    own to."""
    import torch.nn.functional as F
    from repro_torch.models import model, moe
    cfg, params = rt.job.cfg, rt.state["params"]
    m = cfg.moe
    saved = counts()
    taps = []
    route = moe.route

    def tap(xs, router, mcfg):
        r = route(xs, router, mcfg)
        taps.append((int((r[2] == mcfg.n_experts * r[4]).sum()),
                     r[2].numel(), r[4], torch.unique(r[1]).numel()))
        return r

    moe.route = tap
    try:
        B, P = batch["tokens"].shape
        cache = model.init_cache(cfg, B, P + 1, rt.device)
        logits, cache = model.prefill(params, cfg, batch, cache)
        pre, taps[:] = list(taps), []
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        step, _ = model.decode_step(params, cfg, tok, cache, P)
        dec = list(taps)
    finally:
        moe.route = route
    digests = {"prefill": digest(logits.float()),
               "decode": digest(step.float())}
    del cache, logits, step
    set_counts(saved)

    def drops(rows):
        n = sum(r[0] for r in rows)
        total = sum(r[1] for r in rows)
        return {"capacity": rows[0][2], "choices": total, "dropped": n,
                "dropped_share": n / total,
                "dropped_by_layer": [r[0] for r in rows]}

    # the MoE params: a group's own (deepseek_v2) or its moe sublayer's
    # (llama4's {dense, moe} groups)
    lp = params["layers"]["moe"]
    lp = lp if "router" in lp else lp["moe"]
    elem = lp["w_gate"].element_size()
    expert_bytes = 3 * cfg.d_model * m.d_ff_expert * elem
    weights = tree_bytes(params)
    # the embedding table but the B rows looked up
    embed = params["embed"]
    read = weights - tree_bytes(embed) + B * embed[0].numel() * elem
    chosen = [r[3] for r in dec]
    active = weights - expert_bytes * (len(dec) * m.n_experts
                                       - sum(chosen))
    res = {"logits_digests": digests,
           "capacity_drop": {"prefill": drops(pre), "decode": drops(dec)},
           "decode_bound": {
               "weights_gb": weights / 1e9,
               "bound_ms": weights / HBM_BYTES_PER_S * 1e3,
               "read_gb": read / 1e9,
               "embedding_rows_bound_ms": read / HBM_BYTES_PER_S * 1e3,
               "experts_chosen_by_layer": chosen,
               "chosen_experts_bound_ms": active / HBM_BYTES_PER_S * 1e3}}
    if rt.device.type == "cuda":
        res["decode_idle_share"] = out["warm_decode_step"]["idle_share"]
        E, C, d = m.n_experts, pre[0][2], cfg.d_model
        ebuf = _randn((E, C, d), _gen(6))
        wg, wu, wd = (lp[k][0] for k in ("w_gate", "w_up", "w_down"))

        def experts():
            h = F.silu(torch.bmm(ebuf, wg)) * torch.bmm(ebuf, wu)
            return torch.bmm(h, wd)

        ms = time_ms(experts, iters=10)
        res["expert_products"] = {
            "ms_per_layer": ms, "shape": [E, C, d, m.d_ff_expert],
            "prefill_share": ms * len(pre)
            / out["warm_prefill"]["device_ms"]}
        del ebuf
    return res


def _moe_serve_argv(device, smoke):
    """serve_moe's launcher flags and config (``moe_sharded`` runs the
    same job): deepseek_v2_236b cut to ``MOE_LAYERS``, or its smoke
    config."""
    import repro_torch.configs as configs
    arch = "deepseek_v2_236b"
    if smoke:
        return (["--arch", arch, "--smoke", "--batch", "2", "--prompt-len",
                 "24", "--gen", "6", "--device", device],
                configs.get_smoke(arch))
    return (["--arch", arch, "--batch", "4", "--prompt-len", "512", "--gen",
             "32", "--seed", "0", "--device", device],
            configs.get(arch).replace(n_layers=MOE_LAYERS))


def phase_serve_moe(device="cuda", smoke=False):
    """deepseek_v2_236b (the moe family with MLA attention: 2 shared and
    160 routed experts a layer, top-6) at full width, cut in depth to
    ``MOE_LAYERS`` of its 60 layers, random bf16 weights from seed 0,
    through the launcher's entry point (``dense_plane``, handed the cut
    config): 4 prompts of 512 tokens, 32 generated, the decode steps as
    graph replays (the absorbed decode's einsums and the routing
    captured), the launches exact (per layer 1 flash at head dim 192 and
    4 RMSNorms a prefill, 4 RMSNorms a decode step), the prefill logits
    against ``impl="torch"`` with the plain run's routing replayed, and
    with their own routing read beside it (``moe_prefill_pair``).
    Besides: ``moe_reads``."""
    import repro_torch.configs as configs
    arch = "deepseek_v2_236b"
    argv, cfg = _moe_serve_argv(device, smoke)
    full = configs.get_smoke(arch) if smoke else configs.get(arch)
    out = dense_plane("serve_moe", argv, device, cfg=cfg, extra=moe_reads,
                      logits_pair=moe_prefill_pair)
    a = cfg.attention
    out.update(d_model=cfg.d_model, n_heads=a.n_heads,
               qk_head_dim=a.head_dim + a.qk_rope_head_dim,
               v_head_dim=a.v_dim, kv_lora_rank=a.kv_lora_rank,
               n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
               n_shared=cfg.moe.n_shared,
               reduced={"n_layers": [full.n_layers, cfg.n_layers]})
    emit("serve_moe", **out)
    return out


#: llama4_maverick_400b's layers in ``serve_llama4`` and
#: ``serve_llama4_paged``: one group of its 48, a dense layer and a MoE
#: layer of 128 experts (18.57e9 params, 37.1 GB of bf16 weights with the
#: untied embedding and head)
LLAMA4_LAYERS = 2


def _llama4(smoke):
    """llama4_maverick_400b's config and its cut (the smoke config
    whole)."""
    import repro_torch.configs as configs
    arch = "llama4_maverick_400b"
    if smoke:
        return configs.get_smoke(arch), configs.get_smoke(arch)
    full = configs.get(arch)
    return full, full.replace(n_layers=LLAMA4_LAYERS)


def paged_gc(G: int) -> int:
    """The paged kernel's query heads a block for a group of G: the largest
    divisor of G at most 8 (``csrc/paged_attention.cu``'s dispatch)."""
    return max(c for c in range(1, 9) if G % c == 0)


def _gqa(cfg) -> dict:
    """A GQA config's heads, group and the paged kernel's GC."""
    a = cfg.attention
    G = a.n_heads // a.n_kv_heads
    return {"n_heads": a.n_heads, "n_kv_heads": a.n_kv_heads, "group": G,
            "paged_gc": paged_gc(G)}


def phase_serve_llama4(device="cuda", smoke=False):
    """llama4_maverick_400b (the moe family with GQA 40 / 8: dense and MoE
    layers alternating, 128 routed experts top-1 and a shared one) at full
    width, cut in depth to ``LLAMA4_LAYERS`` of its 48 layers (one group),
    random bf16 weights from seed 0, through the launcher's entry point
    (``dense_plane`` handed the cut config): 4 prompts of 512 tokens, 32
    generated, the decode steps as graph replays, the launches exact (per
    layer 1 flash and 2 RMSNorms a prefill, 2 RMSNorms a decode step), the
    prefill logits against ``impl="torch"`` with the plain run's routing
    replayed (``moe_prefill_pair``).  Besides: ``moe_reads`` (C = 20 for
    the prefill's 2048 tokens, C = 1 for a decode step's 4)."""
    full, cfg = _llama4(smoke)
    argv = ["--arch", full.name.replace("_smoke", ""), "--batch", "4",
            "--prompt-len", "512", "--gen", "32", "--seed", "0", "--device",
            device]
    if smoke:
        argv = argv[:2] + ["--smoke", "--batch", "2", "--prompt-len", "24",
                           "--gen", "6", "--device", device]
    out = dense_plane("serve_llama4", argv, device, cfg=cfg, extra=moe_reads,
                      logits_pair=moe_prefill_pair)
    out.update(d_model=cfg.d_model, **_gqa(cfg), d_ff=cfg.d_ff,
               n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
               n_shared=cfg.moe.n_shared, d_ff_expert=cfg.moe.d_ff_expert,
               reduced={"n_layers": [full.n_layers, cfg.n_layers]})
    emit("serve_llama4", **out)
    return out


def phase_serve_llama4_paged(device="cuda", smoke=False):
    """serve_llama4's cut on the paged plane (``paged_plane``): serve_paged's
    traffic, 12 sessions of 17 to 700 prompt tokens through 8 slots, 32
    tokens each, the rounds captured over the nested {dense, moe} pool;
    the admission and first-round logits held with the plain run's routing
    replayed; the eager replay's tokens and pool bit for bit; the paged
    kernel at the group of 5 (GC = 5) on its split route (no scalar-route
    launch); the choices the capacity dropped (at C = 1 a round's idle
    slots take capacity, and an admission's page padding, as in the
    reference); the warm round's replay against its bound (the weights'
    bytes but the embedding table's over the memory rate)."""
    from repro_torch.models import model
    full, cfg = _llama4(smoke)
    job = _paged_job(smoke, cfg=cfg)
    out, _ = paged_plane(
        "serve_llama4_paged", job, _paged_prompts(cfg, smoke),
        PAGED_NEW_TOKENS_SMOKE if smoke else PAGED_NEW_TOKENS, device)
    weights = model.abstract_params(cfg)
    read = tree_bytes(weights) - tree_bytes(weights["embed"])
    out.update(**_gqa(cfg), n_experts=cfg.moe.n_experts,
               top_k=cfg.moe.top_k,
               reduced={"n_layers": [full.n_layers, cfg.n_layers]},
               round_bound={"read_gb": read / 1e9,
                            "bound_ms": read / HBM_BYTES_PER_S * 1e3})
    if "warm_decode_round" in out:
        out["round_bound"]["replay_over_bound"] = (
            out["warm_decode_round"]["wall_ms"]
            / out["round_bound"]["bound_ms"])
    emit("serve_llama4_paged", **out)
    return out


#: the dense configs ``serve_dense_groups`` serves whole, each on both
#: planes, and each paged session's new tokens (the second at smoke size)
DENSE_GROUP_ARCHS = ("starcoder2_15b", "yi_34b")
DENSE_GROUP_NEW_TOKENS, DENSE_GROUP_NEW_TOKENS_SMOKE = 8, 4


def phase_serve_dense_groups(device="cuda", smoke=False):
    """starcoder2_15b (LayerNorm and a non-gated GELU MLP, plain PyTorch as
    in the reference: no RMSNorm launch; GQA 48 / 4) and yi_34b (GQA
    56 / 8; 68.8 GB of bf16 weights, the largest dense model one card
    holds whole) at full size, random bf16 weights from seed 0, each on
    the dense plane through the launcher (``dense_plane``: 4 x 512 prompt
    tokens, 16 generated) and then on the paged plane (``paged_plane``:
    serve_paged's 12 prompts through 8 slots, ``DENSE_GROUP_NEW_TOKENS``
    each), each block freed before the next is built.  The flash kernel
    runs their groups of 12 and 7, the paged kernel G = 12 as two blocks
    of 6 heads a kv head and G = 7 as one."""
    import repro_torch.configs as configs
    from repro_torch.models import model
    out = {}
    for arch in DENSE_GROUP_ARCHS:
        cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
        progress(f"serve_dense_groups: {arch}, dense plane")
        argv = ["--arch", arch, "--batch", "4", "--prompt-len", "512",
                "--gen", "16", "--seed", "0", "--device", device]
        if smoke:
            argv = argv[:2] + ["--smoke", "--batch", "2", "--prompt-len",
                               "24", "--gen", "6", "--device", device]
        dense = dense_plane(f"serve_dense_groups {arch}", argv, device)
        _free(device)
        progress(f"serve_dense_groups: {arch}, paged plane")
        paged, _ = paged_plane(
            f"serve_dense_groups {arch} paged", _paged_job(smoke, cfg=cfg),
            _paged_prompts(cfg, smoke),
            DENSE_GROUP_NEW_TOKENS_SMOKE if smoke
            else DENSE_GROUP_NEW_TOKENS, device)
        _free(device)
        out[arch] = {"norm": cfg.norm, "mlp_gated": cfg.mlp_gated,
                     **_gqa(cfg), "params": model.count_params(
                         model.abstract_params(cfg)),
                     "dense": dense, "paged": paged}
    emit("serve_dense_groups", **out)
    return out


def xlstm_launches(cfg):
    """The kernels' launches in one xlstm prefill and one decode step: a
    group's k-1 mLSTM sublayers and its sLSTM run two RMSNorms each (the
    pre-norm and the block's out_norm), the final norm one; each group's
    sLSTM one ``slstm_scan`` (its recurrence over the prompt, or the one
    step).  The mLSTM scan is plain PyTorch: the reference has no TPU
    kernel for it."""
    from repro_torch.models.transformer import n_groups
    norms = n_groups(cfg) * 2 * cfg.xlstm.slstm_every + 1
    each = {**{n: 0 for n in COUNTERS}, "rmsnorm": norms,
            "slstm_scan": n_groups(cfg)}
    return each, dict(each)


@contextlib.contextmanager
def slstm_stacking(dtype):
    """``ssm.SLSTM_STACK_DTYPE`` (bf16, the reference's rounding of each
    sLSTM step's h) set to ``dtype`` inside the block.  In a bf16 model
    it changes nothing; in an fp32 one float32 takes the rounding out, so
    an fp32 comparison reads the kernels' differences and not the
    one-bf16-step ones their last bits turn into at the rounding
    (``tests/test_torch_xlstm.py``)."""
    from repro_torch.models import ssm
    saved = ssm.SLSTM_STACK_DTYPE
    ssm.SLSTM_STACK_DTYPE = dtype
    try:
        yield
    finally:
        ssm.SLSTM_STACK_DTYPE = saved


def slstm_share(fn) -> dict:
    """One call of ``fn`` (a prefill) timed between device syncs, and the
    part of it spent in ``ssm.slstm_fwd`` (each sLSTM block: its input
    projection, the step-by-step recurrence, its norm and feed-forward),
    every call of it timed between device syncs."""
    from repro_torch.models import ssm
    spans, orig = [], ssm.slstm_fwd

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        torch.cuda.synchronize()
        spans.append(time.perf_counter() - t0)
        return out

    ssm.slstm_fwd = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ssm.slstm_fwd = orig
    return {"wall_ms": wall * 1e3, "slstm_ms": sum(spans) * 1e3,
            "slstm_calls": len(spans), "slstm_share": sum(spans) / wall,
            "card": _CARD}


def serve_xlstm_argv(device, smoke):
    """serve_xlstm's launcher flags (``xlstm_sharded`` runs the same
    job)."""
    argv = ["--arch", "xlstm_350m", "--batch", "4", "--prompt-len", "2048",
            "--gen", "32", "--seed", "0", "--device", device]
    if smoke:
        argv = argv[:2] + ["--smoke", "--batch", "2", "--prompt-len", "24",
                           "--gen", "6", "--device", device]
    return argv


def phase_serve_xlstm(device="cuda", smoke=False):
    """The xlstm family (xlstm_350m: 24 layers, 3 groups of 7 mLSTM and 1
    sLSTM) through the launcher's entry point on the dense plane at full
    size, random bf16 weights from seed 0: 4 x 2048 prompt tokens, 32
    generated, greedy; the decode steps as graph replays held against
    eager ones (``captured_vs_eager``); each kernel's launches in one
    prefill and one decode step, exactly; the logits of the prefill and
    of the first decode step (each from the state its own prefill left)
    against ``impl="torch"``: in fp32 (the weights upcast) the whole
    stack within XLSTM_F32_RTOL of their range with the sLSTM's bf16
    stacking taken out of both runs (``slstm_stacking``) and read with it
    kept; in bf16 sublayer by sublayer (``xlstm_sublayer_check``) within
    HYBRID_GROUP_RTOL, the whole stack read (see XLSTM_F32_RTOL); the
    sLSTM blocks' share of a warm prefill (``slstm_share``)."""
    from repro_torch.launch import serve
    from repro_torch.models import model
    from repro_torch.models.transformer import flatten, unflatten
    args = serve.parse_args(serve_xlstm_argv(device, smoke))
    zero_counts()
    _zero_eager_calls()
    res = serve.run(args)
    launches = counts()
    rt, cfg = res["runtime"], res["cfg"]
    peak = (torch.cuda.max_memory_allocated() / 1e9
            if rt.device.type == "cuda" else None)
    B, P, G = args.batch, args.prompt_len, args.gen
    graph = graph_check("serve_xlstm", rt.decode_graph, G - 1,
                        _eager_calls(), device)
    toks = res["tokens"]
    check(toks.shape == (B, G) and toks.min() >= 0
          and toks.max() < cfg.vocab_size, f"xlstm tokens {toks.shape}")
    progress("serve_xlstm: logits against impl=\"torch\"")

    # the checks' launches are not the main path's: counted apart, then
    # the main path's counts are put back
    params, tokens = rt.state["params"], torch.as_tensor(
        res["batch"]["tokens"], device=rt.device)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    params32 = unflatten((k, v.float()) for k, v in flatten(params))
    logits, per_call, first = {}, {}, None
    for name, c, p, stack in (
            ("bf16", cfg, params, torch.bfloat16),
            ("f32", cfg32, params32, torch.float32),
            ("f32_bf16_stacking", cfg32, params32, torch.bfloat16)):
        for impl in ("auto", "torch"):
            key = f"{name}_{impl}"
            zero_counts()
            cache = model.init_cache(c, B, P + 1, rt.device)
            with slstm_stacking(stack):
                lg, _ = model.prefill(p, c, {"tokens": tokens}, cache,
                                      impl=impl)
                per_call[key] = counts()
                if first is None:
                    # every decode check steps from the main path's first
                    # token
                    first = torch.argmax(lg, -1)[:, None].to(torch.int32)
                zero_counts()
                step, _ = model.decode_step(p, c, first, cache, P,
                                            impl=impl)
            per_call[f"decode_{key}"] = counts()
            logits[key] = (lg.float(), step.float())
            del cache
    del params32
    # the main path's own logits (bf16, the kernels), for xlstm_sharded
    digests = {"prefill": digest(logits["bf16_auto"][0]),
               "decode": digest(logits["bf16_auto"][1])}
    subs = xlstm_sublayer_check(params, cfg, tokens, first)
    set_counts(launches)
    check(bool((first[:, 0].cpu().numpy() == toks[:, 0]).all()),
          "the runtime's first token is not the prefill logits' argmax")

    def read(got, want):
        return {k: v for k, v in logits_check(got, want).items()
                if k not in ("tol", "passed")}

    # fp32 (no bf16 stacking): checked; the rest read
    chk, chk_dec = ({"f32": logits_check(logits["f32_auto"][i],
                                         logits["f32_torch"][i],
                                         XLSTM_F32_RTOL),
                     "f32_bf16_stacking": read(
                         logits["f32_bf16_stacking_auto"][i],
                         logits["f32_bf16_stacking_torch"][i]),
                     "bf16_whole_stack": read(logits["bf16_auto"][i],
                                              logits["bf16_torch"][i]),
                     "bf16_kernels_vs_f32": read(logits["bf16_auto"][i],
                                                 logits["f32_torch"][i]),
                     "bf16_plain_vs_f32": read(logits["bf16_torch"][i],
                                               logits["f32_torch"][i])}
                    for i in (0, 1))
    for what, c in (("prefill", chk), ("first decode step", chk_dec)):
        check(c["f32"]["passed"], f"xlstm {what} logits: {c}")
    worst = {step: max(r["err_over_range"] for r in subs[step])
             for step in ("prefill", "decode")}
    subs["limit"], subs["worst"] = HYBRID_GROUP_RTOL, worst
    states = [k for k, _ in GROUP_STATES["xlstm"]]
    check(all(r["finite"] for step in ("prefill", "decode")
              for r in subs[step])
          and max(worst.values()) <= HYBRID_GROUP_RTOL
          and all(subs[k]["err_over_range"] <= HYBRID_GROUP_RTOL
                  for k in states),
          f"xlstm bf16 sublayers, kernels against impl=\"torch\": {subs}")
    del logits

    want_pre, want_dec = xlstm_launches(cfg)
    if rt.device.type != "cuda":
        want_pre = want_dec = {n: 0 for n in COUNTERS}
    check(all(per_call[k] == want_pre for k in per_call
              if k.endswith("auto") and not k.startswith("decode"))
          and all(per_call[k] == want_dec for k in per_call
                  if k.endswith("auto") and k.startswith("decode"))
          and all(set(per_call[k].values()) == {0} for k in per_call
                  if k.endswith("torch")),
          f"xlstm launches per prefill and decode step {per_call} (want "
          f"{want_pre} and {want_dec} with the kernels, none without)")
    check(launches == {n: want_pre[n] + (G - 1) * want_dec[n]
                       for n in COUNTERS},
          f"xlstm main path launches {launches}: not one prefill and "
          f"{G - 1} decode steps")
    vs_eager, eager_cache, first, pos = captured_vs_eager(
        rt, {"tokens": tokens}, G - 1)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "batch": B,
           "prompt_len": P, "gen": G,
           "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
           "prefill_tok_s": B * P / res["prefill_s"],
           "decode_tok_s": B * (G - 1) / res["decode_s"],
           "launches": launches, "decode_graph": graph,
           "captured_vs_eager": vs_eager,
           "launches_per_prefill": per_call["bf16_auto"],
           "launches_per_decode_step": per_call["decode_bf16_auto"],
           "logits_check": chk, "first_decode_logits_check": chk_dec,
           "bf16_sublayer_check": subs, "tokens": toks.tolist(),
           "logits_digests": digests}
    if rt.device.type == "cuda":
        out["peak_mem_gb"] = peak
        progress("serve_xlstm: warm prefill and decode profiles")
        cache = model.init_cache(cfg, B, P, rt.device)
        out["warm_prefill"] = profile_steps(
            lambda: model.prefill(params, cfg, {"tokens": tokens}, cache), 1)
        out["prefill_slstm_share"] = slstm_share(
            lambda: model.prefill(params, cfg, {"tokens": tokens}, cache))
        del cache
        # a fresh decode context, in the graph's own cache (the states
        # back to their initial values) and cache_len back to P
        restart(rt)
        rt.prefill({"tokens": tokens})
        out["warm_decode_step"] = profile_steps(rt.step, 3)
        pos.fill_(P)
        out["warm_decode_step_eager"] = profile_steps(
            lambda: rt.decode_graph.fn(params, first, eager_cache, pos,
                                       None), 3)
    emit("serve_xlstm", **out)
    return out


def leaf_grad_norms(grads):
    """The grad norm of every leaf in fp32, per layer for the stacked
    ``layers/`` leaves (one slice at a time: a whole full-width leaf in
    fp32 would not fit beside the model)."""
    from repro_torch.models.transformer import flatten
    out = {}
    for path, g in flatten(grads):
        if path.startswith("layers/"):
            for i in range(g.shape[0]):
                out[f"{path}[{i}]"] = float(torch.linalg.vector_norm(
                    g[i].float()))
        else:
            out[path] = float(torch.linalg.vector_norm(g.float()))
    return out


# step-0 limits, 17x or more above the relative errors read on the H100
# (PERF.md: loss 2.3e-5, grad norm 7.5e-5 to 1.6e-4, worst leaf 1.2e-3)
STEP0_RTOL = {"loss": 1e-3, "grad_norm": 5e-3, "worst_leaf_grad_norm": 2e-2}


def step0_reads(params, cfg, batch, impl):
    """Step 0's loss, grad norm and every leaf's grad norm (per layer for
    the stacked leaves), no update."""
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as train_lib
    loss, grads = train_lib.value_and_grad(params, cfg, batch, impl=impl)
    return (float(loss), float(opt_lib.global_norm(grads)),
            leaf_grad_norms(grads))


def step0_distance(got, want, ref="torch"):
    """How far one step-0 read (``step0_reads``) lies from another, named
    ``ref``: the loss, the grad norm, the leaf whose grad norm lies
    farthest and the root mean square over the leaves, each relative to
    ``want``'s."""
    (la, ga, na), (lt, gt, nt) = got, want
    leaf_err = {k: abs(na[k] - nt[k]) / max(abs(nt[k]), 1e-30) for k in nt}
    worst = max(leaf_err, key=leaf_err.get)
    rms = float(np.sqrt(np.mean(np.square(list(leaf_err.values())))))
    return {"loss": la, f"loss_{ref}": lt, "grad_norm": ga,
            f"grad_norm_{ref}": gt, "loss_rel_err": abs(la - lt) / abs(lt),
            "grad_norm_rel_err": abs(ga - gt) / abs(gt),
            "worst_leaf": worst, "worst_leaf_grad_norm": na[worst],
            f"worst_leaf_grad_norm_{ref}": nt[worst],
            "worst_leaf_grad_norm_rel_err": leaf_err[worst],
            "leaf_rms_rel_err": rms, "leaves": len(nt), "finite": bool(np.isfinite(
                [la, lt, ga, gt, *na.values(), *nt.values()]).all())}


def held_within(chk, rtol, what):
    """``chk`` (``step0_distance``) held under ``rtol``, a limit for each
    of its three distances."""
    chk["rtol"] = rtol
    chk["within_rtol"] = all(chk[f"{k}_rel_err"] <= r
                             for k, r in rtol.items())
    check(chk["finite"] and chk["within_rtol"], f"{what}: {chk}")
    return chk


def step0_check(params, cfg, batch):
    """Step 0 with the kernels against the same params and batch with
    ``impl="torch"``.  Both paths round every layer's activations and
    gradients to bf16, and a kernel and its plain version may land a
    value on neighbouring bf16 steps; the limits (``STEP0_RTOL``) leave
    room for that, read from the card.  The kernels themselves are held
    element by element in the kernels phase."""
    got, want = (step0_reads(params, cfg, batch, impl)
                 for impl in ("auto", "torch"))
    return held_within(step0_distance(got, want), STEP0_RTOL,
                       "step-0 check")


# the kernels' bf16 step 0 (hybrid, encoder) may lie this many times as far
# from the fp32 one as the plain bf16 step 0 does (or within STEP0_RTOL of
# it); read on the H100, the kernels' distances were 0.42-1.04 times the
# plain's for the hybrid, 0.13-1.06 for the encoder (PERF.md §6)
BF16_STEP0_MARGIN = 1.25


def step0_upcast_check(params, cfg, batch, hold_bf16=True,
                       consume=False):
    """The hybrid's step 0 with the weights upcast to fp32, every kernel on
    its fp32 instantiation and TF32 off, against ``impl="torch"`` on the
    same weights: held under STEP0_RTOL.  The random-weight bf16 stack
    moves its step 0 farther than STEP0_RTOL from ``impl="torch"``'s in
    bf16, so the bf16 step 0 is held against the fp32 one instead: the
    kernels' loss, grad norm, worst leaf and leaves' root mean square may
    lie no farther from it than the plain version's bf16 step 0 does,
    times BF16_STEP0_MARGIN, or within STEP0_RTOL (the worst leaf's for
    the mean).  Single leaves scatter too widely to hold one by one (a
    leaf's two bf16 distances read 0.4-13 times each other); those past
    STEP0_RTOL are recorded with both distances.  ``hold_bf16=False``
    reads the bf16 step 0 against its limit and does not hold it (the
    xlstm's: ``xlstm_step0_check``).  ``consume=True`` reads the bf16
    step 0 first, then upcasts ``params`` in place, leaf by leaf, so the
    bf16 and the fp32 weights never lie on the card together (pixtral's
    20-layer cut: 13.6 GB beside 27.2 GB of fp32 weights and 27.2 of
    their grads); the caller's params are fp32 after it."""
    from repro_torch.models.transformer import flatten, unflatten

    def bf16_reads():
        return {impl: step0_reads(params, cfg, batch, impl)
                for impl in ("auto", "torch")}

    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    if consume:
        bf16 = bf16_reads()
        for _, v in flatten(params):
            v.data = v.data.float()
        params32 = params
    else:
        params32 = unflatten((k, v.detach().float().requires_grad_(True))
                             for k, v in flatten(params))
    f32 = {impl: step0_reads(params32, cfg32, batch, impl)
           for impl in ("auto", "torch")}
    del params32
    if not consume:
        bf16 = bf16_reads()
    plain = step0_distance(bf16["torch"], f32["torch"], "f32")
    rtol = dict(STEP0_RTOL, leaf_rms=STEP0_RTOL["worst_leaf_grad_norm"])
    limit = {k: max(r, BF16_STEP0_MARGIN * plain[f"{k}_rel_err"])
             for k, r in rtol.items()}
    kernels = step0_distance(bf16["auto"], f32["torch"], "f32")
    far = {}
    for leaf, want in f32["torch"][2].items():
        d = [abs(bf16[impl][2][leaf] - want) / max(abs(want), 1e-30)
             for impl in ("auto", "torch")]
        if max(d) > rtol["leaf_rms"]:
            far[leaf] = {"kernels": d[0], "plain": d[1]}
    kernels["leaves_past_rtol"] = far
    if hold_bf16:
        kernels = held_within(
            kernels, limit, f"bf16 step 0 against the fp32 one (the plain "
            f"bf16 step 0's distance from it: {plain})")
    else:
        kernels["limit_read"] = limit
        kernels["within_limit_read"] = all(
            kernels[f"{k}_rel_err"] <= r for k, r in limit.items())
    return {"f32": held_within(step0_distance(f32["auto"], f32["torch"]),
                               STEP0_RTOL, "step-0 check, fp32"),
            "bf16": step0_distance(bf16["auto"], bf16["torch"]),
            "bf16_plain_vs_f32": plain, "bf16_vs_f32": kernels}


def train_launches(cfg, shape, opt_cfg, params):
    """The kernels' launches in one train step: each microbatch runs every
    group's kernels forward, again in the group's recompute (remat) and
    once backward (the final norm is outside the groups); a dense group
    is one layer (attention and 2 norms), a hybrid group m Mamba2 layers
    (an SSD scan and 2 norms each) and the shared block (attention and 2
    norms), a moe group one attention sublayer (deepseek_v2's [attn +
    moe]) or two (llama4's dense and moe halves), each with 2 norms and,
    with MLA, its q_norm and kv_norm, an xlstm group k-1 mLSTM layers and
    an sLSTM (2 norms each, no attention: the pre-norm and the block's
    out_norm; the sLSTM's recurrence an ``slstm_scan`` forward and an
    ``slstm_scan_bwd``); one AdamW launch a leaf, int8 or fp32 as the
    moments, on
    its scalar route for a leaf whose last dim is no multiple of 16 (the
    vector route's 16-element loads: hubert_xlarge's LM head, 504 wide;
    xlstm_350m's ``w_if``, 8 wide, and its sLSTM's ``w_ff_gate`` and
    ``w_ff_up``, 1365); no other scalar-route launch, and none on the
    flash kernels' CUDA-core routes."""
    from repro_torch.models.transformer import flatten, n_groups
    ng, fwd = n_groups(cfg), 2 if cfg.remat != "none" else 1
    m = cfg.hybrid.mamba_per_group if cfg.family == "hybrid" else 0
    xl = cfg.xlstm.slstm_every if cfg.family == "xlstm" else 0
    attn = (0 if cfg.attention is None
            else 2 if cfg.family == "moe" and cfg.d_ff > 0 else 1)
    attn_norms = 4 if attn and cfg.attention.is_mla else 2
    # LayerNorm (the encoder's) is plain PyTorch: no RMSNorm launch
    norms = (ng * (2 * m + attn * attn_norms + 2 * xl) + 1
             if cfg.norm == "rms" else 0)
    mb = max(1, shape.microbatch)
    adamw = "fused_adamw_i8" if opt_cfg.state_bits == 8 else \
        "fused_adamw_f32"
    return {**{n: 0 for n in COUNTERS},
            "ssd_scan": mb * fwd * ng * m, "ssd_scan_bwd": mb * ng * m,
            "slstm_scan": mb * fwd * ng * (xl > 0),
            "slstm_scan_bwd": mb * ng * (xl > 0),
            "flash_attention": mb * fwd * ng * attn,
            "flash_attention_bwd": mb * ng * attn,
            "rmsnorm": mb * (fwd * (norms - 1) + 1) if norms else 0,
            "rmsnorm_bwd": mb * norms,
            adamw: len(flatten(params)),
            "fused_adamw_scalar": sum(1 for _, p in flatten(params)
                                      if p.ndim == 0 or p.shape[-1] % 16)}


def host_probe(rt, n: int = 2) -> dict:
    """A block's host time to enqueue a step (``step_async`` until it
    returns) and the step's wall time to the device's end, over ``n``
    warm steps: where the first is near the second, the host paces the
    step.  A train step's loss and grad norm, read after its wall
    time."""
    rt._sync()
    out = {"enqueue_ms": [], "wall_ms": []}
    for _ in range(n):
        t0 = time.perf_counter()
        m = rt.step_async()
        t1 = time.perf_counter()
        rt._sync()
        out["enqueue_ms"].append((t1 - t0) * 1e3)
        out["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        if "loss" in m:                 # a train step's metrics
            out.setdefault("losses", []).append(float(m["loss"]))
            out.setdefault("grad_norms", []).append(float(m["grad_norm"]))
    return out


def _train_phase(name, cfg, shape, opt_cfg, device, n_steps, profile,
                 step0=step0_check, after=None, ckpt_root=None,
                 profile_n: int = 1):
    """A train block through ``BlockRuntime``: the step-0 check
    (``step0``; None for none), then ``n_steps`` steps counted as the
    main path, their launches per step held exactly (``train_launches``;
    none on the CPU).  ``after(rt, out)``, when given, runs next and
    returns the runtime the profile steps on.  ``profile``: a profiled
    warm step after them (True), the last of them run under the
    profiler (``"last"``: for a step whose extra runs the script cannot
    spend; the steady time and tok/s then come from the steps before
    it), or none."""
    progress(f"{name}: init")
    from repro_torch.core.block import BlockGrant
    from repro_torch.core.runtime import BlockRuntime, JobSpec
    job = JobSpec(cfg, shape, kind="train", opt=opt_cfg, seed=0,
                  ckpt_namespace=name)
    rt = BlockRuntime(BlockGrant.new([(0, 0, 0)], (1, 1), 3600.0), job,
                      devices=[device], ckpt_root=ckpt_root)
    t0 = time.perf_counter()
    rt.init_state()
    rt._sync()
    init_s = time.perf_counter() - t0
    progress(f"{name}: step-0 check")
    chk = (step0(rt.state["params"], cfg, rt.data.batch(0))
           if step0 is not None else None)
    progress(f"{name}: {n_steps} steps")
    if rt.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    hist, prof = [], None
    in_run = profile == "last" and rt.device.type == "cuda"
    t0 = time.perf_counter()
    for i in range(n_steps):
        if in_run and i == n_steps - 1:
            with device_profile() as prof:
                hist.append(rt.step())
        else:
            hist.append(rt.step())
    elapsed = time.perf_counter() - t0
    launches = counts()
    losses = [h["loss"] for h in hist]
    check(all(np.isfinite(losses)) and all(np.isfinite(
        [h["grad_norm"] for h in hist])), f"{name}: losses {losses}")
    tokens = shape.global_batch * shape.seq_len
    timed = hist[:-1] if in_run else hist
    if in_run:
        elapsed -= hist[-1]["step_s"]
    steady = [h["step_s"] for h in timed[1:]] or [timed[0]["step_s"]]
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "state_bits": opt_cfg.state_bits, "seq_len": shape.seq_len,
           "global_batch": shape.global_batch,
           "microbatch": shape.microbatch, "steps": n_steps,
           "init_s": init_s, "step0_check": chk, "losses": losses,
           "grad_norms": [h["grad_norm"] for h in hist],
           "step_s": [h["step_s"] for h in hist],
           "tok_s": len(timed) * tokens / elapsed,
           "steady_tok_s": tokens / float(np.median(steady)),
           "steady_step_s": float(np.median(steady)),
           "launches": launches,
           "launches_per_step": {k: c / n_steps for k, c in launches.items()}}
    want = (train_launches(cfg, shape, opt_cfg, rt.state["params"])
            if rt.device.type == "cuda" else {n: 0 for n in COUNTERS})
    out["launches_per_step_expected"] = want
    check(out["launches_per_step"] == want,
          f"{name} launches per step {out['launches_per_step']}, want "
          f"{want}")
    if rt.device.type == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if after is not None:
        rt = after(rt, out)
    if rt.device.type == "cuda":
        from repro_torch.launch import hlo_analysis
        # model FLOPs (the Monitor's analytic roofline) over the steady
        # step time, on the H100's bf16 peak
        out["model_flops"] = hlo_analysis.model_step_flops(cfg, shape)
        out["mfu"] = (out["model_flops"] / out["steady_step_s"]
                      / hlo_analysis.PEAK_FLOPS)
        if in_run:
            out["warm_step"] = profile_summary(
                prof, out["steady_step_s"] * 1e3)
            out["warm_step"]["profiled_step_wall_ms"] = \
                hist[-1]["step_s"] * 1e3
        elif profile:
            out["warm_step"] = profile_steps(rt.step, profile_n)
    emit(name, **out)
    return out


def phase_train_encoder(device="cuda", smoke=False):
    """hubert_xlarge (the encoder: LayerNorm, a plain GELU MLP,
    bidirectional MHA at head dim 80, the frame stub and the masked-frame
    loss) at full size, all 48 layers, random bf16 weights from seed 0,
    fp32 AdamW moments, 8 x 1024 frames a step (about 20 s of audio each
    at 50 frames a second), 30% of them masked, remat: step 0 as
    train_hybrid's (``step0_upcast_check``: in fp32, the weights upcast,
    against ``impl="torch"`` under STEP0_RTOL, and the bf16 step 0 against
    the fp32 one within BF16_STEP0_MARGIN of the plain bf16 step 0's
    distance: this random-weight bf16 stack moves single leaves' grad
    norms 7.3% from fp32 in the plain version itself, read on the H100),
    then 5 steps, their launches per step held exactly
    (``train_launches``: no RMSNorm), frames a second, MFU and a profiled
    step."""
    import repro_torch.configs as configs
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train.optimizer import OptConfig
    cfg = (configs.get_smoke("hubert_xlarge") if smoke
           else configs.get("hubert_xlarge"))
    shape = ShapeConfig("chip", "train", seq_len=32 if smoke else 1024,
                        global_batch=2 if smoke else 8, microbatch=1)
    opt_cfg = OptConfig(state_bits=None, warmup_steps=2, total_steps=100)
    return _train_phase("train_encoder", cfg, shape, opt_cfg, device,
                        n_steps=2 if smoke else 5, profile=True,
                        step0=step0_upcast_check)


#: pixtral_12b's layers in ``train_vlm``: 20 of its 40 (6.79e9 params with
#: the embedding, head and patch projection, ~41 GB of train state with
#: int8 moments; the whole model's ~74 GB would leave no room for a step)
VLM_TRAIN_LAYERS = 20


def phase_train_vlm(device="cuda", smoke=False):
    """pixtral_12b (the VLM: mistral_nemo_12b's backbone, GQA 32 / 8, behind
    the patch stub) at full width, cut in depth to ``VLM_TRAIN_LAYERS`` of
    its 40 layers, random bf16 weights from seed 0, int8 AdamW moments,
    2 x 2048 positions a step (the pipeline's 256 stub patches, then 1792
    text tokens), one microbatch, remat.  Step 0 first, before the block
    and its optimizer state exist (its fp32 upcast's params and grads
    would not fit beside them), on the block's params and first batch
    (``step0_upcast_check``, the params upcast in place: in fp32 against ``impl="torch"`` under
    STEP0_RTOL, the bf16 step 0 against the fp32 one within
    BF16_STEP0_MARGIN of the plain bf16 step 0's distance); then 5 steps
    through ``BlockRuntime(kind="train")``, their launches per step held
    exactly (``train_launches``: per layer 2 flash forward with the
    recompute and 1 backward, the backward's dk and dv summed over the
    group of 4 on the tensor cores, none on a CUDA-core route; 81 / 41
    RMSNorms; one int8 AdamW a leaf), tok/s, MFU, peak memory and what it
    leaves free, and a profiled step."""
    import repro_torch.configs as configs
    from repro_torch.data import pipeline
    from repro_torch.models import model as model_lib
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train.optimizer import OptConfig
    full = (configs.get_smoke("pixtral_12b") if smoke
            else configs.get("pixtral_12b"))
    cfg = full if smoke else full.replace(n_layers=VLM_TRAIN_LAYERS)
    shape = ShapeConfig("chip", "train", seq_len=32 if smoke else 2048,
                        global_batch=2, microbatch=1)
    opt_cfg = OptConfig(state_bits=8, warmup_steps=2, total_steps=100)
    progress("train_vlm: step-0 check")
    t0 = time.perf_counter()
    params = model_lib.Transformer(cfg, None, seed=0, device=device,
                                   requires_grad=True).params
    batch = pipeline.DataIterator(cfg, shape, seed=0, device=device).batch(0)
    n_patches = batch["patches"].shape[1]
    chk = step0_upcast_check(params, cfg, batch, consume=True)
    chk["seconds"] = time.perf_counter() - t0
    if torch.device(device).type == "cuda":
        chk["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, batch
    _free(device)

    def after(rt, out):
        out["reduced"] = {"n_layers": [full.n_layers, cfg.n_layers]}
        out.update(**_gqa(cfg), n_patches=n_patches,
                   params=model_lib.count_params(rt.state["params"]))
        out["step0_loss_equals_check"] = (
            out["losses"][0] == chk["bf16"]["loss"])
        check(out["step0_loss_equals_check"],
              f"train_vlm: the block's first loss {out['losses'][0]} is not "
              f"the checked bf16 step 0's {chk['bf16']['loss']}")
        if rt.device.type == "cuda":
            total = torch.cuda.get_device_properties(0).total_memory / 1e9
            out["free_at_peak_gb"] = total - out["peak_mem_gb"]
        return rt

    return _train_phase("train_vlm", cfg, shape, opt_cfg, device,
                        n_steps=2 if smoke else 5, profile=True,
                        step0=lambda *_: chk, after=after)


def phase_train(device="cuda", smoke=False):
    """deepseek_7b at full width, all 30 layers, int8 moments."""
    import repro_torch.configs as configs
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train.optimizer import OptConfig
    cfg = (configs.get_smoke("deepseek_7b") if smoke
           else configs.get("deepseek_7b"))
    shape = ShapeConfig("chip", "train", seq_len=32 if smoke else 2048,
                        global_batch=2, microbatch=1)
    opt_cfg = OptConfig(state_bits=8, warmup_steps=2, total_steps=100)

    def after(rt, out):
        # what train_sharded is held to, bit for bit, and what the dry
        # run's state is held to; then the host's share of two more steps
        out["state_checksums"] = bit_checksums(rt.state)
        out["state_bytes"] = tree_bytes(rt.state)
        out["host_probe"] = host_probe(rt)
        return rt

    return _train_phase("train", cfg, shape, opt_cfg, device,
                        n_steps=2 if smoke else 6, profile=True,
                        after=after)


def _whole(tree):
    """A tree with each DTensor leaf gathered whole (at (1, 1) its local
    shard itself)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    return tree.full_tensor() if isinstance(tree, DTensor) else tree


def tp_summary(tp, measured, planned, tp_leaves):
    """A block's tensor-parallel layout over ``model`` (item 8d) as the
    sharded phases print it: M, the heads a rank computes, the parts
    computed sharded, the rules that kept a part in 8a's layout, the
    bytes ``shard_ctx.full`` brought over ``model`` a step (counted on
    the host: a captured step's gathers count once, at its capture)
    beside the plan's count, and one group's gathered bytes beside the
    group whole.  At M = 1 those bytes are 0 by construction, a model
    axis of one rank having nothing to bring (``model_bytes_structural``:
    their check is of the layout, not a reading); ``tp_leaves`` counts
    the leaves ``full`` handed back as their model shard, the tensor-
    parallel gather path, which runs at M = 1 too."""
    return {**tp.summary(), "model_bytes_a_step": measured,
            "model_bytes_a_step_planned": planned,
            "model_bytes_structural": tp.model == 1,
            "tp_leaves": tp_leaves,
            "group_gb": tp.group_bytes / 1e9,
            "group_gb_whole": tp.group_bytes_whole / 1e9}


def exchange_figures(arch, M):
    """Computed, not measured (``hlo_analysis.tp_traffic``, no card):
    ``arch`` at full width on a (1, M) mesh, the GB the rank that
    receives the most gets over ``model`` in a decode step of 4 rows and
    a 2 x 2048 train step, with the columns' exchange
    (``TPLayout.exchange``) and with the exchanged leaves gathered whole
    (``exchange=False``); checked below the whole gather's."""
    import repro_torch.configs as configs
    from repro_torch.launch.hlo_analysis import tp_traffic
    from repro_torch.models.config import ShapeConfig
    cfg, mesh = configs.get(arch), {"data": 1, "model": M}
    out = {"arch": arch, "mesh": [1, M], "computed": True}
    for name, shape in (("decode_4_rows", ShapeConfig("d", "decode", 1, 4)),
                        ("train_2x2048",
                         ShapeConfig("t", "train", 2048, 2, 1))):
        out[f"{name}_gb"] = tp_traffic(cfg, shape, mesh)["8d"] / 1e9
        out[f"{name}_gb_whole_gather"] = tp_traffic(
            cfg, shape, mesh, exchange=False)["8d"] / 1e9
        check(out[f"{name}_gb"] < out[f"{name}_gb_whole_gather"],
              f"{arch} at (1, {M}): the exchange brings {out}")
    return out


def phase_train_sharded(device="cuda", smoke=False, train=None):
    """``train``'s job through the sharded runtime (item 8a): deepseek_7b
    at full width, 30 layers, int8 moments, 2 x 2048 tokens, seed 0, on a
    (1, 1) DeviceMesh under a process group of one rank (NCCL on the
    card, gloo on the CPU; a ``HashStore``, no network), every state leaf
    a DTensor.  Held bit for bit against ``train``: every loss and grad
    norm, and the per-leaf checksums of the state after the last step;
    its launches per step exactly ``train``'s.  Then two steps of
    ``host_probe`` (``train`` runs the same), a synchronous save and
    ``suspend()`` (the state freed), a fresh (1, 1) block restoring it
    leaf for leaf bit for bit, and three profiled warm steps on that
    block.  The block runs the tensor-parallel path of item 8d at M = 1
    (every leaf's model shard is the leaf, every join of the model
    column skipped): its ``tp`` dict gives the layout, the bytes
    gathered over ``model`` a step (0 by construction at M = 1) and the
    leaves ``full`` handed back as their model shard a step.  The
    process group is destroyed at the end, so the later phases run as
    before."""
    import torch.distributed as dist
    import repro_torch.configs as configs
    from repro_torch import device as device_lib
    from repro_torch.core.block import BlockGrant
    from repro_torch.core.runtime import BlockRuntime
    from repro_torch.models.config import ShapeConfig
    from repro_torch.sharding import ctx as shard_ctx
    from repro_torch.train.optimizer import OptConfig
    from torch.distributed.tensor import DTensor
    cfg = (configs.get_smoke("deepseek_7b") if smoke
           else configs.get("deepseek_7b"))
    shape = ShapeConfig("chip", "train", seq_len=32 if smoke else 2048,
                        global_batch=2, microbatch=1)
    opt_cfg = OptConfig(state_bits=8, warmup_steps=2, total_steps=100)
    device_lib.init_distributed(device, store=dist.HashStore(), rank=0,
                                world_size=1)
    root = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    shard_ctx.GATHERED.update(model_bytes=0, tp_leaves=0)

    def after(rt, out):
        check(rt.mesh is not None and tuple(rt.mesh.mesh.shape) == (1, 1)
              and all(isinstance(t, DTensor) for t in _tensors(
                  rt.state["params"])), "train_sharded: not on a mesh")
        out["mesh"] = list(rt.mesh.mesh.shape)
        out["tp"] = tp_summary(
            rt.tp, shard_ctx.GATHERED["model_bytes"] / len(out["losses"]),
            rt.tp.step_bytes(shape.microbatch, remat=cfg.remat != "none",
                             backward=True),
            shard_ctx.GATHERED["tp_leaves"] / len(out["losses"]))
        check(out["tp"]["model"] == 1 and rt.tp.computes("attn")
              and out["tp"]["model_bytes_a_step"] == 0
              and out["tp"]["tp_leaves"] > 0,
              f"train_sharded: tensor-parallel layout {out['tp']}")
        out["backend"] = dist.get_backend()
        out["state_checksums"] = bit_checksums(_whole(rt.state))
        if train is not None:
            for key in ("losses", "grad_norms", "state_checksums"):
                out[f"{key}_equal_train"] = out[key] == train[key]
                check(out[f"{key}_equal_train"],
                      f"train_sharded {key} differ from train's")
            out["launches_equal_train"] = (out["launches_per_step"]
                                           == train["launches_per_step"])
            check(out["launches_equal_train"],
                  "train_sharded launches differ from train's")
            out["steady_step_s_minus_train"] = (out["steady_step_s"]
                                                - train["steady_step_s"])
        # the host time the DTensor calls add: against train's probe
        out["host_probe"] = host_probe(rt)
        at_suspend = bit_checksums(_whole(rt.state))
        need = tree_bytes(_whole(rt.state))
        _disk_check(root, need, "train_sharded")
        t0 = time.perf_counter()
        rt.suspend()
        out["suspend_s"] = time.perf_counter() - t0
        out["ckpt_gb"] = need / 1e9
        rt2 = BlockRuntime(BlockGrant.new([(0, 0, 0)], (1, 1), 3600.0),
                           rt.job, devices=[device], ckpt_root=root)
        t0 = time.perf_counter()
        at = rt2.restore()
        rt2._sync()
        out["restore_s"] = time.perf_counter() - t0
        restored = bit_checksums(_whole(rt2.state))
        out["restore_bitwise_equal"] = (at == rt.step_count
                                        and restored == at_suspend)
        check(out["restore_bitwise_equal"],
              "train_sharded: the restored state differs")
        return rt2

    try:
        return _train_phase("train_sharded", cfg, shape, opt_cfg, device,
                            n_steps=2 if smoke else 6, profile=True,
                            step0=None, after=after, ckpt_root=root,
                            profile_n=3)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)


def phase_serve_sharded(device="cuda", smoke=False, dense=None, paged=None):
    """The serve block on a mesh (item 8c) on one card: a process group of
    one rank (NCCL on the card, gloo on the CPU; a ``HashStore``, no
    network), so the block runs on a (1, 1) DeviceMesh, every param a
    DTensor gathered a group at a time inside the step (and inside the
    captured decode's graph).  The dense plane: serve_dense's job
    (``dense``: deepseek_7b at full width, 30 layers, random bf16 weights
    from seed 0, 4 x 512 prompt tokens, 32 generated) through
    ``repro_torch.launch.serve``'s ``run``; its tokens serve_dense's bit
    for bit, its prefill's and each captured decode step's launches
    exactly serve_dense's (one capture, a replay a step); warm prefill and
    decode steps profiled, the graph's capture time and pool, the host's
    enqueue of a replay (``host_probe``) and of an eager step
    (``eager_probe``, beside serve_dense's), peak memory.  Then the decode
    again from the prompt, a synchronous save and ``suspend()`` halfway,
    a fresh (1, 1) block restoring the decode context bit for bit and
    decoding the remaining tokens: serve_dense's.  The paged plane:
    serve_paged's job and traffic (``paged``: 12 sessions through 8
    slots) on a (1, 1) mesh, every session's tokens serve_paged's and the
    launches exactly its.  The process group is destroyed at the end, so
    the later phases run as before."""
    import torch.distributed as dist
    from repro_torch import device as device_lib
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.block import BlockGrant
    from repro_torch.core.runtime import BlockRuntime
    from repro_torch.launch import serve
    from repro_torch.sharding import ctx as shard_ctx
    from torch.distributed.tensor import DTensor
    if dense is None:
        dense = phase_serve_dense(device, smoke)
        _free(device)
    if paged is None:
        paged = phase_serve_paged(device, smoke)
        _free(device)
    device_lib.init_distributed(device, store=dist.HashStore(), rank=0,
                                world_size=1)
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_sharded_")
    dev = device_lib.rank_device(device)
    on_card = dev.type == "cuda"

    def sharded(rt, what):
        check(rt.mesh is not None and tuple(rt.mesh.mesh.shape) == (1, 1)
              and all(isinstance(t, DTensor)
                      for t in _tensors(rt.state["params"])),
              f"serve_sharded {what}: not on a mesh")

    out = {"backend": dist.get_backend(), "mesh": [1, 1], "card": _CARD}
    try:
        # ---- the dense plane through the launcher
        args = serve.parse_args(serve_dense_argv(device, smoke))
        B, P, G = args.batch, args.prompt_len, args.gen
        zero_counts()
        _zero_eager_calls()
        shard_ctx.GATHERED.update(model_bytes=0, tp_leaves=0)
        res = serve.run(args)
        launches = counts()
        rt = res["runtime"]
        sharded(rt, "dense")
        out["tp"] = {"dense": tp_summary(
            rt.tp, shard_ctx.GATHERED["model_bytes"], rt.tp.step_bytes(1),
            shard_ctx.GATHERED["tp_leaves"])}
        check(rt.tp.model == 1 and rt.tp.computes("attn")
              and out["tp"]["dense"]["model_bytes_a_step"] == 0
              and out["tp"]["dense"]["tp_leaves"] > 0,
              f"serve_sharded: tensor-parallel layout {out['tp']}")
        graph = graph_check("serve_sharded", rt.decode_graph, G - 1,
                            _eager_calls(), device)
        toks = res["tokens"]
        d = {"prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
             "prefill_tok_s": B * P / res["prefill_s"],
             "decode_tok_s": B * (G - 1) / res["decode_s"],
             "launches": launches, "decode_graph": graph,
             "tokens_equal_serve_dense": toks.tolist() == dense["tokens"],
             "launches_equal_serve_dense": launches == dense["launches"],
             "launches_per_replay_equal_serve_dense": (
                 graph["launches_per_replay"]
                 == dense["decode_graph"]["launches_per_replay"])}
        check(d["tokens_equal_serve_dense"],
              "serve_sharded: the tokens differ from serve_dense's")
        check(d["launches_equal_serve_dense"]
              and d["launches_per_replay_equal_serve_dense"],
              f"serve_sharded launches {launches}, graph {graph}; "
              f"serve_dense's {dense['launches']}, {dense['decode_graph']}")
        batch = {k: torch.as_tensor(v, device=rt.device)
                 for k, v in res["batch"].items()}
        if on_card:
            d["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
            saved = counts()
            d["warm_prefill"] = profile_steps(lambda: rt.prefill(batch), 2)
            rt.prefill(batch)
            d["warm_decode_step"] = profile_steps(rt.step, 3)
            d["host_probe"] = host_probe(rt)
            d["host_probe_eager"] = eager_probe(rt)
            set_counts(saved)
            d["serve_dense"] = {
                k: dense.get(k) for k in ("prefill_s", "decode_s",
                                          "warm_decode_step",
                                          "warm_decode_step_eager",
                                          "host_probe_eager", "peak_mem_gb")}
            d["serve_dense"]["decode_graph"] = {
                k: dense["decode_graph"][k] for k in ("capture_ms",
                                                      "pool_mb")}

        # ---- halfway: a synchronous save and a suspend, a fresh block
        # restores the decode context and decodes the rest
        saved = counts()
        half = (G - 1) // 2
        rt.prefill(batch)
        for _ in range(half):
            rt.step()
        check(rt.token.cpu().numpy().tolist()
              == toks[:, half:half + 1].tolist(),
              "serve_sharded: the decode from the prompt again differs")
        rt.ckpt = CheckpointManager(root, "serve_sharded", keep=1)
        at_save = bit_checksums(_whole(rt._decode_ctx()))
        save_step = rt.step_count
        need = tree_bytes(_whole(rt._payload()["state"]))
        _disk_check(root, need, "serve_sharded")
        t0 = time.perf_counter()
        rt.suspend()
        d["suspend_s"] = time.perf_counter() - t0
        d["ckpt_gb"] = need / 1e9
        job = dataclasses.replace(rt.job, ckpt_namespace="serve_sharded")
        del res, rt
        _free(device)
        rt = BlockRuntime(BlockGrant.new([(0, 0, 0)], (1, 1), 3600.0), job,
                          devices=[device], ckpt_root=root)
        t0 = time.perf_counter()
        at = rt.restore()
        rt._sync()
        d["restore_s"] = time.perf_counter() - t0
        sharded(rt, "restored")
        d["restore_bitwise_equal"] = (
            at == save_step and bit_checksums(_whole(rt._decode_ctx()))
            == at_save)
        check(d["restore_bitwise_equal"],
              "serve_sharded: the restored decode context differs")
        rest = []
        for _ in range(G - 1 - half):
            rt.step()
            rest.append(rt.token.cpu().numpy())
        d["resumed_tokens_equal_serve_dense"] = (
            np.concatenate(rest, axis=1).tolist()
            == toks[:, half + 1:].tolist())
        check(d["resumed_tokens_equal_serve_dense"],
              "serve_sharded: the tokens after the restore differ")
        del rt
        set_counts(saved)
        _free(device)
        out["dense"] = d

        # ---- the paged plane: serve_paged's traffic
        job = _paged_job(smoke)
        rt = _block(job, device)
        rt.init_state()
        sharded(rt, "paged")
        out["tp"]["paged"] = tp_summary(rt.tp, 0, rt.tp.step_bytes(1), 0)
        check(rt.tp.kept == ("paged",), f"serve_sharded paged: {rt.tp}")
        prompts = _paged_prompts(job.cfg, smoke)
        max_new = PAGED_NEW_TOKENS_SMOKE if smoke else PAGED_NEW_TOKENS
        zero_counts()
        _zero_eager_calls()
        emissions, elapsed, ttft = _paged_traffic(rt, prompts, max_new)
        launches = counts()
        sch = rt.sessions
        got = {s.sid: list(s.generated) for s in sch.sessions.values()}
        pg = {"decode_rounds": rt.paged_rounds["decoded"],
              "admissions": sch.admissions, "elapsed_s": elapsed,
              "tok_s": sum(1 for e in emissions if e["event"] == "token")
              / elapsed,
              "ttft_p50_s": float(np.percentile(ttft, 50)),
              "ttft_p99_s": float(np.percentile(ttft, 99)),
              "launches": launches,
              "decode_graph": graph_check(
                  "serve_sharded paged", sch.decode_graph,
                  rt.paged_rounds["decoded"], _eager_calls(), device),
              "tokens_equal_serve_paged": got == paged["session_tokens"],
              "launches_equal_serve_paged": launches == paged["launches"],
              "serve_paged": {k: paged[k] for k in (
                  "decode_rounds", "elapsed_s", "tok_s", "ttft_p50_s")}}
        check(pg["tokens_equal_serve_paged"],
              "serve_sharded: the paged sessions' tokens differ from "
              "serve_paged's")
        check(pg["launches_equal_serve_paged"]
              and pg["decode_rounds"] == paged["decode_rounds"],
              f"serve_sharded paged launches {launches}, serve_paged's "
              f"{paged['launches']}")
        if on_card:
            pg["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del rt, sch
        out["paged"] = pg
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = {n: out["dense"]["launches"][n]
                       + out["paged"]["launches"][n] for n in COUNTERS}
    emit("serve_sharded", **out)
    return out


def _train_f32_setup(smoke):
    """deepseek_7b's width cut to 4 layers, fp32 moments, 2 x 2048 tokens
    in 2 microbatches (``blocks`` runs the same job)."""
    import repro_torch.configs as configs
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train.optimizer import OptConfig
    cfg = (configs.get_smoke("deepseek_7b") if smoke
           else configs.get("deepseek_7b"))
    cfg = dataclasses.replace(cfg, n_layers=2 if smoke else 4)
    shape = ShapeConfig("chip", "train", seq_len=32 if smoke else 2048,
                        global_batch=2, microbatch=2)
    opt_cfg = OptConfig(state_bits=None, warmup_steps=2, total_steps=100)
    return cfg, shape, opt_cfg


def phase_train_f32(device="cuda", smoke=False):
    """The same width cut to 4 layers, fp32 moments, 2 microbatches; then
    ``host_probe``'s two steps, which ``blocks`` runs on alice too."""
    cfg, shape, opt_cfg = _train_f32_setup(smoke)

    def after(rt, out):
        out["host_probe"] = host_probe(rt)
        return rt

    # 3 steps at smoke size too: blocks migrates alice after her second
    return _train_phase("train_f32", cfg, shape, opt_cfg, device,
                        n_steps=3, profile=False, after=after)


#: blocks: the chips of the one-rank topology (alice's, carol's, the spare
#: alice migrates onto), and alice's steps alone after the held ones
BLOCKS_CHIPS = 3
ALONE_STEPS = 3


def phase_blocks(device="cuda", smoke=False, train=None, serve=None):
    """Two tenant blocks at once in one controller, each on a mesh and
    process groups of its own (item 8b), on one card: a process group of
    one rank (NCCL on the card, gloo on the CPU; a ``HashStore``, no
    network) and a topology of 3 chips, all on that rank, driven through
    ``ClusterDaemon``'s deterministic calls on the model clock.  Alice's
    train block on chip 0 runs train_f32's job (``train``: deepseek_7b
    at full width cut to 4 layers, fp32 moments, 2 x 2048 tokens in 2
    microbatches, seed 0) on the sharded runtime at (1, 1); carol's serve
    block on chip 1 runs serve_hybrid's job (``serve``: zamba2_2p7b at
    full size on the dense plane, 4 x 1000 prompt tokens, 32 generated,
    the decode captured).  Both step through ``step_all`` for two rounds;
    alice saves at step 2; chip 0 fails, and the controller migrates her
    onto chip 2, her old state released before the restore; her
    restored state equals her state at the save bit for bit, and she
    takes her third step; carol decodes on to her 32nd token, then alice
    takes 3 steps alone timed as train_f32's are, 3 through the daemon
    and ``host_probe``'s 2 (the sharded step's own time).  Held bit
    for bit: alice's 3 losses and grad norms against train_f32's, carol's
    tokens against serve_hybrid's; launches exactly a train_f32 step
    each alice step, serve_hybrid's prefill and decode step each of
    carol's; the card's memory across the migration never two copies of
    alice's state, and back to where it was once both blocks end.  Read:
    failure-to-first-step, save and restore seconds, the peak memory
    across the migration and each block's step time co-resident against
    alone (alice's steps alone and train_f32's steady step, and both
    blocks' ``host_probe``; carol's
    decode steps after the migration and serve_hybrid's; this run, this
    card).  The process group
    is destroyed at the end, so the later phases run as before."""
    import torch.distributed as dist
    from repro_torch import device as device_lib
    from repro_torch.core.block import BlockState
    from repro_torch.core.daemon import ClusterDaemon
    from repro_torch.core.runtime import JobSpec
    from repro_torch.core.topology import Topology
    from repro_torch.data import pipeline
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models.config import ShapeConfig
    from torch.distributed.tensor import DTensor
    if train is None:
        train = phase_train_f32(device, smoke)
        _free(device)
    if serve is None:
        serve = phase_serve_hybrid(device, smoke)
        _free(device)
    cfg, shape, opt_cfg = _train_f32_setup(smoke)
    alice_job = JobSpec(cfg, shape, kind="train", opt=opt_cfg, seed=0,
                        collect_metrics=True)
    args = serve_lib.parse_args(serve_hybrid_argv(device, smoke))
    ccfg = serve_lib.config(args)
    B, P, G = args.batch, args.prompt_len, args.gen
    carol_job = JobSpec(ccfg, ShapeConfig("cli", "serve", seq_len=P + G,
                                          global_batch=B),
                        kind="serve", seed=args.seed)
    batch = {k: v for k, v in pipeline.synthetic_batch(
        ccfg, ShapeConfig("cli", "prefill", seq_len=P, global_batch=B),
        step=0, seed=args.seed).items() if k != "labels"}
    n_alice = len(train["losses"])
    device_lib.init_distributed(device, store=dist.HashStore(), rank=0,
                                world_size=1)
    dev = device_lib.rank_device(device)
    root = tempfile.mkdtemp(prefix="chip_smoke_blocks_")
    now = 0.0
    out = {"chips": BLOCKS_CHIPS, "backend": dist.get_backend(),
           "world_size": dist.get_world_size()}
    try:
        base = _mem(dev)
        daemon = ClusterDaemon(Topology(n_pods=1, pod_x=BLOCKS_CHIPS,
                                        pod_y=1),
                               devices=[device] * BLOCKS_CHIPS,
                               ckpt_root=root)
        apps, grants = {}, {}
        zero_counts()
        _zero_eager_calls()
        for user, job in (("alice", alice_job), ("carol", carol_job)):
            progress(f"blocks: {user} activates")
            a = daemon.register(user, f"{job.kind} {job.cfg.name}", 1,
                                arch=job.cfg.name)
            grants[user] = daemon.review(a)
            daemon.confirm(a, grants[user].token)
            daemon.activate(a, job)
            daemon.run(a)
            apps[user] = a
        alice, carol = apps["alice"], apps["carol"]
        rt_a, rt_c = daemon.runtime(alice), daemon.runtime(carol)
        groups = [mesh_lib.block_group(rt.mesh) for rt in (rt_a, rt_c)]
        out["meshes"] = {u: {"coords": [list(c) for c in g.coords],
                             "ranks": daemon.runtime(apps[u]).ranks,
                             "mesh": list(daemon.runtime(
                                 apps[u]).mesh.mesh.shape)}
                         for u, g in grants.items()}
        out["own_groups"] = (groups[0] is not groups[1] and all(
            g is not dist.group.WORLD for g in groups))
        # carol's serve block on her (1, 1) mesh too: her params
        # DTensors, gathered inside her captured decode (item 8c)
        out["carol_sharded"] = all(isinstance(t, DTensor) for t in
                                   _tensors(rt_c.state["params"]))
        check(out["own_groups"] and rt_a.ctx is not None
              and rt_c.ctx is not None and out["carol_sharded"]
              and [list(c) for c in grants["alice"].coords] == [[0, 0, 0]]
              and [list(c) for c in grants["carol"].coords] == [[0, 1, 0]],
              f"blocks: the grants and meshes {out['meshes']}")
        state_bytes = tree_bytes(_whole(rt_a.state))
        _disk_check(root, state_bytes, "blocks")
        out["mem_gb"] = {"base": base, "both_active": _mem(dev)}
        launches = {"activation": counts()}

        progress("blocks: carol's prefill")
        zero_counts()
        t0 = time.perf_counter()
        rt_c.prefill(batch)
        tokens = [rt_c.token.cpu().numpy()]
        prefill_s = time.perf_counter() - t0
        launches["carol_prefill"] = counts()

        progress("blocks: two rounds of step_all")
        hist, co = [], []
        zero_counts()
        for _ in range(2):
            t0 = time.perf_counter()
            res = daemon.step_all(rounds=1)
            tokens.append(rt_c.token.cpu().numpy())
            co.append({"round_s": time.perf_counter() - t0,
                       "alice_step_s": res[alice][0]["step_s"],
                       "carol_step_s": res[carol][0]["step_s"]})
            hist.append(res[alice][0])
        launches["co_resident_rounds"] = counts()

        progress("blocks: alice saves, chip 0 fails")
        t0 = time.perf_counter()
        daemon.save(alice)
        save_s = time.perf_counter() - t0
        at_save = bit_checksums(_whole(rt_a.state))
        save_timings = dict(rt_a.ckpt.timings)
        del rt_a
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        mem_before = _mem(dev)
        zero_counts()
        t0 = time.perf_counter()
        failed = daemon.inject_chip_failure((0, 0, 0), now=now)
        migrate_s = time.perf_counter() - t0
        peak_migration = _peak(dev)
        rt_a = daemon.runtime(alice)
        restore_timings = dict(rt_a.ckpt.timings)
        blk = daemon.registry.get(alice)
        restored = bit_checksums(_whole(rt_a.state))
        out["alice"] = {
            "migrated_to": [list(c) for c in blk.grant.coords],
            "restored_step": rt_a.step_count,
            "restored_bitwise": restored == at_save}
        check(failed == alice and blk.state == BlockState.RUNNING
              and out["alice"]["migrated_to"] == [[0, 2, 0]]
              and rt_a.step_count == 2 and out["alice"]["restored_bitwise"],
              f"blocks: the migration {out['alice']}")
        mem_restored = _mem(dev)
        hist += daemon.run_steps({alice: n_alice - 2})[alice]
        failure_to_step_s = time.perf_counter() - t0
        peak = _peak(dev)
        launches["alice_after_migration"] = counts()

        progress("blocks: carol decodes on, then alice steps alone")
        zero_counts()
        t0 = time.perf_counter()
        for _ in range(G - 3):
            daemon.run_steps({carol: 1})
            tokens.append(rt_c.token.cpu().numpy())
        carol_alone_s = (time.perf_counter() - t0) / (G - 3)
        launches["carol_decode"] = counts()
        graph = graph_check("blocks", rt_c.decode_graph, G - 1,
                            _eager_calls(), device)
        toks = np.concatenate(tokens, axis=1)
        # alice's sharded step alone (carol idle), past the steps held
        # to train_f32: timed as train_f32's steps are (BlockRuntime.step,
        # to the device's end), then through the daemon, one at a time,
        # wall clock to its metrics on the host (what her co-resident
        # rounds are read against), then host_probe's enqueue and wall
        # times, which train_f32 reads too
        zero_counts()
        alone = [rt_a.step()["step_s"] for _ in range(ALONE_STEPS)]
        alone_daemon = []
        for _ in range(ALONE_STEPS):
            t0 = time.perf_counter()
            daemon.run_steps({alice: 1})
            alone_daemon.append(time.perf_counter() - t0)
        launches["alice_alone"] = counts()
        probe = host_probe(rt_a)
        del rt_a, rt_c
        for a in apps.values():
            daemon.expire(a, now=now)
        gc.collect()
        out["mem_gb"]["after_expiry"] = _mem(dev)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)

    # held: alice against train_f32, carol against serve_hybrid
    out["alice"].update(
        losses=[h["loss"] for h in hist],
        grad_norms=[h["grad_norm"] for h in hist],
        step_s=[h["step_s"] for h in hist])
    out["carol"] = {"tokens": toks.tolist(), "decode_graph": graph,
                    "prefill_s": prefill_s}
    for key, want in (("losses", train["losses"]),
                      ("grad_norms", train["grad_norms"])):
        out["alice"][f"{key}_equal_train_f32"] = out["alice"][key] == want
        check(out["alice"][key] == want,
              f"blocks: alice's {key} {out['alice'][key]}, train_f32's "
              f"{want}")
    out["carol"]["tokens_equal_serve_hybrid"] = (out["carol"]["tokens"]
                                                 == serve["tokens"])
    check(out["carol"]["tokens_equal_serve_hybrid"],
          "blocks: carol's tokens differ from serve_hybrid's")
    zero = {n: 0 for n in COUNTERS}
    step = train["launches_per_step"]
    pre, dec = hybrid_launches(ccfg)
    if dev.type != "cuda":
        step, pre, dec = zero, zero, zero
    want = {"activation": zero, "carol_prefill": pre,
            "co_resident_rounds": {n: 2 * step[n] + 2 * dec[n]
                                   for n in COUNTERS},
            "alice_after_migration": {n: (n_alice - 2) * step[n]
                                      for n in COUNTERS},
            "carol_decode": {n: (G - 3) * dec[n] for n in COUNTERS},
            "alice_alone": {n: 2 * ALONE_STEPS * step[n]
                            for n in COUNTERS}}
    check(launches == want, f"blocks launches {launches}, want {want}")
    out["launches_by_segment"] = launches
    out["launches"] = {n: sum(c[n] for c in launches.values())
                       for n in COUNTERS}
    gb = lambda b: None if b is None else b / 1e9   # noqa: E731
    out["mem_gb"] = {k: gb(v) for k, v in out["mem_gb"].items()}
    out["mem_gb"].update(before_migration=gb(mem_before),
                         after_restore=gb(mem_restored),
                         peak_migration=peak_migration,
                         peak_migration_and_step=peak,
                         alice_state=state_bytes / 1e9)
    if dev.type == "cuda":
        # the old state went before the new one came: no second copy at
        # any point of the migration, and nothing of either block left
        # once both have ended
        mem = out["mem_gb"]
        check(mem["peak_migration"] < mem["before_migration"]
              + mem["alice_state"] / 2
              and mem["after_restore"] <= mem["before_migration"] + 0.5
              and mem["after_expiry"] <= mem["base"] + 1.0,
              f"blocks: the card's memory {mem}")
    out["migration"] = {"save_s": save_s, "save_timings": save_timings,
                        "migrate_s": migrate_s,
                        "restore_timings": restore_timings,
                        "failure_to_first_step_s": failure_to_step_s}
    # step times: co-resident (the two rounds of step_all, the first
    # carrying first-call costs and carol's capture) against alone
    out["step_time"] = {
        "co_resident": co,
        "alice_alone_s": alone,
        "alice_alone_steady_s": float(np.median(alone[1:])),
        "train_f32_steady_s": train["steady_step_s"],
        "alice_alone_daemon_s": alone_daemon,
        "alice_host_probe": probe,
        "train_f32_host_probe": train.get("host_probe"),
        "alice_after_migration_s": out["alice"]["step_s"][2:],
        "carol_alone_decode_s": serve["decode_s"] / (G - 1),
        "carol_decode_after_s": carol_alone_s}
    out["card"] = _CARD
    emit("blocks", **out)
    return out


def _train_hybrid_setup(smoke):
    """train_hybrid's job: zamba2_2p7b at full width (54 layers), 2 x 2048
    tokens a step (2 x 32 at smoke size), one microbatch, fp32 moments."""
    import repro_torch.configs as configs
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train.optimizer import OptConfig
    cfg = (configs.get_smoke("zamba2_2p7b") if smoke
           else configs.get("zamba2_2p7b"))
    shape = ShapeConfig("chip", "train", seq_len=32 if smoke else 2048,
                        global_batch=2, microbatch=1)
    opt_cfg = OptConfig(state_bits=None, warmup_steps=2, total_steps=100)
    return cfg, shape, opt_cfg


def phase_train_hybrid(device="cuda", smoke=False):
    """zamba2_2p7b at full width (54 layers, random bf16 weights from seed
    0), fp32 AdamW moments, 2 x 2048 tokens a step, one microbatch, remat:
    the step 0 in fp32 (weights upcast) against impl="torch" under
    STEP0_RTOL and the bf16 step 0 beside it; 3 steps, their launches per
    step held exactly (``train_launches``), and a profiled step."""
    cfg, shape, opt_cfg = _train_hybrid_setup(smoke)
    return _train_phase("train_hybrid", cfg, shape, opt_cfg, device,
                        n_steps=2 if smoke else 4, profile=True,
                        step0=step0_upcast_check)


def _sharded_serve(name, ref_name, ref, argv, device, sharded, cfg=None):
    """A ``*_sharded`` phase's serve block: the launcher's job (``argv``;
    ``cfg`` a cut config) under the phase's one-rank process group, its
    layout checked by ``sharded(rt, what)``, held to the unsharded phase
    ``ref_name``'s results ``ref``: its tokens bit for bit, its launches
    and the graph's launches a replay exactly theirs; the prefill's and
    the first decode step's logits, from the block's params under its
    context and a fresh cache as ``ref``'s check ran them (not the main
    path), bit for bit (``logits_digests``); on the card the peak memory
    and the warm replay's wall and device time beside ``ref``'s."""
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.models import model
    from repro_torch.sharding import ctx as shard_ctx
    progress(f"{name}: serve")
    args = serve_launcher.parse_args(argv)
    B, P, G = args.batch, args.prompt_len, args.gen
    zero_counts()
    _zero_eager_calls()
    shard_ctx.GATHERED.update(model_bytes=0, tp_leaves=0)
    res = serve_launcher.run(args, cfg)
    launches = counts()
    rt = res["runtime"]
    sharded(rt, "serve")
    graph = graph_check(f"{name} serve", rt.decode_graph, G - 1,
                        _eager_calls(), device)
    tokens = torch.as_tensor(res["batch"]["tokens"], device=rt.device)
    d = {"prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
         "launches": launches, "decode_graph": graph,
         "tp": tp_summary(rt.tp, shard_ctx.GATHERED["model_bytes"],
                          rt.tp.step_bytes(1),
                          shard_ctx.GATHERED["tp_leaves"]),
         f"tokens_equal_{ref_name}": res["tokens"].tolist() == ref["tokens"],
         f"launches_equal_{ref_name}": launches == ref["launches"],
         f"launches_per_replay_equal_{ref_name}": (
             graph["launches_per_replay"]
             == ref["decode_graph"]["launches_per_replay"])}
    check(d[f"tokens_equal_{ref_name}"],
          f"{name}: the tokens differ from {ref_name}'s")
    check(d[f"launches_equal_{ref_name}"]
          and d[f"launches_per_replay_equal_{ref_name}"],
          f"{name} serve launches {launches}, graph {graph}; {ref_name}'s "
          f"{ref['launches']}, {ref['decode_graph']}")
    saved = counts()
    with shard_ctx.use(rt.ctx):
        cfg = rt.job.cfg
        cache = model.init_cache(cfg, B, P + 1, rt.device)
        params = rt.state["params"]
        lg, _ = model.prefill(params, cfg, {"tokens": tokens}, cache)
        first = torch.argmax(lg, -1)[:, None].to(torch.int32)
        step, _ = model.decode_step(params, cfg, first, cache, P)
        del cache
    d["logits_digests"] = {"prefill": digest(lg.float()),
                           "decode": digest(step.float())}
    del lg, step
    d[f"logits_equal_{ref_name}"] = (d["logits_digests"]
                                     == ref["logits_digests"])
    check(d[f"logits_equal_{ref_name}"],
          f"{name}: the prefill or first decode logits differ from "
          f"{ref_name}'s")
    if rt.device.type == "cuda":
        d["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        d[f"{ref_name}_peak_mem_gb"] = ref["peak_mem_gb"]
        # a fresh decode context in the graph's own cache, then warm
        # replays, as the unsharded phase profiles its own
        restart(rt)
        rt.prefill({"tokens": tokens})
        d["warm_decode_step"] = profile_steps(rt.step, 3)
        d[f"{ref_name}_warm_decode_step"] = {
            k: ref["warm_decode_step"][k]
            for k in ("wall_ms", "device_ms", "idle_share")}
    set_counts(saved)
    return d


def phase_hybrid_sharded(device="cuda", smoke=False, train=None,
                         serve=None):
    """The hybrid family through the sharded runtime (item 8g, part 1):
    zamba2_2p7b under a process group of one rank (NCCL on the card,
    gloo on the CPU; a ``HashStore``), so its blocks run on a (1, 1)
    DeviceMesh with every param a DTensor and the tensor-parallel path
    of its Mamba2 heads, shared attention, MLP and vocabulary at M = 1
    (every join a no-op, every leaf's model shard the leaf).  The train
    block: train_hybrid's job (``train``: 54 layers at full width, fp32
    moments, 2 x 2048 tokens), its losses and grad norms train_hybrid's
    bit for bit and its launches per step exactly theirs.  The serve
    block: serve_hybrid's job through the launcher (``serve``: 4 x 1000
    prompt tokens, 32 generated, the decode captured), its tokens
    serve_hybrid's bit for bit, its launches and the graph's launches a
    replay exactly theirs; the prefill's and the first decode step's
    logits, from the block's params under its context, serve_hybrid's
    (``logits_digests``) bit for bit.  The process group is destroyed
    at the end."""
    import torch.distributed as dist
    from repro_torch import device as device_lib
    from repro_torch.sharding import ctx as shard_ctx
    from torch.distributed.tensor import DTensor
    if train is None:
        train = phase_train_hybrid(device, smoke)
        _free(device)
    if serve is None:
        serve = phase_serve_hybrid(device, smoke)
        _free(device)
    device_lib.init_distributed(device, store=dist.HashStore(), rank=0,
                                world_size=1)
    out = {"backend": dist.get_backend(), "mesh": [1, 1], "card": _CARD}

    def sharded(rt, what):
        check(rt.mesh is not None and tuple(rt.mesh.mesh.shape) == (1, 1)
              and all(isinstance(t, DTensor)
                      for t in _tensors(rt.state["params"]))
              and rt.tp.model == 1 and rt.tp.kept == ()
              and rt.tp.kinds == {"attn", "mlp", "vocab", "mamba"},
              f"hybrid_sharded {what}: not on the tensor-parallel path, "
              f"{rt.tp}")

    try:
        cfg, shape, opt_cfg = _train_hybrid_setup(smoke)
        shard_ctx.GATHERED.update(model_bytes=0, tp_leaves=0)

        def after(rt, o):
            sharded(rt, "train")
            o["tp"] = tp_summary(
                rt.tp, shard_ctx.GATHERED["model_bytes"] / len(o["losses"]),
                rt.tp.step_bytes(shape.microbatch, remat=True,
                                 backward=True),
                shard_ctx.GATHERED["tp_leaves"] / len(o["losses"]))
            check(o["tp"]["model_bytes_a_step"] == 0
                  and o["tp"]["tp_leaves"] > 0,
                  f"hybrid_sharded train: {o['tp']}")
            o["tp"]["over_model"] = exchange_figures("zamba2_2p7b", 16)
            for key in ("losses", "grad_norms", "launches_per_step"):
                o[f"{key}_equal_train_hybrid"] = o[key] == train[key]
                check(o[f"{key}_equal_train_hybrid"],
                      f"hybrid_sharded train: {key} {o[key]}, "
                      f"train_hybrid's {train[key]}")
            # the host time the DTensor calls add: enqueue against wall
            o["host_probe"] = host_probe(rt)
            return rt

        tr = _train_phase("hybrid_sharded_train", cfg, shape, opt_cfg,
                          device, n_steps=train["steps"], profile=False,
                          step0=None, after=after)
        out["train"] = {k: tr[k] for k in (
            "losses", "grad_norms", "steady_step_s", "tok_s", "host_probe",
            "launches_per_step", "tp", "losses_equal_train_hybrid",
            "grad_norms_equal_train_hybrid",
            "launches_per_step_equal_train_hybrid")}
        out["train"]["train_hybrid_steady_step_s"] = train["steady_step_s"]
        _free(device)

        d = _sharded_serve("hybrid_sharded", "serve_hybrid", serve,
                           serve_hybrid_argv(device, smoke), device, sharded)
        out["serve"] = d
    finally:
        dist.destroy_process_group()
    out["launches"] = {n: tr["launches"][n] + d["launches"][n]
                       for n in COUNTERS}
    emit("hybrid_sharded", **out)
    return out


#: serve_long: long_500k's positions, prefill_32k's prompt, decode steps
LONG_POSITIONS = 524288
LONG_PROMPT = 32768
LONG_STEPS = 16
#: what a 32768-token hybrid prefill's activations and logits may take
#: beside the params and the cache (its logits alone 2.1 GB in bf16)
LONG_WORKSPACE = 12e9
#: serve_long_mla: deepseek_v2_236b's published 128K context
#: (arXiv:2405.04434), prefill_32k's prompt, ``LONG_STEPS`` decode steps
MLA_LONG_POSITIONS = 131072
#: what a 32768-token MLA prefill may take beside the params and the
#: cache: the per-head q, K and V (1.6, 1.6 and 1.1 GB in bf16), the
#: expert buffers (2.5 GB) and the logits (6.7 GB in bf16)
MLA_LONG_WORKSPACE = 32e9


@contextlib.contextmanager
def seq_split_forced():
    """The sharded runtime's sharding contexts built inside hold the
    dense serve plane's cache positions split over the data ranks
    (``ShardCtx.seq_split``) whatever the batch.  At (1, 1) a batch of 1
    splits over the one data rank, so the runtime's own rule
    (``plans.seq_splits``: more than one data rank) keeps the positions
    whole; under this the B = 1 runs take the sequence-split path at one
    rank: the slice's offset, the owner-only write of a decode step's
    row, the partial results merged over the data ranks.  A phase's
    override, not an option of the program."""
    from repro_torch.sharding import ctx as shard_ctx
    real = shard_ctx.ShardCtx

    class SeqSplit(real):
        def __init__(self, mesh, dp_axes, model_axis, shards_batch=True,
                     tp=None, local=(), seq_split=False):
            super().__init__(mesh, dp_axes, model_axis, shards_batch=False,
                             tp=tp, local=local, seq_split=True)

    shard_ctx.ShardCtx = SeqSplit
    try:
        yield
    finally:
        shard_ctx.ShardCtx = real


def _long_run(name, job, device, tokens, steps, kinds):
    """One B = 1 serve block of ``job`` on ``device`` (the sharded
    runtime under a process group, on the sequence-split path at its
    one data rank, ``seq_split_forced``; else the unsharded one): a
    prefill of ``tokens`` (its logits kept), ``steps`` captured greedy
    decode steps, then one more decode step run eagerly under the
    block's context for its logits; the launches of the prefill and the
    captured steps, the decode graph, peak memory and a profiled warm
    decode step.  ``kinds``: what the sharded block must compute on the
    tensor-parallel path."""
    import torch.distributed as dist
    from repro_torch.core.block import BlockGrant
    from repro_torch.core.runtime import BlockRuntime
    from repro_torch.models import model
    from repro_torch.models.transformer import flatten
    from repro_torch.serve import serve_step as serve_lib
    from repro_torch.sharding import ctx as shard_ctx
    cfg = job.cfg
    grant = BlockGrant.new([(0, 0, 0)], (1, 1), 3600.0)
    with (seq_split_forced() if dist.is_initialized()
          else contextlib.nullcontext()):
        rt = BlockRuntime(grant, job, devices=[device])
    t0 = time.perf_counter()
    rt.init_state()
    rt._sync()
    init_s = time.perf_counter() - t0
    box, pf = {}, serve_lib.make_prefill_step(cfg)

    def prefill(params, batch, cache):
        logits, cache = pf(params, batch, cache)
        box["logits"] = logits
        return logits, cache
    rt._prefill_fn = prefill
    if rt.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    _zero_eager_calls()
    progress(f"{name}: prefill {tokens.shape[1]} tokens")
    t0 = time.perf_counter()
    rt.prefill({"tokens": tokens})
    rt._sync()
    prefill_s = time.perf_counter() - t0
    pre_launches = counts()
    progress(f"{name}: {steps} decode steps")
    toks = [rt.token]
    t0 = time.perf_counter()
    for _ in range(steps):
        rt.step()
        toks.append(rt.token)
    decode_s = time.perf_counter() - t0
    launches = counts()
    graph = graph_check(name, rt.decode_graph, steps, _eager_calls(),
                        device)
    out = {"init_s": init_s, "prefill_s": prefill_s, "decode_s": decode_s,
           "decode_step_ms": decode_s / steps * 1e3,
           "tokens": [int(t[0, 0]) for t in toks],
           "launches": launches, "launches_prefill": pre_launches,
           "decode_graph": graph, "cache_len": rt.cache_len,
           "seq_split": bool(rt.ctx is not None and rt.ctx.seq_split),
           "sharded": rt.mesh is not None}
    if rt.mesh is not None:
        out["tp"] = rt.tp.summary()
        out["cache_positions_a_rank"] = sorted(
            {t.shape[-2] if p.split("/")[-1] in ("c_kv", "k_rope")
             else t.shape[-3] for p, t in flatten(rt.cache)
             if p.split("/")[-1] in ("k", "v", "c_kv", "k_rope")})
        check(all(rt.tp.computes(k) for k in kinds) and rt.tp.kept == ()
              and out["seq_split"],
              f"{name}: not on the tensor-parallel and sequence-split "
              f"paths, {rt.tp}, seq_split {out['seq_split']}")
    if rt.device.type == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    saved = counts()
    with torch.no_grad(), shard_ctx.use(rt.ctx):
        lg, _ = model.decode_step(rt.state["params"], cfg, rt.token,
                                  rt.cache, rt.cache_len)
    # in their own dtype: a 32768-token prefill's logits are 6.7 GB in
    # bf16 at deepseek_v2's vocabulary
    out["logits_digests"] = {"prefill": digest(box["logits"]),
                             "eager_step": digest(lg)}
    out["logits_finite"] = bool(torch.isfinite(lg).all()
                                and torch.isfinite(box["logits"]).all())
    if rt.device.type == "cuda":
        rt.cache_len += 1
        out["warm_decode_step"] = profile_steps(rt.step, 2)
    set_counts(saved)
    rt.release()
    del rt, box
    return out


def _long_phase(name, cfg, device, smoke, *, P, steps, smax, workspace,
                launches, kinds, attention_check, int32, dry_args):
    """A B = 1 long-context serve phase (``serve_long``,
    ``serve_long_mla``): a cache of ``smax`` positions (halved to the
    largest power of two that fits beside ``workspace`` if the card's
    free memory does not hold it, the cut printed), a ``P``-token
    prefill and ``steps`` captured greedy decode steps, first on the
    unsharded ``BlockRuntime``, then through the sharded runtime at
    (1, 1) under a process group of one rank (NCCL; every join a no-op
    at one rank) on the sequence-split path (``seq_split_forced``): the
    tokens, the prefill's logits and one more eager decode step's bit
    for bit the unsharded run's, the launches exactly one prefill's and
    the captured steps' (``launches``: one prefill's and one decode
    step's).  Then ``attention_check(cfg, smax, dev)``.  Printed: the
    decode step's wall and device ms against its bound (the params and
    the whole cache read once at the memory rate: the step masks, not
    skips, the positions past ``cache_len``), the peak memory against
    the dry run's computed state and peak for the same cell at (1, 1)
    (``python -m repro_torch.launch.dryrun`` with ``dry_args`` in a CPU
    subprocess started first), and the largest tensor each kernel of
    the path takes against 2^31 elements (``int32(cfg, P)``)."""
    import torch.distributed as dist
    from repro_torch import device as device_lib
    from repro_torch.core.runtime import JobSpec
    from repro_torch.data import pipeline
    from repro_torch.models import model
    from repro_torch.models.config import ShapeConfig
    dev = torch.device(device)
    params_b = tree_bytes(model.abstract_params(cfg))

    def cache_b(n):
        return tree_bytes(model.init_cache(cfg, 1, n, "meta"))

    free = (torch.cuda.mem_get_info()[0] if dev.type == "cuda"
            else float("inf"))
    want = smax
    while params_b + cache_b(smax) + workspace > free and smax > P * 2:
        smax //= 2
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "batch": 1,
           "positions": smax, "positions_wanted": want,
           "cut": smax != want, "prompt_len": P, "decode_steps": steps,
           "params_gb": params_b / 1e9, "cache_gb": cache_b(smax) / 1e9,
           "free_gb_at_start": free / 1e9, "card": _CARD}
    # the dry run of the same cell at (1, 1), on the CPU beside the card
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--kind",
           "decode", "--seq-len", str(smax), "--global-batch", "1",
           "--mesh-shape", "1,1"] + dry_args + (["--smoke"] if smoke
                                                else [])
    dry = subprocess.Popen(
        cmd, env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                      PYTHONPATH=os.path.join(ROOT, "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    try:
        job = JobSpec(cfg, ShapeConfig(name, "serve", seq_len=smax,
                                       global_batch=1), kind="serve",
                      seed=0)
        tokens = torch.as_tensor(pipeline.synthetic_batch(
            cfg, ShapeConfig("p", "prefill", seq_len=P, global_batch=1),
            step=0, seed=0)["tokens"], device=dev)
        plain = _long_run(f"{name} unsharded", job, device, tokens, steps,
                          kinds)
        _free(device)
        device_lib.init_distributed(device, store=dist.HashStore(),
                                    rank=0, world_size=1)
        try:
            mesh = _long_run(name, job, device, tokens, steps, kinds)
        finally:
            dist.destroy_process_group()
        _free(device)
        for key in ("tokens", "logits_digests", "launches"):
            out[f"{key}_equal_unsharded"] = mesh[key] == plain[key]
            check(out[f"{key}_equal_unsharded"],
                  f"{name}: the sharded run's {key} differ from the "
                  f"unsharded run's")
        check(mesh["logits_finite"] and mesh["sharded"]
              and not plain["sharded"] and mesh["seq_split"]
              and not plain["seq_split"], f"{name}: logits or runs")
        pre, dec = launches
        if dev.type != "cuda":
            pre = dec = {n: 0 for n in COUNTERS}
        check(mesh["launches_prefill"] == pre and mesh["launches"] == {
            n: pre[n] + steps * dec[n] for n in COUNTERS},
              f"{name} launches {mesh['launches']}: not one prefill "
              f"and {steps} decode steps")
        out["unsharded"], out["sharded"] = plain, mesh
        out["launches"] = {n: plain["launches"][n] + mesh["launches"][n]
                           for n in COUNTERS}
        # the decode step's bound: the params and the whole cache read
        nbytes = params_b + cache_b(smax)
        out["decode_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        out["decode_bytes"] = nbytes
        if dev.type == "cuda":
            w = mesh["warm_decode_step"]
            out["decode_wall_ms"], out["decode_device_ms"] = (
                w["wall_ms"], w["device_ms"])
        out["attention_check"] = attention_check(cfg, smax, dev)
        out["int32"] = int32(cfg, P)
        check(all(v["elements"] < 2 ** 31 for v in out["int32"].values()),
              f"{name}: a kernel's tensor past 2^31 elements "
              f"{out['int32']}")
    finally:
        try:
            so, se = dry.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            dry.kill()
            so, se = dry.communicate()
    lines = [x for x in so.splitlines() if x.startswith("{")]
    check(dry.returncode == 0 and bool(lines),
          f"{name} dryrun: exit {dry.returncode}: {se[-2000:]}")
    line = json.loads(lines[-1])
    check(line.get("status") == "ok", f"{name} dryrun: {line}")
    out["dryrun"] = {"state_gb": line["memory"]["state_bytes"] / 1e9,
                     "peak_gb": line["memory"]["peak_bytes_per_device"]
                     / 1e9, "cache": line["cache"], "gaps": line["gaps"],
                     "step_s": line["roofline"]["step_time_s"]}
    emit(name, **out)
    return out


def phase_serve_long(device="cuda", smoke=False):
    """zamba2_2p7b at full width, B = 1, on long_500k's cache (item 8g,
    part 3; ``_long_phase``): a cache of ``LONG_POSITIONS`` positions
    (48.3 GB of K/V in bf16 beside 4.0 GB of params), a
    ``LONG_PROMPT``-token prefill (prefill_32k's length) and
    ``LONG_STEPS`` captured greedy decode steps, unsharded, then on the
    sharded runtime's sequence-split path at one data rank; then the
    chunked ``decode_attention`` (``ops.DECODE_CHUNK`` positions a
    chunk) against the whole softmax in one chunk on one layer's
    full-size cache, every position valid (rtol ``LONG_RTOL`` in
    fp32)."""
    import repro_torch.configs as configs
    cfg = (configs.get_smoke("zamba2_2p7b") if smoke
           else configs.get("zamba2_2p7b"))
    P, steps = (24, 4) if smoke else (LONG_PROMPT, LONG_STEPS)
    return _long_phase(
        "serve_long", cfg, device, smoke, P=P, steps=steps,
        smax=64 if smoke else LONG_POSITIONS, workspace=LONG_WORKSPACE,
        launches=hybrid_launches(cfg), kinds=("attn", "mamba"),
        attention_check=_long_attention_check, int32=_long_int32,
        dry_args=["--arch", "zamba2_2p7b", "--shape", "long_500k"])


def phase_serve_long_mla(device="cuda", smoke=False):
    """deepseek_v2_236b at full width cut to ``MOE_TRAIN_LAYERS`` of its
    60 layers (train_moe's cut; 17.99 GB of params), B = 1, on a cache
    of ``MLA_LONG_POSITIONS`` positions, its published 128K context
    (0.30 GB of compressed cache at 2 layers), through ``_long_phase``
    (item 8g, part 2): a ``LONG_PROMPT``-token prefill and
    ``LONG_STEPS`` captured greedy decode steps, unsharded, then on the
    sharded runtime at (1, 1), MLA's heads on the tensor-parallel path
    and its compressed cache on the sequence-split path at one data
    rank; then the absorbed decode's attention over four slices of one
    layer's full-size compressed cache merged as the data ranks merge
    them, against the whole softmax (``_long_mla_attention_check``)."""
    import repro_torch.configs as configs
    cfg = (configs.get_smoke("deepseek_v2_236b") if smoke
           else configs.get("deepseek_v2_236b").replace(
               n_layers=MOE_TRAIN_LAYERS))
    P, steps = (24, 4) if smoke else (LONG_PROMPT, LONG_STEPS)
    pre, dec, _ = dense_launches(cfg)
    return _long_phase(
        "serve_long_mla", cfg, device, smoke, P=P, steps=steps,
        smax=64 if smoke else MLA_LONG_POSITIONS,
        workspace=MLA_LONG_WORKSPACE, launches=(pre, dec),
        kinds=("attn", "experts", "shared", "vocab"),
        attention_check=_long_mla_attention_check, int32=_long_mla_int32,
        dry_args=["--arch", "deepseek_v2_236b", "--shape", "long_128k",
                  "--n-layers", str(cfg.n_layers)])


#: the chunked decode attention against the whole softmax, in fp32
LONG_RTOL = 1e-5


def _long_attention_check(cfg, smax, dev):
    """``ops.decode_attention`` over one layer's full-size cache, every
    position valid, in chunks of ``ops.DECODE_CHUNK`` against one chunk
    (the whole softmax), on the same bf16 inputs: the fp32 partial
    results (normalised output and log-sum-exp) within ``LONG_RTOL``."""
    from repro_torch.kernels import ops
    a = cfg.attention
    g = torch.Generator(device=dev)
    g.manual_seed(23)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(
            torch.bfloat16)
    k = randn(1, smax, a.n_kv_heads, a.head_dim)
    v = randn(1, smax, a.n_kv_heads, a.head_dim)
    q = randn(1, a.n_heads, 1, a.head_dim)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    chunk = min(ops.DECODE_CHUNK, smax // 4)

    def run(c):
        return ops.decode_attention(q, kt, vt, smax, chunk=c, partials=True)
    got, want = run(chunk), run(smax)
    (e_o, r_o), (e_l, r_l) = (close(got[0], want[0], LONG_RTOL),
                              close(got[1], want[1], LONG_RTOL))
    out = {"shape": [1, a.n_heads, a.n_kv_heads, smax, a.head_dim],
           "chunk": chunk, "chunks": -(-smax // chunk),
           "rtol": LONG_RTOL, "max_abs_err": max(e_o, e_l),
           "worst_over_tol": max(r_o, r_l)}
    out["passed"] = out["worst_over_tol"] <= 1
    check(out["passed"], f"serve_long: chunked decode attention {out}")
    if dev.type == "cuda":
        out["ms"] = time_ms(lambda: run(chunk), iters=3, warmup=1)
        out["whole_ms"] = time_ms(lambda: run(smax), iters=3, warmup=1)
        out["bound_ms"] = ((k.numel() + v.numel()) * 2
                           / HBM_BYTES_PER_S * 1e3)
    del k, v, kt, vt, got, want
    return out


def _long_int32(cfg, P):
    """The largest tensor, in elements, each kernel of serve_long's path
    takes (B = 1): the SSD scan's x (P, H, head_dim), flash attention's q
    (H, P, head_dim), the RMSNorm's rows (P, d_inner): each kernel
    indexes its inputs with 32-bit offsets (``csrc/``)."""
    di = cfg.ssm.expand * cfg.d_model
    H = di // cfg.ssm.head_dim
    a = cfg.attention
    sizes = {"ssd_scan": P * H * cfg.ssm.head_dim,
             "flash_attention": P * a.n_heads * a.head_dim,
             "rmsnorm": P * di}
    return {k: {"elements": n, "share_of_2_31": n / 2 ** 31}
            for k, n in sizes.items()}


#: the slices the absorbed decode's attention is split into for its
#: check, as four data ranks hold them
MLA_LONG_SLICES = 4


def _long_mla_attention_check(cfg, smax, dev):
    """``layers.mla_decode_attention`` over one layer's full-size
    compressed cache, every position valid, in ``MLA_LONG_SLICES``
    slices each with its offset, merged as the data ranks merge their
    partial results (``ops.merge_attention``), against one call over
    the whole cache (the reference's whole softmax), on the same bf16
    inputs: the fp32 partial results (normalised output and
    log-sum-exp) within ``LONG_RTOL``."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import mla_decode_attention
    a = cfg.attention
    H, R, Dr = a.n_heads, a.kv_lora_rank, a.qk_rope_head_dim
    scale = 1.0 / math.sqrt(a.head_dim + Dr)
    g = torch.Generator(device=dev)
    g.manual_seed(29)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(
            torch.bfloat16)
    c, r = randn(1, smax, R), randn(1, smax, Dr)
    q_abs, q_rope = randn(1, H, 1, R), randn(1, H, 1, Dr)
    sl = smax // MLA_LONG_SLICES

    def whole():
        return mla_decode_attention(q_abs, q_rope, c, r, smax, scale,
                                    partials=True)

    def merged():
        parts = [mla_decode_attention(
            q_abs, q_rope, c[:, lo:lo + sl], r[:, lo:lo + sl], smax, scale,
            offset=lo, partials=True) for lo in range(0, smax, sl)]
        return ops.merge_attention(torch.stack([p[0] for p in parts]),
                                   torch.stack([p[1] for p in parts]))
    got, want = merged(), whole()
    (e_o, r_o), (e_l, r_l) = (close(got[0], want[0], LONG_RTOL),
                              close(got[1], want[1], LONG_RTOL))
    out = {"shape": [1, H, smax, R, Dr], "slices": MLA_LONG_SLICES,
           "rtol": LONG_RTOL, "max_abs_err": max(e_o, e_l),
           "worst_over_tol": max(r_o, r_l)}
    out["passed"] = out["worst_over_tol"] <= 1
    check(out["passed"], f"serve_long_mla: merged absorbed decode {out}")
    if dev.type == "cuda":
        out["ms"] = time_ms(merged, iters=3, warmup=1)
        out["whole_ms"] = time_ms(whole, iters=3, warmup=1)
        out["bound_ms"] = ((c.numel() + r.numel()) * 2
                           / HBM_BYTES_PER_S * 1e3)
    del c, r, got, want
    return out


def _long_mla_int32(cfg, P):
    """The largest tensor, in elements, each kernel of serve_long_mla's
    path takes (B = 1): flash attention's q and K (H, P, Dn + Dr), the
    RMSNorm's rows (P, d_model); and the expert buffer the three batched
    products read, (E, C, d_model) at the prompt's capacity C, beside
    them: each kernel indexes its inputs with 32-bit offsets
    (``csrc/``)."""
    from repro_torch.models.moe import capacity
    a, m = cfg.attention, cfg.moe
    sizes = {"flash_attention": P * a.n_heads
             * (a.head_dim + a.qk_rope_head_dim),
             "rmsnorm": P * cfg.d_model,
             "expert_buffer": m.n_experts * capacity(P, m) * cfg.d_model}
    return {k: {"elements": n, "share_of_2_31": n / 2 ** 31}
            for k, n in sizes.items()}


MOE_TRAIN_LAYERS = 2


def moe_step0_check(params, cfg, batch):
    """Step 0 with the kernels against ``impl="torch"`` under STEP0_RTOL,
    with the plain run's routing replayed into the kernels' run
    (``RoutingTape``: its expert choices and slots; the gates and the aux
    loss's probabilities from the kernels' run's own router, which so
    keeps its gradient), as ``serve_moe``'s logits are held; the kernels'
    run with its own routing read beside it.  Each run's gradients are
    reduced to their norms before the next starts.  Besides: the choices
    each layer's capacity dropped, and remat's recompute routing as the
    first forward did in all three runs (held)."""
    with RoutingTape() as tape:
        want = step0_reads(params, cfg, batch, "torch")
        plain_dropped = list(tape.dropped)
        tape.set("replay")
        got = step0_reads(params, cfg, batch, "auto")
        tape.set("compare")
        free = step0_reads(params, cfg, batch, "auto")
    check(tape.recompute_changed == 0,
          f"train_moe: remat's recompute moved {tape.recompute_changed} "
          f"routing choices or slots")
    chk = held_within(step0_distance(got, want), STEP0_RTOL,
                      "train_moe step-0 check (the plain run's routing "
                      "replayed)")
    chk.update(routing="the plain run's, replayed",
               recompute_changed=tape.recompute_changed,
               plain_dropped_by_layer=plain_dropped,
               own_routing={**step0_distance(free, want),
                            "tokens_rerouted_by_layer": tape.tokens_changed,
                            "choices_reslotted_by_layer":
                                tape.slots_changed,
                            "dropped_by_layer": tape.dropped})
    return chk


def phase_train_moe(device="cuda", smoke=False):
    """deepseek_v2_236b (the moe family with MLA: q_lora 1536, kv_lora
    512, rope 64, flash at head dims 192 | 128; 160 routed experts top-6
    and 2 shared) at full width, cut in depth to ``MOE_TRAIN_LAYERS`` of
    its 60 layers, random bf16 weights from seed 0, int8 AdamW moments,
    2 x 2048 tokens a step, one microbatch, remat, through the training
    launcher's ``run(args, cfg)`` (so through ``ClusterDaemon`` and
    ``BlockRuntime(kind="train")``).  First, before the block and its
    optimizer state exist, step 0 on the launcher's params and first
    batch (``moe_step0_check``; the plain backward's fp32 scores and two
    grad trees would not fit beside the 54 GB of train state); then 6
    steps through the launcher, their launches per step held exactly
    (``train_launches``: per layer 4 RMSNorms and 1 flash at head dim 192
    forward, again in the recompute, 4 and 1 backward; one int8 AdamW a
    leaf; none on a scalar or CUDA-core route); tok/s, steady step, peak
    memory, MFU on the analytic roofline (active params), a profiled
    step after the launcher's run and the share of routing choices the
    capacity dropped at step 0."""
    import repro_torch.configs as configs
    from repro_torch.data import pipeline
    from repro_torch.launch import hlo_analysis
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as model_lib
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.moe import capacity
    arch = "deepseek_v2_236b"
    full = configs.get_smoke(arch) if smoke else configs.get(arch)
    cfg = full if smoke else full.replace(n_layers=MOE_TRAIN_LAYERS)
    seq, steps = (32, 3) if smoke else (2048, 6)
    args = launch_train.parse_args(
        ["--arch", arch, "--steps", str(steps), "--seq-len", str(seq),
         "--global-batch", "2", "--microbatch", "1", "--seed", "0",
         "--log-every", "1", "--device", device]
        + (["--smoke"] if smoke else []))
    shape = ShapeConfig("cli", "train", seq_len=seq, global_batch=2,
                        microbatch=1)
    progress("train_moe: step-0 check")
    t0 = time.perf_counter()
    params = model_lib.Transformer(cfg, None, seed=args.seed, device=device,
                                   requires_grad=True).params
    batch = pipeline.DataIterator(cfg, shape, seed=args.seed,
                                  device=device).batch(0)
    chk = moe_step0_check(params, cfg, batch)
    step0_s = time.perf_counter() - t0
    del params, batch
    _free(device)
    progress(f"train_moe: {steps} steps through the launcher")
    zero_counts()
    res = launch_train.run(args, cfg, state_bits=8)
    launches = counts()
    rt, hist = res["runtime"], res["history"]
    losses = [h["loss"] for h in hist]
    check(len(hist) == steps and all(np.isfinite(losses))
          and all(np.isfinite([h["grad_norm"] for h in hist])),
          f"train_moe: losses {losses}")
    T, K = shape.global_batch * seq, cfg.moe.top_k
    dropped = chk["own_routing"]["dropped_by_layer"]
    # the launcher keeps two steps in flight, so a step's step_s (from
    # its dispatch or the previous step's completion to its own) swings
    # from step to step; their mean is the loop's time a step
    steady = float(np.mean([h["step_s"] for h in hist[1:]]))
    a = cfg.attention
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "reduced": {"n_layers": [full.n_layers, cfg.n_layers]},
           "d_model": cfg.d_model, "n_heads": a.n_heads,
           "qk_head_dim": a.head_dim + a.qk_rope_head_dim,
           "v_head_dim": a.v_dim, "q_lora_rank": a.q_lora_rank,
           "kv_lora_rank": a.kv_lora_rank, "n_experts": cfg.moe.n_experts,
           "top_k": K, "n_shared": cfg.moe.n_shared,
           "params": model_lib.count_params(rt.state["params"]),
           "state_bits": 8, "seq_len": seq,
           "global_batch": shape.global_batch, "microbatch": 1,
           "steps": steps, "step0_s": step0_s, "step0_check": chk,
           "launcher_step0_loss_equals_check":
               losses[0] == chk["own_routing"]["loss"],
           "losses": losses, "grad_norms": [h["grad_norm"] for h in hist],
           "step_s": [h["step_s"] for h in hist], "wall_s": res["wall_s"],
           "tok_s": steps * T / res["wall_s"], "steady_step_s": steady,
           "steady_tok_s": T / steady,
           "capacity_drop": {"capacity": capacity(T, cfg.moe),
                             "choices_per_layer": T * K,
                             "dropped_by_layer": dropped,
                             "dropped_share": sum(dropped)
                             / (T * K * len(dropped))},
           "launches": launches,
           "launches_per_step": {k: c / steps for k, c in launches.items()}}
    want = (train_launches(cfg, shape, rt.job.opt, rt.state["params"])
            if rt.device.type == "cuda" else {n: 0 for n in COUNTERS})
    out["launches_per_step_expected"] = want
    check(out["launches_per_step"] == want,
          f"train_moe launches per step {out['launches_per_step']}, want "
          f"{want}")
    saved = counts()
    if rt.device.type == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["model_flops"] = hlo_analysis.model_step_flops(cfg, shape)
        out["mfu"] = out["model_flops"] / steady / hlo_analysis.PEAK_FLOPS
        out["warm_step"] = profile_steps(rt.step, 1)
    # the host's time to enqueue a step against its wall time, for
    # moe_sharded's beside it
    out["host_probe"] = host_probe(rt)
    set_counts(saved)
    del rt, res
    emit("train_moe", **out)
    return out


def phase_moe_sharded(device="cuda", smoke=False, serve=None, train=None):
    """The moe family with MLA through the sharded runtime (item 8g, part
    2): deepseek_v2_236b under a process group of one rank (NCCL on the
    card, gloo on the CPU; a ``HashStore``), so its blocks run on a
    (1, 1) DeviceMesh with every param a DTensor and the tensor-parallel
    path of MLA's heads, the routed experts, the shared expert and the
    vocabulary at M = 1 (every join a no-op, every leaf's model shard
    the leaf; MLA's down-projections and norms gathered whole, their
    gradients summed over a column of one).  The serve block:
    serve_moe's launcher job (``serve``: 7 layers, 4 x 512 prompt
    tokens, 32 generated, the decode captured), its tokens serve_moe's
    bit for bit, its launches and the graph's launches a replay exactly
    theirs; the prefill's and the first decode step's logits, from the
    block's params under its context, serve_moe's (``logits_digests``)
    bit for bit; the warm replay's wall and device time and the peak
    memory beside serve_moe's.  The train block: train_moe's launcher
    job (``train``: 2 layers, int8 moments, 2 x 2048 tokens, 6 steps),
    its losses and grad norms train_moe's bit for bit and its launches
    per step exactly theirs; the steady step and ``host_probe``'s
    enqueue against train_moe's.  The process group is destroyed at the
    end."""
    import torch.distributed as dist
    import repro_torch.configs as configs
    from repro_torch import device as device_lib
    from repro_torch.launch import train as launch_train
    from repro_torch.sharding import ctx as shard_ctx
    from torch.distributed.tensor import DTensor
    if serve is None:
        serve = phase_serve_moe(device, smoke)
        _free(device)
    if train is None:
        train = phase_train_moe(device, smoke)
        _free(device)
    device_lib.init_distributed(device, store=dist.HashStore(), rank=0,
                                world_size=1)
    out = {"backend": dist.get_backend(), "mesh": [1, 1], "card": _CARD}

    def sharded(rt, what):
        check(rt.mesh is not None and tuple(rt.mesh.mesh.shape) == (1, 1)
              and all(isinstance(t, DTensor)
                      for t in _tensors(rt.state["params"]))
              and rt.tp.model == 1 and rt.tp.kept == ()
              and rt.tp.kinds == {"attn", "experts", "shared", "vocab"}
              and len(rt.tp.partial) == 4,
              f"moe_sharded {what}: not on the tensor-parallel path, "
              f"{rt.tp}")

    try:
        argv, cfg = _moe_serve_argv(device, smoke)
        d = _sharded_serve("moe_sharded", "serve_moe", serve, argv, device,
                           sharded, cfg)
        out["serve"] = d
        _free(device)

        progress("moe_sharded: train")
        targv = ["--arch", "deepseek_v2_236b", "--steps",
                 str(train["steps"]), "--seq-len", str(train["seq_len"]),
                 "--global-batch", "2", "--microbatch", "1", "--seed", "0",
                 "--log-every", "1", "--device", device]
        tcfg = configs.get_smoke("deepseek_v2_236b")
        if smoke:
            targv.append("--smoke")
        else:
            tcfg = configs.get("deepseek_v2_236b").replace(
                n_layers=MOE_TRAIN_LAYERS)
        targs = launch_train.parse_args(targv)
        zero_counts()
        shard_ctx.GATHERED.update(model_bytes=0, tp_leaves=0)
        tres = launch_train.run(targs, tcfg, state_bits=8)
        tl = counts()
        trt, hist = tres["runtime"], tres["history"]
        sharded(trt, "train")
        n = len(hist)
        t = {"losses": [h["loss"] for h in hist],
             "grad_norms": [h["grad_norm"] for h in hist],
             "step_s": [h["step_s"] for h in hist],
             "steady_step_s": float(np.mean([h["step_s"]
                                             for h in hist[1:]])),
             "launches": tl,
             "launches_per_step": {k: c / n for k, c in tl.items()},
             "tp": tp_summary(
                 trt.tp, shard_ctx.GATHERED["model_bytes"] / n,
                 trt.tp.step_bytes(1, remat=True, backward=True),
                 shard_ctx.GATHERED["tp_leaves"] / n)}
        check(t["tp"]["model_bytes_a_step"] == 0
              and t["tp"]["tp_leaves"] > 0, f"moe_sharded train: {t['tp']}")
        for key in ("losses", "grad_norms", "launches_per_step"):
            t[f"{key}_equal_train_moe"] = t[key] == train[key]
            check(t[f"{key}_equal_train_moe"],
                  f"moe_sharded train: {key} {t[key]}, train_moe's "
                  f"{train[key]}")
        t["train_moe_steady_step_s"] = train["steady_step_s"]
        saved = counts()
        if trt.device.type == "cuda":
            t["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
            t["train_moe_peak_mem_gb"] = train["peak_mem_gb"]
        # the host time the DTensor calls add: enqueue against wall
        t["host_probe"] = host_probe(trt)
        t["train_moe_host_probe"] = train["host_probe"]
        set_counts(saved)
        out["train"] = t
        del tres, trt
    finally:
        dist.destroy_process_group()
    out["launches"] = {k: d["launches"][k] + tl[k] for k in COUNTERS}
    emit("moe_sharded", **out)
    return out


def xlstm_step0_check(params, cfg, batch):
    """``step0_upcast_check`` with the bf16 step 0 read beside the fp32
    one and not held: the random-weight xlstm's recurrent stack carries a
    kernel's one-bf16-step differences far (the plain bf16 step 0 itself
    lies 1.2% from the fp32 one in the grad norm and 4.0% in its farthest
    leaf, the kernels' 1.8% and 5.8%, read on the H100; ``serve_xlstm``
    reads the same in its logits), so the fp32 step 0 holds the path and
    the kernels' bf16 instantiations are held element by element at the
    xlstm's shapes in the kernels phase."""
    return step0_upcast_check(params, cfg, batch, hold_bf16=False)


#: xlstm_350m's layers in ``train_xlstm`` (and ``xlstm_sharded``'s train
#: block): all 24, its three groups of 7 mLSTM blocks and 1 sLSTM, since
#: the sLSTM recurrence is one kernel launch a layer (it was cut to one
#: group while a Python loop of one step a position paced the step)
XLSTM_TRAIN_LAYERS = 24


def _train_xlstm_setup(smoke):
    """train_xlstm's job: xlstm_350m at full width cut to
    ``XLSTM_TRAIN_LAYERS`` of its 24 layers, 4 x 2048 tokens a step (the
    smoke config whole, 2 x 32), one microbatch, fp32 moments."""
    import repro_torch.configs as configs
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train.optimizer import OptConfig
    cfg = (configs.get_smoke("xlstm_350m") if smoke
           else configs.get("xlstm_350m").replace(
               n_layers=XLSTM_TRAIN_LAYERS))
    shape = ShapeConfig("chip", "train", seq_len=32 if smoke else 2048,
                        global_batch=2 if smoke else 4, microbatch=1)
    opt_cfg = OptConfig(state_bits=None, warmup_steps=2, total_steps=100)
    return cfg, shape, opt_cfg


def phase_train_xlstm(device="cuda", smoke=False):
    """xlstm_350m at full size, ``XLSTM_TRAIN_LAYERS`` (all 24) layers
    (random bf16 weights from seed 0), fp32 AdamW moments, 4 x 2048
    tokens a step, one microbatch, remat: step 0 in fp32 (the weights
    upcast) against ``impl="torch"`` under STEP0_RTOL and the bf16 step
    0 beside it (``xlstm_step0_check``); 3 steps, their launches per
    step held exactly (``train_launches``: 97 RMSNorms forward with the
    recompute, 49 backward, 6 sLSTM recurrences forward and 3 backward,
    18 fp32 AdamW of which 3 on the scalar route, no flash), the last of
    them profiled; tok/s, MFU and peak memory."""
    import repro_torch.configs as configs
    cfg, shape, opt_cfg = _train_xlstm_setup(smoke)
    full = cfg if smoke else configs.get("xlstm_350m")

    def after(rt, out):
        out["reduced"] = {"n_layers": [full.n_layers, cfg.n_layers]}
        return rt

    return _train_phase("train_xlstm", cfg, shape, opt_cfg, device,
                        n_steps=2 if smoke else 3, profile="last",
                        step0=xlstm_step0_check, after=after)


#: xlstm_sharded's train steps before its ``host_probe`` step: with the
#: probe, train_xlstm's first two
XLSTM_SHARDED_STEPS = 1


def phase_xlstm_sharded(device="cuda", smoke=False, train=None,
                        serve=None):
    """The xLSTM family through the sharded runtime (item 8g, last part):
    xlstm_350m under a process group of one rank (NCCL on the card, gloo
    on the CPU; a ``HashStore``), so its blocks run on a (1, 1)
    DeviceMesh with every param a DTensor and the tensor-parallel path
    of its mLSTM and sLSTM heads, the sLSTM's feed-forward and the tied
    vocabulary at M = 1 (every join a no-op, every leaf's model shard
    the leaf).  The train block: train_xlstm's job (``train``: 24
    layers, fp32 moments, 4 x 2048 tokens), XLSTM_SHARDED_STEPS steps, their
    launches per step exactly train_xlstm's, then one ``host_probe``
    step (its enqueue against its wall time, a warm step); every step's
    loss and grad norm train_xlstm's bit for bit.  The serve block:
    serve_xlstm's job through the launcher (``serve``: 4 x 2048 prompt
    tokens, 32 generated, the decode captured), its tokens serve_xlstm's
    bit for bit, its launches and the graph's launches a replay exactly
    theirs; the prefill's and the first decode step's logits, from the
    block's params under its context, serve_xlstm's (``logits_digests``)
    bit for bit.  The process group is destroyed at the end."""
    import torch.distributed as dist
    from repro_torch import device as device_lib
    from repro_torch.sharding import ctx as shard_ctx
    from torch.distributed.tensor import DTensor
    if train is None:
        train = phase_train_xlstm(device, smoke)
        _free(device)
    if serve is None:
        serve = phase_serve_xlstm(device, smoke)
        _free(device)
    device_lib.init_distributed(device, store=dist.HashStore(), rank=0,
                                world_size=1)
    out = {"backend": dist.get_backend(), "mesh": [1, 1], "card": _CARD}
    n = min(XLSTM_SHARDED_STEPS, train["steps"] - 1)

    def sharded(rt, what):
        check(rt.mesh is not None and tuple(rt.mesh.mesh.shape) == (1, 1)
              and all(isinstance(t, DTensor)
                      for t in _tensors(rt.state["params"]))
              and rt.tp.model == 1 and rt.tp.kept == ()
              and rt.tp.kinds == {"mlstm", "slstm", "slstm_ff", "vocab"},
              f"xlstm_sharded {what}: not on the tensor-parallel path, "
              f"{rt.tp}")

    try:
        cfg, shape, opt_cfg = _train_xlstm_setup(smoke)
        shard_ctx.GATHERED.update(model_bytes=0, tp_leaves=0)

        def after(rt, o):
            sharded(rt, "train")
            o["tp"] = tp_summary(
                rt.tp, shard_ctx.GATHERED["model_bytes"] / len(o["losses"]),
                rt.tp.step_bytes(shape.microbatch, remat=True,
                                 backward=True),
                shard_ctx.GATHERED["tp_leaves"] / len(o["losses"]))
            check(o["tp"]["model_bytes_a_step"] == 0
                  and o["tp"]["tp_leaves"] > 0,
                  f"xlstm_sharded train: {o['tp']}")
            o["tp"]["over_model"] = exchange_figures("xlstm_350m", 4)
            key = "launches_per_step"
            o[f"{key}_equal_train_xlstm"] = o[key] == train[key]
            check(o[f"{key}_equal_train_xlstm"],
                  f"xlstm_sharded train: {key} {o[key]}, train_xlstm's "
                  f"{train[key]}")
            # the host time the DTensor calls add: enqueue against wall,
            # a warm step, held as the steps before it
            o["host_probe"] = probe = host_probe(rt, 1)
            o["warm_step_s"] = probe["wall_ms"][0] / 1e3
            for key in ("losses", "grad_norms"):
                got = o[key] + probe[key]
                o[f"{key}_equal_train_xlstm"] = \
                    got == train[key][:len(got)]
                check(o[f"{key}_equal_train_xlstm"],
                      f"xlstm_sharded train: {key} {got}, train_xlstm's "
                      f"{train[key][:len(got)]}")
            return rt

        tr = _train_phase("xlstm_sharded_train", cfg, shape, opt_cfg,
                          device, n_steps=n, profile=False, step0=None,
                          after=after)
        out["train"] = {k: tr[k] for k in (
            "losses", "grad_norms", "step_s", "warm_step_s", "host_probe",
            "launches_per_step", "tp",
            "losses_equal_train_xlstm", "grad_norms_equal_train_xlstm",
            "launches_per_step_equal_train_xlstm")}
        if "peak_mem_gb" in tr:
            out["train"]["peak_mem_gb"] = tr["peak_mem_gb"]
            out["train"]["train_xlstm_peak_mem_gb"] = train["peak_mem_gb"]
        out["train"]["train_xlstm_step_s"] = train["step_s"]
        out["train"]["train_xlstm_steady_step_s"] = train["steady_step_s"]
        _free(device)

        d = _sharded_serve("xlstm_sharded", "serve_xlstm", serve,
                           serve_xlstm_argv(device, smoke), device, sharded)
        out["serve"] = d
    finally:
        dist.destroy_process_group()
    out["launches"] = {k: tr["launches"][k] + d["launches"][k]
                       for k in COUNTERS}
    emit("xlstm_sharded", **out)
    return out


# ---------------------------------------------------------------- preempt

def _tensors(tree):
    """The tensors of a nested dict, in sorted-key order (a tuple's, the
    xlstm cache's states, in order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k])
    elif isinstance(tree, tuple):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, torch.Tensor):
        yield tree


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def bit_checksums(tree, chunk: int = 1 << 26):
    """Per-leaf checksums of the raw bits, computed where the leaf lies:
    the sum and a position-weighted sum of its 32-bit words (16- or 8-bit
    where its size is no multiple of 4), in int64 with wraparound."""
    out = []
    for t in _tensors(tree):
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        width = next(w for w in (4, 2, 1) if b.numel() % w == 0)
        words = b.view({4: torch.int32, 2: torch.int16, 1: torch.uint8}[
            width])
        s1 = s2 = torch.zeros((), dtype=torch.int64, device=t.device)
        for o in range(0, words.numel(), chunk):
            w = words[o:o + chunk].to(torch.int64)
            pos = torch.arange(o, o + w.numel(), device=t.device) % 1000003
            s1 = s1 + w.sum()
            s2 = s2 + (w * (pos + 1)).sum()
        out.append((int(s1), int(s2)))
    return out


def _mem(device):
    return (torch.cuda.memory_allocated() if device.type == "cuda"
            else None)


def _ckpt_files(rt):
    """The latest checkpoint's bytes on disk and its leaf count."""
    path = os.path.join(rt.ckpt.dir, f"step_{rt.ckpt.latest_step():08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        n = len(json.load(f)["leaves"])
    return sum(os.path.getsize(os.path.join(path, x))
               for x in os.listdir(path)), n


def _disk_check(root, need, what):
    free = shutil.disk_usage(root).free
    progress(f"preempt {what}: {free / 1e9:.1f} GB free for a "
             f"{need / 1e9:.1f} GB checkpoint")
    check(free >= need + (1 << 30),
          f"preempt {what}: {free / 1e9:.2f} GB free under {root}, the "
          f"checkpoint needs {need / 1e9:.2f} GB and 1 GB to spare")
    return free / 1e9


def _suspend_resume(rt, name, root, base_mem):
    """``suspend()``, the card's memory after it, then ``resume()``: the
    timings, GB/s and memory of the pair; the state's checksums before
    and after are held equal bit for bit."""
    payload = rt._payload()
    state_bytes = tree_bytes(payload)
    free = _disk_check(root, state_bytes, name)
    before = bit_checksums(payload)
    del payload
    lost = rt.progress_lost
    from repro_torch.train import compile_cache
    cache_before = compile_cache.GLOBAL.stats()
    graph = rt.decode_graph
    t0 = time.perf_counter()
    info = rt.suspend()
    suspend_s = time.perf_counter() - t0
    check(graph is None or graph._graph is None,
          f"preempt {name}: suspend() kept the decode graph")
    save_t = dict(rt.ckpt.timings)
    held = _mem(rt.device)
    ckpt_bytes, n_leaves = _ckpt_files(rt)
    out = {"state_gb": state_bytes / 1e9, "ckpt_gb": ckpt_bytes / 1e9,
           "ckpt_leaves": n_leaves, "disk_free_gb": free,
           "progress_lost_before_save": lost,
           "progress_lost_after_save": rt.progress_lost,
           "drained_steps": info["drained_steps"],
           "suspend_s": suspend_s,
           "save_s": save_t["copy_s"] + save_t["write_s"],
           "save_stages_s": save_t}
    if held is not None:
        out["mem_after_suspend_gb"] = (held - base_mem) / 1e9
        out["reserved_after_suspend_gb"] = torch.cuda.memory_reserved() / 1e9
        check(held - base_mem < 0.01 * state_bytes,
              f"preempt {name}: {(held - base_mem) / 1e9:.3f} GB still "
              f"allocated after suspend(), 1% of the state is "
              f"{0.01 * state_bytes / 1e9:.3f} GB")
    t0 = time.perf_counter()
    at = rt.resume(rt.grant, [str(rt.device)])
    rt._sync()
    out["resume_s"] = time.perf_counter() - t0
    out["restore_stages_s"] = dict(rt.ckpt.timings)
    check(at == info["step"], f"preempt {name}: resumed at {at}, suspended "
          f"at {info['step']}")
    cache_after = compile_cache.GLOBAL.stats()
    out["compile_cache"] = {"before_suspend": cache_before,
                            "after_resume": cache_after}
    check(cache_after["misses"] == cache_before["misses"]
          and cache_after["hits"] > cache_before["hits"],
          f"preempt {name}: resume is not a compile-cache hit: "
          f"{out['compile_cache']}")
    after = bit_checksums(rt._payload())
    check(after == before, f"preempt {name}: the resumed state's checksums "
          f"differ from the suspended state's in "
          f"{sum(a != b for a, b in zip(after, before))} of {len(before)} "
          f"leaves")
    out["leaves_bitwise_equal"] = len(before)
    for k in ("save", "suspend", "resume"):
        out[f"{k}_gb_s"] = ckpt_bytes / 1e9 / out[f"{k}_s"]
    return out


def _resumed_graph(name, rt, steps):
    """After resume the block's decode captures again, once, and replays
    every step (on the CPU: runs each eagerly)."""
    st = rt.decode_graph.stats()
    want = ((1, steps, 0) if rt.device.type == "cuda" else (0, 0, steps))
    check((st["captures"], st["replays"], st["eager_calls"]) == want,
          f"preempt {name}: the decode graph after resume {st}, want "
          f"(captures, replays, eager) {want}")
    return {**st, "card": _CARD}


def _block(job, device, root=None):
    from repro_torch.core.block import BlockGrant
    from repro_torch.core.runtime import BlockRuntime
    rt = BlockRuntime(BlockGrant.new([(0, 0, 0)], (1, 1), 3600.0), job,
                      devices=[device], ckpt_root=root)
    if root is not None:
        rt.ckpt.keep = 1            # one checkpoint on disk at a time
    return rt


def _peak(device):
    if device.type == "cuda":
        return torch.cuda.max_memory_allocated() / 1e9
    return None


def _preempt_train(device, smoke, root, train):
    """zamba2_2p7b's train_hybrid job: 3 steps, suspend, resume, a 4th;
    the 4 losses and grad norms are the uninterrupted run's, bit for
    bit, and the resumed step's launches ``train_launches``'."""
    from repro_torch.core.runtime import JobSpec
    cfg, shape, opt_cfg = _train_hybrid_setup(smoke)
    job = JobSpec(cfg, shape, kind="train", opt=opt_cfg, seed=0,
                  ckpt_namespace="train_hybrid")
    n_before = 1 if smoke else 3
    if train is None:                       # the uninterrupted run
        rt = _block(job, device)
        rt.init_state()
        train = {"losses": [], "grad_norms": []}
        for _ in range(n_before + 1):
            m = rt.step()
            train["losses"].append(m["loss"])
            train["grad_norms"].append(m["grad_norm"])
        del rt
        _free(device)
    dev = torch.device(device)
    base = _mem(dev)
    rt = _block(job, device, root)
    rt.init_state()
    hist = [rt.step() for _ in range(n_before)]
    out = _suspend_resume(rt, "train_hybrid", root, base)
    zero_counts()
    hist.append(rt.step())
    launches = counts()
    want = (train_launches(cfg, shape, opt_cfg, rt.state["params"])
            if dev.type == "cuda" else {n: 0 for n in COUNTERS})
    check(launches == want, f"preempt train_hybrid: the resumed step's "
          f"launches {launches}, want {want}")
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    ref = (train["losses"][:n_before + 1], train["grad_norms"][:n_before + 1])
    check((losses, gnorms) == ref,
          f"preempt train_hybrid: losses {losses} and grad norms {gnorms} "
          f"across a suspend, uninterrupted {ref}")
    out.update(arch=cfg.name, n_layers=cfg.n_layers, steps_before=n_before,
               losses=losses, grad_norms=gnorms, uninterrupted_losses=ref[0],
               resumed_step_launches=launches, peak_mem_gb=_peak(dev))
    shutil.rmtree(rt.ckpt.dir)
    return out, launches


# the serve_paged traffic: 12 sessions through 8 slots, each generating
# this many tokens (the second at smoke size)
PAGED_NEW_TOKENS, PAGED_NEW_TOKENS_SMOKE = 32, 6


def _paged_job(smoke, ns=None, cfg=None):
    """serve_paged's job (8 slots, page 16, 1024 positions), on deepseek_7b
    or ``cfg``."""
    import repro_torch.configs as configs
    from repro_torch.core.runtime import JobSpec
    from repro_torch.models.config import ShapeConfig
    if cfg is None:
        cfg = (configs.get_smoke("deepseek_7b") if smoke
               else configs.get("deepseek_7b"))
    max_seq = 64 if smoke else 1024
    return JobSpec(cfg, ShapeConfig("smoke", "serve", seq_len=max_seq,
                                    global_batch=1), kind="serve", seed=0,
                   paged=True, page_size=16, max_slots=8,
                   max_seq_len=max_seq, ckpt_namespace=ns)


def _paged_prompts(cfg, smoke):
    """serve_paged's 12 prompts (17 to 700 tokens; 17 to 40 at smoke
    size)."""
    from repro_torch.data import pipeline
    from repro_torch.models.config import ShapeConfig
    longest = 40 if smoke else 700
    toks = pipeline.synthetic_batch(
        cfg, ShapeConfig("p", "prefill", longest, 12), step=1,
        seed=0)["tokens"]
    lens = np.linspace(17, longest, 12).astype(int)
    return [toks[i, :n].tolist() for i, n in enumerate(lens)]


def _feed(rt, rounds=None):
    ems, n = [], 0
    while not rt.idle_serve and (rounds is None or n < rounds):
        ems.extend(rt.feed())
        n += 1
    return ems, n


def _preempt_paged(device, smoke, root):
    """deepseek_7b's serve_paged traffic (12 sessions through 8 slots,
    greedy), once straight and once suspended after a third of its
    rounds: each session's tokens are the same."""
    job = _paged_job(smoke)
    prompts = _paged_prompts(job.cfg, smoke)
    max_new = PAGED_NEW_TOKENS_SMOKE if smoke else PAGED_NEW_TOKENS
    dev = torch.device(device)

    def start(rt):
        rt.init_state()
        return [rt.start_session(p, max_new_tokens=max_new)
                for p in prompts]

    rt = _block(job, device)
    sids = start(rt)
    want, rounds = _feed(rt)
    want_tokens = {s: rt.sessions.sessions[s].generated for s in sids}
    del rt                                   # released before the fresh one
    _free(device)

    base = _mem(dev)
    rt = _block(_paged_job(smoke, "serve_paged"), device, root)
    start(rt)
    got, _ = _feed(rt, rounds // 3)
    states = [s.state for s in rt.sessions.sessions.values()]
    running, queued = states.count("running"), states.count("queued")
    check(running > 0 and queued > 0, f"preempt serve_paged: suspended "
          f"with {running} sessions running and {queued} queued")
    out = _suspend_resume(rt, "serve_paged", root, base)
    zero_counts()
    rest, n_rest = _feed(rt)
    launches = counts()
    out["decode_graph_after_resume"] = _resumed_graph(
        "serve_paged", rt, n_rest)
    got += rest
    tokens = {s: rt.sessions.sessions[s].generated for s in sids}
    check(tokens == want_tokens, f"preempt serve_paged: tokens across a "
          f"suspend differ in sessions "
          f"{[s for s in sids if tokens[s] != want_tokens[s]]}")
    if dev.type == "cuda":
        check(launches["paged_attention"] > 0
              and launches["flash_attention"] > 0
              and launches["paged_attention_scalar"] == 0,
              f"preempt serve_paged: launches after resume {launches}")
    out.update(arch=job.cfg.name, sessions=len(sids), rounds=rounds,
               suspended_after_rounds=rounds // 3, running=running,
               queued=queued, emissions_equal=got == want,
               launches_after_resume=launches, peak_mem_gb=_peak(dev))
    shutil.rmtree(rt.ckpt.dir)
    return out, launches


def _preempt_hybrid(device, smoke, root):
    """zamba2_2p7b on the dense plane, 4 x 1000 prompt tokens: an async
    save after 4 decode steps while steps 5-8 run, a suspend after 8,
    resume, 8 more; the tokens are 16 uninterrupted steps'."""
    import repro_torch.configs as configs
    from repro_torch.core.runtime import JobSpec
    from repro_torch.data import pipeline
    from repro_torch.models.config import ShapeConfig
    cfg = (configs.get_smoke("zamba2_2p7b") if smoke
           else configs.get("zamba2_2p7b"))
    B, P = (2, 24) if smoke else (4, 1000)
    n1, n2, n3 = (2, 2, 4) if smoke else (4, 4, 8)
    G = n1 + n2 + n3
    job = JobSpec(cfg, ShapeConfig("cli", "serve", seq_len=P + G + 1,
                                   global_batch=B), kind="serve", seed=0,
                  ckpt_namespace="serve_hybrid")
    batch = {"tokens": pipeline.synthetic_batch(
        cfg, ShapeConfig("cli", "prefill", seq_len=P, global_batch=B),
        step=0, seed=0)["tokens"]}
    dev = torch.device(device)

    def decode(rt, n):
        toks, times = [], []
        for _ in range(n):
            m = rt.step()
            times.append(m["step_s"])
            toks.append(rt.token.cpu())
        return toks, times

    rt = _block(job, device)
    rt.init_state()
    rt.prefill(batch)
    want, _ = decode(rt, G)
    del rt
    _free(device)

    base = _mem(dev)
    rt = _block(job, device, root)
    rt.init_state()
    rt.prefill(batch)
    got, t_before = decode(rt, n1)
    _disk_check(root, tree_bytes(rt._payload()), "serve_hybrid async")
    lost_before = rt.progress_lost
    t0 = time.perf_counter()
    rt.save(async_=True)
    save_call_s = time.perf_counter() - t0
    lost_after = rt.progress_lost
    t0 = time.perf_counter()
    toks, t_during = decode(rt, n2)
    during_s = time.perf_counter() - t0
    got += toks
    t0 = time.perf_counter()
    rt.ckpt.wait()
    wait_s = time.perf_counter() - t0
    write_s = rt.ckpt.timings["write_s"]
    delay = during_s - n2 * float(np.median(t_before))
    first_steps = rt.ckpt.steps()
    out = _suspend_resume(rt, "serve_hybrid", root, base)
    check(first_steps == [n1] and rt.ckpt.steps() == [n1 + n2],
          f"preempt serve_hybrid: checkpoints {first_steps} then "
          f"{rt.ckpt.steps()} with keep=1")
    check(rt.cache_len == P + n1 + n2, f"preempt serve_hybrid: cache_len "
          f"{rt.cache_len} after resume")
    zero_counts()
    toks, _ = decode(rt, n3)
    launches = counts()
    out["decode_graph_after_resume"] = _resumed_graph(
        "serve_hybrid", rt, n3)
    got += toks
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "preempt serve_hybrid: tokens across an async save and a suspend "
          "differ from uninterrupted decoding")
    per_step = hybrid_launches(cfg)[1] if dev.type == "cuda" else {}
    want_l = {n: n3 * per_step.get(n, 0) for n in COUNTERS}
    check(launches == want_l, f"preempt serve_hybrid: launches after "
          f"resume {launches}, want {want_l}")
    out.update(arch=cfg.name, batch=B, prompt_len=P,
               decode_steps=[n1, n2, n3],
               async_save={"progress_lost_before": lost_before,
                           "progress_lost_after": lost_after,
                           "call_s": save_call_s,
                           "stages_s": {"copy_s": save_call_s,
                                        "write_s": write_s},
                           "steps_during_s": during_s,
                           "wait_after_steps_s": wait_s,
                           # the write ran beside the steps for overlap_s,
                           # and slowed them by step_delay_s: what it hid
                           # is the difference
                           "overlap_s": write_s - wait_s,
                           "step_delay_s": delay,
                           "hidden_share": (write_s - wait_s - delay)
                           / write_s,
                           "step_s_before": t_before,
                           "step_s_during": t_during},
               checkpoints_kept=rt.ckpt.steps(),
               launches_after_resume=launches, peak_mem_gb=_peak(dev))
    shutil.rmtree(rt.ckpt.dir)
    return out, launches


def phase_preempt(device="cuda", smoke=False, train=None):
    """Checkpoints and preempt/resume at full width, three sub-runs, each
    with its checkpoints under one temporary directory (one at a time,
    ``keep=1``, removed before the next sub-run; the directory goes at
    the end): train_hybrid suspended and resumed between steps 3 and 4
    (``train``: train_hybrid's output, whose 4 steps it must equal; run
    here when not given), serve_paged's 12 sessions suspended after a
    third of their rounds, and serve_hybrid's dense decode with an async
    save and a suspend.  Each sub-run gives its checkpoint's GB and
    leaves, save, suspend and resume seconds and GB/s, progress_lost
    before and after the save, the card's memory after suspend() (held
    under 1% of the state) and peak memory."""
    root = tempfile.mkdtemp(prefix="chip_smoke_preempt_")
    t0 = time.perf_counter()
    out, launches = {}, {n: 0 for n in COUNTERS}
    try:
        for name, run in (("train_hybrid", lambda: _preempt_train(
                               device, smoke, root, train)),
                          ("serve_paged", lambda: _preempt_paged(
                              device, smoke, root)),
                          ("serve_hybrid", lambda: _preempt_hybrid(
                              device, smoke, root))):
            progress(f"preempt: {name}")
            _free(device)
            out[name], got = run()
            launches = {n: launches[n] + got[n] for n in COUNTERS}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = launches
    emit("preempt", **out)
    return out


# ---------------------------------------------------------------- control

#: Alice's step rate until Bob arrives: a dispatch every 2 s, about five
#: train_hybrid steps apart, so Bob's submit lands between her steps and
#: the preemption finds her with exactly half her steps done
CONTROL_PACE_HZ = 0.5
#: the longest the control phase waits for one event of its scenario
CONTROL_TIMEOUT_S = 300.0


def _await(daemon, cond, what):
    """Wait until ``cond()`` holds; fails on a timeout or an engine error
    (the daemon's workers print its traceback and go on)."""
    deadline = time.monotonic() + CONTROL_TIMEOUT_S
    while not cond():
        check(not daemon._engine_error_logged,
              f"control: an engine round raised while waiting for {what}")
        check(time.monotonic() < deadline,
              f"control: no {what} in {CONTROL_TIMEOUT_S:.0f} s")
        time.sleep(0.01)


def _events(log, app_id, kind, **payload):
    return [e for e in list(log) if e.app_id == app_id and e.kind == kind
            and all(e.payload.get(k) == v for k, v in payload.items())]


def phase_control(device="cuda", smoke=False, train=None, paged=None):
    """The paper's scenario on one chip, through ``ClusterDaemon`` in
    background mode (its pump thread serves the commands and the periodic
    tick; an engine worker thread runs the blocks' steps): Alice's train
    block (train_hybrid's job) autosteps toward 4 steps (2 at smoke size),
    paced until Bob arrives; Bob's paged serve block (serve_paged's job)
    is submitted at priority 1 once the bus shows her second step, and the
    scheduler preempts her (drain, a synchronous checkpoint, her memory
    given back) and grants him the chip; his 12 sessions run through
    ``daemon.generate`` and the engine's decode rounds (graph replays);
    his period ends, and the pump's tick expires him and resumes Alice,
    who trains on to her last step.  Held: Alice's losses and grad norms
    are train_hybrid's (``train``) bit for bit, and Bob's tokens
    serve_paged's (``paged``); the bus shows her ``preempted`` (her
    checkpoint at her second step, and both steps counted as what a kill
    without the suspend would have lost), his grant and her ``resumed``,
    in that order; her resume is a
    compile-cache hit with no new miss; while Bob runs, the card holds no
    more than his state, his graph pool and 1% of Alice's state; each
    kernel's launches are exactly her steps', his admissions' and his
    rounds'.  Times come from the events' wall clocks."""
    from repro_torch.core.block import BlockState
    from repro_torch.core.daemon import ClusterDaemon
    from repro_torch.core.runtime import JobSpec
    from repro_torch.core.topology import Topology
    from repro_torch.models import model as model_lib
    if train is None:
        train = phase_train_hybrid(device, smoke)
        _free(device)
    if paged is None:
        paged = phase_serve_paged(device, smoke)
        _free(device)
    cfg, shape, opt_cfg = _train_hybrid_setup(smoke)
    n_steps = len(train["losses"])
    n_before = n_steps // 2
    alice_job = JobSpec(cfg, shape, kind="train", opt=opt_cfg, seed=0,
                        collect_metrics=True)
    bob_job = _paged_job(smoke)
    prompts = _paged_prompts(bob_job.cfg, smoke)
    max_new = PAGED_NEW_TOKENS_SMOKE if smoke else PAGED_NEW_TOKENS
    dev = torch.device(device)
    root = tempfile.mkdtemp(prefix="chip_smoke_control_")
    base = _mem(dev)
    log = []
    daemon = ClusterDaemon(Topology(n_pods=1, pod_x=1, pod_y=1),
                           devices=[device], ckpt_root=root,
                           background=True)
    daemon.bus.subscribe(log.append)
    t0 = time.perf_counter()
    try:
        zero_counts()
        _zero_eager_calls()
        progress("control: alice submits")
        t_alice = time.time()
        alice, grant = daemon.submit("alice", f"train {cfg.name}", 1,
                                     job=alice_job, priority=0)
        check(grant is not None, "control: alice not admitted on a free "
              "chip")
        alice_bytes = tree_bytes(daemon.runtime(alice).state)
        _disk_check(root, alice_bytes, "control")
        daemon.autostep_enable(alice, until_steps=n_steps,
                               max_rate_hz=CONTROL_PACE_HZ)
        _await(daemon, lambda: len(_events(log, alice, "step")) >= n_before,
               f"alice's step {n_before}")

        progress("control: bob submits")
        t_bob = time.time()
        bob, bob_grant = daemon.submit("bob", f"serve {bob_job.cfg.name}",
                                       1, job=bob_job, priority=1)
        check(bob_grant is not None and daemon.registry.get(alice).state
              == BlockState.PREEMPTED,
              f"control: bob {bob_grant}, alice "
              f"{daemon.registry.get(alice).state}")
        daemon.autostep_pace(alice, None)      # unpaced once she resumes
        sids = [daemon.generate(bob, p, max_new_tokens=max_new)
                for p in prompts]
        daemon.autostep_enable(bob)
        _await(daemon, lambda: len(_events(
            log, bob, "session", action="finished")) == len(sids),
            "the end of bob's sessions")
        held = _mem(dev)
        rt = daemon.runtime(bob)
        sch = rt.sessions
        bob_bytes = tree_bytes(rt.state) + tree_bytes(sch.pool)
        graph = sch.decode_graph.stats()
        tokens = {s: list(sch.sessions[s].generated) for s in sids}
        admissions = sch.admissions
        del rt, sch
        progress("control: bob's period ends")
        daemon.registry.get(bob).grant.expires_at = time.time()
        _await(daemon, lambda: _events(log, alice, "autostep",
                                       action="done"),
               "alice's last step")
        launches = counts()
        elapsed = time.perf_counter() - t0
        mfu = daemon.monitor.mfu(grant.block_id)
        roofline = daemon.monitor.roofline_report()["blocks"][
            grant.block_id]
        daemon.expire(alice)
    finally:
        daemon.stop()
        shutil.rmtree(root, ignore_errors=True)

    # Alice: her losses and grad norms across the preemption
    steps = _events(log, alice, "step")
    losses = [e.payload["metrics"]["loss"] for e in steps]
    gnorms = [e.payload["metrics"]["grad_norm"] for e in steps]
    check((losses, gnorms) == (train["losses"], train["grad_norms"]),
          f"control: alice's losses {losses} and grad norms {gnorms} "
          f"through the daemon, train_hybrid's {train['losses']} and "
          f"{train['grad_norms']}")
    # Bob: the direct run's tokens, session by session
    want = paged["session_tokens"]
    check(tokens == want, f"control: bob's tokens differ from "
          f"serve_paged's in sessions "
          f"{[s for s in sids if tokens[s] != want.get(s)]}")
    # the bus: her preemption, his grant, her resume
    pre = _events(log, alice, "preempted")
    granted = _events(log, bob, "state", state="approved")
    res = _events(log, alice, "resumed")
    check(len(pre) == len(granted) == len(res) == 1
          and pre[0].seq < granted[0].seq < res[0].seq,
          f"control: events preempted {pre}, granted {granted}, resumed "
          f"{res}")
    pre, res = pre[0], res[0]
    check(pre.payload["checkpoint_step"] == n_before
          and pre.payload["progress_lost_steps"] == n_before
          and res.payload["step"] == n_before,
          f"control: alice preempted {pre.payload}, resumed "
          f"{res.payload}")
    check(daemon.registry.get(bob).state == BlockState.EXPIRED,
          f"control: bob {daemon.registry.get(bob).state}")
    # her resume is a compile-cache hit
    comp = [e.payload["action"] for e in list(log) if e.kind == "compile"
            and e.block_id == grant.block_id and e.seq > pre.seq]
    check("miss" not in comp and "hit" in comp,
          f"control: alice's compile-cache events after her preemption "
          f"{comp}")
    # memory while Bob runs
    if held is not None:
        limit = bob_bytes + graph["pool_mb"] * 2 ** 20 + 0.01 * alice_bytes
        check(held - base < limit,
              f"control: {(held - base) / 1e9:.3f} GB allocated while bob "
              f"runs, his state {bob_bytes / 1e9:.3f} GB, graph pool "
              f"{graph['pool_mb']:.0f} MB, 1% of alice's "
              f"{0.01 * alice_bytes / 1e9:.3f} GB")
    # launches: her steps, his admissions and rounds
    rounds = graph["replays"] if dev.type == "cuda" else graph["eager_calls"]
    zero = {n: 0 for n in COUNTERS}
    per_step, pre_l, per_round = zero, zero, zero
    if dev.type == "cuda":
        check(graph["captures"] == 1 and graph["eager_calls"] == 0
              and _eager_calls() == 0,
              f"control: bob's decode graph {graph}, {_eager_calls()} "
              f"eager decode steps")
        per_step = train_launches(cfg, shape, opt_cfg,
                                  model_lib.abstract_params(cfg))
        pre_l, _, per_round = dense_launches(bob_job.cfg)
    want = {n: n_steps * per_step[n] + admissions * pre_l[n]
            + rounds * per_round[n] for n in COUNTERS}
    check(launches == want, f"control: launches {launches}, want {want} "
          f"({n_steps} train steps, {admissions} admissions, {rounds} "
          f"rounds)")

    def t_of(evs):
        check(bool(evs), "control: an event the timing needs is missing")
        return evs[0].t

    def state_t(app_id, state):
        return t_of(_events(log, app_id, "state", state=state))

    b_steps = _events(log, bob, "step")
    gen = _events(log, bob, "generate")
    bob_enabled = t_of(_events(log, bob, "autostep", action="enabled"))
    alice_tokens = shape.global_batch * shape.seq_len
    step_s = [e.payload["step_s"] for e in steps]
    out = {
        "alice": {"arch": cfg.name, "n_layers": cfg.n_layers,
                  "steps": n_steps, "preempted_after": n_before,
                  "losses": losses, "grad_norms": gnorms,
                  "state_gb": alice_bytes / 1e9, "step_s": step_s,
                  # each step from its dispatch or its predecessor's end,
                  # whichever is later: their sum is the serial chain's
                  # busy time, the first step and the one after resume
                  # included, as the direct run's tok_s includes its first
                  "tok_s_in_daemon": n_steps * alice_tokens / sum(step_s),
                  "tok_s_direct": train["tok_s"],
                  "steady_step_s_direct": train["steady_step_s"],
                  "mfu": mfu, "roofline": roofline},
        "bob": {"arch": bob_job.cfg.name, "sessions": len(sids),
                "max_new_tokens": max_new, "admissions": admissions,
                "rounds": rounds, "tokens": len(gen),
                "decode_graph": graph,
                "state_gb": bob_bytes / 1e9,
                # from the engine's start on his sessions, as the direct
                # run's from their submission
                "tok_s_in_daemon": len(gen) / (gen[-1].t - bob_enabled),
                "tok_s_direct": paged["tok_s"]},
        "events": {"preempted": pre.payload, "resumed": res.payload,
                   "compile_after_preempt": comp},
        # the events' wall clocks (an "admitted" event carries its
        # submission's time, so a grant is its "approved" state event)
        "seconds": {
            "alice_submit_to_grant": state_t(alice, "approved") - t_alice,
            "alice_activation": state_t(alice, "active")
            - state_t(alice, "approved"),
            "alice_grant_to_first_step": t_of(steps)
            - state_t(alice, "approved"),
            "bob_submit_to_grant": state_t(bob, "approved") - t_bob,
            # Bob's submit to Alice's requeue, right after her suspend
            # (her "preempted" events carry the submission's time)
            "alice_suspend": t_of(_events(log, alice, "enqueued",
                                          preempted=True)) - t_bob,
            "bob_activation": state_t(bob, "active")
            - state_t(bob, "approved"),
            "bob_grant_to_first_step": t_of(b_steps)
            - state_t(bob, "approved"),
            "bob_enable_to_first_step": t_of(b_steps) - bob_enabled,
            "bob_submit_to_first_token": t_of(gen) - t_bob,
            "bob_expiry_to_alice_resumed": res.t - state_t(bob, "expired"),
            "bob_expiry_to_alice_step": t_of(
                [e for e in steps if e.seq > res.seq])
            - state_t(bob, "expired"),
            "phase": elapsed},
        "launches": launches, "card": _CARD}
    if held is not None:
        out["mem_while_bob_gb"] = (held - base) / 1e9
        out["mem_limit_gb"] = limit / 1e9
    out["overhead_us_per_step"] = control_overhead()
    emit("control", **out)
    return out


def control_overhead(n: int = 2000) -> dict:
    """The control plane's own host time per step, in microseconds: a
    block whose steps take no time (``SimJobSpec(step_s=0)``), stepped
    ``n`` times by ``run_steps`` and by inline engine rounds, every step
    through the window, the bus and the Monitor as a real block's."""
    from repro_torch.core.block import BlockState
    from repro_torch.core.daemon import ClusterDaemon
    from repro_torch.core.runtime import SimJobSpec
    from repro_torch.core.topology import Topology
    out = {}
    for driver in ("run_steps", "autostep"):
        root = tempfile.mkdtemp(prefix="chip_smoke_overhead_")
        try:
            d = ClusterDaemon(Topology(n_pods=1, pod_x=1, pod_y=1),
                              devices=["cpu"], ckpt_root=root)
            app, _ = d.submit("sim", "overhead", 1,
                              job=SimJobSpec(step_s=0.0))
            t0 = time.perf_counter()
            if driver == "run_steps":
                d.run_steps({app: n})
            else:
                d.autostep_enable(app, until_steps=n)
                while d.registry.get(app).state != BlockState.DONE:
                    d.autostep_round()
            out[driver] = (time.perf_counter() - t0) / n * 1e6
            check(d.runtime(app).step_count == n,
                  f"control overhead: {driver} ran "
                  f"{d.runtime(app).step_count} of {n} steps")
        finally:
            shutil.rmtree(root, ignore_errors=True)
    return out



# ---------------------------------------------------------------- gateway

#: the gateway phase's session profiles: user, token, priority, admin
GATEWAY_USERS = (("alice", "tok-alice", 0, False),
                 ("bob", "tok-bob", 1, False),
                 ("root", "tok-root", 0, True))
#: the event kinds root's SSE feed subscribes to for the whole phase
GATEWAY_KINDS = ("state", "admitted", "preempted", "resumed", "enqueued",
                 "step", "session", "generate", "autostep", "compile")
#: the longest one HTTP call or stream of the gateway phase may take
GATEWAY_TIMEOUT_S = 300.0


class StrictJSON:
    """Stands in for ``json`` in the gateway's server and handler modules
    while the gateway phase runs: ``dumps`` ignores the ``default=str``
    they pass, so a value JSON cannot encode (a tensor in an event
    payload, a status dict or a download) raises where the modules would
    have sent it as the string ``"tensor(...)"``; failures are kept."""

    def __init__(self):
        self.encoded = 0
        self.failures = []

    def dumps(self, obj, default=None, **kw):
        try:
            out = json.dumps(obj, **kw)
        except TypeError as e:
            self.failures.append(repr(e))
            raise
        self.encoded += 1
        return out

    def __getattr__(self, name):
        return getattr(json, name)


class HttpClient:
    """HTTP to the gateway, from any thread: JSON calls and SSE streams
    through ``urllib``; every decoded body and frame is kept for the
    strict-JSON hold, and requests and frames are counted."""

    def __init__(self, url):
        import threading
        self.url = url
        self.lock = threading.Lock()
        self.bodies = []
        self.requests = 0
        self.frames = 0

    def _open(self, method, path, token, body):
        import urllib.request
        r = urllib.request.Request(
            self.url + path, method=method,
            data=None if body is None else json.dumps(body).encode())
        if token:
            r.add_header("Authorization", f"Bearer {token}")
        with self.lock:
            self.requests += 1
        return urllib.request.urlopen(r, timeout=GATEWAY_TIMEOUT_S)

    def raw(self, method, path, token=None, body=None):
        """(status, content type, bytes)."""
        import urllib.error
        try:
            with self._open(method, path, token, body) as resp:
                return resp.status, resp.headers["Content-Type"], resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.headers["Content-Type"], e.read()

    def req(self, method, path, token=None, body=None):
        status, _, data = self.raw(method, path, token, body)
        out = json.loads(data)
        with self.lock:
            self.bodies.append(out)
        return status, out

    def stream(self, method, path, token, body=None, on_frame=None):
        """An SSE response read to its end: its frames (``id``, ``event``,
        the decoded ``data``, ``t`` its arrival on the host clock), each
        also handed to ``on_frame``."""
        frames, cur = [], {}
        with self._open(method, path, token, body) as resp:
            check(resp.headers["Content-Type"].startswith(
                "text/event-stream"), f"gateway: {path} is no SSE stream")
            for raw in resp:
                line = raw.decode().rstrip("\n")
                if line.startswith("id: "):
                    cur["id"] = int(line[4:])
                elif line.startswith("event: "):
                    cur["event"] = line[7:]
                elif line.startswith("data: "):
                    cur["data"] = json.loads(line[6:])
                elif line == "" and "data" in cur:
                    cur["t"] = time.perf_counter()
                    frames.append(cur)
                    if on_frame is not None:
                        on_frame(cur)
                    cur = {}
        with self.lock:
            self.bodies.extend(f["data"] for f in frames)
            self.frames += len(frames)
        return frames


def _gateway_jobs(smoke):
    """Alice's and Bob's jobs as a client writes them: with ``parse_job``'s
    defaults, train_hybrid's job and serve_paged's."""
    cfg, shape, _ = _train_hybrid_setup(smoke)
    paged = _paged_job(smoke)
    alice = {"kind": "train", "arch": "zamba2_2p7b", "smoke": smoke,
             "seq_len": shape.seq_len, "global_batch": shape.global_batch,
             "microbatch": shape.microbatch}
    bob = {"kind": "serve", "arch": "deepseek_7b", "smoke": smoke,
           "paged": True, "page_size": paged.page_size,
           "max_slots": paged.max_slots, "seq_len": paged.shape.seq_len,
           "max_seq_len": paged.max_seq_len, "global_batch": 1}
    return alice, bob


class _Front:
    """The gateway phases' client side: the HTTP client, root's
    cluster-wide SSE feed on a thread of its own (every frame kept), and
    the waits and status checks every call goes through."""

    def __init__(self, url, name):
        import threading
        self.name = name
        self.client = HttpClient(url)
        self.frames, self.generate, self.error = [], 0, None
        self.watcher = threading.Thread(target=self._watch, daemon=True,
                                        name=f"{name}-root-feed")

    def _on_frame(self, frame):
        self.frames.append(frame)
        if frame["event"] == "generate":
            self.generate += 1

    def _watch(self):
        try:
            self.client.stream("GET", "/v1/events/stream?after=0&kinds="
                               + ",".join(GATEWAY_KINDS), "tok-root",
                               on_frame=self._on_frame)
        except Exception as e:          # read by the main thread
            self.error = repr(e)

    def wait_for(self, cond, what):
        deadline = time.monotonic() + GATEWAY_TIMEOUT_S
        while not cond():
            check(self.error is None,
                  f"{self.name}: root's feed failed: {self.error}")
            check(time.monotonic() < deadline,
                  f"{self.name}: no {what} in {GATEWAY_TIMEOUT_S:.0f} s")
            time.sleep(0.005)

    def ok(self, status, out, what, code=200):
        check(status == code,
              f"{self.name}: {what} answered {status}: {out}")
        return out

    def req(self, *a):
        return self.client.req(*a)


def _bob_traffic(front, daemon, log, root, bob_job, prompts, max_new):
    """Bob submits serve_paged's job and opens its sessions as concurrent
    generate requests (all but the last an SSE stream, the last a
    long-poll); after a third of the tokens root preempts his block and
    posts its resume (the pump's tick re-admits a preempted block as soon
    as the chip is free, so whichever lands first resumes him); his block
    expires once every session has finished.  Returns what the checks
    read (``_bob_held``)."""
    import threading
    name, ok = front.name, front.ok
    n_tokens = len(prompts) * max_new
    progress(f"{name}: bob's {len(prompts)} sessions over http")
    zero_counts()
    _zero_eager_calls()
    t_bob = time.time()
    b = ok(*front.req("POST", "/v1/submit", "tok-bob", {
        "job_description": "serve deepseek_7b over http", "n_chips": 1,
        "job": bob_job}), "bob's submit", 201)
    bob = b["app_id"]
    check(b["admitted"] and b["state"] == "running", f"{name}: bob {b}")
    rt = daemon.runtime(bob)
    bob_bytes = tree_bytes(rt.state) + tree_bytes(rt.sessions.pool)
    graph_before = rt.sessions.decode_graph
    del rt
    _disk_check(root, bob_bytes, name)
    polled = len(prompts) - 1        # this one long-polls
    gen = f"/v1/blocks/{bob}/generate"
    sessions = [None] * len(prompts)

    def sse_session(i):
        t_send = time.perf_counter()
        try:
            frames = front.client.stream("POST", gen, "tok-bob", {
                "prompt": prompts[i], "max_new_tokens": max_new})
            sessions[i] = {"send": t_send, "frames": frames}
        except Exception as e:
            sessions[i] = {"error": repr(e)}

    def poll_session(i):
        """``stream: false``; a long-poll that ends before its session
        does (its wait is capped at 30 s, and the preemption falls inside
        it) goes on over the block's feed from a cursor taken before the
        submission."""
        t_send = time.perf_counter()
        try:
            _, page = front.req("GET", f"/v1/blocks/{bob}/events?"
                                "kinds=state", "tok-bob")
            cursor = page["next_after"]
            s, out = front.req("POST", gen, "tok-bob", {
                "prompt": prompts[i], "max_new_tokens": max_new,
                "stream": False})
            check(s == 200, f"{name}: long-poll answered {s}: {out}")
            tokens, done = list(out["tokens"]), out["done"]
            polls = 1
            while not done:
                _, page = front.req(
                    "GET", f"/v1/blocks/{bob}/events?after={cursor}"
                    "&kinds=generate,session&timeout_s=30", "tok-bob")
                cursor = page["next_after"]
                polls += 1
                for ev in page["events"]:
                    if ev.get("session") != out["session"]:
                        continue
                    if (ev["kind"] == "generate"
                            and ev["index"] >= len(tokens)):
                        tokens.append(ev["token"])
                    done = done or ev["kind"] == "generate" and ev["done"]
            sessions[i] = {"send": t_send, "tokens": tokens,
                           "polls": polls, "end": time.perf_counter()}
        except BaseException as e:
            sessions[i] = {"error": repr(e)}

    threads = [threading.Thread(
        target=poll_session if i == polled else sse_session, args=(i,),
        name=f"{name}-session-{i}", daemon=True)
        for i in range(len(prompts))]
    t_traffic = time.perf_counter()
    for th in threads:
        th.start()
    front.wait_for(lambda: front.generate >= n_tokens // 3,
                   "third of bob's tokens")
    progress(f"{name}: root preempts bob")
    t_pre = time.perf_counter()
    t_pre_wall = time.time()
    pr = ok(*front.req("POST", f"/v1/blocks/{bob}/preempt", "tok-root",
                       {"reason": "admin over http"}), "root's preempt")
    preempt_http_s = time.perf_counter() - t_pre
    t_res = time.perf_counter()
    res_status, res_out = front.req("POST", f"/v1/blocks/{bob}/resume",
                                    "tok-root", {})
    resume_http_s = time.perf_counter() - t_res
    for th in threads:
        th.join(GATEWAY_TIMEOUT_S)
    check(not any(th.is_alive() for th in threads),
          f"{name}: a session's request never ended")
    t_end = max(s["frames"][-1]["t"] if "frames" in s else s["end"]
                for s in sessions if s and "error" not in s)
    front.wait_for(lambda: len(_events(log, bob, "session",
                                       action="finished")) == len(prompts),
                   "the end of bob's sessions")
    rt = daemon.runtime(bob)
    out = {"app_id": bob, "t_bob": t_bob, "bytes": bob_bytes,
           "sessions": sessions, "polled": polled, "t_traffic": t_traffic,
           "t_end": t_end, "preempt": pr, "t_pre_wall": t_pre_wall,
           "preempt_http_s": preempt_http_s, "res_status": res_status,
           "res_out": res_out, "resume_http_s": resume_http_s,
           "graphs": (graph_before, rt.sessions.decode_graph),
           "admissions": rt.sessions.admissions,
           "paged_rounds": dict(rt.paged_rounds)}
    del rt
    out["launches"] = counts()
    ok(*front.req("POST", f"/v1/blocks/{bob}/expire", "tok-bob", {}),
       "bob's expire")
    return out


def _bob_held(name, b, log, dev, bob_cfg, want, max_new, paged):
    """Bob's checks: every session's tokens (serve_paged's, ``want``),
    frames and end, one preemption and one resume, a compile-cache hit,
    his launches exactly his admissions' and those of the rounds that
    decoded (every step event is a round; one the engine dispatched after
    his last active session ended decodes nothing and is counted apart).
    Returns his part of the phase's record and his decode graphs."""
    bob, sessions, polled = b["app_id"], b["sessions"], b["polled"]
    bad = [i for i, s in enumerate(sessions) if s is None or "error" in s]
    check(not bad, f"{name}: sessions {bad} failed: "
          f"{[sessions[i] for i in bad]}")
    ttft, got = [], []
    for i, sess in enumerate(sessions):
        if i == polled:
            got.append(sess["tokens"])
            continue
        frames = sess["frames"]
        ids = [f["id"] for f in frames]
        gens = [f for f in frames if f["event"] == "generate"]
        check(ids == sorted(set(ids))
              and [f["data"]["index"] for f in gens] == list(range(max_new))
              and gens[-1]["data"]["done"] and frames[-1] is gens[-1],
              f"{name}: session {i}'s stream: ids {ids}, indices "
              f"{[f['data']['index'] for f in gens]}")
        got.append([f["data"]["token"] for f in gens])
        ttft.append(gens[0]["t"] - sess["send"])
    check(got == want, f"{name}: bob's tokens over http differ from "
          f"serve_paged's in sessions "
          f"{[i for i in range(len(want)) if got[i] != want[i]]}")
    pre = _events(log, bob, "preempted")
    res = _events(log, bob, "resumed")
    check(b["preempt"]["state"] == "preempted" and len(pre) == len(res) == 1
          and pre[0].seq < res[0].seq,
          f"{name}: root's preempt {b['preempt']}, events preempted {pre}, "
          f"resumed {res}")
    res_status = b["res_status"]
    resumed_by = "root" if res_status == 200 else "tick"
    check(res_status == 200 or (res_status == 409 and res[0].t
                                <= b["t_pre_wall"] + b["preempt_http_s"]
                                + b["resume_http_s"]),
          f"{name}: root's resume answered {res_status}: {b['res_out']}")
    # (the paged plane's steps are cached under no block id: Bob's block
    # is the only one on the card after his preemption)
    comp = [e.payload["action"] for e in list(log) if e.kind == "compile"
            and e.seq > pre[0].seq]
    check("miss" not in comp and "hit" in comp,
          f"{name}: bob's compile-cache events after his preemption {comp}")
    graphs = [g.stats() for g in {id(g): g for g in b["graphs"]}.values()]
    rounds = len(_events(log, bob, "step"))
    decoded, empty = b["paged_rounds"]["decoded"], b["paged_rounds"]["empty"]
    check(decoded + empty == rounds,
          f"{name}: bob's {rounds} step events against his block's rounds "
          f"{b['paged_rounds']}")
    zero = {n: 0 for n in COUNTERS}
    if dev.type == "cuda":
        check(len(graphs) == 2 and all(
            g["captures"] == 1 and g["eager_calls"] == 0 for g in graphs)
            and sum(g["replays"] for g in graphs) == decoded
            and _eager_calls() == 0,
            f"{name}: bob's decode graphs {graphs} for {decoded} rounds "
            f"that decoded ({empty} empty), {_eager_calls()} eager decode "
            f"steps")
        pre_l, _, per_round = dense_launches(bob_cfg)
    else:
        check(sum(g["eager_calls"] for g in graphs) == decoded,
              f"{name}: bob's {decoded} rounds that decoded ({empty} "
              f"empty) on the CPU, graphs {graphs}")
        pre_l = per_round = zero
    want_bob = {n: b["admissions"] * pre_l[n] + decoded * per_round[n]
                for n in COUNTERS}
    check(b["launches"] == want_bob,
          f"{name}: bob's launches {b['launches']}, want {want_bob} "
          f"({b['admissions']} admissions, {decoded} rounds that decoded)")
    n_tokens = len(want) * max_new
    traffic_s = b["t_end"] - b["t_traffic"]
    gap_s = res[0].t - b["t_pre_wall"]
    bob_out = {
        "arch": bob_cfg.name, "sessions": len(sessions),
        "sse_sessions": len(ttft), "max_new_tokens": max_new,
        "admissions": b["admissions"], "rounds": rounds,
        "decoded_rounds": decoded, "empty_rounds": empty,
        "tokens": n_tokens, "state_gb": b["bytes"] / 1e9,
        "long_poll_requests": sessions[polled]["polls"],
        "decode_graphs": graphs,
        "submit_to_first_token_s":
            _events(log, bob, "generate")[0].t - b["t_bob"],
        "http": {"ttft_p50_s": float(np.percentile(ttft, 50)),
                 "ttft_p99_s": float(np.percentile(ttft, 99)),
                 "tok_s": n_tokens / traffic_s,
                 "tok_s_outside_preemption": n_tokens / (traffic_s - gap_s)},
        "direct": {"ttft_p50_s": paged["ttft_p50_s"],
                   "ttft_p99_s": paged["ttft_p99_s"],
                   "tok_s": paged["tok_s"]}}
    admin = {"resumed_by": resumed_by, "resume_status": res_status,
             "preempt_http_s": b["preempt_http_s"],
             "resume_http_s": b["resume_http_s"],
             "preempt_event_s": pre[0].t - b["t_pre_wall"],
             "preempted_to_resumed_event_s": res[0].t - pre[0].t,
             "preempt_call_to_resumed_event_s": gap_s,
             "compile_after_preempt": comp}
    return bob_out, admin, graphs


def _front_held(name, front, log, apps, strict):
    """Root's feed in the bus's order with each app's states, the
    dashboard and the trace served, and no tensor hidden as a string,
    server side and client side."""
    frames = front.frames
    ids = [f["id"] for f in frames]
    bus = [e for e in list(log) if e.kind in GATEWAY_KINDS]
    check(ids == [e.seq for e in bus] and ids == sorted(set(ids)),
          f"{name}: root's feed ids {ids[:20]}... are not the bus's "
          f"{[e.seq for e in bus][:20]}...")
    for app in apps:
        seen = [f["data"]["state"] for f in frames if f["event"] == "state"
                and f["data"]["app_id"] == app]
        check(seen == [e.payload["state"] for e in _events(log, app,
                                                            "state")],
              f"{name}: {app}'s states on root's feed {seen}")
    check(strict.failures == [] and strict.encoded > 0,
          f"{name}: the strict encoder failed: {strict.failures}")
    for obj in front.client.bodies:
        text = json.dumps(obj)
        check("tensor(" not in text, f"{name}: a tensor written out as a "
              f"string in {text[:300]}")


def _root_surfaces(front, log):
    """``/ui``, ``/ui/app.js`` and ``/v1/trace`` fetched, and root's feed
    read up to the bus's last event of its kinds."""
    ui = front.client.raw("GET", "/ui")
    app_js = front.client.raw("GET", "/ui/app.js")
    trace = front.ok(*front.req("GET", "/v1/trace", "tok-root"),
                     "root's trace")
    last = max(e.seq for e in list(log) if e.kind in GATEWAY_KINDS)
    front.wait_for(lambda: front.frames and front.frames[-1]["id"] >= last,
                   "root's feed to reach the bus's last event")
    check(ui[0] == 200 and ui[1].startswith("text/html")
          and b"/ui/app.js" in ui[2] and app_js[0] == 200
          and app_js[1].startswith("text/javascript"),
          f"{front.name}: /ui {ui[:2]}, /ui/app.js {app_js[:2]}")
    check(isinstance(trace.get("traceEvents"), list),
          f"{front.name}: /v1/trace is no Chrome trace: {list(trace)[:5]}")


def phase_gateway(device="cuda", smoke=False, paged=None):
    """The web gateway on the card: a background ``ClusterDaemon`` on one
    chip behind a ``GatewayServer`` on 127.0.0.1, every step of the
    scenario a real HTTP call from a client thread.  Alice walks the
    paper's explicit workflow with train_hybrid's job (register, root's
    review, confirm with the capability token, activate, run, 2 steps,
    download, expire); then Bob submits serve_paged's job and opens its 12
    sessions as 12 concurrent generate requests (11 SSE streams, one
    long-poll) with a preemption and a resume among them
    (``_bob_traffic``); root keeps the cluster-wide SSE feed open
    throughout.  Held: Alice's launches exactly 2 train_hybrid steps', her
    download's 2 steps, her MFU in ``/v1/cluster``, under 1% of her state
    left after her expire; Bob's sessions, preemption and launches
    (``_bob_held``: serve_paged's tokens, ``paged``, bit for bit); root's
    frames the bus's for his kinds, in order; ``/ui`` served,
    ``/v1/trace`` a Chrome trace; every response body and frame encoded
    without ``default=`` (no tensor hidden as a string).  The only reads
    of the daemon are for these checks."""
    from repro_torch.core.daemon import ClusterDaemon
    from repro_torch.core.topology import Topology
    from repro_torch.gateway import GatewayServer, ProfileStore, UserProfile
    from repro_torch.gateway import handlers as gw_handlers
    from repro_torch.gateway import server as gw_server
    from repro_torch.models import model as model_lib
    if paged is None:
        paged = phase_serve_paged(device, smoke)
        _free(device)
    cfg, shape, opt_cfg = _train_hybrid_setup(smoke)
    alice_job, bob_job = _gateway_jobs(smoke)
    parsed = gw_handlers.parse_job(alice_job)
    check(parsed.cfg == cfg and parsed.opt == opt_cfg and (
        parsed.shape.seq_len, parsed.shape.global_batch,
        parsed.shape.microbatch) == (shape.seq_len, shape.global_batch,
                                     shape.microbatch),
          f"gateway: alice's job over the wire is not train_hybrid's: "
          f"{parsed}")
    bob_cfg = _paged_job(smoke).cfg
    prompts = _paged_prompts(bob_cfg, smoke)
    max_new = PAGED_NEW_TOKENS_SMOKE if smoke else PAGED_NEW_TOKENS
    want = list(paged["session_tokens"].values())   # in prompt order
    check(len(want) == len(prompts), "gateway: serve_paged's sessions")
    n_alice_steps = 2
    dev = torch.device(device)
    root = tempfile.mkdtemp(prefix="chip_smoke_gateway_")
    strict = StrictJSON()
    encoders = (gw_server.json, gw_handlers.json)
    gw_server.json = gw_handlers.json = strict
    gc.collect()
    base = _mem(dev)
    log = []
    daemon = ClusterDaemon(Topology(n_pods=1, pod_x=1, pod_y=1),
                           devices=[device], ckpt_root=root,
                           background=True)
    daemon.bus.subscribe(log.append)
    server = GatewayServer(daemon, ProfileStore([
        UserProfile(u, tok, priority=p, admin=a)
        for u, tok, p, a in GATEWAY_USERS])).start()
    front = _Front(server.url, "gateway")
    ok = front.ok
    t0 = time.perf_counter()
    try:
        front.watcher.start()
        # ------------------------------------------------ Alice, train
        progress("gateway: alice's explicit workflow")
        zero_counts()
        t_alice = time.time()
        r = ok(*front.req("POST", "/v1/register", "tok-alice", {
            "job_description": "train zamba2_2p7b over http",
            "n_chips": 1}), "alice's register", 201)
        alice = r["app_id"]
        check(r["state"] == "requested", f"gateway: alice {r}")
        rv = ok(*front.req("POST", f"/v1/blocks/{alice}/review",
                           "tok-root", {}), "root's review")
        st = ok(*front.req("GET", f"/v1/blocks/{alice}", "tok-alice"),
                "alice's status")
        check(rv["approved"] and st["token"], f"gateway: review {rv}")
        ok(*front.req("POST", f"/v1/blocks/{alice}/confirm", "tok-alice",
                      {"token": st["token"]}), "alice's confirm")
        ok(*front.req("POST", f"/v1/blocks/{alice}/activate", "tok-alice",
                      {"job": alice_job}), "alice's activate")
        ok(*front.req("POST", f"/v1/blocks/{alice}/run", "tok-alice", {}),
           "alice's run")
        t_steps = time.perf_counter()
        stepped = ok(*front.req("POST", f"/v1/blocks/{alice}/steps",
                                "tok-alice", {"rounds": n_alice_steps}),
                     "alice's steps")
        steps_http_s = time.perf_counter() - t_steps
        dl = ok(*front.req("GET", f"/v1/blocks/{alice}/download",
                           "tok-alice"), "alice's download")
        cl = ok(*front.req("GET", "/v1/cluster", "tok-alice"),
                "alice's cluster view")
        alice_launches = counts()
        alice_block = daemon.registry.get(alice).block_id
        alice_bytes = tree_bytes(daemon.runtime(alice).state)
        ok(*front.req("POST", f"/v1/blocks/{alice}/expire", "tok-alice",
                      {}), "alice's expire")
        gc.collect()
        after_alice = _mem(dev)
        # -------------------------------------------------- Bob, serve
        b = _bob_traffic(front, daemon, log, root, bob_job, prompts,
                         max_new)
        _root_surfaces(front, log)
        elapsed = time.perf_counter() - t0
    finally:
        server.stop()
        daemon.stop()
        gw_server.json, gw_handlers.json = encoders
        front.watcher.join(10.0)
        shutil.rmtree(root, ignore_errors=True)

    # Alice: her workflow, launches, download, MFU, memory
    steps = _events(log, alice, "step")
    check(stepped["completed"] == n_alice_steps == len(steps)
          and dl["steps"] == n_alice_steps,
          f"gateway: alice's steps {stepped}, download {dl}")
    alice_states = [e.payload["state"] for e in _events(log, alice,
                                                         "state")]
    check(alice_states == ["approved", "confirmed", "active", "running",
                           "done", "expired"],
          f"gateway: alice's states {alice_states}")
    roofline = cl["roofline"]["blocks"].get(alice_block, {})
    mfu = roofline.get("mfu")
    check(mfu is not None and mfu > 0,
          f"gateway: alice's MFU in /v1/cluster {roofline}")
    want_alice = _alice_launches(cfg, shape, opt_cfg, dev, n_alice_steps)
    check(alice_launches == want_alice,
          f"gateway: alice's launches {alice_launches}, want {want_alice}")
    if base is not None:
        check(after_alice - base < 0.01 * alice_bytes,
              f"gateway: {(after_alice - base) / 1e9:.3f} GB left after "
              f"alice's expire, her state {alice_bytes / 1e9:.3f} GB")
    bob_out, admin, graphs = _bob_held("gateway", b, log, dev, bob_cfg,
                                       want, max_new, paged)
    _front_held("gateway", front, log, (alice, b["app_id"]), strict)
    out = {
        "alice": {"arch": cfg.name, "n_layers": cfg.n_layers,
                  "steps": n_alice_steps,
                  "submit_to_first_step_s": steps[0].t - t_alice,
                  "steps_http_s": steps_http_s,
                  "step_s": [e.payload["step_s"] for e in steps],
                  "state_gb": alice_bytes / 1e9, "mfu": mfu,
                  "mem_after_expire_gb": (None if base is None else
                                          (after_alice - base) / 1e9)},
        "bob": bob_out, "admin": admin,
        "http_requests": front.client.requests,
        "sse_frames": front.client.frames,
        "root_feed_frames": len(front.frames),
        "strict_encodes": strict.encoded,
        "phase_s": elapsed, "launches": {
            n: alice_launches[n] + b["launches"][n] for n in COUNTERS},
        "launches_by_user": {"alice": alice_launches, "bob": b["launches"]},
        "card": _CARD}
    emit("gateway", **out)
    out["decode_graphs"] = graphs
    return out


def _alice_launches(cfg, shape, opt_cfg, dev, n_steps):
    """``n_steps`` train steps' launches (none on the CPU)."""
    from repro_torch.models import model as model_lib
    per_step = (train_launches(cfg, shape, opt_cfg,
                               model_lib.abstract_params(cfg))
                if dev.type == "cuda" else {n: 0 for n in COUNTERS})
    return {n: n_steps * per_step[n] for n in COUNTERS}


#: service: the launcher's steps on train_f32's job
SERVICE_LAUNCHER_STEPS = 3


def phase_service(device="cuda", smoke=False, train=None, paged=None,
                  f32=None, gateway=None):
    """The daemon's service mode across ranks (item 8f) on one card: the
    gateway phase's scenario through ``core.service``'s leader under a
    process group of one rank (NCCL on the card, gloo on the CPU; a
    ``HashStore``), where every command, tick and engine round is an
    entry of the leader's log, pickled and passed through the control
    group as it is across ranks.  Alice submits train_hybrid's job with
    autostep to 2 steps (``train``: zamba2_2p7b at full width, on the
    sharded runtime at (1, 1)); Bob runs the gateway phase's traffic
    (``_bob_traffic``: serve_paged's 12 sessions as concurrent generate
    requests, a preemption and a resume); then ``launch.train.run`` with
    ``--autostep`` trains train_f32's job (``f32``: deepseek_7b at full
    width cut to 4 layers, fp32 moments) for 3 steps under the same
    group.  Held bit for bit: Alice's losses and grad norms against
    train_hybrid's, Bob's tokens against serve_paged's (``paged``), the
    launcher's losses and grad norms against train_f32's; launches
    exactly as the gateway phase counts them; ``log_entries`` above 0 and
    no tripwire fired; root's feed, ``/ui`` and the trace as in the
    gateway phase.  Read: HTTP TTFT p50 and p99 against the gateway
    phase's (``gateway``), the leader's host time per entry (pickle and
    broadcast), ``log_entries`` and ``log_bytes``.  The process group is
    destroyed at the end."""
    import torch.distributed as dist
    from repro_torch import device as device_lib
    from repro_torch.core.service import ServiceDaemon
    from repro_torch.core.topology import Topology
    from repro_torch.gateway import GatewayServer, ProfileStore, UserProfile
    from repro_torch.gateway import handlers as gw_handlers
    from repro_torch.gateway import server as gw_server
    from repro_torch.launch import train as launch_train
    if train is None:
        train = phase_train_hybrid(device, smoke)
        _free(device)
    if paged is None:
        paged = phase_serve_paged(device, smoke)
        _free(device)
    if f32 is None:
        f32 = phase_train_f32(device, smoke)
        _free(device)
    cfg, shape, opt_cfg = _train_hybrid_setup(smoke)
    alice_job, bob_job = _gateway_jobs(smoke)
    bob_cfg = _paged_job(smoke).cfg
    prompts = _paged_prompts(bob_cfg, smoke)
    max_new = PAGED_NEW_TOKENS_SMOKE if smoke else PAGED_NEW_TOKENS
    want = list(paged["session_tokens"].values())
    n_alice = 2
    dev = torch.device(device)
    root = tempfile.mkdtemp(prefix="chip_smoke_service_")
    strict = StrictJSON()
    saved = (gw_server.json, gw_handlers.json, gw_handlers.parse_job)
    parse = gw_handlers.parse_job

    def parse_job(spec):
        # a train job's step events carry its loss and grad norm
        job = parse(spec)
        if getattr(job, "kind", None) == "train":
            job = dataclasses.replace(job, collect_metrics=True)
        return job

    gw_server.json = gw_handlers.json = strict
    gw_handlers.parse_job = parse_job
    device_lib.init_distributed(device, store=dist.HashStore(), rank=0,
                                world_size=1)
    before = dict(device_lib.CONTROL)
    log = []
    daemon = server = None
    out = {"backend": dist.get_backend(),
           "world_size": dist.get_world_size()}
    try:
        daemon = ServiceDaemon(Topology(n_pods=1, pod_x=1, pod_y=1),
                               devices=[device], ckpt_root=root,
                               background=True)
        daemon.bus.subscribe(log.append)
        server = GatewayServer(daemon, ProfileStore([
            UserProfile(u, tok, priority=p, admin=a)
            for u, tok, p, a in GATEWAY_USERS])).start()
        front = _Front(server.url, "service")
        ok = front.ok
        t0 = time.perf_counter()
        front.watcher.start()
        # --------------------------------------- Alice, train, autostep
        progress("service: alice's train_hybrid job under autostep")
        zero_counts()
        a = ok(*front.req("POST", "/v1/submit", "tok-alice", {
            "job_description": "train zamba2_2p7b under autostep",
            "n_chips": 1, "job": alice_job,
            "autostep": {"until_steps": n_alice}}), "alice's submit", 201)
        alice = a["app_id"]
        check(a["admitted"] and a["autostep"]["until_steps"] == n_alice,
              f"service: alice {a}")
        front.wait_for(lambda: any(
            f["event"] == "state" and f["data"]["app_id"] == alice
            and f["data"]["state"] == "done" for f in list(front.frames)),
            "alice's last step")
        alice_launches = counts()
        ok(*front.req("POST", f"/v1/blocks/{alice}/expire", "tok-alice",
                      {}), "alice's expire")
        # -------------------------------------------------- Bob, serve
        b = _bob_traffic(front, daemon, log, root, bob_job, prompts,
                         max_new)
        _root_surfaces(front, log)
        elapsed = time.perf_counter() - t0
        server.stop()
        daemon.stop()
        server = None
        out["log"] = daemon.log_stats()
        # ------------------------------ the launcher, under autostep
        progress("service: launch.train --autostep on train_f32's job")
        fcfg, fshape, fopt = _train_f32_setup(smoke)
        args = launch_train.parse_args([
            "--arch", "deepseek_7b", "--steps", str(SERVICE_LAUNCHER_STEPS),
            "--seq-len", str(fshape.seq_len),
            "--global-batch", str(fshape.global_batch),
            "--microbatch", str(fshape.microbatch), "--autostep",
            "--device", device, "--log-every", "1000",
            "--ckpt-dir", root, "--ckpt-every", "0"])
        zero_counts()
        res = launch_train.run(args, fcfg, opt=fopt)
        launcher_launches = counts()
        out["launcher_log"] = res["daemon"].log_stats()
    finally:
        if server is not None:
            server.stop()
        if daemon is not None:
            daemon.stop()
        gw_server.json, gw_handlers.json, gw_handlers.parse_job = saved
        shutil.rmtree(root, ignore_errors=True)
        dist.destroy_process_group()
    front.watcher.join(10.0)

    # Alice: autostep to 2 steps, bit for bit train_hybrid's
    steps = _events(log, alice, "step")
    losses = [e.payload["metrics"]["loss"] for e in steps]
    norms = [e.payload["metrics"]["grad_norm"] for e in steps]
    check(losses == train["losses"][:n_alice]
          and norms == train["grad_norms"][:n_alice],
          f"service: alice's losses {losses} and grad norms {norms} are "
          f"not train_hybrid's {train['losses'][:n_alice]}, "
          f"{train['grad_norms'][:n_alice]}")
    auto = [e.payload["action"] for e in _events(log, alice, "autostep")]
    check(auto == ["enabled", "done"], f"service: alice's autostep {auto}")
    want_alice = _alice_launches(cfg, shape, opt_cfg, dev, n_alice)
    check(alice_launches == want_alice,
          f"service: alice's launches {alice_launches}, want {want_alice}")
    bob_out, admin, graphs = _bob_held("service", b, log, dev, bob_cfg,
                                       want, max_new, paged)
    _front_held("service", front, log, (alice, b["app_id"]), strict)
    # the launcher: bit for bit train_f32's
    hist = res["history"]
    got = ([h["loss"] for h in hist], [h["grad_norm"] for h in hist])
    check(got == (f32["losses"], f32["grad_norms"]),
          f"service: the launcher's losses and grad norms {got} are not "
          f"train_f32's {f32['losses']}, {f32['grad_norms']}")
    want_l = _alice_launches(fcfg, fshape, fopt, dev, SERVICE_LAUNCHER_STEPS)
    check(launcher_launches == want_l,
          f"service: the launcher's launches {launcher_launches}, want "
          f"{want_l}")
    for what in ("log", "launcher_log"):
        lg = out[what]
        check(lg["log_entries"] > 0 and lg["diverged"] is None,
              f"service: the leader's {what} {lg}")
    sent = {k: device_lib.CONTROL[k] - before[k] for k in before}
    check(sent["entries"] == out["log"]["log_entries"]
          + out["launcher_log"]["log_entries"],
          f"service: the control channel carried {sent}, the logs "
          f"{out['log']}, {out['launcher_log']}")
    lg = out["log"]
    out.update({
        "alice": {"arch": cfg.name, "steps": n_alice, "losses": losses,
                  "grad_norms": norms,
                  "step_s": [e.payload["step_s"] for e in steps]},
        "bob": bob_out, "admin": admin,
        "launcher": {"arch": fcfg.name, "n_layers": fcfg.n_layers,
                     "steps": len(hist), "losses": got[0],
                     "grad_norms": got[1], "wall_s": res["wall_s"]},
        "leader_send_us_per_entry": 1e6 * lg["send_s"] / lg["log_entries"],
        "log_bytes_per_entry": lg["log_bytes"] / lg["log_entries"],
        "ttft_vs_gateway": (None if gateway is None else {
            "gateway_p50_s": gateway["bob"]["http"]["ttft_p50_s"],
            "gateway_p99_s": gateway["bob"]["http"]["ttft_p99_s"],
            "service_p50_s": bob_out["http"]["ttft_p50_s"],
            "service_p99_s": bob_out["http"]["ttft_p99_s"]}),
        "http_requests": front.client.requests, "phase_s": elapsed,
        "launches": {n: alice_launches[n] + b["launches"][n]
                     + launcher_launches[n] for n in COUNTERS},
        "launches_by_user": {"alice": alice_launches, "bob": b["launches"],
                             "launcher": launcher_launches},
        "card": _CARD})
    emit("service", **out)
    out["decode_graphs"] = graphs
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


OVERLAP_LAYERS = 8
OVERLAP_STEPS = 6


def _overlap_path(cfg, shape, opt_cfg, mesh, ctx, data, dev, overlap,
                  n_steps, step=None):
    """One path of ``train_overlap``: ``n_steps`` steps from seed 0
    on the (1, 1, 1) mesh, its launches counted as the main path's; step
    0's compressed-reduce readings (the last microbatch's scales and the
    leaves' sizes) kept on the host.  ``step``: a train step of the
    caller's in place of ``make_train_step``'s."""
    from repro_torch.models import model as model_lib
    from repro_torch.sharding import ctx as shard_ctx
    from repro_torch.sharding import plans
    from repro_torch.train import train_step as train_lib
    lay = plans.state_layouts(model_lib.abstract_params(cfg), mesh,
                              plans.MeshAxes(dp=("data",), model="model"),
                              state_bits=opt_cfg.state_bits)
    state = train_lib.make_sharded_train_state(cfg, 0, opt_cfg, lay,
                                               device=dev)
    kw = dict(overlap_comm=True, mesh=mesh) if overlap else {}
    if step is None:
        step = train_lib.make_train_step(cfg, shape, opt_cfg, **kw)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    hist, reduce0 = [], None
    for i in range(n_steps):
        t0 = time.perf_counter()
        with shard_ctx.use(ctx):
            state, m = step(state, data.batch(i))
        hist.append({"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "step_s": time.perf_counter() - t0})
        if opt_cfg.state_bits == 8:
            hist[-1]["eps_exposed"] = _eps_exposed(state["opt"])
        if overlap and i == 0 and hasattr(step, "pod_reduce"):
            pr = step.pod_reduce
            reduce0 = {"scales": pr["scales"].double().cpu().tolist(),
                       "numels": list(pr["numels"]),
                       "ef_bytes": pr["ef_bytes"]}
    n = len(hist)
    launches = counts()
    steady = [h["step_s"] for h in hist[1:]]
    out = {"losses": [h["loss"] for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist],
           "step_s": [h["step_s"] for h in hist],
           "steady_step_s": float(np.median(steady)),
           "launches": launches,
           "launches_per_step": {k: c / n for k, c in launches.items()},
           "peak_mem_gb": _peak(dev)}
    if opt_cfg.state_bits == 8:
        out["eps_exposed"] = [h["eps_exposed"] for h in hist]
    if reduce0 is not None:
        out["step0_reduce"] = reduce0
    return out, state, step


@contextlib.contextmanager
def _synced_pod_reduce(dev):
    """Run (a) of the int8 overlapped climb's experiment: the overlapped
    step with the device synchronized after each ``start_pod_reduce``
    and before each ``PodReduce.wait``, so no kernel of the pod reduce
    runs beside another microbatch's."""
    from repro_torch.train import grad_compression as gcomp
    start, wait = gcomp.start_pod_reduce, gcomp.PodReduce.wait

    def synced_start(*a, **kw):
        out = start(*a, **kw)
        _sync(dev)
        return out

    def synced_wait(self, *a, **kw):
        _sync(dev)
        return wait(self, *a, **kw)

    gcomp.start_pod_reduce, gcomp.PodReduce.wait = synced_start, synced_wait
    try:
        yield
    finally:
        gcomp.start_pod_reduce, gcomp.PodReduce.wait = start, wait


def _compressed_serial_step(cfg, shape, opt_cfg, mesh):
    """Run (b) of the int8 overlapped climb's experiment: a serial train
    step whose microbatch gradients each pass synchronously through the
    port's ``grad_compression.compressed_psum_pod`` (the pod made
    pod-local, the error feedback zero each step and carried from
    microbatch to microbatch, as the overlapped step's), summed in fp32,
    then the optimizer's update: the overlapped step's arithmetic with
    no collective in flight."""
    import torch.distributed as dist
    from repro_torch.models.transformer import flatten, unflatten
    from repro_torch.sharding import ctx as shard_ctx
    from repro_torch.train import grad_compression as gcomp
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as train_lib
    n_micro = max(1, shape.microbatch)

    def step(state, batch):
        params = state["params"]
        ctx = shard_ctx.current().pod_local("pod")
        acc = err = None
        losses = []
        for i in range(n_micro):
            with shard_ctx.use(ctx):
                l, g = train_lib.value_and_grad(
                    params, cfg, train_lib._split_micro(batch, n_micro, i))
            local = {p: train_lib._local(t) for p, t in flatten(g)}
            del g
            if err is None:
                err = {p: torch.zeros(t.shape, dtype=torch.float32,
                                      device=t.device)
                       for p, t in local.items()}
                acc = {p: torch.zeros_like(e) for p, e in err.items()}
            red, err = gcomp.compressed_psum_pod(local, err, mesh)
            del local
            for p in acc:
                acc[p].add_(red[p])
            del red
            losses.append(l)
        means = torch.stack(losses)
        n_pods = mesh.size(list(mesh.mesh_dim_names).index("pod"))
        dist.all_reduce(means, group=mesh.get_group("pod"))
        means = means / torch.tensor(float(n_pods), device=means.device)
        loss = torch.zeros((), device=means.device)
        for m in means:
            loss = loss + m
        grads = unflatten((p, train_lib._like(t, acc[p].div_(n_micro)))
                          for p, t in flatten(params))
        del acc, err
        params, opt, metrics = opt_lib.apply(opt_cfg, params, state["opt"],
                                             grads)
        return ({"params": params, "opt": opt},
                {"loss": loss / n_micro, **metrics})
    return step


def _eps_exposed(opt):
    """With int8 moments: the share of elements whose second moment's
    code is 0 while their first moment's is not.  A zero gradient there
    (the compressed reduce gives exact zeros where every microbatch's
    code was 0) makes the next update m / eps (``fused_adamw_torch``):
    one mechanism for the int8 moments' climb, read, not held."""
    from torch.distributed.tensor import DTensor
    from repro_torch.train.optimizer import _leaves

    def local(t):
        return t.to_local() if isinstance(t, DTensor) else t

    hit = n = 0
    for m, v in zip(_leaves(opt["m"], lambda x: "q" in x),
                    _leaves(opt["v"], lambda x: "q" in x)):
        qm, qv = local(m["q"]), local(v["q"])
        hit += int(((qv == 0) & (qm != 0)).sum())
        n += qv.numel()
    return hit / max(n, 1)


def _codec_on_card_and_host(g):
    """The compressed reduce's arithmetic on one gradient leaf on its
    device and on the CPU: the eager codec (``quantize``) and the pod
    reduce's (``pod_scales``, ``pod_quantize_``), codes, scales and
    residuals compared bit for bit."""
    from repro_torch.train import grad_compression as gcomp

    def run(x):
        codes, scale = gcomp.quantize(x)
        e = x.float()
        s = gcomp.pod_scales(torch.amax(torch.abs(e)))
        q = gcomp.pod_quantize_(e, s)
        return codes, scale, q.to(torch.int8), s, e

    here, host = run(g), run(g.cpu())
    same = [bool(torch.equal(a.cpu().reshape(-1).view(torch.uint8),
                             b.reshape(-1).view(torch.uint8)))
            for a, b in zip(here, host)]
    return {"shape": list(g.shape), "codes_equal": same[0] and same[2],
            "scales_equal": same[1] and same[3], "residual_equal": same[4],
            "bitwise_equal": all(same)}


def _step0_held(name, serial, over, n_micro):
    """Step 0 of the two paths, before any optimizer step: the same
    forward, so the same loss bit for bit; the gradients part by the
    last microbatch's residual over ``n_micro`` (|dg| <= scale / 2 an
    element, from the scales the overlapped step records)."""
    r0 = over["step0_reduce"]
    resid = float(np.sqrt(sum(n * (s / 2) ** 2 for n, s in zip(
        r0["numels"], r0["scales"])))) / n_micro
    gap = abs(over["grad_norms"][0] - serial["grad_norms"][0])
    out = {"loss_bitwise_equal": over["losses"][0] == serial["losses"][0],
           "grad_norm_gap": gap, "residual_bound": resid,
           # fp32 rounding of the two accumulators' sums on top
           "within_bound": gap <= resid * (1 + 1e-3)}
    check(out["loss_bitwise_equal"],
          f"{name}: step 0 loss {over['losses'][0]} against the serial "
          f"{serial['losses'][0]}")
    check(out["within_bound"],
          f"{name}: step 0 grad norms part by {gap}, above the residual's "
          f"bound {resid}")
    return out


def phase_train_overlap(device="cuda", smoke=False, train=None):
    """The compressed cross-pod gradient all-reduce (item 9) on one card:
    deepseek_7b at full width cut to ``OVERLAP_LAYERS`` of 30 layers
    (the error feedback and the fp32 accumulator hold 8 bytes a param
    beside the state's, so the 30 layers' 6.9e9 params do not fit one
    card; 8 layers hold 2.46e9), 2 x 2048 tokens in 2 microbatches,
    random bf16 weights from seed 0, on a (1, 1, 1) ``("pod", "data",
    "model")`` DeviceMesh under a process group of one rank (NCCL on
    the card, gloo on the CPU; a ``HashStore``).  With int8 moments, then
    with fp32 ones: the serial step (the pod a summed data axis), then
    ``make_train_step(overlap_comm=True, mesh=)`` from the same seed,
    each microbatch's gradients quantized to int8 with error feedback
    and the codes all-gathered over the one pod asynchronously.

    Held, for both moments: step 0's loss the serial path's bit for bit
    (the forward is the same), step 0's grad norm within the last
    microbatch's residual of it (``_step0_held``), the flash, RMSNorm
    and AdamW launches per step the serial path's and
    ``train_launches``'.  With fp32 moments, as the reference's own test
    of the path runs (``tests/test_train.py``), the 6 losses within its
    bound of the serial ones (rtol 0.05, atol 0.05).  With int8 moments
    both paths climb, the overlapped one faster (an open question,
    ROADMAP queue 3; ``tests/test_torch_grad_compression.py`` holds the
    int8 overlapped step, step by step, to the reference's reducer and
    int8 update at smoke size), so their losses are printed, not held,
    beside each step's share of elements whose int8 second moment's
    code is 0 while the first moment's is not (``_eps_exposed``).  The codec on the card the CPU's, codes, scales and residuals
    bit for bit, on the largest leaf (the embedding) and a small one
    (the final norm's scale).  Printed: the steady step times, the peak
    memories, the error feedback's bytes, and the codec's device time
    on one microbatch's gradients (profiled, ``profile_steps``) beside
    the int8 overlapped step's (profiled).  The process group is
    destroyed at the end."""
    import torch.distributed as dist
    import repro_torch.configs as configs
    from repro_torch import device as device_lib
    from repro_torch.data import pipeline
    from repro_torch.launch.mesh import make_block_mesh
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.transformer import flatten
    from repro_torch.sharding import ctx as shard_ctx
    from repro_torch.sharding import plans
    from repro_torch.train import grad_compression as gcomp
    from repro_torch.train import train_step as train_lib
    from repro_torch.train.optimizer import OptConfig
    progress("train_overlap: init")
    cfg = (configs.get_smoke("deepseek_7b") if smoke else
           dataclasses.replace(configs.get("deepseek_7b"),
                               n_layers=OVERLAP_LAYERS))
    shape = ShapeConfig("chip", "train", seq_len=32 if smoke else 2048,
                        global_batch=2, microbatch=2)
    n_steps = 2 if smoke else OVERLAP_STEPS
    dev = device_lib.init_distributed(device, store=dist.HashStore(),
                                      rank=0, world_size=1)
    try:
        mesh = make_block_mesh([0], (1, 1, 1), ("pod", "data", "model"))
        ctx = shard_ctx.ShardCtx(mesh, ("pod", "data"), "model",
                                 tp=plans.tp_layout(cfg, mesh))
        data = pipeline.DataIterator(
            cfg, shape, seed=0, device=dev,
            shardings=pipeline.batch_shards(mesh, ("pod", "data"), 2))
        out = {"arch": cfg.name, "n_layers": cfg.n_layers,
               "mesh": [1, 1, 1], "backend": dist.get_backend(),
               "seq_len": shape.seq_len, "global_batch": shape.global_batch,
               "microbatch": shape.microbatch, "steps": n_steps,
               "launches": {k: 0 for k in COUNTERS}}
        for moments, bits in (("int8", 8), ("f32", None)):
            name = f"train_overlap {moments}"
            opt_cfg = OptConfig(state_bits=bits, warmup_steps=2,
                                total_steps=100)
            progress(f"{name}: serial path")
            serial, state, _ = _overlap_path(cfg, shape, opt_cfg, mesh, ctx,
                                             data, dev, False, n_steps)
            want = (train_launches(cfg, shape, opt_cfg, state["params"])
                    if dev.type == "cuda" else {n: 0 for n in COUNTERS})
            del state
            _free(device)
            progress(f"{name}: overlapped path")
            over, state, step = _overlap_path(cfg, shape, opt_cfg, mesh,
                                              ctx, data, dev, True, n_steps)
            run = {"serial": serial, "overlap": over,
                   "step0": _step0_held(name, serial, over,
                                        shape.microbatch)}
            for path in (serial, over):
                check(path["launches_per_step"] == want,
                      f"{name} launches per step "
                      f"{path['launches_per_step']}, want {want}")
            run["launches_equal_serial"] = (over["launches_per_step"]
                                            == serial["launches_per_step"])
            run["losses_close"] = bool(np.allclose(
                over["losses"], serial["losses"], rtol=0.05, atol=0.05))
            if bits is None:
                check(run["losses_close"]
                      and all(np.isfinite(over["losses"])),
                      f"{name}: losses {over['losses']} against the "
                      f"serial {serial['losses']}")
            for k in COUNTERS:
                out["launches"][k] += (serial["launches"][k]
                                       + over["launches"][k])
            out[moments] = run
            if bits is None:
                del state, step
                _free(device)
                continue

            r0 = over["step0_reduce"]
            out["ef_bytes"] = r0["ef_bytes"]
            progress(f"{name}: codec on the card and the host")
            with shard_ctx.use(ctx.pod_local("pod")):
                _, grads = train_lib.value_and_grad(
                    state["params"], cfg, train_lib._split_micro(
                        data.batch(0), shape.microbatch, 0))
            leaves = dict((p, g.to_local()) for p, g in flatten(grads))
            del grads
            big = max(leaves, key=lambda p: leaves[p].numel())
            out["codec"] = {p: _codec_on_card_and_host(leaves[p])
                            for p in (big, "final_norm/scale")}
            check(all(c["bitwise_equal"] for c in out["codec"].values()),
                  f"train_overlap: the codec on the card differs from "
                  f"the CPU's: {out['codec']}")
            if dev.type == "cuda":
                progress(f"{name}: profiles")
                local = list(leaves.values())
                out["codec_profile"] = profile_steps(
                    lambda: gcomp.start_pod_reduce(
                        local, [torch.zeros(g.shape, dtype=torch.float32,
                                            device=dev) for g in local],
                        mesh).wait(), n=3)
                del local
            del leaves
            _free(device)
            if dev.type == "cuda":
                def one():
                    nonlocal state
                    with shard_ctx.use(ctx):
                        state, _ = step(state, data.batch(0))
                out["warm_step"] = profile_steps(one, n=2)
                out["codec_share_of_step_device"] = (
                    out["codec_profile"]["device_ms"] * shape.microbatch
                    / out["warm_step"]["device_ms"])
            del state, step
            _free(device)
            # the int8 climb's experiment: (a) the overlapped step with
            # the device synchronized around each pod reduce, (b) the
            # compressed reduce run serially; both from the same seed
            progress(f"{name}: (a) synchronized overlapped path")
            with _synced_pod_reduce(dev):
                synced, _, _ = _overlap_path(cfg, shape, opt_cfg, mesh, ctx,
                                             data, dev, True, n_steps)
            _free(device)
            progress(f"{name}: (b) serial compressed path")
            comp, _, _ = _overlap_path(
                cfg, shape, opt_cfg, mesh, ctx, data, dev, True, n_steps,
                step=_compressed_serial_step(cfg, shape, opt_cfg, mesh))
            _free(device)
            for path in (synced, comp):
                check(path["launches_per_step"] == want,
                      f"{name} (a)/(b) launches per step "
                      f"{path['launches_per_step']}, want {want}")
                for k in COUNTERS:
                    out["launches"][k] += path["launches"][k]
            run["climb"] = {
                "serial": serial["losses"], "overlap": over["losses"],
                "a_synced_overlap": synced["losses"],
                "b_serial_compressed": comp["losses"],
                "a_equals_overlap": synced["losses"] == over["losses"],
                "b_equals_overlap": comp["losses"] == over["losses"],
                "grad_norms": {"serial": serial["grad_norms"],
                               "overlap": over["grad_norms"],
                               "a_synced_overlap": synced["grad_norms"],
                               "b_serial_compressed": comp["grad_norms"]}}
        emit("train_overlap", card=_CARD, **out)
        return out
    finally:
        dist.destroy_process_group()


def phase_dryrun(train, smoke=False, timeout_s: float = 900.0):
    """The port's dry run (item 10) of ``train``'s own job, in a CPU
    subprocess (no card: ``CUDA_VISIBLE_DEVICES`` empty): ``python -m
    repro_torch.launch.dryrun`` on deepseek_7b, 2 x 2048 tokens,
    microbatch 1, int8 moments, a (1, 1) mesh of a fake process group,
    its step run on fake tensors.  Held: it exits 0 with status ``ok``,
    and its state bytes are those of ``train``'s state on the card,
    exactly.  Printed: its predicted peak beside ``train``'s measured
    ``torch.cuda.max_memory_allocated``, its roofline step time beside
    ``train``'s steady step, and its wall time."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", "deepseek_7b", "--kind", "train", "--shape",
           "chip_train", "--seq-len", str(train["seq_len"]),
           "--global-batch", str(train["global_batch"]),
           "--microbatch", str(train["microbatch"]),
           "--state-bits", str(train["state_bits"]), "--mesh-shape", "1,1"]
    if smoke:
        cmd.append("--smoke")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=timeout_s, cwd=ROOT)
    wall = time.perf_counter() - t0
    lines = [x for x in r.stdout.splitlines() if x.startswith("{")]
    check(r.returncode == 0 and bool(lines),
          f"dryrun: exit {r.returncode}: {r.stderr[-2000:]}")
    line = json.loads(lines[-1])
    check(line.get("status") == "ok", f"dryrun: status {line.get('status')}")
    mem, roof = line["memory"], line["roofline"]
    out = {"wall_s": wall, "entry": line["entry"],
           "mesh_layout": line["mesh_layout"], "kernels": line["kernels"],
           "state_bytes": mem["state_bytes"],
           "train_state_bytes": train["state_bytes"],
           "state_bytes_equal": mem["state_bytes"] == train["state_bytes"],
           "predicted_peak_gb": mem["peak_bytes_per_device"] / 1e9,
           "measured_peak_gb": train.get("peak_mem_gb"),
           "predicted_step_s": roof["step_time_s"],
           "bottleneck": roof["bottleneck"],
           "compute_s": roof["compute_s"], "memory_s": roof["memory_s"],
           "collective_s": roof["collective_s"],
           "measured_steady_step_s": train["steady_step_s"],
           "flops": roof["hlo_flops"], "bytes": roof["hlo_bytes"]}
    check(out["state_bytes_equal"],
          f"dryrun: state bytes {mem['state_bytes']}, train's "
          f"{train['state_bytes']}")
    emit("dryrun", card=_CARD, **out)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside the repository)

    global _RECORD
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.jsonl"),
              "w") as record:
        _RECORD = record
        try:
            return _run_all()
        finally:
            _RECORD = None


def _free(device="cuda") -> None:
    """Release the last phase's tensors (the paged phase's taps form a
    reference cycle) so the next phase's peak memory is its own."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def emit_capture_summary(info, runs) -> None:
    """One line: each decode path's step wall time, idle share and tok/s
    run eagerly and as graph replays (the same run, the same card), its
    capture time and graph pool.  ``runs``: (name, a dense-plane or
    paged-plane record)."""
    paths = {}
    for name, run in runs:
        key = ("warm_decode_round" if "warm_decode_round" in run
               else "warm_decode_step")
        eager, captured = run[key + "_eager"], run[key]
        vs = run["captured_vs_eager"]
        paths[name] = {
            "eager": {"wall_ms": eager["wall_ms"],
                      "device_ms": eager["device_ms"],
                      "idle_share": eager["idle_share"],
                      "tok_s": vs["eager_tok_s"]},
            "captured": {"wall_ms": captured["wall_ms"],
                         "device_ms": captured["device_ms"],
                         "idle_share": captured["idle_share"],
                         "tok_s": vs["captured_tok_s"]},
            "capture_ms": run["decode_graph"]["capture_ms"],
            "pool_mb": run["decode_graph"]["pool_mb"],
            "bitwise_equal": vs["tokens_equal"] and vs.get(
                "cache_bitwise_equal", vs.get("pool_bitwise_equal"))}
    emit("decode_capture", card=info["nvidia_smi"], paths=paths)


def _run_all() -> int:
    info = phase_device()
    phase_build()
    progress("kernels")
    kern = phase_kernels()
    _free()
    progress("serve_dense")
    dense = phase_serve_dense()
    _free()
    progress("serve_paged")
    paged = phase_serve_paged()
    _free()
    progress("serve_sharded")
    serve_sharded = phase_serve_sharded(dense=dense, paged=paged)
    _free()
    progress("serve_hybrid")
    hybrid = phase_serve_hybrid()
    _free()
    progress("serve_vlm")
    vlm = phase_serve_vlm()
    _free()
    progress("serve_moe")
    moe = phase_serve_moe()
    _free()
    progress("serve_llama4")
    llama4 = phase_serve_llama4()
    _free()
    progress("serve_llama4_paged")
    llama4_paged = phase_serve_llama4_paged()
    _free()
    progress("serve_dense_groups")
    groups = phase_serve_dense_groups()
    _free()
    progress("serve_xlstm")
    xlstm = phase_serve_xlstm()
    _free()
    train = phase_train()
    _free()
    progress("train_sharded")
    train_sharded = phase_train_sharded(train=train)
    _free()
    progress("train_overlap")
    train_overlap = phase_train_overlap(train=train)
    _free()
    progress("dryrun")
    phase_dryrun(train)
    train_f32 = phase_train_f32()
    _free()
    progress("blocks")
    blocks = phase_blocks(train=train_f32, serve=hybrid)
    _free()
    train_hybrid = phase_train_hybrid()
    _free()
    progress("hybrid_sharded")
    hybrid_sharded = phase_hybrid_sharded(train=train_hybrid, serve=hybrid)
    _free()
    progress("serve_long")
    serve_long = phase_serve_long()
    _free()
    train_encoder = phase_train_encoder()
    _free()
    train_vlm = phase_train_vlm()
    _free()
    train_moe = phase_train_moe()
    _free()
    progress("moe_sharded")
    moe_sharded = phase_moe_sharded(serve=moe, train=train_moe)
    _free()
    progress("serve_long_mla")
    serve_long_mla = phase_serve_long_mla()
    _free()
    train_xlstm = phase_train_xlstm()
    _free()
    progress("xlstm_sharded")
    xlstm_sharded = phase_xlstm_sharded(train=train_xlstm, serve=xlstm)
    _free()
    preempt = phase_preempt(train=train_hybrid)
    _free()
    progress("control")
    control = phase_control(train=train_hybrid, paged=paged)
    _free()
    progress("gateway")
    gateway = phase_gateway(paged=paged)
    _free()
    progress("service")
    service = phase_service(train=train_hybrid, paged=paged, f32=train_f32,
                            gateway=gateway)

    nl = dense["launches"]
    check(nl["flash_attention"] >= 30 and nl["rmsnorm"] >= 61,
          f"dense path launches {nl}")
    pl = paged["launches"]
    check(pl["paged_attention"] >= 30 * paged["decode_rounds"] > 0
          and pl["flash_attention"] >= 30 * paged["admissions"]
          and pl["rmsnorm"] > 0 and pl["paged_attention_scalar"] == 0,
          f"paged path launches {pl}")
    # serve_hybrid's counts, and the train phases' per step, were held
    # exactly in their phases
    runs = {"dense": nl, "paged": pl,
            "serve_sharded": serve_sharded["launches"],
            "hybrid": hybrid["launches"],
            "vlm": vlm["launches"], "moe": moe["launches"],
            "llama4": llama4["launches"],
            "llama4_paged": llama4_paged["launches"],
            **{f"{arch}_{plane}": groups[arch][plane]["launches"]
               for arch in DENSE_GROUP_ARCHS
               for plane in ("dense", "paged")},
            "xlstm": xlstm["launches"],
            "train": train["launches"],
            "train_sharded": train_sharded["launches"],
            "train_overlap": train_overlap["launches"],
            "train_f32": train_f32["launches"],
            "blocks": blocks["launches"],
            "train_hybrid": train_hybrid["launches"],
            "hybrid_sharded": hybrid_sharded["launches"],
            "serve_long": serve_long["launches"],
            "train_encoder": train_encoder["launches"],
            "train_vlm": train_vlm["launches"],
            "train_moe": train_moe["launches"],
            "moe_sharded": moe_sharded["launches"],
            "serve_long_mla": serve_long_mla["launches"],
            "train_xlstm": train_xlstm["launches"],
            "xlstm_sharded": xlstm_sharded["launches"],
            "preempt": preempt["launches"], "control": control["launches"],
            "gateway": gateway["launches"], "service": service["launches"]}

    def launched(counter):
        return {run: c[counter] for run, c in runs.items()}

    scalar_norms = launched("rmsnorm_scalar")
    check(not any(scalar_norms.values()),
          f"main-path rmsnorm calls took the scalar route: {scalar_norms}")

    # the launches that ran inside decode graphs, run by run: each graph's
    # replays times its launches per replay
    graphs = {"dense": [dense["decode_graph"]],
              "paged": [paged["decode_graph"]],
              "serve_sharded": [serve_sharded["dense"]["decode_graph"],
                                serve_sharded["paged"]["decode_graph"]],
              "hybrid": [hybrid["decode_graph"]],
              "vlm": [vlm["decode_graph"]],
              "moe": [moe["decode_graph"]],
              "llama4": [llama4["decode_graph"]],
              "llama4_paged": [llama4_paged["decode_graph"]],
              **{f"{arch}_{plane}": [groups[arch][plane]["decode_graph"]]
                 for arch in DENSE_GROUP_ARCHS
                 for plane in ("dense", "paged")},
              "xlstm": [xlstm["decode_graph"]],
              "hybrid_sharded": [hybrid_sharded["serve"]["decode_graph"]],
              "serve_long": [serve_long[k]["decode_graph"]
                             for k in ("unsharded", "sharded")],
              "moe_sharded": [moe_sharded["serve"]["decode_graph"]],
              "serve_long_mla": [serve_long_mla[k]["decode_graph"]
                                 for k in ("unsharded", "sharded")],
              "xlstm_sharded": [xlstm_sharded["serve"]["decode_graph"]],
              "preempt": [preempt[k]["decode_graph_after_resume"]
                          for k in ("serve_paged", "serve_hybrid")],
              "control": [control["bob"]["decode_graph"]],
              "blocks": [blocks["carol"]["decode_graph"]],
              "gateway": gateway["decode_graphs"],
              "service": service["decode_graphs"]}

    def in_graphs(counter):
        if counter not in COUNTERS:    # fused_adamw: train only, eager
            return {}
        key = "{}.{}".format(*COUNTERS[counter])
        got = {run: sum(g["replays"] * g["launches_per_replay"].get(key, 0)
                        for g in gs) for run, gs in graphs.items()}
        return {run: n for run, n in got.items() if n}

    emit_capture_summary(info, [
        ("serve_dense", dense), ("serve_paged", paged),
        ("serve_hybrid", hybrid), ("serve_vlm", vlm), ("serve_moe", moe),
        ("serve_llama4", llama4), ("serve_llama4_paged", llama4_paged),
        *((f"{arch} {plane}", groups[arch][plane])
          for arch in DENSE_GROUP_ARCHS for plane in ("dense", "paged")),
        ("serve_xlstm", xlstm)])

    rows = []
    for name, meta in KERNEL_META.items():
        k = kern[name]
        if name == "fused_adamw":      # i8 on train, f32 on the others
            per_run = {"train": train["launches"]["fused_adamw_i8"],
                       "train_sharded":
                           train_sharded["launches"]["fused_adamw_i8"],
                       "train_overlap":
                           train_overlap["launches"]["fused_adamw_i8"]
                           + train_overlap["launches"]["fused_adamw_f32"],
                       "train_f32": train_f32["launches"]["fused_adamw_f32"],
                       "blocks": blocks["launches"]["fused_adamw_f32"],
                       "train_hybrid":
                           train_hybrid["launches"]["fused_adamw_f32"],
                       "hybrid_sharded":
                           hybrid_sharded["launches"]["fused_adamw_f32"],
                       "train_encoder":
                           train_encoder["launches"]["fused_adamw_f32"],
                       "train_vlm": train_vlm["launches"]["fused_adamw_i8"],
                       "train_moe": train_moe["launches"]["fused_adamw_i8"],
                       "moe_sharded":
                           moe_sharded["train"]["launches"]["fused_adamw_i8"],
                       "train_xlstm":
                           train_xlstm["launches"]["fused_adamw_f32"],
                       "xlstm_sharded":
                           xlstm_sharded["launches"]["fused_adamw_f32"],
                       "preempt": preempt["launches"]["fused_adamw_f32"],
                       "control": control["launches"]["fused_adamw_f32"],
                       "gateway": gateway["launches"]["fused_adamw_f32"],
                       "service": service["launches"]["fused_adamw_f32"]}
        else:
            per_run = launched(name)
        total = sum(per_run.values())
        check(total > 0, f"{name} was not launched on the main path")
        row = {"name": name, "route": "cuda", **meta,
               "launches": total, "launches_by_run": per_run,
               "launches_in_graphs_by_run": in_graphs(name),
               "max_abs_err": k["max_err"], "ms": k["kernel_ms"],
               "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
               "bound_by": k["bound_by"],
               "library_ms": k["library_ms"], "shape": k["shape"]}
        if name in SCALAR_COUNTERS:
            # the main path's calls that took the route before
            row["scalar_counter"] = SCALAR_COUNTERS[name]
            row["scalar_launches"] = sum(
                launched(SCALAR_COUNTERS[name]).values())
        if "was_route" in k:
            # a redesigned kernel: the route its main path took before
            # (flash's CUDA-core kernels, the scalar routes of the fused
            # AdamW and the paged decode kernel), timed in this run on the
            # same inputs one element off alignment (the RMSNorm forward's
            # on the same inputs, by the route named)
            row["was_ms"] = k["was_route"]["kernel_ms"]
        if name == "rmsnorm":
            # every main-path shape, both routes, and the decode rows in a
            # captured graph beside the floor
            row["shapes"] = {
                key: {f: r[f] for f in (
                    "shape", "row_stride", "max_err", "kernel_ms", "was_ms",
                    "plain_ms", "library_ms", "bound_ms", "bound_share",
                    "clean_l2")}
                for key, r in kern.items() if key in RMSNORM_KEYS}
            row["decode_in_graph"] = k["decode_in_graph"]
        if "f32" in k:
            row["f32"] = k["f32"]
        if "passes_ms" in k:
            row["passes_ms"] = k["passes_ms"]
        if name.startswith("slstm"):
            # the dependent chain: device time a position, and (forward)
            # one decode step's call
            row["step_us"] = k["step_us"]
            if "s1_ms" in k:
                row["s1_ms"] = k["s1_ms"]
        if name == "flash_attention":
            # MLA's prefill shape (head dims 192 | 128), its serve_moe
            # launches and the route each check launch took
            mla = kern["flash_attention_mla"]
            row["mla_prefill"] = {
                "shape": mla["shape"], "v_head_dim": 128,
                "launches": moe["launches"]["flash_attention"],
                "max_abs_err": mla["max_err"], "ms": mla["kernel_ms"],
                "plain_ms": mla["plain_ms"], "bound_ms": mla["bound_ms"],
                "bound_by": mla["bound_by"],
                "library_ms": mla["library_ms"],
                "was_ms": mla["was_route"]["kernel_ms"],
                "routes": mla["routes"]}
        if name == "flash_attention":
            # the other GQA groups' prefills, each run's launches
            row["gqa_prefill"] = {
                key: {f: kern[f"flash_attention_{key}"][f] for f in (
                    "shape", "kv_heads", "max_err", "kernel_ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_by")}
                for key, _, _ in GQA_PREFILLS}
        if name == "paged_attention":
            # the other GQA groups' rounds (GC = 4 and 8 beside them)
            row["gqa_groups"] = {key: k[key] for key in (
                *(g[0] for g in GQA_PREFILLS), "g4", "g8")}
        if name == "flash_attention_bwd":
            # pixtral_12b's GQA train shape and its train_vlm launches
            vt = k["vlm_train_shape"]
            row["vlm_train"] = {
                "shape": vt["shape"], "kv_heads": 8,
                "launches": train_vlm["launches"]["flash_attention_bwd"],
                "max_abs_err": vt["max_err"], "ms": vt["kernel_ms"],
                "plain_ms": vt["plain_ms"], "bound_ms": vt["bound_ms"],
                "bound_by": vt["bound_by"], "library_ms": vt["library_ms"],
                "routes": vt["routes"]}
            # MLA's train shape (head dims 192 | 128), its train_moe
            # launches and the route each check launch took
            mla = k["mla_train_shape"]
            row["mla_train"] = {
                "shape": mla["shape"], "v_head_dim": mla["v_head_dim"],
                "launches": train_moe["launches"]["flash_attention_bwd"],
                "max_abs_err": mla["max_err"], "ms": mla["kernel_ms"],
                "plain_ms": mla["plain_ms"], "bound_ms": mla["bound_ms"],
                "bound_by": mla["bound_by"],
                "library_ms": mla["library_ms"], "routes": mla["routes"]}
        if name == "fused_adamw":
            # the int8 update of a 2.52e9-element expert leaf, as train_moe
            # runs it
            leaf = k["moe_expert_leaf"]
            row["moe_expert_leaf"] = {
                "shape": leaf["shape"], "ms": leaf["kernel_ms"],
                "plain_ms": leaf["plain_ms"], "bound_ms": leaf["bound_ms"],
                "bound_by": leaf["bound_by"], "library_ms": None,
                "p_ulp": leaf["p_ulp"]}
            # pixtral_12b's largest int8 leaves, each launched once a
            # train_vlm step
            row["vlm_i8_leaves"] = {
                leaf: {"shape": r["shape"], "launches": train_vlm["steps"],
                       "max_abs_err": r["p_max_abs_err"],
                       "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                       "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                       "library_ms": None,
                       "was_ms": r["was_route"]["kernel_ms"]}
                for leaf, r in k["vlm_i8_leaves"].items()}
        row["bound_share"] = k["bound_ms"] / k["kernel_ms"]
        rows.append(row)
    line = json.dumps({"kernels": rows})
    print(line, flush=True)
    _RECORD.write(line + "\n")
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
