#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits
non-zero:

  1. device  -- the card (nvidia-smi name and power limit), torch/CUDA
                versions, and the build of every kernel from the sources
                in this checkout (timed as set-up).
  2. kernels -- each kernel of the serve path against its plain PyTorch
                version on the card, at the TPU kernel's own function
                and at the shapes the main path gives it; times of the
                kernel, the plain version and one PyTorch library call
                (the yardstick, never called by the port), the device
                time through a CUDA graph and the wrapper's host time
                per call; for the chunk matmul and the flash kernel
                also the variant each shape took, and for the flash and
                WKV kernels nvcc's registers, spills and warnings of the
                kernel each case ran.
  3. serve   -- the main path: ``repro_torch.launch.serve.main`` serving
                16 requests through qwen2.5-3b at full width and depth
                (random weights from a seed); checks every request's
                token count and that the attention kernel ran 36 times
                per prefill and per decode call.
  4. parity  -- the same port at full width and depth 2, same weights,
                on the card (kernel) and on the CPU (plain version):
                first-token logits within tolerance, greedy tokens
                equal.
  5. train   -- the train path: ``repro_torch.launch.train.spawn``
                runs 4 ranks on the one card (mesh pod 2 x data 2 x
                model 1; the ranks share the card, so the wire is gloo
                over host memory), qwen2.5-3b at full width and depth 2
                (random weights from seed 0), seq 512, global batch 8:
                one step each of zero3, zeropp and fcdp, fcdp with
                int8 qwZ/qgZ, and fcdp
                with the gather-fused collective matmul in modes
                ag_matmul and both. Checks the losses agree, the int8
                kernels and the chunk-matmul kernel ran as often as the
                plans predict, fcdp's pod all-gather bytes undercut
                zero3's and its peak device memory undercuts zeropp's,
                the fused ring moves fcdp's data-axis bytes (neutral)
                and pod bytes, and the fused caches lie in pinned host
                memory.
  6. train_parity -- the smoke-width model, the same 4-rank fcdp+int8
                step and fcdp + ag_matmul step on the card (kernels)
                and on the CPU (plain versions): loss and grad norm
                within tolerance, the same bytes.
  7. rwkv_serve -- the ssm family's serve path: rwkv6-3b at full width
                and depth (random weights from a seed, the
                zero-initialised leaves drawn), batch 8, 512-token
                prompts, one prefill and 32 greedy decode steps through
                ``StepBundle.make_prefill_step`` / ``make_decode_step``
                over the recurrent state; checks the WKV kernel ran once
                per layer and step (32 x 33), every logit is finite and
                the state keeps its leaves' shapes and dtypes.
  8. rwkv_parity -- rwkv6-3b at full width and depth 2, fp32, batch 2, a
                128-token prompt and 4 decode steps, on the card
                (kernel) and on the CPU (plain version), same weights:
                logits within 1e-3, greedy tokens equal.
  9. jamba_serve -- the hybrid family's serve path: jamba-v0.1-52b at
                full width, depth cut to 16 layers (14 mamba, 2
                attention, 8 MoE; random weights from a seed, the
                constant-initialised mamba leaves drawn), bf16, batch 8,
                512-token prompts, one prefill and 32 greedy decode
                steps through ``make_prefill_step`` / ``make_decode_step``
                over the contiguous KV cache and the mamba state; checks
                the scan kernel ran 14 x 33 times and the attention
                kernel 2 x 33, every logit is finite, the state keeps its
                leaves' shapes and dtypes and every cache's idx is 544.
 10. jamba_parity -- jamba at full width, depth 2 (attention + MLP,
                mamba + MoE), bf16, batch 2, a 128-token prompt and 4
                decode steps on the card (kernels) and on the CPU (plain
                versions), same weights, the CPU's greedy tokens fed to
                both: MoE routing equal up to router near-ties (CPU
                margin within ROUTER_STEPS bf16 steps), then logits
                within 0.1 of the CPU run forced onto the card's
                routing, and greedy tokens equal up to near-ties.
 11. peft_train -- PEFT / FCDP-Comm on the train path: qwen2.5-3b at
                full width and depth 2 on the 4 ranks of phase 5, the
                trunk frozen and LoRA adapters of rank 8 on wq/wk/wv/wo,
                grad_clip 1e9: one step each of zero3, zeropp, fcdp and
                mics, of fcdp with int8 qwZ/qgZ (on the adapters) and
                one of the mixed arm (trunk fcdp, '*lora*=zero3'). Checks
                finite losses the ranks agree on, the modes' step-0
                loss and grad norm equal, every frozen shard unchanged
                bit for bit and some lora_b moved, a trainable fraction
                under 1 %, fcdp's and the mixed arm's pod all-gather
                bytes at most 1 % of zero3's, fcdp's caches in pinned
                host memory, and the int8 launches equal to the plans
                (and > 0); reports bytes, peaks and step times.
 12. peft_parity -- peft_smoke's model (d_model 256), rank 8, fp32: the
                4-rank fcdp+int8 and mixed PEFT steps on the card and on
                the CPU from the same weights: loss and grad norm within
                tolerance, the same bytes, the plans' int8 launches on
                the card and none on the CPU.
 13. tp_train -- tensor parallelism over 'model': qwen2.5-3b at full
                width and depth 2, seq 512, global batch 8, on the
                launcher's 8-rank mesh (pod 2 x data 2 x model 2) sharing
                the card (gloo): one step each of zero3, fcdp, fcdp with
                int8 qwZ/qgZ and the int8 TP activation all-reduce, and
                fcdp with the gather-fused matmul, and fcdp with the
                int8 activation all-reduce. Checks finite
                losses the ranks agree on, zero3's, fcdp's and the fused
                run's step-0 loss and grad norm equal, the int8 runs
                within 0.08 of fcdp, every rank's int8 and chunk-matmul
                launches equal to the plans (the activation
                all-reduce's included), fcdp's pod all-gather below
                zero3's, and the int8 activation all-reduce moving about
                half the bf16 psum's bytes; reports bytes per (op, axis),
                peaks and step times.
 14. tp_parity -- tests/test_torch_tp.py's DENSE model at (2, 2, 2),
                fp32: the 8-rank fcdp step with the int8 activation
                all-reduce and the fcdp + ag_matmul step on the card and
                on the CPU from the same weights: loss and grad norm
                within tolerance, the same bytes, the plans' launches on
                the card and none on the CPU.
 15. sched_train -- the stage-1 prefetch ring and hier: qwen2.5-3b at
                full width and depth 2, seq 512, global batch 8, on phase
                5's 4 ranks (riding on its spawn, before its last arm):
                one step each of zero3 at prefetch depth 0 and 1, fcdp
                at 1 and 2 (at 0: phase 5's fcdp arm, read there), fcdp
                at 1 with int8 qwZ/qgZ and
                with the fused matmul (ag_matmul), mics at 1 (live depth
                0) and hier. Checks zero3's pod all-gather at depth 1
                equal to fcdp's and below depth 0's, fcdp's bytes at
                depths 1 and 2 equal to phase 5's depth-0 ones (op, axis)
                by (op, axis), hier's pod psum no more than zero3's and
                its pod reduce-scatter equal to its gather back, the
                step-0 losses of zero3, fcdp and hier equal, the int8 and
                chunk-matmul launches equal to the plans, each run's live
                depth and its ring bytes equal to
                ``prefetch_buffer_bytes``; reports bytes, peaks, caches
                and step times.
 16. sched_parity -- tests/test_torch_sched.py's DENSE model at
                (2, 2, 2), fp32: the 8-rank fcdp step at prefetch depth 1
                and the hier step on the card and on the CPU from the
                same weights: loss and grad norm within tolerance, the
                same bytes and ring.
 17. stream_train -- the scheduler's streams 2 and 3: qwen2.5-3b at
                full width and depth 2, seq 512, global batch 8,
                microbatch 2, on phase 5's 4 ranks: a fcdp sequential
                step, fcdp async and cross-step over the same 2 batches,
                one async step of zero3, fcdp with int8 qwZ/qgZ and with
                ag_matmul, and the cross-step composite (fcdp, the
                embedding hier) over 2 batches. Checks fcdp async's
                bytes equal to the sequential ones (op, axis) by (op,
                axis), zero3 async's pod all-gather equal to fcdp's,
                the async losses and grad norms equal to the sequential
                and to fcdp's, int8 within INT8_DRIFT, the cross-step
                losses, shifted grad norms and final shards (a SHA-256 a
                rank) equal to fcdp async's bit for bit, a piped call's
                bytes equal to a fused step's, the carry's bytes equal to
                ``cross_step_buffer_bytes``, the int8 and chunk-matmul
                launches equal to the plans; reports bytes, buffers,
                step times, and each call's peak device memory by part
                (the microbatch loop, the optimizer epilogue).
 18. stream_parity -- tests/test_torch_streams.py's DENSE model at
                (2, 2, 2), fp32, microbatch 2: the 8-rank fcdp async
                steps and cross-step calls (2 batches) on the card and on
                the CPU from the same weights: losses and grad norms
                within tolerance, the same bytes and carry.
 19. cache_train -- FCDP-Cache: qwen2.5-3b at full width and depth 2,
                seq 512, global batch 8, on phase 5's 4 ranks: one step
                each of fcdp at device-cache fraction 0.5, fcdp under
                the save_collectives activation policy and fcdp with
                int8 qwZ/qgZ and ag_matmul under block_io; then, on
                every rank, ``MemoryPlanner.plan`` (fcdp at prefetch
                depth 1, fractions 1.0 and 0.0) at an impossible budget,
                each attempt one trial step read from the allocator (its
                fraction-1.0 and fraction-0 steps the fraction's other
                two points, its fallback the block_io step), and again
                at a budget halfway between the walk's two lowest
                distinct peaks, taking the walk's peaks over the budget
                and measuring the first attempt under it again; then
                ``plan_serve`` over phase 3's paged pool on this process
                (its budget the card's memory). Checks every arm's and
                attempt's pod all-gather equal to
                ``stage1_dcn_gather_bytes``, the measured cache tiers
                moving by whole layers with the fraction while the
                analytic figures, the bytes and the values stay
                fraction 0's, block_io and save_collectives within the
                step tolerances of save_all, the launches equal to the
                extended plans, the ranks walking the same attempts in
                the reference's demote order, the mid-budget plan
                fitting at the walk's first attempt under it, and the
                serve pool fitting the card; reports the peaks, the
                memory by part, the tiers and the launches.
 20. restart -- checkpoint and restart on the train path, from work
                done on the ranks of phases 5 and 11 (printed after
                phase 11, beside the card's name and power limit): after
                phase 5's arms, its last arm's state (fcdp after one
                step, full width) saved in the JAX package's checkpoint
                format (every rank writing its blocks), its bytes, the
                blocking write's seconds, the restore into a fresh
                bundle (equal and digest-equal to the state saved), and
                one step timed without and with an async save of the
                same state in flight (the same metrics bit for bit);
                and in phase 11, fcdp-PEFT (LoRA rank 8) at microbatch
                2 with streams 2 and 3 over 3 batches through the
                launcher's restart driver, a checkpoint every 2 (the
                carry section riding along), clean and with a failure
                injected at step 2, once the step-2 checkpoint is
                written: the same per-step losses and final shards
                (SHA-256 a rank) after the restore. Fails when the
                disk cannot hold two dense checkpoints.
 21. family_train -- training of the ssm and hybrid families: the Mamba
                scan's forward and gradient (``ops.mamba_scan_train``,
                the adjoint on the same kernel) against autograd of its
                plain version at [2, 64, 512] fp32, with h0 and without
                (the kernel launched twice each), and the forward and
                the adjoint timed at a rank's hybrid shape; then, one
                step an arm on phase 5's 4 ranks (riding on phase 17's
                spawn after its arms), seq 512, global batch 8, bf16:
                rwkv6-3b at full width and depth 2 under zero3 and fcdp,
                and jamba's widths in one period of 2 layers ((attention,
                MLP), (Mamba, MoE), 4 of its 16 experts) under zero3,
                fcdp with int8 qwZ/qgZ and the fused matmul (ag_matmul),
                and the mixed layout (experts mics, embedding hier).
                Checks finite losses the ranks agree on, an aux loss on
                the hybrid arms only, the losses and the mixed grad
                norm equal to zero3's (int8 within INT8_DRIFT), every
                rank's scan, int8 and chunk-matmul launches equal to
                the plans and to the calls (no plain version ran), and
                fcdp's pod all-gather below zero3's on both families;
                reports the bytes, peaks and step times.
 22. family_parity -- tests/test_system.py's t-jamba and t-rwkv at
                (2, 2, 1), fp32: one fcdp step each on the card and on
                the CPU (riding on phase 6's jobs), from the same
                weights: loss, aux loss and grad norm within the step
                tolerances, the same bytes, the scan's plan launched on
                the card and only called on the CPU.

 23. arch_kernels -- the flash kernel at the head dims of the six archs
                the port gained last, against its plain version at their
                serve paths' shapes: gemma-2b's paged prefill chunk and
                decode (hd 256, 8 q heads on 1 kv head, 528 keys) and
                kimi-k2's contiguous prefill and decode (hd 112, 64 / 8
                heads, 544 positions), timed (a CUDA graph, host us,
                the bound, SDPA); nvcc's report of each kernel must show
                no spill.
 24. arch_serve -- the six archs served at full width in bf16 (random
                weights from a seed): gemma-2b (18 layers), granite-3-8b
                (40), yi-34b (30 of 60) and chameleon-34b (24 of 48)
                through the paged engine (8 of the serve phase's
                mixed_requests: 512 positions, 16 generated, batch 8,
                chunks of 128);
                kimi-k2 and llama4-maverick at one layer with all their
                experts (384, 128) through the contiguous steps (batch
                8, a 512-token prompt, 32 greedy decode steps). Checks
                every request's tokens, the flash launches (one a layer
                and call), finite logits and the caches' idx; reports
                TTFT, TPOT, tokens/s, the variant a step takes, the peak
                memory and the card.
 25. arch_train -- gemma-2b and granite-3-8b at depth 2, yi-34b and
                chameleon-34b at depth 1, full width, one fcdp step each
                on phase 5's 4 ranks (riding on phase 17's spawn), seq
                512, global batch 8, bf16: finite metrics the ranks
                agree on; reports the bytes by (op, axis) (gemma's tied
                table gathered and reduced at both ends), the peaks and
                the step times. kimi-k2 and llama4-maverick do not train
                on one card (their embedding and head alone hold ~2.1-
                2.4 B parameters); the CPU tests hold their step.
 26. arch_parity -- card against CPU: the six archs' smoke configs, one
                fcdp step each at (2, 2, 1) in fp32 on phase 6's jobs
                (loss, aux loss, grad norm, bytes); then gemma-2b and
                kimi-k2 (8 of its experts) at full width, depth 1, bf16,
                through the contiguous steps (a 64-token prompt, batch
                2, 8 decode steps; the CPU's tokens fed to both, MoE
                routing as in jamba_parity): logits within 0.1, tokens
                equal up to near-ties.
 27. encdec_kernels -- the flash kernel's non-causal paths at
                seamless-m4t-medium's serve shapes (hd 64, 16 heads):
                the encoder's self-attention [8, 136 over 136 keys], the
                cross-attention's prefill [8, 512 over 136] (mma.sync)
                and decode [8, 1 over 136] (split-KV, 3 splits), timed
                (a CUDA graph, host us, the bound, SDPA); untimed, the
                same with nonzero q_offset (ignored without the mask)
                and at a GQA group of 2; no spill.
 28. encdec_serve -- seamless-m4t-medium at full width and depth (12
                encoder + 12 decoder layers), bf16, random weights:
                batch 8, 136 encoder frames, 512-token prompts, 32
                greedy decode steps through ``make_prefill_step`` (the
                frames, the prompt) / ``make_decode_step``. Checks the
                flash launches (36 a prefill, 24 a decode step), finite
                logits, token ids, the caches; reports prefill time,
                TPOT, the variants and the peak memory.
 29. encdec_train -- seamless-m4t-medium whole (12 + 12 layers), full
                width, on phase 5's 4 ranks (riding on phase 17's
                spawn), seq 512, 128 frames, global batch 8, bf16: one
                step of zero3 and one of fcdp with int8 qwZ/qgZ and
                ag_matmul. Checks the losses agree (INT8_DRIFT), the
                int8 and chunk-matmul launches equal the plans, fcdp's
                pod all-gather below zero3's; reports bytes per (op,
                axis), peaks and step times.
 30. encdec_parity -- card against CPU: the smoke config's fcdp step at
                (2, 2, 1) in fp32 on phase 6's jobs (loss, grad norm,
                bytes); then full width, 1 + 1 layers, bf16, through
                the contiguous steps (the frames, a 64-token prompt,
                batch 2, 8 decode steps): logits within 0.1, tokens
                equal up to near-ties.
 31. dryrun -- the port's dry run (``repro_torch.launch.dryrun``: one
                rank's train step on fake CPU tensors over a collective
                with no wire), in DRYRUN_WORKERS processes started
                (and warmed up) while the kernels build, idle until the
                last timed phase is over (beside phases 3-10 they slowed
                the serve paths' host-bound steps): ``train_4k`` on the
                production mesh (pod 2, data 16, model 16) for the ten
                archs under fcdp at the dry run's depth 1 (each cut to
                DRYRUN_LAYERS, a hybrid to one period, the
                encoder-decoder to 2 + 2), and qwen2.5-3b whole under
                zero3, fcdp, zero3 + PEFT and fcdp + PEFT at depth 0,
                whose bytes per (op, axis) must equal the JAX trace's
                (JAX_QWEN_TRAIN_4K) and FLOPs lie within 2 % of it;
                prints each row's pod all-gather and total, FLOPs a chip,
                peak estimate against the card's memory and dominant
                roofline term. Then the dry run of phase 5's fcdp arm at
                its own config, mesh and shape: its bytes must equal the
                arm's measured bytes a step; its peak estimate over the
                arm's measured step peak is printed (``peak_ratio``).

Each parity phase runs its card and its CPU job side by side.

Phase 2 also holds the three int8 kernels (qwZ/qgZ) bit-exact to their
plain versions at the train and PEFT phases' shapes, at the int8 TP
activation all-reduce's, at stream_train's leaf level and at
seamless-m4t-medium's shards, quantize and dequantize also in the
callers' chunked layouts (n chunks of ragged, unaligned sizes; bf16 and
fp32 in and out), dequant-accumulate also into qgZ's chunk in bf16 and
requantizing for the int8 TP all-reduce (n of 1-5, ragged chunks), with
every quant kernel compiled without a spill, and times the callers'
local passes on either side of the wire (qgZ's arrival and the whole
TP all-reduce included) beside the kernels alone (``int8_local_pass``
lines), the chunk-matmul kernel
of the fused ring within tolerance of its plain version (and bit for bit
column-independent, its wgmma + TMA variant bit-equal to its mma.sync
one) at the train phase's shapes, mode 'both''s transposed operands read
in place, and ragged ones, and the
RWKV-6 WKV kernel within tolerance of its plain version at the rwkv
serve path's prefill and decode shapes, tests/test_kernels.py's sweep
and its strong-decay case, S of 100, 37 and 1 (a last staged chunk of
4 or 5 steps, the decode kernel) at every hd in fp32 and bf16 with and
without a carried state (the fp32 final state within WKV_TOL in every
case), the flash kernel at the jamba path's shapes, its split-KV decode
variant at the edges of its splits (offset 0, last visible keys ending a
split, ragged Skv, GQA groups of 1-16, hd 64, non-causal) and its
keys-per-split sweep,
and the Mamba scan kernel within tolerance of its plain version at the
jamba path's prefill and decode shapes, tests/test_kernels.py's sweep,
ragged shapes and a long-memory case. Then
the card's name and
power limit, the kernels' JSON line, and the result line ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the port beside this script, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
FLASH_TPU_KERNEL = "src/repro/kernels/flash_attention.py:25"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
QUANT_SOURCE = "src/repro_torch/kernels/csrc/quant.cu"
QUANT_TPU_KERNELS = {"quantize": "src/repro/kernels/quant.py:48",
                     "dequantize": "src/repro/kernels/quant.py:74",
                     "dequant_accumulate": "src/repro/kernels/quant.py:95"}
QUANT_NAMES = {"quantize": "int8_quantize_blocks",
               "dequantize": "int8_dequantize_blocks",
               "dequant_accumulate": "int8_dequant_accumulate"}
MM_SOURCE = "src/repro_torch/kernels/csrc/collective_matmul.cu"
MM_TPU_KERNEL = "src/repro/kernels/collective_matmul.py:64"
WKV_SOURCE = "src/repro_torch/kernels/csrc/wkv6.cu"
WKV_TPU_KERNEL = "src/repro/kernels/rwkv6_scan.py:76"
# wkv6 vs its plain version: fp32 outputs and states within rtol = atol
# = 2e-3 (tests/test_kernels.py:66-69; the kernel walks the steps one by
# one, the plain version in chunks, both in fp32); bf16 outputs within
# one bf16 step of the plain value, plus 2e-3 (both round an fp32 value
# that agrees to ~1e-5 once to bf16, and a value on the edge of a step
# may round to its neighbour).
WKV_TOL = 2e-3
# operations the recurrence needs per state element and step: r.S (one
# FMA) and S = w S + k v (a product and an FMA), fp32 on the CUDA cores
WKV_FLOPS_PER_ELEMENT = 5
RWKV_BATCH, RWKV_PROMPT, RWKV_DECODE = 8, 512, 32
RWKV_PARITY = dict(depth=2, batch=2, prompt=128, decode=4, logit_tol=1e-3)
SCAN_SOURCE = "src/repro_torch/kernels/csrc/mamba_scan.cu"
SCAN_TPU_KERNEL = "src/repro/kernels/mamba_scan.py:25"
# mamba_scan vs its plain version: both walk the steps one by one in
# fp32, the kernel with one FMA a step, the plain version with a product
# and a sum (one rounding more); held to tests/test_kernels.py:112-113's
# 1e-4, relative to max(1, max |h|) where |h| grows (long memory: a =
# 0.999 over 512 steps sums ~20 b's of N(0, 1))
SCAN_TOL = 1e-4
# jamba-v0.1-52b's 32 layers cut to 16 (48.5 GiB of bf16 weights; the
# full 96.1 GiB do not fit one 80 GB card): two period-8 groups
JAMBA_DEPTH = 16
JAMBA_BATCH, JAMBA_PROMPT, JAMBA_DECODE = 8, 512, 32
# the full-width parity model: 2 layers of period 2, attention at 0
# (jamba-smoke's layout), bf16 (the flash kernel takes bf16 only)
JAMBA_PARITY = dict(depth=2, batch=2, prompt=128, decode=4, logit_tol=0.1)
# card vs CPU router logits: the router's bf16 input (the residual after
# a mamba sublayer, whose bf16 elementwise ops round differently on the
# two devices) differs by single bf16 steps in some elements, so its
# bf16 logits may lie a few steps apart; a top-2 margin within that
# noise may route a token to another expert on each side. 8 is about
# twice the 3.75 steps read on the card, with CPU margins of 1-2 steps
# at the three tokens routed otherwise (PERF.md, jamba_parity)
ROUTER_STEPS = 8
# phase dryrun: its worker processes, the ten archs' depth cut, and the
# JAX package's trace of qwen2.5-3b's train_4k step at (2, 16, 16), depth
# 0, the dry run's loss_chunk 2048 and block_io (jax 0.9.0, trace only,
# as tests/test_torch_dryrun.py's _reference_prod traces it, at 36
# layers): per (op, axis) bytes a chip and FLOPs a chip
DRYRUN_WORKERS = 7           # the card's host has 8 cores
DRYRUN_LAYERS = 2
DRYRUN_FLOPS_RTOL = 0.02
JAX_QWEN_TRAIN_4K = {
    "zero3": ({"all_gather/pod": 28549248.0, "all_gather/data": 856477440.0,
               "psum/model": 57127157767.5, "psum/data": 86430.0,
               "psum/pod": 2880.765625, "psum_scatter/data": 464705280.0,
               "psum_scatter/pod": 15490176.0}, 68878390525952.0),
    "fcdp": ({"all_gather/pod": 15490176.0, "all_gather/data": 856477440.0,
              "psum/model": 57127157767.5, "psum/data": 86430.0,
              "psum/pod": 2880.765625, "psum_scatter/data": 464705280.0,
              "psum_scatter/pod": 15490176.0}, 68878390525952.0),
    "zero3_peft": ({"all_gather/pod": 28844160.0,
                    "all_gather/data": 865324800.0,
                    "psum/model": 57164759047.5, "psum/data": 829470.0,
                    "psum/pod": 27648.765625, "psum_scatter/data": 4423680.0,
                    "psum_scatter/pod": 147456.0}, 54596550524928.0),
    "fcdp_peft": ({"all_gather/pod": 147456.0, "all_gather/data": 473552640.0,
                   "psum/model": 57164759047.5, "psum/data": 829470.0,
                   "psum/pod": 27648.765625, "psum_scatter/data": 4423680.0,
                   "psum_scatter/pod": 147456.0}, 54596550524928.0)}
TRAIN_DEPTH = 2            # qwen2.5-3b's 36 layers cut to 2 for the train phase
TRAIN_SEQ, TRAIN_BATCH = 512, 8
# train phase tolerances: tests/test_system.py's across modes (fp32
# reductions in another order); the int8 drift bound of test_quant.py
LOSS_RTOL, GNORM_RTOL, INT8_DRIFT = 1e-4, 1e-3, 1e-2
# H100 SXM published peaks (dense): bf16 tensor-core rate, HBM rate
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12       # CUDA cores, no tensor cores (no TF32)
PEAK_HBM_BYTES = 3.35e12
L2_BYTES = 50 * 2 ** 20      # its L2 cache; a timed call's inputs rotate
MAX_ROTATIONS = 64           # past twice it (``rotations``)
# matmul_chunk vs its plain version (x @ w, cuBLAS with fp32 reductions):
# both sum the K products of an output in fp32, in their own orders, and
# round once to the output dtype. Per element |diff| <= one unit in the
# last place of |plain| in the output dtype (bf16; 0 for f32) plus
# 2 K 2^-24 (|x| @ |w|), the textbook bound of a K-term fp32 dot product
# once for each side (it matters only where a sum cancels towards 0).
# bf16 on average: mean |diff| <= 1e-3 x mean |plain| (half a bf16 step
# is 2e-3 relative at most, ~1e-3 on average).
MM_MEAN_REL_TOL = 1e-3
# Kernel vs plain version, bf16 outputs. Per element |diff| <= 2e-2: the
# two sum in different orders and round to bf16, and the largest
# outputs (|out| in [2, 4), rows that see a handful of keys) are one
# bf16 step (0.0156) apart at worst. Per case mean |diff| <= 1e-2 x
# mean |plain|: rounding p and the output to bf16 costs ~2e-3 of the
# mean, while one key too many or too few at the causal edge moves a
# row by ~1/n of |v|, several percent of mean |out| at the main path's
# windows (n ~ 250 keys).
MAX_ABS_TOL = 2e-2
MEAN_REL_TOL = 1e-2
SERVE_ARGS = ["--arch", "qwen2.5-3b", "--requests", "16", "--seq-len", "512",
              "--gen-len", "16", "--batch", "8", "--chunk", "128",
              "--seed", "0"]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


# the script's start on the host clock: every phase line carries its
# seconds since then (``t_s``), so a run's time splits by phase
T0 = time.perf_counter()


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, "t_s": time.perf_counter() - T0,
                      **kw}), flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """``base<args>`` from a mangled kernel name: the length-prefixed
    identifier ending in ``_kernel``, then its template arguments
    (integers and bools as numbers, float as f32, __nv_bfloat16 as
    bf16, int8_t as int8)."""
    # the shortest length-prefixed identifier ending in _kernel (a longer
    # one would take in the digits of a namespace hash before it)
    found = [(int(m.group()[i:]), m.end())
             for m in re.finditer(r"\d+", mangled)
             for i in range(len(m.group()))]
    found = sorted((n, at) for n, at in found
                   if n and mangled[at:at + n].endswith("_kernel")
                   and mangled[at:at + n].isidentifier())
    for n, at in found[:1]:
        base = mangled[at:at + n]
        args, j = [], at + n
        if mangled[j:j + 1] == "I":
            j += 1
            while j < len(mangled) and mangled[j] != "E":
                if mangled[j] == "L":
                    k = mangled.index("E", j)
                    args.append(mangled[j + 2:k])
                    j = k + 1
                elif mangled[j] in "fa":
                    args.append("f32" if mangled[j] == "f" else "int8")
                    j += 1
                elif mangled[j].isdigit():
                    d = re.match(r"\d+", mangled[j:]).group()
                    ident = mangled[j + len(d):j + len(d) + int(d)]
                    args.append("bf16" if ident == "__nv_bfloat16" else ident)
                    j += len(d) + int(d)
                else:
                    break
        return base + (f"<{','.join(args)}>" if args else "")
    return mangled


def ptxas_summary(log: Path) -> dict:
    """Registers, static shared memory and spill bytes per compiled
    kernel, from nvcc's ``-Xptxas -v`` report kept beside the library
    (the wgmma kernels' shared memory is dynamic: their sources' T_SMEM
    and P_SMEM), and any performance warning ptxas printed."""
    out, name = {}, None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = kernel_name(m.group(1))
            out[name] = {"smem_bytes": 0}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m and name:
            out[name]["smem_bytes"] = int(m.group(1))
        if "Performance Loss" in line or "setmaxnreg ignored" in line:
            out.setdefault("warnings", []).append(line.strip())
    return out


def case_ptxas(lib: str, kernel: str) -> dict:
    """nvcc's report for one compiled kernel of library ``lib``
    (``kernel_name``'s form, e.g. ``flash_decode_split_kernel<128>``):
    registers, shared memory and spills, and every performance warning
    ptxas printed for the library."""
    from repro_torch.kernels import _build
    rep = ptxas_summary(_build.library_path(lib).with_suffix(".log"))
    return {"kernel": kernel, **rep.get(kernel, {}),
            "warnings": rep.get("warnings", [])}


FLASH_KERNELS = {"mma": "flash_fwd_kernel<{hd}>",
                 "tma": "flash_fwd_wgmma_kernel",
                 "split": "flash_decode_split_kernel<{hd}>"}
WKV_KERNELS = {False: "wkv6_kernel", True: "wkv6_step_kernel"}


def check_split_counters(phase: str) -> int:
    """Every split-KV decode counter buffer is all zeros again after
    ``phase`` (the kernel's contract: a count left behind would make a
    later call merge its splits wrongly). Returns the buffers held."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    torch.cuda.synchronize()
    for (dev, stream), buf in fa._COUNTERS.items():
        left = int(torch.count_nonzero(buf).item())
        check(left == 0, f"{phase}: {left} split-KV decode counters on "
              f"{dev} (stream {stream:#x}) are not zero after the phase")
    return len(fa._COUNTERS)


def rotations(nbytes: float) -> int:
    """How many copies of a timed call's inputs to take in turn: enough
    that twice the card's L2 is read and written between two calls on
    one copy (``nbytes`` a call), so each call reads its inputs from HBM
    as a step does, not from the L2 the previous call filled. At most
    ``MAX_ROTATIONS``: a call that small sits at the launch floor."""
    return int(min(MAX_ROTATIONS, max(1, -(-2 * L2_BYTES // max(nbytes, 1)))))


def _turns(fn, iters: int):
    """``fn``: a call, or a list of calls (each on copies of the inputs,
    ``rotations``) taken in turn; at least one round of them."""
    calls = list(fn) if isinstance(fn, (list, tuple)) else [fn]
    return calls, max(iters, len(calls))


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    calls, iters = _turns(fn, iters)
    for i in range(warmup):
        calls[i % len(calls)]()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        calls[i % len(calls)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Device ms per call without the host: ``iters`` calls captured in
    one CUDA graph, timed over a replay (``cuda_ms`` times eager calls,
    which a wrapper's host cost can set when the kernel is short)."""
    import torch
    calls, iters = _turns(fn, iters)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(warmup):
            calls[i % len(calls)]()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call: ``calls`` calls on a host clock, no
    sync inside (the wrapper's checks, descriptor encoding and launch)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return t


# -- phase 2 -----------------------------------------------------------------

def attention_bound(B, Sq, Skv, H, Hk, hd, offsets, causal):
    """Least time for the work these inputs need: 4*hd flops per (query,
    head, visible key); bytes of q and out, of the K/V rows some query
    of the row can see, and of q_offset. Returns (ms, bound_by)."""
    flops, kv_rows = 0, 0
    for off in offsets:
        keys = [min(Skv, off + i + 1) if causal else Skv for i in range(Sq)]
        flops += 4 * H * hd * sum(keys)
        kv_rows += max(keys)
    nbytes = 2 * (2 * B * Sq * H * hd + 2 * kv_rows * Hk * hd) + 4 * B
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def kernel_case(name, B, Sq, Skv, H, Hk, hd, offsets, causal, gen,
                timed=False):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa, ops, ref

    dev = "cuda"
    q = torch.randn(B, Sq, H, hd, generator=gen, device=dev).bfloat16()
    k = torch.randn(B, Skv, Hk, hd, generator=gen, device=dev).bfloat16()
    v = torch.randn(B, Skv, Hk, hd, generator=gen, device=dev).bfloat16()
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)
    got = ops.flash_attention(q, k, v, off, causal)
    torch.cuda.synchronize()
    want = ref.attention_plain(q, k, v, off, causal)
    d = (got.float() - want.float()).abs()
    kind = fa.variant(Sq, H, Hk, hd)
    out = {"case": name, "shape": {"B": B, "Sq": Sq, "Skv": Skv, "H": H,
                                   "Hk": Hk, "hd": hd, "causal": causal},
           "offsets": list(offsets), "variant": kind,
           "ptxas": case_ptxas("flash_attention",
                               FLASH_KERNELS[kind].format(hd=hd)),
           "max_abs_err": d.max().item(), "mean_abs_err": d.mean().item(),
           "mean_abs_plain": want.float().abs().mean().item(),
           "finite": bool(torch.isfinite(got).all().item())}
    if kind == "split":
        out["keys_per_split"], out["splits"], _ = fa.split_plan(
            B, H, Hk, Skv, hd)
    check(out["finite"], f"{name}: kernel output not finite")
    check(out["max_abs_err"] <= MAX_ABS_TOL,
          f"{name}: kernel disagrees with plain version "
          f"(max |diff| {out['max_abs_err']} > {MAX_ABS_TOL})")
    check(out["mean_abs_err"] <= MEAN_REL_TOL * out["mean_abs_plain"],
          f"{name}: kernel disagrees with plain version on average "
          f"(mean |diff| {out['mean_abs_err']} > {MEAN_REL_TOL} x mean "
          f"|plain| {out['mean_abs_plain']})")
    if timed:
        def call():
            return ops.flash_attention(q, k, v, off, causal)
        out["ms"] = cuda_ms(call, 50)
        out["device_ms"] = graph_ms(call)
        out["host_us"] = host_us(call)
        out["plain_ms"] = cuda_ms(
            lambda: ref.attention_plain(q, k, v, off, causal), 20)
        # yardstick: one PyTorch call computing the same function
        kpos = torch.arange(Skv, device=dev)
        qpos = off[:, None] + torch.arange(Sq, device=dev)[None, :]
        mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask if causal else None,
                enable_gqa=True)
        lib = library().transpose(1, 2)
        out["library_max_abs_err"] = (lib.float() - want.float()
                                      ).abs().max().item()
        out["library_ms"] = cuda_ms(library, 50)
        out["bound_ms"], out["bound_by"] = attention_bound(
            B, Sq, Skv, H, Hk, hd, offsets, causal)
    return out


def split_sweep(gen) -> list:
    """Device ms of the split-KV decode kernel at both serve decode
    shapes for every keys-per-split it takes (16, 32, 64, 128), each
    launched directly (no count) and held to the plain version: the
    measurement behind ``flash_attention.split_plan``'s 64."""
    import torch
    from repro_torch.kernels import _build, flash_attention as fa, ref
    rows = []
    for name, B, Skv, H, Hk in (("decode", 8, 512, 16, 2),
                                ("jamba_decode", JAMBA_BATCH,
                                 JAMBA_PROMPT + JAMBA_DECODE, 32, 8)):
        q = torch.randn(B, 1, H, 128, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(B, Skv, Hk, 128, generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        off = torch.randint(Skv - 64, Skv, (B,), generator=gen,
                            device="cuda", dtype=torch.int32)
        want = ref.attention_plain(q, k, v, off, True)
        out = torch.empty_like(q)
        for keys in (16, 32, 64, 128):
            splits = -(-Skv // keys)
            ws = torch.empty(splits * B * H * 130, device="cuda")
            cnt = torch.zeros(B * Hk, dtype=torch.int32, device="cuda")

            def call():
                return _build.launch(
                    q.device, fa._kernels()["split"], q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), off.data_ptr(),
                    out.data_ptr(), ws.data_ptr(), cnt.data_ptr(), B, Skv,
                    H, Hk, 128, keys, 1, 128 ** -0.5)
            check(call() == 0, f"split decode launch failed ({keys} keys)")
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            check(err <= MAX_ABS_TOL, f"split decode at {keys} keys a split "
                  f"disagrees with plain version (max |diff| {err})")
            rows.append({"shape": name, "keys_per_split": keys,
                         "splits": splits, "ctas": B * Hk * splits,
                         "max_abs_err": err, "device_ms": graph_ms(call),
                         "chosen": fa.split_plan(B, H, Hk, Skv, 128)[0]
                         == keys})
    return rows


def phase_kernels():
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for S in (512, 200):                  # the TPU kernel's own function
        for causal in (True, False):
            cases.append(kernel_case(
                f"tpu_fn_S{S}_{'causal' if causal else 'full'}", 2, S, S,
                16, 16, 128, [0, 0], causal, gen))
    # the main path's shapes: seq-len 512 in pages of 16 -> a 512-key
    # window per row; prefill chunks start at multiples of the chunk
    prefill = kernel_case("prefill_chunk", 8, 128, 512, 16, 2, 128,
                          [0, 128, 256, 384, 0, 128, 256, 0], True, gen,
                          timed=True)
    offs = torch.randint(16, 512, (8,), generator=gen, device="cuda")
    decode = kernel_case("decode", 8, 1, 512, 16, 2, 128,
                         offs.tolist(), True, gen, timed=True)
    cases += [prefill, decode]
    cases.append(kernel_case("hd16", 8, 32, 128, 4, 2, 16,
                             [0, 32, 64, 96, 0, 32, 64, 0], True, gen))
    # the jamba path's shapes: 32/8 heads of 128 over the contiguous
    # cache of 544 positions, the 512-token prompt from 0 and a decode
    # token at its position
    kv_len = JAMBA_PROMPT + JAMBA_DECODE
    jamba = {"prefill": kernel_case(
        "jamba_prefill", JAMBA_BATCH, JAMBA_PROMPT, kv_len, 32, 8, 128,
        [0] * JAMBA_BATCH, True, gen, timed=True)}
    offs = torch.randint(JAMBA_PROMPT, kv_len, (JAMBA_BATCH,), generator=gen,
                         device="cuda")
    jamba["decode"] = kernel_case("jamba_decode", JAMBA_BATCH, 1, kv_len, 32,
                                  8, 128, offs.tolist(), True, gen,
                                  timed=True)
    cases += list(jamba.values())
    # the split-KV decode variant's edges: offset 0 (only key 0 visible),
    # last visible keys that end a split (64 keys a split at both serve
    # shapes), ragged Skv, GQA groups of 1, 2, 4, 8 and 16,
    # hd 64, and a non-causal decode
    cases += [
        kernel_case("decode_offset0", 8, 1, 512, 16, 2, 128, [0] * 8, True,
                    gen),
        kernel_case("decode_split_ends", 8, 1, 512, 16, 2, 128,
                    [31, 63, 95, 127, 255, 287, 479, 511], True, gen),
        kernel_case("jamba_decode_split_ends", 8, 1, kv_len, 32, 8, 128,
                    [63, 127, 383, 511, 543, 0, 64, 447], True, gen),
        kernel_case("decode_ragged_37_gqa8", 3, 1, 37, 8, 1, 128,
                    [36, 0, 20], True, gen),
        kernel_case("decode_ragged_545_gqa1", 4, 1, 545, 4, 4, 128,
                    [544, 100, 0, 511], True, gen),
        kernel_case("decode_gqa2", 8, 1, 300, 8, 4, 128,
                    [299, 150, 31, 32, 0, 64, 255, 256], True, gen),
        kernel_case("decode_gqa4_hd64", 8, 1, 512, 16, 4, 64,
                    [511, 37, 200, 16, 300, 128, 64, 400], True, gen),
        kernel_case("decode_gqa16", 2, 1, 1000, 16, 1, 128, [999, 500], True,
                    gen),
        kernel_case("decode_noncausal", 8, 1, 512, 16, 2, 128, [0] * 8,
                    False, gen)]
    for c in cases:
        emit("kernels", **c)
    emit("kernels", kernel="flash_attention", case="split_sweep",
         rows=split_sweep(gen))
    return prefill, decode, jamba


def int8_bound(kind, nb, n=1, elt=4, elems=None, requantize=False):
    """Least time: the bytes the function must move (each input read
    once, each output written once) over the HBM rate; a few flops per
    byte, so bytes bind. ``elems``: the dense elements a quantize reads
    or a dequantize or dequant-accumulate writes, ``elt`` bytes each
    (default: nb whole blocks); a requantizing dequant-accumulate writes
    nb blocks and scales instead. Returns (ms, bound_by)."""
    elems = nb * 256 if elems is None else elems
    if kind == "quantize":
        nbytes = elems * elt + nb * 256 + nb * 4
    elif kind == "dequantize":
        nbytes = nb * 256 + nb * 4 + elems * elt
    else:
        nbytes = n * (nb * 256 + nb * 4) + (
            nb * 260 if requantize else elems * elt)
    return nbytes / PEAK_HBM_BYTES * 1e3, "bytes"


def int8_case(kind, name, nb, gen, n=2, dtype="float32", timed=False,
              n_chunks=1, chunk_elems=None, blocks_per_chunk=None, offset=0,
              requantize=False):
    """One int8 kernel against its plain version on the card, bit for
    bit (``torch.equal``). Quantize and dequantize take the chunked
    layout: ``n_chunks`` chunks of ``chunk_elems`` elements (default: nb
    whole blocks), quantized from ``dtype`` (read from ``offset``
    elements into its buffer, so a chunk may start unaligned) into
    ``blocks_per_chunk`` blocks each, or dequantized into ``dtype``.
    Dequant-accumulate folds ``n`` sources of nb blocks into the first
    ``chunk_elems`` elements in ``dtype``, or with ``requantize``
    (``int8_dequant_requantize``, the same kernel) into int8 blocks and
    scales. A timed case takes copies of its inputs in turn
    (``rotations``)."""
    import torch
    from repro_torch.kernels import ops, ref

    dt = getattr(torch, dtype)
    layout = {}
    if kind == "quantize":
        if chunk_elems is None:
            chunk_elems = nb * 256 // n_chunks
        elems = n_chunks * chunk_elems
        buf = torch.randn(offset + elems, generator=gen, device="cuda")
        x = (buf * 0.02).to(dt)[offset:]
        layout = dict(n_chunks=n_chunks, chunk_elems=chunk_elems,
                      blocks_per_chunk=blocks_per_chunk)
        nb = n_chunks * (blocks_per_chunk or -(-chunk_elems // 256))
        args = (x,)
        fn, plain = ops.int8_quantize_blocks, ref.int8_quantize_blocks_plain
    else:
        lead = (nb,) if kind == "dequantize" else (n, nb)
        q = torch.randint(-127, 128, lead + (256,), generator=gen,
                          device="cuda", dtype=torch.int8)
        s = torch.rand(lead + (1,), generator=gen, device="cuda") * 1e-3
        args = (q, s)
        if kind == "dequantize":
            layout = dict(n_chunks=n_chunks, chunk_elems=chunk_elems,
                          out_dtype=dt)
            elems = nb * 256 if chunk_elems is None else n_chunks * chunk_elems
            fn, plain = (ops.int8_dequantize_blocks,
                         ref.int8_dequantize_blocks_plain)
        elif requantize:
            elems = nb * 256
            fn = ops.int8_dequant_requantize
            plain = ref.int8_dequant_requant_plain
        else:
            layout = dict(chunk_elems=chunk_elems, out_dtype=dt)
            elems = nb * 256 if chunk_elems is None else chunk_elems
            fn, plain = ops.int8_dequant_accumulate, ref.int8_dequant_acc_plain
    got = fn(*args, **layout)
    torch.cuda.synchronize()
    want = plain(*args, **layout)
    got_t = got if isinstance(got, tuple) else (got,)
    want_t = want if isinstance(want, tuple) else (want,)
    equal = all(a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(got_t, want_t))
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got_t, want_t))
    out = {"kernel": QUANT_NAMES[kind], "case": name, "nb": nb,
           "n": n if kind == "dequant_accumulate" else None,
           "dtype": "int8" if requantize else dtype,
           "bit_exact": equal, "max_abs_err": err}
    if kind != "dequant_accumulate":
        out.update(n_chunks=n_chunks, chunk_elems=elems // n_chunks,
                   offset=offset)
    else:
        out.update(chunk_elems=None if requantize else elems,
                   requantize=requantize)
    check(equal, f"{QUANT_NAMES[kind]} {name}: kernel differs from its "
          f"plain version (max |diff| {err})")
    if timed:
        bound_ms, bound_by = int8_bound(
            kind, nb, n, elt=torch.finfo(dt).bits // 8, elems=elems,
            requantize=requantize)
        runs = [args] + [tuple(a.clone() for a in args) for _ in range(
            rotations(bound_ms * PEAK_HBM_BYTES / 1e3) - 1)]
        out["ms"] = cuda_ms([lambda a=a: fn(*a, **layout) for a in runs], 50)
        out["device_ms"] = graph_ms([lambda a=a: fn(*a, **layout)
                                     for a in runs])
        out["host_us"] = host_us(lambda: fn(*args, **layout))
        out["plain_ms"] = cuda_ms([lambda a=a: plain(*a, **layout)
                                   for a in runs], 10)
        # no single PyTorch call computes any of the three functions
        out.update(library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                   copies=len(runs))
    return out


class Loopback:
    """A collective over ``n`` ranks with no wire: an all-gather returns
    n copies of what it was first handed, an all-to-all a copy of it,
    each kept by shape and dtype, so a caller's local passes on either
    side of the wire run (and time) alone. ``sent`` keeps the first
    tensor of each kind, the wire's bytes."""

    def __init__(self, n):
        self.n, self.kept, self.sent = n, {}, []
        self.mesh = SimpleNamespace(mesh_shape=self)

    def size(self, axis):
        return self.n

    def _keep(self, op, x, make):
        key = (op, tuple(x.shape), x.dtype)
        if key not in self.kept:
            self.sent.append(x.clone())
            self.kept[key] = make(x)
        return self.kept[key]

    def all_gather(self, x, axis, dim):
        import torch
        return self._keep("all_gather", x, lambda t: torch.cat([t] * self.n))

    def all_to_all(self, x, axis):
        return self._keep("all_to_all", x, lambda t: t.clone())

    def all_gather_async(self, x, axis, dim):
        out = self.all_gather(x, axis, dim)
        return SimpleNamespace(wait=lambda: out)

    def all_to_all_async(self, x, axis):
        out = self.all_to_all(x, axis)
        return SimpleNamespace(wait=lambda: out)


def int8_local_passes(gen, cases):
    """The callers' local passes on either side of the wire, as the train
    step runs them (``core/grad_compress._quantize`` / ``_dequantize`` /
    ``_accumulate``, each one launch), timed as the kernel cases are,
    beside the kernel alone at the same layout (``cases``: "kernel/case"
    -> its record): qwZ's issue (quantize the shard) and arrival
    (dequantize the gathered blocks into the shard's dtype), qgZ's issue
    (quantize the stage-1 gradient in n chunks) and arrival (fold the n
    sources into the gradient's chunk and dtype), the int8 TP
    all-reduce's issue and final dequantize, at qwen2.5-3b's MLP leaf,
    tp_train's activation and seamless-m4t-medium's attention and MLP
    shards; and the int8 TP all-reduce whole (``_int8_allreduce`` over a
    ``Loopback`` wire: quantize, the requantizing fold, dequantize)
    beside its three kernels' cases. Each pass's result equals its
    kernels' run on their own (``torch.equal``; for the all-reduce the
    three kernels chained over a wire of copies, as ``Loopback``'s).
    Each pass is drawn as many times as ``rotations`` asks for its
    kernels' bytes, and the timings take the draws in turn."""
    import torch
    from repro_torch.core.act_compress import _int8_allreduce
    from repro_torch.core.grad_compress import (_accumulate, _dequantize,
                                                _quantize)
    from repro_torch.kernels import ops

    def bf16(*shape):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * 0.02).bfloat16()

    def wire(*lead):
        return (torch.randint(-127, 128, lead + (256,), generator=gen,
                              device="cuda", dtype=torch.int8),
                torch.rand(lead + (1,), generator=gen, device="cuda") * 1e-3)
    q8, dq, acc = (QUANT_NAMES[k] + "/" for k in (
        "quantize", "dequantize", "dequant_accumulate"))
    bf = torch.bfloat16
    w_elems = 2048 * 11008 // 4
    t_total = TRAIN_BATCH // 4 * TRAIN_SEQ * 2048
    t_nb = t_total // 256
    # name -> (its kernels' cases, a draw: () -> (the pass, its kernels))
    passes = {}
    for tag, elems in (("mlp", w_elems), ("seamless_attn", 1024 * 1024 // 4),
                       ("seamless_mlp", 1024 * 4096 // 4)):
        nb = -(-elems // 256)

        def qwz_issue(e=elems):
            w = bf16(e)
            return (lambda: _quantize(w), lambda: ops.int8_quantize_blocks(w))

        def qwz_arrival(e=elems, nb=nb):
            q, s = wire(2 * nb)
            return (lambda: _dequantize(q, s, 2, e, bf),
                    lambda: ops.int8_dequantize_blocks(
                        q, s, n_chunks=2, chunk_elems=e, out_dtype=bf))

        def qgz_issue(e=elems):
            g = bf16(2 * e)
            return (lambda: _quantize(g, 2),
                    lambda: ops.int8_quantize_blocks(g, n_chunks=2))

        def qgz_arrival(e=elems, nb=nb):
            q, s = wire(2, nb)
            return (lambda: _accumulate(q, s, e, bf),
                    lambda: ops.int8_dequant_accumulate(
                        q, s, chunk_elems=e, out_dtype=bf))
        passes.update({
            f"qwz_issue_{tag}": ([q8 + f"{tag}_shard_bf16"], qwz_issue),
            f"qwz_arrival_{tag}": ([dq + f"{tag}_stage1_bf16"], qwz_arrival),
            f"qgz_issue_{tag}": ([q8 + f"{tag}_stage1_grad_bf16"], qgz_issue),
            f"qgz_arrival_{tag}": ([acc + f"{tag}_stage1_grad_bf16"],
                                   qgz_arrival)})

    def act_issue():
        x = bf16(TRAIN_BATCH // 4, TRAIN_SEQ, 2048)
        return (lambda: _quantize(x, blocks_per_chunk=t_nb),
                lambda: ops.int8_quantize_blocks(x.reshape(-1),
                                                 blocks_per_chunk=t_nb))

    def act_arrival():
        q, s = wire(t_nb)
        return (lambda: _dequantize(q, s, 1, t_total, bf),
                lambda: ops.int8_dequantize_blocks(q, s, chunk_elems=t_total,
                                                   out_dtype=bf))

    def act_allreduce():
        x, lo = bf16(TRAIN_BATCH // 4, TRAIN_SEQ, 2048), Loopback(2)

        def kernels():
            q, s = ops.int8_quantize_blocks(x.reshape(-1),
                                            blocks_per_chunk=t_nb)
            q2, s2 = ops.int8_dequant_requantize(q.reshape(2, -1, 256),
                                                 s.reshape(2, -1, 1))
            return ops.int8_dequantize_blocks(
                torch.cat([q2] * 2), torch.cat([s2] * 2),
                chunk_elems=t_total, out_dtype=bf)
        return lambda: _int8_allreduce(x, lo, "model").reshape(-1), kernels
    passes.update({
        "act_issue_tp": ([q8 + "tp_act_bf16"], act_issue),
        "act_arrival_tp": ([dq + "tp_act_gather_bf16"], act_arrival),
        "act_allreduce_tp": ([acc + "tp_act_reduce_requant",
                              q8 + "tp_act_bf16", dq + "tp_act_gather_bf16"],
                             act_allreduce)})
    out = []
    for name, (kcases, draw) in passes.items():
        ks = [cases[k] for k in kcases]
        bound_ms = sum(k["bound_ms"] for k in ks)
        runs = [draw() for _ in range(
            rotations(bound_ms * PEAK_HBM_BYTES / 1e3))]
        local, kernel = runs[0]
        a, b = local(), kernel()              # a tensor, or (q, s)
        a, b = ((a,), (b,)) if isinstance(a, torch.Tensor) else (a, b)
        check(all(torch.equal(u, v) for u, v in zip(a, b)),
              f"int8 local pass {name} differs from its kernel")
        timed = [r[0] for r in runs]
        rec = {"pass": name, "kernel": ks[0]["kernel"],
               "kernel_case": kcases[0] if len(ks) == 1 else kcases,
               "ms": cuda_ms(timed, 50), "device_ms": graph_ms(timed),
               "host_us": host_us(local), "copies": len(runs),
               "kernel_device_ms": sum(k["device_ms"] for k in ks),
               "kernel_host_us": sum(k["host_us"] for k in ks),
               "bound_ms": bound_ms}
        emit("int8_local_pass", **rec)
        out.append(rec)
    return out


def phase_int8_kernels():
    """The int8 kernels at the train phase's shapes (qwen2.5-3b, mesh
    pod 2 x data 2): one rank's shard of an MLP weight (2048 x 11008 / 4
    = 22,016 blocks; bf16, as qwZ quantizes it), its pod-gathered
    stage-1 view (2 x 22,016 blocks: qwZ's dequantize on arrival, into
    bf16 as the train step runs it and into fp32; qgZ's quantize of the
    bf16 gradient in 2 chunks, and of its fp32 widening; the n = 2
    dequant-accumulate), the embedding shard (151,936 x 2048 / 4 =
    303,872 blocks), the PEFT phase's LoRA adapter (one rank's shard of
    a rank-8 ``wq_lora_a``: 2048 x 8 / 4 = 16 blocks, and its stage-1
    view of 32), the int8 TP activation all-reduce of phase tp_train
    (one rank's [2, 512, 2048] activation: quantize 8,192 bf16 blocks,
    dequant-accumulate n = 2 sources of 4,096 into fp32 and requantizing
    them in the same kernel as the all-reduce runs it, quantize the
    4,096 fp32 ones alone, dequantize the gathered 8,192
    into bf16 and fp32), the whole
    stacked MLP leaf that stream_train's async reduce quantizes at once
    (2 layers: the bf16 storage shard of 44,032 blocks, its stage-1 view
    of 88,064, qgZ's quantize of the view's gradient and the n = 2
    dequant-accumulate of 44,032), seamless-m4t-medium's shards at (2,
    2, 1) (encdec_train: attention 262,144 elements = 1,024 blocks, MLP
    4,096 blocks, a norm 1 block, the embedding 256,206 blocks; each
    shard's quantize, the stage-1 arrival of 2 chunks into bf16, the
    stage-1 gradient's quantize in 2 chunks and its fold of 2 sources
    into bf16), ragged chunks whose starts are not 16-byte aligned (2 x
    2,100 bf16, 4 x 4,099, a buffer offset), a ragged block count and
    the fold at n = 1-5 into ragged chunks and requantizing; qgZ's fold
    is written into the gradient's bf16 chunk at every train shape (the
    main case: the MLP's 2 x 22,016 blocks) and into fp32 whole blocks,
    the TPU kernel's own output; then nvcc's report (0 spill bytes in every
    quant kernel) and the callers' local passes (``int8_local_passes``).
    Returns ({kind: timed main-shape case}, {kernel/case: every other
    timed case}, [local passes])."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    w_nb, e_nb = 2048 * 11008 // 4 // 256, 151936 * 2048 // 4 // 256
    a_nb = 2048 * PEFT_RANK // 4 // 256
    t_nb = TRAIN_BATCH // 4 * TRAIN_SEQ * 2048 // 256
    w_el = w_nb * 256
    main = {
        "quantize": int8_case("quantize", "mlp_shard_bf16", w_nb, gen,
                              dtype="bfloat16", timed=True),
        "dequantize": int8_case("dequantize", "mlp_stage1_bf16", 2 * w_nb,
                                gen, dtype="bfloat16", timed=True,
                                n_chunks=2, chunk_elems=w_el),
        # qgZ's arrival as the train step runs it: the fold of the 2
        # sources written into the bf16 gradient's chunk
        "dequant_accumulate": int8_case("dequant_accumulate",
                                        "mlp_stage1_grad_bf16", w_nb, gen,
                                        dtype="bfloat16", timed=True,
                                        chunk_elems=w_el)}
    extra = [
        int8_case("dequant_accumulate", "mlp_stage1_grad", w_nb, gen,
                  timed=True),
        int8_case("dequantize", "mlp_stage1", 2 * w_nb, gen, timed=True),
        int8_case("quantize", "mlp_stage1_grad_bf16", 2 * w_nb, gen,
                  dtype="bfloat16", timed=True, n_chunks=2, chunk_elems=w_el),
        int8_case("quantize", "mlp_stage1_grad_f32", 2 * w_nb, gen,
                  timed=True),
        int8_case("quantize", "embed_shard_bf16", e_nb, gen, dtype="bfloat16",
                  timed=True),
        int8_case("dequantize", "embed_stage1", 2 * e_nb, gen, timed=True),
        int8_case("dequantize", "embed_stage1_bf16", 2 * e_nb, gen,
                  dtype="bfloat16", timed=True, n_chunks=2,
                  chunk_elems=e_nb * 256),
        int8_case("dequant_accumulate", "embed_stage1_grad", e_nb, gen,
                  timed=True),
        int8_case("dequant_accumulate", "embed_stage1_grad_bf16", e_nb, gen,
                  dtype="bfloat16", timed=True, chunk_elems=e_nb * 256),
        int8_case("quantize", "peft_adapter_shard_bf16", a_nb, gen,
                  dtype="bfloat16", timed=True),
        int8_case("quantize", "peft_adapter_stage1_grad_bf16", 2 * a_nb, gen,
                  dtype="bfloat16", n_chunks=2),
        int8_case("dequantize", "peft_adapter_stage1", 2 * a_nb, gen,
                  timed=True),
        int8_case("dequantize", "peft_adapter_stage1_bf16", 2 * a_nb, gen,
                  dtype="bfloat16", n_chunks=2, chunk_elems=a_nb * 256),
        int8_case("dequant_accumulate", "peft_adapter_stage1_grad", a_nb,
                  gen, timed=True),
        int8_case("dequant_accumulate", "peft_adapter_stage1_grad_bf16",
                  a_nb, gen, dtype="bfloat16", chunk_elems=a_nb * 256),
        # the int8 TP activation all-reduce at tp_train's activation:
        # one rank's [2, 512, 2048] bf16 = 8,192 blocks in 2 chunks
        int8_case("quantize", "tp_act_bf16", t_nb, gen, dtype="bfloat16",
                  timed=True),
        int8_case("dequant_accumulate", "tp_act_reduce", t_nb // 2, gen,
                  timed=True),
        # the fold requantized in the same kernel, as the all-reduce runs
        int8_case("dequant_accumulate", "tp_act_reduce_requant", t_nb // 2,
                  gen, timed=True, requantize=True),
        int8_case("quantize", "tp_act_requant_f32", t_nb // 2, gen,
                  timed=True),
        int8_case("dequantize", "tp_act_gather", t_nb, gen, timed=True),
        int8_case("dequantize", "tp_act_gather_bf16", t_nb, gen,
                  dtype="bfloat16", timed=True, chunk_elems=t_nb * 256),
        # stream_train's leaf-level trio: the stacked [2, 2048, 11008] leaf
        int8_case("quantize", "mlp_leaf_shard_bf16", TRAIN_DEPTH * w_nb, gen,
                  dtype="bfloat16", timed=True),
        int8_case("dequantize", "mlp_leaf_stage1", 2 * TRAIN_DEPTH * w_nb,
                  gen, timed=True),
        int8_case("dequantize", "mlp_leaf_stage1_bf16",
                  2 * TRAIN_DEPTH * w_nb, gen, dtype="bfloat16", timed=True,
                  n_chunks=2, chunk_elems=TRAIN_DEPTH * w_el),
        int8_case("quantize", "mlp_leaf_stage1_grad_f32",
                  2 * TRAIN_DEPTH * w_nb, gen, timed=True),
        int8_case("quantize", "mlp_leaf_stage1_grad_bf16",
                  2 * TRAIN_DEPTH * w_nb, gen, dtype="bfloat16", timed=True,
                  n_chunks=2, chunk_elems=TRAIN_DEPTH * w_el),
        int8_case("dequant_accumulate", "mlp_leaf_stage1_grad",
                  TRAIN_DEPTH * w_nb, gen, timed=True),
        int8_case("dequant_accumulate", "mlp_leaf_stage1_grad_bf16",
                  TRAIN_DEPTH * w_nb, gen, dtype="bfloat16", timed=True,
                  chunk_elems=TRAIN_DEPTH * w_el)]
    # seamless-m4t-medium's shards at (2, 2, 1): qwZ's quantize of the
    # shard, its arrival of 2 chunks into bf16, qgZ's quantize of the
    # stage-1 gradient in 2 chunks and its arrival (the fold of the 2
    # sources into the bf16 chunk)
    for tag, elems, timed in (("seamless_attn", 1024 * 1024 // 4, True),
                              ("seamless_mlp", 1024 * 4096 // 4, True),
                              ("seamless_norm", 1024 // 4, False),
                              ("seamless_embed", 256206 * 1024 // 4, True)):
        nb = -(-elems // 256)
        extra += [
            int8_case("quantize", f"{tag}_shard_bf16", nb, gen,
                      dtype="bfloat16", timed=timed, chunk_elems=elems),
            int8_case("dequantize", f"{tag}_stage1_bf16", 2 * nb, gen,
                      dtype="bfloat16", timed=timed, n_chunks=2,
                      chunk_elems=elems),
            int8_case("quantize", f"{tag}_stage1_grad_bf16", 2 * nb, gen,
                      dtype="bfloat16", timed=timed, n_chunks=2,
                      chunk_elems=elems),
            int8_case("dequant_accumulate", f"{tag}_stage1_grad_bf16", nb,
                      gen, dtype="bfloat16", timed=True, chunk_elems=elems)]
    # ragged chunks: starts that are not 16-byte aligned (2,100 bf16
    # elements are 4,200 bytes; 4,099 of either dtype), lanes straddling
    # a chunk's end, a buffer offset, all-zero tail blocks (the TP
    # all-reduce's n * nb blocks of a ragged activation)
    for dtype in ("bfloat16", "float32"):
        extra += [
            int8_case("quantize", f"ragged_2x2100_{dtype}", 0, gen,
                      dtype=dtype, n_chunks=2, chunk_elems=2100),
            int8_case("quantize", f"ragged_4x4099_{dtype}", 0, gen,
                      dtype=dtype, n_chunks=4, chunk_elems=4099),
            int8_case("quantize", f"ragged_offset3_{dtype}", 0, gen,
                      dtype=dtype, n_chunks=2, chunk_elems=2048, offset=3),
            int8_case("quantize", f"ragged_tail_blocks_{dtype}", 0, gen,
                      dtype=dtype, chunk_elems=1_000_003,
                      blocks_per_chunk=2 * 1954),
            int8_case("dequantize", f"ragged_2x2100_{dtype}", 18, gen,
                      dtype=dtype, n_chunks=2, chunk_elems=2100),
            int8_case("dequantize", f"ragged_4x4099_{dtype}", 68, gen,
                      dtype=dtype, n_chunks=4, chunk_elems=4099),
            int8_case("dequantize", f"ragged_tail_blocks_{dtype}", 2 * 1954,
                      gen, dtype=dtype, chunk_elems=1_000_003)]
    # the fold at both n instances (2 unrolled; 1, 3, 4 and 5 the loop),
    # ragged chunks (the last block partly written, a chunk of 1) and
    # the requantize at a ragged block count
    extra += [
        int8_case("quantize", "ragged_f32", 4099, gen),
        int8_case("dequantize", "ragged", 4099, gen),
        int8_case("dequant_accumulate", "ragged_n3", 4099, gen, n=3),
        int8_case("dequant_accumulate", "ragged_n3_requant", 4099, gen, n=3,
                  requantize=True),
        int8_case("dequant_accumulate", "ragged_n4_2100_bf16", 9, gen, n=4,
                  dtype="bfloat16", chunk_elems=2100),
        int8_case("dequant_accumulate", "ragged_n2_1050_f32", 5, gen,
                  chunk_elems=1050),
        int8_case("dequant_accumulate", "ragged_n5_bf16", 4099, gen, n=5,
                  dtype="bfloat16", chunk_elems=4099 * 256 - 77),
        int8_case("dequant_accumulate", "ragged_n1_1_bf16", 1, gen, n=1,
                  dtype="bfloat16", chunk_elems=1),
        int8_case("dequant_accumulate", "ragged_n5_requant", 37, gen, n=5,
                  requantize=True)]
    for c in list(main.values()) + extra:
        emit("kernels", **c)
    # every quant kernel instance compiled without a spill
    from repro_torch.kernels import _build
    quant_ptxas = ptxas_summary(_build.library_path("quant")
                                .with_suffix(".log"))
    spills = {k: v.get("spill_bytes") for k, v in quant_ptxas.items()
              if k != "warnings"}
    emit("int8_ptxas", kernels=quant_ptxas)
    check(spills and all(v == 0 for v in spills.values()),
          f"a quant kernel spills: {spills}")
    timed = {c["kernel"] + "/" + c["case"]: c for c in extra if "ms" in c}
    by_case = {c["kernel"] + "/" + c["case"]: c
               for c in list(main.values()) + extra if "ms" in c}
    return main, timed, int8_local_passes(gen, by_case)


def mm_bound(m, k, n, elt):
    """Least time of [m, k] @ [k, n]: 2mkn flops at the dtype's peak
    rate, or the bytes of x, w and the output once each over the HBM
    rate, whichever is larger. Returns (ms, bound_by)."""
    peak = PEAK_BF16_FLOPS if elt == 2 else PEAK_F32_FLOPS
    t_ops = 2.0 * m * k * n / peak
    t_bytes = (m * k + k * n + m * n) * elt / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def mma_variant(x, w):
    """x @ w through the mma.sync variant on row-major copies, launched
    directly (no count): what the wgmma variant is held to bit for bit."""
    import torch
    from repro_torch.kernels import _build, collective_matmul as cm
    xc, wc = x.contiguous(), w.contiguous()
    (m, k), n = xc.shape, wc.shape[1]
    out = torch.empty((m, n), dtype=xc.dtype, device=xc.device)
    err = _build.launch(xc.device, cm._lib().matmul_chunk_bf16, xc.data_ptr(),
                     wc.data_ptr(), out.data_ptr(), m, n, k, k, n, n,
                     int(k % 8 == 0 and n % 8 == 0))
    check(err == 0, f"matmul_chunk_bf16 launch failed: CUDA error {err}")
    return out


def mm_case(name, m, k, n, gen, dtype="bfloat16", timed=False, x=None,
            w=None):
    """The chunk-matmul kernel against its plain version (x @ w) on the
    card, within the tolerance stated at MM_MEAN_REL_TOL; a bf16 product
    of the wgmma variant also equal to the mma.sync variant's bit for
    bit."""
    import torch
    from repro_torch.kernels import collective_matmul as cm, ops, ref

    dt = getattr(torch, dtype)
    if x is None:
        x = torch.randn(m, k, generator=gen, device="cuda").to(dt)
    if w is None:
        w = torch.randn(k, n, generator=gen, device="cuda").to(dt)
    got = ops.matmul_chunk(x, w)
    torch.cuda.synchronize()
    want = ref.matmul_chunk_plain(x, w)
    d = (got.float() - want.float()).abs()
    mag = x.float().abs() @ w.float().abs()
    bound = 2 * k * 2.0 ** -24 * mag
    if dt == torch.bfloat16:
        expo = torch.floor(torch.log2(want.float().abs().clamp_min(2.0 ** -126)))
        bound = bound + torch.exp2(expo - 7)
    plan = cm.launch_plan(x, w)
    out = {"kernel": "matmul_chunk", "case": name, "M": m, "K": k, "N": n,
           "dtype": dtype, "variant": plan.variant,
           "layout": {"x_col_major": plan.x_mn, "w_row_major": plan.w_mn,
                      "lda": plan.lda, "ldb": plan.ldb},
           "max_abs_err": d.max().item(),
           "mean_abs_err": d.mean().item(),
           "mean_abs_plain": want.float().abs().mean().item(),
           "elements_equal_share": (d == 0).float().mean().item(),
           "worst_err_over_bound": (d / bound).max().item()}
    check(bool(torch.isfinite(got).all().item()),
          f"matmul_chunk {name}: output not finite")
    check(out["worst_err_over_bound"] <= 1.0,
          f"matmul_chunk {name}: |diff| exceeds its bound by "
          f"{out['worst_err_over_bound']}x (max |diff| {out['max_abs_err']})")
    if dt == torch.bfloat16:
        check(out["mean_abs_err"] <= MM_MEAN_REL_TOL * out["mean_abs_plain"],
              f"matmul_chunk {name}: mean |diff| {out['mean_abs_err']} > "
              f"{MM_MEAN_REL_TOL} x mean |plain| {out['mean_abs_plain']}")
    if plan.variant == "tma":
        out["equal_mma_variant"] = bool(torch.equal(got, mma_variant(x, w)))
        check(out["equal_mma_variant"], f"matmul_chunk {name}: the wgmma "
              "and mma.sync variants give different bits")
    if timed:
        def call():
            return ops.matmul_chunk(x, w)
        out["ms"] = cuda_ms(call, 50)
        out["device_ms"] = graph_ms(call)
        out["host_us"] = host_us(call)
        out["plain_ms"] = cuda_ms(lambda: ref.matmul_chunk_plain(x, w), 50)
        # the library call is the same torch.matmul as the plain version
        out["library_ms"] = cuda_ms(lambda: torch.matmul(x, w), 50)
        out["bound_ms"], out["bound_by"] = mm_bound(
            m, k, n, torch.finfo(dt).bits // 8)
    return out


def column_identity(name, x, w_full, n_ranks):
    """The ring's contract on the card: kernel(x, w_full)'s column block
    j equals kernel(x, w_chunk_j) bit for bit, for the chunk read in
    place (a row-strided slice) and copied out; records the variant each
    took (a copied chunk whose width is not a multiple of 8 takes the
    mma.sync variant where the full matrix takes the wgmma one)."""
    import torch
    from repro_torch.kernels import collective_matmul as cm

    full = cm.matmul_chunk(x, w_full)
    nc = w_full.shape[1] // n_ranks
    ok, variants = True, set()
    for j in range(n_ranks):
        sl = w_full[:, j * nc:(j + 1) * nc]
        blk = full[:, j * nc:(j + 1) * nc]
        for chunk in (sl, sl.contiguous()):
            ok &= torch.equal(cm.matmul_chunk(x, chunk), blk)
            variants.add(cm.launch_plan(x, chunk).variant)
    torch.cuda.synchronize()
    check(ok, f"matmul_chunk {name}: a column block differs from the "
          "chunk's own product")
    return {"case": name, "column_identity_bit_exact": ok,
            "variants": {"full": cm.launch_plan(x, w_full).variant,
                         "chunks": sorted(variants)}}


def phase_mm_kernels():
    """The chunk-matmul kernel at the train phase's shapes (qwen2.5-3b,
    mesh pod 2 x data 2: a rank holds 2 sequences x 512 = 1,024 tokens;
    the ring over data has n = 2 chunks of half of d_model's 2,048
    columns): wo's chunk, w_out's chunk, both at phase tp_train's
    (2, 2, 2) too (their input dims halved), mode 'both''s dx and dw chunks
    of w_out with ``chunk.T`` and ``x2.T`` read in place (as the ring
    hands them over), and test_fused_matmul.py's ragged shapes in bf16
    and f32. Also the transposes the parent copied to contiguous, timed
    as a record of what is gone. Returns (main case, {case: timed
    case})."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    tok, d, f = 1024, 2048, 11008
    x2 = torch.randn(tok, f, generator=gen, device="cuda").bfloat16()
    chunk = torch.randn(f, d // 2, generator=gen, device="cuda").bfloat16()
    g2 = torch.randn(tok, d, generator=gen, device="cuda").bfloat16()
    main = mm_case("w_out_chunk", tok, f, d // 2, gen, timed=True, x=x2)
    timed = [mm_case("wo_chunk", tok, d, d // 2, gen, timed=True),
             # tp_train's ring chunks at (2, 2, 2): wo's and w_out's
             # input dims halved over 'model'
             mm_case("tp2_wo_chunk", tok, d // 2, d // 2, gen, timed=True),
             mm_case("tp2_w_out_chunk", tok, f // 2, d // 2, gen,
                     timed=True),
             mm_case("both_dx_w_out", tok, d // 2, f, gen, timed=True,
                     x=g2[:, :d // 2], w=chunk.t()),
             mm_case("both_dw_w_out", f, tok, d // 2, gen, timed=True,
                     x=x2.t(), w=g2[:, d // 2:])]
    extra = [mm_case(f"ragged_{m}x{k}x{n}", m, k, n, gen, dtype=dt)
             for m, k, n in ((7, 96, 100), (130, 32, 257), (1, 16, 1))
             for dt in ("bfloat16", "float32")]
    extra.append(mm_case("f32_train_parity_w_out", 128, 256, 32, gen,
                         dtype="float32"))
    x = torch.randn(tok, d, generator=gen, device="cuda").bfloat16()
    xf = torch.randn(tok, f, generator=gen, device="cuda").bfloat16()
    ids = [column_identity("wo", x, torch.randn(
               d, d, generator=gen, device="cuda").bfloat16(), 2),
           column_identity("w_out", xf, torch.randn(
               f, d, generator=gen, device="cuda").bfloat16(), 2),
           column_identity("f32_ragged", torch.randn(
               130, 96, generator=gen, device="cuda"), torch.randn(
               96, 2 * 129, generator=gen, device="cuda"), 2),
           # 512 tiles (two a CTA) whole, 128 (one a CTA) a chunk
           column_identity("wide", x[:, :d // 2], torch.randn(
               d // 2, 4 * d // 2, generator=gen, device="cuda").bfloat16(),
               4),
           # chunks of 100 columns: in place the wgmma variant (its map
           # starts at the base rounded down), copied the mma.sync one
           column_identity("bf16_chunk_100", torch.randn(
               70, 96, generator=gen, device="cuda").bfloat16(), torch.randn(
               96, 2 * 100, generator=gen, device="cuda").bfloat16(), 2)]
    copies = {"chunk_T_ms": cuda_ms(lambda: chunk.t().contiguous(), 50),
              "x2_T_ms": cuda_ms(lambda: x2.t().contiguous(), 50)}
    for c in [main] + timed + extra + ids:
        emit("kernels", **c)
    emit("kernels", kernel="matmul_chunk", case="both_transpose_copies",
         shape=[f, d // 2], **copies)
    return main, {c["case"]: c for c in timed}


def wkv_bound(B, S, H, hd, elt, with_s0):
    """Least time of the WKV over these inputs: the bytes of r, k, v (elt
    bytes each), logw and u (fp32), the output (elt), the final state
    and s0 (fp32) once each over the HBM rate, or WKV_FLOPS_PER_ELEMENT
    fp32 operations per state element and step over the CUDA cores'
    rate, whichever is larger. Returns (ms, bound_by)."""
    n = B * S * H * hd
    state = B * H * hd * hd * 4
    nbytes = 4 * n * elt + 4 * n + 4 * H * hd + state * (2 if with_s0
                                                          else 1)
    t_bytes = nbytes / PEAK_HBM_BYTES
    t_ops = WKV_FLOPS_PER_ELEMENT * B * S * H * hd * hd / PEAK_F32_FLOPS
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def wkv_case(name, shape, gen, dtype="float32", chunk=64, decay="drawn",
             with_s0=False, timed=False):
    """The WKV kernel against its plain version (``ref.wkv6_plain`` at
    ``chunk``) on the card, within the tolerances stated at WKV_TOL."""
    import torch
    from repro_torch.kernels import ops, ref

    B, S, H, hd = shape
    dt = getattr(torch, dtype)
    dev = "cuda"
    r, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
               for _ in range(3))
    if decay == "strong":
        logw = torch.full(shape, -20.0, device=dev)
    else:
        logw = -torch.exp(torch.randn(shape, generator=gen, device=dev)
                          - 0.5)
    u = torch.randn(H, hd, generator=gen, device=dev)
    s0 = (torch.randn(B, H, hd, hd, generator=gen, device=dev)
          if with_s0 else None)
    got_o, got_s = ops.wkv6(r, k, v, logw, u, s0, chunk)
    torch.cuda.synchronize()
    want_o, want_s = ref.wkv6_plain(r, k, v, logw, u, s0, chunk)
    d_o = (got_o.float() - want_o.float()).abs()
    d_s = (got_s - want_s).abs()
    mag_o = want_o.float().abs()
    if dt == torch.bfloat16:
        expo = torch.floor(torch.log2(mag_o.clamp_min(2.0 ** -126)))
        bound_o = torch.exp2(expo - 7) + WKV_TOL
    else:
        bound_o = WKV_TOL + WKV_TOL * mag_o
    bound_s = WKV_TOL + WKV_TOL * want_s.abs()
    out = {"kernel": "wkv6", "case": name, "shape": list(shape),
           "dtype": dtype, "chunk": chunk, "decay": decay,
           "s0": with_s0, "max_abs_err": max(d_o.max().item(),
                                             d_s.max().item()),
           "out_max_abs_err": d_o.max().item(),
           "state_max_abs_err": d_s.max().item(),
           "out_mean_abs_plain": mag_o.mean().item(),
           "worst_err_over_bound": max((d_o / bound_o).max().item(),
                                       (d_s / bound_s).max().item()),
           "state_err_over_bound": (d_s / bound_s).max().item(),
           # S 1 runs the step kernel, longer S the staged one
           "ptxas": case_ptxas("wkv6", f"{WKV_KERNELS[S == 1]}<"
                               f"{'bf16' if dt == torch.bfloat16 else 'f32'},"
                               f"{hd}>")}
    check(bool(torch.isfinite(got_o).all().item())
          and bool(torch.isfinite(got_s).all().item()),
          f"wkv6 {name}: output or state not finite")
    check(out["worst_err_over_bound"] <= 1.0,
          f"wkv6 {name}: |diff| exceeds its tolerance by "
          f"{out['worst_err_over_bound']}x (out {out['out_max_abs_err']}, "
          f"state {out['state_max_abs_err']})")
    if timed:
        def call():
            return ops.wkv6(r, k, v, logw, u, s0, chunk)
        out["ms"] = cuda_ms(call, 50)
        out["device_ms"] = graph_ms(call)
        out["host_us"] = host_us(call)
        out["plain_ms"] = cuda_ms(
            lambda: ref.wkv6_plain(r, k, v, logw, u, s0, chunk), 5)
        # no single PyTorch call computes the WKV recurrence
        out["library_ms"] = None
        out["bound_ms"], out["bound_by"] = wkv_bound(
            B, S, H, hd, torch.finfo(dt).bits // 8, with_s0)
    return out


def phase_wkv_kernels():
    """The WKV kernel at the rwkv serve phase's shapes (rwkv6-3b: 40
    heads of 64, batch 8): the prefill over a 512-token prompt (bf16 r,
    k, v, from zero state) and a decode step (S 1, from a random
    state); tests/test_kernels.py's sweep shapes in fp32 at chunks 16
    and 32, and its strong-decay case (logw = -20). Returns (prefill,
    decode) cases."""
    import torch
    from repro_torch.kernels import _build

    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (RWKV_BATCH, RWKV_PROMPT, 40, 64)
    prefill = wkv_case("prefill", shape, gen, dtype="bfloat16", timed=True)
    decode = wkv_case("decode", (RWKV_BATCH, 1) + shape[2:], gen,
                      dtype="bfloat16", with_s0=True, timed=True)
    extra = [wkv_case(f"sweep_{'x'.join(map(str, sh))}_c{c}", sh, gen,
                      chunk=c)
             for sh in ((1, 64, 1, 16), (2, 128, 2, 32), (1, 128, 4, 64))
             for c in (16, 32)]
    extra += [wkv_case("strong_decay", (1, 64, 1, 16), gen, chunk=32,
                       decay="strong"),
              wkv_case("decode_f32_hd16", (3, 1, 4, 16), gen,
                       with_s0=True)]
    # the staged chunk (16 steps) against S: a last chunk of 4 (S 100) or
    # 5 (S 37) steps, one step; every hd in both dtypes, with and without
    # s0; the strong decay in bf16 from a carried state
    extra += [wkv_case(f"S{S}_hd{hd}_{dt}{'_s0' if s0 else ''}",
                       (2, S, 3, hd), gen, dtype=dt, chunk=c, with_s0=s0)
              for S, c in ((100, 20), (37, 37), (1, 64))
              for hd in (16, 32, 64) for dt in ("float32", "bfloat16")
              for s0 in ((False, True) if S == 100 else (S == 1,))]
    extra.append(wkv_case("strong_decay_bf16_s0", (2, 100, 3, 64), gen,
                          dtype="bfloat16", chunk=20, decay="strong",
                          with_s0=True))
    ptxas = ptxas_summary(_build.library_path("wkv6").with_suffix(".log"))
    for c in [prefill, decode] + extra:
        emit("kernels", **c)
    emit("kernels", kernel="wkv6", case="ptxas", ptxas=ptxas)
    return prefill, decode


def draw_rwkv_leaves(params, gen) -> None:
    """Overwrite the rwkv stack's zero-initialised leaves in place with
    draws from ``gen`` (on the leaves' device): decay_base ~ N(-0.5, 1),
    the others ~ 0.1 N(0, 1). At their default init the ddlerp deltas
    vanish, every log decay is -1 and the u-bonus is 0, so neither the
    kernel nor a parity check would see a data-dependent decay."""
    import torch
    for kind, names in (("rwkv_tm", ("maa_base", "maa_w1", "decay_base",
                                     "decay_w1", "u")),
                        ("rwkv_cm", ("mu_k", "mu_r"))):
        for n in names:
            t = params["blocks"]["pos0"][kind][n]
            x = torch.randn(t.shape, generator=gen, device=t.device)
            t.copy_(x - 0.5 if n == "decay_base" else 0.1 * x)


def phase_rwkv_serve():
    """The ssm serve path at full width and depth: prefill, then greedy
    decode over the recurrent state. Returns the WKV kernel's launches."""
    import numpy as np
    import torch
    from repro_torch.configs.base import RunConfig, ShapeCell
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import StepBundle
    from repro_torch.core.partition import tree_items
    from repro_torch.kernels import ops

    cfg = get_config("rwkv6-3b")
    cell = ShapeCell("rwkv_serve", "decode", RWKV_PROMPT + RWKV_DECODE,
                     RWKV_BATCH)
    bundle = StepBundle(RunConfig(model=cfg, shape=cell))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bundle.init_all_params(seed=0)
    draw_rwkv_leaves(params, torch.Generator(device="cuda").manual_seed(1))
    ids = torch.randint(1, cfg.vocab_size, (RWKV_BATCH, RWKV_PROMPT),
                        generator=torch.Generator(device="cuda")
                        .manual_seed(2), device="cuda")
    prefill, decode = bundle.make_prefill_step(), bundle.make_decode_step()
    pick = bundle.make_greedy_pick()
    state = bundle.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    ops.wkv6.launches = 0
    t0 = time.perf_counter()
    logits, state = prefill(params, ids, state)
    tok = pick(logits)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    finite, tokens, tpot = [torch.isfinite(logits).all()], [tok], []
    for _ in range(RWKV_DECODE):
        t1 = time.perf_counter()
        logits, state = decode(params, tok[:, None], state)
        tok = pick(logits)
        torch.cuda.synchronize()
        tpot.append(time.perf_counter() - t1)
        finite.append(torch.isfinite(logits).all())
        tokens.append(tok)
    wall = time.perf_counter() - t0
    launches = ops.wkv6.launches

    expected = cfg.num_layers * (1 + RWKV_DECODE)
    check(launches == expected, f"wkv6 launched {launches} times, expected "
          f"{cfg.num_layers} x {1 + RWKV_DECODE}")
    check(all(bool(f.item()) for f in finite), "a logit is not finite")
    toks = torch.stack(tokens, dim=1).cpu()
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all().item()),
          "a token id lies outside the vocabulary")
    L, D, hd = cfg.num_layers, cfg.d_model, cfg.rwkv.head_dim
    H = D // hd
    want = {"pos0.rwkv_cm.xprev": ((L, RWKV_BATCH, D), torch.bfloat16),
            "pos0.rwkv_tm.s": ((L, RWKV_BATCH, H, hd, hd), torch.float32),
            "pos0.rwkv_tm.xprev": ((L, RWKV_BATCH, D), torch.bfloat16)}
    got = {p: (tuple(t.shape), t.dtype) for p, t in tree_items(state)}
    check(got == want, f"decode state {got} != {want}")
    tp = np.asarray(tpot)
    emit("rwkv_serve", model=cfg.name, layers=cfg.num_layers,
         batch=RWKV_BATCH, prompt=RWKV_PROMPT, decode_steps=RWKV_DECODE,
         init_s=init_s, prefill_s=prefill_s,
         tpot_p50_s=float(np.percentile(tp, 50)),
         tpot_p90_s=float(np.percentile(tp, 90)),
         decode_tok_s=RWKV_BATCH * RWKV_DECODE / float(tp.sum()),
         generated_tok_s=RWKV_BATCH * (1 + RWKV_DECODE) / wall, wall_s=wall,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
         launches=launches, expected_launches=expected,
         row0_tokens=toks[0].tolist())
    del params, state
    torch.cuda.empty_cache()
    return launches


def phase_rwkv_parity():
    """rwkv6-3b at full width and depth 2 in fp32 on the card (WKV
    kernel) and on the CPU (its plain version), from the same weights
    (drawn on the CPU): prefill and decode logits within the tolerance,
    greedy tokens equal."""
    import numpy as np
    import torch
    from repro_torch.configs.base import RunConfig, ShapeCell, SystemConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import StepBundle
    from repro_torch.core.partition import tree_map
    from repro_torch.kernels import ops

    cp = RWKV_PARITY
    cfg = dataclasses.replace(get_config("rwkv6-3b"), num_layers=cp["depth"])
    run = RunConfig(model=cfg, shape=ShapeCell(
        "rwkv_parity", "decode", cp["prompt"] + cp["decode"], cp["batch"]),
        system=SystemConfig(dtype="float32"))
    cpu, gpu = StepBundle(run, device="cpu"), StepBundle(run)
    p_cpu = cpu.init_all_params(seed=0)
    draw_rwkv_leaves(p_cpu, torch.Generator().manual_seed(1))
    p_gpu = tree_map(lambda t: t.to(gpu.device), p_cpu)
    ids = torch.randint(1, cfg.vocab_size, (cp["batch"], cp["prompt"]),
                        generator=torch.Generator().manual_seed(2))
    out = {}
    for name, b, p in (("cpu", cpu, p_cpu), ("gpu", gpu, p_gpu)):
        launches = ops.wkv6.launches
        t0 = time.perf_counter()
        logits, state = b.make_prefill_step()(p, ids.to(b.device),
                                              b.init_state())
        steps, toks = [logits.cpu().numpy()], []
        dec = b.make_decode_step()
        for _ in range(cp["decode"]):
            tok = torch.argmax(logits, dim=-1)
            toks.append(tok.cpu().tolist())
            logits, state = dec(p, tok[:, None], state)
            steps.append(logits.cpu().numpy())
        toks.append(torch.argmax(logits, dim=-1).cpu().tolist())
        out[name] = (steps, toks, ops.wkv6.launches - launches,
                     time.perf_counter() - t0)
    (lc, tc, nc, t_c), (lg, tg, ng, t_g) = out["cpu"], out["gpu"]
    diffs = [float(np.abs(a - b).max()) for a, b in zip(lg, lc)]
    check(max(diffs) <= cp["logit_tol"],
          f"card and CPU logits differ by {max(diffs)}")
    check(tc == tg, f"greedy tokens differ: CPU {tc}, card {tg}")
    check(ng == cfg.num_layers * (1 + cp["decode"]) and nc == 0,
          f"wkv6 launches: card {ng} (expected "
          f"{cfg.num_layers * (1 + cp['decode'])}), CPU {nc} (expected 0)")
    emit("rwkv_parity", layers=cfg.num_layers, dtype="float32",
         batch=cp["batch"], prompt=cp["prompt"], decode_steps=cp["decode"],
         logit_tol=cp["logit_tol"], logits_max_abs_diff=diffs,
         tokens=tg, wkv6_launches={"gpu": ng, "cpu": nc}, cpu_s=t_c,
         gpu_s=t_g)
    del p_gpu
    torch.cuda.empty_cache()


# -- the hybrid family (jamba) ---------------------------------------------------

def scan_bound(B, S, C, elt, with_h0):
    """Least time of the scan over these inputs: the bytes of a and b
    (elt bytes each), hs (fp32) and h0 (fp32) once each over the HBM
    rate, or one FMA (2 fp32 operations) per element and step over the
    CUDA cores' rate, whichever is larger. Returns (ms, bound_by)."""
    n = B * S * C
    nbytes = 2 * n * elt + 4 * n + (4 * B * C if with_h0 else 0)
    t_bytes = nbytes / PEAK_HBM_BYTES
    t_ops = 2 * n / PEAK_F32_FLOPS
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def scan_case(name, shape, gen, dtype="float32", with_h0=False,
              a_kind="uniform", timed=False):
    """The Mamba scan kernel against its plain version
    (``ref.mamba_scan_plain``) on the card, within SCAN_TOL x max(1, max
    |h|). a: "decay" draws the model's a = exp(dt A) (dt = softplus(N(-3,
    1)), A = -U(1, 16)), "uniform" U(0.2, 0.999) as tests/test_kernels.py
    draws it, or a constant; b ~ N(0, 1); h0 ~ N(0, 1)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    B, S, C = shape
    dev = "cuda"
    if a_kind == "decay":
        dt = F.softplus(torch.randn(shape, generator=gen, device=dev) - 3.0)
        a = torch.exp(-dt * (torch.rand(C, generator=gen, device=dev) * 15.0
                             + 1.0))
        del dt
    elif a_kind == "uniform":
        a = torch.rand(shape, generator=gen, device=dev) * 0.799 + 0.2
    else:
        a = torch.full(shape, float(a_kind), device=dev)
    b = torch.randn(shape, generator=gen, device=dev)
    dt_ = getattr(torch, dtype)
    a, b = a.to(dt_), b.to(dt_)
    h0 = (torch.randn(B, C, generator=gen, device=dev) if with_h0
          else None)
    got = ops.mamba_scan(a, b, h0)
    torch.cuda.synchronize()
    want = ref.mamba_scan_plain(a, b, h0)
    d = (got - want).abs()
    scale = max(1.0, want.abs().max().item())
    out = {"kernel": "mamba_scan", "case": name, "shape": list(shape),
           "dtype": dtype, "h0": with_h0, "a": a_kind,
           "max_abs_err": d.max().item(), "max_abs_plain": scale,
           "err_over_bound": d.max().item() / (SCAN_TOL * scale)}
    check(bool(torch.isfinite(got).all().item()),
          f"mamba_scan {name}: output not finite")
    check(out["err_over_bound"] <= 1.0,
          f"mamba_scan {name}: max |diff| {out['max_abs_err']} > "
          f"{SCAN_TOL} x max(1, max |h|) = {SCAN_TOL * scale}")
    runs = [(a, b, h0)]
    if timed:
        out["bound_ms"], out["bound_by"] = scan_bound(
            B, S, C, torch.finfo(dt_).bits // 8, with_h0)
        # a decode step's inputs fit the L2: copies taken in turn
        runs += [tuple(None if x is None else x.clone() for x in runs[0])
                 for _ in range(rotations(out["bound_ms"] * PEAK_HBM_BYTES
                                          / 1e3) - 1)]
        calls = [lambda r=r: ops.mamba_scan(*r) for r in runs]
        out["ms"] = cuda_ms(calls, 20)
        # a prefill output is 2 GiB: few calls in the graph
        out["device_ms"] = graph_ms(calls, 5 if S > 1 else 50)
        out["host_us"] = host_us(calls[0], 20 if S > 1 else 200)
        out["plain_ms"] = cuda_ms([lambda r=r: ref.mamba_scan_plain(*r)
                                   for r in runs], 3 if S > 1 else 50)
        # no single PyTorch call computes a linear recurrence
        out.update(library_ms=None, copies=len(runs))
        del calls
    del a, b, h0, got, want, d, runs
    torch.cuda.empty_cache()
    return out


def phase_mamba_kernels():
    """The Mamba scan kernel at the jamba serve phase's shapes (d_inner
    8,192 x d_state 16 = 131,072 channels, batch 8): the prefill over a
    512-token prompt (fp32 a, b, from zero state) and a decode step (S
    1, from a random state); tests/test_kernels.py:105's sweep shapes,
    ragged S and C in fp32 and bf16, and a long-memory case (a = 0.999
    over 512 steps). Returns (prefill, decode) cases."""
    import torch
    from repro_torch.kernels import _build

    gen = torch.Generator(device="cuda").manual_seed(0)
    C = 2 * 4096 * 16
    prefill = scan_case("prefill", (JAMBA_BATCH, JAMBA_PROMPT, C), gen,
                        a_kind="decay", timed=True)
    decode = scan_case("decode", (JAMBA_BATCH, 1, C), gen, a_kind="decay",
                       with_h0=True, timed=True)
    extra = [scan_case(f"sweep_{'x'.join(map(str, sh))}", sh, gen)
             for sh in ((1, 64, 32), (2, 256, 64), (1, 128, 48))]
    extra += [scan_case("ragged_S77_C1000", (2, 77, 1000), gen,
                        with_h0=True),
              scan_case("ragged_bf16", (3, 77, 1000), gen, dtype="bfloat16",
                        with_h0=True),
              scan_case("long_memory", (2, 512, 1024), gen, a_kind="0.999")]
    ptxas = ptxas_summary(
        _build.library_path("mamba_scan").with_suffix(".log"))
    for c in [prefill, decode] + extra:
        emit("kernels", **c)
    emit("kernels", kernel="mamba_scan", case="ptxas", ptxas=ptxas)
    return prefill, decode


def jamba_config(depth, period=None, attn_positions=None):
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), num_layers=depth)
    if period is not None:
        cfg = dataclasses.replace(cfg, hybrid_period=period,
                                  hybrid_attn_positions=attn_positions)
    return cfg


def draw_mamba_leaves(params, gen) -> None:
    """Overwrite the mamba stack's constant-initialised leaves in place
    with draws from ``gen`` (on the leaves' device): A_log = log U(1,
    d_state) (decay rates spread as S4D-real's log 1..n), dt_bias =
    softplus^-1(dt) with dt log-uniform in [1e-3, 1e-1] (Mamba's dt
    init), conv_b ~ 0.1 N(0, 1), D_skip ~ 1 + 0.1 N(0, 1). At their
    default init (ones, zeros) every channel decays alike."""
    import math

    import torch
    for pos in params["blocks"].values():
        if "mamba" not in pos:
            continue
        p = pos["mamba"]
        for name, t in p.items():
            shape, dev = t.shape, t.device
            if name == "A_log":
                x = torch.log(1 + torch.rand(shape, generator=gen, device=dev)
                              * (shape[-1] - 1))
            elif name == "dt_bias":
                lo, hi = math.log(1e-3), math.log(1e-1)
                dt = torch.exp(lo + torch.rand(shape, generator=gen,
                                               device=dev) * (hi - lo))
                x = torch.log(torch.expm1(dt))
            elif name in ("conv_b", "D_skip"):
                x = 0.1 * torch.randn(shape, generator=gen, device=dev)
                x = x + 1.0 if name == "D_skip" else x
            else:
                continue
            t.copy_(x)


def phase_jamba_serve():
    """The hybrid serve path at full width and JAMBA_DEPTH layers:
    prefill, then greedy decode over the contiguous KV cache and the
    mamba state. Returns the scan and attention kernels' launches."""
    import numpy as np
    import torch
    from repro_torch.configs.base import RunConfig, ShapeCell
    from repro_torch.core.engine import StepBundle
    from repro_torch.core.partition import tree_items
    from repro_torch.kernels import ops
    from repro_torch.models.lm import layer_plan

    cfg = jamba_config(JAMBA_DEPTH)
    max_len = JAMBA_PROMPT + JAMBA_DECODE
    cell = ShapeCell("jamba_serve", "decode", max_len, JAMBA_BATCH)
    bundle = StepBundle(RunConfig(model=cfg, shape=cell))
    plan, groups = layer_plan(cfg)
    n_mamba = groups * sum(k[0] == "mamba" for k in plan)
    n_attn = groups * sum(k[0] == "attn" for k in plan)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bundle.init_all_params(seed=0)
    draw_mamba_leaves(params, torch.Generator(device="cuda").manual_seed(1))
    ids = torch.randint(1, cfg.vocab_size, (JAMBA_BATCH, JAMBA_PROMPT),
                        generator=torch.Generator(device="cuda")
                        .manual_seed(2), device="cuda")
    prefill, decode = bundle.make_prefill_step(), bundle.make_decode_step()
    pick = bundle.make_greedy_pick()
    state = bundle.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gib = sum(t.numel() * t.element_size()
                      for _, t in tree_items(params)) / 2**30

    ops.mamba_scan.launches = ops.flash_attention.launches = 0
    t0 = time.perf_counter()
    logits, state = prefill(params, ids, state)
    tok = pick(logits)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    finite, tokens, tpot = [torch.isfinite(logits).all()], [tok], []
    for _ in range(JAMBA_DECODE):
        t1 = time.perf_counter()
        logits, state = decode(params, tok[:, None], state)
        tok = pick(logits)
        torch.cuda.synchronize()
        tpot.append(time.perf_counter() - t1)
        finite.append(torch.isfinite(logits).all())
        tokens.append(tok)
    wall = time.perf_counter() - t0
    launches = {"mamba_scan": ops.mamba_scan.launches,
                "flash_attention": ops.flash_attention.launches}

    steps = 1 + JAMBA_DECODE
    expected = {"mamba_scan": n_mamba * steps,
                "flash_attention": n_attn * steps}
    check(launches == expected, f"kernel launches {launches}, expected "
          f"{expected} ({n_mamba} mamba and {n_attn} attention layers x "
          f"{steps} steps)")
    counters = check_split_counters("jamba_serve")
    check(all(bool(f.item()) for f in finite), "a logit is not finite")
    toks = torch.stack(tokens, dim=1).cpu()
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all().item()),
          "a token id lies outside the vocabulary")
    d_in = cfg.mamba.expand * cfg.d_model
    hd = cfg.resolved_head_dim()
    kv = ((groups, JAMBA_BATCH, max_len, cfg.num_kv_heads, hd),
          torch.bfloat16)
    want = {}
    for i, (mixer, _) in enumerate(plan):
        if mixer == "attn":
            want.update({f"pos{i}.attn.idx": ((groups,), torch.int32),
                         f"pos{i}.attn.k": kv, f"pos{i}.attn.v": kv})
        else:
            want.update({
                f"pos{i}.mamba.conv": ((groups, JAMBA_BATCH,
                                        cfg.mamba.d_conv - 1, d_in),
                                       torch.bfloat16),
                f"pos{i}.mamba.h": ((groups, JAMBA_BATCH, d_in,
                                     cfg.mamba.d_state), torch.float32)})
    got = {p: (tuple(t.shape), t.dtype) for p, t in tree_items(state)}
    check(got == want, f"decode state {got} != {want}")
    idx = {p: t.tolist() for p, t in tree_items(state) if p.endswith("idx")}
    check(all(v == [max_len] * groups for v in idx.values()),
          f"KV cache idx {idx}, expected {max_len}")
    tp = np.asarray(tpot)
    emit("jamba_serve", model=cfg.name, layers=cfg.num_layers,
         layers_full=jamba_config(32).num_layers, mamba_layers=n_mamba,
         attention_layers=n_attn, batch=JAMBA_BATCH, prompt=JAMBA_PROMPT,
         decode_steps=JAMBA_DECODE, weights_gib=weights_gib, init_s=init_s,
         prefill_s=prefill_s, tpot_p50_s=float(np.percentile(tp, 50)),
         tpot_p90_s=float(np.percentile(tp, 90)),
         decode_tok_s=JAMBA_BATCH * JAMBA_DECODE / float(tp.sum()),
         generated_tok_s=JAMBA_BATCH * steps / wall, wall_s=wall,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
         launches=launches, expected_launches=expected,
         split_counter_buffers=counters, row0_tokens=toks[0].tolist())
    del params, state, logits
    torch.cuda.empty_cache()
    return launches


def _recording_router(route, log, force=None):
    """A stand-in for the router ``route`` (``models.sublayers._route``)
    that records, per call, each token's router logits and chosen
    experts (on the host). ``force`` ({call: {token: experts}}) puts
    those tokens on the given experts, with their gates renormalised
    from the router's own probabilities as ``_route`` does."""
    def recorded(cfg, p, x_flat):
        import torch
        probs, gate, eid = route(cfg, p, x_flat)
        if force and len(log) in force:
            gate, eid = gate.clone(), eid.clone()
            for t, experts in force[len(log)].items():
                e = torch.tensor(experts, device=eid.device)
                g = probs[t, e]
                eid[t], gate[t] = e, g / g.sum().clamp_min(1e-9)
        log.append(((x_flat @ p["router"]).float().cpu(), eid.cpu()))
        return probs, gate, eid
    return recorded


def _bf16_step(x):
    """One bf16 step (unit in the last place) at |x|, elementwise."""
    import torch
    return torch.exp2(torch.floor(torch.log2(
        x.abs().clamp_min(2.0 ** -126))) - 7)


def contiguous_parity(phase, cfg, cp, draw=None):
    """``cfg`` through the contiguous serve steps in bf16 on the card
    (kernels) and on the CPU (plain versions), from the same weights
    (drawn on the card, then ``draw(params, generator)`` if given, and
    copied to the CPU), the CPU's greedy tokens fed to both; ``cp``:
    batch, prompt, decode steps, logit tolerance. With a MoE layer (at
    most one), the router logits agree within ROUTER_STEPS bf16 steps,
    and a token may be routed to other experts on the two sides only
    where the CPU's margin between its choice and the card's is within
    ROUTER_STEPS bf16 steps (a near-tie in the router; reported). Where
    any token was so routed, the CPU runs again with the card's choices
    forced at those tokens, so that both sides dispatch alike (the slot
    positions, and so the capacity drops, follow from the choices), and
    its routing must then equal the card's. Every row's logits at every
    step are within the tolerance of the CPU run whose dispatch equals
    the card's; the card's greedy tokens equal its, up to near-ties
    (top-2 logit margin within the tolerance). The card launches the
    flash and scan kernels once an attention and a Mamba layer a step,
    the CPU none. An encoder-decoder's prefill also takes encoder frames
    (bf16, drawn on the CPU from seed 3; ``encdec.enc_len`` of them):
    its encoder and its cross-attentions launch the flash kernel once a
    layer at prefill, the cross-attentions again once a layer a decode
    step. Emits the ``phase`` line; returns it."""
    import torch
    from repro_torch.configs.base import RunConfig, ShapeCell
    from repro_torch.core.engine import StepBundle
    from repro_torch.core.partition import tree_map
    from repro_torch.kernels import ops
    from repro_torch.models import sublayers
    from repro_torch.models.encdec import enc_len
    from repro_torch.models.lm import layer_plan

    seq = cp["prompt"] + cp["decode"]
    run = RunConfig(model=cfg, shape=ShapeCell(phase, "decode", seq,
                                               cp["batch"]))
    cpu, gpu = StepBundle(run, device="cpu"), StepBundle(run)
    frames = ()
    if cfg.num_encoder_layers:
        plan, groups = [("attn", "mlp")], cfg.num_layers
        frames = (torch.randn(cp["batch"], enc_len(seq), cfg.d_model,
                              generator=torch.Generator().manual_seed(3)
                              ).bfloat16(),)
    else:
        plan, groups = layer_plan(cfg)
    n_moe = groups * sum(k[1] == "moe" for k in plan)
    check(n_moe <= 1, f"{phase}: {n_moe} MoE layers (at most 1)")
    t0 = time.perf_counter()
    p_gpu = gpu.init_all_params(seed=0)
    if draw is not None:
        draw(p_gpu, torch.Generator(gpu.device).manual_seed(1))
    p_cpu = tree_map(lambda t: t.to(cpu.device), p_gpu)
    draw_s = time.perf_counter() - t0
    ids = torch.randint(1, cfg.vocab_size, (cp["batch"], cp["prompt"]),
                        generator=torch.Generator().manual_seed(2))
    route = sublayers._route

    def serve(b, p, feed=None, force=None):
        """Prefill + decode steps, fed ``feed`` (default: own greedy
        tokens). Returns (per-step logits, greedy tokens, router log,
        (scan, attention) launches, seconds)."""
        routes = []
        sublayers._route = _recording_router(route, routes, force)
        launches = (ops.mamba_scan.launches, ops.flash_attention.launches)
        t0 = time.perf_counter()
        try:
            logits, state = b.make_prefill_step()(
                p, *(f.to(b.device) for f in frames), ids.to(b.device),
                b.init_state())
            steps = [logits.float().cpu()]
            dec = b.make_decode_step()
            toks = [torch.argmax(logits, dim=-1).cpu()]
            for i in range(cp["decode"]):
                tok = feed[i] if feed is not None else toks[-1]
                logits, state = dec(p, tok[:, None].to(b.device), state)
                steps.append(logits.float().cpu())
                toks.append(torch.argmax(logits, dim=-1).cpu())
        finally:
            sublayers._route = route
        return (steps, toks, routes,
                (ops.mamba_scan.launches - launches[0],
                 ops.flash_attention.launches - launches[1]),
                time.perf_counter() - t0)

    # the CPU's run fixes the tokens both sides are fed
    lc, tc, rc, nc, t_c = serve(cpu, p_cpu)
    lg, tg, rg, ng, t_g = serve(gpu, p_gpu, feed=tc)
    S = cp["prompt"]
    route_diffs, force, router_steps = [], {}, 0.0
    check(len(rc) == len(rg) == n_moe * (1 + cp["decode"]),
          f"{phase}: router calls: CPU {len(rc)}, card {len(rg)}")
    for step, ((l_c, e_c), (l_g, e_g)) in enumerate(zip(rc, rg)):
        # the router logits agree within ROUTER_STEPS bf16 steps at each
        # token's largest |logit|
        unit = _bf16_step(l_c.abs().amax(-1))
        steps_off = (l_g - l_c).abs().amax(-1) / unit
        router_steps = max(router_steps, steps_off.max().item())
        check(router_steps <= ROUTER_STEPS, f"{phase} step {step}: router "
              f"logits differ by {router_steps} bf16 steps")
        same = (e_c.sort(-1).values == e_g.sort(-1).values).all(-1)
        for t in torch.nonzero(~same).flatten().tolist():
            # the CPU's margin between its choice and the card's
            i = [e for e in e_c[t].tolist() if e not in e_g[t].tolist()]
            j = [e for e in e_g[t].tolist() if e not in e_c[t].tolist()]
            margin = ((l_c[t, i].min() - l_c[t, j].max()) / unit[t]).item()
            row, pos = divmod(t, S if step == 0 else 1)
            route_diffs.append({
                "step": step, "row": row, "pos": pos,
                "cpu": e_c[t].tolist(), "card": e_g[t].tolist(),
                "cpu_margin_bf16_steps": margin})
            check(margin <= ROUTER_STEPS, f"{phase} step {step} token {t}: "
                  f"MoE routing {e_c[t].tolist()} (CPU) vs "
                  f"{e_g[t].tolist()} (card) at a CPU margin of {margin} "
                  f"bf16 steps")
            force.setdefault(step, {})[t] = e_g[t].tolist()
    rerun_s = None
    if force:
        lc, tc, rf, _, rerun_s = serve(cpu, p_cpu, feed=tc, force=force)
        for step, ((_, e_f), (_, e_g)) in enumerate(zip(rf, rg)):
            check(torch.equal(e_f.sort(-1).values, e_g.sort(-1).values),
                  f"{phase} step {step}: the forced CPU run routes "
                  "otherwise")
    diffs = []
    for step, (a, b) in enumerate(zip(lg, lc)):
        d = (a - b).abs().amax(-1)
        for row, v in enumerate(d.tolist()):
            check(v <= cp["logit_tol"], f"{phase} step {step} row {row}: "
                  f"card and CPU logits differ by {v}")
        diffs.append(d.tolist())
    near_ties = []
    for step, (a, b) in enumerate(zip(tg, tc)):
        for row in torch.nonzero(a != b).flatten().tolist():
            top2 = lc[step][row].topk(2).values
            check(float(top2[0] - top2[1]) <= cp["logit_tol"],
                  f"{phase} step {step} row {row}: tokens {b[row].item()} "
                  f"(CPU) vs {a[row].item()} (card)")
            near_ties.append([step, row])
    steps = 1 + cp["decode"]
    want = tuple(groups * sum(k[0] == kind for k in plan) * steps
                 for kind in ("mamba", "attn"))
    if frames:      # the encoder's, then a cross-attention a layer a step
        want = (0, want[1] + cfg.num_encoder_layers + groups * steps)
    check(ng == want and nc == (0, 0),
          f"{phase}: launches (scan, attention): card {ng}, expected {want}; "
          f"CPU {nc}")
    line = dict(model=cfg.name, layers=cfg.num_layers, dtype="bfloat16",
                batch=cp["batch"], prompt=cp["prompt"],
                decode_steps=cp["decode"], logit_tol=cp["logit_tol"],
                logits_max_abs_diff=diffs,
                router_logits_max_bf16_steps=router_steps,
                routing_differences=route_diffs, cpu_rerun_forced=bool(force),
                token_near_ties=near_ties,
                tokens_cpu=[t.tolist() for t in tc],
                tokens_gpu=[t.tolist() for t in tg],
                launches={"gpu": ng, "cpu": nc}, draw_s=draw_s, cpu_s=t_c,
                gpu_s=t_g, cpu_rerun_s=rerun_s)
    emit(phase, **line)
    del p_gpu
    torch.cuda.empty_cache()
    return line


def phase_jamba_parity():
    """jamba at full width and depth 2 (attention + MLP, Mamba + MoE) in
    bf16, card against CPU (``contiguous_parity``), its constant leaves
    drawn (``draw_mamba_leaves``)."""
    cp = JAMBA_PARITY
    contiguous_parity("jamba_parity", jamba_config(cp["depth"], 2, (0,)), cp,
                      draw_mamba_leaves)


# -- phase 3 -----------------------------------------------------------------

def phase_serve():
    import contextlib
    import io

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    ops.flash_attention.launches = 0
    with contextlib.redirect_stdout(buf):
        summary, results = serve.main(SERVE_ARGS)
    torch.cuda.synchronize()
    launches = ops.flash_attention.launches
    layers = get_config("qwen2.5-3b").num_layers
    calls = summary["prefill_calls"] + summary["decode_calls"]
    check(len(results) == 16, f"served {len(results)} of 16 requests")
    check(all(len(r.tokens) == 16 for r in results),
          "a request did not return 16 tokens")
    vocab = get_config("qwen2.5-3b").vocab_size
    check(all(0 <= t < vocab for r in results for t in r.tokens),
          "a token id lies outside the vocabulary")
    check(launches == layers * calls,
          f"flash kernel launched {launches} times, expected "
          f"{layers} x {calls}")
    counters = check_split_counters("serve")
    emit("serve", args=" ".join(SERVE_ARGS), launches=launches,
         expected_launches=layers * calls, split_counter_buffers=counters,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
         summary=summary,
         requesf0tokens=sorted(results, key=lambda r: r.rid)[0].tokens)
    return launches


def phase_profile():
    """Where the serve time goes: the phase-3 workload served again under
    torch.profiler (phase 3's numbers are taken with tracing off).
    Device busy time is the sum of the CUDA kernels' and copies' own
    times (one stream, so they do not overlap); idle share is the rest
    of the traced wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import RunConfig, ShapeCell
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import StepBundle
    from repro_torch.core.engine.serve import default_paged_kv
    from repro_torch.core.serve_schedule import PagedServeEngine
    from repro_torch.launch.serve import mixed_requests

    cfg = get_config("qwen2.5-3b")
    cell = ShapeCell("serve", "decode", 512, 8)
    bundle = StepBundle(RunConfig(model=cfg, shape=cell))
    params = bundle.init_all_params(seed=0)
    engine = PagedServeEngine(bundle, default_paged_kv(bundle, cell),
                              chunk=128)
    reqs = mixed_requests(16, 512, 16, cfg.vocab_size, seed=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.serve(params, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    dev, host = profile_self_times(prof)
    busy_us = sum(us for _, us in dev.values())
    n_kernels = sum(n for n, _ in dev.values())
    steps = engine.prefill_calls + engine.decode_calls

    def top(rows, n=12):
        rows = sorted(rows.items(), key=lambda kv: kv[1][1], reverse=True)
        return [{"name": k[:90], "count": c, "ms": us / 1e3}
                for k, (c, us) in rows[:n]]
    emit("profile", wall_s=wall, device_busy_s=busy_us / 1e6,
         device_idle_share=1 - busy_us / 1e6 / wall,
         prefill_calls=engine.prefill_calls,
         decode_calls=engine.decode_calls,
         device_launches=n_kernels, launches_per_step=n_kernels / steps,
         top_device=top(dev), top_host=top(host),
         analysis_s=time.perf_counter() - t1)


def profile_self_times(prof):
    """({name: (count, self us)} of the trace's device events, the same
    of its host ops): what ``prof.key_averages()`` sums as
    ``self_device_time_total`` / ``self_cpu_time_total``, read from the
    raw kineto events. A device event has no children, so its self time
    is its duration; a host op's is its duration less its direct
    children's on the same thread, ops nesting by time as in torch's
    event tree (an op that ends after the open one is not its child; an
    only child of the same name is folded into its parent).
    key_averages builds a Python object of every event first: ~95 s for
    the serve phase's ~10^6 events on the card's host, 11x this."""
    from torch.autograd import DeviceType
    dev, host, threads = {}, {}, {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith("[") or e.is_hidden_event():
            continue                   # memory records, hidden events
        if e.device_type() == DeviceType.CUDA:
            c, us = dev.get(name, (0, 0.0))
            dev[name] = (c + 1, us + e.duration_ns() / 1e3)
        elif e.device_type() == DeviceType.CPU and not e.is_async() \
                and e.start_thread_id() == e.end_thread_id():
            threads.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), -e.end_ns(), name))

    def close(stack):
        node = stack.pop()             # [end, name, duration, children]
        while len(node[3]) == 1 and node[3][0][1] == node[1]:
            node[3] = node[3][0][3]
        if stack:
            stack[-1][3].append(node)
            return
        todo = [node]
        while todo:
            n = todo.pop()
            c, us = host.get(n[1], (0, 0.0))
            host[n[1]] = (c + 1, us + (n[2] - sum(k[2] for k in n[3])) / 1e3)
            todo.extend(n[3])
    for evs in threads.values():
        evs.sort()
        stack = []
        for start, neg_end, name in evs:
            end = -neg_end
            while stack and (stack[-1][0] <= start or end > stack[-1][0]):
                close(stack)
            stack.append([end, name, end - start, []])
        while stack:
            close(stack)
    return dev, host


# -- phase 4 -----------------------------------------------------------------

def phase_parity():
    import numpy as np
    import torch
    from repro_torch.configs.base import RunConfig, ShapeCell
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import StepBundle
    from repro_torch.core.engine.serve import default_paged_kv
    from repro_torch.core.partition import tree_map
    from repro_torch.core.serve_schedule import PagedServeEngine
    from repro_torch.launch.serve import mixed_requests

    tol = 0.1          # logits ~N(0,1) in bf16: a few bf16 steps
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=2)
    run = RunConfig(model=cfg, shape=ShapeCell("parity", "decode", 64, 3))
    cpu = StepBundle(run, device="cpu")
    gpu = StepBundle(run)
    p_cpu = cpu.init_all_params(seed=0)
    p_gpu = tree_map(lambda t: t.to(gpu.device), p_cpu)
    reqs = mixed_requests(3, 64, 4, cfg.vocab_size, seed=1)
    out = {}
    for name, b, p in (("cpu", cpu, p_cpu), ("gpu", gpu, p_gpu)):
        eng = PagedServeEngine(b, default_paged_kv(b, run.shape), chunk=32,
                               capture_logits=True)
        t0 = time.perf_counter()
        res, _ = eng.serve(p, list(reqs))
        out[name] = ({r.rid: r.tokens for r in res}, eng.captured,
                     time.perf_counter() - t0)
    (tok_c, cap_c, t_c), (tok_g, cap_g, t_g) = out["cpu"], out["gpu"]
    first = [float(np.abs(cap_g[r][0] - cap_c[r][0]).max()) for r in tok_c]
    check(max(first) <= tol, f"first-token logits differ by {max(first)}")
    compared, diverged = 0, []
    for rid in tok_c:
        for step, (a, b) in enumerate(zip(tok_c[rid], tok_g[rid])):
            if a != b:
                # only a near-tie may flip: the CPU's top-2 margin at that
                # step must lie within the logit tolerance
                top2 = np.sort(cap_c[rid][step])[-2:]
                check(float(top2[1] - top2[0]) <= tol,
                      f"request {rid} step {step}: tokens {a} vs {b}")
                diverged.append([rid, step])
                break
            compared += 1
    emit("parity", layers=cfg.num_layers, requests=len(reqs),
         logit_tol=tol, first_token_max_abs_diff=first,
         tokens_cpu=tok_c, tokens_gpu=tok_g, tokens_compared=compared,
         near_tie_divergences=diverged, cpu_s=t_c, gpu_s=t_g)


# -- phases 5 and 6 ------------------------------------------------------------

def _train_job(cfg, seq, batch, runs, dtype="bfloat16", grad_clip=1.0,
               mesh=(2, 2, 1), **kw):
    from repro_torch.configs.base import (OptimizerConfig, RunConfig,
                                          ShapeCell, SystemConfig)
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.train import TrainJob
    run = RunConfig(model=cfg, shape=ShapeCell("train", "train", seq, batch),
                    system=SystemConfig(dtype=dtype),
                    optimizer=OptimizerConfig(lr=3e-4, total_steps=100,
                                              warmup_steps=10,
                                              grad_clip=grad_clip))
    return TrainJob(run=run, mesh=MeshShape(("pod", "data", "model"), mesh),
                    runs=runs, seed=0, **kw)


def _rel(a, b):
    return abs(a - b) / abs(b)


def spawn_card_and_cpu(make_job, timeout_s=300):
    """The ranks of ``make_job("cuda")`` and of ``make_job("cpu")`` side
    by side (the CPU job's spawn in a thread): {device: (rank 0's runs,
    wall seconds)}. A parity phase's two jobs share no state, so the
    CPU ranks need not wait for the card's."""
    import threading

    from repro_torch.launch.train import spawn
    out, errors = {}, []

    def one(dev):
        try:
            t0 = time.perf_counter()
            rs = spawn(make_job(dev), timeout_s=timeout_s)[0]["runs"]
            out[dev] = (rs, time.perf_counter() - t0)
        except BaseException as e:       # re-raised on the main thread
            errors.append(e)
    cpu = threading.Thread(target=one, args=("cpu",))
    cpu.start()
    one("cuda")
    cpu.join()
    if errors:
        raise errors[0]
    return out


def phase_train(extra=()):
    """The train path at full width, depth 2, 4 ranks on the card. The
    ``extra`` runs (phase sched_train's) ride on the same ranks before
    the last arm, whose state the checkpoint task takes; returns (the
    launches, fcdp's bytes, the task's results, every rank's record of
    each extra run, every rank's fcdp record)."""
    import math
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import ModeRun, spawn

    cfg = dataclasses.replace(get_config("qwen2.5-3b"),
                              num_layers=TRAIN_DEPTH)
    runs = [ModeRun("zero3"), ModeRun("zeropp"), ModeRun("fcdp"),
            ModeRun("fcdp", "int8_pod", "int8_pod"),
            ModeRun("fcdp", fused_matmul="ag_matmul"),
            ModeRun("fcdp", fused_matmul="both")]
    n = len(runs) - 1
    job = _train_job(cfg, TRAIN_SEQ, TRAIN_BATCH,
                     runs[:n] + list(extra) + runs[n:],
                     task=_dense_ckpt_task, keep_last=True)
    t0 = time.perf_counter()
    ranks = spawn(job, timeout_s=900)
    wall = time.perf_counter() - t0
    idx = list(range(n)) + [n + len(extra)]
    by = {_run_key(ranks[0]["runs"][i]["run"]): [rk["runs"][i]
                                                 for rk in ranks]
          for i in idx}
    extra_results = [[rk["runs"][n + j] for rk in ranks]
                     for j in range(len(extra))]
    check(all(rk["backend"] == "gloo" for rk in ranks),
          "4 ranks on one card must talk through gloo")
    summary = {}
    for name, rs in by.items():
        r0 = rs[0]
        losses = [m["loss"] for m in r0["metrics"]]
        check(all(math.isfinite(v) for v in losses),
              f"{name}: a loss is not finite: {losses}")
        check(all(r["metrics"] == r0["metrics"] for r in rs),
              f"{name}: the ranks disagree on the metrics")
        for r in rs:
            for s, launched in enumerate(r["launches"]):
                check(launched == r["int8_plan"],
                      f"{name} step {s}: int8 launches {launched} != the "
                      f"plans' {r['int8_plan']}")
            check(r["mm_launches"] == [r["mm_plan"]] * len(r["metrics"]),
                  f"{name}: matmul_chunk launches {r['mm_launches']} != the "
                  f"plans' {r['mm_plan']} per step")
        summary[name] = {
            "loss": losses, "grad_norm": [m["grad_norm"]
                                          for m in r0["metrics"]],
            "tokens": r0["metrics"][0]["tokens"],
            "bytes_per_step": r0["bytes"][0],
            "int8_launches_per_rank_step": r0["launches"][0],
            "int8_plan": r0["int8_plan"],
            "matmul_chunk_launches_per_rank_step": r0["mm_launches"][0],
            "cached_bytes": r0["cached"][0],
            "cache_places": r0["cache_places"][0],
            "peak_mem_gib": [r["peak_mem_bytes"] / 2**30 for r in rs],
            "step_s": [r["step_s"] for r in rs]}
    z3, zp, fc, q8 = (summary[k] for k in ("zero3", "zeropp", "fcdp",
                                           "int8"))
    for name, m in (("zeropp", zp), ("fcdp", fc)):
        check(_rel(m["loss"][0], z3["loss"][0]) <= LOSS_RTOL,
              f"{name} loss {m['loss'][0]} != zero3 {z3['loss'][0]}")
        check(_rel(m["grad_norm"][0], z3["grad_norm"][0]) <= GNORM_RTOL,
              f"{name} grad norm {m['grad_norm'][0]} != zero3 "
              f"{z3['grad_norm'][0]}")
    check(_rel(q8["loss"][0], fc["loss"][0]) <= INT8_DRIFT,
          f"int8 step-0 loss {q8['loss'][0]} drifts from fcdp "
          f"{fc['loss'][0]}")
    check(all(v > 0 for v in q8["int8_launches_per_rank_step"].values()),
          "the int8 run launched an int8 kernel no time")
    ag = {k: m["bytes_per_step"]["all_gather/pod"]
          for k, m in (("zero3", z3), ("zeropp", zp), ("fcdp", fc))}
    check(ag["fcdp"] < ag["zero3"] and ag["fcdp"] == ag["zeropp"],
          f"pod all-gather bytes {ag}")
    check(fc["cache_places"] == {"host": [("cpu", True)]},
          f"fcdp caches must lie in pinned host memory: "
          f"{fc['cache_places']}")
    check(all(f < z for f, z in zip(fc["peak_mem_gib"], zp["peak_mem_gib"])),
          f"fcdp peak memory {fc['peak_mem_gib']} GiB not below zeropp "
          f"{zp['peak_mem_gib']} GiB")
    fused = check_fused_runs(fc, summary["fcdp_ag_matmul"],
                             summary["fcdp_both"])
    launches = {k: sum(sum(step[k] for step in r["launches"])
                       for rs in by.values() for r in rs)
                for k in QUANT_NAMES}
    launches["matmul_chunk"] = sum(sum(r["mm_launches"])
                                   for rs in by.values() for r in rs)
    emit("train", model=cfg.name, layers_cut_to=TRAIN_DEPTH,
         layers_full=get_config("qwen2.5-3b").num_layers,
         seq=TRAIN_SEQ, global_batch=TRAIN_BATCH, mesh=job.mesh.shape,
         backend=ranks[0]["backend"], wall_s=wall,
         spawn_shared_with="sched_train",
         kernel_launches_total=launches, fused=fused, modes=summary)
    return (launches, fc["bytes_per_step"], [rk["task"] for rk in ranks],
            extra_results, by["fcdp"])


# the checkpoints of the restart phase: under the checkout (gitignored),
# removed once read
CKPT_DIR = ".smoke_ckpt"
# the PEFT crash/resume runs: 3 batches, a checkpoint every 2 (the step-2
# one mid-pipeline: the carry section rides along), a failure injected at
# step 2, once that checkpoint is written, so the restart restores the
# carry and runs step 2 from it (the CPU tests replay steps too)
PEFT_RESTART = dict(steps=3, ckpt_every=2, fail_at=(2,))


def _dense_ckpt_task(job, mesh, coll, device, state):
    """On every rank of phase train, after its arms: the last arm's state
    (fcdp after one step) saved at full width (blocking), restored into
    a fresh bundle (equal, and digest-equal, to the state saved), then
    one step (batch 1) timed without and with an async save of the
    same state in flight, the state restored between the two, which
    must agree bit for bit."""
    import math
    import shutil

    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint.checkpointer import flatten_with_path
    from repro_torch.core.engine import StepBundle
    from repro_torch.launch.train import state_digest
    from repro_torch.runtime.elastic import mesh_meta

    rank, world = dist.get_rank(), dist.get_world_size()
    root = ROOT / CKPT_DIR / "dense"
    if rank == 0:
        shutil.rmtree(root, ignore_errors=True)
        root.mkdir(parents=True)
    dist.barrier()
    tree = state.state_tree()
    blocks = state.bundle.state_blocks(tree)
    flat = [leaf for _, leaf in flatten_with_path(tree)[0]]
    flat_blocks = [b for _, b in flatten_with_path(blocks)[0]]
    nbytes = sum(math.prod(b.shape) * (leaf.element_size()
                                       if torch.is_tensor(leaf) else 4)
                 for leaf, b in zip(flat, flat_blocks))
    free = shutil.disk_usage(root).free
    # the blocking checkpoint and the async one, both on disk at once
    check(free >= 2.1 * nbytes,
          f"restart: {free} B free under {root}, a checkpoint takes "
          f"{nbytes} B and the phase writes two")
    out = {"bytes": nbytes, "free_bytes": free, "leaves": len(flat),
           "carry": "carry" in tree, "arm": dataclasses.asdict(
               job.runs[-1])}
    ck = Checkpointer(str(root), keep=1, rank=rank, world=world,
                      barrier=dist.barrier)
    meta = mesh_meta(state.bundle)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.barrier()

    out["digest_saved"] = state_digest(tree)
    sync()
    t0 = time.perf_counter()
    ck.save(1, tree, blocking=True, meta=meta, blocks=blocks)
    out["save_blocking_s"] = time.perf_counter() - t0
    if rank == 0:
        out["disk_bytes"] = sum(f.stat().st_size
                                for f in (root / "step_00000001").iterdir())
    # a fresh bundle of the same run: the restore allocates the tensors
    fresh = StepBundle(state.run, device=device, mesh=mesh,
                       defs_fn=job.runs[-1].defs_fn)
    example = {"params": [torch.empty(t.shape, dtype=t.dtype, device="meta")
                          for t in tree["params"]],
               "opt": {k: [torch.empty(t.shape, dtype=t.dtype, device="meta")
                           for t in v] if k != "step" else v
                       for k, v in tree["opt"].items()}}
    sync()
    t0 = time.perf_counter()
    got = ck.restore(1, example, shardings=fresh)
    sync()
    out["restore_s"] = time.perf_counter() - t0
    out["digest_restored"] = state_digest(got)
    out["restored_equal"] = all(
        torch.equal(a, b) if torch.is_tensor(a) else a == b
        for a, b in zip(flat, [leaf for _, leaf in
                               flatten_with_path(got)[0]]))
    del fresh

    def timed_step():
        sync()
        t0 = time.perf_counter()
        m = state.do_train_step(state.batch(1))
        sync()
        return m, time.perf_counter() - t0

    out["metrics_plain"], out["step_plain_s"] = timed_step()
    state.load_state(got)       # back to the saved state
    del got
    sync()
    t0 = time.perf_counter()
    ck.save(2, state.state_tree(), blocking=False, meta=meta, blocks=blocks)
    out["save_async_call_s"] = time.perf_counter() - t0
    out["metrics_async"], out["step_async_s"] = timed_step()
    t0 = time.perf_counter()
    ck.wait()
    out["drain_s"] = time.perf_counter() - t0
    sync()
    if rank == 0:
        shutil.rmtree(root, ignore_errors=True)
    dist.barrier()
    return out


def phase_restart(dense, peft):
    """Checkpoint and restart on the train path, from the ranks of phases
    train and peft_train: the dense checkpoint (``_dense_ckpt_task``)
    and the PEFT crash/resume runs (``PEFT_RESTART``)."""
    gpu = gpu_line()
    d0 = dense[0]
    for d in dense:
        check(d["restored_equal"] and d["digest_restored"]
              == d["digest_saved"],
              "restart: the restored dense state differs from the saved one")
        check(d["metrics_async"] == d["metrics_plain"],
              f"restart: the step with a save in flight "
              f"{d['metrics_async']} != without {d['metrics_plain']}")
    check(d0["disk_bytes"] >= d0["bytes"],
          f"restart: {d0['disk_bytes']} B on disk for a {d0['bytes']} B "
          "checkpoint")
    clean, crash = peft["restart_clean"], peft["restart_crash"]
    for c, x in zip(clean, crash):
        rc, rx = c["restart"], x["restart"]
        check(rc["restarts"] == 0 and rx["restarts"] == 1,
              f"restart: restarts {rc['restarts']} / {rx['restarts']}")
        want = [{"step": PEFT_RESTART["ckpt_every"],
                 "resume": PEFT_RESTART["ckpt_every"], "carry": True,
                 "carry_invalidated": False}]
        check(rx["restored"] == want,
              f"restart: restored {rx['restored']} != {want}")
        check(rx["losses"] == rc["losses"]
              and sorted(rc["losses"]) == list(range(PEFT_RESTART["steps"])),
              f"restart: crash losses {rx['losses']} != clean "
              f"{rc['losses']}")
        check(x["final_digest"] == c["final_digest"],
              "restart: the resumed run's final shards differ from the "
              "uninterrupted run's")
    x0, c0 = crash[0], clean[0]

    def span(key):
        vals = [d[key] for d in dense]
        return {"min": min(vals), "max": max(vals), "rank0": vals[0]}
    emit("restart", gpu=gpu, model=f"qwen2.5-3b depth {TRAIN_DEPTH}",
         seq=TRAIN_SEQ, global_batch=TRAIN_BATCH, ranks=len(dense),
         dense={"arm": d0["arm"]["mode"] + "+" + d0["arm"]["fused_matmul"],
                "checkpoint_bytes": d0["bytes"],
                "disk_bytes": d0["disk_bytes"], "leaves": d0["leaves"],
                "carry": d0["carry"], "free_bytes": d0["free_bytes"],
                "save_blocking_s": span("save_blocking_s"),
                "write_gb_per_s": d0["bytes"] / 1e9
                / max(d["save_blocking_s"] for d in dense),
                "restore_s": span("restore_s"),
                "step_plain_s": span("step_plain_s"),
                "step_async_s": span("step_async_s"),
                "save_async_call_s": span("save_async_call_s"),
                "drain_s": span("drain_s"),
                "loss": d0["metrics_plain"]["loss"],
                "digest_saved": d0["digest_saved"],
                "digest_restored": d0["digest_restored"]},
         peft={"lora_rank": PEFT_RANK, **PEFT_RESTART,
               "losses_clean": c0["restart"]["losses"],
               "losses_crash": x0["restart"]["losses"],
               "kinds_crash": x0["kinds"],
               "restored": x0["restart"]["restored"],
               "final_digest": x0["final_digest"],
               "checkpoint_bytes": peft["checkpoint_bytes"],
               "ckpt_steps": x0["restart"]["ckpt_steps"],
               "save_call_s": x0["restart"]["save_s"],
               "restore_s": x0["restart"]["restore_s"],
               "step_s_clean": c0["step_s"], "step_s_crash": x0["step_s"]})


def _run_key(run):
    if run["param_compress"] != "none":
        return "int8"
    if run["fused_matmul"] != "none":
        return f"{run['mode']}_{run['fused_matmul']}"
    return run["mode"]


def check_fused_runs(fc, ag, both):
    """The fused fcdp runs against unfused fcdp: step-0 loss and grad
    norm within the modes' tolerances (on the card the unfused
    projection is cuBLAS and the fused one the kernel, so not bit for
    bit); 'both''s forward is 'ag_matmul''s, so its step-0 loss is equal
    to the bit; the 'pod' bytes are fcdp's; the ring moves fcdp's
    data-axis bytes (ag_matmul: its forward gathers become ppermutes;
    both: its backward gathers and dw reduce-scatters too); the stage-1
    caches lie in pinned host memory, as many bytes as fcdp's."""
    for name, m in (("ag_matmul", ag), ("both", both)):
        check(_rel(m["loss"][0], fc["loss"][0]) <= LOSS_RTOL,
              f"fused {name} loss {m['loss'][0]} != fcdp {fc['loss'][0]}")
        check(_rel(m["grad_norm"][0], fc["grad_norm"][0]) <= GNORM_RTOL,
              f"fused {name} grad norm {m['grad_norm'][0]} != fcdp "
              f"{fc['grad_norm'][0]}")
        b, bf = m["bytes_per_step"], fc["bytes_per_step"]
        for k in bf:
            if k.endswith("/pod"):
                check(b.get(k) == bf[k], f"fused {name} {k} {b.get(k)} != "
                      f"fcdp {bf[k]}")
        data = sum(v for k, v in b.items() if k.endswith("/data"))
        check(data == sum(v for k, v in bf.items() if k.endswith("/data")),
              f"fused {name}: data-axis bytes {b} not fcdp's {bf}")
        check(b.get("ppermute/data", 0) > 0, f"fused {name}: no ring hop")
        check(m["cache_places"] == {"host": [("cpu", True)]}
              and m["cached_bytes"] == fc["cached_bytes"],
              f"fused {name} caches {m['cached_bytes']} in "
              f"{m['cache_places']}, fcdp {fc['cached_bytes']}")
    check(both["loss"][0] == ag["loss"][0],
          f"both step-0 loss {both['loss'][0]} != ag_matmul "
          f"{ag['loss'][0]}")
    ring = ag["bytes_per_step"]["ppermute/data"]
    check(ag["bytes_per_step"]["all_gather/data"] + ring
          == fc["bytes_per_step"]["all_gather/data"]
          and both["bytes_per_step"]["ppermute/data"] == 3 * ring,
          "the ring is not byte-neutral")
    return {"ring_bytes_per_rank_step": ring,
            "ag_matmul_bytes": ag["bytes_per_step"],
            "both_bytes": both["bytes_per_step"],
            "loss_step0": {"fcdp": fc["loss"][0], "ag_matmul": ag["loss"][0],
                           "both": both["loss"][0]},
            "grad_norm_step0": {"fcdp": fc["grad_norm"][0],
                                "ag_matmul": ag["grad_norm"][0],
                                "both": both["grad_norm"][0]},
            "peak_mem_gib": {"fcdp": fc["peak_mem_gib"],
                             "ag_matmul": ag["peak_mem_gib"],
                             "both": both["peak_mem_gib"]}}


def phase_train_parity():
    """fcdp + int8 and fcdp + ag_matmul at smoke width, the same 4-rank
    steps on the card and on the CPU, from the same weights (drawn on
    the CPU). fp32 weights and activations: in bf16 the dequantized
    weights put matmul outputs on rounding ties that the card's and the
    CPU's matmuls break apart (tests/test_torch_train.py measures the
    same against JAX); fp32 also runs the chunk matmul's CUDA-core
    path. Returns phase family_parity's runs ({device: records}), which
    ride on the same jobs after these two."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.train import ModeRun

    runs = [ModeRun("fcdp", "int8_pod", "int8_pod", dtype="float32"),
            ModeRun("fcdp", fused_matmul="ag_matmul", dtype="float32")]
    # phase family_parity's, arch_parity's and encdec_parity's, checked
    # there
    runs += family_parity_runs() + arch_parity_runs() + encdec_parity_runs()
    out = spawn_card_and_cpu(
        lambda dev: _train_job(get_smoke_config("qwen2.5-3b"), 64, 8, runs,
                               dtype="float32", device=dev, draw_device="cpu"))
    (gs, t_g), (cs, t_c) = out["cuda"], out["cpu"]
    report = {}
    for name, g, c in zip(("int8", "ag_matmul"), gs, cs):
        mg, mc = g["metrics"][0], c["metrics"][0]
        check(_rel(mg["loss"], mc["loss"]) <= LOSS_RTOL,
              f"{name}: card loss {mg['loss']} != CPU {mc['loss']}")
        check(_rel(mg["grad_norm"], mc["grad_norm"]) <= GNORM_RTOL,
              f"{name}: card grad norm {mg['grad_norm']} != CPU "
              f"{mc['grad_norm']}")
        check(g["bytes"] == c["bytes"],
              f"{name}: card and CPU moved different bytes")
        check(g["launches"][0] == g["int8_plan"] and not any(
            c["launches"][0].values()), f"{name}: int8 launches: card must "
              "launch the plans' count, the CPU none")
        check(g["mm_launches"][0] == g["mm_plan"] and c["mm_launches"][0] == 0
              and c["mm_calls"][0] == c["mm_plan"],
              f"{name}: matmul_chunk launches: card {g['mm_launches']} must "
              f"be the plans' {g['mm_plan']}, the CPU none")
        report[name] = {"loss": {"cuda": mg["loss"], "cpu": mc["loss"]},
                        "grad_norm": {"cuda": mg["grad_norm"],
                                      "cpu": mc["grad_norm"]},
                        "int8_launches_cuda": g["launches"][0],
                        "matmul_chunk_launches_cuda": g["mm_launches"][0],
                        "bytes": g["bytes"][0]}
    check(report["ag_matmul"]["matmul_chunk_launches_cuda"] > 0,
          "the fused parity run launched no chunk matmul")
    emit("train_parity", model="qwen2.5-smoke", dtype="float32",
         runs=report, wall_s={"cuda": t_g, "cpu": t_c})
    return {"cuda": gs[2:], "cpu": cs[2:]}


# -- phases 11 and 12: PEFT / FCDP-Comm ------------------------------------------

PEFT_RANK = 8              # the paper's section V-D LoRA rank, on wq/wk/wv/wo
PEFT_MIXED = (("*lora*", "zero3"),)
# peft_smoke's model (benchmarks/harness/workloads.py): wide enough at
# rank 8 for the adapters' per-layer shards (512 elements) to carry int8
PEFT_SMOKE = dict(name="smoke-dense-peft", family="dense", num_layers=2,
                  d_model=256, num_heads=4, num_kv_heads=2, d_ff=1024,
                  vocab_size=256)


def _peft_key(run):
    if run["ckpt_dir"]:
        return "restart_crash" if run["fail_at"] else "restart_clean"
    if run["mode_overrides"]:
        return "mixed"
    return "int8" if run["param_compress"] != "none" else run["mode"]


def phase_peft_train(train_fcdp_bytes):
    """PEFT / FCDP-Comm at full width, depth 2, 4 ranks on the card: the
    trunk frozen, LoRA adapters of rank 8 on wq/wk/wv/wo trained under
    zero3, zeropp, fcdp and mics, fcdp with int8 qwZ/qgZ, and the mixed
    arm (trunk fcdp, adapters zero3); grad_clip far above the norm."""
    import math
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import ModeRun, spawn

    cfg = dataclasses.replace(get_config("qwen2.5-3b"),
                              num_layers=TRAIN_DEPTH)
    peft = dict(peft=True, lora_rank=PEFT_RANK)
    import shutil
    restart = dict(peft, microbatch=STREAM_MB, async_grad_reduce=True,
                   cross_step_pipeline=True,
                   steps=PEFT_RESTART["steps"],
                   ckpt_every=PEFT_RESTART["ckpt_every"])
    dirs = {k: ROOT / CKPT_DIR / f"peft_{k}" for k in ("clean", "crash")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    runs = [ModeRun(m, **peft)
            for m in ("zero3", "zeropp", "fcdp", "mics")] + [
        ModeRun("fcdp", "int8_pod", "int8_pod", **peft),
        ModeRun("fcdp", mode_overrides=PEFT_MIXED, **peft),
        ModeRun("fcdp", ckpt_dir=str(dirs["clean"]), **restart),
        ModeRun("fcdp", ckpt_dir=str(dirs["crash"]),
                fail_at=PEFT_RESTART["fail_at"], **restart)]
    job = _train_job(cfg, TRAIN_SEQ, TRAIN_BATCH, runs, grad_clip=1e9)
    t0 = time.perf_counter()
    ranks = spawn(job, timeout_s=900)
    wall = time.perf_counter() - t0
    by = {_peft_key(r["run"]): [rk["runs"][i] for rk in ranks]
          for i, r in enumerate(ranks[0]["runs"])}
    # the crash/resume runs (phase restart): the checkpoint's bytes on
    # disk, then the directories go
    restart_runs = {k: by.pop(k) for k in ("restart_clean", "restart_crash")}
    last = dirs["crash"] / f"step_{PEFT_RESTART['ckpt_every']:08d}"
    restart_runs["checkpoint_bytes"] = sum(f.stat().st_size
                                           for f in last.iterdir())
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    summary = {}
    for name, rs in by.items():
        r0 = rs[0]
        losses = [m["loss"] for m in r0["metrics"]]
        check(all(math.isfinite(v) for v in losses),
              f"peft {name}: a loss is not finite: {losses}")
        check(all(r["metrics"] == r0["metrics"] for r in rs),
              f"peft {name}: the ranks disagree on the metrics")
        check(all(r["frozen_unchanged"] for r in rs),
              f"peft {name}: a frozen shard changed")
        check(any(r["lora_b_moved"] for r in rs),
              f"peft {name}: every lora_b is still zero")
        for r in rs:
            for s, launched in enumerate(r["launches"]):
                check(launched == r["int8_plan"],
                      f"peft {name} step {s}: int8 launches {launched} != "
                      f"the plans' {r['int8_plan']}")
            check(not any(r["mm_launches"]),
                  f"peft {name}: the fused ring ran on a frozen leaf")
        summary[name] = {
            "loss": losses,
            "grad_norm": [m["grad_norm"] for m in r0["metrics"]],
            "bytes_per_step": r0["bytes"][0],
            "int8_launches_per_rank_step": r0["launches"][0],
            "int8_plan": r0["int8_plan"],
            "cached_bytes": r0["cached"][0],
            "cache_places": r0["cache_places"][0],
            "trainable_frac": r0["params_trainable"] / r0["params_total"],
            "peak_mem_gib": [r["peak_mem_bytes"] / 2**30 for r in rs],
            "step_s": [r["step_s"] for r in rs]}
    z3, fc, q8, mx = (summary[k] for k in ("zero3", "fcdp", "int8",
                                           "mixed"))
    for name, m in summary.items():
        check(m["trainable_frac"] < 0.01,
              f"peft {name}: trainable fraction {m['trainable_frac']}")
        if name != "int8":
            check(_rel(m["loss"][0], z3["loss"][0]) <= LOSS_RTOL
                  and _rel(m["grad_norm"][0], z3["grad_norm"][0])
                  <= GNORM_RTOL,
                  f"peft {name} step 0 ({m['loss'][0]}, {m['grad_norm'][0]})"
                  f" != zero3's ({z3['loss'][0]}, {z3['grad_norm'][0]})")
    check(_rel(q8["loss"][0], fc["loss"][0]) <= INT8_DRIFT,
          f"peft int8 step-0 loss {q8['loss'][0]} drifts from fcdp "
          f"{fc['loss'][0]}")
    check(all(v > 0 for v in q8["int8_launches_per_rank_step"].values()),
          "the peft int8 run launched an int8 kernel no time")
    pod = {k: m["bytes_per_step"].get("all_gather/pod", 0.0)
           for k, m in summary.items()}
    for name in ("fcdp", "mixed"):
        check(pod[name] <= 0.01 * pod["zero3"],
              f"peft {name} pod all-gather {pod[name]} B > 1 % of zero3's "
              f"{pod['zero3']} B")
    check(fc["cache_places"] == {"host": [("cpu", True)]},
          f"peft fcdp caches must lie in pinned host memory: "
          f"{fc['cache_places']}")
    launches = {k: sum(sum(step[k] for step in r["launches"])
                       for rs in by.values() for r in rs)
                for k in QUANT_NAMES}
    emit("peft_train", model=cfg.name, layers_cut_to=TRAIN_DEPTH,
         seq=TRAIN_SEQ, global_batch=TRAIN_BATCH, lora_rank=PEFT_RANK,
         mesh=job.mesh.shape, backend=ranks[0]["backend"], wall_s=wall,
         pod_all_gather_bytes=pod,
         pod_all_gather_vs_zero3_peft={k: pod[k] / pod["zero3"]
                                       for k in pod},
         pod_all_gather_vs_train_fcdp={
             k: pod[k] / train_fcdp_bytes["all_gather/pod"] for k in pod},
         kernel_launches_total=launches, modes=summary)
    return launches, restart_runs


def phase_peft_parity():
    """fcdp PEFT + int8 and the mixed arm at peft_smoke's width, rank 8,
    fp32, the same 4-rank steps on the card (kernels) and on the CPU
    (plain versions) from the same weights (drawn on the CPU)."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch.train import ModeRun

    peft = dict(peft=True, lora_rank=PEFT_RANK, dtype="float32")
    runs = [ModeRun("fcdp", "int8_pod", "int8_pod", **peft),
            ModeRun("fcdp", mode_overrides=PEFT_MIXED, **peft)]
    out = spawn_card_and_cpu(
        lambda dev: _train_job(ModelConfig(**PEFT_SMOKE), 64, 8, runs,
                               dtype="float32", grad_clip=1e9, device=dev,
                               draw_device="cpu"))
    (gs, t_g), (cs, t_c) = out["cuda"], out["cpu"]
    report = {}
    for name, g, c in zip(("int8", "mixed"), gs, cs):
        mg, mc = g["metrics"][0], c["metrics"][0]
        check(_rel(mg["loss"], mc["loss"]) <= LOSS_RTOL,
              f"peft {name}: card loss {mg['loss']} != CPU {mc['loss']}")
        check(_rel(mg["grad_norm"], mc["grad_norm"]) <= GNORM_RTOL,
              f"peft {name}: card grad norm {mg['grad_norm']} != CPU "
              f"{mc['grad_norm']}")
        check(g["bytes"] == c["bytes"],
              f"peft {name}: card and CPU moved different bytes")
        check(g["launches"][0] == g["int8_plan"] and not any(
            c["launches"][0].values()) and c["calls"][0] == c["int8_plan"],
              f"peft {name}: int8 launches: card must launch the plans' "
              "count, the CPU none")
        report[name] = {"loss": {"cuda": mg["loss"], "cpu": mc["loss"]},
                        "grad_norm": {"cuda": mg["grad_norm"],
                                      "cpu": mc["grad_norm"]},
                        "int8_launches_cuda": g["launches"][0],
                        "bytes": g["bytes"][0]}
    check(all(v > 0 for v in report["int8"]["int8_launches_cuda"].values()),
          "the peft parity run launched an int8 kernel no time")
    emit("peft_parity", model=PEFT_SMOKE["name"], dtype="float32",
         lora_rank=PEFT_RANK, runs=report, wall_s={"cuda": t_g, "cpu": t_c})


# -- phases 13 and 14: tensor parallelism over 'model' ---------------------------

# tests/test_torch_tp.py's DENSE model (tests/test_system.py's)
TP_PARITY_MODEL = dict(name="t-dense", family="dense", num_layers=2,
                       d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                       vocab_size=256, qkv_bias=True)
# the int8 activation all-reduce against the exact run, per step
# (tests/test_substrate.py's bound)
ACT_DRIFT = 0.08


def _tp_key(run):
    key = run["mode"]
    if run["param_compress"] != "none":
        key += "_int8_pod"
    if run["act_psum"] != "bf16":
        key += "_act_" + run["act_psum"]
    if run["fused_matmul"] != "none":
        key += "_" + run["fused_matmul"]
    return key


def _tp_checks(name, rs):
    """Finite losses the ranks agree on, and the int8 and chunk-matmul
    launches of every rank and step equal to the plans."""
    import math
    r0 = rs[0]
    losses = [m["loss"] for m in r0["metrics"]]
    check(all(math.isfinite(v) for v in losses),
          f"tp {name}: a loss is not finite: {losses}")
    check(all(r["metrics"] == r0["metrics"] for r in rs),
          f"tp {name}: the ranks disagree on the metrics")
    for r in rs:
        for s, launched in enumerate(r["launches"]):
            check(launched == r["int8_plan"],
                  f"tp {name} step {s}: int8 launches {launched} != the "
                  f"plans' {r['int8_plan']}")
        check(r["mm_launches"] == [r["mm_plan"]] * len(r["metrics"]),
              f"tp {name}: matmul_chunk launches {r['mm_launches']} != the "
              f"plans' {r['mm_plan']} per step")


def phase_tp_train():
    """The train path tensor-parallel: qwen2.5-3b at full width, depth 2,
    seq 512, global batch 8, on the launcher's 8-rank mesh (pod 2, data
    2, model 2) sharing the card (gloo): zero3, fcdp, fcdp with the int8
    TP activation all-reduce, fcdp with int8 qwZ/qgZ and act
    int8, and fcdp with the gather-fused matmul."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import train_mesh_shape
    from repro_torch.launch.train import ModeRun, spawn

    cfg = dataclasses.replace(get_config("qwen2.5-3b"),
                              num_layers=TRAIN_DEPTH)
    mesh = train_mesh_shape(8, True)
    check(mesh.shape == {"pod": 2, "data": 2, "model": 2},
          f"the launcher's 8-rank mesh is {mesh.shape}")
    runs = [ModeRun("zero3"), ModeRun("fcdp"),
            ModeRun("fcdp", act_psum="int8"),
            ModeRun("fcdp", "int8_pod", "int8_pod", act_psum="int8"),
            ModeRun("fcdp", fused_matmul="ag_matmul")]
    job = _train_job(cfg, TRAIN_SEQ, TRAIN_BATCH, runs,
                     mesh=mesh.axis_sizes)
    t0 = time.perf_counter()
    ranks = spawn(job, timeout_s=900)
    wall = time.perf_counter() - t0
    check(all(rk["backend"] == "gloo" for rk in ranks),
          "8 ranks on one card must talk through gloo")
    by = {_tp_key(r["run"]): [rk["runs"][i] for rk in ranks]
          for i, r in enumerate(ranks[0]["runs"])}
    summary = {}
    for name, rs in by.items():
        _tp_checks(name, rs)
        r0 = rs[0]
        summary[name] = {
            "loss": [m["loss"] for m in r0["metrics"]],
            "grad_norm": [m["grad_norm"] for m in r0["metrics"]],
            "bytes_per_step": r0["bytes"][0],
            "int8_launches_per_rank_step": r0["launches"][0],
            "int8_plan": r0["int8_plan"],
            "int8_act_allreduce_plan": r0["act_int8_plan"],
            "matmul_chunk_launches_per_rank_step": r0["mm_launches"][0],
            "cache_places": r0["cache_places"][0],
            "peak_mem_gib": [r["peak_mem_bytes"] / 2**30 for r in rs],
            "step_s": [r["step_s"] for r in rs]}
    z3, fc, a8, q8, ag = (summary[k] for k in (
        "zero3", "fcdp", "fcdp_act_int8", "fcdp_int8_pod_act_int8",
        "fcdp_ag_matmul"))
    for name, m in (("fcdp", fc), ("fcdp_ag_matmul", ag)):
        check(_rel(m["loss"][0], z3["loss"][0]) <= LOSS_RTOL
              and _rel(m["grad_norm"][0], z3["grad_norm"][0]) <= GNORM_RTOL,
              f"tp {name} step 0 ({m['loss'][0]}, {m['grad_norm'][0]}) != "
              f"zero3's ({z3['loss'][0]}, {z3['grad_norm'][0]})")
    for name, m in (("act int8", a8), ("int8_pod + act int8", q8)):
        check(_rel(m["loss"][0], fc["loss"][0]) <= ACT_DRIFT,
              f"tp {name} step-0 loss {m['loss'][0]} drifts from fcdp "
              f"{fc['loss'][0]}")
        check(all(v > 0 for v in m["int8_launches_per_rank_step"].values()),
              f"tp {name}: an int8 kernel launched no time")
    check(fc["bytes_per_step"]["all_gather/pod"]
          < z3["bytes_per_step"]["all_gather/pod"],
          f"tp pod all-gather: fcdp {fc['bytes_per_step']} zero3 "
          f"{z3['bytes_per_step']}")
    check(fc["cache_places"] == {"host": [("cpu", True)]},
          f"tp fcdp caches must lie in pinned host memory: "
          f"{fc['cache_places']}")
    check(ag["matmul_chunk_launches_per_rank_step"] > 0,
          "tp ag_matmul launched no chunk matmul")
    # the int8 all-reduce's all-to-all + all-gather against the bf16
    # psum of the same activations (4 a layer, [2, 512, 2048] bf16)
    act = TRAIN_BATCH // 4 * TRAIN_SEQ * cfg.d_model * 2
    n_ar = 4 * TRAIN_DEPTH
    b8 = a8["bytes_per_step"]
    int8_share = (b8["all_to_all/model"] + b8["all_gather/model"]) / (
        n_ar * act)
    check(0.45 < int8_share < 0.55,
          f"tp act int8 moves {int8_share} of the bf16 psum's bytes")
    launches = {k: sum(sum(step[k] for step in r["launches"])
                       for rs in by.values() for r in rs)
                for k in QUANT_NAMES}
    launches["matmul_chunk"] = sum(sum(r["mm_launches"])
                                   for rs in by.values() for r in rs)
    emit("tp_train", model=cfg.name, layers_cut_to=TRAIN_DEPTH,
         seq=TRAIN_SEQ, global_batch=TRAIN_BATCH, mesh=mesh.shape,
         backend=ranks[0]["backend"], wall_s=wall,
         act_int8_bytes_vs_bf16_psum=int8_share,
         pod_all_gather_fcdp_vs_zero3=(
             fc["bytes_per_step"]["all_gather/pod"]
             / z3["bytes_per_step"]["all_gather/pod"]),
         kernel_launches_total=launches, modes=summary)
    return launches


def tp2_parity_jobs():
    """The runs of the three 8-rank parity phases (tp_parity,
    sched_parity, stream_parity; the last on its 3-layer model) on one
    job a device, the card's and the CPU's side by side, which spares
    two spawns on each: {phase: {device: (rank 0's records of its runs,
    the shared job's wall seconds)}}."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch.train import ModeRun

    stream = ModelConfig(**STREAM_PARITY_MODEL)
    groups = {
        "tp": [ModeRun("fcdp", act_psum="int8", dtype="float32"),
               ModeRun("fcdp", fused_matmul="ag_matmul", dtype="float32")],
        "sched": [ModeRun("fcdp", prefetch_depth=1, dtype="float32"),
                  ModeRun("hier", dtype="float32")],
        "stream": [ModeRun("fcdp", dtype="float32", microbatch=STREAM_MB,
                           steps=2, async_grad_reduce=True, model=stream),
                   ModeRun("fcdp", dtype="float32", microbatch=STREAM_MB,
                           steps=2, async_grad_reduce=True,
                           cross_step_pipeline=True, model=stream)]}
    runs = [r for g in groups.values() for r in g]
    out = spawn_card_and_cpu(
        lambda dev: _train_job(ModelConfig(**TP_PARITY_MODEL), 64, 8, runs,
                               dtype="float32", mesh=(2, 2, 2), device=dev,
                               draw_device="cpu"))
    split, i = {}, 0
    for name, g in groups.items():
        split[name] = {dev: (rs[i:i + len(g)], wall)
                       for dev, (rs, wall) in out.items()}
        i += len(g)
    return split


def phase_tp_parity(out):
    """tests/test_torch_tp.py's DENSE model at (2, 2, 2), fp32: fcdp with the
    int8 TP activation all-reduce and fcdp with the gather-fused
    matmul, the same 8-rank steps on the card (kernels) and on the CPU
    (plain versions) from the same weights (drawn on the CPU). ``out``:
    this phase's share of ``tp2_parity_jobs``."""
    (gs, t_g), (cs, t_c) = out["cuda"], out["cpu"]
    report = {}
    for name, g, c in zip(("act_int8", "ag_matmul"), gs, cs):
        mg, mc = g["metrics"][0], c["metrics"][0]
        check(_rel(mg["loss"], mc["loss"]) <= LOSS_RTOL,
              f"tp {name}: card loss {mg['loss']} != CPU {mc['loss']}")
        check(_rel(mg["grad_norm"], mc["grad_norm"]) <= GNORM_RTOL,
              f"tp {name}: card grad norm {mg['grad_norm']} != CPU "
              f"{mc['grad_norm']}")
        check(g["bytes"] == c["bytes"],
              f"tp {name}: card and CPU moved different bytes")
        check(g["launches"][0] == g["int8_plan"]
              and not any(c["launches"][0].values())
              and c["calls"][0] == c["int8_plan"],
              f"tp {name}: int8 launches: card must launch the plans' "
              "count, the CPU none")
        check(g["mm_launches"][0] == g["mm_plan"] and c["mm_launches"][0] == 0
              and c["mm_calls"][0] == c["mm_plan"],
              f"tp {name}: matmul_chunk launches: card {g['mm_launches']} "
              f"must be the plans' {g['mm_plan']}, the CPU none")
        report[name] = {"loss": {"cuda": mg["loss"], "cpu": mc["loss"]},
                        "grad_norm": {"cuda": mg["grad_norm"],
                                      "cpu": mc["grad_norm"]},
                        "int8_launches_cuda": g["launches"][0],
                        "matmul_chunk_launches_cuda": g["mm_launches"][0],
                        "bytes": g["bytes"][0]}
    check(all(v > 0 for v in report["act_int8"]["int8_launches_cuda"]
              .values()), "the tp parity run launched an int8 kernel no time")
    check(report["ag_matmul"]["matmul_chunk_launches_cuda"] > 0,
          "the tp parity run launched no chunk matmul")
    emit("tp_parity", model=TP_PARITY_MODEL["name"], dtype="float32",
         mesh={"pod": 2, "data": 2, "model": 2}, runs=report,
         wall_s={"cuda": t_g, "cpu": t_c})


# -- phases 15 and 16: the stage-1 prefetch ring and hier --------------------------

# zero3_d0 runs first and takes 2 steps: its step 0 pays the job's
# they ride on phase train's spawn (warm: its zero3 arm took the
# cuBLAS and allocator warm-up); fcdp at depth 0 is phase train's fcdp
# arm, the same run on the same ranks, read there
SCHED_RUNS = (("zero3_d0", dict(mode="zero3")),
              ("zero3_d1", dict(mode="zero3", prefetch_depth=1)),
              ("fcdp_d1", dict(mode="fcdp", prefetch_depth=1)),
              ("fcdp_d2", dict(mode="fcdp", prefetch_depth=2)),
              ("fcdp_d1_int8", dict(mode="fcdp", param_compress="int8_pod",
                                    grad_compress="int8_pod",
                                    prefetch_depth=1)),
              ("fcdp_d1_ag_matmul", dict(mode="fcdp", prefetch_depth=1,
                                         fused_matmul="ag_matmul")),
              ("mics_d1", dict(mode="mics", prefetch_depth=1)),
              ("hier", dict(mode="hier")))


def _sched_checks(name, rs, depth):
    """Finite losses the ranks agree on, the plans' int8 and chunk-matmul
    launches on every rank, the ring's live depth (``depth``) and its
    bytes equal to ``prefetch_buffer_bytes``."""
    _tp_checks(name, rs)
    for r in rs:
        steps = len(r["metrics"])
        check(r["live_depth"] == [depth] * steps,
              f"sched {name}: live depth {r['live_depth']} != {depth}")
        check(r["ring_bytes"] == [r["prefetch_buffer_bytes"]] * steps,
              f"sched {name}: ring bytes {r['ring_bytes']} != "
              f"prefetch_buffer_bytes {r['prefetch_buffer_bytes']}")


def sched_runs():
    """Phase sched_train's runs, in ``SCHED_RUNS`` order, riding on phase
    train's spawn."""
    from repro_torch.launch.train import ModeRun
    return [ModeRun(**kw) for _, kw in SCHED_RUNS]


def phase_sched_train(train_fcdp_bytes, results, fcdp):
    """The stage-1 prefetch ring and hier on the train path: qwen2.5-3b
    at full width, depth 2, seq 512, global batch 8, on phase train's 4
    ranks (pod 2, data 2) sharing the card, a step of each of
    ``SCHED_RUNS`` (``results``: every rank's record of each, from phase
    train's spawn) and of fcdp at depth 0 (``fcdp``: phase train's
    arm)."""
    from repro_torch.configs.registry import get_config

    cfg = dataclasses.replace(get_config("qwen2.5-3b"),
                              num_layers=TRAIN_DEPTH)
    by = {name: rs for (name, _), rs in zip(SCHED_RUNS, results)}
    kws = dict(SCHED_RUNS, fcdp_d0=dict(mode="fcdp"))
    summary = {}
    for name, kw in kws.items():
        rs = by[name] if name != "fcdp_d0" else fcdp
        streams = kw["mode"] not in ("mics", "hier")
        _sched_checks(name, rs, min(kw.get("prefetch_depth", 0),
                                    TRAIN_DEPTH) if streams else 0)
        r0 = rs[0]
        summary[name] = {
            "loss": r0["metrics"][0]["loss"],
            "grad_norm": r0["metrics"][0]["grad_norm"],
            "bytes_per_step": r0["bytes"][0],
            "live_depth": r0["live_depth"][0],
            "ring_bytes": r0["ring_bytes"][0],
            "prefetch_buffer_bytes": r0["prefetch_buffer_bytes"],
            "widened_leaves": len(r0["widened"]),
            "int8_launches_per_rank_step": r0["launches"][0],
            "matmul_chunk_launches_per_rank_step": r0["mm_launches"][0],
            "cached_bytes": r0["cached"][0],
            "cache_places": r0["cache_places"][0],
            "peak_mem_gib": [r["peak_mem_bytes"] / 2**30 for r in rs],
            "step_s": [r["step_s"] for r in rs]}
    b = {k: m["bytes_per_step"] for k, m in summary.items()}
    check(b["zero3_d1"]["all_gather/pod"] == b["fcdp_d1"]["all_gather/pod"]
          < b["zero3_d0"]["all_gather/pod"],
          f"zero3's pod all-gather at depth 1 "
          f"{b['zero3_d1']['all_gather/pod']} must equal fcdp's "
          f"{b['fcdp_d1']['all_gather/pod']}, below depth 0's "
          f"{b['zero3_d0']['all_gather/pod']}")
    for k in ("fcdp_d0", "fcdp_d1", "fcdp_d2"):
        check(b[k] == train_fcdp_bytes,
              f"{k} bytes {b[k]} != phase train's fcdp (depth 0) "
              f"{train_fcdp_bytes}")
    h = b["hier"]
    check(h["psum/pod"] == b["zero3_d0"]["psum/pod"]
          and h["psum_scatter/pod"] == h["all_gather/pod"] > 0,
          f"hier pod bytes {h}: its psum must be zero3's "
          f"{b['zero3_d0']['psum/pod']} (the loss terms and replicated "
          "leaves), its reduce-scatter its gather back")
    check(summary["hier"]["widened_leaves"] > 0, "hier widened no leaf")
    z3 = summary["zero3_d0"]
    for k in ("zero3_d1", "fcdp_d0", "fcdp_d1", "fcdp_d2", "hier"):
        m = summary[k]
        check(_rel(m["loss"], z3["loss"]) <= LOSS_RTOL
              and _rel(m["grad_norm"], z3["grad_norm"]) <= GNORM_RTOL,
              f"sched {k} step 0 ({m['loss']}, {m['grad_norm']}) != "
              f"zero3's ({z3['loss']}, {z3['grad_norm']})")
    check(_rel(summary["fcdp_d1_int8"]["loss"], z3["loss"]) <= INT8_DRIFT,
          "sched int8 step-0 loss drifts from zero3's")
    check(all(v > 0 for v in summary["fcdp_d1_int8"][
        "int8_launches_per_rank_step"].values()),
          "sched int8: an int8 kernel launched no time")
    check(summary["fcdp_d1_ag_matmul"]["matmul_chunk_launches_per_rank_step"]
          > 0, "sched ag_matmul launched no chunk matmul")
    check(summary["fcdp_d1"]["cache_places"] == {"host": [("cpu", True)]}
          and summary["zero3_d1"]["cache_places"].get("device"),
          "ring-fed caches: fcdp's must lie in pinned host memory, "
          "zero3's on the device")
    launches = {k: sum(sum(step[k] for step in r["launches"])
                       for rs in by.values() for r in rs)
                for k in QUANT_NAMES}
    launches["matmul_chunk"] = sum(sum(r["mm_launches"])
                                   for rs in by.values() for r in rs)
    emit("sched_train", model=cfg.name, layers_cut_to=TRAIN_DEPTH,
         seq=TRAIN_SEQ, global_batch=TRAIN_BATCH,
         mesh={"pod": 2, "data": 2, "model": 1},
         spawn_shared_with="train", fcdp_d0_from="train",
         kernel_launches_total=launches, runs=summary)
    return launches


def phase_sched_parity(out):
    """tests/test_torch_sched.py's DENSE model at (2, 2, 2), fp32: fcdp at
    prefetch depth 1 and hier, the same 8-rank steps on the card and on
    the CPU from the same weights (drawn on the CPU): loss within
    tolerance, the same bytes. ``out``: this phase's share of
    ``tp2_parity_jobs``."""
    (gs, t_g), (cs, t_c) = out["cuda"], out["cpu"]
    report = {}
    for name, g, c in zip(("fcdp_d1", "hier"), gs, cs):
        mg, mc = g["metrics"][0], c["metrics"][0]
        check(_rel(mg["loss"], mc["loss"]) <= LOSS_RTOL,
              f"sched {name}: card loss {mg['loss']} != CPU {mc['loss']}")
        check(_rel(mg["grad_norm"], mc["grad_norm"]) <= GNORM_RTOL,
              f"sched {name}: card grad norm {mg['grad_norm']} != CPU "
              f"{mc['grad_norm']}")
        check(g["bytes"] == c["bytes"],
              f"sched {name}: card and CPU moved different bytes")
        check(g["live_depth"] == c["live_depth"]
              and g["ring_bytes"] == c["ring_bytes"],
              f"sched {name}: card and CPU rings differ")
        report[name] = {"loss": {"cuda": mg["loss"], "cpu": mc["loss"]},
                        "grad_norm": {"cuda": mg["grad_norm"],
                                      "cpu": mc["grad_norm"]},
                        "live_depth": g["live_depth"][0],
                        "ring_bytes": g["ring_bytes"][0],
                        "bytes": g["bytes"][0]}
    emit("sched_parity", model=TP_PARITY_MODEL["name"], dtype="float32",
         mesh={"pod": 2, "data": 2, "model": 2}, runs=report,
         wall_s={"cuda": t_g, "cpu": t_c})


# -- phases 17 and 18: the scheduler's streams 2 and 3 ----------------------------

STREAM_MB = 2              # microbatches a step: the streams need >= 2
# (name, ModeRun keywords): fcdp sequential, then fcdp async and
# cross-step over the same 2 batches (a prime, a piped call, a flush),
# one async step of each other arm, and the composite's cross-step over 2
# batches. A call takes ~20 s at microbatch 2 on the H100 (3 batches
# each and a mics sequential step took 359.5 s), so the arms are cut to
# fit the smoke's time limit. mics, which declines the flag (a host-side
# gate), is held to its sequential step on the CPU by
# tests/test_torch_streams.py and has no arm here
STREAM_RUNS = (
    ("fcdp_seq", dict(mode="fcdp")),
    ("fcdp_async", dict(mode="fcdp", steps=2, async_grad_reduce=True)),
    ("fcdp_xstep", dict(mode="fcdp", steps=2, async_grad_reduce=True,
                        cross_step_pipeline=True)),
    ("zero3_async", dict(mode="zero3", async_grad_reduce=True)),
    ("fcdp_async_int8", dict(mode="fcdp", param_compress="int8_pod",
                             grad_compress="int8_pod",
                             async_grad_reduce=True)),
    ("fcdp_async_ag_matmul", dict(mode="fcdp", fused_matmul="ag_matmul",
                                  async_grad_reduce=True)),
    ("embed_hier_xstep", dict(mode="fcdp", steps=2, async_grad_reduce=True,
                              cross_step_pipeline=True,
                              mode_overrides=(("embed", "hier"),))))
STREAM_PARITY_MODEL = dict(name="t-dense", family="dense", num_layers=3,
                           d_model=64, num_heads=4, num_kv_heads=2,
                           d_ff=128, vocab_size=256, qkv_bias=True)


def _view_bytes(mem):
    """What the stage-1 views hold on the device: the bytes allocated
    once they are built, less those at the step's previous mark."""
    parts = list(mem)
    if "view" not in parts:
        return None
    return mem["view"][1] - mem[parts[parts.index("view") - 1]][1]


def _stream_summary(rs):
    r0 = rs[0]
    return {"kinds": r0["kinds"],
            "loss": [m.get("loss") for m in r0["metrics"]],
            "grad_norm": [m["grad_norm"] for m in r0["metrics"]],
            "bytes_per_call": r0["bytes"],
            "async_live": r0["async_live"],
            "cross_step_live": r0["cross_step_live"],
            "async_buffer_bytes": r0["async_buffer_bytes"],
            "cross_step_buffer_bytes": r0["cross_step_buffer_bytes"],
            "carry_bytes": r0["carry_bytes"],
            "int8_launches_per_rank_call": r0["launches"],
            "int8_plan": r0["int8_plan"],
            "matmul_chunk_launches_per_rank_call": r0["mm_launches"],
            "matmul_chunk_plan": r0["mm_plan"],
            "live_depth": r0["live_depth"],
            "cached_bytes": r0["cached"][0],
            "cache_places": r0["cache_places"][0],
            "widened_leaves": len(r0["widened"]),
            "peak_mem_gib": [r["peak_mem_bytes"] / 2**30 for r in rs],
            # per call and part of it (TrainStep._mark), the largest over
            # the ranks: the part's peak and what stays allocated at its
            # end; and each rank's view bytes in its first call
            "view_bytes": [_view_bytes(r["memory"][0]) for r in rs],
            "memory_gib": [
                {part: {k: max(r["memory"][c][part][i] for r in rs) / 2**30
                        for i, k in enumerate(("peak", "live"))}
                 for part in r0["memory"][c]}
                for c in range(len(r0["kinds"]))],
            "step_s": [r["step_s"] for r in rs]}


def _xstep_checks(name, xs, carry_bytes):
    """A cross-step run: prime, piped calls and a flush; the carry's
    bytes equal ``cross_step_buffer_bytes`` after every call but the
    flush."""
    for r in xs:
        n = len(r["kinds"]) - 1
        check(r["cross_step_live"] and r["kinds"]
              == ["prime"] + ["piped"] * (n - 1) + ["flush"],
              f"stream {name}: calls {r['kinds']}")
        check(r["carry_bytes"] == [carry_bytes] * n + [0]
              and carry_bytes == r["cross_step_buffer_bytes"] > 0,
              f"stream {name}: carry bytes {r['carry_bytes']} != "
              f"cross_step_buffer_bytes {r['cross_step_buffer_bytes']}")
        check(r["metrics"][0]["grad_norm"] == 0.0
              and r["metrics"][0]["primed"],
              f"stream {name}: the prime reports a grad norm")


def phase_stream_train(extra=(), task=None):
    """The scheduler's streams 2 and 3 on the train path: qwen2.5-3b at
    full width, depth 2, seq 512, global batch 8, on phase train's 4
    ranks (pod 2, data 2) sharing the card, microbatch 2:
    ``STREAM_RUNS``. The ``extra`` runs (the arms of phases
    family_train, arch_train and encdec_train, each with its own model,
    and phase cache_train's) and the job's
    ``task`` (cache_train's) ride on the same ranks after them, which
    spares spawns; returns (the launches, every rank's record of each
    extra run, every rank's result, the spawn's wall seconds)."""
    import math
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import ModeRun, spawn

    cfg = dataclasses.replace(get_config("qwen2.5-3b"),
                              num_layers=TRAIN_DEPTH)
    job = _train_job(cfg, TRAIN_SEQ, TRAIN_BATCH,
                     [ModeRun(microbatch=STREAM_MB, **kw)
                      for _, kw in STREAM_RUNS] + list(extra), task=task)
    t0 = time.perf_counter()
    ranks = spawn(job, timeout_s=900)
    wall = time.perf_counter() - t0
    by = {name: [rk["runs"][i] for rk in ranks]
          for i, (name, _) in enumerate(STREAM_RUNS)}
    summary = {}
    for name, kw in STREAM_RUNS:
        rs = by[name]
        r0 = rs[0]
        check(all(math.isfinite(m.get("loss", 0.0))
                  and math.isfinite(m["grad_norm"]) for m in r0["metrics"]),
              f"stream {name}: a metric is not finite: {r0['metrics']}")
        check(all(r["metrics"] == r0["metrics"] for r in rs),
              f"stream {name}: the ranks disagree on the metrics")
        for r in rs:
            if not r["cross_step_live"]:
                check(all(c == r["int8_plan"] for c in r["launches"]),
                      f"stream {name}: int8 launches {r['launches']} != "
                      f"the plans' {r['int8_plan']}")
                check(r["mm_launches"] == [r["mm_plan"]] * len(r["kinds"]),
                      f"stream {name}: matmul_chunk launches "
                      f"{r['mm_launches']} != the plans' {r['mm_plan']}")
            check(r["live_depth"] == [0] * len(r["kinds"]),
                  f"stream {name}: live depth {r['live_depth']}")
        check(r0["async_live"] == kw.get("async_grad_reduce", False)
              and r0["cross_step_live"] == kw.get("cross_step_pipeline",
                                                  False),
              f"stream {name}: live async {r0['async_live']}, cross-step "
              f"{r0['cross_step_live']}")
        summary[name] = _stream_summary(rs)
    seq, asy, xs = (by[k] for k in ("fcdp_seq", "fcdp_async", "fcdp_xstep"))
    b = {k: m["bytes_per_call"] for k, m in summary.items()}
    check(all(x == b["fcdp_seq"][0] for x in b["fcdp_async"]),
          f"fcdp async bytes {b['fcdp_async']} != sequential "
          f"{b['fcdp_seq']}")
    check(b["zero3_async"][0]["all_gather/pod"]
          == b["fcdp_async"][0]["all_gather/pod"],
          f"zero3 async pod all-gather {b['zero3_async'][0]} != fcdp's "
          f"{b['fcdp_async'][0]}")
    m_s, m_a, m_x = (r[0]["metrics"] for r in (seq, asy, xs))
    for s, (ms, ma) in enumerate(zip(m_s, m_a)):
        check(_rel(ma["loss"], ms["loss"]) <= LOSS_RTOL
              and _rel(ma["grad_norm"], ms["grad_norm"]) <= GNORM_RTOL,
              f"fcdp async step {s} ({ma['loss']}, {ma['grad_norm']}) != "
              f"sequential ({ms['loss']}, {ms['grad_norm']})")
    for k in ("zero3_async", "fcdp_async_ag_matmul"):
        m = by[k][0]["metrics"][0]
        check(_rel(m["loss"], m_a[0]["loss"]) <= LOSS_RTOL
              and _rel(m["grad_norm"], m_a[0]["grad_norm"]) <= GNORM_RTOL,
              f"stream {k} step 0 ({m['loss']}, {m['grad_norm']}) != fcdp "
              f"async's ({m_a[0]['loss']}, {m_a[0]['grad_norm']})")
    q8 = by["fcdp_async_int8"][0]
    check(_rel(q8["metrics"][0]["loss"], m_a[0]["loss"]) <= INT8_DRIFT,
          "stream int8 step-0 loss drifts from fcdp async's")
    check(all(v > 0 for v in q8["launches"][0].values()),
          "stream int8: an int8 kernel launched no time")
    check(by["fcdp_async_ag_matmul"][0]["mm_launches"][0] > 0,
          "stream ag_matmul launched no chunk matmul")
    # stream 3 against the fused async step: the same bits and bytes
    check([m["loss"] for m in m_x[:-1]] == [m["loss"] for m in m_a]
          and [m["grad_norm"] for m in m_x[1:]]
          == [m["grad_norm"] for m in m_a],
          f"cross-step metrics {m_x} != fcdp async's {m_a}")
    check([r["final_digest"] for r in xs] == [r["final_digest"] for r in asy],
          "cross-step final shards differ from fcdp async's")
    check(all(x == b["fcdp_async"][1] for x in b["fcdp_xstep"][1:-1]),
          f"piped bytes {b['fcdp_xstep'][1:-1]} != a fused async step's "
          f"{b['fcdp_async'][1]}")
    _xstep_checks("fcdp_xstep", xs, summary["fcdp_async"][
        "cross_step_buffer_bytes"])
    _xstep_checks("embed_hier_xstep", by["embed_hier_xstep"],
                  summary["embed_hier_xstep"]["cross_step_buffer_bytes"])
    check(summary["embed_hier_xstep"]["widened_leaves"] > 0,
          "the composite widened no leaf")
    launches = {k: sum(sum(step[k] for step in r["launches"])
                       for rs in by.values() for r in rs)
                for k in QUANT_NAMES}
    launches["matmul_chunk"] = sum(sum(r["mm_launches"])
                                   for rs in by.values() for r in rs)
    emit("stream_train", model=cfg.name, layers_cut_to=TRAIN_DEPTH,
         seq=TRAIN_SEQ, global_batch=TRAIN_BATCH, microbatch=STREAM_MB,
         mesh=job.mesh.shape, backend=ranks[0]["backend"], wall_s=wall,
         spawn_shared_with=["family_train", "arch_train", "encdec_train",
                            "cache_train"],
         kernel_launches_total=launches, runs=summary)
    n = len(STREAM_RUNS)
    return (launches, [[rk["runs"][n + j] for rk in ranks]
                       for j in range(len(extra))], ranks, wall)


def phase_stream_parity(out):
    """tests/test_torch_streams.py's DENSE model at (2, 2, 2), fp32,
    microbatch 2: fcdp async (2 steps) and fcdp cross-step (2 batches),
    the same 8-rank calls on the card and on the CPU from the same
    weights (drawn on the CPU): losses and grad norms within tolerance,
    the same bytes and carry. ``out``: this phase's share of
    ``tp2_parity_jobs``."""
    (gs, t_g), (cs, t_c) = out["cuda"], out["cpu"]
    report = {}
    for name, g, c in zip(("fcdp_async", "fcdp_xstep"), gs, cs):
        check(g["kinds"] == c["kinds"] and g["async_live"],
              f"stream {name}: card calls {g['kinds']}, CPU {c['kinds']}")
        for mg, mc in zip(g["metrics"], c["metrics"]):
            for k in ("loss", "grad_norm"):
                if k in mg:
                    tol = LOSS_RTOL if k == "loss" else GNORM_RTOL
                    check(mg[k] == mc[k] or _rel(mg[k], mc[k]) <= tol,
                          f"stream {name}: card {k} {mg[k]} != CPU {mc[k]}")
        check(g["bytes"] == c["bytes"] and g["carry_bytes"]
              == c["carry_bytes"],
              f"stream {name}: card and CPU moved or carried different "
              "bytes")
        report[name] = {"kinds": g["kinds"],
                        "loss": {"cuda": [m.get("loss")
                                          for m in g["metrics"]],
                                 "cpu": [m.get("loss")
                                         for m in c["metrics"]]},
                        "grad_norm": {"cuda": [m["grad_norm"]
                                               for m in g["metrics"]],
                                      "cpu": [m["grad_norm"]
                                              for m in c["metrics"]]},
                        "carry_bytes": g["carry_bytes"],
                        "bytes": g["bytes"][0]}
    emit("stream_parity", model=STREAM_PARITY_MODEL["name"],
         dtype="float32", microbatch=STREAM_MB,
         mesh={"pod": 2, "data": 2, "model": 2}, runs=report,
         wall_s={"cuda": t_g, "cpu": t_c})


CACHE_FRACTIONS = (0.0, 0.5, 1.0)
# (name, ModeRun keywords): the arms the planner's walk does not cover:
# the middle fraction (the walk's trial steps give 1.0 and 0.0),
# save_collectives, and qwZ/qgZ + ag_matmul under block_io
CACHE_RUNS = (
    ("fcdp_f0.5", dict(mode="fcdp", device_cache_fraction=0.5)),
    ("fcdp_save_collectives", dict(mode="fcdp",
                                   activation_policy="save_collectives")),
    ("fcdp_q8_ag_block_io", dict(mode="fcdp", param_compress="int8_pod",
                                 grad_compress="int8_pod",
                                 fused_matmul="ag_matmul",
                                 activation_policy="block_io")))
# the planner's walk: fcdp at prefetch depth 1 over fractions (1.0, 0.0)
CACHE_WALK = dict(prefetch_depth=1, fractions=(1.0, 0.0))


def _attempt_key(it):
    """A planner attempt's configuration (a serve attempt has no
    cross-step carry)."""
    return (it["device_fraction"], it["prefetch_depth"],
            it.get("cross_step", False), it["activation_policy"])


def _cache_task(job, mesh, coll, device, state=None):
    """On every rank of phase cache_train: the planner's walk at an
    impossible budget, each attempt one trial step; then a plan at a
    budget halfway between the walk's two lowest distinct peaks, which
    takes the walk's peaks for the attempts over that budget and
    measures the first under it again. Returns both plans, what each
    trial step measured on this rank (``MemoryPlanner.trials``) and the
    budget."""
    from repro_torch.core.cache import MemoryPlanner

    run = dataclasses.replace(job.run, system=dataclasses.replace(
        job.run.system, mode="fcdp",
        prefetch_depth=CACHE_WALK["prefetch_depth"]))
    out = {}
    walk = MemoryPlanner(hbm_budget=1, coll=coll, device=device,
                         seed=job.seed)
    out["walk"] = dataclasses.asdict(walk.plan(run, mesh,
                                               CACHE_WALK["fractions"]))
    out["walk_trials"] = walk.trials
    its = out["walk"]["iterations"]
    peaks = sorted({it["peak_bytes"] for it in its})
    budget = out["budget"] = (peaks[0] + peaks[1]) // 2 \
        if len(peaks) > 1 else peaks[0]
    over = {_attempt_key(it): it["peak_bytes"] for it in its
            if it["peak_bytes"] > budget}

    class Recorded(MemoryPlanner):
        def _peak(self, bundle):
            s = bundle.run.system
            key = (s.device_cache_fraction, s.prefetch_depth,
                   s.cross_step_pipeline, s.activation_policy)
            return over[key] if key in over else super()._peak(bundle)

    mid = Recorded(hbm_budget=budget, coll=coll, device=device,
                   seed=job.seed)
    out["mid"] = dataclasses.asdict(mid.plan(run, mesh,
                                             CACHE_WALK["fractions"]))
    out["mid_trials"] = mid.trials
    return out


def _gib_parts(memory):
    """A step's memory by part (``TrainStep.memory``) in GiB."""
    return {p: {k: v / 2**30 for k, v in zip(("peak", "live"), pv)}
            for p, pv in memory.items()}


def cache_runs():
    """Phase cache_train's runs (``CACHE_RUNS``), which ride on phase
    stream_train's spawn with ``_cache_task``."""
    from repro_torch.launch.train import ModeRun
    return [ModeRun(**kw) for _, kw in CACHE_RUNS]


def phase_cache_train(results, ranks, wall):
    """FCDP-Cache on the train path: qwen2.5-3b at full width, depth 2,
    seq 512, global batch 8, on phase train's 4 ranks: ``CACHE_RUNS``,
    then the planner's walk and mid-budget plan on every rank
    (``_cache_task``), the walk's trial steps giving fractions 1.0 and
    0.0 (the measured cache tiers against the analytic ones); then one
    ``plan_serve`` over the paged serve cell's pool on this process.
    The runs and the task ride on phase stream_train's spawn:
    ``results`` holds every rank's record of each run, ``ranks`` every
    rank's result (its task's), ``wall`` the spawn's seconds."""
    import math

    import torch
    from repro_torch.configs.base import RunConfig, ShapeCell, SystemConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core.cache import MemoryPlanner
    from repro_torch.core.engine import StepBundle
    from repro_torch.core.engine.serve import default_paged_kv
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import MeshShape

    cfg = dataclasses.replace(get_config("qwen2.5-3b"),
                              num_layers=TRAIN_DEPTH)
    by = {name: rs for (name, _), rs in zip(CACHE_RUNS, results)}
    arms = {}
    for name, kw in CACHE_RUNS:
        rs = by[name]
        r0 = rs[0]
        m = r0["metrics"][0]
        check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
              f"cache {name}: a metric is not finite: {m}")
        check(all(r["metrics"] == r0["metrics"] for r in rs),
              f"cache {name}: the ranks disagree on the metrics")
        for r in rs:
            check(r["launches"] == [r["int8_plan"]]
                  and r["mm_launches"] == [r["mm_plan"]],
                  f"cache {name}: launches {r['launches']} / "
                  f"{r['mm_launches']} != the plans' {r['int8_plan']} / "
                  f"{r['mm_plan']}")
        acct = r0["cache_accounting"]
        arms[name] = {
            "loss": m["loss"], "grad_norm": m["grad_norm"],
            "measured_cached": r0["cached"][0],
            "cache_places": r0["cache_places"][0],
            "analytic": {k: v for k, v in acct.items() if k != "by_group"},
            "analytic_by_group": acct["by_group"],
            "all_gather_pod": r0["bytes"][0].get("all_gather/pod", 0.0),
            "bytes_per_step": r0["bytes"][0],
            "int8_launches": r0["launches"][0], "int8_plan": r0["int8_plan"],
            "matmul_chunk_launches": r0["mm_launches"][0],
            "matmul_chunk_plan": r0["mm_plan"],
            "memory_gib": {part: {k: max(r["memory"][0][part][i]
                                         for r in rs) / 2**30
                                  for i, k in enumerate(("peak", "live"))}
                           for part in r0["memory"][0]},
            "peak_mem_gib": [r["peak_mem_bytes"] / 2**30 for r in rs],
            "step_s": [r["step_s"] for r in rs]}
        check(arms[name]["all_gather_pod"]
              == acct["stage1_dcn_gather_bytes_per_chip"],
              f"cache {name}: pod all-gather {arms[name]['all_gather_pod']} "
              f"!= stage1_dcn_gather_bytes "
              f"{acct['stage1_dcn_gather_bytes_per_chip']}")
    # the planner: every rank walks the same attempts
    tasks = [rk["task"] for rk in ranks]
    walk, mid = tasks[0]["walk"], tasks[0]["mid"]
    check(all(t["walk"] == walk and t["mid"] == mid for t in tasks),
          "the ranks' planners walked different attempts")
    k0 = CACHE_WALK["prefetch_depth"]
    fr = CACHE_WALK["fractions"]
    want_walk = ([(fr[0], d, False, "save_all") for d in range(k0, 0, -1)]
                 + [(f, 0, False, "save_all") for f in fr]
                 + [(0.0, 0, False, "block_io")])
    keys = [_attempt_key(it) for it in walk["iterations"]]
    check(not walk["fits"] and keys == want_walk,
          f"the walk's attempts {keys} != {want_walk}")
    check(all(it["peak_bytes"] > 0 for it in walk["iterations"]),
          "an attempt measured no peak")
    # each attempt's trial step: the ranks agree, the pod all-gather is
    # the analytic figure
    trials = []
    for i, it in enumerate(walk["iterations"]):
        ts = [t["walk_trials"][i] for t in tasks]
        m = ts[0]["metrics"]
        check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
              and all(t["metrics"] == m for t in ts),
              f"walk attempt {keys[i]}: metrics {[t['metrics'] for t in ts]}")
        check(ts[0]["bytes"].get("all_gather/pod", 0.0)
              == it["stage1_dcn_gather_bytes"],
              f"walk attempt {keys[i]}: pod all-gather {ts[0]['bytes']} != "
              f"stage1_dcn_gather_bytes {it['stage1_dcn_gather_bytes']}")
        trials.append(ts[0])
    # the fraction moves whole layers' caches from the host to the device
    # and nothing else: the same analytic figures, bytes and values
    by_frac = {1.0: trials[keys.index((1.0, 0, False, "save_all"))],
               0.0: trials[keys.index((0.0, 0, False, "save_all"))]}
    f05 = arms["fcdp_f0.5"]
    by_frac[0.5] = {"cached": f05["measured_cached"],
                    "bytes": f05["bytes_per_step"],
                    "metrics": {"loss": f05["loss"],
                                "grad_norm": f05["grad_norm"]}}
    f0 = by_frac[0.0]
    layer = f0["cached"]["host"] / TRAIN_DEPTH
    analytic = walk["iterations"][keys.index((0.0, 0, False, "save_all"))]
    for f in CACHE_FRACTIONS:
        a = by_frac[f]
        n_dev = int(round(f * TRAIN_DEPTH))
        want = {k: v for k, v in (("device", n_dev * layer),
                                  ("host", (TRAIN_DEPTH - n_dev) * layer))
                if v}
        check(a["cached"] == want,
              f"cache fraction {f}: measured tiers {a['cached']} != {want}")
        check(a["bytes"] == f0["bytes"],
              f"cache fraction {f}: the bytes moved: {a['bytes']} != "
              f"{f0['bytes']}")
        check(a["metrics"]["loss"] == f0["metrics"]["loss"]
              and a["metrics"]["grad_norm"] == f0["metrics"]["grad_norm"],
              f"cache fraction {f}: {a['metrics']} != fraction 0's "
              f"{f0['metrics']}")
    # (the depth-1 attempt adds its ring slot's bytes)
    check(all(it["host_bytes"] == analytic["host_bytes"]
              and (it["by_group"] == analytic["by_group"]
                   or it["prefetch_depth"])
              for it in walk["iterations"])
          and f05["analytic_by_group"] == analytic["by_group"],
          "cache: the analytic figures moved with the fraction or policy")
    base = f0["metrics"]
    blk = trials[keys.index((0.0, 0, False, "block_io"))]
    for name, m in (("block_io", blk["metrics"]),
                    ("save_collectives", arms["fcdp_save_collectives"])):
        check(_rel(m["loss"], base["loss"]) <= LOSS_RTOL
              and _rel(m["grad_norm"], base["grad_norm"]) <= GNORM_RTOL,
              f"{name} ({m['loss']}, {m['grad_norm']}) != save_all "
              f"({base['loss']}, {base['grad_norm']})")
    check(blk["bytes"] == f0["bytes"],
          f"block_io's bytes {blk['bytes']} != save_all's {f0['bytes']}")
    q8 = arms["fcdp_q8_ag_block_io"]
    check(_rel(q8["loss"], base["loss"]) <= INT8_DRIFT
          and all(v > 0 for v in q8["int8_launches"].values())
          and q8["matmul_chunk_launches"] > 0,
          f"qwZ/qgZ + ag_matmul block_io: loss {q8['loss']}, launches "
          f"{q8['int8_launches']} / {q8['matmul_chunk_launches']}")
    # the mid-budget plan: the walk's peaks over the budget, the first
    # attempt under it measured again, and fitting there
    budget = tasks[0]["budget"]
    first = next(i for i, it in enumerate(walk["iterations"])
                 if it["peak_bytes"] <= budget)
    check(mid["fits"] and len(mid["iterations"]) == first + 1
          and _attempt_key(mid["iterations"][-1]) == keys[first]
          and len(tasks[0]["mid_trials"]) == 1,
          f"the plan at budget {budget} fit at "
          f"{[_attempt_key(i) for i in mid['iterations']]} after "
          f"{len(tasks[0]['mid_trials'])} trial steps, expected the walk's "
          f"attempt {first} measured again")
    # the paged serve cell's pool, on this process, against the card's
    # memory
    total = torch.cuda.get_device_properties(0).total_memory
    flash0 = ops.flash_attention.launches
    t1 = time.perf_counter()
    cell = ShapeCell("serve", "decode", 512, 8)
    run = RunConfig(model=get_config("qwen2.5-3b"), shape=cell,
                    system=SystemConfig())
    kv = default_paged_kv(StepBundle(run, device="cuda"), cell)
    serve_plan = dataclasses.asdict(MemoryPlanner(device="cuda").plan_serve(
        run, MeshShape(("data", "model"), (1, 1)), kv))
    serve_s = time.perf_counter() - t1
    check(serve_plan["fits"] and serve_plan["kv_pages"]
          == kv.pages_per_replica,
          f"the paged serve cell does not fit the card: {serve_plan}")
    launches = {k: sum(r["launches"][0][k] for rs in by.values() for r in rs)
                for k in QUANT_NAMES}
    launches["matmul_chunk"] = sum(r["mm_launches"][0]
                                   for rs in by.values() for r in rs)
    launches["flash_attention"] = ops.flash_attention.launches - flash0

    def gib(it):
        return {"attempt": list(_attempt_key(it)),
                "peak_bytes": it["peak_bytes"],
                "peak_gib": it["peak_bytes"] / 2**30,
                "host_bytes": it["host_bytes"],
                "prefetch_buffer_bytes": it["prefetch_buffer_bytes"],
                "stage1_dcn_gather_bytes": it.get("stage1_dcn_gather_bytes")}
    emit("cache_train", model=cfg.name, layers_cut_to=TRAIN_DEPTH,
         seq=TRAIN_SEQ, global_batch=TRAIN_BATCH,
         mesh={"pod": 2, "data": 2, "model": 1},
         backend=ranks[0]["backend"], spawn_shared_with="stream_train",
         wall_s=wall, hbm_per_chip=total,
         arms=arms,
         walk=[dict(gib(it), measured_cached=t["cached"],
                    loss=t["metrics"]["loss"],
                    grad_norm=t["metrics"]["grad_norm"],
                    all_gather_pod=t["bytes"].get("all_gather/pod", 0.0),
                    memory_gib=_gib_parts(t["memory"]))
               for it, t in zip(walk["iterations"], trials)],
         budget=budget, budget_gib=budget / 2**30,
         mid=[gib(it) for it in mid["iterations"]], mid_fits=mid["fits"],
         mid_memory_gib=_gib_parts(tasks[0]["mid_trials"][0]["memory"]),
         mid_peak_minus_walk=(mid["iterations"][-1]["peak_bytes"]
                              - walk["iterations"][first]["peak_bytes"]),
         serve_plan={"fits": serve_plan["fits"],
                     "kv_pages": serve_plan["kv_pages"],
                     "attempts": [dict(gib(it), kv_pages=it["kv_pages"],
                                       kv_page_bytes=it["kv_page_bytes"])
                                  for it in serve_plan["iterations"]]},
         serve_plan_s=serve_s, kernel_launches_total=launches)
    return launches


# -- phase 21: training of the moe, ssm and hybrid families ------------------

FAMILY_DEPTH = 2
# jamba's 16 experts cut to 4: at 16 the cut holds ~3.68 B parameters,
# more than the card holds for 4 ranks (PERF.md section 4)
FAMILY_EXPERTS = 4
# the reference's headline composite: experts on mics, embedding on hier
MIXED_RULES = (("blocks.*.moe.we_*", "mics"), ("embed", "hier"))
FAMILY_RUNS = {
    "rwkv6-3b": (("zero3", dict(mode="zero3")),
                 ("fcdp", dict(mode="fcdp"))),
    "jamba-v0.1-52b": (
        ("zero3", dict(mode="zero3")),
        ("fcdp_q8_ag", dict(mode="fcdp", param_compress="int8_pod",
                            grad_compress="int8_pod",
                            fused_matmul="ag_matmul")),
        ("mixed", dict(mode="fcdp", mode_overrides=MIXED_RULES)))}
# the scan's gradient on the card against autograd of its plain version
SCAN_GRAD_SHAPE = (2, 64, 512)
# tests/test_system.py's t-jamba and t-rwkv
FAMILY_PARITY_MODELS = {
    "t-jamba": dict(name="t-jamba", family="hybrid", num_layers=4,
                    d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                    vocab_size=256, mamba=dict(d_state=8, dt_rank=8),
                    moe=dict(num_experts=4, top_k=2, d_ff_expert=128,
                             moe_period=2, moe_offset=1),
                    hybrid_period=2, hybrid_attn_positions=(0,)),
    "t-rwkv": dict(name="t-rwkv", family="ssm", num_layers=2, d_model=64,
                   num_heads=0, num_kv_heads=0, d_ff=128, vocab_size=256,
                   rwkv=dict(head_dim=16, decay_lora=8))}
AUX_RTOL = 1e-4


def family_config(arch):
    """The family arm's model: rwkv6-3b at full width, depth 2; jamba's
    widths in one period of 2 layers ((attention, MLP), (Mamba, MoE):
    jamba-smoke's layout) with 4 of its 16 experts."""
    from repro_torch.configs.registry import get_config
    if arch == "rwkv6-3b":
        return dataclasses.replace(get_config(arch), num_layers=FAMILY_DEPTH)
    cfg = jamba_config(FAMILY_DEPTH, period=2, attn_positions=(0,))
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=FAMILY_EXPERTS))


def _launch_checks(name, r):
    """Every call of a run launched each kernel as often as its plan
    says and called no plain version on the card."""
    for s, (launched, called) in enumerate(zip(r["launches"], r["calls"])):
        check(launched == r["int8_plan"] == called,
              f"{name} step {s}: int8 launches {launched} / calls {called} "
              f"!= the plans' {r['int8_plan']}")
    check(r["mm_launches"] == r["mm_calls"]
          == [r["mm_plan"]] * len(r["metrics"]),
          f"{name}: matmul_chunk launches {r['mm_launches']} / calls "
          f"{r['mm_calls']} != the plans' {r['mm_plan']}")
    check(r["scan_launches"] == r["scan_calls"]
          == [r["scan_plan"]] * len(r["metrics"]),
          f"{name}: mamba_scan launches {r['scan_launches']} / calls "
          f"{r['scan_calls']} != the plans' {r['scan_plan']}")


def scan_grad_case(shape, gen, with_h0):
    """``ops.mamba_scan_train``'s forward and gradient on the card
    against autograd of ``ref.mamba_scan_plain`` (fp32, a ~ U(0.2,
    0.999), b, h0 and the output's gradient ~ N(0, 1)), each within
    SCAN_TOL x max(1, max |plain|); the kernel must launch twice (the
    forward and the adjoint)."""
    import torch
    from repro_torch.kernels import ops, ref

    B, S, C = shape
    dev = "cuda"
    a = torch.rand(shape, generator=gen, device=dev) * 0.799 + 0.2
    b = torch.randn(shape, generator=gen, device=dev)
    gy = torch.randn(shape, generator=gen, device=dev)
    h0 = torch.randn(B, C, generator=gen, device=dev) if with_h0 else None
    leaves = [t.clone().requires_grad_() for t in (a, b, h0)
              if t is not None]
    plain = [t.clone().requires_grad_() for t in (a, b, h0)
             if t is not None]
    before = ops.mamba_scan.launches
    hs = ops.mamba_scan_train(*leaves, *([] if with_h0 else [None]))
    grads = torch.autograd.grad(hs, leaves, gy)
    torch.cuda.synchronize()
    launches = ops.mamba_scan.launches - before
    want = ref.mamba_scan_plain(*plain, *([] if with_h0 else [None]))
    want_grads = torch.autograd.grad(want, plain, gy)
    out = {"case": "scan_grad", "shape": list(shape), "h0": with_h0,
           "launches": launches}
    for name, g, w in zip(("hs", "da", "db", "dh0"), (hs,) + grads,
                          (want,) + want_grads):
        scale = max(1.0, w.abs().max().item())
        err = (g.detach() - w.detach()).abs().max().item()
        out[f"{name}_max_abs_err"] = err
        check(bool(torch.isfinite(g).all().item()),
              f"scan_grad {name}: not finite")
        check(err <= SCAN_TOL * scale,
              f"scan_grad {name}: max |diff| {err} > {SCAN_TOL} x {scale}")
    check(launches == 2, f"scan_grad: the kernel launched {launches} times "
          "for a forward and its gradient, not 2")
    return out


def scan_adjoint_time(shape, gen):
    """The scan's forward and its backward (the adjoint: flips, the
    kernel, the products) timed at the hybrid arm's shape, fp32, from
    zero state, beside the least time of each: the forward's
    (``scan_bound``) and the adjoint's, whose function reads a, hs and
    the gradient and writes da and db (the flipped copies are the
    implementation's), 3 fp32 operations an element (lambda's FMA, da's
    product)."""
    import torch
    from repro_torch.kernels import ops

    B, S, C = shape
    a = (torch.rand(shape, generator=gen, device="cuda") * 0.799
         + 0.2).requires_grad_()
    b = torch.randn(shape, generator=gen, device="cuda").requires_grad_()
    gy = torch.randn(shape, generator=gen, device="cuda")
    hs = ops.mamba_scan_train(a, b)
    out = {"case": "scan_adjoint_time", "shape": list(shape),
           "fwd_ms": cuda_ms(lambda: ops.mamba_scan_train(a, b), 5),
           "adjoint_ms": cuda_ms(lambda: torch.autograd.grad(
               hs, (a, b), gy, retain_graph=True), 5)}
    out["fwd_bound_ms"], out["fwd_bound_by"] = scan_bound(B, S, C, 4, False)
    n = B * S * C
    t_bytes, t_ops = 5 * 4 * n / PEAK_HBM_BYTES, 3 * n / PEAK_F32_FLOPS
    out["adjoint_bound_ms"] = max(t_bytes, t_ops) * 1e3
    out["adjoint_bound_by"] = "operations" if t_ops > t_bytes else "bytes"
    del a, b, gy, hs
    torch.cuda.empty_cache()
    return out


def family_runs():
    """Phase family_train's arms, in ``FAMILY_RUNS`` order: (arch, arm,
    ModeRun), each ModeRun with its family's model."""
    from repro_torch.launch.train import ModeRun
    cfgs = {arch: family_config(arch) for arch in FAMILY_RUNS}
    return [(arch, name, ModeRun(model=cfgs[arch], **kw))
            for arch, runs in FAMILY_RUNS.items() for name, kw in runs]


def phase_family_train(arms, results):
    """The scan's gradient on the card, then the training of the ssm and
    hybrid families at full width, one step an arm on phase 5's 4 ranks
    (``family_runs``: ``results`` holds every rank's record of each,
    from the stream_train spawn they rode on). Returns the kernels'
    launches and the adjoint's timing."""
    import math

    import torch

    gpu = gpu_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    grad = [scan_grad_case(SCAN_GRAD_SHAPE, gen, h0) for h0 in (False, True)]
    # a rank's scan in the hybrid arm: 2 rows, 512 steps, d_inner 8,192
    # x d_state 16 channels
    grad.append(scan_adjoint_time((TRAIN_BATCH // 4, TRAIN_SEQ, 8192 * 16),
                                  gen))
    for c in grad:
        emit("family_train", **c)
    adjoint = grad[-1]
    launches = {k: 0 for k in QUANT_NAMES}
    launches.update(matmul_chunk=0, mamba_scan=0)
    by = {}
    for (arch, name, mr), rs in zip(arms, results):
        cfg = mr.model
        by[arch, name] = rs
        r0 = rs[0]
        m = r0["metrics"][0]
        check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
              f"{arch} {name}: a metric is not finite: {m}")
        check(all(r["metrics"] == r0["metrics"] for r in rs),
              f"{arch} {name}: the ranks disagree on the metrics")
        check((m["aux_loss"] > 0) == (cfg.moe is not None),
              f"{arch} {name}: aux loss {m['aux_loss']}")
        for r in rs:
            _launch_checks(f"{arch} {name}", r)
        for k in QUANT_NAMES:
            launches[k] += sum(s[k] for r in rs for s in r["launches"])
        launches["matmul_chunk"] += sum(sum(r["mm_launches"]) for r in rs)
        launches["mamba_scan"] += sum(sum(r["scan_launches"]) for r in rs)
        emit("family_train", arch=arch, arm=name, layers=FAMILY_DEPTH,
             experts=cfg.moe.num_experts if cfg.moe else None,
             params=r0["params_total"], seq=TRAIN_SEQ,
             global_batch=TRAIN_BATCH, mesh={"pod": 2, "data": 2, "model": 1},
             loss=m["loss"],
             aux_loss=m["aux_loss"], grad_norm=m["grad_norm"],
             pod_bytes={k: v for k, v in r0["bytes"][0].items()
                        if k.endswith("/pod")},
             bytes_per_step=r0["bytes"][0],
             peak_mem_gib=[r["peak_mem_bytes"] / 2**30 for r in rs],
             step_s=[r["step_s"][0] for r in rs],
             scan_launches=r0["scan_launches"][0], scan_plan=r0["scan_plan"],
             int8_launches=r0["launches"][0],
             matmul_chunk_launches=r0["mm_launches"][0], gpu=gpu)
    for arch, runs in FAMILY_RUNS.items():
        z3 = by[arch, "zero3"][0]["metrics"][0]
        for name, _ in runs:
            m = by[arch, name][0]["metrics"][0]
            tol = INT8_DRIFT if "q8" in name else LOSS_RTOL
            check(_rel(m["loss"], z3["loss"]) <= tol,
                  f"{arch} {name}: loss {m['loss']} != zero3 {z3['loss']}")
        fc = "fcdp" if arch == "rwkv6-3b" else "fcdp_q8_ag"
        ag = {n: by[arch, n][0]["bytes"][0].get("all_gather/pod", 0)
              for n in (fc, "zero3")}
        check(ag[fc] < ag["zero3"],
              f"{arch}: fcdp's pod all-gather {ag[fc]} not below zero3's "
              f"{ag['zero3']}")
    q8 = by["jamba-v0.1-52b", "fcdp_q8_ag"][0]
    check(all(v > 0 for v in q8["launches"][0].values())
          and q8["mm_launches"][0] > 0 and q8["scan_launches"][0] > 0,
          "hybrid: the int8, chunk-matmul or scan kernel launched no time")
    z3 = by["jamba-v0.1-52b", "zero3"][0]["metrics"][0]
    mx = by["jamba-v0.1-52b", "mixed"][0]["metrics"][0]
    check(_rel(mx["grad_norm"], z3["grad_norm"]) <= GNORM_RTOL,
          f"hybrid mixed: grad norm {mx['grad_norm']} != zero3 "
          f"{z3['grad_norm']}")
    return launches, adjoint


def family_parity_runs():
    """Phase family_parity's runs: one fcdp step in fp32 for each of
    ``FAMILY_PARITY_MODELS``."""
    from repro_torch.configs.base import (MambaConfig, ModelConfig,
                                          MoEConfig, RWKVConfig)
    from repro_torch.launch.train import ModeRun

    sub = {"moe": MoEConfig, "mamba": MambaConfig, "rwkv": RWKVConfig}
    return [ModeRun("fcdp", dtype="float32", model=ModelConfig(
        **{k: sub[k](**v) if k in sub else v for k, v in kw.items()}))
        for kw in FAMILY_PARITY_MODELS.values()]


def phase_family_parity(got):
    """tests/test_system.py's t-jamba and t-rwkv at (2, 2, 1), fp32: one
    fcdp step each on the card (the scan kernel in both directions) and
    on the CPU (plain versions) from the same weights (drawn on the
    CPU), run on train_parity's jobs (``got``: {device: rank 0's
    records}): loss, aux loss and grad norm within the step tolerances,
    the same bytes, the scan's plan launched on the card and only called
    on the CPU."""
    report = {}
    for i, name in enumerate(FAMILY_PARITY_MODELS):
        g, c = got["cuda"][i], got["cpu"][i]
        mg, mc = g["metrics"][0], c["metrics"][0]
        check(_rel(mg["loss"], mc["loss"]) <= LOSS_RTOL,
              f"{name}: card loss {mg['loss']} != CPU {mc['loss']}")
        check(_rel(mg["grad_norm"], mc["grad_norm"]) <= GNORM_RTOL,
              f"{name}: card grad norm {mg['grad_norm']} != CPU "
              f"{mc['grad_norm']}")
        check(abs(mg["aux_loss"] - mc["aux_loss"])
              <= AUX_RTOL * abs(mc["aux_loss"]),
              f"{name}: card aux loss {mg['aux_loss']} != CPU "
              f"{mc['aux_loss']}")
        check(g["bytes"] == c["bytes"],
              f"{name}: card and CPU moved different bytes")
        check(g["scan_launches"] == g["scan_calls"] == [g["scan_plan"]]
              and c["scan_launches"] == [0]
              and c["scan_calls"] == [c["scan_plan"]],
              f"{name}: scan launches card {g['scan_launches']} / CPU "
              f"{c['scan_launches']}, plan {g['scan_plan']}")
        report[name] = {
            "loss": {"cuda": mg["loss"], "cpu": mc["loss"]},
            "aux_loss": {"cuda": mg["aux_loss"], "cpu": mc["aux_loss"]},
            "grad_norm": {"cuda": mg["grad_norm"], "cpu": mc["grad_norm"]},
            "scan_launches_cuda": g["scan_launches"][0],
            "bytes": g["bytes"][0], "step_s": {"cuda": g["step_s"][0],
                                               "cpu": c["step_s"][0]}}
    emit("family_parity", dtype="float32",
         mesh={"pod": 2, "data": 2, "model": 1}, runs=report)


# -- the six remaining decoder-only archs -----------------------------------

# the serve arms' batch, prompt and greedy decode steps (the contiguous
# cache holds prompt + decode positions); the paged arms' requests of
# the serve phase's mixed_requests shape (up to 512 positions, 16
# generated, in prefill chunks of 128)
ARCH_SERVE_BATCH, ARCH_PROMPT, ARCH_DECODE = 8, 512, 32
ARCH_REQUESTS, ARCH_GEN, ARCH_CHUNK = 8, 16, 128
# each serve arm's depth on the card: the dense and vlm archs whole or
# cut to ~35 GB of bf16 weights, the moe archs to one layer with all
# their experts (PERF.md section 4)
ARCH_SERVE_DEPTH = {"gemma-2b": 18, "granite-3-8b": 40, "yi-34b": 30,
                    "chameleon-34b": 24, "kimi-k2-1t-a32b": 1,
                    "llama4-maverick-400b-a17b": 1}
# the train arms' depth: the dense and vlm archs at ~0.7-1.8 B parameters
# for 4 ranks on one card; the moe archs' embedding and head alone
# (~2.1-2.4 B) do not fit there (PERF.md section 4)
ARCH_TRAIN_DEPTH = {"gemma-2b": 2, "granite-3-8b": 2, "yi-34b": 1,
                    "chameleon-34b": 1}
# card against CPU through the contiguous steps at full width, depth 1
ARCH_PARITY = dict(batch=2, prompt=64, decode=8, logit_tol=0.1)
ARCH_PARITY_EXPERTS = 8

def phase_arch_kernels():
    """The flash kernel at the new archs' head dims, against its plain
    version at the shapes their serve paths give it: gemma-2b's paged
    prefill chunk and decode (hd 256, MQA: 8 q heads on 1 kv head, 528
    keys a row) and kimi-k2's contiguous prefill and decode (hd 112, 64 /
    8 heads over the 544-position cache), each timed (a CUDA graph, the
    wrapper's host us, the bound, SDPA); then, untimed, yi-34b's and
    llama4-maverick's (hd 128, groups of 7 and 5). nvcc's report of the
    kernel each case ran must show no spill."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(25)
    B, kv_len = ARCH_SERVE_BATCH, ARCH_PROMPT + ARCH_DECODE
    chunk_offs = (torch.randint(0, 400 // 16, (B,), generator=gen,
                                device="cuda") * 16).tolist()
    dec_offs = torch.randint(16, 528, (B,), generator=gen, device="cuda")
    kimi_offs = torch.randint(ARCH_PROMPT, kv_len, (B,), generator=gen,
                              device="cuda")
    cases = {
        "gemma_prefill_chunk": kernel_case(
            "gemma_prefill_chunk", B, 128, 528, 8, 1, 256, chunk_offs, True,
            gen, timed=True),
        "gemma_decode": kernel_case(
            "gemma_decode", B, 1, 528, 8, 1, 256, dec_offs.tolist(), True,
            gen, timed=True),
        "kimi_prefill": kernel_case(
            "kimi_prefill", B, ARCH_PROMPT, kv_len, 64, 8, 112, [0] * B,
            True, gen, timed=True),
        "kimi_decode": kernel_case(
            "kimi_decode", B, 1, kv_len, 64, 8, 112, kimi_offs.tolist(),
            True, gen, timed=True)}
    # the other archs' shapes that no earlier phase holds: yi's GQA group
    # of 7 and llama4's of 5 (hd 128) take the mma.sync prefill and the
    # split-KV decode at a group size the kernels phase does not run
    others = [
        kernel_case("yi_prefill_chunk", B, 128, 512, 56, 8, 128, chunk_offs,
                    True, gen),
        kernel_case("yi_decode", B, 1, 512, 56, 8, 128, dec_offs.tolist(),
                    True, gen),
        kernel_case("llama4_prefill", B, ARCH_PROMPT, kv_len, 40, 8, 128,
                    [0] * B, True, gen),
        kernel_case("llama4_decode", B, 1, kv_len, 40, 8, 128,
                    kimi_offs.tolist(), True, gen)]
    for c in list(cases.values()) + others:
        name = c["case"]
        check(c["variant"] == "mma" or name not in cases,
              f"{name}: variant {c['variant']}")
        check(c["ptxas"].get("spill_bytes") == 0,
              f"{name}: {c['ptxas']['kernel']} spills "
              f"({c['ptxas'].get('spill_bytes')} bytes)")
        emit("arch_kernels", **c)
    return cases


def arch_config(arch, depth, experts=None):
    """``arch`` at full width, its depth cut to ``depth`` (and its experts
    to ``experts``)."""
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config(arch), num_layers=depth)
    if experts is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=experts))
    return cfg


def _arch_paged_arm(cfg):
    """The paged engine over ``ARCH_REQUESTS`` of the serve phase's
    mixed_requests shape (512 positions, 16 generated, batch 8, chunks
    of 128)."""
    import torch
    from repro_torch.configs.base import RunConfig, ShapeCell
    from repro_torch.core.engine import StepBundle
    from repro_torch.core.engine.serve import default_paged_kv
    from repro_torch.core.serve_schedule import PagedServeEngine, summarize
    from repro_torch.kernels import flash_attention as fa, ops
    from repro_torch.launch.serve import mixed_requests

    cell = ShapeCell("arch_serve", "decode", ARCH_PROMPT, ARCH_SERVE_BATCH)
    bundle = StepBundle(RunConfig(model=cfg, shape=cell))
    t0 = time.perf_counter()
    params = bundle.init_all_params(seed=0)
    engine = PagedServeEngine(bundle, default_paged_kv(bundle, cell),
                              chunk=ARCH_CHUNK)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    requests = mixed_requests(ARCH_REQUESTS, ARCH_PROMPT, ARCH_GEN,
                              cfg.vocab_size, seed=0)
    ops.flash_attention.launches = 0
    results, wall = engine.serve(params, requests)
    torch.cuda.synchronize()
    launches = ops.flash_attention.launches
    calls = {"prefill": engine.prefill_calls, "decode": engine.decode_calls}
    check(len(results) == ARCH_REQUESTS
          and all(len(r.tokens) == ARCH_GEN for r in results),
          f"{cfg.name}: served {len(results)} requests of "
          f"{[len(r.tokens) for r in results]} tokens")
    check(all(0 <= t < cfg.vocab_size for r in results for t in r.tokens),
          f"{cfg.name}: a token id lies outside the vocabulary")
    L = cfg.num_layers
    check(launches == L * sum(calls.values()), f"{cfg.name}: flash "
          f"launched {launches} times, expected {L} x {calls}")
    H, Hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    step_variants = {"prefill": {fa.variant(ARCH_CHUNK, H, Hk, hd): L},
                     "decode": {fa.variant(1, H, Hk, hd): L}}
    summary = summarize(results, wall)
    del params, engine
    return dict(path="paged", calls=calls, launches=launches,
                flash_launches_a_step=step_variants,
                requests=ARCH_REQUESTS, seq_len=ARCH_PROMPT, gen=ARCH_GEN,
                chunk=ARCH_CHUNK, init_s=init_s,
                ttft_p50_s=summary["ttft_s"]["p50"],
                tpot_p50_s=summary["tpot_s"]["p50"],
                tok_s=summary["throughput_tok_s"], summary=summary,
                row0_tokens=sorted(results, key=lambda r: r.rid)[0].tokens)


def _arch_contiguous_arm(cfg):
    """The contiguous prefill of ARCH_PROMPT tokens and ARCH_DECODE greedy
    decode steps at batch ARCH_SERVE_BATCH, as jamba_serve runs them."""
    import numpy as np
    import torch
    from repro_torch.configs.base import RunConfig, ShapeCell
    from repro_torch.core.engine import StepBundle
    from repro_torch.kernels import flash_attention as fa, ops

    max_len = ARCH_PROMPT + ARCH_DECODE
    cell = ShapeCell("arch_serve", "decode", max_len, ARCH_SERVE_BATCH)
    bundle = StepBundle(RunConfig(model=cfg, shape=cell))
    t0 = time.perf_counter()
    params = bundle.init_all_params(seed=0)
    ids = torch.randint(1, cfg.vocab_size, (ARCH_SERVE_BATCH, ARCH_PROMPT),
                        generator=torch.Generator(device="cuda")
                        .manual_seed(2), device="cuda")
    prefill, decode = bundle.make_prefill_step(), bundle.make_decode_step()
    pick = bundle.make_greedy_pick()
    state = bundle.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ops.flash_attention.launches = 0
    t0 = time.perf_counter()
    logits, state = prefill(params, ids, state)
    tok = pick(logits)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    finite, tokens, tpot = [torch.isfinite(logits).all()], [tok], []
    for _ in range(ARCH_DECODE):
        t1 = time.perf_counter()
        logits, state = decode(params, tok[:, None], state)
        tok = pick(logits)
        torch.cuda.synchronize()
        tpot.append(time.perf_counter() - t1)
        finite.append(torch.isfinite(logits).all())
        tokens.append(tok)
    wall = time.perf_counter() - t0
    launches = ops.flash_attention.launches
    steps = 1 + ARCH_DECODE
    L = cfg.num_layers
    check(launches == L * steps, f"{cfg.name}: flash launched {launches} "
          f"times, expected {L} x {steps}")
    check(all(bool(f.item()) for f in finite),
          f"{cfg.name}: a logit is not finite")
    toks = torch.stack(tokens, dim=1).cpu()
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all().item()),
          f"{cfg.name}: a token id lies outside the vocabulary")
    idx = state["pos0"]["attn"]["idx"].tolist()
    check(idx == [max_len] * L, f"{cfg.name}: KV cache idx {idx}")
    H, Hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    tp = np.asarray(tpot)
    del params, state, logits
    return dict(path="contiguous", launches=launches,
                flash_launches_a_step={
                    "prefill": {fa.variant(ARCH_PROMPT, H, Hk, hd): L},
                    "decode": {fa.variant(1, H, Hk, hd): L}},
                prompt=ARCH_PROMPT, decode_steps=ARCH_DECODE, init_s=init_s,
                ttft_s=prefill_s, prefill_s=prefill_s,
                tpot_p50_s=float(np.percentile(tp, 50)),
                tpot_p90_s=float(np.percentile(tp, 90)),
                tok_s=ARCH_SERVE_BATCH * steps / wall,
                decode_tok_s=ARCH_SERVE_BATCH * ARCH_DECODE / float(tp.sum()),
                wall_s=wall, row0_tokens=toks[0].tolist())


def phase_arch_serve():
    """The six archs served on the card at full width, bf16, the depth
    of ``ARCH_SERVE_DEPTH`` (every expert kept): the paged engine for the
    dense and vlm archs, the contiguous steps for the moe ones (the
    paged path refuses a MoE stack, as in the JAX package). Returns the
    flash kernel's launches."""
    import torch
    from repro_torch.configs.base import SystemConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core.partition import tree_items
    from repro_torch.models.lm import LM

    gpu = gpu_line()
    total = 0
    for arch, depth in ARCH_SERVE_DEPTH.items():
        cfg = arch_config(arch, depth)
        params = sum(d.size() for _, d in tree_items(LM(cfg,
                                                        SystemConfig()).defs))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        arm = (_arch_contiguous_arm(cfg) if cfg.moe is not None
               else _arch_paged_arm(cfg))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.empty_cache()
        total += arm["launches"]
        emit("arch_serve", arch=arch, layers=depth,
             layers_full=get_config(arch).num_layers,
             experts=cfg.moe.num_experts if cfg.moe else None,
             params=params, weights_gib=params * 2 / 2**30,
             batch=ARCH_SERVE_BATCH, peak_mem_gib=peak, gpu=gpu, **arm)
    check_split_counters("arch_serve")
    return total


def arch_train_runs():
    """Phase arch_train's arms, in ``ARCH_TRAIN_DEPTH`` order: (arch,
    ModeRun), one fcdp step each of the arch at full width and its cut
    depth, riding on phase stream_train's spawn."""
    from repro_torch.launch.train import ModeRun
    return [(arch, ModeRun("fcdp", model=arch_config(arch, depth)))
            for arch, depth in ARCH_TRAIN_DEPTH.items()]


def phase_arch_train(arms, results):
    """The dense and vlm archs' train step at full width on phase 5's 4
    ranks (pod 2, data 2, model 1), seq 512, global batch 8, bf16, one
    fcdp step each (``results``: every rank's record of each arm, from
    the stream_train spawn they rode on): finite metrics the ranks agree
    on, no aux loss, no kernel launched that no plan asks for; reports
    the loss, the grad norm, the bytes by (op, axis) (gemma's tied table
    gathered and reduced at both ends of the step), the peak a rank and
    the step time."""
    import math

    gpu = gpu_line()
    for (arch, mr), rs in zip(arms, results):
        r0 = rs[0]
        m = r0["metrics"][0]
        check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
              f"arch_train {arch}: a metric is not finite: {m}")
        check(all(r["metrics"] == r0["metrics"] for r in rs),
              f"arch_train {arch}: the ranks disagree on the metrics")
        check(m["aux_loss"] == 0, f"arch_train {arch}: aux loss "
              f"{m['aux_loss']}")
        for r in rs:
            _launch_checks(f"arch_train {arch}", r)
        emit("arch_train", arch=arch, layers=mr.model.num_layers,
             tied=mr.model.tie_embeddings, params=r0["params_total"],
             seq=TRAIN_SEQ, global_batch=TRAIN_BATCH,
             mesh={"pod": 2, "data": 2, "model": 1}, mode=mr.mode,
             loss=m["loss"], grad_norm=m["grad_norm"],
             pod_bytes={k: v for k, v in r0["bytes"][0].items()
                        if k.endswith("/pod")},
             bytes_per_step=r0["bytes"][0],
             peak_mem_gib=[r["peak_mem_bytes"] / 2**30 for r in rs],
             step_s=[r["step_s"][0] for r in rs], gpu=gpu)


def arch_parity_runs():
    """Phase arch_parity's train runs: one fcdp step in fp32 of each new
    arch's smoke config, riding on train_parity's jobs."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.train import ModeRun
    return [ModeRun("fcdp", dtype="float32", model=get_smoke_config(a))
            for a in ARCH_SERVE_DEPTH]


def phase_arch_parity(got):
    """Card against CPU for the six archs: their smoke configs' fcdp step
    at (2, 2, 1) in fp32 (``got``: {device: rank 0's records} of
    ``arch_parity_runs`` on train_parity's jobs; loss, aux loss and grad
    norm within the step tolerances, the same bytes), then gemma-2b and
    kimi-k2 (8 of its experts) at full width, depth 1, through the
    contiguous serve steps in bf16 (``contiguous_parity``: the card's
    kernels, hd 256 and 112, against the CPU's plain versions)."""
    from repro_torch.configs.registry import get_smoke_config
    report = {}
    for arch, g, c in zip(ARCH_SERVE_DEPTH, got["cuda"], got["cpu"]):
        name = get_smoke_config(arch).name
        mg, mc = g["metrics"][0], c["metrics"][0]
        check(_rel(mg["loss"], mc["loss"]) <= LOSS_RTOL,
              f"{name}: card loss {mg['loss']} != CPU {mc['loss']}")
        check(_rel(mg["grad_norm"], mc["grad_norm"]) <= GNORM_RTOL,
              f"{name}: card grad norm {mg['grad_norm']} != CPU "
              f"{mc['grad_norm']}")
        check(abs(mg["aux_loss"] - mc["aux_loss"])
              <= AUX_RTOL * abs(mc["aux_loss"]),
              f"{name}: card aux loss {mg['aux_loss']} != CPU "
              f"{mc['aux_loss']}")
        check(g["bytes"] == c["bytes"],
              f"{name}: card and CPU moved different bytes")
        report[name] = {
            "loss": {"cuda": mg["loss"], "cpu": mc["loss"]},
            "aux_loss": {"cuda": mg["aux_loss"], "cpu": mc["aux_loss"]},
            "grad_norm": {"cuda": mg["grad_norm"], "cpu": mc["grad_norm"]},
            "bytes": g["bytes"][0]}
    emit("arch_parity", part="train", dtype="float32",
         mesh={"pod": 2, "data": 2, "model": 1}, runs=report)
    contiguous_parity("arch_parity", arch_config("gemma-2b", 1),
                      ARCH_PARITY)
    contiguous_parity("arch_parity", arch_config("kimi-k2-1t-a32b", 1,
                                                 ARCH_PARITY_EXPERTS),
                      ARCH_PARITY)


# -- seamless-m4t-medium, the encoder-decoder -------------------------------

ENCDEC = "seamless-m4t-medium"
# the serve cell: batch 8, 512-token prompts and 32 greedy decode steps
# in a cache of 544 positions, 136 encoder frames (encdec.enc_len)
ENCDEC_SERVE_BATCH, ENCDEC_PROMPT, ENCDEC_DECODE = 8, 512, 32
# the train arms, whole (12 + 12 layers), on stream_train's 4 ranks
ENCDEC_TRAIN_RUNS = (
    ("zero3", dict(mode="zero3")),
    ("fcdp_q8_ag", dict(mode="fcdp", param_compress="int8_pod",
                        grad_compress="int8_pod", fused_matmul="ag_matmul")))
# card against CPU through the contiguous steps at full width, 1 + 1
# layers
ENCDEC_PARITY = dict(batch=2, prompt=64, decode=8, logit_tol=0.1)


def encdec_config(layers=None):
    """seamless-m4t-medium at full width; with ``layers``, that many
    encoder and decoder layers each."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(ENCDEC)
    if layers is None:
        return cfg
    return dataclasses.replace(cfg, num_layers=layers,
                               num_encoder_layers=layers)


def phase_encdec_kernels():
    """The flash kernel's non-causal paths at seamless-m4t-medium's serve
    shapes (hd 64, 16 heads on 16 kv heads), against its plain version,
    timed (a CUDA graph, host us, the bound, SDPA): the encoder's
    self-attention [8, 136 over 136] and the cross-attention's prefill
    [8, 512 over 136] (the mma.sync kernel: q tiles past the 136 keys,
    whose last tile of 64 is ragged, bounded by the key count alone) and
    decode [8, 1 over 136] (the split-KV kernel, three splits, the last
    one ragged). Then, untimed, the same non-causal calls with nonzero
    ``q_offset`` (ignored without the mask) and at a GQA group of 2.
    nvcc's report of each case's kernel must show no spill."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.encdec import enc_len
    gen = torch.Generator(device="cuda").manual_seed(26)
    B, S = ENCDEC_SERVE_BATCH, ENCDEC_PROMPT
    F = enc_len(ENCDEC_PROMPT + ENCDEC_DECODE)
    zeros = [0] * B
    offs = torch.randint(1, 500, (B,), generator=gen, device="cuda").tolist()
    cases = {
        "encoder": kernel_case("encdec_encoder", B, F, F, 16, 16, 64, zeros,
                               False, gen, timed=True),
        "cross_prefill": kernel_case("encdec_cross_prefill", B, S, F, 16,
                                     16, 64, zeros, False, gen, timed=True),
        "cross_decode": kernel_case("encdec_cross_decode", B, 1, F, 16, 16,
                                    64, zeros, False, gen, timed=True)}
    others = [
        kernel_case("encdec_cross_prefill_offsets", B, S, F, 16, 16, 64,
                    offs, False, gen),
        kernel_case("encdec_cross_decode_offsets", B, 1, F, 16, 16, 64,
                    offs, False, gen),
        kernel_case("encdec_cross_prefill_gqa2", B, S, F, 16, 8, 64, zeros,
                    False, gen),
        kernel_case("encdec_cross_decode_gqa2", B, 1, F, 16, 8, 64, offs,
                    False, gen)]
    want = {"encoder": "mma", "cross_prefill": "mma", "cross_decode": "split"}
    for name, c in cases.items():
        check(c["variant"] == want[name],
              f"{c['case']}: variant {c['variant']}")
    check(cases["cross_decode"]["splits"] == -(-F // fa.KEYS_PER_SPLIT) == 3,
          f"encdec cross decode: {cases['cross_decode']['splits']} splits")
    for c in list(cases.values()) + others:
        check(c["ptxas"].get("spill_bytes") == 0,
              f"{c['case']}: {c['ptxas']['kernel']} spills "
              f"({c['ptxas'].get('spill_bytes')} bytes)")
        emit("encdec_kernels", **c)
    return cases


def phase_encdec_serve():
    """seamless-m4t-medium served at full width and depth (12 encoder and
    12 decoder layers), bf16, random weights from seed 0, through
    ``StepBundle.make_prefill_step`` (the encoder frames, bf16, drawn
    from seed 2) and ``make_decode_step``: batch 8, 512-token prompts,
    32 greedy decode steps. Checks the flash launches (a prefill: 12 in
    the encoder, non-causal; 12 causal self-attentions; 12
    cross-attentions; a decode step: 24), the variant of each, finite
    logits, token ids in the vocabulary, every self-attention cache's
    idx; reports the prefill time, TPOT, tokens/s and the peak memory.
    Returns the flash launches."""
    import numpy as np
    import torch
    from repro_torch.configs.base import RunConfig, ShapeCell
    from repro_torch.core.engine import StepBundle
    from repro_torch.core.partition import tree_items
    from repro_torch.kernels import flash_attention as fa, ops
    from repro_torch.models.encdec import enc_len

    cfg = encdec_config()
    B, S, D = ENCDEC_SERVE_BATCH, ENCDEC_PROMPT, ENCDEC_DECODE
    max_len = S + D
    F = enc_len(max_len)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bundle = StepBundle(RunConfig(model=cfg, shape=ShapeCell(
        "encdec_serve", "decode", max_len, B)))
    t0 = time.perf_counter()
    params = bundle.init_all_params(seed=0)
    g = torch.Generator(device="cuda").manual_seed(2)
    frames = torch.randn(B, F, cfg.d_model, generator=g,
                         device="cuda").bfloat16()
    ids = torch.randint(1, cfg.vocab_size, (B, S), generator=g,
                        device="cuda")
    prefill, decode = bundle.make_prefill_step(), bundle.make_decode_step()
    pick = bundle.make_greedy_pick()
    state = bundle.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ops.flash_attention.launches = 0
    t0 = time.perf_counter()
    logits, state = prefill(params, frames, ids, state)
    tok = pick(logits)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = ops.flash_attention.launches
    finite, tokens, tpot = [torch.isfinite(logits).all()], [tok], []
    for _ in range(D):
        t1 = time.perf_counter()
        logits, state = decode(params, tok[:, None], state)
        tok = pick(logits)
        torch.cuda.synchronize()
        tpot.append(time.perf_counter() - t1)
        finite.append(torch.isfinite(logits).all())
        tokens.append(tok)
    wall = time.perf_counter() - t0
    launches = ops.flash_attention.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_enc, n_dec = cfg.num_encoder_layers, cfg.num_layers
    check(prefill_launches == n_enc + 2 * n_dec,
          f"encdec_serve: the prefill launched flash {prefill_launches} "
          f"times, expected {n_enc} + 2 x {n_dec}")
    check(launches == prefill_launches + 2 * n_dec * D,
          f"encdec_serve: flash launched {launches} times, expected "
          f"{prefill_launches} + 2 x {n_dec} x {D}")
    check(all(bool(f.item()) for f in finite),
          "encdec_serve: a logit is not finite")
    toks = torch.stack(tokens, dim=1).cpu()
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all().item()),
          "encdec_serve: a token id lies outside the vocabulary")
    idx = state["pos0"]["attn"]["idx"].tolist()
    check(idx == [max_len] * n_dec, f"encdec_serve: KV cache idx {idx}")
    xk = state["pos0"]["xattn"]["k"]
    check(tuple(xk.shape) == (n_dec, B, F, cfg.num_kv_heads, 64)
          and xk.dtype == torch.bfloat16,
          f"encdec_serve: cross-attention state {tuple(xk.shape)} "
          f"{xk.dtype}")
    H, Hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    variants = {"prefill": {"encoder": fa.variant(F, H, Hk, hd),
                            "self": fa.variant(S, H, Hk, hd),
                            "cross": fa.variant(S, H, Hk, hd)},
                "decode": {"self": fa.variant(1, H, Hk, hd),
                           "cross": fa.variant(1, H, Hk, hd)}}
    n_params = sum(d.size() for _, d in tree_items(bundle.defs))
    tp = np.asarray(tpot)
    emit("encdec_serve", arch=ENCDEC, encoder_layers=n_enc,
         decoder_layers=n_dec, params=n_params,
         weights_gib=n_params * 2 / 2**30, batch=B, prompt=S,
         decode_steps=D, enc_frames=F, init_s=init_s, prefill_s=prefill_s,
         tpot_p50_s=float(np.percentile(tp, 50)),
         tpot_p90_s=float(np.percentile(tp, 90)),
         decode_tok_s=B * D / float(tp.sum()), wall_s=wall,
         launches=launches, prefill_launches=prefill_launches,
         variants=variants, peak_mem_gib=peak,
         row0_tokens=toks[0].tolist(), gpu=gpu_line())
    check_split_counters("encdec_serve")
    del params, state, logits
    torch.cuda.empty_cache()
    return launches


def encdec_train_runs():
    """Phase encdec_train's arms, in ``ENCDEC_TRAIN_RUNS`` order: (arm,
    ModeRun), seamless-m4t-medium whole, riding on phase stream_train's
    spawn."""
    from repro_torch.launch.train import ModeRun
    cfg = encdec_config()
    return [(name, ModeRun(model=cfg, **kw))
            for name, kw in ENCDEC_TRAIN_RUNS]


def phase_encdec_train(arms, results):
    """seamless-m4t-medium's train step at full width and depth (12 + 12
    layers) on phase 5's 4 ranks (pod 2, data 2, model 1), seq 512
    (128 encoder frames), global batch 8, bf16: zero3, and fcdp with
    int8 qwZ/qgZ and ag_matmul (``results``: every rank's record of
    each, from the stream_train spawn they rode on). Checks finite
    metrics the ranks agree on, no aux loss, the fcdp arm's loss within
    INT8_DRIFT of zero3's, every rank's int8 and chunk-matmul launches
    equal to the plans (no plain call), and fcdp's pod all-gather below
    zero3's; reports the bytes by (op, axis), the peaks and the step
    times. Returns the kernels' launches."""
    import math

    from repro_torch.models.encdec import enc_len
    gpu = gpu_line()
    launches = {k: 0 for k in QUANT_NAMES}
    launches["matmul_chunk"] = 0
    by = {}
    for (name, mr), rs in zip(arms, results):
        by[name] = rs
        r0 = rs[0]
        m = r0["metrics"][0]
        check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
              f"encdec_train {name}: a metric is not finite: {m}")
        check(all(r["metrics"] == r0["metrics"] for r in rs),
              f"encdec_train {name}: the ranks disagree on the metrics")
        check(m["aux_loss"] == 0, f"encdec_train {name}: aux loss "
              f"{m['aux_loss']}")
        for r in rs:
            _launch_checks(f"encdec_train {name}", r)
        for k in QUANT_NAMES:
            launches[k] += sum(s[k] for r in rs for s in r["launches"])
        launches["matmul_chunk"] += sum(sum(r["mm_launches"]) for r in rs)
        emit("encdec_train", arch=ENCDEC, arm=name,
             encoder_layers=mr.model.num_encoder_layers,
             decoder_layers=mr.model.num_layers, params=r0["params_total"],
             seq=TRAIN_SEQ, enc_frames=enc_len(TRAIN_SEQ),
             global_batch=TRAIN_BATCH,
             mesh={"pod": 2, "data": 2, "model": 1}, loss=m["loss"],
             grad_norm=m["grad_norm"],
             pod_bytes={k: v for k, v in r0["bytes"][0].items()
                        if k.endswith("/pod")},
             bytes_per_step=r0["bytes"][0],
             peak_mem_gib=[r["peak_mem_bytes"] / 2**30 for r in rs],
             step_s=[r["step_s"][0] for r in rs],
             int8_launches=r0["launches"][0], int8_plan=r0["int8_plan"],
             matmul_chunk_launches=r0["mm_launches"][0],
             matmul_chunk_plan=r0["mm_plan"], gpu=gpu)
    z3, q8 = by["zero3"][0], by["fcdp_q8_ag"][0]
    check(_rel(q8["metrics"][0]["loss"], z3["metrics"][0]["loss"])
          <= INT8_DRIFT, f"encdec_train: fcdp_q8_ag loss "
          f"{q8['metrics'][0]['loss']} drifts from zero3's "
          f"{z3['metrics'][0]['loss']}")
    check(all(v > 0 for v in q8["launches"][0].values())
          and q8["mm_launches"][0] > 0,
          "encdec_train: the int8 or chunk-matmul kernel launched no time")
    ag = {n: by[n][0]["bytes"][0].get("all_gather/pod", 0) for n in by}
    check(ag["fcdp_q8_ag"] < ag["zero3"],
          f"encdec_train: fcdp's pod all-gather {ag['fcdp_q8_ag']} not "
          f"below zero3's {ag['zero3']}")
    return launches


def encdec_parity_runs():
    """Phase encdec_parity's train run: one fcdp step in fp32 of the
    smoke config, riding on train_parity's jobs."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.train import ModeRun
    return [ModeRun("fcdp", dtype="float32", model=get_smoke_config(ENCDEC))]


def phase_encdec_parity(got):
    """Card against CPU: the smoke config's fcdp step at (2, 2, 1) in fp32
    (``got``: {device: rank 0's record}, from train_parity's jobs; loss
    and grad norm within the step tolerances, the same bytes), then
    seamless-m4t-medium at full width, 1 + 1 layers, bf16, through the
    contiguous steps (``contiguous_parity``: the frames, a 64-token
    prompt, batch 2, 8 decode steps; logits within 0.1, tokens equal up
    to near-ties; the card's non-causal kernels against the CPU's plain
    versions)."""
    from repro_torch.configs.registry import get_smoke_config
    g, c = got["cuda"], got["cpu"]
    mg, mc = g["metrics"][0], c["metrics"][0]
    name = get_smoke_config(ENCDEC).name
    check(_rel(mg["loss"], mc["loss"]) <= LOSS_RTOL,
          f"{name}: card loss {mg['loss']} != CPU {mc['loss']}")
    check(_rel(mg["grad_norm"], mc["grad_norm"]) <= GNORM_RTOL,
          f"{name}: card grad norm {mg['grad_norm']} != CPU "
          f"{mc['grad_norm']}")
    check(g["bytes"] == c["bytes"],
          f"{name}: card and CPU moved different bytes")
    emit("encdec_parity", part="train", dtype="float32", model=name,
         mesh={"pod": 2, "data": 2, "model": 1},
         loss={"cuda": mg["loss"], "cpu": mc["loss"]},
         grad_norm={"cuda": mg["grad_norm"], "cpu": mc["grad_norm"]},
         bytes=g["bytes"][0], step_s={"cuda": g["step_s"][0],
                                      "cpu": c["step_s"][0]})
    contiguous_parity("encdec_parity", encdec_config(1), ENCDEC_PARITY)


# -- phase 31: dryrun ----------------------------------------------------------

def _dryrun_init(src: str) -> None:
    """A dry-run worker: the port on its path, no card in sight, one
    thread (fake tensors compute nothing), and the dry run's imports
    done, with one fake op for those made at first use."""
    import os
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    sys.path.insert(0, src)
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    import repro_torch.launch.dryrun  # noqa: F401
    torch.set_num_threads(1)
    with FakeTensorMode():
        torch.ones(2, 2) @ torch.ones(2, 2)


def _dryrun_job(job):
    """One dry-run row, in a worker: ("cell", arch, mode, peft, depth,
    layers) runs ``dryrun_cell`` on the multi-pod production mesh with
    the arch cut to ``layers`` (None: whole); ("train_fcdp",) phase 5's
    fcdp arm at its own config, mesh and shape."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun as dr
    if job[0] == "train_fcdp":
        cfg = dataclasses.replace(get_config("qwen2.5-3b"),
                                  num_layers=TRAIN_DEPTH)
        tj = _train_job(cfg, TRAIN_SEQ, TRAIN_BATCH, [])
        run = tj.run.replace(system=dataclasses.replace(tj.run.system,
                                                        mode="fcdp"))
        row = dr.dryrun_run(run, tj.mesh)
    else:
        _, arch, mode, peft, depth, layers = job
        cfg = get_config(arch)
        if layers is not None:
            kw = {"num_layers": cfg.hybrid_period or layers}
            if cfg.num_encoder_layers:
                kw["num_encoder_layers"] = layers
            cfg = dataclasses.replace(cfg, **kw)
        row = dr.dryrun_cell(arch, "train_4k", True, mode,
                             system_overrides={"peft": peft},
                             prefetch_depth=depth, verbose=False, model=cfg)
        row["layers"] = cfg.num_layers + cfg.num_encoder_layers
    rep = row["roofline"]
    return {"job": list(job), "collective_bytes": row["collective_bytes"],
            "flops_per_chip": row["flops_per_chip"],
            "bytes_per_chip": row["bytes_per_chip"],
            "memory": row["memory"], "layers": row.get("layers"),
            "prefetch_depth": row["prefetch_depth"],
            "trace_s": row["trace_s"],
            "roofline": {k: rep[k] for k in (
                "compute_s", "memory_s", "collective_s", "ici_s", "dcn_s",
                "dominant", "step_time_lb_s", "roofline_fraction",
                "useful_flops_ratio")}}


def dryrun_jobs():
    """Phase dryrun's rows, longest first: qwen2.5-3b whole under the four
    modes, the ten archs cut, phase 5's fcdp arm."""
    from repro_torch.configs.registry import ARCH_IDS
    jobs = [("cell", "qwen2.5-3b", mode, peft, 0, None)
            for mode, peft in (("zero3", False), ("fcdp", False),
                               ("zero3", True), ("fcdp", True))]
    jobs += [("cell", a, "fcdp", False, 1, DRYRUN_LAYERS) for a in ARCH_IDS]
    return jobs + [("train_fcdp",)]


def dryrun_pool():
    """Phase dryrun's DRYRUN_WORKERS spawned processes (no CUDA context
    in them), started at once, one empty task each, so they warm up
    (``_dryrun_init``) while the kernels build and wait idle for the
    phase; returns (the pool, the empty tasks)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    pool = ProcessPoolExecutor(DRYRUN_WORKERS, mp_context=mp.get_context(
        "spawn"), initializer=_dryrun_init, initargs=(str(ROOT / "src"),))
    return pool, [pool.submit(int) for _ in range(DRYRUN_WORKERS)]


def start_dryrun(pool):
    """Phase dryrun's rows on ``dryrun_pool``'s workers: {job: future};
    the workers exit once the rows are done."""
    pool, warm = pool
    for f in warm:
        f.result()
    futures = {job: pool.submit(_dryrun_job, job) for job in dryrun_jobs()}
    pool.shutdown(wait=False)
    return futures


def _pod_total(row):
    return sum(v for k, v in row["collective_bytes"].items()
               if k.endswith("/pod"))


def phase_dryrun(futures, train_fcdp):
    """Read the dry-run rows: qwen2.5-3b whole against the JAX trace
    (bytes exact, FLOPs within DRYRUN_FLOPS_RTOL), the paper's two
    ratios, the ten archs' rows, and phase 5's fcdp arm against its
    measured bytes (exact) and step peak (the ratio printed)."""
    import torch
    t0 = time.perf_counter()
    rows = {job: f.result(timeout=600) for job, f in futures.items()}
    wall_s = time.perf_counter() - t0
    card = torch.cuda.get_device_properties(0).total_memory
    qwen = {}
    for mode, peft in (("zero3", False), ("fcdp", False), ("zero3", True),
                       ("fcdp", True)):
        rid = mode + ("_peft" if peft else "")
        r = rows[("cell", "qwen2.5-3b", mode, peft, 0, None)]
        want, flops = JAX_QWEN_TRAIN_4K[rid]
        check(r["collective_bytes"] == want,
              f"qwen2.5-3b {rid}: dry-run bytes {r['collective_bytes']} != "
              f"the JAX trace's {want}")
        rel = r["flops_per_chip"] / flops - 1.0
        check(abs(rel) <= DRYRUN_FLOPS_RTOL,
              f"qwen2.5-3b {rid}: FLOPs a chip {r['flops_per_chip']} not "
              f"within {DRYRUN_FLOPS_RTOL} of the JAX trace's {flops}")
        qwen[rid] = dict(r, flops_rel_to_jax=rel)
    ag = {k: r["collective_bytes"]["all_gather/pod"] for k, r in qwen.items()}
    ratios = {"fcdp_over_zero3": ag["fcdp"] / ag["zero3"],
              "fcdp_peft_over_zero3_peft": ag["fcdp_peft"] / ag["zero3_peft"]}
    check(ratios["fcdp_over_zero3"] < 0.6
          and ratios["fcdp_peft_over_zero3_peft"] < 0.01,
          f"the paper's ratios on the dry run: {ratios}")
    archs = {}
    for job, r in rows.items():
        if job[0] != "cell" or job[5] is None:
            continue
        archs[job[1]] = {
            "layers": r["layers"],
            "all_gather_pod": r["collective_bytes"].get("all_gather/pod", 0.0),
            "pod_total": _pod_total(r), "flops_per_chip": r["flops_per_chip"],
            "peak_est_bytes": r["memory"]["peak_est_bytes"],
            "host_bytes": r["memory"]["host_bytes"],
            "peak_over_card": r["memory"]["peak_est_bytes"] / card,
            "roofline": r["roofline"], "trace_s": r["trace_s"]}
    check(len(archs) == 10, f"dry-run rows of {sorted(archs)}")
    dry = rows[("train_fcdp",)]
    r0 = train_fcdp[0]
    measured = {k: v for k, v in r0["bytes"][0].items() if v}
    check(dry["collective_bytes"] == measured,
          f"phase train's fcdp arm: dry-run bytes {dry['collective_bytes']} "
          f"!= the measured {measured}")
    peaks = [max(p for part, (p, _) in r["memory"][0].items()
                 if part != "start") for r in train_fcdp]
    ratio = dry["memory"]["peak_est_bytes"] / max(peaks)
    emit("dryrun", mesh={"pod": 2, "data": 16, "model": 16},
         workers=DRYRUN_WORKERS, wall_s=wall_s, card_bytes=card,
         qwen={k: {"all_gather_pod": ag[k], "pod_total": _pod_total(r),
                   "flops_per_chip": r["flops_per_chip"],
                   "flops_rel_to_jax": r["flops_rel_to_jax"],
                   "peak_est_bytes": r["memory"]["peak_est_bytes"],
                   "host_bytes": r["memory"]["host_bytes"],
                   "peak_over_card": r["memory"]["peak_est_bytes"] / card,
                   "roofline": r["roofline"], "trace_s": r["trace_s"]}
               for k, r in qwen.items()},
         paper_ratios=ratios, archs=archs,
         train_fcdp={"bytes_equal": True, "memory": dry["memory"],
                     "measured_step_peak": peaks, "peak_ratio": ratio,
                     "peak_ratio_in_0.85_1.15": 0.85 <= ratio <= 1.15,
                     "trace_s": dry["trace_s"]})


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the port (src/repro_torch) is not beside "
              f"{Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuBLAS keeps bf16 reductions in fp32 (the plain version's sums)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from repro_torch.kernels import _build

    workers = dryrun_pool()
    gpu = gpu_line()
    t0 = time.perf_counter()
    built = _build.build()
    emit("device", gpu=gpu, torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         build_s=time.perf_counter() - t0, built=built,
         ptxas={n: ptxas_summary(_build.library_path(n).with_suffix(".log"))
                for n in _build.SOURCES})

    prefill, decode, flash_jamba = phase_kernels()
    int8_main, int8_extra, int8_passes = phase_int8_kernels()
    mm_main, mm_extra = phase_mm_kernels()
    wkv_prefill, wkv_decode = phase_wkv_kernels()
    scan_prefill, scan_decode = phase_mamba_kernels()
    flash_arch = phase_arch_kernels()
    flash_encdec = phase_encdec_kernels()
    launches = phase_serve()
    phase_profile()
    phase_parity()
    wkv_launches = phase_rwkv_serve()
    phase_rwkv_parity()
    jamba_launches = phase_jamba_serve()
    phase_jamba_parity()
    arch_launches = phase_arch_serve()
    encdec_launches = phase_encdec_serve()
    (train_launches, train_fcdp_bytes, dense_ckpt, sched_results,
     train_fcdp) = phase_train(sched_runs())
    family_parity = phase_train_parity()
    peft_launches, peft_restart = phase_peft_train(train_fcdp_bytes)
    phase_restart(dense_ckpt, peft_restart)
    phase_peft_parity()
    tp_launches = phase_tp_train()
    tp2_parity = tp2_parity_jobs()
    phase_tp_parity(tp2_parity["tp"])
    sched_launches = phase_sched_train(train_fcdp_bytes, sched_results,
                                       train_fcdp)
    phase_sched_parity(tp2_parity["sched"])
    family_arms = family_runs()
    arch_arms = arch_train_runs()
    encdec_arms = encdec_train_runs()
    cache = cache_runs()
    stream_launches, extra, stream_ranks, stream_wall = phase_stream_train(
        [mr for _, _, mr in family_arms] + [mr for _, mr in arch_arms]
        + [mr for _, mr in encdec_arms] + cache, task=_cache_task)
    n_fam, n_arch, n_enc = len(family_arms), len(arch_arms), len(encdec_arms)
    family_results, arch_results, encdec_results, cache_results = (
        extra[:n_fam], extra[n_fam:n_fam + n_arch],
        extra[n_fam + n_arch:n_fam + n_arch + n_enc],
        extra[n_fam + n_arch + n_enc:])
    phase_stream_parity(tp2_parity["stream"])
    cache_launches = phase_cache_train(cache_results, stream_ranks,
                                       stream_wall)
    family_launches, scan_adjoint = phase_family_train(family_arms,
                                                       family_results)
    phase_family_parity(family_parity)
    phase_arch_train(arch_arms, arch_results)
    n_fp, n_ap = len(FAMILY_PARITY_MODELS), len(ARCH_SERVE_DEPTH)
    phase_arch_parity({dev: rs[n_fp:n_fp + n_ap]
                       for dev, rs in family_parity.items()})
    encdec_train = phase_encdec_train(encdec_arms, encdec_results)
    phase_encdec_parity({dev: rs[n_fp + n_ap]
                         for dev, rs in family_parity.items()})
    # after every timed phase: the workers would share the host with it
    phase_dryrun(start_dryrun(workers), train_fcdp)

    def entry(c):
        # the redesigned kernels also carry the variant each shape took,
        # their device time (a CUDA graph), their host time per call and
        # the copies of the inputs their timings took in turn
        return {k: c[k] for k in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms",
                                  "variant", "device_ms", "host_us",
                                  "copies")
                if k in c}
    kernels = {"kernels": [{
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_TPU_KERNEL,
        "launches": launches + cache_launches["flash_attention"]
        + arch_launches + encdec_launches,
        **entry(prefill), "shape": "prefill_chunk",
        "decode": entry(decode),
        "jamba_launches": jamba_launches["flash_attention"],
        "jamba_shapes": {n: entry(c) for n, c in flash_jamba.items()},
        "arch_launches": arch_launches,
        "arch_shapes": {n: entry(c) for n, c in flash_arch.items()},
        "encdec_launches": encdec_launches,
        "encdec_shapes": {n: entry(c) for n, c in flash_encdec.items()}}
    ] + [{
            "name": QUANT_NAMES[k], "route": "cuda", "source": QUANT_SOURCE,
            "replaces": QUANT_TPU_KERNELS[k],
            "launches": train_launches[k] + peft_launches[k]
            + tp_launches[k] + sched_launches[k] + stream_launches[k]
            + cache_launches[k] + family_launches[k] + encdec_train[k],
            **entry(c), "shape": c["case"],
            "other_shapes": {n: entry(e) for n, e in int8_extra.items()
                             if e["kernel"] == QUANT_NAMES[k]},
            "local_passes": {
                p["pass"]: {f: p[f] for f in ("ms", "device_ms", "host_us",
                                              "kernel_device_ms", "bound_ms")}
                for p in int8_passes if p["kernel"] == QUANT_NAMES[k]}}
            for k, c in int8_main.items()] + [{
        "name": "matmul_chunk", "route": "cuda", "source": MM_SOURCE,
        "replaces": MM_TPU_KERNEL,
        "launches": train_launches["matmul_chunk"]
        + tp_launches["matmul_chunk"] + sched_launches["matmul_chunk"]
        + stream_launches["matmul_chunk"] + cache_launches["matmul_chunk"]
        + family_launches["matmul_chunk"] + encdec_train["matmul_chunk"],
        **entry(mm_main),
        "shape": mm_main["case"],
        "other_shapes": {n: entry(e) for n, e in mm_extra.items()}}, {
        "name": "wkv6", "route": "cuda", "source": WKV_SOURCE,
        "replaces": WKV_TPU_KERNEL, "launches": wkv_launches,
        **entry(wkv_prefill), "shape": "prefill",
        "decode": entry(wkv_decode)}, {
        "name": "mamba_scan", "route": "cuda", "source": SCAN_SOURCE,
        "replaces": SCAN_TPU_KERNEL,
        "launches": jamba_launches["mamba_scan"]
        + family_launches["mamba_scan"], **entry(scan_prefill),
        "shape": "prefill", "decode": entry(scan_decode),
        "train_launches": family_launches["mamba_scan"],
        "train_adjoint": scan_adjoint}]}
    print(gpu)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
