"""GPU smoke run of the PyTorch/CUDA port: serving and training.

    python3 chip_smoke.py [--profile]

Needs one CUDA card and ``nvcc``; exits nonzero without them.  Phases, each
fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build the kernels from ``cara_tpu_torch/csrc`` (seconds printed);
3. each kernel wrapper against its plain PyTorch version at ViT-B shapes
   (B=64, N=197, E=768, H=12, hidden 3072, rank 8, bf16 inputs, drop rate
   0.1, two drop-path gates zero for the training kernels; the plain
   reference runs in fp32 with TF32 off): max |error| against the stated
   tolerance, the weight-dropout fold's keep pattern against the plain
   mask bit for bit, and the median time of kernel and plain (the plain
   version on the same bf16 inputs) over 20 runs by CUDA events; then
   row 1 (``fused_qkv_attention``) at B 16 past one 256-key chunk, N =
   257 with keys >= 250 masked and N = 512 (its two-chunk path); row 2
   (its backward) at B 64 past the previous kernel's 352-token cap, N =
   401 and N = 512 with keys >= 500 masked, as entries of their own;
   rows 1 and 2 at VPT's lengths, N = 205 and 397 (``ZOO_FORMS``);
4. the serving path: ViT-B/16 in21k at full width and depth from seed 0
   (tanh pre_logits, 10 classes) with a perturbed order-4 rank-8 CaRA
   adapter at scale 10, saved as an npz checkpoint, then served merged
   and unmerged through ``Predictor.from_checkpoint_auto`` and
   ``InferenceServer``: 96 requests from 8 client threads through the
   micro-batcher, ``/healthz`` and ``/stats`` over HTTP, logits against
   the plain forward on the same weights and merged against unmerged,
   images per second at batch 64; every serving kernel's launch counter
   grew;
5. the training path: ViT-B/16 in21k at full width and depth from seed 0,
   CaRA order 4 rank 8, weight dropout 0.1 (element-wise), drop-path 0.1,
   bf16 compute with fp32 trainables, batch 64: (a) one step's gradients
   of every trainable leaf through the kernels against the fp32 plain
   path on the same weights and the same injected randomness, within
   5e-2 or, where larger, the worst error of the plain path in bf16 over
   that step and eight copies of it with perturbed images, (b) 30
   steps on one fixed synthetic batch (finite, falling loss), (c) ms per
   step by CUDA events, img/s on the host clock and the plain path's ms
   per step, (d) ``cli.vit_cp --synthetic`` for a few epochs, whose best
   checkpoint ``Predictor.from_checkpoint_auto`` then serves; every
   training kernel's launch counter grew;
6. the same for the rank weight-dropout route (the split attention path:
   ``cp_dense_ln``, ``fused_qkv_attention``, ``cp_dense``, then
   ``cp_mlp_block``, each with its backward kernel), 20 steps, and the
   CLI with ``--weight-dropout-impl rank``; then one step's gradients of
   the row route and of weight dropout 0 against the fp32 plain path;
7. the 384-px route (ViT-B/16 at 577 tokens, past the full-score
   attention's 512): the kernel entries of TPU rows 15 and 16 at its
   shapes (the blockwise attention forward and backward,
   ``cp_dense_wd`` / ``cp_dense_ln_wd`` forward and backward, row 15's
   factor gradients; the blockwise forward and backward again at N = 640
   with keys >= 577 masked (zero dk, dv there), and the forward's
   log-sum-exp at both);
   ``vit_base_patch16_384_in21k`` served merged and unmerged as in 4;
   trained with element and with rank weight dropout as in 5 and 6, the
   gradient check at batch 16, 12 timed steps at batch 64.  Over these
   phases the blockwise counters grow and the full-score attention's and
   the attention megakernel's do not;
8. the routes without an adapter: the kernel entries of TPU row 17 (the
   flash attention, forward and backward, on strided q, k, v views of a
   qkv tensor) at N = 197 and N = 577 (run with phase 3's); full
   fine-tuning of ViT-B/16 at 224 px, batch 64, bf16: one step's
   gradient of every leaf (backbone and head) against the fp32 plain
   path as in 5, 20 timed steps on one batch, ``cli.vit_cp --method
   full`` whose checkpoint is served; the linear probe (``--method
   linear``): the gradient check, 10 steps with a falling loss and the
   head as the only leaf that moves; then one full step of ViT-B/16 at
   384 px, batch 16, in which the flash counters grow and the blockwise
   counters do not;
9. activation and attention dropout (run after 6): the kernel entries of
   TPU row 13's GELU body on the fc1 site (``cp_dense_ln(act="gelu")``
   with the rank delta and ``cp_dense_ln_wd(act="gelu")`` on W', forward
   and the dact helper, at B=64, N=197, E=768, hidden 3072, and the W'
   form again at N=577; run with phase 3's); the element and rank routes
   with ``dropout_rate`` 0.1 as in 5 and 6 (30 timed steps each, the
   element CLI with attention dropout 0.1 too), in which the GELU
   counters grow and no block megakernel launches; gradient checks of
   the rank route with attention dropout too (``mha``), of the element
   route at 384 px (batch 16) and of one full fine-tuning step with both
   rates;
10. the rank route's attention-block switches (run after 6): the kernel
   entries of TPU row 3 (``fused_qkv_attention_proj``, the attention and
   the projection site in one kernel), its backward with row 4, and row 6
   (``cp_attn_block``'s backward) at phase 3's shapes (run with phase
   3's), and row 3's forward and backward again at ViT-B's 401 and 512
   tokens (keys >= 500 masked), at CLIP ViT-L/14's E 1024 and at
   ViT-H/14's E 1280 with heads of width 80, 257 tokens
   (``PROJ_FORMS``, run after 15's entries); the unmerged ViT-B forward
   of phase 4's checkpoint at batch 64
   with ``CARA_ATTN_MEGA=0 CARA_ATTNPROJ=1`` (row 3 in every layer,
   logits within 5 % of the default route's); the rank route as in 6
   with ``CARA_ATTN_MEGA=1`` (set in ``models.vit`` around the phase and
   in the environment of a child process that runs the CLI, as JAX reads
   it: at import) and then with ``CARA_ATTN_MEGA=0 CARA_ATTNPROJ=1`` (the
   CLI in this process, its eval through row 3 too), 20 timed steps
   each: under each, the switch's kernels launch and the split route's
   attention wrappers do not; then the default rank route and both
   switched ones timed in turns on one setup (ms per step by CUDA events);
11. quantized serving and the whole-block eval kernel (run after 4, on
   its checkpoint): the kernel entries of TPU row 18 (``int8_dense``, the
   dequant-fused int8 GEMM) at M = 12608 and 197 for the qkv (768 ->
   2304) and fc2 (3072 -> 768) sites and at M = 16448 and 257 for
   ViT-H/14's (1280 -> 3840, 5120 -> 1280), with
   ``torch._weight_int8pack_mm`` as the yardstick (``torch.matmul`` on
   the codes dequantized in advance printed beside it), of row 14 at
   ViT-H/14's widths (a layer's four folds in two grouped launches;
   ViT-B's are phase 3's), and of row 19 (``block_pair_fwd``) at phase 3's
   shapes, also against the port's split halves (rows 5 and 9) on the
   card, whose time is its yardstick (run with phase 3's); the
   checkpoint served through ``Predictor.from_checkpoint_auto`` merged
   with ``quantize="int8"`` and ``"w8a8"`` and unmerged with ``"int8"``,
   each bucket's forward with ``CARA_INT8_PALLAS`` unset and set (row 18
   launches 48 times a forward on the weight-only modes with it, never
   without it or on w8a8), logits against the unquantized bf16
   ``Predictor`` with the JAX package's bounds (``QUANT_BOUNDS``, argmax
   agreement >= 0.9 on 64 images), img/s at batch 64 and the batch-1
   latency on the host clock; ``python -m cara_tpu_torch.cli.serve
   --quantize int8`` in a child with ``CARA_INT8_PALLAS=1`` answering 8
   PNG requests over HTTP (``/stats`` counts them; its row 18 counter
   is 48 for each forward it ran); then the unmerged ViT-B forward with
   every block through row 19 (once a layer), its logits within 5 % of
   the default route's;
12. the GEMM core (``csrc/sm90_gemm.cuh``) alone, run with phase 3's:
   row 11's five products at B 64, N 197 (``grad_gemm.cu``: NN with the
   PRE_GELU epilogue, NT with DGELU, NT dxa, the two TN dT products;
   launches: the element training phase) and the forward site's six
   forms (``cp_site.cu`` with the LayerNorm row pass: qkv with LN1, proj
   and fc2 with the residual, fc1 with LN2 and the GELU, fc1's dact,
   and fc1 writing its bf16 pre-activation beside h; delta scale 1.5;
   launches: adapter serving, the dact mode the rank route with
   dropout, the pre-activation form the element training phase)
   against their fp32 plain versions, timed beside
   ``torch.matmul`` on the same bf16 operands; then determinism: the
   backwards of rows 2 (N 197, 512), 16 (N 577) and 17 (N 197, 577)
   called twice at B 64 give dq, dk and dv bit for bit, the six site
   forms their outputs, and two runs of two rank steps of ViT-B at 224
   px from one state and seed end with every trainable leaf bit for
   bit;
13. the saved-residual modes (run after 6): by default, as on the TPU,
   the training forwards keep the MLP block's pre-activation
   (``CARA_MLP_SAVE_PRE``) and the attention block's qkv and output
   (``CARA_ATTN_SAVE_QKV``), and the backwards of rows 8, 10 and 11 read
   them (the ``*_saved`` entries of phase 3, held against their plain
   twins at the saved rounding points; the recompute entries run with
   both switches "0"), and no recompute form (nor its NN PRE_GELU or NT
   DGELU product) launches on the default element and rank routes at
   224 or 384 px; the element and rank steps at 224 px with both
   switches "0" (every recompute form launches, no saved one, no fc1
   site writes its pre-activation), then both forms timed in turns on
   one setup, with the peak memory of each, and two such steps of each
   route at 384 px (rows 10 and 11's recompute forms at N 577).
   Serving writes no saved residual.  Every training phase prints its
   peak memory;
14. CLIP ViT-L/14 (``vit_large_patch14_224_clip``: E 1024, 16 heads,
   hidden 4096, 257 tokens, ``ln_pre``, LayerNorm eps 1e-5, a 768-wide
   projection before the 10-class head, quick_gelu in every MLP block)
   at full width and 12 of its 24 layers (``CLIP_DEPTH``), run after 9
   (``clip_phase``): the
   quick_gelu forms' entries (``QUICK_FORMS``: rows 9, 10 and 11 whole in
   the saved forms, row 13's body and dact, the fc1 site with and
   without its pre output and its dact, ``grad_gemm.cu``'s ``DGELU_H``,
   ``PRE_GELU`` and ``DGELU``) at M = 64 x 257, K 1024 / N 4096 and K
   4096 / N 1024, and row 19 with quick_gelu at phase 3's ViT-B shapes
   and at CLIP's (``PAIR_FORMS``: B 64, N 257, E 1024, 16 heads, hidden
   4096, LayerNorm eps 1e-5, also against the split halves), each against
   its fp32 plain version (run with phase 3's); then CLIP
   served merged and unmerged as in 4, then unmerged with every block
   through row 19 (its quick_gelu form once a layer, logits within 5 % of
   the default route's), trained on the element and rank
   routes as in 5 and 6 (gradient check at batch 16, 14 timed steps at
   batch 64, peak memory), two steps of each with both saved-residual
   switches "0", two rank steps with ``dropout_rate`` 0.1 (row 13's
   quick_gelu body), and ``cli.vit_cp --model vit_large_patch14_224_clip``
   in a child; the quick_gelu forms launch, the GELU forms never, and the
   recompute forms only with the switches "0";
15. ViT-H/14 (``vit_huge_patch14_224_in21k``: E 1280, 16 heads of width
   80, hidden 5120, 257 tokens) at full width and 16 of its 32 layers
   (``HUGE_DEPTH``), run after 14 (``huge_phase``): the kernel entries
   of rows 1 (N 257, 401, 512), 2 (257, 512), 16 (577) and 17 (257, 577)
   at head width 80,
   and of row 17 at 16 and 32 (``DH_FORMS``, run with phase 3's, beside
   SDPA; launches: the ViT-H phase, and the test model's full steps for
   16 and 32, ``narrow_flash_phase``, run with 8), and of row 19 at B 64,
   N 257, E 1280, 16 heads of 80, hidden 5120 (``PAIR_FORMS``, also
   against the split halves), determinism of rows 2, 16 and 17 at Dh 80
   (run with 12); then ViT-H served merged and unmerged at batch 64,
   unmerged with every block through row 19 (logits within 5 % of the
   default route's), and merged weight-only int8 with and without
   ``CARA_INT8_PALLAS=1`` (row 18 128 times a forward, ``QUANT_BOUNDS``
   against the bf16 Predictor, img/s), the element and rank routes
   (gradient check at batch 16, 10 timed steps at batch 64, peak
   memory), full fine-tuning
   through row 17 (gradient check of every leaf at batch 8, 10 steps),
   two rank steps under ``CARA_ATTN_MEGA=1``, the rank route under
   ``CARA_ATTN_MEGA=0 CARA_ATTNPROJ=1`` (rows 3 and 4: the gradient check
   at batch 16, four steps at batch 64 timed in turns with the default
   rank route over three rounds, row 3 and its backward once a layer a
   step and the split projection site never, the unmerged eval at batch
   64 within 5 % of the default route's logits), at 336 px (577 tokens:
   row 16) served at batch 16 with a rank gradient check at batch 4,
   four steps and a full step, and ``cli.vit_cp --model
   vit_huge_patch14_224_in21k`` in a child (at full width, 8 layers);
   after the full fine-tuning step (its gradient check with remat on),
   the step with remat on, off, and as 8 microbatches of 8, in turns;
16. the training CLI's single-device features (run after 6): gradient
   accumulation on the element route at batch 64 (``accum_phase``: the
   accumulated 4 x 16 step's gradients against the fp32 plain path's
   accumulated step, every leaf within 5's bound, then 4 x 16 and one
   pass of 64 timed in turns with their peak memory); ``--nan-check``
   (``nan_phase``: a batch with one NaN image raises
   ``FloatingPointError``, the checked and unchecked steps in turns);
   resume and preemption through the CLI (``resume_phase``: a ViT-B/16
   child with ``--resume-dir --memory-report --profile-dir`` gets
   SIGTERM after its first logged step and exits 0 with "Preempted
   (SIGTERM) at step k", ``latest_step`` reads k, the relaunch with
   ``--compilation-cache`` at a copy of the built library loads it
   without building, resumes from step k and runs to its end; the
   digests of the saved, the written and the restored state agree; the
   trace holds the sites' and products' ``gemm_kernel``, the attention
   and the fold); then on the relaunch's checkpoint
   (``export_phase``) ``cli.export`` merged / adapter / full, the merged
   arrays against an fp32 merge on the card (1e-6 of each array's
   largest value, with a merge at half the scale and the unmerged
   backbone as controls that must miss it), the merged export served
   against ``merge=True`` (1 %), ``--evaluate
   --merged-eval`` and ``cli.predict`` on PNG files; full fine-tuning of
   ViT-B (8) with its gradient check repeated with remat off, then timed
   with remat on and off (``remat_phase``);
17. multi-task serving (run after 11, ``multitask_phase``): three CaRA
   tasks (delta scales 0.1, 10 and 100; 2, 10 and 102 classes) over one
   ViT-B/16 backbone at full width and depth in a ``MultiTaskPredictor``
   at batch 64: each task's logits within 5 % of its fp32 plain forward,
   the same bits with the tasks asked in the other order, rows 1, 5 and 9
   launched, one task with every block through row 19; a stream of 288
   requests over the three tasks through ``InferenceServer`` (one
   batcher a task; img/s, ``/stats`` per task, ``POST /predict?task=``
   and its 400 / 404); the group and a single-task adapter ``Predictor``
   timed in turns; the group with ``quantize="int8"`` within
   ``QUANT_BOUNDS``, row 18 launching 4 x 12 times a forward with
   ``CARA_INT8_PALLAS=1``; ``python -m cara_tpu_torch.cli.serve`` in a
   child with two ``name=path`` adapter-only checkpoints and
   ``--backbone`` (a Google-format npz);
18. CP orders (run after 6, ``orders_phase``): ViT-B/16 at full width and
   depth, rank 16, batch 64, on the element route at orders 3 and 5, the
   rank route at order 5, order 2 and order 4 with the materialized
   delta (the XLA dense forms): each one step's gradient check as in 5
   on 16 images, 10 steps on one batch (a falling loss, ms a step by
   CUDA events against order 4's element step, peak memory), the route's
   kernels launched (the dense deltas launch only the attention's), the
   eval forward within 5 % of fp32 plain; then ``python -m
   cara_tpu_torch.cli.dim_experiment --synthetic --dims 5 --ranks 32``
   in a child at 4 layers, preempted by SIGTERM and relaunched to its
   end;
19. interop (``interop_phase`` after 16 on its checkpoint,
   ``clip_import_phase`` after 14): ``cli.export --mode torch`` writes the
   reference's ``.pt``, which reads back to the same arrays, evaluates
   (``cli.vit_cp --evaluate X.pt`` in a child) to the npz's accuracy and
   exports merged to the npz's merged arrays bit for bit; a
   HuggingFace-layout CLIP ViT-L/14 state dict written from seed at full
   width and depth, built through ``api.build_model(backbone_path=
   X.bin)``: every array equal, merged serving within 5 % of fp32 plain;
20. LoRA and FacT (``peft_phase``, after the rank-128 phase): ViT-B/16 at
   full width and depth, rank 8, scale 10, batch 64, bf16, each method's
   zero factor perturbed from a seed (``PEFT_STD``); for LoRA, FacT-TT
   and FacT-TK the element route (weight dropout 0.1) and the rate-0
   route through the CaRA sites' kernels: the gradient check as in 5 on
   16 images (LoRA and TK on the element route, TT on rate 0), six steps
   on one batch (a falling loss, ms a step), the launches of rows 1, 2,
   5 and 7-14 over the steps printed as differences; each route's
   methods and CaRA rank 8 timed in turns, with the profiler's device
   time a step; LoRA and FacT-TK served unmerged and merged (each
   within 5 % of fp32 plain, img/s); two LoRA tasks at scales 2 and 8
   through ``MultiTaskPredictor``, each task against its single-task
   ``Predictor``; ``cli.vit_cp --method fact_tk --fact-core-rank 4`` at
   4 layers in a child, its checkpoint exported by ``cli.export --mode
   merged`` and served against the unmerged one;
21. the PEFT zoo (``zoo_phase``, after 20): ViT-B/16 at full width and
   depth, bf16, batch 64, seed 0; VPT-Deep and VPT-Shallow (8 prompts,
   205 tokens), SSF, BitFit, Houlsby and AdaptFormer (width 8, internal
   dropout 0.1, AdaptFormer at scale 0.1), their zero leaves perturbed
   from a seed (``ZOO_STD``): each method's gradient check as in 5 on 16
   images and six steps on one batch (a falling loss, ms a step), rows 1
   and 2 launched and no CaRA site; the methods and CaRA rank 8 timed in
   turns with the profiler's device time a step; each served from its
   checkpoint unmerged and with ``merge=True`` (SSF and BitFit fold, the
   others stay unmerged), within 5 % of the unmerged fp32 plain forward,
   row 1 launched 12 times a forward; SSF unmerged with
   ``quantize="int8"`` and ``CARA_INT8_PALLAS=1`` (row 18, within
   ``QUANT_BOUNDS``); SSF exported merged by ``cli.export`` and served
   against the unmerged checkpoint, VPT refused; VPT-Deep at 200 prompts
   (397 tokens) and at 384 px (585 tokens: row 16, not rows 1 and 2):
   the gradient check and three steps on 8 images.  Rows 1 and 2 at 205
   and 397 tokens are entries of the ``kernels`` line;
22. ToMe (``tome_phase``, after 11, on the serving checkpoint merged):
   at r 0, 8 and 13 the bf16 forward within 5 % of the port's fp32 plain
   ``tome_forward`` at the same r, no kernel of the port launched, two
   calls bit for bit; img/s in turns with merged serving and a forward's
   device time by kernel; ``quantize="int8"`` at r 8 with
   ``CARA_INT8_PALLAS=1``: row 18 48 launches a forward, within
   ``QUANT_BOUNDS``, its device time a launch and its entries at the last
   layer's M (printed, not in the ``kernels`` line); ``cli.serve --tome-r
   8`` in a child answers requests;
23. CaRA's mixture of experts (``moe_phase``, after 21): ViT-B/16 at full
   width and depth, bf16, batch 64, 4 experts routed top 2, rank 8 on
   the rank route, scale 10: the gradient check as in 5 on 16 images
   (router included), six steps (a falling loss with the aux term, peak
   memory), rows 1 and 2 launched and no other kernel; timed in turns
   with CaRA rank 8 on its fused sites and at ``dense_impl="xla"``, with
   the profiler's device time a step; served with ``merge=True`` (kept
   unmerged) within 5 % of fp32 plain; ``merge_cara`` and
   ``MultiTaskPredictor`` refuse it; ``cli.vit_cp --moe 4,2`` at 4 layers
   in a child, and ``--evaluate`` of its checkpoint without ``--moe``.

Each kernel entry also carries its bound: the least time the card could
take for the work at these inputs (the larger of its operations over the
bf16 tensor-core peak and its bytes, each input read and each output
written once, over the memory rate), and, for the attention forwards and
backwards, the time of ``F.scaled_dot_product_attention`` on the same
inputs (a yardstick only; the port never calls it), for row 18
``torch._weight_int8pack_mm``; row 19 has none and carries
``split_ms``, the time of rows 5 and 9 on the same block.  The line
before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.

``--profile`` only builds and then prints the device time by kernel of
five ViT-B element steps as 4 microbatches of 16 and of ViT-H/14 full
fine-tuning with remat on, off and as 8 microbatches of 8, then of
five ViT-B train steps of the element and of the rank route, at 224 and
at 384 px (at 224 px also with both saved-residual switches "0"), of
the same two routes of CLIP ViT-L/14 and of ViT-H/14, of
full fine-tuning (remat on, JAX's "auto", and off) and the linear probe
at 224 px, of the element and
rank routes with activation dropout 0.1 at 224 px, and of
the rank route under each attention-block switch (``torch.profiler``),
with the busy share; then merged serving at batch 64 in bf16, int8 with
and without ``CARA_INT8_PALLAS=1`` and w8a8 (also with row-major codes):
img/s in turns and a forward's device time by kernel.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from cara_tpu_torch import api
from cara_tpu_torch.cli import dim_experiment as dim_cli
from cara_tpu_torch.cli import export as export_cli
from cara_tpu_torch.cli import predict as predict_cli
from cara_tpu_torch.cli import vit_cp as vit_cp_cli
from cara_tpu_torch.config import (LORA_FAMILY, NO_ADAPTER, CaraConfig,
                                   get_model_config)
from cara_tpu_torch.data.vtab import load_image_u8, normalize
from cara_tpu_torch.models import cara as cara_lib
from cara_tpu_torch.models import convert
from cara_tpu_torch.models import quant as quant_lib
from cara_tpu_torch.models import tome as tome_lib
from cara_tpu_torch.models import torch_import
from cara_tpu_torch.models import vit as vit_lib
from cara_tpu_torch.models.merge import merge_cara
from cara_tpu_torch.models.vit import vit_forward
from cara_tpu_torch.ops.cuda import _build, _bwd, _site, wd_fold
from cara_tpu_torch.ops.cuda import block_pair as pair_mod
from cara_tpu_torch.ops.cuda import blockwise_attention as bwa_mod
from cara_tpu_torch.ops.cuda import cp_attn_block as attn_mod
from cara_tpu_torch.ops.cuda import cp_dense as dense_mod
from cara_tpu_torch.ops.cuda import cp_mlp as mlp_mod
from cara_tpu_torch.ops.cuda import flash_attention as flash_mod
from cara_tpu_torch.ops.cuda import fused_qkv_attention as fqa_mod
from cara_tpu_torch.ops.cuda import int8_dense as int8_mod
from cara_tpu_torch.ops.layers import activation, activation_grad, layer_norm
from cara_tpu_torch.server import InferenceServer
from cara_tpu_torch.serving import MultiTaskPredictor, Predictor
from cara_tpu_torch.train import checkpoint as ckpt_lib
from cara_tpu_torch.train import steps as steps_lib
from cara_tpu_torch.train.checkpoint import save_model

MODEL = "vit_base_patch16_224_in21k"
# name -> (module, launch counter, source, TPU kernel replaced).
KERNELS = {
    "fused_qkv_attention": (
        fqa_mod, "LAUNCHES", "cara_tpu_torch/csrc/qkv_attention.cu",
        "cara_tpu/ops/pallas/fused_qkv_attention.py:200"),
    "cp_attn_block": (
        attn_mod, "LAUNCHES", "cara_tpu_torch/csrc/cp_site.cu",
        "cara_tpu/ops/pallas/cp_attn_block.py:305"),
    "cp_mlp_block": (
        mlp_mod, "LAUNCHES", "cara_tpu_torch/csrc/cp_site.cu",
        "cara_tpu/ops/pallas/cp_mlp.py:253"),
    "build_wd_weight": (
        wd_fold, "LAUNCHES", "cara_tpu_torch/csrc/wd_fold.cu",
        "cara_tpu/ops/pallas/cp_dense.py:565"),
    # Row 14 at ViT-H/14's widths (launches: its element training).
    "build_wd_weight_huge": (
        wd_fold, "LAUNCHES", "cara_tpu_torch/csrc/wd_fold.cu",
        "cara_tpu/ops/pallas/cp_dense.py:565"),
    "cp_attn_block_wd": (
        attn_mod, "WD_LAUNCHES", "cara_tpu_torch/csrc/cp_site.cu",
        "cara_tpu/ops/pallas/cp_attn_block.py:521"),
    "cp_attn_block_wd_bwd": (
        attn_mod, "WD_BWD_LAUNCHES",
        "cara_tpu_torch/csrc/qkv_attention_bwd.cu",
        "cara_tpu/ops/pallas/cp_attn_block.py:578"),
    "cp_mlp_block_wd_bwd": (
        mlp_mod, "WD_BWD_LAUNCHES", "cara_tpu_torch/csrc/grad_gemm.cu",
        "cara_tpu/ops/pallas/cp_mlp.py:579"),
    "cp_dense": (
        dense_mod, "LAUNCHES", "cara_tpu_torch/csrc/cp_site.cu",
        "cara_tpu/ops/pallas/cp_dense.py:356"),
    "cp_dense_dx": (
        dense_mod, "DX_LAUNCHES", "cara_tpu_torch/csrc/grad_gemm.cu",
        "cara_tpu/ops/pallas/cp_dense.py:273"),
    "fused_qkv_attention_bwd": (
        fqa_mod, "BWD_LAUNCHES", "cara_tpu_torch/csrc/qkv_attention_bwd.cu",
        "cara_tpu/ops/pallas/fused_qkv_attention.py:230"),
    # Row 2's backward past 352 tokens (ROW2_EDGES; launches: the rank
    # route at 224 px, the same kernel).
    "fused_qkv_attention_bwd_401": (
        fqa_mod, "BWD_LAUNCHES", "cara_tpu_torch/csrc/qkv_attention_bwd.cu",
        "cara_tpu/ops/pallas/fused_qkv_attention.py:230"),
    "fused_qkv_attention_bwd_512": (
        fqa_mod, "BWD_LAUNCHES", "cara_tpu_torch/csrc/qkv_attention_bwd.cu",
        "cara_tpu/ops/pallas/fused_qkv_attention.py:230"),
    "cp_mlp_block_bwd": (
        mlp_mod, "BWD_LAUNCHES", "cara_tpu_torch/csrc/grad_gemm.cu",
        "cara_tpu/ops/pallas/cp_mlp.py:292"),
    # Rows 8, 11 and 10 in the TPU's default saved-residual modes: the
    # backward reads the qkv and attention output, or the pre-activation,
    # its forward kept (launches: the element and rank training phases).
    # The three entries above are the recompute forms, both switches "0"
    # (launches: the recompute phase).
    "cp_attn_block_wd_bwd_saved": (
        attn_mod, "WD_BWD_SAVED_LAUNCHES",
        "cara_tpu_torch/csrc/qkv_attention_bwd.cu",
        "cara_tpu/ops/pallas/cp_attn_block.py:578"),
    "cp_mlp_block_wd_bwd_saved": (
        mlp_mod, "WD_BWD_SAVED_LAUNCHES", "cara_tpu_torch/csrc/grad_gemm.cu",
        "cara_tpu/ops/pallas/cp_mlp.py:579"),
    "cp_mlp_block_bwd_saved": (
        mlp_mod, "BWD_SAVED_LAUNCHES", "cara_tpu_torch/csrc/grad_gemm.cu",
        "cara_tpu/ops/pallas/cp_mlp.py:292"),
    "blockwise_qkv_attention": (
        bwa_mod, "LAUNCHES", "cara_tpu_torch/csrc/blockwise_attention.cu",
        "cara_tpu/ops/pallas/blockwise_attention.py:228"),
    "blockwise_qkv_attention_bwd": (
        bwa_mod, "BWD_LAUNCHES",
        "cara_tpu_torch/csrc/blockwise_attention_bwd.cu",
        "cara_tpu/ops/pallas/blockwise_attention.py:279"),
    "cp_dense_wd": (
        dense_mod, "WD_LAUNCHES", "cara_tpu_torch/csrc/cp_site.cu",
        "cara_tpu/ops/pallas/cp_dense.py:356"),
    "cp_dense_wd_bwd": (
        dense_mod, "WD_BWD_LAUNCHES", "cara_tpu_torch/csrc/grad_gemm.cu",
        "cara_tpu/ops/pallas/cp_dense.py:273"),
    "cp_wd_factor_grads": (
        wd_fold, "FACTOR_LAUNCHES", "cara_tpu_torch/csrc/wd_factor_grads.cu",
        "cara_tpu/ops/pallas/cp_dense.py:663"),
    # Row 17 at N = 197 (launches: the full fine-tuning phase at 224 px)
    # and at N = 577 (launches: the full step at 384 px).
    "flash_attention": (
        flash_mod, "LAUNCHES", "cara_tpu_torch/csrc/flash_attention.cu",
        "cara_tpu/ops/pallas/flash_attention.py:146"),
    "flash_attention_bwd": (
        flash_mod, "BWD_LAUNCHES",
        "cara_tpu_torch/csrc/flash_attention_bwd.cu",
        "cara_tpu/ops/pallas/flash_attention.py:176"),
    "flash_attention_577": (
        flash_mod, "LAUNCHES", "cara_tpu_torch/csrc/flash_attention.cu",
        "cara_tpu/ops/pallas/flash_attention.py:146"),
    "flash_attention_bwd_577": (
        flash_mod, "BWD_LAUNCHES",
        "cara_tpu_torch/csrc/flash_attention_bwd.cu",
        "cara_tpu/ops/pallas/flash_attention.py:176"),
    # Row 13's GELU body, the fc1 site once activation dropout turns the
    # MLP megakernel off: the LN form with the rank delta (launches: the
    # rank route with dropout), the W' form (the element route at 224 px
    # and, suffixed, at 384 px), forward and dact each.
    "cp_dense_gelu": (
        dense_mod, "ACT_LAUNCHES", "cara_tpu_torch/csrc/cp_site.cu",
        "cara_tpu/ops/pallas/cp_dense.py:356"),
    "cp_dense_dact": (
        dense_mod, "DACT_LAUNCHES", "cara_tpu_torch/csrc/cp_site.cu",
        "cara_tpu/ops/pallas/cp_dense.py:356"),
    "cp_dense_wd_gelu": (
        dense_mod, "ACT_LAUNCHES", "cara_tpu_torch/csrc/cp_site.cu",
        "cara_tpu/ops/pallas/cp_dense.py:356"),
    "cp_dense_wd_dact": (
        dense_mod, "DACT_LAUNCHES", "cara_tpu_torch/csrc/cp_site.cu",
        "cara_tpu/ops/pallas/cp_dense.py:356"),
    "cp_dense_wd_gelu_577": (
        dense_mod, "ACT_LAUNCHES", "cara_tpu_torch/csrc/cp_site.cu",
        "cara_tpu/ops/pallas/cp_dense.py:356"),
    "cp_dense_wd_dact_577": (
        dense_mod, "DACT_LAUNCHES", "cara_tpu_torch/csrc/cp_site.cu",
        "cara_tpu/ops/pallas/cp_dense.py:356"),
    # The rank route's attention-block switches: CARA_ATTNPROJ=1 runs row
    # 3 (the attention and the projection in one kernel) and its backward
    # with row 4; CARA_ATTN_MEGA=1 the attention megakernel's backward,
    # row 6 (launches: the rank phases under each switch).
    "fused_qkv_attention_proj": (
        fqa_mod, "PROJ_LAUNCHES", "cara_tpu_torch/csrc/attn_proj.cu",
        "cara_tpu/ops/pallas/fused_qkv_attention.py:312"),
    "fused_qkv_attention_proj_bwd": (
        fqa_mod, "PROJ_BWD_LAUNCHES",
        "cara_tpu_torch/csrc/qkv_attention_bwd.cu",
        "cara_tpu/ops/pallas/fused_qkv_attention.py:380"),
    "cp_attn_block_bwd": (
        attn_mod, "BWD_LAUNCHES", "cara_tpu_torch/csrc/qkv_attention_bwd.cu",
        "cara_tpu/ops/pallas/cp_attn_block.py:356"),
    # Row 18, the dequant-fused int8 GEMM of quantized serving with
    # CARA_INT8_PALLAS=1, at the qkv site and the fc2 site, batch 64 and
    # batch 1 (the split contraction), of ViT-B (768 -> 2304, 3072 ->
    # 768) and ViT-H/14 (1280 -> 3840, 5120 -> 1280) (launches: each
    # model's quantized serving, every site of every layer).
    **{"int8_dense" + suffix: (
        int8_mod, "LAUNCHES", "cara_tpu_torch/csrc/int8_dense.cu",
        "cara_tpu/ops/pallas/int8_dense.py:64")
       for suffix in ("", "_m197", "_fc2", "_fc2_m197", "_huge",
                      "_huge_m257", "_huge_fc2", "_huge_fc2_m257")},
    # Row 19, the whole-block eval kernel (launches: the unmerged ViT-B
    # forward with every block through it).
    "block_pair_fwd": (
        pair_mod, "LAUNCHES", "cara_tpu_torch/csrc/block_pair.cu",
        "cara_tpu/ops/pallas/block_pair.py:88"),
    # The GEMM core of the block backwards alone, at row 11's products
    # (M = 12608, E 768, hidden 3072; launches: the element training
    # phase, every launch of that layout and epilogue, the attention
    # block's included; for the recompute form's NN PRE_GELU and NT
    # DGELU the recompute phase), the saved form's NT DGELU_H among them.
    "grad_gemm_nn_pre_gelu": (
        _bwd, "LAUNCHES_NN_PRE_GELU", "cara_tpu_torch/csrc/grad_gemm.cu",
        "cara_tpu/ops/pallas/cp_mlp.py:579"),
    "grad_gemm_nt_dgelu": (
        _bwd, "LAUNCHES_NT_DGELU", "cara_tpu_torch/csrc/grad_gemm.cu",
        "cara_tpu/ops/pallas/cp_mlp.py:579"),
    "grad_gemm_nt_dgelu_h": (
        _bwd, "LAUNCHES_NT_DGELU_H", "cara_tpu_torch/csrc/grad_gemm.cu",
        "cara_tpu/ops/pallas/cp_mlp.py:579"),
    "grad_gemm_nt_dxa": (
        _bwd, "LAUNCHES_NT_F32", "cara_tpu_torch/csrc/grad_gemm.cu",
        "cara_tpu/ops/pallas/cp_mlp.py:579"),
    "grad_gemm_tn_dt1": (
        _bwd, "LAUNCHES_TN_F32", "cara_tpu_torch/csrc/grad_gemm.cu",
        "cara_tpu/ops/pallas/cp_mlp.py:579"),
    "grad_gemm_tn_dt2": (
        _bwd, "LAUNCHES_TN_F32", "cara_tpu_torch/csrc/grad_gemm.cu",
        "cara_tpu/ops/pallas/cp_mlp.py:579"),
    # The forward CaRA site alone (csrc/cp_site.cu on the wgmma core of
    # sm90_gemm.cuh, z folded in; the LayerNorm row pass of block_rows.cu
    # before it on an LN site) at ViT-B's five forms, M = 12608
    # (launches: adapter serving for the four block sites, rows 5 and 9
    # in every layer, by epilogue; the rank route with dropout for the
    # dact mode).
    "cp_site_qkv_ln": (
        _site, "LAUNCHES_BF16", "cara_tpu_torch/csrc/cp_site.cu",
        "cara_tpu/ops/pallas/cp_attn_block.py:305"),
    "cp_site_proj_res": (
        _site, "LAUNCHES_RES", "cara_tpu_torch/csrc/cp_site.cu",
        "cara_tpu/ops/pallas/cp_attn_block.py:305"),
    "cp_site_fc1_ln_gelu": (
        _site, "LAUNCHES_GELU", "cara_tpu_torch/csrc/cp_site.cu",
        "cara_tpu/ops/pallas/cp_mlp.py:253"),
    "cp_site_fc2_res": (
        _site, "LAUNCHES_RES", "cara_tpu_torch/csrc/cp_site.cu",
        "cara_tpu/ops/pallas/cp_mlp.py:253"),
    "cp_site_fc1_dact": (
        _site, "LAUNCHES_DACT", "cara_tpu_torch/csrc/cp_site.cu",
        "cara_tpu/ops/pallas/cp_dense.py:356"),
    # launches: the element and rank training routes (save-pre default)
    "cp_site_fc1_ln_gelu_pre": (
        _site, "LAUNCHES_GELU_PRE", "cara_tpu_torch/csrc/cp_site.cu",
        "cara_tpu/ops/pallas/cp_mlp.py:253"),
}
SITE_PRODUCTS = ("cp_site_qkv_ln", "cp_site_proj_res", "cp_site_fc1_ln_gelu",
                 "cp_site_fc2_res", "cp_site_fc1_dact",
                 "cp_site_fc1_ln_gelu_pre")
# The fc1 site of a training forward in the save-pre mode: h and the
# pre-activation (bf16) from one launch.
SAVE_PRE_SITE = "cp_site_fc1_ln_gelu_pre"
# The site entries whose launches adapter serving counts.
SITE_SERVING = SITE_PRODUCTS[:4]
# The delta scale of the site entries: not 1, so that the kernel's fp32
# scale step runs.  The rounding of z to bf16 (the TPU's rounding point)
# is multiplied by it: at 10 (the smoke checkpoints' CaRA scale) with
# these inputs' factors (std 0.05) the bf16 plain twin itself misses
# KERNEL_TOL against fp32 (0.067 at |ref| 0.02 on the qkv site).
SITE_SCALE = 1.5
GEMM_PRODUCTS = ("grad_gemm_nn_pre_gelu", "grad_gemm_nt_dgelu",
                 "grad_gemm_nt_dgelu_h", "grad_gemm_nt_dxa",
                 "grad_gemm_tn_dt1", "grad_gemm_tn_dt2")
# The products only the recompute forms launch.
GEMM_RECOMPUTE = ("grad_gemm_nn_pre_gelu", "grad_gemm_nt_dgelu")
# The recompute form of each saved-residual entry.
SAVED_FORMS = {"cp_attn_block_wd_bwd": "cp_attn_block_wd_bwd_saved",
               "cp_mlp_block_wd_bwd": "cp_mlp_block_wd_bwd_saved",
               "cp_mlp_block_bwd": "cp_mlp_block_bwd_saved"}
# What the rank route launches only in the recompute form.
RANK_RECOMPUTE = ("cp_mlp_block_bwd",) + GEMM_RECOMPUTE
GELU_KERNELS = ("cp_dense_gelu", "cp_dense_dact", "cp_dense_wd_gelu",
                "cp_dense_wd_dact")
FLASH_KERNELS = ("flash_attention", "flash_attention_bwd")
MODEL_384 = "vit_base_patch16_384_in21k"
SERVING_KERNELS = ("fused_qkv_attention", "cp_attn_block", "cp_mlp_block")
TRAINING_KERNELS = ("build_wd_weight", "cp_attn_block_wd",
                    "cp_attn_block_wd_bwd_saved", "cp_mlp_block_wd_bwd_saved")
# The rank / row / no-dropout route: the kernels it launches.
SPLIT_KERNELS = ("cp_dense", "cp_dense_dx", "fused_qkv_attention",
                 "fused_qkv_attention_bwd", "cp_mlp_block",
                 "cp_mlp_block_bwd_saved")
NEW_SPLIT_KERNELS = ("cp_dense", "cp_dense_dx", "fused_qkv_attention_bwd",
                     "cp_mlp_block_bwd_saved")
# The 384-px route's entries (rows 16 and 15 and the split element sites),
# checked at N = 577, and the kernels each 384 phase launches.
LONG_KERNELS = ("blockwise_qkv_attention", "blockwise_qkv_attention_bwd",
                "cp_dense_wd", "cp_dense_wd_bwd", "cp_wd_factor_grads")
LONG_SERVING_KERNELS = ("blockwise_qkv_attention", "cp_dense",
                        "cp_mlp_block")
LONG_ELEMENT_KERNELS = ("build_wd_weight", "cp_dense_wd", "cp_dense_wd_bwd",
                        "cp_wd_factor_grads", "blockwise_qkv_attention",
                        "blockwise_qkv_attention_bwd",
                        "cp_mlp_block_wd_bwd_saved")
LONG_SPLIT_KERNELS = ("cp_dense", "cp_dense_dx", "blockwise_qkv_attention",
                      "blockwise_qkv_attention_bwd", "cp_mlp_block",
                      "cp_mlp_block_bwd_saved")
# Activation dropout turns both block megakernels off (the MLP one on
# every route, the attention one on the element route): the dropout
# routes launch the split sites, row 13's GELU body among them.
DROPOUT = {"dropout_rate": 0.1}
MEGA_KERNELS = ("cp_attn_block", "cp_attn_block_wd", "cp_attn_block_wd_bwd",
                "cp_mlp_block", "cp_mlp_block_bwd", "cp_mlp_block_wd_bwd",
                *SAVED_FORMS.values())
DROPOUT_ELEMENT_KERNELS = ("build_wd_weight", "cp_dense_wd",
                           "cp_dense_wd_bwd", "cp_wd_factor_grads",
                           "fused_qkv_attention", "fused_qkv_attention_bwd",
                           "cp_dense_wd_gelu", "cp_dense_wd_dact")
DROPOUT_RANK_KERNELS = ("cp_dense", "cp_dense_dx", "fused_qkv_attention",
                        "fused_qkv_attention_bwd", "cp_dense_gelu",
                        "cp_dense_dact", "cp_site_fc1_dact")
# What the 384-px route must not launch: the full-score attention and the
# attention megakernels, capped at 512 tokens.
SHORT_ATTENTION_KERNELS = ("fused_qkv_attention", "fused_qkv_attention_bwd",
                           "cp_attn_block", "cp_attn_block_wd",
                           "cp_attn_block_wd_bwd",
                           "cp_attn_block_wd_bwd_saved")
BLOCKWISE_KERNELS = ("blockwise_qkv_attention", "blockwise_qkv_attention_bwd")
# The attention-block switches: name -> (``models.vit`` settings, the
# environment of a child process that runs the phase's CLI, or None to
# run it in this process; the kernels the rank route launches under the
# switch, the kernels it must not launch).  With the attention
# megakernel off the CLI's eval runs row 3 too.
ATTN_ROUTE_KERNELS = ("fused_qkv_attention_proj",
                      "fused_qkv_attention_proj_bwd", "cp_attn_block_bwd")
SWITCHES = {
    "CARA_ATTN_MEGA=1": (
        {"_ATTN_MEGA": "1"}, {"CARA_ATTN_MEGA": "1"},
        ("cp_attn_block", "cp_attn_block_bwd", "cp_mlp_block",
         "cp_mlp_block_bwd_saved"),
        ("fused_qkv_attention", "fused_qkv_attention_bwd", "cp_dense",
         "cp_dense_dx", "fused_qkv_attention_proj")),
    "CARA_ATTN_MEGA=0,CARA_ATTNPROJ=1": (
        {"_ATTN_MEGA": "0", "_ATTNPROJ": True}, None,
        ("cp_dense", "cp_dense_dx", "fused_qkv_attention_proj",
         "fused_qkv_attention_proj_bwd", "cp_mlp_block",
         "cp_mlp_block_bwd_saved"),
        ("fused_qkv_attention", "fused_qkv_attention_bwd", "cp_attn_block",
         "cp_attn_block_bwd")),
}
# The attention + projection switch (rows 3 and 4).
ATTNPROJ = "CARA_ATTN_MEGA=0,CARA_ATTNPROJ=1"
# The adapter's kernels, which the routes without one must not launch.
ADAPTER_KERNELS = ("build_wd_weight", "cp_attn_block", "cp_mlp_block",
                   "cp_attn_block_wd", "cp_attn_block_wd_bwd",
                   "cp_mlp_block_wd_bwd", "cp_dense", "cp_dense_dx",
                   "cp_mlp_block_bwd", "cp_dense_wd", "cp_dense_wd_bwd",
                   "cp_wd_factor_grads", *SAVED_FORMS.values())
# Timed calls of a yardstick (default 20): torch._weight_int8pack_mm is a
# matrix-vector kernel, 48-234 ms a call at row 18's batch-64 shapes.
LIBRARY_ITERS = {"int8_dense": 5}
# |kernel - fp32 plain| <= ATOL + RTOL * |ref|, elementwise.  The kernels
# round their intermediates (qkv, P, z, h; in the backward do, dqkv, ds,
# dpre) and their outputs to bf16, the reference does not; bf16 keeps 8
# bits, so 2e-2 leaves ~4 ulps of room, 5e-2 for the backward's dx, which
# passes three rounded products.  The fold's only rounding is its output.
# The blockwise forward averages over 577 keys (|out| ~0.025 at the
# smoke's inputs), so its atol is 2e-3.
KERNEL_TOL = {"fused_qkv_attention": (1e-2, 1e-2),
              "cp_attn_block": (2e-2, 2e-2),
              "cp_mlp_block": (2e-2, 2e-2),
              "build_wd_weight": (1e-3, 1e-2),
              "cp_attn_block_wd": (2e-2, 2e-2),
              "cp_attn_block_wd_bwd": (5e-2, 5e-2),
              "cp_mlp_block_wd_bwd": (5e-2, 5e-2),
              "cp_dense": (2e-2, 2e-2),
              "cp_dense_dx": (5e-2, 5e-2),
              "cp_mlp_block_bwd": (5e-2, 5e-2),
              "cp_attn_block_wd_bwd_saved": (5e-2, 5e-2),
              "cp_mlp_block_wd_bwd_saved": (5e-2, 5e-2),
              "cp_mlp_block_bwd_saved": (5e-2, 5e-2),
              "blockwise_qkv_attention": (2e-3, 1e-2),
              "flash_attention": (2e-3, 1e-2),
              "cp_dense_wd": (2e-2, 2e-2),
              "cp_dense_wd_bwd": (5e-2, 5e-2),
              "cp_dense_gelu": (2e-2, 2e-2),
              "cp_dense_dact": (5e-2, 5e-2),
              "cp_dense_wd_gelu": (2e-2, 2e-2),
              "cp_dense_wd_dact": (5e-2, 5e-2),
              "fused_qkv_attention_proj": (2e-2, 2e-2),
              "cp_attn_block_bwd": (5e-2, 5e-2),
              "int8_dense": (2e-2, 2e-2),
              "block_pair_fwd": (2e-2, 2e-2),
              # one rounding to bf16 (h, dpre); fp32 outputs from the same
              # bf16 operands differ only in the order of fp32 additions
              "grad_gemm_nn_pre_gelu": (2e-2, 2e-2),
              "grad_gemm_nt_dgelu": (2e-2, 2e-2),
              "grad_gemm_nt_dgelu_h": (2e-2, 2e-2),
              "grad_gemm_nt_dxa": (1e-2, 1e-2),
              "grad_gemm_tn_dt1": (1e-2, 1e-2),
              "grad_gemm_tn_dt2": (1e-2, 1e-2),
              # one rounding to bf16 each of xa, z and the output
              "cp_site_qkv_ln": (2e-2, 2e-2),
              "cp_site_proj_res": (2e-2, 2e-2),
              "cp_site_fc1_ln_gelu": (2e-2, 2e-2),
              "cp_site_fc2_res": (2e-2, 2e-2),
              "cp_site_fc1_dact": (5e-2, 5e-2),
              "cp_site_fc1_ln_gelu_pre": (2e-2, 2e-2)}
# CLIP ViT-L/14 (24 layers, E 1024, 16 heads, hidden 4096, 257 tokens,
# ln_pre, LayerNorm eps 1e-5, a 768-wide projection) runs its MLP blocks
# with quick_gelu, y sigmoid(1.702 y): the quick_gelu forms of rows 9,
# 10, 11, 13 and 19, each an entry of its own -> (its GELU twin, whose
# module, source, TPU kernel, tolerance and work it shares; the counter
# of its own form).  Launches: the CLIP phases (row 19's: CLIP's unmerged
# forward through it).
MODEL_CLIP = "vit_large_patch14_224_clip"
QUICK_FORMS = {
    "cp_mlp_block_quick": ("cp_mlp_block", "QUICK_LAUNCHES"),
    "cp_mlp_block_bwd_saved_quick": ("cp_mlp_block_bwd_saved",
                                     "QUICK_BWD_SAVED_LAUNCHES"),
    "cp_mlp_block_wd_bwd_saved_quick": ("cp_mlp_block_wd_bwd_saved",
                                        "QUICK_WD_BWD_SAVED_LAUNCHES"),
    "cp_dense_quick_gelu": ("cp_dense_gelu", "QUICK_ACT_LAUNCHES"),
    "cp_dense_quick_dact": ("cp_dense_dact", "QUICK_DACT_LAUNCHES"),
    "cp_site_fc1_ln_quick_gelu": ("cp_site_fc1_ln_gelu",
                                  "LAUNCHES_QUICK_GELU"),
    "cp_site_fc1_ln_quick_gelu_pre": (SAVE_PRE_SITE,
                                      "LAUNCHES_QUICK_GELU_PRE"),
    "cp_site_fc1_quick_dact": ("cp_site_fc1_dact", "LAUNCHES_QUICK_DACT"),
    "grad_gemm_nn_pre_quick_gelu": ("grad_gemm_nn_pre_gelu",
                                    "LAUNCHES_NN_PRE_QUICK_GELU"),
    "grad_gemm_nt_dquick_gelu": ("grad_gemm_nt_dgelu",
                                 "LAUNCHES_NT_DQUICK_GELU"),
    "grad_gemm_nt_dquick_gelu_h": ("grad_gemm_nt_dgelu_h",
                                   "LAUNCHES_NT_DQUICK_GELU_H"),
    "block_pair_fwd_quick": ("block_pair_fwd", "QUICK_LAUNCHES"),
}
for _name, (_twin, _counter) in QUICK_FORMS.items():
    KERNELS[_name] = (KERNELS[_twin][0], _counter) + KERNELS[_twin][2:]
    KERNEL_TOL[_name] = KERNEL_TOL[_twin]
# Row 19 at the wider registry models, each an entry of its own -> (the
# entry whose module, counter, source, TPU kernel and tolerance it shares;
# N, E, heads, hidden, activation, LayerNorm eps): CLIP ViT-L/14 (E 1024,
# 16 heads of 64, quick_gelu: a cluster of four blocks) and ViT-H/14 (E
# 1280, 16 heads of 80: five blocks) at 257 tokens.  Launches: an entry
# takes those of its kernel instance (head width, rank depth and
# activation): CLIP's unmerged eval through row 19 for the quick_gelu
# instance at head width 64 (``block_pair_fwd_quick`` too), ViT-H's for
# 80.
PAIR_FORMS = {
    "block_pair_fwd_clip": ("block_pair_fwd_quick", 257, 1024, 16, 4096,
                            "quick_gelu", 1e-5),
    "block_pair_fwd_huge": ("block_pair_fwd", 257, 1280, 16, 5120, "gelu",
                            1e-6),
}
for _name, (_base, *_) in PAIR_FORMS.items():
    KERNELS[_name] = KERNELS[_base]
    KERNEL_TOL[_name] = KERNEL_TOL[_base]
# The GELU forms, none of which a CLIP phase may launch.
GELU_FORMS = tuple(twin for twin, _ in QUICK_FORMS.values())
# The quick_gelu entries' GELU twin names at CLIP's shapes (the kernel
# phase builds them as the twins, then renames them).
QUICK_ENTRIES = {twin: name for name, (twin, _) in QUICK_FORMS.items()}
# The recompute forms' quick_gelu products, which the default CLIP routes
# must not launch; the saved forms, which the recompute steps must not.
QUICK_RECOMPUTE = ("grad_gemm_nn_pre_quick_gelu", "grad_gemm_nt_dquick_gelu")
QUICK_SAVED = ("cp_attn_block_wd_bwd_saved", "cp_mlp_block_bwd_saved_quick",
               "cp_mlp_block_wd_bwd_saved_quick",
               "cp_site_fc1_ln_quick_gelu_pre")
CLIP_SERVING_KERNELS = ("fused_qkv_attention", "cp_attn_block",
                        "cp_mlp_block_quick", "cp_site_fc1_ln_quick_gelu")
CLIP_ELEMENT_KERNELS = ("build_wd_weight", "cp_attn_block_wd",
                        "cp_attn_block_wd_bwd_saved",
                        "cp_mlp_block_wd_bwd_saved_quick",
                        "cp_site_fc1_ln_quick_gelu_pre",
                        "grad_gemm_nt_dquick_gelu_h")
CLIP_RANK_KERNELS = ("cp_dense", "cp_dense_dx", "fused_qkv_attention",
                     "fused_qkv_attention_bwd", "cp_mlp_block_quick",
                     "cp_mlp_block_bwd_saved_quick",
                     "cp_site_fc1_ln_quick_gelu_pre",
                     "grad_gemm_nt_dquick_gelu_h")
CLIP_DROPOUT_KERNELS = ("cp_dense_quick_gelu", "cp_dense_quick_dact",
                        "cp_site_fc1_quick_dact")
# ViT-H/14 (32 layers, E 1280, 16 heads of width 80, hidden 5120, 257
# tokens): rows 1, 2, 16 and 17 at head width 80, which the kernels take
# as a 64-column and a 16-column part (csrc/sm90_common.cuh, HeadTile);
# and row 17 at the other widths of the registry's attention instances,
# 16 (the test model) and 32.  Each an entry of its own -> (the entry
# whose module, counter, source, TPU kernel, tolerance and work rule it
# shares; N; head width).  Launches: row 1 (one instance from 257 to 512
# tokens, the two-chunk path) over ViT-H's serving and rank route, row 2
# (one instance) over its rank route, row 16 and the flash attention at
# 577 tokens over its 336-px steps, the flash attention at 257 over its
# full fine-tuning, at 16 and 32 over the test model's full steps.
MODEL_HUGE = "vit_huge_patch14_224_in21k"
# The smoke's ViT-H/14 phase runs 16 of its 32 layers and its CLIP
# ViT-L/14 phase 12 of 24 (full width), to leave the run's time to the
# multi-task, CP-order and interop phases.
HUGE_DEPTH = 16
CLIP_DEPTH = 12
DH_FORMS = {
    "fused_qkv_attention_dh80": ("fused_qkv_attention", 257, 80),
    "fused_qkv_attention_dh80_401": ("fused_qkv_attention", 401, 80),
    "fused_qkv_attention_dh80_512": ("fused_qkv_attention", 512, 80),
    "fused_qkv_attention_bwd_dh80": ("fused_qkv_attention_bwd", 257, 80),
    "fused_qkv_attention_bwd_dh80_512": ("fused_qkv_attention_bwd", 512,
                                         80),
    "blockwise_qkv_attention_dh80": ("blockwise_qkv_attention", 577, 80),
    "blockwise_qkv_attention_bwd_dh80": ("blockwise_qkv_attention_bwd", 577,
                                         80),
    "flash_attention_dh80": ("flash_attention", 257, 80),
    "flash_attention_bwd_dh80": ("flash_attention_bwd", 257, 80),
    "flash_attention_dh80_577": ("flash_attention", 577, 80),
    "flash_attention_bwd_dh80_577": ("flash_attention_bwd", 577, 80),
    "flash_attention_dh16": ("flash_attention", 197, 16),
    "flash_attention_bwd_dh16": ("flash_attention_bwd", 197, 16),
    "flash_attention_dh32": ("flash_attention", 197, 32),
    "flash_attention_bwd_dh32": ("flash_attention_bwd", 197, 32),
}
# Rows 1 and 2 at the lengths VPT gives ViT-B/16 at 224 px: 197 tokens
# and 8 prompts (205), and 200 prompts (397); launches: the zoo phase's
# VPT-Deep steps at those lengths.
ZOO_FORMS = {
    "fused_qkv_attention_205": ("fused_qkv_attention", 205, 64),
    "fused_qkv_attention_bwd_205": ("fused_qkv_attention_bwd", 205, 64),
    "fused_qkv_attention_397": ("fused_qkv_attention", 397, 64),
    "fused_qkv_attention_bwd_397": ("fused_qkv_attention_bwd", 397, 64),
}
for _name, (_base, _, _) in {**DH_FORMS, **ZOO_FORMS}.items():
    KERNELS[_name] = KERNELS[_base]
    if _base in KERNEL_TOL:  # a backward's gradients: GRAD_REL_L2
        KERNEL_TOL[_name] = KERNEL_TOL[_base]
# Row 3 (``CARA_ATTNPROJ=1``: the attention and the projection site in
# one kernel) and its backward with row 4 past ViT-B's 197 tokens and at
# the wider registry models: each an entry of its own -> (the entry whose
# module, counter, source, TPU kernel, tolerance and work rule it shares;
# N, n_real, E, heads).  ViT-B at 401 and 512 tokens (keys >= 500 masked
# there, as ROW2_EDGES), CLIP ViT-L/14 (E 1024, 16 heads of 64) and
# ViT-H/14 (E 1280, 16 heads of 80) at 257.  Launches: an entry takes
# those of its kernel instance (head width and rank depth): the ViT-B
# switched rank phase's for the head width 64 (ViT-B at 197-512 tokens
# and CLIP run that instance), ViT-H's switched rank step's for 80.
PROJ_FORMS = {
    "fused_qkv_attention_proj_401": ("fused_qkv_attention_proj", 401, 401,
                                     768, 12),
    "fused_qkv_attention_proj_bwd_401": ("fused_qkv_attention_proj_bwd",
                                         401, 401, 768, 12),
    "fused_qkv_attention_proj_512": ("fused_qkv_attention_proj", 512, 500,
                                     768, 12),
    "fused_qkv_attention_proj_bwd_512": ("fused_qkv_attention_proj_bwd",
                                         512, 500, 768, 12),
    "fused_qkv_attention_proj_clip": ("fused_qkv_attention_proj", 257, 257,
                                      1024, 16),
    "fused_qkv_attention_proj_bwd_clip": ("fused_qkv_attention_proj_bwd",
                                          257, 257, 1024, 16),
    "fused_qkv_attention_proj_dh80": ("fused_qkv_attention_proj", 257, 257,
                                      1280, 16),
    "fused_qkv_attention_proj_bwd_dh80": ("fused_qkv_attention_proj_bwd",
                                          257, 257, 1280, 16),
}
for _name, (_base, *_) in PROJ_FORMS.items():
    KERNELS[_name] = KERNELS[_base]
    if _base in KERNEL_TOL:  # a backward's gradients: GRAD_REL_L2
        KERNEL_TOL[_name] = KERNEL_TOL[_base]
# Past rank 64: the rank-dependent rows (3-15 and 19) at ViT-B's shapes
# and rank RANK_WIDE, where the GEMM core's rank step runs in k-tiles of
# 64, the fold and the masked factor gradients in rank chunks and rows 3
# and 19 form z in chunks of 64.  Each an entry of its own -> the rank-8
# entry whose module, counter, source, TPU kernel, tolerance and work rule
# it shares.  Launches: ``ranks_phase``, every run of which is at rank
# RANK_WIDE (the element and rank routes, both switches, unmerged serving
# and the eval through row 19).  Row 15's entry counts every launch of
# its masked finish (``wd_fold.MASKED_LAUNCHES``), which the element
# route's block backwards (rows 8 and 11) run at 224 px.
RANK_WIDE = 128
RANK_FORMS = {f"{base}_r{RANK_WIDE}": base for base in (
    "fused_qkv_attention_proj", "fused_qkv_attention_proj_bwd",
    "cp_attn_block", "cp_attn_block_bwd", "cp_attn_block_wd",
    "cp_attn_block_wd_bwd_saved", "cp_mlp_block", "cp_mlp_block_bwd_saved",
    "cp_mlp_block_wd_bwd_saved", "cp_dense_dx", "cp_dense",
    "build_wd_weight", "cp_wd_factor_grads", "block_pair_fwd")}
for _name, _base in RANK_FORMS.items():
    KERNELS[_name] = KERNELS[_base]
    if _base in KERNEL_TOL:  # a backward's gradients: GRAD_REL_L2
        KERNEL_TOL[_name] = KERNEL_TOL[_base]
KERNELS[f"cp_wd_factor_grads_r{RANK_WIDE}"] = (
    (wd_fold, "MASKED_LAUNCHES") + KERNELS["cp_wd_factor_grads"][2:])
# ViT-H's routes: what each launches.  Its element route's row 2 runs
# inside row 8 (uncounted there); the rank route counts it.
HUGE_SERVING_KERNELS = SERVING_KERNELS + SITE_SERVING
HUGE_ELEMENT_KERNELS = TRAINING_KERNELS + ("grad_gemm_nt_dgelu_h",
                                           SAVE_PRE_SITE)
HUGE_RANK_KERNELS = SPLIT_KERNELS + (SAVE_PRE_SITE,)
# Outputs held elementwise (forwards, dx); every other key of a gradient
# dict by relative L2: the factor and bias gradients, and the attention
# backward's dq, dk and dv, whose typical size at the smoke's inputs
# (|dq|, |dk| ~0.03) is below an elementwise bound's atol.
ELEMENTWISE_KEYS = ("out", "x", "o", "qkv", "proj", "h", "pre16")
# Factor and bias gradients reduce over B*N = 12608 rows of bf16
# products: held by ||kernel - ref|| / ||ref|| (relative L2).
GRAD_REL_L2 = 2e-2
# The blockwise forward's fp32 log-sum-exp (~log N + the row max) from the
# same bf16 q and k as the fp32 plain: only the summation order differs.
# A key wrongly kept or masked at N = 640 moves it by ~log(640 / 577).
LSE_ATOL = 1e-3
# Logits: bf16 through 12 layers against fp32 on the same weights.
LOGIT_RTOL = 0.05
# ``export_phase``: the merged export's arrays against an fp32 merge of
# its checkpoint on the card (the same fold: only summation order could
# differ), and its served logits against ``merge=True`` (the same merged
# weights rounded to bf16 once each), relative to the largest value.
EXPORT_WEIGHT_RTOL = 1e-6
EXPORT_LOGIT_RTOL = 1e-2
# One train step's gradient of each trainable leaf, bf16 kernels against
# the fp32 plain path: relative L2.  The error of bf16 rounding (2^-8) at
# every rounded intermediate, forward and backward, through 12 layers; a
# wrong mask, gate or missing term shows as O(1).  A CP factor whose
# gradient contracts many larger terms (P1, R2) can amplify that noise
# past 5e-2 on some realizations, in the plain path in bf16 as much as
# in the kernels: a leaf's bound is then the plain path's worst error
# over the step and NOISE_DRAWS copies of it whose images carry noise of
# std NOISE_STD (same weights, masks and gates).
TRAIN_GRAD_REL_L2 = 5e-2
NOISE_DRAWS = 8
NOISE_STD = 1e-3
DROP_RATE = 0.1
# LoRA and FacT (PR 22): the methods, the std of the seeded noise in each
# one's zero factor (LoRA's B, TT's G, TK's C; at PEFT_SCALE the ViT-B qkv
# delta is then about a fifth of the backbone's product on LN'd input,
# CaRA's perturbation in size), the delta scale, FacT-TK's core rank, the
# route of each method's gradient check (both kernel families held), and
# the counters of the TPU rows the phase's steps launch.
PEFT_METHODS = ("lora", "fact_tt", "fact_tk")
PEFT_STD = {"lora": 0.006, "fact_tt": 0.12, "fact_tk": 0.5}
PEFT_SCALE = 10.0
PEFT_CORE_RANK = 4
PEFT_GRAD_ROUTE = {"lora": "element", "fact_tt": "rate0",
                   "fact_tk": "element"}
PEFT_ROWS = (("1", "fused_qkv_attention"), ("2", "fused_qkv_attention_bwd"),
             ("5", "cp_attn_block"), ("7", "cp_attn_block_wd"),
             ("8", "cp_attn_block_wd_bwd_saved"), ("9", "cp_mlp_block"),
             ("10", "cp_mlp_block_bwd_saved"),
             ("11", "cp_mlp_block_wd_bwd_saved"), ("12", "cp_dense_dx"),
             ("13", "cp_dense"), ("14", "build_wd_weight"))
PEFT_PATHS = {"element": TRAINING_KERNELS + ("cp_mlp_block",),
              "rate0": SPLIT_KERNELS}
# The PEFT zoo (``zoo_phase``): the six methods without a low-rank delta,
# which train and serve through the fused attention (rows 1, 2; row 16
# past 512 tokens) and the XLA dense forms.  Bottleneck width ZOO_RANK,
# the adapters' internal dropout ZOO_DROP (AdaptFormer's default; Houlsby
# at the same rate, so that both draw masks), VPT's ZOO_PROMPTS tokens
# (ZOO_LONG_PROMPTS for row 2's upper range).  ZOO_STD: the std of the
# seeded noise on the tree's zero leaves (the up projections and biases,
# BitFit's deltas), so that the gradient check has signal; VPT's prompts
# and SSF's pairs are drawn nonzero.
ZOO_METHODS = ("vpt_deep", "vpt_shallow", "ssf", "bitfit", "adapter",
               "adaptformer")
ZOO_STD = {"bitfit": 0.02, "adapter": 0.02, "adaptformer": 0.02}
ZOO_RANK = 8
ZOO_DROP = 0.1
ZOO_PROMPTS = 8
ZOO_LONG_PROMPTS = 200
ZOO_ROWS = PEFT_ROWS[:2]
# CaRA's mixture of experts (``moe_phase``): X experts routed top K, rank
# 8 on the rank route (the XLA dense forms; rows 1 and 2 only).
MOE_EXPERTS = 4
MOE_TOP_K = 2
# ToMe (``tome_phase``): the merge counts a layer served, and the one on
# the int8 backbone.
TOME_RS = (0, 8, 13)
TOME_INT8_R = 8
# Published peaks of one H100 SXM (NVIDIA data sheet, dense): bf16 tensor
# cores and HBM3.  A kernel's bound is the larger of its work over each.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms, by CUDA events per run."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_inputs(dev, b=64, n=197, e=768, heads=12, hidden=3072, r=8,
                  seed=0, n_real=None, zero_gates=2, act="gelu", eps=1e-6):
    """bf16 inputs at the main path's shapes, from a seeded generator;
    keys at or past ``n_real`` (default ``n``) are masked.  The training
    kernels get drop-path gates ``1/(1-p)`` with the first ``zero_gates``
    images dropped, four int32 mask seeds and output cotangents.  ``act``
    and ``eps`` are the MLP entries' activation and LayerNorm eps (CLIP:
    "quick_gelu", 1e-5).  Past rank 64 the CP factors' std shrinks by
    (64 / r) ** (1 / 4), so that the delta keeps rank 64's size."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    f = 0.05 * min(1.0, 64 / max(r, 1)) ** 0.25  # the CP factors' std

    def rnd(*shape, std=1.0, mean=0.0):
        t = torch.randn(shape, generator=g, device=dev) * std + mean
        return t.to(torch.bfloat16)

    gates = torch.full((b, 1), 1.0 / (1.0 - DROP_RATE), device=dev)
    gates[:zero_gates] = 0.0
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (4, 1, 1), generator=g,
                          device=dev, dtype=torch.int32)
    return dict(
        b=b, n=n, n_real=n if n_real is None else n_real, e=e, heads=heads,
        sm=(e // heads) ** -0.5, act=act, eps=eps,
        qkv=rnd(b, n, 3 * e, std=0.6),
        attn=dict(x=rnd(b, n, e), wq=rnd(e, 3 * e, std=0.02),
                  bq=rnd(3 * e, std=0.02), u1=rnd(e, r, std=f),
                  v1=rnd(r, 3 * e, std=f), wp=rnd(e, e, std=0.02),
                  bp=rnd(e, std=0.02), u2=rnd(e, r, std=f),
                  v2=rnd(r, e, std=f), cb2=rnd(e, std=0.02),
                  ln_scale=rnd(e, std=0.1, mean=1.0),
                  ln_bias=rnd(e, std=0.1),
                  dpm=torch.ones((b, 1), device=dev, dtype=torch.bfloat16)),
        mlp=dict(x=rnd(b, n, e), w1=rnd(e, hidden, std=0.02),
                 b1=rnd(hidden, std=0.02), u1=rnd(e, r, std=f),
                 v1=rnd(r, hidden, std=f), cb1=rnd(hidden, std=0.02),
                 w2=rnd(hidden, e, std=0.02), b2=rnd(e, std=0.02),
                 u2=rnd(hidden, r, std=f), v2=rnd(r, e, std=f),
                 cb2=rnd(e, std=0.02), ln_scale=rnd(e, std=0.1, mean=1.0),
                 ln_bias=rnd(e, std=0.1),
                 dpm=torch.ones((b, 1, 1), device=dev,
                                dtype=torch.bfloat16)),
        gates=gates.to(torch.bfloat16), seeds=list(seeds),
        g_attn=rnd(b, n, e), g_mlp=rnd(b, n, e),
        o=rnd(b, n, e, std=0.5), g_qkv=rnd(b, n, 3 * e),
        g_hid=rnd(b, n, hidden))


# Positional tensor arguments of the two block wrappers, in order, and
# the inputs the training wrappers differentiate.
ATTN_ARGS = ("x", "wq", "bq", "u1", "v1", "wp", "bp", "u2", "v2", "cb2",
             "ln_scale", "ln_bias", "dpm")
MLP_ARGS = ("x", "w1", "b1", "u1", "v1", "cb1", "w2", "b2", "u2", "v2",
            "cb2", "ln_scale", "ln_bias", "dpm")
ATTN_DIFF = ("x", "u1", "v1", "u2", "v2", "cb2")
MLP_DIFF = ("x", "u1", "v1", "cb1", "u2", "v2", "cb2")
DENSE_DIFF = ("x", "u1", "v1", "o", "u2", "v2", "cb2")
FOLD_SITES = ("qkv", "proj", "fc1", "fc2")


# The sites a block call folds in one launch: the attention block's
# pair, the MLP block's pair.
FOLD_PAIRS = (("qkv", "proj"), ("fc1", "fc2"))


def _fold_sites(inp):
    a, m, sd = inp["attn"], inp["mlp"], inp["seeds"]
    return {"qkv": (a["wq"], a["u1"], a["v1"], sd[0]),
            "proj": (a["wp"], a["u2"], a["v2"], sd[1]),
            "fc1": (m["w1"], m["u1"], m["v1"], sd[2]),
            "fc2": (m["w2"], m["u2"], m["v2"], sd[3])}


def fold_calls(folds, rate, s=1.0):
    """Row 14's entry on a layer's four sites: (the grouped fold, two
    launches as the block calls make them; its plain twin; fp32 plain),
    each site -> W'."""
    def pairs(fold, dtype=None):
        out = {}
        for pair in FOLD_PAIRS:
            sites = [folds[k] for k in pair]
            if dtype is not None:
                sites = [(w.to(dtype), u.to(dtype), v.to(dtype), sd)
                         for w, u, v, sd in sites]
            out.update(zip(pair, fold(sites, s, rate)))
        return out

    return (lambda: pairs(wd_fold.build_wd_weights),
            lambda: pairs(wd_fold.build_wd_weights_plain),
            lambda: pairs(wd_fold.build_wd_weights_plain, torch.float32))


def fold_kernel_phase(dev, timed: bool = True, name="build_wd_weight_huge",
                      e=1280, hidden=5120, r=8) -> dict:
    """Row 14's entry at other widths (by default ViT-H/14's: 1280 ->
    3840, 1280 -> 1280, 1280 -> 5120, 5120 -> 1280), the layer's four
    folds in two grouped launches, against the fp32 plain fold."""
    inp = kernel_inputs(dev, b=1, n=17, e=e, heads=16, hidden=hidden, r=r,
                        seed=e)
    print(f"[kernel] {name} (row 14) at E {e}, hidden {hidden}, rank {r}:",
          flush=True)
    res = check_entries(
        dev, inp, {"build_wd_weight": fold_calls(_fold_sites(inp),
                                                 DROP_RATE)},
        timed, work={"build_wd_weight": kernel_work(inp)["build_wd_weight"]},
        library={})
    return {name: res["build_wd_weight"]}


@contextlib.contextmanager
def save_switch(value: str):
    """Both saved-residual switches (``cp_mlp._SAVE_PRE``,
    ``cp_attn_block._SAVE_QKV``) set to ``value`` inside the block,
    restored after it; a recorded forward decides at its call."""
    old = mlp_mod._SAVE_PRE, attn_mod._SAVE_QKV
    mlp_mod._SAVE_PRE = attn_mod._SAVE_QKV = value
    try:
        yield
    finally:
        mlp_mod._SAVE_PRE, attn_mod._SAVE_QKV = old


def _grad_call(fwd, inp_tree, diff, grads_out, dtype):
    """One forward ``fwd(leaves)`` (its graph kept; one output tensor or a
    tuple), returning a call that runs only its backward against
    ``grads_out``: name -> gradient."""
    leaves = {k: v.detach().to(dtype).requires_grad_(k in diff)
              if v.is_floating_point() else v for k, v in inp_tree.items()}
    out = fwd(leaves)
    outs = out if isinstance(out, tuple) else (out,)
    gs = [t.to(dtype) for t in (grads_out if isinstance(grads_out, tuple)
                                else (grads_out,))]
    wrt = [leaves[k] for k in diff]
    return lambda: dict(zip(diff, torch.autograd.grad(
        outs, wrt, gs, retain_graph=True)))


def kernel_calls(inp):
    """name -> (kernel call, plain call on the same inputs, fp32 plain);
    each returns a tensor or a dict of tensors."""
    h, sm, n = inp["heads"], inp["sm"], inp["n_real"]
    a = inp["attn"]
    a32 = {k: v.float() for k, v in a.items()}
    an = ATTN_ARGS
    qkv = inp["qkv"]
    s1, s2 = inp["seeds"][:2]
    rate = DROP_RATE
    folds = _fold_sites(inp)
    aw = dict(a, dpm=inp["gates"])
    aw32 = {k: v.float() for k, v in aw.items()}

    def attn_wd(*args, impl="auto"):
        return attn_mod.cp_attn_block_wd(*args, s1, s2, h, sm, n, 1.0, rate,
                                         impl=impl)

    # The block backwards' forwards run here, with the saved-residual
    # switches "0" (the recompute forms) or "1" (the saved forms and their
    # plain twins at the saved rounding points).
    def attn_bwd(impl, dtype, save="0"):
        with save_switch(save):
            return _grad_call(
                lambda t: attn_wd(*(t[k] for k in an), impl=impl), aw,
                ATTN_DIFF, inp["g_attn"], dtype)

    # The split path's two dense sites: qkv (LN prologue, no cb) on x and
    # the projection on an attention output o.
    dense = dict(a, o=inp["o"])

    def dense_sites(t, impl):
        return (dense_mod.cp_dense_ln(t["x"], t["wq"], t["bq"], t["u1"],
                                      t["v1"], None, t["ln_scale"],
                                      t["ln_bias"], impl=impl),
                dense_mod.cp_dense(t["o"], t["wp"], t["bp"], t["u2"],
                                   t["v2"], t["cb2"], impl=impl))

    def dense_fwd(impl, dtype):
        t = {k: v.to(dtype) for k, v in dense.items()}
        return lambda: dict(zip(("qkv", "proj"), dense_sites(t, impl)))

    def dense_bwd(impl, dtype):
        return _grad_call(lambda t: dense_sites(t, impl), dense, DENSE_DIFF,
                          (inp["g_qkv"], inp["g_attn"]), dtype)

    bf, f32 = torch.bfloat16, torch.float32
    return {**mlp_kernel_calls(inp),
        "fused_qkv_attention": (
            lambda: fqa_mod.fused_qkv_attention(qkv, h, sm, n),
            lambda: fqa_mod.fused_qkv_attention_plain(qkv, h, sm, n),
            lambda: fqa_mod.fused_qkv_attention_plain(qkv.float(), h, sm,
                                                      n)),
        "cp_attn_block": (
            lambda: attn_mod.cp_attn_block(*(a[k] for k in an), h, sm, n),
            lambda: attn_mod.cp_attn_block_plain(*(a[k] for k in an), h, sm,
                                                 n),
            lambda: attn_mod.cp_attn_block_plain(*(a32[k] for k in an), h,
                                                 sm, n)),
        "build_wd_weight": fold_calls(folds, rate),
        "cp_attn_block_wd": (
            lambda: attn_wd(*(aw[k] for k in an)),
            lambda: attn_mod.cp_attn_block_wd_plain(
                *(aw[k] for k in an), s1, s2, h, sm, n, 1.0, rate),
            lambda: attn_mod.cp_attn_block_wd_plain(
                *(aw32[k] for k in an), s1, s2, h, sm, n, 1.0, rate)),
        "cp_attn_block_wd_bwd": (attn_bwd("auto", bf), attn_bwd("plain", bf),
                                 attn_bwd("plain", torch.float32)),
        "cp_dense": (dense_fwd("auto", bf), dense_fwd("plain", bf),
                     dense_fwd("plain", torch.float32)),
        "cp_dense_dx": (dense_bwd("auto", bf), dense_bwd("plain", bf),
                        dense_bwd("plain", torch.float32)),
        "fused_qkv_attention_bwd": row2_bwd_calls(inp),
        "cp_attn_block_wd_bwd_saved": (
            attn_bwd("auto", bf, "1"), attn_bwd("plain", bf, "1"),
            attn_bwd("plain", f32, "1")),
    }


def mlp_kernel_calls(inp, names=None):
    """:func:`kernel_calls`' entries of the MLP block (rows 9, 10 and 11,
    the backwards in both residual forms) with ``inp``'s activation and
    LayerNorm eps; ``names`` picks some (their backwards' forwards run
    as the calls are made)."""
    m = inp["mlp"]
    m32 = {k: v.float() for k, v in m.items()}
    mn = MLP_ARGS
    s3, s4 = inp["seeds"][2:]
    kw = dict(act=inp["act"], ln_eps=inp["eps"])
    mw = dict(m, dpm=inp["gates"].reshape(-1, 1, 1))

    def mlp_wd(*args, impl="auto"):
        return mlp_mod.cp_mlp_block_wd(*args, s3, s4, 1.0, DROP_RATE,
                                       impl=impl, **kw)

    def mlp_bwd(impl, dtype, save="0"):
        with save_switch(save):
            return _grad_call(
                lambda t: mlp_wd(*(t[k] for k in mn), impl=impl), mw,
                MLP_DIFF, inp["g_mlp"], dtype)

    def mlp_block_bwd(impl, dtype, save="0"):
        with save_switch(save):
            return _grad_call(
                lambda t: mlp_mod.cp_mlp_block(*(t[k] for k in mn),
                                               impl=impl, **kw),
                mw, MLP_DIFF, inp["g_mlp"], dtype)

    bf, f32 = torch.bfloat16, torch.float32
    makers = {
        "cp_mlp_block": lambda: (
            lambda: mlp_mod.cp_mlp_block(*(m[k] for k in mn), **kw),
            lambda: mlp_mod.cp_mlp_block_plain(*(m[k] for k in mn), **kw),
            lambda: mlp_mod.cp_mlp_block_plain(*(m32[k] for k in mn),
                                               **kw)),
        "cp_mlp_block_wd_bwd": lambda: (
            mlp_bwd("auto", bf), mlp_bwd("plain", bf), mlp_bwd("plain", f32)),
        "cp_mlp_block_bwd": lambda: (
            mlp_block_bwd("auto", bf), mlp_block_bwd("plain", bf),
            mlp_block_bwd("plain", f32)),
        "cp_mlp_block_wd_bwd_saved": lambda: (
            mlp_bwd("auto", bf, "1"), mlp_bwd("plain", bf, "1"),
            mlp_bwd("plain", f32, "1")),
        "cp_mlp_block_bwd_saved": lambda: (
            mlp_block_bwd("auto", bf, "1"), mlp_block_bwd("plain", bf, "1"),
            mlp_block_bwd("plain", f32, "1")),
    }
    return {k: make() for k, make in makers.items()
            if names is None or k in names}


def row2_bwd_calls(inp):
    """Row 2's entry: the kernel, plain and fp32 plain calls of
    ``fused_qkv_attention``'s backward on ``inp["qkv"]`` (keys at or past
    ``inp["n_real"]`` masked) and the cotangent ``inp["g_attn"]``, dqkv
    split into its dq, dk and dv thirds (held apart: dq and dk are a third
    the size of dv here)."""
    h, sm, n = inp["heads"], inp["sm"], inp["n_real"]

    def call(impl, dtype):
        grads = _grad_call(
            lambda t: fqa_mod.fused_qkv_attention(t["qkv"], h, sm, n,
                                                  impl=impl),
            {"qkv": inp["qkv"]}, ("qkv",), inp["g_attn"], dtype)
        return lambda: dict(zip(("dq", "dk", "dv"),
                                grads()["qkv"].chunk(3, dim=-1)))

    return (call("auto", torch.bfloat16), call("plain", torch.bfloat16),
            call("plain", torch.float32))


def long_kernel_calls(inp):
    """:func:`kernel_calls` for the 384-px route's entries
    (``LONG_KERNELS``): the blockwise attention forward and backward, the
    two element-dropout sites (qkv with LN1 and no cb, proj with cb2)
    forward and backward, and row 15 on the qkv site's LN(x) and
    cotangent."""
    h, sm, n = inp["heads"], inp["sm"], inp["n_real"]
    a = inp["attn"]
    qkv = inp["qkv"]
    s1, s2 = inp["seeds"][:2]
    rate = DROP_RATE
    dense = dict(a, o=inp["o"])

    def attn_fwd(dtype, impl):
        q = qkv.to(dtype)
        return lambda: bwa_mod.blockwise_qkv_attention(q, h, sm, n,
                                                       impl=impl)

    def attn_bwd(impl, dtype):
        call = _grad_call(
            lambda t: bwa_mod.blockwise_qkv_attention(t["qkv"], h, sm, n,
                                                      impl=impl),
            {"qkv": qkv}, ("qkv",), inp["g_attn"], dtype)
        return lambda: dict(zip(("dq", "dk", "dv"),
                                call()["qkv"].chunk(3, dim=-1)))

    def wd_sites(t, impl):
        return (dense_mod.cp_dense_ln_wd(t["x"], t["wq"], t["bq"], t["u1"],
                                         t["v1"], None, t["ln_scale"],
                                         t["ln_bias"], s1, 1.0, rate,
                                         impl=impl),
                dense_mod.cp_dense_wd(t["o"], t["wp"], t["bp"], t["u2"],
                                      t["v2"], t["cb2"], s2, 1.0, rate,
                                      impl=impl))

    def wd_fwd(impl, dtype):
        t = {k: v.to(dtype) for k, v in dense.items()}
        return lambda: dict(zip(("qkv", "proj"), wd_sites(t, impl)))

    def wd_bwd(impl, dtype):
        return _grad_call(lambda t: wd_sites(t, impl), dense, DENSE_DIFF,
                          (inp["g_qkv"], inp["g_attn"]), dtype)

    e = inp["e"]
    xa = layer_norm(a["x"], a["ln_scale"], a["ln_bias"]).reshape(-1, e)
    g_qkv = inp["g_qkv"].reshape(-1, 3 * e)

    def factor(fn, dtype):
        t = [v.to(dtype) for v in (xa, g_qkv, a["u1"], a["v1"])]
        return lambda: dict(zip(("du", "dv"), fn(*t, s1, 1.0, rate)))

    bf = torch.bfloat16
    return {
        "blockwise_qkv_attention": (attn_fwd(bf, "auto"),
                                    attn_fwd(bf, "plain"),
                                    attn_fwd(torch.float32, "plain")),
        "blockwise_qkv_attention_bwd": (attn_bwd("auto", bf),
                                        attn_bwd("plain", bf),
                                        attn_bwd("plain", torch.float32)),
        "cp_dense_wd": (wd_fwd("auto", bf), wd_fwd("plain", bf),
                        wd_fwd("plain", torch.float32)),
        "cp_dense_wd_bwd": (wd_bwd("auto", bf), wd_bwd("plain", bf),
                            wd_bwd("plain", torch.float32)),
        "cp_wd_factor_grads": (
            factor(wd_fold.cp_wd_factor_grads, bf),
            factor(wd_fold.cp_wd_factor_grads_plain, bf),
            factor(wd_fold.cp_wd_factor_grads_plain, torch.float32)),
    }


def gelu_kernel_calls(inp):
    """:func:`kernel_calls` for row 13's GELU body (``GELU_KERNELS``) on
    the fc1 site of ``inp["mlp"]``: the LN form with the rank delta
    (``cp_dense_ln(act="gelu")``) and the W' form (``cp_dense_ln_wd``,
    the fold and the GELU site on W' at rank 0), forward, and the dact
    helper of each on the hidden cotangent ``inp["g_hid"]`` (the W' one
    on the kernels' fold of the same seed)."""
    m = inp["mlp"]
    e, hid = inp["e"], m["w1"].shape[1]
    act, eps = inp["act"], inp["eps"]
    s3 = inp["seeds"][2]
    rate = DROP_RATE
    x2 = m["x"].reshape(-1, e)
    g2 = inp["g_hid"].reshape(-1, hid)
    site = ("w1", "b1", "u1", "v1", "cb1")
    wp = wd_fold.build_wd_weight(m["w1"], m["u1"], m["v1"], s3, 1.0, rate)

    def ln(dtype):
        return (m["ln_scale"].to(dtype), m["ln_bias"].to(dtype), eps)

    def fwd(dtype, impl, wd):
        t = {k: m[k].to(dtype) for k in ("x", "ln_scale", "ln_bias") + site}
        args = (t["x"],) + tuple(t[k] for k in site)
        if wd:
            return lambda: dense_mod.cp_dense_ln_wd(
                *args, t["ln_scale"], t["ln_bias"], s3, 1.0, rate, eps,
                impl=impl, act=act)
        return lambda: dense_mod.cp_dense_ln(
            *args, t["ln_scale"], t["ln_bias"], ln_eps=eps, impl=impl,
            act=act)

    def dact(dtype, impl, wd):
        if wd:
            w, u, v = wp, *wd_fold.zero_rank(x2, e, hid)
        else:
            w, u, v = m["w1"], m["u1"], m["v1"]
        args = [t.to(dtype) for t in (g2, x2, w, m["b1"], u, v, m["cb1"])]
        if impl == "plain":
            return lambda: dense_mod.cp_dense_dact_plain(*args, 1.0,
                                                         ln(dtype), act)
        return lambda: dense_mod.cp_dense_dact(*args, 1.0, ln(dtype), act)

    bf, f32 = torch.bfloat16, torch.float32
    out = {}
    for wd, name in ((False, "cp_dense"), (True, "cp_dense_wd")):
        out[name + "_gelu"] = (fwd(bf, "auto", wd), fwd(bf, "plain", wd),
                               fwd(f32, "plain", wd))
        out[name + "_dact"] = (dact(bf, "auto", wd), dact(bf, "plain", wd),
                               dact(f32, "plain", wd))
    return out


def gelu_kernel_phase(dev, inp, timed: bool = True) -> dict:
    """Row 13's GELU entries at ``inp``'s shapes; at N = 577 only the W'
    form (the 384-px route's element sites), suffixed ``_577``."""
    print(f"[kernel] row 13's GELU body at B {inp['b']}, N {inp['n']}, "
          f"E {inp['e']}, hidden {inp['mlp']['w1'].shape[1]}:", flush=True)
    calls = gelu_kernel_calls(inp)
    if inp["n"] > fqa_mod.MAX_NP_FULL_SCORES:
        calls = {k: v for k, v in calls.items() if "_wd_" in k}
        return {k + "_577": v
                for k, v in check_entries(dev, inp, calls, timed).items()}
    return check_entries(dev, inp, calls, timed)


def flash_kernel_calls(inp):
    """:func:`kernel_calls` for row 17 (``FLASH_KERNELS``): the flash
    attention forward and its q, k, v cotangents on the (B, H, N, Dh)
    views of ``inp["qkv"]`` that the model makes (strided, not copied),
    the cotangent ``inp["g_attn"]`` in the model's (B, N, E) layout."""
    h, sm = inp["heads"], inp["sm"]
    b, n, e = inp["b"], inp["n"], inp["e"]
    d = e // h

    def views(qkv):
        return [t.transpose(1, 2)
                for t in qkv.reshape(b, n, 3, h, d).unbind(2)]

    def fwd(dtype, impl):
        q, k, v = views(inp["qkv"].to(dtype))
        return lambda: flash_mod.flash_attention(q, k, v, sm, impl=impl)

    def bwd(impl, dtype):
        qkv = inp["qkv"].detach().to(dtype).requires_grad_(True)
        q, k, v = views(qkv)
        out = flash_mod.flash_attention(q, k, v, sm, impl=impl)
        g = inp["g_attn"].to(dtype).reshape(b, n, h, d).transpose(1, 2)
        return lambda: dict(zip(("dq", "dk", "dv"), torch.autograd.grad(
            out, (q, k, v), g, retain_graph=True)))

    bf = torch.bfloat16
    return {
        "flash_attention": (fwd(bf, "auto"), fwd(bf, "plain"),
                            fwd(torch.float32, "plain")),
        "flash_attention_bwd": (bwd("auto", bf), bwd("plain", bf),
                                bwd("plain", torch.float32)),
    }


def flash_kernel_phase(dev, inp, timed: bool = True,
                       suffix: str = "") -> dict:
    """Row 17's entries on ``inp`` (all keys valid), named with
    ``suffix``."""
    print(f"[kernel] flash attention (row 17) at B {inp['b']}, N "
          f"{inp['n']}, H {inp['heads']}:", flush=True)
    out = check_entries(dev, inp, flash_kernel_calls(inp), timed)
    return {name + suffix: res for name, res in out.items()}


# The inputs the attention-block switches' entries differentiate: row 3's
# qkv and proj-site leaves, row 6's block leaves with both biases.
PROJ_DIFF = ("qkv", "bp", "u2", "v2", "cb2")
ATTN_BLOCK_DIFF = ("x", "bq", "u1", "v1", "bp", "u2", "v2", "cb2")


def attn_route_kernel_calls(inp):
    """:func:`kernel_calls` for the attention-block switches
    (``ATTN_ROUTE_KERNELS``): row 3's forward on ``inp["qkv"]`` and the
    projection site's weights, its backward (rows 3 and 4; dqkv held as
    its dq, dk and dv thirds), and row 6, the attention megakernel's
    backward, with the drop-path gates of the training entries."""
    h, sm, n = inp["heads"], inp["sm"], inp["n_real"]
    a = inp["attn"]
    proj = dict(qkv=inp["qkv"], wp=a["wp"], bp=a["bp"], u2=a["u2"],
                v2=a["v2"], cb2=a["cb2"])

    def proj_call(t, impl):
        return fqa_mod.fused_qkv_attention_proj(
            t["qkv"], t["wp"], t["bp"], t["u2"], t["v2"], t["cb2"], h, sm,
            n, impl=impl)

    def proj_fwd(impl, dtype):
        t = {k: v.to(dtype) for k, v in proj.items()}
        return lambda: proj_call(t, impl)

    def proj_bwd(impl, dtype):
        call = _grad_call(lambda t: proj_call(t, impl), proj, PROJ_DIFF,
                          inp["g_attn"], dtype)

        def split():
            out = call()
            dq, dk, dv = out.pop("qkv").chunk(3, dim=-1)
            return dict(out, dq=dq, dk=dk, dv=dv)
        return split

    block = dict(a, dpm=inp["gates"])

    def block_bwd(impl, dtype):
        return _grad_call(
            lambda t: attn_mod.cp_attn_block(*(t[k] for k in ATTN_ARGS), h,
                                             sm, n, impl=impl),
            block, ATTN_BLOCK_DIFF, inp["g_attn"], dtype)

    bf, f32 = torch.bfloat16, torch.float32
    return {
        "fused_qkv_attention_proj": (proj_fwd("auto", bf),
                                     proj_fwd("plain", bf),
                                     proj_fwd("plain", f32)),
        "fused_qkv_attention_proj_bwd": (proj_bwd("auto", bf),
                                         proj_bwd("plain", bf),
                                         proj_bwd("plain", f32)),
        "cp_attn_block_bwd": (block_bwd("auto", bf), block_bwd("plain", bf),
                              block_bwd("plain", f32)),
    }


def attn_route_kernel_phase(dev, inp, timed: bool = True) -> dict:
    """The attention-block switches' entries at ``inp``'s shapes."""
    print(f"[kernel] rows 3, 4 and 6 (CARA_ATTNPROJ, CARA_ATTN_MEGA) at B "
          f"{inp['b']}, N {inp['n']}, E {inp['e']}, H {inp['heads']}:",
          flush=True)
    return check_entries(dev, inp, attn_route_kernel_calls(inp), timed)


def proj_kernel_phase(dev, timed: bool = True, b: int = 64,
                      forms=None) -> dict:
    """The entries of ``PROJ_FORMS`` (``forms`` a subset): row 3's forward
    and its backward at each entry's N, n_real, E and heads (Dh = E /
    heads, hidden 4 E, rank 8), held against the fp32 plain twins, timed
    beside SDPA + ``torch.addmm`` (and SDPA's backward + the dx GEMM),
    bound by the base entries' work rule at these shapes."""
    forms = PROJ_FORMS if forms is None else forms
    groups = {}
    for name, (base, *shape) in forms.items():
        groups.setdefault(tuple(shape), []).append((name, base))
    out = {}
    for (n, n_real, e, heads), entries in groups.items():
        inp = kernel_inputs(dev, b=b, n=n, e=e, heads=heads, hidden=4 * e,
                            seed=n + e, n_real=n_real)
        bases = {base for _, base in entries}
        made = {k: v for k, v in attn_route_kernel_calls(inp).items()
                if k in bases}
        masked = f", keys >= {n_real} masked" if n_real < n else ""
        print(f"[kernel] row 3 at B {b}, N {n}{masked}, E {e}, {heads} "
              f"heads of width {e // heads}: "
              f"{', '.join(name for name, _ in entries)}", flush=True)
        res = check_entries(dev, inp, made, timed)
        for name, base in entries:
            out[name] = res[base]
        del inp, made, res
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


# Row 18's entries: name suffix -> (M, K, N), the qkv and fc2 sites of
# ViT-B at batch 64 (M = 64 * 197) and at batch 1, and of ViT-H/14 (M =
# 64 * 257 and 257).  At batch 1 the wrapper splits the contraction.
INT8_SHAPES = {"": (12608, 768, 2304), "_m197": (197, 768, 2304),
               "_fc2": (12608, 3072, 768), "_fc2_m197": (197, 3072, 768),
               "_huge": (16448, 1280, 3840), "_huge_m257": (257, 1280, 3840),
               "_huge_fc2": (16448, 5120, 1280),
               "_huge_fc2_m257": (257, 5120, 1280)}


def int8_inputs(dev, m, k, n, seed=0) -> dict:
    """bf16 x (M, K) and bias (N,), and the int8 codes and bf16 scale of
    a seeded bf16 (K, N) weight by ``models/quant.py``."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).to(
            torch.bfloat16)

    q = quant_lib.quantize_kernel(rnd(k, n, std=0.02))
    return dict(x=rnd(m, k), wq=q["q"], scale=q["scale"].reshape(n),
                b=rnd(n, std=0.02))


def int8_kernel_phase(dev, timed: bool = True, shapes=None) -> dict:
    """Row 18's entries at ``shapes`` (``INT8_SHAPES``): the kernel
    against its fp32 plain version; its yardstick is
    ``torch._weight_int8pack_mm`` on the same x, codes and scale (no
    bias), a PyTorch call the port never makes.  A second yardstick is
    printed: ``torch.matmul`` on the codes dequantized to bf16 in
    advance, which reads twice the weight's bytes."""
    out = {}
    for suffix, (m, k, n) in (shapes or INT8_SHAPES).items():
        t = int8_inputs(dev, m, k, n)
        args = (t["x"], t["wq"], t["scale"], t["b"])
        args32 = (t["x"].float(), t["wq"], t["scale"].float(),
                  t["b"].float())
        work = {"int8_dense": (2 * m * k * n,
                               2 * m * k + k * n + 4 * n + 2 * m * n)}
        w_nk = t["wq"].t().contiguous()
        library = {"int8_dense": lambda: torch._weight_int8pack_mm(
            t["x"], w_nk, t["scale"])}
        print(f"[kernel] int8_dense (row 18) at M {m}, K {k}, N {n} "
              "(library: torch._weight_int8pack_mm, no bias):", flush=True)
        res = check_entries(
            dev, t, {"int8_dense": (lambda: int8_mod.int8_dense(*args),
                                    lambda: int8_mod.int8_dense_plain(*args),
                                    lambda: int8_mod.int8_dense_plain(
                                        *args32))},
            timed, work=work, library=library)
        out["int8_dense" + suffix] = res["int8_dense"]
        bn, splits = int8_mod.plan(m, k, n, int8_mod.sm_count(dev))
        print(f"[kernel] int8_dense{suffix}: blocks {bn} wide, the "
              f"contraction split {splits} ways", flush=True)
        if timed:
            wd = t["wq"].to(torch.bfloat16)
            ms = median_ms(lambda: torch.matmul(t["x"], wd))
            print(f"[kernel] int8_dense{suffix}: torch.matmul on the codes "
                  f"dequantized in advance (reads twice the weight's "
                  f"bytes, no scale or bias) {ms:.4f} ms", flush=True)
            del wd
    return out


def pair_args(inp) -> tuple:
    """``block_pair_fwd``'s tensor arguments from ``inp``'s attention and
    MLP halves (two blocks' halves, as the entries of rows 5 and 9)."""
    a, m = inp["attn"], inp["mlp"]
    return (a["x"], a["wq"], a["bq"], a["u1"], a["v1"], a["wp"], a["bp"],
            a["u2"], a["v2"], a["cb2"], a["ln_scale"], a["ln_bias"],
            m["w1"], m["b1"], m["u1"], m["v1"], m["cb1"], m["w2"], m["b2"],
            m["u2"], m["v2"], m["cb2"], m["ln_scale"], m["ln_bias"])


def split_halves(inp, args):
    """The port's two half-block kernels (rows 5 and 9) with unit gates
    on the same block: what row 19 computes in two launches."""
    h, sm, n = inp["heads"], inp["sm"], inp["n_real"]
    b = args[0].shape[0]
    ones = args[0].new_ones((b, 1))
    xm = attn_mod.cp_attn_block(*args[:12], ones, h, sm, n,
                                ln_eps=inp["eps"])
    return mlp_mod.cp_mlp_block(xm, *args[12:], ones.reshape(b, 1, 1),
                                act=inp["act"], ln_eps=inp["eps"])


def pair_kernel_phase(dev, inp, timed: bool = True, name=None) -> dict:
    """Row 19's entry at ``inp``'s shapes against its fp32 plain version,
    then against the port's split halves (rows 5 and 9) on the card:
    max |difference| within twice the forward tolerance (each is within
    it of the fp32 reference).  No PyTorch call computes a block, so the
    entry's ``library_ms`` is None; ``split_ms`` is the split halves'
    time, its yardstick.  With ``inp["act"]`` "quick_gelu" the entry is
    ``block_pair_fwd_quick``, unless ``name`` names it (``PAIR_FORMS``).
    ``inp["eps"]`` is both LayerNorms' eps."""
    h, sm, n = inp["heads"], inp["sm"], inp["n_real"]
    act, eps = inp["act"], inp["eps"]
    if name is None:
        name = QUICK_ENTRIES["block_pair_fwd"] if act != "gelu" \
            else "block_pair_fwd"
    args = pair_args(inp)
    args32 = tuple(t.float() for t in args)
    a, m = inp["attn"], inp["mlp"]
    e, hid = inp["e"], m["w1"].shape[1]
    r, rows = a["u1"].shape[1], inp["b"] * inp["n"]

    def site(k, nout):
        return 2 * rows * (k * nout + k * r + r * nout)

    weights = sum(2 * t.numel() for t in args[1:])
    # the two halves' products; x read and y written (qkv, the attention
    # output, x_mid and h are the kernels' own)
    work = {name: (
        site(e, 3 * e) + 4 * inp["b"] * inp["n"] * n * e + site(e, e)
        + site(e, hid) + site(hid, e), 2 * rows * e * 2 + weights)}
    print(f"[kernel] {name} (row 19, {act}) at B {inp['b']}, N "
          f"{inp['n']}, E {e}, H {h} of width {e // h}, hidden {hid}, "
          f"LayerNorm eps {eps}:", flush=True)
    out = check_entries(
        dev, inp, {name: (
            lambda: pair_mod.block_pair_fwd(*args, h, sm, n, 1.0, act=act,
                                            ln_eps=eps),
            lambda: pair_mod.block_pair_fwd_plain(*args, h, sm, n, 1.0, act,
                                                  eps),
            lambda: pair_mod.block_pair_fwd_plain(*args32, h, sm, n, 1.0,
                                                  act, eps))},
        timed, work=work, library={})
    got = pair_mod.block_pair_fwd(*args, h, sm, n, 1.0, act=act,
                                  ln_eps=eps).float()
    ref = split_halves(inp, args).float()
    atol, rtol = KERNEL_TOL[name]
    err = (got - ref).abs()
    excess = (err - 2 * (atol + rtol * ref.abs())).max().item()
    print(f"[kernel] {name} vs the split halves (rows 5 + 9): "
          f"max|diff| {err.max().item():.3e}, tolerance 2 x (atol {atol} "
          f"+ rtol {rtol}*|ref|) ({'ok' if excess <= 0 else 'MISS'})",
          flush=True)
    require(excess <= 0, f"{name} disagrees with the split halves")
    split_ms = median_ms(lambda: split_halves(inp, args)) if timed else None
    if timed:
        print(f"[kernel] {name}: split halves (rows 5 + 9) "
              f"{split_ms:.4f} ms", flush=True)
    out[name]["split_ms"] = split_ms
    return out


def gemm_operands(inp) -> dict:
    """Row 11's products' operands at ``inp``'s shapes (the MLP block of
    ``inp["mlp"]``): xa = bf16(LN2(x)), the fp32 pre-activation and
    (pre16) its bf16 rounding, the saved form's, h = bf16(gelu(pre)), g2
    = the cotangent, dpre = bf16((g2 W2^T) gelu'(pre)), and W1, b1, cb1,
    W2."""
    m = inp["mlp"]
    e, act = inp["e"], inp["act"]
    bf = torch.bfloat16
    xa = layer_norm(m["x"].reshape(-1, e).float(), m["ln_scale"].float(),
                    m["ln_bias"].float(), inp["eps"]).to(bf)
    pre = (xa.float() @ m["w1"].float() + m["b1"].float()
           + m["cb1"].float())
    g2 = inp["g_mlp"].reshape(-1, e)
    dpre = ((g2.float() @ m["w2"].float().t())
            * activation_grad(pre, act)).to(bf)
    return dict(xa=xa, pre=pre, pre16=pre.to(bf),
                h=activation(pre, act).to(bf), g2=g2, dpre=dpre, w1=m["w1"],
                b1=m["b1"], cb1=m["cb1"], w2=m["w2"], act=act)


def gemm_kernel_calls(inp, o):
    """:func:`kernel_calls` for ``GEMM_PRODUCTS`` on the operands ``o``
    (:func:`gemm_operands`): ``_bwd.gemm`` against the same product and
    epilogue in PyTorch, in bf16 (plain) and fp32; the DGELU column sums
    per 128-row block as the kernel writes them.  With
    :func:`gemm_library_calls`."""
    e, hid = o["w1"].shape
    rows = o["xa"].shape[0]
    blocks = -(-rows // 128)
    act = o["act"]

    def cast(dtype):
        return {k: v.to(dtype) if isinstance(v, torch.Tensor)
                and v.dtype == torch.bfloat16 else v for k, v in o.items()}

    def pre_gelu(t):
        pre = (t["xa"] @ t["w1"]).float() + t["b1"].float() + t["cb1"].float()
        return {"pre": pre, "out": activation(pre, act).to(t["xa"].dtype)}

    def dgelu(t, key="pre"):
        dpre = (t["g2"] @ t["w2"].t()).float() * activation_grad(
            t[key].float(), act)
        pad = F.pad(dpre, (0, 0, 0, blocks * 128 - rows))
        return {"out": dpre.to(t["g2"].dtype),
                "colpart": pad.reshape(blocks, 128, hid).sum(1)}

    def dgelu_h(t):  # on the saved bf16 pre, h = gelu(pre) beside dpre
        return dict(dgelu(t, "pre16"),
                    h=activation(t["pre16"].float(), act).to(t["g2"].dtype))

    def tn(a, b):
        return {"out": _bwd.gemm(_bwd.TN, _bwd.EPI_F32, a, b,
                                 splits=_bwd.dt_splits(a.shape[1],
                                                       b.shape[1], rows))}

    plain = {
        "grad_gemm_nn_pre_gelu": pre_gelu,
        "grad_gemm_nt_dgelu": dgelu,
        "grad_gemm_nt_dgelu_h": dgelu_h,
        "grad_gemm_nt_dxa": lambda t: {
            "out": (t["dpre"] @ t["w1"].t()).float()},
        "grad_gemm_tn_dt1": lambda t: {
            "out": (t["xa"].t() @ t["dpre"]).float()},
        "grad_gemm_tn_dt2": lambda t: {"out": (t["h"].t() @ t["g2"]).float()},
    }
    kernel = {
        "grad_gemm_nn_pre_gelu": lambda: dict(zip(("pre", "out"), _bwd.gemm(
            _bwd.NN, _bwd.EPI_PRE_GELU, o["xa"], o["w1"], bias1=o["b1"],
            bias2=o["cb1"], act=act))),
        "grad_gemm_nt_dgelu": lambda: dict(zip(("out", "colpart"), _bwd.gemm(
            _bwd.NT, _bwd.EPI_DGELU, o["g2"], o["w2"], aux=o["pre"],
            act=act))),
        "grad_gemm_nt_dgelu_h": lambda: dict(zip(
            ("out", "colpart", "h"), _bwd.gemm(
                _bwd.NT, _bwd.EPI_DGELU_H, o["g2"], o["w2"],
                aux=o["pre16"], act=act))),
        "grad_gemm_nt_dxa": lambda: {"out": _bwd.gemm(
            _bwd.NT, _bwd.EPI_F32, o["dpre"], o["w1"])},
        "grad_gemm_tn_dt1": lambda: tn(o["xa"], o["dpre"]),
        "grad_gemm_tn_dt2": lambda: tn(o["h"], o["g2"]),
    }
    bf16, f32 = cast(torch.bfloat16), cast(torch.float32)
    return {name: (kernel[name], functools.partial(fn, bf16),
                   functools.partial(fn, f32))
            for name, fn in plain.items()}


def gemm_library_calls(o) -> dict:
    """One ``torch.matmul`` on the same bf16 operands for each of
    ``GEMM_PRODUCTS`` (the product without its epilogue): a yardstick,
    timed only."""
    return {
        "grad_gemm_nn_pre_gelu": lambda: torch.matmul(o["xa"], o["w1"]),
        "grad_gemm_nt_dgelu": lambda: torch.matmul(o["g2"], o["w2"].t()),
        "grad_gemm_nt_dgelu_h": lambda: torch.matmul(o["g2"], o["w2"].t()),
        "grad_gemm_nt_dxa": lambda: torch.matmul(o["dpre"], o["w1"].t()),
        "grad_gemm_tn_dt1": lambda: torch.matmul(o["xa"].t(), o["dpre"]),
        "grad_gemm_tn_dt2": lambda: torch.matmul(o["h"].t(), o["g2"]),
    }


def gemm_kernel_phase(dev, inp, timed: bool = True) -> dict:
    """``GEMM_PRODUCTS`` at ``inp``'s shapes, each against its fp32 plain
    version, timed beside ``torch.matmul``."""
    o = gemm_operands(inp)
    e, hid = o["w1"].shape
    print(f"[kernel] grad_gemm.cu alone at row 11's products: M "
          f"{o['xa'].shape[0]}, E {e}, hidden {hid}:", flush=True)
    return check_entries(dev, inp, gemm_kernel_calls(inp, o), timed,
                         library=gemm_library_calls(o) if timed else {})


def site_operands(inp) -> dict:
    """name -> (positional arguments, keyword arguments) of
    ``_site.site_cuda`` for each of ``SITE_PRODUCTS`` at ``inp``'s
    shapes: the qkv site (LN1, no cb) on the attention block's x, the
    projection with the residual on ``inp["o"]``, fc1 (LN2, GELU) on the
    MLP block's x, fc2 with the residual on a hidden activation,
    fc1's dact mode on the hidden cotangent, and fc1 writing its
    pre-activation beside h; drop-path gates by image, delta scale
    ``SITE_SCALE``."""
    a, m = inp["attn"], inp["mlp"]
    b, n, e = inp["b"], inp["n"], inp["e"]
    hid = m["w1"].shape[1]
    x_attn, x_mlp = a["x"].reshape(-1, e), m["x"].reshape(-1, e)
    dpm = inp["gates"].float().expand(b, n).reshape(-1).contiguous()
    hidden = inp["g_hid"].reshape(-1, hid)
    ln1 = (a["ln_scale"], a["ln_bias"], inp["eps"])
    ln2 = (m["ln_scale"], m["ln_bias"], inp["eps"])
    act = inp["act"]
    fc1 = (x_mlp, m["w1"], m["b1"], m["u1"], m["v1"], m["cb1"],
           SITE_SCALE)
    return {
        "cp_site_qkv_ln": ((x_attn, a["wq"], a["bq"], a["u1"], a["v1"],
                            None, SITE_SCALE), dict(ln=ln1)),
        "cp_site_proj_res": ((inp["o"].reshape(-1, e), a["wp"], a["bp"],
                              a["u2"], a["v2"], a["cb2"], SITE_SCALE),
                             dict(res=x_attn, dpm_rows=dpm)),
        "cp_site_fc1_ln_gelu": (fc1, dict(ln=ln2, act=act)),
        "cp_site_fc2_res": ((hidden, m["w2"], m["b2"], m["u2"], m["v2"],
                             m["cb2"], SITE_SCALE),
                            dict(res=x_mlp, dpm_rows=dpm)),
        "cp_site_fc1_dact": (fc1, dict(ln=ln2, act=act, dact_g=hidden)),
        SAVE_PRE_SITE: (fc1, dict(ln=ln2, act=act, return_pre=True)),
    }


def site_kernel_calls(inp) -> dict:
    """:func:`kernel_calls` for ``SITE_PRODUCTS``: ``_site.site_cuda``
    against ``_site.site_forward_plain`` on the same inputs, in bf16 and
    in fp32 (:func:`site_operands`); the save-pre site's two outputs as
    {"h", "pre16"}, the plain pre-activation rounded to the dtype."""

    def cast(t, dtype):
        if isinstance(t, tuple):
            return tuple(cast(v, dtype) for v in t)
        if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
            return t.to(dtype)
        return t

    out = {}
    def with_pre(kern):
        return lambda: dict(zip(("h", "pre16"), kern()))

    for name, (args, kw) in site_operands(inp).items():
        def plain(dtype, args=args, kw=kw):
            kw = {k: cast(v, dtype) for k, v in kw.items()}
            if not kw.pop("return_pre", False):
                return _site.site_forward_plain(*cast(args, dtype), **kw)
            return {"h": _site.site_forward_plain(*cast(args, dtype), **kw),
                    "pre16": _site.site_forward_plain(
                        *cast(args, dtype), **dict(kw, act=None))}

        kern = functools.partial(_site.site_cuda, *args, **kw)
        out[name] = (with_pre(kern) if kw.get("return_pre") else kern,
                     functools.partial(plain, torch.bfloat16),
                     functools.partial(plain, torch.float32))
    return out


def site_library_calls(inp) -> dict:
    """One ``torch.matmul`` of each site's dense product (x W, on xa =
    bf16(LN(x)) for an LN site) on the same bf16 operands: a yardstick,
    timed only."""
    out = {}
    for name, (args, kw) in site_operands(inp).items():
        x2, w = args[0], args[1]
        if "ln" in kw:
            x2 = layer_norm(x2, *kw["ln"])
        out[name] = functools.partial(torch.matmul, x2, w)
    return out


def site_kernel_phase(dev, inp, timed: bool = True) -> dict:
    """``SITE_PRODUCTS`` at ``inp``'s shapes, each against its fp32 plain
    version, timed beside ``torch.matmul``."""
    print(f"[kernel] cp_site.cu at ViT-B's forward sites: M "
          f"{inp['b'] * inp['n']}, E {inp['e']}, hidden "
          f"{inp['mlp']['w1'].shape[1]}, rank {inp['attn']['u1'].shape[1]}, "
          f"s {SITE_SCALE}:", flush=True)
    return check_entries(dev, inp, site_kernel_calls(inp), timed,
                         library=site_library_calls(inp) if timed else {})


def kernel_work(inp) -> dict:
    """name -> (operations, bytes) of each entry's call at these inputs:
    the products the function needs (a backward recomputes what its
    forward did not keep, once; a kernel that recomputes more is held to
    that; softmax and row passes are not counted as operations), each input
    read once and each output written once (bf16 2 bytes, fp32 factor
    and bias gradients 4).  Attention counts the valid keys only."""
    a, m = inp["attn"], inp["mlp"]
    b, n, nr, e = inp["b"], inp["n"], inp["n_real"], inp["e"]
    r, hid = a["u1"].shape[1], m["w1"].shape[1]
    rows = b * n

    def nb(*tensors, width=2):
        return width * sum(t.numel() for t in tensors)

    def site(k, nout):  # x W + (x U) V on `rows` rows
        return 2 * rows * (k * nout + k * r + r * nout)

    attn = 4 * b * n * nr * e          # q k^T and p v
    attn_bwd = 10 * b * n * nr * e     # s recomputed, dv, dp, dq, dk
    act = rows * e * 2                 # one (M, E) bf16 activation
    qkv_act = 3 * act
    lse = rows * inp["heads"] * 4
    attn_w = nb(*(a[k] for k in ("wq", "bq", "u1", "v1", "wp", "bp", "u2",
                                 "v2", "cb2", "ln_scale", "ln_bias")))
    mlp_w = nb(*(m[k] for k in ("w1", "b1", "u1", "v1", "cb1", "w2", "b2",
                                "u2", "v2", "cb2", "ln_scale", "ln_bias")))
    proj_w = nb(*(a[k] for k in ("wp", "bp", "u2", "v2", "cb2")))
    folds = [(a["wq"], a["u1"]), (a["wp"], a["u2"]), (m["w1"], m["u1"]),
             (m["w2"], m["u2"])]
    fold_ops = [2 * w.numel() * r for w, _ in folds]
    fold_bytes = [2 * nb(w) + nb(u) + r * w.shape[1] * 2 for w, u in folds]
    # the masked finish: dU = dtc V^T and dV = U^T dtc per site
    finish = [2 * f for f in fold_ops]
    def factor(k, nout):  # fp32 dU (K, r) and dV (r, N) written
        return 4 * r * (k + nout)

    # row 13's fc1 site: x read, the (M, hidden) output written (the
    # dact reads its cotangent too); the W' form folds, then runs at
    # rank 0, and its dact reads W' in place of W, U and V
    hid_act = rows * hid * 2
    fc1_w = nb(*(m[k] for k in ("w1", "b1", "u1", "v1", "cb1", "ln_scale",
                                "ln_bias")))
    fc1_wp = nb(*(m[k] for k in ("w1", "b1", "cb1", "ln_scale", "ln_bias")))
    dense_fc1 = 2 * rows * e * hid
    # z1, z1 V1, gv2, gv2 U2^T, gv1, gv1 U1^T, z2 and the four factor
    # products of the MLP backward: 5 of width E, 6 of width hidden
    mlp_rank = 2 * rows * r * (5 * e + 6 * hid)
    # row 11's products alone: each 2 M E hidden operations; bf16 operands
    # read, outputs written (fp32 pre, dxa and dT; the DGELU column sums
    # one fp32 row per 128-row block)
    gemm = 2 * rows * e * hid
    w_bytes = e * hid * 2
    # the forward sites alone: x (or h) read, the output written, the
    # residual or the cotangent read, the row gates (fp32) read
    gates = rows * 4
    qkv_w = nb(*(a[k] for k in ("wq", "bq", "u1", "v1", "ln_scale",
                                "ln_bias")))
    fc2_w = nb(*(m[k] for k in ("w2", "b2", "u2", "v2", "cb2")))
    return {
        "cp_site_qkv_ln": (site(e, 3 * e), act + qkv_w + qkv_act),
        "cp_site_proj_res": (site(e, e), 3 * act + proj_w + gates),
        "cp_site_fc1_ln_gelu": (site(e, hid), act + fc1_w + hid_act),
        "cp_site_fc2_res": (site(hid, e), hid_act + fc2_w + 2 * act
                            + gates),
        "cp_site_fc1_dact": (site(e, hid), act + fc1_w + 2 * hid_act),
        # h and the bf16 pre-activation written
        SAVE_PRE_SITE: (site(e, hid), act + fc1_w + 2 * hid_act),
        "grad_gemm_nn_pre_gelu": (gemm, act + w_bytes + 4 * hid
                                  + rows * hid * 6),
        "grad_gemm_nt_dgelu": (gemm, act + w_bytes + rows * hid * 6
                               + -(-rows // 128) * hid * 4),
        # the bf16 pre read, dpre and h written
        "grad_gemm_nt_dgelu_h": (gemm, act + w_bytes + rows * hid * 6
                                 + -(-rows // 128) * hid * 4),
        "grad_gemm_nt_dxa": (gemm, hid_act + w_bytes + rows * e * 4),
        "grad_gemm_tn_dt1": (gemm, act + hid_act + e * hid * 4),
        "grad_gemm_tn_dt2": (gemm, hid_act + act + e * hid * 4),
        "fused_qkv_attention": (attn, qkv_act + act),
        "cp_attn_block": (site(e, 3 * e) + attn + site(e, e),
                          2 * act + attn_w),
        "cp_mlp_block": (site(e, hid) + site(hid, e), 2 * act + mlp_w),
        "build_wd_weight": (sum(fold_ops), sum(fold_bytes)),
        "cp_attn_block_wd": (
            fold_ops[0] + fold_ops[1] + 2 * rows * (3 * e * e + e * e) + attn,
            2 * act + attn_w),
        "cp_attn_block_wd_bwd": (
            2 * rows * (3 * e * e) * 3 + 2 * rows * e * e * 2 + attn
            + attn_bwd + finish[0] + finish[1],
            3 * act + attn_w + factor(e, 3 * e) + factor(e, e)),
        "cp_mlp_block_wd_bwd": (
            5 * 2 * rows * e * hid + finish[2] + finish[3],
            3 * act + mlp_w + factor(e, hid) + factor(hid, e)
            + 4 * (hid + e)),
        "cp_dense": (site(e, 3 * e) + site(e, e),
                     act + qkv_act + 2 * act + attn_w),
        "cp_dense_dx": (
            site(3 * e, e) + site(e, e) + 2 * rows * r * (2 * e + 3 * e)
            + 2 * rows * r * (2 * e + e),
            qkv_act + 2 * act + 3 * act + attn_w + factor(e, 3 * e)
            + factor(e, e)),
        "fused_qkv_attention_bwd": (attn_bwd, 2 * qkv_act + act),
        "cp_mlp_block_bwd": (
            3 * 2 * rows * e * hid + mlp_rank,
            3 * act + mlp_w + factor(e, hid) + factor(hid, e)
            + 4 * (hid + e)),
        # the saved forms: the backward's own products (no fc1 or qkv
        # product, no z1 V1, no attention forward), and the saved
        # residual read (the pre-activation; qkv and the attention output)
        "cp_mlp_block_bwd_saved": (
            2 * 2 * rows * e * hid + 2 * rows * r * 5 * (e + hid),
            3 * act + mlp_w + factor(e, hid) + factor(hid, e)
            + 4 * (hid + e) + hid_act),
        "cp_mlp_block_wd_bwd_saved": (
            4 * 2 * rows * e * hid + finish[2] + finish[3],
            3 * act + mlp_w + factor(e, hid) + factor(hid, e)
            + 4 * (hid + e) + hid_act),
        "cp_attn_block_wd_bwd_saved": (
            2 * rows * (3 * e * e) * 2 + 2 * rows * e * e * 2 + attn_bwd
            + finish[0] + finish[1],
            3 * act + attn_w + factor(e, 3 * e) + factor(e, e) + qkv_act
            + act),
        # s, p v; its output and the (B, N, H) fp32 log-sum-exp
        "blockwise_qkv_attention": (attn, qkv_act + act + lse),
        # s, dp, dq, dk and dv over the valid keys (the kernels recompute
        # s and dp, as the TPU's do; recomputes are not the function's)
        "blockwise_qkv_attention_bwd": (attn_bwd,
                                        2 * qkv_act + 2 * act + lse),
        "cp_dense_wd": (
            fold_ops[0] + fold_ops[1] + 2 * rows * (3 * e * e + e * e),
            act + qkv_act + 2 * act + attn_w),
        # dx = g W'^T and dT = xa^T g at both sites, and their finish
        "cp_dense_wd_bwd": (
            2 * 2 * rows * (3 * e * e + e * e) + finish[0] + finish[1],
            qkv_act + 3 * act + 2 * act + attn_w + factor(e, 3 * e)
            + factor(e, e) + 4 * e),
        "cp_wd_factor_grads": (2 * rows * e * 3 * e + finish[0],
                               act + qkv_act + factor(e, 3 * e)),
        # q, k, v read, o written; its backward reads q, k, v and do and
        # writes dq, dk, dv (the kernels' saved o and lse are theirs)
        "flash_attention": (attn, qkv_act + act),
        "flash_attention_bwd": (attn_bwd, 2 * qkv_act + act),
        "cp_dense_gelu": (site(e, hid), act + hid_act + fc1_w),
        "cp_dense_dact": (site(e, hid), act + 2 * hid_act + fc1_w),
        "cp_dense_wd_gelu": (fold_ops[2] + dense_fc1,
                             act + hid_act + fc1_w),
        "cp_dense_wd_dact": (dense_fc1, act + 2 * hid_act + fc1_wp),
        # row 3: the attention, then the projection site on its output
        # (which never leaves the kernel); qkv read, y written
        "fused_qkv_attention_proj": (attn + site(e, e),
                                     qkv_act + act + proj_w),
        # rows 3 and 4 backward: the projection's dx (g W^T, gv = g V^T,
        # gv U^T), its factor products (du, z = o U, dv), o recomputed
        # (the forward keeps only qkv) and the attention backward; qkv and
        # g read, dqkv, the fp32 factor gradients and db, dcb written
        "fused_qkv_attention_proj_bwd": (
            site(e, e) + 2 * rows * r * 3 * e + attn + attn_bwd,
            2 * qkv_act + act + proj_w + factor(e, e) + 4 * 2 * e),
        # row 6: both sites' dx with their rank steps, both sites' factor
        # products (du, z, dv), o recomputed from the kept qkv (the TPU's
        # save-qkv default: no qkv GEMM) and the attention backward; x, g
        # and qkv read, dx, the fp32 factor gradients and the three bias
        # gradients written
        "cp_attn_block_bwd": (
            site(3 * e, e) + site(e, e) + 2 * rows * r * (2 * e + 3 * e)
            + 2 * rows * r * 3 * e + attn + attn_bwd,
            qkv_act + 3 * act + attn_w + factor(e, 3 * e) + factor(e, e)
            + 4 * 5 * e),
    }


# The tiled attention backward's entries held for bitwise determinism at
# the smoke's batch: (entry, N, heads, head width): ViT-B's twelve heads
# of 64, then ViT-H's sixteen of 80 (one dq staging buffer).
DETERMINISM_ROWS = (("fused_qkv_attention_bwd", 197, 12, 64),
                    ("fused_qkv_attention_bwd", 512, 12, 64),
                    ("blockwise_qkv_attention_bwd", 577, 12, 64),
                    ("flash_attention_bwd", 197, 12, 64),
                    ("flash_attention_bwd", 577, 12, 64),
                    ("fused_qkv_attention_bwd", 257, 16, 80),
                    ("fused_qkv_attention_bwd", 512, 16, 80),
                    ("blockwise_qkv_attention_bwd", 577, 16, 80),
                    ("flash_attention_bwd", 257, 16, 80))


def attention_bwd_call(name, inp):
    """The kernel call of an attention backward entry (rows 2, 16, 17) on
    ``inp``'s qkv and cotangent: -> dict of dq, dk, dv."""
    h, sm, n = inp["heads"], inp["sm"], inp["n_real"]
    b, e = inp["b"], inp["e"]
    if name == "fused_qkv_attention_bwd":
        return row2_bwd_calls(inp)[0]
    if name == "blockwise_qkv_attention_bwd":
        call = _grad_call(
            lambda t: bwa_mod.blockwise_qkv_attention(t["qkv"], h, sm, n),
            {"qkv": inp["qkv"]}, ("qkv",), inp["g_attn"], torch.bfloat16)
        return lambda: dict(zip(("dq", "dk", "dv"),
                                call()["qkv"].chunk(3, dim=-1)))
    qkv = inp["qkv"].detach().requires_grad_(True)
    q, k, v = (t.transpose(1, 2)
               for t in qkv.reshape(b, inp["n"], 3, h, e // h).unbind(2))
    out = flash_mod.flash_attention(q, k, v, sm)
    g = inp["g_attn"].reshape(b, inp["n"], h, e // h).transpose(1, 2)
    return lambda: dict(zip(("dq", "dk", "dv"), torch.autograd.grad(
        out, (q, k, v), g, retain_graph=True)))


def determinism_phase(dev, b: int = 64, e: int = 768, heads: int = 12,
                      steps: int = 2, batch: int = 64,
                      model: str = MODEL) -> None:
    """Bitwise determinism: each of ``DETERMINISM_ROWS`` called twice on
    the same inputs at batch ``b`` gives dq, dk and dv bit for bit (dq's
    fp32 sum is taken in key-tile order), each of ``SITE_PRODUCTS`` its
    output at N 197 and width ``e``; then two runs of ``steps`` rank
    steps of ViT-B at 224 px from the same state and seed end with every
    trainable leaf bit for bit the same.  Fails the run on any
    difference."""
    for name, n, h, dh in DETERMINISM_ROWS:
        inp = kernel_inputs(dev, b=b, n=n, e=h * dh, heads=h,
                            hidden=4 * h * dh, seed=7)
        call = attention_bwd_call(name, inp)
        first = call()
        second = call()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        same = {k: bool(torch.equal(first[k], second[k])) for k in first}
        told = ", ".join(k + (" equal" if v else " DIFFERENT")
                         for k, v in same.items())
        print(f"[determinism] {name} at B {b}, N {n}, {h} heads of {dh}: "
              f"two calls give {told}", flush=True)
        require(all(same.values()), f"{name} at N {n}, head width {dh} is "
                "not bitwise deterministic")
        del inp, call, first, second
    # The forward sites (no split contraction): the same output twice.
    inp = kernel_inputs(dev, b=b, n=197, e=e, heads=heads, hidden=4 * e,
                        seed=7)
    for name, (kern, _, _) in site_kernel_calls(inp).items():
        first, second = kern(), kern()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        if not isinstance(first, dict):
            first, second = {"out": first}, {"out": second}
        same = all(torch.equal(first[k], second[k]) for k in first)
        print(f"[determinism] {name} at B {b}, N 197: two calls give "
              f"{'equal' if same else 'DIFFERENT'} outputs", flush=True)
        require(same, f"{name} is not bitwise deterministic")
    del inp
    leaves = []
    for _ in range(2):
        cfg, cara_cfg, frozen, state, data = train_setup(
            dev, model=model, batch=batch, impl="rank")
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        state, losses, _, _ = fixed_batch_steps(
            cfg, cara_cfg, frozen, state, data, gen, steps, timed=False)
        leaves.append(dict(steps_lib.tree_leaves(state.trainable)))
        del frozen, data
    differ = [k for k in leaves[0]
              if not torch.equal(leaves[0][k], leaves[1][k])]
    print(f"[determinism] rank route of {model}, batch {batch}: two runs of "
          f"{steps} steps from one state and seed give "
          f"{len(leaves[0]) - len(differ)} of {len(leaves[0])} trainable "
          f"leaves bit for bit (losses {losses})", flush=True)
    require(not differ, f"rank steps are not bitwise reproducible: "
            f"{differ[:5]}")


def bound(ops: float, nbytes: float):
    """(least ms, "operations" or "bytes") on the published peaks."""
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def library_calls(inp) -> dict:
    """name -> one PyTorch call computing the entry's function on the same
    inputs, where there is one: ``F.scaled_dot_product_attention`` forward
    (rows 1, 16 and 17) and its backward (rows 2, 16 and 17); for row 3
    SDPA's forward then ``torch.addmm`` for the projection, for its
    backward SDPA's backward and the projection's dx GEMM (the rank delta
    left out of both).  Yardsticks, timed only."""
    b, n, nr, e, h = (inp["b"], inp["n"], inp["n_real"], inp["e"],
                      inp["heads"])
    q, k, v = (t.detach().clone().requires_grad_(True) for t in
               inp["qkv"].reshape(b, n, 3, h, e // h).permute(2, 0, 3, 1, 4))
    mask = None
    if nr < n:
        mask = (torch.arange(n, device=q.device) < nr).reshape(1, 1, 1, n)
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                         scale=inp["sm"])
    g = inp["g_attn"].reshape(b, n, h, e // h).transpose(1, 2)
    qd, kd, vd = q.detach(), k.detach(), v.detach()

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                                  scale=inp["sm"])

    def bwd():
        return torch.autograd.grad(out, (q, k, v), g, retain_graph=True)

    a = inp["attn"]
    g2 = inp["g_attn"].reshape(b * n, e)

    def fwd_proj():  # SDPA, then torch.addmm for the projection
        o = fwd().transpose(1, 2).reshape(b * n, e)
        return torch.addmm(a["bp"], o, a["wp"])

    def bwd_proj():  # SDPA's backward and the projection's dx GEMM
        return bwd(), g2 @ a["wp"].t()

    return {"fused_qkv_attention": fwd, "fused_qkv_attention_bwd": bwd,
            "blockwise_qkv_attention": fwd,
            "blockwise_qkv_attention_bwd": bwd,
            "flash_attention": fwd, "flash_attention_bwd": bwd,
            "fused_qkv_attention_proj": fwd_proj,
            "fused_qkv_attention_proj_bwd": bwd_proj}


def rel_l2(out, ref) -> float:
    return ((out.float() - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def _check_outputs(name, out, ref) -> float:
    """Elementwise bound for tensors, the fold's weights and a backward's
    dx; relative L2 for the other gradients (``ELEMENTWISE_KEYS``).
    Returns the max |err| over all outputs."""
    if not isinstance(out, dict):
        out, ref = {"out": out}, {"out": ref}
    max_err = 0.0
    for key in out:
        o, r = out[key].float(), ref[key].float()
        require(o.shape == r.shape, f"{name}/{key}: shape {tuple(o.shape)}")
        require(bool(torch.isfinite(o).all()), f"{name}/{key}: non-finite")
        err = (o - r).abs()
        max_err = max(max_err, err.max().item())
        if key in ELEMENTWISE_KEYS or name.startswith("build_wd_weight"):
            atol, rtol = KERNEL_TOL[name]
            excess = (err - (atol + rtol * r.abs())).max().item()
            print(f"[kernel] {name}/{key}: max|err| {err.max().item():.3e} "
                  f"vs fp32 plain, tolerance atol {atol} + rtol {rtol}*|ref| "
                  f"({'ok' if excess <= 0 else 'MISS'})", flush=True)
            require(excess <= 0, f"{name}/{key}: kernel disagrees with plain")
        else:
            rel = rel_l2(o, r)
            print(f"[kernel] {name}/{key}: relative L2 {rel:.3e} vs fp32 "
                  f"plain (max|err| {err.max().item():.3e}), bound "
                  f"{GRAD_REL_L2} "
                  f"({'ok' if rel <= GRAD_REL_L2 else 'MISS'})", flush=True)
            require(rel <= GRAD_REL_L2, f"{name}/{key}: kernel disagrees "
                    "with plain")
    return max_err


def wd_keep_check(dev, inp) -> int:
    """The fold's keep pattern against the plain mask, bit for bit: with
    W = 0, U = V = 1 an output element is nonzero exactly where kept."""
    checked = 0
    for site, (w, u, v, sd) in _fold_sites(inp).items():
        k, nn = w.shape
        r = u.shape[1]
        ones_u = torch.ones((k, r), device=dev, dtype=torch.bfloat16)
        ones_v = torch.ones((r, nn), device=dev, dtype=torch.bfloat16)
        out = wd_fold.build_wd_weight(torch.zeros_like(w), ones_u, ones_v,
                                      sd, 1.0, DROP_RATE)
        keep = wd_fold.hash_keep_plain(0, 0, k, nn, sd, DROP_RATE, dev)
        same = bool(torch.equal(out != 0, keep))
        print(f"[kernel] build_wd_weight/{site}: keep pattern of {k}x{nn} "
              f"{'equals' if same else 'DIFFERS from'} the plain mask "
              f"(kept {keep.float().mean().item():.4f})", flush=True)
        require(same, f"build_wd_weight/{site}: keep pattern differs")
        checked += keep.numel()
    return checked


def kernel_phase(dev, inp, timed: bool = True) -> dict:
    """Each kernel against its fp32 plain version; returns per-kernel
    ``max_abs_err``, ``ms``, ``plain_ms``, ``bound_ms``, ``bound_by`` and
    ``library_ms``.  Then row 1 at the edges of its kernel's paths."""
    wd_keep_check(dev, inp)
    out = check_entries(dev, inp, kernel_calls(inp), timed)
    qkv_attention_edge_check(dev, inp)
    return out


# Row 1 past one 256-key chunk: ViT-L/14's 257 tokens (two chunks, keys
# masked as at 224 px with padding) and the kernel's cap, 512.
ROW1_EDGES = ((257, 250), (512, 512))


def qkv_attention_edge_check(dev, inp, batch=16) -> None:
    """Row 1 at each (N, n_real) of ``ROW1_EDGES`` (the two-chunk path: a
    pass for the row max, a pass for exp, the sum and P V) against its fp32
    plain version, ``KERNEL_TOL``, at ``inp``'s width."""
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    for n, n_real in ROW1_EDGES:
        qkv = (torch.randn((batch, n, 3 * inp["e"]), generator=g, device=dev)
               * 0.6).to(torch.bfloat16)
        args = (inp["heads"], inp["sm"], n_real)
        with torch.inference_mode():
            got = fqa_mod.fused_qkv_attention(qkv, *args)
        ref = fqa_mod.fused_qkv_attention_plain(qkv.float(), *args)
        print(f"[kernel] fused_qkv_attention at B {batch}, N {n}, keys >= "
              f"{n_real} masked:", flush=True)
        _check_outputs("fused_qkv_attention", got, ref)


# Row 2's backward past the previous kernel's shared-memory cap of 352
# tokens, up to row 1's 512: (N, n_real), the second with keys masked.
ROW2_EDGES = ((401, 401), (512, 500))


def row2_edge_phase(dev, timed: bool = True, b: int = 64, e: int = 768,
                    heads: int = 12) -> dict:
    """Row 2's entry at each (N, n_real) of ``ROW2_EDGES``, named
    ``fused_qkv_attention_bwd_<N>``, against its fp32 plain twin, timed
    beside SDPA's backward, with its bound."""
    out = {}
    for n, n_real in ROW2_EDGES:
        inp = kernel_inputs(dev, b=b, n=n, e=e, heads=heads, hidden=4 * e,
                            n_real=n_real, seed=3)
        print(f"[kernel] fused_qkv_attention_bwd at B {b}, N {n}, keys >= "
              f"{n_real} masked:", flush=True)
        name = "fused_qkv_attention_bwd"
        res = check_entries(dev, inp, {name: row2_bwd_calls(inp)}, timed)
        out[f"{name}_{n}"] = res[name]
        del inp
    return out


def row1_calls(inp):
    """Row 1's entry: the kernel, plain and fp32 plain calls of
    ``fused_qkv_attention`` on ``inp["qkv"]``."""
    h, sm, n = inp["heads"], inp["sm"], inp["n_real"]
    qkv = inp["qkv"]
    return (lambda: fqa_mod.fused_qkv_attention(qkv, h, sm, n),
            lambda: fqa_mod.fused_qkv_attention_plain(qkv, h, sm, n),
            lambda: fqa_mod.fused_qkv_attention_plain(qkv.float(), h, sm, n))


def dh_kernel_phase(dev, timed: bool = True, b: int = 64,
                    forms=None) -> dict:
    """The entries of ``DH_FORMS`` (``forms`` a subset): each its base
    entry's call at its N and head width -- sixteen heads at Dh 80
    (ViT-H/14: E 1280, hidden 5120), twelve at 16 and 32 -- held against
    its fp32 plain version, timed beside SDPA, bound by its base entry's
    work rule at these shapes.  At N 512 keys >= 500 are masked."""
    forms = DH_FORMS if forms is None else forms
    groups = {}
    for name, (base, n, dh) in forms.items():
        groups.setdefault((n, dh), []).append((name, base))
    out = {}
    for (n, dh), entries in groups.items():
        heads = 16 if dh == 80 else 12
        inp = kernel_inputs(dev, b=b, n=n, e=heads * dh, heads=heads,
                            hidden=4 * heads * dh, seed=n + dh,
                            n_real=500 if n == 512 else n)
        bases = {base for _, base in entries}
        calls = {"fused_qkv_attention": row1_calls,
                 "fused_qkv_attention_bwd": row2_bwd_calls}
        made = {}
        for base in bases:
            if base in calls:
                made[base] = calls[base](inp)
        if bases & set(BLOCKWISE_KERNELS):
            made.update({k: v for k, v in long_kernel_calls(inp).items()
                         if k in bases})
        if bases & set(FLASH_KERNELS):
            made.update({k: v for k, v in flash_kernel_calls(inp).items()
                         if k in bases})
        masked = (f", keys >= {inp['n_real']} masked"
                  if inp["n_real"] < n else "")
        print(f"[kernel] at B {b}, N {n}{masked}, {heads} heads of width "
              f"{dh}: "
              f"{', '.join(name for name, _ in entries)}", flush=True)
        res = check_entries(dev, inp, made, timed)
        for name, base in entries:
            out[name] = res[base]
        del inp, made, res
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def long_kernel_phase(dev, inp, timed: bool = True) -> dict:
    """:func:`kernel_phase` for the 384-px route's entries on ``inp`` (at
    N = 577), then the blockwise attention forward and backward at N = 640
    with keys >= 577 masked (the backward's last key tile wholly so)."""
    out = check_entries(dev, inp, long_kernel_calls(inp), timed)
    args = (inp["heads"], inp["sm"], inp["n_real"])
    blockwise_lse_check(inp["qkv"], *args)
    n, nr = 640, inp["n"]
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    qkv = (torch.randn((inp["b"], n, 3 * inp["e"]), generator=g, device=dev)
           * 0.6).to(torch.bfloat16)
    args = (inp["heads"], inp["sm"], nr)
    got = bwa_mod.blockwise_qkv_attention(qkv, *args)
    ref, _ = bwa_mod.blockwise_attention_fwd_plain(qkv.float(), *args)
    print(f"[kernel] blockwise_qkv_attention at N {n}, keys >= {nr} "
          "masked:", flush=True)
    _check_outputs("blockwise_qkv_attention", got, ref)
    blockwise_lse_check(qkv, *args)
    cot = torch.randn((inp["b"], n, inp["e"]), generator=g,
                      device=dev).to(torch.bfloat16)

    def bwd(impl, dtype):
        call = _grad_call(
            lambda t: bwa_mod.blockwise_qkv_attention(t["qkv"], *args,
                                                      impl=impl),
            {"qkv": qkv}, ("qkv",), cot, dtype)
        return dict(zip(("dq", "dk", "dv"), call()["qkv"].chunk(3, dim=-1)))

    print(f"[kernel] blockwise_qkv_attention_bwd at N {n}, keys >= {nr} "
          "masked:", flush=True)
    got = bwd("auto", torch.bfloat16)
    for key in ("dk", "dv"):
        require(not got[key][:, nr:].any(),
                f"blockwise_qkv_attention_bwd/{key}: keys past {nr} got a "
                "gradient")
    _check_outputs("blockwise_qkv_attention_bwd", got,
                   bwd("plain", torch.float32))
    return out


def blockwise_lse_check(qkv, heads, sm, n_real) -> float:
    """The blockwise forward kernel's log-sum-exp, which the backward
    reads, against the fp32 plain one: max |err| <= ``LSE_ATOL``.  A CPU
    tensor (a rehearsal) takes the plain forward in its own dtype."""
    fwd = (bwa_mod.attention_fwd_cuda if qkv.is_cuda
           else bwa_mod.blockwise_attention_fwd_plain)
    _, lse = fwd(qkv, heads, sm, n_real)
    _, ref = bwa_mod.blockwise_attention_fwd_plain(qkv.float(), heads, sm,
                                                   n_real)
    err = (lse - ref).abs().max().item()
    print(f"[kernel] blockwise_qkv_attention/lse at N {qkv.shape[1]}, "
          f"n_real {n_real}: max|err| {err:.3e} vs fp32 plain, tolerance "
          f"{LSE_ATOL} ({'ok' if err <= LSE_ATOL else 'MISS'})", flush=True)
    require(err <= LSE_ATOL, "blockwise_qkv_attention/lse: kernel "
            "disagrees with plain")
    return err


def check_entries(dev, inp, calls, timed: bool, work=None,
                  library=None) -> dict:
    """Each entry of ``calls`` against its fp32 plain version, timed;
    ``work`` (name -> (operations, bytes)) and ``library`` (name -> one
    PyTorch call) default to :func:`kernel_work` and
    :func:`library_calls` of ``inp``."""
    work = kernel_work(inp) if work is None else work
    if not timed:
        library = {}
    elif library is None:
        library = library_calls(inp)
    results = {}
    for name, (kern, plain, ref32) in calls.items():
        out = kern()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        max_err = _check_outputs(name, out, ref32())
        bound_ms, bound_by = bound(*work[name])
        ms = plain_ms = lib_ms = None
        if timed:
            ms = median_ms(kern)
            plain_ms = median_ms(plain)
            if name in library:
                lib_ms = median_ms(library[name],
                                   iters=LIBRARY_ITERS.get(name, 20))
            print(f"[kernel] {name}: median {ms:.4f} ms, plain "
                  f"(bf16 inputs) {plain_ms:.4f} ms over 20 runs; bound "
                  f"{bound_ms:.4f} ms by {bound_by} ({work[name][0]:.4e} "
                  f"operations, {work[name][1]:.4e} bytes); library "
                  f"{lib_ms if lib_ms is None else f'{lib_ms:.4f} ms'}",
                  flush=True)
        results[name] = {"max_abs_err": max_err, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": lib_ms}
    return results


@functools.lru_cache(maxsize=2)
def _seeded_backbone(cfg, seed):
    return convert.init_vit_params(cfg, seed)


def init_backbone(cfg, seed):
    """``convert.init_vit_params(cfg, seed)``: a fresh copy of arrays drawn
    once a process for each weight shape and seed (a ViT-B draw takes
    ~4 s on the host, a ViT-H one ~30; the smoke and ``--profile`` make a
    dozen).  The rates, on which no weight depends, are left out of the
    key, and so is the image size: another size takes the 224-px draw
    with a position embedding of its own length drawn from ``seed``."""
    key = dataclasses.replace(cfg, dropout_rate=0.0, attn_dropout_rate=0.0,
                              drop_path_rate=0.0, image_size=224)

    def copy(tree):
        return {k: copy(v) if isinstance(v, dict) else np.array(v)
                for k, v in tree.items()}
    tree = copy(_seeded_backbone(key, seed))
    if cfg.seq_len != key.seq_len:
        tree["pos_embed"] = convert._trunc_normal(
            np.random.default_rng(seed), (1, cfg.seq_len, cfg.embed_dim),
            0.02)
    return tree


def make_checkpoint(path, model=MODEL, num_classes=10, rank=8, scale=10.0,
                    seed=0, **overrides):
    cfg = get_model_config(model, num_classes=num_classes, **overrides)
    cara_cfg = CaraConfig(rank=rank, scale=scale, cp_order=4)
    params = init_backbone(cfg, seed)
    cara = convert.perturb_adapter(
        convert.init_cara_params(cfg, cara_cfg, seed + 1), seed + 2)
    meta = {"method": "cara", "scale": scale, "cp_order": 4,
            "weight_dropout": cara_cfg.weight_dropout, "model": model}
    if overrides:
        meta["model_overrides"] = overrides
    save_model(path, params, cara, meta)
    return cfg


def make_images(n, size, seed=0):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    return normalize(raw.astype(np.float32) / 255.0).astype(np.float32)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        require(r.status == 200, f"GET {path}: HTTP {r.status}")
        return json.loads(r.read())


def serve_requests(srv, images, clients=8, tasks=None):
    """Submit every image through the batcher (with ``tasks``, image i
    through task tasks[i mod len(tasks)]'s) from ``clients`` threads;
    returns the logits in image order (with ``tasks``, a list: the
    tasks' class counts differ)."""
    futures = [None] * len(images)
    errors = []

    def client(k):
        try:
            for i in range(k, len(images), clients):
                batcher = (srv.batcher if tasks is None
                           else srv.batchers[tasks[i % len(tasks)]])
                futures[i] = batcher.submit(images[i])
        except Exception as exc:  # recorded and raised below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    require(not errors, f"submit failed: {errors}")
    rows = [f.result(timeout=300)[0] for f in futures]
    return rows if tasks else np.stack(rows)


def reference_logits(pred, images, chunk=32):
    """fp32 plain forward on the predictor's own (bf16) weights."""
    params = convert.map_floating(pred._params, lambda t: t.float())
    cara = (None if pred._cara is None
            else convert.map_floating(pred._cara, lambda t: t.float()))
    outs = []
    with torch.inference_mode():
        for s in range(0, len(images), chunk):
            x = torch.from_numpy(images[s:s + chunk]).to(pred.device)
            outs.append(vit_forward(
                params, x, pred.cfg, cara_params=cara,
                cara_cfg=pred._cara_cfg, impl="plain").cpu().numpy())
    return np.concatenate(outs)


def serving_phase(dev, ckpt, model, images, batch_size=64, dtype=None,
                  timed=True, tag="serve") -> dict:
    """Serve ``images`` merged and unmerged; returns per-mode logits."""
    dtype = torch.bfloat16 if dtype is None else dtype
    out = {}
    for merge in (True, False):
        mode = f"{tag}:merged" if merge else f"{tag}:adapter"
        pred = Predictor.from_checkpoint_auto(
            ckpt, model, batch_size=batch_size, buckets="auto", merge=merge,
            device=dev, dtype=dtype)
        t0 = time.perf_counter()
        srv = InferenceServer(pred, port=0).start(warmup=True)
        print(f"[{mode}] warmup over buckets {pred.buckets}: "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        try:
            logits = serve_requests(srv, images)
            health = _get(srv.port, "/healthz")
            stats = _get(srv.port, "/stats")
        finally:
            srv.close()
        require(health.get("status") == "ok", f"healthz: {health}")
        print(f"[{mode}] /stats {json.dumps(stats)}", flush=True)
        require(stats["requests"] == len(images),
                f"{mode}: {stats['requests']} of {len(images)} answered")
        require(stats["mean_batch_occupancy"] > 1,
                f"{mode}: requests did not coalesce ({stats})")
        require(logits.shape == (len(images), pred.cfg.num_classes),
                f"{mode}: logits shape {logits.shape}")
        require(bool(np.isfinite(logits).all()), f"{mode}: non-finite")
        ref = reference_logits(pred, images)
        err = float(np.abs(logits - ref).max())
        tol = LOGIT_RTOL * float(np.abs(ref).max())
        print(f"[{mode}] max|logits - fp32 plain| {err:.4e}, "
              f"tolerance {tol:.4e} ({LOGIT_RTOL} x max|ref|)", flush=True)
        require(err <= tol, f"{mode}: logits disagree with the plain path")
        if timed:
            batch = images[:batch_size]
            pred.logits(batch)
            iters = 10
            t0 = time.perf_counter()
            for _ in range(iters):
                pred.logits(batch)
            dt = time.perf_counter() - t0
            print(f"[{mode}] {iters * len(batch) / dt:.1f} img/s at "
                  f"batch {len(batch)} (Predictor.logits, host clock, "
                  f"{dt / iters * 1e3:.3f} ms per batch)", flush=True)
        out["merged" if merge else "adapter"] = logits
    err = float(np.abs(out["merged"] - out["adapter"]).max())
    tol = LOGIT_RTOL * float(np.abs(out["adapter"]).max())
    print(f"[{tag}] max|merged - adapter| {err:.4e}, tolerance {tol:.4e}",
          flush=True)
    require(err <= tol, "merged and adapter logits disagree")
    return out


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def reset_launches() -> None:
    for mod, attr, _, _ in KERNELS.values():
        setattr(mod, attr, 0)


def read_launches(names) -> dict:
    return {k: getattr(KERNELS[k][0], KERNELS[k][1]) for k in names}


def train_setup(dev, model=MODEL, num_classes=10, rank=8, scale=10.0,
                batch=64, seed=0, impl="element", method="cara", lr=1e-3,
                cp_order=4, delta_impl="factorized", fact_core_rank=0,
                vpt_tokens=ZOO_PROMPTS, adapter_dropout=0.0, moe_experts=0,
                moe_top_k=2, **overrides):
    """Seeded ViT + perturbed adapter (weight dropout 0.1 of the ``impl``
    kind, or none for ``impl="rate0"``; CaRA at CP order ``cp_order`` in
    the ``delta_impl`` form, or its mixture of ``moe_experts`` experts
    routed top ``moe_top_k`` (the zero factors and the router's bias
    perturbed as CaRA's), or ``method`` "lora", "fact_tt" / "fact_tk"
    (core rank ``fact_core_rank``) with its zero factor perturbed by
    ``PEFT_STD``; a ``ZOO_METHODS`` tree, ``vpt_tokens`` prompts or
    ``adapter_dropout``, its zero leaves perturbed by ``ZOO_STD``; the
    model's drop-path) -> (cfg, cara_cfg, fp32 frozen,
    state, one fixed device batch of normalized images); ``overrides``
    change the model's config.  ``method`` "linear" or "full" trains
    without an adapter; the backbone is then rounded to bf16 values
    (full fine-tuning keeps it as the fp32 master weights, so that the
    fp32 reference of the gradient check runs on the weights the bf16
    path computes with)."""
    cfg = get_model_config(model, num_classes=num_classes, **overrides)
    params = init_backbone(cfg, seed)
    rate = 0.0 if impl == "rate0" else DROP_RATE
    impl = "element" if impl == "rate0" else impl
    if method in LORA_FAMILY:
        cara_cfg = CaraConfig(method=method, rank=rank, scale=scale,
                              weight_dropout=rate, weight_dropout_impl=impl,
                              fact_core_rank=fact_core_rank)
        cara = convert.perturb_adapter(
            convert.init_cara_params(cfg, cara_cfg, seed + 1), seed + 2,
            std=PEFT_STD[method])
    elif method in ZOO_METHODS:
        cara_cfg = CaraConfig(method=method, rank=rank, scale=scale,
                              weight_dropout=0.0, vpt_tokens=vpt_tokens,
                              adapter_dropout=adapter_dropout)
        cara = convert.init_cara_params(cfg, cara_cfg, seed + 1)
        if method in ZOO_STD:
            cara = convert.perturb_adapter(cara, seed + 2,
                                           std=ZOO_STD[method])
    elif method == "cara":
        cara_cfg = CaraConfig(rank=rank, scale=scale,
                              weight_dropout=rate,
                              weight_dropout_impl=impl, cp_order=cp_order,
                              delta_impl=delta_impl,
                              moe_experts=moe_experts, moe_top_k=moe_top_k)
        cara = convert.perturb_adapter(
            convert.init_cara_params(cfg, cara_cfg, seed + 1), seed + 2)
        if cp_order == 2:
            # Order 2's A2 (E^2, r) stands for order 4's A2 (E, r) x A3
            # (H, r) x A4 (Dh, r), whose orthogonal columns have entries
            # of about 1 / sqrt(H) and 1 / sqrt(Dh): at the same noise its
            # dense delta would be sqrt(E) times larger (at scale 10 a
            # qkv delta 13x the backbone's weights, whose bf16 forward is
            # chaotic: gradients 1.35 relative L2 off fp32 on the plain
            # path too).  Scaled to order 4's size.
            cara["A2"] = cara["A2"] / np.float32(np.sqrt(cfg.embed_dim))
    else:
        cara_cfg = CaraConfig(method=method, weight_dropout=0.0)
        cara = {}
        params = convert.map_floating(
            convert.params_from_numpy(params, dev),
            lambda t: t.to(torch.bfloat16).float())
    frozen, state = steps_lib.init_train_state(
        params, cara, dev, lr, steps_per_epoch=1, total_epochs=100,
        method=method)
    rng = np.random.default_rng(seed + 3)
    data = {"image": torch.from_numpy(make_images(batch, cfg.image_size,
                                                  seed + 4)).to(dev),
            "label": torch.from_numpy(rng.integers(
                0, num_classes, batch).astype(np.int64)).to(dev)}
    return cfg, cara_cfg, frozen, state, data


def _fp32_randomness(rand):
    """``rand`` with its floating draws in fp32; the dropout masks stay as
    drawn: keep masks are boolean and the block casts weight masks to its
    compute dtype."""
    return {k: (v if k == "masks" else [t.float() for t in v]
                if isinstance(v, list)
                else v.float() if v.is_floating_point() else v)
            for k, v in rand.items()}


def step_grads(cfg, cara_cfg, frozen_c, state, data, rand,
               dtype=torch.bfloat16, impl="auto", impls=("auto", "auto"),
               grad_accum=1, remat="auto"):
    """(loss, grads) of one train step on the ``dtype``-rounded backbone
    ``frozen_c`` with the randomness ``rand`` (a list of one a
    microbatch with ``grad_accum`` > 1: the accumulated step of
    ``steps_lib.loss_and_grads``); ``dtype=None`` is the fp32 plain
    path on the same weights and randomness (cast to fp32).  ``remat``
    resolves as the train step's."""
    if dtype is None:
        frozen_c = steps_lib.cast_floating(frozen_c, torch.float32)
        rand = ([_fp32_randomness(r) for r in rand]
                if isinstance(rand, list) else _fp32_randomness(rand))
        impl = "plain"
    attn_impl, dense_impl = steps_lib.resolve_impls(*impls, cara_cfg)
    loss, _, grads = steps_lib.loss_and_grads(
        cfg, cara_cfg, state.trainable, frozen_c, data,
        grad_accum=grad_accum, randomness=rand, compute_dtype=dtype,
        impl=impl, attn_impl=attn_impl, dense_impl=dense_impl,
        remat=steps_lib.resolve_remat(remat, dense_impl))
    return loss, grads


def _perturbed(data, k, dev):
    """``data`` for k = 0, else its images plus noise of std
    ``NOISE_STD`` from a generator seeded with 100 + k."""
    if k == 0:
        return data
    gen = torch.Generator(device=dev)
    gen.manual_seed(100 + k)
    noise = torch.randn(data["image"].shape, generator=gen, device=dev)
    return dict(data, image=data["image"] + NOISE_STD * noise)


def grad_check(dev, cfg, cara_cfg, frozen, state, data, generator,
               dtype=torch.bfloat16, tag=None,
               impls=("auto", "auto"), grad_accum=1, remat="auto",
               lazy=False) -> dict:
    """(a) One step's gradients of every trainable leaf through the
    kernels (``dtype`` compute) against the fp32 plain path on the same
    (``dtype``-rounded) backbone and the same drop-path gates and masks,
    by relative L2 per leaf.  The same step on ``NOISE_DRAWS`` copies of
    the batch with perturbed images (same masks and gates) runs through
    the kernels, the plain path in ``dtype`` (the TPU kernels' rounding
    points in other summation orders) and fp32: a leaf's bound is the
    larger of ``TRAIN_GRAD_REL_L2`` and the plain path's worst error over
    the step and its copies, and the kernels' error on the step must stay
    within it.  ``impls`` are the step's (attn_impl, dense_impl); the
    step runs under ``remat``, by default the train step's "auto" (on
    for the routes without an adapter).  ``grad_accum`` > 1 checks the
    accumulated step:
    ``grad_accum`` microbatches, one weight-dropout draw, gates and masks
    of their own (``steps_lib.microbatch_randomness``), on every path.
    ``lazy``: the perturbed copies run only where a leaf of the step
    misses ``TRAIN_GRAD_REL_L2`` (the verdict is the same: they can only
    raise a leaf's bound above it)."""
    tag = f"[train:{_route(cara_cfg)}]" if tag is None else tag
    attn_impl, dense_impl = steps_lib.resolve_impls(*impls, cara_cfg)
    remat = steps_lib.resolve_remat(remat, dense_impl)
    print(f"{tag} gradient check: remat {remat}, {grad_accum} "
          f"microbatch(es) of {data['image'].shape[0] // grad_accum}",
          flush=True)
    rand = steps_lib.microbatch_randomness(
        cfg, cara_cfg, data["image"].shape[0], grad_accum, dev, generator,
        dtype, masks=True, attn_impl=attn_impl, dense_impl=dense_impl)
    if grad_accum == 1:
        rand = rand[0]
    frozen_c = steps_lib.cast_floating(frozen, dtype)
    paths = [p for p, _ in steps_lib.tree_leaves(state.trainable)]
    # per realization: {"kernel" | "plain": path -> relative L2}
    errs, losses = [], []
    for k in range(NOISE_DRAWS + 1):
        args = (cfg, cara_cfg, frozen_c, state, _perturbed(data, k, dev),
                rand)
        ref_loss, ref = step_grads(*args, dtype=None, impls=impls,
                                   grad_accum=grad_accum, remat=remat)
        row = {}
        for name, impl in (("kernel", "auto"), ("plain", "plain")):
            loss, grads = step_grads(*args, dtype=dtype, impl=impl,
                                     impls=impls, grad_accum=grad_accum,
                                     remat=remat)
            for path, g in zip(paths, grads):
                require(bool(torch.isfinite(g).all()),
                        f"{name} grad {path}: non-finite")
            row[name] = {p: rel_l2(g, r) for p, g, r in zip(paths, grads, ref)}
            losses.append((loss.item(), ref_loss.item()))
        errs.append(row)
        what = "the step" if k == 0 else f"its images + {NOISE_STD} noise"
        print(f"{tag} realization {k} ({what}): " + "; ".join(
            f"{name} worst {_worst(e)}" for name, e in row.items()),
            flush=True)
        if lazy and max(row["kernel"].values()) <= TRAIN_GRAD_REL_L2:
            break
    misses = []
    for path in paths:
        kern = errs[0]["kernel"][path]
        plain_worst = max(e["plain"][path] for e in errs)
        bound_p = max(TRAIN_GRAD_REL_L2, plain_worst)
        print(f"{tag} grad {path}: relative L2 {kern:.3e} vs fp32 plain, "
              f"bf16 plain {errs[0]['plain'][path]:.3e}; worst over "
              f"{len(errs)} realizations: kernel "
              f"{max(e['kernel'][path] for e in errs):.3e}, bf16 plain "
              f"{plain_worst:.3e}; bound {bound_p:.3e} "
              f"({'ok' if kern <= bound_p else 'MISS'})", flush=True)
        if kern > bound_p:
            misses.append(path)
    worst = max(errs[0]["kernel"].values())
    means = {name: statistics.mean(max(e[name].values()) for e in errs)
             for name in ("kernel", "plain")}
    loss, ref_loss = losses[0]
    print(f"{tag} loss {loss:.6f}, fp32 plain {ref_loss:.6f}; worst "
          f"gradient relative L2 {worst:.3e}; worst leaf's mean over "
          f"{len(errs)} realizations: kernel {means['kernel']:.3e}, bf16 "
          f"plain {means['plain']:.3e}", flush=True)
    require(not misses, f"train-step gradients of {misses} disagree with "
            "the fp32 plain path")
    return {"worst_grad_rel_l2": worst, "loss": loss, "plain_loss": ref_loss}


def _worst(errs: dict) -> str:
    path = max(errs, key=errs.get)
    return f"{errs[path]:.3e} ({path})"


def _route(cara_cfg) -> str:
    if cara_cfg.method in NO_ADAPTER:
        return cara_cfg.method
    route = ("rate0" if cara_cfg.weight_dropout <= 0.0
             else cara_cfg.weight_dropout_impl)
    return route if cara_cfg.method == "cara" else (
        f"{cara_cfg.method}:{route}")


def fixed_batch_steps(cfg, cara_cfg, frozen, state, data, generator, steps,
                      dtype=torch.bfloat16, impl="auto", timed=True,
                      **step_kw):
    """(b, c) ``steps`` train steps on one fixed batch: the losses, the
    median device ms per step (CUDA events) and img/s on the host clock
    (synchronized at both ends).  ``step_kw`` go to ``make_train_step``
    (``remat``, ``grad_accum``, ``nan_check``)."""
    step_fn = steps_lib.make_train_step(cfg, cara_cfg, compute_dtype=dtype,
                                        impl=impl, **step_kw)
    frozen_c = steps_lib.cast_floating(frozen, dtype)
    losses, times = [], []
    if timed:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        if timed:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        state, metrics = step_fn(state, frozen_c, data, generator=generator)
        if timed:
            end.record()
            times.append((start, end))
        losses.append(metrics["loss"])
    if timed:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(v) for v in losses]
    ms = ([s.elapsed_time(e) for s, e in times] if timed else [])
    return state, losses, ms, wall


@contextlib.contextmanager
def attn_switch(**values):
    """``models.vit``'s switches (``_ATTN_MEGA``, ``_ATTNPROJ``) set to
    ``values`` inside the block, restored after it."""
    old = {k: getattr(vit_lib, k) for k in values}
    for k, v in values.items():
        setattr(vit_lib, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(vit_lib, k, v)


def cli_child(argv, env, out=None) -> dict:
    """``cli.vit_cp`` with ``argv`` in a child process whose environment
    adds ``env`` (the ``CARA_*`` switches are read at import, as JAX reads
    them); returns the child's launch counters (and appends its stdout's
    lines to the list ``out`` when given)."""
    code = ("import json, sys, chip_smoke; "
            "chip_smoke.vit_cp_cli.main(sys.argv[1:]); "
            "print(json.dumps(chip_smoke.read_launches("
            "tuple(chip_smoke.KERNELS))))")
    proc = subprocess.run([sys.executable, "-c", code, *argv],
                          env=dict(os.environ, **env), capture_output=True,
                          text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    if out is not None:
        out.extend(lines)
    for line in lines[-4:-1]:
        print(f"  child: {line}", flush=True)
    require(proc.returncode == 0, f"cli.vit_cp child failed ({env}): "
            f"{proc.stderr[-2000:]}")
    return json.loads(lines[-1])


def training_phase(dev, timed=True, steps=30, plain_steps=3, batch=64,
                   model=MODEL, impl="element", path=None, grad_batch=None,
                   idle=(), method="cara", lr=1e-3, overrides=None,
                   cli_extra=(), falls="last", switch=None,
                   cli=True) -> dict:
    """One training route (``impl`` weight dropout at 0.1, or ``method``
    "linear" / "full" without an adapter, at learning rate ``lr``; the
    model's config changed by ``overrides``, e.g. its dropout rates): (a)
    gradients against the fp32 plain path (on the first ``grad_batch``
    images, all by default), (b) a falling loss over ``steps`` steps on a
    fixed batch (the linear probe: only the head moved), (c) ms per step
    and img/s, kernel and (over ``plain_steps`` steps, none when 0)
    plain, (d) ``cli.vit_cp --synthetic`` with the
    same overrides and ``cli_extra``, whose best checkpoint is served
    (left out with ``cli`` False).
    ``switch`` names the ``SWITCHES`` entry the caller set (for the tag;
    where it has an environment the CLI runs in a child process with it,
    and every kernel of ``path`` must launch there too).  Launch counters
    are set to 0 before (b): every kernel of
    ``path`` (by default the 224-px route's) launched by the end of (d),
    none of ``idle`` before its checkpoint is served.  The loss falls when its
    last value is below its first (``falls="last"``) or, for a noisier
    run (activation dropout draws new masks every step), when the mean of
    the second half of the steps is below that of the first
    (``"halves"``)."""
    overrides = overrides or {}
    if path is None:
        path = TRAINING_KERNELS if impl == "element" else SPLIT_KERNELS
    cfg, cara_cfg, frozen, state, data = train_setup(
        dev, model=model, batch=batch, impl=impl, method=method, lr=lr,
        **overrides)
    route = impl if method == "cara" else method
    if overrides:
        route += ":" + ",".join(f"{k}={v}" for k, v in overrides.items())
    if switch:
        route += ":" + switch
    cli_env = SWITCHES[switch][1] if switch else None
    tag = (f"[train:{route}]" if model == MODEL
           else f"[train:{route}:{model}]")
    what = (f"rank {cara_cfg.rank}, weight dropout "
            f"{cara_cfg.weight_dropout} ({impl})" if method == "cara"
            else f"no adapter ({method}), lr {lr}")
    print(f"{tag} {model}: depth {cfg.depth}, E {cfg.embed_dim}, heads "
          f"{cfg.num_heads}, {cfg.num_patches + 1} tokens, {what}, "
          f"drop-path {cfg.drop_path_rate}, batch {batch}, bf16", flush=True)
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    gdata = {k: v[:grad_batch] for k, v in data.items()}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = grad_check(dev, cfg, cara_cfg, frozen, state, gdata, generator,
                     tag=tag)
    if dev.type == "cuda":
        print(f"{tag} gradient check at batch {len(gdata['label'])}: peak "
              f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f} GiB "
              "allocated", flush=True)
    out["setup"] = (cfg, cara_cfg, frozen, state, data)

    before = {p: t.detach().clone()
              for p, t in steps_lib.tree_leaves(state.trainable)}
    frozen_sum = sum(t.double().sum().item()
                     for _, t in steps_lib.tree_leaves(frozen))
    reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state, losses, ms, wall = fixed_batch_steps(
        cfg, cara_cfg, frozen, state, data, generator, steps, timed=timed)
    if dev.type == "cuda":
        print(f"{tag} {steps} steps at batch {batch}: peak "
              f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f} GiB "
              "allocated", flush=True)
    print(f"{tag} loss over {steps} steps on one batch: "
          + " ".join(f"{v:.4f}" for v in losses), flush=True)
    if method == "cara" and impl == "element":
        print(f"{tag} row 14's fold launches a step: "
              f"{wd_fold.LAUNCHES / steps:g} (one a block call's pair; "
              f"{cfg.depth} layers)", flush=True)
    require(all(np.isfinite(losses)), "non-finite training loss")
    if falls == "halves":
        half = len(losses) // 2
        first, second = (statistics.mean(losses[:half]),
                         statistics.mean(losses[half:]))
        print(f"{tag} mean loss over the first {half} steps {first:.4f}, "
              f"over the last {len(losses) - half} {second:.4f}",
              flush=True)
        require(second < first, "the loss did not fall")
    else:
        require(losses[-1] < losses[0], "the loss did not fall")
    out["losses"] = losses
    moved = [p for p, t in steps_lib.tree_leaves(state.trainable)
             if not torch.equal(t.detach(), before[p])]
    print(f"{tag} {len(moved)} of {len(before)} trainable leaves moved",
          flush=True)
    require(method == "cara" or len(moved) == len(before),
            f"trainable leaves that did not move: "
            f"{sorted(set(before) - set(moved))}")
    if method == "linear":
        require(sorted(before) == ["head/bias", "head/kernel"],
                f"the linear probe trains {sorted(before)}")
        require(frozen_sum == sum(t.double().sum().item()
                                  for _, t in steps_lib.tree_leaves(frozen)),
                "the linear probe moved the frozen backbone")
        print(f"{tag} only the head moved; the frozen backbone is "
              "unchanged", flush=True)
    if timed:
        steady = ms[5:] if len(ms) > 8 else ms
        out["ms_per_step"] = statistics.median(steady)
        out["img_per_s"] = steps * batch / wall
        out["plain_ms_per_step"] = None
        if plain_steps:
            _, _, pms, _ = fixed_batch_steps(cfg, cara_cfg, frozen, state,
                                             data, generator, plain_steps,
                                             impl="plain")
            out["plain_ms_per_step"] = statistics.median(pms[1:] or pms)
        plain = out["plain_ms_per_step"]
        print(f"{tag} median {out['ms_per_step']:.3f} ms per step (CUDA "
              f"events, steps {6 if len(ms) > 8 else 1}-{steps}), "
              f"{out['img_per_s']:.1f} img/s on the host clock over {steps} "
              f"steps; plain path (bf16) "
              f"{'not timed' if plain is None else f'{plain:.3f} ms'} per "
              "step", flush=True)

    trained = read_launches(tuple(KERNELS))
    if cli:
        with tempfile.TemporaryDirectory() as tmp:
            argv = ["--synthetic", "--dataset", "svhn", "--model", model,
                    "--dim", "8", "--epochs", "11", "--batch-size",
                    str(batch), "--eval-batch-size", str(batch),
                    "--synthetic-size",
                    str(2 * batch), "--log-every", "11", "--out-dir", tmp,
                    "--backbone", os.path.join(tmp, "none.npz"),
                    "--weight-dropout-impl", impl, "--device", str(dev),
                    "--method", method, "--lr", str(lr), *cli_extra]
            for key, value in overrides.items():
                argv += ["--model-override", f"{key}={value}"]
            t0 = time.perf_counter()
            if cli_env is None:
                acc = vit_cp_cli.main(argv)
            else:
                child = cli_child(argv, cli_env)
                acc = "in the child"
                print(f"{tag} the child's kernel launches: "
                      f"{ {k: v for k, v in child.items() if v} }",
                      flush=True)
                for name in path:
                    require(child[name] > 0, f"{name} never launched by the "
                            f"CLI child with {cli_env}")
            ckpts = sorted(f for f in os.listdir(tmp) if f.endswith(".npz"))
            print(f"{tag} cli.vit_cp depth {cfg.depth}: best acc {acc}, "
                  f"{time.perf_counter() - t0:.1f} s, checkpoints {ckpts}",
                  flush=True)
            require(len(ckpts) == 1, "the CLI wrote no best checkpoint")
            trained = read_launches(tuple(KERNELS))
            pred = Predictor.from_checkpoint_auto(
                os.path.join(tmp, ckpts[0]), model, batch_size=batch,
                device=dev, dtype=torch.bfloat16)
            logits = pred.logits(make_images(8, cfg.image_size, 5))
            require(logits.shape == (8, 10)
                    and bool(np.isfinite(logits).all()),
                    f"served checkpoint gave {logits.shape} logits")
            print(f"{tag} the best checkpoint serves: logits {logits.shape}",
                  flush=True)
    out["launches"] = read_launches(tuple(KERNELS))
    print(f"{tag} kernel launches on the training path: "
          f"{ {k: v for k, v in out['launches'].items() if v} }",
          flush=True)
    for name in path:
        require(out["launches"][name] > 0,
                f"{name} never launched on the {route} training path")
    for name in idle:
        require(trained[name] == 0,
                f"{name} launched on the {route} training path of {model}")
    return out


def dropout_phase(dev, model=MODEL, batch=64, long_model=MODEL_384,
                  long_over=None, long_batch=16, timed=True) -> dict:
    """Activation dropout (``dropout_rate`` 0.1) on the 224-px element and
    rank routes, each as :func:`training_phase` with 30 steps (the loss
    falls by the means of their halves; over 10 steps the per-step noise
    of the fresh masks hides the fall): the
    MLP megakernel gives way to row 13's GELU site and the fc2 site (and
    the element route's attention megakernel to its split sites), so the
    GELU counters grow and no ``cp_attn_block*`` / ``cp_mlp_block*``
    kernel launches; the element route's CLI adds attention dropout.
    Then gradient checks of the rank route with attention dropout too
    (``mha``), of the element route at 384 px (batch 16, then two steps
    whose launches are counted) and of one full fine-tuning step with
    both rates.  Returns the GELU entries' launches and the site's dact
    mode's.  ``model``,
    ``long_model`` (with ``long_over``) and the batches shrink it for a
    rehearsal on the CPU."""
    launches = {}
    elem = training_phase(
        dev, timed=timed, steps=30, plain_steps=2, batch=batch, model=model,
        impl="element", overrides=DROPOUT, falls="halves",
        cli_extra=("--model-override", f"attn_dropout_rate={DROP_RATE}"),
        path=DROPOUT_ELEMENT_KERNELS, idle=MEGA_KERNELS)
    for name in ("cp_dense_wd_gelu", "cp_dense_wd_dact"):
        launches[name] = elem["launches"][name]
    del elem
    rank = training_phase(dev, timed=timed, steps=30, plain_steps=2,
                          batch=batch, model=model, impl="rank",
                          overrides=DROPOUT, path=DROPOUT_RANK_KERNELS,
                          idle=MEGA_KERNELS, falls="halves")
    for name in ("cp_dense_gelu", "cp_dense_dact", "cp_site_fc1_dact"):
        launches[name] = rank["launches"][name]
    cfg, cara_cfg, frozen, state, data = rank.pop("setup")
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    both = dict(DROPOUT, attn_dropout_rate=DROP_RATE)
    grad_check(dev, dataclasses.replace(cfg, **both), cara_cfg, frozen,
               state, data, generator, tag="[train:rank:dropout+attn]")
    del rank, frozen, state, data

    cfg, cara_cfg, frozen, state, data = train_setup(
        dev, model=long_model, batch=long_batch, impl="element",
        **DROPOUT, **(long_over or {}))
    tag = f"[train:element:dropout:{long_model}]"
    grad_check(dev, cfg, cara_cfg, frozen, state, data, generator, tag=tag)
    reset_launches()
    state, losses, _, _ = fixed_batch_steps(cfg, cara_cfg, frozen, state,
                                            data, generator, 2, timed=timed)
    counted = read_launches(tuple(KERNELS))
    print(f"{tag} 2 steps at batch {long_batch}: loss {losses}; launches "
          f"{ {k: v for k, v in counted.items() if v} }", flush=True)
    require(all(np.isfinite(losses)), "non-finite loss at 384 px")
    for name in ("cp_dense_wd_gelu", "cp_dense_wd_dact") + BLOCKWISE_KERNELS:
        require(counted[name] > 0, f"{name} never launched at 384 px")
    for name in MEGA_KERNELS + SHORT_ATTENTION_KERNELS:
        require(counted[name] == 0, f"{name} launched at 384 px")
    for name in ("cp_dense_wd_gelu", "cp_dense_wd_dact"):
        launches[name + "_577"] = counted[name]
    del frozen, state, data

    cfg, cara_cfg, frozen, state, data = train_setup(
        dev, model=model, batch=batch, method="full", lr=1e-4, **both)
    grad_check(dev, cfg, cara_cfg, frozen, state, data, generator,
               tag="[train:full:dropout+attn]")
    return launches


def attnproj_eval_check(dev, ckpt, model, images, batch=64) -> int:
    """The unmerged forward of ``ckpt`` at ``batch`` with the attention
    megakernel off (``CARA_ATTN_MEGA=0``) and ``CARA_ATTNPROJ=1``: row 3's
    forward serves in every layer, and the logits stay within
    ``LOGIT_RTOL`` of max |logits| of the default route's (the
    megakernel).  Returns row 3's launches."""
    pred = Predictor.from_checkpoint_auto(
        ckpt, model, batch_size=batch, merge=False, device=dev,
        dtype=torch.bfloat16)
    x = images[:batch]
    ref = pred.logits(x)
    reset_launches()
    with attn_switch(**SWITCHES[ATTNPROJ][0]):
        got = pred.logits(x)
    launches = read_launches(("fused_qkv_attention_proj", "cp_attn_block",
                              "fused_qkv_attention"))
    err = float(np.abs(got - ref).max())
    tol = LOGIT_RTOL * float(np.abs(ref).max())
    print(f"[serve:attnproj] batch {len(x)} with CARA_ATTN_MEGA=0 "
          f"CARA_ATTNPROJ=1: launches {launches}; max|logits - default "
          f"route's| {err:.4e}, tolerance {tol:.4e}", flush=True)
    require(launches["fused_qkv_attention_proj"] >= pred.cfg.depth
            and launches["cp_attn_block"] == 0
            and launches["fused_qkv_attention"] == 0,
            f"the attnproj eval did not run row 3 in every layer: "
            f"{launches}")
    require(bool(np.isfinite(got).all()) and err <= tol,
            "attnproj eval logits disagree with the default route's")
    return launches["fused_qkv_attention_proj"]


# Quantized serving against the unquantized bf16 Predictor on the same
# weights, the JAX package's own bounds (tests/test_quant.py): max |dlogit|
# < k * std(reference logits) + c, and argmax agreement.
QUANT_BOUNDS = {"int8": (0.1, 0.05), "w8a8": (0.25, 0.1)}
ARGMAX_AGREE = 0.9


@contextlib.contextmanager
def int8_switch(on: bool):
    """``CARA_INT8_PALLAS`` set to "1" (``on``) or unset in ``os.environ``
    inside the block, restored after it (``models.vit.matk`` reads it at
    each call, as the reference does)."""
    old = os.environ.pop("CARA_INT8_PALLAS", None)
    if on:
        os.environ["CARA_INT8_PALLAS"] = "1"
    try:
        yield
    finally:
        os.environ.pop("CARA_INT8_PALLAS", None)
        if old is not None:
            os.environ["CARA_INT8_PALLAS"] = old


def host_timing(pred, images, batch=64, iters=10, singles=20) -> str:
    """img/s through ``Predictor.logits`` at ``batch`` and the median
    latency of a 1-image call, both on the host clock (each call ends in
    the copy-out)."""
    x = images[:batch]
    pred.logits(x)
    t0 = time.perf_counter()
    for _ in range(iters):
        pred.logits(x)
    rate = iters * len(x) / (time.perf_counter() - t0)
    lat = []
    for i in range(singles):
        t0 = time.perf_counter()
        pred.logits(images[i:i + 1])
        lat.append((time.perf_counter() - t0) * 1e3)
    return (f"{rate:.1f} img/s at batch {len(x)}, batch-1 latency "
            f"{statistics.median(lat):.3f} ms (median of {singles}; host "
            "clock)")


def quant_logit_check(tag, got, ref, mode) -> None:
    k, c = QUANT_BOUNDS[mode]
    err = float(np.abs(got - ref).max())
    tol = k * float(np.std(ref)) + c
    agree = float((got.argmax(-1) == ref.argmax(-1)).mean())
    print(f"[{tag}] max|logits - bf16 Predictor's| {err:.4e}, bound "
          f"{tol:.4e} ({k} x std + {c}); argmax agreement {agree:.4f} of "
          f"{len(ref)} (bound {ARGMAX_AGREE})", flush=True)
    require(bool(np.isfinite(got).all()), f"{tag}: non-finite logits")
    require(err < tol, f"{tag}: quantized logits too far from bf16")
    require(agree >= ARGMAX_AGREE, f"{tag}: argmax agreement {agree}")


QUANT_MODES = (("int8", True), ("w8a8", True), ("int8", False))


def quant_serving_phase(dev, ckpt, model, images, batch=64,
                        timed=True, modes=QUANT_MODES) -> int:
    """A checkpoint served quantized through
    ``Predictor.from_checkpoint_auto``, each of ``modes`` (quantize mode,
    merged) (by default merged ``quantize="int8"`` and ``"w8a8"``,
    unmerged ``"int8"``) held against the unquantized bf16 Predictor of
    the same merge on ``batch`` images (``QUANT_BOUNDS``).  Every
    bucket's forward is run with ``CARA_INT8_PALLAS`` unset and set: row
    18 launches 4 x depth times a forward with it on the weight-only
    modes, and never without it or on w8a8.  Returns row 18's
    launches."""
    x = images[:batch]
    refs = {}
    for merge in sorted({merge for _, merge in modes}, reverse=True):
        base = Predictor.from_checkpoint_auto(
            ckpt, model, batch_size=batch, merge=merge, device=dev,
            dtype=torch.bfloat16)
        refs[merge] = base.logits(x)
        if timed:
            print(f"[serve:bf16:{'merged' if merge else 'adapter'}] "
                  f"{host_timing(base, images, batch)}", flush=True)
        del base
    launches = 0
    for mode, merge in modes:
        pred = Predictor.from_checkpoint_auto(
            ckpt, model, batch_size=batch, merge=merge, device=dev,
            dtype=torch.bfloat16, quantize=mode)
        per_forward = 4 * pred.cfg.depth if mode == "int8" else 0
        for switch in (False, True):
            tag = (f"serve:{mode}:{'merged' if merge else 'adapter'}"
                   f"{':CARA_INT8_PALLAS=1' if switch else ''}")
            want = per_forward if switch else 0
            with int8_switch(switch):
                counts = []
                for b in pred.buckets:
                    reset_launches()
                    pred.logits(x[:b])
                    counts.append(int8_mod.LAUNCHES)
                reset_launches()
                got = pred.logits(x)
                counts.append(int8_mod.LAUNCHES)
                print(f"[{tag}] row 18 launches a forward, buckets "
                      f"{pred.buckets} then batch {len(x)}: {counts} "
                      f"(want {want} each)", flush=True)
                require(all(c == want for c in counts),
                        f"{tag}: row 18 launched {counts}, want {want}")
                if switch:
                    launches += sum(counts)
                quant_logit_check(tag, got, refs[merge],
                                  "w8a8" if mode == "w8a8" else "int8")
                if timed:
                    print(f"[{tag}] {host_timing(pred, images, batch)}",
                          flush=True)
        del pred
    return launches


def _png(image) -> bytes:
    """A normalized image back to 8-bit RGB, PNG-encoded."""
    from PIL import Image

    from cara_tpu_torch.data.vtab import IMAGENET_MEAN, IMAGENET_STD
    raw = np.clip((image * IMAGENET_STD + IMAGENET_MEAN) * 255.0, 0, 255)
    buf = io.BytesIO()
    Image.fromarray(raw.round().astype(np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def quant_cli_child(ckpt, model, images, requests=8, extra=()) -> None:
    """``python -m cara_tpu_torch.cli.serve --quantize int8`` in a child
    process with ``CARA_INT8_PALLAS=1`` in its environment: ``requests``
    PNG posts from four threads, ``/stats`` counts them, then SIGTERM;
    the child's row 18 counter must be 4 x depth for every forward it
    ran (its warm-up of each bucket and each batch ``/stats`` counts).
    ``extra`` adds CLI options (a CPU rehearsal: ``--device cpu``)."""
    code = ("import json, sys, chip_smoke; "
            "from cara_tpu_torch.cli import serve; "
            "serve.main(sys.argv[1:]); "
            "print(json.dumps(chip_smoke.read_launches(('int8_dense',))))")
    argv = ["--ckpt", ckpt, "--model", model, "--quantize", "int8",
            "--port", "0", "--max-batch", "64", "--max-wait-ms", "20",
            *extra]
    with tempfile.TemporaryFile(mode="w+") as err:
        out, stats = _serve_child(code, argv, err, images, requests)
        err.seek(0)
        require(out is not None, f"serve child failed: {err.read()[-2000:]}")
    got = json.loads(out.strip().splitlines()[-1])["int8_dense"]
    forwards = 4 + stats["batches"]  # the warm-up runs buckets 1, 4, 16, 64
    depth = get_model_config(model).depth
    print(f"[serve:int8:cli] the child's row 18 launches: {got} over "
          f"{forwards} forwards (want {4 * depth} each)", flush=True)
    require(got == 4 * depth * forwards,
            f"serve child: row 18 launched {got} times")


def _serve_child(code, argv, err, images, requests, tasks=None,
                 tag="serve:int8:cli"):
    """Run the serve child of :func:`quant_cli_child`, post ``requests``
    PNGs, read ``/stats``, stop it with SIGTERM: (its stdout after the
    stop, or None if it exited nonzero; the stats).  With ``tasks`` (a
    multi-task child) request i goes to ``?task=tasks[i % len(tasks)]``
    and ``/stats`` counts each task's."""
    proc = subprocess.Popen(
        [sys.executable, "-c", code, *argv], stdout=subprocess.PIPE,
        stderr=err, text=True, env=dict(os.environ, CARA_INT8_PALLAS="1"))
    try:
        port = None
        deadline = time.perf_counter() + 600
        while port is None and time.perf_counter() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            print(f"  child: {line.rstrip()}", flush=True)
            if line.startswith("serving on http://"):
                port = int(line.split()[2].rsplit(":", 1)[1])
        if port is None:
            err.seek(0)
            require(False, f"the serve child never listened: "
                    f"{err.read()[-2000:]}")
        bodies = [_png(images[i]) for i in range(requests)]
        answers, errors = [None] * requests, []

        def post(k):
            try:
                for i in range(k, requests, 4):
                    query = (f"?task={tasks[i % len(tasks)]}" if tasks
                             else "")
                    req = urllib.request.Request(
                        f"http://127.0.0.1:{port}/predict{query}",
                        data=bodies[i], method="POST")
                    with urllib.request.urlopen(req, timeout=120) as r:
                        answers[i] = json.loads(r.read())
            except Exception as exc:  # recorded and raised below
                errors.append(exc)

        threads = [threading.Thread(target=post, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        require(not errors and all(a is not None for a in answers),
                f"serve child: requests failed: {errors}")
        stats = _get(port, "/stats")
        print(f"[{tag}] /stats {json.dumps(stats)}; classes "
              f"{[a['class'] for a in answers]}", flush=True)
        answered = (sum(stats[t]["requests"] for t in tasks) if tasks
                    else stats["requests"])
        require(answered == requests,
                f"serve child answered {answered} of {requests}")
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return (out if proc.returncode == 0 else None), stats


def _pair_block(x, bp, f1, p1, cfg, cara_params, cara_cfg, impl, rand=None,
                attn_impl="fused", dense_impl="fused", scale=None, ad=None,
                moe_gates=None):
    """``models.vit._block`` of an eval block with a CaRA adapter, in one
    call of row 19: the factors collapsed and the delta scale (``scale``,
    a task's ``scale_override``, or the config's) folded as ``_block``
    does for the two half-block kernels.  It takes every argument of
    ``_block`` and refuses the bottleneck adapters' and a mixture's."""
    require(rand is None and cara_params is not None and ad is None
            and moe_gates is None,
            "the row 19 eval check runs CaRA blocks in eval")
    dt, mr = x.dtype, cfg.mlp_ratio
    s = cara_cfg.scale if scale is None else scale
    p2, p3, r2 = cara_params["P2"], cara_params["P3"], cara_params["R2"]

    def uv(fn, *args):
        u, v = fn(*args, None)
        return u.to(dt).contiguous(), (v * s).to(dt).contiguous()

    def fold(t):
        return (t * s).to(dt).contiguous()

    u1, v1 = uv(cara_lib.qkv_uv, cara_params, f1, cfg, cara_cfg)
    u2, v2 = uv(cara_lib.rows_out_uv, p1[0:1], p2, p3, r2)
    u3, v3 = uv(cara_lib.rows_out_uv, p1[1:1 + mr], p2, p3, r2)
    u4, v4 = uv(cara_lib.rows_in_uv, p1[1 + mr:1 + 2 * mr], p2, p3, r2)
    return pair_mod.block_pair_fwd(
        x, bp["qkv"]["kernel"], bp["qkv"]["bias"], u1, v1,
        bp["proj"]["kernel"], bp["proj"]["bias"], u2, v2,
        fold(cara_params["bias1"]), bp["ln1_scale"], bp["ln1_bias"],
        bp["fc1"]["kernel"], bp["fc1"]["bias"], u3, v3,
        fold(cara_params["bias2"]), bp["fc2"]["kernel"], bp["fc2"]["bias"],
        u4, v4, fold(cara_params["bias3"]), bp["ln2_scale"],
        bp["ln2_bias"], cfg.num_heads, cfg.head_dim ** -0.5, x.shape[1],
        1.0, act=cfg.activation, ln_eps=cfg.layernorm_eps, impl=impl)


def pair_eval_check(dev, ckpt, model, images, batch=64) -> int:
    """The unmerged forward of ``ckpt`` at ``batch`` with every block
    through row 19 (``models.vit._block`` replaced around the call):
    one launch a layer, logits within ``LOGIT_RTOL`` of max |logits| of
    the default route's (rows 5 and 9).  Returns row 19's launches."""
    pred = Predictor.from_checkpoint_auto(
        ckpt, model, batch_size=batch, merge=False, device=dev,
        dtype=torch.bfloat16)
    pair, mlp = "block_pair_fwd", "cp_mlp_block"
    if pred.cfg.activation != "gelu":  # the checkpoint's quick_gelu
        pair, mlp = QUICK_ENTRIES[pair], QUICK_ENTRIES[mlp]
    x = images[:batch]
    ref = pred.logits(x)
    old = vit_lib._block
    vit_lib._block = _pair_block
    try:
        reset_launches()
        got = pred.logits(x)
        launches = read_launches((pair, "cp_attn_block", mlp))
    finally:
        vit_lib._block = old
    err = float(np.abs(got - ref).max())
    tol = LOGIT_RTOL * float(np.abs(ref).max())
    print(f"[serve:block_pair] batch {len(x)}, {pred.cfg.activation}, "
          f"every block through row 19: launches {launches}; "
          f"max|logits - default route's| {err:.4e}, tolerance {tol:.4e}",
          flush=True)
    require(launches[pair] == pred.cfg.depth
            and launches["cp_attn_block"] == 0 and launches[mlp] == 0,
            f"the row 19 eval did not run it in every layer: {launches}")
    require(bool(np.isfinite(got).all()) and err <= tol,
            "row 19 eval logits disagree with the default route's")
    return launches[pair]


def switched_rank_phases(dev, steps=20, model=MODEL, batch=64, timed=True,
                         rounds=3) -> dict:
    """The rank route under each attention-block switch (``SWITCHES``), as
    :func:`training_phase` with ``steps`` timed steps, the switch set in
    ``models.vit`` around the phase (and in the environment of its CLI
    child): each switch's kernels launch and the split route's do not.
    Then the default rank route and both switched ones are timed in turns
    on one setup (``rounds`` rounds of six steps a route, the order
    reversed every other round; the first step of a turn is dropped), so
    that the host's drift over the call does not enter the comparison.
    Returns the launches of ``ATTN_ROUTE_KERNELS``."""
    launches = {}
    for name, (values, _, path, idle) in SWITCHES.items():
        with attn_switch(**values):
            out = training_phase(dev, timed=timed, steps=steps,
                                 plain_steps=2, batch=batch, model=model,
                                 impl="rank", path=path, idle=idle,
                                 switch=name)
        for k in ATTN_ROUTE_KERNELS:
            if out["launches"][k]:
                launches[k] = out["launches"][k]
        setup = out.pop("setup")
        del out
    if not timed:
        return launches
    cfg, cara_cfg, frozen, state, data = setup
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    names = ["default", *SWITCHES]
    turns = {k: [] for k in names}
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            with attn_switch(**({} if name == "default"
                                else SWITCHES[name][0])):
                state, _, ms, _ = fixed_batch_steps(
                    cfg, cara_cfg, frozen, state, data, generator, 6)
            turns[name] += ms[1:]
    med = {k: statistics.median(v) for k, v in turns.items()}
    print(f"[train:rank] ms per step by CUDA events in turns ({rounds} "
          f"rounds, {len(turns['default'])} steps a route): " + "; ".join(
              f"{k} {v:.3f} ({v / med['default']:.3f}x the default)"
              for k, v in med.items()), flush=True)
    return launches


# The environment that selects the recompute forms, as a user sets it.
RECOMPUTE_ENV = {"CARA_MLP_SAVE_PRE": "0", "CARA_ATTN_SAVE_QKV": "0"}


def recompute_steps(dev, model, impl, batch, steps, path, timed=True,
                    saved=(*SAVED_FORMS.values(), SAVE_PRE_SITE),
                    overrides=None):
    """``steps`` steps of the ``impl`` route of ``model`` (its config
    changed by ``overrides``) with both saved-residual switches "0"
    (``save_switch``): every kernel of ``path`` launches, none of
    ``saved`` (the saved forms, the fc1 site writing its pre-activation).
    -> (the setup, its state after the steps, the generator, the
    launches)."""
    tag = (f"[train:{impl}:recompute]" if model == MODEL
           else f"[train:{impl}:recompute:{model}]")
    setup = train_setup(dev, model=model, batch=batch, impl=impl,
                        **(overrides or {}))
    cfg, cara_cfg, frozen, state, data = setup
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with save_switch("0"):
        state, losses, _, _ = fixed_batch_steps(
            cfg, cara_cfg, frozen, state, data, generator, steps,
            timed=timed)
    got = read_launches(tuple(KERNELS))
    peak = (f"; peak {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f} "
            "GiB allocated" if dev.type == "cuda" else "")
    print(f"{tag} {steps} steps at batch {batch} with CARA_MLP_SAVE_PRE=0 "
          f"CARA_ATTN_SAVE_QKV=0: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}{peak}; kernel launches "
          f"{ {k: v for k, v in got.items() if v} }", flush=True)
    require(all(np.isfinite(losses)), "non-finite recompute loss")
    for name in path:
        require(got[name] > 0, f"{name} never launched on {model} with "
                "the saved-residual switches 0")
    for name in saved:
        require(got[name] == 0, f"{name} launched on {model} with the "
                "saved-residual switches 0")
    return setup, state, generator, got


def recompute_phase(dev, steps=8, long_steps=2, rounds=3, batch=64,
                    model=MODEL, timed=True) -> dict:
    """The element and rank routes with both saved-residual switches "0":
    :func:`recompute_steps`, ``steps`` steps each, in which every
    recompute form of rows 8, 10 and 11 (and the recompute's NN PRE_GELU
    and NT DGELU products) launches; then the saved (default) and the
    recompute form timed in turns on one setup (``rounds`` rounds of six
    steps a form, the order reversed every other round, the first step
    of a turn dropped), with each form's peak memory; then
    ``cli.vit_cp`` for one epoch in a child whose environment sets both
    switches to "0" (``RECOMPUTE_ENV``, read at import): the recompute
    forms launch there and no saved one.  Last, ``long_steps`` steps of
    each route at 384 px (N 577), rows 10 and 11's recompute forms.
    Returns the launches of the recompute entries."""
    launches = {}
    paths = {"element": ("cp_attn_block_wd_bwd", "cp_mlp_block_wd_bwd",
                         *GEMM_RECOMPUTE),
             "rank": RANK_RECOMPUTE}
    for impl, path in paths.items():
        tag = f"[train:{impl}:recompute]"
        setup, state, generator, got = recompute_steps(
            dev, model, impl, batch, steps, path, timed=timed)
        cfg, cara_cfg, frozen, _, data = setup
        # the two GEMM entries keep the element route's launches
        launches.update({name: got[name] for name in path
                         if name not in launches})
        with tempfile.TemporaryDirectory() as tmp:
            child = cli_child(
                ["--synthetic", "--dataset", "svhn", "--model", model,
                 "--dim", "8", "--epochs", "1", "--batch-size", str(batch),
                 "--eval-batch-size", str(batch), "--synthetic-size",
                 str(2 * batch), "--out-dir", tmp, "--backbone",
                 os.path.join(tmp, "none.npz"), "--weight-dropout-impl",
                 impl, "--device", str(dev)], RECOMPUTE_ENV)
        print(f"{tag} cli.vit_cp child with {RECOMPUTE_ENV}: kernel "
              f"launches { {k: v for k, v in child.items() if v} }",
              flush=True)
        for name in path[:2]:
            require(child[name] > 0, f"{name} never launched by the CLI "
                    f"child with {RECOMPUTE_ENV}")
        for name in SAVED_FORMS.values():
            require(child[name] == 0, f"{name} launched by the CLI child "
                    f"with {RECOMPUTE_ENV}")
        if timed:
            turns = {"saved": [], "recompute": []}
            peak = {}
            for r in range(rounds):
                for form in (("saved", "recompute") if r % 2 == 0
                             else ("recompute", "saved")):
                    torch.cuda.reset_peak_memory_stats(dev)
                    with save_switch("1" if form == "saved" else "0"):
                        state, _, ms, _ = fixed_batch_steps(
                            cfg, cara_cfg, frozen, state, data, generator,
                            6)
                    turns[form] += ms[1:]
                    peak[form] = (torch.cuda.max_memory_allocated(dev)
                                  / 2 ** 30)
            med = {k: statistics.median(v) for k, v in turns.items()}
            print(f"{tag} ms per step by CUDA events in turns ({rounds} "
                  f"rounds, {len(turns['saved'])} steps a form): saved "
                  f"{med['saved']:.3f} (peak {peak['saved']:.3f} GiB), "
                  f"recompute {med['recompute']:.3f} (peak "
                  f"{peak['recompute']:.3f} GiB); saved / recompute "
                  f"{med['saved'] / med['recompute']:.4f}", flush=True)
        del setup, state, frozen, data
    long_paths = {"element": ("cp_mlp_block_wd_bwd", *GEMM_RECOMPUTE),
                  "rank": RANK_RECOMPUTE}
    for impl, path in long_paths.items():
        recompute_steps(dev, MODEL_384, impl, batch, long_steps, path,
                        timed=False)
    return launches


def quick_kernel_phase(dev, inp, timed: bool = True) -> dict:
    """The quick_gelu entries of ``QUICK_FORMS`` but row 19's at
    ``inp``'s shapes (``inp["act"]`` "quick_gelu"; CLIP ViT-L/14's: M =
    64 x 257, E 1024, hidden 4096, rank 8, eps 1e-5): each built as its
    GELU twin's entry with the activation, held against its fp32 plain
    version with the twin's tolerance, bound by the twin's work at these
    shapes.  No PyTorch call computes any of them (library None)."""
    require(inp["act"] == "quick_gelu", "the quick entries need quick_gelu")
    print(f"[kernel] the quick_gelu forms at B {inp['b']}, N {inp['n']}, "
          f"E {inp['e']}, hidden {inp['mlp']['w1'].shape[1]}, rank "
          f"{inp['attn']['u1'].shape[1]}, LayerNorm eps {inp['eps']}:",
          flush=True)
    twins = set(QUICK_ENTRIES) - {"block_pair_fwd"}
    calls = mlp_kernel_calls(inp, names=twins)
    for more in (gelu_kernel_calls(inp), site_kernel_calls(inp),
                 gemm_kernel_calls(inp, gemm_operands(inp))):
        calls.update({k: v for k, v in more.items() if k in twins})
    require(set(calls) == twins, f"quick entries missing: "
            f"{sorted(twins - set(calls))}")
    work = kernel_work(inp)
    return check_entries(
        dev, inp, {QUICK_ENTRIES[k]: v for k, v in calls.items()}, timed,
        work={QUICK_ENTRIES[k]: work[k] for k in calls}, library={})


def _add_launches(total, got, names) -> None:
    for name in names:
        total[name] = total.get(name, 0) + got[name]


def clip_phase(dev, batch=64, steps=14, grad_batch=16, overrides=None,
               timed=True) -> dict:
    """CLIP ViT-L/14 (``MODEL_CLIP``) at full width and depth from seed 0
    with a perturbed order-4 rank-8 CaRA adapter at scale 10, 10 classes
    on its 768-wide projection, bf16, ``batch`` images (``overrides``
    shrink it for a rehearsal on the CPU):

    1. served merged and unmerged as :func:`serving_phase` does (logits
       within ``LOGIT_RTOL`` of the fp32 plain forward): rows 1 and 5
       launch, row 9 in its quick_gelu form, and no GELU form;
    2. the element and the rank route as :func:`training_phase` (the
       gradient check on ``grad_batch`` images, ``steps`` timed steps,
       peak memory; no CLI): the saved forms of rows 8, 10 and 11 run,
       with quick_gelu, and no recompute form and no GELU form;
    3. two steps of each route with both saved-residual switches "0":
       the recompute forms of rows 10 and 11 with quick_gelu, and no
       saved one;
    4. the rank route with ``dropout_rate`` 0.1: the gradient check on
       half of ``grad_batch``, then two steps, which run row 13's
       quick_gelu body and its dact helper;
    5. ``cli.vit_cp --model vit_large_patch14_224_clip --synthetic`` in a
       child for four steps (two epochs of two batches);
    6. row 19 with quick_gelu: 1.'s checkpoint served unmerged with every
       block through row 19 (:func:`pair_eval_check`, run right after 1.
       while the checkpoint exists): its quick_gelu form in every layer.

    Returns the quick_gelu entries' launches."""
    over = dict(overrides or {})
    cfg = get_model_config(MODEL_CLIP, num_classes=10, **over)
    print(f"[clip] {MODEL_CLIP}: depth {cfg.depth}, E {cfg.embed_dim}, "
          f"heads {cfg.num_heads}, hidden {cfg.hidden_dim}, "
          f"{cfg.num_patches + 1} tokens, {cfg.activation}, ln_pre "
          f"{cfg.ln_pre}, LayerNorm eps {cfg.layernorm_eps}, proj_dim "
          f"{cfg.proj_dim}, batch {batch}, bf16", flush=True)
    launches = {}
    none_gelu = GELU_FORMS + ("cp_mlp_block_bwd", "cp_mlp_block_wd_bwd")
    images = make_images(96, cfg.image_size)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "clip_smoke_seed_0.npz")
        make_checkpoint(ckpt, model=MODEL_CLIP, **over)
        reset_launches()
        serving_phase(dev, ckpt, MODEL_CLIP, images, batch_size=batch,
                      timed=timed, tag="serve:clip")
        served = read_launches(tuple(KERNELS))
        launches["block_pair_fwd_clip"] = pair_eval_check(
            dev, ckpt, MODEL_CLIP, images, batch=batch)
        launches["block_pair_fwd_quick"] = launches["block_pair_fwd_clip"]
    del images
    print(f"[serve:clip] kernel launches on the serving path: "
          f"{ {k: v for k, v in served.items() if v} }", flush=True)
    for name in CLIP_SERVING_KERNELS:
        require(served[name] > 0, f"{name} never launched serving CLIP")
    for name in none_gelu:
        require(served[name] == 0, f"{name} launched serving CLIP")
    _add_launches(launches, served, ("cp_mlp_block_quick",
                                     "cp_site_fc1_ln_quick_gelu"))

    common = dict(model=MODEL_CLIP, batch=batch, steps=steps,
                  plain_steps=2, grad_batch=grad_batch, cli=False,
                  overrides=over or None, timed=timed)
    for impl, path, own in (
            ("element", CLIP_ELEMENT_KERNELS,
             ("cp_mlp_block_wd_bwd_saved_quick",)),
            ("rank", CLIP_RANK_KERNELS, ("cp_mlp_block_bwd_saved_quick",))):
        out = training_phase(
            dev, impl=impl, path=path, idle=none_gelu + QUICK_RECOMPUTE
            + ("cp_attn_block_wd_bwd",), **common)
        _add_launches(launches, out["launches"], own + (
            "cp_site_fc1_ln_quick_gelu_pre", "grad_gemm_nt_dquick_gelu_h"))
        del out

    for impl, path, counter in (
            ("element", ("cp_attn_block_wd_bwd",) + QUICK_RECOMPUTE,
             "QUICK_WD_BWD_LAUNCHES"),
            ("rank", QUICK_RECOMPUTE, "QUICK_BWD_LAUNCHES")):
        before = getattr(mlp_mod, counter)
        _, _, _, got = recompute_steps(
            dev, MODEL_CLIP, impl, batch, 2, path, timed=timed,
            saved=QUICK_SAVED, overrides=over)
        rows = getattr(mlp_mod, counter) - before
        print(f"[train:{impl}:recompute:{MODEL_CLIP}] the MLP block's "
              f"recompute form with quick_gelu ({counter}): {rows} "
              "launches", flush=True)
        require(rows > 0, f"{impl}: the quick_gelu recompute form of the "
                "MLP block never launched")
        for name in none_gelu:
            require(got[name] == 0, f"{name} launched by the CLIP "
                    "recompute steps")
        _add_launches(launches, got, QUICK_RECOMPUTE)

    tag = f"[train:rank:dropout:{MODEL_CLIP}]"
    dcfg, dcc, frozen, state, data = train_setup(
        dev, model=MODEL_CLIP, batch=batch, impl="rank", **over, **DROPOUT)
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    grad_check(dev, dcfg, dcc, frozen, state,
               {k: v[:max(1, grad_batch // 2)] for k, v in data.items()},
               generator, tag=tag)
    reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state, losses, _, _ = fixed_batch_steps(dcfg, dcc, frozen, state, data,
                                            generator, 2, timed=timed)
    got = read_launches(tuple(KERNELS))
    peak = (f"; peak {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f} "
            "GiB allocated" if dev.type == "cuda" else "")
    print(f"{tag} 2 steps at batch {batch}: loss {losses}{peak}; launches "
          f"{ {k: v for k, v in got.items() if v} }", flush=True)
    require(all(np.isfinite(losses)), "non-finite CLIP dropout loss")
    for name in CLIP_DROPOUT_KERNELS:
        require(got[name] > 0, f"{name} never launched by the CLIP "
                "dropout steps")
    for name in none_gelu + ("cp_mlp_block_quick",
                             "cp_mlp_block_bwd_saved_quick"):
        require(got[name] == 0, f"{name} launched by the CLIP dropout "
                "steps")
    _add_launches(launches, got, CLIP_DROPOUT_KERNELS)
    del frozen, state, data

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--synthetic", "--dataset", "svhn", "--model", MODEL_CLIP,
                "--dim", "8", "--epochs", "2", "--batch-size", "32",
                "--eval-batch-size", "32", "--synthetic-size", "64",
                "--log-every", "1", "--out-dir", tmp, "--backbone",
                os.path.join(tmp, "none.npz"), "--device", str(dev)]
        for key, value in over.items():
            argv += ["--model-override", f"{key}={value}"]
        t0 = time.perf_counter()
        child = cli_child(argv, {})
    print(f"[clip] cli.vit_cp child, 4 steps: "
          f"{time.perf_counter() - t0:.1f} s; kernel launches "
          f"{ {k: v for k, v in child.items() if v} }", flush=True)
    for name in CLIP_ELEMENT_KERNELS:
        require(child[name] > 0, f"{name} never launched by the CLIP CLI")
    for name in none_gelu:
        require(child[name] == 0, f"{name} launched by the CLIP CLI")
    return launches


def attnproj_rank_steps(dev, setup, grad_batch, model=MODEL_HUGE, steps=4,
                        rounds=3, timed=True) -> dict:
    """The rank route of ``setup`` (cfg, cara_cfg, frozen, state, one fixed
    batch) with ``CARA_ATTN_MEGA=0 CARA_ATTNPROJ=1`` (rows 3 and 4): the
    gradient check of every trainable leaf on the first ``grad_batch``
    images, then ``rounds`` rounds of ``steps`` steps (one more, dropped,
    a turn) of the default rank route and of the switched one in turns on
    the same batch.  In each switched turn row 3's forward and its
    backward launch once a layer a step, the split projection site never
    (``cp_dense`` launches only for the qkv sites, once a layer a step),
    the switch's kernels launch and the split attention's do not.
    Returns the switched turns' launches of rows 3 and 4."""
    values, _, path, idle = SWITCHES[ATTNPROJ]
    cfg, cara_cfg, frozen, state, data = setup
    tag = f"[train:rank:{ATTNPROJ}:{model}]"
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    gdata = {k: v[:grad_batch] for k, v in data.items()}
    with attn_switch(**values):
        grad_check(dev, cfg, cara_cfg, frozen, state, gdata, generator,
                   tag=tag)
    rows = ("fused_qkv_attention_proj", "fused_qkv_attention_proj_bwd")
    launches = dict.fromkeys(rows, 0)
    turns = {"default": [], ATTNPROJ: []}
    for r in range(rounds):
        for route in list(turns) if r % 2 == 0 else list(turns)[::-1]:
            with attn_switch(**({} if route == "default" else values)):
                reset_launches()
                state, losses, ms, _ = fixed_batch_steps(
                    cfg, cara_cfg, frozen, state, data, generator,
                    steps + 1, timed=timed)
                got = read_launches(tuple(KERNELS))
            require(all(np.isfinite(losses)), f"non-finite loss on the "
                    f"{route} rank route of {model}")
            turns[route] += ms[1:]
            if route == "default":
                continue
            per = (steps + 1) * cfg.depth
            print(f"{tag} turn {r}: loss {losses[-1]:.4f}; launches "
                  f"{ {k: v for k, v in got.items() if v} }", flush=True)
            require(all(got[k] == per for k in rows) and got["cp_dense"]
                    == per, f"{model} under {ATTNPROJ}: rows 3 / 4 and "
                    f"the qkv site must launch once a layer a step ({per}), "
                    f"the split projection site never: "
                    f"{ {k: got[k] for k in rows + ('cp_dense',)} }")
            for name in path:
                require(got[name] > 0, f"{name} never launched by "
                        f"{model} under {ATTNPROJ}")
            for name in idle:
                require(got[name] == 0, f"{name} launched by {model} "
                        f"under {ATTNPROJ}")
            _add_launches(launches, got, rows)
    if timed:
        med = {k: statistics.median(v) for k, v in turns.items()}
        print(f"{tag} ms per step by CUDA events in turns ({rounds} rounds, "
              f"{len(turns['default'])} steps a route, batch "
              f"{len(data['label'])}): " + "; ".join(
                  f"{k} {v:.3f} ({v / med['default']:.3f}x the default)"
                  for k, v in med.items()), flush=True)
    return launches


def huge_phase(dev, batch=64, steps=10, grad_batch=16, full_grad_batch=8,
               long_size=336, long_batch=16, long_grad_batch=4,
               cli_depth=8, overrides=None, timed=True) -> dict:
    """ViT-H/14 (``MODEL_HUGE``) at full width and depth from seed 0 with a
    perturbed order-4 rank-8 CaRA adapter at scale 10, 10 classes, bf16,
    ``batch`` images (``overrides`` shrink it for a rehearsal on the
    CPU); every attention at head width 80:

    1. served merged and unmerged as :func:`serving_phase` does (logits
       within ``LOGIT_RTOL`` of the fp32 plain forward): rows 1, 5 and 9
       launch; then unmerged with every block through row 19
       (:func:`pair_eval_check`: once a layer, logits within
       ``LOGIT_RTOL`` of the default route's); then merged weight-only
       int8 (:func:`quant_serving_phase`: row 18 launches 4 x 32 times a
       forward with ``CARA_INT8_PALLAS=1``, logits within
       ``QUANT_BOUNDS`` of the bf16 Predictor's);
    2. the element and the rank route as :func:`training_phase` (the
       gradient check on ``grad_batch`` images, ``steps`` timed steps,
       peak memory; no CLI, no plain timing): the saved forms of rows 8,
       10 and 11, row 2 inside row 8 on the element route and on its own
       on the rank route;
    3. full fine-tuning (lr 1e-4) through row 17: the gradient check of
       every leaf on ``full_grad_batch`` images, ``steps`` timed steps,
       peak memory;
    4. the rank route with ``CARA_ATTN_MEGA=1`` (rows 5 and 6), two steps;
       then with ``CARA_ATTN_MEGA=0 CARA_ATTNPROJ=1`` (rows 3 and 4,
       :func:`attnproj_rank_steps`): the gradient check on
       ``grad_batch`` images, four steps timed in turns with the default
       rank route; the unmerged eval of 1.'s checkpoint under the same
       switch (:func:`attnproj_eval_check`);
    5. at ``long_size`` px (577 tokens: row 16): served merged and
       unmerged at ``long_batch``, the rank route's gradient check on
       ``long_grad_batch`` images and four steps at ``long_batch``, one
       full fine-tuning step on ``long_grad_batch`` images (row 17 at 577
       tokens);
    6. ``cli.vit_cp --model vit_huge_patch14_224_in21k --synthetic`` in a
       child for four steps (two epochs of two batches), full width at
       ``cli_depth`` layers (its checkpoint's write and the model's
       set-up scale with depth).

    Returns the launches of the Dh-80 entries of ``DH_FORMS``,
    ``PROJ_FORMS`` and ``PAIR_FORMS``, and of the ViT-H entries of rows 14
    and 18 (its element route's folds, its int8 serving)."""
    over = dict(overrides or {})
    cfg = get_model_config(MODEL_HUGE, num_classes=10, **over)
    print(f"[huge] {MODEL_HUGE}: depth {cfg.depth}, E {cfg.embed_dim}, "
          f"heads {cfg.num_heads} of width {cfg.head_dim}, hidden "
          f"{cfg.hidden_dim}, {cfg.num_patches + 1} tokens, batch {batch}, "
          "bf16", flush=True)
    got = {}

    def free():
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    def serve(size, n_images, serve_batch, tag, evals=False):
        images = make_images(n_images, size)
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = os.path.join(tmp, "vit_huge_smoke_seed_0.npz")
            t0 = time.perf_counter()
            make_checkpoint(ckpt, model=MODEL_HUGE,
                            **dict(over, image_size=size))
            print(f"[{tag}] checkpoint written in "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
            reset_launches()
            serving_phase(dev, ckpt, MODEL_HUGE, images,
                          batch_size=serve_batch, timed=timed, tag=tag)
            served = read_launches(tuple(KERNELS))
            if evals:  # the adapter's eval through row 3, then row 19
                served["fused_qkv_attention_proj"] = attnproj_eval_check(
                    dev, ckpt, MODEL_HUGE, images, batch=serve_batch)
                served["block_pair_fwd_huge"] = pair_eval_check(
                    dev, ckpt, MODEL_HUGE, images, batch=serve_batch)
                free()
                # weight-only int8, merged, through row 18 (128 launches
                # a forward with CARA_INT8_PALLAS=1)
                served["int8_dense_huge"] = quant_serving_phase(
                    dev, ckpt, MODEL_HUGE, images, batch=serve_batch,
                    timed=timed, modes=(("int8", True),))
        print(f"[{tag}] kernel launches on the serving path: "
              f"{ {k: v for k, v in served.items() if v} }", flush=True)
        free()
        return served

    served = serve(cfg.image_size, 96, batch, "serve:huge", evals=True)
    for name in HUGE_SERVING_KERNELS:
        require(served[name] > 0, f"{name} never launched serving ViT-H")
    _add_launches(got, served, ("fused_qkv_attention",
                                "fused_qkv_attention_proj",
                                "block_pair_fwd_huge", "int8_dense_huge"))

    common = dict(model=MODEL_HUGE, batch=batch, steps=steps, plain_steps=0,
                  grad_batch=grad_batch, cli=False, overrides=over or None,
                  timed=timed)
    saved_idle = GEMM_RECOMPUTE + tuple(SAVED_FORMS)
    out = training_phase(dev, impl="element", path=HUGE_ELEMENT_KERNELS,
                         idle=saved_idle, **common)
    got["build_wd_weight_huge"] = out["launches"]["build_wd_weight"]
    del out
    free()
    out = training_phase(dev, impl="rank", path=HUGE_RANK_KERNELS,
                         idle=saved_idle, **common)
    _add_launches(got, out["launches"], ("fused_qkv_attention",
                                         "fused_qkv_attention_bwd"))
    setup = out.pop("setup")
    del out

    # The attention megakernel and its backward (rows 5, 6), two steps.
    values, _, path, idle = SWITCHES["CARA_ATTN_MEGA=1"]
    scfg, scc, frozen, state, data = setup
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    with attn_switch(**values):
        reset_launches()
        state, losses, ms, _ = fixed_batch_steps(
            scfg, scc, frozen, state, data, generator, 2, timed=timed)
        mega = read_launches(tuple(KERNELS))
    print(f"[train:rank:CARA_ATTN_MEGA=1:{MODEL_HUGE}] 2 steps at batch "
          f"{batch}: loss {losses}, ms {ms}; kernel launches "
          f"{ {k: v for k, v in mega.items() if v} }", flush=True)
    require(all(np.isfinite(losses)), "non-finite ViT-H loss under "
            "CARA_ATTN_MEGA=1")
    for name in path:
        require(mega[name] > 0, f"{name} never launched by ViT-H under "
                "CARA_ATTN_MEGA=1")
    for name in idle:
        require(mega[name] == 0, f"{name} launched by ViT-H under "
                "CARA_ATTN_MEGA=1")
    # Rows 3 and 4 (CARA_ATTN_MEGA=0 CARA_ATTNPROJ=1), in turns with the
    # default rank route.
    _add_launches(got, attnproj_rank_steps(
        dev, (scfg, scc, frozen, state, data), grad_batch, timed=timed),
        ("fused_qkv_attention_proj", "fused_qkv_attention_proj_bwd"))
    del setup, scfg, scc, frozen, state, data
    free()

    out = training_phase(
        dev, method="full", lr=1e-4, path=FLASH_KERNELS,
        idle=("fused_qkv_attention", "fused_qkv_attention_bwd")
        + BLOCKWISE_KERNELS + ADAPTER_KERNELS,
        **dict(common, grad_batch=full_grad_batch))
    _add_launches(got, out["launches"], FLASH_KERNELS)
    # Remat on (the "auto" policy: its gradient check above) and off, and
    # an effective batch of 64 as 8 microbatches of 8.
    free()
    remat_phase(dev, out.pop("setup"), 3, f"[remat:full:{MODEL_HUGE}]",
                accum=8, timed=timed)
    del out
    free()

    # 577 tokens: row 16 (and row 17 for full fine-tuning).
    long_over = dict(over, image_size=long_size)
    served = serve(long_size, 2 * long_batch, long_batch,
                   f"serve:huge:{long_size}")
    for name in LONG_SERVING_KERNELS:
        require(served[name] > 0, f"{name} never launched serving ViT-H at "
                f"{long_size} px")
    for name in SHORT_ATTENTION_KERNELS:
        require(served[name] == 0, f"{name} launched serving ViT-H at "
                f"{long_size} px")
    _add_launches(got, served, ("blockwise_qkv_attention",))
    out = training_phase(
        dev, impl="rank", path=LONG_SPLIT_KERNELS,
        idle=SHORT_ATTENTION_KERNELS + RANK_RECOMPUTE,
        **dict(common, batch=long_batch, steps=4,
               grad_batch=long_grad_batch, overrides=long_over))
    _add_launches(got, out["launches"], BLOCKWISE_KERNELS)
    del out
    free()
    full = full_step_577(dev, batch=long_grad_batch, model=MODEL_HUGE,
                         timed=timed, **long_over)
    for name in FLASH_KERNELS:
        got[name + "_577"] = full[name]
    free()

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--synthetic", "--dataset", "svhn", "--model", MODEL_HUGE,
                "--dim", "8", "--epochs", "2", "--batch-size", "32",
                "--eval-batch-size", "32", "--synthetic-size", "64",
                "--log-every", "1", "--out-dir", tmp, "--backbone",
                os.path.join(tmp, "none.npz"), "--device", str(dev)]
        for key, value in dict(over, depth=min(cli_depth,
                                               cfg.depth)).items():
            argv += ["--model-override", f"{key}={value}"]
        t0 = time.perf_counter()
        child = cli_child(argv, {})
    print(f"[huge] cli.vit_cp child at depth {cli_depth}, 4 steps: "
          f"{time.perf_counter() - t0:.1f} s; kernel launches "
          f"{ {k: v for k, v in child.items() if v} }", flush=True)
    for name in HUGE_ELEMENT_KERNELS:
        require(child[name] > 0, f"{name} never launched by the ViT-H CLI")

    # Every entry of one kernel instance takes that instance's launches.
    out = {name: got[base + ("_577" if n == 577 and base in FLASH_KERNELS
                             else "")]
           for name, (base, n, dh) in DH_FORMS.items() if dh == 80}
    out.update({name: got[base]
                for name, (base, _, _, e, heads) in PROJ_FORMS.items()
                if e // heads == 80})
    out["block_pair_fwd_huge"] = got["block_pair_fwd_huge"]
    out["build_wd_weight_huge"] = got["build_wd_weight_huge"]
    out.update({"int8_dense" + suffix: got["int8_dense_huge"]
                for suffix in INT8_SHAPES if suffix.startswith("_huge")})
    return out


def narrow_flash_phase(dev, steps=6, batch=64, timed=True) -> dict:
    """Full fine-tuning of the test model (``vit_tiny_test``: four heads of
    width 16) and of the same with two heads (width 32) as
    :func:`training_phase` (the gradient check, ``steps`` steps at lr
    1e-3, no CLI): row 17 at those widths.  Returns the launches of the
    Dh 16 and 32 entries of ``DH_FORMS``."""
    launches = {}
    for dh, over in ((16, {}), (32, {"num_heads": 2})):
        out = training_phase(dev, timed=timed, steps=steps, plain_steps=1,
                             batch=batch, model="vit_tiny_test",
                             method="full", lr=1e-3, path=FLASH_KERNELS,
                             overrides=over, cli=False)
        require(out["setup"][0].head_dim == dh, "head width")
        for name in FLASH_KERNELS:
            launches[f"{name}_dh{dh}"] = out["launches"][name]
        del out
    return launches


def full_step_577(dev, batch=16, model=MODEL_384, timed=True,
                  **overrides) -> dict:
    """One full fine-tuning step of ViT-B/16 at 384 px (or ``model`` with
    ``overrides``; 577 tokens): the flash attention at any token count,
    as on the TPU, so the flash counters grow and the blockwise ones do
    not."""
    cfg, cara_cfg, frozen, state, data = train_setup(
        dev, model=model, batch=batch, method="full", lr=1e-4, **overrides)
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state, losses, ms, _ = fixed_batch_steps(cfg, cara_cfg, frozen, state,
                                             data, generator, 1, timed=timed)
    ms = ms or [float("nan")]
    peak = (f"; peak {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f} "
            "GiB allocated" if dev.type == "cuda" else "")
    launches = read_launches(tuple(KERNELS))
    print(f"[train:full:{model}] one step at batch {batch}: loss "
          f"{losses[0]:.4f}, {ms[0]:.3f} ms (CUDA events, the first step)"
          f"{peak}; kernel launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    tokens = cfg.num_patches + 1
    require(bool(np.isfinite(losses[0])), f"non-finite loss at {tokens} "
            "tokens")
    for name in FLASH_KERNELS:
        require(launches[name] > 0, f"{name} never launched at {tokens} "
                "tokens")
    for name in BLOCKWISE_KERNELS + SHORT_ATTENTION_KERNELS:
        require(launches[name] == 0, f"{name} launched by full fine-tuning "
                f"at {tokens} tokens")
    return launches


def other_routes_grad_check(dev, setup) -> dict:
    """One step's gradients of the row route and of weight dropout 0
    (the split path both) against the fp32 plain path."""
    cfg, cara_cfg, frozen, state, data = setup
    out = {}
    for over in ({"weight_dropout_impl": "row"}, {"weight_dropout": 0.0}):
        cc = dataclasses.replace(cara_cfg, **over)
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
        out[_route(cc)] = grad_check(dev, cfg, cc, frozen, state, data,
                                     generator)
    return out


def profile_steps(dev, impl, steps=5, batch=64, top=24,
                  model=MODEL, overrides=None, label=None,
                  step_kw=None) -> None:
    """``--profile``: device time by kernel of ``steps`` train steps of
    ``model`` on the ``impl`` route (or, for "linear" / "full", that
    method without an adapter) after three warm-up steps from
    ``torch.profiler``, and the busy share: the kernels' summed time over
    the step time by CUDA events of as many steps run without the
    profiler (whose own host cost stretches its window).  ``label``
    names a switch the caller set in the tag; ``step_kw`` go to
    ``make_train_step`` (``grad_accum``, ``remat``)."""
    from torch.profiler import ProfilerActivity, profile

    method = impl if impl in NO_ADAPTER else "cara"
    cfg, cara_cfg, frozen, state, data = train_setup(
        dev, model=model, batch=batch, impl=impl, method=method,
        lr=1e-4 if method == "full" else 1e-3, **(overrides or {}))
    where = {MODEL: "", MODEL_384: ":384", MODEL_CLIP: ":clip",
             MODEL_HUGE: ":huge"}[model]
    tag = f"[profile:{impl}{where}]"
    if overrides:
        tag = tag[:-1] + ":dropout]"
    if label:
        tag = tag[:-1] + f":{label}]"
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    step_fn = steps_lib.make_train_step(cfg, cara_cfg,
                                        compute_dtype=torch.bfloat16,
                                        **(step_kw or {}))
    frozen_c = steps_lib.cast_floating(frozen, torch.bfloat16)
    for _ in range(3):
        state, _ = step_fn(state, frozen_c, data, generator=generator)

    def run():
        nonlocal state
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(steps):
            state, _ = step_fn(state, frozen_c, data, generator=generator)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / steps

    step_ms = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms = run()
    # user annotations (the optimizer's step range) carry the device time
    # of the kernels they enclose, which are listed on their own
    rows = [(e.self_device_time_total / 1e3 / steps, e.count / steps, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer.")]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"{tag} {steps} steps at batch {batch}: {step_ms:.3f} "
          f"ms a step by CUDA events ({profiled_ms:.3f} under the "
          f"profiler); kernels {busy:.3f} ms a step "
          f"({100 * busy / step_ms:.1f} % busy)", flush=True)
    for ms, count, name in rows[:top]:
        print(f"{tag} {ms:8.3f} ms {100 * ms / step_ms:5.1f} % "
              f"{count:6.1f}/step  {name[:90]}", flush=True)
    rest = sum(r[0] for r in rows[top:])
    print(f"{tag} {rest:8.3f} ms in {len(rows) - top} other "
          f"kernels", flush=True)


def _row_major_codes(pred):
    """``pred`` with its w8a8 codes made row-major again (the layout
    ``quantize_block_weights`` writes; ``Predictor`` keeps them
    column-major for ``torch._int_mm``): the comparison row of
    :func:`profile_serving`."""
    for name in quant_lib.QUANT_NAMES:
        kernel = pred._params["blocks"][name]["kernel"]
        kernel["qa"] = kernel["qa"].contiguous()
    return pred


def profile_serving(dev, batch=64, iters=5, rounds=4, top=12) -> None:
    """``--profile``: merged ViT-B serving at ``batch`` in bf16 and
    quantized (int8 with ``CARA_INT8_PALLAS`` unset and set, w8a8, and
    w8a8 with row-major codes): img/s through ``Predictor.logits`` in
    turns (``rounds`` rounds of ten calls, the order reversed every
    other round; host clock), then one forward's device time by kernel
    (``torch.profiler``, ``iters`` forwards) and the busy share."""
    from torch.profiler import ProfilerActivity, profile

    images = make_images(batch, 224)
    x = torch.from_numpy(images).to(dev, torch.bfloat16)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "vit_smoke_seed_0.npz")
        make_checkpoint(ckpt)

        def pred(**kw):
            return Predictor.from_checkpoint_auto(
                ckpt, MODEL, batch_size=batch, device=dev,
                dtype=torch.bfloat16, **kw)
        preds = {"bf16": (pred(), False),
                 "int8": (pred(quantize="int8"), False),
                 "int8:CARA_INT8_PALLAS=1": (pred(quantize="int8"), True),
                 "w8a8": (pred(quantize="w8a8"), False),
                 "w8a8:row-major": (_row_major_codes(pred(
                     quantize="w8a8")), False)}
    rates = {k: [] for k in preds}
    for r in range(rounds + 1):  # round 0 warms up
        for name in (list(preds) if r % 2 == 0 else list(preds)[::-1]):
            p, on = preds[name]
            with int8_switch(on):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(10):
                    p.logits(images)
                if r:
                    rates[name].append(10 * batch
                                       / (time.perf_counter() - t0))
    for name, (p, on) in preds.items():
        tag = f"[profile:serve:{name}]"
        with int8_switch(on), torch.inference_mode():
            def run():
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    vit_forward(p._params, x, p.cfg)
                end.record()
                end.synchronize()
                return start.elapsed_time(end) / iters
            fwd_ms = run()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run()
        rows = [(e.self_device_time_total / 1e3 / iters, e.count / iters,
                 e.key) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        print(f"{tag} {statistics.median(rates[name]):.1f} img/s at batch "
              f"{batch} (median of {rounds} turns, host clock; "
              f"{', '.join(f'{v:.1f}' for v in rates[name])}); a forward "
              f"{fwd_ms:.3f} ms by CUDA events, kernels {busy:.3f} ms "
              f"({100 * busy / fwd_ms:.1f} % busy)", flush=True)
        for ms, count, name_ in rows[:top]:
            print(f"{tag} {ms:8.3f} ms {count:6.1f}/forward  {name_[:90]}",
                  flush=True)


def _peak_gib(dev) -> float:
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30


def timed_variants(dev, setup, variants, steps, tag, rounds=1,
                   timed=True) -> dict:
    """``variants`` (name -> ``make_train_step`` options) of the train step
    on one setup, ``steps`` steps each, in turns over ``rounds`` rounds:
    the median ms a step by CUDA events (steps 2 on) and the peak device
    memory of each, printed with ``tag``."""
    cfg, cara_cfg, frozen, state, data = setup
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    out = {name: {"ms": [], "peak_gib": 0.0} for name in variants}
    for _ in range(rounds):
        for name, kw in variants.items():
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            state, losses, ms, _ = fixed_batch_steps(
                cfg, cara_cfg, frozen, state, data, generator, steps,
                timed=timed, **kw)
            require(all(np.isfinite(losses)), f"{tag} {name}: non-finite")
            out[name]["ms"] += ms[1:]
            if dev.type == "cuda":
                out[name]["peak_gib"] = max(out[name]["peak_gib"],
                                            _peak_gib(dev))
    for name, rec in out.items():
        rec["median_ms"] = statistics.median(rec["ms"]) if rec["ms"] else None
        print(f"{tag} {name} ({variants[name]}): median "
              f"{rec['median_ms'] if rec['ms'] else 'not timed'} ms a step "
              f"(CUDA events, {len(rec['ms'])} steps in {rounds} round(s)), "
              f"peak {rec['peak_gib']:.3f} GiB allocated", flush=True)
    return out


def accum_phase(dev, setup, micro=4, steps=8, timed=True) -> dict:
    """Gradient accumulation on the element route (``setup`` from
    :func:`training_phase`, batch 64): the accumulated step's gradient
    check (``micro`` microbatches, every leaf against the fp32 plain
    path's accumulated step, :func:`grad_check`'s bound), then the
    accumulated step and the one-pass step timed in turns, with the
    peak memory of each."""
    cfg, cara_cfg, frozen, state, data = setup
    batch = data["label"].shape[0]
    tag = f"[accum:{_route(cara_cfg)}]"
    generator = torch.Generator(device=dev)
    generator.manual_seed(1)
    out = grad_check(dev, cfg, cara_cfg, frozen, state, data, generator,
                     tag=tag, grad_accum=micro)
    out.update(timed_variants(
        dev, setup, {f"one pass of {batch}": {},
                     f"{micro} x {batch // micro}": {"grad_accum": micro}},
        steps, tag, rounds=2, timed=timed))
    return out


def nan_phase(dev, setup, steps=8, timed=True) -> None:
    """``--nan-check`` on the element route: a batch with one image all NaN
    raises ``FloatingPointError`` (the step not taken), and the check's
    cost on clean steps, timed in turns with the unchecked step."""
    cfg, cara_cfg, frozen, state, data = setup
    step_fn = steps_lib.make_train_step(cfg, cara_cfg,
                                        compute_dtype=torch.bfloat16,
                                        nan_check=True)
    bad = dict(data, image=data["image"].clone())
    bad["image"][3] = float("nan")
    generator = torch.Generator(device=dev)
    generator.manual_seed(2)
    frozen_c = steps_lib.cast_floating(frozen, torch.bfloat16)
    before = state.step
    try:
        step_fn(state, frozen_c, bad, generator=generator)
        raised = None
    except FloatingPointError as exc:
        raised = str(exc)
    print(f"[nan-check] a batch with one NaN image: {raised}", flush=True)
    require(raised is not None and state.step == before,
            "--nan-check let a NaN batch through")
    timed_variants(dev, setup, {"unchecked": {},
                                "nan_check": {"nan_check": True}},
                   steps, "[nan-check]", rounds=2, timed=timed)


def remat_phase(dev, setup, steps, tag, accum=None, timed=True,
                check_off=False) -> None:
    """A route without an adapter (``setup`` from :func:`training_phase`,
    whose gradient check ran with the "auto" remat, on): with
    ``check_off``, the same gradient check with ``remat=False``; the step
    with remat "auto" and with ``remat=False`` (``--no-remat``) timed in
    turns with each one's peak memory; with ``accum``, the step as
    ``accum`` microbatches too."""
    if check_off:
        cfg, cara_cfg, frozen, state, data = setup
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
        grad_check(dev, cfg, cara_cfg, frozen, state, data, generator,
                   tag=tag[:-1] + ":no-remat]", remat=False)
    variants = {"remat auto (on)": {}, "no remat": {"remat": False}}
    if accum:
        batch = setup[4]["label"].shape[0]
        variants[f"{accum} x {batch // accum}"] = {"grad_accum": accum}
    timed_variants(dev, setup, variants, steps, tag, timed=timed)


def resume_args(model, tmp, dev) -> list:
    """The CLI arguments of :func:`resume_phase`'s children: 2 epochs of
    8 steps of batch 32 and an eval of 64 images, the 2-class task (so
    that the final eval's accuracy is above 0 and a checkpoint is kept)."""
    return ["--synthetic", "--dataset", "patch_camelyon", "--model", model,
            "--dim", "8", "--epochs", "2", "--batch-size", "32",
            "--eval-batch-size", "64", "--synthetic-size", "256",
            "--log-every", "1", "--backbone", os.path.join(tmp, "none.npz"),
            "--device", str(dev)]
# The port's kernels a trace of an element step must hold: the sites and
# the GEMM core's products, the attention, the fold.
TRACE_KERNELS = ("gemm_kernel", "qkv_attention_kernel", "wd_fold_kernel")


def _resume_child(argv, wrap, sigterm=False, timeout=600, cli="vit_cp_cli"):
    """``cli.vit_cp`` (or the CLI module ``chip_smoke.<cli>``) with
    ``argv`` in a child process; ``wrap`` is code run before it (it may
    instrument ``train.checkpoint``).  With ``sigterm`` the child gets
    SIGTERM once it has logged its first step.  Returns (its stdout
    lines, its launch counters, its build info)."""
    code = "\n".join([
        "import json, sys, chip_smoke",
        "from cara_tpu_torch.train import checkpoint as c",
        "from cara_tpu_torch.ops.cuda import _build",
        wrap,
        f"chip_smoke.{cli}.main(sys.argv[1:])",
        "print(json.dumps({'launches': chip_smoke.read_launches(",
        "    tuple(chip_smoke.KERNELS)), 'build': {",
        "    'cached': _build.BUILD_INFO['cached'],",
        "    'dir': str(_build.BUILD_DIR)}}))"])
    lines = []
    with tempfile.TemporaryFile(mode="w+") as err:
        proc = subprocess.Popen([sys.executable, "-c", code, *argv],
                                stdout=subprocess.PIPE, stderr=err,
                                text=True)
        try:
            deadline = time.perf_counter() + timeout
            for line in proc.stdout:
                lines.append(line.rstrip())
                if (sigterm and proc.poll() is None
                        and line.startswith("{") and '"loss"' in line):
                    proc.send_signal(signal.SIGTERM)
                    sigterm = False
                    print(f"  child: {line.rstrip()}\n  parent: SIGTERM",
                          flush=True)
                require(time.perf_counter() < deadline, "child timed out")
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        err.seek(0)
        require(proc.returncode == 0, f"{cli} child exited "
                f"{proc.returncode}: {err.read()[-3000:]}")
    tail = json.loads(lines[-1])
    return lines[:-1], tail["launches"], tail["build"]


def resume_phase(dev, tmp, model=MODEL) -> str:
    """Resume and preemption through the CLI at ViT-B width: a child with
    ``--resume-dir`` (and ``--memory-report``, ``--profile-dir``) gets
    SIGTERM once it has logged its first step, exits 0 with "Preempted
    (SIGTERM) at step k", and ``latest_step`` reads k; the digest of the
    snapshot it saved, of the file, and of the state a relaunch restored
    agree; the relaunch, with ``--compilation-cache`` at a directory that
    holds a copy of the built library, prints "resumed from ... step k",
    loads the library without building it and runs to its end.  The
    trace of the first child holds the port's sites, attention and fold.
    Returns the relaunch's best checkpoint."""
    resume, prof, cache = (os.path.join(tmp, d) for d in
                           ("resume", "prof", "cache"))
    out_dir = os.path.join(tmp, "out")
    os.makedirs(cache)
    for name in (_build.LIB_NAME, _build.LIB_NAME + ".sha256"):
        shutil.copy2(_build.BUILD_DIR / name, os.path.join(cache, name))
    cached_files = sorted(os.listdir(cache))
    argv = resume_args(model, tmp, dev) + ["--out-dir", out_dir,
                                            "--resume-dir", resume]
    save_wrap = "\n".join([
        "real = c.save_train_state",
        "def save(*a, **k):",
        "    d = real(*a, **k)",
        "    print(json.dumps({'saved_digest': d, 'step': a[1]}), "
        "flush=True)",
        "    return d",
        "c.save_train_state = save"])
    t0 = time.perf_counter()
    lines, launches, _ = _resume_child(
        argv + ["--memory-report", "--profile-dir", prof], save_wrap,
        sigterm=True)
    t1 = time.perf_counter()
    for line in lines[-5:]:
        print(f"  child: {line}", flush=True)
    preempted = [l for l in lines if l.startswith("Preempted (SIGTERM)")]
    require(len(preempted) == 1, "the child did not report its preemption")
    k = int(preempted[0].split("at step ")[1].split()[0])
    saved = [json.loads(l) for l in lines if '"saved_digest"' in l]
    memory = [l for l in lines if l.startswith('{"train_step_memory"')]
    print(f"[resume] first child: {t1 - t0:.1f} s, preempted at step {k}, "
          f"snapshots {saved}; {memory}", flush=True)
    require(len(memory) == 1 and (dev.type != "cuda" or json.loads(
        memory[0])["train_step_memory"]["total_mib"] > 0),
        "no memory report line")
    require(ckpt_lib.latest_step(resume) == k == saved[-1]["step"],
            f"latest_step {ckpt_lib.latest_step(resume)}, preempted at {k}")
    on_disk = ckpt_lib.digest(ckpt_lib.load_snapshot(resume, k))
    require(on_disk == saved[-1]["saved_digest"],
            "the snapshot on disk is not what the child saved")
    traces = os.listdir(prof)
    require(len(traces) == 1, f"--profile-dir wrote {traces}")
    with open(os.path.join(prof, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    print(f"[profile] {traces[0]}: {len(events)} events, "
          f"{len(kernels)} kernel names, the port's: "
          f"{sorted({n for n in kernels for w in TRACE_KERNELS if w in n})}",
          flush=True)
    for want in TRACE_KERNELS:
        require(any(want in n for n in kernels),
                f"the trace holds no {want}")

    restore_wrap = "\n".join([
        "real = c.restore_train_state",
        "def restore(d, step, template, generator=None):",
        "    out = real(d, step, template, generator)",
        "    print(json.dumps({'restored_digest': c.digest(",
        "        c.snapshot_arrays(out[0], generator))}), flush=True)",
        "    return out",
        "c.restore_train_state = restore"])
    lines, launches, build = _resume_child(
        argv + ["--compilation-cache", cache], restore_wrap)
    for line in lines[-4:]:
        print(f"  child: {line}", flush=True)
    print(f"[resume] relaunch: {time.perf_counter() - t1:.1f} s; kernel "
          f"build {build}", flush=True)
    resumed = [l for l in lines if l.startswith("[cara_tpu] resumed from")]
    require(len(resumed) == 1 and f"step {k} " in resumed[0],
            f"the relaunch did not resume from step {k}: {resumed}")
    restored = [json.loads(l)["restored_digest"] for l in lines
                if '"restored_digest"' in l]
    require(restored == [on_disk], "the restored state is not the saved one")
    require(build["cached"] is True and build["dir"] == cache
            and sorted(os.listdir(cache)) == cached_files,
            f"--compilation-cache built again: {build}, "
            f"{sorted(os.listdir(cache))}")
    for name in TRAINING_KERNELS:
        require(launches[name] > 0, f"{name} never launched by the relaunch")
    ckpts = sorted(f for f in os.listdir(out_dir) if f.endswith(".npz"))
    require(len(ckpts) == 1, f"the relaunch wrote {ckpts}")
    print(f"[resume] digests: saved = on disk = restored ({on_disk[:16]}); "
          f"best checkpoint {ckpts[0]}", flush=True)
    return os.path.join(out_dir, ckpts[0])


def export_phase(dev, ckpt, tmp, n_images=64, model=MODEL) -> None:
    """``cli.export`` merged / adapter / full of ``ckpt`` on the card: the
    merged export's arrays within ``EXPORT_WEIGHT_RTOL`` of an fp32 merge
    of ``ckpt`` on the card at its recorded scale, while the same merge
    at half the scale and the backbone without its adapter (the
    controls) must miss that bound; the merged export served through
    ``Predictor.from_checkpoint_auto`` against ``merge=True`` on
    ``ckpt`` (within ``EXPORT_LOGIT_RTOL``); the adapter file holds the
    factors and head; the full one the original arrays; ``cli.vit_cp
    --evaluate --merged-eval`` prints an accuracy; ``cli.predict`` on
    PNG files classifies them as the Predictor does."""
    reset_launches()
    paths = {}
    for mode in ("merged", "adapter", "full"):
        paths[mode] = os.path.join(tmp, f"export_{mode}.npz")
        t0 = time.perf_counter()
        export_cli.main(["--ckpt", ckpt, "--out", paths[mode], "--mode",
                         mode, "--device", str(dev)])
        print(f"[export] --mode {mode}: {time.perf_counter() - t0:.3f} s, "
              f"{os.path.getsize(paths[mode]) / 2 ** 20:.3f} MiB", flush=True)
    params, cara, meta = ckpt_lib.load_model(ckpt)
    a_cara, a_head, a_meta = ckpt_lib.load_adapter(paths["adapter"])
    require(ckpt_lib.is_adapter_checkpoint(paths["adapter"])
            and a_meta["scale"] == meta["scale"]
            and sorted(a_cara) == sorted(cara) and a_head is not None,
            "the adapter export lost its factors, head or scale")
    f_params, f_cara, _ = ckpt_lib.load_model(paths["full"])
    want = ckpt_lib.flatten_tree({"p": params, "c": cara})
    got = ckpt_lib.flatten_tree({"p": f_params, "c": f_cara})
    require(sorted(got) == sorted(want)
            and all(np.array_equal(got[k], want[k]) for k in want),
            "the full export differs from its input")
    cfg = get_model_config(model, num_classes=params["head"]["kernel"].shape[
        -1], **meta.get("model_overrides", {}))
    exported = ckpt_lib.flatten_tree(ckpt_lib.load_model(paths["merged"])[0])

    def weight_err(want):  # worst array's max |diff| / max |value|
        require(sorted(want) == sorted(exported),
                "the merged export holds other arrays")
        return max(float(np.abs(exported[k] - want[k]).max()) / max(
            float(np.abs(want[k]).max()), float(np.abs(exported[k]).max()),
            1e-30) for k in want)

    def merged_at(scale):  # fp32 on the card, TF32 off (``main``)
        return ckpt_lib.flatten_tree(merge_cara(
            convert.params_from_numpy(params, dev, torch.float32),
            convert.params_from_numpy(cara, dev, torch.float32), cfg,
            ckpt_lib.infer_cara_cfg(cara, meta, scale=scale)))

    scale = float(meta["scale"])
    errs = {"the merge at the recorded scale": weight_err(merged_at(scale)),
            "control: half the scale": weight_err(merged_at(scale / 2)),
            "control: the adapter dropped": weight_err(
                ckpt_lib.flatten_tree(params))}
    print(f"[export] merged arrays, worst max|diff| / max|value| (bound "
          f"{EXPORT_WEIGHT_RTOL:.0e}): " + "; ".join(
              f"{k} {v:.4e}" for k, v in errs.items()), flush=True)
    first, *controls = errs.values()
    require(first <= EXPORT_WEIGHT_RTOL,
            "the merged export differs from the merge of its checkpoint")
    require(all(c > EXPORT_WEIGHT_RTOL for c in controls),
            "a wrong merge passes the merged export's check")
    size = cfg.image_size
    images = make_images(n_images, size, seed=7)
    merged = Predictor.from_checkpoint_auto(paths["merged"], model,
                                            device=dev, dtype=torch.bfloat16)
    require(merged._cara is None, "the merged export carries an adapter")
    ref = Predictor.from_checkpoint_auto(ckpt, model, merge=True, device=dev,
                                         dtype=torch.bfloat16)
    got, want = merged.logits(images), ref.logits(images)
    err = float(np.abs(got - want).max())
    tol = EXPORT_LOGIT_RTOL * float(np.abs(want).max())
    print(f"[export] merged export served: max|logits - merge=True on the "
          f"checkpoint| {err:.4e}, tolerance {tol:.4e}", flush=True)
    require(err <= tol, "the merged export serves other logits")
    acc = vit_cp_cli.main(resume_args(model, tmp, dev)
                          + ["--evaluate", ckpt, "--merged-eval"])
    print(f"[export] --evaluate --merged-eval: accuracy {acc}", flush=True)
    require(0.0 <= acc <= 1.0, f"--merged-eval accuracy {acc}")
    files = []
    for i in range(4):
        files.append(os.path.join(tmp, f"img{i}.png"))
        with open(files[-1], "wb") as f:
            f.write(_png(images[i]))
    t0 = time.perf_counter()
    results = predict_cli.main(["--ckpt", ckpt, "--model", model, "--top",
                                "2", "--device", str(dev), *files])
    decoded = np.stack([normalize(load_image_u8(p, size).astype(np.float32)
                                  / 255.0) for p in files])
    top = np.argsort(-ref.logits(decoded), axis=-1)[:, 0]
    print(f"[predict] {time.perf_counter() - t0:.3f} s: "
          f"{[r['classes'] for r in results]}; the Predictor's top-1 "
          f"{top.tolist()}", flush=True)
    require([r["classes"][0] for r in results] == top.tolist(),
            "cli.predict disagrees with the Predictor")
    launched = read_launches(("fused_qkv_attention",))
    require(launched["fused_qkv_attention"] > 0,
            "the exported model's forward launched no attention kernel")


# The multi-task group of ``multitask_phase``: (task, delta scale, classes).
MULTITASK = (("svhn", 0.1, 2), ("dtd", 10.0, 10), ("caltech101", 100.0, 102))
# The CP orders and delta forms of ``orders_phase``: (weight-dropout impl,
# CP order, delta form, gradient check).  Order 4's element step (no
# check: ``training_phase`` holds it) is the yardstick of the others.
ORDER_ROUTES = (("element", 4, "factorized", False),
                ("element", 3, "factorized", True),
                ("element", 5, "factorized", True),
                ("rank", 5, "factorized", True),
                ("element", 2, "factorized", True),
                ("element", 4, "materialized", True))
# What the dense deltas (order 2, materialized) launch: the attention
# only; their products are the XLA form's matmuls.
DENSE_DELTA_KERNELS = ("fused_qkv_attention", "fused_qkv_attention_bwd")
# The unmerged eval: the block megakernels (rows 5 and 9, the attention
# inside row 5) and their sites.
ADAPTER_SERVING_KERNELS = ("cp_attn_block", "cp_mlp_block") + SITE_SERVING


def google_npz(path, params, cfg) -> None:
    """Write ``params`` (the port's tree) as a Google-format ViT npz, the
    inverse of ``models.npz.convert_npz_dict`` (what ``--backbone``
    reads)."""
    e, h, d, p = cfg.embed_dim, cfg.num_heads, cfg.head_dim, cfg.patch_size
    b = params["blocks"]
    z = {"embedding/kernel": params["embed"]["kernel"].reshape(
             p, p, cfg.in_chans, e),
         "embedding/bias": params["embed"]["bias"], "cls": params["cls"],
         "Transformer/posembed_input/pos_embedding": params["pos_embed"],
         "Transformer/encoder_norm/scale": params["norm"]["scale"],
         "Transformer/encoder_norm/bias": params["norm"]["bias"]}
    if "pre_logits" in params:
        z["pre_logits/kernel"] = params["pre_logits"]["kernel"]
        z["pre_logits/bias"] = params["pre_logits"]["bias"]
    attn = "MultiHeadDotProductAttention_1"
    for i in range(cfg.depth):
        pre = f"Transformer/encoderblock_{i}/"
        z[pre + "LayerNorm_0/scale"] = b["ln1_scale"][i]
        z[pre + "LayerNorm_0/bias"] = b["ln1_bias"][i]
        z[pre + "LayerNorm_2/scale"] = b["ln2_scale"][i]
        z[pre + "LayerNorm_2/bias"] = b["ln2_bias"][i]
        qk = b["qkv"]["kernel"][i].reshape(e, 3, h, d)
        qb = b["qkv"]["bias"][i].reshape(3, h, d)
        for j, n in enumerate(("query", "key", "value")):
            z[f"{pre}{attn}/{n}/kernel"] = qk[:, j]
            z[f"{pre}{attn}/{n}/bias"] = qb[j]
        z[f"{pre}{attn}/out/kernel"] = b["proj"]["kernel"][i].reshape(h, d, e)
        z[f"{pre}{attn}/out/bias"] = b["proj"]["bias"][i]
        z[pre + "MlpBlock_3/Dense_0/kernel"] = b["fc1"]["kernel"][i]
        z[pre + "MlpBlock_3/Dense_0/bias"] = b["fc1"]["bias"][i]
        z[pre + "MlpBlock_3/Dense_1/kernel"] = b["fc2"]["kernel"][i]
        z[pre + "MlpBlock_3/Dense_1/bias"] = b["fc2"]["bias"][i]
    np.savez(path, **{k: np.asarray(v, np.float32) for k, v in z.items()})


def multitask_group(cfg, rank=8, order=4, seed=30) -> dict:
    """``MULTITASK``'s tasks for ``MultiTaskPredictor``: a perturbed CaRA
    adapter (``rank``, ``order``) and a fresh head each, numpy trees."""
    tasks = {}
    for i, (name, scale, classes) in enumerate(MULTITASK):
        cara = convert.perturb_adapter(convert.init_cara_params(
            cfg, CaraConfig(rank=rank, cp_order=order), seed + i),
            seed + 10 + i)
        tasks[name] = {"cara": cara, "scale": scale, "cp_order": order,
                       "head": api.linear_init(seed + 20 + i,
                                               api._head_in_dim(cfg),
                                               classes)}
    return tasks


def multitask_reference(pred, images, task, chunk=32):
    """fp32 plain forward of ``task`` on the predictor's own (bf16)
    backbone, adapter, head and scale."""
    tid = pred._tid[task]
    params = dict(convert.map_floating(pred._base, lambda t: t.float()),
                  head={"kernel": pred._hk[tid].float(),
                        "bias": pred._hb[tid].float()})
    cara = {k: v[tid].float() for k, v in pred._cara.items()}
    outs = []
    with torch.inference_mode():
        for s in range(0, len(images), chunk):
            x = torch.from_numpy(images[s:s + chunk]).to(pred.device)
            outs.append(vit_forward(
                params, x, pred.cfg, cara_params=cara,
                cara_cfg=pred._cara_cfg, impl="plain",
                scale_override=pred._scales[tid]).cpu().numpy())
    return np.concatenate(outs)[:, :pred._num_classes[task]]


def _logit_check(tag, got, ref, against="fp32 plain") -> None:
    err = float(np.abs(got - ref).max())
    tol = LOGIT_RTOL * float(np.abs(ref).max())
    print(f"[{tag}] max|logits - {against}| {err:.4e}, tolerance "
          f"{tol:.4e} ({LOGIT_RTOL} x max|ref|)", flush=True)
    require(bool(np.isfinite(got).all()), f"{tag}: non-finite logits")
    require(err <= tol, f"{tag}: logits disagree with the plain path")


def _post(port, query, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict{query}",
                                 data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def multitask_phase(dev, model=MODEL, batch=64, n_images=96, rounds=2,
                    timed=True, cli=True) -> dict:
    """Multi-task serving: ``MULTITASK``'s three CaRA tasks (delta scales
    0.1, 10 and 100; 2, 10 and 102 classes) over one backbone of
    ``model`` at full width and depth, bf16, ``batch`` a call:

    1. ``MultiTaskPredictor``: each task's logits on ``n_images`` images
       within ``LOGIT_RTOL`` of its fp32 plain forward; the same bits when
       the tasks are asked in the other order; rows 1, 5 and 9 launch
       (the tasks share every kernel call: the scale rides the factors);
       then one task with every block through row 19;
    2. ``InferenceServer``: a stream of 3 x ``n_images`` requests cycling
       over the tasks from 8 client threads (img/s on the host clock,
       each answer within ``LOGIT_RTOL`` of its task's fp32 forward),
       ``/stats`` per task, ``POST /predict?task=`` over HTTP and its 400
       / 404; the group's img/s at ``batch`` in turns with a single-task
       adapter ``Predictor`` on the same backbone;
    3. the group with ``quantize="int8"`` (the shared backbone only),
       with ``CARA_INT8_PALLAS`` unset and set (row 18 launches 4 x depth
       times a forward with it), within ``QUANT_BOUNDS`` of the bf16
       group's logits;
    4. ``python -m cara_tpu_torch.cli.serve`` in a child with two
       ``name=path`` adapter-only checkpoints and ``--backbone`` (a
       Google-format npz), answering 8 requests over HTTP.

    Returns the launches of rows 5, 9, 18 and 19 over 1-3."""
    cfg = get_model_config(model, num_classes=0)
    params = init_backbone(get_model_config(model, num_classes=10), 0)
    params.pop("head")
    tasks = multitask_group(cfg)
    names = list(tasks)
    images = make_images(n_images, cfg.image_size, seed=11)
    print(f"[multitask] {model}: depth {cfg.depth}, tasks "
          f"{[(n, s, c) for n, s, c in MULTITASK]} (name, scale, classes), "
          f"rank 8, order 4, batch {batch}, bf16", flush=True)
    pred = MultiTaskPredictor(params, cfg, tasks, batch_size=batch,
                              device=dev)
    reset_launches()
    first = {}
    for name in names:
        first[name] = pred.logits(images, name)
        require(first[name].shape == (n_images, tasks[name]["head"][
            "kernel"].shape[-1]), f"{name}: logits {first[name].shape}")
        _logit_check(f"multitask:{name}", first[name],
                     multitask_reference(pred, images, name))
    launches = read_launches(ADAPTER_SERVING_KERNELS)
    print(f"[multitask] kernel launches: {launches}", flush=True)
    for kname, count in launches.items():
        require(count > 0, f"{kname} never launched serving the tasks")
    for name in reversed(names):
        require(np.array_equal(pred.logits(images, name), first[name]),
                f"{name}: other bits when the tasks come in another order")
    print("[multitask] the same bits with the tasks in the reverse order",
          flush=True)
    out = {k: launches[k] for k in ("cp_attn_block", "cp_mlp_block")}
    # One task with every block through row 19.
    old = vit_lib._block
    vit_lib._block = _pair_block
    try:
        reset_launches()
        got = pred.logits(images[:batch], "caltech101")
        pair = read_launches(("block_pair_fwd", "cp_attn_block"))
    finally:
        vit_lib._block = old
    err = float(np.abs(got - first["caltech101"][:batch]).max())
    tol = LOGIT_RTOL * float(np.abs(first["caltech101"]).max())
    print(f"[multitask:block_pair] caltech101 (scale 100) through row 19: "
          f"launches {pair}; max|logits - default route's| {err:.4e}, "
          f"tolerance {tol:.4e}", flush=True)
    require(pair["block_pair_fwd"] == cfg.depth
            and pair["cp_attn_block"] == 0 and err <= tol,
            "the tasks' row 19 eval disagrees")
    out["block_pair_fwd"] = pair["block_pair_fwd"]

    # The mixed stream through the server, then HTTP.
    reset_launches()
    srv = InferenceServer(pred, port=0).start(warmup=True)
    try:
        stream = np.concatenate([images] * len(names))
        t0 = time.perf_counter()
        rows = serve_requests(srv, stream, tasks=names)
        wall = time.perf_counter() - t0
        health = _get(srv.port, "/healthz")
        body = _png(images[0])
        answers = {n: _post(srv.port, f"?task={n}", body) for n in names}
        bad = (_post(srv.port, "", body), _post(srv.port, "?task=x", body))
        stats = _get(srv.port, "/stats")
    finally:
        srv.close()
    out["cp_attn_block"] += read_launches(("cp_attn_block",))[
        "cp_attn_block"]
    for i, row in enumerate(rows):
        name = names[i % len(names)]
        ref = first[name][i % n_images]
        require(row.shape == ref.shape and float(np.abs(row - ref).max())
                <= LOGIT_RTOL * float(np.abs(first[name]).max()),
                f"stream request {i} ({name}) disagrees")
    print(f"[multitask:server] {len(rows)} requests over {len(names)} tasks "
          f"from 8 threads: {len(rows) / wall:.1f} img/s (host clock, "
          f"{wall:.3f} s); /stats {json.dumps(stats)}", flush=True)
    require(health.get("tasks") == names, f"healthz: {health}")
    for name in names:
        require(stats[name]["requests"] == n_images + 1,
                f"/stats counts {stats[name]['requests']} for {name}")
        code, ans = answers[name]
        require(code == 200 and max(ans["classes"]) < tasks[name]["head"][
            "kernel"].shape[-1], f"POST ?task={name}: {code} {ans}")
    require([c for c, _ in bad] == [400, 404], f"bad requests: {bad}")
    print(f"[multitask:server] POST ?task=: {[answers[n][1]['class'] for n in names]}; "
          f"no task {bad[0][0]}, unknown task {bad[1][0]}", flush=True)
    if timed:
        single = Predictor(
            dict(params, head=tasks["dtd"]["head"]),
            get_model_config(model, num_classes=10),
            cara_params=tasks["dtd"]["cara"],
            cara_cfg=CaraConfig(rank=8, scale=tasks["dtd"]["scale"]),
            merge=False, batch_size=batch, device=dev)
        x = images[:batch]
        rates = {"multi-task": [], "single-task adapter": []}
        for r in range(rounds):
            for label in (("multi-task", "single-task adapter") if r % 2 == 0
                          else ("single-task adapter", "multi-task")):
                calls = ([lambda n=n: pred.logits(x, n) for n in names]
                         if label == "multi-task" else
                         [lambda: single.logits(x)])
                calls[0]()
                t0 = time.perf_counter()
                for i in range(12):
                    calls[i % len(calls)]()
                rates[label].append(12 * len(x) / (time.perf_counter() - t0))
        print(f"[multitask] img/s at batch {len(x)} in turns (host clock): "
              + "; ".join(f"{k} " + ", ".join(f"{v:.1f}" for v in vs)
                          for k, vs in rates.items()), flush=True)
        del single

    # int8 on the shared backbone.
    q = MultiTaskPredictor(params, cfg, tasks, batch_size=batch, device=dev,
                           quantize="int8")
    x = images[:batch]
    out["int8_dense"] = 0
    for switch in (False, True):
        with int8_switch(switch):
            for name in names:
                reset_launches()
                got = q.logits(x, name)
                n8 = int8_mod.LAUNCHES
                want = 4 * cfg.depth if switch else 0
                tag = (f"multitask:int8:{name}"
                       f"{':CARA_INT8_PALLAS=1' if switch else ''}")
                require(n8 == want, f"{tag}: row 18 launched {n8}, want "
                        f"{want}")
                out["int8_dense"] += n8
                quant_logit_check(tag, got, first[name][:batch], "int8")
            if timed:
                q.logits(x, names[0])
                t0 = time.perf_counter()
                for i in range(9):
                    q.logits(x, names[i % 3])
                print(f"[multitask:int8{':CARA_INT8_PALLAS=1' if switch else ''}]"
                      f" {9 * len(x) / (time.perf_counter() - t0):.1f} img/s "
                      f"at batch {len(x)} (host clock)", flush=True)
    del q, pred
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    if cli:
        with tempfile.TemporaryDirectory() as tmp:
            bb = os.path.join(tmp, "backbone.npz")
            t0 = time.perf_counter()
            google_npz(bb, params, cfg)
            argv = ["--model", model, "--backbone", bb, "--port", "0",
                    "--max-batch", str(batch), "--max-wait-ms", "20",
                    "--device", str(dev)]
            for name in ("svhn", "caltech101"):
                path = os.path.join(tmp, f"{name}_adapter.npz")
                ckpt_lib.save_adapter(
                    path, tasks[name]["cara"], tasks[name]["head"],
                    {"scale": tasks[name]["scale"], "cp_order": 4,
                     "model": model, "dataset": name})
                argv += ["--ckpt", f"{name}={path}"]
            print(f"[multitask:cli] backbone npz and adapters written in "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
            code = ("import json, sys, chip_smoke; "
                    "from cara_tpu_torch.cli import serve; "
                    "serve.main(sys.argv[1:]); print(json.dumps("
                    "chip_smoke.read_launches(('cp_attn_block',))))")
            with tempfile.TemporaryFile(mode="w+") as err:
                t0 = time.perf_counter()
                got, stats = _serve_child(code, argv, err, images, 8,
                                          tasks=["svhn", "caltech101"],
                                          tag="multitask:cli")
                err.seek(0)
                require(got is not None,
                        f"multi-task serve child failed: {err.read()[-2000:]}")
            child = json.loads(got.strip().splitlines()[-1])
            print(f"[multitask:cli] child {time.perf_counter() - t0:.1f} s; "
                  f"its row 5 launches {child['cp_attn_block']}", flush=True)
            require(child["cp_attn_block"] > 0,
                    "the serve child launched no adapter kernel")
    return out


def eval_check(dev, cfg, cc, frozen, state, data, tag) -> dict:
    """The trained adapter's eval forward in bf16 (the kernels) against
    the fp32 plain forward on the same bf16-rounded weights: max |error|
    within ``LOGIT_RTOL`` of max |logits|, or, where larger, the plain
    path's own worst error in bf16 over the batch and ``NOISE_DRAWS``
    copies with perturbed images (the gradient check's policy: a large
    dense delta, as order 2's perturbed (E^2, r) factor gives, makes the
    bf16 forward itself drift).  Returns the first forward's launches of
    rows 5 and 9."""
    t = steps_lib.cast_floating(state.trainable, torch.bfloat16)
    params = steps_lib.merge_params(
        steps_lib.cast_floating(frozen, torch.bfloat16), t)
    params32 = convert.map_floating(params, lambda v: v.float())
    cara32 = convert.map_floating(t["cara"], lambda v: v.float())
    errs = []
    with torch.inference_mode():
        for k in range(NOISE_DRAWS + 1):
            x = _perturbed(data, k, dev)["image"]
            if k == 0:
                reset_launches()
            got = vit_forward(params, x.to(torch.bfloat16), cfg, t["cara"],
                              cc).float()
            if k == 0:
                evals = read_launches(("cp_attn_block", "cp_mlp_block"))
            plain = vit_forward(params, x.to(torch.bfloat16), cfg,
                                t["cara"], cc, impl="plain").float()
            ref = vit_forward(params32, x.float(), cfg, cara32, cc,
                              impl="plain")
            errs.append((float((got - ref).abs().max()),
                         float((plain - ref).abs().max()),
                         float(ref.abs().max())))
            require(bool(torch.isfinite(got).all()), f"{tag}: non-finite")
    kern, plain0, top = errs[0]
    worst = max(e[1] for e in errs)
    bound = max(LOGIT_RTOL * top, worst)
    print(f"[{tag}] max|logits - fp32 plain| {kern:.4e} (bf16 plain "
          f"{plain0:.4e}, its worst over {len(errs)} realizations "
          f"{worst:.4e}); bound {bound:.4e} (the larger of that and "
          f"{LOGIT_RTOL} x max|ref| {LOGIT_RTOL * top:.4e})", flush=True)
    require(kern <= bound, f"{tag}: logits disagree with the plain path")
    return evals


def orders_phase(dev, model=MODEL, batch=64, grad_batch=16, steps=10,
                 rank=16, routes=ORDER_ROUTES, overrides=None, timed=True,
                 cli=True) -> dict:
    """CP orders 2, 3 and 5 and the materialized delta, at ``model``'s
    full width and depth, rank ``rank``, weight dropout 0.1, bf16: for
    each of ``routes`` (impl, order, delta form, check) one step's
    gradients of every leaf on ``grad_batch`` images against the fp32
    plain path (:func:`grad_check`), then ``steps`` steps on one batch of
    ``batch`` (the loss falls by the means of the two halves, ms a step
    by CUDA events, peak memory),
    the kernels of the route launched (the element route's at orders 3 /
    5, the rank route's at 5; only the attention's for the dense deltas
    of order 2 and the materialized form, whose products are matmuls),
    and the eval forward at ``batch`` against fp32 plain
    (:func:`eval_check`).  Order 4's element step, unchecked, is timed beside them.
    Then ``python -m cara_tpu_torch.cli.dim_experiment --synthetic --dims
    5 --ranks 32`` in a child at 4 layers, preempted by SIGTERM after its
    first step and relaunched to its end.  Returns the launches of the
    kernels of the element route at orders 3 and 5 (rows 7, 8, 11, 14),
    the rank route's (rows 10, 12, 13) and the eval's (rows 5, 9)."""
    over = dict(overrides or {})
    got = {}
    ms = {}
    for impl, order, delta, check in routes:
        dense = order == 2 or delta == "materialized"
        tag = f"[orders:{impl}:order {order}:{delta}]"
        cfg, cc, frozen, state, data = train_setup(
            dev, model=model, rank=rank, batch=batch, impl=impl,
            cp_order=order, delta_impl=delta, **over)
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        if check:
            grad_check(dev, cfg, cc, frozen, state,
                       {k: v[:grad_batch] for k, v in data.items()},
                       generator, tag=tag)
        reset_launches()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        state, losses, step_ms, _ = fixed_batch_steps(
            cfg, cc, frozen, state, data, generator, steps, timed=timed)
        peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                if dev.type == "cuda" else float("nan"))
        launched = read_launches(tuple(KERNELS))
        half = len(losses) // 2
        print(f"{tag} loss over {steps} steps: "
              + " ".join(f"{v:.4f}" for v in losses), flush=True)
        require(all(np.isfinite(losses)) and statistics.mean(
            losses[half:]) < statistics.mean(losses[:half]),
            f"{tag} the loss did not fall (the means of the halves)")
        if timed:
            ms[(impl, order, delta)] = statistics.median(step_ms[3:])
            print(f"{tag} median {ms[(impl, order, delta)]:.3f} ms per step "
                  f"(CUDA events, steps 4-{steps}, batch {batch}); peak "
                  f"{peak:.3f} GiB allocated", flush=True)
        path = (DENSE_DELTA_KERNELS if dense else
                TRAINING_KERNELS if impl == "element" else SPLIT_KERNELS)
        idle = ADAPTER_KERNELS if dense else ()
        print(f"{tag} kernel launches: "
              f"{ {k: v for k, v in launched.items() if v} }", flush=True)
        for name in path:
            require(launched[name] > 0, f"{tag} {name} never launched")
        for name in idle:
            require(launched[name] == 0, f"{tag} {name} launched")
        if check and not dense:
            _add_launches(got, launched, path)
        evals = eval_check(dev, cfg, cc, frozen, state, data,
                           f"orders:eval:order {order}:{delta}")
        if not dense:
            require(min(evals.values()) > 0, f"{tag} eval: {evals}")
            _add_launches(got, evals, tuple(evals))
        del cfg, cc, frozen, state, data
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if timed and ("element", 4, "factorized") in ms:
        base = ms[("element", 4, "factorized")]
        print("[orders] ms per step against order 4's element step "
              f"({base:.3f}): " + "; ".join(
                  f"{i}:{o}:{d} {v:.3f} ({v / base:.2f}x)"
                  for (i, o, d), v in ms.items()), flush=True)
    if cli:
        with tempfile.TemporaryDirectory() as tmp:
            resume = os.path.join(tmp, "resume")
            argv = ["--synthetic", "--dataset", "patch_camelyon", "--model",
                    model, "--dims", "5", "--ranks", "32", "--epochs", "2",
                    "--batch-size", "32", "--eval-batch-size", "64",
                    "--synthetic-size", "128", "--log-every", "1",
                    "--backbone", os.path.join(tmp, "none.npz"),
                    "--out-dir", tmp, "--resume-dir", resume,
                    "--device", str(dev), "--model-override",
                    f"depth={over.get('depth', 4)}"]
            for key, value in over.items():
                if key != "depth":
                    argv += ["--model-override", f"{key}={value}"]
            t0 = time.perf_counter()
            lines, _, _ = _resume_child(argv, "", sigterm=True,
                                        cli="dim_cli")
            pre = [l for l in lines if l.startswith("Preempted (SIGTERM)")]
            require(len(pre) == 1, "the dim_experiment child was not "
                    "preempted")
            k = int(pre[0].split("at step ")[1].split()[0])
            t1 = time.perf_counter()
            lines, launches, _ = _resume_child(argv, "", cli="dim_cli")
            resumed = [l for l in lines
                       if l.startswith("[cara_tpu] resumed from")]
            acc = [l for l in lines if l.startswith("Accuracy:")]
            ckpts = sorted(f for f in os.listdir(tmp) if f.endswith(".npz"))
            print(f"[orders:dim_experiment] --dims 5 --ranks 32, 4 layers: "
                  f"preempted at step {k} after {t1 - t0:.1f} s; relaunch "
                  f"{time.perf_counter() - t1:.1f} s: {resumed}, {acc}, "
                  f"checkpoints {ckpts}", flush=True)
            require(len(resumed) == 1 and f"step {k} " in resumed[0],
                    "the dim_experiment relaunch did not resume")
            require(len(acc) == 1 and len(ckpts) == 1,
                    "the dim_experiment relaunch kept no checkpoint")
            for name in TRAINING_KERNELS:
                require(launches[name] > 0, f"{name} never launched by "
                        "the dim_experiment child")
    return got


def rank_kernel_phase(dev, timed: bool = True, r: int = RANK_WIDE) -> dict:
    """The entries of ``RANK_FORMS``: rows 3-15 and 19 at ViT-B's shapes
    (B 64, N 197) and rank ``r``, each against its fp32 plain version and
    timed beside it (bound from :func:`kernel_work`, which counts the
    true rank), and the fold's keep pattern at that rank."""
    inp = kernel_inputs(dev, r=r, seed=r)
    print(f"[kernel] the rank-dependent rows at rank {r} (B {inp['b']}, N "
          f"{inp['n']}, E {inp['e']}):", flush=True)
    wd_keep_check(dev, inp)
    calls = {**kernel_calls(inp), **attn_route_kernel_calls(inp),
             **long_kernel_calls(inp)}
    work = kernel_work(inp)
    lib = library_calls(inp) if timed else {}
    pair = f"block_pair_fwd_r{r}"
    forms = {k: b for k, b in RANK_FORMS.items() if k != pair}
    out = check_entries(
        dev, inp, {k: calls[b] for k, b in forms.items()}, timed,
        work={k: work[b] for k, b in forms.items()},
        library={k: lib[b] for k, b in forms.items() if b in lib})
    del calls
    out.update(pair_kernel_phase(dev, inp, timed, name=pair))
    return out


def _rank_launches(total, tag) -> None:
    """Add this run's launches of the ``RANK_FORMS`` entries to
    ``total`` (every counter was set to 0 before the run)."""
    got = read_launches(tuple(RANK_FORMS))
    print(f"{tag} launches of the rank-{RANK_WIDE} entries: "
          f"{ {k: v for k, v in got.items() if v} }", flush=True)
    _add_launches(total, got, tuple(RANK_FORMS))


def _device_ms_per_step(cfg, cara_cfg, frozen, state, data, generator,
                        steps=2, tag=None, top=5, native=False, **step_kw):
    """The kernels' device time a train step on one batch (one step
    unprofiled, then ``steps`` under ``torch.profiler``), summed over
    every CUDA kernel the profiler records; with ``tag`` the ``top``
    kernels by device time are printed.  ``native``: return (total, the
    share of PyTorch's own ``at::native`` kernels: elementwise ops,
    reductions, copies).  ``step_kw`` go to ``make_train_step``."""
    from torch.profiler import ProfilerActivity, profile

    step_fn = steps_lib.make_train_step(cfg, cara_cfg,
                                        compute_dtype=torch.bfloat16,
                                        **step_kw)
    frozen_c = steps_lib.cast_floating(frozen, torch.bfloat16)
    state, _ = step_fn(state, frozen_c, data, generator=generator)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = step_fn(state, frozen_c, data, generator=generator)
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3 / steps, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.key.startswith("Optimizer.")), reverse=True)
    if tag:
        for ms, name in rows[:top]:
            print(f"{tag} {ms:8.3f} ms a step  {name[:90]}", flush=True)
    total = sum(ms for ms, _ in rows)
    if native:
        return total, sum(ms for ms, name in rows if "at::native" in name)
    return total


def ranks_phase(dev, rank=RANK_WIDE, batch=64, grad_batch=16,
                steps=6, switch_steps=2, cli_rank=96, cli_depth=4,
                timed=True) -> dict:
    """Past rank 64: ViT-B/16 at full width and depth, rank ``rank``,
    scale 10, batch ``batch``, bf16.  (a) The element and rank routes:
    one step's gradients of every leaf on ``grad_batch`` images against
    the fp32 plain path (:func:`grad_check`, the perturbed copies only
    where a leaf misses 5e-2), ``steps`` steps on one batch (the loss
    falls by the means of the halves; ms a step by CUDA events with the
    spread; peak memory), each kernel of the route launched.  (b) The
    rank route under ``CARA_ATTN_MEGA=1`` and under ``CARA_ATTNPROJ=1``:
    the gradient check and ``switch_steps`` steps, the switch's kernels
    launched and the split attention's not.  (Since PR 22 the smoke no
    longer times rank 8 in turns here, for its time limit: ``peft_phase``
    times CaRA rank 8, ``tools/compare_parent.py`` any two trees.)  (c) A
    rank-``rank`` checkpoint served unmerged by ``Predictor`` (img/s on
    the host clock) and its eval with every block through row 19, both
    within ``LOGIT_RTOL`` of the fp32 plain forward.  (d) ``cli.vit_cp
    --synthetic --dim cli_rank`` at ``cli_depth`` layers in a child.
    Returns the launches of the ``RANK_FORMS`` entries over (a), (b) and
    (c)."""
    launches = {}
    setups = {}
    paths = {"element": TRAINING_KERNELS + ("grad_gemm_nt_dgelu_h",
                                            SAVE_PRE_SITE),
             "rank": SPLIT_KERNELS + (SAVE_PRE_SITE,)}
    for impl, path in paths.items():
        tag = f"[ranks:{impl}:r{rank}]"
        cfg, cc, frozen, state, data = train_setup(dev, rank=rank,
                                                   batch=batch, impl=impl)
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
        grad_check(dev, cfg, cc, frozen, state,
                   {k: v[:grad_batch] for k, v in data.items()}, generator,
                   tag=tag, lazy=True)
        reset_launches()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        state, losses, ms, _ = fixed_batch_steps(
            cfg, cc, frozen, state, data, generator, steps, timed=timed)
        peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                if dev.type == "cuda" else float("nan"))
        got = read_launches(tuple(KERNELS))
        half = len(losses) // 2
        print(f"{tag} loss over {steps} steps: "
              + " ".join(f"{v:.4f}" for v in losses), flush=True)
        require(all(np.isfinite(losses)) and statistics.mean(
            losses[half:]) < statistics.mean(losses[:half]),
            f"{tag} the loss did not fall (the means of the halves)")
        if timed:
            tail = ms[2:]
            print(f"{tag} median {statistics.median(tail):.3f} ms per step "
                  f"(CUDA events, steps 3-{steps}: {min(tail):.3f}-"
                  f"{max(tail):.3f}), batch {batch}; peak {peak:.3f} GiB "
                  "allocated", flush=True)
        for name in path:
            require(got[name] > 0, f"{tag} {name} never launched")
        if impl == "element":
            require(wd_fold.MASKED_LAUNCHES > 0,
                    f"{tag} the masked factor gradients never launched")
        _rank_launches(launches, tag)
        setups[impl] = [cfg, cc, frozen, state, data]

    cfg, cc, frozen, state, data = setups["rank"]
    generator = torch.Generator(device=dev)
    generator.manual_seed(1)
    for name in ("CARA_ATTN_MEGA=1", ATTNPROJ):
        values, _, path, idle = SWITCHES[name]
        tag = f"[ranks:rank:{name}:r{rank}]"
        with attn_switch(**values):
            grad_check(dev, cfg, cc, frozen, state,
                       {k: v[:grad_batch] for k, v in data.items()},
                       generator, tag=tag, lazy=True)
            reset_launches()
            state, losses, _, _ = fixed_batch_steps(
                cfg, cc, frozen, state, data, generator, switch_steps,
                timed=False)
            got = read_launches(tuple(KERNELS))
            require(all(np.isfinite(losses)), f"{tag} non-finite loss")
            _rank_launches(launches, tag)
        for k in path:
            require(got[k] > 0, f"{tag} {k} never launched")
        for k in idle:
            require(got[k] == 0, f"{tag} {k} launched")
    del setups, cfg, cc, frozen, state, data
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, f"vit_smoke_r{rank}_seed_0.npz")
        make_checkpoint(ckpt, rank=rank)
        pred = Predictor.from_checkpoint_auto(
            ckpt, MODEL, batch_size=batch, merge=False, device=dev,
            dtype=torch.bfloat16)
        images = make_images(batch, pred.cfg.image_size, seed=21)
        ref = reference_logits(pred, images)
        tol = LOGIT_RTOL * float(np.abs(ref).max())
        for route in ("adapter", "block_pair"):
            tag = f"[ranks:serve:{route}:r{rank}]"
            old = vit_lib._block
            if route == "block_pair":
                vit_lib._block = _pair_block
            try:
                reset_launches()
                got = pred.logits(images)
                _rank_launches(launches, tag)
                counts = read_launches(("cp_attn_block", "cp_mlp_block",
                                        "block_pair_fwd"))
                if timed:
                    iters = 10
                    t0 = time.perf_counter()
                    for _ in range(iters):
                        pred.logits(images)
                    dt = time.perf_counter() - t0
            finally:
                vit_lib._block = old
            err = float(np.abs(got - ref).max())
            print(f"{tag} batch {batch}: max|logits - fp32 plain| "
                  f"{err:.4e}, tolerance {tol:.4e} ({LOGIT_RTOL} x "
                  f"max|ref|); launches "
                  f"{counts}" + (f"; {iters * batch / dt:.1f} img/s "
                                 f"(Predictor.logits, host clock)"
                                 if timed else ""), flush=True)
            require(bool(np.isfinite(got).all()) and err <= tol,
                    f"{tag} logits disagree with the plain path")
            want = (("block_pair_fwd",) if route == "block_pair"
                    else ("cp_attn_block", "cp_mlp_block"))
            for k in want:
                require(counts[k] >= pred.cfg.depth, f"{tag} {k}: {counts}")
        del pred

    if cli_rank:
        with tempfile.TemporaryDirectory() as tmp:
            argv = ["--synthetic", "--dataset", "svhn", "--model", MODEL,
                    "--dim", str(cli_rank), "--epochs", "1",
                    "--batch-size", str(batch), "--eval-batch-size",
                    str(batch), "--synthetic-size", str(2 * batch),
                    "--log-every", "1", "--out-dir", tmp,
                    "--backbone", os.path.join(tmp, "none.npz"),
                    "--device", str(dev), "--model-override",
                    f"depth={cli_depth}"]
            t0 = time.perf_counter()
            child = cli_child(argv, {})
            print(f"[ranks:cli] cli.vit_cp --dim {cli_rank}, {cli_depth} "
                  f"layers: {time.perf_counter() - t0:.1f} s; launches "
                  f"{ {k: v for k, v in child.items() if v} }", flush=True)
            for name in TRAINING_KERNELS:
                require(child[name] > 0, f"{name} never launched by the "
                        f"--dim {cli_rank} child")
    return launches


def _row_diffs(before, after) -> dict:
    """The launches of ``PEFT_ROWS`` between two ``read_launches``."""
    return {f"row {row} {name}": after[name] - before[name]
            for row, name in PEFT_ROWS}


def peft_serving(dev, method, batch=64, n_images=64, iters=20,
                 timed=True, tmp=None, model=MODEL) -> None:
    """A ViT-B checkpoint with a perturbed ``method`` adapter served
    unmerged (rows 5 and 9 a layer) and merged by ``Predictor``: both
    within ``LOGIT_RTOL`` of the fp32 plain forward, img/s of each on the
    host clock."""
    path = os.path.join(tmp, f"vit_{method}_seed_0.npz")
    cfg, cc, _, state, _ = train_setup(
        dev, model=model, method=method, impl="rate0", batch=1,
        scale=PEFT_SCALE,
        fact_core_rank=PEFT_CORE_RANK if method == "fact_tk" else 0)
    params = init_backbone(cfg, 0)
    params["head"] = ckpt_lib.to_numpy_tree(state.trainable["head"])
    save_model(path, params, state.trainable["cara"],
               {**dataclasses.asdict(cc), "model": model})
    images = make_images(n_images, cfg.image_size, seed=23)
    ref = None
    for merge in (False, True):
        tag = f"[peft:serve:{method}:{'merged' if merge else 'adapter'}]"
        pred = Predictor.from_checkpoint_auto(
            path, model, batch_size=batch, merge=merge, device=dev,
            dtype=torch.bfloat16)
        if ref is None:
            ref = reference_logits(pred, images)
        before = read_launches(("cp_attn_block", "cp_mlp_block"))
        got = pred.logits(images)
        after = read_launches(("cp_attn_block", "cp_mlp_block"))
        rate = ""
        if timed:
            t0 = time.perf_counter()
            for _ in range(iters):
                pred.logits(images)
            rate = (f"; {iters * n_images / (time.perf_counter() - t0):.1f}"
                    " img/s (Predictor.logits, host clock)")
        _logit_check(tag[1:-1], got, ref)
        fused = {k: after[k] - before[k] for k in after}
        print(f"{tag} batch {batch}: block megakernel launches {fused}"
              f"{rate}", flush=True)
        for k, v in fused.items():
            require(v == (0 if merge else cfg.depth), f"{tag} {k}: {v}")
        del pred


def peft_multitask(dev, batch=64, n_images=64,
                   tasks=(("a", 2.0, 10), ("b", 8.0, 5)),
                   model=MODEL) -> None:
    """Two LoRA tasks at different scales and class counts over one ViT-B
    backbone (``MultiTaskPredictor``): each task's logits against its
    own single-task unmerged ``Predictor`` (the scale on the config, not
    riding ``scale_override``), within ``LOGIT_RTOL``."""
    cfg = get_model_config(model, num_classes=0)
    params = init_backbone(cfg, 0)
    group = {}
    for i, (name, scale, classes) in enumerate(tasks):
        cc = CaraConfig(method="lora", rank=8, scale=scale,
                        weight_dropout=0.0)
        group[name] = {
            "cara": convert.perturb_adapter(convert.init_cara_params(
                cfg, cc, 40 + i), 50 + i, std=PEFT_STD["lora"]),
            "head": api.linear_init(60 + i, api._head_in_dim(cfg), classes),
            "scale": scale, "cp_order": 4}
    multi = MultiTaskPredictor(params, cfg, group, batch_size=batch,
                               device=dev, dtype=torch.bfloat16)
    images = make_images(n_images, cfg.image_size, seed=24)
    for name, scale, classes in tasks:
        task = group[name]
        single = Predictor(
            dict(params, head=task["head"]),
            dataclasses.replace(cfg, num_classes=classes),
            cara_params=task["cara"],
            cara_cfg=CaraConfig(method="lora", rank=8, scale=scale,
                                weight_dropout=0.0),
            merge=False, batch_size=batch, device=dev, dtype=torch.bfloat16)
        got = multi.logits(images, name)
        require(got.shape == (n_images, classes),
                f"peft:multitask:{name}: shape {got.shape}")
        _logit_check(f"peft:multitask:{name} (scale {scale})", got,
                     single.logits(images), "its single-task Predictor")
        del single


def peft_phase(dev, batch=64, grad_batch=16, steps=6, rounds=1,
               turn_steps=3, cli_depth=4, timed=True, model=MODEL) -> None:
    """LoRA and FacT (TT, TK) at ViT-B/16 full width and depth, rank 8,
    scale ``PEFT_SCALE``, bf16, batch ``batch``, seed 0, through the CaRA
    sites' kernels.  (a) For each method, the element route (weight
    dropout 0.1) and the rate-0 route: on the route of
    ``PEFT_GRAD_ROUTE`` one step's gradients of every leaf on
    ``grad_batch`` images against the fp32 plain path (:func:`grad_check`),
    then ``steps`` steps on one batch (a falling loss; ms a step), with
    the launches of ``PEFT_ROWS`` before and after printed as
    differences and the route's kernels required.  (b) Each route's
    methods and CaRA rank 8 timed in turns (``rounds`` rounds of
    ``turn_steps`` steps, one more dropped a turn, the order reversed
    every other round), then the kernels' device time a step by the
    profiler, with PyTorch's ``at::native`` kernels' share (CaRA's
    collapse runs there).  (c) LoRA and FacT-TK served unmerged and
    merged, and two
    LoRA tasks through ``MultiTaskPredictor``.  (d) ``cli.vit_cp --method
    fact_tk --fact-core-rank 4 --synthetic`` at ``cli_depth`` layers in a
    child, then ``cli.export --mode merged`` on its checkpoint, whose
    merged logits agree with the unmerged ones."""
    setups = {}
    for method in PEFT_METHODS:
        core = PEFT_CORE_RANK if method == "fact_tk" else 0
        for route, path in PEFT_PATHS.items():
            tag = f"[peft:{method}:{route}]"
            setup = list(train_setup(dev, model=model, method=method,
                                     impl=route, batch=batch,
                                     scale=PEFT_SCALE, fact_core_rank=core))
            cfg, cc, frozen, state, data = setup
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
            if route == PEFT_GRAD_ROUTE[method]:
                print(f"{tag} {cc.trainable_param_count(cfg)} adapter "
                      "parameters", flush=True)
                grad_check(dev, cfg, cc, frozen, state,
                           {k: v[:grad_batch] for k, v in data.items()},
                           generator, tag=tag, lazy=True)
            before = read_launches(tuple(KERNELS))
            state, losses, ms, _ = fixed_batch_steps(
                cfg, cc, frozen, state, data, generator, steps, timed=timed)
            after = read_launches(tuple(KERNELS))
            setup[3] = state
            setups[(method, route)] = setup
            half = len(losses) // 2
            print(f"{tag} loss over {steps} steps: "
                  + " ".join(f"{v:.4f}" for v in losses)
                  + (f"; ms a step (CUDA events): "
                     + " ".join(f"{v:.3f}" for v in ms) if timed else ""),
                  flush=True)
            print(f"{tag} launches over the {steps} steps: "
                  f"{_row_diffs(before, after)}", flush=True)
            require(all(np.isfinite(losses)) and statistics.mean(
                losses[half:]) < statistics.mean(losses[:half]),
                f"{tag} the loss did not fall (the means of the halves)")
            for name in path:
                require(after[name] > before[name],
                        f"{tag} {name} never launched")

    if timed:
        generator = torch.Generator(device=dev)
        generator.manual_seed(1)
        for route in PEFT_PATHS:
            setups[("cara", route)] = list(train_setup(
                dev, model=model, rank=8, impl=route, batch=batch))
            keys = [(m, route) for m in PEFT_METHODS + ("cara",)]
            turns = {k: [] for k in keys}
            for rd in range(rounds):
                for key in keys if rd % 2 == 0 else keys[::-1]:
                    c, cc, fr, st, da = setups[key]
                    st, _, ms, _ = fixed_batch_steps(c, cc, fr, st, da,
                                                     generator,
                                                     turn_steps + 1)
                    setups[key][3] = st
                    turns[key] += ms[1:]
            device = {k: _device_ms_per_step(
                *setups[k], generator, tag=f"[peft:{k[0]}:{route}:device]",
                top=3, native=True) for k in keys}
            base_ms = statistics.median(turns[("cara", route)])
            base_dev = device[("cara", route)][0]
            for key in keys:
                med = statistics.median(turns[key])
                dev_ms, native = device[key]
                print(f"[peft:{route}] {key[0]}: ms a step by CUDA events "
                      f"in turns ({rounds} rounds, {len(turns[key])} "
                      f"steps) {med:.3f} ({min(turns[key]):.3f}-"
                      f"{max(turns[key]):.3f}), {med / base_ms:.3f}x CaRA "
                      f"rank 8; device time by the profiler {dev_ms:.3f} "
                      f"ms a step, {dev_ms / base_dev:.3f}x (PyTorch's "
                      f"at::native kernels {native:.3f}, the rest "
                      f"{dev_ms - native:.3f})", flush=True)
            for key in keys:
                setups.pop(key)
    setups.clear()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        for method in ("lora", "fact_tk"):
            peft_serving(dev, method, batch=batch, timed=timed, tmp=tmp,
                         model=model)
        peft_multitask(dev, batch=batch, model=model)
        if not cli_depth:
            return
        out = os.path.join(tmp, "cli")
        argv = ["--synthetic", "--dataset", "patch_camelyon", "--model",
                model, "--method", "fact_tk", "--fact-core-rank",
                str(PEFT_CORE_RANK), "--dim", "8", "--epochs", "1",
                "--batch-size", str(batch), "--eval-batch-size", str(batch),
                "--synthetic-size", str(2 * batch), "--log-every", "1",
                "--out-dir", out, "--backbone", os.path.join(tmp, "none.npz"),
                "--device", str(dev), "--model-override",
                f"depth={cli_depth}"]
        t0 = time.perf_counter()
        child = cli_child(argv, {})
        print(f"[peft:cli] cli.vit_cp --method fact_tk --fact-core-rank "
              f"{PEFT_CORE_RANK}, {cli_depth} layers: "
              f"{time.perf_counter() - t0:.1f} s; launches "
              f"{ {k: v for k, v in child.items() if v} }", flush=True)
        for name in PEFT_PATHS["rate0"]:  # FacT's default rate is 0
            require(child[name] > 0, f"{name} never launched by the "
                    "--method fact_tk child")
        files = [f for f in os.listdir(out) if f.endswith(".npz")]
        require(len(files) == 1, f"the fact_tk child wrote {files}")
        ckpt = os.path.join(out, files[0])
        _, tree, meta = ckpt_lib.load_model(ckpt)
        require(meta.get("method") == "fact_tk"
                and tree["C"].shape == (PEFT_CORE_RANK, 8, 8),
                f"the fact_tk checkpoint records {meta.get('method')}, "
                f"C {tree['C'].shape}")
        merged = os.path.join(tmp, "merged.npz")
        export_cli.main(["--ckpt", ckpt, "--out", merged, "--mode",
                         "merged", "--device", str(dev)])
        kw = dict(batch_size=batch, device=dev, dtype=torch.bfloat16)
        got = Predictor.from_checkpoint_auto(merged, model, **kw)
        images = make_images(batch, got.cfg.image_size, seed=25)
        got = got.logits(images)
        want = Predictor.from_checkpoint_auto(ckpt, model, merge=False,
                                              **kw).logits(images)
        _logit_check("peft:cli: the exported merged checkpoint", got, want,
                     "the unmerged checkpoint")


def _zoo_kw(method) -> dict:
    """``train_setup``'s keywords of a ``ZOO_METHODS`` method: the
    bottleneck width, the default scale (AdaptFormer 0.1, 1.0 else) and
    the adapters' dropout."""
    bottleneck = method in ("adapter", "adaptformer")
    return dict(method=method, rank=ZOO_RANK,
                scale=0.1 if method == "adaptformer" else 1.0,
                adapter_dropout=ZOO_DROP if bottleneck else 0.0)


def zoo_train(dev, method, tag, steps, grad_batch, batch, model=MODEL,
              timed=True, rows=ZOO_ROWS, idle=ADAPTER_KERNELS,
              **kw) -> tuple:
    """One ``ZOO_METHODS`` setup: the gradient check on ``grad_batch``
    images, then ``steps`` steps on one batch (a falling loss, ms a step),
    the launches of ``rows`` required and of ``idle`` refused.  Returns
    (setup, the launches of ``rows`` over the steps)."""
    setup = list(train_setup(dev, model=model, batch=batch,
                             **{**_zoo_kw(method), **kw}))
    cfg, cc, frozen, state, data = setup
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    forms = steps_lib.resolve_impls("auto", "auto", cc)
    print(f"{tag} {cc.trainable_param_count(cfg)} trainable parameters "
          f"(head apart), {cfg.seq_len} + "
          f"{cc.vpt_tokens if method.startswith('vpt') else 0} tokens, "
          f"forms {forms}", flush=True)
    require(forms == ("fused", "xla"), f"{tag} resolved to {forms}")
    # AdaptFormer's ReLU flips its gates where bf16 moves h across 0, on
    # the kernels' path and the plain one alike: its down projection's
    # gradient is 3-13 % off fp32 on both, so its bound takes every
    # perturbed copy.
    grad_check(dev, cfg, cc, frozen, state,
               {k: v[:grad_batch] for k, v in data.items()}, generator,
               tag=tag, lazy=method != "adaptformer")
    before = read_launches(tuple(KERNELS))
    state, losses, ms, _ = fixed_batch_steps(cfg, cc, frozen, state, data,
                                             generator, steps, timed=timed)
    after = read_launches(tuple(KERNELS))
    setup[3] = state
    diffs = {name: after[name] - before[name] for name in after}
    half = len(losses) // 2
    print(f"{tag} loss over {steps} steps: "
          + " ".join(f"{v:.4f}" for v in losses)
          + (f"; ms a step (CUDA events): "
             + " ".join(f"{v:.3f}" for v in ms) if timed else ""),
          flush=True)
    print(f"{tag} launches over the {steps} steps: "
          f"{ {k: v for k, v in diffs.items() if v} }", flush=True)
    require(all(np.isfinite(losses)) and statistics.mean(
        losses[half:]) < statistics.mean(losses[:half]),
        f"{tag} the loss did not fall (the means of the halves)")
    for _, name in rows:
        require(diffs[name] > 0, f"{tag} {name} never launched")
    for name in idle:
        require(diffs[name] == 0, f"{tag} {name} launched")
    return setup, {name: diffs[name] for _, name in rows}


def zoo_serving(dev, setup, tmp, batch=64, n_images=64, iters=10,
                timed=True, model=MODEL) -> str:
    """The setup's trees saved as a checkpoint and served by
    ``Predictor.from_checkpoint_auto``: unmerged, and with ``merge=True``
    (SSF and BitFit fold; VPT and the bottleneck adapters stay unmerged),
    each within ``LOGIT_RTOL`` of the unmerged fp32 plain forward, row 1
    launched and no CaRA site; img/s on the host clock.  SSF's unmerged
    ``quantize="int8"`` forward with ``CARA_INT8_PALLAS=1`` launches row
    18 4 x depth times within ``QUANT_BOUNDS``.  Returns the path."""
    cfg, cc, _, state, _ = setup
    method = cc.method
    path = os.path.join(tmp, f"vit_{method}_seed_0.npz")
    params = init_backbone(cfg, 0)
    params["head"] = ckpt_lib.to_numpy_tree(state.trainable["head"])
    save_model(path, params, ckpt_lib.to_numpy_tree(state.trainable["cara"]),
               {**dataclasses.asdict(cc), "model": model})
    images = make_images(n_images, cfg.image_size, seed=26)
    kw = dict(batch_size=batch, device=dev, dtype=torch.bfloat16)
    ref = got_unmerged = None
    for merge in (False, True):
        tag = f"[zoo:serve:{method}:{'merged' if merge else 'adapter'}]"
        pred = Predictor.from_checkpoint_auto(path, model, merge=merge, **kw)
        folds = method in ("ssf", "bitfit")
        require((pred._cara is None) == (merge and folds),
                f"{tag} merged {pred._cara is None}")
        if ref is None:
            ref = reference_logits(pred, images)
        before = read_launches(tuple(KERNELS))
        got = pred.logits(images)
        after = read_launches(tuple(KERNELS))
        diffs = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        rate = ""
        if timed:
            t0 = time.perf_counter()
            for _ in range(iters):
                pred.logits(images)
            rate = (f"; {iters * n_images / (time.perf_counter() - t0):.1f}"
                    " img/s (Predictor.logits, host clock)")
        _logit_check(tag[1:-1], got, ref, "the unmerged fp32 plain forward")
        print(f"{tag} batch {batch}: launches {diffs}{rate}", flush=True)
        require(diffs.get("fused_qkv_attention", 0) == cfg.depth,
                f"{tag} row 1 launched {diffs}")
        require(not set(diffs) & set(ADAPTER_KERNELS),
                f"{tag} a CaRA site launched: {diffs}")
        if not merge:
            got_unmerged = got
        del pred
    if method == "ssf":
        tag = "zoo:serve:ssf:int8:adapter:CARA_INT8_PALLAS=1"
        pred = Predictor.from_checkpoint_auto(path, model, merge=False,
                                              quantize="int8", **kw)
        with int8_switch(True):
            reset_launches()
            got = pred.logits(images)
            count = int8_mod.LAUNCHES
            print(f"[{tag}] row 18 launches a forward {count} (want "
                  f"{4 * cfg.depth})"
                  + (f"; {host_timing(pred, images, batch)}" if timed
                     else ""), flush=True)
        require(count == 4 * cfg.depth, f"{tag}: row 18 launched {count}")
        quant_logit_check(tag, got, got_unmerged, "int8")
        del pred
    return path


def zoo_phase(dev, batch=64, grad_batch=16, steps=6, long_steps=3,
              long_batch=8, turn_steps=3, timed=True, model=MODEL,
              long_model=MODEL_384, long_over=None) -> dict:
    """The PEFT zoo at ViT-B/16 full width and depth, bf16, batch
    ``batch``, seed 0 (``ZOO_METHODS``: VPT-Deep and -Shallow at
    ``ZOO_PROMPTS`` tokens, SSF, BitFit, Houlsby and AdaptFormer at width
    ``ZOO_RANK`` with dropout ``ZOO_DROP``).  (a) Each method: the
    gradient check of every trainable leaf on ``grad_batch`` images, then
    ``steps`` steps (:func:`zoo_train`: rows 1 and 2 launched, no CaRA
    site).  (b) The methods and CaRA rank 8 (element route) timed in
    turns, ``turn_steps`` steps each (one more dropped), then the kernels'
    device time a step by the profiler.  (c) Each method served
    (:func:`zoo_serving`; SSF also int8 with row 18), SSF's checkpoint
    exported merged by ``cli.export`` (the merged checkpoint served
    against the unmerged one) and VPT's refused.  (d) VPT-Deep at
    ``ZOO_LONG_PROMPTS`` prompts (397 tokens) and at 384 px (585 tokens:
    the blockwise attention, row 16, and not rows 1 and 2; ``long_model``
    with ``long_over`` its config's overrides): the gradient check and
    ``long_steps`` steps on ``long_batch`` images.  Returns the launches
    of the ``ZOO_FORMS`` entries."""
    launches = {}
    setups = {}
    for method in ZOO_METHODS:
        setup, rows = zoo_train(dev, method, f"[zoo:{method}]", steps,
                                grad_batch, batch, model=model, timed=timed)
        setups[method] = setup
        if method == "vpt_deep":
            launches["fused_qkv_attention_205"] = rows["fused_qkv_attention"]
            launches["fused_qkv_attention_bwd_205"] = rows[
                "fused_qkv_attention_bwd"]
    if timed:
        generator = torch.Generator(device=dev)
        generator.manual_seed(1)
        setups["cara"] = list(train_setup(dev, model=model, rank=8,
                                          batch=batch))
        turns = {k: [] for k in setups}
        for key, (c, cc, fr, st, da) in setups.items():
            st, _, ms, _ = fixed_batch_steps(c, cc, fr, st, da, generator,
                                             turn_steps + 1)
            setups[key][3] = st
            turns[key] += ms[1:]
        device = {k: _device_ms_per_step(*setups[k], generator,
                                         tag=f"[zoo:{k}:device]", top=3,
                                         native=True) for k in setups}
        base_ms = statistics.median(turns["cara"])
        base_dev = device["cara"][0]
        for key in setups:
            med = statistics.median(turns[key])
            dev_ms, native = device[key]
            print(f"[zoo] {key}: ms a step by CUDA events in turns "
                  f"({len(turns[key])} steps) {med:.3f} "
                  f"({min(turns[key]):.3f}-{max(turns[key]):.3f}), "
                  f"{med / base_ms:.3f}x CaRA rank 8 (element); device "
                  f"time by the profiler {dev_ms:.3f} ms a step, "
                  f"{dev_ms / base_dev:.3f}x (PyTorch's at::native "
                  f"kernels {native:.3f}, the rest {dev_ms - native:.3f})",
                  flush=True)
        setups.pop("cara")
    with tempfile.TemporaryDirectory() as tmp:
        ckpts = {m: zoo_serving(dev, setups.pop(m), tmp, batch=batch,
                                timed=timed, model=model)
                 for m in ZOO_METHODS}
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        merged = os.path.join(tmp, "merged.npz")
        export_cli.main(["--ckpt", ckpts["ssf"], "--out", merged, "--mode",
                         "merged", "--device", str(dev)])
        kw = dict(batch_size=batch, device=dev, dtype=torch.bfloat16)
        got = Predictor.from_checkpoint_auto(merged, model, **kw)
        images = make_images(batch, got.cfg.image_size, seed=27)
        got = got.logits(images)
        want = Predictor.from_checkpoint_auto(ckpts["ssf"], model,
                                              merge=False,
                                              **kw).logits(images)
        _logit_check("zoo:export: the exported merged SSF checkpoint", got,
                     want, "the unmerged checkpoint")
        try:
            export_cli.main(["--ckpt", ckpts["vpt_deep"], "--out", merged,
                             "--mode", "merged", "--device", str(dev)])
        except SystemExit as exc:
            print(f"[zoo:export] VPT refused: {exc}", flush=True)
            require("cannot fold" in str(exc), f"VPT export: {exc}")
        else:
            require(False, "cli.export merged a VPT checkpoint")
    _, rows = zoo_train(dev, "vpt_deep", "[zoo:vpt_deep:P200]", long_steps,
                        long_batch, long_batch, model=model, timed=timed,
                        vpt_tokens=ZOO_LONG_PROMPTS)
    launches["fused_qkv_attention_397"] = rows["fused_qkv_attention"]
    launches["fused_qkv_attention_bwd_397"] = rows["fused_qkv_attention_bwd"]
    long_rows = tuple(("16", name) for name in BLOCKWISE_KERNELS)
    zoo_train(dev, "vpt_deep", "[zoo:vpt_deep:384]", long_steps, long_batch,
              long_batch, model=long_model, timed=timed, rows=long_rows,
              idle=ADAPTER_KERNELS + SHORT_ATTENTION_KERNELS,
              **(long_over or {}))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return launches


def _only(names) -> tuple:
    """The ``KERNELS`` entries whose launch counters are none of those of
    ``names``: what must stay idle where only ``names`` launch."""
    keep = {KERNELS[n][:2] for n in names}
    return tuple(k for k in KERNELS if KERNELS[k][:2] not in keep)


def _launched(before, after) -> dict:
    """The counters that grew between two ``read_launches``, each under
    the first of the ``KERNELS`` entries that share it."""
    out, seen = {}, set()
    for k in after:
        counter = KERNELS[k][:2]
        if after[k] > before[k] and counter not in seen:
            out[k] = after[k] - before[k]
        seen.add(counter)
    return out


def moe_serving(dev, setup, tmp, batch=64, n_images=64, iters=10,
                timed=True, model=MODEL) -> str:
    """The trained mixture saved as a checkpoint and served by
    ``Predictor.from_checkpoint_auto(merge=True)``, which keeps it
    unmerged: logits within ``LOGIT_RTOL`` of the fp32 plain forward, row
    1 launched a layer and nothing else, img/s on the host clock; then
    ``merge_cara`` and ``MultiTaskPredictor`` refuse it.  Returns the
    path."""
    cfg, cc, _, state, _ = setup
    tag = "[moe:serve]"
    path = os.path.join(tmp, "vit_moe_seed_0.npz")
    params = init_backbone(cfg, 0)
    params["head"] = ckpt_lib.to_numpy_tree(state.trainable["head"])
    tree = ckpt_lib.to_numpy_tree(state.trainable["cara"])
    save_model(path, params, tree, {**dataclasses.asdict(cc), "model": model})
    images = make_images(n_images, cfg.image_size, seed=28)
    pred = Predictor.from_checkpoint_auto(path, model, merge=True,
                                          batch_size=batch, device=dev,
                                          dtype=torch.bfloat16)
    require(pred._cara is not None and pred._cara_cfg.moe,
            f"{tag} merge=True folded the mixture")
    ref = reference_logits(pred, images)
    before = read_launches(tuple(KERNELS))
    got = pred.logits(images)
    diffs = _launched(before, read_launches(tuple(KERNELS)))
    rate = ""
    if timed:
        t0 = time.perf_counter()
        for _ in range(iters):
            pred.logits(images)
        rate = (f"; {iters * n_images / (time.perf_counter() - t0):.1f} "
                "img/s (Predictor.logits, host clock)")
    _logit_check(tag[1:-1], got, ref)
    print(f"{tag} merge=True served unmerged, batch {batch}: launches "
          f"{diffs}{rate}", flush=True)
    forwards = -(-n_images // batch)
    require(diffs == {"fused_qkv_attention": cfg.depth * forwards},
            f"{tag} launched {diffs}")
    del pred
    for what, call in (
            ("merge_cara", lambda: merge_cara(
                convert.params_from_numpy(params, dev),
                convert.params_from_numpy(tree, dev), cfg, cc)),
            ("MultiTaskPredictor", lambda: MultiTaskPredictor(
                params, cfg, {"a": {"cara": tree, "head": params["head"],
                                    "scale": cc.scale, "cp_order": 4}},
                device=dev))):
        try:
            call()
        except ValueError as exc:
            print(f"{tag} {what} refused: {exc}", flush=True)
            require("MoE" in str(exc), f"{tag} {what}: {exc}")
        else:
            require(False, f"{tag} {what} took a mixture of experts")
    return path


def moe_phase(dev, batch=64, grad_batch=16, steps=6, turn_steps=3,
              rounds=1, cli_depth=4, timed=True, model=MODEL) -> None:
    """CaRA's mixture of experts at ViT-B/16 full width and depth, bf16,
    batch ``batch``, seed 0: ``MOE_EXPERTS`` experts routed top
    ``MOE_TOP_K``, CP order 4, rank 8, scale 10, rank weight dropout 0.1,
    the experts' zero factors and the router's bias perturbed (as CaRA's
    in :func:`train_setup`).  (a) The forms resolve to the fused attention
    and the XLA dense forms ("fused" refused), the gradient check of
    every trainable leaf (router included) on ``grad_batch`` images, then
    ``steps`` steps on one batch: a falling loss (the aux term in it), ms
    a step, img/s, peak memory, rows 1 and 2 launched and no other
    kernel.  (b) Timed in turns with CaRA rank 8 on the rank route (its
    fused sites) and with CaRA at ``dense_impl="xla"`` (the mixture's
    dense forms, so that the expert axis's cost shows): ``rounds`` rounds
    of ``turn_steps`` steps (one more dropped), peak memory, then the
    device time a step by the profiler.  (c) Served
    (:func:`moe_serving`).  (d) ``cli.vit_cp --moe 4,2 --synthetic`` at
    ``cli_depth`` layers in a child, then ``--evaluate`` of its checkpoint
    without ``--moe`` in another: the same accuracy, only rows 1 (and 2
    in training) launched."""
    tag = "[moe]"
    rows = tuple(name for _, name in ZOO_ROWS)
    idle = _only(rows)
    setup = list(train_setup(dev, model=model, rank=8, impl="rank",
                             batch=batch, moe_experts=MOE_EXPERTS,
                             moe_top_k=MOE_TOP_K))
    cfg, cc, frozen, state, data = setup
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    forms = steps_lib.resolve_impls("auto", "auto", cc)
    count = sum(t.numel() for _, t in
                steps_lib.tree_leaves(state.trainable["cara"]))
    print(f"{tag} {MOE_EXPERTS} experts top {MOE_TOP_K}, rank {cc.rank}, "
          f"{count} adapter parameters (router included), forms {forms}, "
          f"remat {steps_lib.resolve_remat('auto', forms[1])}", flush=True)
    require(forms == ("fused", "xla"), f"{tag} resolved to {forms}")
    try:
        steps_lib.resolve_impls("auto", "fused", cc)
    except ValueError as exc:
        print(f"{tag} dense_impl='fused' refused: {exc}", flush=True)
    else:
        require(False, f"{tag} dense_impl='fused' was taken")
    grad_check(dev, cfg, cc, frozen, state,
               {k: v[:grad_batch] for k, v in data.items()}, generator,
               tag=tag, lazy=True)
    if timed:
        torch.cuda.reset_peak_memory_stats(dev)
    before = read_launches(tuple(KERNELS))
    state, losses, ms, wall = fixed_batch_steps(cfg, cc, frozen, state, data,
                                                generator, steps,
                                                timed=timed)
    diffs = _launched(before, read_launches(tuple(KERNELS)))
    setup[3] = state
    half = len(losses) // 2
    print(f"{tag} loss (cross-entropy + {cc.moe_aux_coef} x aux) over "
          f"{steps} steps: " + " ".join(f"{v:.4f}" for v in losses)
          + (f"; ms a step (CUDA events): " + " ".join(f"{v:.3f}" for v in ms)
             + f"; {steps * batch / wall:.1f} img/s (host clock); peak "
             f"{_peak_gib(dev):.3f} GiB" if timed else ""), flush=True)
    print(f"{tag} launches over the {steps} steps: {diffs}", flush=True)
    require(all(np.isfinite(losses)) and statistics.mean(
        losses[half:]) < statistics.mean(losses[:half]),
        f"{tag} the loss did not fall (the means of the halves)")
    for name in rows:
        require(diffs.get(name, 0) > 0, f"{tag} {name} never launched")
    require(not set(diffs) & set(idle), f"{tag} another kernel launched: "
            f"{ {k: v for k, v in diffs.items() if k in idle} }")

    if timed:
        generator.manual_seed(1)
        variants = {
            "moe": (setup, {}),
            "cara": (list(train_setup(dev, model=model, rank=8, impl="rank",
                                      batch=batch)), {}),
            "cara:xla": (list(train_setup(dev, model=model, rank=8,
                                          impl="rank", batch=batch)),
                         {"dense_impl": "xla"})}
        turns = {k: [] for k in variants}
        peaks = {}
        for rd in range(rounds):
            for key in (list(variants) if rd % 2 == 0
                        else list(variants)[::-1]):
                (c, ccv, fr, st, da), kw = variants[key]
                torch.cuda.reset_peak_memory_stats(dev)
                st, _, t_ms, _ = fixed_batch_steps(c, ccv, fr, st, da,
                                                   generator,
                                                   turn_steps + 1, **kw)
                peaks[key] = _peak_gib(dev)
                variants[key][0][3] = st
                turns[key] += t_ms[1:]
        device = {k: _device_ms_per_step(*s, generator,
                                         tag=f"[moe:{k}:device]", top=4,
                                         native=True, **kw)
                  for k, (s, kw) in variants.items()}
        for key in variants:
            med = statistics.median(turns[key])
            dev_ms, native = device[key]
            print(f"[moe] {key}: ms a step by CUDA events in turns "
                  f"({len(turns[key])} steps) {med:.3f} "
                  f"({min(turns[key]):.3f}-{max(turns[key]):.3f}); device "
                  f"time by the profiler {dev_ms:.3f} ms a step (at::native "
                  f"{native:.3f}, the rest {dev_ms - native:.3f}); peak "
                  f"{peaks[key]:.3f} GiB", flush=True)
        moe_ms = statistics.median(turns["moe"])
        for base in ("cara", "cara:xla"):
            print(f"[moe] moe / {base}: events "
                  f"{moe_ms / statistics.median(turns[base]):.3f}x, device "
                  f"{device['moe'][0] / device[base][0]:.3f}x", flush=True)
        del variants
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        moe_serving(dev, setup, tmp, batch=batch, timed=timed, model=model)
        del setup
        if not cli_depth:
            return
        out = os.path.join(tmp, "cli")
        argv = ["--synthetic", "--dataset", "patch_camelyon", "--model",
                model, "--dim", "8", "--epochs", "1",
                "--batch-size", str(batch), "--eval-batch-size", str(batch),
                "--synthetic-size", str(2 * batch), "--log-every", "1",
                "--out-dir", out, "--backbone", os.path.join(tmp, "none.npz"),
                "--device", str(dev), "--model-override",
                f"depth={cli_depth}"]
        t0 = time.perf_counter()
        child = cli_child(argv + ["--moe", f"{MOE_EXPERTS},{MOE_TOP_K}"], {})
        print(f"[moe:cli] cli.vit_cp --moe {MOE_EXPERTS},{MOE_TOP_K}, "
              f"{cli_depth} layers: {time.perf_counter() - t0:.1f} s; "
              f"launches { {k: v for k, v in child.items() if v} }",
              flush=True)
        for name in rows:
            require(child[name] > 0, f"{name} never launched by the --moe "
                    "child")
        require(not any(child[k] for k in idle),
                "the --moe child launched another kernel")
        files = [f for f in os.listdir(out) if f.endswith(".npz")]
        require(len(files) == 1, f"the --moe child wrote {files}")
        ckpt = os.path.join(out, files[0])
        _, tree, meta = ckpt_lib.load_model(ckpt)
        require((meta.get("moe_experts"), meta.get("moe_top_k"))
                == (MOE_EXPERTS, MOE_TOP_K)
                and tree["router"]["kernel"].shape == (cfg.embed_dim,
                                                       MOE_EXPERTS),
                f"the --moe checkpoint records {meta.get('moe_experts')}, "
                f"{meta.get('moe_top_k')}")
        lines = []
        child = cli_child(argv + ["--evaluate", ckpt], {}, out=lines)
        acc = [float(l.split()[-1]) for l in lines
               if l.startswith("Accuracy:")]
        print(f"[moe:cli] --evaluate without --moe: accuracy {acc} (the "
              f"training run's best {meta.get('acc')}); launches "
              f"{ {k: v for k, v in child.items() if v} }", flush=True)
        require(acc == [meta.get("acc")], "--evaluate disagrees with the "
                "training run's accuracy")
        require(child[rows[0]] > 0 and not any(
            child[k] for k in idle + rows[1:]),
            "--evaluate launched another kernel than row 1")


def _forward_profile(fn, tag, iters=5, top=4) -> dict:
    """One forward ``fn()``: ms by CUDA events over ``iters`` calls, then
    the same under ``torch.profiler``: the device time by kernel and the
    busy share (the ``top`` kernels printed).  Returns {kernel name: (ms
    a forward, launches a forward)}."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    with torch.inference_mode():
        run()
        fwd_ms = run()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
    rows = {e.key: (e.self_device_time_total / 1e3 / iters, e.count / iters)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}
    busy = sum(ms for ms, _ in rows.values())
    print(f"{tag} a forward {fwd_ms:.3f} ms by CUDA events, kernels "
          f"{busy:.3f} ms ({100 * busy / fwd_ms:.1f} % busy)", flush=True)
    for key, (ms, count) in sorted(rows.items(), key=lambda kv: -kv[1][0]
                                   )[:top]:
        print(f"{tag} {ms:8.3f} ms {count:6.1f}/forward  {key[:90]}",
              flush=True)
    return rows


def tome_cli_child(ckpt, model, images, r=8, requests=8, extra=()) -> None:
    """``python -m cara_tpu_torch.cli.serve --tome-r r`` in a child:
    ``requests`` PNG posts answered (``/stats``), then SIGTERM; the child
    serves ToMe's forward, which launches none of the port's kernels (the
    merged path would launch the block megakernels, rows 5 and 9).
    ``extra`` adds CLI options (a CPU rehearsal: ``--device cpu``)."""
    code = ("import json, sys, chip_smoke; "
            "from cara_tpu_torch.cli import serve; "
            "serve.main(sys.argv[1:]); "
            "print(json.dumps(chip_smoke.read_launches("
            "tuple(chip_smoke.KERNELS))))")
    argv = ["--ckpt", ckpt, "--model", model, "--tome-r", str(r),
            "--port", "0", "--max-batch", "64", "--max-wait-ms", "20",
            *extra]
    with tempfile.TemporaryFile(mode="w+") as err:
        out, _ = _serve_child(code, argv, err, images, requests,
                              tag=f"tome:serve:cli:r{r}")
        err.seek(0)
        require(out is not None, f"the ToMe serve child failed: "
                f"{err.read()[-2000:]}")
    got = json.loads(out.strip().splitlines()[-1])
    print(f"[tome:serve:cli:r{r}] the child's launches: "
          f"{ {k: v for k, v in got.items() if v} }", flush=True)
    require(not any(got.values()), "the ToMe serve child launched a kernel")


def tome_phase(dev, ckpt, model, images, batch=64, rounds=3, iters=10,
               timed=True, cli_extra=()) -> None:
    """ToMe on the smoke's ViT-B checkpoint, merged, batch ``batch``.
    (a) At each r of ``TOME_RS``, ``tome_forward`` in bf16 (r > 0 through
    ``Predictor(tome_r=r)``) within ``LOGIT_RTOL`` of the port's fp32
    plain ``tome_forward`` at the same r on the same weights; no kernel
    of the port launches (the attention is the plain ``mha``, the GEMMs
    ``F.linear``), and two calls of one batch agree bit for bit.  (b)
    img/s in turns with the merged ``Predictor`` (the block megakernels,
    rows 5 and 9): ``rounds`` rounds of ``iters`` calls, the order
    reversed every other round (host clock); a forward's device time by
    kernel for merged and the largest r.  (c) ``quantize="int8"`` at
    ``TOME_INT8_R`` with ``CARA_INT8_PALLAS=1``: row 18 launches 4 x depth
    times a forward at each layer's shrinking M, within ``QUANT_BOUNDS``
    of the bf16 ToMe forward, bit for bit on a second call; its device
    time a launch, and row 18's entries at the last layer's M of each r
    against their fp32 plain versions, bound and library (printed, not
    entries of the ``kernels`` line).  (d) ``cli.serve --tome-r 8`` in a
    child answers requests (``cli_extra`` its added options)."""
    x = images[:batch]
    kw = dict(batch_size=batch, device=dev, dtype=torch.bfloat16)
    merged = Predictor.from_checkpoint_auto(ckpt, model, **kw)
    cfg = merged.cfg
    params32 = convert.map_floating(merged._params, lambda t: t.float())
    xt = torch.from_numpy(x).to(dev)
    preds = {"merged": merged}
    logits = {}
    for r in TOME_RS:
        tag = f"[tome:r{r}]"
        with torch.inference_mode():
            ref = tome_lib.tome_forward(params32, xt, cfg, r, impl="plain")
        ref = ref.float().cpu().numpy()
        if r:
            pred = Predictor.from_checkpoint_auto(ckpt, model, tome_r=r, **kw)
            require(pred._cara is None and pred.tome_r == r,
                    f"{tag} the Predictor did not merge")
            preds[f"tome r{r}"] = pred

            def call(p=pred):
                return p.logits(x)
        else:
            def call():
                with torch.inference_mode():
                    return tome_lib.tome_forward(
                        merged._params, xt.to(torch.bfloat16), cfg,
                        0).float().cpu().numpy()
        before = read_launches(tuple(KERNELS))
        got = call()
        diffs = _launched(before, read_launches(tuple(KERNELS)))
        again = call()
        counts = tome_lib.token_counts(cfg, r)
        print(f"{tag} tokens entering each layer {counts}, "
              f"{counts[-1] - tome_lib.merge_schedule(cfg, r)[-1]} leave "
              f"the last; launches {diffs}; two calls bit for bit "
              f"{np.array_equal(got, again)}", flush=True)
        _logit_check(f"tome:r{r}", got, ref, "fp32 plain tome_forward")
        require(not diffs, f"{tag} launched {diffs}")
        require(np.array_equal(got, again), f"{tag} two calls differ")
        logits[r] = got
    if timed:
        rates = {k: [] for k in preds}
        for rd in range(rounds + 1):  # round 0 warms up
            for name in (list(preds) if rd % 2 == 0 else list(preds)[::-1]):
                t0 = time.perf_counter()
                for _ in range(iters):
                    preds[name].logits(x)
                if rd:
                    rates[name].append(iters * batch
                                       / (time.perf_counter() - t0))
        base = statistics.median(rates["merged"])
        for name, got in rates.items():
            med = statistics.median(got)
            print(f"[tome] {name}: {med:.1f} img/s at batch {batch} (median "
                  f"of {rounds} turns of {iters} calls, host clock; "
                  f"{', '.join(f'{v:.1f}' for v in got)}), "
                  f"{med / base:.3f}x merged", flush=True)
        xb = xt.to(torch.bfloat16)
        _forward_profile(lambda: vit_forward(merged._params, xb, cfg),
                         "[tome:merged:device]")
        r = TOME_RS[-1]
        _forward_profile(lambda: tome_lib.tome_forward(
            merged._params, xb, cfg, r), f"[tome:r{r}:device]")
    del preds

    tag = f"tome:int8:r{TOME_INT8_R}:CARA_INT8_PALLAS=1"
    q = Predictor.from_checkpoint_auto(ckpt, model, quantize="int8",
                                       tome_r=TOME_INT8_R, **kw)
    with int8_switch(True):
        reset_launches()
        got = q.logits(x)
        count = int8_mod.LAUNCHES
        again = q.logits(x)
        print(f"[{tag}] row 18 launches a forward {count} (want "
              f"{4 * cfg.depth}); two calls bit for bit "
              f"{np.array_equal(got, again)}"
              + (f"; {host_timing(q, images, batch)}" if timed else ""),
              flush=True)
        require(count == 4 * cfg.depth, f"{tag}: row 18 launched {count}")
        require(np.array_equal(got, again), f"{tag}: two calls differ")
        quant_logit_check(tag, got, logits[TOME_INT8_R], "int8")
        if timed:
            rows = _forward_profile(lambda: tome_lib.tome_forward(
                q._params, xt.to(torch.bfloat16), cfg, TOME_INT8_R),
                f"[{tag}:device]")
            counts = tome_lib.token_counts(cfg, TOME_INT8_R)
            for key, (ms, n) in rows.items():
                if "int8" in key:
                    print(f"[{tag}:device] {key[:60]}: {ms / n:.4f} ms a "
                          f"launch ({n:.0f} a forward, M from "
                          f"{batch * counts[0]} down to "
                          f"{batch * counts[-1]})", flush=True)
    del q
    shapes = {}
    for r in TOME_RS[1:]:  # the last layer: qkv before its merge, fc2 after
        n = tome_lib.token_counts(cfg, r)[-1]
        shapes[f"_tome_r{r}"] = (batch * n, cfg.embed_dim, 3 * cfg.embed_dim)
        shapes[f"_tome_r{r}_fc2"] = (
            batch * (n - tome_lib.merge_schedule(cfg, r)[-1]),
            cfg.hidden_dim, cfg.embed_dim)
    int8_kernel_phase(dev, timed=timed, shapes=shapes)
    tome_cli_child(ckpt, model, images, extra=cli_extra)


def to_hf_clip(params, cfg) -> dict:
    """``params`` (a CLIP tower in the port's layout) as a HuggingFace
    ``CLIPVisionModelWithProjection`` state dict (torch tensors), the
    inverse of ``models.clip_import``; HF's patch embedding has no bias."""
    e, p = cfg.embed_dim, cfg.patch_size
    vm = "vision_model."
    b = params["blocks"]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    sd = {vm + "embeddings.class_embedding": t(params["cls"].reshape(e)),
          vm + "embeddings.patch_embedding.weight": t(
              params["embed"]["kernel"].reshape(p, p, cfg.in_chans, e)
              .transpose(3, 2, 0, 1)),
          vm + "embeddings.position_embedding.weight": t(
              params["pos_embed"][0]),
          vm + "pre_layrnorm.weight": t(params["ln_pre"]["scale"]),
          vm + "pre_layrnorm.bias": t(params["ln_pre"]["bias"]),
          vm + "post_layernorm.weight": t(params["norm"]["scale"]),
          vm + "post_layernorm.bias": t(params["norm"]["bias"]),
          "visual_projection.weight": t(params["proj_out"]["kernel"].T)}
    for i in range(cfg.depth):
        pre = vm + f"encoder.layers.{i}."
        qw, qb = b["qkv"]["kernel"][i].T, b["qkv"]["bias"][i]
        for j, n in enumerate(("q", "k", "v")):
            sd[pre + f"self_attn.{n}_proj.weight"] = t(qw[j * e:(j + 1) * e])
            sd[pre + f"self_attn.{n}_proj.bias"] = t(qb[j * e:(j + 1) * e])
        for ours, theirs in (("proj", "self_attn.out_proj"),
                             ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            sd[pre + theirs + ".weight"] = t(b[ours]["kernel"][i].T)
            sd[pre + theirs + ".bias"] = t(b[ours]["bias"][i])
        for n, key in (("1", "ln1"), ("2", "ln2")):
            sd[pre + f"layer_norm{n}.weight"] = t(b[key + "_scale"][i])
            sd[pre + f"layer_norm{n}.bias"] = t(b[key + "_bias"][i])
    return sd


def clip_import_phase(dev, tmp, model=MODEL_CLIP, batch=64,
                      overrides=None) -> None:
    """A HuggingFace-layout state dict of ``model`` (CLIP ViT-L/14 at full
    width and depth) written from seed 0 to a ``.bin``, built through
    ``api.build_model(backbone_path=...)`` (``models.clip_import``): the
    imported tower equals the seeded arrays, and merged serving of it
    with a perturbed adapter gives logits within ``LOGIT_RTOL`` of its
    fp32 plain forward."""
    over = dict(overrides or {})
    cfg = get_model_config(model, num_classes=10, **over)
    src = init_backbone(cfg, 0)
    src["embed"]["bias"] = np.zeros_like(src["embed"]["bias"])
    path = os.path.join(tmp, "clip_vision.bin")
    t0 = time.perf_counter()
    torch.save(to_hf_clip(src, cfg), path)
    t1 = time.perf_counter()
    built = api.build_model(model, rank=8, scale=10.0, num_classes=10,
                            backbone_path=path, model_overrides=over)
    t2 = time.perf_counter()
    want = ckpt_lib.flatten_tree({k: v for k, v in src.items()
                                  if k != "head"})
    have = ckpt_lib.flatten_tree({k: v for k, v in built.params.items()
                                  if k != "head"})
    require(sorted(have) == sorted(want)
            and all(np.array_equal(have[k], want[k]) for k in want),
            "the imported CLIP tower differs from the seeded arrays")
    print(f"[clip:import] {model}: HF state dict written in {t1 - t0:.3f} s "
          f"({os.path.getsize(path) / 2 ** 20:.1f} MiB), built through "
          f"clip_import in {t2 - t1:.3f} s; every array equal", flush=True)
    pred = Predictor(built.params, built.cfg, cara_params=(
        convert.perturb_adapter(built.cara_params, 3)),
        cara_cfg=built.cara_cfg, merge=True, batch_size=batch, device=dev)
    images = make_images(batch, cfg.image_size, seed=12)
    reset_launches()
    got = pred.logits(images)
    _logit_check("clip:import:merged", got, reference_logits(pred, images))
    require(read_launches(("fused_qkv_attention",))["fused_qkv_attention"]
            > 0, "the imported CLIP tower's forward launched no attention")


def interop_phase(dev, ckpt, tmp, model=MODEL) -> None:
    """The reference's ``.pt`` of ``ckpt`` (the resumed run's best
    checkpoint): ``cli.export --mode torch`` writes it
    (``models.torch_export``); ``models.torch_import`` reads back the
    same arrays; ``cli.vit_cp --evaluate X.pt`` in a child (rank and
    order from the file) gives the npz ``--evaluate``'s accuracy on the
    same synthetic split; ``cli.export`` merges the ``.pt`` into the
    arrays of the npz's merged export."""
    params, cara, meta = ckpt_lib.load_model(ckpt)
    cfg = get_model_config(model, num_classes=params["head"]["kernel"].shape[
        -1], **meta.get("model_overrides", {}))
    pt = os.path.join(tmp, "vit_resumed.pt")
    t0 = time.perf_counter()
    export_cli.main(["--ckpt", ckpt, "--out", pt, "--mode", "torch"])
    print(f"[interop] --mode torch: {time.perf_counter() - t0:.3f} s, "
          f"{os.path.getsize(pt) / 2 ** 20:.3f} MiB", flush=True)
    back, back_cara, info = torch_import.load_torch_checkpoint(pt, cfg)
    want = ckpt_lib.flatten_tree({"p": params, "c": cara})
    have = ckpt_lib.flatten_tree({"p": back, "c": back_cara})
    require(sorted(have) == sorted(want)
            and all(np.array_equal(have[k], want[k]) for k in want)
            and info == {"cp_order": meta["cp_order"],
                         "rank": cara["R1"].shape[0]},
            "the .pt does not read back to the checkpoint's arrays")
    argv = resume_args(model, tmp, dev)
    acc_npz = vit_cp_cli.main(argv + ["--evaluate", ckpt])
    t0 = time.perf_counter()
    lines, launches, _ = _resume_child(argv + ["--evaluate", pt], "")
    acc = [float(l.split()[1]) for l in lines if l.startswith("Accuracy:")]
    print(f"[interop] --evaluate X.pt in a child ({time.perf_counter() - t0:.1f}"
          f" s): accuracy {acc}, the npz's {acc_npz}; child launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    require(acc == [acc_npz], "the .pt evaluates to another accuracy")
    for name in ADAPTER_SERVING_KERNELS:
        require(launches[name] > 0, f"{name} never launched evaluating the "
                ".pt")
    merged = os.path.join(tmp, "export_merged_pt.npz")
    export_cli.main(["--ckpt", pt, "--model", model, "--scale",
                     str(meta["scale"]), "--out", merged, "--mode",
                     "merged", "--device", str(dev)])
    a = ckpt_lib.flatten_tree(ckpt_lib.load_model(merged)[0])
    b = ckpt_lib.flatten_tree(ckpt_lib.load_model(
        os.path.join(tmp, "export_merged.npz"))[0])
    require(sorted(a) == sorted(b)
            and all(np.array_equal(a[k], b[k]) for k in b),
            "the .pt's merged export differs from the npz's")
    print("[interop] cli.export of the .pt (merged): the npz's merged "
          "export's arrays, bit for bit", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="only build, then profile the train steps by "
                             "kernel (see the module docs)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def stamp(what):  # the run's time budget, by phase
        print(f"[time] {time.perf_counter() - t_start:.1f} s: {what}",
              flush=True)

    print(nvidia_smi_line(), flush=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    _build.lib()
    info = _build.BUILD_INFO
    print(f"[build] {_build.BUILD_DIR / _build.LIB_NAME}: "
          f"{info['seconds']:.3f} s (cached={info['cached']})", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build] {line.strip()}", flush=True)
    if args.profile:
        # Gradient accumulation and remat first.
        profile_steps(dev, "element", label="4x16",
                      step_kw={"grad_accum": 4})
        for kw, label in (({}, "remat"), ({"remat": False}, "no-remat"),
                          ({"grad_accum": 8}, "remat:8x8")):
            profile_steps(dev, "full", model=MODEL_HUGE, label=label,
                          step_kw=kw)
        for model in (MODEL, MODEL_384, MODEL_CLIP, MODEL_HUGE):
            for impl in ("element", "rank"):
                profile_steps(dev, impl, model=model)
        for method in ("full", "linear"):
            profile_steps(dev, method)
        profile_steps(dev, "full", label="no-remat",
                      step_kw={"remat": False})
        for impl in ("element", "rank"):
            with save_switch("0"):
                profile_steps(dev, impl, label="recompute")
        for impl in ("element", "rank"):
            profile_steps(dev, impl, overrides=DROPOUT)
        for name, (values, _, _, _) in SWITCHES.items():
            with attn_switch(**values):
                profile_steps(dev, "rank", label=name)
        profile_serving(dev)
        return 0

    stamp("built")
    results = kernel_phase(dev, kernel_inputs(dev))
    results.update(row2_edge_phase(dev))
    results.update(long_kernel_phase(dev, kernel_inputs(dev, n=577)))
    results.update(flash_kernel_phase(dev, kernel_inputs(dev)))
    results.update(flash_kernel_phase(dev, kernel_inputs(dev, n=577),
                                      suffix="_577"))
    results.update(gelu_kernel_phase(dev, kernel_inputs(dev)))
    results.update(gelu_kernel_phase(dev, kernel_inputs(dev, n=577)))
    results.update(attn_route_kernel_phase(dev, kernel_inputs(dev)))
    results.update(int8_kernel_phase(dev))
    results.update(fold_kernel_phase(dev))
    results.update(pair_kernel_phase(dev, kernel_inputs(dev)))
    results.update(gemm_kernel_phase(dev, kernel_inputs(dev)))
    results.update(site_kernel_phase(dev, kernel_inputs(dev)))
    results.update(quick_kernel_phase(dev, kernel_inputs(
        dev, n=257, e=1024, heads=16, hidden=4096, act="quick_gelu",
        eps=1e-5)))
    results.update(pair_kernel_phase(dev, kernel_inputs(
        dev, act="quick_gelu")))
    for name, (_, n, e, heads, hidden, act, eps) in PAIR_FORMS.items():
        results.update(pair_kernel_phase(dev, kernel_inputs(
            dev, n=n, e=e, heads=heads, hidden=hidden, act=act, eps=eps,
            seed=n + e), name=name))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    results.update(dh_kernel_phase(dev))
    results.update(dh_kernel_phase(dev, forms=ZOO_FORMS))
    results.update(proj_kernel_phase(dev))
    results.update(rank_kernel_phase(dev))
    determinism_phase(dev)

    stamp("kernel entries")
    images = make_images(96, 224)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "vit_smoke_seed_0.npz")
        t0 = time.perf_counter()
        make_checkpoint(ckpt)
        print(f"[serve] checkpoint written in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        reset_launches()
        serving_phase(dev, ckpt, MODEL, images)
        launches = read_launches(SERVING_KERNELS + SITE_SERVING)
        print(f"[serve] kernel launches on the serving path: {launches}; "
              f"fc1 sites with the pre-activation "
              f"{_site.LAUNCHES_GELU_PRE}", flush=True)
        for name, count in launches.items():
            require(count > 0, f"{name} never launched on the serving path")
        require(_site.LAUNCHES_GELU_PRE == 0,
                "serving wrote a saved pre-activation")
        attnproj_eval_check(dev, ckpt, MODEL, images)
        stamp("serving")
        # Quantized serving (row 18) and the whole-block eval (row 19).
        launches["int8_dense"] = quant_serving_phase(dev, ckpt, MODEL,
                                                     images)
        quant_cli_child(ckpt, MODEL, images)
        launches["block_pair_fwd"] = pair_eval_check(dev, ckpt, MODEL,
                                                     images)
        stamp("quantized serving and the whole-block eval")
        # ToMe on the merged checkpoint: bf16, and int8 through row 18.
        tome_phase(dev, ckpt, MODEL, images)
    stamp("ToMe")
    # Three tasks over one backbone: rows 5, 9, 18 and 19 at per-task
    # scales.
    for name, count in multitask_phase(dev).items():
        launches[name] += count
    for suffix in INT8_SHAPES:
        if not suffix.startswith("_huge"):
            launches["int8_dense" + suffix] = launches["int8_dense"]

    stamp("multi-task serving")
    # The default routes run rows 8, 10 and 11 in the saved forms only.
    saved_products = tuple(k for k in GEMM_PRODUCTS
                           if k not in GEMM_RECOMPUTE)
    element_path = TRAINING_KERNELS + saved_products + (SAVE_PRE_SITE,)
    train = training_phase(dev, path=element_path,
                           idle=tuple(SAVED_FORMS) + GEMM_RECOMPUTE)
    launches.update({k: train["launches"][k] for k in element_path})
    split = training_phase(dev, steps=20, impl="rank",
                           path=SPLIT_KERNELS + (SAVE_PRE_SITE,),
                           idle=RANK_RECOMPUTE)
    launches.update({k: split["launches"][k] for k in NEW_SPLIT_KERNELS})
    for n, _ in ROW2_EDGES:
        launches[f"fused_qkv_attention_bwd_{n}"] = launches[
            "fused_qkv_attention_bwd"]
    other_routes_grad_check(dev, split["setup"])
    del split
    stamp("element and rank training")
    # CP orders 2, 3 and 5 and the materialized delta, and the
    # dim_experiment CLI.
    for name, count in orders_phase(dev).items():
        launches[name] = launches.get(name, 0) + count
    stamp("CP orders and dim_experiment")
    # Past rank 64: ViT-B at rank RANK_WIDE on both routes, both
    # switches, unmerged serving and row 19; a --dim 96 CLI child.
    launches.update(ranks_phase(dev))
    stamp(f"rank {RANK_WIDE}")
    # LoRA and FacT (TT, TK) at ViT-B through the CaRA sites' kernels.
    peft_phase(dev)
    stamp("LoRA and FacT")
    # VPT, SSF, BitFit and the bottleneck adapters at ViT-B: the fused
    # attention (rows 1, 2; row 16 at 384 px) and the XLA dense forms.
    launches.update(zoo_phase(dev))
    stamp("the PEFT zoo")
    # CaRA's mixture of experts at ViT-B: the fused attention (rows 1, 2)
    # and the XLA dense forms with the expert axis.
    moe_phase(dev)
    stamp("the mixture of experts")
    # Gradient accumulation (4 x 16 against one pass of 64) and the NaN
    # check on the element route's setup.
    setup = train.pop("setup")
    accum_phase(dev, setup)
    nan_phase(dev, setup)
    del train, setup
    stamp("gradient accumulation and the NaN check")
    # Resume and preemption through the CLI, then export, merged eval and
    # predict on the relaunch's checkpoint.
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = resume_phase(dev, tmp)
        export_phase(dev, ckpt, tmp)
        # The reference's .pt of the same checkpoint.
        interop_phase(dev, ckpt, tmp)
    stamp("resume, the build cache, profiling, export, predict and .pt")
    # The recompute forms of rows 8, 10 and 11, against the saved ones.
    launches.update(recompute_phase(dev))
    stamp("the recompute forms")
    # The rank route's attention-block switches: rows 6, 3 and 4.
    launches.update(switched_rank_phases(dev))
    stamp("the switched rank routes")
    # Activation and attention dropout: row 13's GELU body.
    launches.update(dropout_phase(dev))
    stamp("dropout")
    # CLIP ViT-L/14 at full width and depth: the quick_gelu forms.
    launches.update(clip_phase(dev, overrides={"depth": CLIP_DEPTH}))
    # A HuggingFace-layout CLIP tower (all 24 layers) through the
    # importer.
    with tempfile.TemporaryDirectory() as tmp:
        clip_import_phase(dev, tmp)
    stamp("CLIP ViT-L/14")
    # ViT-H/14 at full width and half its depth: the attention at head
    # width 80.
    launches.update(huge_phase(dev, overrides={"depth": HUGE_DEPTH}))
    stamp("ViT-H/14")
    # Row 3's head-width-64 entries: the ViT-B switched phase's instance.
    for name, (base, _, _, e, heads) in PROJ_FORMS.items():
        if e // heads == 64:
            launches[name] = launches[base]

    # The 384-px route: 577 tokens, past the full-score attention's 512.
    images = make_images(96, 384)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "vit_smoke_384_seed_0.npz")
        make_checkpoint(ckpt, model=MODEL_384)
        reset_launches()
        serving_phase(dev, ckpt, MODEL_384, images, tag="serve:384")
        served = read_launches(tuple(KERNELS))
    print(f"[serve:384] kernel launches on the serving path: "
          f"{ {k: v for k, v in served.items() if v} }", flush=True)
    for name in LONG_SERVING_KERNELS:
        require(served[name] > 0, f"{name} never launched serving 384 px")
    for name in SHORT_ATTENTION_KERNELS:
        require(served[name] == 0, f"{name} launched serving 384 px")
    del images
    for impl, path, recompute in (
            ("element", LONG_ELEMENT_KERNELS,
             ("cp_mlp_block_wd_bwd",) + GEMM_RECOMPUTE),
            ("rank", LONG_SPLIT_KERNELS, RANK_RECOMPUTE)):
        long = training_phase(dev, steps=12, plain_steps=2, model=MODEL_384,
                              impl=impl, path=path + (SAVE_PRE_SITE,),
                              grad_batch=16,
                              idle=SHORT_ATTENTION_KERNELS + recompute)
        if impl == "element":
            launches.update({k: long["launches"][k] for k in LONG_KERNELS})
        del long

    stamp("384 px")
    # The routes without an adapter: full fine-tuning through the flash
    # attention (row 17), the linear probe over the fused one.
    no_flash = ("fused_qkv_attention", "fused_qkv_attention_bwd")
    full = training_phase(dev, steps=20, method="full", lr=1e-4,
                          path=FLASH_KERNELS,
                          idle=no_flash + BLOCKWISE_KERNELS + ADAPTER_KERNELS)
    launches.update({k: full["launches"][k] for k in FLASH_KERNELS})
    remat_phase(dev, full.pop("setup"), 6, "[remat:full]", check_off=True)
    del full
    training_phase(dev, steps=10, plain_steps=2, method="linear",
                   path=no_flash[:1],
                   idle=no_flash[1:] + FLASH_KERNELS + BLOCKWISE_KERNELS
                   + ADAPTER_KERNELS)
    long_full = full_step_577(dev)
    for name in FLASH_KERNELS:
        launches[name + "_577"] = long_full[name]
    # Row 17 at head widths 16 and 32.
    launches.update(narrow_flash_phase(dev))

    stamp("without an adapter")
    kernels = []
    for name, (_, _, src, replaces) in KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        **results[name]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
