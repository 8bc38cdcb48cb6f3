"""Main train/eval CLI (port of ``cara_tpu/cli/vit_cp.py``): published
order-4 CaRA with exact element-wise weight dropout, or the structured
rank / row weight dropout (``--weight-dropout-impl``), or with ``--moe
X[,K]`` X CaRA experts behind a per-token top-K router (rank weight
dropout, the XLA dense forms); with ``--method
lora`` (``--lora-alpha``) or ``fact_tt`` / ``fact_tk`` (``--fact-scale``,
``--fact-core-rank``) the paper's comparison adapters, through the same
site kernels; with ``--method vpt_deep|vpt_shallow`` (``--vpt-tokens``),
``ssf``, ``bitfit`` or ``adapter|adaptformer`` (``--dim`` the bottleneck
width, ``--adapter-scale``, ``--adapter-dropout``) the other PEFT
baselines, through the fused attention and the XLA dense forms; or, with
``--method linear|full``, the non-adapter control rows: the linear probe
(the head over the frozen backbone) and full fine-tuning (every weight,
through the flash attention).  Activation and attention dropout
(``--model-override dropout_rate=R`` / ``attn_dropout_rate=R``), the
attention (``--attn-impl fused|flash|xla``) and the dense forms
(``--dense-impl fused|xla``) apply to every method, as in JAX.

    python -m cara_tpu_torch.cli.vit_cp --synthetic --dataset svhn \\
        --model vit_base_patch16_224_in21k --dim 8 [--backbone X.npz] \\
        [--weight-dropout-impl rank] [--method full] [--device cpu] \\
        [--model-override dropout_rate=0.1] [--attn-impl xla]

Trains on the card through the port's kernels (bf16 compute, fp32
trainables), evaluates every 10 epochs through the serving kernels (the
flash attention for ``full``) and keeps the best checkpoint as
``vit_{dataset}_{acc}_seed_{seed}.npz`` in ``--out-dir``, a file both
packages' ``load_model`` and serve CLIs read.  ``--evaluate X.npz`` only
evaluates (a checkpoint of ``full`` through the flash attention;
``--merged-eval`` folds the adapter into the dense weights first; a
reference ``.pt`` takes its rank and CP order from the file and its scale
from the task table).  ``--delta-impl materialized`` trains on the dense
deltas (the XLA dense forms, element-wise weight dropout).  On
``--device cpu`` every kernel runs its plain PyTorch version.

The JAX CLI's single-device training features are ported:
``--grad-accum N``, ``--no-remat``, ``--resume-dir`` /
``--resume-every-steps`` (with SIGTERM handling), ``--profile-dir``,
``--memory-report``, ``--nan-check``, ``--wandb`` and
``--compilation-cache`` (the kernel build's directory).
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from cara_tpu_torch import api
from cara_tpu_torch.cli import common
from cara_tpu_torch.config import NO_ADAPTER
from cara_tpu_torch.data import vtab as vtab_lib
from cara_tpu_torch.data.vtab_config import get_task_hparams
from cara_tpu_torch.models.convert import params_from_numpy
from cara_tpu_torch.models import torch_import
from cara_tpu_torch.models.merge import merge_cara
from cara_tpu_torch.train import checkpoint as ckpt_lib
from cara_tpu_torch.train import loop as loop_lib
from cara_tpu_torch.train import steps as steps_lib
from cara_tpu_torch.utils.logging import MetricLogger


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--dim", default=32, type=int,
                   help="Number of trainable ranks (CP rank)")
    p.add_argument("--evaluate", default=None, type=str,
                   help="Checkpoint path: evaluate only, then exit")
    p.add_argument("--merged-eval", action="store_true",
                   help="With --evaluate: fold the adapter into the dense "
                        "weights first (merged-weight inference path)")
    common.add_common_args(p)
    args = p.parse_args(argv)
    common.refuse_unported(args)
    return args


def main(argv=None) -> float:
    args = parse_args(argv)
    common.setup_runtime(args)
    print(args)
    device = common.resolve_device(args.device)
    dtype = common.resolve_dtype(args.dtype)
    hp = get_task_hparams(args.dataset, paper=args.paper_hparams)
    seed = args.seed if args.seed is not None else hp.seed
    print(f"Seed: {seed}")
    torch.manual_seed(seed)

    num_classes = vtab_lib.get_classes_num(args.dataset)
    mo = common.resolve_model_overrides(args)
    scale, weight_dropout = common.adapter_scale_wd(args, hp.scale,
                                                    hp.weight_dropout)
    model = api.build_model(
        args.model, rank=args.dim, scale=scale,
        l_mu=hp.init_mean, l_std=hp.init_std, num_classes=num_classes,
        seed=seed, backbone_path=args.backbone, delta_impl=args.delta_impl,
        weight_dropout=weight_dropout, model_overrides=mo,
        **common.adapter_impl_kwargs(args))
    train_loader, eval_loader = vtab_lib.get_data(
        args.dataset, root=args.data_root, evaluate=True,
        batch_size=args.batch_size, eval_batch_size=args.eval_batch_size,
        image_size=model.cfg.image_size, seed=seed, synthetic=args.synthetic,
        synthetic_size=args.synthetic_size)
    logger = MetricLogger(use_wandb=args.wandb, wandb_kwargs={
        "project": "cara-tpu",
        "name": f"LR__{args.dataset}__{args.lr}-Scale_{hp.scale}"
                f"-Rank_{args.dim}",
    } if args.wandb else None, enabled=True)
    if args.evaluate is not None:
        print("Only evaluation")
        cara_cfg = model.cara_cfg
        if torch_import.is_torch_checkpoint(args.evaluate):
            # A reference .pt: scale and lambda init come from the task
            # table (model.cara_cfg), rank and order from the artifact.
            params, cara_params, info = torch_import.load_torch_checkpoint(
                args.evaluate, model.cfg)
            meta = {}
            if cara_params is not None:
                cara_cfg = dataclasses.replace(
                    cara_cfg, rank=info["rank"], cp_order=info["cp_order"])
        else:
            params, cara_params, meta = ckpt_lib.load_model(args.evaluate)
            if cara_params is not None and "router" in cara_params:
                # a mixture of experts: its routing from the meta (the
                # router's width where it records none), so that --moe
                # need not be repeated at eval
                cara_cfg = dataclasses.replace(
                    cara_cfg,
                    moe_experts=int(meta.get(
                        "moe_experts",
                        cara_params["router"]["kernel"].shape[-1])),
                    moe_top_k=int(meta.get("moe_top_k", 2)),
                    weight_dropout_impl=meta.get("weight_dropout_impl",
                                                 "rank"))
            elif cara_params is not None and "A1" not in cara_params:
                # LoRA / FacT / VPT / SSF / BitFit / bottleneck adapters:
                # method, rank and scale from the artifact, so --method
                # need not be repeated at eval
                cara_cfg = ckpt_lib.infer_cara_cfg(cara_params, meta)
        params = params_from_numpy(params, device, torch.float32)
        if cara_params is not None:
            cara_params = params_from_numpy(cara_params, device,
                                            torch.float32)
        elif meta.get("method") in NO_ADAPTER:
            # the method that wrote it picks the attention (full: flash)
            cara_cfg = dataclasses.replace(
                cara_cfg, method=meta["method"], weight_dropout=0.0)
        if args.merged_eval and cara_params is not None:
            params = merge_cara(params, cara_params, model.cfg, cara_cfg)
            cara_params = None
        eval_step = steps_lib.make_eval_step(
            model.cfg, cara_cfg, compute_dtype=dtype,
            attn_impl=args.attn_impl, dense_impl=args.dense_impl)
        acc = loop_lib.evaluate(eval_step, params, cara_params, eval_loader,
                                device)
        print(f"Accuracy: {acc}")
        return acc

    print(f"Total parameters: {model.trainable_count}")
    eval_step = steps_lib.make_eval_step(model.cfg, model.cara_cfg,
                                         compute_dtype=dtype,
                                         attn_impl=args.attn_impl,
                                         dense_impl=args.dense_impl)
    frozen, state = steps_lib.init_train_state(
        model.params, model.cara_params, device, args.lr,
        train_loader.steps_per_epoch(), total_epochs=args.epochs,
        method=model.cara_cfg.method)
    keeper = ckpt_lib.BestCheckpointKeeper(args.out_dir, args.dataset, seed)
    fit_cfg = loop_lib.FitConfig(
        epochs=args.epochs, eval_every=10, eval_start=1,
        log_every=args.log_every, lambda_telemetry=hp.logger or args.wandb,
        profile_dir=args.profile_dir, memory_report=args.memory_report,
        resume_dir=args.resume_dir,
        resume_every_steps=args.resume_every_steps)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    state, fit_cfg = loop_lib.maybe_resume(args.resume_dir, state, fit_cfg,
                                           generator)
    result = loop_lib.fit(
        cfg=model.cfg, cara_cfg=model.cara_cfg, frozen=frozen, state=state,
        train_loader=train_loader, eval_loader=eval_loader, device=device,
        generator=generator, fit_cfg=fit_cfg, logger=logger, keeper=keeper,
        eval_step=eval_step, compute_dtype=dtype, attn_impl=args.attn_impl,
        dense_impl=args.dense_impl,
        remat=False if args.no_remat else "auto",
        grad_accum=args.grad_accum, nan_check=args.nan_check,
        ckpt_meta={"model": args.model, "dataset": args.dataset,
                   **({"model_overrides": mo} if mo else {})})
    if result["preempted"]:
        hint = (f"relaunch with --resume-dir {args.resume_dir} to continue"
                if args.resume_dir else
                "no --resume-dir was set; optimizer state was NOT saved")
        print(f"Preempted (SIGTERM) at step {result['state'].step} — {hint}")
    print(f"Accuracy: {result['best_acc']}")
    print(f"Throughput: {result['images_per_sec']:.1f} images/sec")
    logger.finish()
    return result["best_acc"]


if __name__ == "__main__":
    main()
