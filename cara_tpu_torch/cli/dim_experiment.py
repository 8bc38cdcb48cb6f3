"""CP-order / rank ablation CLI (port of ``cara_tpu/cli/dim_experiment.py``,
the counterpart of the reference's ``image_classification/dim_experiment.py``).

``--ranks`` (the CP rank) and ``--dims`` (the CP order of the qkv
tensorisation: 2, 3, 4 = the published method, or 5), with the training
CLI's other flags (``cli/common.py``).  The method is fixed to CaRA (the
order axis is CaRA's), and the ablation evaluates every 5 epochs from
epoch 50 (``dim_experiment.py:60``).  Order 2 (and ``--delta-impl
materialized`` at any order) trains on the dense deltas through the XLA
dense forms; orders 3-5 run the factor kernels.  The single-device
features of ``cli.vit_cp`` apply: ``--resume-dir`` / ``--resume-every-steps``
(SIGTERM saves a snapshot and exits), ``--profile-dir``,
``--memory-report``, ``--nan-check``, ``--wandb``, ``--compilation-cache``,
``--grad-accum``, ``--no-remat``.

    python -m cara_tpu_torch.cli.dim_experiment --synthetic --dataset svhn \\
        --ranks 16 --dims 3 [--delta-impl materialized] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from cara_tpu_torch import api
from cara_tpu_torch.cli import common
from cara_tpu_torch.data import vtab as vtab_lib
from cara_tpu_torch.data.vtab_config import get_task_hparams
from cara_tpu_torch.train import checkpoint as ckpt_lib
from cara_tpu_torch.train import loop as loop_lib
from cara_tpu_torch.train import steps as steps_lib
from cara_tpu_torch.utils.logging import MetricLogger

#: The ablation's eval cadence (``dim_experiment.py:60``): every 5 epochs
#: from epoch 50.
EVAL_EVERY, EVAL_START = 5, 50


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--ranks", default=32, type=int,
                   help="Number of trainable ranks (CP rank)")
    p.add_argument("--dims", default=4, type=int, choices=[2, 3, 4, 5],
                   help="Number of CP factors (tensorisation order)")
    common.add_common_args(p)
    args = p.parse_args(argv)
    if args.method != "cara":
        raise SystemExit("--method is fixed to cara here: the CP-order "
                         "ablation (--dims) is CaRA-specific; LoRA has no "
                         "order axis (use cli.vit_cp --method lora)")
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
    torch.manual_seed(seed)

    num_classes = vtab_lib.get_classes_num(args.dataset)
    mo = common.resolve_model_overrides(args)
    model = api.build_model(
        args.model, rank=args.ranks, scale=hp.scale, l_mu=hp.init_mean,
        l_std=hp.init_std, num_classes=num_classes, seed=seed,
        backbone_path=args.backbone, cp_order=args.dims,
        delta_impl=args.delta_impl, weight_dropout=hp.weight_dropout,
        weight_dropout_impl=args.weight_dropout_impl, model_overrides=mo)
    train_loader, eval_loader = vtab_lib.get_data(
        args.dataset, root=args.data_root, evaluate=True,
        batch_size=args.batch_size, eval_batch_size=args.eval_batch_size,
        image_size=model.cfg.image_size, seed=seed, synthetic=args.synthetic,
        synthetic_size=args.synthetic_size)

    print(f"Total parameters: {model.trainable_count}")
    logger = MetricLogger(use_wandb=args.wandb, enabled=True)
    eval_step = steps_lib.make_eval_step(model.cfg, model.cara_cfg,
                                         compute_dtype=dtype,
                                         attn_impl=args.attn_impl,
                                         dense_impl=args.dense_impl)
    frozen, state = steps_lib.init_train_state(
        model.params, model.cara_params, device, args.lr,
        train_loader.steps_per_epoch(), total_epochs=args.epochs)
    keeper = ckpt_lib.BestCheckpointKeeper(args.out_dir, args.dataset, seed)
    fit_cfg = loop_lib.FitConfig(
        epochs=args.epochs, eval_every=EVAL_EVERY, eval_start=EVAL_START,
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
    logger.finish()
    return result["best_acc"]


if __name__ == "__main__":
    main()
