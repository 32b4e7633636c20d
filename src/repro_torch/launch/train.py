"""Training entry point of the port: the counterpart of ``repro.launch.train``.

Config registry, parameters from a seeded generator, AdamW with a
warmup-cosine schedule, the deterministic synthetic data stream, async
checkpoints and restart, on ONE device: CUDA unless ``--device`` names
another (it raises when CUDA is asked for and absent).  On CUDA the
attention of every layer runs on the hand-written flash-attention
kernels, forward and backward.  The reference's ``--devices`` and
``--mesh-shape`` are left out: the port trains on one card, without a
mesh.

Examples::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --smoke --steps 100 --device cpu --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --steps 6 --batch 2 --seq 2048 --remat full     # on the GPU
"""

import argparse


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ga-steps", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()

    import torch

    from repro_torch.compat import resolve_device
    from repro_torch.configs.registry import ARCHS, SMOKE
    from repro_torch.data.synthetic import Loader, SyntheticLM
    from repro_torch.models.build import build_model
    from repro_torch.optim import adamw
    from repro_torch.parallel.ctx import RunCtx
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    device = resolve_device(args.device)
    cfg = (SMOKE if args.smoke else ARCHS)[args.arch]
    model = build_model(cfg)
    ctx = RunCtx(remat=args.remat)
    opt = adamw.AdamWConfig(
        lr=args.lr,
        weight_decay=0.0,
        schedule=adamw.warmup_cosine(args.lr, max(args.steps // 20, 1),
                                     args.steps),
    )
    tcfg = TrainerConfig(
        steps=args.steps,
        ga_steps=args.ga_steps,
        ckpt_every=args.ckpt_every if args.ckpt_dir else 0,
        ckpt_dir=args.ckpt_dir or None,
        log_every=max(args.steps // 20, 1),
    )
    trainer = Trainer(model, ctx, opt, tcfg)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    start_step, extra = 0, {}
    if args.resume and args.ckpt_dir:
        params, opt_state, start_step, extra = trainer.recover(gen)
        print(f"resumed from step {start_step}")
    else:
        params, opt_state = trainer.init(gen)

    src = SyntheticLM(cfg, batch=args.batch, seq_len=args.seq, seed=args.seed)
    loader = Loader(src, device=device,
                    start_step=int(extra.get("data_step", start_step)))
    try:
        params, opt_state, history = trainer.run(
            params, opt_state, loader, start_step=start_step,
            on_step=lambda s, m: print(
                f"step {s:5d} loss {m['loss']:.4f} "
                f"gnorm {m['grad_norm']:.3f} {m['step_time_s']*1e3:.0f}ms",
                flush=True,
            ),
        )
    finally:
        loader.close()
    print(f"final loss: {history[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
