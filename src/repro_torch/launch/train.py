"""Training entry point of the port: the counterpart of ``repro.launch.train``.

Config registry, parameters from a seeded generator, AdamW with a
warmup-cosine schedule, the deterministic synthetic data stream, async
checkpoints and restart, on ONE device: CUDA unless ``--device`` names
another (it raises when CUDA is asked for and absent).  On CUDA the
attention of every layer runs on the hand-written flash-attention
kernels, forward and backward.  ``--mesh-shape`` builds the reference's
mesh (``launch/mesh.py``: ``4,2`` is data=4, model=2; three sizes add
"pod") and its axis roles into the ``RunCtx`` and the ``ShardedLoader``;
on the one device the losses are those of the run without a mesh.  The
reference's ``--devices`` (forced XLA host devices) has no counterpart.

Examples::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --smoke --steps 100 --device cpu --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --smoke --mesh-shape 4,2 --steps 50 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --steps 6 --batch 2 --seq 2048 --remat full     # on the GPU
"""

import argparse

from repro_torch.parallel.ctx import REMAT_POLICIES


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-trainable)")
    ap.add_argument("--mesh-shape", default="",
                    help="e.g. 4,2 -> mesh (data=4, model=2)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ga-steps", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--remat", default="none",
                    choices=REMAT_POLICIES,
                    help="activation recompute policy (parallel/ctx.py)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()

    import torch

    from repro_torch.compat import resolve_device
    from repro_torch.configs.registry import ARCHS, SMOKE
    from repro_torch.data.synthetic import ShardedLoader, SyntheticLM
    from repro_torch.launch.mesh import make_mesh, mesh_axes
    from repro_torch.models.build import build_model
    from repro_torch.optim import adamw
    from repro_torch.parallel.ctx import RunCtx
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    device = resolve_device(args.device)
    cfg = (SMOKE if args.smoke else ARCHS)[args.arch]
    model = build_model(cfg)

    mesh = None
    dp, tp = ("data",), "model"
    if args.mesh_shape:
        shape = tuple(int(x) for x in args.mesh_shape.split(","))
        axes = ("data", "model")[: len(shape)] if len(shape) <= 2 else (
            "pod", "data", "model")
        mesh = make_mesh(shape, axes)
        dp, tp = mesh_axes(mesh)

    ctx = RunCtx(mesh=mesh, dp=dp, tp=tp, remat=args.remat)
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
    loader = ShardedLoader(
        src, mesh=mesh, dp_axes=dp, device=device,
        start_step=int(extra.get("data_step", start_step)),
    )
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
