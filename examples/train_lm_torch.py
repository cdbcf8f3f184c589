"""Train a ~100M-parameter dense LM on the PyTorch port, with checkpoints
and loss reporting (the counterpart of `examples/train_lm.py`).

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200   # GPU
    PYTHONPATH=src python examples/train_lm_torch.py --steps 2 \\
        --batch 2 --seq 32 --device cpu

The model is the stablelm family cut to 12 layers x 768 (~100 M
parameters, bf16), trained on `data.synthetic`'s stateless batches with
AdamW; --ckpt DIR checkpoints every 50 steps and resumes from the
latest one. It runs on the GPU unless given the CPU, and raises where
CUDA is missing.
"""
import argparse
import dataclasses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default="",
                    help="checkpoint directory (none by default)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    import torch
    from repro_torch.checkpoint import checkpoint as CKPT
    from repro_torch.configs.base import get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.train import device_batch
    from repro_torch.models import model as MODEL
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    device = resolve_device(args.device)
    # ~100M params: stablelm family scaled to 12 layers x 768
    cfg = dataclasses.replace(
        get_config("stablelm-3b"), name="stablelm-100m", n_layers=12,
        d_model=768, n_heads=12, n_kv=12, d_ff=2048, vocab=32000)
    n_params = sum(p.numel() for p in MODEL.param_shapes(cfg).parameters())
    print(f"model: {cfg.name}  params={n_params / 1e6:.1f}M  on {device}")

    ocfg = OptConfig(peak_lr=6e-4, warmup_steps=20, decay_steps=args.steps)
    params = MODEL.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    opt = init_opt_state(params, ocfg)
    step_fn = make_train_step(cfg, ocfg)
    start = 0
    if args.ckpt and CKPT.latest_step(args.ckpt) is not None:
        (params, opt), start, _ = CKPT.restore(args.ckpt, (params, opt))
        print(f"resumed from step {start}")
    losses = []
    for step in range(start, args.steps):
        batch = device_batch(cfg, step, args.batch, args.seq, 0, device)
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"lr {float(m['lr']):.2e}")
        if args.ckpt and (step + 1) % 50 == 0:
            CKPT.save(args.ckpt, step + 1, (params, opt))
    print("done")
    return losses


if __name__ == "__main__":
    main()
