"""Training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm_3b \\
        --reduced --device cpu --steps 3

The reference's ``repro.launch.train`` on one device: the same flags
(``--arch``, ``--steps``, ``--batch``, ``--seq``, ``--reduced``,
``--microbatches``, ``--ckpt-dir``, ``--ckpt-every``, ``--lr``,
``--seed``) and the same lines (``step …  loss …  lr …  gnorm …``, then
``done: …`` and ``loss a -> b``), plus ``--device`` (default ``cuda``; with
no card it raises before a line is printed), and no mesh.  ``--reduced``
trains the smoke-scale config; without it the config trains at full size.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.optim.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    trainer = Trainer(
        cfg=cfg, global_batch=args.batch, seq_len=args.seq,
        opt_cfg=AdamWConfig(lr=args.lr, total_steps=args.steps),
        microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, seed=args.seed, device=args.device,
        on_metrics=lambda s, m: print(
            f"step {s:5d}  loss {m.get('loss', float('nan')):.4f}  "
            f"lr {m.get('lr', 0):.2e}  gnorm {m.get('grad_norm', 0):.3f}",
            flush=True))
    result = trainer.run(args.steps)
    print(f"done: {len(result['history'])} log points, "
          f"{result['steps_per_s']:.3f} steps/s")
    first, last = result["history"][0], result["history"][-1]
    print(f"loss {first['loss']:.4f} -> {last['loss']:.4f}")
    return result


if __name__ == "__main__":
    main()
