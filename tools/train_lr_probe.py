"""The full-width trainer's loss under several AdamW settings, on one
CUDA card: qwen1.5-0.5b at full width and depth, batch 4 x 4096 tokens
(two microbatches), 8 steps of the Markov token stream from the same
random weights for each setting, with the loss of a held-out batch (2 x
4096 tokens) before the first step and after each one.

    python3 tools/train_lr_probe.py

Prints one line a setting: the training batches' losses by step and the
held-out losses.  ``chip_smoke.py``'s trainer takes its lr and warmup
from what this shows (the JAX package's default 100-step warmup moves the
loss by about 1e-3 in 8 steps).
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

SETTINGS = ((3e-4, 100), (3e-4, 1), (1e-3, 1), (1e-3, 8), (3e-3, 8))


def main() -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.largevis import resolve_device, seeded_generator
    from repro_torch.data.synthetic import token_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.models.factory import make_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    dev = resolve_device("cuda")
    cfg = get_config("qwen1.5-0.5b")
    held = token_batch(1, 10_000, 2, 4096, cfg.vocab_size, device=dev)

    def held_loss(params):
        with torch.no_grad():
            return round(float(lm.lm_loss(params, cfg, held["tokens"],
                                          held["labels"], remat=False)), 5)

    for lr, warmup in SETTINGS:
        step = make_train_step(cfg, ShapeConfig("c", "train", 4096, 4),
                               opt_cfg=AdamWConfig(lr=lr,
                                                   warmup_steps=warmup),
                               microbatches=0)
        params = make_model(cfg)["init"](seeded_generator(dev, 0))
        opt = adamw_init(params)
        train, held_out = [], [held_loss(params)]
        for i in range(8):
            batch = token_batch(1, i, 4, 4096, cfg.vocab_size, device=dev)
            params, opt, loss = step(params, opt, batch)
            train.append(round(float(loss), 4))
            held_out.append(held_loss(params))
        print(f"lr {lr} warmup {warmup}: train {train} held {held_out}",
              flush=True)
        del params, opt
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
