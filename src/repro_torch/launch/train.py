"""Training launcher, the reference's ``launch/train.py`` on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --smoke --steps 50 --batch 8 --seq 128 --device cpu

Runs on the card unless ``--device cpu``; ``--smoke`` selects the reduced
config.  Every family trains: the decoders (attention, MoE, patch prefix:
``--arch paligemma-3b``, whose ``--seq`` counts the patches; the recurrent
mixers: ``--arch recurrentgemma-9b`` or ``xlstm-350m``, whose mLSTM takes
``--seq`` below 64 or a multiple of it) and whisper's encoder-decoder
(``--arch whisper-small``: ``--seq`` decoder tokens over the config's
frames, drawn from the seed by the data pipeline).  The reference's flags,
the mesh ones included: one device is the
only mesh the port trains on (``--data-mesh`` 0 or 1, ``--model-mesh``
1; more is the multi-device slice's).  The AdamW moments follow the
config's ``opt_state_mode``, the learning rate a warmup-cosine schedule.
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticTokenSource, TokenPipeline
from repro_torch.models.lm import Model, check_prefill_len
from repro_torch.optim import AdamWConfig
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data-mesh", type=int, default=0,
                    help="data axis size (0 = all local devices: one)")
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default: the card")
    args = ap.parse_args(argv)
    if args.data_mesh not in (0, 1) or args.model_mesh != 1:
        ap.error("the port trains on one device (--data-mesh 0 or 1, "
                 "--model-mesh 1); meshes are the multi-device slice's")

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    try:
        check_prefill_len(cfg, args.seq)
    except ValueError as e:
        ap.error(str(e))
    model = Model(cfg, device=device)
    n = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} params={n:,} device={device}")

    opt_cfg = AdamWConfig(
        lr=args.lr, state_mode=cfg.opt_state_mode,
        schedule=warmup_cosine(args.lr, args.warmup, args.steps))
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir)
    dcfg = DataConfig(global_batch=args.batch, seq_len=args.seq,
                      seed=args.seed)
    src = SyntheticTokenSource(cfg.vocab, args.seed)

    def pipeline_factory(start_step):
        return TokenPipeline(src, dcfg, device, cfg, start_step=start_step)

    trainer = Trainer(model, opt_cfg, tcfg, pipeline_factory)
    trainer.run(args.seed)
    losses = [m["loss"] for m in trainer.metrics]
    if losses:
        print(f"first loss {losses[0]:.4f} -> last loss {losses[-1]:.4f}")
        print(f"stragglers flagged: {len(trainer.watchdog.events)}")
    return trainer


if __name__ == "__main__":
    main()
