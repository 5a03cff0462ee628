"""End-to-end LM training on the PyTorch port (fault-tolerant loop, any
dense --arch).

The port's counterpart of ``examples/train_lm.py``, with the same flags
and ``--device`` (default: the GPU; ``cpu`` runs the plain attention).
Default: a ~100M-param dense model on the synthetic token pipeline for
a few hundred steps.  ``--preset quick`` is a short sanity run;
``--arch <id> --smoke`` trains a dense architecture's reduced config.

  PYTHONPATH=src python examples/train_lm_torch.py --preset quick
  PYTHONPATH=src python examples/train_lm_torch.py --steps 300   # ~100M
  PYTHONPATH=src python examples/train_lm_torch.py --arch granite-3-2b \\
      --smoke --device cpu
"""

import argparse
import os
import sys
import tempfile
from pathlib import Path

try:
    import repro_torch  # noqa: F401 — installed, or on PYTHONPATH
except ImportError:  # checkout fallback: src/ relative to this file
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch.configs import get_config
from repro_torch.data.tokens import DataConfig
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import build_model
from repro_torch.models.params import param_count
from repro_torch.train import TrainConfig, Trainer


def lm_100m() -> ModelConfig:
    return ModelConfig(
        arch="repro-100m", family="dense", n_layers=10, d_model=640,
        n_heads=10, n_kv_heads=5, head_dim=64, d_ff=2560,
        vocab_size=32768, rope_theta=1e4, remat=False)


def lm_quick() -> ModelConfig:
    return ModelConfig(
        arch="repro-8m", family="dense", n_layers=4, d_model=256,
        n_heads=4, n_kv_heads=2, head_dim=64, d_ff=1024,
        vocab_size=4096, rope_theta=1e4, remat=False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="assigned arch id")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--preset", default="100m", choices=["100m", "quick"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_example"))
    ap.add_argument("--device", default="cuda",
                    help="default: the GPU; 'cpu' runs the plain versions "
                         "of the kernels")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    if args.arch:
        cfg = get_config(args.arch, smoke=args.smoke)
    elif args.preset == "quick":
        cfg = lm_quick()
        args.steps = min(args.steps, 60)
        args.seq, args.batch = 128, 8
    else:
        cfg = lm_100m()

    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    print(f"arch={cfg.arch} params={param_count(params)/1e6:.1f}M "
          f"steps={args.steps} seq={args.seq} batch={args.batch} "
          f"device={device}")

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch, seed=0)
    train_cfg = TrainConfig(steps=args.steps, lr=6e-4, warmup=20,
                            checkpoint_every=100, log_every=10,
                            checkpoint_dir=args.ckpt)
    trainer = Trainer(model, data_cfg, train_cfg, device=device)
    trainer.install_signal_handler()  # SIGTERM -> checkpoint + clean exit
    out = trainer.run(init_params=params, resume=True)

    losses = [m["loss"] for m in out["metrics"]]
    if losses:
        print(f"loss: first={losses[0]:.4f}  "
              f"min={min(losses):.4f}  last={losses[-1]:.4f}")
    print("train example done")


if __name__ == "__main__":
    main()
