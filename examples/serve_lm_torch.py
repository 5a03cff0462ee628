"""Batched serving driver on the PyTorch port: prefill + decode with a
KV (and recurrent-state) cache.

The port's counterpart of ``examples/serve_lm.py``, with the same flags
and ``--device`` (default: the GPU; ``cpu`` runs the plain versions of
the kernels).  Builds a small model with random weights, then serves a
batch of prompts through ``repro_torch.serving.Engine`` (prefill writes
the cache; decode appends one token per step).  Any ``--arch`` the port
builds works at its reduced config: the dense, moe, ssm and hybrid
families.

  PYTHONPATH=src python examples/serve_lm_torch.py
  PYTHONPATH=src python examples/serve_lm_torch.py --arch zamba2-1.2b \\
      --smoke --device cpu
"""

import argparse
import sys
import time
from pathlib import Path

try:
    import repro_torch  # noqa: F401 — installed, or on PYTHONPATH
except ImportError:  # checkout fallback: src/ relative to this file
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import build_model
from repro_torch.serving import Engine, ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="default: the GPU; 'cpu' runs the plain versions "
                         "of the kernels")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    if args.arch:
        cfg = get_config(args.arch, smoke=args.smoke)
    else:
        cfg = ModelConfig(
            arch="serve-demo-20m", family="dense", n_layers=4, d_model=256,
            n_heads=4, n_kv_heads=2, head_dim=64, d_ff=1024,
            vocab_size=4096, remat=False)

    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    engine = Engine(model, params,
                    ServeConfig(max_len=args.prompt_len + args.new_tokens + 8,
                                temperature=args.temperature))

    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)

    t0 = time.perf_counter()
    gen, info = engine.generate(prompts, args.new_tokens)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.arch}: served batch={args.batch} "
          f"prompt={args.prompt_len} new={args.new_tokens} "
          f"in {dt:.2f}s ({args.batch * args.new_tokens / dt:.1f} tok/s) "
          f"on {device}")
    for i in range(min(args.batch, 2)):
        print(f"  seq{i}: {prompts[i].tolist()} -> {gen[i].tolist()}")

    # determinism check: greedy serving must be reproducible
    gen2, _ = engine.generate(prompts, args.new_tokens)
    if args.temperature <= 0 and not np.array_equal(gen, gen2):
        raise RuntimeError("greedy serving gave two different outputs")
    print("serve example done")


if __name__ == "__main__":
    main()
