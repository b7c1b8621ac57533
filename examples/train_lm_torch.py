"""End-to-end training on the PyTorch port (the counterpart of
examples/train_lm.py): a ~25M-param qwen3-family model (``--hundred-m``
for ~100M) through the port's stack (config → data pipeline → train step
→ checkpoints), on ``--device`` (``cuda`` by default; ``cpu`` accepted).

  PYTHONPATH=src python examples/train_lm_torch.py --steps 20
  PYTHONPATH=src python examples/train_lm_torch.py --hundred-m --steps 300
"""
import argparse
import dataclasses
import os
import sys
import tempfile
import types

from repro_torch import configs
from repro_torch.launch import train as train_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    base = configs.get_config("qwen3-8b")
    if args.hundred_m:
        cfg = dataclasses.replace(
            base, name="qwen3-100m", n_layers=16, d_model=640, n_heads=10,
            n_kv_heads=2, head_dim=64, d_ff=2560, vocab=16384)
    else:
        cfg = dataclasses.replace(
            base, name="qwen3-25m", n_layers=8, d_model=384, n_heads=6,
            n_kv_heads=2, head_dim=64, d_ff=1536, vocab=8192)
    pc = cfg.param_counts()
    print(f"model: {cfg.name} ({pc['total']/1e6:.1f}M params)")

    # Register the reduced config on the fly and drive the real launcher.
    mod_name = "examples_dynamic"
    m = types.ModuleType(mod_name)
    m.CONFIG = cfg
    sys.modules[f"repro_torch.configs.{mod_name}"] = m
    configs.ARCHS[cfg.name] = mod_name

    losses = train_mod.main([
        "--arch", cfg.name, "--steps", str(args.steps), "--batch", "8",
        "--seq", "256", "--lr", "6e-4", "--log-every", "20",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100", "--device", args.device,
    ])
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} over {args.steps} steps")
    return losses


if __name__ == "__main__":
    main()
