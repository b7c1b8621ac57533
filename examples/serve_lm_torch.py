"""Batched serving on the PyTorch port (the counterpart of
examples/serve_lm.py): prefill + KV-cache decode over a batch of
requests, with greedy and sampled generation, on ``--device`` (``cuda``
by default; ``cpu`` accepted).

  PYTHONPATH=src python examples/serve_lm_torch.py --requests 8 --gen 32
"""
import argparse

from repro_torch.launch import serve as serve_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return serve_mod.main([
        "--arch", args.arch, "--tiny",
        "--requests", str(args.requests),
        "--prompt-len", "32", "--gen", str(args.gen),
        "--temperature", str(args.temperature),
        "--device", args.device,
    ])


if __name__ == "__main__":
    main()
