"""End-to-end training on one card: the port of the reference
package's ``launch/train.py``.

Wires together: config registry → train state (``train/step.py``) →
deterministic data pipeline (``data/pipeline.py``, optionally DDC-curated
through ``data/curation.py``) → train step → checkpoints
(``train/checkpoint.py``: background writes, atomic publish, ``--resume``
from the latest).  Runs on ``--device`` (``cuda`` by default; it never
falls back to the CPU).  Prints the reference's JSON log line every
``--log-every`` steps, with the device added.

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen3-8b --tiny --steps 50 --batch 8 --seq 128

The multi-card flags (``--mesh production``, ``--multi-pod``,
``--mesh-devices`` > 1, ``--fsdp``, ``--compress-grads``) raise
``ValueError``: the port drives one card (ROADMAP A10 item 6).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

MULTI_CARD = "needs several cards, which the port does not drive yet (ROADMAP A10 item 6)"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--opt", default="adamw")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default="host", choices=["host", "production"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh-devices", type=int, default=0)
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--remat", default="none")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--curate", action="store_true",
                    help="DDC-curated cluster-balanced sampling")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (never falls back to the CPU)")
    return ap


def main(argv=None):
    return train(parser().parse_args(argv))


def train(args, state=None):
    """Train as the reference's ``main`` does; returns the losses of the
    steps run.  A caller may hand over the initial ``state`` (a
    ``TrainState`` on ``args.device``; a parity check with the
    reference's ``jax.random`` parameters); otherwise it is drawn from
    ``TrainConfig.seed``.  ``--resume`` replaces it with the latest
    checkpoint in ``--ckpt-dir``."""
    import torch

    from repro_torch import configs
    from repro_torch.data import curation, pipeline
    from repro_torch.models import transformer as T
    from repro_torch.parallel import api as par
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import step as step_mod

    for flag, on in (("--mesh production", args.mesh == "production"),
                     ("--multi-pod", args.multi_pod),
                     (f"--mesh-devices {args.mesh_devices}", args.mesh_devices > 1),
                     ("--fsdp", args.fsdp), ("--compress-grads", args.compress_grads)):
        if on:
            raise ValueError(f"{flag} {MULTI_CARD}")

    cfg = configs.get_config(args.arch)
    if args.tiny:
        cfg = cfg.tiny()
    dev = T._device(args.device)
    pctx = par.ParallelCtx(remat=args.remat)
    tcfg = step_mod.TrainConfig(
        opt=opt_mod.OptConfig(name=args.opt, lr=args.lr, decay_steps=max(args.steps, 10)),
        microbatches=args.microbatches,
    )

    dcfg = pipeline.DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed, frontend=cfg.frontend, frontend_seq=cfg.frontend_seq,
        prefix_len=cfg.prefix_len, d_model=cfg.d_model,
    )
    if args.curate:
        emb, doc_clusters = pipeline.doc_embeddings(dcfg, n_docs=4096)
        res = curation.curate(emb)
        dcfg = curation.apply_to_data_config(dcfg, res, doc_clusters)
        print(f"[curate] DDC found {res.n_clusters} clusters; "
              f"exchanged {res.exchanged_fraction:.2%} of embedding bytes")

    if state is None:
        state = step_mod.make_train_state(cfg, tcfg, device=dev)
    step_fn = step_mod.build_train_step(cfg, tcfg, pctx)

    mgr = None
    start_step = 0
    if args.ckpt_dir:
        mgr = ckpt_mod.CheckpointManager(args.ckpt_dir)
        if args.resume and mgr.latest_step() is not None:
            state, manifest = ckpt_mod.restore(args.ckpt_dir, state)
            start_step = int(manifest["step"])
            print(f"[ckpt] resumed at step {start_step}")

    it = pipeline.iterate(dcfg, start_step)
    t0 = time.time()
    losses = []
    for i in range(start_step, args.steps):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in next(it).items()}
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if (i + 1) % args.log_every == 0 or i == args.steps - 1:
            dt = time.time() - t0
            print(json.dumps({
                "step": i + 1,
                "loss": round(float(np.mean(losses[-args.log_every:])), 4),
                "gnorm": round(float(metrics["gnorm"]), 3),
                "lr": float(metrics["lr"]),
                "steps_per_s": round((i + 1 - start_step) / dt, 3),
                "device": str(dev),
            }), flush=True)
        if mgr and (i + 1) % args.ckpt_every == 0:
            mgr.save_async(state, i + 1)
    if mgr:
        mgr.save(state, args.steps)
        print(f"[ckpt] final checkpoint at step {args.steps}")
    return losses


if __name__ == "__main__":
    main()
