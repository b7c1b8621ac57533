"""End-to-end training on one card or over a mesh of ranks: the port of
the reference package's ``launch/train.py``.

Wires together: config registry → train state (``train/step.py``) →
deterministic data pipeline (``data/pipeline.py``, optionally DDC-curated
through ``data/curation.py``) → train step → checkpoints
(``train/checkpoint.py``: background writes, atomic publish, ``--resume``
from the latest).  Runs on ``--device`` (``cuda`` by default; it never
falls back to the CPU).  Prints the reference's JSON log line every
``--log-every`` steps, with the device added.

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen3-8b --tiny --steps 50 --batch 8 --seq 128

``--mesh host --mesh-devices N`` (N > 1) trains on N rank processes
(``launch/ranks.py::run_cases``; NCCL when each rank has a card of its
own, gloo when they share one) over the reference's host mesh, N lanes of
``data``, with ``--fsdp`` and ``--compress-grads`` as the reference reads
them; every rank draws the same parameters and batches and keeps its
part.  Rank 0 prints the log (with the backend, and whether collectives
staged through the host) and writes the checkpoints.  ``--mesh
production`` (``--multi-pod``) lays the state out on the (16, 16)
((2, 16, 16)) mesh, which needs 256 (512) ranks: with fewer it raises
``ValueError``, as the reference does short of devices.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


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
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import ranks
    from repro_torch.models import transformer as T

    if args.mesh == "production" or args.multi_pod:
        shape, _ = mesh_mod.production_shape(args.multi_pod)
        need = int(np.prod(shape))
        have = dist.get_world_size() if dist.is_initialized() else 1
        if have != need:
            raise ValueError(f"--mesh production{' --multi-pod' if args.multi_pod else ''}: it "
                             f"lays the state over {shape}, which needs {need} ranks, and "
                             f"{have} run")
        return _train(args, mesh_mod.make_production_mesh(multi_pod=args.multi_pod,
                                                          device=T._device(args.device)),
                      state)
    n = args.mesh_devices or 1
    if n > 1:
        if state is not None:
            raise ValueError("a given state is one process's; --mesh-devices > 1 draws its own")
        T._device(args.device)
        timing: dict = {}
        out = ranks.run_cases([ranks.Case(train_rank, n, (args,))], n, device=args.device,
                              timing=timing)[0]
        return out[0]
    return _train(args, None, state)


def train_rank(rank, group, dev, args):
    """One rank of ``--mesh-devices N``: the host mesh of N ``data`` lanes
    on this rank's device; returns its losses."""
    from repro_torch.launch import mesh as mesh_mod

    args = argparse.Namespace(**{**vars(args), "device": str(dev)})
    return _train(args, mesh_mod.make_host_mesh(group=group, device=dev), None)


def _train(args, mesh, state):
    import torch

    from repro_torch import configs
    from repro_torch.data import curation, pipeline
    from repro_torch.models import transformer as T
    from repro_torch.parallel import api as par
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import step as step_mod

    cfg = configs.get_config(args.arch)
    if args.tiny:
        cfg = cfg.tiny()
    dev = T._device(args.device)
    pctx = par.ParallelCtx(mesh=mesh, fsdp=args.fsdp, remat=args.remat,
                           compress_grads=args.compress_grads)
    root = mesh is None or mesh.rank == 0
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
        if root:
            print(f"[curate] DDC found {res.n_clusters} clusters; "
                  f"exchanged {res.exchanged_fraction:.2%} of embedding bytes")

    if state is None:
        state = step_mod.make_train_state(cfg, tcfg, device=dev, pctx=pctx)
    step_fn = step_mod.build_train_step(cfg, tcfg, pctx)
    where = {"device": str(dev)}
    if mesh is not None:
        where.update(ranks=mesh.size, mesh=mesh.shape, backend=mesh.backend,
                     staged=mesh.staged)

    mgr = None
    start_step = 0
    if args.ckpt_dir:
        mgr = ckpt_mod.CheckpointManager(args.ckpt_dir)
        if args.resume and mgr.latest_step() is not None:
            with par.use(pctx):
                state, manifest = ckpt_mod.restore(args.ckpt_dir, state)
            start_step = int(manifest["step"])
            if root:
                print(f"[ckpt] resumed at step {start_step}")

    it = pipeline.iterate(dcfg, start_step)
    t0 = time.time()
    losses = []
    for i in range(start_step, args.steps):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in next(it).items()}
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if root and ((i + 1) % args.log_every == 0 or i == args.steps - 1):
            dt = time.time() - t0
            print(json.dumps({
                "step": i + 1,
                "loss": round(float(np.mean(losses[-args.log_every:])), 4),
                "gnorm": round(float(metrics["gnorm"]), 3),
                "lr": float(metrics["lr"]),
                "steps_per_s": round((i + 1 - start_step) / dt, 3),
                **where,
            }), flush=True)
        if mgr and (i + 1) % args.ckpt_every == 0:
            with par.use(pctx):
                mgr.save_async(state, i + 1)
    if mgr:
        with par.use(pctx):
            mgr.save(state, args.steps)
        if root:
            print(f"[ckpt] final checkpoint at step {args.steps}")
    return losses


if __name__ == "__main__":
    main()
