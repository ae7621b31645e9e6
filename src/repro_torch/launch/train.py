"""Training launcher — the end-to-end driver with fault-tolerance wiring.
Port of ``src/repro/launch/train.py``, plus ``--device`` (default
``cuda``: the card; ``cpu`` runs the plain PyTorch path):

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch gemma3-1b --smoke --steps 200 --batch 8 --seq 128

Runs any registered arch (full or --smoke reduced config) on the
available devices, as the reference does: a ``(data, model=1)`` mesh
over every visible card (``launch.mesh.make_host_mesh``), its
``ShardingRules``, the activation pins configured (``actctx``), and the
data-parallel train step over that mesh, one replica of the weights and
moments a card (on the CPU, or on a one-card machine, one device: the
plain step).  With microbatch accumulation, async checkpointing every
--ckpt-every steps (in the reference's layout, one replica, so either
package, and a run on any number of devices, resumes from it),
resume-from-latest, straggler monitoring, and optional int8 gradient
compression.  ``run(args, mesh=...)`` trains over another mesh, such as
``make_host_mesh(data=2, device="cuda:0")``, two batch shards on one
card.
"""

from __future__ import annotations

import argparse
import time
import types

import numpy as np
import torch

from ..configs import get_config, smoke_config
from ..data.pipeline import TokenPipeline
from ..distributed import actctx
from ..distributed.checkpoint import CheckpointManager
from ..distributed.collectives import compress_decompress
from ..distributed.elastic import StragglerMonitor
from ..distributed.sharding import ShardingRules
from ..models.convert import from_reference_state, to_reference_state
from ..models.encdec import EncDec
from ..models.transformer import LM
from ..train import optimizer as opt
from ..train.step import make_train_step
from .mesh import make_host_mesh


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, mesh=None) -> types.SimpleNamespace:
    """Train as ``args`` say, over ``mesh`` — by default the reference
    launcher's: ``data`` = every visible card when ``args.device`` is
    ``cuda``, ``model`` = 1 (one slot on the CPU or a named card);
    returns the model (the replica on the mesh's first device), the
    optimizer state, the step function, the pipeline, the mesh and the
    history (one dict a step: ``step``, ``loss``, ``ms``, and
    ``metrics``, the step's device scalars)."""
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if mesh is None:
        dev = torch.device(args.device)
        every_card = (dev.type == "cuda" and dev.index is None
                      and torch.cuda.is_available())
        mesh = make_host_mesh(
            data=torch.cuda.device_count() if every_card else 1,
            device=args.device)
    rules = ShardingRules(cfg, mesh)
    model = (EncDec if cfg.is_encoder_decoder else LM)(
        cfg, device=mesh.devices.flat[0], seed=0)
    params = dict(model.named_parameters())
    opt_state = opt.init(params)

    ocfg = opt.OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                         total_steps=args.steps)
    # one slot is one device: the plain step is the data-parallel one
    step_fn = make_train_step(
        model, ocfg, accum_steps=args.accum, remat=True,
        grad_transform=compress_decompress if args.compress_grads else None,
        mesh=mesh if mesh.size > 1 else None)

    pipe = TokenPipeline(cfg, args.batch, args.seq)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore()
        sd, ostate = from_reference_state(cfg, state)
        model.load_state_dict(sd)
        opt_state = {"m": {k: t.to(model.device)
                           for k, t in ostate["m"].items()},
                     "v": {k: t.to(model.device)
                           for k, t in ostate["v"].items()},
                     "step": ostate["step"].to(model.device)}
        start = int(state["meta"]["step"])
        print(f"[train] resumed from step {start}")

    def snapshot(step):
        tree = to_reference_state(cfg, params, opt_state)
        tree["meta"] = {"step": np.asarray(step)}
        return tree

    straggler = StragglerMonitor()
    host = "host0"
    history = []
    loss = float("nan")
    t_train0 = time.time()
    with actctx.use(mesh, rules.dp):
        for step in range(start, args.steps):
            batch = pipe.batch_at(step)
            t0 = time.time()
            metrics = step_fn(opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            history.append({"step": step, "loss": loss, "ms": dt * 1e3,
                            "metrics": metrics})
            straggler.record(host, dt)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f} ms")
            if straggler.should_checkpoint_and_rebalance():
                print(f"[train] stragglers detected: "
                      f"{straggler.stragglers()}")
            if ckpt and step and step % args.ckpt_every == 0:
                ckpt.save(step, snapshot(step), blocking=False)
    if ckpt:
        ckpt.save(args.steps, snapshot(args.steps))
        ckpt.wait()
    print(f"[train] done in {time.time()-t_train0:.1f}s; "
          f"final loss {loss:.4f}")
    return types.SimpleNamespace(model=model, opt_state=opt_state,
                                 step_fn=step_fn, pipe=pipe, cfg=cfg,
                                 mesh=mesh, history=history)


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
