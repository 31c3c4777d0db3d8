"""LM training on one GPU from the command line: the twin of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --shape train_4k [--reduced] [--steps N] [--ckpt DIR] [--batch B] [--device cpu]

Builds the cell (:func:`repro_torch.launch.steps.build_cell`), draws the
parameters with the reference's ``_materialize`` formula (normal times
0.02 / sqrt(fan) + 0.01, fan the leaf's leading dimension) from a
``torch.Generator`` seeded with 0, and zeroes the optimizer state as the
reference's script does (its ``jax.tree.map(zeros_like)`` over the state:
master copy, moments and step). Each step draws its (B, S) tokens and
targets from a numpy generator seeded with 0, integers below 256 (the
reference's ``vocab_hint``: its arch specs carry no ``vocab``), runs one
train step and feeds its time to a ``StragglerDetector``. With ``--ckpt`` an
``AsyncCheckpointer`` saves {"params", "opt_state"} every 100 steps and at
the end, in the reference's layout and bytes; a directory that already
holds a checkpoint is restored first, and the run continues from its step
(the data offset it would skip is printed, as the reference prints it).

Beside the reference's flags it takes ``--device`` (default: the GPU) and
``--batch`` (a cut of the global batch, a multiple of the arch's
micro-batches). The mesh flags take their one-card meaning: ``--host-mesh``
names the 1 x 1 mesh and ``--multi-pod`` the (2, 16, 16) production mesh
instead of (16, 16) (:mod:`repro_torch.launch.mesh`); the mesh is printed
at the start of the log and returned, and the run itself is the same on
one card whichever is named.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.steps import build_cell
from repro_torch.models.transformer import normal_chunked
from repro_torch.train.checkpoint import (AsyncCheckpointer, flatten, latest_step,
                                          restore_checkpoint)
from repro_torch.train.fault_tolerance import StragglerDetector, data_skip_offset

CKPT_EVERY = 100


@torch.no_grad()
def materialize(leaves: dict, opt_state: dict, generator: torch.Generator) -> None:
    """The reference script's start, in place: each floating leaf, in
    order, normal * (0.02 / sqrt(max(fan, 1)) + 0.01) with fan its leading
    dimension (1 for a scalar), drawn from ``generator``; every tensor of
    ``opt_state`` zero."""
    for t in leaves.values():
        fan = t.shape[0] if t.dim() else 1
        scale = 0.02 / max(fan, 1) ** 0.5 + 0.01
        t.copy_(normal_chunked(t.shape, scale, t.dtype, generator, t.device))
    for _, t in flatten(opt_state):
        t.zero_()


@torch.no_grad()
def restore_into(state: dict, directory: str) -> int:
    """Copy the latest checkpoint under ``directory`` into the tensors of
    ``state`` ({"params", "opt_state"}), path by path; returns its step."""
    saved, step = restore_checkpoint(directory, device=next(iter(state["params"].values())).device)
    saved = dict(flatten(saved))
    mine = dict(flatten(state))
    if set(saved) != set(mine):
        raise ValueError(f"the checkpoint's paths differ from the state's: "
                         f"{sorted(set(saved) ^ set(mine))[:4]}")
    for path, t in mine.items():
        t.copy_(saved[path])
    return step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--host-mesh", action="store_true",
                    help="1x1 mesh (CPU smoke); default = production mesh")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args(argv)

    mesh = make_host_mesh() if args.host_mesh else make_production_mesh(multi_pod=args.multi_pod)
    print(f"mesh {mesh.shape} ({mesh.n_devices} devices in the reference's layout); "
          "this run holds the whole cell on one device")
    cell = build_cell(args.arch, args.shape, reduced=args.reduced, device=args.device,
                      batch=args.batch)
    model, opt_state, tokens, _ = cell.args
    dev = model.device
    state = {"params": model.leaves(), "opt_state": opt_state}
    materialize(state["params"], opt_state, torch.Generator(device=dev).manual_seed(0))

    start_step = 0
    ckpt = AsyncCheckpointer(args.ckpt) if args.ckpt else None
    if args.ckpt and latest_step(args.ckpt) is not None:
        start_step = restore_into(state, args.ckpt)
        print(f"restored step {start_step}; data offset "
              f"{data_skip_offset(start_step, tokens.shape[0])}")

    rng = np.random.default_rng(0)
    vocab = getattr(get_arch(args.arch), "vocab", 256)
    straggler = StragglerDetector()
    losses = []
    for step in range(start_step, start_step + args.steps):
        batch = [torch.from_numpy(rng.integers(0, vocab, tokens.shape).astype(np.int32)).to(dev)
                 for _ in range(2)]
        t0 = time.monotonic()
        loss, metrics = cell.fn(model, opt_state, *batch)
        loss, gnorm = float(loss), float(metrics["grad_norm"])  # waits for the step
        dt = time.monotonic() - t0
        straggler.observe(0, dt)
        losses.append(loss)
        print(f"step {step}: loss={loss:.4f} grad_norm={gnorm:.3f} {dt:.2f}s")
        if ckpt and (step + 1) % CKPT_EVERY == 0:
            ckpt.save(step + 1, state)
    if ckpt:
        ckpt.save(start_step + args.steps, state)
        ckpt.wait()
    print("done")
    return {"start_step": start_step, "losses": losses, "flagged": straggler.flagged,
            "mesh": mesh}


if __name__ == "__main__":
    main()
