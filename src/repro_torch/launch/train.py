"""The end-to-end trainer (counterpart of ``repro.launch.train``).

Wires together the model zoo, the data pipeline, AdamW (+WSD), the
checkpoints, fault-tolerance supervision and (optionally) int8 gradient
compression. It runs on the card unless ``--device cpu`` is passed, with
every attention's forward and backward on the hand-written flash kernels
(``kernels.flash_attention.FlashAttentionFn``):

  python -m repro_torch.launch.train --arch minicpm-2b --steps 6 \\
      --batch 4 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
      --reduced --steps 200 --batch 8 --seq 128 --device cpu \\
      --ckpt-dir /tmp/ckpt

``--model-axis N`` trains on a ("data", "model") mesh
(``launch.mesh.make_local_mesh``) over the ranks of the process group:
one rank started here, or ``torchrun``'s,

  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch minicpm-2b --reduced \\
      --model-axis 2 --device cpu

with the parameters placed by ``runtime.partition.place_model`` (DTensors
with their reference specs' placements; the AdamW moments follow them),
each 'data' rank on its contiguous rows of the global batch, the loss the
global batch's mean, the clipping norm summed over every shard once,
``--grad-compression`` on each gradient's global layout (its int8 blocks
are 1024 elements of the whole flattened leaf), and rank 0 writing the
checkpoint from whole tensors. A resume places the restored tree with
``runtime.fault_tolerance.elastic_remesh``, whatever mesh wrote it.

Differences from the reference, each deliberate: the step runs eagerly
(no ``jit``, no buffer donation; the optimizer updates in place instead);
without ``--model-axis`` it trains on one device with no mesh, the
one-card trainer of earlier slices, and under ``torchrun`` a model axis
must be given; the supervisor builds the reference-layout checkpoint tree
only on a save step; a resumed run continues at the step after the
checkpoint's (the reference repeats the checkpoint's own step, whose
update the checkpoint already holds). Checkpoints
hold the reference's tree (``{"params", "opt"}``, layers stacked), so
either trainer resumes the other's.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs.base import get_arch
from repro_torch.convert import (lm_params_from_reference,
                                 lm_params_to_reference,
                                 opt_state_from_reference,
                                 opt_state_to_reference)
from repro_torch.data.pipeline import DataCfg, TokenPipeline, stub_frames
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.api import build_model
from repro_torch.obs import ranges
from repro_torch.optim import grad_compress
from repro_torch.optim.adamw import (AdamW, AdamWState, clip_scale,
                                     clip_scale_on_mesh, cosine_schedule,
                                     wsd_schedule)
from repro_torch.runtime import partition as PT
from repro_torch.runtime import tp
from repro_torch.runtime.fault_tolerance import (TrainSupervisor,
                                                 elastic_remesh)

STACKED = PT.STACKED

# the spans of one step's phases (``obs.ranges``), for a profiler's split
RANGES = ("train.forward", "train.backward", "train.optimizer")


def make_step(api, opt: AdamW, use_compression: bool,
              mesh=None) -> Callable:
    """``step(params, opt_state, err_state, batch) -> (params, opt_state,
    err_state, metrics)``: the loss, its gradient by
    ``torch.autograd.grad``, compression, clipping at 1.0 and the update,
    in the reference's order. ``params`` is the model, updated in
    place. With a ``mesh`` the model is placed on it (DTensor parameters
    and moments) and ``batch`` holds this rank's rows."""
    def step(params, opt_state, err_state, batch):
        leaves = list(params.parameters())
        with PT.use_mesh(mesh):
            with ranges.span(RANGES[0]):
                loss, _ = api.loss(params, batch)
            with ranges.span(RANGES[1]):
                grads = torch.autograd.grad(loss, leaves)
            with ranges.span(RANGES[2]):
                if mesh is None:
                    if use_compression:
                        grads, err_state = grad_compress.apply(grads,
                                                               err_state)
                    grads, gnorm = clip_scale(grads, 1.0)
                    _, opt_state = opt.update(grads, opt_state, leaves)
                else:
                    opt_state, err_state, gnorm = _update_on_mesh(
                        opt, use_compression, leaves, grads, opt_state,
                        err_state, mesh)
        return params, opt_state, err_state, {"loss": loss.detach(),
                                              "gnorm": gnorm}
    return step


@torch.no_grad()
def _update_on_mesh(opt: AdamW, use_compression: bool, leaves, grads,
                    opt_state: AdamWState, err_state, mesh):
    """The gradients summed into their parameters' placements (a use of a
    parameter leaves its gradient partial over the ranks that computed
    with it), compression on the whole gradients (every rank alike),
    clipping by the norm over every shard, and AdamW on each rank's local
    shards of the parameters and moments, in place."""
    grads = [g if g.placements == p.placements
             else g.redistribute(mesh, p.placements)
             for g, p in zip(grads, leaves)]
    if use_compression:
        whole, err_state = grad_compress.apply(
            [g.full_tensor() for g in grads], err_state)
        local = [tp.local_shard(w, g.placements)
                 for w, g in zip(whole, grads)]
    else:
        local = [g.to_local() for g in grads]
    local, gnorm = clip_scale_on_mesh(
        local, [g.placements for g in grads], mesh, 1.0)
    locs = lambda ts: [t.to_local() for t in ts]          # noqa: E731
    _, new = opt.update(local, AdamWState(locs(opt_state.mu),
                                          locs(opt_state.nu),
                                          opt_state.count), locs(leaves))
    return AdamWState(opt_state.mu, opt_state.nu, new.count), err_state, \
        gnorm


def schedule(kind: str, lr: float, steps: int) -> Callable:
    """The reference's schedules and their warmup / stable / decay
    lengths from the run's step count."""
    if kind == "wsd":
        return wsd_schedule(lr, warmup=max(steps // 20, 5),
                            stable=int(steps * 0.7),
                            decay=max(int(steps * 0.25), 1))
    return cosine_schedule(lr, warmup=max(steps // 20, 5), total=steps)


def make_batch(cfg, pipe: TokenPipeline, step: int, batch: int,
               device, rows: Optional[slice] = None
               ) -> Dict[str, torch.Tensor]:
    """Step ``step``'s batch on ``device``: the pipeline's tokens and
    targets, and a vlm's patches or whisper's frames from the stub
    frontend, in the config's dtype; ``rows`` of the global batch only,
    when given."""
    rows = rows or slice(None)
    out = {k: torch.from_numpy(v[rows]).to(device)
           for k, v in pipe.batch(step).items()}
    if cfg.family in ("vlm", "audio"):
        key, n = (("patches", cfg.n_patches) if cfg.family == "vlm"
                  else ("frames", cfg.encdec.enc_len))
        frames = stub_frames(batch, n, cfg.d_model, step)[rows]
        out[key] = torch.from_numpy(frames).to(device=device,
                                               dtype=cfg.torch_dtype)
    return out


def _rows(mesh, batch: int) -> slice:
    """This rank's contiguous rows of the global batch."""
    with PT.use_mesh(mesh):
        idx, n = tp.batch_split()
    if batch % n:
        raise ValueError(f"train: batch {batch} does not split over {n} "
                         f"data ranks")
    per = batch // n
    return slice(idx * per, (idx + 1) * per)


def main(argv: Optional[List[str]] = None,
         on_step: Optional[Callable[[int, Dict[str, Any]], None]] = None
         ) -> List[float]:
    """Train; returns the logged losses. ``on_step(step, metrics)``, when
    given, runs after every step (instrumentation)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", choices=("cosine", "wsd"), default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=100)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--model-axis", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: --device cuda needs a CUDA device and "
                           "none is available (pass --device cpu)")
    mesh, rank = None, 0
    if args.model_axis is not None:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             0)))
            torch.cuda.set_device(device)
        mesh = make_local_mesh(args.model_axis, device.type)
        rank = dist.get_rank()
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise ValueError("train: several ranks need a mesh; pass "
                         "--model-axis")
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    # minicpm trains with the WSD schedule (arXiv:2404.06395)
    sched_kind = args.schedule or ("wsd" if cfg.arch_id.startswith("minicpm")
                                   else "cosine")
    api = build_model(cfg)
    opt = AdamW(lr=schedule(sched_kind, args.lr, args.steps))

    params = api.init_params(torch.Generator(device).manual_seed(args.seed))
    if mesh is not None:
        PT.place_model(params, cfg, mesh)
    opt_state = opt.init(list(params.parameters()))
    err_state = (grad_compress.init_error(list(params.parameters()))
                 if args.grad_compression else None)
    pipe = TokenPipeline(DataCfg(cfg.vocab, args.seq, args.batch,
                                 seed=args.seed))
    rows = None if mesh is None else _rows(mesh, args.batch)
    step_fn = make_step(api, opt, args.grad_compression, mesh)

    def host_state() -> Dict:
        """The reference-layout tree on the host (on a mesh, a collective
        every rank joins: the shards are gathered whole)."""
        return {"params": lm_params_to_reference(params, cfg),
                "opt": opt_state_to_reference(opt_state, params)}

    sup = None
    start_step = 0
    if args.ckpt_dir:
        ckpt = Checkpointer(args.ckpt_dir)
        if rank == 0:
            sup = TrainSupervisor(ckpt, args.ckpt_dir + "/hb",
                                  save_every=args.save_every)
        if ckpt.latest_step() is not None:
            # the template: the fresh state's structure and dtypes
            restored, saved, _ = ckpt.restore(host_state(),
                                              ckpt.latest_step())
            params, opt_state = _place_restored(restored, cfg, device, mesh)
            start_step = saved + 1
            print(f"[train] resumed from step {saved}; continuing at step "
                  f"{start_step}")

    losses: List[float] = []
    # the rate's clock starts at the first logged step's loss, whose read
    # synchronises: step 0's warm-up stays out of it
    clock = None
    for step in range(start_step, args.steps):
        batch = make_batch(cfg, pipe, step, args.batch, device, rows)
        params, opt_state, err_state, metrics = step_fn(
            params, opt_state, err_state, batch)
        if args.ckpt_dir:
            if mesh is None:
                sup.on_step(step, host_state)
            else:
                # every rank gathers on a save step; rank 0 writes
                due = step > 0 and step % args.save_every == 0
                tree = host_state() if due else None
                if sup is not None:
                    sup.on_step(step, lambda: tree)
        if on_step is not None:
            on_step(step, metrics)
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            losses.append(loss)
            now = time.perf_counter()
            if clock is None:
                clock, rate = (now, step), ""
            else:
                rate = f" ({(now - clock[0]) / (step - clock[1]):.2f}s/step)"
            if rank == 0:
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['gnorm']):.3f}{rate}",
                      flush=True)
    if sup is not None:
        sup.ckpt.wait()
    if losses and rank == 0:
        print(f"[train] done: first loss {losses[0]:.4f} -> last "
              f"{losses[-1]:.4f}")
    return losses


def _place_restored(restored: Dict, cfg, device, mesh):
    """A restored reference-layout tree as the model and its AdamW state:
    on a mesh, placed by ``elastic_remesh`` with the reference's
    parameter specs (the moments as the parameters), then unstacked into
    one module per layer."""
    if mesh is None:
        params = lm_params_from_reference(restored["params"], cfg, device)
        return params, opt_state_from_reference(restored["opt"], params,
                                                device)
    specs = PT.param_specs(restored["params"], STACKED)
    mu, nu, count = restored["opt"]
    params = lm_params_from_reference(
        elastic_remesh(restored["params"], mesh, specs), cfg, device)
    opt = (elastic_remesh(mu, mesh, specs), elastic_remesh(nu, mesh, specs),
           count)
    return params, opt_state_from_reference(opt, params, device)


if __name__ == "__main__":
    main()
