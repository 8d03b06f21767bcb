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

Differences from the reference, each deliberate: the step runs eagerly
(no ``jit``, no buffer donation; the optimizer updates in place instead);
one card, so ``--model-axis`` must be 1 (partitioning comes with the port
of ``runtime/partition``); the supervisor builds the reference-layout
checkpoint tree only on a save step; and a resumed run continues at the
step after the checkpoint's (the reference repeats the checkpoint's own
step, whose update the checkpoint already holds). Checkpoints hold the
reference's tree (``{"params", "opt"}``, layers stacked), so either
trainer resumes the other's.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs.base import get_arch
from repro_torch.convert import (lm_params_from_reference,
                                 lm_params_to_reference,
                                 opt_state_from_reference,
                                 opt_state_to_reference)
from repro_torch.data.pipeline import DataCfg, TokenPipeline, stub_frames
from repro_torch.models.api import build_model
from repro_torch.optim import grad_compress
from repro_torch.optim.adamw import (AdamW, clip_by_global_norm,
                                     cosine_schedule, wsd_schedule)
from repro_torch.runtime.fault_tolerance import TrainSupervisor

# the record_function ranges of one step, for a profiler's split
RANGES = ("train.forward", "train.backward", "train.optimizer")


def make_step(api, opt: AdamW, use_compression: bool) -> Callable:
    """``step(params, opt_state, err_state, batch) -> (params, opt_state,
    err_state, metrics)``: the loss, its gradient by
    ``torch.autograd.grad``, compression, clipping at 1.0 and the update,
    in the reference's order. ``params`` is the model, updated in
    place."""
    def step(params, opt_state, err_state, batch):
        leaves = list(params.parameters())
        with torch.profiler.record_function(RANGES[0]):
            loss, _ = api.loss(params, batch)
        with torch.profiler.record_function(RANGES[1]):
            grads = torch.autograd.grad(loss, leaves)
        with torch.profiler.record_function(RANGES[2]):
            if use_compression:
                grads, err_state = grad_compress.apply(grads, err_state)
            grads, gnorm = clip_by_global_norm(grads, 1.0)
            _, opt_state = opt.update(grads, opt_state, leaves)
        return params, opt_state, err_state, {"loss": loss.detach(),
                                              "gnorm": gnorm}
    return step


def schedule(kind: str, lr: float, steps: int) -> Callable:
    """The reference's schedules and their warmup / stable / decay
    lengths from the run's step count."""
    if kind == "wsd":
        return wsd_schedule(lr, warmup=max(steps // 20, 5),
                            stable=int(steps * 0.7),
                            decay=max(int(steps * 0.25), 1))
    return cosine_schedule(lr, warmup=max(steps // 20, 5), total=steps)


def make_batch(cfg, pipe: TokenPipeline, step: int, batch: int,
               device) -> Dict[str, torch.Tensor]:
    """Step ``step``'s batch on ``device``: the pipeline's tokens and
    targets, and a vlm's patches or whisper's frames from the stub
    frontend, in the config's dtype."""
    out = {k: torch.from_numpy(v).to(device)
           for k, v in pipe.batch(step).items()}
    if cfg.family in ("vlm", "audio"):
        key, n = (("patches", cfg.n_patches) if cfg.family == "vlm"
                  else ("frames", cfg.encdec.enc_len))
        out[key] = torch.from_numpy(stub_frames(batch, n, cfg.d_model, step)
                                    ).to(device=device, dtype=cfg.torch_dtype)
    return out


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
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.model_axis != 1:
        raise ValueError(f"--model-axis {args.model_axis}: this trainer runs "
                         f"on one card; a model axis comes with the port of "
                         f"runtime/partition")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: --device cuda needs a CUDA device and "
                           "none is available (pass --device cpu)")
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    # minicpm trains with the WSD schedule (arXiv:2404.06395)
    sched_kind = args.schedule or ("wsd" if cfg.arch_id.startswith("minicpm")
                                   else "cosine")
    api = build_model(cfg)
    opt = AdamW(lr=schedule(sched_kind, args.lr, args.steps))

    params = api.init_params(torch.Generator(device).manual_seed(args.seed))
    opt_state = opt.init(list(params.parameters()))
    err_state = (grad_compress.init_error(list(params.parameters()))
                 if args.grad_compression else None)
    pipe = TokenPipeline(DataCfg(cfg.vocab, args.seq, args.batch,
                                 seed=args.seed))
    step_fn = make_step(api, opt, args.grad_compression)

    def host_state() -> Dict:
        return {"params": lm_params_to_reference(params, cfg),
                "opt": opt_state_to_reference(opt_state, params)}

    sup = None
    start_step = 0
    if args.ckpt_dir:
        ckpt = Checkpointer(args.ckpt_dir)
        sup = TrainSupervisor(ckpt, args.ckpt_dir + "/hb",
                              save_every=args.save_every)
        if ckpt.latest_step() is not None:
            # the template: the fresh state's structure and dtypes
            restored, saved, _ = sup.resume_or_init(host_state())
            params = lm_params_from_reference(restored["params"], cfg, device)
            opt_state = opt_state_from_reference(restored["opt"], params,
                                                 device)
            start_step = saved + 1
            print(f"[train] resumed from step {saved}; continuing at step "
                  f"{start_step}")

    losses: List[float] = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = make_batch(cfg, pipe, step, args.batch, device)
        params, opt_state, err_state, metrics = step_fn(
            params, opt_state, err_state, batch)
        if sup is not None:
            sup.on_step(step, host_state)
        if on_step is not None:
            on_step(step, metrics)
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.time() - t0
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['gnorm']):.3f} "
                  f"({dt / max(step - start_step + 1, 1):.2f}s/step)",
                  flush=True)
    if sup is not None:
        sup.ckpt.wait()
    if losses:
        print(f"[train] done: first loss {losses[0]:.4f} -> last "
              f"{losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
