"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step with no
data (counterpart of ``repro.launch.dryrun``).

For each cell the step (a train step: the loss, ``torch.autograd.grad``,
clipping and AdamW; ``prefill``; or ``decode_step``) runs once, eagerly,
under ``FakeTensorMode`` — tensors with shapes, dtypes and devices but no
data, so nothing materialises — on rank 0 of torch's fake process group
of 256 (16 x 16) or 512 (2 x 16 x 16) ranks, over the production
``DeviceMesh`` (``launch.mesh.make_production_mesh``). The parameters are
DTensors built from fake local shards with their reference specs'
placements (``runtime.partition``), the AdamW moments are placed by
``zero1_specs`` on the reference's stacked layout (the moment of a layer
stack is one tensor, as in the reference), the batch by ``batch_specs``
and the decode state by ``decode_state_specs``. A step that runs proves
that the distribution is coherent (every shape, placement and collective
of rank 0's program); ``roofline.op_costs.OpCosts`` counts its FLOPs, HBM
bytes, collective bytes and live bytes (the peak proves it fits), and
``roofline.analysis`` turns them into the three roofline terms on the
H100's data-sheet peaks. Every number is modelled, none measured.

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minicpm-2b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
      --out dryrun.json

Differences from the reference, each deliberate: one process traces rank
0's program (JAX's single controller compiles every device's), so costs
are rank 0's times the chips (the reference's are one chip's post-SPMD
HLO times the chips); the record has ``trace_s`` where the reference has
``lower_s``/``compile_s``/``hlo_kb``, and ``--skip-compile`` stops after
the placement (status ``placed``); the step is the port's eager program
(a Python loop over layers, per-layer parameters whose grads are stacked
per reference leaf for the ZeRO-1 update); the fake tensors lie on the
card when there is one, else on the CPU (autograd cannot hold fake CUDA
tensors in a torch built without CUDA), which changes no count. The
flash kernel is counted through its registered operators
(``strela::flash_fwd``/``flash_bwd``/``flash_attn``), never through its
plain version.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeCfg,
                                      all_archs, cell_runnable, get_arch)
from repro_torch.convert import _path
from repro_torch.launch.mesh import compat_make_mesh
from repro_torch.models.api import ModelAPI, build_model
from repro_torch.launch import train
from repro_torch.optim.adamw import (AdamW, AdamWState, clip_scale_on_mesh,
                                     cosine_schedule)
from repro_torch.roofline import analysis as RA
from repro_torch.roofline.op_costs import OpCosts
from repro_torch.runtime import partition as PT
from repro_torch.runtime import tp

STACKED = PT.STACKED


# ---------------------------------------------------------------------------
# parameter counts, on the reference's stacked layout
# ---------------------------------------------------------------------------

def _leaf_sizes(tree) -> Dict[Tuple[str, ...], int]:
    """Each reference leaf's path and element count, a layer stack's
    layers summed, in the order ``jax.tree_util`` flattens the
    reference's tree (keys sorted at every level)."""
    if isinstance(tree, nn.Module):
        named = [(_path(n)[0], p.numel()) for n, p in tree.named_parameters()]
    else:
        named = [(tuple(k.split("/")), v.numel() if hasattr(v, "numel")
                  else v.size) for k, v in PT.tree_paths(tree).items()]
    sizes: Dict[Tuple[str, ...], int] = {}
    for path, n in named:
        sizes[path] = sizes.get(path, 0) + n
    return dict(sorted(sizes.items()))


def count_params(tree) -> float:
    """All parameters of a model (or a tree of shaped leaves)."""
    return float(sum(_leaf_sizes(tree).values()))


def count_active_params(cfg: ArchConfig, tree) -> float:
    """Active parameters per token (MoE: routed experts scaled by k/E),
    summed leaf by leaf in the reference's order."""
    total = 0.0
    for path, n in _leaf_sizes(tree).items():
        frac = 1.0
        if cfg.moe is not None and "w_experts" in "/".join(path):
            frac = cfg.moe.top_k / cfg.moe.n_experts
        total += n * frac
    return total


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

class Group(NamedTuple):
    """One reference leaf: its path, the port parameters it stacks (one
    for an unstacked leaf) and whether it is a layer stack."""
    path: str
    names: Tuple[str, ...]
    stacked: bool


def param_groups(model: nn.Module) -> List[Group]:
    """The model's parameters grouped by reference leaf, layers in
    order, leaves in the reference's order."""
    by: Dict[Tuple[str, ...], List[Tuple[int, str]]] = {}
    for name, _ in model.named_parameters():
        path, layer = _path(name)
        by.setdefault(path, []).append((layer, name))
    return [Group("/".join(path), tuple(n for _, n in sorted(items)),
                  items[0][0] >= 0)
            for path, items in sorted(by.items())]


def _shifted(placements: Sequence, by: int) -> List:
    return [Shard(p.dim + by) if isinstance(p, Shard) else p
            for p in placements]


def _stacked(ts: Sequence[DTensor], stacked: bool) -> DTensor:
    """A group's per-layer DTensors as one DTensor over the stack (their
    local shards stacked, each placement one dim further in)."""
    if not stacked:
        return ts[0]
    t = ts[0]
    shape = (len(ts),) + tuple(t.shape)
    return DTensor.from_local(
        torch.stack([x.to_local() for x in ts]), t.device_mesh,
        _shifted(t.placements, 1), run_check=False, shape=shape,
        stride=tp.contiguous_strides(shape))


def _zero1_update(opt: AdamW, params: Dict[str, nn.Parameter],
                  grads: Dict[str, DTensor], groups: Sequence[Group],
                  opt_state: AdamWState, mesh) -> torch.Tensor:
    """ZeRO-1: each group's gradient reduced into its moments' placements
    (``zero1_specs``: a reduce-scatter over 'data'), clipping by the norm
    over every shard, AdamW on this rank's shards of the parameters and
    moments, and the updated shards gathered back into the parameters'
    placements (an all-gather over 'data'). Returns the global norm."""
    g_loc, p_z = [], []
    for grp, mu in zip(groups, opt_state.mu):
        g = _stacked([grads[n] for n in grp.names], grp.stacked)
        g_loc.append(g.redistribute(mesh, mu.placements).to_local())
        del g
        p = _stacked([params[n] for n in grp.names], grp.stacked)
        p_z.append(p.redistribute(mesh, mu.placements))
    g_loc, gnorm = clip_scale_on_mesh(
        g_loc, [mu.placements for mu in opt_state.mu], mesh, 1.0)
    locs = [p.to_local() for p in p_z]
    opt.update(g_loc, AdamWState([m.to_local() for m in opt_state.mu],
                                 [v.to_local() for v in opt_state.nu],
                                 opt_state.count), locs)
    for grp, p, loc in zip(groups, p_z, locs):
        target = params[grp.names[0]].placements
        back = DTensor.from_local(loc, mesh, p.placements, run_check=False,
                                  shape=p.shape, stride=p.stride())
        whole = back.redistribute(
            mesh, _shifted(target, 1) if grp.stacked else target).to_local()
        parts = whole.unbind(0) if grp.stacked else (whole,)
        for n, part in zip(grp.names, parts):
            params[n].to_local().copy_(part)
    return gnorm


def make_train_step(api: ModelAPI, opt: AdamW, mesh=None,
                    groups: Optional[Sequence[Group]] = None):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the loss, its gradient by ``torch.autograd.grad``, clipping at 1.0 and
    AdamW, in place. Without a mesh it is the trainer's step
    (``launch.train.make_step``); on one, the moments are ZeRO-1
    (:func:`_zero1_update`, one moment per group of ``groups``)."""
    if mesh is None:
        trainer = train.make_step(api, opt, False)

        def step(params, opt_state, batch):
            params, opt_state, _, metrics = trainer(params, opt_state, None,
                                                    batch)
            return params, opt_state, metrics
        return step

    def step(params, opt_state, batch):
        named = dict(params.named_parameters())
        with PT.use_mesh(mesh):
            loss, aux = api.loss(params, batch)
            grads = torch.autograd.grad(loss, list(named.values()))
            with torch.no_grad():
                gnorm = _zero1_update(opt, named, dict(zip(named, grads)),
                                      groups, opt_state, mesh)
        return params, AdamWState(opt_state.mu, opt_state.nu,
                                  opt_state.count + 1), {
            "loss": loss.detach(), "gnorm": gnorm, "aux": aux}
    return step


# ---------------------------------------------------------------------------
# fake placement
# ---------------------------------------------------------------------------

def _zeros_dtensor(shape, dtype, spec, mesh, device) -> DTensor:
    """A DTensor of zeros of ``shape`` placed by ``spec``: this rank's
    local shard on ``device`` (fake, unmaterialised, under
    ``FakeTensorMode``)."""
    pl = PT.placements(spec, mesh)
    loc = torch.zeros(tp.shard_box(shape, mesh, pl)[0], dtype=dtype,
                      device=device)
    return DTensor.from_local(loc, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=tp.contiguous_strides(shape))


def _fake_local(spec_tree, tree, mesh, device, placed: bool = False):
    """Every meta leaf of ``tree`` as a fake tensor on ``device``: rank
    0's local shard cut as ``spec_tree`` places it (a DTensor of it with
    ``placed``), the whole leaf without a mesh."""
    if isinstance(tree, dict):
        return {k: _fake_local(spec_tree[k], v, mesh, device, placed)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_fake_local(s, v, mesh, device, placed)
                          for s, v in zip(spec_tree, tree))
    if mesh is None:
        return torch.empty(tree.shape, dtype=tree.dtype, device=device)
    if placed:
        return _zeros_dtensor(tree.shape, tree.dtype, spec_tree, mesh,
                              device)
    local, _ = tp.shard_box(tree.shape, mesh, PT.placements(spec_tree, mesh))
    return torch.empty(local, dtype=tree.dtype, device=device)


def place_params(model: nn.Module, mesh, device) -> nn.Module:
    """Every parameter of a model built under ``FakeTensorMode``: a
    DTensor from a fake local shard with its reference spec's placements
    (``partition.model_specs``), or a fake tensor on ``device`` without a
    mesh."""
    specs = PT.model_specs(model) if mesh is not None else None
    for prefix, mod in model.named_modules():
        for key, p in list(mod._parameters.items()):
            name = f"{prefix}.{key}" if prefix else key
            if mesh is None:
                t = torch.empty(p.shape, dtype=p.dtype, device=device)
            else:
                t = _zeros_dtensor(p.shape, p.dtype, specs[name], mesh,
                                   device)
            mod._parameters[key] = nn.Parameter(t, p.requires_grad)
    return model


def zero1_moments(model: nn.Module, groups: Sequence[Group], mesh,
                  device) -> Tuple[List[DTensor], List[DTensor]]:
    """The AdamW moments (float32 zeros) on the reference's layout, one
    per group (a layer stack is one tensor), placed by ``zero1_specs``."""
    named = dict(model.named_parameters())
    shapes = {}
    for g in groups:
        t = named[g.names[0]]
        shapes[g.path] = torch.empty(
            ((len(g.names),) if g.stacked else ()) + tuple(t.shape),
            device="meta")
    tree: Dict = {}
    for path, t in shapes.items():
        _set(tree, path.split("/"), t)
    specs = PT.tree_paths(PT.zero1_specs(tree, stacked_prefixes=STACKED))
    mk = lambda g: _zeros_dtensor(shapes[g.path].shape,       # noqa: E731
                                  torch.float32, specs[g.path], mesh,
                                  device)
    return [mk(g) for g in groups], [mk(g) for g in groups]


def _set(tree: Dict, keys: Sequence[str], leaf) -> None:
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = leaf


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def start_fake_group(world: int) -> None:
    """Torch's fake process group of ``world`` ranks, this process rank
    0, in place of any group already started."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def default_device_type() -> str:
    """The card when torch has one, else the CPU (autograd cannot hold
    fake CUDA tensors in a torch built without CUDA)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def trace_cell(cfg: ArchConfig, shape: ShapeCfg, mesh=None,
               device_type: Optional[str] = None) -> Dict[str, Any]:
    """The step of ``shape``'s kind for ``cfg`` run once under
    ``FakeTensorMode`` on ``mesh`` (one device without one) and counted
    by ``OpCosts``: one rank's costs, argument bytes by kind, the
    parameter counts and the trace's wall time."""
    device = torch.device(device_type or default_device_type())
    api = build_model(cfg)
    out: Dict[str, Any] = {}
    with FakeTensorMode():
        model = api.init_params(torch.Generator("cpu").manual_seed(0))
        out["n_params"] = count_params(model)
        out["n_params_active"] = count_active_params(cfg, model)
        place_params(model, mesh, device)
        args: Dict[str, Any] = {"params": model}
        batch_sds = api.input_specs(shape)
        bspecs = PT.batch_specs(batch_sds, shape.global_batch)
        batch = _fake_local(bspecs, batch_sds, mesh, device)
        args["batch"] = batch
        if shape.kind == "train":
            opt = AdamW(lr=cosine_schedule(3e-4, 100, 10000))
            if mesh is None:
                groups = None
                opt_state = opt.init(list(model.parameters()))
            else:
                groups = param_groups(model)
                mu, nu = zero1_moments(model, groups, mesh, device)
                opt_state = AdamWState(mu, nu, torch.zeros(
                    (), dtype=torch.int32, device=device))
            args["opt_state"] = opt_state
            fn = make_train_step(api, opt, mesh, groups)
            call = lambda: fn(model, opt_state, batch)  # noqa: E731
        elif shape.kind == "prefill":
            call = lambda: _with_mesh(mesh, api.prefill,  # noqa: E731
                                      model, batch)
        else:
            state_sds = api.state_specs(shape)
            sspecs = PT.decode_state_specs(cfg, shape, state_sds)
            state = _fake_local(sspecs, state_sds, mesh, device, True)
            args["state"] = state
            tokens = batch["tokens"]
            cache_len = shape.seq_len - 1
            call = lambda: _with_mesh(mesh, api.decode_step,  # noqa: E731
                                      model, state, tokens, cache_len)
        out["argument_bytes"] = {
            k: OpCosts(v).argument_bytes for k, v in args.items()}
        t0 = time.time()
        with OpCosts(args) as costs:
            result = call()
        out["trace_s"] = round(time.time() - t0, 2)
        del result
    out["costs"] = costs
    return out


def _with_mesh(mesh, fn, *args):
    with PT.use_mesh(mesh):
        return fn(*args)


def cell_mesh(multi_pod: bool, mesh_shape: Optional[Sequence[int]] = None,
              device_type: Optional[str] = None):
    """The cell's mesh on a fresh fake process group: the production mesh
    (16 x 16, or 2 x 16 x 16 with ``multi_pod``), or ``mesh_shape`` over
    the same axis names (a smaller mesh for tests)."""
    shape = tuple(mesh_shape) if mesh_shape else (
        (2, 16, 16) if multi_pod else (16, 16))
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data",
                                                             "model")
    n = 1
    for s in shape:
        n *= s
    start_fake_group(n)
    return compat_make_mesh(shape, axes, device_type or
                            default_device_type())


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             skip_compile: bool = False,
             overrides: Optional[Dict[str, Any]] = None,
             mesh_shape: Optional[Sequence[int]] = None,
             reduced: bool = False) -> Dict[str, Any]:
    """One cell's record, with the reference's keys (``trace_s`` in place
    of ``lower_s``/``compile_s``/``hlo_kb``). ``mesh_shape`` and
    ``reduced`` (a smaller mesh, the reduced config) serve tests."""
    cfg = get_arch(arch_id)
    if reduced:
        cfg = cfg.reduced()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    mesh_name = ("x".join(map(str, mesh_shape)) if mesh_shape else
                 "2x16x16" if multi_pod else "16x16")
    rec: Dict[str, Any] = {"arch": arch_id, "shape": shape_name,
                           "mesh": mesh_name}
    ok, reason = cell_runnable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec

    mesh = cell_mesh(multi_pod, mesh_shape)
    chips = mesh.size()
    if skip_compile:
        rec["status"] = "placed"
        return rec
    t = trace_cell(cfg, shape, mesh)
    costs = t["costs"]
    rec["trace_s"] = t["trace_s"]
    ab = t["argument_bytes"]
    rec["memory"] = {
        "argument_bytes": int(costs.argument_bytes),
        "param_bytes": int(ab["params"]),
        "opt_state_bytes": int(ab.get("opt_state", 0)),
        "batch_bytes": int(ab["batch"]),
        "state_bytes": int(ab.get("state", 0)),
        "temp_bytes": int(costs.peak_live_bytes),
        "peak_bytes_per_device": int(costs.peak_bytes),
    }
    if shape.kind == "train":
        mf = RA.model_flops_train(t["n_params_active"],
                                  shape.global_batch * shape.seq_len)
    elif shape.kind == "prefill":
        mf = RA.model_flops_decode(t["n_params_active"],
                                   shape.global_batch * shape.seq_len)
    else:
        mf = RA.model_flops_decode(t["n_params_active"], shape.global_batch)
    # rank 0's costs, times the chips (balanced SPMD, as the reference)
    flops = costs.flops() * chips
    nbytes = costs.hbm_bytes() * chips
    by_type = {k: v * chips for k, v in costs.collective_bytes().items()}
    coll_bytes = sum(by_type.values())
    rec["collectives"] = {"bytes_by_type": by_type,
                          "total_bytes": coll_bytes}
    rl = RA.roofline_from_costs(flops, nbytes, coll_bytes, chips, mf)
    rec["roofline"] = {
        "flops": rl.flops, "hbm_bytes": rl.hbm_bytes,
        "collective_bytes": rl.collective_bytes, "chips": chips,
        "compute_s": rl.compute_s, "memory_s": rl.memory_s,
        "collective_s": rl.collective_s, "bottleneck": rl.bottleneck,
        "model_flops": mf,
        "useful_fraction": rl.useful_fraction(),
        "roofline_fraction": rl.roofline_fraction(),
    }
    rec["n_params"] = t["n_params"]
    rec["n_params_active"] = t["n_params_active"]
    rec["status"] = "ok"
    return rec


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-compile", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    help="config override key=value (e.g. "
                         "moe_impl=shard_map)")
    args = ap.parse_args(argv)

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        overrides[k] = int(v) if v.isdigit() else v

    archs = list(all_archs()) if (args.all or args.arch is None) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]

    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
                t0 = time.time()
                try:
                    rec = run_cell(arch, shape, mp,
                                   skip_compile=args.skip_compile,
                                   overrides=overrides or None)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "status": "error",
                           "error": f"{type(e).__name__}: {str(e)[:400]}"}
                    traceback.print_exc()
                rec["wall_s"] = round(time.time() - t0, 1)
                results.append(rec)
                status = rec.get("status")
                extra = ""
                if status == "ok":
                    rl = rec["roofline"]
                    extra = (f" bottleneck={rl['bottleneck']}"
                             f" compute={rl['compute_s']:.4f}s"
                             f" mem={rl['memory_s']:.4f}s"
                             f" coll={rl['collective_s']:.4f}s")
                    mem = rec.get("memory", {})
                    if "peak_bytes_per_device" in mem:
                        extra += (f" mem/dev="
                                  f"{mem['peak_bytes_per_device']/2**30:.2f}GiB")
                print(f"[dryrun] {tag}: {status} ({rec['wall_s']}s){extra}",
                      flush=True)
                if args.out:
                    with open(args.out, "w") as f:
                        json.dump(results, f, indent=1)
    if dist.is_initialized():
        dist.destroy_process_group()
    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_skip = sum(1 for r in results if r["status"] == "skipped")
    n_err = len(results) - n_ok - n_skip
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} failed")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
