"""Multi-process jobs for the port's mesh tests (``test_torch_mesh*.py``,
``test_torch_pipeline.py``), in a module of their own so that a spawned
rank imports torch and ``repro_torch`` only, never JAX.

:func:`spawn` starts ``nprocs`` ranks with ``torch.multiprocessing``
(start method ``spawn``), each joining a ``gloo`` group on a ``file://``
store under the test's directory, runs one job in them, and fails if a
rank raises or the job outlasts its timeout (every rank is then killed).
A job writes what the test checks into that directory from rank 0.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TRAIN = ["--reduced", "--steps", "3", "--batch", "4", "--seq", "32",
         "--device", "cpu", "--log-every", "1", "--save-every", "1"]


def spawn(job: str, nprocs: int, directory, timeout: float = 240.0) -> None:
    ctx = mp.start_processes(_entry, args=(nprocs, job, str(directory)),
                             nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{job}: {nprocs} ranks still running after "
                               f"{timeout} s")
    assert all(not p.is_alive() for p in ctx.processes)


def _entry(rank: int, nprocs: int, job: str, directory: str) -> None:
    torch.set_num_threads(1)
    globals()[job](rank, nprocs, directory)


def _group(rank: int, world: int, directory: str, name: str) -> None:
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        directory, f"store_{name}"), rank=rank, world_size=world)


def _write(directory: str, name: str, obj) -> None:
    with open(os.path.join(directory, name + ".json"), "w") as f:
        json.dump(obj, f)


def float32(arch: str, moe_impl: str = "") -> None:
    """Re-register ``arch`` in this process with float32 parameters (and
    the MoE impl, when given), for the trainer's ``get_arch``."""
    import dataclasses
    from repro_torch.configs import base
    cfg = dataclasses.replace(base.get_arch(arch), dtype="float32")
    base.register(dataclasses.replace(cfg, moe_impl=moe_impl)
                  if moe_impl else cfg)


def train_run(directory: str, tag: str, argv, rank: int) -> None:
    """One trainer run (3 steps, float32, reduced), its checkpoints under
    ``directory/tag`` (every step from 1) and, from rank 0, its losses and
    gradient norms in ``directory/tag.json``. ``argv`` holds ``--arch``
    and may end with ``impl=<MoE impl>``."""
    from repro_torch.launch import train
    impl = [a[5:] for a in argv if a.startswith("impl=")]
    argv = [a for a in argv if not a.startswith("impl=")]
    float32(argv[argv.index("--arch") + 1], *impl)
    gnorms = []
    losses = train.main(
        TRAIN + list(argv) + ["--ckpt-dir", os.path.join(directory, tag)],
        on_step=lambda step, m: gnorms.append(float(m["gnorm"])))
    if rank == 0:
        _write(directory, tag, {"losses": losses, "gnorms": gnorms})
    if dist.is_initialized():
        dist.barrier()      # rank 0's checkpoints are on disk for every rank


def read_run(directory: str, tag: str, step: int = 2):
    """A run's losses and gradient norms, and its step-``step``
    checkpoint as flat tensors (``params/...``, ``opt#0/...``)."""
    with open(os.path.join(directory, tag + ".json")) as f:
        rec = json.load(f)
    return rec, _flat_checkpoint(os.path.join(directory, tag,
                                              f"step_{step:08d}"))


def same_training(directory: str, got: str, want: str,
                  exact: bool = False) -> None:
    """Run ``got`` against run ``want``: bit for bit with ``exact``, else
    losses within 1e-5 and gradient norms within 1e-4 relative, and the
    parameters after the last step within 3.6e-4, with at most 0.1% of
    entries past 1e-6."""
    g, gflat = read_run(directory, got)
    w, wflat = read_run(directory, want)
    assert set(gflat) == set(wflat)
    if exact:
        assert g == w, (got, g, w)
        bad = [k for k in wflat if not torch.equal(gflat[k], wflat[k])]
        assert not bad, (got, bad)
        return
    np.testing.assert_allclose(g["losses"], w["losses"], rtol=1e-5,
                               err_msg=got)
    np.testing.assert_allclose(g["gnorms"], w["gnorms"], rtol=1e-4,
                               err_msg=got)
    diffs = torch.cat([(gflat[k] - wflat[k]).abs().reshape(-1)
                       for k in sorted(wflat) if k.startswith("params/")])
    assert float(diffs.max()) <= 3.6e-4, (got, float(diffs.max()))
    past = int((diffs > 1e-6).sum())
    assert past <= 1e-3 * diffs.numel(), (got, past, diffs.numel())


# ---------------------------------------------------------------------------
# the trainer at every mesh and family (test_torch_mesh_train.py)
# ---------------------------------------------------------------------------

FAMILIES = [("granite-moe-3b-a800m", ["impl=gspmd"]),
            ("granite-moe-3b-a800m", ["impl=shard_map"]),
            ("mamba2-1.3b", []), ("zamba2-2.7b", []), ("whisper-base", []),
            ("internvl2-76b", [])]
MINICPM = [("minicpm-2b", []), ("minicpm-2b", ["--grad-compression"])]


def tag(arch: str, extra, mesh: str) -> str:
    return "_".join([arch] + [e.strip("-").replace("impl=", "")
                              for e in extra] + [mesh])


def trainer_two_ranks(rank: int, world: int, directory: str) -> None:
    """(2, 1) and (1, 2) of minicpm-2b with and without compression and
    (1, 2) of every other family; then, on rank 0 alone, (1, 1) of each
    and the one-device trainer with no mesh."""
    _group(rank, world, directory, "two")
    for arch, extra in MINICPM:
        for model_axis in (1, 2):
            mesh = f"{world // model_axis}x{model_axis}"
            train_run(directory, tag(arch, extra, mesh),
                      ["--arch", arch, "--model-axis", str(model_axis)]
                      + extra, rank)
    for arch, extra in FAMILIES:
        train_run(directory, tag(arch, extra, "1x2"),
                  ["--arch", arch, "--model-axis", "2"] + extra, rank)
    dist.destroy_process_group()
    if rank:
        return
    _group(0, 1, directory, "one")
    for arch, extra in MINICPM + FAMILIES:
        train_run(directory, tag(arch, extra, "1x1"),
                  ["--arch", arch, "--model-axis", "1"] + extra, 0)
    dist.destroy_process_group()
    for arch, extra in MINICPM:
        train_run(directory, tag(arch, extra, "nomesh"),
                  ["--arch", arch] + extra, 0)


# ---------------------------------------------------------------------------
# mesh, place_model, elastic resume, expert parallelism (test_torch_mesh.py)
# ---------------------------------------------------------------------------

def _flat_checkpoint(path: str):
    from repro_torch.checkpoint import ckpt as C
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(path, "data.msgpack.zst"), "rb") as f:
        blob = f.read()
    if blob[:4] == C.ZSTD_MAGIC:
        blob = C._ZD.decompress(blob)
    payload = C.unpackb(blob)
    return {k: C._decode_array(payload[k], m["dtype"], m["shape"])
            for k, m in manifest["tensors"].items()}


def _remesh_is_exact(directory: str, step_dir: str, model_axis: int) -> dict:
    """Restore ``step_dir`` with ``elastic_remesh`` onto
    ``make_local_mesh(model_axis)``: each leaf's placements are its
    spec's, and each leaf gathered whole equals the file bit for bit."""
    from repro_torch.checkpoint.ckpt import Checkpointer
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.runtime import partition as PT
    from repro_torch.runtime.fault_tolerance import elastic_remesh
    flat = _flat_checkpoint(step_dir)
    mesh = make_local_mesh(model_axis, "cpu")
    cfg = get_arch("minicpm-2b").reduced()
    restored, _, _ = Checkpointer(os.path.dirname(step_dir)).restore(
        _template(cfg), int(step_dir[-8:]))
    specs = PT.param_specs(restored["params"], PT.STACKED)
    placed = elastic_remesh(restored["params"], mesh, specs)
    exact, placements_ok = True, True
    for path, leaf in PT.tree_paths(placed).items():
        want = PT.placements(PT.tree_paths(specs)[path], mesh)
        placements_ok &= list(leaf.placements) == want
        exact &= torch.equal(leaf.full_tensor(), flat["params/" + path])
    return {"exact": bool(exact), "placements": bool(placements_ok),
            "mesh": list(mesh.mesh.shape)}


def _template(cfg):
    from repro_torch.convert import (lm_params_to_reference,
                                     opt_state_to_reference)
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamW
    import dataclasses
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg).init_params(torch.Generator().manual_seed(0))
    opt = AdamW(lr=lambda c: c).init(list(model.parameters()))
    return {"params": lm_params_to_reference(model, cfg),
            "opt": opt_state_to_reference(opt, model)}


def _moe_check(directory: str, rank: int) -> dict:
    """The MoE layer on a 2 x 2 mesh, both impls, from the parameters and
    input the test wrote: outputs gathered over 'data', aux losses, and
    the gradients of the global ``sum(out * w)`` gathered whole."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs.base import MoESpec
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.moe import moe_apply
    from repro_torch.runtime import partition as PT
    from repro_torch.runtime import tp
    data = np.load(os.path.join(directory, "moe_in.npz"))
    spec = MoESpec(n_experts=4, top_k=2, capacity_factor=8.0)
    mesh = make_local_mesh(2, "cpu")
    out = {}
    for impl in ("gspmd", "shard_map"):
        params = {k: distribute_tensor(
            torch.from_numpy(data[k]), mesh,
            PT.placements(PT.spec_for(k, data[k].ndim, False,
                                      data[k].shape), mesh)
        ).requires_grad_() for k in ("router", "w_experts_gate",
                                     "w_experts_up", "w_experts_down")}
        with PT.use_mesh(mesh):
            rows = slice(*[2 * tp.batch_split()[0] + i for i in (0, 2)])
            x = torch.from_numpy(data["x"][rows])
            y, aux = moe_apply(params, spec, 64, x, impl)
            w = torch.from_numpy(data["w"][rows])
            # the impls' aux losses differ by definition (the global
            # batch's means against the shards' mean), so the gradient
            # compared is the output's
            loss = tp.reduce_batch((y * w).sum())
            grads = torch.autograd.grad(loss, list(params.values()))
            ys = tp.all_gather_batch(y.detach())
        out[impl] = {"y": torch.cat(ys).tolist(), "aux": float(aux),
                     "grads": {k: g.full_tensor().tolist()
                               for k, g in zip(params, grads)}}
    # the global path where the capacity drops pairs: each rank's slots
    # count the pairs of the rows before it, as one device's sort does
    tight = MoESpec(n_experts=4, top_k=2, capacity_factor=0.5)
    p = {k: torch.from_numpy(data[k]) for k in ("router", "w_experts_gate",
                                                "w_experts_up",
                                                "w_experts_down")}
    x = torch.from_numpy(data["x"])
    want, want_aux = moe_apply(p, tight, 64, x, "gspmd")
    with PT.use_mesh(mesh):
        i, _ = tp.batch_split()
        y, aux = moe_apply(p, tight, 64, x[2 * i:2 * i + 2], "gspmd")
        y = torch.cat(tp.all_gather_batch(y))
    out["drops"] = {"y": float((y - want).abs().max()),
                    "aux": abs(float(aux) - float(want_aux)),
                    "zero_rows": int((want.abs().sum(-1) == 0).sum())}
    return out


def _attention_check(model_axis: int, n_heads: int, n_kv: int,
                     bias: bool, causal: bool) -> dict:
    """``layers.attention`` on ``make_local_mesh(model_axis)`` with its
    parameters placed by their specs and each 'data' rank on its rows,
    against the one-device call on the same inputs: max errors of the
    output and of every parameter's gradient (gathered whole), each over
    the largest magnitude of what it is held to."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import layers as L
    from repro_torch.runtime import partition as PT
    from repro_torch.runtime import tp
    cfg = L.AttnCfg(32, n_heads, n_kv, 16, qkv_bias=bias, causal=causal)
    p = L.attn_init(torch.Generator().manual_seed(1), cfg, torch.float32)
    if bias:
        g = torch.Generator().manual_seed(2)
        p = {k: v + 0.1 * torch.randn(v.shape, generator=g)
             if k.startswith("b") else v for k, v in p.items()}
    x = torch.randn(4, 8, 32, generator=torch.Generator().manual_seed(3))
    pos = torch.arange(8, dtype=torch.int32)[None].expand(4, 8)
    plain = {k: v.clone().requires_grad_() for k, v in p.items()}
    want, _ = L.attention(plain, cfg, x, pos)
    want_g = torch.autograd.grad((want ** 2).sum(), list(plain.values()))
    mesh = make_local_mesh(model_axis, "cpu")
    placed = {k: distribute_tensor(v, mesh, PT.placements(
        PT.spec_for(k, v.ndim, False, tuple(v.shape)), mesh)
    ).requires_grad_() for k, v in p.items()}
    with PT.use_mesh(mesh):
        i, n = tp.batch_split()
        rows = slice(i * 4 // n, (i + 1) * 4 // n)
        got, _ = L.attention(placed, cfg, x[rows], pos[rows])
        loss = tp.reduce_batch((got ** 2).sum())
        got_g = torch.autograd.grad(loss, list(placed.values()))
        heads, seq = L.head_layout(n_heads, 8)
    return {"out": float((got - want[rows]).abs().max()
                         / want[rows].abs().max()),
            "grads": max(float((g.full_tensor() - w).abs().max()
                               / w.abs().max())
                         for g, w in zip(got_g, want_g)),
            "split": "heads" if seq is None else "rows",
            "heads": heads}


def mesh_four_ranks(rank: int, world: int, directory: str) -> None:
    """On 4 ranks: place_model of every reduced arch on (2, 2); minicpm-2b
    trained on (2, 2) with and without compression; its step-1
    checkpoint remeshed onto (4, 1) bit-exactly and resumed there; the
    MoE layer's two impls on (2, 2); attention split by heads and by
    query rows. Then on rank 0 alone: the (1, 1) baselines, the remesh
    and resume on (1, 1), and ``elastic_remesh`` on a (1,) mesh."""
    import shutil
    from repro_torch.configs.base import all_archs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.api import build_model
    from repro_torch.runtime import partition as PT
    _group(rank, world, directory, "four")
    mesh = make_local_mesh(2, "cpu")
    placed = {}
    for name, cfg in sorted(all_archs().items()):
        model = build_model(cfg.reduced()).init_params(
            torch.Generator().manual_seed(0))
        whole = {n: p.detach().clone() for n, p in model.named_parameters()}
        PT.place_model(model, cfg.reduced(), mesh)
        specs = PT.model_specs(model)
        placed[name] = all(
            list(p.placements) == PT.placements(specs[n], mesh)
            and torch.equal(p.full_tensor(), whole[n])
            for n, p in model.named_parameters())
    for arch, extra in MINICPM:
        train_run(directory, tag(arch, extra, "2x2"),
                  ["--arch", arch, "--model-axis", "2"] + extra, rank)
    src = os.path.join(directory, tag("minicpm-2b", [], "2x2"),
                       "step_00000001")
    remesh = {"4x1": _remesh_is_exact(directory, src, 1)}
    if rank == 0:
        shutil.copytree(src, os.path.join(directory, "resume_4x1",
                                          "step_00000001"))
    dist.barrier()
    train_run(directory, "resume_4x1", ["--arch", "minicpm-2b",
                                        "--model-axis", "1"], rank)
    moe = _moe_check(directory, rank)
    attention = {"heads_1x4": _attention_check(4, 4, 2, False, True),
                 "uneven_2x2": _attention_check(2, 3, 1, True, True),
                 "rows_1x4": _attention_check(4, 2, 1, False, True),
                 "rows_noncausal_1x4": _attention_check(4, 2, 2, True,
                                                        False)}
    dist.destroy_process_group()
    if rank:
        return
    _group(0, 1, directory, "one")
    for arch, extra in MINICPM:
        train_run(directory, tag(arch, extra, "1x1"),
                  ["--arch", arch, "--model-axis", "1"] + extra, 0)
    remesh["1x1"] = _remesh_is_exact(directory, src, 1)
    shutil.copytree(src, os.path.join(directory, "resume_1x1",
                                      "step_00000001"))
    train_run(directory, "resume_1x1", ["--arch", "minicpm-2b",
                                        "--model-axis", "1"], 0)
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.runtime.fault_tolerance import elastic_remesh
    tree = {"w": np.arange(16, dtype=np.float32).reshape(4, 4),
            "none": None}
    out = elastic_remesh(tree, compat_make_mesh((1,), ("data",), "cpu"),
                         {"w": PT.P("data", None), "none": PT.P()})
    roundtrip = (out["none"] is None
                 and np.array_equal(out["w"].full_tensor().numpy(),
                                    tree["w"]))
    dist.destroy_process_group()
    _write(directory, "mesh", {"placed": placed, "remesh": remesh,
                               "moe": moe, "attention": attention,
                               "roundtrip": roundtrip})


# ---------------------------------------------------------------------------
# the GPipe pipeline (test_torch_pipeline.py)
# ---------------------------------------------------------------------------

def pipeline_four_stages(rank: int, world: int, directory: str) -> None:
    """``pipeline_forward`` on a (4,) ('pod',) mesh against the serial
    loop on the same parameters: the forward and every gradient of
    ``mean(out ** 2)``, on every stage."""
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.runtime import partition as PT
    from repro_torch.runtime.pipeline import pipeline_forward
    data = np.load(os.path.join(directory, "pipe_in.npz"))

    def layer_fn(lp, h):
        return torch.tanh(h @ lp["w"] + lp["b"])

    def inputs():
        return ({k: torch.from_numpy(data[k]).requires_grad_()
                 for k in ("w", "b")},
                torch.from_numpy(data["x"]).requires_grad_())
    params, x = inputs()
    serial = pipeline_forward(layer_fn, params, x, 6)
    gs = torch.autograd.grad((serial ** 2).mean(), [params["w"],
                                                     params["b"], x])
    _group(rank, world, directory, "pipe")
    params, x = inputs()
    with PT.use_mesh(compat_make_mesh((4,), ("pod",), "cpu")):
        piped = pipeline_forward(layer_fn, params, x, n_microbatches=6)
        gp = torch.autograd.grad((piped ** 2).mean(), [params["w"],
                                                        params["b"], x])
    errs = {"forward": float((piped - serial).detach().abs().max()),
            "grads": [float((a - b).abs().max()) for a, b in zip(gp, gs)]}
    every = [None] * world
    dist.all_gather_object(every, errs)
    dist.destroy_process_group()
    if rank == 0:
        _write(directory, "pipe", {"stages": every,
                                   "serial": serial.detach().tolist()})


# ---------------------------------------------------------------------------
# prefill and decode on a mesh (test_torch_mesh_decode.py)
# ---------------------------------------------------------------------------

DECODE_ARCHS = ("minicpm-2b", "granite-moe-3b-a800m", "internvl2-76b",
                "mamba2-1.3b", "zamba2-2.7b", "whisper-base",
                "minicpm-2b-one-head")
DECODE_B, DECODE_S, DECODE_STEPS = 4, 16, 3


def _decode_run(api, cfg, params, rows: slice, single=None):
    """Prefill of ``rows`` of a fixed prompt batch (whisper: its encoder,
    and the prompt decoded into caches 3 positions longer), then 3 decode
    steps of fixed tokens: every step's logits. ``single``, a decode
    state for one request, skips the prefill."""
    from repro_torch.models import encdec
    g = torch.Generator().manual_seed(1)
    B, S, n = DECODE_B, DECODE_S, DECODE_STEPS
    toks = torch.randint(0, cfg.vocab, (B, S), generator=g,
                         dtype=torch.int32)
    nxt = torch.randint(0, cfg.vocab, (B, n), generator=g,
                        dtype=torch.int32)
    extra = torch.randn((B, max(cfg.n_patches, 1), cfg.d_model),
                        generator=g)
    frames = (torch.randn((B, cfg.encdec.enc_len, cfg.d_model),
                          generator=g) if cfg.encdec else None)
    toks, nxt, extra = toks[rows], nxt[rows], extra[rows]
    out, start = [], S
    with torch.no_grad():
        if single is not None:
            state = single
        elif cfg.family == "audio":
            enc = encdec.encode(params, cfg, frames[rows])
            caches = encdec.init_caches(cfg, toks.shape[0], S + n,
                                        device="cpu")
            logits, state = api.decode_step(params, (enc, caches), toks, 0)
            out.append(logits)
        else:
            batch = {"tokens": toks, "max_len": S + n
                     + (cfg.n_patches if cfg.family == "vlm" else 0)}
            if cfg.family == "vlm":
                batch["patches"] = extra
                start += cfg.n_patches
            logits, state = api.prefill(params, batch)
            out.append(logits)
        for t in range(n):
            logits, state = api.decode_step(params, state, nxt[:, t:t + 1],
                                            start + t)
            out.append(logits)
    return out, state


def _whole(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def decode_four_ranks(rank: int, world: int, directory: str) -> None:
    """On a (2, 2) mesh, for one reduced float32 arch of each family (the
    MoE on its global path) and minicpm-2b with one head (attention split
    by query rows):
    prefill and 3 decode steps of this rank's rows, the caches and states
    DTensors placed by ``partition.kv_cache_spec`` / ``ssm_state_specs``,
    against the same run with no mesh on the whole batch; then, for the
    sub-quadratic archs and minicpm, a single request's decode from a
    whole state placed in the long-context layout (the KV sequence and
    the SSM state's head channels over 'data')."""
    import dataclasses
    from repro_torch.configs.base import ShapeCfg, get_arch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.api import build_model
    from repro_torch.runtime import partition as PT
    from repro_torch.runtime import tp
    _group(rank, world, directory, "decode")
    mesh = make_local_mesh(2, "cpu")
    with PT.use_mesh(mesh):
        idx, n = tp.batch_split()
    per = DECODE_B // n
    rows = slice(idx * per, (idx + 1) * per)
    errs, long_errs = {}, {}
    for arch in DECODE_ARCHS:
        # the MoE's global path: its expert-parallel path counts each
        # rank's capacity, so only the global one equals one device
        cfg = dataclasses.replace(get_arch(arch.replace(
            "-one-head", "")).reduced(), dtype="float32", moe_impl="gspmd")
        if arch.endswith("-one-head"):
            # fewer heads than 'model' ranks: attention splits the query
            # rows, and a decode step's one row goes to one rank
            cfg = dataclasses.replace(cfg, n_heads=1, n_kv_heads=1)
        api = build_model(cfg)
        params = api.init_params(torch.Generator().manual_seed(0))
        want, _ = _decode_run(api, cfg, params, slice(None))
        PT.place_model(params, cfg, mesh)
        with PT.use_mesh(mesh):
            got, state = _decode_run(api, cfg, params, rows)
        placed = all(isinstance(t, torch.distributed.tensor.DTensor)
                     for t in _state_leaves(state) if t.dim() >= 4)
        errs[arch] = {"err": max(float((g - w[rows]).abs().max()
                                       / w[rows].abs().max())
                                 for g, w in zip(got, want)),
                      "placed": placed}
        if arch not in ("minicpm-2b", "mamba2-1.3b", "zamba2-2.7b"):
            continue
        whole = build_model(cfg).init_params(
            torch.Generator().manual_seed(0))
        _, st = _decode_run(api, cfg, whole, slice(0, 1))
        want1, _ = _decode_run(api, cfg, whole, slice(0, 1),
                               single=_clone(st))
        specs = PT.decode_state_specs(cfg, ShapeCfg("one", 0, 1, "decode"),
                                      st)
        long_state = _place(st, specs, mesh)
        with PT.use_mesh(mesh):
            got1, _ = _decode_run(api, cfg, params, slice(0, 1),
                                  single=long_state)
        long_errs[arch] = max(float((g - w).abs().max() / w.abs().max())
                              for g, w in zip(got1, want1[len(want1)
                                                          - len(got1):]))
    dist.destroy_process_group()
    if rank == 0:
        _write(directory, "decode", {"errs": errs, "long": long_errs})


def _state_leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _state_leaves(v)]
    return [] if tree is None else [tree]


def _clone(tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone()


def _place(tree, specs, mesh):
    """A whole decode state (the same on every rank) as DTensors."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.runtime import partition as PT
    if isinstance(tree, (tuple, list)):
        return type(tree)(_place(t, s, mesh) for t, s in zip(tree, specs))
    return distribute_tensor(tree, mesh, PT.placements(specs, mesh))


# ---------------------------------------------------------------------------
# the dry run's ZeRO-1 step on a mesh (test_torch_dryrun_zero1.py)
# ---------------------------------------------------------------------------

ZERO1_ARCHS = ("minicpm-2b", "granite-moe-3b-a800m", "whisper-base")
ZERO1_B, ZERO1_S, ZERO1_STEPS = 4, 16, 2


def _zero1_batch(api, cfg):
    """A fixed training batch of the shapes ``api.input_specs`` gives."""
    from repro_torch.configs.base import ShapeCfg
    g = torch.Generator().manual_seed(1)
    specs = api.input_specs(ShapeCfg("zero1", ZERO1_S, ZERO1_B, "train"))
    return {k: (torch.randint(0, cfg.vocab, v.shape, generator=g,
                              dtype=v.dtype)
                if not v.dtype.is_floating_point
                else torch.randn(v.shape, generator=g, dtype=v.dtype))
            for k, v in specs.items()}


def dryrun_zero1_four_ranks(rank: int, world: int, directory: str) -> None:
    """On a (2, 2) mesh, for one reduced float32 arch of three families
    (the MoE on its global path): two steps of the dry run's train step
    (``dryrun.make_train_step`` with the mesh, its parameter groups and
    the ZeRO-1 moments of ``dryrun.zero1_moments``) on this rank's rows,
    against two steps of the trainer's one-device step on the whole batch
    (the losses, gradient norms, parameters and stacked moments) and two
    of the trainer's mesh step (``launch.train.make_step`` with the mesh,
    moments placed like the parameters) on the same rows."""
    import dataclasses
    from repro_torch.configs.base import get_arch
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamW, AdamWState, cosine_schedule
    from repro_torch.runtime import partition as PT
    from repro_torch.runtime import tp
    _group(rank, world, directory, "zero1")
    mesh = make_local_mesh(2, "cpu")
    with PT.use_mesh(mesh):
        idx, n = tp.batch_split()
    per = ZERO1_B // n
    out = {}
    for arch in ZERO1_ARCHS:
        cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32",
                                  moe_impl="gspmd")
        api = build_model(cfg)
        opt = AdamW(lr=cosine_schedule(1e-2, 1, 10))
        batch = _zero1_batch(api, cfg)
        rows = {k: v[idx * per:(idx + 1) * per] for k, v in batch.items()}
        init = lambda: api.init_params(                   # noqa: E731
            torch.Generator().manual_seed(0))
        want = init()
        want_state = opt.init(list(want.parameters()))
        step = D.make_train_step(api, opt)
        got = init()
        PT.place_model(got, cfg, mesh)
        groups = D.param_groups(got)
        mu, nu = D.zero1_moments(got, groups, mesh, "cpu")
        got_state = AdamWState(mu, nu, torch.zeros((), dtype=torch.int32))
        mesh_step = D.make_train_step(api, opt, mesh, groups)
        trainer = init()
        PT.place_model(trainer, cfg, mesh)
        trainer_state = opt.init(list(trainer.parameters()))
        trainer_step = train.make_step(api, opt, False, mesh)
        losses, gnorms = [], []
        for i in range(ZERO1_STEPS):
            want, want_state, w = step(want, want_state, batch)
            got, got_state, g = mesh_step(got, got_state, rows)
            trainer, trainer_state, _, _ = trainer_step(
                trainer, trainer_state, None, rows)
            losses.append([float(g["loss"]), float(w["loss"])])
            gnorms.append([float(g["gnorm"]), float(w["gnorm"])])
            if i == 0:
                moment_err = _zero1_moment_err(want, want_state, groups,
                                               got_state)
        named = dict(want.named_parameters())
        on_mesh = dict(trainer.named_parameters())
        diffs = torch.cat([(_whole(p) - named[k]).detach().abs().reshape(-1)
                           for k, p in got.named_parameters()])
        mesh_err = max(float((_whole(p) - _whole(on_mesh[k])).abs().max())
                       for k, p in got.named_parameters())
        out[arch] = {"losses": losses, "gnorms": gnorms,
                     "param_err": float(diffs.max()),
                     "param_past": int((diffs > 1e-6).sum()),
                     "param_n": diffs.numel(), "mesh_err": mesh_err,
                     "moment_err": moment_err,
                     "count": int(got_state.count),
                     "groups": len(groups),
                     "stacked": sum(g.stacked for g in groups)}
    dist.destroy_process_group()
    if rank == 0:
        _write(directory, "zero1", out)


def _zero1_moment_err(want, want_state, groups, got_state) -> float:
    """The largest difference of the ZeRO-1 moments (a layer stack one
    tensor) from the one-device trainer's (one per parameter), relative
    to the largest magnitude of each."""
    order = {k: i for i, (k, _) in enumerate(want.named_parameters())}
    err = 0.0
    for grp, m, v in zip(groups, got_state.mu, got_state.nu):
        for mine, theirs in ((m, want_state.mu), (v, want_state.nu)):
            ref = (torch.stack([theirs[order[k]] for k in grp.names])
                   if grp.stacked else theirs[order[grp.names[0]]])
            err = max(err, float((_whole(mine) - ref).abs().max()
                                 / max(float(ref.abs().max()), 1e-30)))
    return err
