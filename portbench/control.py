#!/usr/bin/env python3
"""The readings the limits of ``limits/<cell>.json`` are set from, at the
cell's own size, on the card:

* the program's sound runs on ``--seeds`` seeds (the lower readings);
* the control, the reference in the program's place computed in float8
  e4m3 (``reference.precision.CONTROL``), on ``--control-seeds`` seeds
  (the upper readings);
* for a training cell, the fault "half of the batch left out, the mean
  taken over the rest", planted in the program, on ``--control-seeds``
  seeds (a state left unchanged reads 1 by the check's measure and needs
  no run).

  python3 portbench/control.py --workload minicpm-2b.train-512 \\
      --seeds 12 --control-seeds 3 --first-seed 1000

One JSON line a reading on standard output (with what lies behind it
under ``detail``), then a summary line: each number's largest sound
reading and smallest control and fault reading.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def half_batch(api):
    """The port's loss on the first half of the rows (of the positions of
    a one-row batch), its mean taken over them alone."""
    loss = api.loss

    def half(params, batch):
        B, S = batch["tokens"].shape
        cut = (lambda t: t[:B // 2]) if B > 1 else (lambda t: t[:, :S // 2])
        return loss(params, {k: cut(v) for k, v in batch.items()})
    api.loss = half
    return api


def train_readings(cell, seed, device, kind):
    from portbench import check, device as D, port
    from portbench.drivers import train as T
    from portbench.reference.precision import CONTROL
    if kind == "control":
        ctrl = T.reference(cell, seed, device, CONTROL)
        D.release(device)
        ref = T.reference(cell, seed, device)
        D.release(device)
        return dict(check.train_numbers(ctrl, ref),
                    detail=check.train_detail(ctrl, ref))
    build = port.api
    if kind == "half_batch":
        port.api = lambda cfg: half_batch(build(cfg))
    try:
        prog = T.Program(cell, seed, device)
        readings = T.checked_steps(prog)
    finally:
        port.api = build
    del prog
    D.release(device)
    ref = T.reference(cell, seed, device)
    D.release(device)
    return dict(check.train_numbers(readings, ref),
                detail=check.train_detail(readings, ref))


def prefill_readings(cell, seed, device, kind):
    import torch
    from portbench import device as D, traffic, weights
    from portbench.drivers import prefill as P
    from portbench.reference import model as ref_model
    from portbench.reference.precision import CONTROL
    from portbench.spec import model_spec
    picked = P.sample(cell.mix, seed)
    spec = model_spec(cell.conf)
    outputs = {}
    if kind == "control":
        tree = weights.make_tree(spec, seed, device)
        lens = P.lengths_upto(cell.mix, seed, max(picked) + 1)
        for i, rows in picked.items():
            tokens = traffic.prompts(cell.mix, spec.vocab, seed, i, lens[i],
                                     device)
            ks, vs = [], []
            logits = ref_model.prefill(
                spec, tree, tokens, CONTROL,
                lambda layer, k, v, r=rows: (ks.append(k[r]), vs.append(v[r])))
            outputs[i] = (logits, torch.tensor(rows, device=device),
                          torch.stack(ks), torch.stack(vs))
        del tree
    else:
        prog = P.Program(cell, seed, device)
        kept = P.Kept(cell.mix, spec, seed, device, picked)
        P.window(prog, kept, 0.0)
        outputs = {i: (kept.logits[i], kept.rows[i], kept.k[i], kept.v[i])
                   for i in kept.rows}
        del prog, kept
    D.release(device)
    tally = P.reference(cell, seed, device, outputs)
    D.release(device)
    return dict(tally.n, detail={
        "kv_by_layer": [round(tally.kv_by_layer[i], 6)
                        for i in sorted(tally.kv_by_layer)],
        "request_errs": sorted(round(e, 6) for e in tally.request_errs)})


def main(argv=None, device=None, cell=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=1000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from portbench import harness
    cell = cell or harness.load_cell(args.workload)
    if device is None:
        if not torch.cuda.is_available():
            print("control: needs a CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train = cell.mix["kind"] == "train"
    readings = train_readings if train else prefill_readings
    plan = [("program", args.first_seed + i) for i in range(args.seeds)]
    plan += [(k, args.first_seed + 100 + i)
             for k in (("control", "half_batch") if train else ("control",))
             for i in range(args.control_seeds)]
    rows = []
    for kind, seed in plan:
        t = time.perf_counter()
        numbers = readings(cell, seed, device, kind)
        row = {"workload": cell.name, "kind": kind, "seed": seed,
               "numbers": numbers, "seconds": time.perf_counter() - t}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": cell.name, "summary": {}}
    for name in [n for n in rows[0]["numbers"] if n != "detail"]:
        by = lambda k: [r["numbers"][name] for r in rows  # noqa: E731
                        if r["kind"] == k]
        summary["summary"][name] = {
            k: (max if k == "program" else min)(by(k))
            for k in dict.fromkeys(r["kind"] for r in rows)}
    if device.type == "cuda":
        summary["device"] = torch.cuda.get_device_name(device)
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            for row in rows + [summary]:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
