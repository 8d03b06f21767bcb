"""Render the dry run's tables (``launch.dryrun --out dryrun.json``) as
Markdown: ``python -m repro_torch.roofline.report dryrun.json``.

A verbatim copy of ``repro.roofline.report`` (``tests/test_torch_copies.py``
holds the two syntax trees equal). Its ``interesting_cells`` keeps the
reference's 197e12 FLOP/s as the ideal rate, the TPU v5e's peak, so its
fractions are on that scale and not the H100's; ``dryrun_table`` prints
the reference's ``lower s``/``compile s`` columns, which a port record
lacks (they read 0.0; the port's record has ``trace_s``)."""
from __future__ import annotations

import json
import sys
from typing import List


def fmt_bytes(b: float) -> str:
    if b >= 2 ** 40:
        return f"{b / 2**40:.2f}TiB"
    if b >= 2 ** 30:
        return f"{b / 2**30:.2f}GiB"
    if b >= 2 ** 20:
        return f"{b / 2**20:.1f}MiB"
    return f"{b / 2**10:.0f}KiB"


def roofline_table(recs: List[dict], mesh: str = "16x16") -> str:
    """§Roofline: single-pod baselines, one row per (arch x shape)."""
    lines = [
        "| arch | shape | compute s | memory s | collective s | bottleneck | "
        "useful frac | mem/dev |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["mesh"] != mesh:
            continue
        if r["status"] == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"skipped | — | — |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"ERROR | — | — |")
            continue
        rl = r["roofline"]
        uf = rl.get("useful_fraction")
        mem = r.get("memory", {}).get("peak_bytes_per_device", 0)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {rl['compute_s']:.4g} | "
            f"{rl['memory_s']:.4g} | {rl['collective_s']:.4g} | "
            f"{rl['bottleneck']} | "
            f"{uf:.2f} |" .replace("None", "—") if uf is not None else
            f"| {r['arch']} | {r['shape']} | ... | — |")
        lines[-1] = (
            f"| {r['arch']} | {r['shape']} | {rl['compute_s']:.4g} | "
            f"{rl['memory_s']:.4g} | {rl['collective_s']:.4g} | "
            f"{rl['bottleneck']} | "
            f"{(uf if uf is not None else float('nan')):.2f} | "
            f"{fmt_bytes(mem)} |")
    return "\n".join(lines)


def dryrun_table(recs: List[dict]) -> str:
    """§Dry-run: both meshes, compile status + memory + collective volume."""
    lines = [
        "| arch | shape | mesh | status | lower s | compile s | mem/dev | "
        "collective bytes (global) | HLO flops (global) |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"skipped ({r['reason'][:40]}…) | — | — | — | — | — |")
            continue
        mem = r.get("memory", {}).get("peak_bytes_per_device", 0)
        coll = r.get("collectives", {}).get("total_bytes", 0)
        fl = r.get("roofline", {}).get("flops", 0)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['status']} | "
            f"{r.get('lower_s', 0):.1f} | {r.get('compile_s', 0):.1f} | "
            f"{fmt_bytes(mem)} | {fmt_bytes(coll)} | {fl:.3g} |")
    return "\n".join(lines)


def interesting_cells(recs: List[dict]) -> dict:
    """Hillclimb candidates: worst useful-fraction, most collective-bound."""
    ok = [r for r in recs if r["status"] == "ok" and r["mesh"] == "16x16"]
    def coll_ratio(r):
        rl = r["roofline"]
        t = max(rl["compute_s"], rl["memory_s"], rl["collective_s"], 1e-12)
        return rl["collective_s"] / t
    def waste(r):
        uf = r["roofline"].get("useful_fraction") or 0.0
        step = max(r["roofline"]["compute_s"], r["roofline"]["memory_s"],
                   r["roofline"]["collective_s"])
        ideal = r["roofline"]["model_flops"] / (
            r["roofline"]["chips"] * 197e12)
        return ideal / step if step else 0.0    # roofline fraction of ideal
    worst = min(ok, key=waste)
    most_coll = max(ok, key=coll_ratio)
    return {"worst_roofline": (worst["arch"], worst["shape"], waste(worst)),
            "most_collective": (most_coll["arch"], most_coll["shape"],
                                coll_ratio(most_coll)),
            "fractions": sorted(((r["arch"], r["shape"], round(waste(r), 4))
                                 for r in ok), key=lambda t: t[2])}


if __name__ == "__main__":
    recs = json.load(open(sys.argv[1] if len(sys.argv) > 1
                          else "results/dryrun.json"))
    print(dryrun_table(recs))
    print()
    print(roofline_table(recs))
    print()
    info = interesting_cells(recs)
    print("worst roofline fraction:", info["worst_roofline"])
    print("most collective-bound:", info["most_collective"])
    for t in info["fractions"][:10]:
        print("  low-fraction:", t)
