"""The few calls that differ between the card and the CPU (the CPU serves
the benchmark's own tests only; a run on the CPU reports nothing)."""
from __future__ import annotations

import gc

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def allocated(device: torch.device) -> int:
    return torch.cuda.memory_allocated(device) \
        if device.type == "cuda" else 0


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def release(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def profiler_activities(device: torch.device):
    from torch.profiler import ProfilerActivity
    return [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
