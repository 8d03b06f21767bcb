"""LM serving launch driver: prefill + greedy decode with KV caches and
SSM states (counterpart of ``repro.launch.serve_lm``; every family, a
vlm on tokens only and whisper on the stub frontend's frames, as in the
reference).

Not to be confused with ``repro_torch.serve`` (the always-on CGRA kernel
serving engine): this module batch-serves *language models*. It runs on
the card unless ``--device cpu`` is passed:

  python -m repro_torch.launch.serve_lm --arch minicpm-2b
  python -m repro_torch.launch.serve_lm --arch granite-moe-3b-a800m
  python -m repro_torch.launch.serve_lm --arch mamba2-1.3b
  python -m repro_torch.launch.serve_lm --arch zamba2-2.7b
  python -m repro_torch.launch.serve_lm --arch whisper-base
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch minicpm-2b \\
      --reduced --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import get_arch
from repro_torch.data.pipeline import stub_frames
from repro_torch.models import encdec, hybrid, ssm, transformer
from repro_torch.models.api import ModelAPI, build_model


def init_decode_state(cfg, batch: int, max_len: int, device="cuda"):
    """The zeroed decode state of ``cfg``'s family: the KV caches (dense,
    moe, vlm), the SSM states (ssm) or both (hybrid). The audio family's
    state holds the encoder's output: :func:`encode_state` builds it, as
    the reference builds it in ``main``."""
    if cfg.family in ("dense", "moe", "vlm"):
        return transformer.init_caches(cfg, batch, max_len, device=device)
    if cfg.family == "ssm":
        return ssm.init_lm_states(cfg, batch, device)
    if cfg.family == "hybrid":
        return hybrid.init_decode_state(cfg, batch, max_len, device)
    raise ValueError(cfg.family)


def encode_state(cfg, params, batch: int, max_len: int, device="cuda"):
    """Whisper's decode state as the reference's ``main`` builds it: the
    stub frames (step 0) in the config's dtype, encoded, and zeroed
    caches ``max_len`` long."""
    frames = torch.from_numpy(stub_frames(batch, cfg.encdec.enc_len,
                                          cfg.d_model))
    frames = frames.to(device=device, dtype=cfg.torch_dtype)
    return (encdec.encode(params, cfg, frames),
            encdec.init_caches(cfg, batch, max_len, device))


def generate(api: ModelAPI, params, prompt: torch.Tensor, gen: int) -> Dict:
    """Prefill by repeated ``decode_step`` over the prompt (the decode
    state's warm-up, as in the reference), then ``gen`` greedy steps.
    Returns the generated tokens (B, gen) on the host, the last logits,
    the decode state and the two phases' seconds (each ending in a
    synchronise). Whisper's encoder runs inside the timed prefill, as in
    the reference."""
    cfg, device = api.cfg, prompt.device
    B, S = prompt.shape

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    if cfg.family == "audio":
        state = encode_state(cfg, params, B, S + gen + 1, device)
    else:
        state = init_decode_state(cfg, B, S + gen + 1, device)
    logits = None
    for t in range(S):
        logits, state = api.decode_step(params, state, prompt[:, t:t + 1], t)
    sync()
    prefill_s = time.perf_counter() - t0

    out: List[np.ndarray] = []
    t0 = time.perf_counter()
    cur = torch.argmax(logits, -1)[:, None]
    for t in range(gen):
        out.append(cur[:, 0].cpu().numpy())
        logits, state = api.decode_step(params, state, cur, S + t)
        cur = torch.argmax(logits, -1)[:, None]
    sync()
    decode_s = time.perf_counter() - t0
    tokens = np.stack(out, 1)
    if not (np.all(tokens >= 0) and np.all(tokens < cfg.vocab)):
        raise RuntimeError("serve_lm: padded-vocab leak!")
    return {"tokens": tokens, "logits": logits, "state": state,
            "prefill_s": prefill_s, "decode_s": decode_s,
            "ms_per_token": decode_s / gen * 1e3}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve_lm: --device cuda needs a CUDA device and "
                           "none is available (pass --device cpu)")
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = build_model(cfg)
    params = api.init_params(torch.Generator(device).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    B, S = args.batch, args.prompt_len
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)).to(device)

    with torch.inference_mode():
        res = generate(api, params, prompt, args.gen)
    print(f"[serve] arch={cfg.arch_id} batch={B} prompt={S} gen={args.gen} "
          f"device={device}")
    print(f"[serve] prefill {res['prefill_s']:.2f}s, decode "
          f"{res['ms_per_token']:.1f} ms/token/batch")
    print(f"[serve] sample generations (token ids): "
          f"{res['tokens'][0][:12].tolist()}")
    return dict(res, cfg=cfg, api=api, params=params, prompt=prompt)


if __name__ == "__main__":
    main()
