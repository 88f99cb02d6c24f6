"""Serving entry point: prefill a batch of prompts, then batched greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --full --batch 8 --prompt-len 1024 --gen 32

Runs on the card unless ``--device cpu`` is given. Weights are random,
fp32 (``--dtype bfloat16`` for bf16, the reference's default dtype, in
which the decode cache is bf16 too), from the port's ``init_params``
seeded with 0; prompts come from a second
``torch.Generator`` seeded with 1. A config with a stub frontend
(qwen2-vl's image patches, musicgen's conditioning frames) gets a prefix
of ``n_stub_tokens`` zero embeddings before each prompt, as the
reference's ``launch/serve.py`` feeds it. :func:`serve` is the one
function the CLI, the tests and ``chip_smoke.py`` call.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch.profiler import record_function

from repro_torch.configs import ModelConfig, get_config
from repro_torch.device import disable_tf32, resolve_device
from repro_torch.models.model import decode, init_cache, init_params, prefill

# the params' dtypes the drivers' --dtype takes
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class ServeResult:
    tokens: torch.Tensor     # (B, gen) greedy tokens, the first from prefill
    logits: torch.Tensor     # (gen, B, V) fp32: prefill's, then each step's
    timings: Dict[str, float]


def make_prompts(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
                 device: str | torch.device = "cuda") -> torch.Tensor:
    """(batch, prompt_len) int64 tokens, uniform over the vocab, drawn on
    the CPU so that every device gets the same prompts."""
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen)
    return toks.to(resolve_device(device))


def stub_prefix(cfg: ModelConfig, batch: int,
                device: str | torch.device) -> Optional[torch.Tensor]:
    """The stub frontend's output that :func:`serve` feeds: zeros (batch,
    n_stub_tokens, d_model) fp32, as the reference's ``launch/serve.py``;
    None for a config without a stub frontend."""
    if not cfg.n_stub_tokens:
        return None
    return torch.zeros((batch, cfg.n_stub_tokens, cfg.d_model),
                       device=device)


def prefill_to_cache(params: Dict, cfg: ModelConfig, prompts: torch.Tensor,
                     max_len: int, *, window: int = 0,
                     stub_embeds: Optional[torch.Tensor] = None):
    """Prefill ``prompts`` (B, P), after ``stub_embeds`` when given (the
    prefill then holds n_stub + P positions, and ``max_len`` must count
    them), and move the prefill KV into a decode cache of ``max_len``
    positions (a ring of min(window, max_len) slots when windowed), in
    the params' dtype, ``dense_layers`` and a hybrid's ``shared_attn``
    included; an ssm or hybrid config's ``ssm`` states (h and the conv
    window) are states, not positions, and are copied whole. Returns
    (last-token logits, cache). MLA's prefill keeps
    full-length latents under a window, as the reference's does; a prompt
    longer than the window therefore does not fit the ring, and raises
    (the reference's ``launch/serve.py`` drops that prefill cache: ROADMAP
    Queue C, C4)."""
    logits, pcache = prefill(params, cfg, prompts, stub_embeds=stub_embeds,
                             window=window)
    cache = init_cache(cfg, prompts.shape[0], max_len, window=window,
                       device=prompts.device, dtype=params["embed"].dtype)
    for group, entries in cache.items():
        for name, c in entries.items():
            pc = pcache[group][name]
            if group == "ssm":                  # states, not positions
                c.copy_(pc)
            elif pc.shape[2] > c.shape[2]:
                if not window:   # the reference drops it (ROADMAP C5)
                    raise ValueError(
                        f"{cfg.name}: the prefill holds {pc.shape[2]} "
                        f"positions, more than the cache's max_len "
                        f"{c.shape[2]}")
                raise NotImplementedError(
                    f"{cfg.name}: the prefill's {name!r} holds "
                    f"{pc.shape[2]} positions, the decode ring "
                    f"{c.shape[2]} (ROADMAP Queue C, C4)")
            else:
                c[:, :, :pc.shape[2]] = pc
    return logits, cache


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def serve(cfg: ModelConfig, params: Dict, prompts: torch.Tensor, gen: int, *,
          window: int = 0, device: str | torch.device = "cuda",
          stub_embeds: Optional[torch.Tensor] = None) -> ServeResult:
    """Prefill ``prompts`` (B, P) after the stub prefix (``stub_embeds``
    (B, n_stub, D), default :func:`stub_prefix`'s zeros; n_stub = 0
    without a stub frontend) into a cache of n_stub + P + gen positions
    (:func:`prefill_to_cache`), then decode greedily
    from position n_stub + P on: ``gen`` tokens in all, the first from the
    prefill's logits and one per decode step after it. (The reference's
    ``launch/serve.py`` sizes its cache at P + gen, which drops the
    prefill's cache whenever n_stub > gen: ROADMAP Queue C, C5.) Timings
    are host milliseconds around work that ends in a device sync; the two
    phases are ``torch.profiler`` ranges ``serve.prefill`` and
    ``serve.decode``."""
    dev = resolve_device(device)
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    B, P = prompts.shape
    stub = stub_prefix(cfg, B, dev) if stub_embeds is None else stub_embeds
    start = P + (stub.shape[1] if cfg.n_stub_tokens
                 else 0)                   # the first decode position
    _sync(dev)
    t0 = time.perf_counter()
    with record_function("serve.prefill"):
        logits, cache = prefill_to_cache(params, cfg, prompts, start + gen,
                                         window=window, stub_embeds=stub)
        _sync(dev)
    t1 = time.perf_counter()

    token = torch.argmax(logits, dim=-1)[:, None]
    tokens, step_logits = [token], [logits]
    with record_function("serve.decode"):
        for i in range(gen - 1):
            logits, cache = decode(params, cfg, token, cache, start + i,
                                   window=window)
            token = torch.argmax(logits, dim=-1)[:, None]
            tokens.append(token)
            step_logits.append(logits)
        _sync(dev)
    t2 = time.perf_counter()
    steps = gen - 1
    decode_ms = (t2 - t1) * 1e3
    timings = {"prefill_ms": (t1 - t0) * 1e3,
               "decode_ms_per_step": decode_ms / steps if steps else 0.0,
               "decode_tok_per_s": steps * B / (decode_ms / 1e3)
               if steps else 0.0}
    return ServeResult(torch.cat(tokens, dim=1), torch.stack(step_logits),
                       timings)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true",
                    help="the published widths and depth (else reduced())")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32",
                    help="the params' and the cache's dtype (the reference's "
                    "launch/serve.py runs fp32; its init_params defaults to "
                    "bf16)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    disable_tf32()
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                         DTYPES[args.dtype])
    prompts = make_prompts(cfg, args.batch, args.prompt_len, 1, dev)
    res = serve(cfg, params, prompts, args.gen, window=args.window,
                device=dev)
    t = res.timings
    print(f"prefill: {t['prefill_ms']:.2f} ms")
    print(f"decode: {args.gen - 1} steps, {t['decode_ms_per_step']:.3f} ms "
          f"per step ({t['decode_tok_per_s']:.1f} tok/s)")
    print("sample tokens:", res.tokens[0, :16].tolist())


if __name__ == "__main__":
    main()
