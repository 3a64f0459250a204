"""Serving entry point of the LM stack: random weights packed to 1 bit (paper
§3.1), a prompt batch prefilled, greedy tokens decoded over the KV
cache and the SSM state. As ``repro.launch.serve``, on CUDA unless
``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch jamba-1.5-large-398b --batch 4 --prompt-len 32 --gen 16 --device cpu

Prompts longer than 256 tokens must be a multiple of 256 (the mamba
prefill chunk). Every family of the JAX package serves: a config fed by
embeddings (pixtral-12b) is prompted with ``[batch, prompt_len,
d_model]`` normal patch embeddings, the encoder-decoder
(seamless-m4t-large-v2) with as many frame embeddings and a token
prompt; decode feeds tokens.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch

from repro_torch.configs.base import float_policy, get_config, serve_policy, smoke_config
from repro_torch.core.bnn import resolve_device
from repro_torch.models.model_factory import build_model

CACHE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def _clock(dev: torch.device) -> Callable[[], float]:
    """Seconds, read after the device has finished the work queued so far."""
    def now() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()
    return now


def serve_config(cfg, policy, *, batch: int = 4, prompt_len: int = 32,
                 gen: int = 16, seed: int = 0, cache_dtype=torch.float32,
                 device=None, params=None,
                 on_step: Optional[Callable] = None) -> dict:
    """Serve one prompt batch on ``cfg`` under ``policy``.

    ``params``: the model's params; by default drawn from a
    ``torch.Generator`` on the device seeded with ``seed`` (``init_packed``
    under a packed policy, else ``init``). Prompts come from a CPU
    generator seeded with ``seed``, and after them, for a config fed by
    embeddings, ``[batch, prompt_len, d_model]`` float32 normal
    embeddings from the same generator (the JAX serve batch: the
    embeddings alone, or beside the prompts for encdec). ``on_step(step,
    logits)`` is called after the prefill (step 0) and after each decode
    step, with that step's logits ``[batch, vocab]``. Returns the prompts, the prefill's
    inputs (``batch``), the generated tokens ``[batch, gen]`` and the
    prefill and decode times (seconds, the device synchronized)."""
    dev = resolve_device(device)
    model = build_model(cfg, policy)
    if params is None:
        weights = torch.Generator(device=dev).manual_seed(seed)
        params = (model.init_packed(weights) if policy.packed
                  else model.init(weights))
    host = torch.Generator().manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=host).to(dev)
    batch_in = {"tokens": prompts}
    if cfg.input_kind == "embeddings":
        embeds = torch.randn((batch, prompt_len, cfg.d_model), generator=host)
        batch_in = {"input_embeds": embeds.to(dev)}
        if cfg.family == "encdec":
            batch_in["tokens"] = prompts
    state = model.init_state(batch, prompt_len + gen, dtype=cache_dtype,
                             device=dev)
    now = _clock(dev)

    with torch.inference_mode():
        t0 = now()
        logits, state = model.prefill(params, state, batch_in)
        t_prefill = now() - t0
        if on_step is not None:
            on_step(0, logits)
        tokens = logits.argmax(-1)[:, None]
        generated = [tokens]
        t0 = now()
        for step in range(1, gen):
            logits, state = model.decode_step(params, state, {"tokens": tokens})
            if on_step is not None:
                on_step(step, logits)
            tokens = logits.argmax(-1)[:, None]
            generated.append(tokens)
        t_decode = now() - t0
    return {
        "prompts": prompts,
        "batch": batch_in,
        "tokens": torch.cat(generated, dim=1),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
    }


def serve(arch: str, *, smoke: bool = True, batch: int = 4,
          prompt_len: int = 32, gen: int = 16, quantized: bool = True,
          seed: int = 0, cache_dtype=torch.float32, device=None) -> dict:
    cfg = smoke_config(arch) if smoke else get_config(arch)
    policy = serve_policy() if quantized else float_policy()
    return serve_config(cfg, policy, batch=batch, prompt_len=prompt_len,
                        gen=gen, seed=seed, cache_dtype=cache_dtype,
                        device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="jamba-1.5-large-398b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--float", dest="quantized", action="store_false")
    ap.add_argument("--cache-dtype", default="f32", choices=sorted(CACHE_DTYPES),
                    help="KV-cache storage dtype")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain-"
                         "torch path on the CPU)")
    args = ap.parse_args(argv)
    r = serve(args.arch, smoke=args.smoke, batch=args.batch,
              prompt_len=args.prompt_len, gen=args.gen,
              quantized=args.quantized, seed=args.seed,
              cache_dtype=CACHE_DTYPES[args.cache_dtype], device=args.device)
    print("generated shape", tuple(r["tokens"].shape))
    print(f"prefill {r['prefill_s']:.2f}s  decode {r['decode_s']:.2f}s  "
          f"{r['tok_per_s']:.1f} tok/s")


if __name__ == "__main__":
    main()
