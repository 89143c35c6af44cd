"""Batched serving driver of the LM substrate: prefill and incremental decode
with a KV cache.

  python -m repro_torch.launch.serve --arch llama3.2-3b --batch 4 --prompt-len 16 --gen 32
  python -m repro_torch.launch.serve --arch mamba2-1.3b --smoke --device cpu

The JAX package's ``launch/serve.py`` flow: initialise the model from
``--seed``, draw the prompts, run the encoder for ``encdec``, prefill by
stepping the decode one prompt token at a time, then decode ``--gen`` tokens
greedily (``--temperature 0``) or by sampling, and print the same line.  It
runs on the card unless ``--device cpu`` is given; without CUDA and without
that flag it raises.

One difference from the reference, by design: the cache takes the
parameters' dtype.  The reference builds an f32 cache, into which a bf16
model's first decode step cannot write (``lax.dynamic_update_slice`` refuses
mixed dtypes), so it serves only the f32 ``--smoke`` configs.

:func:`generate` is the generation loop, callable with given weights and
prompts.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import all_archs, get_config
from repro_torch.models import model as M
from repro_torch.models.steps import make_serve_step


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor                    # int64 [B, G], the generated tokens
    prompt_len: int
    prefill_s: float                        # stepping through the prompt
    decode_s: float                         # the G decode steps
    prompt_logits: Optional[torch.Tensor]   # [B, P, V_padded] decode logits at the prompt

    @property
    def tokens_per_s(self) -> float:
        """Prompt and generated tokens over the whole wall, as the reference
        prints it ("incl. prefill")."""
        B, G = self.tokens.shape
        return B * (self.prompt_len + G) / max(self.prefill_s + self.decode_s, 1e-12)


def _next_token(cfg: ModelConfig, logits: torch.Tensor, temperature: float,
                generator: torch.Generator) -> torch.Tensor:
    """[B, 1] tokens from the last position's logits: argmax, or a draw at
    ``temperature`` (the Gumbel-max form of ``jax.random.categorical``)."""
    last = logits[:, -1, : cfg.vocab].float()
    if temperature > 0:
        u = torch.rand(last.shape, generator=generator, device=last.device)
        last = last / temperature - torch.log(-torch.log(u.clamp_min(1e-20)))
    return last.argmax(dim=-1, keepdim=True)


@torch.no_grad()
def generate(cfg: ModelConfig, params, prompts: torch.Tensor, gen: int, *,
             temperature: float = 0.0, seed: int = 0,
             frames: Optional[torch.Tensor] = None,
             keep_prompt_logits: bool = False) -> Generation:
    """Serve ``prompts`` (int [B, P] on the parameters' device): prefill by
    stepping, then ``gen`` decode steps.  ``frames`` ([B, enc_context, d])
    feed the encoder of an ``encdec`` model.  The cache takes the
    parameters' dtype.  With ``keep_prompt_logits`` the decode logits at
    every prompt position are kept (to hold against a full forward)."""
    dev = prompts.device
    B, P = prompts.shape
    cache = M.init_cache(cfg, B, P + gen, params["embed"].dtype, dev)
    if cfg.family == "encdec":
        if frames is None:
            raise ValueError("an encdec model needs frames for its encoder")
        cache = M.encode(cfg, params, frames, cache)
    step = make_serve_step(cfg)
    g = device_mod.generator(dev, seed, 1)

    t0 = time.perf_counter()
    kept = []
    logits = None
    for t in range(P):
        logits, cache = step(params, cache, prompts[:, t: t + 1], t)
        if keep_prompt_logits:
            kept.append(logits[:, 0])
    device_mod.synchronize(dev)
    t1 = time.perf_counter()
    out = []
    tok = _next_token(cfg, logits, 0.0, g)
    for t in range(P, P + gen):
        out.append(tok[:, 0])
        logits, cache = step(params, cache, tok, t)
        tok = _next_token(cfg, logits, temperature, g)
    tokens = torch.stack(out, dim=1) if out else torch.zeros((B, 0), dtype=torch.int64,
                                                             device=dev)
    device_mod.synchronize(dev)
    return Generation(tokens=tokens, prompt_len=P, prefill_s=t1 - t0,
                      decode_s=time.perf_counter() - t1,
                      prompt_logits=torch.stack(kept, dim=1) if keep_prompt_logits else None)


def draw_inputs(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
                device: torch.device):
    """The launcher's prompts (uniform over the vocabulary) and, for
    ``encdec``, f32 frame embeddings, from ``seed``."""
    g = device_mod.generator(device, seed, 2)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g, device=device)
    frames = None
    if cfg.family == "encdec":
        frames = torch.randn((batch, cfg.enc_context, cfg.d_model), generator=g,
                             device=device)
    return prompts, frames


def main(argv: Optional[Sequence[str]] = None) -> Generation:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b", choices=all_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)

    cfg = get_config(args.arch, smoke=args.smoke)
    model = M.init(cfg, args.seed, dev)
    prompts, frames = draw_inputs(cfg, args.batch, args.prompt_len, args.seed, dev)
    res = generate(cfg, model.params(), prompts, args.gen, temperature=args.temperature,
                   seed=args.seed, frames=frames)
    gen = res.tokens.cpu().numpy()
    print(f"arch={cfg.name} generated {gen.shape} tokens in "
          f"{res.prefill_s + res.decode_s:.2f}s ({res.tokens_per_s:.1f} tok/s incl. prefill)")
    print("first sequence:", np.asarray(gen[0][:16]), "...")
    return res


if __name__ == "__main__":
    main()
