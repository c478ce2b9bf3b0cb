"""Serving launcher: random weights from a seed, then batched requests from
a synthetic prompt stream through :class:`~repro_torch.runtime.server.Server`.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b   # full config, on cuda

The port of ``repro.launch.serve``, with its flags and defaults plus
``--device``.  Without ``--smoke`` it serves the full config.  Runs on
``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, Optional, Sequence, Union

import torch

from repro_torch import config as C
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.runtime.server import Server

PARAM_SEED, PROMPT_SEED, FRONTEND_SEED, TEMPERATURE = 0, 1, 2, 0.7


def make_prompts(cfg: C.ModelConfig, batch: int, prompt_len: int,
                 device: torch.device, seed: int = PROMPT_SEED) -> torch.Tensor:
    """(batch, prompt_len) random token ids, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen,
                         device=device)


def make_frontend(cfg: C.ModelConfig, batch: int, device: torch.device,
                  seed: int = FRONTEND_SEED) -> torch.Tensor:
    """(batch, frontend_seq, d_model) bf16 standard-normal rows, drawn on
    ``device``: the stub of a vision or audio encoder's output that the
    reference's serve launcher draws for a config with a frontend."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((batch, cfg.frontend_seq, cfg.d_model), generator=gen,
                       device=device).to(torch.bfloat16)


def run(arch: str, *, smoke: bool = False, batch: int = 4, prompt_len: int = 32,
        max_new: int = 16, device: Optional[Union[str, torch.device]] = None
        ) -> Dict[str, Any]:
    """Build the model with seeded random weights and serve one prompt batch.

    A config with a frontend (internvl2-2b, seamless-m4t-large-v2) gets
    its ``frontend_emb`` rows from :func:`make_frontend`.  Returns the
    server (with its stats), the generated token ids, the prompts, the whole
    request batch, the model and its parameters.
    """
    dev = resolve_device(device)
    entry = C.get(arch)
    model_cfg = entry.smoke if smoke else entry.full
    shape = C.ShapeConfig("serve", prompt_len + max_new, batch, "prefill")
    rc = C.RunConfig(model=model_cfg, shape=shape, mesh=C.SMOKE_MESH)
    model = build_model(model_cfg)
    params = model.init(seed=PARAM_SEED, device=dev)
    server = Server(rc, params, temperature=TEMPERATURE)
    prompts = make_prompts(model_cfg, batch, prompt_len, dev)
    requests = {"tokens": prompts}
    if model_cfg.frontend != "none":
        requests["frontend_emb"] = make_frontend(model_cfg, batch, dev)
    out = server.generate(requests, max_new_tokens=max_new)
    return {"server": server, "tokens": out, "prompts": prompts, "requests": requests,
            "model": model, "params": params}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve",
                                description=__doc__.split("\n")[0])
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; fails without a GPU)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    res = run(args.arch, smoke=args.smoke, batch=args.batch,
              prompt_len=args.prompt_len, max_new=args.max_new,
              device=args.device)
    stats = res["server"].stats
    print(f"generated {res['tokens'].shape} tokens; prefill "
          f"{stats.prefill_s * 1e3:.1f} ms, decode {stats.decode_tok_per_s:.1f} "
          f"tok/s on {res['server'].device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
