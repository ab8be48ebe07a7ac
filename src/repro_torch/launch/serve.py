"""LM serving launcher: batched prefill, then a decode loop. Counterpart of
``repro/launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-medium \
      --smoke --device cpu --requests 2 --prompt-len 32 --gen 4
  # the moe, ssm, hybrid, local_global and vlm families: --arch
  # kimi-k2-1t-a32b, mamba2-1.3b, hymba-1.5b, gemma2-2b, qwen2-vl-72b (an
  # ssm or hybrid prompt needs at least conv_width - 1 tokens, ROADMAP C;
  # gemma2-2b's published config pads its heads and is refused, ROADMAP C:
  # --smoke runs)
  # tensor parallel over 'model' (every family but the extra_dp
  # configs; mamba2's SSD over its heads): --model 2 serves over a
  # (1, 2) mesh of the first two visible cards (fewer raise); --device
  # cuda:0 runs both ranks on that card, and on the CPU the device
  # repeats
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-72b \
      --smoke --device cpu --model 2 --requests 2 --prompt-len 32 --gen 4

Runs on the card unless ``--device cpu``. Inputs come from
``np.random.default_rng(0)`` exactly as in the reference launcher (for a
frontend arch every decode step takes fresh random embeddings, not the
sampled token), so with the same weights the two packages' logits depend
on the weights and that numpy stream only. Weights come from the port's
own seeded init (``--seed``; ``transformer.init_params``) or, from a
caller, the reference's tree carried by ``params_from_numpy``. Sampling
draws from a ``torch.Generator`` seeded with ``seed + 1``, a stream that
differs from the reference's ``jax.random.categorical``.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.device import device_arg, resolve_device
from repro_torch.distributed import tensor_parallel
from repro_torch.kernels import flash_attention
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import serving, ssm, steps, transformer


def _positions(cfg, b, s, start_pos, device):
    pos = np.arange(start_pos, start_pos + s, dtype=np.int32)[None].repeat(b,
                                                                          0)
    if cfg.mrope:
        pos = np.stack([pos] * 3, -1)
    return torch.from_numpy(pos).to(device)


def _frontend_inputs(cfg, b, s, rng, device) -> Dict[str, torch.Tensor]:
    out = {"embeddings": torch.from_numpy(
        rng.random((b, s, cfg.frontend_dim), np.float32)).to(device)}
    if cfg.adc.enable:
        out["adc_mask"] = torch.ones((cfg.frontend_dim, 2 ** cfg.adc.bits),
                                     dtype=torch.int32, device=device)
    return out


def make_batch(cfg, b, s, start_pos=0, rng=None, device=None):
    """Prompt inputs: frontend embeddings (uniform [0, 1), all ADC levels
    kept) or tokens, and positions start_pos.. (B, S); under M-RoPE the
    three components equal, (B, S, 3), as in the reference launcher
    (``data.lm.mrope_grid_positions`` builds a vision grid's)."""
    rng = rng or np.random.default_rng(0)
    if cfg.frontend:
        out = _frontend_inputs(cfg, b, s, rng, device)
    else:
        out = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)).to(
                device)}
    out["positions"] = _positions(cfg, b, s, start_pos, device)
    return out


def token_to_batch(cfg, tokens, pos_scalar, b, rng, device=None):
    """Next-step decode inputs from sampled tokens (B,)."""
    if cfg.frontend:
        out = _frontend_inputs(cfg, b, 1, rng, device)
    else:
        out = {"tokens": tokens[:, None].to(device=device, dtype=torch.int32)}
    out["positions"] = _positions(cfg, b, 1, pos_scalar, device)
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg, params, *, requests: int, prompt_len: int, gen: int,
          temperature: float = 1.0, device=None, seed: int = 0, mesh=None
          ) -> Tuple[np.ndarray, Dict]:
    """Prefill ``requests`` prompts of ``prompt_len``, then decode ``gen``
    tokens each, over ``mesh`` (a mesh whose plan,
    ``serving.serving_plan``, placed ``params``; its first device is
    where the inputs and logits live) or on ``device``. Returns the
    (requests, gen) generated matrix and a dict: prefill_s, decode_s
    (host clock around synchronised work), prefill_tokens_per_s,
    decode_ms_per_token, the flash-attention kernels' launches (either
    route) in the prefill and in the decode loop, and the float32 logits
    (prefill's last position, then one array per decode step)."""
    dev = mesh_lib.work_device(device, mesh)
    rng = np.random.default_rng(0)
    prefill = steps.make_prefill_step(cfg, mesh)
    decode = steps.make_decode_step(cfg, mesh)
    b, s = requests, prompt_len
    batch = make_batch(cfg, b, s, rng=rng, device=dev)
    count0 = flash_attention.total_launches()
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    count1 = flash_attention.total_launches()
    gen_rng = torch.Generator(device=dev)
    gen_rng.manual_seed(seed + 1)
    toks, all_logits = [], [logits]
    t0 = time.perf_counter()
    for i in range(gen):
        probs = torch.softmax(logits / temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=gen_rng)[:, 0]
        toks.append(nxt)
        step_batch = token_to_batch(cfg, nxt, s + i, b, rng, device=dev)
        logits, cache = decode(params, step_batch, cache)
        all_logits.append(logits)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    count2 = flash_attention.total_launches()
    out = (torch.stack(toks, 1).cpu().numpy() if toks
           else np.zeros((b, 0), np.int64))
    info = {"prefill_s": t_prefill, "decode_s": t_decode,
            "prefill_tokens_per_s": b * s / t_prefill,
            "decode_ms_per_token": t_decode / max(gen, 1) * 1e3,
            "prefill_flash_launches": count1 - count0,
            "decode_flash_launches": count2 - count1,
            "logits": [lg.cpu().numpy() for lg in all_logits]}
    return out, info


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--device", type=device_arg, default="cuda",
                    help="cuda, cuda:N (that card alone) or cpu")
    ap.add_argument("--model", type=int, default=1,
                    help="tensor parallelism: serve over a (1, N) mesh "
                         "('model' axis N) of the first N visible cards "
                         "(cuda), or of one device repeated (cuda:N, "
                         "cpu)")
    ap.add_argument("--seed", type=int, default=0,
                    help="weights (port's own init) and sampling stream")
    return ap


def main(argv=None, params=None) -> Tuple[np.ndarray, Dict]:
    """The CLI. ``params``: the reference's parameter tree as numpy
    arrays, carried over with ``params_from_numpy`` in place of the
    port's own seeded init (parity tests)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    try:
        transformer.check_supported(cfg)
        if cfg.ssm is not None:
            ssm.check_prompt(args.prompt_len, cfg.ssm)
    except (NotImplementedError, ValueError) as exc:
        ap.error(str(exc))
    try:
        dev = resolve_device(args.device)
        mesh = plan = None
        if args.model > 1:
            mesh = mesh_lib.make_host_mesh(1, args.model, device=dev)
            plan = serving.serving_plan(cfg, mesh)
            dev = mesh.first_device
    except RuntimeError as exc:
        ap.error(str(exc))
    except NotImplementedError as exc:
        ap.error(str(exc))
    if params is None:
        tree = transformer.init_params(cfg, seed=args.seed, device=dev,
                                       plan=plan)
    else:
        tree = transformer.params_from_numpy(params, cfg, device=dev,
                                             plan=plan)
    gen, info = serve(cfg, tree, requests=args.requests,
                      prompt_len=args.prompt_len, gen=args.gen,
                      temperature=args.temperature, device=dev,
                      seed=args.seed, mesh=mesh)
    where = dev if mesh is None else mesh_lib.describe(mesh)
    if mesh is not None:
        where += (f", weight bytes a rank "
                  f"{tensor_parallel.weight_bytes(tree)}")
    print(f"prefill: {args.requests}x{args.prompt_len} in "
          f"{info['prefill_s']:.2f}s; decode: {args.gen} steps in "
          f"{info['decode_s']:.2f}s ({info['decode_ms_per_token']:.0f} "
          f"ms/tok) on {where}")
    print("generated token matrix:\n", gen)
    if gen.shape != (args.requests, args.gen):
        raise RuntimeError(f"generated {gen.shape}, expected "
                           f"{(args.requests, args.gen)}")
    if not all(np.isfinite(lg).all() for lg in info["logits"]):
        raise RuntimeError("non-finite logits")
    return gen, info


if __name__ == "__main__":
    main()
