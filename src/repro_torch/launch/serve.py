"""LM serving launcher on the port: batched prefill, then a greedy decode
loop over a KV cache, fp32 or int8 (counterpart of `repro.launch.serve`;
no mesh). The archs: the dense qwen3-0.6b, minitron-8b, stablelm-12b and
mistral-large-123b, and the MoE arctic-480b (128 experts top-2 beside a
dense residual FFN) and deepseek-v2-236b (MLA attention over a latent
cache, 160 experts top-6 and 2 shared), and the recurrent-state families,
the hybrid jamba-v0.1-52b (Mamba layers around one attention layer per 8,
16 experts top-2 on every other layer) and the xLSTM xlstm-125m, and the
cross-attention families, the VLM llama-3.2-vision-90b (a gated
cross-attention layer over image embeddings every 5th layer) and the
encoder-decoder whisper-tiny. As in the reference, a VLM request gets zero
image embeddings (batch, n_image_tokens, d_model) at prefill and at every
decode step, and a whisper request zero frames (batch, prompt_len,
d_model) through the encoder at prefill, then a zero encoder output of that
shape at every decode step (so its decode steps do not attend over the
encoder output its prefill made). Cross-attention layers keep no cache.
deepseek-v2's cache is its latent (c_kv, k_rope): an int8 request gives a
bf16 latent cache, as in the reference. jamba's cache is a KV cache for its
attention layers beside the Mamba layers' recurrent state (conv ring and
SSM state, fp32 for either request); xlstm's is recurrent state only, the
same for either request. The summary line says which.

Run on the card (default device "cuda"), at full width with fp32 weights
(minitron-8b takes 31 GB of the card, stablelm-12b 49 GB; mistral-large-123b
fits no single card and serves only reduced, and so do arctic-480b, whose
35 layers hold ~477 B parameters, and deepseek-v2-236b, 239 B:
`chip_smoke.py` drives arctic-480b at full width with its depth cut to one
layer, 56 GB, deepseek-v2-236b with its depth cut to two, 36 GB,
jamba-v0.1-52b with its depth cut to one interleave group of 8, 53 GB, and
llama-3.2-vision-90b, 351 GB, with its depth cut to one group of 5, 25.5 GB;
xlstm-125m and whisper-tiny serve at full width and depth):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-8b --full --kv-cache-dtype int8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-12b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m --full --prompt-len 128
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny --full --kv-cache-dtype int8
On the host, through the kernels' plain PyTorch versions (reduced config):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-8b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch arctic-480b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b --device cpu --kv-cache-dtype int8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-3.2-vision-90b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny --device cpu --kv-cache-dtype int8
"""
from __future__ import annotations

import argparse
import logging
import time
from typing import NamedTuple

import torch

from repro_torch.configs.base import DEFAULT_RUN, ModelConfig, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import model as M

log = logging.getLogger("repro_torch.serve")

KV_CACHE_DTYPES = {"float32": torch.float32, "int8": torch.int8}


class ServeResult(NamedTuple):
    tokens: torch.Tensor  # (batch, gen_len) int32, the greedy continuation
    prompt: torch.Tensor  # (batch, prompt_len) int32
    prefill_ms: float  # the prefill step, synchronised
    decode_ms: float  # mean decode step (gen_len - 1 steps), synchronised
    tok_s: float  # batch * gen_len over prefill plus decode


def cache_kind(cfg: ModelConfig, kv_cache_dtype: str) -> str:
    """What a request for `kv_cache_dtype` gets: a KV cache of that type;
    for MLA the latent cache, bfloat16 for an int8 request; for a hybrid a
    KV cache of that type beside the recurrent state; for an SSM LM the
    recurrent state alone; for a VLM and an encoder-decoder a KV cache of
    that type for the (decoder's) self-attention layers only."""
    if cfg.family == "ssm":
        return "recurrent state"
    if cfg.family == "hybrid":
        return f"{kv_cache_dtype} KV + recurrent state"
    if cfg.is_encoder_decoder:
        return f"{kv_cache_dtype} decoder KV (self-attention layers only)"
    if cfg.family == "vlm":
        return f"{kv_cache_dtype} KV (self-attention layers only)"
    if cfg.attn_type == "mla":
        return "bfloat16 latent" if kv_cache_dtype == "int8" else f"{kv_cache_dtype} latent"
    return kv_cache_dtype


def request_inputs(cfg: ModelConfig, batch: int, prompt_len: int, device) -> tuple:
    """The inputs a request carries beside its tokens, as the reference's
    `serve` makes them: ({prefill's}, {each decode step's}). VLM: zero
    `img_embeds` (batch, n_image_tokens, d_model) in both; encoder-decoder:
    zero `frames` (batch, prompt_len, d_model) at prefill, a zero `enc_out`
    of that shape at each decode step; none for the other families."""
    def zeros(s):
        return torch.zeros((batch, s, cfg.d_model), device=device)

    if cfg.family == "vlm":
        img = zeros(cfg.n_image_tokens)
        return {"img_embeds": img}, {"img_embeds": img}
    if cfg.is_encoder_decoder:
        return {"frames": zeros(prompt_len)}, {"enc_out": zeros(prompt_len)}
    return {}, {}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str | ModelConfig, *, reduced: bool = True, batch: int = 4, prompt_len: int = 32,
          gen_len: int = 32, seed: int = 0, device=None,
          kv_cache_dtype: str = "float32", params: dict | None = None) -> ServeResult:
    """`arch` is a registered arch's name (its full or reduced config) or a
    `ModelConfig` itself, such as a full-width arch with its depth cut.
    Random weights from `torch.Generator(seed)` (drawn on the host and
    moved leaf by leaf), or `params`, a tree `init_params` made for this
    config on `device`; random prompt tokens from `seed + 1`. Returns the
    generated tokens and the step times."""
    if kv_cache_dtype not in KV_CACHE_DTYPES:
        raise ValueError(f"kv_cache_dtype {kv_cache_dtype!r}: choose from "
                         f"{sorted(KV_CACHE_DTYPES)}")
    dev = resolve_device(device)
    cfg = arch if isinstance(arch, ModelConfig) else get_config(arch, reduced=reduced)
    run = DEFAULT_RUN.replace(kv_cache_dtype=kv_cache_dtype)
    if params is None:
        params = M.init_params(cfg, torch.Generator().manual_seed(seed), device=dev)
    caches = M.init_cache(cfg, batch, prompt_len + gen_len,
                          KV_CACHE_DTYPES[kv_cache_dtype], device=dev)
    prefill = make_prefill_step(cfg, run)
    step = make_serve_step(cfg, run)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt_len), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(seed + 1)).to(dev)
    pre_in, dec_in = request_inputs(cfg, batch, prompt_len, dev)

    _sync(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, caches = prefill(params, caches, {"tokens": toks, **pre_in})
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
    _sync(dev)
    t1 = time.perf_counter()
    out_tokens = [nxt]
    for i in range(gen_len - 1):
        nxt, caches = step(params, caches, {"tokens": nxt[:, None], **dec_in},
                           prompt_len + i)
        out_tokens.append(nxt)
    _sync(dev)
    t2 = time.perf_counter()
    gen = torch.stack(out_tokens, 1)
    tok_s = batch * gen_len / (t2 - t0)
    res = ServeResult(tokens=gen, prompt=toks, prefill_ms=(t1 - t0) * 1e3,
                      decode_ms=(t2 - t1) * 1e3 / max(gen_len - 1, 1), tok_s=tok_s)
    log.info("served %d seqs x %d tokens in %.2fs (%.1f tok/s): prefill %.2f ms, "
             "decode %.3f ms/step, %s cache, %s", batch, gen_len, t2 - t0, tok_s,
             res.prefill_ms, res.decode_ms, cache_kind(cfg, kv_cache_dtype), dev)
    return res


def main():
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the kernels' "
                         "plain PyTorch versions)")
    ap.add_argument("--kv-cache-dtype", choices=sorted(KV_CACHE_DTYPES),
                    default="float32")
    args = ap.parse_args()
    serve(args.arch, reduced=not args.full, batch=args.batch,
          prompt_len=args.prompt_len, gen_len=args.gen_len, seed=args.seed,
          device=args.device, kv_cache_dtype=args.kv_cache_dtype)


if __name__ == "__main__":
    main()
