"""Serve a model with the port's chunked-prefill continuous batcher (the
PyTorch/CUDA counterpart of ``examples/serve.py``: the same flags and the
same summary).

    python examples/serve_torch.py --device cpu --arch moe_tiny \
        --capacity-factor 1.25 --packed          # the plain path on the CPU
    python examples/serve_torch.py --arch mixtral-8x22b --full-config \
        --layers 12 --cache paged --packed --capacity-factor 1.25 \
        --prompt-len 256 --requests 8 --new-tokens 32 --chunk-size 64 \
        --token-budget 256                       # on the card (CUDA, default)

Initializes a model (``--arch``: a smoke config, or with ``--full-config``
the published config at full width, cut to ``--layers`` layers, with bf16
parameters; the demo decoder otherwise) with random weights from seed 0,
or loads its parameters from a checkpoint directory either package wrote
(``--ckpt``, the ``params`` subtree), and pushes a stream of requests
through ``ContinuousBatcher``: prompts are prefilled ``--chunk-size``
tokens per engine step, and each step's total work is capped at
``--token-budget`` scheduled tokens — the serving analogue of
DropCompute's compute threshold ``tau`` (overflow prefill chunks are
deferred, decode slots never stall).  ``--capacity-factor`` serves an MoE
model through fixed per-expert buffers and prints the routes dropped.
This file imports neither ``jax`` nor ``repro``.
"""
import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch import resolve_device, synchronize  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import ModelConfig  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatcher,
    DraftModelProposer,
    NGramProposer,
    Request,
    SamplingParams,
    SpecConfig,
)
from repro_torch.train import checkpoint  # noqa: E402

#: the reference example's demo model and draft model (``serve.py:126-154``)
DEMO = ModelConfig(name="serve-demo", n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
                   d_ff=256, vocab_size=1003, sliding_window=64, layer_pattern="LG",
                   dtype="float32", remat=False)
DRAFT = ModelConfig(name="serve-draft", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                    d_ff=128, vocab_size=DEMO.vocab_size, sliding_window=64,
                    layer_pattern="LG", dtype="float32", remat=False)


def seeded_prompts(n: int, prompt_len: int, vocab: int, seed: int = 1,
                   shared_prefix: int = 0):
    """The reference workload's prompts (``benchmarks/common.py``
    ``seeded_prompts``): ``n`` uniform draws from ``seed``, all starting
    with the same ``shared_prefix`` tokens (drawn first)."""
    rng = np.random.default_rng(seed)
    n_prefix = min(shared_prefix, max(prompt_len - 1, 0))
    prefix = rng.integers(0, vocab, size=n_prefix).tolist()
    return [prefix + rng.integers(0, vocab, size=prompt_len - n_prefix).tolist()
            for _ in range(n)]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8, help="cache slots")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--chunk-size", type=int, default=16)
    ap.add_argument("--token-budget", type=int, default=0,
                    help="per-step scheduled-token cap (0 = uncapped)")
    ap.add_argument("--packed", action="store_true",
                    help="token-packed step program: granted tokens alone determine per-step "
                         "compute")
    ap.add_argument("--cache", default="dense", choices=["dense", "paged"],
                    help="KV-cache layout: paged = page pool + block tables + prefix sharing")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--kv-dtype", default="", metavar="DTYPE",
                    help="paged-pool element type (e.g. 'int8': quantized pages with per-row "
                         "scales). Default: the model compute dtype")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                    help="give every prompt the same N-token prefix; with --cache paged, later "
                         "requests map the first one's pages instead of re-prefilling them")
    ap.add_argument("--spec", default="off", choices=["off", "ngram", "draft"],
                    help="speculative decoding: 'ngram' proposes from each request's own "
                         "history, 'draft' runs a smaller draft model ahead")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="max draft tokens verified per decode slot per step")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0, help="top-k truncation (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0, help="nucleus truncation (1.0 = off)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="base sampling seed; request i streams from seed+i")
    ap.add_argument("--capacity-factor", type=float, default=0.0,
                    help="MoE serving dispatch (needs an MoE --arch, e.g. moe_tiny or "
                         "mixtral-8x22b): route tokens through fixed per-expert buffers of "
                         "ceil(cf * tokens * top_k / n_experts) slots; overflow routes drop "
                         "to the residual path.  0 = dense dispatch; inf = never drop")
    ap.add_argument("--arch", default="",
                    help="config name: its smoke config, or with --full-config the published "
                         "one; the demo decoder when empty")
    ap.add_argument("--full-config", action="store_true",
                    help="serve --arch's published config (full width, bf16 parameters)")
    ap.add_argument("--layers", type=int, default=0,
                    help="with --full-config: cut the depth to this many layers (0 = all)")
    ap.add_argument("--ckpt", default="",
                    help="checkpoint directory (either package's) to load the parameters from")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain path; default the card (CUDA)")
    return ap.parse_args(argv)


def model_config(args) -> ModelConfig:
    if not args.arch:
        return DEMO
    if not args.full_config:
        return get_smoke_config(args.arch)
    cfg = dataclasses.replace(get_config(args.arch), param_dtype="bfloat16")
    return dataclasses.replace(cfg, n_layers=args.layers) if args.layers else cfg


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = model_config(args)
    print(f"serving {cfg.name}: {cfg.param_count()/1e6:.1f}M params")

    params = init_params(cfg, seed=0, device=dev)
    if args.ckpt:
        params = checkpoint.restore(args.ckpt, {"params": params})[0]["params"]
    max_len = args.prompt_len + args.new_tokens
    spec = None
    if args.spec == "ngram":
        spec = SpecConfig(NGramProposer(), k=args.spec_k)
    elif args.spec == "draft":
        draft = dataclasses.replace(DRAFT, vocab_size=cfg.vocab_size)
        spec = SpecConfig(DraftModelProposer(init_params(draft, seed=1, device=dev), draft,
                                             args.batch, max_len), k=args.spec_k)
    eng = ContinuousBatcher(
        params, cfg, batch_slots=args.batch, max_len=max_len, chunk_size=args.chunk_size,
        token_budget=args.token_budget or None, packed=args.packed, cache=args.cache,
        page_size=args.page_size, kv_dtype=args.kv_dtype or None, spec=spec,
        capacity_factor=args.capacity_factor or None,
    )

    sampling = {}
    if args.temperature > 0:
        base = SamplingParams(temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
                              seed=args.sample_seed)
        sampling = {"sampling": base}
        print(f"  sampling: T={args.temperature} top_k={args.top_k} "
              f"top_p={args.top_p} base seed {args.sample_seed}")
    prompts = seeded_prompts(args.requests, args.prompt_len, cfg.vocab_size, seed=1,
                             shared_prefix=args.shared_prefix)
    for i, p in enumerate(prompts):
        kw = {k: v.with_seed(v.seed + i) for k, v in sampling.items()}
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=args.new_tokens, **kw))

    t0 = time.time()
    done = eng.run()
    synchronize(dev)
    dt = time.time() - t0

    s = eng.stats_summary()
    n_out = sum(len(r.output) for r in done.values())
    n_prompt = args.requests * args.prompt_len
    print(f"finished {len(done)}/{args.requests} requests in {dt:.2f}s "
          f"({eng.steps} engine steps)")
    print(f"  prompt tokens {n_prompt}  output tokens {n_out}  "
          f"total {(n_prompt + n_out)/dt:.1f} tok/s")
    print(f"  mean TTFT {s['mean_ttft']*1e3:.1f} ms   p99 TTFT {s['p99_ttft']*1e3:.1f} ms")
    print(f"  max step tokens {s['max_step_tokens']:.0f}  "
          f"deferred {s['deferred_tokens']:.0f}  "
          f"max step wall {s['max_step_wall']*1e3:.1f} ms")
    if eng.kv is not None:
        print(f"  paged KV: {s['peak_used_pages']:.0f}/{s['num_pages']:.0f} "
              f"peak pages used ({args.page_size} tokens each), "
              f"{s['shared_tokens']:.0f} prompt tokens served from "
              f"prefix-shared pages")
    if eng.spec is not None:
        print(f"  speculative ({args.spec}, k={args.spec_k}): "
              f"{s['draft_tokens']:.0f} drafts verified, acceptance "
              f"{s['acceptance_rate']:.2f}, "
              f"{s['steps_per_token']:.2f} engine steps per generated token")
    if args.capacity_factor:
        print(f"  MoE capacity dispatch (cf={args.capacity_factor}): "
              f"{s['expert_overflow_tokens']:.0f} routes dropped to the "
              f"residual path (max {s['max_expert_overflow']:.0f}/step)")
    r0 = done[0]
    print("sample continuation:", r0.output[:12])
    return eng


if __name__ == "__main__":
    main()
