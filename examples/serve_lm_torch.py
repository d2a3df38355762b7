"""Batched serving on the PyTorch/CUDA port: the twin of
``examples/serve_lm.py``.  Prefill, then greedy decode, through
``repro_torch.launch.serve.serve_batch``; attention runs through the
port's B5 kernel and the recurrences through B4 on the GPU.

  PYTHONPATH=src python examples/serve_lm_torch.py --device cpu  # smoke
  PYTHONPATH=src python examples/serve_lm_torch.py --arch minicpm-2b

The smoke config of ``--arch`` is served, as the JAX example serves it;
the device is the GPU unless ``--device cpu`` is given.
"""

import argparse
import sys

sys.path.insert(0, "src")

import numpy as np

from repro_torch import configs
from repro_torch.launch.serve import Request, serve_batch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = configs.get(args.arch, smoke=True)
    rng = np.random.default_rng(0)
    reqs = [Request(rng.integers(0, cfg.vocab, args.prompt_len,
                                 dtype=np.int32), args.max_new)
            for _ in range(args.batch)]
    stats = serve_batch(args.arch, reqs, smoke=True, t_max=128,
                        device=args.device)
    print(f"arch={args.arch} (smoke config, {cfg.family})")
    print(f"prefill: {stats['prefill_s']*1e3:.0f} ms for batch "
          f"{args.batch} × {args.prompt_len} tokens")
    print(f"decode:  {stats['tok_per_s']:.1f} tok/s")
    for i, r in enumerate(reqs):
        print(f"  req{i}: {r.out}")


if __name__ == "__main__":
    main()
