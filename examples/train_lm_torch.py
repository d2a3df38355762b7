"""End-to-end LM training on the PyTorch/CUDA port: the twin of
``examples/train_lm.py``.  Trains the xLSTM-125M architecture (full
published config, ~110M params, with ``--full``) on the synthetic
pipeline with cosine scheduling; its scans run forward and backward
through the port's B4 kernel on the GPU.  Every other architecture
trains on the GPU too (``--arch``): attention runs forward and backward
through B5's kernels.  Zamba2-2.7B at its published size needs
``remat="full"`` to fit 8 × 1,024 tokens in one 80 GB card, which
``python -m repro_torch.launch.train --remat full`` offers.

  PYTHONPATH=src python examples/train_lm_torch.py --device cpu  # smoke
  PYTHONPATH=src python examples/train_lm_torch.py --full --seq 1024

On the CPU the default is the smoke config at a shortened sequence
length; pass --full --seq 1024 on a GPU.  With ``--ckpt DIR`` the run
checkpoints into DIR and resumes from the latest checkpoint there; a
run that finds the last step already saved trains no more.  Without it
nothing is saved: the JAX example's fixed default directory would let
one run resume another's state, saved with other arguments.
"""

import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.launch.train import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="train the full published config (CPU: slow)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory: saves there, and resumes "
                         "from its latest checkpoint")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    params, losses = train(args.arch, steps=args.steps, batch=args.batch,
                           seq=args.seq, smoke=not args.full,
                           ckpt_dir=args.ckpt, log_every=20,
                           device=args.device)
    if not losses:
        print(f"\n{args.ckpt} holds step {args.steps} already: nothing to "
              f"train")
        return
    print(f"\nloss: {losses[0]:.3f} → {losses[-1]:.3f} over "
          f"{len(losses)} steps")
    assert losses[-1] < losses[0], "training failed to reduce loss"


if __name__ == "__main__":
    main()
