"""The three ``train`` runs of ``tests/test_torch_checkpoint.py``'s
resume test, in a process of their own.

    python tests/torch_resume_worker.py ARCH DTYPE DIR

Runs the plain run, run A (checkpoints and heartbeats under ``DIR``)
and run B (resumed from a copy of A's step 25) and saves their losses,
histories and parameters to ``DIR/runs.pt``.  The test starts it with
the intra-op thread count pinned and MKL's dynamic threading off in its
environment (:data:`PINNED`): bit for bit holds only there, since an
MKL GEMM whose threads or code path change between runs sums in
another order.  It imports the port only.
"""

import os
import shutil
import sys

import torch

from repro_torch.launch import train as train_mod

#: the environment the runs need for bit-for-bit results
PINNED = {"OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2",
          "MKL_DYNAMIC": "FALSE", "OMP_DYNAMIC": "FALSE",
          "MKL_CBWR": "AUTO"}
#: the resume runs: 28 steps save at 25 (max(28 // 4, 25)) and 28
RUN = dict(steps=28, batch=4, seq=32, lr=3e-3, log_every=100, device="cpu")
RESUME_AT = 25


def main(arch: str, dtype: str, out: str) -> None:
    kw = dict(RUN, dtype=getattr(torch, dtype))
    _, plain = train_mod.train(arch, **kw)
    a_dir, b_dir = os.path.join(out, "a"), os.path.join(out, "b")
    hist_a = []
    params_a, losses_a = train_mod.train(
        arch, ckpt_dir=a_dir, history=hist_a,
        heartbeat_dir=os.path.join(out, "hb"), **kw)
    steps_a = sorted(os.listdir(a_dir))
    os.makedirs(b_dir)
    shutil.copytree(os.path.join(a_dir, f"step_{RESUME_AT}"),
                    os.path.join(b_dir, f"step_{RESUME_AT}"))
    print("-- run B --", flush=True)
    hist_b = []
    params_b, losses_b = train_mod.train(arch, ckpt_dir=b_dir,
                                         history=hist_b, **kw)
    torch.save({"plain": plain, "losses_a": losses_a, "hist_a": hist_a,
                "steps_a": steps_a, "params_a": params_a,
                "losses_b": losses_b, "hist_b": hist_b,
                "params_b": params_b, "threads": torch.get_num_threads()},
               os.path.join(out, "runs.pt"))


if __name__ == "__main__":
    main(*sys.argv[1:4])
